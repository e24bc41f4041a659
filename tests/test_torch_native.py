"""The port's native OpenFOAM tokenizer (``gnn_bfs_rans_tpu_torch/native/``)
against the JAX package's (``gnn_bfs_rans_tpu/native/``) and the port's
numpy cursor walk, on the mixed hex/prism case (triangles and quads in one
faces file).  Both libraries are built with the system ``g++``."""

import logging

import numpy as np
import pytest

from gnn_bfs_rans_tpu import native as jax_native
from gnn_bfs_rans_tpu_torch import native
from gnn_bfs_rans_tpu_torch.foam import tokenizer
from gnn_bfs_rans_tpu_torch.foam.casegen import generate_mixed_prism_case


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The faces, points and owner bodies of a 6 × 5 × 3 mixed case."""
    root = tmp_path_factory.mktemp("native") / "mixed"
    generate_mixed_prism_case(root, 6, 5, 3)
    mesh = root / "constant" / "polyMesh"
    return {name: tokenizer.strip_header((mesh / name).read_text())
            for name in ("faces", "points", "owner")}


def _list_body(body):
    """(count, the text after the list's opening parenthesis)."""
    head, rest = body.split("(", 1)
    return int(head.split()[-1]), rest


@pytest.fixture(scope="module")
def libs():
    if not (native.available() and jax_native.available()):
        pytest.skip("no g++ to build the native tokenizers")


def test_parse_faces_matches_jax_and_the_walk(mixed, libs):
    n, text = _list_body(mixed["faces"])
    max_points = 4 * n
    got = native.parse_faces(text, n, max_points)
    want = jax_native.parse_faces(text, n, max_points)
    walk = tokenizer.parse_face_list(mixed["faces"])
    sizes = np.diff(got[0])
    assert set(sizes.tolist()) == {3, 4}          # mixed-size faces
    for a, b, c in zip(got, want, walk):
        assert a.dtype == np.int32 and np.array_equal(a, b)
        assert np.array_equal(a, c)
    # the tokenizer's entry point takes the native walk for mixed faces
    for a, b in zip(tokenizer.parse_face_list_fast(mixed["faces"]), got):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name,fn", [("points", "parse_doubles"),
                                     ("owner", "parse_labels")])
def test_parse_numbers_match_jax(mixed, libs, name, fn):
    n, text = _list_body(mixed[name])
    cap = 3 * n if name == "points" else n
    got = getattr(native, fn)(text, cap)
    want = getattr(jax_native, fn)(text, cap)
    assert got.dtype == want.dtype and got.shape == (cap,)
    assert np.array_equal(got, want)


def test_overflow_returns_none_and_the_tokenizer_walks(mixed, libs,
                                                       monkeypatch):
    n, text = _list_body(mixed["faces"])
    assert native.parse_faces(text, n, 10) is None
    assert jax_native.parse_faces(text, n, 10) is None
    calls = []
    parse = native.parse_faces

    def overflowing(text, n_faces, max_points):
        calls.append(n_faces)
        return parse(text, n_faces, 10)

    monkeypatch.setattr(native, "parse_faces", overflowing)
    got = tokenizer.parse_face_list_fast(mixed["faces"])
    want = tokenizer.parse_face_list(mixed["faces"])
    assert calls == [n]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_a_failed_build_warns_and_the_walk_parses(mixed, monkeypatch,
                                                  tmp_path, caplog):
    """Without a compiler the library is None, a WARNING says so, and the
    tokenizer parses with the numpy walk."""
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "LIB", tmp_path / "libfoamparse.so")
    monkeypatch.setenv("PATH", str(tmp_path))       # no g++ on it
    with caplog.at_level(logging.WARNING, logger=native.LOG.name):
        assert native.get_lib() is None
    assert any("numpy walk" in r.getMessage() for r in caplog.records)
    got = tokenizer.parse_face_list_fast(mixed["faces"])
    for a, b in zip(got, tokenizer.parse_face_list(mixed["faces"])):
        assert np.array_equal(a, b)
