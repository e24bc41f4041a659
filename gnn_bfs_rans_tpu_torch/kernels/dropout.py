"""The port's dropout stream (plain PyTorch version).

The JAX package's kernels draw dropout bits from the TPU's Mosaic PRNG on
the chip and, in interpret mode, from a counter-based hash of (seed, draw,
element index) (``gnn_bfs_rans_tpu/kernels/banded.py::_hash_bits``).  The
TPU stream cannot be reproduced off the TPU, so the port uses the hash
everywhere: its masks are bit-identical to the JAX package run on the CPU.
The GAT kernels and the epilogue draw once per plane (draw 0); the
Transformer attention draws once per head, draw h over each tile's
[T, Wcols] plane (``transformer_keep``).  The same function is written for
the card in ``csrc/dropout.cuh``, which every CUDA kernel includes.

An element is kept when ``hash_bits(seed, flat, draw) >= threshold(rate)``
and then scaled by ``1 / (1 − rate)``.  Seeds are [1] int32 tensors on the
device of the data they mask, drawn from an explicit ``torch.Generator``,
so a kernel reads its seed without a host round trip.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """The keep threshold on the uint32 bits (``_dropout_thresh``)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x·c) mod 2³² for int64 x in [0, 2³²): split so no product
    overflows int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_bits(seed, flat: torch.Tensor, draw=0) -> torch.Tensor:
    """uint32 bits (as int64) of element ``flat`` of draw ``draw`` of the
    stream ``seed``.

    ``seed`` and ``draw`` are ints or int64 tensors broadcastable against
    ``flat``; the seed wraps to 32 bits as the int32 seed arithmetic of the
    kernels does.
    """
    flat = flat.to(torch.int64)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=flat.device) & _M32
    # an int draw stays a Python int: no host-to-device copy, so the plain
    # versions capture into CUDA graphs
    step = (draw * 0x85EBCA6B & _M32 if isinstance(draw, int)
            else _mul32(draw, 0x85EBCA6B))
    x = (flat ^ _mul32(seed, 0x9E3779B9)) + step & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def transformer_keep(seed, n_tiles: int, tile: int, width: int, heads: int,
                     rate: float, device=None) -> torch.Tensor:
    """[n_tiles, H, T, Wcols] keep mask of the Transformer's attention
    dropout: tile t, head h draws ``h`` of the stream seed + t over the
    tile's [T, Wcols] plane, element i·Wcols + w (``_transformer_kernel``'s
    ``_attn_dropout(e, ..., sv, draw=h)``).  ``seed``: an int or a [1]
    int64 tensor (read without a host sync)."""
    if device is None:
        device = seed.device if torch.is_tensor(seed) else "cpu"
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    t = ar(n_tiles)[:, None, None, None]
    h = ar(heads)[None, :, None, None]
    flat = ar(tile)[:, None] * width + ar(width)[None, :]
    return hash_bits(seed + t, flat, h) >= threshold(rate)


def check_seed(seed: torch.Tensor | None, rate: float,
               device: torch.device) -> torch.Tensor | None:
    """The seed a kernel reads: None at rate 0, else a [1] int32 tensor on
    ``device`` (raises otherwise)."""
    if rate <= 0:
        return None
    if not 0 < rate < 1:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout rate > 0 needs a seed tensor")
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or seed.device != device):
        raise ValueError(f"the seed must be one int32 on {device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return seed.contiguous()


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One kernel seed in [0, 2³¹ − 1) from ``generator`` (on ``device``),
    the range of the JAX package's ``_dropout_seed``."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


class MaskTape:
    """A generator stand-in that replays its masks: the keep masks drawn
    through :func:`bernoulli_keep` are drawn from ``generator`` once, kept,
    and handed out again, in order, after :meth:`rewind`.  A conv
    recomputed in the backward (``ModelConfig.remat``) so sees the masks
    of its forward, and the generator advances once, as without remat;
    nothing reads or sets the generator's state, so the step still
    captures into a CUDA graph."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.masks: list[torch.Tensor] = []
        self.pos = 0

    def rewind(self) -> None:
        self.pos = 0

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        if self.pos == len(self.masks):
            self.masks.append(torch.rand(shape, generator=self.generator,
                                         device=device) < 1.0 - rate)
        mask = self.masks[self.pos]
        self.pos += 1
        return mask


def bernoulli_keep(shape, rate: float,
                   generator: torch.Generator | MaskTape,
                   device) -> torch.Tensor:
    """Keep mask of the dense and segment backends' attention dropout: each
    element kept with probability 1 − rate, drawn from ``generator`` (or
    replayed by a :class:`MaskTape`).  The JAX package draws these from
    ``jax.random.bernoulli``, which torch cannot reproduce: masks match in
    distribution, not bit for bit."""
    if isinstance(generator, MaskTape):
        return generator.keep(shape, rate, device)
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate
