"""Banded block-sparse adjacency for the banded kernels.

Counterpart of ``gnn_bfs_rans_tpu/graph/band.py``.  After RCM reordering
every edge satisfies ``|sender − receiver| ≤ bandwidth``, so the senders of
a tile of ``T`` consecutive receivers fall inside a window of consecutive
rows.  ``build_band`` runs on the host in numpy exactly as the JAX package
does; the :class:`Band` it returns holds torch tensors.

* ``adj``         — [n_tiles, W, T, T] 0/1 adjacency, ``torch.bfloat16``
* ``gcn``         — [n_tiles, W, T, T] f32 normalized GCN coefficients
* ``bias_self``   — [n_tiles, T, Wcols] int8 attention mask with self-loops
* ``bias_noself`` — [n_tiles, T, Wcols] int8 attention mask without them
* ``edge``        — [n_tiles, D_e, T, Wcols] f32 edge features on the band
* ``geo``         — [n_tiles, 2, T, Wcols] f32 (dist, 1/dist) planes, 0 off
  the band and on self-loops, with ``pos`` [n_pad, 4] f32 (xyz, 0): the
  factorised form of geometric ``[unit dir, dist]`` features

Receiver tile ``t``'s attention window starts at sender row
``t·T − (Wcols − T)/2`` (half-tile granular, see the JAX module); rows
outside ``[0, n_pad)`` are absent and their mask entries are 0.  The
edge-conditioned Transformer reads ``geo`` when the edge features validate
as geometric (every mesh the system builds) and ``edge`` otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ALL_COMPONENTS = ("adj", "gcn", "bias_self", "bias_noself", "geo", "edge")
# the tensor fields of a Band that move with it
_TENSORS = ("adj", "gcn", "bias_self", "bias_noself", "edge", "geo", "pos")

# band components each conv reads; with both "geo" and "edge" listed,
# "geo" is built when the edge features validate as geometric and "edge"
# otherwise
LAYER_COMPONENTS = {
    "GCN": ("gcn",),
    "GIN": ("adj",),
    "GAT": ("bias_self",),
    "Transformer": ("bias_noself", "geo", "edge"),
}


@dataclasses.dataclass(frozen=True)
class Band:
    """Banded adjacency tensors (see module doc for layouts)."""

    adj: torch.Tensor | None
    gcn: torch.Tensor | None
    bias_self: torch.Tensor | None
    bias_noself: torch.Tensor | None
    tile: int
    edge: torch.Tensor | None = None
    geo: torch.Tensor | None = None
    pos: torch.Tensor | None = None

    @property
    def width_cols(self) -> int:
        """Attention window width in sender columns (Wcols)."""
        for f in (self.bias_self, self.bias_noself, self.edge, self.geo):
            if f is not None:
                return f.shape[-1]
        f = self.adj if self.adj is not None else self.gcn
        return f.shape[1] * self.tile

    @property
    def reach(self) -> int:
        """The farthest sender row a window covers on either side (rows):
        the halo a node-partitioned shard needs (``parallel/partition``)."""
        r = 0
        for f in (self.adj, self.gcn):
            if f is not None:
                r = max(r, (f.shape[1] // 2) * self.tile)
        for f in (self.bias_self, self.bias_noself, self.edge, self.geo):
            if f is not None:
                r = max(r, (f.shape[-1] - self.tile) // 2)
        return r

    def transposed(self, name: str) -> torch.Tensor:
        """The ``name`` plane ('gcn' or 'adj') of Aᵀ for the SpMM's
        backward, or the attention mask 'bias_self' as [n_tiles, Wcols, T]
        for the GAT backward's sender pass; computed at first use and kept
        with this Band (``to`` makes a new Band, which computes its own)."""
        cache = self.__dict__.setdefault("_transposed", {})
        if name not in cache:
            if name == "bias_self":
                from ..kernels.banded_bwd import transpose_mask
                cache[name] = transpose_mask(self.bias_self)
            else:
                from ..kernels.banded import transpose_band
                cache[name] = transpose_band(getattr(self, name))
        return cache[name]

    def to(self, device: str | torch.device) -> "Band":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device)
            for name in _TENSORS if getattr(self, name) is not None
        })


def build_band(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_pad: int,
    node_mask: np.ndarray,
    in_degree: np.ndarray,
    tile: int = 128,
    components: tuple[str, ...] = ALL_COMPONENTS,
    max_window_tiles: int = 5,
    edge_feat: np.ndarray | None = None,
    node_pos: np.ndarray | None = None,
) -> Band | None:
    """Build the banded adjacency; None if the graph is not band-limited.

    The window ``W = 2·k0+1`` full tiles is chosen minimally from the
    tile bandwidth; graphs needing ``W > max_window_tiles`` (or an
    attention window wider than ``max_window_tiles·T``) return None.
    ``edge_feat`` ([n_edges, D_e], in the order of ``senders``) and
    ``node_pos`` ([≥ n_nodes, 3]) feed the ``geo`` and ``edge`` planes.
    """
    if n_pad % tile != 0:
        return None

    n_tiles = n_pad // tile
    t = receivers // tile
    s_tile = senders // tile
    delta = s_tile - t
    k0 = int(np.abs(delta).max()) if len(senders) else 1
    k0 = max(k0, 1)
    window = 2 * k0 + 1
    if window > max_window_tiles:
        return None

    adj = np.zeros((n_tiles, window, tile, tile), dtype=np.float32)
    row = receivers % tile
    col = senders % tile
    k = delta + k0
    adj[t, k, row, col] = 1.0

    # half-tile attention window, sized from the exact per-edge column
    # offsets (s − t·T)
    sub = tile // 2
    if len(senders):
        col_off = senders.astype(np.int64) - t.astype(np.int64) * tile
        pad_needed = max(int(-col_off.min()), int(col_off.max()) - tile + 1, 1)
    else:
        col_off = np.zeros(0, np.int64)
        pad_needed = 1
    k0s = -(-pad_needed // sub)
    width = tile + 2 * k0s * sub
    if width > max_window_tiles * tile:
        return None
    attn_col = col_off + k0s * sub
    diag_col = np.arange(tile) + k0s * sub
    diag_idx = np.arange(tile)

    gcn = None
    if "gcn" in components:
        # Â = A + I normalized by D̂^-1/2 on both sides; padding rows → 0
        deg_hat = np.asarray(in_degree, dtype=np.float32) + np.float32(1.0)
        inv_sqrt = np.where(
            node_mask, np.float32(1.0) / np.sqrt(np.maximum(deg_hat, 1.0)), 0.0
        ).astype(np.float32)
        gcn = adj.copy()
        gcn[:, k0, diag_idx, diag_idx] += np.float32(1.0)
        gcn *= inv_sqrt.reshape(n_tiles, tile)[:, None, :, None]
        pad0 = np.zeros(k0 * tile, np.float32)
        padded = np.concatenate([pad0, inv_sqrt, pad0])
        send_scale = np.lib.stride_tricks.sliding_window_view(
            padded, window * tile
        )[::tile][:n_tiles].reshape(n_tiles, window, tile)
        gcn *= send_scale[:, :, None, :]

    bias_self = None
    if "bias_self" in components:
        bias_self = np.zeros((n_tiles, tile, width), dtype=np.int8)
        bias_self[t, row, attn_col] = 1
        # every row attends at least to itself, padding rows included, so
        # the GAT softmax never runs over a fully masked row
        bias_self[:, diag_idx, diag_col] = 1

    bias_noself = None
    if "bias_noself" in components:
        bias_noself = np.zeros((n_tiles, tile, width), dtype=np.int8)
        bias_noself[t, row, attn_col] = 1

    geo = pos = None
    if (edge_feat is not None and node_pos is not None
            and "geo" in components and edge_feat.shape[1] == 4):
        geo, pos = _try_build_geo(edge_feat, node_pos, senders, receivers,
                                  n_pad, n_tiles, width, tile, t, row,
                                  attn_col)

    edge = None
    if edge_feat is not None and "edge" in components and geo is None:
        d_e = edge_feat.shape[1]
        edge = np.zeros((n_tiles, d_e, tile, width), dtype=np.float32)
        edge[t, :, row, attn_col] = np.asarray(edge_feat, dtype=np.float32)

    def _t(a):
        return None if a is None else torch.from_numpy(a)

    return Band(
        # 0/1 values are exact in bfloat16
        adj=(torch.from_numpy(adj).to(torch.bfloat16)
             if "adj" in components else None),
        gcn=_t(gcn),
        bias_self=_t(bias_self),
        bias_noself=_t(bias_noself),
        tile=tile,
        edge=_t(edge),
        geo=_t(geo),
        pos=_t(pos),
    )


def _try_build_geo(edge_feat, node_pos, senders, receivers, n_pad, n_tiles,
                   width, tile, t, row, attn_col):
    """The (dist, 1/dist) planes and ``pos``, or (None, None) when the
    features are not ``[(pos_r − pos_s)/dist, dist]`` of the node positions
    (the JAX package's check, same arithmetic).  Self-loops store
    dist = 1/dist = 0: their edge contribution is zero."""
    ef = np.asarray(edge_feat, dtype=np.float32)
    pos = np.asarray(node_pos, dtype=np.float32)
    if pos.shape[0] < n_pad:
        pos = np.concatenate(
            [pos, np.zeros((n_pad - pos.shape[0], pos.shape[1]), np.float32)])
    pos = pos[:n_pad]
    d = pos[receivers] - pos[senders]
    dist = np.linalg.norm(d, axis=1)
    nz = dist > 0
    recon = np.zeros_like(ef)
    recon[nz, :3] = d[nz] / dist[nz, None]
    recon[:, 3] = np.where(nz, dist, 0.0)
    scale_ref = max(float(np.abs(ef).max()), 1e-12)
    if not np.allclose(recon, ef, atol=1e-4 * scale_ref + 1e-6):
        return None, None
    geo = np.zeros((n_tiles, 2, tile, width), dtype=np.float32)
    inv = np.where(nz, 1.0 / np.maximum(dist, 1e-30), 0.0).astype(np.float32)
    geo[t, 0, row, attn_col] = np.where(nz, dist, 0.0).astype(np.float32)
    geo[t, 1, row, attn_col] = inv
    pos4 = np.zeros((n_pad, 4), dtype=np.float32)
    pos4[:, :3] = pos[:, :3]
    return geo, pos4
