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

Receiver tile ``t``'s attention window starts at sender row
``t·T − (Wcols − T)/2`` (half-tile granular, see the JAX module); rows
outside ``[0, n_pad)`` are absent and their mask entries are 0.  The
Transformer's edge/geo planes are not built yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ALL_COMPONENTS = ("adj", "gcn", "bias_self", "bias_noself")

# band components each conv reads (the JAX package's LAYER_COMPONENTS less
# the Transformer's edge planes)
LAYER_COMPONENTS = {
    "GCN": ("gcn",),
    "GIN": ("adj",),
    "GAT": ("bias_self",),
    "Transformer": ("bias_noself",),
}


@dataclasses.dataclass(frozen=True)
class Band:
    """Banded adjacency tensors (see module doc for layouts)."""

    adj: torch.Tensor | None
    gcn: torch.Tensor | None
    bias_self: torch.Tensor | None
    bias_noself: torch.Tensor | None
    tile: int

    @property
    def width_cols(self) -> int:
        """Attention window width in sender columns (Wcols)."""
        for f in (self.bias_self, self.bias_noself):
            if f is not None:
                return f.shape[-1]
        f = self.adj if self.adj is not None else self.gcn
        return f.shape[1] * self.tile

    def transposed(self, name: str) -> torch.Tensor:
        """The ``name`` plane ('gcn' or 'adj') of Aᵀ for the SpMM's
        backward, computed at first use and kept with this Band (``to``
        makes a new Band, which computes its own)."""
        cache = self.__dict__.setdefault("_transposed", {})
        if name not in cache:
            from ..kernels.banded import transpose_band
            cache[name] = transpose_band(getattr(self, name))
        return cache[name]

    def to(self, device: str | torch.device) -> "Band":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device)
            for name in ALL_COMPONENTS if getattr(self, name) is not None
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
) -> Band | None:
    """Build the banded adjacency; None if the graph is not band-limited.

    The window ``W = 2·k0+1`` full tiles is chosen minimally from the
    tile bandwidth; graphs needing ``W > max_window_tiles`` (or an
    attention window wider than ``max_window_tiles·T``) return None.
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
    )
