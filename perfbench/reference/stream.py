"""The configurations' training dropout, worked out again.

The port documents its dropout as a stream keyed by a seed that each
layer draws from the training generator (``torch.randint(0, 2**31 − 1,
(1,), int32)`` on the generator's device, one for a conv's attention,
then one for the block's epilogue), and by an element's place:

* an element is kept when ``hash(seed + block, element, draw) ≥
  ⌊rate · 2³²⌋`` (a 32-bit mix of seed, element and draw: :func:`bits`);
* GAT attention: block = the receiver tile, element ``(h·T + i)·W + w``
  for head h, row i of the tile and window column w (W columns);
* Transformer attention: block = the receiver tile, element ``i·W + w``,
  draw h;
* the epilogue (after BatchNorm and ReLU): block = row // B, element
  ``(row mod B)·F + f``, B the largest multiple of 8 dividing the padded
  row count whose B·F elements of the activations' dtype fit 512 KiB;
* the output MLP's two dropouts: ``torch.rand(N_pad, F) < 1 − rate`` from
  the same generator.

Kept values are scaled by 1 / (1 − rate).  These functions give the
keep masks on the reference's edges and rows.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def bits(seed: torch.Tensor, element: torch.Tensor, draw) -> torch.Tensor:
    """The stream's uint32 (as int64) at ``element`` of draw ``draw`` of
    stream ``seed`` (int64 tensors, broadcast)."""
    seed = seed.to(torch.int64) & _M32
    element = element.to(torch.int64)
    step = (_mul32(torch.as_tensor(draw, dtype=torch.int64,
                                   device=element.device), 0x85EBCA6B))
    x = (element ^ _mul32(seed, 0x9E3779B9)) + step & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep(seed, element, draw, rate: float) -> torch.Tensor:
    return bits(seed, element, draw) >= threshold(rate)


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


def gat_attention_keep(seed, rows: torch.Tensor, cols: torch.Tensor,
                       heads: int, width: int, rate: float, tile: int
                       ) -> torch.Tensor:
    """[E, H] keep mask of edges into ``rows`` at window ``cols``."""
    h = torch.arange(heads, device=rows.device)[None, :]
    element = ((h * tile + (rows % tile)[:, None]) * width + cols[:, None])
    return keep(seed.long() + (rows // tile)[:, None], element, 0, rate)


def transformer_attention_keep(seed, rows, cols, heads: int, width: int,
                               rate: float, tile: int) -> torch.Tensor:
    h = torch.arange(heads, device=rows.device)[None, :]
    element = ((rows % tile) * width + cols)[:, None]
    return keep(seed.long() + (rows // tile)[:, None], element, h, rate)


def epilogue_block(n_pad: int, feat: int, itemsize: int) -> int:
    cap = max(512 * 1024 // (feat * itemsize), 8)
    best = 8
    for b in range(8, min(cap, n_pad) + 1, 8):
        if n_pad % b == 0:
            best = b
    return best


def epilogue_keep(seed, n_rows: int, feat: int, block: int, rate: float,
                  device) -> torch.Tensor:
    rows = torch.arange(n_rows, device=device)[:, None]
    element = (rows % block) * feat + torch.arange(feat, device=device)[None]
    return keep(seed.long() + rows // block, element, 0, rate)
