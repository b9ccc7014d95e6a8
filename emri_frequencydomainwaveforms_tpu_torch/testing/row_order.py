"""The fixed-order row kernels' additions (``csrc/row_ops.cu``), replayed in
torch.

`row_sum_order` and `row_cumsum_order` make, one by one and in the same
order, the floating-point additions that the CUDA kernels make: each lane's
serial sum of its 16-byte groups and the butterfly (`row_sum`), the chunks'
partials in chunk order, each thread's serial scan, the warp scan, the warp
totals, the tiles' carry (`row_cumsum`). They use elementwise additions,
`torch.where` and indexing only, never ``torch.sum`` or ``torch.cumsum``,
so they give the same bits on any device, and nvcc without fast-math does
not reassociate an addition: the kernels must equal them exactly. A test
aid; on no path of the port.
"""

from __future__ import annotations

import torch

from ..ops.row_ops import CHUNK, SCAN_K, SCAN_THREADS, SMALL_MAX, VECTOR_BYTES

WARP = 32


def sum_chunks(n: int) -> int:
    """The number of chunks `row_sum` cuts a row of ``n`` elements into."""
    return 1 if n <= SMALL_MAX else -(-n // CHUNK)


def _butterfly(acc: torch.Tensor) -> torch.Tensor:
    """Lane l adds lane l ^ off's value, off = 16, 8, 4, 2, 1: (R, 32) -> (R,)."""
    lanes = torch.arange(WARP, device=acc.device)
    off = WARP // 2
    while off:
        acc = acc + acc[:, lanes ^ off]
        off //= 2
    return acc[:, 0]


def _warp_sum(seg: torch.Tensor) -> torch.Tensor:
    """One warp's sum of each row of ``seg`` (R, m): lane l adds, in order,
    the groups g of V consecutive elements with g % 32 == l (the last group
    may be partial), then the butterfly."""
    n_rows, m = seg.shape
    v = VECTOR_BYTES // seg.element_size()
    span = WARP * v
    rounds = -(-m // span)
    padded = seg.new_zeros(n_rows, rounds * span)
    padded[:, :m] = seg
    padded = padded.reshape(n_rows, rounds, WARP, v)
    index = torch.arange(rounds * span, device=seg.device).reshape(rounds, WARP, v)
    acc = seg.new_zeros(n_rows, WARP)
    for k in range(rounds):
        for i in range(v):
            acc = torch.where(index[k, :, i] < m, acc + padded[:, k, :, i], acc)
    return _butterfly(acc)


def row_sum_order(x: torch.Tensor, mean: bool = False) -> torch.Tensor:
    """What ``ops.row_sum`` gives on the card for ``x`` (float32 / float64),
    addition for addition."""
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    scale = torch.tensor(1.0 / n if mean else 1.0, dtype=x.dtype, device=x.device)
    chunks = sum_chunks(n)
    if chunks == 1:
        total = _warp_sum(rows)
    else:
        total = rows.new_zeros(rows.shape[0])
        for c in range(chunks):
            total = total + _warp_sum(rows[:, c * CHUNK:(c + 1) * CHUNK])
    return (total * scale).reshape(x.shape[:-1])


def row_cumsum_order(x: torch.Tensor) -> torch.Tensor:
    """What ``ops.row_cumsum`` gives on the card for ``x`` (float32 /
    float64), addition for addition."""
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    n_rows, k = rows.shape[0], SCAN_K[x.dtype]
    warps, tile = SCAN_THREADS // WARP, SCAN_THREADS * k
    tiles = -(-n // tile)
    padded = rows.new_zeros(n_rows, tiles * tile)
    padded[:, :n] = rows
    # (row, tile, warp, lane, element): thread t = 32 warp + lane owns K
    # contiguous elements of the tile
    local = list(padded.reshape(n_rows, tiles, warps, WARP, k).unbind(-1))
    for i in range(1, k):
        local[i] = local[i - 1] + local[i]
    incl = local[-1]
    d = 1
    while d < WARP:  # Kogge-Stone: lane l >= d adds lane l - d's value
        incl = torch.cat([incl[..., :d], incl[..., :-d] + incl[..., d:]], dim=-1)
        d *= 2
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    warp_total = incl[..., -1]  # (row, tile, warp)
    before = [torch.zeros_like(warp_total[..., 0])]
    for w in range(warps):
        before.append(before[-1] + warp_total[..., w])
    tile_total = before.pop()
    before = torch.stack(before, dim=-1)
    carry = [torch.zeros_like(tile_total[:, 0])]
    for t in range(tiles - 1):
        carry.append(carry[-1] + tile_total[:, t])
    carry = torch.stack(carry, dim=-1)
    prefix = carry[..., None, None] + (before[..., None] + excl)
    out = torch.stack([prefix + v for v in local], dim=-1)
    return out.reshape(n_rows, tiles * tile)[:, :n].reshape(x.shape)


__all__ = ["row_sum_order", "row_cumsum_order", "sum_chunks"]
