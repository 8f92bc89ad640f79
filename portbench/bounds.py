"""The yardstick's arithmetic: published peaks of the card and the work
each hand-written kernel must do, whatever implements it.

Frozen copies of ``chip_smoke.py``'s ``_bound``, of the scan's byte and
operation count in its ``_time_scan`` and of ``_pivot_chunk_bound``, so
that a later change to the program or to chip_smoke cannot move them.
"""

from __future__ import annotations

from typing import Tuple

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the full
# power limit of 700 W): device memory and the rates of the operations the
# kernels do (f32 and f64 on the vector units).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def bound_s(bytes_moved: float, flops: float, peak: float = F32_FLOPS) -> Tuple[float, str]:
    """(seconds, bound by): the least time for the bytes at the memory rate
    and for the operations at ``peak``, whichever is larger."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_bound_s(M: int, N: int, itemsize: int) -> Tuple[float, str]:
    """One ``fused_price_scan`` of an (M, N) tableau: A, P (3 x M), c and
    gamma read once, d and gamma written; 6 M N operations."""
    return bound_s((M * N + 3 * M + 4 * N) * itemsize, 6.0 * M * N,
                   F64_FLOPS if itemsize == 8 else F32_FLOPS)


def pivot_chunk_bound_s(B: int, M: int, N: int, shared: bool, pivots: int,
                        running: int) -> Tuple[float, str]:
    """One batched-pivot chunk of B LPs on an (M, N) tableau (``shared``:
    one tableau for the batch, else one an LP): the tableau and every LP's
    state in and out, against 6 M N + 6 M^2 operations a pivot taken (the
    stacked scan, FTRAN, v and the rank-1 update) and 2 M N a running LP
    (the chunk-entry reduced costs)."""
    tableaus = 1 if shared else B
    state = B * (2 * M * M * 4 + 2 * 3 * M * 4 + N * 4 + N + 2 * N + 2 * N * 4)
    flops = pivots * (6.0 * M * N + 6.0 * M * M) + running * 2.0 * M * N
    return bound_s(tableaus * M * N * 4 + state, flops)
