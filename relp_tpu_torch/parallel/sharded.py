"""Column-sharded simplex over ``torch.distributed``: the port of
``relp_tpu.parallel.sharded``.

The (M, N) tableau is split into contiguous blocks of columns over the
mesh's "col" axis, one ``.contiguous()`` block per rank: A, its scan copy,
c, the candidate mask and the N-sized state (``d``, ``gamma``,
``in_basis``).  The carry (``Binv``, or the LU engine's factors and eta
ring; ``xB``, ``pi``, ``obj``, ``basis`` and the scalars) is replicated,
and every rank updates it identically.

The JAX package leaves the collectives to GSPMD.  Here they are written
out, kept on the device (nothing calls ``.item()``, so a chunk needs no
host sync), two per pivot:

* the entering choice: each rank's best (key, global index, any eligible)
  is all-gathered, and the highest key wins, the lowest global index on a
  tie (``torch.argmax``'s first-max rule, under which a NaN wins); the
  smallest-index and rotated rules use the negated distance as key;
* the entering column, ``c_q`` and ``c_B``: the owner contributes them,
  every other rank zeros, and one ``all_reduce(SUM)`` combines them (a sum
  with zeros is exact).

At a chunk's exit the basis matrix B (``basis_columns``) is combined the
same way, so the refactorization (the dense inverse or the LU factors)
sees exact B; the scan, the LU engine's pricing and Goldfarb products,
``recompute_gamma`` and the reduced costs stay local.  Never pad the
simplex's columns: padding would change N and with it the modular
rotation of the pricing rules.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# Collective calls since the last reset (each all_gather / all_reduce).  A
# captured chunk counts its collectives at capture; every replay adds what
# its capture counted (``simplex.graphs.launch_counts``).
COLLECTIVES = 0

# ``all_gather_single`` where torch has it (it deprecates the older name).
_ALL_GATHER_INTO_TENSOR = (getattr(dist, "all_gather_single", None)
                           or dist.all_gather_into_tensor)


def all_reduce(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place (SUM by default), counted."""
    global COLLECTIVES
    COLLECTIVES += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The group's ``size`` copies of ``t``'s shape (at least one
    dimension), stacked in rank order into one (size, *t.shape) tensor,
    counted.  One collective into one tensor, no list of outputs: NCCL's
    list form allocates and copies inside the process group, which a
    captured graph must not do."""
    global COLLECTIVES
    COLLECTIVES += 1
    t = t.contiguous()
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    _ALL_GATHER_INTO_TENSOR(out, t, group=group)
    return out.view(size, *t.shape)


def _bounds(n: int, parts: int, index: int):
    """[lo, hi) of block ``index`` of ``tensor_split(n, parts)``: the first
    ``n % parts`` blocks hold one more element."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)


class ColumnShard:
    """This rank's contiguous block of the N columns of one LP (or of every
    LP of a batch) and the collectives over the ranks that share the LP."""

    def __init__(self, group, size: int, rank: int, N: int, device):
        if N < size:
            raise ValueError(f"cannot split {N} columns over {size} ranks")
        self.group, self.size, self.rank = group, size, rank
        self.N = N
        self.device = torch.device(device)
        self.lo, self.hi = _bounds(N, size, rank)
        self.n = self.hi - self.lo
        self.widths = [_bounds(N, size, r)[1] - _bounds(N, size, r)[0]
                       for r in range(size)]
        self.ids = torch.arange(self.lo, self.hi, device=self.device)

    # A shard is a static argument of a captured chunk or step, part of its
    # key (simplex/graphs.py): equal shards make equal keys, so that the
    # steps of a second ``solve_batch`` call under one mesh, which makes a
    # new shard, replay the first call's graphs.
    def _identity(self):
        return self.group, self.size, self.rank, self.N, str(self.device)

    def __eq__(self, other):
        return isinstance(other, ColumnShard) and self._identity() == other._identity()

    def __hash__(self):
        return hash(self._identity())

    # --- placement ---

    def take(self, x) -> torch.Tensor:
        """This rank's columns (last dimension) of a host array or tensor,
        as a contiguous tensor on the rank's device."""
        if isinstance(x, np.ndarray):
            return torch.as_tensor(np.ascontiguousarray(x[..., self.lo:self.hi]),
                                   device=self.device)
        return x[..., self.lo:self.hi].contiguous().to(self.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full width of a column-sharded tensor (last dimension), on
        every rank."""
        width = max(self.widths)
        dtype = x.dtype
        y = x.to(torch.uint8) if dtype == torch.bool else x
        if self.n < width:
            y = torch.nn.functional.pad(y, (0, width - self.n))
        parts = all_gather(y, self.group, self.size)
        out = torch.cat([p[..., :w] for p, w in zip(parts, self.widths)], dim=-1)
        return out.to(dtype) if dtype == torch.bool else out

    # --- the per-pivot collectives ---

    def best(self, key: torch.Tensor, loc: torch.Tensor, any_local: torch.Tensor):
        """The winning (global index, any eligible) over the ranks from each
        rank's ``key`` (last dimension; per LP with a leading batch
        dimension) at its first maximum ``loc``: the highest key, the
        lowest global index on a tie, a NaN key winning as under
        ``torch.argmax``."""
        top = torch.take_along_dim(key, loc.unsqueeze(-1), dim=-1).squeeze(-1)
        packed = torch.stack([
            top.to(torch.float64),
            (loc + self.lo).to(torch.float64),
            any_local.to(torch.float64),
        ])
        g = all_gather(packed, self.group, self.size)  # (ranks, 3, ...)
        win = torch.argmax(g[:, 0], dim=0, keepdim=True)  # first max: lowest rank
        q = torch.take_along_dim(g[:, 1], win, dim=0)[0].to(torch.int64)
        return q, g[:, 2].amax(dim=0) > 0

    def _local(self, idx: torch.Tensor):
        """(clamped local index, owned) of global column indices."""
        local = idx.to(torch.int64) - self.lo
        own = (local >= 0) & (local < self.n)
        return local.clamp(0, self.n - 1), own

    def fetch(self, A, c, q, basis):
        """(A[:, q], c[q], c[basis]) from the owners, in one all_reduce.
        Single LP: A (M, n), c (n,), q 0-d, basis (M,); batch: a leading
        dimension on each."""
        single = A.dim() == 2
        if single:
            A, c, q, basis = A[None], c[None], q.reshape(1), basis[None]
        Bt, M, _ = A.shape
        iq, own_q = self._local(q.reshape(Bt, 1))
        col = torch.take_along_dim(A, iq[:, None, :], dim=2).reshape(Bt, M)
        col = torch.where(own_q, col, 0)
        ids = torch.cat([q.reshape(Bt, 1).to(torch.int64), basis.to(torch.int64)], dim=1)
        ic, own_c = self._local(ids)
        cv = torch.where(own_c, torch.take_along_dim(c, ic, dim=1), 0)
        packed = all_reduce(torch.cat([col, cv.to(col.dtype)], dim=1), self.group)
        a_q, c_q, cB = packed[:, :M], packed[:, M], packed[:, M + 1:]
        c_q, cB = c_q.to(c.dtype), cB.to(c.dtype)
        if single:
            return a_q[0], c_q[0], cB[0]
        return a_q, c_q, cB

    def basis_columns(self, A, c, basis):
        """(B, c_B) = (A[:, basis], c[basis]) exactly, each rank filling the
        columns it owns: one all_reduce of (M, M) + M."""
        single = A.dim() == 2
        if single:
            A, c, basis = A[None], c[None], basis[None]
        Bt, M, _ = A.shape
        ib, own = self._local(basis)
        B = torch.where(own[:, None, :], torch.take_along_dim(A, ib[:, None, :], dim=2), 0)
        cB = torch.where(own, torch.take_along_dim(c, ib, dim=1), 0)
        packed = all_reduce(torch.cat([B.reshape(Bt, M * M), cB.to(B.dtype)], dim=1),
                            self.group)
        B, cB = packed[:, : M * M].reshape(Bt, M, M), packed[:, M * M:].to(c.dtype)
        return (B[0], cB[0]) if single else (B, cB)

    def put(self, x: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
        """A copy of the (n,) column-sized ``x`` with ``value`` at global
        column ``idx`` (one index) where this rank owns it."""
        return torch.where(self.ids == idx.to(torch.int64), value, x)


def _group(mesh, axis: str):
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis)


def column_shard(mesh, N: int, device) -> ColumnShard:
    """This rank's block of N columns over the mesh's "col" axis."""
    group, size, rank = _group(mesh, "col")
    return ColumnShard(group, size, rank, N, device)


def batch_block(mesh, B: int):
    """This rank's [lo, hi) of B scenarios over the "batch" axis, or
    (0, B) when B does not divide it (the batch is then replicated)."""
    _, size, rank = _group(mesh, "batch")
    if B % size:
        return 0, B
    return _bounds(B, size, rank)


def shard_problem(mesh, A, b, c, candidate_mask):
    """This rank's column block of the tableau, its costs and mask; b is
    replicated."""
    shard = column_shard(mesh, A.shape[1], A.device)
    return shard.take(A), b, shard.take(c), shard.take(candidate_mask)


def shard_state(mesh, state, N: Optional[int] = None):
    """The state (a ``SimplexState`` or the LU engine's ``LUState``) with
    its N-sized members (``in_basis``, ``gamma`` and, where it has one,
    ``d``) cut to this rank's columns; the carry stays replicated."""
    N = state.in_basis.shape[-1] if N is None else N
    shard = column_shard(mesh, N, state.in_basis.device)
    names = [name for name in ("in_basis", "gamma", "d") if name in state._fields]
    return state._replace(**{name: shard.take(getattr(state, name)) for name in names})


def shard_batch_problem(mesh, A, b, c, candidate_mask, A_scan=None):
    """This rank's scenarios (over "batch" when B divides that axis, else
    all of them) and column block (over "col") of batched (B, ...) problem
    arrays.  A tableau shared by the batch (batch stride 0) stays one block,
    expanded again."""
    lo, hi = batch_block(mesh, A.shape[0])
    shard = column_shard(mesh, A.shape[-1], A.device)

    def tab(T):
        if T is None:
            return None
        if T.shape[0] > 1 and T.stride(0) == 0:
            return shard.take(T[0]).expand(hi - lo, *T.shape[1:-1], shard.n)
        return shard.take(T[lo:hi])

    return (tab(A), b[lo:hi].contiguous(), shard.take(c[lo:hi]),
            shard.take(candidate_mask[lo:hi]), tab(A_scan))


def shard_batch_state(mesh, batch_state):
    """This rank's scenarios of a batched state, its (B, N) members cut to
    the rank's columns."""
    lo, hi = batch_block(mesh, batch_state.basis.shape[0])
    shard = column_shard(mesh, batch_state.in_basis.shape[-1],
                         batch_state.in_basis.device)
    rows = type(batch_state)(*(t[lo:hi].contiguous() for t in batch_state))
    return rows._replace(
        in_basis=shard.take(rows.in_basis),
        gamma=shard.take(rows.gamma),
        d=shard.take(rows.d),
    )


def sharded_run_chunk(shard: ColumnShard, state, A_scan, A_full, c, candidate_mask,
                      **kwargs):
    """``relp_tpu_torch.simplex.kernels.run_chunk`` (or, for an ``LUState``,
    ``lu.lu_run_chunk``) on column-sharded inputs: the same pivots, with the
    collectives above.  ``shard`` is the ``column_shard`` of the LP's global
    N (the local blocks do not tell it)."""
    from relp_tpu_torch.simplex.kernels import run_chunk
    from relp_tpu_torch.simplex.lu import LUState, lu_run_chunk

    run = lu_run_chunk if isinstance(state, LUState) else run_chunk
    return run(state, A_scan, A_full, c, candidate_mask, shard=shard, **kwargs)
