"""Tests of relp_tpu_torch that need a CUDA card (marker ``cuda``).

They skip without a card.  The card's machine has no jax, so this file
imports none, and it runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The hand-written scan kernel is held against its plain PyTorch version on
the same tensors (|err| <= tol * (1 + max|plain|): f32 1e-5, f64 1e-12,
summation order only; bf16 5e-2, S and the outputs rounded to 8 bits at
other places), one launch a call, two launches bitwise equal, under its
own tiling and every tiling the timing tool sweeps; the main path on CUDA must reach the exact
verdicts the port reaches on the CPU.  The batched-pivot kernels are held
against batched_pivot_chunk_reference at the JAX megakernel tests' toy
shapes (identical pivots; xB 1e-4, pi 1e-3, Binv 1e-3, gamma 1e-2 relative
to 1 + max|plain|; two launches give the same bits), give the same bits on
one tableau expanded over the batch as on B copies of it; their shared
memory is the wrapper's formula; and solve_batch on CUDA must reach the
CPU's verdicts and exact objectives through them.  The precision probe's
kernels keep TF32 above 1e-6 relative error and the others below it, and
agree with their plain version on the card (1e-6 * max|plain|, the outer
product bitwise, two launches bitwise equal).  The eta-ring kernels give
the bits of the plain FTRAN loop and of the ordered BTRAN twin (one
vector, and the pair of two through one launch) at M = 30, 384, 1920,
1921 and 20,000, every ring fill, repeated rows, a zero pivot and a ring
of K = 150 past their chain group, and above the 48 KB default of shared
memory on every card; the slot-chain probe reads the last live
slot; LU chunks entering with
different ring fills replay one graph with the eager chunk's bits.
The three other solve modes (``--mip``, ``--first-order``, ``--basis-inverse
lu``) give the CPU's payload on knap6, and PDHG on CUDA walks the CPU's
iterations.  A dense chunk replayed from its CUDA graph gives the eager
chunk's bits, primal and dual, at an aligned, an unaligned and a ragged
shape; so do the LU chunk (entering with an empty ring and with etas in
it), the df32 chunk (with the eager chunk's scan launches) and the PDHG
chunk, and whole solves with ``basis_inverse="lu"`` and ``carry="df32"``
and ``pdhg_solve`` give the eager results through them; a second solve
of an LP of one shape captures nothing, replaying the process-wide cache,
with its eager solve's bits.  The batch
driver's steps (``_batch_step`` on the kernel route and the batched torch
path, the dual and the polish chunk) replayed from the process-wide cache
give the eager steps' bits and kernel launches, also a kernel-route graph
replayed after an eager launch at a smaller M; a kernel-route capture that
launches no kernel raises; solve_batch through graphs gives the eager
call's results; and with a tableau per LP, whose steps read it in place,
its peak memory stays within the largest graph pool and the cache's
static buffers of the eager call's, and it keeps nothing allocated that
the eager call does not.  In an NCCL world of one the sharded dense and
LU chunks, ``pdhg_solve(mesh=...)``, the sharded batch steps and
``solve_batch(mesh=...)`` replay graphs with their collectives captured,
bit for bit against eager, counting per replay the eager run's
collectives and launches.
"""

import os

import numpy as np
import pytest
import torch

from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.ops import batch_pivot, price_scan
from relp_tpu_torch.simplex import SolveStatus, solve_general_form
from relp_tpu_torch.testing import WARM_FAMILY, generated_lp, scenario_family

pytestmark = pytest.mark.cuda

KNAP6 = os.path.join(os.path.dirname(__file__), "data", "knap6.mps")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _scan_inputs(device, M, N, dtype):
    rng = np.random.default_rng(M * N)
    as_t = lambda x: torch.as_tensor(x, device=device).to(dtype)  # noqa: E731
    return (as_t(rng.standard_normal((3, M))), as_t(rng.standard_normal((M, N))),
            as_t(rng.standard_normal(N)), as_t(1.0 + np.abs(rng.standard_normal(N))),
            as_t(1.0 + abs(float(rng.standard_normal())) * 5))


def _assert_scan_close(outs, plain, tol):
    for kern, want in zip(outs, plain):
        scale = 1.0 + float(want.double().abs().max())
        assert float((kern.double() - want.double()).abs().max()) <= tol * scale


SCAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 5e-2}


# Rows 16-byte aligned and not (N sizeof(T) % 16: the masked tail path), a
# ragged last column tile, ragged cluster ranks, ranks whose P rows do not
# fit in shared memory (read through L1), and the main path's shape.
@pytest.mark.parametrize(
    "M,N,dtype",
    [(8, 128, torch.float32), (100, 1000, torch.float32), (7, 130, torch.float32),
     (1, 3, torch.float32), (1000, 780, torch.float32), (1000, 777, torch.float32),
     (5000, 256, torch.float32), (40000, 256, torch.float32), (100000, 7, torch.float32),
     (1024, 5120, torch.float32), (1920, 5248, torch.float32),
     (1, 3, torch.float64), (65, 1001, torch.float64), (384, 1920, torch.float64),
     (1920, 5248, torch.float64),
     (96, 1280, torch.bfloat16), (33, 1001, torch.bfloat16), (1000, 776, torch.bfloat16),
     (1024, 5120, torch.bfloat16), (1920, 5248, torch.bfloat16)],
)
def test_scan_kernel_matches_plain(cuda_device, M, N, dtype):
    """One launch a call, within the dtype's tolerance of the plain version,
    and a second launch bitwise equal to the first."""
    args = _scan_inputs(cuda_device, M, N, dtype)
    launches, by_dtype = price_scan.LAUNCHES, dict(price_scan.LAUNCHES_BY_DTYPE)
    d_k, g_k = price_scan.fused_price_scan(*args)
    torch.cuda.synchronize()
    assert price_scan.LAUNCHES == launches + 1
    name = str(dtype).replace("torch.", "")
    assert price_scan.LAUNCHES_BY_DTYPE[name] == by_dtype[name] + 1
    _assert_scan_close((d_k, g_k), price_scan.fused_price_scan_reference(*args),
                       SCAN_TOL[dtype])
    d_2, g_2 = price_scan.fused_price_scan(*args)
    for first, second in ((d_k, d_2), (g_k, g_2)):
        assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_scan_kernel_every_tiling_matches_plain(cuda_device, dtype):
    """Every tiling the timing tool sweeps (tiles of 128 B, 256 B and 512 B,
    clusters of 1-8 ranks) gives the plain version's result."""
    from relp_tpu_torch.tools.scan_timing import candidates

    M, N = 700, 1000
    args = _scan_inputs(cuda_device, M, N, dtype)
    plain = price_scan.fused_price_scan_reference(*args)
    for t in candidates(M, N, args[1].element_size()):
        _assert_scan_close(price_scan._launch(*args, t), plain, SCAN_TOL[dtype])


def test_scan_kernel_rejects_bad_arguments(cuda_device):
    A = torch.zeros((4, 6), device=cuda_device)
    ok = dict(P=torch.zeros((3, 4), device=cuda_device),
              c=torch.zeros(6, device=cuda_device),
              gamma=torch.ones(6, device=cuda_device))
    bad = [
        dict(ok, P=torch.zeros((3, 5), device=cuda_device)),  # shape
        dict(ok, c=torch.zeros(6, device=cuda_device, dtype=torch.float64)),  # dtype
        dict(ok, gamma=torch.ones(12, device=cuda_device)[::2]),  # contiguity
        dict(ok, c=torch.zeros(6)),  # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            price_scan.fused_price_scan(args["P"], A, args["c"], args["gamma"], 1.0)


# The eta ring of the LU engine (ops/eta_ring.py): K slots, the fills the
# CPU tests take (empty, one eta, partial, full, and the count K + 1 of a
# masked iteration's rho BTRAN on a full ring).
ETA_K = 60
ETA_FILLS = (0, 1, 23, ETA_K, ETA_K + 1)


def _eta_bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def _eta_cases(device, M, K, dtype, fills, seed):
    """(vals, rows, count, x) on ``device`` at each fill, then 37 slots
    (K - 1 past 37) on three rows again and again."""
    from relp_tpu_torch.testing import eta_ring_case

    cases = [eta_ring_case(M, K, dtype, fill, seed=seed) for fill in fills]
    cases.append(eta_ring_case(M, K, dtype, min(37, K - 1), seed=seed, repeat_rows=True))
    return [tuple(torch.as_tensor(np.asarray(a), device=device) for a in case)
            for case in cases]


def _eta_calls(kind, vals, rows, count, x):
    """(one launch, its plain version) of ``kind``: FTRAN against the plain
    loop, BTRAN against the ordered twin; the pair on x and on another
    vector whose count is one slot less (rho's and the Goldfarb BTRAN of an
    LU pivot)."""
    from relp_tpu_torch.ops import eta_ring

    if kind == "ftran":
        return (lambda: eta_ring.eta_ftran(vals, rows, count, x),
                lambda: eta_ring.eta_ftran_plain(vals, rows, count, x))
    if kind == "btran":
        return (lambda: eta_ring.eta_btran(vals, rows, count, x),
                lambda: eta_ring.eta_btran_plain(vals, rows, count, x, order="kernel"))
    w = torch.flip(x, (0,)).contiguous()
    count_b = torch.clamp_min(count - 1, 0)
    return (lambda: torch.cat(eta_ring.eta_btran_pair(vals, rows, count, x, count_b, w)),
            lambda: torch.cat(eta_ring.eta_btran_pair_plain(vals, rows, count, x, count_b, w,
                                                            order="kernel")))


@pytest.mark.parametrize("kind", ["ftran", "btran", "btran_pair"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("M", [30, 384, 1920, 1921, 20000])
def test_eta_ring_kernels_match_plain(cuda_device, M, dtype, kind):
    """Each eta-ring entry against its plain version on the same CUDA
    tensors, at every fill and with repeated rows: FTRAN the plain loop's
    bits, BTRAN and the pair the ordered twin's (eta_btran_plain(...,
    order="kernel")), and BTRAN within 1e-5 (f32) / 1e-12 (f64) of the
    matmul loop relative to its largest entry; one launch a call, two
    launches bitwise equal.  M from one tile and one block to 20,000 (79
    tiles of BTRAN's cluster, 157 FTRAN blocks)."""
    from relp_tpu_torch.ops import eta_ring

    for vals, rows, count, x in _eta_cases(cuda_device, M, ETA_K, dtype, ETA_FILLS, 7):
        launch, plain = _eta_calls(kind, vals, rows, count, x)
        before = dict(eta_ring.LAUNCHES)
        first, second = launch(), launch()
        torch.cuda.synchronize()
        assert eta_ring.LAUNCHES == {k: n + (2 if k == kind else 0) for k, n in before.items()}
        assert _eta_bits(first, plain()), (kind, int(count))
        assert _eta_bits(first, second), (kind, int(count))
        if kind == "btran":
            loop = eta_ring.eta_btran_plain(vals, rows, count, x)  # torch.matmul's order
            scale = float(loop.double().abs().max())
            tol = 1e-5 if dtype == np.float32 else 1e-12
            assert float((first.double() - loop.double()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eta_ring_kernels_past_the_chain_group(cuda_device, dtype):
    """K = 150, past the 64 slots of the kernels' chain group (whose G
    sits in shared memory; past it the chain reads the ring from L2), at
    fills 0, 1, 64, 65, 130, 150 and 151 and with repeated rows: every
    entry the bits of its plain version."""
    from relp_tpu_torch.ops import eta_ring

    K = 150
    assert K > eta_ring.CHAIN_SLOTS
    for vals, rows, count, x in _eta_cases(cuda_device, 1920, K, dtype,
                                           (0, 1, 64, 65, 130, K, K + 1), 11):
        for kind in ("ftran", "btran", "btran_pair"):
            launch, plain = _eta_calls(kind, vals, rows, count, x)
            got = launch()
            torch.cuda.synchronize()
            assert _eta_bits(got, plain()), (kind, int(count))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eta_ring_kernels_zero_pivot(cuda_device, dtype):
    """A zero pivot w_k[r_k]: the plain versions' inf and NaN, and their
    bits wherever they are not NaN."""
    from relp_tpu_torch.testing import eta_ring_case

    vals, rows, count, x = eta_ring_case(384, ETA_K, dtype, 9, seed=3)
    vals[4, rows[4]] = 0.0
    vals, rows, count, x = (torch.as_tensor(np.asarray(a), device=cuda_device)
                            for a in (vals, rows, count, x))
    for kind in ("ftran", "btran", "btran_pair"):
        launch, plain = _eta_calls(kind, vals, rows, count, x)
        got, want = launch(), plain()
        assert not torch.isfinite(want).all()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert _eta_bits(got[keep], want[keep])


def test_eta_ring_kernels_reject_bad_arguments(cuda_device):
    from relp_tpu_torch.ops import eta_ring

    vals = torch.zeros((4, 6), device=cuda_device)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    count = torch.zeros((), dtype=torch.int32, device=cuda_device)
    x = torch.zeros(6, device=cuda_device)
    for args in ((vals, rows, count, x.double()), (vals, rows.long(), count, x),
                 (vals, rows, count.cpu(), x), (vals[:, :5], rows, count, x),
                 (torch.zeros((6, 4), device=cuda_device).T, rows, count, x)):
        for fn in (eta_ring.eta_ftran, eta_ring.eta_btran):
            with pytest.raises(ValueError):
                fn(*args)
        with pytest.raises(ValueError):
            eta_ring.eta_btran_pair(args[0], args[1], count, x, args[2], args[3])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eta_ring_kernels_take_large_shared_memory_on_every_card(cuda_device, dtype):
    """At K = 150 an FTRAN block takes 99 KB (f64; 50 KB f32) of shared
    memory, above the 48 KB a block gets without opting in: on each card of
    the process in turn (the opt-in is per card), every entry gives its
    plain version's bits."""
    from relp_tpu_torch.testing import eta_ring_case

    case = eta_ring_case(13000, 150, dtype, 141, seed=9)
    for index in range(torch.cuda.device_count()):
        device = torch.device("cuda", index)
        vals, rows, count, x = (torch.as_tensor(np.asarray(a), device=device)
                                for a in case)
        with torch.cuda.device(device):
            for kind in ("ftran", "btran", "btran_pair"):
                launch, plain = _eta_calls(kind, vals, rows, count, x)
                got = launch()
                torch.cuda.synchronize()
                assert _eta_bits(got, plain()), (kind, index)


@pytest.mark.parametrize("kind", ["ftran", "btran"])
def test_slot_chain_probe_reads_the_last_live_slot(cuda_device, kind):
    """The slot-chain probe (csrc/slot_chain.cu) walks the live slots: each
    thread's output is the element of the last live w_k its neighbour
    read, zero with no live slot."""
    from relp_tpu_torch.testing import eta_ring_case
    from relp_tpu_torch.tools.eta_ring_timing import slot_chain

    vals, _rows, count, _x = (torch.as_tensor(np.asarray(a), device=cuda_device)
                              for a in eta_ring_case(1920, ETA_K, np.float32, 59))
    got = slot_chain(kind, vals, count)
    assert torch.equal(got, vals[58, (torch.arange(1024, device=cuda_device) + 1) % 1024])
    assert not slot_chain(kind, vals, torch.zeros_like(count)).any()


def test_graphed_lu_chunks_replay_one_eta_ring_capture(cuda_device):
    """LU chunks entering with different ring fills replay one CUDA graph
    (the eta-ring kernels read the fill on the device), each bitwise equal
    to the eager chunk with the kernels, a replay counting the eager
    chunk's eta-ring launches."""
    from relp_tpu_torch.simplex import graphs, kernels, lu
    from relp_tpu_torch.testing import lu_start

    state, A, c1, _c2, mask = lu_start(m=120, n=264, pad=64, seed=7, capacity=60,
                                       device=cuda_device)
    kw = dict(pricing=kernels.PRICE_STEEPEST, chunk=20, opt_tol=1e-7, pivot_tol=1e-7,
              degen_tol=1e-7)
    cache, eager, graphed, entries = graphs.ChunkGraphs(), state, state, []
    for _ in range(3):
        entries.append(int(eager.eta_count))
        eager, n_eager = _counted(
            lambda: lu.lu_run_chunk(eager, A, A, c1, mask, early_exit=False, **kw))
        graphed, n_graphed = _counted(lambda: cache.lu_run_chunk(graphed, A, A, c1, mask,
                                                                 **kw))
        assert n_graphed == n_eager and n_eager["eta_ftran"] > 0
        # A steepest-edge pivot's BTRANs are one pair: no BTRAN of one vector.
        assert n_eager["eta_btran_pair"] == n_eager["eta_ftran"] and n_eager["eta_btran"] == 0
        _state_bits_equal(graphed, eager)
    assert len(set(entries)) == 3
    assert cache.captured(lu.lu_run_chunk, "eta0") == {None: 1}


# An aligned chunk (rows of 16-byte multiples), an unaligned one (N * 4 not
# a multiple of 16: the scan's masked tail) and a ragged one (the rows split
# over a cluster, a partial last column tile): (m, n, pad) of
# testing.synthetic_start, lowered 128x448, 30x91 and 300x1001.
CHUNK_SHAPES = {"aligned": (120, 264, 64), "unaligned": (30, 61, 1),
                "ragged": (300, 701, 1)}


@pytest.mark.parametrize("kind", ["steepest", "stop_at_zero", "float64",
                                  "bfloat16_scan", "dual"])
@pytest.mark.parametrize("shape", sorted(CHUNK_SHAPES))
def test_graphed_chunk_equals_eager_chunk(cuda_device, shape, kind):
    """A chunk replayed from its CUDA graph (simplex/graphs.py) against the
    eager chunk from the same state: every field bitwise equal, the same
    scan launches counted, and a second replay from the first one's output
    equal to the second eager chunk."""
    from relp_tpu_torch.simplex import graphs, kernels
    from relp_tpu_torch.testing import chunk_case, synthetic_start

    m, n, pad = CHUNK_SHAPES[shape]
    state, A, c1, _c2, mask = synthetic_start(m=m, n=n, pad=pad, dtype=np.float32,
                                              seed=7, device=cuda_device)
    name, args, kw = chunk_case(kind, state, A, c1, mask, chunk=40)
    cache = graphs.ChunkGraphs()
    eager_state = graphed_state = args[0]
    for _ in range(2):
        launches = price_scan.LAUNCHES
        eager_state = getattr(kernels, name)(eager_state, *args[1:], **kw)
        eager_launches = price_scan.LAUNCHES - launches
        graphed_state = getattr(cache, name)(graphed_state, *args[1:], **kw)
        torch.cuda.synchronize()
        assert price_scan.LAUNCHES - launches == 2 * eager_launches
        assert (eager_launches > 0) == (name == "run_chunk")
        for field, g, e in zip(eager_state._fields, graphed_state, eager_state):
            assert g.dtype == e.dtype and torch.equal(
                g.reshape(-1).view(torch.uint8), e.reshape(-1).view(torch.uint8)), field
    assert int(eager_state.iteration) > 0


@pytest.mark.parametrize("kind", ["lu_steepest", "lu_steepest_eta", "lu_stop_at_zero_eta",
                                  "lu_dantzig_eta", "df32", "pdhg"])
@pytest.mark.parametrize("shape", sorted(CHUNK_SHAPES))
def test_graphed_body_equals_eager_chunk(cuda_device, shape, kind):
    """The LU, df32 and PDHG chunks of testing.body_case replayed from their
    CUDA graphs against the eager chunk from the same state: every field
    bitwise equal, the same scan launches counted (the df32 chunk's only),
    and a replay from the first one's output equal to the eager chunk
    from there."""
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import body_case

    m, n, pad = CHUNK_SHAPES[shape]
    start, eager, graphed = body_case(kind, m, n, pad=pad, device=cuda_device, chunk=40)
    cache = graphs.ChunkGraphs()
    state = start
    for _ in range(2 if kind != "pdhg" else 1):
        launches = price_scan.LAUNCHES
        want = eager(state)
        eager_launches = price_scan.LAUNCHES - launches
        got = graphed(cache, state)
        torch.cuda.synchronize()
        assert price_scan.LAUNCHES - launches == 2 * eager_launches
        assert (eager_launches > 0) == (kind == "df32")
        for field, g, e in zip(want._fields, got, want):
            assert g.dtype == e.dtype and torch.equal(
                g.reshape(-1).view(torch.uint8), e.reshape(-1).view(torch.uint8)), field
        state = got
    if kind != "pdhg":
        assert int(want.iteration) > int(start.iteration)


@pytest.mark.parametrize("mode", ["lu", "df32", "pdhg"])
def test_graphed_solves_equal_eager_solves(cuda_device, mode):
    """A solve on the card with every chunk replayed from its graph and the
    same solve with graphs.DEVICE_TYPES emptied (eager chunks): the same
    verdict, exact objective, basis, pivots and chunks (basis_inverse="lu",
    carry="df32"), the same PDHG point bit for bit and statistics."""
    from relp_tpu_torch.firstorder import pdhg
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import pdhg_lp

    def solve():
        if mode == "pdhg":
            x, y, st = pdhg.pdhg_solve(*pdhg_lp(64, 256, 7), max_iters=4_000,
                                       device=cuda_device)
            return x.tobytes(), y.tobytes(), st.iterations, st.restarts
        cfg = dict(basis_inverse="lu") if mode == "lu" else dict(carry="df32")
        result, _solution = solve_general_form(generated_lp(64, 256, 7),
                                               SolverConfig(**cfg))
        assert result.stats.certified
        return (result.status, result.exact_objective, result.basis,
                result.stats.iterations, result.stats.chunks)

    replays = graphs.REPLAYS
    graphed = solve()
    assert graphs.REPLAYS > replays
    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        replays = graphs.REPLAYS
        assert solve() == graphed
        assert graphs.REPLAYS == replays
    finally:
        graphs.DEVICE_TYPES = kept


def test_graphed_solves_of_one_shape_share_the_process_cache(cuda_device):
    """Two solve_general_form calls with LPs of one shape: the first
    captures its chunks into the process-wide cache, the second captures
    nothing and replays them, and each gives, bit for bit, what its solve
    with graphs.DEVICE_TYPES emptied (eager chunks) gives: the verdict,
    the exact and the float objective, the basis, the pivots and chunks."""
    from relp_tpu_torch.simplex import graphs

    def solve(seed):
        result, _solution = solve_general_form(generated_lp(64, 256, seed), SolverConfig())
        assert result.stats.certified
        return (result.status, result.exact_objective, result.objective, result.basis,
                result.stats.iterations, result.stats.phase1_iterations,
                result.stats.chunks)

    graphs._CHUNKS = None
    graphed, captures = [], []
    for seed in (7, 8):
        before = graphs.CAPTURES
        graphed.append(solve(seed))
        captures.append(graphs.CAPTURES - before)
    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        replays = graphs.REPLAYS
        assert [solve(seed) for seed in (7, 8)] == graphed
        assert graphs.REPLAYS == replays
    finally:
        graphs.DEVICE_TYPES = kept
    assert captures[0] > 0 and captures[1] == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_main_path_on_cuda_matches_cpu(cuda_device, dtype):
    verdicts = {}
    for platform in ("cpu", "cuda"):
        launches = price_scan.LAUNCHES
        result, solution = solve_general_form(
            generated_lp(64, 256, 7), SolverConfig(dtype=dtype, platform=platform)
        )
        verdicts[platform] = (result.status, result.stats.certified,
                              solution.objective_value)
        if platform == "cuda":
            assert price_scan.LAUNCHES > launches
    assert verdicts["cuda"] == verdicts["cpu"]
    assert verdicts["cuda"][:2] == (SolveStatus.FINITE_OPTIMUM, True)


def test_cli_on_cuda(cuda_device, capsys):
    import json

    from relp_tpu_torch.__main__ import main

    assert main(["solve", "--json", KNAP6]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["status"], out["objective"], out["certified"]) == (
        "finite_optimum", "-30", True)


@pytest.mark.parametrize("mode", [["--mip"], ["--first-order"], ["--basis-inverse", "lu"]])
def test_cli_solve_modes_on_cuda_match_cpu(cuda_device, capsys, mode):
    """knap6 as a MIP, by PDHG + crossover and on the LU engine: exact -30,
    certified, and the CPU's payload (timing aside); the MIP path launches
    the scan kernel."""
    import json

    from relp_tpu_torch.__main__ import main

    payloads = {}
    for platform in ("cpu", "cuda"):
        launches = price_scan.LAUNCHES
        assert main(["solve", "--json", "--platform", platform, *mode, KNAP6]) == 0
        payloads[platform] = json.loads(capsys.readouterr().out)
        payloads[platform].pop("wall_time_s", None)
        if platform == "cuda" and mode[0] == "--mip":
            assert price_scan.LAUNCHES > launches
    assert payloads["cuda"] == payloads["cpu"]
    assert (payloads["cuda"]["objective"], payloads["cuda"]["certified"]) == ("-30", True)


def test_pdhg_on_cuda_matches_cpu(cuda_device):
    """pdhg_solve in f64 on a 13x37 LP: CUDA's iterations and restarts are
    the CPU's, the iterates within 1e-9 relative."""
    from relp_tpu_torch.firstorder.pdhg import pdhg_solve

    rng = np.random.default_rng(7)
    A = np.abs(rng.standard_normal((13, 37))) + 0.1
    b = A @ np.abs(rng.standard_normal(37))
    c = rng.standard_normal(37)
    runs = {dev: pdhg_solve(A, b, c, tol=1e-9, dtype=np.float64, device=dev)
            for dev in ("cpu", "cuda")}
    (x0, y0, s0), (x1, y1, s1) = runs["cpu"], runs["cuda"]
    assert s0.converged and s1.converged
    assert (s1.iterations, s1.restarts) == (s0.iterations, s0.restarts)
    for mine, want in ((x1, x0), (y1, y0)):
        assert np.abs(mine - want).max() <= 1e-9 * (1 + np.abs(want).max())


def _toy_batch(device, B, m, n):
    """tests/test_pallas_batch.py's toy batch: B synthetic LPs (pad 32, f32)
    at their artificial start, as the kernels' twelve arguments."""
    from relp_tpu_torch.testing import synthetic_problem

    probs = [synthetic_problem(m=m, n=n, pad=32, seed=s, dtype=np.float32)
             for s in range(B)]
    A, b, c1, _c2, cand, basis = (np.stack(x) for x in zip(*probs))
    _, M, N = A.shape
    in_basis = np.zeros((B, N), dtype=bool)
    np.put_along_axis(in_basis, basis.astype(np.int64), True, axis=1)
    cB = np.take_along_axis(c1, basis.astype(np.int64), axis=1)
    zeros = np.zeros(B, dtype=np.int32)
    arrays = (A, c1, cand, np.tile(np.eye(M, dtype=np.float32), (B, 1, 1)), b,
              cB, basis, in_basis, np.ones((B, N), np.float32), zeros, zeros, zeros)
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays]


@pytest.mark.parametrize("variant,m,n", [("resident", 32, 64), ("blocked", 48, 192),
                                         ("resident", 48, 192), ("blocked", 32, 64)])
@pytest.mark.parametrize("stop_at_zero", [True, False])
def test_batch_pivot_kernels_match_plain(cuda_device, variant, m, n, stop_at_zero):
    kern = (batch_pivot.batched_pivot_chunk if variant == "resident"
            else batch_pivot.batched_pivot_chunk_blocked)
    args = _toy_batch(cuda_device, 3, m, n)
    kw = dict(chunk=25, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7,
              stop_at_zero=stop_at_zero)
    counter = "LAUNCHES_RESIDENT" if variant == "resident" else "LAUNCHES_BLOCKED"
    launches = getattr(batch_pivot, counter)
    out, again = kern(*args, **kw), kern(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(batch_pivot, counter) == launches + 2
    plain = batch_pivot.batched_pivot_chunk_reference(*args, **kw)
    names = ("Binv", "xB", "pi", "basis", "in_basis", "gamma", "status",
             "iteration", "degen")
    for name, k, k2, p in zip(names, out, again, plain):
        assert torch.equal(k, k2), name
        if name in ("basis", "in_basis", "status", "iteration"):
            assert torch.equal(k, p), name
    tol = {"xB": 1e-4, "pi": 1e-3, "Binv": 1e-3, "gamma": 1e-2}
    for name, k, p in zip(names, out, plain):
        if name in tol:
            scale = 1.0 + float(p.abs().max())
            assert float((k - p).abs().max()) <= tol[name] * scale, name
    assert int(out[7].sum()) > 0


def test_batch_pivot_kernels_reject_bad_arguments(cuda_device):
    args = _toy_batch(cuda_device, 2, 32, 64)
    kw = dict(chunk=5, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7)
    bad = [
        (0, args[0].double()),  # dtype
        (3, args[3][:, :, :-1]),  # shape
        (4, torch.zeros(2, args[4].shape[1] * 2, device=cuda_device)[:, ::2]),  # contiguity
        (8, args[8].cpu()),  # device
        (6, args[6].long()),  # index dtype
    ]
    for fn in (batch_pivot.batched_pivot_chunk, batch_pivot.batched_pivot_chunk_blocked):
        for i, value in bad:
            broken = list(args)
            broken[i] = value
            with pytest.raises(ValueError):
                fn(*broken, **kw)
        with pytest.raises(ValueError):
            fn(*args, noise_eps=4e-3, **kw)
    # An inverse too large for a block's shared memory: the resident kernel refuses.
    big = _toy_batch(cuda_device, 1, 250, 300)
    with pytest.raises(ValueError, match="shared memory"):
        batch_pivot.batched_pivot_chunk(*big, **kw)


@pytest.mark.parametrize("m,n,counter", [(16, 48, "LAUNCHES_RESIDENT"),
                                         (150, 200, "LAUNCHES_BLOCKED")])
def test_solve_batch_on_cuda_matches_cpu(cuda_device, m, n, counter):
    """A small generated family through the batched-pivot kernels on CUDA:
    the verdicts and exact objectives of the CPU run (M=128 takes the
    resident kernel, M=384 the blocked one)."""
    from relp_tpu_torch.parallel import solve_batch

    kw = dict(pad_to=128, chunk_size=150, refactor_period=150)
    verdicts = {}
    for platform in ("cpu", "cuda"):
        launches = getattr(batch_pivot, counter)
        results = solve_batch(scenario_family(m, n, 7, 4),
                              SolverConfig(platform=platform, **kw),
                              certify=True, shared_structure=True)
        verdicts[platform] = [(r.status, r.stats.certified, r.exact_objective)
                              for r in results]
        if platform == "cuda":
            assert getattr(batch_pivot, counter) > launches
    assert verdicts["cuda"] == verdicts["cpu"]
    assert all(v[:2] == (SolveStatus.FINITE_OPTIMUM, True) for v in verdicts["cuda"])


def _family_batch(device, m, n, count=4):
    """A generated family lowered by solve_batch's lower_batch at its
    phase-1 start (one tableau expanded over the batch), as the kernels'
    twelve arguments."""
    from relp_tpu_torch.parallel.batch import _v_gamma
    from relp_tpu_torch.parallel.batch_driver import lower_batch

    cfg = SolverConfig(platform="cuda", pad_to=128, chunk_size=150,
                       refactor_period=150)
    _p, A, _b, c1, _c2, cand, st = lower_batch(
        scenario_family(m, n, 7, count), cfg, device, shared_structure=True)
    assert A.stride(0) == 0
    gamma = _v_gamma(st.Binv, A, st.in_basis)
    return [A, c1, cand, st.Binv, st.xB, st.pi, st.basis, st.in_basis, gamma,
            st.status, st.iteration, st.degen_count]


_PIVOT_OUTPUTS = (3, 4, 6, 7)  # basis, in_basis, status, iteration


@pytest.mark.parametrize("variant,m,n", [("resident", 16, 48), ("blocked", 150, 200),
                                         ("blocked", 16, 48)])
def test_batch_pivot_kernels_same_bits_on_one_shared_tableau(cuda_device, variant, m, n):
    """The kernel on one tableau expanded over the batch (batch stride 0)
    gives the bits it gives on B stacked copies, and the plain version's
    pivots."""
    kern = (batch_pivot.batched_pivot_chunk if variant == "resident"
            else batch_pivot.batched_pivot_chunk_blocked)
    args = _family_batch(cuda_device, m, n)
    kw = dict(chunk=25, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7,
              stop_at_zero=True)
    shared = kern(*args, **kw)
    copies = kern(args[0].contiguous(), *args[1:], **kw)
    plain = batch_pivot.batched_pivot_chunk_reference(*args, **kw)
    torch.cuda.synchronize()
    for k, k2 in zip(shared, copies):
        assert torch.equal(k, k2)
    for i in _PIVOT_OUTPUTS:
        assert torch.equal(shared[i], plain[i]), i
    assert int((shared[7] - args[10]).min()) > 0


@pytest.mark.parametrize("M,N", [(32, 96), (64, 256), (128, 384), (224, 544),
                                 (384, 640), (512, 1408), (1024, 4096), (128, 5120)])
def test_kernel_shared_memory_is_the_wrappers_formula(cuda_device, M, N):
    """csrc/batch_pivot.cu's smem_bytes equals ops/batch_pivot.py's for the
    resident layout (256 threads) and the blocked one (1024) with its
    default rows and with none."""
    import ctypes

    lib = batch_pivot._lib()
    lib.relp_batch_pivot_smem_bytes.restype = ctypes.c_longlong
    cases = [(M, True)] + [(R, False) for R in
                           {0, M, batch_pivot.blocked_rows(M, N) or 0}]
    for R, resident in cases:
        threads = batch_pivot._THREADS[resident]
        assert (lib.relp_batch_pivot_smem_bytes(M, N, R, int(resident))
                == batch_pivot._bytes(M, N, R, threads))


def test_probe_kernels_precision(cuda_device):
    """Single-pass TF32 loses digits (relative error above 1e-6, below
    1e-2 for a correct product); 3xTF32 and the outer product keep f32's
    (at most 1e-6)."""
    from relp_tpu_torch.tools import probe_dot_precision as probe

    before = dict(probe.LAUNCHES)
    err = probe.run(cuda_device)
    assert 1e-6 < err["tf32"] < 1e-2
    assert err["tf32x3"] <= 1e-6 and err["outer"] <= 1e-6
    assert all(probe.LAUNCHES[k] == before[k] + 1 for k in probe.KINDS)


@pytest.mark.parametrize("kind,M", [(kind, M) for kind in ("tf32", "tf32x3", "outer")
                                     for M in (64, 256, 512)]
                         + [("outer", M) for M in (320, 1920, 4096, 8192)])
def test_probe_kernel_matches_plain(cuda_device, kind, M):
    """Each probe kernel against its plain version on the card: the two
    products within 1e-6 * max|plain| (the same TF32 terms, summed in f32
    by the kernel and in f64 by the plain version), the outer product
    bitwise, also at M = 320 (80 float4s a row: blocks of 80 x 3 threads,
    the last row unit ragged), 1,920 (two chunks of a row, the second
    ragged; four rows a thread), 4,096 (C larger than L2) and 8,192 (the
    grid passes over C four times, each batch of A[i, 0] loaded ahead); two
    launches give the same bits and count one each."""
    from relp_tpu_torch.tools import probe_dot_precision as probe

    a, b = probe.inputs(cuda_device, M, seed=3)
    before = probe.LAUNCHES[kind]
    first, second = probe.probe_dot(kind, a, b), probe.probe_dot(kind, a, b)
    torch.cuda.synchronize()
    assert probe.LAUNCHES[kind] == before + 2
    assert torch.equal(first, second)
    plain = probe.probe_dot_reference(kind, a, b)
    assert plain.device == a.device
    err = float((first.double() - plain).abs().max())
    assert err <= (0.0 if kind == "outer" else 1e-6 * float(plain.abs().max()))


@pytest.mark.parametrize("M", [64, 4096])
def test_probe_outer_on_edge_values(cuda_device, M):
    """The outer kernel on every pair of EDGE_BITS (signed zeros,
    subnormals, infinities, NaNs, products that underflow, overflow or fall
    beside the flush's threshold): the plain version's f32 bits on the
    card and on the CPU, NaN in the same places; two launches the same.  At
    M = 64 a thread stores its one row alone; at 4,096 it runs the batched
    loop, four rows, and a row has four chunks."""
    from relp_tpu_torch.tools import probe_dot_precision as probe

    a, b = probe.edge_inputs(cuda_device, M)
    first, second = probe.probe_dot("outer", a, b), probe.probe_dot("outer", a, b)
    plain = probe.probe_dot_reference("outer", a, b).to(torch.float32)
    torch.cuda.synchronize()
    assert probe.same_bits(first, plain) and probe.same_bits(second, first)
    assert probe.same_bits(first.cpu(), probe.probe_dot_reference(
        "outer", a.cpu(), b.cpu()).to(torch.float32))


# Families of testing.step_case for the batch driver's captured steps: the
# resident kernel's shape (8 x 128x256), the blocked kernel's (3 x
# 384x896) and the warm family's first 16 scenarios (16 x 128x384).
STEP_FAMILIES = {"resident": dict(m=16, n=48, seed=7, count=8),
                 "blocked": dict(m=150, n=200, seed=7, count=3),
                 "warm": dict(WARM_FAMILY, count=16)}
BATCH_STEP_CASES = [("kernel", "resident", True), ("kernel", "resident", False),
                    ("kernel", "blocked", True), ("kernel", "blocked", False),
                    ("torch_float32", "resident", True), ("torch_float32", "resident", False),
                    ("torch_float64", "resident", True), ("torch_float64", "resident", False),
                    ("dual", "warm", None), ("polish", "resident", None)]


def _state_bits_equal(got, want):
    for field, g, e in zip(want._fields, got, want):
        assert g.dtype == e.dtype and torch.equal(
            g.reshape(-1).view(torch.uint8), e.reshape(-1).view(torch.uint8)), field


@pytest.mark.parametrize("kind,family,stop_at_zero", BATCH_STEP_CASES)
def test_graphed_batch_step_equals_eager_step(cuda_device, kind, family, stop_at_zero):
    """One of solve_batch's device steps (testing.step_case) through the
    process-wide cache against the eager step from the same state, three
    times in a row after the key's first use (which runs eagerly; the
    polish chunk's output is another key, first used at the second step):
    state and report bitwise equal, and the batched-pivot launches of the
    graphed steps those of the eager ones."""
    from relp_tpu_torch.parallel.batch_driver import _batch_step, run_step
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import step_case

    kw = {} if stop_at_zero is None else dict(stop_at_zero=stop_at_zero)
    body, state, inputs, static = step_case(kind, STEP_FAMILIES[family],
                                            device=cuda_device, **kw)
    run_step(body, state, inputs, graphed=True, **static)  # the first use
    graphed = eager = state
    replays = graphs.REPLAYS
    for _ in range(3):
        before = graphs.launch_counts()
        e = run_step(body, eager, inputs, graphed=False, **static)
        middle = graphs.launch_counts()
        g = run_step(body, graphed, inputs, graphed=True, **static)
        torch.cuda.synchronize()
        after = graphs.launch_counts()
        for name in ("resident", "blocked"):
            assert after[name] - middle[name] == middle[name] - before[name], name
        if static.get("must_launch"):
            assert middle[static["must_launch"]] == before[static["must_launch"]] + 1
        if body is _batch_step:
            assert torch.equal(g[1].view(torch.uint8), e[1].view(torch.uint8))
            g, e = g[0], e[0]
        _state_bits_equal(g, e)
        graphed, eager = g, e
    assert graphs.REPLAYS == replays + (2 if kind == "polish" else 3)
    assert int((eager.iteration - state.iteration).sum()) > 0


@pytest.mark.parametrize("variant", ["resident", "blocked"])
def test_graphed_kernel_step_replays_after_a_smaller_eager_launch(cuda_device, variant):
    """A kernel-route step captured at the family's M, then the same kernel
    launched eagerly at M=32 (csrc/batch_pivot.cu sets the kernel's
    shared-memory attribute to each launch's own size, lowering it), then
    the first graph replayed: the eager step's bits."""
    from relp_tpu_torch.parallel.batch_driver import run_step
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import step_case

    body, state, inputs, static = step_case("kernel", STEP_FAMILIES[variant],
                                            device=cuda_device)
    want, want_report = run_step(body, state, inputs, graphed=False, **static)
    cache = graphs.ChunkGraphs()
    cache.run(body, state, inputs, early_exit=False, **static)  # the capture
    kern = (batch_pivot.batched_pivot_chunk if variant == "resident"
            else batch_pivot.batched_pivot_chunk_blocked)
    small = _toy_batch(cuda_device, 3, 16, 32)
    smem = batch_pivot.smem_bytes(32, small[0].shape[2], resident=variant == "resident")
    _B, M, N = inputs["A"].shape
    assert smem < batch_pivot.smem_bytes(M, N, resident=variant == "resident")
    kern(*small, chunk=5, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7)
    got, report = cache.run(body, state, inputs, early_exit=False, **static)
    torch.cuda.synchronize()
    _state_bits_equal(got, want)
    assert torch.equal(report.view(torch.uint8), want_report.view(torch.uint8))


def test_graphed_kernel_step_that_launches_no_kernel_raises(cuda_device, monkeypatch):
    """A kernel-route capture on the card whose step launched no
    batched-pivot kernel (the plain version swapped in) raises."""
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import step_case

    monkeypatch.setattr(batch_pivot, "batched_pivot_chunk",
                        batch_pivot.batched_pivot_chunk_reference)
    body, state, inputs, static = step_case("kernel", STEP_FAMILIES["resident"],
                                            device=cuda_device, chunk=5)
    with pytest.raises(RuntimeError, match="launched no resident kernel"):
        graphs.ChunkGraphs().run(body, state, inputs, early_exit=False, **static)


@pytest.mark.parametrize("case", ["resident", "blocked", "float64", "warm"])
def test_graphed_batch_solve_equals_eager_solve(cuda_device, case):
    """solve_batch on the card with its steps replayed from the
    process-wide cache and with graphs.DEVICE_TYPES emptied (every step
    eager): the same statuses, exact objectives, bases and pivots, the same
    batched-pivot launches; a second graphed call replays, and captures
    only the steps the first took once; a third captures nothing."""
    from relp_tpu_torch.parallel import solve_batch
    from relp_tpu_torch.simplex import graphs, solve_relaxation
    from relp_tpu_torch.testing import scenario_base

    family = STEP_FAMILIES["warm" if case == "warm" else
                           "blocked" if case == "blocked" else "resident"]
    cfg = SolverConfig(dtype="float64" if case == "float64" else "float32",
                       pad_to=128, chunk_size=150, refactor_period=150)
    kw = dict(certify=True, shared_structure=True)
    if case == "warm":
        gf, counts = scenario_base(family["m"], family["n"], family["seed"])
        kw["warm_start_basis"] = solve_relaxation(gf.derive_matrix_data(counts),
                                                  cfg).basis

    def solve():
        before = graphs.launch_counts()
        results = solve_batch(scenario_family(**family), cfg, **kw)
        after = graphs.launch_counts()
        return ([(r.status, r.exact_objective, r.stats.certified, r.basis,
                  r.stats.iterations, r.stats.phase1_iterations,
                  r.stats.dual_iterations, r.stats.batch_fallback) for r in results],
                {k: after[k] - before[k] for k in ("resident", "blocked")})

    graphed, launches = solve()
    replays = graphs.REPLAYS
    assert solve() == (graphed, launches) and graphs.REPLAYS > replays
    captures = graphs.CAPTURES
    assert solve() == (graphed, launches) and graphs.CAPTURES == captures
    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        replays = graphs.REPLAYS
        assert solve() == (graphed, launches)
        assert graphs.REPLAYS == replays
    finally:
        graphs.DEVICE_TYPES = kept
    assert all(v[2] for v in graphed)
    if case == "warm":
        assert all(v[6] > 0 for v in graphed if not v[7])
    assert (launches["resident"] > 0) == (case == "resident")
    assert (launches["blocked"] > 0) == (case == "blocked")


def test_graphed_batch_with_stacked_tableaus_stays_within_one_pool_of_eager(
        cuda_device, capsys):
    """solve_batch with a tableau per LP (the default layout; 16 x 384x896,
    50-pivot chunks) with every step eager, then through the cache of
    steps, each from an empty cache: the same results; the graphed call's
    peak allocated memory at most the eager call's plus its largest graph
    pool and the cache's static buffers (no copy of the tableau: its steps
    read it in place); after the call the cache holds nothing of it, and no
    more stays allocated than after the eager call."""
    from relp_tpu_torch.parallel import solve_batch
    from relp_tpu_torch.simplex import graphs

    cfg = SolverConfig(pad_to=128, chunk_size=50, refactor_period=50)
    family = dict(STEP_FAMILIES["blocked"], count=16)
    at_release = {}
    release = graphs.ChunkGraphs.release

    def recording_release(cache, *tensors):
        entries = list(cache._entries.values())
        at_release.update(
            pool=max((e.pool_bytes for e in entries), default=0),
            slots=sum(slot.nbytes for slot in cache._slots.values()),
            entries=len(entries), bound=sum(bool(e.bound) for e in entries))
        return release(cache, *tensors)

    def solve(graphed):
        kept = graphs.DEVICE_TYPES
        graphs.DEVICE_TYPES = kept if graphed else ()
        graphs._STEPS = None
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            results = solve_batch(scenario_family(**family), cfg, certify=False)
            torch.cuda.synchronize()
            return ([(r.status, r.basis, r.stats.iterations) for r in results],
                    torch.cuda.max_memory_allocated() - before,
                    torch.cuda.max_memory_reserved(),
                    torch.cuda.memory_allocated() - before)
        finally:
            graphs.DEVICE_TYPES = kept

    eager, eager_peak, eager_reserved, eager_kept = solve(False)
    graphs.ChunkGraphs.release = recording_release
    try:
        replays = graphs.REPLAYS
        graphed, peak, reserved, kept = solve(True)
    finally:
        graphs.ChunkGraphs.release = release
    with capsys.disabled():
        print(f"\nstacked 16x384x896: peak allocated eager {eager_peak} graphed {peak}, "
              f"peak reserved eager {eager_reserved} graphed {reserved}, kept after "
              f"eager {eager_kept} graphed {kept}, at release {at_release}")
    assert graphed == eager and graphs.REPLAYS > replays
    assert at_release["entries"] > 0 and at_release["bound"] == at_release["entries"]
    assert peak <= eager_peak + at_release["pool"] + at_release["slots"]
    assert not graphs.steps()._entries and graphs.steps().nbytes() == 0
    assert kept <= eager_kept
    graphs._STEPS = None


@pytest.fixture(scope="module")
def nccl_mesh():
    """An NCCL world of one in this process (initialize_multihost with no
    torchrun environment) and its (1, 1) mesh; the process group and the
    caches of its sharded steps go at the end of the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the captured graphs run on one")
    import torch.distributed as dist

    from relp_tpu_torch.parallel import initialize_multihost, make_mesh, shutdown_multihost

    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")
           if k in os.environ}
    initialize_multihost()
    try:
        assert dist.get_backend() == "nccl"
        yield make_mesh((1, 1))
    finally:
        shutdown_multihost()
        os.environ.update(env)


def _sharded_chunk(mesh, name, args, kw):
    """The chunk ``name`` (of ``kernels`` and ``graphs.ChunkGraphs``: the
    dense ``run_chunk``, ``lu.lu_run_chunk`` as ``lu_run_chunk``) with its
    column-sized inputs and state cut to the mesh's column block: (state,
    args after the state, keywords with the shard)."""
    from relp_tpu_torch.parallel import column_shard, shard_state

    state, A_scan, A_full, c, mask = args
    shard = column_shard(mesh, A_full.shape[1], A_full.device)
    return (shard_state(mesh, state, A_full.shape[1]),
            tuple(shard.take(x) for x in (A_scan, A_full, c, mask)),
            dict(kw, shard=shard))


def _counted(fn):
    """fn()'s result and what it added to every counter of
    graphs.launch_counts (the collectives among them)."""
    from relp_tpu_torch.simplex import graphs

    before = graphs.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in graphs.launch_counts().items()}


@pytest.mark.parametrize("kind", ["steepest", "stop_at_zero", "float64", "bfloat16_scan",
                                  "lu_steepest", "lu_steepest_eta", "lu_dantzig_eta"])
def test_graphed_sharded_chunk_equals_eager_chunk(nccl_mesh, kind):
    """The dense and the LU chunk column-sharded over the NCCL world of one,
    replayed from a graph with its collectives captured, against the eager
    sharded chunk from the same state, twice in a row: every field bitwise
    equal, and a replay's collectives and scan launches those of the eager
    chunk."""
    from relp_tpu_torch.simplex import graphs, kernels, lu
    from relp_tpu_torch.testing import LU_ETA0, chunk_case, lu_start, synthetic_start

    m, n, pad = CHUNK_SHAPES["aligned"]
    if kind.startswith("lu_"):
        state, A, c1, _c2, mask = lu_start(m=m, n=n, pad=pad, seed=7, device="cuda")
        kw = dict(pricing=kernels.PRICE_DANTZIG if "dantzig" in kind
                  else kernels.PRICE_STEEPEST, chunk=40, opt_tol=1e-7, pivot_tol=1e-7,
                  degen_tol=1e-7)
        if kind.endswith("_eta"):  # etas in the ring at entry
            state = lu.lu_run_chunk(state, A, A, c1, mask, **dict(kw, chunk=LU_ETA0))
        name, args = "lu_run_chunk", (state, A, A, c1, mask)
        eager_body = lu.lu_run_chunk
    else:
        state, A, c1, _c2, mask = synthetic_start(m=m, n=n, pad=pad, dtype=np.float32,
                                                  seed=7, device="cuda")
        name, args, kw = chunk_case(kind, state, A, c1, mask, chunk=40)
        eager_body = kernels.run_chunk
    state, rest, kw = _sharded_chunk(nccl_mesh, name, args, kw)
    cache = graphs.ChunkGraphs()
    eager_state = graphed_state = state
    for _ in range(2):
        eager_state, eager_counts = _counted(
            lambda: eager_body(eager_state, *rest, early_exit=False, **kw))
        graphed_state, graphed_counts = _counted(
            lambda: getattr(cache, name)(graphed_state, *rest, **kw))
        assert graphed_counts == eager_counts and eager_counts["collectives"] > 0
        _state_bits_equal(graphed_state, eager_state)
    assert graphs.CAPTURES > 0 and int(eager_state.iteration) > int(state.iteration)


def test_graphed_sharded_pdhg_equals_eager(nccl_mesh):
    """pdhg_solve(mesh=...) over the NCCL world of one with its chunks
    replayed (the grid's reductions captured) and with graphs.DEVICE_TYPES
    emptied: the same point bit for bit, iterations, restarts and
    collectives; one capture a call."""
    from relp_tpu_torch.firstorder import pdhg
    from relp_tpu_torch.parallel import sharded
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import pdhg_lp

    def solve():
        sharded.COLLECTIVES = 0
        x, y, st = pdhg.pdhg_solve(*pdhg_lp(64, 256, 7), max_iters=4_000,
                                   device="cuda", mesh=nccl_mesh)
        return x.tobytes(), y.tobytes(), st.iterations, st.restarts, sharded.COLLECTIVES

    captures, replays = graphs.CAPTURES, graphs.REPLAYS
    graphed = solve()
    assert graphs.CAPTURES == captures + 1 and graphs.REPLAYS == replays + graphed[2] // 200
    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        assert solve() == graphed
    finally:
        graphs.DEVICE_TYPES = kept


@pytest.mark.parametrize("kind", ["torch_float32", "torch_float64", "polish"])
def test_graphed_sharded_batch_step_equals_eager_step(nccl_mesh, kind):
    """A sharded step of solve_batch(mesh=...) (testing.step_case with the
    mesh) through the cache of the mesh's column group against the eager
    step (fixed length, as captured), three times after the key's first
    use: state and report bitwise equal, a replay's collectives the eager
    step's."""
    from relp_tpu_torch.parallel.batch_driver import _batch_step, run_step
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import step_case

    body, state, inputs, static = step_case(kind, STEP_FAMILIES["resident"],
                                            device="cuda", mesh=nccl_mesh)
    run_step(body, state, inputs, graphed=True, **static)  # the first use
    graphed = eager = state
    replays = graphs.REPLAYS
    for _ in range(3):
        e, eager_counts = _counted(lambda: body(eager, **inputs, early_exit=False,
                                                **static))
        g, graphed_counts = _counted(lambda: run_step(body, graphed, inputs,
                                                      graphed=True, **static))
        assert graphed_counts == eager_counts and eager_counts["collectives"] > 0
        if body is _batch_step:
            assert torch.equal(g[1].view(torch.uint8), e[1].view(torch.uint8))
            g, e = g[0], e[0]
        _state_bits_equal(g, e)
        graphed, eager = g, e
    assert graphs.REPLAYS == replays + (2 if kind == "polish" else 3)
    assert graphs.steps(static["shard"].group)._entries


def test_graphed_sharded_batch_solve_equals_eager_solve(nccl_mesh):
    """solve_batch(mesh=...) on the resident family's small cut over the
    NCCL world of one: the eager call's results; a second call of the
    shape replays the first call's keys and a third captures nothing."""
    from relp_tpu_torch.parallel import solve_batch
    from relp_tpu_torch.simplex import graphs

    cfg = SolverConfig(pad_to=128, chunk_size=150, refactor_period=150)

    def solve():
        return [(r.status, r.exact_objective, r.stats.certified, r.basis,
                 r.stats.iterations) for r in solve_batch(
                     scenario_family(**STEP_FAMILIES["resident"]), cfg, certify=True,
                     shared_structure=True, mesh=nccl_mesh)]

    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        eager = solve()
    finally:
        graphs.DEVICE_TYPES = kept
    replays = graphs.REPLAYS
    assert solve() == eager and solve() == eager and graphs.REPLAYS > replays
    captures = graphs.CAPTURES
    assert solve() == eager and graphs.CAPTURES == captures
    assert all(v[2] for v in eager)
