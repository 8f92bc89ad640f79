"""Tests of relp_tpu_torch that need a CUDA card (marker ``cuda``).

They skip without a card.  The card's machine has no jax, so this file
imports none, and it runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The hand-written scan kernel is held against its plain PyTorch version on
the same tensors (|err| <= tol * (1 + max|plain|): f32 1e-5, f64 1e-12,
summation order only), and the main path on CUDA must reach the exact
verdicts the port reaches on the CPU.  The batched-pivot kernels are held
against batched_pivot_chunk_reference at the JAX megakernel tests' toy
shapes (identical pivots; xB 1e-4, pi 1e-3, Binv 1e-3, gamma 1e-2 relative
to 1 + max|plain|; two launches give the same bits), give the same bits on
one tableau expanded over the batch as on B copies of it; their shared
memory is the wrapper's formula; and solve_batch on CUDA must reach the
CPU's verdicts and exact objectives through them.  The precision probe's
kernels keep TF32 above 1e-6 relative error and the others below it.
The three other solve modes (``--mip``, ``--first-order``, ``--basis-inverse
lu``) give the CPU's payload on knap6, and PDHG on CUDA walks the CPU's
iterations.
"""

import os

import numpy as np
import pytest
import torch

from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.ops import batch_pivot, price_scan
from relp_tpu_torch.simplex import SolveStatus, solve_general_form
from relp_tpu_torch.testing import generated_lp, scenario_family

pytestmark = pytest.mark.cuda

KNAP6 = os.path.join(os.path.dirname(__file__), "data", "knap6.mps")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "M,N,dtype,tol",
    [(8, 128, torch.float32, 1e-5), (100, 1000, torch.float32, 1e-5),
     (1024, 5120, torch.float32, 1e-5), (1, 3, torch.float64, 1e-12),
     (384, 1920, torch.float64, 1e-12)],
)
def test_scan_kernel_matches_plain(cuda_device, M, N, dtype, tol):
    rng = np.random.default_rng(M * N)
    as_t = lambda x: torch.as_tensor(x, device=cuda_device).to(dtype)  # noqa: E731
    P, A = as_t(rng.standard_normal((3, M))), as_t(rng.standard_normal((M, N)))
    c, g = as_t(rng.standard_normal(N)), as_t(1.0 + np.abs(rng.standard_normal(N)))
    gq = as_t(1.0 + abs(float(rng.standard_normal())) * 5)
    launches = price_scan.LAUNCHES
    d_k, g_k = price_scan.fused_price_scan(P, A, c, g, gq)
    torch.cuda.synchronize()
    assert price_scan.LAUNCHES == launches + 1
    d_p, g_p = price_scan.fused_price_scan_reference(P, A, c, g, gq)
    for kern, plain in ((d_k, d_p), (g_k, g_p)):
        scale = 1.0 + float(plain.abs().max())
        assert float((kern - plain).abs().max()) <= tol * scale


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
