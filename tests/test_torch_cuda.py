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
to 1 + max|plain|; two launches give the same bits), and solve_batch on
CUDA must reach the CPU's verdicts and exact objectives through them.
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


def _toy_batch(device, B, m, n):
    """tests/test_pallas_batch.py's toy batch: B synthetic LPs (pad 32, f32)
    at their artificial start, as the kernels' twelve arguments."""
    from __graft_entry__ import _synthetic_problem

    probs = [_synthetic_problem(m=m, n=n, pad=32, seed=s, dtype=np.float32)
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
