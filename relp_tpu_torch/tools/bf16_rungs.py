"""Solves main/real's LP with the scans in bf16 under several scan
implementations and prints each rung of the escalation ladder.

    python -m relp_tpu_torch.tools.bf16_rungs [--platform cpu] [--parent DIR]
        [--max-iterations N] [VARIANT ...]

VARIANT is ``kernel`` (the hand-written scan, the default), ``plain``
(``fused_price_scan_reference`` in its place, torch on the tensors' device)
or ``parent`` (the scan kernel of the earlier tree in DIR, built and loaded
as ``scan_timing`` does).  Each variant runs ``solve_general_form`` on
``testing.generated_lp(**REAL_SIZE)`` with ``SolverConfig(scan_dtype=
"bfloat16", max_iterations=N)`` and prints, per rung, its dtype, status,
``certified``, pivots, phase-1 pivots and seconds, then the verdict and
the exact objective's digest check.  On the CPU only ``plain`` runs (the
kernel needs a card).
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from pathlib import Path

from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.simplex import driver, kernels, solve_general_form
from relp_tpu_torch.testing import REAL_SIZE, REAL_SIZE_OBJECTIVE_SHA256, generated_lp


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--platform", default=None)
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--max-iterations", type=int, default=15_000)
    parser.add_argument("variants", nargs="*", default=["kernel"])
    args = parser.parse_args(argv)
    if args.platform != "cpu":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0], flush=True)
    scans = {"kernel": kernels.fused_price_scan}
    from relp_tpu_torch.ops import price_scan

    scans["plain"] = price_scan.fused_price_scan_reference
    if args.parent is not None:
        from relp_tpu_torch.tools.scan_timing import _parent_module

        scans["parent"] = _parent_module(args.parent).fused_price_scan
    rungs = []
    once = driver._solve_relaxation_once

    def recorded(provider, cfg, *rest, **kwargs):
        t0 = time.perf_counter()
        result = once(provider, cfg, *rest, **kwargs)
        rungs.append(f"{cfg.dtype}:{result.status.value}:{result.stats.certified}:"
                     f"{result.stats.iterations}:{result.stats.phase1_iterations}:"
                     f"{time.perf_counter() - t0:.1f}s")
        return result

    driver._solve_relaxation_once = recorded
    try:
        for name in args.variants:
            kernels.fused_price_scan = scans[name]
            rungs.clear()
            t0 = time.perf_counter()
            result, solution = solve_general_form(
                generated_lp(**REAL_SIZE),
                SolverConfig(scan_dtype="bfloat16", platform=args.platform,
                             max_iterations=args.max_iterations))
            digest = hashlib.sha256(str(solution.objective_value).encode()).hexdigest()
            print(f"[bf16_rungs] variant={name} platform={args.platform or 'cuda'} "
                  f"max_iterations={args.max_iterations} rungs={','.join(rungs)} "
                  f"status={result.status.value} certified={result.stats.certified} "
                  f"pivots={result.stats.iterations} "
                  f"digest_ok={digest == REAL_SIZE_OBJECTIVE_SHA256} "
                  f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    finally:
        driver._solve_relaxation_once = once
        kernels.fused_price_scan = scans["kernel"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
