"""PDHG on the generated 2048 x 8192 LP of ``relp_tpu_torch.testing``
(``pdhg_lp(**PDHG_SIZE)``), with the KKT residuals of the returned point
recomputed in f64 numpy on the host.

``chip_smoke.py`` makes the f32 call on the card; this tool makes the same
call (tol 1e-6, ``--max-iters`` 20,000 by default) in the dtype and on the
device asked for, and prints one JSON line: iterations, restarts,
converged, and the returned point's host residuals (primal, dual, gap) in
the scaled system PDHG iterates on.  The f64 CPU run pins the progress
bound of chip_smoke's check (``testing.PDHG_F64_CPU``):

    python -m relp_tpu_torch.tools.pdhg_check --platform cpu --dtype float64
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from relp_tpu_torch.firstorder import pdhg
from relp_tpu_torch.testing import PDHG_SIZE, pdhg_lp

MAX_ITERS = 20_000


def kkt64(A, b, c, u, x, y):
    """``pdhg._kkt`` in f64 numpy, an evaluation independent of torch:
    (primal, dual, gap) residuals of (x, y) for min c.x, A x = b, 0 <= x <= u."""
    A, b, c, u, x, y = (np.asarray(v, dtype=np.float64) for v in (A, b, c, u, x, y))
    pr = np.linalg.norm(A @ x - b) / (1.0 + np.linalg.norm(b))
    lam = c - y @ A
    finite = np.isfinite(u)
    du = np.linalg.norm(np.where(finite, 0.0, np.maximum(-lam, 0.0))) / (
        1.0 + np.linalg.norm(c))
    pobj = float(c @ x)
    dobj = float(b @ y + np.sum(np.where(finite, np.where(u > 0, u, 0.0), 0.0)
                                * np.minimum(lam, 0.0)))
    return pr, du, abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))


def run(device, dtype=np.float32, max_iters: int = MAX_ITERS):
    """(x, y, stats, scaled, host): ``pdhg_solve``'s answer, the scaled
    system (As, bs, cs, us, xs, ys) it iterated on, and kkt64 of it."""
    A, b, c, u = pdhg_lp(**PDHG_SIZE)
    x, y, stats = pdhg.pdhg_solve(A, b, c, u, tol=1e-6, max_iters=max_iters,
                                  dtype=dtype, device=device)
    As, bs, cs, us, d_row, d_col = pdhg.scale_problem(A, b, c, u, dtype)
    scaled = (As, bs, cs, us, x / d_col, y / d_row)
    return x, y, stats, scaled, kkt64(*scaled)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    parser.add_argument("--max-iters", type=int, default=MAX_ITERS)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    _x, _y, stats, _scaled, host = run(args.platform, np.dtype(args.dtype).type,
                                       args.max_iters)
    print(json.dumps(dict(
        platform=args.platform, dtype=args.dtype, max_iters=args.max_iters,
        iterations=stats.iterations, restarts=stats.restarts,
        converged=stats.converged, primal=host[0], dual=host[1], gap=host[2],
        wall_s=time.perf_counter() - t0,
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
