"""Sparse host backend — the CPU fallback for very large, very sparse LPs.

The device path lowers the provider to a dense padded tableau: ideal for the
MXU, but on the CPU backend an 80BAU3B-class instance (m ~ 5000, n ~ 14000,
density 0.04%) means a ~800 MB dense tableau, O(m^3) dense refactorizations
and an 800 MB sweep per pricing scan — the one reference-suite problem that
could not finish on CPU.  This module is a sparse revised simplex on the
host, closest in spirit to the reference's own execution model
(LUDecomposition + eta files, lower_upper/mod.rs): scipy ``splu`` basis
factors + product-form eta updates, O(nnz) pricing matvecs, and the same
pricing rules / Harris ratio test / Bland fallback / exact certification as
the device engine.

Per pivot: one FTRAN, two BTRANs (steepest-edge work vectors), three
O(nnz) sparse matvecs and an O(n) gamma update — ~2-5 ms at 80BAU3B scale
vs ~1 s on the dense CPU path.

Selected via ``SolverConfig.backend = "host_sparse"``, or automatically
("auto", the default) when running on the CPU backend and the dense
lowering would be both huge and nearly empty.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.providers.base import MatrixProvider, PartialInitialBasis
from relp_tpu_torch.simplex.result import OptimizationResult, SolveStats, SolveStatus

# Pricing codes shared with the device kernels.
from relp_tpu_torch.simplex.kernels import PRICE_BLAND, PRICE_DANTZIG, PRICE_STEEPEST


class _Factors:
    """Basis factors: splu of B0 + product-form eta files.

    B = B0 E_1 ... E_k with E_i the identity with column r_i replaced by
    w_i = B_{i-1}^-1 a_q (reference: EtaFile, eta_file.rs; applied here on
    the solve side instead of to U).
    """

    def __init__(self, A_csc, basis: np.ndarray):
        from scipy.sparse.linalg import splu

        B = A_csc[:, basis].tocsc()
        self.splu = splu(B)
        self.etas: List[Tuple[int, np.ndarray]] = []

    def ftran(self, v: np.ndarray) -> np.ndarray:
        """B^-1 v — base solve then eta inverses in insertion order."""
        x = self.splu.solve(v)
        for r, w in self.etas:
            t = x[r] / w[r]
            x = x - t * w
            x[r] = t
        return x

    def btran(self, v: np.ndarray) -> np.ndarray:
        """B^-T v — transposed etas in reverse order, then the base solve.

        E^-1 = I - (w - e_r) e_r^T / w_r, so E^-T y only changes y_r:
        y_r' = y_r - ((w.y - y_r) / w_r).
        """
        y = np.array(v, dtype=np.float64, copy=True)
        for r, w in reversed(self.etas):
            y[r] = y[r] - (w @ y - y[r]) / w[r]
        return self.splu.solve(y, trans="T")

    def push(self, r: int, w: np.ndarray) -> None:
        self.etas.append((int(r), w.copy()))


def _equilibrate_sparse(M, rounds: int = 3):
    """Pow-2 Ruiz equilibration of a sparse structural block.

    Returns (scaled, row_scale, col_scale) with scaled = Dr M Dc.  Powers of
    two keep every float exact, so the equilibration is invisible to the
    exact pipeline (same rationale as the device lowering's equilibrate,
    relp_tpu/data/scale/equilibrate.py); b' = Dr b preserves b >= 0 and
    x_j = col_scale[j] * x'_j undoes it at extraction."""
    from scipy import sparse

    m, n = M.shape
    dr = np.ones(m)
    dc = np.ones(n)
    absM = abs(M)
    for _ in range(rounds):
        rmax = np.asarray(absM.max(axis=1).todense()).ravel()
        sr = np.where(rmax > 0, 2.0 ** -np.round(np.log2(rmax)), 1.0)
        absM = sparse.diags(sr) @ absM
        dr *= sr
        cmax = np.asarray(absM.max(axis=0).todense()).ravel()
        sc = np.where(cmax > 0, 2.0 ** -np.round(np.log2(cmax)), 1.0)
        absM = absM @ sparse.diags(sc)
        dc *= sc
    return sparse.diags(dr) @ M @ sparse.diags(dc), dr, dc


def _build_arrays(provider: MatrixProvider):
    """CSC standard-form matrix [real columns | artificial identity],
    pow-2 equilibrated (PILOT87's 1e10 coefficient range made raw splu
    refactorizations go exactly singular mid-phase)."""
    from scipy import sparse

    m = provider.nr_rows()
    n = provider.nr_columns()
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    for j in range(n):
        for i, v in provider.column(j).iter_entries():
            rows.append(i)
            cols.append(j)
            vals.append(float(v))
    struct = sparse.csc_matrix(
        (vals, (rows, cols)), shape=(m, n), dtype=np.float64
    )
    struct, dr, dc = _equilibrate_sparse(struct)
    art = sparse.identity(m, format="csc", dtype=np.float64)
    A = sparse.hstack([struct, art], format="csc")
    b = dr * np.array(
        [float(v) for v in provider.right_hand_side()], dtype=np.float64
    )
    c2 = np.zeros(n + m, dtype=np.float64)
    for j in range(n):
        cost = provider.cost_value(j)
        if cost:
            c2[j] = float(cost) * dc[j]
    c1 = np.zeros(n + m, dtype=np.float64)
    c1[n:] = 1.0
    candidate = np.zeros(n + m, dtype=bool)
    candidate[:n] = True
    basis = np.arange(n, n + m, dtype=np.int64)
    if isinstance(provider, PartialInitialBasis):
        for row, col in provider.pivot_element_indices():
            basis[row] = col
    # 1/dc per column (artificials unscaled): pricing must test reduced
    # costs in ORIGINAL units — a column scaled down by 2^-20 would hide a
    # true -1e-3 candidate below any absolute scaled threshold (FIT2P's
    # phase 1 falsely terminated 'optimal' at positive objective).
    inv_dc = np.concatenate([1.0 / dc, np.ones(m)])
    return A, b, c1, c2, candidate, basis, n, m, dc, inv_dc


def _repair_basis(A, basis, n_real: int, m: int):
    """Rank-revealing repair of a numerically singular basis: pivoted dense
    QR finds the dependent basis positions; each is replaced by the
    artificial of the row where its left-null direction is largest (rows
    and artificials kept distinct).  Returns the repaired basis, or None
    when QR says the basis is numerically full-rank after all.

    Only valid during PHASE 1, where artificial columns are legal basis
    members (cost 1 drives them back out).  Dense O(m^3) — only runs on the
    rare splu "exactly singular" event (netlib PILOT87)."""
    import scipy.linalg as sla

    B = A[:, basis].toarray()
    q, r, piv = sla.qr(B, pivoting=True)
    diag = np.abs(np.diag(r))
    tol = max(float(diag.max()) * m * np.finfo(float).eps, 1e-10) if diag.size else 0.0
    rank = int((diag > tol).sum())
    if rank >= m:
        return None
    taken = set(int(j) for j in basis)
    used_rows = set()
    new_basis = basis.copy()
    for idx, p in enumerate(piv[rank:]):
        qcol = q[:, rank + idx]  # left-null direction of the kept columns
        for i in np.argsort(-np.abs(qcol)):
            i = int(i)
            art = n_real + i
            if i not in used_rows and art not in taken:
                used_rows.add(i)
                taken.add(art)
                new_basis[p] = art
                break
    return new_basis


def _refactor(A, b, c, basis):
    factors = _Factors(A, basis)
    xB = factors.ftran(b)
    cB = c[basis]
    pi = factors.btran(cB)
    obj = float(cB @ xB)
    return factors, xB, pi, obj


def _harris_leaving(
    xB, w, basis, bland: bool, pivot_tol: float
) -> Tuple[Optional[int], bool]:
    """Harris two-pass ratio test / Bland min-ratio — host mirror of
    kernels._select_leaving (delta relative to the basic value scale)."""
    pos = w > pivot_tol
    if not pos.any():
        return None, False
    xB_eff = np.maximum(xB, 0.0)
    ratio = np.where(pos, xB_eff / np.where(pos, w, 1.0), np.inf)
    if bland:
        tmin = ratio.min()
        near = pos & (ratio <= tmin + 1e-12 * (1.0 + abs(tmin)))
        cand = np.where(near)[0]
        return int(cand[np.argmin(basis[cand])]), True
    delta = 1e-7 * (1.0 + xB_eff)
    relaxed = np.where(pos, (xB_eff + delta) / np.where(pos, w, 1.0), np.inf)
    theta = relaxed.min()
    ok = pos & (ratio <= theta)
    cand = np.where(ok)[0]
    return int(cand[np.argmax(w[cand])]), True


def solve_relaxation_host_sparse(
    provider: MatrixProvider,
    config: Optional[SolverConfig] = None,
    *,
    warm_start_basis: Optional[List[int]] = None,
) -> OptimizationResult:
    """Two-phase sparse revised simplex on the host (f64).

    Same contract as :func:`relp_tpu_torch.simplex.driver.solve_relaxation`;
    supports phase 1 with partially-artificial starts, zero-level artificial
    drive-out with redundant-row removal (rank repair), Bland anti-cycling,
    and the exact certification / cleanup pass.
    """
    from relp_tpu_torch.config import default_config

    cfg = config or default_config()
    stats = SolveStats()
    t_start = time.time()

    (
        A, b, c1, c2, candidate, basis, n_real, m, col_scale, inv_dc
    ) = _build_arrays(provider)
    removed_rows: List[int] = []
    pricing = PRICE_STEEPEST if cfg.pricing == "steepest" else PRICE_DANTZIG

    # f64 host tolerances (the f32 clamp in SolverConfig does not apply here).
    req = getattr(cfg, "requested_tolerances", {})
    opt_tol = min(req.get("opt_tol", cfg.opt_tol), 1e-9)
    pivot_tol = min(req.get("pivot_tol", cfg.pivot_tol), 1e-9)
    phase1_tol = min(req.get("phase1_tol", cfg.phase1_tol), 1e-8)

    state = {}
    warm_started = False
    if warm_start_basis is not None and len(warm_start_basis) == m:
        warm = np.asarray(warm_start_basis, dtype=np.int64)
        try:
            _f, xB_w, _pi, _obj = _refactor(A, b, c2, warm)
            if np.isfinite(xB_w).all() and float(xB_w.min()) > -1e-7:
                basis = warm
                warm_started = True
        except Exception:  # noqa: BLE001 — singular warm basis: cold start
            pass

    import logging as _logging

    _log = _logging.getLogger("relp_tpu_torch.host_sparse")

    def run_phase(c, stop_at_zero: bool) -> str:
        """Primal loop on the current basis; returns a status string."""
        nonlocal basis
        factors, xB, pi, obj = _refactor(A, b, c, basis)
        in_basis = np.zeros(A.shape[1], dtype=bool)
        in_basis[basis] = True
        gamma = np.ones(A.shape[1])
        if pricing == PRICE_STEEPEST:
            # Exact init is an O(n) batch of FTRANs — too expensive on host;
            # gamma=1 are the Goldfarb "reference framework" weights, exactly
            # how the device engine starts (pivot_rule.rs:299-305 allows any
            # positive init; updates keep them consistent).
            pass
        bland = False
        stall = 0
        last_obj = None
        iters_at_entry = stats.iterations
        refactor_failures = 0
        # Degenerate-plateau escape: after repeated zero-progress refactor
        # windows even under Bland, enter a COST-PERTURBATION episode
        # (CPLEX-style; the host analog of the device EXPAND jitter):
        # tiny deterministic per-column cost noise breaks the pricing ties
        # that pin the walk to one plateau.  Feasibility is untouched, and
        # the episode is removed before any "optimal" verdict: true costs
        # are restored, the state refactorized, and pricing re-entered
        # (QAP12/QAP15: 200k flat Bland pivots at phase-1 obj 24.0).
        c_work = c
        perturbed = False
        perturb_episodes = 0
        # Second escape hatch for *primal* degeneracy (QAP12/QAP15: b is
        # mostly zeros, so most basic values are 0 and every ratio test
        # returns a zero step — cost noise cannot fix that).  Perturb the
        # rhs IN THE CURRENT BASIS FRAME: b_work = b + B0 @ eps makes the
        # current basic values strictly positive (xB += eps) and — crucially
        # — the perturbation is FIXED for the whole episode, so refactoring
        # against b_work preserves the perturbed problem and Bland/steepest
        # walks on it make real progress.  (A first attempt re-applied a raw
        # xB shift after every refactorization; that restarts the perturbed
        # problem each window, voids Bland's termination guarantee, and
        # measurably cycles forever on QAP12.)  The perturbation is removed
        # (refactor against the true b) before any verdict.
        b_work = b
        xb_perturbed = False
        xb_episodes = 0

        def _xb_jitter_vec(episode: int) -> np.ndarray:
            idx = np.arange(m)
            return (
                1e-6
                * episode
                * (1.0 + ((idx * 37 + episode * 11) % 19) / 19.0)
            )

        while True:
            if stop_at_zero and obj <= 1e-9:
                state.update(f=factors, xB=xB, pi=pi, obj=obj, basis=basis)
                return "feasible"
            d = c_work - A.T @ pi  # O(nnz) pricing scan (scaled units)
            # Eligibility/selection in ORIGINAL units (see _build_arrays);
            # the pi/objective updates keep the scaled d_q below.
            d_true = d * inv_dc
            eligible = candidate & (~in_basis) & (d_true < -opt_tol)
            if not eligible.any():
                if perturbed or xb_perturbed:
                    c_work = c
                    b_work = b
                    perturbed = False
                    xb_perturbed = False
                    bland = False
                    stall = 0
                    last_obj = None
                    factors, xB, pi, obj = _refactor(A, b, c_work, basis)
                    stats.refactorizations += 1
                    continue
                state.update(f=factors, xB=xB, pi=pi, obj=obj, basis=basis)
                return "optimal"
            if bland or pricing == PRICE_BLAND:
                q = int(np.argmax(eligible))
            elif pricing == PRICE_STEEPEST:
                score = np.where(eligible, d_true * d_true / gamma, -np.inf)
                q = int(np.argmax(score))
            else:
                q = int(np.argmin(np.where(eligible, d_true, np.inf)))

            a_q = A[:, q].toarray().ravel()
            w = factors.ftran(a_q)
            r, any_pos = _harris_leaving(xB, w, basis, bland, pivot_tol)
            if not any_pos:
                state.update(f=factors, xB=xB, pi=pi, obj=obj, basis=basis)
                return "unbounded"

            # --- pivot ---
            w_r = w[r]
            t = max(xB[r], 0.0) / w_r
            if pricing == PRICE_STEEPEST:
                v = factors.btran(w)  # Goldfarb work vector, OLD basis
            leaving = int(basis[r])
            factors.push(r, w)
            basis = basis.copy()
            basis[r] = q
            in_basis[leaving] = False
            in_basis[q] = True
            xB = xB - t * w
            xB[r] = t
            d_q = float(d[q])
            e_r = np.zeros(m)
            e_r[r] = 1.0
            rho = factors.btran(e_r)  # new pivot row of B^-1
            pi = pi + d_q * rho
            obj = float(c_work[basis] @ xB)
            stats.iterations += 1

            if pricing == PRICE_STEEPEST:
                gamma_q = 1.0 + float(w @ w)
                abar = A.T @ rho  # pivot row of the updated tableau
                inner = A.T @ v
                gamma = np.maximum(
                    gamma - 2.0 * abar * inner + abar * abar * gamma_q,
                    1.0 + abar * abar,
                )
                gamma[leaving] = max(gamma_q / (w_r * w_r), 1.0)
                gamma[q] = 1.0

            # --- cadence: refactorize, stall/Bland control ---
            if len(factors.etas) >= cfg.refactor_period * (
                1 + refactor_failures
            ):
                try:
                    factors, xB, pi, obj = _refactor(A, b_work, c_work, basis)
                except RuntimeError:
                    # superlu "Factor is exactly singular": cancellation
                    # made the basis numerically rank-deficient (PILOT87
                    # hits this mid-phase-1).  In phase 1, repair by
                    # swapping the QR-identified dependent columns for
                    # their rows' artificials (cost 1 drives them back
                    # out); otherwise keep pivoting on the still-valid
                    # product-form factors with a stretched cadence and
                    # Bland's rule.  Repeated failures give up honestly —
                    # the exact certifier never sees an unverified verdict
                    # either way.
                    refactor_failures += 1
                    bland = True
                    repaired = None
                    if stop_at_zero:
                        repaired = _repair_basis(
                            A, basis, A.shape[1] - m, m
                        )
                    if repaired is not None:
                        basis = repaired
                        in_basis[:] = False
                        in_basis[basis] = True
                        gamma = np.ones(A.shape[1])
                        try:
                            factors, xB, pi, obj = _refactor(
                                A, b_work, c_work, basis
                            )
                            stats.refactorizations += 1
                            refactor_failures = 0
                        except RuntimeError:
                            pass  # fall through to the failure counter
                    if refactor_failures > 3:
                        state.update(
                            f=factors, xB=xB, pi=pi, obj=obj, basis=basis
                        )
                        return "numerical_error"
                    continue
                refactor_failures = 0
                stats.refactorizations += 1
                if stats.refactorizations % 20 == 0:
                    _log.info(
                        "phase%s iter=%d obj=%.6e bland=%s",
                        "1" if stop_at_zero else "2",
                        stats.iterations, obj, bland,
                    )
                xB = np.where(xB > -1e-9, np.maximum(xB, 0.0), xB)
                progressed = last_obj is None or (last_obj - obj) > 1e-12 * (
                    1.0 + abs(obj)
                )
                last_obj = obj
                if progressed:
                    stall = 0
                    bland = False
                else:
                    stall += 1
                    if stall >= 2:
                        bland = True
                    if stall >= 4 and perturbed and not xb_perturbed:
                        # Cost noise did not move the walk: the block is
                        # primal degeneracy.  Perturb the rhs in the basis
                        # frame (fixed for the whole episode; see above).
                        xb_episodes += 1
                        eps = _xb_jitter_vec(xb_episodes)
                        b_work = b_work + A[:, basis] @ eps
                        xB = xB + eps
                        obj = float(c_work[basis] @ xB)
                        last_obj = None
                        xb_perturbed = True
                        bland = False
                        stall = 0
                        _log.info(
                            "phase%s iter=%d: basis-frame rhs perturbation "
                            "episode %d",
                            "1" if stop_at_zero else "2",
                            stats.iterations, xb_episodes,
                        )
                    elif stall >= 4 and not perturbed:
                        # Fresh seed + growing magnitude per episode: a
                        # plateau that survives one perturbation must see
                        # different tie-breaks next time, not the same ones.
                        perturb_episodes += 1
                        rng = np.random.default_rng(
                            9173
                            + 7919 * perturb_episodes
                            + stats.iterations
                        )
                        c_work = c + (
                            1e-7
                            * perturb_episodes
                            * (1.0 + np.abs(c))
                            * rng.uniform(0.5, 1.5, c.shape)
                        )
                        perturbed = True
                        bland = False
                        stall = 0
                        factors, xB, pi, obj = _refactor(
                            A, b, c_work, basis
                        )
                        stats.refactorizations += 1
                        _log.info(
                            "phase%s iter=%d: cost-perturbation episode",
                            "1" if stop_at_zero else "2",
                            stats.iterations,
                        )
            if stats.iterations - iters_at_entry >= cfg.max_iterations:
                state.update(f=factors, xB=xB, pi=pi, obj=obj, basis=basis)
                return "iteration_limit"

    def finish(status: SolveStatus) -> OptimizationResult:
        stats.wall_time_s = time.time() - t_start
        stats.removed_rows = removed_rows
        return OptimizationResult(status=status, stats=stats)

    needs_phase1 = not warm_started and bool((basis >= n_real).any())
    drive_out = False
    if needs_phase1 and cfg.phase1 == "bigm":
        # Single composite walk on c2 + M*c1: real cost gradients break the
        # pricing ties that pin pure-phase-1 walks to degenerate plateaus
        # (QAP12/QAP15).  Any failure falls back to the classic two-phase
        # path; the final basis is exactly certified either way.
        cand_c2 = np.abs(c2[candidate]) if candidate.any() else None
        m_big = 1e4 * (1.0 + (float(cand_c2.max()) if cand_c2 is not None and cand_c2.size else 1.0))
        verdict = run_phase(c2 + m_big * c1, stop_at_zero=False)
        stats.phase1_iterations = stats.iterations
        if verdict == "numerical_error":
            return finish(SolveStatus.NUMERICAL_ERROR)
        if verdict == "iteration_limit":
            return finish(SolveStatus.ITERATION_LIMIT)
        if verdict == "optimal":
            bb = state["basis"]
            art_mask = bb >= n_real
            art_level = (
                float(np.abs(state["xB"][art_mask]).max())
                if art_mask.any()
                else 0.0
            )
            if art_level <= 1e-7:
                needs_phase1 = False
                basis = bb
                drive_out = True
            # else: composite optimum keeps artificials positive — possibly
            # infeasible; the classic phase 1 below decides (with exact
            # Farkas certification).
        # "unbounded" composite: M may be too small; classic path decides.
    if needs_phase1:
        verdict = run_phase(c1, stop_at_zero=True)
        stats.phase1_iterations = stats.iterations
        if verdict == "iteration_limit":
            return finish(SolveStatus.ITERATION_LIMIT)
        if verdict == "numerical_error":
            return finish(SolveStatus.NUMERICAL_ERROR)
        feasible = state["obj"] <= phase1_tol
        if not feasible:
            if cfg.certify:
                from relp_tpu_torch.exact.certify import certify_infeasible

                stats.certified = certify_infeasible(
                    provider, [int(j) for j in state["basis"]], n_real
                )
                if not stats.certified:
                    # The exact Farkas check REFUTED the float phase-1
                    # verdict (the basis is not exactly phase-1-optimal):
                    # an uncertified INFEASIBLE must never ship.
                    return finish(SolveStatus.NUMERICAL_ERROR)
            return finish(SolveStatus.INFEASIBLE)

        drive_out = True

    if drive_out:
        # Drive zero-level artificials out; rows where no real column has a
        # nonzero tableau entry are redundant (rank repair; reference:
        # remove_artificial_basis_variables, phase_one.rs:232-278).
        basis = state["basis"]
        factors, xB, pi, obj = _refactor(A, b, c1, basis)
        art_rows = [i for i in range(m) if basis[i] >= n_real]
        redundant: List[int] = []
        in_basis = np.zeros(A.shape[1], dtype=bool)
        in_basis[basis] = True
        for r in art_rows:
            e_r = np.zeros(m)
            e_r[r] = 1.0
            rho = factors.btran(e_r)
            row = A.T @ rho
            row[~candidate] = 0.0
            row[in_basis] = 0.0
            cand = np.where(np.abs(row) > 1e-7)[0]
            if cand.size:
                q = int(cand[np.argmax(np.abs(row[cand]))])
                w = factors.ftran(A[:, q].toarray().ravel())
                t = xB[r] / w[r]
                factors.push(r, w)
                leaving = int(basis[r])
                basis[r] = q
                in_basis[leaving] = False
                in_basis[q] = True
                xB = xB - t * w
                xB[r] = t
                if len(factors.etas) >= cfg.refactor_period:
                    factors, xB, pi, obj = _refactor(A, b, c1, basis)
            else:
                redundant.append(r)
        if redundant:
            removed_rows = redundant
            stats.removed_rows = redundant
        state["basis"] = basis

    if removed_rows:
        keep = np.array(
            [i for i in range(m) if i not in set(removed_rows)], dtype=np.int64
        )
        A = A.tocsr()[keep].tocsc()
        b = b[keep]
        m2 = len(keep)
        # Artificial block: keep columns n_real + keep rows, reindexed.
        from scipy import sparse

        art = sparse.identity(m2, format="csc", dtype=np.float64)
        A = sparse.hstack([A[:, :n_real], art], format="csc")
        c1 = np.concatenate([c1[:n_real], np.ones(m2)])
        c2 = np.concatenate([c2[:n_real], np.zeros(m2)])
        inv_dc = np.concatenate([inv_dc[:n_real], np.ones(m2)])
        candidate = np.zeros(n_real + m2, dtype=bool)
        candidate[:n_real] = True
        old_basis = state["basis"]
        new_basis = []
        for new_i, old_i in enumerate(keep):
            j = int(old_basis[old_i])
            new_basis.append(j if j < n_real else n_real + new_i)
        basis = np.array(new_basis, dtype=np.int64)
        m = m2

    verdict = run_phase(c2, stop_at_zero=False)
    if verdict == "numerical_error":
        return finish(SolveStatus.NUMERICAL_ERROR)
    if verdict == "iteration_limit":
        return finish(SolveStatus.ITERATION_LIMIT)
    basis = state["basis"]
    xB = state["xB"]

    if verdict == "unbounded":
        if cfg.certify:
            from relp_tpu_torch.exact.certify import certify_unbounded

            filtered = _filtered_provider(provider, removed_rows)
            stats.certified = certify_unbounded(
                filtered, [int(j) for j in basis], art_offset=n_real
            )
        return finish(SolveStatus.UNBOUNDED)

    # --- extraction + certification (identical contract to the driver) ---
    entries = [
        (int(j), xB[i] * col_scale[int(j)])
        for i, j in enumerate(basis)
        if j < n_real and abs(xB[i]) > cfg.zero_tol
    ]
    result = OptimizationResult(
        status=SolveStatus.FINITE_OPTIMUM,
        objective=float(state["obj"]),
        basis=[int(j) for j in basis],
        stats=stats,
    )
    result.float_entries = entries  # type: ignore[attr-defined]
    filtered = _filtered_provider(provider, removed_rows)
    result.provider = filtered  # type: ignore[attr-defined]
    result.removed_rows = removed_rows  # type: ignore[attr-defined]
    if cfg.certify:
        from relp_tpu_torch.exact.certify import certify_and_repair

        _tc = time.time()
        certify_and_repair(
            result, filtered, [int(j) for j in basis], cfg, art_offset=n_real
        )
        stats.certify_time_s += time.time() - _tc
    else:
        from fractions import Fraction

        result.bfs = SparseVector(
            [(j, Fraction(float(v))) for j, v in entries],
            provider.nr_columns(),
        )
    stats.wall_time_s = time.time() - t_start
    return result


def _filtered_provider(provider: MatrixProvider, removed_rows: List[int]):
    if not removed_rows:
        return provider
    from relp_tpu_torch.providers.filter import RemoveRows

    return RemoveRows(provider, removed_rows)


def should_use_host_sparse(provider: MatrixProvider, cfg: SolverConfig, device) -> bool:
    """Auto-routing heuristic: host-sparse wins only when the solve runs on
    the CPU (``device``, a torch device) and the dense lowering would be both
    huge (> ~2.5e7 padded cells, i.e. hundreds of MB and O(m^3) dense
    refactorizations) and nearly empty (< 2% dense).  On CUDA the dense
    device path stays."""
    if device.type != "cpu":
        return False
    m = provider.nr_rows()
    n = provider.nr_columns()
    from relp_tpu_torch.linalg.device import pad_to_multiple

    M = pad_to_multiple(max(m, 1), cfg.pad_to)
    N = pad_to_multiple(n + M, cfg.pad_to)
    if M * N < 2.5e7:
        return False
    try:
        nnz = sum(len(provider.column(j).entries()) for j in range(n))
    except Exception:  # noqa: BLE001 — unknown providers: stay on device
        return False
    return nnz / (m * n) < 0.02
