"""Exact branch & bound over batched LP relaxations.

Beyond reference scope (the reference's README roadmap lists branch & bound
as unimplemented; its miplib tests stop at root relaxations,
the original solver's tests/miplib/mod.rs:48-72), and TPU-native by construction:

* **Branching (almost) never changes the constraint matrix.**  Upper-bound
  branches tighten the variable's existing bound row — a pure rhs tweak.
  Lower-bound branches need a ``x'_k >= l`` row; those rows are added
  *lazily*, only for the handful of variables the tree actually branches
  below on (as :class:`~relp_tpu_torch.mip.cuts.CutProvider` rows, exactly like
  root cuts), instead of one row per integer variable upfront — on
  instances like miplib 50v-10 (1,647 integer variables, ~30 branch
  variables) the eager design doubled every node LP's row count.
* **Within a wave the frontier is a perturbed-rhs scenario family** —
  every node shares base matrix + root cuts + the current branch rows and
  differs only in rhs, exactly what the batched scenario driver solves in
  lockstep on one chip (``solve_batch(shared_structure=True)``),
  dual-simplex warm-restarted from the root optimal basis extended with
  the branch rows' surplus columns: the extension is block-triangular, so
  the duals (hence dual feasibility) are exactly preserved and nodes skip
  both phases.  The matrix changes shape only when a *new* variable is
  branched below for the first time (``pad_to`` buckets absorb the
  recompiles on TPU).
* **Everything is exact.**  Node relaxations are certified rational
  optima (Dixon); bounds, incumbents, pruning comparisons, and integrality
  checks are Fraction arithmetic; INFEASIBLE nodes carry exact Farkas
  certificates through the single-LP fallback.

* **MIP-safe presolve** runs first (``GeneralForm.presolve(mip_safe=True)``):
  the LP presolve fixpoint restricted to integer-hull-preserving rules —
  every derived bound on an integer variable rounds inward (ceil/floor,
  strictly stronger than LP propagation; Achterberg 2007 alg. 7.1's integer
  case), the slack rule never eliminates an integer column (its
  reconstructed value need not be integral), and an integer variable fixed
  at a fractional value is INFEASIBLE.

v1 scope (documented limits, checked with clear errors):

* every integer variable must have finite lower AND upper bounds (so its
  bound row exists in the standard form at every node);
* free integer variables (split as x+ - x-) are not supported.
"""

from __future__ import annotations

import copy
import dataclasses
import heapq
from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

from relp_tpu_torch.config import SolverConfig, default_config
from relp_tpu_torch.data.elements import VariableType
from relp_tpu_torch.data.general_form import Active, GeneralForm
from relp_tpu_torch.data.solution import Solution
from relp_tpu_torch.simplex.result import OptimizationResult, SolveStatus
from relp_tpu_torch.utils.logging import traced


@dataclass
class MipResult:
    """Outcome of an exact branch & bound run.

    ``objective``/``solution`` are in the standardized MINIMIZE sense (the
    same convention as ``solve_general_form``); ``certified`` means every
    node bound and the incumbent were exactly certified.
    """

    status: SolveStatus
    objective: Optional[Fraction] = None
    solution: Optional[Solution] = None
    nodes_solved: int = 0
    nodes_pruned: int = 0
    node_limit_hit: bool = False
    certified: bool = True
    root_objective: Optional[Fraction] = None
    #: distinct variables that received a lazy lower-bound branch row
    branch_vars_used: int = 0
    #: global dual (lower) bound at exit: min over open-node bounds and the
    #: incumbent.  With ``best_bound_exact`` it is a *rigorous* rational
    #: bound — early stops (gap/node/time limits) still return a proven
    #: optimality interval [best_bound, objective].
    best_bound: Optional[Fraction] = None
    best_bound_exact: bool = True
    #: exact relative gap (objective - best_bound) / max(1, |objective|)
    #: at exit; 0 when optimality was proven.
    gap: Optional[Fraction] = None
    time_limit_hit: bool = False
    #: the incumbent came from the root rounding dive (it may later be
    #: replaced by a better tree incumbent)
    dive_incumbent: bool = False
    #: LPs spent by the rounding dive heuristic
    dive_lps: int = 0
    #: the incumbent came from a RINS sub-MIP (relaxation-induced
    #: neighborhood search); still an exactly certified feasible point.
    rins_incumbent: bool = False
    #: RINS rounds that produced a strict improvement
    rins_improvements: int = 0
    #: the incumbent came from a local-branching sub-MIP (Fischetti & Lodi)
    lb_incumbent: bool = False
    #: local-branching rounds that produced a strict improvement
    lb_improvements: int = 0


@dataclass(order=True)
class _Node:
    """One open node: its parent's bound (the best-first heap priority) plus
    the integer-variable bounds in ACTIVE standardized space.

    ``bound_exact`` records whether ``bound`` is a certified rational — only
    exact bounds may prune (a float bound could prune the true optimum)."""

    bound: Fraction
    seq: int  # tie-break: FIFO among equal bounds
    lower: Tuple[Fraction, ...] = dataclasses.field(compare=False)
    upper: Tuple[Fraction, ...] = dataclasses.field(compare=False)
    bound_exact: bool = dataclasses.field(compare=False, default=True)
    # Pseudocost bookkeeping: which branching created this node (t-index
    # into actives, up = ceil side), the parent's fractional part at the
    # branch variable, and the parent's (float) bound.
    branch_t: Optional[int] = dataclasses.field(compare=False, default=None)
    branch_up: bool = dataclasses.field(compare=False, default=False)
    branch_frac: float = dataclasses.field(compare=False, default=0.0)
    parent_bound_f: float = dataclasses.field(compare=False, default=0.0)


def _integer_actives(gf: GeneralForm) -> List[int]:
    """Indices of active integer variables; reject unsupported shapes."""
    actives = [
        k
        for k, v in enumerate(gf.variables)
        if v.variable_type is VariableType.INTEGER
    ]
    for k in actives:
        orig = gf.from_active_to_original[k]
        entry = gf.original_variables[orig][1]
        if not isinstance(entry, Active):
            raise NotImplementedError(
                "free (split) integer variables are not supported; give "
                f"integer variable {gf.original_variables[orig][0]!r} "
                "finite bounds"
            )
        if gf.variables[k].upper_bound is None:
            raise NotImplementedError(
                "integer variables need a finite upper bound (its bound row "
                "must exist in the standard form); "
                f"{gf.original_variables[orig][0]!r} has none"
            )
    return actives


def _node_provider(gf, counts, actives, node: _Node):
    """MatrixData for one node: shared constraint matrix, node-specific
    integer-variable upper bounds (rhs-only; lower-bound branch rows are
    appended by the CutProvider wrapper in ``solve_mip``)."""
    b = list(gf.b)
    variables = list(gf.variables)
    for t, k in enumerate(actives):
        variables[k] = dataclasses.replace(variables[k], upper_bound=node.upper[t])
    from relp_tpu_torch.providers.matrix_data import MatrixData

    nr_eq, nr_range, nr_le, nr_ge = counts
    ranges = [
        ct.range for ct in gf.constraint_types[nr_eq : nr_eq + nr_range]
    ]
    return MatrixData(
        constraints=gf.constraints,
        b=b,
        ranges=ranges,
        nr_equality=nr_eq,
        nr_range=nr_range,
        nr_upper=nr_le,
        nr_lower=nr_ge,
        variables=variables,
    )


def _exact_values(
    result: OptimizationResult, provider, gf, actives
) -> Optional[List[Fraction]]:
    """Exact ORIGINAL-space values of the integer variables, or None when
    only a float bfs is available."""
    reduced = getattr(result, "exact_bfs", None)
    if reduced is None:
        reduced = result.bfs
    if reduced is None:
        return None
    active_vals = provider.reconstruct_solution(copy.deepcopy(reduced))
    out = []
    for k in actives:
        v = active_vals.get(k)
        var = gf.variables[k]
        orig = v - var.shift
        if var.flipped:
            orig = -orig
        out.append(orig)
    return out


def _branch_bounds(var, value: Fraction):
    """Map original-space branches x <= floor(v) / x >= ceil(v) to ACTIVE
    standardized-space (lower, upper) deltas.

    reshift_solution defines orig = flip(x' - shift), so
      not flipped: x' = orig + shift
      flipped:     x' = shift - orig
    Down child (orig <= floor): ub' = floor+shift  (or lb' = shift-floor).
    Up   child (orig >= ceil):  lb' = ceil+shift   (or ub' = shift-ceil).
    """
    import math

    f = Fraction(math.floor(value))
    c = f + 1
    if not var.flipped:
        down = ("ub", f + var.shift)
        up = ("lb", c + var.shift)
    else:
        down = ("lb", var.shift - f)
        up = ("ub", var.shift - c)
    return down, up


@traced("bb.search")
def solve_mip(
    general_form: GeneralForm,
    config: Optional[SolverConfig] = None,
    *,
    batch_width: int = 16,
    node_limit: int = 10_000,
    gomory_cuts: int = 8,
    cut_rounds: int = 4,
    cover_cuts: int = 8,
    branching: str = "pseudocost",
    strong_branching: int = 8,
    dive_rounds: int = 30,
    rins_rounds: int = 0,
    rins_nodes: int = 200,
    rins_time_s: float = 120.0,
    local_branching: int = 0,
    lb_rounds: int = 3,
    incumbent_hint: Optional[Solution] = None,
    rel_gap: object = 0,
    time_limit_s: Optional[float] = None,
    mesh=None,
) -> MipResult:
    """Exact branch & bound on a GeneralForm with integer variables.

    ``batch_width`` open nodes are popped best-bound-first per wave and
    solved in lockstep by the batched scenario driver (all nodes share the
    constraint matrix; only rhs entries differ), dual-warm-restarted from
    the root optimal basis.  With no integer variables this degenerates to
    one exact LP solve.

    ``gomory_cuts`` > 0 adds up to ``cut_rounds`` rounds of up to that many
    exact Gomory mixed-integer cuts at the root (relp_tpu_torch.mip.cuts) before
    branching — globally valid inequalities, so every node shares the
    augmented matrix.  Rounds stop when the root turns integral, the exact
    bound stalls, or no new cuts separate.

    ``cover_cuts`` > 0 adds one round of exact knapsack cover cuts on the
    post-GMI root point (``mip/cuts.knapsack_cover_cuts``): minimal covers
    of the standardized <= / >= rows over the binary columns, ``sum_C x_j
    <= |C| - 1``, appended as ``<=`` rows whose +1 slack needs no phase-1
    artificial.  Globally valid (branching only tightens upper bounds).

    ``branching``: "pseudocost" (default) scores candidates by the product
    of observed per-unit objective degradations from past branchings
    (uninitialized pseudocosts are 1, so the rule starts as most-fractional
    and sharpens as the tree supplies data); "most_fractional" keeps the
    pure fractional-part rule.

    ``strong_branching`` > 0 evaluates up to that many fractional root
    candidates by actually solving both children — all 2K child LPs are a
    perturbed-rhs scenario family over ONE matrix (candidate branch rows
    appended like cuts), so the whole evaluation is a single batched
    dispatch warm-started from the root basis.  Observed degradations seed
    the pseudocosts; a child with a *certified* exact Farkas infeasibility
    fixes the root to the opposite side (both sides infeasible proves the
    MIP infeasible before any branching).

    ``dive_rounds`` > 0 runs a rounding dive at the root when it did not
    land integral: every fractional integer variable is rounded toward the
    side its branch expresses as an UPPER-bound move (floor for plain
    variables, ceil for flipped ones) — a pure rhs restriction, so each
    dive step is ONE dual-warm LP re-solve of the same matrix.  An
    integer-feasible certified dive optimum becomes the initial incumbent,
    enabling pruning from the first wave (pure best-bound search can
    otherwise visit thousands of nodes on large MIPs without ever finding
    a feasible point).

    ``rins_rounds`` > 0 runs relaxation-induced neighborhood search after
    the dive (Danna, Rothberg & Le Pape 2005): every integer variable whose
    exact incumbent value AGREES with the root-LP value is fixed there, and
    the resulting sub-MIP — the same original problem with tightened bounds,
    so every feasible point is feasible for the full MIP — is solved by a
    recursive exact branch & bound under ``rins_nodes``/``rins_time_s``
    budgets.  A strictly better certified incumbent replaces the current
    one (and sharpens wave pruning); rounds repeat with the new agreements
    until no improvement.  Beyond reference scope.

    ``local_branching`` > 0 runs local-branching rounds (Fischetti & Lodi
    2003) after RINS: the ORIGINAL problem plus ONE Hamming-ball row
    ``sum_{x̂=0} x_j - sum_{x̂=1} x_j <= k - |x̂=1|`` over the binary
    variables around the incumbent x̂ is solved recursively (hint-seeded).
    Unlike RINS neighborhoods — which can only move variables that already
    DISAGREE somewhere — a radius-k ball can OPEN binaries that are 0 in
    both the LP and the incumbent, which is exactly where fix-the-
    agreements search proved the 50v-10 dive incumbent locally optimal.
    Improvements re-center the ball; a proven-optimal ball enlarges k.

    ``mesh`` (a ``jax.sharding.Mesh`` with "batch" and "col" axes) shards
    every batched stage — node waves, strong branching — over the batch
    axis and the tableau columns over the col axis; single-LP stages
    (root, cut re-solves, dive) shard columns.  Verdicts are unchanged:
    the mesh only moves where the chunks execute.

    ``rel_gap`` > 0 stops once the *exact* relative optimality gap
    ``(incumbent - best open bound) / max(1, |incumbent|)`` is proven at or
    below it; ``time_limit_s`` stops before the next wave once the wall
    clock is exceeded.  Early stops return ``certified=False`` (optimality
    not proven) but a rigorous interval: ``best_bound``/``gap`` are exact
    rationals whenever ``best_bound_exact``.
    """
    from relp_tpu_torch.parallel.batch_driver import solve_batch
    from relp_tpu_torch.simplex.driver import solve_relaxation

    import math

    if branching not in ("pseudocost", "most_fractional"):
        raise ValueError(f"unknown branching rule {branching!r}")

    import time as _time

    t_entry = _time.time()

    def _time_left() -> Optional[float]:
        if time_limit_s is None:
            return None
        return time_limit_s - (_time.time() - t_entry)

    cfg = config or default_config()
    cfg = dataclasses.replace(cfg, certify=True)
    gf = general_form
    # RINS rebuilds the ORIGINAL problem with tightened bounds; snapshot it
    # before presolve/standardize mutate gf in place.
    gf_snapshot = (
        copy.deepcopy(general_form)
        if rins_rounds > 0 or local_branching > 0
        else None
    )

    # MIP-safe bound strengthening: integer bounds round inward exactly.
    for v in gf.variables:
        if v.variable_type is VariableType.INTEGER:
            if v.lower_bound is not None:
                v.lower_bound = Fraction(math.ceil(v.lower_bound))
            if v.upper_bound is not None:
                v.upper_bound = Fraction(math.floor(v.upper_bound))
            if (
                v.lower_bound is not None
                and v.upper_bound is not None
                and v.upper_bound < v.lower_bound
            ):
                return MipResult(SolveStatus.INFEASIBLE)

    # MIP-safe presolve (beyond reference scope): the LP presolve fixpoint
    # restricted to integer-hull-preserving rules — integer bounds round
    # inward (strictly stronger than LP propagation), integer slacks are
    # never eliminated, fractional-fixed integers are INFEASIBLE.
    if cfg.presolve:
        from relp_tpu_torch.data.elements import LinearProgramError, LPStatus

        try:
            gf.presolve(mip_safe=True)
        except LinearProgramError as exc:
            if exc.status is LPStatus.FINITE_OPTIMUM:
                # Presolve solved the MIP outright; every removed integer
                # variable was pinned at an integral value (rounded bounds,
                # gated slack rule), so the LP verdict is the MIP verdict.
                # The payload objective is in the ORIGINAL sense (presolve
                # runs before standardization); MipResult reports the
                # standardized MINIMIZE sense.
                from relp_tpu_torch.data.elements import Objective

                sol = exc.payload
                obj = sol.objective_value
                if gf.objective is Objective.MAXIMIZE:
                    obj = -obj
                return MipResult(
                    SolveStatus.FINITE_OPTIMUM,
                    objective=obj,
                    solution=sol,
                    nodes_solved=0,
                    certified=True,
                    root_objective=obj,
                    best_bound=obj,
                    gap=Fraction(0),
                )
            if exc.status is LPStatus.INFEASIBLE:
                return MipResult(SolveStatus.INFEASIBLE)
            return MipResult(SolveStatus.UNBOUNDED)

    counts = tuple(gf.standardize())
    actives = _integer_actives(gf)

    # --- root relaxation ---
    root_lower = tuple(Fraction(0) for _ in actives)
    root_upper = tuple(gf.variables[k].upper_bound for k in actives)
    root_node = _Node(Fraction(0), 0, root_lower, root_upper)
    root_provider = _node_provider(gf, counts, actives, root_node)
    root = solve_relaxation(root_provider, cfg, mesh=mesh)
    if root.status is SolveStatus.INFEASIBLE:
        return MipResult(SolveStatus.INFEASIBLE, certified=root.stats.certified)
    if root.status is SolveStatus.UNBOUNDED:
        return MipResult(SolveStatus.UNBOUNDED, certified=root.stats.certified)
    if not root.is_optimal():
        return MipResult(root.status, certified=False)

    # Rank repair at the root removed exactly-dependent STRUCTURAL rows.
    # Branching only edits bound-row rhs and appends rows, so those rows
    # stay dependent-and-consistent at every node: apply the SAME filter to
    # every node provider.  (Without this, the filtered root basis has the
    # wrong row count for unfiltered node matrices and every warm start —
    # cut re-solves, strong branching, node waves — silently degrades to
    # cold phase 1.)  Only certified roots may install the filter, and only
    # when all removed rows are structural (bound-row rhs changes per node).
    removed_rows: List[int] = sorted(
        getattr(root.stats, "removed_rows", None) or []
    )
    if removed_rows and not (
        root.stats.certified
        and all(r < root_provider.nr_constraints() for r in removed_rows)
    ):
        removed_rows = []

    def _filtered(p):
        if not removed_rows:
            return p
        from relp_tpu_torch.providers.filter import RemoveRows

        return RemoveRows(p, removed_rows)

    # --- root GMI cut rounds (globally valid: shared by every node, so the
    # frontier stays a perturbed-rhs family of ONE flat matrix).  Later
    # rounds derive cuts on the cut-augmented tableau; coefficients landing
    # on earlier surplus columns are substituted out exactly
    # (flatten_cut_over_base), keeping a single flat CutProvider. ---
    cuts: list = []
    cut_rhs: list = []
    cut_senses: list = []
    base_md = root_provider  # the pre-cut node MatrixData
    base_n = base_md.nr_columns()
    if gomory_cuts > 0:
        from relp_tpu_torch.mip.cuts import (
            CutProvider,
            flatten_cut_over_base,
            gomory_mixed_cuts,
        )

        for _round in range(cut_rounds):
            left = _time_left()
            if left is not None and left <= 0:
                break
            root_vals = _exact_values(root, root_provider, gf, actives)
            if root_vals is None or all(
                v.denominator == 1 for v in root_vals
            ):
                break
            # root.basis indexes the provider the driver actually solved —
            # after rank repair that is a RemoveRows view with fewer rows.
            # RemoveRows keeps column indices, so cuts derived on it are
            # valid over the unfiltered node matrices.
            basis_provider = getattr(root, "provider", root_provider)
            new_cuts, new_rhs = gomory_mixed_cuts(
                basis_provider, root.basis, set(actives), max_cuts=gomory_cuts
            )
            flat = [
                flatten_cut_over_base(c, r, base_n, cuts, cut_rhs)
                for c, r in zip(new_cuts, new_rhs)
            ]
            trial_cuts = cuts + [c for c, _ in flat if c]
            trial_rhs = cut_rhs + [r for c, r in flat if c]
            trial_senses = cut_senses + [">="] * (
                len(trial_cuts) - len(cuts)
            )
            if len(trial_cuts) == len(cuts):
                break
            cut_provider = _filtered(
                CutProvider(base_md, trial_cuts, trial_rhs, trial_senses)
            )
            # Dual warm restart from the previous root basis extended with
            # the new cuts' surplus columns: block-triangular, so the duals
            # (hence dual feasibility) are exactly preserved while the new
            # surpluses sit primal-infeasible — the dual simplex repairs
            # them directly instead of re-running phase 1 from scratch
            # (50v-10: the cold re-solve burned 1,900 phase-1 iterations).
            cut_warm = None
            if root.basis is not None and len(root.basis) == (
                base_md.nr_rows() - len(removed_rows) + len(cuts)
            ):
                cut_warm = list(root.basis) + [
                    base_n + t for t in range(len(cuts), len(trial_cuts))
                ]
            cut_root = solve_relaxation(
                cut_provider, cfg, warm_start_basis=cut_warm, mesh=mesh
            )
            if cut_root.status is SolveStatus.INFEASIBLE:
                # Valid inequalities never cut an integer point: the MIP
                # is infeasible.
                return MipResult(
                    SolveStatus.INFEASIBLE,
                    certified=cut_root.stats.certified,
                )
            if not cut_root.is_optimal():
                break  # numerical trouble: keep the last good round only
            improved = cut_root.exact_objective is not None and (
                root.exact_objective is None
                or cut_root.exact_objective > root.exact_objective
            )
            root_provider, root = cut_provider, cut_root
            cuts, cut_rhs, cut_senses = trial_cuts, trial_rhs, trial_senses
            if not improved:
                break  # bound stalled: keep this round's cuts but stop

    # --- one round of exact knapsack cover cuts (also globally valid:
    # branching only tightens upper bounds, which only strengthens the
    # covers' rhs absorption) on the post-GMI root point. ---
    if cover_cuts > 0:
        from relp_tpu_torch.mip.cuts import CutProvider, knapsack_cover_cuts

        reduced0 = getattr(root, "exact_bfs", None)
        if reduced0 is None:
            reduced0 = root.bfs
        if reduced0 is not None:
            x_active = root_provider.reconstruct_solution(
                copy.deepcopy(reduced0)
            )
            binaries = [
                k
                for k in actives
                if gf.variables[k].upper_bound == 1
                and gf.variables[k].lower_bound in (None, Fraction(0))
            ]
            if binaries:
                cov, cov_rhs, cov_senses = knapsack_cover_cuts(
                    gf, counts, binaries, x_active, max_cuts=cover_cuts
                )
                if cov:
                    trial_cuts = cuts + cov
                    trial_rhs = cut_rhs + cov_rhs
                    trial_senses = cut_senses + cov_senses
                    cov_provider = _filtered(
                        CutProvider(
                            base_md, trial_cuts, trial_rhs, trial_senses
                        )
                    )
                    cov_warm = None
                    if root.basis is not None and len(root.basis) == (
                        base_md.nr_rows() - len(removed_rows) + len(cuts)
                    ):
                        # The new <= slacks enter basic (their rows are
                        # violated at the root point -> negative values);
                        # the dual simplex repairs them like surpluses.
                        cov_warm = list(root.basis) + [
                            base_n + t
                            for t in range(len(cuts), len(trial_cuts))
                        ]
                    cov_root = solve_relaxation(
                        cov_provider,
                        cfg,
                        warm_start_basis=cov_warm,
                        mesh=mesh,
                    )
                    if cov_root.status is SolveStatus.INFEASIBLE:
                        return MipResult(
                            SolveStatus.INFEASIBLE,
                            certified=cov_root.stats.certified,
                        )
                    if cov_root.is_optimal():
                        root_provider, root = cov_provider, cov_root
                        cuts, cut_rhs, cut_senses = (
                            trial_cuts,
                            trial_rhs,
                            trial_senses,
                        )

    # Lazy branch rows: active-variable t-indices that ever received a
    # lower-bound branch, in insertion order.  Each becomes one CutProvider
    # row ``x'_k >= node.lower[t]`` appended after the root cuts; nodes in
    # a wave share the matrix and differ only in rhs.
    branch_vars: List[int] = []
    n_gmi = len(cuts)

    def wrap(md, node: _Node):
        if not cuts and not branch_vars:
            return _filtered(md)
        from relp_tpu_torch.mip.cuts import CutProvider

        rows = list(cuts) + [{actives[t]: Fraction(1)} for t in branch_vars]
        rhs = list(cut_rhs) + [node.lower[t] for t in branch_vars]
        senses = list(cut_senses) + [">="] * len(branch_vars)
        return _filtered(CutProvider(md, rows, rhs, senses))

    # Warm-start nodes from the root basis (only when it matches — the
    # removed-rows filter keeps root and node row counts aligned even
    # after rank repair) extended with the branch rows' surplus columns: the
    # extended basis is block-triangular over the root basis, so its duals
    # — hence dual feasibility — are exactly those of the root optimum, and
    # the batched dual simplex restores primal feasibility per node.
    root_basis = root.basis
    if root_basis is not None and len(root_basis) != (
        base_md.nr_rows() - len(removed_rows) + n_gmi
    ):
        root_basis = None

    def wave_warm_basis():
        if root_basis is None:
            return None
        return list(root_basis) + [
            base_n + n_gmi + j for j in range(len(branch_vars))
        ]

    result = MipResult(SolveStatus.FINITE_OPTIMUM)
    # Reported objectives include gf.fixed_cost (accrued by presolve's
    # removed variables and standardization's bound shifts); node-LP bounds
    # and the incumbent comparisons all share that constant, so pruning
    # stays on the raw LP objectives.
    fixed_cost = gf.fixed_cost
    if root.exact_objective is not None:
        result.root_objective = root.exact_objective + fixed_cost
    result.certified = bool(root.stats.certified)
    incumbent_obj: Optional[Fraction] = None
    incumbent_reduced = None
    incumbent_provider = None
    hint_solution: Optional[Solution] = None
    if incumbent_hint is not None:
        # A known integer-feasible Solution (e.g. the parent incumbent in a
        # RINS sub-solve, feasible here by construction since RINS only
        # tightens bounds): primes pruning from the first wave and spares
        # the dive.  Replaced by any strictly better tree incumbent.
        hint_solution = incumbent_hint
        incumbent_obj = incumbent_hint.objective_value - fixed_cost
    seq = 1
    heap: List[_Node] = []

    # Pseudocosts: (t, up) -> (sum of per-unit objective degradations,
    # sample count).  Uninitialized directions estimate 1.0, which makes
    # the product score f*(1-f) — exactly the most-fractional rule — until
    # real observations arrive (Benichou et al. 1971 / Achterberg 2007).
    pc: dict = {}

    def _pc_estimate(t: int, up: bool) -> float:
        entry = pc.get((t, up))
        if entry is None:
            return 1.0
        s, cnt = entry
        return s / cnt

    def consider(node: _Node, res: OptimizationResult, provider) -> None:
        """Prune / accept / branch one solved node."""
        nonlocal incumbent_obj, incumbent_reduced, incumbent_provider, seq
        if res.status is SolveStatus.INFEASIBLE:
            result.nodes_pruned += 1
            return
        if not res.is_optimal():
            # Numerical failure even after the single-LP escalation ladder:
            # the node's subtree cannot be certified-pruned.  Give up on
            # exactness honestly rather than silently dropping the subtree.
            result.certified = False
            result.nodes_pruned += 1
            return
        if not res.stats.certified:
            result.certified = False
        exact_bound = res.exact_objective
        if exact_bound is not None:
            bound, bound_exact = exact_bound, True
        else:
            # Priority only — a float-derived bound must never prune.
            bound = Fraction(float(res.objective)).limit_denominator(10**9)
            bound_exact = False
        if node.branch_t is not None:
            # Feed the observed degradation back into the pseudocosts
            # (heuristic only: floats never influence bounds or pruning).
            f_used = (
                1.0 - node.branch_frac if node.branch_up else node.branch_frac
            )
            gain = max(float(bound) - node.parent_bound_f, 0.0)
            key = (node.branch_t, node.branch_up)
            s, cnt = pc.get(key, (0.0, 0))
            pc[key] = (s + gain / max(f_used, 1e-9), cnt + 1)
        if (
            bound_exact
            and incumbent_obj is not None
            and bound >= incumbent_obj
        ):
            result.nodes_pruned += 1
            return
        values = _exact_values(res, provider, gf, actives)
        if values is None:
            result.certified = False
            result.nodes_pruned += 1
            return
        fractional = [
            (t, v) for t, v in enumerate(values) if v.denominator != 1
        ]
        if not fractional:
            # Integer feasible.  Only an exactly-certified incumbent may
            # drive pruning; an uncertified one is recorded but drops the
            # run's certified flag (already cleared above).
            if bound_exact and (incumbent_obj is None or bound < incumbent_obj):
                incumbent_obj = bound
                reduced = getattr(res, "exact_bfs", None)
                if reduced is None:
                    reduced = res.bfs
                incumbent_reduced = copy.deepcopy(reduced)
                incumbent_provider = provider
                result.objective = incumbent_obj + fixed_cost
            return
        import math

        if branching == "pseudocost":
            # Product rule over the estimated down/up degradations
            # (Achterberg 2007 §5.3); with no observations this is
            # f*(1-f), i.e. most-fractional.
            def pc_score(tv):
                t, v = tv
                f = float(v) - math.floor(v)
                return (
                    _pc_estimate(t, False) * max(f, 1e-6)
                ) * (_pc_estimate(t, True) * max(1.0 - f, 1e-6))

            t, v = max(fractional, key=pc_score)
        else:
            # Most-fractional: fractional part closest to 1/2.
            def frac_distance(tv):
                frac = tv[1] - math.floor(tv[1])
                return abs(frac - Fraction(1, 2))

            t, v = min(fractional, key=frac_distance)
        k = actives[t]
        frac_f = float(v) - math.floor(v)
        down, up = _branch_bounds(gf.variables[k], v)
        for child_up, (kind, val) in enumerate((down, up)):
            lower = list(node.lower)
            upper = list(node.upper)
            if kind == "lb":
                lower[t] = max(lower[t], max(val, Fraction(0)))
                if lower[t] > 0 and t not in branch_vars:
                    # First lower-bound branch on this variable: it gets a
                    # lazy branch row in every subsequent wave's wrapper.
                    branch_vars.append(t)
            else:
                upper[t] = min(upper[t], val)
            if upper[t] < lower[t] or upper[t] < 0:
                result.nodes_pruned += 1
                continue
            if (tuple(lower), tuple(upper)) == (node.lower, node.upper):
                # The branch did not shrink the box: the node's claimed LP
                # value lies OUTSIDE its own bounds — a numerically-broken
                # (necessarily uncertified) node result.  Re-pushing the
                # identical box loops forever; drop the subtree honestly.
                result.certified = False
                result.nodes_pruned += 1
                continue
            heapq.heappush(
                heap,
                _Node(
                    bound,
                    seq,
                    tuple(lower),
                    tuple(upper),
                    bound_exact,
                    branch_t=t,
                    branch_up=bool(child_up),
                    branch_frac=frac_f,
                    parent_bound_f=float(bound),
                ),
            )
            seq += 1

    # --- root strong branching: one batched dispatch over the top-K
    # fractional candidates' down/up children (a perturbed-rhs family over
    # ONE matrix: GMI cuts + one branch row per candidate), warm-started
    # from the root basis.  Exact bounds/pruning are untouched — outputs
    # are pseudocost seeds (float heuristics) and certified-infeasible
    # root fixings (exact). ---
    _left = _time_left()
    if _left is not None and _left <= 0:
        strong_branching = 0
        dive_rounds = 0
    if strong_branching > 0 and root_basis is not None:
        sb_vals = _exact_values(root, root_provider, gf, actives)
        sb_frac = (
            []
            if sb_vals is None
            else [
                (t, v) for t, v in enumerate(sb_vals) if v.denominator != 1
            ]
        )
        if len(sb_frac) > 1:
            from relp_tpu_torch.mip.cuts import CutProvider

            sb_frac.sort(
                key=lambda tv: abs(
                    (tv[1] - math.floor(tv[1])) - Fraction(1, 2)
                )
            )
            cands = sb_frac[:strong_branching]
            sb_rows = list(cuts) + [
                {actives[t]: Fraction(1)} for t, _ in cands
            ]
            sb_senses = list(cut_senses) + [">="] * len(cands)
            sb_warm = list(root_basis) + [
                base_n + n_gmi + j for j in range(len(cands))
            ]
            root_obj_f = float(root.objective)

            def sb_child(t, v, which):
                """(lower, upper) of candidate t's down/up child, or None
                when the child box is empty."""
                down, up_b = _branch_bounds(gf.variables[actives[t]], v)
                kind, val = down if which == 0 else up_b
                lower = list(root_lower)
                upper = list(root_upper)
                if kind == "lb":
                    lower[t] = max(lower[t], max(val, Fraction(0)))
                else:
                    upper[t] = min(upper[t], val)
                if upper[t] < lower[t] or upper[t] < 0:
                    return None
                return tuple(lower), tuple(upper)

            def sb_provider(lower, upper):
                nd = _Node(Fraction(0), 0, lower, upper)
                md = _node_provider(gf, counts, actives, nd)
                rhs = list(cut_rhs) + [lower[t] for t, _ in cands]
                return _filtered(CutProvider(md, sb_rows, rhs, sb_senses))

            metas = []  # (t, v, which) aligned with providers
            providers = []
            for t, v in cands:
                for which in (0, 1):
                    cb = sb_child(t, v, which)
                    if cb is None:
                        continue
                    metas.append((t, v, which))
                    providers.append(sb_provider(*cb))
            if len(providers) == 1:
                sb_solved = [
                    solve_relaxation(
                        providers[0], cfg, warm_start_basis=sb_warm,
                        mesh=mesh,
                    )
                ]
            else:
                sb_solved = solve_batch(
                    providers,
                    cfg,
                    certify=True,
                    shared_structure=True,
                    warm_start_basis=sb_warm,
                    mesh=mesh,
                )
            infeasible_sides: dict = {}
            for (t, v, which), res in zip(metas, sb_solved):
                f = float(v) - math.floor(v)
                f_used = f if which == 0 else 1.0 - f
                if res.status is SolveStatus.INFEASIBLE:
                    if res.stats.certified:
                        infeasible_sides.setdefault(t, set()).add(which)
                    continue
                if not res.is_optimal():
                    continue
                gain = max(float(res.objective) - root_obj_f, 0.0)
                key = (t, which == 1)
                s, cnt = pc.get(key, (0.0, 0))
                pc[key] = (s + gain / max(f_used, 1e-9), cnt + 1)
            # Certified-infeasible children fix the root to the other side.
            new_lower = list(root_node.lower)
            new_upper = list(root_node.upper)
            for t, sides in infeasible_sides.items():
                v = dict(cands)[t]
                if sides == {0, 1}:
                    return dataclasses.replace(
                        result, status=SolveStatus.INFEASIBLE, objective=None
                    )
                which_dead = next(iter(sides))
                down, up_b = _branch_bounds(gf.variables[actives[t]], v)
                kind, val = up_b if which_dead == 0 else down
                if kind == "lb":
                    new_lower[t] = max(new_lower[t], max(val, Fraction(0)))
                    if new_lower[t] > 0 and t not in branch_vars:
                        branch_vars.append(t)
                else:
                    new_upper[t] = min(new_upper[t], val)
                if new_upper[t] < new_lower[t]:
                    return dataclasses.replace(
                        result, status=SolveStatus.INFEASIBLE, objective=None
                    )
            root_node.lower = tuple(new_lower)
            root_node.upper = tuple(new_upper)

    consider(root_node, root, root_provider)
    result.nodes_solved = 1

    # --- root rounding dive (relaxation-induced rounding): each round
    # fixes the CURRENT fractional integer variables at their nearest
    # integral value — the upper side is an rhs tweak, the lower side a
    # small dive-local ``x >= a`` row (only for positive fixings) — then
    # re-solves one dual-warm LP so the free variables compensate.  Fixed
    # variables stay fixed, so the fractional set shrinks toward an
    # integer-feasible certified point (the initial incumbent) or the
    # restriction turns infeasible (give up — the tree still runs). ---
    if dive_rounds > 0 and incumbent_obj is None and actives:
        dive_lower = list(root_node.lower)
        dive_upper = list(root_node.upper)
        dive_lb_vars: List[int] = []  # t indices with a dive lb row
        dive_vals = _exact_values(root, root_provider, gf, actives)

        def _active_value(var, k: Fraction) -> Fraction:
            return k + var.shift if not var.flipped else var.shift - k

        def dive_wrap(md):
            rows = (
                list(cuts)
                + [{actives[t]: Fraction(1)} for t in branch_vars]
                + [{actives[t]: Fraction(1)} for t in dive_lb_vars]
            )
            rhs = (
                list(cut_rhs)
                + [dive_lower[t] for t in branch_vars]
                + [dive_lower[t] for t in dive_lb_vars]
            )
            senses = list(cut_senses) + [">="] * (
                len(branch_vars) + len(dive_lb_vars)
            )
            if not rows:
                return _filtered(md)
            return _filtered(CutProvider(md, rows, rhs, senses))

        def dive_warm():
            if root_basis is None:
                return None
            return list(root_basis) + [
                base_n + n_gmi + j
                for j in range(len(branch_vars) + len(dive_lb_vars))
            ]

        from relp_tpu_torch.mip.cuts import CutProvider

        best_frac = None
        stalled_rounds = 0
        for _ in range(dive_rounds):
            left = _time_left()
            if left is not None and left <= 0:
                break
            if dive_vals is None:
                break
            dive_frac = [
                (t, v) for t, v in enumerate(dive_vals)
                if v.denominator != 1
            ]
            if not dive_frac:
                break  # integral — consider() already handled the root
            # Each round fixes every fractional variable, but freed
            # continuous/integral movement creates new ones; abort when
            # the fractional count stops shrinking.
            if best_frac is not None and len(dive_frac) >= best_frac:
                stalled_rounds += 1
                if stalled_rounds >= 5:
                    break
            else:
                best_frac = len(dive_frac)
                stalled_rounds = 0
            if len(dive_frac) <= 8:
                # Endgame: fix only the most-nearly-integral variable so
                # the re-solve barely moves (fix-all oscillates here:
                # observed 5 -> 5 -> 6 -> 7 on 50v-10's tail).
                def _dist(tv):
                    f = tv[1] - math.floor(tv[1])
                    return min(f, 1 - f)

                dive_frac = [min(dive_frac, key=_dist)]
            ok = True
            for t, v in dive_frac:
                var = gf.variables[actives[t]]
                k = Fraction(math.floor(v))
                if v - k >= Fraction(1, 2):
                    k += 1
                if stalled_rounds >= 2 and stalled_rounds % 2 == 0:
                    # Cycling escape: periodically round AWAY from the LP
                    # value (the classic feasibility-pump flip).  One
                    # stalled round is normal in the fix-one endgame, so
                    # flips start at the second.
                    k = 2 * Fraction(math.floor(v)) + 1 - k
                a = _active_value(var, k)
                if a < dive_lower[t] or a > dive_upper[t] or a < 0:
                    # nearest is outside the box: try the other side
                    k2 = 2 * Fraction(math.floor(v)) + 1 - k
                    a = _active_value(var, k2)
                    if a < dive_lower[t] or a > dive_upper[t] or a < 0:
                        ok = False
                        break
                dive_upper[t] = a
                dive_lower[t] = a
                if a > 0 and t not in dive_lb_vars:
                    dive_lb_vars.append(t)
            if not ok:
                break
            dive_node = _Node(
                Fraction(0), 0, tuple(dive_lower), tuple(dive_upper)
            )
            dive_prov = dive_wrap(
                _node_provider(gf, counts, actives, dive_node)
            )
            dive_res = solve_relaxation(
                dive_prov, cfg, warm_start_basis=dive_warm(), mesh=mesh
            )
            result.dive_lps += 1
            if not dive_res.is_optimal():
                break  # infeasible/failed restriction: abandon the dive
            dive_vals = _exact_values(dive_res, dive_prov, gf, actives)
            if (
                dive_vals is not None
                and all(v.denominator == 1 for v in dive_vals)
                and dive_res.stats.certified
                and dive_res.exact_objective is not None
            ):
                incumbent_obj = dive_res.exact_objective
                reduced = getattr(dive_res, "exact_bfs", None)
                if reduced is None:
                    reduced = dive_res.bfs
                incumbent_reduced = copy.deepcopy(reduced)
                incumbent_provider = dive_prov
                result.objective = incumbent_obj + fixed_cost
                result.dive_incumbent = True
                break

    # --- RINS (relaxation-induced neighborhood search, Danna et al. 2005):
    # fix every integer variable whose exact incumbent value agrees with
    # the root-LP value, exactly solve the sub-MIP (the same ORIGINAL
    # problem with tightened bounds — every feasible point of the sub-MIP
    # is feasible for the full MIP), adopt a strictly better certified
    # incumbent, repeat with the new agreements.  Beyond reference scope. ---
    rins_solution: Optional[Solution] = None
    if rins_rounds > 0 and incumbent_obj is not None and actives:
        import logging as _logging

        _rins_log = _logging.getLogger("relp_tpu_torch.mip.rins")
        lp_vals = _exact_values(root, root_provider, gf, actives)

        def _incumbent_orig_values():
            # The incumbent may exist only as a caller-provided hint (public
            # API: incumbent_hint + rins_rounds with no tree incumbent), in
            # which case incumbent_provider is None; hint_solution is a full
            # original-space Solution and serves the same role.
            full = rins_solution
            if full is None and incumbent_provider is None:
                full = hint_solution
            if full is not None:
                return [
                    full.value_of(
                        gf.original_variables[gf.from_active_to_original[k]][0]
                    )
                    for k in actives
                ]
            vals = incumbent_provider.reconstruct_solution(
                copy.deepcopy(incumbent_reduced)
            )
            out = []
            for k in actives:
                var = gf.variables[k]
                orig = vals.get(k) - var.shift
                if var.flipped:
                    orig = -orig
                out.append(orig)
            return out

        import random as _random

        for _round in range(rins_rounds):
            left = _time_left()
            if left is not None and left <= 0:
                break
            if lp_vals is None:
                break
            inc_vals = _incumbent_orig_values()
            sub_gf = copy.deepcopy(gf_snapshot)
            # Round 0 fixes the full agreement set (classic RINS).  Later
            # rounds open TARGETED neighborhoods: everything positive in
            # the incumbent (the paid-for activity pattern the dive chose
            # greedily) and every general integer is freed, plus a growing
            # random fraction of the remaining agreements — root LPs that
            # are integral almost everywhere (binaries at 0) make the
            # classic neighborhood trivially tight (50v-10: round 0 fixes
            # 1578/1647 and proves the dive incumbent locally optimal).
            free_frac = 0.0 if _round <= 1 else 0.08 * (2 ** (_round - 2))
            rng = _random.Random(9091 + _round)
            fixed_ct = 0
            for t, k in enumerate(actives):
                orig = gf.from_active_to_original[k]
                if lp_vals[t] != inc_vals[t]:
                    continue  # disagreement: always free
                if _round >= 1 and (
                    inc_vals[t] != 0
                    or (gf_snapshot.variables[orig].upper_bound or 2) > 1
                ):
                    continue  # targeted: active pattern + general integers
                if free_frac and rng.random() < free_frac:
                    continue
                v = inc_vals[t]
                sub_gf.variables[orig].lower_bound = v
                sub_gf.variables[orig].upper_bound = v
                fixed_ct += 1
            if fixed_ct == 0 or fixed_ct == len(actives):
                break  # nothing to search (or nothing left free)
            _rins_log.info(
                "RINS round %d: fixed %d/%d integer variables, sub-MIP "
                "budgets nodes=%d time=%.0fs",
                _round, fixed_ct, len(actives), rins_nodes,
                rins_time_s if _time_left() is None
                else max(min(rins_time_s, _time_left()), 0.0),
            )
            hint = rins_solution
            if hint is None and incumbent_provider is not None:
                hint = gf.compute_full_solution_with_reduced_solution(
                    incumbent_provider.reconstruct_solution(
                        copy.deepcopy(incumbent_reduced)
                    )
                )
            sub = solve_mip(
                sub_gf,
                config,
                batch_width=batch_width,
                node_limit=rins_nodes,
                gomory_cuts=gomory_cuts,
                cut_rounds=cut_rounds,
                cover_cuts=cover_cuts,
                branching=branching,
                strong_branching=strong_branching,
                dive_rounds=dive_rounds,
                incumbent_hint=hint,
                rins_rounds=0,
                time_limit_s=(
                    rins_time_s
                    if _time_left() is None
                    else max(min(rins_time_s, _time_left()), 0.0)
                ),
                mesh=mesh,
            )
            _rins_log.info(
                "RINS round %d: sub status=%s objective=%s vs incumbent %s",
                _round, sub.status.value,
                None if sub.objective is None else float(sub.objective),
                float(incumbent_obj + fixed_cost),
            )
            if (
                sub.status is SolveStatus.FINITE_OPTIMUM
                and sub.objective is not None
                and sub.objective < incumbent_obj + fixed_cost
            ):
                # The sub-incumbent is an exactly certified feasible point
                # of the full MIP; adopt it (and sharpen wave pruning).
                rins_solution = sub.solution
                incumbent_obj = sub.objective - fixed_cost
                incumbent_reduced = None
                incumbent_provider = None
                result.objective = sub.objective
                result.rins_incumbent = True
                result.dive_incumbent = False
                result.rins_improvements += 1
            # No break on a non-improving round: the next round frees a
            # larger random fraction of the agreement set.

    # --- local branching (Fischetti & Lodi 2003): one Hamming-ball row
    # around the incumbent over the ORIGINAL binary variables.  See the
    # docstring; runs after RINS, re-centering on improvements and
    # enlarging the radius when a ball is proven optimal. ---
    if local_branching > 0 and incumbent_obj is not None and actives:
        import logging as _logging

        _lb_log = _logging.getLogger("relp_tpu_torch.mip.lb")

        def _current_solution() -> Solution:
            if rins_solution is not None:
                return rins_solution
            if incumbent_provider is None:
                # Incumbent supplied as a hint only (see _incumbent_orig_values).
                return hint_solution
            return gf.compute_full_solution_with_reduced_solution(
                incumbent_provider.reconstruct_solution(
                    copy.deepcopy(incumbent_reduced)
                )
            )

        k_ball = local_branching
        for _round in range(lb_rounds):
            left = _time_left()
            if left is not None and left <= 0:
                break
            center = _current_solution()
            sub_gf = copy.deepcopy(gf_snapshot)
            cols = sub_gf.constraints.columns
            row_i = sub_gf.constraints.nr_rows
            ones = 0
            n_bin = 0
            for j, ((name, _entry), var) in enumerate(
                zip(sub_gf.original_variables, sub_gf.variables)
            ):
                if (
                    var.variable_type is VariableType.INTEGER
                    and var.lower_bound == 0
                    and var.upper_bound == 1
                ):
                    n_bin += 1
                    v = center.value_of(name)
                    if v == 0:
                        cols[j].append((row_i, Fraction(1)))
                    else:
                        ones += 1
                        cols[j].append((row_i, Fraction(-1)))
            if n_bin == 0:
                break
            from relp_tpu_torch.data.elements import RangedConstraintRelation

            sub_gf.constraints.nr_rows = row_i + 1
            sub_gf.constraint_types.append(RangedConstraintRelation.less())
            sub_gf.b.append(Fraction(k_ball - ones))
            _lb_log.info(
                "LB round %d: radius %d ball over %d binaries (|x̂=1|=%d)",
                _round, k_ball, n_bin, ones,
            )
            sub = solve_mip(
                sub_gf,
                config,
                batch_width=batch_width,
                node_limit=rins_nodes,
                gomory_cuts=gomory_cuts,
                cut_rounds=cut_rounds,
                cover_cuts=cover_cuts,
                branching=branching,
                strong_branching=strong_branching,
                dive_rounds=0,
                incumbent_hint=center,
                rins_rounds=0,
                local_branching=0,
                time_limit_s=(
                    rins_time_s
                    if _time_left() is None
                    else max(min(rins_time_s, _time_left()), 0.0)
                ),
                mesh=mesh,
            )
            _lb_log.info(
                "LB round %d: sub status=%s objective=%s vs incumbent %s",
                _round, sub.status.value,
                None if sub.objective is None else float(sub.objective),
                float(incumbent_obj + fixed_cost),
            )
            if (
                sub.status is SolveStatus.FINITE_OPTIMUM
                and sub.objective is not None
                and sub.objective < incumbent_obj + fixed_cost
            ):
                rins_solution = sub.solution
                incumbent_obj = sub.objective - fixed_cost
                incumbent_reduced = None
                incumbent_provider = None
                result.objective = sub.objective
                result.lb_incumbent = True
                result.rins_incumbent = False
                result.dive_incumbent = False
                result.lb_improvements += 1
                # Re-center at the same radius next round.
            else:
                k_ball *= 2  # proven-optimal or budget-limited ball: widen

    t0 = t_entry
    gap_target = (
        rel_gap if isinstance(rel_gap, Fraction) else Fraction(str(rel_gap))
    )
    gap_stop = False

    while heap and result.nodes_solved < node_limit:
        if time_limit_s is not None and _time.time() - t0 > time_limit_s:
            result.time_limit_hit = True
            break
        if incumbent_obj is not None and gap_target > 0:
            # The heap min is the global dual bound; only exact bounds can
            # prove a gap.  (Float-bound nodes are rare — every certified
            # node yields an exact bound — so the all() is cheap.)
            if all(n.bound_exact for n in heap):
                bb = min(n.bound for n in heap)
                denom = max(Fraction(1), abs(incumbent_obj))
                if (incumbent_obj - bb) / denom <= gap_target:
                    gap_stop = True
                    break
        wave: List[_Node] = []
        while (
            heap
            and len(wave) < batch_width
            and result.nodes_solved + len(wave) < node_limit
        ):
            node = heapq.heappop(heap)
            if (
                node.bound_exact
                and incumbent_obj is not None
                and node.bound >= incumbent_obj
            ):
                result.nodes_pruned += 1
                continue
            wave.append(node)
        if not wave:
            break
        providers = [
            wrap(_node_provider(gf, counts, actives, n), n) for n in wave
        ]
        warm_basis = wave_warm_basis()
        if len(providers) == 1:
            solved = [
                solve_relaxation(
                    providers[0], cfg, warm_start_basis=warm_basis,
                    mesh=mesh,
                )
            ]
        else:
            solved = solve_batch(
                providers,
                cfg,
                certify=True,
                shared_structure=True,
                warm_start_basis=warm_basis,
                mesh=mesh,
            )
        for node, res, provider in zip(wave, solved, providers):
            consider(node, res, provider)
        result.nodes_solved += len(wave)

    result.node_limit_hit = (
        bool(heap)
        and not gap_stop
        and not result.time_limit_hit
        and result.nodes_solved >= node_limit
    )
    result.branch_vars_used = len(branch_vars)

    # Global dual bound over everything still open plus the incumbent;
    # rigorous whenever every contributing node bound is exact.
    open_bounds = [n.bound for n in heap]
    candidates = list(open_bounds)
    if incumbent_obj is not None:
        candidates.append(incumbent_obj)
    if candidates:
        result.best_bound = min(candidates) + fixed_cost
        result.best_bound_exact = all(n.bound_exact for n in heap)

    if incumbent_obj is None:
        if result.node_limit_hit or result.time_limit_hit:
            # Limit reached before any integer-feasible point was found:
            # not a numerical failure — best_bound still carries the
            # rigorous dual bound reached so far.
            return dataclasses.replace(
                result, status=SolveStatus.ITERATION_LIMIT, certified=False
            )
        return dataclasses.replace(
            result,
            status=SolveStatus.INFEASIBLE,
            objective=None,
            best_bound=None,
        )
    # The incumbent is exactly optimal only if the tree was exhausted.
    if result.node_limit_hit or result.time_limit_hit or gap_stop:
        result.certified = False
    if incumbent_provider is not None:
        reduced = incumbent_provider.reconstruct_solution(incumbent_reduced)
        result.solution = gf.compute_full_solution_with_reduced_solution(
            reduced
        )
        result.objective = result.solution.objective_value
        assert result.objective == incumbent_obj + fixed_cost
    else:
        # RINS incumbent or hint: already a full original-space Solution
        # of the same problem.
        sol = rins_solution if rins_solution is not None else hint_solution
        result.solution = sol
        result.objective = sol.objective_value
        assert result.objective == incumbent_obj + fixed_cost
    if result.best_bound is not None:
        result.gap = (result.objective - result.best_bound) / max(
            Fraction(1), abs(result.objective)
        )
    return result
