"""Exact branch and bound: ``solve_mip`` on knapsacks of the
configuration's class, one instance after another, each searched for the
configuration's ``node_limit`` nodes with its solver settings and the
cell's node-wave width.

Instance ``i`` of a run is drawn from (seed, i); the warm-up searches the
first ``traffic["warmup_searches"]`` instances of WARM_SEED, the same for
every seed (so that the memory reserved after set-up is the same in every
run), as the window does, so that the window finds the batch driver's process-wide
cache of steps holding the shapes that node waves of this class take (its
first searches in a process capture most of them).  The window starts
instances until ``seconds`` have passed; the one running then finishes and
counts, so every instance does the same search whatever the host's speed.  Every LP that branch and bound sends to ``solve_batch``
or to the single-LP driver is kept with its answer; the judge re-solves a
sample of them with the plain reference, and checks each instance's start
(its LP relaxation, from the raw data), its incumbent and its bound.
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Dict, List

import numpy as np

from portbench.problems import mknap
from portbench.reference import lp as ref
from portbench.reference import mknap as ref_mknap

# The seed of the warm-up's instances.
WARM_SEED = 1_000_003


def provider_lp(provider) -> ref.LP:
    """A node LP as plain lists, read through the provider's exact
    interface (the LP that branch and bound built: its branch rows and
    cuts are the program's state)."""
    columns = [[(i, Fraction(v)) for i, v in provider.exact_column_entries(j)]
               for j in range(provider.nr_columns())]
    return ref.LP(columns, [Fraction(v) for v in provider.right_hand_side()],
                  [Fraction(provider.cost_value(j)) for j in range(provider.nr_columns())])


class Search:
    def __init__(self, cfg: Dict, cell: Dict, seed: int, platform):
        from relp_tpu_torch.config import SolverConfig
        from relp_tpu_torch.mip import solve_mip

        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.solver = SolverConfig(platform=platform, **cfg.get("solver", {}))
        self.solve_mip = solve_mip
        self.runs: List = []  # (W, capacity, profit, MipResult, first LP index)
        self.lps: List = []  # (provider, result) of every LP the searches sent

    def _search(self, index_seed, index, **limits):
        data = mknap.draw(self.cfg, index_seed, index)
        return data, self.solve_mip(
            mknap.model(data, integer=True), self.solver,
            batch_width=self.cell["traffic"]["batch_width"], **limits)

    def warm_up(self) -> None:
        for index in range(self.cell["traffic"]["warmup_searches"]):
            self._search(WARM_SEED, index, node_limit=self.cfg["node_limit"])

    def window(self, seconds: float, recorder) -> None:
        recorder.keep = self.lps
        t0 = time.perf_counter()
        index = 0
        while time.perf_counter() - t0 < seconds:
            first = len(self.lps)
            data, mip = self._search(self.seed, index, node_limit=self.cfg["node_limit"])
            self.runs.append((*data, mip, first))
            recorder.unit_done()
            index += 1

    def attempted_failed(self):
        return len(self.lps), sum(1 for _p, r in self.lps if not r.stats.certified)

    def free(self) -> None:
        """Keep the node LPs to judge as plain lists, and only the answers."""
        self.picks = self.sample(self.seed)
        self.judged = [(provider_lp(self.lps[k][0]), _said(self.lps[k][1]))
                       for k in self.picks]
        self.lps_total = len(self.lps)
        self.lps = []

    def sample(self, seed: int) -> List[int]:
        """``traffic["sample"]`` LPs drawn from the seed, and the first LP of
        each search (its root relaxation)."""
        rng = np.random.default_rng([int(seed) % 2**64, 17])
        n = len(self.lps)
        picks = set(rng.choice(n, size=min(n, self.cell["traffic"]["sample"]),
                               replace=False).tolist()) if n else set()
        picks.update(first for *_rest, first in self.runs if first < n)
        return sorted(picks)

    def judge(self, seed: int, control: str = None) -> Dict:
        """The numbers compared, each (value, limit 0): sampled node LPs whose
        status or exact objective differs from the reference's, or that were
        not certified; searches whose first LP's optimum is not the raw
        instance's LP relaxation (a knapsack's presolve and standardization
        move no constant out of its objective); incumbents that are not
        0/1, break a row or do not give their objective; bounds out of
        order (relaxation <= best bound <= incumbent) or not exact.  With
        ``control`` (a precision) the reference's float simplex answers
        the node LPs and the relaxation in the program's place."""
        counts = dict(status=0, objective=0, uncertified=0, root=0, incumbent=0,
                      bound=0)
        for lp, said in self.judged:
            want = ref.solve(lp)
            if control is not None:
                got = ref.solve(lp, precision=control, exact=False)
                said = (got.status, got.objective, True)
            status, objective, certified = said
            counts["status"] += status != want.status
            counts["objective"] += objective != want.objective
            counts["uncertified"] += not certified
        for W, capacity, profit, mip, first in self.runs:
            relax = ref.solve(ref_mknap.relaxation(W, capacity, profit))
            root = [s for k, (_lp, s) in zip(self.picks, self.judged) if k == first]
            if control is not None:
                got = ref.solve(ref_mknap.relaxation(W, capacity, profit),
                                precision=control, exact=False)
                root = [(got.status, got.objective, True)]
            counts["root"] += not (root and root[0][1] == relax.objective)
            if mip.objective is not None:
                counts["incumbent"] += not ref_mknap.point_holds(
                    W, capacity, profit, dict(mip.solution.solution_values),
                    mip.objective)
            top = mip.objective if mip.objective is not None else None
            counts["bound"] += not (
                mip.best_bound is not None and mip.best_bound_exact
                and relax.objective <= mip.best_bound
                and (top is None or mip.best_bound <= top))
        return {
            "wrong_node_status": (counts["status"], 0),
            "wrong_node_objective": (counts["objective"], 0),
            "uncertified_nodes": (counts["uncertified"], 0),
            "wrong_relaxation": (counts["root"], 0),
            "wrong_incumbent": (counts["incumbent"], 0),
            "bound_out_of_order": (counts["bound"], 0),
        }


def _said(result):
    return (result.status.value, result.exact_objective, bool(result.stats.certified))


def make(cfg: Dict, cell: Dict, seed: int, platform) -> Search:
    return Search(cfg, cell, seed, platform)
