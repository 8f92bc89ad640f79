"""Scenario families: ``solve_batch(shared_structure=True, certify=True)`` on
families of ``traffic["family_size"]`` scenarios, one family after another,
with the configuration's solver settings.

Every scenario of a family shares the matrix and the costs and has its own
right-hand side: family f of a run is the configuration's problem's
``family(cfg, seed, f, size)``; the warm-up solves one family of seed +
WARM_OFFSET.  Each scenario's model is standardized without presolve
(presolve would depend on the right-hand side), so that all have the same
matrix and costs.  The window runs families until ``seconds`` have passed;
the family running then finishes and counts.  The judge re-solves a sample
of the scenarios with the plain reference, from the drawn data alone.  No
cell uses this entry yet (PERF.md, Open questions).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench.entries.lp_stream import WARM_OFFSET, problem, solver_config
from portbench.reference import lp as ref


class Families:
    def __init__(self, cfg: Dict, cell: Dict, seed: int, platform):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.problem = problem(cfg)
        self.solver = solver_config(cfg, platform)
        self.size = cell["traffic"]["family_size"]
        self.answers: List = []  # (data, result) of every scenario solved

    def providers(self, seed: int, family: int):
        """The family's scenarios, each its model standardized (the same
        structure for every right-hand side), and their data."""
        out, drawn = [], self.problem.family(self.cfg, seed, family, self.size)
        for data in drawn:
            gf = self.problem.model(data)
            out.append(gf.derive_matrix_data(gf.standardize()))
        return out, drawn

    def _solve(self, providers):
        from relp_tpu_torch.parallel import batch_driver

        return batch_driver.solve_batch(providers, self.solver, certify=True,
                                        shared_structure=True)

    def warm_up(self) -> None:
        self._solve(self.providers(self.seed + WARM_OFFSET, 0)[0])

    def window(self, seconds: float, recorder) -> None:
        t0 = time.perf_counter()
        family = 0
        while time.perf_counter() - t0 < seconds:
            providers, drawn = self.providers(self.seed, family)
            self.answers.extend(zip(drawn, self._solve(providers)))
            recorder.unit_done()
            family += 1

    def attempted_failed(self):
        return len(self.answers), sum(1 for _d, r in self.answers if not r.stats.certified)

    def free(self) -> None:
        self.answers = [(d, (r.status.value, r.exact_objective, bool(r.stats.certified)))
                        for d, r in self.answers]

    def judge(self, seed: int, control: str = None) -> Dict:
        """Sampled scenarios whose status or exact objective differs from the
        reference's, or that were not certified (each limit 0).  With
        ``control`` the reference's float simplex in that precision answers
        in the program's place."""
        rng = np.random.default_rng([int(seed) % 2**64, 17])
        n = len(self.answers)
        picks = sorted(rng.choice(n, size=min(n, self.cell["traffic"]["sample"]),
                                  replace=False).tolist()) if n else []
        counts = dict(status=0, objective=0, uncertified=0)
        for k in picks:
            data, said = self.answers[k]
            lp = self.problem.reference_lp(data)
            want = ref.solve(lp)
            if control is not None:
                got = ref.solve(lp, precision=control, exact=False)
                said = (got.status, got.objective, True)
            counts["status"] += said[0] != want.status
            counts["objective"] += said[1] != want.objective
            counts["uncertified"] += not said[2]
        return {"wrong_status": (counts["status"], 0),
                "wrong_objective": (counts["objective"], 0),
                "uncertified": (counts["uncertified"], 0)}


def make(cfg: Dict, cell: Dict, seed: int, platform) -> Families:
    return Families(cfg, cell, seed, platform)
