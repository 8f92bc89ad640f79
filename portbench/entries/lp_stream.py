"""A stream of single LPs: one caller sends the next LP when the previous
answer returns (a closed loop of one client), each through
``solve_general_form`` with the configuration's solver settings.

LP ``i`` of a run is the configuration's problem (the module it names
under ``"problem"``, such as ``portbench.problems.mknap``) drawn from
(seed, i); the warm-up solves LPs of seed + WARM_OFFSET.  The window sends
LPs until ``seconds`` have passed and ends when the last one returns.  The
judge re-solves a sample of the window's LPs with the plain reference, from
the drawn data alone.
"""

from __future__ import annotations

import importlib
import time
from fractions import Fraction
from typing import Dict, List

import numpy as np

from portbench.reference import lp as ref

WARM_OFFSET = 1_000_003


def problem(cfg: Dict):
    """The module of the configuration's problem."""
    return importlib.import_module(cfg["problem"])


def solver_config(cfg: Dict, platform):
    from relp_tpu_torch.config import SolverConfig

    return SolverConfig(platform=platform, **cfg.get("solver", {}))


class Stream:
    def __init__(self, cfg: Dict, cell: Dict, seed: int, platform):
        from relp_tpu_torch.simplex import solve_general_form

        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.problem = problem(cfg)
        self.solver = solver_config(cfg, platform)
        self.solve = solve_general_form
        self.answers: List = []  # (index, data, result, solution, device objective)

    def warm_up(self) -> None:
        for i in range(self.cell["traffic"]["warmup_lps"]):
            data = self.problem.draw(self.cfg, self.seed + WARM_OFFSET, i)
            self.solve(self.problem.model(data), self.solver)

    def window(self, seconds: float, recorder) -> None:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            data = self.problem.draw(self.cfg, self.seed, i)
            kept = len(recorder.device_objectives)
            result, solution = recorder.request(self.solve, self.problem.model(data),
                                                self.solver)
            device = recorder.device_objectives[-1][0] if len(
                recorder.device_objectives) > kept else None
            self.answers.append((i, data, result, solution, device))
            recorder.unit_done()
            i += 1

    def attempted_failed(self):
        return len(self.answers), sum(
            1 for _i, _d, r, s, _f in self.answers
            if not (r.stats.certified and s is not None))

    def free(self) -> None:
        """Keep only what the judge reads of each answer."""
        self.answers = [(i, d, _Said.of(r, s, f)) for i, d, r, s, f in self.answers]

    def sample(self, seed: int) -> List:
        """The answers to judge: ``traffic["sample"]`` drawn from the seed,
        and the one that took the most pivots."""
        rng = np.random.default_rng([int(seed) % 2**64, 17])
        n = len(self.answers)
        picks = set(rng.choice(n, size=min(n, self.cell["traffic"]["sample"]),
                               replace=False).tolist()) if n else set()
        if n:
            picks.add(max(range(n), key=lambda k: self.answers[k][2].pivots))
        return [self.answers[k] for k in sorted(picks)]

    def judge(self, seed: int, control: str = None) -> Dict:
        """The numbers compared, each (value, limit): wrong statuses, wrong
        exact objectives, points that break the LP or do not give their
        objective, answers not certified (all limit 0), and the widest
        relative gap of the device's float objective before certification
        from the exact optimum.  With ``control`` (a precision) the
        reference's float simplex in that precision answers in the
        program's place."""
        counts = dict(status=0, objective=0, point=0, uncertified=0)
        gap = 0.0
        for i, data, said in self.sample(seed):
            lp = self.problem.reference_lp(data)
            want = ref.solve(lp)
            if control is not None:
                got = ref.solve(lp, precision=control, exact=False)
                names = self.problem.names(data)
                said = _Said(got.status, got.objective,
                             {names[j]: v for j, v in (got.x or {}).items()
                              if j < len(names)},
                             True, got.float_objective, got.pivots)
            counts["status"] += said.status != want.status
            counts["objective"] += said.objective != want.objective
            counts["point"] += not (said.values is not None and self.problem.point_holds(
                data, said.values, said.objective))
            counts["uncertified"] += not said.certified
            if said.device is None:  # no float answer reached certification
                gap = max(gap, 1.0)
            else:
                gap = max(gap, abs(said.device - float(want.objective))
                          / max(1.0, abs(float(want.objective))))
        limits = self.cell["limits"]
        return {
            "wrong_status": (counts["status"], 0),
            "wrong_objective": (counts["objective"], 0),
            "wrong_point": (counts["point"], 0),
            "uncertified": (counts["uncertified"], 0),
            "device_gap": (gap, limits["device_gap"]),
        }


class _Said:
    """What the program said of one LP, as the judge reads it: status,
    exact objective, the point by name, certified, the device's float
    objective (before certification, in the LP's own sense) and pivots."""

    def __init__(self, status, objective, values, certified, device, pivots):
        self.status, self.objective, self.values = status, objective, values
        self.certified, self.device, self.pivots = certified, device, pivots

    @classmethod
    def of(cls, result, solution, device):
        objective = values = None
        if solution is not None:
            objective = Fraction(solution.objective_value)
            values = dict(solution.solution_values)
        if device is not None and objective is not None and \
                result.exact_objective is not None:
            # The provider's objective differs from the LP's by the constant
            # that presolve and standardization moved out of it.
            device = device + float(objective - result.exact_objective)
        return cls(result.status.value, objective, values,
                   bool(result.stats.certified), device,
                   result.stats.iterations + result.stats.dual_iterations)


def make(cfg: Dict, cell: Dict, seed: int, platform) -> Stream:
    return Stream(cfg, cell, seed, platform)
