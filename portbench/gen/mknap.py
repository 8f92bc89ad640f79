"""Multidimensional 0/1 knapsacks by Chu & Beasley's recipe (OR-Library
``mknapcb``, J. Heuristics 4 (1998) 63-86).

A frozen copy of ``relp_tpu_torch.testing.mknap_data``, so that the
benchmark's inputs do not move with the program's test helpers: the same
seed gives the same instance as that function (seed 7 is chip_smoke's
mip/real instance).  Only numpy is used.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def instance(cfg: Dict, seed: int, index: int = 0):
    """(W, capacity, profit) of instance ``index`` of the run of ``seed``:
    weights w_ij uniform on 1..1000, capacity_i = floor(tightness *
    sum_j w_ij), profit_j = sum_i w_ij // m plus a uniform draw on 0..500.
    Instance 0 is drawn from ``seed`` alone, as the copied function does."""
    words = [int(seed) % 2**64] + ([int(index)] if index else [])
    rng = np.random.default_rng(words if index else words[0])
    m, n = cfg["m"], cfg["n"]
    lo, hi = cfg["weights"]
    W = rng.integers(lo, hi + 1, size=(m, n))
    capacity = np.floor(cfg["tightness"] * W.sum(axis=1)).astype(np.int64)
    profit = W.sum(axis=0) // m + rng.integers(0, cfg["profit_extra"] + 1, size=n)
    return W, capacity, profit
