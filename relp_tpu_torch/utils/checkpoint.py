"""Checkpoint / resume.

The reference has no checkpointing; SURVEY.md section 5 identifies the basis
as the natural checkpoint unit (the reference's ``IM::from_basis`` rebuilds
everything from the basis index list, carry/mod.rs:444-478).  Here:

* :func:`save_basis` persists the structural basis (plus metadata) as JSON;
* :func:`load_basis` restores it for ``solve_relaxation(...,
  warm_start_basis=...)``, which refactorizes and continues — phase 1 is
  skipped entirely when the saved basis is still feasible.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


def save_basis(path: str, basis: List[int], metadata: Optional[Dict] = None) -> None:
    payload = {
        "format": "relp_tpu-basis-v1",
        "timestamp": time.time(),
        "basis": [int(j) for j in basis],
        "metadata": metadata or {},
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def load_basis(path: str) -> List[int]:
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format") != "relp_tpu-basis-v1":
        raise ValueError(f"not a relp_tpu basis checkpoint: {path}")
    return [int(j) for j in payload["basis"]]
