"""Problem representation layer.

Host-side, exact-rational mirror of the reference's ``src/data``:
LP vocabulary (elements), the mutable ``GeneralForm``, presolve, prescale,
solution reconstruction, and the network modeling kit.
"""

from relp_tpu_torch.data.elements import (
    ConstraintRelation,
    RangedConstraintRelation,
    BoundDirection,
    LinearProgramType,
    Objective,
    VariableType,
)
from relp_tpu_torch.data.general_form import GeneralForm, Variable
from relp_tpu_torch.data.solution import Solution

__all__ = [
    "ConstraintRelation",
    "RangedConstraintRelation",
    "BoundDirection",
    "LinearProgramType",
    "Objective",
    "VariableType",
    "GeneralForm",
    "Variable",
    "Solution",
]
