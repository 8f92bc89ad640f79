"""LP element vocabulary.

Python mirror of the reference's ``src/data/linear_program/elements.rs``:
constraint relations (including ranges ``b - r <= <a,x> <= b``), bound
directions, objective direction, variable types, and the solver result
vocabulary.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Union


class ConstraintRelation(enum.Enum):
    """==, <=, >= (reference: elements.rs ConstraintRelation)."""

    EQUAL = "=="
    LESS = "<="
    GREATER = ">="


class RangedKind(enum.Enum):
    EQUAL = "=="
    RANGE = "=r="
    LESS = "<="
    GREATER = ">="


@dataclass(frozen=True)
class RangedConstraintRelation:
    """A constraint relation that may carry a range.

    ``RANGE`` with value ``r > 0`` means ``b - r <= <a, x> <= b``
    (reference: elements.rs:44-59).
    """

    kind: RangedKind
    range: Optional[Fraction] = None

    def __post_init__(self) -> None:
        if self.kind is RangedKind.RANGE:
            if self.range is None or self.range <= 0:
                raise ValueError("range constraints must carry r > 0")
        elif self.range is not None:
            raise ValueError("only range constraints carry a value")

    @staticmethod
    def equal() -> "RangedConstraintRelation":
        return RangedConstraintRelation(RangedKind.EQUAL)

    @staticmethod
    def less() -> "RangedConstraintRelation":
        return RangedConstraintRelation(RangedKind.LESS)

    @staticmethod
    def greater() -> "RangedConstraintRelation":
        return RangedConstraintRelation(RangedKind.GREATER)

    @staticmethod
    def ranged(r: Fraction) -> "RangedConstraintRelation":
        if r == 0:
            return RangedConstraintRelation(RangedKind.EQUAL)
        return RangedConstraintRelation(RangedKind.RANGE, abs(Fraction(r)))

    @staticmethod
    def from_relation(rel: ConstraintRelation) -> "RangedConstraintRelation":
        return RangedConstraintRelation(RangedKind(rel.value))


class BoundDirection(enum.Enum):
    """Lower / Upper (reference: elements.rs:122-128).

    Multiplying by a sign flips the direction (elements.rs:149-158); here
    that's the :meth:`flipped` helper.
    """

    LOWER = "lower"
    UPPER = "upper"

    def flipped(self) -> "BoundDirection":
        return BoundDirection.UPPER if self is BoundDirection.LOWER else BoundDirection.LOWER

    def times_sign(self, s: int) -> "BoundDirection":
        if s == 0:
            raise ValueError("sign must be nonzero")
        return self if s > 0 else self.flipped()


class VariableType(enum.Enum):
    CONTINUOUS = "continuous"
    INTEGER = "integer"


class Objective(enum.Enum):
    """Optimization direction (reference: elements.rs:191-199)."""

    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


class LPStatus(enum.Enum):
    """Solver verdict vocabulary (reference: elements.rs LinearProgramType)."""

    FINITE_OPTIMUM = "finite_optimum"
    INFEASIBLE = "infeasible"
    UNBOUNDED = "unbounded"


# A solved LP is either a finite optimum carrying a payload, or a verdict.
LinearProgramType = LPStatus


class LinearProgramError(Exception):
    """Raised when a problem is proven infeasible/unbounded mid-pipeline.

    The reference threads these outcomes as ``Err(LinearProgramType)`` through
    presolve (general_form/mod.rs:372-374); Python uses an exception.
    """

    def __init__(self, status: LPStatus, payload: Union[None, object] = None):
        super().__init__(status.value)
        self.status = status
        self.payload = payload
