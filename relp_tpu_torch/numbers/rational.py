"""Exact rational helpers.

Mirrors the *semantics* of relp-num's rational parsing used by the MPS reader
(reference: src/io/mps/number/parse.rs — decimal text becomes an exact
rational, never a float).  Python's ``Fraction`` accepts decimal and
exponent-form strings exactly, which covers everything netlib SIF files use.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Iterable

Rational = Fraction


def parse_decimal(text: str) -> Fraction:
    """Parse decimal/scientific text to an exact rational.

    ``"1.5"`` -> 3/2, ``"-2.5E-1"`` -> -1/4, ``".5"`` -> 1/2.  Raises
    ``ValueError`` on malformed input (the caller wraps it into the error
    hierarchy, reference: io/error.rs).
    """
    return Fraction(text)


def sign(value: Fraction) -> int:
    """-1, 0 or +1 (reference: relp-num Sign)."""
    if value > 0:
        return 1
    if value < 0:
        return -1
    return 0


def lcm(a: int, b: int) -> int:
    return abs(a * b) // math.gcd(a, b) if a and b else abs(a or b)


def common_denominator(values: Iterable[Fraction]) -> int:
    """Least common multiple of the denominators (>= 1)."""
    result = 1
    for v in values:
        result = lcm(result, v.denominator)
    return result or 1


def fraction_to_float(value: Fraction) -> float:
    """Round-to-nearest float64 of an exact rational."""
    return value.numerator / value.denominator
