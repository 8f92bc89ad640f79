"""Exact number tower.

The reference delegates to the external ``relp-num`` crate (Rational8..128,
RationalBig, Binary, One, sign traits, prime factorization — SURVEY.md comp. 1).
Here the exact side is Python's arbitrary-precision ``int`` and
``fractions.Fraction`` (the analog of RationalBig); fixed-width rationals are
pointless in Python.  The zero-sized ``Binary``/``One`` tricks of the reference
are replaced by plain constants — on TPU, artificial costs and incidence
entries are just 0.0/1.0 entries of dense arrays.

Device-side, numbers are float32/float64; exactness is recovered by the
certification pass in :mod:`relp_tpu_torch.exact`.
"""

from fractions import Fraction

from relp_tpu_torch.numbers.rational import (
    Rational,
    parse_decimal,
    sign,
    lcm,
    common_denominator,
    fraction_to_float,
)
from relp_tpu_torch.numbers.factorize import factorize_int, factorize_fraction

__all__ = [
    "Fraction",
    "Rational",
    "parse_decimal",
    "sign",
    "lcm",
    "common_denominator",
    "fraction_to_float",
    "factorize_int",
    "factorize_fraction",
]
