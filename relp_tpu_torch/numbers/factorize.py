"""Integer / rational prime factorization.

Backs the prescaler (reference: relp-num's ``NonZeroFactorizable`` trait and
src/algorithm/two_phase/../presolve/scale/rational — the scaler factorizes
every nonzero of the problem and optimizes per-prime row/column power shifts).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict


def factorize_int(n: int) -> Dict[int, int]:
    """Prime factorization of ``abs(n)`` as {prime: power}; 0/±1 -> {}.

    Trial division by 2/3 then a 6k±1 wheel — problem data coefficients are
    small (decimal fractions), so this is plenty fast.
    """
    n = abs(n)
    if n <= 1:
        return {}
    factors: Dict[int, int] = {}
    for p in (2, 3):
        while n % p == 0:
            factors[p] = factors.get(p, 0) + 1
            n //= p
    f = 5
    while f * f <= n:
        for p in (f, f + 2):
            while n % p == 0:
                factors[p] = factors.get(p, 0) + 1
                n //= p
        f += 6
    if n > 1:
        factors[n] = factors.get(n, 0) + 1
    return factors


def factorize_fraction(value: Fraction) -> Dict[int, int]:
    """Signed-power factorization of a nonzero rational.

    Returns {prime: power} with negative powers for denominator primes
    (reference: NonZeroFactorization of relp-num).
    """
    if value == 0:
        raise ValueError("cannot factorize zero")
    factors = factorize_int(value.numerator)
    for prime, power in factorize_int(value.denominator).items():
        factors[prime] = factors.get(prime, 0) - power
    return {p: k for p, k in factors.items() if k != 0}
