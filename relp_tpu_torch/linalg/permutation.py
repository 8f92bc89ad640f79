"""Permutation utilities.

Mirror of reference ``carry/lower_upper/permutation``: a small family of
permutation representations with forward/backward application — ``Full``
(explicit forward+backward arrays, O(1) invert), ``RotateToBack`` and
``Swap`` (the reference composes these in its Forrest-Tomlin update lists).

In this framework the device LU backend keeps its pivot permutation as the
``piv`` array from ``lu_factor``; these host-side utilities serve factor
bookkeeping and tests, and convert to/from that representation.
"""

from __future__ import annotations

from typing import List, Sequence


class Permutation:
    """Forward/backward index mapping."""

    def forward(self, i: int) -> int:
        raise NotImplementedError

    def backward(self, i: int) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def apply(self, values: Sequence) -> List:
        """new[forward(i)] = old[i]."""
        out = [None] * len(values)
        for i, v in enumerate(values):
            out[self.forward(i)] = v
        return out

    def apply_inverse(self, values: Sequence) -> List:
        out = [None] * len(values)
        for i, v in enumerate(values):
            out[self.backward(i)] = v
        return out


class FullPermutation(Permutation):
    """Explicit forward and backward arrays (reference: full.rs)."""

    def __init__(self, forward: Sequence[int]):
        self._forward = list(forward)
        assert sorted(self._forward) == list(range(len(self._forward)))
        self._backward = [0] * len(self._forward)
        for i, f in enumerate(self._forward):
            self._backward[f] = i

    def forward(self, i: int) -> int:
        return self._forward[i]

    def backward(self, i: int) -> int:
        return self._backward[i]

    def __len__(self) -> int:
        return len(self._forward)

    def invert(self) -> "FullPermutation":
        """O(1)-ish swap of the two arrays (reference: full.rs invert)."""
        inverted = FullPermutation.__new__(FullPermutation)
        inverted._forward = self._backward
        inverted._backward = self._forward
        return inverted

    @staticmethod
    def from_lapack_piv(piv: Sequence[int]) -> "FullPermutation":
        """Convert a LAPACK-style sequential-swap pivot array (as returned by
        ``lu_factor``) into an explicit permutation."""
        order = list(range(len(piv)))
        for i, p in enumerate(piv):
            order[i], order[p] = order[p], order[i]
        # order[k] = source row that ends in position k; forward maps
        # source -> destination.
        forward = [0] * len(order)
        for dest, src in enumerate(order):
            forward[src] = dest
        return FullPermutation(forward)


class RotateToBackPermutation(Permutation):
    """Indices [start, end) rotate left by one; ``start`` goes to the back
    (reference: rotate_to_back.rs — used after deleting a spike row)."""

    def __init__(self, start: int, length: int):
        assert 0 <= start < length
        self.start = start
        self.length = length

    def forward(self, i: int) -> int:
        if i < self.start or i >= self.length:
            return i
        if i == self.start:
            return self.length - 1
        return i - 1

    def backward(self, i: int) -> int:
        if i < self.start or i >= self.length:
            return i
        if i == self.length - 1:
            return self.start
        return i + 1

    def __len__(self) -> int:
        return self.length


class SwapPermutation(Permutation):
    """Transposition of two indices (reference: swap.rs)."""

    def __init__(self, a: int, b: int, length: int):
        self.a, self.b, self.length = a, b, length

    def forward(self, i: int) -> int:
        if i == self.a:
            return self.b
        if i == self.b:
            return self.a
        return i

    backward = forward

    def __len__(self) -> int:
        return self.length


class IdentityPermutation(Permutation):
    """No-op (reference: identity.rs)."""

    def __init__(self, length: int):
        self.length = length

    def forward(self, i: int) -> int:
        return i

    backward = forward

    def __len__(self) -> int:
        return self.length
