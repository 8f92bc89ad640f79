"""Presolve queues — dedup FIFOs per rule.

Mirror of reference ``presolve/queues.rs``: four queues (substitution, bound,
slack, activity) whose elements are unique while enqueued (the reference uses
the ``fifo-set`` crate).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Generic, Hashable, Iterable, Optional, Set, TypeVar

T = TypeVar("T", bound=Hashable)


class FifoSet(Generic[T]):
    """FIFO queue with set semantics: re-pushing an enqueued element is a no-op."""

    def __init__(self, items: Iterable[T] = ()):  # noqa: D107
        self._queue: Deque[T] = deque()
        self._set: Set[T] = set()
        for item in items:
            self.push(item)

    def push(self, item: T) -> None:
        if item not in self._set:
            self._set.add(item)
            self._queue.append(item)

    def pop(self) -> Optional[T]:
        if not self._queue:
            return None
        item = self._queue.popleft()
        self._set.discard(item)
        return item

    def __bool__(self) -> bool:
        return bool(self._queue)

    def __len__(self) -> int:
        return len(self._queue)


class Queues:
    """The four rule queues (reference: queues.rs:15-84)."""

    def __init__(self) -> None:
        self.substitution: FifoSet[int] = FifoSet()
        self.bound: FifoSet[int] = FifoSet()
        self.slack: FifoSet[int] = FifoSet()
        self.activity: FifoSet = FifoSet()  # holds (constraint, BoundDirection)

    def are_empty(self) -> bool:
        return not (
            self.activity or self.slack or self.bound or self.substitution
        )
