"""Bounded arrival buffer with counted backpressure; the reference's
``repro/serve/queue.py`` (pure Python), unchanged.

The server's admission queue: uploads are ``offer``-ed as they arrive and
``take``-n in FIFO order by the fused ingest step.  When the buffer is at
capacity the offer fails *loudly* — the caller is told, and one of the
backpressure counters is bumped — so the accounting invariant

    received == accepted + rejected + deferred
    accepted == taken + depth

holds at every instant (tests/test_torch_ingest.py enforces it).  Two
backpressure policies, chosen at construction:

* ``"reject"`` — the upload is refused for good; the client must
  recompress against a fresher model (its round counter moved on).
* ``"defer"``  — the upload is pushed back to the client for retry;
  the payload is unchanged, only its staleness grows.

The distinction is bookkeeping, not mechanics — both return ``False``
from ``offer`` — but they age differently (a deferred payload re-arrives
with a larger ``delta_tau``), so telemetry counts them separately.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional

__all__ = ["ArrivalBuffer"]

_POLICIES = ("reject", "defer")


class ArrivalBuffer:
    """FIFO queue of wire payloads with a hard capacity."""

    def __init__(self, capacity: int, policy: str = "reject"):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        self.capacity = int(capacity)
        self.policy = policy
        self._q: deque = deque()
        self.received = 0
        self.accepted = 0
        self.rejected = 0
        self.deferred = 0
        self.taken = 0
        self.peak = 0

    # -- producer side -------------------------------------------------------

    def offer(self, item) -> bool:
        """Admit one upload; ``False`` (+ a counter) when full."""
        self.received += 1
        if len(self._q) >= self.capacity:
            if self.policy == "reject":
                self.rejected += 1
            else:
                self.deferred += 1
            return False
        self._q.append(item)
        self.accepted += 1
        self.peak = max(self.peak, len(self._q))
        return True

    def offer_all(self, items: Iterable) -> int:
        """Offer each item; returns how many were admitted."""
        return sum(1 for it in items if self.offer(it))

    # -- consumer side -------------------------------------------------------

    def take(self, k: Optional[int] = None) -> List:
        """Pop up to ``k`` items FIFO (all queued items if ``k`` is None)."""
        n = len(self._q) if k is None else min(int(k), len(self._q))
        out = [self._q.popleft() for _ in range(n)]
        self.taken += n
        return out

    # -- accounting ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def counters(self) -> dict:
        return {"received": self.received, "accepted": self.accepted,
                "rejected": self.rejected, "deferred": self.deferred,
                "taken": self.taken, "depth": self.depth, "peak": self.peak}

    def check_invariant(self) -> None:
        """Raise if any upload went unaccounted for."""
        if self.received != self.accepted + self.rejected + self.deferred:
            raise AssertionError(
                f"arrival accounting broken: received={self.received} != "
                f"accepted={self.accepted} + rejected={self.rejected} + "
                f"deferred={self.deferred}")
        if self.accepted != self.taken + self.depth:
            raise AssertionError(
                f"queue accounting broken: accepted={self.accepted} != "
                f"taken={self.taken} + depth={self.depth}")
