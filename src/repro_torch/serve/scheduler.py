"""Deadline scheduling for the async serving subsystem (DESIGN.md §10.2).

``DeadlineWheel`` is a hashed timer wheel: deadlines land in coarse
slots of ``granularity`` seconds, ``pop_due(now)`` sweeps only the slots
at or before ``now`` and returns the keys whose exact deadline has
passed. Scheduling, cancelling, and re-scheduling are O(1) (stale slot
entries are lazily discarded on sweep — a key's live deadline is the
last one scheduled). The service keys entries by (shard, concept) queue
group: one entry per non-empty group, not per request, so the wheel
stays tiny under load.

Everything is driven by an injected ``clock`` callable — production uses
``time.perf_counter``, tests use ``ManualClock`` and advance virtual
time explicitly, so deadline semantics are tested without a single
wall-clock sleep.
"""
from __future__ import annotations


class ManualClock:
    """Injectable fake clock: ``clock()`` reads virtual time,
    ``advance`` moves it. Lets tests drive deadline-triggered flushes
    deterministically."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time cannot move backwards")
        self.t += dt
        return self.t


class DeadlineWheel:
    """Bucketed deadline index over opaque hashable keys.

    Stale entries (cancelled or superseded schedules) are normally
    discarded lazily when their slot is swept — but cancel-heavy load
    (every size-triggered serving flush cancels its group's deadline)
    can park garbage tuples in FUTURE slots that a sweep never reaches
    until their slot time passes. ``schedule``/``cancel`` therefore
    compact eagerly once the stale count exceeds
    ``max(COMPACT_MIN, COMPACT_FACTOR * live)``: the slots are rebuilt
    from the live map in O(live), so total slot storage stays bounded
    by O(live) regardless of the schedule/cancel churn rate."""

    COMPACT_MIN = 64
    COMPACT_FACTOR = 4

    def __init__(self, granularity: float = 0.001):
        if granularity <= 0:
            raise ValueError("granularity must be positive")
        self.granularity = float(granularity)
        self._slots: dict[int, list] = {}      # slot -> [(deadline, key)]
        self._live: dict = {}                  # key -> its live deadline
        self._entries = 0                      # tuples stored across slots
        self.compactions = 0

    def __len__(self) -> int:
        return len(self._live)

    @property
    def stored_entries(self) -> int:
        """Slot tuples currently held (live + stale) — the quantity the
        compaction bound caps (regression-tested)."""
        return self._entries

    def _slot(self, t: float) -> int:
        return int(t / self.granularity)

    def _maybe_compact(self) -> None:
        stale = self._entries - len(self._live)
        if stale <= max(self.COMPACT_MIN,
                        self.COMPACT_FACTOR * len(self._live)):
            return
        self._slots = {}
        for key, deadline in self._live.items():
            self._slots.setdefault(self._slot(deadline), []).append(
                (deadline, key))
        self._entries = len(self._live)
        self.compactions += 1

    def schedule(self, key, deadline: float) -> None:
        """(Re-)schedule ``key``; the newest deadline wins, any earlier
        slot entry for the key turns stale and is dropped on sweep (or
        eagerly, by compaction)."""
        deadline = float(deadline)
        self._live[key] = deadline
        self._slots.setdefault(self._slot(deadline), []).append(
            (deadline, key))
        self._entries += 1
        self._maybe_compact()

    def cancel(self, key) -> None:
        """Forget ``key`` (no-op if absent) — the size-triggered flush
        path cancels the group's deadline."""
        self._live.pop(key, None)
        self._maybe_compact()

    def pop_due(self, now: float) -> list:
        """Remove and return every key whose live deadline is <= now,
        in deadline order. Slots strictly in the future are not touched."""
        horizon = self._slot(now)
        due = []
        for slot in sorted(s for s in self._slots if s <= horizon):
            keep = []
            for deadline, key in self._slots[slot]:
                if self._live.get(key) != deadline:
                    continue                   # stale or cancelled
                if deadline <= now:
                    due.append((deadline, key))
                    del self._live[key]
                else:
                    keep.append((deadline, key))
            self._entries -= len(self._slots[slot]) - len(keep)
            if keep:
                self._slots[slot] = keep
            else:
                del self._slots[slot]
        due.sort(key=lambda dk: dk[0])
        return [key for _, key in due]

    def next_deadline(self) -> float | None:
        """Earliest live deadline (None when idle) — lets a serving loop
        sleep exactly until the next flush is due."""
        return min(self._live.values(), default=None)
