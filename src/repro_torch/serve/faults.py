"""Fault injection and typed non-label results for the serving layer
(DESIGN.md §12.4).

Production devices slow down, die, and throw transient compute errors;
the service must convert every one of those into a typed, bounded
outcome instead of a hang. This module holds

* the **typed non-label results** a request can carry instead of a 0/1
  label: ``Shed`` (admission control rejected it — queue full or
  dispatch permanently failed) and ``TimedOut`` (its deadline expired
  in-queue, or its batch exceeded the per-batch timeout with no healthy
  device left). Both are falsy and compare by (kind, reason), so caller
  code can branch on ``isinstance``/truthiness without magic ints;
* an injectable **fault plan** (``FaultPlan`` + ``FaultInjector``)
  exercised by the service's dispatch path: per-device dispatch
  failures, transient compute errors, device slowdowns (labels not
  ready until a virtual delay passes), and dead devices (labels NEVER
  ready — any accidental blocking read raises instead of hanging).

Everything is clock-injected: with a ``ManualClock`` a "slow" device is
one whose wrapped labels report ``is_ready() == False`` until virtual
time passes ``dispatch + delay`` — no wall-clock sleeps anywhere in the
tests (DESIGN.md §10.2 discipline carried to the fault model).

In this package the service's unit of dispatch is a *lane* (a device
and, on a card, a CUDA stream of its own: serve/service.py), so a
"device index" below is a lane index, and the labels the proxies wrap
are the service's pending labels (``is_ready()`` asks the lane's CUDA
event; ``np.asarray`` waits for it).
"""
from __future__ import annotations

from dataclasses import dataclass, field


# ------------------------------------------------- typed non-label results --
@dataclass(frozen=True)
class Shed:
    """Admission control rejected the request (queue full, or dispatch
    exhausted every healthy device). The request was NOT evaluated."""
    reason: str = "queue-full"

    def __bool__(self) -> bool:
        return False


@dataclass(frozen=True)
class TimedOut:
    """The request's deadline expired (in-queue) or its batch exceeded
    the per-batch timeout with retries exhausted. NOT evaluated."""
    reason: str = "deadline"

    def __bool__(self) -> bool:
        return False


def is_label(result) -> bool:
    """True when ``result`` is an actual 0/1 cascade label (goodput),
    False for None/Shed/TimedOut."""
    return result is not None and not isinstance(result, (Shed, TimedOut))


# ----------------------------------------------------------- fault errors --
class DeviceError(RuntimeError):
    """A device failed at dispatch (injected: ``FaultPlan.fail_dispatch``
    / ``dead_devices``). The service re-routes to a healthy device."""


class TransientComputeError(RuntimeError):
    """A one-off compute error (injected: ``FaultPlan.transient_errors``).
    Retrying — same device or another — succeeds once the budget drains."""


# ------------------------------------------------------------ label proxies --
class _SlowLabels:
    """Device-slowdown proxy: wraps a real label array but reports
    not-ready until virtual ``ready_at``; forcing it early is allowed
    (the values are exact — slowness changes WHEN, never WHAT)."""

    def __init__(self, labels, ready_at: float, clock):
        self._labels = labels
        self._ready_at = ready_at
        self._clock = clock

    def is_ready(self) -> bool:
        if self._clock() < self._ready_at:
            return False
        return not hasattr(self._labels, "is_ready") \
            or self._labels.is_ready()

    def __array__(self, dtype=None, copy=None):
        import numpy as np
        a = np.asarray(self._labels)
        return a if dtype is None else a.astype(dtype)


class NeverReadyLabels:
    """Dead-device proxy: ``is_ready()`` is False forever and any
    blocking read RAISES — a hang converted into a loud failure. The
    per-batch timeout path must fire before anyone forces this."""

    def is_ready(self) -> bool:
        return False

    def __array__(self, dtype=None, copy=None):
        raise DeviceError("dead device: labels will never be ready")


# -------------------------------------------------------------- fault plan --
@dataclass
class FaultPlan:
    """Declarative fault schedule, keyed by device INDEX (the service's
    unique-device ordering). All counters are consumed as faults fire,
    so a plan naturally describes transient outages.

    * ``slow_devices``  — device -> extra virtual seconds before a
      dispatched batch's labels become ready;
    * ``fail_dispatch`` — device -> how many dispatches raise
      ``DeviceError`` (``-1`` = permanently failing);
    * ``dead_devices``  — devices whose dispatches "succeed" but whose
      labels are never ready (silent stall: only the per-batch timeout
      can detect it);
    * ``transient_errors`` — first N dispatches ANYWHERE raise
      ``TransientComputeError`` (retry succeeds once drained)."""
    slow_devices: dict = field(default_factory=dict)
    fail_dispatch: dict = field(default_factory=dict)
    dead_devices: set = field(default_factory=set)
    transient_errors: int = 0


class FaultInjector:
    """Stateful executor of a FaultPlan, called from the service's
    dispatch path. Counts every injected fault for test assertions."""

    def __init__(self, plan: FaultPlan, clock=None):
        import time
        self.plan = plan
        self.clock = clock or time.perf_counter
        self.injected = {"dispatch_failures": 0, "transient_errors": 0,
                         "slowdowns": 0, "dead_batches": 0}

    def on_dispatch(self, device_index: int) -> None:
        """Raise the fault (if any) this dispatch is scheduled to hit."""
        if self.plan.transient_errors > 0:
            self.plan.transient_errors -= 1
            self.injected["transient_errors"] += 1
            raise TransientComputeError(
                f"injected transient error (device {device_index})")
        left = self.plan.fail_dispatch.get(device_index, 0)
        if left:
            if left > 0:
                self.plan.fail_dispatch[device_index] = left - 1
            self.injected["dispatch_failures"] += 1
            raise DeviceError(
                f"injected dispatch failure (device {device_index})")

    def wrap_labels(self, labels, device_index: int):
        """Apply post-dispatch faults: dead devices never deliver, slow
        devices deliver late (values exact)."""
        if device_index in self.plan.dead_devices:
            self.injected["dead_batches"] += 1
            return NeverReadyLabels()
        delay = self.plan.slow_devices.get(device_index)
        if delay:
            self.injected["slowdowns"] += 1
            return _SlowLabels(labels, self.clock() + float(delay), self.clock)
        return labels
