"""Wall-clock event host for the async serving subsystem (DESIGN.md
§12.1).

``AsyncCascadeService.poll()`` only runs when a caller ticks it — a
stalled or departed client silently rots every queued deadline.
``EventHost`` closes that hole: a timer-driven loop that sleeps until
``service.next_event_time()`` (flush deadlines, batch timeouts, request
deadlines — whichever comes first) and fires ``poll()`` WITHOUT caller
cooperation. Submitting through the host wakes the timer so an
earlier-than-expected deadline re-arms immediately.

Everything time-shaped is injected, so the loop body is fully testable
with zero wall-clock sleeps: the CLOCK (``ManualClock`` in tests) feeds
the service, and the TIMER (``FakeTimer`` in tests, ``WallTimer`` — a
``threading.Event`` — in production) is where the loop parks between
events. Tests drive ``step()`` directly: advance the virtual clock,
step once, and assert what fired and how long the host ASKED to sleep;
the background thread is nothing but ``while running: wait(step())``.

Thread safety: the service is single-threaded by design; the host
serializes every service call (its own ``submit``/``drain``/``step``)
behind one lock, so callers interact with the service only through the
host while it runs. The host's thread is not the thread that built the
service, and CUDA's current device and stream are per thread: the
service enters each lane's device and stream explicitly on every
dispatch (serve/service.py), so nothing depends on which thread calls.
"""
from __future__ import annotations

import threading


class WallTimer:
    """Production timer: ``wait(timeout)`` parks on a threading.Event;
    ``wake()`` fires it early (new work arrived). Returns True when
    woken early, False on timeout — the loop doesn't care, it re-polls
    either way."""

    def __init__(self):
        self._ev = threading.Event()

    def wait(self, timeout: float | None) -> bool:
        fired = self._ev.wait(timeout)
        self._ev.clear()
        return fired

    def wake(self) -> None:
        self._ev.set()


class FakeTimer:
    """Test timer: records every wait the host asked for and never
    blocks — the test advances the ManualClock itself and calls
    ``step()`` again. ``waits`` is the host's requested sleep schedule,
    directly assertable."""

    def __init__(self):
        self.waits: list = []
        self.wakes = 0

    def wait(self, timeout: float | None) -> bool:
        self.waits.append(timeout)
        return False

    def wake(self) -> None:
        self.wakes += 1


class EventHost:
    """Timer-driven serving loop around an ``AsyncCascadeService``.

    * ``submit(concept, req)`` — thread-safe submit + timer wake;
    * ``step()`` — ONE loop iteration: poll the service, then return
      how long to sleep until the next timed event (None = idle). This
      is the unit tests drive deterministically;
    * ``start()``/``stop()`` — run ``step`` on a daemon thread parked
      on the timer between events;
    * ``wait_idle(timeout)`` — block the CALLER until the service has
      no queued or in-flight work (delivery condition for examples and
      integration tests; not a sleep — it returns the instant the host
      finishes the last delivery).
    """

    def __init__(self, service, *, timer=None, clock=None,
                 idle_interval_s: float = 0.05):
        self.service = service
        self.timer = timer if timer is not None else WallTimer()
        self.clock = clock if clock is not None else service.clock
        # in-flight batches have no timed deadline unless batch_timeout
        # is set; the idle interval bounds how long a finished batch can
        # sit undelivered with no other event to wake the loop
        self.idle_interval_s = float(idle_interval_s)
        self._lock = threading.RLock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._idle = threading.Event()
        self._idle.set()
        self.steps = 0

    # ------------------------------------------------------- client face --
    def submit(self, concept: str, req) -> None:
        with self._lock:
            self.service.submit(concept, req)
            busy = self.service.busy()
        if busy:
            self._idle.clear()
        self.timer.wake()

    def drain(self) -> None:
        with self._lock:
            self.service.drain()
        self._idle.set()

    def summary(self) -> dict:
        with self._lock:
            return self.service.summary()

    # --------------------------------------------------------- loop body --
    def step(self) -> float | None:
        """Fire everything due, then compute the sleep until the next
        timed event: ``next_event_time() - now`` (floored at 0), the
        idle interval while batches are in flight with nothing timed,
        or None when the service is fully idle."""
        with self._lock:
            self.service.poll()
            nxt = self.service.next_event_time()
            busy = self.service.busy()
            now = self.clock()
        self.steps += 1
        if not busy:
            self._idle.set()
            return None
        self._idle.clear()
        sleep = None if nxt is None else max(nxt - now, 0.0)
        if self.service._inflight and self.service.batch_timeout_s is None:
            # in-flight work with no timed deadline: re-poll at the idle
            # interval so finished batches get harvested promptly
            sleep = self.idle_interval_s if sleep is None \
                else min(sleep, self.idle_interval_s)
        return self.idle_interval_s if sleep is None else sleep

    def _run(self) -> None:
        while self._running:
            timeout = self.step()
            if not self._running:
                break
            self.timer.wait(self.idle_interval_s
                            if timeout is None else timeout)

    # ------------------------------------------------------- lifecycle ----
    def start(self) -> "EventHost":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._run,
                                        name="serve-event-host",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._running = False
        self.timer.wake()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no work is queued or in flight (event-driven —
        set by the host thread the moment the last delivery lands)."""
        return self._idle.wait(timeout)

    def __enter__(self) -> "EventHost":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
