"""Deterministic fault injection for the resilience layer.

Counterpart of ``repro.core.faults``: a registry of **named failure
points** placed at the real call sites the recovery paths protect
(``FAULT_POINTS``).  A test arms a point with ``fault_injection(...)`` and
a deterministic trigger schedule (fail on the Nth hit, a bounded number of
times), then drives the normal API: the site consults the registry, the
fault fires where a real failure would, and the recovery path runs end to
end.

All four of the reference's points have their sites: the planned lane's
capacity retry (``capacity_undersize``), B's placement retry
(``gather_fail``), the streamed lane's tile staging (``stage_tile_fail``)
and the serving layer's replay of a failed micro-batch
(``dispatch_fail``).

Disarmed points cost one dict lookup per consult and never fire.

Usage::

    with faults.fault_injection("dispatch_fail") as fault:
        svc.flush()                  # the batched dispatch fails once
    assert fault.triggers == 1       # ...and every member was replayed

Sites call ``fire(name)`` (raise ``FaultInjected``) or ``trigger(name)``
(returns True; the site perturbs its own state).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional


class FaultInjected(RuntimeError):
    """The error an armed raise-style fault point throws at its site."""


#: Every failure point a site consults, with where it lives.  Arming an
#: unknown name is a ``ValueError``: a typo'd chaos test must fail loudly.
FAULT_POINTS: Dict[str, str] = {
    "capacity_undersize": (
        "planned sizing: shrink one chunk's out_cap below its true "
        "uniqueCounts (executor._run_planned) so the overflow flag and the "
        "measured-capacity retry run"),
    "gather_fail": (
        "B-operand placement: fail building B's ELL once "
        "(executor.execute_plan); recovery re-issues it"),
    "stage_tile_fail": (
        "streamed lane: fail one tile's host-to-device staging "
        "(executor.execute_plan_streamed); recovery re-stages the tile"),
    "dispatch_fail": (
        "serving layer: fail a dispatch (SpGEMMService._dispatch_key); "
        "recovery replays the micro-batch members individually and "
        "quarantines a member that fails alone"),
}


@dataclasses.dataclass
class FaultHandle:
    """One armed fault point with its deterministic trigger schedule.

    ``on_hit`` is the 1-based hit index of the first trigger; ``times``
    bounds how many consecutive hits from there trigger (``None`` = every
    hit from ``on_hit`` on).  ``hits``/``triggers`` are live counters.
    """

    name: str
    on_hit: int = 1
    times: Optional[int] = 1
    hits: int = 0
    triggers: int = 0

    def consult(self) -> bool:
        """Record one site hit; True when this hit should fail."""
        self.hits += 1
        if self.hits < self.on_hit:
            return False
        if self.times is not None and self.triggers >= self.times:
            return False
        self.triggers += 1
        return True


_ARMED: Dict[str, FaultHandle] = {}


def _validate(name: str) -> None:
    if name not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {name!r}; registered points: "
            f"{', '.join(sorted(FAULT_POINTS))}")


def armed(name: str) -> bool:
    """True when ``name`` is currently armed (schedule aside)."""
    _validate(name)
    return name in _ARMED


def trigger(name: str) -> bool:
    """Consult a perturbation-style site: True when the armed schedule
    says this hit fails."""
    _validate(name)
    handle = _ARMED.get(name)
    return handle.consult() if handle is not None else False


def fire(name: str) -> None:
    """Consult a raise-style site: throws ``FaultInjected`` on a scheduled
    hit, returns silently otherwise."""
    if trigger(name):
        raise FaultInjected(
            f"injected fault at {name!r} (hit {_ARMED[name].hits})")


@contextlib.contextmanager
def fault_injection(name: str, *, on_hit: int = 1,
                    times: Optional[int] = 1) -> Iterator[FaultHandle]:
    """Arm fault point ``name`` for the duration of the ``with`` block.

    ``on_hit`` (1-based) delays the first trigger to the Nth site hit;
    ``times`` bounds the number of triggers (default 1; ``None`` = fail
    every hit).  Yields the live ``FaultHandle``.  Points disarm on exit
    however the block ends; nesting the same point is an error.
    """
    _validate(name)
    if isinstance(on_hit, bool) or not isinstance(on_hit, int) or on_hit < 1:
        raise ValueError(f"on_hit must be an int >= 1; got {on_hit!r}")
    if times is not None and (isinstance(times, bool)
                              or not isinstance(times, int) or times < 1):
        raise ValueError(f"times must be None or an int >= 1; got {times!r}")
    if name in _ARMED:
        raise RuntimeError(f"fault point {name!r} is already armed")
    handle = FaultHandle(name=name, on_hit=on_hit, times=times)
    _ARMED[name] = handle
    try:
        yield handle
    finally:
        del _ARMED[name]
