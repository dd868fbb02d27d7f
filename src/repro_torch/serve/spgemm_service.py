"""Multi-tenant SpGEMM serving: a pattern-coalescing micro-batcher.

Counterpart of ``repro.serve.spgemm_service``, with the same semantics, on
the device the requests' operands live on:

* ``submit(tenant_id, a, b, **knobs)`` fingerprints both operand patterns
  (``executor.pattern_fingerprint``, the ``PlanCache`` key) and enqueues
  the request under ``(fingerprint_a, fingerprint_b, knob signature)``.
  Same-pattern traffic from any tenant lands in the same micro-batch.
* A micro-batch dispatches through ``spgemm_batched`` the moment it
  reaches ``max_batch``, or when its oldest request has waited
  ``max_wait`` seconds (checked on every ``submit``/``poll``).  A
  singleton group runs plain ``spgemm``.  Results equal a per-request loop
  (bit for bit on the CPU).
* The queue is bounded (``max_queue``): a submit beyond it is shed with
  ``QueueFull`` and counted in ``stats()["requests_shed"]``.
* Every tenant gets its own quota'd ``PlanCache`` / ``OperandCache`` /
  ``AutotuneCache``; a coalesced batch runs on the lead tenant's caches
  and every other tenant in it accounts the plan against its own quota
  (``PlanCache.plan_for(supplier=)``).
* A failed batched dispatch replays each member alone (the
  ``dispatch_fail`` fault point exercises it); a member that fails alone
  is quarantined with its own error.
* ``stats()`` is the metrics surface: p50/p99 latency, queue depth,
  coalescing ratio, shed counts and per-tenant cache hit rates.

The service is synchronous and single-threaded: dispatch happens inside
``submit``/``poll``/``flush`` on the caller's thread, and the clock and
sleep are injectable, so latency accounting is deterministic under a fake
clock.  Knob names are validated at submit time; ``gather="auto"``
resolves against the operands' device at dispatch.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core import faults
from repro_torch.core.executor import (
    AutotuneCache, OperandCache, PlanCache, check_gather,
    pattern_fingerprint, resolve_engine, resolve_operands)
from repro_torch.launch.sharding import shard_devices
from repro_torch.core.spgemm import SpGEMMResult, spgemm, spgemm_batched
from repro_torch.sparse.formats import CSR


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is at capacity.

    The request is *shed*, not queued: the caller decides whether to
    retry, back off, or drop — or pass ``submit(..., retries=, backoff=)``
    to have the service retry with exponential backoff before shedding.
    Shed counts surface in ``SpGEMMService.stats()`` (globally and per
    tenant).
    """


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline=`` elapsed before its micro-batch dispatched.

    Raised by ``Ticket.result()`` (the request is expired at dispatch
    time, never executed) and counted in
    ``SpGEMMService.stats()['deadline_exceeded']`` — a late answer to a
    caller that stopped waiting is work the service refuses to do.
    """


# Base backoff (seconds) for submit's shed-retry loop; attempt *k* sleeps
# ``backoff * 2**k`` through the injectable ``sleep`` hook.
DEFAULT_BACKOFF = 0.05


def resolve_deadline(deadline) -> Optional[float]:
    """Validate a request's ``deadline=`` (seconds; ``None`` = no deadline).

    The deadline is relative to submit time and enforced at dispatch: a
    request whose deadline elapsed while queued is expired with
    ``DeadlineExceeded`` instead of executed.
    """
    if deadline is None:
        return None
    if isinstance(deadline, bool) or not isinstance(
            deadline, (int, float, np.integer, np.floating)):
        raise ValueError(
            f"deadline must be a positive number of seconds or None; "
            f"got {deadline!r}")
    if float(deadline) <= 0:
        raise ValueError(f"deadline must be > 0 seconds; got {deadline!r}")
    return float(deadline)


def resolve_retries(retries) -> int:
    """Validate ``submit``'s ``retries=`` (shed-retry attempts; default 0).

    ``0`` (the default) preserves the shed-loudly contract: a full queue
    raises ``QueueFull`` immediately.  ``k > 0`` lets submit back off and
    re-poll up to ``k`` times before shedding.
    """
    if retries is None:
        return 0
    if isinstance(retries, bool) or not isinstance(retries, (int, np.integer)):
        raise ValueError(f"retries must be an int >= 0; got {retries!r}")
    if int(retries) < 0:
        raise ValueError(f"retries must be >= 0; got {int(retries)}")
    return int(retries)


def resolve_backoff(backoff) -> float:
    """Validate ``submit``'s ``backoff=`` (base seconds; ``None`` = the
    ``DEFAULT_BACKOFF``).  Retry attempt *k* sleeps ``backoff * 2**k``."""
    if backoff is None:
        return DEFAULT_BACKOFF
    if isinstance(backoff, bool) or not isinstance(
            backoff, (int, float, np.integer, np.floating)):
        raise ValueError(
            f"backoff must be a positive number of seconds; got {backoff!r}")
    if float(backoff) <= 0:
        raise ValueError(f"backoff must be > 0 seconds; got {backoff!r}")
    return float(backoff)


@dataclasses.dataclass(frozen=True)
class ServeKnobs:
    """The executor knobs a request is dispatched with.

    Requests coalesce only when their knob signatures match exactly — a
    tenant asking for ``engine="hash"`` never rides a ``"sort"`` batch.
    Every field is validated eagerly at ``submit`` time through the
    executor's hooks, so a typo (or a ``mesh`` that is not a sequence of
    devices) fails the submitting caller immediately instead of poisoning
    a whole micro-batch at dispatch.
    ``gather`` is checked by name here and resolved against the operands'
    device at dispatch.  ``mesh`` participates in the signature by
    identity.
    """

    engine: str = "sort"
    gather: str = "auto"
    schedule: str = "grouped"
    row_chunk: int = 4096
    pipeline: str = "two_wave"
    sizing: str = "auto"
    operands: str = "auto"
    mesh: object = None

    def validate(self) -> "ServeKnobs":
        """Fail fast on any invalid knob value (returns self)."""
        resolve_engine(self.engine)
        check_gather(self.gather)
        resolve_operands(self.operands)
        shard_devices(self.mesh)
        if self.schedule not in ("grouped", "natural"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.pipeline not in ("two_wave", "legacy"):
            raise ValueError(f"unknown pipeline {self.pipeline!r}")
        if self.sizing not in ("auto", "planned", "measured"):
            raise ValueError(f"unknown sizing {self.sizing!r}")
        return self

    def signature(self) -> tuple:
        """Hashable coalescing key component (mesh by identity)."""
        return (self.engine, self.gather, self.schedule, int(self.row_chunk),
                self.pipeline, self.sizing, self.operands,
                None if self.mesh is None else id(self.mesh))

    def call_kwargs(self) -> dict:
        """The kwargs forwarded to ``spgemm``/``spgemm_batched``."""
        return dict(engine=self.engine, gather=self.gather,
                    schedule=self.schedule, row_chunk=self.row_chunk,
                    pipeline=self.pipeline, sizing=self.sizing,
                    operands=self.operands, mesh=self.mesh)


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted request.

    ``result()`` returns the request's ``SpGEMMResult``; if the request is
    still queued it forces its micro-batch to dispatch first (a caller
    blocking on a result should not wait out ``max_wait``).  ``done`` is
    True once the batch containing this request has executed;
    ``coalesced_with`` is the number of requests that shared its dispatch
    (1 = singleton fallback).  A request that failed — its ``deadline=``
    elapsed while queued, or it was quarantined as the poison member of a
    failed micro-batch — re-raises its recorded error from ``result()``.
    """

    tenant_id: str
    submitted_at: float
    done: bool = False
    coalesced_with: int = 0
    latency_s: float = -1.0
    deadline_at: Optional[float] = None
    _result: Optional[SpGEMMResult] = None
    _error: Optional[Exception] = None
    _service: Optional["SpGEMMService"] = None
    _group_key: Optional[tuple] = None

    def result(self) -> SpGEMMResult:
        """The request's product, dispatching its micro-batch if needed.

        Raises ``DeadlineExceeded`` if the request expired while queued,
        or the quarantined request's own error if it was the member that
        failed an isolated replay.
        """
        if not self.done:
            self._service._dispatch_key(self._group_key)
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _QueuedRequest:
    tenant_id: str
    a: CSR
    b: CSR
    ticket: Ticket
    submitted_at: float
    deadline_at: Optional[float] = None


@dataclasses.dataclass
class _PendingGroup:
    """One open micro-batch: same (pattern-pair, knob signature)."""

    knobs: ServeKnobs
    requests: List[_QueuedRequest] = dataclasses.field(default_factory=list)

    @property
    def oldest(self) -> float:
        return self.requests[0].submitted_at


class _TenantState:
    """Per-tenant cache scope + accounting.

    Each tenant owns quota'd ``PlanCache``/``OperandCache``/
    ``AutotuneCache`` instances — the LRU bound is *per tenant*, so a
    noisy tenant cycling through many patterns evicts only its own
    entries.
    """

    def __init__(self, plan_quota: int, operand_quota: int,
                 autotune_quota: int):
        self.plans = PlanCache(max_entries=plan_quota)
        self.operands = OperandCache(max_entries=operand_quota)
        self.autotune = AutotuneCache(max_entries=autotune_quota)
        self.submitted = 0
        self.completed = 0
        self.shed = 0

    def stats(self) -> Dict[str, object]:
        """Per-tenant metrics: traffic counts + cache occupancy/hit rates."""
        plan = self.plans.stats()
        lookups = plan["hits"] + plan["misses"]
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "plan_entries": plan["entries"],
            "plan_hits": plan["hits"],
            "plan_misses": plan["misses"],
            "plan_hit_rate": plan["hits"] / lookups if lookups else 0.0,
            "operand_entries": len(self.operands),
            "autotune_entries": len(self.autotune),
        }


class SpGEMMService:
    """Multi-tenant SpGEMM serving engine (pattern-coalescing micro-batcher).

    Parameters
    ----------
    max_batch:
        Micro-batch size that triggers an immediate dispatch of a group.
    max_wait:
        Seconds the oldest request of a group may wait before the group is
        flushed (enforced on every ``submit``/``poll``; there is no
        background thread — an idle service flushes on the next call, or
        via an explicit ``flush()``).
    max_queue:
        Bound on the total number of queued (undispatched) requests;
        submits beyond it raise ``QueueFull`` and count as shed.
    tenant_plan_quota / tenant_operand_quota / tenant_autotune_quota:
        Per-tenant LRU bounds of the scoped caches.
    clock:
        Injectable time source (seconds, monotonic); tests drive a fake
        clock, production uses ``time.monotonic``.
    sleep:
        Injectable sleep used by submit's shed-retry backoff; tests pass
        a fake that advances the fake clock, production uses
        ``time.sleep``.
    latency_window:
        How many recent request latencies the p50/p99 estimate keeps.
    """

    def __init__(self, max_batch: int = 16, max_wait: float = 0.01,
                 max_queue: int = 1024, tenant_plan_quota: int = 32,
                 tenant_operand_quota: int = 8,
                 tenant_autotune_quota: int = 16,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 latency_window: int = 4096):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_batch = max_batch
        self.max_wait = float(max_wait)
        self.max_queue = max_queue
        self._quotas = (tenant_plan_quota, tenant_operand_quota,
                        tenant_autotune_quota)
        self._clock = clock
        self._sleep = sleep
        self._groups: "OrderedDict[tuple, _PendingGroup]" = OrderedDict()
        self._tenants: Dict[str, _TenantState] = {}
        self._latencies: Deque[float] = deque(maxlen=latency_window)
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._dispatches = 0
        self._batched_dispatches = 0
        self._singleton_dispatches = 0
        self._coalesced_requests = 0
        self._deadline_exceeded = 0
        self._retries = 0
        self._quarantined = 0

    # ------------------------------------------------------------------
    # Request path
    # ------------------------------------------------------------------

    def submit(self, tenant_id: str, a: CSR, b: CSR, *,
               deadline: Optional[float] = None, retries: int = 0,
               backoff: Optional[float] = None, **knobs) -> Ticket:
        """Enqueue one ``a @ b`` request for ``tenant_id``.

        Knobs (``engine=``, ``gather=``, ``sizing=``, ... — see
        ``ServeKnobs``) are validated immediately; the request coalesces
        with queued requests whose operands share both sparsity patterns
        *and* whose knob signature matches.  Returns a ``Ticket``; raises
        ``QueueFull`` (and counts the request as shed) when the bounded
        queue is at capacity.  Overdue groups are flushed on the way in,
        so a steadily-submitting caller honors ``max_wait`` without a
        background thread.

        ``deadline`` (seconds from now, ``None`` = unbounded) expires the
        request if it is still queued when its micro-batch dispatches:
        ``result()`` then raises ``DeadlineExceeded`` instead of returning
        a stale answer.  ``retries``/``backoff`` soften the ``QueueFull``
        edge: a submit finding the queue full sleeps ``backoff * 2**k``
        (injectable ``sleep``) and re-polls, up to ``retries`` times,
        before shedding — each attempt counted in ``stats()['retries']``.
        """
        deadline_s = resolve_deadline(deadline)
        n_retries = resolve_retries(retries)
        backoff_s = resolve_backoff(backoff)
        kn = ServeKnobs(**knobs).validate()
        now = self._clock()
        self.poll(now)
        tenant = self._tenant(tenant_id)
        attempt = 0
        while self.queue_depth() >= self.max_queue:
            if attempt >= n_retries:
                self._shed += 1
                tenant.shed += 1
                raise QueueFull(
                    f"serving queue at capacity ({self.max_queue} queued "
                    f"requests); request from tenant {tenant_id!r} shed"
                    + (f" after {attempt} retries" if attempt else ""))
            # bounded retry-with-backoff: overdue groups may drain on the
            # re-poll, turning a would-be shed into a served request
            self._retries += 1
            self._sleep(backoff_s * (2 ** attempt))
            attempt += 1
            now = self._clock()
            self.poll(now)
        self._submitted += 1
        tenant.submitted += 1
        key = (pattern_fingerprint(a), pattern_fingerprint(b),
               kn.signature())
        deadline_at = None if deadline_s is None else now + deadline_s
        ticket = Ticket(tenant_id=tenant_id, submitted_at=now,
                        deadline_at=deadline_at, _service=self,
                        _group_key=key)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _PendingGroup(knobs=kn)
        group.requests.append(
            _QueuedRequest(tenant_id, a, b, ticket, now,
                           deadline_at=deadline_at))
        if len(group.requests) >= self.max_batch:
            self._dispatch_key(key)
        return ticket

    def poll(self, now: Optional[float] = None) -> int:
        """Dispatch every group whose oldest request exceeded ``max_wait``.

        Returns the number of dispatches performed.  Call this from an
        idle loop (or rely on ``submit``, which polls on entry).
        """
        now = self._clock() if now is None else now
        due = [k for k, g in self._groups.items()
               if now - g.oldest >= self.max_wait]
        for key in due:
            self._dispatch_key(key)
        return len(due)

    def flush(self) -> int:
        """Dispatch every queued group regardless of age/size; returns the
        number of dispatches."""
        keys = list(self._groups)
        for key in keys:
            self._dispatch_key(key)
        return len(keys)

    def queue_depth(self) -> int:
        """Total queued (undispatched) requests across all groups."""
        return sum(len(g.requests) for g in self._groups.values())

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------

    def _tenant(self, tenant_id: str) -> _TenantState:
        st = self._tenants.get(tenant_id)
        if st is None:
            st = self._tenants[tenant_id] = _TenantState(*self._quotas)
        return st

    def _run_isolated(self, req: _QueuedRequest, plan, lead: _TenantState,
                      kwargs: dict):
        """Execute one request alone; an Exception return means quarantine.

        The batch-isolation replay path: when a coalesced dispatch fails,
        each member re-runs individually through this, so the poison
        request collects its own error and every innocent member still
        completes.
        """
        try:
            faults.fire("dispatch_fail")
            return spgemm(req.a, req.b, plan=plan, autotune=lead.autotune,
                          operand_cache=lead.operands, **kwargs)
        except Exception as e:  # noqa: BLE001 — any member failure isolates
            return e

    def _dispatch_key(self, key: tuple) -> None:
        group = self._groups.pop(key, None)
        if group is None:
            return  # already dispatched (e.g. result() raced a poll)
        now = self._clock()
        reqs = []
        for r in group.requests:
            if r.deadline_at is not None and now > r.deadline_at:
                # expired while queued: refuse the work, surface the error
                t = r.ticket
                t._error = DeadlineExceeded(
                    f"request from tenant {r.tenant_id!r} queued "
                    f"{now - r.submitted_at:.3f}s, past its "
                    f"{r.deadline_at - r.submitted_at:.3f}s deadline")
                t.done = True
                t.latency_s = now - r.submitted_at
                self._deadline_exceeded += 1
            else:
                reqs.append(r)
        if not reqs:
            return
        lead = self._tenant(reqs[0].tenant_id)
        # Plan once through the lead tenant's cache; every other tenant in
        # the batch accounts the same plan against its own quota without
        # re-planning (PlanCache.plan_for(supplier=...) — the executor's
        # multi-tenant scoping hook).
        a0, b0 = reqs[0].a, reqs[0].b
        plan = lead.plans.plan_for(a0, b0)
        for tid in dict.fromkeys(r.tenant_id for r in reqs):
            if tid != reqs[0].tenant_id:
                self._tenant(tid).plans.plan_for(a0, b0,
                                                 supplier=lambda: plan)
        kwargs = group.knobs.call_kwargs()
        self._dispatches += 1
        if len(reqs) == 1:
            # Singleton-pattern fallback: no batch to amortize, skip the
            # vmapped value planes entirely.
            self._singleton_dispatches += 1
            results = [self._run_isolated(reqs[0], plan, lead, kwargs)]
        else:
            self._batched_dispatches += 1
            self._coalesced_requests += len(reqs)
            try:
                faults.fire("dispatch_fail")
                batch = spgemm_batched(
                    [r.a for r in reqs], [r.b for r in reqs], plan=plan,
                    autotune=lead.autotune, operand_cache=lead.operands,
                    **kwargs)
                results = [
                    SpGEMMResult(c=c, plan=batch.plan,
                                 info={**batch.info, "batch": len(reqs)})
                    for c in batch.cs
                ]
            except Exception:  # noqa: BLE001 — isolate, don't fail the batch
                # Batch-failure isolation: one poison member must never
                # fail a whole micro-batch.  Replay every member alone;
                # innocents complete (bit-exact — the per-request loop is
                # the batched lane's reference), the poison request is
                # quarantined with its own error.
                results = [self._run_isolated(r, plan, lead, kwargs)
                           for r in reqs]
        now = self._clock()
        for req, res in zip(reqs, results):
            t = req.ticket
            t.done = True
            t.coalesced_with = len(reqs)
            t.latency_s = now - req.submitted_at
            if isinstance(res, Exception):
                t._error = res
                self._quarantined += 1
                continue
            t._result = res
            self._latencies.append(t.latency_s)
            self._completed += 1
            self._tenant(req.tenant_id).completed += 1

    # ------------------------------------------------------------------
    # Metrics
    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The service metrics surface, one flat dict plus a per-tenant map.

        * ``requests_submitted`` / ``requests_completed`` /
          ``requests_shed`` — lifetime traffic counters (shed = rejected
          by the ``max_queue`` bound, never executed).
        * ``queue_depth`` / ``queued_groups`` — current undispatched
          requests and the open micro-batches holding them.
        * ``dispatches`` / ``batched_dispatches`` /
          ``singleton_dispatches`` — executor calls made, split by lane.
        * ``coalescing_ratio`` — completed requests per dispatch (1.0 =
          no coalescing; ``max_batch`` = perfect).
        * ``coalesced_fraction`` — fraction of completed requests that
          rode a multi-request batch.
        * ``latency_p50_ms`` / ``latency_p99_ms`` — percentiles over the
          trailing ``latency_window`` completed requests (queue wait +
          dispatch, by the service clock).
        * ``deadline_exceeded`` — requests whose ``deadline=`` elapsed
          while queued (expired at dispatch, never executed).
        * ``retries`` — shed-retry backoff attempts submit made before
          queueing or shedding (``submit(..., retries=)``).
        * ``quarantined`` — requests that failed an isolated replay after
          a micro-batch dispatch failure and carry their own error.
        * ``tenants`` — ``{tenant_id: per-tenant stats}`` with traffic
          counts, plan hit rates, and cache occupancies (see
          ``_TenantState.stats``).
        """
        lat = np.asarray(self._latencies, np.float64)
        p50, p99 = (float(np.percentile(lat, 50)) * 1e3,
                    float(np.percentile(lat, 99)) * 1e3) if lat.size else \
            (0.0, 0.0)
        return {
            "requests_submitted": self._submitted,
            "requests_completed": self._completed,
            "requests_shed": self._shed,
            "queue_depth": self.queue_depth(),
            "queued_groups": len(self._groups),
            "dispatches": self._dispatches,
            "batched_dispatches": self._batched_dispatches,
            "singleton_dispatches": self._singleton_dispatches,
            "coalescing_ratio": (self._completed / self._dispatches
                                 if self._dispatches else 0.0),
            "coalesced_fraction": (self._coalesced_requests / self._completed
                                   if self._completed else 0.0),
            "latency_p50_ms": p50,
            "latency_p99_ms": p99,
            "deadline_exceeded": self._deadline_exceeded,
            "retries": self._retries,
            "quarantined": self._quarantined,
            "tenants": {tid: st.stats()
                        for tid, st in sorted(self._tenants.items())},
        }
