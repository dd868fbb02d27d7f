"""The port's ``SpGEMMService``, ``core.faults`` and ``launch.serve
--spgemm`` against the JAX package, on the CPU.

The cases of the reference's ``tests/test_serve.py`` (and the serving
cases of ``tests/test_resilience.py``) run against the port, with each
request's result held bit for bit against the port's own ``spgemm`` of
that request.  One seeded request stream under an injected clock goes
through both services: the ``stats()`` counters must be equal and every
result bit-equal (on the CPU every lane of the port sums in the
reference's order).  ``launch.serve --spgemm`` prints the reference's
counters.
"""
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as ref_launch_serve
from repro.serve import SpGEMMService as RefService
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.core import faults
from repro_torch.core.spgemm import spgemm
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    DeadlineExceeded, QueueFull, ServeKnobs, SpGEMMService)
from repro_torch.serve.spgemm_service import (
    DEFAULT_BACKOFF, resolve_backoff, resolve_deadline, resolve_retries)
from repro_torch.sparse.formats import csr_from_dense


def _pattern(seed, shape=(20, 20), density=0.25):
    return np.random.default_rng(seed).random(shape) < density


def _dense(mask, seed):
    vals = np.random.default_rng(seed).standard_normal(mask.shape)
    return (mask * vals).astype(np.float32)


def _csr(mask, seed):
    return csr_from_dense(_dense(mask, seed), device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _service(**kw):
    clock = FakeClock()
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait", 1.0)
    kw.setdefault("max_queue", 64)
    return SpGEMMService(clock=clock, sleep=lambda s: None, **kw), clock


def assert_bit_exact(got, want):
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The reference's test_serve.py cases, on the port
# ---------------------------------------------------------------------------

def test_coalesced_batch_bit_exact_vs_per_request():
    svc, _ = _service(max_batch=4)
    mask_a, mask_b = _pattern(1), _pattern(2)
    b_mats = [_csr(mask_b, 100 + i) for i in range(4)]
    a_mats = [_csr(mask_a, 200 + i) for i in range(4)]
    tickets = [svc.submit(f"t{i % 2}", a_mats[i], b_mats[i])
               for i in range(4)]
    stats = svc.stats()
    assert stats["batched_dispatches"] == 1
    assert stats["singleton_dispatches"] == 0
    assert stats["coalescing_ratio"] == 4.0
    for i, tk in enumerate(tickets):
        assert tk.done and tk.coalesced_with == 4
        assert_bit_exact(tk.result().c, spgemm(a_mats[i], b_mats[i]).c)


def test_singleton_pattern_falls_back_to_single_spgemm():
    svc, clock = _service(max_batch=8, max_wait=0.5)
    tk = svc.submit("solo", _csr(_pattern(3), 1), _csr(_pattern(4), 2))
    assert not tk.done and svc.queue_depth() == 1
    clock.t = 1.0
    assert svc.poll() == 1
    assert tk.done and tk.coalesced_with == 1
    stats = svc.stats()
    assert stats["singleton_dispatches"] == 1
    assert stats["batched_dispatches"] == 0
    assert_bit_exact(tk.result().c,
                     spgemm(_csr(_pattern(3), 1), _csr(_pattern(4), 2)).c)


def test_result_forces_dispatch_of_pending_group():
    svc, _ = _service(max_batch=8)
    tk = svc.submit("t", _csr(_pattern(5), 1), _csr(_pattern(6), 2))
    assert not tk.done
    res = tk.result()
    assert tk.done and res is not None and svc.queue_depth() == 0


def test_queue_full_sheds_and_counts():
    svc, _ = _service(max_batch=100, max_queue=3)
    b = _csr(_pattern(7), 0)
    for i in range(3):
        svc.submit("t", _csr(_pattern(10 + i), i), b)
    with pytest.raises(QueueFull):
        svc.submit("t", _csr(_pattern(20), 9), b)
    stats = svc.stats()
    assert stats["requests_shed"] == 1
    assert stats["queue_depth"] == 3
    assert stats["tenants"]["t"]["shed"] == 1
    assert svc.flush() == 3
    assert svc.stats()["requests_completed"] == 3


def test_max_wait_flush_on_submit_path():
    svc, clock = _service(max_batch=8, max_wait=0.5)
    tk = svc.submit("t", _csr(_pattern(8), 1), _csr(_pattern(9), 2))
    clock.t = 0.6
    svc.submit("t", _csr(_pattern(30), 3), _csr(_pattern(31), 4))
    assert tk.done


def test_per_tenant_quota_eviction_is_isolated():
    svc, _ = _service(max_batch=1, tenant_plan_quota=2)
    b = _csr(_pattern(40), 0)
    for i in range(2):
        svc.submit("A", _csr(_pattern(50 + i), i), b)
    for i in range(4):
        svc.submit("B", _csr(_pattern(60 + i), i), b)
    ten = svc.stats()["tenants"]
    assert ten["B"]["plan_entries"] == 2
    assert ten["A"]["plan_entries"] == 2
    for i in range(2):
        svc.submit("A", _csr(_pattern(50 + i), 100 + i), b)
    assert svc.stats()["tenants"]["A"]["plan_hits"] == 2


def test_cross_tenant_batch_accounts_plan_in_both_caches():
    svc, _ = _service(max_batch=2)
    mask_a, mask_b = _pattern(70), _pattern(71)
    svc.submit("lead", _csr(mask_a, 1), _csr(mask_b, 2))
    svc.submit("rider", _csr(mask_a, 3), _csr(mask_b, 4))
    ten = svc.stats()["tenants"]
    assert ten["lead"]["plan_entries"] == 1
    assert ten["rider"]["plan_entries"] == 1
    assert svc.stats()["batched_dispatches"] == 1


def test_knob_signature_splits_groups_and_validates():
    svc, _ = _service(max_batch=2)
    mask_a, mask_b = _pattern(80), _pattern(81)
    svc.submit("t", _csr(mask_a, 1), _csr(mask_b, 2), engine="sort")
    svc.submit("t", _csr(mask_a, 3), _csr(mask_b, 4), engine="hash")
    assert svc.stats()["queued_groups"] == 2
    for bad in ({"engine": "nope"}, {"sizing": "nope"}, {"gather": "dma"}):
        with pytest.raises(ValueError):
            svc.submit("t", _csr(mask_a, 5), _csr(mask_b, 6), **bad)
    # a value that is not a mesh fails the submitting caller, saying what
    # a mesh is, instead of quarantining a batch at dispatch
    with pytest.raises(TypeError, match="a mesh is"):
        svc.submit("t", _csr(mask_a, 5), _csr(mask_b, 6), mesh=object())
    # operands="footprint" is a knob of its own signature
    svc.submit("t", _csr(mask_a, 5), _csr(mask_b, 6), engine="sort",
               operands="footprint")
    assert svc.stats()["queued_groups"] == 3
    svc.flush()


def test_service_flush_under_a_cpu_mesh():
    """Requests under one mesh object coalesce (the mesh joins the
    signature by identity) and each result is its solo ``mesh=None``
    product bit for bit; another mesh object is another group."""
    svc, _ = _service(max_batch=8)
    mesh = [torch.device("cpu")] * 3
    mask_a, mask_b = _pattern(82), _pattern(83)
    b = _csr(mask_b, 7)
    a_mats = [_csr(mask_a, i) for i in range(4)]
    tickets = [svc.submit("t", a, b, engine="fused_hash", mesh=mesh,
                          operands="footprint") for a in a_mats[:3]]
    other = svc.submit("t", a_mats[3], b, engine="fused_hash",
                       mesh=list(mesh), operands="footprint")
    assert svc.stats()["queued_groups"] == 2
    svc.flush()
    assert [t.coalesced_with for t in tickets] == [3, 3, 3]
    assert other.coalesced_with == 1
    for t, a in zip(tickets + [other], a_mats):
        res = t.result()
        assert res.info["n_shards"] == 3
        want = spgemm(a, b, engine="fused_hash").c
        nnz = int(want.indptr[-1])
        assert torch.equal(res.c.indptr, want.indptr)
        assert torch.equal(res.c.indices[:nnz], want.indices[:nnz])
        assert torch.equal(res.c.data[:nnz], want.data[:nnz])


def test_stats_latency_percentiles_use_injected_clock():
    svc, clock = _service(max_batch=4)
    mask_a, mask_b = _pattern(90), _pattern(91)
    b = _csr(mask_b, 0)
    for i in range(3):
        svc.submit("t", _csr(mask_a, i), b)
        clock.t += 0.1
    svc.flush()
    s = svc.stats()
    assert s["latency_p50_ms"] >= 100.0
    assert s["latency_p99_ms"] >= s["latency_p50_ms"]
    assert s["requests_completed"] == 3


def test_serve_knobs_signature_stable():
    k1, k2 = ServeKnobs(engine="hash"), ServeKnobs(engine="hash")
    assert k1.signature() == k2.signature()
    assert ServeKnobs(engine="sort").signature() != k1.signature()


# ---------------------------------------------------------------------------
# Deadlines, retries and quarantine (the reference's resilience cases)
# ---------------------------------------------------------------------------

def test_serve_resolvers_validate():
    assert resolve_deadline(None) is None and resolve_deadline(0.5) == 0.5
    assert resolve_retries(None) == 0 and resolve_retries(3) == 3
    assert resolve_backoff(None) == DEFAULT_BACKOFF
    for fn, bads in ((resolve_deadline, (-1, 0, True, "soon")),
                     (resolve_retries, (-1, True, 1.5)),
                     (resolve_backoff, (-0.1, 0, True))):
        for bad in bads:
            with pytest.raises(ValueError):
                fn(bad)


def test_deadline_and_retry_backoff():
    svc, clock = _service(max_batch=8, max_wait=0.05, max_queue=2)
    a0, b0 = _csr(_pattern(1), 10), _csr(_pattern(2), 20)
    t_dead = svc.submit("t", a0, b0, deadline=0.08)
    b1 = _csr(_pattern(2), 21)
    t_live = svc.submit("t", a0, b1)
    slept = []
    svc._sleep = slept.append
    with pytest.raises(QueueFull):  # the queue never drains: shed
        svc.submit("t", a0, b0, retries=2, backoff=0.1)
    assert slept == [0.1, 0.2]

    def sleep(s):
        slept.append(s)
        clock.t += s  # sleeping past the deadline and max_wait drains

    svc._sleep = sleep
    t_late = svc.submit("t", _csr(_pattern(3), 1), b0, retries=20,
                        backoff=0.1)  # one retry: the poll at 0.1 drains
    assert slept == [0.1, 0.2, 0.1]
    assert t_dead.done and t_live.done
    with pytest.raises(DeadlineExceeded):
        t_dead.result()
    assert_bit_exact(t_live.result().c, spgemm(a0, b1).c)
    assert t_late.result() is not None
    st = svc.stats()
    assert st["deadline_exceeded"] == 1 and st["requests_shed"] == 1
    assert st["retries"] == 3


def test_dispatch_fail_replays_every_member_bit_exact():
    """One failed batched dispatch: every member completes by replay, each
    equal to its solo run; with a second trigger the first member's replay
    fails too and only it is quarantined."""
    a_mats = [_csr(_pattern(1), 100 + i) for i in range(3)]
    b_mats = [_csr(_pattern(2), 200 + i) for i in range(3)]
    for times, poisoned in ((1, 0), (2, 1)):
        svc, _ = _service(max_batch=3, max_wait=10.0)
        with faults.fault_injection("dispatch_fail", times=times) as fault:
            tickets = [svc.submit("t", a_mats[i], b_mats[i])
                       for i in range(3)]
        assert fault.triggers == times and all(t.done for t in tickets)
        if poisoned:
            with pytest.raises(faults.FaultInjected):
                tickets[0].result()
        for i in range(poisoned, 3):
            assert_bit_exact(tickets[i].result().c,
                             spgemm(a_mats[i], b_mats[i]).c)
        st = svc.stats()
        assert st["quarantined"] == poisoned
        assert st["requests_completed"] == 3 - poisoned


def test_unported_fault_points_raise():
    """Every reference point is registered now; an unknown name or a bad
    schedule still raises."""
    assert set(faults.FAULT_POINTS) == {
        "capacity_undersize", "gather_fail", "stage_tile_fail",
        "dispatch_fail"}
    with pytest.raises(ValueError, match="unknown fault point"):
        with faults.fault_injection("dispatch_fial"):
            pass
    with pytest.raises(ValueError, match="on_hit"):
        with faults.fault_injection("dispatch_fail", on_hit=0):
            pass
    assert not faults.armed("dispatch_fail")


@pytest.mark.parametrize("name, n_requests", [("capacity_undersize", 3),
                                               ("gather_fail", 1)])
def test_ported_fault_points_recover_in_the_service(name, n_requests):
    """``capacity_undersize`` under a batched ``fused_hash`` dispatch and
    ``gather_fail`` under a single one: each fires once and every result is
    the reference's ``spgemm`` of that request, bit for bit."""
    from repro.core.spgemm import spgemm as ref_spgemm

    mask_a, mask_b = _pattern(100, (12, 12), 0.3), _pattern(101, (12, 12),
                                                            0.3)
    svc, _ = _service()
    with faults.fault_injection(name) as fault:
        tickets = [svc.submit("t", _csr(mask_a, 10 + i), _csr(mask_b, 20 + i),
                              engine="fused_hash")
                   for i in range(n_requests)]
        svc.flush()
    assert fault.triggers == 1
    for i, ticket in enumerate(tickets):
        want = ref_spgemm(ref_csr_from_dense(_dense(mask_a, 10 + i)),
                          ref_csr_from_dense(_dense(mask_b, 20 + i)),
                          engine="fused_hash").c
        c = ticket.result().c
        nnz = int(np.asarray(want.indptr)[-1])
        np.testing.assert_array_equal(c.indptr.numpy(),
                                      np.asarray(want.indptr))
        np.testing.assert_array_equal(c.indices[:nnz].numpy(),
                                      np.asarray(want.indices)[:nnz])
        np.testing.assert_array_equal(c.data[:nnz].numpy(),
                                      np.asarray(want.data)[:nnz])


# ---------------------------------------------------------------------------
# Both packages on one request stream
# ---------------------------------------------------------------------------

COUNTERS = ("requests_submitted", "requests_completed", "requests_shed",
            "dispatches", "batched_dispatches", "singleton_dispatches",
            "coalescing_ratio", "coalesced_fraction", "latency_p50_ms",
            "latency_p99_ms", "deadline_exceeded", "retries", "quarantined",
            "queue_depth")


def drive(service_cls, to_csr, fault_module, stream):
    """Submit ``stream`` (tenant, dense A, dense B, knobs, deadline, dt)
    under a fake clock that advances ``dt`` after each submit, with the
    2nd and 3rd consults of ``dispatch_fail`` failing; then flush."""
    clock = FakeClock()
    svc = service_cls(max_batch=3, max_wait=0.25, max_queue=5, clock=clock,
                      sleep=lambda s: None)
    tickets = []
    with fault_module.fault_injection("dispatch_fail", on_hit=2, times=2):
        for tenant, xa, xb, knobs, deadline, dt in stream:
            tickets.append(svc.submit(tenant, to_csr(xa), to_csr(xb),
                                      deadline=deadline, **knobs))
            clock.t += dt
        svc.flush()
    return svc.stats(), tickets


def test_same_stream_through_both_services():
    """Ten requests over two patterns from three tenants, every third on
    ``fused_hash``, one with a deadline it misses, a pause that flushes by
    ``max_wait``, and two injected dispatch failures (a batch replayed, its
    first member quarantined): equal counters and bit-equal results."""
    from repro.core import faults as ref_faults

    rng = np.random.default_rng(13)
    masks = [(_pattern(s, (12, 12), 0.3), _pattern(s + 1, (12, 12), 0.3))
             for s in (100, 200)]
    stream = []
    for i in range(10):
        pa, pb = masks[0 if rng.random() < 0.7 else 1]
        stream.append((f"t{i % 3}", _dense(pa, 1000 + i), _dense(pb, 2000 + i),
                       {"engine": "fused_hash"} if i % 3 == 2 else {},
                       0.1 if i == 3 else None, 0.4 if i == 6 else 0.05))
    got, got_t = drive(SpGEMMService,
                       lambda x: csr_from_dense(x, device="cpu"), faults,
                       stream)
    want, want_t = drive(RefService, ref_csr_from_dense, ref_faults, stream)
    for key in COUNTERS:
        assert got[key] == want[key], key
    assert got["batched_dispatches"] > 0 and got["singleton_dispatches"] > 0
    assert got["deadline_exceeded"] == 1 and got["quarantined"] == 1
    for tid in want["tenants"]:
        for key in ("submitted", "completed", "shed", "plan_entries",
                    "plan_hits", "plan_misses"):
            assert got["tenants"][tid][key] == want["tenants"][tid][key]
    for tk, rtk in zip(got_t, want_t):
        assert tk.coalesced_with == rtk.coalesced_with
        if rtk._error is not None:
            assert type(tk._error).__name__ == type(rtk._error).__name__
            continue
        c, rc = tk.result().c, rtk.result().c
        nnz = int(np.asarray(rc.indptr)[-1])
        np.testing.assert_array_equal(c.indptr.numpy(), np.asarray(rc.indptr))
        np.testing.assert_array_equal(c.indices[:nnz].numpy(),
                                      np.asarray(rc.indices)[:nnz])
        np.testing.assert_array_equal(c.data[:nnz].numpy(),
                                      np.asarray(rc.data)[:nnz])


def test_launch_serve_spgemm_prints_the_reference_counters(monkeypatch,
                                                            capsys):
    """``--spgemm`` at the reference's default n (64) on the CPU.  A long
    ``--max-wait`` makes the dispatches depend on the stream alone (each
    launcher's service runs on the wall clock), so every counter line but
    the latency line is equal."""
    args = ["--spgemm", "--requests", "6", "--patterns", "2",
            "--tenants", "2", "--max-batch", "3", "--max-wait", "1000"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    ref_launch_serve.main()
    want = capsys.readouterr().out.splitlines()
    stats = launch_serve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2 + 2
    assert got[0] == want[0] and got[2:] == want[2:]
    assert got[1].split("shed=")[1] == want[1].split("shed=")[1]
    assert stats["requests_completed"] == 6
