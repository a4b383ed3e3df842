"""Parity of the port's multi-tenant broker (repro_torch.frontend) with the
JAX package's, on ``device="cpu"``.

One seeded single-threaded op script goes through the reference ``Broker``
and the port's: every ticket's result (or error type), every flush's
``BatchDelta``, every ``pairs()``, every ``CountResult`` (exact and
degraded, both estimators), the journals and the ``stats()`` keys and
counters must be equal.  Then the port alone: admission (block with a
timeout, reject, shed_oldest), whole-op deadline expiry, a 4-thread run
whose ``pairs()`` equals ``replay_journal``'s, and the same run under
``debug_locks=True`` with no lock-discipline violation.
"""
import threading
import time

import jax
import numpy as np
import pytest

from repro import api as ref_api
from repro_torch import api
from repro_torch.testing.oracles import service_pairs

jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("queue_depth", "accepted", "rejected", "shed", "expired",
            "failed", "applied", "flushes", "degraded_reads", "exact_reads")


def _bounds(rng, d, b=None):
    shape = (d,) if b is None else ((b,) if d == 1 else (b, d))
    lo = rng.integers(0, 40, shape).astype(np.float32)
    hi = lo + rng.integers(0, 6, shape).astype(np.float32)
    if b is None and d == 1:
        return float(lo[0]), float(hi[0])
    return lo, hi


def _script(seed, d):
    """Ops: ("register"|"move"|"unregister", side, ...), ("flush",),
    ("pairs",), ("count",).  Rids are drawn blindly, so some moves and
    unregisters hit dead rids and fail their tickets; one register has
    lo > hi."""
    rng = np.random.default_rng(seed)
    ops = [("register", "sub", *_bounds(rng, d, 12)),
           ("register", "upd", *_bounds(rng, d, 10)),
           ("flush",), ("count",), ("pairs",)]
    for step in range(8):
        for _ in range(int(rng.integers(1, 7))):
            side = ("sub", "upd")[int(rng.integers(0, 2))]
            kind = int(rng.integers(0, 4))
            if kind == 0:
                ops.append(("register", side, *_bounds(rng, d)))
            elif kind == 1:
                ops.append(("move", side, int(rng.integers(0, 14)),
                            *_bounds(rng, d)))
            elif kind == 2:
                ops.append(("move", side, rng.choice(10, 3, replace=False),
                            *_bounds(rng, d, 3)))
            else:
                ops.append(("unregister", side, int(rng.integers(0, 14))))
            if rng.random() < 0.3:
                ops.append(("count",))
        ops.append(("count",))      # degraded once 3 ops are queued
        if step == 3:
            lo, hi = _bounds(rng, d)
            ops.append(("register", "sub", hi, np.asarray(lo) - 10))
        ops.append(("flush",) if step % 2 else ("pairs",))
        ops.append(("count",))
    return ops


def _run(mod, ops, d, estimator, **session_kw):
    broker = mod.Broker(journal=True, degrade=mod.DegradePolicy(
        max_queue_depth=3, estimator=estimator))
    sess = broker.create_session("w", dims=d, capacity=8, **session_kw)
    out, tickets = [], []
    for op in ops:
        kind = op[0]
        if kind == "register":
            tickets.append(sess.register(op[1], op[2], op[3]))
        elif kind == "move":
            tickets.append(sess.move(op[1], op[2], op[3], op[4]))
        elif kind == "unregister":
            tickets.append(sess.unregister(op[1], op[2]))
        elif kind == "flush":
            delta = sess.flush()
            out.append(("delta", sorted(delta.added), sorted(delta.removed)))
        elif kind == "pairs":
            out.append(("pairs", sorted(sess.pairs())))
        else:
            c = sess.match_count()
            out.append(("count", c.count, c.exact, c.source, c.pending))
    broker.close()
    for t in tickets:
        try:
            value = t.result(timeout=0)
            out.append(("ticket", np.asarray(value).tolist()))
        except Exception as exc:  # the error type is part of the transcript
            out.append(("ticket", type(exc).__name__))
    return broker, sess, out


@pytest.mark.parametrize("d,estimator", [(1, "probe"), (1, "grid"),
                                         (2, "probe")])
def test_single_threaded_script_equals_the_reference(d, estimator):
    ops = _script(40 + d, d)
    r_broker, r_sess, r_out = _run(ref_api, ops, d, estimator)
    broker, sess, out = _run(api, ops, d, estimator, device="cpu")
    assert out == r_out
    kinds = {o[0] for o in out}
    assert kinds == {"delta", "pairs", "count", "ticket"}
    reads = [o for o in out if o[0] == "count"]
    assert {o[2] for o in reads} == {True, False}       # exact and degraded
    assert any(o == ("ticket", "ValidationError") for o in out)
    assert sess.journal == r_sess.journal
    st, r_st = broker.stats(), r_broker.stats()
    assert set(st) == set(r_st)
    assert set(st["totals"]) == set(r_st["totals"])
    assert set(st["sessions"]["w"]) == set(r_st["sessions"]["w"])
    for key in COUNTERS:
        assert st["sessions"]["w"][key] == r_st["sessions"]["w"][key], key
    assert st["sessions"]["w"]["degraded_reads"] > 0
    cap = sess.service._subs.lo.shape[1]
    replay = api.replay_journal(sess.journal, dims=d, capacity=8,
                                device="cpu")
    r_replay = ref_api.replay_journal(r_sess.journal, dims=d, capacity=8)
    assert replay.pairs() == r_replay.pairs() == sess.pairs()
    assert cap == r_sess.service._subs.lo.shape[1]


def _warm(sess, n=8):
    lo = np.linspace(0.0, 900.0, n).astype(np.float32)
    sess.register("sub", lo, lo + np.float32(200.0))
    sess.register("upd", lo + np.float32(50.0), lo + np.float32(60.0))
    sess.flush()


def test_admission_reject_and_shed_oldest():
    broker = api.Broker(admission=api.AdmissionPolicy(max_queue=2,
                                                      backpressure="reject"))
    sess = broker.create_session("s", device="cpu")
    sess.register("sub", 0.0, 1.0)
    sess.register("sub", 1.0, 2.0)
    with pytest.raises(api.OverloadError, match="'reject' policy"):
        sess.register("sub", 2.0, 3.0)
    assert sess.stats()["rejected"] == 1 and sess.queue_depth == 2
    sess.flush()
    sess.register("sub", 2.0, 3.0)

    broker = api.Broker(admission=api.AdmissionPolicy(
        max_queue=2, backpressure="shed_oldest"))
    sess = broker.create_session("s", device="cpu")
    first = sess.register("sub", 0.0, 1.0)
    second = sess.register("sub", 1.0, 2.0)
    third = sess.register("sub", 2.0, 3.0)           # sheds `first`
    with pytest.raises(api.OverloadError, match="shed"):
        first.result(timeout=0)
    sess.flush()
    assert second.result(0) == 0 and third.result(0) == 1
    st = sess.stats()
    assert st["shed"] == 1 and st["applied"] == 2
    with pytest.raises(api.ValidationError, match="backpressure"):
        api.AdmissionPolicy(backpressure="drop_newest")
    with pytest.raises(api.ValidationError, match="estimator"):
        api.DegradePolicy(estimator="psychic")


def test_admission_block_times_out_then_waits_for_a_drain():
    broker = api.Broker(admission=api.AdmissionPolicy(
        max_queue=1, backpressure="block", block_timeout=0.05))
    sess = broker.create_session("s", device="cpu")
    sess.register("sub", 0.0, 1.0)
    t0 = time.perf_counter()
    with pytest.raises(api.OverloadError, match="blocking"):
        sess.register("sub", 1.0, 2.0)               # nobody drains
    assert time.perf_counter() - t0 >= 0.04
    timer = threading.Timer(0.01, sess.flush)
    timer.start()
    ticket = sess.register("sub", 1.0, 2.0)          # the drain admits it
    timer.join(timeout=5.0)
    assert not timer.is_alive()
    sess.flush()
    assert ticket.result(0) == 1


def test_deadlines_expire_whole_ops():
    broker = api.Broker()
    sess = broker.create_session("s", device="cpu")
    fresh = sess.register("sub", 0.0, 10.0)
    stale = sess.register("upd", np.array([5.0, 7.0]), np.array([6.0, 8.0]),
                          timeout=0.0)
    late = sess.register("upd", 2.0, 3.0, timeout=60.0)
    time.sleep(0.01)                                  # the deadline passes
    sess.flush()
    with pytest.raises(api.DeadlineExceeded, match="deadline passed"):
        stale.result(timeout=0)
    assert fresh.result(0) == 0
    assert sess.pairs() == {(0, late.result(0))}     # no part of `stale`
    assert sess.stats()["expired"] == 1


def test_degraded_reads_run_on_the_session_device():
    broker = api.Broker(degrade=api.DegradePolicy(max_queue_depth=1,
                                                  estimator="grid"))
    sess = broker.create_session("s", device="cpu")
    _warm(sess)
    exact = sess.match_count()
    sess.register("upd", 1e5, 1e5 + 1)
    got = sess.match_count()
    assert got.exact is False and got.source == "grid_count"
    assert got.count == exact.count and got.pending == 1
    assert str(sess.service.device) == "cpu"


def _threaded(debug_locks):
    """4 producer threads against one session with the flusher running;
    the live pairs must equal the journal's single-threaded replay and the
    host oracle."""
    broker = api.Broker(
        admission=api.AdmissionPolicy(max_queue=48, block_timeout=30.0),
        journal=True, flush_interval=0.002, debug_locks=debug_locks)
    sess = broker.create_session("stress", capacity=64, device="cpu")
    _warm(sess, n=16)
    barrier = threading.Barrier(4)
    errors = []

    def producer(k):
        """Moves of its own warm rids 4k..4k+2, registers, and at the end
        the unregister of its rid 4k+3 on both sides."""
        rng = np.random.default_rng(500 + k)
        try:
            barrier.wait(timeout=30.0)
            tickets = []
            for i in range(80):
                lo = float(rng.uniform(0, 9e2))
                side = "sub" if (i + k) % 2 else "upd"
                if i % 4 == 0:
                    tickets.append(sess.move(side, 4 * k + i % 3,
                                             lo, lo + 50.0))
                else:
                    tickets.append(sess.register(side, lo, lo + 50.0))
            tickets += [sess.unregister(side, 4 * k + 3)
                        for side in ("sub", "upd")]
            for t in tickets:
                t.result(timeout=30.0)
        except Exception as exc:  # pragma: no cover - diagnostic
            errors.append(exc)

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    broker.close()
    assert not errors, errors
    replayed = api.replay_journal(sess.journal, dims=1, capacity=64,
                                  device="cpu")
    live = sess.pairs()
    assert replayed.pairs() == live == service_pairs(sess.service)
    st = sess.stats()
    assert st["accepted"] == st["applied"] == 4 * 82 + 2
    assert st["failed"] == st["shed"] == st["expired"] == 0
    assert st["flushes"] > 1
    return broker


def test_threaded_producers_equal_the_journal_replay():
    _threaded(debug_locks=False)


def test_threaded_producers_under_debug_locks_run_clean():
    locks = _threaded(debug_locks=True).stats()["locks"]
    assert locks["violations"] == []
    assert locks["order"][0] == "broker"
    assert locks["acquisitions"]["session:stress"] > 100
