"""The port's lock-order witness against the JAX package's.

`pipeedge_tpu_torch/analysis/lockdep.py` is the port's copy of
`pipeedge_tpu/analysis/lockdep.py`. The same scripted acquisitions go
through a private witness of each package, and the reports agree: the
locks, the order edges, the cycles (an A->B / B->A inversion across two
threads, two instances of one lock site nested, none for a re-entrant
hold) and the blocking-under-lock records (a `Condition.wait` parks
without holding). While a witness is enabled `time.sleep` and blocking
`queue.Queue.get/put` report to it, and `disable()` restores them. The
port's `make_lock`/`make_rlock`/`make_condition` give tracked locks
only while it is on. One port DCN fleet runs with `PIPEEDGE_LOCKDEP=1`:
every rank appends its report line at exit, each with zero cycles.
"""
import json
import queue
import threading
import time

import pytest

from pipeedge_tpu.analysis import lockdep as jlockdep
from pipeedge_tpu_torch.analysis import lockdep as tlockdep
from pipeedge_tpu_torch.utils import threads as tthreads

PACKAGES = [pytest.param(jlockdep, id="jax"), pytest.param(tlockdep,
                                                          id="port")]


def _script(ld):
    """One fixed sequence of acquisitions and blocking notes on a private
    witness of module `ld`; returns its report."""
    st = ld.LockdepState()
    a, b = ld.TrackedLock(st, "a"), ld.TrackedLock(st, "b")
    c = ld.TrackedLock(st, "c")
    r = ld.TrackedRLock(st, "r")
    same1, same2 = ld.TrackedLock(st, "conn"), ld.TrackedLock(st, "conn")

    def a_then_b():
        with a:
            with b:
                pass

    def b_then_a():
        with b:
            with a:
                st.note_blocking("socket.send")

    for fn, name in ((a_then_b, "t1"), (b_then_a, "t2")):
        t = threading.Thread(target=fn, name=name)
        t.start()
        t.join()
    with c:               # an order edge with no inversion
        with r:
            with r:       # re-entrant: no self-edge
                pass
    with same1:           # two instances of one site nested: a self-edge
        with same2:
            pass
    cond = threading.Condition(ld.TrackedRLock(st, "cond"))
    with cond:
        cond.wait(timeout=0.001)   # parks released: not a violation
    st.note_blocking("not under a lock")
    return st.report()


def _comparable(rep):
    return {"locks": rep["locks"], "edges": rep["edges"],
            "threads": rep["threads"], "cycles": rep["cycles"],
            "blocking": [(v["held"], v["call"], v["thread"])
                         for v in rep["blocking_violations"]],
            "dropped": rep["blocking_dropped"]}


def test_same_script_same_report():
    jrep, trep = _script(jlockdep), _script(tlockdep)
    assert _comparable(jrep) == _comparable(trep)
    assert trep["cycles"] == [["a", "b"], ["conn"]]
    assert trep["locks"] == ["a", "b", "c", "cond", "conn", "r"]
    assert _comparable(trep)["blocking"] == [(["b", "a"], "socket.send",
                                              "t2")]


@pytest.mark.parametrize("ld", PACKAGES)
def test_edge_witnesses_and_dump(ld, tmp_path):
    st = ld.LockdepState()
    a, b = ld.TrackedLock(st, "x"), ld.TrackedLock(st, "y")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    wit = st.edge_witnesses(["x", "y"])
    assert sorted((w["held"], w["acquired"]) for w in wit) == [
        ("x", "y"), ("y", "x")]
    out = tmp_path / "lockdep.json"
    st.dump(str(out))
    st.dump(str(out))
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["cycles"] == [["x", "y"]]
    assert len(lines[0]["cycle_witnesses"][0]) == 2


@pytest.mark.parametrize("ld", PACKAGES)
def test_blocking_probes_wrap_while_enabled(ld):
    orig = (time.sleep, queue.Queue.get, queue.Queue.put)
    st = ld.enable(ld.LockdepState())
    try:
        assert ld.enabled() and ld.state() is st
        lk = ld.TrackedLock(st, "held")
        q = queue.Queue()
        with lk:
            time.sleep(0.001)
            q.put(1)
            q.get()
            q.put(2, block=False)    # non-blocking: not recorded
        time.sleep(0.001)            # nothing held: not recorded
        calls = [v["call"] for v in st.report()["blocking_violations"]]
        assert calls == ["time.sleep(0.001)", "queue.Queue.put",
                         "queue.Queue.get"]
    finally:
        ld.disable()
    assert not ld.enabled()
    assert (time.sleep, queue.Queue.get, queue.Queue.put) == orig


def test_port_factories_track_only_while_enabled():
    plain = type(threading.Lock())
    assert not tlockdep.enabled()
    assert type(tthreads.make_lock("n")) is plain
    assert type(tthreads.make_rlock("n")) is type(threading.RLock())
    assert type(tthreads.make_condition("n")._lock) is type(
        threading.RLock())
    st = tlockdep.enable(tlockdep.LockdepState())
    try:
        lk = tthreads.make_lock("site.a")
        rl = tthreads.make_rlock("site.b")
        cond = tthreads.make_condition("site.c")
        assert isinstance(lk, tlockdep.TrackedLock)
        assert isinstance(rl, tlockdep.TrackedRLock)
        assert isinstance(cond._lock, tlockdep.TrackedRLock)
        with lk:
            with rl:
                with cond:
                    cond.notify_all()
        rep = st.report()
        assert rep["locks"] == ["site.a", "site.b", "site.c"]
        assert rep["edges"] == 3 and rep["cycles"] == []
    finally:
        tlockdep.disable()
    assert type(tthreads.make_lock("n")) is plain


@pytest.mark.fleet
def test_port_dcn_fleet_witnessed_without_cycles(tmp_path):
    from test_torch_dcn_runtime import MODEL, _run_fleet
    out = tmp_path / "lockdep.jsonl"
    _run_fleet(tmp_path, ["-c", "dcn", "-m", MODEL, "-b", "16", "-u", "4",
                          "-pt", "1,4,5,8", "-q", "8,0", "-r", "0,1",
                          "--sched-timeout", "60"], world=2,
               env_extra={"PIPEEDGE_LOCKDEP": "1",
                          "PIPEEDGE_LOCKDEP_OUT": str(out)})
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == 2, lines      # one line per rank
    assert len({rep["pid"] for rep in lines}) == 2
    for rep in lines:
        assert rep["cycles"] == [], rep["cycle_witnesses"]
        # the transport's own lock sites were witnessed
        assert any(name.startswith("dcn.") for name in rep["locks"]), rep
        assert rep["edges"] >= 0 and rep["threads"] >= 2
