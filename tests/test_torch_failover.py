"""The DCN driver's fault plane, in process, against the JAX package.

Every case of tests/test_failover.py (the microbatch ledger, the
survivor re-scheduling cascade, rejoin planning, the chaos grammar and
its send wrapper), the ledger-snapshot cases of
tests/test_transport_tiers.py and the gray chaos grammar of
tests/test_gray_failures.py run once through each package on the same
inputs: each case returns what it observed (deliveries, replay sets,
schedules, parsed specs, forwarded sends), and the port's must equal the
JAX package's exactly. A property test draws random schedules, dead sets
and bench sets for `plan_failover` and `plan_rejoin`.

Besides those: corrupt@K's bit flip is the JAX transport's; the JOIN
admission keeps a live connection to the restarted incarnation (the
port's repair, ROADMAP F3); and `@K` counts every send of a pipeline
stage, on the colocated tier too.
"""
import queue
import socket
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import runtime as jrt
from pipeedge_tpu.comm import chaos as jchaos
from pipeedge_tpu.sched import failover as jfailover
from pipeedge_tpu_torch import runtime as trt
from pipeedge_tpu_torch.comm import chaos as tchaos
from pipeedge_tpu_torch.comm import dcn
from pipeedge_tpu_torch.sched import failover as tfailover

JAX = (jrt, jfailover, jchaos)
PORT = (trt, tfailover, tchaos)


def _both(case, *args):
    """Run `case` through each package; the port's observations must
    equal the JAX package's. Returns them."""
    got = case(*PORT, *args)
    want = case(*JAX, *args)
    assert got == want
    return got


class _Delivered:
    """Capture what a ledger hands to `handle_results` (as bytes, so
    arrays compare exactly) and the labels it queues, restoring the
    runtime module afterwards."""

    def __init__(self, rt):
        self.rt = rt
        self.out = []

    def __enter__(self):
        self.orig = self.rt.handle_results
        self.rt.handle_results = lambda o: self.out.append(
            (np.asarray(o).dtype.str, np.asarray(o).shape,
             np.asarray(o).tobytes()))
        return self

    def __exit__(self, *exc):
        self.rt.handle_results = self.orig
        self.labels = []
        while not self.rt.label_queue.empty():
            self.labels.append(np.asarray(self.rt.label_queue.get()).tolist())


def _make_ledger(rt, n=4, labels=True, snapshot_every=None):
    ubatches = [np.full((2, 3), i, np.float32) for i in range(n)]
    lbs = [np.asarray([i, i]) for i in range(n)] if labels else None
    return ubatches, rt._MicrobatchLedger(ubatches, lbs,
                                          snapshot_every=snapshot_every)


def _ids(pending):
    return [i for i, _ in pending]


# -- the microbatch ledger (tests/test_failover.py) ----------------------

def ledger_in_order_delivery_and_replay_set(rt, fo, ch):
    _, ledger = _make_ledger(rt, 4)
    seen = []
    with _Delivered(rt) as d:
        seen.append(_ids(ledger.pending()))
        seen.append(ledger.ack(1, np.full((2,), 1.0)))
        seen.append((len(d.out), ledger.done.is_set()))
        seen.append(ledger.ack(0, np.full((2,), 0.0)))
        seen.append(_ids(ledger.pending()))
        seen += [ledger.ack(3, np.full((2,), 3.0)),
                 ledger.ack(2, np.full((2,), 2.0))]
        seen.append(ledger.done.is_set())
    assert seen[0] == [0, 1, 2, 3] and seen[4] == [2, 3] and seen[-1]
    return seen, d.out, d.labels


def ledger_dedupes_replay_overlap(rt, fo, ch):
    _, ledger = _make_ledger(rt, 2)
    with _Delivered(rt) as d:
        seen = [ledger.ack(0, np.zeros(2)), ledger.ack(0, np.ones(2)),
                ledger.ack(99, np.ones(2)), ledger.ack(1, np.ones(2)),
                ledger.done.is_set(), ledger.acked_count]
    assert seen == [True, False, False, True, True, 2]
    return seen, d.out, d.labels


def ledger_empty_batch_is_done(rt, fo, ch):
    return rt._MicrobatchLedger([], []).done.is_set()


def ledger_dedupe_keys_include_epoch(rt, fo, ch):
    _, ledger = _make_ledger(rt, 2)
    with _Delivered(rt) as d:
        seen = [ledger.ack(0, np.zeros(2), epoch=0),
                ledger.ack(0, np.ones(2), epoch=1),
                ledger.ack(1, np.ones(2), epoch=2), ledger.acked_epochs()]
    assert seen[-1] == {0: 0, 1: 2}
    return seen, d.out


def ledger_fences_stale_incarnation_acks(rt, fo, ch):
    _, ledger = _make_ledger(rt, 2)
    with _Delivered(rt) as d:
        ledger.fence_rank(3, 1)
        seen = [ledger.ack(0, np.zeros(2), epoch=0, src=3),
                ledger.stale_dropped, _ids(ledger.pending()),
                ledger.ack(0, np.zeros(2), epoch=1, src=3),
                ledger.ack(1, np.ones(2), epoch=0, src=2),
                ledger.done.is_set()]
    assert seen == [False, 1, [0, 1], True, True, True]
    return seen, d.out


# -- survivor re-scheduling ----------------------------------------------

_LAYERS = [(1, 4), (5, 8)]


def failover_substitutes_spare_rank(rt, fo, ch):
    planned = fo.plan_failover(_LAYERS, [8, 0], [0, 1], world_size=4,
                               dead_ranks={1})
    assert planned == (_LAYERS, [8, 0], [0, 2])
    return planned


def failover_no_spare_returns_none(rt, fo, ch):
    return fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=2,
                            dead_ranks={1})


def failover_dead_idle_rank_keeps_schedule(rt, fo, ch):
    return fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=4,
                            dead_ranks={3})


def failover_multiple_deaths_multiple_spares(rt, fo, ch):
    return fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=5,
                            dead_ranks={0, 1})


def failover_scheduler_fn_ranks_remap_to_survivors(rt, fo, ch):
    asked = []

    def scheduler_fn(n_survivors):
        asked.append(n_survivors)
        return [(1, 8)], [0], [2]
    planned = fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=4,
                               dead_ranks={1}, scheduler_fn=scheduler_fn)
    assert planned == ([(1, 8)], [0], [3])
    return planned, asked


def failover_scheduler_fn_failure_falls_through_to_spares(rt, fo, ch):
    def scheduler_fn(_n):
        raise RuntimeError("no profiles")
    return fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=3,
                            dead_ranks={1}, scheduler_fn=scheduler_fn)


def failover_benched_rank_loses_stage_prefers_fresh_spare(rt, fo, ch):
    return fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=4,
                            dead_ranks=set(), benched={1})


def failover_benched_rank_is_last_resort_spare(rt, fo, ch):
    return fo.plan_failover(_LAYERS, [0, 0], [0, 1], world_size=2,
                            dead_ranks=set(), benched={1})


# -- rejoin / heal planning ----------------------------------------------

def rejoin_restores_pre_failure_schedule(rt, fo, ch):
    return fo.plan_rejoin((_LAYERS, [8, 0], [0, 2]),
                          (_LAYERS, [8, 0], [0, 1]), world_size=4,
                          dead_ranks=set())


def rejoin_waits_while_pre_failure_rank_still_dead(rt, fo, ch):
    return fo.plan_rejoin((_LAYERS, [0, 0], [0, 2]),
                          (_LAYERS, [0, 0], [0, 1]), world_size=3,
                          dead_ranks={1})


def rejoin_expands_contracted_partition(rt, fo, ch):
    cur = ([(1, 8)], [0], [0])
    restored = fo.plan_rejoin(cur, (_LAYERS, [0, 0], [0, 1]), world_size=2,
                              dead_ranks=set())
    expanded = fo.plan_rejoin(cur, None, world_size=2, dead_ranks=set())
    assert restored == (_LAYERS, [0, 0], [0, 1])
    assert len(expanded[0]) == 2 and expanded[2] == [0, 1]
    return restored, expanded


def rejoin_no_spares_returns_none(rt, fo, ch):
    return fo.plan_rejoin(([(1, 8)], [0], [0]), None, world_size=2,
                          dead_ranks={1})


# -- the chaos grammar and its send wrapper ------------------------------

def _spec(ch, text):
    return [(a.kind, a.at_send, a.delay_ms, a.until_send)
            for a in ch.ChaosSpec.parse(text).actions]


def chaos_spec_parse(rt, fo, ch):
    got = _spec(ch, "kill@3; delay@1:250; drop@7")
    assert got[1] == ("delay", 1, 250.0, None)
    return got


def chaos_spec_parse_restart_and_flap(rt, fo, ch):
    return _spec(ch, "restart@3:2000; flap@2:500")


def chaos_spec_rejects_bad_clauses(rt, fo, ch):
    out = []
    for bad in ("explode@3", "kill@x", "delay@2:abc", "restart@x:5",
                "flap@2:zz"):
        with pytest.raises(ValueError, match="DCN_CHAOS") as exc:
            ch.ChaosSpec.parse(bad)
        out.append(str(exc.value))
    return out


class _Ctx:
    """A context whose sends are recorded (dst, channel, tensor bytes)."""

    def __init__(self):
        self.sent = []

    def send_tensors(self, dst, tensors, channel=0, trace=None):
        self.sent.append((dst, channel, [np.asarray(t).tobytes()
                                         for t in tensors]))


def chaos_drop_and_delay_wrap(rt, fo, ch, monkeypatch):
    ctx = _Ctx()
    monkeypatch.setenv(ch.ENV_CHAOS, "drop@2;delay@3:1")
    spec = ch.maybe_install(ctx)
    t0 = time.monotonic()
    for i in range(4):
        ctx.send_tensors(1, [np.full(1, i)], channel=i)
    assert time.monotonic() - t0 >= 0.002      # sends 3 and 4 delayed
    assert [c for _, c, _ in ctx.sent] == [0, 2, 3]
    return ([(a.kind, a.at_send) for a in spec.actions],
            [(d, c) for d, c, _ in ctx.sent])


def chaos_env_unset_is_noop(rt, fo, ch, monkeypatch):
    monkeypatch.delenv(ch.ENV_CHAOS, raising=False)
    return ch.maybe_install(_Ctx())


CASES = {f.__name__: f for f in (
    ledger_in_order_delivery_and_replay_set, ledger_dedupes_replay_overlap,
    ledger_empty_batch_is_done, ledger_dedupe_keys_include_epoch,
    ledger_fences_stale_incarnation_acks, failover_substitutes_spare_rank,
    failover_no_spare_returns_none, failover_dead_idle_rank_keeps_schedule,
    failover_multiple_deaths_multiple_spares,
    failover_scheduler_fn_ranks_remap_to_survivors,
    failover_scheduler_fn_failure_falls_through_to_spares,
    failover_benched_rank_loses_stage_prefers_fresh_spare,
    failover_benched_rank_is_last_resort_spare,
    rejoin_restores_pre_failure_schedule,
    rejoin_waits_while_pre_failure_rank_still_dead,
    rejoin_expands_contracted_partition, rejoin_no_spares_returns_none,
    chaos_spec_parse, chaos_spec_parse_restart_and_flap,
    chaos_spec_rejects_bad_clauses)}
ENV_CASES = {f.__name__: f for f in (chaos_drop_and_delay_wrap,
                                     chaos_env_unset_is_noop)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_plane_equals_jax(case):
    _both(CASES[case])


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_chaos_wrapper_equals_jax(case, monkeypatch):
    _both(ENV_CASES[case], monkeypatch)


# -- ledger snapshots (tests/test_transport_tiers.py) ---------------------

def snapshot_compacts_and_bounds_replay(rt, fo, ch):
    ubatches, ledger = _make_ledger(rt, 8, labels=False, snapshot_every=3)
    with _Delivered(rt) as d:
        for i in range(5):
            assert ledger.ack(i, np.full((2,), float(i)))
            ledger.maybe_snapshot()
        pending = ledger.pending()
    compacted = [ledger._ubatches[i] is None for i in range(8)]
    assert ledger.snapshots == 1 and ledger._frontier == 3
    assert _ids(pending) == [5, 6, 7]
    for i, u in pending:
        assert u.tobytes() == ubatches[i].tobytes()
    return (ledger.snapshots, ledger._frontier, compacted, _ids(pending),
            d.out)


def snapshot_replay_exactly_once_bit_identical(rt, fo, ch):
    _, ledger = _make_ledger(rt, 6, labels=False, snapshot_every=2)
    results = {i: np.full((2, 2), i * 1.5, np.float32) for i in range(6)}
    seen = []
    with _Delivered(rt) as d:
        for i in (0, 1, 2):
            seen.append(ledger.ack(i, results[i]))
            seen.append(ledger.maybe_snapshot())
        seen.append(_ids(ledger.pending()))
        seen.append(ledger.ack(2, results[2] + 99))
        for i in (4, 3, 5):
            seen.append(ledger.ack(i, results[i]))
            seen.append(ledger.maybe_snapshot())
        seen.append(ledger.done.is_set())
    assert seen[6] == [3, 4, 5] and not seen[7] and seen[-1]
    assert [o[2] for o in d.out] == [results[i].tobytes() for i in range(6)]
    return seen, d.out, ledger.forensics()


def snapshot_disabled_keeps_payloads(rt, fo, ch):
    _, ledger = _make_ledger(rt, 4, labels=False, snapshot_every=0)
    with _Delivered(rt):
        seen = []
        for i in range(4):
            ledger.ack(i, np.full((2,), float(i)))
            seen.append(ledger.maybe_snapshot())
    assert ledger.snapshots == 0
    assert all(u is not None for u in ledger._ubatches)
    return seen, ledger.snapshots


SNAPSHOT_CASES = {f.__name__: f for f in (
    snapshot_compacts_and_bounds_replay,
    snapshot_replay_exactly_once_bit_identical,
    snapshot_disabled_keeps_payloads)}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_CASES))
def test_ledger_snapshots_equal_jax(case):
    _both(SNAPSHOT_CASES[case])


def test_ledger_snapshot_default_and_forensics_equal_jax(monkeypatch):
    """DCN_LEDGER_SNAPSHOT sets the cadence (default 8), and the
    postmortem's ledger slice (with the request map) is the JAX one."""
    monkeypatch.delenv(trt.ENV_LEDGER_SNAPSHOT, raising=False)
    assert trt.ENV_LEDGER_SNAPSHOT == jrt.ENV_LEDGER_SNAPSHOT
    assert trt.DEFAULT_LEDGER_SNAPSHOT == jrt.DEFAULT_LEDGER_SNAPSHOT == 8

    def case(rt, fo, ch):
        _, ledger = _make_ledger(rt, 10)
        with _Delivered(rt):
            for i in range(10):
                ledger.record_trace(i, f"r0.mb{i}")
            for i in (1, 0, 2, 3, 4, 5, 6, 7):
                ledger.ack(i, np.zeros(1))
                ledger.maybe_snapshot()
        return ledger.snapshots, ledger.forensics(), ledger.trace_of(8)

    snapshots, forensics, rid = _both(case)
    assert snapshots == 1 and forensics["pending_mbids"] == [8, 9]
    assert rid == "r0.mb8"


# -- the gray chaos grammar (tests/test_gray_failures.py) ----------------

def test_chaos_grammar_gray_faults_equal_jax():
    def case(rt, fo, ch):
        return (_spec(ch, "slow@2:80;jitter@3-9:40;corrupt@5"),
                _spec(ch, "slow@2-12:80"), _spec(ch, "jitter@2:"))

    got = _both(case)
    assert got[0][1] == ("jitter", 3, 40.0, 9) and got[2][0][2] == 0


@pytest.mark.parametrize("bad", ["slow@x:80", "jitter@2-z:10", "corrupt@",
                                 "wat@3"])
def test_chaos_grammar_rejects_bad_gray_clauses_as_jax(bad):
    msgs = []
    for ch in (tchaos, jchaos):
        with pytest.raises(ValueError) as exc:
            ch.ChaosSpec.parse(bad)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_corrupt_flips_one_bit_of_the_largest_tensor_in_a_copy():
    """corrupt@K's flip (below the integrity layer): the same bytes as the
    JAX transport's, one bit of the largest tensor, the caller's arrays
    untouched."""
    from pipeedge_tpu.comm import dcn as jdcn
    tensors = [np.asarray(7, np.int64),
               np.arange(64, dtype=np.float32).reshape(4, 16)]
    keep = [t.copy() for t in tensors]
    got = dcn._flip_one_bit(tensors)
    want = jdcn._flip_one_bit(tensors)
    assert [t.tobytes() for t in got] == [t.tobytes() for t in want]
    diff = np.unpackbits(np.frombuffer(got[1].tobytes(), np.uint8)
                         ^ np.frombuffer(keep[1].tobytes(), np.uint8))
    assert diff.sum() == 1 and got[0].tobytes() == keep[0].tobytes()
    assert all(a.tobytes() == b.tobytes() for a, b in zip(tensors, keep))


# -- property: the planners agree on random fleets -----------------------

@st.composite
def _fleets(draw):
    world = draw(st.integers(1, 7))
    n_stages = draw(st.integers(1, world))
    n_layers = draw(st.integers(n_stages, 4 * n_stages + 4))
    cuts = sorted(draw(st.sets(st.integers(1, n_layers - 1),
                               min_size=n_stages - 1,
                               max_size=n_stages - 1))) \
        if n_stages > 1 else []
    bounds = [0] + cuts + [n_layers]
    layers = [(bounds[i] + 1, bounds[i + 1]) for i in range(n_stages)]
    quant = draw(st.lists(st.sampled_from([0, 2, 4, 8, 16]),
                          min_size=n_stages, max_size=n_stages))
    ranks = draw(st.permutations(range(world)))[:n_stages]
    dead = draw(st.sets(st.integers(0, world - 1)))
    benched = draw(st.sets(st.integers(0, world - 1)))
    return layers, quant, list(ranks), world, dead, benched


@settings(max_examples=300, deadline=None)
@given(_fleets(), st.booleans())
def test_planners_agree_on_random_fleets(fleet, with_pre):
    layers, quant, ranks, world, dead, benched = fleet
    planned = [fo.plan_failover(layers, quant, ranks, world, dead,
                                benched=benched)
               for fo in (tfailover, jfailover)]
    assert planned[0] == planned[1]
    current = planned[0] or (layers, quant, ranks)
    pre = (layers, quant, ranks) if with_pre else None
    healed = [fo.plan_rejoin(current, pre, world, dead)
              for fo in (tfailover, jfailover)]
    assert healed[0] == healed[1]


# -- the JOIN admission keeps the restarted incarnation's live links ------

def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_admission_keeps_links_dialed_to_the_new_incarnation():
    """A restarted rank beats its peers before its JOIN; a peer echoes
    the beat over a connection it dials to the NEW listener. Admitting
    the JOIN must drop only connections to the old incarnation: closing
    the echo's made the new incarnation take the drop for the peer's
    death and fence it, and every later command from the peer (a
    CMD_SCHED) was dropped as stale."""
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    cmds = queue.Queue()
    peer = dcn.DistDcnContext(2, 0, addrs)
    peer.init()
    old = dcn.DistDcnContext(2, 1, addrs)
    old.init()
    new = None
    try:
        peer.send_tensors(1, [np.zeros(1, np.float32)])
        old.recv_tensors(0, timeout=10)
        old.shutdown()
        deadline = time.monotonic() + 10
        while 1 not in peer.dead_ranks():
            # a send to the dead rank fails and declares it
            try:
                peer.send_tensors(1, [np.zeros(1, np.float32)])
            except OSError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.05)
        new = dcn.DistDcnContext(2, 1, addrs, epoch=1,
                                 cmd_handler=lambda c, t: cmds.put(c))
        new.init()
        new.start_heartbeat([0], interval=0.1, miss_threshold=50)
        deadline = time.monotonic() + 10
        while peer._cmd_conns.get(1) is None:     # the echo's dial
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert new.announce_join([0]) == [0]
        deadline = time.monotonic() + 10
        while 1 in peer.dead_ranks():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        time.sleep(0.5)
        assert not new.dead_ranks()
        peer.cmd_broadcast(trt.CMD_SCHED, [np.asarray(5, np.int32)])
        assert cmds.get(timeout=10) == trt.CMD_SCHED
    finally:
        for ctx in (new, old, peer):
            if ctx is not None:
                ctx.shutdown()


@pytest.mark.parametrize("tier", ["local", "socket"])
def test_chaos_counts_a_stage_s_sends_on_every_tier(tier, monkeypatch):
    """`@K` counts `send_tensors` calls on the wrapped context, and every
    send of a `DcnPipelineStage` goes through it — the colocated tier's
    hand-off included — so `drop@2` drops exactly the stage's second
    microbatch."""
    monkeypatch.setenv(dcn.ENV_LOCAL_HANDOFF, "1" if tier == "local"
                       else "0")
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    ctxs = [dcn.DistDcnContext(2, r, addrs) for r in range(2)]
    for c in ctxs:
        c.init()
    try:
        assert ctxs[0].negotiate_edge_path(1, timeout=10) == (
            dcn.PATH_LOCAL if tier == "local" else dcn.PATH_ZEROCOPY)
        monkeypatch.setenv(tchaos.ENV_CHAOS, "drop@2")
        tchaos.maybe_install(ctxs[0])
        stage = dcn.DcnPipelineStage(ctxs[0], None, 1,
                                     work_cb=lambda ts: ts)
        stage.start()
        for i in range(3):
            stage.enqueue_tensors([np.full(2, i, np.float32)])
        got = [float(np.asarray(ctxs[1].recv_tensors(0, timeout=10)[0])[0])
               for _ in range(2)]
        stage.stop()
        assert got == [0.0, 2.0]
    finally:
        for c in ctxs:
            c.shutdown()


def test_drop_queued_releases_a_reader_parked_on_a_stale_channel():
    """Two late frames on a channel nobody reads any more (a finished
    round's results) park the connection's reader on the full queue, and
    the next round's frame behind them never arrives; dropping the stale
    channel's frames lets it through."""
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    ctxs = [dcn.DistDcnContext(2, r, addrs) for r in range(2)]
    for c in ctxs:
        c.init()
    stale, current = dcn.CHANNEL_RESULTS, dcn.CHANNEL_RESULTS + 8
    try:
        for i in range(2):
            ctxs[1].send_tensors(0, [np.full(1, i, np.float32)],
                                 channel=stale)
        ctxs[1].send_tensors(0, [np.full(1, 7, np.float32)],
                             channel=current)
        with pytest.raises(queue.Empty):
            ctxs[0].recv_tensors(1, timeout=1.0, channel=current)
        dropped = 0
        deadline = time.monotonic() + 10
        while dropped < 2 and time.monotonic() < deadline:
            dropped += ctxs[0].drop_queued(stale)
            time.sleep(0.05)
        assert dropped == 2
        got = ctxs[0].recv_tensors(1, timeout=10, channel=current)
        assert float(np.asarray(got[0])[0]) == 7.0
        assert ctxs[0].drop_queued(stale, src=1) == 0
    finally:
        for c in ctxs:
            c.shutdown()
