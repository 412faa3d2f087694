"""The port's cross-process prefill fleet (`pipeedge_tpu_torch/kv/fleet.py`)
against the JAX package's (`pipeedge_tpu/kv/fleet.py`).

The cases of `tests/test_kv_fleet.py`, run through the port, on
`pipeedge/test-tiny-gpt2` in two stages (`-pt 1,4,5,8`), max_len 48, f32,
with the seeded weights both packages draw per shard when no weights file
is given (the JAX shards carried to the port by `params_from_jax`):

- the lease/ack/cancel headers, byte-equal to the JAX package's;
- leases over real sockets: greedy tokens equal to the JAX
  `DecodePipeline.generate`, a sampled request equal to the port's own
  solo run (sampling differs between the packages by design, ROADMAP §C);
- the fault matrix: a CRC-corrupt ship re-shipped once, every ship
  corrupt -> colocated fallback, a worker's death mid-lease re-dispatched
  to a survivor, the zombie-ack fence, a cancelled lease skipped, a
  failed prompt pass acked as an error;
- a `python -m pipeedge_tpu_torch.prefill_worker --device cpu` process
  SIGKILLed mid-burst: every request completes with the JAX greedy
  tokens and no page leaks;
- mixed fleets: a JAX `PrefillWorkerLoop` on its own JAX context serves
  the port's `RemotePrefillFleet`, and the port's loop serves the JAX
  fleet, each answer equal to the JAX greedy run.

Tokens are compared exactly. Contexts run with the local hand-off tier
off, so the in-process planes ride the socket path (where the CRC layer
and the corrupt hook live), as the JAX tests' do.
"""
import os
import queue as queue_mod
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from pipeedge_tpu.comm import dcn as jdcn
from pipeedge_tpu.kv import PagedKvBackend as JBackend
from pipeedge_tpu.kv import PrefillWorkerLoop as JWorkerLoop
from pipeedge_tpu.kv import RemotePrefillFleet as JFleet
from pipeedge_tpu.kv import fleet as jfleet_mod
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import batcher as jbatcher
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.telemetry import metrics as jprom
from pipeedge_tpu_torch.comm import dcn
from pipeedge_tpu_torch.kv import (PagedKvBackend, PrefillUnavailable,
                                   PrefillWorkerLoop, RemotePrefillFleet)
from pipeedge_tpu_torch.kv import fleet as fleet_mod
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel.batcher import ContinuousBatcher
from pipeedge_tpu_torch.telemetry import metrics as prom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pipeedge/test-tiny-gpt2"
PARTITION = [(1, 4), (5, 8)]
MAX_LEN = 48


@pytest.fixture(scope="module")
def pipes():
    """{"jax": JAX pipeline, "jax_prefill": a second JAX pipeline,
    "torch": the port's decode pipeline, "prefill": the port's prefill
    pipeline}, on the weights a worker process draws."""
    jparams = [jreg.module_shard_factory(MODEL, None, l, r, stage=i,
                                         unroll=False)[1]
               for i, (l, r) in enumerate(PARTITION)]
    tparams = [params_from_jax(jax.device_get(p)) for p in jparams]
    jfamily = jreg.get_model_entry(MODEL).family.FAMILY
    jcfg = jreg.get_model_config(MODEL)
    tfamily = treg.get_model_entry(MODEL).family.FAMILY
    tcfg = treg.get_model_config(MODEL)

    def port():
        return tdec.DecodePipeline(tfamily, tcfg, PARTITION, tparams,
                                   max_len=MAX_LEN, device="cpu")

    def jax_pipe():
        return jdec.DecodePipeline(jfamily, jcfg, PARTITION, jparams,
                                   max_len=MAX_LEN)

    return {"jax": jax_pipe(), "jax_prefill": jax_pipe(), "torch": port(),
            "prefill": port()}


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _contexts(classes):
    """One context per class (rank order), on free loopback ports, with
    the local hand-off tier off."""
    addrs = [("127.0.0.1", p) for p in _free_ports(len(classes))]
    before = os.environ.get("DCN_LOCAL_HANDOFF")
    os.environ["DCN_LOCAL_HANDOFF"] = "0"
    try:
        ctxs = [cls(len(classes), r, addrs) for r, cls in enumerate(classes)]
    finally:
        if before is None:
            os.environ.pop("DCN_LOCAL_HANDOFF", None)
        else:
            os.environ["DCN_LOCAL_HANDOFF"] = before
    for c in ctxs:
        c.init()
    return ctxs


def _backend(pipe, n_pages=24, page_size=4):
    return PagedKvBackend(pipe, n_pages, page_size, registry=prom.Registry())


def _jax_greedy(pipes, ids, n):
    return np.asarray(pipes["jax"].generate(ids, n))


def _decode(pipes, rid, ids, n, **kw):
    """One request through the port's paged wave executor."""
    batcher = ContinuousBatcher(pipes["torch"], kv=_backend(pipes["torch"]))
    batcher.submit(rid, ids, new_tokens=n, **kw)
    return batcher.run()[rid]


class _ShipPlane:
    """One port decode rank + N in-process port worker ranks over real
    sockets: the stand-in for the subprocess fleet (same frames, same
    transport)."""

    def __init__(self, prefill_pipe, n_workers=1, start=True, **fleet_kw):
        self.ctxs = _contexts([dcn.DistDcnContext] * (1 + n_workers))
        self.workers = [PrefillWorkerLoop(prefill_pipe, self.ctxs[r])
                        for r in range(1, 1 + n_workers)]
        self.threads = []
        if start:
            for i, w in enumerate(self.workers):
                t = threading.Thread(target=w.run, daemon=True,
                                     name=f"test-prefill-w{i}")
                t.start()
                self.threads.append(t)
        fleet_kw.setdefault("registry", prom.Registry())
        fleet_kw.setdefault("lease_timeout_s", 30.0)
        self.fleet = RemotePrefillFleet(
            self.ctxs[0], ranks=range(1, 1 + n_workers),
            dtype=prefill_pipe.dtype, device="cpu", **fleet_kw)

    def close(self):
        self.fleet.close()
        for w in self.workers:
            w.stop()
        for t in self.threads:
            t.join(timeout=10)
        for c in self.ctxs:
            c.shutdown()


# ---------------------------------------------------------------------------
# protocol codec
# ---------------------------------------------------------------------------

def test_lease_ack_cancel_headers_equal_jax():
    for mod in (fleet_mod, jfleet_mod):
        hdr = mod.lease_header(7, 2, 8, True, 1500.0)
        assert mod.parse_lease_header(hdr) == {
            "lease_id": 7, "attempt": 2, "ship_bits": 8, "crc": True,
            "deadline_ms": 1500}
        assert mod.parse_ack_header(mod.ack_header(7, 2, 0)) == {
            "lease_id": 7, "attempt": 2, "status": 0}
        assert mod.parse_cancel_header(mod.cancel_header(9)) == 9
        with pytest.raises(ValueError, match="magic"):
            mod.parse_lease_header(np.asarray([1, 2, 3], np.int64))
        with pytest.raises(ValueError, match="magic"):
            mod.parse_ack_header(hdr)     # a lease is not an ack
    for make in ("lease_header", "ack_header", "cancel_header"):
        args = {"lease_header": (7, 2, 8, True, 1500.0),
                "ack_header": (7, 2, fleet_mod.ACK_ERROR),
                "cancel_header": (9,)}[make]
        mine, theirs = (getattr(fleet_mod, make)(*args),
                        getattr(jfleet_mod, make)(*args))
        assert mine.dtype == theirs.dtype
        assert mine.tobytes() == theirs.tobytes()
    assert (fleet_mod.CH_LEASE, fleet_mod.CH_SHIP, fleet_mod.CH_CANCEL) \
        == (jfleet_mod.CH_LEASE, jfleet_mod.CH_SHIP, jfleet_mod.CH_CANCEL) \
        == (4, 5, 6)
    assert max(4, 5, 6) < dcn.CHANNEL_ROUND_PARITY
    assert fleet_mod.LEASE_OUTCOMES == jfleet_mod.LEASE_OUTCOMES


# ---------------------------------------------------------------------------
# happy path: cross-context ship, token parity
# ---------------------------------------------------------------------------

def test_remote_prefill_token_parity(pipes):
    """Leases over real sockets: the greedy request equals the JAX greedy
    run, the sampled one the port's own solo run with its seed."""
    plane = _ShipPlane(pipes["prefill"])
    try:
        ids = np.random.default_rng(41).integers(0, 100, size=(1, 7))
        kv = _backend(pipes["torch"])
        batcher = ContinuousBatcher(pipes["torch"], kv=kv)
        batcher.submit("greedy", ids, new_tokens=6,
                       shipped=plane.fleet.prefill(ids, rid="greedy"))
        batcher.submit("sampled", ids, new_tokens=5, temperature=0.9,
                       seed=6,
                       shipped=plane.fleet.prefill(ids, rid="sampled"))
        results = batcher.run()
        np.testing.assert_array_equal(results["greedy"],
                                      _jax_greedy(pipes, ids, 6))
        np.testing.assert_array_equal(
            results["sampled"],
            pipes["torch"].generate(ids, 5, temperature=0.9,
                                    seed=6).numpy())
        snap = plane.fleet.snapshot()
        assert snap["leases"]["shipped"] == 2
        assert snap["leases"]["fallback"] == 0
        assert snap["zombies_dropped_total"] == 0
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# the ship fault matrix
# ---------------------------------------------------------------------------

def test_crc_corrupt_ship_bounded_resend_then_success(pipes):
    """The first ack's KV payload takes a flipped bit (the corrupt hook,
    below the integrity layer); `decode_kv_ship` raises
    `WireCorruptError` and the fleet re-leases once: the clean re-ship
    installs with the JAX greedy tokens."""
    plane = _ShipPlane(pipes["prefill"], crc=True)
    try:
        plane.ctxs[1].send_retries = 0
        plane.ctxs[1]._corrupt_next_send = True
        ids = np.random.default_rng(43).integers(0, 100, size=(1, 6))
        handle = plane.fleet.prefill(ids, rid="crc")
        np.testing.assert_array_equal(
            _decode(pipes, "crc", ids, 5, shipped=handle),
            _jax_greedy(pipes, ids, 5))
        snap = plane.fleet.snapshot()
        assert snap["ship_corrupt_total"] == 1
        assert snap["leases"]["corrupt_retry"] == 1
        assert snap["leases"]["shipped"] == 1
    finally:
        plane.close()


def test_resend_exhaustion_degrades_to_colocated_with_parity(pipes):
    """Every ship corrupt: the retry budget runs out, the caller falls
    back to COLOCATED prefill (no `shipped`), and the tokens still equal
    the JAX greedy run."""
    plane = _ShipPlane(pipes["prefill"], crc=True, max_attempts=2)
    try:
        wctx = plane.ctxs[1]
        orig_send = wctx.send_tensors

        def corrupt_every_send(dst, tensors, channel=0, **kw):
            wctx._corrupt_next_send = True
            return orig_send(dst, tensors, channel=channel, **kw)

        wctx.send_tensors = corrupt_every_send
        ids = np.random.default_rng(47).integers(0, 100, size=(1, 8))
        kw = {}
        try:
            kw["shipped"] = plane.fleet.prefill(ids, rid="exhaust")
        except PrefillUnavailable:
            pass        # the serving layer's colocated fallback
        assert "shipped" not in kw, "corrupt ships should have exhausted"
        np.testing.assert_array_equal(_decode(pipes, "exhaust", ids, 4, **kw),
                                      _jax_greedy(pipes, ids, 4))
        snap = plane.fleet.snapshot()
        assert snap["leases"]["fallback"] == 1
        assert snap["ship_corrupt_total"] == 2      # one per attempt
    finally:
        plane.close()


def test_worker_death_mid_lease_redispatches_to_survivor(pipes):
    """Rank 1 swallows its lease (no ack) and dies; the fleet resolves the
    stranded lease at once (no 60 s timeout), re-dispatches to rank 2,
    and the request completes with the JAX greedy tokens."""
    plane = _ShipPlane(pipes["prefill"], n_workers=2, start=False,
                       lease_timeout_s=60.0,
                       heartbeat_interval=0.3, heartbeat_miss=3)
    try:
        # workers beat the decode rank as the CLI does: beat SILENCE is
        # how a black-holed peer's death shows at all
        for wctx in plane.ctxs[1:]:
            wctx.start_heartbeat([0], interval=0.3, miss_threshold=10)
        stop_hole = threading.Event()

        def black_hole():
            while not stop_hole.is_set():
                try:
                    plane.ctxs[1].recv_tensors(0, timeout=0.2,
                                               channel=fleet_mod.CH_LEASE)
                except (queue_mod.Empty, ConnectionError, OSError):
                    continue

        hole = threading.Thread(target=black_hole, daemon=True)
        hole.start()
        t2 = threading.Thread(target=plane.workers[1].run, daemon=True)
        t2.start()
        plane.threads.append(t2)
        plane.fleet._rr = 1     # the first dispatch lands on doomed rank 1
        ids = np.random.default_rng(53).integers(0, 100, size=(1, 6))
        killer_fired = threading.Event()

        def kill_rank1():
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if plane.fleet.snapshot()["in_flight"] >= 1:
                    break
                time.sleep(0.05)
            time.sleep(0.2)     # let the black hole swallow the lease
            stop_hole.set()
            plane.ctxs[1].shutdown()
            killer_fired.set()

        killer = threading.Thread(target=kill_rank1, daemon=True)
        killer.start()
        t0 = time.monotonic()
        handle = plane.fleet.prefill(ids, rid="death")
        took = time.monotonic() - t0
        assert killer_fired.wait(timeout=30)
        assert took < 45.0      # driven by the death, not the timeout
        np.testing.assert_array_equal(
            _decode(pipes, "death", ids, 4, shipped=handle),
            _jax_greedy(pipes, ids, 4))
        snap = plane.fleet.snapshot()
        assert snap["leases"]["redispatched"] >= 1
        assert snap["leases"]["shipped"] == 1
        assert 1 in snap["dead"]
    finally:
        plane.close()


def test_zombie_ack_stale_attempt_is_fenced():
    """An ack for an unknown lease, a stale attempt or an already resolved
    lease drops (counted), never resolves: the lease fence, on a stub
    context so socket timing stays out of it."""

    class _StubCtx:
        CONNECT_TIMEOUT = 60.0

        def register_peer_death_handler(self, h):
            pass

        def register_peer_rejoin_handler(self, h):
            pass

        def negotiate_edge_path(self, dst, timeout=None):
            raise queue_mod.Empty

        def stop_heartbeat(self):
            pass

        def recv_tensors(self, src, timeout=None, channel=0):
            raise queue_mod.Empty

    fleet = RemotePrefillFleet(_StubCtx(), ranks=[1], dtype=torch.float32,
                               registry=prom.Registry(), device="cpu")
    try:
        fleet._resolve({"lease_id": 99, "attempt": 1, "status": 0}, [])
        assert fleet.snapshot()["zombies_dropped_total"] == 1
        ls = fleet_mod._Lease(5, 2, 1, "r5")
        with fleet._lock:
            fleet._leases[5] = ls
        fleet._resolve({"lease_id": 5, "attempt": 1, "status": 0},
                       [np.zeros(3)])
        assert not ls.event.is_set(), "stale ack resolved a live lease"
        assert fleet.snapshot()["zombies_dropped_total"] == 2
        fleet._resolve({"lease_id": 5, "attempt": 2, "status": 0},
                       [np.zeros(3)])
        assert ls.event.is_set() and ls.tensors is not None
        fleet._resolve({"lease_id": 5, "attempt": 2, "status": 0},
                       [np.ones(3)])
        assert fleet.snapshot()["zombies_dropped_total"] == 3
        np.testing.assert_array_equal(ls.tensors[0], np.zeros(3))
    finally:
        fleet.close()


def test_cancelled_lease_skipped_not_executed(pipes):
    """A lease cancelled before it ran (the cancel overtakes it on its own
    channel) is SKIPPED by the worker; the next lease is served."""
    ctxs = _contexts([dcn.DistDcnContext] * 2)
    calls = []
    prefill = pipes["prefill"]

    class _Spy:
        cache_bits = 0
        dtype = prefill.dtype
        device = prefill.device

        def _ids(self, ids):
            return prefill._ids(ids)

        def _prefill(self, ids):
            calls.append(tuple(ids.shape))
            return prefill._prefill(ids)

    worker = PrefillWorkerLoop(_Spy(), ctxs[1])
    t = threading.Thread(target=worker.run, daemon=True)
    try:
        ctxs[0].send_tensors(1, [fleet_mod.cancel_header(7)],
                             channel=fleet_mod.CH_CANCEL)
        ctxs[0].send_tensors(
            1, [fleet_mod.lease_header(7, 1, 0, False, 1000),
                np.zeros((1, 4), np.int64)], channel=fleet_mod.CH_LEASE)
        ctxs[0].send_tensors(
            1, [fleet_mod.lease_header(9, 1, 0, False, 1000),
                np.ones((1, 5), np.int64)], channel=fleet_mod.CH_LEASE)
        t.start()
        tensors = ctxs[0].recv_tensors(1, timeout=60.0,
                                       channel=fleet_mod.CH_SHIP)
        ack = fleet_mod.parse_ack_header(tensors[0])
        assert ack["lease_id"] == 9 and ack["status"] == fleet_mod.ACK_OK
        assert worker.leases_cancelled == 1
        assert calls == [(1, 5)], "the cancelled lease ran a prompt pass"
    finally:
        worker.stop()
        t.join(timeout=10)
        for c in ctxs:
            c.shutdown()


class _Boom:
    cache_bits = 0
    device = torch.device("cpu")

    def _ids(self, ids):
        return torch.as_tensor(ids)

    def _prefill(self, ids):
        raise RuntimeError("poisoned prompt")


def test_worker_error_ack_counts_redispatch(pipes):
    """A worker whose prompt pass FAILS acks with an error status (silence
    would cost the whole lease timeout); the fleet re-dispatches once and
    then falls back."""
    plane = _ShipPlane(pipes["prefill"], max_attempts=2)
    try:
        plane.workers[0].pipe = _Boom()
        t0 = time.monotonic()
        with pytest.raises(PrefillUnavailable):
            plane.fleet.prefill(np.zeros((1, 4), np.int64), rid="boom")
        assert time.monotonic() - t0 < 25.0     # acked, not timed out
        snap = plane.fleet.snapshot()
        assert snap["leases"]["redispatched"] == 1
        assert snap["leases"]["fallback"] == 1
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# mixed fleets: either package's worker serves the other's fleet
# ---------------------------------------------------------------------------

def _jax_decode(pipes, rid, ids, n, shipped):
    kv = JBackend(pipes["jax"], 24, 4, registry=jprom.Registry())
    batcher = jbatcher.ContinuousBatcher(pipes["jax"], kv=kv)
    batcher.submit(rid, ids, new_tokens=n, shipped=shipped)
    return np.asarray(batcher.run()[rid])


@pytest.mark.parametrize("worker_pkg", ["jax", "torch"])
def test_mixed_fleet_serves_the_other_package(pipes, worker_pkg):
    """A JAX worker loop on its own JAX context serves the port's fleet,
    and the port's loop serves the JAX fleet: the frames are one
    protocol, and each answer equals the JAX greedy run."""
    if worker_pkg == "jax":
        ctxs = _contexts([dcn.DistDcnContext, jdcn.DistDcnContext])
        worker = JWorkerLoop(pipes["jax_prefill"], ctxs[1])
        fleet = RemotePrefillFleet(ctxs[0], ranks=[1],
                                   dtype=pipes["torch"].dtype,
                                   registry=prom.Registry(), device="cpu")
    else:
        ctxs = _contexts([jdcn.DistDcnContext, dcn.DistDcnContext])
        worker = PrefillWorkerLoop(pipes["prefill"], ctxs[1])
        fleet = JFleet(ctxs[0], ranks=[1], dtype=pipes["jax"].dtype,
                       registry=jprom.Registry())
    t = threading.Thread(target=worker.run, daemon=True)
    t.start()
    try:
        ids = np.random.default_rng(71).integers(0, 100, size=(1, 7))
        handle = fleet.prefill(ids, rid="mixed")
        got = (_decode(pipes, "mixed", ids, 5, shipped=handle)
               if worker_pkg == "jax"
               else _jax_decode(pipes, "mixed", ids, 5, handle))
        np.testing.assert_array_equal(got, _jax_greedy(pipes, ids, 5))
        assert fleet.snapshot()["leases"]["shipped"] == 1
    finally:
        fleet.close()
        worker.stop()
        t.join(timeout=10)
        for c in ctxs:
            c.shutdown()


# ---------------------------------------------------------------------------
# chaos acceptance: kill a REAL prefill worker process mid-burst
# ---------------------------------------------------------------------------

@pytest.mark.fleet
def test_chaos_prefill_process_killed_midburst_all_requests_survive(
        pipes):
    """Two `python -m pipeedge_tpu_torch.prefill_worker --device cpu`
    processes over DCN sockets; one is SIGKILLed with a burst of leases
    in flight. Every request completes (re-dispatch or colocated
    fallback) with the JAX greedy tokens, and the pool accounts for every
    page afterwards (zero leaks after the orphan sweep)."""
    world = 3
    addrs = [("127.0.0.1", p) for p in _free_ports(world)]
    addr_arg = ",".join(f"127.0.0.1:{p}" for _, p in addrs)
    env = dict(os.environ, PYTHONPATH=REPO, DCN_CONNECT_TIMEOUT="30",
               OMP_NUM_THREADS="1")
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "pipeedge_tpu_torch.prefill_worker",
             str(r), str(world), "--dcn-addrs", addr_arg, "-m", MODEL,
             "-pt", "1,4,5,8", "--max-len", str(MAX_LEN), "-t", "float32",
             "--heartbeat-interval", "0.5", "--device", "cpu"],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=REPO)
        for r in (1, 2)]
    ctx = dcn.DistDcnContext(world, 0, addrs)
    ctx.init()
    fleet = RemotePrefillFleet(ctx, ranks=[1, 2], dtype=torch.float32,
                               lease_timeout_s=10.0,
                               heartbeat_interval=0.5, heartbeat_miss=4,
                               registry=prom.Registry(), device="cpu")
    kv = _backend(pipes["torch"], n_pages=24, page_size=4)
    batcher = ContinuousBatcher(pipes["torch"], kv=kv)
    try:
        rng = np.random.default_rng(59)
        prompts = [rng.integers(0, 100, size=(1, 6)) for _ in range(6)]
        lock = threading.Lock()
        shipped = {}

        def prefill_one(i):
            kw = {}
            try:
                kw["shipped"] = fleet.prefill(prompts[i], rid=f"b{i}")
            except PrefillUnavailable:
                pass       # colocated fallback: submit without shipped
            with lock:
                shipped[i] = kw

        threads = [threading.Thread(target=prefill_one, args=(i,),
                                    daemon=True) for i in range(6)]
        for t in threads[:2]:
            t.start()
        time.sleep(0.3)
        os.kill(workers[0].pid, signal.SIGKILL)
        for t in threads[2:]:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "a prefill call never returned"
        for i in range(6):
            batcher.submit(i, prompts[i], new_tokens=4,
                           **shipped.get(i, {}))
        results = batcher.run()
        assert len(results) == 6, "a request was lost to the fault"
        for i in range(6):
            np.testing.assert_array_equal(
                results[i], _jax_greedy(pipes, prompts[i], 4))
        assert kv.sweep_orphans(set()) == 0
        assert kv.pool.stats()["leaked"] == 0
        cached = kv.trie.stats()["pages_cached"]
        assert kv.pool.free_pages + cached == kv.pool.n_pages
        snap = fleet.snapshot()
        assert 1 in snap["dead"]
        assert snap["leases"]["shipped"] >= 1
    finally:
        fleet.close()
        ctx.shutdown()
        for w in workers:
            if w.poll() is None:
                w.terminate()
            try:
                w.wait(timeout=30)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
            w.stdout.close()
