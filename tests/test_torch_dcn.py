"""The port's DCN transport (`pipeedge_tpu_torch/comm/dcn.py`).

The cases of tests/test_dcn.py against the port's context: framing of
every dtype code (bfloat16 and the nibble-packed int4/uint4 without
`ml_dtypes`, as `wire.WireArray`), the context's P2P and command paths,
the three transport tiers, liveness (heartbeats, grace, epoch fencing,
JOIN), send retries, frame-integrity resends, bitwidth negotiation and
the pipeline stage (contract, FIFO at depth 2, overlap, stop while
blocked). Besides those: every frame the port writes equals the JAX
package's frame byte for byte, and a JAX context and a port context in
one process exchange frames and commands both ways.
"""
import queue
import socket
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pipeedge_tpu.comm import dcn as jdcn
from pipeedge_tpu_torch.comm import CMD_SCHED, CMD_STOP
from pipeedge_tpu_torch.comm import dcn
from pipeedge_tpu_torch.comm import wire
from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.models import vit as tvit


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _make_contexts(n, handlers=None, **kw):
    addrs = [("127.0.0.1", p) for p in _free_ports(n)]
    ctxs = [dcn.DistDcnContext(n, r, addrs,
                               cmd_handler=(handlers or {}).get(r), **kw)
            for r in range(n)]
    for c in ctxs:
        c.init()
    return ctxs


def _shutdown(*ctxs):
    for c in ctxs:
        if c is not None:
            c.shutdown()


def _wait_for(predicate, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _frame_bytes(module, tensors, msg_type=1, aux=7, channel=1):
    """The bytes `module._send_frame` writes for `tensors`."""
    a, b = socket.socketpair()
    module._send_frame(a, msg_type, aux, tensors, channel=channel)
    a.close()
    data = bytearray()
    while True:
        chunk = b.recv(1 << 16)
        if not chunk:
            break
        data += chunk
    b.close()
    return bytes(data)


NUMPY_DTYPES = [np.float16, np.float32, np.float64, np.uint8, np.int8,
                np.int16, np.int32, np.int64, np.bool_, np.complex64,
                np.complex128, np.uint16, np.uint32, np.uint64]


# -- framing -----------------------------------------------------------

@pytest.mark.parametrize("dtype", NUMPY_DTYPES)
def test_frame_roundtrip_dtypes(dtype):
    a, b = socket.socketpair()
    arr = np.arange(24).reshape(2, 3, 4).astype(dtype)
    dcn._send_frame(a, dcn._MSG_TENSORS, 7, [arr], channel=1)
    msg_type, aux, channel, out = dcn._recv_frame(b)
    assert msg_type == dcn._MSG_TENSORS and aux == 7 and channel == 1
    np.testing.assert_array_equal(out[0], arr)
    assert out[0].dtype == arr.dtype
    a.close(), b.close()


def test_frame_roundtrip_bfloat16_as_bits():
    """bfloat16 rides as code 14: a CPU torch tensor in, a `WireArray` of
    its 16-bit patterns out, which `wire` turns back into the tensor."""
    t = (torch.arange(24, dtype=torch.float32) / 7).reshape(2, 3, 4).to(
        torch.bfloat16)
    a, b = socket.socketpair()
    dcn._send_frame(a, dcn._MSG_TENSORS, 0, [t])
    _, _, _, out = dcn._recv_frame(b)
    assert out[0].wire_code == wire.CODE_BFLOAT16 and out[0].shape == (2, 3, 4)
    back = wire._from_numpy(out[0], torch.device("cpu"))
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    a.close(), b.close()


@pytest.mark.parametrize("code", [wire.CODE_BFLOAT16, wire.CODE_INT4,
                                  wire.CODE_UINT4] + list(range(14)))
def test_frame_bytes_equal_jax_frame(code):
    """Every dtype code: the port's frame is the JAX package's frame byte
    for byte, and each package reads the other's."""
    rng = np.random.default_rng(code)
    if code == wire.CODE_BFLOAT16:
        j = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
        p = wire.WireArray(j.view(np.int16), code)
    elif code in (wire.CODE_INT4, wire.CODE_UINT4):
        lo = -8 if code == wire.CODE_INT4 else 0
        vals = rng.integers(lo, lo + 16, size=(3, 5)).astype(np.int8)
        j = vals.astype(ml_dtypes.int4 if code == wire.CODE_INT4
                        else ml_dtypes.uint4)
        p = wire.WireArray(vals if code == wire.CODE_INT4
                           else vals.astype(np.uint8), code)
    else:
        j = p = (rng.normal(size=(3, 5)) * 9).astype(NUMPY_DTYPES[code])
    got = _frame_bytes(dcn, [p, np.int64(4).reshape(())])
    assert got == _frame_bytes(jdcn, [j, np.int64(4).reshape(())])
    a, b = socket.socketpair()
    a.sendall(got)
    _, _, _, port_out = dcn._recv_frame(b)
    a.sendall(got)
    _, _, _, jax_out = jdcn._recv_frame(b)
    a.close(), b.close()
    assert getattr(port_out[0], "wire_code", code) == code
    assert port_out[0].tobytes() == np.asarray(p).tobytes()
    assert jax_out[0].dtype == j.dtype
    assert jax_out[0].tobytes() == j.tobytes()


def test_frame_accepts_ml_dtypes_arrays():
    """An array a caller made with ml_dtypes frames under its code."""
    j = np.arange(6).astype(ml_dtypes.bfloat16)
    assert _frame_bytes(dcn, [j]) == _frame_bytes(jdcn, [j])


def test_frame_roundtrip_edge_shapes():
    a, b = socket.socketpair()
    tensors = [np.float32(3.5).reshape(()),                # 0-d
               np.zeros((0, 5), np.int32),                 # zero-size
               np.arange(20, dtype=np.float32)[::2]]       # non-contiguous
    dcn._send_frame(a, dcn._MSG_TENSORS, 0, tensors)
    _, _, _, out = dcn._recv_frame(b)
    assert out[0].shape == () and float(out[0]) == 3.5
    assert out[1].shape == (0, 5)
    np.testing.assert_array_equal(out[2], np.arange(0, 20, 2,
                                                    dtype=np.float32))
    a.close(), b.close()


@pytest.mark.parametrize("code", [wire.CODE_INT4, wire.CODE_UINT4])
def test_frame_roundtrip_4bit_nibble_packed(code):
    """4-bit codes ride nibble-packed: values, code and shape survive,
    including odd counts (pad nibble) and signed values."""
    lo, store = (-8, np.int8) if code == wire.CODE_INT4 else (0, np.uint8)
    a, b = socket.socketpair()
    tensors = [wire.WireArray(np.arange(lo, lo + 15).astype(store), code),
               wire.WireArray(np.arange(lo, lo + 8).astype(store)
                              .reshape(2, 4), code),
               wire.WireArray(np.asarray(5, store).reshape(()), code)]
    dcn._send_frame(a, dcn._MSG_TENSORS, 3, tensors, channel=2)
    msg_type, aux, channel, out = dcn._recv_frame(b)
    assert (msg_type, aux, channel) == (dcn._MSG_TENSORS, 3, 2)
    for sent, got in zip(tensors, out):
        assert got.wire_code == code and got.shape == sent.shape
        assert got.dtype == np.dtype(store)
        np.testing.assert_array_equal(got, sent)
    a.close(), b.close()


def test_frame_4bit_wire_bytes_are_halved():
    n = 64
    sizes = {}
    for name, arr in (("u4", wire.WireArray(np.zeros(n, np.uint8),
                                            wire.CODE_UINT4)),
                      ("i8", np.zeros(n, np.int8))):
        sizes[name] = len(_frame_bytes(dcn, [arr]))
    overhead = dcn._HEADER.size + dcn._TENSOR_HEADER.size + dcn._DIM.size
    assert sizes["i8"] - overhead == n
    assert sizes["u4"] - overhead == n // 2


def test_frame_rejects_unknown_dtype():
    a, b = socket.socketpair()
    with pytest.raises(TypeError):
        dcn._send_frame(a, dcn._MSG_TENSORS, 0,
                        [np.array(["x"], dtype=object)])
    a.close(), b.close()


def test_protocol_table_is_coherent():
    dcn._check_protocol_table()
    assert {k: v for k, v in vars(dcn).items() if k.startswith("_MSG_")} \
        == {k: v for k, v in vars(jdcn).items() if k.startswith("_MSG_")}
    assert dcn.base_channel(dcn.CHANNEL_RESULTS
                            + dcn.CHANNEL_ROUND_PARITY) == dcn.CHANNEL_RESULTS
    assert dcn.parse_rank_addrs("h:1,g:2", 2, 0) == [("h", 1), ("g", 2)]
    assert dcn.parse_rank_addrs(None, 2, 100) == [("127.0.0.1", 100),
                                                  ("127.0.0.1", 101)]


# -- context P2P -------------------------------------------------------

def test_context_send_recv_bidirectional():
    ctxs = _make_contexts(2)
    try:
        x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
        y = np.arange(6, dtype=np.int64)
        ctxs[0].send_tensors(1, [x, y])
        got = ctxs[1].recv_tensors(0, timeout=10)
        np.testing.assert_array_equal(got[0], x)
        np.testing.assert_array_equal(got[1], y)
        ctxs[1].send_tensors(0, [y])
        np.testing.assert_array_equal(ctxs[0].recv_tensors(1, timeout=10)[0],
                                      y)
    finally:
        _shutdown(*ctxs)


def test_self_loop_channels_demultiplex():
    ctxs = _make_contexts(1)
    try:
        a = np.arange(4, dtype=np.float32)
        b = np.arange(8, dtype=np.float32)
        ctxs[0].send_tensors(0, [a], channel=dcn.CHANNEL_DATA)
        ctxs[0].send_tensors(0, [b], channel=dcn.CHANNEL_RESULTS)
        got_b = ctxs[0].recv_tensors(0, timeout=10,
                                     channel=dcn.CHANNEL_RESULTS)
        got_a = ctxs[0].recv_tensors(0, timeout=10, channel=dcn.CHANNEL_DATA)
        np.testing.assert_array_equal(got_a[0], a)
        np.testing.assert_array_equal(got_b[0], b)
    finally:
        _shutdown(*ctxs)


def test_context_lifecycle_reusable():
    ctx = dcn.DistDcnContext(1, 0, [("127.0.0.1", _free_ports(1)[0])])
    for session in range(2):
        with ctx:
            assert ctx.initialized
            x = np.full((3,), session, np.int32)
            ctx.send_tensors(0, [x])
            np.testing.assert_array_equal(ctx.recv_tensors(0, timeout=10)[0],
                                          x)
        assert not ctx.initialized


def test_cmd_broadcast_reaches_all_peers():
    received = {r: queue.Queue() for r in range(3)}
    handlers = {r: (lambda cmd, tensors, _r=r: received[_r].put((cmd,
                                                                 tensors)))
                for r in range(3)}
    ctxs = _make_contexts(3, handlers)
    try:
        sched = np.asarray([[1, 24], [25, 48]], np.int32)
        ctxs[0].cmd_broadcast(CMD_SCHED, [sched])
        for r in (1, 2):
            cmd, tensors = received[r].get(timeout=10)
            assert cmd == CMD_SCHED
            np.testing.assert_array_equal(tensors[0], sched)
        ctxs[0].cmd_broadcast(CMD_STOP)
        for r in (1, 2):
            cmd, tensors = received[r].get(timeout=10)
            assert cmd == CMD_STOP and tensors == ()
        assert received[0].empty()
    finally:
        _shutdown(*ctxs)


def test_send_recv_hooks_measure_wire_bytes():
    ctxs = _make_contexts(2)
    events = {"send_pre": [], "send": [], "recv_pre": [], "recv": []}
    ctxs[0].register_send_hooks(
        lambda dst, ch: events["send_pre"].append((dst, ch)),
        lambda dst, ch, ts: events["send"].append(
            (dst, ch, sum(t.nbytes for t in ts))))
    ctxs[1].register_recv_hooks(
        lambda src, ch: events["recv_pre"].append((src, ch)),
        lambda src, ch, ts: events["recv"].append(
            (src, ch, sum(t.nbytes for t in ts))))
    try:
        x = np.zeros((4, 8), np.float32)
        y = np.arange(6, dtype=np.int64)
        ctxs[0].send_tensors(1, [x, y], channel=dcn.CHANNEL_DATA)
        ctxs[1].recv_tensors(0, timeout=10)
        ctxs[0].cmd_broadcast(CMD_STOP)
        time.sleep(0.3)
        nbytes = x.nbytes + y.nbytes
        assert events["send_pre"] == [(1, dcn.CHANNEL_DATA)]
        assert events["send"] == [(1, dcn.CHANNEL_DATA, nbytes)]
        assert events["recv_pre"] == [(0, dcn.CHANNEL_DATA)]
        assert events["recv"] == [(0, dcn.CHANNEL_DATA, nbytes)]
    finally:
        _shutdown(*ctxs)


def test_context_int8_uint4_bf16_frames_roundtrip():
    ctxs = _make_contexts(2)
    try:
        rng = np.random.default_rng(3)
        i8 = rng.integers(-128, 128, size=(4, 33)).astype(np.int8)
        u4 = wire.WireArray(rng.integers(0, 16, size=(3, 7)).astype(np.uint8),
                            wire.CODE_UINT4)
        bf = torch.from_numpy(rng.normal(size=(2, 5)).astype(
            np.float32)).to(torch.bfloat16)
        ctxs[0].send_tensors(1, [i8, u4, bf])
        got = ctxs[1].recv_tensors(0, timeout=10)
        np.testing.assert_array_equal(got[0], i8)
        assert got[1].wire_code == wire.CODE_UINT4
        np.testing.assert_array_equal(got[1], u4)
        assert torch.equal(wire._from_numpy(got[2], torch.device("cpu")), bf)
    finally:
        _shutdown(*ctxs)


# -- the pipeline stage --------------------------------------------------

def test_three_stage_pipeline_matches_single_shard():
    """Microbatches through 3 DCN stages (3 contexts in one process, the
    tiny ViT cut mid-block) equal the single-shard forward bit for bit."""
    model = "pipeedge/test-tiny-vit"
    cfg = registry.get_model_config(model)
    weights = tvit.random_npz_weights(cfg, seed=5)

    def shard(l, r):
        sc = registry.make_shard_config(model, l, r)
        fn, params, _ = registry.module_shard_factory(
            model, None, l, r, device="cpu",
            params=tvit.load_params(cfg, sc, weights))
        return fn, params

    full_fn, full_params = shard(1, 8)
    fns = [shard(l, r) for l, r in [(1, 3), (4, 5), (6, 8)]]

    def work(k):
        fn, params = fns[k]

        def cb(tensors):
            ts = tuple(torch.from_numpy(np.array(t)) for t in tensors)
            out = fn(params, ts[0] if len(ts) == 1 else ts)
            out = out if isinstance(out, tuple) else (out,)
            return [t.numpy() for t in out]
        return cb

    results = queue.Queue()
    ctxs = _make_contexts(3)
    stages = [dcn.DcnPipelineStage(ctxs[0], None, 1, work(0)),
              dcn.DcnPipelineStage(ctxs[1], 0, 2, work(1)),
              dcn.DcnPipelineStage(ctxs[2], 1, None, work(2),
                                   results_cb=results.put)]
    rng = np.random.default_rng(0)
    ubatches = [rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
                for _ in range(4)]
    try:
        for s in stages:
            s.start()
        for u in ubatches:
            stages[0].enqueue_tensors([u])
        outs = [results.get(timeout=60) for _ in ubatches]
    finally:
        for s in stages:
            s.stop()
        _shutdown(*ctxs)
    for u, out in zip(ubatches, outs):
        expect = full_fn(full_params, torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(out[0], expect)


def test_stage_stop_while_blocked():
    ctxs = _make_contexts(1)
    blocker = threading.Event()

    def slow(tensors):
        blocker.wait(5)
        return tensors

    stage = dcn.DcnPipelineStage(ctxs[0], None, None, slow,
                                 results_cb=lambda x: time.sleep(1))
    try:
        stage.start()
        for _ in range(2):
            stage.enqueue_tensors([np.zeros(2, np.float32)])
        blocker.set()
        stage.stop()
        assert all(not t.is_alive() for t in stage._threads)
    finally:
        _shutdown(*ctxs)


def test_stage_contract_validation():
    ctxs = _make_contexts(1)
    try:
        with pytest.raises(ValueError, match="not both"):
            dcn.DcnPipelineStage(ctxs[0], None, None, work_cb=lambda t: t,
                                 dispatch_cb=lambda t: t)
        with pytest.raises(ValueError, match="requires dispatch_cb"):
            dcn.DcnPipelineStage(ctxs[0], None, None,
                                 readback_cb=lambda t: t)
        with pytest.raises(ValueError, match="depth"):
            dcn.DcnPipelineStage(ctxs[0], None, None, work_cb=lambda t: t,
                                 depth=0)
        with pytest.raises(ValueError, match="needs a"):
            dcn.DcnPipelineStage(ctxs[0], 0, 1)
        dcn.DcnPipelineStage(ctxs[0], None, None).start()
    finally:
        _shutdown(*ctxs)


def test_stage_depth2_preserves_fifo_under_jitter():
    ctxs = _make_contexts(1)
    delays = np.random.default_rng(0).uniform(0.0, 0.01, size=(16, 2))
    results = queue.Queue()
    idx = [0, 0]

    def dispatch(tensors):
        time.sleep(delays[idx[0] % len(delays)][0])
        idx[0] += 1
        return tensors

    def readback(tensors):
        time.sleep(delays[idx[1] % len(delays)][1])
        idx[1] += 1
        return tensors

    stage = dcn.DcnPipelineStage(ctxs[0], None, None, dispatch_cb=dispatch,
                                 readback_cb=readback, depth=2,
                                 results_cb=results.put)
    try:
        stage.start()
        for i in range(16):
            stage.enqueue_tensors([np.full((2,), i, np.int32)])
        outs = [results.get(timeout=30) for _ in range(16)]
    finally:
        stage.stop()
        _shutdown(*ctxs)
    assert [int(o[0][0]) for o in outs] == list(range(16))


def test_stage_overlap_beats_serialized_depth1():
    ctxs = _make_contexts(1)
    work_s = drain_s = 0.02
    n = 12

    def run(depth, split):
        results = queue.Queue()

        def dispatch(tensors):
            time.sleep(work_s)
            return tensors

        def readback(tensors):
            time.sleep(drain_s)
            return tensors

        if split:
            stage = dcn.DcnPipelineStage(
                ctxs[0], None, None, dispatch_cb=dispatch,
                readback_cb=readback, depth=depth, results_cb=results.put)
        else:
            stage = dcn.DcnPipelineStage(
                ctxs[0], None, None, work_cb=lambda t: readback(dispatch(t)),
                depth=depth, results_cb=results.put)
        stage.start()
        try:
            tik = time.monotonic()
            for i in range(n):
                stage.enqueue_tensors([np.full((1,), i, np.int32)])
            outs = [results.get(timeout=60) for _ in range(n)]
            elapsed = time.monotonic() - tik
        finally:
            stage.stop()
        assert [int(o[0][0]) for o in outs] == list(range(n))
        return elapsed

    try:
        serialized = run(depth=1, split=False)
        overlapped = run(depth=2, split=True)
    finally:
        _shutdown(*ctxs)
    assert overlapped < serialized * 0.75, (serialized, overlapped)


# -- peer death on the receive path ------------------------------------

def test_truncated_frame_mid_payload_raises():
    a, b = socket.socketpair()
    a.sendall(b"".join([dcn._HEADER.pack(dcn._MSG_TENSORS, 0, 0, 1),
                        dcn._TENSOR_HEADER.pack(dcn._dtype_code(
                            np.dtype(np.float32)), 1),
                        dcn._DIM.pack(100)]))
    a.sendall(b"\x00" * 40)
    a.close()
    with pytest.raises(ConnectionError, match="peer closed"):
        dcn._recv_frame(b)
    b.close()


def test_context_mid_payload_death_never_yields_garbage():
    ctxs = _make_contexts(2)
    deaths = queue.Queue()
    ctxs[0].register_peer_death_handler(deaths.put)
    try:
        raw = socket.create_connection(ctxs[0]._rank_addrs[0])
        dcn._send_frame(raw, dcn._MSG_HELLO, 1, ())
        raw.sendall(dcn._HEADER.pack(dcn._MSG_TENSORS, 1, 0, 1))
        raw.sendall(dcn._TENSOR_HEADER.pack(
            dcn._dtype_code(np.dtype(np.float32)), 1))
        raw.sendall(dcn._DIM.pack(64))
        raw.sendall(b"\x00" * 16)
        raw.close()
        assert deaths.get(timeout=10) == 1
        with pytest.raises(ConnectionError, match="died"):
            ctxs[0].recv_tensors(1, timeout=10)
    finally:
        _shutdown(*ctxs)


def test_peer_restart_within_grace_reconnects():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    watcher = dcn.DistDcnContext(2, 0, addrs, reconnect_grace=1.5)
    watcher.init()
    deaths = queue.Queue()
    watcher.register_peer_death_handler(deaths.put)
    peer = dcn.DistDcnContext(2, 1, addrs)
    peer.init()
    try:
        peer.send_tensors(0, [np.arange(3, dtype=np.int32)])
        watcher.recv_tensors(1, timeout=10)
        peer.shutdown()
        peer = dcn.DistDcnContext(2, 1, addrs)
        peer.init()
        peer.send_tensors(0, [np.full((2,), 7, np.int32)])
        got = watcher.recv_tensors(1, timeout=10)
        np.testing.assert_array_equal(got[0], np.full((2,), 7, np.int32))
        time.sleep(2.0)
        assert deaths.empty()
        assert not watcher.dead_ranks()
    finally:
        _shutdown(peer, watcher)


def test_grace_window_expires_to_death():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    watcher = dcn.DistDcnContext(2, 0, addrs, reconnect_grace=0.5)
    watcher.init()
    deaths = queue.Queue()
    watcher.register_peer_death_handler(deaths.put)
    peer = dcn.DistDcnContext(2, 1, addrs)
    peer.init()
    try:
        peer.send_tensors(0, [np.zeros(1, np.float32)])
        watcher.recv_tensors(1, timeout=10)
        peer.shutdown()
        assert deaths.get(timeout=10) == 1
        assert 1 in watcher.dead_ranks()
    finally:
        _shutdown(watcher)


@pytest.mark.parametrize("sign", ["frame", "dial"])
def test_late_drop_after_restart_is_not_a_death(sign):
    """A restarted peer's life sign (its HELLO and a frame, or the
    watcher's successful dial to its new listener) can come before the
    watcher's reader sees the old connection drop. The drop is held here
    until that sign is in, deterministically: the grace window must then
    count the sign as a revival, not open after it and expire into a
    death of the live peer."""
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    watcher = dcn.DistDcnContext(2, 0, addrs, reconnect_grace=1.5)
    watcher.init()
    deaths = queue.Queue()
    watcher.register_peer_death_handler(deaths.put)
    held, release = threading.Event(), threading.Event()
    mark_dead = watcher._mark_dead

    def late_mark_dead(*args, **kwargs):
        held.set()
        release.wait(10)
        return mark_dead(*args, **kwargs)

    watcher._mark_dead = late_mark_dead
    peer = dcn.DistDcnContext(2, 1, addrs)
    peer.init()
    try:
        peer.send_tensors(0, [np.arange(3, dtype=np.int32)])
        watcher.recv_tensors(1, timeout=10)
        peer.shutdown()
        assert held.wait(10)
        peer = dcn.DistDcnContext(2, 1, addrs)
        peer.init()
        fresh = np.full((2,), 7, np.int32)
        if sign == "frame":
            peer.send_tensors(0, [fresh])
            got = watcher.recv_tensors(1, timeout=10)
        else:
            watcher.send_tensors(1, [fresh])
            got = peer.recv_tensors(0, timeout=10)
        np.testing.assert_array_equal(got[0], fresh)
        release.set()
        time.sleep(2.0)     # past the grace window
        assert deaths.empty()
        assert not watcher.dead_ranks()
    finally:
        release.set()
        _shutdown(peer, watcher)


# -- liveness plane ----------------------------------------------------

def test_heartbeat_detects_beat_silent_peer():
    ctxs = _make_contexts(2)
    deaths = queue.Queue()
    beats = queue.Queue()
    ctxs[0].register_peer_death_handler(deaths.put)
    ctxs[0].register_heartbeat_hook(beats.put)
    try:
        ctxs[0].start_heartbeat([1], interval=0.2, miss_threshold=3)
        ctxs[1].start_heartbeat([0], interval=0.2, miss_threshold=3)
        assert beats.get(timeout=10) == 1
        ctxs[1].stop_heartbeat()
        assert deaths.get(timeout=10) == 1
        assert 1 in ctxs[0].dead_ranks()
        assert ctxs[0].heartbeat_rtt_stats()[1]["n"] >= 1
    finally:
        _shutdown(*ctxs)


def test_heartbeat_disabled_by_default():
    ctxs = _make_contexts(1)
    try:
        ctxs[0].start_heartbeat([0])
        assert ctxs[0]._hb_thread is None
    finally:
        _shutdown(*ctxs)


def test_stale_epoch_frames_fenced_after_death():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    watcher = dcn.DistDcnContext(2, 0, addrs)
    watcher.init()
    deaths = queue.Queue()
    rejoins = queue.Queue()
    watcher.register_peer_death_handler(deaths.put)
    watcher.register_peer_rejoin_handler(lambda r, e: rejoins.put((r, e)))
    peer = dcn.DistDcnContext(2, 1, addrs)
    peer.init()
    zombie = fresh = None
    try:
        peer.send_tensors(0, [np.arange(3, dtype=np.int32)])
        watcher.recv_tensors(1, timeout=10)
        peer.shutdown()
        assert deaths.get(timeout=10) == 1
        assert watcher.min_epoch_of(1) == 1
        zombie = dcn.DistDcnContext(2, 1, addrs, epoch=0)
        zombie.init()
        zombie.send_tensors(0, [np.full((2,), 6, np.int32)])
        _wait_for(lambda: watcher.stale_frames_dropped >= 1,
                  what="stale frame drop")
        assert 1 in watcher.dead_ranks()
        zombie.shutdown()
        zombie = None
        fresh = dcn.DistDcnContext(2, 1, addrs, epoch=1)
        fresh.init()
        assert fresh.announce_join() == [0]
        assert rejoins.get(timeout=10) == (1, 1)
        assert 1 not in watcher.dead_ranks()
        fresh.send_tensors(0, [np.full((2,), 7, np.int32)])
        got, epoch = watcher.recv_tensors_meta(1, timeout=10)
        np.testing.assert_array_equal(got[0], np.full((2,), 7, np.int32))
        assert epoch == 1
    finally:
        _shutdown(zombie, fresh, watcher)


def test_join_refused_when_accept_joins_off():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    watcher = dcn.DistDcnContext(2, 0, addrs, accept_joins=False)
    watcher.init()
    deaths = queue.Queue()
    rejoins = queue.Queue()
    watcher.register_peer_death_handler(deaths.put)
    watcher.register_peer_rejoin_handler(lambda r, e: rejoins.put((r, e)))
    peer = dcn.DistDcnContext(2, 1, addrs)
    peer.init()
    fresh = None
    try:
        peer.send_tensors(0, [np.zeros(1, np.float32)])
        watcher.recv_tensors(1, timeout=10)
        peer.shutdown()
        assert deaths.get(timeout=10) == 1
        fresh = dcn.DistDcnContext(2, 1, addrs, epoch=1)
        fresh.init()
        fresh.announce_join()
        time.sleep(0.5)
        assert rejoins.empty()
        assert 1 in watcher.dead_ranks()
    finally:
        _shutdown(fresh, watcher)


def test_heartbeat_rewatch_dead_alive_dead():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    watcher = dcn.DistDcnContext(2, 0, addrs)
    watcher.init()
    deaths = queue.Queue()
    beats = queue.Queue()
    watcher.register_peer_death_handler(deaths.put)
    watcher.register_heartbeat_hook(beats.put)
    peer = dcn.DistDcnContext(2, 1, addrs)
    peer.init()
    fresh = None
    try:
        watcher.start_heartbeat([1], interval=0.2, miss_threshold=3)
        peer.start_heartbeat([0], interval=0.2, miss_threshold=3)
        assert beats.get(timeout=10) == 1
        peer.stop_heartbeat()
        peer.shutdown()
        assert deaths.get(timeout=10) == 1
        fresh = dcn.DistDcnContext(2, 1, addrs, epoch=1)
        fresh.init()
        assert fresh.announce_join() == [0]
        _wait_for(lambda: 1 not in watcher.dead_ranks(), what="rejoin")
        while not beats.empty():
            beats.get()
        fresh.start_heartbeat([0], interval=0.2, miss_threshold=3)
        assert beats.get(timeout=10) == 1
        fresh.stop_heartbeat()
        assert deaths.get(timeout=10) == 1
        assert 1 in watcher.dead_ranks()
    finally:
        _shutdown(fresh, watcher)


def test_send_retries_heal_transient_break():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    rx = dcn.DistDcnContext(2, 0, addrs, reconnect_grace=5.0)
    tx = dcn.DistDcnContext(2, 1, addrs, send_retries=2)
    rx.init()
    tx.init()
    deaths = queue.Queue()
    rx.register_peer_death_handler(deaths.put)
    try:
        tx.send_tensors(0, [np.zeros(4, np.float32)])
        rx.recv_tensors(1, timeout=10)
        with tx._conns_lock:
            conn = tx._conns[0]
        conn.shutdown(socket.SHUT_RDWR)
        conn.close()
        tx.send_tensors(0, [np.full((4,), 9, np.float32)])
        got = rx.recv_tensors(1, timeout=10)
        np.testing.assert_array_equal(got[0], np.full((4,), 9, np.float32))
        assert deaths.empty()
        assert tx.send_retry_counts().get(0, 0) >= 1
    finally:
        _shutdown(tx, rx)


# -- frame integrity: seq-addressed resends -----------------------------

def test_corrupt_frame_is_dropped_and_resent(monkeypatch):
    """With PIPEEDGE_WIRE_CRC=1 the reader verifies a CRC-flagged frame,
    drops a corrupt copy and asks its producer for that frame's seq; the
    producer replays the clean frame from its resend cache."""
    monkeypatch.setenv(wire.ENV_WIRE_CRC, "1")
    rx, tx = _make_contexts(2)
    try:
        frame = wire.wire_encode_device(torch.randn(2, 6), 8,
                                        crc=True).finalize()
        tx.send_tensors(0, frame)                      # clean, seq 1
        first = rx.recv_tensors(1, timeout=10)
        bad = [np.array(t) for t in frame]
        bad[1].reshape(-1).view(np.uint8)[0] ^= 1      # flip a word bit
        before = dcn.FRAMES_CORRUPT.value(peer="1")
        with tx._conn_locks[0]:
            conn = tx._ensure_conn(0)
            dcn._send_frame(conn, dcn._MSG_TENSORS, 1, bad,
                            dcn.CHANNEL_DATA)
        replay = rx.recv_tensors(1, timeout=10)
        assert dcn.FRAMES_CORRUPT.value(peer="1") == before + 1
        for a, b in zip(replay, first):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        # a consumer may also ask for a frame by seq itself, once (the
        # cap is max(1, DCN_SEND_RETRIES) replays per frame)
        tx.send_tensors(0, frame)                      # seq 2
        rx.recv_tensors(1, timeout=10)
        rx.request_resend(1, dcn.CHANNEL_DATA, seq=2)
        again = rx.recv_tensors(1, timeout=10)
        assert np.asarray(again[1]).tobytes() == \
            np.asarray(first[1]).tobytes()
    finally:
        _shutdown(rx, tx)


# -- edge bitwidth and transport-tier negotiation ------------------------

def test_edge_bit_negotiation_caps_to_receiver():
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    ctxs = [dcn.DistDcnContext(2, 0, addrs),
            dcn.DistDcnContext(2, 1, addrs, edge_bits_supported=(0, 4, 8))]
    for c in ctxs:
        c.init()
    try:
        assert ctxs[0].negotiate_edge_bits(1, 8) == 8
        assert ctxs[0].negotiate_edge_bits(1, 16) == 8
        assert ctxs[0].negotiate_edge_bits(1, 6) == 4
        assert ctxs[0].negotiate_edge_bits(1, 2) == 0
        assert ctxs[1].negotiate_edge_bits(0, 16) == 16
        assert ctxs[0].negotiate_edge_bits(0, 8) == 8
    finally:
        _shutdown(*ctxs)


@pytest.mark.parametrize("pool", ["1", "0"], ids=["zerocopy", "socket_v2"])
def test_socket_tiers(pool, monkeypatch):
    """Ranks in one process negotiate `local`; with the colocated tier
    off they get the receiver's socket tier (`zerocopy` with pooled
    receive buffers, `socket_v2` without), and frames flow either way."""
    monkeypatch.setenv(dcn.ENV_RECV_POOL, pool)
    monkeypatch.setenv(dcn.ENV_LOCAL_HANDOFF, "0")
    ctxs = _make_contexts(2)
    try:
        want = dcn.PATH_ZEROCOPY if pool == "1" else dcn.PATH_SOCKET_V2
        assert ctxs[0].negotiate_edge_path(1, timeout=10) == want
        x = np.arange(12, dtype=np.float32)
        ctxs[0].send_tensors(1, [x])
        np.testing.assert_array_equal(ctxs[1].recv_tensors(0, timeout=10)[0],
                                      x)
    finally:
        _shutdown(*ctxs)


def test_local_tier_hands_off_tensors():
    """Two contexts in one process agree on `local`: a `DeviceFrame` (the
    encoder's tensors) reaches the consumer's queue as is, with the send
    and receive hooks fired as on a socket."""
    ctxs = _make_contexts(2)
    recv_bytes = []
    ctxs[1].register_recv_hooks(
        None, lambda src, ch, ts: recv_bytes.append(
            sum(int(t.nbytes) for t in ts)))
    try:
        assert ctxs[0].negotiate_edge_path(1, timeout=10) == dcn.PATH_LOCAL
        assert ctxs[0].edge_path(1) == dcn.PATH_LOCAL
        x = torch.randn(3, 4, 8)
        pending = wire.wire_encode_device(x, 8)

        class Fence:                    # stands in for the CUDA event
            waited = 0

            def synchronize(self):
                Fence.waited += 1

        frame = wire.DeviceFrame(pending.device_parts, Fence())
        ctxs[0].send_tensors(1, frame)
        got = ctxs[1].recv_tensors(0, timeout=10)
        assert got[2] is frame[2]                       # no copy
        assert got.event is frame.event                 # the fence travels
        assert recv_bytes == [wire.frame_wire_bytes(frame)]
        wire.wire_decode(got, torch.float32, device="cpu")
        assert Fence.waited == 1
        np.testing.assert_array_equal(
            wire.wire_decode(got, torch.float32, device="cpu").numpy(),
            wire.wire_decode(pending.finalize(), torch.float32,
                             device="cpu").numpy())
    finally:
        _shutdown(*ctxs)


def test_pooled_buffer_reuse_never_changes_a_decoded_frame():
    """A decoded tensor that still references its pooled receive buffer
    keeps that buffer out of rotation: later frames land elsewhere."""
    ctxs = _make_contexts(2)
    try:
        assert ctxs[0].negotiate_edge_path(1, timeout=10) == dcn.PATH_LOCAL
        ctxs[0]._edge_path[1] = dcn.PATH_ZEROCOPY      # force the socket
        first = np.full((64, 64), 3.0, np.float32)
        ctxs[0].send_tensors(1, wire.wire_encode_device(
            torch.from_numpy(first), 0).finalize())
        kept = wire.wire_decode(ctxs[1].recv_tensors(0, timeout=10),
                                torch.float32, device="cpu")
        for k in range(8):
            ctxs[0].send_tensors(1, wire.wire_encode_device(
                torch.full((64, 64), float(k)), 0).finalize())
            out = wire.wire_decode(ctxs[1].recv_tensors(0, timeout=10),
                                   torch.float32, device="cpu")
            assert torch.equal(out, torch.full((64, 64), float(k)))
        np.testing.assert_array_equal(kept.numpy(), first)
    finally:
        _shutdown(*ctxs)


def test_cmd_broadcast_bypasses_backpressured_data_send():
    got = queue.Queue()
    a, b = _make_contexts(2, handlers={1: lambda c, t: got.put(c)})
    try:
        # the socket tier, so the flood fills the kernel buffers
        a._edge_path[1] = dcn.PATH_ZEROCOPY
        big = np.zeros(4 * 1024 * 1024, np.uint8)
        sent = [0]

        def flood():
            try:
                while True:
                    a.send_tensors(1, [big])
                    sent[0] += 1
            except OSError:
                pass

        threading.Thread(target=flood, daemon=True).start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            before = sent[0]
            time.sleep(1.0)
            if sent[0] == before and before > 0:
                break
        assert sent[0] > 0
        tik = time.monotonic()
        a.cmd_broadcast(CMD_STOP)
        elapsed = time.monotonic() - tik
        assert got.get(timeout=10) == CMD_STOP
        assert elapsed < 5, elapsed
    finally:
        _shutdown(a, b)


# -- a JAX rank and a port rank in one process ---------------------------

def test_jax_and_port_contexts_exchange_frames_both_ways():
    """Rank 0 is the JAX package's context, rank 1 the port's: tensor
    frames of every kind arrive byte for byte both ways, commands reach
    the other side's handler, and both handshakes are answered."""
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    jcmds, tcmds = queue.Queue(), queue.Queue()
    j = jdcn.DistDcnContext(2, 0, addrs,
                            cmd_handler=lambda c, t: jcmds.put((c, t)))
    t = dcn.DistDcnContext(2, 1, addrs,
                           cmd_handler=lambda c, ts: tcmds.put((c, ts)))
    j.init()
    t.init()
    try:
        rng = np.random.default_rng(7)
        x = rng.normal(size=(3, 5)).astype(np.float32)
        bf = rng.normal(size=(2, 4)).astype(ml_dtypes.bfloat16)
        i4 = rng.integers(-8, 8, size=(7,)).astype(np.int8)
        jframe = [x, bf, i4.astype(ml_dtypes.int4)]
        tframe = [x, wire.WireArray(bf.view(np.int16), wire.CODE_BFLOAT16),
                  wire.WireArray(i4, wire.CODE_INT4)]
        j.send_tensors(1, jframe)
        got = t.recv_tensors(0, timeout=10)
        for g, w in zip(got, tframe):
            assert getattr(g, "wire_code", None) == getattr(w, "wire_code",
                                                            None)
            assert g.tobytes() == np.asarray(w).tobytes()
        t.send_tensors(0, tframe)
        got = j.recv_tensors(1, timeout=10)
        for g, w in zip(got, jframe):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        # a wire-v2 frame the port encodes decodes in JAX, and the reverse
        pending = wire.wire_encode_device(torch.from_numpy(x), 8)
        t.send_tensors(0, pending.finalize())
        from pipeedge_tpu.comm import wire as jwire
        j_out = np.asarray(jwire.wire_decode(j.recv_tensors(1, timeout=10),
                                             jnp.float32))
        j.send_tensors(1, jwire.wire_encode_device(jnp.asarray(x),
                                                   8).finalize())
        t_out = wire.wire_decode(t.recv_tensors(0, timeout=10),
                                 torch.float32, device="cpu").numpy()
        np.testing.assert_allclose(t_out, j_out, rtol=0, atol=2e-6)
        j.cmd_broadcast(CMD_SCHED, [np.asarray([[1, 4], [5, 8]], np.int32)])
        cmd, ts = tcmds.get(timeout=10)
        assert cmd == CMD_SCHED and ts[0].tolist() == [[1, 4], [5, 8]]
        t.cmd_broadcast(CMD_STOP, [np.asarray(3, np.int32)])
        cmd, ts = jcmds.get(timeout=10)
        assert cmd == CMD_STOP and int(ts[0]) == 3
        assert t.negotiate_edge_bits(0, 8, timeout=10) == 8
        assert j.negotiate_edge_bits(1, 6, timeout=10) == 6
        assert t.negotiate_edge_path(0, timeout=10) == dcn.PATH_ZEROCOPY
        assert j.negotiate_edge_path(1, timeout=10) == jdcn.PATH_ZEROCOPY
    finally:
        t.shutdown()
        j.shutdown()
