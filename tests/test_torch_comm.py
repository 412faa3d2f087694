"""The port's comm contexts against the JAX package's.

The cases of `tests/test_comm.py` run against both packages: the
`DistContext` lifecycle, `SliceContext`'s device snapshot and command
delivery (`tests/test_comm.py:38`), `MultiHostContext` over one process
skipping its bring-up (`:47`), and the command plane's order, drain and
stop. The port's own: `MultiHostContext` refuses an `nccl` world whose
ranks would share a card, with an error that names the card and says to
pass `backend="gloo"` (the device count stubbed; no NCCL init runs), the
backend defaults by device kind and is never switched, and
`global_devices()` without a world is this process's own positions.
"""
import socket
import threading
import time

import pytest
import torch

import pipeedge_tpu.comm as jcomm
import pipeedge_tpu_torch.comm as tcomm

PACKAGES = [pytest.param(jcomm, id="jax"), pytest.param(tcomm, id="port")]


def _slice(pkg, handler=None):
    if pkg is tcomm:
        return pkg.SliceContext(cmd_handler=handler, device="cpu")
    return pkg.SliceContext(cmd_handler=handler)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dist_context_lifecycle(pkg):
    ctx = pkg.DistContext(world_size=1, rank=0)
    assert not ctx.initialized
    ctx.init()
    assert ctx.initialized
    ctx.shutdown()
    assert not ctx.initialized
    with ctx:
        assert ctx.initialized
    with ctx:
        assert ctx.initialized
    assert not ctx.initialized


@pytest.mark.parametrize("pkg", PACKAGES)
def test_slice_context_devices_and_commands(pkg):
    got = []
    event = threading.Event()

    def handler(cmd, payload):
        got.append((cmd, payload))
        event.set()

    ctx = _slice(pkg, handler)
    assert ctx.devices == [] and ctx.world_size == 0   # nothing touched
    with ctx:
        assert ctx.world_size >= 1
        assert len(ctx.devices) == ctx.world_size
        ctx.cmd_broadcast(pkg.CMD_SCHED, ((1, 24), (25, 48)))
        assert event.wait(timeout=5)
    assert got == [(pkg.CMD_SCHED, ((1, 24), (25, 48)))]


def test_port_slice_context_snapshots_the_cpu():
    with tcomm.SliceContext(device="cpu") as ctx:
        assert ctx.devices == [torch.device("cpu")]
        assert ctx.world_size == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multihost_single_process_noop(pkg):
    kwargs = {"device": "cpu"} if pkg is tcomm else {}
    with pkg.MultiHostContext("127.0.0.1:0", num_processes=1, process_id=0,
                              **kwargs) as ctx:
        assert ctx.initialized
        assert ctx.world_size == 1
    assert not ctx.initialized


def test_port_multihost_single_process_skips_torch_distributed(caplog):
    caplog.set_level("INFO")
    with tcomm.MultiHostContext("127.0.0.1:0", 1, 0, device="cpu"):
        assert not torch.distributed.is_initialized()
        # one process's positions, in order
        assert tcomm.global_devices(["cpu", "cpu"]) == [
            tcomm.Position(0, torch.device("cpu"))] * 2
    assert "skipping torch.distributed" in caplog.text


@pytest.mark.parametrize("pkg", PACKAGES)
def test_command_plane_ordering_and_stop(pkg):
    got = []
    plane = pkg.CommandPlane(lambda cmd, p: got.append(cmd))
    plane.start()
    for cmd in (pkg.CMD_SCHED, pkg.CMD_SCHED, pkg.CMD_STOP):
        plane.publish(cmd)
    deadline = time.monotonic() + 5
    while len(got) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    plane.stop()
    assert got == [pkg.CMD_SCHED, pkg.CMD_SCHED, pkg.CMD_STOP]
    plane.stop()  # idempotent


@pytest.mark.parametrize("pkg", PACKAGES)
def test_command_plane_stop_drains_pending(pkg):
    got = []
    plane = pkg.CommandPlane(lambda cmd, p: got.append(cmd))
    plane.start()
    plane.publish(pkg.CMD_SCHED)
    plane.publish(pkg.CMD_STOP)
    plane.stop()
    assert got == [pkg.CMD_SCHED, pkg.CMD_STOP]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_command_plane_stop_from_handler_then_restart(pkg):
    got = []
    plane = pkg.CommandPlane(None)

    def handler(cmd, payload):
        got.append(cmd)
        if cmd == pkg.CMD_STOP:
            plane.stop()

    plane._handler = handler
    plane.publish(pkg.CMD_STOP)
    plane.publish(pkg.CMD_SCHED)
    plane.start()
    deadline = time.monotonic() + 5
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got == [pkg.CMD_STOP, pkg.CMD_SCHED]
    plane.start()
    plane.publish(pkg.CMD_SCHED)
    plane.stop()
    assert got == [pkg.CMD_STOP, pkg.CMD_SCHED, pkg.CMD_SCHED]


def test_default_backend_by_device_kind():
    assert tcomm.default_backend("cpu") == "gloo"
    assert tcomm.default_backend("cuda") == "nccl"
    ctx = tcomm.MultiHostContext("127.0.0.1:1", 2, 0, device="cpu")
    assert ctx.backend == "gloo"
    # asked for, kept: the context never picks another backend itself
    ctx = tcomm.MultiHostContext("127.0.0.1:1", 2, 0, backend="gloo",
                                 device="cuda")
    assert ctx.backend == "gloo"


@pytest.mark.parametrize("hosts,count,clash", [
    (["a", "a"], 1, "cuda:0"),
    (["a", "a", "a"], 2, "cuda:0"),
    (["a", "b"], 1, None),
    (["a", "a"], 2, None),
    (["a", "b", "a", "b"], 2, None),
])
def test_nccl_card_clash(hosts, count, clash):
    why = tcomm.nccl_card_clash(hosts, count)
    if clash is None:
        assert why is None
    else:
        assert f"share card {clash}" in why
        assert 'backend="gloo"' in why


def test_multihost_refuses_nccl_ranks_on_one_card(monkeypatch):
    """Two ranks on one host whose device count reads 1: both refuse
    before any process group starts, naming the card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with socket.create_server(("127.0.0.1", 0)) as s:
        port = s.getsockname()[1]
    errors = {}

    def rank(r):
        ctx = tcomm.MultiHostContext(f"127.0.0.1:{port}", 2, r,
                                     backend="nccl", device="cuda")
        try:
            ctx.init()
        except RuntimeError as exc:
            errors[r] = str(exc)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(errors) == [0, 1]
    for why in errors.values():
        assert "ranks 0 and 1 would share card cuda:0" in why
        assert "Duplicate GPU detected" in why
        assert 'backend="gloo"' in why
    assert not torch.distributed.is_initialized()
