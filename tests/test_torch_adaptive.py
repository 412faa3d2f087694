"""The port's adaptive bitwidth loop and monitoring against the JAX package.

- The policies (`utils/quant.py`, `utils/controller.py`) give the JAX
  package's values on the same inputs: the cases of tests/test_policies.py,
  each held to the JAX copy's result.
- The runtime's adaptive callback takes the JAX runtime's decisions on the
  same monitoring windows (a fake clock makes the windows exact).
- The monitoring package and facade pass the cases of
  tests/test_monitoring.py.
- CPU runs of the port's runtime: per-edge `send*` CSVs, an edge whose
  bitwidth moves under a tight SEND_CONSTRAINT, and integer token ids that
  keep their dtype on the way to the first stage.
"""
import csv
import json
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import monitoring as jfacade
import runtime as jruntime
from pipeedge_tpu.monitoring import MonitorContext as JMonitorContext
from pipeedge_tpu.monitoring import \
    MonitorIterationContext as JMonitorIterationContext
from pipeedge_tpu.monitoring import energy as jenergy
from pipeedge_tpu.ops import quant as jops_quant
from pipeedge_tpu.utils import controller as jcontroller
from pipeedge_tpu.utils import quant as jquant
from pipeedge_tpu_torch import runtime
from pipeedge_tpu_torch.monitoring import MonitorContext, MonitorIterationContext
from pipeedge_tpu_torch.monitoring import energy
from pipeedge_tpu_torch.monitoring import facade
from pipeedge_tpu_torch.ops import quant as ops_quant
from pipeedge_tpu_torch.utils import controller
from pipeedge_tpu_torch.utils import quant
from pipeedge_tpu_torch.utils.threads import (RWLock, ThreadSafeCounter,
                                              make_condition, make_lock,
                                              make_rlock)

# --- policies ----------------------------------------------------------------


def test_bitwidths_unique_discrete_compressions():
    assert quant.BITWIDTHS == [32, 16, 10, 8, 6, 5, 4, 3, 2]
    assert quant.BITWIDTHS == jquant.BITWIDTHS


@pytest.mark.parametrize("bit", range(1, 33))
def test_compression_factor_matches_jax(bit):
    assert ops_quant.compression_factor(bit) == \
        jops_quant.compression_factor(bit)


def test_kalman_matches_jax():
    kf, jkf = controller.KalmanFilter(), jcontroller.KalmanFilter()
    for i in range(100):
        z, h = 10.0 + (i % 7) * 0.3, 1.0 + (i % 3)
        assert kf(z, h) == jkf(z, h)
    assert kf.x_hat == pytest.approx(jkf.x_hat)


def test_controller_tracks_reference_as_jax():
    ctl = controller.AdaptiveIntegralXupController(10.0, 1.0, u_max=16.0)
    jctl = jcontroller.AdaptiveIntegralXupController(10.0, 1.0, u_max=16.0)
    u = ju = 1.0
    for _ in range(50):
        u, ju = ctl(2.0 * u), jctl(2.0 * ju)
        assert u == ju
    assert 2.0 * u == pytest.approx(10.0, rel=0.05)


def test_controller_pole_validation():
    ctl = controller.AdaptiveIntegralXupController(1.0, 1.0)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            ctl.pole = bad
    ctl.pole = 0.5
    assert ctl.pole == 0.5


def test_controller_antiwindup_clamp():
    ctl = controller.AdaptiveIntegralXupController(1e9, 1.0, u_max=4.0)
    jctl = jcontroller.AdaptiveIntegralXupController(1e9, 1.0, u_max=4.0)
    for _ in range(10):
        u, ju = ctl(1.0), jctl(1.0)
    assert u == ju == 4.0


@pytest.mark.parametrize("args", [
    (1.0, 1.0, 1.0, 32), (0.5, 1.0, 1.0, 32), (0.25, 1.0, 1.0, 32),
    (0.24, 1.0, 1.0, 32), (0.01, 1.0, 1.0, 32), (1.0, 0.0, 1.0, 32),
    (0.3, 2.5, 7.0, 16), (0.125, 1.0, 1.0, 8), (0.05, 3.0, 40.0, 32)])
def test_constrain_max_bitwidth_matches_jax(args):
    assert quant.constrain_max_bitwidth(*args) == \
        jquant.constrain_max_bitwidth(*args)


def test_constrain_max_bitwidth_values():
    assert quant.constrain_max_bitwidth(1.0, 1.0, 1.0, 32) == 32
    assert quant.constrain_max_bitwidth(0.5, 1.0, 1.0, 32) == 16
    assert quant.constrain_max_bitwidth(0.25, 1.0, 1.0, 32) == 8
    assert quant.constrain_max_bitwidth(0.24, 1.0, 1.0, 32) == 6
    assert quant.constrain_max_bitwidth(0.01, 1.0, 1.0, 32) == 0
    assert quant.constrain_max_bitwidth(1.0, 0.0, 1.0, 32) == 32


@pytest.mark.parametrize("start", [32, 8])
def test_bitwidth_controller_window_split_matches_jax(start):
    """31 calls (the first plus the 30 of test_policies.py) at a measured
    rate of half the target: the same (bw1, bw2, iterations) every call."""
    ctl = quant.AdaptiveBitwidthPerformanceController(100.0, quant.BITWIDTHS,
                                                      start)
    jctl = jquant.AdaptiveBitwidthPerformanceController(100.0,
                                                        jquant.BITWIDTHS, start)
    seq = [ctl(50.0, 10) for _ in range(31)]
    assert seq == [jctl(50.0, 10) for _ in range(31)]
    bw1, bw2, iters1 = seq[0]
    assert bw1 in quant.BITWIDTHS and bw2 in quant.BITWIDTHS
    assert bw1 >= bw2 and 0 <= iters1 <= 10
    assert seq[-1][1] <= 4


@pytest.mark.parametrize("bit", quant.BITWIDTHS)
def test_plain_encode_words_match_jax_at_every_policy_bit(bit):
    """Every bit a policy can pick runs the plain codec outside 4 and 8:
    its words, scale and shift are the JAX package's (10 and 32 are not in
    SUPPORTED_BITS, the set tests/test_torch_quant.py walks); the decoded
    values agree within that file's DECODE_ATOL (XLA may contract the
    decode's multiply-add, so values can sit one f32 ulp apart)."""
    x = np.random.default_rng(bit).normal(size=(3, 5, 37)).astype(np.float32)
    got = ops_quant.tensor_encode_outerdim(torch.from_numpy(x), bit)
    want = jops_quant.tensor_encode_outerdim(x, bit)
    np.testing.assert_array_equal(ops_quant.words_u32(got),
                                  np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.shift.numpy(), np.asarray(want.shift))
    np.testing.assert_allclose(
        ops_quant.tensor_decode_outerdim(got).numpy(),
        np.asarray(jops_quant.tensor_decode_outerdim(want)), rtol=0, atol=2e-6)


# --- the runtime's adaptive callback against the JAX runtime's ----------------

class _Stage:
    def __init__(self, bit):
        self.quant_bit = bit


def _feed(fac, ctx_cls, key, clock, work_mbits, duration_s, n):
    """n beats of (work, duration) on `key`, exact under the fake clock."""
    with fac.get_locked_context(key) as mctx:
        for _ in range(n):
            clock[0] += int(duration_s * 1e9)
            ic = ctx_cls(t_ns_last=clock[0] - int(duration_s * 1e9),
                         e_uj_last=0)
            mctx.iteration(key=key, work=work_mbits, iter_ctx=ic)


@pytest.mark.parametrize("policy,constraint", [
    ("HEURISTIC", "40"), ("HEURISTIC", "0"), ("HEURISTIC2", "40"),
    ("CONTROLLER", "40"), ("CONTROLLER", "5")])
def test_adaptive_callback_decides_as_the_jax_runtime(
        policy, constraint, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    clock = [10**12]
    monkeypatch.setattr(time, "monotonic_ns", lambda: clock[0])
    monkeypatch.setenv("ADAPTIVE_QUANT", policy)
    monkeypatch.setenv("SEND_CONSTRAINT", constraint)
    window, keys = 3, ["send0", "send1"]
    # per window: (Mbits, seconds) of each beat on edge 0 and edge 1
    windows = [((2.0, 0.05), (4.0, 0.3)), ((1.0, 0.2), (4.0, 0.05)),
               ((0.5, 0.01), (8.0, 1.0)), ((3.0, 0.1), (0.2, 0.02))]
    bits = {}
    for name, fac, ctx_cls, rt in (
            ("jax", jfacade, JMonitorIterationContext, jruntime),
            ("port", facade, MonitorIterationContext, runtime)):
        fac.init("shard", window)
        try:
            for key in keys:
                fac.add_key(key, work_type="Mbits")
            stages = [_Stage(8), _Stage(8)]
            cb = rt._make_adaptive_callback(stages, window, edge_keys=keys)
            trace = []
            i = 0
            for w0, w1 in windows:
                _feed(fac, ctx_cls, "send0", clock, *w0, n=window)
                _feed(fac, ctx_cls, "send1", clock, *w1, n=window)
                for _ in range(window):
                    cb(i, np.zeros((2, 5), np.float32))
                    trace.append([s.quant_bit for s in stages])
                    i += 1
            bits[name] = trace
        finally:
            fac.finish()
    assert bits["port"] == bits["jax"]
    if constraint != "0" or policy != "HEURISTIC":
        assert any(b != [8, 8] for b in bits["port"])


# --- monitoring ----------------------------------------------------------------

def test_monitor_lifecycle_and_metrics(tmp_path):
    log = tmp_path / "shard.csv"
    with MonitorContext(key="shard", window_size=3, log_name=str(log)) as ctx:
        for i in range(7):
            ctx.iteration_start(key="shard")
            time.sleep(0.002)
            ctx.iteration(key="shard", work=8, accuracy=i)
        assert ctx.get_tag(key="shard") == 7
        assert ctx.get_global_work(key="shard") == 56
        assert ctx.get_window_work(key="shard") == 24
        assert ctx.get_instant_work(key="shard") == 8
        assert ctx.get_global_time_s(key="shard") >= 0.014
        assert ctx.get_instant_heartrate(key="shard") > 0
        assert ctx.get_global_perf(key="shard") > 0
        assert ctx.get_global_energy_j(key="shard") == 0
        assert ctx.get_window_power_w(key="shard") == 0
        assert ctx.energy_source == "None"
    rows = list(csv.reader(open(log)))
    assert rows[0][0] == "Tag" and len(rows) == 8


def test_monitor_csv_rows_match_jax_format(tmp_path, monkeypatch):
    """The same beats under a fake clock give the JAX package's CSV, byte
    for byte."""
    clock = [5 * 10**9]
    monkeypatch.setattr(time, "monotonic_ns", lambda: clock[0])
    texts = []
    for cls, name in ((MonitorContext, "port.csv"), (JMonitorContext, "jax.csv")):
        with cls(key="k", window_size=2, log_name=str(tmp_path / name)) as ctx:
            for i in range(5):
                ctx.iteration_start(key="k")
                clock[0] += 1_000_000 * (i + 1)
                ctx.iteration(key="k", work=3 + i, accuracy=0.5 * i)
        texts.append((tmp_path / name).read_text())
    assert texts[0] == texts[1]


def test_monitor_multiple_keys(tmp_path):
    ctx = MonitorContext(key="a", window_size=2, log_name=None)
    ctx.add_heartbeat(key="b", log_name=str(tmp_path / "b.csv"))
    with ctx:
        ctx.iteration_start(key="b")
        ctx.iteration(key="b", work=3)
        assert ctx.get_global_work(key="b") == 3
        assert ctx.get_global_work(key="a") == 0
    with pytest.raises(ValueError):
        ctx.add_heartbeat(key="b")


def test_monitor_not_open_raises_and_pickle_blocked():
    ctx = MonitorContext(key="x")
    with pytest.raises(RuntimeError):
        ctx.iteration_start(key="x")
    with pytest.raises(TypeError):
        pickle.dumps(ctx)


def test_monitor_rows_on_disk_before_close(tmp_path):
    log = tmp_path / "k.csv"
    with MonitorContext(key="k", window_size=2, log_name=str(log)) as ctx:
        for _ in range(3):
            ctx.iteration_start(key="k")
            ctx.iteration(key="k", work=1)
        ctx.flush()
        assert len(list(csv.reader(open(log)))) == 4


def test_snapshot_matrix_all_keys(tmp_path):
    with MonitorContext(key="a", window_size=2,
                        log_name=str(tmp_path / "a.csv")) as ctx:
        ctx.add_heartbeat(key="b", log_name=None)
        for i in range(5):
            ctx.iteration_start(key="a")
            time.sleep(0.001)
            ctx.iteration(key="a", work=3, accuracy=i)
        ctx.iteration_start(key="b")
        ctx.iteration(key="b", work=7)
        snap = ctx.snapshot()
        assert set(snap) == {"a", "b"}
        for key in ("a", "b"):
            assert set(snap[key]) == {"instant", "window", "global", "tag",
                                      "window_size"}
            for scope in ("instant", "window", "global"):
                assert set(snap[key][scope]) == {
                    "time_s", "heartrate", "work", "perf", "energy_j",
                    "power_w", "accuracy", "accuracy_rate"}
        assert snap["a"]["global"]["work"] == ctx.get_global_work(key="a")
        assert snap["a"]["window"]["work"] == ctx.get_window_work(key="a")
        assert snap["a"]["global"]["perf"] == ctx.get_global_perf(key="a")
        assert snap["a"]["tag"] == 5 and snap["a"]["window_size"] == 2
        assert snap["b"]["global"]["work"] == 7


def test_facade_lifecycle(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    facade.init("shard", 2, work_type="items", acc_type="layers")
    facade.add_key("send", work_type="Mbits")
    facade.iteration_start("shard")
    facade.iteration("shard", work=4, accuracy=12)
    facade.iteration_start("send")
    facade.iteration("send", work=1.5)
    with facade.get_locked_context("send") as mctx:
        assert mctx.get_tag(key="send") == 1
        assert mctx.get_window_work(key="send") == 1.5
    facade.finish()
    assert (tmp_path / "shard.csv").exists()
    assert (tmp_path / "send.csv").exists()
    facade.iteration_start("shard")       # after finish: no-ops
    facade.iteration("shard")
    facade.iteration_reset("shard")
    facade.iteration_abort("shard")
    with facade.get_locked_context("shard") as mctx:
        assert mctx is None


def test_facade_unbalanced_iteration_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    facade.init("k", 2)
    try:
        with pytest.raises(KeyError):
            facade.iteration("k", work=1)
        facade.iteration("k", work=1, safe=False)
        facade.iteration_start("k")
        facade.iteration_abort("k")       # discarded: no beat
        with facade.get_locked_context("k") as mctx:
            assert mctx.get_tag(key="k") == 0
    finally:
        facade.finish()


def test_facade_threads_same_key(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    facade.init("k", 4)
    errors = []

    def worker():
        try:
            for _ in range(5):
                facade.iteration_start("k")
                facade.iteration("k", work=1)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with facade.get_locked_context("k") as mctx:
        assert mctx.get_tag(key="k") == 20
        assert mctx.get_global_work(key="k") == 20
    facade.finish()
    assert not errors


def test_facade_flush_and_snapshot(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    facade.flush()
    assert facade.snapshot() == {}
    facade.init("k", 2)
    try:
        facade.add_key("j", work_type="Mbits")
        facade.iteration_start("k")
        facade.iteration("k", work=4)
        facade.flush()
        assert len(list(csv.reader(open(tmp_path / "k.csv")))) == 2
        snap = facade.snapshot()
        assert set(snap) == {"k", "j"}
        assert snap["k"]["global"]["work"] == 4 and snap["j"]["tag"] == 0
    finally:
        facade.finish()
    facade.flush()
    assert facade.snapshot() == {}


def test_facade_csv_mode_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "k.csv").write_text("old\n")
    monkeypatch.setenv(facade.ENV_CSV_FILE_MODE, "x")
    with pytest.raises(FileExistsError):
        facade.init("k", 2)
    monkeypatch.setenv(facade.ENV_CSV_FILE_MODE, "a")
    facade.init("k", 2)
    facade.finish()
    assert (tmp_path / "k.csv").read_text().startswith("old\nTag,")


def test_rwlock_counter_and_lock_factories():
    lock = RWLock()
    with lock.lock_read():
        with lock.lock_read():
            pass
    with lock.lock_write():
        pass
    counter = ThreadSafeCounter()
    t = threading.Thread(target=lambda: (time.sleep(0.01), counter.add(5)))
    t.start()
    assert counter.wait_gte(5, timeout=2)
    t.join()
    assert counter.value == 5
    counter.set(1)
    assert not counter.wait_gte(2, timeout=0.01)
    for make in (make_lock, make_rlock, make_condition):
        with make("site"):
            pass


def _fake_powercap(root, values):
    for i, v in enumerate(values):
        d = root / f"intel-rapl:{i}"
        d.mkdir(parents=True)
        (d / "energy_uj").write_text(str(v))
        (d / "max_energy_range_uj").write_text("1000")
    (root / "intel-rapl:0:0").mkdir()      # a subdomain: skipped


def test_energy_sources_match_jax(tmp_path):
    assert energy.default_energy_source(str(tmp_path / "none")) is None
    assert jenergy.default_energy_source(str(tmp_path / "none")) is None
    _fake_powercap(tmp_path, [100, 250])
    src = energy.default_energy_source(str(tmp_path))
    jsrc = jenergy.default_energy_source(str(tmp_path))
    src.init()
    jsrc.init()
    assert src.get_source() == jsrc.get_source() == "RAPL(2 domains)"
    (tmp_path / "intel-rapl:1" / "energy_uj").write_text("50")   # wrapped
    assert src.get_uj() == jsrc.get_uj() == 100 + 50 + 1000


# --- the port's runtime on the CPU ----------------------------------------------

def _run_runtime(capsys, *args):
    runtime.main(["0", *args, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    bits = [ln for ln in lines if ln.startswith("edge_bits=")]
    assert len(bits) == 1
    return lines, json.loads(bits[0].split("=", 1)[1])


@pytest.mark.parametrize("policy", ["HEURISTIC", "CONTROLLER"])
@pytest.mark.parametrize("model,pt,q", [
    ("pipeedge/test-tiny-bert", "1,4,5,8", "8,0"),
    ("pipeedge/test-tiny-vit", "1,3,4,6,7,8", "8,8,0")])
def test_runtime_adaptive_edges_move_and_log(model, pt, q, policy, capsys,
                                             monkeypatch, tmp_path):
    """A send constraint far past what the CPU run reaches makes the policy
    compress each edge below 8 bits; each edge writes its own CSV with one
    row per microbatch after the first."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ADAPTIVE_QUANT", policy)
    monkeypatch.setenv("SEND_CONSTRAINT", "1e9")
    monkeypatch.setenv("WINDOW_SIZE", "2")
    n_edges = q.count(",")
    lines, bits = _run_runtime(capsys, str(n_edges + 1), "-m", model,
                               "-pt", pt, "-q", q, "-b", "12", "-u", "2")
    assert len(bits) == n_edges
    assert all(0 < b < 8 for b in bits), bits
    for key in [f"send{i}" for i in range(n_edges)] + ["send", "output"]:
        rows = list(csv.DictReader(open(tmp_path / f"{key}.csv")))
        assert len(rows) == 5, key              # 6 microbatches
    # edge 0's wire Mbits shrink once the policy has moved its bitwidth
    work = [float(r["Work"]) for r in csv.DictReader(open(tmp_path / "send0.csv"))]
    assert work[-1] < work[0]


def test_runtime_opens_only_the_keys_it_feeds(capsys, monkeypatch, tmp_path):
    """The host loop writes the CSVs of the keys it feeds (results, all
    edges, each edge) and opens none that only the DCN stages feed."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ADAPTIVE_QUANT", raising=False)
    _run_runtime(capsys, "3", "-m", "pipeedge/test-tiny-vit",
                 "-pt", "1,3,4,6,7,8", "-q", "8,4,0", "-b", "4", "-u", "2")
    assert sorted(f.name for f in tmp_path.glob("*.csv")) == [
        "output.csv", "send.csv", "send0.csv", "send1.csv"]
    for name in ("output.csv", "send0.csv"):
        assert len(list(csv.DictReader(open(tmp_path / name)))) == 1


def test_runtime_fixed_bits_without_policy(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ADAPTIVE_QUANT", raising=False)
    _, bits = _run_runtime(capsys, "3", "-m", "pipeedge/test-tiny-vit",
                           "-pt", "1,3,4,6,7,8", "-q", "8,4,0",
                           "-b", "4", "-u", "2")
    assert bits == [8, 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runtime_token_model_keeps_integer_ids(dtype, capsys, monkeypatch,
                                               tmp_path):
    """BERT's token ids reach the first stage as int32 whatever `-t` says
    (cast to the float dtype they would not index the embedding)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ADAPTIVE_QUANT", raising=False)
    seen = []
    real_run = runtime.host_pipeline.HostPipeline.run

    def spy(self, ubatches):
        seen.extend(u.dtype for u in ubatches)
        return real_run(self, ubatches)

    monkeypatch.setattr(runtime.host_pipeline.HostPipeline, "run", spy)
    lines, _ = _run_runtime(capsys, "2", "-m", "pipeedge/test-tiny-bert",
                            "-pt", "1,4,5,8", "-q", "8,0", "-b", "4",
                            "-u", "2", "-t", dtype)
    assert seen == [torch.int32, torch.int32]
    assert any(ln.startswith("latency_sec=") for ln in lines)
    rows = list(csv.DictReader(open(tmp_path / "output.csv")))
    assert len(rows) == 1


def test_to_input_casts_floats_only():
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = runtime.to_input(ids, torch.device("cpu"), torch.bfloat16)
    assert got.dtype == torch.int32 and torch.equal(got, torch.from_numpy(ids))
    img = np.zeros((2, 3), np.float32)
    assert runtime.to_input(img, torch.device("cpu"),
                            torch.bfloat16).dtype == torch.bfloat16


def test_load_dataset_matches_jax():
    """Token models get the JAX package's seeded ids (64 per item), vision
    models its seeded images."""
    from pipeedge_tpu.utils import data as jdata
    from pipeedge_tpu_torch.utils import data
    ds = runtime.load_dataset("textattack/bert-base-uncased-CoLA", 4)
    want = jdata.synthetic_token_dataset(4, seq_len=64, vocab_size=30522,
                                         n_labels=2)
    assert len(ds) == len(want) == 4
    for i in range(4):
        got_ids, got_lb = ds[i]
        want_ids, want_lb = want[i]
        assert got_ids.dtype == np.int32 and got_ids.shape == (64,)
        np.testing.assert_array_equal(got_ids, want_ids)
        assert got_lb == want_lb
    assert runtime.load_dataset("pipeedge/test-tiny-bert", 2)[0][0].shape == (64,)
    img = runtime.load_dataset("pipeedge/test-tiny-vit", 2)[0][0]
    assert img.shape == (3, 16, 16) and img.dtype == np.float32
    tok = data.synthetic_token_dataset(70, seq_len=8, vocab_size=50)
    assert len(tok) == 70 and np.array_equal(tok[64][0], tok[0][0])
