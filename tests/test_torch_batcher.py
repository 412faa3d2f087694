"""The port's continuous-batching executors against the JAX package's.

`pipeedge_tpu_torch/parallel/batcher.py` (`ContinuousBatcher`, the wave
executor, and `StageWorkerExecutor`, one thread per stage) over the port's
`DecodePipeline` on the CPU (the plain versions of the kernels), held
against `pipeedge_tpu/parallel/batcher.py` over the JAX `DecodePipeline`
(its int8 decode-attention kernel in interpret mode), on
`pipeedge/test-tiny-gpt2` in two stages (`-pt 1,4,5,8`), max_len 48, f32,
one set of HF-layout random weights loaded into both:

- greedy tokens identical, fp and int8 caches, both executors, with
  batched rows, eos masking over several rows and prefix-seeded requests;
- the wave batcher's `stats` and its dispatch order identical, dense
  chunked prefill and `prefill_budget` included, `step_join` admitting in
  the completion tick, `set_chunk_tokens` taking effect live;
- cancel and deadline finishing early as in JAX, the same validation
  errors and `check_prefix` refusals;
- the port's own contracts: each run equals its own solo `generate`
  (sampled requests too, per seed), a prefix handle's caches are
  unchanged by the requests that use it, a dead or stopped worker fails
  its waiters, the paged plane and shipped prefill refuse, and many
  concurrent clients on the stage workers keep every result exact.

Tokens are compared exactly; no logits are compared here.
"""
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import batcher as jbatcher
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.ops import _build
from pipeedge_tpu_torch.parallel import batcher as tbatcher
from pipeedge_tpu_torch.parallel import decode as tdec

MODEL = "pipeedge/test-tiny-gpt2"
CFG = treg.get_model_config(MODEL)
PARTITION = [(1, 4), (5, 8)]
MAX_LEN, FLOOR = 48, 16
# cache mode -> (cache_bits, int8 decode-attend opt-in: the kernel route)
MODES = {"fp": (0, 0), "int8": (8, 1)}
PACKAGES = {"jax": jbatcher, "torch": tbatcher}


@pytest.fixture(scope="module")
def weights():
    return tgpt2.random_npz_weights(CFG, seed=3)


def _jax_params(weights):
    jcfg = jreg.get_model_config(MODEL)
    return [jgpt2.load_params(jcfg, JShardConfig(l, r, is_first=l == 1,
                                                 is_last=r == 8), weights)
            for l, r in PARTITION]


@pytest.fixture(scope="module")
def pipes(weights):
    """mode -> {"jax": JAX pipeline, "torch": the port's on the CPU}."""
    jparams = _jax_params(weights)
    tparams = [params_from_jax(jax.device_get(p)) for p in jparams]
    out = {}
    for mode, (bits, optin) in MODES.items():
        out[mode] = {
            "jax": jdec.DecodePipeline(
                jgpt2.FAMILY, jreg.get_model_config(MODEL), PARTITION,
                jparams, max_len=MAX_LEN, cache_bits=bits,
                attend_floor=FLOOR, int8_decode_attend=optin),
            "torch": tdec.DecodePipeline(
                tgpt2.FAMILY, CFG, PARTITION, tparams, max_len=MAX_LEN,
                device="cpu", cache_bits=bits, attend_floor=FLOOR,
                int8_decode_attend=optin)}
    return out


def _traffic():
    """Seeded requests: rid -> submit kwargs (ids as numpy). Prompt shapes
    stay few ([1, 6], [2, 6], a [1, 4] suffix), so the JAX side compiles
    few programs."""
    rng = np.random.default_rng(5)
    ids = {k: rng.integers(0, CFG.vocab_size, size=shape)
           for k, shape in (("a", (1, 6)), ("b", (2, 6)), ("c", (1, 6)),
                            ("d", (2, 6)), ("e", (1, 4)))}
    return {"a": dict(ids=ids["a"], new_tokens=9),
            "b": dict(ids=ids["b"], new_tokens=6),
            "c": dict(ids=ids["c"], new_tokens=12),
            "d": dict(ids=ids["d"], new_tokens=10),
            "e": dict(ids=ids["e"], new_tokens=7, prefix=True)}


PREFIX = np.random.default_rng(6).integers(0, CFG.vocab_size, size=(1, 5))


def _with_eos(pipe_t, traffic):
    """Give "c" and "d" an eos token from their own solo runs: the token
    row 0 emits at step 3, so row 0 stops early and (for "d") row 1 may
    not."""
    out = dict(traffic)
    for rid in ("c", "d"):
        req = traffic[rid]
        solo = pipe_t.generate(req["ids"], req["new_tokens"]).numpy()
        out[rid] = dict(req, eos_token=int(solo[0, req["ids"].shape[1] + 3]))
    return out


def _submit_all(ex, pkg, pipe, traffic, **extra):
    handle = pipe.precompute_prefix(PREFIX)
    for rid, req in traffic.items():
        kw = {k: v for k, v in req.items() if k != "prefix"}
        if req.get("prefix"):
            kw["prefix"] = handle
        if pkg == "jax":
            kw["ids"] = np.asarray(kw["ids"], np.int32)
        ex.submit(rid, **kw, **extra)
    return handle


def _wave(pkg, pipe, traffic, **kw):
    b = PACKAGES[pkg].ContinuousBatcher(pipe, **kw)
    _submit_all(b, pkg, pipe, traffic)
    return {k: np.asarray(v) for k, v in b.run().items()}, dict(b.stats)


def _stage(pkg, pipe, traffic, **kw):
    ex = PACKAGES[pkg].StageWorkerExecutor(pipe, **kw)
    try:
        _submit_all(ex, pkg, pipe, traffic)
        return {rid: np.asarray(ex.wait(rid, timeout=120))
                for rid in traffic}
    finally:
        ex.stop()


@pytest.fixture(scope="module")
def runs(pipes):
    """mode -> package -> {"wave": (results, stats), "stage": results}:
    each package's executors over the same eos-bearing traffic."""
    out = {}
    for mode, by_pkg in pipes.items():
        traffic = _with_eos(by_pkg["torch"], _traffic())
        out[mode] = {"traffic": traffic}
        for pkg, pipe in by_pkg.items():
            out[mode][pkg] = {"wave": _wave(pkg, pipe, traffic),
                              "stage": _stage(pkg, pipe, traffic)}
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)


@pytest.mark.parametrize("mode", list(MODES))
def test_wave_tokens_and_stats_match_jax(runs, mode):
    (got, stats), (want, jstats) = (runs[mode]["torch"]["wave"],
                                    runs[mode]["jax"]["wave"])
    _assert_same(got, want)
    assert stats == jstats
    # eos: "c" stopped early, "d" masked row 0 after its eos
    assert got["c"].shape[1] < 6 + 12


@pytest.mark.parametrize("mode", list(MODES))
def test_stage_workers_match_jax(runs, mode):
    _assert_same(runs[mode]["torch"]["stage"], runs[mode]["jax"]["stage"])
    _assert_same(runs[mode]["torch"]["stage"],
                 runs[mode]["torch"]["wave"][0])


def _masked_solo(pipe, req, handle):
    """The solo run of one request as the executors return it: cut where
    every row has emitted the eos, tokens after a row's eos padded."""
    ids = req["ids"]
    solo = pipe.generate(ids, req["new_tokens"], prefix=(
        handle if req.get("prefix") else None)).numpy()
    eos = req.get("eos_token")
    if eos is None:
        return solo
    s = ids.shape[1]
    toks = solo[:, s:]
    hit = toks == eos
    first = np.where(hit.any(1), hit.argmax(1), toks.shape[1])
    stop = int(first.max()) + 1 if hit.any(1).all() else toks.shape[1]
    toks = toks[:, :stop].copy()
    for r, f in enumerate(first):
        toks[r, f + 1:] = eos
    return np.concatenate([ids, toks], axis=1)


@pytest.mark.parametrize("mode", list(MODES))
def test_each_run_equals_its_solo_generate(pipes, runs, mode):
    pipe = pipes[mode]["torch"]
    handle = pipe.precompute_prefix(PREFIX)
    got = runs[mode]["torch"]["wave"][0]
    for rid, req in runs[mode]["traffic"].items():
        np.testing.assert_array_equal(got[rid],
                                      _masked_solo(pipe, req, handle),
                                      err_msg=rid)
    d = got["d"]
    assert (d[0, 6:] == runs[mode]["traffic"]["d"]["eos_token"]).sum() > 1


def _dispatch_trace(pkg, pipe, traffic, monkeypatch, steer=None, **kw):
    """Wave dispatch order: (tick, stage, rid, kind, width at stage 0)
    for every stage-step, plus the results and stats. `steer(batcher,
    tick)` runs before each tick."""
    mod = PACKAGES[pkg]
    trace = []
    b = mod.ContinuousBatcher(pipe, **kw)
    real = mod._run_stage

    def spy(p, i, req, data, kind):
        trace.append((b.stats["ticks"], i, req.rid, kind,
                      int(data.shape[1]) if i == 0 else None))
        return real(p, i, req, data, kind)

    monkeypatch.setattr(mod, "_run_stage", spy)
    _submit_all(b, pkg, pipe, traffic)
    tick = 0
    while True:
        if steer is not None:
            steer(b, tick)
        if not b.tick():
            break
        tick += 1
    monkeypatch.setattr(mod, "_run_stage", real)
    return trace, {k: np.asarray(v) for k, v in b.results.items()}, \
        dict(b.stats)


def _chunk_traffic():
    t = _traffic()
    return {k: t[k] for k in ("a", "b", "e")}


@pytest.mark.parametrize("kw", [dict(chunk_tokens=4),
                                dict(chunk_tokens=2, prefill_budget=3),
                                dict(step_join=True, max_active=1),
                                dict(chunk_tokens=4, step_join=True)],
                         ids=["chunk4", "chunk2-budget3", "step-join",
                              "chunk4-step-join"])
def test_wave_scheduling_matches_jax(pipes, monkeypatch, kw):
    """Dense chunked prefill, the prefill budget and step_join: the same
    stage-steps in the same ticks, the same tokens, and (fp caches, where
    a span is exact) the tokens of the unchunked run."""
    by_pkg = pipes["fp"]
    got = _dispatch_trace("torch", by_pkg["torch"], _chunk_traffic(),
                          monkeypatch, **kw)
    want = _dispatch_trace("jax", by_pkg["jax"], _chunk_traffic(),
                           monkeypatch, **kw)
    assert got[0] == want[0]
    _assert_same(got[1], want[1])
    assert got[2] == want[2]
    plain = _wave("torch", by_pkg["torch"], _chunk_traffic())[0]
    _assert_same(got[1], plain)
    if kw.get("chunk_tokens"):
        assert got[2]["prefill_chunks"] > 3
    if kw.get("step_join") and kw.get("max_active") == 1:
        # each joiner's first stage-step lands in the tick its
        # predecessor retired in (the retiring wave ran at the last stage)
        for rid in ("b", "e"):
            first = min(t for t, _, r, _, _ in got[0] if r == rid)
            prev = {"b": "a", "e": "b"}[rid]
            last = max(t for t, i, r, _, _ in got[0] if r == prev)
            assert first == last


def test_set_chunk_tokens_live_matches_jax(pipes, monkeypatch):
    def steer(b, tick):
        if tick == 2:
            b.set_chunk_tokens(1)
        if tick == 6:
            b.set_chunk_tokens(0)

    by_pkg = pipes["fp"]
    got = _dispatch_trace("torch", by_pkg["torch"], _chunk_traffic(),
                          monkeypatch, steer=steer, chunk_tokens=3)
    want = _dispatch_trace("jax", by_pkg["jax"], _chunk_traffic(),
                           monkeypatch, steer=steer, chunk_tokens=3)
    assert got[0] == want[0] and got[2] == want[2]
    _assert_same(got[1], want[1])
    widths = [w for _, i, _, kind, w in got[0] if kind == "chunk"]
    assert 1 in widths and 3 in widths


class _Clock:
    """A stand-in for the `time` module of both batchers: monotonic time
    moves only when a test says so."""

    def __init__(self):
        self.now = 0.0
        self.monotonic = lambda: self.now
        self.monotonic_ns = lambda: int(self.now * 1e9)


@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_cancel_and_deadline_match_jax(pipes, monkeypatch, executor):
    """A cancel flag set at step 2 and a deadline passed at step 4 end
    their requests with the tokens so far; a deadline already past at
    admission returns the bare prompt: the JAX package's outcomes."""
    outs = {}
    for pkg, mod in PACKAGES.items():
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        pipe = pipes["fp"][pkg]
        ids = _traffic()["a"]["ids"]
        if pkg == "jax":
            ids = np.asarray(ids, np.int32)
        cancel = threading.Event()

        def cancel_at_2(step, tok, cancel=cancel):
            if step == 2:
                cancel.set()

        def expire_at_4(step, tok, clock=clock):
            if step == 4:
                clock.now = 100.0

        reqs = {"cancel": dict(on_token=cancel_at_2, cancel=cancel),
                "deadline": dict(on_token=expire_at_4, deadline=50.0,
                                 cancel=threading.Event()),
                "dead": dict(deadline=-1.0)}
        res = {}
        for rid, kw in reqs.items():
            if executor == "wave":
                b = mod.ContinuousBatcher(pipe, max_active=1)
                b.submit(rid, ids, 20, **kw)
                res[rid] = np.asarray(b.run()[rid])
            else:
                ex = mod.StageWorkerExecutor(pipe, max_active=1)
                try:
                    ex.submit(rid, ids, 20, **kw)
                    res[rid] = np.asarray(ex.wait(rid, timeout=120))
                finally:
                    ex.stop()
            clock.now = 0.0
        outs[pkg] = res
        monkeypatch.undo()
    _assert_same(outs["torch"], outs["jax"])
    assert [outs["torch"][r].shape[1] for r in ("cancel", "deadline",
                                                "dead")] == [6 + 3, 6 + 5, 6]


def test_validation_errors_match_jax(pipes):
    ids = _traffic()["a"]["ids"]
    cases = [dict(ids=ids[0], new_tokens=2),
             dict(ids=np.zeros((1, 0), np.int64), new_tokens=2),
             dict(ids=ids, new_tokens=0),
             dict(ids=ids, new_tokens=2, pad_token=3),
             dict(ids=ids, new_tokens=MAX_LEN)]
    for kw in cases:
        msgs = {}
        for pkg, mod in PACKAGES.items():
            b = mod.ContinuousBatcher(pipes["fp"][pkg])
            with pytest.raises(ValueError) as err:
                b.submit("x", **kw)
            msgs[pkg] = str(err.value)
        assert msgs["torch"] == msgs["jax"]
    for pkg, mod in PACKAGES.items():
        b = mod.ContinuousBatcher(pipes["fp"][pkg])
        b.submit("x", np.asarray(ids, np.int32), 2)
        with pytest.raises(ValueError, match="duplicate request id"):
            b.submit("x", np.asarray(ids, np.int32), 2)
        with pytest.raises(ValueError, match="max_active must be >= 1"):
            mod.ContinuousBatcher(pipes["fp"][pkg], max_active=0)


def test_check_prefix_refusals_match_jax(pipes):
    ids = _traffic()["e"]["ids"]
    int8_handle = {pkg: pipes["int8"][pkg].precompute_prefix(PREFIX)
                   for pkg in PACKAGES}
    for bad in ("int8", "no-sig"):
        for pkg, mod in PACKAGES.items():
            handle = (int8_handle[pkg] if bad == "int8"
                      else {"caches": [], "len": 5})
            b = mod.ContinuousBatcher(pipes["fp"][pkg])
            with pytest.raises(ValueError,
                               match="incompatible pipeline" if bad ==
                               "int8" else "not a precompute_prefix"):
                b.submit("x", np.asarray(ids, np.int32), 2, prefix=handle)


@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_prefix_handle_unchanged_after_use(pipes, executor):
    pipe = pipes["int8"]["torch"]
    handle = pipe.precompute_prefix(PREFIX)
    before = [{k: v.clone() for k, v in c.items()}
              for c in handle["caches"]]
    traffic = {f"p{i}": dict(ids=np.random.default_rng(i).integers(
        0, CFG.vocab_size, size=(1 + i % 2, 4)), new_tokens=5, prefix=True)
        for i in range(3)}
    if executor == "wave":
        _wave("torch", pipe, traffic)
    else:
        _stage("torch", pipe, traffic)
    # the executors used a handle of their own; this one is held to the
    # same contract through _seed_caches directly too
    req = tbatcher._build_request(pipe, "h", traffic["p1"]["ids"], 5, 0.0,
                                  0, 0, None, None, handle)
    assert tbatcher._seed_caches(pipe, req) == "span"
    tbatcher._run_stage(pipe, 0, req, req.ids, "span")
    for c, b in zip(handle["caches"], before):
        for k in b:
            assert torch.equal(c[k], b[k]), k


@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_sampled_request_equals_solo_generate(pipes, executor):
    pipe = pipes["fp"]["torch"]
    ids = _traffic()["b"]["ids"]
    traffic = {f"s{seed}": dict(ids=ids, new_tokens=8, temperature=0.9,
                                top_k=20, seed=seed) for seed in (1, 2)}
    traffic["g"] = dict(ids=ids, new_tokens=8)
    got = (_wave("torch", pipe, traffic)[0] if executor == "wave"
           else _stage("torch", pipe, traffic))
    for rid, req in traffic.items():
        want = pipe.generate(ids, 8, temperature=req.get("temperature", 0.0),
                             top_k=req.get("top_k", 0),
                             seed=req.get("seed", 0)).numpy()
        np.testing.assert_array_equal(got[rid], want, err_msg=rid)
    assert not np.array_equal(got["s1"], got["s2"])


def test_paged_plane_and_shipped_refused(pipes):
    pipe = pipes["fp"]["torch"]
    for cls in (tbatcher.ContinuousBatcher, tbatcher.StageWorkerExecutor):
        with pytest.raises(ValueError, match="ROADMAP A5.3a"):
            cls(pipe, kv=object())
    b = tbatcher.ContinuousBatcher(pipe)
    with pytest.raises(ValueError, match="ROADMAP A5.3a"):
        b.submit("x", _traffic()["a"]["ids"], 2, shipped={})


def test_stop_wakes_blocked_submitter_and_fails_waiters(pipes):
    ex = tbatcher.StageWorkerExecutor(pipes["fp"]["torch"], max_active=1)
    errs = {}
    first = threading.Event()

    def client(rid, n, **kw):
        try:
            ex.submit(rid, np.zeros((1, 4), np.int64), n, **kw)
            ex.wait(rid, timeout=120)
        except RuntimeError as exc:
            errs[rid] = str(exc)

    t_a = threading.Thread(target=client, args=("a", 40), daemon=True,
                           kwargs={"on_token": lambda s, t: first.set()})
    t_a.start()
    assert first.wait(timeout=120)
    t_b = threading.Thread(target=client, args=("b", 2), daemon=True)
    t_b.start()
    deadline = time.monotonic() + 120
    while "b" not in ex._live and time.monotonic() < deadline:
        time.sleep(0.01)
    ex.stop()
    t_a.join(timeout=120)
    t_b.join(timeout=120)
    assert not t_a.is_alive() and not t_b.is_alive()
    assert "in flight" in errs.get("a", "") and "b" in errs


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_worker_fails_waiters(pipes, monkeypatch):
    pipe = pipes["fp"]["torch"]
    ex = tbatcher.StageWorkerExecutor(pipe, max_active=2)
    real = tbatcher._run_stage

    def failing(p, i, req, data, kind):
        if i == 1 and kind == "step":
            raise RuntimeError("injected stage fault")
        return real(p, i, req, data, kind)

    monkeypatch.setattr(tbatcher, "_run_stage", failing)
    try:
        ex.submit("a", _traffic()["a"]["ids"], 4)
        with pytest.raises(RuntimeError, match="injected stage fault"):
            ex.wait("a", timeout=120)
        with pytest.raises(RuntimeError, match="stage worker died"):
            ex.submit("b", _traffic()["a"]["ids"], 4)
    finally:
        monkeypatch.setattr(tbatcher, "_run_stage", real)
        ex.stop()


def test_many_concurrent_clients_on_stage_workers(pipes):
    """More clients than stages and cores, a short switch interval: every
    result still equals its solo run, and every stage-step is counted."""
    pipe = pipes["int8"]["torch"]
    ex = tbatcher.StageWorkerExecutor(pipe, max_active=6)
    rng = np.random.default_rng(8)
    reqs = {i: (rng.integers(0, CFG.vocab_size, size=(1, 6)),
                int(rng.integers(3, 9))) for i in range(16)}
    out, errs = {}, []

    def client(i):
        try:
            ex.submit(i, reqs[i][0], reqs[i][1])
            out[i] = ex.wait(i, timeout=120)
        except Exception as exc:   # noqa: BLE001 — asserted below
            errs.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        ex.stop()
    assert not errs and not any(t.is_alive() for t in threads)
    for i, (ids, n) in reqs.items():
        np.testing.assert_array_equal(out[i], pipe.generate(ids, n).numpy())
    steps = sum(n - 1 for _, n in reqs.values())
    assert [k["step"] for k in ex.kind_steps] == [steps, steps]
    assert ex.snapshot()["tokens"] == sum(n for _, n in reqs.values())


def test_launch_counter_exact_under_threads():
    """`count_launch` from many threads loses no increment."""
    _build.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch("decode_attention") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert _build.launch_counts["decode_attention"] == 16000
    _build.reset_launch_counts()


def test_executor_threads_use_one_stream_context():
    """Off the card the stream context is empty; stage work runs under
    inference mode in every executor thread."""
    pipe = types.SimpleNamespace(device=torch.device("cpu"))
    seen = []
    with tbatcher._stage_context(pipe):
        seen.append(torch.is_inference_mode_enabled())
    assert seen == [True] and not torch.is_inference_mode_enabled()
