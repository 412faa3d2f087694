"""The port's disaggregated prefill (`pipeedge_tpu_torch/kv/disagg.py`, the
shipped-KV install of `kv/backend.py`, the executors' `shipped=`) against
the JAX package's.

The cases of `tests/test_kv_plane.py`'s disaggregation block, on both
executors, on `pipeedge/test-tiny-gpt2` in two stages (`-pt 1,4,5,8`),
max_len 48, f32, one set of seeded weights in both packages (the JAX
shards carried to the port by `params_from_jax`):

- `local` and `wire` at ship bits 0: greedy answers equal to the JAX
  `DecodePipeline.generate` and to the port's colocated paged run,
  sampled answers to the port's own solo run (sampling differs between
  the packages by design, ROADMAP §C);
- an 8-bit `wire` handle equal to the JAX fleet's 8-bit handle within
  the codec tolerance ROADMAP §C states (2e-6: the CPU decode against
  XLA), logits included;
- a submitter that dies mid-ship leaks no page once the orphan sweep
  runs; a malformed handle returns the pages it was charged;
- the install's idempotence fence, the trie publish of a shipped prompt,
  and a shipped first token that completes its request at admission.

Tokens are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from pipeedge_tpu.kv import PrefillFleet as JPrefillFleet
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.telemetry import metrics as jprom
from pipeedge_tpu_torch.kv import PagedKvBackend, PrefillFleet
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.parallel import batcher as tbatcher
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.telemetry import metrics as prom

MODEL = "pipeedge/test-tiny-gpt2"
PARTITION = [(1, 4), (5, 8)]
MAX_LEN = 48
# the codec's CPU decode against XLA (ROADMAP §C, "Codec tolerances")
CODEC_ATOL = 2e-6
EXECUTORS = ["wave", "stage"]


@pytest.fixture(scope="module")
def pipes():
    """{"jax", "torch" (the decode pipeline), "prefill" (the port's
    prefill pipeline, sharing the decode pipeline's weights)}."""
    jparams = [jreg.module_shard_factory(MODEL, None, l, r, stage=i,
                                         unroll=False)[1]
               for i, (l, r) in enumerate(PARTITION)]
    tparams = [params_from_jax(jax.device_get(p)) for p in jparams]
    jpipe = jdec.DecodePipeline(jreg.get_model_entry(MODEL).family.FAMILY,
                                jreg.get_model_config(MODEL), PARTITION,
                                jparams, max_len=MAX_LEN)
    tpipe = tdec.build_decode_pipeline(MODEL, PARTITION, max_len=MAX_LEN,
                                       stage_params=tparams, device="cpu")
    prefill = tdec.build_decode_pipeline(
        MODEL, PARTITION, max_len=MAX_LEN,
        stage_params=[st["params"] for st in tpipe.stages], device="cpu")
    return {"jax": jpipe, "torch": tpipe, "prefill": prefill}


def _backend(pipe, n_pages=24, page_size=4):
    return PagedKvBackend(pipe, n_pages, page_size, registry=prom.Registry())


def _fleet(pipes, path="local", bits=0):
    return PrefillFleet(pipes["prefill"], path=path, ship_bits=bits,
                        registry=prom.Registry())


def _run(executor, pipe, kv, requests):
    """{rid: answer} of `requests` ({rid: submit kwargs}) through the
    port's wave or stage executor on backend `kv`."""
    if executor == "wave":
        ex = tbatcher.ContinuousBatcher(pipe, kv=kv)
        for rid, kw in requests.items():
            ex.submit(rid, **kw)
        return ex.run(), ex
    ex = tbatcher.StageWorkerExecutor(pipe, kv=kv)
    try:
        for rid, kw in requests.items():
            ex.submit(rid, **kw)
        return {rid: ex.wait(rid, timeout=300) for rid in requests}, ex
    finally:
        ex.stop()


def _ids(seed, length):
    return np.random.default_rng(seed).integers(0, 100, size=(1, length))


@pytest.mark.parametrize("path", ["local", "wire"])
@pytest.mark.parametrize("executor", EXECUTORS)
def test_disaggregated_loopback_matches_colocated(pipes, executor, path):
    """Prefill fleet -> decode executor over either ship path: greedy
    equal to the JAX greedy run and to the colocated paged run, sampled
    equal to the port's solo run with its seed."""
    ids = _ids(41, 7)
    fleet = _fleet(pipes, path)
    got, _ = _run(executor, pipes["torch"], _backend(pipes["torch"]), {
        "greedy": dict(ids=ids, new_tokens=6,
                       shipped=fleet.prefill(ids, rid="greedy")),
        "sampled": dict(ids=ids, new_tokens=5, temperature=0.9, seed=6,
                        shipped=fleet.prefill(ids, rid="sampled"))})
    want = np.asarray(pipes["jax"].generate(ids, 6))
    np.testing.assert_array_equal(got["greedy"], want)
    np.testing.assert_array_equal(
        got["sampled"],
        pipes["torch"].generate(ids, 5, temperature=0.9, seed=6).numpy())
    colo, _ = _run(executor, pipes["torch"], _backend(pipes["torch"]),
                   {"greedy": dict(ids=ids, new_tokens=6)})
    np.testing.assert_array_equal(colo["greedy"], got["greedy"])
    assert fleet.m_prefills.value() == 2
    assert fleet.m_ship_bytes.value(path=path) > 0


def test_eight_bit_handle_equals_jax_handle(pipes):
    """`wire` at ship bits 8: the port's decoded handle equals the JAX
    fleet's within the codec tolerance, per stage and leaf, logits too;
    the bytes on the wire are the same count."""
    ids = _ids(43, 9)
    port = _fleet(pipes, "wire", 8)
    jfleet = JPrefillFleet(pipes["jax"], path="wire", ship_bits=8,
                           registry=jprom.Registry())
    mine, theirs = port.prefill(ids), jfleet.prefill(ids)
    assert mine["prompt_len"] == theirs["prompt_len"] == 9
    for got, want in zip(mine["stage_rows"], theirs["stage_rows"]):
        assert set(got) == set(want) == {"k", "v"}
        for name in ("k", "v"):
            assert tuple(got[name].shape) == tuple(want[name].shape)
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]),
                                       rtol=0, atol=CODEC_ATOL)
    np.testing.assert_allclose(np.asarray(mine["logits"]),
                               np.asarray(theirs["logits"]),
                               rtol=0, atol=CODEC_ATOL)
    assert port.m_ship_bytes.value(path="wire") == \
        jfleet.m_ship_bytes.value(path="wire")


class _Req:
    """The executor-side request skeleton `admit` needs."""

    def __init__(self, rid, ids, shipped, new_tokens=4):
        self.rid = rid
        self.ids = torch.as_tensor(ids)
        self.host_ids = np.asarray(ids)
        self.prompt_len = ids.shape[1]
        self.new_tokens = new_tokens
        self.shipped = shipped
        self.tokens = []
        self.rows_done = None
        self.eos_token = None
        self.on_token = None
        self.gen = None
        self.pick = tdec.make_token_picker()


def test_mid_ship_death_leaks_zero_pages_after_sweep(pipes):
    """A request whose submitter dies mid-ship (pages charged, KV
    installed, nothing released) leaks no page once the orphan sweep
    reconciles against liveness, and the pool serves again afterwards."""
    kv = _backend(pipes["torch"])
    ids = _ids(61, 6)
    req = _Req("died-mid-ship", ids, _fleet(pipes).prefill(ids))
    with torch.inference_mode():
        kind, _ = kv.admit(req)
    assert kind == "step"
    taken = kv.pool.n_pages - kv.pool.free_pages
    assert taken > 0
    leaked = kv.sweep_orphans(set())
    assert leaked == taken
    assert kv.pool.stats()["leaked"] == leaked
    # every page is free again or retained by the trie (the install
    # published the prompt's full page: cached capacity, not a leak)
    cached = kv.trie.stats()["pages_cached"]
    assert kv.pool.free_pages + cached == kv.pool.n_pages
    kv.release(req)             # the late release is a no-op
    assert kv.pool.free_pages + cached == kv.pool.n_pages
    got, _ = _run("wave", pipes["torch"], kv,
                  {"after": dict(ids=ids, new_tokens=4)})
    np.testing.assert_array_equal(got["after"],
                                  np.asarray(pipes["jax"].generate(ids, 4)))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_malformed_handle_returns_its_pages(pipes, executor):
    """A handle that does not cover the prompt is refused at admission
    with the JAX backend's error, after the pages were charged and
    adopted: they are released again, and the executor takes the next
    request."""
    kv = _backend(pipes["torch"])
    handle = _fleet(pipes).prefill(_ids(62, 5))
    with pytest.raises(ValueError, match="shipped KV covers 5 prompt "
                                         "tokens; request prompt is 6"):
        _run(executor, pipes["torch"], kv,
             {"bad": dict(ids=_ids(63, 6), new_tokens=3, shipped=handle)})
    assert kv.pool.free_pages == kv.pool.n_pages
    assert kv.pool.stats()["owners"] == 0


def test_shipped_install_is_idempotent(pipes):
    """A second `_install_shipped` for one request (a ship delivered
    twice above the lease fence) returns the first install's decision
    and appends no second token."""
    kv = _backend(pipes["torch"])
    ids = _ids(67, 6)
    batcher = tbatcher.ContinuousBatcher(pipes["torch"], kv=kv)
    handle = _fleet(pipes).prefill(ids)
    batcher.submit("idem", ids, new_tokens=4, shipped=handle)
    with torch.inference_mode():
        batcher._admit()
        req = batcher._stage_q[0][0][0]
        assert len(req.tokens) == 1        # the shipped first token
        first = req.kvstate["install_result"]
        again = kv._install_shipped(req, handle)
    assert again is first
    assert len(req.tokens) == 1, "double install double-appended tokens"
    while batcher.tick():
        pass
    np.testing.assert_array_equal(batcher.results["idem"],
                                  np.asarray(pipes["jax"].generate(ids, 4)))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_shipped_install_publishes_prefix(pipes, executor):
    """A shipped prompt's full pages land in the decode-side trie: the
    next colocated request with that prompt reuses them (one executor
    serves both, as a server does)."""
    kv = _backend(pipes["torch"])
    ids = _ids(47, 8)
    handle = _fleet(pipes).prefill(ids)
    wave = executor == "wave"
    ex = (tbatcher.ContinuousBatcher if wave
          else tbatcher.StageWorkerExecutor)(pipes["torch"], kv=kv)
    try:
        ex.submit("shipped", ids, 4, shipped=handle)
        out = ex.run()["shipped"] if wave else ex.wait("shipped",
                                                       timeout=300)
        np.testing.assert_array_equal(
            out, np.asarray(pipes["jax"].generate(ids, 4)))
        assert kv.trie.stats()["pages_cached"] == 2     # 8 tokens / 4
        ex.submit("reuse", ids, 4)
        again = ex.run()["reuse"] if wave else ex.wait("reuse",
                                                       timeout=300)
        np.testing.assert_array_equal(again, out)
        assert kv.trie.stats()["pages_reused_total"] > 0
    finally:
        if not wave:
            ex.stop()


@pytest.mark.parametrize("executor", EXECUTORS)
def test_shipped_first_token_completes_at_admission(pipes, executor):
    """One new token: the shipped logits' pick completes the request in
    admission (kind "done"), so no stage-step runs, the token is counted
    once, and the pages go back to the pool."""
    kv = _backend(pipes["torch"])
    ids = _ids(71, 6)
    got, ex = _run(executor, pipes["torch"], kv, {
        "one": dict(ids=ids, new_tokens=1,
                    shipped=_fleet(pipes, "wire").prefill(ids))})
    np.testing.assert_array_equal(got["one"],
                                  np.asarray(pipes["jax"].generate(ids, 1)))
    assert all(n == 0 for steps in ex.kind_steps for n in steps.values())
    assert ex.stats["tokens"] == 1
    assert kv.pool.free_pages + kv.trie.stats()["pages_cached"] \
        == kv.pool.n_pages
