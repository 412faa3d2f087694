"""The port's paged KV plane (`pipeedge_tpu_torch/kv/`) against the JAX
package's (`pipeedge_tpu/kv/`).

The counterparts of the non-shipping tests of `tests/test_kv_plane.py`,
on `pipeedge/test-tiny-gpt2` in two stages (`-pt 1,4,5,8`), max_len 48,
f32, page sizes 4 and 8, one set of HF-layout random weights loaded into
both packages:

- pool accounting, refcounts, the owner ledger and its sweep; a gather
  of a page table equal to the JAX pool's gather of the same table over
  the same arena contents (fp and int8 leaves), and a gathered view the
  decode-attention kernel takes as it takes a dense cache;
- the prefix trie's hit / partial / miss and cold eviction under
  pressure; token-budget admission beyond the dense slots' worth (and
  the EDF head keeping its place, its grant order recorded at the grant);
- submits bigger than the pool refused, `stop` waking a page-blocked
  submitter, more concurrent requests than the dense slots' worth;
- the paged wave and stage executors' greedy tokens identical to the
  JAX paged executors', to the port's dense executors and to solo
  `generate` (fp and int8 caches, chunked prefill and step-join too);
  sampled requests equal to the port's own solo runs per seed (sampling
  differs between the packages by design, ROADMAP §C);
- the ship-dependent methods: nothing cached exports nothing, a malformed
  prefix or shipped handle is refused alike by both backends, and a
  shipped handle installs (disaggregation has its own file,
  `test_torch_disagg.py`).

Tokens and gathered leaves are compared exactly.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.kv import KvPagePool as JPool
from pipeedge_tpu.kv import PagedKvBackend as JBackend
from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import batcher as jbatcher
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.telemetry import metrics as jprom
from pipeedge_tpu_torch.kv import (KvPagePool, PagedKvBackend, PoolExhausted,
                                   PrefixTrie, pages_for)
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.ops import decode_attention
from pipeedge_tpu_torch.parallel import batcher as tbatcher
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.serving import admission as tadm
from pipeedge_tpu_torch.telemetry import metrics as prom

MODEL = "pipeedge/test-tiny-gpt2"
CFG = treg.get_model_config(MODEL)
PARTITION = [(1, 4), (5, 8)]
MAX_LEN, FLOOR = 48, 16
# cache mode -> (cache_bits, int8 decode-attend opt-in: the kernel route)
MODES = {"fp": (0, 0), "int8": (8, 1)}


@pytest.fixture(scope="module")
def pipes():
    """mode -> {"jax": JAX pipeline, "torch": the port's on the CPU}, on
    one set of seeded HF-layout weights."""
    weights = tgpt2.random_npz_weights(CFG, seed=3)
    jcfg = jreg.get_model_config(MODEL)
    jparams = [jgpt2.load_params(jcfg, JShardConfig(l, r, is_first=l == 1,
                                                    is_last=r == 8), weights)
               for l, r in PARTITION]
    tparams = [params_from_jax(jax.device_get(p)) for p in jparams]
    out = {}
    for mode, (bits, optin) in MODES.items():
        out[mode] = {
            "jax": jdec.DecodePipeline(
                jgpt2.FAMILY, jcfg, PARTITION, jparams, max_len=MAX_LEN,
                cache_bits=bits, attend_floor=FLOOR,
                int8_decode_attend=optin),
            "torch": tdec.DecodePipeline(
                tgpt2.FAMILY, CFG, PARTITION, tparams, max_len=MAX_LEN,
                device="cpu", cache_bits=bits, attend_floor=FLOOR,
                int8_decode_attend=optin)}
    return out


@pytest.fixture(scope="module")
def pipe(pipes):
    return pipes["fp"]["torch"]


def _pool(pipe, n_pages=16, page_size=4):
    return KvPagePool(pipe, n_pages, page_size, registry=prom.Registry())


def _backend(pipe, n_pages=24, page_size=4, **kw):
    return PagedKvBackend(pipe, n_pages, page_size,
                          registry=prom.Registry(), **kw)


def _jbackend(pipe, n_pages=24, page_size=4, **kw):
    return JBackend(pipe, n_pages, page_size, registry=jprom.Registry(),
                    **kw)


def _prompts(n, batch=1, lens=(6,), seed0=11):
    rng = np.random.default_rng(seed0)
    return [np.asarray(rng.integers(
        0, CFG.vocab_size, size=(batch, lens[i % len(lens)])), np.int64)
        for i in range(n)]


# ---------------------------------------------------------------------------
# page pool: alloc / free / refcount / owner ledger
# ---------------------------------------------------------------------------

def test_pool_alloc_free_refcount(pipe):
    pool = _pool(pipe, n_pages=8, page_size=4)
    assert pool.tokens_capacity == 32
    a = pool.alloc(3)
    assert len(a) == 3 and len(set(a)) == 3
    assert pool.free_pages == 5
    pool.share(a[:2])
    pool.release(a)
    assert pool.free_pages == 6
    assert pool.refcount(a[0]) == 1
    pool.release(a[:2])
    assert pool.free_pages == 8 and pool.refcount(a[0]) == 0
    with pytest.raises(ValueError, match="unallocated"):
        pool.release([a[0]])
    with pytest.raises(ValueError, match="unallocated"):
        pool.share([a[0]])
    with pytest.raises(PoolExhausted):
        pool.alloc(9)
    b = pool.alloc(8)
    with pytest.raises(PoolExhausted, match="need 1 page"):
        pool.alloc(1)
    pool.release(b)
    assert pages_for(0, 4) == 0 and pages_for(1, 4) == 1 \
        and pages_for(9, 4) == 3


def test_pool_alloc_order_and_stats_match_jax(pipes):
    """The same alloc / share / release sequence leaves the two pools
    with the same page ids, free counts and stats."""
    pools = {"torch": _pool(pipes["int8"]["torch"], 12, 4),
             "jax": JPool(pipes["int8"]["jax"], 12, 4,
                          registry=jprom.Registry())}
    seen = {}
    for name, pool in pools.items():
        a = pool.alloc(5)
        b = pool.alloc(3)
        pool.share(a[1:3])
        pool.release(a)
        pool.adopt("r", b)
        c = pool.alloc(4)
        seen[name] = (a, b, c, pool.free_pages, pool.refcounts(),
                      pool.stats())
    assert seen["torch"] == seen["jax"]


def test_pool_owner_sweep_reclaims_orphans(pipe):
    pool = _pool(pipe, n_pages=8, page_size=4)
    dead = pool.alloc(3)
    pool.adopt("dead-req", dead)
    live = pool.alloc(2)
    pool.adopt("live-req", live)
    bare = pool.alloc(1)
    assert pool.free_pages == 2
    assert pool.sweep_leaked({"live-req"}) == 3
    assert pool.free_pages == 5
    assert pool.stats()["leaked"] == 3
    assert pool.sweep_leaked({"live-req"}) == 0
    assert pool.sweep_leaked(lambda: {"live-req"}) == 0
    assert pool.sweep_leaked(lambda: None) == 0
    assert pool.disown("dead-req") is None
    pool.release(live + bare)
    pool.disown("live-req")
    assert pool.free_pages == 8


def test_pool_gather_scatter_roundtrip(pipe):
    pool = _pool(pipe, n_pages=6, page_size=4)
    pids = pool.alloc(2)
    table = np.asarray([pids], np.int64)
    view = pool.gather(0, table)
    n_blocks = pipe.stages[0]["n_blocks"]
    assert view["k"].shape == (n_blocks, 1, 8, CFG.kv_heads, CFG.head_dim)
    marked = {k: torch.full_like(v, 7.0) for k, v in view.items()}
    pool.scatter(0, table, marked, [(0, 0), (0, 1)])
    again = pool.gather(0, table)
    assert (again["k"] == 7).all()
    # the view is a copy: writing it does not write the arena
    again["k"].zero_()
    assert (pool.gather(0, table)["k"] == 7).all()
    # scattering only page 0 leaves page 1 untouched
    half = {k: torch.zeros_like(v) for k, v in again.items()}
    pool.scatter(0, table, half, [(0, 0)])
    mixed = pool.gather(0, table)["k"]
    assert (mixed[:, :, :4] == 0).all() and (mixed[:, :, 4:] == 7).all()
    pool.release(pids)


def _fill_both(pools, seed):
    """Write the same random rows into every page of both packages'
    arenas (through each pool's own scatter), leaf by leaf."""
    rng = np.random.default_rng(seed)
    tpool, jpool = pools["torch"], pools["jax"]
    n = tpool.n_pages
    table = np.arange(n)[None]
    writes = [(0, j) for j in range(n)]
    for stage in range(len(tpool.pipe.stages)):
        tview = tpool.gather(stage, table)
        rows = {}
        for name, leaf in tview.items():
            if leaf.dtype == torch.int8:
                rows[name] = rng.integers(-128, 128, size=leaf.shape,
                                          dtype=np.int8)
            else:
                rows[name] = rng.standard_normal(leaf.shape).astype(
                    np.float32)
        tpool.scatter(stage, table, {k: torch.from_numpy(v.copy())
                                     for k, v in rows.items()}, writes)
        jpool.scatter(stage, table, {k: jnp.asarray(v)
                                     for k, v in rows.items()}, writes)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("page_size", [4, 8])
def test_gather_equals_jax_pool(pipes, mode, page_size):
    """A page table [B, n] over the same arena contents gathers the same
    leaves [L, B, n * page, ...] in both packages, and the port's view is
    contiguous, with the 16-byte aligned block windows the
    decode-attention kernel takes (the check its route gate asks)."""
    pools = {"torch": _pool(pipes[mode]["torch"], 10, page_size),
             "jax": JPool(pipes[mode]["jax"], 10, page_size,
                          registry=jprom.Registry())}
    _fill_both(pools, seed=page_size)
    table = np.asarray([[3, 7, 1], [9, 0, 4]], np.int64)
    for stage in range(len(PARTITION)):
        got = pools["torch"].gather(stage, table)
        want = pools["jax"].gather(stage, table)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]),
                                          err_msg=name)
            assert got[name].is_contiguous()
        if mode == "int8":
            assert decode_attention.window_refusal(
                got["k"][0][:, :2 * page_size],
                got["v"][0][:, :2 * page_size]) is None


# ---------------------------------------------------------------------------
# prefix trie: hit / miss / partial + eviction under pressure
# ---------------------------------------------------------------------------

def test_prefix_trie_hit_miss_partial(pipe):
    pool = _pool(pipe, n_pages=16, page_size=4)
    trie = PrefixTrie(pool, registry=prom.Registry())
    toks = list(range(12))
    pids = pool.alloc(3)
    assert trie.insert(toks, pids) == 3
    assert len(trie) == 3
    got = trie.lookup(toks)
    assert got == pids
    assert all(pool.refcount(p) == 3 for p in pids)
    part = trie.lookup(toks[:8] + [99, 98, 97, 96])
    assert part == pids[:2]
    assert trie.lookup([55] * 12) == []
    capped = trie.lookup(toks, max_tokens=11)
    assert capped == pids[:2]
    assert trie.peek(toks, max_tokens=11) == 8
    st = trie.stats()
    assert st["lookups"] == 4 and st["pages_cached"] == 3
    assert st["hits"] == 3 and st["misses"] == 1
    for got_pids in (got, part, capped):
        pool.release(got_pids)


def test_trie_eviction_under_pressure(pipe):
    pool = _pool(pipe, n_pages=4, page_size=4)
    trie = PrefixTrie(pool, registry=prom.Registry())
    pool.set_evict_hook(trie.evict_cold)
    pids = pool.alloc(3)
    trie.insert(list(range(12)), pids)
    pool.release(pids)
    assert trie.cold_pages() == 3 and pool.free_pages == 1
    got = pool.alloc(3)
    assert len(got) == 3 and len(trie) < 3
    pool.release(got)
    trie.evict_cold(None)
    pids2 = pool.alloc(2)
    trie.insert(list(range(8)), pids2)
    held = trie.lookup(list(range(8)))
    assert held == pids2
    assert trie.cold_pages() == 0
    with pytest.raises(PoolExhausted):
        pool.alloc(4)
    pool.release(held)
    pool.release(pids2)
    assert trie.evict_cold(None) == 2
    assert pool.free_pages == 4


# ---------------------------------------------------------------------------
# token-budget admission
# ---------------------------------------------------------------------------

def test_token_budget_admission_admits_beyond_slots_worth():
    ctl = tadm.AdmissionController(concurrency=32, queue_capacity=8,
                                   registry=prom.Registry(),
                                   token_budget=96)
    small = [ctl.admit("interactive", tokens=12) for _ in range(8)]
    assert len(small) == 8
    snap = ctl.snapshot()
    assert snap["token_budget"] == 96 and snap["tokens_free"] == 0
    with pytest.raises(tadm.AdmissionShed) as err:
        ctl.admit("interactive", tokens=97)
    assert err.value.reason == "budget"
    granted = []

    def late():
        granted.append(ctl.admit("interactive", tokens=12))

    th = threading.Thread(target=late, daemon=True)
    th.start()
    th.join(timeout=0.5)
    assert th.is_alive() and not granted
    ctl.release(small[0])
    th.join(timeout=30)
    assert not th.is_alive() and granted
    for t in small[1:] + granted:
        ctl.release(t)
    assert ctl.snapshot()["tokens_free"] == 96


def test_token_budget_head_keeps_queue_position():
    """A token-short EDF head is NOT re-queued behind a later small
    request: it keeps its place and is granted first once tokens free up.
    The grant order is recorded AT THE GRANT, under the controller's lock
    (the JAX test records it after `admit` returns in each waiter thread,
    so the two waiters woken by one release may append in either order)."""
    ctl = tadm.AdmissionController(concurrency=4, queue_capacity=8,
                                   registry=prom.Registry(),
                                   token_budget=100)
    h1 = ctl.admit("interactive", tokens=50)
    h2 = ctl.admit("interactive", tokens=50)
    granted = []
    take = ctl._take_tokens_locked

    def recording(tokens):      # called under the lock, at each grant
        granted.append(tokens)
        take(tokens)

    ctl._take_tokens_locked = recording

    def wait_depth(n, budget=120.0):
        end = time.monotonic() + budget
        while time.monotonic() < end and ctl.queue_depth != n:
            time.sleep(0.01)
        assert ctl.queue_depth == n

    waiters = [threading.Thread(target=ctl.admit, args=("interactive",),
                                kwargs={"tokens": tokens}, daemon=True)
               for tokens in (80, 10)]
    waiters[0].start()
    wait_depth(1)
    waiters[1].start()
    wait_depth(2)
    # 50 tokens free: not enough for the 80-token head, and the small
    # request behind it must NOT overtake
    ctl.release(h1)
    time.sleep(0.2)
    assert granted == [] and ctl.queue_depth == 2
    ctl.release(h2)             # 100 free: the head, then the small one
    for th in waiters:
        th.join(timeout=30)
        assert not th.is_alive()
    assert granted == [80, 10]


# ---------------------------------------------------------------------------
# paged executors: refusals, blocking, capacity
# ---------------------------------------------------------------------------

def test_paged_submit_rejects_bigger_than_pool(pipe):
    ids = np.zeros((1, 6), np.int64)    # 6 + 8 tokens -> 4 pages > 2
    b = tbatcher.ContinuousBatcher(pipe, kv=_backend(pipe, n_pages=2))
    with pytest.raises(ValueError, match="KV page"):
        b.submit("big", ids, new_tokens=8)
    assert not b.pending and b.tick() is False
    handle = pipe.precompute_prefix(np.asarray([[1, 2, 3, 4]]))
    with pytest.raises(ValueError, match="prefix trie"):
        b.submit("pfx", ids, new_tokens=2, prefix=handle)
    ex = tbatcher.StageWorkerExecutor(pipe, kv=_backend(pipe, n_pages=2))
    try:
        with pytest.raises(ValueError, match="KV page"):
            ex.submit("big", ids, 8)
        with pytest.raises(ValueError, match="prefix trie"):
            ex.submit("pfx", ids, 2, prefix=handle)
        assert ex.active == 0
    finally:
        ex.stop()


def test_paged_stop_wakes_page_blocked_submitter(pipe):
    """A submitter parked on PAGE availability (slots free, pages not)
    raises on `stop()` instead of hanging."""
    kv = _backend(pipe, n_pages=12, page_size=4)
    ex = tbatcher.StageWorkerExecutor(pipe, kv=kv, max_active=8)
    errs = {}
    first_token = threading.Event()
    ids = np.zeros((1, 4), np.int64)

    def client(rid, tokens, **kw):
        try:
            ex.submit(rid, ids, tokens, **kw)
            ex.wait(rid, timeout=120)
        except RuntimeError as exc:
            errs[rid] = str(exc)

    # "a" reserves the whole pool (4 + 44 tokens -> 12 pages, the cap)
    t_a = threading.Thread(target=client, args=("a", 44), daemon=True,
                           kwargs={"on_token":
                                   lambda s, t: first_token.set()})
    t_a.start()
    assert first_token.wait(timeout=120)
    t_b = threading.Thread(target=client, args=("b", 4), daemon=True)
    t_b.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and "b" not in ex._live:
        time.sleep(0.01)
    assert "b" in ex._live
    ex.stop()
    t_a.join(timeout=120)
    t_b.join(timeout=120)
    assert not t_a.is_alive() and not t_b.is_alive()
    assert "b" in errs and "closed" in errs["b"]


def test_paged_batcher_active_exceeds_dense_slot_equivalent(pipe):
    kv = _backend(pipe, n_pages=24, page_size=4)     # 96 tokens
    batcher = tbatcher.ContinuousBatcher(pipe, kv=kv)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, CFG.vocab_size, size=(1, 8))
    batcher.submit("seed", np.concatenate(
        [shared, rng.integers(0, CFG.vocab_size, size=(1, 4))], axis=1),
        new_tokens=4)
    batcher.run()
    for i in range(6):
        ids = np.concatenate(
            [shared, rng.integers(0, CFG.vocab_size, size=(1, 4))], axis=1)
        batcher.submit(i, ids, new_tokens=4)
    peak = 0
    while batcher.tick():
        peak = max(peak, batcher.active)
    assert peak > 2
    assert len(batcher.results) == 7
    assert kv.trie.stats()["pages_reused_total"] > 0
    assert kv.pool.free_pages + kv.trie.stats()["pages_cached"] \
        == kv.pool.n_pages


# ---------------------------------------------------------------------------
# paged decode parity
# ---------------------------------------------------------------------------

def _paged_traffic():
    """rid -> (ids, new_tokens): single rows that share a whole-page
    prefix with an earlier one (trie hits at page size 4), a two-row
    request, and prompts long enough to chunk at 4 tokens."""
    rng = np.random.default_rng(21)
    shared = rng.integers(0, CFG.vocab_size, size=(1, 8))
    tail = lambda n: rng.integers(0, CFG.vocab_size, size=(1, n))  # noqa
    return {"p": (shared, 6),
            "s1": (np.concatenate([shared, tail(3)], axis=1), 7),
            "s2": (np.concatenate([shared, tail(5)], axis=1), 5),
            "b2": (rng.integers(0, CFG.vocab_size, size=(2, 6)), 6),
            "x": (tail(11), 9)}


def _run_paged(pkg, pipe, executor, chunk, step_join, page_size):
    """The traffic through one package's paged executor: "p" alone first
    (it publishes its prompt's pages), then the rest at once."""
    mod = {"jax": jbatcher, "torch": tbatcher}[pkg]
    kv = (_jbackend if pkg == "jax" else _backend)(pipe, 40, page_size)
    traffic = _paged_traffic()
    conv = (lambda a: np.asarray(a, np.int32)) if pkg == "jax" \
        else (lambda a: a)
    if executor == "wave":
        ex = mod.ContinuousBatcher(pipe, kv=kv, chunk_tokens=chunk,
                                   step_join=step_join, max_active=3)
        ex.submit("p", conv(traffic["p"][0]), traffic["p"][1])
        ex.run()
        for rid, (ids, n) in traffic.items():
            if rid != "p":
                ex.submit(rid, conv(ids), n)
        out = ex.run()
    else:
        ex = mod.StageWorkerExecutor(pipe, kv=kv, chunk_tokens=chunk,
                                     step_join=step_join, max_active=3)
        try:
            ex.submit("p", conv(traffic["p"][0]), traffic["p"][1])
            out = {"p": ex.wait("p", timeout=300)}
            threads = [threading.Thread(
                target=lambda r=rid, a=ids, n=n: ex.submit(r, conv(a), n),
                daemon=True) for rid, (ids, n) in traffic.items()
                if rid != "p"]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            for rid in traffic:
                if rid != "p":
                    out[rid] = ex.wait(rid, timeout=300)
        finally:
            ex.stop()
    return {k: np.asarray(v) for k, v in out.items()}, kv


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("executor", ["wave", "stage"])
@pytest.mark.parametrize("sched", [(0, False, 4), (4, True, 4),
                                   (0, False, 8)],
                         ids=["plain-p4", "chunk4-join-p4", "plain-p8"])
def test_paged_executors_match_jax_and_dense(pipes, mode, executor, sched):
    """Greedy tokens of the port's paged executor equal the JAX paged
    executor's and the port's dense executor's on the same traffic and
    scheduling; with dense prefill (no chunking) each also equals its
    solo `generate` (an int8 chunked prompt pass is its own computation,
    and fp chunks equal the single pass). Trie-shared prefixes are hit
    and every page comes back (free or cached)."""
    chunk, join, page_size = sched
    got, kv = _run_paged("torch", pipes[mode]["torch"], executor, chunk,
                         join, page_size)
    want, _ = _run_paged("jax", pipes[mode]["jax"], executor, chunk, join,
                         page_size)
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    dense = tbatcher.ContinuousBatcher(pipes[mode]["torch"],
                                       chunk_tokens=chunk, step_join=join)
    for rid, (ids, n) in _paged_traffic().items():
        dense.submit(rid, ids, n)
    for rid, arr in dense.run().items():
        np.testing.assert_array_equal(got[rid], arr, err_msg=rid)
    if not chunk or mode == "fp":
        for rid, (ids, n) in _paged_traffic().items():
            np.testing.assert_array_equal(
                got[rid], pipes[mode]["torch"].generate(ids, n).numpy(),
                err_msg=rid)
    st = kv.trie.stats()
    # the two sharers each reuse the 8-token prefix's whole pages
    assert st["hits"] >= 2 and st["pages_reused_total"] >= 2 * (8 // page_size)
    assert kv.pool.free_pages + st["pages_cached"] == kv.pool.n_pages
    assert kv.pool.stats()["owners"] == 0


@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_paged_sampled_equals_port_solo_runs(pipe, executor):
    """Sampled requests on a paged executor equal the port's own solo
    `generate` with the same seed (and a second seed draws otherwise)."""
    ids = _prompts(1, lens=(7,), seed0=3)[0]
    reqs = {"s1": dict(temperature=0.8, seed=1),
            "s2": dict(temperature=1.1, top_k=5, seed=2)}
    kv = _backend(pipe)
    if executor == "wave":
        b = tbatcher.ContinuousBatcher(pipe, kv=kv)
        for rid, kw in reqs.items():
            b.submit(rid, ids, 8, **kw)
        got = b.run()
    else:
        ex = tbatcher.StageWorkerExecutor(pipe, kv=kv)
        try:
            for rid, kw in reqs.items():
                ex.submit(rid, ids, 8, **kw)
            got = {rid: ex.wait(rid, timeout=120) for rid in reqs}
        finally:
            ex.stop()
    for rid, kw in reqs.items():
        np.testing.assert_array_equal(
            got[rid], pipe.generate(ids, 8, **kw).numpy(), err_msg=rid)
    assert not np.array_equal(got["s1"], got["s2"])


def test_paged_touched_pages_and_publish_match_jax(pipes):
    """After the same traffic, the port's and the JAX backend's tries
    hold the same pages for the same tokens, and their pools the same
    free pages and refcounts."""
    tkv = _run_paged("torch", pipes["fp"]["torch"], "wave", 0, False, 4)[1]
    jkv = _run_paged("jax", pipes["fp"]["jax"], "wave", 0, False, 4)[1]
    assert tkv.pool.refcounts() == jkv.pool.refcounts()
    assert tkv.pool.free_pages == jkv.pool.free_pages
    assert tkv.trie.stats() == jkv.trie.stats()
    assert tkv.snapshot()["pool"] == jkv.snapshot()["pool"]
    assert tkv.evict_cold_all() == jkv.evict_cold_all()
    assert tkv.pool.free_pages == tkv.pool.n_pages


def test_paged_sizing_matches_jax(pipes):
    tkv, jkv = _backend(pipes["fp"]["torch"]), _jbackend(pipes["fp"]["jax"])
    for prompt, new, batch in ((1, 1, 1), (6, 8, 1), (9, 30, 2), (40, 8, 1),
                               (5, 43, 3)):
        assert tkv.pool.pages_needed(prompt, new, batch) == \
            jkv.pages_needed(prompt, new, batch)
        assert tkv.tokens_needed(prompt, new, batch) == \
            jkv.tokens_needed(prompt, new, batch)
    assert tkv.shared_prompt_tokens([1, 2, 3]) == 0


def test_ship_dependent_methods_name_their_items(pipes):
    """The router's prefix migration is ported (kv/ship.py frames; held in
    tests/test_torch_wire.py): with nothing cached both backends export
    None and refuse a malformed handle alike. The shipped-KV install of
    disaggregated prefill refuses a handle of the wrong stage count with
    the JAX backend's error, returning the pages it charged, and installs
    a well-formed one (the first token picked at admission)."""
    from pipeedge_tpu_torch.kv import PrefillFleet
    kv = _backend(pipes["fp"]["torch"])
    jkv = _jbackend(pipes["fp"]["jax"])
    assert kv.export_prefix([1, 2, 3, 4]) is None
    assert jkv.export_prefix([1, 2, 3, 4]) is None
    bad = {"prompt_len": 3, "stage_rows": []}
    for backend in (kv, jkv):
        with pytest.raises(ValueError, match="multiple of page_size"):
            backend.install_prefix([1, 2, 3, 4], bad)
    ids = _prompts(1)[0]
    errors = []
    for backend, mod in ((kv, tbatcher), (jkv, jbatcher)):
        pipe = backend.pipe
        req = mod._build_request(pipe, "x", ids, 4, 0.0, 0, 0, None, None,
                                 None, shipped={"prompt_len": 6,
                                                "stage_rows": [], "logits":
                                                np.zeros((1, 8))})
        with pytest.raises(ValueError) as err:
            backend.admit(req)
        errors.append(str(err.value))
        assert backend.pool.free_pages == backend.pool.n_pages
    assert errors[0] == errors[1] == \
        "shipped KV has 0 stages; this pipeline has 2"
    pipe = pipes["fp"]["torch"]
    handle = PrefillFleet(pipe, registry=prom.Registry()).prefill(ids)
    req = tbatcher._build_request(pipe, "ok", ids, 4, 0.0, 0, 0, None,
                                  None, None, shipped=handle)
    with torch.inference_mode():
        kind, token = kv.admit(req)
    assert kind == "step" and len(req.tokens) == 1
    assert torch.equal(token[:, 0], req.tokens[0])
    kv.release(req)


def test_orphan_sweep_reclaims_a_dead_submitters_pages(pipe):
    """A request whose pages were charged but never released (its
    submitter died) leaks nothing once the sweep runs, and a late release
    is a no-op."""
    kv = _backend(pipe, n_pages=24, page_size=4)
    req = tbatcher._build_request(pipe, "died", np.zeros((1, 6), np.int64),
                                  4, 0.0, 0, 0, None, None, None)
    kind, _ = kv.admit(req)
    assert kind == "prefill"
    taken = kv.pool.n_pages - kv.pool.free_pages
    assert taken == 4 and kv.sweep_orphans(set()) == taken
    assert kv.pool.free_pages == kv.pool.n_pages
    kv.release(req)
    assert kv.pool.free_pages == kv.pool.n_pages
