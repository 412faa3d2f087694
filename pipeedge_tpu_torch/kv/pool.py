"""Paged KV pool: fixed-size token pages behind per-request page tables.

Port of `pipeedge_tpu/kv/pool.py`. Dense per-request cache slots bound
serving concurrency by SLOTS: a 6-token request holds as much KV memory
as a 1024-token one. The pool bounds it by TOKENS instead:

- **One page arena per stage**, preallocated on the pipeline's device:
  page `p` of stage `i` holds `page_size` token positions of every cache
  leaf of that stage (K, V and, for an int8 cache, their scale/shift
  rows), so one page-id list describes a request on every stage.
- **Page tables, not slots**: a request holds `ceil((prompt + new_tokens)
  / page_size)` pages per batch row; admission charges tokens.
- **Refcounted sharing**: the prefix trie (`kv/prefix.py`) retains a
  finished prompt's pages, and a later request with the same prompt
  prefix references the SAME pages instead of re-prefilling them.
- **The executors' cache layout is unchanged**: a request's stage view is
  gathered from the arena, `[n_blocks, B, pages * page_size, ...]`, the
  layout `DecodePipeline`'s stage functions consume; the pages a step
  wrote are scattered back (`kv/backend.py`).

Layout (the port's own): each arena leaf is `[n_blocks, P, page_size,
...]`, the page axis second. A gather is one `index_select` on that axis
per leaf, whose output `[n_blocks, B * n, page_size, ...]` reshapes as a
view into the contiguous `[n_blocks, B, n * page_size, ...]` the stage
functions write in place. Each block's window therefore has the 16-byte
aligned bases and strides the decode-attention kernel takes
(`ops/decode_attention.window_refusal`), exactly as a dense cache does.
A scatter is one `index_select` of the written pages out of the view and
one `index_copy_` into the arena per leaf. The index tensors reach the
card by non-blocking copies from pinned memory, so neither waits for the
device. The JAX package lays its arenas out `[P, n_blocks, page, ...]`
and moves the axis after the gather; the gathered leaves are equal.

Eviction: when the free list runs dry, `alloc` calls the registered evict
hook (the trie's cold-page eviction) before failing, and the brownout
ladder's `evict_cold_pages` rung calls it ahead of need.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import metrics as prom
from ..utils.threads import make_condition


class PoolExhausted(RuntimeError):
    """The pool cannot supply the requested pages, even after cold-page
    eviction. The serving layer's token-budget admission keeps this
    unreachable; from a raw executor it is backpressure."""

    def __init__(self, need: int, free: int, capacity: int):
        super().__init__(
            f"KV page pool exhausted: need {need} page(s), {free} free "
            f"of {capacity}")
        self.need = need
        self.free = free
        self.capacity = capacity


def pages_for(tokens: int, page_size: int) -> int:
    """Pages covering `tokens` cache positions (ceil division)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(page_size))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def device_index(values, device: torch.device) -> torch.Tensor:
    """A 1-D int64 index tensor on `device` from host `values`. On the
    card it is copied from pinned memory without blocking the host; the
    caching host allocator keeps the pinned buffer until the copy ran."""
    host = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class KvPagePool:
    """Preallocated per-stage page arenas + one global page-id space.

    `pipe` supplies the per-stage cache geometry (block counts, KV head
    layout, dtype, cache_bits) and the device the arenas live on. Arena
    leaves mirror `init_cache`'s leaves with the batch axis replaced by
    the page axis. Tensor-, sequence- and expert-parallel pipelines are
    refused (the port's `DecodePipeline` has none until ROADMAP A7).

    Thread model: page accounting (free list, refcounts, owners) lives
    under one condition; `release` notifies, so a blocking `alloc` wakes
    on completions. `scatter` writes the arenas in place; the caller
    (`kv/backend.py`) serializes them under its arena lock.
    """

    def __init__(self, pipe, n_pages: int, page_size: int = 16,
                 registry: Optional[prom.Registry] = None):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if getattr(pipe, "mesh", None) is not None \
                or getattr(pipe, "ep_mesh", None) is not None \
                or getattr(pipe, "tp_ep_mesh", None) is not None \
                or getattr(pipe, "sp_degree", 1) != 1:
            raise ValueError(
                "paged KV covers the host-driven pipeline; tp/ep/sp mesh "
                "pipelines keep their sharded dense caches")
        from ..parallel.decode import init_cache
        self.pipe = pipe
        self.device = pipe.device
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # template leaf [L, P, page, ...]: init_cache's batch axis sized
        # to the page count
        self._arena: List[Dict[str, torch.Tensor]] = [
            init_cache(pipe.cfg, st["n_blocks"], self.n_pages, page_size,
                       pipe.dtype, cache_bits=pipe.cache_bits,
                       device=self.device)
            for st in pipe.stages]
        self._cond = make_condition("kv.pool")
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        # owner ledger (leak audit): the page references a live REQUEST
        # holds, keyed by its id; the periodic sweep reconciles it
        # against executor liveness
        self._owners: Dict[str, List[int]] = {}
        self._evict_hook: Optional[Callable[[int], int]] = None
        self._closed = False
        reg = prom.REGISTRY if registry is None else registry
        self.m_pages = reg.gauge(
            "pipeedge_kv_pages",
            "KV page pool accounting by state (total / free); occupancy "
            "= 1 - free/total (docs/SERVING.md paged KV plane)")
        self.m_pages.set(self.n_pages, state="total")
        self.m_pages.set(self.n_pages, state="free")
        self.m_evicted = reg.counter(
            "pipeedge_kv_pages_evicted_total",
            "cold prefix pages reclaimed from the trie (allocation "
            "pressure or the brownout evict_cold_pages rung)")
        self.m_evicted.declare()
        self.m_leaked = reg.counter(
            "pipeedge_kv_pages_leaked_total",
            "page references reclaimed by the orphan sweep: their "
            "owning request was no longer live (submitter/shipper died "
            "between page charge and release — "
            "docs/FAULT_TOLERANCE.md disaggregated serving)")
        self.m_leaked.declare()

    # -- accounting -------------------------------------------------------

    @property
    def tokens_capacity(self) -> int:
        """Total cache positions the pool can hold (the admission token
        budget's natural value)."""
        return self.n_pages * self.page_size

    def pages_needed(self, prompt_len: int, new_tokens: int,
                     batch: int = 1) -> int:
        """The pages a request of `batch` rows reserves: each row's span
        rounded up to a power of two (so the attend windows of its steps
        keep the dense path's buckets), capped at the pipeline's
        `max_len`."""
        per_row = min(_next_pow2(pages_for(prompt_len + new_tokens,
                                           self.page_size)),
                      pages_for(self.pipe.max_len, self.page_size))
        return per_row * batch

    @property
    def free_pages(self) -> int:
        with self._cond:
            return len(self._free)

    @property
    def arena_bytes(self) -> int:
        """Device bytes the arenas hold, every stage and leaf."""
        return sum(t.numel() * t.element_size()
                   for leaves in self._arena for t in leaves.values())

    def set_evict_hook(self, hook: Optional[Callable[[int], int]]) -> None:
        """`hook(need) -> freed` reclaims cold pages (the prefix trie's
        eviction); called OUTSIDE the pool lock on allocation pressure."""
        self._evict_hook = hook

    def refcount(self, pid: int) -> int:
        with self._cond:
            return self._refs.get(pid, 0)

    def refcounts(self) -> Dict[int, int]:
        """One locked snapshot of every page's refcount (the trie's
        cold-page walks take it once, not once per node)."""
        with self._cond:
            return dict(self._refs)

    def close(self) -> None:
        """Fail every current and future BLOCKING allocation: the
        executor's death/stop path wakes submitters parked on page
        availability. Releases still work, so in-flight completions
        drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def alloc(self, n: int, block: bool = False,
              timeout: Optional[float] = None) -> List[int]:
        """Take `n` fresh pages (refcount 1 each). On a dry free list the
        evict hook runs first; `block=True` then waits for releases (the
        stage-worker submit path's backpressure) up to `timeout`."""
        if n <= 0:
            return []
        if n > self.n_pages:
            raise PoolExhausted(n, self.free_pages, self.n_pages)
        while True:
            with self._cond:
                if self._closed:
                    raise RuntimeError(
                        "KV page pool closed (executor shut down)")
                if len(self._free) >= n:
                    pids = [self._free.pop() for _ in range(n)]
                    for p in pids:
                        self._refs[p] = 1
                    self.m_pages.set(len(self._free), state="free")
                    return pids
                short = n - len(self._free)
            hook = self._evict_hook
            if hook is not None and hook(short) > 0:
                continue            # eviction freed something: retry
            with self._cond:
                if self._closed:
                    raise RuntimeError(
                        "KV page pool closed (executor shut down)")
                if len(self._free) >= n:
                    continue        # a release raced us: retry the take
                if not block:
                    raise PoolExhausted(n, len(self._free), self.n_pages)
                if not self._cond.wait(timeout):
                    raise PoolExhausted(n, len(self._free), self.n_pages)

    def share(self, pids: Sequence[int]) -> None:
        """Add one reference to each page (prefix reuse / trie retention)."""
        with self._cond:
            for p in pids:
                if self._refs.get(p, 0) <= 0:
                    raise ValueError(f"share of unallocated page {p}")
                self._refs[p] += 1

    def release(self, pids: Sequence[int], evicted: bool = False) -> None:
        """Drop one reference per page; refcount 0 returns the page to
        the free list and wakes blocked allocators."""
        freed = 0
        with self._cond:
            for p in pids:
                r = self._refs.get(p, 0)
                if r <= 0:
                    raise ValueError(f"release of unallocated page {p}")
                if r == 1:
                    del self._refs[p]
                    self._free.append(p)
                    freed += 1
                else:
                    self._refs[p] = r - 1
            if freed:
                self.m_pages.set(len(self._free), state="free")
                self._cond.notify_all()
        if evicted and freed:
            self.m_evicted.inc(freed)

    # -- owner ledger + orphan sweep (leak audit) -------------------------

    def adopt(self, owner, pids: Sequence[int]) -> None:
        """Record `owner` (a request id) as holding one reference to each
        page in `pids`: the set `disown` hands to exactly one releaser."""
        with self._cond:
            self._owners[str(owner)] = list(pids)

    def disown(self, owner) -> Optional[List[int]]:
        """Claim `owner`'s page references for release; None when already
        claimed (the request's own release and the orphan sweep race
        benignly: whoever pops the ledger entry releases)."""
        with self._cond:
            return self._owners.pop(str(owner), None)

    def sweep_leaked(self, live_owners) -> int:
        """Drop the page references of every ledger owner that is no
        longer live. Executors list a request as live before charging
        pages and release pages before delisting it, so the ledger is
        read FIRST and liveness SECOND: pass `live_owners` as a callable
        for a live system (called after the ledger snapshot; None aborts
        the sweep). A plain set serves offline callers. Returns the page
        references dropped (counted on pipeedge_kv_pages_leaked_total)."""
        with self._cond:
            owners = list(self._owners)
        if callable(live_owners):
            live_owners = live_owners()
            if live_owners is None:     # liveness snapshot raced; skip
                return 0
        live = {str(o) for o in live_owners}
        leaked = 0
        for owner in (o for o in owners if o not in live):
            pids = self.disown(owner)
            if pids:
                self.release(pids)
                leaked += len(pids)
        if leaked:
            self.m_leaked.inc(leaked)
        return leaked

    def stats(self) -> dict:
        with self._cond:
            free = len(self._free)
            shared = sum(1 for r in self._refs.values() if r > 1)
            owners = len(self._owners)
        return {"pages_total": self.n_pages, "pages_free": free,
                "page_size": self.page_size,
                "pages_shared": shared,
                "occupancy": round(1.0 - free / self.n_pages, 4),
                "pages_evicted_total": int(self.m_evicted.value()),
                "owners": owners,
                "leaked": int(self.m_leaked.value())}

    # -- the gather/scatter indirection ----------------------------------

    def index(self, table) -> torch.Tensor:
        """A page table `[B, n]` as the flat device index `gather` takes
        (a request's table is fixed for its lifetime: make it once)."""
        return device_index(table, self.device)

    def gather(self, stage: int, table,
               index: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Materialize a request's stage-`stage` cache view from its page
        table `[B, n]` -> new contiguous leaves `[L, B, n * page_size,
        ...]` (the layout `DecodePipeline`'s stage functions consume and
        write in place). `index` is `self.index(table)`, when the caller
        keeps one."""
        table = np.asarray(table)
        batch, n = table.shape
        ids = self.index(table) if index is None else index
        out = {}
        for name, arr in self._arena[stage].items():
            g = arr.index_select(1, ids)           # [L, B*n, page, ...]
            out[name] = g.view(g.shape[0], batch, n * self.page_size,
                               *g.shape[3:])
        return out

    def scatter(self, stage: int, table, cache: Dict[str, torch.Tensor],
                writes: Sequence[Tuple[int, int]]) -> None:
        """Write the view pages named by `writes`, `(row, page_col)`
        pairs into `table`, back into the stage arena. Only a request's
        PRIVATE, TOUCHED pages are written (`kv/backend.py` computes the
        set), so shared prefix pages are never written."""
        if not writes:
            return
        table = np.asarray(table)
        n = table.shape[1]
        b_idx = np.asarray([b for b, _ in writes], np.int64)
        j_idx = np.asarray([j for _, j in writes], np.int64)
        pids = device_index(table[b_idx, j_idx], self.device)
        rows = device_index(b_idx * n + j_idx, self.device)
        for name, arr in self._arena[stage].items():
            v = cache[name]                        # [L, B, n*page, ...]
            v = v.reshape(v.shape[0], v.shape[1] * n, self.page_size,
                          *v.shape[3:])
            arr.index_copy_(1, pids, v.index_select(1, rows))
