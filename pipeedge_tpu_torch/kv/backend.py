"""Paged-KV execution backend for the serving executors.

Port of `pipeedge_tpu/kv/backend.py`. `ContinuousBatcher` and
`StageWorkerExecutor` (`parallel/batcher.py`) drive per-request
stage-steps; this backend replaces their dense per-request cache slots
with page-table indirection over the shared pool:

- **admit**: charge `ceil((prompt + new_tokens) / page_size)` pages per
  batch row (rounded up to a power of two, capped at `max_len`), and walk
  the prefix trie for whole-page prompt reuse (single-row requests).
- **run_stage**: gather the request's cache view from the page arena, run
  the UNCHANGED stage function (prefill / span / chunk / step, exactly
  `batcher._run_stage`'s semantics and spans), then scatter back only
  the pages the step wrote AND the request privately owns: shared prefix
  pages are never written.
- **release**: drop the request's page references; a completed prompt's
  full pages were published to the trie at the end of its prompt pass,
  so the NEXT request with that prefix reuses them.

Numerics: the gathered view is `[n_blocks, B, pages * page_size, ...]`
instead of the dense `[.., max_len, ..]`. Positions past a step's live
rows are masked to exact softmax zeros either way, and a step attends
`min(read_len, pages * page_size)` rows; a prefill attends its own prompt
rows only, on either cache (`parallel/decode.py`). So a paged step runs
the dense step's computation wherever its view is at least the attend
bucket wide, which the power-of-two page count makes the rule; a request
of fewer pages than the attend floor attends a narrower window on fp
caches (the same masked function, reduced over fewer zeros), while the
int8 decode-attention kernel reads only the live rows on any width.
Int8 caches carry the same quantization caveat as `precompute_prefix`
reuse.

Thread model: page/trie accounting locks live in pool/prefix; the
arena's read-modify-write (gather -> stage function -> scatter) is
serialized under one arena lock. On the card every executor thread
enqueues on the device's default stream, so the hold is host-side only.

Not ported yet: installing shipped prefill KV (`shipped=`, ROADMAP
A5.3b) and the router's prefix migration (`export_prefix` /
`install_prefix`, ROADMAP A5.2a); both stand on `kv/ship.py` and
`comm/wire.py`'s v2 framing, and raise until those are ported.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..telemetry import metrics as prom
from ..utils.threads import make_lock
from .pool import KvPagePool, pages_for
from .prefix import PrefixTrie

# the ROADMAP items that port what stands on kv/ship.py
_MIGRATE = ("ROADMAP A5.2a, with port copies of kv/ship.py and "
            "comm/wire.py's v2 framing")
_DISAGG = "ROADMAP A5.3b with A6, the prefill supervisors"


def _ship_refusal(what: str, item: str) -> ValueError:
    return ValueError(f"{what}: KV shipping is not ported to "
                      f"pipeedge_tpu_torch yet ({item})")


class PagedKvBackend:
    """The executors' cache provider: page tables instead of dense slots,
    over one `KvPagePool` and the `PrefixTrie` that shares its prompt
    pages (single-row requests only: lockstep multi-row prompts have
    per-row token content)."""

    def __init__(self, pipe, n_pages: int, page_size: int = 16,
                 registry: Optional[prom.Registry] = None):
        self.pipe = pipe
        self.pool = KvPagePool(pipe, n_pages, page_size, registry=registry)
        self.page_size = self.pool.page_size
        self.trie = PrefixTrie(self.pool, registry=registry)
        self.pool.set_evict_hook(self.trie.evict_cold)
        self._arena_lock = make_lock("kv.arena")
        self._n_stages = len(pipe.stages)

    # -- sizing -----------------------------------------------------------

    def tokens_needed(self, prompt_len: int, new_tokens: int,
                      batch: int = 1) -> int:
        """The admission token charge (pages x page_size: what the
        request actually reserves, bucketing included)."""
        return self.pool.pages_needed(prompt_len, new_tokens,
                                      batch) * self.page_size

    def can_admit(self, req) -> bool:
        """Whether `admit` would succeed right now (free + evictable
        cold pages cover the request): the wave batcher's pending-queue
        gate, so a too-big head request pends instead of raising."""
        need = self.pool.pages_needed(req.prompt_len, req.new_tokens,
                                      req.ids.shape[0])
        free = self.pool.free_pages
        return free >= need or free + self.trie.cold_pages() >= need

    def check_admittable(self, req) -> None:
        """Reject at SUBMIT time what admission could never take: a
        hand-passed prefix handle (the trie replaces them), or a page
        reservation exceeding the whole pool (the paged analogue of
        `validate_capacity`), so the wave batcher's pending queue never
        wedges behind a head `can_admit` can never pass."""
        if getattr(req, "prefix", None) is not None:
            raise ValueError(
                "paged KV replaces hand-passed prefix handles (the "
                "prefix trie shares prompts automatically); submit the "
                "full prompt instead")
        need = self.pool.pages_needed(req.prompt_len, req.new_tokens,
                                      req.ids.shape[0])
        if need > self.pool.n_pages:
            raise ValueError(
                f"request needs {need} KV page(s) "
                f"({req.ids.shape[0]} row(s) x prompt {req.prompt_len} "
                f"+ {req.new_tokens} new tokens at page_size "
                f"{self.page_size}); the pool holds {self.pool.n_pages}")

    # -- admission --------------------------------------------------------

    def admit(self, req, block: bool = False) -> Tuple[str, object]:
        """Seed the request's page tables; returns `(kind, data)` for its
        first stage-0 dispatch: ("prefill", ids) for a fresh prompt, or
        ("span", suffix_ids) when the trie matched a prefix."""
        if getattr(req, "prefix", None) is not None:
            raise ValueError(
                "paged KV replaces hand-passed prefix handles (the "
                "prefix trie shares prompts automatically); submit the "
                "full prompt instead")
        if getattr(req, "shipped", None) is not None:
            return self._install_shipped(req, req.shipped)
        batch, prompt_len = req.ids.shape[0], req.prompt_len
        per_row = self.pool.pages_needed(prompt_len, req.new_tokens)
        tokens = None
        if batch == 1:
            host = getattr(req, "host_ids", None)
            tokens = (np.asarray(host)[0] if host is not None
                      else req.ids[0].cpu().numpy()).tolist()
        shared_pids: List[int] = []
        if tokens is not None:
            shared_pids = self.trie.lookup(tokens,
                                           max_tokens=prompt_len - 1)
        shared = len(shared_pids)
        private: List[List[int]] = []
        try:
            for _ in range(batch):
                private.append(self.pool.alloc(per_row - shared,
                                               block=block))
        except BaseException:
            for row in private:
                self.pool.release(row)
            if shared_pids:
                self.pool.release(shared_pids)
            raise
        table = np.asarray(
            [shared_pids + row for row in private], np.int64)
        req.kvstate = {
            "table": table, "index": self.pool.index(table),
            "shared": shared, "shared_len": shared * self.page_size,
            "owned": shared_pids + [p for row in private for p in row],
            "tokens": tokens, "published": False,
        }
        # leak audit: the owner ledger mirrors this request's page
        # references from the instant they exist
        self.pool.adopt(req.rid, req.kvstate["owned"])
        if shared:
            return "span", req.ids[:, shared * self.page_size:]
        return "prefill", req.ids

    def _install_shipped(self, req, handle) -> Tuple[str, object]:
        """Land a prefill fleet's shipped KV rows in the request's pages
        (the decode side of disaggregation)."""
        del req, handle
        raise _ship_refusal("shipped KV", _DISAGG)

    # -- the stage-step indirection --------------------------------------

    def _touched_pages(self, kind: str, req, span: int) -> range:
        ks = req.kvstate
        if kind == "prefill":
            lo, hi = 0, req.prompt_len
        elif kind == "span":
            lo, hi = ks["shared_len"], req.prompt_len
        elif kind == "chunk":
            # chunked prefill: only this chunk's slice of the prompt was
            # written (earlier chunks already scattered theirs)
            lo, hi = req.chunk_off, req.chunk_off + span
        else:
            lo, hi = req.pos, req.pos + 1
        return range(lo // self.page_size,
                     pages_for(hi, self.page_size))

    def run_stage(self, i: int, req, data, kind: str):
        """One stage-step through page-table indirection: the paged
        analogue of `batcher._run_stage` (same spans, same stage
        functions)."""
        st = self.pipe.stages[i]
        ks = req.kvstate
        batch = req.ids.shape[0]
        span = data.shape[1] if kind in ("prefill", "span", "chunk") else 1
        writes = [(b, j) for b in range(batch)
                  for j in self._touched_pages(kind, req, span)
                  if j >= ks["shared"]]
        with telemetry.span("stage", f"exec{i}", stage=i,
                            rid=str(req.rid)):
            with self._arena_lock:
                cache = self.pool.gather(i, ks["table"], ks["index"])
                if kind == "prefill":
                    out, cache = st["prefill"](st["params"], data, cache)
                elif kind == "span":
                    out, cache = self.pipe._decode_step(
                        st, data, cache, ks["shared_len"], span=span)
                elif kind == "chunk":
                    # one slice of a chunked prompt pass: a span at the
                    # chunk's absolute offset (batcher._run_stage's rule)
                    out, cache = self.pipe._decode_step(
                        st, data, cache, req.chunk_off, span=span)
                else:
                    out, cache = self.pipe._decode_step(st, data, cache,
                                                        req.pos)
                self.pool.scatter(i, ks["table"], cache, writes)
        # trie publish waits for the prompt pass to COMPLETE: a single
        # prefill/span, or the FINAL chunk of a chunked pass
        if i == self._n_stages - 1 \
                and (kind in ("prefill", "span")
                     or (kind == "chunk" and req.chunk_final)) \
                and tokens_publishable(req):
            self._publish(req)
        return out

    def gather_all(self, table) -> List[dict]:
        """Every stage's cache view of page table `table` `[B, n]`,
        gathered under the arena lock (so no executor's scatter lands
        halfway through): a speculative generation's working caches."""
        with self._arena_lock:
            return [self.pool.gather(i, table)
                    for i in range(self._n_stages)]

    def _publish(self, req) -> None:
        """Prompt pass complete on every stage: hand the prompt's FULL
        pages to the trie for cross-request reuse (a partial tail page
        stays private: its owner's decode steps keep writing it)."""
        ks = req.kvstate
        ks["published"] = True
        full = req.prompt_len // self.page_size
        if full <= ks["shared"]:
            return          # nothing new beyond the already-shared pages
        self.trie.insert(ks["tokens"][:full * self.page_size],
                         ks["table"][0][:full].tolist())

    # -- prefix migration (the router's drain) ---------------------------

    def export_prefix(self, tokens, bits: int = 0):
        """The router's drain export of a cached prefix as ship frames."""
        del tokens, bits
        raise _ship_refusal("export_prefix", _MIGRATE)

    def install_prefix(self, tokens, handle) -> int:
        """The receive side of `export_prefix`."""
        del tokens, handle
        raise _ship_refusal("install_prefix", _MIGRATE)

    # -- completion / pressure -------------------------------------------

    def release(self, req) -> None:
        ks = getattr(req, "kvstate", None)
        if not ks:
            return
        req.kvstate = None
        # claim-then-release through the owner ledger: if the orphan
        # sweep already reclaimed this request, there is nothing to drop
        pids = self.pool.disown(req.rid)
        if pids is not None:
            self.pool.release(pids)

    def shared_prompt_tokens(self, tokens) -> int:
        """How many leading prompt tokens the trie could serve from
        shared pages right now (no references taken: a routing probe;
        the binding lookup happens at admission)."""
        if tokens is None:
            return 0
        return self.trie.peek(tokens, max_tokens=len(tokens) - 1)

    def sweep_orphans(self, live_rids) -> int:
        """Reclaim pages whose owning request is no longer live (the
        periodic leak audit). `live_rids` is the executor's live
        request-id set, or a callable returning it; returns pages
        reclaimed."""
        return self.pool.sweep_leaked(live_rids)

    def evict_cold_all(self) -> int:
        """Drop EVERY cold cached prefix page (the brownout
        `evict_cold_pages` rung's sweep)."""
        return self.trie.evict_cold(None)

    def snapshot(self) -> dict:
        return {"pool": self.pool.stats(), "prefix": self.trie.stats()}


def tokens_publishable(req) -> bool:
    """Whether this request's prompt can feed the trie: single-row, host tokens captured, not already published."""
    ks = getattr(req, "kvstate", None)
    return (ks is not None and not ks["published"]
            and ks["tokens"] is not None)
