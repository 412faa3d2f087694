"""Speculative decoding: a draft pipeline proposes, the target verifies.

Port of `pipeedge_tpu/parallel/speculative.py` over the port's
`DecodePipeline`:

- **Greedy-exact**: output is the target's own greedy continuation for fp
  caches: verification accepts exactly the draft tokens the target would
  have produced, and the first mismatch is replaced by the target's own
  argmax. Acceptance changes how many target dispatches a sequence
  costs, never the tokens. On the card the verify is a (gamma+1)-token
  span, a GEMM of M = B(gamma+1) where serial steps run M = B, so its
  logits may differ from the serial steps' by rounding, and an argmax
  on a near-tie may flip (`chip_smoke.py` phase 13 measures both).
- **Per round**: ONE target `extend()` over a fixed (gamma+1)-token span,
  gamma-1 draft single steps and a 1-or-2-token draft catch-up span.
- **Batch-safe**: drafts are per-row; a round accepts the MINIMUM
  accepted prefix across rows. Rows that matched deeper re-derive those
  tokens next round.
- **Cache discipline**: rejected proposals leave K/V rows past the
  committed position; each is overwritten by the next round's span
  write before any query attends it (the span mask keeps k_pos <=
  q_pos), so the committed position IS the rollback state.

`sync` sets the host round trips per round. "host": every draft argmax is
read back (gamma + 1 per round). "device": the draft's argmaxes stay on
the card from step to step and feed its next step, so a round reads back
once for its gamma proposals and once for the verify's argmax row (two
per round). The JAX package compiles that draft round into one XLA
program; the port has no jit, so its "device" rounds run the same eager
stage functions as "host" rounds, with the same `last_sync_count`.
"auto" picks "device" unless `_device_rounds_eligible` refuses the
draft pipeline, as the JAX package does, so the default gives its
`last_sync_count`. Eager device rounds save only readbacks, which cost
little beside a round's dispatch: in paired timings on the H100 they
were neither steadily faster nor steadily slower than host rounds
(`chip_smoke.py` phase 13, PERF.md).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .decode import DecodePipeline, _repeat_batch, validate_capacity

__all__ = ["SpeculativeDecoder"]


def _device_rounds_eligible(pipe) -> Optional[str]:
    """None if `pipe`'s draft rounds may keep their argmaxes on the
    device, else the reason they cannot (the JAX package's refusals:
    per-stage device placement moves data between devices through the
    host, and tp / ep / tp x ep meshes re-place params and caches). The
    port's stages carry no per-stage device, so the meshes refuse; a
    sequence-parallel pipeline decodes on one device and is eligible."""
    if any(st.get("device") is not None for st in pipe.stages):
        return "per-stage device placement"
    if getattr(pipe, "mesh", None) is not None:
        return "tensor-parallel mesh"
    if getattr(pipe, "ep_mesh", None) is not None:
        return "expert-parallel mesh"
    if getattr(pipe, "tp_ep_mesh", None) is not None:
        return "tp x ep mesh"
    return None


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] logits -> [B] tokens, the host rule (f32 argmax)."""
    return logits.float().argmax(dim=-1)


class SpeculativeDecoder:
    """Greedy speculative decoding over two `DecodePipeline`s.

    `gamma` is the draft lookahead per round: the draft proposes gamma
    tokens, one target `extend()` scores all of them plus a bonus
    position. `sync` is "host", "device" or "auto" (module docstring).
    `last_acceptance_rate` (accepted / proposed drafts) and
    `last_sync_count` (host readbacks) describe the latest `generate`.

    Paged mode (`attach_paged`): each generation's caches are
    page-shaped views gathered from pages charged against the serving
    pools, so its cache residency counts against the same capacity as
    the executors' requests, and the orphan sweeps see it."""

    def __init__(self, target: DecodePipeline, draft: DecodePipeline,
                 gamma: int = 4, sync: str = "auto"):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary: "
                f"{draft.cfg.vocab_size} vs {target.cfg.vocab_size}")
        for name, pipe in (("target", target), ("draft", draft)):
            cfg = pipe.cfg
            if cfg.n_experts and cfg.capacity_factor < cfg.n_experts:
                # capacity routing is not per-token: a verify span routes
                # its tokens jointly, which serial steps cannot reproduce
                raise ValueError(
                    f"capacity-bounded MoE {name} breaks the greedy-exact "
                    "guarantee (span routing != per-step routing); use a "
                    "dropless config (capacity_factor >= n_experts)")
        if sync not in ("auto", "host", "device"):
            raise ValueError(f"sync must be auto/host/device, got {sync!r}")
        blockers = {name: why for name, pipe in (("draft", draft),)
                    if (why := _device_rounds_eligible(pipe)) is not None}
        if sync == "device" and blockers:
            raise ValueError(
                f"sync='device' unavailable: {blockers} (the draft round "
                "keeps its argmaxes on one device); use sync='auto' or "
                "'host'")
        self.target = target
        self.draft = draft
        self.gamma = gamma
        self.sync = "host" if sync == "auto" and blockers else \
            ("device" if sync == "auto" else sync)
        self.kv = None
        self.draft_pool = None
        self._live: set = set()   # owners mid-generate (sweep liveness)
        self._seq = itertools.count()
        self.last_acceptance_rate: Optional[float] = None
        self.last_sync_count: Optional[int] = None

    def precompute_prefix(self, prefix_ids) -> dict:
        """Prompt caching: prefill the shared prefix through BOTH
        pipelines (each model needs its own K/V) into one handle for
        `generate(..., prefix=)`."""
        return {"target": self.target.precompute_prefix(prefix_ids),
                "draft": self.draft.precompute_prefix(prefix_ids)}

    # -- paged caches (kv/pool.py) ----------------------------------------

    def attach_paged(self, target_kv, draft_pool) -> None:
        """Arm paged mode: `target_kv` is the decode plane's
        `PagedKvBackend`, `draft_pool` a `KvPagePool` over the draft
        pipeline (the server builds the decoder before its
        `PagedKvBackend` exists)."""
        if target_kv is None or draft_pool is None:
            raise ValueError("attach_paged needs BOTH target_kv and "
                             "draft_pool")
        self.kv = target_kv
        self.draft_pool = draft_pool

    def live_rids(self) -> set:
        """Owners currently mid-generate: the serving governor unions
        them into the pool sweeps' live set."""
        return set(self._live)

    def sweep_orphans(self) -> int:
        """Reclaim DRAFT-pool pages whose generation died between page
        charge and release (the target pool's pages ride the decode
        plane's sweep, which is passed `live_rids`)."""
        if self.draft_pool is None:
            return 0
        return self.draft_pool.sweep_leaked(lambda: self.live_rids())

    def _alloc_paged(self, owner, batch: int, prompt_len: int,
                     new_tokens: int):
        """Charge one paged generation's pages (target pages from the
        decode plane's pool, draft pages from the draft-layout pool) and
        return the gathered working views `[L, B, pages * page_size,
        ...]`. A generation's caches are never shared, so the pages are
        the capacity reservation and the rounds run on the views; a
        scatter back to the arena would be a dead store."""
        g = self.gamma
        t_per = self.kv.pool.pages_needed(prompt_len, new_tokens + g)
        dpool = self.draft_pool
        d_per = dpool.pages_needed(prompt_len, new_tokens + g)
        t_rows: list = []
        d_rows: list = []
        try:
            for _ in range(batch):
                t_rows.append(self.kv.pool.alloc(t_per))
            for _ in range(batch):
                d_rows.append(dpool.alloc(d_per))
        except BaseException:
            for row in t_rows:
                self.kv.pool.release(row)
            for row in d_rows:
                dpool.release(row)
            raise
        # ledger adoption: the owner is in _live already, so a sweep
        # cannot take these pages for orphans while this thread runs
        self.kv.pool.adopt(owner, [p for row in t_rows for p in row])
        dpool.adopt(owner, [p for row in d_rows for p in row])
        t_table = np.asarray(t_rows, np.int64)
        d_table = np.asarray(d_rows, np.int64)
        t_caches = self.kv.gather_all(t_table)
        d_caches = [dpool.gather(i, d_table)
                    for i in range(len(self.draft.stages))]
        return t_caches, d_caches

    def _release_paged(self, owner) -> None:
        """Drop both pools' page references (claim-then-release through
        the owner ledgers) and delist the owner."""
        pids = self.kv.pool.disown(owner)
        if pids is not None:
            self.kv.pool.release(pids)
        pids = self.draft_pool.disown(owner)
        if pids is not None:
            self.draft_pool.release(pids)
        self._live.discard(owner)

    @torch.inference_mode()
    def generate(self, ids, new_tokens: int, prefix: Optional[dict] = None,
                 rid=None) -> torch.Tensor:
        """Greedy-decode `new_tokens` continuations of prompt `ids`
        [B, S]; returns [B, S + new_tokens] (prompt included) on the
        target's device: the tokens of `target.generate(ids, new_tokens)`
        for fp caches.

        `prefix` (from this decoder's `precompute_prefix`) seeds both
        pipelines with a shared prompt prefix; `ids` is then each row's
        SUFFIX (non-empty), and the result omits the prefix, as
        `DecodePipeline.generate(prefix=)` does. In paged mode `rid`
        names the page owner in the pools' ledgers (default: a fresh
        id)."""
        ids = self.target._ids(ids)
        batch, suffix_len = ids.shape
        base = prefix["target"]["len"] if prefix else 0
        prompt_len = suffix_len + base
        if prefix is not None:
            self.target.check_prefix(prefix["target"])
            self.draft.check_prefix(prefix["draft"])
            if prefix["draft"]["len"] != base:
                raise ValueError("target/draft prefix lengths differ: "
                                 f"{base} vs {prefix['draft']['len']}")
            if suffix_len == 0:
                raise ValueError("prefix reuse needs a non-empty suffix")
        if new_tokens <= 0:
            return ids
        if self.kv is not None and prefix is not None:
            raise ValueError(
                "paged speculative decoding replaces dense prefix "
                "handles (the serving layer expands prefixes into "
                "prompt tokens); submit the full prompt instead")
        g = self.gamma
        # the worst case writes a full span past the last emitted token
        validate_capacity(self.target.cfg, self.target.max_len,
                          prompt_len, new_tokens + g)
        validate_capacity(self.draft.cfg, self.draft.max_len,
                          prompt_len, new_tokens + g)

        owner = None
        try:
            if self.kv is not None:
                owner = str(rid) if rid is not None \
                    else f"spec{next(self._seq)}"
                self._live.add(owner)
                t_caches, d_caches = self._alloc_paged(
                    owner, batch, prompt_len, new_tokens)
                # the prompt pass runs as a span at offset 0 over the
                # page-shaped views (the rule chunked prefill relies on)
                t_out, t_caches = self.target.extend(ids, t_caches, 0)
                _, d_caches = self.draft.extend(ids, d_caches, 0)
                known = []
            elif prefix is None:
                t_out, t_caches = self.target._prefill(ids)
                _, d_caches = self.draft._prefill(ids)
                # the draft has seen the whole prompt; catch-up tokens are
                # all emitted ones
                known = []
            else:
                t_caches = [_repeat_batch(c, batch)
                            for c in prefix["target"]["caches"]]
                t_out, t_caches = self.target.extend(ids, t_caches, base)
                d_caches = [_repeat_batch(c, batch)
                            for c in prefix["draft"]["caches"]]
                # the draft has seen only the prefix: its first catch-up
                # span covers the whole suffix too
                known = list(ids.T)
            return self._rounds(ids, new_tokens, t_out, t_caches,
                                d_caches, known, base, prompt_len,
                                bool(prefix))
        finally:
            if owner is not None:
                self._release_paged(owner)

    def _rounds(self, ids, new_tokens: int, t_out, t_caches, d_caches,
                known: list, base: int, prompt_len: int,
                prefixed: bool) -> torch.Tensor:
        """The draft-propose / target-verify loop (seeding done), shared
        by the dense, prefix-seeded and paged cache paths. `known` holds
        [B] device token columns: the suffix, then each emission, at
        positions [d_floor, ...)."""
        g = self.gamma
        device_rounds = self.sync == "device"
        pending = _greedy(t_out[:, -1])          # [B] first continuation
        pending_host = pending.cpu().numpy()     # the first-token readback
        syncs = 1
        n_suffix = len(known)
        known.append(pending)
        d_floor = base if prefixed else prompt_len
        n_emitted = 1
        t_pos = prompt_len   # target cache rows [0, t_pos) are committed
        d_pos = d_floor      # draft cache rows [0, d_pos) are committed
        proposed = accepted = 0

        while n_emitted < new_tokens:
            # --- draft: catch up on committed tokens it has not seen
            # (suffix + pending on a prefix-seeded first round; then 1
            # token, 2 after a fully accepted round), then propose gamma
            # tokens autoregressively
            catch = torch.stack(known[d_pos - d_floor:], dim=1)
            d_logits, d_caches = self.draft.extend(catch, d_caches, d_pos)
            d_pos += catch.shape[1]
            props = [_greedy(d_logits[:, -1])]
            if not device_rounds:
                props[0] = props[0].cpu()
                syncs += 1
            for _ in range(g - 1):
                d_logits, d_caches = self.draft.extend(
                    props[-1][:, None], d_caches, d_pos)
                props.append(_greedy(d_logits[:, -1]))
                if not device_rounds:
                    props[-1] = props[-1].cpu()
                    syncs += 1
                d_pos += 1
            if device_rounds:
                # the round's one proposal readback
                props_host = torch.stack(props, dim=1).cpu().numpy()
                syncs += 1
            else:
                props_host = torch.stack(props, dim=1).numpy()

            # --- target: one span forward scores pending + proposals
            span = torch.cat([torch.as_tensor(pending_host)[:, None],
                              torch.as_tensor(props_host)], dim=1)
            t_logits, t_caches = self.target.extend(span, t_caches, t_pos)
            targets = _greedy(t_logits).cpu().numpy()    # [B, g+1]
            syncs += 1

            # --- accept the minimum matching prefix across rows
            a = 0
            while a < g and bool(np.all(props_host[:, a] == targets[:, a])):
                a += 1
            proposed += g
            accepted += a
            dev = ids.device
            known.extend(torch.as_tensor(props_host[:, k], device=dev)
                         for k in range(a))
            pending_host = targets[:, a]
            known.append(torch.as_tensor(pending_host, device=dev))
            n_emitted += a + 1
            t_pos += a + 1
            # draft rows hold [pending, p1..p_{g-1}] from this round's
            # catch-up and proposals; committed among them: pending..p_a
            d_pos = t_pos - 1 if a == g else t_pos

        self.last_acceptance_rate = accepted / proposed if proposed else None
        self.last_sync_count = syncs
        gen = torch.stack(known[n_suffix:n_suffix + new_tokens], dim=1)
        return torch.cat([ids, gen.to(ids.device)], dim=1)
