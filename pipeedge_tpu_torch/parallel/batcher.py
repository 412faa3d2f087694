"""Continuous batching for pipelined decoding: concurrent requests fill the
pipeline bubbles a single autoregressive stream leaves empty.

Port of `pipeedge_tpu/parallel/batcher.py` over the port's
`DecodePipeline` (dense per-request caches). Interleaving S concurrent
requests as a wave — stage i decoding request r while stage i+1 decodes
request r-1 — keeps every stage busy once S >= K stages, without touching
the stage functions:

- **Per-request caches**: each request keeps its OWN per-stage cache slots
  (created at admission, freed at completion) and runs exactly
  `DecodePipeline`'s stage functions, so its tokens equal a solo
  `generate()` run with the same settings. There is no cross-request
  padding or masking.
- **Wave scheduling, host-driven** (`ContinuousBatcher`): one "tick"
  dispatches at most one stage-step per stage, stages back-to-front, so a
  request advances exactly one stage per tick.
- **Stage workers** (`StageWorkerExecutor`): one thread per stage, so the
  host-side dispatch of different stages overlaps.
- **Iteration-level scheduling** (opt-in): `step_join=True` and
  `chunk_tokens=N` / `prefill_budget` (long prompt passes split into
  N-token chunks interleaved with other requests' decode steps), on the
  dense caches.

What the port does its own way, and why:

- **One stream.** Every thread that runs stage work (the wave ticker, the
  stage workers, and the caller threads that build a request's ids and
  caches) enqueues on the device's default stream
  (`_on_device_stream`). Stage i's output handed to stage i+1's thread,
  and the last stage's token handed back to stage 0, were enqueued
  before the hand-off on that same stream, so the stream order carries
  every hand-off, and a tensor freed in one thread is reused by the
  caching allocator only behind its last use. No event per hand-off is
  needed (`HostPipeline`'s per-stage streams need one).
- **Host readbacks** (`_decide_eos`, `_finalize_tokens`) copy to the host
  in the executor's thread, so a waiter only ever receives numpy arrays.
  `on_token(step, tokens)` receives the [B] device tensor; the callback
  decides how to fence its readback (`serve.py` copies it to pinned
  memory behind an event).
- **Sampling**: each request owns a device `torch.Generator` seeded with
  its `seed`, drawn in the order `DecodePipeline.generate` draws, so a
  sampled request equals the port's solo `generate` with the same seed
  (not the JAX package's: ROADMAP §C).
- **`torch.inference_mode`** is thread-local: every thread that runs
  stage work enters it.
- The paged KV plane (`kv=`) and shipped prefill (`shipped=`) wait for
  ROADMAP A5.3a and raise. The JAX executors' `sp_degree` refusal has no
  counterpart: the port's `DecodePipeline` has no sequence-parallel
  prefill until ROADMAP A7.
"""
from __future__ import annotations

import contextlib
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import telemetry
from ..telemetry import metrics as prom
from ..utils.threads import make_condition
from .decode import (DecodePipeline, _repeat_batch, make_token_picker,
                     validate_capacity)

# iteration-level scheduling counters: one family per event, labelled by
# executor so /metrics tells the wave batcher's steps from the stage
# workers' without a second registry
M_STEPS = prom.REGISTRY.counter(
    "pipeedge_decode_steps_total",
    "decode-step boundaries crossed (one per picked token wave), "
    "by executor")
M_CHUNKS = prom.REGISTRY.counter(
    "pipeedge_prefill_chunks_total",
    "prompt chunks dispatched by the chunked-prefill scheduler, "
    "by executor")
for _ex in ("wave", "workers"):
    M_STEPS.declare(executor=_ex)
    M_CHUNKS.declare(executor=_ex)
del _ex

# the stage-step kinds an executor dispatches ("span": a prefix-seeded
# suffix prompt pass; "chunk": one slice of a chunked prompt pass)
KINDS = ("prefill", "span", "chunk", "step")


def _paged_refusal(what: str) -> ValueError:
    return ValueError(f"{what}: the paged KV plane is not ported to "
                      "pipeedge_tpu_torch yet (ROADMAP A5.3a); the port's "
                      "executors run dense per-request caches")


def _on_device_stream(pipe: DecodePipeline):
    """The context every executor thread runs stage work in: the device's
    default stream on a GPU (module docstring, "One stream"), nothing on
    the CPU."""
    if pipe.device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.default_stream(pipe.device))


@contextlib.contextmanager
def _stage_context(pipe: DecodePipeline):
    with _on_device_stream(pipe), torch.inference_mode():
        yield


def _sched_mark(name: str, rid) -> None:
    """Instant `sched` span (join/retire/chunk): scheduler decisions are
    point events whose endpoints may straddle threads, so both executors
    record them pre-timed instead of opening a with-span."""
    if telemetry.enabled():
        now = time.monotonic_ns()
        telemetry.record("sched", name, now, now, rid=str(rid))


@dataclass
class _Request:
    rid: object
    ids: torch.Tensor                # [B, S] prompt on the device (the
    new_tokens: int                  # SUFFIX when a prefix handle seeds
    pick: object                     # the caches)
    gen: Optional[torch.Generator]   # None for greedy requests
    prompt_len: int                  # prefix + suffix
    prefix: Optional[Dict] = None    # precompute_prefix handle
    eos_token: Optional[int] = None  # stop early once every row emitted it
    pad_token: Optional[int] = None  # fills rows past their own eos
    # streaming hook: fires (step, [B] device tokens) as each pick lands
    on_token: Optional[object] = None
    # cooperative cancellation: an is_set()-style flag (threading.Event)
    # checked after each pick — a cancelled request completes with the
    # tokens decoded so far, freeing its cache slots/admission slot early
    cancel: Optional[object] = None
    # absolute monotonic deadline: checked at every decode-step boundary;
    # expiry FIRES the cancel flag and completes the request early
    deadline: Optional[float] = None
    expired: bool = False            # the deadline check tripped
    rows_done: Optional[np.ndarray] = None   # [B] eos seen per row
    caches: Optional[List] = None    # per-stage cache slots (admission)
    # chunked prefill: `chunk_rest` holds the prompt tokens not yet
    # dispatched, `chunk_off` the in-flight chunk's absolute cache offset,
    # `chunk_next` the next chunk's offset, and `chunk_final` whether the
    # in-flight chunk completes the prompt (only then does the last stage
    # pick a token)
    chunk_rest: Optional[torch.Tensor] = None
    chunk_off: int = 0
    chunk_next: int = 0
    chunk_final: bool = False
    chunks_done: int = 0
    tokens: List = field(default_factory=list)

    @property
    def pos(self) -> int:
        """Cache position for the NEXT decode wave: the wave that produces
        token len(tokens)+1 attends through position prompt_len +
        len(tokens) - 1 (mirrors DecodePipeline.generate's pos)."""
        return self.prompt_len + len(self.tokens) - 1


def _build_request(pipe: DecodePipeline, rid, ids, new_tokens: int,
                   temperature: float, top_k: int, seed: int,
                   eos_token: Optional[int], pad_token: Optional[int],
                   prefix: Optional[Dict],
                   on_token=None, cancel=None,
                   deadline: Optional[float] = None,
                   shipped: Optional[Dict] = None) -> _Request:
    """Validate one request's arguments against `pipe` and build its
    `_Request` — the shared admission contract of the wave batcher and
    the stage-worker executor (the JAX package's errors, and one
    generator discipline, so token streams match across executors)."""
    if shipped is not None:
        raise _paged_refusal("shipped KV")
    if not isinstance(ids, torch.Tensor):
        ids = np.asarray(ids)
    with _on_device_stream(pipe):
        ids = torch.as_tensor(ids, dtype=torch.long, device=pipe.device)
    if ids.dim() != 2 or ids.shape[1] == 0:
        raise ValueError("prompt must be [B, S] with S >= 1, got "
                         f"shape {tuple(ids.shape)}")
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    if pad_token is not None and eos_token is None:
        raise ValueError("pad_token only applies with eos_token (rows "
                         "are padded after their own eos)")
    if prefix is not None:
        # reject handles built by an incompatible pipeline up front
        pipe.check_prefix(prefix)
    prompt_len = ids.shape[1] + (prefix["len"] if prefix else 0)
    validate_capacity(pipe.cfg, pipe.max_len, prompt_len, new_tokens)
    gen = None
    if temperature > 0.0:
        # seeded as DecodePipeline.generate seeds its generator
        gen = torch.Generator(device=pipe.device)
        gen.manual_seed(seed)
    return _Request(
        rid=rid, ids=ids, new_tokens=new_tokens,
        pick=make_token_picker(temperature, top_k), gen=gen,
        prompt_len=prompt_len, prefix=prefix, eos_token=eos_token,
        pad_token=eos_token if pad_token is None else pad_token,
        on_token=on_token, cancel=cancel,
        deadline=None if deadline is None else float(deadline))


def _seed_caches(pipe: DecodePipeline, req: _Request) -> str:
    """Create the request's per-stage cache slots and return its prompt
    pass kind: a prefix-seeded request's suffix runs as one SPAN at the
    prefix offset (prompt caching; the handle's caches are copied, never
    written); otherwise a fresh prefill."""
    with _stage_context(pipe):
        if req.prefix is not None:
            req.caches = [_repeat_batch(c, req.ids.shape[0])
                          for c in req.prefix["caches"]]
            return "span"
        req.caches = pipe._fresh_caches(req.ids.shape[0])
    return "prefill"


def _next_chunk(req: _Request, chunk_tokens: int) -> torch.Tensor:
    """Pop the next prompt chunk off `req.chunk_rest`: advances
    `chunk_off`/`chunk_next`, sets `chunk_final` on the last slice.
    `chunk_tokens` is read per pop, so a brownout chunk clamp
    (`set_chunk_tokens`) takes effect at the next chunk boundary."""
    rest = req.chunk_rest
    take = rest.shape[1] if chunk_tokens < 1 \
        else min(int(chunk_tokens), rest.shape[1])
    req.chunk_off = req.chunk_next
    req.chunk_next += take
    data, rest = rest[:, :take], rest[:, take:]
    req.chunk_rest = rest if rest.shape[1] else None
    req.chunk_final = req.chunk_rest is None
    req.chunks_done += 1
    _sched_mark("chunk", req.rid)
    return data


def _maybe_chunk(req: _Request, kind: str, data, chunk_tokens: int):
    """Convert a long prompt pass into its first CHUNK. A prompt pass
    ("prefill" for a fresh prompt, "span" for a prefix-seeded suffix)
    longer than `chunk_tokens` becomes a sequence of "chunk" waves: each
    runs `chunk_tokens` prompt positions as a span at its absolute offset
    (DecodePipeline.extend's rule — token-identical to the single pass
    for fp caches), and the scheduler interleaves other requests' decode
    steps between chunks. The base offset is prompt_len - data_len (0
    fresh, prefix_len with a prefix)."""
    if chunk_tokens < 1 or kind not in ("prefill", "span") \
            or data.shape[1] <= chunk_tokens:
        return kind, data
    req.chunk_next = req.prompt_len - data.shape[1]
    req.chunk_rest = data
    return "chunk", _next_chunk(req, chunk_tokens)


def _run_stage(pipe: DecodePipeline, i: int, req: _Request, data,
               kind: str):
    """One stage-step dispatch for request `req` at stage `i` — THE
    per-stage semantics (prefill vs span vs chunk vs step), shared by
    ContinuousBatcher.tick and StageWorkerExecutor's workers so the two
    executors can never drift apart. Each step records a request-tagged
    `stage`/`exec{i}` span (host time), free when span recording is
    off."""
    st = pipe.stages[i]
    with telemetry.span("stage", f"exec{i}", stage=i, rid=str(req.rid)):
        if kind == "prefill":
            out, req.caches[i] = st["prefill"](st["params"], data,
                                               req.caches[i])
        elif kind == "span":
            # prefix-seeded prompt pass: the suffix runs as one span at
            # the prefix offset (DecodePipeline.extend's rule)
            out, req.caches[i] = pipe._decode_step(
                st, data, req.caches[i], req.prefix["len"],
                span=data.shape[1])
        elif kind == "chunk":
            # chunked prefill: this slice of the prompt runs as a span at
            # its absolute offset; earlier chunks' rows are in the caches
            out, req.caches[i] = pipe._decode_step(
                st, data, req.caches[i], req.chunk_off,
                span=data.shape[1])
        else:
            out, req.caches[i] = pipe._decode_step(st, data, req.caches[i],
                                                   req.pos)
    return out


def _pick(req: _Request, out) -> torch.Tensor:
    """The next token [B] from the last stage's output: the last
    position's logits for every wave kind (prefill [B,S], span [B,S_s],
    step [B,1]), picked with the request's own generator."""
    return req.pick(out[:, -1].float(), req.gen)


def _expired(req: _Request, now: Optional[float] = None) -> bool:
    """THE deadline check, shared by both executors at their decode-step
    boundaries (and at admission): past-deadline requests fire the
    existing `cancel` flag and record `expired` so the serving layer can
    tell a 504 from an ordinary early completion."""
    if req.deadline is None:
        return False
    if (now if now is not None else time.monotonic()) < req.deadline:
        return False
    req.expired = True
    cancel_set = getattr(req.cancel, "set", None)
    if cancel_set is not None:
        cancel_set()
    return True


def _finalize_tokens(req: _Request) -> np.ndarray:
    """[B, S + T] host result: prompt + picked tokens, with everything
    strictly after each row's first eos masked to its pad token. The one
    readback of the request's tokens, in the executor's thread."""
    ids = req.ids.cpu().numpy()
    if not req.tokens:
        # a request expired/cancelled before its first pick completes
        # with the bare prompt (the serving layer answers it 504)
        return ids
    toks = torch.stack(req.tokens, dim=1).cpu().numpy()       # [B, T]
    if req.eos_token is not None:
        seen = np.cumsum(toks == req.eos_token, axis=1) > 0
        after = np.concatenate(
            [np.zeros_like(seen[:, :1]), seen[:, :-1]], axis=1)
        toks = np.where(after, req.pad_token, toks)
    return np.concatenate([ids, toks], axis=1)


def _eos_done(req: _Request, token: torch.Tensor) -> bool:
    """Fold this pick into the request's per-row eos record (a readback
    of the [B] token); True once every row has emitted the eos."""
    hit = token.cpu().numpy() == req.eos_token
    req.rows_done = hit if req.rows_done is None else req.rows_done | hit
    return bool(req.rows_done.all())


class ContinuousBatcher:
    """Wave-scheduled multi-request decoding over a `DecodePipeline`.

    >>> batcher = ContinuousBatcher(pipe)
    >>> batcher.submit("a", ids_a, new_tokens=8)
    >>> batcher.submit("b", ids_b, new_tokens=5, temperature=0.7, seed=1)
    >>> results = batcher.run()      # {"a": [B, S_a+8], "b": [B, S_b+5]}

    Results are token-identical to `pipe.generate(ids, new_tokens, ...)`
    run solo with the same sampling settings: the same stage functions run
    on the same per-request data; only the interleaving differs. `stats`
    afterwards reports ticks/stage_steps/tokens/prefill_chunks (the JAX
    batcher's keys); `kind_steps[i]` counts stage i's steps by kind.
    """

    def __init__(self, pipe: DecodePipeline, max_active: Optional[int] = None,
                 kv=None, chunk_tokens: int = 0,
                 prefill_budget: Optional[int] = None,
                 step_join: bool = False, on_step=None):
        if kv is not None:
            raise _paged_refusal("ContinuousBatcher(kv=...)")
        self.pipe = pipe
        self.n_stages = len(pipe.stages)
        self.max_active = (self.n_stages + 1 if max_active is None
                           else max_active)
        if self.max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {self.max_active}")
        # chunked prefill: prompt passes longer than `chunk_tokens` are
        # split into chunk waves; `prefill_budget` bounds the prompt tokens
        # ENTERING stage 0 per tick (default: one chunk's worth), so decode
        # steps keep landing while a long prompt streams in. 0 disables.
        if chunk_tokens < 0:
            raise ValueError(f"chunk_tokens must be >= 0, got {chunk_tokens}")
        self.chunk_tokens = int(chunk_tokens)
        self.prefill_budget = (self.chunk_tokens if prefill_budget is None
                               else int(prefill_budget))
        if self.chunk_tokens and self.prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1 when chunking")
        self._budget = 0
        # step_join: refill a slot freed at the LAST stage into stage 0
        # within the SAME tick (the reversed drain visits stage 0 after
        # the completion), so admission happens at step boundaries
        self.step_join = bool(step_join)
        # on_step(): fired after each decode-step boundary (a pick landed)
        self.on_step = on_step
        self.pending: deque = deque()
        self.active = 0
        self._live_rids = set()      # pending + admitted (not yet completed)
        # stage i's input queue: (request, data, kind) tuples; `data` is
        # token ids at stage 0, the previous stage's hidden state after
        self._stage_q: List[deque] = [deque() for _ in range(self.n_stages)]
        self.results: Dict = {}
        self.stats = {"ticks": 0, "stage_steps": 0, "tokens": 0,
                      "prefill_chunks": 0}
        self.kind_steps = [dict.fromkeys(KINDS, 0)
                           for _ in range(self.n_stages)]

    def set_chunk_tokens(self, n: int) -> None:
        """Retarget the chunk size (GIL-atomic int write) — the brownout
        ladder's chunk-clamp rung calls this from the governor thread;
        in-flight requests see it at their next chunk boundary."""
        self.chunk_tokens = max(0, int(n))

    def submit(self, rid, ids, new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, seed: int = 0,
               eos_token: Optional[int] = None,
               pad_token: Optional[int] = None,
               prefix: Optional[Dict] = None,
               on_token=None, cancel=None,
               deadline: Optional[float] = None,
               shipped: Optional[Dict] = None) -> None:
        """Queue a request. `ids` [B, S] is a prompt batch decoded in
        lockstep (B=1 for a single sequence).

        `prefix` (from the pipeline's `precompute_prefix`) seeds this
        request's cache slots with a copy of a shared prompt prefix; `ids`
        is then the request's SUFFIX and the returned array omits the
        prefix, as `generate(prefix=)` does.

        `eos_token`: finish once EVERY row of the batch has emitted the
        token (`new_tokens` stays the cap); rows that finished first keep
        decoding in lockstep, their post-eos tokens masked with
        `pad_token` (default: the eos token) in the returned array.

        `on_token(step, tokens)` fires as each step's pick lands (tokens
        is the [B] device tensor). `cancel` (an is_set()-style flag)
        completes the request at its next pick with the tokens decoded so
        far. `deadline` (absolute `time.monotonic()` seconds) is checked
        at every decode-step boundary; expiry fires `cancel`. `shipped`
        waits for ROADMAP A5.3a and raises."""
        if rid in self.results or rid in self._live_rids:
            raise ValueError(f"duplicate request id {rid!r}")
        req = _build_request(self.pipe, rid, ids, new_tokens, temperature,
                             top_k, seed, eos_token, pad_token, prefix,
                             on_token=on_token, cancel=cancel,
                             deadline=deadline, shipped=shipped)
        self._live_rids.add(rid)
        self.pending.append(req)

    def _admit(self) -> None:
        while self.pending and self.active < self.max_active:
            req = self.pending[0]
            if _expired(req):
                # dead before its first wave: never seed caches or touch
                # the pipeline — the whole point of deadline propagation
                self.pending.popleft()
                self.results[req.rid] = _finalize_tokens(req)
                self._live_rids.discard(req.rid)
                continue
            self.pending.popleft()
            kind, data = _seed_caches(self.pipe, req), req.ids
            kind, data = _maybe_chunk(req, kind, data, self.chunk_tokens)
            if kind == "chunk":
                self.stats["prefill_chunks"] += 1
                M_CHUNKS.inc(executor="wave")
            self.active += 1
            _sched_mark("join", req.rid)
            self._stage_q[0].append((req, data, kind))

    def _finish_wave(self, req: _Request, out, kind: str,
                     reentries: list, eos_pending: list) -> None:
        """Last stage done: pick the next token, then complete or re-enter
        stage 0. Requests with an eos_token defer their stop decision to
        AFTER the tick's dispatch loop (`eos_pending`): the decision reads
        the token back, and doing it here would serialize every other
        stage's dispatch behind this request's compute. An INTERMEDIATE
        prompt chunk picks nothing: its boundary retires an expired or
        cancelled request or queues the next chunk."""
        if kind == "chunk" and not req.chunk_final:
            if _expired(req) or (req.cancel is not None
                                 and req.cancel.is_set()):
                self._complete(req)   # mid-prompt shed: free the slots
                return
            data = _next_chunk(req, self.chunk_tokens)
            self.stats["prefill_chunks"] += 1
            M_CHUNKS.inc(executor="wave")
            reentries.append((req, data, "chunk"))
            return
        token = _pick(req, out)
        req.tokens.append(token)
        self.stats["tokens"] += int(token.shape[0])
        M_STEPS.inc(executor="wave")
        if self.on_step is not None:
            self.on_step()
        if req.on_token is not None:
            req.on_token(len(req.tokens) - 1, token)
        done = len(req.tokens) >= req.new_tokens
        if not done and (_expired(req) or (req.cancel is not None
                                           and req.cancel.is_set())):
            self._complete(req)     # expired/caller gone: free the slots
            return
        if req.eos_token is not None:
            eos_pending.append(req)
            return
        if done:
            self._complete(req)
        else:
            reentries.append((req, token[:, None], "step"))

    def _complete(self, req: _Request) -> None:
        self.results[req.rid] = _finalize_tokens(req)
        req.caches = None            # free this request's cache slots
        req.chunk_rest = None
        self.active -= 1
        self._live_rids.discard(req.rid)
        _sched_mark("retire", req.rid)
        if self.step_join:
            # the slot freed at THIS step boundary joins a pending request
            # into stage 0 within the same tick
            self._admit()

    def _decide_eos(self, req: _Request) -> None:
        """Post-dispatch stop decision for an eos request: read back the
        just-picked token (all of this tick's work is already dispatched,
        so the wait overlaps other requests' device work)."""
        token = req.tokens[-1]
        done = len(req.tokens) >= req.new_tokens or _eos_done(req, token)
        if done:
            self._complete(req)
        else:
            self._stage_q[0].append((req, token[:, None], "step"))

    def _pop_stage0(self):
        """Token-budget-per-step policy at stage 0: the budget accrues
        `prefill_budget` tokens per tick (capped) and prompt-kind
        dispatches spend it. A prompt head that outruns the accrued budget
        is deferred behind the first queued decode step; when no decode
        step is waiting, prompt work passes regardless, so starvation is
        impossible."""
        q = self._stage_q[0]
        if self.chunk_tokens and q[0][2] != "step" \
                and q[0][1].shape[1] > self._budget:
            for k in range(1, len(q)):
                if q[k][2] == "step":
                    q.rotate(-k)
                    item = q.popleft()
                    q.rotate(k)   # restore order minus item k
                    return item
        item = q.popleft()
        if item[2] != "step":
            self._budget -= item[1].shape[1]
        return item

    def tick(self) -> bool:
        """Advance every stage by at most one stage-step; returns whether
        any work remains. Strict wave semantics: stages are drained
        back-to-front and a token finishing at the last stage re-enters
        stage 0 only AFTER the tick, so all of a tick's dispatches belong
        to DISTINCT requests. With `step_join`, completions refill stage 0
        mid-tick; with `chunk_tokens`, stage 0's pop obeys the per-tick
        prefill token budget."""
        with _stage_context(self.pipe):
            return self._tick()

    def _tick(self) -> bool:
        cap = max(self.prefill_budget, self.chunk_tokens)
        self._budget = min(self._budget + self.prefill_budget, cap)
        self._admit()
        worked = False
        reentries: list = []
        eos_pending: list = []
        for i in reversed(range(self.n_stages)):
            if not self._stage_q[i]:
                continue
            req, data, kind = (self._pop_stage0() if i == 0
                               else self._stage_q[i].popleft())
            out = _run_stage(self.pipe, i, req, data, kind)
            self.stats["stage_steps"] += 1
            self.kind_steps[i][kind] += 1
            worked = True
            if i + 1 < self.n_stages:
                self._stage_q[i + 1].append((req, out, kind))
            else:
                self._finish_wave(req, out, kind, reentries, eos_pending)
        self._stage_q[0].extend(reentries)
        for req in eos_pending:
            self._decide_eos(req)
        self.stats["ticks"] += worked
        self._admit()                # a completion may free a slot mid-tick
        return worked or self.active > 0 or bool(self.pending)

    def run(self) -> Dict:
        """Drive ticks until every submitted request completes; returns
        {rid: [B, prompt+new_tokens] ids} (prompt included)."""
        while self.tick():
            pass
        return self.results


class StageWorkerExecutor:
    """Stage-pinned multi-worker executor: one thread per pipeline stage.

    Worker `i` blocks on stage `i`'s input queue, dispatches exactly its
    own stage's functions, and hands the wave to stage `i+1`'s queue, so
    the host-side dispatch of different stages overlaps, and the last
    stage's token picks (plus eos readbacks) never stall the other
    stages. The per-request computation is exactly the wave batcher's.

    >>> ex = StageWorkerExecutor(pipe)
    >>> ex.submit("a", ids, new_tokens=8)       # returns immediately
    >>> out = ex.wait("a")                      # [B, S+8]
    >>> ex.stop()

    `max_active` bounds concurrently admitted requests (cache memory) with
    a semaphore: `submit` blocks while the pipeline is full. A worker that
    raises marks the executor dead; every current and future waiter
    raises instead of hanging."""

    _DONE = object()

    def __init__(self, pipe: DecodePipeline,
                 max_active: Optional[int] = None, kv=None,
                 chunk_tokens: int = 0, step_join: bool = False,
                 on_step=None):
        if kv is not None:
            raise _paged_refusal("StageWorkerExecutor(kv=...)")
        self.pipe = pipe
        self.n_stages = len(pipe.stages)
        self.max_active = (self.n_stages + 1 if max_active is None
                           else max_active)
        if self.max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {self.max_active}")
        # chunked prefill: the stage queues are FIFO, so bounding every
        # item's token cost at `chunk_tokens` IS the latency policy here
        if chunk_tokens < 0:
            raise ValueError(f"chunk_tokens must be >= 0, got {chunk_tokens}")
        self.chunk_tokens = int(chunk_tokens)
        # stage workers join/retire at step boundaries BY CONSTRUCTION;
        # `step_join` is accepted for signature parity with the wave batcher
        self.step_join = bool(step_join)
        self.on_step = on_step
        self._q = [queue_mod.Queue() for _ in range(self.n_stages)]
        # plain (not Bounded) semaphore: _die() over-releases on purpose
        # so submitters blocked on admission wake up and see the failure
        self._slots = threading.Semaphore(self.max_active)
        self._lock = make_condition("batcher.results")
        self.results: Dict = {}
        self._live = set()
        self._dead: Optional[BaseException] = None
        self.active = 0
        self.stats = {"stage_steps": [0] * self.n_stages,
                      "busy": [False] * self.n_stages, "tokens": 0,
                      "prefill_chunks": 0}
        # each worker writes only its own stage's dict
        self.kind_steps = [dict.fromkeys(KINDS, 0)
                           for _ in range(self.n_stages)]
        self._workers = [
            threading.Thread(target=self._stage_loop, args=(i,),
                             daemon=True, name=f"stage-worker-{i}")
            for i in range(self.n_stages)]
        for w in self._workers:
            w.start()

    # -- client side ------------------------------------------------------

    def submit(self, rid, ids, new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, seed: int = 0,
               eos_token: Optional[int] = None,
               pad_token: Optional[int] = None,
               prefix: Optional[Dict] = None,
               on_token=None, cancel=None,
               deadline: Optional[float] = None,
               shipped: Optional[Dict] = None) -> None:
        """Admit one request (same argument contract as
        `ContinuousBatcher.submit`). BLOCKS while `max_active` requests
        are in flight — admission backpressure is the caller's thread."""
        req = _build_request(self.pipe, rid, ids, new_tokens, temperature,
                             top_k, seed, eos_token, pad_token, prefix,
                             on_token=on_token, cancel=cancel,
                             deadline=deadline, shipped=shipped)
        with self._lock:
            self._check_dead()
            if rid in self.results or rid in self._live:
                raise ValueError(f"duplicate request id {rid!r}")
            self._live.add(rid)
        self._slots.acquire()
        try:
            with self._lock:
                if self._dead is not None:   # woken by _die's over-release
                    self._check_dead()
                self.active += 1
            if _expired(req):
                # the admission wait outlived the deadline: complete with
                # the bare prompt without ever touching the pipeline
                arr = _finalize_tokens(req)
                with self._lock:
                    self.results[rid] = arr
                    self._live.discard(rid)
                    self.active -= 1
                    self._lock.notify_all()
                self._slots.release()
                return
            try:
                kind, data = _seed_caches(self.pipe, req), req.ids
                kind, data = _maybe_chunk(req, kind, data,
                                          self.chunk_tokens)
                if kind == "chunk":
                    with self._lock:
                        self.stats["prefill_chunks"] += 1
                    M_CHUNKS.inc(executor="workers")
                _sched_mark("join", rid)
                self._q[0].put((req, data, kind))
            except BaseException:
                # roll the admission back (e.g. cache allocation OOM):
                # leaking the slot would eventually wedge every submit
                with self._lock:
                    self.active -= 1
                raise
        except BaseException:
            with self._lock:
                self._live.discard(rid)
            self._slots.release()
            raise

    def wait(self, rid, timeout: Optional[float] = None) -> np.ndarray:
        """Block until request `rid` completes; returns its [B, S + T]
        ids (the array `ContinuousBatcher.run` would record)."""
        with self._lock:
            while rid not in self.results:
                self._check_dead()
                if not self._lock.wait(timeout):
                    raise TimeoutError(f"request {rid!r} not done after "
                                       f"{timeout}s")
            return self.results.pop(rid)

    def snapshot(self) -> Dict:
        """Point-in-time per-worker stats for health reporting: stage
        steps and busy flag per worker, queue depths, tokens, active."""
        with self._lock:
            return {"stage_steps": list(self.stats["stage_steps"]),
                    "busy": list(self.stats["busy"]),
                    "queued": [q.qsize() for q in self._q],
                    "tokens": self.stats["tokens"],
                    "prefill_chunks": self.stats["prefill_chunks"],
                    "active": self.active}

    def set_chunk_tokens(self, n: int) -> None:
        """Retarget the chunk size (GIL-atomic int write); in-flight
        requests see it at their next chunk boundary."""
        self.chunk_tokens = max(0, int(n))

    def stop(self) -> None:
        """Shut the workers down. Queued work ahead of the sentinels is
        processed, but a multi-step request cannot finish once worker 0
        exits — after the join, every still-live request's waiter is
        FAILED rather than left hanging. Drain with `wait` before stopping
        if results matter."""
        for q in self._q:
            q.put(self._DONE)
        for w in self._workers:
            w.join()
        with self._lock:
            if self._live and self._dead is None:
                self._dead = RuntimeError(
                    f"executor stopped with {len(self._live)} request(s) "
                    "in flight")
            self._lock.notify_all()
            dead = self._dead is not None
        if dead:
            # in-flight requests will never release their admission slots
            # now: over-release so blocked submitters wake and raise
            for _ in range(self.max_active):
                self._slots.release()

    def _check_dead(self) -> None:
        if self._dead is not None:
            raise RuntimeError(f"stage worker died: {self._dead!r}")

    # -- worker side ------------------------------------------------------

    def _stage_loop(self, i: int) -> None:
        with _stage_context(self.pipe):
            while True:
                item = self._q[i].get()
                if item is self._DONE:
                    return
                req, data, kind = item
                self.stats["busy"][i] = True
                try:
                    out = _run_stage(self.pipe, i, req, data, kind)
                    self.stats["stage_steps"][i] += 1
                    self.kind_steps[i][kind] += 1
                    if i + 1 < self.n_stages:
                        self._q[i + 1].put((req, out, kind))
                    else:
                        self._finish(req, out, kind)
                except BaseException as exc:   # noqa: BLE001 — a dead
                    self._die(exc)   # worker must fail waiters, not hang
                    raise
                finally:
                    self.stats["busy"][i] = False

    def _retire(self, req: _Request) -> None:
        """Complete `req` (runs in the last stage's worker): read its
        result back, free its cache slots and its admission slot."""
        arr = _finalize_tokens(req)
        req.caches = None            # free this request's cache slots
        req.chunk_rest = None
        _sched_mark("retire", req.rid)
        with self._lock:
            self.results[req.rid] = arr
            self._live.discard(req.rid)
            self.active -= 1
            self._lock.notify_all()
        self._slots.release()

    def _finish(self, req: _Request, out, kind: str) -> None:
        """Last stage done: pick the next token, stream it, then complete
        or re-enter stage 0. The eos readback blocks only THIS worker. An
        INTERMEDIATE prompt chunk picks nothing: its boundary retires an
        expired/cancelled request or queues the next chunk."""
        if kind == "chunk" and not req.chunk_final:
            if _expired(req) or (req.cancel is not None
                                 and req.cancel.is_set()):
                self._retire(req)    # the bare prompt
                return
            data = _next_chunk(req, self.chunk_tokens)
            with self._lock:
                self.stats["prefill_chunks"] += 1
            M_CHUNKS.inc(executor="workers")
            self._q[0].put((req, data, "chunk"))
            return
        token = _pick(req, out)
        req.tokens.append(token)
        with self._lock:
            self.stats["tokens"] += int(token.shape[0])
        M_STEPS.inc(executor="workers")
        if self.on_step is not None:
            self.on_step()
        if req.on_token is not None:
            req.on_token(len(req.tokens) - 1, token)
        done = len(req.tokens) >= req.new_tokens
        if not done and _expired(req):
            done = True             # deadline passed: cancel mid-flight
        if not done and req.cancel is not None and req.cancel.is_set():
            done = True             # caller gone: free the slot early
        if not done and req.eos_token is not None:
            done = _eos_done(req, token)
        if done:
            self._retire(req)
        else:
            self._q[0].put((req, token[:, None], "step"))

    def _die(self, exc: BaseException) -> None:
        with self._lock:
            if self._dead is None:
                self._dead = exc
            self._lock.notify_all()
        # wake submitters blocked on admission so they observe the death
        for _ in range(self.max_active):
            self._slots.release()
