"""HTTP serving front end over the port's pipelined decode executors.

The single-replica half of the repository's `tools/serve.py`, on PyTorch:

    python -m pipeedge_tpu_torch.serve -m gpt2 -pt 1,24,25,48 \\
        --max-len 1024 -t float32 --kv-bits 8 --int8-decode-attend auto \\
        [--executor stage] [--port 8321] [--device cpu]

A stdlib JSON/HTTP server that drives a `ContinuousBatcher` (wave
executor) or a `StageWorkerExecutor` (one worker thread per pipeline
stage) continuously: requests admit as they arrive and share the
pipeline, and prompt prefixes registered once via /prefix are reused by
any number of /generate requests. Every /generate rides the admission
plane (`serving/`: per-class token buckets, a bounded
earliest-deadline-first queue, watermark-driven brownout), so a surge is
shed with 503 + Retry-After; a request's `"deadline_ms"` rides into the
executor, which cancels expired work at the next decode-step boundary
(HTTP 504). It prints `serving <model> (<n> stages, <executor> executor)
on <host>:<port>` once it listens, and `kernel_launches={...}` (the
kernels this process launched) when it exits.

Endpoints (as in `tools/serve.py`, JSON unless noted):
- GET  /healthz   -> {"ok", "model", "stages", "speculative", "executor",
                      "degraded", "draining", "serving", "flight",
                      "peer_health", "stats"}; 503 once a worker died
- GET  /metrics   -> Prometheus text (the JAX server's family names and
                     label sets)
- GET  /debug/spans[?drain=0] -> the span ring
- POST /degraded {"degraded": bool, "dead_rank"?, "retry_after"?,
                  "healing"?, "healed"?, "rank"?} -> {"degraded": bool}
- POST /debug/dump {"rid"?} -> {"path", "written_total"}
- POST /prefix   {"ids": [t0, ...]} -> {"prefix_id": "p0", "len": N}
- POST /generate {"ids": [[...], ...] | [...], "new_tokens": N,
                  "temperature"?, "top_k"?, "seed"?, "eos_token"?,
                  "prefix_id"?, "class"?, "deadline_ms"?, "stream"?}
                 -> {"ids": [[prompt+continuation], ...], "rid": "q17"}
  With `"stream": true` the response is chunked `application/x-ndjson`:
  one `{"step": i, "tokens": [[...]]}` line per decode step, then a final
  `{"ids", "first_token_ms", "steps", "rid"}` line equal to the plain
  response. `"speculative": true` runs greedy draft/verify rounds with
  `--draft-model` (the target's own greedy tokens), gets the JAX server's
  400 ("speculative generation unavailable") without one, and plain
  greedy under brownout.

Tokens equal solo `DecodePipeline.generate` runs with the same settings.
With an int8 cache (`--kv-bits 8`) and `--int8-decode-attend` on, every
single-token decode step attends through the decode-attention kernel.

The paged KV plane (`--kv-pages N [--kv-page-size 16]`, `kv/`): the
executors run on page tables over one shared pool per stage instead of
dense per-request caches, a prompt-prefix trie shares whole prompt pages
across requests, admission charges each request's page reservation
against a KV TOKEN budget of N x page size, `/prefix` registers token
lists (the trie owns the KV), the brownout ladder's evict rung reclaims
cold prefix pages, and the governor sweeps orphaned pages. It enables
`--chunked-prefill N` (prompt passes split into N-token chunks between
decode steps, `--prefill-budget` tokens per wave tick) and shares the
pool with speculative generations (`--draft-model` gets a draft-layout
pool of its own):

    python -m pipeedge_tpu_torch.serve -m gpt2 -pt 1,24,25,48 \\
        --max-len 1024 -t float32 --kv-bits 8 --int8-decode-attend auto \\
        --kv-pages 1024 --kv-page-size 16 --chunked-prefill 64 --step-join
    python -m pipeedge_tpu_torch.serve -m gpt2-medium --max-len 1024 \\
        -t float32 --draft-model gpt2 --gamma 4 --kv-pages 1024

Threads and the card: the executor threads and the handler threads all
enqueue on the device's default stream (`parallel/batcher.py`). A
streamed token is copied to pinned host memory behind a CUDA event in
the executor's thread (`_fence_tokens`); the handler thread waits on that
event, so it never reads a tensor still being written.

The routed fleet (`--role router|replica`): a model-free router process
health-polls N decode replicas and routes `/generate` and `/prefix`
across them (`serving/router.py`: prefix affinity, retry to another
replica, hedging, mid-stream failover). With `--replicas N` it spawns
and supervises N `--role replica` processes on free ports (a dead one
respawns with the next epoch and is readmitted after clean polls); with
`--replica-addrs HOST:PORT,...` it routes across replicas someone else
runs. A replica is a single server plus `POST /drain` (stop admitting,
finish in-flight work), `POST /kv/export` and `POST /kv/import` (a
cached prefix's pages as base64 `kv/ship.py` frames, which the router's
drain moves to a survivor; needs `--kv-pages`); the router's own `POST
/drain {"replica": "r0"}` orchestrates that:

    python -m pipeedge_tpu_torch.serve --role router --replicas 2 \\
        -m gpt2 -pt 1,24,25,48 -t float32 --kv-bits 8 \\
        --int8-decode-attend auto --max-len 1024 --port 8321
    python -m pipeedge_tpu_torch.serve --role router \\
        --replica-addrs 127.0.0.1:8400,127.0.0.1:8401 --port 8321

The router prints `serving router (<n> replicas) on <host>:<port>` once
every replica is up and it listens; SIGTERM stops it and its replicas.

The router's observatory and capacity loop: a fleet collector scrapes
every replica's /metrics each `--fleet-scrape-interval` seconds (default
1; <= 0 turns it off and GET /fleet answers 503) into `GET /fleet`
(per-class goodput and shed rates, the summed admission queue depth, the
max brownout level, the exemplar union, per-replica age and errors, the
SLO burn rates). `--autoscale auto` closes the loop over it
(`serving/autoscale.py`): sustained queue depth, brownout or SLO burn
spawns a replica with `add_rank` (it earns traffic through the health
polls' readmission, printing `autoscale_spawn replica=... rank=...
epoch=... url=...`), sustained calm drains the newest healthy replica
with prefix migration and retires its process (`autoscale_drain
replica=... rank=... migrated=...`); `advise` logs and counts the same
decisions and moves nothing. `/healthz` and `/fleet` carry the
controller's `autoscale` block:

    python -m pipeedge_tpu_torch.serve --role router --replicas 1 \
        -m gpt2 -pt 1,24,25,48 -t float32 --kv-bits 8 --kv-pages 1024 \
        --max-active 4 --autoscale auto --autoscale-min 1 \
        --autoscale-max 2 --fleet-scrape-interval 0.5 --port 8321

Disaggregated prefill (`--disaggregate local|wire|process`, needs
`--kv-pages`): prompt passes run on a prefill fleet and their KV rows land
in the decode executor's pages, so a long prompt no longer stretches
every other request's inter-token latency. `local` runs them on a
dedicated pipeline in this process that shares the decode pipeline's
weights and hands the tensors over; `wire` ships real bytes through the
v2 codec and a loopback socket (`--kv-ship-bits 8`: the codec's encode
kernel on the prefill side, its decode kernel here); `process` spawns
`--prefill-ranks` worker processes (`python -m
pipeedge_tpu_torch.prefill_worker`, DCN ranks 1..N, this process rank 0)
behind the lease/ack protocol of `kv/fleet.py` (re-dispatch, bounded
re-ship, colocated fallback), respawning a dead worker with the next
epoch. A prompt the prefix trie covers to within one page, brownout rung
4, and `PrefillUnavailable` run it colocated
(`pipeedge_kv_prefill_colocated_total{reason}`); `/healthz` carries
`kv.disaggregated` and `kv.prefill` (the fleet's leases and workers):

    python -m pipeedge_tpu_torch.serve -m gpt2 -pt 1,24,25,48 \\
        --max-len 1024 -t float32 --kv-pages 1024 --kv-page-size 16 \\
        --disaggregate process --prefill-ranks 2 --kv-ship-bits 8

Every flag of `tools/serve.py` is ported (`REFUSED` is empty). Without
`--kv-pages`, a `prefix_id` names a dense `precompute_prefix` handle
(and, with a draft model, the draft's too).
"""
from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import torch

from . import health as peer_health
from . import telemetry
from .kv import (KvPagePool, PagedKvBackend, PrefillFleet,
                 PrefillUnavailable, RemotePrefillFleet, ship)
from .models import registry
from .ops import _build
from .parallel import batcher as batcher_mod
from .parallel.decode import build_decode_pipeline
from .parallel.speculative import SpeculativeDecoder
from .serving import (AdmissionController, AdmissionShed, BrownoutLadder,
                      DeadlineExceeded, REQUEST_CLASSES, Watermarks,
                      default_policies, parse_class_map)
from .telemetry import collector as fleet_obs
from .telemetry import flight
from .telemetry import metrics as prom
from .utils.threads import make_condition, make_lock

# request outcomes the per-class counter tracks (the request-class x
# outcome matrix, pre-declared at service construction)
REQUEST_OUTCOMES = ("ok", "shed", "deadline", "degraded", "error")

# request-id header: a caller that already minted a rid (a router, any
# tracing client) passes it here; the server mints `q<n>` only when absent
RID_HEADER = "X-PipeEdge-Rid"

# `tools/serve.py` flags this entry refuses, each with the ROADMAP item
# that ports it (so no flag is silently ignored):
# flag -> (argparse keywords, ROADMAP item). Every flag is ported now.
REFUSED: dict = {}


def _header_rid(headers) -> Optional[str]:
    """A sane caller-supplied rid from the request headers, else None
    (it lands in span rings, logs and postmortem filenames: bound and
    sanitize it)."""
    raw = headers.get(RID_HEADER)
    if not raw:
        return None
    rid = raw.strip()
    if not rid or len(rid) > 128 or not rid.isprintable():
        return None
    return rid


def _rid_headers(rid) -> tuple:
    """Response-header echo of the request id."""
    return ((RID_HEADER, rid),) if rid else ()


def _fence_tokens(token: torch.Tensor):
    """A streamed pick [B] as (host tensor, event or None), taken in the
    executor's thread: on the card the copy goes to pinned memory on the
    stream that wrote the token, behind a recorded event, so the executor
    never waits; the reader waits on the event (`_read_tokens`). A CPU
    token is final as it is (the executor never writes it again)."""
    if token.device.type != "cuda":
        return token, None
    host = torch.empty(token.shape, dtype=token.dtype, pin_memory=True)
    host.copy_(token, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _read_tokens(fenced) -> list:
    host, event = fenced
    if event is not None:
        event.synchronize()
    return host.tolist()


class Server(ThreadingHTTPServer):
    """The HTTP front end: one thread per connection. Its listen backlog
    holds a burst of clients that connect at once; socketserver's default
    of 5 resets connections past the fifth."""
    request_queue_size = 128


class ServiceDegraded(RuntimeError):
    """The service is in a failover window (a backing stage died): new
    work should come back later instead of queueing into the hole."""

    def __init__(self, dead_rank, retry_after: float):
        where = f" (rank {dead_rank} dead)" if dead_rank is not None else ""
        super().__init__(
            f"service degraded during failover{where}; retry after "
            f"{retry_after:g}s")
        self.dead_rank = dead_rank
        self.retry_after = retry_after


class _Service:
    """Owns the pipeline + executor; HTTP handler threads submit requests
    and wait for (or stream) their results."""

    def __init__(self, pipe, max_active=None, max_prefixes=8, spec=None,
                 executor="wave", edge_itemsize=2,
                 admission_enabled=True, queue_capacity=64,
                 class_rates=None, class_deadlines_s=None,
                 brownout_enabled=True, brownout_marks=None,
                 clamp_new_tokens=16, governor_interval=0.25,
                 postmortem_dir=None, kv_pages=0, kv_page_size=16,
                 chunked_prefill=0, step_join=False,
                 prefill_budget=None, clamp_chunk_tokens=0,
                 slo_objective=0.99, slo_burn_fast=30.0,
                 slo_burn_slow=300.0, slo_burn_threshold=10.0,
                 prefill_fleet=None, prefill_supervisor=None):
        self.pipe = pipe
        self.spec = spec
        self.executor = executor
        self.draining = False     # POST /drain (a replica behind a router)
        # -- paged KV plane (kv/) ---------------------------------------
        # kv_pages > 0 swaps the executors' dense per-request cache slots
        # for page tables over one shared pool (+ the prefix trie);
        # admission then runs on a KV TOKEN budget. The optional prefill
        # fleet (--disaggregate) runs prompt passes on its OWN pipeline or
        # processes and ships KV pages in, so decode waves never share
        # stage time with prefills
        self.kv_backend = None
        if kv_pages:
            self.kv_backend = PagedKvBackend(pipe, kv_pages, kv_page_size)
            if spec is not None:
                # speculative verify caches reserve pages from the SAME
                # pool as decode requests; the draft model gets its own
                # pool over its own pipeline geometry
                spec.attach_paged(self.kv_backend,
                                  KvPagePool(spec.draft, kv_pages,
                                             kv_page_size))
        self.prefill_fleet = prefill_fleet
        self.prefill_supervisor = prefill_supervisor
        self.m_prefill_colocated = None
        if prefill_fleet is not None and self.kv_backend is None:
            raise ValueError("--disaggregate needs --kv-pages (shipped "
                             "KV lands in the paged pool)")
        if prefill_fleet is not None:
            # colocated-fallback accounting: "unavailable" = every prefill
            # rank and retry exhausted; "brownout" = the colocate_prefill
            # rung turned shipping off
            self.m_prefill_colocated = prom.REGISTRY.counter(
                "pipeedge_kv_prefill_colocated_total",
                "prompt passes run colocated in the decode executor "
                "while disaggregation was configured, by reason")
            for reason in ("unavailable", "brownout"):
                self.m_prefill_colocated.declare(reason=reason)
        self.cond = make_condition("serve.results")
        # -- /metrics + healthz counters (one source of truth) ----------
        # healthz's stats read the registry instruments back (stats()),
        # so both surfaces always agree; get_or_create returns the
        # surviving instruments across a _Service rebuild in one process
        self._edge_itemsize = int(edge_itemsize)
        self.m_requests = prom.REGISTRY.counter(
            "pipeedge_serve_requests_total",
            "generate requests by endpoint and outcome status")
        for endpoint in ("/generate", "/generate-speculative"):
            for status in ("200", "503", "504", "error"):
                self.m_requests.declare(endpoint=endpoint, status=status)
        self.m_tokens = prom.REGISTRY.counter(
            "pipeedge_serve_tokens_total", "tokens generated (rows x steps)")
        self.m_latency = prom.REGISTRY.histogram(
            "pipeedge_serve_request_latency_seconds",
            "end-to-end generate latency (request receipt -> result)")
        self.m_class_outcome = prom.REGISTRY.counter(
            "pipeedge_requests_by_class_total",
            "generate requests by request class and outcome "
            "(ok / shed / deadline / degraded / error)")
        for cls in REQUEST_CLASSES:
            for outcome in REQUEST_OUTCOMES:
                self.m_class_outcome.declare(**{"class": cls,
                                                "outcome": outcome})
        # flight recorder: always-on event ring + postmortem bundles on
        # 504 / shed / failover / SLO breach
        self.flight = flight.configure(rank=0, out_dir=postmortem_dir)
        # local SLO burn-rate engine (ticked by the governor loop)
        self.burn = fleet_obs.BurnRateEngine(
            objective=slo_objective, fast_window_s=slo_burn_fast,
            slow_window_s=slo_burn_slow, threshold=slo_burn_threshold,
            on_breach=self._on_slo_burn)
        self.m_degraded = prom.REGISTRY.counter(
            "pipeedge_serve_degraded_entered_total",
            "failover windows opened via POST /degraded")
        self.m_replays = prom.REGISTRY.counter(
            "pipeedge_serve_failover_replays_total",
            "in-flight requests replayed after a degraded window closed")
        self.m_rejoined = prom.REGISTRY.counter(
            "pipeedge_serve_rejoined_ranks_total",
            "degraded windows closed as HEALED (capacity restored by a "
            "rank rejoining), by rank")
        self.m_last_dead = prom.REGISTRY.gauge(
            "pipeedge_serve_last_dead_rank",
            "rank named by the most recent degraded window (-1 = none)")
        self.m_last_dead.set(-1)
        # estimated device-edge activation bytes (not socket bytes)
        self.m_edge_bytes = prom.REGISTRY.counter(
            "pipeedge_serve_edge_wire_bytes_total",
            "per-edge activation bytes moved by completed requests "
            "(prefill + decode steps, estimated from shapes)")
        for i in range(len(pipe.stages) - 1):
            self.m_edge_bytes.declare(edge=f"{i}->{i + 1}")
        # speculative generations hold THIS lock, not self.cond: plain
        # requests and result waits proceed concurrently; serializing
        # speculative requests with each other bounds their cache memory
        self.spec_lock = make_lock("serve.speculative")
        self.prefixes = OrderedDict()   # LRU-bounded: dense handles hold
        self.spec_prefixes = OrderedDict()   # full max_len KV buffers
        self.max_prefixes = max_prefixes
        self._next_rid = 0
        self._next_pid = 0
        self._stop = False
        self._dead: Optional[BaseException] = None
        # failover window (enter_degraded/exit_degraded): while set, new
        # work is refused with 503 + Retry-After; unlike `_dead` it clears
        self.degraded_info: Optional[dict] = None
        # set on every window close so in-flight requests waiting out a
        # failover wake immediately on recovery
        self._recovered = threading.Event()
        # observed heal durations: the basis of the derived Retry-After
        self._heal_s = deque(maxlen=8)
        # iteration-level scheduling: chunked_prefill > 0 splits long
        # prompt passes into fixed-token chunks between decode steps;
        # step_join re-drives admission at every decode-step boundary
        self.chunked_prefill = int(chunked_prefill)
        self.step_join = bool(step_join)
        if executor == "stage":
            self.exec = batcher_mod.StageWorkerExecutor(
                pipe, max_active=max_active, kv=self.kv_backend,
                chunk_tokens=self.chunked_prefill, step_join=self.step_join,
                on_step=self._on_step)
            self.batcher = None
            self.worker = None
        elif executor == "wave":
            self.exec = None
            self.batcher = batcher_mod.ContinuousBatcher(
                pipe, max_active=max_active, kv=self.kv_backend,
                chunk_tokens=self.chunked_prefill,
                prefill_budget=prefill_budget, step_join=self.step_join,
                on_step=self._on_step)
            self.worker = threading.Thread(target=self._loop, daemon=True,
                                           name="wave-executor")
            self.worker.start()
        else:
            raise ValueError(f"unknown executor {executor!r} "
                             "(expected 'wave' or 'stage')")
        # -- overload-protection plane ----------------------------------
        # admission concurrency mirrors the executor's own bound, so the
        # EDF queue is the ONLY place requests wait
        concurrency = (self.exec.max_active if self.exec is not None
                       else self.batcher.max_active)
        self.m_deadline = prom.REGISTRY.counter(
            "pipeedge_deadline_exceeded_total",
            "requests whose deadline expired mid-flight (cancelled at a "
            "decode-step boundary and answered 504)")
        self.admission: Optional[AdmissionController] = None
        if admission_enabled:
            # paged mode: each admit also charges the request's page
            # reservation against a TOKEN budget, so many small requests
            # share the capacity a few dense slots would pin
            self.admission = AdmissionController(
                concurrency=concurrency, queue_capacity=queue_capacity,
                policies=default_policies(class_rates, class_deadlines_s),
                token_budget=(None if self.kv_backend is None
                              else self.kv_backend.pool.tokens_capacity))
        self.brownout: Optional[BrownoutLadder] = None
        self._gov_stop = threading.Event()
        self.governor_interval = float(governor_interval)
        if brownout_enabled:
            self.brownout = BrownoutLadder(
                brownout_marks if brownout_marks is not None
                else Watermarks(), clamp_new_tokens=clamp_new_tokens,
                clamp_chunk_tokens=clamp_chunk_tokens)
            if self.kv_backend is not None:
                # the evict_cold_pages rung's lever: reclaim cached but
                # idle prefix pages before any request class is shed
                self.brownout.evict_hook = self.kv_backend.evict_cold_all
        # the governor also ticks the SLO burn-rate engine and (paged)
        # sweeps orphaned pages; the burn engine always exists, so the
        # thread always runs
        self._governor = threading.Thread(target=self._governor_loop,
                                          daemon=True,
                                          name="brownout-governor")
        self._governor.start()

    def _on_step(self):
        """Executor decode-step hook: re-drive the EDF admission queue at
        every step boundary (a no-op when the queue is empty; tolerant of
        construction order: the executors exist before admission)."""
        adm = getattr(self, "admission", None)
        if adm is not None:
            adm.notify_step()

    def _loop(self):
        while True:
            with self.cond:
                while not self._stop and not (
                        self.batcher.pending or self.batcher.active):
                    self.cond.wait()
                if self._stop:
                    return
                try:
                    self.batcher.tick()
                except BaseException as exc:   # noqa: BLE001 — a wedged
                    # worker would hang every waiter forever; record the
                    # failure so they raise instead
                    self._dead = exc
                    self.cond.notify_all()
                    raise
                if self.batcher.results:
                    self.cond.notify_all()

    @property
    def dead(self) -> Optional[BaseException]:
        if self._dead is not None:
            return self._dead
        return self.exec._dead if self.exec is not None else None

    def add_prefix(self, ids):
        with self.cond:
            self._check_admittable()
            if self.kv_backend is not None:
                # paged mode: registration is the TOKEN LIST; the prefix
                # trie dedups the prefill across every request using it
                tokens = [int(t) for t in ids]
                if not tokens:
                    raise ValueError("prefix must be non-empty")
                pid = f"p{self._next_pid}"
                self._next_pid += 1
                self.prefixes[pid] = {"tokens": tokens,
                                      "len": len(tokens)}
                while len(self.prefixes) > self.max_prefixes:
                    self.prefixes.popitem(last=False)
                return pid, len(tokens)
            # both handles (the draft's too, with a draft model) before
            # registering either; built in this handler thread, on the
            # executors' stream
            with batcher_mod._stage_context(self.pipe):
                target = self.pipe.precompute_prefix(ids)
                draft = (self.spec.draft.precompute_prefix(ids)
                         if self.spec is not None else None)
            pid = f"p{self._next_pid}"
            self._next_pid += 1
            self.prefixes[pid] = target
            if draft is not None:
                self.spec_prefixes[pid] = {"target": target,
                                           "draft": draft}
            while len(self.prefixes) > self.max_prefixes:
                old, _ = self.prefixes.popitem(last=False)  # evict oldest
                self.spec_prefixes.pop(old, None)
            return pid, target["len"]

    def _check_dead(self):
        dead = self.dead
        if dead is not None:
            raise RuntimeError(f"serving worker died: {dead!r}")

    # -- brownout governor ----------------------------------------------

    def _on_slo_burn(self, cls, burn):
        """BurnRateEngine breach hook (edge-triggered, governor thread):
        capture the serving state that burned the budget."""
        self.flight.note("slo_burn_breach", request_class=cls,
                         burn=round(burn, 3))
        ctx = self.bundle_context()
        ctx["slo_burn"] = {"class": cls, "burn_rate": round(burn, 4),
                           "objective": self.burn.objective,
                           "threshold": self.burn.threshold}
        self.flight.maybe_dump("slo_burn", context=ctx)

    def _live_request_ids(self):
        """Snapshot of every live executor request id (and, with a draft
        model, every speculative generation's page owner): the orphan
        sweep's liveness set. None when the snapshot raced a mutation
        (the sweep skips; the next tick retries)."""
        src = (self.exec._live if self.exec is not None
               else self.batcher._live_rids)
        for _ in range(3):
            try:
                live = set(src)
                break
            except RuntimeError:     # set mutated during copy
                continue
        else:
            return None
        if self.spec is not None:
            live |= self.spec.live_rids()
        return live

    def _governor_loop(self):
        """Periodic brownout tick: the windowed p95 of the request-latency
        histogram + the admission queue depth drive the ladder; the
        degraded lifecycle floors it (healing implies at least level 1).
        The ladder's shed classes feed straight into admission, its chunk
        clamp into the executor. With a paged backend the loop is also
        the leak audit: every ~2 s the pool's owner ledger is reconciled
        against executor liveness."""
        prev_counts, prev_n = self.m_latency.snapshot()
        last_level = self.brownout.level if self.brownout is not None else 0
        sweep_every = max(1, round(2.0 / self.governor_interval))
        ticks = 0
        while not self._gov_stop.wait(self.governor_interval):
            ticks += 1
            self._sweep_pages(ticks % sweep_every == 0)
            counts, n = self.m_latency.snapshot()
            delta = [c - p for c, p in zip(counts, prev_counts)]
            p95 = prom.percentile_from_counts(
                self.m_latency.buckets, delta, n - prev_n, 95.0)
            prev_counts, prev_n = counts, n
            depth = (self.admission.queue_depth
                     if self.admission is not None else 0)
            self.burn.update(fleet_obs.BurnRateEngine.counts_from_counter(
                self.m_class_outcome))
            if self.brownout is None:
                continue
            self.brownout.set_floor(1 if self.degraded_info is not None
                                    else 0)
            level = self.brownout.update(depth, p95)
            if self.admission is not None:
                self.admission.set_shed_classes(self.brownout.shed_classes())
            if level != last_level:
                t = time.monotonic_ns()
                telemetry.record("serve", f"brownout:{level}", t, t)
                self.flight.note("brownout", level=level,
                                 queue_depth=depth, p95_s=p95)
                if level >= 2 and level > last_level:
                    # stepping INTO the clamp/shed rungs is the SLO-breach
                    # trigger: capture the state that drove the ladder up
                    self.flight.maybe_dump("slo",
                                           context=self.bundle_context())
                last_level = level
            if self.chunked_prefill:
                # the clamp_tokens rung's second lever: a smaller chunk
                # while hot (identity when clamp_chunk_tokens is 0)
                want = self.brownout.clamp_chunk(self.chunked_prefill)
                ex = self.exec if self.exec is not None else self.batcher
                if ex.chunk_tokens != want:
                    ex.set_chunk_tokens(want)
                    self.flight.note("chunk_clamp", chunk_tokens=want)

    def _sweep_pages(self, due: bool) -> None:
        """The governor's orphan sweep (paged mode, when `due`): liveness
        is passed as a CALLABLE, so the sweep reads the owner ledger
        first and liveness second, and a request admitted between the
        two reads is never taken for dead."""
        if self.kv_backend is None or not due:
            return
        leaked = self.kv_backend.sweep_orphans(self._live_request_ids)
        if leaked:
            self.flight.note("kv_pages_reclaimed", pages=leaked)
        if self.spec is not None:
            d_leaked = self.spec.sweep_orphans()
            if d_leaked:
                self.flight.note("draft_pages_reclaimed", pages=d_leaked)

    # -- failover window ------------------------------------------------

    def _derived_retry_after(self) -> float:
        """Retry-After for a window opened WITHOUT a hint: the median
        observed heal time, 5 s until a heal has been seen."""
        if self._heal_s:
            med = sorted(self._heal_s)[len(self._heal_s) // 2]
            return min(60.0, max(0.5, med))
        return 5.0

    def enter_degraded(self, dead_rank=None,
                       retry_after: Optional[float] = None):
        """Open a failover window: admission refuses new work with
        503 + Retry-After until `exit_degraded`."""
        if retry_after is None:
            retry_after = self._derived_retry_after()
        self._recovered.clear()
        with self.cond:
            self.degraded_info = {"dead_rank": dead_rank,
                                  "since": time.monotonic(),
                                  "retry_after": float(retry_after),
                                  "phase": "degraded"}
            self.cond.notify_all()
        self.m_degraded.inc()
        if dead_rank is not None:
            self.m_last_dead.set(int(dead_rank))
        self.flight.note("degraded", dead_rank=dead_rank,
                         retry_after=retry_after)
        self.flight.maybe_dump("failover", context=self.bundle_context())

    def mark_healing(self):
        """The dead rank rejoined: the window stays open, but /healthz
        reports `healing`. A no-op when no window is open."""
        with self.cond:
            if self.degraded_info is not None:
                self.degraded_info["phase"] = "healing"
                self.cond.notify_all()

    def exit_degraded(self, healed: bool = False, rank=None):
        """Close the window. `healed=True` counts the close as a capacity
        restoration and feeds its duration into the heal history."""
        with self.cond:
            was_open = self.degraded_info is not None
            if healed and was_open:
                self._heal_s.append(
                    time.monotonic() - self.degraded_info["since"])
            self.degraded_info = None
            self.cond.notify_all()
        self._recovered.set()     # wake replay waiters immediately
        self.flight.note("degraded_closed", healed=healed, rank=rank)
        if healed and was_open:
            self.m_rejoined.inc()

    def _check_admittable(self):
        deg = self.degraded_info
        if deg is not None:
            raise ServiceDegraded(deg["dead_rank"], deg["retry_after"])
        if self.draining:
            # drains don't heal: the Retry-After sends the client to
            # another replica (the router already stopped routing here;
            # this is the race window's backstop)
            raise RuntimeError("draining: this replica admits no new "
                               "requests")

    def begin_drain(self):
        """POST /drain: stop admitting, let in-flight work finish. The
        router owns the rest (migrate warm prefixes, detach, respawn);
        this side refuses new admits and reports `active` in /healthz."""
        self.draining = True
        self.flight.note("drain_begin")

    # -- replica-to-replica KV migration ---------------------------------

    def kv_export(self, ids):
        """POST /kv/export: this replica's cached KV pages of a prompt
        prefix as a base64 ship blob. Returns (blob | None,
        tokens_covered, pages)."""
        if self.kv_backend is None:
            raise ValueError("KV export needs --kv-pages (dense cache "
                             "slots have no page plane to export)")
        # imported here, as the JAX server does: importing the router
        # registers its metric families, which a replica does not serve
        from .serving.router import encode_ship_blob
        out = self.kv_backend.export_prefix([int(t) for t in ids])
        if out is None:
            return None, 0, 0
        frames, plen, pages = out
        return encode_ship_blob(frames), plen, pages

    def kv_import(self, ids, blob_b64):
        """POST /kv/import: install a shipped prefix in this replica's
        page pool and trie (an already-cached prefix installs 0 pages).
        Returns pages installed."""
        if self.kv_backend is None:
            raise ValueError("KV import needs --kv-pages")
        from .serving.router import decode_ship_blob
        handle = ship.decode_kv_ship(decode_ship_blob(blob_b64),
                                     self.pipe.dtype, device=self.pipe.device)
        return self.kv_backend.install_prefix([int(t) for t in ids], handle)

    def _await_recovery(self) -> bool:
        """Block until the degraded window closes (True) or its retry
        budget (2x retry_after) runs out / the worker is truly dead
        (False): the replay gate of a request in flight at a failover."""
        with self.cond:
            deg = self.degraded_info
            if deg is None:
                return False   # the failure was not a failover window
        deadline = time.monotonic() + 2 * deg["retry_after"]
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or self.dead is not None:
                return False
            if self._recovered.wait(timeout=min(0.5, left)):
                return (self.dead is None
                        and self.degraded_info is None)

    # -- admission plumbing ---------------------------------------------

    def speculative_allowed(self) -> bool:
        """Brownout rung 1 (`no_speculative`): speculative requests fall
        back to plain greedy."""
        return self.brownout is None or self.brownout.allow_speculative()

    def mint_rid(self) -> str:
        """Mint one request id: THE identity every span, flight event,
        response body and postmortem bundle correlates on."""
        with self.cond:
            n = self._next_rid
            self._next_rid += 1
        return f"q{n}"

    def kv_tokens(self, ids, new_tokens) -> int:
        """The admission token charge of one request under the paged KV
        plane: its prompt + max-new-tokens page reservation (0 with
        dense caches or no admission: slot-only admission)."""
        if self.kv_backend is None or self.admission is None or not ids:
            return 0
        return self.kv_backend.tokens_needed(
            max(len(r) for r in ids), int(new_tokens), len(ids))

    def admit(self, request_class: str, deadline_s=None, rid=None,
              tokens: int = 0):
        """Acquire an admission ticket (blocking, EDF order) + its
        absolute deadline. Returns (ticket, deadline); raises
        `AdmissionShed` (503 + Retry-After) on shed, KeyError on an
        unknown class. The caller hands the ticket to `generate`, which
        releases it. `tokens` is the KV-token charge under a token
        budget (`kv_tokens`)."""
        if self.admission is None:
            deadline = (None if deadline_s is None
                        else time.monotonic() + float(deadline_s))
            return None, deadline
        deadline = self.admission.deadline_for(request_class, deadline_s)
        t0 = time.monotonic_ns()
        try:
            ticket = self.admission.admit(request_class, deadline,
                                          rid=rid, tokens=tokens)
        except AdmissionShed as exc:
            telemetry.record(
                "serve", f"shed:{exc.request_class}:{exc.reason}",
                t0, time.monotonic_ns(), rid=rid)
            self.flight.note("shed", rid=rid, cls=exc.request_class,
                             reason=exc.reason,
                             retry_after=exc.retry_after)
            if self.flight.would_dump("shed"):
                self.flight.maybe_dump("shed", rid=rid,
                                       context=self.bundle_context())
            raise
        telemetry.record("serve", f"admit:{request_class}",
                         t0, time.monotonic_ns(), rid=rid)
        self.flight.note("admit", rid=rid, cls=request_class,
                         wait_ms=round((time.monotonic_ns() - t0) / 1e6, 3))
        return ticket, deadline

    def bundle_context(self) -> dict:
        """The serving-state slice every postmortem bundle carries."""
        ctx = {"serving": self.serving_stats(), "stats": self.stats()}
        deg = self.degraded_info
        if deg is not None:
            ctx["degraded"] = {"dead_rank": deg["dead_rank"],
                               "phase": deg.get("phase"),
                               "since_s": round(time.monotonic()
                                                - deg["since"], 3)}
        ctx["latency_exemplars"] = self.m_latency.exemplars()
        return ctx

    def dump_postmortem(self, rid=None, trigger="manual"):
        """POST /debug/dump: write a bundle NOW (manual dumps bypass the
        cooldown). Returns the bundle path."""
        return self.flight.maybe_dump(trigger, rid=rid,
                                      context=self.bundle_context())

    def flight_stats(self) -> dict:
        """The /healthz `flight` block."""
        return {"postmortems_written_total": self.flight.written_total(),
                "last_postmortem": self.flight.last_path(),
                "events_dropped": self.flight.dropped}

    def retry_after_hint(self) -> float:
        """The best current 'come back in N seconds' estimate."""
        deg = self.degraded_info
        if deg is not None:
            return deg["retry_after"]
        if self.admission is not None:
            return self.admission.retry_after()
        return 5.0

    def serving_stats(self) -> dict:
        """The /healthz `serving` block (admission + brownout state)."""
        s = {"deadline_exceeded_total": int(self.m_deadline.value())}
        if self.admission is not None:
            s["admission"] = self.admission.snapshot()
        if self.brownout is not None:
            s["brownout"] = self.brownout.snapshot()
        if self.chunked_prefill or self.step_join:
            # iteration-level scheduling: the configured chunk size, the
            # EFFECTIVE one (brownout may clamp it) and the chunk waves
            ex = self.exec if self.exec is not None else self.batcher
            s["scheduler"] = {
                "chunked_prefill": self.chunked_prefill,
                "chunk_tokens": ex.chunk_tokens,
                "step_join": self.step_join,
                "prefill_chunks": int(
                    self.exec.snapshot()["prefill_chunks"]
                    if self.exec is not None
                    else self.batcher.stats["prefill_chunks"]),
            }
        if self.kv_backend is not None:
            s["kv"] = self.kv_backend.snapshot()
            s["kv"]["disaggregated"] = self.prefill_fleet is not None
            # the leak audit's health surface: page references the
            # orphan sweep reclaimed (0 = no leaks)
            s["kv"]["leaked"] = s["kv"]["pool"]["leaked"]
            fleet_snapshot = getattr(self.prefill_fleet, "snapshot", None)
            if fleet_snapshot is not None:
                s["kv"]["prefill"] = fleet_snapshot()
                s["kv"]["prefill"]["colocated"] = {
                    r: int(self.m_prefill_colocated.value(reason=r))
                    for r in ("unavailable", "brownout")}
            if self.prefill_supervisor is not None:
                s["kv"].setdefault("prefill", {})["workers"] = \
                    self.prefill_supervisor.snapshot()
        return s

    def generate_speculative(self, ids, new_tokens, prefix_id=None,
                             request_class="interactive",
                             deadline_s=None, ticket=None, rid=None):
        """Greedy speculative decoding (the target's own greedy tokens;
        the draft changes only the dispatch count). Holds only the
        dedicated spec lock during the generation, so plain requests keep
        flowing through the executor. Admitted like any generate (the
        deadline guards the queue wait; the rounds have no mid-flight
        cancel boundary). Without a draft model: the JAX server's
        KeyError (HTTP 400), counted under /generate-speculative."""
        t0 = time.monotonic()
        if rid is None:
            rid = self.mint_rid()
        tctx = telemetry.TraceContext(rid, request_class,
                                      deadline_ms=None if deadline_s is None
                                      else deadline_s * 1e3,
                                      parent="serve.speculative")
        released = self.admission is None
        try:
            strip = 0
            if self.kv_backend is not None and prefix_id is not None:
                # paged mode: the prefix becomes prepended tokens BEFORE
                # the token charge is computed
                with self.cond:
                    self._check_dead()
                    self._check_admittable()
                    ids, strip = self._expand_prefix(
                        ids, {"prefix_id": prefix_id})
                prefix_id = None
            if ticket is None and self.admission is not None:
                # paged speculative rounds reserve up to gamma verify
                # positions past new_tokens: charge for them
                gamma = self.spec.gamma if self.spec is not None else 0
                ticket, _ = self.admit(
                    request_class, deadline_s, rid=rid,
                    tokens=self.kv_tokens(ids, int(new_tokens) + gamma))
            completed = False
            try:
                with telemetry.trace_scope(tctx):
                    out = self._generate_speculative_once(ids, new_tokens,
                                                          prefix_id,
                                                          rid=rid)
                    if strip:
                        out = out[:, strip:]
                completed = True
            finally:
                if not released:
                    # failures must not feed the service-rate estimator
                    self.admission.release(ticket, completed=completed)
                    released = True
        except AdmissionShed:
            self.m_requests.inc(endpoint="/generate-speculative",
                                status="503")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "shed"})
            raise
        except ServiceDegraded:
            self.m_requests.inc(endpoint="/generate-speculative",
                                status="503")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "degraded"})
            raise
        except BaseException:
            self.m_requests.inc(endpoint="/generate-speculative",
                                status="error")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "error"})
            raise
        self.m_latency.observe(time.monotonic() - t0, exemplar=rid)
        self.m_requests.inc(endpoint="/generate-speculative", status="200")
        self.m_class_outcome.inc(**{"class": request_class,
                                    "outcome": "ok"})
        self.m_tokens.inc(len(ids) * int(new_tokens))
        self._account_edge_bytes(ids, int(new_tokens))
        return out

    def _generate_speculative_once(self, ids, new_tokens, prefix_id,
                                   rid=None):
        if self.spec is None:
            raise KeyError("server started without --draft-model; "
                           "speculative generation unavailable")
        with self.cond:                     # resolve the prefix briefly
            self._check_dead()
            self._check_admittable()
            prefix = None
            if prefix_id is not None:
                if prefix_id not in self.spec_prefixes:
                    raise KeyError(
                        f"unknown prefix_id {prefix_id!r} for speculative "
                        "generation (register via /prefix while the "
                        "draft model is configured)")
                self.prefixes.move_to_end(prefix_id)   # LRU touch
                prefix = self.spec_prefixes[prefix_id]
        # on the executors' stream; the rid names the page owner in the
        # pools' ledgers, so the governor's orphan sweep can name it
        with self.spec_lock, telemetry.span("serve", "speculative"), \
                batcher_mod._on_device_stream(self.pipe):
            out = self.spec.generate(ids, new_tokens, prefix=prefix,
                                     rid=rid)
            return out.cpu().numpy()

    def prevalidate(self, ids, new_tokens, kw):
        """Resolve prefix_id and run the full admission validation WITHOUT
        submitting: the streaming path needs errors raised BEFORE the
        200/chunked headers commit. Returns `(ids, kw)` with the prefix
        resolved: the dense handle in `kw["prefix"]`, or (paged mode) the
        prefix TOKENS prepended to `ids` and `kw["strip_prefix"]`, so the
        response still omits them."""
        kw = dict(kw)
        with self.cond:
            self._check_dead()
            self._check_admittable()
            if self.kv_backend is not None:
                ids, strip = self._expand_prefix(ids, kw)
                if strip:
                    kw["strip_prefix"] = strip
            else:
                self._resolve_prefix(kw)
        batcher_mod._build_request(
            self.pipe, "__prevalidate__", ids, new_tokens,
            kw.get("temperature", 0.0), kw.get("top_k", 0),
            kw.get("seed", 0), kw.get("eos_token"), kw.get("pad_token"),
            kw.get("prefix"))
        return ids, kw

    def _resolve_prefix(self, kw):
        pid = kw.pop("prefix_id", None)
        if pid is not None:
            if pid not in self.prefixes:
                raise KeyError(f"unknown prefix_id {pid!r} (evicted "
                               "or never registered)")
            self.prefixes.move_to_end(pid)     # LRU touch
            kw["prefix"] = self.prefixes[pid]

    def _expand_prefix(self, ids, kw):
        """Paged mode: a `prefix_id` becomes its registered tokens
        prepended to every prompt row (the trie turns the repeated
        prefill into page reuse). Returns (expanded ids, strip); callers
        slice `strip` columns off the result, so the response matches
        the dense handle contract (suffix + continuation)."""
        pid = kw.pop("prefix_id", None)
        if pid is None:
            return ids, 0
        if pid not in self.prefixes:
            raise KeyError(f"unknown prefix_id {pid!r} (evicted "
                           "or never registered)")
        self.prefixes.move_to_end(pid)         # LRU touch
        tokens = self.prefixes[pid]["tokens"]
        return [list(tokens) + [int(t) for t in r] for r in ids], \
            len(tokens)

    def generate(self, ids, new_tokens, on_token=None,
                 request_class="interactive", deadline_s=None,
                 ticket=None, deadline=None, rid=None, **kw):
        """One admitted generation; returns the [B, S + T] host ids. A
        pre-admitted `ticket` (+ its absolute `deadline`) comes from the
        streaming path. The deadline rides into the executor, whose
        decode-step expiry check fires the request's `cancel` flag: a
        mid-flight expiry surfaces as `DeadlineExceeded` (HTTP 504)."""
        t0 = time.monotonic()
        if rid is None:
            rid = self.mint_rid()
        tctx = telemetry.TraceContext(rid, request_class,
                                      deadline_ms=None if deadline_s is None
                                      else deadline_s * 1e3,
                                      parent="serve.generate")
        # paged mode: a prefix_id becomes prepended tokens BEFORE the
        # token charge is computed (the reservation covers the whole
        # prompt; the trie makes the shared part nearly free to run)
        strip = int(kw.pop("strip_prefix", 0))
        if self.kv_backend is not None and kw.get("prefix_id") is not None:
            with self.cond:
                ids, strip = self._expand_prefix(ids, kw)
        completed = False
        try:
            if ticket is None and deadline is None:
                ticket, deadline = self.admit(
                    request_class, deadline_s, rid=rid,
                    tokens=self.kv_tokens(ids, new_tokens))
            try:
                if self.brownout is not None:
                    new_tokens = self.brownout.clamp(new_tokens)
                cancel = kw.get("cancel")
                if deadline is not None:
                    if cancel is None:
                        cancel = threading.Event()
                        kw["cancel"] = cancel
                    kw["deadline"] = deadline
                with telemetry.trace_scope(tctx), \
                        telemetry.span("serve", "generate", rid=rid):
                    out = self._generate_policied(ids, new_tokens,
                                                  on_token, kw, rid=rid)
                now = time.monotonic()
                if (deadline is not None and now >= deadline
                        and cancel.is_set()):
                    # the executor cancelled it at a decode-step boundary
                    completed = True   # it DID occupy a full slot
                    raise DeadlineExceeded(
                        request_class, deadline_s
                        if deadline_s is not None else deadline - t0)
                completed = True
            finally:
                # generate releases ANY ticket it holds
                if ticket is not None and self.admission is not None:
                    self.admission.release(ticket, completed=completed)
        except AdmissionShed:
            self.m_requests.inc(endpoint="/generate", status="503")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "shed"})
            raise
        except DeadlineExceeded:
            self.m_deadline.inc()
            self.m_requests.inc(endpoint="/generate", status="504")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "deadline"})
            self.flight.note("deadline", rid=rid, cls=request_class,
                             budget_s=deadline_s,
                             elapsed_ms=round((time.monotonic() - t0) * 1e3,
                                              3))
            self.flight.maybe_dump("deadline", rid=rid,
                                   context=self.bundle_context())
            raise
        except ServiceDegraded:
            self.m_requests.inc(endpoint="/generate", status="503")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "degraded"})
            raise
        except BaseException:
            self.m_requests.inc(endpoint="/generate", status="error")
            self.m_class_outcome.inc(**{"class": request_class,
                                        "outcome": "error"})
            raise
        elapsed = time.monotonic() - t0
        self.m_latency.observe(elapsed, exemplar=rid)
        self.m_requests.inc(endpoint="/generate", status="200")
        self.m_class_outcome.inc(**{"class": request_class,
                                    "outcome": "ok"})
        self.m_tokens.inc(len(ids) * int(new_tokens))
        self._account_edge_bytes(ids, int(new_tokens))
        self.flight.note("done", rid=rid, cls=request_class,
                         ms=round(elapsed * 1e3, 3))
        # paged prefix contract: the response omits the prepended prefix
        return out[:, strip:] if strip else out

    def _generate_policied(self, ids, new_tokens, on_token, kw, rid=None):
        with self.cond:
            self._check_dead()
            self._check_admittable()   # degraded: 503 + Retry-After
        try:
            return self._generate_once(ids, new_tokens, on_token, kw,
                                       rid=rid)
        except ServiceDegraded:
            raise
        except RuntimeError:
            # the executor failed while a failover window was open: replay
            # once after recovery (not a streamed request: its partial
            # output cannot be unsent)
            if on_token is not None or not self._await_recovery():
                raise
            self.m_replays.inc()
            self.flight.note("replay", rid=rid)
            return self._generate_once(ids, new_tokens, on_token, kw,
                                       rid=None if rid is None
                                       else f"{rid}.replay")

    def _account_edge_bytes(self, ids, new_tokens: int) -> None:
        """Per-edge activation traffic of one completed request: every
        stage boundary moves a [B, S, H] prefill payload plus a [B, 1, H]
        payload per decode step."""
        n_edges = len(self.pipe.stages) - 1
        if n_edges <= 0:
            return
        hidden = getattr(self.pipe.cfg, "hidden_size", 0)
        prompt_len = max(len(r) for r in ids) if ids else 0
        per_edge = (len(ids) * (prompt_len + max(0, new_tokens - 1))
                    * hidden * self._edge_itemsize)
        for i in range(n_edges):
            self.m_edge_bytes.inc(per_edge, edge=f"{i}->{i + 1}")

    def _generate_once(self, ids, new_tokens, on_token, kw, rid=None):
        # the trace rid doubles as the EXECUTOR request id
        if rid is None:
            rid = self.mint_rid()
        if self.prefill_fleet is not None and kw.get("shipped") is None:
            self._route_prefill(ids, kw, rid)
        if self.exec is not None:
            with self.cond:
                self._check_dead()
                self._resolve_prefix(kw)
            self.exec.submit(rid, ids, new_tokens, on_token=on_token, **kw)
            return self.exec.wait(rid)
        with self.cond:
            self._check_dead()
            self._resolve_prefix(kw)
            self.batcher.submit(rid, ids, new_tokens, on_token=on_token,
                                **kw)
            self.cond.notify_all()
            while rid not in self.batcher.results:
                self._check_dead()
                self.cond.wait()
            return self.batcher.results.pop(rid)

    def _route_prefill(self, ids, kw, rid) -> None:
        """Disaggregated: the prompt pass runs on the prefill fleet and
        its KV lands in this request's pages (`kw["shipped"]`), so the
        decode executor only runs decode steps. It runs colocated instead
        under brownout rung 4, when the prefix trie covers the prompt to
        within one page (a short suffix span is cheaper in place than
        re-prefilled and re-shipped), or when no prefill rank could take
        it (`PrefillUnavailable`: the request survives with the same
        tokens; only the isolation degrades)."""
        if self.brownout is not None \
                and not self.brownout.allow_disaggregate():
            self.m_prefill_colocated.inc(reason="brownout")
            self.flight.note("prefill_colocated", rid=rid,
                             reason="brownout")
            return
        if len(ids) == 1:
            toks = [int(t) for t in ids[0]]
            matched = self.kv_backend.shared_prompt_tokens(toks)
            if matched > 0 and matched >= len(toks) \
                    - self.kv_backend.page_size:
                return
        try:
            kw["shipped"] = self.prefill_fleet.prefill(ids, rid=rid)
        except PrefillUnavailable as exc:
            self.m_prefill_colocated.inc(reason="unavailable")
            self.flight.note("prefill_colocated", rid=rid,
                             reason="unavailable", error=str(exc))

    def stats(self):
        """Lock-free best-effort snapshot for /healthz."""
        if self.exec is not None:
            s = self.exec.snapshot()
            s["pending"] = 0          # admission blocks in submit threads
            s["prefixes"] = len(self.prefixes)
        else:
            s = dict(self.batcher.stats,
                     active=self.batcher.active,
                     pending=len(self.batcher.pending),
                     prefixes=len(self.prefixes))
        s["degraded_entered_total"] = int(self.m_degraded.value())
        s["failover_replays_total"] = int(self.m_replays.value())
        s["rejoined_ranks_total"] = int(self.m_rejoined.value())
        last = self.m_last_dead.value()
        s["last_dead_rank"] = (None if last is None or last < 0
                               else int(last))
        return s

    def stop(self):
        self._gov_stop.set()
        if self.admission is not None:
            self.admission.close()   # shed every queued waiter (shutdown)
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        if self.exec is not None:
            self.exec.stop()
        elif self.worker is not None:
            self.worker.join()
        self._governor.join()
        # the ship plane goes LAST: in-flight prefills were failed fast by
        # the executor stop above
        close = getattr(self.prefill_fleet, "close", None)
        if close is not None:
            close()
        if self.prefill_supervisor is not None:
            self.prefill_supervisor.stop()


def make_handler(service, model_name):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"      # chunked transfer needs 1.1

        def log_message(self, *a):      # quiet server
            pass

        def _send(self, code, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, obj):
            data = json.dumps(obj).encode() + b"\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _stream_generate(self, ids, new_tokens, kw,
                             request_class="interactive", deadline_s=None,
                             rid=None):
            """Chunked x-ndjson response: one line per decode step as the
            token lands, then the authoritative final line. The executor
            pushes fenced host tokens (`_fence_tokens`) into a queue; the
            wait for the copy happens here, in the handler thread. A
            client that disconnects mid-stream sets the request's
            `cancel` flag, so the executor completes it early."""
            t0 = time.monotonic()
            # validate and ADMIT before the headers commit: a bad request
            # still gets 400, a shed a real 503 + Retry-After
            ids, kw = service.prevalidate(ids, new_tokens, kw)
            if rid is None:
                rid = service.mint_rid()
            try:
                ticket, deadline = service.admit(
                    request_class, deadline_s, rid=rid,
                    tokens=service.kv_tokens(ids, new_tokens))
            except AdmissionShed:
                # a streaming shed never reaches generate(): settle both
                # counters here
                service.m_requests.inc(endpoint="/generate", status="503")
                service.m_class_outcome.inc(**{"class": request_class,
                                               "outcome": "shed"})
                raise
            try:
                cancel = threading.Event()
                kw.update(cancel=cancel, request_class=request_class,
                          ticket=ticket, deadline=deadline, rid=rid)
                q = queue_mod.Queue()
                worker = threading.Thread(
                    target=self._run_generate,
                    args=(ids, new_tokens, kw, q), daemon=True)
                # once started, generate() owns the ticket's release
                worker.start()
            except BaseException:
                if ticket is not None:
                    service.admission.release(ticket, completed=False)
                raise
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header(RID_HEADER, rid)
            self.end_headers()
            steps = 0
            first_ms = None
            # writes stop once the client is gone. Unlike the JAX server,
            # an expired deadline (which also sets `cancel`) still gets
            # its terminal error line and the chunked terminator
            gone = False
            while True:
                kind, payload = q.get()
                if kind in ("error", "result"):
                    final = ({"error": str(payload), "rid": rid}
                             if kind == "error"
                             else {"ids": payload.tolist(),
                                   "first_token_ms": first_ms,
                                   "steps": steps, "rid": rid})
                    if not gone:
                        try:
                            self._chunk(final)
                        except OSError:
                            gone = True
                            cancel.set()
                    break
                step, fenced = payload
                tok = _read_tokens(fenced)
                if first_ms is None:
                    first_ms = round((time.monotonic() - t0) * 1e3, 3)
                if not gone:
                    try:
                        self._chunk({"step": step, "tokens": tok})
                    except OSError:
                        # client went away: cancel the generation but keep
                        # draining the queue until the terminal line
                        gone = True
                        cancel.set()
                steps += 1
            if not gone:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass    # disconnect after the final line: nothing owed

        def _run_generate(self, ids, new_tokens, kw, q):
            try:
                out = service.generate(
                    ids, new_tokens,
                    on_token=lambda step, tok: q.put(
                        ("token", (step, _fence_tokens(tok)))),
                    **kw)
                q.put(("result", out))
            except BaseException as exc:   # noqa: BLE001 — surfaced as a
                q.put(("error", exc))      # terminal stream line

        def do_GET(self):
            if self.path == "/metrics":
                from .monitoring import facade
                extra = prom.render_monitoring_snapshot(facade.snapshot())
                body = prom.REGISTRY.render(extra=extra).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.split("?", 1)[0] == "/debug/spans":
                drain = "drain=0" not in self.path
                self._send(200,
                           fleet_obs.debug_spans_payload(drain=drain))
            elif self.path == "/healthz":
                dead = service.dead is not None
                deg = service.degraded_info
                degraded = False
                if deg is not None:
                    degraded = {"dead_rank": deg["dead_rank"],
                                "since_s": round(time.monotonic()
                                                 - deg["since"], 3),
                                "retry_after": deg["retry_after"],
                                "phase": deg.get("phase", "degraded")}
                self._send(503 if dead else 200,
                           {"ok": not dead, "model": model_name,
                            "stages": len(service.pipe.stages),
                            "speculative": service.spec is not None,
                            "executor": service.executor,
                            "degraded": degraded,
                            "draining": service.draining,
                            "serving": service.serving_stats(),
                            "flight": service.flight_stats(),
                            "peer_health": peer_health.snapshot(),
                            "stats": service.stats()})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            rid = None       # minted for /generate; names error bodies too
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/debug/dump":
                    path = service.dump_postmortem(rid=req.get("rid"))
                    self._send(200, {"path": path,
                                     "written_total":
                                     service.flight.written_total()})
                elif self.path == "/degraded":
                    # the failover orchestrator's switch:
                    # degraded -> healing -> healed lifecycle
                    if req.get("degraded", True):
                        if req.get("healing"):
                            service.mark_healing()
                        else:
                            ra = req.get("retry_after")
                            service.enter_degraded(
                                dead_rank=req.get("dead_rank"),
                                retry_after=(None if ra is None
                                             else float(ra)))
                    else:
                        service.exit_degraded(
                            healed=bool(req.get("healed")),
                            rank=req.get("rank"))
                    self._send(200, {"degraded":
                                     service.degraded_info is not None})
                elif self.path == "/prefix":
                    pid, plen = service.add_prefix(req["ids"])
                    self._send(200, {"prefix_id": pid, "len": plen})
                elif self.path == "/drain":
                    # the router's graceful drain (replica side): stop
                    # admitting, keep finishing; /healthz's stats.active
                    # reports the remaining in-flight work
                    service.begin_drain()
                    self._send(200, {"draining": True,
                                     "active": service.stats().get(
                                         "active", 0)})
                elif self.path == "/kv/export":
                    blob, plen, pages = service.kv_export(req["ids"])
                    self._send(200, {"blob": blob, "tokens_covered": plen,
                                     "pages": pages})
                elif self.path == "/kv/import":
                    pages = service.kv_import(req["ids"], req["blob"])
                    self._send(200, {"installed_pages": pages})
                elif self.path == "/generate":
                    ids = req["ids"]
                    if ids and not isinstance(ids[0], list):
                        ids = [ids]
                    request_class = req.get("class", "interactive")
                    if request_class not in REQUEST_CLASSES:
                        raise ValueError(
                            f"unknown request class {request_class!r} "
                            f"(expected one of {sorted(REQUEST_CLASSES)})")
                    deadline_s = None
                    if req.get("deadline_ms") is not None:
                        deadline_s = float(req["deadline_ms"]) / 1e3
                        if deadline_s <= 0:
                            raise ValueError("deadline_ms must be > 0")
                    rid = _header_rid(self.headers) or service.mint_rid()
                    if req.get("speculative"):
                        if req.get("temperature") or req.get("top_k") \
                                or req.get("eos_token") is not None \
                                or req.get("stream"):
                            raise ValueError(
                                "speculative generation is greedy-exact "
                                "whole-rounds; it does not compose with "
                                "sampling/eos/stream")
                        if not service.speculative_allowed():
                            # brownout rung 1: plain greedy instead
                            out = service.generate(
                                ids, int(req["new_tokens"]),
                                request_class=request_class,
                                deadline_s=deadline_s, rid=rid,
                                temperature=0.0, top_k=0, seed=0,
                                eos_token=None,
                                prefix_id=req.get("prefix_id"))
                        else:
                            out = service.generate_speculative(
                                ids, int(req["new_tokens"]),
                                prefix_id=req.get("prefix_id"),
                                request_class=request_class,
                                deadline_s=deadline_s, rid=rid)
                        self._send(200, {"ids": out.tolist(), "rid": rid},
                                   headers=_rid_headers(rid))
                    else:
                        kw = dict(
                            temperature=float(req.get("temperature", 0.0)),
                            top_k=int(req.get("top_k", 0)),
                            seed=int(req.get("seed", 0)),
                            eos_token=req.get("eos_token"),
                            prefix_id=req.get("prefix_id"))
                        if req.get("stream"):
                            self._stream_generate(
                                ids, int(req["new_tokens"]), kw,
                                request_class, deadline_s, rid=rid)
                        else:
                            out = service.generate(
                                ids, int(req["new_tokens"]),
                                request_class=request_class,
                                deadline_s=deadline_s, rid=rid, **kw)
                            self._send(200, {"ids": out.tolist(),
                                             "rid": rid},
                                       headers=_rid_headers(rid))
                else:
                    self._send(404, {"error": "unknown path"})
            except (KeyError, ValueError, TypeError, IndexError) as exc:
                self._send(400, {"error": str(exc)})
            except AdmissionShed as exc:
                # overload backpressure: the Retry-After is computed from
                # the observed service rate
                self._send(503, {"error": str(exc), "shed": True,
                                 "class": exc.request_class,
                                 "reason": exc.reason, "rid": rid},
                           headers=(("Retry-After",
                                     f"{exc.retry_after:g}"),)
                           + _rid_headers(rid))
            except DeadlineExceeded as exc:
                # expired while EXECUTING (no Retry-After: the same budget
                # would expire the same way)
                self._send(504, {"error": str(exc),
                                 "deadline_exceeded": True,
                                 "class": exc.request_class, "rid": rid},
                           headers=_rid_headers(rid))
            except ServiceDegraded as exc:
                self._send(503, {"error": str(exc),
                                 "degraded": True,
                                 "dead_rank": exc.dead_rank, "rid": rid},
                           headers=(("Retry-After",
                                     f"{exc.retry_after:g}"),)
                           + _rid_headers(rid))
            except RuntimeError as exc:
                # every 503 carries a Retry-After, even a dead worker's
                self._send(503, {"error": str(exc)},
                           headers=(("Retry-After",
                                     f"{service.retry_after_hint():g}"),))

    return Handler


def _parse_class_map(pairs, what, parser):
    """`interactive=2.5`-style repeated CLI pairs -> {class: float}."""
    try:
        out = parse_class_map(pairs, what)
    except ValueError as exc:
        parser.error(str(exc))
    return out or None


def _inject_stall(pipe, spec, parser):
    """`--inject-stall STAGE:MS`: wrap every callable of one pipeline
    stage with a fixed host sleep, a deterministic stall inside that
    stage's `exec{i}` span (tests only)."""
    import functools
    try:
        stage_s, ms_s = spec.split(":", 1)
        idx, delay_s = int(stage_s), float(ms_s) / 1e3
        st = pipe.stages[idx]
    except (ValueError, IndexError):
        parser.error(f"--inject-stall expects STAGE:MS with STAGE < "
                     f"{len(pipe.stages)}, got {spec!r}")
        return

    def slow(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            time.sleep(delay_s)
            return fn(*a, **kw)
        return wrapper

    for key, fn in list(st.items()):
        if callable(fn):
            st[key] = slow(fn)
    print(f"chaos: injecting {ms_s}ms stall into every step of stage "
          f"{idx}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model-name", default="gpt2",
                   choices=[n for n in registry.get_model_names()
                            if registry.get_model_config(n).model_type
                            in registry.DECODER_TYPES])
    p.add_argument("-M", "--model-file", default=None,
                   help="weights (.npz, HF state-dict keys of the family); "
                        "without it each stage draws seeded random weights")
    p.add_argument("-pt", "--partition", default=None)
    p.add_argument("--max-len", default=1024, type=int)
    p.add_argument("-t", "--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kv-bits", default=0, type=int, choices=[0, 8])
    p.add_argument("--attend-floor", default=64, type=int)
    p.add_argument("--int8-decode-attend", default=None,
                   choices=["0", "1", "2", "auto"],
                   help="int8-KV decode-attention kernel opt-in (needs "
                        "--kv-bits 8): 0 = dequantize route, 1/2/auto = "
                        "the kernel. Default: PIPEEDGE_INT8_DECODE_ATTEND, "
                        "else on (auto) when the int8 compute path is on")
    p.add_argument("--executor", default="wave", choices=["wave", "stage"],
                   help="wave: one thread ticks the batcher; stage: one "
                        "worker thread per pipeline stage (healthz reports "
                        "per-worker stats)")
    p.add_argument("--draft-model", default=None,
                   choices=[n for n in registry.get_model_names()
                            if registry.get_model_config(n).model_type
                            in registry.DECODER_TYPES],
                   help="enable speculative generation: requests with "
                        '"speculative": true run greedy draft/verify '
                        "rounds against this (smaller, same-vocabulary) "
                        "model, token-identical to plain greedy")
    p.add_argument("--gamma", default=4, type=int,
                   help="speculative draft lookahead per round")
    p.add_argument("--max-active", default=None, type=int)
    p.add_argument("--max-prefixes", default=8, type=int,
                   help="LRU bound on registered prompt prefixes (each "
                        "handle retains full max_len KV buffers; with "
                        "--kv-pages only the token lists are stored: the "
                        "prefix trie owns the KV)")
    p.add_argument("--port", default=8321, type=int)
    p.add_argument("--host", default="127.0.0.1")
    # -- overload protection --------------------------------------------
    p.add_argument("--no-admission", action="store_true",
                   help="disable the SLO-aware admission plane (deadlines "
                        "still propagate)")
    p.add_argument("--queue-capacity", default=64, type=int)
    p.add_argument("--class-rate", action="append", metavar="CLASS=RPS",
                   help="per-class sustained token-bucket admit rate "
                        "(repeatable; default: unlimited)")
    p.add_argument("--class-deadline", action="append",
                   metavar="CLASS=SECONDS",
                   help="per-class DEFAULT deadline budget for requests "
                        "without deadline_ms (repeatable)")
    p.add_argument("--no-brownout", action="store_true")
    p.add_argument("--brownout-queue-high", default=8, type=int)
    p.add_argument("--brownout-queue-low", default=1, type=int)
    p.add_argument("--brownout-p95-high", default=2.0, type=float)
    p.add_argument("--brownout-p95-low", default=0.5, type=float)
    p.add_argument("--brownout-dwell-up", default=0.5, type=float)
    p.add_argument("--brownout-dwell-down", default=2.0, type=float)
    p.add_argument("--brownout-clamp-tokens", default=16, type=int,
                   help="new_tokens clamp at brownout level >= 2")
    p.add_argument("--brownout-clamp-chunk", default=0, type=int,
                   metavar="TOKENS",
                   help="chunked-prefill chunk-size clamp at brownout "
                        "level >= 2 (0 = lever unarmed; only applies "
                        "with --chunked-prefill)")
    # -- paged KV plane ---------------------------------------------------
    p.add_argument("--kv-pages", default=0, type=int,
                   help="enable the paged KV plane: N fixed-size pages "
                        "per stage shared by every request (page tables "
                        "+ cross-request prefix trie); admission then "
                        "runs on a KV TOKEN budget of N x --kv-page-size "
                        "instead of max_active slots. 0 = dense "
                        "per-request cache slots")
    p.add_argument("--kv-page-size", default=16, type=int,
                   help="cache positions per KV page")
    p.add_argument("--chunked-prefill", default=0, type=int, metavar="N",
                   help="split prompt passes longer than N tokens into "
                        "N-token chunks interleaved with decode steps "
                        "at every executor step boundary (needs "
                        "--kv-pages). 0 = run-to-completion prefill")
    p.add_argument("--prefill-budget", default=None, type=int,
                   metavar="TOKENS",
                   help="prompt tokens the wave executor may start per "
                        "decode step when chunking (default: the chunk "
                        "size, one chunk per step)")
    p.add_argument("--step-join", action="store_true",
                   help="re-drive the admission queue at every decode-"
                        "step boundary, so queued requests join mid-"
                        "generation instead of at the next completion")
    p.add_argument("--disaggregate", default="off",
                   choices=["off", "local", "wire", "process"],
                   help="split serving into a prefill fleet and a decode "
                        "fleet (needs --kv-pages): prompt passes run on "
                        "a DEDICATED pipeline and ship finished KV pages "
                        "into the decode executor — 'local' hands the "
                        "tensors over in-process, 'wire' pushes real bytes "
                        "through the v2 codec + a loopback socket "
                        "(see --kv-ship-bits), 'process' spawns REAL "
                        "separate prefill worker processes over DCN "
                        "sockets with the fault-tolerant lease/ack ship "
                        "protocol (retry, re-dispatch, colocated "
                        "fallback)")
    p.add_argument("--prefill-ranks", default=1, type=int,
                   help="worker processes of --disaggregate process "
                        "(leases re-dispatch across them on faults)")
    p.add_argument("--prefill-lease-timeout", default=30.0, type=float,
                   help="seconds a dispatched prompt pass may go "
                        "unacked before it re-dispatches")
    p.add_argument("--prefill-attempts", default=3, type=int,
                   help="total lease dispatches per prompt before the "
                        "request degrades to colocated prefill")
    p.add_argument("--no-prefill-respawn", action="store_true",
                   help="do not respawn dead prefill workers (default: "
                        "respawn with DCN_EPOCH+1 and readmit via JOIN)")
    p.add_argument("--prefill-heartbeat-interval", default=1.0,
                   type=float,
                   help="ship-plane heartbeat interval (0 disables; "
                        "catches hung workers whose sockets stay open)")
    p.add_argument("--kv-ship-bits", default=0, type=int, choices=[0, 8],
                   help="quantize shipped KV pages on the wire (the "
                        "codec's 8-bit quads, 4x fewer bytes; 0 = exact, "
                        "the token-parity setting)")
    p.add_argument("--prefill-concurrency", default=2, type=int,
                   help="in-flight prompt passes the prefill fleet runs "
                        "concurrently")
    p.add_argument("--governor-interval", default=0.25, type=float)
    p.add_argument("--trace-spans", default=None, metavar="OUT",
                   help="write the request/stage spans as Perfetto-"
                        "loadable trace JSON to OUT on shutdown")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="directory for flight-recorder postmortem bundles "
                        "(default: env PIPEEDGE_POSTMORTEM_DIR or "
                        "./postmortems)")
    p.add_argument("--slo-objective", default=0.99, type=float)
    p.add_argument("--slo-burn-fast", default=30.0, type=float,
                   metavar="S")
    p.add_argument("--slo-burn-slow", default=300.0, type=float,
                   metavar="S")
    p.add_argument("--slo-burn-threshold", default=10.0, type=float)
    p.add_argument("--inject-stall", default=None, metavar="STAGE:MS",
                   help="chaos hook (tests only): sleep MS ms inside every "
                        "step of pipeline stage STAGE")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their "
                        "plain versions")
    # -- routed decode fleet -----------------------------------------------
    p.add_argument("--role", default="single",
                   choices=["single", "router", "replica"],
                   help="single: one decode process serving directly; "
                        "router: a model-free front end that health-checks "
                        "and routes across N decode replicas (spawned and "
                        "supervised, or external via --replica-addrs); "
                        "replica: a decode process behind a router (the "
                        "single surface plus drain/migration)")
    p.add_argument("--replicas", default=2, type=int,
                   help="decode replica processes the router spawns and "
                        "supervises (ignored with --replica-addrs)")
    p.add_argument("--replica-addrs", default=None,
                   metavar="HOST:PORT,...",
                   help="route across EXTERNAL replicas at these addresses "
                        "instead of spawning any (no respawn supervision)")
    p.add_argument("--no-replica-respawn", action="store_true",
                   help="do not respawn dead decode replicas (default: "
                        "respawn with crash-loop backoff + epoch bump and "
                        "readmit after clean health polls)")
    p.add_argument("--router-poll-interval", default=0.5, type=float,
                   help="seconds between /healthz polls per replica")
    p.add_argument("--router-health-timeout", default=2.0, type=float,
                   help="health-poll timeout; a slow poll scores as "
                        "degraded, a failed one as a miss")
    p.add_argument("--route-timeout", default=120.0, type=float,
                   help="per-attempt request timeout at the router")
    p.add_argument("--route-retries", default=2, type=int,
                   help="re-route attempts to a DIFFERENT replica after a "
                        "connect failure or mid-stream death")
    p.add_argument("--hedge-ms", default=0.0, type=float,
                   help="tail hedging for non-streaming interactive "
                        "requests: if the primary replica has not answered "
                        "within this many ms, race a second replica and "
                        "keep the first answer (0 = off)")
    p.add_argument("--drain-timeout", default=60.0, type=float,
                   help="seconds POST /drain waits for a replica's "
                        "in-flight requests before migrating its prefix "
                        "pages anyway")
    p.add_argument("--fleet-scrape-interval", default=1.0, type=float,
                   metavar="S",
                   help="(router) period of the fleet collector's "
                        "/metrics scrape across replicas: feeds GET "
                        "/fleet and the SLO burn-rate engine (<= 0 "
                        "disables; /fleet then 503s)")
    p.add_argument("--fleet-history", default=120, type=int,
                   help="(router) scrape samples retained per target "
                        "(the /fleet rate window is bounded by "
                        "history * scrape interval)")
    # -- closed-loop capacity ---------------------------------------------
    p.add_argument("--autoscale", default="off",
                   choices=["off", "advise", "auto"],
                   help="(router) closed-loop capacity control over the "
                        "supervised replica fleet: scale-out spawns a "
                        "replica with the next epoch (warm-up gated "
                        "before it takes traffic), scale-in drains + "
                        "migrates KV prefixes then retires the process. "
                        "advise = run the identical decision loop but "
                        "only log (the A/B control arm); auto = act")
    p.add_argument("--autoscale-min", default=1, type=int,
                   help="replica floor the autoscaler never drains below")
    p.add_argument("--autoscale-max", default=2, type=int,
                   help="replica ceiling it never spawns above")
    p.add_argument("--autoscale-confirm", default=3, type=int,
                   help="consecutive same-direction observation windows "
                        "before a decision is eligible (one hot scrape "
                        "moves nothing)")
    p.add_argument("--autoscale-cooldown", default=10.0, type=float,
                   metavar="S",
                   help="seconds between decisions; each direction "
                        "REVERSAL doubles the effective cooldown "
                        "(flap damper, capped at 8x)")
    p.add_argument("--autoscale-interval", default=1.0, type=float,
                   metavar="S", help="governor tick period")
    p.add_argument("--autoscale-dwell-up", default=0.0, type=float,
                   metavar="S",
                   help="seconds up-pressure must persist before "
                        "scale-out (on top of --autoscale-confirm)")
    p.add_argument("--autoscale-dwell-down", default=5.0, type=float,
                   metavar="S",
                   help="seconds calm must persist before scale-in")
    p.add_argument("--autoscale-queue-high", default=4.0, type=float,
                   help="summed admission queue depth PER REPLICA that "
                        "counts as up pressure")
    p.add_argument("--autoscale-queue-low", default=0.5, type=float,
                   help="per-replica queue depth below which the fleet "
                        "counts as calm (dead band against queue-high)")
    p.add_argument("--autoscale-burn-high", default=1.0, type=float,
                   help="short-window SLO burn rate that counts as up "
                        "pressure")
    p.add_argument("--autoscale-burn-low", default=0.25, type=float,
                   help="burn rate below which the fleet counts as calm")
    for flag, (kw, item) in REFUSED.items():
        p.add_argument(flag, default=argparse.SUPPRESS,
                       help=f"not ported yet (ROADMAP {item})", **kw)
    return p


def parse_args(argv: Optional[Sequence[str]] = None):
    p = build_parser()
    args = p.parse_args(argv)
    for flag, (_, item) in REFUSED.items():
        if hasattr(args, flag.lstrip("-").replace("-", "_")):
            p.error(f"{flag} is not ported to pipeedge_tpu_torch yet "
                    f"(ROADMAP {item})")
    # the JAX server's composition checks, before any model build
    if args.disaggregate != "off" and not args.kv_pages:
        p.error("--disaggregate needs --kv-pages (shipped KV lands in "
                "the paged pool)")
    if args.chunked_prefill < 0:
        p.error("--chunked-prefill must be >= 0")
    if args.chunked_prefill and not args.kv_pages:
        p.error("--chunked-prefill needs --kv-pages (chunk waves write "
                "prompt spans at an offset into the request's page "
                "table; dense cache slots have no span-at-offset path)")
    if args.prefill_budget is not None and not args.chunked_prefill:
        p.error("--prefill-budget only applies with --chunked-prefill")
    if args.prefill_budget is not None and args.prefill_budget < 1:
        p.error("--prefill-budget must be >= 1")
    if args.draft_model and args.kv_bits:
        p.error("--draft-model does not compose with --kv-bits (int8 "
                "span verification is not bit-identical to serial "
                "int8 steps)")
    if args.role == "router":
        if args.disaggregate != "off":
            p.error("--role router does not compose with --disaggregate "
                    "yet (run disaggregation inside each replica is a "
                    "scoped follow-up; see docs/SERVING.md)")
        if args.replica_addrs is None and args.replicas < 1:
            p.error("--replicas must be >= 1 (or pass --replica-addrs)")
        if args.hedge_ms < 0:
            p.error("--hedge-ms must be >= 0")
        if args.route_retries < 0:
            p.error("--route-retries must be >= 0")
        if args.autoscale != "off":
            if args.replica_addrs is not None:
                p.error("--autoscale needs a SUPERVISED fleet (it "
                        "spawns and retires replica processes); "
                        "--replica-addrs fleets are the operator's "
                        "lifecycle")
            if args.fleet_scrape_interval <= 0:
                p.error("--autoscale needs the fleet collector "
                        "(--fleet-scrape-interval > 0) — its scrape is "
                        "the controller's signal plane")
            if not 1 <= args.autoscale_min <= args.autoscale_max:
                p.error("need 1 <= --autoscale-min <= --autoscale-max")
            if args.autoscale_confirm < 1:
                p.error("--autoscale-confirm must be >= 1")
            if args.autoscale_interval <= 0:
                p.error("--autoscale-interval must be > 0")
    elif args.replica_addrs is not None:
        p.error("--replica-addrs only applies with --role router")
    elif args.autoscale != "off":
        p.error("--autoscale only applies with --role router (runtime "
                "--rounds fleets get the pipeline-level half via "
                "runtime.py --autoscale-ranks)")
    if args.partition:
        nums = [int(x) for x in args.partition.split(",")]
        if len(nums) % 2:
            p.error(f"-pt needs an even count of layer bounds: {nums}")
        args.partition = list(zip(nums[::2], nums[1::2]))
    args.class_rate = _parse_class_map(args.class_rate, "--class-rate", p)
    args.class_deadline = _parse_class_map(args.class_deadline,
                                           "--class-deadline", p)
    return args


def build_pipeline(args, stage_params=None):
    """The decode pipeline the flags describe (`stage_params`: already
    loaded per-stage params to share, e.g. between two configurations)."""
    return build_decode_pipeline(
        args.model_name, args.partition, max_len=args.max_len,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        cache_bits=args.kv_bits, attend_floor=args.attend_floor,
        model_file=args.model_file, stage_params=stage_params,
        device=args.device, int8_decode_attend=args.int8_decode_attend)


def build_draft_pipeline(args, stage_params=None):
    """The `--draft-model` pipeline: one stage, the target's max_len,
    dtype and attend floor, an fp cache; None without a draft model."""
    if not args.draft_model:
        return None
    return build_decode_pipeline(
        args.draft_model, None, max_len=args.max_len,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        attend_floor=args.attend_floor, stage_params=stage_params,
        device=args.device)


def make_service(args, pipe, draft=None, prefill_fleet=None,
                 prefill_supervisor=None) -> _Service:
    """The `_Service` the flags describe, over `pipe` (and, with
    `--draft-model`, over `draft`, built from the flags when not given;
    with `--disaggregate`, over the prefill fleet `build_prefill_fleet`
    made)."""
    if args.inject_stall:
        _inject_stall(pipe, args.inject_stall, build_parser())
    spec = None
    if args.draft_model:
        if draft is None:
            draft = build_draft_pipeline(args)
        spec = SpeculativeDecoder(pipe, draft, gamma=args.gamma)
    return _Service(pipe, max_active=args.max_active,
                    max_prefixes=args.max_prefixes, spec=spec,
                    executor=args.executor,
                    edge_itemsize=2 if args.dtype == "bfloat16" else 4,
                    admission_enabled=not args.no_admission,
                    queue_capacity=args.queue_capacity,
                    class_rates=args.class_rate,
                    class_deadlines_s=args.class_deadline,
                    brownout_enabled=not args.no_brownout,
                    brownout_marks=Watermarks(
                        queue_high=args.brownout_queue_high,
                        queue_low=args.brownout_queue_low,
                        p95_high_s=args.brownout_p95_high,
                        p95_low_s=args.brownout_p95_low,
                        dwell_up_s=args.brownout_dwell_up,
                        dwell_down_s=args.brownout_dwell_down),
                    clamp_new_tokens=args.brownout_clamp_tokens,
                    governor_interval=args.governor_interval,
                    postmortem_dir=args.postmortem_dir,
                    kv_pages=args.kv_pages,
                    kv_page_size=args.kv_page_size,
                    chunked_prefill=args.chunked_prefill,
                    step_join=args.step_join,
                    prefill_budget=args.prefill_budget,
                    clamp_chunk_tokens=args.brownout_clamp_chunk,
                    slo_objective=args.slo_objective,
                    slo_burn_fast=args.slo_burn_fast,
                    slo_burn_slow=args.slo_burn_slow,
                    slo_burn_threshold=args.slo_burn_threshold,
                    prefill_fleet=prefill_fleet,
                    prefill_supervisor=prefill_supervisor)


def build_prefill_fleet(args, pipe):
    """`--disaggregate`'s prefill fleet over the decode pipeline `pipe`:
    `(fleet, supervisor, ship_ctx)`, all None when off.

    `local`/`wire`: a `PrefillFleet` over a DEDICATED fp-cache pipeline
    that shares `pipe`'s loaded weights (one copy on the card). `process`:
    `--prefill-ranks` worker processes (ranks 1..N of a DCN world whose
    rank 0 is this process), supervised and respawned, behind a
    `RemotePrefillFleet` that decodes shipped handles on `pipe`'s
    device."""
    if args.disaggregate == "off":
        return None, None, None
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.disaggregate != "process":
        # its prompt passes never contend with the decode executor's
        # stage-steps for one pipeline's caches
        prefill_pipe = build_decode_pipeline(
            args.model_name, args.partition, max_len=args.max_len,
            dtype=dtype, attend_floor=args.attend_floor,
            stage_params=[st["params"] for st in pipe.stages],
            device=pipe.device)
        return PrefillFleet(prefill_pipe, path=args.disaggregate,
                            ship_bits=args.kv_ship_bits,
                            max_concurrent=args.prefill_concurrency), \
            None, None
    from .comm import dcn
    world = 1 + args.prefill_ranks
    addrs = [(args.host, port) for port in _free_ports(world, args.host)]
    worker_cmd = [
        str(world), "--dcn-addrs",
        ",".join(f"{h}:{port}" for h, port in addrs),
        "-m", args.model_name, "--max-len", str(args.max_len),
        "-t", args.dtype, "--attend-floor", str(args.attend_floor),
        "--heartbeat-interval", str(args.prefill_heartbeat_interval),
        "--device", pipe.device.type]
    if args.partition:
        worker_cmd += ["-pt", ",".join(f"{l},{r}"
                                       for l, r in args.partition)]
    if args.model_file:
        worker_cmd += ["-M", os.path.abspath(args.model_file)]
    # per-worker observability listeners (GET /metrics, /healthz,
    # /debug/spans): /healthz names each worker's http_url
    pf_http = dict(zip(range(1, world),
                       _free_ports(args.prefill_ranks, args.host)))
    supervisor = PrefillWorkerSupervisor(
        worker_cmd, ranks=range(1, world),
        respawn=not args.no_prefill_respawn, http_ports=pf_http)
    ship_ctx = dcn.DistDcnContext(world, 0, addrs)
    try:
        ship_ctx.init()
        supervisor.wait_ready(timeout=600.0)
        fleet = RemotePrefillFleet(
            ship_ctx, ranks=range(1, world), dtype=dtype,
            ship_bits=args.kv_ship_bits,
            lease_timeout_s=args.prefill_lease_timeout,
            max_attempts=args.prefill_attempts,
            max_concurrent=max(1, args.prefill_concurrency),
            heartbeat_interval=args.prefill_heartbeat_interval,
            device=pipe.device)
    except BaseException:
        supervisor.stop()
        ship_ctx.shutdown()
        raise
    return fleet, supervisor, ship_ctx


class WorkerSupervisor:
    """Spawns and supervises a fleet of child worker PROCESSES: respawn on
    death with crash-loop backoff and an epoch bump per incarnation (env
    `DCN_EPOCH`). Subclasses name the fleet (`LABEL`/`TAG`) and give the
    per-rank argv and ready-line contract: `PrefillWorkerSupervisor` runs
    the prefill fleet of `--disaggregate process`, `ReplicaSupervisor`
    the decode replicas of `--role router`. Port of the JAX server's
    supervisor base."""

    LABEL = "worker"       # log name ("prefill worker rank 1 died")
    TAG = "worker"         # stdout tee prefix ("[worker r1] ...")

    RESPAWN_DELAY_S = 0.5
    RESPAWN_BACKOFF_MAX_S = 30.0
    FAST_DEATH_S = 5.0     # an incarnation dying this fast escalates

    def __init__(self, ranks, respawn=True):
        self.ranks = tuple(ranks)
        self.respawn = bool(respawn)
        self._procs = {}                  # rank -> Popen
        self._epoch = {r: 0 for r in self.ranks}
        self._ready = {r: threading.Event() for r in self.ranks}
        # crash-loop protection: a worker that dies FAST (startup
        # failure) doubles its respawn delay up to the cap; an
        # incarnation that lived a while resets the backoff
        self._backoff = {r: self.RESPAWN_DELAY_S for r in self.ranks}
        self._spawned_at = {r: 0.0 for r in self.ranks}
        self._respawn_after = {r: 0.0 for r in self.ranks}
        # ranks retired by the autoscaler: their epoch records are
        # retained so a later add_rank continues the sequence (+1) and
        # the rejoin stays fenced against every dead incarnation
        self._retired = set()
        self._stop = threading.Event()
        self._lock = make_lock(f"serve.{self.TAG}_sup")
        self._watchers = []
        for r in self.ranks:
            self._spawn(r)
        self._supervisor = threading.Thread(target=self._watch_loop,
                                            daemon=True,
                                            name=f"{self.TAG}-supervisor")
        self._supervisor.start()

    # -- the per-fleet contract (subclasses) -----------------------------

    def _argv(self, rank):
        raise NotImplementedError

    def _env(self, rank):
        env = dict(os.environ)
        # every incarnation carries its epoch: a respawned worker's
        # JOIN/readmission is fenced against its dead predecessor
        env["DCN_EPOCH"] = str(self._epoch[rank])
        # the package's own checkout first, wherever the server runs from
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        return env

    def _is_ready(self, rank, line):
        raise NotImplementedError

    def _on_add_rank(self, rank):
        """Subclass hook: provision per-rank resources (a port) BEFORE the
        new rank's first spawn."""

    # -- lifecycle -------------------------------------------------------

    def _spawn(self, rank):
        proc = subprocess.Popen(
            self._argv(rank), env=self._env(rank), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        with self._lock:
            # stop() may have swept _procs while this Popen was in
            # flight: a spawn the shutdown can no longer see is ended
            # here, not leaked
            if self._stop.is_set():
                proc.terminate()
                return
            self._procs[rank] = proc
            self._spawned_at[rank] = time.monotonic()
        t = threading.Thread(target=self._pump, args=(rank, proc),
                             daemon=True, name=f"{self.TAG}-out-r{rank}")
        t.start()
        # pump threads exit when their worker's stdout closes: prune the
        # finished ones so a long-lived server keeps no record per respawn
        self._watchers = [w for w in self._watchers if w.is_alive()]
        self._watchers.append(t)
        print(f"{self.LABEL} rank {rank} spawned "
              f"(pid={proc.pid}, epoch={self._epoch[rank]})", flush=True)

    def _pump(self, rank, proc):
        # tee the worker's output through this process's stdout, prefixed:
        # the chaos harness keys on the workers' ready and exit lines
        for line in proc.stdout:
            print(f"[{self.TAG} r{rank}] {line}", end="", flush=True)
            if self._is_ready(rank, line):
                self._ready[rank].set()

    def _watch_loop(self):
        dead_pending = set()       # deaths observed, respawn not yet due
        while not self._stop.wait(self.RESPAWN_DELAY_S):
            now = time.monotonic()
            for rank in self.ranks:
                with self._lock:
                    proc = self._procs.get(rank)
                if proc is None or proc.poll() is None:
                    continue
                if rank not in dead_pending:
                    # observe the death ONCE: escalate the backoff only
                    # for fast deaths (crash loop), reset otherwise
                    lived = now - self._spawned_at[rank]
                    if lived < self.FAST_DEATH_S:
                        self._backoff[rank] = min(
                            self.RESPAWN_BACKOFF_MAX_S,
                            self._backoff[rank] * 2)
                    else:
                        self._backoff[rank] = self.RESPAWN_DELAY_S
                    self._respawn_after[rank] = now + self._backoff[rank]
                    dead_pending.add(rank)
                    print(f"{self.LABEL} rank {rank} died "
                          f"(rc={proc.returncode}; respawn backoff "
                          f"{self._backoff[rank]:g}s)", flush=True)
                    if not self.respawn:
                        with self._lock:
                            self._procs.pop(rank, None)
                        continue
                if not self.respawn or self._stop.is_set() \
                        or now < self._respawn_after[rank]:
                    continue
                dead_pending.discard(rank)
                self._ready[rank].clear()
                self._epoch[rank] += 1
                self._spawn(rank)

    def wait_ready(self, timeout=180.0):
        deadline = time.monotonic() + timeout
        for rank in self.ranks:
            if not self._ready[rank].wait(
                    max(0.0, deadline - time.monotonic())):
                raise RuntimeError(
                    f"{self.LABEL} rank {rank} never became ready "
                    f"within {timeout}s")

    def restart(self, rank):
        """Planned restart (the router's drain endgame): terminate the
        incarnation; the watch loop respawns it with the next epoch, the
        path an unplanned death takes."""
        with self._lock:
            proc = self._procs.get(rank)
        if proc is not None and proc.poll() is None:
            proc.terminate()

    # -- autoscale membership ----------------------------------------------

    def add_rank(self, rank=None):
        """Autoscale scale-out: bring a new rank into the supervised set,
        preferring the lowest retired rank id. A resurrected rank
        continues its epoch sequence (+1), so its join is fenced against
        every dead incarnation exactly like a respawn; a brand-new rank
        starts at epoch 0. Returns the rank spawned."""
        with self._lock:
            if rank is None:
                spare = sorted(self._retired)
                rank = spare[0] if spare else \
                    (max(self._epoch) + 1 if self._epoch else 0)
            if rank in self.ranks:
                raise ValueError(f"rank {rank} is already active")
            self._retired.discard(rank)
            if rank in self._epoch:
                self._epoch[rank] += 1
            else:
                self._epoch[rank] = 0
            self._ready[rank] = threading.Event()
            self._backoff[rank] = self.RESPAWN_DELAY_S
            self._spawned_at[rank] = 0.0
            self._respawn_after[rank] = 0.0
            self._on_add_rank(rank)
            self.ranks = tuple(list(self.ranks) + [rank])
        self._spawn(rank)
        return rank

    def retire_rank(self, rank):
        """Autoscale scale-in endgame: take `rank` out of the supervised
        set WITHOUT respawn and terminate its incarnation. The proc
        record is popped under the lock BEFORE the terminate, so the
        watch loop can never observe the death and resurrect it (a
        retired rank leaves `snapshot()`). Epoch records are retained
        (see add_rank)."""
        with self._lock:
            if rank not in self.ranks:
                return False
            self.ranks = tuple(r for r in self.ranks if r != rank)
            proc = self._procs.pop(rank, None)
            self._ready[rank].clear()
            self._retired.add(rank)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        print(f"{self.LABEL} rank {rank} retired "
              f"(epoch={self._epoch[rank]})", flush=True)
        return True

    def pid_of(self, rank):
        with self._lock:
            proc = self._procs.get(rank)
        return None if proc is None else proc.pid

    def snapshot(self):
        with self._lock:
            return {str(r): {"pid": p.pid, "epoch": self._epoch[r],
                             "alive": p.poll() is None}
                    for r, p in self._procs.items()}

    def stop(self):
        self._stop.set()
        self._supervisor.join(timeout=5)
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        # the workers' last lines (their kernel_launches=) reach this
        # process's stdout before it goes on to exit
        for t in self._watchers:
            t.join(timeout=5)


class PrefillWorkerSupervisor(WorkerSupervisor):
    """The prefill fleet of `--disaggregate process` (`python -m
    pipeedge_tpu_torch.prefill_worker` ranks 1..N of the ship plane's DCN
    world). A worker that dies (crash, OOM, chaos kill) is respawned with
    `DCN_EPOCH` incremented, so its JOIN clears the decode side's death
    fence and the fleet readmits it. Chaos: `PIPEEDGE_PREFILL_CHAOS` (a
    `DCN_CHAOS` spec) arms deterministic faults in ONE worker's env
    (`PIPEEDGE_PREFILL_CHAOS_RANK`, default 1) for the first incarnation
    only: respawns come up clean, as with the restart@K:MS contract."""

    LABEL = "prefill worker"
    TAG = "prefill"

    def __init__(self, worker_cmd, ranks, respawn=True, http_ports=None):
        self._cmd = list(worker_cmd)      # after the rank, per rank
        # rank -> observability HTTP port (each worker serves /metrics +
        # /debug/spans there, so the fleet collector and trace_report
        # --fleet reach prefill processes too)
        self._http_ports = dict(http_ports or {})
        super().__init__(ranks, respawn=respawn)

    def _argv(self, rank):
        argv = [sys.executable, "-m", "pipeedge_tpu_torch.prefill_worker",
                str(rank)] + self._cmd
        port = self._http_ports.get(rank)
        if port:
            argv += ["--http-port", str(port)]
        return argv

    def snapshot(self):
        out = super().snapshot()
        for rank, port in self._http_ports.items():
            rec = out.get(str(rank))
            if rec is not None:
                rec["http_url"] = f"http://127.0.0.1:{port}"
        return out

    def _env(self, rank):
        env = super()._env(rank)
        chaos = os.getenv("PIPEEDGE_PREFILL_CHAOS")
        chaos_rank = int(os.getenv("PIPEEDGE_PREFILL_CHAOS_RANK", "1"))
        if chaos and rank == chaos_rank and self._epoch[rank] == 0:
            env["DCN_CHAOS"] = chaos
        return env

    def _is_ready(self, rank, line):
        # the exact machine line only: a bare substring ("ready") would
        # also match a model-build warning and release wait_ready early
        return line.startswith(f"prefill worker rank {rank} ready")


class ReplicaSupervisor(WorkerSupervisor):
    """The decode replicas behind `--role router`: each rank is a full
    `python -m pipeedge_tpu_torch.serve --role replica` process on its
    own port. A dead replica respawns with the next epoch after a
    crash-loop backoff, and the router's health polls readmit it once it
    proves itself. `restart(rank)` is the drain endgame;
    `add_rank`/`retire_rank` are the autoscaler's actuators."""

    LABEL = "decode replica"
    TAG = "replica"

    def __init__(self, base_cmd, host, ports, respawn=True):
        self._base_cmd = list(base_cmd)
        self._host = host
        self._ports = list(ports)
        super().__init__(range(len(self._ports)), respawn=respawn)

    def _argv(self, rank):
        return [sys.executable, "-m", "pipeedge_tpu_torch.serve"] \
            + self._base_cmd + ["--host", self._host,
                                "--port", str(self._ports[rank])]

    def _is_ready(self, rank, line):
        # the replica's own "serving ... on HOST:PORT" line
        return (line.startswith("serving ")
                and f" on {self._host}:{self._ports[rank]}" in line)

    def _on_add_rank(self, rank):
        # a resurrected rank reuses its old port (the listener is gone:
        # nothing holds it); a brand-new rank gets a fresh one
        while len(self._ports) <= rank:
            self._ports += _free_ports(1, self._host)

    def url_of(self, rank):
        return f"http://{self._host}:{self._ports[rank]}"


def _exit_once(*_):
    """SIGTERM handler: unwind through the caller's finally (exit 0); a
    second SIGTERM during that shutdown is ignored."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    sys.exit(0)


def _free_ports(n, host="127.0.0.1"):
    import socket as socket_mod
    socks = [socket_mod.create_server((host, 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def make_router_handler(router, model_name, collector=None,
                        autoscaler=None):
    """HTTP surface of `--role router`: the endpoint shapes one replica
    serves (clients need no change), backed by the `DecodeRouter`.
    `collector` (a `FleetCollector`) backs GET /fleet, the one aggregated
    scrape surface across router and replicas; `autoscaler` (an
    `AutoscaleRunner`) adds the capacity controller's snapshot to
    /healthz and /fleet."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"      # chunked transfer needs 1.1

        def log_message(self, *a):      # quiet server
            pass

        def _send(self, code, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, obj):
            data = json.dumps(obj).encode() + b"\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/metrics":
                body = prom.REGISTRY.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/fleet":
                if collector is None:
                    self._send(503, {"error": "fleet collector disabled "
                                              "(--fleet-scrape-interval "
                                              "0)"},
                               headers=(("Retry-After", "5"),))
                else:
                    snap = collector.fleet_snapshot()
                    if autoscaler is not None:
                        snap["autoscale"] = \
                            autoscaler.controller.snapshot()
                    self._send(200, snap)
            elif self.path.split("?", 1)[0] == "/debug/spans":
                drain = "drain=0" not in self.path
                self._send(200,
                           fleet_obs.debug_spans_payload(drain=drain))
            elif self.path == "/healthz":
                code, body = router.healthz()
                body["model"] = model_name
                if autoscaler is not None:
                    body["autoscale"] = \
                        autoscaler.controller.snapshot()
                headers = ((("Retry-After", "1"),) if code == 503
                           else ())
                self._send(code, body, headers=headers)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/generate":
                    if req.get("stream"):
                        self._stream(req)
                        return
                    status, body, headers = router.dispatch(req)
                    self._send(status, body, headers=headers)
                elif self.path == "/prefix":
                    pid, plen = router.register_prefix(req["ids"])
                    self._send(200, {"prefix_id": pid, "len": plen})
                elif self.path == "/drain":
                    out = router.drain_replica(
                        req["replica"],
                        migrate=bool(req.get("migrate", True)))
                    self._send(200 if out.get("drained") else 409, out)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, TypeError, IndexError) as exc:
                self._send(400, {"error": str(exc)})
            except RuntimeError as exc:
                self._send(503, {"error": str(exc)},
                           headers=(("Retry-After", "1"),))

        def _stream(self, req):
            """Relay a streaming generation: the router's generator owns
            failover; this method only moves lines to the socket."""
            streaming = False
            it = router.stream(req)
            for item in it:
                if item[0] == "status":
                    _, code, headers = item
                    if code == 200:
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/x-ndjson")
                        self.send_header("Transfer-Encoding", "chunked")
                        for name, value in headers:
                            self.send_header(name, value)
                        self.end_headers()
                        streaming = True
                    else:
                        nxt = next(it, None)
                        body = (nxt[1] if nxt is not None
                                and nxt[0] == "line" else {})
                        self._send(code, body, headers=headers)
                        return
                else:
                    try:
                        self._chunk(item[1])
                    except OSError:
                        # the client went away: closing the generator
                        # tears down the upstream replica connection too
                        it.close()
                        return
            if streaming:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass

    return Handler


def replica_command(args) -> list:
    """The `--role replica` flags of a spawned replica: the router's own
    serving flags, passed through."""
    cmd = ["--role", "replica", "-m", args.model_name,
           "--max-len", str(args.max_len), "-t", args.dtype,
           "--kv-bits", str(args.kv_bits),
           "--attend-floor", str(args.attend_floor),
           "--executor", args.executor,
           "--max-prefixes", str(args.max_prefixes),
           "--queue-capacity", str(args.queue_capacity),
           "--kv-pages", str(args.kv_pages),
           "--kv-page-size", str(args.kv_page_size),
           "--chunked-prefill", str(args.chunked_prefill),
           "--governor-interval", str(args.governor_interval),
           "--brownout-queue-high", str(args.brownout_queue_high),
           "--brownout-queue-low", str(args.brownout_queue_low),
           "--brownout-p95-high", str(args.brownout_p95_high),
           "--brownout-p95-low", str(args.brownout_p95_low),
           "--brownout-dwell-up", str(args.brownout_dwell_up),
           "--brownout-dwell-down", str(args.brownout_dwell_down),
           "--brownout-clamp-tokens", str(args.brownout_clamp_tokens),
           "--brownout-clamp-chunk", str(args.brownout_clamp_chunk),
           "--slo-objective", str(args.slo_objective),
           "--slo-burn-fast", str(args.slo_burn_fast),
           "--slo-burn-slow", str(args.slo_burn_slow),
           "--slo-burn-threshold", str(args.slo_burn_threshold),
           "--device", args.device]
    partition = (",".join(f"{l},{r}" for l, r in args.partition)
                 if args.partition else None)
    optional = (("-pt", partition), ("-M", args.model_file),
                ("--max-active", args.max_active),
                ("--prefill-budget", args.prefill_budget),
                ("--int8-decode-attend", args.int8_decode_attend),
                ("--postmortem-dir", args.postmortem_dir),
                ("--inject-stall", args.inject_stall))
    for flag, value in optional:
        if value is not None:
            cmd += [flag, str(value)]
    for flag, on in (("--step-join", args.step_join),
                     ("--no-admission", args.no_admission),
                     ("--no-brownout", args.no_brownout)):
        if on:
            cmd.append(flag)
    if args.draft_model:
        cmd += ["--draft-model", args.draft_model, "--gamma", str(args.gamma)]
    for flag, rates in (("--class-rate", args.class_rate),
                        ("--class-deadline", args.class_deadline)):
        for cls, value in (rates or {}).items():
            cmd += [flag, f"{cls}={value}"]
    return cmd


def _fleet_collector(args, router, router_flight):
    """The router's fleet collector: scrapes every replica's /metrics
    into GET /fleet, and feeds a burn-rate engine whose fast-window
    breach dumps an `slo_burn` postmortem of the router. None when
    `--fleet-scrape-interval <= 0`."""
    if args.fleet_scrape_interval <= 0:
        return None

    def _on_breach(cls, burn):
        router_flight.note("slo_burn_breach", rid=None,
                           request_class=cls, burn=round(burn, 3))
        router_flight.maybe_dump(
            "slo_burn",
            context={"class": cls, "burn_rate": round(burn, 4),
                     "window": "short",
                     "objective": args.slo_objective,
                     "threshold": args.slo_burn_threshold,
                     "fleet": router.registry.snapshot()})

    burn = fleet_obs.BurnRateEngine(
        objective=args.slo_objective,
        fast_window_s=args.slo_burn_fast,
        slow_window_s=args.slo_burn_slow,
        threshold=args.slo_burn_threshold,
        on_breach=_on_breach)
    return fleet_obs.FleetCollector(
        router.scrape_targets,
        interval_s=args.fleet_scrape_interval,
        history=args.fleet_history,
        burn=burn)


def _autoscaler(args, router, supervisor, collector):
    """The closed capacity loop (`serving/autoscale.py`): its signals come
    from the fleet collector's aggregated scrape, its actuators are the
    supervisor (spawn with the next epoch) and the router's drain without
    respawn. Advise mode runs the same loop but only logs. None when
    `--autoscale off`."""
    if args.autoscale == "off":
        return None
    from .serving import autoscale as autoscale_mod
    apol = autoscale_mod.CapacityPolicy(
        min_size=args.autoscale_min,
        max_size=args.autoscale_max,
        confirm=args.autoscale_confirm,
        cooldown_s=args.autoscale_cooldown,
        dwell_up_s=args.autoscale_dwell_up,
        dwell_down_s=args.autoscale_dwell_down,
        queue_high=args.autoscale_queue_high,
        queue_low=args.autoscale_queue_low,
        burn_high=args.autoscale_burn_high,
        burn_low=args.autoscale_burn_low)

    def _fleet_size():
        return len(router.registry.names())

    def _plan_capacity(direction, cur, target):
        # the dry-run: an un-runnable move renders as `held`
        if supervisor is None:
            return {"ok": False,
                    "reason": "static fleet (--replica-addrs)"}
        if direction == "up":
            return {"ok": True, "direction": "up", "to": target}
        snap = router.registry.snapshot()
        healthy = [n for n, rec in snap.items()
                   if rec["state"] == "healthy"]
        if len(healthy) < 2:
            return {"ok": False,
                    "reason": "no healthy survivor to absorb "
                              "the drain"}
        # newest healthy replica leaves first (LIFO): the warmest caches
        # stay with the longest-lived replicas
        victim = max(healthy,
                     key=lambda n: int(n[1:]) if n[1:].isdigit() else -1)
        return {"ok": True, "direction": "down", "victim": victim,
                "to": target}

    def _apply_capacity(plan):
        if plan["direction"] == "up":
            rank = supervisor.add_rank()
            name = f"r{rank}"
            url = supervisor.url_of(rank)
            router.add_replica(name, url, rank=rank)
            print(f"autoscale_spawn replica={name} rank={rank} "
                  f"epoch={supervisor.snapshot()[str(rank)]['epoch']} "
                  f"url={url}", flush=True)
        else:
            victim = plan["victim"]
            out = router.remove_replica(victim)
            rank = out.get("rank")
            if rank is not None:
                supervisor.retire_rank(rank)
            print(f"autoscale_drain replica={victim} rank={rank} "
                  f"migrated={out.get('migrated_prefixes', 0)}",
                  flush=True)

    controller = autoscale_mod.CapacityController(
        apol, mode=args.autoscale, size_fn=_fleet_size,
        plan_fn=_plan_capacity, apply_fn=_apply_capacity,
        label="replicas")

    def _signals():
        fleet = collector.fleet_snapshot()
        return autoscale_mod.signals_from_fleet(fleet, _fleet_size())

    return autoscale_mod.AutoscaleRunner(
        controller, _signals, interval_s=args.autoscale_interval)


def _run_router(args) -> None:
    """`--role router`: spawn or adopt the replica fleet, start the health
    poller, the fleet collector and the autoscaler, serve the routed HTTP
    surface until SIGTERM. Model-free: the router loads no weights and
    never touches a card."""
    from .serving.router import DecodeRouter, RouterPolicy
    policy = RouterPolicy(
        poll_interval_s=args.router_poll_interval,
        health_timeout_s=args.router_health_timeout,
        request_timeout_s=args.route_timeout,
        route_retries=args.route_retries,
        hedge_ms=args.hedge_ms,
        drain_timeout_s=args.drain_timeout)
    supervisor = None
    if args.replica_addrs:
        replicas = {}
        for i, addr in enumerate(args.replica_addrs.split(",")):
            addr = addr.strip()
            replicas[f"r{i}"] = (addr if addr.startswith("http")
                                 else f"http://{addr}")
    else:
        ports = _free_ports(args.replicas, args.host)
        supervisor = ReplicaSupervisor(
            replica_command(args), args.host, ports,
            respawn=not args.no_replica_respawn)
        replicas = {f"r{i}": supervisor.url_of(i) for i in range(len(ports))}
    server = None
    router = DecodeRouter(replicas, policy=policy, supervisor=supervisor)
    # the router is a peer process of the fleet observatory: its own span
    # ring for /debug/spans, a flight recorder for slo_burn postmortems
    telemetry.configure(rank=0)
    router_flight = flight.configure(rank=0, out_dir=args.postmortem_dir)
    collector = _fleet_collector(args, router, router_flight)
    autoscaler = _autoscaler(args, router, supervisor, collector)
    # SIGTERM unwinds through the finally below: replicas stop too
    signal.signal(signal.SIGTERM, _exit_once)
    try:
        if supervisor is not None:
            for i, name in enumerate(replicas):
                router.bind_rank(name, i)
            supervisor.wait_ready(timeout=600.0)
        router.start()
        if collector is not None:
            collector.start()
        if autoscaler is not None:
            autoscaler.start()
            print(f"autoscale mode={args.autoscale} "
                  f"min={args.autoscale_min} max={args.autoscale_max} "
                  f"confirm={args.autoscale_confirm} "
                  f"cooldown={args.autoscale_cooldown:g}", flush=True)
        server = Server((args.host, args.port),
                        make_router_handler(router, args.model_name,
                                            collector=collector,
                                            autoscaler=autoscaler))
        # the bound port (`--port 0` takes a free one)
        print(f"serving router ({len(replicas)} replicas) on "
              f"{args.host}:{server.server_address[1]}", flush=True)
        server.serve_forever()
    finally:
        if server is not None:
            server.server_close()
        if autoscaler is not None:
            autoscaler.stop()
        if collector is not None:
            collector.stop()
        router.stop()
        if supervisor is not None:
            supervisor.stop()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.role == "router":
        # a model-free proxy: no weights, no card
        _run_router(args)
        return
    pipe = build_pipeline(args)
    # SIGTERM unwinds through the finally below: the executors and the
    # prefill workers stop, the trace is written and the process exits 0
    signal.signal(signal.SIGTERM, _exit_once)
    prefill_fleet, prefill_supervisor, ship_ctx = \
        build_prefill_fleet(args, pipe)
    # spans are always on in serving processes: GET /debug/spans drains
    # the ring without pre-arming; --trace-spans controls only the
    # shutdown trace dump
    telemetry.configure(rank=0)
    service = None
    try:
        service = make_service(args, pipe, prefill_fleet=prefill_fleet,
                               prefill_supervisor=prefill_supervisor)
        if isinstance(prefill_fleet, RemotePrefillFleet):
            # ship-plane faults (lease timeouts, zombie drops, worker
            # deaths and readmissions) land in the flight recorder's ring
            prefill_fleet.flight_note = service.flight.note
        server = Server((args.host, args.port),
                        make_handler(service, args.model_name))
    except BaseException:
        if service is not None:
            service.stop()
        elif prefill_supervisor is not None:
            prefill_fleet.close()
            prefill_supervisor.stop()
        if ship_ctx is not None:
            ship_ctx.shutdown()
        raise
    print(f"serving {args.model_name} ({len(pipe.stages)} stages, "
          f"{args.executor} executor) on {args.host}:{args.port}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.stop()
        if ship_ctx is not None:
            ship_ctx.shutdown()
        # the kernels this process launched (a replica behind a router
        # prints it through the router's output when it is retired), in
        # one write: `print` writes the text and its newline apart, and a
        # handler thread's error report (stderr, the same pipe under a
        # supervisor) could land between them, after the line's JSON
        sys.stdout.write("kernel_launches=" + json.dumps(
            _build.launch_counts, sort_keys=True) + "\n")
        sys.stdout.flush()
        if args.trace_spans and telemetry.recorder() is not None:
            from .telemetry import chrome_trace
            chrome_trace.dump_trace(telemetry.recorder().snapshot(),
                                    args.trace_spans)


if __name__ == "__main__":
    main()
