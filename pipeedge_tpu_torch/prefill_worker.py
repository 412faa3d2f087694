"""Standalone prefill worker: one rank of the cross-process prefill fleet.

Port of `tools/prefill_worker.py`. The decode side (`python -m
pipeedge_tpu_torch.serve --disaggregate process`) is DCN rank 0; each
worker is a rank 1..N of the same address list. The worker builds its
OWN `DecodePipeline` (same model and partition as the decode executor)
on its device, joins the ship plane over the port's DCN sockets
(`comm/dcn.py`), and serves prefill LEASES (`kv/fleet.py`): receive a
prompt, run the prompt pass, ack with the wire-v2 KV ship bundle (at
`--kv-ship-bits 8` on the server, the codec's encode kernel packs it on
the card).

Fault surface:
- `DCN_CHAOS` (kill/slow/corrupt/...) arms deterministic faults on this
  worker's SENDS: the ship edge is a chaos target.
- A restarted worker (the server's respawn, or chaos `restart@K:MS`)
  comes back with `DCN_EPOCH` incremented and JOINs; the decode-side
  fleet readmits it, and a ship its dead incarnation left in flight is
  fenced (stale epoch at the transport, stale lease attempt above).
- The worker exits when the decode rank dies or on SIGTERM.

It prints `prefill worker rank R ready (epoch=E, pid=P)` once it serves
leases, and `prefill worker rank R exiting (N lease(s) served)
kernel_launches={...}` (the kernels this process launched) when it ends.

Usage (normally spawned by the server, not by hand):

  python -m pipeedge_tpu_torch.prefill_worker RANK WORLD \\
      --dcn-addrs host:p0,host:p1 -m pipeedge/test-tiny-gpt2 \\
      -pt 1,4,5,8 --max-len 48 -t float32 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("--dcn-addrs", required=True,
                   help="comma-separated host:port per rank (rank 0 is "
                        "the decode side)")
    p.add_argument("-m", "--model-name", default="gpt2")
    p.add_argument("-M", "--model-file", default=None,
                   help="weights (.npz, HF state-dict keys of the family); "
                        "without it each stage draws seeded random weights")
    p.add_argument("-pt", "--partition", default=None)
    p.add_argument("--max-len", default=1024, type=int)
    p.add_argument("-t", "--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--attend-floor", default=64, type=int)
    p.add_argument("--heartbeat-interval", default=1.0, type=float,
                   help="beat the decode rank (0 disables); a missed-"
                        "beat death on either side tears the edge down "
                        "cleanly")
    p.add_argument("--heartbeat-miss", default=5, type=int)
    p.add_argument("--http-port", default=0, type=int,
                   help="observability listener port (GET /metrics, "
                        "/healthz, /debug/spans): the router's fleet "
                        "collector and trace_report --fleet scrape it; "
                        "0 disables")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the prompt passes run (cpu: the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    if not 0 < args.rank < args.world:
        p.error(f"rank must be in [1, {args.world - 1}] (rank 0 is the "
                "decode side)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    import torch

    from . import telemetry
    from .comm import chaos, dcn
    from .kv.fleet import PrefillWorkerLoop
    from .ops import _build
    from .parallel.decode import build_decode_pipeline

    # span ring on from the start: /debug/spans federates this rank's
    # prefill spans into trace_report --fleet timelines. The listener and
    # the DCN context come up FIRST: the decode side's dials and
    # heartbeats reach this rank while the (slow) model build below runs,
    # and early leases just queue until the loop starts draining them
    telemetry.configure(rank=args.rank)
    http_server = None
    if args.http_port:
        http_server = _start_http(args.http_port, args.rank)
    addrs = dcn.parse_rank_addrs(args.dcn_addrs, args.world, 29600)
    ctx = dcn.DistDcnContext(args.world, args.rank, addrs)
    ctx.init()
    chaos.maybe_install(ctx)    # DCN_CHAOS faults on the ship edge

    partition = None
    if args.partition:
        nums = [int(x) for x in args.partition.split(",")]
        partition = list(zip(nums[::2], nums[1::2]))
    pipe = build_decode_pipeline(
        args.model_name, partition, max_len=args.max_len,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        attend_floor=args.attend_floor, model_file=args.model_file,
        device=args.device)
    loop = PrefillWorkerLoop(pipe, ctx, decode_rank=0)
    ctx.register_peer_death_handler(
        lambda rank: loop.stop() if rank == 0 else None)
    # a restarted incarnation (DCN_EPOCH > 0) must JOIN to clear the
    # decode side's death fence before any lease can reach it
    if ctx.epoch > 0:
        ctx.announce_join([0])
    if args.heartbeat_interval > 0:
        ctx.start_heartbeat([0], interval=args.heartbeat_interval,
                            miss_threshold=args.heartbeat_miss)
    signal.signal(signal.SIGTERM, lambda *a: loop.stop())
    # machine-read readiness line (the server's supervisor and the chaos
    # harness key on it)
    print(f"prefill worker rank {args.rank} ready "
          f"(epoch={ctx.epoch}, pid={os.getpid()})", flush=True)
    try:
        loop.run()
    finally:
        # one write (as runtime.emit_line): a log record from another
        # thread cannot land between the line's JSON and its newline
        sys.stdout.write(
            f"prefill worker rank {args.rank} exiting "
            f"({loop.leases_served} lease(s) served) kernel_launches="
            + json.dumps(_build.launch_counts, sort_keys=True) + "\n")
        sys.stdout.flush()
        if http_server is not None:
            http_server.shutdown()
        ctx.shutdown()


def _device_memory() -> Optional[dict]:
    """This process's card memory as its caching allocator holds it (None
    before the first CUDA use, and on the CPU)."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved()}


def _start_http(port: int, rank: int) -> ThreadingHTTPServer:
    """Tiny observability listener (daemon thread): the three read-only
    endpoints every other fleet process serves, /metrics (Prometheus
    text), /healthz (with the card memory this process holds) and
    /debug/spans (ring drain with clock-offset stamps). No mutation
    surface: leases arrive over DCN only."""
    from .telemetry import collector as fleet_obs
    from .telemetry import metrics as prom

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # noqa: N802 — stdlib name
            pass

        def _send(self, code, body, ctype="application/json"):
            data = (body if isinstance(body, bytes)
                    else json.dumps(body).encode("utf8")
                    if not isinstance(body, str) else body.encode("utf8"))
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):   # noqa: N802 — stdlib name
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._send(200, prom.REGISTRY.render(),
                           ctype="text/plain; version=0.0.4")
            elif path == "/healthz":
                self._send(200, {"ok": True, "role": "prefill_worker",
                                 "rank": rank, "pid": os.getpid(),
                                 "device_memory": _device_memory()})
            elif path == "/debug/spans":
                drain = "drain=0" not in self.path
                self._send(200, fleet_obs.debug_spans_payload(drain=drain))
            else:
                self._send(404, {"error": f"no route {path}"})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="prefill-http").start()
    return server


if __name__ == "__main__":
    main()
