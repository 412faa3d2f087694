"""Disaggregated serving: a prefill fleet feeding a decode fleet.

Port of `pipeedge_tpu/kv/disagg.py`. The O(S^2) prompt pass and the
O(1)-per-token decode step have opposite resource shapes: colocated, one
long prompt stretches every other request's inter-token latency. The
split:

- **PrefillFleet** owns a DEDICATED `DecodePipeline` (same weights; it
  may share the decode pipeline's loaded parameters) and runs ONLY prompt
  passes: `prefill()` returns a ship handle, the per-stage KV rows plus
  the final logits (`kv/ship.py`). Concurrency is bounded: each in-flight
  prefill holds dense prompt-sized caches until its handle is installed.
- The DECODE executors admit the handle through `PagedKvBackend.admit`
  (`shipped=`): pages are charged, the rows land by gather/scatter, and
  the first token is picked decode-side from the shipped logits with the
  request's own generator, so disaggregated tokens equal colocated ones.

Ship paths: `local` hands the device tensors over in-process (views into
the prefill pipeline's caches, which the handle keeps alive until the
install); `wire` pushes real bytes through the v2 codec and a loopback
socket (8-bit quads at `ship_bits=8`: the codec's encode kernel on the
prefill side, its decode kernel on the decode side) and decodes onto the
pipeline's device. Both run on the device's default stream, the stream
the executors install on (`kv/ship.py device_stream`).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .. import telemetry
from ..telemetry import metrics as prom
from . import ship


class PrefillFleet:
    """Prompt passes on a dedicated pipeline, results shipped as KV.

    `max_concurrent` bounds in-flight prefills (each holds dense
    prompt-length KV until its handle is consumed); `path` picks the ship
    transport ("local" | "wire"); `ship_bits` quantizes KV wire bytes (0
    exact, the parity setting; 8 = the codec's 8-bit quads)."""

    def __init__(self, pipe, path: str = "local", ship_bits: int = 0,
                 max_concurrent: int = 2,
                 registry: Optional[prom.Registry] = None):
        if path not in ship.SHIP_PATHS:
            raise ValueError(f"unknown ship path {path!r} (expected one "
                             f"of {ship.SHIP_PATHS})")
        if ship_bits not in (0, 8):
            raise ValueError(f"ship_bits must be 0 or 8, got {ship_bits}")
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if pipe.cache_bits:
            raise ValueError("the prefill fleet ships fp KV rows; int8 "
                             "CACHES don't ship (quantize the wire with "
                             "ship_bits=8 instead)")
        self.pipe = pipe
        self.path = path
        self.ship_bits = int(ship_bits)
        self._slots = threading.Semaphore(max_concurrent)
        reg = prom.REGISTRY if registry is None else registry
        self.m_prefills = reg.counter(
            "pipeedge_kv_prefills_total",
            "prompt passes run by the prefill fleet")
        self.m_prefills.declare()
        self.m_ship_bytes = reg.counter(
            "pipeedge_kv_ship_bytes_total",
            "KV bytes shipped prefill fleet -> decode fleet, by path "
            "(local = in-process array hand-off, estimated; wire = "
            "serialized v2 frame bytes through the loopback socket)")
        for p in ship.SHIP_PATHS:
            self.m_ship_bytes.declare(path=p)

    def prefill(self, ids, rid: Optional[str] = None) -> dict:
        """Run one prompt batch `[B, S]` through the prefill pipeline and
        ship the result; returns the decode-side install handle
        (`PagedKvBackend.admit`'s `shipped=`). Blocks while
        `max_concurrent` prefills are in flight."""
        srid = None if rid is None else str(rid)
        with self._slots, ship.device_stream(self.pipe.device):
            ids = self.pipe._ids(ids)
            with telemetry.span("kv", "prefill", rid=srid):
                out, caches = self.pipe._prefill(ids)
                logits = out[:, -1]
            self.m_prefills.inc()
            prompt_len = ids.shape[1]
            with telemetry.span("kv", f"ship:{self.path}", rid=srid):
                if self.path == "local":
                    # in-process hand-off: the tensors ARE the handle
                    handle = {
                        "stage_rows": [
                            {n: c[n][:, :, :prompt_len]
                             for n in ("k", "v")} for c in caches],
                        "logits": logits, "prompt_len": prompt_len,
                    }
                    self.m_ship_bytes.inc(
                        sum(a.numel() * a.element_size()
                            for row in handle["stage_rows"]
                            for a in row.values()), path="local")
                    return handle
                frames = ship.encode_kv_ship(caches, prompt_len, logits,
                                             bits=self.ship_bits)
                blob = ship.frames_to_bytes(frames)
                self.m_ship_bytes.inc(len(blob), path="wire")
                back = ship.frames_from_bytes(ship.ship_over_socket(blob))
                return ship.decode_kv_ship(back, self.pipe.dtype,
                                           device=self.pipe.device)
