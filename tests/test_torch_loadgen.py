"""The port's load generator (`pipeedge_tpu_torch/loadgen.py`) against
the JAX tool's (`tools/loadgen.py`), on the same seeds and specs.

- the prompt specs (`N`, `uniform:LO:HI`, `shared:PFX:TOTAL[:POOL]`)
  parse, size and draw the same token lists, and both refuse the same
  bad specs;
- the `ramp:LO:HI[:HOLD]` spec parses the same, its offered rate is the
  same at every instant, and the `uniform`, `poisson` and ramp arrival
  schedules are the same lists of offsets;
- `run_load` against one local HTTP stub (it answers 200, a 503 shed
  with `Retry-After` or a 504 by the prompt's last token) sends the same
  request bodies and counts the same outcomes per class, under a Poisson
  burst of shared-prefix prompts and under a ramp.
"""
import http.server
import json
import os
import random
import sys
import threading

import pytest

from pipeedge_tpu_torch import loadgen as port

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import loadgen as jax_loadgen  # noqa: E402

PROMPT_SPECS = ["6", 9, "uniform:2:9", "shared:16:24:2", "shared:3:8"]
BAD_PROMPT_SPECS = ["0", "uniform:5:2", "shared:8:8", "shared:2:8:0",
                    "zipf:1:2"]
RAMPS = ["ramp:1:8:0.4", "ramp:2:5", "ramp:3:3:0"]
BAD_RAMPS = ["ramp:0:4", "ramp:5:2", "ramp:1:2:1", "ramp:1", "ramp:a:2"]


@pytest.mark.parametrize("spec", PROMPT_SPECS)
def test_prompt_specs_draw_as_the_jax_tool(spec):
    assert port.parse_prompt_spec(spec) == jax_loadgen.parse_prompt_spec(spec)
    assert port.spec_max_len(spec) == jax_loadgen.spec_max_len(spec)
    for seed in (0, 7):
        mine, theirs = random.Random(seed), random.Random(seed)
        for _ in range(40):
            assert port.prompt_ids(spec, mine, seed) \
                == jax_loadgen.prompt_ids(spec, theirs, seed)


@pytest.mark.parametrize("spec", BAD_PROMPT_SPECS)
def test_bad_prompt_specs_are_refused_by_both(spec):
    with pytest.raises(ValueError):
        jax_loadgen.parse_prompt_spec(spec)
    with pytest.raises(ValueError):
        port.parse_prompt_spec(spec)


@pytest.mark.parametrize("spec", RAMPS)
def test_ramp_schedule_is_the_jax_tool_s(spec):
    ramp = port.parse_ramp_spec(spec)
    assert ramp == jax_loadgen.parse_ramp_spec(spec)
    for duration in (4.0, 8.0):
        for i in range(101):
            t = duration * i / 80     # past the end too
            assert port.ramp_rate(t, duration, ramp) \
                == jax_loadgen.ramp_rate(t, duration, ramp)
        assert port.arrival_offsets(0, None, spec, duration_s=duration) \
            == jax_loadgen.arrival_offsets(0, None, spec,
                                           duration_s=duration)


@pytest.mark.parametrize("spec", BAD_RAMPS)
def test_bad_ramps_are_refused_by_both(spec):
    with pytest.raises(ValueError):
        jax_loadgen.parse_ramp_spec(spec)
    with pytest.raises(ValueError):
        port.parse_ramp_spec(spec)


@pytest.mark.parametrize("arrival", ["uniform", "poisson"])
def test_arrival_offsets_are_the_jax_tool_s(arrival):
    assert port.arrival_offsets(50, 12.5, arrival, random.Random(3)) \
        == jax_loadgen.arrival_offsets(50, 12.5, arrival, random.Random(3))
    assert port.parse_ramp_spec(arrival) is None \
        and jax_loadgen.parse_ramp_spec(arrival) is None


class _Stub(http.server.BaseHTTPRequestHandler):
    """POST /generate: the outcome is a function of the prompt's last
    token (a shared prefix's first is the same in most prompts), so both
    tools' runs meet the same answers; every body is kept."""
    bodies = None

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.bodies.append(body)
        last = body["ids"][0][-1]
        if last % 7 == 0:
            code, reply, extra = 503, {"shed": True}, {"Retry-After": "0.5"}
        elif last % 7 == 1:
            code, reply, extra = 504, {"deadline_exceeded": True}, {}
        else:
            code, reply, extra = 200, {"rid": f"r{last}"}, {}
        data = json.dumps(reply).encode()
        self.send_response(code)
        for k, v in {"Content-Type": "application/json",
                     "Content-Length": str(len(data)), **extra}.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


class _Server(http.server.ThreadingHTTPServer):
    request_queue_size = 256      # a Poisson burst is not refused


def _against_stub(tool, **kw):
    bodies = []
    handler = type("Handler", (_Stub,), {"bodies": bodies})
    server = _Server(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        report = tool.run_load(
            f"http://127.0.0.1:{server.server_address[1]}/generate", **kw)
    finally:
        server.shutdown()
        server.server_close()
    return report, sorted(json.dumps(b, sort_keys=True) for b in bodies)


@pytest.mark.parametrize("load", [
    dict(duration_s=1.0, qps=30.0, mix={"interactive": 1.0},
         new_tokens=24, prompt_len="shared:16:24:2", seed=7,
         arrival="poisson"),
    dict(duration_s=1.5, qps=None, mix={"interactive": 0.6, "batch": 0.4},
         deadline_from_slo=False, new_tokens=4, prompt_len="6", seed=7,
         arrival="ramp:4:30:0.4"),
], ids=["poisson_shared", "ramp"])
def test_run_load_sends_and_counts_as_the_jax_tool(load):
    mine, my_bodies = _against_stub(port, **load)
    theirs, their_bodies = _against_stub(jax_loadgen, **load)
    assert my_bodies == their_bodies and len(my_bodies) > 10
    for key in ("requests", "offered_qps", "seed", "arrival", "prompt_len",
                "client_dropped", "totals", "deadline_rids", "ramp"):
        assert mine.get(key) == theirs.get(key), key
    for cls, counts in mine["classes"].items():
        for key in (*port.OUTCOMES, "sent", "slo_ms"):
            assert counts[key] == theirs["classes"][cls][key], (cls, key)
    for key in ("n", "min", "max", "distinct"):
        assert mine["retry_after"][key] == theirs["retry_after"][key]
    assert mine["totals"]["shed"] and mine["totals"]["deadline"] \
        and mine["totals"]["ok"] and not mine["totals"]["error"]
