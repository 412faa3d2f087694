"""The port stands alone: no JAX, no `pipeedge_tpu`, no silent CPU runs.

- No import anywhere under `pipeedge_tpu_torch/` or in `chip_smoke.py`
  names `jax`, `jaxlib` or `pipeedge_tpu` as its top-level module, nor a
  module at the repository's root that imports one of them, directly or
  through another root module (`monitoring`, `runtime`, `profiler`, ...:
  the list is derived by scanning the root `*.py` files).
- Every module of the port imports in a process where `jax`,
  `pipeedge_tpu` and those root modules cannot be imported; nothing of
  the port imports `yaml` (the card's host has no PyYAML), and its
  scheduling modules, profiler and runtime import without it; nothing of
  the port imports `ml_dtypes` (a JAX dependency the card's host lacks),
  and the DCN transport frames without it.
- Entry points default to `cuda` and raise on a host without a GPU.
"""
import ast
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import pipeedge_tpu_torch
from pipeedge_tpu_torch import generate, runtime
from pipeedge_tpu_torch.parallel.pipeline import build_pipeline

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TOPS = {"jax", "jaxlib", "pipeedge_tpu"}


def _root_modules_importing(forbidden, root=ROOT):
    """Root `*.py` modules whose imports reach a top-level name in
    `forbidden`, directly or through other root modules (a fixed point)."""
    imports = {f.stem: set(_imported_tops(f)) for f in root.glob("*.py")}
    found = set()
    while True:
        more = {name for name, tops in imports.items()
                if name not in found and tops & (forbidden | found)}
        if not more:
            return found
        found |= more


def _port_files():
    pkg = ROOT / "pipeedge_tpu_torch"
    # _build/ holds kernel builds (and whatever a caller unpacks there to
    # run beside them); it is not part of the package
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    return files + [ROOT / "chip_smoke.py"]


def _imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FORBIDDEN = JAX_TOPS | _root_modules_importing(JAX_TOPS)


def _bad_imports(files, root=ROOT, forbidden=None):
    forbidden = FORBIDDEN if forbidden is None else forbidden
    return {(str(f.relative_to(root)), top) for f in files
            for top in _imported_tops(f) if top in forbidden}


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    assert {"monitoring", "runtime", "profiler"} <= FORBIDDEN
    assert "chip_smoke" not in FORBIDDEN
    assert not _bad_imports(files)


# the serving slices' modules, each a copy or port of a JAX-package
# module (the paged KV plane and speculative decoding included)
SERVING_MODULES = [
    "telemetry/__init__.py", "telemetry/metrics.py", "telemetry/flight.py",
    "telemetry/collector.py", "telemetry/chrome_trace.py",
    "health/__init__.py", "health/guard.py", "health/scorer.py",
    "serving/__init__.py", "serving/admission.py", "serving/brownout.py",
    "parallel/batcher.py", "serve.py", "kv/__init__.py", "kv/pool.py",
    "kv/prefix.py", "kv/backend.py", "parallel/speculative.py",
    "generate.py"]

# the decoder families' modules: the Llama family, the switch-MoE FFN, and
# the shards and the decode pipeline that dispatch to them
DECODER_MODULES = [
    "models/llama.py", "parallel/expert.py", "models/gpt2.py",
    "models/layers.py", "models/registry.py", "models/convert.py",
    "parallel/decode.py"]


# PipeEdge's own loop on one card (the reverse auction, span tracing) and
# the replica router with its wire-v2 frames and KV ship bundles
LOOP_AND_ROUTER_MODULES = [
    "sched/revauct.py", "sched/yaml_files.py", "revauct.py",
    "utils/tracing.py", "parallel/pipeline.py", "runtime.py",
    "comm/__init__.py", "comm/wire.py", "kv/ship.py", "serving/router.py"]


# PipeEdge's own transport: the DCN context and stage, the host codec,
# the per-stage checkpoints
DCN_MODULES = ["comm/dcn.py", "ops/native_quant.py", "utils/checkpoint.py"]


# the routed fleet's observatory and capacity loop (the fleet collector
# is telemetry/collector.py, above): the autoscaler, the span report and
# its profile feedback, trace_report
OBSERVATORY_MODULES = ["serving/autoscale.py", "telemetry/report.py",
                       "telemetry/feedback.py", "trace_report.py"]


# the DCN driver's fault plane: the failover planner, the chaos injector
# and its harness
FAULT_MODULES = ["sched/failover.py", "comm/chaos.py", "chaos_dcn.py"]


# the DCN driver's control loop: the load generator the serving chaos
# targets drive (the rebalancer, the rank autoscaler, the DCN auction and
# DCN generate live in runtime.py, revauct.py and generate.py, above)
CONTROL_MODULES = ["loadgen.py"]


# disaggregated prefill: the in-process prefill fleet, the cross-process
# lease protocol and the prefill worker entry
DISAGG_MODULES = ["kv/disagg.py", "kv/fleet.py", "prefill_worker.py"]


# the tensor-parallel axis: the shard group, the Megatron blocks and the
# quantized collectives
TP_MODULES = ["parallel/mesh.py", "parallel/tensor.py",
              "ops/qcollectives.py"]

# the sequence axis: the ring and Ulysses cores (the expert-parallel FFN
# is parallel/expert.py, among the decoder modules)
SP_MODULES = ["parallel/sequence.py"]

# the SPMD pipeline driver (its mesh is in parallel/mesh.py, above)
SPMD_MODULES = ["parallel/spmd.py"]


@pytest.mark.parametrize("rel", SERVING_MODULES + DECODER_MODULES
                         + LOOP_AND_ROUTER_MODULES + DCN_MODULES
                         + OBSERVATORY_MODULES + FAULT_MODULES
                         + CONTROL_MODULES + DISAGG_MODULES + TP_MODULES
                         + SP_MODULES + SPMD_MODULES)
def test_serving_modules_import_no_jax_anywhere(rel):
    """Each serving-slice module is scanned, and none imports `jax` or
    `pipeedge_tpu` (nor a root module that does), at module level or
    inside a function (the scan walks every import node)."""
    path = ROOT / "pipeedge_tpu_torch" / rel
    assert path in _port_files()
    tops = set(_imported_tops(path))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    # absolute imports inside functions (relative ones stay in the port)
    nested = [node for node in ast.walk(ast.parse(path.read_text()))
              if (isinstance(node, ast.Import) or (
                  isinstance(node, ast.ImportFrom) and node.level == 0))
              and node.col_offset > 0]
    for node in nested:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module])
        assert not {n.split(".")[0] for n in names} & FORBIDDEN


def test_port_imports_nothing_of_tools():
    """The repository's `tools/` scripts import the JAX package: the port
    keeps its own copies (`loadgen.py`) and imports none of them."""
    assert not _bad_imports(_port_files(), forbidden={"tools"})


def test_scan_flags_an_import_inside_a_function(tmp_path):
    (tmp_path / "lazy.py").write_text(
        "def f():\n    import jax.numpy as jnp\n    return jnp\n")
    assert _bad_imports([tmp_path / "lazy.py"], root=tmp_path) == {
        ("lazy.py", "jax")}


def test_serve_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    from pipeedge_tpu_torch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["-m", "pipeedge/test-tiny-gpt2", "-pt", "1,4,5,8",
                    "--max-len", "48", "--port", "0"])


def test_scan_flags_a_root_module_that_imports_jax(tmp_path):
    """A port module that imports a root module which imports the JAX
    package (even through another root module) is flagged."""
    (tmp_path / "facade.py").write_text("from pipeedge_tpu.utils import x\n")
    (tmp_path / "wrapper.py").write_text("import facade\n")
    (tmp_path / "plain.py").write_text("import os\n")
    found = _root_modules_importing(JAX_TOPS, root=tmp_path)
    assert found == {"facade", "wrapper"}
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "ok.py").write_text("import plain\nfrom . import sibling\n")
    (pkg / "bad.py").write_text("import torch\nimport wrapper\n")
    (pkg / "worse.py").write_text("from facade import iteration\n")
    bad = _bad_imports(sorted(pkg.glob("*.py")), root=tmp_path,
                       forbidden=JAX_TOPS | found)
    assert bad == {("pkg/bad.py", "wrapper"), ("pkg/worse.py", "facade")}


def test_port_imports_with_jax_blocked():
    names = [m.name for m in pkgutil.walk_packages(
        pipeedge_tpu_torch.__path__, "pipeedge_tpu_torch.")]
    assert "pipeedge_tpu_torch.parallel.pipeline" in names
    code = ("import importlib, sys\n"
            f"for blocked in {sorted(FORBIDDEN)!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_reads_and_writes_yaml_without_pyyaml():
    """The card's host has no PyYAML: no module of the port, nor
    `chip_smoke.py`, imports `yaml`, and the scheduling modules, the
    profiler, its converters and the runtime import, and the port's YAML
    subset round-trips, in a process where `yaml` cannot be imported."""
    assert not _bad_imports(_port_files(), forbidden={"yaml"})
    code = ("import sys\n"
            "for blocked in ['yaml'] + "
            f"{sorted(FORBIDDEN)!r}:\n"
            "    sys.modules[blocked] = None\n"
            "from pipeedge_tpu_torch import (profiler, runtime,\n"
            "    profiler_results_to_models,\n"
            "    profiler_results_to_device_types)\n"
            "from pipeedge_tpu_torch.sched import (miniyaml, profiles,\n"
            "    rebalance, scheduler, yaml_files, yaml_types)\n"
            "v = {'time_s': [1e-05, 3.2e-05, 0.0001], 0: ['h100-0', 7]}\n"
            "assert miniyaml.loads(miniyaml.dumps(v)) == v\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_never_imports_ml_dtypes():
    assert not _bad_imports(_port_files(), forbidden={"ml_dtypes"})
    code = ("import sys\n"
            "for blocked in ['ml_dtypes'] + "
            f"{sorted(FORBIDDEN)!r}:\n"
            "    sys.modules[blocked] = None\n"
            "import socket, torch\n"
            "from pipeedge_tpu_torch.comm import dcn, wire\n"
            "from pipeedge_tpu_torch import runtime\n"
            "a, b = socket.socketpair()\n"
            "t = torch.ones(2, 3, dtype=torch.bfloat16)\n"
            "dcn._send_frame(a, 1, 0, wire.wire_encode_device(t, 0)"
            ".finalize())\n"
            "out = wire.wire_decode(dcn._recv_frame(b)[3], torch.bfloat16,"
            " device='cpu')\n"
            "assert torch.equal(out, t)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_dcn_runtime_without_device_raises_without_gpu(monkeypatch,
                                                       tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.main(["1", "2", "-c", "dcn", "-m", "pipeedge/test-tiny-vit",
                      "--dcn-addrs", "127.0.0.1:1,127.0.0.1:2"])


def test_build_pipeline_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        build_pipeline("pipeedge/test-tiny-vit", [(1, 4), (5, 8)])
    with pytest.raises(RuntimeError, match="cuda"):
        pipeedge_tpu_torch.resolve_device(None)


def test_remote_prefill_fleet_without_device_raises_without_gpu():
    """The decode side of the prefill fleet decodes shipped handles on the
    card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    from pipeedge_tpu_torch.kv import RemotePrefillFleet
    with pytest.raises(RuntimeError, match="cuda"):
        RemotePrefillFleet(None, ranks=[1], dtype=torch.float32)


def test_generate_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        generate.main(["-m", "pipeedge/test-tiny-gpt2", "-b", "2",
                       "--prompt-len", "4", "--new-tokens", "2"])


def test_runtime_without_device_raises_without_gpu(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.main(["0", "2", "-m", "pipeedge/test-tiny-bert",
                      "-pt", "1,4,5,8", "-q", "8,0", "-b", "4", "-u", "2"])


def test_runtime_cpu_prints_report(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)   # the monitoring CSVs land in the cwd
    runtime.main(["0", "2", "-m", "pipeedge/test-tiny-vit", "-pt", "1,5,6,8",
                  "-q", "8,0", "-b", "4", "-u", "2", "--device", "cpu",
                  "--measure-rounds", "2"])
    lines = capsys.readouterr().out.splitlines()
    report = [ln for ln in lines if ln.startswith("latency_sec=")]
    assert len(report) == 1 and "throughput_items_sec=" in report[0]
    assert any(ln.startswith("steady_state_throughput_items_sec=")
               for ln in lines)
    # plain versions on the CPU: no kernel launched
    launches = [ln for ln in lines if ln.startswith("kernel_launches=")]
    assert launches == ['kernel_launches={"decode_attention": 0, '
                        '"fused_attention": 0, "fused_decode": 0, '
                        '"fused_encode": 0, "int8_matmul": 0}']


def test_runtime_rejects_bad_partition():
    with pytest.raises(ValueError):
        runtime.main(["0", "2", "-m", "pipeedge/test-tiny-vit",
                      "-pt", "1,4,6,8", "--device", "cpu"])
