"""The port's scheduling package against the JAX package's.

- `miniyaml` (the port's YAML subset) reads every committed profile as
  `yaml.safe_load` does, and what it writes reads back equal under
  `yaml.safe_load`: floats stay floats (`1e-05` is a string to PyYAML
  1.1, so the writer spells it `1.0e-05`), numeric host names stay ints.
  PyYAML is used only here, as the oracle; the port never imports it.
- The port's converters give the JAX package's models.yml and
  device_types.yml on the committed profiles, and refuse what it refuses.
- The port's `sched_pipeline` (its own build of `native/`, made with the
  host's C++ compiler) gives the JAX package's schedules: on the
  committed profiles, on `tests/test_sched.py`'s heterogeneous,
  memory-bound and infeasible fixtures, and on files the port wrote.
- `solve_partition`, `spread_layer_costs`, `RebalancePolicy` and
  `results_from_measured` equal the JAX functions on seeded random costs.
- The card's own profiles (`pipeedge_tpu_torch/profiles/h100/`) read the
  same in `miniyaml` and PyYAML, and schedule ViT-Large over four hosts.
"""
import dataclasses
import glob
import math
import os
from pathlib import Path

import numpy as np
import pytest
import yaml

from pipeedge_tpu.sched import profiles as jprofiles
from pipeedge_tpu.sched import rebalance as jrebalance
from pipeedge_tpu.sched import scheduler as jscheduler
from pipeedge_tpu.sched import yaml_files as jyaml_files
from pipeedge_tpu.sched import yaml_types as jyaml_types
from pipeedge_tpu_torch import profiler_results_to_device_types as to_types
from pipeedge_tpu_torch import profiler_results_to_models as to_models
from pipeedge_tpu_torch.sched import miniyaml
from pipeedge_tpu_torch.sched import profiles as tprofiles
from pipeedge_tpu_torch.sched import rebalance as trebalance
from pipeedge_tpu_torch.sched import scheduler as tscheduler
from pipeedge_tpu_torch.sched import yaml_files as tyaml_files

REPO = Path(__file__).resolve().parents[1]
TPU = REPO / "profiles" / "tpu"
H100 = REPO / "pipeedge_tpu_torch" / "profiles" / "h100"
TPU_FILES = sorted(glob.glob(str(TPU / "*.yml")))
TPU_MODELS = [("google/vit-base-patch16-224", 48),
              ("google/vit-large-patch16-224", 96),
              ("bert-base-uncased", 48),
              ("facebook/deit-base-distilled-patch16-224", 48),
              ("gpt2", 48)]


# --- miniyaml ---------------------------------------------------------------

@pytest.mark.parametrize("path", TPU_FILES, ids=os.path.basename)
def test_reads_committed_profiles_as_pyyaml(path):
    with open(path, encoding="utf-8") as f:
        want = yaml.safe_load(f)
    got = miniyaml.load(path)
    assert got == want
    # and writes them as PyYAML lays them out
    assert miniyaml.dumps(got) == yaml.safe_dump(want, default_flow_style=None)


SAMPLE = {
    "floats": [3.2e-05, 1e-05, 0.0001, 1e+20, 5e-324, -0.0, 1.5, 2.0,
               math.inf, -math.inf],
    0: {"hosts": [0, "0", "h100-0", "1e-05", "yes", True, None, ""],
        "nested": [[1, [2, 3]], {"k": {"j": [1]}}], "empty": [], "none": {}},
    "sched": [{"h100-0": [1, 24]}, {7: [25, 48]}],
    "strings": ["it's", "a: b", "#x", "-a", "x # y", "'q'", 'say "hi"',
                "back\\slash", "é"],
}


@pytest.mark.parametrize("style", ["miniyaml", "pyyaml", "pyyaml-block",
                                   "pyyaml-flow"])
def test_round_trip_with_pyyaml(style):
    text = {"miniyaml": miniyaml.dumps,
            "pyyaml": lambda v: yaml.safe_dump(v, default_flow_style=None),
            "pyyaml-block": lambda v: yaml.safe_dump(
                v, default_flow_style=False),
            "pyyaml-flow": lambda v: yaml.safe_dump(
                v, default_flow_style=True)}[style](SAMPLE)
    assert yaml.safe_load(text) == SAMPLE
    assert miniyaml.loads(text) == SAMPLE


@pytest.mark.parametrize("value", [3.2e-05, 1e-05, 0.0001, 1e20, 1e-300,
                                   123456789.0, 0.1, 7.0])
def test_floats_read_back_as_floats(value):
    text = miniyaml.dumps({"t": [value]})
    back = yaml.safe_load(text)["t"][0]
    assert isinstance(back, float) and back == value
    assert miniyaml.format_float(value) == yaml.safe_dump(value).split("\n")[0]


@pytest.mark.parametrize("text", [
    "1e5", "1.0e5", "1.0e+5", ".5", ".inf", "-.Inf", "+1", "-0", "~",
    "Null", "NO", "on", "1.", "+.5", "08", "h100-0", "3.2e-05", "1e-05",
    "0bad", "1:3x"])
def test_plain_scalars_resolve_as_pyyaml(text):
    want = yaml.safe_load(f"v: {text}")["v"]
    got = miniyaml.resolve_plain(text)
    assert type(got) is type(want) and got == want


def test_reads_the_scheduler_output():
    out = "- h100-0: [1, 24]\n- h100-1: [25, 48]\n- 2: [49, 96]\n"
    assert miniyaml.loads(out) == yaml.safe_load(out) == [
        {"h100-0": [1, 24]}, {"h100-1": [25, 48]}, {2: [49, 96]}]


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!float 1\n", "a: |\n  text\n", "a: [1, 2\n",
    "a: 1\na: 2\n", 'a: "\\n"\n',
    # YAML 1.1 numbers that no scheduler file holds
    "a: 017\n", "a: 0x1F\n", "a: 0b101\n", "a: 1_000\n", "a: 1:30\n",
    "a: 1:30.5\n"])
def test_refuses_what_is_outside_the_subset(text):
    with pytest.raises(miniyaml.YamlError):
        miniyaml.loads(text)


@pytest.mark.parametrize("text", ["017", "0x1F", "1_000", "tab\there"])
def test_writes_outside_the_subset_quoted_or_refused(text):
    if text.isprintable():
        # a string that reads as a number outside the subset is quoted
        out = miniyaml.dumps({"a": text})
        assert out == f"a: '{text}'\n" and yaml.safe_load(out)["a"] == text
    else:
        with pytest.raises(miniyaml.YamlError):
            miniyaml.dumps({"a": text})


# --- converters -------------------------------------------------------------

@pytest.mark.parametrize("name", ["vitb", "vitl", "bertb"])
def test_converters_give_the_jax_files(tmp_path, name):
    results = str(TPU / f"profiler_results_{name}.yml")
    jres = jprofiles.ProfilerResults.load(results)
    jprofiles.upsert_model(str(tmp_path / "jax_models.yml"), jres)
    jprofiles.upsert_device_type(str(tmp_path / "jax_types.yml"), "tpu-v5e",
                                 jres, mem_MB=16384, bw_Mbps=100000)
    to_models.main(["-i", results, "-o", str(tmp_path / "models.yml")])
    to_types.main(["tpu-v5e", "-i", results, "-o",
                   str(tmp_path / "types.yml"), "-dtm", "16384",
                   "-dtb", "100000"])
    for port, jax in (("models.yml", "jax_models.yml"),
                      ("types.yml", "jax_types.yml")):
        with open(tmp_path / port) as f, open(tmp_path / jax) as g:
            assert yaml.safe_load(f) == yaml.safe_load(g)
    assert (tmp_path / "models.yml").read_text() == \
        (tmp_path / "jax_models.yml").read_text()


def _refusal(pkg, tmp_path, case):
    """The message of `pkg`'s refusal in `case` (paths made relative)."""
    results = pkg.ProfilerResults.load(str(TPU / "profiler_results_vitb.yml"))
    models = str(tmp_path / f"{pkg.__name__}-models.yml")
    types = str(tmp_path / f"{pkg.__name__}-types.yml")
    try:
        if case == "model exists":
            pkg.upsert_model(models, results)
            pkg.upsert_model(models, results)
        elif case == "new type without capacity":
            pkg.upsert_device_type(types, "t", results, mem_MB=1)
        elif case == "capacity mismatch":
            pkg.upsert_device_type(types, "t", results, mem_MB=1, bw_Mbps=2)
            pkg.upsert_device_type(types, "t", results, mem_MB=3)
        elif case == "profile exists":
            pkg.upsert_device_type(types, "t", results, mem_MB=1, bw_Mbps=2)
            pkg.upsert_device_type(types, "t", results)
        elif case == "empty profile":
            path = tmp_path / f"{pkg.__name__}-empty.yml"
            path.write_text("model_name: m\ndtype: float32\nbatch_size: 8\n"
                            "layers: 0\nprofile_data: []\n")
            pkg.ProfilerResults.load(str(path))
        elif case == "layer count":
            path = tmp_path / f"{pkg.__name__}-count.yml"
            path.write_text("model_name: m\ndtype: float32\nbatch_size: 8\n"
                            "layers: 2\nprofile_data:\n- {time: 1.0}\n")
            pkg.ProfilerResults.load(str(path))
    except pkg.ProfileError as exc:
        return str(exc).replace(str(tmp_path), "").replace(pkg.__name__, "")
    return None


@pytest.mark.parametrize("case", ["model exists", "new type without capacity",
                                  "capacity mismatch", "profile exists",
                                  "empty profile", "layer count"])
def test_upsert_refusals_match(tmp_path, case):
    want = _refusal(jprofiles, tmp_path, case)
    assert want is not None
    assert _refusal(tprofiles, tmp_path, case) == want


def test_measured_profiles_feed_the_converter(tmp_path):
    record = tprofiles.results_from_measured(
        "m", "float32", 8, 6, [(1, 2), (3, 6)], [2e-05, 1e-05])
    path = tmp_path / "measured.yml"
    tprofiles.save_measured_profiles(str(path), record)
    with open(path) as f:
        assert yaml.safe_load(f) == record   # 5e-06 stays a float
    res = tprofiles.ProfilerResults.load(str(path))
    tprofiles.upsert_device_type(str(tmp_path / "t.yml"), "d", res,
                                 mem_MB=1, bw_Mbps=1)
    got = tyaml_files.yaml_device_types_load(str(tmp_path / "t.yml"))
    assert got["d"]["model_profiles"]["m"][0]["time_s"] == [1e-05] * 2 + \
        [2.5e-06] * 4


# --- the native scheduler ---------------------------------------------------

@pytest.fixture(scope="module")
def binaries():
    """Both packages' scheduler binaries. Skips where the host has no C++
    compiler (the port's build) or the JAX package's native build cannot
    be found or made."""
    if tscheduler.compiler() is None:
        pytest.skip("no C++ compiler on this host: the port cannot build "
                    "sched-pipeline")
    port = tscheduler.build_native()
    assert port is not None, "the port's sched-pipeline build failed"
    jax = jscheduler.build_native()
    if jax is None:
        pytest.skip("the JAX package's sched-pipeline is unbuilt and its "
                    "cmake build is unavailable")
    return port, jax


def test_port_builds_into_its_own_directory(binaries):
    port, jax = binaries
    assert Path(port).parent == REPO / "pipeedge_tpu_torch" / "_build"
    assert Path(port) == tscheduler.binary_path()
    assert os.access(port, os.X_OK)
    assert Path(jax).parent != Path(port).parent


def test_binary_name_follows_the_toolchain(monkeypatch):
    # a build from another compiler or machine (a copied checkout) gets
    # another name, so it is never found and run here
    here = tscheduler.binary_path()
    tscheduler.toolchain_id.cache_clear()
    monkeypatch.setattr(tscheduler.platform, "machine", lambda: "aarch64")
    try:
        assert tscheduler.binary_path() != here
    finally:
        tscheduler.toolchain_id.cache_clear()


def _both(binaries, model, batch, dtype, files):
    kw = dict(dtype=dtype, models_file=str(files[0]),
              dev_types_file=str(files[1]), dev_file=str(files[2]))
    port = tscheduler.sched_pipeline(model, 2, 2, batch, **kw)
    jax = jscheduler.sched_pipeline(model, 2, 2, batch, **kw)
    return port, jax


@pytest.mark.parametrize("model,layers", TPU_MODELS)
def test_schedules_equal_on_committed_profiles(binaries, model, layers):
    files = [TPU / "models.yml", TPU / "device_types.yml", TPU / "devices.yml"]
    port, jax = _both(binaries, model, 8, "bfloat16", files)
    assert port == jax
    covered = [l for st in port for a, b in st.values()
               for l in range(a, b + 1)]
    assert covered == list(range(1, layers + 1)) and len(port) == 4


def _mk_type(mem_mb, bw, time_s):
    return jyaml_types.yaml_device_type(mem_mb, bw, {"m": [
        jyaml_types.yaml_model_profile("torch.float32", 8, time_s)]})


def _fixture(case):
    """`tests/test_sched.py`'s fixtures: models, device types, devices."""
    if case == "heterogeneous":
        n = 6
        return ({"m": jyaml_types.yaml_model(n, 1000, [1000] * n, [1.0] * n)},
                {"fast": _mk_type(1024, 1000, [0.1] * n),
                 "slow": _mk_type(1024, 1000, [0.3] * n)},
                {"fast": ["f0"], "slow": ["s0"]})
    if case == "memory-bound":
        n = 4
        return ({"m": jyaml_types.yaml_model(n, 1000, [1000] * n,
                                             [100.0] * n)},
                {"small": _mk_type(250, 1000, [0.1] * n)},
                {"small": ["h0", "h1", "h2"]})
    if case == "infeasible":
        n = 2
        return ({"m": jyaml_types.yaml_model(n, 1000, [1000] * n,
                                             [10000.0] * n)},
                {"tiny": _mk_type(1, 1000, [0.1] * n)}, {"tiny": ["h0"]})
    # numeric host names, float times with exponents, wrapped flow lists
    rng = np.random.default_rng(5)
    n = 48
    times = [float(t) for t in rng.uniform(1e-5, 9e-5, n)]
    return ({"m": jyaml_types.yaml_model(n, 150528, [151296] * n,
                                         [float(x) for x in
                                          rng.uniform(1, 30, n)])},
            {"a": _mk_type(4096, 3433227, times),
             "b": _mk_type(4096, 1000, [2 * t for t in times])},
            {"a": [0, 1], "b": [2]})


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("case", ["heterogeneous", "memory-bound",
                                  "infeasible", "numeric hosts"])
def test_schedules_equal_on_fixtures(binaries, tmp_path, case, writer):
    save = (tyaml_files if writer == "port" else jyaml_files).yaml_save
    files = [tmp_path / name for name in ("models.yml", "types.yml",
                                          "devices.yml")]
    for data, path in zip(_fixture(case), files):
        save(data, str(path))
    port, jax = _both(binaries, "m", 8, "torch.float32", files)
    assert port == jax
    assert (port == []) == (case == "infeasible")
    if case == "numeric hosts":
        assert all(isinstance(host, int) for st in port for host in st)


# --- rebalancing -----------------------------------------------------------

@pytest.mark.parametrize("seed,n_layers,n_stages,align,fixed", [
    (0, 12, 3, 1, False), (1, 48, 4, 1, True), (2, 96, 4, 4, False),
    (3, 24, 8, 1, True), (4, 7, 7, 1, False), (5, 40, 5, 4, True)])
def test_solve_partition_equals_jax(seed, n_layers, n_stages, align, fixed):
    rng = np.random.default_rng(seed)
    costs = [float(c) for c in rng.uniform(1e-5, 1e-3, n_layers)]
    fixed_costs = ([float(c) for c in rng.uniform(0, 1e-4, n_stages)]
                   if fixed else None)
    assert trebalance.solve_partition(costs, n_stages, fixed_costs, align) \
        == jrebalance.solve_partition(costs, n_stages, fixed_costs, align)


@pytest.mark.parametrize("seed", range(4))
def test_spread_and_measured_profiles_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n_layers = int(rng.integers(4, 97))
    cuts = sorted(rng.choice(np.arange(1, n_layers), size=3, replace=False))
    bounds = [0, *(int(c) for c in cuts), n_layers]
    partition = [(bounds[i] + 1, bounds[i + 1]) for i in range(4)]
    stage_s = [float(t) for t in rng.uniform(1e-4, 1e-2, 4)]
    assert trebalance.spread_layer_costs(partition, stage_s) == \
        jrebalance.spread_layer_costs(partition, stage_s)
    assert tprofiles.results_from_measured("m", "float32", 8, n_layers,
                                           partition, stage_s) == \
        jprofiles.results_from_measured("m", "float32", 8, n_layers,
                                        partition, stage_s)


@pytest.mark.parametrize("partition", [[(1, 3), (5, 8)], [(1, 4), (4, 8)],
                                       [(2, 8)]])
def test_partition_refusals_equal_jax(partition):
    with pytest.raises(ValueError) as want:
        jrebalance.spread_layer_costs(partition, [1.0] * len(partition))
    with pytest.raises(ValueError) as got:
        trebalance.spread_layer_costs(partition, [1.0] * len(partition))
    assert str(got.value) == str(want.value)
    with pytest.raises(jprofiles.ProfileError):
        jprofiles.results_from_measured("m", "f", 8, 8, partition,
                                        [1.0] * len(partition))
    with pytest.raises(tprofiles.ProfileError):
        tprofiles.results_from_measured("m", "f", 8, 8, partition,
                                        [1.0] * len(partition))


@dataclasses.dataclass
class _Estimate:
    layer_s: float
    fixed_s: float

    @property
    def service_s(self):
        return self.layer_s + self.fixed_s


def test_rebalance_policy_equals_jax():
    """Both policies take the same decisions on the same seeded windows
    (a straggler that persists, then balanced rounds)."""
    rng = np.random.default_rng(3)
    policies = [pkg.RebalancePolicy(threshold=0.05, cooldown=1, confirm=1)
                for pkg in (trebalance, jrebalance)]
    partition = [(1, 12), (13, 24), (25, 36), (37, 48)]
    decisions = [[], []]
    for rnd in range(8):
        slow = 3.0 if rnd < 5 else 1.0
        est = {i: _Estimate(float(rng.uniform(0.9, 1.1)) * (slow if i == 1
                                                            else 1.0),
                            float(rng.uniform(0, 0.05)))
               for i in range(4)}
        for pol, out in zip(policies, decisions):
            prop = pol.consider(partition, est, rnd)
            out.append(None if prop is None else
                       (prop.partition, prop.bottleneck_before_s,
                        prop.bottleneck_after_s))
    assert decisions[0] == decisions[1]
    assert any(d is not None for d in decisions[0])
    assert policies[0].events == policies[1].events


# --- the card's own profiles ------------------------------------------------

H100_FILES = ["profiler_results_vitb.yml", "profiler_results_vitl.yml",
              "models.yml", "device_types.yml", "devices.yml"]


@pytest.mark.parametrize("name", H100_FILES)
def test_h100_profiles_read_the_same(name):
    text = (H100 / name).read_text()
    assert text.startswith("# NVIDIA H100")   # the card and its power limit
    assert miniyaml.loads(text) == yaml.safe_load(text)


def test_h100_profiles_schedule_vit_large(binaries):
    files = [H100 / "models.yml", H100 / "device_types.yml",
             H100 / "devices.yml"]
    port, jax = _both(binaries, "google/vit-large-patch16-224", 8, "float32",
                      files)
    assert port == jax
    hosts = [host for st in port for host in st]
    assert hosts == ["h100-0", "h100-1", "h100-2", "h100-3"]
    covered = [l for st in port for a, b in st.values()
               for l in range(a, b + 1)]
    assert covered == list(range(1, 97))
