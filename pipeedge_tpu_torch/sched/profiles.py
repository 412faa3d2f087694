"""Bridge from profiler results to the scheduler's YAML input files.

The offline profiler emits one `profiler_results.yml` per (model, dtype,
batch) run; the scheduler consumes two different projections of it:

- `models.yml` — per-model structure: layer count, boundary element counts
  (`parameters_in`/`parameters_out`, the comm-bytes source for the DP
  scheduler's edge costs), per-layer weight memory.
- `device_types.yml` — per-device-type capacity plus (dtype, batch)-keyed
  timing profiles for each model measured on that device type.

This module owns the validation + merge ("upsert") semantics both
converters share (`pipeedge_tpu_torch.profiler_results_to_models` and
`..._to_device_types` are thin argparse shims over it). The port's copy
of `pipeedge_tpu/sched/profiles.py`, over `miniyaml` in place of PyYAML.
"""
import dataclasses
import math
from typing import List, Optional, Sequence

from . import miniyaml, normalize_dtype, yaml_files, yaml_types


class ProfileError(Exception):
    """A profiler-results file is inconsistent or a merge would clobber."""


@dataclasses.dataclass(frozen=True)
class ProfilerResults:
    """A parsed, validated profiler_results.yml."""
    model_name: str
    dtype: str
    batch_size: int
    layers: int
    profile_data: List[dict]

    @classmethod
    def load(cls, path: str, known_layer_counts=None) -> "ProfilerResults":
        """Read + validate a results file.

        `known_layer_counts`: optional callable name -> expected layer count
        (the model registry); a mismatch or unknown model only warns, since
        profiles for models outside the registry are legitimate.
        """
        raw = miniyaml.load(path)
        res = cls(model_name=raw["model_name"], dtype=raw["dtype"],
                  batch_size=raw["batch_size"], layers=raw["layers"],
                  profile_data=list(raw["profile_data"]))
        if not res.profile_data:
            raise ProfileError(f"{path}: empty profile data")
        if res.layers != len(res.profile_data):
            raise ProfileError(
                f"{path}: declared layer count {res.layers} != "
                f"{len(res.profile_data)} profile records")
        if known_layer_counts is not None:
            try:
                expected = known_layer_counts(res.model_name)
            except (KeyError, ValueError):
                print(f"Warning: layer count unverifiable for model outside "
                      f"the registry: {res.model_name}: {res.layers}")
            else:
                if expected != res.layers:
                    print(f"Warning: registry expects {expected} layers for "
                          f"{res.model_name}, profile has {res.layers}")
        return res

    # -- projections -------------------------------------------------------

    def model_entry(self) -> dict:
        """models.yml record: boundary element counts from recorded shapes."""
        def elements(shapes: Sequence[Sequence[int]]) -> int:
            return sum(math.prod(s) for s in shapes)

        return yaml_types.yaml_model(
            self.layers,
            elements(self.profile_data[0]["shape_in"]),
            [elements(rec["shape_out"]) for rec in self.profile_data],
            [rec["memory"] for rec in self.profile_data])

    def timing_profile(self) -> dict:
        """device_types.yml model-profile record (dtype+batch keyed)."""
        return yaml_types.yaml_model_profile(
            self.dtype, self.batch_size,
            [rec["time"] for rec in self.profile_data])

    def matches_profile(self, profile: dict) -> bool:
        """Whether `profile` carries this run's unique (dtype, batch) key.
        dtype compares normalized, so 'float32' == 'torch.float32'."""
        return (normalize_dtype(profile["dtype"]) == normalize_dtype(self.dtype)
                and profile["batch_size"] == self.batch_size)


# ---------------------------------------------------------------------------
# Live-measurement ingestion: measured stage timings -> profiler_results.yml

def results_from_measured(model_name: str, dtype: str, batch_size: int,
                          total_layers: int,
                          partition: Sequence[Sequence[int]],
                          stage_times_s: Sequence[float]) -> dict:
    """A profiler_results.yml-shaped record built from MEASURED per-stage
    runtime timings instead of the offline profiler: stage i's per-microbatch seconds spread uniformly
    over its `[l, r]` layer range — the per-layer resolution a per-stage
    measurement supports.

    Only the `time` series carries live data; `shape_in`/`shape_out`/
    `memory` are zeroed placeholders, so the record feeds
    `upsert_device_type` (timing profiles, what offline re-scheduling
    needs) but NOT `upsert_model` (structure comes from the static
    profiler's models.yml). `ProfilerResults.load` reads the file back.
    """
    from . import rebalance

    partition = [tuple(map(int, lr)) for lr in partition]
    try:
        # one owner for the partition contract + uniform spreading: the
        # runtime rebalancer and this offline path must always agree on
        # what a valid partition is
        per_layer = rebalance.spread_layer_costs(partition, stage_times_s)
    except ValueError as exc:
        raise ProfileError(str(exc)) from exc
    if len(per_layer) != total_layers:
        raise ProfileError(f"partition {partition} covers {len(per_layer)} "
                           f"layers, model has {total_layers}")
    profile_data = [{"time": t, "shape_in": [[0]], "shape_out": [[0]],
                     "memory": 0.0} for t in per_layer]
    return {"model_name": model_name, "dtype": dtype,
            "batch_size": int(batch_size), "layers": int(total_layers),
            "profile_data": profile_data}


def save_measured_profiles(path: str, record: dict) -> None:
    """Write a `results_from_measured` record as profiler_results.yml."""
    miniyaml.dump(record, path)


# ---------------------------------------------------------------------------
# Merge operations (each loads, upserts one record, saves)

def upsert_model(path: str, results: ProfilerResults,
                 overwrite: bool = False) -> None:
    """Merge the results' model entry into a models.yml file."""
    models = yaml_files.yaml_models_load(path)
    if results.model_name in models and not overwrite:
        raise ProfileError(f"model already exists: {path}: "
                           f"{results.model_name} (use overwrite)")
    models[results.model_name] = results.model_entry()
    yaml_files.yaml_save(models, path)


def upsert_device_type(path: str, dev_type: str, results: ProfilerResults,
                       mem_MB: Optional[float] = None,
                       bw_Mbps: Optional[float] = None,
                       overwrite: bool = False) -> None:
    """Merge the results' timing profile into a device_types.yml file.

    Creating a new device type requires mem_MB + bw_Mbps; an existing type's
    capacity values must not silently change (pass them identical or None).
    """
    device_types = yaml_files.yaml_device_types_load(path)
    entry = device_types.get(dev_type)
    if entry is None:
        if mem_MB is None or bw_Mbps is None:
            raise ProfileError(
                f"new device type {dev_type}: memory and bandwidth required")
        entry = yaml_types.yaml_device_type(mem_MB, bw_Mbps, {})
        device_types[dev_type] = entry
    else:
        for key, given in (("mem_MB", mem_MB), ("bw_Mbps", bw_Mbps)):
            if given is not None and entry[key] != given:
                raise ProfileError(
                    f"device type {dev_type} {key} mismatch: "
                    f"{entry[key]} != {given}")
        if entry.get("model_profiles") is None:
            entry["model_profiles"] = {}

    profiles = entry["model_profiles"].setdefault(results.model_name, [])
    fresh = results.timing_profile()
    slot = next((i for i, p in enumerate(profiles)
                 if results.matches_profile(p)), None)
    if slot is None:
        profiles.append(fresh)
    elif overwrite:
        print(f"Overwriting model profile: {path}: {dev_type}: "
              f"{results.model_name}: {profiles[slot]}")
        profiles[slot] = fresh
    else:
        raise ProfileError(
            f"model profile already exists: {path}: {dev_type}: "
            f"{results.model_name}: {profiles[slot]} (use overwrite)")
    yaml_files.yaml_save(device_types, path)
