"""Schemas for the scheduler's YAML data interchange.

The port's copy of `pipeedge_tpu/sched/yaml_types.py`. The emitted dict
shapes are the interop contract shared with the native `sched-pipeline`
binary (PipeEdge's models.yml / device_types.yml / device_neighbors*.yml
formats, its README_Scheduler.md). Each `yaml_*` constructor validates
its inputs (raising TypeError on schema violations) and returns a plain
dict ready for `miniyaml.dump`.
"""
from typing import List, Optional, Union

Scalar = Union[int, float]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise TypeError(f"yaml schema: {what}")


def _number_series(xs, what: str) -> List[Scalar]:
    _require(isinstance(xs, list), f"{what} must be a list")
    _require(all(isinstance(x, (int, float)) for x in xs),
             f"{what} entries must be numbers")
    return list(xs)


def yaml_model(num_layers: int, parameters_in: int, parameters_out: List[int],
               mem_MB: List[Scalar]) -> dict:
    """A models.yml record: layer count, boundary element counts, per-layer
    weight memory. `parameters_out[i]` (elements flowing out of layer i) is
    the scheduler's comm-bytes source."""
    _require(isinstance(num_layers, int), "layers must be int")
    _require(isinstance(parameters_in, int), "parameters_in must be int")
    _require(isinstance(parameters_out, list)
             and all(isinstance(p, int) for p in parameters_out),
             "parameters_out must be a list of int")
    return {
        'layers': num_layers,
        'parameters_in': parameters_in,
        'parameters_out': list(parameters_out),
        'mem_MB': _number_series(mem_MB, "mem_MB"),
    }


def yaml_model_profile(dtype: str, batch_size: int,
                       time_s: List[Scalar]) -> dict:
    """A device type's timing profile for one model; (dtype, batch_size) is
    the unique key within a model's profile list."""
    _require(isinstance(dtype, str), "dtype must be str")
    _require(isinstance(batch_size, int), "batch_size must be int")
    return {
        'dtype': dtype,
        'batch_size': batch_size,
        'time_s': _number_series(time_s, "time_s"),
    }


def yaml_device_type(mem_MB: Scalar, bw_Mbps: Scalar,
                     model_profiles: Optional[dict]) -> dict:
    """A device_types.yml record: capacity plus per-model timing profiles."""
    _require(isinstance(mem_MB, (int, float)), "mem_MB must be a number")
    _require(isinstance(bw_Mbps, (int, float)), "bw_Mbps must be a number")
    _require(model_profiles is None or isinstance(model_profiles, dict),
             "model_profiles must be a dict")
    return {
        'mem_MB': mem_MB,
        'bw_Mbps': bw_Mbps,
        'model_profiles': dict(model_profiles or {}),
    }


def yaml_device_neighbors_type(bw_Mbps: Scalar) -> dict:
    """A neighbor-link record (extensible: today just bandwidth)."""
    _require(isinstance(bw_Mbps, (int, float)), "bw_Mbps must be a number")
    return {'bw_Mbps': bw_Mbps}


def yaml_device_neighbors(neighbors: List[str],
                          bws_Mbps: List[Scalar]) -> dict:
    """A host's neighbor map: neighbor name -> link record."""
    _require(isinstance(neighbors, list)
             and all(isinstance(n, str) for n in neighbors),
             "neighbors must be a list of str")
    _number_series(bws_Mbps, "bws_Mbps")
    return {name: yaml_device_neighbors_type(bw)
            for name, bw in zip(neighbors, bws_Mbps)}
