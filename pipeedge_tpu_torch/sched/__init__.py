"""Scheduling: cost model mirroring the native scheduler.

The port's copy of `pipeedge_tpu/sched/__init__.py` (the port imports
nothing of the JAX package). Layers are 0-based here, 1-based in the
native scheduler and runtime CLIs (PipeEdge's legacy convention).

Besides float32, bfloat16 and float16 payloads are priced at 2 bytes.
"""
from typing import Union

_DTYPE_BYTES = {
    'torch.float32': 4,
    'float32': 4,
    'torch.bfloat16': 2,
    'bfloat16': 2,
    'torch.float16': 2,
    'float16': 2,
}


def normalize_dtype(dtype: str) -> str:
    """'torch.float32' and 'float32' name the same dtype: PipeEdge-format
    YAML uses torch-style names, the profilers write bare names.
    Mirrors normalize_dtype in native/sched_pipeline_main.cpp."""
    return dtype[len('torch.'):] if dtype.startswith('torch.') else dtype


def _dtype_bytes(dtype: str) -> int:
    """Bytes for a single value of `dtype`."""
    return _DTYPE_BYTES[dtype]


def ubatch_bytes(n_params: int, ubatch_size: int, dtype: str = 'torch.float32') -> int:
    """Bytes required for a microbatch buffer (PipeEdge sched/__init__.py:17-19)."""
    return n_params * ubatch_size * _dtype_bytes(dtype)


def mem_bytes(yml_model: dict, layer_l: int, layer_r: int, dtype: str,
              ubatch_size: int, data_buffers_in: int = 2,
              data_buffers_out: int = 2) -> int:
    """Estimated memory for a complete stage: weights + in/out data buffers +
    processing buffers (PipeEdge sched/__init__.py:22-48). Layers 0-based."""
    assert len(yml_model['mem_MB']) == len(yml_model['parameters_out'])
    assert 0 <= layer_l <= layer_r < len(yml_model['mem_MB'])
    weights = sum(yml_model['mem_MB'][layer_l:layer_r + 1]) * 1024 * 1024
    params_in = yml_model['parameters_in'] if layer_l == 0 else \
        yml_model['parameters_out'][layer_l - 1]
    bytes_in = ubatch_bytes(params_in, ubatch_size, dtype=dtype)
    bytes_out = ubatch_bytes(yml_model['parameters_out'][layer_r], ubatch_size,
                             dtype=dtype)
    buffers = 0
    if layer_l > 0:
        buffers += bytes_in * data_buffers_in   # recv buffer (+ queue)
    buffers += bytes_out * data_buffers_out     # send buffer (+ queue)
    buffers += bytes_in + bytes_out             # processing buffers
    return weights + buffers


def computation_time(yml_model_profile: dict, layer_l: int, layer_r: int) -> float:
    """Seconds to process a layer range (PipeEdge sched/__init__.py:51-57)."""
    time_s = yml_model_profile['time_s']
    assert 0 <= layer_l <= layer_r < len(time_s)
    return sum(time_s[layer_l:layer_r + 1])


def communication_time(yml_device_type: dict, data_bytes: int) -> float:
    """Seconds to transfer `data_bytes` at the device's bandwidth."""
    return communication_time_bw(yml_device_type['bw_Mbps'], data_bytes)


def communication_time_bw(bw_mbits_sec: Union[int, float], data_bytes: int) -> float:
    """Seconds to transfer `data_bytes` at `bw_mbits_sec` Mbit/s
    (PipeEdge sched/__init__.py:60-69: Mb = 1024*1024 bits)."""
    bytes_sec = bw_mbits_sec * 1024 * 1024 / 8
    return data_bytes / bytes_sec
