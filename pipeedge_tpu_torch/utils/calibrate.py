"""Offline per-tag calibration for the int8 compute path.

Port of `pipeedge_tpu/utils/calibrate.py`. Sweeps calibration batches
through a shard with an observer installed on the tagged denses
(models/layers.py `_QC_OBSERVER`), aggregates per-tag activation moments,
and derives Banner-optimal clip thresholds from `ops/clamp.py`'s factors:
tagged activations are taken as near-Laplace (alpha = W(3*4^b) *
sqrt(var/2)), except the MLP-down input, which is post-GeLU (half bell
curve, alpha = W(3*4^(b+1)) * sqrt(E[x^2])).

The result is a scale sidecar written next to the checkpoint
(`<ckpt>.int8scales.npz`): per-tag clamp alphas (`alpha/<tag>`) plus
per-channel weight scales (`wscale/<path>`) for every dense of the shard,
and a JSON `meta` record. The layout and the weight paths
(`blocks/<i>/<name>`) are those of the JAX package, so a sidecar written
by either package loads in the other. `quantize_compute_from_sidecar`
turns a sidecar into the `QuantizeCompute` config whose alphas clip the
int8 matmul's inputs (ops/int8_matmul.int8_dense).

PyTorch runs eagerly, so the observer always sees data; the moments are
summed in float64 on the activations' own device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..models import layers
from ..ops.clamp import clamp_factor_gelu, clamp_factor_laplace

# tags whose observed input is post-GeLU (half bell curve): everything
# else calibrates with the Laplace factor
GELU_TAGS = ("mlp.down",)


@dataclasses.dataclass
class TagStats:
    """Running activation moments for one dense tag across calibration
    batches (and across blocks: all blocks share a tag, so one alpha
    serves the whole shard, like the wire clamp)."""
    amax: float = 0.0
    sum_sq: float = 0.0
    sum_: float = 0.0
    count: int = 0

    def update(self, x) -> None:
        xf = torch.as_tensor(x).detach().to(torch.float32)
        x64 = xf.to(torch.float64)
        self.amax = max(self.amax, float(xf.abs().max()))
        self.sum_sq += float((x64 * x64).sum())
        self.sum_ += float(x64.sum())
        self.count += xf.numel()

    @property
    def var(self) -> float:
        if not self.count:
            return 0.0
        mean = self.sum_ / self.count
        return max(self.sum_sq / self.count - mean * mean, 0.0)

    @property
    def second_moment(self) -> float:
        return self.sum_sq / self.count if self.count else 0.0


def collect_activation_stats(run_fn: Callable, params,
                             batches: Iterable) -> Dict[str, TagStats]:
    """Run `run_fn(params, batch)` for each calibration batch with the tag
    observer installed; returns per-tag running stats."""
    stats: Dict[str, TagStats] = {}

    def observer(tag: str, x) -> None:
        stats.setdefault(tag, TagStats()).update(x)

    prev = layers._QC_OBSERVER
    layers._QC_OBSERVER = observer
    try:
        for batch in batches:
            run_fn(params, batch)
    finally:
        layers._QC_OBSERVER = prev
    if not stats:
        raise RuntimeError("calibration saw no tagged denses: the model "
                           "family has no int8-routable layers")
    return stats


def compute_alphas(stats: Mapping[str, TagStats],
                   bit: int = 8) -> Dict[str, float]:
    """Banner-optimal clip threshold per tag (ops/clamp.py factors)."""
    alphas: Dict[str, float] = {}
    for tag, st in stats.items():
        if tag in GELU_TAGS:
            alpha = clamp_factor_gelu(bit) * float(
                np.sqrt(st.second_moment))
        else:
            alpha = clamp_factor_laplace(bit) * float(
                np.sqrt(0.5 * st.var))
        # never clip tighter than half the observed amax: a degenerate
        # calibration batch cannot zero a layer out
        alphas[tag] = max(alpha, 0.5 * st.amax) if st.amax else 1.0
    return alphas


def weight_channel_scales(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Per-output-channel int8 scales for every dense `{w, b}` dict in a
    shard's parameters, keyed by slash-joined path."""
    from ..ops.int8_matmul import quantize_weight

    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            if "w" in node and getattr(node["w"], "ndim", 0) == 2:
                out[path] = quantize_weight(node["w"])[1].cpu().numpy()
                return
            for key, sub in node.items():
                walk(sub, f"{path}/{key}" if path else str(key))
        elif isinstance(node, (tuple, list)):
            for i, sub in enumerate(node):
                walk(sub, f"{path}/{i}" if path else str(i))

    walk(params, prefix)
    return out


def sidecar_path(model_file: str) -> str:
    """The sidecar lives next to the checkpoint it calibrates."""
    return model_file + ".int8scales.npz"


def write_sidecar(path: str, alphas: Mapping[str, float],
                  wscales: Mapping[str, np.ndarray],
                  meta: Optional[dict] = None) -> None:
    arrays = {f"alpha/{tag}": np.float32(a) for tag, a in alphas.items()}
    arrays.update({f"wscale/{k}": np.asarray(v, np.float32)
                   for k, v in wscales.items()})
    arrays["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_sidecar(path: str) -> dict:
    """Inverse of `write_sidecar`: {'alphas': {...}, 'weight_scales':
    {...}, 'meta': {...}}."""
    with np.load(path) as z:
        alphas = {k[len("alpha/"):]: float(z[k]) for k in z.files
                  if k.startswith("alpha/")}
        wscales = {k[len("wscale/"):]: z[k] for k in z.files
                   if k.startswith("wscale/")}
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files \
            else {}
    return {"alphas": alphas, "weight_scales": wscales, "meta": meta}


def quantize_compute_from_sidecar(
        path: str, skip_tags: Iterable[str] = (),
        block_k: int = 128, tunnel: bool = False) -> layers.QuantizeCompute:
    """Build the runtime config from a calibration sidecar."""
    side = load_sidecar(path)
    return layers.QuantizeCompute(
        enabled=True, block_k=block_k, skip_tags=frozenset(skip_tags),
        clamp_alphas=dict(side["alphas"]), tunnel=tunnel)


def calibrate_shard(model_name: str, model_file: Optional[str],
                    layer_start: int, layer_end: int,
                    batches: List, bit: int = 8,
                    device: DeviceLike = None):
    """One-call calibration: build the shard on `device` (default `cuda`),
    sweep the batches (numpy arrays or tensors), return (alphas,
    weight_scales, stats)."""
    from ..models import registry

    dev = resolve_device(device)
    fn, params, _ = registry.module_shard_factory(
        model_name, model_file, layer_start, layer_end, device=dev)
    stats = collect_activation_stats(
        fn, params, (torch.as_tensor(b).to(dev) for b in batches))
    alphas = compute_alphas(stats, bit=bit)
    wscales = weight_channel_scales(params)
    return alphas, wscales, stats
