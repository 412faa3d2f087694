"""Per-stage checkpoints: one npz per pipeline stage, with a manifest.

Port of the per-stage half of `pipeedge_tpu/utils/checkpoint.py`. The
JAX package writes each stage as an Orbax checkpoint; the port writes
each stage as an npz that holds exactly the keys of the model's npz
archive that the stage's parameters are built from, so a DCN rank
(`runtime.py --stage-ckpt DIR`) reads its own stage and nothing else.
`manifest.json` beside the stage files records the model and the
partition they were cut for, and a rank refuses a checkpoint cut for
another partition.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_PARAMS = "params.npz"


class _KeyRecorder(Mapping):
    """A read-only view of an npz archive that records the keys read."""

    def __init__(self, weights: Mapping):
        self._weights = weights
        self.keys_read: List[str] = []

    def __getitem__(self, key):
        value = self._weights[key]
        self.keys_read.append(key)
        return value

    def __iter__(self):
        return iter(self._weights)

    def __len__(self):
        return len(self._weights)

    def __contains__(self, key):
        return key in self._weights


def stage_dir(root: str, stage: int) -> str:
    return os.path.join(os.path.abspath(root), f"stage_{stage:03d}")


def save_stage_checkpoints(model_name: str, npz_path: str, out_root: str,
                           partition: Sequence[Tuple[int, int]]
                           ) -> List[str]:
    """Slice a model's npz archive into one npz per stage of `partition`
    (the keys `module_shard_factory` reads for that stage's layers) and
    write the manifest. Returns the stage directories."""
    from ..models import registry

    entry = registry.get_model_entry(model_name)
    dirs = []
    with np.load(npz_path) as weights:
        for i, (l, r) in enumerate(partition):
            sc = registry.make_shard_config(model_name, l, r)
            rec = _KeyRecorder(weights)
            entry.family.load_params(entry.config, sc, rec)
            d = stage_dir(out_root, i)
            os.makedirs(d, exist_ok=True)
            np.savez(os.path.join(d, _PARAMS),
                     **{k: weights[k] for k in dict.fromkeys(rec.keys_read)})
            dirs.append(d)
    with open(os.path.join(os.path.abspath(out_root), _MANIFEST), "w",
              encoding="utf8") as f:
        json.dump({"model_name": model_name,
                   "partition": [list(p) for p in partition]}, f)
    return dirs


def read_manifest(out_root: str) -> Optional[Dict]:
    """The {model_name, partition} manifest written next to the stage dirs
    (None when there is none)."""
    path = os.path.join(os.path.abspath(out_root), _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf8") as f:
        return json.load(f)


def check_stage_compatible(out_root: str, model_name: str, stage: int,
                           layer_range: Tuple[int, int]) -> None:
    """Raise if the checkpoint's partition disagrees with the runtime
    schedule: a stage-index restore with a shifted partition would
    otherwise load the wrong layers' weights silently."""
    manifest = read_manifest(out_root)
    if manifest is None:
        return
    if manifest["model_name"] != model_name:
        raise ValueError(
            f"stage checkpoint {out_root} is for model "
            f"{manifest['model_name']!r}, not {model_name!r}")
    saved = [tuple(p) for p in manifest["partition"]]
    if stage >= len(saved) or saved[stage] != tuple(layer_range):
        raise ValueError(
            f"stage {stage} layer range {tuple(layer_range)} does not match "
            f"checkpoint partition {saved} (re-cut the checkpoint with the "
            f"runtime partition)")


def load_stage_checkpoint(out_root: str, stage: int,
                          dtype=torch.float32) -> Dict:
    """Stage `stage`'s parameters (on the CPU, in `dtype`), built from its
    npz as `module_shard_factory` builds them from the whole archive."""
    from ..models import registry

    manifest = read_manifest(out_root)
    if manifest is None:
        raise ValueError(f"stage checkpoint {out_root} has no "
                         f"{_MANIFEST}")
    model_name = manifest["model_name"]
    l, r = manifest["partition"][stage]
    entry = registry.get_model_entry(model_name)
    sc = registry.make_shard_config(model_name, l, r)
    with np.load(os.path.join(stage_dir(out_root, stage), _PARAMS)) as w:
        return entry.family.load_params(entry.config, sc, w, dtype=dtype)
