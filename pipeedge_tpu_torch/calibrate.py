"""Offline int8 calibration: sweep batches through a shard, write the
scale sidecar next to the checkpoint.

    python -m pipeedge_tpu_torch.calibrate -m google/vit-base-patch16-224 \\
        --batch 8 --batches 2 --out vitb.int8scales.npz

The port's counterpart of `tools/calibrate.py`, with the same flags plus
`--device` (default `cuda`; `cpu` runs the plain versions). Prints one
JSON line with the per-tag alphas and where the sidecar landed. Serving
paths load it back with `utils.calibrate.quantize_compute_from_sidecar`
and install it with `models.layers.set_quantize_compute`.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .models import registry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", default="pipeedge/test-tiny-vit",
                    choices=registry.get_model_names())
    ap.add_argument("--model-file", default=None,
                    help="checkpoint npz (default: the registry's; the "
                         "sidecar lands next to it)")
    ap.add_argument("--layer-start", type=int, default=1)
    ap.add_argument("--layer-end", type=int, default=0,
                    help="0 = all layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2,
                    help="calibration batches swept through the shard")
    ap.add_argument("--bit", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="sidecar path (default: <model-file>.int8scales"
                         ".npz, or ./<model>.int8scales.npz without a "
                         "checkpoint)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain versions")
    args = ap.parse_args(argv)

    import numpy as np

    from .utils import calibrate

    cfg = registry.get_model_config(args.model)
    layer_end = args.layer_end or registry.get_model_layers(args.model)
    rng = np.random.default_rng(args.seed)
    batches = [np.asarray(rng.normal(size=(
        args.batch, cfg.num_channels, cfg.image_size, cfg.image_size)),
        np.float32) for _ in range(args.batches)]

    alphas, wscales, stats = calibrate.calibrate_shard(
        args.model, args.model_file, args.layer_start, layer_end,
        batches, bit=args.bit, device=args.device)

    out = args.out
    if out is None:
        base = args.model_file or registry.get_model_entry(
            args.model).weights_file or args.model.replace("/", "_")
        out = calibrate.sidecar_path(base)
    calibrate.write_sidecar(out, alphas, wscales, meta={
        "model": args.model, "bit": args.bit, "batch": args.batch,
        "batches": args.batches, "seed": args.seed,
        "layers": [args.layer_start, layer_end]})

    print(json.dumps({
        "bench": "calibrate", "model": args.model, "sidecar": out,
        "bit": args.bit,
        "alphas": {t: round(a, 6) for t, a in sorted(alphas.items())},
        "amax": {t: round(s.amax, 6) for t, s in sorted(stats.items())},
        "weight_scale_tensors": len(wscales),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
