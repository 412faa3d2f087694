"""Cut a model's npz weights into per-stage checkpoints.

The counterpart of the repository's `tools/convert_checkpoint.py`: one
directory per pipeline stage of `-pt`, each holding the npz keys its
stage's parameters are built from, beside a manifest of the model and the
partition (`utils/checkpoint.py save_stage_checkpoints`; the JAX tool
writes Orbax directories). A `runtime -c dcn --stage-ckpt DIR` rank then
reads its own stage and nothing else:

    python -m pipeedge_tpu_torch.convert_checkpoint -m MODEL -M weights.npz \\
        -pt 1,24,25,48 -o ckpts/

Each stage prints `stage I [L, R] -> DIR`, as the JAX tool logs it.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional, Sequence

from .models import registry
from .utils import checkpoint as ckpt

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="npz -> per-stage checkpoints",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-m", "--model-name", required=True,
                        choices=registry.get_model_names())
    parser.add_argument("-M", "--model-file", default=None,
                        help="npz weights (default: the model's default file)")
    parser.add_argument("-pt", "--partition", required=True,
                        help="comma-delimited layer pairs, e.g. '1,24,25,48'")
    parser.add_argument("-o", "--output-dir", required=True)
    args = parser.parse_args(argv)
    nums = [int(x) for x in args.partition.split(",")]
    if len(nums) % 2:
        parser.error("partition must be layer pairs")
    args.partition = list(zip(nums[::2], nums[1::2]))
    return args


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Write the stage checkpoints; returns their directories."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(message)s")
    args = parse_args(argv)
    npz = args.model_file or registry.get_model_entry(
        args.model_name).weights_file
    dirs = ckpt.save_stage_checkpoints(args.model_name, npz,
                                       args.output_dir, args.partition)
    for i, d in enumerate(dirs):
        logger.info("stage %d [%d, %d] -> %s", i, *args.partition[i], d)
    return dirs


if __name__ == "__main__":
    main()
