"""CLI: merge a profiler results file into a scheduler device_types.yml.

    python -m pipeedge_tpu_torch.profiler_results_to_device_types h100 \\
        -i profiler_results.yml -o device_types.yml -dtm 81559 -dtb 3433227

A thin shim over `sched/profiles.py`, with the flags and the output of
the root `profiler_results_to_device_types.py`: the (dtype, batch_size)
pair keys a device type's model profiles; `-dtm` is memory in MiB and
`-dtb` bandwidth in Mbit/s (Mb = 2^20 bits), both needed to create a type.
"""
import argparse
import sys
from typing import Optional, Sequence

from .models import registry
from .sched import profiles


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Produce scheduler-compatible device types YAML file "
                    "from profiling results",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("dev_type", help="device type name")
    parser.add_argument("-i", "--results-yml", default="profiler_results.yml",
                        help="profiler results input YAML file")
    parser.add_argument("-o", "--dev-types-yml", default="device_types.yml",
                        help="device types output YAML file")
    parser.add_argument("-dtm", "--dev-type-mem", type=int,
                        help="memory in MB (required if not already in "
                             "DEV_TYPES_YML)")
    parser.add_argument("-dtb", "--dev-type-bw", type=int,
                        help="bandwidth in Mbps (required if not already in "
                             "DEV_TYPES_YML)")
    parser.add_argument("-f", "--overwrite", action="store_true",
                        help="overwrite existing YAML device type model "
                             "profile entries")
    args = parser.parse_args(argv)

    try:
        results = profiles.ProfilerResults.load(
            args.results_yml, known_layer_counts=registry.get_model_layers)
        profiles.upsert_device_type(
            args.dev_types_yml, args.dev_type, results,
            mem_MB=args.dev_type_mem, bw_Mbps=args.dev_type_bw,
            overwrite=args.overwrite)
    except profiles.ProfileError as exc:
        print(exc)
        sys.exit(1)


if __name__ == "__main__":
    main()
