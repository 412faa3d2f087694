"""CLI: project a profiler results file into a scheduler models.yml.

    python -m pipeedge_tpu_torch.profiler_results_to_models \\
        -i profiler_results.yml -o models.yml

A thin shim over `sched/profiles.py`, with the flags and the output of
the root `profiler_results_to_models.py`.
"""
import argparse
import sys
from typing import Optional, Sequence

from .models import registry
from .sched import profiles


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Produce scheduler-compatible models YAML file from "
                    "profiling results",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--results-yml", default="profiler_results.yml",
                        help="profiler results input YAML file")
    parser.add_argument("-o", "--models-yml", default="models.yml",
                        help="models output YAML file")
    parser.add_argument("-f", "--overwrite", action="store_true",
                        help="overwrite existing YAML model entries")
    args = parser.parse_args(argv)

    try:
        results = profiles.ProfilerResults.load(
            args.results_yml, known_layer_counts=registry.get_model_layers)
        profiles.upsert_model(args.models_yml, results,
                              overwrite=args.overwrite)
    except profiles.ProfileError as exc:
        print(exc)
        sys.exit(1)


if __name__ == "__main__":
    main()
