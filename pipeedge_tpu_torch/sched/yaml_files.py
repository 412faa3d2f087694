"""Load/save helpers for the scheduler's YAML files.

After `pipeedge_tpu/sched/yaml_files.py`, over the port's `miniyaml`
(the card's host has no PyYAML). Missing files load as empty maps.
"""
import os

from . import miniyaml


def _yaml_load_map(file) -> dict:
    if os.path.exists(file):
        return miniyaml.load(file) or {}
    return {}


def yaml_models_load(file) -> dict:
    """models.yml: model name -> yaml_model."""
    return _yaml_load_map(file)


def yaml_device_types_load(file) -> dict:
    """device_types.yml: device type name -> yaml_device_type."""
    return _yaml_load_map(file)


def yaml_devices_load(file) -> dict:
    """devices.yml: device type name -> list of hosts."""
    return _yaml_load_map(file)


def yaml_device_neighbors_load(file) -> dict:
    """device_neighbors.yml: neighbor host -> yaml_device_neighbors_type."""
    return _yaml_load_map(file)


def yaml_device_neighbors_world_load(file) -> dict:
    """device_neighbors_world.yml: host -> {neighbor host -> link props}."""
    return _yaml_load_map(file)


def yaml_save(yml, file) -> None:
    """Save with leaf lists in flow style (PipeEdge's emitted formats)."""
    miniyaml.dump(yml, file)
