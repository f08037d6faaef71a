"""YAML config system: a copy of ``splatloc_tpu.cli.config`` (the port
imports nothing of the JAX package). The reference schema with recursive
``inherit_from`` merging (utils/config_utils.py:4-50), plus an
attribute-dict wrapper replacing munch. The ``tpu:`` section of the shipped
configs is read and ignored by the port.
"""
from __future__ import annotations

import functools
import os

import yaml


class AttrDict(dict):
    """dict with attribute access (munchify replacement)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return AttrDict(v) if isinstance(v, dict) else v

    def __setattr__(self, k, v):
        self[k] = v


def merge_configs(base: dict, override: dict) -> dict:
    """Pure deep-merge: a new dict where mapping-valued overrides merge
    key-by-key into the base value and everything else replaces it.
    Neither input is mutated."""
    merged = dict(base)
    for key, value in override.items():
        if isinstance(value, dict):
            below = merged.get(key)
            merged[key] = merge_configs(
                below if isinstance(below, dict) else {}, value)
        else:
            merged[key] = value
    return merged


def _read_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.full_load(f) or {}


def _inheritance_chain(path: str) -> list[dict]:
    """Root-first list of raw config dicts along the ``inherit_from``
    chain starting at ``path`` (leaf). Inherit paths are repo-relative in
    the shipped configs; a path relative to the including file works too.
    Cycles are detected and rejected."""
    chain, visited = [], set()
    while path is not None:
        real = os.path.realpath(path)
        if real in visited:
            raise ValueError(f"inherit_from cycle through {path}")
        visited.add(real)
        cfg = _read_yaml(path)
        chain.append(cfg)
        parent = cfg.get("inherit_from")
        if parent is not None and not os.path.exists(parent):
            sibling = os.path.join(os.path.dirname(path), parent)
            if os.path.exists(sibling):
                parent = sibling
        path = parent
    return chain[::-1]


def load_config(path: str, default_path: str | None = None) -> dict:
    """Merged config for ``path``: the ``inherit_from`` chain folded
    root-first through :func:`merge_configs`; ``default_path`` (if given)
    seeds the fold below the chain root."""
    layers = _inheritance_chain(path)
    if default_path is not None:
        layers.insert(0, _read_yaml(default_path))
    return functools.reduce(merge_configs, layers, {})


def save_dir_for(config: dict) -> str:
    """Reference save-dir layout (train_gaussians.py:370-380)."""
    path = config["Dataset"]["dataset_path"].rstrip("/").split("/")
    base = config["Results"]["save_dir"]
    if config["Dataset"]["type"] == "replica":
        return os.path.join(base, path[-2], path[-1])
    if config["Dataset"]["type"] == "12scenes":
        return os.path.join(base, path[-3], path[-2] + "_" + path[-1])
    raise ValueError("Dataset type should be replica or 12scenes")
