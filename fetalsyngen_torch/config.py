"""Hydra-compatible YAML config loader + object instantiation (copy of
``fetalsyngen_tpu.config``).

The reference builds its whole object tree from Hydra YAML configs with
``_target_`` keys, ``defaults:`` composition and ``${..key}`` interpolation
(reference: ``configs/dataset/generator/default.yaml``, ``fetalsyngen/test.py:8-12``).
Hydra is not available here, so this module implements the subset the configs
use: recursive ``_target_`` instantiation, relative/absolute interpolation, and
``defaults`` list composition — keeping the reference's YAML schema working
against this framework's classes.

Two changes from the JAX package's module: :func:`instantiate` rewrites a
``_target_`` under ``fetalsyngen_tpu.`` to the same path under
``fetalsyngen_torch.``, so the repository's YAMLs build the port's classes as
they are; and PyYAML is imported by :func:`load_yaml` alone, so the port
imports without it.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Any

_INTERP_RE = re.compile(r"^\$\{([^}]+)\}$")


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str | Path, _root_dir: Path | None = None) -> dict:
    """Load a YAML config, composing any ``defaults:`` list (Hydra-style).

    ``defaults`` entries may be strings (``group/name``) or single-item dicts
    (``{group: name}``); they are resolved relative to the config's directory.
    """
    import yaml

    path = Path(path)
    root = _root_dir or path.parent
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    defaults = cfg.pop("defaults", None)
    if defaults:
        merged: dict = {}
        for entry in defaults:
            if entry == "_self_":
                merged = _deep_merge(merged, cfg)
                cfg = {}
                continue
            if isinstance(entry, dict):
                ((group, name),) = entry.items()
                if name is None:
                    continue
                sub_path = root / str(group) / f"{name}.yaml"
                sub = load_yaml(sub_path)
                keyed = sub
                for part in reversed(str(group).split("/")):
                    keyed = {part: keyed}
                merged = _deep_merge(merged, keyed)
            else:
                # "group/name" nests under the group path (Hydra package
                # semantics); a bare name merges at the root.
                sub_path = root / f"{entry}.yaml"
                sub = load_yaml(sub_path)
                parts = str(entry).split("/")[:-1]
                keyed = sub
                for part in reversed(parts):
                    keyed = {part: keyed}
                merged = _deep_merge(merged, keyed)
        cfg = _deep_merge(merged, cfg)
    return cfg


def _resolve_path(cfg: Any, parts: list[str], stack: list[Any]) -> Any:
    """Resolve an interpolation path like ``..device`` against the node stack."""
    # Count leading empty parts from '..'-style paths: "${..device}" splits to
    # ['', '', 'device'] — each leading '' walks one level up.
    # Leading dots are OmegaConf-relative: one dot = the containing node,
    # each further dot walks one parent up. stack[-1] is the containing node.
    ups = 0
    while ups < len(parts) and parts[ups] == "":
        ups += 1
    if ups:
        node = stack[-ups] if ups <= len(stack) else stack[0]
        keys = parts[ups:]
    else:
        node = stack[0]  # absolute path from root
        keys = parts
    for k in keys:
        node = node[k]
    return node


def resolve_interpolations(cfg: Any) -> Any:
    """Resolve ``${path}`` string interpolations in-place (returns a copy)."""

    def walk(node: Any, stack: list[Any]) -> Any:
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out[k] = walk(v, stack + [node])
            return out
        if isinstance(node, list):
            return [walk(v, stack) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.match(node)
            if m:
                resolved = _resolve_path(cfg, m.group(1).split("."), stack)
                return walk(resolved, stack)
        return node

    return walk(cfg, [])


_JAX_PREFIX = "fetalsyngen_tpu."


def _import_target(target: str):
    if target.startswith(_JAX_PREFIX):
        target = "fetalsyngen_torch." + target[len(_JAX_PREFIX):]
    module_name, _, attr = target.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(cfg: Any, **overrides: Any) -> Any:
    """Recursively instantiate a config node (Hydra ``instantiate`` subset).

    Dicts with a ``_target_`` key become objects (a ``fetalsyngen_tpu.``
    target names the port's class of the same path); other dicts/lists are
    instantiated recursively; scalars pass through.
    """
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" in cfg:
        kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
        kwargs.update(overrides)
        cls = _import_target(cfg["_target_"])
        return cls(**kwargs)
    return {k: instantiate(v) for k, v in cfg.items()}


def load_and_instantiate(path: str | Path, key: str | None = None, **overrides: Any) -> Any:
    """Load a YAML config file, resolve interpolations, and instantiate.

    Args:
        path: Path to the YAML file.
        key: Optional top-level key to instantiate (e.g. ``"dataset"``).
        overrides: Keyword overrides applied to the top-level target.
    """
    cfg = resolve_interpolations(load_yaml(path))
    if key is not None:
        cfg = cfg[key]
    return instantiate(cfg, **overrides)
