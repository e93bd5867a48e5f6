"""Versioned JSON schema for every ``BENCH_*.json`` artifact of the port.

The reference's ``repro.evalsuite.schema``: the same built-in validator
(a subset of JSON Schema: ``type``, ``required``, ``properties``,
``items``, ``enum``, ``const``, ``minimum``, ``minItems``; unknown keys
allowed, unknown schema keywords a programming error), the same four
schemas and the same ``SCHEMA_VERSION``, so each package's validator
accepts the other's documents.

Every artifact carries ``schema_version`` and is validated before it is
written (and again by the gate before it is trusted):

* :data:`ENVELOPE_SCHEMA` — the shared envelope: a bench name, the host
  context and a list of row dicts.
* :data:`SUITE_SCHEMA` — the full ``BENCH_suite`` contract: dataset specs
  with ``f_star``, one row per (dataset, method, seed) run, one
  aggregated cell per (dataset, method).

:func:`host_info` records the device the run used: ``backend``
(``"cuda"`` or ``"cpu"``), ``device`` (the card's name, or ``"cpu"``),
``power_limit`` (from ``nvidia-smi`` on the card) and ``cpu_count``.  The
host schema requires ``xla_devices``, so that key is kept and holds the
number of devices the run used: a departure in name only.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Any

SCHEMA_VERSION = "repro.bench/1"

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "integer": int,
    "null": type(None),
}

_KEYWORDS = {
    "type", "required", "properties", "items", "enum", "const",
    "minimum", "minItems",
    # documentation-only keywords, ignored by the validator
    "$id", "description", "title",
}


def _type_ok(value: Any, expected: str) -> bool:
    if expected == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if expected == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, _TYPES[expected])


def validate(doc: Any, schema: dict, path: str = "$") -> list[str]:
    """Validate ``doc`` against ``schema``; return a list of error strings
    (empty = valid).  Supports the subset documented in the module header."""
    unknown = set(schema) - _KEYWORDS
    if unknown:
        raise ValueError(f"unsupported schema keywords at {path}: {unknown}")
    errors: list[str] = []

    if "const" in schema and doc != schema["const"]:
        errors.append(f"{path}: expected {schema['const']!r}, got {doc!r}")
    if "enum" in schema and doc not in schema["enum"]:
        errors.append(f"{path}: {doc!r} not in {schema['enum']!r}")

    expected = schema.get("type")
    if expected is not None:
        types = expected if isinstance(expected, list) else [expected]
        if not any(_type_ok(doc, t) for t in types):
            errors.append(
                f"{path}: expected type {expected}, got "
                f"{type(doc).__name__} ({doc!r:.60})")
            return errors          # downstream keywords assume the type

    if isinstance(doc, dict):
        for field in schema.get("required", ()):
            if field not in doc:
                errors.append(f"{path}: missing required field {field!r}")
        for field, sub in schema.get("properties", {}).items():
            if field in doc:
                errors.extend(validate(doc[field], sub, f"{path}.{field}"))

    if isinstance(doc, list):
        if "minItems" in schema and len(doc) < schema["minItems"]:
            errors.append(
                f"{path}: expected >= {schema['minItems']} items, "
                f"got {len(doc)}")
        if "items" in schema:
            for i, item in enumerate(doc):
                errors.extend(validate(item, schema["items"], f"{path}[{i}]"))

    if "minimum" in schema and _type_ok(doc, "number"):
        if doc < schema["minimum"]:
            errors.append(f"{path}: {doc!r} < minimum {schema['minimum']!r}")

    return errors


def check(doc: Any, schema: dict, what: str = "document") -> None:
    """Raise ``ValueError`` with every validation error if ``doc`` is invalid."""
    errors = validate(doc, schema)
    if errors:
        raise ValueError(
            f"{what} failed schema validation ({len(errors)} error(s)):\n  "
            + "\n  ".join(errors))


_HOST_SCHEMA = {
    "type": "object",
    "required": ["cpu_count", "xla_devices"],
    "properties": {
        "cpu_count": {"type": ["integer", "null"]},
        "xla_devices": {"type": "integer", "minimum": 1},
    },
}

# The shared envelope: what every BENCH_*.json must carry so artifacts can
# be discovered, attributed to a host, and diffed mechanically.
ENVELOPE_SCHEMA = {
    "$id": "repro.bench.envelope/1",
    "type": "object",
    "required": ["schema_version", "bench", "host", "rows"],
    "properties": {
        "schema_version": {"const": SCHEMA_VERSION},
        "bench": {"type": "string"},
        "host": _HOST_SCHEMA,
        "rows": {"type": "array", "items": {"type": "object"}},
    },
}

_DATASET_SCHEMA = {
    "type": "object",
    "required": ["name", "paper_name", "m", "n", "k", "s", "n_chunks",
                 "f_star"],
    "properties": {
        "name": {"type": "string"},
        "paper_name": {"type": "string"},
        "m": {"type": "integer", "minimum": 1},
        "n": {"type": "integer", "minimum": 1},
        "k": {"type": "integer", "minimum": 1},
        "s": {"type": "integer", "minimum": 1},
        "n_chunks": {"type": "integer", "minimum": 1},
        "f_star": {"type": ["number", "null"]},
    },
}

_ROW_SCHEMA = {
    "type": "object",
    "required": ["dataset", "method", "seed", "f_full", "epsilon",
                 "success", "wall_s"],
    "properties": {
        "dataset": {"type": "string"},
        "method": {"type": "string"},
        "kind": {"enum": ["bigmeans", "baseline"]},
        "seed": {"type": "integer"},
        "f_full": {"type": "number"},
        "epsilon": {"type": "number"},
        "success": {"type": "boolean"},
        "wall_s": {"type": "number", "minimum": 0},
        "n_chunks": {"type": "integer"},
        "n_iterations": {"type": "integer"},
        "n_accepted": {"type": "integer"},
    },
}

_CELL_SCHEMA = {
    "type": "object",
    "required": ["dataset", "method", "kind", "n_seeds", "epsilon_mean",
                 "epsilon_min", "epsilon_max", "success_rate",
                 "wall_mean_s", "time_to_target"],
    "properties": {
        "dataset": {"type": "string"},
        "method": {"type": "string"},
        "kind": {"enum": ["bigmeans", "baseline"]},
        "n_seeds": {"type": "integer", "minimum": 1},
        "epsilon_mean": {"type": "number"},
        "epsilon_min": {"type": "number"},
        "epsilon_max": {"type": "number"},
        "success_rate": {"type": "number", "minimum": 0},
        "wall_mean_s": {"type": "number", "minimum": 0},
        "time_to_target": {
            "type": "array",
            "items": {"type": "array", "items": {"type": "number"},
                      "minItems": 2},
        },
    },
}

# The full BENCH_suite.json contract (a superset of the envelope).
SUITE_SCHEMA = {
    "$id": "repro.bench.suite/1",
    "type": "object",
    "required": ["schema_version", "bench", "host", "rows", "tier",
                 "success_tol", "protocol", "datasets", "cells"],
    "properties": {
        "schema_version": {"const": SCHEMA_VERSION},
        "bench": {"const": "suite"},
        "tier": {"enum": ["quick", "full"]},
        "success_tol": {"type": "number", "minimum": 0},
        "protocol": {"type": "string"},
        "host": _HOST_SCHEMA,
        "datasets": {"type": "array", "items": _DATASET_SCHEMA,
                     "minItems": 1},
        "rows": {"type": "array", "items": _ROW_SCHEMA, "minItems": 1},
        "cells": {"type": "array", "items": _CELL_SCHEMA, "minItems": 1},
    },
}


def _power_limit(index: int) -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it (``"700.00 W"``),
    or None where ``nvidia-smi`` is not there or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if index >= len(lines):
        return None
    return lines[index].rpartition(",")[2].strip() or None


def host_info(device=None) -> dict:
    """The host context every artifact records (trajectories are only
    comparable like for like): the card unless ``device="cpu"``.  Raises
    without a card unless the CPU is asked for.  A run uses one device
    (the host cell's ranks share the card), so ``xla_devices`` is 1."""
    import torch

    from repro_torch import device as devices

    dev = devices.resolve(device)
    info = {
        "cpu_count": os.cpu_count(),
        "xla_devices": 1,
        "backend": dev.type,
        "device": "cpu",
        "power_limit": None,
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        info["device"] = torch.cuda.get_device_name(index)
        info["power_limit"] = _power_limit(index)
    return info


def envelope(bench: str, rows: list[dict], *, host: dict | None = None,
             **extra) -> dict:
    """Build a schema-versioned artifact envelope around ``rows``;
    ``host`` defaults to :func:`host_info` on the card."""
    doc = {
        "schema_version": SCHEMA_VERSION,
        "bench": bench,
        "host": host_info() if host is None else host,
        "rows": rows,
    }
    doc.update(extra)
    return doc


def write_bench(path: str, doc: dict, schema: dict | None = None) -> str:
    """Validate ``doc`` (envelope schema by default) and write it to ``path``.

    The validate-then-write order is the point: a producer bug yields a
    loud ValueError, never a malformed committed artifact.
    """
    check(doc, schema or ENVELOPE_SCHEMA, what=os.path.basename(path))
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    return path
