"""Strict-JSON artifact IO.

Copy of ``bunmpc_tpu/utils/jsonio.py``. Python's ``json`` serializes
``float('nan')``/``inf`` as bare ``NaN`` / ``Infinity`` tokens, which strict
JSON parsers (and dashboards) reject. Every artifact goes through
:func:`sanitize` (non-finite floats -> ``null``) and is serialized with
``allow_nan=False``, so a non-finite value that slipped past sanitation
fails loudly at write time instead of corrupting the artifact.
"""

from __future__ import annotations

import json
import math


def sanitize(obj):
    """Recursively replace non-finite floats with None (JSON null)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    # numpy scalars
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return sanitize(obj.item())
    return obj


def dumps(obj, **kwargs) -> str:
    """json.dumps with NaN/Infinity mapped to null and strict output."""
    return json.dumps(sanitize(obj), allow_nan=False, **kwargs)


def dump(obj, fh, **kwargs):
    fh.write(dumps(obj, **kwargs))


def write_jsonl(path: str, entries):
    """Write one strict-JSON object per line."""
    with open(path, "w") as fh:
        for e in entries:
            fh.write(dumps(e) + "\n")


def write_json(path: str, obj, indent: int = 1):
    """Write one strict-JSON document."""
    with open(path, "w") as fh:
        fh.write(dumps(obj, indent=indent) + "\n")
