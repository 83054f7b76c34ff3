"""Experiment configs: YAML files, dotted CLI overrides, dataclass hydration.

Counterpart of ``bunmpc_tpu/utils/config.py`` (the reference's Hydra /
OmegaConf stack, cfgs/*.yaml): the port's own copies of the configs live in
``bunmpc_tpu_torch/configs/`` and load into nested dicts, ``key.subkey=value``
overrides apply on top (values parsed by ``ast.literal_eval``, else kept as
strings), and ``hydrate`` builds a dataclass from a dict.

The port needs no PyYAML: ``parse_yaml`` reads the subset of YAML the
configs use, with PyYAML's ``safe_load`` typing of plain scalars (YAML 1.1
ints, floats with a dot, booleans, nulls): a mapping of ``key: value`` lines
at one indentation, comments, plain and quoted scalars, and flow ``[...]``
lists and ``{...}`` maps. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os
import re
from typing import Any

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")

# PyYAML's (YAML 1.1) resolvers for the plain scalars the configs can hold
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$")
# the other numbers of YAML 1.1 (binary, octal, hex, base 60), not read here
_OTHER_NUMBER = re.compile(r"[-+]?(?:0[bx0-7]|[1-9][0-9_]*(?::[0-5]?[0-9])+)")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _plain(s: str) -> Any:
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if m := _INF.match(s):
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    if _OTHER_NUMBER.match(s):
        raise ValueError(f"config YAML: the number {s!r} is not supported")
    return s


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a
    space, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """A flow value (scalar, ``[...]``, ``{...}``) parsed from ``text``."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def fail(self, what):
        raise ValueError(f"config YAML: {what} at column {self.i} of {self.s!r}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self) -> Any:
        self.skip()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        end = self.i
        while end < len(self.s) and self.s[end] not in ",]}":
            end += 1
        text, self.i = self.s[self.i:end].strip(), end
        if ": " in text:
            self.fail("a nested mapping entry")
        return _plain(text)

    def quoted(self) -> str:
        q = self.s[self.i]
        j = self.i + 1
        while True:
            j = self.s.find(q, j)
            if j < 0:
                self.fail("an unterminated string")
            if q == "'" and self.s[j + 1:j + 2] == "'":
                j += 2
                continue
            if q == '"' and self.s[j - 1] == "\\":
                j += 1
                continue
            break
        raw, self.i = self.s[self.i:j + 1], j + 1
        return raw[1:-1].replace("''", "'") if q == "'" else ast.literal_eval(raw)

    def items(self, close, item):
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.s[self.i:self.i + 1] == close:
                self.i += 1
                return out
            out.append(item())
            self.skip()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != close:
                self.fail(f"expected ',' or {close!r}")

    def seq(self) -> list:
        return self.items("]", self.value)

    def mapping(self) -> dict:
        def entry():
            self.skip()
            k = self.s.find(":", self.i)
            if k < 0:
                self.fail("a mapping entry without ':'")
            key = _plain(self.s[self.i:k].strip())
            self.i = k + 1
            return key, self.value()

        return dict(self.items("}", entry))

    def end(self):
        self.skip()
        if self.i != len(self.s):
            self.fail("trailing text")


def parse_yaml(text: str) -> dict:
    """The mapping of a config file (see the module docstring)."""
    out = {}
    indent = None
    for n, line in enumerate(text.splitlines(), 1):
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        lead = len(body) - len(body.lstrip(" "))
        if indent is None:
            indent = lead
        key, sep, rest = body.strip().partition(":")
        if lead != indent or not sep or (rest and rest[0] not in " \t") or not key:
            raise ValueError(f"config YAML line {n}: only 'key: value' lines at one "
                             f"indentation are supported: {line!r}")
        key = _Flow(key).quoted() if key[0] in "'\"" else _plain(key)
        rest = rest.strip()
        if rest[:1] in ("[", "{", "'", '"'):
            flow = _Flow(rest)
            out[key] = flow.value()
            flow.end()
        else:
            out[key] = _plain(rest)
    return out


def load_yaml(name: str, config_dir: str | None = None) -> dict:
    path = name if os.path.exists(name) else os.path.join(config_dir or CONFIG_DIR, f"{name}.yaml")
    with open(path) as fh:
        return parse_yaml(fh.read())


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Apply ``a.b.c=value`` CLI overrides (Hydra-style)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return cfg


def load_config(name: str, overrides: list[str] | None = None,
                config_dir: str | None = None) -> dict:
    cfg = load_yaml(name, config_dir)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def hydrate(cls, cfg: dict):
    """Build a dataclass from a dict, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in cfg.items() if k in names})
