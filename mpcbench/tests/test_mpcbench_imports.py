"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: every module that
``mpcbench/run.py`` and ``mpcbench/reference/`` import, found by an AST
scan of the benchmark's sources and by ``sys.modules`` after importing them
on the CPU, compared by whole top-level names."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "bunmpc_tpu"}
PROGRAM = "bunmpc_tpu_torch"


def sources(sub=""):
    """The benchmark's Python files (its tests left out)."""
    out = []
    for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported(path):
    """Whole top-level names of the absolute modules a file imports, and
    whether it imports relatively past its own package tree."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in sources():
        bad = imported(path) & FORBIDDEN
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for path in sources("reference"):
        names = imported(path)
        assert PROGRAM not in names and "mpcbench" not in names, path
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        depth = os.path.relpath(os.path.dirname(path), ref).count(os.sep) + (
            0 if os.path.dirname(path) == ref else 1)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth + 1, f"{path} imports out of the reference"


PROBE = """
import importlib, json, os, sys
sys.path.insert(0, {root!r})
mods = [{mods}]
for m in mods:
    importlib.import_module(m)
from mpcbench import run
if {program}:  # what a run loads of the program: each configuration's objects, both sides
    from mpcbench import system
    for f in os.listdir(os.path.join({root!r}, "mpcbench", "configs")):
        cfg = json.load(open(os.path.join({root!r}, "mpcbench", "configs", f)))
        for pkg in (system.PROGRAM, system.REFERENCE):
            system.spec(pkg, cfg, cfg["gait"], "cpu")
            system.module(pkg, "sim.rollout")
    system.module(system.PROGRAM, "solvers.cuda_admm")
names = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(names))
"""


def module_names(paths):
    out = []
    for p in paths:
        rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[: -len(".__init__")]
        if "." in os.path.basename(p)[:-3]:  # a metric reader's file name holds a dot
            continue
        out.append(rel)
    return out


def probe(mods, program=True):
    code = PROBE.format(root=ROOT, mods=", ".join(repr(m) for m in mods), program=program)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    import json

    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_sys_modules_after_importing_the_harness_hold_no_jax():
    loaded = probe(module_names(sources()))
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)
    assert PROGRAM in loaded


def test_sys_modules_after_importing_the_reference_hold_nothing_of_the_program():
    loaded = probe(module_names(sources("reference")), program=False)
    assert not loaded & (FORBIDDEN | {PROGRAM}), sorted(loaded & (FORBIDDEN | {PROGRAM}))


def test_a_metric_reader_imports_no_jax():
    for path in sources("metrics"):
        assert not imported(path) & (FORBIDDEN | {PROGRAM}), path
