"""The port does what the JAX package does: every public (no leading
underscore) top-level name of every ``bunmpc_tpu/**.py`` module has a
counterpart of the same name in the same module of ``bunmpc_tpu_torch/``,
and every script of ``scripts/`` one in ``bunmpc_tpu_torch/scripts/``, apart
from the exclusions below, each with its reason. An AST scan, so that no
test worker imports the JAX scripts (they set JAX's platform and compile
cache when imported). An exclusion must name something the JAX package has
and the port lacks: a stale entry fails too.
"""

import ast
import glob
import os

import pytest

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "bunmpc_tpu")
PORT = os.path.join(ROOT, "bunmpc_tpu_torch")

_TPU_ONLY = ("the TPU's own profilers and kernel checks: the port's are chip_smoke.py and "
             "python -m bunmpc_tpu_torch.profile_kernels")
_PROBE = "a probe of one earlier round's question, not a tool of the system"

# module (relative to the package) -> (its replacement in the port, or None; the reason)
MODULES = {
    "native/__init__.py": (None, "the JAX package's C++ twin for its own tests; the port's "
                                 "tests compare against the JAX package directly"),
    "native/bindings.py": (None, "the JAX package's C++ twin for its own tests; the port's "
                                 "tests compare against the JAX package directly"),
    "parallel/__init__.py": (None, "multi-device meshes: the port targets one card "
                                   "(learning/bc.py refuses a mesh)"),
    "parallel/mesh.py": (None, "multi-device meshes: the port targets one card "
                               "(learning/bc.py refuses a mesh)"),
    "robots/urdf.py": (None, "builds models from the reference's URDFs, which are not in the "
                             "tree; the port loads the byte-identical .npz assets"),
    "solvers/pallas_admm.py": (("solvers/cuda_admm.py", "solvers/cuda_fused.py"),
                               "the Pallas kernels K1 and K3: the hand-written CUDA kernels "
                               "csrc/admm.cu and csrc/fused.cu"),
    "solvers/pallas_ddp.py": (("solvers/cuda_ddp.py",),
                              "the Pallas kernel K2: the hand-written CUDA kernel csrc/ddp.cu"),
}
# (module, name) -> (its replacement in the port's module, or None; the reason)
NAMES = {
    ("utils/runtime.py", "setup_jax"): ("setup_torch", "the platform and compile cache of JAX"),
    ("learning/networks.py", "policy_tree"): ("PolicyBundle", "flax parameter pytrees"),
    ("learning/networks.py", "policy_fn_from_tree"): ("PolicyBundle", "flax parameter pytrees"),
    ("learning/bc.py", "make_train_step"): ("train_step", "a jitted step factory"),
    ("learning/bc.py", "make_sharded_train_step"): (None, "a mesh-sharded step: one card"),
}
SCRIPTS = {
    "check_pallas_ddp.py": _TPU_ONLY, "profile_ddp.py": _TPU_ONLY,
    "profile_breakdown.py": _TPU_ONLY, "profile_prep.py": _TPU_ONLY, "roofline.py": _TPU_ONLY,
    "ab_precondition.py": _TPU_ONLY, "bench_multichip.py": _TPU_ONLY + " (and a TPU mesh)",
    "generate_robot_assets.py": "needs the reference's URDFs, which are not in the tree",
    "probe_expert_robustness.py": _PROBE, "probe_gait_trace.py": _PROBE,
    "probe_go2_nan.py": _PROBE, "probe_window.py": _PROBE, "debug_tracking.py": _PROBE,
    "f32_sensitivity.py": _PROBE, "make_e2e_fixture.py": "wrote the JAX package's native "
                                                         "fixture (tests/fixtures), kept as is",
    "finalize_learning_demo.py": "rebuilt one JAX artifact from its checkpoint",
}


def public_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return {n for n in out if not n.startswith("_")}


JAX_MODULES = sorted(os.path.relpath(p, JAX_PKG)
                     for p in glob.glob(os.path.join(JAX_PKG, "**", "*.py"), recursive=True))
JAX_SCRIPTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "scripts", "*.py")))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_is_ported(rel):
    src = os.path.join(JAX_PKG, rel)
    dst = os.path.join(PORT, rel)
    if rel in MODULES:
        repl, reason = MODULES[rel]
        assert reason and not os.path.exists(dst), f"{rel} is excluded but the port has it"
        for r in repl or ():
            assert os.path.exists(os.path.join(PORT, r)), r
        return
    assert os.path.exists(dst), f"bunmpc_tpu_torch/{rel} is missing"
    missing = public_names(src) - public_names(dst)
    for name in sorted(missing):
        assert (rel, name) in NAMES, f"{rel}: {name} has no counterpart in the port"
    for (mod, name), (repl, reason) in NAMES.items():
        if mod == rel:
            assert reason and name in missing, f"{rel}: {name} is excluded but ported"
            assert repl is None or repl in public_names(dst), repl


@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_script_is_ported(name):
    dst = os.path.join(PORT, "scripts", name)
    if name in SCRIPTS:
        assert SCRIPTS[name] and not os.path.exists(dst), f"{name} is excluded but ported"
        return
    assert os.path.exists(dst), f"bunmpc_tpu_torch/scripts/{name} is missing"
    assert "main" in public_names(dst)


def test_exclusions_name_the_jax_package():
    assert set(MODULES) <= set(JAX_MODULES)
    assert {m for m, _ in NAMES} <= set(JAX_MODULES)
    assert set(SCRIPTS) <= set(JAX_SCRIPTS)
