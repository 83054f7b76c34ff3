"""The port stands alone: ``bunmpc_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the robot constants are a byte-identical
copy, entry points refuse a CUDA device that is not there, and the kernel
wrappers take CPU tensors to their plain versions without a launch."""

import ast
import dataclasses
import filecmp
import os
import sys

import numpy as np
import pytest
import torch

import bunmpc_tpu_torch
from bunmpc_tpu_torch.mpc import ik as IK
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.centroidal import ContactPlan
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu_torch.robots.solo12 import Solo12Config
from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused

from torch_port_helpers import admm_problem, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bunmpc_tpu_torch")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_or_jax_package_imports():
    files = _port_files()
    assert len(files) > 15
    for sub in ("physics.py", "controllers.py", "rollout.py"):  # the closed loop is scanned
        assert os.path.join(PKG, "sim", sub) in files
    for sub in ("goals.py", "database.py", "networks.py", "bc.py", "perturbations.py",
                "contact_planner.py", "data_collection.py",  # the learning substrate
                "dagger.py", "bayes.py", "gp_bo.py"):  # and the DAgger family
        assert os.path.join(PKG, "learning", sub) in files
    for sub in ("velocity_grid.py", "max_force.py", "cc_replanning.py", "past_goals.py",
                "multi_database.py", "visualize.py"):  # the eval suite
        assert os.path.join(PKG, "eval", sub) in files
    for sub in (("robots", "go2.py"), ("mpc", "motions", "go2_cyclic.py")):  # the Go2
        assert os.path.join(PKG, *sub) in files
    for sub in UTILS + SCRIPTS + PARALLEL:  # the experiment layer, the multi-device path
        assert os.path.join(PKG, sub) in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "orbax", "bunmpc_tpu"), \
                f"{path} imports {mod}"


UTILS = tuple(os.path.join("utils", f"{n}.py") for n in (
    "config", "jsonio", "logging", "runtime", "checkpoint", "profiling"))
SCRIPTS = tuple(os.path.join("scripts", f"{n}.py") for n in (
    "run_data_collection", "run_bc", "run_dagger", "run_eval", "run_sweep"))
PARALLEL = (os.path.join("parallel", "__init__.py"), os.path.join("parallel", "mesh.py"),
            os.path.join("scripts", "bench_multichip.py"))


def test_parallel_imports_torch_numpy_and_the_standard_library():
    """The multi-device path (``parallel/``, ``scripts/bench_multichip.py``)
    imports torch (``torch.distributed``), numpy, the standard library and
    the port, at any level."""
    for sub in PARALLEL:
        path = os.path.join(PKG, sub)
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level > 0:
                continue  # the port's own modules
            for mod in _imported_modules_of(node):
                assert mod.split(".")[0] in {"torch", "numpy", "__future__",
                                             "bunmpc_tpu_torch"} | set(sys.stdlib_module_names), \
                    f"{path} imports {mod}"


def _imported_modules_of(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [node.module]
    return []


def _module_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_optional_packages_stay_inside_functions():
    """No module of the port imports PyYAML, h5py, wandb or orbax at module
    level (the card's machine has none of them): the configs are read by the
    port's own YAML reader, an hdf5 snapshot imports h5py where it is read or
    written, the metrics logger imports wandb in ``__init__``; PyYAML and
    orbax are imported nowhere."""
    for path in _port_files():
        for mod in _module_level_imports(path):
            assert mod.split(".")[0] not in ("yaml", "h5py", "wandb", "orbax"), \
                f"{path} imports {mod} at module level"
        assert not {m.split(".")[0] for m in _imported_modules(path)} & {"yaml", "orbax"}, path


def test_scipy_only_in_gp_bo():
    """The port imports torch and numpy; scipy only for the GP's L-BFGS-B
    acquisition search (``learning/gp_bo.py``)."""
    users = {os.path.relpath(path, REPO) for path in _port_files()
             if any(m.split(".")[0] == "scipy" for m in _imported_modules(path))}
    assert users == {os.path.join("bunmpc_tpu_torch", "learning", "gp_bo.py")}


def test_plotting_imports_stay_inside_functions():
    """The port imports torch and numpy at module level; the eval suite's
    plots import matplotlib and PIL inside the functions that draw
    (``eval/visualize.py`` alone), so that no entry point needs them."""
    top = {"torch", "numpy", "scipy", "bunmpc_tpu_torch"}
    users = set()
    for path in _port_files():
        for mod in _module_level_imports(path):
            assert mod.split(".")[0] in top | {"__future__"} or mod.split(".")[0] in (
                sys.stdlib_module_names), f"{path} imports {mod} at module level"
        if any(m.split(".")[0] in ("matplotlib", "PIL") for m in _imported_modules(path)):
            users.add(os.path.relpath(path, REPO))
    assert users == {os.path.join("bunmpc_tpu_torch", "eval", "visualize.py")}


def test_robot_asset_is_byte_identical():
    ours = os.path.join(PKG, "robots", "assets", "solo12_model.npz")
    theirs = os.path.join(REPO, "bunmpc_tpu", "robots", "assets", "solo12_model.npz")
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_go2_asset_is_byte_identical():
    ours = os.path.join(PKG, "robots", "assets", "go2_model.npz")
    theirs = os.path.join(REPO, "bunmpc_tpu", "robots", "assets", "go2_model.npz")
    assert filecmp.cmp(ours, theirs, shallow=False)


@pytest.mark.parametrize("name", ["bc", "dagger", "data_collection", "locosafedagger",
                                  "safedagger"])
def test_config_is_byte_identical(name):
    ours = os.path.join(PKG, "configs", f"{name}.yaml")
    theirs = os.path.join(REPO, "bunmpc_tpu", "configs", f"{name}.yaml")
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_solo8_asset_is_byte_identical():
    ours = os.path.join(PKG, "robots", "assets", "solo8_model.npz")
    theirs = os.path.join(REPO, "bunmpc_tpu", "robots", "assets", "solo8_model.npz")
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_precision_settings():
    assert bunmpc_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal applies to CPU-only hosts")
    model = Solo12Config.load_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        KD.make_cyclic_spec(model, trot, Solo12Config.q0())
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0(), device="cpu")
    gpu_spec = dataclasses.replace(spec, device=torch.device("cuda"))
    q = np.tile(Solo12Config.q0(), (2, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        KD.solve_mpc_batch(gpu_spec, q, np.zeros((2, 18)), np.zeros(2), np.zeros((2, 3)),
                           np.zeros(2))


def test_closed_loop_start_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal applies to CPU-only hosts")
    from bunmpc_tpu_torch import workload

    with pytest.raises(RuntimeError, match="CUDA"):
        workload.settled_start(2)


@pytest.mark.parametrize(
    "kwargs, exc",
    [
        (dict(fuse_prep=True, admm_backend="torch"), ValueError),
        (dict(admm_backend="pallas"), ValueError),
        (dict(ik_backend="xla"), ValueError),
    ],
)
def test_unported_options_raise(kwargs, exc):
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device="cpu")
    q = torch.as_tensor(np.tile(Solo12Config.q0(), (2, 1)), dtype=torch.float64)
    z = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(exc):
        KD.solve_mpc_batch(spec, q, torch.zeros(2, 18, dtype=torch.float64), z,
                           torch.zeros(2, 3, dtype=torch.float64), z, **kwargs)


def test_admm_wrapper_takes_cpu_tensors_to_the_plain_version():
    p = to_torch(admm_problem(2), torch.float64)
    plan = ContactPlan(cnt=p["cnt"], r=p["r"], dt=p["dt"])
    cfg = cuda_admm.CudaAdmmConfig(rho=5e4, max_admm_iters=3)
    args = (plan, 2.5, p["x_init"], p["W"], p["X_ref"], p["W_F"], p["X_wm"], p["F_wm"],
            (p["lb"], p["ub"]), cfg)
    before = cuda_admm.KERNEL.launches
    out = cuda_admm.solve(*args)
    ref = cuda_admm.solve_plain(*args)
    assert cuda_admm.KERNEL.launches == before == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="x_solver"):
        cuda_admm.solve(*args[:-1], dataclasses.replace(cfg, x_solver="cholesky"))


def test_fused_wrapper_takes_cpu_tensors_to_the_plain_version():
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device="cpu")
    q = torch.as_tensor(np.tile(Solo12Config.q0(), (2, 1)), dtype=torch.float64)
    z = torch.zeros(2, dtype=torch.float64)
    _, t, vdw, x_init, ee, hip, amom = KD._compact_inputs(
        spec, q, torch.zeros(2, 18, dtype=torch.float64), z, torch.zeros(2, 3, dtype=torch.float64),
        z)
    cfg = cuda_admm.CudaAdmmConfig(rho=5e4, max_admm_iters=3)
    args = (t, vdw, z, x_init, ee, hip, amom, spec.model.total_mass, KD.make_prep_consts(spec),
            cfg, spec.horizon, spec.n_eff)
    before = cuda_fused.KERNEL.launches
    out = cuda_fused.solve_from_state(*args)
    ref = cuda_fused.solve_from_state_plain(*args)
    assert cuda_fused.KERNEL.launches == before == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[7].dtype == torch.bool


def test_ddp_wrapper_takes_cpu_tensors_to_the_plain_version():
    model = Solo12Config.load_model()
    eff = Solo12Config.eff_names
    B, H, nv = 2, 2, model.nv
    rng = np.random.default_rng(3)
    f64 = torch.float64
    x_reg = np.concatenate([Solo12Config.q0(), np.zeros(nv)])
    tasks = IK.IkTasks(
        ee_targets=torch.as_tensor(rng.normal(size=(B, H, 4, 3)) * 0.1, dtype=f64),
        ee_wts=torch.ones(B, H, 4, dtype=f64),
        com_ref=torch.zeros(B, H + 1, 3, dtype=f64),
        mom_ref=torch.zeros(B, H + 1, 6, dtype=f64),
        com_wt=1.0, mom_wt=1.0,
        state_wt=torch.ones(2 * nv, dtype=f64),
        x_reg=torch.as_tensor(x_reg, dtype=f64),
        reg_wt_state=0.1, reg_wt_ctrl=1e-4,
        ctrl_wt=torch.ones(nv, dtype=f64),
        dts=torch.full((B, H), 0.05, dtype=f64),
    )
    w_stage, w_term, ctrl_w, xr = IK.dense_weights(model, eff, tasks)
    x0 = torch.as_tensor(np.tile(x_reg, (B, 1)), dtype=f64)
    args = (model, eff, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, xr, w_stage,
            w_term, ctrl_w, tasks.dts)
    cfg = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    before = cuda_ddp.KERNEL.launches
    out = cuda_ddp.solve_ik_batch(*args, cfg=cfg)
    ref = cuda_ddp.solve_ik_batch_plain(*args, cfg=cfg)
    assert cuda_ddp.KERNEL.launches == before == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
