"""What the JAX package's analysis scripts (``scripts/*.py``) compute, kept
as a fixture for ``tests/test_torch_sweeps.py`` and
``tests/test_torch_diagnostics.py``. The scripts set JAX's platform and
compile cache when imported, so only this generator, in its own process,
imports them.

Two kinds of reference:

* **The scripts' post-processing on seeded stub records.** Each script's
  ``main`` runs with its rollouts (or its learning driver and policy
  evaluation) replaced by stubs that return seeded numpy records
  (``stub_records``, ``stub_grid_eval``, ``StubDriver``, shared with the
  tests): the report lines it prints and the documents it writes (minus
  times and the device) are the reference for the port's code on the same
  stubs. The JAX scripts' ``jax.jit``/``jax.vmap`` calls go through a shim
  (``_JaxShim``) whose ``vmap`` hands the rollout's stub back.
* **The scripts' solves in float64.** ``sweep_contact`` (its own window
  loop, T=100: two windows) and ``diagnose_admm`` (B=4) run for real with
  ``jnp.float32`` read as ``jnp.float64`` (the scripts fix float32 on their
  inputs); ``solve_times_sweep``'s loop (B=4, four horizons) is repeated
  here, since the script cannot run (``jax_solve_times``).

Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_scripts_reference.py [npz json]

(~15 min on a CPU: the float64 solves compile once per horizon).
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE_NPZ = os.path.join(HERE, "fixtures", "torch_scripts.npz")
FIXTURE_JSON = os.path.join(HERE, "fixtures", "torch_scripts.json")

# times and devices differ from run to run: left out of the comparisons
VOLATILE = ("device", "sweep_seconds", "seconds", "wall_seconds", "loop_seconds",
            "eval_seconds")
STUB_T = 1200  # past the scripts' 500 ms settle window and their last 1000 ms
SWEEP_CONTACT_T = 100  # two windows
SOLVE_TIMES_B = 4
DIAGNOSE_ADMM_B = 4
DEMO_ARGS = {"run_learning_demo": ["3", "2", "2000"], "run_locodemo": ["3", "2"],
             "run_locosafedagger_demo": ["3", "2", "2000"]}


# --- stubs shared with the port's tests ---


def stub_records(B: int, T: int, seed: int, nv: int = 18, ne: int = 4) -> dict:
    """Seeded rollout records of B episodes (float32, bool, int32): states
    whose quaternion tilts a few degrees about a base height near 0.25 m,
    contact flags, forces and foot positions near the ground, and a failure
    for every third episode."""
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(B, T, nv + 8 + 17)) * 0.1
    tilt = rng.normal(size=(B, T, 3)) * 0.05
    quat = np.concatenate([np.sin(tilt / 2), np.ones((B, T, 1))], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    states[..., nv + 8] = 0.25 + rng.normal(size=(B, T)) * 0.02
    states[..., nv + 9:nv + 13] = quat
    failed = np.arange(B) % 3 == 1
    fail_step = np.where(failed, rng.integers(600, T, size=B), T)
    return {
        "states": states.astype(np.float32),
        "base": (rng.normal(size=(B, T, 3)) * 0.1).astype(np.float32),
        "in_contact": rng.random((B, T, ne)) < 0.6,
        "contact_forces": (rng.normal(size=(B, T, ne, 3)) * 5.0 + [0, 0, 6.0]).astype(np.float32),
        "contact_pos": (rng.normal(size=(B, T, ne, 3)) * 0.004 + 0.016).astype(np.float32),
        "failed": failed,
        "fail_step": fail_step.astype(np.int32),
        "q": rng.normal(size=(B, 7 + nv - 6)).astype(np.float32),
        "v": rng.normal(size=(B, nv)).astype(np.float32),
    }


def rollout_result(cls, state_cls, rec: dict, asarray, b=None):
    """A package's ``RolloutResult`` of ``stub_records``: batched, or episode
    ``b`` alone (the JAX package's unbatched rollout)."""
    def pick(a):
        return asarray(a if b is None else a[b])

    B, T = rec["states"].shape[:2]
    zeros = np.zeros((B, T, 12), np.float32)
    return cls(
        states=pick(rec["states"]), actions=pick(zeros), vc_goals=pick(zeros[..., :5]),
        base=pick(rec["base"]), com=pick(rec["base"]),
        contact_forces=pick(rec["contact_forces"]), contact_pos=pick(rec["contact_pos"]),
        in_contact=pick(rec["in_contact"]), failed=pick(rec["failed"]),
        fail_step=pick(rec["fail_step"]),
        final_state=state_cls(pick(rec["q"]), pick(rec["v"])),
        mpc_usage=pick(np.ones((B, T), np.float32)))


def stub_grid_eval(N: int, seed: int) -> dict:
    """A seeded ``GridEvalResult``'s fields over N commands (two survive
    the first call, none a later one every fourth call)."""
    rng = np.random.default_rng(seed)
    v_des = np.zeros((N, 3))
    v_des[:, 0] = np.linspace(0.0, 0.33, N)
    survived = rng.random(N) < 0.4
    if seed % 4 == 3:
        survived[:] = False
    fail_step = np.where(survived, 2000, rng.integers(100, 2000, size=N))
    return dict(v_des=v_des, w_des=np.zeros(N), vx_mse=rng.random(N) * 0.1,
                vy_mse=rng.random(N) * 0.01, survived=survived,
                mean_speed=rng.random(N) * 0.3, fail_step=fail_step)


def stub_demo_logs(mode: str, n_iter: int, seed: int, goal_vx=None) -> list:
    """The training entries a learning driver's ``run`` would log."""
    rng = np.random.default_rng(seed)
    out = []
    for it in range(n_iter):
        e = {"iteration": it, "train_loss_first": float(1.0 + rng.random()),
             "train_loss": float(rng.random()), "valid_loss": float(rng.random()),
             "failed_frac": float(rng.random()), "datapoints_added": int(rng.integers(1000))}
        if mode == "locosafedagger":
            e_mpc, e_pol = float(rng.random()), float(rng.random())
            e.update(goal=[float(rng.choice(goal_vx)), 0.0, 0.0],
                     aggregated="mpc" if e_mpc < e_pol else "policy", e_mpc=e_mpc,
                     e_policy=e_pol, tracking_error=min(e_mpc, e_pol),
                     posterior_entropy=float(rng.random()))
        out.append(e)
    return out


class StubDriver:
    """Stands for a learning driver (``SafeDagger``, ``LocoSafeDagger``) in a
    demo's ``main``: ``run`` logs ``stub_demo_logs`` (and the eval hook
    after the warmup and every iteration), the posterior is seeded."""

    calls = []

    def __init__(self, spec, cfg, sim_params=None, seed=0, grid=None, grid_n=30,
                 error_scaled_likelihood=False, **_):
        self.cfg = cfg
        self.policy = types.SimpleNamespace(module=None)
        if grid is None:
            lin = [np.linspace(r[0], r[1], grid_n)
                   for r in (cfg.vx_range, cfg.vy_range, cfg.w_range)]
            grid = types.SimpleNamespace(vx=lin[0], vy=lin[1], w=lin[2],
                                         shape=(grid_n, grid_n, grid_n))
        self.grid = grid
        p = np.random.default_rng(7).random(grid.shape)
        self.posterior = p / p.sum()

    def _settle(self, q0, v0):
        return "settled"

    def run(self, q0, v0, checkpoint_dir=None, resume=False, eval_hook=None):
        StubDriver.calls.append({"checkpoint_dir": checkpoint_dir, "resume": resume})
        # the SafeDAgger demo evaluates through its hook; the LocoSafeDagger ones log goals
        mode = "safedagger" if eval_hook is not None else "locosafedagger"
        logs = []
        if eval_hook is not None:
            logs.append({"iteration": "warmup", **eval_hook(self)})
        for e in stub_demo_logs(mode, self.cfg.n_iterations, 3, goal_vx=self.grid.vx):
            if eval_hook is not None:
                e.update(eval_hook(self))
            logs.append(e)
        return logs


def stub_eval(result_cls):
    """An ``eval_policy_grid`` stand-in: call k returns ``stub_grid_eval(N, k)``."""
    count = [0]

    def fn(spec, sim_params, cfg, state0, policy, vx_values, w_values=(0.0,), **_):
        count[0] += 1
        return result_cls(**stub_grid_eval(len(vx_values) * len(w_values), count[0] - 1))

    return fn


def strip(obj):
    """A document without its run-dependent keys."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def same_report(got, want):
    """Equal lines, their numbers equal to the last printed digit."""
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        for x, y in zip(NUM.findall(a), NUM.findall(b)):
            digits = len(y.split("e")[0].split(".")[1]) if "." in y else 0
            scale = 10.0 ** (int(y.split("e")[1]) if "e" in y else 0)
            assert abs(float(x) - float(y)) <= 1.01 * 10.0 ** -digits * scale + 1e-12, (a, b)


def report_lines(lines):
    start = next(i for i, ln in enumerate(lines) if ln.startswith("robot="))
    return [ln for ln in lines[start:] if not ln.startswith("  wrote")
            and not ln.startswith("  no matplotlib")]


# --- running the JAX scripts ---


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JaxShim(types.SimpleNamespace):
    """The ``jax`` a script sees: ``jit`` is the identity (or records what
    the jitted functions return), ``vmap(f)`` asks ``hook(f)`` for a
    stand-in (None: the real ``vmap``)."""

    def __init__(self, jax, hook=None, record=None):
        def jit(f, **_):
            if record is None:
                return f

            def g(*a, **k):
                out = jax.jit(f)(*a, **k)
                record.append(out)
                return out

            return g

        def vmap(f, *a, **k):
            alt = None if hook is None else hook(f)
            return jax.vmap(f, *a, **k) if alt is None else alt

        super().__init__(jit=jit, vmap=vmap, block_until_ready=lambda x: x,
                         devices=jax.devices, lax=jax.lax, tree_util=jax.tree_util,
                         config=jax.config)


@contextlib.contextmanager
def _argv(args):
    old = sys.argv
    sys.argv = ["script"] + [str(a) for a in args]
    try:
        yield
    finally:
        sys.argv = old


@contextlib.contextmanager
def _float64():
    """``jnp.float32`` read as ``jnp.float64`` (the scripts' inputs in f64)."""
    import jax.numpy as jnp

    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = f32


def _run(mod, args):
    buf = io.StringIO()
    with _argv(args), contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue().splitlines()


def _jax_rollout(results: list, unbatched: bool):
    """``rollout_mpc`` stand-in returning stub records: call k takes seed
    100 + k; ``unbatched``: one episode without the batch axis (the JAX
    package's single rollout), else B = the fourth argument (the vmapped
    calls' stand-ins pass it)."""
    import jax.numpy as jnp

    from bunmpc_tpu.sim import physics, rollout

    def fn(spec, sp, cfg, state0, *a, **k):
        i = len(results)
        B = 1 if unbatched else state0
        rec = stub_records(B, cfg.episode_length, 100 + i, nv=spec.model.nv)
        res = rollout_result(rollout.RolloutResult, physics.SimState, rec, jnp.asarray,
                             b=0 if unbatched else None)
        results.append(i)
        return res

    return fn


def _rollout_ns(rollout_mpc):
    from bunmpc_tpu.sim import rollout

    return types.SimpleNamespace(RolloutConfig=rollout.RolloutConfig, rollout_mpc=rollout_mpc,
                                 settle_state=lambda model, eff, sp, s0, *a, **k: s0)


def jax_calibrate_contact(tmp):
    import jax

    mod = load_script("calibrate_contact")
    calls = []
    batched = _jax_rollout(calls, unbatched=False)
    single = _jax_rollout(calls, unbatched=True)
    from bunmpc_tpu.sim import rollout

    cfg = rollout.RolloutConfig(episode_length=STUB_T)
    spec = types.SimpleNamespace(model=types.SimpleNamespace(nv=18))

    def hook(f):  # the grid's settle and rollout, vmapped over its 36 rows
        return lambda cps: batched(spec, None, cfg, 36)

    mod.jax = _JaxShim(jax, hook)
    mod.rollout = _rollout_ns(single)
    out = os.path.join(tmp, "calibrate.json")
    lines = _run(mod, [out, STUB_T])
    with open(out) as fh:
        return {"doc": strip(json.load(fh)), "stdout": lines}


def jax_validate_wf_norm(tmp):
    import jax

    mod = load_script("validate_wf_norm")
    mod.jax = _JaxShim(jax)
    mod.rollout = _rollout_ns(_jax_rollout([], unbatched=True))
    out = os.path.join(tmp, "wf.json")
    _run(mod, [out, STUB_T])
    with open(out) as fh:
        return {"doc": strip(json.load(fh))}


def jax_sweep_stability(tmp, robot, grid):
    import jax

    from bunmpc_tpu.sim import rollout

    mod = load_script("sweep_stability")
    calls = []
    roll = _jax_rollout(calls, unbatched=False)

    def hook(f):
        if f.__name__ != "one":
            return None

        def run(sp, g, sb, fg):
            spec = types.SimpleNamespace(model=types.SimpleNamespace(nv=18))
            return roll(spec, sp, rollout.RolloutConfig(episode_length=STUB_T),
                        sp.contact.kn.shape[0])

        return run

    mod.jax = _JaxShim(jax, hook)
    out = os.path.join(tmp, f"ss_{robot}_{grid}.json")
    lines = _run(mod, [robot, 0.3, STUB_T, 500, grid, out])
    with open(out) as fh:
        return {"doc": strip(json.load(fh)), "stdout": lines}


def jax_diagnose_gait(tmp, robot):
    import jax

    from bunmpc_tpu.eval import visualize as V

    mod = load_script("diagnose_gait")
    mod.jax = _JaxShim(jax)
    mod.rollout = _rollout_ns(_jax_rollout([], unbatched=True))
    saved = V.rollout_strip, V.render_rollout_video
    V.rollout_strip = V.render_rollout_video = lambda *a, **k: None
    try:
        return {"stdout": _run(mod, [robot, 0.3, STUB_T, os.path.join(tmp, "diag")])}
    finally:
        V.rollout_strip, V.render_rollout_video = saved


def jax_sweep_contact(arrays):
    """The JAX script's own loop in float64 (two windows, every combination)."""
    import jax

    mod = load_script("sweep_contact")
    outs = []

    def hook(f):
        if f.__name__ != "run_one":
            return None

        def run(theta):
            res = jax.vmap(f)(theta)
            outs.append(res)
            return res

        return run

    mod.jax = _JaxShim(jax, hook)
    with _float64():
        lines = _run(mod, ["solo12", 0.3, SWEEP_CONTACT_T])
    for k, a in zip(("z", "rpy", "vx", "in_contact"), outs[0]):
        arrays[f"sweep_contact/{k}"] = np.asarray(a)
    return {"stdout": lines}


def jax_solve_times(tmp):
    """The JAX script's computation (scripts/solve_times_sweep.py:36-71) at
    B=4 in float64. The script itself cannot run: its body is indented under
    a module-level ``if`` (:24), so importing it with JAX_PLATFORMS set
    raises NameError and ``main`` otherwise does nothing; the loop is
    repeated here line for line, with its float32 inputs in float64."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.solvers import biconvex

    B, f64 = SOLVE_TIMES_B, jnp.float64
    params = GAITS["trot"]
    model = Solo12Config.load_model()
    results = {}
    for gait_horizon in (1.0, 1.5, 2.0, 2.5):
        p = dataclasses.replace(params, gait_horizon=gait_horizon)
        spec = KD.make_cyclic_spec(model, p, Solo12Config.q0())
        q = jnp.asarray(np.tile(Solo12Config.q0(), (B, 1)), f64)
        v = jnp.zeros((B, 18), f64)
        t = jnp.zeros(B, f64)
        vd = jnp.tile(jnp.asarray([0.2, 0.0, 0.0], f64), (B, 1))
        wd = jnp.zeros(B, f64)
        admm = biconvex.BiconvexConfig(rho=p.rho, log_statistics=True)
        solve = jax.jit(jax.vmap(lambda *a: KD.solve_mpc(spec, *a, admm_cfg=admm)))
        plans = jax.block_until_ready(solve(q, v, t, vd, wd))
        results[str(spec.horizon)] = {
            "mean_admm_iters": float(jnp.mean(plans.admm_iters)),
            "mean_viol": float(jnp.mean(plans.dyn_violation)),
        }
    return results


def jax_diagnose_admm(arrays):
    """The JAX script's computation at B=4 in float64: per ``precondition``
    the solve's iterations and violation history, the subproblems' FISTA
    iterations."""
    import jax

    mod = load_script("diagnose_admm")
    record = []
    mod.jax = _JaxShim(jax, record=record)
    with _float64():
        lines = _run(mod, [f"batch={DIAGNOSE_ADMM_B}"])
    _, res_f, res_t, (fi, Lf), (xi, Lx) = record
    for tag, r in (("False", res_f), ("True", res_t)):
        arrays[f"diagnose_admm/{tag}/admm_iters"] = np.asarray(r.admm_iters)
        arrays[f"diagnose_admm/{tag}/viol_hist"] = np.asarray(r.viol_hist)
        arrays[f"diagnose_admm/{tag}/viol_norm"] = np.asarray(r.viol_norm)
    arrays["diagnose_admm/f_iters"] = np.asarray(fi)
    arrays["diagnose_admm/x_iters"] = np.asarray(xi)
    arrays["diagnose_admm/f_L"] = np.asarray(Lf)
    arrays["diagnose_admm/x_L"] = np.asarray(Lx)
    return {"stdout": lines}


def jax_demo(tmp, name):
    from bunmpc_tpu.eval.velocity_grid import GridEvalResult

    mod = load_script(name)
    StubDriver.calls = []
    for attr in ("SafeDagger", "LocoSafeDagger"):
        if hasattr(mod, attr):
            setattr(mod, attr, StubDriver)
    if hasattr(mod, "eval_policy_grid"):
        mod.eval_policy_grid = stub_eval(GridEvalResult)
        mod.policy_fn_from_tree = lambda *a: None
        mod.policy_tree = lambda *a: None
    out = os.path.join(tmp, f"{name}.jsonl")
    _run(mod, [out] + DEMO_ARGS[name])
    with open(out) as fh:
        entries = [json.loads(ln) for ln in fh if ln.strip()]
    return {"entries": strip(entries)}


def reference():
    """``(arrays, document)``: every reference above."""
    import jax

    jax.config.update("jax_enable_x64", True)
    arrays, doc = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        doc["calibrate_contact"] = jax_calibrate_contact(tmp)
        doc["validate_wf_norm"] = jax_validate_wf_norm(tmp)
        doc["sweep_stability"] = {f"{r}_{g}": jax_sweep_stability(tmp, r, g)
                                  for r, g in (("go2", "default"), ("solo12", "calibrate"))}
        doc["diagnose_gait"] = {r: jax_diagnose_gait(tmp, r) for r in ("solo12", "go2")}
        doc["run_learning_demo"] = jax_demo(tmp, "run_learning_demo")
        doc["run_locodemo"] = jax_demo(tmp, "run_locodemo")
        doc["run_locosafedagger_demo"] = jax_demo(tmp, "run_locosafedagger_demo")
        doc["diagnose_admm"] = jax_diagnose_admm(arrays)
        doc["sweep_contact"] = jax_sweep_contact(arrays)
        doc["solve_times_sweep"] = jax_solve_times(tmp)
    return arrays, doc


def main(npz=FIXTURE_NPZ, doc_path=FIXTURE_JSON):
    arrays, doc = reference()
    os.makedirs(os.path.dirname(npz), exist_ok=True)
    np.savez_compressed(npz, **arrays)
    with open(doc_path, "w") as fh:
        json.dump(doc, fh, indent=1, allow_nan=False)
    print(f"wrote {npz} ({len(arrays)} arrays) and {doc_path}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(*sys.argv[1:3])
