"""The JAX package's problem assembly and MPC solve on the Solo8's trot, on
the inputs of ``tests/test_torch_solo8.py``, kept as a fixture because the
jitted JAX solve takes minutes to compile on a CPU.

Per gait of ``solo8_cyclic.GAITS`` (the trot):

* ``<gait>/prep/*``: the eager JAX ``_prepare_problem`` (vmapped, not
  jitted: jitted, the first-knot dt degenerates on knot clocks) at B=4 in
  float64 on ``prep_inputs(name)``, and the eager JAX ``prep_values`` (K3's
  prologue, an f32 function) on the port's compact inputs of the same
  problems (stored as ``<gait>/compact/*``);
* ``<gait>/<field>``: at B=2 in float64 (``workload.solo8_states(2,
  seed=1)``: problem 0 the JAX Solo8 test's window, the standing q0 at rest
  at t=0 with v_des (0.2, 0, 0); problem 1 a bench.py draw about it), the
  JAX package's ``solve_mpc_batch(admm_backend="xla", ik_backend="xla")``
  with bench.py's ADMM config (thomas X-solve, fista_max_iters=30) and the
  default ``DdpConfig``: every ``MpcPlan`` field.

Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_solo8_reference.py
"""

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_solo8.npz")
B, SEED = 2, 1
PREP_FIELDS = ("q", "x_init", "W", "X_ref", "W_F", "X_wm", "F_wm", "cnt", "r", "dt",
               "swing_mask", "lb", "ub")
PREP_VALUES = ("cnt", "r", "dt", "swing", "W", "qlin", "WF", "qF", "lb", "ub", "X0", "F0")
COMPACT = ("t", "v_des_w", "w_des", "x_init", "ee", "hip", "amom")


def inputs(name):
    """The gait's B problems ``(q, v, t, v_des, w_des)`` (float64 numpy)."""
    from bunmpc_tpu_torch.workload import solo8_states

    return solo8_states(B, seed=SEED)


def prep_inputs(name):
    """B=4 problems led by the JAX Solo8 test's window; every gait clock is
    clear of the jitted first-knot fault (round(mod(t, 0.05), 2) < 0.05)."""
    from bunmpc_tpu_torch.workload import solo8_states

    st = solo8_states(4, seed=0)
    assert np.all(np.round(np.mod(st[2], 0.05), 2) < 0.05)
    return st


def compact_inputs(name):
    """The port's compact inputs of ``prep_inputs(name)`` in float32, K3's
    prologue's arguments (t, v_des_w, w_des, x_init, ee, hip, amom)."""
    import torch

    from bunmpc_tpu_torch.mpc import kino_dyn as TKD
    from bunmpc_tpu_torch.workload import solo8_spec

    spec = solo8_spec(name, device="cpu")
    st = [torch.as_tensor(a, dtype=torch.float32) for a in prep_inputs(name)]
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(spec, *st)
    return dict(zip(COMPACT, (a.numpy() for a in (t, vdw, st[4], x_init, ee, hip, amom))))


def jax_spec(params):
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.robots.solo8 import Solo8Config as C
    from bunmpc_tpu_torch.workload import solo8_q0

    return KD.make_cyclic_spec(C.load_model(), params, solo8_q0(),
                               eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
                               foot_size=C.foot_size)


def preps() -> dict:
    """Per gait, the eager JAX assembly and K3's JAX prologue (needs x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo8_cyclic import GAITS
    from bunmpc_tpu.solvers import pallas_admm as PA

    assert jax.config.jax_enable_x64
    out = {}
    for key, g in GAITS.items():
        name = key
        spec = jax_spec(g)
        jp = jax.vmap(lambda *a, spec=spec: KD._prepare_problem(spec, *a))(
            *[jnp.asarray(a, jnp.float64) for a in prep_inputs(name)])
        vals = dict(jp, cnt=jp["plan"].cnt, r=jp["plan"].r, dt=jp["plan"].dt,
                    lb=jp["x_bounds"][0], ub=jp["x_bounds"][1])
        for f in PREP_FIELDS + (("F_ref",) if "F_ref" in vals else ()):
            out[f"{key}/prep/{f}"] = np.asarray(vals[f])
        ci = compact_inputs(name)
        for f, a in ci.items():
            out[f"{key}/compact/{f}"] = a

        def lanes(a):  # (B, ...) -> (..., B)
            return jnp.moveaxis(jnp.asarray(a, jnp.float32), 0, -1)

        ref = PA.prep_values(lanes(ci["t"])[None], lanes(ci["v_des_w"]), lanes(ci["w_des"])[None],
                             lanes(ci["x_init"]), lanes(ci["ee"]), lanes(ci["hip"]),
                             lanes(ci["amom"]), pc=KD.make_prep_consts(spec),
                             m=float(spec.model.total_mass), H=spec.horizon,
                             ne=len(spec.eff_frames))
        for f, a in zip(PREP_VALUES, ref):
            out[f"{key}/prep_values/{f}"] = np.moveaxis(np.asarray(a), -1, 0)
    return out


def solves() -> dict:
    """Per gait, the JAX package's plan (needs x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo8_cyclic import GAITS
    from bunmpc_tpu.solvers.biconvex import BiconvexConfig

    assert jax.config.jax_enable_x64
    out = {}
    for name, g in GAITS.items():
        spec = jax_spec(g)
        cfg = BiconvexConfig(rho=g.rho, x_solver="thomas", fista_max_iters=30)
        plan = jax.jit(lambda *a, spec=spec, cfg=cfg: KD.solve_mpc_batch(
            spec, *a, admm_cfg=cfg, admm_backend="xla", ik_backend="xla"))(
            *[jnp.asarray(a, jnp.float64) for a in inputs(name)])
        for f in plan._fields:
            out[f"{name}/{f}"] = np.asarray(getattr(plan, f))
        print(f"{name}: H {spec.horizon}, IK H {spec.ik_hor}, dyn_violation "
              f"{out[f'{name}/dyn_violation']}, iters {out[f'{name}/admm_iters']}", flush=True)
    return out


def reference() -> dict:
    return {**preps(), **solves()}


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(FIXTURE, **reference())
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
