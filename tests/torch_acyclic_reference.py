"""The JAX package's acyclic MPC solve on the six Solo12 motions, on the
inputs of ``tests/test_torch_acyclic.py``, kept as a fixture because the
jitted JAX solve compiles once per motion (minutes each on a CPU).

Per motion of ``solo12_acyclic.MOTIONS``, ``<motion>/<field>``: at B=2 in
float64 (``inputs(name)``: problem 0 the JAX tests' start, q0 at x=0.2 at
rest at t=0; problem 1 ``workload.acyclic_states(name, 2,
seed=SEEDS[name])``'s draw, at a clock whose knots sit off every segment
boundary, the first seed from 1 whose draw converges: most draws of
cartwheel and hifive diverge, in both packages), the JAX
package's ``solve_acyclic_mpc`` under ``vmap`` and ``jit`` with its default
ADMM config (the motion's rho, the Thomas X-step) and the default
``DdpConfig``: every ``MpcPlan`` field. ``hifive`` is built with
``plan_freq=PLAN_FREQ["hifive"]``: at its own plan_freq (1.4 s) its plan
covers the whole horizon and the JAX package's force interpolation raises
(ROADMAP "Faults found"). From the start at t=0, rearing and hifive diverge
(a NaN violation).

Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_acyclic_reference.py
"""

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_acyclic_solo12.npz")
B = 2
SEEDS = {"jump_fwd": 1, "cartwheel": 3, "rearing": 1, "stand": 1, "hifive": 4,
         "rearing_jump": 3}
PLAN_FREQ = {"hifive": 1.0}


def inputs(name):
    """The motion's B problems ``(q, v, t)`` (float64 numpy)."""
    from bunmpc_tpu_torch.workload import acyclic_states

    return acyclic_states(name, B, seed=SEEDS[name])


def solves(names=None) -> dict:
    """Per motion, the JAX package's plan (needs x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.mpc import acyclic as AC
    from bunmpc_tpu.mpc.motions.solo12_acyclic import MOTIONS
    from bunmpc_tpu.robots.solo12 import Solo12Config

    assert jax.config.jax_enable_x64
    out = {}
    for name in names or MOTIONS:
        spec = AC.make_acyclic_spec(Solo12Config.load_model(), MOTIONS[name],
                                    plan_freq=PLAN_FREQ.get(name))
        plan = jax.jit(jax.vmap(lambda q, v, t, spec=spec: AC.solve_acyclic_mpc(
            spec, q, v, t)))(*[jnp.asarray(a, jnp.float64) for a in inputs(name)])
        for f in plan._fields:
            out[f"{name}/{f}"] = np.asarray(getattr(plan, f))
        print(f"{name}: H {spec.horizon}, IK H {spec.ik_hor}, size {spec.size}, t "
              f"{inputs(name)[2]}, dyn_violation {out[f'{name}/dyn_violation']}, iters "
              f"{out[f'{name}/admm_iters']}", flush=True)
    return out


def reference() -> dict:
    return solves()


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(FIXTURE, **reference())
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
