"""The JAX package's closed loop on uneven ground, on the inputs of
``tests/test_torch_terrain.py``, kept as a fixture because tracing and
compiling the JAX ``rollout_mpc`` (the whole MPC inside a scan) takes
minutes on a CPU.

The ground is a 10% slope along x, ``heights = 0.1 x`` on a 0.1 m grid over
[-4, 4)^2 (``slope_heights()``, numpy). On it, in float64:

* ``step/*``: one ``physics.step`` of four perturbed Solo12 states with
  random torques (``step_inputs()``), jitted;
* ``mpc/*``: two windows (100 steps) of the Solo12 ``trot_sim`` loop for
  three episodes, ``vmap`` of ``rollout.rollout_mpc(terrain=...)`` with
  tests/test_rollout.py's fast solver settings (ADMM max_admm_iters=60, DDP
  n_iters=4) and the spec's default carry of (X, F, P), from the settled
  start and the commands of tests/fixtures/torch_rollout_solo12_trot_sim.npz;
* ``policy/*``: 100 steps of ``rollout.rollout_policy(terrain=...)`` from
  the same start, driven by the vc policy of
  tests/fixtures/torch_policy_rollout_solo12_trot_sim.npz.

Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_terrain_reference.py
"""

import os

import numpy as np

import torch_learning_reference as POLICY_REF
import torch_rollout_reference as ROLLOUT_REF

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_terrain.npz")
B, T = 3, 100
GRADE, EXTENT, CELL = 0.1, 4.0, 0.1
FIELDS = ROLLOUT_REF.FIELDS


def slope_heights():
    """The slope's grid, ``GRADE * x`` along the first axis (numpy)."""
    n = int(2 * EXTENT / CELL)
    x = -EXTENT + np.arange(n) * CELL
    return np.tile((GRADE * x)[:, None], (1, n))


def step_inputs():
    """Four Solo12 states about q0 (xy spread over the slope) and torques."""
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config

    rng = np.random.default_rng(7)
    q = np.tile(Solo12Config.q0(), (4, 1))
    q[:, 0:2] = rng.uniform(-1.0, 1.0, size=(4, 2))
    q[:, 2] += 0.1 * q[:, 0] - 0.01  # the feet near the local ground
    q[:, 7:] += rng.normal(size=(4, 12)) * 0.05
    v = rng.normal(size=(4, 18)) * 0.1
    tau = rng.normal(size=(4, 12))
    return q, v, tau


def reference() -> dict:
    """The inputs and the JAX package's results as numpy arrays (needs x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.learning.networks import init_policy, policy_fn_from_tree
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.sim import physics, rollout
    from bunmpc_tpu.solvers import biconvex, ddp

    assert jax.config.jax_enable_x64
    model = Solo12Config.load_model()
    eff = tuple(Solo12Config.eff_names)
    sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    terrain = physics.Terrain(heights=jnp.asarray(slope_heights()), origin=(-EXTENT, -EXTENT),
                              cell=CELL)
    out = {"heights": slope_heights()}

    q, v, tau = step_inputs()
    new, info = jax.jit(lambda q, v, tau: physics.step(
        model, eff, sp, physics.SimState(q=q, v=v), tau, terrain=terrain))(q, v, tau)
    out.update({"step/q": q, "step/v": v, "step/tau": tau, "step/q_next": np.asarray(new.q),
                "step/v_next": np.asarray(new.v), "step/forces": np.asarray(info.forces),
                "step/in_contact": np.asarray(info.in_contact)})

    start = np.load(ROLLOUT_REF.FIXTURE)
    q0, v0, v_des, w_des = start["q0"], start["v0"], start["v_des"], start["w_des"]
    qb, vb = jnp.tile(jnp.asarray(q0)[None], (B, 1)), jnp.tile(jnp.asarray(v0)[None], (B, 1))
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    admm = biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60)
    ddp_cfg = ddp.DdpConfig(n_iters=4)
    res = jax.jit(jax.vmap(lambda q, v, vd, wd: rollout.rollout_mpc(
        spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, terrain=terrain, admm_cfg=admm,
        ddp_cfg=ddp_cfg)))(qb, vb, jnp.asarray(v_des), jnp.asarray(w_des))
    for f in FIELDS:
        out[f"mpc/{f}"] = np.asarray(getattr(res, f))
    out["mpc/final_q"], out["mpc/final_v"] = np.asarray(res.final_state.q), np.asarray(
        res.final_state.v)

    pol = np.load(POLICY_REF.FIXTURE)
    module, _ = init_policy(jax.random.PRNGKey(0), 43 + 5, num_hidden_layer=POLICY_REF.HIDDEN[0],
                            hidden_dim=POLICY_REF.HIDDEN[1])
    tree = {"params": POLICY_REF.unflat_params(pol, "vc/params"),
            "state_mean": pol["state_mean"], "state_std": pol["state_std"],
            "goal_mean": pol["vc/goal_mean"], "goal_std": pol["vc/goal_std"]}
    policy = policy_fn_from_tree(module, tree)
    res = jax.jit(jax.vmap(lambda q, v, vd, wd: rollout.rollout_policy(
        spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, policy, terrain=terrain)))(
        qb, vb, jnp.asarray(v_des), jnp.asarray(w_des))
    for f in FIELDS:
        out[f"policy/{f}"] = np.asarray(getattr(res, f))
    out["policy/final_q"], out["policy/final_v"] = np.asarray(res.final_state.q), np.asarray(
        res.final_state.v)
    return out


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(FIXTURE, **reference())
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
