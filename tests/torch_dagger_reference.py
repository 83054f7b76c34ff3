"""The JAX package's expert-gated and per-episode-start rollouts on the inputs
of ``tests/test_torch_dagger.py``, kept as a fixture because tracing and
compiling a JAX rollout (the whole MPC inside a scan) takes minutes a
variant on a CPU.

Three episodes of 100 steps (two windows) of the Solo12 ``trot_sim`` loop in
float64, with tests/test_rollout.py's fast solver settings (ADMM
max_admm_iters=60, DDP n_iters=4), each episode with its own start time
(START_TIMES: a replanning point of the first gait cycle, as the DAgger
drivers' perturbed starts have, and one past the first second, as their
ending rollouts have):

* ``safedagger``: ``vmap(rollout_safedagger)`` with num_steps_to_block=30;
  episode 0 starts rolled 25.5 deg (past the 25 deg danger box) and 2 cm
  higher (``q_tilt``), so that the MPC takes over at step 0 and releases
  it at step 75; the other variants start every episode settled;
* ``dagger``: ``vmap(rollout_dagger)`` with mpc_usage_percentage 0.5 on keys
  whose coins take both values (stored as ``dagger/coins``);
* ``mpc``: ``vmap(rollout_mpc)`` with the default carry of (X, F, P);
* ``policy``: ``vmap(rollout_policy)``.

The policy is the vc hold-pose policy of
tests/fixtures/torch_policy_rollout_solo12_trot_sim.npz
(tests/torch_learning_reference.py); the settled start and the commands are
those of tests/fixtures/torch_rollout_solo12_trot_sim.npz.

The JAX package's jitted round puts two of these window clocks (0.35 s and
1.15 s) one ulp above the port's (numpy's round); the fixture keeps the JAX
package's clocks (``jax_clocks``), and tests/test_torch_dagger.py says so
and compares the records on them.

Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_dagger_reference.py
"""

import os

import numpy as np

import torch_learning_reference as POLICY_REF
import torch_rollout_reference as ROLLOUT_REF

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_gated_rollout_solo12_trot_sim.npz")
B, T = 3, 100
START_TIMES = np.array([0.05, 0.35, 1.1])
NUM_STEPS_TO_BLOCK = 30
TILT_DEG, TILT_LIFT = 25.5, 0.02
DAGGER_SEED = 1
FIELDS = ROLLOUT_REF.FIELDS + ("mpc_usage",)
VARIANTS = ("safedagger", "dagger", "mpc", "policy")


def tilted_start(q0):
    """(B, nq) copies of the settled q0; episode 0 rolled TILT_DEG about the
    base x axis and lifted TILT_LIFT."""
    q = np.tile(q0, (B, 1))
    a = np.deg2rad(TILT_DEG)
    q[0, 3:7] = [np.sin(a / 2), 0.0, 0.0, np.cos(a / 2)]
    q[0, 2] += TILT_LIFT
    return q


def jax_window_clocks(start_times, n_windows):
    """The JAX package's window clocks, (B, n_windows): its ``jnp.round`` is
    jitted, and XLA computes round(x, 3) as rint(x * 1000) * (1/1000)."""
    import jax
    import jax.numpy as jnp

    st = jnp.asarray(start_times, jnp.float64)[:, None]
    w = jnp.arange(n_windows)[None, :]
    return np.asarray(jax.jit(lambda s, k: jnp.round(s + k * 0.05 * 1.0, 3))(st, w))


def reference() -> dict:
    """The inputs and the four variants' records as numpy arrays (needs x64)."""
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
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    start = np.load(ROLLOUT_REF.FIXTURE)
    pol = dict(np.load(POLICY_REF.FIXTURE))
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    admm = biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60)
    ddp_cfg = ddp.DdpConfig(n_iters=4)
    module, _ = init_policy(jax.random.PRNGKey(0), 48, num_hidden_layer=POLICY_REF.HIDDEN[0],
                            hidden_dim=POLICY_REF.HIDDEN[1])
    policy = policy_fn_from_tree(module, {
        "params": POLICY_REF.unflat_params(pol, "vc/params"), "state_mean": pol["state_mean"],
        "state_std": pol["state_std"], "goal_mean": pol["vc/goal_mean"],
        "goal_std": pol["vc/goal_std"]})
    keys = jax.random.split(jax.random.PRNGKey(DAGGER_SEED), B)
    coins = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (cfg.n_windows,)) < 0.5)(keys))
    assert coins.any() and not coins.all()
    q_tilt = tilted_start(start["q0"])
    out = {"q0": start["q0"], "v0": start["v0"], "q_tilt": q_tilt, "v_des": start["v_des"],
           "w_des": start["w_des"], "start_times": START_TIMES, "dagger/coins": coins,
           "jax_clocks": jax_window_clocks(START_TIMES, cfg.n_windows)}
    kw = dict(admm_cfg=admm, ddp_cfg=ddp_cfg)

    def state(q, v):
        return physics.SimState(q=q, v=v)

    one = {
        "safedagger": lambda q, v, vd, wd, st, key: rollout.rollout_safedagger(
            spec, sp, cfg, state(q, v), vd, wd, policy, num_steps_to_block=NUM_STEPS_TO_BLOCK,
            start_time=st, **kw),
        "dagger": lambda q, v, vd, wd, st, key: rollout.rollout_dagger(
            spec, sp, cfg, state(q, v), vd, wd, policy, key, mpc_usage_percentage=0.5,
            start_time=st, **kw),
        "mpc": lambda q, v, vd, wd, st, key: rollout.rollout_mpc(
            spec, sp, cfg, state(q, v), vd, wd, start_time=st, **kw),
        "policy": lambda q, v, vd, wd, st, key: rollout.rollout_policy(
            spec, sp, cfg, state(q, v), vd, wd, policy, start_time=st),
    }
    vb = jnp.tile(jnp.asarray(start["v0"])[None], (B, 1))
    for name in VARIANTS:
        qb = q_tilt if name == "safedagger" else np.tile(start["q0"], (B, 1))
        res = jax.jit(jax.vmap(one[name]))(
            jnp.asarray(qb), vb, jnp.asarray(start["v_des"]), jnp.asarray(start["w_des"]),
            jnp.asarray(START_TIMES), keys)
        for f in FIELDS:
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
        out[f"{name}/final_q"] = np.asarray(res.final_state.q)
        out[f"{name}/final_v"] = np.asarray(res.final_state.v)
    return out


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(FIXTURE, **reference())
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
