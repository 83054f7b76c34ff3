"""The JAX package's pushed and static-goal rollouts on the inputs of
``tests/test_torch_eval.py``, kept as a fixture because tracing and
compiling the JAX rollouts takes minutes on a CPU.

Three episodes of 100 steps (two replanning windows) of the Solo12
``trot_sim`` loop in float64, from the settled start of
tests/fixtures/torch_rollout_solo12_trot_sim.npz with the commands
``bunmpc_tpu_torch.workload.command_draw(3)``, on the closed-loop simulator
(kn=1e4, dn=500, kt=500):

* ``mpc``: ``vmap`` of ``rollout.rollout_mpc`` with a per-episode push
  (``PUSH``, the layout of ``eval/max_force.survival_fraction``) and
  tests/test_rollout.py's fast solver settings (ADMM max_admm_iters=60, DDP
  n_iters=4), cold start;
* ``policy``: ``vmap`` of ``rollout.rollout_policy`` with the same push and
  the vc policy of tests/fixtures/torch_policy_rollout_solo12_trot_sim.npz;
* ``cc_static``: ``vmap`` of ``rollout.rollout_policy`` with the cc policy of
  that fixture and ``goal_fn = lambda step, q: goals[step]`` on the goals of
  ``eval.cc_replanning.static_cc_goals`` (the ``cc_static`` variant of
  ``compare_cc_replanning``), with the desired schedules of
  ``eval.cc_replanning.desired_schedules``.

Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_eval_reference.py
"""

import os

import numpy as np

import torch_learning_reference as POLICY_REF
import torch_rollout_reference as ROLLOUT_REF

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_eval_solo12_trot_sim.npz")
B, T = 3, 100
FIELDS = ROLLOUT_REF.FIELDS
PUSH_START, PUSH_STEPS, PUSH_N = 30, 40, 6.0  # across the window boundary at step 50


def push():
    """(B, T, 3): episode b pushed by PUSH_N newtons in the plane at
    120 b degrees over steps PUSH_START..PUSH_START + PUSH_STEPS."""
    ang = 2.0 * np.pi * np.arange(B) / B
    d = np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], -1)
    p = np.zeros((B, T, 3))
    p[:, PUSH_START:PUSH_START + PUSH_STEPS] = PUSH_N * d[:, None]
    return p


def reference() -> dict:
    """The inputs and the three variants' records as numpy arrays (needs
    x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.eval import cc_replanning as CCR
    from bunmpc_tpu.learning.networks import init_policy, policy_fn_from_tree
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.sim import physics, rollout
    from bunmpc_tpu.solvers import biconvex, ddp
    from bunmpc_tpu_torch.workload import command_draw

    assert jax.config.jax_enable_x64
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    start = np.load(ROLLOUT_REF.FIXTURE)
    pol = dict(np.load(POLICY_REF.FIXTURE))
    q0, v0 = start["q0"], start["v0"]
    v_des, w_des = command_draw(B)
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    p = push()
    out = {"q0": q0, "v0": v0, "v_des": v_des, "w_des": w_des, "push": p}
    qb, vb = jnp.tile(jnp.asarray(q0)[None], (B, 1)), jnp.tile(jnp.asarray(v0)[None], (B, 1))
    vd, wd = jnp.asarray(v_des), jnp.asarray(w_des)

    def policy(name, n_goal):
        module, _ = init_policy(jax.random.PRNGKey(0), 43 + n_goal,
                                num_hidden_layer=POLICY_REF.HIDDEN[0],
                                hidden_dim=POLICY_REF.HIDDEN[1])
        tree = {"params": POLICY_REF.unflat_params(pol, f"{name}/params"),
                "state_mean": pol["state_mean"], "state_std": pol["state_std"],
                "goal_mean": pol[f"{name}/goal_mean"], "goal_std": pol[f"{name}/goal_std"]}
        return policy_fn_from_tree(module, tree)

    admm = biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60)
    ddp_cfg = ddp.DdpConfig(n_iters=4)
    runs = {"mpc": jax.jit(jax.vmap(lambda q, v, vd, wd, pb: rollout.rollout_mpc(
        spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, push_force=pb, admm_cfg=admm,
        ddp_cfg=ddp_cfg, warm_start_carry=False)))(qb, vb, vd, wd, jnp.asarray(p))}
    vc = policy("vc", 5)
    runs["policy"] = jax.jit(jax.vmap(lambda q, v, vd, wd, pb: rollout.rollout_policy(
        spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, vc, push_force=pb)))(
        qb, vb, vd, wd, jnp.asarray(p))
    sched = CCR.desired_schedules(spec, q0, v0, v_des, w_des, T)
    goals = CCR.static_cc_goals(spec, sched, q0, v_des, T)
    out["schedules"], out["static_goals"] = sched, goals
    cc = policy("cc", 12)
    runs["cc_static"] = jax.jit(jax.vmap(lambda q, v, vd, wd, g: rollout.rollout_policy(
        spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, cc,
        goal_fn=lambda step, _q: g[step])))(qb, vb, vd, wd, jnp.asarray(goals))
    for name, res in runs.items():
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
