"""The JAX package's closed loop on the inputs of ``tests/test_torch_rollout.py``,
kept as a fixture because tracing and compiling the JAX ``rollout_mpc`` (the
whole MPC inside a scan) takes 150-180 s a variant on a CPU.

Two windows (100 steps) of the Solo12 ``trot_sim`` loop for three episodes
in float64, ``vmap`` of ``rollout.rollout_mpc`` with tests/test_rollout.py's
fast solver settings (ADMM max_admm_iters=60, DDP n_iters=4), cold start
(``warm_start_carry=False``) and with (X, F, P) carried. The start is the
JAX package's 500 ms PD settle of q0 on the closed-loop simulator (kn=1e4,
dn=500, kt=500); the commands are ``bunmpc_tpu_torch.workload.command_draw(3)``.

Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_rollout_reference.py
"""

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_rollout_solo12_trot_sim.npz")
B, T = 3, 100
FIELDS = ("states", "actions", "vc_goals", "base", "com", "contact_forces", "contact_pos",
          "in_contact", "failed", "fail_step")


def reference() -> dict:
    """The inputs and both variants' records as numpy arrays (needs x64)."""
    import jax
    import jax.numpy as jnp

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
    eff = tuple(spec.eff_frames)
    s0 = rollout.settle_state(
        model, eff, sp, physics.SimState(q=jnp.asarray(Solo12Config.q0()), v=jnp.zeros(model.nv)),
        trot_sim.kp, trot_sim.kd)
    v_des, w_des = command_draw(B)
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    admm = biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60)
    ddp_cfg = ddp.DdpConfig(n_iters=4)
    out = {"q0": np.asarray(s0.q), "v0": np.asarray(s0.v), "v_des": v_des, "w_des": w_des}
    qb, vb = jnp.tile(s0.q[None], (B, 1)), jnp.tile(s0.v[None], (B, 1))
    for name, carry in (("cold", False), ("carry", True)):
        res = jax.jit(jax.vmap(lambda q, v, vd, wd: rollout.rollout_mpc(
            spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd, admm_cfg=admm, ddp_cfg=ddp_cfg,
            warm_start_carry=carry)))(qb, vb, jnp.asarray(v_des), jnp.asarray(w_des))
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
