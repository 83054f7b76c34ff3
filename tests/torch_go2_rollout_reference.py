"""The JAX package's Go2 closed loop with every per-episode option, on the
inputs of ``tests/test_torch_go2_rollout.py``, kept as a fixture because
tracing and compiling the JAX ``rollout_mpc`` takes minutes a variant on a
CPU.

Two windows (100 steps) of the Go2 ``trot_sim`` loop for three episodes in
float64, ``vmap`` of ``rollout.rollout_mpc`` over per-episode PD gains,
contact parameters, ``swing_blend``, ``force_gate``, sensor biases
``q_noise``/``v_noise`` and commands, with tests/test_rollout.py's fast
solver settings (ADMM max_admm_iters=60, DDP n_iters=4). The episodes are
rows ``ROWS`` of the JAX package's Go2 stability sweep
(``bunmpc_tpu_torch.workload.go2_sweep_grid``), each started from the JAX
package's 500 ms PD settle of q0 at its own gains on its own contact, as
scripts/sweep_stability.py settles. Variants: ``options`` with the spec's
default warm start (the "vdes" start, no carry) and ``carry`` with (X, F, P)
carried (``warm_start_carry=True``: the "vdes" cold start where the carry is
not taken). ``policy``: 50 steps of ``rollout.rollout_policy`` from the same
starts on the same simulators with the same sensor biases, the policy the
linear map ``policy_action`` (pd_target at trot_sim's gains).

Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_go2_rollout_reference.py
"""

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_rollout_go2_trot_sim.npz")
T = 100
# sweep rows: kp 60 / kn 6e4 / swing_blend 0.5, force_gate 1 (the walking
# configuration); kp 60 / kn 1.2e5 / 0.5, 0; kp 40 / kn 6e4 / 0.2, 1
ROWS = (31, 37, 23)
B = len(ROWS)
VX = (0.3, 0.2, 0.25)
FIELDS = ("states", "actions", "vc_goals", "base", "com", "contact_forces", "contact_pos",
          "in_contact", "failed", "fail_step")
VARIANTS = {"options": None, "carry": True}


def options() -> dict:
    """The episodes' per-episode options as float64 numpy arrays: the sweep
    rows' gains, contact, swing_blend and force_gate, the commands and the
    sensor biases (seed 7)."""
    from bunmpc_tpu_torch.workload import go2_sweep_grid

    grid = go2_sweep_grid()
    out = {k: v[list(ROWS)] for k, v in grid.items()}
    rng = np.random.default_rng(7)
    q_noise = np.zeros((B, 19))
    q_noise[:, 2] = rng.normal(size=B) * 0.003
    q_noise[:, 3:7] = rng.normal(size=(B, 4)) * 0.01
    q_noise[:, 7:] = rng.normal(size=(B, 12)) * 0.01
    out.update(v_des=np.stack([np.asarray(VX), np.zeros(B), np.zeros(B)], -1), w_des=np.zeros(B),
               q_noise=q_noise, v_noise=rng.normal(size=(B, 18)) * 0.02)
    return out


POLICY_T = 50


def policy_weights():
    """The policy's weights: (43, 12) on the state features, (5, 12) on the
    vc goal (seed 5)."""
    rng = np.random.default_rng(5)
    return rng.normal(size=(43, 12)) * 0.05, rng.normal(size=(5, 12)) * 0.05


def policy_action(xp, feat, goal, wf, wg, q0j):
    """q0's joints plus 0.02 tanh(feat wf + goal wg), in the array module
    ``xp`` (numpy-like: jax.numpy or torch)."""
    return q0j + 0.02 * xp.tanh(feat @ wf + goal @ wg)


def reference() -> dict:
    """The inputs, the settled starts and both variants' records as numpy
    arrays (needs x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.go2_cyclic import trot_sim
    from bunmpc_tpu.robots.go2 import Go2Config as C
    from bunmpc_tpu.sim import controllers, physics, rollout
    from bunmpc_tpu.solvers import biconvex, ddp

    assert jax.config.jax_enable_x64
    model = C.load_model()
    spec = KD.make_cyclic_spec(model, trot_sim, C.q0(), eff_frames=tuple(C.eff_names),
                               hip_frames=tuple(C.hip_names), foot_size=C.foot_size)
    eff = tuple(spec.eff_frames)
    o = options()
    f = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    full = lambda x: jnp.full(B, x, jnp.float64)  # noqa: E731
    sp = physics.SimParams(
        contact=physics.ContactParams(foot_radius=full(C.foot_size), kn=f(o["kn"]),
                                      dn=f(o["dn"]), kt=f(o["kt"]), mu=full(1.0)),
        joint_damping=full(0.02), torque_limit=full(23.7))
    gains = controllers.IdControllerGains(kp=f(o["kp"]), kd=f(o["kd"]))
    s0 = physics.SimState(q=jnp.asarray(C.q0()), v=jnp.zeros(model.nv))
    settled = jax.jit(jax.vmap(lambda p, kp, kd: rollout.settle_state(
        model, eff, p, s0, kp, kd)))(sp, gains.kp, gains.kd)
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    admm = biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60)
    ddp_cfg = ddp.DdpConfig(n_iters=4)
    out = dict(o, q0=np.asarray(settled.q), v0=np.asarray(settled.v))
    for name, carry in VARIANTS.items():
        res = jax.jit(jax.vmap(lambda s, vd, wd, p, g, sb, fg, qn, vn: rollout.rollout_mpc(
            spec, p, cfg, s, vd, wd, q_noise=qn, v_noise=vn, admm_cfg=admm, ddp_cfg=ddp_cfg,
            gains=g, warm_start_carry=carry, swing_blend=sb, force_gate=fg)))(
            settled, f(o["v_des"]), f(o["w_des"]), sp, gains, f(o["swing_blend"]),
            f(o["force_gate"]), f(o["q_noise"]), f(o["v_noise"]))
        for fld in FIELDS:
            out[f"{name}/{fld}"] = np.asarray(getattr(res, fld))
        out[f"{name}/final_q"] = np.asarray(res.final_state.q)
        out[f"{name}/final_v"] = np.asarray(res.final_state.v)
        print(f"{name}: failed {out[f'{name}/failed']}", flush=True)
    wf, wg = (jnp.asarray(w) for w in policy_weights())
    q0j = jnp.asarray(C.q0()[7:])
    pcfg = rollout.RolloutConfig(episode_length=POLICY_T, kp=trot_sim.kp, kd=trot_sim.kd,
                                 gait_period=trot_sim.gait_period)
    res = jax.jit(jax.vmap(lambda s, vd, wd, p, qn, vn: rollout.rollout_policy(
        spec, p, pcfg, s, vd, wd, lambda feat, goal: policy_action(jnp, feat, goal, wf, wg, q0j),
        q_noise=qn, v_noise=vn)))(settled, f(o["v_des"]), f(o["w_des"]), sp, f(o["q_noise"]),
                                  f(o["v_noise"]))
    for fld in FIELDS:
        out[f"policy/{fld}"] = np.asarray(getattr(res, fld))
    out["policy/final_q"] = np.asarray(res.final_state.q)
    out["policy/final_v"] = np.asarray(res.final_state.v)
    return out


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(FIXTURE, **reference())
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
