"""The JAX package's policy rollouts on the inputs of
``tests/test_torch_policy_rollout.py``, kept as a fixture because tracing
and compiling the JAX ``rollout_policy`` scan takes minutes on a CPU.

Three episodes of 100 steps of the Solo12 ``trot_sim`` loop in float64
(``vmap`` of ``rollout.rollout_policy`` with vc goals and of
``rollout.rollout_policy_cc`` with cc goals), each driven by a small flax
``GoalConditionedPolicyNet`` (2 x 32, ``PRNGKey(0)``/``PRNGKey(1)``) whose
head is scaled by 0.03 and biased to the nominal joint angles, so that the
policy holds the pose with a small learned-looking feedback. The start is
the settled state of tests/fixtures/torch_rollout_solo12_trot_sim.npz, the
commands ``bunmpc_tpu_torch.workload.command_draw(3)``, the simulator the
closed-loop one (kn=1e4, dn=500, kt=500). The cc variant's schedules are the
JAX ``ContactPlanner``'s touchdowns per foot, padded by repeating each
foot's last touchdown (the JAX planner pads each foot with zero rows, on
which the JAX ``cc_goal_fn``'s search lands past every touchdown).

Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_learning_reference.py
"""

import os

import numpy as np

import torch_rollout_reference as ROLLOUT_REF

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_policy_rollout_solo12_trot_sim.npz")
B, T = 3, 100
HIDDEN = (2, 32)
FIELDS = ROLLOUT_REF.FIELDS


def repeat_pad(per_foot, n=None):
    """Per-foot (n_k, 4) touchdown rows -> (n_eff, n, 4) (n defaults to the
    largest n_k), each foot padded by repeating its last row (zero rows for a
    foot with none)."""
    n = max(max(len(r) for r in per_foot), 1) if n is None else n
    out = np.zeros((len(per_foot), n, 4))
    for ee, r in enumerate(per_foot):
        if len(r):
            out[ee, : len(r)] = r
            out[ee, len(r):] = r[-1]
    return out


def jax_touchdowns(planner, q0, v0, v_des, w_des, episode_length, start_time=0.0):
    """The JAX ``ContactPlanner``'s touchdowns of one episode, per foot
    ((n_k, 4) rows [step, x, y, z] in time order)."""
    cnt_plan, _ = planner.get_raibert_contact_plan(q0, v0, v_des, w_des, episode_length,
                                                   start_time)
    sw = planner.get_switches(cnt_plan, start_time / planner.sim_dt)
    ne = len(planner.spec.eff_frames)
    return [sw[sw[:, 0] == ee, 1:5] for ee in range(ne)]


def flat_params(params, prefix="params"):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflat_params(d, prefix):
    """The flax params tree stored by ``flat_params`` under ``prefix``."""
    tree = {}
    for k, v in d.items():
        if k.startswith(prefix + "/"):
            layer, name = k[len(prefix) + 1:].split("/")
            tree.setdefault(layer, {})[name] = np.asarray(v)
    return tree


def reference() -> dict:
    """The inputs, the policies and both variants' records as numpy arrays
    (needs x64)."""
    import jax
    import jax.numpy as jnp

    from bunmpc_tpu.learning.contact_planner import ContactPlanner
    from bunmpc_tpu.learning.networks import init_policy, policy_fn_from_tree
    from bunmpc_tpu.mpc import kino_dyn as KD
    from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu.robots.solo12 import Solo12Config
    from bunmpc_tpu.sim import physics, rollout
    from bunmpc_tpu_torch.workload import command_draw

    assert jax.config.jax_enable_x64
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0())
    sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    start = np.load(ROLLOUT_REF.FIXTURE)
    q0, v0 = start["q0"], start["v0"]
    v_des, w_des = command_draw(B)
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    rng = np.random.default_rng(0)
    expert = start["cold/states"].reshape(-1, 43)
    out = {"q0": q0, "v0": v0, "v_des": v_des, "w_des": w_des,
           "state_mean": expert.mean(0), "state_std": expert.std(0) + 0.1}
    # cc goals [steps to touchdown, com_x - x, com_y - y] per foot
    out["cc/goal_mean"] = np.tile([250.0, 0.0, 0.0], 4) + rng.normal(size=12) * 0.01
    out["cc/goal_std"] = np.tile([150.0, 0.2, 0.2], 4) * rng.uniform(0.8, 1.2, size=12)
    out["vc/goal_mean"], out["vc/goal_std"] = np.zeros(5), np.ones(5)
    planner = ContactPlanner(spec)
    feet = [jax_touchdowns(planner, q0, v0, v_des[b], w_des[b], T) for b in range(B)]
    n = max(len(r) for f in feet for r in f)
    out["schedule"] = np.stack([repeat_pad(f, n) for f in feet])

    qb, vb = jnp.tile(jnp.asarray(q0)[None], (B, 1)), jnp.tile(jnp.asarray(v0)[None], (B, 1))
    for i, (name, n_goal) in enumerate((("vc", 5), ("cc", 12))):
        module, params = init_policy(jax.random.PRNGKey(i), 43 + n_goal, num_hidden_layer=HIDDEN[0],
                                     hidden_dim=HIDDEN[1])
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        head = f"Dense_{HIDDEN[0]}"
        params[head] = {"kernel": params[head]["kernel"] * 0.03,
                        "bias": np.asarray(Solo12Config.q0()[7:], np.float64)}
        out.update(flat_params(params, f"{name}/params"))
        tree = {"params": params, "state_mean": out["state_mean"], "state_std": out["state_std"],
                "goal_mean": out[f"{name}/goal_mean"], "goal_std": out[f"{name}/goal_std"]}
        policy = policy_fn_from_tree(module, tree)
        if name == "vc":
            def one(q, v, vd, wd, sched, policy=policy):
                return rollout.rollout_policy(spec, sp, cfg, physics.SimState(q=q, v=v), vd, wd,
                                              policy)
        else:
            def one(q, v, vd, wd, sched, policy=policy):
                return rollout.rollout_policy_cc(spec, sp, cfg, physics.SimState(q=q, v=v), vd,
                                                 wd, policy, sched)
        res = jax.jit(jax.vmap(one))(qb, vb, jnp.asarray(v_des), jnp.asarray(w_des),
                                     jnp.asarray(out["schedule"]))
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
