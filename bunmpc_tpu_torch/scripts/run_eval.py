"""Evaluation-suite driver (CLI): velocity grids, the cc-replanning ablation,
the past-goals matrix, max-force robustness.

Counterpart of ``scripts/run_eval.py`` (reference
behavioral_cloning_vc_evaluation_*.py,
behavioral_cloning_evaluation_effects_of_cc_replanning.py,
max_force_search.py, test_sweep_policy.py):

    python -m bunmpc_tpu_torch.scripts.run_eval mode=mpc_grid  [vx=-0.3:0.5:5 w=0:0:1 ...]
    python -m bunmpc_tpu_torch.scripts.run_eval mode=policy_grid policy=models/x/policy
    python -m bunmpc_tpu_torch.scripts.run_eval mode=cc_replanning vc_policy=... cc_policy=...
    python -m bunmpc_tpu_torch.scripts.run_eval mode=max_force
    python -m bunmpc_tpu_torch.scripts.run_eval mode=past_goals n_goals=5 out=pg.csv

Results print as a summary dict and export to CSV (``out=...csv``);
``device=cpu`` runs on the CPU (the card otherwise). Policies are
checkpoints of either package (``utils/checkpoint.load_policy``).
"""

import sys

import numpy as np


def _parse_range(s, default):
    """"lo:hi:n" -> linspace; single number -> [x]."""
    if s is None:
        return np.asarray(default)
    if ":" in s:
        lo, hi, n = s.split(":")
        return np.linspace(float(lo), float(hi), int(n))
    return np.asarray([float(s)])


def main(argv=None) -> int:
    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import GAITS, trot
    from ..robots.solo12 import Solo12Config
    from ..sim import physics, rollout
    from ..utils.checkpoint import load_policy
    from ..utils.runtime import setup_torch

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else list(argv)))
    device = setup_torch(args.get("device"))
    mode = args.get("mode", "mpc_grid")
    gait = GAITS.get(args.get("gait", "trot"), trot)

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, gait, Solo12Config.q0(), device=device)
    sim_params = physics.SimParams(contact=physics.ContactParams(mu=1.0))
    cfg = rollout.RolloutConfig(
        episode_length=int(args.get("episode_length", 2000)),
        kp=gait.kp,
        kd=gait.kd,
        gait_period=gait.gait_period,
    )
    state0 = physics.SimState(q=Solo12Config.q0(), v=np.zeros(model.nv))
    vx = _parse_range(args.get("vx"), np.linspace(-0.2, 0.4, 4))
    w = _parse_range(args.get("w"), [0.0])
    out = args.get("out")

    if mode == "mpc_grid":
        from ..eval import velocity_grid

        res = velocity_grid.eval_mpc_grid(spec, sim_params, cfg, state0, vx, w_values=w)
    elif mode == "policy_grid":
        from ..eval import velocity_grid

        pol = load_policy(args["policy"], device=device)
        res = velocity_grid.eval_policy_grid(
            spec, sim_params, cfg, state0, pol, vx, w_values=w
        )
    elif mode == "cc_replanning":
        from ..eval import cc_replanning

        vc_pol = load_policy(args["vc_policy"], device=device)
        cc_pol = load_policy(args["cc_policy"], device=device)
        grid = [(x, ww) for x in vx for ww in w]
        res = cc_replanning.compare_cc_replanning(
            spec, sim_params, cfg, state0, vc_pol, cc_pol,
            v_des_batch=np.asarray([[x, 0.0, 0.0] for x, _ in grid]),
            w_des_batch=np.asarray([ww for _, ww in grid]),
            goal_horizon=int(args.get("goal_horizon", 1)),
        )
    elif mode == "past_goals":
        from ..eval.past_goals import run_past_goals_eval
        from ..learning.bc import BcConfig

        n_goals = int(args.get("n_goals", 5))
        vx_lo, vx_hi = (float(x) for x in args.get("vx_range", "0.0,0.4").split(","))
        goals = np.stack([
            np.linspace(vx_lo, vx_hi, n_goals),
            np.zeros(n_goals), np.zeros(n_goals), np.zeros(n_goals),
        ], axis=1)
        res = run_past_goals_eval(
            spec, sim_params, cfg, Solo12Config.q0(), np.zeros(18), goals,
            bc_cfg=BcConfig(n_epoch=int(args.get("bc_epochs", 50))),
        )
        print({"forgetting": res.forgetting()})
        if out:
            res.to_csv(out)
            print("wrote", out)
        return 0
    elif mode == "max_force":
        from ..eval import max_force

        f_max, hist = max_force.max_force_search(
            spec, sim_params, cfg, state0,
            v_des=np.asarray([float(args.get("vx_des", 0.0)), 0.0, 0.0]),
            w_des=float(args.get("w_des", 0.0)),
            f_high=float(args.get("f_high", 30.0)),
            n_bisect=int(args.get("n_bisect", 5)),
        )
        print({"f_max": f_max, "history": hist})
        return 0
    else:
        raise SystemExit(f"unknown mode {mode!r}")

    print(res.summary())
    if out:
        res.to_csv(out)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
