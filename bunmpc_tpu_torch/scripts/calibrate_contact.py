"""Contact-model calibration against the reference's closed loop.

Counterpart of ``scripts/calibrate_contact.py``: with the reference's
gains (kp=3/kd=0.05) and its verbatim trot table, sweep the implicit
contact model's ``ContactParams`` (kn, dn, kt) as the episodes of one
``rollout_mpc`` call, each episode PD-settled first on its own contact
(``settle_state`` with per-episode ``sim_params``); record the closed-loop
contact observables (duty factor against the plan's 0.6, touchdown peak
force, penetration, roll envelope, height error) per row, rank the rows
(survive, then survival time, then roll), and the same observables of the
shipped ``trot_sim`` configuration as the baseline.

    python -m bunmpc_tpu_torch.scripts.calibrate_contact [out.json] [T_ms]

On the card each window runs K1 and K2 once; ``device=cpu`` runs their
plain versions. Writes ``out.json`` (default
``artifacts/torch_contact_calibration_solo12.json``) under the JAX
script's keys.
"""

import itertools
import os
import sys
import time

import numpy as np

VX = 0.3
KNS = [2e3, 4e3, 1e4, 3e4]
DNS = [50.0, 150.0, 500.0]
KTS = [150.0, 500.0, 1500.0]
SIM_CONTACT = {"kn": 1e4, "dn": 500.0, "kt": 500.0}  # the trot_sim baseline's


def contact_metrics(spec, res, cfg, T: int) -> dict:
    """Closed-loop contact observables of each episode of ``res`` (tensors or
    arrays, leading axis B) over the post-settle window from 500 ms to the
    failure: duty factor, peak normal force at touchdowns, mean and max
    penetration of the 0.018 m foot, roll envelope and the last 1000 ms'
    height error."""
    from ._common import attitude, host

    nv = spec.model.nv
    incnt = host(res.in_contact)  # (B, T, ne)
    forces = host(res.contact_forces)  # (B, T, ne, 3)
    cpos = host(res.contact_pos)  # (B, T, ne, 3)
    failed = host(res.failed)
    fail_step = np.where(failed, host(res.fail_step), T)
    # post-settle steady window
    w0 = 500
    B = incnt.shape[0]
    duty, imp, pen_mean, pen_max, roll_max, z_dev = [], [], [], [], [], []
    rpy, z, _ = attitude(host(res.states), nv)
    foot_r = 0.018
    for b in range(B):
        Tb = int(fail_step[b])
        w = slice(w0, max(Tb, w0 + 1))
        duty.append(float(incnt[b, w].mean()))
        # touchdown impulse: peak normal force at 0->1 contact transitions
        trans = (incnt[b, 1:] > incnt[b, :-1]) & (np.arange(1, incnt.shape[1])[:, None] < Tb)
        fz = forces[b, 1:, :, 2]
        imp.append(float(fz[trans].max()) if trans.any() else 0.0)
        pen = np.clip(foot_r - cpos[b, w, :, 2], 0.0, None)
        pen_in = pen[incnt[b, w]]
        pen_mean.append(float(pen_in.mean()) if pen_in.size else 0.0)
        pen_max.append(float(pen.max()) if pen.size else 0.0)
        roll_max.append(float(np.rad2deg(np.abs(rpy[b, w, 0]).max())))
        z_dev.append(float(np.abs(z[b, max(Tb - 1000, w0):Tb].mean() - spec.params.nom_ht))
                     if Tb > w0 else float("nan"))
    return {
        "failed": failed.tolist(),
        "survival_ms": fail_step.tolist(),
        "duty_factor": duty,
        "touchdown_peak_fz": imp,
        "penetration_mean": pen_mean,
        "penetration_max": pen_max,
        "roll_max_deg": roll_max,
        "z_dev_end": z_dev,
    }


def score(r):
    """The ranking: survivors first, then longer survival, then smaller roll."""
    return (
        0 if not r["failed"] else 1,
        -r["survival_ms"],
        r["roll_max_deg"] if np.isfinite(r["roll_max_deg"]) else 1e9,
    )


def main(argv=None) -> int:
    import torch

    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import trot, trot_sim
    from ..robots.solo12 import Solo12Config
    from ..sim import physics, rollout
    from ..utils import jsonio
    from ..utils.runtime import device_label, setup_torch
    from ._common import arg, repo_root, split_args

    pos, device = split_args(argv)
    device = setup_torch(device)
    out = arg(pos, 0, str, os.path.join(repo_root(), "artifacts",
                                         "torch_contact_calibration_solo12.json"))
    T = arg(pos, 1, int, 3000)

    model = Solo12Config.load_model()
    q0 = Solo12Config.q0()
    spec_ref = KD.make_cyclic_spec(model, trot, q0, device=device)  # the reference's table
    cfg = rollout.RolloutConfig(episode_length=T, kp=trot.kp, kd=trot.kd,
                                gait_period=trot.gait_period)
    f32 = dict(dtype=torch.float32, device=spec_ref.device)
    v_des = torch.as_tensor([[VX, 0.0, 0.0]], **f32)

    # --- the grid over ContactParams with the reference's gains ---
    grid = list(itertools.product(KNS, DNS, KTS))
    B = len(grid)
    sps = physics.SimParams(contact=physics.ContactParams(
        foot_radius=torch.full((B,), 0.018, **f32),
        kn=torch.as_tensor([g[0] for g in grid], **f32),
        dn=torch.as_tensor([g[1] for g in grid], **f32),
        mu=torch.full((B,), 1.0, **f32),
        kt=torch.as_tensor([g[2] for g in grid], **f32)))
    print(f"sweep: {B} contact-param rows, reference gains kp={trot.kp}/kd={trot.kd}", flush=True)
    t0 = time.time()
    # settled per episode on its own contact (the drop must not decide the sweep)
    s0 = physics.SimState(q=torch.as_tensor(np.tile(q0, (B, 1)), **f32),
                          v=torch.zeros((B, model.nv), **f32))
    s0 = rollout.settle_state(model, tuple(spec_ref.eff_frames), sps, s0, trot.kp, trot.kd,
                              ms=500)
    res = rollout.rollout_mpc(spec_ref, sps, cfg, s0, v_des.repeat(B, 1),
                              torch.zeros(B, **f32))
    met = contact_metrics(spec_ref, res, cfg, T)
    sweep_s = time.time() - t0
    rows = [{"kn": kn, "dn": dn, "kt": kt, **{k: met[k][i] for k in met}}
            for i, (kn, dn, kt) in enumerate(grid)]
    best = sorted(rows, key=score)[0]
    print("best row:", best, flush=True)

    # --- the baseline: the shipped trot_sim configuration ---
    spec_sim = KD.make_cyclic_spec(model, trot_sim, q0, device=device)
    cfg_sim = rollout.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
    sp_sim = physics.SimParams(contact=physics.ContactParams(**SIM_CONTACT))
    s1 = physics.SimState(q=torch.as_tensor(q0[None], **f32), v=torch.zeros((1, model.nv), **f32))
    s1 = rollout.settle_state(model, tuple(spec_sim.eff_frames), sp_sim, s1, trot_sim.kp,
                              trot_sim.kd, ms=500)
    res_sim = rollout.rollout_mpc(spec_sim, sp_sim, cfg_sim, s1, v_des, torch.zeros(1, **f32))
    baseline = {k: v[0] for k, v in contact_metrics(spec_sim, res_sim, cfg_sim, T).items()}
    print("trot_sim baseline:", baseline, flush=True)

    artifact = {
        "meta": {
            "robot": "solo12", "vx": VX, "T_ms": T,
            "reference_gains": {"kp": trot.kp, "kd": trot.kd},
            "reference_table": "trot (verbatim, W_F=1e1)",
            "grid": {"kn": KNS, "dn": DNS, "kt": KTS, "mu": 1.0},
            "planned_duty_factor": float(np.mean(trot.stance_percent)),
            "device": device_label(device),
            "sweep_seconds": round(sweep_s, 1),
        },
        "best": best,
        "grid_rows": rows,
        "trot_sim_baseline": {"kp": trot_sim.kp, "kd": trot_sim.kd,
                              "contact": dict(SIM_CONTACT), **baseline},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    jsonio.write_json(out, artifact)
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
