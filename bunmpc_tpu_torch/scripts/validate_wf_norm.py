"""Mass-normalized force regularization against the shipped tables.

Counterpart of ``scripts/validate_wf_norm.py``: per robot, one closed-loop
episode of (a) the shipped table (``f_reg_style="zero"`` with its per-robot
W_F scale) and (b) the reference's W_F value with ``f_reg_style="weight"``
(the force regularized toward the weight-distributed nominal force, so one
table transfers across robots), each from the PD-settled q0, reporting
survival, the roll and pitch envelopes, the height error and the forward
speed.

    python -m bunmpc_tpu_torch.scripts.validate_wf_norm [out.json] [T_ms]

On the card each window runs K1 and K2 once; ``device=cpu`` runs their
plain versions. Writes ``out.json`` (default
``artifacts/torch_wf_normalization.json``) under the JAX script's keys.
"""

import dataclasses
import os
import sys
import time

import numpy as np

VX = 0.3


def run_case(name, model, params, q0, sp, eff_kwargs, T, sb=None, fg=None, device=None):
    """One case's episode and its row (the JAX script's ``run_case``)."""
    import torch

    from ..mpc import kino_dyn as KD
    from ..sim import physics, rollout
    from ._common import attitude, host

    spec = KD.make_cyclic_spec(model, params, q0, device=device, **eff_kwargs)
    cfg = rollout.RolloutConfig(episode_length=T, kp=params.kp, kd=params.kd,
                                gait_period=params.gait_period)
    f32 = dict(dtype=torch.float32, device=spec.device)
    s0 = physics.SimState(q=torch.as_tensor(np.asarray(q0)[None], **f32),
                          v=torch.zeros((1, model.nv), **f32))
    s0 = rollout.settle_state(model, tuple(spec.eff_frames), sp, s0, params.kp, params.kd)
    t0 = time.time()
    res = rollout.rollout_mpc(spec, sp, cfg, s0, torch.as_tensor([[VX, 0.0, 0.0]], **f32),
                              torch.zeros(1, **f32), swing_blend=sb, force_gate=fg)
    rpy, z, vx = attitude(host(res.states[0]), model.nv)
    failed = bool(res.failed[0])
    win = slice(500, T)
    out = {
        "case": name,
        "f_reg_style": params.f_reg_style,
        "W_F_xyz": np.asarray(params.W_F[:3]).tolist(),
        "failed": failed,
        "survival_ms": int(res.fail_step[0]) if failed else T,
        "roll_max_deg": float(np.rad2deg(np.abs(rpy[win, 0]).max())),
        "pitch_max_deg": float(np.rad2deg(np.abs(rpy[win, 1]).max())),
        "z_dev_end_mm": float(abs(z[-1000:].mean() - params.nom_ht) * 1000.0),
        "vx_end": float(vx[-1000:].mean()),
        "seconds": round(time.time() - t0, 1),
    }
    print(name, out, flush=True)
    return out


def cases():
    """The four cases as ``(name, robot, params, sim_params, sb, fg)``:
    each robot's shipped ``trot_sim`` and its weight-style twin."""
    from ..mpc.motions.go2_cyclic import trot_sim as g_trot_sim
    from ..mpc.motions.solo12_cyclic import trot, trot_sim
    from ..robots.go2 import Go2Config
    from ..sim import physics

    s_sp = physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))
    # the weight style at the shared table value W_F=1e0: the candidate that
    # transfers across robots
    trot_sim_w = dataclasses.replace(trot, motion_name="trot_sim", kp=trot_sim.kp, kd=trot_sim.kd,
                                     W_F=trot.W_F * 0.1, f_reg_style="weight")
    g_sp = physics.SimParams(
        contact=physics.ContactParams(foot_radius=Go2Config.foot_size, kn=6e4, dn=3000.0,
                                      kt=3000.0, mu=1.0),
        torque_limit=23.7)
    g_trot_w = dataclasses.replace(g_trot_sim, W_F=np.array([1e0, 1e0, 1e0] * 4),
                                   f_reg_style="weight")
    return [
        ("solo12_trot_sim_zero", "solo12", trot_sim, s_sp, None, None),
        ("solo12_trot_sim_weight", "solo12", trot_sim_w, s_sp, None, None),
        ("go2_trot_sim_zero", "go2", g_trot_sim, g_sp, 0.5, 1.0),
        ("go2_trot_sim_weight", "go2", g_trot_w, g_sp, 0.5, 1.0),
    ]


def main(argv=None) -> int:
    from ..robots.go2 import Go2Config
    from ..robots.solo12 import Solo12Config
    from ..utils import jsonio
    from ..utils.runtime import device_label, setup_torch
    from ._common import arg, repo_root, split_args

    pos, device = split_args(argv)
    device = setup_torch(device)
    out_path = arg(pos, 0, str, os.path.join(repo_root(), "artifacts",
                                              "torch_wf_normalization.json"))
    T = arg(pos, 1, int, 3000)
    robots = {
        "solo12": (Solo12Config, {}),
        "go2": (Go2Config, dict(eff_frames=tuple(Go2Config.eff_names),
                                hip_frames=tuple(Go2Config.hip_names),
                                foot_size=Go2Config.foot_size)),
    }
    results = []
    for name, robot, params, sp, sb, fg in cases():
        C, kw = robots[robot]
        results.append(run_case(name, C.load_model(), params, C.q0(), sp, kw, T, sb=sb, fg=fg,
                                device=device))
    doc = {"meta": {"vx": VX, "T_ms": T, "device": device_label(device)}, "results": results}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    jsonio.write_json(out_path, doc)
    print("wrote", out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
