"""Gait-quality diagnostics of one closed-loop trot episode, Solo12 or Go2.

Counterpart of ``scripts/diagnose_gait.py``: the per-half-second attitude
envelopes, height drift and forward speed, the contact timing against the
gait plan (duty and touchdown lead/lag by cross-correlation per foot) and
velocity tracking of one ``rollout_mpc`` episode.

    python -m bunmpc_tpu_torch.scripts.diagnose_gait [solo12|go2] [vx] [episode_ms]
        [out_prefix] [kp] [kd] [nom_ht] [swing_blend] [kn] [carry] [force_gate] [settle_ms]

``kn`` sets kn and kn/20 for dn and kt; ``carry`` (0|1, default 1) the
loop's warm-start carry; ``settle_ms`` a stiff PD hold of q0 first. On the
card each window runs K1 and K2 once; ``device=cpu`` runs their plain
versions. Draws ``<out_prefix>_strip.png`` and ``<out_prefix>.gif``
(default prefix ``torch_diag_<robot>`` in the temporary directory) where
matplotlib and PIL are installed, and says so where they are not.
"""

import dataclasses
import importlib.util
import os
import sys
import tempfile

import numpy as np

FEET = ["FL", "FR", "HL", "HR"]


def build(robot: str, device):
    """``(spec, sim_params, config class, trot table)`` as the JAX script
    builds them: Solo12 on the default contact with mu 1, the Go2 on kn 2.4e4
    / dn 1800 / kt 1800 with its foot and torque limit."""
    from ..sim import physics
    from ._common import trot_spec

    spec, C, trot = trot_spec(robot, device)
    if robot == "solo12":
        sp = physics.SimParams(contact=physics.ContactParams(mu=1.0))
    else:
        sp = physics.SimParams(
            contact=physics.ContactParams(foot_radius=C.foot_size, kn=2.4e4, dn=1800.0,
                                          kt=1800.0, mu=1.0),
            torque_limit=23.7)
    return spec, sp, C, trot


def report(robot, vx, T, qs, vx_act, incnt, failed, fail_step, planned) -> list:
    """The JAX script's report of one episode: ``qs`` (T, 19) the base xy and
    q[2:], ``vx_act`` (T,), ``incnt`` (T, n_eff) the measured contacts,
    ``planned`` (T, n_eff) the plan's stance flags."""
    import torch

    from ..utils.quat import quat_to_rot, rot_to_rpy

    rpy = rot_to_rpy(quat_to_rot(torch.as_tensor(qs[:, 3:7]))).numpy()
    z = qs[:, 2]
    lines = [f"robot={robot} vx={vx} T={T}ms failed={bool(failed)} fail_step={int(fail_step)}"]
    for s in range(T // 500):
        sl = slice(s * 500, (s + 1) * 500)
        lines.append(
            f"  t={s*0.5:.1f}s: roll[deg] rms={np.rad2deg(np.sqrt((rpy[sl,0]**2).mean())):6.2f} "
            f"max={np.rad2deg(np.abs(rpy[sl,0]).max()):6.2f} | "
            f"pitch mean={np.rad2deg(rpy[sl,1].mean()):+6.2f} "
            f"max={np.rad2deg(np.abs(rpy[sl,1]).max()):6.2f} | "
            f"z mean={z[sl].mean():.3f} drift={z[sl][-1]-z[sl][0]:+.3f} | "
            f"vx mean={vx_act[sl].mean():.3f}")
    meas = incnt > 0
    lines.append("  contact duty (planned vs measured) and phase lead/lag per foot:")
    for j, name in enumerate(FEET):
        # cross-correlate the stance signals to estimate the timing offset
        p = planned[:, j].astype(float) - planned[:, j].mean()
        m = meas[:, j].astype(float) - meas[:, j].mean()
        lags = np.arange(-100, 101)
        xc = [np.dot(p[max(0, -l):T - max(0, l)], m[max(0, l):T - max(0, -l)]) for l in lags]
        best = lags[int(np.argmax(xc))]
        lines.append(
            f"    {name}: duty plan={planned[:, j].mean():.2f} meas={meas[:, j].mean():.2f} "
            f"touchdown offset={best:+d} ms (>0: measured late)")
    return lines


def main(argv=None) -> int:
    import torch

    from ..mpc import gait as G
    from ..sim import physics, rollout
    from ..utils.runtime import setup_torch
    from ._common import arg, host, split_args

    pos, device = split_args(argv)
    device = setup_torch(device)
    robot = arg(pos, 0, str, "solo12")
    vx = arg(pos, 1, float, 0.3)
    T = arg(pos, 2, int, 3000)
    out = arg(pos, 3, str, os.path.join(tempfile.gettempdir(), f"torch_diag_{robot}"))
    kp = arg(pos, 4, float, None)
    kd = arg(pos, 5, float, None)
    nom_ht = arg(pos, 6, float, None)
    swing_blend = arg(pos, 7, float, None)
    kn = arg(pos, 8, float, None)
    carry = arg(pos, 9, lambda s: bool(int(s)), True)
    force_gate = arg(pos, 10, float, None)
    settle_ms = arg(pos, 11, int, 0)

    spec, sim_params, C, trot = build(robot, device)
    if kn is not None:
        sim_params = dataclasses.replace(
            sim_params,
            contact=dataclasses.replace(sim_params.contact, kn=kn, dn=kn / 20.0, kt=kn / 20.0))
    if nom_ht is not None:
        trot = dataclasses.replace(trot, nom_ht=nom_ht)
        spec = dataclasses.replace(spec, params=trot)
    cfg = rollout.RolloutConfig(
        episode_length=T,
        kp=kp if kp is not None else trot.kp,
        kd=kd if kd is not None else trot.kd,
        gait_period=trot.gait_period,
    )
    if kp is not None or kd is not None:
        spec = dataclasses.replace(spec, params=dataclasses.replace(spec.params, kp=cfg.kp,
                                                                    kd=cfg.kd))
    print(f"config: kp={spec.params.kp} kd={spec.params.kd} nom_ht={spec.params.nom_ht}")
    f32 = dict(dtype=torch.float32, device=spec.device)
    state0 = physics.SimState(q=torch.as_tensor(C.q0()[None], **f32),
                              v=torch.zeros((1, 18), **f32))
    if settle_ms:
        # pre-settle: hold q0's joints with the stiff PD (6x the gait's gains)
        # until the base rests on its feet
        state0 = rollout.settle_state(spec.model, tuple(spec.eff_frames), sim_params, state0,
                                      spec.params.kp, spec.params.kd, ms=settle_ms)
        print(f"settled {settle_ms} ms: z={float(state0.q[0, 2]):.4f} "
              f"|v|={float(state0.v.abs().max()):.4f}")
    res = rollout.rollout_mpc(spec, sim_params, cfg, state0,
                              torch.as_tensor([[vx, 0.0, 0.0]], **f32), torch.zeros(1, **f32),
                              swing_blend=swing_blend, warm_start_carry=carry,
                              force_gate=force_gate)
    qs = np.concatenate([host(res.base[0, :, :2]), host(res.states[0, :, 26:43])], -1)
    ts = torch.arange(T, dtype=torch.float32) * cfg.sim_dt
    planned = G.in_stance(spec.gait, ts).numpy()
    print("\n".join(report(robot, vx, T, qs, host(res.states[0, :, 0]),
                           host(res.in_contact[0]), host(res.failed[0]), host(res.fail_step[0]),
                           planned)))
    if not all(importlib.util.find_spec(m) for m in ("matplotlib", "PIL")):
        print("  no matplotlib or PIL here: the strip and the gif are not drawn")
        return 0
    from ..eval import visualize as V

    ep = V.episode(res, 0)
    V.rollout_strip(ep, out + "_strip.png", title=f"{robot} trot vx={vx}")
    V.render_rollout_video(C.load_model(), ep, out + ".gif", stride=20)
    print(f"  wrote {out}_strip.png, {out}.gif")
    return 0


if __name__ == "__main__":
    sys.exit(main())
