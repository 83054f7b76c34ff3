"""In-sim trot stability sweep over PD gains, ground contact and the loop's
contact-adaptive options.

Counterpart of ``scripts/sweep_stability.py``: every (kp, kd, kn, dn, kt,
swing_blend, force_gate) combination of a grid as one episode of ONE
batched ``rollout_mpc`` call (per-episode gains, contact, swing blend and
force gate), each episode PD-settled first at its own gains on its own
contact (``settle_state``, the stiff 6x hold), with a table of failure
step, roll and pitch envelopes, height and forward speed per row.

    python -m bunmpc_tpu_torch.scripts.sweep_stability [solo12|go2] [vx] [episode_ms]
        [settle_ms] [grid] [out_json]

``grid`` is ``default`` (gains x contact x blend) or ``calibrate`` (Solo12:
the reference's kp=3/kd=0.05 pinned over a wide contact grid). The
environment's ``BUNMPC_SWEEP_WS`` (tiled|vdes: the ADMM warm-start style),
``BUNMPC_SWEEP_CARRY`` (0|1: the loop's warm-start carry) and
``BUNMPC_SWEEP_WF`` (a scale of Solo12's W_F) are read as the JAX script
reads them. On the card each window runs K1 and K2 once; ``device=cpu``
runs their plain versions. Writes ``out_json`` (default
``artifacts/torch_stability_sweep_<robot>[_<grid>].json``).
"""

import dataclasses
import os
import sys

import numpy as np

# the JAX script's grids: (kp, kd), (kn, dn, kt), (swing_blend, force_gate)
GRIDS = {
    ("solo12", "default"): (
        [(8.0, 0.3), (12.0, 0.5), (16.0, 0.8), (20.0, 1.0)],
        [(1e4, 500.0, 500.0), (2e4, 900.0, 900.0)],
        [(1.0, 1.0), (0.5, 1.0), (0.5, 0.0)],
    ),
    ("solo12", "calibrate"): (
        [(3.0, 0.05)],
        [
            (1e4, 500.0, 500.0),  # round-2 winner contact
            (3e4, 1500.0, 1500.0),
            (1e5, 5000.0, 5000.0),  # near-rigid, high damping
            (3e5, 15000.0, 15000.0),
            (1e5, 15000.0, 5000.0),  # overdamped normal
            (1e5, 5000.0, 20000.0),  # sticky tangential
            (3e5, 30000.0, 30000.0),
            (1e6, 60000.0, 60000.0),
        ],
        [(1.0, 1.0), (0.5, 0.0)],
    ),
    ("go2", "default"): (
        [(25.0, 1.0), (25.0, 2.0), (40.0, 2.0), (60.0, 3.0)],
        [(6e4, 3000.0, 3000.0), (1.2e5, 5000.0, 5000.0)],
        [(1.0, 1.0), (0.5, 1.0), (0.5, 0.0), (0.2, 1.0), (0.2, 0.0)],
    ),
}
TORQUE_LIMIT = {"solo12": 2.7, "go2": 23.7}


def combos(robot: str, grid: str):
    """The grid's rows (kp, kd, kn, dn, kt, sb, fg) in the JAX script's
    order (the Go2 has only its default grid)."""
    g = GRIDS[(robot, grid if robot == "solo12" else "default")]
    return [(kp, kd, kn, dn, kt, sb, fg) for kp, kd in g[0] for kn, dn, kt in g[1]
            for sb, fg in g[2]]


def sweep(robot, vx, T, settle_ms, rows, device, ws_style=None, carry=None, wf_scale=1.0):
    """The settle and the one ``rollout_mpc`` call of every row: ``(spec,
    result)``."""
    import torch

    from ..sim import controllers, physics, rollout
    from ._common import trot_spec

    params = None
    if robot == "solo12" and wf_scale != 1.0:
        from ..mpc.motions.solo12_cyclic import trot

        params = dataclasses.replace(trot, W_F=trot.W_F * wf_scale)
    spec, C, _ = trot_spec(robot, device, params=params, warm_start_style=ws_style)
    B = len(rows)
    f32 = dict(dtype=torch.float32, device=spec.device)

    def col(i):
        return torch.as_tensor([r[i] for r in rows], **f32)

    foot = 0.018 if robot == "solo12" else C.foot_size
    gains = controllers.IdControllerGains(kp=col(0), kd=col(1))
    sp = physics.SimParams(
        contact=physics.ContactParams(foot_radius=torch.full((B,), foot, **f32), kn=col(2),
                                      dn=col(3), kt=col(4), mu=torch.full((B,), 1.0, **f32)),
        joint_damping=torch.full((B,), 0.02, **f32),
        torque_limit=torch.full((B,), TORQUE_LIMIT[robot], **f32))
    cfg = rollout.RolloutConfig(episode_length=T, gait_period=spec.params.gait_period)
    s0 = physics.SimState(q=torch.as_tensor(np.tile(C.q0(), (B, 1)), **f32),
                          v=torch.zeros((B, spec.model.nv), **f32))
    # pre-settle: hold q0's joints with the stiff PD until the base rests on its feet
    s0 = rollout.settle_state(spec.model, tuple(spec.eff_frames), sp, s0, gains.kp, gains.kd,
                              ms=settle_ms)
    v_des = torch.zeros((B, 3), **f32)
    v_des[:, 0] = vx
    res = rollout.rollout_mpc(spec, sp, cfg, s0, v_des, torch.zeros(B, **f32), gains=gains,
                              swing_blend=col(5), force_gate=col(6), warm_start_carry=carry)
    return spec, res


def table(rows, states, failed, fail_step, T, nv, nom_ht):
    """The JAX script's result rows (attitude and height over the gait window
    500..T, the last 1000 ms for the end values)."""
    from ._common import attitude

    rpy, z, vx_act = attitude(states, nv)
    last = slice(T - 1000, T)
    gait_win = slice(500, T)
    out = []
    for i, (kp, kd, kn, dn, kt, sb, fg) in enumerate(rows):
        f = bool(failed[i])
        out.append({
            "kp": kp, "kd": kd, "kn": kn, "dn": dn, "kt": kt,
            "swing_blend": sb, "force_gate": fg,
            "failed": f, "fail_step": int(fail_step[i]) if f else -1,
            "roll_rms_deg": float(np.rad2deg(np.sqrt((rpy[i, last, 0] ** 2).mean()))),
            "roll_max_deg": float(np.rad2deg(np.abs(rpy[i, gait_win, 0]).max())),
            "roll_max_deg_incl_settle": float(np.rad2deg(np.abs(rpy[i, :, 0]).max())),
            "pitch_mean_deg": float(np.rad2deg(rpy[i, gait_win, 1].mean())),
            "pitch_max_deg": float(np.rad2deg(np.abs(rpy[i, gait_win, 1]).max())),
            "z_end_m": float(z[i, last].mean()), "z_min_m": float(z[i].min()),
            "z_dev_end_m": float(abs(z[i, last].mean() - nom_ht)),
            "vx_end": float(vx_act[i, last].mean()),
        })
    return out


def table_lines(robot, vx, T, grid, table_rows) -> list:
    """The JAX script's printed table."""
    lines = [f"robot={robot} vx={vx} T={T}ms grid={grid}  ({len(table_rows)} combos, one call)",
             f"{'kp':>5} {'kd':>5} {'kn':>8} {'dn':>6} {'kt':>6} {'sb':>4} {'fg':>4} | "
             f"{'fail@':>6} {'roll_rms':>8} {'roll_max':>8} {'pit_mean':>8} {'pit_max':>8} "
             f"{'z_end':>6} {'z_min':>6} {'vx_end':>6}"]
    for r in table_rows:
        lines.append(
            f"{r['kp']:5.1f} {r['kd']:5.2f} {r['kn']:8.0f} {r['dn']:6.0f} {r['kt']:6.0f} "
            f"{r['swing_blend']:4.1f} {r['force_gate']:4.1f} | {r['fail_step']:6d} "
            f"{r['roll_rms_deg']:8.2f} {r['roll_max_deg']:8.2f} {r['pitch_mean_deg']:8.2f} "
            f"{r['pitch_max_deg']:8.2f} {r['z_end_m']:6.3f} {r['z_min_m']:6.3f} "
            f"{r['vx_end']:6.3f}")
    return lines


def main(argv=None) -> int:
    from ..utils import jsonio
    from ..utils.runtime import device_label, setup_torch
    from ._common import arg, repo_root, split_args

    pos, device = split_args(argv)
    device = setup_torch(device)
    robot = arg(pos, 0, str, "solo12")
    vx = arg(pos, 1, float, 0.3)
    T = arg(pos, 2, int, 3000)
    settle_ms = arg(pos, 3, int, 500)
    grid = arg(pos, 4, str, "default")
    ws_style = os.environ.get("BUNMPC_SWEEP_WS") or None
    carry_env = os.environ.get("BUNMPC_SWEEP_CARRY")
    carry = None if carry_env is None else bool(int(carry_env))
    wf_scale = float(os.environ.get("BUNMPC_SWEEP_WF", "1.0"))

    rows = combos(robot, grid)
    spec, res = sweep(robot, vx, T, settle_ms, rows, device, ws_style, carry, wf_scale)
    nom_ht = float(spec.params.nom_ht)
    out_rows = table(rows, res.states, res.failed.cpu().numpy(), res.fail_step.cpu().numpy(),
                     T, spec.model.nv, nom_ht)
    print("\n".join(table_lines(robot, vx, T, grid, out_rows)))
    suffix = f"_{grid}" if grid != "default" else ""
    out = arg(pos, 5, str, os.path.join(repo_root(), "artifacts",
                                         f"torch_stability_sweep_{robot}{suffix}.json"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    jsonio.write_json(out, {
        "robot": robot, "vx": vx, "episode_ms": T, "grid": grid, "settle_ms": settle_ms,
        "nom_ht": nom_ht, "device": device_label(device), "rows": out_rows,
    })
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
