"""Closed-loop contact and gain sweep for in-sim trot quality.

Counterpart of ``scripts/sweep_contact.py``: the full closed loop (the MPC in
the loop) over a batch of (kn, dn, kt, kp, kd) combinations, reporting per
combination the base height, attitude, forward speed and contact duty over
the second half of the episode. Late touchdowns leave the contact forces
short of the MPC's feed-forward and the base sinks between replans; this
sweep shows which contact and gain settings avoid that.

    python -m bunmpc_tpu_torch.scripts.sweep_contact [solo12|go2] [vx] [T_ms]

The JAX script writes its own loop (one cold ``solve_mpc`` a 50 ms window
at the clock round(w 0.05, 3), then 50 substeps of the ID controller, with
no swing blend, force gate or sensor model, and the physics with the
combination's contact and gains), vmapped over the combinations. Here the
combinations are the batch: one ``solve_mpc_batch`` a window (K1 and K2 on
the card, their plain versions on the CPU) and the substeps on device
tensors, replayed as one CUDA graph on the card (``rollout._Substep``).
Prints its table; writes no file (as the JAX script).
"""

import sys
from typing import NamedTuple

import numpy as np

# (kn, dn, kt, kp, kd) per robot, the JAX script's tables in its order
COMBOS = {
    "solo12": [
        (4e3, 300.0, 300.0, 3.0, 0.05),  # current defaults
        (1e4, 600.0, 600.0, 3.0, 0.05),
        (2e4, 1000.0, 1000.0, 3.0, 0.05),
        (4e4, 2000.0, 2000.0, 3.0, 0.05),
        (4e3, 300.0, 1500.0, 3.0, 0.05),  # tangential stick only
        (4e3, 1500.0, 300.0, 3.0, 0.05),  # touchdown damping only
        (2e4, 1000.0, 1000.0, 8.0, 0.20),  # stiff ground + firmer PD
        (4e3, 300.0, 300.0, 8.0, 0.20),  # firmer PD only
    ],
    "go2": [
        (2.4e4, 1800.0, 1800.0, 25.0, 1.0),  # current defaults
        (6e4, 3000.0, 3000.0, 25.0, 1.0),
        (1.2e5, 5000.0, 5000.0, 25.0, 1.0),
        (2.4e4, 1800.0, 5000.0, 25.0, 1.0),
        (6e4, 3000.0, 3000.0, 40.0, 2.0),
        (2.4e4, 1800.0, 1800.0, 40.0, 2.0),
        (6e4, 3000.0, 3000.0, 15.0, 0.5),
        (2.4e4, 5000.0, 1800.0, 25.0, 1.0),
    ],
}


class _Loop(NamedTuple):
    """The loop's tensors, updated in place (a substep reads no host value)."""

    q: object
    v: object
    i: object  # substep within the window
    k: object  # step within the episode
    xs_int: object
    us_int: object
    f_int: object
    z: object  # (B, T) records of the state before each step
    rpy: object  # (B, T, 3)
    vx: object  # (B, T)
    in_contact: object  # (B, T, n_eff) measured by each step


def _substep(model, eff, sim_params, gains, b: _Loop):
    from ..sim import controllers, physics
    from ..utils.quat import quat_to_rot, rot_to_rpy

    nq = model.nq
    i1, k1 = b.i.view(1), b.k.view(1)
    xs = b.xs_int.index_select(1, i1)[:, 0]
    tau_ff, tau_fb = controllers.id_joint_torques(
        model, eff, gains, b.q, b.v, xs[:, :nq], xs[:, nq:], b.us_int.index_select(1, i1)[:, 0],
        b.f_int.index_select(1, i1)[:, 0])
    new, ci = physics.step(model, eff, sim_params, physics.SimState(b.q, b.v), tau_ff + tau_fb)
    b.z.index_copy_(1, k1, b.q[:, 2:3])
    b.rpy.index_copy_(1, k1, rot_to_rpy(quat_to_rot(b.q[:, 3:7]))[:, None])
    b.vx.index_copy_(1, k1, b.v[:, 0:1])
    b.in_contact.index_copy_(1, k1, ci.in_contact[:, None])
    b.q.copy_(new.q)
    b.v.copy_(new.v)
    b.i.add_(1)
    b.k.add_(1)


def run_combos(spec, q0, combos, vx: float, T: int, foot_radius: float, torque_limit: float,
               dtype=None):
    """The closed loop of every combination from ``q0`` at rest, T ms:
    ``(z, rpy, vx, in_contact)`` records (numpy, (B, T, ...)). Runs on
    ``spec.device`` in ``dtype`` (float32 by default): the kernels on the
    card, their plain versions on the CPU."""
    import torch

    from ..mpc import kino_dyn as KD
    from ..sim import controllers, physics, rollout

    dtype = torch.float32 if dtype is None else dtype
    dev = spec.device
    model, eff = spec.model, tuple(spec.eff_frames)
    th = torch.as_tensor(np.asarray(combos, np.float64), dtype=dtype, device=dev)
    B = th.shape[0]
    full = torch.full((B,), 1.0, dtype=dtype, device=dev)
    sp = physics.SimParams(
        contact=physics.ContactParams(foot_radius=foot_radius * full, kn=th[:, 0], dn=th[:, 1],
                                      kt=th[:, 2], mu=full),
        torque_limit=torque_limit)
    gains = controllers.IdControllerGains(kp=th[:, 3], kd=th[:, 4])
    n_windows = T // 50
    Tr = n_windows * 50
    ne = len(eff)

    def empty(*shape, dt=dtype):
        return torch.empty((B, Tr) + shape, dtype=dt, device=dev)

    b = _Loop(
        q=torch.as_tensor(np.tile(q0, (B, 1)), dtype=dtype, device=dev),
        v=torch.zeros((B, model.nv), dtype=dtype, device=dev),
        i=torch.zeros((), dtype=torch.int64, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        xs_int=torch.empty((B, spec.n_int, model.nq + model.nv), dtype=dtype, device=dev),
        us_int=torch.empty((B, spec.n_int, model.nv), dtype=dtype, device=dev),
        f_int=torch.empty((B, spec.n_int, 3 * ne), dtype=dtype, device=dev),
        z=empty(), rpy=empty(3), vx=empty(), in_contact=empty(ne, dt=torch.bool))
    v_des = torch.zeros((B, 3), dtype=dtype, device=dev)
    v_des[:, 0] = vx
    w_des = torch.zeros(B, dtype=dtype, device=dev)
    substep = rollout._Substep(_substep, model, eff, sp, gains, b)
    for w in range(n_windows):
        t = KD.window_clock(0.0, w, 0.05, b.q).expand(B)
        plan = KD.solve_mpc_batch(spec, b.q, b.v, t, v_des, w_des)
        b.xs_int.copy_(plan.xs_int)
        b.us_int.copy_(plan.us_int)
        b.f_int.copy_(plan.f_int)
        b.i.zero_()
        for _ in range(50):
            substep()
    return tuple(a.cpu().numpy() for a in (b.z, b.rpy, b.vx, b.in_contact))


def report(robot, vx, T, combos, z, rpy, vxs, incnt, planned, nom_ht) -> list:
    """The JAX script's table, line by line (metrics over the second half)."""
    half = T // 2
    lines = [f"robot={robot} vx={vx} T={T}ms  (metrics over the 2nd half)",
             f"{'kn':>7} {'dn':>6} {'kt':>6} {'kp':>5} {'kd':>5} | "
             f"{'z_mean':>6} {'z_min':>6} {'roll':>5} {'pitch':>6} {'vx':>5} "
             f"{'dutyF':>5} {'dutyH':>5} {'alive':>5}"]
    for b, th in enumerate(combos):
        zb = z[b, half:]
        alive = bool((z[b] > 0.66 * nom_ht).all())
        duty = incnt[b, half:].mean(axis=0)
        lines.append(
            f"{th[0]:7.0f} {th[1]:6.0f} {th[2]:6.0f} {th[3]:5.1f} {th[4]:5.2f} | "
            f"{zb.mean():6.3f} {zb.min():6.3f} "
            f"{np.rad2deg(np.abs(rpy[b, half:, 0]).max()):5.1f} "
            f"{np.rad2deg(np.abs(rpy[b, half:, 1]).max()):6.1f} "
            f"{vxs[b, half:].mean():5.2f} "
            f"{duty[:2].mean():5.2f} {duty[2:].mean():5.2f} {str(alive):>5}")
    lines.append(f"planned duty={planned.mean():.2f}  nom_ht={nom_ht}")
    return lines


def planned_stance(spec, T: int):
    """The gait plan's stance flags at every ms of the episode, (T, n_eff)."""
    import torch

    from ..mpc import gait as G

    ts = torch.arange(T, dtype=torch.float64) * 0.001
    return G.in_stance(spec.gait, ts).numpy()


def main(argv=None) -> int:
    from ..utils.runtime import setup_torch
    from ._common import arg, split_args, trot_spec

    pos, device = split_args(argv)
    device = setup_torch(device)
    robot = arg(pos, 0, str, "solo12")
    vx = arg(pos, 1, float, 0.3)
    T = arg(pos, 2, int, 2000)
    spec, C, _ = trot_spec(robot, device)
    solo = robot == "solo12"
    foot_radius, torque_limit = (0.018, 2.5) if solo else (C.foot_size, 23.7)
    combos = COMBOS["solo12" if solo else "go2"]
    z, rpy, vxs, incnt = run_combos(spec, C.q0(), combos, vx, T, foot_radius, torque_limit)
    lines = report(robot, vx, T, combos, z, rpy, vxs, incnt, planned_stance(spec, T),
                   spec.params.nom_ht)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
