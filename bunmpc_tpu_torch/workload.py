"""The inputs the port is driven and measured with, made from a seed with
numpy: bench.py's batch of Solo12 trot states (and, per gait, the same batch
led by the gait's own check), the random IK problems of the JAX package's own
DDP kernel check (tests/test_pallas_ddp.py), and the closed loop's settled
standing start and command draw; for the Go2 the same recipe on its q0, the
simulator its walking trot is validated on, its settled start and the JAX
package's stability-sweep grid (scripts/sweep_stability.py); for the Solo8
the same recipe on its standing q0; for the Solo12 acyclic motions states
drawn about their start at times across the motion; and the heightfields of
the terrain runs."""

from __future__ import annotations

import numpy as np
import torch

from .mpc import acyclic as AC
from .mpc import ik as IK
from .mpc import kino_dyn as KD
from .mpc.motions import go2_cyclic, solo8_cyclic
from .mpc.motions.solo12_acyclic import MOTIONS
from .mpc.motions.solo12_cyclic import trot_sim
from .robots.go2 import Go2Config
from .robots.solo8 import Solo8Config
from .robots.solo12 import Solo12Config
from .sim import controllers, physics, rollout


def trot_states(n: int, seed: int = 0, q0=None):
    """bench.py's inputs ``(q, v, t, v_des, w_des)`` as float64 numpy arrays:
    q0 (Solo12's unless given) with N(0, 0.05) joint offsets, N(0, 0.05)
    velocities, a uniform gait clock in [0, 0.5), commands v_des in
    [-0.3, 0.5] x [-0.2, 0.2] and yaw rates in [-0.3, 0.3]."""
    rng = np.random.default_rng(seed)
    q = np.tile(Solo12Config.q0() if q0 is None else q0, (n, 1))
    q[:, 7:] += rng.normal(size=(n, 12)) * 0.05
    v = rng.normal(size=(n, 18)) * 0.05
    t = rng.uniform(0, 0.5, size=n)
    v_des = np.stack([rng.uniform(-0.3, 0.5, n), rng.uniform(-0.2, 0.2, n), np.zeros(n)], -1)
    w_des = rng.uniform(-0.3, 0.3, size=n)
    return q, v, t, v_des, w_des


# Each gait's command on its own check: the JAX package's where it solves the
# gait (tests/test_mpc.py:177-221: walk at vx 0.15, air_bound at vx 0.2,
# bound_turn at vx 0.2 and a yaw rate of 0.5); vx 0.2 elsewhere, with a yaw
# rate of 0.3 on the trot's turning variant and no motion for the stand-still.
GAIT_COMMANDS = {
    "trot": (0.2, 0.0), "trot_sim": (0.2, 0.0), "trot_turn": (0.2, 0.3), "jump": (0.2, 0.0),
    "bound": (0.2, 0.0), "bound_turn": (0.2, 0.5), "air_bound": (0.2, 0.0), "still": (0.0, 0.0),
    "gallop": (0.2, 0.0), "walk": (0.15, 0.0),
}


def gait_states(name: str, n: int, seed: int = 0):
    """``trot_states(n, seed)`` led by the gait's own check: problem 0 is
    Solo12's q0 at rest at t=0 with ``GAIT_COMMANDS[name]``."""
    q, v, t, v_des, w_des = trot_states(n, seed)
    vx, w = GAIT_COMMANDS[name]
    q[0], v[0], t[0], w_des[0] = Solo12Config.q0(), 0.0, 0.0, w
    v_des[0] = (vx, 0.0, 0.0)
    return q, v, t, v_des, w_des


def random_ik_problems(model, eff_frames, n: int, H: int, device, q0=None):
    """The random IK problems of tests/test_pallas_ddp.py's full-size check
    (rng seed 3; distinct start states, shared random targets and weights) at
    batch n in float32, as the argument tuple of
    ``solvers/cuda_ddp.solve_ik_batch``; about Solo12's q0, or ``q0`` for a
    robot of another joint count."""
    rng = np.random.default_rng(3)
    dtype = torch.float32
    nv = model.nv

    def rep(a):
        a = np.asarray(a)
        return torch.as_tensor(np.broadcast_to(a, (n,) + a.shape).copy(), dtype=dtype,
                               device=device)

    def vec(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    q0 = Solo12Config.q0() if q0 is None else np.asarray(q0)
    x_reg = np.concatenate([q0, np.zeros(nv)])
    tasks = IK.IkTasks(
        ee_targets=rep(rng.normal(size=(H, 4, 3)) * 0.1),
        ee_wts=rep(rng.uniform(0.5, 2.0, size=(H, 4))),
        com_ref=rep(rng.normal(size=(H + 1, 3)) * 0.05),
        mom_ref=rep(rng.normal(size=(H + 1, 6)) * 0.05),
        com_wt=3.0, mom_wt=2.0,
        state_wt=vec(rng.uniform(0.1, 1.0, size=2 * nv)),
        x_reg=vec(x_reg),
        reg_wt_state=0.7, reg_wt_ctrl=1e-4,
        ctrl_wt=vec(rng.uniform(0.1, 1.0, size=nv)),
        dts=rep(np.full(H, 0.05)),
    )
    qs = np.tile(q0, (n, 1))
    qs[:, 7:] += rng.normal(size=(n, model.n_joints)) * 0.03
    x0 = vec(np.concatenate([qs, rng.normal(size=(n, nv)) * 0.05], 1))
    w_stage, w_term, ctrl_w, xr = IK.dense_weights(model, eff_frames, tasks)
    return (model, eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, xr, w_stage,
            w_term, ctrl_w, tasks.dts)


def closed_loop_sim_params():
    """The simulator the walking trot (``trot_sim``) is validated on: the
    default SimParams with contact kn=1e4, dn=500, kt=500."""
    return physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))


def settled_start(n: int, device="cuda", dtype=torch.float32):
    """The closed loop's start: Solo12's q0 PD-held for 500 ms
    (``rollout.settle_state`` at trot_sim's gains on the closed-loop
    simulator), as n copies of one state on ``device``."""
    device = KD.resolve_device(device)
    model = Solo12Config.load_model()
    s0 = physics.SimState(
        q=torch.as_tensor(Solo12Config.q0()[None], dtype=dtype, device=device),
        v=torch.zeros((1, model.nv), dtype=dtype, device=device),
    )
    s = rollout.settle_state(model, tuple(Solo12Config.eff_names), closed_loop_sim_params(), s0,
                             trot_sim.kp, trot_sim.kd)
    return physics.SimState(q=s.q.expand(n, -1).contiguous(), v=s.v.expand(n, -1).contiguous())


def command_draw(n: int, seed: int = 0):
    """Commands of the reference envelope (the data-collection config's
    vx_range [0, 0.3], vy_range and w_range [0, 0]): ``(v_des (n, 3),
    w_des (n,))`` as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    v_des = np.zeros((n, 3))
    v_des[:, 0] = rng.uniform(0.0, 0.3, n)
    return v_des, np.zeros(n)


def go2_states(name: str, n: int, seed: int = 0):
    """bench.py's recipe (``trot_states``) on the Go2's q0, led by the JAX
    package's Go2 check (tests/test_go2.py:139-144): problem 0 is q0 at rest
    at t=0 with v_des = (0.3, 0, 0) and no yaw rate. ``name`` is a key of
    ``go2_cyclic.GAITS``."""
    if name not in go2_cyclic.GAITS:
        raise ValueError(f"unknown Go2 gait {name!r}")
    q, v, t, v_des, w_des = trot_states(n, seed, q0=Go2Config.q0())
    q[0], v[0], t[0], w_des[0] = Go2Config.q0(), 0.0, 0.0, 0.0
    v_des[0] = (0.3, 0.0, 0.0)
    return q, v, t, v_des, w_des


def go2_spec(name: str, device="cuda"):
    """The Go2 spec of ``go2_cyclic.GAITS[name]`` with the Go2's feet, thighs
    and foot size (generic offsets, the "vdes" warm start)."""
    C = Go2Config
    return KD.make_cyclic_spec(C.load_model(), go2_cyclic.GAITS[name], C.q0(),
                               eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
                               foot_size=C.foot_size, device=device)


def go2_sim_params():
    """The simulator the Go2's walking trot (``trot_sim``) is validated on
    (the JAX package's tests/test_gait_quality.py:86-91): contact kn=6e4,
    dn=3000, kt=3000, mu=1 on a 2 cm foot, a 23.7 N m torque limit."""
    return physics.SimParams(
        contact=physics.ContactParams(foot_radius=Go2Config.foot_size, kn=6e4, dn=3000.0,
                                      kt=3000.0, mu=1.0),
        torque_limit=23.7)


def go2_settled_start(n: int, device="cuda", dtype=torch.float32, sim_params=None, kp=None,
                      kd=None):
    """The Go2's closed-loop start: q0 PD-held for 500 ms (``settle_state``)
    at ``trot_sim``'s gains on ``go2_sim_params()`` (or the given per-episode
    gains and simulator, (n,) tensors, as the stability sweep settles), as n
    states on ``device``."""
    device = KD.resolve_device(device)
    model = Go2Config.load_model()
    per_episode = sim_params is not None or kp is not None or kd is not None
    m = n if per_episode else 1  # one settle, copied, where every episode has the same
    s0 = physics.SimState(
        q=torch.as_tensor(np.tile(Go2Config.q0(), (m, 1)), dtype=dtype, device=device),
        v=torch.zeros((m, model.nv), dtype=dtype, device=device),
    )
    sp = go2_sim_params() if sim_params is None else sim_params
    kp = go2_cyclic.trot_sim.kp if kp is None else kp
    kd = go2_cyclic.trot_sim.kd if kd is None else kd
    s = rollout.settle_state(model, tuple(Go2Config.eff_names), sp, s0, kp, kd)
    return physics.SimState(q=s.q.expand(n, -1).contiguous(), v=s.v.expand(n, -1).contiguous())


def go2_sweep_grid():
    """The JAX package's Go2 stability sweep (scripts/sweep_stability.py:
    118-127, artifacts/stability_sweep_go2.json): (kp, kd) x (kn, dn, kt) x
    (swing_blend, force_gate), 40 combinations in the script's order, as a
    dict of (40,) float64 arrays."""
    gains = [(25.0, 1.0), (25.0, 2.0), (40.0, 2.0), (60.0, 3.0)]
    contact = [(6e4, 3000.0, 3000.0), (1.2e5, 5000.0, 5000.0)]
    blend = [(1.0, 1.0), (0.5, 1.0), (0.5, 0.0), (0.2, 1.0), (0.2, 0.0)]
    rows = [(kp, kd, kn, dn, kt, sb, fg) for kp, kd in gains for kn, dn, kt in contact
            for sb, fg in blend]
    cols = np.asarray(rows, np.float64).T
    return dict(zip(("kp", "kd", "kn", "dn", "kt", "swing_blend", "force_gate"), cols))


def go2_sweep_options(grid: dict, device="cuda", dtype=torch.float32):
    """A sweep grid as ``rollout_mpc``'s per-episode options: ``(gains,
    sim_params, swing_blend, force_gate)``, (B,) tensors on ``device`` with
    the Go2's foot, friction, joint damping and torque limit."""
    device = KD.resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    B = len(grid["kp"])
    base = go2_sim_params()
    sp = physics.SimParams(
        contact=physics.ContactParams(
            foot_radius=t(np.full(B, base.contact.foot_radius)), kn=t(grid["kn"]),
            dn=t(grid["dn"]), kt=t(grid["kt"]), mu=t(np.full(B, base.contact.mu))),
        joint_damping=t(np.full(B, base.joint_damping)),
        torque_limit=t(np.full(B, base.torque_limit)))
    gains = controllers.IdControllerGains(kp=t(grid["kp"]), kd=t(grid["kd"]))
    return gains, sp, t(grid["swing_blend"]), t(grid["force_gate"])


def go2_commands(n: int, seed: int = 0):
    """Forward commands for the Go2's walking trot: vx ~ U[0.15, 0.3] (the
    range its sweep walks in), episode 0 the JAX gait gate's exact 0.3 m/s
    (tests/test_gait_quality.py:75-101); ``(v_des (n, 3), w_des (n,))`` as
    float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    v_des = np.zeros((n, 3))
    v_des[:, 0] = rng.uniform(0.15, 0.3, n)
    v_des[0, 0] = 0.3
    return v_des, np.zeros(n)


def go2_window_inputs(n: int, seed: int = 11):
    """A Go2 window with every per-episode option (chip_smoke.py phase 11b
    and the CPU test of its gate): episode b takes row ``b % 40`` of
    ``go2_sweep_grid()`` (its gains and contact, from its own settle), the
    commands ``go2_commands(n, seed=1)``, and seeded sensor biases (base
    height 3 mm, quaternion and joints 0.01, velocities 0.02). Returns a dict
    of float64 numpy arrays: ``rows``, ``q_noise``, ``v_noise``, ``v_des``,
    ``w_des``."""
    rows = np.arange(n) % len(go2_sweep_grid()["kp"])
    rng = np.random.default_rng(seed)
    q_noise = np.zeros((n, Go2Config.q0().shape[0]))
    q_noise[:, 2] = rng.normal(size=n) * 0.003
    q_noise[:, 3:7] = rng.normal(size=(n, 4)) * 0.01
    q_noise[:, 7:] = rng.normal(size=(n, 12)) * 0.01
    v_noise = rng.normal(size=(n, 18)) * 0.02
    v_des, w_des = go2_commands(n, seed=1)
    return dict(rows=rows, q_noise=q_noise, v_noise=v_noise, v_des=v_des, w_des=w_des)


def solo8_q0():
    """The Solo8 standing on the ground (tests/test_solo8.py:23-29): its q0
    at x = 0 with the base at 0.241 m (the reference's 0.4 m is a drop
    pose)."""
    q = Solo8Config.q0()
    q[0] = 0.0
    q[2] = 0.241
    return q


def solo8_spec(name: str = "trot", device="cuda"):
    """The Solo8 spec of ``solo8_cyclic.GAITS[name]`` at ``solo8_q0()`` with
    the Solo8's feet, HFE hip frames and foot size (the JAX package's
    defaults for a ``solo*`` robot: "solo12_hip" offsets, "tiled" start)."""
    C = Solo8Config
    return KD.make_cyclic_spec(C.load_model(), solo8_cyclic.GAITS[name], solo8_q0(),
                               eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
                               foot_size=C.foot_size, device=device)


def solo8_states(n: int, seed: int = 0):
    """bench.py's recipe (``trot_states``) about the Solo8's standing q0 with
    its 8 joints and 14 velocities, led by the JAX Solo8 test's window
    (tests/test_solo8.py:72-102): problem 0 is ``solo8_q0()`` at rest at
    t=0 with v_des = (0.2, 0, 0) and no yaw rate."""
    rng = np.random.default_rng(seed)
    q = np.tile(solo8_q0(), (n, 1))
    q[:, 7:] += rng.normal(size=(n, 8)) * 0.05
    v = rng.normal(size=(n, 14)) * 0.05
    t = rng.uniform(0, 0.5, size=n)
    v_des = np.stack([rng.uniform(-0.3, 0.5, n), rng.uniform(-0.2, 0.2, n), np.zeros(n)], -1)
    w_des = rng.uniform(-0.3, 0.3, size=n)
    q[0], v[0], t[0], w_des[0] = solo8_q0(), 0.0, 0.0, 0.0
    v_des[0] = (0.2, 0.0, 0.0)
    return q, v, t, v_des, w_des


def acyclic_q0():
    """The acyclic motions' start (tests/test_acyclic.py:14-18): Solo12's q0
    at x = 0.2, the frame the motions are authored in."""
    q = Solo12Config.q0()
    q[0] = 0.2
    return q


def acyclic_spec(name: str, device="cuda", plan_freq=None):
    """The Solo12 spec of ``MOTIONS[name]`` (IK horizon ratio 1.0)."""
    return AC.make_acyclic_spec(Solo12Config.load_model(), MOTIONS[name], plan_freq=plan_freq,
                                device=device)


def acyclic_states(name: str, n: int, seed: int = 0):
    """``(q, v, t)`` of n acyclic solves of ``MOTIONS[name]`` as float64
    numpy arrays. Problem 0 is the JAX tests' start: ``acyclic_q0()`` at
    rest at t=0. The others draw about it: base position N(0, 0.01) m, a
    small base rotation (N(0, 0.02) rad about each axis), joints N(0, 0.05)
    rad, velocities N(0, 0.05), and a time into the motion uniform over
    its segments, on a 10 ms grid plus 3 ms, so that no knot time sits on a
    segment boundary (knot times keep the 3 ms) and the batch holds every
    segment: stance, flight, rear."""
    rng = np.random.default_rng(seed)
    T = float(np.asarray(MOTIONS[name].cnt_plan, float)[-1, 0, 5])
    q = np.tile(acyclic_q0(), (n, 1))
    q[:, 0:3] += rng.normal(size=(n, 3)) * 0.01
    half = rng.normal(size=(n, 3)) * 0.01  # half the rotation angle
    dq = np.concatenate([half, np.ones((n, 1))], 1)
    q[:, 3:7] = dq / np.linalg.norm(dq, axis=1, keepdims=True)  # q0's base is level
    q[:, 7:] += rng.normal(size=(n, 12)) * 0.05
    v = rng.normal(size=(n, 18)) * 0.05
    t = np.floor(rng.uniform(0.0, T - 0.01, size=n) * 100.0) / 100.0 + 0.003
    q[0], v[0], t[0] = acyclic_q0(), 0.0, 0.0
    return q, v, t


def terrain_draw(seed: int = 0, device="cuda", dtype=torch.float32):
    """The heightfield of chip_smoke.py's phase 13c: ``physics.random_terrain``
    over 8 m x 8 m (extent 4 m, cell 0.05 m), amplitude 0.02 m, 3 blurs,
    from a ``torch.Generator`` seeded ``seed`` on ``device``."""
    device = KD.resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return physics.random_terrain(g, extent=4.0, cell=0.05, amplitude=0.02, smooth=3,
                                  dtype=dtype)


def slope_terrain(grade: float = 0.1, extent: float = 4.0, cell: float = 0.1,
                  device="cuda", dtype=torch.float32):
    """A plane rising along x, height = grade * x (tests/test_terrain.py's
    slope), over [-extent, extent)^2."""
    device = KD.resolve_device(device)
    n = int(2 * extent / cell)
    x = -extent + np.arange(n) * cell
    h = np.tile((grade * x)[:, None], (1, n))
    return physics.Terrain(heights=torch.as_tensor(h, dtype=dtype, device=device),
                           origin=(-extent, -extent), cell=cell)
