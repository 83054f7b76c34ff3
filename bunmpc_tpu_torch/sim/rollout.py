"""Batched closed-loop MPC rollouts and policy rollouts.

Counterpart of ``bunmpc_tpu/sim/rollout.py`` (reference ``Simulation``,
examples/iterative_algorithm/simulation.py:22-2094), batch-leading: an
episode is a Python loop over replanning windows, and in each window

1. ONE batched MPC solve for every episode (``kino_dyn.solve_mpc_batch``;
   with the "cuda" backends one launch of K1 and one of K2), then
2. ``steps_per_plan`` 1 ms substeps, each the features, the
   inverse-dynamics controller, the action encoding, the physics step, the
   failure predicate and the records: in ``rollout_mpc`` on the card one
   launch of K4 (``cuda_substep``, ``csrc/substep.cu``), otherwise (and in
   the gated and policy rollouts) a handful of batched tensor ops.

Nothing inside a window waits for the host: a failed episode is frozen
with ``torch.where``, as the JAX package's scan does, and the records are
written into preallocated (B, T, ...) tensors.

Rates follow the reference: 1 kHz simulation and control, a replan every
``plan_freq`` (20 Hz, 50 steps). Records per step: state features
(n_state=43: v, base_wrt_foot, q[2:]), the vc goal (phase, v_des_xy, w_des,
gait id) and the action (torque / pd_target / structured).

``rollout_safedagger`` and ``rollout_dagger`` run the MPC and a learned
policy side by side: the MPC solves at every window boundary as in
``rollout_mpc``, and a gate picks the MPC's or the policy's torque at every
substep (SafeDAgger's danger box, DAgger's per-window coin).

``rollout_policy`` and ``rollout_policy_cc`` run a learned policy in the
same loop without the MPC: every 1 ms substep evaluates the policy on the
state features and a vc or cc goal (``cc_goal_fn``) and decodes its action
(``_decode_action``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kin import algorithms as K
from ..mpc import gait as G
from ..mpc import kino_dyn as KD
from ..robots.model import RobotModel
from ..solvers.ddp import DdpConfig
from ..utils import profiling
from ..utils.quat import quat_to_rot, rot_to_rpy
from . import controllers, cuda_substep, physics


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    episode_length: int  # total 1 ms steps
    plan_freq: float = 0.05  # s between replans (20 Hz)
    sim_dt: float = 0.001
    action_type: str = "pd_target"  # torque | pd_target | structured
    kp: float = 3.0  # PD gains of the action parametrization
    kd: float = 0.05
    gait_id: float = 1.0  # vc-goal gait indicator
    fail_angle_deg: float = 30.0
    gait_period: float = 0.5

    @property
    def steps_per_plan(self) -> int:
        return int(round(self.plan_freq / self.sim_dt))

    @property
    def n_windows(self) -> int:
        return self.episode_length // self.steps_per_plan


class RolloutResult(NamedTuple):
    states: torch.Tensor  # (B, T, 43) state features
    actions: torch.Tensor  # (B, T, n_action)
    vc_goals: torch.Tensor  # (B, T, 5)
    base: torch.Tensor  # (B, T, 3) base positions
    com: torch.Tensor  # (B, T, 3)
    contact_forces: torch.Tensor  # (B, T, n_eff, 3) measured ground reactions
    contact_pos: torch.Tensor  # (B, T, n_eff, 3)
    in_contact: torch.Tensor  # (B, T, n_eff) bool
    failed: torch.Tensor  # (B,) True where the failure predicate fired
    fail_step: torch.Tensor  # (B,) first failing step (episode_length if none)
    final_state: physics.SimState
    mpc_usage: torch.Tensor  # (B, T) 1.0 where the MPC was in control


def state_features(model: RobotModel, eff_frames, q, v, fk=None):
    """n_state=43 featurization (simulation.py:487-489); ``fk`` is
    ``K.fk(model, q)`` where the caller has it."""
    R, p = K.fk(model, q) if fk is None else fk
    feet = torch.stack([K._frame_pos(model, R, p, n, q) for n in eff_frames], dim=-2)
    base_wrt_foot = (q[..., None, 0:2] - feet[..., 0:2]).flatten(-2)
    return torch.cat([v, base_wrt_foot, q[..., 2:]], dim=-1)


def vc_goal(cfg: RolloutConfig, step, v_des, w_des):
    """[phase %, v_des_x, v_des_y, w_des, gait id] (..., 5)
    (simulation.py:492-495); ``step`` is the absolute sim step as a tensor,
    so start_time shifts the phase (a reference quirk kept)."""
    phase = G._mod(step * cfg.sim_dt, cfg.gait_period) / cfg.gait_period
    phase, vx = torch.broadcast_tensors(phase, v_des[..., 0])
    return torch.stack(
        [phase, vx, v_des[..., 1], w_des, torch.full_like(vx, cfg.gait_id)], dim=-1)


def failed_state(cfg: RolloutConfig, q, time_elapsed):
    """Height/attitude failure envelope (simulation.py:189-220), after a
    grace period of one gait cycle."""
    rpy = rot_to_rpy(quat_to_rot(q[..., 3:7]))
    ang = math.radians(cfg.fail_angle_deg)
    bad = (
        (q[..., 2] < 0.1)
        | (q[..., 2] > 2.0)
        | (torch.abs(rpy[..., 0]) > ang)
        | (torch.abs(rpy[..., 1]) > ang)
    )
    return bad & (time_elapsed > (cfg.gait_period / cfg.sim_dt))


def settle_state(
    model: RobotModel,
    eff_frames,
    sim_params: physics.SimParams,
    state0: physics.SimState,
    kp: float,
    kd: float,
    ms: int = 500,
    gain_scale: float = 6.0,
) -> physics.SimState:
    """PD-hold the initial pose for ``ms`` steps, so that episodes start from
    a standing state settled into the soft contacts rather than from the raw
    configuration dropped onto the ground. ``kp``, ``kd`` and the fields of
    ``sim_params`` are floats or (B,) tensors per episode (the stability
    sweep settles each episode at its own gains and contact). On the card
    the steps replay one captured CUDA graph, as the rollouts' substeps."""
    b = physics.SimState(state0.q.clone(), state0.v.clone())
    step = _Substep(_settle_step, model, eff_frames, sim_params, state0.q[..., 7:],
                    physics.per_robot(kp), physics.per_robot(kd), gain_scale, b)
    for _ in range(ms):
        step()
    return b


def _settle_step(model, eff_frames, sim_params, q0j, kp, kd, gain_scale, b: physics.SimState):
    tau = -gain_scale * kp * (b.q[..., 7:] - q0j) - gain_scale * kd * b.v[..., 6:]
    s, _ = physics.step(model, eff_frames, sim_params, b, tau)
    b.q.copy_(s.q)
    b.v.copy_(s.v)


def _measure(q, v, q_noise=None, v_noise=None):
    """The state the controller sees (simulation.py:471-477): the true state
    plus a constant sensor bias, ``q_noise`` (nq,) or (B, nq) with the
    quaternion renormalised, ``v_noise`` (nv,) or (B, nv); without a bias
    the state buffers themselves."""
    if q_noise is None and v_noise is None:
        return q, v
    qm = q
    if q_noise is not None:
        qm = q + q_noise
        quat = qm[..., 3:7]
        qm = torch.cat([qm[..., :3], quat / torch.linalg.norm(quat, dim=-1, keepdim=True),
                        qm[..., 7:]], dim=-1)
    vm = v if v_noise is None else v + v_noise
    return qm, vm


def leg_joint_mask(model: RobotModel, eff_frames):
    """(n_eff, n_joints) incidence: 1 where the joint lies on the path from
    the base to that end-effector frame (a numpy constant)."""
    mask = np.zeros((len(eff_frames), model.nv - 6), np.float32)
    for e, name in enumerate(eff_frames):
        for j in model.ancestors(model.frames[name].body):
            mask[e, j] = 1.0
    return mask


def swing_blend_scale(leg_mask_j, planned_st, meas_cnt, sb):
    """Per-joint scale of the PD feedback for the contact-adaptive swing
    release: the joints of a leg the gait plans as swinging
    (``planned_st == 0``) whose foot is measured in contact get ``sb`` (0
    releases the leg, 1 is the reference's behaviour), every other joint 1.
    ``leg_mask_j`` (n_eff, nj), ``planned_st`` and ``meas_cnt`` (..., n_eff),
    ``sb`` a float or a tensor that broadcasts against (..., nj)."""
    gate = ((planned_st == 0) & meas_cnt).to(leg_mask_j.dtype)
    return 1.0 - (1.0 - sb) * (gate @ leg_mask_j).clamp(0.0, 1.0)


def _decode_action(cfg: RolloutConfig, action, q, v):
    """Policy action -> joint torques, per action_type (simulation.py:760-777)."""
    nj = q.shape[-1] - 7
    if cfg.action_type == "torque":
        return action
    if cfg.action_type == "pd_target":
        return cfg.kp * (action - q[..., 7:]) - cfg.kd * v[..., 6:]
    if cfg.action_type == "structured":
        tau_ff = action[..., :nj]
        q_des = action[..., nj : 2 * nj]
        dq_des = action[..., 2 * nj : 3 * nj]
        return tau_ff + cfg.kp * (q_des - q[..., 7:]) + cfg.kd * (dq_des - v[..., 6:])
    raise ValueError(f"unsupported action_type {cfg.action_type!r}")


def _extract_action(cfg: RolloutConfig, tau, q, v, tau_ff=None, q_des=None, v_des_traj=None):
    """Action encodings (simulation.py:525-531): pd_target recovers the PD
    setpoint the torque implies; structured records [tau_ff, q_des_joints,
    v_des_joints]."""
    if cfg.action_type == "torque":
        return tau
    if cfg.action_type == "pd_target":
        return (tau + cfg.kd * v[..., 6:]) / cfg.kp + q[..., 7:]
    if cfg.action_type == "structured":
        return torch.cat([tau_ff, q_des[..., 7:], v_des_traj[..., 6:]], dim=-1)
    raise ValueError(f"unsupported action_type {cfg.action_type!r}")


def _carried_warm_start(spec: KD.CyclicMpcSpec, qm0, vm0, t, v_des, prev, n_shift: int):
    """The previous window's (X, F, dual P) shifted one window and moved
    into the new plan frame, where it is finite and sane; elsewhere the
    spec's cold start (the tiled centroidal state, or for "vdes" specs the
    same riding the command on the plan's time grid at the window clock
    ``t``), zero forces and dual."""
    model = spec.model
    B, H = qm0.shape[0], spec.horizon
    q_reset = torch.cat([torch.zeros_like(qm0[:, 0:2]), qm0[:, 2:]], dim=-1)
    com, h_lin, h_ang = K.centroidal_momentum(model, q_reset, vm0)
    defX = torch.cat([com, h_lin / model.total_mass, h_ang], dim=-1)[:, None].expand(B, H + 1, 9)
    if spec.warm_start_style == "vdes":
        dts = torch.full((B, H), spec.params.gait_dt, dtype=qm0.dtype, device=qm0.device)
        dts[:, 0] = G.first_knot_dt(spec.gait, t)
        tg = torch.cat([torch.zeros_like(dts[:, :1]), torch.cumsum(dts, dim=1)], dim=1)
        vdw = (quat_to_rot(q_reset[:, 3:7]) @ v_des[..., None])[..., 0]
        defX = torch.cat([defX[..., 0:2] + tg[..., None] * vdw[:, None, 0:2], defX[..., 2:3],
                          vdw[:, None, :].expand(B, H + 1, 3), defX[..., 6:]], dim=-1)
    if prev is None:
        zF = torch.zeros((B, H, spec.n_eff, 3), dtype=qm0.dtype, device=qm0.device)
        return defX.contiguous(), zF, torch.zeros_like(defX)
    prevX, prevF, prevP, prev_xy = prev

    def shift(a):
        return torch.cat([a[:, n_shift:], a[:, -1:].expand((B, n_shift) + a.shape[2:])], dim=1)

    # plan frames are origin-reset at the base xy
    dxy = prev_xy - qm0[:, 0:2]
    shX = shift(prevX)
    shX = torch.cat([shX[..., 0:2] + dxy[:, None, :], shX[..., 2:]], dim=-1)
    shF, shP = shift(prevF), shift(prevP)
    f_sane = 10.0 * model.total_mass * 9.81
    healthy = (
        torch.isfinite(shX).flatten(1).all(1)
        & torch.isfinite(shF).flatten(1).all(1)
        & (shF.abs().flatten(1).amax(1) < f_sane)
    )
    h3, h4 = healthy[:, None, None], healthy[:, None, None, None]
    return (
        torch.where(h3, shX, defX).contiguous(),
        torch.where(h4, shF, torch.zeros_like(shF)),
        torch.where(h3, shP, torch.zeros_like(shP)),
    )


def _push(push_force, B: int, T: int, like: torch.Tensor):
    """``push_force`` as the substeps read it: None, or a (B, T, 3) tensor in
    ``like``'s dtype and device (a (T, 3) push, one for the batch, is
    expanded). Row ``k`` is the external world-frame force on the base at
    episode step ``k``; at least the ``T`` steps the rollout runs."""
    if push_force is None:
        return None
    p = torch.as_tensor(push_force, dtype=like.dtype, device=like.device)
    if p.dim() == 2:
        p = p.expand(B, -1, -1)
    if p.dim() != 3 or p.shape[0] != B or p.shape[1] < T or p.shape[2] != 3:
        raise ValueError(f"push_force: a (T, 3) or ({B}, T, 3) tensor with T >= {T}, got shape "
                         f"{tuple(torch.as_tensor(push_force).shape)}")
    return p


def _push_at(push, k):
    """The push of every episode at the device step ``k`` (B, 3), or None:
    read through the step counter, so a substep captured in a CUDA graph
    replays the push of its own step."""
    return None if push is None else push.index_select(1, k.view(1))[:, 0]


def _start_time(start_time, B: int, like: torch.Tensor):
    """``start_time`` as the rollouts take it: a float, or a (B,) tensor of
    per-episode start times in ``like``'s dtype and device."""
    if isinstance(start_time, (int, float)):
        return float(start_time)
    st = torch.as_tensor(start_time, dtype=like.dtype, device=like.device)
    if st.dim() != 0 and tuple(st.shape) != (B,):
        raise ValueError(f"start_time: a float or a ({B},) tensor, got shape {tuple(st.shape)}")
    return st


def _step0(start_time, cfg: RolloutConfig, like: torch.Tensor):
    """The absolute step of each episode's first step, ``start_time /
    sim_dt``, as the vc goal's phase reads it: 0-d, or (B,) per episode."""
    if torch.is_tensor(start_time):
        return start_time / cfg.sim_dt
    return torch.full((), start_time / cfg.sim_dt, dtype=like.dtype, device=like.device)


def _check_window(spec: KD.CyclicMpcSpec, cfg: RolloutConfig):
    if spec.n_int < cfg.steps_per_plan:
        raise ValueError(f"a plan covers {spec.n_int} ms, less than the {cfg.steps_per_plan} "
                         "steps of a replanning window")


def rollout_mpc(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,  # q (B, nq), v (B, nv)
    v_des,  # (B, 3)
    w_des,  # (B,)
    start_time=0.0,  # a float, or (B,) per-episode start times
    push_force=None,
    terrain=None,
    q_noise=None,
    v_noise=None,
    admm_cfg=None,
    ddp_cfg=None,
    gains: controllers.IdControllerGains | None = None,
    warm_start_carry: bool | None = None,
    swing_blend=None,
    force_gate=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> RolloutResult:
    """MPC expert rollouts of a batch of episodes (reference
    Simulation.rollout_mpc, simulation.py:340), on the device of ``state0``.

    Each window solves the MPC once for the whole batch with
    ``solve_mpc_batch(admm_backend, ik_backend)`` ("cuda": the kernels K1
    and K2; "torch": their plain versions) at the clock
    ``KD.window_clock(start_time, w)``, per episode where ``start_time`` is
    a (B,) tensor (the DAgger drivers' on-trajectory and ending rollouts);
    the vc goal's phase counts from ``start_time``, the failure grace period
    from the episode's own first step.

    ``warm_start_carry`` feeds each window's ADMM the previous window's
    (X, F, dual P), shifted one window, behind the JAX package's health
    gate, on either backend (K1 takes the dual in and gives it back). None
    means on for "tiled" specs (the Solo family) and off for "vdes" specs
    (the Go2: a carried solution drags the next solve back to the stay-put
    basin the command-riding start avoids), the JAX package's default.

    Sensor bias (simulation.py:56-61, 471-477): ``q_noise`` (nq,) or (B, nq)
    and ``v_noise`` (nv,) or (B, nv) are added to the state the solver, the
    controller and the records see; the physics integrates the true state.

    Per episode: ``gains`` overrides the controller's PD gains with floats
    or (B,) tensors; every field of ``sim_params`` but ``dt`` may be a (B,)
    tensor. ``swing_blend`` (a float or (B,)) scales the PD feedback of a
    leg the gait plans as swinging while its foot is measured in contact
    (0 releases the leg, 1 is the reference's behaviour); ``force_gate`` (a
    float or (B,)) scales the feed-forward J^T f of a leg measured airborne.
    Both read the previous step's measured contact (all feet down at the
    start) and, like the push, live in device buffers that the substep's
    CUDA graph reads. ``push_force`` pushes the base: a (T, 3) world-frame
    force per episode step for the whole batch, or (B, T, 3) per episode (the
    JAX package's ``vmap`` over a (T, 3) push); each substep adds its step's
    row to the physics step as ``f_ext``. ``terrain`` (``physics.Terrain``)
    is the ground of the physics and of every window's plan (touchdown,
    swing and CoM heights, ``solve_mpc_batch(terrain=)``); its heights go to
    the state's device before the substep's CUDA graph is captured.
    """
    if warm_start_carry is None:
        warm_start_carry = spec.warm_start_style == "tiled"
    _check_window(spec, cfg)
    args, start_time = _loop_args(spec, sim_params, cfg, state0, v_des, w_des, start_time,
                                  push_force, terrain, q_noise, v_noise, gains, swing_blend,
                                  force_gate)
    *_, v_des, w_des, _, _, opts, b = args
    # a CPU tensor takes the plain substep; a CUDA tensor K4, or the call raises
    substep = _Substep(_substep if b.q.device.type == "cpu" else cuda_substep.Launch(*args),
                       *args)
    _windows(spec, cfg, b, substep, start_time, v_des, w_des, warm_start_carry, opts,
             admm_cfg=admm_cfg, ddp_cfg=ddp_cfg, admm_backend=admm_backend, ik_backend=ik_backend)
    return _result(b, torch.ones(b.states.shape[:2], dtype=b.q.dtype, device=b.q.device))


def _loop_args(spec, sim_params, cfg, state0, v_des, w_des, start_time=0.0, push_force=None,
               terrain=None, q_noise=None, v_noise=None, gains=None, swing_blend=None,
               force_gate=None):
    """``_substep``'s arguments for ``rollout_mpc``'s inputs, every option as
    the substeps read it and the loop's buffers fresh; and ``start_time`` as
    the windows take it: ``(args, start_time)``."""
    if gains is None:
        gains = controllers.IdControllerGains(kp=spec.params.kp, kd=spec.params.kd)
    q, v = state0
    B, dtype, device = q.shape[0], q.dtype, q.device
    v_des = torch.as_tensor(v_des, dtype=dtype, device=device)
    w_des = torch.as_tensor(w_des, dtype=dtype, device=device)
    start_time = _start_time(start_time, B, q)
    gains = controllers.IdControllerGains(kp=_per_episode(gains.kp, "gains.kp", B, q),
                                          kd=_per_episode(gains.kd, "gains.kd", B, q))
    sim_params = _sim_params_on(sim_params, B, q)
    opts = _LoopOptions(
        q_noise=_noise(q_noise, "q_noise", B, q), v_noise=_noise(v_noise, "v_noise", B, v),
        terrain=None if terrain is None else terrain.to(q),
        swing_blend=_per_episode(swing_blend, "swing_blend", B, q),
        force_gate=None if force_gate is None else torch.as_tensor(
            _per_episode(force_gate, "force_gate", B, q), dtype=dtype, device=device).expand(B),
        leg_mask=None if swing_blend is None else torch.as_tensor(
            leg_joint_mask(spec.model, spec.eff_frames), dtype=dtype, device=device))
    b = _make_buffers(spec, cfg, q, v)
    push = _push(push_force, B, b.states.shape[1], q)
    return ((spec, sim_params, cfg, gains, v_des, w_des, _step0(start_time, cfg, q), push, opts, b),
            start_time)


class _LoopOptions(NamedTuple):
    """The closed loop's per-run options as the substeps read them: tensors
    on the state's device (or floats), made before any capture."""

    q_noise: torch.Tensor | None = None  # (B, nq)
    v_noise: torch.Tensor | None = None  # (B, nv)
    swing_blend: torch.Tensor | float | None = None  # (B,) or a float
    force_gate: torch.Tensor | None = None  # (B,)
    leg_mask: torch.Tensor | None = None  # (n_eff, nj), with swing_blend
    terrain: physics.Terrain | None = None  # heights on the state's device


def _per_episode(x, name: str, B: int, like: torch.Tensor):
    """A float (or None) as it is; a tensor or array as a (B,) tensor in
    ``like``'s dtype and device, one value per episode."""
    if x is None or isinstance(x, (int, float)):
        return x
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if t.dim() == 0:
        return float(t)
    if tuple(t.shape) != (B,):
        raise ValueError(f"{name}: a float or a ({B},) tensor, got shape {tuple(t.shape)}")
    return t


def _sim_params_on(sp: physics.SimParams, B: int, like: torch.Tensor) -> physics.SimParams:
    """``sp`` with each per-episode field as a (B,) tensor on ``like``'s
    device and dtype (``dt`` stays one float)."""
    if torch.is_tensor(sp.dt):
        raise ValueError("sim_params.dt is one step for the batch: a float")

    contact = physics.ContactParams(**{
        f.name: _per_episode(getattr(sp.contact, f.name), f.name, B, like)
        for f in dataclasses.fields(sp.contact)})
    return physics.SimParams(
        dt=sp.dt, contact=contact,
        joint_damping=_per_episode(sp.joint_damping, "joint_damping", B, like),
        torque_limit=_per_episode(sp.torque_limit, "torque_limit", B, like))


def _noise(x, name: str, B: int, like: torch.Tensor):
    """A sensor bias as a (B, n) tensor in ``like``'s dtype and device: one
    (n,) bias for the batch is expanded."""
    if x is None:
        return None
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    n = like.shape[-1]
    if t.shape == (n,):
        t = t.expand(B, n)
    if tuple(t.shape) != (B, n):
        raise ValueError(f"{name}: a ({n},) or ({B}, {n}) tensor, got shape {tuple(t.shape)}")
    return t.contiguous()


class _Buffers(NamedTuple):
    """The loop's tensors, updated in place: the state, the failure flags,
    the substep and step indices (on the device, so no substep needs a host
    value), the window's plan and the (B, T, ...) records; for the gated
    rollouts also the gate's state and the ``mpc_usage`` record."""

    q: torch.Tensor
    v: torch.Tensor
    failed: torch.Tensor
    fail_step: torch.Tensor
    i: torch.Tensor  # substep within the window
    k: torch.Tensor  # step within the episode
    sim_t: torch.Tensor  # (B,) the window's start time, unrounded (swing_blend's clock)
    prev_cnt: torch.Tensor  # (B, n_eff) bool: the previous step's measured contact
    xs_int: torch.Tensor
    us_int: torch.Tensor
    f_int: torch.Tensor
    mpc_bad: torch.Tensor
    states: torch.Tensor
    actions: torch.Tensor
    vc_goals: torch.Tensor
    base: torch.Tensor
    com: torch.Tensor
    contact_forces: torch.Tensor
    contact_pos: torch.Tensor
    in_contact: torch.Tensor
    use_mpc: torch.Tensor | None = None  # (B,) bool: the MPC is in control
    steps_blocked: torch.Tensor | None = None  # (B,) int32: MPC steps since the takeover
    mpc_usage: torch.Tensor | None = None  # (B, T) 1.0 where the MPC acted


_RECORDS = ("states", "actions", "vc_goals", "base", "com", "contact_forces", "contact_pos",
            "in_contact")
_WARMUP = 2  # eager substeps on the card before the capture (lazy library setup)


def _make_buffers(spec: KD.CyclicMpcSpec, cfg: RolloutConfig, q, v, gated: bool = False):
    model, ne = spec.model, spec.n_eff
    B, dtype, device = q.shape[0], q.dtype, q.device
    T = cfg.n_windows * cfg.steps_per_plan

    def empty(*shape, dt=dtype):
        return torch.empty((B, T) + shape, dtype=dt, device=device)

    gate = {}
    if gated:
        gate = dict(use_mpc=torch.zeros(B, dtype=torch.bool, device=device),
                    steps_blocked=torch.zeros(B, dtype=torch.int32, device=device),
                    mpc_usage=empty())
    return _Buffers(
        q=q.clone(), v=v.clone(),
        failed=torch.zeros(B, dtype=torch.bool, device=device),
        fail_step=torch.full((B,), cfg.episode_length, dtype=torch.int32, device=device),
        i=torch.zeros((), dtype=torch.int64, device=device),
        k=torch.zeros((), dtype=torch.int64, device=device),
        sim_t=torch.zeros(B, dtype=dtype, device=device),
        prev_cnt=torch.ones((B, ne), dtype=torch.bool, device=device),  # a standing start
        xs_int=torch.empty((B, spec.n_int, model.nq + model.nv), dtype=dtype, device=device),
        us_int=torch.empty((B, spec.n_int, model.nv), dtype=dtype, device=device),
        f_int=torch.empty((B, spec.n_int, 3 * ne), dtype=dtype, device=device),
        mpc_bad=torch.zeros(B, dtype=torch.bool, device=device),
        states=empty(model.nv + 2 * ne + model.nq - 2),  # n_state = 43
        actions=empty(model.n_joints * (3 if cfg.action_type == "structured" else 1)),
        vc_goals=empty(5), base=empty(3),
        com=empty(3), contact_forces=empty(ne, 3), contact_pos=empty(ne, 3),
        in_contact=empty(ne, dt=torch.bool),
        **gate,
    )


def _windows(spec, cfg, b: _Buffers, substep, start_time, v_des, w_des, warm_start_carry,
             opts: _LoopOptions = _LoopOptions(), ddp_cfg=None, **solve_kw):
    """The loop over replanning windows: one batched solve on the measured
    state at the window clock (with the previous window's (X, F, P) carried
    where ``warm_start_carry``), the plan into the buffers, then the
    substeps."""
    B = b.q.shape[0]
    ddp_cfg = DdpConfig() if ddp_cfg is None else ddp_cfg
    n_shift = max(1, int(round(cfg.plan_freq / spec.params.gait_dt)))
    prev = None
    for w in range(cfg.n_windows):
        t = KD.window_clock(start_time, w, cfg.plan_freq, b.q).expand(B)
        b.sim_t.copy_(KD.window_start(start_time, w, cfg.plan_freq, b.q).expand(B))
        qm0, vm0 = _measure(b.q, b.v, opts.q_noise, opts.v_noise)
        warm = (_carried_warm_start(spec, qm0, vm0, t, v_des, prev, n_shift)
                if warm_start_carry else None)
        plan = KD.solve_mpc_batch(spec, qm0, vm0, t, v_des, w_des, warm_start=warm,
                                  ddp_cfg=ddp_cfg, terrain=opts.terrain, **solve_kw)
        if warm_start_carry:  # qm0 is the state buffer the substeps overwrite: copy its xy
            prev = (plan.X_opt, plan.F_opt, plan.P_opt, qm0[:, 0:2].clone())
        b.xs_int.copy_(plan.xs_int)
        b.us_int.copy_(plan.us_int)
        b.f_int.copy_(plan.f_int)
        b.mpc_bad.copy_(torch.isnan(plan.f_int).flatten(1).any(1)
                        | torch.isnan(plan.xs_int).flatten(1).any(1))
        b.i.zero_()
        with profiling.span("rollout.substeps"):
            for _ in range(cfg.steps_per_plan):
                substep()


def _result(b, mpc_usage) -> RolloutResult:
    return RolloutResult(
        states=b.states, actions=b.actions, vc_goals=b.vc_goals, base=b.base, com=b.com,
        contact_forces=b.contact_forces, contact_pos=b.contact_pos, in_contact=b.in_contact,
        failed=b.failed, fail_step=b.fail_step, final_state=physics.SimState(q=b.q, v=b.v),
        mpc_usage=mpc_usage)


class _Substep:
    """One 1 ms step of every episode, ``fn(*args)``, in place on the loop's
    buffers (the last argument). On a CPU tensor it runs eagerly. On the card
    the first substeps run eagerly on a side stream, then one substep is
    captured as a CUDA graph and every later substep replays it: the
    thousands of small kernels of a substep are then launched without the
    host's per-op dispatch. A failed capture raises. The graph holds the
    addresses of every tensor the substep reads, a policy's weights
    included, and lives as long as this object: one rollout call."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args
        self.cuda = args[-1].q.device.type == "cuda"
        self.warm = 0
        self.graph = None

    def __call__(self):
        if not self.cuda:
            self.fn(*self.args)
        elif self.graph is not None:
            self.graph.replay()
        elif self.warm < _WARMUP:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*self.args)
            torch.cuda.current_stream().wait_stream(side)
            self.warm += 1
        else:
            with profiling.span("rollout.capture"):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self.fn(*self.args)
                graph.replay()  # the capture only recorded the step
            self.graph = graph


def _advance(b, records, new: physics.SimState, now_failed):
    """The end of a substep: write the records at step ``b.k``, freeze the
    state of failed episodes (the reference breaks the loop), step on."""
    k1 = b.k.view(1)
    b.fail_step.copy_(torch.where(now_failed & ~b.failed, b.k.to(torch.int32), b.fail_step))
    for name, val in zip(_RECORDS, records):
        getattr(b, name).index_copy_(1, k1, val[:, None])
    b.q.copy_(torch.where(now_failed[:, None], b.q, new.q))
    b.v.copy_(torch.where(now_failed[:, None], b.v, new.v))
    b.failed.copy_(now_failed)
    b.k.add_(1)


def _plan_torques(spec, sim_params, cfg, gains, b: _Buffers, qm, vm,
                  opts: _LoopOptions = _LoopOptions()):
    """The ID controller's torques at substep ``b.i`` of the window's plan,
    with ``force_gate`` on the feed-forward forces and ``swing_blend`` on
    the feedback, saturated before they are recorded (the recorded expert
    action is the torque the actuator can apply): ``(tau, tau_ff, q_des,
    v_des_traj)``."""
    model, nq = spec.model, spec.model.nq
    i1 = b.i.view(1)
    xs = b.xs_int.index_select(1, i1)[:, 0]
    q_des, v_des_traj = xs[:, :nq], xs[:, nq:]
    f_scale = None
    if opts.force_gate is not None:  # scale the forces of legs measured airborne
        fg = opts.force_gate[:, None]
        f_scale = torch.where(b.prev_cnt, torch.ones_like(fg), fg)
    tau_ff, tau_fb = controllers.id_joint_torques(
        model, spec.eff_frames, gains, qm, vm, q_des, v_des_traj,
        b.us_int.index_select(1, i1)[:, 0], b.f_int.index_select(1, i1)[:, 0], f_scale=f_scale)
    if opts.swing_blend is not None:  # release planned-swing legs still on the ground
        t_ms = b.sim_t + b.i.to(qm.dtype) * cfg.sim_dt
        planned = G.in_stance(spec.gait, t_ms)
        tau_fb = swing_blend_scale(opts.leg_mask, planned, b.prev_cnt,
                                   physics.per_robot(opts.swing_blend)) * tau_fb
    lim = physics.per_robot(sim_params.torque_limit)
    return torch.clamp(tau_ff + tau_fb, -lim, lim), tau_ff, q_des, v_des_traj


def _substep(spec, sim_params, cfg, gains, v_des, w_des, step0, push, opts: _LoopOptions,
             b: _Buffers):
    model, eff = spec.model, spec.eff_frames
    biased = opts.q_noise is not None or opts.v_noise is not None
    qm, vm = _measure(b.q, b.v, opts.q_noise, opts.v_noise)
    kin = K.body_velocities(model, qm, vm)
    fk = (kin[2], kin[3])
    tau, tau_ff, q_des, v_des_traj = _plan_torques(spec, sim_params, cfg, gains, b, qm, vm, opts)
    # the physics steps the true state: the measured state's kinematics only without a bias
    new, cinfo = physics.step(model, eff, sim_params, physics.SimState(b.q, b.v), tau,
                              f_ext=_push_at(push, b.k), terrain=opts.terrain,
                              kin=None if biased else kin)
    now_failed = b.failed | failed_state(cfg, qm, b.k) | b.mpc_bad
    records = (
        state_features(model, eff, qm, vm, fk=fk),
        _extract_action(cfg, tau, qm, vm, tau_ff=tau_ff, q_des=q_des, v_des_traj=v_des_traj),
        vc_goal(cfg, step0 + b.k, v_des, w_des),
        qm[:, 0:3],
        K.com_from_fk(model, *fk),
        cinfo.forces,
        cinfo.positions,
        cinfo.in_contact,
    )
    _advance(b, records, new, now_failed)
    b.prev_cnt.copy_(cinfo.in_contact)
    b.i.add_(1)


# ---- expert-gated rollouts (SafeDAgger, DAgger) ----

# the SafeDAgger safety box's joint limits (simulation.py:222-297): left and
# right HAA are asymmetric; the joint order is FL, FR, HL, HR x (HAA, HFE, KFE)
_SAFE_HAA_L = (-0.8, 1.5)
_SAFE_HAA_R = (-1.5, 0.8)
_SAFE_HFE = (-2.0, 2.0)
_SAFE_KFE = (-3.0, 3.0)
_SAFE_LO = np.array([_SAFE_HAA_L[0], _SAFE_HFE[0], _SAFE_KFE[0],
                     _SAFE_HAA_R[0], _SAFE_HFE[0], _SAFE_KFE[0]] * 2)
_SAFE_HI = np.array([_SAFE_HAA_L[1], _SAFE_HFE[1], _SAFE_KFE[1],
                     _SAFE_HAA_R[1], _SAFE_HFE[1], _SAFE_KFE[1]] * 2)


def state_is_dangerous(q, z_bounds=(0.15, 1.0), body_angle_deg=25.0):
    """SafeDAgger's safety box (simulation.py:222-297) on ``q`` (..., nq):
    the base height outside ``z_bounds``, roll or pitch beyond
    ``body_angle_deg``, or a joint outside its box."""
    rpy = rot_to_rpy(quat_to_rot(q[..., 3:7]))
    ang = math.radians(body_angle_deg)
    joints = q[..., 7:]
    return (
        (q[..., 2] < z_bounds[0])
        | (q[..., 2] > z_bounds[1])
        | (torch.abs(rpy[..., 0]) > ang)
        | (torch.abs(rpy[..., 1]) > ang)
        | ((joints < K.const(_SAFE_LO, q)) | (joints > K.const(_SAFE_HI, q))).any(-1)
    )


@torch.no_grad()
def _gated_rollout(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,  # q (B, nq), v (B, nv)
    v_des,  # (B, 3)
    w_des,  # (B,)
    policy_fn,  # (states (B, 43), goals (B, 5)) -> actions (B, n_action)
    gate_fn,  # (q, k, use_mpc, steps_blocked) -> (use_mpc, steps_blocked), all (B,)
    start_time=0.0,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> RolloutResult:
    """Shared skeleton of the expert-gated rollouts (SafeDAgger, DAgger),
    the JAX package's ``_gated_rollout``: every window solves the MPC once
    for the batch on the state at the window clock, cold (fixed shapes: the
    plan is at most one window stale at a mid-window takeover, a documented
    deviation from the reference's solve-on-takeover); every substep asks
    ``gate_fn`` whether the MPC or the policy acts, with the episode's step
    ``k`` and the gate's state as device tensors (the substep is one CUDA
    graph replay on the card, so no Python value may steer it). The recorded
    action is whatever acted (the MPC's as ``_extract_action`` encodes it);
    ``mpc_usage`` records the gate. Both torques are computed every step."""
    _check_window(spec, cfg)
    q, v = _state_on_device(spec, state0)
    B, dtype, device = q.shape[0], q.dtype, q.device
    v_des = torch.as_tensor(v_des, dtype=dtype, device=device)
    w_des = torch.as_tensor(w_des, dtype=dtype, device=device)
    start_time = _start_time(start_time, B, q)
    gains = controllers.IdControllerGains(kp=spec.params.kp, kd=spec.params.kd)
    b = _make_buffers(spec, cfg, q, v, gated=True)
    substep = _Substep(_gated_substep, spec, sim_params, cfg, gains, v_des, w_des,
                       _step0(start_time, cfg, q), policy_fn, gate_fn, b)
    _windows(spec, cfg, b, substep, start_time, v_des, w_des, False,
             admm_cfg=admm_cfg, ddp_cfg=ddp_cfg, admm_backend=admm_backend, ik_backend=ik_backend)
    return _result(b, b.mpc_usage)


def _gated_substep(spec, sim_params, cfg, gains, v_des, w_des, step0, policy_fn, gate_fn,
                   b: _Buffers):
    model, eff = spec.model, spec.eff_frames
    qm, vm = _measure(b.q, b.v)
    kin = K.body_velocities(model, qm, vm)
    fk = (kin[2], kin[3])
    feat = state_features(model, eff, qm, vm, fk=fk)
    goal = vc_goal(cfg, step0 + b.k, v_des, w_des)
    use, blocked = gate_fn(qm, b.k, b.use_mpc, b.steps_blocked)
    b.use_mpc.copy_(use)
    b.steps_blocked.copy_(blocked)
    tau_mpc, tau_ff, q_des, v_des_traj = _plan_torques(spec, sim_params, cfg, gains, b, qm, vm)
    action_pol = policy_fn(feat, goal)
    u = b.use_mpc[:, None]
    tau = torch.where(u, tau_mpc, _decode_action(cfg, action_pol, qm, vm))
    action_mpc = _extract_action(cfg, tau_mpc, qm, vm, tau_ff=tau_ff, q_des=q_des,
                                 v_des_traj=v_des_traj)
    new, cinfo = physics.step(model, eff, sim_params, physics.SimState(b.q, b.v), tau, kin=kin)
    now_failed = b.failed | failed_state(cfg, qm, b.k) | b.mpc_bad
    b.mpc_usage.index_copy_(1, b.k.view(1), b.use_mpc.to(b.mpc_usage.dtype)[:, None])
    records = (feat, torch.where(u, action_mpc, action_pol), goal, qm[:, 0:3],
               K.com_from_fk(model, *fk), cinfo.forces, cinfo.positions, cinfo.in_contact)
    _advance(b, records, new, now_failed)
    b.i.add_(1)


def safedagger_gate(num_steps_to_block: int):
    """SafeDAgger's gate (simulation.py:1290-1323): a dangerous state hands
    control to the MPC and restarts the block count at a fresh takeover; the
    MPC keeps control for at least ``num_steps_to_block`` steps and releases
    it on the first safe step after that."""

    def gate(q, k, use_mpc, steps_blocked):
        dangerous = state_is_dangerous(q)
        zero = torch.zeros_like(steps_blocked)
        blocked = torch.where(dangerous & ~use_mpc, zero,
                              torch.where(use_mpc, steps_blocked + 1, steps_blocked))
        release = use_mpc & ~dangerous & (blocked >= num_steps_to_block)
        return dangerous | (use_mpc & ~release), torch.where(release, zero, blocked)

    return gate


def rollout_safedagger(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn,
    num_steps_to_block: int = 150,
    start_time=0.0,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> RolloutResult:
    """Safety-gated rollouts of a batch of episodes (reference
    Simulation.rollout_safedagger, simulation.py:1097): the MPC takes over
    when the state enters the danger box and keeps control for at least
    ``num_steps_to_block`` steps after it is safe again
    (``safedagger_gate``). Each window launches K1 and K2 once with the
    "cuda" backends."""
    return _gated_rollout(spec, sim_params, cfg, state0, v_des, w_des, policy_fn,
                          safedagger_gate(num_steps_to_block), start_time=start_time,
                          admm_cfg=admm_cfg, ddp_cfg=ddp_cfg, admm_backend=admm_backend,
                          ik_backend=ik_backend)


def dagger_coins(generator: torch.Generator, B: int, n_windows: int,
                 mpc_usage_percentage: float = 0.5):
    """DAgger's expert coins, (B, n_windows) bool on the generator's device:
    one Bernoulli(``mpc_usage_percentage``) draw per episode and window (the
    JAX package draws each episode's from its own key)."""
    u = torch.rand((B, n_windows), generator=generator, device=generator.device)
    return u < mpc_usage_percentage


def rollout_dagger(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn,
    generator: torch.Generator | None = None,
    mpc_usage_percentage: float = 0.5,
    start_time=0.0,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
    coins=None,
) -> RolloutResult:
    """Classic DAgger rollouts (reference Simulation.rollout_dagger,
    simulation.py:1450, mixing at :1584-1589): each replanning window of each
    episode gives control to the MPC on a Bernoulli(``mpc_usage_percentage``)
    coin, drawn by ``dagger_coins`` from ``generator`` unless ``coins``
    ((B, n_windows) bool) is given. The gate reads the coin of window
    ``k // steps_per_plan`` from the step counter on the device."""
    q, _ = _state_on_device(spec, state0)
    B, spp = q.shape[0], cfg.steps_per_plan
    if coins is None:
        coins = dagger_coins(generator, B, cfg.n_windows, mpc_usage_percentage)
    coins = torch.as_tensor(coins, dtype=torch.bool, device=q.device)
    if tuple(coins.shape) != (B, cfg.n_windows):
        raise ValueError(f"coins: shape {tuple(coins.shape)}, expected {(B, cfg.n_windows)}")

    def gate(q, k, use_mpc, steps_blocked):
        w = torch.div(k, spp, rounding_mode="floor")
        return coins.index_select(1, w.view(1))[:, 0], steps_blocked

    return _gated_rollout(spec, sim_params, cfg, state0, v_des, w_des, policy_fn, gate,
                          start_time=start_time, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
                          admm_backend=admm_backend, ik_backend=ik_backend)


# ---- policy rollouts ----


def cc_goal_fn(model, eff_frames, contact_schedule, goal_horizon: int = 1):
    """Contact-conditioned goal builder for policy rollouts.

    ``contact_schedule``: (B, n_eff, n_events, 4) rows [step, x, y, z] per
    foot in time order (``learning.contact_planner.ContactPlanner.
    get_contact_schedule``, which pads a foot by repeating its last row).
    Returns ``goal(step, q) -> (B, 3*n_eff*goal_horizon)`` with ``step`` the
    step within the episode (a 0-d tensor) and ``q`` (B, nq): [steps to the
    foot's next touchdown, com_x - x, com_y - y] per horizon slot and foot,
    as the JAX package's ``cc_goal_fn`` computes it (the touchdown after
    ``step``, ``goal_horizon - 1`` more, the last row past the end), matching
    ``goals.construct_cc_goal`` (reference utils.py:36-102)."""
    sched = contact_schedule
    B, ne, n_events, _ = sched.shape
    times = sched[..., 0].contiguous()  # (B, ne, n_events)

    def goal(step, q):
        com = K.com(model, q)
        s = step.to(times.dtype)
        nxt = torch.searchsorted(times, s.expand(B, ne, 1).contiguous(), right=True)
        out = []
        for gh in range(goal_horizon):
            idx = (nxt + gh).clamp(0, n_events - 1)
            row = sched.gather(2, idx[..., None].expand(B, ne, 1, 4))[:, :, 0]  # (B, ne, 4)
            out.append(torch.stack([row[..., 0] - s, com[:, None, 0] - row[..., 1],
                                    com[:, None, 1] - row[..., 2]], dim=-1))
        return torch.stack(out, dim=1).flatten(1)

    return goal


def rollout_policy_cc(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    policy_fn,
    contact_schedule,  # (B, n_eff, n_events, 4) desired schedule
    goal_horizon: int = 1,
    **kwargs,
) -> RolloutResult:
    """Contact-conditioned policy rollouts (reference
    Simulation.rollout_policy_with_cc_replanning, simulation.py:834): the
    policy consumes cc goals computed online against each episode's desired
    contact schedule instead of vc goals."""
    q, _ = _state_on_device(spec, state0)
    sched = torch.as_tensor(contact_schedule, dtype=q.dtype, device=q.device)
    gfn = cc_goal_fn(spec.model, spec.eff_frames, sched, goal_horizon)
    return rollout_policy(spec, sim_params, cfg, state0, v_des, w_des, policy_fn,
                          goal_fn=gfn, **kwargs)


def _state_on_device(spec: KD.CyclicMpcSpec, state0):
    """``(q, v)`` as tensors: a tensor keeps its device and dtype, anything
    else goes to ``spec.device`` in float32."""
    q, v = state0
    device = KD.resolve_device(q.device if torch.is_tensor(q) else spec.device)
    dtype = q.dtype if torch.is_tensor(q) else torch.float32
    return (torch.as_tensor(q, dtype=dtype, device=device),
            torch.as_tensor(v, dtype=dtype, device=device))


@torch.no_grad()
def rollout_policy(
    spec: KD.CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: RolloutConfig,
    state0: physics.SimState,  # q (B, nq), v (B, nv)
    v_des,  # (B, 3)
    w_des,  # (B,)
    policy_fn,  # (states (B, 43), goals (B, g)) -> actions (B, n_action)
    goal_fn=None,  # optional (step, q (B, nq)) -> goals (B, g); default the vc goal
    start_time=0.0,  # a float, or (B,) per-episode start times (the vc goal's phase)
    push_force=None,
    terrain=None,
    q_noise=None,
    v_noise=None,
) -> RolloutResult:
    """Policy rollouts of a batch of episodes (reference
    Simulation.rollout_policy, simulation.py:582), on the device of
    ``state0`` (``spec.device`` for arrays): the policy runs at 1 kHz on
    [state features, goal], its action is decoded to torques per
    ``cfg.action_type`` (simulation.py:760-777), and no MPC runs. On the card
    each substep, the policy's forward pass included, is one CUDA-graph
    replay. ``vc_goals`` records the goal the policy saw (vc or cc).
    ``push_force`` pushes the base and ``q_noise``/``v_noise`` bias the
    measured state as in ``rollout_mpc``; ``terrain`` is the physics' ground,
    as there."""
    q, v = _state_on_device(spec, state0)
    B, dtype, device = q.shape[0], q.dtype, q.device
    v_des = torch.as_tensor(v_des, dtype=dtype, device=device)
    w_des = torch.as_tensor(w_des, dtype=dtype, device=device)
    if goal_fn is None:
        step0 = _step0(_start_time(start_time, B, q), cfg, q)

        def goal_fn(step, q):
            return vc_goal(cfg, step0 + step, v_des, w_des)

    model, ne, T = spec.model, spec.n_eff, cfg.episode_length
    k = torch.zeros((), dtype=torch.int64, device=device)
    n_goal = goal_fn(k, q).shape[-1]

    def empty(*shape, dt=dtype):
        return torch.empty((B, T) + shape, dtype=dt, device=device)

    b = _PolicyBuffers(
        q=q.clone(), v=v.clone(),
        failed=torch.zeros(B, dtype=torch.bool, device=device),
        fail_step=torch.full((B,), T, dtype=torch.int32, device=device),
        k=k,
        states=empty(model.nv + 2 * ne + model.nq - 2),
        actions=empty(model.n_joints * (3 if cfg.action_type == "structured" else 1)),
        vc_goals=empty(n_goal), base=empty(3), com=empty(3), contact_forces=empty(ne, 3),
        contact_pos=empty(ne, 3), in_contact=empty(ne, dt=torch.bool),
    )
    opts = _LoopOptions(q_noise=_noise(q_noise, "q_noise", B, q),
                        v_noise=_noise(v_noise, "v_noise", B, v),
                        terrain=None if terrain is None else terrain.to(q))
    substep = _Substep(_policy_substep, spec, sim_params, cfg, policy_fn, goal_fn,
                       _push(push_force, B, T, q), opts, b)
    for _ in range(T):
        substep()
    return RolloutResult(
        states=b.states, actions=b.actions, vc_goals=b.vc_goals, base=b.base, com=b.com,
        contact_forces=b.contact_forces, contact_pos=b.contact_pos, in_contact=b.in_contact,
        failed=b.failed, fail_step=b.fail_step, final_state=physics.SimState(q=b.q, v=b.v),
        mpc_usage=torch.zeros((B, T), dtype=dtype, device=device),
    )


class _PolicyBuffers(NamedTuple):
    """The policy loop's tensors, updated in place: the state, the failure
    flags, the step index (on the device) and the (B, T, ...) records."""

    q: torch.Tensor
    v: torch.Tensor
    failed: torch.Tensor
    fail_step: torch.Tensor
    k: torch.Tensor
    states: torch.Tensor
    actions: torch.Tensor
    vc_goals: torch.Tensor
    base: torch.Tensor
    com: torch.Tensor
    contact_forces: torch.Tensor
    contact_pos: torch.Tensor
    in_contact: torch.Tensor


def _policy_substep(spec, sim_params, cfg, policy_fn, goal_fn, push, opts: _LoopOptions,
                    b: _PolicyBuffers):
    model, eff = spec.model, spec.eff_frames
    biased = opts.q_noise is not None or opts.v_noise is not None
    qm, vm = _measure(b.q, b.v, opts.q_noise, opts.v_noise)
    kin = K.body_velocities(model, qm, vm)
    fk = (kin[2], kin[3])
    feat = state_features(model, eff, qm, vm, fk=fk)
    goal = goal_fn(b.k, qm)
    action = policy_fn(feat, goal)
    tau = _decode_action(cfg, action, qm, vm)
    new, cinfo = physics.step(model, eff, sim_params, physics.SimState(b.q, b.v), tau,
                              f_ext=_push_at(push, b.k), terrain=opts.terrain,
                              kin=None if biased else kin)
    now_failed = b.failed | failed_state(cfg, qm, b.k)
    records = (feat, action, goal, qm[:, 0:3], K.com_from_fk(model, *fk), cinfo.forces,
               cinfo.positions, cinfo.in_contact)
    _advance(b, records, new, now_failed)
