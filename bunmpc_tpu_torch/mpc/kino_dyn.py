"""Kino-dynamic MPC orchestrator: one batched whole-body solve.

Counterpart of ``bunmpc_tpu/mpc/kino_dyn.py`` (reference
``SoloMpcGaitGen.optimize -> KinoDynMP::optimize``,
examples/mpc/abstract_cyclic_gen.py:629-698, src/motion_planner/kino_dyn.cpp:
39-99). ``solve_mpc_batch`` runs five stages on a batch of robot states:

1. problem assembly (``_prepare_problem``): one FK pass, the contact plan,
   the dynamics costs, the kinematic box and the warm starts;
2. the centroidal ADMM — K1, ``solvers/cuda_admm.py`` (``admm_backend="cuda"``)
   or its plain version ``solvers/biconvex.py`` (``"torch"``);

   with ``fuse_prep=True`` stages 1 and 2 are the FK pass of
   ``_compact_inputs`` and then K3, ``solvers/cuda_fused.py``, which builds the
   rest of the problem inside the ADMM kernel (its plain version on the CPU);
3. the IK task build (``_build_ik_tasks`` + ``ik.dense_weights``);
4. the kinematic GN-DDP — K2, ``solvers/cuda_ddp.py`` (``ik_backend="cuda"``)
   or its plain version ``mpc/ik.py`` + ``solvers/ddp.py`` (``"torch"``);
5. the 1 kHz interpolation (``_finish_from_ik``).

Every function is batch-leading; the device comes from the spec or from the
tensors passed in, and a CUDA device that is not there raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..solvers import biconvex, cuda_admm, cuda_ddp, cuda_fused, ddp
from ..utils import profiling
from ..utils import quat as Q
from . import gait as G
from . import ik as IK
from .motions.params import BiconvexMotionParams


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device raises when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class CyclicMpcSpec:
    """Static, host-side precomputation for one (robot, gait) pair."""

    model: RobotModel
    params: BiconvexMotionParams
    eff_frames: tuple
    horizon: int
    ik_hor: int
    gait: G.GaitParams
    planner: G.RaibertPlannerParams
    hip_offsets: np.ndarray  # (n_eff, 3)
    I_comp: np.ndarray  # (3, 3) composite inertia at q0 (yaw-momentum target)
    x_reg: np.ndarray  # (nq+nv,) regularization state
    size: int  # interpolation knot count
    n_int: int  # 1 kHz samples produced per solve
    device: torch.device
    # kinematic CoM box margins (abstract_cyclic_gen.py:92-97)
    bx: float = 0.45
    by: float = 0.45
    bz: float = 0.45
    # ADMM warm start: "tiled" = the current centroidal state over the horizon
    # (kino_dyn.cpp:83-99), the Solo family's; "vdes" = the same start with the
    # xy and velocity rows riding the command (x_init + v_des t), which keeps
    # the Go2's alternation out of the stay-put basin the tiled start lands in
    warm_start_style: str = "tiled"

    @property
    def n_eff(self) -> int:
        return len(self.eff_frames)


def make_cyclic_spec(
    model: RobotModel,
    params: BiconvexMotionParams,
    q0: np.ndarray,
    eff_frames=("FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"),
    hip_frames=("FL_HFE", "FR_HFE", "HL_HFE", "HR_HFE"),
    ik_hor_ratio: float = 0.5,
    foot_size: float = 0.018,
    x_reg: np.ndarray | None = None,
    offset_style: str | None = None,
    warm_start_style: str | None = None,
    device="cuda",
) -> CyclicMpcSpec:
    """Host-side setup (in f64 on the CPU): Raibert planning offsets relative
    to the CoM at q0 and the composite inertia for the yaw-momentum target.
    ``device`` is where ``solve_mpc_batch`` runs by default.

    ``offset_style``: "solo12_hip" = hip - com with Solo12's hand-tuned
    lateral nudges (abstract_cyclic_gen.py:51-76; their signs assume the
    first foot at +y, Solo12's FL, where the Go2's first foot, FR, sits at
    -y, so on the Go2 they narrow the stance);
    "generic" = foot - com, no nudges (abstract_cyclic_gen1.py:50-65); None =
    "solo12_hip" for the Solo family, else "generic". ``warm_start_style``
    None = "tiled" for the Solo family, else "vdes" (``CyclicMpcSpec``).

    K2 is built for the joint counts of ``cuda_ddp.JOINT_COUNTS`` (12: Solo12
    and the Go2; 8: Solo8), each a tree of chains off the base with four
    feet (``cuda_ddp.check_model``); another model raises ValueError."""
    device = resolve_device(device)
    cuda_ddp.check_model(model, eff_frames)
    solo = model.name.startswith("solo")
    if offset_style is None:
        offset_style = "solo12_hip" if solo else "generic"
    if warm_start_style is None:
        warm_start_style = "tiled" if solo else "vdes"
    if warm_start_style not in ("tiled", "vdes"):
        raise ValueError(f"unknown warm_start_style {warm_start_style!r}")
    q0t = torch.as_tensor(np.asarray(q0), dtype=torch.float64)
    com0 = K.com(model, q0t).numpy()
    if offset_style == "solo12_hip":
        hips = K.frame_positions(model, q0t, hip_frames).numpy()
        offsets = np.round(hips - com0, 3)
        offsets[:, 1] += np.array([0.04, -0.04, 0.04, -0.04])  # widen the stance
    elif offset_style == "generic":
        feet = K.frame_positions(model, q0t, eff_frames).numpy()
        offsets = np.round(feet - com0, 3)
    else:
        raise ValueError(f"unknown offset_style {offset_style!r}")
    R0 = Q.quat_to_rot(q0t[3:7]).numpy()
    offsets = offsets @ R0  # into the base frame
    I_comp = K.composite_inertia_about_com(model, q0t).numpy()

    horizon = params.horizon
    ik_hor = params.ik_horizon(ik_hor_ratio)
    size = min(ik_hor, int(params.plan_freq / params.gait_dt) + 2)
    if params.plan_freq > params.gait_dt:
        size -= 1
    n_int = size * int(round(params.gait_dt / 0.001))
    if x_reg is None:
        x_reg = np.concatenate([np.asarray(q0), np.zeros(model.nv)])

    return CyclicMpcSpec(
        model=model,
        params=params,
        eff_frames=tuple(eff_frames),
        horizon=horizon,
        ik_hor=ik_hor,
        gait=G.GaitParams(
            gait_period=params.gait_period,
            stance_percent=tuple(params.stance_percent),
            phase_offset=tuple(params.phase_offset),
            gait_dt=params.gait_dt,
            step_height=params.step_ht,
        ),
        planner=G.RaibertPlannerParams(hip_offsets=offsets, foot_size=foot_size),
        hip_offsets=offsets,
        I_comp=I_comp,
        x_reg=np.asarray(x_reg),
        size=size,
        n_int=n_int,
        device=device,
        warm_start_style=warm_start_style,
    )


class MpcPlan(NamedTuple):
    """Outputs of a batch of MPC solves (leading batch axis B), interpolated
    to 1 kHz like the reference, plus solver diagnostics."""

    xs_int: torch.Tensor  # (B, n_int, nq+nv) desired states
    us_int: torch.Tensor  # (B, n_int, nv) desired accelerations
    f_int: torch.Tensor  # (B, n_int, n_eff*3) feed-forward forces
    X_opt: torch.Tensor  # (B, H+1, 9) centroidal trajectory
    F_opt: torch.Tensor  # (B, H, n_eff, 3)
    xs: torch.Tensor  # (B, ik_hor+1, nq+nv) IK knots
    us: torch.Tensor  # (B, ik_hor, nv)
    cnt_plan: torch.Tensor  # (B, H, n_eff, 4) [flag, x, y, z]
    dyn_violation: torch.Tensor  # (B,)
    admm_iters: torch.Tensor  # (B,)
    ik_cost: torch.Tensor  # (B,)
    P_opt: torch.Tensor  # (B, H+1, 9) ADMM scaled dual at the base rho (zeros from K3)


def window_start(start_time, w_idx: int, plan_freq: float, like: torch.Tensor):
    """The start time of replanning window ``w_idx``, ``start_time + w_idx *
    plan_freq`` in ``like``'s dtype and device, unrounded (the JAX package's
    ``sim_t``, sim/rollout.py:322). ``start_time`` is a float (a 0-d time)
    or a (B,) tensor of per-episode start times."""
    w = torch.full((), w_idx, dtype=like.dtype, device=like.device)
    if torch.is_tensor(start_time):
        start_time = start_time.to(dtype=like.dtype, device=like.device)
    return start_time + w * plan_freq * 1.0


def window_clock(start_time, w_idx: int, plan_freq: float, like: torch.Tensor):
    """The gait clock of replanning window ``w_idx``: ``round(window_start,
    3)``, the JAX package's expression (sim/rollout.py:375) with numpy's
    rounding, the reference's. ``torch.round(x, decimals=3)`` divides by
    1000, where ``x / 1000`` on the card (and ``jnp.round``, which XLA
    compiles) multiplies by a rounded reciprocal; a clock one ulp off a knot
    can degenerate the first knot (``gait.first_knot_dt``)."""
    return torch.round(window_start(start_time, w_idx, plan_freq, like), decimals=3)


def _interp_1khz(spec: CyclicMpcSpec, dts, knots):
    """Linear interpolation of per-knot values onto the 1 ms grid.
    ``dts`` (B, size) durations; ``knots`` (B, size+1, d)."""
    B = dts.shape[0]
    bounds = torch.cat([torch.zeros_like(dts[:, :1]), torch.cumsum(dts, dim=-1)], dim=-1)
    tau = torch.arange(spec.n_int, dtype=dts.dtype, device=dts.device) * 0.001
    tau_b = tau.expand(B, -1).contiguous()
    k = torch.searchsorted(bounds.contiguous(), tau_b, right=True) - 1
    k = torch.clamp(k, 0, spec.size - 1)
    t0 = torch.gather(bounds, 1, k)
    w = torch.clamp((tau_b - t0) / torch.gather(dts, 1, k), 0.0, 1.0)[..., None]
    d = knots.shape[-1]
    k0 = torch.gather(knots, 1, k[..., None].expand(-1, -1, d))
    k1 = torch.gather(knots, 1, (k + 1)[..., None].expand(-1, -1, d))
    return k0 * (1 - w) + k1 * w


def _prepare_problem(spec: CyclicMpcSpec, q, v, t, v_des, w_des, noise_xy=None, terrain=None):
    """Batched problem assembly: contact plan + dynamics costs + warm starts
    (abstract_cyclic_gen.py create_cnt_plan/create_costs; kino_dyn.cpp:83-99
    for the cold warm start, with the spec's ``warm_start_style``). Forces
    regularize toward zero (``f_reg_style="zero"``, the reference's) or, with
    ``"weight"``, toward m g shared by a knot's stance feet (``F_ref``).

    ``noise_xy`` (B, H, n_eff, 2) moves the planned touchdowns (scaled by
    their distance from the plan's origin, ``gait.create_cnt_plan``).
    ``terrain`` (``sim.physics.Terrain``, world coordinates) sets the
    touchdown and swing heights and lifts the nominal and terminal CoM
    heights by the ground under the planned CoM path; the plan is
    origin-reset, so q's pre-reset xy maps it back onto the heightfield.
    Flat ground (neither given) is the reference's plan."""
    p = spec.params
    if p.f_reg_style not in ("zero", "weight"):
        raise ValueError(f"unknown f_reg_style {p.f_reg_style!r}")
    m = spec.model.total_mass
    dtype, device = q.dtype, q.device
    H = spec.horizon
    B = q.shape[0]

    def vec(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    xy_world = q[:, 0:2].clone()  # the terrain is in world coordinates
    q = q.clone()
    q[:, 0:2] = 0.0  # origin reset (abstract_cyclic_gen.py:632-633)
    t = t.to(dtype)
    v_des_w = (Q.quat_to_rot(q[:, 3:7]) @ v_des[..., None])[..., 0]

    com, h_lin, h_ang, ee_pos = K.centroidal_state_and_frames(
        spec.model, q, v, spec.eff_frames
    )
    x_init = torch.cat([com, h_lin / m, h_ang], dim=-1)
    plan, swing_mask = G.create_cnt_plan(
        spec.gait, spec.planner, H, q, t, v_des_w, w_des, com, ee_pos,
        noise_xy=noise_xy, terrain=terrain, terrain_offset=xy_world,
    )

    # dynamics costs (create_costs, abstract_cyclic_gen.py:564-614)
    dt_arr = plan.dt
    vxy = v_des_w[:, None, 0:2]
    xy_nom = (
        x_init[:, None, 0:2]
        + torch.cumsum(vxy * dt_arr[..., None], dim=1)
        - vxy * dt_arr[:, 0, None, None]
    )  # knot 0 anchors at the current CoM

    ident = vec([0.0, 0.0, 0.0, 1.0]).expand(B, 4)
    ori_des = torch.where((w_des != 0.0)[:, None], q[:, 3:7], ident)
    amom = Q.log3_quat(Q.quat_mul(Q.yaw_quat(ori_des), Q.quat_conj(q[:, 3:7])))
    oc = p.ori_correction
    yaw_mom = float(spec.I_comp[2, 2]) * w_des
    amom_z_nom = torch.where(w_des == 0.0, amom[:, 2] * oc[2], yaw_mom)

    ones = torch.ones((B, H), dtype=dtype, device=device)
    # the nominal height rides the ground under the planned CoM path
    z_nom = p.nom_ht * ones if terrain is None else (
        p.nom_ht + terrain.height_at(xy_nom + xy_world[:, None]))
    X_nom = torch.cat(
        [
            xy_nom,
            z_nom[..., None],
            v_des_w[:, None, :].expand(B, H, 3),
            (amom[:, 0, None] * oc[0] * ones)[..., None],
            (amom[:, 1, None] * oc[1] * ones)[..., None],
            (amom_z_nom[:, None] * ones)[..., None],
        ],
        dim=-1,
    )
    xy_ter = x_init[:, 0:2] + (p.gait_horizon * p.gait_period * v_des_w)[:, 0:2]
    z_ter = torch.full((B, 1), p.nom_ht, dtype=dtype, device=device) if terrain is None else (
        p.nom_ht + terrain.height_at(xy_ter + xy_world)[:, None])
    X_ter = torch.cat(
        [
            xy_ter,
            z_ter,
            v_des_w,
            amom[:, 0:2],
            torch.where(w_des == 0.0, amom[:, 2], yaw_mom)[:, None],
        ],
        dim=-1,
    )
    W = torch.cat([vec(p.W_X).expand(H, 9), vec(p.W_X_ter)[None]], dim=0).expand(B, H + 1, 9)
    X_ref = torch.cat([X_nom, X_ter[:, None]], dim=1)
    W_F = vec(np.asarray(p.W_F).reshape(spec.n_eff, 3)).expand(B, H, spec.n_eff, 3)

    b_lo = vec([-spec.bx, -spec.by, 0.0])
    b_hi = vec([spec.bx, spec.by, spec.bz])
    x_bounds = biconvex.kinematic_box_bounds(plan, b_lo, b_hi)

    # mass-normalized force regularization point: a knot's stance feet share
    # m g, swing feet pull to zero
    F_ref = None
    if p.f_reg_style == "weight":
        n_act = torch.clamp(torch.sum(plan.cnt, dim=-1, keepdim=True), min=1.0)
        F_ref = torch.zeros((B, H, spec.n_eff, 3), dtype=dtype, device=device)
        F_ref[..., 2] = plan.cnt * (m * 9.81) / n_act

    # cold warm start: the current centroidal state tiled, zero forces; "vdes"
    # rides the command on the plan's time grid
    X_wm = x_init[:, None, :].expand(B, H + 1, 9).contiguous()
    if spec.warm_start_style == "vdes":
        tgrid = torch.cat([torch.zeros_like(dt_arr[:, :1]), torch.cumsum(dt_arr, dim=1)], dim=1)
        X_wm[..., 0:2] += tgrid[..., None] * v_des_w[:, None, 0:2]
        X_wm[..., 3:6] = v_des_w[:, None, :]
    F_wm = torch.zeros((B, H, spec.n_eff, 3), dtype=dtype, device=device)
    return dict(
        q=q, v=v, plan=plan, swing_mask=swing_mask, x_init=x_init,
        W=W.contiguous(), X_ref=X_ref, W_F=W_F.contiguous(), x_bounds=x_bounds,
        X_wm=X_wm, F_wm=F_wm, F_ref=F_ref,
    )


def make_prep_consts(spec: CyclicMpcSpec) -> cuda_fused.PrepConsts:
    """The static constants of K3's prologue for this (robot, gait)."""
    p = spec.params
    g = spec.gait
    return cuda_fused.PrepConsts(
        gait_period=float(g.gait_period),
        gait_dt=float(g.gait_dt),
        stance_percent=tuple(float(x) for x in g.stance_percent),
        phase_offset=tuple(float(x) for x in g.phase_offset),
        foot_size=float(spec.planner.foot_size),
        nom_ht=float(p.nom_ht),
        ori_correction=tuple(float(x) for x in p.ori_correction),
        gait_horizon=float(p.gait_horizon),
        izz_yaw=float((np.asarray(spec.I_comp) @ np.array([0.0, 0.0, 1.0]))[2]),
        W_X=tuple(float(x) for x in np.asarray(p.W_X)),
        W_X_ter=tuple(float(x) for x in np.asarray(p.W_X_ter)),
        W_F=tuple(float(x) for x in np.asarray(p.W_F)),
        bx=float(spec.bx),
        by=float(spec.by),
        bz=float(spec.bz),
        warm_start_vdes=spec.warm_start_style == "vdes",
        f_reg_weight=p.f_reg_style == "weight",
    )


def _compact_inputs(spec: CyclicMpcSpec, q, v, t, v_des, w_des):
    """The fused path's first stage, batched: the kinematics K3 does not
    rebuild (the FK pass for the centroidal state and the feet, the yaw-frame
    hip offsets, the orientation-correction momentum). Returns
    ``(q, t, v_des_w, x_init, ee_pos, hip_world, amom)`` with q origin-reset."""
    m = spec.model.total_mass
    dtype, device = q.dtype, q.device
    B = q.shape[0]
    q = q.clone()
    q[:, 0:2] = 0.0  # origin reset (abstract_cyclic_gen.py:632-633)
    t = t.to(dtype)
    v_des_w = (Q.quat_to_rot(q[:, 3:7]) @ v_des[..., None])[..., 0]
    com, h_lin, h_ang, ee_pos = K.centroidal_state_and_frames(
        spec.model, q, v, spec.eff_frames
    )
    x_init = torch.cat([com, h_lin / m, h_ang], dim=-1)
    R_yaw = Q.quat_to_rot(Q.yaw_quat(q[:, 3:7]))
    hip_off = torch.as_tensor(spec.planner.hip_offsets, dtype=dtype, device=device)
    hip_world = (R_yaw[:, None, :, :] @ hip_off[..., None])[..., 0]  # (B, ne, 3)
    ident = torch.as_tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device).expand(B, 4)
    ori_des = torch.where((w_des != 0.0)[:, None], q[:, 3:7], ident)
    amom = Q.log3_quat(Q.quat_mul(Q.yaw_quat(ori_des), Q.quat_conj(q[:, 3:7])))
    return q, t, v_des_w, x_init, ee_pos.contiguous(), hip_world.contiguous(), amom


def _build_ik_tasks(spec: CyclicMpcSpec, prob, dyn_X):
    """IK tasks from the dynamics solution: tracking targets (kino_dyn.cpp:
    50-56) and swing tasks (abstract_cyclic_gen.py:545-554). Returns
    ``(tasks, x0)``."""
    p = spec.params
    m = spec.model.total_mass
    q, v = prob["q"], prob["v"]
    plan, swing_mask = prob["plan"], prob["swing_mask"]
    dtype, device = q.dtype, q.device
    ik_h = spec.ik_hor

    com_ref = dyn_X[:, : ik_h + 1, 0:3].contiguous()
    mom_ref = torch.cat([m * dyn_X[:, : ik_h + 1, 3:6], dyn_X[:, : ik_h + 1, 6:9]], dim=-1)

    cnt_ik = plan.cnt[:, :ik_h]
    ee_targets = plan.r[:, :ik_h]
    # via height is ground-relative: (z - foot_size) + step_ht
    via_z = ee_targets[..., 2] - spec.planner.foot_size + p.step_ht
    via_targets = torch.cat([ee_targets[..., 0:2], via_z[..., None]], dim=-1)
    is_via = swing_mask[:, :ik_h] & (cnt_ik == 0)
    ee_targets = torch.where(is_via[..., None], via_targets, ee_targets)
    zero = torch.zeros_like(cnt_ik)
    ee_wts = torch.where(
        cnt_ik == 1.0,
        zero + p.swing_wt[0],
        torch.where(is_via, zero + p.swing_wt[1], zero),
    )

    def vec(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    tasks = IK.IkTasks(
        ee_targets=ee_targets,
        ee_wts=ee_wts,
        com_ref=com_ref,
        mom_ref=mom_ref,
        com_wt=float(p.cent_wt[0]),
        mom_wt=float(p.cent_wt[1]),
        state_wt=vec(p.state_wt),
        x_reg=vec(spec.x_reg),
        reg_wt_state=float(p.reg_wt[0]),
        reg_wt_ctrl=float(p.reg_wt[1]),
        ctrl_wt=vec(p.ctrl_wt),
        dts=plan.dt[:, :ik_h].contiguous(),
    )
    return tasks, torch.cat([q, v], dim=-1)


def _finish_from_ik(spec, prob, dyn_X, dyn_F, dyn_viol, dyn_iters, ik_xs, ik_us, ik_cost, dyn_P):
    """1 kHz interpolation + plan assembly (abstract_cyclic_gen.py:677-698)."""
    plan = prob["plan"]
    sz = spec.size
    dts_sz = plan.dt[:, :sz]
    B = dyn_X.shape[0]
    xs_int = _interp_1khz(spec, dts_sz, ik_xs[:, : sz + 1])
    us_pad = torch.cat([ik_us, ik_us[:, -1:]], dim=1)[:, : sz + 1]
    us_int = _interp_1khz(spec, dts_sz, us_pad)
    f_int = _interp_1khz(spec, dts_sz, dyn_F[:, : sz + 1].reshape(B, sz + 1, -1))
    return MpcPlan(
        xs_int=xs_int,
        us_int=us_int,
        f_int=f_int,
        X_opt=dyn_X,
        F_opt=dyn_F,
        xs=ik_xs,
        us=ik_us,
        cnt_plan=torch.cat([plan.cnt[..., None], plan.r], dim=-1),
        dyn_violation=dyn_viol,
        admm_iters=dyn_iters,
        ik_cost=ik_cost,
        P_opt=dyn_P,
    )


def _inputs(spec: CyclicMpcSpec, q, v, t, v_des, w_des):
    """The five inputs as tensors on one device: a tensor keeps its device,
    anything else goes to ``spec.device``."""
    device = q.device if isinstance(q, torch.Tensor) else spec.device
    device = resolve_device(device)
    dtype = q.dtype if isinstance(q, torch.Tensor) else torch.float32

    def t_(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return t_(q), t_(v), t_(t), t_(v_des), t_(w_des)


def solve_mpc_batch(
    spec: CyclicMpcSpec,
    q,  # (B, nq)
    v,  # (B, nv)
    t,  # (B,)
    v_des,  # (B, 3)
    w_des,  # (B,)
    admm_cfg=None,  # biconvex.BiconvexConfig ("torch") / cuda_admm.CudaAdmmConfig ("cuda")
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
    fuse_prep: bool = False,
    warm_start=None,  # optional (X_wm (B, H+1, 9), F_wm (B, H, n_eff, 3), P_wm (B, H+1, 9))
    noise_xy=None,  # optional (B, H, n_eff, 2) touchdown-location noise
    terrain=None,  # optional sim.physics.Terrain: uneven-ground planning
) -> MpcPlan:
    """Batched kino-dynamic MPC. ``"cuda"`` backends run the hand-written
    kernels, ``"torch"`` their plain versions; both return the ADMM's scaled
    dual in ``P_opt``. ``fuse_prep=True`` builds the problem inside the ADMM
    kernel (K3; flat ground, as the JAX package's fused path), needs
    ``admm_backend="cuda"`` and returns a zero dual. Any B is accepted.

    ``warm_start`` replaces the ADMM's cold start with a carried solution
    and its scaled dual (the JAX package's ``solve_mpc(warm_start=...)``), on
    either backend; the fused path starts cold, as the JAX package's does.

    ``noise_xy`` and ``terrain`` plan touchdown noise and uneven ground
    (``_prepare_problem``; the JAX package's ``solve_mpc``, whose batch it
    takes whole where the JAX package vmaps). K3 builds a flat plan with no
    noise, as the JAX package's fused path does: with ``fuse_prep=True``
    either raises ValueError."""
    if admm_backend not in ("cuda", "torch"):
        raise ValueError(f"admm_backend must be 'cuda' or 'torch', got {admm_backend!r}")
    if ik_backend not in ("cuda", "torch"):
        raise ValueError(f"ik_backend must be 'cuda' or 'torch', got {ik_backend!r}")
    if fuse_prep and admm_backend != "cuda":
        # the JAX package falls back to the unfused path here without a word
        raise ValueError("fuse_prep=True runs the fused kernel (K3): admm_backend must be 'cuda'")
    if warm_start is not None and fuse_prep:
        raise ValueError("the fused path (K3) builds its own cold start: warm_start needs "
                         "fuse_prep=False")
    if (noise_xy is not None or terrain is not None) and fuse_prep:
        raise ValueError("the fused path (K3) plans flat ground without touchdown noise: "
                         "noise_xy and terrain need fuse_prep=False")
    with profiling.span("mpc.solve"):
        p = spec.params
        m = spec.model.total_mass
        q, v, t, v_des, w_des = _inputs(spec, q, v, t, v_des, w_des)
        if noise_xy is not None:
            noise_xy = torch.as_tensor(noise_xy, dtype=q.dtype, device=q.device)
        if terrain is not None:
            terrain = terrain.to(q)

        if fuse_prep:
            if admm_cfg is None:
                admm_cfg = cuda_admm.CudaAdmmConfig(rho=p.rho, x_solver="thomas")
            with profiling.span("mpc.fused"):
                qr, t_, v_des_w, x_init, ee, hip, amom = _compact_inputs(spec, q, v, t, v_des,
                                                                         w_des)
                X, F, viol, iters, cnt, r, dts, swing = cuda_fused.solve_from_state(
                    t_, v_des_w, w_des, x_init, ee, hip, amom, m, make_prep_consts(spec),
                    admm_cfg, spec.horizon, spec.n_eff,
                )
                prob = dict(q=qr, v=v, x_init=x_init, plan=G.ContactPlan(cnt=cnt, r=r, dt=dts),
                            swing_mask=swing)
                P = torch.zeros_like(X)
        else:
            with profiling.span("mpc.prep"):
                prob = _prepare_problem(spec, q, v, t, v_des, w_des, noise_xy=noise_xy,
                                        terrain=terrain)
            X_wm, F_wm, P_wm = (prob["X_wm"], prob["F_wm"], None) if warm_start is None \
                else warm_start
            with profiling.span("mpc.k1"):
                if admm_backend == "cuda":
                    if admm_cfg is None:
                        admm_cfg = cuda_admm.CudaAdmmConfig(rho=p.rho, x_solver="thomas")
                    X, F, viol, iters, P = cuda_admm.solve(
                        prob["plan"], m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"],
                        X_wm, F_wm, prob["x_bounds"], admm_cfg, prob["F_ref"], P_wm,
                    )
                else:
                    if admm_cfg is None:
                        admm_cfg = biconvex.BiconvexConfig(rho=p.rho, x_solver="thomas")
                    dyn = biconvex.solve(
                        prob["plan"], m, prob["x_init"],
                        biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"]), prob["W_F"], X_wm,
                        F_wm, torch.zeros_like(X_wm) if P_wm is None else P_wm, admm_cfg,
                        x_bounds=prob["x_bounds"], F_ref=prob["F_ref"],
                    )
                    X, F, viol, iters, P = dyn.X, dyn.F, dyn.viol_norm, dyn.admm_iters, dyn.P
        profiling.count("mpc.admm_iters_max", iters)

        with profiling.span("mpc.ik_build"):
            tasks, x0 = _build_ik_tasks(spec, prob, X)
            w_stage, w_term, ctrl_w, x_reg = IK.dense_weights(spec.model, spec.eff_frames, tasks)
            args = (
                x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg, w_stage, w_term,
                ctrl_w, tasks.dts,
            )
        with profiling.span("mpc.k2"):
            if ik_backend == "cuda":
                if ddp_cfg.derivs_every != 1:
                    raise NotImplementedError(
                        "the DDP kernel refreshes its Jacobians every iteration")
                kcfg = cuda_ddp.CudaDdpConfig(
                    n_iters=ddp_cfg.n_iters, alphas=tuple(ddp_cfg.alphas), reg=ddp_cfg.reg
                )
                ik_xs, ik_us, ik_cost = cuda_ddp.solve_ik_batch(
                    spec.model, spec.eff_frames, *args, cfg=kcfg
                )
            else:
                res = IK.solve_dense(spec.model, spec.eff_frames, *args, cfg=ddp_cfg)
                ik_xs, ik_us, ik_cost = res.xs, res.us, res.cost
        with profiling.span("mpc.finish"):
            return _finish_from_ik(spec, prob, X, F, viol, iters, ik_xs, ik_us, ik_cost, P)


def _one(a):
    """A single problem's input as a batch of one: a leading axis added (an
    array stays an array, so that ``_inputs`` places it)."""
    return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]


def solve_mpc(
    spec: CyclicMpcSpec,
    q,  # (nq,)
    v,  # (nv,)
    t,  # () gait clock
    v_des,  # (3,) commanded CoM velocity (base heading frame)
    w_des,  # () commanded yaw rate
    admm_cfg=None,
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
    noise_xy=None,  # optional (H, n_eff, 2) touchdown-location noise
    terrain=None,  # optional sim.physics.Terrain: uneven-ground planning
    warm_start=None,  # optional (X_wm, F_wm, P_wm) from a previous solve
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> MpcPlan:
    """One kino-dynamic MPC solve (the JAX package's ``solve_mpc``): the
    batch of one through ``solve_mpc_batch``, whose plan it returns without
    the batch axis. Inputs, config and backends as there."""
    plan = solve_mpc_batch(
        spec, _one(q), _one(v), _one(t), _one(v_des), _one(w_des), admm_cfg=admm_cfg,
        ddp_cfg=ddp_cfg, admm_backend=admm_backend, ik_backend=ik_backend,
        warm_start=None if warm_start is None else tuple(_one(a) for a in warm_start),
        noise_xy=None if noise_xy is None else _one(noise_xy), terrain=terrain,
    )
    return MpcPlan(*(a[0] for a in plan))
