"""Acyclic motion planner: jumps, cartwheels, rearing, stand.

Counterpart of ``bunmpc_tpu/mpc/acyclic.py`` (reference ``SoloAcyclicGen``,
examples/mpc/abstract_acyclic_gen.py:13-468): the contact plan, nominal
states, CoM bounds, swing via-points and state/control regularization all
come from time-stamped segments of an ``ACyclicMotionParams`` motion table;
each solve looks up the segment active at every knot time.

``make_acyclic_spec`` turns the table's Python lists into dense arrays once
on the host; a lookup is ``torch.searchsorted`` over the segment starts.
``solve_acyclic_mpc_batch`` takes the batch whole, one motion time per
problem (the JAX package vmaps ``solve_acyclic_mpc``): stage 1 assembles
every problem's centroidal ADMM, stage 2 runs it (K1, ``solvers/cuda_admm``,
with ``admm_backend="cuda"``; its plain version with ``"torch"``), stage 3
builds the IK tasks with per-knot weights, stage 4 runs the GN-DDP (K2,
``solvers/cuda_ddp``, with ``ik_backend="cuda"``; its plain version with
``"torch"``) and stage 5 interpolates the plan to 1 kHz.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..solvers import biconvex, cuda_admm, cuda_ddp, ddp
from . import gait as G
from . import ik as IK
from .centroidal import ContactPlan
from .kino_dyn import MpcPlan, _interp_1khz, resolve_device
from .motions.params import ACyclicMotionParams


@dataclasses.dataclass(frozen=True)
class AcyclicMpcSpec:
    """Static, host-side precomputation for one (robot, motion) pair."""

    model: RobotModel
    params: ACyclicMotionParams
    eff_frames: tuple
    horizon: int  # n_col
    ik_hor: int
    dt_arr: np.ndarray  # (n_col,)
    # dense segment tables (host-side constants)
    cnt_starts: np.ndarray  # (n_seg,)
    cnt_vals: np.ndarray  # (n_seg, n_eff, 4)
    xnom_starts: np.ndarray
    xnom_vals: np.ndarray  # (n_seg, 9)
    x_ter: np.ndarray  # (9,)
    bounds_starts: np.ndarray
    bounds_vals: np.ndarray  # (n_seg, 6)
    swing_starts: np.ndarray  # (n_seg,) via-point windows ([] allowed)
    swing_ends: np.ndarray
    swing_vals: np.ndarray  # (n_seg, n_eff, 4) [wt, x, y, z]
    sreg_starts: np.ndarray
    sreg_wt: np.ndarray  # (n_seg, 2nv)
    sreg_x: np.ndarray  # (n_seg, nq+nv)
    sreg_scale: np.ndarray  # (n_seg,)
    creg_starts: np.ndarray
    creg_wt: np.ndarray  # (n_seg, nv)
    creg_scale: np.ndarray  # (n_seg,)
    size: int
    n_int: int
    plan_freq: float
    device: torch.device

    @property
    def n_eff(self):
        return len(self.eff_frames)


def make_acyclic_spec(
    model: RobotModel,
    params: ACyclicMotionParams,
    eff_frames=("FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"),
    ik_hor_ratio: float = 1.0,
    plan_freq: float | None = None,
    device="cuda",
) -> AcyclicMpcSpec:
    """Host-side setup of a motion (the JAX package's ``make_acyclic_spec``).
    ``device`` is where ``solve_acyclic_mpc_batch`` runs arrays by default;
    a model K2 is not built for raises ValueError (``cuda_ddp.check_model``)."""
    device = resolve_device(device)
    cuda_ddp.check_model(model, eff_frames)
    nv = model.nv
    n_col = int(params.n_col)
    ik_hor = int(round(ik_hor_ratio * n_col))
    dt_arr = np.asarray(params.dt_arr, float)

    cnt = np.asarray(params.cnt_plan, float)  # (n_seg, n_eff, 6)
    xnom = np.asarray(params.X_nom, float)  # (n_seg, 11)
    sw = params.swing_wt
    if sw is not None and len(sw):
        sw = np.asarray(sw, float)  # (n_seg, n_eff, 6)
        swing_starts, swing_ends = np.ascontiguousarray(sw[:, 0, 4]), sw[:, 0, 5]
        swing_vals = sw[:, :, 0:4]
    else:
        swing_starts = np.array([np.inf])
        swing_ends = np.array([np.inf])
        swing_vals = np.zeros((1, len(eff_frames), 4))
    sreg_scale = np.asarray(params.state_scale, float)
    creg_scale = np.asarray(params.ctrl_scale, float)

    pf = plan_freq if plan_freq is not None else (
        params.plan_freq if np.isscalar(params.plan_freq) else params.plan_freq[0][0]
    )
    size = min(ik_hor, int(pf / dt_arr[0]) + 2)
    if pf > dt_arr[0]:
        size += 1
    size = min(size, ik_hor)
    n_int = size * int(round(dt_arr[0] / 0.001))

    bounds = np.asarray(params.bounds, float)
    return AcyclicMpcSpec(
        model=model,
        params=params,
        eff_frames=tuple(eff_frames),
        horizon=n_col,
        ik_hor=ik_hor,
        dt_arr=dt_arr,
        cnt_starts=np.ascontiguousarray(cnt[:, 0, 4]),
        cnt_vals=cnt[:, :, 0:4],
        xnom_starts=np.ascontiguousarray(xnom[:, 9]),
        xnom_vals=xnom[:, 0:9],
        x_ter=np.asarray(params.X_ter, float),
        bounds_starts=np.ascontiguousarray(bounds[:, -2]),
        bounds_vals=bounds[:, 0:6],
        swing_starts=swing_starts,
        swing_ends=swing_ends,
        swing_vals=swing_vals,
        sreg_starts=np.ascontiguousarray(sreg_scale[:, 1]),
        sreg_wt=np.asarray(params.state_wt, float)[:, : 2 * nv],
        sreg_x=np.asarray(params.state_reg, float)[:, : model.nq + nv],
        sreg_scale=sreg_scale[:, 0],
        creg_starts=np.ascontiguousarray(creg_scale[:, 1]),
        creg_wt=np.asarray(params.ctrl_wt, float)[:, :nv],
        creg_scale=creg_scale[:, 0],
        size=size,
        n_int=n_int,
        plan_freq=pf,
        device=device,
    )


def _lookup(starts, vals, ft):
    """The values of the last segment whose start is <= ft (..., K): (...,
    K, *vals.shape[1:]); times past the last start take the last segment,
    times before the first the first (the reference's make_cyclic=False
    path). ``starts`` and ``vals`` are host arrays, read in ``ft``'s dtype."""
    s = K.const(starts, ft)
    idx = torch.clamp(torch.searchsorted(s, ft.contiguous(), right=True) - 1, 0, len(starts) - 1)
    return K.const(vals, ft)[idx]


def knot_times(spec: AcyclicMpcSpec, t):
    """``(knot_t (B, H), dts (B, H))``: each knot's time into the motion,
    ``round(t - dt_0 + cumsum(dt_arr), 3)`` (reference :86-88), and the knot
    durations with the first knot shrunk to the next multiple of dt_0
    (rounded to 2 decimals, ``gait.first_knot_dt``'s quirk)."""
    dt_arr = K.const(spec.dt_arr, t)
    knot_t = torch.round(t[:, None] - dt_arr[0] + torch.cumsum(dt_arr, 0), decimals=3)
    d0 = float(spec.dt_arr[0])
    dt0 = d0 - torch.round(G._mod(t, d0), decimals=2)
    dt0 = torch.where(dt0 == 0.0, torch.full_like(dt0, d0), dt0)
    dts = dt_arr.expand(t.shape[0], -1).clone()
    dts[:, 0] = dt0
    return knot_t, dts


def _prepare(spec: AcyclicMpcSpec, q, v, t):
    """Stage 1, batched: the contact plan, the dynamics costs and bounds and
    the cold start from the segments active at each knot (reference
    SoloAcyclicGen.optimize, :299-340)."""
    p = spec.params
    m = spec.model.total_mass
    B, H = q.shape[0], spec.horizon
    dtype, device = q.dtype, q.device
    knot_t, dts = knot_times(spec, t)
    cnt4 = _lookup(spec.cnt_starts, spec.cnt_vals, knot_t)  # (B, H, ne, 4)
    plan = ContactPlan(cnt=cnt4[..., 0].contiguous(), r=cnt4[..., 1:4].contiguous(), dt=dts)

    com, h_lin, h_ang = K.centroidal_momentum(spec.model, q, v)
    x_init = torch.cat([com, h_lin / m, h_ang], dim=-1)
    X_nom = _lookup(spec.xnom_starts, spec.xnom_vals, knot_t)  # a copy: gathered
    X_nom[:, 0] = x_init  # reference :187
    X_ref = torch.cat([X_nom, K.const(spec.x_ter, q).expand(B, 1, 9)], dim=1)
    W = torch.cat([K.const(p.W_X, q).expand(H, 9), K.const(p.W_X_ter, q)[None]]).expand(
        B, H + 1, 9)
    W_F = K.const(p.W_F, q).reshape(spec.n_eff, 3).expand(B, H, spec.n_eff, 3)
    bounds6 = _lookup(spec.bounds_starts, spec.bounds_vals, knot_t)
    x_bounds = biconvex.kinematic_box_bounds(plan, bounds6[..., 0:3], bounds6[..., 3:6])
    X_wm = x_init[:, None, :].expand(B, H + 1, 9).contiguous()
    F_wm = torch.zeros((B, H, spec.n_eff, 3), dtype=dtype, device=device)
    return dict(plan=plan, cnt4=cnt4, knot_t=knot_t, x_init=x_init, W=W.contiguous(),
                X_ref=X_ref, W_F=W_F.contiguous(), x_bounds=x_bounds, X_wm=X_wm, F_wm=F_wm)


def _ik_tasks(spec: AcyclicMpcSpec, prob, X):
    """Stage 3: the IK tasks from the dynamics solution, with the swing
    via-points and the per-knot regularization of the segments active at
    each IK knot (reference :340-370)."""
    p = spec.params
    m = spec.model.total_mass
    ik_h = spec.ik_hor
    plan, knot_t = prob["plan"], prob["knot_t"]
    knot_t_ik = knot_t[:, :ik_h]
    cnt_ik = plan.cnt[:, :ik_h]
    cnt_targets = plan.r[:, :ik_h]
    swing = _lookup(spec.swing_starts, spec.swing_vals, knot_t_ik)  # (B, ik_h, ne, 4)
    in_window = ((knot_t_ik[..., None] >= float(spec.swing_starts[0]))
                 & (knot_t_ik[..., None] < float(spec.swing_ends[-1])))
    swing_active = (swing[..., 0] > 0) & in_window & (cnt_ik == 0)
    ee_targets = torch.where(swing_active[..., None], swing[..., 1:4], cnt_targets)
    zero = torch.zeros_like(cnt_ik)
    ee_wts = torch.where(cnt_ik == 1.0, zero + float(getattr(p, "cnt_wt", 5e4)),
                         torch.where(swing_active, swing[..., 0], zero))

    knot_t_full = torch.cat([knot_t_ik, knot_t_ik[:, -1:] + float(spec.dt_arr[ik_h - 1])], dim=1)
    return IK.IkTasks(
        ee_targets=ee_targets.contiguous(),
        ee_wts=ee_wts,
        com_ref=X[:, : ik_h + 1, 0:3].contiguous(),
        mom_ref=torch.cat([m * X[:, : ik_h + 1, 3:6], X[:, : ik_h + 1, 6:9]], dim=-1),
        com_wt=float(p.cent_wt[0]),
        mom_wt=float(p.cent_wt[1]),
        state_wt=_lookup(spec.sreg_starts, spec.sreg_wt, knot_t_full),
        x_reg=_lookup(spec.sreg_starts, spec.sreg_x, knot_t_full),
        reg_wt_state=_lookup(spec.sreg_starts, spec.sreg_scale, knot_t_full),
        reg_wt_ctrl=_lookup(spec.creg_starts, spec.creg_scale, knot_t_ik),
        ctrl_wt=_lookup(spec.creg_starts, spec.creg_wt, knot_t_ik),
        dts=plan.dt[:, :ik_h].contiguous(),
    )


def _inputs(spec: AcyclicMpcSpec, q, v, t):
    """The three inputs as tensors on one device: a tensor keeps its device
    and dtype, anything else goes to ``spec.device`` in float32."""
    device = resolve_device(q.device if isinstance(q, torch.Tensor) else spec.device)
    dtype = q.dtype if isinstance(q, torch.Tensor) else torch.float32
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (q, v, t))


def solve_acyclic_mpc_batch(
    spec: AcyclicMpcSpec,
    q,  # (B, nq)
    v,  # (B, nv)
    t,  # (B,) time into the motion
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
    admm_cfg=None,  # cuda_admm.CudaAdmmConfig ("cuda") / biconvex.BiconvexConfig ("torch")
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
) -> MpcPlan:
    """A batch of acyclic MPC solves (reference SoloAcyclicGen.optimize,
    :299-370; the JAX package's ``solve_acyclic_mpc`` per problem), each at
    its own time ``t`` into the motion. ``"cuda"`` backends run K1 and K2,
    ``"torch"`` their plain versions; the default ADMM config is the
    motion's rho with the Thomas X-step. No warm start is taken: each solve
    starts from the current centroidal state tiled and zero forces."""
    if admm_backend not in ("cuda", "torch"):
        raise ValueError(f"admm_backend must be 'cuda' or 'torch', got {admm_backend!r}")
    if ik_backend not in ("cuda", "torch"):
        raise ValueError(f"ik_backend must be 'cuda' or 'torch', got {ik_backend!r}")
    p = spec.params
    m = spec.model.total_mass
    q, v, t = _inputs(spec, q, v, t)
    prob = _prepare(spec, q, v, t)
    plan = prob["plan"]
    admm_in = (plan, m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"], prob["X_wm"],
               prob["F_wm"], prob["x_bounds"])
    if admm_backend == "cuda":
        if admm_cfg is None:
            admm_cfg = cuda_admm.CudaAdmmConfig(rho=p.rho, x_solver="thomas")
        X, F, viol, iters, P = cuda_admm.solve(*admm_in, admm_cfg)
    else:
        if admm_cfg is None:
            admm_cfg = biconvex.BiconvexConfig(rho=p.rho, x_solver="thomas")
        dyn = biconvex.solve(
            plan, m, prob["x_init"], biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"]),
            prob["W_F"], prob["X_wm"], prob["F_wm"], torch.zeros_like(prob["X_wm"]), admm_cfg,
            x_bounds=prob["x_bounds"])
        X, F, viol, iters, P = dyn.X, dyn.F, dyn.viol_norm, dyn.admm_iters, dyn.P

    tasks = _ik_tasks(spec, prob, X)
    w_stage, w_term, ctrl_w, x_reg = IK.dense_weights(spec.model, spec.eff_frames, tasks)
    x0 = torch.cat([q, v], dim=-1)
    args = (x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg, w_stage, w_term, ctrl_w,
            tasks.dts)
    if ik_backend == "cuda":
        if ddp_cfg.derivs_every != 1:
            raise NotImplementedError("the DDP kernel refreshes its Jacobians every iteration")
        kcfg = cuda_ddp.CudaDdpConfig(n_iters=ddp_cfg.n_iters, alphas=tuple(ddp_cfg.alphas),
                                      reg=ddp_cfg.reg)
        ik_xs, ik_us, ik_cost = cuda_ddp.solve_ik_batch(spec.model, spec.eff_frames, *args,
                                                        cfg=kcfg)
    else:
        res = IK.solve_dense(spec.model, spec.eff_frames, *args, cfg=ddp_cfg)
        ik_xs, ik_us, ik_cost = res.xs, res.us, res.cost

    sz = spec.size
    dts_sz = plan.dt[:, :sz]
    B = q.shape[0]
    xs_int = _interp_1khz(spec, dts_sz, ik_xs[:, : sz + 1])
    us_int = _interp_1khz(spec, dts_sz, torch.cat([ik_us, ik_us[:, -1:]], dim=1)[:, : sz + 1])
    # the forces' last knot repeats where the plan covers the whole horizon
    # (size == H, hifive's; the JAX package's reshape raises there)
    f_pad = torch.cat([F, F[:, -1:]], dim=1)[:, : sz + 1]
    f_int = _interp_1khz(spec, dts_sz, f_pad.reshape(B, sz + 1, -1))
    return MpcPlan(
        xs_int=xs_int, us_int=us_int, f_int=f_int, X_opt=X, F_opt=F, xs=ik_xs, us=ik_us,
        cnt_plan=prob["cnt4"], dyn_violation=viol, admm_iters=iters, ik_cost=ik_cost, P_opt=P,
    )


def solve_acyclic_mpc(
    spec: AcyclicMpcSpec,
    q,  # (nq,)
    v,  # (nv,)
    t,  # () time into the motion
    admm_cfg=None,
    ddp_cfg: ddp.DdpConfig = ddp.DdpConfig(),
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> MpcPlan:
    """One acyclic MPC solve (the JAX package's ``solve_acyclic_mpc``): the
    batch of one through ``solve_acyclic_mpc_batch``, whose plan it returns
    without the batch axis."""
    def one(a):
        return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]

    plan = solve_acyclic_mpc_batch(spec, one(q), one(v), one(t), admm_backend=admm_backend,
                                   ik_backend=ik_backend, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg)
    return MpcPlan(*(a[0] for a in plan))
