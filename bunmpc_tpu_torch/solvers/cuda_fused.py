"""K3: problem assembly and the centroidal ADMM in one hand-written CUDA kernel.

Counterpart of ``bunmpc_tpu/solvers/pallas_admm.py`` (``PrepConsts``,
``prep_values``, ``solve_from_state`` -> ``_kernel_fused``). The kernel is
``csrc/fused.cu``: a prologue rebuilds the contact plan, the dynamics costs,
the kinematic CoM box and the warm starts of one problem from its ~40 floats
of compact state into the problem's shared-memory slice, then runs the ADMM
of ``csrc/admm_core.cuh`` (the code K1 runs, in K1's layout). This module
holds K3's plain version too: ``prep_values`` (the prologue in batched
PyTorch) followed by K1's plain ADMM.

Dispatch: tensors on the CPU go to the plain version; tensors on a CUDA
device go to the kernel, or the call raises.
"""

from __future__ import annotations

import dataclasses

import torch

from .._build import Kernel
from ..mpc.centroidal import ContactPlan
from ..mpc.gait import _mod
from . import cuda_admm

KERNEL = Kernel("fused")
NE = cuda_admm.NE
BIG = cuda_admm.BIG
_G = 9.81


@dataclasses.dataclass(frozen=True)
class PrepConsts:
    """Static per-(robot, gait) constants of the prologue (the fields of the
    JAX package's ``pallas_admm.PrepConsts``)."""

    gait_period: float
    gait_dt: float
    stance_percent: tuple  # (ne,)
    phase_offset: tuple  # (ne,)
    foot_size: float
    nom_ht: float
    ori_correction: tuple  # (3,)
    gait_horizon: float
    izz_yaw: float  # (I_comp @ e_z)[2]: the yaw-rate momentum coefficient
    W_X: tuple  # (9,)
    W_X_ter: tuple  # (9,)
    W_F: tuple  # (ne*3,)
    bx: float
    by: float
    bz: float
    warm_start_vdes: bool  # CyclicMpcSpec.warm_start_style == "vdes"
    f_reg_weight: bool  # BiconvexMotionParams.f_reg_style == "weight"

    def as_array(self) -> list:
        """The 52 doubles the kernel reads (csrc/fused.cu: make_prep)."""
        vals = [self.gait_period, self.gait_dt, *self.stance_percent, *self.phase_offset,
                self.foot_size, self.nom_ht, *self.ori_correction, self.gait_horizon,
                self.izz_yaw, *self.W_X, *self.W_X_ter, *self.W_F, self.bx, self.by, self.bz,
                float(self.warm_start_vdes), float(self.f_reg_weight)]
        if len(vals) != PREP_N:
            raise ValueError(f"PrepConsts for {NE} feet give {PREP_N} values, got {len(vals)}")
        return [float(v) for v in vals]


PREP_N = 52


def _assemble(t, vdes, wdes, x_init, ee, hip, amom, pc: PrepConsts, m, H, ne):
    """The prologue, batch-leading, in the inputs' dtype. Returns the plan
    (cnt, r, dt, swing as 0/1) and the problem with X_ref and F_reg (None for
    the pull-to-zero force regularization) in place of the linear costs."""
    dtype, device = t.dtype, t.device
    P, gdt = pc.gait_period, pc.gait_dt
    w, vx, vy = wdes, vdes[:, 0], vdes[:, 1]
    com = x_init[:, 0:3]

    # dt schedule with the shrunk first knot (abstract_cyclic_gen.py:385-390):
    # gdt - rint(mod(t, gdt) * 100) / 100. torch.round(decimals=2) divides by
    # 100 in the kernel; `/ 100.0` on a CUDA tensor multiplies by a rounded
    # reciprocal instead, which leaves gdt - dt0 a few 1e-9 off zero where the
    # clock sits on a knot, and the first knot degenerates
    dt0 = gdt - torch.round(_mod(t, gdt), decimals=2)
    dt0 = torch.where(dt0 == 0.0, torch.full_like(dt0, gdt), dt0)
    ki = torch.arange(H, dtype=dtype, device=device)
    dtarr = torch.where(ki == 0.0, dt0[:, None], torch.full_like(dt0[:, None], gdt))
    knot_t = t[:, None] + ki * gdt  # (B, H)

    # Raibert angular-step term (gait.create_cnt_plan)
    ang_c = 0.5 * torch.sqrt(com[:, 2] / _G)
    ang_step_x = ang_c * vy * w
    ang_step_y = -(ang_c * vx) * w
    cnt_l, swing_l, td_l, sw_l = [], [], [], []
    fs = torch.full_like(knot_t, pc.foot_size)
    for e in range(ne):
        st = pc.stance_percent[e] * P
        ph = _mod(knot_t + pc.phase_offset[e] * P, P)
        stance = ph <= st + 1e-4  # gait_planner.cpp:48-49 tolerance
        per = torch.where(stance, ph / st, (ph - st) / (P - st))
        hipx = com[:, 0, None] + hip[:, e, 0, None] + ki * gdt * vx[:, None]
        hipy = com[:, 1, None] + hip[:, e, 1, None] + ki * gdt * vy[:, None]
        rbx = 0.5 * vx * P * pc.stance_percent[e]
        rby = 0.5 * vy * P * pc.stance_percent[e]
        tdx = hipx + (rbx + ang_step_x)[:, None]
        tdy = hipy + (rby + ang_step_y)[:, None]
        early = per < 0.5
        swx = torch.where(early, hipx + ang_step_x[:, None], tdx)
        swy = torch.where(early, hipy + ang_step_y[:, None], tdy)
        cnt_e = stance.to(dtype)
        # swing via-point flag over the first half of swing, never on knot 0
        swing_l.append(((cnt_e == 0.0) & (per - 0.5 < 0.02) & (ki != 0.0)).to(dtype))
        cnt_l.append(cnt_e)
        td_l.append(torch.stack([tdx, tdy, fs], dim=-1))
        sw_l.append(torch.stack([swx, swy, fs], dim=-1))
    cnt = torch.stack(cnt_l, dim=-1)  # (B, H, ne)
    swing = torch.stack(swing_l, dim=-1)
    td = torch.stack(td_l, dim=-2)  # (B, H, ne, 3)
    sw = torch.stack(sw_l, dim=-2)

    # knot 0 keeps the measured foot positions; a foot in contact keeps the
    # location planned at its touchdown
    rows = [ee]
    for i in range(1, H):
        c = cnt[:, i, :, None]
        landed = c * (1.0 - cnt[:, i - 1, :, None])
        stay = torch.where(landed > 0.0, td[:, i], rows[-1])
        rows.append(torch.where(c > 0.0, stay, sw[:, i]))
    r = torch.stack(rows, dim=1)  # (B, H, ne, 3)

    # dynamics costs (kino_dyn._prepare_problem); the prefix sum of dt runs
    # in order, as the kernel's does
    acc = torch.zeros_like(dt0)
    cum_l = []
    for i in range(H):
        acc = acc + dtarr[:, i]
        cum_l.append(acc)
    cum = torch.stack(cum_l, dim=1)  # (B, H)
    xy_nom_x = com[:, 0, None] + vx[:, None] * (cum - dt0[:, None])
    xy_nom_y = com[:, 1, None] + vy[:, None] * (cum - dt0[:, None])
    oc = pc.ori_correction
    yaw_mom = pc.izz_yaw * w
    amom_z_nom = torch.where(w == 0.0, amom[:, 2] * oc[2], yaw_mom)
    ones = torch.ones_like(cum)
    X_nom = torch.stack(
        [xy_nom_x, xy_nom_y, pc.nom_ht * ones, vdes[:, 0, None] * ones,
         vdes[:, 1, None] * ones, vdes[:, 2, None] * ones, (amom[:, 0] * oc[0])[:, None] * ones,
         (amom[:, 1] * oc[1])[:, None] * ones, amom_z_nom[:, None] * ones],
        dim=-1,
    )  # (B, H, 9)
    hz = pc.gait_horizon * pc.gait_period
    X_ter = torch.stack(
        [com[:, 0] + hz * vdes[:, 0], com[:, 1] + hz * vdes[:, 1],
         torch.full_like(w, pc.nom_ht), vdes[:, 0], vdes[:, 1], vdes[:, 2], amom[:, 0],
         amom[:, 1], torch.where(w == 0.0, amom[:, 2], yaw_mom)],
        dim=-1,
    )
    X_ref = torch.cat([X_nom, X_ter[:, None]], dim=1)  # (B, H+1, 9)

    def const(vals, shape):
        return torch.as_tensor(vals, dtype=dtype, device=device).reshape(shape)

    B = t.shape[0]
    W = torch.cat([const(pc.W_X, (1, 9)).expand(H, 9), const(pc.W_X_ter, (1, 9))])
    W = W.expand(B, H + 1, 9).contiguous()
    WF = const(pc.W_F, (ne, 3)).expand(B, H, ne, 3).contiguous()
    if pc.f_reg_weight:
        n_act = torch.clamp_min(torch.sum(cnt, dim=-1), 1.0)  # (B, H)
        fz_ref = cnt * ((m * _G) / n_act)[..., None]
        zero = torch.zeros_like(fz_ref)
        F_reg = torch.stack([zero, zero, fz_ref], dim=-1)
    else:
        F_reg = None

    # kinematic CoM box (biconvex.kinematic_box_bounds), +-BIG where free
    any_cnt = (torch.sum(cnt, dim=-1) > 0.0)[..., None]
    big = torch.full_like(r[:, :, 0], BIG)
    lb = torch.full((B, H + 1, 9), -BIG, dtype=dtype, device=device)
    ub = torch.full((B, H + 1, 9), BIG, dtype=dtype, device=device)
    lb[:, :H, 0:3] = torch.where(any_cnt, torch.amax(r, dim=2) + const([-pc.bx, -pc.by, 0.0], 3),
                                 -big)
    ub[:, :H, 0:3] = torch.where(any_cnt, torch.amin(r, dim=2) + const([pc.bx, pc.by, pc.bz], 3),
                                 big)

    # warm starts (kino_dyn.cpp:83-99 tiled; the "vdes" ramp per spec)
    X0 = x_init[:, None, :].expand(B, H + 1, 9).clone()
    if pc.warm_start_vdes:
        tgrid = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)  # (B, H+1)
        X0[..., 0] = x_init[:, 0, None] + tgrid * vx[:, None]
        X0[..., 1] = x_init[:, 1, None] + tgrid * vy[:, None]
        X0[..., 3:6] = vdes[:, None, :]
    F0 = torch.zeros((B, H, ne, 3), dtype=dtype, device=device)
    return dict(cnt=cnt, r=r, dt=dtarr, swing=swing, W=W, X_ref=X_ref, WF=WF, F_reg=F_reg,
                lb=lb, ub=ub, X0=X0, F0=F0)


def prep_values(t, vdes, wdes, x_init, ee, hip, amom, *, pc: PrepConsts, m, H, ne):
    """K3's prologue as batched PyTorch (counterpart of
    ``pallas_admm.prep_values``, batch-leading, in the inputs' dtype).

    Inputs: t (B,), vdes (B, 3) world-frame v_des, wdes (B,), x_init (B, 9),
    ee (B, ne, 3) measured foot positions (origin-reset frame), hip (B, ne, 3)
    yaw-frame hip offsets, amom (B, 3) orientation-correction momentum.
    Returns (cnt, r, dt, swing, W, qlin, WF, qF, lb, ub, X0, F0)."""
    a = _assemble(t, vdes, wdes, x_init, ee, hip, amom, pc, m, H, ne)
    qlin = -2.0 * a["W"] * a["X_ref"]
    qF = torch.zeros_like(a["WF"]) if a["F_reg"] is None else -2.0 * a["WF"] * a["F_reg"]
    return (a["cnt"], a["r"], a["dt"], a["swing"], a["W"], qlin, a["WF"], qF, a["lb"], a["ub"],
            a["X0"], a["F0"])


def solve_from_state_plain(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc, cfg, H,
                           ne):
    """K3's plain version: ``prep_values`` followed by K1's plain ADMM. Same
    returns as ``solve_from_state``."""
    a = _assemble(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, pc, m, H, ne)
    plan = ContactPlan(cnt=a["cnt"], r=a["r"], dt=a["dt"])
    X, F, viol, iters = cuda_admm.solve_plain(
        plan, m, x_init, a["W"], a["X_ref"], a["WF"], a["X0"], a["F0"], (a["lb"], a["ub"]), cfg,
        a["F_reg"],
    )
    return X, F, viol, iters, a["cnt"], a["r"], a["dt"], a["swing"] > 0.5


_I, _D, _P = cuda_admm._I, cuda_admm._D, cuda_admm._P
ARGTYPES = [_I] * 9 + [_D] * 11 + [_P] * 18


def work_size(H: int) -> int:
    """Device-memory workspace elements per problem (csrc/fused.cu:
    fused_work_size): the prologue's touchdown and swing locations and its
    dt prefix sum. The rest of the problem lives in K1's shared-memory
    layout (``cuda_admm.shared_size``)."""
    return 4 * H * NE + H


def kernel_args(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc, cfg, H, ne):
    """Checked inputs, freshly allocated outputs and buffers, and the C
    argument list (without the launch configuration) of one kernel call.
    Returns ``(args, keep, outputs)``: ``keep`` holds every tensor the call
    points at, ``outputs`` is ``(X, F, viol, iters, cnt, r, dt, swing,
    fista_iters)`` with swing as 0/1 in the inputs' dtype."""
    cuda_admm._check_config(cfg)
    if ne != NE:
        raise ValueError(f"the fused kernel is built for {NE} feet, got {ne}")
    B = t.shape[0]
    dtype, device = x_init.dtype, x_init.device
    shapes = {"t": (t, (B,)), "v_des_w": (v_des_w, (B, 3)), "w_des": (w_des, (B,)),
              "x_init": (x_init, (B, 9)), "ee_pos": (ee_pos, (B, NE, 3)),
              "hip_world": (hip_world, (B, NE, 3)), "amom": (amom, (B, 3))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype or a.device != device:
            raise ValueError(f"{name}: {a.dtype} on {a.device}, expected {dtype} on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    consts = torch.tensor(pc.as_array(), dtype=torch.float64)  # host memory: read at launch
    outs = (empty(B, H + 1, 9), empty(B, H, NE, 3), empty(B), empty(B, dt=torch.int32),
            empty(B, H, NE), empty(B, H, NE, 3), empty(B, H), empty(B, H, NE),
            empty(B, dt=torch.int32))
    work = empty(B, work_size(H))
    ptrs = [t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, *outs, work]
    args = ([B] + cuda_admm.config_args(H, m, cfg) + [consts.data_ptr()]
            + [a.data_ptr() for a in ptrs])
    X, F, viol, iters, cnt, r, dt, swing, fista = outs
    return args, ptrs + [consts], (X, F, viol, iters, cnt, r, dt, swing, fista)


def _launch(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc, cfg, H, ne):
    if x_init.device.type != "cuda":
        raise ValueError(f"the fused kernel runs on a CUDA device, got {x_init.device}")
    if x_init.dtype != torch.float32:
        raise ValueError(f"the fused kernel takes float32, got {x_init.dtype}")
    per_block = cuda_admm.launch_per_block(H)
    args, keep, out = kernel_args(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc,
                                  cfg, H, ne)
    with torch.cuda.device(x_init.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("fused_launch_f32", args + [per_block, stream], ARGTYPES + [_I, _P])
    del keep
    return out


def fista_iterations(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc, cfg, H, ne):
    """F-step FISTA iterations the kernel runs per problem (B,), for measuring."""
    return _launch(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc, cfg, H, ne)[8]


def solve_from_state(
    t,  # (B,)
    v_des_w,  # (B, 3) desired CoM velocity, world frame
    w_des,  # (B,)
    x_init,  # (B, 9) current centroidal state
    ee_pos,  # (B, ne, 3) measured foot positions (origin-reset frame)
    hip_world,  # (B, ne, 3) yaw-frame hip offsets
    amom,  # (B, 3) orientation-correction angular momentum
    m: float,
    pc: PrepConsts,
    cfg: cuda_admm.CudaAdmmConfig,
    H: int,
    ne: int,
):
    """Problem assembly + ADMM from compact per-problem state: the
    centroidal solution and the contact plan the IK stage reads. Returns
    ``(X, F, viol, iters, cnt, r, dts, swing_mask)``, swing_mask boolean."""
    if x_init.device.type == "cpu":
        return solve_from_state_plain(t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc,
                                      cfg, H, ne)
    X, F, viol, iters, cnt, r, dt, swing, _ = _launch(
        t, v_des_w, w_des, x_init, ee_pos, hip_world, amom, m, pc, cfg, H, ne)
    return X, F, viol, iters, cnt, r, dt, swing > 0.5
