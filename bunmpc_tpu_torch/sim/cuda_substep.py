"""K4: the closed loop's 1 ms substep as a hand-written CUDA kernel.

``rollout._substep`` (the ID controller, the physics step, the failure
predicate and the records of every episode) in one launch: the kernel is
``csrc/substep.cu`` (a warp and a slice of the block's shared memory per
episode; its header gives the design and what bounds it). It replaces no
TPU kernel: the JAX package writes the substep in plain jnp.

``Launch`` binds the kernel to one ``rollout_mpc`` call's buffers: it checks
them and packs the model, the per-episode parameters and the options onto
the device once, before the substep's CUDA graph is captured; each call then
launches one substep, which reads the substep ``b.i`` and the step ``b.k``
on the device and advances them. The plain version is ``rollout._substep``,
which ``rollout_mpc`` runs on a CPU tensor; on a CUDA tensor it builds a
``Launch``, which raises where the kernel does not take the buffers (no
fallback). The kernel is built for each joint count of ``JOINT_COUNTS`` (12:
Solo12 and the Go2; 8: Solo8) from one source, a library each (``KERNELS``,
which count their launches), float32 only.

``kernel_args`` is the packing itself, shared with the CPU tests, which run
the g++ build of the same per-episode math (``_build.build_host``) in f64 on
CPU buffers against the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._build import Kernel
from ..solvers import cuda_ddp

JOINT_COUNTS = cuda_ddp.JOINT_COUNTS  # K4 takes the robots K2 takes
KERNELS = {nj: Kernel("substep", defines=(f"BK_SUB_NJ={nj}",)) for nj in JOINT_COUNTS}
PER_BLOCK = 4  # episodes per thread block
DEFAULT_SMEM = 48 * 1024  # a block's shared memory without an opt-in
NE = 4

# the argument arrays, in csrc/substep.cu's orders (enums A_*, S_*, I_*, PR_*)
PTRS = ("model", "gait", "params", "q", "v", "q_noise", "v_noise", "xs", "us", "fi", "failed",
        "mpc_bad", "fail_step", "sim_t", "prev_cnt", "push", "v_des", "w_des", "heights",
        "swing", "gate", "leg_mask", "i", "k", "done", "states", "actions", "vc", "base", "com",
        "cf", "cp", "in_contact")
SCALARS = ("dt", "sim_dt", "act_kp", "act_kd", "gait_id", "fail_after", "fail_angle",
           "goal_period", "gait_period", "origin_x", "origin_y", "cell")
INTS = ("B", "T", "n_int", "action", "push_stride", "hn", "hm")
PARAMS = ("foot_radius", "kn", "dn", "mu", "kt", "joint_damping", "torque_limit", "kp", "kd",
          "step0")
ACTIONS = ("torque", "pd_target", "structured")

_I = ctypes.c_int
_P = ctypes.c_void_p
ARGTYPES = [_I, _P, _P, _P]  # nj, pointers, scalars, ints
LAUNCH_ARGTYPES = ARGTYPES + [_I, _P]  # + episodes a block, stream


def work_size(nj: int) -> int:
    """Shared-memory elements an episode takes (csrc/substep.cu: W_N)."""
    nb, nq, nv, nc = nj + 1, nj + 7, nj + 6, 3 * NE
    kin, der = 18 * nb, 12 * nb + 3 * nj
    return (2 * (nq + nv) + nq + 2 * nv + nc + 3 * kin + 2 * der + nv * nv + nv
            + nv * (1 + nc) + nc * nv + NE * nv + 2 * nv + 2 * nj + nc + 2 * NE + nc
            + nv + nc * nc + 2 * nc + nv)


def per_block(nj: int) -> int:
    """Episodes a block: PER_BLOCK, or as many as 48 KB of shared memory hold
    (the launch opts into no more)."""
    return max(1, min(PER_BLOCK, DEFAULT_SMEM // (4 * work_size(nj))))


def substep_ops(nj: int) -> int:
    """Floating-point operations of one episode's substep, counted from the
    algorithms' shapes (each multiply-add two): three kinematic passes, the
    derived inertias, nv + 2 RNEAs, the Jacobians, the Cholesky factor, the
    two triangular solves of 1 + 3 n_eff right-hand sides, G, the LU solve and
    the step. A bound's numerator, not a count of the kernel's instructions."""
    nb, nv, nc = nj + 1, nj + 6, 3 * NE
    kin = nj * (2 * 54 + 18 + 18) + 2 * nj * 18 + 40  # FK and body velocities
    der = nb * (18 + 2 * 45) + nj * 15
    rnea = nj * 60 + nb * 70 + nb * 20 + nj * 5 + 30
    jac = NE * nv * 6
    chol = nv ** 3 // 3
    solves = 2 * nv * nv * (1 + nc)
    contact = 2 * nc * nc * nv + 2 * nc * nv + 2 * nc ** 3 // 3 + nc * nc
    step = 2 * nv * nc + 120
    return 3 * kin + 2 * der + (nv + 2) * rnea + 2 * jac + chol + solves + contact + step


def substep_bytes(nj: int, action_type: str = "pd_target") -> int:
    """Bytes one episode's substep reads and writes in float32: the state
    (read and written), the plan's row, the parameters and the records."""
    nq, nv, nc = nj + 7, nj + 6, 3 * NE
    n_act = 3 * nj if action_type == "structured" else nj
    floats = (2 * (nq + nv) + (nq + nv) + nv + nc + len(PARAMS) + 1 + 4
              + (nv + 2 * NE + nq - 2) + n_act + 5 + 3 + 3 + 2 * nc)
    return 4 * floats + 3 + 2 * NE + 4


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"K4: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"K4: {name} is {t.dtype} on {t.device}, expected {dtype} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"K4: {name} must be contiguous")


def kernel_args(spec, sim_params, cfg, gains, v_des, w_des, step0, push, opts, b):
    """The kernel's three argument arrays for ``rollout._substep``'s
    arguments, on ``b``'s device and dtype, after checking every buffer's
    shape, dtype, device and contiguity (ValueError otherwise). Returns
    ``(nj, ptrs, scalars, ints, keep)``: ``keep`` holds the tensors the
    pointers point into."""
    model, eff = spec.model, tuple(spec.eff_frames)
    cuda_ddp.check_model(model, eff)  # K2's joint counts and trees are K4's
    nj, nq, nv = model.n_joints, model.nq, model.nv
    if cfg.action_type not in ACTIONS:
        raise ValueError(f"unsupported action_type {cfg.action_type!r}")
    q = b.q
    dtype, device = q.dtype, q.device
    B, T = q.shape[0], b.states.shape[1]
    n_int = b.xs_int.shape[1]
    n_act = nj * (3 if cfg.action_type == "structured" else 1)
    f, boolean, i32, i64 = dtype, torch.bool, torch.int32, torch.int64
    for name, shape, dt in (
            ("q", (B, nq), f), ("v", (B, nv), f), ("failed", (B,), boolean),
            ("fail_step", (B,), i32), ("i", (), i64), ("k", (), i64), ("sim_t", (B,), f),
            ("prev_cnt", (B, NE), boolean), ("xs_int", (B, n_int, nq + nv), f),
            ("us_int", (B, n_int, nv), f), ("f_int", (B, n_int, 3 * NE), f),
            ("mpc_bad", (B,), boolean), ("states", (B, T, nv + 2 * NE + nq - 2), f),
            ("actions", (B, T, n_act), f), ("vc_goals", (B, T, 5), f), ("base", (B, T, 3), f),
            ("com", (B, T, 3), f), ("contact_forces", (B, T, NE, 3), f),
            ("contact_pos", (B, T, NE, 3), f), ("in_contact", (B, T, NE), boolean)):
        _check(name, getattr(b, name), shape, dt, device)

    def column(x):  # a float or a (B,) tensor as a (B,) tensor
        return torch.as_tensor(x, dtype=dtype, device=device).expand(B)

    cp = sim_params.contact
    params = torch.stack([column(x) for x in (
        cp.foot_radius, cp.kn, cp.dn, cp.mu, cp.kt, sim_params.joint_damping,
        sim_params.torque_limit, gains.kp, gains.kd, step0)], dim=1).contiguous()
    gait = torch.as_tensor(tuple(spec.gait.phase_offset) + tuple(spec.gait.stance_percent),
                           dtype=dtype).to(device)
    mbuf = torch.as_tensor(cuda_ddp.pack_model(model, eff), dtype=dtype).to(device)
    inputs = {"v_des": (v_des, (B, 3)), "w_des": (w_des, (B,))}
    if opts.q_noise is not None:
        inputs["q_noise"] = (opts.q_noise, (B, nq))
    if opts.v_noise is not None:
        inputs["v_noise"] = (opts.v_noise, (B, nv))
    if opts.force_gate is not None:
        inputs["gate"] = (opts.force_gate, (B,))
    if opts.swing_blend is not None:
        inputs["swing"] = (column(opts.swing_blend), (B,))
        inputs["leg_mask"] = (opts.leg_mask, (NE, nj))
    terrain = opts.terrain
    if terrain is not None:
        inputs["heights"] = (terrain.heights, tuple(terrain.heights.shape))
    ptr = {}
    for name, (t, shape) in inputs.items():
        t = torch.as_tensor(t).contiguous()
        _check(name, t, shape, dtype, device)
        ptr[name] = t
    push_stride = 0
    if push is not None:
        if push.dim() != 3 or push.shape[0] != B or push.shape[1] < T or push.shape[2] != 3:
            raise ValueError(f"K4: push has shape {tuple(push.shape)}, expected ({B}, >= {T}, 3)")
        if push.dtype != dtype or push.device != device or push.stride()[1:] != (3, 1):
            raise ValueError("K4: push must be a (B, T, 3) tensor of the state's dtype and device "
                             "with rows of 3 contiguous values")
        push_stride = push.stride(0)
        ptr["push"] = push
    ptr.update(model=mbuf, gait=gait, params=params, q=b.q, v=b.v, xs=b.xs_int, us=b.us_int,
               fi=b.f_int, failed=b.failed, mpc_bad=b.mpc_bad, fail_step=b.fail_step,
               sim_t=b.sim_t, prev_cnt=b.prev_cnt, i=b.i, k=b.k,
               done=torch.zeros(1, dtype=i32, device=device), states=b.states,
               actions=b.actions, vc=b.vc_goals, base=b.base, com=b.com, cf=b.contact_forces,
               cp=b.contact_pos, in_contact=b.in_contact)
    # k > gait_period / sim_dt: a comparison PyTorch makes in its default dtype
    fail_after = float(torch.tensor(cfg.gait_period / cfg.sim_dt, dtype=torch.get_default_dtype()))
    scal = dict(dt=sim_params.dt, sim_dt=cfg.sim_dt, act_kp=cfg.kp, act_kd=cfg.kd,
                gait_id=cfg.gait_id, fail_after=fail_after,
                fail_angle=math.radians(cfg.fail_angle_deg), goal_period=cfg.gait_period,
                gait_period=spec.gait.gait_period,
                origin_x=float(terrain.origin[0]) if terrain is not None else 0.0,
                origin_y=float(terrain.origin[1]) if terrain is not None else 0.0,
                cell=float(terrain.cell) if terrain is not None else 1.0)
    hn, hm = tuple(terrain.heights.shape) if terrain is not None else (0, 0)
    ints = dict(B=B, T=T, n_int=n_int, action=ACTIONS.index(cfg.action_type),
                push_stride=push_stride, hn=hn, hm=hm)
    ptrs = (ctypes.c_void_p * len(PTRS))(*[ptr[n].data_ptr() if n in ptr else None for n in PTRS])
    scalars = (ctypes.c_double * len(SCALARS))(*[float(scal[n]) for n in SCALARS])
    ints_c = (ctypes.c_int * len(INTS))(*[int(ints[n]) for n in INTS])
    return nj, ptrs, scalars, ints_c, list(ptr.values())


class Launch:
    """K4 bound to one rollout's buffers (``rollout._substep``'s arguments):
    checked and packed once, here; each call launches one substep of every
    episode on the current stream. Raises ValueError where the kernel does
    not take the buffers: not on a CUDA device, not float32, a shape, dtype
    or layout it does not read, a robot it is not built for."""

    def __init__(self, spec, sim_params, cfg, gains, v_des, w_des, step0, push, opts, b):
        device = b.q.device
        if device.type != "cuda":
            raise ValueError(f"K4 runs on a CUDA device, not {device}")
        if b.q.dtype != torch.float32:
            raise ValueError(f"K4 takes float32, got {b.q.dtype}")
        self.device = device
        self.nj, self.ptrs, self.scalars, self.ints, self.keep = kernel_args(
            spec, sim_params, cfg, gains, v_des, w_des, step0, push, opts, b)
        self.per_block = per_block(self.nj)

    def __call__(self, *_):
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            KERNELS[self.nj].launch(
                "substep_launch_f32",
                [self.nj, ctypes.addressof(self.ptrs), ctypes.addressof(self.scalars),
                 ctypes.addressof(self.ints), self.per_block, stream], LAUNCH_ARGTYPES)
