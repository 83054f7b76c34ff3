"""K2: the batched kinematic Gauss-Newton DDP (the IK) as a hand-written CUDA
kernel.

Counterpart of ``bunmpc_tpu/solvers/pallas_ddp.py`` (``solve_ik_batch`` ->
``_build_kernel(...).kernel``); the kernel is ``csrc/ddp.cu`` (a warp and a
slice of the block's shared memory per problem, see its header for the
design and what bounds it). ``solve_ik_batch`` takes a batch of any size B
(no padding) and any horizon whose problem fits a block's shared memory
(``launch_per_block``; past that it raises).

The robot constants (joint frames, axes, masses, CoMs, inertias, foot frames)
reach the kernel as one small argument buffer packed from the port's
``RobotModel`` by ``pack_model``.

Dispatch: tensors on the CPU go to the plain version (``mpc/ik.py`` +
``solvers/ddp.py``); tensors on a CUDA device go to the kernel, or the call
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._build import Kernel, fit_per_block
from ..mpc import ik
from ..robots.model import RobotModel
from . import ddp

KERNEL = Kernel("ddp")
NJ, NE = 12, 4  # joints and feet the kernel is built for
PER_BLOCK = 4  # problems per thread block, where their shared memory fits
MAX_ALPHAS = 8


@dataclasses.dataclass(frozen=True)
class CudaDdpConfig:
    """The fields and defaults of ``PallasDdpConfig`` (without ``interpret``)."""

    n_iters: int = 6
    alphas: tuple = (1.0, 0.7, 0.3, 0.1, 0.03)
    reg: float = 1e-9


def pack_model(model: RobotModel, eff_frames) -> np.ndarray:
    """The kernel's model buffer (float64; the wrapper casts it): parent[nj],
    joint_rot[nj,3,3], joint_pos[nj,3], axis[nj,3], mass[nb], com[nb,3],
    inertia[nb,3,3], foot_body[ne], foot_pos[ne,3], total_mass — the layout
    ``ModelView`` in csrc/ddp.cu reads."""
    if model.n_joints != NJ or len(eff_frames) != NE:
        raise ValueError(f"the DDP kernel is built for {NJ} joints and {NE} feet")
    if any(int(p) not in (0, j) for j, p in enumerate(model.parent)):
        raise ValueError("the DDP kernel is built for chains off the base: joint j's parent "
                         "body must be the base (0) or body j")
    feet = [model.frames[n] for n in eff_frames]
    parts = [
        np.asarray(model.parent, np.float64),
        model.joint_rot, model.joint_pos, model.axis, model.mass, model.com, model.inertia,
        np.array([f.body for f in feet], np.float64),
        np.stack([f.pos for f in feet]),
        np.array([model.total_mass]),
    ]
    return np.concatenate([np.asarray(p, np.float64).reshape(-1) for p in parts])


def _plain_cfg(cfg: CudaDdpConfig) -> ddp.DdpConfig:
    return ddp.DdpConfig(n_iters=cfg.n_iters, alphas=tuple(cfg.alphas), reg=cfg.reg)


def solve_ik_batch_plain(model, eff_frames, x0, ee_targets, com_ref, mom_ref, x_reg,
                         w_stage, w_term, ctrl_weight, dts, cfg=CudaDdpConfig()):
    """K2's plain version: the batched PyTorch GN-DDP, same returns as
    ``solve_ik_batch``."""
    res = ik.solve_dense(model, eff_frames, x0, ee_targets, com_ref, mom_ref, x_reg,
                         w_stage, w_term, ctrl_weight, dts, _plain_cfg(cfg))
    return res.xs, res.us, res.cost


_I = ctypes.c_int
_D = ctypes.c_double
_P = ctypes.c_void_p
ARGTYPES = [_I, _I, _I, _I, _D] + [_P] * 15


def scratch_size(H: int, nq: int, nv: int) -> int:
    """Device-memory scratch elements per problem (csrc/ddp.cu:
    ddp_scratch_size): the alphas' candidate trajectories, and per knot a
    record of its FK cache, residual, B6 and step blocks."""
    nb, ndx = NJ + 1, 2 * nv
    kin = 36 * nb + 6 * NJ + 9  # csrc/ddp.cu: Kin
    return MAX_ALPHAS * ((H + 1) * (nq + nv) + H * nv) + (H + 1) * (kin + 3 * NE + 9 + ndx + 108)


def shared_size(H: int, nq: int, nv: int) -> int:
    """Shared-memory elements per problem (csrc/ddp.cu: ddp_layout): the
    trajectory and gains, the current knot's Gauss-Newton data, the Riccati
    matrices, the union of the knot's FK cache and rows with the step's
    products, the rollouts' knot costs, and the staged inputs."""
    nx, ndx = nq + nv, 2 * nv
    nr, nrt = 3 * NE + 9 + ndx, 9 + ndx
    work = ((H + 1) * nx + 2 * H * nv + H * nv * ndx  # xs, us, kff, Kfb
            + ndx + ndx * ndx + 72  # Lx, Qxx, Fb
            + 2 * ndx + ndx * ndx + nv + ndx * nv + 2 * nv * nv  # Vx, Vxx, Qx, Qu, Qux, Quu, Lc
            + ndx * ndx + MAX_ALPHAS * (H + 1))  # U, kc
    inputs = nx + H * NE * 3 + (H + 1) * (3 + 6 + nx) + H * nr + nrt + H * nv + H
    return work + inputs


def launch_per_block(H: int, nq: int = 19, nv: int = 18) -> int:
    """Problems per block at horizon H: PER_BLOCK, or as many as the
    block's shared memory holds; raises ValueError if one does not fit."""
    return fit_per_block("the DDP kernel", 4 * shared_size(H, nq, nv), PER_BLOCK, f"H={H}")


def kernel_args(model, eff_frames, x0, ee_targets, com_ref, mom_ref, x_reg, w_stage,
                w_term, ctrl_weight, dts, cfg):
    """Checked inputs, freshly allocated outputs/scratch, and the C argument
    list (without the launch configuration). Returns ``(args, keep, outputs)``."""
    B, H = dts.shape
    nq, nv = model.nq, model.nv
    nx, ndx = nq + nv, 2 * nv
    nr, nrt = 3 * NE + 9 + ndx, 9 + ndx
    if len(cfg.alphas) > MAX_ALPHAS or len(cfg.alphas) == 0:
        raise ValueError(f"1..{MAX_ALPHAS} line-search alphas supported, got {len(cfg.alphas)}")
    dtype, device = x0.dtype, x0.device
    shapes = {
        "x0": (x0, (B, nx)), "ee_targets": (ee_targets, (B, H, NE, 3)),
        "com_ref": (com_ref, (B, H + 1, 3)), "mom_ref": (mom_ref, (B, H + 1, 6)),
        "x_reg": (x_reg, (B, H + 1, nx)), "w_stage": (w_stage, (B, H, nr)),
        "w_term": (w_term, (B, nrt)), "ctrl_weight": (ctrl_weight, (B, H, nv)),
        "dts": (dts, (B, H)),
    }
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype or a.device != device:
            raise ValueError(f"{name}: {a.dtype} on {a.device}, expected {dtype} on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    mbuf = torch.as_tensor(pack_model(model, eff_frames), dtype=dtype).to(device)
    alphas = torch.as_tensor(cfg.alphas, dtype=dtype).to(device)
    xs = torch.empty((B, H + 1, nx), dtype=dtype, device=device)
    us = torch.empty((B, H, nv), dtype=dtype, device=device)
    cost = torch.empty((B,), dtype=dtype, device=device)
    scratch = torch.empty((B, scratch_size(H, nq, nv)), dtype=dtype, device=device)
    ptrs = [mbuf, alphas, x0, ee_targets, com_ref, mom_ref, x_reg, w_stage, w_term,
            ctrl_weight, dts, xs, us, cost, scratch]
    args = [B, H, cfg.n_iters, len(cfg.alphas), cfg.reg] + [t.data_ptr() for t in ptrs]
    return args, ptrs, (xs, us, cost)


def solve_ik_batch(
    model: RobotModel,
    eff_frames,
    x0,  # (B, nq+nv)
    ee_targets,  # (B, H, ne, 3)
    com_ref,  # (B, H+1, 3)
    mom_ref,  # (B, H+1, 6)
    x_reg,  # (B, H+1, nq+nv)
    w_stage,  # (B, H, nr) stage residual weights
    w_term,  # (B, nrt)
    ctrl_weight,  # (B, H, nv)
    dts,  # (B, H)
    cfg: CudaDdpConfig = CudaDdpConfig(),
):
    """Batched kinematic GN-DDP. Returns ``(xs (B, H+1, nq+nv), us (B, H, nv),
    cost (B,))``."""
    if x0.device.type == "cpu":
        return solve_ik_batch_plain(model, eff_frames, x0, ee_targets, com_ref, mom_ref,
                                    x_reg, w_stage, w_term, ctrl_weight, dts, cfg)
    if x0.device.type != "cuda":
        raise ValueError(f"cuda_ddp.solve_ik_batch: unsupported device {x0.device}")
    if x0.dtype != torch.float32:
        raise ValueError(f"the DDP kernel takes float32, got {x0.dtype}")
    per_block = launch_per_block(dts.shape[1], model.nq, model.nv)
    args, keep, out = kernel_args(model, eff_frames, x0, ee_targets, com_ref, mom_ref, x_reg,
                                  w_stage, w_term, ctrl_weight, dts, cfg)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("ddp_launch_f32", args + [per_block, stream], ARGTYPES + [_I, _P])
    del keep
    return out
