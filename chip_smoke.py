#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bunmpc_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``bunmpc_tpu_torch/csrc/`` (K1 the
ADMM, K2 the GN-DDP, K3 the fused problem assembly + ADMM), holds each kernel
and each of K1's branches against its plain PyTorch version on the card,
holds K1 against the committed native fixture, holds K1 and K2 at twice the
trot's horizons (the trot with ``gait_horizon=4.0``: ADMM H=40, IK H=20)
against their plain versions, and drives two paths of the
batched Solo12 trot MPC solve of ``bench.py`` (B=512, f32): the main path
``solve_mpc_batch(admm_backend="cuda", ik_backend="cuda")`` (K1, K2) and the
fused path with ``fuse_prep=True`` (K3, K2). It checks their outputs, counts
each kernel's launches in each path's run, times both, and prints one
``kernels`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Every phase fails the run (non-zero exit)
on a miss; without CUDA, or without the repository next to it, it exits
non-zero and prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 512
H100_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
H100_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def quantile_gate(name, a, b, q_tol=5e-3, max_tol=5e-2):
    d = (a - b).abs().flatten().double()
    q = float(np.quantile(d.cpu().numpy(), 0.999))
    mx = float(d.max())
    log(f"  {name}: |d| q0.999 {q:.3e} (< {q_tol}), max {mx:.3e} (< {max_tol})")
    check(q < q_tol and mx < max_tol, f"{name}: quantile gate missed (q {q:.3e}, max {mx:.3e})")
    return mx


def admm_ops(iters, fista_iters, H, cfg):
    """Arithmetic (f32 operations) the ADMM kernel performs on these inputs,
    counted from csrc/admm_core.cuh per problem: per ADMM iteration
    (power_iters+1) applications of the F operator (~260 ops per knot) with a
    norm, one Thomas sweep (~3,400 ops per knot: the 9x9 Cholesky on the
    lower triangle ~500, the 9x10 block solve ~1,800, the Schur update of the
    next block's lower triangle and right-hand side ~1,100) and the dual
    update (~150 ops per knot); per FISTA iteration one operator application,
    the step, the cone projection and the momentum update (~400 ops per
    knot)."""
    f_op = 260.0 * H
    per_admm = (cfg.power_iters + 1) * (f_op + 36.0 * H) + 3400.0 * (H + 1) + 150.0 * (H + 1)
    per_fista = f_op + 140.0 * H
    return float(iters.double().sum()) * per_admm + float(fista_iters.double().sum()) * per_fista


def ddp_ops(n_problems, H, cfg):
    """Arithmetic the DDP kernel performs (fixed work, no data dependence),
    counted from csrc/ddp.cu per problem and iteration: per knot of the
    backward sweep the kinematics (~3.5k ops), the 36-direction tangent pass
    (~60k), the Gauss-Newton products (~27k) and the block-structured Riccati
    step (~100k, most of it the 18x37 solve and the Kfb'Qux update); per knot
    of each alpha's rollout ~7k ops."""
    backward = (H + 1) * (3.5e3 + 60e3 + 27e3) + H * 100e3
    rollouts = len(cfg.alphas) * H * 7e3
    first = H * 7e3
    return n_problems * (first + cfg.n_iters * (backward + rollouts))


def prep_ops(n_problems, H):
    """Arithmetic of K3's prologue (csrc/fused.cu), counted per problem: per
    knot-foot pair the phase, contact flag, touchdown and swing point (~40
    ops), per knot and foot of the location carry ~10, per knot the costs,
    the box over the feet and the warm start (~100)."""
    return n_problems * (H * 4 * 40.0 + H * 4 * 10.0 + (H + 1) * 100.0)


def rows(a, n):
    """The first n problems of a tensor, a tuple of them or a ContactPlan."""
    if isinstance(a, tuple):
        return tuple(rows(x, n) for x in a)
    if hasattr(a, "cnt"):
        return type(a)(cnt=rows(a.cnt, n), r=rows(a.r, n), dt=rows(a.dt, n))
    return a[:n].contiguous() if hasattr(a, "contiguous") else a


def as_f64(a):
    """A tensor, a tuple of them or a ContactPlan in float64."""
    if isinstance(a, tuple):
        return tuple(as_f64(x) for x in a)
    if hasattr(a, "cnt"):
        return type(a)(cnt=as_f64(a.cnt), r=as_f64(a.r), dt=as_f64(a.dt))
    return a.double() if hasattr(a, "double") else a


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import bunmpc_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the repository (bunmpc_tpu_torch not found)",
              file=sys.stderr)
        return 1
    from bunmpc_tpu_torch import _build, workload
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused
    from bunmpc_tpu_torch.solvers.ddp import DdpConfig

    t_start = time.time()
    dev = torch.device("cuda")

    # ---- 1. device ----
    card = card_info()
    log(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build (every kernel, nvcc in parallel) ----
    t0 = time.time()
    reports = _build.build(["admm", "ddp", "fused"], force=True)
    build_s = time.time() - t0
    log(f"[2] build: {build_s:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"  {name}: {line.strip()}")

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0(), device="cuda")
    # the launch shape: a warp and a shared-memory slice per problem
    admm_shape = (cuda_admm.launch_per_block(spec.horizon), 4 * cuda_admm.shared_size(spec.horizon))
    ddp_shape = (cuda_ddp.launch_per_block(spec.ik_hor),
                 4 * cuda_ddp.shared_size(spec.ik_hor, model.nq, model.nv))
    for name, (pb, per_problem) in (("admm", admm_shape), ("fused", admm_shape),
                                    ("ddp", ddp_shape)):
        log(f"  {name}: {pb} problems ({pb * 32} threads) per block, {pb * per_problem} bytes "
            f"of shared memory per block ({per_problem} per problem)")
    inputs = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in workload.trot_states(B))
    prob = KD._prepare_problem(spec, *inputs)
    m = model.total_mass
    plan = prob["plan"]
    admm_in = (plan, m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"], prob["X_wm"],
               prob["F_wm"], prob["x_bounds"])
    bench_cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", fista_max_iters=30)

    # ---- 3. K1 against its plain version, on the card ----
    pinned = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", max_admm_iters=15,
                                      dual_relax=1.0, rho_growth=1.0)
    Xk, Fk, vk, _ = cuda_admm.solve(*admm_in, pinned)
    Xp, Fp, vp, _ = cuda_admm.solve_plain(*admm_in, pinned)
    torch.cuda.synchronize()
    dX, dF = float((Xk - Xp).abs().max()), float((Fk - Fp).abs().max())
    dv = float(((vk - vp).abs() / vp.abs().clamp_min(1e-30)).max())
    log(f"[3] K1 pinned (15 iters): |dX| {dX:.3e} (< 1e-4), |dF| {dF:.3e} (< 1e-3), "
        f"viol rel {dv:.3e} (< 1e-3)")
    check(dX < 1e-4 and dF < 1e-3 and dv < 1e-3, "K1 pinned case disagrees with its plain version")
    Xk, Fk, vk, itk = cuda_admm.solve(*admm_in, bench_cfg)
    Xp, Fp, vp, itp = cuda_admm.solve_plain(*admm_in, bench_cfg)
    torch.cuda.synchronize()
    log(f"[3] K1 bench config: iters kernel mean {itk.float().mean():.2f}, plain mean "
        f"{itp.float().mean():.2f}; problems with other iteration counts {(itk != itp).sum()}")
    k1_err = quantile_gate("K1 X", Xk, Xp)
    log(f"  K1 F: |d| max {float((Fk - Fp).abs().max()):.3e} (force scale "
        f"{float(Fp.abs().max()):.1f} N)")
    check(bool(torch.isfinite(Xk).all() and torch.isfinite(Fk).all()), "K1 output not finite")

    # ---- 3b. K1's other branches against the plain version run in f64 ----
    # 64 problems, 15 pinned iterations (reference schedule); the gates are
    # the JAX package's fista gates (tests/test_pallas_admm.py:69-72: X 5e-3,
    # F 2e-1, viol rel 1e-3), except viol rel 5e-3 for fista+precondition:
    # there the capped, preconditioned X-FISTA amplifies f32 rounding into
    # jumps on single problems, so an f32 run may land ~2.5e-3 from f64 on
    # these inputs whatever its code: the g++ build of the same kernel math
    # does (the card's build, which contracts into fused multiply-adds, lands
    # far closer), and so does the plain version at fista_max_iters 149
    sub = rows(admm_in, 64)
    sub64 = as_f64(sub)
    for name, kw, viol_tol in (("fista", dict(x_solver="fista"), 1e-3),
                               ("thomas+precondition", dict(precondition=True), 1e-3),
                               ("fista+precondition", dict(x_solver="fista", precondition=True),
                                5e-3)):
        cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, max_admm_iters=15, dual_relax=1.0,
                                       rho_growth=1.0, **kw)
        Xb, Fb, vb, _ = cuda_admm.solve(*sub, cfg)
        Xr, Fr, vr, _ = cuda_admm.solve_plain(*sub64, cfg)
        X3, _, v3, _ = cuda_admm.solve_plain(*sub, cfg)
        torch.cuda.synchronize()
        dX, dF = float((Xb.double() - Xr).abs().max()), float((Fb.double() - Fr).abs().max())
        dv = float(((vb.double() - vr).abs() / vr.abs().clamp_min(1e-30)).max())
        dv3 = float(((v3.double() - vr).abs() / vr.abs().clamp_min(1e-30)).max())
        log(f"[3b] K1 {name} (15 iters) vs plain f64: |dX| {dX:.3e} (< 5e-3), |dF| {dF:.3e} "
            f"(< 2e-1), viol rel {dv:.3e} (< {viol_tol}); plain f32 vs plain f64: |dX| "
            f"{float((X3.double() - Xr).abs().max()):.3e}, viol rel {dv3:.3e}")
        check(dX < 5e-3 and dF < 2e-1 and dv < viol_tol,
              f"K1 {name} disagrees with its plain version")
        check(bool(torch.isfinite(Xb).all() and torch.isfinite(Fb).all()), f"K1 {name} not finite")

    # ---- 4. K2 against its plain version, on the card ----
    # (a) one iteration, one alpha, on the random IK problems of the JAX
    # package's own kernel check (tests/test_pallas_ddp.py), at the main
    # path's shapes. The plain version runs in f64 on the same inputs: in f32
    # its own rounding (batched LAPACK Cholesky, forward-mode Jacobians) is
    # ~2e-4 on xs over 512 problems, about 100x the kernel's
    one = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    rnd_in = workload.random_ik_problems(model, spec.eff_frames, B, spec.ik_hor, dev)
    rnd_in64 = tuple(a.double() if torch.is_tensor(a) else a for a in rnd_in)
    xs_k, us_k, c_k = cuda_ddp.solve_ik_batch(*rnd_in, cfg=one)
    xs_p, us_p, c_p = cuda_ddp.solve_ik_batch_plain(*rnd_in64, cfg=one)
    torch.cuda.synchronize()
    dxs, dus = float((xs_k - xs_p).abs().max()), float((us_k - us_p).abs().max())
    dc = float(((c_k - c_p).abs() / c_p.abs()).max())
    log(f"[4] K2 one iteration (kernel f32 vs plain f64): |dxs| {dxs:.3e} (< 2e-4), "
        f"|dus| {dus:.3e} (< 2e-3), cost rel {dc:.3e} (< 1e-4)")
    check(dxs < 2e-4 and dus < 2e-3 and dc < 1e-4, "K2 single iteration disagrees")
    # (b) the full config on the main path's own IK problems (built from K1's
    # output); their weights span 1e-5..1e4, so f32 rounding moves both f32
    # solvers by up to ~1e-2 from the exact solution: the plain version runs
    # in f64 on the same inputs and the kernel (f32) is held to the quantile
    # gates
    tasks, x0 = KD._build_ik_tasks(spec, prob, Xk)
    w_stage, w_term, ctrl_w, x_reg = IK.dense_weights(model, spec.eff_frames, tasks)
    ddp_in = (model, spec.eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg,
              w_stage, w_term, ctrl_w, tasks.dts)
    ddp_in64 = tuple(a.double() if torch.is_tensor(a) else a for a in ddp_in)
    full = cuda_ddp.CudaDdpConfig()
    xs_k, us_k, c_k = cuda_ddp.solve_ik_batch(*ddp_in, cfg=full)
    xs_p, us_p, c_p = cuda_ddp.solve_ik_batch_plain(*ddp_in64, cfg=full)
    torch.cuda.synchronize()
    log("[4] K2 full config (kernel f32 vs plain f64):")
    k2_err = quantile_gate("K2 xs", xs_k.double(), xs_p)
    log(f"  K2 cost rel max {float(((c_k.double() - c_p).abs() / c_p.abs()).max()):.3e}")
    check(bool(torch.isfinite(xs_k).all()), "K2 output not finite")

    # ---- 5. K1 against the committed native fixture (reference schedule) ----
    fx = np.load(os.path.join(REPO, "tests", "fixtures", "solo12_trot_e2e.npz"))
    f32 = torch.float32

    def one_row(a):
        return torch.as_tensor(np.asarray(a, np.float64)[None], dtype=f32, device=dev)

    fprob = KD._prepare_problem(
        spec, one_row(fx["q"]), one_row(fx["v"]), one_row(float(fx["t"])),
        one_row(fx["v_des"]), one_row(float(fx["w_des"])),
    )
    fcfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", exit_tol=1e-5,
                                    max_admm_iters=500, dual_relax=1.0, rho_growth=1.0)
    Xf, Ff, vf, itf = cuda_admm.solve(
        fprob["plan"], m, fprob["x_init"], fprob["W"], fprob["X_ref"], fprob["W_F"],
        fprob["X_wm"], fprob["F_wm"], fprob["x_bounds"], fcfg,
    )
    torch.cuda.synchronize()
    fdX = float(np.abs(Xf[0].double().cpu().numpy() - fx["X_opt"]).max())
    fdF = float(np.abs(Ff[0].double().cpu().numpy() - fx["F_opt"]).max())
    log(f"[5] K1 vs native fixture: viol {float(vf[0]):.3e} (< 1e-4), iters {int(itf[0])}, "
        f"|dX| {fdX:.3e} (< 1e-3), |dF| {fdF:.3e} (< 5e-3)")
    check(float(vf[0]) < 1e-4 and fdX < 1e-3 and fdF < 5e-3, "K1 misses the native fixture")

    # ---- 5a. K1 and K2 at twice the trot's horizons, against their plain versions ----
    # the trot with gait_horizon=4.0, the longest Solo12 gait horizon of the
    # JAX package's motions: ADMM H=40 (fewer problems a block fit), IK H=20;
    # the gates of phases 3 and 4(a)
    spec2 = KD.make_cyclic_spec(model, dataclasses.replace(trot, gait_horizon=4.0),
                                Solo12Config.q0(), device="cuda")
    prob2 = KD._prepare_problem(spec2, *inputs)
    admm2 = (prob2["plan"], m, prob2["x_init"], prob2["W"], prob2["X_ref"], prob2["W_F"],
             prob2["X_wm"], prob2["F_wm"], prob2["x_bounds"])
    Xk, Fk, vk, _ = cuda_admm.solve(*admm2, pinned)
    Xp, Fp, vp, _ = cuda_admm.solve_plain(*admm2, pinned)
    torch.cuda.synchronize()
    dX, dF = float((Xk - Xp).abs().max()), float((Fk - Fp).abs().max())
    dv = float(((vk - vp).abs() / vp.abs().clamp_min(1e-30)).max())
    log(f"[5a] K1 at H={spec2.horizon} ({cuda_admm.launch_per_block(spec2.horizon)} problems a "
        f"block), pinned: |dX| {dX:.3e} (< 1e-4), |dF| {dF:.3e} (< 1e-3), viol rel {dv:.3e} "
        f"(< 1e-3)")
    check(dX < 1e-4 and dF < 1e-3 and dv < 1e-3, "K1 at the long horizon disagrees")
    rnd2 = workload.random_ik_problems(model, spec2.eff_frames, B, spec2.ik_hor, dev)
    rnd2_64 = tuple(a.double() if torch.is_tensor(a) else a for a in rnd2)
    xs_k, us_k, c_k = cuda_ddp.solve_ik_batch(*rnd2, cfg=one)
    xs_p, us_p, c_p = cuda_ddp.solve_ik_batch_plain(*rnd2_64, cfg=one)
    torch.cuda.synchronize()
    dxs, dus = float((xs_k - xs_p).abs().max()), float((us_k - us_p).abs().max())
    dc = float(((c_k - c_p).abs() / c_p.abs()).max())
    log(f"[5a] K2 at IK H={spec2.ik_hor} ({cuda_ddp.launch_per_block(spec2.ik_hor)} problems a "
        f"block), one iteration vs plain f64: |dxs| {dxs:.3e} (< 2e-4), |dus| {dus:.3e} "
        f"(< 2e-3), cost rel {dc:.3e} (< 1e-4)")
    check(dxs < 2e-4 and dus < 2e-3 and dc < 1e-4, "K2 at the long horizon disagrees")
    check(bool(torch.isfinite(Xk).all() and torch.isfinite(xs_k).all()),
          "long-horizon output not finite")

    # ---- 5b. K3 against its plain version, on the card ----
    H = spec.horizon
    pc = KD.make_prep_consts(spec)
    ci = KD._compact_inputs(spec, *inputs)
    k3_in = (ci[1], ci[2], inputs[4], ci[3], ci[4], ci[5], ci[6], m, pc)
    for name, cfg in (("pinned (15 iters)", pinned), ("bench config", bench_cfg)):
        K = cuda_fused.solve_from_state(*k3_in, cfg, H, spec.n_eff)
        P = cuda_fused.solve_from_state_plain(*k3_in, cfg, H, spec.n_eff)
        torch.cuda.synchronize()
        dr, ddt = float((K[5] - P[5]).abs().max()), float((K[6] - P[6]).abs().max())
        log(f"[5b] K3 {name}: cnt equal {torch.equal(K[4], P[4])}, swing equal "
            f"{torch.equal(K[7], P[7])}, |dr| {dr:.3e} (< 1e-5), |ddt| {ddt:.3e} (< 1e-5); "
            f"iters kernel mean {K[3].float().mean():.2f}, plain {P[3].float().mean():.2f}")
        check(torch.equal(K[4], P[4]) and torch.equal(K[7], P[7]), "K3 contact plan flags differ")
        check(dr < 1e-5 and ddt < 1e-5, "K3 contact locations or knot durations differ")
        check(bool(torch.isfinite(K[0]).all() and torch.isfinite(K[1]).all()), "K3 not finite")
        if cfg is pinned:
            dX, dF = float((K[0] - P[0]).abs().max()), float((K[1] - P[1]).abs().max())
            dv = float(((K[2] - P[2]).abs() / P[2].abs().clamp_min(1e-30)).max())
            log(f"  K3 pinned: |dX| {dX:.3e} (< 1e-4), |dF| {dF:.3e} (< 1e-3), viol rel "
                f"{dv:.3e} (< 1e-3)")
            check(dX < 1e-4 and dF < 1e-3 and dv < 1e-3, "K3 pinned case disagrees")
        else:
            k3_err = quantile_gate("K3 X", K[0], P[0])
            k3_iters = K[3]

    # ---- 6. the main path, end to end ----
    ddp_cfg = DdpConfig()

    def solve():
        return KD.solve_mpc_batch(spec, *inputs, admm_cfg=bench_cfg, ddp_cfg=ddp_cfg,
                                  admm_backend="cuda", ik_backend="cuda")

    kernels_of = {"admm": cuda_admm.KERNEL, "ddp": cuda_ddp.KERNEL, "fused": cuda_fused.KERNEL}

    def zero_counts():
        for k in kernels_of.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels_of.items()}

    zero_counts()
    plans = solve()
    torch.cuda.synchronize()
    launches = counts()
    log(f"[6] main path launches: {launches}")
    check(launches == {"admm": 1, "ddp": 1, "fused": 0}, "K1 and K2 must launch once per solve")
    expect = {"xs_int": (B, spec.n_int, 37), "us_int": (B, spec.n_int, 18),
              "f_int": (B, spec.n_int, 12), "X_opt": (B, 21, 9), "F_opt": (B, 20, 4, 3),
              "xs": (B, 11, 37), "us": (B, 10, 18)}
    for name, shape in expect.items():
        a = getattr(plans, name)
        check(tuple(a.shape) == shape, f"{name}: shape {tuple(a.shape)}, expected {shape}")
        check(bool(torch.isfinite(a).all()), f"{name}: not finite")
    conv = float((plans.dyn_violation < 1e-3).float().mean())
    log(f"[6] converged_frac {conv:.4f} (>= 0.99), admm iters mean "
        f"{plans.admm_iters.float().mean():.2f}")
    check(conv >= 0.99, "converged_frac below 0.99")
    # the whole path against the plain path in f64 on the first 64 problems
    sub = tuple(a[:64].double() for a in inputs)
    ref = KD.solve_mpc_batch(spec, *sub, admm_cfg=cuda_admm.plain_config(bench_cfg),
                             ddp_cfg=ddp_cfg, admm_backend="torch", ik_backend="torch")
    log("[6] main path vs plain path in f64 (64 problems):")
    quantile_gate("xs", plans.xs[:64].double(), ref.xs)
    quantile_gate("X_opt", plans.X_opt[:64].double(), ref.X_opt)

    # timed reps: host clock around work that ends in synchronize
    solve()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    check(cuda_admm.KERNEL.launches == 7 and cuda_ddp.KERNEL.launches == 7,
          "launch counters did not rise by one per solve")
    med = float(np.median(reps))

    # per-stage milliseconds by CUDA events (the stages of solve_mpc_batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    pr = KD._prepare_problem(spec, *inputs)
    ev[1].record()
    X, F, viol, iters = cuda_admm.solve(
        pr["plan"], m, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"], pr["X_wm"], pr["F_wm"],
        pr["x_bounds"], bench_cfg)
    ev[2].record()
    tk, x0s = KD._build_ik_tasks(spec, pr, X)
    ws, wt, cw, xr = IK.dense_weights(model, spec.eff_frames, tk)
    ev[3].record()
    ixs, ius, icost = cuda_ddp.solve_ik_batch(model, spec.eff_frames, x0s, tk.ee_targets,
                                              tk.com_ref, tk.mom_ref, xr, ws, wt, cw, tk.dts)
    ev[4].record()
    KD._finish_from_ik(spec, pr, X, F, viol, iters, ixs, ius, icost, torch.zeros_like(X))
    ev[5].record()
    torch.cuda.synchronize()
    stage_names = ["prep", "k1_admm", "ik_build", "k2_ddp", "interp"]
    stages = {n: round(ev[i].elapsed_time(ev[i + 1]), 3) for i, n in enumerate(stage_names)}
    log(json.dumps({
        "metric": "trot_mpc_solves_per_sec", "value": round(B / med, 1), "batch": B,
        "converged_frac": conv, "rep_times_s": [round(r, 5) for r in reps],
        "stage_ms": stages, "card": card,
    }))

    # ---- 6b. the fused path (fuse_prep=True: compact inputs, K3, IK, K2), end to end ----
    def solve_fused():
        return KD.solve_mpc_batch(spec, *inputs, admm_cfg=bench_cfg, ddp_cfg=ddp_cfg,
                                  admm_backend="cuda", ik_backend="cuda", fuse_prep=True)

    zero_counts()
    fplans = solve_fused()
    torch.cuda.synchronize()
    launches = counts()
    log(f"[6b] fused path launches: {launches}")
    check(launches == {"admm": 0, "ddp": 1, "fused": 1}, "K3 and K2 must launch once per solve")
    for name, shape in expect.items():
        a = getattr(fplans, name)
        check(tuple(a.shape) == shape, f"fused {name}: shape {tuple(a.shape)}, expected {shape}")
        check(bool(torch.isfinite(a).all()), f"fused {name}: not finite")
    fconv = float((fplans.dyn_violation < 1e-3).float().mean())
    log(f"[6b] converged_frac {fconv:.4f} (>= 0.99), admm iters mean "
        f"{fplans.admm_iters.float().mean():.2f}")
    check(fconv >= 0.99, "fused path converged_frac below 0.99")
    log(f"[6b] fused path vs the main path (both on the kernels, {B} problems):")
    quantile_gate("xs", fplans.xs, plans.xs)
    quantile_gate("X_opt", fplans.X_opt, plans.X_opt)
    solve_fused()
    torch.cuda.synchronize()
    freps = []
    for _ in range(5):
        t0 = time.perf_counter()
        solve_fused()
        torch.cuda.synchronize()
        freps.append(time.perf_counter() - t0)
    fmed = float(np.median(freps))
    ev[0].record()
    qr, t_, vdw, x_init, ee, hip, amom = KD._compact_inputs(spec, *inputs)
    ev[1].record()
    X, F, viol, iters, cnt, r, dts, swing = cuda_fused.solve_from_state(
        t_, vdw, inputs[4], x_init, ee, hip, amom, m, pc, bench_cfg, H, spec.n_eff)
    ev[2].record()
    fpr = dict(q=qr, v=inputs[1], x_init=x_init, plan=type(plan)(cnt=cnt, r=r, dt=dts),
               swing_mask=swing)
    tk, x0s = KD._build_ik_tasks(spec, fpr, X)
    ws, wt, cw, xr = IK.dense_weights(model, spec.eff_frames, tk)
    ev[3].record()
    ixs, ius, icost = cuda_ddp.solve_ik_batch(model, spec.eff_frames, x0s, tk.ee_targets,
                                              tk.com_ref, tk.mom_ref, xr, ws, wt, cw, tk.dts)
    ev[4].record()
    KD._finish_from_ik(spec, fpr, X, F, viol, iters, ixs, ius, icost, torch.zeros_like(X))
    ev[5].record()
    torch.cuda.synchronize()
    fstage_names = ["compact", "k3", "ik_build", "k2_ddp", "interp"]
    fstages = {n: round(ev[i].elapsed_time(ev[i + 1]), 3) for i, n in enumerate(fstage_names)}
    log(json.dumps({
        "metric": "fused_trot_mpc_solves_per_sec", "value": round(B / fmed, 1), "batch": B,
        "converged_frac": fconv, "rep_times_s": [round(r, 5) for r in freps],
        "stage_ms": fstages, "card": card,
    }))

    # ---- 7. the kernels line ----
    zero_counts()
    solve()
    torch.cuda.synchronize()
    main_launches = counts()
    check(main_launches == {"admm": 1, "ddp": 1, "fused": 0}, "main path launches")
    zero_counts()
    solve_fused()
    torch.cuda.synchronize()
    fused_launches = counts()
    check(fused_launches == {"admm": 0, "ddp": 1, "fused": 1}, "fused path launches")

    k1_ms = cuda_ms(torch, lambda: cuda_admm.solve(*admm_in, bench_cfg), 5)
    k1_plain_ms = cuda_ms(torch, lambda: cuda_admm.solve_plain(*admm_in, bench_cfg), 1)
    k3_ms = cuda_ms(torch, lambda: cuda_fused.solve_from_state(*k3_in, bench_cfg, H, 4), 5)
    k3_plain_ms = cuda_ms(
        torch, lambda: cuda_fused.solve_from_state_plain(*k3_in, bench_cfg, H, 4), 1)
    k2_ms = cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch(*ddp_in, cfg=full), 3)
    k2_plain_ms = cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch_plain(*ddp_in, cfg=full), 1)
    Hik = spec.ik_hor
    fista_total = cuda_admm.fista_iterations(*admm_in, bench_cfg)
    k3_fista = cuda_fused.fista_iterations(*k3_in, bench_cfg, H, 4)
    log(f"[7] K1 work per problem: ADMM iterations mean {itk.float().mean():.2f}, F-step FISTA "
        f"iterations mean {fista_total.float().mean():.2f}")
    # K1 reads cnt, r, dt, x_init, W, q, W_F, qF, lb, ub, X_wm, F_wm and
    # writes X, F, viol, iters (f32/int32)
    nXk, nFk = (H + 1) * 9, H * 12
    k1_bytes = 4.0 * B * (H * 4 + nFk + H + 9 + 5 * nXk + 3 * nFk + nXk + nFk + 2)
    k1_bound, k1_by = bound_ms(k1_bytes, admm_ops(itk, fista_total, H, bench_cfg))
    # K3 reads t, v_des_w, w_des, x_init, ee, hip, amom (41 floats) and
    # writes X, F, viol, iters, cnt, r, dt, swing
    k3_bytes = 4.0 * B * (41 + nXk + nFk + 2 + H * 4 + nFk + H + H * 4)
    k3_bound, k3_by = bound_ms(
        k3_bytes, admm_ops(k3_iters, k3_fista, H, bench_cfg) + prep_ops(B, H))
    nx, nv = 37, 18
    k2_bytes = 4.0 * B * (nx + Hik * 12 + (Hik + 1) * (3 + 6 + nx) + Hik * 57 + 45 + Hik * nv
                          + Hik + (Hik + 1) * nx + Hik * nv + 1)
    k2_bound, k2_by = bound_ms(k2_bytes, ddp_ops(B, Hik, full))
    kernels = [
        {"name": "admm", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/admm.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_admm.py:589", "launches": main_launches["admm"],
         "max_abs_err": k1_err, "ms": round(k1_ms, 4), "plain_ms": round(k1_plain_ms, 4),
         "bound_ms": round(k1_bound, 6), "bound_by": k1_by, "library_ms": None},
        {"name": "ddp", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/ddp.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_ddp.py:1046", "launches": main_launches["ddp"],
         "max_abs_err": k2_err, "ms": round(k2_ms, 4), "plain_ms": round(k2_plain_ms, 4),
         "bound_ms": round(k2_bound, 6), "bound_by": k2_by, "library_ms": None},
        {"name": "fused", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/fused.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_admm.py:1028",
         "launches": fused_launches["fused"], "max_abs_err": k3_err, "ms": round(k3_ms, 4),
         "plain_ms": round(k3_plain_ms, 4), "bound_ms": round(k3_bound, 6), "bound_by": k3_by,
         "library_ms": None},
    ]
    log(f"[7] total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
