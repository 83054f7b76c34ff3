"""Time the hand-written kernels on the card at the main path's inputs.

    python -m bunmpc_tpu_torch.profile_kernels [--batch 512] [--reps 5]
        [--per-block 1 2 4 8] [--phases]

Builds K1 (csrc/admm.cu), K2 (csrc/ddp.cu) and K3 (csrc/fused.cu), assembles
bench.py's Solo12 trot problems (rng seed 0) at the given batch (and, for K2
built for 8 joints, "ddp8", the same recipe on the Solo8's trot), and times
each kernel by CUDA events for every block size in ``--per-block`` (problems
per thread block, a warp each; a size whose shared memory does not fit is
reported as refused; the JSON gives each kernel's shared memory per problem).
K1 and K3 run bench.py's ADMM config. With
``--phases`` it also builds the kernels with ``-DBK_PROFILE`` and reports,
per kernel at its default block size, where a problem's time goes: lane 0 of
every problem adds the clock64() cycles of each phase to a per-problem row
(common.cuh: Prof); a phase's ``ms`` is its share of the mean per-problem
cycles times the kernel's time. Prints one JSON object with the card's name
and power limit beside the times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

# the phase slots of csrc/ddp.cu and csrc/admm_core.cuh (enum PH_*)
DDP_PHASES = ("total", "rollout0", "derivs", "riccati", "chol", "alphas", "decision",
              "derivs_copy", "derivs_tangent", "derivs_gn", "riccati_products", "riccati_gains",
              "riccati_vxx", "derivs_records")
ADMM_PHASES = ("total", "f_power", "f_fista", "thomas", "chol", "dual", "x_fista", "prologue")
PROF_SLOTS = 16  # common.cuh: PROF_SLOTS


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _problems(spec, batch, states):
    """K1's, K2's and K3's argument tuples on a spec's problems."""
    from .mpc import ik as IK
    from .mpc import kino_dyn as KD
    from .solvers import cuda_admm, cuda_ddp

    model = spec.model
    inputs = [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in states]
    prob = KD._prepare_problem(spec, *inputs)
    admm_cfg = cuda_admm.CudaAdmmConfig(rho=spec.params.rho, x_solver="thomas",
                                        fista_max_iters=30)
    admm_in = (prob["plan"], model.total_mass, prob["x_init"], prob["W"], prob["X_ref"],
               prob["W_F"], prob["X_wm"], prob["F_wm"], prob["x_bounds"], admm_cfg)
    X = cuda_admm.solve(*admm_in)[0]
    tasks, x0 = KD._build_ik_tasks(spec, prob, X)
    w_stage, w_term, ctrl_w, x_reg = IK.dense_weights(model, spec.eff_frames, tasks)
    ddp_in = (model, spec.eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref,
              x_reg, w_stage, w_term, ctrl_w, tasks.dts, cuda_ddp.CudaDdpConfig())
    _, t, vdw, x_init, ee, hip, amom = KD._compact_inputs(spec, *inputs)
    fused_in = (t, vdw, inputs[4], x_init, ee, hip, amom, model.total_mass,
                KD.make_prep_consts(spec), admm_cfg, spec.horizon, spec.n_eff)
    return admm_in, ddp_in, fused_in


def _inputs(batch):
    """The kernels' argument tuples on bench.py's trot problems, and K2's on
    the same recipe on the Solo8's trot (8 joints)."""
    from . import workload
    from .mpc import kino_dyn as KD
    from .mpc.motions.solo12_cyclic import trot
    from .robots.solo12 import Solo12Config

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(),
                               device="cuda")
    admm_in, ddp_in, fused_in = _problems(spec, batch, workload.trot_states(batch))
    ddp8_in = _problems(workload.solo8_spec("trot"), batch, workload.solo8_states(batch))[1]
    return admm_in, ddp_in, fused_in, ddp8_in


def _launchers(admm_in, ddp_in, fused_in, ddp8_in):
    """{name: (module, launch(kernel, per_block), bytes of shared memory a
    problem takes)} of K1, K2 (12 and 8 joints), K3."""
    from .solvers import cuda_admm, cuda_ddp, cuda_fused

    stream = torch.cuda.current_stream().cuda_stream
    H, Hik = admm_in[0].dt.shape[1], ddp_in[-2].shape[1]
    admm_bytes = 4 * cuda_admm.shared_size(H)
    out = {}
    for name, mod, kernel, symbol, ins, nbytes in (
            ("admm", cuda_admm, cuda_admm.KERNEL, "admm_launch_f32", admm_in, admm_bytes),
            ("ddp", cuda_ddp, cuda_ddp.KERNELS[12], "ddp_launch_f32", ddp_in,
             4 * cuda_ddp.shared_size(Hik, 19, 18)),
            ("ddp8", cuda_ddp, cuda_ddp.KERNELS[8], "ddp_launch_f32", ddp8_in,
             4 * cuda_ddp.shared_size(ddp8_in[-2].shape[1], 15, 14)),
            ("fused", cuda_fused, cuda_fused.KERNEL, "fused_launch_f32", fused_in, admm_bytes)):
        def launch(kernel, per_block, mod=mod, symbol=symbol, ins=ins):
            a, keep, _ = mod.kernel_args(*ins)
            kernel.launch(symbol, a + [per_block, stream], mod.ARGTYPES + [mod._I, mod._P])
        out[name] = (kernel, launch, nbytes)
    return out


def _phases(launchers, batch, reps):
    """Per kernel at its default block size: the profiling build's phase
    cycles (mean over problems), each phase's share of the total and its ms
    at the main build's kernel time."""
    from . import _build
    from .solvers import cuda_admm, cuda_ddp

    _build.build_kernels([k for k, _, _ in launchers.values()], force=True,
                         extra=("BK_PROFILE",))
    out = {}
    for name, (kernel, launch, _) in launchers.items():
        lib = kernel.name
        per_block = (cuda_ddp if lib == "ddp" else cuda_admm).PER_BLOCK
        ms = _time(lambda: launch(kernel, per_block), reps)
        prof = _build.Kernel(lib, defines=kernel.defines + ("BK_PROFILE",))
        rows = torch.zeros((batch, PROF_SLOTS), dtype=torch.int64, device="cuda")
        setter = getattr(prof.lib(), f"{lib}_set_profile")
        setter.argtypes = [ctypes.c_void_p]
        setter.restype = ctypes.c_int
        if setter(rows.data_ptr()) != 0:
            raise RuntimeError(f"{name}: could not install the profile buffer")
        prof_ms = _time(lambda: launch(prof, per_block), 1)
        cyc = rows.double() / 2  # _time launched twice (warm-up, then one timed)
        names = DDP_PHASES if lib == "ddp" else ADMM_PHASES
        total = float(cyc[:, 0].mean())
        phases = {}
        for i, ph in enumerate(names):
            mean = float(cyc[:, i].mean())
            if i and mean == 0.0:
                continue
            phases[ph] = {"cycles_mean": round(mean), "cycles_max": round(float(cyc[:, i].max())),
                          "share": round(mean / total, 4), "ms": round(ms * mean / total, 3)}
        out[name] = {"per_block": per_block, "kernel_ms": round(ms, 3),
                     "profiling_build_ms": round(prof_ms, 3), "phases": phases}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--per-block", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--phases", action="store_true",
                    help="also report each kernel's phase breakdown (profiling build)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    launchers = _launchers(*_inputs(args.batch))
    out = {"card": card, "batch": args.batch, "admm_ms": {}, "ddp_ms": {}, "ddp8_ms": {},
           "fused_ms": {}}
    from ._build import SMEM_PER_BLOCK

    out["smem_bytes_per_problem"] = {name: nb for name, (_, _, nb) in launchers.items()}
    for per_block in args.per_block:
        for name, (kernel, launch, nbytes) in launchers.items():
            if per_block * nbytes > SMEM_PER_BLOCK:
                ms = f"refused: {per_block * nbytes} bytes of shared memory"
            else:
                ms = round(_time(lambda: launch(kernel, per_block), args.reps), 3)
            out[f"{name}_ms"][per_block] = ms
    if args.phases:
        out["phases"] = _phases(launchers, args.batch, args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
