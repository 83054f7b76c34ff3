"""Time the hand-written kernels on the card at the main path's inputs.

    python -m bunmpc_tpu_torch.profile_kernels [--batch 512] [--reps 5]

Builds K1 (csrc/admm.cu), K2 (csrc/ddp.cu) and K3 (csrc/fused.cu), assembles
bench.py's Solo12 trot problems (rng seed 0) at the given batch, and times
each kernel by CUDA events for every block size in ``--per-block`` (problems
per thread block; K1 and K3 run 32 threads per problem, K2 16). K1 and K3
run bench.py's ADMM config. Prints one JSON object with the card's name and
power limit beside the times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    # at 255 registers a thread, 16 K1 or K3 problems (512 threads) exceed an SM's
    # 65,536 registers and the launch is refused
    ap.add_argument("--per-block", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA device")
    from .mpc import ik as IK
    from .mpc import kino_dyn as KD
    from .mpc.motions.solo12_cyclic import trot
    from .robots.solo12 import Solo12Config
    from .solvers import cuda_admm, cuda_ddp, cuda_fused
    from .workload import trot_states

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0(), device="cuda")
    inputs = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
              for a in trot_states(args.batch)]
    prob = KD._prepare_problem(spec, *inputs)
    admm_cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", fista_max_iters=30)
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

    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": card, "batch": args.batch, "admm_ms": {}, "ddp_ms": {}, "fused_ms": {}}
    for per_block in args.per_block:
        def admm():
            a, keep, _ = cuda_admm.kernel_args(*admm_in)
            cuda_admm.KERNEL.launch("admm_launch_f32", a + [per_block, stream],
                                    cuda_admm.ARGTYPES + [cuda_admm._I, cuda_admm._P])

        def ddp():
            a, keep, _ = cuda_ddp.kernel_args(*ddp_in)
            cuda_ddp.KERNEL.launch("ddp_launch_f32", a + [per_block, stream],
                                   cuda_ddp.ARGTYPES + [cuda_ddp._I, cuda_ddp._P])

        def fused():
            a, keep, _ = cuda_fused.kernel_args(*fused_in)
            cuda_fused.KERNEL.launch("fused_launch_f32", a + [per_block, stream],
                                     cuda_fused.ARGTYPES + [cuda_fused._I, cuda_fused._P])

        out["admm_ms"][per_block] = round(_time(admm, args.reps), 3)
        out["ddp_ms"][per_block] = round(_time(ddp, args.reps), 3)
        out["fused_ms"][per_block] = round(_time(fused, args.reps), 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
