"""Solve time and convergence against the horizon.

Counterpart of ``scripts/solve_times_sweep.py`` (reference
examples/analysis/solve_times_test.py:66-118 and dyn_violation.py:80-87):
for each ``gait_horizon`` in (1.0, 1.5, 2.0, 2.5) of the gait's table, a
batch of ``batch`` solves from q0 at vx 0.2 (``solve_mpc_batch``), one
untimed call first (the kernels' build and the allocator's warm-up, where
the JAX script compiles), then one timed call.

    python -m bunmpc_tpu_torch.scripts.solve_times_sweep [gait=trot] [batch=64] [out=...]

On the card the solve runs through the kernels K1 (the ADMM) and K2 (the
IK), so these times are the kernels' (the JAX script times its XLA ADMM);
``device=cpu`` runs their plain versions. The wall time of the timed call
(``utils/profiling.SolveTimer``, the device waited for) is the output's;
CUDA events around it are printed beside it. Writes ``{H: {sec_per_batch,
solves_per_sec, mean_admm_iters, mean_viol}}`` to ``out`` (default
``torch_solve_times_<gait>.json``).
"""

import dataclasses
import sys

import numpy as np


def sweep(gait_name: str, B: int, device, horizons=(1.0, 1.5, 2.0, 2.5), dtype=None):
    """The sweep's table ``{H: {...}}`` and, per H, the timed call's CUDA
    event milliseconds (None off the card); the problems in ``dtype``
    (float32 by default, the JAX script's)."""
    import torch

    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import GAITS
    from ..robots.solo12 import Solo12Config
    from ..solvers import cuda_admm
    from ..utils.profiling import SolveTimer

    params = GAITS[gait_name]
    model = Solo12Config.load_model()
    results, event_ms = {}, {}
    timer = SolveTimer()
    on_card = torch.device(device).type == "cuda"
    for gait_horizon in horizons:
        p = dataclasses.replace(params, gait_horizon=gait_horizon)
        spec = KD.make_cyclic_spec(model, p, Solo12Config.q0(), device=device)
        f32 = dict(dtype=torch.float32 if dtype is None else dtype, device=device)
        q = torch.as_tensor(np.tile(Solo12Config.q0(), (B, 1)), **f32)
        v = torch.zeros((B, 18), **f32)
        t = torch.zeros(B, **f32)
        vd = torch.as_tensor([0.2, 0.0, 0.0], **f32).repeat(B, 1)
        wd = torch.zeros(B, **f32)
        admm = cuda_admm.CudaAdmmConfig(rho=p.rho)

        def solve():
            return KD.solve_mpc_batch(spec, q, v, t, vd, wd, admm_cfg=admm)

        plans = solve()
        if on_card:
            torch.cuda.synchronize(device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        name = f"H={spec.horizon}"
        with timer.phase(name, block_on=None):
            if on_card:
                ev[0].record()
            plans = solve()
            if on_card:
                ev[1].record()
                torch.cuda.synchronize(device)
        event_ms[spec.horizon] = ev[0].elapsed_time(ev[1]) if on_card else None
        sec = timer.times[name][-1]
        results[spec.horizon] = {
            "sec_per_batch": sec,
            "solves_per_sec": B / sec,
            "mean_admm_iters": float(plans.admm_iters.double().mean()),
            "mean_viol": float(plans.dyn_violation.double().mean()),
        }
    return results, event_ms


def main(argv=None) -> int:
    from ..utils import jsonio
    from ..utils.runtime import setup_torch

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else list(argv)))
    device = setup_torch(args.get("device"))
    gait_name = args.get("gait", "trot")
    B = int(args.get("batch", 64))
    results, event_ms = sweep(gait_name, B, device)
    for H, r in results.items():
        ev = "" if event_ms[H] is None else f" (CUDA events: {event_ms[H]:.3f} ms)"
        print(f"H={H}: {r}{ev}")
    out = args.get("out", f"torch_solve_times_{gait_name}.json")
    jsonio.write_json(out, {str(h): r for h, r in results.items()}, indent=2)
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
