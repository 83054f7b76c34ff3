"""Faults planted in the program under test, for the tests that see a run
with its timed path broken come out not correct."""

from __future__ import annotations

import torch


def answers_shifted():
    """Every problem's plan handed to its neighbour (an off-by-one in the
    problem index where the plans are produced)."""
    from bunmpc_tpu_torch.mpc import kino_dyn as KD

    solve = KD.solve_mpc_batch

    def shifted(*a, **kw):
        plan = solve(*a, **kw)
        return type(plan)(*(torch.roll(x, 1, dims=0) for x in plan))

    KD.solve_mpc_batch = shifted


def state_unchanged():
    """K1 returns its warm start unchanged: no ADMM step is taken."""
    from bunmpc_tpu_torch.solvers import cuda_admm

    def unchanged(plan, m, x_init, W, X_ref, W_F, X_wm, F_wm, x_bounds, cfg, F_ref=None,
                  P_wm=None):
        B = X_wm.shape[0]
        P = torch.zeros_like(X_wm) if P_wm is None else P_wm
        return (X_wm.clone(), F_wm.clone(), torch.zeros(B, dtype=X_wm.dtype),
                torch.zeros(B, dtype=torch.int32), P.clone())

    cuda_admm.solve = unchanged


def half_batch():
    """Only the first half of each batch is solved; the second half gets
    the first half's plans."""
    from bunmpc_tpu_torch.mpc import kino_dyn as KD

    solve = KD.solve_mpc_batch

    def half(spec, q, v, t, v_des, w_des, **kw):
        B = q.shape[0]
        h = (B + 1) // 2
        ws = kw.get("warm_start")
        if ws is not None:
            kw["warm_start"] = tuple(a[:h] for a in ws)
        plan = solve(spec, q[:h], v[:h], t[:h], v_des[:h], w_des[:h], **kw)
        idx = torch.arange(B) % h
        return type(plan)(*(x[idx] for x in plan))

    KD.solve_mpc_batch = half


def physics_unchanged():
    """The physics step returns the state it was given."""
    from bunmpc_tpu_torch.sim import physics

    step = physics.step

    def unchanged(model, eff_frames, params, state, tau, *a, **kw):
        _, info = step(model, eff_frames, params, state, tau, *a, **kw)
        return physics.SimState(state.q.clone(), state.v.clone()), info

    physics.step = unchanged


def physics_half_batch():
    """The physics steps only the first half of the episodes; the rest keep
    their state."""
    from bunmpc_tpu_torch.sim import physics

    step = physics.step

    def half(model, eff_frames, params, state, tau, *a, **kw):
        new, info = step(model, eff_frames, params, state, tau, *a, **kw)
        h = (state.q.shape[0] + 1) // 2
        keep = (torch.arange(state.q.shape[0]) >= h)[:, None]
        return physics.SimState(torch.where(keep, state.q, new.q),
                                torch.where(keep, state.v, new.v)), info

    physics.step = half


FAULTS = {f.__name__: f for f in (answers_shifted, state_unchanged, half_batch,
                                    physics_unchanged, physics_half_batch)}


def apply(name):
    if name is not None:
        FAULTS[name]()


def gather_local():
    """``gather_batch`` exchanges nothing: each rank's plans are its own
    shard repeated once a rank."""
    from bunmpc_tpu_torch.parallel import mesh as PM

    def local(mesh, tree):
        return type(tree)(torch.cat([a] * mesh.size) for a in tree)

    PM.gather_batch = local


def in_rank(name, fn, *args):
    """Run ``fn(*args)`` in a rank with the fault ``name`` planted there."""
    FAULTS[name]()
    return fn(*args)


def in_ranks(name):
    """Plant ``name`` inside every rank that ``parallel.mesh.launch``
    starts (ranks are forked from a server that never saw this process's
    patches)."""
    import functools

    from bunmpc_tpu_torch.parallel import mesh as PM

    launch = PM.launch

    def patched(fn, *a, **kw):
        return launch(functools.partial(in_rank, name, fn), *a, **kw)

    PM.launch = patched


def exchange_left_out():
    in_ranks("gather_local")


def ranks_half_batch():
    in_ranks("half_batch")


FAULTS.update({f.__name__: f for f in (gather_local, exchange_left_out, ranks_half_batch)})
