"""Policy-remembering ("past goals") evaluation.

Counterpart of ``bunmpc_tpu/eval/past_goals.py`` (reference
``test_policy_rollout_with_past_goals.py``,
examples/iterative_algorithm/test_policy_rollout_with_past_goals.py:481-660,
the only eval driver without a round-2 counterpart): goals are visited
sequentially; after training on goal ``i`` the policy is rolled out on EVERY
past goal ``j <= i`` and the vx/vy velocity-tracking MSEs are recorded,
yielding the lower-triangular "forgetting matrix" the reference exports to
xlsx (error_vx_his / error_vy_his).

The reference needs ``i+1`` sequential PyBullet episodes per iteration; here
the past-goal sweep of one iteration is a SINGLE batched policy rollout (all
past goals in parallel on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..learning import goals as GU
from ..learning.bc import BcConfig, train_policy
from ..learning.database import Database
from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout
from .velocity_grid import batch_start, host


@dataclasses.dataclass
class PastGoalsResult:
    goals: np.ndarray  # (n, 4) [vx, vy, vz, w]
    error_vx: np.ndarray  # (n, n) lower-triangular MSE matrix
    error_vy: np.ndarray  # (n, n)
    survived: np.ndarray  # (n, n) bool

    def forgetting(self):
        """Mean error increase on goal j between its own iteration and the
        final iteration — the quantitative 'did it forget' scalar."""
        n = self.error_vx.shape[0]
        diag = np.array([self.error_vx[j, j] for j in range(n)])
        final = self.error_vx[n - 1, :]
        return float(np.nanmean(final[: n - 1] - diag[: n - 1])) if n > 1 else 0.0

    def to_csv(self, path: str):
        n = self.error_vx.shape[0]
        with open(path, "w") as fh:
            fh.write("iteration,goal_idx,vx_des,vy_des,w_des,vx_mse,vy_mse,survived\n")
            for i in range(n):
                for j in range(i + 1):
                    g = self.goals[j]
                    fh.write(
                        f"{i},{j},{g[0]:.4f},{g[1]:.4f},{g[3]:.4f},"
                        f"{self.error_vx[i, j]:.6f},{self.error_vy[i, j]:.6f},"
                        f"{int(self.survived[i, j])}\n"
                    )


def run_past_goals_eval(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    rcfg: rollout.RolloutConfig,
    q0,
    v0,
    goal_list,  # (n, 4) rows [vx, vy, vz, w] (reference: linspace over ranges)
    bc_cfg: BcConfig = BcConfig(),
    database_size: int = 200_000,
    seed: int = 0,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> PastGoalsResult:
    """Sequential-goal BC with past-goal re-evaluation (reference
    run_unperturbed loop): per iteration i — the nominal MPC rollout at goal
    i is aggregated, the policy trained (its weights carried to the next
    iteration, the BC seed ``rng.integers(1 << 31)`` drawn per iteration),
    then ONE batched policy rollout runs over the full goal set (the batch
    never changes size; rows j > i are discarded).

    The n nominal MPC rollouts do not depend on the policy, so they run as
    ONE batched ``rollout_mpc`` call over the goals before the loop (K1 and
    K2 once per window), and iteration i appends goal i's records as the
    JAX package's per-iteration rollout does: the only change of order. That
    call keeps ``rollout_mpc``'s default warm start (carried for "tiled"
    specs, as the JAX package's). Everything runs on ``q0``'s device
    and dtype (``spec.device`` in float32 for arrays); the policy trains on
    that device."""
    goal_list = np.asarray(host(goal_list), np.float32)
    n = goal_list.shape[0]
    db = Database(database_size, goal_type="vc")
    rng = np.random.default_rng(seed)
    params = None

    start = batch_start(spec, physics.SimState(q=q0, v=v0), n)
    like = start.q
    vds = torch.as_tensor(goal_list[:, 0:3], dtype=like.dtype, device=like.device)
    wds = torch.as_tensor(goal_list[:, 3], dtype=like.dtype, device=like.device)
    mpc = rollout.rollout_mpc(spec, sim_params, rcfg, start, vds, wds, admm_cfg=admm_cfg,
                              ddp_cfg=ddp_cfg, admm_backend=admm_backend, ik_backend=ik_backend)
    mpc_failed, mpc_fail_step = host(mpc.failed), host(mpc.fail_step)

    error_vx = np.full((n, n), np.nan)
    error_vy = np.full((n, n), np.nan)
    survived = np.zeros((n, n), bool)

    for i in range(n):
        T = int(mpc_fail_step[i]) if bool(mpc_failed[i]) else mpc.states.shape[1]
        if T > 50:
            db.append(
                host(mpc.states[i, :T]),
                host(mpc.actions[i, :T]),
                vc_goals=host(mpc.vc_goals[i, :T]),
            )
        policy, _ = train_policy(db, bc_cfg, rng_seed=int(rng.integers(1 << 31)), params=params,
                                 device=like.device)
        params = policy.module.state_dict()

        B = i + 1
        pres = rollout.rollout_policy(spec, sim_params, rcfg, start, vds, wds, policy)
        st = host(pres.states[..., 0:6])
        failed = host(pres.failed)
        fail_step = host(pres.fail_step)
        for j in range(B):
            Tj = int(fail_step[j]) if bool(failed[j]) else st.shape[1]
            if Tj < 2:
                continue
            vx_e, vy_e, _ = GU.compute_vc_mse(
                goal_list[j, 0:3], float(goal_list[j, 3]),
                st[j, :Tj, 0:2], st[j, :Tj, 5],
            )
            error_vx[i, j] = vx_e
            error_vy[i, j] = vy_e
            survived[i, j] = not bool(failed[j])

    return PastGoalsResult(
        goals=goal_list, error_vx=error_vx, error_vy=error_vy, survived=survived
    )
