"""Go2 cyclic gait parameters (copy of the tables of
``bunmpc_tpu/mpc/motions/go2_cyclic.py``, with their notes).

The reference ships no Go2 gait file — its robot-agnostic ``AbstractGaitGen``
(reference examples/mpc/abstract_cyclic_gen1.py:13-96) is the Go2-capable
path and users supply parameters. This trot set is the Solo12 trot scaled to
the Go2's 15.1 kg mass and ~0.30 m standing height (rho and PD gains scale
with mass/inertia). Status: MPC solves converge and in-sim stepping-in-place
is stable (<16 deg attitude); forward-walk gait tuning is tracked in
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .params import BiconvexMotionParams

_NJ = 12


trot = BiconvexMotionParams(
    robot_name="go2",
    motion_name="trot",
    gait_period=0.5,
    stance_percent=(0.6, 0.6, 0.6, 0.6),
    gait_dt=0.05,
    phase_offset=(0.0, 0.5, 0.5, 0.0),
    step_ht=0.09,
    state_wt=np.array(
        [0.0, 0.0, 10.0] + [1000.0] * 3 + [1.0] * _NJ + [0.0] * 3 + [100.0] * 3 + [0.5] * _NJ
    ),
    ctrl_wt=np.array([0.0, 0.0, 1000.0] + [5e2] * 3 + [1.0] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(0.0, 5e2),
    reg_wt=(5e-2, 1e-5),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]),
    W_X_ter=10.0 * np.array([1e5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    # Force regularization scales with the SQUARE of the force magnitude:
    # Go2 stance forces are ~6x Solo12's (74 N vs 12 N per leg), so the
    # Solo12 W_F=1e1 over-penalizes them 36x — the round-4 diagnosis of the
    # Go2 collapse: the "optimal" plan starved stance Fz (~110 N << mg=148)
    # and flew the CoM up into its 0.45 m kinematic bound before crashing
    # (scripts/probe_gait_trace.py). (m_solo/m_go2)^2 ~ 0.027 -> W_F ~ 0.1;
    # measured: com-z plan excursion 0.29-0.32 m at 0.1 vs 0.29-0.47 at 1e1.
    W_F=np.array([1e-1, 1e-1, 1e-1] * 4),
    rho=2e5,  # scales with mass: ADMM penalty must match 6x larger momentum rows
    ori_correction=(0.3, 0.5, 0.4),
    gait_horizon=2.0,
    nom_ht=0.30,
    kp=25.0,
    kd=1.0,
)

# Extended-horizon trot (BASELINE.json configs[1]: "Go2 trot/bound with
# extended horizon"): 3 gait cycles of lookahead instead of 2 — 30 knots,
# same weights; full contact-schedule replanning comes from the 20 Hz
# receding-horizon loop re-planning the whole window every cycle.
trot_extended = BiconvexMotionParams(
    **{**trot.__dict__, "motion_name": "trot_extended", "gait_horizon": 3.0}
)


# Bound: front pair and hind pair alternate (phase split front/back instead
# of diagonal). Timings follow the Solo12 bound table (reference
# examples/motions/cyclic/solo12_bound.py:13-41) with the mass-scaled
# weights/penalties used by the Go2 trot above and the Go2 eff order
# (FR, FL, RR, RL) -> front pair = indices (0, 1).
bound = BiconvexMotionParams(
    robot_name="go2",
    motion_name="bound",
    gait_period=0.3,
    stance_percent=(0.5, 0.5, 0.5, 0.5),
    gait_dt=0.05,
    phase_offset=(0.0, 0.0, 0.5, 0.5),
    step_ht=0.07,
    state_wt=np.array(
        [0.0, 0.0, 1e3] + [10.0, 10.0, 10.0] + [50.0] * _NJ
        + [0.0] * 3 + [100.0, 10.0, 100.0] + [0.5] * _NJ
    ),
    ctrl_wt=np.array([0.5, 0.5, 0.5] + [1.0] * 3 + [0.5] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(5e1, 5e2),
    reg_wt=(7e-3, 7e-5),
    W_X=np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 5e3, 1e4, 5e3]),
    W_X_ter=10.0 * np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 1e4, 1e4, 1e4]),
    W_F=np.array([1e-1, 1e-1, 1.5e-1] * 4),  # force-scale^2 scaling, see trot
    rho=4e5,  # bound's flight phases need a stiffer penalty than the trot's
    # 2e5 (measured: 2e5 diverges to NaN at ~iter 240 on the nominal window;
    # 4e5 converges @1e-3 in ~110 iters)
    ori_correction=(0.2, 0.8, 0.8),
    gait_horizon=4.0,
    nom_ht=0.30,
    kp=40.0,
    kd=2.0,
)

# In-sim validated trot (the JAX package's stability sweep,
# artifacts/stability_sweep_go2.json): with the W_F fix and the "vdes" warm
# start the Go2 walks 3 s at 0.3 m/s on the implicit contact model with
# kp=60/kd=3.0, ContactParams(kn=6e4, dn=3000, kt=3000), swing_blend=0.5,
# force_gate=1.0 and warm_start_carry off (the JAX package's
# tests/test_gait_quality.py gates it).
trot_sim = dataclasses.replace(trot, motion_name="trot_sim", kp=60.0, kd=3.0)


GAITS = {
    "trot": trot,
    "trot_sim": trot_sim,
    "trot_extended": trot_extended,
    "bound": bound,
}
