"""Contact-conditioned state perturbations for data collection.

Counterpart of ``bunmpc_tpu/learning/perturbations.py`` (reference
examples/iterative_algorithm/data_collection.py:225-262): Gaussian tangent
perturbations of a nominal state, projected into the nullspace of the stacked
contact Jacobian so the perturbed state keeps the stance feet where they are,
with candidates that put a foot below the ground rejected.

Batch-leading: one call perturbs a whole batch of nominal states, drawing
every episode's ``n_candidates`` candidates at once from one
``torch.Generator`` and keeping each episode's first valid one.
"""

from __future__ import annotations

import torch

from ..kin import algorithms as K
from ..robots.model import RobotModel


def contact_jacobian(model: RobotModel, eff_frames, q, cnt_flags):
    """Stacked LOCAL_WORLD_ALIGNED translation Jacobian of the feet flagged
    in contact, (..., 3*ne, nv); the rows of feet not in contact are zero."""
    R, p = K.fk(model, q)
    rows = [K.frame_jacobian(model, q, name, R=R, p=p) * cnt_flags[..., j, None, None]
            for j, name in enumerate(eff_frames)]
    return torch.cat(rows, dim=-2)


def nullspace_project(Jc, vec):
    """(I - pinv(J) J) vec for ``vec`` (..., k, nv) against ``Jc`` (..., m,
    nv): removes the components that would move stance feet
    (data_collection.py:243-247). The pseudo-inverse drops singular values
    below JAX's default cutoff, 10 * max(m, nv) * eps of the largest (PyTorch's
    own default is ten times smaller)."""
    m, nv = Jc.shape[-2:]
    rtol = 10.0 * max(m, nv) * torch.finfo(Jc.dtype).eps
    pinv = torch.linalg.pinv(Jc, rtol=rtol)  # (..., nv, m)
    proj = (Jc[..., None, :, :] @ vec[..., None])[..., 0]  # (..., k, m)
    return vec - (pinv[..., None, :, :] @ proj[..., None])[..., 0]


def sample_perturbed_state(
    model: RobotModel,
    eff_frames,
    generator: torch.Generator,
    q_nom,  # (B, nq)
    v_nom,  # (B, nv)
    cnt_flags,  # (B, n_eff) contact flags at the replanning knot
    sigma_base_pos=0.1,
    sigma_base_ori=0.3,
    sigma_joint_pos=0.2,
    sigma_vel=0.1,
    n_candidates: int = 8,
):
    """Returns ``(q0 (B, nq), v0 (B, nv), ok (B,))``: contact-consistent
    perturbed initial states. Each episode draws ``n_candidates`` position
    and velocity perturbations (``generator`` on the states' device),
    projects them into its contact nullspace and keeps the first candidate
    whose feet are all above the ground; where none is, it keeps the nominal
    state (ok False)."""
    B, nv = v_nom.shape
    like = dict(dtype=q_nom.dtype, device=q_nom.device)
    sig_pos = torch.cat([torch.full((3,), float(sigma_base_pos), **like),
                         torch.full((3,), float(sigma_base_ori), **like),
                         torch.full((nv - 6,), float(sigma_joint_pos), **like)])
    dpos = torch.randn((B, n_candidates, nv), generator=generator, **like) * sig_pos
    dvel = torch.randn((B, n_candidates, nv), generator=generator, **like) * sigma_vel

    Jc = contact_jacobian(model, eff_frames, q_nom, cnt_flags)
    q0s = K.integrate(model, q_nom[:, None, :].expand(-1, n_candidates, -1),
                      nullspace_project(Jc, dpos))
    v0s = v_nom[:, None, :] + nullspace_project(Jc, dvel)
    feet = K.frame_positions(model, q0s, eff_frames)  # (B, k, ne, 3)
    oks = (feet[..., 2] >= 0.0).all(dim=-1)  # (B, k)
    ok = oks.any(dim=1)
    idx = torch.argmax(oks.to(torch.int32), dim=1)  # the first valid candidate
    pick = torch.arange(B, device=q_nom.device)
    q0 = torch.where(ok[:, None], q0s[pick, idx], q_nom)
    v0 = torch.where(ok[:, None], v0s[pick, idx], v_nom)
    return q0, v0, ok
