"""Bayesian goal-distribution update over the velocity-command grid.

Copy of ``bunmpc_tpu/learning/bayes.py`` (reference LocoSafeDagger,
examples/iterative_algorithm/locosafedagger_modified.py:357-425, and the 2-D
prototype test_bayesian_update.py:18-154): a discrete grid over (vx, vy, w),
a Gaussian likelihood centred at the observed goal, a multiplicative
posterior update, and categorical sampling of the next training goal.
Host-side numpy: the grid is a few thousand cells and is updated once per
iteration.

The reference's semantics are kept: a fixed-sigma Gaussian (the reference
documents an ``error`` argument that its implementation does not use), the
posterior = prior * likelihood, normalised. Optional extensions, off by
default: a likelihood whose width grows with the tracking error, and an
inverted update that moves mass toward poorly tracked goals.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GoalGrid:
    vx: np.ndarray
    vy: np.ndarray
    w: np.ndarray

    @classmethod
    def make(cls, vx_range, vy_range, w_range, n: int = 100):
        return cls(
            vx=np.linspace(vx_range[0], vx_range[1], n),
            vy=np.linspace(vy_range[0], vy_range[1], n),
            w=np.linspace(w_range[0], w_range[1], n),
        )

    @property
    def shape(self):
        return (len(self.vx), len(self.vy), len(self.w))

    def uniform_prior(self):
        p = np.ones(self.shape)
        return p / p.sum()


def compute_likelihood(grid: GoalGrid, observed_goal, sigma: float = 0.1, error: float = None):
    """Gaussian likelihood centred at the observed goal, normalised
    (locosafedagger_modified.py:357-384). Pass ``error`` for the extension
    where the width grows with the realised tracking error."""
    if error is not None:
        sigma = sigma * (1.0 + error)
    dvx = (grid.vx[:, None, None] - observed_goal[0]) / sigma
    dvy = (grid.vy[None, :, None] - observed_goal[1]) / sigma
    dw = (grid.w[None, None, :] - observed_goal[2]) / sigma
    ll = np.exp(-0.5 * (dvx**2 + dvy**2 + dw**2))
    s = ll.sum()
    return ll / s if s > 0 else np.full(grid.shape, 1.0 / np.prod(grid.shape))


def update_goal_distribution(prior: np.ndarray, likelihood: np.ndarray, invert: bool = False):
    """posterior ∝ prior * likelihood (locosafedagger_modified.py:386-403).
    ``invert=True`` is an extension: mass moves away from well-covered goals."""
    like = (1.0 - likelihood / likelihood.max()) if invert else likelihood
    post = prior * like
    s = post.sum()
    return post / s if s > 0 else prior


def random_sample_from_distribution(rng: np.random.Generator, grid: GoalGrid, posterior):
    """Categorical draw of the next goal (locosafedagger_modified.py:404-425)."""
    flat = posterior.reshape(-1)
    idx = rng.choice(len(flat), p=flat / flat.sum())
    i, j, k = np.unravel_index(idx, grid.shape)
    return np.array([grid.vx[i], grid.vy[j], grid.w[k]])
