"""GP-based Bayesian optimisation over velocity goals.

Copy of ``bunmpc_tpu/learning/gp_bo.py`` (reference
examples/iterative_algorithm/test_bayesian_optimization.py:65-678:
``gp_minimize`` with an LCB acquisition, n_calls=10, over (vx, w), objective
= min(MPC tracking error, policy tracking error)). The GP (Matern-5/2, exact
inference) and the LCB minimisation run on numpy and scipy on the host: ten
evaluations an iteration, a host-side problem by construction. This is the
one module of the port that needs scipy (``scipy.optimize.minimize``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
from scipy.optimize import minimize


def _matern52(X1, X2, length_scale):
    d = np.sqrt(
        np.maximum(
            np.sum((X1[:, None, :] - X2[None, :, :]) ** 2 / length_scale**2, axis=-1), 1e-30
        )
    )
    s5 = np.sqrt(5.0) * d
    return (1.0 + s5 + s5**2 / 3.0) * np.exp(-s5)


@dataclasses.dataclass
class GpLcbOptimizer:
    """Sequential model-based minimisation with a lower-confidence-bound
    acquisition (skopt ``gp_minimize`` semantics)."""

    bounds: np.ndarray  # (d, 2)
    kappa: float = 1.96
    noise: float = 1e-6
    n_initial: int = 3
    seed: int = 0

    def __post_init__(self):
        self.X: list = []
        self.y: list = []
        self.rng = np.random.default_rng(self.seed)
        self._ls = (self.bounds[:, 1] - self.bounds[:, 0]) / 3.0

    def _gp_posterior(self, Xq):
        X = np.asarray(self.X)
        y = np.asarray(self.y)
        mu0 = y.mean()
        K = _matern52(X, X, self._ls) + self.noise * np.eye(len(X))
        Ks = _matern52(Xq, X, self._ls)
        alpha = np.linalg.solve(K, y - mu0)
        mu = mu0 + Ks @ alpha
        v = np.linalg.solve(K, Ks.T)
        var = np.maximum(1.0 - np.sum(Ks * v.T, axis=1), 1e-12)
        return mu, np.sqrt(var) * y.std() if y.std() > 0 else np.sqrt(var)

    def ask(self) -> np.ndarray:
        if len(self.X) < self.n_initial:
            return self.rng.uniform(self.bounds[:, 0], self.bounds[:, 1])

        def lcb(x):
            mu, sd = self._gp_posterior(x[None, :])
            return float(mu[0] - self.kappa * sd[0])

        best_x, best_v = None, np.inf
        for _ in range(8):  # multi-start local minimisation of the acquisition
            x0 = self.rng.uniform(self.bounds[:, 0], self.bounds[:, 1])
            res = minimize(lcb, x0, bounds=self.bounds, method="L-BFGS-B")
            if res.fun < best_v:
                best_x, best_v = res.x, res.fun
        return best_x

    def tell(self, x, y):
        self.X.append(np.asarray(x, float))
        self.y.append(float(y))

    @property
    def best(self):
        i = int(np.argmin(self.y))
        return np.asarray(self.X[i]), self.y[i]


def gp_minimize(objective: Callable, bounds, n_calls: int = 10, seed: int = 0):
    """Drop-in for the reference's GP_optimization loop
    (test_bayesian_optimization.py:613-640)."""
    opt = GpLcbOptimizer(bounds=np.asarray(bounds, float), seed=seed)
    for _ in range(n_calls):
        x = opt.ask()
        opt.tell(x, objective(x))
    return opt.best
