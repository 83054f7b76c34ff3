"""Policy networks.

Counterpart of ``bunmpc_tpu/learning/networks.py`` (reference
``GoalConditionedPolicyNet``, examples/iterative_algorithm/networks.py:7-81):
an MLP mapping [state(43) ⊕ goal] -> action(12), ReLU, optional BatchNorm,
Kaiming fan-in init. Defaults mirror the reference (4 hidden layers x 256);
the BC config trains 3 x 512 (cfgs/bc_config.yaml).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

# standard deviation of the unit normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def kaiming_truncated_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``kaiming_normal`` in place on a ``(out, in)`` weight:
    ``variance_scaling(2.0, "fan_in", "truncated_normal")``, a unit normal
    truncated to (-2, 2) (drawn by the inverse CDF, as ``jax.random.
    truncated_normal`` draws it) scaled to std sqrt(2 / fan_in)."""
    fan_in = weight.shape[1]
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        u = torch.rand(weight.shape, generator=generator, dtype=weight.dtype,
                       device=weight.device)
        z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        z = z.clamp(-2.0, 2.0)
        return weight.copy_(z * (math.sqrt(2.0 / fan_in) / _TRUNC_STD))


class GoalConditionedPolicyNet(nn.Module):
    """``num_hidden_layer`` Linear(+BatchNorm)+ReLU blocks and a Linear head.
    Parameters are named ``dense.{i}`` and ``norm.{i}``, in the order of the
    flax module's ``Dense_{i}`` and ``BatchNorm_{i}``. BatchNorm uses flax's
    momentum 0.99 and epsilon 1e-5; in training mode PyTorch updates the
    running variance with the unbiased batch variance, flax with the biased
    one (the outputs in both modes agree)."""

    def __init__(self, input_size: int, output_size: int = 12, num_hidden_layer: int = 4,
                 hidden_dim: int = 256, batch_norm: bool = False):
        super().__init__()
        widths = [input_size] + [hidden_dim] * num_hidden_layer + [output_size]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.norm = nn.ModuleList(
            nn.BatchNorm1d(hidden_dim, eps=1e-5, momentum=0.01)
            for _ in range(num_hidden_layer if batch_norm else 0))

    def forward(self, x):
        for i, layer in enumerate(self.dense[:-1]):
            x = layer(x)
            if len(self.norm):
                x = self.norm[i](x)
            x = torch.relu(x)
        return self.dense[-1](x)


@dataclasses.dataclass
class PolicyBundle:
    """A trained policy and its input normalization payload (the reference's
    checkpoint dict {network, norm stats}, behavioral_cloning_train.py:169-189).
    Called on ``(states (B, 43), goals (B, g))``; the normalization tensors
    live on the module's device."""

    module: GoalConditionedPolicyNet
    state_mean: torch.Tensor
    state_std: torch.Tensor
    goal_mean: torch.Tensor
    goal_std: torch.Tensor

    def __call__(self, state, goal):
        s = (state - self.state_mean) / self.state_std
        g = (goal - self.goal_mean) / self.goal_std
        return self.module(torch.cat([s, g], dim=-1))


def init_policy(generator: torch.Generator, input_size: int, output_size: int = 12,
                device="cpu", dtype=torch.float32, **kwargs) -> GoalConditionedPolicyNet:
    """A freshly initialised policy on ``device``: Kaiming truncated-normal
    kernels drawn from ``generator`` (layer by layer, in order) and zero
    biases, as flax initialises the JAX package's net. ``generator`` lives
    on ``device``."""
    module = GoalConditionedPolicyNet(input_size, output_size, **kwargs).to(device, dtype)
    for layer in module.dense:
        kaiming_truncated_(layer.weight, generator)
        nn.init.zeros_(layer.bias)
    return module
