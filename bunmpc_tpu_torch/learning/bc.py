"""Behavioral-cloning trainer.

Counterpart of ``bunmpc_tpu/learning/bc.py`` (reference
examples/iterative_algorithm/behavioral_cloning_train.py:35-244): L1 loss,
Adam, a train/validation split and the normalization payload. The training
rows move to the device once; every mini-batch is drawn there by index, in
the order of the JAX trainer's numpy permutations, so the two trainers see
the same batches step for step. With a mesh (``parallel.mesh``) the step is
data-parallel, one rank per device: each rank takes its equal part of every
batch, and the gradients are all-reduced before the same Adam step runs on
every rank (the JAX trainer's ``make_sharded_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..mpc.kino_dyn import resolve_device
from ..parallel.mesh import Mesh, replicate, shard_batch
from .database import Database
from .networks import GoalConditionedPolicyNet, PolicyBundle, init_policy


@dataclasses.dataclass
class BcConfig:
    """Reference defaults from cfgs/bc_config.yaml:84-88."""

    batch_size: int = 256
    learning_rate: float = 2e-3
    n_epoch: int = 150
    n_train_frac: float = 0.9
    num_hidden_layer: int = 3
    hidden_dim: int = 512
    loss: str = "l1"  # nn.L1Loss in the reference (:104)


@dataclasses.dataclass
class TrainReport:
    train_losses: list
    valid_losses: list


def make_optimizer(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(pred, y, loss_type: str = "l1"):
    """Mean L1 (or squared) error. The L1 subgradient at zero is +1, as
    ``jax.grad(jnp.abs)(0.0)`` gives it (``torch.abs`` gives 0 there)."""
    d = pred - y
    if loss_type == "l1":
        return torch.where(d >= 0, d, -d).mean()
    return (d * d).mean()


def train_step(module, optimizer, x, y, loss_type: str = "l1"):
    """One Adam step on the batch ``(x, y)``; returns the loss (a tensor on
    the device, not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(module(x), y, loss_type)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_sharded_train_step(module, optimizer, mesh: Mesh, loss_type: str = "l1"):
    """Data-parallel train step over the ``batch`` mesh (the JAX trainer's
    sharded step, whose psum XLA inserts): ``step(x, y)`` takes this rank's
    shard of the batch (``shard_batch``), computes its mean loss and
    gradients, all-reduces them (one sum over the mesh of the loss and every
    gradient, divided by the mesh's size: the whole batch's mean, since the
    shards are equal) and takes the Adam step, the same on every rank.
    Returns the whole batch's loss (a tensor on the device, not
    synchronised). The parameters must start equal on every rank
    (``replicate``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"make_sharded_train_step: mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    params = list(module.parameters())

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(module(x), y, loss_type)
        loss.backward()
        flat = torch.cat([loss.detach().reshape(1)] + [p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        off = 1
        for p in params:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        optimizer.step()
        return flat[0]

    return step


def train_policy(
    database: Database,
    cfg: BcConfig = BcConfig(),
    rng_seed: int = 0,
    mesh=None,
    params: dict | None = None,
    log_fn: Callable | None = None,
    device=None,
) -> tuple[PolicyBundle, TrainReport]:
    """Train a goal-conditioned policy on the database (train_network,
    behavioral_cloning_train.py:83-167) in float32 on ``device``. Pass
    ``params`` (a state dict of ``GoalConditionedPolicyNet``, e.g. from
    ``convert.policy_params_from_flax`` or a bundle's ``module.state_dict()``)
    to warm-start; otherwise the net is initialised from ``rng_seed``. The
    split and the batches come from ``np.random.default_rng(rng_seed)`` as in
    the JAX trainer. ``device`` defaults to the card.

    With ``mesh`` (a ``parallel.mesh`` batch mesh; every rank of it calls
    this with the same arguments) the training is data-parallel on the
    mesh's devices: the batch size is rounded to a multiple of the mesh's
    size (``max(bs // n * n, n)``, as in JAX), every rank draws the same
    permutations, starts from the first rank's parameters and takes its
    part of each batch (``make_sharded_train_step``); the losses reported
    are the whole batch's, and every rank returns the same bundle.
    ``device`` must then be None or the mesh's device."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"train_policy: mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh.rank is None:
            raise ValueError(f"train_policy: this process is not a rank of the mesh {mesh.ranks}")
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"train_policy: device {device} is not the mesh's {mesh.device}")
        device = mesh.device
    device = resolve_device("cuda" if device is None else device)
    x_all, y_all = database.xy()
    rng = np.random.default_rng(rng_seed)
    perm = rng.permutation(len(x_all))
    n_train = int(cfg.n_train_frac * len(x_all))
    tr, va = perm[:n_train], perm[n_train:]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    x_tr, y_tr = dev(x_all[tr]), dev(y_all[tr])
    x_va, y_va = dev(x_all[va]), dev(y_all[va])

    arch = dict(output_size=y_all.shape[-1], num_hidden_layer=cfg.num_hidden_layer,
                hidden_dim=cfg.hidden_dim)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(rng_seed)
        module = init_policy(gen, x_all.shape[-1], device=device, **arch)
    else:
        module = GoalConditionedPolicyNet(x_all.shape[-1], **arch).to(device)
        module.load_state_dict(params)
    optimizer = make_optimizer(module, cfg.learning_rate)

    if mesh is not None:
        module.load_state_dict(replicate(mesh, module.state_dict()))
        sharded = make_sharded_train_step(module, optimizer, mesh, cfg.loss)

        def step(sel):
            mine = shard_batch(mesh, sel)
            return sharded(x_tr[mine], y_tr[mine])

        bs = max(cfg.batch_size // mesh.size * mesh.size, mesh.size)
    else:
        def step(sel):
            return train_step(module, optimizer, x_tr[sel], y_tr[sel], cfg.loss)

        bs = cfg.batch_size
    n = (len(x_tr) // bs) * bs
    train_losses, valid_losses = [], []
    for epoch in range(cfg.n_epoch):
        module.train()
        order = torch.as_tensor(rng.permutation(len(x_tr))[:n], device=device)
        losses = [step(sel) for sel in order.split(bs)]
        tl = float(torch.stack(losses).double().mean()) if losses else float("nan")
        module.eval()
        if len(x_va):
            with torch.no_grad():
                vl = float((module(x_va) - y_va).abs().mean())
        else:
            vl = float("nan")
        train_losses.append(tl)
        valid_losses.append(vl)
        if log_fn is not None:
            log_fn({"epoch": epoch, "Training Loss": tl, "Validation Loss": vl})
    module.eval()

    sm, ss, gm, gs = database.get_database_mean_std()
    bundle = PolicyBundle(module=module, state_mean=dev(sm), state_std=dev(ss),
                          goal_mean=dev(gm), goal_std=dev(gs))
    return bundle, TrainReport(train_losses=train_losses, valid_losses=valid_losses)
