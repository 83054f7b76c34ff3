"""The control's precision: float32 with its matrix products in TF32.

The port computes in float32 with TF32 off (``bunmpc_tpu_torch/__init__.py``
turns it off). The nearest precision below is TF32: a tensor-core product
rounds each float32 input to a 10-bit mantissa and accumulates in float32.
``tf32_products`` does exactly that to every matrix product of float32
tensors run inside it, on any device, so that the control reads the same on
the CPU as on the card, whichever kernel cuBLAS would choose; on the card it
also lets cuBLAS use TF32.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 11 significant bits (10 stored),
    still as float32: Veltkamp's split, ``c - (c - x)`` with ``c = x * (2^13
    + 1)``, pure arithmetic, so that it also runs under ``torch.func``'s
    transforms. Values too large to split (and non-finite ones) stay as
    they are."""
    c = x * 8193.0
    hi = c - (c - x)
    return torch.where(torch.isfinite(hi), hi, x)


_PRODUCTS = {
    torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
    torch.bmm, torch.Tensor.bmm, torch.mm, torch.Tensor.mm, torch.mv, torch.Tensor.mv,
    torch.einsum, torch.tensordot, torch.baddbmm, torch.addmm, torch.inner, torch.outer,
    torch.dot, torch.Tensor.dot,
}


def _round_arg(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return round_tf32(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_round_arg(x) for x in a)
    return a


class _Tf32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(_round_arg(a) for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32_products():
    """Run the block with every float32 matrix product in TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with _Tf32Products():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
