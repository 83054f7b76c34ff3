"""bunmpc_tpu_torch — the PyTorch/CUDA port of ``bunmpc_tpu`` for one NVIDIA
H100: the batched Solo12 trot MPC solve (problem assembly, centroidal ADMM,
IK task build, kinematic GN-DDP, 1 kHz interpolation), with the two solver
kernels written by hand in CUDA C++ (``csrc/admm.cu``, ``csrc/ddp.cu``).

Module layout and names follow the JAX package so each module's counterpart
is easy to find. The port imports torch and numpy only.
"""

import torch as _torch

# Full-f32 arithmetic everywhere. Reduced-precision matmul passes (TF32 on
# the card, bf16 on the TPU) break the 9x9 block-Cholesky factors of the
# ADMM X-solve and the Riccati blocks of the DDP, so they are turned off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
