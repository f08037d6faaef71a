"""Full float32 precision for one operation, not for the process.

The JAX package asks for ``Precision.HIGHEST`` on the products and
convolutions whose thresholds are calibrated in float32 (the descriptor
similarity, the SSIM filter, the KD-snap distances, PnP). PyTorch holds
the matching switches (TF32 for matmuls and for cuDNN) process-wide, so
``full_float32`` turns both off inside a block and gives the caller's
settings back after it. It works as a ``with`` block and as a decorator.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """Matmuls and convolutions in full float32 (TF32 off) inside the
    block; both TF32 switches as the caller left them after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
