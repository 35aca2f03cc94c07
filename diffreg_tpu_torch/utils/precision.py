"""Precision policy: float32 everywhere, no TF32.

The JAX package pins its contractions to ``Precision.HIGHEST``. The port's
counterpart is plain float32 with TF32 off for matmuls and cuDNN, so that
the Sinkhorn logits, the pose covariance and the KPConv contractions keep
full float32 on the card.
"""
from __future__ import annotations

import torch


def pin_float32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
