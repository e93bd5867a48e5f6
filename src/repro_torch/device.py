"""Device resolution for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
With no CUDA device and no explicit ``device="cpu"`` they raise: a run never
moves to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as asked.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_f32(X, device: torch.device) -> torch.Tensor:
    """A 2-D array or tensor as contiguous float32 on ``device`` (no copy
    when it already is one)."""
    return to_dtype(X, device, torch.float32)


def to_dtype(X, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A 2-D array or tensor as a contiguous ``dtype`` tensor on ``device``
    (no copy when it already is one)."""
    if isinstance(X, np.ndarray):
        X = torch.from_numpy(np.require(X, requirements="W"))
    return torch.as_tensor(X).to(device=device, dtype=dtype).contiguous()


def host_array(x, dtype) -> np.ndarray:
    """An array, or a tensor on any device, as a numpy array of ``dtype``
    (bf16 tensors through f32, which holds them exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x, dtype=dtype)


def data_dtype(X) -> torch.dtype:
    """The dtype the in-core loops read ``X`` as: a tensor's own, f32 for
    anything else (numpy has no bf16, so a bf16 dataset is a tensor)."""
    return X.dtype if isinstance(X, torch.Tensor) else torch.float32
