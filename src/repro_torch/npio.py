"""Tensors as numpy arrays and back, bfloat16 included.

JAX's numpy side holds bfloat16 as ``ml_dtypes`` arrays, which ``np.savez``
stores as 2-byte raw values (npz dtype ``|V2``).  The port writes and reads
the same raw values through a 16-bit integer view, so it needs no
``ml_dtypes``.  Checkpoints (``checkpoint/ckpt.py``) and the reference's
weights and training state (``models/convert.py``, ``train/convert.py``)
go through here.
"""
from __future__ import annotations

import numpy as np
import torch

BF16_NPZ = np.dtype("V2")      # how numpy stores an ml_dtypes bfloat16


def to_numpy(x) -> np.ndarray:
    """A leaf as the npz stores it: a tensor on the host (bfloat16 as
    ``|V2`` raw values), or an array as it is."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(BF16_NPZ)
    return x.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A host tensor of ``a``; 2-byte raw values (``|V2``) and ml_dtypes
    bfloat16 arrays become bfloat16."""
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C", copy=True)
    if a.dtype == BF16_NPZ or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def dtype_name(x) -> str:
    """The dtype string of a leaf as the reference's manifest writes it
    (numpy's name; bfloat16)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)
