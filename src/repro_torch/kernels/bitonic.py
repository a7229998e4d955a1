"""Row-wise bitonic co-sort: the ``sort_pairs`` kernel.

Wrapper of ``csrc/bitonic.cu``, the Hopper port of
``repro.kernels.bitonic.sort_pairs``: (B, n) f32 keys with two (B, n) int32
payloads, each row sorted ascending in the total order (key, p0, p1).  A
row of n <= 1024 is sorted in one warp's registers; a longer one merges
1024-element runs through shared memory.  n is a power of two from 1 up to
:data:`MAX_N` = 16384, the largest whose 12 B × n fit a block's shared
memory on an H100 (227 KB); other n raise ``ValueError``.

For CPU tensors :func:`sort_pairs` returns the plain version
(``kernels.ref.sort_pairs_ref``); for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ref as _ref
from repro_torch.launch import op_profile

MAX_N = 16384


def sort_pairs(keys: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise ascending co-sort of (B, n) f32 keys and int32 payloads by
    (key, p0, p1); returns the sorted (keys, p0, p1)."""
    if keys.dim() != 2 or p0.shape != keys.shape or p1.shape != keys.shape:
        raise ValueError(f"sort_pairs: want keys, p0, p1 of one (B, n) "
                         f"shape; got {tuple(keys.shape)}, "
                         f"{tuple(p0.shape)}, {tuple(p1.shape)}")
    if keys.dtype != torch.float32 or p0.dtype != torch.int32 \
            or p1.dtype != torch.int32:
        raise TypeError(f"sort_pairs: want float32 keys and int32 payloads, "
                        f"got {keys.dtype}, {p0.dtype}, {p1.dtype}")
    n = keys.shape[1]
    if n < 1 or n & (n - 1) or n > MAX_N:
        raise ValueError(f"sort_pairs: row length {n} must be a power of "
                         f"two in [1, {MAX_N}]")
    if len({keys.device, p0.device, p1.device}) != 1:
        raise ValueError("sort_pairs: tensors on several devices")
    if keys.device.type == "cpu":
        return _ref.sort_pairs_ref(keys, p0, p1)
    keys, p0, p1 = keys.contiguous(), p0.contiguous(), p1.contiguous()
    out = (torch.empty_like(keys), torch.empty_like(p0),
           torch.empty_like(p1))
    if keys.numel():
        if op_profile.ACTIVE is not None:
            # 12 B an element read and written; two comparisons a
            # compare-exchange of the bitonic network
            k = n.bit_length() - 1
            op_profile.ACTIVE.kernel(
                "sort_pairs", (keys, p0, p1), out,
                keys.shape[0] * (n // 2) * (k * (k + 1) // 2) * 2, "f32",
                12 * keys.numel(), 12 * keys.numel())
        if _cuda.traced(keys):
            return out
        _cuda.launch("bitonic", "sort_pairs", keys, p0, p1, *out,
                     keys.shape[0], n)
    return out
