"""Quantize / dequantize stored vectors (port of ``repro.quant.codec``).

Every function works on tensors on their own device; :func:`cache_codes`
and :func:`code_key` stay host numpy, as in the reference.  Conventions:

* int8 is SYMMETRIC around zero with 127 levels per side: ``code =
  round(x / s)`` with ``s = max|x| / 127`` over the scale group, so no value
  clips and the reconstruction error is at most ``s / 2`` elementwise;
* scales are float32 with broadcast-ready shapes — ``(N, 1)`` per-vector,
  ``(1, d)`` per-dimension — and a zero-size ``(0, 0)`` placeholder when the
  scheme has no scales (bf16 / none);
* bf16 is scale-free storage rounding (``x.to(torch.bfloat16)``).

``torch.round``, ``jnp.round`` and ``np.rint`` all round half to even, and
each step here is one correctly rounded float32 operation in the
reference's order, so codes and scales equal the reference's bit for bit on
every device.  That is why the level divisions go through :func:`_div`:
torch's CUDA division by a Python scalar multiplies by the rounded
reciprocal, which is off by an ulp for some inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant.scheme import QuantSpec

INT8_LEVELS = 127.0          # symmetric: codes in [-127, 127]
_EPS = 1e-12                 # all-zero scale groups quantize to code 0


def _f32(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))
    return t.to(device=device or t.device, dtype=torch.float32)


def _div(x: torch.Tensor, levels: float) -> torch.Tensor:
    """``x / levels`` correctly rounded on any device (a tensor divisor
    keeps torch from taking the reciprocal-multiply path)."""
    return x / torch.full_like(x, levels)


def no_scales(device=None) -> torch.Tensor:
    """The zero-size scales placeholder for scale-free schemes."""
    return torch.zeros((0, 0), dtype=torch.float32, device=device)


def fit_scales(x, spec: QuantSpec) -> torch.Tensor:
    """Max-abs scales of (N, d) vectors: (N, 1) for per-vector int8,
    (1, d) for per-dimension int8, the zero-size placeholder otherwise."""
    x = _f32(x)
    if spec.dtype != "int8":
        return no_scales(x.device)
    dim = 0 if spec.per_dim else 1
    amax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    return _div(torch.clamp(amax, min=_EPS), INT8_LEVELS)


def quantize(x, spec: QuantSpec, scales=None) -> torch.Tensor:
    """Encode (N, d) float vectors into the scheme's storage dtype (int8
    needs the :func:`fit_scales` of the same scale groups)."""
    x = _f32(x)
    if spec.dtype == "int8":
        if scales is None:
            raise ValueError("int8 quantize requires scales (fit_scales)")
        codes = torch.round(x / _f32(scales, x.device))
        return torch.clamp(codes, -INT8_LEVELS, INT8_LEVELS).to(torch.int8)
    if spec.dtype == "bf16":
        return x.to(torch.bfloat16)
    return x


def dequantize(codes, spec: QuantSpec, scales=None) -> torch.Tensor:
    """Decode stored codes back to float32."""
    codes = codes if isinstance(codes, torch.Tensor) else \
        torch.from_numpy(np.asarray(codes))
    if spec.dtype == "int8":
        if scales is None:
            raise ValueError("int8 dequantize requires scales")
        return codes.float() * _f32(scales, codes.device)
    return codes.float()


def query_levels(d: int) -> float:
    """Integer levels of query codes on the int8 integer-dot path: the
    widest symmetric grid (at most 15 bits) for which a length-``d`` dot of
    int8 codes against query codes cannot overflow int32
    (``127 · levels · d < 2^31``)."""
    return float(min(32767, (2 ** 31 - 1) // (128 * max(d, 1))))


def quantize_query(q, levels: float | None = None):
    """Symmetric per-row quantization of (..., d) queries: (codes int32
    (..., d), scale float32 (..., 1)); ``levels`` defaults to
    :func:`query_levels` of the query's d."""
    q = _f32(q)
    if levels is None:
        levels = query_levels(q.shape[-1])
    amax = torch.amax(torch.abs(q), dim=-1, keepdim=True)
    scale = _div(torch.clamp(amax, min=_EPS), levels)
    codes = torch.clamp(torch.round(q / scale), -levels, levels)
    return codes.to(torch.int32), scale


def cache_codes(q, levels: float = INT8_LEVELS):
    """Symmetric int8 codes + float32 scale of one query (host numpy): the
    serving result cache's key material.  q: (d,) -> (codes int8 (d,),
    scale float32 scalar)."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    q = np.asarray(q, np.float32).reshape(-1)
    amax = float(np.max(np.abs(q))) if q.size else 0.0
    scale = np.float32(max(amax, _EPS) / levels)
    codes = np.clip(np.rint(q / scale), -levels, levels).astype(np.int8)
    return codes, scale


def code_key(codes, scale) -> bytes:
    """Exact-match key bytes: the int8 codes verbatim plus the
    little-endian float32 bits of the scale (no hashing, so key equality is
    exactly (codes, scale) equality)."""
    if isinstance(codes, torch.Tensor):
        codes = codes.detach().cpu().numpy()
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    scale_bits = np.asarray(scale, dtype="<f4").tobytes()
    return codes.tobytes() + scale_bits


def query_cache_key(q, levels: float = INT8_LEVELS) -> bytes:
    """:func:`cache_codes` + :func:`code_key` in one step."""
    return code_key(*cache_codes(q, levels))


def max_error_bound(spec: QuantSpec, scales) -> torch.Tensor:
    """Elementwise reconstruction-error bound: half a step for int8
    (broadcasts like ``scales``), 2^-8 RELATIVE for bf16, 0 for none."""
    if spec.dtype == "int8":
        return _f32(scales) * 0.5
    if spec.dtype == "bf16":
        return torch.tensor(2.0 ** -8, dtype=torch.float32)
    return torch.tensor(0.0, dtype=torch.float32)
