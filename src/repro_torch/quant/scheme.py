"""Quantization schemes for stored index vectors.

The port's own copy of ``repro.quant.scheme``: a :class:`QuantSpec` says how
the embedding table is stored (``"none"`` float32, ``"bf16"``, ``"int8"``
codes + float32 scales); ``quant.codec`` encodes the table and
``quant.kernels`` holds the distance backends that read it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

QUANT_DTYPES = ("none", "int8", "bf16")


@dataclass(frozen=True)
class QuantSpec:
    """How the index's embedding table is quantized (an index-time property,
    persisted with the index inside ``IndexSpec``)."""
    dtype: str = "none"       # "none" | "int8" | "bf16"
    per_dim: bool = False     # int8 scale granularity: per-vector rows
    #                           (False) or per-dimension columns (True)
    keep_float: bool = True   # persist the float32 vectors alongside the
    #                           codes so search can re-rank exactly

    def __post_init__(self):
        if self.dtype not in QUANT_DTYPES:
            raise ValueError(
                f"unknown quant dtype {self.dtype!r}; one of {QUANT_DTYPES}")

    @property
    def enabled(self) -> bool:
        return self.dtype != "none"

    def with_(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


def coerce_quant(value) -> QuantSpec:
    """Normalize the user-facing forms of a quant spec (``None``, a
    :class:`QuantSpec`, a dtype string, or the json round-trip dict)."""
    if value is None:
        return QuantSpec()
    if isinstance(value, QuantSpec):
        return value
    if isinstance(value, str):
        return QuantSpec(dtype=value)
    if isinstance(value, dict):
        return QuantSpec(**value)
    raise TypeError(f"quant must be a QuantSpec, dtype string, or dict; "
                    f"got {type(value).__name__}")


def required_quant_dtype(backend: str) -> str:
    """The quant dtype a distance backend needs ("none" for f32 backends);
    quantized backends follow the ``<base>_<dtype>`` naming convention."""
    for dtype in ("int8", "bf16"):
        if backend.endswith("_" + dtype):
            return dtype
    return "none"
