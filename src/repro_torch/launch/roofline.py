"""Roofline terms against one NVIDIA H100 SXM (the port's counterpart of
``repro.launch.roofline``).

Three terms per cell, in seconds:

    compute    = Σ_dtype FLOPs_dtype / (chips × PEAK_FLOPS[dtype])
    memory     = bytes / (chips × HBM_BW)
    collective = wire bytes / (chips × LINK_BW)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and its
collective bytes from the optimized HLO, against TPU v5e constants.  The
port has neither: FLOPs and bytes come from ``launch.op_profile``'s op
record (counted on the meta device or on the card), its collectives from
the ``torch.distributed`` ops in that record, and the constants below are
the H100's.  This module is their one home in the package.

Constants, per card: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column,
dense (without sparsity).  f32 is the CUDA-core rate: the port runs with
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``), so an f32
product never reaches the tensor cores.  ``LINK_BW`` is NVLink 4's 900 GB/s
a card, 450 GB/s in one direction.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

PEAK_FLOPS: Dict[str, float] = {
    "bf16": 989e12,
    "f16": 989e12,
    "f32": 67e12,
    "int8": 1979e12,
}
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction
HBM_BYTES = 80 * 10**9       # device memory of one card: what a cell must fit

# the reference's collective kinds (HLO names), the keys of collective_bytes
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# torch.distributed ops (c10d and functional collectives) -> kind
_C10D = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",       # _dtensor's, a shard move
    "send": "collective-permute", "recv_": "collective-permute",
}


def collective_kind(name: str) -> Optional[str]:
    """The collective an op of a record is (``c10d.allreduce_.default``
    -> "all-reduce"), or None."""
    space, _, rest = name.partition(".")
    if space not in ("c10d", "_c10d_functional", "_dtensor"):
        return None
    return _C10D.get(rest.split(".")[0])


def collective_bytes(record) -> Dict[str, int]:
    """Per-kind result bytes of the collectives in an op record (a list of
    ``op_profile.OpEntry``; names such as ``c10d.allreduce_.default``):
    the bytes an op writes, and for ``send``, which writes nothing, the
    bytes it reads.  A record made on one card holds none (ROADMAP.md §1
    item 8)."""
    out = {c: 0 for c in COLLECTIVES}
    for e in record:
        kind = collective_kind(e.name)
        if kind is not None:
            out[kind] += e.bytes_written or e.bytes_read
    return out


def wire_bytes(coll: Mapping[str, int]) -> int:
    """The reference's rule: result bytes are wire bytes, and an
    all-reduce (a ring's reduce-scatter and all-gather) counts twice."""
    return (2 * coll.get("all-reduce", 0) + coll.get("all-gather", 0)
            + coll.get("reduce-scatter", 0) + coll.get("all-to-all", 0)
            + coll.get("collective-permute", 0))


def roofline_terms(flops: Union[float, Mapping[str, float]],
                   bytes_accessed: float,
                   coll: Optional[Mapping[str, int]], chips: int) -> Dict:
    """The reference's keys.  ``flops`` is a number (bf16) or a dict by
    dtype; ``coll`` None means the collectives were not counted (no
    partitioner): ``t_collective_s`` and ``collective_wire_bytes`` are
    None and ``dominant`` is chosen from compute and memory."""
    if not isinstance(flops, Mapping):
        flops = {"bf16": flops}
    t_compute = sum(f / (chips * PEAK_FLOPS[dt]) for dt, f in flops.items())
    t_memory = bytes_accessed / (chips * HBM_BW)
    terms = [("compute", t_compute), ("memory", t_memory)]
    wire = t_coll = None
    if coll is not None:
        wire = wire_bytes(coll)
        t_coll = wire / (chips * LINK_BW)
        terms.append(("collective", t_coll))
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": max(terms, key=lambda kv: kv[1])[0],
        "collective_wire_bytes": wire,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train), 2·N·D (prefill) with N the active
    parameters (MoE: per token); decode D = one new token a sequence."""
    n = cfg.active_param_count()
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch
