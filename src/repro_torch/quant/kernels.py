"""Quantized distance backends (port of ``repro.quant.kernels``).

Batch-major ``DistFn``s ((B, M, R) ids in, (B, M, R) f32 distances out, one
call per global step) that read the index's quantized table
(``PaddedCSR.codes`` + ``.scales``) instead of the float32 ``vectors``:

* ``ref_int8``       — plain torch; per-vector scales take the integer path
  (int32-accumulated dot against integer query codes on the widest grid
  that cannot overflow, ONE f32 rescale per candidate, :func:`int8dist_ref`);
  per-dimension scales dequantize the gathered rows and reduce in f32;
* ``rowgather_int8`` — ``csrc/rowgather_int8.cu``, eight lanes per candidate
  and 32 candidates a block, laid out by :func:`rowgather_int8_plan`
  (per-vector scales only: the integer path is the point of the kernel);
* ``ref_bf16``       — plain torch bf16 gather, f32 reduction.

"l2" is ``max(s²·‖c‖² − 2·s·s_q·(c·c_q) + ‖q‖², 0)`` with the exact f32
query norm, "ip"/"cosine" is ``−s·s_q·(c·c_q)``; ids >= N give +inf.  The
query side (codes, scale, ‖q‖²) comes from ONE helper, :func:`query_meta`,
for the plain version and both kernels, so every backend sees the same bits;
the kernel DistFns keep it per queries tensor (:class:`QueryMetaMemo`; per
call for tensors made under ``torch.inference_mode()``).
The integer sums are exact in any order and the float epilogue is rounded
op by op in the reference's order, so the kernels equal the plain version
bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.registry import register_backend
from repro_torch.quant.codec import quantize_query


def require_codes(graph, dtype: str):
    """The graph's ``dtype`` codes table and scales; raises with build
    guidance when the index carries none or another dtype."""
    codes, scales = getattr(graph, "codes", None), getattr(graph, "scales",
                                                           None)
    if codes is None or codes.numel() == 0:
        raise ValueError(
            f"the '{dtype}' distance backends need a quantized table; "
            f"build the index with IndexSpec(quant=\"{dtype}\")")
    want = torch.int8 if dtype == "int8" else torch.bfloat16
    if codes.dtype != want:
        raise ValueError(
            f"index is quantized as {codes.dtype}, not {dtype}; pick the "
            f"matching backend or rebuild with IndexSpec(quant=\"{dtype}\")")
    return codes, scales


def _kmetric(metric: str) -> str:
    if metric in ("ip", "cosine"):
        return "ip"
    if metric == "l2":
        return "l2"
    raise ValueError(f"unknown metric {metric!r}")


def query_meta(queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, d) queries -> (query codes int32 (B, d), scale f32 (B, 1),
    ‖q‖² f32 (B, 1)), as the reference prepares them once per call."""
    qf = queries.float()
    qc, qs = quantize_query(qf)
    q2 = torch.sum(qf * qf, dim=-1, keepdim=True)
    return qc.contiguous(), qs.contiguous(), q2.contiguous()


def query_side(queries: torch.Tensor, qmeta=None):
    """``qmeta`` (a :func:`query_meta` of ``queries`` the caller kept) after
    a check of its shape and device, or a fresh :func:`query_meta`."""
    if qmeta is None:
        return query_meta(queries)
    qc = qmeta[0]
    if qc.shape != queries.shape or qc.device != queries.device:
        raise ValueError(f"qmeta codes {tuple(qc.shape)} on {qc.device} do "
                         f"not match queries {tuple(queries.shape)} on "
                         f"{queries.device}")
    return qmeta


class QueryMetaMemo:
    """``queries -> query_meta(queries)``, recomputed only for another
    tensor or for the same one changed in place.  The DistFns hold one: a
    search hands every step the same queries tensor (speedann a new one per
    global step), so the query side is quantized once per tensor, not once
    per call.  The last tensor is held, so its memory cannot be reused by
    another tensor at the same address, and its ``_version`` counts its
    in-place writes.  A tensor made under ``torch.inference_mode()`` has no
    version counter, so nothing tells that it was not changed in place: its
    query side is computed on every call.

    Safe across threads (a DistFn may serve searches on several): the
    tensor, its version and its query side are one tuple, replaced in one
    assignment and read once into a local, so a call returns either the
    held query side of its own tensor or one it computed itself."""

    def __init__(self):
        self._held = (None, -1, None)      # (queries, _version, meta)

    def __call__(self, queries: torch.Tensor):
        if queries.is_inference():
            return query_meta(queries)
        version = queries._version
        held_q, held_v, meta = self._held
        if held_q is queries and held_v == version:
            return meta
        meta = query_meta(queries)
        self._held = (queries, version, meta)
        return meta


def int8_epilogue(acc: torch.Tensor, rn2: torch.Tensor, s: torch.Tensor,
                  qs: torch.Tensor, q2: torch.Tensor,
                  kmetric: str) -> torch.Tensor:
    """The one f32 rescale, each op rounded on its own, in the reference's
    order: ``xq = (s·qs)·acc``; ip -> ``−xq``; l2 ->
    ``max(((s·s)·rn2 − 2·xq) + q2, 0)``."""
    xq = s * qs * acc.float()
    if kmetric == "ip":
        return -xq
    return torch.clamp(s * s * rn2.float() - 2.0 * xq + q2, min=0.0)


def int8dist_ref(codes: torch.Tensor, scales: torch.Tensor,
                 ids: torch.Tensor, queries: torch.Tensor,
                 metric: str = "l2", *, qmeta=None) -> torch.Tensor:
    """Plain version of the int8 kernels: (N, d) int8 codes, (N, 1)
    per-vector scales, (B, C) int32 ids, (B, d) f32 queries -> (B, C) f32.
    Ids >= N give +inf; negative ids read row 0, as the kernels do.  The
    int32 dot is an elementwise product summed over d (exact: no int32
    overflow by ``codec.query_levels``).  ``qmeta``: a kept
    :func:`query_meta` of ``queries``."""
    kmetric = _kmetric(metric)
    n = codes.shape[0]
    safe = ids.long().clamp(0, n - 1)
    rows = codes[safe].to(torch.int32)                     # (B, C, d)
    qc, qs, q2 = query_side(queries, qmeta)
    acc = torch.sum(rows * qc[:, None, :], dim=-1, dtype=torch.int32)
    rn2 = torch.sum(rows * rows, dim=-1, dtype=torch.int32)
    d = int8_epilogue(acc, rn2, scales[safe, 0], qs, q2, kmetric)
    return torch.where(ids < n, d, float("inf"))


def _check_per_vector(kernel: str, codes: torch.Tensor,
                      scales: torch.Tensor) -> None:
    if scales.shape != (codes.shape[0], 1):
        raise ValueError(
            f"{kernel} needs per-vector scales of shape ({codes.shape[0]}, "
            f"1), got {tuple(scales.shape)}; per-dimension scales are "
            f"served by the 'ref_int8' backend")


INT8_ROWS = 32               # kRows: candidates of a block of 256 threads
INT8_SMEM_BUDGET = 96 * 1024  # query codes of one block


class Int8Plan(NamedTuple):
    """Launch layout of ``csrc/rowgather_int8.cu``: a 1-D grid of
    ``blocks`` = ``slices`` × (groups of queries) blocks of 256 threads;
    block k takes the (k % slices)-th ``slice`` consecutive candidates of
    each of the ``queries`` consecutive queries of group k // slices
    (``slice * queries <= INT8_ROWS`` candidates, 8 lanes each), and
    ``smem`` bytes of dynamic shared memory for their int32 query codes."""
    blocks: int
    slices: int
    slice: int
    queries: int
    smem: int


def rowgather_int8_plan(b: int, c: int, d: int) -> Int8Plan:
    """The ``rowgather_int8`` kernel's layout for (B, C) candidates of a
    (N, d) codes table: slices of 32 candidates of one query, or, for
    C < 32, whole rows of as many queries as 32 candidates hold (fewer
    where their query codes would pass :data:`INT8_SMEM_BUDGET`), so that
    a block's ids are one contiguous span.  The grid is 1-D, so no grid
    dimension limits B."""
    if b < 1 or c < 1 or d < 1:
        raise ValueError(f"int8dist_rowgather: empty launch B={b}, C={c}, "
                         f"d={d}")
    sl = min(c, INT8_ROWS)
    qpb = max(1, min(INT8_ROWS // sl, b, INT8_SMEM_BUDGET // (4 * d)))
    smem = 4 * d * qpb
    if smem > _cuda.SMEM_MAX:
        raise ValueError(f"int8dist_rowgather: d = {d} query codes do not "
                         f"fit a block's shared memory")
    slices = -(-c // sl)
    return Int8Plan(slices * -(-b // qpb), slices, sl, qpb, smem)


def int8dist_rowgather(codes: torch.Tensor, scales: torch.Tensor,
                       ids: torch.Tensor, queries: torch.Tensor, *,
                       metric: str = "l2", qmeta=None) -> torch.Tensor:
    """Eight lanes per candidate over int8 code rows, laid out by
    :func:`rowgather_int8_plan`; see ``csrc/rowgather_int8.cu``.
    ``qmeta``: a kept :func:`query_meta` of ``queries`` (computed here
    otherwise).  CPU tensors take :func:`int8dist_ref`."""
    _check_per_vector("int8dist_rowgather", codes, scales)
    _cuda.check_int8_inputs("int8dist_rowgather", codes, scales, ids,
                            queries)
    kmetric = _kmetric(metric)
    if codes.device.type == "cpu":
        return int8dist_ref(codes, scales, ids, queries, metric, qmeta=qmeta)
    qc, qs, q2 = query_side(queries, qmeta)
    out = torch.empty(ids.shape, dtype=torch.float32, device=codes.device)
    if out.numel():
        plan = rowgather_int8_plan(ids.shape[0], ids.shape[1],
                                   codes.shape[1])
        _cuda.launch("rowgather_int8", "int8dist_rowgather",
                     codes, codes.shape[0], codes.shape[1], scales, ids,
                     ids.shape[0], ids.shape[1], qc, qs, q2, out,
                     int(kmetric == "ip"), _cuda.int8_vec_ok(codes, qc),
                     plan.blocks, plan.slices, plan.slice, plan.queries,
                     plan.smem)
    return out


# ---------------------------------------------------------------------------
# batch-major DistFns
# ---------------------------------------------------------------------------

def make_int8_dist_fn(metric: str = "l2"):
    """Batch-major ``ref_int8`` DistFn: the integer path for per-vector
    scales, dequantize-and-reduce for per-dimension scales."""
    kmetric = _kmetric(metric)

    def dist_fn(graph, active_ids, nbr_ids, queries):
        codes, scales = require_codes(graph, "int8")
        b, m, r = nbr_ids.shape
        flat = nbr_ids.reshape(b, m * r)
        if scales.shape[0] == 1:                           # per-dimension
            n = graph.n_nodes
            x = codes[flat.long().clamp(0, n - 1)].float() * scales
            qf = queries.float()[:, None, :]
            if kmetric == "ip":
                d = -torch.sum(x * qf, dim=-1)
            else:
                d = torch.sum((x - qf) ** 2, dim=-1)
            d = torch.where(flat < n, d, float("inf"))
        else:
            d = int8dist_ref(codes, scales, flat, queries, kmetric)
        return d.reshape(b, m, r)
    return dist_fn


def make_bf16_dist_fn(metric: str = "l2"):
    """Batch-major ``ref_bf16`` DistFn: half-width gather, f32 reduction."""
    kmetric = _kmetric(metric)

    def dist_fn(graph, active_ids, nbr_ids, queries):
        codes, _ = require_codes(graph, "bf16")
        b, m, r = nbr_ids.shape
        d = _ref.dist_ref(codes, nbr_ids.reshape(b, m * r), queries,
                          kmetric)
        return d.reshape(b, m, r)
    return dist_fn


def make_rowgather_int8_dist_fn(metric: str = "l2"):
    """Batch-major ``rowgather_int8`` DistFn: the whole (B, M·R) candidate
    grid in ONE kernel launch, the query side once per queries tensor
    (:class:`QueryMetaMemo`)."""
    qmeta = QueryMetaMemo()

    def dist_fn(graph, active_ids, nbr_ids, queries):
        codes, scales = require_codes(graph, "int8")
        if scales.shape[0] == 1:
            raise NotImplementedError(
                "rowgather_int8 implements the per-vector-scale integer "
                "path; per-dimension scales are served by 'ref_int8'")
        b, m, r = nbr_ids.shape
        d = int8dist_rowgather(codes, scales,
                               nbr_ids.reshape(b, m * r).contiguous(),
                               queries.contiguous(), metric=metric,
                               qmeta=qmeta(queries))
        return d.reshape(b, m, r)
    return dist_fn


def _cfg_metric(cfg) -> str:
    return getattr(cfg, "metric", "l2") or "l2"


@register_backend("ref_int8")
def _ref_int8_backend(cfg):
    return make_int8_dist_fn(_cfg_metric(cfg))


@register_backend("rowgather_int8")
def _rowgather_int8_backend(cfg):
    return make_rowgather_int8_dist_fn(_cfg_metric(cfg))


@register_backend("ref_bf16")
def _ref_bf16_backend(cfg):
    return make_bf16_dist_fn(_cfg_metric(cfg))
