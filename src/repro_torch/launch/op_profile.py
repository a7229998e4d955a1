"""Op records and device profiles (the port's counterpart of
``repro.launch.hlo_profile``).

The reference parses a compiled cell's optimized HLO and ranks its ops by
modeled cost.  The port has no HLO: :class:`OpCounter` is a
``TorchDispatchMode`` that records every aten op as it runs, alike on the
meta device, the CPU and the card, so a record made on ``meta`` (no
weights, no memory) is the record of the card's run, op for op.

Per op (:class:`OpEntry`): its name, the shapes and dtypes of its tensor
operands and results, FLOPs of the product family (``mm``, ``addmm``,
``bmm``, ``baddbmm``, which ``matmul`` and ``einsum`` lower to; 2·M·N·K,
by the operands' dtype), the bytes it reads and writes, and the bytes the
run has allocated and not yet freed after it.

Conventions (a lower bound a kernel of this op cannot beat):
* a tensor's bytes are those of its distinct elements (a stride-0 axis of
  a broadcast counts once);
* a view (or any op whose results all alias its operands without writing
  them, as ``_unsafe_view`` does) moves nothing;
* an op reads each tensor operand once and writes each result once, but
  ``copy_``, ``fill_``, ``zero_`` and the in-place scatters
  (``index_put_``, ...) do not read the tensor they overwrite, and a
  scatter writes only as many elements as its source holds; a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) reads the
  elements it returns and its indices, not its whole source; an
  allocation (``empty*``) reads and writes nothing, and a fill made beside a
  tensor (``zeros_like``, ``ones_like``, ``full_like``, ``new_zeros``,
  ``new_ones``, ``new_full``) reads nothing of it.

Live bytes follow storages, not tensors: a storage first made as an op's
result counts from then until it is freed, however many views hold it,
and so also while autograd keeps it saved for backward (its Python object
is kept alive with it; a ``weakref.finalize`` on it fires at the free).
Storages made before the counter started (arguments) are not counted:
callers add them (``launch.dryrun``).  Torch's own memory trackers are
not used: they are private and move between torch releases.

Over ranks (DTensors, the dry run's partitioner) the counter records
what one rank runs: each rank-local op on its local tensors, and each
collective DTensor issues (``_c10d_functional.*``, or ``c10d.*`` from
code that calls ``torch.distributed`` itself; ``_dtensor.shard_dim_alltoall``
for a shard move), once.  The DTensor-level
op at global shapes is passed on to DTensor unrecorded, and so are a
functional collective's wait and autograd wrap, and every op DTensor
runs to propagate shardings (on fake tensors, and on small index
tensors for shard offsets): it runs once per distinct op and is then
cached, so a second trace in one process would not run it
(:func:`_quiet_propagation`).

The port's CUDA kernel wrappers do not dispatch an aten op for their
launch; each reports its own operands, bytes and FLOPs to the active
counter (:data:`ACTIVE`, one ``None`` check when there is none) as an
entry named ``kernel.<name>``, on the card and alike on the meta device,
where they launch nothing: a meta record holds the kernels a card runs.

:func:`profile` ranks a record as the reference's ``profile`` ranks HLO;
:func:`device_profile` times a run on the card under ``torch.profiler``.
"""
from __future__ import annotations

import statistics
import threading
import time
import weakref
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the counter inside whose block the current code runs, else None
ACTIVE: Optional["OpCounter"] = None

try:
    from torch.distributed.tensor import DTensor as _DTENSOR
except ImportError:      # a torch without distributed support
    _DTENSOR = None

_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64", torch.int8: "int8", torch.uint8: "u8",
          torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
          torch.bool: "pred"}

# products: aten name -> index of the first product operand
_PRODUCTS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1}
# ops that overwrite their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "index_put_", "_index_put_impl_",
              "copy", "fill"}
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
# fills that read no element of their operand (its shape, dtype and device
# alone): the gradient buffers' (train_step._zeros), and ``new_*`` made
# beside a tensor
_LIKE = {"zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
         "new_full"}
# gathers read the rows they return (and their indices), not the source
_GATHER = {"index", "_unsafe_index", "index_select", "gather", "embedding",
           "take"}
# in-place scatters write as many elements as their last operand holds
_SCATTER = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
            "index_add_", "index_copy_", "masked_scatter_"}

# depth of DTensor sharding propagation on this thread (see
# _quiet_propagation)
_QUIET = threading.local()


def _quiet_propagation() -> None:
    """Mark DTensor's sharding propagation (its two entry points on the
    dispatcher's propagator, wrapped once a process, when a counter first
    meets a DTensor op) so that a counter records none of the ops it runs:
    they are not the rank's work, and they run only on a cache miss.
    Raises when this torch's dispatcher lacks either entry point."""
    dispatcher = getattr(_DTENSOR, "_op_dispatcher", None)
    if getattr(dispatcher, "_counter_quiet", False):
        return
    prop = getattr(dispatcher, "sharding_propagator", None)
    if not (callable(getattr(dispatcher,
                             "_propagate_op_sharding_dispatch_slow_path",
                             None))
            and callable(getattr(prop, "propagate", None))):
        raise RuntimeError(
            f"OpCounter cannot keep DTensor's sharding propagation out of "
            f"its record on torch {torch.__version__}: the dispatcher has "
            "no _propagate_op_sharding_dispatch_slow_path or "
            "sharding_propagator.propagate")

    def quiet(fn):
        def run(*args, **kwargs):
            depth = getattr(_QUIET, "depth", 0)
            _QUIET.depth = depth + 1
            try:
                return fn(*args, **kwargs)
            finally:
                _QUIET.depth = depth
        return run
    dispatcher._propagate_op_sharding_dispatch_slow_path = quiet(
        dispatcher._propagate_op_sharding_dispatch_slow_path)
    prop.propagate = quiet(prop.propagate)
    dispatcher._counter_quiet = True


# a functional collective's wait and autograd wrap: no work of the rank's
_BOOKKEEPING = {"_c10d_functional.wait_tensor.default",
                "_c10d_functional._wrap_tensor_autograd.default"}

Shape = Tuple[torch.Size, torch.dtype]


class OpEntry(NamedTuple):
    name: str                 # "aten.mm.default", "kernel.l2dist_rowgather"
    ins: Tuple[Shape, ...]    # (size, dtype) of each tensor operand
    outs: Tuple[Shape, ...]   # (size, dtype) of each tensor result
    flops: int
    flops_dtype: Optional[str]
    bytes_read: int
    bytes_written: int
    live_bytes: int           # allocated in the run and not freed, after

    def key(self) -> tuple:
        """What two runs of one computation must agree on: everything but
        the live bytes, which follow when the host frees."""
        return self[:7]


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE.get(dtype, str(dtype).replace("torch.", ""))


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (stride-0 axes count once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n


def _tensors(x, out: list) -> list:
    for y in x:
        if isinstance(y, torch.Tensor):
            out.append(y)
        elif isinstance(y, (list, tuple)):
            _tensors(y, out)
    return out


def _shapes(ts) -> Tuple[Shape, ...]:
    return tuple((t.shape, t.dtype) for t in ts)


def product_flops(op: str, ins: List[torch.Tensor]) -> int:
    """2·M·N·K (times the batch for ``bmm``/``baddbmm``) of a product."""
    a, b = ins[_PRODUCTS[op]], ins[_PRODUCTS[op] + 1]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class _Op(NamedTuple):
    name: str          # str(func)
    op: str            # the aten name without namespace or overload
    view: bool
    mutates: bool
    skip: int          # leading operands not read (overwritten)
    alloc: bool
    gather: bool
    scatter: bool
    c10d: bool         # a torch.distributed collective (writes its first
                       # operand when it returns no tensor)


_OPS: Dict[object, _Op] = {}


def _op(func) -> _Op:
    info = _OPS.get(func)
    if info is None:
        op = func._schema.name.split("::")[-1]
        c10d = str(func).startswith("c10d.")
        info = _OPS[func] = _Op(
            str(func), op, func.is_view,
            c10d or any(a.alias_info is not None and a.alias_info.is_write
                        for a in func._schema.arguments),
            1 if (op in _OVERWRITE or op in _SCATTER or op in _LIKE
                  or op in _ALLOC) else 0,
            op in _ALLOC,
            op in _GATHER, op in _SCATTER, c10d)
    return info


class OpCounter(TorchDispatchMode):
    """Record every aten op run inside the block (see the module's
    docstring).  ``record`` is the list of :class:`OpEntry`;
    ``peak_bytes`` the most bytes allocated inside the block and alive at
    once."""

    def __init__(self):
        super().__init__()
        self.record: List[OpEntry] = []
        self.live = 0
        self.peak_bytes = 0
        self._owned: Dict[int, int] = {}      # storage id -> bytes
        # re-entrant: a collection inside a locked block may free a
        # storage, whose finalizer takes the lock in the same thread
        self._lock = threading.RLock()
        self._outer = None

    # -- the block ----------------------------------------------------------
    def __enter__(self):
        global ACTIVE
        self._outer, ACTIVE = ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._outer
        return super().__exit__(*exc)

    # -- live bytes ---------------------------------------------------------
    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            if self._owned.pop(key, None) is not None:
                self.live -= nbytes

    def _own(self, storage) -> None:
        key = storage._cdata
        with self._lock:
            if key in self._owned:
                return
            nbytes = storage.nbytes()
            self._owned[key] = nbytes
            self.live += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(storage, self._free, key, nbytes)

    # -- recording ----------------------------------------------------------
    def _append(self, name, ins, outs, flops, fdt, nread, nwritten) -> None:
        with self._lock:
            self.record.append(OpEntry(name, _shapes(ins), _shapes(outs),
                                       flops, fdt, nread, nwritten,
                                       self.live))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(_QUIET, "depth", 0):     # sharding propagation
            return func(*args, **(kwargs or {}))
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            # DTensor runs the rank's local ops (and collectives), which
            # come back here on plain tensors
            _quiet_propagation()
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        info = _op(func)
        if info.name in _BOOKKEEPING:
            return out
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        outs = ([out] if isinstance(out, torch.Tensor)
                else _tensors(out, []) if isinstance(out, (list, tuple))
                else [])
        if info.c10d and not outs:     # it wrote its output operand
            outs = _tensors(args[:1], [])
        if info.view:
            self._append(info.name, ins, outs, 0, None, 0, 0)
            return out
        in_store = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs
                 if t.untyped_storage()._cdata not in in_store]
        for t in fresh:
            self._own(t.untyped_storage())
        if not fresh and not info.mutates:
            nread = nwritten = 0
        else:
            nwritten = (0 if info.alloc
                        else tensor_bytes(ins[-1]) if info.scatter
                        else sum(tensor_bytes(t) for t in outs))
            if info.gather:          # the source is the first operand
                nread = nwritten + sum(tensor_bytes(t) for t in ins[1:])
            else:
                nread = sum(tensor_bytes(t) for t in ins[info.skip:])
        flops, fdt = 0, None
        if info.op in _PRODUCTS:
            flops = product_flops(info.op, ins)
            fdt = dtype_name(ins[_PRODUCTS[info.op]].dtype)
        self._append(info.name, ins, outs, flops, fdt, nread, nwritten)
        return out

    def kernel(self, name: str, ins, outs, flops: int, flops_dtype: str,
               bytes_read: int, bytes_written: int) -> None:
        """A kernel wrapper's launch: ``ins``/``outs`` its tensors, the
        bytes and operations its function needs."""
        self._append(f"kernel.{name}", ins, outs, int(flops), flops_dtype,
                     int(bytes_read), int(bytes_written))

    # -- totals -------------------------------------------------------------
    def flops_by_dtype(self) -> Dict[str, int]:
        return record_flops(self.record)

    def bytes(self) -> int:
        return record_bytes(self.record)


def report_gather(name: str, table: torch.Tensor, ids: torch.Tensor,
                  queries: torch.Tensor, out: torch.Tensor, ops: int,
                  dtype: str, pair_bytes: int = 0) -> None:
    """A gather-distance kernel's launch, for the active counter: it reads
    the ids, one table row a candidate (no dedup: counting distinct rows
    would need a host sync), ``pair_bytes`` more a candidate (int8: its
    scale) and the queries, writes the (B, C) output, and does ``ops``
    operations of ``dtype`` an element of each pair."""
    b, c = ids.shape
    d = table.shape[1]
    ACTIVE.kernel(name, (table, ids, queries), (out,), b * c * d * ops,
                  dtype,
                  tensor_bytes(ids) + b * c * (d * table.element_size()
                                               + pair_bytes)
                  + tensor_bytes(queries), tensor_bytes(out))


def record_flops(record) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for e in record:
        if e.flops:
            out[e.flops_dtype] += e.flops
    return dict(out)


def record_bytes(record) -> int:
    return sum(e.bytes_read + e.bytes_written for e in record)


def _key(e) -> tuple:
    return e.key() if isinstance(e, OpEntry) else tuple(e)


def first_difference(a, b) -> Optional[str]:
    """None when two records (of :class:`OpEntry`, or of their
    :meth:`OpEntry.key`) agree op for op, else where they first
    differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        if _key(x) != _key(y):
            return f"op {i}: {_key(x)} != {_key(y)}"
    if len(a) != len(b):
        return f"{len(a)} ops != {len(b)} ops"
    return None


def profile(record, top: int = 15) -> Dict:
    """The reference's keys: products ranked by FLOPs (``top_dots``:
    (FLOPs, a line naming the op, its dtype and operand shapes)), their
    total, and the bytes each op moves (read + written) summed by op name,
    the ``top`` largest."""
    dots: List[Tuple[int, str]] = []
    bytes_by_op: Dict[str, int] = defaultdict(int)
    total = 0
    for e in record:
        bytes_by_op[e.name] += e.bytes_read + e.bytes_written
        if e.flops:
            total += e.flops
            dots.append((e.flops, f"{e.name} {e.flops_dtype} "
                         + " x ".join(str(tuple(s)) for s, _ in e.ins)))
    dots.sort(key=lambda fd: -fd[0])
    return {
        "dot_flops_total": total,
        "top_dots": dots[:top],
        "bytes_by_op": dict(sorted(bytes_by_op.items(),
                                   key=lambda kv: -kv[1])[:top]),
    }


def print_profile(record, top: int = 12) -> Dict:
    p = profile(record, top)
    print(f"total product flops: {p['dot_flops_total']:.3e}")
    print("-- top products --")
    for f, line in p["top_dots"]:
        print(f"  {f:.3e}  {line}")
    print("-- bytes moved by op --")
    for op, b in p["bytes_by_op"].items():
        print(f"  {b / 1e9:8.2f} GB  {op}")
    return p


def device_profile(run: Callable[[], object], kernel: Optional[str] = None,
                   reps: int = 3, cpu_ops: bool = True) -> Dict:
    """``run()`` on the card: its wall time (median of ``reps`` plain
    runs; with ``reps`` 0, the profiled run's), then one run under
    ``torch.profiler`` for the summed kernel time (busy), the device's
    idle share against the wall time, the kernel launches, the calls and
    mean time of the kernels whose name holds ``kernel``, and the ops that
    take the most device time (``cpu_ops`` False traces the device alone,
    which costs far less on a run of ~10^5 ops, and lists no ops).
    Without device events in the trace the device numbers read "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.append(ProfilerActivity.CPU)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_profiled = (time.perf_counter() - t0) * 1e3
    wall = float(statistics.median(walls)) if walls else wall_profiled

    # the device's events (kernels, copies, fills) straight from the
    # trace: torch's per-op event table takes far longer to build
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    busy_ms = sum(e.duration_ns() for e in device) / 1e6
    measured = busy_ms > 0
    dist = [e for e in device if kernel is not None and kernel in e.name()]
    dist_ms = sum(e.duration_ns() for e in dist) / 1e6
    dist_n = len(dist)
    ops = []
    if cpu_ops:
        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        # the aten ops that launched the kernels give the breakdown
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU and dev_us(e) > 0),
                     key=dev_us, reverse=True)
        ops = [[e.key, dev_us(e) / 1e3, e.count] for e in ops[:10]]
    return {"wall_ms": wall, "wall_ms_profiled": wall_profiled,
            "device_busy_ms": busy_ms if measured else "not measured",
            "idle_share": 1 - busy_ms / wall if measured
            else "not measured",
            "kernel_launches": len(device),
            "dist_kernel_calls": dist_n,
            "dist_kernel_mean_ms": dist_ms / dist_n if dist_n
            else "not measured",
            "top_ops_device_ms": ops}
