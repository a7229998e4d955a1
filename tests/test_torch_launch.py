"""The port's launch tools: ``repro_torch.launch.roofline`` against
``repro.launch.roofline``, the op counter of ``launch.op_profile``
against ``torch.utils.flop_counter`` and closed forms, op records on the
meta device against the CPU's, and the meta device's trees against
``jax.eval_shape`` of the reference's init.  The smoke configs keep it
small (~15 s on one worker)."""
import dataclasses
import gc
import hashlib

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.config import ALL_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_rl
from repro.models import build_model as ref_build_model
from repro.sharding import keystr_simple as ref_keystr
from repro_torch.config import ALL_SHAPES, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_profile import (OpCounter, OpEntry,
                                           first_difference, profile,
                                           record_bytes, record_flops,
                                           tensor_bytes)
from repro_torch.models import build_model
from repro_torch.treepath import flatten_with_path, keystr_simple

# one smoke config of every family
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "vlm": "qwen2-vl-7b",
                "moe": "qwen3-moe-30b-a3b", "ssm": "mamba2-2.7b",
                "hybrid": "zamba2-7b", "encdec": "whisper-large-v3"}
PREFILL = ShapeConfig("prefill_smoke", 16, 2, "prefill")
DECODE = ShapeConfig("decode_smoke", 32, 2, "decode")
TRAIN = ShapeConfig("train_smoke", 16, 4, "train")


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_h100_constants_pinned():
    assert rl.PEAK_FLOPS["bf16"] == 989e12
    assert rl.PEAK_FLOPS["f32"] == 67e12
    assert rl.PEAK_FLOPS["int8"] == 1979e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9
    assert rl.HBM_BYTES == 80 * 10**9


def test_roofline_terms_dominance():
    # compute: 989e12 bf16 flops on one card is 1 s, 1 GB of bytes 0.3 ms
    t = rl.roofline_terms(989e12, 1e9, {}, 1)
    assert t["dominant"] == "compute" and t["t_compute_s"] == 1.0
    t = rl.roofline_terms(1.0, 3.35e12, {"all-reduce": 1}, 2)
    assert t["dominant"] == "memory" and t["t_memory_s"] == 0.5
    # the reference's wire rule: an all-reduce counts twice
    t = rl.roofline_terms(1.0, 1.0, {"all-reduce": 450e9,
                                     "all-gather": 450e9}, 1)
    assert t["dominant"] == "collective"
    assert t["collective_wire_bytes"] == 3 * 450e9
    assert t["t_collective_s"] == 3.0
    # a dtype split: 67e12 f32 flops take as long as 989e12 bf16 ones
    t = rl.roofline_terms({"bf16": 989e12, "f32": 67e12}, 5e12, None, 1)
    assert t["t_compute_s"] == 2.0 and t["dominant"] == "compute"
    assert t["t_collective_s"] is None
    assert t["collective_wire_bytes"] is None
    t = rl.roofline_terms({"f32": 67e12}, 6.7e12, None, 1)
    assert t["dominant"] == "memory"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_reference(arch):
    ref_shapes = {s.name: s for s in REF_SHAPES}
    for shape in ALL_SHAPES:
        assert rl.model_flops(get_config(arch), shape) == \
            ref_rl.model_flops(ref_get_config(arch), ref_shapes[shape.name])


def test_collective_bytes_counts_all_reduce_twice():
    def entry(name, nread, nwritten):
        return OpEntry(name, (), (), 0, None, nread, nwritten, 0)
    record = [entry("c10d.allreduce_.default", 64, 64),
              entry("_c10d_functional.all_gather_into_tensor.default",
                    16, 128),
              entry("c10d.send.default", 32, 0),
              entry("aten.mm.default", 8, 8)]
    coll = rl.collective_bytes(record)
    assert coll == {"all-reduce": 64, "all-gather": 128,
                    "reduce-scatter": 0, "all-to-all": 0,
                    "collective-permute": 32}
    assert rl.wire_bytes(coll) == 2 * 64 + 128 + 32
    assert rl.collective_bytes(record[3:]) == dict.fromkeys(coll, 0)


# ---------------------------------------------------------------------------
# the op counter
# ---------------------------------------------------------------------------

def _cell(arch, shape, device, microbatches=2):
    cfg = get_smoke_config(arch)
    tcfg = dataclasses.replace(dryrun.train_config_for(cfg),
                               microbatches=microbatches)
    model = build_model(cfg, device=device)
    gen = (torch.Generator(device="cpu").manual_seed(0)
           if device == "cpu" else None)
    args = dryrun.cell_arguments(model, cfg, shape, tcfg, generator=gen)
    return model, cfg, tcfg, args


def _counted(arch, shape, device):
    model, cfg, tcfg, args = _cell(arch, shape, device)
    return dryrun.trace(model, cfg, shape, tcfg, args)["counter"]


@pytest.mark.parametrize("shape", [PREFILL, DECODE, TRAIN],
                         ids=lambda s: s.kind)
def test_counter_flops_equal_flop_counter_mode(shape):
    model, cfg, tcfg, args = _cell("qwen2.5-3b", shape, "cpu")
    step = dryrun.cell_step(model, cfg, shape, tcfg)
    with OpCounter() as counter:
        step(args)
    model, cfg, tcfg, args = _cell("qwen2.5-3b", shape, "cpu")
    step = dryrun.cell_step(model, cfg, shape, tcfg)
    fc = FlopCounterMode(display=False)
    with fc:
        step(args)
    assert sum(counter.flops_by_dtype().values()) == fc.get_total_flops()
    assert profile(counter.record)["dot_flops_total"] == \
        fc.get_total_flops()


def test_counter_flops_closed_form_dense_prefill():
    """Projections and MLP in bf16 over every token, QKᵀ and PV in f32
    over the full S × S (the port materializes masked scores), the head
    in bf16 at the last position only."""
    cfg = get_smoke_config("qwen2.5-3b")
    b, s = PREFILL.global_batch, PREFILL.seq_len
    t, d, hd = b * s, cfg.d_model, cfg.resolved_head_dim
    h, kv, f, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    layer = 2 * t * d * (2 * h * hd + 2 * kv * hd) + 3 * 2 * t * d * f
    bf16 = cfg.num_layers * layer + 2 * b * d * v
    f32 = cfg.num_layers * 2 * (2 * b * h * s * s * hd)
    counter = _counted("qwen2.5-3b", PREFILL, "meta")
    assert counter.flops_by_dtype() == {"bf16": bf16, "f32": f32}


CASES = ([(fam, PREFILL) for fam in FAMILY_ARCHS]
         + [(fam, DECODE) for fam in FAMILY_ARCHS] + [("dense", TRAIN)])


@pytest.mark.parametrize("family,shape", CASES,
                         ids=[f"{f}-{s.kind}" for f, s in CASES])
def test_meta_record_equals_cpu_record(family, shape):
    arch = FAMILY_ARCHS[family]
    cpu = _counted(arch, shape, "cpu")
    meta = _counted(arch, shape, "meta")
    assert len(cpu.record) > 100
    assert first_difference(cpu.record, meta.record) is None
    assert record_flops(cpu.record) == record_flops(meta.record)
    assert record_bytes(cpu.record) == record_bytes(meta.record)
    assert cpu.peak_bytes == meta.peak_bytes > 0


def test_live_bytes_follow_storages_views_and_saved_tensors():
    x = torch.ones(1024, requires_grad=True)      # an argument: not counted
    with OpCounter() as c:
        y = x.exp()                 # 4 KB, saved by exp for its backward
        v = y[:10]                  # a view: no bytes of its own
        z = (v * 2).sum()           # v * 2 (40 B) is freed at once
        assert c.live == 4096 + 4 and c.peak_bytes == 4096 + 40 + 4
        del y, v
        gc.collect()
        assert c.live == 4096 + 4   # autograd keeps exp's output
        z.backward()
        del z
        gc.collect()
        assert c.live == 4096       # x.grad alone
    assert x.grad is not None and c.peak_bytes > 3 * 4096
    views = [e for e in c.record if e.name == "aten.slice.Tensor"]
    assert views and all(e.bytes_read == e.bytes_written == 0
                         for e in views)


def test_tensor_bytes_counts_a_broadcast_once():
    t = torch.ones(3, 1).expand(3, 1000)
    assert tensor_bytes(t) == 12
    assert tensor_bytes(torch.ones(2, 5)[:, :2]) == 16


FILLS = {"zeros_like": lambda x: torch.zeros_like(x),
         "ones_like": lambda x: torch.ones_like(x),
         "full_like": lambda x: torch.full_like(x, 2.0),
         "new_zeros": lambda x: x.new_zeros((3,)),
         "new_ones": lambda x: x.new_ones((3,)),
         "new_full": lambda x: x.new_full((3,), 2.0),
         "empty_like": lambda x: torch.empty_like(x),
         "new_empty": lambda x: x.new_empty((3,))}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("fill", sorted(FILLS))
def test_fill_beside_a_tensor_reads_nothing_of_it(fill, device):
    """A fill or an allocation made beside a tensor takes its shape, dtype
    and device, not its elements: it reads nothing, and writes its result
    (a fill) or nothing (an allocation)."""
    x = torch.empty(1000, 1000, device=device)
    with OpCounter() as c:
        out = FILLS[fill](x)
    (e,) = c.record
    assert e.bytes_read == 0
    assert e.bytes_written == (0 if "empty" in fill else tensor_bytes(out))


def _meta_launch(name):
    """Kernel ``name``'s wrapper on meta operands (b 4, c 32, d 96, N 100;
    the sort (4, 64)): (its call, its entry's FLOPs)."""
    from repro_torch.kernels.bitonic import sort_pairs
    from repro_torch.kernels.dedup import dedupdist, dedupdist_int8
    from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather
    from repro_torch.quant.kernels import int8dist_rowgather
    m, (n, d, b, c) = "meta", (100, 96, 4, 32)
    table = torch.empty(n, d, dtype=torch.bfloat16, device=m)
    codes = torch.empty(n, d, dtype=torch.int8, device=m)
    scales = torch.empty(n, 1, device=m)
    ids = torch.empty(b, c, dtype=torch.int32, device=m)
    q = torch.empty(b, d, device=m)
    keys, p0 = (torch.empty(b, 64, device=m),
                torch.empty(b, 64, dtype=torch.int32, device=m))
    return {"l2dist_rowgather": (lambda: l2dist_rowgather(table, ids, q),
                                 b * c * d * 3),
            "l2dist_dma": (lambda: l2dist_dma(table, ids, q), b * c * d * 3),
            "dedupdist": (lambda: dedupdist(table, ids, q), b * c * d * 3),
            "int8dist_rowgather": (
                lambda: int8dist_rowgather(codes, scales, ids, q),
                b * c * d * 4),
            "dedupdist_int8": (lambda: dedupdist_int8(codes, scales, ids, q),
                               b * c * d * 4),
            "sort_pairs": (lambda: sort_pairs(keys, p0, p0.clone()),
                           b * 32 * 21 * 2)}[name]


@pytest.mark.parametrize("name", ["l2dist_rowgather", "l2dist_dma",
                                  "dedupdist", "int8dist_rowgather",
                                  "dedupdist_int8", "sort_pairs"])
def test_kernel_wrapper_on_meta_reports_its_launch(name):
    """On the meta device (the dry run's trace) a kernel's wrapper makes
    its outputs and reports its launch to the counter as on a card, with
    its FLOPs, and launches nothing."""
    from repro_torch.kernels import _cuda
    call, flops = _meta_launch(name)
    before = dict(_cuda.LAUNCHES)
    with OpCounter() as c:
        out = call()
    (e,) = [e for e in c.record if e.name.startswith("kernel.")]
    assert e.name == f"kernel.{name}" and e.flops == flops
    assert e.bytes_read > 0 and e.bytes_written > 0
    assert dict(_cuda.LAUNCHES) == before
    assert all(t.device.type == "meta"
               for t in (out if isinstance(out, tuple) else (out,)))


# ---------------------------------------------------------------------------
# models on the meta device
# ---------------------------------------------------------------------------

def _ref_tree(arch):
    model = ref_build_model(ref_get_config(arch))
    sds = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return {ref_keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(sds)[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_tree_equals_reference_eval_shape(arch):
    tree = build_model(get_config(arch), device="meta").init_tree()
    ours = {keystr_simple(p): (tuple(t.shape),
                               str(t.dtype).replace("torch.", ""))
            for p, t in flatten_with_path(tree)}
    assert all(t.device.type == "meta" for _, t in flatten_with_path(tree))
    assert ours == _ref_tree(arch)


# sha256 of the seed-0 CPU trees, computed before the meta device's init
# existed: the draws on the CPU must not change a bit
TREE_SHA256 = {
    "qwen2.5-3b":
        "2a182055b112dd680db3ae8d6c6d4c4d423a278893fc1ed0913ba31d103cd252",
    "mamba2-2.7b":
        "b87b9f94cd83b279c88c57cb201436ca4a1401d9f3917ef311bace204bea7b46",
}


@pytest.mark.parametrize("arch", sorted(TREE_SHA256))
def test_seeded_cpu_draws_unchanged(arch):
    model = build_model(get_smoke_config(arch), device="cpu")
    tree = model.init_tree(torch.Generator(device="cpu").manual_seed(0))
    h = hashlib.sha256()
    for path, t in flatten_with_path(tree):
        h.update("/".join(map(str, path)).encode())
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == TREE_SHA256[arch]


def test_meta_model_takes_no_generator_and_cpu_model_needs_one():
    model = build_model(get_smoke_config("qwen2.5-3b"), device="meta")
    assert model.init().embedding.device.type == "meta"
    with pytest.raises(ValueError, match="generator"):
        build_model(get_smoke_config("qwen2.5-3b"), device="cpu").init()
    with pytest.raises(ValueError, match="generator"):
        model.init_tree(torch.Generator(device="cpu"))
