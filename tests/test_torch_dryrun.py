"""The port's dry runs on the meta device: ``repro_torch.launch.dryrun``
(its CLI on smoke configs, the bytes a card of the production mesh holds
against ``repro.sharding.param_specs`` on an abstract mesh) and
``launch.dryrun_ann`` (its byte counts against small CPU indexes)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.sharding import param_specs as ref_param_specs
from repro_torch.config import SHAPES_BY_NAME
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.distributed import make_search_mesh
from repro_torch.launch import dryrun, dryrun_ann
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model


def _abstract_mesh(shape, names):
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:            # jax <= 0.4: ((name, size), ...)
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def test_production_mesh_layouts():
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert single.device.type == multi.device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_card_parameter_bytes_equal_reference(arch):
    sds = jax.eval_shape(ref_build_model(ref_get_config(arch)).init,
                         jax.random.PRNGKey(0))
    tree = build_model(get_config(arch), device="meta").init_tree()
    for multi in (False, True):
        shape = (2, 16, 16) if multi else (16, 16)
        names = ("pod", "data", "model") if multi else ("data", "model")
        sizes = dict(zip(names, shape))
        specs = ref_param_specs(sds, _abstract_mesh(shape, names))
        want = 0
        for x, spec in zip(jax.tree.leaves(sds), jax.tree.leaves(
                specs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))):
            n = int(np.prod(x.shape)) * x.dtype.itemsize
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    if a is not None:
                        n //= sizes[a]
            want += n
        got = dryrun.per_card_bytes({"params": tree, "batch": {}},
                                    make_production_mesh(multi, "meta"))
        assert got == want


def test_ann_bytes_equal_small_cpu_indexes():
    idx = dryrun_ann.make_corpus(1000, 3, seed=0, device="cpu", d=8, r=5)
    assert dryrun.tree_bytes(idx) == dryrun_ann.corpus_bytes(1000, 3, 8, 5)
    assert idx.vectors.dtype == torch.bfloat16
    assert int(idx.vectors.abs().max()) <= 8
    assert int(idx.nbrs.max()) < 1000 and int(idx.nbrs.min()) >= 0
    g = dryrun_ann.make_graph(700, seed=0, device="cpu", d=8, r=5)
    assert dryrun.tree_bytes(g) == dryrun_ann.graph_bytes(700, 8, 5)
    assert g.n_nodes == 700 and g.degree == 5
    assert torch.equal(g.vectors, dryrun_ann.make_graph(
        700, seed=0, device="cpu", d=8, r=5).vectors)
    # the production cells: a card holds one 48M-row shard
    assert dryrun_ann.corpus_bytes(dryrun_ann.N_SHARD, 1) == \
        13_824_000_000 + 8
    for name, (kind, multi) in dryrun_ann.CELLS.items():
        m = dryrun_ann.per_card(kind, multi)["memory"]
        share = (dryrun_ann.corpus_bytes() if kind == "corpus"
                 else dryrun_ann.graph_bytes())
        assert m["index_bytes"] == share
        assert m["query_bytes"] == 64 * 96 * 4
        assert m["visited_bytes"] == 64 * (1 << 16) * 4


def test_ann_share_searches_equal_through_rowgather_and_ref(monkeypatch):
    """One card's share of each cell, at a small size on the CPU (the
    wrappers take their plain versions there; 2**10-slot visited tables
    in place of the cells' 2**16 keep it quick)."""
    for name in ("CFG", "CORPUS_CFG"):
        monkeypatch.setattr(dryrun_ann, name,
                            getattr(dryrun_ann, name).with_(hash_bits=10))
    q = dryrun_ann.make_queries(4, seed=0, device="cpu")
    for kind, index, mesh in (
            ("corpus", dryrun_ann.make_corpus(600, 1, 0, "cpu"),
             make_search_mesh((1, 1), device="cpu")),
            ("walker", dryrun_ann.make_graph(3000, 0, "cpu"),
             make_search_mesh((1, 16), device="cpu"))):
        share = {"index": index, "queries": q, "mesh": mesh}
        a = dryrun_ann.search(kind, share, "ref")
        b = dryrun_ann.search(kind, share, "rowgather")
        assert a[0].shape == (4, 10) and bool((a[0] >= 0).all())
        assert dryrun_ann._same(a, b)


ANN_KEYS = {"mesh", "chips", "memory", "queries_per_card", "status",
            "compile_s", "ops", "hlo_flops", "flops_by_dtype", "hlo_bytes",
            "collectives", "port_only_collectives", "loop_trips", "backend",
            "fits", "t_compute_s", "t_memory_s", "t_collective_s",
            "dominant", "collective_wire_bytes"}


def test_ann_cli_partitions_the_four_cells(tmp_path):
    """Each cell as rank 0 of the counting group on its production mesh:
    the reference's keys, the loop caps, one card's index bytes as
    counted, and the walker cell's collectives those of one global round:
    CheckMetrics' all-reduces (u_sum and any_work stacked, then comps),
    the gather of the 16 walkers' queues and of their hash tables, and
    the port's own gather of the answer over ``data``."""
    out = tmp_path / "ann.json"
    assert dryrun_ann.main(["--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert sorted(res) == sorted(dryrun_ann.CELLS)
    rows, k = 64, dryrun_ann.PARAMS.k
    for name, (kind, multi) in dryrun_ann.CELLS.items():
        row = res[name]
        assert set(row) == ANN_KEYS, name
        assert row["loop_trips"] == {"global_rounds": 12, "local_steps": 8,
                                     "max_steps": 64}
        chips = row["chips"]
        assert chips == (512 if multi else 256)
        base = dryrun_ann.per_card(kind, multi)["memory"]
        m = row["memory"]
        for key in ("index_bytes", "query_bytes", "visited_bytes"):
            assert m[key] == base[key], (name, key)
        assert m["query_bytes_passed"] == 1024 * 96 * 4
        assert m["peak_bytes"] == m["argument_bytes"] + \
            m["trace_peak_bytes"]
        coll = {c: v // chips for c, v in row["collectives"].items()}
        port = row["port_only_collectives"]["all-gather"] // chips
        if kind == "walker":
            queues = 16 * rows * 128 * (4 + 4 + 1)
            tables = 16 * rows * (1 << 16) * 4
            assert queues + tables == 269_615_104
            assert port == 16 * rows * (2 * k + 8) * 4
            assert coll["all-gather"] == queues + tables + port
            assert coll["all-reduce"] == 3 * rows * 4 == 768
        else:
            assert port == 16 * rows * k * 8
            assert coll["all-gather"] == 16 * rows * k * 8 + port
            assert coll["all-reduce"] == 0
        assert coll["all-to-all"] == coll["reduce-scatter"] == 0
        assert row["t_collective_s"] > 0 and row["hlo_bytes"] > 0
        # the distance kernel reports its FLOPs on meta, as on a card
        assert row["hlo_flops"] == row["flops_by_dtype"]["f32"] > 0
        assert row["t_compute_s"] > 0


REF_KEYS = {"arch", "shape", "mesh", "chips", "trace_s", "flops",
            "flops_by_dtype", "bytes", "collectives", "memory",
            "model_flops", "useful_flops_ratio", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant",
            "collective_wire_bytes", "status", "fits", "reason", "ops"}
FAMILY_CELLS = [("qwen2.5-3b", "train_4k"), ("qwen2-vl-7b", "prefill_32k"),
                ("qwen3-moe-30b-a3b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"), ("zamba2-7b", "decode_32k"),
                ("whisper-large-v3", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_dryrun_cli_writes_reference_keys(arch, shape, tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--smoke", "--arch", arch, "--shape", shape,
                        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert sorted(res) == [f"{arch}|{shape}|{m}" for m in
                           ("16x16", "1xh100", "2x16x16")]
    cfg = get_smoke_config(arch)
    assert cfg.family in dryrun.PARTITIONED
    for key, row in res.items():
        assert set(row) == REF_KEYS, key
        assert row["status"] == "ok" and row["flops"] > 0
        if key.endswith("1xh100"):
            assert row["t_collective_s"] is None
            assert row["collectives"] is None
            assert row["dominant"] in ("compute", "memory")
    one = res[f"{arch}|{shape}|1xh100"]
    assert one["chips"] == 1 and isinstance(one["fits"], bool)
    mem = one["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + \
        mem["trace_peak_bytes"]
    wide = res[f"{arch}|{shape}|16x16"]
    assert wide["chips"] == 256
    assert 0 < wide["memory"]["argument_bytes"] <= mem["argument_bytes"]
    # the partitioner: one rank's collectives and peak, its local shards'
    # bytes those the mesh's specs give a card
    model = build_model(cfg, device="meta")
    tcfg = dryrun.train_config_for(cfg)
    args = dryrun.cell_arguments(model, cfg, SHAPES_BY_NAME[shape], tcfg)
    for name, multi in (("16x16", False), ("2x16x16", True)):
        row = res[f"{arch}|{shape}|{name}"]
        assert row["collectives"] is not None
        assert any(v > 0 for v in row["collectives"].values())
        assert row["t_collective_s"] is not None
        assert row["t_collective_s"] > 0 and row["reason"] is None
        m = row["memory"]
        assert m["peak_bytes"] == m["argument_bytes"] + \
            m["trace_peak_bytes"]
        assert isinstance(row["fits"], bool)
        assert m["argument_bytes"] == dryrun.per_card_bytes(
            args, make_production_mesh(multi, "meta"))
    # a rerun keeps what is cached
    assert dryrun.main(["--smoke", "--arch", arch, "--shape", shape,
                        "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == res


def test_dryrun_cli_records_documented_skips(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--smoke", "--shape", "long_500k", "--mesh",
                        "single", "--arch", "yi-9b",
                        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert list(res) == ["yi-9b|long_500k|16x16"]
    assert res["yi-9b|long_500k|16x16"]["status"] == "skip"
    assert "quadratic" in res["yi-9b|long_500k|16x16"]["reason"]
