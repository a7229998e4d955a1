"""The port's config types against the reference, and its import rules.

* ``SearchConfig``, ``IndexSpec``, ``SearchParams`` and ``QuantSpec`` have
  the reference's fields, in its order, with its defaults, and validate
  the same way; ``to_search_config`` lowers identically.
* No module of ``repro_torch`` and not ``chip_smoke.py`` imports ``jax`` or
  anything of ``repro``.
* Entry points default to CUDA and raise without it.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import repro.ann.spec as j_spec
import repro.core.config as j_config
import repro.quant.scheme as j_scheme
import repro_torch.ann.spec as t_spec
import repro_torch.core.config as t_config
import repro_torch.quant.scheme as t_scheme
from repro_torch.ann import AnnIndex
from repro_torch.configs import get_smoke_config
from repro_torch.core.graph import make_padded_csr
from repro_torch.data import make_vector_dataset
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.attention import init_cache
from repro_torch.serve import ServeEngine
from repro_torch.serve.knnlm import build_datastore

ROOT = pathlib.Path(__file__).resolve().parents[1]

PAIRS = [
    (j_config.SearchConfig, t_config.SearchConfig),
    (j_spec.IndexSpec, t_spec.IndexSpec),
    (j_spec.SearchParams, t_spec.SearchParams),
    (j_scheme.QuantSpec, t_scheme.QuantSpec),
]


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("ref_cls,port_cls", PAIRS,
                         ids=[p[0].__name__ for p in PAIRS])
def test_fields_and_defaults_match(ref_cls, port_cls):
    ref = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d)
           for n, d in _fields(ref_cls)]
    got = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d)
           for n, d in _fields(port_cls)]
    assert got == ref
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(ref_cls())


@pytest.mark.parametrize("algorithm", ["bfis", "topm", "speedann"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_to_search_config_matches(algorithm, metric):
    kw = dict(k=7, queue_len=40, m_max=4, num_walkers=2, backend="dma",
              dma_group=4, algorithm=algorithm, visited_mode="hash")
    ref = j_spec.SearchParams(**kw).to_search_config(metric)
    got = t_spec.SearchParams(**kw).to_search_config(metric)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    back_ref = j_spec.SearchParams.from_search_config(ref, algorithm)
    back = t_spec.SearchParams.from_search_config(got, algorithm)
    assert dataclasses.asdict(back) == dataclasses.asdict(back_ref)


@pytest.mark.parametrize("value", [None, "int8", "bf16",
                                   {"dtype": "int8", "per_dim": True}])
def test_coerce_quant_matches(value):
    assert dataclasses.asdict(t_scheme.coerce_quant(value)) \
        == dataclasses.asdict(j_scheme.coerce_quant(value))


@pytest.mark.parametrize("backend", ["ref", "rowgather", "dma",
                                     "dedup_gather", "ref_int8",
                                     "rowgather_int8", "ref_bf16",
                                     "dedup_gather_int8"])
def test_required_quant_dtype_matches(backend):
    assert t_scheme.required_quant_dtype(backend) \
        == j_scheme.required_quant_dtype(backend)


@pytest.mark.parametrize("cls_name,kw", [
    ("IndexSpec", dict(builder="faiss")),
    ("IndexSpec", dict(metric="hamming")),
    ("IndexSpec", dict(n_top_fraction=1.5)),
    ("IndexSpec", dict(entry_policy="max_norm", metric="l2")),
    ("IndexSpec", dict(builder="hnsw", n_top_fraction=0.1)),
    ("IndexSpec", dict(build_batch=0)),
    ("SearchParams", dict(algorithm="annoy")),
    ("SearchParams", dict(rerank_k=-1)),
    ("QuantSpec", dict(dtype="int4")),
])
def test_validation_matches(cls_name, kw):
    ref_mod = j_scheme if cls_name == "QuantSpec" else j_spec
    port_mod = t_scheme if cls_name == "QuantSpec" else t_spec
    with pytest.raises(ValueError) as ref_err:
        getattr(ref_mod, cls_name)(**kw)
    with pytest.raises(ValueError) as got_err:
        getattr(port_mod, cls_name)(**kw)
    assert str(got_err.value) == str(ref_err.value)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


# the LM slice's modules, held by name so that none can drop out of the scan
LM_MODULES = ["config.py", "configs/__init__.py", "configs/qwen2_5_3b.py",
              "models/common.py", "models/attention.py", "models/mlp.py",
              "models/transformer.py", "models/registry.py",
              "models/convert.py", "data/tokens.py", "data/vectors.py",
              "serve/engine.py", "serve/knnlm.py", "launch/serve.py",
              "sharding.py", "models/moe.py", "models/moe_a2a.py",
              "models/whisper.py", "configs/shapes.py",
              "launch/roofline.py", "launch/op_profile.py",
              "launch/dryrun.py", "launch/dryrun_ann.py", "launch/mesh.py",
              "ranks.py", "runtime/elastic.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in _port_files()[:-1]}
    assert set(LM_MODULES) <= scanned, set(LM_MODULES) - scanned
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(_port_files()) > 10
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nbrs = np.zeros((4, 2), np.int32)
    vecs = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_padded_csr(nbrs, vecs)
    g = make_padded_csr(nbrs, vecs, device="cpu")
    arrays = dict(format=np.int64(1),
                  spec=np.asarray('{"metric": "l2", "degree": 2}'),
                  nbrs=nbrs, vectors=vecs, medoid=np.int32(0),
                  n_top=np.int64(0), flat=np.zeros((0, 2, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnIndex.from_arrays(arrays)
    idx = AnnIndex.from_arrays(arrays, device="cpu")
    assert idx.device == g.device == torch.device("cpu")

    # the LM slice: the model, its caches, the vector data, the launcher
    cfg = get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_vector_dataset(n=20, n_queries=2, k=2, dim=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--mode", "lm", "--smoke"])
    # the model's device is where its engine and its datastore run
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks, _ = ServeEngine(model, params, s_max=8).generate(
        np.zeros((1, 2), np.int64), steps=2)
    assert toks.device == torch.device("cpu")
    ds = build_datastore(model, params, [np.zeros((2, 5), np.int64)],
                         cfg.vocab_size, degree=4)
    assert ds.index.device == ds.values.device == torch.device("cpu")
