"""The port's observability stack against the reference's.

``repro_torch.obs`` keeps its own copies of ``repro.obs``: on the same
samples the sketches give the same quantiles, merges and JSON; registries
give byte-equal JSON and Prometheus text; a served request's span tree has
the reference's names and passes ``scripts/check_trace.py``; the registry
series the engines and the coalescer write match the reference's; and
``device_annotation`` shows as a range under ``torch.profiler``.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro import obs as jobs
from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro_torch import obs as tobs
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import SearchParams as TParams
from serving_harness import VirtualClock

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (1, 2, 4, 8)
PARAMS = dict(k=10, queue_len=48, m_max=4, num_walkers=4, max_steps=128,
              local_steps=4)
QUANTILES = (0.0, 0.01, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


def _check_trace():
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "scripts" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def indices(tmp_path_factory):
    rng = np.random.RandomState(9)
    x = rng.randint(-8, 9, size=(1200, 24)).astype(np.float32)
    q = rng.randint(-8, 9, size=(8, 24)).astype(np.float32)
    ref = JIndex.build(x, JSpec(degree=12, passes=1))
    path = ref.save(str(tmp_path_factory.mktemp("obs") / "l2"))
    return ref, TIndex.load(path, device="cpu"), q


def _samples(kind):
    rng = np.random.RandomState(0)
    if kind == "lognormal":
        return rng.lognormal(mean=1.0, sigma=1.5, size=5000), {}
    if kind == "decades":          # more buckets than the cap: collapse
        return 10.0 ** rng.uniform(-6, 6, size=3000), {"max_buckets": 64}
    # zeros, negatives and non-finite values beside ordinary ones
    v = rng.exponential(3.0, size=500)
    v[::7] = 0.0
    v[::11] = -2.0
    v[::13] = np.nan
    v[::17] = np.inf
    return v, {"rel_err": 0.05}


@pytest.mark.parametrize("kind", ["lognormal", "decades", "edges"])
def test_histogram_equals_reference(kind):
    values, kw = _samples(kind)
    ref, got = jobs.LogHistogram(**kw), tobs.LogHistogram(**kw)
    ref.observe_many(values)
    got.observe_many(values)
    assert got.to_dict() == ref.to_dict()
    assert [got.quantile(q) for q in QUANTILES] == \
        [ref.quantile(q) for q in QUANTILES]
    assert (got.mean, got.min, got.max, got.n_buckets, got.percentile(99)) \
        == (ref.mean, ref.min, ref.max, ref.n_buckets, ref.percentile(99))
    assert got.bucket_bounds() == ref.bucket_bounds()
    assert repr(got) == repr(ref)
    back = tobs.LogHistogram.from_dict(json.loads(json.dumps(got.to_dict())))
    assert back.to_dict() == ref.to_dict()


def test_histogram_merges_equal_reference():
    rng = np.random.RandomState(2)
    parts = [rng.lognormal(size=777) for _ in range(3)]

    def sketches(mod):
        out = []
        for p in parts:
            h = mod.LogHistogram()
            h.observe_many(p)
            out.append(h)
        return out
    j, t = sketches(jobs), sketches(tobs)
    ref = j[0].merge(j[1]).merge(j[2])
    got = t[0].merge(t[1]).merge(t[2])
    assert got.to_dict() == ref.to_dict()
    assert got.quantile(0.95) == ref.quantile(0.95)
    # a port sketch merges a reference sketch (the replicas of a mixed
    # fleet) exactly
    mixed = tobs.LogHistogram()
    for h in sketches(jobs):
        mixed.merge(h)
    assert mixed.to_dict() == ref.to_dict()
    for mod in (jobs, tobs):
        with pytest.raises(ValueError, match="different resolutions"):
            mod.LogHistogram(rel_err=0.01).merge(
                mod.LogHistogram(rel_err=0.05))


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("req_total", "requests by outcome").inc(
        2, outcome="served")
    reg.counter("req_total").inc(1, outcome="shed")
    reg.counter("esc_total", "escaping").inc(3, path='a"b\\c\nd')
    reg.gauge("queue_depth", "pending requests").set(7)
    reg.gauge("queue_depth").labels(replica="1").dec(2.5)
    for v in (1.0, 2.0, 2.0, 100.0, 0.0):
        reg.histogram("lat_ms", "latency").observe(v, backend="ref")
    other = mod.MetricsRegistry()
    other.counter("req_total").inc(4, outcome="served")
    other.histogram("lat_ms").observe(7.5, backend="ref")
    return reg.merge(other)


def test_registry_json_and_prometheus_byte_equal():
    ref, got = _fill(jobs), _fill(tobs)
    assert got.to_json() == ref.to_json()
    assert got.to_json(indent=2) == ref.to_json(indent=2)
    assert got.to_prometheus() == ref.to_prometheus()
    back = tobs.MetricsRegistry.from_json(ref.to_json())
    assert back.to_prometheus() == ref.to_prometheus()
    for mod in (jobs, tobs):
        with pytest.raises(TypeError, match="already registered"):
            _fill(mod).gauge("req_total")
        with pytest.raises(ValueError, match="only go up"):
            mod.MetricsRegistry().counter("c").inc(-1)


def _tree(trace):
    """(name, phase) of every event in the trace's own order, the
    metadata left out, and the arg keys of each span name."""
    events = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    args = {}
    for e in events:
        args.setdefault(e["name"], set()).update(e["args"])
    return [(e["name"], e["ph"]) for e in events], args


def test_served_request_span_tree_equals_reference(indices):
    ref_idx, port, q = indices
    ct = _check_trace()
    traces, regs = [], []
    for idx, params in ((ref_idx, JParams(**PARAMS)),
                        (port, TParams(**PARAMS))):
        mod = jobs if idx is ref_idx else tobs
        obs = mod.Observability(tracing=True, metrics=True)
        engine = idx.serve(params, bucket_sizes=BUCKETS, obs=obs)
        engine.search(q[:3])
        srv = idx.serve_async(params, start=False, bucket_sizes=BUCKETS,
                              obs=obs)
        futs = [srv.submit(v) for v in q[3:6]]
        assert srv.flush() == 3
        assert all(f.result(timeout=0).ids.shape == (10,) for f in futs)
        srv.close()
        trace = obs.tracer.to_chrome_trace()
        assert ct.validate(trace, require=[
            "engine.search", "device_compute", "postprocess",
            "batch_formation", "dispatch", "resolve", "request"]) == []
        traces.append(trace)
        regs.append(obs.registry.to_dict())
    assert _tree(traces[1]) == _tree(traces[0])
    # the engine's span nesting: engine.search > device_compute, then
    # postprocess, both inside it
    ev = {e["name"]: e for e in traces[1]["traceEvents"]}
    outer = ev["engine.search"]
    for inner in ("device_compute", "postprocess"):
        assert outer["ts"] <= ev[inner]["ts"]
        assert ev[inner]["ts"] + ev[inner]["dur"] <= \
            outer["ts"] + outer["dur"] + 0.5
    assert ev["device_compute"]["ts"] + ev["device_compute"]["dur"] <= \
        ev["postprocess"]["ts"] + 0.5
    # the same series with the same labels and counts; only latencies and
    # the process name differ
    ref_reg, got_reg = regs
    assert sorted(got_reg) == sorted(ref_reg)
    for name, meta in ref_reg.items():
        mine = got_reg[name]
        assert (mine["type"], mine["help"]) == (meta["type"], meta["help"])
        assert [s["labels"] for s in mine["series"]] == \
            [s["labels"] for s in meta["series"]]
        for s_r, s_g in zip(meta["series"], mine["series"]):
            if "value" in s_r:
                assert s_g["value"] == s_r["value"], name
            elif not name.endswith("_ms"):
                assert s_g["histogram"] == s_r["histogram"], name
            else:
                assert s_g["histogram"]["count"] == \
                    s_r["histogram"]["count"], name
    assert traces[1]["traceEvents"][0]["args"]["name"] == \
        "repro_torch.serve"


def test_deadline_shed_event_and_counter(indices):
    _, port, q = indices
    obs = tobs.Observability(tracing=True, metrics=True)
    clock = VirtualClock()
    srv = port.serve_async(TParams(**PARAMS), start=False,
                           bucket_sizes=BUCKETS, obs=obs, clock=clock)
    fut = srv.submit(q[0], deadline_ms=1.0)
    clock.advance(0.005)
    srv.flush()
    with pytest.raises(Exception, match="deadline expired"):
        fut.result(timeout=0)
    srv.close()
    sheds = [e for e in obs.tracer.events() if e["name"] == "deadline_shed"]
    assert sheds and sheds[0]["args"]["late_ms"] == 4.0
    d = obs.registry.to_dict()
    shed = [s for s in d["coalescer_requests_total"]["series"]
            if s["labels"] == {"outcome": "shed"}]
    assert shed[0]["value"] == 1.0
    assert _check_trace().validate(obs.tracer.to_chrome_trace()) == []


def test_device_annotation_shows_under_torch_profiler(indices):
    _, port, q = indices
    assert tobs.have_profiler()
    obs = tobs.Observability(tracing=False, metrics=False, profile=True)
    engine = port.serve(TParams(**PARAMS), bucket_sizes=BUCKETS, obs=obs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.search(q[:3])
        with tobs.device_annotation("not_recorded", enabled=False):
            torch.ones(2).sum()
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys.get("ann_dispatch/bucket4") == 1
    assert "not_recorded" not in keys
    # off by default: the shared no-op context, nothing allocated
    assert tobs.device_annotation("x") is tobs.device_annotation("y")


def test_disabled_obs_writes_nothing(indices):
    _, port, q = indices
    engine = port.serve(TParams(**PARAMS), bucket_sizes=BUCKETS)
    assert engine.obs is tobs.NULL_OBS
    engine.search(q[:2])
    assert tobs.NULL_OBS.tracer.n_events == 0
    assert tobs.NULL_OBS.registry.to_dict() == {}
    assert tobs.NULL_TRACER.span("a") is tobs.NULL_TRACER.span("b")
    obs = tobs.Observability(tracing=False, metrics=False)
    port.serve(TParams(**PARAMS), bucket_sizes=BUCKETS,
               obs=obs).search(q[:2])
    assert obs.tracer.n_events == 0 and obs.registry.to_dict() == {}
    assert obs.enabled is False
    rec = tobs.TraceRecorder(max_events=100)
    for i in range(500):
        rec.instant(f"e{i}")
    assert (rec.n_events, rec.dropped_events) == (100, 400)
