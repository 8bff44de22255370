"""The port's spans (``utils/runtime.py::scoped_phase``, ``ert::`` names)
and their reduction (``perfbench/spans.py``):

- (a) a volpath render on the lane pool, its gradient through the path
  replay, and a path render on the scan driver, each under
  ``runtime.trace``, emit every span those paths reach, nested as the
  layers nest (the query and the volume lookup inside a bounce, inside a
  pool iteration or a scan pass, inside the film's one ``ert::render``);
- (b) the films and the integrators' counters are the same with the
  profiler on and off;
- (c) with no profiler active a render enters ``record_function`` zero
  times;
- (d) the span reduction of a synthetic trace, a second launching thread
  included, and the benchmark's existing reduction unchanged by the spans;
- (e) each span metric reads None without its span, and the benchmark's
  own traced run on the CPU gives every span metric a number."""

import json
import inspect
from collections import Counter

import pytest
import torch

from eradiate_kernel_tpu_torch import integrators
from eradiate_kernel_tpu_torch.integrators import common
from eradiate_kernel_tpu_torch.scene import load_dict
from eradiate_kernel_tpu_torch.utils import autodiff, runtime
from eradiate_kernel_tpu_torch.utils.scenes import atmosphere, cornell_box
from perfbench import bench, devtrace, spans, spanrun

LANES = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def atmo():
    return load_dict(atmosphere(8, 8, 4, 6, grid_res=16), device="cpu")


@pytest.fixture(scope="module")
def cbox():
    return load_dict(cornell_box(8, 8, 2, 3), device="cpu")


def pool_film(scene):
    return integrators.render(scene, seed=1, regen=True,
                              samples_per_pass=LANES, develop_film=False)


def scan_film(scene):
    return integrators.render(scene, seed=1, develop_film=False)


def traced(fn, tmp_path):
    """(fn()'s value, the ert:: spans of its trace as (ts, end, name, tid))."""
    with runtime.trace(str(tmp_path)):
        out = fn()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return out, [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
                 for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith("ert::")]


def enclosing(span, all_spans):
    """Names of the spans that strictly enclose ``span`` on its thread."""
    t0, t1, _name, tid = span
    return {n for a, b, n, t in all_spans if t == tid and (a, b) != (t0, t1)
            and a <= t0 and t1 <= b}


POOL_SPANS = {"ert::render", "ert::pool.iteration", "ert::pool.harvest",
              "ert::pool.refill", "ert::bounce", "ert::nee",
              "ert::free_flight", "ert::volume_eval", "ert::rng",
              "ert::bsdf", "ert::phase", "ert::query"}
SCAN_SPANS = {"ert::render", "ert::pass", "ert::bounce", "ert::nee",
              "ert::query", "ert::rng", "ert::bsdf", "ert::film"}


def test_pool_render_spans_nest_by_layer(atmo, tmp_path):
    _film, found = traced(lambda: pool_film(atmo), tmp_path)
    names = Counter(n for _a, _b, n, _t in found)
    assert POOL_SPANS <= set(names), names
    assert names["ert::render"] == 1 and "ert::pass" not in names
    stats = {}
    integrators.render_wavefront_regen(atmo, LANES, 1, 4, stats=stats)
    # the span opens before the loop's break: the last pass finds nothing
    assert names["ert::pool.iteration"] == stats["iterations"] + 1
    assert names["ert::bounce"] == stats["iterations"]
    for s in found:
        if s[2] in ("ert::query", "ert::volume_eval"):
            assert {"ert::bounce", "ert::pool.iteration",
                    "ert::render"} <= enclosing(s, found), s
        if s[2] in ("ert::pool.harvest", "ert::pool.refill"):
            assert enclosing(s, found) == {"ert::pool.iteration",
                                           "ert::render"}
        if s[2] == "ert::free_flight":
            assert "ert::bounce" in enclosing(s, found)


def test_scan_render_spans_nest_by_layer(cbox, tmp_path):
    _film, found = traced(lambda: scan_film(cbox), tmp_path)
    names = Counter(n for _a, _b, n, _t in found)
    assert SCAN_SPANS <= set(names), names
    assert names["ert::render"] == 1 and names["ert::pass"] == 1
    assert "ert::pool.iteration" not in names
    for s in found:
        if s[2] == "ert::query":
            assert {"ert::bounce", "ert::pass",
                    "ert::render"} <= enclosing(s, found), s
        if s[2] == "ert::film":
            assert enclosing(s, found) == {"ert::pass", "ert::render"}


def test_the_adjoint_sweep_replays_the_pool_inside_its_span(atmo, tmp_path):
    pm = autodiff.traverse(atmo).keep(["volumes.gridvolume.grid"])
    params = pm.trainable()

    def value_grad():
        img = autodiff.render(pm, params, seed=1, regen=True,
                              samples_per_pass=LANES)
        img.mean().backward()

    _none, found = traced(value_grad, tmp_path)
    adjoint = [s for s in found if s[2] == "ert::adjoint"]
    assert len(adjoint) == 1
    inside = [s for s in found if "ert::adjoint" in enclosing(s, found)]
    assert {"ert::pool.iteration", "ert::bounce"} <= {s[2] for s in inside}
    assert "ert::render" not in enclosing(adjoint[0], found)


@pytest.mark.parametrize("render", [pool_film, scan_film])
def test_films_and_counters_are_the_same_under_the_profiler(
        render, atmo, cbox, tmp_path):
    scene = atmo if render is pool_film else cbox

    def counted():
        common.counters.update(host_syncs=0, pool_syncs=0)
        film = render(scene)
        return film, dict(common.counters)

    off = counted()
    on, _found = traced(counted, tmp_path)
    assert torch.equal(off[0], on[0])
    assert off[1] == on[1]


def test_no_profiler_no_record_function(atmo, cbox, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered without a "
                                 "profiler")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    assert not torch._C._autograd._profiler_enabled()
    pool_film(atmo)
    scan_film(cbox)
    with runtime.scoped_phase("ert::test"):
        pass


def test_scoped_phase_decorates_and_keeps_the_signature(tmp_path):
    @runtime.scoped_phase("ert::test")
    def f(a, b=2):
        """doc"""
        return a + b

    assert f.__name__ == "f" and f.__doc__ == "doc" and f(1) == 3
    assert list(inspect.signature(f).parameters) == ["a", "b"]
    _out, found = traced(lambda: f(1), tmp_path)
    assert [n for _a, _b, n, _t in found] == ["ert::test"]


# ---- the reduction (perfbench/spans.py) -----------------------------------

def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def synthetic():
    """A 100 µs window: (the benchmark's events, the port's spans)."""
    bench_ev = [
        _ev("user_annotation", devtrace.WINDOW, 0, 100),
        _ev("cpu_op", "aten::mul", 5, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 2, correlation=1),
        _ev("user_annotation", devtrace.QUERY, 20, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 22, 2, correlation=2),
        _ev("user_annotation", devtrace.CAPTURE, 50, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
        _ev("cpu_op", "aten::nonzero", 60, 30),
        _ev("cuda_runtime", "cudaStreamSynchronize", 62, 26),
        # a kernel launched from a second thread at 70
        _ev("cuda_runtime", "cudaLaunchKernel", 70, 1, tid=2,
            correlation=4),
        _ev("kernel", "mul_kernel", 10, 10, correlation=1),
        _ev("kernel", "tile_sweep_small_kernel", 25, 30, correlation=2),
        _ev("kernel", "copy", 56, 2, correlation=3),
        _ev("kernel", "other_thread_kernel", 72, 4, correlation=4),
        _ev("gpu_memcpy", "Memcpy DtoH", 88, 4)]
    ert = [
        _ev("user_annotation", "ert::render", 2, 96),
        _ev("user_annotation", "ert::bounce", 4, 50),
        _ev("user_annotation", "ert::rng", 5, 12),
        _ev("user_annotation", "ert::query", 19, 30),
        _ev("user_annotation", "ert::pool.refill", 58, 35),
        # the second thread's span, around its launch
        _ev("user_annotation", "ert::adjoint", 69, 5, tid=2)]
    return bench_ev, ert


def test_span_reduction_on_a_synthetic_window():
    bench_ev, ert = synthetic()
    r = spans.reduce_events(bench_ev + ert)
    us = lambda d: {k: pytest.approx(v * 1e-6) for k, v in d.items()}
    # inclusive: the mul kernel under render, bounce and rng; the sweep
    # under render, bounce and query; the capture's copy nowhere; the
    # memcpy has no launch record; the second thread's kernel under its
    # own span only
    assert r["span_device_s"] == us({
        "ert::render": 10 + 30, "ert::bounce": 10 + 30, "ert::rng": 10,
        "ert::query": 30, "ert::pool.refill": 0, "ert::adjoint": 4})
    # idle 0-10, 20-25, 55-72, 76-88 and 92-100 by the innermost span on
    # the main thread (render 2-98, bounce 4-54, rng 5-17, query 19-49,
    # refill 58-93)
    assert r["span_idle_s"] == us({
        spans.NONE: 2 + 2, "ert::render": 2 + 3 + 5, "ert::bounce": 1,
        "ert::rng": 5, "ert::query": 5, "ert::pool.refill": 14 + 12 + 1})
    assert r["span_count"] == {"ert::render": 1, "ert::bounce": 1,
                               "ert::rng": 1, "ert::query": 1,
                               "ert::pool.refill": 1, "ert::adjoint": 1}
    assert spans.kernels_inside(bench_ev + ert, "ert::bounce",
                                "ert::query") == {
        "tile_sweep_small_kernel": pytest.approx(30e-6)}
    # exclusive: each operation once, under its innermost span; the memcpy
    # has no launch record, so no span
    inner = spans.innermost_kernels(bench_ev + ert)
    assert inner == {"ert::rng": {"mul_kernel": pytest.approx(10e-6)},
                     "ert::query": {"tile_sweep_small_kernel":
                                    pytest.approx(30e-6)},
                     "ert::adjoint": {"other_thread_kernel":
                                      pytest.approx(4e-6)},
                     spans.NONE: {"Memcpy DtoH": pytest.approx(4e-6)}}
    line = spans.log_line(r)
    assert line.startswith("# spans: ert::render n=1 device 0.000040 s")


def test_spans_leave_the_benchmarks_reduction_as_it_was():
    bench_ev, ert = synthetic()
    before = devtrace.reduce_events(bench_ev)
    after = devtrace.reduce_events(bench_ev + ert)
    for k in ("window_s", "busy_s", "launches", "query_kernel_s",
              "kernels_unmatched", "device_ops"):
        assert after[k] == before[k], k
    # the idle breakdown keeps its total; a span only names a gap that no
    # host operation covered, or one inside an operation it encloses
    gaps_b, gaps_a = dict(before["idle_gaps"]), dict(after["idle_gaps"])
    assert sum(gaps_a.values()) == pytest.approx(sum(gaps_b.values()))
    for k, v in gaps_a.items():
        if not k.startswith("ert::"):
            assert v <= gaps_b[k] + 1e-12, k


SPAN_METRICS = {"query_device_ms_per_msample.render": "ert::query",
                "volume_device_ms_per_msample.render": "ert::volume_eval",
                "rng_device_ms_per_msample.render": "ert::rng",
                "driver_idle_ms_per_msample.render": "ert::pool.iteration"}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_reads_none_without_its_span(metric):
    read = bench.metric_reader(metric)
    plain = {"launches": 5, "busy_s": 1.0, "window_s": 2.0}
    ctx = {"trace": plain, "counters": {}, "work": None,
           "samples": 2_000_000, "films": 1}
    assert read(ctx) is None                      # no span keys at all
    other = {"span_device_s": {"ert::phase": 1.0},
             "span_idle_s": {"ert::phase": 1.0, spans.NONE: 1.0},
             "span_count": {"ert::phase": 3}}
    assert read({**ctx, "trace": {**plain, **other}}) is None
    name = SPAN_METRICS[metric]
    with_it = {"span_device_s": {name: 0.5}, "span_idle_s": {name: 0.25},
               "span_count": {name: 7}}
    want = 125.0 if metric.startswith("driver") else 250.0
    assert read({**ctx, "trace": {**plain, **with_it}}) == \
        pytest.approx(want)


@pytest.mark.parametrize("workload", ["pp64_gap.render",
                                      "terrain256.render"])
def test_the_benchmarks_traced_run_reads_every_span_metric(workload,
                                                           monkeypatch):
    seen, lines = {}, []
    monkeypatch.setattr(devtrace, "reduce_file",
                        spanrun.with_spans(seen, lines.append))
    tiny = {"mix": {"width": 8, "height": 8, "spp": 4,
                    "samples_per_pass": 128, "block": 4, "trace_films": 1},
            "limits": {"reference_spp": 64}}
    if workload.startswith("terrain"):
        tiny["scene"] = {"resolution": 17}
    result = bench.run(workload, 2 ** 31 + 99, 0.0, 1, device="cpu",
                       overrides=tiny, log=lambda m: None)
    assert result["correct"], result["checks"]
    assert seen["span_count"]["ert::render"] == 1
    assert lines and lines[0].startswith("# spans: ")
    ctx = {"trace": seen, "samples": 8 * 8 * 4}
    values = {m: bench.metric_reader(m)(ctx) for m in SPAN_METRICS}
    # on the CPU no device operation is traced: the device times read 0,
    # and the window is idle throughout
    want_none = {"volume_device_ms_per_msample.render"} \
        if workload.startswith("terrain") else set()
    for m, v in values.items():
        assert (v is None) == (m in want_none), (m, v)
    assert values["driver_idle_ms_per_msample.render"] > 0
    # every idle second of the window has a label, a span's or "(none)"
    dev = result["device"]
    assert sum(seen["span_idle_s"].values()) == pytest.approx(
        dev["window_s"] - dev["busy_s"])
