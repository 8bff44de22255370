"""CPU tests of the benchmark harness: the cells resolve by name, the
frozen scene builders and tile partition agree with the port's, the trace
reduction and roofline arithmetic on synthetic inputs, the references
against the port at tiny sizes, the control and the planted faults turn
``correct`` false, and nothing a run loads is JAX or the JAX package."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import bench, devtrace, roofline
from perfbench.reference import atmosphere as ref_atmosphere
from perfbench.reference import common, compare
from perfbench.reference import terrain as ref_terrain
from perfbench.scenes import atmosphere as scene_atmosphere
from perfbench.scenes import terrain as scene_terrain

ROOT = bench.ROOT
SPEC = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"mix": {"width": 8, "height": 8, "spp": 16, "samples_per_pass": 512,
                "block": 4, "trace_films": 1},
        "limits": {"reference_spp": 64}}


def tiny(workload):
    out = {k: dict(v) for k, v in TINY.items()}
    if workload.startswith("terrain"):
        out["scene"] = {"resolution": 17}
    return out


def test_benchmark_json_is_well_formed():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("perfbench/")
        assert bench.load_json(os.path.join(ROOT, c["file"]))["name"] == \
            c["name"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_resolves_by_name():
    for w in SPEC["workloads"]:
        spec, cell, cfg, mix, limits = bench.resolve(w["name"])
        assert cell["config"] == cfg["name"]
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "scenes", cfg["builder"] + ".py"))
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "reference", cfg["builder"] + ".py"))
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "entries", mix["entry"] + ".py"))
        assert set(limits["limits"]) == {"block_chi2", "global_z",
                                         "samples_lost", "duplicate_films"}
        for m in bench.reports(spec, w["name"], "per_layer"):
            assert callable(bench.metric_reader(m["name"]))


def test_atmosphere_builder_is_the_ports():
    from eradiate_kernel_tpu_torch.utils import scenes

    cfg = bench.resolve("pp64_gap.render")[2]["scene"]
    mine = scene_atmosphere.scene_dict(
        cfg, scene_atmosphere.inputs(cfg), 16, 16, 4)
    port = scenes.atmosphere(16, 16, 4, cfg["max_depth"], cfg["grid_res"],
                             cfg["tau"], cfg["albedo"], cfg["rpv_rho_0"],
                             tuple(cfg["sun_direction"]))
    a = mine["atmo"]["interior"]["sigma_t"]["data"]
    b = port["atmo"]["interior"]["sigma_t"]["data"]
    assert a.dtype == b.dtype and np.array_equal(a, b)
    # the same scene but the ground's height and the NEE estimator
    assert mine["surface"]["to_world"][1]["value"][2] == cfg["ground_z"]
    mine["surface"]["to_world"][1]["value"][2] = 0.0
    mine["atmo"]["interior"]["sigma_t"]["data"] = b
    mine["sun"]["direction"] = list(port["sun"]["direction"])
    del mine["integrator"]["nee_transmittance"]
    assert repr(mine) == repr(port)


def test_terrain_builder_is_chip_smokes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    V, F = scene_terrain.heightfield(33, 0)
    V2, F2 = chip_smoke.terrain(33, 0)
    assert np.array_equal(V, V2) and np.array_equal(F, F2)
    cfg = bench.resolve("terrain256.render")[2]["scene"]
    mine = scene_terrain.scene_dict(cfg, {"vertices": V, "faces": F}, 8, 8,
                                    4)
    port = chip_smoke.terrain_scene(V, F, 8, 8, 4, cfg["max_depth"])
    mine["sun"]["direction"] = list(port["sun"]["direction"])
    mine["camera"]["to_world"] = {
        k: list(v) if isinstance(v, list) else v
        for k, v in mine["camera"]["to_world"].items()}
    assert repr(mine) == repr(port)


def test_frozen_tiles_are_the_ports():
    from eradiate_kernel_tpu_torch.ops import accel

    V, F = scene_terrain.heightfield(17, 3)
    perm, lo, hi = accel._build_tiles_numpy(V, F)
    lo2, hi2, count = roofline.tiles(V, F)
    assert np.array_equal(lo, lo2) and np.array_equal(hi, hi2)
    assert np.array_equal(count, (perm >= 0).reshape(len(lo), -1).sum(1))
    assert count.sum() == len(F)


def test_roofline_work_counts_crossed_tiles():
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    F = np.zeros((300, 3), np.int32) + np.array([0, 1, 2], np.int32)
    work = roofline.Work(V, F, "cpu")             # 3 tiles: 128, 128, 44
    assert work.count.tolist() == [128, 128, 44]
    rays = torch.tensor([
        [0.2, 0.2, 1, 0, 0, -1, 0, 10],           # crosses the tiles
        [5.0, 5.0, 1, 0, 0, -1, 0, 10],           # misses them
        [0.2, 0.2, 1, 0, 0, -1, 0, 0.5],          # stops short
        [0.2, 0.2, 1, 0, 0, -1, 0, 0]],           # dead: maxt = mint
        dtype=torch.float32)
    work.add(rays)
    assert work.tests == 300
    assert work.nbytes == 4 * (32 + 20) + 300 * 44 + 3 * 24
    t, by = work.bound()
    assert by == "bytes"
    assert t == pytest.approx(work.nbytes / roofline.HBM_BYTES_PER_S)
    work.tests = 1e12
    assert work.bound() == (pytest.approx(1e12 * 46 / 67e12), "operations")


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def test_trace_reduction_on_a_synthetic_window():
    ev = [_ev("user_annotation", devtrace.WINDOW, 0, 100),
          _ev("cpu_op", "aten::mul", 5, 10),
          _ev("cuda_runtime", "cudaLaunchKernel", 6, 2, correlation=1),
          _ev("user_annotation", devtrace.QUERY, 20, 20),
          _ev("cuda_runtime", "cudaLaunchKernel", 22, 2, correlation=2),
          _ev("user_annotation", devtrace.CAPTURE, 50, 5),
          _ev("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
          _ev("cpu_op", "aten::nonzero", 60, 30),
          _ev("cuda_runtime", "cudaStreamSynchronize", 62, 26),
          _ev("kernel", "mul_kernel", 10, 10, correlation=1),
          _ev("kernel", "tile_sweep_small_kernel", 25, 30, correlation=2),
          _ev("kernel", "copy", 56, 2, correlation=3),
          _ev("gpu_memcpy", "Memcpy DtoH", 88, 4)]
    r = devtrace.reduce_events(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    # kernels 10-20 and 25-55 and the copy 88-92; the capture's copy is out
    assert r["busy_s"] == pytest.approx((10 + 30 + 4) * 1e-6)
    assert r["launches"] == 2
    assert r["query_kernel_s"] == pytest.approx(30e-6)
    gaps = dict(r["idle_gaps"])
    # idle 0-10, 20-25, 55-88 and 92-100, by the innermost host operation
    expect = {"(no host operation traced)": 5 + 5 + 8, "aten::mul": 3,
              "cudaLaunchKernel": 2 + 2, devtrace.QUERY: 3,
              "aten::nonzero": 2, "cudaStreamSynchronize": 26}
    assert gaps == pytest.approx({k: v * 1e-6 for k, v in expect.items()})
    assert dict(r["device_ops"])["tile_sweep_small_kernel"] == \
        pytest.approx(30e-6)


def test_per_layer_readers_on_synthetic_numbers():
    ctx = {"trace": {"launches": 500, "busy_s": 3.0, "window_s": 4.0,
                     "query_kernel_s": 0.5},
           "counters": {"host_syncs": 30, "pool_syncs": 10}, "work": None,
           "samples": 2_000_000, "films": 1}
    read = lambda n: bench.metric_reader(n)(ctx)
    assert read("host_syncs_per_msample.render") == 20
    assert read("launches_per_msample.render") == 250
    assert read("idle_pct.render") == pytest.approx(25)
    assert read("tile_sweep_roofline") is None      # nothing to read
    work = roofline.Work(np.eye(3, dtype=np.float32),
                         np.array([[0, 1, 2]], np.int32), "cpu")
    work.add(torch.tensor([[0.3, 0.3, 1, 0, 0, -1, 0, 5.0]]))
    ctx["work"] = work
    assert read("tile_sweep_roofline") == pytest.approx(
        100 * work.bound()[0] / 0.5)


def _port_film(workload, seed, size, spp):
    _spec, _cell, cfg, mix, _lim = bench.resolve(workload)
    ov = tiny(workload)
    mix = {**mix, **ov["mix"], "width": size, "height": size, "spp": spp}
    cfg = {**cfg, "scene": {**cfg["scene"], **ov.get("scene", {})}}
    from perfbench.entries import film

    scenes = scene_terrain if cfg["builder"] == "terrain" else \
        scene_atmosphere
    runner = film.Runner(cfg, mix, scenes, "cpu")
    return cfg, runner.inputs, runner(seed)


@pytest.mark.parametrize("workload,reference,spp", [
    ("pp64_gap.render", ref_atmosphere, 32),
    ("terrain256.render", ref_terrain, 32)])
def test_reference_agrees_with_the_port_at_a_tiny_size(workload, reference,
                                                       spp):
    # 16 blocks of 4 x 4 pixels: the mean of their z^2 is 1 +- 0.35
    cfg, inputs, film = _port_film(workload, 11, 16, spp)
    sums, counts = reference.render(cfg, inputs, 16, 16, 4 * spp, 5, "cpu")
    nums = compare.film_numbers(film, sums, counts, spp, 4)
    assert nums["samples_lost"] == 0
    assert nums["block_chi2"] < 3 and nums["global_z"] < 4, nums


def test_control_in_bfloat16_fails_the_comparison():
    _spec, _cell, cfg, _mix, limits = bench.resolve("pp64_gap.render")
    inputs = scene_atmosphere.inputs(cfg["scene"])
    s16, c16 = ref_atmosphere.render(cfg, inputs, 32, 32, 64, 1, "cpu",
                                     torch.bfloat16)
    sums, counts = ref_atmosphere.render(cfg, inputs, 32, 32, 64, 2, "cpu")
    s32, c32 = ref_atmosphere.render(cfg, inputs, 32, 32, 64, 3, "cpu")
    control = compare.film_numbers(common.film_from_sums(s16.float(), c16),
                                   sums, counts, 64, 4)
    sound = compare.film_numbers(common.film_from_sums(s32.float(), c32),
                                 sums, counts, 64, 4)
    assert sound["global_z"] < 4 < control["global_z"]


def _broken(kind):
    """A wrapper of the entry's runner that breaks the timed path."""
    def wrap(runner):
        kept = {}

        def call(seed, spp=None):
            if kind == "unchanged":
                film = runner(seed)
                return torch.zeros_like(film)
            if kind == "half_batch":
                return runner(seed, spp=runner.mix["spp"] // 2)
            if kind == "altered":
                film = runner(seed).clone()
                film[..., :3] *= 1.5
                return film
            if kind == "stale":
                kept.setdefault("film", runner(seed))
                return kept["film"]
            return runner(seed)
        return call
    return wrap


@pytest.mark.parametrize("kind,correct", [
    ("sound", True), ("unchanged", False), ("half_batch", False),
    ("altered", False), ("stale", False)])
def test_a_run_judges_the_timed_path(kind, correct):
    # a stale answer shows only beside a second film: a longer window
    seconds = 5.0 if kind == "stale" else 0.5
    result = bench.run("pp64_gap.render", 2 ** 31 + 12345, seconds, 0,
                       device="cpu", overrides=tiny("pp64_gap.render"),
                       log=lambda m: None, program=_broken(kind))
    if kind == "stale":
        assert result["attempted"] >= 2
    assert result["correct"] is correct, result["checks"]
    assert list(result)[-1] == "checks"


def test_forbidden_names_compare_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["eradiate_kernel_tpu_torch_extra"] = sys
        assert "eradiate_kernel_tpu" not in bench.forbidden_modules()
        sys.modules["eradiate_kernel_tpu.core"] = sys
        sys.modules["jaxlib"] = sys
        assert {"eradiate_kernel_tpu", "jaxlib"} <= set(
            bench.forbidden_modules())
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


RUN_CHECK = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import bench
ov = {ov!r}
for w in ("pp64_gap.render", "terrain256.render"):
    o = dict(ov)
    if w.startswith("terrain"):
        o["scene"] = {{"resolution": 17}}
    r = bench.run(w, 7, 0.1, 1, device="cpu", overrides=o,
                  log=lambda m: None)
print(json.dumps(bench.forbidden_modules()))
"""


def test_a_run_loads_no_jax_in_a_fresh_process():
    code = RUN_CHECK.format(root=ROOT, ov=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "pp64_gap.render",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card(card):
    _spec, _cell, cfg, mix, limits = bench.resolve("pp64_gap.render")
    inputs = scene_atmosphere.inputs(cfg["scene"])
    W, H, spp = mix["width"], mix["height"], mix["spp"]
    s16, c16 = ref_atmosphere.render(cfg, inputs, W, H, spp, 1, card,
                                     torch.bfloat16)
    sums, counts = ref_atmosphere.render(cfg, inputs, W, H, spp, 2, card)
    nums = compare.film_numbers(common.film_from_sums(s16.float(), c16),
                                sums, counts, spp, mix["block"])
    assert any(nums[k] > limits["limits"][k] for k in nums), nums
