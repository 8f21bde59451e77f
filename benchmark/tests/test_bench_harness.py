"""The benchmark harness on the CPU: its result line, the files it finds by
name, its JAX check, its refusal of a run without a card, its rate and
tail arithmetic, and `BENCHMARK.json` against the contract's limits."""

import json
import re
import time

import pytest
from conftest import BENCH, YAMLS, published, small_cell

import run as R
from harness import cell as C
from harness import compare, drive, stats

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_result_line_keys():
    cell = small_cell("kitti_stereo.live_mapping")
    res = R.run_cell(cell, 2 ** 31 + 12345, 1.0, False, "cpu", time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(res["metrics"]) >= {"frames_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["compared"]) == {"orb_keypoints_off", "orb_bits_off", "pose_err_m",
                                    "kf_pose_err_m"}
    assert all(set(v) == {"value", "limit"} for v in res["compared"].values())
    assert res["attempted"] >= 1
    json.dumps(res)


def test_traced_result_has_breakdown():
    cell = small_cell("kitti_stereo.batch32_tracking")
    res = R.run_cell(cell, 77, 1.0, True, "cpu", time.perf_counter())
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert list(res)[-1] == "compared"


def test_one_profiler_keeps_every_traced_call():
    """The traced calls of a window, under one profiler from half the
    window on, each found by its span; the calls before them run
    untraced."""
    cell = small_cell("kitti_stereo.live_mapping")
    m = R.measure(cell, 2 ** 31 + 5, 3.0, True, "cpu", time.perf_counter())
    w = m.window
    traced = [i for i, c in enumerate(w.calls) if c.traced]
    assert len(traced) == cell.traffic["trace_calls"] == 3
    assert traced == list(range(traced[0], traced[0] + 3)) and traced[0] > 0
    assert len(w.trace.calls) == 3
    starts = [s for s, _ in w.trace.calls]
    assert starts == sorted(starts) and all(e > s for s, e in w.trace.calls)
    assert w.trace.window_s > 0
    assert not any(n == drive.CALL_SPAN for n, _, _ in w.trace.host)


def test_reservoir_keeps_n_with_equal_chance():
    counts = [0] * 20
    for seed in range(2000):
        r = drive.Reservoir(5, seed)
        for i in range(20):
            r.offer(i)
        assert len(r.items) == 5 and len(set(r.items)) == 5
        for i in r.items:
            counts[i] += 1
    # each of 20 kept with chance 1/4: 500 of 2000, sd ~19
    assert all(400 < c < 600 for c in counts), counts
    a, b = drive.Reservoir(3, 9), drive.Reservoir(3, 9)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_unknown_workload_no_result(capsys):
    code = R.main(["--workload", "no_such.cell", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert code == R.NO_WORKLOAD
    assert out.out == ""
    assert "no workload" in out.err


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a cell's limits, a check and a
    per-layer metric added as new files, with new BENCHMARK.json entries
    only; and a monocular configuration with its YAML as published."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits", "checks", "metrics"):
        (tmp_path / "benchmark" / sub).mkdir(parents=True)
    src = json.loads((BENCH / "configs" / "kitti_stereo.json").read_text())
    (tmp_path / "benchmark" / "configs" / "new_config.json").write_text(json.dumps(src))
    traffic = json.loads((BENCH / "traffic" / "live_mapping.json").read_text())
    traffic["warmup_frames"] = 7
    (tmp_path / "benchmark" / "traffic" / "new_mix.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "new_config.new_mix.json").write_text('{"pose_err_m": 1}')
    (tmp_path / "benchmark" / "metrics" / "new.metric.py").write_text(
        'LAYER = "device"\n\ndef read(ctx):\n    return 42.0\n')
    (tmp_path / "benchmark" / "checks" / "new.check.py").write_text(
        'def read(cell, scene, out, control):\n    return {"new_err": float(control)}\n')
    mono = dict(src, name="new_mono", sensor="monocular",
                yaml=published(YAMLS / "Monocular" / "TUM1.yaml"))
    (tmp_path / "benchmark" / "configs" / "new_mono.json").write_text(json.dumps(mono))
    (tmp_path / "benchmark" / "traffic" / "new_mono_mix.json").write_text(
        json.dumps(dict(traffic, entry="track_mono", checks=["new.check"])))
    bench["workloads"].append({"name": "new_config.new_mix", "config": "new_config",
                               "traffic": "new_mix", "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "new_mono.new_mono_mix", "config": "new_mono",
                               "traffic": "new_mono_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "frames_per_s", "workloads": ["new_config.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(C, "HERE", tmp_path / "benchmark")
    monkeypatch.setattr(C, "ROOT", tmp_path)
    cell = C.load("new_config.new_mix")
    assert cell.traffic["warmup_frames"] == 7
    assert cell.limits == {"pose_err_m": 1}
    assert cell.settings_fields()["force_kf_every"] == 10
    assert "new.metric" in [m["name"] for m in cell.per_layer]
    assert C.metric_reader("new.metric").read(None) == 42.0
    cell = C.load("new_mono.new_mono_mix")
    assert cell.sensor == "monocular" and drive.SENSORS[cell.sensor].member == "MONOCULAR"
    assert cell.traffic["entry"] in drive.ENTRIES
    fields = cell.settings_fields()
    assert fields["using_line"] is True and fields["line_features"] == 600 and fields["k3"] != 0
    assert "Lineextractor.do_merge" in cell.unread
    assert compare.numbers(cell, None, None) == {"new_err": 0.0}
    assert compare.numbers(cell, None, None, control=True) == {"new_err": 1.0}


@pytest.mark.parametrize("names,held", [
    (["splslam_tpu_torch", "splslam_tpu_torch.slam.system", "numpy"], []),
    (["splslam_tpu", "splslam_tpu_torch"], ["splslam_tpu"]),
    (["splslam_tpu.ops.orb"], ["splslam_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_like", "flaxen", "splslam_tpu_torchx"], []),
])
def test_jax_check_compares_whole_top_level_names(names, held):
    assert R.forbidden_modules(names) == held


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = R.main(["--workload", "kitti_stereo.live_mapping", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code == R.NO_CARD
    assert out.out == ""
    assert "no CUDA device" in out.err


def test_too_few_cards_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    code = R.main(["--workload", "kitti_stereo.live_mapping", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert code == R.NO_CARD
    assert capsys.readouterr().out == ""


def test_rate_and_tail_arithmetic():
    """200 calls of 100 ms and one stall of 5 s among 10 of 900 ms."""
    calls = [100.0] * 190 + [900.0] * 10 + [5000.0]
    window_s = sum(calls) / 1e3
    assert stats.frames_per_s(len(calls), window_s) == pytest.approx(201 / 33.0)
    # rank 0.95 * 200 = 190: the first 900 ms call
    assert stats.p95_ms(calls) == pytest.approx(900.0)
    # a short window (a slow host) still reports the tail of all its calls
    assert stats.p95_ms(calls[:148]) == pytest.approx(100.0)
    assert stats.p95_ms(calls[-20:]) == pytest.approx(900.0 + 0.05 * 4100.0)
    assert stats.p95_ms([]) is None
    assert stats.median_ms(calls) == 100.0
    with pytest.raises(ValueError):
        stats.frames_per_s(3, 0.0)


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (BENCH.parent / c["file"]).exists()
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((BENCH.parent / c["file"]).read_text())["reduced"] == c["reduced"]
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", [x["name"] for x in b["workloads"]]):
            assert C._applies(next(e for e in b["end_to_end"] if e["name"] == m["moves"]), w)
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in C.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cuda_card, workload):
    """A short run of each cell on the card ends with a result line."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", workload,
                        "--seed", str(2 ** 31 + 999), "--seconds", "5", "--trace", "0"],
                       cwd=BENCH.parent, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "frames_per_s" in res["metrics"] and "setup_s" in res["metrics"]
