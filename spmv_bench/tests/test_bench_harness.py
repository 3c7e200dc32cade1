"""``BENCHMARK.json`` against the benchmark's contract, the harness's
discovery by name, the last line's schema, and the exits without a card
or without the program."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from spmv_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E, LAYER = BENCH["end_to_end"], BENCH["per_layer"]
WIDTH = re.compile(r"hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spmv_bench"]
    assert BENCH["command"] == ["python3", "spmv_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line_ok(c["source"])
        assert _line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        assert c["file"].startswith("spmv_bench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert all(k in data or k in data["params"] for k in c["reduced"])
        assert callable(harness.generator(data).generate)
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = harness.mix_of(w)
        drive = harness.driver(mix)
        for part in ("prepare", "window", "release", "check"):
            assert callable(getattr(drive, part))
        assert mix["limits"]


def test_metrics():
    names = [m["name"] for m in E2E + LAYER]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in E2E:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in E2E)
    for m in LAYER:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace",
                               "program_counter", "program_span")
        assert _line_ok(m["layer"])
        moved = next(e for e in E2E if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
    for m in E2E + LAYER:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        e2e = harness.metrics_of(BENCH, cell, False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.metrics_of(BENCH, cell, True)


def test_last_line_schema():
    out = harness.run_cell(BENCH, "lynx68.spmv", 2**35 + 1, 0.2, False,
                           device="cpu", params={"nx": 16, "extras": 5,
                                                 "diagonal": 24.0})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["device"]["count"] == 1
    assert set(out["metrics"]) == {"spmv_gnz_s", "setup_s"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"] == {"y_gap": {"value": out["checks"]["y_gap"]
                                       ["value"], "limit": 1e-9}}
    json.dumps(out)


def test_chips_are_the_cells():
    bench = json.loads(json.dumps(BENCH))
    harness.find(bench, "lynx68.spmv")["chips"] = 4
    with pytest.raises(ValueError, match="one card, not 4"):
        harness.run_cell(bench, "lynx68.spmv", 3, 0.1, False, device="cpu",
                         params={"nx": 8, "extras": 5, "diagonal": 24.0})


def test_run_exits_without_a_card():
    proc = subprocess.run(
        [sys.executable, "spmv_bench/run.py", "--workload", "lynx68.spmv",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert proc.returncode == 1 and "{" not in proc.stdout


def test_run_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "spmv_bench", tmp_path / "spmv_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from spmv_bench import harness; "
            "harness.run_cell(harness.load_json('BENCHMARK.json'), "
            "'lynx68.spmv', 1, 0.1, False, device='cpu', "
            "params={'nx': 8, 'extras': 5, 'diagonal': 24.0})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "ellspmv_tpu_torch" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "spmv_bench/run.py", "--workload", "lynx68.spmv",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout
