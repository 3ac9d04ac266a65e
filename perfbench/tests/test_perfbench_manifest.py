"""The manifest against the benchmark's contract, and its files by name."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
M = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert M["paths"] == ["perfbench"] and M["command"][1] == "perfbench/run.py"
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in M[key]:
            assert NAME.match(x["name"]), x["name"]
            names.append((key in ("end_to_end", "per_layer"), x["name"]))
    for kind in (True, False):
        got = [n for k, n in names if k == kind]
        assert len(got) == len(set(got))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in M["configs"] + M["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in M["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_cells_and_what_they_report():
    configs = {c["name"] for c in M["configs"]}
    assert configs == {w["config"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for w in M["workloads"]:
        assert w["chips"] == 1
        assert (REPO / "perfbench/traffic" / f"{w['traffic']}.json").is_file()
        got = [m["name"] for m in M["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in got and len(got) >= 2
        assert any(_reports(m, w["name"]) for m in M["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for w in M["workloads"]:
            if _reports(m, w["name"]):
                assert _reports(e2e[m["moves"]], w["name"]), (m["name"], w["name"])


def test_files_by_name():
    for c in M["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["file"].startswith("perfbench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["limits"] and set(cfg["limits"]) <= {"gap_p999", "flip_gap_mean"}
        assert all(v > 0 for v in cfg["limits"].values())
    for m in M["end_to_end"] + M["per_layer"]:
        assert (REPO / "perfbench/metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("name", ["ts_total_fast", "ts_total"])
def test_published_widths(name):
    cfg = json.loads((REPO / f"perfbench/configs/{name}.json").read_text())
    net = cfg["network"]
    assert net["features_per_stage"] == [32, 64, 128, 256, 320, 320]
    assert cfg["patch_size"] == [128, 128, 128] and cfg["folds"] == [0]
    assert sum(m["num_classes"] - 1 for m in cfg["models"]) == 117
