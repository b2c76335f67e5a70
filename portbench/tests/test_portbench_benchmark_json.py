"""BENCHMARK.json holds to the benchmark's contract, and every name in it
has its file under portbench/."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert (ROOT / bench["command"][1]).is_file()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in bench[kind]]
        assert len(seen) == len(set(seen))


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used, f"{c['name']} has no cell"
        assert c["file"].startswith("portbench/")
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (PB / "mixes" / f"{w['traffic']}.json").is_file()
        with open(PB / "workloads" / f"{w['name']}.json") as f:
            cell = json.load(f)
        assert (PB / "drivers" / f"{cell['driver']}.py").is_file()
        assert cell["limits"]
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def _reports(bench, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        for c in cells:
            if _reports(bench, m, c):
                assert _reports(bench, e2e[m["moves"]], c), (m["name"], c)
    for c in cells:
        reported = [m for m in bench["end_to_end"] if _reports(bench, m, c)]
        assert any(m["name"] == "setup_s" for m in reported)
        assert len(reported) >= 2
        assert any(_reports(bench, m, c) for m in bench["per_layer"])


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
