"""BENCHMARK.json against the rules a benchmark file keeps, and every file
it names present under the benchmark's directory; the same with the
withdrawn cells' entries (benchmark/withdrawn/) merged back in, as a later
change that restores them would have it."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.tests.tiny import DATA, REPO, full_spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _cells(SPEC, m) -> set:
    """The cells that report a metric: its list, or every cell where it has none."""
    return set(m.get("workloads", [w["name"] for w in SPEC["workloads"]]))


@pytest.fixture(params=["committed", "with_withdrawn"])
def SPEC(request):
    if request.param == "committed":
        return json.loads((REPO / "BENCHMARK.json").read_text())
    return full_spec()


def test_top_level(SPEC):
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][:3] == ["python3", "-m",
                                                                      "benchmark.run"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs(SPEC):
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file()
        assert c["reduced"] == json.loads((REPO / c["file"]).read_text())["reduced"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_workloads(SPEC):
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (DATA / "traffic" / f"{w['traffic']}.json").is_file()
        assert (DATA / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(SPEC, group):
    cells = {w["name"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC[group]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if group == "end_to_end" else {"layer", "moves"}
        # setup_s is reported in every cell, those added later too, so it lists none
        keys |= set() if m["name"] == "setup_s" else {"workloads"}
        assert set(m) == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert _cells(SPEC, m) <= cells and _cells(SPEC, m)
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"])
            assert (DATA / "metrics" / f"{m['name']}.py").is_file()
            moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
            assert _cells(SPEC, m) <= _cells(SPEC, moved)


def test_every_cell_reports_enough(SPEC):
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in _cells(SPEC, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells(SPEC, m) for m in SPEC["per_layer"])
        assert any("mfu" in m["name"] for m in SPEC["per_layer"]
                   if w["name"] in _cells(SPEC, m))
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_check_budget(SPEC):
    """A full check of 24 cells at run_seconds fits the 43200 s a check has."""
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
