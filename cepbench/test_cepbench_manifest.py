"""``BENCHMARK.json`` and the files it names: the contract's names, units,
keys and limits, and every configuration, traffic mix and per-layer
metric found by name."""
from __future__ import annotations

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in MAN["end_to_end"]}
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _names():
    for c in MAN["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in MAN["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in METRICS:
        yield m["name"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    for w in MAN["command"]:
        assert LINE.match(w) and not w.startswith("/") and ".." not in w
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert (ROOT / MAN["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    keys = {"name", "unit", "better", "source"}
    if m in MAN["end_to_end"]:
        keys |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert LINE.match(m["layer"])
        assert m["moves"] in E2E
        assert (ROOT / "cepbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert set(m) - {"workloads"} == keys
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in MAN["workloads"]}


def test_metric_names_unique_and_setup_bound():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(c["source"]) and LINE.match(c["why"])
    assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert cfg["source"] == c["source"]
    assert len(c["reduced"]) <= 16
    assert set(cfg["limits"]) == {"carry_leaves_differing",
                                  "push_stats_differing",
                                  "events_unprocessed",
                                  "model_values_differing", "ut_table_gap"}
    assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    assert w["config"] in {c["name"] for c in MAN["configs"]}
    cell = json.loads((ROOT / "cepbench" / "cells" /
                       f"{w['name']}.json").read_text())
    assert cell["lanes"] >= 1 and cell["session_sets"] >= 2
    reported = [m for m in METRICS if w["name"] in m.get("workloads",
                                                          [w["name"]])]
    e2e = {m["name"] for m in reported if m["name"] in E2E}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m not in MAN["end_to_end"] for m in reported)


def test_cells_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [w["name"] for w in MAN["workloads"]]
    assert len(names) == len(set(names))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(names) // 4)


def test_run_seconds_fits_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
