"""The manifest and the data files it names: names, units, and that every
cell, configuration and per-layer metric resolves to its files."""

from __future__ import annotations

import json
import re

import pytest

from perfbench_tiny_cells import PKG, REPO

from perfbench.lib import spec

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry


def test_manifest_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda v: v["name"] if isinstance(v, dict) else v)
def test_names_and_units(group, entry):
    assert spec.NAME_RE.match(entry["name"])
    if group in ("end_to_end", "per_layer"):
        assert spec.UNIT_RE.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if group == "workloads":
        assert spec.NAME_RE.match(entry["config"]) and spec.NAME_RE.match(entry["traffic"])
        assert TEXT_RE.match(entry["why"]) and entry["chips"] in (1, 4)
    if group == "configs":
        assert all(spec.NAME_RE.match(k) for k in entry["reduced"])
        assert TEXT_RE.match(entry["source"]) and TEXT_RE.match(entry["why"])
    if group == "per_layer":
        assert TEXT_RE.match(entry["layer"])


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert (PKG / "traffic" / f"{c.workload['traffic']}.py").exists()
    assert (PKG / "systems" / f"{c.config['kind']}.py").exists()
    assert (PKG / "reference" / f"{c.config['kind']}.py").exists()
    assert c.workload["why"] == c.entry["why"]
    assert c.workload["check"]["limits"]
    reported = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer()


def test_configs_match_files():
    for entry in MANIFEST["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        assert {"assumed", "departures", "kind"} <= set(cfg)
    files = [e["file"] for e in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {e["name"] for e in MANIFEST["configs"]}


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert callable(spec.metric_reader(metric["name"]))
    moved = {m["name"]: m for m in MANIFEST["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if metric["name"].split(".")[0].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_layers_agree():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
