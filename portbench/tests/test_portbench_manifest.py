"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""
import json
import re

import pytest

from portbench import manifest, traffic

DOC = manifest.load()
CELLS = [w["name"] for w in DOC["workloads"]]
METRICS = DOC["end_to_end"] + DOC["per_layer"]
E2E = {m["name"] for m in DOC["end_to_end"]}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert 1 <= len(DOC["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in DOC["command"])
    assert isinstance(DOC["run_seconds"], int)
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells = 24
    total = ((2 + 14 * cells) * (DOC["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize("name", [e["name"] for e in
                                  DOC["configs"] + DOC["workloads"]
                                  + METRICS])
def test_names_use_the_allowed_characters(name):
    assert manifest.NAME_RE.match(name)


def test_names_are_unique():
    for group in (DOC["configs"], DOC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"}
    per_layer = metric in DOC["per_layer"]
    if per_layer:
        keys |= {"layer", "moves"}
    else:
        keys |= {"bound"}
    assert set(metric) - {"workloads"} == keys
    assert manifest.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25
    assert (manifest.PKG / "metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("metric", DOC["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_every_cell_of_it_reports(metric):
    assert metric["moves"] in E2E
    moved = next(m for m in DOC["end_to_end"]
                 if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert manifest.applies(moved, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in manifest.metrics_for(DOC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_for(DOC, cell, True)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in DOC["per_layer"]}
    assert all(LINE.match(x) for x in layers)
    assert len({x.lower() for x in layers}) == len(layers)


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_cells_find_their_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert LINE.match(cell["why"])
    config = manifest.config(cell["config"])
    mix = traffic.mix(manifest.traffic(cell["traffic"]))
    limits = manifest.limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    assert mix["loop"] == "closed"
    assert hasattr(manifest.driver(config["driver"]), "Driver")
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert (manifest.ROOT / entry["file"]).exists()
    assert entry["source"].startswith("https://")
    assert len(entry["reduced"]) <= 16
    doc = manifest.config(entry["name"])
    assert doc["reduced"] == entry["reduced"]
    assert doc["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in DOC["workloads"])


def test_every_file_under_paths_has_an_allowed_name():
    for path in manifest.PKG.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(manifest.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
