"""BENCHMARK.json against the contract, and every piece found by its name."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_keys_and_names():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    assert len(json.dumps(bench)) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s at this window
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES and "\n" not in m["layer"]
        assert m["workloads"] and set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_every_piece_is_a_file_found_by_name():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert harness.config_file(c["name"])["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        work = harness.workload_file(w["traffic"])
        assert harness.driver_module(work["driver"]).run
        assert harness.cell(w["name"], bench) == w
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert m["moves"] in e2e
    assert harness.roofline_names() == ["irfft", "smt", "spectrogram"]
    for kernel in harness.roofline_names():
        roof = harness.roofline_module(kernel)
        assert roof.PATTERNS and roof.PEAK in harness.PEAK and roof.BOUND in ("operations", "bytes")
        assert roof.MODULE.startswith("avlen_tpu_torch.ops.") and callable(roof.shapes)


def test_missing_pieces_are_refused():
    with pytest.raises(FileNotFoundError):
        harness.workload_file("no.such.cell")
    with pytest.raises(FileNotFoundError):
        harness.metric_module("no_such_metric.train")
    with pytest.raises(KeyError):
        harness.cell("no.such.cell")


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(w["name"], "end_to_end", bench)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(w["name"], "per_layer", bench)


def test_cell_metrics_follow_workloads_and_moves():
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "p", "moves": "a", "workloads": ["x"]},
                           {"name": "q", "moves": "a", "workloads": ["y"]},
                           {"name": "r", "moves": "setup_s", "workloads": ["x", "y"]}]}
    assert [m["name"] for m in harness.cell_metrics("x", "end_to_end", bench)] == ["a", "setup_s"]
    assert [m["name"] for m in harness.cell_metrics("x", "per_layer", bench)] == ["p", "r"]
    assert [m["name"] for m in harness.cell_metrics("y", "per_layer", bench)] == ["q", "r"]
