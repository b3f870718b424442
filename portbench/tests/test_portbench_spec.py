"""BENCHMARK.json and the files the harness finds by name."""

import json
import os
import re

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])
    # a per-layer metric's cells report the end-to-end metric it moves
    reports = {m["name"]: set(m.get("workloads", cells(b))) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells(b))) <= reports[m["moves"]], m["name"]


def cells(b):
    return [w["name"] for w in b["workloads"]]


def listed_metrics():
    return [m["name"] for m in bench()["per_layer"]]


def test_every_reader_file_serves_a_listed_metric():
    files = {f[:-3] for f in os.listdir(os.path.join(run.BENCH, "metrics")) if f.endswith(".py")}
    used = set()
    for name in listed_metrics():
        own = name if name in files else name.rsplit(".", 1)[0]
        assert own in files, name
        used.add(own)
    assert files == used


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_files_load_by_name(workload):
    spec = run.cell_spec(workload)
    assert spec["config"]["name"] == spec["workload"]["config"]
    assert spec["traffic"]["kind"] in ("serve", "train")
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())
    params = spec["config"]["params"]
    if isinstance(params, str):      # a path to an .npz, or a draw from a fixed seed
        assert os.path.exists(os.path.join(run.ROOT, params))
    else:
        assert params["draw"] == "glorot" and isinstance(params["seed"], int)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    assert {m["name"] for m in spec["end_to_end"]} - {"setup_s"}
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", listed_metrics())
def test_metric_reader_loads_and_reads_nothing_from_nothing(metric):
    read = run.metric_reader(metric)
    assert read({"kind": "serve"}) is None
    assert read({"kind": "train"}) is None


def test_config_files_are_the_committed_model():
    with open(os.path.join(run.ROOT, "bench_results", "config.json")) as f:
        committed = json.load(f)
    mqa = run.load_json(run.BENCH, "configs", "mqa-flagship.json")
    mha = run.load_json(run.BENCH, "configs", "mha-flagship.json")
    assert mqa["config"] == committed
    model = dict(committed["model"], dec_kv_heads=0)
    assert mha["config"] == dict(committed, model=model)
