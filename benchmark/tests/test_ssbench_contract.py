"""BENCHMARK.json and the files it names keep to the benchmark's contract."""

import json
import re

import pytest

from benchmark.spec import ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("workloads", "end_to_end", "per_layer", "configs"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES


def test_end_to_end(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_an_end_to_end_metric(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_has_its_files(bench):
    spec = Spec()
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        used.add(w["config"])
        traffic = spec.traffic(w["traffic"])
        assert {"height", "width", "n_iterations", "backend", "options"} <= set(traffic)
        limits = spec.limits(w["name"])
        assert set(limits) == {"chain_err", "sample_err"} and all(v > 0 for v in limits.values())
    assert used == configs
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert len(c["source"]) <= 200 and c["source"].startswith("https://")
        for kind in ("apps", "reference"):
            assert (ROOT / "benchmark" / kind / f"{c['name']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_four_chip_cells_are_few(bench):
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)
