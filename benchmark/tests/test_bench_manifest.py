"""BENCHMARK.json against the benchmark's contract: the keys, names and
units in the allowed characters, every file found by name, the bounds,
and the metrics each cell reports."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def text(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_size(manifest):
    assert set(manifest) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(manifest["configs"]) <= 24
    assert 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16
    assert 1 <= len(manifest["per_layer"]) <= 128


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(text(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    for w in cmd[1:]:  # files the command names lie under paths
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in paths)


def test_run_seconds_fits_a_full_check(manifest):
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text(c["source"]) and text(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text(w["why"])
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_file_is_found_by_name(manifest):
    bench = os.path.join(ROOT, "benchmark")
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert os.path.isfile(os.path.join(bench, "traffic",
                                           w["traffic"] + ".json"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics",
                                           m["name"] + ".py"))


def test_configs_name_their_sources(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert "guarantee" in cfg and "assumed" in cfg


def test_every_cell_reports_what_it_must(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for cell in cells:
        assert sum(reports(m, cell) for m in e2e.values()
                   if m["name"] != "setup_s") >= 1
        assert any(reports(m, cell) for m in manifest["per_layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        # each cell that reports it reports the metric it moves
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell)
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_four_chip_cells_are_at_most_a_quarter(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
