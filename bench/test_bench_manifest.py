"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and character sets, each metric's layer and ``moves``, the cells'
chips, and every file it names present under ``bench/``."""
from __future__ import annotations

import json
import math
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith("bench/")
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in conf
        # no width is ever reduced
        assert not re.search(r"(_dim$|_rank$|hidden_size|intermediate|"
                             r"d_model|d_ff|expand|ratio|experts_per_tok|"
                             r"head)", key), key
    assert sorted(entry["reduced"]) == sorted(conf.get("reduced", {}))
    assert conf["source"] == entry["source"]
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert entry["name"] in used


def test_config_files_are_distinct():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in MANIFEST["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_cells_of_several_cards_name_their_mesh():
    """A cell of more than one card runs its configuration's ``run.mesh``
    (axis -> size), one rank a card; at most a quarter of the cells
    (rounded down), or one, ask for more than one."""
    files = {c["name"]: c["file"] for c in MANIFEST["configs"]}
    cells = MANIFEST["workloads"]
    several = [w for w in cells if w["chips"] > 1]
    for w in several:
        mesh = json.loads((ROOT / files[w["config"]]).read_text())["run"][
            "mesh"]
        assert list(mesh) == ["data", "model"], mesh
        assert math.prod(mesh.values()) == w["chips"], (w["name"], mesh)
    assert len(several) <= max(1, len(cells) // 4)


def _reports(metric: dict) -> set:
    cells = {w["name"] for w in MANIFEST["workloads"]}
    return set(metric.get("workloads", cells))


def test_end_to_end():
    e2e = MANIFEST["end_to_end"]
    assert 1 <= len(e2e) <= 16
    names = {m["name"] for m in e2e}
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MANIFEST["workloads"]:
        got = {m["name"] for m in e2e if w["name"] in _reports(m)}
        assert "setup_s" in got and len(got) >= 2, w["name"]


def test_per_layer():
    per = MANIFEST["per_layer"]
    assert 1 <= len(per) <= 128
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in per:
        # the harness reports a per-layer metric in the cells it lists
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        # each cell that reports the metric reports what it moves
        assert m["moves"] in e2e
        assert _reports(m) <= _reports(e2e[m["moves"]]), m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in MANIFEST["workloads"]:
        assert any(w["name"] in _reports(m) for m in per), w["name"]


def test_names_are_unique():
    every = ([m["name"] for m in MANIFEST["end_to_end"]]
             + [m["name"] for m in MANIFEST["per_layer"]])
    assert len(every) == len(set(every))
    assert len({c["name"] for c in MANIFEST["configs"]}) == len(
        MANIFEST["configs"])


def test_layers_are_named_alike():
    """Metrics of one layer give the same name, and PERF.md lists it."""
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MANIFEST["per_layer"]}:
        assert layer in perf, layer
