"""BENCHMARK.json keeps to its contract, every name in it resolves to its
files, and a new cell, mix, configuration and metric are new files and
entries alone."""

import json
import os
import re
import shutil

import pytest

from portbench import harness
from tiny_cells import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:  # every cell that reports it reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.resolve(ROOT, cell)
    assert c.driver().run and c.limits and c.ref.leaves
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert c.reader(m["name"]).read({}) is None  # nothing to read, nothing reported


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """A throw-away configuration, mix, metric and cell added as files and
    entries in a copy of the checkout resolve without an edit elsewhere."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "caco_base.json").read_text())
    (pb / "configs" / "caco_wide.json").write_text(json.dumps(dict(cfg, name="caco_wide")))
    shutil.copy(pb / "configs" / "caco_base_ref.py", pb / "configs" / "caco_wide_ref.py")
    mix = json.loads((pb / "traffic" / "embed_10s.json").read_text())
    (pb / "traffic" / "embed_5s.json").write_text(json.dumps(dict(mix, buffer_seconds=5)))
    (pb / "limits" / "caco_wide.embed_5s.json").write_text('{"embed_gap": 0.5}')
    (pb / "metrics" / "embed.calls.py").write_text("def read(c):\n    return c.get('calls')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "caco_wide", "source": "https://example.org/caco",
                             "file": "portbench/configs/caco_wide.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "caco_wide.embed_5s", "config": "caco_wide",
                               "traffic": "embed_5s", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_clips_per_s":
            m["workloads"].append("caco_wide.embed_5s")
    bench["per_layer"].append({"name": "embed.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "audio_clips_per_s", "workloads": ["caco_wide.embed_5s"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.resolve(str(tmp_path), "caco_wide.embed_5s")
    assert c.traffic["buffer_seconds"] == 5 and c.limits == {"embed_gap": 0.5}
    assert c.config["name"] == "caco_wide" and c.driver().__file__.startswith(str(tmp_path))
    assert [m["name"] for m in c.per_layer] == ["embed.calls"]
    assert c.reader("embed.calls").read({"calls": 3}) == 3
    assert {m["name"] for m in c.end_to_end} == {"audio_clips_per_s", "setup_s"}
