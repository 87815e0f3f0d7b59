"""BENCHMARK.json keeps to its contract, every name in it resolves to its
files, every cell has its CPU form, and a new cell, mix, configuration
(cut to a chip or not), metric and CPU form are new files and entries
alone."""

import copy
import filecmp
import json
import os
import shutil

import pytest

from contract import check_shape, check_thirteen, check_tiny
from portbench import harness
from tiny_cells import ROOT, cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_shape():
    check_shape(BENCH, ROOT)
    assert {c["name"]: c["reduced"] for c in BENCH["configs"]} == {"caco_base": [],
                                                                   "audiomae_base": []}


def _cut_root(tmp_path, reduced, **file_keys) -> dict:
    """A checkout in tmp_path whose caco_base entry lists `reduced` and
    whose file carries `file_keys` (six audio layers of twelve, and a
    catalog-style `text_config` group cut to 4 of its 27 layers)."""
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    for c in BENCH["configs"]:
        shutil.copy(os.path.join(ROOT, c["file"]), tmp_path / c["file"])
    path = tmp_path / "portbench" / "configs" / "caco_base.json"
    conf = json.loads(path.read_text())
    conf["audio"]["num_layers"] = 6
    conf["text_config"] = {"num_hidden_layers": 4, "hidden_size": 2048}
    path.write_text(json.dumps(dict(conf, reduced=reduced, **file_keys)))
    bench = copy.deepcopy(BENCH)
    bench["configs"][0]["reduced"] = reduced
    return bench


DEPLOY = "the audio tower's layers split over two chips, six each, as pipeline stages"


@pytest.mark.parametrize("reduced, file_keys", [
    (["audio.num_layer"], dict(published={"audio.num_layer": 12}, deployment=DEPLOY)),
    (["audio.num_layers"], dict(deployment=DEPLOY)),
    (["audio.num_layers"], dict(published={"audio.num_layers": 12})),
    (["audio.num_layers"], dict(published={"audio.num_layers": 12}, deployment="two\nlines")),
    (["audio.num_layers"], dict(published={"audio.num_layers": 6}, deployment=DEPLOY)),
    (["audio.hidden_size"], dict(published={"audio.hidden_size": 1024}, deployment=DEPLOY)),
    (["text_config.hidden_size"], dict(published={"text_config.hidden_size": 4096},
                                       deployment=DEPLOY)),
], ids=["unresolved", "no_published", "no_deployment", "deployment_lines", "not_a_cut", "a_width",
        "a_nested_width"])
def test_shape_refuses_a_cut_it_cannot_read(tmp_path, reduced, file_keys):
    with pytest.raises(AssertionError):
        check_shape(_cut_root(tmp_path, reduced, **file_keys), str(tmp_path))


@pytest.mark.parametrize("key, published", [("audio.num_layers", 12),
                                              ("text_config.num_hidden_layers", 27)])
def test_shape_takes_a_stated_cut(tmp_path, key, published):
    """A depth cut is no width, also where its key holds `hidden`."""
    bench = _cut_root(tmp_path, [key], published={key: published}, deployment=DEPLOY, assumed={})
    check_shape(bench, str(tmp_path))


@pytest.mark.parametrize("cell_name", CELLS)
def test_every_cell_resolves(cell_name):
    c = harness.resolve(ROOT, cell_name)
    assert c.driver().run and c.limits and c.ref.leaves
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert c.reader(m["name"]).read({}) is None  # nothing to read, nothing reported


@pytest.mark.parametrize("cell_name", CELLS)
def test_every_cell_has_a_tiny_form(cell_name):
    bench = dict(BENCH, workloads=[w for w in BENCH["workloads"] if w["name"] == cell_name])
    check_tiny(bench, ROOT)
    tiny = cell(cell_name)
    assert tiny.name == cell_name and tiny.config != harness.resolve(ROOT, cell_name).config


def _files(root) -> set:
    out = set()
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out |= {os.path.relpath(os.path.join(d, f), root) for f in files}
    return out


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """A throw-away configuration cut to a chip, mix, metric appended at the
    end of `per_layer`, CPU form and cell, added as files and entries in a
    copy of the checkout, resolve and keep the contract with no other file
    of the copy changed."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path)
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "caco_base.json").read_text())
    cfg["audio"]["num_layers"] = 6
    cut = dict(cfg, name="caco_cut", reduced=["audio.num_layers"],
               published={"audio.num_layers": 12}, deployment=DEPLOY)
    added = {"portbench/configs/caco_cut.json", "portbench/configs/caco_cut_ref.py",
             "portbench/traffic/embed_5s.json", "portbench/limits/caco_cut.embed_5s.json",
             "portbench/metrics/embed.calls.py", "portbench/tests/tiny/caco_cut.embed_5s.py"}
    (tmp_path / "portbench/configs/caco_cut.json").write_text(json.dumps(cut))
    shutil.copy(pb / "configs" / "caco_base_ref.py", pb / "configs" / "caco_cut_ref.py")
    mix = json.loads((pb / "traffic" / "embed_10s.json").read_text())
    (pb / "traffic" / "embed_5s.json").write_text(json.dumps(dict(mix, buffer_seconds=5)))
    (pb / "limits" / "caco_cut.embed_5s.json").write_text('{"embed_gap": 0.5}')
    (pb / "metrics" / "embed.calls.py").write_text("def read(c):\n    return c.get('calls')\n")
    (pb / "tests" / "tiny" / "caco_cut.embed_5s.py").write_text(
        "from tiny_cells import caco as config  # noqa: F401\n\n"
        "TRAFFIC = dict(buffer_seconds=0.5, batch_size=4, pool_clips=6)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "caco_cut", "source": "https://example.org/caco",
                             "file": "portbench/configs/caco_cut.json",
                             "reduced": ["audio.num_layers"], "why": "a test"})
    bench["workloads"].append({"name": "caco_cut.embed_5s", "config": "caco_cut",
                               "traffic": "embed_5s", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_clips_per_s":
            m["workloads"].append("caco_cut.embed_5s")
    bench["per_layer"].append({"name": "embed.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "audio_clips_per_s", "workloads": ["caco_cut.embed_5s"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    root = str(tmp_path)
    check_shape(bench, root)
    check_thirteen(bench)
    check_tiny(bench, root)
    c = harness.resolve(root, "caco_cut.embed_5s")
    assert c.traffic["buffer_seconds"] == 5 and c.limits == {"embed_gap": 0.5}
    assert c.config["name"] == "caco_cut" and c.config["audio"]["num_layers"] == 6
    assert c.driver().__file__.startswith(root)
    assert [m["name"] for m in c.per_layer] == ["embed.calls"]
    assert c.reader("embed.calls").read({"calls": 3}) == 3
    assert {m["name"] for m in c.end_to_end} == {"audio_clips_per_s", "setup_s"}
    tiny = cell("caco_cut.embed_5s", root)
    assert tiny.traffic["buffer_seconds"] == 0.5 and tiny.limits == {"embed_gap": 0.5}

    now = _files(tmp_path)
    assert now - before == added
    changed = {f for f in before
               if not filecmp.cmp(tmp_path / f, os.path.join(ROOT, f), shallow=False)}
    assert changed == {"BENCHMARK.json"}
