"""The checks a BENCHMARK.json has to pass, as functions of the benchmark
dict and the checkout that holds its files, so that the tests can run them
on this checkout and on a copy with a cell added."""

from __future__ import annotations

import json
import os
import re

from tiny_cells import form

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys that name a width, which `reduced` may never name, matched whole: a
# hidden, intermediate, latent, state, head or projection size, a `_dim` or
# `_rank`, an expansion factor, the experts per token; never a depth such as
# `num_hidden_layers`, an expert count or a vocabulary
WIDTH = re.compile(
    r"(_dims?|rank|_headdim)$|(^|_)d_(model|ff|inner|state|conv|head|ssm)$|"
    r"(hidden|intermediate|latent|state|head|ffn|projection|proj|embed|embedding|model|inner|"
    r"mlp|kv)_(size|width)$|(^|_)(expand|expansion|expansion_(factor|ratio|rate))$|"
    r"experts_per_tok(en)?$|(^|moe_|router_|experts_|dynamic_)top_?k$|active_primary_experts$|"
    r"^(idim|odim|width|n_embd|n_inner|kv_channels|mlp_ratio|patch_size|transformer_linear_units|"
    r"n_activated_experts)$", re.I)
# PR 17's per-layer metrics, which read the program's spans and counters
THIRTEEN = ("embed.fill_ms", "embed.launch_ms", "embed.idle_in_fill_share",
            "embed.idle_in_launch_share", "embed.patch_useful_share", "query.text_host_ms",
            "query.text_device_ms", "query.text_rows_useful_share", "query.search_device_ms",
            "train.frontend_device_ms", "train.forward_device_ms", "train.backward_device_ms",
            "train.optimizer_device_ms")


def _one_line(text, most: int = 200) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text \
        and "\t" not in text


def check_reduced(entry: dict, conf: dict) -> None:
    """A configuration's cuts: `reduced` lists dotted key paths of its file,
    none a width; a cut file states each key's published value under
    `published` and the deployment it stands for under `deployment`, and
    sizes its builder set go under `assumed`."""
    reduced = entry["reduced"]
    assert isinstance(reduced, list) and len(reduced) <= 16 and len(set(reduced)) == len(reduced)
    assert conf.get("reduced", reduced) == reduced, "the file's `reduced` is the entry's"
    for key in reduced:
        assert isinstance(key, str) and NAME.match(key), key
        assert not any(WIDTH.search(part) for part in key.split(".")), f"{key} is a width"
        node = conf
        for part in key.split("."):
            assert isinstance(node, dict) and part in node, f"{key} does not resolve in the file"
            node = node[part]
        assert key in conf.get("published", {}), f"no published value of {key}"
        assert conf["published"][key] != node, f"{key} is as published: not a cut"
    if reduced:
        assert set(conf["published"]) == set(reduced)
        assert _one_line(conf.get("deployment")), "a cut file states its deployment on one line"
    assert isinstance(conf.get("assumed", {}), dict)


def check_shape(bench: dict, root: str) -> None:
    """BENCHMARK.json's keys, names, limits and cuts, its configuration
    files read from `root`."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["why"]) and _one_line(c["source"])
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        with open(os.path.join(root, c["file"])) as f:
            check_reduced(c, json.load(f))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:  # every cell that reports it reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])


def check_thirteen(bench: dict) -> None:
    """PR 17's thirteen per-layer metrics, found by name wherever they stand,
    each once and in the order they were added; a device number comes from
    the trace, the others from the program's spans and counters."""
    found = [m for m in bench["per_layer"] if m["name"] in THIRTEEN]
    assert [m["name"] for m in found] == list(THIRTEEN)
    for m in found:
        device = m["source"] == "device_trace"
        assert device == ("device" in m["name"] or "idle" in m["name"]), m["name"]
        assert m["source"] in ("device_trace", "program_span", "program_counter")


def check_tiny(bench: dict, root: str) -> None:
    """Every cell has its CPU form, tiny/<cell>.py, with a `config()` that
    gives the configuration's groups and a `TRAFFIC` of the mix's keys."""
    for w in bench["workloads"]:
        tiny = form(w["name"], root)
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        with open(os.path.join(root, conf["file"])) as f:
            real = json.load(f)
        bookkeeping = {"published", "deployment", "assumed"}
        assert set(real) - bookkeeping <= set(tiny.config()), w["name"]
        with open(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")) as f:
            mix = json.load(f)
        assert isinstance(tiny.TRAFFIC, dict) and set(tiny.TRAFFIC) <= set(mix), w["name"]
