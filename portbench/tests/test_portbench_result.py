"""The result line's schema, and the numbers compared closing standard
error and the line, on a cell cut to the CPU."""

import json

import pytest

from portbench import run
from tiny_cells import context


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace, capsys):
    ctx = context("caco_base.embed_10s", trace=bool(trace))
    out = run.execute(ctx)
    capsys.readouterr()
    run.emit(out)
    got = capsys.readouterr()
    line = json.loads(got.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {"embed.device_idle_share", "embed.mfu",
                                        "embed.attention_roofline", "embed.gemm_roofline"}
    else:
        assert set(line["metrics"]) == {"audio_clips_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    err = got.err.strip().splitlines()
    assert err[-1].startswith("check embed_gap ") and " limit " in err[-1]
    assert line["checks"]["embed_gap"]["limit"] == ctx.cell.limits["embed_gap"]
