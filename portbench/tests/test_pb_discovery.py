"""The harness finds a configuration, a traffic mix, a metric and a limit
by the names a cell gives, with no edit to a file that is there: a
throwaway copy of the benchmark's data folders gains one file of each, and
a run of the new cell reads them."""
import json
import os
import shutil

import check
import run
import scenes
import traffic

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    for folder in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(PORTBENCH, folder), tmp_path / folder)
    cfg = json.loads((tmp_path / "configs" / "cornell.json").read_text())
    cfg["name"] = "box_copy"
    (tmp_path / "configs" / "box_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "traffic" / "progressive.json").read_text())
    mix.update(name="short_views", frames_per_view=4)
    (tmp_path / "traffic" / "short_views.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "frames_done.py").write_text(
        '"""frames_done: frames in the window."""\n\n\ndef read(ctx):\n    return ctx.frames\n')
    (tmp_path / "limits" / "box_copy.short_views.json").write_text(
        json.dumps({"accum_px": 0.01, "accum_mad": 0.001}))
    for module in (run, scenes, traffic, check):
        monkeypatch.setattr(module, "HERE", str(tmp_path))
    with open(os.path.join(os.path.dirname(PORTBENCH), "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "box_copy", "source": "-", "why": "-", "reduced": [],
                                "file": "portbench/configs/box_copy.json"})
    manifest["workloads"].append({"name": "box_copy.short_views", "config": "box_copy",
                                  "traffic": "short_views", "chips": 1, "why": "-"})
    manifest["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                   "bound": 0.1, "source": "host_clock",
                                   "workloads": ["box_copy.short_views"]})
    result, _ = run.run("box_copy.short_views", 11, 1.0, False, device="cpu", size=(32, 18),
                        manifest=manifest)
    assert result["metrics"]["frames_done"]["value"] == result["attempted"] > 4
    assert result["correct"], result["check"]
