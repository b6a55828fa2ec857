"""BENCHMARK.json and the files it names: every configuration, workload and
metric reader parses and is found by its name, the entries keep to the
benchmark's contract, and a new cell is one new workload file and one new
entry."""
import json
import re
import shutil

import numpy as np
import pytest

from portbench import checks, harness, spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.load_cell(name)
    wl = cell.workload
    assert cell.chips == 1
    assert cell.scene_path.is_file()
    assert set(wl.limits) == set(checks.NUMBERS)
    assert all(v > 0 for v in wl.limits.values())
    golden = checks.read_golden(wl.golden)
    x0, y0, x1, y1 = wl.golden_window or (0, 0, wl.width, wl.height)
    assert 0 <= x0 < x1 <= wl.width and 0 <= y0 < y1 <= wl.height
    # the part of the film that the golden shows has the golden's aspect
    assert (x1 - x0) * golden.shape[0] == (y1 - y0) * golden.shape[1]
    if wl.golden_window is None:
        assert golden.shape == (wl.height, wl.width, 3)
    assert np.isfinite(golden).all() and 0 <= wl.golden_trim < 0.01
    assert wl.reference_rows is None or 0 < wl.reference_rows < wl.height
    text = spec.scene_text(cell, wl)
    assert f'"integer xresolution" [{wl.width}]' in text
    assert f'"integer pixelsamples" [{wl.spp}]' in text
    assert {m["name"] for m in cell.end_to_end} == {"paths_per_s",
                                                    "setup_s"}
    assert len(cell.per_layer) >= 1


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert NAME.match(config["name"])
    d = json.loads((ROOT / config["file"]).read_text())
    assert d["name"] == config["name"]
    assert d["reduced"] == config["reduced"] == []
    assert (spec.BENCH_DIR / d["scene"]).is_file()
    assert 1 <= len(config["source"]) <= 200
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found(name):
    m = next(x for x in BENCH["end_to_end"] + BENCH["per_layer"]
             if x["name"] == name)
    assert NAME.match(name) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.metric_reader(name).read)
    if name.endswith("_roofline_pct"):
        kernel = spec.metric_reader(name).ROOFLINE
        assert name == f"{kernel}_roofline_pct"
        assert m["unit"] == "%" and "workloads" in m


def test_bounds_and_names():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_is_data(tmp_path):
    """A new resolution of cornell: a workload file and an entry, no file
    of the benchmark edited; the harness finds it and renders it."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("refport", "tests",
                                                  "__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="cornell.16x16", config="cornell",
                                   traffic="16x16", chips=1,
                                   why="a tiny copy for the CPU test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((spec.BENCH_DIR / "workloads" / "cornell.1080p.json")
                    .read_text())
    wl.update(traffic="16x16", width=16, height=16, spp=4)
    for key in ("golden", "golden_trim", "golden_window"):
        wl.pop(key, None)
    del wl["limits"]["golden_mrse"]
    (tmp_path / "portbench" / "workloads" / "cornell.16x16.json") \
        .write_text(json.dumps(wl))
    cell = spec.load_cell("cornell.16x16", root=tmp_path)
    assert (cell.workload.width, cell.workload.spp) == (16, 4)
    result = harness.run(cell, 2 ** 31 + 7, 0.2, False, "cpu", 0.0)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"paths_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_scene_text_rewrite(tmp_path):
    p = tmp_path / "s.pbrt"
    p.write_text('Film "rgb" "integer xresolution" [400] '
                 '"integer yresolution"  [ 300 ]\n'
                 'Sampler "zsobol" "integer pixelsamples" [64]\n'
                 'Integrator "path" "integer maxdepth" [5]\n')
    wl = spec.Workload("c", "t", 20, 10, 8, 3, "auto", {})
    text = spec.scene_text(p, wl)
    assert '"integer xresolution" [20]' in text
    assert '"integer yresolution" [10]' in text
    assert '"integer pixelsamples" [8]' in text
    assert '"integer maxdepth" [3]' in text
    p.write_text('Film "rgb" "integer xresolution" [400]\n')
    with pytest.raises(ValueError):
        spec.scene_text(p, wl)
