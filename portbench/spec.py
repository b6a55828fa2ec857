"""What a cell is, read from data: BENCHMARK.json's entry, the
configuration file, the workload file and the metric readers, each found
by its name. A new cell, configuration or per-layer metric is a new file
and a new entry; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Workload:
    """One image of the cell's traffic, rendered again and again."""
    config: str
    traffic: str
    width: int
    height: int
    spp: int
    max_depth: int
    route: str          # "auto": the program's own routing; "general":
    #                     PathOptions(megakernel=False)
    limits: dict        # each number compared (checks.NUMBERS) -> limit
    golden: str = None  # pbrt-v4's render at this size (in the file: under
    #                     portbench/; once loaded: its path); with it,
    #                     golden_mrse is compared
    golden_trim: float = 0.0    # golden_mrse's trim
    golden_window: tuple = None     # (x0, y0, x1, y1): the part of the
    #                     film that the golden shows, area-averaged to its
    #                     size; None: the whole film, at the golden's size
    reference_rows: int = None      # rows of a compared image that the
    #                     reference renders, drawn from the seed; None: all

    @property
    def paths(self) -> int:
        return self.width * self.height * self.spp

    @property
    def megakernel(self):
        """PathOptions.megakernel of the route."""
        return "auto" if self.route == "auto" else False


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    workload: Workload
    scene_path: Path
    end_to_end: tuple       # BENCHMARK.json metric entries for this cell
    per_layer: tuple


def _for_cell(metrics, cell_name):
    return tuple(m for m in metrics
                 if "workloads" not in m or cell_name in m["workloads"])


def load_workload(path: Path) -> Workload:
    d = json.loads(Path(path).read_text())
    if d["route"] not in ("auto", "general"):
        raise ValueError(f"{path}: route must be 'auto' or 'general'")
    if ("golden_mrse" in d["limits"]) != ("golden" in d):
        raise ValueError(f"{path}: golden_mrse needs a golden, and a golden "
                         f"its limit")
    return Workload(config=d["config"], traffic=d["traffic"],
                    width=int(d["width"]), height=int(d["height"]),
                    spp=int(d["spp"]), max_depth=int(d["max_depth"]),
                    route=d["route"], limits=dict(d["limits"]),
                    golden=d.get("golden"),
                    golden_trim=float(d.get("golden_trim", 0.0)),
                    golden_window=tuple(int(x) for x in d["golden_window"])
                    if "golden_window" in d else None,
                    reference_rows=int(d["reference_rows"])
                    if "reference_rows" in d else None)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its workload file
    portbench/workloads/<name>.json and its configuration file (root: a
    checkout's root)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / BENCH_DIR.name
    wl = load_workload(bench_dir / "workloads" / f"{name}.json")
    if wl.golden:
        wl = dataclasses.replace(wl, golden=str(bench_dir / wl.golden))
    if (wl.config, wl.traffic) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names config "
                         f"{wl.config!r}, traffic {wl.traffic!r}; "
                         f"BENCHMARK.json {entry['config']!r}, "
                         f"{entry['traffic']!r}")
    config = json.loads((root / configs[wl.config]["file"]).read_text())
    return Cell(name=name, chips=int(entry["chips"]), workload=wl,
                scene_path=bench_dir / config["scene"],
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


_FILM_RES = re.compile(r'"integer ([xy])resolution"\s*\[\s*\d+\s*\]')
_SPP = re.compile(r'"integer pixelsamples"\s*\[\s*\d+\s*\]')
_DEPTH = re.compile(r'"integer maxdepth"\s*\[\s*\d+\s*\]')


def scene_text(cell_or_path, wl: Workload) -> str:
    """The configuration's .pbrt text with the workload's film resolution,
    pixel samples and depth written in: a new resolution of an existing
    scene is one new workload file."""
    path = cell_or_path.scene_path if isinstance(cell_or_path, Cell) \
        else Path(cell_or_path)
    text = path.read_text()
    for pattern, what in ((_FILM_RES, "Film resolution"),
                          (_SPP, "Sampler pixelsamples"),
                          (_DEPTH, "Integrator maxdepth")):
        if len(pattern.findall(text)) != (2 if pattern is _FILM_RES else 1):
            raise ValueError(f"{path}: cannot rewrite its {what}")
    text = _FILM_RES.sub(
        lambda m: f'"integer {m.group(1)}resolution" '
                  f'[{wl.width if m.group(1) == "x" else wl.height}]', text)
    text = _SPP.sub(f'"integer pixelsamples" [{wl.spp}]', text)
    return _DEPTH.sub(f'"integer maxdepth" [{wl.max_depth}]', text)


def metric_reader(name: str):
    """The reader module metrics/<name>.py: read(ctx) -> float or None."""
    return importlib.import_module(f"portbench.metrics.{name}")
