"""Find a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells; everything
else is a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the deployment (model, spectra, priors,
  sampler and ladder settings, the limits of the output checks);
- ``traffic/<traffic>.json``: the entry the window drives and the
  parameters of the input generator;
- ``metrics/<metric>.py``: one reader per metric;
- ``entries/<entry>.py``: the ``Entry`` that drives one of the program's
  entry points, named by a traffic mix's ``"entry"``.

A later change adds a cell by adding such files and entries only.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (all cells when the metric
    names none)."""
    return cell in metric.get("workloads", [cell])


def cell_of(name, config, traffic, chips=1, bench_dir: Path = BENCH_DIR):
    """A cell of configuration ``config`` under traffic mix ``traffic``
    (their file names), with no metrics: what the CPU tests and a cell
    not yet in the manifest run."""
    return Cell(name, chips,
                load_json(bench_dir / "configs" / f"{config}.json"),
                load_json(bench_dir / "traffic" / f"{traffic}.json"), [], [])


def find_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    manifest = load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path.name}: "
                       f"{sorted(cells)}")
    w = cells[name]
    cell = cell_of(name, w["config"], w["traffic"], int(w["chips"]),
                   bench_dir)
    cell.end_to_end = [m for m in manifest["end_to_end"]
                       if reports(m, name)]
    cell.per_layer = [m for m in manifest["per_layer"] if reports(m, name)]
    return cell


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<name>.py`` (its ``read(ctx)``)."""
    return _load(bench_dir / "metrics" / f"{name}.py",
                 f"bench_metric_{name.replace('.', '_')}")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_class(name: str, bench_dir: Path = BENCH_DIR):
    """The ``Entry`` class of ``entries/<name>.py``."""
    return _load(bench_dir / "entries" / f"{name}.py",
                 f"bench_entry_{name}").Entry
