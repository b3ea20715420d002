"""The manifest and the files it names: found by name, new ones taken
with no edit, every name and unit within the allowed characters."""

import json
import re
import shutil

import pytest

from core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_resolves():
    m = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    for w in m["workloads"]:
        cell = manifest.find_cell(w["name"])
        assert manifest.entry_class(cell.traffic["entry"]).unit
        names = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for metric in cell.end_to_end + cell.per_layer:
            mod = manifest.metric_reader(metric["name"])
            assert mod.UNIT == metric["unit"]
            assert mod.SOURCE == metric["source"]
            if "layer" in metric:
                assert mod.LAYER == metric["layer"]
                assert mod.MOVES == metric["moves"]


def test_names_and_units():
    m = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in m[group]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] == 1
    for c in m["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert c["source"] == cfg["source"]


def test_a_new_cell_is_found_by_adding_files_only(tmp_path):
    """A throwaway configuration, traffic mix, entry and metric in a copy
    of the benchmark are found by name; no file already there is
    edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "nh3_irdc.json").read_text())
    (bench / "configs" / "nh3_tiny.json").write_text(json.dumps(
        dict(cfg, name="nh3_tiny", nlive=20)))
    (bench / "traffic" / "nh3_wide.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "nh3_bright.json")
                        .read_text()), rms=0.3)))
    (bench / "entries" / "echo.py").write_text(
        'class Entry:\n    def unit(self, k):\n        return k\n')
    (bench / "traffic" / "echo.json").write_text(json.dumps(
        dict(entry="echo", unit_s=1.0)))
    (bench / "metrics" / "px_count.py").write_text(
        'UNIT = "px"\nLAYER = "cube ladder (cube/fitter.py)"\n'
        'MOVES = "cube_px_per_s"\nSOURCE = "program_counter"\n\n\n'
        'def read(ctx):\n    return ctx.pixels\n')
    m["configs"].append(dict(m["configs"][0], name="nh3_tiny",
                             file="benchmark/configs/nh3_tiny.json"))
    m["workloads"].append(dict(name="nh3_tiny_wide", config="nh3_tiny",
                               traffic="nh3_wide", chips=1, why="a test"))
    m["per_layer"].append(dict(
        name="px_count", unit="px", better="higher",
        source="program_counter", layer="cube ladder (cube/fitter.py)",
        moves="cube_px_per_s", workloads=["nh3_tiny_wide"]))
    m["end_to_end"][0]["workloads"].append("nh3_tiny_wide")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    cell = manifest.find_cell("nh3_tiny_wide", path, bench)
    assert cell.config["nlive"] == 20 and cell.traffic["rms"] == 0.3
    assert [x["name"] for x in cell.per_layer] == ["px_count"]
    echo = manifest.cell_of("echo", "nh3_tiny", "echo", bench_dir=bench)
    assert manifest.entry_class(echo.traffic["entry"], bench)().unit(3) == 3
    reader = manifest.metric_reader("px_count", bench)
    assert reader.read(type("C", (), {"pixels": 7})) == 7
    for p, data in before.items():
        assert p.read_bytes() == data, p
    with pytest.raises(KeyError):
        manifest.find_cell("no_such_cell", path, bench)
