"""The NH3 cell on the CPU: ``nh3_irdc`` under the ``nh3_bright_3u`` mix,
shrunk to a few pixels and a small nlive, through the cube ladder is
correct and its refit rows are read from the program's counter; the
manifest reports the cell's metrics; K1's work counts both
transitions' lines and channels."""

import time
from types import SimpleNamespace

import pytest

import run
from core import gen, manifest, roofline
from reference import hyperfine

CUBE_METRICS = {"refit_wall_share.cube", "evals_per_px.cube",
                "device_idle.cube", "k1_roofline.cube", "step_mfu.cube",
                "host_syncs_per_iter.cube", "launches_per_iter.cube",
                "sampler_idle_share.cube", "graph_step_share.cube",
                "refit_rows_per_px.cube", "lnl_fused_share.cube"}


def test_the_cell_reports_the_cube_metrics():
    cell = manifest.find_cell("nh3_cube_bright")
    assert cell.config["name"] == "nh3_irdc" and cell.chips == 1
    assert {m["name"] for m in cell.per_layer} == CUBE_METRICS
    assert {m["name"] for m in cell.end_to_end} == {
        "cube_px_per_s", "peak_mem_gib", "setup_s"}
    base = manifest.load_json(manifest.BENCH_DIR / "traffic"
                              / "nh3_bright.json")
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("unit_s", "origin")} == \
        {k: v for k, v in base.items() if k not in ("unit_s", "origin")}


def test_k1_work_sums_both_transitions():
    config = manifest.find_cell("nh3_cube_bright").config
    axes = [hyperfine.make_axis(config["model"], tid, xarr)
            for tid, xarr in gen.axes(config)]
    assert [(a.trans_id, a.n_lines, a.size) for a in axes] == \
        [(1, 18, 380), (2, 21, 380)]
    assert roofline.lines_x_channels(axes) == (18 + 21) * 380
    exps, flops, nbytes = roofline.k1_work({2: 10}, 14820, 6)
    assert exps == 2 * 10 * 14820 and flops == 5 * exps
    assert nbytes == 4 * 10 * (2 * 6 + 1)


@pytest.fixture(scope="module")
def tiny_run():
    """Two units of 8 px at nlive 16, with the per-layer metric of the
    refit rows read as a traced run reads it (no card: no device
    trace; the last unit is the one a card would profile)."""
    cell = manifest.find_cell("nh3_cube_bright")
    cell.config = dict(cell.config, nlive=16, max_iter=600, batch_size=8)
    cell.traffic = dict(cell.traffic, unit_s=0.05)
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] in ("refit_rows_per_px.cube",
                                       "refit_wall_share.cube",
                                       "evals_per_px.cube")]
    result, _ = run.run_cell(cell, 2**31 + 11, 0.1, trace=True,
                             device="cpu", t_proc=time.time(),
                             log=lambda *a, **k: None)
    return result


def test_the_shrunk_cell_is_correct(tiny_run):
    assert tiny_run["correct"], tiny_run["checks"]
    assert tiny_run["attempted"] == 16 and tiny_run["failed"] == 0
    assert tiny_run["checks"]["lnz_err_gap"]["value"] <= 0.1


def test_the_shrunk_cell_reads_its_refit_rows(tiny_run):
    m = tiny_run["metrics"]
    assert m["refit_rows_per_px.cube"]["unit"] == "rows/px"
    assert m["refit_rows_per_px.cube"]["value"] >= 0.0
    assert "refit_wall_share.cube" in m and "evals_per_px.cube" in m


def _unit(counters, pixels):
    return {"pixels": pixels, "batch": SimpleNamespace(
        trace=SimpleNamespace(spans=[], counters=counters, syncs={}))}


def test_refit_rows_per_px_reads_the_untraced_batches():
    read = manifest.metric_reader("refit_rows_per_px.cube").read
    units = [_unit({"cube.refit_rows": 300}, 1024),
             {"pixels": 0, "batch": None},          # the pass was over
             _unit({"cube.refit_rows": 0}, 1024),
             _unit({"cube.refit_rows": 999}, 1024)]  # the traced unit
    ctx = SimpleNamespace(entry="cube", units=units, untraced=[0, 1, 2])
    assert read(ctx) == pytest.approx(300 / 2048)
    parent = [_unit({"ns.iterations": 10}, 1024)] * 3
    assert read(SimpleNamespace(entry="cube", units=parent,
                                untraced=[0, 1])) is None
    assert read(SimpleNamespace(entry="batch")) is None
