"""The production live points on the CPU: ``nh3_irdc_snr`` is
``nh3_irdc`` at NestFit's ``nlive_snr_fact`` 5; the cell
``nh3_cube_snr`` reports the cube metrics and the share of graph
building; its 2,048-px cube's SNR bucket plan is one batch for each unit
of the window on every seed checked; a shrunk factor-5 NH3 pass runs
every level's batches, correct; and the reader of the graph building
share on hand-made traces."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import run
from core import gen, manifest, window
from reference import levels

DATA = Path(__file__).resolve().parent / "data"
CUBE_METRICS = {"refit_wall_share.cube", "evals_per_px.cube",
                "device_idle.cube", "k1_roofline.cube", "step_mfu.cube",
                "host_syncs_per_iter.cube", "launches_per_iter.cube",
                "sampler_idle_share.cube", "graph_step_share.cube",
                "refit_rows_per_px.cube", "lnl_fused_share.cube"}
#: seeds of the plan's check: small, near 2**31 and 2**32, and past them
PLAN_SEEDS = [0, 1, 7, 2**31 - 1, 2**31, 2**31 + 29, 2**32 - 5, 2**32 + 3,
              2**32 + 2**30, 4010000011, 4010000037, 4150000003,
              3150000011, 3150000127, 1234567891, 2718281828, 3141592653,
              999999937, 4294967291, 4500000007, 4600000001, 4700000011,
              4800000013, 4900000019]


def test_the_config_is_nh3_irdc_at_the_production_live_points():
    base = manifest.load_json(manifest.BENCH_DIR / "configs"
                              / "nh3_irdc.json")
    cfg = manifest.load_json(manifest.BENCH_DIR / "configs"
                             / "nh3_irdc_snr.json")
    assert cfg["nlive_snr_fact"] == 5 and cfg["nlive_buckets"] == 4
    assert cfg["reduced"] == {}
    assert cfg["limits"] == base["limits"]
    same = set(base) - {"name", "source", "nlive_snr_fact", "reduced",
                        "assumed"}
    assert {k: cfg[k] for k in same} == {k: base[k] for k in same}


def test_the_cell_reports_the_cube_metrics_and_the_graph_build_share():
    cell = manifest.find_cell("nh3_cube_snr")
    assert cell.config["name"] == "nh3_irdc_snr" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "cube_px_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == \
        CUBE_METRICS | {"graph_build_share.cube"}
    base = manifest.load_json(manifest.BENCH_DIR / "traffic"
                              / "nh3_bright.json")
    assert cell.traffic["map_px"] == 2048
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("unit_s", "origin", "map_px")} == \
        {k: v for k, v in base.items() if k not in ("unit_s", "origin")}
    for name in ("n2hp_cube_bright", "nh3_cube_bright"):
        assert "graph_build_share.cube" not in {
            m["name"] for m in manifest.find_cell(name).per_layer}


@pytest.mark.parametrize("seed", PLAN_SEEDS)
def test_the_plan_is_one_batch_a_unit(seed):
    """The 2,048-px cube as a run of ``seed`` makes it has a plan of as
    many batches as the window has units: one for each of 4 levels."""
    cell = manifest.find_cell("nh3_cube_snr")
    n_units = window.units_for(51, float(cell.traffic["unit_s"]))
    assert n_units == 4
    ss_data, _, _ = np.random.SeedSequence(seed % 2**64).spawn(3)
    inputs = gen.make_inputs(cell.config, cell.traffic,
                             cell.traffic["map_px"],
                             np.random.default_rng(ss_data))
    plan = levels.plan(cell.config, [d for _, _, d in inputs.spectra],
                       inputs.rms)
    assert len(plan.batches) == n_units
    assert len({lv for lv, _ in plan.batches}) == n_units
    assert sum(plan.sizes) == 2048


def tiny_cell():
    """The test-only configuration of ``data/nh3_snr_tiny.json``."""
    spec = json.loads((DATA / "nh3_snr_tiny.json").read_text())
    cell = manifest.cell_of("nh3_snr_tiny", spec["config"],
                            spec["traffic"])
    cell.config = dict(cell.config, **spec["config_changes"])
    cell.traffic = dict(cell.traffic, **spec["traffic_changes"])
    return cell, spec["seconds"]


def test_a_shrunk_factor_5_nh3_pass_is_correct(monkeypatch):
    from core import check

    cell, seconds = tiny_cell()
    seen = {}
    judge = check.judge

    def keep(*a, **k):
        seen["units"] = a[3]
        return judge(*a, **k)

    monkeypatch.setattr(check, "judge", keep)
    result, _ = run.run_cell(cell, 2**31 + 29, seconds, device="cpu",
                             t_proc=time.time(), log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] == cell.traffic["map_px"] == 64
    assert result["failed"] == 0
    ran = [(u["batch"].nlive, u["batch"].pixel_ix.size)
           for u in seen["units"]]
    assert len(ran) == seconds / cell.traffic["unit_s"]
    assert [lv for lv, _ in ran] == sorted(lv for lv, _ in ran)
    assert len({lv for lv, _ in ran}) > 1
    assert sum(n for _, n in ran) == 64


def _unit(spans):
    return {"batch": SimpleNamespace(trace=SimpleNamespace(
        spans=[(n, t0, t1, 0, {}) for n, t0, t1 in spans], counters={},
        syncs={}))}


def test_graph_build_share_reads_the_untraced_batches():
    read = manifest.metric_reader("graph_build_share.cube").read
    units = [_unit([("cube.batch", 0, 1000), ("graphs.first_run", 10, 40),
                    ("graphs.capture", 40, 60), ("ns.segment", 60, 900)]),
             {"batch": None},                    # the pass was over
             _unit([("cube.batch", 0, 600), ("cube.batch", 700, 1000),
                    ("graphs.capture", 50, 80)]),
             _unit([("cube.batch", 0, 100),      # the traced unit
                    ("graphs.first_run", 0, 90)])]
    ctx = SimpleNamespace(entry="cube", units=units, untraced=[0, 1, 2])
    assert read(ctx) == pytest.approx(100.0 * (30 + 20 + 30) / 1900)
    parent = [_unit([("cube.batch", 0, 1000), ("graphs.capture", 0, 50)])]
    assert read(SimpleNamespace(entry="cube", units=parent,
                                untraced=[0])) is None
    cpu = [_unit([("cube.batch", 0, 1000)])]
    assert read(SimpleNamespace(entry="cube", units=cpu,
                                untraced=[0])) is None
    assert read(SimpleNamespace(entry="batch")) is None
