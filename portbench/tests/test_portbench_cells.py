"""The benchmark finds its configurations, mixes, limits and metric
readers by the names ``BENCHMARK.json`` gives, and refuses a name it
lacks."""
import json
import re

import pytest

import cells
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(workload):
    cell = cells.load_cell(ROOT, workload)
    assert cell.chips == 1
    assert cell.sampler in ("dmc", "vmc")
    assert cell.steps_per_block == 512
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    # Every number the check compares has a limit of its own.
    assert "handoff_mismatches" in cell.limits
    assert "start_gap" in cell.limits


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_loads(metric):
    assert callable(cells.load_reader(metric))


def test_names_units_and_keys_are_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for entry in (BENCH["configs"] + BENCH["workloads"]
                  + BENCH["end_to_end"] + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"])
        assert metric["better"] in ("lower", "higher")
    for metric in BENCH["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
    assert [w["name"] for w in BENCH["workloads"]] == [
        "dmc-n128-production", "dmc-n128-bare", "vmc-n64-sk",
        "vmc-n64-variational"]
    for config in BENCH["configs"]:
        assert (ROOT / config["file"]).is_file()
        assert all(NAME.match(key) for key in config["reduced"])


@pytest.mark.parametrize("kind,name", [("configs", "no-such-config"),
                                       ("traffic", "no-such-mix"),
                                       ("limits", "no-such-cell")])
def test_a_missing_file_is_refused(kind, name):
    with pytest.raises(cells.MissingEntry):
        cells._load_json(kind, name)


def test_a_missing_reader_is_refused():
    with pytest.raises(cells.MissingEntry):
        cells.load_reader("no_such_metric")


def test_a_missing_workload_is_refused():
    with pytest.raises(cells.MissingEntry):
        cells.load_cell(ROOT, "no-such-workload")


def test_proc_config_merges_config_traffic_and_depth():
    cell = cells.load_cell(ROOT, "dmc-n128-production")
    config = cell.proc_config(seed=2 ** 31 + 5, num_blocks=3, block_offset=1)
    assert config["rng_seed"] == 2 ** 31 + 5
    assert config["num_blocks"] == 3 and config["block_offset"] == 1
    assert config["burn_in_blocks"] == 0
    assert config["itc_spec"]["num_lags"] == 64
    assert config["max_num_walkers"] == 17408
