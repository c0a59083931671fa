"""Shared fixtures of the benchmark's own tests: the benchmark's modules
on the import path, and the cells cut to a size the CPU runs in
seconds."""
import copy
import dataclasses
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

import cells  # noqa: E402


def tiny_cell(workload: str, nop: int = 8, walkers: int = 64,
              slots: int = 68, steps: int = 64):
    """``workload`` at ``nop`` bosons in ``nop`` wells, ``walkers`` walkers
    (``slots`` slots) and ``steps``-step blocks, with its estimators' grids
    and ITC lags cut to match: the same code paths at a CPU's size."""
    cell = cells.load_cell(ROOT, workload)
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    model = config["proc"]["model_spec"]
    model.update(boson_number=nop, supercell_size=float(nop))
    if "max_num_walkers" in config["proc"]:
        config["proc"].update(max_num_walkers=slots,
                              target_num_walkers=walkers)
    else:
        config["proc"]["num_walkers"] = walkers
    proc = traffic["proc"]
    for key in ("num_time_steps_block", "num_steps_block"):
        if key in proc:
            proc[key] = steps
    if "pfw_num_time_steps" in proc.get("ssf_spec", {}):
        proc["ssf_spec"]["pfw_num_time_steps"] = steps
    if "itc_spec" in proc:
        proc["itc_spec"].update(num_lags=4, est_every_mult=4)
    if "obd_spec" in proc:
        proc["obd_spec"]["num_pos"] = 5
    return dataclasses.replace(cell, config=config, traffic=traffic)


@pytest.fixture
def cuda():
    """The card, for the tests that need it; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port "
                    "on the card")
    return torch.device("cuda", 0)
