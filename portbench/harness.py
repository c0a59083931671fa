"""Set-up, the timed window and the traced blocks of one run of a cell.

The window is one call of the program's execution layer,
``qmc_exec.dmc.Proc.exec`` or ``qmc_exec.vmc.Proc.exec``, on a state that
set-up made on the card from the seed and warmed by a block of the cell's
own shapes.  Set-up picks the window's depth from the warm block's time,
so that the call covers at least the run's seconds; the rates are all
the window's steps over all of its time.  A traced run profiles whole
blocks of the same call, started and stopped by its per-block hook.
"""
import logging
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

import capture
import yardstick

__all__ = ["Run", "Window", "run_window", "set_up"]

#: A warm block shorter than this is followed by a second one, whose time
#: then sets the window's depth: a block of a few hundred milliseconds
#: reads its first-call costs in its own time.
WARM_AGAIN_SECONDS = 2.0
#: Where a traced run writes its Chrome trace, inside the checkout.
TRACE_DIR = Path("build") / "portbench"


def _program(sampler: str):
    """The program's execution layer and sampler module of a sampler."""
    if sampler == "dmc":
        from phd_qmclib_torch.qmc_exec import dmc as proc_module
        from phd_qmclib_torch.samplers import dmc as sampler_module
    else:
        from phd_qmclib_torch.qmc_exec import vmc as proc_module
        from phd_qmclib_torch.samplers import vmc as sampler_module
    logging.getLogger("phd-qmclib-torch").setLevel(logging.WARNING)
    return proc_module, sampler_module


def start_positions(cell, seed: int, device) -> np.ndarray:
    """The walkers' or chains' first positions, made on the card from
    the seed: uniform on ``[0, L)``, or the regular lattice start."""
    model = cell.config["proc"]["model_spec"]
    nop, length = int(model["boson_number"]), float(model["supercell_size"])
    if cell.traffic["start"] == "regular":
        row = torch.arange(nop, dtype=torch.float64, device=device) \
            * (length / nop)
        pos = row.expand(cell.walkers, nop)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        pos = torch.rand((cell.walkers, nop), generator=gen,
                         dtype=torch.float64, device=device) * length
    return pos.to(torch.float32).cpu().numpy()


@dataclass
class Run:
    """What set-up hands the window."""
    cell: object
    seed: int
    proc_module: object
    sampler_module: object
    start: dict          # the state set-up built, on the host
    state: object        # the warmed state the window starts from
    warm_blocks: int
    block_seconds: float
    num_blocks: int
    phases: dict         # set-up's parts, host seconds by name


def _host_state(state) -> dict:
    return {name: value.detach().to("cpu")
            for name, value in state._asdict().items()
            if isinstance(value, torch.Tensor) and name != "itc_buf"}


def set_up(cell, seed: int, seconds: float, device) -> Run:
    """Build the state from the seed, warm it by a block of the cell's
    shapes (two where one is short), and choose the window's depth: at
    least the traffic's ``min_blocks``, and enough blocks of the last warm
    block's time to cover ``seconds``."""
    begun = time.perf_counter()
    proc_module, sampler_module = _program(cell.sampler)
    t1 = time.perf_counter()
    proc = proc_module.Proc.from_config(cell.proc_config(seed, 1, 0))
    pos = start_positions(cell, seed, device)
    state = proc.sampling.build_state(pos, dtype=np.dtype(
        cell.config["proc"]["dtype"]), device=device)
    start = _host_state(state)
    t2 = time.perf_counter()
    warm = 0
    while True:
        proc = proc_module.Proc.from_config(cell.proc_config(seed, 1, warm))
        _sync(device)
        t0 = time.perf_counter()
        state = proc.exec(proc_module.ProcInput(state)).state
        _sync(device)
        block_seconds = time.perf_counter() - t0
        warm += 1
        if warm > 1 or block_seconds >= WARM_AGAIN_SECONDS:
            break
    num_blocks = max(int(cell.traffic.get("min_blocks", 1)),
                     math.ceil(seconds / block_seconds))
    phases = {"import_program": t1 - begun, "build_state": t2 - t1,
              "warm_blocks": time.perf_counter() - t2}
    return Run(cell, seed, proc_module, sampler_module, start, state, warm,
               block_seconds, num_blocks, phases)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class BlockProfiler:
    """A ``torch.profiler`` session over whole blocks of the window,
    driven by the execution layer's per-block hook: it starts when
    ``skip`` blocks have ended (before the call where ``skip`` is 0) and
    stops when ``count`` more have."""

    def __init__(self, skip: int, count: int, device):
        self.skip, self.count, self.device = skip, count, device
        self.ends = 0
        self.prof = None
        self.done = False

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        _sync(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def hook(self, _resume_input):
        self.ends += 1
        if self.ends == self.skip:
            self.start()
        elif self.ends == self.skip + self.count and self.prof is not None:
            _sync(self.device)
            self.prof.stop()
            self.done = True

    def reduce(self, steps: int) -> dict:
        if not self.done:
            return None
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / "trace.json"
        try:
            self.prof.export_chrome_trace(str(path))
            events = yardstick.read_chrome_trace(path)
        finally:
            if path.exists():
                path.unlink()
        return yardstick.reduce_trace(events, steps)


@dataclass
class Window:
    """What the window produced and how long it took."""
    started: float       # the host clock at the call
    seconds: float
    num_blocks: int
    steps: int
    memory_peak_bytes: int
    records: dict
    handoff: int
    attempted: int       # the window's blocks
    failed: int          # blocks whose energy total is not finite
    trace: dict          # the reduced trace of the profiled blocks


def run_window(run: Run, device, traced: bool) -> Window:
    """The timed call: one ``Proc.exec`` over ``run.num_blocks`` blocks,
    the checked steps recorded, whole blocks profiled where ``traced``."""
    cell = run.cell
    config = cell.proc_config(run.seed, run.num_blocks, run.warm_blocks)
    profiler = None
    kwargs = {}
    if traced:
        # One whole block after the first: every estimator's cadence
        # comes round within a block.
        profiler = BlockProfiler(1 if run.num_blocks > 1 else 0, 1, device)
        config["checkpoint_every"] = 1
        kwargs["checkpoint_hook"] = profiler.hook
    proc = run.proc_module.Proc.from_config(config)
    total = run.num_blocks * cell.steps_per_block
    cap = capture.StepCapture(run.sampler_module.Sampling, cell.sampler,
                              capture.checked_steps(run.seed, total), total)
    proc_input = run.proc_module.ProcInput(run.state)
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with cap:
        if profiler is not None and profiler.skip == 0:
            profiler.start()
        t0 = time.perf_counter()
        result = proc.exec(proc_input, **kwargs)
        _sync(device)
        seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    records = cap.records
    handoff = 0
    if records:
        last = records[max(records)]["out"]["pos"]
        handoff += _mismatches(result.state.pos, last)
        handoff += _mismatches(records[min(records)]["in"]["pos"],
                               run.state.pos)
    if len(records) != len(cap.checked):
        # Steps that never went through the sampler's _step: the check
        # could not follow them.
        print(f"the window's {total} steps made {cap.count} calls of "
              f"{run.sampler_module.__name__}.Sampling._step; the check "
              f"recorded {len(records)} of its {len(cap.checked)} steps",
              file=sys.stderr)
        handoff += 1 << 30
    totals = np.asarray(result.data.blocks.energy.totals, dtype=np.float64)
    trace = profiler.reduce(cell.steps_per_block * profiler.count) \
        if profiler is not None else None
    return Window(t0, seconds, run.num_blocks, total, int(peak), records,
                  handoff, int(totals.shape[0]),
                  int((~np.isfinite(totals)).sum()), trace)


def _mismatches(a, b) -> int:
    a, b = a.detach().to("cpu"), b.detach().to("cpu")
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())
