"""Where the time of a DMC and a VMC step goes on the card: the runs of
``chip_smoke.py`` (D, G1, G2, G3, V1, V2), each profiled over one block.

    PYTHONPATH=. python tools/profile_steps.py

Prints the card's name and power limit, then for each window one JSON
line with the profiled block's device time and kernel launches per
step, the kernels that take the most of it, and the host time per step
of two more blocks without the profiler.  Last come the device times of
the VMC step's items at the V1 shape (CUDA events).  Needs a CUDA device; it
reads the configurations from ``chip_smoke`` next to the package it
profiles, so the same script also profiles an older checkout
(``PYTHONPATH=<checkout>``; a checkout without the ITC estimator has no
G3 window).  G3's ITC estimator measures every 256th step, which a
64-step block never reaches: the G3 window measures it every 64th step
instead (cadence multiplier 8, the same ring buffer), once per block
like the OBDM and g2, and the "ITC only" window runs that estimator
alone, so that its kernels head the list.
"""
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.samplers import vmc

#: Steps per profiled block: 64, so that G2's and V2's every-64th-step
#: estimators fall in each block.
STEPS = 64


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_window(label: str, blocks) -> None:
    """One warm-up block, one profiled block, two timed blocks."""
    next(blocks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        next(blocks)
        torch.cuda.synchronize()
    rows = []
    for event in prof.key_averages():
        dev_us = getattr(event, "self_device_time_total", None)
        if dev_us is None:
            dev_us = event.self_cuda_time_total
        if dev_us > 0 and event.device_type.name == "CUDA":
            rows.append((dev_us, event.key, event.count))
    rows.sort(reverse=True)
    device_ms_step = sum(r[0] for r in rows) / 1e3 / STEPS
    host_ms_step = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(blocks)  # ends in a fetch
        host_ms_step.append((time.perf_counter() - t0) * 1e3 / STEPS)
    print(json.dumps({
        "window": label, "steps": STEPS,
        "device_ms_per_step": device_ms_step,
        "kernel_launches_per_step": sum(r[2] for r in rows) / STEPS,
        "unprofiled_ms_per_step": host_ms_step,
        "top_kernels_ms_per_step": [
            [key[:90], dev_us / 1e3 / STEPS, count]
            for dev_us, key, count in rows[:12]]}), flush=True)


def main() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)

    spec = mrbp.Spec(**cs.BENCH_SPEC)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(cs.TARGET_WALKERS)]).astype(np.float32)
    windows = [("D", {}), ("G1", cs.G1_ESTIMATORS), ("G2", cs.G2_ESTIMATORS)]
    if hasattr(cs, "G3_ITC"):
        from dataclasses import replace
        itc = replace(cs.G3_ITC, est_every_mult=8)
        windows += [("G3, ITC every 64th step",
                     dict(cs.G2_ESTIMATORS, itc_est_spec=itc)),
                    ("ITC only, every 64th step",
                     dict(est_every=8, itc_est_spec=itc))]
    for label, estimators in windows:
        sampling = cs.bench_sampling(**estimators)
        state = sampling.build_state(confs, dtype=np.float32, device=device)
        profile_window(label, sampling.blocks(state,
                                              num_time_steps_block=STEPS))

    vspec = mrbp.Spec(**cs.VMC_SPEC)
    chains, nop = cs.VMC_CHAINS, cs.VMC_NOP
    v1 = vmc.Sampling(vspec, move_spread=0.4, rng_seed=1, num_walkers=chains,
                      ssf_est_spec=vmc.SSFEstSpec(num_modes=32))
    v2 = vmc.Sampling(vspec, move_spread=0.25, rng_seed=7,
                      num_walkers=chains, est_every=8,
                      ssf_est_spec=vmc.SSFEstSpec(num_modes=64),
                      obd_est_spec=vmc.OBDEstSpec(num_pos=32,
                                                  est_every_mult=8))
    vconfs = np.random.default_rng(0).uniform(
        0.0, float(nop), (chains, nop)).astype(np.float32)
    for label, sampling in (("V1", v1), ("V2", v2)):
        vstate = sampling.build_state(vconfs, dtype=torch.float32,
                                      device=device)
        profile_window(label, sampling.blocks(STEPS, vstate))

    funcs = v1.core_funcs
    cfc = mrbp.cast_params(v1.cfc_params, torch.float32, device)
    pos = torch.as_tensor(vconfs, device=device)
    offsets = torch.as_tensor(v2.obd_pos_offsets, dtype=torch.float32,
                              device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    items = {
        "K1 log (log_psi_and_energy)": (
            lambda: funcs.log_psi_and_energy(pos, cfc), 20),
        "S(k) 32 harmonics": (
            lambda: funcs.fourier_density_parts_harmonics(32, pos, cfc), 20),
        "S(k) 64 harmonics": (
            lambda: funcs.fourier_density_parts_harmonics(64, pos, cfc), 20),
        "OBDM 32 offsets": (
            lambda: funcs.one_body_density_grid(offsets, pos, cfc), 3),
        "draws": (lambda: (torch.rand(pos.shape, generator=gen,
                                      device=device),
                           torch.rand(pos.shape[:1], generator=gen,
                                      device=device)), 20),
    }
    for name, (fn, reps) in items.items():
        print(json.dumps({"item": name, "device_ms": device_ms(fn, reps)}),
              flush=True)


if __name__ == "__main__":
    main()
