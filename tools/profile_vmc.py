"""Where the time of a VMC step goes on the card: the bench VMC
configuration (phase V1 of ``chip_smoke.py``) and the variational
example (V2).

    PYTHONPATH=. python tools/profile_vmc.py

Prints the card's name and power limit, then for each window (V1, V1
without S(k), V2) one JSON line with the profiled block's wall time and
device time and the kernels that take the most device time per step,
then the unprofiled host time per step of two more blocks.  Last come
the device times of the step's items at the V1 shape (CUDA events), and
the host time of packing the kernel's parameters (``pack_params``, which
the samplers do once per run) beside the host time of a K1 log call that
packs its own and of one given the packed vector.  Needs a CUDA device.
"""
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import pairwise
from phd_qmclib_torch.samplers import vmc


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


def host_ms(fn, reps: int) -> float:
    """Mean host time to enqueue ``fn()``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / reps


def profile_window(label: str, sampling: vmc.Sampling, confs, steps: int,
                   device) -> None:
    state = sampling.build_state(confs, dtype=torch.float32, device=device)
    blocks = sampling.blocks(steps, state)
    next(blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        next(blocks)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for event in prof.key_averages():
        dev_us = getattr(event, "self_device_time_total", None)
        if dev_us is None:
            dev_us = event.self_cuda_time_total
        if dev_us > 0 and event.device_type.name == "CUDA":
            rows.append((dev_us, event.key, event.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    print(json.dumps({"window": label, "steps": steps,
                      "wall_ms_profiled": wall_ms,
                      "device_ms_total": total_ms,
                      "device_busy_share_profiled": total_ms / wall_ms}),
          flush=True)
    for dev_us, key, count in rows[:25]:
        print(f"{label} {dev_us / 1e3 / steps:10.4f} ms/step "
              f"{100 * dev_us / 1e3 / total_ms:6.2f}% n={count:6d} "
              f"{key[:110]}")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(blocks)  # ends in a fetch
        print(json.dumps({"window": label, "unprofiled_ms_per_step":
                          (time.perf_counter() - t0) * 1e3 / steps}),
              flush=True)


def main() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    spec = mrbp.Spec(**cs.VMC_SPEC)
    chains, nop = cs.VMC_CHAINS, cs.VMC_NOP
    v1 = vmc.Sampling(spec, move_spread=0.4, rng_seed=1, num_walkers=chains,
                      ssf_est_spec=vmc.SSFEstSpec(num_modes=32))
    v2 = vmc.Sampling(spec, move_spread=0.25, rng_seed=7, num_walkers=chains,
                      est_every=8, ssf_est_spec=vmc.SSFEstSpec(num_modes=64),
                      obd_est_spec=vmc.OBDEstSpec(num_pos=32,
                                                  est_every_mult=8))
    bare = vmc.Sampling(spec, move_spread=0.4, rng_seed=1,
                        num_walkers=chains)
    confs = np.random.default_rng(0).uniform(
        0.0, float(nop), (chains, nop)).astype(np.float32)
    for label, sampling, steps in (("V1", v1, 32), ("V1 without S(k)", bare,
                                                    32), ("V2", v2, 64)):
        profile_window(label, sampling, confs, steps, device)

    funcs = v1.core_funcs
    cfc = mrbp.cast_params(v1.cfc_params, torch.float32, device)
    pos = torch.as_tensor(confs, device=device)
    params = pairwise.pack_params(cfc, torch.float32, device)
    offsets = torch.as_tensor(v2.obd_pos_offsets, dtype=torch.float32,
                              device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    items = {
        "K1 log (log_psi_and_energy)": (
            lambda: funcs.log_psi_and_energy(pos, cfc, params), 20),
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
        "pack_params": (
            lambda: pairwise.pack_params(cfc, torch.float32, device), 200),
    }
    for name, (fn, reps) in items.items():
        print(json.dumps({"item": name, "device_ms": device_ms(fn, reps)}),
              flush=True)
    # Few enough K1 calls that the launch queue never fills and the host
    # clock reads the enqueue alone.
    host = {
        "pack_params": (lambda: pairwise.pack_params(cfc, torch.float32,
                                                     device), 200),
        "K1 log with pack_params": (
            lambda: funcs.log_psi_and_energy(pos, cfc), 20),
        "K1 log, parameters packed once": (
            lambda: funcs.log_psi_and_energy(pos, cfc, params), 20),
    }
    for name, (fn, reps) in host.items():
        print(json.dumps({"host_item": name, "host_ms": host_ms(fn, reps)}),
              flush=True)


if __name__ == "__main__":
    main()
