"""Host time per DMC step, block by block, at the bench
configuration without estimators (``chip_smoke.py``'s phase D), from a
fresh start as ``tools/profile_steps.py`` runs it.

    PYTHONPATH=. python tools/dmc_block_times.py [--blocks 12] [--steps 64]

Prints the card's name and power limit, then one JSON line with, for
each block, the host milliseconds per step (clock around a block that
ends in a fetch) and the card's SM clock (``nvidia-smi``, read after
the block).  Needs a CUDA device; like ``tools/profile_steps.py`` it
runs an older checkout's package with ``PYTHONPATH=<checkout>``.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from phd_qmclib_torch.models import mrbp


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--blocks", type=int, default=12)
    parser.add_argument("--steps", type=int, default=64)
    args = parser.parse_args()
    print(smi("name,power.limit"), flush=True)
    device = torch.device("cuda", 0)
    spec = mrbp.Spec(**cs.BENCH_SPEC)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(cs.TARGET_WALKERS)]).astype(np.float32)
    sampling = cs.bench_sampling()
    state = sampling.build_state(confs, dtype=np.float32, device=device)
    blocks = sampling.blocks(state, num_time_steps_block=args.steps)
    host, clocks = [], []
    for _ in range(args.blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(blocks)  # ends in a fetch
        host.append((time.perf_counter() - t0) * 1e3 / args.steps)
        clocks.append(smi("clocks.sm"))
    print(json.dumps({"steps_per_block": args.steps,
                      "host_ms_per_step": host,
                      "sm_clock_after_block": clocks}), flush=True)


if __name__ == "__main__":
    main()
