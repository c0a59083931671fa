"""The variational example at a chosen block length, unsharded and on
gloo ranks of one card: E/N and acceptance side by side.

    PYTHONPATH=. python tools/vmc_blocks.py [--steps 256 512]
                                            [--burn 1 4] [--ranks 2]

Runs ``examples/vmc_variational.yml``'s procedure (``chip_smoke.
VARIATIONAL_PROC``: N=64, L=64, 16,384 chains, move_spread 0.25, f32,
64-mode S(k) and 32-point OBDM) from its regular start through
``vmc.Proc.exec``, as ``chip_smoke.py``'s R2 does, and the same on
``--ranks`` gloo ranks on the card, as its M5 does: for every block
length in ``--steps`` and every burn-in in ``--burn``, one run of
``burn`` burn-in blocks and one measured block, unsharded and sharded in
turns.  A sharded run draws other streams (each shard's seed), so the
two agree statistically, not bit for bit.  Prints the card's name and
power limit, then one JSON line per run.  Needs a CUDA device.
"""
import argparse
import json
import subprocess
import time

import torch

import chip_smoke as cs
from phd_qmclib_torch.qmc_exec import vmc as vmc_exec


def run(device, steps: int, burn: int, ranks: int) -> dict:
    proc = vmc_exec.Proc.from_config(cs.VARIATIONAL_PROC).evolve(dict(
        num_blocks=1, burn_in_blocks=burn, num_steps_block=steps,
        keep_iter_data=True,
        num_mesh_devices=ranks if ranks > 1 else None))
    proc_input = vmc_exec.ProcInput.from_model_sys_conf_spec(
        vmc_exec.ModelSysConfSpec(dist_type="REGULAR"), proc, device=device)
    kwargs = {"mesh": cs.card_mesh(device, ranks)} if ranks > 1 else {}
    t0 = time.perf_counter()
    result, exec_ms, _, _ = cs.timed_exec(proc, proc_input, **kwargs)
    totals = result.data.blocks.energy.totals
    return {"ranks": ranks, "steps_per_block": steps, "burn_in_blocks": burn,
            "energy_per_boson": float(totals.mean()) / cs.VMC_NOP,
            "accept_rate": float(
                result.data.series.iter_props.move_stat[0].mean()),
            "wall_s": time.perf_counter() - t0,
            "step_ms_cuda_events": exec_ms / ((burn + 1) * steps)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, nargs="+", default=[256, 512])
    parser.add_argument("--burn", type=int, nargs="+", default=[1])
    parser.add_argument("--ranks", type=int, default=2)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    for steps in args.steps:
        for burn in args.burn:
            for ranks in (1, args.ranks):
                print(json.dumps({"card": card,
                                  **run(device, steps, burn, ranks)}),
                      flush=True)


if __name__ == "__main__":
    main()
