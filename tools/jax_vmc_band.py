"""The E/N and acceptance band of ``chip_smoke.py``'s phase V1, from a VMC
run of the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_vmc_band.py \\
        --chains 2048 --seed 1 [--extra-blocks 2]

It runs the bench VMC configuration (``chip_smoke.VMC_SPEC``) with
V1's protocol (``chip_smoke.VMC_BAND_PROTOCOL``: the sampler's settings,
uniform random starts, the burn blocks and the timed blocks of
``steps_per_block`` steps) in f32 on the XLA path, and prints one JSON
line per block and a summary line.  The statistic is V1's: the mean
over the timed blocks of every step and chain.  Its error is the spread
of the independent chains' time averages over sqrt(chains); a blocking
analysis of the chain-mean series is printed beside it.  Blocks past
the timed ones (``--extra-blocks``) show how far E/N still drifts.

The band in ``chip_smoke.py`` combines three runs: 2048 chains with
seeds 1 and 2, and 4096 chains with seed 3 (a block of 2048 chains
takes about half a minute on a CPU).
"""
import argparse
import json
import time

import jax
import numpy as np

from chip_smoke import VMC_BAND_PROTOCOL, VMC_SPEC
from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.samplers import vmc


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--extra-blocks", type=int, default=0)
    args = parser.parse_args()

    protocol = VMC_BAND_PROTOCOL
    if protocol["start"] != "uniform":
        raise ValueError(f"unknown start {protocol['start']!r}")
    nop = VMC_SPEC["boson_number"]
    chains = args.chains
    sampling = vmc.Sampling(
        mrbp.Spec(**VMC_SPEC), move_spread=protocol["move_spread"],
        rng_seed=args.seed, num_walkers=chains,
        ssf_est_spec=vmc.SSFEstSpec(num_modes=protocol["ssf_modes"]))
    confs = np.random.default_rng(args.seed).uniform(
        0.0, VMC_SPEC["supercell_size"], (chains, nop)).astype(np.float32)
    blocks = sampling.blocks(protocol["steps_per_block"],
                             sampling.build_state(confs))
    burn, timed = protocol["burn_blocks"], protocol["timed_blocks"]
    t0 = time.perf_counter()
    energies, accepts = [], []
    for index in range(burn + timed + args.extra_blocks):
        block = next(blocks)
        e = np.asarray(block.iter_props.energy, dtype=np.float64) / nop
        acc = np.asarray(block.iter_props.move_stat, dtype=np.float64)
        energies.append(e)  # (steps, chains)
        accepts.append(acc)
        print(json.dumps({"block": index, "burn": index < burn,
                          "e_per_n": e.mean(), "accept": acc.mean(),
                          "e_last_step": e[-1].mean(),
                          "s": time.perf_counter() - t0}), flush=True)

    e = np.concatenate(energies[burn:burn + timed])
    acc = np.concatenate(accepts[burn:burn + timed])
    series = e.mean(axis=1)
    reblock, size = [], 1
    while len(series) // size >= 16:
        num = len(series) // size
        means = series[:num * size].reshape(num, size).mean(axis=1)
        reblock.append((size, float(means.std(ddof=1) / np.sqrt(num))))
        size *= 2
    print(json.dumps({
        "chains": chains, "seed": args.seed, "protocol": protocol,
        "jax": jax.__version__, "device": str(jax.devices()[0]),
        "e_per_n": e.mean(),
        "e_err_chains": e.mean(axis=0).std(ddof=1) / np.sqrt(chains),
        "accept": acc.mean(),
        "accept_err_chains": acc.mean(axis=0).std(ddof=1) / np.sqrt(chains),
        "reblock_series": reblock}), flush=True)


if __name__ == "__main__":
    main()
