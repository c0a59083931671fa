"""The N -> infinity series on the card, held against the JAX package's
records.

    PYTHONPATH=. python tools/fs_series.py [--sizes 32 64 128 256]
                                           [--walkers 4096] [--burn 8]
                                           [--blocks 24] [--nts 512]
                                           [--out FILE]

DMC rows at N = 32, 64, 128 and 256 at unit density (L = N) and fixed
coupling: v0=20, r=1, gn=1, rm=0.4, dt=1e-3, 4,096 target walkers in
4,608 slots, f32, seeds 11, 12, ...: the defaults of the JAX package's
``benchmarks/fs_sweep.py`` (read, not imported).  The rows differ in N,
so they run one after another, each through ``dmc.Proc.exec`` from a
random start with ``--burn`` burn-in and ``--blocks`` measured blocks of
``--nts`` steps.  The fit in x = 1/N^2 (the Luttinger-liquid Casimir
term under periodic boundaries) is ``qmc_exec.report.summarize_fs_fit``
on the in-memory results (what ``mrbp_cli dmc analyze --fs-fit`` reports
from the rows' files; a GPU machine need not have ``h5py``).

Printed beside the JAX package's records (``BASELINE.md``, the
finite-size sweep: the per-N table and the fit 8.41493(82)), which hold
on any hardware.  Prints the card's name and power limit, the
procedures' logs and one JSON object of results, which ``--out`` also
writes to a file.  Needs a CUDA device.
"""
import argparse
import json
import subprocess
import time
import warnings

import numpy as np
import torch

from phd_qmclib_torch.qmc_exec import dmc as dmc_exec, report

#: The JAX package's rows (E/N, error) and its linear fit in 1/N^2.
RECORD_ROWS = {32: (8.413473, 0.000680), 64: (8.414162, 0.000782),
               128: (8.414813, 0.001486), 256: (8.417215, 0.002172)}
RECORD_FIT = (8.41493, 0.00082)


def proc(nop: int, seed: int, walkers: int, burn: int, blocks: int,
         nts: int) -> dmc_exec.Proc:
    return dmc_exec.Proc.from_config(dict(
        model_spec=dict(lattice_depth=20.0, lattice_ratio=1.0,
                        interaction_strength=1.0, boson_number=nop,
                        supercell_size=float(nop), tbf_contact_cutoff=0.4),
        time_step=1e-3, max_num_walkers=walkers + walkers // 8,
        target_num_walkers=walkers, num_blocks=blocks,
        num_time_steps_block=nts, burn_in_blocks=burn, rng_seed=seed,
        dtype="float32"))


def run(device, sizes, walkers: int, burn: int, blocks: int,
        nts: int) -> dict:
    out = {"walkers": walkers, "burn_blocks": burn, "blocks": blocks,
           "steps_per_block": nts, "rows": []}
    entries = []
    for i, nop in enumerate(sizes):
        p = proc(nop, 11 + i, walkers, burn, blocks, nts)
        pin = dmc_exec.ProcInput.from_model_sys_conf_spec(
            dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), p, device=device)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            result = p.exec(pin)
        wall = time.perf_counter() - t0
        energy = result.data.blocks.energy
        e, err = float(energy.mean) / nop, float(energy.mean_error) / nop
        row = {"boson_number": nop, "energy_per_boson": [e, err],
               "run_s": wall,
               "ms_per_step": wall * 1e3 / ((burn + blocks) * nts)}
        if nop in RECORD_ROWS:
            rec, rec_err = RECORD_ROWS[nop]
            row["record"] = [rec, rec_err]
            row["dev_in_combined_sigmas"] = (e - rec) / float(
                np.hypot(err, rec_err))
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
        entries.append((f"n{i}", result))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit = report.summarize_fs_fit(entries)
    out["fit"] = fit
    out["record_fit"] = list(RECORD_FIT)
    out["fit_dev_from_record_in_combined_sigmas"] = (
        (fit["e0"] - RECORD_FIT[0]) / float(np.hypot(fit["e0_err"],
                                                     RECORD_FIT[1])))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[32, 64, 128, 256])
    parser.add_argument("--walkers", type=int, default=4096)
    parser.add_argument("--burn", type=int, default=8)
    parser.add_argument("--blocks", type=int, default=24)
    parser.add_argument("--nts", type=int, default=512)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, **run(torch.device("cuda", 0), args.sizes,
                               args.walkers, args.burn, args.blocks,
                               args.nts)}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")


if __name__ == "__main__":
    main()
