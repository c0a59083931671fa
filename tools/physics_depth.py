"""The production example at depth on the card, through the port's own
execution layer, held against the JAX package's recorded observables.

    PYTHONPATH=. python tools/physics_depth.py [--burn 8] [--blocks 64]
                                               [--no-itc] [--out FILE]

Runs ``examples/dmc_production.yml``'s procedure (``chip_smoke.
PRODUCTION_PROC``: N=128, 16,384 walkers, f32, ``est_every`` 8, pure
density, S(k), OBDM, g2, CM diffusion and, unless ``--no-itc``, the pure
ITC estimator) as a user would start it, but from a config dict and
without files (a GPU machine need not have ``yaml`` or ``h5py``):
``dmc.Proc.from_config``, ``ProcInput.from_model_sys_conf_spec(RANDOM)``
and ``Proc.exec`` with ``--burn`` burn-in blocks and ``--blocks`` measured
blocks of 512 steps (the example runs 8 and 64).  The ITC estimator
leaves the dynamics and the other estimators bit-identical, so one run
with it gives both of the example's variants.

Every observable is read from the result's ``SamplingData``: the block
containers reblock their totals with ``phd_qmclib_torch.stats`` (one pure
sample per block, weighted by its last step's walker count), and
``phd_qmclib_torch.analysis`` turns them into the condensate fraction and
the contact.  Printed beside the records of the JAX package's run of the
same example (``BASELINE.md``, "Round-4 flagship re-validation"), which
hold on any hardware: E/N 8.41403(104), condensate fraction 0.8530(4),
contact g2(0) 0.5449(4), m/m* 0.820(43); and, with ITC, the effective
energies ``omega_eff(k, tau)`` at the deepest filled lag beside the
Feynman bound ``k^2 / S(k)``.

Prints the card's name and power limit, the procedure's log (one line per
eighth of the run) and one JSON object of results, which ``--out`` also
writes to a file.  Needs a CUDA device.
"""
import argparse
import json
import math
import subprocess
import time
import warnings

import numpy as np
import torch

import chip_smoke as cs
from phd_qmclib_torch import analysis
from phd_qmclib_torch.qmc_exec import dmc as dmc_exec

#: The JAX package's records of the same example: value and error.
RECORDS = {"energy_per_boson": (8.41403, 0.00104),
           "condensate_fraction": (0.8530, 0.0004),
           "g2_contact": (0.5449, 0.0004),
           "effective_mass_ratio": (0.820, 0.043)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--burn", type=int, default=8)
    parser.add_argument("--blocks", type=int, default=64)
    parser.add_argument("--no-itc", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    nop, sc, nts = cs.NOP, float(cs.NOP), cs.NTS

    config = dict(cs.PRODUCTION_PROC, num_blocks=args.blocks,
                  burn_in_blocks=args.burn)
    # The example's CM window of 8 blocks must tile the run.
    config["cm_diffusion_spec"] = dict(
        window_blocks=math.gcd(8, args.blocks))
    if args.no_itc:
        del config["itc_spec"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a short run's lags
        proc = dmc_exec.Proc.from_config(config)
    t0 = time.perf_counter()
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device=device)
    start_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = proc.exec(proc_input)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    blocks = result.data.blocks
    spec = proc.model_spec

    steps = (args.burn + args.blocks) * nts
    out = {"card": card, "burn_blocks": args.burn, "blocks": args.blocks,
           "steps_per_block": nts, "itc": not args.no_itc,
           "from_model_sys_conf_spec_s": start_s, "run_s": run_s,
           "ms_per_step": run_s * 1e3 / steps,
           "records": {k: list(v) for k, v in RECORDS.items()}}
    out["energy_per_boson"] = [float(blocks.energy.mean) / nop,
                               float(blocks.energy.mean_error) / nop]
    out["density_integral_over_n"] = float(blocks.density.mean.sum()) / nop

    offsets = proc.sampling.obd_pos_offsets
    _, occ, occ_err = analysis.momentum_distribution(
        offsets, blocks.one_body_dm.mean, sc, nop,
        n1_err=blocks.one_body_dm.mean_error)
    out["condensate_fraction"] = [float(occ[0]) / nop,
                                  float(occ_err[0]) / nop]

    r, g2, g2_err = blocks.pair_corr.pair_correlation(nop, sc)
    contact = analysis.contact_from_pair_correlation(
        r, g2, g2_err, float(spec.interaction_strength))
    out["g2_contact"] = [float(contact[0]), float(contact[1])]

    ratio = blocks.cm_diffusion.effective_mass_ratio()
    out["effective_mass_ratio"] = [float(ratio[0]), float(ratio[1])]
    out["cm_windows"] = blocks.cm_diffusion.num_windows

    ssf = blocks.ss_factor
    out["ssf_first_modes"] = (ssf.mean[1:5] / nop).tolist()
    _, feynman, feynman_err = ssf.feynman_spectrum(nop, sc)
    if blocks.itc is not None:
        itc = blocks.itc
        tau_mid, omega, omega_err = itc.effective_energy()
        # The deepest lag that every block past the fill has counted.
        filled = min(proc.itc_spec.num_lags, max(1, (args.blocks * nts) // int(
            round(itc.tau_step / proc.time_step)) - 1))
        lag = max(0, filled // 2 - 1)
        modes = list(range(1, 6))
        out["itc"] = {
            "tau_step": float(itc.tau_step), "lag_index": lag,
            "tau_mid": float(tau_mid[lag]),
            "momenta": itc.momenta[modes].tolist(),
            "omega_eff": omega[lag, modes].tolist(),
            "omega_eff_err": omega_err[lag, modes].tolist(),
            "omega_eff_first_lag": omega[0, modes].tolist(),
            "feynman_bound": feynman[[m - 1 for m in modes]].tolist(),
            "feynman_bound_err": feynman_err[[m - 1 for m in modes]].tolist(),
        }
    for name, (value, err) in RECORDS.items():
        if name in out:
            got, got_err = out[name]
            out[f"{name}_dev_in_combined_sigmas"] = (
                (got - value) / float(np.hypot(err, got_err)))
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")


if __name__ == "__main__":
    main()
