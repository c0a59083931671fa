"""The production example at depth on the card, reblocked with the port's
own statistics layer and held against the JAX package's recorded
observables.

    PYTHONPATH=. python tools/physics_depth.py [--burn 8] [--blocks 64]
                                               [--no-itc] [--out FILE]

Runs ``examples/dmc_production.yml``'s sampling (N=128, 16,384 walkers,
f32, ``est_every`` 8, pure density, S(k), OBDM, g2, CM diffusion and,
unless ``--no-itc``, the pure ITC estimator) through the Python API from
random configurations: ``--burn`` burn-in blocks and ``--blocks``
measured blocks of 512 steps (the example runs 8 and 64).  The ITC
estimator leaves the dynamics and the other estimators bit-identical, so
one run with it gives both of the example's variants.

Each pure estimator gives one sample per block, its window's last row
over that step's walker count; the samples and the per-block energies
are reblocked with ``phd_qmclib_torch.stats`` and turned into observables
with ``phd_qmclib_torch.analysis``.  Printed beside the records of the
JAX package's run of the same example (``BASELINE.md``, "Round-4
flagship re-validation"), which hold on any hardware: E/N 8.41403(104),
condensate fraction 0.8530(4), contact g2(0) 0.5449(4), m/m* 0.820(43);
and, with ITC, the effective energies ``omega_eff(k, tau)`` at the
deepest filled lag beside the Feynman bound ``k^2 / S(k)``.

Prints the card's name and power limit, one JSON line per block
(progress) and one JSON object of results, which ``--out`` also writes to
a file.  Needs a CUDA device.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from phd_qmclib_torch import analysis
from phd_qmclib_torch.models import mrbp

#: The JAX package's records of the same example: value and error.
RECORDS = {"energy_per_boson": (8.41403, 0.00104),
           "condensate_fraction": (0.8530, 0.0004),
           "g2_contact": (0.5449, 0.0004),
           "effective_mass_ratio": (0.820, 0.043)}


def omega_eff(sums: np.ndarray, counts: np.ndarray, tau_step: float):
    """``-d ln F / d tau`` between consecutive lags from the blocks' lag
    sums ``(B, L + 1, M)`` and counts ``(B, L + 1)``, with a
    delete-one-block jackknife error."""
    def omega(s, c):
        with np.errstate(divide="ignore", invalid="ignore"):
            f = s.sum(axis=0) / c.sum(axis=0)[:, None]
            return -np.diff(np.log(np.maximum(f, 1e-300)), axis=0) / tau_step

    full = omega(sums, counts)
    num = sums.shape[0]
    loo = np.stack([omega(np.delete(sums, i, axis=0),
                          np.delete(counts, i, axis=0)) for i in range(num)])
    err = np.sqrt((num - 1) / num * ((loo - loo.mean(axis=0)) ** 2).sum(0))
    return full, err


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

    estimators = cs.G2_ESTIMATORS if args.no_itc else cs.G3_ESTIMATORS
    sampling = cs.bench_sampling(**estimators)
    spec = mrbp.Spec(**cs.BENCH_SPEC)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(cs.TARGET_WALKERS)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32, device=device)
    blocks = sampling.blocks(state, nts, burn_in_blocks=args.burn)
    t0 = time.perf_counter()
    for _ in range(args.burn):
        next(blocks)
    burn_s = time.perf_counter() - t0

    energy, samples, cmd, cmd_nw = [], {}, [], []
    itc_sums, itc_counts = [], []
    every = sampling.est_every
    t0 = time.perf_counter()
    for index in range(args.blocks):
        block = next(blocks)
        props = block.iter_props
        nw = props.num_walkers.double().numpy()
        energy.append(float(props.energy.double().sum()
                            / props.weight.double().sum()) / nop)
        for name in ("density", "ssf", "obd", "g2"):
            rows = getattr(block, f"iter_{name}").double().numpy()
            samples.setdefault(name, []).append(rows[-1] / nw[-1])
        cmd.append(block.iter_cmd.double().numpy())
        cmd_nw.append(nw[every - 1::every])
        if block.iter_itc is not None:
            itc_sums.append(block.iter_itc.double().numpy()[-1])
            itc_counts.append(block.iter_itc_nw.double().numpy()[-1])
        print(json.dumps({"block": index, "energy_per_boson": energy[-1],
                          "num_walkers": float(nw[-1]),
                          "elapsed_s": time.perf_counter() - t0}), flush=True)
    run_s = time.perf_counter() - t0

    out = {"card": card, "burn_blocks": args.burn, "blocks": args.blocks,
           "steps_per_block": nts, "itc": not args.no_itc, "burn_s": burn_s,
           "run_s": run_s, "ms_per_step": run_s * 1e3 / (args.blocks * nts),
           "records": {k: list(v) for k, v in RECORDS.items()}}
    e_mean, e_err = cs.reblocked(np.asarray(energy))
    out["energy_per_boson"] = [float(e_mean), float(e_err)]

    density, density_err = cs.reblocked(np.stack(samples["density"]))
    out["density_integral_over_n"] = float(density.sum()) / nop

    n1, n1_err = cs.reblocked(np.stack(samples["obd"]))
    offsets = sampling.obd_pos_offsets
    _, occ, occ_err = analysis.momentum_distribution(offsets, n1, sc, nop,
                                                     n1_err=n1_err)
    out["condensate_fraction"] = [float(occ[0]) / nop,
                                  float(occ_err[0]) / nop]

    counts, counts_err = cs.reblocked(np.stack(samples["g2"]))
    r, g2, g2_err = analysis.pair_correlation_from_counts(
        counts, nop, sc, counts_err=counts_err)
    contact = analysis.contact_from_pair_correlation(
        r, g2, g2_err, float(spec.interaction_strength))
    out["g2_contact"] = [float(contact[0]), float(contact[1])]

    # The CM-diffusion windows span cm_window_blocks blocks each.
    window = sampling.cm_window_blocks
    num_windows = args.blocks // window
    if num_windows:
        rows = np.concatenate(cmd[:num_windows * window]).reshape(
            num_windows, -1, 2)
        rows_nw = np.concatenate(cmd_nw[:num_windows * window]).reshape(
            num_windows, -1)
        ratio = analysis.effective_mass_from_cm_diffusion(
            sampling.time_step * every, rows, rows_nw, nop)
        out["effective_mass_ratio"] = [float(ratio[0]), float(ratio[1])]

    ssf, ssf_err = cs.reblocked(np.stack(samples["ssf"])[:, :, 0] / nop)
    momenta = sampling.ssf_momenta
    out["ssf_first_modes"] = ssf[1:5].tolist()
    k, feynman, feynman_err = analysis.feynman_spectrum(momenta, ssf, ssf_err)
    if itc_sums:
        itc_spec = sampling.itc_est_spec
        tau_step = sampling.itc_lag_times[1]
        omega, omega_err = omega_eff(np.stack(itc_sums), np.stack(itc_counts),
                                     tau_step)
        # The deepest lag that every block past the fill has counted.
        filled = min(itc_spec.num_lags, max(1, (args.blocks * nts) // int(
            round(tau_step / sampling.time_step)) - 1))
        lag = max(0, filled // 2 - 1)
        modes = list(range(1, 6))
        out["itc"] = {
            "tau_step": float(tau_step), "lag_index": lag,
            "tau_mid": float((lag + 0.5) * tau_step),
            "momenta": sampling.itc_momenta[modes].tolist(),
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
