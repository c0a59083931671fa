"""The dt -> 0 series on the card as one fused sweep whose rows differ in
the time step, held against the JAX package's records.

    PYTHONPATH=. python tools/dt_series.py [--walkers 16384] [--burn 16]
                                           [--blocks 24] [--nts 512]
                                           [--check-blocks 2] [--out FILE]

The bench model (``chip_smoke.BENCH_SPEC``: v0=20, r=1, gn=1, N=128,
L=128, rm=0.4) at dt 4e-3, 2e-3, 1e-3 and 5e-4, ``--walkers`` target
walkers a row (in 17/16 as many slots, the bench's buffer), energy only,
f32, the bench's controller factor 0.125, a seed per row: four
``dmc.Proc`` stanzas run as one ``qmc_exec.sweep.SweepProc`` from
random starts, as a ``fused_sweep: true`` config runs them.  The burn-in
is uniform at the smallest dt's need: 16 blocks of 512 steps reach an
imaginary time of 4.1 at dt 5e-4 (the gas equilibrates over tau ~ 3-4,
``BASELINE.md``'s equilibration note); then ``--blocks`` measured
blocks.  Each row's E/N and error, and the weighted linear fit in dt,
three ways:

* ``fit``: ``qmc_exec.report.summarize_dt_fit`` on the in-memory
  results, what ``mrbp_cli dmc analyze --dt-fit`` reports from the rows'
  files (a GPU machine need not have ``h5py``): the error of each row
  reblocks its block totals, too few to converge at 24 blocks;
* ``fit_naive_block_errors``: the spread of the block means over the
  square root of their number, as the JAX package's
  ``benchmarks/dt_sweep.py`` reports the records (blind to the
  correlation between blocks);
* ``fit_step_reblocked_errors``: the per-step local energies of each
  row (``keep_iter_data``) reblocked with ``phd_qmclib_torch.stats``.

Before the run, ``--check-blocks`` blocks of the fused sweep are held
bit for bit against each row's standalone ``Sampling.blocks`` run with
the same seed, at the full width.

Printed beside the JAX package's records (``BASELINE.md``, config #3:
the 16-block rows and their fit 8.41720, and the flagship's 24-block fit
8.41702(10)), which hold on any hardware.  Prints the card's name and
power limit, the procedure's log and one JSON object of results, which
``--out`` also writes to a file.  Needs a CUDA device.
"""
import argparse
import json
import subprocess
import time
import warnings

import numpy as np
import torch

import chip_smoke as cs
from phd_qmclib_torch import analysis
from phd_qmclib_torch.qmc_exec import dmc as dmc_exec, report
from phd_qmclib_torch.stats import reblock
from phd_qmclib_torch.qmc_exec import sweep as sweep_exec

TIME_STEPS = (4e-3, 2e-3, 1e-3, 5e-4)
#: The JAX package's rows at N=128, 16,384 walkers (16 blocks): E/N and
#: error; its linear fit; and the flagship's 24-block fit and error.
RECORD_ROWS = {4e-3: (8.41197, 0.00019), 2e-3: (8.41389, 0.00015),
               1e-3: (8.41614, 0.00013), 5e-4: (8.41648, 0.00014)}
RECORD_FIT_16 = 8.41720
RECORD_FIT_24 = (8.41702, 0.00010)


def procs(walkers: int, burn: int, blocks: int, nts: int):
    """One ``dmc.Proc`` per time step: the bench configuration's stanza
    (``chip_smoke.BENCH_PROC``) at this depth, a seed per row."""
    return [dmc_exec.Proc.from_config(dict(
        cs.BENCH_PROC, time_step=dt, max_num_walkers=walkers * 17 // 16,
        target_num_walkers=walkers, num_blocks=blocks,
        burn_in_blocks=burn, num_time_steps_block=nts, rng_seed=3 + r,
        keep_iter_data=True))
        for r, dt in enumerate(TIME_STEPS)]


def check_rows(rows, inputs, nts: int, num_blocks: int) -> None:
    """``num_blocks`` blocks of the fused sweep, each row bit-equal to
    its standalone ``Sampling.blocks`` run (per-step ensemble scalars and
    final positions)."""
    sweep = sweep_exec.SweepProc(rows).sweep
    state = cs.dmc.State(*(None if fields[0] is None else torch.stack(fields)
                           for fields in zip(*(p.state for p in inputs))))
    it = sweep.blocks(state, nts, burn_in_blocks=num_blocks)
    fused = [next(it) for _ in range(num_blocks)]
    for r, (proc, pin) in enumerate(zip(rows, inputs)):
        it = proc.sampling.blocks(pin.state, nts, burn_in_blocks=num_blocks)
        for b, f in enumerate(fused):
            a = next(it)
            for name in ("energy", "weight", "num_walkers", "ref_energy"):
                cs.require_equal(getattr(f.iter_props, name)[:, r].cpu(),
                                 getattr(a.iter_props, name).cpu(),
                                 f"dt row {r} block {b} {name}")
        cs.require(torch.equal(fused[-1].last_state.pos[r],
                               a.last_state.pos),
                   f"dt row {r}: final positions bit-equal")


def run(device, walkers: int, burn: int, blocks: int, nts: int,
        check_blocks: int) -> dict:
    rows = procs(walkers, burn, blocks, nts)
    inputs = [dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), p, device=device)
        for p in rows]
    t0 = time.perf_counter()
    if check_blocks:
        check_rows(rows, inputs, nts, check_blocks)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        results = sweep_exec.SweepProc(rows).exec(inputs)
    run_s = time.perf_counter() - t0
    nop = cs.NOP
    out = {"walkers_per_row": walkers, "burn_blocks": burn, "blocks": blocks,
           "steps_per_block": nts,
           "burn_tau_smallest_dt": burn * nts * min(TIME_STEPS),
           "rows_bit_equal_blocks": check_blocks, "check_s": check_s,
           "run_s": run_s, "ms_per_fused_step": run_s * 1e3
           / ((burn + blocks) * nts), "rows": []}
    naive_errs, step_errs = [], []
    for dt, result in zip(TIME_STEPS, results):
        blocks = result.data.blocks
        e, err = (float(blocks.energy.mean) / nop,
                  float(blocks.energy.mean_error) / nop)
        block_e = blocks.energy.totals / blocks.weight.totals / nop
        naive_errs.append(float(block_e.std() / np.sqrt(len(block_e))))
        series = result.data.series
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            step_errs.append(float(reblock.OTFObject.from_non_obj_data(
                series.energy / series.weight).mean_eff_error) / nop)
        rec, rec_err = RECORD_ROWS[dt]
        out["rows"].append({
            "time_step": dt, "energy_per_boson": [e, err],
            "naive_block_error": naive_errs[-1],
            "step_reblocked_error": step_errs[-1],
            "record": [rec, rec_err],
            "dev_in_combined_sigmas": (e - rec) / float(np.hypot(err,
                                                                  rec_err)),
            "dev_in_combined_sigmas_step_reblocked": (e - rec) / float(
                np.hypot(step_errs[-1], rec_err)),
            "mean_num_walkers": float(blocks.num_walkers.totals.mean())
            / nts})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit = report.summarize_dt_fit(
            [(f"dt{r}", res) for r, res in enumerate(results)])
    out["fit"] = fit
    out["record_fit_16_blocks"] = RECORD_FIT_16
    out["record_fit_24_blocks"] = list(RECORD_FIT_24)
    x = np.asarray(TIME_STEPS)
    y = np.asarray([row["energy_per_boson"][0] for row in out["rows"]])
    for key, errs in (("fit_naive_block_errors", naive_errs),
                      ("fit_step_reblocked_errors", step_errs)):
        e0, e0_err, coeffs = analysis.zero_limit_extrapolation(
            x, y, np.asarray(errs))
        out[key] = {"e0": float(e0), "e0_err": float(e0_err),
                    "slope": float(coeffs[-2])}
    for key in ("fit", "fit_naive_block_errors",
                "fit_step_reblocked_errors"):
        e0, e0_err = out[key]["e0"], out[key]["e0_err"]
        out[key]["dev_from_24_block_record_in_combined_sigmas"] = (
            (e0 - RECORD_FIT_24[0])
            / float(np.hypot(e0_err, RECORD_FIT_24[1])))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--walkers", type=int, default=16384)
    parser.add_argument("--burn", type=int, default=16)
    parser.add_argument("--blocks", type=int, default=24)
    parser.add_argument("--nts", type=int, default=512)
    parser.add_argument("--check-blocks", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, **run(torch.device("cuda", 0), args.walkers,
                               args.burn, args.blocks, args.nts,
                               args.check_blocks)}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")


if __name__ == "__main__":
    main()
