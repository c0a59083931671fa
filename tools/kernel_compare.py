"""An older checkout's kernels against this tree's, in one process on one
card: K1 and K1 log, K1 log's parameter VJP, K2's rows kernel and K3; and
the OBDM grid's and the S(k) harmonics' kernels against the plain
versions that they replaced.

    PYTHONPATH=. python tools/kernel_compare.py [k1] [vjp] [k2_rows] [k3] \
        [obd] [ssf] [--parent build/parent] [--out-dir build/compare]

(no kernel named: all six; ``--parent`` is needed by all but ``obd`` and
``ssf``).
The older checkout (``git archive <commit>`` unpacked into a git-ignored
directory) builds its kernel library with its own ``ops/_build.py``, in
a subprocess, into its own ``build/``; this tree's builds as a launch
would.  Both libraries are loaded with ctypes and export the same launch
functions, so each kernel runs on the same inputs from both, in turns
(parent, new, new, parent):

* ``k1``: ``qmc_pair_energy_drift_{f32,f64}`` and
  ``qmc_pair_logpsi_energy_drift_{f32,f64}`` at 17408 x 128 (the DMC
  cells' slots) and 16384 x 64 (the VMC cells' chains), each on positions
  uniform in [0, L) and on a state warmed by the port's own sampler (two
  512-step blocks: DMC at the bench model from ``init_get_sys_conf``, VMC
  at move_spread 0.4 from a uniform start), and on the 4 x 4352 x 64 table
  of phase S0's rows (``chip_smoke.table_inputs``): each output of both
  against the plain version in f64 at the same inputs (the largest
  relative gap of the energy and log|psi|, the largest absolute gap of
  the drift), this tree's within the card tests' tolerances of the plain
  version in the kernel's dtype (f64 within ``K1_F64_RTOL``) and, in f64,
  its forward and log variants' energy and drift equal; the time of a
  launch (CUDA events), in f32 the share of the bound
  (``yardstick.k1_bound``, the benchmark's count), and the share of warp
  steps whose vote takes the full pair body (``pairwise.vote_share``);
* ``vjp``: ``qmc_pair_logpsi_params_vjp_{f32,f64}`` at 4096 x 128 (the
  bench model) and 16384 x 64 (the bench VMC model), positions uniform
  in [0, L): the rows of both summed and compared (f32 within
  ``chip_smoke.K1_VJP_F32_TOL`` of the f64 sums, f64 within
  ``K1_VJP_F64_RTOL``), the time of a launch (CUDA events), and the
  bound under this tree's flop count and under the first design's;
* ``k2_rows``: ``qmc_philox_normals_rows_f32`` at 4 x 4352 x 64 (S1's
  fused step): both outputs word for word equal, the kernels' device
  time (profiler), beside the single-row kernel and ``torch.randn`` at
  17408 x 64;
* ``k3``: ``qmc_diffuse_energy_drift_{f32,f64}`` on
  ``chip_smoke.diffuse_inputs`` at 17408 x 128 (the bench DMC shape) and
  17408 x 64 (the EOS and VMC width), K2's noise for one key: the moved
  positions of both word for word equal to each other and to the DMC
  step's (``dmc.Sampling.diffuse`` on K2's noise), also with injected
  normals; energy, drift and weight of both against the step's within
  phase J's tolerances (f64 within 1e-10); the time of a launch (CUDA
  events), and in f32 the share of the bound under this tree's count
  (``chip_smoke.k3_bound``: each pair by its side of the cutoff in the
  moved positions) and under the first design's;
* ``obd``: ``qmc_obd_grid_{f32,f64}`` (``pairwise.obd_grid``) at
  17408 x 128 (the production cell's slots) and 16384 x 64 (the
  variational cell's chains), 32 offsets over [0, L/2], positions uniform
  in [0, L), against the plain version (``models/jastrow.py``'s
  ``one_body_density_grid``, which a CUDA tensor ran before the kernel
  and still runs as ``one_body_density_grid_plain``), in turns (plain,
  kernel, kernel, plain): the gap of each from the f64 plain version at
  the same inputs (f64 kernel within 1e-12; n1(0) exactly 1), the time
  of a call (CUDA events; the plain version's some thousand launches are
  back to back), and in f32 the kernel's share of its bound
  (``chip_smoke.obd_bound``: ``OBD_FLOPS_PER_PAIR`` flops for each of
  the N (N - 1) (M + 1) ordered pairs, ``csrc/obd.cu``);
* ``ssf``: ``qmc_ssf_harmonics_{f32,f64}`` (``ssf.ssf_harmonics``) at
  ``chip_smoke.SSF_SHAPES``, the sk, variational and production cells'
  16384 x 64 x 32, 16384 x 64 x 64 and 17408 x 128 x 64 (walkers,
  particles, modes), positions uniform in [0, L), against the plain
  recurrence (``models/jastrow.py``'s ``_harmonics_reim``, which a CUDA
  tensor ran before the kernel and still runs as
  ``fourier_density_parts_harmonics_plain``), in turns (plain, kernel,
  kernel, plain): the f32 kernel's gap from the plain f32 version as a
  share of the bound of the sums' order (``chip_smoke.ssf_reorder_gaps``:
  at most 1), the f64 kernel within 1e-12 of each slot's scale; the time
  of a call through the dispatch (CUDA events; launch included), of the
  kernel's launch alone and its device time (profiler), and in f32 the share of the bound
  (``chip_smoke.ssf_bound``: ``SSF_FLOPS_PER_ELEMENT`` flops for each
  particle and mode, ``csrc/ssf.cu``).

Prints the card's name and power limit, then one JSON line per
measurement.  With ``--out-dir`` it writes both builds' ``-Xptxas -v``
reports and both libraries' SASS (``cuobjdump -sass``) there.  Needs a
CUDA device.
"""
import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import _build, pairwise, prng, ssf
from phd_qmclib_torch.samplers import vmc

VJP_SHAPES = (("dmc shape", cs.BENCH_SPEC, 4096),
              ("vmc shape", cs.VMC_SPEC, cs.VMC_CHAINS))
VJP_REPS = {torch.float32: 50, torch.float64: 10}
ROWS, ROW_WALKERS, ROW_NOP = 4, cs.EOS_SLOTS, cs.EOS_NOP
K3_SHAPES = (("dmc shape", cs.BENCH_SPEC), ("eos width", cs.VMC_SPEC))
K3_REPS = {torch.float32: 50, torch.float64: 10}
OBD_SHAPES = (("production", cs.BENCH_SPEC, cs.MAX_WALKERS),
              ("variational", cs.VMC_SPEC, cs.VMC_CHAINS))
#: Reps of one timing (kernel, plain) by dtype.
OBD_REPS = {torch.float32: (20, 2), torch.float64: (5, 1)}
#: Reps of one timing (kernel, plain) by dtype.
SSF_REPS = {torch.float32: (200, 5), torch.float64: (50, 2)}
#: Reps of one K1 timing by dtype, and the walkers of one plain call.
K1_REPS = {torch.float32: 50, torch.float64: 10}
K1_PLAIN_CHUNK = 1024
#: Blocks of NTS steps that warm the K1 compare's sampled states.
K1_WARM_BLOCKS = 2
COMPARES = ("k1", "vjp", "k2_rows", "k3", "obd", "ssf")


def build_parent(parent: Path) -> tuple:
    """Build the older checkout's library in a subprocess; returns its
    path and the build's report."""
    proc = subprocess.run(
        [sys.executable, "-c", "from phd_qmclib_torch.ops import _build; "
         "print(_build.build())"], cwd=parent, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(parent)))
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's build failed:\n{proc.stderr}")
    return parent / "build" / _build.LIBRARY.name, proc.stdout


def load(path: Path, names) -> dict:
    lib = ctypes.CDLL(str(path))
    fns = {}
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, *args):
    """A call of launch function ``fn`` on the current stream that
    raises on a launch error."""
    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return run


def in_turns(parent, new, timer) -> dict:
    p1, n1 = timer(parent), timer(new)
    n2, p2 = timer(new), timer(parent)
    return {"parent": [p1, p2], "new": [n1, n2]}


def warmed_dmc_state(device) -> torch.Tensor:
    """The DMC slots (17408 x 128, f32) after K1_WARM_BLOCKS blocks of
    the bench model from ``init_get_sys_conf``'s configurations."""
    spec = mrbp.Spec(**cs.BENCH_SPEC)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(cs.TARGET_WALKERS)]).astype(np.float32)
    sampling = cs.bench_sampling()
    blocks = sampling.blocks(
        sampling.build_state(confs, dtype=np.float32, device=device),
        num_time_steps_block=cs.NTS, burn_in_blocks=K1_WARM_BLOCKS)
    for _ in range(K1_WARM_BLOCKS):
        block = next(blocks)
    return block.last_state.pos.contiguous()


def warmed_vmc_state(device) -> torch.Tensor:
    """The VMC chains (16384 x 64, f32) after K1_WARM_BLOCKS blocks at
    move_spread 0.4 from a uniform start (the sk cell's protocol)."""
    sampling = vmc.Sampling(mrbp.Spec(**cs.VMC_SPEC), move_spread=0.4,
                            rng_seed=1, num_walkers=cs.VMC_CHAINS)
    confs = np.random.default_rng(0).uniform(
        0.0, float(cs.VMC_NOP), (cs.VMC_CHAINS, cs.VMC_NOP))
    blocks = sampling.blocks(cs.NTS, sampling.build_state(
        confs.astype(np.float32), dtype=torch.float32, device=device))
    for _ in range(K1_WARM_BLOCKS):
        block = next(blocks)
    return block.last_state.pos.contiguous()


def k1_inputs(device) -> list:
    """``(label, pos, params, kw)`` in f32: uniform and warmed positions
    at the DMC and VMC shapes, and S0's four-row table."""
    out = []
    for label, spec_kwargs, walkers, warmed in (
            ("dmc shape", cs.BENCH_SPEC, cs.MAX_WALKERS, warmed_dmc_state),
            ("vmc shape", cs.VMC_SPEC, cs.VMC_CHAINS, warmed_vmc_state)):
        pos, params, kw = cs.pair_inputs(spec_kwargs, walkers, torch.float32,
                                         device)
        out.append((f"{label}, uniform", pos, params, kw))
        out.append((f"{label}, warmed", warmed(device), params, kw))
    pos, table, kw = cs.table_inputs(torch.float32, device, cs.EOS_SLOTS)
    out.append(("4-row table", pos, table, kw))
    return out


def k1_plain(pos, params, kw, with_log_psi: bool) -> tuple:
    """The plain version, K1_PLAIN_CHUNK walkers of one row at a time."""
    rows = params if params.dim() == 2 else params[None]
    per_row = pos.shape[0] // rows.shape[0]
    parts = []
    for r, row in enumerate(rows):
        for start in range(r * per_row, (r + 1) * per_row, K1_PLAIN_CHUNK):
            stop = min(start + K1_PLAIN_CHUNK, (r + 1) * per_row)
            parts.append(pairwise.energy_and_drift_plain(
                pos[start:stop], row, with_log_psi=with_log_psi, **kw))
    return tuple(torch.cat(p) for p in zip(*parts))


def k1_gaps(got, want) -> dict:
    """The largest relative gaps of log|psi| and the energy and the
    largest absolute gap of the drift, ``got`` against ``want``."""
    names = ("log_psi", "energy", "drift")[-len(got):]
    gaps = {}
    for name, g, w in zip(names, got, want):
        d = (g.double() - w.double()).abs()
        gaps[name] = float(d.max() if name == "drift"
                           else (d / w.double().abs().clamp_min(1e-300)).max())
    return gaps


def k1_within(got, want, dtype) -> bool:
    """``got`` within the card tests' tolerances of the plain version
    ``want`` in the same dtype."""
    if dtype == torch.float64:
        tols = [(cs.K1_F64_RTOL, cs.K1_F64_RTOL)] * 3
    else:
        tol = cs.K1_LOG_F32_TOL
        tols = [(tol["log_psi_rtol"], tol["log_psi_rtol"]),
                (tol["energy_rtol"], tol["energy_rtol"]),
                (tol["drift_rtol"], tol["drift_atol"])]
    return all(bool(torch.isclose(g, w, rtol=rtol, atol=atol).all())
               for g, w, (rtol, atol) in zip(got, want, tols[-len(got):]))


def compare_k1(parent_fns, new_fns, device, card) -> None:
    for label, pos32, params32, kw in k1_inputs(device):
        walkers, nop = pos32.shape
        per_row = walkers // params32.shape[0] if params32.dim() == 2 \
            else walkers
        share = pairwise.vote_share(pos32, params32, nop)
        oracle = {}
        forward64 = None
        for dtype in (torch.float64, torch.float32):
            suffix = "f32" if dtype == torch.float32 else "f64"
            pos, params = pos32.to(dtype), params32.to(dtype)
            for log_psi in (False, True):
                name = (f"qmc_pair_logpsi_energy_drift_{suffix}" if log_psi
                        else f"qmc_pair_energy_drift_{suffix}")
                outs = {}

                def call(fns, key):
                    out = ((pos.new_empty(walkers),) if log_psi else ()) + (
                        pos.new_empty(walkers), torch.empty_like(pos))
                    outs[key] = out
                    return launcher(fns[name], pos.data_ptr(),
                                    params.data_ptr(),
                                    *(t.data_ptr() for t in out), walkers,
                                    per_row, nop, int(kw["is_free"]),
                                    int(kw["is_ideal"]), kw["defects_sep"])

                runs = {k: call(fns, k) for k, fns in (("parent", parent_fns),
                                                       ("new", new_fns))}
                for run in runs.values():
                    run()
                torch.cuda.synchronize()
                if log_psi not in oracle:
                    oracle[log_psi] = k1_plain(pos.double(), params.double(),
                                               kw, log_psi)
                want = oracle[log_psi] if dtype == torch.float64 \
                    else k1_plain(pos, params, kw, log_psi)
                check = {
                    "gap_vs_f64_plain": {k: k1_gaps(o, oracle[log_psi])
                                         for k, o in outs.items()},
                    "within_plain_tol": {k: k1_within(o, want, dtype)
                                         for k, o in outs.items()}}
                ok = check["within_plain_tol"]["new"]
                if dtype == torch.float64:
                    if log_psi:
                        equal = all(torch.equal(a, b) for a, b in
                                    zip(forward64, outs["new"][1:]))
                        check["f64_variants_equal"] = equal
                        ok = ok and equal
                    else:
                        forward64 = outs["new"]
                times = in_turns(runs["parent"], runs["new"],
                                 lambda fn: cs.cuda_ms(fn, K1_REPS[dtype]))
                out = {"kernel": "K1 log" if log_psi else "K1",
                       "dtype": suffix, "shape": [walkers, nop],
                       "rows": params.shape[0] if params.dim() == 2 else 1,
                       "label": label, "card": card, "ms": times,
                       "vote_share": share, **check, "ok": ok}
                if dtype == torch.float32:
                    bound_ms = cs.k1_bound(walkers, nop, log_psi)["bound_ms"]
                    out.update(bound_ms=bound_ms, share_of_bound={
                        k: bound_ms / (sum(v) / 2) for k, v in times.items()})
                print(json.dumps(out), flush=True)
                if not ok:
                    raise SystemExit(f"{out['kernel']} {suffix} {label}: "
                                     f"{check}")


def compare_vjp(parent_fns, new_fns, device, card) -> None:
    for dtype in (torch.float32, torch.float64):
        suffix = "f32" if dtype == torch.float32 else "f64"
        name = f"qmc_pair_logpsi_params_vjp_{suffix}"
        for label, spec_kwargs, walkers in VJP_SHAPES:
            args, kw = cs.vjp_inputs(spec_kwargs, walkers, dtype, device)
            pos, params, drift, g_lp, g_e = args
            rows = {k: pos.new_empty((walkers, pairwise.PARAMS_SIZE))
                    for k in ("parent", "new")}
            call = {k: launcher(fns[name], pos.data_ptr(), params.data_ptr(),
                                drift.data_ptr(), g_lp.data_ptr(),
                                g_e.data_ptr(), rows[k].data_ptr(), walkers,
                                kw["nop"], int(kw["is_free"]),
                                int(kw["is_ideal"]), kw["defects_sep"])
                    for k, fns in (("parent", parent_fns), ("new", new_fns))}
            for run in call.values():
                run()
            torch.cuda.synchronize()
            got = {k: r.double().sum(dim=0) for k, r in rows.items()}
            check = {}
            if dtype == torch.float64:
                rel = float(((got["new"] - got["parent"]).abs()
                             / got["parent"].abs().clamp_min(1e-300)).max())
                check = {"new_vs_parent_max_rel": rel,
                         "ok": rel <= cs.K1_VJP_F64_RTOL}
            else:
                oracle = cs.vjp_plain_f64(args, kw)
                tol = cs.K1_VJP_F32_TOL
                limit = tol["rtol"] * oracle.abs() \
                    + tol["rtol_of_max"] * oracle.abs().max()
                shares = {k: float(((g - oracle).abs() / limit).max())
                          for k, g in got.items()}
                check = {"share_of_f32_limit": shares,
                         "ok": shares["new"] <= 1.0}
            check["rm_slot"] = float(got["new"][pairwise.P_RM])
            times = in_turns(call["parent"], call["new"],
                             lambda fn: cs.cuda_ms(fn, VJP_REPS[dtype]))
            out = {"kernel": "K1 vjp", "dtype": suffix, "shape":
                   [walkers, kw["nop"]], "label": label, "card": card,
                   "ms": times, **check}
            if dtype == torch.float32:
                least = cs.vjp_bound(pos, params)
                first = cs.vjp_bound(pos, params,
                                     cs.K1_VJP_FIRST_DESIGN_FLOPS)
                mean = {k: sum(v) / 2 for k, v in times.items()}
                out.update(
                    bound_ms=least["bound_ms"],
                    bound_ms_first_design_count=first["bound_ms"],
                    pairs=least["pairs"],
                    pairs_in_cutoff=least["pairs_in_cutoff"],
                    share_of_bound={k: least["bound_ms"] / v
                                    for k, v in mean.items()},
                    share_of_first_design_bound={
                        k: first["bound_ms"] / v for k, v in mean.items()})
            print(json.dumps(out), flush=True)
            if not check["ok"] or check["rm_slot"] != 0.0:
                raise SystemExit(f"K1 vjp {suffix} {label}: {check}")


def compare_rows(parent_fn, device, card) -> None:
    keys = prng.key_table([int(p["rng_seed"]) for p in cs.EOS_PROCS], device)
    scales = torch.tensor([math.sqrt(2 * dt) for dt in
                           (1e-3, 2e-3, 1e-3, 5e-4)], device=device)
    shape = (ROWS, ROW_WALKERS, ROW_NOP)
    row_numel = ROW_WALKERS * ROW_NOP
    bufs = {k: torch.empty(shape, device=device) for k in ("parent", "new")}
    sms = _build.sm_count(device.index or 0)
    # The parent's kernel took the persistent grid of all the rows' quads.
    parent_grid = _build.persistent_grid(
        -(-ROWS * row_numel // 4 // prng.THREADS), sms,
        _build.functions()["qmc_philox_ctas_per_sm"]())
    call = {"parent": launcher(parent_fn, bufs["parent"].data_ptr(),
                               row_numel, ROWS, keys.data_ptr(),
                               scales.data_ptr(), 5, parent_grid),
            "new": lambda: prng.normal_rows(keys, 5, scales, bufs["new"])}
    for run in call.values():
        run()
    torch.cuda.synchronize()
    equal = torch.equal(bufs["parent"], bufs["new"])
    flat = torch.empty((ROWS * ROW_WALKERS, ROW_NOP), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    times = in_turns(call["parent"], call["new"],
                     lambda fn: cs.device_ms(fn, 200))
    single = [cs.device_ms(lambda: prng.normal(1, 5, flat.shape, scale=0.04,
                                               out=flat, device=device), 200)
              for _ in range(2)]
    randn = [cs.device_ms(lambda: torch.randn(flat.shape, generator=gen,
                                              out=flat), 200)
             for _ in range(2)]
    numel = flat.numel()
    print(json.dumps({
        "kernel": "K2 rows", "shape": list(shape), "card": card,
        "words_equal_parent": equal, "device_ms": times,
        "single_row_device_ms": single, "torch_randn_device_ms": randn,
        **cs.bound(numel * cs.K2_FLOPS_PER_NORMAL,
                   cs.F32_BYTES * numel + 12 * ROWS)}), flush=True)
    if not equal:
        raise SystemExit("K2 rows: the words differ from the parent's")


def within_phase_j(got, want, dtype) -> bool:
    """Energy, drift and weight of ``got`` against ``want`` (K3's
    outputs) within phase J's tolerances in f32, 1e-10 in f64."""
    if dtype == torch.float64:
        pairs = [(g, w, 1e-10, 1e-10) for g, w in zip(got[1:], want[1:])]
    else:
        tol = cs.K1_F32_TOL
        pairs = [(got[1], want[1], tol["energy_rtol"], 0.0),
                 (got[2], want[2], tol["drift_rtol"], tol["drift_atol"]),
                 (got[3], want[3], 1e-6, 0.0)]
    return all(bool(torch.isclose(g, w, rtol=rtol, atol=atol).all())
               for g, w, rtol, atol in pairs)


def compare_k3(parent_fns, new_fns, device, card) -> None:
    for dtype in (torch.float32, torch.float64):
        suffix = "f32" if dtype == torch.float32 else "f64"
        name = f"qmc_diffuse_energy_drift_{suffix}"
        for label, spec_kwargs in K3_SHAPES:
            args, kw, step = cs.diffuse_inputs(device, spec_kwargs, dtype)
            cpos = args["cpos"]
            walkers, nop = cpos.shape
            xi = prng.normal_plain(5, 6, cpos.shape, dtype, device)
            outs = {}

            def call(fns, key, noise=None):
                out = (torch.empty_like(cpos), cpos.new_empty(walkers),
                       torch.empty_like(cpos), cpos.new_empty(walkers))
                outs[key] = out
                return launcher(
                    fns[name], *(args[k].data_ptr() for k in (
                        "cpos", "cdrift", "cenergy", "params")),
                    None if noise is None else noise.data_ptr(),
                    args["e_ref"].data_ptr(), args["dt"], args["sigma"],
                    *prng.check_key(args["rng_seed"], args["step"]),
                    *(t.data_ptr() for t in out), walkers, nop,
                    int(kw["is_free"]), int(kw["is_ideal"]),
                    kw["defects_sep"])

            runs = {"parent": call(parent_fns, "parent"),
                    "new": call(new_fns, "new")}
            for key, fns in (("parent", parent_fns), ("new", new_fns)):
                call(fns, f"{key} injected", xi)()
            for run in runs.values():
                run()
            torch.cuda.synchronize()
            stepped, injected = step(), step(xi)
            check = {
                "npos_equal_parent": torch.equal(outs["new"][0],
                                                 outs["parent"][0]),
                "npos_equal_step": torch.equal(outs["new"][0], stepped[0]),
                "injected_npos_equal": all(
                    torch.equal(outs[f"{k} injected"][0], injected[0])
                    for k in ("parent", "new")),
                "within_phase_j": {
                    k: within_phase_j(outs[k], stepped, dtype)
                    and within_phase_j(outs[f"{k} injected"], injected,
                                       dtype)
                    for k in ("parent", "new")},
                "energy_max_abs_vs_step": {
                    k: float((outs[k][1] - stepped[1]).abs().max())
                    for k in ("parent", "new")},
                "weight_max_rel_vs_step": {
                    k: float(((outs[k][3] - stepped[3]).abs()
                              / stepped[3].abs()).max())
                    for k in ("parent", "new")}}
            ok = (check["npos_equal_parent"] and check["npos_equal_step"]
                  and check["injected_npos_equal"]
                  and check["within_phase_j"]["new"])
            times = in_turns(runs["parent"], runs["new"],
                             lambda fn: cs.cuda_ms(fn, K3_REPS[dtype]))
            out = {"kernel": "K3", "dtype": suffix, "shape": [walkers, nop],
                   "label": label, "card": card, "ms": times, **check,
                   "ok": ok}
            if dtype == torch.float32:
                mean = {k: sum(v) / 2 for k, v in times.items()}
                least = cs.k3_bound(outs["new"][0], args["params"])
                first = cs.k3_bound(outs["new"][0], args["params"],
                                    *cs.K3_FIRST_DESIGN_FLOPS)
                out.update(
                    bound_ms=least["bound_ms"],
                    pairs_in_cutoff=least["pairs_in_cutoff"],
                    bound_ms_first_design_count=first["bound_ms"],
                    share_of_bound={k: least["bound_ms"] / v
                                    for k, v in mean.items()},
                    share_of_first_design_bound={
                        k: first["bound_ms"] / v for k, v in mean.items()})
            print(json.dumps(out), flush=True)
            if not ok:
                raise SystemExit(f"K3 {suffix} {label}: {check}")


def compare_obd(device, card) -> None:
    for label, spec_kwargs, walkers in OBD_SHAPES:
        spec = mrbp.Spec(**spec_kwargs)
        static = spec.static_spec
        nop, length = static.boson_number, spec.supercell_size
        funcs = mrbp.core_funcs(spec)
        gen = torch.Generator(device=device)
        gen.manual_seed(nop)
        pos64 = length * torch.rand((walkers, nop), generator=gen,
                                    dtype=torch.float64, device=device)
        kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal)
        oracle = None
        for dtype in (torch.float64, torch.float32):
            suffix = "f32" if dtype == torch.float32 else "f64"
            pos = pos64.to(dtype)
            offsets = torch.linspace(0.0, 0.5 * length, cs.OBD_NUM_POS,
                                     dtype=dtype, device=device)
            cfc = mrbp.cast_params(spec.cfc_params, dtype, device)
            params = pairwise.pack_params(cfc, dtype, device)
            outs = {}

            def kernel():
                outs["kernel"] = pairwise.obd_grid(offsets, pos, params,
                                                   **kw)

            def plain():
                outs["plain"] = funcs.one_body_density_grid_plain(
                    offsets, pos, cfc)

            kernel()
            plain()
            torch.cuda.synchronize()
            if oracle is None:
                oracle = outs["plain"]
            want = funcs.one_body_density_grid_plain(
                offsets.double(), pos.double(),
                mrbp.cast_params(cfc, torch.float64, device)) \
                if dtype == torch.float32 else oracle
            gaps = {k: float((v.double() - want).abs().max())
                    for k, v in outs.items()}
            at_zero = bool((outs["kernel"][:, 0] == 1).all())
            ok = at_zero and (gaps["kernel"] <= 1e-12
                              if dtype == torch.float64
                              else gaps["kernel"] <= 4 * gaps["plain"])
            reps = OBD_REPS[dtype]
            p1 = cs.cuda_ms(plain, reps[1])
            k1 = cs.cuda_ms(kernel, reps[0])
            k2 = cs.cuda_ms(kernel, reps[0])
            p2 = cs.cuda_ms(plain, reps[1])
            times = {"plain": [p1, p2], "kernel": [k1, k2]}
            out = {"kernel": "OBDM grid", "dtype": suffix,
                   "shape": [walkers, nop, cs.OBD_NUM_POS], "label": label,
                   "card": card, "ms": times, "gap_vs_f64_plain": gaps,
                   "n1_at_zero_exactly_1": at_zero, "ok": ok}
            if dtype == torch.float32:
                least = cs.obd_bound(walkers, nop, cs.OBD_NUM_POS)
                out.update(least, share_of_bound={
                    k: least["bound_ms"] / (sum(v) / 2)
                    for k, v in times.items()})
            print(json.dumps(out), flush=True)
            del outs
            if not ok:
                raise SystemExit(f"OBDM grid {suffix} {label}: {gaps}")


def compare_ssf(device, card) -> None:
    for label, walkers, nop, num_modes in cs.SSF_SHAPES:
        spec = mrbp.Spec(**dict(cs.BENCH_SPEC, boson_number=nop,
                                supercell_size=float(nop)))
        funcs = mrbp.core_funcs(spec)
        gen = torch.Generator(device=device)
        gen.manual_seed(nop + num_modes)
        pos64 = nop * torch.rand((walkers, nop), generator=gen,
                                 dtype=torch.float64, device=device)
        for dtype in (torch.float64, torch.float32):
            suffix = "f32" if dtype == torch.float32 else "f64"
            pos = pos64.to(dtype)
            cfc = mrbp.cast_params(spec.cfc_params, dtype, device)
            lengths = cfc.model_params.supercell_size.reshape(1)
            outs = {}

            def kernel():
                outs["kernel"] = funcs.fourier_density_parts_harmonics(
                    num_modes, pos, cfc)

            def plain():
                outs["plain"] = funcs.fourier_density_parts_harmonics_plain(
                    num_modes, pos, cfc)

            def alone():
                ssf.ssf_harmonics(pos, lengths, num_modes=num_modes)

            kernel()
            plain()
            torch.cuda.synchronize()
            if dtype == torch.float64:
                gap = cs.ssf_f64_gap(outs["kernel"], outs["plain"], nop)
                check = {"f64_max_rel_err": gap}
                ok = gap <= cs.SSF_F64_RTOL
            else:
                check = cs.ssf_reorder_gaps(outs["kernel"], outs["plain"],
                                            nop)
                ok = check["share_of_reorder_bound"] <= 1.0
            ok = ok and torch.equal(outs["kernel"][:, 0],
                                    outs["plain"][:, 0])
            reps = SSF_REPS[dtype]
            p1 = cs.cuda_ms(plain, reps[1])
            k1_ms = cs.cuda_ms(kernel, reps[0])
            k2_ms = cs.cuda_ms(kernel, reps[0])
            p2 = cs.cuda_ms(plain, reps[1])
            times = {"plain": [p1, p2], "call": [k1_ms, k2_ms]}
            out = {"kernel": "S(k) harmonics", "dtype": suffix,
                   "shape": [walkers, nop, num_modes], "label": label,
                   "card": card, "ms": times,
                   "kernel_alone_ms": cs.cuda_ms(alone, reps[0]),
                   "device_ms": cs.device_ms(alone, reps[0]), **check,
                   "ok": ok}
            if dtype == torch.float32:
                least = cs.ssf_bound(walkers, nop, num_modes)
                out.update(least, share_of_bound={
                    k: least["bound_ms"] / (sum(v) / 2)
                    for k, v in times.items()},
                    device_share_of_bound=(least["bound_ms"]
                                           / out["device_ms"]
                                           if out["device_ms"] else None))
            print(json.dumps(out), flush=True)
            del outs
            if not ok:
                raise SystemExit(f"S(k) {suffix} {label}: {check}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("compares", nargs="*", choices=COMPARES,
                        help="the kernels to compare (default: all)")
    parser.add_argument("--parent", type=Path)
    parser.add_argument("--out-dir", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    compares = args.compares or COMPARES
    builds = [("new", _build.build(), _build.LIBRARY)]
    if set(compares) - {"obd", "ssf"}:
        if args.parent is None:
            raise SystemExit("--parent is needed by k1, vjp, k2_rows and "
                             "k3")
        parent_lib, parent_log = build_parent(args.parent.resolve())
        builds.insert(0, ("parent", parent_log, parent_lib))
    if args.out_dir:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        for label, log, lib in builds:
            (args.out_dir / f"ptxas_{label}.txt").write_text(log)
            with open(args.out_dir / f"sass_{label}.txt", "w") as out:
                subprocess.run([str(cuobjdump), "-sass", str(lib)],
                               stdout=out, stderr=subprocess.STDOUT)
    if "obd" in compares:
        compare_obd(device, card)
    if "ssf" in compares:
        compare_ssf(device, card)
    if len(builds) == 1:
        return
    names = ["qmc_pair_energy_drift_f32", "qmc_pair_energy_drift_f64",
             "qmc_pair_logpsi_energy_drift_f32",
             "qmc_pair_logpsi_energy_drift_f64",
             "qmc_pair_logpsi_params_vjp_f32",
             "qmc_pair_logpsi_params_vjp_f64", "qmc_philox_normals_rows_f32",
             "qmc_diffuse_energy_drift_f32", "qmc_diffuse_energy_drift_f64"]
    parent_fns = load(parent_lib, names)
    new_fns = {name: _build.functions()[name] for name in names}
    if "k1" in compares:
        compare_k1(parent_fns, new_fns, device, card)
    if "k2_rows" in compares:
        compare_rows(parent_fns["qmc_philox_normals_rows_f32"], device, card)
    if "vjp" in compares:
        compare_vjp(parent_fns, new_fns, device, card)
    if "k3" in compares:
        compare_k3(parent_fns, new_fns, device, card)


if __name__ == "__main__":
    main()
