"""Human-readable reports of stored QMC results.

Counterpart of ``phd_qmclib_tpu.qmc_exec.report``, on this package's
result containers (``qmc_exec.data``), ``analysis`` and ``stats``: the
same text and the same JSON for the same file.

``report_hdf5`` loads a result written by the DMC/VMC procedures (of
either package, or by the upstream library: the file layout is shared)
and renders the physics in physical units: ground-state energy with
reblocked errors, population statistics, S(k), density profile,
OBDM/condensate numbers, and the CM-diffusion effective mass.
``sweep_fit_hdf5`` extrapolates across the stored results of a sweep
(dt, population, finite size).  Everything here is NumPy on the host;
files load their states on the CPU.

``h5py`` is imported by the functions that open files, so the module
imports where ``h5py`` is missing and :func:`summarize` and the
``describe_*`` functions run on results held in memory.
"""
import typing as t
import warnings

import numpy as np

__all__ = ["report_hdf5", "describe_dmc", "describe_vmc",
           "find_result_groups"]


def _fmt(value, err=None, prec: int = 6) -> str:
    if err is None or not np.isfinite(err):
        return f"{value:.{prec}g}"
    return f"{value:.{prec}g} +/- {err:.3g}"


def _correlation_line(energy_blocks) -> str:
    """Blocking-analysis summary of the energy series: integrated
    autocorrelation time (in block units) and the decorrelated sample
    count behind the quoted error bar."""
    rb = energy_blocks.reblock
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tau = float(rb.opt_iac_time)
        eff = float(rb.eff_size)
    unresolved = any("optimum block size" in str(w.message)
                     for w in caught)
    line = (f"correlation tau_int = {tau:.3g} blocks, "
            f"{eff:.0f} effective samples of {int(rb.size)} blocks")
    if unresolved:
        line += " (block-size criterion unresolved - gather more blocks)"
    return line


def _model_lines(model_spec) -> t.List[str]:
    wells = model_spec.supercell_size / model_spec.boson_number
    per = "well" if abs(wells - 1.0) < 1e-12 else f"{wells:g} wells"
    lines = [
        f"model       N = {model_spec.boson_number} bosons, "
        f"L = {model_spec.supercell_size:g} (one boson per {per})",
        f"            v0 = {model_spec.lattice_depth:g}, "
        f"r = {model_spec.lattice_ratio:g}, "
        f"gn = {model_spec.interaction_strength:g}, "
        f"rm = {model_spec.tbf_contact_cutoff:g}",
    ]
    if getattr(model_spec, "num_defects", 0):
        lines.append(f"            defects: {model_spec.num_defects} "
                     f"x magnitude {model_spec.defect_magnitude:g}")
    return lines


def _ssf_lines(ssf_blocks, nop: int, sc_size: float,
               full: bool) -> t.List[str]:
    mean = np.asarray(ssf_blocks.mean, dtype=np.float64) / nop
    err = np.asarray(ssf_blocks.mean_error, dtype=np.float64) / nop
    num_modes = mean.shape[0]
    momenta = np.arange(num_modes) * 2 * np.pi / sc_size
    shown = num_modes if full else min(num_modes, 8)
    lines = [f"S(k)        {num_modes} modes, k_j = 2 pi j / L "
             f"(normalized per particle):"]
    for j in range(shown):
        lines.append(f"            k = {momenta[j]:8.4f}   "
                     f"S = {_fmt(mean[j], err[j])}")
    if shown < num_modes:
        lines.append(f"            ... ({num_modes - shown} more modes; "
                     f"use full=True)  S(k_max) = "
                     f"{_fmt(mean[-1], err[-1])}")
    if num_modes >= 4:
        from ..analysis import sound_speed_from_ssf
        c, c_err = sound_speed_from_ssf(momenta, mean, err)
        if np.isfinite(c):
            lines.append(f"            sound speed c = {_fmt(c, c_err)} "
                         f"(Feynman k->0, units hbar^2/2m = 1)")
    return lines


def _density_lines(density_blocks, nop: int, sc_size: float,
                   full: bool) -> t.List[str]:
    mean = np.asarray(density_blocks.mean, dtype=np.float64)
    err = np.asarray(density_blocks.mean_error, dtype=np.float64)
    num_bins = mean.shape[0]
    bin_size = sc_size / num_bins
    n_z = mean / bin_size                     # particles per unit length
    total = float(mean.sum())
    lines = [
        f"density     {num_bins} bins; integral = {total:.6g} "
        f"(sum rule: N = {nop})",
        f"            n(z): min = {n_z.min():.6g}, "
        f"max = {n_z.max():.6g}, "
        f"contrast (max-min)/(max+min) = "
        f"{(n_z.max() - n_z.min()) / max(n_z.max() + n_z.min(), 1e-300):.4g}",
    ]
    if (mean > 0).all():
        from ..analysis import leggett_bound

        fs_max, fs_err = leggett_bound(mean, err)
        lines.append(
            f"            Leggett bound on the superfluid fraction: "
            f"f_s <= {_fmt(fs_max, fs_err)}")
    if full:
        for b in range(num_bins):
            z = (b + 0.5) * bin_size
            lines.append(f"            z = {z:8.4f}   "
                         f"n = {_fmt(n_z[b], err[b] / bin_size)}")
    return lines


def _density_consistency_line(density_blocks, ssf_blocks, nop: int,
                              sc_size: float) -> t.List[str]:
    """Internal-consistency diagnostic: the direct density histogram
    and the band-limited Fourier synthesis from the same run's
    ``<rho_k>`` parts measure the same n(z) by independent chains."""
    mean = np.asarray(density_blocks.mean, dtype=np.float64)
    err = np.asarray(density_blocks.mean_error, dtype=np.float64)
    num_bins = mean.shape[0]
    bin_size = sc_size / num_bins
    n_direct = mean / bin_size
    n_err = np.nan_to_num(err, nan=0.0) / bin_size
    num_modes = ssf_blocks.fdk_real_part.totals.shape[-1]
    momenta = np.arange(num_modes) * 2 * np.pi / sc_size
    z = (np.arange(num_bins) + 0.5) * bin_size
    n_fourier, nf_err = ssf_blocks.density_profile(z, nop, sc_size)
    nf_err = np.nan_to_num(np.asarray(nf_err, dtype=np.float64),
                           nan=0.0)
    sigma = np.sqrt(n_err ** 2 + nf_err ** 2)
    # The synthesis is band-limited: harmonics above k_max are absent,
    # so allow a floor of the highest retained harmonic's amplitude.
    amps = np.abs(np.asarray(ssf_blocks.fdk_real_part.mean)) \
        + np.abs(np.asarray(ssf_blocks.fdk_imag_part.mean))
    floor = 2.0 * float(amps[-1]) / sc_size + 1e-3 * nop / sc_size
    dev = np.abs(n_direct - n_fourier)
    pulls = np.where(np.isfinite(dev),
                     dev / np.maximum(sigma + floor, 1e-300), -1.0)
    if not np.any(pulls >= 0):
        return []
    worst = int(np.argmax(pulls))
    note = "" if pulls[worst] <= 2.0 else \
        " — the S(k) mode grid under-resolves the profile's sharp " \
        "features (raise num_modes), or the chains disagree"
    return [
        f"            consistency vs Fourier-from-<rho_k>: max dev "
        f"{dev[worst]:.4g} at z = {z[worst]:.4g} "
        f"({pulls[worst]:.2f}x the combined error + cutoff "
        f"floor){note}"]


def _g2_consistency_line(g2_blocks, ssf_blocks, nop: int,
                         sc_size: float) -> t.List[str]:
    """Internal-consistency diagnostic: the direct pair-distance
    histogram and the Fourier inversion of the measured S(k) are two
    independent estimator chains of the same g2(r); report their
    worst normalized deviation away from the contact region (where
    the Fourier route's mode cutoff dominates)."""
    r, g2_d, g2_d_err = g2_blocks.pair_correlation(nop, sc_size)
    g2_f, g2_f_err = ssf_blocks.pair_correlation(r, nop, sc_size)
    mask = r > sc_size / 8
    if not np.any(mask):
        return []
    # Degenerate bins can carry NaN errors (empty in every block);
    # exclude them from the pull rather than letting argmax land on a
    # NaN entry.
    sigma = np.sqrt(np.nan_to_num(g2_d_err[mask], nan=0.0) ** 2
                    + np.nan_to_num(g2_f_err[mask], nan=0.0) ** 2)
    num_modes = ssf_blocks.fdk_sqr_abs_part.totals.shape[-1]
    # The truncated Fourier series has an O(1/M) resolution floor.
    floor = 2.0 / num_modes
    dev = np.abs(g2_d[mask] - g2_f[mask])
    pulls = np.where(np.isfinite(dev),
                     dev / np.maximum(sigma + floor, 1e-300), -1.0)
    if not np.any(pulls >= 0):
        return []
    worst = int(np.argmax(pulls))
    return [
        f"            consistency vs Fourier-from-S(k): max dev "
        f"{dev[worst]:.4g} at r = {r[mask][worst]:.4g} "
        f"({pulls[worst]:.2f}x the combined error + 2/M cutoff floor)"]


def _pair_corr_lines(g2_blocks, nop: int, sc_size: float, full: bool,
                     coupling: t.Optional[float] = None) -> t.List[str]:
    r, g2, g2_err = g2_blocks.pair_correlation(nop, sc_size)
    num_bins = g2.shape[0]
    # The first bin AVERAGES g2 over [0, dr) — label it by its center
    # rather than calling it the contact (the cusp rise biases the bin
    # average low by ~ coupling*dr/2).
    lines = [
        f"g2(r)       direct histogram, {num_bins} bins over [0, L/2]: "
        f"g2({r[0]:.4g}) = {_fmt(g2[0], g2_err[0])}, "
        f"g2(L/2) = {_fmt(g2[-1], g2_err[-1])}",
    ]
    if coupling is not None and coupling > 0 and num_bins >= 4:
        from ..analysis import contact_from_pair_correlation
        c, c_err = contact_from_pair_correlation(r, g2, g2_err,
                                                 float(coupling))
        lines.append(
            f"            contact g2(0) = {_fmt(c, c_err)} "
            f"(cusp-constrained r->0 fit; Hellmann-Feynman: "
            f"dE/dg = {nop * (nop - 1) / (2 * sc_size) * c:.6g})")
    if full:
        for b in range(num_bins):
            lines.append(f"            r = {r[b]:8.4f}   "
                         f"g2 = {_fmt(g2[b], g2_err[b])}")
    return lines


def _obd_lines(obd_blocks, nop: int, sc_size: float, num_pos: int,
               full: bool) -> t.List[str]:
    from ..analysis import momentum_distribution

    mean = np.asarray(obd_blocks.mean, dtype=np.float64)
    err = np.asarray(obd_blocks.mean_error, dtype=np.float64)
    offsets = np.linspace(0.0, 0.5 * sc_size, num_pos)
    lines = [
        f"OBDM        n1 on {num_pos} displacements over [0, L/2]: "
        f"n1(0) = {_fmt(mean[0], err[0])}, "
        f"n1(L/2) = {_fmt(mean[-1], err[-1])}",
    ]
    if num_pos >= 2:
        momenta, occ, occ_err = momentum_distribution(
            offsets, mean, sc_size, nop, n1_err=err)
        lines.append(f"            condensate fraction "
                     f"n(k=0)/N = {_fmt(occ[0] / nop, occ_err[0] / nop)}")
    if full:
        for i in range(num_pos):
            lines.append(f"            sz = {offsets[i]:8.4f}   "
                         f"n1 = {_fmt(mean[i], err[i])}")
    return lines


def describe_dmc(result, full: bool = False) -> str:
    """Render a DMC ``ProcResult`` as a physics report."""
    proc = result.proc
    blocks = result.data.blocks
    nop = proc.model_spec.boson_number
    sc = proc.model_spec.supercell_size
    num_blocks = len(blocks.energy.totals)

    lines = ["== DMC result =="]
    lines += _model_lines(proc.model_spec)
    lines.append(
        f"sampling    dt = {proc.time_step:g}, "
        f"{proc.target_num_walkers} target walkers "
        f"(max {proc.max_num_walkers}), "
        f"{num_blocks} blocks x {proc.num_time_steps_block} steps"
        + (f", est_every = {proc.est_every}" if proc.est_every > 1
           else "") + f", dtype = {proc.dtype}")
    e_mean = float(blocks.energy.mean)
    e_err = float(blocks.energy.mean_error)
    lines.append(f"energy      E/N = {_fmt(e_mean / nop, e_err / nop)}"
                 f"   (E = {_fmt(e_mean, e_err)} per walker)")
    ll = _exact_ll_reference(proc.model_spec)
    if ll is not None:
        dev = (e_mean / nop - ll["e"]) / max(e_err / nop, 1e-300)
        lines.append(
            f"            exact Lieb-Liniger (v0 = 0, Bethe ansatz): "
            f"E/N = {ll['e']:.6g} ({dev:+.1f} sigma), "
            f"c = {ll['sound_speed']:.6g}, K = {ll['luttinger_k']:.6g}")
    lines.append(_correlation_line(blocks.energy))
    state = result.state
    if state is not None and hasattr(state, "accum_energy"):
        lines.append(
            f"growth      accumulated growth energy/N = "
            f"{float(state.accum_energy) / nop:.6g}, "
            f"last E_ref/N = "
            f"{float(state.ref_energy) / nop:.6g}")
    # Walker/weight totals are per-block SUMS over the block's steps
    # (the upstream library's convention, ``qmc_exec/data/dmc.py:263-267``) —
    # unless the file stores the full per-step series
    # (``keep_iter_data``), where each entry covers one step.
    entries = len(blocks.num_walkers.totals)
    steps_per_entry = proc.num_time_steps_block \
        if entries < proc.num_blocks * proc.num_time_steps_block else 1
    nw_mean = float(blocks.num_walkers.mean) / steps_per_entry
    nw_err = float(blocks.num_walkers.mean_error) / steps_per_entry
    lines.append(
        f"population  <walkers> = {_fmt(nw_mean, nw_err)} "
        f"({100.0 * nw_mean / proc.target_num_walkers:.2f}% of target), "
        f"<weight>/step = "
        f"{float(blocks.weight.mean) / steps_per_entry:.6g}")
    if blocks.density is not None:
        lines += _density_lines(blocks.density, nop, sc, full)
        if blocks.ss_factor is not None:
            lines += _density_consistency_line(blocks.density,
                                               blocks.ss_factor, nop,
                                               sc)
    if blocks.ss_factor is not None:
        lines += _ssf_lines(blocks.ss_factor, nop, sc, full)
    if blocks.one_body_dm is not None and proc.obd_spec is not None:
        lines += _obd_lines(blocks.one_body_dm, nop, sc,
                            proc.obd_spec.num_pos, full)
    if blocks.pair_corr is not None:
        lines += _pair_corr_lines(
            blocks.pair_corr, nop, sc, full,
            coupling=proc.model_spec.interaction_strength)
        if blocks.ss_factor is not None:
            lines += _g2_consistency_line(blocks.pair_corr,
                                          blocks.ss_factor, nop, sc)
    mm = None
    if blocks.cm_diffusion is not None:
        mm = blocks.cm_diffusion.effective_mass_ratio()
        lines.append(f"transport   m/m* (superfluid fraction) = "
                     f"{_fmt(*mm)} from "
                     f"{blocks.cm_diffusion.num_windows} CM-diffusion "
                     f"windows")
    if blocks.itc is not None:
        s_p, s_pe = _pure_ssf_for_itc(blocks.itc, blocks.ss_factor,
                                      proc, nop)
        in_lattice = getattr(proc.model_spec, "lattice_depth",
                             0.0) > 1e-12
        lines += _itc_lines(blocks.itc, blocks.ss_factor, nop, full,
                            ssf_pure=s_p, ssf_pure_err=s_pe,
                            lattice_mm=mm if in_lattice else None,
                            itc_pure=getattr(proc.itc_spec,
                                             "as_pure_est", False))
    lines += _luttinger_lines(blocks, proc, nop, sc, mm=mm)
    return "\n".join(lines)


def _pure_ssf_for_itc(itc, ssf_blocks, proc, nop: int):
    """Mode-aligned per-particle PURE S(k) (+err) for the hybrid
    (amplitude-bias-free) static response; ``(None, None)`` when the
    run's S(k) is mixed or absent (the mixed amplitude would defeat
    the point of the rescale) — or when the ITC itself is the pure
    (forward-walked) estimator, whose amplitude needs no rescue."""
    itc_spec = getattr(proc, "itc_spec", None)
    if getattr(itc_spec, "as_pure_est", False):
        return None, None
    spec = getattr(proc, "ssf_spec", None)
    if ssf_blocks is None or spec is None \
            or not getattr(spec, "as_pure_est", False):
        return None, None
    n_m = itc.num_modes
    s = np.full(n_m, np.nan)
    se = np.full(n_m, np.nan)
    mean = np.asarray(ssf_blocks.mean, dtype=np.float64) / nop
    err = np.asarray(ssf_blocks.mean_error, dtype=np.float64) / nop
    m = min(n_m, mean.shape[0])
    s[:m] = mean[:m]
    se[:m] = err[:m]
    return s, se


def _itc_lines(itc_blocks, ssf_blocks, nop: int, full: bool,
               ssf_pure=None, ssf_pure_err=None, lattice_mm=None,
               itc_pure: bool = False) -> t.List[str]:
    """Imaginary-time correlation: effective excitation energies from
    the large-tau log slope of F(k, tau) — a tau-dependent UPPER bound
    on the lowest excitation at each k, tighter than (and bounded by)
    the Feynman S(k) estimate."""
    tau = itc_blocks.tau_grid
    tau_mid, omega, omega_err = itc_blocks.effective_energy()
    lines = [f"itc         F(k,tau) on {len(tau) - 1} lags "
             f"(dtau = {itc_blocks.tau_step:g}, tau_max = "
             f"{tau[-1]:g}); omega_eff(k, tau_max) = excitation upper "
             f"bound, tightening with tau"]
    # The deepest RESOLVED lag per mode is the tightest bound this run
    # reaches (deeper rows may never have filled on short runs — those
    # are NaN by construction, not zeros).
    show = range(1, min(4, itc_blocks.num_modes))
    parts = []
    for j in show:
        finite = np.where(np.isfinite(omega[:, j]))[0]
        if finite.size:
            li = finite[-1]
            parts.append(f"k{j} = {_fmt(omega[li, j], omega_err[li, j])}")
    if parts:
        lines.append("            omega_eff at tau_max: "
                     + ", ".join(parts))
    if ssf_blocks is not None:
        # Feynman upper bound from the same run's S(k) — omega_eff
        # must undercut (or match) it within errors.  The bound
        # inherits S(k)'s statistical error (relative error carried
        # over, k^2 exact): at noisy long-wavelength modes an
        # apparent omega_eff-above-Feynman is usually this error bar,
        # not a bound violation — print it.
        try:
            momenta = itc_blocks.momenta
            s_mean = ssf_blocks.mean / nop
            s_err = np.asarray(ssf_blocks.mean_error,
                               dtype=np.float64) / nop
            feyn = np.full(len(momenta), np.nan)
            feyn_err = np.full(len(momenta), np.nan)
            nz = s_mean[:len(momenta)] > 0
            feyn[nz] = momenta[nz] ** 2 / s_mean[:len(momenta)][nz]
            feyn_err[nz] = feyn[nz] * (s_err[:len(momenta)][nz]
                                       / s_mean[:len(momenta)][nz])
            parts = [f"k{j} = " + _fmt(feyn[j], feyn_err[j], prec=4)
                     for j in show if np.isfinite(feyn[j])]
            if parts:
                lines.append("            Feynman bound k^2/S(k) for "
                             "comparison: " + ", ".join(parts))
        except (ValueError, IndexError):  # pragma: no cover
            pass
    # Spectral inversion (regularized inverse Laplace): the mean
    # excitation omega_mean = m1/m0 per mode, plus the f-sum closure
    # m1/k^2 (the inversion does not enforce it — a ratio near 1 says
    # the whole two-time pipeline is internally consistent).  Needs a
    # few filled lags to mean anything.
    filled = int((itc_blocks.lag_counts.sum(axis=0) > 0).sum()) - 1
    if filled >= 4:
        try:
            spec = itc_blocks.spectral_function(num_omega=48)
            momenta = itc_blocks.momenta
            parts, closure = [], []
            for j in show:
                if np.isfinite(spec["omega_mean"][j]):
                    entry = f"k{j} = " + _fmt(
                        spec["omega_mean"][j],
                        spec["omega_mean_err"][j])
                    sys_j = spec["omega_mean_sys"][j]
                    if np.isfinite(sys_j):
                        entry += f" (+/- {sys_j:.2g} sys)"
                    parts.append(entry)
                    closure.append(
                        f"k{j} = {spec['m1'][j] / momenta[j] ** 2:.3f}")
            if parts:
                lines.append("            S(k,omega) inversion, mean "
                             "excitation m1/m0 [sys = finite-tau_max "
                             "resolution, shrinks with deeper lags]: "
                             + ", ".join(parts))
                lines.append("            f-sum closure m1/k^2 (-> 1): "
                             + ", ".join(closure))
        except (ValueError, np.linalg.LinAlgError):  # pragma: no cover
            pass
        # Static response chi(k) = -2 m_{-1} (inverse-moment sum rule,
        # tail-completed tau integral of F): the m0/m_{-1} excitation
        # bound is Cauchy-Schwarz-tighter than Feynman's m1/m0, and
        # 1/sqrt(m_{-1}) -> c as k -> 0 (compressibility sum rule) —
        # a third, independent sound-speed route.
        try:
            sr = itc_blocks.static_response(ssf=ssf_pure,
                                            ssf_err=ssf_pure_err)
            if itc_pure:
                amp = "pure (forward-walked) amplitude"
            elif ssf_pure is not None:
                amp = "pure-S(k) amplitude"
            else:
                amp = "mixed amplitude"
            parts = [f"k{j} = " + _fmt(sr["chi"][j], sr["chi_err"][j])
                     for j in show if np.isfinite(sr["chi"][j])]
            if parts:
                lines.append("            static response chi(k) = "
                             f"-2 m_{{-1}} [{amp}]: "
                             + ", ".join(parts))
                bound = [f"k{j} = " + _fmt(sr["omega_bound"][j],
                                           sr["omega_bound_err"][j])
                         for j in show
                         if np.isfinite(sr["omega_bound"][j])]
                lines.append("            excitation bound m0/m_{-1} "
                             "(<= Feynman m1/m0): " + ", ".join(bound))
                j_lo = next((j for j in show
                             if np.isfinite(sr["sound_speed"][j])),
                            None)
                if j_lo is not None:
                    lines.append(
                        "            sound speed from chi(k"
                        f"{j_lo}) [compressibility sum rule, k->0]: "
                        + _fmt(sr["sound_speed"][j_lo],
                               sr["sound_speed_err"][j_lo]))
                    if lattice_mm is not None \
                            and np.isfinite(lattice_mm[0]) \
                            and lattice_mm[0] > 0:
                        # Galilean-broken Luttinger split: in a
                        # lattice c^2 = v_J v_N, i.e. the
                        # compressibility speed picks up the phase-
                        # stiffness factor sqrt(m/m*) measured by the
                        # same run's CM diffusion (exact at v0 = 0
                        # where m/m* = 1).  Chip validation:
                        # BASELINE.md "Lattice phonon closure".
                        mmv, mme = lattice_mm
                        c_l = np.sqrt(mmv) * sr["sound_speed"][j_lo]
                        rel = np.hypot(
                            0.5 * mme / mmv,
                            sr["sound_speed_err"][j_lo]
                            / sr["sound_speed"][j_lo])
                        lines.append(
                            "            lattice sound speed "
                            "sqrt(m/m*) x chi-route [Galilean-broken "
                            "Luttinger split]: "
                            + _fmt(c_l, abs(c_l) * rel))
        except (ValueError, np.linalg.LinAlgError):  # pragma: no cover
            pass
    if full:
        f_norm = itc_blocks.normalized
        for j in show:
            lines.append(
                f"            F(k{j}, tau)/F(k{j}, 0) = "
                + ", ".join(f"{v:.4f}" for v in f_norm[:, j]))
    return lines


def _exact_ll_reference(model_spec) -> t.Optional[dict]:
    """Exact Bethe-ansatz ground-state data when the model IS the
    Lieb-Liniger gas (no lattice, no defects, repulsive coupling);
    None otherwise.  Used by the report as an absolute reference line
    — every v0 = 0 run can be checked against the exact solution."""
    try:
        if model_spec.lattice_depth > 1e-12 \
                or getattr(model_spec, "num_defects", 0) \
                or model_spec.interaction_strength <= 0:
            return None
        dens = model_spec.boson_number / model_spec.supercell_size
        # Model reduction (models/mrbp.py lgm): gamma = gn/(2 n^2).
        gamma = model_spec.interaction_strength / (2.0 * dens ** 2)
    except AttributeError:     # partial spec (e.g. unit-test stubs)
        return None
    from ..lieb_liniger import ground_state

    return ground_state(gamma, density=dens, num_points=256)


def _luttinger_lines(blocks, proc, nop: int, sc: float,
                     mm: t.Optional[t.Tuple[float, float]] = None) \
        -> t.List[str]:
    """Luttinger-liquid universality: K from the OBDM tail, and — when
    the run also measured S(k) and the CM diffusion — the hydrodynamic
    ``K = v_J / c = 2 pi n f_s / c`` from two OTHER estimator chains
    of the same run."""
    if blocks.one_body_dm is None or proc.obd_spec is None:
        return []
    from ..analysis import luttinger_parameter_from_obdm

    n1 = np.asarray(blocks.one_body_dm.mean, dtype=np.float64)
    n1_err = np.asarray(blocks.one_body_dm.mean_error,
                        dtype=np.float64)
    if n1.shape[0] < 6:
        return []
    offsets = np.linspace(0.0, 0.5 * sc, n1.shape[0])
    # On a non-trivial lattice only period-commensurate displacements
    # carry the clean Luttinger envelope (the period is 1 LKP by the
    # unit system).
    period = 1.0 if proc.model_spec.lattice_depth > 1e-10 else None
    try:
        k_obdm, k_err = luttinger_parameter_from_obdm(
            offsets, n1, sc, n1_err=n1_err, lattice_period=period)
    except ValueError:
        return []
    if not np.isfinite(k_obdm):
        return []
    lines = [f"Luttinger   K from the OBDM tail "
             f"(n1 ~ d^(-1/2K)) = {_fmt(k_obdm, k_err)}",
             "            NOTE: finite-size/window bias inflates the "
             "OBDM-tail K — treat it as an UPPER bound; prefer the "
             "hydrodynamic K below when available (BASELINE.md "
             "Luttinger study: tail-K ~2.4x high at the TG point)"]
    if blocks.ss_factor is not None \
            and blocks.cm_diffusion is not None:
        num_modes = np.asarray(
            blocks.ss_factor.fdk_sqr_abs_part.totals).shape[-1]
        if num_modes >= 4:
            c, c_err = blocks.ss_factor.sound_speed(nop, sc)
            fs, fs_err = mm if mm is not None \
                else blocks.cm_diffusion.effective_mass_ratio()
            if np.isfinite(c) and c > 0:
                dens = nop / sc
                k_hydro = 2 * np.pi * dens * fs / c
                k_hydro_err = k_hydro * np.sqrt(
                    (fs_err / max(fs, 1e-300)) ** 2
                    + (c_err / c) ** 2)
                lines.append(
                    f"            K from hydrodynamics "
                    f"(2 pi n f_s / c, independent chains) = "
                    f"{_fmt(k_hydro, k_hydro_err)}")
    ll = _exact_ll_reference(proc.model_spec)
    if ll is not None:
        lines.append(f"            exact Lieb-Liniger K "
                     f"(v0 = 0, Bethe ansatz) = "
                     f"{ll['luttinger_k']:.6g}")
    return lines


def describe_vmc(result, full: bool = False) -> str:
    """Render a VMC ``ProcResult`` as a physics report."""
    proc = result.proc
    blocks = result.data.blocks
    nop = proc.model_spec.boson_number
    sc = proc.model_spec.supercell_size
    num_blocks = len(blocks.energy.totals)

    lines = ["== VMC result =="]
    lines += _model_lines(proc.model_spec)
    lines.append(
        f"sampling    move_spread = {proc.move_spread:g}, "
        f"{proc.num_walkers} chain(s), "
        f"{num_blocks} blocks x {proc.num_steps_block} steps"
        + (f", est_every = {proc.est_every}" if proc.est_every > 1
           else "") + f", dtype = {proc.dtype}")
    e_mean = float(blocks.energy.mean)
    e_err = float(blocks.energy.mean_error)
    lines.append(f"energy      E/N = {_fmt(e_mean / nop, e_err / nop)}"
                 f"   (variational upper bound)")
    ll = _exact_ll_reference(proc.model_spec)
    if ll is not None:
        gap = e_mean / nop - ll["e"]
        lines.append(
            f"            exact Lieb-Liniger (v0 = 0, Bethe ansatz): "
            f"E/N = {ll['e']:.6g} — variational gap "
            f"{gap:+.4g} ({100.0 * gap / abs(ll['e']):.2f}% of E, "
            f"trial-function quality)")
    lines.append(_correlation_line(blocks.energy))
    if blocks.ss_factor is not None:
        lines += _ssf_lines(blocks.ss_factor, nop, sc, full)
    if blocks.one_body_dm is not None and proc.obd_spec is not None:
        lines += _obd_lines(blocks.one_body_dm, nop, sc,
                            proc.obd_spec.num_pos, full)
    if blocks.pair_corr is not None:
        lines += _pair_corr_lines(
            blocks.pair_corr, nop, sc, full,
            coupling=proc.model_spec.interaction_strength)
        if blocks.ss_factor is not None:
            lines += _g2_consistency_line(blocks.pair_corr,
                                          blocks.ss_factor, nop, sc)
    return "\n".join(lines)


def summarize(result, sampling_type: str) -> dict:
    """The report's headline observables as a plain JSON-able dict —
    the machine-readable face of ``describe_dmc``/``describe_vmc`` for
    pipelines (``mrbp-dmc analyze --json``).  Curves come as
    ``[values...]`` lists with matching ``*_err`` entries; absent
    estimators are absent keys.
    """
    proc = result.proc
    blocks = result.data.blocks
    nop = proc.model_spec.boson_number
    sc = proc.model_spec.supercell_size
    out = {
        "sampling_type": sampling_type,
        "model_spec": {
            "lattice_depth": proc.model_spec.lattice_depth,
            "lattice_ratio": proc.model_spec.lattice_ratio,
            "interaction_strength":
                proc.model_spec.interaction_strength,
            "boson_number": nop,
            "supercell_size": sc,
            "tbf_contact_cutoff": proc.model_spec.tbf_contact_cutoff,
        },
        "energy_per_particle": float(blocks.energy.mean) / nop,
        "energy_per_particle_err":
            float(blocks.energy.mean_error) / nop,
        "num_blocks": int(len(blocks.energy.totals)),
    }
    if sampling_type == "dmc":
        out["time_step"] = proc.time_step
        out["target_num_walkers"] = proc.target_num_walkers
    density = getattr(blocks, "density", None)
    if density is not None:
        out["density"] = np.asarray(density.mean).tolist()
        out["density_err"] = np.asarray(density.mean_error).tolist()
    if blocks.ss_factor is not None:
        out["ssf"] = (np.asarray(blocks.ss_factor.mean) / nop).tolist()
        out["ssf_err"] = (np.asarray(blocks.ss_factor.mean_error)
                          / nop).tolist()
        if len(out["ssf"]) >= 4:
            c, c_err = blocks.ss_factor.sound_speed(nop, sc)
            if np.isfinite(c):
                out["sound_speed"] = float(c)
                out["sound_speed_err"] = float(c_err)
    if blocks.one_body_dm is not None and proc.obd_spec is not None:
        from ..analysis import momentum_distribution
        n1 = np.asarray(blocks.one_body_dm.mean)
        n1_err = np.asarray(blocks.one_body_dm.mean_error)
        out["obdm"] = n1.tolist()
        out["obdm_err"] = n1_err.tolist()
        if n1.shape[0] >= 2:
            offsets = np.linspace(0.0, 0.5 * sc, n1.shape[0])
            _, occ, occ_err = momentum_distribution(
                offsets, n1, sc, nop, n1_err=n1_err)
            out["condensate_fraction"] = float(occ[0] / nop)
            out["condensate_fraction_err"] = float(occ_err[0] / nop)
    if getattr(blocks, "pair_corr", None) is not None:
        r, g2, g2_err = blocks.pair_corr.pair_correlation(nop, sc)
        out["g2"] = g2.tolist()
        out["g2_err"] = g2_err.tolist()
        coupling = proc.model_spec.interaction_strength
        if coupling > 0 and g2.shape[0] >= 4:
            from ..analysis import contact_from_pair_correlation
            c0, c0_err = contact_from_pair_correlation(
                r, g2, g2_err, float(coupling))
            out["g2_contact"] = c0
            out["g2_contact_err"] = c0_err
    cmd = getattr(blocks, "cm_diffusion", None)
    if cmd is not None:
        ratio, ratio_err = cmd.effective_mass_ratio()
        out["effective_mass_ratio"] = float(ratio)
        out["effective_mass_ratio_err"] = float(ratio_err)
    itc = getattr(blocks, "itc", None)
    if itc is not None:
        out["itc_tau"] = itc.tau_grid.tolist()
        out["itc"] = np.asarray(itc.mean).tolist()
        out["itc_err"] = np.asarray(itc.mean_error).tolist()
        _, omega, omega_err = itc.effective_energy()
        # The tightest (deepest RESOLVED lag) excitation upper bound
        # per mode; NaN where a mode never resolved a slope.
        last = np.full(omega.shape[1], np.nan)
        last_err = np.full(omega.shape[1], np.nan)
        for j in range(omega.shape[1]):
            finite = np.where(np.isfinite(omega[:, j]))[0]
            if finite.size:
                last[j] = omega[finite[-1], j]
                last_err[j] = omega_err[finite[-1], j]
        out["itc_omega_eff"] = last.tolist()
        out["itc_omega_eff_err"] = last_err.tolist()
        # Tail-fit decay rates (averaged over the filled tail — the
        # steadier upper bound; see ITCBlocks.excitation_fit).
        fit, fit_err = itc.excitation_fit()
        out["itc_omega_fit"] = np.asarray(fit).tolist()
        out["itc_omega_fit_err"] = np.asarray(fit_err).tolist()
        # Spectral-inversion moments (see ITCBlocks.spectral_function);
        # omega_mean = m1/m0 and the un-enforced f-sum first moment m1.
        if int((itc.lag_counts.sum(axis=0) > 0).sum()) - 1 >= 4:
            try:
                spec = itc.spectral_function(num_omega=48)
                out["itc_spectral_omega_mean"] = \
                    spec["omega_mean"].tolist()
                out["itc_spectral_omega_mean_err"] = \
                    spec["omega_mean_err"].tolist()
                # Self-calibrated finite-resolution systematic (the
                # jackknife above is statistical only); quote the
                # moments as value +/- err +/- sys.
                out["itc_spectral_omega_mean_sys"] = \
                    spec["omega_mean_sys"].tolist()
                out["itc_spectral_omega_peak_sys"] = \
                    spec["omega_peak_sys"].tolist()
                out["itc_spectral_m0"] = spec["m0"].tolist()
                out["itc_spectral_m1"] = spec["m1"].tolist()
                out["itc_spectral_m1_sys"] = spec["m1_sys"].tolist()
            except (ValueError, np.linalg.LinAlgError):  # pragma: no cover
                pass
            # Static response chi(k) = -2 m_{-1} and its derived
            # diagnostics (see ITCBlocks.static_response); hybrid
            # pure-S(k) amplitude whenever the run measured one.
            try:
                s_p, s_pe = _pure_ssf_for_itc(
                    itc, blocks.ss_factor, proc, nop)
                sr = itc.static_response(ssf=s_p, ssf_err=s_pe)
                for key in ("m_minus1", "m_minus1_err", "chi",
                            "chi_err", "omega_bound",
                            "omega_bound_err", "sound_speed",
                            "sound_speed_err"):
                    out[f"itc_{key}"] = np.asarray(sr[key]).tolist()
                if getattr(proc.itc_spec, "as_pure_est", False):
                    out["itc_chi_amplitude"] = "pure-forward-walked"
                else:
                    out["itc_chi_amplitude"] = \
                        "pure" if s_p is not None else "mixed"
                # Galilean-broken Luttinger split (lattice runs with a
                # CM-diffusion measurement): c = sqrt(m/m*) / sqrt(m_{-1}).
                cmd = getattr(blocks, "cm_diffusion", None)
                if cmd is not None and getattr(
                        proc.model_spec, "lattice_depth", 0.0) > 1e-12:
                    mmv, mme = cmd.effective_mass_ratio()
                    if np.isfinite(mmv) and mmv > 0:
                        c_arr = np.sqrt(mmv) \
                            * np.asarray(sr["sound_speed"])
                        with np.errstate(invalid="ignore",
                                         divide="ignore"):
                            rel = np.hypot(
                                0.5 * mme / mmv,
                                np.asarray(sr["sound_speed_err"])
                                / np.asarray(sr["sound_speed"]))
                        out["itc_sound_speed_lattice_split"] = \
                            c_arr.tolist()
                        out["itc_sound_speed_lattice_split_err"] = \
                            np.abs(c_arr * rel).tolist()
            except (ValueError, np.linalg.LinAlgError):  # pragma: no cover
                pass
    ll = _exact_ll_reference(proc.model_spec)
    if ll is not None:
        out["exact_lieb_liniger"] = {
            "e_per_particle": ll["e"], "mu": ll["mu"],
            "sound_speed": ll["sound_speed"],
            "luttinger_k": ll["luttinger_k"],
            "ssf_slope": ll["ssf_slope"], "chi_k0": ll["chi_k0"]}
    if sampling_type == "vmc":
        out["move_spread"] = proc.move_spread
        out["num_walkers"] = proc.num_walkers
    return out


def summarize_extrapolated(dmc_result, vmc_result) -> dict:
    """Machine-readable counterpart of :func:`describe_extrapolated`:
    the ``2 <DMC mixed> - <VMC>`` curves (and the extrapolated
    condensate fraction) as a JSON-able dict.  Pure (forward-walking)
    DMC estimators are skipped exactly as in the text report."""
    from ..analysis import extrapolated_estimate, momentum_distribution

    dproc, vproc = dmc_result.proc, vmc_result.proc
    if dproc.model_spec != vproc.model_spec:
        raise ValueError(
            "extrapolation needs matching model specs (same physics "
            "AND the same trial function)")
    nop = dproc.model_spec.boson_number
    sc = dproc.model_spec.supercell_size
    db, vb = dmc_result.data.blocks, vmc_result.data.blocks
    out = {}

    def _pair(d_blocks, v_blocks, as_pure):
        if d_blocks is None or v_blocks is None or as_pure:
            return None
        dm = np.asarray(d_blocks.mean)
        vm = np.asarray(v_blocks.mean)
        if dm.shape != vm.shape:
            return None
        return extrapolated_estimate(
            dm, vm, np.asarray(d_blocks.mean_error),
            np.asarray(v_blocks.mean_error))

    if db.one_body_dm is not None and vb.one_body_dm is not None:
        pair = _pair(db.one_body_dm, vb.one_body_dm,
                     dproc.obd_spec.as_pure_est)
        if pair is not None:
            n1, n1_err = pair
            out["obdm_ext"] = n1.tolist()
            out["obdm_ext_err"] = n1_err.tolist()
            if n1.shape[0] >= 2:
                offsets = np.linspace(0.0, 0.5 * sc, n1.shape[0])
                _, occ, occ_err = momentum_distribution(
                    offsets, n1, sc, nop, n1_err=n1_err)
                out["condensate_fraction_ext"] = float(occ[0] / nop)
                out["condensate_fraction_ext_err"] = \
                    float(occ_err[0] / nop)
    if db.ss_factor is not None and vb.ss_factor is not None:
        pair = _pair(db.ss_factor, vb.ss_factor,
                     dproc.ssf_spec.as_pure_est)
        if pair is not None:
            s, s_err = pair
            out["ssf_ext"] = (s / nop).tolist()
            out["ssf_ext_err"] = (s_err / nop).tolist()
    if db.pair_corr is not None and vb.pair_corr is not None:
        pair = _pair(db.pair_corr, vb.pair_corr,
                     dproc.pair_corr_spec.as_pure_est)
        if pair is not None:
            from ..analysis import pair_correlation_from_counts
            counts, counts_err = pair
            _, g2, g2_err = pair_correlation_from_counts(
                counts, nop, sc, counts_err=counts_err)
            out["g2_ext"] = g2.tolist()
            out["g2_ext_err"] = g2_err.tolist()
    return out


def describe_extrapolated(dmc_result, vmc_result,
                          full: bool = False) -> str:
    """Second-order extrapolated estimators ``2 <DMC mixed> - <VMC>``
    from a matched pair of runs (``analysis.extrapolated_estimate``).

    The standard correction for the first-order trial-wavefunction
    bias of MIXED DMC estimators; estimators the DMC run measured with
    forward walking (``as_pure_est: true``) are already projected and
    are skipped with a note.  Both runs must share the model spec (the
    formula cancels the bias of one specific trial function).
    """
    from ..analysis import extrapolated_estimate, momentum_distribution

    dproc, vproc = dmc_result.proc, vmc_result.proc
    if dproc.model_spec != vproc.model_spec:
        raise ValueError(
            "extrapolation needs matching model specs (same physics "
            "AND the same trial function); got "
            f"{dproc.model_spec} vs {vproc.model_spec}")
    nop = dproc.model_spec.boson_number
    sc = dproc.model_spec.supercell_size
    db, vb = dmc_result.data.blocks, vmc_result.data.blocks
    lines = ["== extrapolated estimators: 2 <DMC mixed> - <VMC> =="]

    def _curves(name, d_blocks, v_blocks, as_pure):
        if d_blocks is None or v_blocks is None:
            return None
        if as_pure:
            lines.append(
                f"{name:<11} skipped: the DMC run measured it with "
                f"forward walking (already projected; extrapolation "
                f"applies to mixed estimators)")
            return None
        dm, de = np.asarray(d_blocks.mean), np.asarray(
            d_blocks.mean_error)
        vm, ve = np.asarray(v_blocks.mean), np.asarray(
            v_blocks.mean_error)
        if dm.shape != vm.shape:
            lines.append(f"{name:<11} skipped: grid mismatch "
                         f"({dm.shape} vs {vm.shape})")
            return None
        return extrapolated_estimate(dm, vm, de, ve)

    if db.one_body_dm is not None and vb.one_body_dm is not None:
        out = _curves("OBDM", db.one_body_dm, vb.one_body_dm,
                      dproc.obd_spec.as_pure_est)
        if out is not None:
            n1, n1_err = out
            offsets = np.linspace(0.0, 0.5 * sc, n1.shape[0])
            lines.append(
                f"OBDM        n1_ext(L/2) = {_fmt(n1[-1], n1_err[-1])} "
                f"(DMC mixed {_fmt(np.asarray(db.one_body_dm.mean)[-1])}"
                f", VMC {_fmt(np.asarray(vb.one_body_dm.mean)[-1])})")
            if n1.shape[0] >= 2:
                momenta, occ, occ_err = momentum_distribution(
                    offsets, n1, sc, nop, n1_err=n1_err)
                lines.append(
                    f"            condensate fraction n(k=0)/N = "
                    f"{_fmt(occ[0] / nop, occ_err[0] / nop)}")
            if full:
                for i, sz in enumerate(offsets):
                    lines.append(f"            sz = {sz:8.4f}   "
                                 f"n1_ext = {_fmt(n1[i], n1_err[i])}")

    if db.ss_factor is not None and vb.ss_factor is not None:
        out = _curves("S(k)", db.ss_factor, vb.ss_factor,
                      dproc.ssf_spec.as_pure_est)
        if out is not None:
            s, s_err = out
            lines.append(
                f"S(k)        extrapolated, per particle: "
                f"S(k_1) = {_fmt(s[1] / nop, s_err[1] / nop)}, "
                f"S(k_max) = {_fmt(s[-1] / nop, s_err[-1] / nop)}")
            if full:
                momenta = np.arange(s.shape[0]) * 2 * np.pi / sc
                for j in range(s.shape[0]):
                    lines.append(
                        f"            k = {momenta[j]:8.4f}   "
                        f"S = {_fmt(s[j] / nop, s_err[j] / nop)}")

    if db.density is not None and getattr(vb, "density", None) is None:
        lines.append("density     skipped: the VMC run stored no "
                     "density estimator")
    if db.pair_corr is not None and vb.pair_corr is not None:
        out = _curves("g2(r)", db.pair_corr, vb.pair_corr,
                      dproc.pair_corr_spec.as_pure_est)
        if out is not None:
            from ..analysis import pair_correlation_from_counts
            counts, counts_err = out
            r, g2, g2_err = pair_correlation_from_counts(
                counts, nop, sc, counts_err=counts_err)
            lines.append(
                f"g2(r)       extrapolated: g2({r[0]:.4g}) = "
                f"{_fmt(g2[0], g2_err[0])}, "
                f"g2(L/2) = {_fmt(g2[-1], g2_err[-1])}")
            if full:
                for b in range(g2.shape[0]):
                    lines.append(f"            r = {r[b]:8.4f}   "
                                 f"g2_ext = {_fmt(g2[b], g2_err[b])}")

    if len(lines) == 1:
        lines.append("(no estimator stored in both runs)")
    return "\n".join(lines)


def _sweep_zero_fit(entries: t.Sequence[t.Tuple[str, t.Any]],
                    order: int, what: str, x_key: str,
                    x_of_proc: t.Callable[[t.Any], float],
                    caveat_of_procs: t.Callable[
                        [t.Sequence[t.Any]], t.List[str]],
                    spec_key: t.Optional[
                        t.Callable[[t.Any], t.Any]] = None) -> dict:
    """Shared machinery of the stored-sweep ``x -> 0`` energy
    extrapolations (``--dt-fit``, ``--nw-fit``): extract (x, E/N, err)
    per row, demand one shared model spec, run the weighted fit, and
    attach chi2/dof, a higher-degree check fit, and the exact
    Lieb-Liniger reference for v0 = 0."""
    from ..analysis import zero_limit_extrapolation

    if order < 1:
        # A degree-0 "fit" has no slope (coeffs[-2] below) and no
        # extrapolation content — fail with the same clean message
        # channel every other bad input gets (the CLI wraps
        # ValueError in a one-line ClickException).
        raise ValueError(
            f"a {what} fit needs a polynomial order >= 1, "
            f"got {order}")
    if len(entries) < 2:
        raise ValueError(
            f"a {what} fit needs at least two stored DMC results, "
            f"got {len(entries)}")
    specs = []
    groups, xs, means, errs = [], [], [], []
    for group, result in entries:
        proc = result.proc
        if not hasattr(proc, "time_step"):
            raise ValueError(
                f"group '{group or '/'}' is not a DMC result "
                f"(no time_step); the {what} fit applies to DMC "
                f"sweeps")
        nop = proc.model_spec.boson_number
        specs.append(proc.model_spec)
        groups.append(group)
        xs.append(x_of_proc(proc))
        blocks = result.data.blocks
        means.append(float(blocks.energy.mean) / nop)
        errs.append(float(blocks.energy.mean_error) / nop)
    base = specs[0]
    # ``spec_key`` projects out the fields the sweep legitimately
    # varies (the finite-size fit varies N and L together at fixed
    # density); the default compares whole specs.
    key = spec_key or (lambda s: s)
    base_key = key(base)
    for group, spec in zip(groups[1:], specs[1:]):
        if key(spec) != base_key:
            raise ValueError(
                f"the stored results do not share one model spec "
                f"(group '{groups[0] or '/'}' vs '{group or '/'}': "
                f"{base} vs {spec}); a {what} fit needs rows "
                f"differing only in the swept parameter")
    if len(set(xs)) < order + 1:
        raise ValueError(
            f"need at least {order + 1} distinct {what} values for a "
            f"degree-{order} fit, got {sorted(set(xs))}")
    caveats = caveat_of_procs([e[1].proc for e in entries])
    idx = np.argsort(xs)
    x = np.asarray(xs, dtype=np.float64)[idx]
    y = np.asarray(means, dtype=np.float64)[idx]
    y_err = np.asarray(errs, dtype=np.float64)[idx]
    e0, e0_err, coeffs = zero_limit_extrapolation(x, y, y_err,
                                                  order=order)
    out = {
        "order": order,
        "num_points": len(x),
        "groups": [groups[i] for i in idx],
        x_key: x.tolist(),
        "energy_per_particle": y.tolist(),
        "energy_per_particle_err": y_err.tolist(),
        "e0": e0,
        "e0_err": e0_err,
        "slope": float(coeffs[-2]),
    }
    dof = len(x) - (order + 1)
    if dof > 0:
        resid = (y - np.polyval(coeffs, x)) / np.maximum(y_err, 1e-300)
        out["chi2_dof"] = float((resid ** 2).sum() / dof)
    if len(x) >= order + 3 and len(set(xs)) >= order + 2:
        q0, q0_err, _ = zero_limit_extrapolation(x, y, y_err,
                                                 order=order + 1)
        out["check_fit"] = {"order": order + 1, "e0": q0,
                            "e0_err": q0_err}
    ll = _exact_ll_reference(base)
    if ll is not None:
        out["exact_ll"] = {
            "energy_per_particle": ll["e"],
            "sigma_dev": (e0 - ll["e"]) / max(e0_err, 1e-300),
        }
    if caveats:
        out["caveats"] = caveats
    return out


def summarize_dt_fit(entries: t.Sequence[t.Tuple[str, t.Any]],
                     order: int = 1) -> dict:
    """Time-step extrapolation ``E(dt) -> E(0)`` across a set of
    otherwise-identical DMC results — the production face of the
    ``benchmarks/dt_sweep.py`` workflow (BASELINE config #3), wired
    into ``mrbp-dmc analyze --dt-fit``.

    ``entries`` are ``(group, ProcResult)`` pairs, e.g. the rows of a
    fused ``time_step`` sweep stored in one HDF5 file.  The
    drift-diffusion Trotter bias is smooth in dt, so the headline is
    the degree-``order`` (default linear) weighted fit of E/N vs dt
    through :func:`~phd_qmclib_torch.analysis.zero_limit_extrapolation`;
    when at least ``order + 3`` points are available a
    degree-``order + 1`` check fit is attached so curvature
    contamination of the linear window is visible instead of silent.
    For a pure Lieb-Liniger model (v0 = 0, no defects) the exact
    Bethe-ansatz energy is attached with the extrapolation's
    sigma-deviation.

    The upstream library ships no analysis layer for this workflow at all —
    its DMC procedure (``qmc_exec/dmc/proc.py``) leaves time-step studies
    to notebook code outside the package.
    """
    def caveats(procs):
        walkers = {p.target_num_walkers for p in procs}
        if len(walkers) > 1:
            return [f"rows differ in target_num_walkers "
                    f"{sorted(walkers)}: the O(1/N_w) "
                    f"population-control bias is not constant across "
                    f"the fit"]
        return []

    return _sweep_zero_fit(entries, order, "time-step", "time_steps",
                           lambda p: float(p.time_step), caveats)


def summarize_nw_fit(entries: t.Sequence[t.Tuple[str, t.Any]],
                     order: int = 1) -> dict:
    """Population-control-bias extrapolation ``E(N_w) -> E(inf)``
    across a set of otherwise-identical DMC results at different
    walker targets (``mrbp-dmc analyze --nw-fit``).

    The E_ref feedback of the branching controller (the upstream
    library's formula: ``qmc_base/dmc.py:769-771``) biases the
    growth/mixed energy by O(1/N_w), so the fit variable is ``x =
    1/target_num_walkers`` and
    the reported ``e0`` is the infinite-population limit.  Rows that
    also differ in ``time_step`` carry a caveat (the Trotter bias
    would contaminate the fit)."""
    def caveats(procs):
        dts = {float(p.time_step) for p in procs}
        if len(dts) > 1:
            return [f"rows differ in time_step {sorted(dts)}: the "
                    f"O(dt) Trotter bias is not constant across the "
                    f"fit"]
        return []

    return _sweep_zero_fit(entries, order, "walker-number",
                           "inv_walkers",
                           lambda p: 1.0 / p.target_num_walkers,
                           caveats)


def summarize_fs_fit(entries: t.Sequence[t.Tuple[str, t.Any]],
                     order: int = 1) -> dict:
    """Finite-size extrapolation ``E/N(N) -> E/N(inf)`` across a set
    of DMC results at matched density and coupling but different
    particle numbers (``mrbp-dmc analyze --fs-fit``) — the third
    standard DMC convergence axis next to ``--dt-fit`` (Trotter) and
    ``--nw-fit`` (population control).

    Under periodic boundaries the low-energy physics is a gapless
    Luttinger liquid, so the leading finite-size correction to the
    ground-state energy density is the CFT Casimir term
    ``E/L = e_inf - pi c_sound/(6 L^2)`` (central charge 1) — at fixed
    density ``n = N/L`` the per-particle correction is ``O(1/N^2)``,
    which is the fit variable ``x = 1/N^2`` (degree ``order`` in x;
    NOT 1/N, whose coefficient vanishes for PBC).  For v0 = 0 the
    attached exact Bethe-ansatz reference IS the thermodynamic-limit
    energy, so its sigma-deviation gates the whole extrapolation —
    unlike the dt/nw fits, where the exact line carries the residual
    finite-size offset.

    Rows must share everything except ``boson_number`` and
    ``supercell_size`` (scaled together; a density mismatch is a hard
    error).  Rows differing in ``time_step`` or walker target carry
    caveats (those biases would contaminate the fit).  The upstream library
    leaves size studies to notebook code outside the package.
    """
    import dataclasses

    def spec_key(spec):
        d = dataclasses.asdict(spec)
        n = d.pop("boson_number")
        sc = d.pop("supercell_size")
        return (tuple(sorted(d.items())), round(n / sc, 10))

    def caveats(procs):
        out = []
        dts = {float(p.time_step) for p in procs}
        if len(dts) > 1:
            out.append(f"rows differ in time_step {sorted(dts)}: the "
                       f"O(dt) Trotter bias is not constant across "
                       f"the fit")
        walkers = {p.target_num_walkers for p in procs}
        if len(walkers) > 1:
            out.append(f"rows differ in target_num_walkers "
                       f"{sorted(walkers)}: the O(1/N_w) "
                       f"population-control bias is not constant "
                       f"across the fit")
        return out

    return _sweep_zero_fit(entries, order, "finite-size",
                           "inv_nop_sq",
                           lambda p: 1.0
                           / p.model_spec.boson_number ** 2,
                           caveats, spec_key=spec_key)


def describe_sweep_fit(summary: dict) -> str:
    """Render a :func:`summarize_dt_fit` / :func:`summarize_nw_fit` /
    :func:`summarize_fs_fit` dict as a human report."""
    nw = "inv_walkers" in summary
    fs = "inv_nop_sq" in summary
    if fs:
        title = "finite-size extrapolation E/N(N) -> E/N(inf)"
    elif nw:
        title = "population-control extrapolation E(N_w) -> E(inf)"
    else:
        title = "time-step extrapolation E(dt) -> E(0)"
    lines = [f"== {title} =="]
    xs = summary["inv_nop_sq" if fs
                 else "inv_walkers" if nw else "time_steps"]
    for xv, e, err, group in zip(xs, summary["energy_per_particle"],
                                 summary["energy_per_particle_err"],
                                 summary["groups"]):
        if fs:
            label = f"N = {1.0 / np.sqrt(xv):<8.6g}"
        elif nw:
            label = f"N_w = {1.0 / xv:<8.6g}"
        else:
            label = f"dt = {xv:<10.6g}"
        lines.append(f"  {label} E/N = {_fmt(e, err)}   "
                     f"[{group or '/'}]")
    chi2 = (f", chi2/dof = {summary['chi2_dof']:.3g}"
            if "chi2_dof" in summary else "")
    limit = ("E/N(N->inf)" if fs
             else "E/N(N_w->inf)" if nw else "E/N(dt->0)")
    lines.append(
        f"degree-{summary['order']} fit: "
        f"{limit} = {_fmt(summary['e0'], summary['e0_err'])} "
        f"(slope {summary['slope']:+.4g}{chi2})")
    check = summary.get("check_fit")
    if check is not None:
        lines.append(
            f"            degree-{check['order']} check fit: "
            f"{limit} = {_fmt(check['e0'], check['e0_err'])}")
    ll = summary.get("exact_ll")
    if ll is not None:
        lines.append(
            f"            exact Lieb-Liniger (v0 = 0, Bethe ansatz): "
            f"E/N = {ll['energy_per_particle']:.6g} "
            f"({ll['sigma_dev']:+.1f} sigma)")
    for caveat in summary.get("caveats", ()):
        lines.append(f"            caveat: {caveat}")
    return "\n".join(lines)


# Backward-compatible alias (the dt fit landed first).
describe_dt_fit = describe_sweep_fit


def sweep_fit_hdf5(location: str, kind: str = "dt",
                   group_prefix: t.Optional[str] = None,
                   order: int = 1) -> dict:
    """Load every stored DMC result in ``location`` (optionally
    restricted to groups starting with ``group_prefix``, e.g. one
    sweep's row prefix) and run the ``kind`` extrapolation
    (``"dt"`` -> :func:`summarize_dt_fit`, ``"nw"`` ->
    :func:`summarize_nw_fit`, ``"fs"`` -> :func:`summarize_fs_fit`)
    on them."""
    from .io import DmcHDF5FileHandler

    entries = [(g, st) for g, st in find_result_groups(location)
               if st == "dmc"]
    if group_prefix is not None:
        entries = [(g, st) for g, st in entries
                   if g.startswith(group_prefix)]
    loaded = [(g, DmcHDF5FileHandler(location=location,
                                         group=g).load(device="cpu"))
              for g, _ in entries]
    if len(loaded) < 2:
        stored = ", ".join(g or "/" for g, _ in entries) or "none"
        raise ValueError(
            f"--{kind}-fit needs at least two stored DMC results in "
            f"'{location}' (matching prefix {group_prefix!r}; "
            f"found: {stored})")
    fit = {"dt": summarize_dt_fit, "nw": summarize_nw_fit,
           "fs": summarize_fs_fit}[kind]
    return fit(loaded, order=order)


def dt_fit_hdf5(location: str, group_prefix: t.Optional[str] = None,
                order: int = 1) -> dict:
    """:func:`sweep_fit_hdf5` with ``kind="dt"``."""
    return sweep_fit_hdf5(location, "dt", group_prefix, order)


def find_result_groups(location: str) -> t.List[t.Tuple[str, str]]:
    """``(group, sampling_type)`` pairs stored in an HDF5 result file."""
    import h5py

    found = []

    def visit(name, obj):
        if not isinstance(obj, h5py.Group):
            return
        tail = name.rsplit("/", 1)[-1]
        if tail in ("vmc", "dmc") and "proc_spec" in obj \
                and "data" in obj:
            found.append((name.rsplit("/", 1)[0] if "/" in name else "",
                          tail))

    with h5py.File(location, "r") as fp:
        fp.visititems(visit)
    return found


def report_hdf5(location: str, group: t.Optional[str] = None,
                sampling_type: t.Optional[str] = None,
                full: bool = False, as_json: bool = False) -> str:
    """Report every matching result stored in ``location``.

    ``group``/``sampling_type`` filter; by default all stored results
    are rendered (one report per ``{group}/{vmc|dmc}`` entry).  With
    ``as_json`` the output is a JSON array of :func:`summarize` dicts
    (one per entry, plus ``group``) instead of the human report.
    """
    import h5py

    from .io import DmcHDF5FileHandler, VmcHDF5FileHandler

    entries = find_result_groups(location)
    if group is not None:
        entries = [e for e in entries if e[0] == group]
    if sampling_type is not None:
        entries = [e for e in entries if e[1] == sampling_type]
    if not entries:
        stored = ", ".join(f"{g or '/'}:{st}"
                           for g, st in find_result_groups(location)) \
            or "none"
        hint = ""
        with h5py.File(location, "r") as fp:
            state_only = []

            def visit(name, obj):
                if isinstance(obj, h5py.Group) and "state" in obj \
                        and "data" not in obj \
                        and name.rsplit("/", 1)[-1] in ("vmc", "dmc"):
                    state_only.append(name)

            fp.visititems(visit)
        if state_only:
            hint = ("; the file holds a mid-run CHECKPOINT (state + "
                    "proc_spec, no data) — continue it with "
                    "Proc.restore_checkpoint instead of analyzing it")
        raise ValueError(
            f"no matching results in '{location}' "
            f"(group={group!r}, type={sampling_type!r}; "
            f"stored: {stored}){hint}")
    reports = []
    summaries = []
    for grp, stype in entries:
        handler_cls = DmcHDF5FileHandler if stype == "dmc" \
            else VmcHDF5FileHandler
        result = handler_cls(location=location, group=grp).load(device="cpu")
        if as_json:
            summaries.append({"group": grp, **summarize(result, stype)})
            continue
        describe = describe_dmc if stype == "dmc" else describe_vmc
        header = f"-- {location} :: {grp or '/'} --"
        reports.append(header + "\n" + describe(result, full=full))
    if as_json:
        import json

        return json.dumps(summaries, indent=2)
    return "\n\n".join(reports)
