"""Post-processing helpers for measured estimators.

The port's own copy of the JAX package's ``analysis.py`` (NumPy only,
``scipy.optimize`` inside the spectral inversion).  The upstream library
ships no analysis layer; these helpers consume the block-statistics
data model directly.
"""
import typing as t

import numpy as np

__all__ = ["contact_from_pair_correlation",
           "effective_mass_from_cm_diffusion", "leggett_bound",
           "luttinger_parameter_from_obdm",
           "momentum_distribution",
           "extrapolated_estimate", "pair_correlation_from_counts",
           "pair_correlation_from_ssf", "spectral_function_from_itc"]


def pair_correlation_from_counts(counts: np.ndarray,
                                 boson_number: int,
                                 supercell_size: float,
                                 counts_err: t.Optional[np.ndarray]
                                 = None):
    """Normalize a mean pair-distance histogram to ``g2(r)``.

    ``counts``: per-walker mean unordered-pair counts on uniform bins
    over ``[0, L/2]`` (the direct pair-correlation estimator's output,
    ``pair_corr_est_spec``).  Returns ``(r_centers, g2, g2_err)`` with
    ``g2(r) = counts * L / (N (N-1) dr)`` — exactly 1 for uncorrelated
    uniform positions.  The single normalization authority for the
    direct-histogram route (both samplers' data layers and the
    benchmarks delegate here).
    """
    if boson_number < 2:
        raise ValueError("g2 is undefined for fewer than two bosons")
    counts = np.asarray(counts, dtype=np.float64)
    num_bins = counts.shape[-1]
    dr = 0.5 * supercell_size / num_bins
    r_centers = (np.arange(num_bins) + 0.5) * dr
    norm = supercell_size / (boson_number * (boson_number - 1) * dr)
    err = None if counts_err is None \
        else np.asarray(counts_err, dtype=np.float64) * norm
    return r_centers, counts * norm, err


def momentum_distribution(offsets: np.ndarray, n1: np.ndarray,
                          supercell_size: float, boson_number: int,
                          n1_err: t.Optional[np.ndarray] = None):
    """Momentum occupations ``n(k_j)`` from an OBDM grid.

    For a periodic system the occupation of mode ``k_j = 2 pi j / L``
    is the cosine transform of the (symmetric, ``n1(L - z) = n1(z)``)
    one-body density matrix::

        n(k_j) = (N / L) * int_0^L n1(z) cos(k_j z) dz

    evaluated by the trapezoid rule on the measured ``[0, L/2]`` grid
    (doubled by symmetry).  The occupations satisfy the sum rule
    ``sum_j n(k_j) = N * n1(0) = N`` over all ``L/h`` modes.

    :param offsets: the ``num_pos`` displacement grid over ``[0, L/2]``
        (e.g. ``Sampling.obd_pos_offsets``).
    :param n1: measured ``n1`` means on that grid (``n1[0] == 1``).
    :param supercell_size: the supercell ``L``.
    :param boson_number: particles ``N`` (sets the normalization).
    :param n1_err: optional standard errors of ``n1``; when given the
        result includes propagated errors.
    :return: ``(momenta, occupations)`` or ``(momenta, occupations,
        errors)``; momenta are the non-negative harmonics resolvable by
        the grid spacing.
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    n1 = np.asarray(n1, dtype=np.float64)
    num_pos = offsets.shape[0]
    if num_pos < 2:
        raise ValueError("need at least two displacement grid points")
    sc = float(supercell_size)
    # Number of distinct non-negative harmonics the grid resolves:
    # spacing h = L / (2 (M-1)) -> modes j = 0 .. M-1.
    momenta = np.arange(num_pos) * 2 * np.pi / sc
    # Trapezoid weights on [0, L/2], doubled for the mirror half.
    w = np.full(num_pos, offsets[1] - offsets[0])
    w[0] *= 0.5
    w[-1] *= 0.5
    cos_kz = np.cos(momenta[:, None] * offsets[None, :])  # (J, M)
    # One mirror-half integral; cos(k (L - z)) = cos(k z) for harmonics,
    # so the full-period integral is twice the half integral (endpoint
    # weights already halved).
    occ = (2.0 * boson_number / sc) * (cos_kz * (w * n1)).sum(axis=1)
    if n1_err is None:
        return momenta, occ
    err = (2.0 * boson_number / sc) * np.sqrt(
        ((cos_kz * w) ** 2 * np.asarray(n1_err, dtype=np.float64) ** 2)
        .sum(axis=1))
    return momenta, occ, err


def contact_from_pair_correlation(r: np.ndarray, g2: np.ndarray,
                                  g2_err: np.ndarray, coupling: float,
                                  num_fit_bins: int = 8):
    """``(g2(0), err)``: cusp-constrained ``r -> 0`` extrapolation of a
    binned pair-correlation curve.

    The exact short-distance form for a contact interaction of
    strength ``g`` (units ``hbar^2/2m = 1``) is the Bethe-Peierls cusp
    ``g2(r) = g2(0)(1 + g r) + O(r^2)``, so fit
    ``c (1 + g r) + b r^2`` over the first bins by weighted linear
    least squares in ``(c, b)`` — the known cusp slope removes the
    leading bias a plain bin average or linear fit has on the convex
    rise near contact.  Feeds the Hellmann-Feynman consistency check
    ``dE/dg = N(N-1)/(2L) g2(0)`` (``benchmarks/contact_hf.py``).
    """
    r = np.asarray(r, dtype=np.float64)
    # Stay inside the cusp regime: the linear form only holds while
    # ``coupling * r`` is small, so never fit past ``g r = 1`` (coarse
    # bins would otherwise drag the intercept with long-range shape).
    in_cusp = int(np.count_nonzero(coupling * r <= 1.0))
    k = min(int(num_fit_bins), len(r), max(2, in_cusp))
    if k < 2 or len(r) < 2:
        return float(g2[0]), float(g2_err[0])
    # Degenerate bins (empty histogram bins deep in the correlation
    # hole of a long run) report err = 0 — or NaN through the
    # ratio-of-means propagation — and a raw 1/err weight then makes
    # the weighted design matrix ill-conditioned or non-finite (SVD
    # failure).  Treat non-finite like zero and floor the weights at
    # the smallest healthy error.
    err_k = np.asarray(g2_err[:k], dtype=np.float64)
    healthy = np.isfinite(err_k) & (err_k > 0)
    floor = float(err_k[healthy].min()) if healthy.any() else 1.0
    w = 1.0 / np.where(healthy, err_k, floor)
    design = np.stack([1.0 + coupling * r[:k], r[:k] ** 2], axis=1)
    aw = design * w[:, None]
    yw = g2[:k] * w
    coeffs, *_ = np.linalg.lstsq(aw, yw, rcond=None)
    cov = np.linalg.inv(aw.T @ aw)
    return float(coeffs[0]), float(np.sqrt(cov[0, 0]))


def pair_correlation_from_ssf(momenta: np.ndarray, rho2: np.ndarray,
                              r_grid: np.ndarray, boson_number: int,
                              supercell_size: float,
                              rho2_err: t.Optional[np.ndarray] = None):
    """Pair-correlation function ``g2(r)`` from the measured
    ``<|rho_k|^2>`` S(k) part — a new observable at zero runtime cost.

    For the periodic supercell the distinct-pair distance density

        G(r) = (1/N) sum_{i != j} <delta_L(z_i - z_j - r)>

    (per particle; integrates to ``N - 1`` over the period) relates to
    the Fourier modes ``rho_k = sum_i exp(i k z_i)`` at
    ``k_j = 2 pi j / L`` by ``<|rho_k|^2>/N = 1 + (1/L-normalized)
    Fourier coefficient of G``, so the truncated inversion over the
    measured modes (G is even, cosine series) is::

        G_M(r) = (1/L) [t_0 + 2 sum_{j>=1} t_j cos(k_j r)],
        t_j = <|rho_{k_j}|^2>/N - 1

    normalized here to ``g2 = L G / (N - 1)`` (``g2 == 1`` for
    uncorrelated particles).  Truncation to M modes smooths features
    sharper than ``L/M`` (Gibbs ringing near the contact point if M is
    small); modes beyond the correlation support contribute nothing,
    e.g. the free-fermion/Tonks-Girardeau S(k) is exactly 1 past
    ``2 k_F`` and the inversion is then exact (tested against the
    finite-N Dirichlet-kernel formula in ``tests/test_analysis.py``).

    Use ``SSFBlocks.fdk_sqr_abs_part.mean`` (NOT ``SSFBlocks.mean``,
    which subtracts the static/Bragg part) as ``rho2``.

    :param momenta: the measured mode grid ``arange(M) * 2 pi / L``
        (``Sampling.ssf_momenta``); must start at ``k = 0``.
    :param rho2: per-walker ``<|rho_k|^2>`` means on that grid.
    :param r_grid: distances at which to evaluate ``g2``.
    :param rho2_err: optional standard errors; propagated when given.
    :return: ``g2`` on ``r_grid`` (and errors when ``rho2_err``).
    """
    momenta = np.asarray(momenta, dtype=np.float64)
    rho2 = np.asarray(rho2, dtype=np.float64)
    r_grid = np.asarray(r_grid, dtype=np.float64)
    nop = int(boson_number)
    if nop < 2:
        raise ValueError("pair correlations need at least two particles")
    if abs(momenta[0]) > 1e-12:
        raise ValueError("mode grid must start at k = 0")
    terms = rho2 / nop - 1.0
    cos_kr = np.cos(momenta[1:, None] * r_grid[None, :])  # (M-1, R)
    g2 = (terms[0] + 2.0 * (terms[1:, None] * cos_kr).sum(axis=0)) \
        / (nop - 1)
    if rho2_err is None:
        return g2
    err = np.asarray(rho2_err, dtype=np.float64) / nop
    # Exactly-constant modes (the deterministic k=0, where
    # |rho_0|^2 == N^2 every sample) have zero variance; blocking
    # analyses report them as NaN, which must not poison the sum.
    err = np.where(np.isfinite(err), err, 0.0)
    g2_err = np.sqrt(err[0] ** 2
                     + 4.0 * ((err[1:, None] * cos_kr) ** 2).sum(axis=0)) \
        / (nop - 1)
    return g2, g2_err


def density_from_ssf(momenta: np.ndarray, rho_re: np.ndarray,
                     rho_im: np.ndarray, z_grid: np.ndarray,
                     supercell_size: float,
                     boson_number: int,
                     re_err: t.Optional[np.ndarray] = None,
                     im_err: t.Optional[np.ndarray] = None):
    """Density profile ``n(z)`` from the measured ``<Re rho_k>`` /
    ``<Im rho_k>`` S(k) parts — a second zero-runtime-cost observable
    from data the S(k) estimator already stores (companion of
    :func:`pair_correlation_from_ssf`).

    With ``rho_k = sum_i exp(i k z_i)`` at ``k_j = 2 pi j / L``, the
    density is the (band-limited) Fourier synthesis::

        n_M(z) = (1/L) [N + 2 sum_{j>=1} (<Re rho_kj> cos(k_j z)
                                          + <Im rho_kj> sin(k_j z))]

    normalized so ``integral n = N``.  Truncation to M modes smooths
    features sharper than ``L/M`` — for lattice gases the profile is
    essentially band-limited to a few harmonics of the lattice
    wavevector, so modest M already reproduces the binned histogram
    estimator (tested against it in ``tests/test_analysis.py``); as a
    kernel (rather than binned) estimator it has no bin-discretization
    bias.

    :param momenta: the measured mode grid ``arange(M) * 2 pi / L``
        (must start at ``k = 0``).
    :param rho_re: per-walker ``<Re rho_k>`` means on that grid
        (``SSFBlocks.fdk_real_part.mean``).
    :param rho_im: per-walker ``<Im rho_k>`` means
        (``SSFBlocks.fdk_imag_part.mean``).
    :param z_grid: positions at which to evaluate ``n``.
    :return: ``n`` on ``z_grid`` (and errors when ``re_err``/``im_err``
        are given).
    """
    momenta = np.asarray(momenta, dtype=np.float64)
    rho_re = np.asarray(rho_re, dtype=np.float64)
    rho_im = np.asarray(rho_im, dtype=np.float64)
    z_grid = np.asarray(z_grid, dtype=np.float64)
    if abs(momenta[0]) > 1e-12:
        raise ValueError("mode grid must start at k = 0")
    cos_kz = np.cos(momenta[1:, None] * z_grid[None, :])  # (M-1, Z)
    sin_kz = np.sin(momenta[1:, None] * z_grid[None, :])
    n = (boson_number
         + 2.0 * (rho_re[1:, None] * cos_kz
                  + rho_im[1:, None] * sin_kz).sum(axis=0)) \
        / supercell_size
    if re_err is None and im_err is None:
        return n
    re_e = np.zeros_like(rho_re) if re_err is None \
        else np.asarray(re_err, dtype=np.float64)
    im_e = np.zeros_like(rho_im) if im_err is None \
        else np.asarray(im_err, dtype=np.float64)
    re_e = np.where(np.isfinite(re_e), re_e, 0.0)
    im_e = np.where(np.isfinite(im_e), im_e, 0.0)
    n_err = 2.0 * np.sqrt(((re_e[1:, None] * cos_kz) ** 2
                           + (im_e[1:, None] * sin_kz) ** 2)
                          .sum(axis=0)) / supercell_size
    return n, n_err


def effective_mass_from_cm_diffusion(time_step: float,
                                     iter_cmd: np.ndarray,
                                     iter_num_walkers: np.ndarray,
                                     boson_number: int,
                                     fit_fraction: float = 0.5):
    """Superfluid fraction / inverse effective mass ``m/m*`` from the
    center-of-mass imaginary-time diffusion.

    The ground-state-transformed DMC dynamics is a Fokker-Planck
    process whose Bloch spectrum equals ``E(k) - E0`` of the
    Hamiltonian, so the long-tau diffusion constant of the total
    (center-of-mass) coordinate gives the curvature of the many-body
    band: ``m/m* = N * d<W_cm^2>/dtau / 2`` (``= 1`` for ANY
    interaction without a lattice, by Galilean invariance; equal to
    the single-particle band-curvature ratio
    :func:`phd_qmclib_torch.ideal.effective_mass_ratio` for the ideal
    lattice gas).  The ancestry transport of the accumulated
    displacement makes the long-window average a forward-walked
    estimate; with an approximate trial wavefunction a residual mixed
    bias of the usual kind remains.

    :param time_step: the DMC imaginary time step.
    :param iter_cmd: ``(nts, 2)`` or ``(B, nts, 2)`` per-step
        ``[sum W^2, sum W]`` accumulators
        (``SamplingBlock.iter_cmd``); blocks are averaged.
    :param iter_num_walkers: matching ``(nts,)`` / ``(B, nts)`` walker
        counts (``iter_props.num_walkers``).
    :param fit_fraction: fit the slope over the LAST fraction of the
        window (the early window carries the transient of the
        non-diffusive modes).
    :return: ``(ratio, ratio_err)`` — slope-fit value and, with two or
        more window blocks, a delete-one-window jackknife error
        (between-window scatter dominates the in-curve fit residuals;
        cf. ``CMDiffusionBlocks.effective_mass_ratio``).  Single-window
        inputs fall back to the fit-residual error.
    """
    cmd = np.asarray(iter_cmd, dtype=np.float64)
    nw = np.asarray(iter_num_walkers, dtype=np.float64)
    if cmd.ndim == 2:
        cmd = cmd[None]
        nw = nw[None]
    w2_rows = cmd[..., 0] / nw               # (B, nts)
    w2 = w2_rows.mean(axis=0)                # <W_cm^2>(tau)
    nts = w2.shape[0]
    tau = (np.arange(nts) + 1.0) * float(time_step)
    start = int(round((1.0 - fit_fraction) * nts))
    t_fit = tau[start:]

    def _slope(y):
        return np.polyfit(t_fit, y[start:], 1)[0]

    slope = _slope(w2)
    ratio = 0.5 * boson_number * slope
    n_b = w2_rows.shape[0]
    if n_b >= 2:
        loo = np.array([_slope(np.delete(w2_rows, i, axis=0)
                               .mean(axis=0)) for i in range(n_b)])
        err = np.sqrt((n_b - 1) / n_b * ((loo - loo.mean()) ** 2).sum())
        return ratio, 0.5 * boson_number * float(err)
    _, cov = np.polyfit(t_fit, w2[start:], 1, cov=True)
    return ratio, 0.5 * boson_number * float(np.sqrt(cov[0, 0]))


def luttinger_parameter_from_obdm(offsets: np.ndarray, n1: np.ndarray,
                                  supercell_size: float,
                                  n1_err: t.Optional[np.ndarray] = None,
                                  fit_min_frac: float = 0.2,
                                  lattice_period: t.Optional[float]
                                  = None,
                                  period_tol: float = 0.05):
    """``(K, K_err)`` — the Luttinger parameter from the OBDM tail.

    A 1D quantum liquid has no true condensate: the one-body density
    matrix decays algebraically, ``n1(r) ~ d(r)^(-1/(2K))`` with the
    periodic chord distance ``d(r) = (L/pi) sin(pi r / L)`` (the
    standard finite-size conformal substitution), where ``K`` is the
    Luttinger parameter (K = 1 in the Tonks-Girardeau limit, K -> inf
    for free bosons).  Weighted log-log fit over
    ``r >= fit_min_frac * L/2`` (the short-distance region is not
    asymptotic).

    Hydrodynamic counterpart for the same run: ``K = v_J / c`` with
    the current stiffness ``v_J = 2 pi n f_s`` in this codebase's
    units (``hbar = 1, m = 1/2``; ``f_s = m/m*`` from the CM-diffusion
    estimator) and the sound speed ``c`` from the Feynman S(k) slope —
    Luttinger-liquid universality ties three independent estimator
    chains together.  No reference analog.

    Accuracy caveat (measured): the OBDM is off-diagonal, so even the
    forward-walking estimator retains a trial-wavefunction remnant
    that FLATTENS the tail (overestimating K) — a near-TG run of the
    JAX package (gamma = 32) fit K = 1.32(1) against the exact 1
    (finite-gamma ~1.13), and subleading ``cos(2 pi n r) d^{-K/2-1/(2K)}``
    oscillations bias a pure power fit further.  Treat the OBDM-tail K
    as an upper-bound diagnostic; for quantitative K prefer the
    hydrodynamic route, or extrapolate the OBDM first
    (``2 <mixed> - <VMC>``, :func:`extrapolated_estimate`).
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    n1 = np.asarray(n1, dtype=np.float64)
    half = 0.5 * supercell_size
    mask = (offsets >= fit_min_frac * half) & (n1 > 0) \
        & (offsets > 0) & (offsets <= half)
    if lattice_period:
        # On a lattice n1(sz) carries the Bloch intra-cell modulation
        # on top of the Luttinger envelope; fit only the displacements
        # that are (near-)integer lattice periods, where the intra-cell
        # factor is constant.
        frac = np.mod(offsets / lattice_period, 1.0)
        frac = np.minimum(frac, 1.0 - frac)
        mask &= frac <= period_tol
    if mask.sum() < 3:
        raise ValueError("need at least 3 OBDM points in the fit range")
    chord = (supercell_size / np.pi) * np.sin(
        np.pi * offsets[mask] / supercell_size)
    x = np.log(chord)
    y = np.log(n1[mask])
    if n1_err is not None:
        rel = np.asarray(n1_err, dtype=np.float64)[mask] / n1[mask]
        healthy = np.isfinite(rel) & (rel > 0)
        floor = float(rel[healthy].min()) if healthy.any() else 1.0
        w = 1.0 / np.where(healthy, rel, floor)
        coeffs, cov = np.polyfit(x, y, 1, w=w, cov="unscaled")
    else:
        coeffs, cov = np.polyfit(x, y, 1, cov=True)
    slope, slope_err = coeffs[0], float(np.sqrt(cov[0, 0]))
    # n1 ~ d^(-1/(2K))  =>  K = -1/(2 slope).
    if slope >= 0:
        return float("inf"), float("inf")
    k_val = -1.0 / (2.0 * slope)
    return float(k_val), float(abs(k_val / slope) * slope_err)


def extrapolated_estimate(mixed: np.ndarray, variational: np.ndarray,
                          mixed_err: t.Optional[np.ndarray] = None,
                          variational_err: t.Optional[np.ndarray] = None):
    """Second-order extrapolated estimator ``2 <mixed> - <vmc>``.

    The standard correction for off-diagonal observables (like the
    OBDM) whose DMC mixed estimator retains a first-order trial-
    wavefunction bias: combining with the variational estimate cancels
    the ``O(phi - psi_T)`` term.
    """
    est = 2.0 * np.asarray(mixed) - np.asarray(variational)
    if mixed_err is None and variational_err is None:
        return est
    me = np.zeros_like(est) if mixed_err is None \
        else np.asarray(mixed_err)
    ve = np.zeros_like(est) if variational_err is None \
        else np.asarray(variational_err)
    return est, np.sqrt(4.0 * me ** 2 + ve ** 2)


def zero_limit_extrapolation(x: np.ndarray, y: np.ndarray,
                             y_err: t.Optional[np.ndarray] = None,
                             order: int = 1):
    """Weighted polynomial extrapolation of a systematic-bias series to
    its ``x -> 0`` limit.

    The two standard DMC convergence workflows share this shape:

    * **time-step bias**: ``x = dt``, ``y = E(dt)`` from a dt sweep
      (e.g. ``benchmarks/dt_sweep.py`` / a fused ``ParamSweep``) — the
      drift-diffusion Trotter error is linear-plus-higher-order in dt;
    * **population-control bias**: ``x = 1 / N_w``, ``y = E(N_w)`` — the
      E_ref feedback bias is O(1/N_w) (reference controller:
      ``qmc_base/dmc.py:769-771``).

    Uses a weighted least-squares polynomial of degree ``order`` with
    ``1/y_err`` weights and the *unscaled* parameter covariance (errors
    taken from the supplied measurement errors, not the residuals — the
    right convention when each point carries its own reblocked error
    bar).

    :return: ``(limit, limit_err, coeffs)`` — the extrapolated
        ``y(x=0)``, its standard error, and the full coefficient vector
        (highest degree first, ``coeffs[-1] == limit``).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape or x.ndim != 1:
        raise ValueError("x and y must be equal-length 1-D arrays")
    if len(x) < order + 1:
        raise ValueError(f"need at least {order + 1} points for a "
                         f"degree-{order} fit, got {len(x)}")
    if y_err is not None:
        w = 1.0 / np.maximum(np.asarray(y_err, dtype=np.float64), 1e-300)
    else:
        w = None
    if len(x) == order + 1:
        # Exact interpolation: polyfit cannot form a covariance.
        coeffs = np.polyfit(x, y, order, w=w)
        err = float("nan") if y_err is None else _interp_limit_err(
            x, np.asarray(y_err, dtype=np.float64), order)
        return float(coeffs[-1]), err, coeffs
    coeffs, cov = np.polyfit(x, y, order, w=w, cov="unscaled")
    return (float(coeffs[-1]), float(np.sqrt(cov[-1, -1])), coeffs)


def _interp_limit_err(x, y_err, order):
    """Error of the x=0 value of the exact degree-n interpolation:
    linear propagation through the Lagrange basis at 0."""
    basis = []
    for i in range(len(x)):
        others = np.delete(x, i)
        basis.append(np.prod(-others) / np.prod(x[i] - others))
    return float(np.sqrt((np.asarray(basis) ** 2 * y_err ** 2).sum()))


def feynman_spectrum(momenta: np.ndarray, ssf: np.ndarray,
                     ssf_err: t.Optional[np.ndarray] = None):
    """Feynman (single-mode) excitation spectrum from S(k).

    ``omega(k) <= hbar^2 k^2 / (2 m S(k))`` is the Bijl-Feynman upper
    bound on the lowest excitation energy at momentum ``k``; in this
    package's units (``hbar^2 / 2m = 1``, see ``constants`` —
    ``ER = pi^2`` is the recoil at ``k = K_OPT = pi``) it reads
    ``omega(k) = k^2 / S(k)`` with ``S`` the PER-PARTICLE structure
    factor (``SSFBlocks.mean / N``).  The bound is saturated as
    ``k -> 0`` (phonons exhaust the f-sum rule), so
    ``omega(k)/k -> c`` gives the sound speed; exactly linear for the
    Tonks-Girardeau gas (``S = k/2k_F`` below ``2 k_F`` gives
    ``omega = 2 k_F k``, the exact TG phonon slope) and exactly
    Bogoliubov when ``S`` is the Bogoliubov structure factor.

    Zero-cost observable: computed from the stored S(k) blocks of any
    run.  The ``k = 0`` mode (``S(0) = 0``) is excluded.

    :param momenta: ``(M,)`` mode momenta (``SSFBlocks`` stores
        ``k_j = 2 pi j / L``).
    :param ssf: per-particle ``S(k)`` on those modes.
    :param ssf_err: optional standard errors of ``ssf``.
    :return: ``(momenta[1:], omega, omega_err?)`` — errors included
        when ``ssf_err`` is given.
    """
    momenta = np.asarray(momenta, dtype=np.float64)
    ssf = np.asarray(ssf, dtype=np.float64)
    k = momenta[1:]
    s = ssf[1:]
    omega = k ** 2 / s
    if ssf_err is None:
        return k, omega
    err = omega * np.asarray(ssf_err, dtype=np.float64)[1:] / s
    return k, omega, err


def sound_speed_from_ssf(momenta: np.ndarray, ssf: np.ndarray,
                         ssf_err: t.Optional[np.ndarray] = None,
                         num_modes: int = 3):
    """Sound speed ``c = lim_{k->0} omega_F(k)/k`` from the first
    ``num_modes`` nonzero modes of the Feynman spectrum, extrapolated
    to ``k = 0`` in ``k^2`` with :func:`zero_limit_extrapolation` —
    the phonon branch's leading finite-``k`` correction is quadratic
    (Bogoliubov: ``omega/k = sqrt(c^2 + k^2)`` is exactly linear in
    ``k^2`` to ``O(k^4)``; TG: ``omega/k`` constant), so the ``k^2``
    fit removes the dominant curvature bias a fit in ``k`` leaves.

    :return: ``(c, c_err)``; ``c_err`` is NaN without ``ssf_err``.
    """
    out = feynman_spectrum(momenta, ssf, ssf_err)
    k, omega = out[0][:num_modes], out[1][:num_modes]
    phase_vel = omega / k
    vel_err = out[2][:num_modes] / k if ssf_err is not None else None
    c, c_err, _ = zero_limit_extrapolation(k ** 2, phase_vel, vel_err)
    return c, c_err


def leggett_bound(density: np.ndarray,
                  density_err: t.Optional[np.ndarray] = None):
    """Leggett's upper bound on the superfluid fraction from the
    density profile.

    For a 1D system with ground-state density ``rho(x)``,

        f_s  <=  [ <rho> * <1/rho> ]^{-1}

    with ``< >`` the spatial average (Leggett 1970; the harmonic-to-
    arithmetic mean ratio of the density).  The bound is 1 exactly for
    a homogeneous profile and decreases as density modulation deepens;
    for a profile with an empty bin it is 0 (a strict barrier blocks
    superflow in 1D).  It is scale-invariant, so raw per-bin histogram
    counts (``DensityBlocks.mean``) work directly — no normalization
    needed.

    Complements :func:`effective_mass_from_cm_diffusion`: the measured
    ``m/m*`` must satisfy ``m/m* <= f_Leggett`` when both come from
    the same ground state, giving an internal consistency check
    between two independent observables (dynamic CM diffusion vs the
    static profile).  No reference analog (the reference has neither
    observable).

    :param density: ``(num_bins,)`` density profile (any overall
        scale; all entries must be ``>= 0``).
    :param density_err: optional matching standard errors; propagated
        linearly.
    :return: ``(bound, bound_err)``; ``bound_err`` is NaN without
        ``density_err``.
    """
    rho = np.asarray(density, dtype=np.float64)
    if rho.ndim != 1:
        raise ValueError("density must be one-dimensional")
    if (rho < 0).any():
        raise ValueError("density must be non-negative")
    if (rho == 0).any():
        return 0.0, 0.0 if density_err is not None else np.nan
    a = rho.mean()
    h = (1.0 / rho).mean()
    bound = 1.0 / (a * h)
    if density_err is None:
        return float(bound), np.nan
    err = np.asarray(density_err, dtype=np.float64)
    nb = rho.size
    # d bound / d rho_b = bound * (1 / (nb * rho_b^2 * h) - 1 / (nb * a))
    grad = bound * (1.0 / (nb * rho ** 2 * h) - 1.0 / (nb * a))
    return float(bound), float(np.sqrt(((grad * err) ** 2).sum()))


def spectral_function_from_itc(tau: np.ndarray, f: np.ndarray,
                               f_err: t.Optional[np.ndarray] = None,
                               omega_max: t.Optional[float] = None,
                               num_omega: int = 64,
                               reg: t.Optional[float] = None):
    """Density-channel spectral function ``S(k, omega)`` for ONE mode
    from its imaginary-time correlation ``F(k, tau)``.

    At ``T = 0`` the intermediate scattering function is the Laplace
    transform of the (non-negative) dynamic structure factor::

        F(k, tau) = int_0^inf domega S(k, omega) e^{-omega tau}

    Inverting this is the classic ill-posed analytic-continuation
    problem; this helper solves the regularized non-negative
    least-squares version — Tikhonov curvature smoothing with the
    regularization weight chosen by the discrepancy principle
    (``chi^2(lambda) = n_data``, bisected in ``log lambda``) so the
    returned spectrum is the SMOOTHEST non-negative one consistent
    with the data at one sigma.  Exact sharp features are therefore
    broadened by construction (resolution ~ 1/tau_max); the integrated
    moments are the trustworthy outputs:

    * ``m0 = int S domega = F(k, 0) = S(k)`` (static structure factor),
    * ``m1 = int omega S domega = k^2`` (f-sum rule, units
      ``hbar^2/2m = 1`` as in :func:`feynman_spectrum`) — an
      *independent check* the inversion does not enforce,
    * ``m1/m0`` (mean excitation = Feynman ratio) and the peak
      position (dominant excitation branch).

    No reference analog (the reference has no two-time observables).

    :param tau: ``(L+1,)`` imaginary-time lags (``ITCBlocks.tau_grid``).
    :param f: ``(L+1,)`` per-particle ``F(k, tau)`` for one mode.
    :param f_err: optional matching standard errors; used as the
        chi^2 weights.  Without them a uniform ``1e-3 * F(k, 0)``
        noise scale is assumed.
    :param omega_max: spectral support cutoff; default ``8x`` the
        first-lag log-derivative (the mean excitation energy), a safe
        multiple of where the weight can sit.
    :param num_omega: grid resolution.
    :param reg: fix the regularization weight instead of the
        discrepancy search (used by jackknife resamples so all
        resamples share the full-data smoothing).
    :return: ``(omega, s_omega, info)`` — the grid, the spectral
        density on it (``trapezoid(s_omega, omega) ~ m0``), and a dict
        with ``lambda``, ``chi2``, ``m0``, ``m1``, ``omega_mean``,
        ``omega_peak`` plus the self-calibrated resolution
        systematics ``omega_mean_sys``/``omega_peak_sys``/``m1_sys``
        (the moment shift a sharp single pole at the recovered mean
        frequency suffers through the same inversion operator — the
        finite-``tau_max`` smoothing bias the jackknife cannot see).
    """
    from scipy.optimize import nnls

    tau = np.asarray(tau, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    good = np.isfinite(f)
    if good.sum() < 3:
        raise ValueError("need at least three finite F(tau) points to "
                         "attempt an inversion")
    tau, f = tau[good], f[good]
    if f[0] <= 0:
        raise ValueError("F(k, 0) = S(k) must be positive")
    sigma = None if f_err is None else \
        np.asarray(f_err, dtype=np.float64)[good]
    if sigma is None or not np.isfinite(sigma).all() or \
            (sigma <= 0).any():
        sigma = np.full_like(f, 1e-3 * f[0])
    if omega_max is None:
        dtau = tau[1] - tau[0]
        ratio = f[1] / f[0]
        if not 0 < ratio < 1:
            raise ValueError("F must decay over the first lag to set "
                             "an automatic omega_max; pass one")
        omega_max = -8.0 * np.log(ratio) / dtau
    omega = np.linspace(0.0, float(omega_max), num_omega)
    d_omega = omega[1] - omega[0]
    w = np.full(num_omega, d_omega)
    w[0] = w[-1] = 0.5 * d_omega                    # trapezoid
    kernel = np.exp(-np.outer(tau, omega)) * w      # (L+1, num_omega)

    # Curvature penalty rows, scaled so lambda is dimensionless.
    d2 = (np.eye(num_omega, k=0)[:-2] - 2 * np.eye(num_omega, k=1)[:-2]
          + np.eye(num_omega, k=2)[:-2])
    kw = kernel / sigma[:, None]
    scale = np.linalg.norm(kw) / max(np.linalg.norm(d2), 1e-30)

    def _solve(lam, target=None):
        b = f if target is None else target
        a_aug = np.vstack([kw, np.sqrt(lam) * scale * d2])
        b_aug = np.concatenate([b / sigma, np.zeros(d2.shape[0])])
        sol = nnls(a_aug, b_aug)[0]
        chi2 = float((((kernel @ sol) - b) / sigma) ** 2 @
                     np.ones_like(b))
        return sol, chi2

    if reg is not None:
        lam = float(reg)
        sol, chi2 = _solve(lam)
    else:
        n_data = f.size
        lo, hi = -8.0, 6.0
        sol_lo, chi_lo = _solve(10.0 ** lo)
        sol_hi, chi_hi = _solve(10.0 ** hi)
        if chi_lo >= n_data:        # even unregularized cannot reach
            lam, sol, chi2 = 10.0 ** lo, sol_lo, chi_lo
        elif chi_hi <= n_data:      # smoothest still fits
            lam, sol, chi2 = 10.0 ** hi, sol_hi, chi_hi
        else:
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                sol, chi2 = _solve(10.0 ** mid)
                if chi2 > n_data:
                    hi = mid
                else:
                    lo = mid
            lam = 10.0 ** (0.5 * (lo + hi))
            sol, chi2 = _solve(lam)

    m0 = float(np.trapezoid(sol, omega))
    m1 = float(np.trapezoid(omega * sol, omega))
    info = {"lambda": lam, "chi2": chi2, "m0": m0, "m1": m1,
            "omega_mean": m1 / m0 if m0 > 0 else np.nan,
            "omega_peak": float(omega[np.argmax(sol)])}
    # Resolution systematic, self-calibrated: push the EXACT Laplace
    # image of a sharp single pole at the recovered mean frequency
    # through the SAME inversion operator (grid, sigma weights,
    # regularization); the recovered-minus-true moment shift measures
    # the smoothing bias at this (tau_max, noise) — the dominant
    # systematic of the method, which the TG exact-F control isolated
    # at ~10% of omega_mean for omega_1 tau_max ~ 0.6 (BASELINE.md)
    # while jackknife errors see none of it.  The true spectrum is at
    # least as sharp as the data can resolve, so the sharp-pole
    # control bounds the broadening effect; it goes to zero as
    # tau_max deepens (gated in tests/test_analysis_spectral.py).
    info["omega_mean_sys"] = np.nan
    info["omega_peak_sys"] = np.nan
    info["m1_sys"] = np.nan
    w_ref = info["omega_mean"]
    if np.isfinite(w_ref) and w_ref > 0 and m0 > 0:
        f_ctrl = m0 * np.exp(-w_ref * tau)
        sol_c, _ = _solve(lam, target=f_ctrl)
        m0_c = float(np.trapezoid(sol_c, omega))
        m1_c = float(np.trapezoid(omega * sol_c, omega))
        if m0_c > 0:
            info["omega_mean_sys"] = m1_c / m0_c - w_ref
            info["omega_peak_sys"] = \
                float(omega[np.argmax(sol_c)]) - w_ref
            info["m1_sys"] = m1_c - m0_c * w_ref
    return omega, sol, info
