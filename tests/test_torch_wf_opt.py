"""The wavefunction optimizer (``phd_qmclib_torch.wf_opt``), its parameter
solves (``models/mrbp.py``: ``tbf_params_device``, ``obf_params_device``,
``cfc_params_device``) and the differentiable log|psi| and energy
(``ops/pairwise.py``: ``LogPsiAndEnergy``, the parameter VJP) on the CPU,
in float64, against the JAX package on the same configurations: the JAX
optimizer tests' set (N=5, 256 configurations from ``default_rng(7)``).

Tolerances: the solves' values 1e-12 and their derivatives 1e-8 (the
same bisection in two libraries; the implicit derivative divides two
autodiff partials); variances, gradients and grid values 1e-10 (sums of
256 weighted terms whose log-weights differ by a few ulps); the optima
1e-6 (scipy's paths, identical up to those ulps).

The CUDA kernel behind the VJP is held against its plain version on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` W0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch import wf_opt as twf
from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.ops import pairwise as tpairwise
from phd_qmclib_tpu import wf_opt as jwf
from phd_qmclib_tpu.models import mrbp as jmrbp

torch.set_num_threads(1)

SPEC = dict(lattice_depth=10.0, lattice_ratio=1.0, interaction_strength=2.0,
            boson_number=5, supercell_size=5.0, tbf_contact_cutoff=0.1)
SOLVE_RTOL, SOLVE_GRAD_RTOL = 1e-12, 1e-8
VARIANCE_RTOL = 1e-10
OPTIMUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    """Both packages' specs, the configurations and their log|psi|
    (the JAX package's, as its optimizer tests make them)."""
    jspec, tspec = jmrbp.Spec(**SPEC), tmrbp.Spec(**SPEC)
    rng = np.random.default_rng(7)
    pos = np.stack([jspec.init_get_sys_conf(rng=rng)
                    for _ in range(256)])[:, jmrbp.SysConfSlot.pos, :]
    cfc = jax.tree.map(jnp.float64, jspec.cfc_params)
    lp = np.asarray(jmrbp.core_funcs(jspec).log_psi(jnp.asarray(pos), cfc))
    return jspec, tspec, pos, lp


@pytest.fixture(scope="module")
def optimizers(setup):
    """(JAX, port) pairs of the 1-D and the joint gradient optimizers."""
    jspec, tspec, pos, lp = setup
    return {joint: (jwf.GradCSWFOptimizer(jspec, pos, lp,
                                          opt_obf_lattice_depth=joint),
                    twf.GradCSWFOptimizer(tspec, pos, lp,
                                          opt_obf_lattice_depth=joint,
                                          device="cpu"))
            for joint in (False, True)}


def _tensor(x):
    return torch.tensor(x, dtype=torch.float64)


# -- the parameter solves ----------------------------------------------------------

TBF_FIELDS = ("param_k2", "param_beta", "param_r_off", "param_am")
OBF_FIELDS = ("param_e0", "param_k1", "param_kp1")


def _jax_values_and_derivatives(fields, xs, *args):
    """``fields(x, *args)`` (a stacked vector) and its derivative in x at
    every x of ``xs``, in one jitted, vmapped forward-mode call."""
    def one(x, *a):
        return jax.jvp(lambda y: fields(y, *a), (x,), (jnp.ones_like(x),))

    values, derivs = jax.jit(jax.vmap(one, in_axes=(0,) + (None,) * len(
        args)))(jnp.asarray(xs, jnp.float64), *args)
    return np.asarray(values), np.asarray(derivs)


def _check_solve(got_fields, x, want, want_deriv, rows):
    """Each field's values and d/dx (elementwise, hence the sums' grads)
    against JAX's, and the batch against the row-by-row solves."""
    for n, got in enumerate(got_fields):
        grad, = torch.autograd.grad(got.sum(), x, retain_graph=True)
        np.testing.assert_allclose(got.detach().numpy(), want[:, n],
                                   rtol=SOLVE_RTOL)
        np.testing.assert_allclose(grad.numpy(), want_deriv[:, n],
                                   rtol=SOLVE_GRAD_RTOL)
        np.testing.assert_allclose([float(row[n]) for row in rows],
                                   got.detach().numpy(), rtol=SOLVE_RTOL)


@pytest.mark.parametrize("gn,nop", [(0.1, 16), (2.0, 5), (50.0, 16)])
def test_tbf_params_device_matches_jax(gn, nop):
    """Values and d/drm of every derived field, batched over rm; the
    batch equals the row-by-row solves."""
    rms = [0.05, 0.2, 0.45, 2.0, 0.45 * nop]

    def fields(rm, gn_):
        tbf = jmrbp.tbf_params_device(rm, gn_, nop, float(nop))
        return jnp.stack([getattr(tbf, name) for name in TBF_FIELDS])

    want, want_deriv = _jax_values_and_derivatives(fields, rms,
                                                   jnp.float64(gn))
    rm = _tensor(rms).requires_grad_()
    tbf = tmrbp.tbf_params_device(rm, gn, nop, float(nop))
    rows = [tmrbp.tbf_params_device(_tensor(x), gn, nop, float(nop))
            for x in rms]
    _check_solve([getattr(tbf, name) for name in TBF_FIELDS], rm, want,
                 want_deriv, [[getattr(r, name) for name in TBF_FIELDS]
                              for r in rows])


def test_obf_params_device_matches_jax(setup):
    jspec, tspec, _, _ = setup
    depths = [1.0, 5.0, 20.0, 60.0]

    def fields(v0):
        obf = jmrbp.obf_params_device(v0, jspec)
        return jnp.stack([getattr(obf, name) for name in OBF_FIELDS])

    want, want_deriv = _jax_values_and_derivatives(fields, depths)
    v0 = _tensor(depths).requires_grad_()
    obf = tmrbp.obf_params_device(v0, tspec)
    rows = [tmrbp.obf_params_device(_tensor(x), tspec) for x in depths]
    _check_solve([getattr(obf, name) for name in OBF_FIELDS], v0, want,
                 want_deriv, [[getattr(r, name) for name in OBF_FIELDS]
                              for r in rows])


def test_cfc_params_device_matches_jax(setup):
    """Every leaf and its derivatives in (rm, orbital v0): both solves."""
    jspec, tspec, _, _ = setup
    x0 = [0.31, 8.0]

    def leaves_jax(x):
        cfc = jmrbp.cfc_params_device(x[0], jspec, obf_lattice_depth=x[1])
        return jnp.stack([jnp.asarray(v, jnp.float64)
                          for v in jax.tree.leaves(cfc)])

    def leaves_torch(x):
        cfc = tmrbp.cfc_params_device(x[0], tspec, obf_lattice_depth=x[1])
        return torch.stack([v for group in cfc for v in group])

    x = _tensor(x0)
    np.testing.assert_allclose(leaves_torch(x).numpy(),
                               np.asarray(leaves_jax(jnp.asarray(x0))),
                               rtol=SOLVE_RTOL)
    jac = torch.autograd.functional.jacobian(leaves_torch, x)
    want = np.asarray(jax.jit(jax.jacfwd(leaves_jax))(jnp.asarray(x0)))
    np.testing.assert_allclose(jac.numpy(), want, rtol=SOLVE_GRAD_RTOL,
                               atol=1e-14)
    # The 1-D form takes the host spec's orbital.
    cfc = tmrbp.cfc_params_device(x[0], tspec)
    assert [float(v) for v in cfc.obf_params] == list(tspec.obf_params)


def test_pack_params_batches_and_keeps_free_gradients_finite(setup):
    _, tspec, _, _ = setup
    rms = _tensor([0.2, 0.31, 1.7])
    batched = tpairwise.pack_params(tmrbp.cfc_params_device(rms, tspec),
                                    torch.float64, "cpu")
    assert batched.shape == (3, tpairwise.PARAMS_SIZE)
    for k in range(3):
        row = tpairwise.pack_params(
            tmrbp.cfc_params_device(rms[k], tspec), torch.float64, "cpu")
        torch.testing.assert_close(batched[k], row, rtol=SOLVE_RTOL, atol=0)
        # The host spec's packing at the same rm.
        host = tpairwise.pack_params(
            tspec.evolve(tbf_contact_cutoff=float(rms[k])).cfc_params,
            torch.float64, "cpu")
        torch.testing.assert_close(row, host, rtol=1e-9, atol=1e-12)
    free = tmrbp.Spec(**dict(SPEC, lattice_depth=0.0))
    leaves = [torch.tensor(float(x), dtype=torch.float64,
                           requires_grad=True) for x in free.obf_params]
    cfc = free.cfc_params._replace(obf_params=tmrbp.OBFParams(*leaves))
    packed = tpairwise.pack_params(cfc, torch.float64, "cpu")
    assert float(packed[tpairwise.P_CF].detach()) == 0.0
    grads = torch.autograd.grad(packed.sum(), leaves, allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)


# -- the differentiable log|psi| and energy -------------------------------------------

def test_log_psi_and_energy_function_on_the_cpu(setup):
    """``LogPsiAndEnergy`` on a CPU tensor (plain forward, plain VJP) by
    ``gradcheck``, and the plain VJP equal to autograd through
    ``core_funcs.log_psi_and_energy``, which keeps the plain version on
    the CPU."""
    _, tspec, pos, _ = setup
    static = tspec.static_spec
    kw = dict(nop=static.boson_number, is_free=static.is_free,
              is_ideal=static.is_ideal, defects_sep=static.defects_sep)
    pos_t = torch.as_tensor(pos[:6])
    params = tpairwise.pack_params(tspec.cfc_params, torch.float64, "cpu")
    params.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda p: tpairwise.LogPsiAndEnergy.apply(pos_t, p, kw), (params,))
    rng = np.random.default_rng(3)
    g_lp, g_e = (torch.as_tensor(rng.standard_normal(6)) for _ in range(2))
    lp, energy = tmrbp.core_funcs(tspec).log_psi_and_energy(pos_t, None,
                                                            params)
    want, = torch.autograd.grad((lp * g_lp).sum() + (energy * g_e).sum(),
                                params)
    got = tpairwise.energy_and_drift_params_vjp(
        pos_t, params.detach(), None, g_lp, g_e, **kw)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="params only"):
        tpairwise.LogPsiAndEnergy.apply(pos_t.clone().requires_grad_(),
                                        params, kw)


# -- the variance functional ------------------------------------------------------

@pytest.mark.parametrize("x", [0.1, 0.3, 0.9, [0.31, 8.0]],
                         ids=["rm0.1", "rm0.3", "rm0.9", "joint"])
def test_principal_function_matches_jax(setup, x):
    jspec, tspec, pos, lp = setup
    joint = isinstance(x, list)
    jopt = jwf.CSWFOptimizer(jspec, pos, lp, opt_obf_lattice_depth=joint)
    topt = twf.CSWFOptimizer(tspec, pos, lp, opt_obf_lattice_depth=joint,
                             device="cpu")
    np.testing.assert_allclose(topt.principal_function(x),
                               jopt.principal_function(x),
                               rtol=VARIANCE_RTOL)


def test_pinned_slice_is_the_1d_functional(setup):
    """The joint variance at [rm, physical depth] equals the 1-D variance
    at rm."""
    _, tspec, pos, lp = setup
    opt1 = twf.CSWFOptimizer(tspec, pos, lp, device="cpu")
    opt2 = twf.CSWFOptimizer(tspec, pos, lp, opt_obf_lattice_depth=True,
                             device="cpu")
    for rm in (0.1, 0.3, 0.9):
        np.testing.assert_allclose(
            opt2.principal_function([rm, tspec.lattice_depth]),
            opt1.principal_function(rm), rtol=1e-12)


@pytest.mark.parametrize("joint", [False, True])
def test_variance_and_gradient_match_jax(optimizers, joint):
    jopt, topt = optimizers[joint]
    x = [0.31, 8.0] if joint else [0.31]
    jv, jg = jopt._value_and_grad_fn(jnp.asarray(x if joint else x[0],
                                                 jnp.float64))
    tv, tg = topt._value_and_grad_fn(x)
    np.testing.assert_allclose(float(tv), float(jv), rtol=VARIANCE_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.atleast_1d(np.asarray(jg)),
                               rtol=VARIANCE_RTOL)
    np.testing.assert_allclose(float(topt._variance_fn(x)), float(jv),
                               rtol=VARIANCE_RTOL)
    np.testing.assert_allclose(float(tv), topt.principal_function(x),
                               rtol=VARIANCE_RTOL)


@pytest.mark.parametrize("joint", [False, True])
def test_grid_values_match_jax(optimizers, joint):
    """The batched grid stage at the same points as JAX's vmapped one:
    the 1-D exec grid, and a coarse 2-D grid."""
    jopt, topt = optimizers[joint]
    (lo, hi), *rest = topt.principal_function_bounds
    if joint:
        axes = np.meshgrid(np.linspace(lo, hi, 8),
                           np.linspace(*rest[0], 4), indexing="ij")
        grid = np.stack([a.ravel() for a in axes], axis=-1)
    else:
        grid = np.linspace(lo, hi, topt.num_grid)[:, None]
    got = topt._grid_values(grid)
    want = np.asarray(jopt._grid_fn(jnp.asarray(grid)))
    np.testing.assert_allclose(got, want, rtol=VARIANCE_RTOL)


# -- the optimizers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_optima(setup, optimizers):
    jspec, _, pos, lp = setup
    return {"de": jwf.CSWFOptimizer(jspec, pos, lp).exec(),
            "grad": optimizers[False][0].exec(),
            "joint": optimizers[True][0].exec()}


@pytest.mark.parametrize("method", ["de", "grad", "joint"])
def test_optimum_matches_jax(setup, optimizers, jax_optima, method):
    _, tspec, pos, lp = setup
    if method == "de":
        topt = twf.CSWFOptimizer(tspec, pos, lp, device="cpu")
    else:
        topt = optimizers[method == "joint"][1]
    got, want = topt.exec(), jax_optima[method]
    assert isinstance(got, tmrbp.Spec)
    np.testing.assert_allclose(got.tbf_contact_cutoff,
                               want.tbf_contact_cutoff, rtol=OPTIMUM_RTOL)
    if method == "joint":
        np.testing.assert_allclose(got.obf_lattice_depth,
                                   want.obf_lattice_depth, rtol=OPTIMUM_RTOL)
    else:
        assert got.obf_lattice_depth is None


def test_wf_opt_proc_dispatch_and_errors(setup):
    _, tspec, pos, lp = setup
    proc = twf.WFOptProc(num_sys_confs=256, method="grad")
    opt_spec = proc.exec(tspec, torch.tensor(pos), torch.tensor(lp),
                         device="cpu")
    assert opt_spec.tbf_contact_cutoff != tspec.tbf_contact_cutoff
    with pytest.raises(ValueError, match="unknown wf-opt method 'nope'"):
        twf.WFOptProc(method="nope").exec(tspec, pos, lp, device="cpu")
    with pytest.raises(ValueError, match="configuration layout"):
        twf.CSWFOptimizer(tspec, pos[:, :4], lp, device="cpu")
    free = tmrbp.Spec(**dict(SPEC, lattice_depth=0.0))
    with pytest.raises(ValueError, match="needs a finite lattice"):
        _ = twf.CSWFOptimizer(free, pos, lp, opt_obf_lattice_depth=True,
                              device="cpu").principal_function_bounds
    # The packed (M, 2, N) layout takes the positions' slot.
    packed = np.stack([pos, np.zeros_like(pos)], axis=1)
    opt = twf.CSWFOptimizer(tspec, packed, lp, device="cpu")
    assert torch.equal(opt.sys_conf_set, torch.as_tensor(pos))
    assert twf.weighed_variance(np.zeros(3), np.array([1.0, 2.0, 3.0])) \
        == pytest.approx(2.0 / 3.0)
