"""The port's ``qmc_exec.dmc.Proc`` and ``qmc_exec.vmc.Proc`` against
the JAX package's.

* Config dicts go through both ``from_config -> as_config -> evolve``:
  equal dicts, the same warnings, the same error texts for each invalid
  case of ``__post_init__`` (exact string equality).
* ``from_model_sys_conf_spec`` draws the same start configurations (bit
  for bit; the energies at those positions agree to 1e-10 relative).
* ``Proc.exec`` in the port equals, bit for bit, the port's own
  ``Sampling.blocks`` reduced by hand in this file.
* What the port cannot honour yet raises by name.
"""
import json
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from phd_qmclib_torch.qmc_exec import dmc as tdmc, vmc as tvmc
from phd_qmclib_torch.qmc_exec.proc import ProcInputError
from phd_qmclib_torch.utils import tracing
from phd_qmclib_tpu.qmc_exec import dmc as jdmc, vmc as jvmc

from .test_torch_exec_utils import MODEL_CONFIG, to_numpy

torch.set_num_threads(1)

DMC_BASE = dict(model_spec=dict(MODEL_CONFIG), time_step="1e-3",
                max_num_walkers=64, target_num_walkers=48, num_blocks=4,
                num_time_steps_block=16, burn_in_blocks=1, rng_seed=31,
                dtype="float64")
VMC_BASE = dict(model_spec=dict(MODEL_CONFIG), move_spread="0.25",
                num_blocks=3, num_steps_block=16, burn_in_blocks=1,
                num_walkers=8, rng_seed=77, dtype="float64")


def _outcome(build):
    """What building a Proc does: the warnings it gives, and either its
    config or its error."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            proc = build()
        except (ValueError, TypeError) as exc:
            result = (type(exc).__name__, str(exc))
        else:
            result = ("ok", proc.as_config())
    return result, sorted((w.category.__name__, str(w.message))
                          for w in caught)


DMC_CONFIGS = {
    "plain": {},
    "no-burn-in-given": {"burn_in_blocks": None, "num_blocks": 32},
    "aliases": {"num_batches": 8, "num_time_steps_batch": 32,
                "burn_in_batches": 2, "jit_parallel": True,
                "fastmath": False},
    "all-estimators": {
        "est_every": 2, "keep_iter_data": 1,
        "density_spec": {"num_bins": 8},
        "ssf_spec": {"num_modes": 4, "as_pure_est": False},
        "obd_spec": {"num_pos": 3, "est_every_mult": 4},
        "pair_corr_spec": {"num_bins": 6, "est_every_mult": 2,
                           "pfw_num_time_steps": 8},
        "cm_diffusion_spec": {"window_blocks": 2},
        "itc_spec": {"num_modes": 3, "num_lags": 4, "est_every_mult": 2,
                     "as_pure_est": True, "pfw_num_time_steps": 32}},
    "cm-whole-run": {"cm_diffusion_spec": {"window_blocks": 0}},
    "obf-depth": {"model_spec": dict(MODEL_CONFIG, obf_lattice_depth=9.0)},
    "sharding-fields": {"num_mesh_devices": 4, "rebalance_every": 2},
    "checkpoint-fields": {"checkpoint_file": "c.h5", "checkpoint_every": 2,
                          "checkpoint_light": True, "block_offset": 5},
    "itc-too-deep": {"itc_spec": {"num_modes": 2, "num_lags": 64}},
    "pfw-clamped": {"ssf_spec": {"num_modes": 4,
                                 "pfw_num_time_steps": 24}},
    "windows-differ": {"density_spec": {"num_bins": 4,
                                        "pfw_num_time_steps": 32},
                       "ssf_spec": {"num_modes": 4}},
    # The invalid cases of __post_init__, in its order.
    "bad-est-every": {"est_every": 0},
    "bad-block-length": {"est_every": 3},
    "bad-itc-sizes": {"itc_spec": {"num_modes": 0, "num_lags": 4}},
    "bad-itc-cadence": {"itc_spec": {"num_modes": 2, "num_lags": 2,
                                     "est_every_mult": 3}},
    "bad-cm-window": {"cm_diffusion_spec": {"window_blocks": 3}},
    "bad-obd-mult": {"obd_spec": {"num_pos": 3, "est_every_mult": 0}},
    "bad-g2-cadence": {"pair_corr_spec": {"num_bins": 4,
                                          "est_every_mult": 5}},
    "bad-pfw-mixed": {"density_spec": {"num_bins": 4, "as_pure_est": False,
                                       "pfw_num_time_steps": 8}},
    "bad-pfw-zero": {"ssf_spec": {"num_modes": 4,
                                  "pfw_num_time_steps": -8}},
    "bad-pfw-cadence": {"est_every": 2,
                        "obd_spec": {"num_pos": 3, "est_every_mult": 2,
                                     "pfw_num_time_steps": 6}},
    "unknown-key": {"no_such_field": 1},
}


@pytest.mark.parametrize("name", sorted(DMC_CONFIGS))
def test_dmc_config_outcomes_match_jax(name):
    config = dict(DMC_BASE, **DMC_CONFIGS[name])
    if "num_batches" in config:
        for key in ("num_blocks", "num_time_steps_block", "burn_in_blocks"):
            del config[key]
    expected = _outcome(lambda: jdmc.Proc.from_config(config))
    got = _outcome(lambda: tdmc.Proc.from_config(config))
    if name == "unknown-key":
        # A TypeError of the dataclass: its text names the class.
        assert got[0][0] == expected[0][0] == "TypeError"
        assert "no_such_field" in got[0][1]
        return
    assert got == expected
    assert got[0][0] == ("ValueError" if name.startswith("bad-") else "ok")


def test_dmc_config_round_trips_through_both_packages():
    config = dict(DMC_BASE, **DMC_CONFIGS["all-estimators"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tproc = tdmc.Proc.from_config(config)
        jproc = jdmc.Proc.from_config(tproc.as_config())
        again = tdmc.Proc.from_config(jproc.as_config())
    assert again == tproc
    assert again.as_config() == jproc.as_config() == tproc.as_config()
    assert isinstance(tproc.time_step, float) and tproc.keep_iter_data is True


EVOLVE_CASES = [
    {"num_blocks": 8, "rng_seed": 5},
    {"model_spec": {"tbf_contact_cutoff": 0.25}},
    {"ssf_spec": {"num_modes": 6}, "obd_spec": {"num_pos": 5}},
    {"pair_corr_spec": {"num_bins": 4}, "itc_spec": {"num_lags": 2}},
    {"checkpoint_file": None, "block_offset": 9},
]


@pytest.mark.parametrize("changes", EVOLVE_CASES, ids=range(len(EVOLVE_CASES)))
def test_dmc_evolve_matches_jax(changes):
    config = dict(DMC_BASE, **DMC_CONFIGS["all-estimators"],
                  checkpoint_file="c.h5")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jproc = jdmc.Proc.from_config(config).evolve(changes)
        tproc = tdmc.Proc.from_config(config).evolve(changes)
    assert tproc.as_config() == jproc.as_config()
    assert tproc.checkpoint_file == jproc.checkpoint_file


VMC_CONFIGS = {
    "plain": {},
    "aliases": {"num_batches": 4, "num_steps_batch": 32,
                "burn_in_batches": 1},
    "estimators": {"est_every": 2, "gaussian": True, "keep_iter_data": True,
                   "ssf_spec": {"num_modes": 4},
                   "obd_spec": {"num_pos": 3, "est_every_mult": 2},
                   "pair_corr_spec": {"num_bins": 5, "est_every_mult": 4}},
    "bad-est-every": {"est_every": 0},
    "bad-g2-mult": {"pair_corr_spec": {"num_bins": 5, "est_every_mult": 0}},
    "bad-g2-cadence": {"pair_corr_spec": {"num_bins": 5,
                                          "est_every_mult": 3}},
    "bad-obd-mult": {"obd_spec": {"num_pos": 3, "est_every_mult": -1}},
    "bad-obd-cadence": {"obd_spec": {"num_pos": 3, "est_every_mult": 5}},
    "bad-block-length": {"est_every": 3},
}


@pytest.mark.parametrize("name", sorted(VMC_CONFIGS))
def test_vmc_config_outcomes_match_jax(name):
    config = dict(VMC_BASE, **VMC_CONFIGS[name])
    if "num_batches" in config:
        for key in ("num_blocks", "num_steps_block", "burn_in_blocks"):
            del config[key]
    expected = _outcome(lambda: jvmc.Proc.from_config(config))
    got = _outcome(lambda: tvmc.Proc.from_config(config))
    assert got == expected
    assert got[0][0] == ("ValueError" if name.startswith("bad-") else "ok")
    if got[0][0] == "ok":
        changes = {"num_blocks": 5, "ssf_spec": {"num_modes": 3},
                   "model_spec": {"tbf_contact_cutoff": 0.2}}
        assert _outcome(lambda: tvmc.Proc.from_config(config)
                        .evolve(changes)) \
            == _outcome(lambda: jvmc.Proc.from_config(config)
                        .evolve(changes))


# -- start configurations ------------------------------------------------------

@pytest.mark.parametrize("num_sys_conf", (None, 40, 60))
def test_dmc_start_configurations_match_jax(num_sys_conf):
    config = dict(DMC_BASE, density_spec={"num_bins": 4},
                  cm_diffusion_spec={"window_blocks": 1},
                  itc_spec={"num_modes": 2, "num_lags": 2})
    jproc, tproc = jdmc.Proc.from_config(config), \
        tdmc.Proc.from_config(config)
    spec = dict(dist_type="RANDOM", num_sys_conf=num_sys_conf)
    jstate = jdmc.ProcInput.from_model_sys_conf_spec(
        jdmc.ModelSysConfSpec(**spec), jproc).state
    tinput = tdmc.ProcInput.from_model_sys_conf_spec(
        tdmc.ModelSysConfSpec(**spec), tproc, device="cpu")
    tstate = tinput.state
    assert tinput.resume is None and tstate.pos.dtype == torch.float64
    np.testing.assert_array_equal(to_numpy(tstate.pos), to_numpy(jstate.pos))
    np.testing.assert_array_equal(to_numpy(tstate.masks),
                                  to_numpy(jstate.masks))
    assert int(tstate.num_walkers) == int(to_numpy(jstate.num_walkers).sum())
    np.testing.assert_allclose(to_numpy(tstate.energies),
                               to_numpy(jstate.energies), rtol=1e-10)
    np.testing.assert_allclose(float(tstate.ref_energy),
                               float(jstate.ref_energy), rtol=1e-10)
    assert tstate.cmd_accum.shape == (64,)
    assert tstate.itc_buf.shape == (64, 2, 2, 2)


def test_vmc_start_configurations_match_jax():
    jproc, tproc = jvmc.Proc.from_config(VMC_BASE), \
        tvmc.Proc.from_config(VMC_BASE)
    jstate = jvmc.ProcInput.from_model_sys_conf_spec(
        jvmc.ModelSysConfSpec(), jproc).state
    with pytest.warns(UserWarning, match="num_sys_conf=3 differs"):
        tstate = tvmc.ProcInput.from_model_sys_conf_spec(
            tvmc.ModelSysConfSpec(num_sys_conf=3), tproc,
            device="cpu").state
    np.testing.assert_array_equal(to_numpy(tstate.pos), to_numpy(jstate.pos))
    np.testing.assert_allclose(to_numpy(tstate.wf_abs_log),
                               to_numpy(jstate.wf_abs_log), rtol=1e-10)
    np.testing.assert_allclose(to_numpy(tstate.energy),
                               to_numpy(jstate.energy), rtol=1e-10)


# -- exec against the sampler's blocks, reduced by hand -------------------------

EXEC_CONFIG = dict(
    DMC_BASE, time_step=1e-2, num_blocks=4, num_time_steps_block=8,
    burn_in_blocks=2, block_offset=3, est_every=2,
    density_spec={"num_bins": 6, "pfw_num_time_steps": 16},
    ssf_spec={"num_modes": 4, "as_pure_est": False},
    obd_spec={"num_pos": 3, "as_pure_est": False, "est_every_mult": 2},
    pair_corr_spec={"num_bins": 5, "pfw_num_time_steps": 16,
                    "est_every_mult": 2},
    cm_diffusion_spec={"window_blocks": 2},
    itc_spec={"num_modes": 3, "num_lags": 2})


def _f64(tensor):
    return np.asarray(tensor, dtype=np.float64)


def _hand_blocks(proc, state):
    """The measured blocks of ``Sampling.blocks`` as the procedure must
    start it."""
    blocks = proc.sampling.blocks(state, proc.num_time_steps_block,
                                  proc.burn_in_blocks,
                                  block_offset=proc.block_offset)
    for _ in range(proc.burn_in_blocks):
        next(blocks)
    return [next(blocks) for _ in range(proc.num_blocks)]


@pytest.mark.parametrize("keep", (True, False))
def test_dmc_exec_equals_blocks_reduced_by_hand(keep):
    proc = tdmc.Proc.from_config(dict(EXEC_CONFIG, keep_iter_data=keep))
    start = tdmc.ProcInput.from_model_sys_conf_spec(
        tdmc.ModelSysConfSpec(), proc, device="cpu")
    result = proc.exec(start)
    hand = _hand_blocks(proc, start.state)
    np.testing.assert_array_equal(result.state.pos, hand[-1].last_state.pos)
    np.testing.assert_array_equal(result.state.itc_buf,
                                  hand[-1].last_state.itc_buf)
    assert result.proc is proc
    data = result.data

    def rows(name):
        return np.stack([_f64(getattr(block, name)) for block in hand])

    def prop(name):
        return np.stack([_f64(getattr(block.iter_props, name))
                         for block in hand])

    energy, weight, nw = prop("energy"), prop("weight"), prop("num_walkers")
    if keep:
        series = data.series
        for name in ("energy", "weight", "num_walkers", "ref_energy",
                     "accum_energy"):
            np.testing.assert_array_equal(
                getattr(series.iter_props, name), prop(name))
        np.testing.assert_array_equal(series.density, rows("iter_density"))
        np.testing.assert_array_equal(series.ssf, rows("iter_ssf"))
        np.testing.assert_array_equal(series.obd, rows("iter_obd"))
        np.testing.assert_array_equal(series.g2, rows("iter_g2"))
        np.testing.assert_array_equal(series.cmd, rows("iter_cmd"))
        np.testing.assert_array_equal(series.itc, rows("iter_itc"))
        np.testing.assert_array_equal(series.itc_nw, rows("iter_itc_nw"))
    else:
        assert data.series is None
    blocks = data.blocks
    np.testing.assert_array_equal(blocks.energy.totals, energy.sum(axis=1))
    np.testing.assert_array_equal(blocks.energy.weight_totals,
                                  weight.sum(axis=1))
    np.testing.assert_array_equal(blocks.num_walkers.totals, nw.sum(axis=1))
    # Pure estimators: one sample per two-block window, its last row,
    # weighted by the window-final step's walker count.
    np.testing.assert_array_equal(blocks.density.totals,
                                  rows("iter_density")[1::2, -1])
    np.testing.assert_array_equal(blocks.pair_corr.totals,
                                  rows("iter_g2")[1::2, -1])
    np.testing.assert_array_equal(blocks.density.weight_totals,
                                  nw[1::2, -1:])
    # Mixed estimators: the sum of the measured rows, normalized by the
    # measured steps' weights.
    ssf = rows("iter_ssf").sum(axis=1)
    np.testing.assert_array_equal(blocks.ss_factor.fdk_sqr_abs_part.totals,
                                  ssf[..., 0])
    np.testing.assert_array_equal(
        blocks.ss_factor.fdk_real_part.weight_totals,
        weight[:, 1::2].sum(axis=1)[:, None])
    np.testing.assert_array_equal(blocks.one_body_dm.totals,
                                  rows("iter_obd").sum(axis=1))
    np.testing.assert_array_equal(blocks.one_body_dm.weight_totals,
                                  weight[:, 3::4].sum(axis=1)[:, None])
    np.testing.assert_array_equal(blocks.itc.lag_sums,
                                  rows("iter_itc").sum(axis=1))
    np.testing.assert_array_equal(blocks.itc.lag_counts,
                                  rows("iter_itc_nw").sum(axis=1))
    w2 = rows("iter_cmd")[..., 0] / nw[:, 1::2]
    np.testing.assert_array_equal(blocks.cm_diffusion.w2_series,
                                  w2.reshape(2, -1))
    assert blocks.cm_diffusion.tau_step == 2 * proc.time_step


@pytest.mark.parametrize("keep", (True, False))
def test_vmc_exec_equals_blocks_reduced_by_hand(keep):
    config = dict(VMC_BASE, keep_iter_data=keep, block_offset=2,
                  ssf_spec={"num_modes": 4},
                  obd_spec={"num_pos": 3, "est_every_mult": 2},
                  est_every=2)
    proc = tvmc.Proc.from_config(config)
    start = tvmc.ProcInput.from_model_sys_conf_spec(
        tvmc.ModelSysConfSpec(), proc, device="cpu")
    result = proc.exec(start)
    blocks = proc.sampling.blocks(proc.num_steps_block, start.state,
                                  block_offset=proc.block_offset)
    for _ in range(proc.burn_in_blocks):
        next(blocks)
    hand = [next(blocks) for _ in range(proc.num_blocks)]
    np.testing.assert_array_equal(result.state.pos, hand[-1].last_state.pos)
    energy = np.stack([_f64(b.iter_props.energy.mean(dim=-1)) for b in hand])
    ssf = np.stack([_f64(b.iter_ssf) for b in hand]) / proc.num_walkers
    obd = np.stack([_f64(b.iter_obd) for b in hand]) / proc.num_walkers
    data = result.data
    if keep:
        np.testing.assert_array_equal(data.series.iter_props.energy, energy)
        np.testing.assert_array_equal(data.series.ssf, ssf)
        np.testing.assert_array_equal(data.series.obd, obd)
    else:
        assert data.series is None
        np.testing.assert_array_equal(data.blocks.energy.totals,
                                      energy.mean(axis=1))
        np.testing.assert_array_equal(
            data.blocks.ss_factor.fdk_sqr_abs_part.totals,
            np.stack([_f64(b.iter_ssf) for b in hand]).mean(axis=1)[..., 0]
            / proc.num_walkers)
        np.testing.assert_array_equal(
            data.blocks.one_body_dm.totals,
            np.stack([_f64(b.iter_obd) for b in hand]).mean(axis=1)
            / proc.num_walkers)


# -- what the port cannot honour raises by name ---------------------------------

@pytest.mark.parametrize("mod,base", ((tdmc, DMC_BASE), (tvmc, VMC_BASE)),
                         ids=("dmc", "vmc"))
def test_sharded_procedure_raises_by_name(mod, base):
    """``num_mesh_devices`` is no longer refused: on the CPU the
    procedure runs on that many gloo ranks and returns the global view;
    asking for more cards than the machine has raises with the JAX
    package's text."""
    proc = mod.Proc.from_config(dict(base, num_mesh_devices=2))
    # The configuration round-trips.
    assert proc.as_config()["num_mesh_devices"] == 2
    start = mod.ProcInput.from_model_sys_conf_spec(mod.ModelSysConfSpec(),
                                                   proc, device="cpu")
    result = proc.exec(start)
    if mod is tdmc:
        # Each shard its valid prefix, one count each.
        assert start.state.num_walkers.tolist() == [24, 24]
        assert result.state.num_walkers.shape == (2,)
        assert result.state.pos.shape == (64, 5)
        nw = result.data.blocks.num_walkers.totals
        assert nw.shape == (proc.num_blocks,) and np.all(nw > 0)
    else:
        assert result.state.pos.shape == (8, 5)
        assert result.state.wf_abs_log.shape == (8,)
    assert np.isfinite(result.data.blocks.energy.mean)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 2 devices, 0 "
                                             "available"):
            proc.mesh_spec("cuda")


def test_exec_refuses_a_foreign_input():
    dproc = tdmc.Proc.from_config(DMC_BASE)
    vproc = tvmc.Proc.from_config(VMC_BASE)
    vinput = tvmc.ProcInput.from_model_sys_conf_spec(
        tvmc.ModelSysConfSpec(), vproc, device="cpu")
    with pytest.raises(ProcInputError, match="dmc ProcInput"):
        dproc.exec(vinput)
    with pytest.raises(ProcInputError, match="vmc ProcInput"):
        vproc.exec(object())


def test_profile_dir_writes_a_trace(tmp_path):
    proc = tdmc.Proc.from_config(dict(
        DMC_BASE, num_blocks=1, burn_in_blocks=0, num_time_steps_block=4,
        profile_dir=str(tmp_path / "trace")))
    start = tdmc.ProcInput.from_model_sys_conf_spec(
        tdmc.ModelSysConfSpec(), proc, device="cpu")
    traced = proc.exec(start)
    plain = proc.evolve({"profile_dir": None}).exec(start)
    path = tmp_path / "trace" / "dmc_block0.trace.json"
    assert path.stat().st_size > 0
    np.testing.assert_array_equal(traced.data.blocks.energy.totals,
                                  plain.data.blocks.energy.totals)
    # The trace names the layers: the block's run and each of its steps.
    spans = Counter(e["name"] for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation")
    assert spans[tracing.RUN_DMC] == 1 and spans[tracing.STEP_DMC] == 4
    assert not tracing.enabled()
