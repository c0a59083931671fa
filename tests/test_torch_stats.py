"""The port's copy of the reblocking engine against the JAX package's
original: every public name on seeded series and on a stored series of
the JAX package's tests, equal bit for bit.  Both build the tables of
series of at least 2^14 values with their optional compiled cascade (the
same C++ source, each package building its own library); the tests
switch both off and compare NumPy with NumPy, and hold the two libraries
to each other, and the copy's with its library off to the NumPy path,
bit for bit."""
import pathlib
import shutil
import warnings

import numpy as np
import pytest

from phd_qmclib_torch import stats as tstats
from phd_qmclib_torch.stats import reblock as treblock
from phd_qmclib_tpu import stats as jstats
from phd_qmclib_tpu.stats import reblock as jreblock
from tests.warn_utils import expect_opt_block_warning

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _correlated(n, tau=8.0, seed=577, cols=None):
    rng = np.random.default_rng(seed)
    alpha = np.exp(-1.0 / tau)
    noise = rng.normal(size=(n,) + (() if cols is None else (cols,)))
    out = np.empty_like(noise)
    acc = np.zeros(noise.shape[1:])
    for i in range(n):
        acc = alpha * acc + np.sqrt(1 - alpha ** 2) * noise[i]
        out[i] = acc
    return out + 5.0


def _stored_series():
    import h5py
    with h5py.File(FIXTURES / "test-vmc-results.h5", "r") as fp:
        return np.asarray(fp["test-group/vmc/data/blocks/energy/totals"])


SERIES = {
    "correlated 2^12": lambda: _correlated(2 ** 12),
    "correlated 3000 (not a power of two)": lambda: _correlated(3000, 20.0, 1),
    "white 2^15 (the original's accelerated size)":
        lambda: np.random.default_rng(4).normal(size=2 ** 15) + 1.5,
    "stored VMC energies": _stored_series,
}
PROPS = ("size", "mean", "var", "block_sizes", "num_blocks", "means", "vars",
         "errors", "iac_times", "opt_block_size", "opt_iac_time", "eff_size",
         "mean_eff_error")


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn()


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got, dtype=np.float64),
                                  np.asarray(want, dtype=np.float64))


@pytest.fixture(autouse=True)
def numpy_tables(monkeypatch):
    from phd_qmclib_tpu.stats import native
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setenv("PHD_QMCLIB_TORCH_NATIVE", "0")


def test_public_names_match():
    assert set(treblock.__all__) == set(jreblock.__all__)
    for name in ("IACTimeFit", "Object", "OTFObject", "OTFSet",
                 "on_the_fly_extend_obj_data_set", "on_the_fly_obj_create",
                 "on_the_fly_obj_data_init", "on_the_fly_obj_data_order",
                 "on_the_fly_obj_data_update", "otf_data_dtype", "reblock"):
        assert hasattr(tstats, name) and hasattr(jstats, name), name
    assert treblock.otf_data_dtype == jreblock.otf_data_dtype
    assert hasattr(tstats, "native")
    assert set(tstats.native.__all__) >= set(jstats.native.__all__)


@pytest.mark.parametrize("series", sorted(SERIES))
def test_tables_match(series):
    data = SERIES[series]()
    assert treblock.on_the_fly_obj_data_order(data) \
        == jreblock.on_the_fly_obj_data_order(data)
    got = treblock.on_the_fly_obj_create(data)
    want = jreblock.on_the_fly_obj_create(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    for field in got.dtype.names:
        _same(got[field], want[field])
    order = treblock.on_the_fly_obj_data_order(data)
    init = treblock.on_the_fly_obj_data_init(order, 3)
    want_init = jreblock.on_the_fly_obj_data_init(order, 3)
    assert init.shape == want_init.shape
    assert init.tobytes() == want_init.tobytes()


def test_tables_match_the_accelerated_original(monkeypatch):
    from phd_qmclib_tpu.stats import native
    monkeypatch.undo()
    assert native.native_available() and tstats.native.native_available()
    data = np.random.default_rng(8).normal(size=(2 ** 15, 3)) + 1.5
    got = treblock.on_the_fly_obj_create(data)
    want = jreblock.on_the_fly_obj_create(data)
    assert got.shape == want.shape
    for field in got.dtype.names:
        np.testing.assert_array_equal(got[field], want[field],
                                      err_msg=field)


def test_native_is_available_here(monkeypatch):
    """This host has ``g++``: the port's library builds and loads (a
    silently skipped native path is an unverified one)."""
    monkeypatch.undo()
    assert shutil.which("g++") is not None
    assert tstats.native.native_available()
    assert tstats.native.LIBRARY.exists()


#: (samples, columns): the original's accelerated size, and an odd length.
NATIVE_SHAPES = [(2 ** 15, 3), (40001, 2), (2 ** 15, 1)]


@pytest.mark.parametrize("shape", NATIVE_SHAPES, ids=str)
def test_native_tables_bit_equal_to_the_originals(monkeypatch, shape):
    from phd_qmclib_tpu.stats import native
    monkeypatch.undo()
    data = np.random.default_rng(shape[0]).normal(size=shape) + 1.5
    order = treblock.on_the_fly_obj_data_order(data)
    got = tstats.native.otf_reblock_native(data, order)
    want = native.otf_reblock_native(data, order)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    table = treblock.on_the_fly_obj_create(data)
    want_table = jreblock.on_the_fly_obj_create(data)
    assert table.tobytes() == want_table.tobytes()


@pytest.mark.parametrize("shape", NATIVE_SHAPES, ids=str)
def test_switched_off_tables_are_the_numpy_paths(monkeypatch, shape):
    """``PHD_QMCLIB_TORCH_NATIVE=0`` (the autouse fixture) takes the
    vectorized NumPy path: bit-equal to the original's NumPy tables."""
    assert not tstats.native.native_available()
    data = np.random.default_rng(shape[0]).normal(size=shape) + 1.5

    def refuse(*args):
        raise AssertionError("the native cascade was called")

    monkeypatch.setattr(tstats.native, "otf_reblock_native", refuse)
    got = treblock.on_the_fly_obj_create(data)
    want = jreblock.on_the_fly_obj_create(data)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("cols", [1, 4])
def test_native_threshold(monkeypatch, cols):
    """The library takes a series of at least 2^14 values and no
    smaller one, as in the original."""
    monkeypatch.undo()
    calls = []
    cascade = tstats.native.otf_reblock_native

    def spy(data, max_order):
        calls.append(data.shape)
        return cascade(data, max_order)

    monkeypatch.setattr(tstats.native, "otf_reblock_native", spy)
    rng = np.random.default_rng(cols)
    for n, native_path in (((1 << 14) // cols - 1, False),
                           ((1 << 14) // cols, True)):
        data = rng.normal(size=(n, cols))
        calls.clear()
        treblock.on_the_fly_obj_create(data)
        assert calls == ([(n, cols)] if native_path else []), n


def test_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                        tmp_path):
    broken = tmp_path / "reblock.cpp"
    broken.write_text("extern \"C\" { void otf_reblock_f64( }\n")
    monkeypatch.setattr(tstats.native, "SOURCE", broken)
    monkeypatch.setattr(tstats.native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tstats.native, "LIBRARY",
                        tmp_path / "build" / "libreblock.so")
    with pytest.raises(RuntimeError, match="error"):
        tstats.native.build(shutil.which("g++"))
    assert not (tmp_path / "build" / "libreblock.so").exists()


@pytest.mark.parametrize("cls", ["Object", "OTFObject"])
@pytest.mark.parametrize("series", sorted(SERIES))
def test_analysis_objects_match(series, cls):
    data = SERIES[series]()

    def build(module):
        kind = getattr(module, cls)
        return kind(data) if cls == "Object" \
            else kind.from_non_obj_data(data)

    got, want = build(treblock), build(jreblock)
    for name in PROPS:
        _same(_quiet(lambda: getattr(got, name)),
              _quiet(lambda: getattr(want, name)))


def test_otf_set_matches():
    data = _correlated(2 ** 10, cols=4)
    got = treblock.OTFSet.from_non_obj_data(data)
    want = jreblock.OTFSet.from_non_obj_data(data)
    assert len(got) == len(want) == 4
    for name in PROPS:
        _same(_quiet(lambda: getattr(got, name)),
              _quiet(lambda: getattr(want, name)))
    for obj, ref in zip(got, want):
        _same(obj.means, ref.means)
        _same(obj.vars, ref.vars)
    single = treblock.OTFObject.from_non_obj_data(data[:, 2])
    np.testing.assert_allclose(got[2].means, single.means, rtol=1e-12)


def test_update_and_extend_match():
    runs = [_correlated(2 ** 9, seed=s) for s in range(8)]

    def tables(module):
        return np.stack([module.on_the_fly_obj_create(r) for r in runs])

    got, want = tables(treblock), tables(jreblock)
    ext = treblock.on_the_fly_extend_obj_data_set(got)
    ext_want = jreblock.on_the_fly_extend_obj_data_set(want)
    assert ext.shape == ext_want.shape and ext.shape[0] > got.shape[1]
    for field in ext.dtype.names:
        _same(ext[field], ext_want[field])
    _same(treblock.OTFObject(ext).mean, np.concatenate(runs).mean())
    merged, merged_want = got[0].copy(), want[0].copy()
    treblock.on_the_fly_obj_data_update(merged, got[1])
    jreblock.on_the_fly_obj_data_update(merged_want, want[1])
    for field in merged.dtype.names:
        _same(merged[field], merged_want[field])
    both = treblock.OTFObject.from_obj_data_set(got)
    both_want = jreblock.OTFObject.from_obj_data_set(want)
    _same(both.means, both_want.means)
    _same(both.mean_eff_error, both_want.mean_eff_error)


def test_iac_time_fit_matches():
    times = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256], dtype=float)
    true = treblock.IACTimeFit.__func__(times, 8.0, 12.0, 7.5)
    _same(true, jreblock.IACTimeFit.__func__(times, 8.0, 12.0, 7.5))
    got, want = treblock.IACTimeFit(times, true), \
        jreblock.IACTimeFit(times, true)
    assert got.iac_time == pytest.approx(8.0, rel=1e-4)
    assert got.eac_time == pytest.approx(12.0, rel=1e-3)
    _same(got.params, want.params)
    _same(got(times), want(times))
    data = _correlated(2 ** 12)
    _same(treblock.OTFObject.from_non_obj_data(data).iac_time_fit.params,
          jreblock.OTFObject.from_non_obj_data(data).iac_time_fit.params)


def test_short_series_warns_from_the_copy():
    """The optimum-block-size warning of a short, strongly correlated
    series comes from the port's own module."""
    data = _correlated(2 ** 6, tau=64.0)
    otf = treblock.OTFObject.from_non_obj_data(data)
    with expect_opt_block_warning() as record:
        opt = otf.opt_block_size
    assert opt == otf.block_sizes.max()
    assert any("phd_qmclib_torch" in str(w.filename) for w in record)


def test_constant_series_is_defined_and_warning_free():
    data = np.full(2 ** 10, 7.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for obj in (treblock.Object(data),
                    treblock.OTFObject.from_non_obj_data(data)):
            assert obj.mean == pytest.approx(7.0)
            assert obj.var == 0.0
            assert np.allclose(obj.iac_times, 0.5)
            assert obj.mean_eff_error == 0.0
