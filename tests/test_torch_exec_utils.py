"""Helpers shared by the tests of the port's execution layer
(``tests/test_torch_{proc,accumulator,data,io,cli,checkpoint}.py``)."""
import dataclasses
import warnings

import numpy as np

MODEL_CONFIG = dict(lattice_depth=10.0, lattice_ratio=1.0,
                    interaction_strength=1.0, boson_number=5,
                    supercell_size=5.0, tbf_contact_cutoff=0.3)


def to_numpy(value):
    """A tensor, a JAX array or an array as a NumPy array."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def assert_same(a, b, path="data"):
    """Hold two result containers (dataclasses, named tuples, dicts,
    sequences, arrays, scalars), one of each package, equal field by
    field and bit for bit; NaNs of equal position count as equal."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for name in names:
            assert_same(getattr(a, name), getattr(b, name),
                        f"{path}.{name}")
    elif hasattr(a, "_fields"):
        assert a._fields == b._fields, path
        for name in a._fields:
            assert_same(getattr(a, name), getattr(b, name),
                        f"{path}.{name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for name in a:
            assert_same(a[name], b[name], f"{path}[{name!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for idx, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{idx}]")
    else:
        x, y = to_numpy(a), to_numpy(b)
        assert x.shape == y.shape, f"{path}: {x.shape} != {y.shape}"
        np.testing.assert_array_equal(x, y, err_msg=path)


def assert_same_statistics(a, b):
    """The reblocked means and errors of two ``PropsDataBlocks`` (DMC or
    VMC), one of each package, equal bit for bit."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if x is None or not hasattr(x, "mean"):
                continue
            assert_same(x.mean, y.mean, f"{f.name}.mean")
            assert_same(x.mean_error, y.mean_error, f"{f.name}.mean_error")


# -- the helpers hold what they claim ---------------------------------------

@dataclasses.dataclass
class _Box:
    values: np.ndarray
    extra: object = None


def test_assert_same_takes_equal_containers():
    a = _Box(np.array([1.0, np.nan]), {"k": (1, [2.0, None])})
    b = _Box(np.array([1.0, np.nan]), {"k": (1, [2.0, None])})
    assert_same(a, b)


def test_assert_same_refuses_a_last_bit():
    import pytest

    a = _Box(np.array([1.0, 2.0]))
    b = _Box(np.array([1.0, np.nextafter(2.0, 3.0)]))
    with pytest.raises(AssertionError, match="data.values"):
        assert_same(a, b)
    with pytest.raises(AssertionError):
        assert_same(_Box(np.zeros(2), None), _Box(np.zeros(2), 0.0))


def h5_tree(group) -> dict:
    """An HDF5 group as ``{path: array}`` and ``{path@attr: value}``."""
    import h5py

    tree = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            tree[name] = obj[()]
        for key, value in obj.attrs.items():
            tree[f"{name}@{key}"] = value

    group.visititems(visit)
    for key, value in group.attrs.items():
        tree[f"@{key}"] = value
    return tree


def assert_same_tree(a: dict, b: dict):
    """Two :func:`h5_tree` results equal: the same paths, dtypes and
    values."""
    assert sorted(a) == sorted(b)
    for path in a:
        x, y = np.asarray(a[path]), np.asarray(b[path])
        assert x.dtype == y.dtype, f"{path}: {x.dtype} != {y.dtype}"
        assert x.shape == y.shape, path
        if x.dtype.kind in "OSU":
            assert x.tolist() == y.tolist(), path
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)
