"""The port's NamedTuple <-> structured-array conversion against the JAX
package's original, on the port's parameter NamedTuples: equal
structured dtypes, equal bytes, and round trips back to equal tuples."""
import numpy as np
import pytest

from phd_qmclib_torch.models import jastrow as tjastrow, mrbp as tmrbp
from phd_qmclib_torch.utils import record as trecord
from phd_qmclib_tpu.utils import record as jrecord

SPECS = {
    "bench": dict(lattice_depth=20.0, lattice_ratio=1.0,
                  interaction_strength=1.0, boson_number=128,
                  supercell_size=128.0, tbf_contact_cutoff=0.4),
    "defected": dict(lattice_depth=12.0, lattice_ratio=1.0,
                     interaction_strength=4.0, boson_number=16,
                     supercell_size=16.0, tbf_contact_cutoff=0.35,
                     num_defects=4, defect_magnitude=7.5),
}


def _tuples():
    out = {"TBFParams literal": tmrbp.TBFParams(5.0, 0.3, 1.1, 2.2, 3.3,
                                                0.9)}
    for name, kwargs in SPECS.items():
        spec = tmrbp.Spec(**kwargs)
        cfc = spec.cfc_params
        out[f"{name} ModelParams"] = cfc.model_params
        out[f"{name} OBFParams"] = cfc.obf_params
        out[f"{name} TBFParams"] = cfc.tbf_params
        out[f"{name} StaticSpec"] = spec.static_spec
    return out


TUPLES = _tuples()


def test_public_names_match():
    assert trecord.__all__ == jrecord.__all__


@pytest.mark.parametrize("name", sorted(TUPLES))
def test_record_bit_equal_to_the_original(name):
    nt = TUPLES[name]
    got = trecord.namedtuple_as_record(nt)
    want = jrecord.namedtuple_as_record(nt)
    assert got.dtype == want.dtype
    assert got.dtype.names == nt._fields
    assert got.shape == want.shape == ()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", sorted(TUPLES))
def test_round_trip(name):
    nt = TUPLES[name]
    rec = trecord.namedtuple_as_record(nt)
    back = trecord.record_as_namedtuple(rec, type(nt))
    want = jrecord.record_as_namedtuple(rec, type(nt))
    assert back == nt and back == want
    assert [type(v) for v in back] == [type(v) for v in want]


def test_round_trip_through_a_structured_row():
    """A record stored in a table row (a ``numpy.void``) rebuilds too."""
    nt = TUPLES["bench TBFParams"]
    table = np.zeros(3, dtype=trecord.namedtuple_as_record(nt).dtype)
    table[1] = trecord.namedtuple_as_record(nt)
    assert trecord.record_as_namedtuple(table[1], tmrbp.TBFParams) == nt
    cfc = tmrbp.Spec(**SPECS["bench"]).cfc_params
    assert isinstance(cfc, tjastrow.CFCParams)
