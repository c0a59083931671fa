"""NamedTuple <-> numpy structured-array conversion.

The port's own copy of the JAX package's ``utils/record.py`` (NumPy
only).  The upstream library's ``Record`` mixin maps attrs classes to
numpy structured arrays for HDF5-friendly storage; here the same role is
played by the parameter NamedTuples of the model layer.
"""
import typing as t

import numpy as np

__all__ = ["namedtuple_as_record", "record_as_namedtuple"]


def namedtuple_as_record(nt) -> np.ndarray:
    """A zero-dimensional structured array with one field per
    NamedTuple field (floats stored as f8, ints as i8, bools as b1)."""
    fields = []
    values = []
    for name, value in zip(nt._fields, nt):
        if isinstance(value, (bool, np.bool_)):
            dtype = np.bool_
        elif isinstance(value, (int, np.integer)):
            dtype = np.int64
        else:
            dtype = np.float64
        fields.append((name, dtype))
        values.append(value)
    rec = np.array(tuple(values), dtype=np.dtype(fields))
    return rec


def record_as_namedtuple(record: np.ndarray, nt_cls: t.Type) -> t.Any:
    """Rebuild a NamedTuple instance from a structured array/void."""
    values = []
    for name in nt_cls._fields:
        value = record[name]
        if isinstance(value, np.generic):
            value = value.item()
        values.append(value)
    return nt_cls(*values)
