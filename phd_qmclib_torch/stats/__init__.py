"""Statistics engine: blocking/autocorrelation analysis (NumPy and SciPy,
and an optional C++ cascade for large tables, built at its first use)."""
from . import native, reblock  # noqa: F401
from .reblock import (  # noqa: F401
    IACTimeFit, Object, OTFObject, OTFSet, on_the_fly_extend_obj_data_set,
    on_the_fly_obj_create, on_the_fly_obj_data_init,
    on_the_fly_obj_data_order, on_the_fly_obj_data_update, otf_data_dtype,
)
