"""Write ``obd_grid_jax.npz``: the JAX package's OBDM grid, in f64 on the
CPU, at inputs made with numpy from a seed.

The card's kernel is held against these readings in
``tests/test_torch_cuda_kernels.py`` (the card's host has no JAX), and
``tests/test_torch_estimators.py`` checks on the CPU that they are still
what the JAX package computes.  For each spec the file holds its keyword
arguments (``<name>_spec``, JSON), the walkers (``<name>_pos``, ``(W, N)``
in [0, L)), the estimator's grid of offsets over [0, L/2]
(``<name>_offsets``, ``(M,)``) and the grid (``<name>_obd``, ``(W, M)``).

Run from the root of the repository::

    JAX_PLATFORMS=cpu python tests/fixtures/make_obd_grid_jax.py
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from phd_qmclib_tpu.models import mrbp

BENCH = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
             boson_number=128, supercell_size=128.0, tbf_contact_cutoff=0.4)
#: The production width; the trial function's branches: the free gas has
#: no one-body factor, the ideal one no pair factor, defects only enter
#: the potential.
SPECS = {
    "bench": BENCH,
    "defected": dict(BENCH, num_defects=8, defect_magnitude=10.0),
    "free": dict(BENCH, lattice_depth=0.0),
    "ideal": dict(BENCH, interaction_strength=0.0),
}
NUM_WALKERS, NUM_POS = 8, 32
PATH = pathlib.Path(__file__).with_name("obd_grid_jax.npz")


def jax_grid(kwargs, pos, offsets):
    """The JAX package's ``one_body_density_grid`` in f64."""
    spec = mrbp.Spec(**kwargs)
    cfc = jax.tree.map(jnp.float64, spec.cfc_params)
    return np.asarray(mrbp.core_funcs(spec).one_body_density_grid(
        jnp.asarray(offsets), jnp.asarray(pos), cfc))


def main():
    jax.config.update("jax_enable_x64", True)
    arrays = {}
    for seed, (name, kwargs) in enumerate(sorted(SPECS.items())):
        length = kwargs["supercell_size"]
        pos = np.random.default_rng(seed).uniform(
            0.0, length, (NUM_WALKERS, kwargs["boson_number"]))
        offsets = np.linspace(0.0, 0.5 * length, NUM_POS)
        arrays[f"{name}_spec"] = np.array(json.dumps(kwargs, sort_keys=True))
        arrays[f"{name}_pos"] = pos
        arrays[f"{name}_offsets"] = offsets
        arrays[f"{name}_obd"] = jax_grid(kwargs, pos, offsets)
    np.savez_compressed(PATH, **arrays)


if __name__ == "__main__":
    main()
