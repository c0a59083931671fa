"""Write ``ssf_harmonics_jax.npz``: the JAX package's S(k) parts at the
harmonic momenta (``fourier_density_parts_harmonics``), in f64 on the
CPU, at inputs made with numpy from a seed.

The card's S(k) kernel is held against these readings in
``tests/test_torch_cuda_kernels.py`` (the card's host has no JAX), and
``tests/test_torch_estimators.py`` checks on the CPU that they are still
what the JAX package computes.  For each case the file holds the spec's
keyword arguments (``<name>_spec``, JSON), the mode count
(``<name>_modes``), the walkers (``<name>_pos``, ``(W, N)``) and the
parts (``<name>_parts``, ``(W, M, 3)``).

Run from the root of the repository::

    JAX_PLATFORMS=cpu PYTHONPATH=. \
        python tests/fixtures/make_ssf_harmonics_jax.py
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from phd_qmclib_tpu.models import mrbp

BENCH = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
             boson_number=128, supercell_size=128.0, tbf_contact_cutoff=0.4)
#: The production and sk widths and mode counts, and an odd one: N past a
#: warp, M past two chunks of 32, L not an integer, positions across
#: (-L, 2L).  (name: spec, modes, span of the positions in units of L.)
CASES = {
    "production": (BENCH, 64, (0.0, 1.0)),
    "sk": (dict(BENCH, boson_number=64, supercell_size=64.0), 32, (0.0, 1.0)),
    "odd": (dict(BENCH, boson_number=37, supercell_size=40.5), 65,
            (-1.0, 2.0)),
}
NUM_WALKERS = 8
PATH = pathlib.Path(__file__).with_name("ssf_harmonics_jax.npz")


def jax_parts(kwargs, num_modes, pos):
    """The JAX package's ``fourier_density_parts_harmonics`` in f64."""
    spec = mrbp.Spec(**kwargs)
    cfc = jax.tree.map(jnp.float64, spec.cfc_params)
    return np.asarray(mrbp.core_funcs(spec).fourier_density_parts_harmonics(
        num_modes, jnp.asarray(pos), cfc))


def main():
    jax.config.update("jax_enable_x64", True)
    arrays = {}
    for seed, (name, (kwargs, num_modes, span)) in enumerate(
            sorted(CASES.items())):
        length = kwargs["supercell_size"]
        pos = np.random.default_rng(seed).uniform(
            span[0] * length, span[1] * length,
            (NUM_WALKERS, kwargs["boson_number"]))
        arrays[f"{name}_spec"] = np.array(json.dumps(kwargs, sort_keys=True))
        arrays[f"{name}_modes"] = np.array(num_modes)
        arrays[f"{name}_pos"] = pos
        arrays[f"{name}_parts"] = jax_parts(kwargs, num_modes, pos)
    np.savez_compressed(PATH, **arrays)


if __name__ == "__main__":
    main()
