"""The port imports without JAX, the JAX package, a GPU, Triton, h5py,
PyYAML, Jinja2 or click: the command line included.  (``tqdm`` cannot be
held out of ``sys.modules``, since ``torch`` imports it; no module of the
port imports it at its top.)"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "phd_qmclib_torch"
FORBIDDEN = ("jax", "phd_qmclib_tpu", "triton", "h5py", "yaml", "jinja2",
             "click")
#: Imported only by the function that needs them.
LAZY = ("h5py", "yaml", "jinja2", "click", "tqdm", "triton")


def test_import_pulls_in_no_jax_or_triton():
    code = (
        "import sys\n"
        "import phd_qmclib_torch\n"
        "from phd_qmclib_torch.samplers import dmc\n"
        "from phd_qmclib_torch.ops import pairwise, prng\n"
        "from phd_qmclib_torch import analysis, lieb_liniger, stats\n"
        "from phd_qmclib_torch.stats import reblock\n"
        "from phd_qmclib_torch.qmc_exec import (cli_app, config, dmc as d,\n"
        "                                       io, report, sweep, vmc)\n"
        "from phd_qmclib_torch.parallel import ParamSweep, VmcSweep\n"
        "from phd_qmclib_torch.parallel import mesh, launch\n"
        "from phd_qmclib_torch.qmc_exec import sharded\n"
        "assert mesh.make_walker_mesh(2, 'cpu').backend == 'gloo'\n"
        "from phd_qmclib_torch.qmc_exec.data import dmc as dd, vmc as dv\n"
        "from phd_qmclib_torch import mrbp_cli, wf_opt\n"
        "from phd_qmclib_torch.models import mrbp\n"
        "assert callable(mrbp.cfc_params_device)\n"
        "assert callable(pairwise.LogPsiAndEnergy.apply)\n"
        "cli_app.WFOptAppSpec.from_config({'proc_type': 'wf_opt',\n"
        "    'proc': dict(model_spec=dict(lattice_depth=10.0,\n"
        "    lattice_ratio=1.0, interaction_strength=1.0, boson_number=5,\n"
        "    supercell_size=5.0, tbf_contact_cutoff=0.3), move_spread=0.2)})\n"
        "wf_opt.WFOptProc(method='grad')\n"
        "from phd_qmclib_torch.multirods_qmc import bloch_phonon\n"
        "assert callable(mrbp_cli.dmc_cli)\n"
        "d.Proc.from_config(dict(model_spec=dict(lattice_depth=10.0,\n"
        "    lattice_ratio=1.0, interaction_strength=1.0, boson_number=5,\n"
        "    supercell_size=5.0, tbf_contact_cutoff=0.3),\n"
        "    time_step=1e-3)).sampling\n"
        "reblock.OTFObject.from_non_obj_data(list(range(64))).mean\n"
        "lieb_liniger.ground_state_energy(2.0, num_points=32)\n"
        "from phd_qmclib_torch import reference_replay\n"
        "from phd_qmclib_torch.utils import record, now, shard_key\n"
        "from phd_qmclib_torch.stats import native\n"
        "record.namedtuple_as_record(mrbp.StaticSpec(5, 1, False, False))\n"
        "reference_replay.MRBPKernels(d.Proc.from_config(dict(\n"
        "    model_spec=dict(lattice_depth=10.0, lattice_ratio=1.0,\n"
        "    interaction_strength=1.0, boson_number=5, supercell_size=5.0,\n"
        "    tbf_contact_cutoff=0.3), time_step=1e-3)).model_spec)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=PKG.parent)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax(path):
    """Not even lazily, inside a function."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "phd_qmclib_tpu"), \
                f"{path.name} imports {name}"


def _imported(node):
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module]
    return []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_optional_packages_are_imported_inside_functions(path):
    """At the top of a module (also under an ``if`` or a ``try`` there)
    nothing imports a package a GPU machine may lack."""
    def top_level(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                if isinstance(node, ast.ClassDef):
                    yield from top_level(node.body)
                continue
            yield node
            for field in ("body", "orelse", "finalbody", "handlers"):
                yield from top_level(getattr(node, field, []) or [])

    for node in top_level(ast.parse(path.read_text()).body):
        for name in _imported(node):
            assert name.split(".")[0] not in LAZY, \
                f"{path.name} imports {name} at its top"
