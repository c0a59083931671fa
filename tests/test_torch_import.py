"""The port imports without JAX, the JAX package, a GPU, Triton or h5py."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "phd_qmclib_torch"
FORBIDDEN = ("jax", "phd_qmclib_tpu", "triton", "h5py")


def test_import_pulls_in_no_jax_or_triton():
    code = (
        "import sys\n"
        "import phd_qmclib_torch\n"
        "from phd_qmclib_torch.samplers import dmc\n"
        "from phd_qmclib_torch.ops import pairwise, prng\n"
        "from phd_qmclib_torch import analysis, lieb_liniger, stats\n"
        "from phd_qmclib_torch.stats import reblock\n"
        "reblock.OTFObject.from_non_obj_data(list(range(64))).mean\n"
        "lieb_liniger.ground_state_energy(2.0, num_points=32)\n"
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
