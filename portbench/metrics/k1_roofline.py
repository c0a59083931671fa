"""``k1_roofline``: the DMC step's energy and drift evaluation against the
card's bound, in percent.

The bound is the work of one evaluation counted from the shapes (every
slot's unordered pairs at K1's 28 flops a pair, positions and parameters
in, energies and drift out; ``yardstick.k1_bound``) at the published
FP32 and HBM peaks of a 700 W H100.  The time is the device time per
step of the kernels named here, the forward instantiations of the pair
kernel.  A run in which none of them ran reads nothing."""
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import yardstick  # noqa: E402

KERNELS = re.compile(r"\bpair_energy_drift_kernel<(float|double), false>")


def read(trace, cell):
    seconds = sum(k["seconds"] for name, k in trace["kernels"].items()
                  if KERNELS.search(name))
    if seconds <= 0 or trace["steps"] <= 0:
        return None
    bound_s = yardstick.k1_bound(cell.slots, cell.nop, False)["bound_ms"] \
        * 1e-3
    return 100.0 * bound_s / (seconds / trace["steps"])
