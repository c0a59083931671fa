"""``k1_log_roofline``: the VMC step's log|psi| and energy evaluation
against the card's bound, in percent.

The bound is the work of one evaluation counted from the shapes (every
chain's unordered pairs at K1 log's 40 flops a pair, positions and
parameters in, log|psi|, energies and drift out; ``yardstick.k1_bound``)
at the published FP32 and HBM peaks of a 700 W H100.  The time is the
device time per step of the kernels named here, the log|psi|
instantiations of the pair kernel.  A run in which none of them ran
reads nothing."""
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import yardstick  # noqa: E402

KERNELS = re.compile(r"\bpair_energy_drift_kernel<(float|double), true>")


def read(trace, cell):
    seconds = sum(k["seconds"] for name, k in trace["kernels"].items()
                  if KERNELS.search(name))
    if seconds <= 0 or trace["steps"] <= 0:
        return None
    bound_s = yardstick.k1_bound(cell.slots, cell.nop, True)["bound_ms"] \
        * 1e-3
    return 100.0 * bound_s / (seconds / trace["steps"])
