"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; their files live here, one per name:

* ``configs/<config>.json``: the model, the walkers or chains, the time
  step and the dtype (``proc``), and which sampler runs it;
* ``traffic/<traffic>.json``: the estimators, the cadence, the block
  length, the start and any other settings of the procedure (``proc``),
  and the fewest blocks a window holds (``min_blocks``);
* ``limits/<workload>.json``: the limit of each number the check
  compares;
* ``metrics/<metric>.py``: the reader of a per-layer metric.

Nothing here imports the program.
"""
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Cell", "HERE", "load_cell", "load_reader", "read_benchmark"]

HERE = Path(__file__).resolve().parent


class MissingEntry(LookupError):
    """A name that ``BENCHMARK.json`` or the benchmark's files lack."""


def read_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise MissingEntry(f"no {path}")
    return json.loads(path.read_text())


def _load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise MissingEntry(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def load_reader(metric: str):
    """The ``read(trace, cell)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise MissingEntry(f"no reader for metric {metric!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass(frozen=True)
class Cell:
    """One workload: its configuration, traffic mix and limits, and the
    metrics ``BENCHMARK.json`` has it report."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple   # the metric entries this cell reports
    per_layer: tuple

    @property
    def sampler(self) -> str:
        return self.config["sampler"]

    def proc_config(self, seed: int, num_blocks: int,
                    block_offset: int) -> dict:
        """The procedure's config dict: the configuration's and the
        traffic's ``proc`` settings, the seed as ``rng_seed``, no burn-in
        (set-up warms the state) and the given depth."""
        config = dict(self.config["proc"])
        config.update(self.traffic["proc"])
        config.update(rng_seed=int(seed), num_blocks=int(num_blocks),
                      burn_in_blocks=0, block_offset=int(block_offset))
        return config

    @property
    def steps_per_block(self) -> int:
        proc = self.traffic["proc"]
        return int(proc.get("num_time_steps_block",
                            proc.get("num_steps_block")))

    @property
    def walkers(self) -> int:
        """Target walkers (DMC) or chains (VMC): the work of one step."""
        proc = self.config["proc"]
        return int(proc.get("target_num_walkers", proc.get("num_walkers")))

    @property
    def nop(self) -> int:
        return int(self.config["proc"]["model_spec"]["boson_number"])

    @property
    def slots(self) -> int:
        """Walker slots every step computes."""
        proc = self.config["proc"]
        return int(proc.get("max_num_walkers", proc.get("num_walkers")))


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the checkout at ``root``."""
    bench = read_benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise MissingEntry(f"BENCHMARK.json has no workload {workload!r}")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise MissingEntry(f"BENCHMARK.json has no config "
                           f"{entry['config']!r}")
    config = _load_json("configs", entry["config"])
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config,
        traffic=_load_json("traffic", entry["traffic"]),
        limits=_load_json("limits", workload),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if _applies(m, workload)))
