"""HDF5 input/output handlers.

Counterpart of ``phd_qmclib_tpu.qmc_exec.io``: the same groups,
datasets and attrs, so a file written by either package loads in the
other.  Both keep the upstream library's canonical file layout
(``qmc_exec/io.py:76-208``)::

    {group}/{vmc|dmc}/state      - last sampler state
    {group}/{vmc|dmc}/proc_spec  - procedure config as HDF5 attrs
    {group}/{vmc|dmc}/data       - block statistics (totals datasets)

DMC state layout matches ``qmc_exec/dmc/io.py:35-80``: ``confs`` packs
(pos, drift) as ``(Wm, 2, N)``, walker properties live under ``props/``
and ensemble scalars are group attrs.

``h5py`` is imported by the functions that open a file, so the module
imports where it is missing.  States are written from wherever they
live and load onto the ``device`` the caller names.
"""
import types
import typing as t
from abc import ABCMeta, abstractmethod
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..models import mrbp
from ..samplers import dmc as dmc_sampler, vmc as vmc_sampler
from . import dmc as dmc_proc, vmc as vmc_proc
from .data import dmc as dmc_data, vmc as vmc_data

__all__ = [
    "HDF5FileHandler",
    "HDF5FileHandlerGroupError",
    "DmcHDF5FileHandler",
    "VmcHDF5FileHandler",
    "IOHandler",
]

HDF5_FILE_TYPE = "HDF5_FILE"


class IOHandler(metaclass=ABCMeta):
    """Abstract IO handler (``qmc_exec/io.py:16-43``)."""
    type: str

    @classmethod
    @abstractmethod
    def from_config(cls, config: t.Mapping):
        ...

    @abstractmethod
    def load(self, device="cuda"):
        ...

    @abstractmethod
    def dump(self, proc_result):
        ...


class HDF5FileHandlerGroupError(ValueError):
    """An error saving data to an HDF5 file (group collision)."""


@dataclass(frozen=True)
class HDF5FileHandler(IOHandler, metaclass=ABCMeta):
    """Handler for properly structured HDF5 files
    (``qmc_exec/io.py:51-223``)."""
    location: str
    group: str
    dump_replace: bool = False
    type: str = HDF5_FILE_TYPE

    @classmethod
    def from_config(cls, config: t.Mapping):
        config = dict(config)
        config.pop("type", None)
        # A missing required key would surface as a bare dataclass
        # TypeError; name the stanza and the key instead (the
        # reference requires the same keys with the same raw failure,
        # ``qmc_exec/io.py:51-70``).
        for key in ("location", "group"):
            if key not in config:
                raise ValueError(
                    f"an HDF5_FILE stanza needs a '{key}' entry "
                    f"(got keys {sorted(config)})")
        return cls(**config)

    @property
    def location_path(self) -> Path:
        return Path(self.location).absolute()

    @property
    @abstractmethod
    def sampling_type(self) -> str:
        ...

    def load(self, device="cuda"):
        """The stored result, its state on ``device``."""
        import h5py

        with h5py.File(self.location_path, "r") as h5_file:
            qmc_group = h5_file.get(f"{self.group}/{self.sampling_type}")
            if qmc_group is None:
                raise HDF5FileHandlerGroupError(
                    f"no '{self.group}/{self.sampling_type}' group in "
                    f"{self.location_path}")
            # Proc first: legacy reference states (see ``load_state``)
            # may need the model spec to rebuild derived state fields.
            proc_inst = self.load_proc(qmc_group.get("proc_spec"))
            state = self.load_state(qmc_group.get("state"), proc_inst,
                                    device=device)
            data = self.load_sampling_data(qmc_group.get("data"))
        return self.build_result(state, proc_inst, data)

    def dump(self, proc_result):
        import h5py

        with h5py.File(self.location_path, "a") as h5_file:
            base_group = h5_file.require_group(self.group)
            sampling_type = self.sampling_type
            if sampling_type in base_group:
                if self.dump_replace:
                    del base_group[sampling_type]
                else:
                    raise HDF5FileHandlerGroupError(
                        f"Unable to create '{sampling_type}' group "
                        f"(name already exists)")
            qmc_group = base_group.require_group(sampling_type)
            self.save_state(proc_result.state,
                            qmc_group.require_group("state"))
            self.save_proc(proc_result.proc.as_config(),
                           qmc_group.require_group("proc_spec"))
            self.save_sampling_data(proc_result.data,
                                    qmc_group.require_group("data"))
            h5_file.flush()

    # -- proc spec <-> attrs (``qmc_exec/io.py:155-208``) -------------------

    def load_proc(self, group: "h5py.Group"):
        model_spec_config = dict(group.get("model_spec").attrs.items())
        proc_config = {"model_spec": model_spec_config}
        density_group = group.get("density_spec")
        if density_group is not None:
            proc_config["density_spec"] = dict(density_group.attrs.items())
        ssf_group = group.get("ssf_spec")
        if ssf_group is not None:
            proc_config["ssf_spec"] = dict(ssf_group.attrs.items())
        obd_group = group.get("obd_spec")
        if obd_group is not None:
            proc_config["obd_spec"] = dict(obd_group.attrs.items())
        g2_group = group.get("pair_corr_spec")
        if g2_group is not None:
            proc_config["pair_corr_spec"] = dict(g2_group.attrs.items())
        cmd_group = group.get("cm_diffusion_spec")
        if cmd_group is not None:
            proc_config["cm_diffusion_spec"] = dict(
                cmd_group.attrs.items())
        itc_group = group.get("itc_spec")
        if itc_group is not None:
            proc_config["itc_spec"] = dict(itc_group.attrs.items())
        proc_config.update(group.attrs.items())
        # h5py returns numpy scalars/bytes; normalize.
        proc_config = _normalize_h5_config(proc_config)
        return self.build_proc(proc_config)

    @staticmethod
    def save_proc(config: dict, group: "h5py.Group"):
        config = dict(config)
        model_spec = {k: v for k, v in config.pop("model_spec").items()
                      if v is not None}
        group.require_group("model_spec").attrs.update(**model_spec)
        density_config = config.pop("density_spec", None)
        if density_config is not None:
            group.require_group("density_spec").attrs.update(
                **density_config)
        ssf_config = config.pop("ssf_spec", None)
        if ssf_config is not None:
            group.require_group("ssf_spec").attrs.update(**ssf_config)
        obd_config = config.pop("obd_spec", None)
        if obd_config is not None:
            group.require_group("obd_spec").attrs.update(**obd_config)
        g2_config = config.pop("pair_corr_spec", None)
        if g2_config is not None:
            group.require_group("pair_corr_spec").attrs.update(
                **g2_config)
        cmd_config = config.pop("cm_diffusion_spec", None)
        if cmd_config is not None:
            group.require_group("cm_diffusion_spec").attrs.update(
                **{k: v for k, v in cmd_config.items() if v is not None})
        itc_config = config.pop("itc_spec", None)
        if itc_config is not None:
            group.require_group("itc_spec").attrs.update(**itc_config)
        group.attrs.update(config)

    @abstractmethod
    def build_proc(self, proc_config: dict):
        ...

    @abstractmethod
    def build_result(self, state, proc_inst, sampling_data):
        ...

    @abstractmethod
    def load_state(self, group: "h5py.Group", proc_inst=None,
                   device="cuda"):
        ...

    @abstractmethod
    def save_state(self, state, group: "h5py.Group"):
        ...

    @abstractmethod
    def load_sampling_data(self, group: "h5py.Group"):
        ...

    @abstractmethod
    def save_sampling_data(self, sampling_data, group: "h5py.Group"):
        ...


def _numpy(tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def _normalize_h5_config(config):
    out = {}
    for key, value in config.items():
        if isinstance(value, dict):
            out[key] = _normalize_h5_config(value)
        elif isinstance(value, bytes):
            out[key] = value.decode()
        elif isinstance(value, np.generic):
            out[key] = value.item()
        else:
            out[key] = value
    return out


@dataclass(frozen=True)
class DmcHDF5FileHandler(HDF5FileHandler):
    """DMC flavor (``qmc_exec/dmc/io.py`` + ``mrbp_qmc/dmc_exec/io.py``)."""

    @property
    def sampling_type(self) -> str:
        return "dmc"

    def build_proc(self, proc_config: dict):
        return dmc_proc.Proc.from_config(proc_config)

    def build_result(self, state, proc_inst, sampling_data):
        return dmc_proc.ProcResult(state, proc_inst, sampling_data)

    def save_state(self, state: dmc_sampler.State, group: "h5py.Group"):
        group.create_dataset("confs", data=_numpy(state.confs))
        props_group = group.require_group("props")
        props_group.create_dataset("energy",
                                   data=_numpy(state.energies))
        props_group.create_dataset("weight",
                                   data=_numpy(state.weights))
        props_group.create_dataset("mask", data=_numpy(state.masks))
        # The reference stores the branching table ``(cloning_factor,
        # cloning_ref)`` (``qmc_base/dmc.py:381-383``, saved as a
        # ``(2, Wm)`` array by ``qmc_exec/dmc/io.py:41``).  This
        # state does not need it to resume; write an identity cloning
        # table so a reference-side reader that transports data through
        # ``cloning_ref`` maps each slot to itself.
        max_w = state.max_num_walkers
        branching = np.zeros((2, max_w), dtype=np.int64)
        branching[1] = np.arange(max_w)
        group.create_dataset("branching_spec", data=branching)
        # Controller accumulators as an extra dataset so the attrs stay
        # exactly the reference's six fields.
        group.create_dataset(
            "controller_totals",
            data=np.array([float(state.total_energy),
                           float(state.total_weight)]))
        group.attrs.update({
            "energy": float(state.energy),
            "weight": float(state.weight),
            "num_walkers": int(state.num_walkers.sum()),
            "ref_energy": float(state.ref_energy),
            "accum_energy": float(state.accum_energy),
            "max_num_walkers": int(state.max_num_walkers),
        })
        # Per-shard walker counts (extra dataset of the JAX package's
        # layout; a state on one device has one entry equal to the
        # num_walkers attr, a sharded run's global view one per shard).
        group.create_dataset("shard_num_walkers",
                             data=np.atleast_1d(_numpy(state.num_walkers))
                             .astype(np.int32))
        if state.cmd_accum is not None:
            # CM-diffusion window accumulator (extra dataset; absent
            # in the reference layout and ignored by its readers).  A
            # checkpoint cut mid-window then resumes the window
            # instead of restarting it.
            group.create_dataset("cmd_accum",
                                 data=_numpy(state.cmd_accum))
        if state.itc_buf is not None:
            # Imaginary-time-correlation lag ring buffer (extra
            # datasets, same contract as cmd_accum): a restore
            # continues the lag fill exactly where the checkpoint cut
            # it.
            group.create_dataset("itc_buf",
                                 data=_numpy(state.itc_buf))
            group.attrs["itc_filled"] = int(state.itc_filled)

    def load_state(self, group: "h5py.Group", proc_inst=None,
                   device="cuda") -> dmc_sampler.State:
        import h5py

        confs = group.get("confs")[()]
        props = group.get("props")
        if isinstance(props, h5py.Dataset):
            # Legacy reference layout: ``props`` is one ``(3, Wm)``
            # array with rows (energy, weight, mask) instead of the
            # ``props/{energy,weight,mask}`` subdatasets (fallback in
            # the reference's loader, ``qmc_exec/dmc/io.py:66-76``).
            props_arr = props[()]
            energies = props_arr[0]
            weights = props_arr[1]
            masks = props_arr[2].astype(bool)
        else:
            energies = props.get("energy")[()]
            weights = props.get("weight")[()]
            masks = props.get("mask")[()].astype(bool)
        attrs = dict(group.attrs.items())
        totals_ds = group.get("controller_totals")
        totals = totals_ds[()] if totals_ds is not None else (0.0, 0.0)
        shard_nw_ds = group.get("shard_num_walkers")
        shard_nw = shard_nw_ds[()] if shard_nw_ds is not None \
            else np.asarray([attrs["num_walkers"]])
        pos = confs[:, mrbp.SysConfSlot.pos, :]
        drift = confs[:, mrbp.SysConfSlot.drift, :]
        dtype = pos.dtype
        cmd_ds = group.get("cmd_accum")
        itc_ds = group.get("itc_buf")

        def scalar(value):
            return np.asarray(value, dtype=dtype)

        fields = types.SimpleNamespace(
            pos=pos, drift=drift,
            energies=np.asarray(energies, dtype=dtype),
            weights=np.asarray(weights, dtype=dtype),
            masks=masks,
            energy=scalar(attrs["energy"]),
            weight=scalar(attrs["weight"]),
            num_walkers=np.asarray(shard_nw, dtype=np.int64),
            ref_energy=scalar(attrs["ref_energy"]),
            accum_energy=scalar(attrs["accum_energy"]),
            total_energy=scalar(totals[0]),
            total_weight=scalar(totals[1]),
            cmd_accum=(np.asarray(cmd_ds[()], dtype=dtype)
                       if cmd_ds is not None else None),
            itc_buf=(np.asarray(itc_ds[()], dtype=dtype)
                     if itc_ds is not None else None),
            itc_filled=(np.int32(attrs["itc_filled"])
                        if itc_ds is not None else None))
        return dmc_sampler.state_from_numpy(fields, device=device)

    def load_sampling_data(self, group: "h5py.Group"):
        return dmc_data.SamplingData.from_hdf5_data(group)

    def save_sampling_data(self, sampling_data, group: "h5py.Group"):
        sampling_data.hdf5_export(group)


@dataclass(frozen=True)
class VmcHDF5FileHandler(HDF5FileHandler):
    """VMC flavor (``qmc_exec/vmc/io.py`` + ``mrbp_qmc/vmc_exec/io.py``)."""

    @property
    def sampling_type(self) -> str:
        return "vmc"

    def build_proc(self, proc_config: dict):
        return vmc_proc.Proc.from_config(proc_config)

    def build_result(self, state, proc_inst, sampling_data):
        return vmc_proc.ProcResult(state, proc_inst, sampling_data)

    def save_state(self, state: vmc_sampler.State, group: "h5py.Group"):
        group.create_dataset("sys_conf", data=_numpy(state.pos))
        group.create_dataset("wf_abs_log",
                             data=_numpy(state.wf_abs_log))
        group.create_dataset("energy", data=_numpy(state.energy))
        group.create_dataset("move_stat",
                             data=_numpy(state.move_stat))
        group.attrs.update({"num_walkers": state.pos.shape[0]})

    def load_state(self, group: "h5py.Group", proc_inst=None,
                   device="cuda") -> vmc_sampler.State:
        """The chain state on ``device``.  A stored state has no S(k)
        or OBDM parts: the sampler computes them where it carries
        them."""
        def state(pos, wf_abs_log, energy, move_stat):
            return vmc_sampler.state_from_numpy(types.SimpleNamespace(
                pos=pos, wf_abs_log=wf_abs_log, energy=energy,
                move_stat=move_stat), device=device)

        sys_conf = group.get("sys_conf")[()]
        if "wf_abs_log" not in group:
            # Legacy reference layout: a single ``(2, N)`` configuration
            # with ``wf_abs_log``/``move_stat`` stored as group attrs and
            # no energy (``qmc_exec/vmc/io.py:37-58``).  Recompute the
            # energy from the model so the resumed chain has a complete
            # state.
            attrs = dict(group.attrs.items())
            pos = np.asarray(sys_conf[mrbp.SysConfSlot.pos])[np.newaxis]
            wf_abs_log = np.asarray(
                [attrs["wf_abs_log"]], dtype=pos.dtype)
            move_stat = np.asarray(
                [attrs.get("move_stat", 0)], dtype=bool)
            if proc_inst is not None:
                physical = mrbp.PhysicalFuncs(proc_inst.model_spec,
                                              device)
                energy = _numpy(physical.energy(pos))
            else:
                energy = np.full((1,), np.nan, dtype=pos.dtype)
            return state(pos, wf_abs_log, energy, move_stat)
        pos = sys_conf
        wf_abs_log = group.get("wf_abs_log")[()]
        energy = group.get("energy")[()]
        move_stat = group.get("move_stat")[()].astype(bool)
        return state(pos, wf_abs_log, energy, move_stat)

    def load_sampling_data(self, group: "h5py.Group"):
        return vmc_data.SamplingData.from_hdf5_data(group)

    def save_sampling_data(self, sampling_data, group: "h5py.Group"):
        sampling_data.hdf5_export(group)
