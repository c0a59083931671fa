"""Walker meshes: one process per device over a ``torch.distributed``
group.

Counterpart of ``phd_qmclib_tpu.parallel.mesh``.  The JAX package puts
one program on every chip of a 1-D mesh (``shard_map``); here every rank
is a process of its own that runs the same step on its shard of the
walker buffer, and the JAX package's ``psum`` over the walker axis
becomes :meth:`WalkerMesh.psum`: an ``all_gather`` of the shard's
partial, then a sum in rank order on every rank.  So every rank holds
the same bits, and the result depends neither on the backend nor on its
reduction algorithm: S ranks on one GPU over gloo compute what S GPUs
over NCCL compute.

:func:`make_walker_mesh` says where the ranks run (a
:class:`MeshSpec`), :func:`launch` runs a function on every rank and
hands each its :class:`WalkerMesh`.  Rank 0 runs in the caller's
process, ranks 1..n-1 in processes started with ``spawn``; they meet
through a ``FileStore`` in a fresh temporary directory (no TCP port),
and their transports bind to the loopback interface.  A rank that
raises or dies makes :func:`launch` raise, with the rank's traceback,
within the mesh's ``timeout``: every collective and every join is
bounded by it.  Nothing picks a backend for the caller but the rule of
:func:`make_walker_mesh`, and nothing falls back to another backend or
to fewer ranks.
"""
import os
import shutil
import tempfile
import time
import typing as t
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from ..samplers import dmc

__all__ = ["MeshSpec", "WalkerMesh", "launch", "make_walker_mesh"]

#: Seconds a collective, the rendezvous or the join of the ranks may take
#: before the run raises.
DEFAULT_TIMEOUT = 600.0

@dataclass(frozen=True)
class MeshSpec:
    """Where the ranks of a mesh run: ``devices[k]`` is rank ``k``'s
    device (one may repeat over gloo), ``backend`` the group's.  With
    ``rows`` above 1 the ranks form a ``(rows, size // rows)`` sweep mesh:
    rank ``r * W + w`` holds row ``r``'s walker shard ``w`` (see
    :meth:`WalkerMesh.row_mesh`)."""
    devices: t.Tuple[str, ...]
    backend: str
    rows: int = 1
    timeout: float = DEFAULT_TIMEOUT

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"unknown backend {self.backend!r} (gloo or "
                             f"nccl)")
        if self.rows < 1 or len(self.devices) % self.rows:
            raise ValueError(f"{len(self.devices)} devices do not split "
                             f"into {self.rows} sweep rows")
        if self.backend == "nccl":
            kinds = {torch.device(d).type for d in self.devices}
            if kinds != {"cuda"} \
                    or len(set(self.devices)) != len(self.devices):
                raise ValueError(
                    "nccl takes one rank per GPU: give distinct CUDA "
                    "devices, or backend='gloo' for several ranks on one "
                    "device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def walkers(self) -> int:
        """Walker shards per sweep row."""
        return self.size // self.rows


def make_walker_mesh(num_devices: t.Optional[int] = None,
                     device="cuda", *, devices=None,
                     backend: t.Optional[str] = None, rows: int = 1,
                     timeout: float = DEFAULT_TIMEOUT) -> MeshSpec:
    """A mesh of ``num_devices`` ranks (default: every device).

    On ``device="cuda"`` rank ``k`` runs on ``cuda:k`` over NCCL, and
    asking for more ranks than cards raises; on ``device="cpu"`` the
    ranks are processes on the CPU over gloo (the CPU counts as one
    device).  ``devices=[...]``, with ``backend`` named, places the ranks
    explicitly, a device as often as wanted over gloo: S ranks on one
    card.  ``rows`` and ``timeout`` as in :class:`MeshSpec`.
    """
    if devices is not None:
        if backend is None:
            raise ValueError("a mesh on an explicit device list needs its "
                             "backend named (backend='gloo' or 'nccl')")
        devices = tuple(str(torch.device(d)) for d in devices)
        if num_devices is not None and num_devices != len(devices):
            raise ValueError(f"requested {num_devices} devices, given "
                             f"{len(devices)}")
        return MeshSpec(devices, backend, rows, timeout)
    kind = torch.device(device).type
    if kind == "cuda":
        available = torch.cuda.device_count()
        num = available if num_devices is None else num_devices
        if num > available:
            raise ValueError(f"requested {num} devices, {available} "
                             f"available")
        devices = tuple(f"cuda:{k}" for k in range(num))
    elif kind == "cpu":
        num = 1 if num_devices is None else num_devices
        devices = ("cpu",) * num
    else:
        raise ValueError(f"no walker mesh on {device!r}")
    if num < 1:
        raise ValueError(f"a mesh needs at least one device, not {num}")
    return MeshSpec(devices, backend or ("nccl" if kind == "cuda"
                                         else "gloo"), rows, timeout)


@dataclass(frozen=True, eq=False)
class WalkerMesh:
    """One rank's view of a mesh: its ``rank`` among the ``size`` ranks
    of ``group`` (``None``: the default group) and its ``device``.  A
    sweep mesh also holds one subgroup per sweep row, ``row_groups``,
    made on every rank in the same order."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: t.Any = None
    rows: int = 1
    row_groups: t.Tuple[t.Any, ...] = field(default=(), repr=False)

    def all_gather(self, x: torch.Tensor) -> t.List[torch.Tensor]:
        """Every rank's ``x`` (of one shape and dtype), in rank order."""
        x = x.contiguous()
        # The transports move bytes: a bool goes as uint8.
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        if x.dtype == torch.bool:
            parts = [p.to(torch.bool) for p in parts]
        return parts

    def cat(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated on the first axis, in rank
        order."""
        return torch.cat(self.all_gather(x))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' ``x``, in rank order, the same bits on
        every rank."""
        parts = self.all_gather(x)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`psum` over the number of ranks."""
        return self.psum(x) / self.size

    def gather_state(self, state):
        """The global view of a DMC state whose walker tensors are this
        rank's shard: the shards' walker tensors in rank order, the
        shards' counts as a ``(size,)`` ``num_walkers``; the ensemble
        scalars, the same on every rank, as this rank has them."""
        fields = {name: (self.cat(getattr(state, name))
                         if name in dmc.WALKER_FIELDS
                         and getattr(state, name) is not None
                         else getattr(state, name))
                  for name in state._fields}
        fields["num_walkers"] = torch.stack(self.all_gather(
            state.num_walkers.reshape(())))
        return type(state)(**fields)

    @property
    def row(self) -> int:
        """This rank's sweep row."""
        return self.rank // (self.size // self.rows)

    def row_mesh(self) -> t.Optional["WalkerMesh"]:
        """This rank's view of its sweep row's walker mesh, over the
        row's subgroup; ``None`` when the row has one shard (it then runs
        unsharded, as its standalone run does)."""
        walkers = self.size // self.rows
        if walkers == 1:
            return None
        return WalkerMesh(self.rank % walkers, walkers, self.device,
                          self.backend, self.row_groups[self.row])


def _bind_loopback() -> None:
    """Keep every transport on the loopback interface: the ranks are
    processes of one host."""
    for name in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(name, "lo")


def _join_mesh(rank: int, spec: MeshSpec, store_dir: str) -> WalkerMesh:
    """Join the group of ``spec`` as ``rank``: this process's
    :class:`WalkerMesh`."""
    device = torch.device(spec.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _bind_loopback()
    timeout = timedelta(seconds=spec.timeout)
    store = dist.FileStore(os.path.join(store_dir, "store"), spec.size)
    dist.init_process_group(spec.backend, store=store, rank=rank,
                            world_size=spec.size, timeout=timeout)
    walkers = spec.walkers
    row_groups = ()
    if spec.rows > 1 and walkers > 1:
        # Every rank makes every row's group, in the same order.
        row_groups = tuple(
            dist.new_group([r * walkers + w for w in range(walkers)],
                           timeout=timeout)
            for r in range(spec.rows))
    return WalkerMesh(rank, spec.size, device, spec.backend, None,
                      spec.rows, row_groups)


def _run_rank(rank: int, fn, spec: MeshSpec, store_dir: str, args,
              kwargs):
    mesh = _join_mesh(rank, spec, store_dir)
    try:
        return fn(mesh, *args, **kwargs)
    finally:
        dist.destroy_process_group()


def _child(index: int, fn, spec: MeshSpec, store_dir: str, args) -> None:
    """Entry of the spawned rank ``index + 1``."""
    torch.set_num_threads(1)
    _run_rank(index + 1, fn, spec, store_dir, args, {})


def _reap(context, timeout: float):
    """The exception of a child that failed within ``timeout`` seconds
    (``None`` if none did); the children are terminated either way."""
    error = None
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                break
    except Exception as exc:  # ProcessRaisedException, ProcessExitedException
        error = exc
    for process in context.processes:
        if process.is_alive():
            process.terminate()
        process.join(5.0)
    return error


def launch(fn, spec: MeshSpec, *args, rank0_kwargs: t.Optional[dict] = None):
    """Run ``fn(mesh, *args)`` on every rank of ``spec`` and return rank
    0's result.

    Rank 0 runs in this process (it also gets ``rank0_kwargs``, which
    are not sent anywhere: a callback may go there); ranks 1..n-1 run in
    spawned processes, which import ``fn`` by its module path and unpickle
    ``args``: send arrays or CPU tensors, and let each rank move its part
    to its device.  The group is destroyed when ``fn`` returns.  If a
    rank raises or dies, or a rank outlives the others by ``timeout``,
    this raises (a child's failure as ``torch.multiprocessing``'s
    exception, with the child's traceback).  This process must not hold
    a default group already.
    """
    if dist.is_initialized():
        raise RuntimeError("launch makes its own process group; this "
                           "process already holds one")
    if any(torch.device(d).type == "cuda" for d in spec.devices):
        # Build the kernels once, before the ranks start.
        from ..ops import _build
        _build.build()
    store_dir = tempfile.mkdtemp(prefix="walker-mesh-")
    context = None
    try:
        if spec.size > 1:
            import torch.multiprocessing as mp
            context = mp.start_processes(
                _child, args=(fn, spec, store_dir, args),
                nprocs=spec.size - 1, join=False, start_method="spawn")
        try:
            result = _run_rank(0, fn, spec, store_dir, args,
                               rank0_kwargs or {})
        except BaseException:
            error = _reap(context, 5.0) if context is not None else None
            if error is not None:
                raise error
            raise
        if context is not None:
            deadline = time.monotonic() + spec.timeout
            while not context.join(timeout=max(
                    0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    _reap(context, 0.0)
                    raise TimeoutError(
                        f"a rank of the mesh outlived rank 0 by "
                        f"{spec.timeout} s")
        return result
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
