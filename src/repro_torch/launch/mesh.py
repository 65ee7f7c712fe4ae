"""Rank meshes over ``torch.distributed`` (the port of
``src/repro/launch/mesh.py``).

Where the reference lays JAX devices out as a named ``Mesh`` and lets
GSPMD or ``shard_map`` place the work, the port runs one process per
rank: the ranks of the default process group are the devices.

* :func:`make_mesh`, :func:`make_host_mesh` and
  :func:`make_production_mesh` lay the ranks out as a :class:`Mesh`:
  rank ``r`` sits where ``np.arange(n).reshape(shape)`` holds ``r`` (on a
  ``(data, model)`` mesh at ``(r // model, r % model)``), with one process
  group for each row, each column and each other set of axes. A mesh
  larger than the world raises, as the reference's does. Training runs on
  these (``sharding/rules.py``, ``sharding/fsdp.py``).
* :func:`init_tp_group` and :func:`tp_context` give tensor-parallel
  serving its one-axis ``("model",)`` group (the counterpart of
  ``make_tp_mesh``).
* :func:`spawn_ranks` starts a world of ranks, each a process: rank ``r``
  on ``cuda:r`` over NCCL, or every rank on ``cuda:0`` over gloo
  (``share_device``: NCCL refuses two ranks on one card), or on the CPU
  over gloo. A rank that fails aborts its group (:func:`abort_world`)
  rather than wait on a peer. The ranks rendezvous through a
  ``FileStore``, so no port is opened and nothing leaves the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import pickle
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding.tp import TPContext

#: how long a rank waits in the rendezvous or in one collective
TIMEOUT = datetime.timedelta(seconds=600)


# --------------------------------------------------------------------------
# Meshes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named layout of ranks: ``devices`` holds the rank ids in the
    mesh's shape, ``axis_names`` names its axes. ``rank`` is this
    process's rank (None when it lies outside the mesh). ``groups`` maps
    each set of axes (a frozenset) to the process group of the ranks that
    share this rank's coordinates on every other axis; a set whose extent
    is 1 has no group (its collectives are the identity)."""

    devices: np.ndarray
    axis_names: tuple
    rank: Optional[int] = 0
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        """Axis name -> extent, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coord(self, axis: str) -> int:
        """This rank's index on ``axis``."""
        where = np.argwhere(self.devices == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} lies outside the mesh {self.devices.shape}")
        return int(where[0][self.axis_names.index(axis)])

    def extent(self, axes) -> int:
        """The product of the extents of ``axes`` (a name, a tuple or None)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        """The process group over ``axes`` (None when its extent is 1)."""
        if isinstance(axes, str):
            axes = (axes,)
        return self.groups.get(frozenset(axes))

    def index(self, axes) -> int:
        """This rank's position within its group over ``axes`` (row-major
        over the axes in mesh order)."""
        if isinstance(axes, str):
            axes = (axes,)
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.coord(a)
        return idx


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh(shape, axes) -> Mesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    world, rank = _world()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {world} "
            "(start the ranks with launch/mesh.spawn_ranks)"
        )
    devices = np.arange(n).reshape(shape)
    groups = {}
    # every rank creates every group in the same order (new_group is
    # collective over the default group), and keeps the ones it is in
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            if math.prod(shape[i] for i in sub) == 1:
                continue
            rest = [i for i in range(len(axes)) if i not in sub]
            moved = np.moveaxis(devices, list(sub), list(range(len(rest), len(axes))))
            members = moved.reshape(-1, math.prod(shape[i] for i in sub))
            for ranks in members:
                ranks = [int(r) for r in ranks]
                if len(ranks) == world:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(ranks, timeout=TIMEOUT)
                if rank in ranks:
                    groups[frozenset(axes[i] for i in sub)] = g
    return Mesh(devices=devices, axis_names=axes, rank=rank if rank < n else None,
                groups=groups)


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh (tests, elastic re-meshing): ``shape`` and ``axes``
    are parallel tuples, e.g. ``make_mesh((4, 2), ("data", "model"))``.
    Raises ``RuntimeError`` when the world has fewer than ``prod(shape)``
    ranks (outside a process group the world is this one process)."""
    return _mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """Mesh over every rank of the world, shaped ``(world // model,
    model)`` as ``("data", "model")``."""
    world, _ = _world()
    return _mesh((max(world // model, 1), model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's deployment mesh: ``("data", "model")`` of 16 x 16,
    or ``("pod", "data", "model")`` of 2 x 16 x 16 (pure data parallelism
    across pods). It needs a world of 256 (512) ranks."""
    return _mesh(*production_shape(multi_pod))


def make_dry_mesh(shape, axes, rank: int = 0) -> Mesh:
    """A mesh of ``shape`` for a dry run (``launch/dryrun.py``), with no
    process group: rank ``rank``'s groups are ``sharding/collectives.DryGroup``
    stand-ins, one for each set of axes whose extent exceeds 1 (its size
    and this rank's index in it), so the collectives record their calls
    and return outputs of the right shape without communicating."""
    from repro_torch.sharding.collectives import DryGroup

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    layout = Mesh(devices=np.arange(math.prod(shape)).reshape(shape), axis_names=axes,
                  rank=rank)
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            n = layout.extent(sub)
            if n > 1:
                groups[frozenset(sub)] = DryGroup(n, layout.index(sub))
    return dataclasses.replace(layout, groups=groups)


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axes) of the reference's deployment mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


# --------------------------------------------------------------------------
# Starting ranks
# --------------------------------------------------------------------------


def _init_world(world: int, rank: int, store_dir: str, backend: str) -> None:
    store = dist.FileStore(os.path.join(store_dir, "tp_store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)


def init_tp_group(model_parallel: int, rank: int, store_dir: str,
                  backend: str = "gloo") -> TPContext:
    """Join the default process group of ``model_parallel`` ranks as
    ``rank``: the ranks rendezvous through a ``FileStore`` in ``store_dir``
    (the same directory for every rank, fresh for every group). Returns the
    group's :class:`TPContext`."""
    _init_world(model_parallel, rank, store_dir, backend)
    return TPContext(size=model_parallel, rank=rank)


def tp_context() -> TPContext:
    """The :class:`TPContext` of the default process group (a rank body
    started by :func:`spawn_ranks` for tensor-parallel serving)."""
    return TPContext(size=dist.get_world_size(), rank=dist.get_rank())


def abort_world() -> None:
    """End this process's part in the default group at once, without a
    collective and without waiting on a peer (NCCL's communicators are
    aborted, not drained). A rank whose work failed while its peers may be
    inside a collective it will never join calls this and raises: the
    peers' collectives then fail, and :func:`spawn_ranks` ends the ranks
    still running."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if abort is None:
        dist.destroy_process_group()
    else:
        abort()


def _rank_main(rank, fn, world, device, share_device, backend, store_dir, args, result_path):
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device")
        dev = torch.device("cuda", 0 if share_device else rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)  # the ranks share the host's cores
    _init_world(world, rank, store_dir, backend)
    try:
        out = fn(backend, dev, *args)
        dist.barrier()
    except BaseException:
        abort_world()  # a peer may wait in a collective: do not drain it
        raise
    dist.destroy_process_group()
    if rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)


def spawn_ranks(fn: Callable, world: int, *, device: str = "cuda", share_device: bool = False,
                args: tuple = (), store_dir: Optional[str] = None) -> Any:
    """Run ``fn(backend, device, *args)`` on a world of ``world`` ranks,
    each a process started with ``spawn`` with the default process group
    initialised, and return rank 0's result (pickled back). ``fn`` must be
    importable by name (a module-level function); it lays the world out
    with :func:`make_mesh` or :func:`make_host_mesh` (a ``(data, model)``
    mesh of ``data * model`` ranks), or takes :func:`tp_context` for
    tensor-parallel serving. On ``device="cuda"`` rank ``r`` takes
    ``cuda:r`` over NCCL, or with ``share_device`` every rank ``cuda:0``
    over gloo; on the CPU the ranks use gloo. The result must be host data
    (no CUDA tensor). The ranks rendezvous in a fresh temporary directory
    under ``store_dir`` (default: the system's temporary directory). A rank
    that raises aborts its group (:func:`abort_world`); the others are then
    ended and the error is raised here."""
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and not share_device and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"{world} ranks need {world} CUDA devices, found {torch.cuda.device_count()}"
        )
    backend = "nccl" if on_cuda and not share_device else "gloo"
    # a fresh directory per group: a FileStore file outlives its group
    with tempfile.TemporaryDirectory(prefix="tp_", dir=store_dir) as where:
        result_path = os.path.join(where, "rank0_result.pkl")
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(fn, world, device, share_device, backend, where, args, result_path))
        with open(result_path, "rb") as f:
            return pickle.load(f)
