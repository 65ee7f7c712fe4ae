"""Process groups for tensor-parallel serving (the port's counterpart of
``make_tp_mesh``, ``src/repro/launch/mesh.py:65``).

Where the reference builds a one-axis ``("model",)`` device mesh and runs
its steps under ``shard_map``, the port runs one process per rank over a
``torch.distributed`` process group: :func:`init_tp_group` joins one
(rendezvous through a ``FileStore``, so no port is opened and nothing
leaves the host) and returns its :class:`~repro_torch.sharding.tp.TPContext`;
:func:`spawn_tp` starts the ranks and returns rank 0's result. Rank ``r``
runs on ``cuda:r`` over NCCL, or every rank on ``cuda:0`` over gloo
(``share_device``: NCCL refuses two ranks on one card), or on the CPU over
gloo. The data and production meshes of the reference's training path are
ROADMAP item 11b.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding.tp import TPContext

#: how long a rank waits in the rendezvous or in one collective
TIMEOUT = datetime.timedelta(seconds=600)


def init_tp_group(model_parallel: int, rank: int, store_dir: str,
                  backend: str = "gloo") -> TPContext:
    """Join the default process group of ``model_parallel`` ranks as
    ``rank``: the ranks rendezvous through a ``FileStore`` in ``store_dir``
    (the same directory for every rank, fresh for every group). Returns the
    group's :class:`TPContext`."""
    store = dist.FileStore(os.path.join(store_dir, "tp_store"), model_parallel)
    dist.init_process_group(backend, store=store, rank=rank, world_size=model_parallel,
                            timeout=TIMEOUT)
    return TPContext(size=model_parallel, rank=rank)


def _rank_main(rank, fn, model_parallel, device, share_device, backend, store_dir, args,
               result_path):
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", 0 if share_device else rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)  # P ranks share the host's cores
    tp = init_tp_group(model_parallel, rank, store_dir, backend)
    try:
        out = fn(tp, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)


def spawn_tp(fn: Callable, model_parallel: int, *, device: str = "cuda",
             share_device: bool = False, args: tuple = (), store_dir: Optional[str] = None):
    """Run ``fn(tp, device, *args)`` on ``model_parallel`` ranks, each a
    process started with ``spawn``, and return rank 0's result (pickled
    back). ``fn`` must be importable by name (a module-level function).
    On ``device="cuda"`` rank ``r`` takes ``cuda:r`` over NCCL, or with
    ``share_device`` every rank ``cuda:0`` over gloo; on the CPU the ranks
    use gloo. The result must be host data (no CUDA tensor). The ranks
    rendezvous in a
    fresh temporary directory under ``store_dir`` (default: the system's
    temporary directory). A rank that raises ends the others and raises
    here."""
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and not share_device and torch.cuda.device_count() < model_parallel:
        raise RuntimeError(
            f"model_parallel={model_parallel} needs {model_parallel} CUDA devices, found "
            f"{torch.cuda.device_count()}"
        )
    backend = "nccl" if on_cuda and not share_device else "gloo"
    # a fresh directory per group: a FileStore file outlives its group
    with tempfile.TemporaryDirectory(prefix="tp_", dir=store_dir) as where:
        result_path = os.path.join(where, "rank0_result.pkl")
        mp.spawn(_rank_main, nprocs=model_parallel, join=True,
                 args=(fn, model_parallel, device, share_device, backend, where, args,
                       result_path))
        with open(result_path, "rb") as f:
            return pickle.load(f)
