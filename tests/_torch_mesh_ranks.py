"""The rank bodies of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_moe_ep.py``: spawned rank processes import this module
by name, so it imports ``torch`` and the port only (no JAX). Weights and
batches come in as numpy (bf16 as its uint16 bit pattern); each body
returns host data gathered on rank 0 (``launch/mesh.spawn_ranks`` hands
rank 0's value back)."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.layers import moe as tmoe
from repro_torch.models.transformer import _to_torch
from repro_torch.optim import OptimConfig
from repro_torch.sharding import rules as sh
from repro_torch.sharding.collectives import all_reduce_

AXES = ("data", "model")


def to_torch(tree, device="cpu"):
    """A numpy tree (bf16 as uint16) as tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    return _to_torch(tree, device)


def to_numpy(tree):
    """A tensor tree as numpy (bf16 as uint16, bit-exact)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return tr.tree_map(one, tree)


def blocks_of(full, mesh):
    """(this rank's blocks of a whole tree, the tree's specs)."""
    with sh.use_rules(sh.rules_for_mesh(mesh)):
        specs = sh.tree_param_specs(full)
    blocks = tr.tree_map(lambda t, s: sh.shard_leaf(t, s, mesh).clone(), full, specs)
    return blocks, specs


def rank_train(backend, dev, shape, arch, cfg_over, params_np, batches, opt_kind, w_bits,
               microbatches=1, compress=False):
    """``len(batches)`` train steps of the reduced ``arch`` on a ``shape``
    mesh from the given weights: the losses and grad norms of every step,
    the whole updated tree, and the optimizer state's block shapes."""
    mesh = make_mesh(shape, AXES)
    cfg = dataclasses.replace(get_reduced(arch), **cfg_over)
    params, specs = blocks_of(to_torch(params_np, dev), mesh)
    opt = OptimConfig(kind=opt_kind, peak_lr=1e-3, total_steps=10)
    policy = PrecisionPolicy.uniform(w_bits, w_bits) if w_bits else PrecisionPolicy.off()
    step_fn = make_train_step(cfg, opt, policy=policy, microbatches=microbatches,
                              compress_grads=compress, mesh=mesh, specs=specs)
    state = init_opt_state(cfg, opt, params, compress)
    losses, gnorms = [], []
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, state, m = step_fn(params, state, batch, i)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    full = to_numpy(sh.gather_tree(params, specs, mesh, to="cpu"))
    return {"losses": losses, "gnorms": gnorms, "params": full,
            "state_shapes": [tuple(t.shape) for t in tr.leaves(state)]}


def rank_train_cases(backend, dev, cases):
    """:func:`rank_train` for each case (a dict of its arguments) in turn,
    on meshes of this world."""
    return [rank_train(backend, dev, **case) for case in cases]


def _rows(x, mesh, seq_sharded):
    """This rank's block of a (B, S, d) batch: its rows over data (where
    they divide), its sequence block over model with ``seq_sharded``."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    if x.shape[0] % d == 0:
        n = x.shape[0] // d
        x = x[mesh.coord("data") * n:(mesh.coord("data") + 1) * n]
    if seq_sharded:
        n = x.shape[1] // m
        x = x[:, mesh.coord("model") * n:(mesh.coord("model") + 1) * n]
    return x


def _gather_rows(t, mesh, seq_sharded, whole_rows):
    if seq_sharded:
        t = sh.gather_leaf(t, sh.P(None, "model"), mesh)
    if whole_rows:
        t = sh.gather_leaf(t, sh.P("data"), mesh)
    return t


def rank_moe(backend, dev, shape, params_np, x_np, n_experts, top_k, cf, seq_sharded, w_bits):
    """``moe_apply_gshard`` on a ``shape`` mesh (its expert-parallel
    branch, QAT gradients on): the whole output, the aux loss, the kept
    copies (summed over the model row and the data column), and the whole
    gradients of ``mean(out^2) + 0.01 * aux`` with respect to x and the
    layer's parameters."""
    mesh = make_mesh(shape, AXES)
    full = to_torch({"moe": params_np}, dev)
    blocks, specs = blocks_of(full, mesh)
    blocks = tr.tree_map(lambda t: t.detach().requires_grad_(), blocks)
    x_full = to_torch(x_np, dev)
    x = _rows(x_full, mesh, seq_sharded).detach().requires_grad_()
    policy = PrecisionPolicy.uniform(w_bits, w_bits, keep_dense=("router",)) if w_bits \
        else PrecisionPolicy.off()
    with tmoe.record_drops() as log:
        out, aux = tmoe.moe_apply_gshard(blocks["moe"], x, n_experts=n_experts, top_k=top_k,
                                         policy=policy, training=True, capacity_factor=cf,
                                         mesh=mesh, seq_sharded=seq_sharded)
    # this rank's term of mean(out^2): its rows' share (the model row holds
    # the same rows unless the sequence is sharded)
    whole_rows = x_full.shape[0] % mesh.shape["data"] == 0
    n_total = x_full.numel()
    term = torch.sum(out.to(torch.float32) ** 2) / n_total
    if not whole_rows:
        term = term / mesh.shape["data"]
    loss = term + 0.01 * aux
    leaves = [x] + tr.leaves(blocks)
    grads = torch.autograd.grad(loss, leaves)
    g_x = _gather_rows(grads[0], mesh, seq_sharded, whole_rows)
    g_params = sh.gather_tree(tr.unflatten_like(blocks, list(grads[1:])), specs, mesh)
    # each copy is dropped on the rank of its expert; the data column
    # holds other rows only when they are split over it
    dropped = sum(d for _, _, d in log)
    dropped = all_reduce_(torch.as_tensor(dropped, dtype=torch.int64, device=dev).clone(),
                          mesh.group(("data", "model") if whole_rows else ("model",)))
    n_copies = sum(n for _, n, _ in log) * (mesh.shape["data"] if whole_rows else 1)
    out_full = _gather_rows(out.detach(), mesh, seq_sharded, whole_rows)
    return {"out": to_numpy(out_full), "aux": float(aux.detach()), "kept": n_copies - int(dropped),
            "g_x": to_numpy(g_x), "g_params": to_numpy(g_params)["moe"]}


def rank_world(backend, dev, shape):
    """The mesh's layout seen from every rank: (rank, coords, the group
    ranks of each axis), gathered on rank 0."""
    mesh = make_mesh(shape, AXES)
    me = [dist.get_rank(), mesh.coord("data"), mesh.coord("model")]
    for ax in (("data",), ("model",), ("data", "model")):
        g = mesh.group(ax)
        me.append(-1 if g is None else dist.get_world_size(g))
        me.append(mesh.index(ax))
    t = torch.tensor(me, dtype=torch.int64)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    try:
        make_mesh((shape[0] * 2, shape[1]), AXES)
        too_big = None
    except RuntimeError as e:
        too_big = str(e)
    return {"rows": [o.tolist() for o in out], "too_big": too_big}


def rank_fail_on_rank0(backend, dev, run, at_step):
    """``run`` (a ``TrainRun``) as this rank of the world, with rank 0's
    step ``at_step`` failing before its first collective while the other
    ranks enter theirs."""
    import repro_torch.launch.train as train_mod

    real = train_mod.make_train_step

    def make(*args, **kwargs):
        step_fn = real(*args, **kwargs)

        def step(params, opt_state, batch, i):
            if i == at_step and dist.get_rank() == 0:
                raise RuntimeError("injected failure on rank 0")
            return step_fn(params, opt_state, batch, i)

        return step

    train_mod.make_train_step = make
    return run.run()


def rank_train_runs(backend, dev, runs, compare=None, watchdog_s=None):
    """Each of ``runs`` (name -> a ``TrainRun``; its ``model_axis`` lays
    this world out, one rank a world of one device) trained in turn as
    this rank, from a clean card (its peak reset). Returns rank 0's host
    data per run: losses, grad norms, step ms, the mesh, each rank's card
    peak and resident GiB, the traced step's ranges. ``compare`` (a pair
    of names of runs that gather their parameters): whether their whole
    trees are bit-equal, compared here so the trees stay in the rank.
    ``watchdog_s``: a run that takes longer makes every rank print its
    stacks and exit (a hung collective then fails with its place)."""
    import faulthandler
    import gc

    out, trees = {}, {}
    cuda = dev.type == "cuda"
    for name, run in runs.items():
        if watchdog_s:  # re-armed for each run
            faulthandler.dump_traceback_later(watchdog_s, exit=True)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        run = dataclasses.replace(run, device=str(dev))
        got = run.run()
        timings = got.get("timings", run.timings)
        memory = got.get("rank_memory") or ([{
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "resident_gib": timings["resident_bytes"] / 2**30}] if cuda else None)
        if compare and name in compare:
            trees[name] = got["params"]
        out[name] = {"losses": got["losses"], "grad_norms": got["grad_norms"],
                     "step_ms": timings["step_ms"], "mesh": got.get("mesh"),
                     "memory_gib": memory, "traced_step": timings.get("profile")}
        del got
    if compare:
        a, b = (trees[n] for n in compare)
        out["bit_equal"] = None if a is None else all(
            torch.equal(x, y) for x, y in zip(tr.leaves(a), tr.leaves(b)))
    if watchdog_s:
        faulthandler.cancel_dump_traceback_later()
    return out


def rank_collectives(backend, dev, cases, arch, batch_np):
    """One sharded train step of the reduced ``arch`` for each case
    ``(mesh shape, config override, whole weights as numpy)`` with the
    collective recorder on: every recorded call ``(kind, operand bytes,
    group size, range name)`` in order, per case."""
    from repro_torch.sharding.collectives import recording

    out = []
    for shape, cfg_over, params_np in cases:
        mesh = make_mesh(shape, AXES)
        cfg = dataclasses.replace(get_reduced(arch), **cfg_over)
        params, specs = blocks_of(to_torch(params_np, dev), mesh)
        opt = OptimConfig(kind="adamw", peak_lr=1e-3, total_steps=10)
        step_fn = make_train_step(cfg, opt, mesh=mesh, specs=specs)
        state = init_opt_state(cfg, opt, params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        calls = []
        with recording(lambda *c: calls.append(c)):
            step_fn(params, state, batch, 0)
        out.append(calls)
    return out
