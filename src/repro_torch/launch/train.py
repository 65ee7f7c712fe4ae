"""The trainer's entry point: the train step, the data pipeline, checkpoints with
resume, step retry and straggler detection.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt

Runs on the GPU unless ``--device cpu`` (``device="cpu"``) is given;
without a GPU the default is an error. Parameters come from the port's
``init_params`` (a ``torch.Generator`` seeded with ``seed``) and are held
in the reference's tree (``models.transformer.stack_layers``), so the
optimizer state and the checkpoints line up leaf for leaf with the
reference trainer's: a checkpoint either writes, the other resumes.

With ``--model-axis M`` (``TrainRun(model_axis=M)``) or more than one
rank, it trains on a ``(data, model)`` mesh of ranks, as the reference
does on its host mesh: ``data * model`` processes (``TrainRun.ranks``;
default: the cards there are, or on the CPU ``M`` ranks), rank ``r`` on
``cuda:r`` over NCCL or on the host over gloo; a process that is already
a rank of a group (``launch/mesh.spawn_ranks``; gloo ranks may share one
card) trains as that rank. Each rank draws the parameters
part by part and keeps its blocks (``sharding/rules.py``), holds its
blocks of the optimizer state, and takes its rows of every microbatch;
the step is ``sharding/fsdp.py``'s (FSDP over data, tensor and expert
parallel over model). A checkpoint is the reference's whole tree,
gathered on rank 0 and written there, so it resumes on any mesh
(``runtime.ElasticMesh``) and in either package. The straggler detector
runs on rank 0's step time, broadcast, so every rank takes the same host
decisions. A step is not retried on a mesh: a rank whose step fails may
leave its peers inside a collective it never joins, so it aborts the
process group and raises (``launch/mesh.abort_world``); the peers'
collectives fail, the launcher ends them, and the run resumes from its
last checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch.mesh import abort_world
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.models.transformer import init_params, stack_layers
from repro_torch.optim import OptimConfig, state_specs
from repro_torch.runtime import ElasticMesh, StragglerDetector, retry_step
from repro_torch.sharding import rules as sh


def init_blocks(cfg, gen, dev, mesh):
    """This rank's blocks of the parameters drawn part by part from ``gen``
    on ``dev``, each part cut to the rank's blocks as it is drawn (the
    whole tree is never held), in the reference's tree; and their specs.
    Under the mesh's rules (``sharding.rules.use_rules``)."""
    specs = {}

    def keep(part, path):
        pairs = tr.flatten_with_path(part)
        sp = [sh.param_spec(f"{path}/{tr.path_key(p)}", leaf) for p, leaf in pairs]
        specs[path] = tr.unflatten_like(part, sp)
        return tr.unflatten_like(part, [sh.shard_leaf(leaf, s, mesh).clone()
                                        for (_, leaf), s in zip(pairs, sp)])

    params = init_params(cfg, gen, device=dev, each=keep)
    spec_tree = {k: specs[f"/{k}"] for k in params if k != "layers"}
    spec_tree["layers"] = [specs[cfg.param_path(i)] for i in range(cfg.n_layers)]
    return stack_layers(cfg, params), _stack_specs(cfg, spec_tree)


@dataclasses.dataclass
class TrainRun:
    """Programmatic entry point; the reference's fields, plus ``device``."""

    cfg: object
    steps: int = 20
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    policy: PrecisionPolicy = dataclasses.field(default_factory=PrecisionPolicy.off)
    compress_grads: bool = False
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    model_axis: int = 1
    seed: int = 0
    log_every: int = 10
    device: str | None = None
    #: the ranks of a mesh run (None: the cards there are, or on the CPU
    #: ``model_axis``)
    ranks: int | None = None
    #: whether a mesh run gathers the trained parameters for its result
    gather_params: bool = True
    #: a mesh run's step traced under ``torch.profiler`` (left out of
    #: ``step_ms``): ``timings["profile"]`` holds its ranges' times
    profile_step: int | None = None
    #: the dtype the microbatch gradients sum in (``make_train_step``)
    grad_accum_dtype: object = torch.float32
    #: the initial parameters in the reference's tree (one device only;
    #: None: drawn from ``seed``), e.g. the reference's own, carried
    initial_params: dict | None = None

    def world(self) -> int:
        """The ranks this run trains on (1: the single-device trainer)."""
        if self.ranks is not None:
            return self.ranks
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        if resolve_device(self.device).type == "cuda":
            return torch.cuda.device_count()
        return self.model_axis

    def run(self, resume: bool = True) -> dict:
        """Train to ``steps`` (from the latest checkpoint with ``resume``).
        Returns the reference's dict: ``params`` (the reference's tree),
        ``losses`` (this run's steps), ``final_loss``, ``steps_per_s`` and
        ``stragglers``, and ``grad_norms``. Afterwards ``self.timings``
        holds the step times (``step_ms``: CUDA events on the card, the
        host clock elsewhere), ``restore_s``, the checkpoint manager's
        ``saves`` and, on the card, ``resident_bytes`` (what the parameters
        and the optimizer state took of the card: allocated bytes after
        their creation less those before).

        On a mesh (module docstring) the ranks are started here, unless
        this process is already a rank of an initialised process group,
        which then trains as its rank; the result is rank 0's, ``params``
        the whole tree on rank 0's host (None on the other ranks, and
        without ``gather_params``), with
        ``mesh``, ``timings`` and, on the card, ``rank_memory`` (each rank's
        card peak and resident GiB)."""
        world = self.world()
        if world % self.model_axis:
            raise ValueError(f"{world} ranks do not divide into model_axis={self.model_axis}")
        if world == 1:
            return self._train(resume, mesh=None)
        if dist.is_available() and dist.is_initialized():
            return self._train(resume, mesh=ElasticMesh(self.model_axis).mesh_for(world))
        from repro_torch.launch.mesh import spawn_ranks

        out = spawn_ranks(_train_rank, world, device=resolve_device(self.device).type,
                          args=(self, resume))
        self.timings = out.pop("timings")
        return out

    def _init_blocks(self, cfg, dev, mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        return init_blocks(cfg, gen, dev, mesh)

    def _train(self, resume: bool, mesh) -> dict:
        """The training loop of one device (``mesh`` None) or of this rank
        of ``mesh``."""
        cfg = self.cfg
        dev = resolve_device(self.device)
        lead = mesh is None or dist.get_rank() == 0
        opt_cfg = OptimConfig(
            kind=self.optimizer, peak_lr=self.peak_lr, total_steps=max(self.steps, 2)
        )
        pipeline = DataPipeline(
            DataConfig(
                seq_len=self.seq_len,
                global_batch=self.global_batch,
                vocab_size=cfg.vocab_size,
                seed=self.seed,
            ),
            dp_rank=0,
            dp_size=1,  # the global batch; on a mesh each rank takes its rows
        )
        mgr = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        self.timings = {"step_ms": [], "restore_s": None, "saves": []}
        before = _allocated(dev)

        if mesh is None and self.initial_params is not None:
            params, specs = tr.tree_map(lambda t: t.to(dev), self.initial_params), None
        elif mesh is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.seed)
            params, specs = stack_layers(cfg, init_params(cfg, gen, device=dev)), None
        elif self.initial_params is not None:
            raise ValueError("initial_params trains on one device, not on a mesh")
        else:
            with sh.use_rules(sh.rules_for_mesh(mesh)):
                params, specs = self._init_blocks(cfg, dev, mesh)
        opt_state = init_opt_state(cfg, opt_cfg, params, self.compress_grads)
        if before is not None:
            self.timings["resident_bytes"] = _allocated(dev) - before
        place = all_specs = None
        if mesh is not None:
            o_specs = dict(state_specs(self.optimizer, params, specs))
            if self.compress_grads:
                o_specs["_gc_error"] = specs
            all_specs = {"params": specs, "opt": o_specs}
            spec_of = {tr.path_key(p): s for p, s in tr.flatten_with_path(all_specs)}
            place = lambda key, arr: ElasticMesh.place(arr, spec_of[key], mesh)  # noqa: E731
        start_step = 0
        if mgr and resume and mgr.latest_step() is not None:
            t0 = time.perf_counter()
            state, meta = mgr.restore({"params": params, "opt": opt_state}, place=place)
            self.timings["restore_s"] = time.perf_counter() - t0
            params, opt_state = state["params"], state["opt"]
            start_step = meta["step"] + 1
            if lead:
                print(f"[train] resumed from step {meta['step']}"
                      + ("" if mesh is None else f" on mesh {mesh.shape}"))

        step_fn = make_train_step(
            cfg,
            opt_cfg,
            policy=self.policy,
            microbatches=self.microbatches,
            compress_grads=self.compress_grads,
            mesh=mesh,
            grad_accum_dtype=self.grad_accum_dtype,
            specs=specs,
        )

        def mesh_step(params, opt_state, batch, step):
            # the peers may wait inside a collective this rank never joins:
            # no retry and no further collective, the group is aborted
            try:
                return step_fn(params, opt_state, batch, step)
            except BaseException as e:
                rank = dist.get_rank()
                abort_world()
                raise RuntimeError(f"train step {step} failed on rank {rank}; "
                                   "the process group was aborted") from e

        def save(step, block=False):
            state = {"params": params, "opt": opt_state}
            if mesh is not None:  # the whole tree, held by rank 0 only
                state = sh.gather_tree(state, all_specs, mesh, to="cpu", root=0)
            if lead:
                mgr.save(step, state, block=block)

        cuda = dev.type == "cuda"
        detector = StragglerDetector()
        losses, gnorms = [], []
        step = start_step
        t_train0 = time.time()
        while step < self.steps:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in pipeline.batch_at(step).items()}
            traced = step == self.profile_step
            prof = _tracer(cuda) if traced else contextlib.nullcontext()
            t0 = time.time()
            with prof:
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                if mesh is None:
                    params, opt_state, metrics = retry_step(step_fn, params, opt_state, batch,
                                                            step)
                else:
                    params, opt_state, metrics = mesh_step(params, opt_state, batch, step)
                if cuda:
                    ev[1].record()
                loss = float(metrics["loss"])
            gnorms.append(float(metrics["grad_norm"]))
            dt = time.time() - t0
            if mesh is not None:
                # rank 0's step time, so every rank flags the same stragglers
                dt_t = torch.tensor([dt], dtype=torch.float64, device=dev)
                dist.broadcast(dt_t, src=0)
                dt = float(dt_t)
            ms = ev[0].elapsed_time(ev[1]) if cuda else dt * 1e3
            if traced:  # the tracer's cost stays out of the step times
                self.timings["profile"] = dict(_range_times(prof), step_ms=ms)
            else:
                self.timings["step_ms"].append(ms)
            if not traced and detector.record(dt) and lead:
                print(f"[train] straggler step {step}: {dt:.3f}s "
                      f"(median {detector.median:.3f}s)")
            losses.append(loss)
            if step % self.log_every == 0 and lead:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.3f}s"
                      + ("" if mesh is None else f" mesh {mesh.shape}"))
            if mgr and self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                save(step)
            step += 1

        if mgr:
            save(self.steps - 1, block=True)
            if lead:
                mgr.wait()
                self.timings["saves"] = list(mgr.saves)
        wall = time.time() - t_train0
        out = {
            "params": params,
            "losses": losses,
            "final_loss": losses[-1] if losses else float("nan"),
            "steps_per_s": (self.steps - start_step) / max(wall, 1e-9),
            "stragglers": detector.flagged,
            "grad_norms": gnorms,
        }
        if mesh is None:
            return out
        memory = None
        if cuda:  # every rank's card peak and resident GiB, in rank order
            memory = [None] * dist.get_world_size()
            dist.all_gather_object(memory, {
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "resident_gib": self.timings["resident_bytes"] / 2**30})
        out.update(params=sh.gather_tree(params, specs, mesh, to="cpu", root=0)
                   if self.gather_params else None,
                   timings=self.timings, mesh=mesh.shape, rank_memory=memory)
        return out


#: the ranges of a traced step: the step's parts and the collectives
RANGES = ("train.grads", "train.clip", "train.update", "train.allgather",
          "train.reduce_scatter", "train.allreduce", "moe.ep_gather", "moe.ep_combine")


def _allocated(dev) -> int | None:
    """The card's allocated bytes (None on the host)."""
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def _tracer(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _range_times(prof) -> dict:
    """A traced step's times: for each of :data:`RANGES` its host ms (the
    sum of its spans on the host) and its device ms (the sum of its spans
    on the device timeline), and the device's kernel ms in all."""
    host = {r: 0.0 for r in RANGES}
    device = {r: 0.0 for r in RANGES}
    kernels = 0.0
    for e in prof.events():
        us = e.time_range.end - e.time_range.start
        on_device = e.device_type != torch.autograd.DeviceType.CPU
        if e.name in host:
            (device if on_device else host)[e.name] += us / 1e3
        elif on_device:
            kernels += us / 1e3
    return {"host_ms": host, "device_ms": device, "kernels_ms": kernels}


def _stack_specs(cfg, specs):
    """The spec tree of :func:`stack_layers`'s tree: a stacked leaf's spec
    has a leading (layer) entry of None."""
    if not cfg.scan_layers:
        return specs
    period, n_full = cfg.period_layout()
    layers = specs["layers"]
    out = {k: v for k, v in specs.items() if k != "layers"}
    out["periods"] = {
        f"b{j}_{kind}": tr.tree_map(lambda sp: sh.P(None, *sp), layers[j])
        for j, kind in enumerate(period)
    } if n_full else {}
    out["tail"] = list(layers[n_full * len(period):])
    return out


def _train_rank(backend, dev, run: TrainRun, resume: bool) -> dict:
    """One spawned rank of a mesh run (``launch/mesh.spawn_ranks``)."""
    return dataclasses.replace(run, device=str(dev)).run(resume)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="quantization-aware training")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--w-bits", type=int, default=0, help="QAT bits (0 = dense)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis (tensor and expert parallel)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' trains on the host)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model_axis < 1:
        raise SystemExit(f"[train] invalid flags: --model-axis {args.model_axis} < 1")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    policy = (
        PrecisionPolicy.uniform(args.w_bits, args.w_bits)
        if args.w_bits
        else PrecisionPolicy.off()
    )
    run = TrainRun(
        cfg=cfg,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        microbatches=args.microbatches,
        optimizer=args.optimizer,
        peak_lr=args.lr,
        policy=policy,
        compress_grads=args.compress_grads,
        ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every,
        model_axis=args.model_axis,
        device=args.device,
        gather_params=False,
    )
    out = run.run()
    print(f"[train] done: final loss {out['final_loss']:.4f}, "
          f"{out['steps_per_s']:.2f} steps/s, {len(out['stragglers'])} stragglers")
    return out


if __name__ == "__main__":
    main()
