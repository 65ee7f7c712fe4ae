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
Tensor-parallel training (``--model-axis`` > 1) is ROADMAP item 11b.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.models.transformer import init_params, stack_layers
from repro_torch.optim import OptimConfig
from repro_torch.runtime import StragglerDetector, retry_step

MODEL_AXIS_REFUSAL = ("tensor-parallel training is not ported yet (ROADMAP.md, queue 1, "
                      "item 11b: tensor-parallel training)")


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

    def run(self, resume: bool = True) -> dict:
        """Train to ``steps`` (from the latest checkpoint with ``resume``).
        Returns the reference's dict: ``params`` (the reference's tree),
        ``losses`` (this run's steps), ``final_loss``, ``steps_per_s`` and
        ``stragglers``. Afterwards ``self.timings`` holds the step seconds
        (``step_ms``: CUDA events on the card, the host clock elsewhere),
        ``restore_s`` and the checkpoint manager's ``saves``."""
        if self.model_axis != 1:
            raise NotImplementedError(f"--model-axis {self.model_axis}: {MODEL_AXIS_REFUSAL}")
        cfg = self.cfg
        dev = resolve_device(self.device)
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
            dp_size=1,
        )
        mgr = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        self.timings = {"step_ms": [], "restore_s": None, "saves": []}

        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        params = stack_layers(cfg, init_params(cfg, gen, device=dev))
        opt_state = init_opt_state(cfg, opt_cfg, params, self.compress_grads)
        start_step = 0
        if mgr and resume and mgr.latest_step() is not None:
            t0 = time.perf_counter()
            state, meta = mgr.restore({"params": params, "opt": opt_state})
            self.timings["restore_s"] = time.perf_counter() - t0
            params, opt_state = state["params"], state["opt"]
            start_step = meta["step"] + 1
            print(f"[train] resumed from step {meta['step']}")

        step_fn = make_train_step(
            cfg,
            opt_cfg,
            policy=self.policy,
            microbatches=self.microbatches,
            compress_grads=self.compress_grads,
        )
        cuda = dev.type == "cuda"
        detector = StragglerDetector()
        losses = []
        step = start_step
        t_train0 = time.time()
        while step < self.steps:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in pipeline.batch_at(step).items()}
            t0 = time.time()
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            params, opt_state, metrics = retry_step(step_fn, params, opt_state, batch, step)
            if cuda:
                ev[1].record()
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.timings["step_ms"].append(ev[0].elapsed_time(ev[1]) if cuda else dt * 1e3)
            if detector.record(dt):
                print(f"[train] straggler step {step}: {dt:.3f}s "
                      f"(median {detector.median:.3f}s)")
            losses.append(loss)
            if step % self.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.3f}s")
            if mgr and self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                mgr.save(step, {"params": params, "opt": opt_state})
            step += 1

        if mgr:
            mgr.save(self.steps - 1, {"params": params, "opt": opt_state}, block=True)
            mgr.wait()
            self.timings["saves"] = list(mgr.saves)
        wall = time.time() - t_train0
        return {
            "params": params,
            "losses": losses,
            "final_loss": losses[-1] if losses else float("nan"),
            "steps_per_s": (self.steps - start_step) / max(wall, 1e-9),
            "stragglers": detector.flagged,
        }


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
                    help=f"must be 1: {MODEL_AXIS_REFUSAL}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' trains on the host)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model_axis != 1:
        raise SystemExit(f"[train] invalid flags: --model-axis: {MODEL_AXIS_REFUSAL}")
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
    )
    out = run.run()
    print(f"[train] done: final loss {out['final_loss']:.4f}, "
          f"{out['steps_per_s']:.2f} steps/s, {len(out['stragglers'])} stragglers")


if __name__ == "__main__":
    main()
