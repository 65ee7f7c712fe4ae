"""End-to-end training driver: train a small LM for a few hundred steps
through the full stack — data pipeline, quantized linears (QAT at the
policy's bit-widths), AdamW, checkpoint/restart, straggler detection — and
verify the loss actually falls.

Default is a fast ~7M-parameter llama-family model (CPU-friendly);
``--model-100m`` selects a ~100M-parameter config (the deliverable-scale
run; hours on a laptop CPU, minutes on one GPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--steps 300]
          [--model-100m] [--qat-bits 8] [--ckpt /tmp/tiny_ckpt] [--resume]
          [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.train import TrainRun
from repro_torch.models.config import ModelConfig


def tiny_7m() -> ModelConfig:
    return ModelConfig(
        name="tiny-7m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, head_dim=32, d_ff=768, vocab_size=4096,
    )


def lm_100m() -> ModelConfig:
    # ~100M params: 12L, d=768, llama-style (GQA 12H/kv4, SwiGLU 2048)
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
    )


def train_tiny_lm(cfg, device, *, params=None, steps: int = 300, batch: int = 8,
                  seq: int = 256, lr: float = 1e-3, qat_bits: int = 0, ckpt=None,
                  resume: bool = False) -> dict:
    """Train ``cfg`` on ``device`` through ``TrainRun`` (from ``params``,
    an initial tree in the reference's layout, or its seed-0 draw), with
    checkpoints every 100 steps under ``ckpt``. Returns ``TrainRun.run``'s
    result with the mean loss of the first and of the last ten steps
    (``first``, ``last``) and the run's ``timings``."""
    device = torch.device(device)
    n = cfg.param_count()
    print(f"[tiny-lm] {cfg.name}: {n/1e6:.1f}M params, "
          f"{steps} steps, batch {batch} x seq {seq}, "
          f"devices={torch.cuda.device_count()}")

    policy = (
        PrecisionPolicy.uniform(qat_bits, qat_bits, keep_dense=("lm_head", "embed"))
        if qat_bits else PrecisionPolicy.off()
    )
    run = TrainRun(
        cfg=cfg,
        steps=steps,
        global_batch=batch,
        seq_len=seq,
        peak_lr=lr,
        policy=policy,
        ckpt_dir=ckpt,
        ckpt_every=100,
        log_every=20,
        device=str(device),
        initial_params=params,
    )
    out = run.run(resume=resume)

    first = sum(out["losses"][:10]) / max(len(out["losses"][:10]), 1)
    last = sum(out["losses"][-10:]) / max(len(out["losses"][-10:]), 1)
    print(f"[tiny-lm] loss {first:.3f} -> {last:.3f} "
          f"({out['steps_per_s']:.2f} steps/s)")
    assert last < first, "loss did not fall — training is broken"
    print("[tiny-lm] OK: loss fell through the full QAT stack")
    out.update(first=first, last=last, timings=run.timings)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--qat-bits", type=int, default=0,
                    help="train with fake-quant at this width (0 = dense)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = lm_100m() if args.model_100m else tiny_7m()
    return train_tiny_lm(cfg, device, steps=args.steps, batch=args.batch, seq=args.seq,
                         lr=args.lr, qat_bits=args.qat_bits, ckpt=args.ckpt,
                         resume=args.resume)


if __name__ == "__main__":
    main()
