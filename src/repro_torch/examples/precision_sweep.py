"""Layer-wise precision sweep — the paper's flexibility argument.

bitSMM's case against binarized NNs (§I) is that bit-serial hardware
lets *different layers run at different precisions*. This example
reproduces that argument end-to-end in the framework:

1. Uniform sweep w/a in {16, 8, 6, 4, 2, 1}: quality degrades gracefully
   while the analytic serial-cycle cost (Eq. 8) falls linearly with bits
   — the precision <-> latency dial.
2. Mixed policy: sensitive layers (first/last block, LM head) at 8 bits,
   the rest at 4 — the per-layer dial recovering most of the uniform-8
   quality at near-uniform-4 cost.
3. The *runtime* dial (plan API): quantize + decompose ONCE at 8 bits,
   then run the same weight tree at 8/6/4 via
   ``policy.with_runtime_bits`` — the execution plans
   (:mod:`repro_torch.core.plan`) consume only the top planes of the stored
   decomposition (MSB-prefix truncation, zero re-quantization), exactly
   the accelerator's effective-width register.

Quality metric: KL(dense || quantized) of next-token distributions on
random prompts (random-init weights; the *relative* ordering is what the
example demonstrates).

Run:  PYTHONPATH=src python -m repro_torch.examples.precision_sweep
          [--arch granite-3-8b] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_reduced
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.systolic import SAConfig, matmul_total_cycles
from repro_torch.examples import counted
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.serve import resolve_device
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import SeededParams, forward, init_params

UNIFORM_BITS = (16, 8, 6, 4, 2, 1)
DIAL_BITS = (8, 6, 4)
KEEP_DENSE = ("frontend", "router")


def sweep_config(cfg):
    """The layers unrolled, so per-layer-index overrides are addressable by
    name, and at least 4 deep, so "ends at 8, middle at 4" is
    non-degenerate."""
    return dataclasses.replace(cfg, scan_layers=False, n_layers=max(cfg.n_layers, 4))


def kl_from_dense(cfg, params, batch, dense_logits, policy, backend: str = "auto"):
    """(KL(dense || quantized) of the last position's next-token
    distributions, averaged over the batch; the quantized logits)."""
    logits, _, _ = forward(cfg, params, batch, policy=policy, backend=backend)
    p = torch.log_softmax(dense_logits[:, -1, : cfg.vocab_size].float(), dim=-1)
    q = torch.log_softmax(logits[:, -1, : cfg.vocab_size].float(), dim=-1)
    return float(torch.mean(torch.sum(torch.exp(p) * (p - q), dim=-1))), logits


def precision_sweep(cfg, params, device, *, backend: str = "auto") -> dict:
    """The sweep over ``cfg`` (already :func:`sweep_config`'s) and
    ``params`` on ``device``, every forward through ``backend``'s routes.
    Returns the KL and the serial cycles of each policy (``"w<bits>"``,
    ``"mixed"``, ``"dial-w<bits>"``), each policy's logits (``"dense"``
    too), route calls and kernel launches, and the plan registry's counts
    and truncation audit."""
    device = torch.device(device)
    batch = make_batch(cfg, 4, 64, "prefill", np.random.default_rng(7), device=device)
    dense, _, _ = forward(cfg, params, batch, backend=backend)
    out: dict = {"kl": {}, "cycles": {}, "logits": {"dense": dense}, "routes": {},
                 "launches": {}}

    def kl_of(name, tree, policy):
        (kl, out["logits"][name]), out["routes"][name], out["launches"][name] = counted(
            lambda: kl_from_dense(cfg, tree, batch, dense, policy, backend))
        out["kl"][name] = kl
        return kl

    sa = SAConfig(width=64, height=16)  # the paper's largest array
    n = 512  # nominal dot-product length for the cycle model

    reduced = cfg == sweep_config(get_reduced(cfg.name))
    what = "reduced" if reduced else f"{cfg.n_layers} layers"
    print(f"[sweep] {cfg.name} ({what}, unrolled): KL(dense||quant) vs bits")
    print(f"  {'policy':24s} {'KL':>9s}   {'serial cycles (Eq.8+readout)':>30s}")
    for bits in UNIFORM_BITS:
        pol = PrecisionPolicy.uniform(bits, bits, keep_dense=KEEP_DENSE)
        kl = kl_of(f"w{bits}", params, pol)
        cyc = out["cycles"][f"w{bits}"] = matmul_total_cycles(sa, n, bits)
        print(f"  uniform w{bits:<2d}a{bits:<13d} {kl:9.4f}   {cyc:>18,d}")

    # Mixed policy: 8-bit where it hurts, 4-bit elsewhere.
    last = cfg.n_layers - 1
    mixed = PrecisionPolicy.from_dict({
        "": (4, 4),
        r"layers/0/": (8, 8),
        rf"layers/{last}/": (8, 8),
        "lm_head": (8, 8),
        "frontend|router": (None, None),
    })
    kl = kl_of("mixed", params, mixed)
    # cost: 2 of n_layers' blocks at 8 bits, rest at 4
    c8, c4 = matmul_total_cycles(sa, n, 8), matmul_total_cycles(sa, n, 4)
    avg = out["cycles"]["mixed"] = int((2 * c8 + (cfg.n_layers - 2) * c4) / cfg.n_layers)
    print(f"  {'mixed 8/4 (ends at 8)':24s} {kl:9.4f}   {avg:>18,d}")
    print("[sweep] the mixed policy sits between uniform-4 cost and "
          "uniform-8 quality — the paper's layer-wise dial.")

    # 3. Runtime dial: one 8-bit decomposition, executed at 8/6/4 by
    # plane-prefix truncation (no re-quantization between rows).
    base = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                   keep_dense=KEEP_DENSE)
    q_params = quantize_params(params, base, cfg=cfg, plane_cache=True)
    print("[sweep] runtime dial: ONE stored 8-bit decomposition, truncated")
    print(f"  {'runtime bits':24s} {'KL':>9s}")
    for bits in DIAL_BITS:
        kl = kl_of(f"dial-w{bits}", q_params, base.with_runtime_bits(bits, bits))
        print(f"  w{bits} (truncated from 8){'':4s} {kl:9.4f}")
    del q_params
    # what the registry resolved the dialed matmuls to
    reg = plan_mod.DEFAULT_REGISTRY
    truncated = [p for p in reg.plans() if p.w_shift]
    if truncated:
        print("[sweep] example truncated plan:", truncated[0].describe())
    print(f"[sweep] plan registry: {len(reg)} plans, {reg.hits} hits / {reg.misses} misses")
    out.update(registry={"plans": len(reg), "truncated": len(truncated), "hits": reg.hits,
                         "misses": reg.misses},
               truncation_audit=plan_mod.truncation_audit())
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="granite-3-8b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = sweep_config(get_reduced(args.arch))
    params = init_params(cfg, SeededParams(0).generator(device), device=device)
    return precision_sweep(cfg, params, device)


if __name__ == "__main__":
    main()
