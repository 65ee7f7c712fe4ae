"""End-to-end quantized serving — the paper's own deployment scenario.

Weights are stored at the policy bit-width, activations quantize per
token at runtime, and every projection executes through a compile-once
:class:`repro_torch.core.plan.MatmulPlan`. Serves batched requests
(prefill + greedy decode) on the lockstep engine and demonstrates:

* precision as a RUNTIME knob: one engine, one 8-bit weight
  decomposition, decoded at 8/6/4 bits via ``engine.set_precision`` —
  the plans truncate the stored plane prefix, nothing is re-quantized;
* the two MAC variants producing IDENTICAL tokens (both are exact
  integer matmuls — paper §III);
* bit-plane vs digit level agreement at the same width.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_quantized
          [--arch yi-6b] [--batch 4] [--prompt-len 32] [--gen 24] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_reduced
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.examples import counted
from repro_torch.launch.serve import Engine, resolve_device
from repro_torch.models.transformer import SeededParams, init_params

KEEP_DENSE = ("frontend", "router")


def serve_quantized(cfg, params, device, *, batch: int = 4, prompt_len: int = 32,
                    gen: int = 24, backend: str = "auto") -> dict:
    """The scenario on ``device``: a dense engine, one Booth bit-plane
    engine dialed 8 -> 6 -> 4, a Booth digit and an SBMwC bit-plane engine,
    all through ``backend``'s routes (``"torch"``, the plain versions,
    decodes eagerly; else each precision's decode step is a CUDA graph on
    the card). Returns the tokens of every engine and tier, tok/s, the
    agreements with dense, the two equalities, the plan registry's counts
    and truncation audit, and each engine's route calls and kernel
    launches."""
    device = torch.device(device)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    max_len = prompt_len + gen + 1
    kw = dict(max_len=max_len, device=device, backend=backend,
              compile_steps=backend != "torch")
    out: dict = {"tokens": {}, "tok_per_s": {}, "agreement": {}, "routes": {}, "launches": {}}

    def serve(name, eng):
        (toks, tps), out["routes"][name], out["launches"][name] = counted(
            lambda: eng.generate(prompts, gen))
        out["tokens"][name], out["tok_per_s"][name] = toks.cpu(), tps
        return out["tokens"][name], tps

    what = "reduced" if cfg == get_reduced(cfg.name) else f"{cfg.n_layers} layers"
    print(f"[serve] {cfg.name} ({what}), batch={batch}, prompt={prompt_len}, gen={gen}")

    # Dense bf16 reference
    ref_tokens, tps = serve("dense", Engine(cfg, params, PrecisionPolicy.off(), **kw))
    print(f"  dense bf16          : {tps:7.1f} tok/s   tokens[0,:8]="
          f"{[int(t) for t in ref_tokens[0, :8]]}")

    # Runtime precision dial: ONE engine, ONE 8-bit decomposition. Each
    # tier is a plan swap (set_precision), not a requantization.
    pol8 = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                   keep_dense=KEEP_DENSE)
    eng = Engine(cfg, params, pol8, **kw)
    for bits in (8, 6, 4):
        eng.set_precision(None if bits == 8 else bits)
        toks, tps = serve(f"booth-bitplane-w{bits}", eng)
        agree = float((toks == ref_tokens).float().mean())
        out["agreement"][bits] = agree
        trunc = "stored width " if bits == 8 else "truncated    "
        print(f"  w{bits}a{bits} {trunc}  : {tps:7.1f} tok/s   "
              f"agreement with dense: {agree:5.1%}")
    del eng

    # MAC-variant equivalence: both are exact integer matmul -> same tokens
    # (the Booth variant at the digit level, SBMwC at the bit-plane level).
    tok_by_variant = {}
    for variant in ("booth", "sbmwc"):
        level = "digit" if variant == "booth" else "bitplane"
        pol = PrecisionPolicy.uniform(8, 8, variant=variant, level=level,
                                      keep_dense=KEEP_DENSE)
        tok_by_variant[variant], _ = serve(f"{variant}-{level}", Engine(cfg, params, pol, **kw))
    same = bool(torch.equal(tok_by_variant["booth"], tok_by_variant["sbmwc"]))
    print(f"  w8a8 sbmwc == booth : {same} (exactness, paper §III)")
    assert same, "MAC variants diverged — integer path broken"
    # ...and both match the bitplane engine's stored-width row above
    same8 = bool(torch.equal(tok_by_variant["booth"], out["tokens"]["booth-bitplane-w8"]))
    print(f"  w8a8 digit==bitplane: {same8} (level equivalence)")
    assert same8, "bitplane and digit levels diverged"

    reg = plan_mod.DEFAULT_REGISTRY
    truncated = [p for p in reg.plans() if p.w_shift]
    print(f"[serve] plan registry: {len(reg)} plans resolved "
          f"({len(truncated)} truncated tiers), {reg.hits} hits")
    if truncated:
        print("[serve] e.g.", truncated[0].describe())
    print("[serve] OK")
    out.update(sbmwc_eq_booth=same, digit_eq_bitplane=same8,
               registry={"plans": len(reg), "truncated": len(truncated), "hits": reg.hits},
               truncation_audit=plan_mod.truncation_audit())
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = init_params(cfg, SeededParams(0).generator(device), device=device)
    return serve_quantized(cfg, params, device,
                           batch=args.batch, prompt_len=args.prompt_len, gen=args.gen)


if __name__ == "__main__":
    main()
