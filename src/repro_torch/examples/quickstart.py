"""Quickstart: the bitSMM technique in five minutes.

1. Exact bit-serial matmul (both MAC variants, all execution levels)
2. The cycle-accurate serial-MAC simulator (the paper's hardware, bit for bit)
3. The systolic-array throughput model (paper Eq. 9/10 — Fig. 6 numbers)
4. A quantized forward pass through a reduced llama-family model

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.bitserial import bitserial_matmul
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.quantize import quantize
from repro_torch.core.systolic import SAConfig, gops, peak_op_per_cycle, serial_mac_dot
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.serve import resolve_device
from repro_torch.models.transformer import SeededParams, forward, init_params

BITS = 7
#: the paper's Table II GOPS at 300 MHz, 16-bit operands
TABLE_II = {(16, 4): 1.2, (32, 8): 4.8, (64, 16): 19.2}


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def _ints(rng, shape, device) -> torch.Tensor:
    lo, hi = -(2 ** (BITS - 1)), 2 ** (BITS - 1) - 1
    return torch.as_tensor(rng.integers(lo, hi + 1, shape), dtype=torch.int32, device=device)


def quickstart(cfg, params, device, *, backend: str = "auto") -> dict:
    """The four sections on ``device``; §4 forwards ``cfg`` / ``params``
    dense and at w8a8 (Booth, digit level) through ``backend``'s routes.
    Returns every printed number, and §4's logits."""
    device = torch.device(device)
    out: dict = {"exact": {}, "mac": {}, "gops": {}}

    section("1. Exact bit-serial matmul")
    rng = np.random.default_rng(0)
    a = _ints(rng, (8, 32), device)
    w = _ints(rng, (32, 16), device)
    exact = (a.double() @ w.double()).to(torch.int32)  # exact: |sums| < 2^53
    for level in ("bitplane", "digit", "fused"):
        for variant in ("sbmwc", "booth"):
            got = bitserial_matmul(a, w, a_bits=BITS, w_bits=BITS, variant=variant, level=level)
            ok = bool(torch.equal(got, exact))
            print(f"  level={level:9s} variant={variant:6s} exact={ok}")
            assert ok
            out["exact"][(level, variant)] = ok

    section("2. Cycle-accurate serial MAC (the paper's hardware)")
    mc = _ints(rng, (5,), device)
    ml = _ints(rng, (5,), device)
    for variant in ("booth", "sbmwc"):
        got, cycles = serial_mac_dot(mc, ml, bits=BITS, variant=variant)
        want = int(torch.sum(mc.long() * ml.long()))
        print(f"  {variant:6s}: dot={int(got):6d} (expect {want}), "
              f"cycles={cycles} (= (n+1)*b = {(5 + 1) * BITS}, paper Eq. 8)")
        assert int(got) == want and cycles == (5 + 1) * BITS
        out["mac"][variant] = (int(got), cycles)

    section("3. Systolic-array throughput model (paper Eq. 10 / Table II)")
    for cols, rows in ((16, 4), (32, 8), (64, 16)):
        sa = SAConfig(width=cols, height=rows)
        g = gops(sa, bits=16, freq_hz=300e6)
        print(f"  {cols}x{rows} @300 MHz, 16-bit: peak {peak_op_per_cycle(sa, 16):6.1f} "
              f"OP/cycle -> {g:5.2f} GOPS  (paper Table II: {TABLE_II[(cols, rows)]})")
        out["gops"][(cols, rows)] = g

    what = f"reduced {cfg.name}" if cfg == get_reduced(cfg.name) else cfg.name
    section(f"4. Quantized model forward ({what}, w8a8 Booth)")
    batch = make_batch(cfg, 2, 32, "train", device=device)
    dense, _, _ = forward(cfg, params, batch, backend=backend)
    pol = PrecisionPolicy.uniform(8, 8, variant="booth", level="digit")
    quant, _, _ = forward(cfg, params, batch, policy=pol, backend=backend)
    d, q_ = dense.float(), quant.float()
    err = float(torch.mean(torch.abs(d - q_)) / (torch.mean(torch.abs(d)) + 1e-9))
    print(f"  logits rel-L1 error dense vs w8a8: {err:.4f} (small, != 0: quantized)")
    x = torch.as_tensor(rng.standard_normal((4, 8)), dtype=torch.float32, device=device)
    q = quantize(x, bits=8, axis=-1)
    lo, hi = int(q.values.min()), int(q.values.max())
    print(f"  quantize() per-axis scales shape: {tuple(q.scale.shape)}, int range [{lo}, {hi}]")
    print("\nquickstart OK")
    out.update(rel_l1=err, dense=dense, quant=quant, scale_shape=tuple(q.scale.shape),
               int_range=(lo, hi))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced("granite-3-8b")
    params = init_params(cfg, SeededParams(0).generator(device), device=device)
    return quickstart(cfg, params, device)


if __name__ == "__main__":
    main()
