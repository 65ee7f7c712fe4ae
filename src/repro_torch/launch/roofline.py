"""Roofline terms of a step, and the bound of one call (the port of
``src/repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), as the reference's:

    compute    = FLOPs / (chips * peak FLOP/s)   (+ int8 ops / int8 peak)
    memory     = bytes / (chips * HBM bytes/s)
    collective = wire bytes / (chips * link bytes/s)

The reference reads FLOPs and bytes from XLA's compiled HLO; the port has
no compiled program, so :mod:`repro_torch.launch.cost` counts them over
one eager step and charges each bit-serial plan call and each attention
call by the function it computes (:func:`plan_call`,
:func:`attention_call`), never by the kernel or the plain version that
runs it. The rates are ``core/autotune.HARDWARE_TABLE``'s H100 SXM row
(NVIDIA's data sheet, dense: 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35
TB/s, 80 GB, 450 GB/s of NVLink a direction) unless a row is given: every
time here is a model prediction for that row at its full 700 W, not a
measurement.

:func:`bound_ms` is the least time of one call — the larger of its bytes
(each input read once, each output written once) over the memory rate
and its operations over the peak of their type — which ``chip_smoke.py``
prints beside every kernel's time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.autotune import HARDWARE_TABLE, HardwareModel  # noqa: F401

#: the H100 SXM row every prediction is normalized against by default
H100 = HARDWARE_TABLE["h100"]

def _wire_bytes(kind: str, operand_bytes: float, g: int) -> float:
    """Per-device wire bytes under the ring algorithm (the reference's
    ``hlo_cost._wire_bytes``). Operand payloads: an all-gather's is the
    local shard (wire = (g-1) x shard); a reduce-scatter's the full tensor
    (wire = (g-1)/g x it); an all-reduce moves ~2(g-1)/g x the tensor
    (RS+AG); an all-to-all keeps (g-1)/g of the buffer on the wire; a
    permute is point to point."""
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * f * operand_bytes
    if kind == "all-gather":
        return float(g - 1) * operand_bytes
    if kind == "reduce-scatter":
        return f * operand_bytes
    if kind == "all-to-all":
        return f * operand_bytes
    return operand_bytes  # collective-permute


@dataclasses.dataclass
class Roofline:
    """The roofline terms of one rank's step, scaled to the whole mesh as
    the reference's: ``flops`` (non-int8 operations), ``int8_ops`` (the
    bit-serial plan calls' int8 products), ``hbm_bytes`` and
    ``collective_bytes`` (wire bytes) are global, over ``chips``."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float
    int8_ops: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    hw: Optional[HardwareModel] = None

    def __post_init__(self):
        hw = self.hw or H100
        self.compute_s = (self.flops / (self.chips * hw.peak_flops_bf16)
                          + self.int8_ops / (self.chips * hw.peak_flops_int8))
        self.memory_s = self.hbm_bytes / (self.chips * hw.hbm_bw)
        self.collective_s = self.collective_bytes / (self.chips * hw.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        return self.model_flops / max(self.flops + self.int8_ops, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time (bf16 peak)."""
        peak = (self.hw or H100).peak_flops_bf16
        return self.model_flops / (self.step_time_s * self.chips * peak + 1e-30)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hw": (self.hw or H100).name,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "flops": self.flops,
            "int8_ops": self.int8_ops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "useful_flop_fraction": self.useful_flop_fraction,
            "mfu_at_roofline": self.mfu,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# --------------------------------------------------------------------------
# One call
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CallCost:
    """The work one call's function needs: operations (``int8`` ones on
    the int8 tensor-core rate, the rest on the bf16 rate) and bytes."""

    ops: float
    n_bytes: float
    int8: bool


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = H100.peak_flops_int8,
             hw: HardwareModel = H100) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of a call that moves
    ``n_bytes`` and computes ``n_ops`` operations at ``peak_ops`` a
    second."""
    t_bytes = n_bytes / hw.hbm_bw * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_products(a_bits: int, w_bits: int, *, a_signed: bool = True,
                   w_signed: bool = True) -> int:
    """Fewest int8 products per (m, n, k) of ``A @ W`` at these widths:
    the signed bytes that hold A's values times those of W's (an unsigned
    operand needs its top bit's byte as well; plane sums regrouped by the
    outer-product pair weights: the byte split's floor). Two 8-bit Booth
    operands take one; the kernels run at least this many, so a bound
    built on it stays a floor."""
    def signed_bytes(bits, signed):
        return -(-(bits + (0 if signed else 1)) // 8)

    return signed_bytes(a_bits, a_signed) * signed_bytes(w_bits, w_signed)


def plan_call(m: int, k: int, n: int, a_bits: int, w_bits: int, *, n_bytes: float,
              a_signed: bool = True) -> CallCost:
    """A bit-serial plan call computing ``A (m, k) @ W (k, n)``:
    ``2·m·k·n`` int8 operations times :func:`split_products`, and
    ``n_bytes``, the bytes of its stored operands (activation, the weight
    as stored — planes or digits at the executed width — and the
    epilogue's scales and bias) and of its output, each read or written
    once."""
    return CallCost(2.0 * m * k * n * split_products(a_bits, w_bits, a_signed=a_signed),
                    float(n_bytes), int8=True)


def attention_call(q_heads: int, pairs: int, head_dim: int, n_bytes: float) -> CallCost:
    """An attention call: 4 operations per (query head, (query, key) pair,
    d) — q·k and p·v, a multiply and an add each — on the bf16 rate, and
    ``n_bytes`` (q, K, V and their scales read once, the output written
    once)."""
    return CallCost(4.0 * q_heads * pairs * head_dim, float(n_bytes), int8=False)


def attention_pairs(sq: int, keys: int, causal: bool) -> int:
    """(query, key) pairs of one lane's attention over ``keys`` keys: every
    pair, or causally from the top left (query i sees keys j <= i)."""
    if not causal:
        return sq * keys
    if keys >= sq:
        return sq * (sq + 1) // 2
    return keys * (keys + 1) // 2 + (sq - keys) * keys


def packed_call_bound(m: int, n: int, pa, pw, products: int, gate_tiles=None,
                      hw: HardwareModel = H100) -> tuple[float, str]:
    """Bound of one packed product (``plane_matmul_packed``): A and W
    words read once, the int32 output written once; ``products`` int8
    products per (m, n, k) (:func:`split_products`). With ``gate_tiles``
    (the weight's (P_w, chunks) tile occupancy) only the occupied (plane,
    chunk) tiles' words are counted: that is what these data need."""
    from repro_torch.kernels.bytesplit import CHUNK_WORDS

    sides_a = 1 if pa.sign is None else 2
    sides_w = 1 if pw.sign is None else 2
    n_w, kw, _ = pw.mag.shape
    w_words = n_w * kw if gate_tiles is None else int(gate_tiles.sum()) * CHUNK_WORDS
    n_bytes = 4 * (sides_a * pa.mag.numel() + sides_w * w_words * n + m * n)
    return bound_ms(n_bytes, 2.0 * m * n * pa.k * products, hw=hw)
