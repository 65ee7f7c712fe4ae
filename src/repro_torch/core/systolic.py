"""Systolic-array performance model and cycle-accurate serial-MAC simulator
(the port of ``src/repro/core/systolic.py``).

Two roles:

1. **Analytical model** — Equations 6, 8, 9, 10 of the paper (Tables II
   and III's GOPS at the reported clocks, Table IV, Figure 6), plain
   integer and float arithmetic.

2. **Cycle-accurate simulator** of both serial MAC variants (Booth and
   SBMwC), bit by bit, with the paper's hardware semantics: the multiplier
   streamed LSb first; the Booth variant adds or subtracts the
   (sign-extended) multiplicand shifted left by the cycle's bit index when
   the two most recent multiplier bits differ (digit ``prev - cur``); the
   SBMwC variant adds the shifted multiplicand on a set bit and commits
   the difference at the sign bit. The accumulator is int32 two's
   complement, as the hardware's and the reference's: a sum that leaves
   its range wraps.

Where the reference scans one element and one cycle at a time, the
simulator here works on torch tensors batched over every element and
every dot product (any leading dims), and is serial only over the
``bits`` cycles of an element: the accumulator's additions commute
modulo 2^32, so summing a cycle's terms over all elements at once gives
the reference's result bit for bit. It runs on the tensors' device.
"""

from __future__ import annotations

import dataclasses

import torch

# --------------------------------------------------------------------------
# Analytical model (paper Eqs. 6, 8, 9, 10)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """Compile-time systolic array topology (#columns x #rows in the paper's
    notation; e.g. the evaluated 16x4, 32x8, 64x16)."""

    width: int  # columns
    height: int  # rows
    max_bits: int = 16

    @property
    def n_macs(self) -> int:
        return self.width * self.height


# The paper's evaluated topologies.
PAPER_TOPOLOGIES = (SAConfig(16, 4), SAConfig(32, 8), SAConfig(64, 16))


def bismo_dot_cycles(b_mc: int, b_ml: int, n_values: int) -> int:
    """Eq. 6 — BISMO/Loom-style cycles for a dot product (no parallelism)."""
    return b_mc * b_ml * n_values


def bitsmm_dot_cycles(b_max: int, n_values: int) -> int:
    """Eq. 8 — bitSMM cycles for a dot product: (n+1) * b_max (the +1 is
    the lead-in: the multiplicand streams b_max cycles ahead of the
    multiplier, Eq. 7)."""
    return (n_values + 1) * b_max


def matmul_total_cycles(sa: SAConfig, n: int, bits: int) -> int:
    """Compute latency (Eq. 8) + snake-readout latency (#rows x #cols)."""
    return bitsmm_dot_cycles(bits, n) + sa.n_macs


def op_per_cycle(sa: SAConfig, n: int, a_width: int, b_height: int, bits: int) -> float:
    """Eq. 9 — MAC operations per cycle for an (n x a_width) @ (b_height x n)
    product on the array (a_width <= sa.width, b_height <= sa.height)."""
    ops = n * a_width * b_height
    cycles = (1 + n) * bits + sa.n_macs
    return ops / cycles


def peak_op_per_cycle(sa: SAConfig, bits: int) -> float:
    """Eq. 10 — n -> inf, matrices matching the SA dimensions."""
    return sa.n_macs / bits


def gops(sa: SAConfig, bits: int, freq_hz: float) -> float:
    """Peak throughput in GOPS at a clock frequency (Tables II/III)."""
    return peak_op_per_cycle(sa, bits) * freq_hz / 1e9


def readout_cycles(sa: SAConfig) -> int:
    """One accumulator per cycle through the snake network."""
    return sa.n_macs


def pipeline_register_count(sa: SAConfig) -> int:
    """(#rows - 1)(#cols - 1) + 1 registers (paper §III-B)."""
    return (sa.height - 1) * (sa.width - 1) + 1


def mux_count(sa: SAConfig) -> int:
    """#rows x #cols - 1 two-input muxes (paper §III-B)."""
    return sa.n_macs - 1


# --------------------------------------------------------------------------
# Cycle-accurate serial MAC simulator
# --------------------------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2^32 as int32 two's complement."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _twos_complement_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Low ``bits`` bits of x, LSb first: shape x.shape + (bits,)."""
    u = x.to(torch.int64) & ((1 << bits) - 1)
    shifts = torch.arange(bits, dtype=torch.int64, device=x.device)
    return (u[..., None] >> shifts) & 1


def _operands(mc: torch.Tensor, ml: torch.Tensor, bits: int):
    mc, ml = torch.broadcast_tensors(mc, ml)
    # the int32 multiplicand register (sign-extended)
    return _wrap32(mc.to(torch.int64)).to(torch.int64), _twos_complement_bits(ml, bits)


def _shifted(mc: torch.Tensor, i: int) -> torch.Tensor:
    """The multiplicand shifted left i bits in the int32 register."""
    return _wrap32(mc << i).to(torch.int64)


def booth_mac_dot(mc: torch.Tensor, ml: torch.Tensor, bits: int) -> tuple[torch.Tensor, int]:
    """Bit-serial Booth MAC over the last dim of ``mc`` (multiplicands) and
    ``ml`` (multipliers), both ``bits``-bit two's complement (leading dims
    broadcast: one dot product each). Returns (int32 dot products,
    total_cycles) with total_cycles = (n+1)*bits (Eq. 8).

    Cycle i of an element examines (ml_bit[i], ml_bit[i-1]) — Table I —
    and adds the digit ``prev - cur`` times the multiplicand shifted left
    i bits."""
    n = mc.shape[-1]
    mc64, ml_bits = _operands(mc, ml, bits)
    acc = torch.zeros(mc64.shape[:-1], dtype=torch.int64, device=mc64.device)
    prev = torch.zeros_like(ml_bits[..., 0])
    for i in range(bits):
        cur = ml_bits[..., i]
        acc = acc + ((prev - cur) * _shifted(mc64, i)).sum(dim=-1)
        prev = cur
    return _wrap32(acc), bitsmm_dot_cycles(bits, n)


def sbmwc_mac_dot(mc: torch.Tensor, ml: torch.Tensor, bits: int) -> tuple[torch.Tensor, int]:
    """Bit-serial SBMwC MAC: unsigned accumulation with a subtract at the
    multiplier sign bit. The hardware keeps sum and difference
    accumulators (two adders) because it cannot know in advance whether
    the current bit is the last; committing the difference at the sign
    bit is bit-exact. Shapes and returns as :func:`booth_mac_dot`."""
    n = mc.shape[-1]
    mc64, ml_bits = _operands(mc, ml, bits)
    acc = torch.zeros(mc64.shape[:-1], dtype=torch.int64, device=mc64.device)
    for i in range(bits):
        sign = -1 if i == bits - 1 else 1
        acc = acc + sign * (ml_bits[..., i] * _shifted(mc64, i)).sum(dim=-1)
    return _wrap32(acc), bitsmm_dot_cycles(bits, n)


def serial_mac_dot(
    mc: torch.Tensor, ml: torch.Tensor, bits: int, variant: str = "booth"
) -> tuple[torch.Tensor, int]:
    if variant == "booth":
        return booth_mac_dot(mc, ml, bits)
    if variant == "sbmwc":
        return sbmwc_mac_dot(mc, ml, bits)
    raise ValueError(f"unknown variant {variant!r}")


def serial_sa_matmul(
    a: torch.Tensor, b: torch.Tensor, bits: int, sa: SAConfig, variant: str = "booth"
) -> tuple[torch.Tensor, int]:
    """Matrix product on the simulated SA: each output element is one MAC's
    accumulator; returns (A @ B as int32, total_cycles incl. snake readout).

    ``a``: (M, n) multipliers streamed on horizontal inputs (LSb first),
    ``b``: (n, N) multiplicands on vertical inputs (MSb first); M <= rows,
    N <= cols as in the hardware.
    """
    m, n = a.shape
    n2, ncols = b.shape
    if n != n2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} x {tuple(b.shape)}")
    if m > sa.height or ncols > sa.width:
        raise ValueError(
            f"matrix {tuple(a.shape)}x{tuple(b.shape)} exceeds SA {sa.width}x{sa.height}"
        )
    out, _ = serial_mac_dot(b.t()[None, :, :], a[:, None, :], bits, variant)
    return out, bitsmm_dot_cycles(bits, n) + readout_cycles(sa)
