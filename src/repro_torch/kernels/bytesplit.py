"""The byte split behind the tensor-core plane kernels: the host side of
``csrc/plane_mm_common.cuh``.

Every pair-weight vector the plan executors build is a wrapped outer
product, ``pw[i*P_w + j] = wrap32(wa[i] * ww[j])``, so modulo 2^32

    sum_ij pw_ij (a_i @ w_j)  ==  A @ W,   A = sum_i wa_i a_i,  W = sum_j ww_j w_j,

and both sides go to int8 tensor cores as bytes:

* the weight side as *byte digits* of its words (:func:`weight_digits`):
  planes of weights ``c * 2^p`` (p < 8) share one byte, bit p = plane p's
  bit; a Booth operand has a magnitude and a sign byte per group, so
  ``W = sum_g c_g (M_g - 2 S_g)``: two digits at 8 Booth planes;
* the activation side as *signed base-256 digits*
  (:func:`signed_byte_count`, :func:`split_signed_bytes`): one for a raw
  int8 activation, two for 8 packed Booth planes.

:func:`pair_route` decides on the host, before a launch, whether a call's
pair weights are that outer product of its operands' plane weights (the
byte-split kernels) or not (the all-pairs path: unpack to int8 planes and
``plane_matmul``, exact for any pw). :func:`digit_plan` builds the
``DigitPlan`` struct a kernel takes by value; :func:`bytesplit_matmul` is
the plain model of what the kernels compute, digit by digit, which the CPU
tests hold against ``plane_matmul_ref`` and the JAX functions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch

from repro_torch.core.bitplanes import PackedPlanes, unpack_planes

MASK32 = 0xFFFFFFFF
#: planes per operand the kernels take
MAX_PLANES = 32
#: activation digits the kernels take (4 bytes cover every value mod 2^32)
MAX_A_DIGITS = 4
#: row tiles the kernels are instantiated for (1, 2 or 4 n8 token tiles)
ROW_TILES = (8, 16, 32)
#: output columns per CUDA block (four warps of 32)
COLS_PER_BLOCK = 128
#: packed words per K chunk: one staged activation tile, one gate tile, the
#: unit of the K split
CHUNK_WORDS = 16
#: blocks per SM the K split aims for at small M
BLOCKS_PER_SM = 4


def wrap32(v: int) -> int:
    """``v`` modulo 2^32 as a signed int32 value."""
    v &= MASK32
    return v - (1 << 32) if v >> 31 else v


@dataclasses.dataclass(frozen=True)
class WeightDigit:
    """One byte digit of the weight side: bit p of the byte is the
    magnitude (or, with ``sign``, the sign) bit of plane ``slots[p]``
    (None: zero); the byte is two's complement when ``s8``. The digit adds
    ``coef * byte`` (mod 2^32) to W."""

    coef: int
    slots: tuple[Optional[int], ...]
    sign: bool
    s8: bool


def weight_digits(ww: Sequence[int], ternary: bool) -> tuple[WeightDigit, ...]:
    """Byte digits of ``W = sum_j ww[j] * (mag_j - 2 sign_j)`` (mod 2^32).

    Greedy grouping: plane j joins the first group whose coefficient c has
    a free bit p with ``c * 2^p == ww[j]`` (mod 2^32), or bit 7 of a
    two's-complement byte with ``-128 c == ww[j]`` (SBMwC's top plane);
    else it opens a group with c = ww[j]. A plane of weight 0 (mod 2^32)
    adds nothing and is left out. Each group gives a magnitude digit
    (coefficient c) and, for ternary words, a sign digit (-2c). Exact for
    any words: each byte is an exact integer and the regrouping holds mod
    2^32."""
    groups: list[list] = []  # [c, slots, s8]
    for j, w in enumerate(ww):
        w32 = w & MASK32
        if w32 == 0:
            continue
        for grp in groups:
            c, slots, _ = grp
            p = next((p for p in range(8)
                      if slots[p] is None and (c << p) & MASK32 == w32), None)
            if p is None and slots[7] is None and (-(c << 7)) & MASK32 == w32:
                p, grp[2] = 7, True
            if p is not None:
                slots[p] = j
                break
        else:
            groups.append([w32, [j] + [None] * 7, False])
    if not groups:  # every plane weighs 0: one inert digit
        groups.append([0, [None] * 8, False])
    digits = []
    for c, slots, s8 in groups:
        digits.append(WeightDigit(c, tuple(slots), False, s8))
        if ternary:
            digits.append(WeightDigit((-2 * c) & MASK32, tuple(slots), True, s8))
    return tuple(digits)


@functools.lru_cache(maxsize=256)
def signed_byte_count(weights: tuple[int, ...], ternary: bool) -> int:
    """Signed bytes that hold ``sum_i weights[i] * v_i`` for any plane
    values (v in {-2, -1, 0, 1} for ternary words, whatever the bits; {0, 1}
    for binary ones), weights taken as int32; 4 when the range exceeds
    int32 (four bytes hold every value mod 2^32)."""
    vals = (-2, -1, 0, 1) if ternary else (0, 1)
    lo = sum(min(wrap32(w) * v for v in vals) for w in weights)
    hi = sum(max(wrap32(w) * v for v in vals) for w in weights)
    for n in range(1, MAX_A_DIGITS):
        if -(1 << (8 * n - 1)) <= lo and hi < (1 << (8 * n - 1)):
            return n
    return MAX_A_DIGITS


def split_signed_bytes(x: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """The low ``n_bytes`` signed base-256 digits of an integer tensor
    taken modulo 2^32 (as int32): ``(n_bytes,) + x.shape`` int8 ``d``,
    ``d[b]`` the sign-extended low byte of what the lower digits leave.
    ``sum_b 256^b d[b] == x`` where that int32 value fits ``n_bytes < 4``
    signed bytes; at four bytes, modulo 2^32 for every x."""
    if not 1 <= n_bytes <= MAX_A_DIGITS:
        raise ValueError(f"n_bytes must be in [1, {MAX_A_DIGITS}], got {n_bytes}")
    r = x.to(torch.int64)
    r = (r & MASK32) - ((r >> 31 & 1) << 32)  # the int32 value of x mod 2^32
    out = []
    for _ in range(n_bytes):
        d = ((r & 0xFF) ^ 0x80) - 0x80
        out.append(d.to(torch.int8))
        r = (r - d) >> 8
    return torch.stack(out)


def row_tile(m: int, bm: Optional[int] = None) -> int:
    """Kernel row tile: the smallest instantiated tile covering M (<= 32)."""
    if bm is not None:
        if bm not in ROW_TILES:
            raise ValueError(f"bm must be one of {ROW_TILES}, got {bm}")
        return bm
    return next((t for t in ROW_TILES if t >= m), ROW_TILES[-1])


def padded_words(kw: int) -> int:
    """KW rounded up to whole K chunks (the staged activation's row)."""
    return -(-kw // CHUNK_WORDS) * CHUNK_WORDS


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k_split(m: int, n: int, n_chunks: int, tile: int, sms: int) -> int:
    """The kernels' default K split of an (M, N) call at row tile ``tile``
    on ``sms`` SMs (at most one split per K chunk; partial sums meet by
    atomics). A grid under one wave of ``BLOCKS_PER_SM`` blocks on each SM
    is split until it fills that wave. A grid of a wave or more takes, of
    at most ``BLOCKS_PER_SM`` splits, the one whose last wave ends first
    (waves times K chunks a block; the fewer splits on a tie): it fills a
    part-empty last wave."""
    blocks = -(-n // COLS_PER_BLOCK) * -(-m // tile)
    slots = BLOCKS_PER_SM * sms
    if blocks < slots:
        return max(1, min(n_chunks, -(-slots // blocks)))

    def span(split: int) -> int:
        per = -(-n_chunks // split)  # chunks a block; the kernels launch ceil(n_chunks/per) ranges
        return -(-blocks * -(-n_chunks // per) // slots) * per

    return min(range(1, min(n_chunks, BLOCKS_PER_SM) + 1), key=lambda s: (span(s), s))


def checked_k_split(k_split_: Optional[int]) -> Optional[int]:
    """An explicit K split passed through (an int >= 1; the kernels cap it
    at the call's K chunks), or None for :func:`k_split`'s default."""
    if k_split_ is not None and (isinstance(k_split_, bool) or not isinstance(k_split_, int)
                                 or k_split_ < 1):
        raise ValueError(f"k_split must be an int >= 1, got {k_split_!r}")
    return k_split_


def vec4_ok(n: int, *words: Optional[torch.Tensor]) -> bool:
    """Whether the kernel may read four columns' words as one 16-byte
    vector: N a multiple of 4 and every word tensor 16-byte aligned."""
    return n % 4 == 0 and all(w is None or w.data_ptr() % 16 == 0 for w in words)


class DigitPlan(ctypes.Structure):
    """``plane_mm::DigitPlan`` of ``csrc/plane_mm_common.cuh``."""

    _fields_ = [
        ("n_wd", ctypes.c_int),
        ("n_ad", ctypes.c_int),
        ("wcoef", ctypes.c_uint32 * (2 * MAX_PLANES)),
        ("wplane", (ctypes.c_int8 * 8) * (2 * MAX_PLANES)),
        ("wsign", ctypes.c_uint8 * (2 * MAX_PLANES)),
        ("ws8", ctypes.c_uint8 * (2 * MAX_PLANES)),
        ("n_a", ctypes.c_int),
        ("n_w", ctypes.c_int),
        ("wa", ctypes.c_int32 * MAX_PLANES),
    ]


#: the two routes of a plane-pair call (:func:`pair_route`)
BYTESPLIT, ALL_PAIRS = "bytesplit", "all_pairs"


def is_outer_product(pw: torch.Tensor, wa: Sequence[int], ww: Sequence[int]) -> bool:
    """Whether ``pw[i*P_w + j] == wrap32(wa[i] * ww[j])`` for every pair
    (reads ``pw`` back to the host)."""
    want = [wrap32(a * b) for a in wa for b in ww]
    return tuple(pw.shape) == (len(want),) and pw.tolist() == want


def tag_pair_weights(pw: torch.Tensor, wa: Sequence[int], ww: Sequence[int]) -> torch.Tensor:
    """Record on ``pw``, the wrapped outer product of ``wa`` and ``ww`` that
    ``ops._pair_weights`` builds, its factors and its version counter:
    :func:`pair_route` then trusts it without a read-back until it is
    written."""
    pw._pair_factors = (tuple(int(x) for x in wa), tuple(int(x) for x in ww), pw._version)
    return pw


def pair_route(pw: torch.Tensor, wa: Sequence[int], ww: Sequence[int], n_a: int,
               n_w: int) -> str:
    """The route of a call whose operands have ``n_a`` and ``n_w`` planes
    with plane weights ``wa`` and ``ww`` (empty for operands packed without
    weights): :data:`BYTESPLIT` when ``pw`` is their wrapped outer product
    and both plane counts fit the byte-split kernels, else
    :data:`ALL_PAIRS`. A ``pw`` that ``ops._pair_weights`` built (as every
    plan executor's is) carries its factors and decides without a
    read-back while its version counter is unchanged; any other ``pw`` is
    read back (at most 1024 int32 values) on every call.

    The trust in a carried tag holds only while ``pw`` is written through
    ops that bump its version counter: a write through ``pw.data``, a
    DLPack alias or a raw pointer leaves the tag standing over values that
    are no longer the outer product. ``ops._pair_weights``' tensors are
    never written."""
    if (len(wa) != n_a or len(ww) != n_w
            or not (1 <= n_a <= MAX_PLANES and 1 <= n_w <= MAX_PLANES)):
        return ALL_PAIRS
    tag = getattr(pw, "_pair_factors", None)
    if tag is not None and tag == (tuple(wa), tuple(ww), pw._version):
        return BYTESPLIT
    return BYTESPLIT if is_outer_product(pw, wa, ww) else ALL_PAIRS


@functools.lru_cache(maxsize=256)
def digit_plan(wa: tuple[int, ...], ww: tuple[int, ...], w_ternary: bool,
               n_a_digits: int) -> DigitPlan:
    """The kernel's byte plan for activation plane weights ``wa`` (the
    packed kernel sums A's planes with them), weight plane weights ``ww``,
    and ``n_a_digits`` signed activation bytes; built once per key (the
    serving loop asks for the same few)."""
    digits = weight_digits(ww, w_ternary)
    plan = DigitPlan()
    plan.n_wd, plan.n_ad = len(digits), n_a_digits
    plan.n_a, plan.n_w = len(wa), len(ww)
    for d, dig in enumerate(digits):
        plan.wcoef[d] = dig.coef
        for p, j in enumerate(dig.slots):
            plan.wplane[d][p] = -1 if j is None else j
        plan.wsign[d], plan.ws8[d] = int(dig.sign), int(dig.s8)
    for i, v in enumerate(wa):
        plan.wa[i] = wrap32(v)
    return plan


# ---------------------------------------------------------------------------
# The plain model of the kernels' arithmetic
# ---------------------------------------------------------------------------


def _word_bits(packed: PackedPlanes, sign: bool) -> torch.Tensor:
    """{0,1} values of the magnitude (or sign) words, unpacked to K order."""
    words = packed.sign if sign else packed.mag
    return unpack_planes(dataclasses.replace(packed, mag=words, sign=None), dtype=torch.int32)


def weight_digit_bytes(packed_w: PackedPlanes, digits: Sequence[WeightDigit]) -> torch.Tensor:
    """The weight digits' bytes ``(D, K, N)`` (int32 values of the u8 or s8
    bytes), from the words as stored."""
    mag = _word_bits(packed_w, False)
    sign = None if packed_w.sign is None else _word_bits(packed_w, True)
    out = []
    for dig in digits:
        bits = sign if dig.sign else mag
        byte = torch.zeros_like(mag[0])
        for p, j in enumerate(dig.slots):
            if j is not None:
                byte += bits[j] << p
        if dig.s8:
            byte = byte - ((byte >> 7 & 1) << 8)
        out.append(byte)
    return torch.stack(out)


def bytesplit_matmul(
    a_digits: torch.Tensor,
    w_bytes: torch.Tensor,
    digits: Sequence[WeightDigit],
) -> torch.Tensor:
    """``sum_{b,d} 256^b c_d (a_digits[b] @ w_bytes[d])`` modulo 2^32 as
    int32: the kernels' sum, one exact product per (activation digit,
    weight digit). ``a_digits`` (B, M, K) and ``w_bytes`` (D, K, N) integer
    bytes (float64 products are exact: |a|, |w| <= 255)."""
    acc = torch.zeros((a_digits.shape[1], w_bytes.shape[2]), dtype=torch.int64,
                      device=a_digits.device)
    for b in range(a_digits.shape[0]):
        a = a_digits[b].to(torch.float64)
        for d, dig in enumerate(digits):
            prod = (a @ w_bytes[d].to(torch.float64)).to(torch.int64)
            acc = (acc + ((dig.coef << (8 * b)) & MASK32) * prod) & MASK32
    return (acc - ((acc >> 31 & 1) << 32)).to(torch.int32)


def fused_activation_digits(x_q: torch.Tensor, a_bits: int, variant: str) -> torch.Tensor:
    """The fused kernel's one activation digit ``(1, M, K)``: x's low
    ``a_bits`` bits, sign-extended (booth, sbmwc) or not (unsigned) — the
    sum of its bit planes."""
    u = x_q.to(torch.int32) & ((1 << a_bits) - 1)
    if variant != "unsigned":
        u = u - ((u >> (a_bits - 1) & 1) << a_bits)
    return u[None]


def packed_activation_digits(packed_a: PackedPlanes) -> torch.Tensor:
    """The packed kernel's activation digits ``(B, M, K)``: A = sum_i
    wa_i a_i from the words as stored, in signed bytes."""
    planes = unpack_planes(packed_a, dtype=torch.int64)
    wa = torch.tensor([wrap32(w) for w in packed_a.weights], dtype=torch.int64,
                      device=planes.device).reshape(-1, 1, 1)
    a = (planes * wa).sum(dim=0)
    return split_signed_bytes(a, signed_byte_count(tuple(packed_a.weights),
                                                   packed_a.sign is not None))
