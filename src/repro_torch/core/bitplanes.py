"""Bit-plane and digit-plane decompositions of integer tensors.

The paper streams operands one bit per cycle; here the temporal stream
becomes a leading ``planes`` axis:

* **unsigned** bit-planes: ``x = sum_i 2^i * p_i``, ``p_i in {0,1}``.
* **SBMwC** planes: two's complement, the MSB plane carries weight
  ``-2^(b-1)`` (the paper's "subtract at the multiplier sign bit").
* **Booth** signed-digit planes: ``d_i = x_{i-1} - x_i`` (``x_{-1} = 0``),
  digits in ``{-1, 0, +1}``, weights ``2^i``.

Digit-plane (radix ``2^k``) variants generalize the same schemes to int8
digits (k = 8). All decompositions are exact.

Bit-planes also have a *packed* storage format (:func:`pack_planes` /
:func:`unpack_planes`): binary planes pack 32 plane values per int32
word, ternary Booth planes pack as a sign/magnitude word pair. The word
layout is the reference's, word for word: with ``W`` words covering the
padded extent, bit ``t`` of word ``j`` holds the value at ``k = t*W + j``;
the *blocked* layout applies that per ``block``-value chunk of K.

Every function here is plain PyTorch on integer tensors and runs on any
device; words built on the card equal words built on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

Variant = Literal["unsigned", "sbmwc", "booth"]

WORD_BITS = 32  # plane values per packed int32 word
DEFAULT_BLOCK = 512  # K values per pack block in the blocked (fused-kernel) layout


@dataclasses.dataclass(frozen=True)
class PlaneDecomposition:
    """Planes stacked on a leading axis plus their integer weights:
    ``x == sum_i weights[i] * planes[i]``."""

    planes: torch.Tensor
    weights: tuple[int, ...]

    @property
    def n_planes(self) -> int:
        return len(self.weights)

    def reconstruct(self, dtype=torch.int32) -> torch.Tensor:
        w = _const(self.weights, dtype, self.planes.device)
        w = w.reshape((self.n_planes,) + (1,) * (self.planes.dim() - 1))
        return torch.sum(self.planes.to(dtype) * w, dim=0).to(dtype)


def _check_bits(bits: int, max_bits: int = 32) -> None:
    if not 1 <= bits <= max_bits:
        raise ValueError(f"bits must be in [1, {max_bits}], got {bits}")


def signed_range(bits: int) -> tuple[int, int]:
    """Two's-complement representable range for ``bits``-bit values."""
    if bits == 1:
        return -1, 0
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def plane_weights(bits: int, variant: Variant) -> tuple[int, ...]:
    """Plane weights of :func:`to_bitplanes` without computing the planes."""
    _check_bits(bits)
    if variant in ("unsigned", "booth"):
        return tuple(1 << i for i in range(bits))
    if variant == "sbmwc":
        return tuple(1 << i for i in range(bits - 1)) + (-(1 << (bits - 1)),)
    raise ValueError(f"unknown variant {variant!r}")


def _shifts(bits: int, x: torch.Tensor) -> torch.Tensor:
    return torch.arange(bits, dtype=torch.int32, device=x.device).reshape(
        (bits,) + (1,) * x.dim()
    )


def _low_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    # two's-complement low ``bits`` bits; at 32 bits the int32 bit pattern
    # itself (arithmetic shifts then read the same bits a uint32 view would)
    return x & ((1 << bits) - 1) if bits < 32 else x


def to_bitplanes(x: torch.Tensor, bits: int, variant: Variant = "sbmwc") -> PlaneDecomposition:
    """Decompose integer tensor ``x`` into ``bits`` binary/ternary int8 planes."""
    weights = plane_weights(bits, variant)
    x = x.to(torch.int32)
    if variant == "unsigned":
        planes = ((x[None] >> _shifts(bits, x)) & 1).to(torch.int8)
        return PlaneDecomposition(planes, weights)
    u = _low_bits(x, bits)
    cur = ((u[None] >> _shifts(bits, x)) & 1).to(torch.int8)
    if variant == "sbmwc":
        return PlaneDecomposition(cur, weights)
    if variant == "booth":
        prev = torch.cat([torch.zeros_like(cur[:1]), cur[:-1]], dim=0)
        planes = prev - cur  # {-1, 0, +1}
        if bits < 32:
            # Closed-range extension: ternary digits represent the closed
            # interval [-2^(b-1), +2^(b-1)], but the two's-complement recode
            # wraps +2^(b-1) to -2^(b-1). Booth prefix truncation rounds half
            # up onto that boundary (see shift_requantize); fix the single
            # wrapped value so truncation stays exact.
            top = 2 * (x == (1 << (bits - 1))).to(torch.int8)
            planes[bits - 1] += top
        return PlaneDecomposition(planes, weights)
    raise ValueError(f"unknown variant {variant!r}")


def to_digits(
    x: torch.Tensor, bits: int, variant: Variant = "booth", radix_bits: int = 8
) -> PlaneDecomposition:
    """Radix-``2^radix_bits`` digit decomposition.

    ``booth`` recodes carry-propagating signed digits so every digit fits
    ``[-2^(k-1), 2^(k-1)-1]`` (int8 for k=8) at the cost of one extra
    digit; ``unsigned``/``sbmwc`` keep low digits in ``[0, 2^k - 1]``.
    """
    _check_bits(bits)
    if radix_bits < 1 or radix_bits > 16:
        raise ValueError(f"radix_bits must be in [1,16], got {radix_bits}")
    x = x.to(torch.int32)
    k = radix_bits
    base = 1 << k
    n_digits = -(-bits // k)
    digits, weights = [], []
    rem = x
    if variant == "unsigned":
        for i in range(n_digits):
            digits.append(rem & (base - 1))
            weights.append(base**i)
            rem = rem >> k
        return PlaneDecomposition(torch.stack(digits).to(torch.int32), tuple(weights))
    if variant == "sbmwc":
        for i in range(n_digits):
            if i < n_digits - 1:
                digits.append(rem & (base - 1))
                rem = rem >> k
            else:
                digits.append(rem)
            weights.append(base**i)
        return PlaneDecomposition(torch.stack(digits).to(torch.int32), tuple(weights))
    if variant == "booth":
        half = base // 2
        for i in range(n_digits + 1):
            d = ((rem & (base - 1)) ^ half) - half  # sign-extend low k bits
            digits.append(d)
            weights.append(base**i)
            rem = (rem - d) >> k
        planes = torch.stack(digits).to(torch.int8 if k <= 8 else torch.int16)
        return PlaneDecomposition(planes, tuple(weights))
    raise ValueError(f"unknown variant {variant!r}")


# ---------------------------------------------------------------------------
# Packed plane storage
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedPlanes:
    """Bit-packed plane tensor plus the metadata needed to unpack it.

    ``mag``:     int32 words; bit t of word j = |plane value| at k = t*W + j.
    ``sign``:    int32 words, bit set where the value is -1 (ternary Booth
                 planes), else ``None``; the value is ``mag - 2*sign``.
    ``k``:       unpadded extent of the packed axis.
    ``axis``:    which axis of the unpacked plane array was packed (never 0).
    ``weights``: plane weights carried from the decomposition.
    ``block``:   ``None`` for the global planar layout, else the blocked
                 layout's chunk size (a multiple of ``WORD_BITS``): whole
                 blocks unpack to natural K order, which the fused kernel
                 needs against raw int8 activations.
    ``occupancy``: per-(plane, word) {0,1} int32 bitmap — 1 where any value
                 packed into that word is non-zero.
    ``checksum``: optional per-plane column sums of the unpacked values
                 over the non-packed axes: ``checksum[p, k] = sum_n
                 plane[p, k, n]`` for a ``(P, K, N)`` weight, the reference
                 side of the ABFT row-sum identity (:func:`checksum_vector`).
    """

    mag: torch.Tensor
    sign: Optional[torch.Tensor]
    k: int
    axis: int
    weights: tuple[int, ...]
    block: Optional[int] = None
    occupancy: Optional[torch.Tensor] = None
    checksum: Optional[torch.Tensor] = None

    @property
    def n_planes(self) -> int:
        return self.mag.shape[0]

    @property
    def n_words(self) -> int:
        return self.mag.shape[self.axis]


def _pad_axis(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _to_words(bits01: torch.Tensor, axis: int, n_words: int) -> torch.Tensor:
    """Pack a {0,1} int tensor along ``axis`` into int32 words (planar).

    The extent splits into an adjacent (32, W) pair and bit t comes from
    slice t: one shift and one sum over the 32 slices (the bits are
    disjoint, so the sum is their OR), a few launches on the card however
    many bits. Words are assembled in int64 and wrapped to the int32 bit
    pattern explicitly (bit 31 set gives a negative word, as in the
    reference), so no signed shift overflows."""
    x = _pad_axis(bits01, axis, n_words * WORD_BITS - bits01.shape[axis])
    sh = x.shape
    x = x.reshape(sh[:axis] + (WORD_BITS, n_words) + sh[axis + 1 :])
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=x.device).reshape(
        (WORD_BITS,) + (1,) * (x.dim() - 1 - axis)
    )
    words = (x.to(torch.int64) << shifts).sum(dim=axis)
    words = words - ((words >> 31) & 1) * (1 << 32)
    return words.to(torch.int32)


def _from_words(words: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Inverse of :func:`_to_words`: int32 words -> {0,1} int32 values."""
    sh = words.shape
    w = words.unsqueeze(axis)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device).reshape(
        (WORD_BITS,) + (1,) * (w.dim() - 1 - axis)
    )
    bits = (w >> shifts) & 1
    bits = bits.reshape(sh[:axis] + (WORD_BITS * sh[axis],) + sh[axis + 1 :])
    return bits.narrow(axis, 0, k)


def _to_words_blocked(bits01: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Blocked planar pack: planar-pack each ``block``-value chunk."""
    bkw = block // WORD_BITS
    k = bits01.shape[axis]
    nkb = -(-k // block)
    x = _pad_axis(bits01, axis, nkb * block - k)
    sh = x.shape
    x = x.reshape(sh[:axis] + (nkb, block) + sh[axis + 1 :])
    w = _to_words(x, axis + 1, bkw)
    return w.reshape(sh[:axis] + (nkb * bkw,) + sh[axis + 1 :])


def _from_words_blocked(words: torch.Tensor, axis: int, k: int, block: int) -> torch.Tensor:
    bkw = block // WORD_BITS
    sh = words.shape
    nkb = sh[axis] // bkw
    w = words.reshape(sh[:axis] + (nkb, bkw) + sh[axis + 1 :])
    vals = _from_words(w, axis + 1, block)
    vals = vals.reshape(sh[:axis] + (nkb * block,) + sh[axis + 1 :])
    return vals.narrow(axis, 0, k)


def pack_planes(
    planes: torch.Tensor,
    *,
    axis: int = -1,
    ternary: bool = False,
    weights: tuple[int, ...] = (),
    block: Optional[int] = None,
    checksum: bool = False,
) -> PackedPlanes:
    """Bit-pack plane values ({0,1}, or {-1,0,+1} with ``ternary``) along
    ``axis`` into int32 words. ``block=None`` gives the global planar
    layout; an int the blocked layout, clamped so a small K never pads up
    to a whole oversized block (the reference's clamp rounds K up to 128,
    so words compare equal with it)."""
    axis = axis % planes.dim()
    if axis == 0:
        raise ValueError("cannot pack along the planes axis (axis 0)")
    k = planes.shape[axis]
    v = planes.to(torch.int32)
    if block is not None:
        if block % WORD_BITS:
            raise ValueError(f"block must be a multiple of {WORD_BITS}, got {block}")
        lane = 4 * WORD_BITS
        if block > lane:
            block = min(block, -(-k // lane) * lane)

        def towords(x):
            return _to_words_blocked(x, axis, block)

    else:
        n_words = -(-k // WORD_BITS)

        def towords(x):
            return _to_words(x, axis, n_words)

    if ternary:
        mag = towords(v.abs())
        sign = towords((v < 0).to(torch.int32))
    else:
        mag = towords(v)
        sign = None
    reduce_axes = tuple(a for a in range(mag.dim()) if a not in (0, axis))
    nz = mag != 0
    occupancy = (nz.any(dim=reduce_axes) if reduce_axes else nz).to(torch.int32)
    chk = None
    if checksum:
        chk = (v.sum(dim=reduce_axes) if reduce_axes else v).to(torch.int32)
    return PackedPlanes(
        mag=mag, sign=sign, k=k, axis=axis, weights=tuple(weights), block=block,
        occupancy=occupancy, checksum=chk,
    )


def unpack_planes(packed: PackedPlanes, dtype=torch.int8) -> torch.Tensor:
    """Exact inverse of :func:`pack_planes`. Words packed along another
    axis than the last unpack in chunks of the last axis, so the int32
    intermediates of a vocabulary-wide head stay bounded."""
    n = packed.mag.shape[-1]
    step = max(1, _DECOMPOSE_WEIGHTS * n // max(packed.mag.numel() * WORD_BITS, 1))
    if packed.axis != packed.mag.dim() - 1 and n > step:
        return torch.cat([
            unpack_planes(dataclasses.replace(
                packed, mag=packed.mag[..., i:i + step],
                sign=None if packed.sign is None else packed.sign[..., i:i + step]), dtype)
            for i in range(0, n, step)
        ], dim=-1)
    if packed.block is not None:
        def fromwords(w):
            return _from_words_blocked(w, packed.axis, packed.k, packed.block)
    else:
        def fromwords(w):
            return _from_words(w, packed.axis, packed.k)

    vals = fromwords(packed.mag)
    if packed.sign is not None:
        vals = vals - 2 * fromwords(packed.sign)
    return vals.to(dtype)


def pack_decomposition(
    dec: PlaneDecomposition,
    *,
    axis: int = -1,
    variant: Variant = "sbmwc",
    block: Optional[int] = None,
    checksum: bool = False,
) -> PackedPlanes:
    """Pack a bit-plane :class:`PlaneDecomposition` (carries its weights)."""
    return pack_planes(
        dec.planes, axis=axis, ternary=variant == "booth", weights=dec.weights,
        block=block, checksum=checksum,
    )


def _const(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, built once per (values, dtype,
    device): the serving step asks for the same few on every call, and a
    tensor built from host data inside it would be a host-to-device copy
    per call, which a CUDA graph cannot capture. Never written."""
    key = (tuple(values), dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


_CONSTS: dict = {}


def _take_planes(arr: Optional[torch.Tensor], idx: list[int], axis: int):
    if arr is None:
        return None
    return arr.index_select(axis, _const(idx, torch.long, arr.device))


@dataclasses.dataclass(frozen=True)
class WeightPlanes:
    """Pre-decomposed weight operand of the serving weight-plane cache.

    ``packed``: :class:`PackedPlanes` with K packed along the rows
                (bit-plane level);
    ``planes``: raw planes ``(P, K, N)`` — always at digit level; also kept
                at bit-plane level on the host, where the plain plane-pair
                contraction consumes them without unpacking.
    """

    packed: Optional[PackedPlanes]
    planes: Optional[torch.Tensor]
    weights: tuple[int, ...]
    level: str
    variant: str
    w_bits: int


#: weights a bit-plane decomposition takes at a time (wider weights are
#: decomposed in column chunks of at most this many values)
_DECOMPOSE_WEIGHTS = 1 << 26


def _cat_columns(parts: list) -> "WeightPlanes":
    """One bit-plane cache from the caches of consecutive column chunks:
    the words and planes side by side along N; occupancy (any value in the
    word over N) ORed and the column checksums (sums over N) added."""
    first, pks = parts[0], [p.packed for p in parts]

    def cat(ts):
        return None if ts[0] is None else torch.cat(ts, dim=-1)

    occ = torch.stack([p.occupancy for p in pks]).amax(dim=0)
    chk = None if pks[0].checksum is None else torch.stack([p.checksum for p in pks]).sum(
        dim=0, dtype=torch.int32)
    packed = PackedPlanes(
        mag=cat([p.mag for p in pks]), sign=cat([p.sign for p in pks]), k=pks[0].k,
        axis=pks[0].axis, weights=pks[0].weights, block=pks[0].block, occupancy=occ,
        checksum=chk,
    )
    return WeightPlanes(packed=packed, planes=cat([p.planes for p in parts]),
                        weights=first.weights, level=first.level, variant=first.variant,
                        w_bits=first.w_bits)


def make_weight_planes(
    w_q: torch.Tensor,
    *,
    w_bits: int,
    variant: Variant = "booth",
    level: str = "digit",
    radix_bits: int = 8,
    store: str = "auto",
    block: Optional[int] = DEFAULT_BLOCK,
    checksum: bool = False,
) -> WeightPlanes:
    """Decompose (and, at bit-plane level, pack) a quantized ``(K, N)``
    weight. ``store="auto"`` keeps only the packed words for a CUDA
    weight (the lean serving format the fused kernel reads; for a meta
    weight too: a dry run of the card) and also the raw planes for a host
    weight."""
    if w_q.dim() != 2:
        raise ValueError(f"make_weight_planes expects (K, N), got {tuple(w_q.shape)}")
    if store not in ("auto", "packed", "both"):
        raise ValueError(f"unknown store mode {store!r}")
    if store == "auto":
        store = "packed" if w_q.is_cuda or w_q.is_meta else "both"
    if level == "bitplane":
        k, n = w_q.shape
        step = max(1, _DECOMPOSE_WEIGHTS // max(k, 1))
        if n > step:
            # columns decompose independently: a whole vocabulary-wide head
            # at once would hold tens of GB of int32 / int64 intermediates
            return _cat_columns([
                make_weight_planes(w_q[:, i:i + step], w_bits=w_bits, variant=variant,
                                   level=level, radix_bits=radix_bits, store=store,
                                   block=block, checksum=checksum)
                for i in range(0, n, step)
            ])
        dec = to_bitplanes(w_q, w_bits, variant)
        packed = pack_decomposition(
            dec, axis=-2, variant=variant, block=block, checksum=checksum,
        )
        return WeightPlanes(
            packed=packed,
            planes=dec.planes if store == "both" else None,
            weights=dec.weights,
            level=level, variant=variant, w_bits=w_bits,
        )
    if level == "digit":
        dec = to_digits(w_q, w_bits, variant, radix_bits)
        return WeightPlanes(
            packed=None, planes=dec.planes, weights=dec.weights,
            level=level, variant=variant, w_bits=w_bits,
        )
    raise ValueError(f"no weight-plane cache for level {level!r}")


# ---------------------------------------------------------------------------
# Occupancy and plane compaction
# ---------------------------------------------------------------------------
#
# Per-(plane, word) occupancy bitmaps let a kernel skip plane-pair work
# (:func:`occupancy_per_tile` reduces words onto K tiles); compaction
# drops planes that are zero everywhere. Kept planes keep their original
# shift: ``weights`` is filtered, not renumbered, so every consumer reads
# the plane weights rather than assuming a dense bit index.


def occupancy_per_tile(occ: torch.Tensor, words_per_tile: int) -> torch.Tensor:
    """Reduce a ``(P, W)`` occupancy bitmap onto word-aligned K tiles:
    entry ``(p, t)`` is 1 iff any word of tile ``t`` in plane ``p`` is
    occupied. The word axis zero-pads to a whole tile (padding is inert)."""
    p, w = occ.shape
    nt = -(-w // words_per_tile)
    occ = _pad_axis(occ, 1, nt * words_per_tile - w)
    return (occ.reshape(p, nt, words_per_tile) != 0).any(dim=-1).to(torch.int32)


def plane_alive(packed: PackedPlanes) -> list[bool]:
    """Per plane, whether its occupancy bitmap has a set word anywhere (over
    any leading batch axes): the kept set of :func:`compact_packed`, read
    back to the host."""
    if packed.occupancy is None:
        raise ValueError("compact_packed needs occupancy metadata (re-pack first)")
    occ = packed.occupancy
    plane_axis = occ.dim() - 2
    reduce_axes = tuple(a for a in range(occ.dim()) if a != plane_axis)
    return [bool(a) for a in (occ != 0).any(dim=reduce_axes).tolist()]


def compact_packed(packed: PackedPlanes, alive: Optional[list] = None) -> PackedPlanes:
    """Drop planes whose occupancy bitmap is all zero. The kept set is
    shape information, so it is read back to the host: call this at load
    time. Surviving planes keep their shift weights, so the result
    reconstructs the same integers; an all-zero operand keeps one inert
    plane so no kernel sees an empty planes axis. ``alive`` (one bool per
    plane) overrides the kept set: the tensor-parallel shards of one weight
    keep the planes alive in any shard (``sharding/tp.py``)."""
    if packed.occupancy is None:
        raise ValueError("compact_packed needs occupancy metadata (re-pack first)")
    occ = packed.occupancy
    if len(packed.weights) != occ.shape[-2]:
        raise ValueError(
            "compaction needs per-plane weights to renumber shifts; pack via "
            "pack_decomposition / make_weight_planes (got "
            f"{len(packed.weights)} weights for {occ.shape[-2]} planes)"
        )
    plane_axis = occ.dim() - 2
    if alive is None:
        alive = plane_alive(packed)
    idx = [i for i, a in enumerate(alive) if a] or [0]
    if len(idx) == len(packed.weights):
        return packed
    mag_pa = packed.mag.dim() - 3
    return PackedPlanes(
        mag=_take_planes(packed.mag, idx, mag_pa),
        sign=_take_planes(packed.sign, idx, mag_pa),
        k=packed.k,
        axis=packed.axis,
        weights=tuple(packed.weights[i] for i in idx),
        block=packed.block,
        occupancy=_take_planes(occ, idx, plane_axis),
        checksum=None if packed.checksum is None
        else _take_planes(packed.checksum, idx, packed.checksum.dim() - 2),
    )


def compact_weight_planes(wp: WeightPlanes, alive: Optional[list] = None) -> WeightPlanes:
    """Compact a bit-plane weight cache: the packed words and the optional
    raw planes lose the same all-zero planes (or those ``alive`` marks
    dead; :func:`compact_packed`). ``w_bits`` is unchanged, so prefix
    truncation of the result stays exact."""
    if wp.level != "bitplane" or wp.packed is None:
        raise ValueError("compaction needs a packed bitplane cache")
    packed = compact_packed(wp.packed, alive)
    if packed is wp.packed:
        return wp
    keep = set(packed.weights)
    idx = [i for i, w in enumerate(wp.weights) if w in keep]
    planes = None if wp.planes is None else _take_planes(wp.planes, idx, wp.planes.dim() - 3)
    return WeightPlanes(
        packed=packed, planes=planes, weights=packed.weights,
        level=wp.level, variant=wp.variant, w_bits=wp.w_bits,
    )


# ---------------------------------------------------------------------------
# Prefix truncation (runtime precision reconfiguration)
# ---------------------------------------------------------------------------
#
# The top ``to_bits`` planes of a ``from_bits`` decomposition, with weights
# divided by 2^(from-to), are a complete ``to_bits`` decomposition of the
# requantized value: ``x >> s`` for unsigned/sbmwc, ``(x >> s) + bit_(s-1)``
# (round half up) for Booth. Truncation is one slice of the planes axis.


def shift_requantize(
    x: torch.Tensor, from_bits: int, to_bits: int, variant: Variant = "sbmwc"
) -> torch.Tensor:
    """Requantize ``from_bits`` integers to ``to_bits`` by the exact value
    the truncated plane prefix represents."""
    if to_bits > from_bits:
        raise ValueError(f"cannot requantize {from_bits} bits up to {to_bits}")
    s = from_bits - to_bits
    if s == 0:
        return x
    x = x.to(torch.int32)
    if variant == "booth":
        return (x >> s) + ((x >> (s - 1)) & 1)
    return x >> s


def truncate_packed(
    packed: PackedPlanes,
    to_bits: int,
    variant: Variant,
    from_bits: Optional[int] = None,
) -> PackedPlanes:
    """Top-``to_bits`` plane prefix of a packed decomposition: keep the
    planes whose weight magnitude is at least ``2^s`` and shift their
    weights down by ``s`` (also right for compacted caches)."""
    from_bits = packed.n_planes if from_bits is None else from_bits
    if not 1 <= to_bits <= from_bits:
        raise ValueError(f"to_bits must be in [1, {from_bits}], got {to_bits}")
    s = from_bits - to_bits
    if s == 0:
        return packed
    floor = 1 << s
    idx = [i for i, w in enumerate(packed.weights) if abs(w) >= floor]
    pa = packed.mag.dim() - 3
    if not idx:
        mag = torch.zeros_like(packed.mag.narrow(pa, 0, 1))
        return PackedPlanes(
            mag=mag,
            sign=None if packed.sign is None else torch.zeros_like(mag),
            k=packed.k, axis=packed.axis, weights=(1,), block=packed.block,
            occupancy=None if packed.occupancy is None else torch.zeros_like(
                packed.occupancy.narrow(packed.occupancy.dim() - 2, 0, 1)
            ),
            checksum=None if packed.checksum is None else torch.zeros_like(
                packed.checksum.narrow(packed.checksum.dim() - 2, 0, 1)
            ),
        )
    return PackedPlanes(
        mag=_take_planes(packed.mag, idx, pa),
        sign=_take_planes(packed.sign, idx, pa),
        k=packed.k,
        axis=packed.axis,
        weights=tuple(packed.weights[i] >> s for i in idx),
        block=packed.block,
        occupancy=None if packed.occupancy is None
        else _take_planes(packed.occupancy, idx, packed.occupancy.dim() - 2),
        checksum=None if packed.checksum is None
        else _take_planes(packed.checksum, idx, packed.checksum.dim() - 2),
    )


def truncate_weight_planes(wp: WeightPlanes, to_bits: int) -> WeightPlanes:
    """Truncate a bit-plane weight cache to its top ``to_bits`` planes —
    one stored 8-bit decomposition serves every precision below it."""
    if wp.level != "bitplane":
        raise ValueError(
            f"only bitplane caches are prefix-truncatable, got level={wp.level!r}"
        )
    if not 1 <= to_bits <= wp.w_bits:
        raise ValueError(f"to_bits must be in [1, {wp.w_bits}], got {to_bits}")
    if to_bits == wp.w_bits:
        return wp
    s = wp.w_bits - to_bits
    floor = 1 << s
    idx = [i for i, w in enumerate(wp.weights) if abs(w) >= floor]
    packed = (
        None if wp.packed is None
        else truncate_packed(wp.packed, to_bits, wp.variant, from_bits=wp.w_bits)  # type: ignore[arg-type]
    )
    if wp.planes is None:
        planes = None
    elif idx:
        planes = _take_planes(wp.planes, idx, wp.planes.dim() - 3)
    else:
        planes = torch.zeros_like(wp.planes.narrow(wp.planes.dim() - 3, 0, 1))
    weights = tuple(wp.weights[i] >> s for i in idx) or (1,)
    return WeightPlanes(
        packed=packed, planes=planes, weights=weights,
        level=wp.level, variant=wp.variant, w_bits=to_bits,
    )


# ---------------------------------------------------------------------------
# ABFT column checksums
# ---------------------------------------------------------------------------
#
# A checksummed pack stores, per plane, the signed sum of plane values
# over the non-packed axes. checksum_vector folds it with the plane
# weights into the row-sum vector of the integer weight the kernel
# consumes (the plans' matmul-time identity); verify_packed recomputes
# checksums and occupancy from the stored words (an at-rest probe).
# Truncation and compaction slice the checksum rows with the words, so
# the identity holds at every tier of one stored cache.


def checksum_vector(packed: PackedPlanes, dtype=torch.int32) -> torch.Tensor:
    """``sum_p weights[p] * checksum[p]``: the row-sum vector (length K,
    plus any leading batch dims) of the reconstructed integer matrix."""
    if packed.checksum is None:
        raise ValueError(
            "checksum_vector needs a checksummed pack (pack_planes(..., checksum=True))"
        )
    ww = _const(packed.weights, dtype, packed.checksum.device)
    return torch.sum(packed.checksum.to(dtype) * ww.reshape(-1, 1), dim=-2, dtype=dtype)


def verify_packed(packed: PackedPlanes) -> torch.Tensor:
    """Recompute column checksums (and occupancy) from the stored words and
    compare with the stored copies: a 0-dim bool tensor, True when they
    agree. Catches any single flip in the consumed extent of the words,
    occupancy or checksums, and a sign bit set without its mag bit; flips
    in padding bit positions need the bit-pattern fingerprint."""
    if packed.checksum is None:
        raise ValueError("verify_packed needs a checksummed pack")
    vals = unpack_planes(packed, dtype=torch.int32)
    reduce_axes = tuple(a for a in range(vals.dim()) if a not in (0, packed.axis))
    sums = vals.sum(dim=reduce_axes, dtype=torch.int32) if reduce_axes else vals
    ok = torch.all(sums == packed.checksum)
    if packed.occupancy is not None:
        occ_axes = tuple(a for a in range(packed.mag.dim()) if a not in (0, packed.axis))
        nz = packed.mag != 0
        occ = (nz.any(dim=occ_axes) if occ_axes else nz).to(torch.int32)
        ok = ok & torch.all(occ == packed.occupancy)
    if packed.sign is not None:
        ok = ok & torch.all((packed.sign & ~packed.mag) == 0)
    return ok


def booth_nonzero_digit_count(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Number of non-zero Booth digits per element (the paper's motivation:
    runs of ones collapse to two non-zero digits; plane-skip scheduling
    analytics), int32."""
    dec = to_bitplanes(x, bits, "booth")
    return dec.planes.to(torch.int32).abs().sum(dim=0, dtype=torch.int32)
