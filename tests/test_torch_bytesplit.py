"""The byte split the tensor-core plane kernels rely on (``kernels/bytesplit.py``).

With pair weights ``pw = wrap32(wa (x) ww)`` the plane-pair sum is ``A @ W``
modulo 2^32, and the kernels compute it as ``sum_{b,d} 256^b c_d (A_b @ D_d)``
over the activation's signed base-256 digits ``A_b`` and the weight words'
byte digits ``D_d``. Here the host helpers that pick the digits are tested,
and the identity is held, bit for bit (integer results), against the plain
plane-pair contraction and the JAX reference's ``fused_linear`` and
``plane_matmul_packed`` (jnp backend): booth, sbmwc and unsigned; bits 1-8,
16-bit packed operands, truncated tiers, compacted caches; corrupted words
(a flipped bit, a sign bit without its magnitude bit); K not a multiple of
32. The kernels themselves are held against their plain versions on the
card by ``test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import bitplanes as tbp
from repro_torch.core.bitserial import _wrap_weights
from repro_torch.kernels import bytesplit as bs
from repro_torch.kernels import plane_mm_fused, plane_mm_packed

from _torch_parity import packed_to_jax, t2n
from _torch_words import corrupt_words


def _ints(rng, bits, variant, shape):
    lo, hi = (0, (1 << bits) - 1) if variant == "unsigned" else tbp.signed_range(bits)
    return torch.from_numpy(rng.integers(lo, hi + 1, shape).astype(np.int32))


def _corrupt(packed: tbp.PackedPlanes, rng) -> tbp.PackedPlanes:
    gen = torch.Generator()
    gen.manual_seed(int(rng.integers(1 << 31)))
    return corrupt_words(packed, gen)


@pytest.mark.parametrize("ww,ternary,n_digits,s8", [
    (tuple(1 << i for i in range(8)), True, 2, False),  # 8 Booth planes: one group
    (tuple(1 << i for i in range(7)) + (-128,), False, 1, True),  # 8-bit SBMwC: one s8 byte
    (tuple(1 << i for i in range(8)), False, 1, False),  # unsigned
    ((1, 2, 8, 32, 64, 128), True, 2, False),  # compacted: holes in one byte
    ((1, 2, 4, -8), False, 2, False),  # 4-bit SBMwC (a truncated tier): top plane alone
    (tuple(1 << i for i in range(16)), True, 4, False),  # 16 planes: two groups
    ((1 << 32, 1, 2), True, 2, False),  # a weight of 0 mod 2^32 is left out
])
def test_weight_digits(ww, ternary, n_digits, s8):
    digits = bs.weight_digits(ww, ternary)
    assert len(digits) == n_digits
    assert digits[0].s8 == s8
    placed = [j for d in digits if not d.sign for j in d.slots if j is not None]
    assert sorted(placed) == [j for j, w in enumerate(ww) if w & bs.MASK32]
    for d in digits:  # bit p of a digit's byte carries its plane's (mag or -2 sign) weight
        for p, j in enumerate(d.slots):
            if j is not None:
                bit = -(1 << 7) if (p == 7 and d.s8) else 1 << p
                want = -2 * ww[j] if d.sign else ww[j]
                assert (d.coef * bit - want) & bs.MASK32 == 0, (d, p, j)


@pytest.mark.parametrize("weights,ternary,want", [
    (tuple(1 << i for i in range(8)), True, 2),  # [-510, 255]
    (tuple(1 << i for i in range(7)) + (-128,), False, 1),  # [-128, 127]
    (tuple(1 << i for i in range(8)), False, 2),  # [0, 255]
    (tuple(1 << i for i in range(7)), False, 1),  # [0, 127]
    ((1,), True, 1),  # one Booth plane: [-2, 1]
    (tuple(1 << i for i in range(16)), True, 3),  # 16 Booth planes: [-131070, 65535]
    ((1 << 31, 1), False, 4),  # beyond int32: four bytes hold every value mod 2^32
])
def test_signed_byte_count(weights, ternary, want):
    assert bs.signed_byte_count(weights, ternary) == want


@pytest.mark.parametrize("n_bytes", [1, 2, 3, 4])
def test_split_signed_bytes_reconstructs_mod_2_32(n_bytes, rng):
    x = torch.from_numpy(np.concatenate([
        rng.integers(-(1 << 40), 1 << 40, 500),
        [0, -1, 127, -128, 128, -129, 2**31 - 1, -(2**31), 2**32 + 5],
    ]).astype(np.int64))
    d = bs.split_signed_bytes(x, n_bytes)
    assert d.dtype == torch.int8 and d.shape == (n_bytes,) + x.shape
    back = sum(d[b].to(torch.int64) << (8 * b) for b in range(n_bytes))
    if n_bytes == 4:  # every value, modulo 2^32
        assert torch.equal(back & bs.MASK32, x & bs.MASK32)
    else:  # exact where the bytes hold x modulo 2^32 (as int32)
        x32 = (x & bs.MASK32) - ((x >> 31 & 1) << 32)
        lim = 1 << (8 * n_bytes - 1)
        fits = (x32 >= -lim) & (x32 < lim)
        assert int(fits.sum()) >= 4
        assert torch.equal(back[fits], x32[fits])


def _fused_case(rng, m, k, n, a_bits, w_bits, variant, block, tier, compact, corrupt):
    # activations in the a_bits range (an unsigned byte as its int8 bit
    # pattern): outside it the reference's jnp oracle (to_bitplanes) and the
    # kernels (low-bit slicing) read different planes
    x = _ints(rng, a_bits, variant, (m, k)).to(torch.int8)
    w = _ints(rng, w_bits, variant, (k, n))
    if compact:
        w = w & ~1  # even values: plane 0 is zero in every variant, compaction drops it
    wp = tbp.make_weight_planes(w, w_bits=w_bits, variant=variant, level="bitplane",
                                block=block)
    if compact:
        wp = tbp.compact_weight_planes(wp)
        assert len(wp.weights) < w_bits
    if tier is not None:
        wp = tbp.truncate_weight_planes(wp, tier)
    packed = _corrupt(wp.packed, rng) if corrupt else wp.packed
    return x, packed


@pytest.mark.parametrize("variant,a_bits,w_bits,m,k,n,block,tier,compact,corrupt", [
    ("booth", 8, 8, 5, 70, 9, 512, None, False, False),
    ("booth", 8, 8, 4, 300, 12, 128, None, False, True),
    ("booth", 5, 8, 3, 100, 7, 32, 4, False, False),
    ("booth", 1, 8, 2, 64, 5, 512, None, True, True),
    ("sbmwc", 3, 8, 6, 45, 8, 96, None, False, True),
    ("sbmwc", 8, 4, 2, 33, 16, 512, None, False, False),
    ("unsigned", 8, 8, 3, 130, 6, 512, None, False, True),
    ("unsigned", 6, 5, 4, 31, 3, 32, None, True, False),
])
def test_bytesplit_fused_equals_plain_and_reference(variant, a_bits, w_bits, m, k, n, block,
                                                   tier, compact, corrupt, rng):
    """The fused kernel's sum: x's one activation byte against the weight
    words' byte digits — the plain plane-pair contraction and the JAX
    fused_linear give the same int32 accumulator."""
    x, packed = _fused_case(rng, m, k, n, a_bits, w_bits, variant, block, tier, compact, corrupt)
    wa = tbp.plane_weights(a_bits, variant)
    digits = bs.weight_digits(packed.weights, packed.sign is not None)
    got = bs.bytesplit_matmul(bs.fused_activation_digits(x, a_bits, variant),
                              bs.weight_digit_bytes(packed, digits), digits)
    pw = _wrap_weights([a * b for a in wa for b in packed.weights])
    plain = plane_mm_fused.fused_plane_linear_plain(x, packed, pw, a_bits=a_bits, variant=variant)
    assert torch.equal(got, plain)
    ref = jax.jit(lambda xj, pj: jops.fused_linear(
        xj, pj, None, a_bits=a_bits, variant=variant, backend="jnp"))(t2n(x), packed_to_jax(packed))
    np.testing.assert_array_equal(np.asarray(ref), t2n(got))


@pytest.mark.parametrize("variant,a_bits,w_bits,m,k,n,block,tier,corrupt", [
    ("booth", 8, 8, 4, 1030, 24, 512, None, False),
    ("booth", 8, 8, 3, 200, 10, None, None, True),
    ("booth", 16, 8, 2, 70, 9, None, None, False),  # 16-bit A: three activation digits
    ("booth", 8, 16, 3, 40, 5, 128, None, True),  # 16-bit W: two groups
    ("booth", 4, 8, 2, 260, 8, 32, 6, False),
    ("sbmwc", 8, 8, 3, 300, 17, None, None, True),
    ("unsigned", 6, 4, 7, 33, 5, None, None, False),
])
def test_bytesplit_packed_equals_plain_and_reference(variant, a_bits, w_bits, m, k, n, block,
                                                    tier, corrupt, rng):
    """The packed kernel's sum: A's signed digits (from its words as
    stored) against W's byte digits."""
    pa = tbp.pack_decomposition(tbp.to_bitplanes(_ints(rng, a_bits, variant, (m, k)), a_bits,
                                                 variant), axis=-1, variant=variant, block=block)
    pk = tbp.pack_decomposition(tbp.to_bitplanes(_ints(rng, w_bits, variant, (k, n)), w_bits,
                                                 variant), axis=-2, variant=variant, block=block)
    if tier is not None:
        pk = tbp.truncate_packed(pk, tier, variant, from_bits=w_bits)
    if corrupt:
        pa, pk = _corrupt(pa, rng), _corrupt(pk, rng)
    digits = bs.weight_digits(pk.weights, pk.sign is not None)
    a_dig = bs.packed_activation_digits(pa)
    assert a_dig.shape[0] == bs.signed_byte_count(tuple(pa.weights), pa.sign is not None)
    got = bs.bytesplit_matmul(a_dig, bs.weight_digit_bytes(pk, digits), digits)
    pw = _wrap_weights([a * b for a in pa.weights for b in pk.weights])
    assert torch.equal(got, plane_mm_packed.plane_matmul_packed_plain(pa, pk, pw))
    ref = jax.jit(lambda a, w, p: jops.plane_matmul_packed(a, w, p, backend="jnp"))(
        packed_to_jax(pa), packed_to_jax(pk), t2n(pw))
    np.testing.assert_array_equal(np.asarray(ref), t2n(got))


@pytest.mark.parametrize("variant", ["booth", "sbmwc", "unsigned"])
@pytest.mark.parametrize("bits", range(1, 9))
def test_bytesplit_equals_plane_pairs_at_every_width(variant, bits, rng):
    """Both kernels' sums at a_bits = w_bits = 1..8 (K = 45, not a multiple
    of 32), against the plain plane-pair contraction: x's one byte and A's
    signed digits from its words give the same int32 accumulator."""
    x = _ints(rng, bits, variant, (3, 45))
    pa = tbp.pack_decomposition(tbp.to_bitplanes(x, bits, variant), axis=-1, variant=variant)
    pk = tbp.pack_decomposition(tbp.to_bitplanes(_ints(rng, bits, variant, (45, 7)), bits,
                                                 variant), axis=-2, variant=variant, block=64)
    pw = _wrap_weights([a * b for a in pa.weights for b in pk.weights])
    digits = bs.weight_digits(pk.weights, pk.sign is not None)
    w_bytes = bs.weight_digit_bytes(pk, digits)
    fused = bs.bytesplit_matmul(bs.fused_activation_digits(x, bits, variant), w_bytes, digits)
    assert torch.equal(fused, plane_mm_fused.fused_plane_linear_plain(
        x.to(torch.int8), pk, pw, a_bits=bits, variant=variant))
    assert torch.equal(bs.bytesplit_matmul(bs.packed_activation_digits(pa), w_bytes, digits),
                       fused)


def test_valid_int8_activation_has_zero_high_digit(rng):
    """A valid 8-plane Booth decomposition of int8 values needs one signed
    byte: the kernel's per-chunk gate skips the second digit's products."""
    x = torch.from_numpy(rng.integers(-128, 128, (6, 300)).astype(np.int32))
    pa = tbp.pack_decomposition(tbp.to_bitplanes(x, 8, "booth"), axis=-1, variant="booth",
                                block=512)
    a_dig = bs.packed_activation_digits(pa)
    assert a_dig.shape[0] == 2 and not bool(a_dig[1].any())
    assert torch.equal(a_dig[0].to(torch.int32), x)


def test_foreign_pair_weights_are_refused(rng):
    """The byte split refuses pair weights that are not the outer product
    of the plane weights: they take the all-pairs path instead."""
    wa = tbp.plane_weights(8, "booth")
    ww = tbp.plane_weights(8, "booth")
    pw = _wrap_weights([a * b for a in wa for b in ww])
    assert bs.is_outer_product(pw, wa, ww)
    assert bs.pair_route(pw, wa, ww, 8, 8) == bs.BYTESPLIT
    bad = pw.clone()
    bad[int(rng.integers(bad.numel()))] += 1
    assert not bs.is_outer_product(bad, wa, ww)
    assert bs.pair_route(bad, wa, ww, 8, 8) == bs.ALL_PAIRS
    assert not bs.is_outer_product(pw[:-1], wa, ww)


def test_digit_plan_struct():
    wa, ww = tbp.plane_weights(8, "booth"), tbp.plane_weights(8, "sbmwc")
    plan = bs.digit_plan(wa, ww, False, 1)
    assert (plan.n_wd, plan.n_ad, plan.n_a, plan.n_w) == (1, 1, 8, 8)
    assert list(plan.wplane[0]) == list(range(8)) and plan.ws8[0] == 1
    assert list(plan.wa)[:8] == [1 << i for i in range(8)]
    assert plan.wcoef[0] == 1  # SBMwC's planes share one two's-complement byte
    assert bs.digit_plan(wa, ww, False, 1) is plan  # built once per key
    assert bs.row_tile(4) == 8 and bs.row_tile(100) == bs.ROW_TILES[-1]
    with pytest.raises(ValueError, match="bm must be one of"):
        bs.row_tile(4, bm=12)
