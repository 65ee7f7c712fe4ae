"""Port parity of the core numerics: plane decompositions, packed words,
occupancy, truncation, quantization and the precision policy.

Every integer result of ``repro_torch.core`` is held bit-equal to the JAX
reference on the same inputs (made from a numpy seed).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import bitplanes as jbp
from repro.core import bitserial as jbs
from repro.core.precision import LayerPrecision as JLP
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.core.quantize import quantize as jquantize
from repro_torch.core import bitplanes as tbp
from repro_torch.core import bitserial as tbs
from repro_torch.core.precision import LayerPrecision as TLP
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.quantize import quantize as tquantize

from _torch_parity import j2t, t2n

VARIANTS = ("unsigned", "sbmwc", "booth")


def _ints(rng, bits, variant, shape):
    lo, hi = (0, (1 << bits) - 1) if variant == "unsigned" else jbp.signed_range(bits)
    return rng.integers(lo, hi + 1, shape).astype(np.int32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), t2n(b))


BLOCKS = (None, 32, 512)


@functools.partial(jax.jit, static_argnames=("variant",))
def _jax_decompose_and_pack(xs, *, variant):
    """The reference's planes and packed words for bits 1..8 and every
    layout, in one compiled call per variant (eager JAX compiles each
    primitive separately, which costs seconds per case)."""
    out = []
    for bits, x in zip(range(1, 9), xs):
        dec = jbp.to_bitplanes(x, bits, variant)
        packs = [
            jbp.pack_decomposition(dec, axis=-2, variant=variant, block=b, checksum=True)
            for b in BLOCKS
        ]
        out.append((dec.planes, [(p.mag, p.sign, p.occupancy, p.checksum) for p in packs],
                    [jbp.unpack_planes(p) for p in packs]))
    return out


_PACK_CASES: dict = {}


def _pack_case(variant, bits):
    """(x, reference outputs) for one case; computed per variant once."""
    if variant not in _PACK_CASES:
        rng = np.random.default_rng(7)
        xs = [_ints(rng, b, variant, (37, 19)) for b in range(1, 9)]
        ref = _jax_decompose_and_pack([jnp.asarray(x) for x in xs], variant=variant)
        _PACK_CASES[variant] = list(zip(xs, ref))
    return _PACK_CASES[variant][bits - 1]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("bits", range(1, 9))
def test_bitplanes_and_packed_words_equal_reference(variant, bits):
    """Planes, weights, packed mag/sign words (planar and blocked, incl. the
    small-K block clamp), occupancy, column checksums — ragged K."""
    x, (planes_j, packs_j, unpacked_j) = _pack_case(variant, bits)
    dt = tbp.to_bitplanes(torch.from_numpy(x), bits, variant)
    _eq(planes_j, dt.planes)
    assert tbp.plane_weights(bits, variant) == jbp.plane_weights(bits, variant) == dt.weights
    for block, (mag, sign, occ, chk), unp in zip(BLOCKS, packs_j, unpacked_j):
        pt = tbp.pack_decomposition(dt, axis=-2, variant=variant, block=block, checksum=True)
        want_block = None if block is None else (block if block <= 128 else 128)
        assert pt.block == want_block and pt.k == 37 and pt.axis == 1
        _eq(mag, pt.mag)
        assert (sign is None) == (pt.sign is None)
        if sign is not None:
            _eq(sign, pt.sign)
        _eq(occ, pt.occupancy)
        _eq(chk, pt.checksum)
        _eq(unp, tbp.unpack_planes(pt))
        _eq(planes_j, tbp.unpack_planes(pt))


def test_packed_words_with_bit31_set_equal_reference(rng):
    """Words whose bit 31 is set are negative int32 in both packages."""
    x = rng.integers(-128, 128, (1024, 6)).astype(np.int32)
    pj = jax.jit(lambda v: jbp.pack_decomposition(
        jbp.to_bitplanes(v, 8, "booth"), axis=-2, variant="booth", block=512
    ))(jnp.asarray(x))
    pt = tbp.pack_decomposition(tbp.to_bitplanes(torch.from_numpy(x), 8, "booth"),
                                axis=-2, variant="booth", block=512)
    assert (np.asarray(pj.mag) < 0).any()
    _eq(pj.mag, pt.mag)
    _eq(pj.sign, pt.sign)


def test_booth_closed_range_value(rng):
    """+2^(b-1) (one past the two's-complement max) decomposes exactly."""
    for bits in range(2, 9):
        x = np.array([1 << (bits - 1), -(1 << (bits - 1)), 0, 1], np.int32)
        dt = tbp.to_bitplanes(torch.from_numpy(x), bits, "booth")
        assert t2n(dt.reconstruct()).tolist() == x.tolist()
        # the closed-range fix lands on the top plane only
        assert t2n(dt.planes[bits - 1])[0] == 1 and t2n(dt.planes[: bits - 1, 0]).tolist() == [0] * (bits - 1)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("bits", [1, 3, 8, 12, 16])
def test_digits_equal_reference(variant, bits, rng):
    x = _ints(rng, bits, variant, (11, 7))
    dj = jbp.to_digits(jnp.asarray(x), bits, variant)
    dt = tbp.to_digits(torch.from_numpy(x), bits, variant)
    _eq(dj.planes, dt.planes)
    assert dj.weights == dt.weights
    assert t2n(dt.reconstruct()).tolist() == x.tolist()


@functools.partial(jax.jit, static_argnames=("variant", "level"))
def _jax_weight_planes(w, *, variant, level):
    wp = jbp.make_weight_planes(w, w_bits=8, variant=variant, level=level, store="both")
    if level != "bitplane":
        return wp, []
    return wp, [jbp.truncate_weight_planes(wp, b) for b in range(1, 8)]


@pytest.mark.parametrize(
    "level,variant", [("bitplane", "sbmwc"), ("bitplane", "booth"), ("digit", "booth")]
)
def test_weight_planes_and_truncation_equal_reference(level, variant, rng):
    """make_weight_planes (a host weight keeps its raw planes, as the
    reference's non-TPU store does) and every truncation tier 8 -> 1."""
    w = rng.integers(-128, 128, (200, 24)).astype(np.int32)
    wj, tiers = _jax_weight_planes(jnp.asarray(w), variant=variant, level=level)
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant=variant, level=level)
    assert wj.weights == wt.weights
    _eq(wj.planes, wt.planes)
    if level == "digit":
        assert wt.packed is None
        return
    _eq(wj.packed.mag, wt.packed.mag)
    for to_bits, tj in zip(range(1, 8), tiers):
        tt = tbp.truncate_weight_planes(wt, to_bits)
        assert tj.weights == tt.weights and tj.w_bits == tt.w_bits == to_bits
        _eq(tj.packed.mag, tt.packed.mag)
        if variant == "booth":
            _eq(tj.packed.sign, tt.packed.sign)
        _eq(tj.packed.occupancy, tt.packed.occupancy)
        _eq(tj.planes, tt.planes)


@pytest.mark.parametrize("variant", ["unsigned", "sbmwc", "booth"])
def test_shift_requantize_equal_reference(variant, rng):
    x = _ints(rng, 8, variant, (64,))
    for to_bits in range(1, 9):
        _eq(jbp.shift_requantize(jnp.asarray(x), 8, to_bits, variant),
            tbp.shift_requantize(torch.from_numpy(x), 8, to_bits, variant))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_equal_reference_eager(bits, rng):
    """Weight quantization at load (eager in the reference): values by
    division and round-half-even, per-channel scales by division."""
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    qj = jquantize(jnp.asarray(w), bits, axis=-2)
    qt = tquantize(torch.from_numpy(w), bits, axis=-2)
    _eq(qj.values, qt.values)
    _eq(qj.scale, qt.scale)


def test_activation_quantize_equals_compiled_reference(rng):
    """Per-token activation quantization inside the reference's compiled
    steps: XLA folds ``amax / qmax`` into ``amax * f32(1/qmax)``; the
    port's ``reciprocal_scale`` path reproduces it bit for bit."""
    x = (rng.standard_normal((300, 128)) * 3).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    qj = jax.jit(lambda v: jquantize(v, 8, axis=-1))(jnp.asarray(x))
    qt = tquantize(torch.from_numpy(x), 8, axis=-1, reciprocal_scale=True)
    _eq(qj.values, qt.values)
    _eq(qj.scale, qt.scale)


@pytest.mark.parametrize(
    "level,variant", [("bitplane", "sbmwc"), ("bitplane", "booth"), ("digit", "booth")]
)
def test_bitserial_matmul_int32_equal_reference(level, variant, rng):
    a = rng.integers(-128, 128, (9, 50)).astype(np.int32)
    w = rng.integers(-128, 128, (50, 7)).astype(np.int32)
    accj = jbs.bitserial_matmul(jnp.asarray(a), jnp.asarray(w), a_bits=8, w_bits=8,
                                variant=variant, level=level)
    acct = tbs.bitserial_matmul(torch.from_numpy(a), torch.from_numpy(w), a_bits=8,
                                w_bits=8, variant=variant, level=level)
    _eq(accj, acct)
    assert t2n(acct).tolist() == (a @ w).tolist()


def test_wrap_weights_equal_reference():
    ws = [1, 256, 65536, 1 << 24, 1 << 32, -(1 << 31), (1 << 31), 3 << 30]
    _eq(jbs._wrap_weights(ws, jnp.int32), tbs._wrap_weights(ws))


def test_precision_policy_matches_reference():
    spec = {"": (8, 8), "lm_head": (None, None), "layers/dense/mlp": (4, 6)}
    pj = JPolicy.from_dict(spec, level="bitplane")
    pt = TPolicy.from_dict(spec, level="bitplane")
    for name in ("layers/dense/attn/q_proj", "layers/dense/mlp/down_proj", "lm_head"):
        lj, lt = pj.lookup(name), pt.lookup(name)
        assert (lj.w_bits, lj.a_bits) == (lt.w_bits, lt.a_bits)
        for rb in ((4, 4), (2, 8), (None, 5)):
            ej = pj.with_runtime_bits(*rb).lookup_effective(name)
            et = pt.with_runtime_bits(*rb).lookup_effective(name)
            assert (ej.w_bits, ej.a_bits) == (et.w_bits, et.a_bits)
    assert pj.storage_width() == pt.storage_width() == 8
    with pytest.raises(ValueError):
        TLP(w_bits=8)
    assert JLP(8, 8).active and TLP(8, 8).active


@settings(deadline=None, max_examples=25)
@given(
    bits=st.integers(1, 8),
    variant=st.sampled_from(VARIANTS),
    k=st.integers(1, 300),
    block=st.sampled_from([None, 32, 64, 512]),
    seed=st.integers(0, 2**31 - 1),
)
def test_pack_roundtrip_property(bits, variant, k, block, seed):
    """Any decomposition packs and unpacks exactly, on both the planar and
    the blocked layouts, for any K."""
    x = _ints(np.random.default_rng(seed), bits, variant, (k, 3))
    dt = tbp.to_bitplanes(torch.from_numpy(x), bits, variant)
    pt = tbp.pack_decomposition(dt, axis=-2, variant=variant, block=block)
    assert torch.equal(tbp.unpack_planes(pt), dt.planes)
    assert t2n(dt.reconstruct()).tolist() == x.tolist()
    assert j2t(np.asarray(x)).shape == (k, 3)
