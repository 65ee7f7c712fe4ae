"""Port parity of the packed plane matmul and the bitplanes helpers the
packed routes and the ABFT checks need.

Tolerance: bit-equal throughout (integer results). The packed kernel's
plain version is held against the reference's Pallas kernel run in
interpret mode at one grid step per case, and against the reference's
jnp oracle at more shapes; occupancy tiles, compaction, column-checksum
vectors and ``verify_packed`` against the reference's functions. The
Hopper kernel itself is held against the plain version on the card by
``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.kernels import ops as jops
from repro.kernels.plane_mm_packed import plane_matmul_packed as jplane_matmul_packed
from repro_torch.core import bitplanes as tbp
from repro_torch.core.bitserial import _wrap_weights
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plane_mm_packed
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.models.quant import quantize_params as tquantize_params

from _torch_parity import packed_to_jax as _to_jax
from _torch_parity import t2n

VARIANTS = ("unsigned", "sbmwc", "booth")


def _ints(rng, bits, variant, shape):
    lo, hi = (0, (1 << bits) - 1) if variant == "unsigned" else jbp.signed_range(bits)
    return rng.integers(lo, hi + 1, shape).astype(np.int32)


def _pack(x, bits, variant, axis, block, checksum=False):
    """(JAX, port) packed decompositions of the same integers."""
    pt = tbp.pack_decomposition(tbp.to_bitplanes(torch.from_numpy(x), bits, variant),
                                axis=axis, variant=variant, block=block, checksum=checksum)
    return _to_jax(pt), pt


def _operands(rng, m, k, n, a_bits, w_bits, variant, block):
    """Packed A and W (shared layout) with the top weight planes of the
    first half of K zero, so gated tiles exist, and their pair weights."""
    x = _ints(rng, a_bits, variant, (m, k))
    w = _ints(rng, w_bits, variant, (k, n))
    w[: k // 2] >>= 3
    aj, at = _pack(x, a_bits, variant, -1, block)
    wj, wt = _pack(w, w_bits, variant, -2, block)
    pw = _wrap_weights([a * b for a in at.weights for b in wt.weights])
    return x, w, (aj, wj, jnp.asarray(t2n(pw))), (at, wt, pw)


@functools.partial(jax.jit, static_argnames=("gate",))
def _jax_interpret(aj, wj, pw, *, gate):
    return jplane_matmul_packed(aj, wj, pw, bm=8, bn=128, bk=128, gate=gate, interpret=True)


@pytest.mark.parametrize("variant,block,gate", [("booth", 512, True), ("sbmwc", None, False)])
def test_plain_equals_pallas_kernel_in_interpret_mode(variant, block, gate, rng):
    """One grid step of the reference kernel (M 5 <= bm, N 9 <= bn, ragged
    K 70 in one 128-wide K tile), blocked and global-planar layouts, Booth
    sign words and SBMwC binary planes, gated and dense."""
    x, w, (aj, wj, pwj), (at, wt, pwt) = _operands(rng, 5, 70, 9, 8, 8, variant, block)
    want = np.asarray(_jax_interpret(aj, wj, pwj, gate=gate))
    got = plane_mm_packed.plane_matmul_packed_plain(at, wt, pwt)
    np.testing.assert_array_equal(want, t2n(got))
    np.testing.assert_array_equal(t2n(got), x.astype(np.int64) @ w)
    got_gate = plane_mm_packed.plane_matmul_packed(at, wt, pwt, gate=gate)
    np.testing.assert_array_equal(t2n(got_gate), want)


@jax.jit
def _jax_oracle(aj, wj, pw):
    return jops.plane_matmul_packed(aj, wj, pw, backend="jnp")


@pytest.mark.parametrize("variant,a_bits,w_bits,m,k,n,block,tier", [
    ("booth", 8, 8, 4, 1030, 24, 512, None),
    ("booth", 8, 8, 16, 96, 40, 512, 4),
    ("sbmwc", 8, 8, 3, 300, 17, None, None),
    ("unsigned", 6, 4, 7, 33, 5, None, None),
    ("booth", 4, 8, 2, 260, 8, 32, 6),
])
def test_plain_equals_reference_jnp_oracle(variant, a_bits, w_bits, m, k, n, block, tier, rng):
    """ops.plane_matmul_packed on the plain version against the reference's
    jnp oracle, including a truncated weight tier (shifted pair weights)."""
    x, _, (aj, wj, pwj), (at, wt, pwt) = _operands(rng, m, k, n, a_bits, w_bits, variant, block)
    if tier is not None:
        wt = tbp.truncate_packed(wt, tier, variant, from_bits=w_bits)
        wj = jbp.truncate_packed(wj, tier, variant, from_bits=w_bits)
        assert wj.weights == wt.weights
        np.testing.assert_array_equal(np.asarray(wj.mag), t2n(wt.mag))
        pwt = _wrap_weights([a * b for a in at.weights for b in wt.weights])
        pwj = jnp.asarray(t2n(pwt))
    want = np.asarray(_jax_oracle(aj, wj, pwj))
    got = tops.plane_matmul_packed(at, wt, pwt, backend="torch", gate=True)
    np.testing.assert_array_equal(want, t2n(got))


def test_validate_packed_operands_matches_reference_contract(rng):
    # K = 128: one 128-value block and the global planar layout both take 4 words
    _, _, (aj, wj, pwj), (at, wt, pwt) = _operands(rng, 2, 128, 3, 8, 8, "booth", 512)
    _, _, (aj2, _, _), (at2, _, _) = _operands(rng, 2, 128, 3, 8, 8, "booth", None)
    for a_t, pw_t, match in ((at2, pwt, "different layouts"), (at, pwt[:-1], "pair_weights")):
        with pytest.raises(ValueError, match=match):
            plane_mm_packed.validate_packed_operands(a_t, wt, pw_t)
    with pytest.raises(ValueError, match="different layouts"):
        jops.plane_matmul_packed(aj2, wj, pwj, backend="jnp")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.plane_matmul_packed(at, wt, pwt, backend="cuda")


# ---------------------------------------------------------------------------
# bitplanes helpers
# ---------------------------------------------------------------------------


@jax.jit
def _jax_helpers(packs, flipped):
    """The reference's tile occupancy, checksum vectors and verify_packed
    for many packs in one compiled call."""
    return [
        ([jbp.occupancy_per_tile(p.occupancy, wpt) for wpt in (1, 3, 4)],
         jbp.checksum_vector(p), jbp.verify_packed(p), jbp.verify_packed(f))
        for p, f in zip(packs, flipped)
    ]


def _flip(pt):
    mag = pt.mag.clone()
    mag[0, 0, 1] ^= 2
    return tbp.PackedPlanes(mag, pt.sign, pt.k, pt.axis, pt.weights, pt.block,
                            pt.occupancy, pt.checksum)


_HELPER_CASES: dict = {}


def _helper_cases(variant):
    """Bits 1-8 x both layouts for every variant, with the reference's
    results from one compiled call (made once per module)."""
    if not _HELPER_CASES:
        rng = np.random.default_rng(11)
        for v in VARIANTS:
            cases = []
            for block in (None, 512):
                for bits in range(1, 9):
                    # small values leave the top planes empty, so compaction drops some
                    x = _ints(rng, bits, v, (70, 6)) >> (bits // 2)
                    if v == "sbmwc" and bits > 1:
                        x = np.abs(x)  # a negative value sets the SBMwC sign plane
                    pt = _pack(x, bits, v, -2, block, checksum=True)[1]
                    cases.append((x, pt, _flip(pt)))
            _HELPER_CASES[v] = cases
        flat = [c for v in VARIANTS for c in _HELPER_CASES[v]]
        want = iter(_jax_helpers([_to_jax(pt) for _, pt, _ in flat],
                                 [_to_jax(ft) for _, _, ft in flat]))
        for v in VARIANTS:
            _HELPER_CASES[v] = [(c, next(want)) for c in _HELPER_CASES[v]]
    return _HELPER_CASES[variant]


@pytest.mark.parametrize("variant", VARIANTS)
def test_occupancy_compaction_and_checksums_equal_reference(variant):
    """Bits 1-8, ragged K, global planar and blocked layouts: tile
    occupancy, compacted words/occupancy/checksums/weights, the folded
    checksum vector and verify_packed (clean, and after one flipped word
    bit) all equal the reference's."""
    dropped = 0
    for (x, pt, ft), (tiles_j, cv_j, ok_j, bad_j) in _helper_cases(variant):
        for wpt, tj in zip((1, 3, 4), tiles_j):
            np.testing.assert_array_equal(np.asarray(tj), t2n(tbp.occupancy_per_tile(pt.occupancy, wpt)))
        np.testing.assert_array_equal(np.asarray(cv_j), t2n(tbp.checksum_vector(pt)))
        np.testing.assert_array_equal(t2n(tbp.checksum_vector(pt)), x.sum(axis=-1))
        assert bool(ok_j) and bool(tbp.verify_packed(pt))
        assert not bool(bad_j) and not bool(tbp.verify_packed(ft))
        cj, ct = jbp.compact_packed(_to_jax(pt)), tbp.compact_packed(pt)
        assert cj.weights == ct.weights and cj.block == ct.block
        dropped += len(pt.weights) - len(ct.weights)
        for a, b in ((cj.mag, ct.mag), (cj.sign, ct.sign), (cj.occupancy, ct.occupancy),
                     (cj.checksum, ct.checksum)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), t2n(b))
        np.testing.assert_array_equal(t2n(tbp.checksum_vector(ct)), x.sum(axis=-1))
    assert dropped > 0


def test_compact_weight_planes_and_quantize_params_compaction(rng):
    """compact_weight_planes drops the same planes from the packed words
    and the raw planes as the reference; quantize_params(sparsity=
    "compact") stores exactly that cache."""
    w = rng.integers(-3, 4, (64, 8)).astype(np.int32)  # 8-bit storage, 3-bit values
    wj = jbp.make_weight_planes(jnp.asarray(w), w_bits=8, variant="booth", level="bitplane",
                                store="both", checksum=True)
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant="booth",
                                level="bitplane", checksum=True)
    cj, ct = jbp.compact_weight_planes(wj), tbp.compact_weight_planes(wt)
    assert cj.weights == ct.weights and len(ct.weights) < 8 and ct.w_bits == 8
    np.testing.assert_array_equal(np.asarray(cj.planes), t2n(ct.planes))
    np.testing.assert_array_equal(np.asarray(cj.packed.mag), t2n(ct.packed.mag))
    params = {"lm_head": {"head": {"w": torch.from_numpy(w.astype(np.float32))}}}
    pol = TPolicy.uniform(8, 8, level="bitplane", sparsity="compact")
    q = tquantize_params(params, pol, cfg=None, plane_cache=True)["lm_head"]["head"]
    ref = tbp.compact_weight_planes(tbp.make_weight_planes(
        q["w_q"], w_bits=8, variant="booth", level="bitplane"))
    assert q["w_planes"].weights == ref.weights
    assert torch.equal(q["w_planes"].packed.mag, ref.packed.mag)
    assert torch.equal(q["w_planes"].planes, ref.planes)
