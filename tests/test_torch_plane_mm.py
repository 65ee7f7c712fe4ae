"""The tensor-core ``plane_matmul`` and the all-pairs path of the fused and
packed kernels, on the CPU.

``csrc/plane_mm.cu`` runs one int8 tensor-core product per plane pair and
K chunk of 128 and folds it into a uint32 total with the pair weight, so
it is exact modulo 2^32 for any int32 pair weights, and its K-split
partial sums meet in any order. ``plane_mm.chunked_plane_matmul`` is the
plain model of that arithmetic; here it is held bit-equal to the JAX
Pallas kernel ``repro.kernels.plane_matmul`` (interpret mode) on
numpy-seeded planes: Booth digits (2 x 2 pairs) and 8 x 8 bit planes,
random pair weights, pair weights near +-2^31 and the levels' own, K not
a multiple of 32 or of the chunk. The kernel's shared-memory swizzles and
its 4x4 byte transpose are replayed in numpy against the mma fragment
layout. The route decision of the fused and packed wrappers
(``bytesplit.pair_route``: factors carried, an outer product after a
read-back, or all pairs) is tested as a plain function, and the wrappers
on the CPU against the JAX package for a perturbed pw and for operands
packed without plane weights. The kernel itself is held against these
plain versions on the card by test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.kernels import ops as jops
from repro.kernels.plane_mm_fused import fused_plane_linear as jfused
from repro_torch.core import bitplanes as tbp
from repro_torch.core.bitserial import _wrap_weights
from repro_torch.kernels import bytesplit as bs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plane_mm, plane_mm_fused, plane_mm_packed

from _torch_parity import t2n


def _planes(rng, level, m, k, n):
    """(P_a, M, K) and (P_w, K, N) int8 planes of random 8-bit operands:
    Booth radix-256 digits or 8 Booth bit planes, with their pair weights."""
    a = rng.integers(-128, 128, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int32)
    dec = jbp.to_digits if level == "digit" else jbp.to_bitplanes
    da, dw = dec(jnp.asarray(a), 8, "booth"), dec(jnp.asarray(w), 8, "booth")
    return (np.asarray(da.planes).astype(np.int8), np.asarray(dw.planes).astype(np.int8),
            np.asarray(jops._pair_weights(da.weights, dw.weights)), a, w)


def _pair_weights(rng, kind, own):
    if kind == "own":
        return own
    if kind == "random":
        return rng.integers(-(2**31), 2**31, own.shape).astype(np.int32)
    # near +-2^31: every product wraps
    off = rng.integers(0, 64, own.shape)
    return np.where(rng.random(own.shape) < 0.5, 2**31 - 1 - off, -(2**31) + off).astype(np.int32)


@pytest.mark.parametrize("level,m,k,n", [("digit", 5, 300, 6), ("bitplane", 3, 70, 5)])
@pytest.mark.parametrize("kind", ["own", "random", "near_2_31"])
def test_chunked_model_equals_pallas_interpret(level, m, k, n, kind, rng):
    a_pl, w_pl, own, a, w = _planes(rng, level, m, k, n)
    pw = _pair_weights(rng, kind, own)
    want = np.asarray(jax.jit(
        lambda x, y, p: jops.plane_matmul(x, y, p, backend="interpret", bm=8, bn=8, bk=128)
    )(jnp.asarray(a_pl), jnp.asarray(w_pl), jnp.asarray(pw)))
    at, wt, pt = (torch.from_numpy(np.array(x)) for x in (a_pl, w_pl, pw))
    n_chunks = -(-k // plane_mm.K_TILE)
    for ksplit in sorted({1, n_chunks}):
        order = rng.permutation(-(-n_chunks // -(-n_chunks // ksplit)))
        got = plane_mm.chunked_plane_matmul(at, wt, pt, ksplit=ksplit, order=list(order))
        np.testing.assert_array_equal(t2n(got), want)
    np.testing.assert_array_equal(t2n(plane_mm.plane_matmul(at, wt, pt)), want)
    if kind == "own":  # the levels' pair weights: the plain int product
        np.testing.assert_array_equal(want, a.astype(np.int64) @ w)


def test_pair_product_stays_inside_int32():
    """The worst chunk of int8 planes: 128 products of -128 * -128."""
    worst = plane_mm.K_TILE * 128 * 128
    assert worst < 2**31
    a = torch.full((1, 1, 300), -128, dtype=torch.int8)
    w = torch.full((1, 300, 1), -128, dtype=torch.int8)
    pw = torch.tensor([3], dtype=torch.int32)
    want = (3 * 300 * 128 * 128) & 0xFFFFFFFF
    want = want - (1 << 32) if want >> 31 else want
    assert int(plane_mm.chunked_plane_matmul(a, w, pw)[0, 0]) == want


def test_byte_transpose_is_the_4x4_transpose(rng):
    for _ in range(50):
        words = [int(x) for x in rng.integers(0, 2**32, 4, dtype=np.uint64)]
        b = np.array([[(x >> (8 * c)) & 0xFF for c in range(4)] for x in words])  # b[row, col]
        want = [sum(int(b[r, c]) << (8 * r) for r in range(4)) for c in range(4)]
        assert plane_mm.byte_transpose4x4(words) == want


def _stage_w(tile):
    """The kernel's W staging: row r's 16-byte chunk c at chunk
    c ^ (((r >> 2) & 3) << 1) of a 128-byte row."""
    out = np.zeros_like(tile)
    for r in range(tile.shape[0]):
        for c in range(8):
            p = c ^ (((r >> 2) & 3) << 1)
            out[r, 16 * p:16 * p + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def test_weight_fragments_follow_the_mma_layout(rng):
    """Replay of one (chunk, W plane) tile: every thread's four words per
    (k32 step, half), read at the kernel's swizzled offset and transposed,
    are the m16n8k32 A fragment of the columns the epilogue writes
    (m16 tile T: row g -> column 4g + 2T, row g + 8 -> 4g + 2T + 1)."""
    tile = rng.integers(0, 256, (128, 128)).astype(np.uint8)  # W[k, n] of one tile
    staged = _stage_w(tile)
    banks = set()
    for warp in range(4):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            w_off = ((((2 * warp + (g >> 2)) ^ (q << 1)) & 7) << 4) + ((g & 3) << 2)
            for s in range(4):
                for h in range(2):
                    rows = [32 * s + 16 * h + 4 * q + r for r in range(4)]
                    words = [int.from_bytes(staged[row, w_off:w_off + 4].tobytes(), "little")
                             for row in rows]
                    if warp == 0 and s == 0 and h == 0:
                        banks.add((rows[0] * 128 + w_off) // 4 % 32)
                    x = plane_mm.byte_transpose4x4(words)
                    for t in range(2):
                        for e in range(2):  # register 2h + e of tile t
                            col = 32 * warp + 4 * g + 2 * t + e
                            k0 = 32 * s + 16 * h + 4 * q
                            want = int.from_bytes(tile[k0:k0 + 4, col].tobytes(), "little")
                            assert x[2 * t + e] == want
    assert len(banks) == 32  # one warp-wide read: 32 distinct banks


def test_activation_fragments_follow_the_mma_layout(rng):
    """The A-plane staging (token t's chunk c at c ^ (t & 7)) and the
    kernel's B-fragment reads: b0 / b1 of n8 tile nt are K bytes 32s + 4q
    (+16) of token 8nt + g, from 32 distinct banks."""
    bm = 32
    tile = rng.integers(0, 256, (bm, 128)).astype(np.uint8)
    staged = np.zeros_like(tile)
    for t in range(bm):
        for c in range(8):
            p = c ^ (t & 7)
            staged[t, 16 * p:16 * p + 16] = tile[t, 16 * c:16 * c + 16]
    for s in range(4):
        for nt in range(bm // 8):
            banks = set()
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                row = nt * 8 + g
                for half in range(2):
                    off = (((2 * s + half) ^ g) << 4) + (q << 2)
                    k0 = 32 * s + 16 * half + 4 * q
                    assert staged[row, off:off + 4].tobytes() == tile[row, k0:k0 + 4].tobytes()
                    if half == 0:
                        banks.add((row * 128 + off) // 4 % 32)
            assert len(banks) == 32


# --- the route decision --------------------------------------------------------------


def test_pair_route_carried_factors_need_no_read_back(monkeypatch):
    wa, ww = tbp.plane_weights(8, "booth"), tbp.plane_weights(8, "booth")
    pw = tops._pair_weights(wa, ww, torch.device("cpu"))
    monkeypatch.setattr(bs, "is_outer_product", lambda *a: pytest.fail("read back"))
    assert bs.pair_route(pw, wa, ww, 8, 8) == bs.BYTESPLIT
    assert tops._pair_weights(wa, ww, torch.device("cpu")) is pw  # built once


def test_pair_route_reads_back_other_pair_weights_every_call(monkeypatch):
    wa, ww = (1, 2, 4), (1, 256)
    pw = _wrap_weights([a * b for a in wa for b in ww])
    reads = []
    real = bs.is_outer_product
    monkeypatch.setattr(bs, "is_outer_product", lambda *a: reads.append(1) or real(*a))
    assert bs.pair_route(pw, wa, ww, 3, 2) == bs.BYTESPLIT
    assert bs.pair_route(pw, wa, ww, 3, 2) == bs.BYTESPLIT
    assert len(reads) == 2 and not hasattr(pw, "_pair_factors")
    # a carried tag is trusted until the tensor is written
    bs.tag_pair_weights(pw, wa, ww)
    assert bs.pair_route(pw, wa, ww, 3, 2) == bs.BYTESPLIT and len(reads) == 2
    pw[4] += 1  # written: the tag is stale and the values are read again
    assert bs.pair_route(pw, wa, ww, 3, 2) == bs.ALL_PAIRS
    assert bs.pair_route(pw, wa, ww, 3, 2) == bs.ALL_PAIRS
    assert len(reads) == 4
    # the tag names other factors than the operands': read again
    pw[4] -= 1
    bs.tag_pair_weights(pw, wa, ww)
    assert bs.pair_route(pw, (1, 2, 5), ww, 3, 2) == bs.ALL_PAIRS and len(reads) == 5


def test_pair_route_all_pairs_cases():
    wa, ww = tbp.plane_weights(4, "booth"), tbp.plane_weights(4, "booth")
    outer = _wrap_weights([a * b for a in wa for b in ww])
    assert bs.pair_route(outer, wa, ww, 4, 4) == bs.BYTESPLIT
    assert bs.pair_route(outer, (), ww, 4, 4) == bs.ALL_PAIRS  # packed without weights
    assert bs.pair_route(outer, wa, (), 4, 4) == bs.ALL_PAIRS
    many = tuple(1 << (i % 31) for i in range(bs.MAX_PLANES + 1))
    big = _wrap_weights([a * b for a in many for b in ww])
    assert bs.pair_route(big, many, ww, len(many), 4) == bs.ALL_PAIRS  # beyond the byte split
    # wrapped: 2^32 * x == 0 (mod 2^32) is still the outer product
    wrapped = _wrap_weights([(a << 32) * b for a in wa for b in ww])
    assert bs.pair_route(wrapped, tuple(a << 32 for a in wa), ww, 4, 4) == bs.BYTESPLIT
    with torch.inference_mode():  # an inference tensor: decided by a read-back
        inf = outer.clone()
    assert bs.pair_route(inf, wa, ww, 4, 4) == bs.BYTESPLIT
    assert not hasattr(inf, "_pair_factors")


# --- the wrappers on the CPU against the JAX package ---------------------------------


def _perturb(pw, rng):
    bad = pw.copy()
    bad[int(rng.integers(bad.size))] += 12345
    return bad


@pytest.mark.parametrize("case", ["perturbed", "no_weights"])
def test_packed_wrapper_takes_any_pair_weights(case, rng):
    a = rng.integers(-8, 8, (5, 70)).astype(np.int32)
    w = rng.integers(-8, 8, (70, 6)).astype(np.int32)
    packs = []
    for lib, arr in ((jbp, jnp.asarray), (tbp, torch.from_numpy)):
        da, dw = lib.to_bitplanes(arr(a), 4, "booth"), lib.to_bitplanes(arr(w), 4, "booth")
        # pack_planes records no plane weights unless given them
        kw = [{}, {}] if case == "no_weights" else [{"weights": da.weights},
                                                     {"weights": dw.weights}]
        packs.append((lib.pack_planes(da.planes, axis=-1, ternary=True, **kw[0]),
                      lib.pack_planes(dw.planes, axis=-2, ternary=True, **kw[1])))
    own = np.array(jops._pair_weights(jbp.plane_weights(4, "booth"),
                                        jbp.plane_weights(4, "booth")))
    pw = _perturb(own, rng) if case == "perturbed" else own
    (pja, pjk), (pta, ptk) = packs
    assert (pta.weights == ()) == (case == "no_weights")
    want = np.asarray(jops.plane_matmul_packed(pja, pjk, jnp.asarray(pw), backend="jnp"))
    got = tops.plane_matmul_packed(pta, ptk, torch.from_numpy(pw))
    np.testing.assert_array_equal(t2n(got), want)
    np.testing.assert_array_equal(
        t2n(plane_mm_packed.plane_matmul_packed(pta, ptk, torch.from_numpy(pw))), want)
    if case == "no_weights":  # the levels' pair weights: the plain int product
        np.testing.assert_array_equal(want, a.astype(np.int64) @ w)


@pytest.mark.parametrize("case", ["perturbed", "no_weights"])
def test_fused_wrapper_takes_any_pair_weights(case, rng):
    """Raw int32 against the reference's Pallas kernel in interpret mode
    (2-bit operands: four plane pairs keep interpret mode short)."""
    a_bits, m, k, n = 2, 4, 64, 8
    x = rng.integers(-2, 2, (m, k)).astype(np.int8)
    w = rng.integers(-2, 2, (k, n)).astype(np.int32)
    pj = jbp.pack_decomposition(jbp.to_bitplanes(jnp.asarray(w), 2, "booth"), axis=-2,
                                variant="booth", block=32)
    pt = tbp.pack_decomposition(tbp.to_bitplanes(torch.from_numpy(w), 2, "booth"), axis=-2,
                                variant="booth", block=32)
    own = np.array(jops._pair_weights(jbp.plane_weights(a_bits, "booth"), pj.weights))
    pw = own
    if case == "perturbed":
        pw = _perturb(own, rng)
    else:
        pj, pt = dataclasses.replace(pj, weights=()), dataclasses.replace(pt, weights=())
    want = np.asarray(jfused(jnp.asarray(x), pj, jnp.asarray(pw), a_bits=a_bits, variant="booth",
                             bm=8, bn=8, interpret=True))
    got = plane_mm_fused.fused_plane_linear(torch.from_numpy(x), pt, torch.from_numpy(pw),
                                            a_bits=a_bits, variant="booth")
    np.testing.assert_array_equal(t2n(got), want)
    if case == "no_weights":
        np.testing.assert_array_equal(want, x.astype(np.int64) @ w)
