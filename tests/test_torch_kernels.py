"""Port parity of the kernel modules.

On the CPU the plain PyTorch versions are held against the JAX Pallas
kernels run in interpret mode at tiny shapes: int32 accumulators
bit-equal, bf16 epilogues within one bf16 rounding step (XLA's CPU
tanh/logistic and torch's differ in the last float32 bits, which can flip
a bf16 rounding). The Hopper kernels themselves are held against these
plain versions on the card by test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.kernels import ops as jops
from repro_torch.core import bitplanes as tbp
from repro_torch.core.bitserial import _wrap_weights
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plane_mm, plane_mm_fused

from _torch_parity import j2t, t2n

BF16_RTOL = 2.0**-7  # one bf16 rounding step


def _operands(rng, m, k, n, a_bits, w_bits):
    alo, ahi = jbp.signed_range(a_bits)
    wlo, whi = jbp.signed_range(w_bits)
    return (rng.integers(alo, ahi + 1, (m, k)).astype(np.int8),
            rng.integers(wlo, whi + 1, (k, n)).astype(np.int32))


def _jax_fused(x, packed, ep, *, a_bits, variant, backend):
    """The reference's fused_linear in one compiled call (the epilogue's
    activation name and dtype stay static)."""
    if ep is None:
        return jax.jit(lambda x, p: jops.fused_linear(
            x, p, None, a_bits=a_bits, variant=variant, backend=backend, bm=8, bn=8))(x, packed)
    act, dt = ep.activation, ep.out_dtype
    return jax.jit(lambda x, p, a, w, b: jops.fused_linear(
        x, p, jops.Epilogue(a, w, b, act, dt), a_bits=a_bits, variant=variant,
        backend=backend, bm=8, bn=8))(x, packed, ep.a_scale, ep.w_scale, ep.bias)


def _packed_pair(w, w_bits, variant, block):
    pj = jbp.pack_decomposition(jbp.to_bitplanes(jnp.asarray(w), w_bits, variant),
                                axis=-2, variant=variant, block=block)
    pt = tbp.pack_decomposition(tbp.to_bitplanes(torch.from_numpy(w), w_bits, variant),
                                axis=-2, variant=variant, block=block)
    return pj, pt


@pytest.mark.parametrize(
    "variant,a_bits,w_bits,m,k,n,backend",
    [("booth", 8, 8, 5, 70, 9, "jnp"), ("sbmwc", 8, 4, 1, 33, 16, None),
     ("booth", 4, 4, 8, 64, 8, None), ("sbmwc", 6, 8, 3, 100, 5, None)],
)
def test_fused_plain_raw_equals_reference(variant, a_bits, w_bits, m, k, n, backend, rng):
    """Raw int32 accumulator of the plain fused version == the reference's
    staged oracle (one case; compiling it costs seconds) == the integer
    product (the Pallas kernel itself, in interpret mode, is held in the
    truncated-tier test below)."""
    x, w = _operands(rng, m, k, n, a_bits, w_bits)
    pj, pt = _packed_pair(w, w_bits, variant, 32)
    got_j = (x.astype(np.int64) @ w if backend is None else
             _jax_fused(jnp.asarray(x), pj, None, a_bits=a_bits, variant=variant,
                        backend=backend))
    pw = _wrap_weights([a * b for a in tbp.plane_weights(a_bits, variant) for b in pt.weights])
    got_t = plane_mm_fused.fused_plane_linear_plain(
        torch.from_numpy(x), pt, pw, a_bits=a_bits, variant=variant)
    np.testing.assert_array_equal(np.asarray(got_j), t2n(got_t))
    np.testing.assert_array_equal(t2n(got_t), x.astype(np.int64) @ w)
    # the wrapper takes the plain version for host tensors and launches nothing
    n0 = plane_mm_fused.fused_plane_linear.launches
    got_w = plane_mm_fused.fused_plane_linear(
        torch.from_numpy(x), pt, pw, a_bits=a_bits, variant=variant)
    assert torch.equal(got_w, got_t) and plane_mm_fused.fused_plane_linear.launches == n0


@pytest.mark.parametrize(
    "activation,bias,a_bits,backend",
    [("silu", True, 4, "interpret"), ("gelu", True, 8, "jnp"), ("none", False, 8, "jnp")],
)
def test_fused_plain_epilogue_matches_reference(activation, bias, a_bits, backend, rng):
    """The dequant/bias/activation epilogue against the Pallas kernel's
    (interpret, one grid step at 4x4 bits: interpret mode costs seconds per
    plane pair) and the reference's XLA epilogue (jnp)."""
    m, k, n = (6, 32, 8) if backend == "interpret" else (6, 64, 16)
    x, w = _operands(rng, m, k, n, a_bits, a_bits)
    pj, pt = _packed_pair(w, a_bits, "booth", 32)
    a_scale = (rng.random((m, 1)) * 1e-2 + 1e-3).astype(np.float32)
    w_scale = (rng.random((1, n)) * 1e-3 + 1e-4).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    ep_j = jops.Epilogue(jnp.asarray(a_scale), jnp.asarray(w_scale),
                         None if b is None else jnp.asarray(b), activation, jnp.bfloat16)
    got_j = _jax_fused(jnp.asarray(x), pj, ep_j, a_bits=a_bits, variant="booth",
                       backend=backend)
    ep_t = tops.Epilogue(torch.from_numpy(a_scale), torch.from_numpy(w_scale),
                         None if b is None else torch.from_numpy(b), activation, torch.bfloat16)
    got_t = tops.fused_linear(torch.from_numpy(x), pt, ep_t, a_bits=a_bits, variant="booth")
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_allclose(np.asarray(got_j).astype(np.float32), t2n(got_t),
                               rtol=BF16_RTOL, atol=1e-6)


def test_fused_plain_truncated_tier_equals_pallas_interpret(rng):
    """Raw int32 mode of the Pallas kernel (interpret) on the 8 -> 4 bit
    tier made by truncate_weight_planes: the plain version agrees."""
    x8, w = _operands(rng, 4, 32, 8, 8, 8)
    wj = jbp.make_weight_planes(jnp.asarray(w), w_bits=8, variant="booth", level="bitplane",
                                block=32)
    wt = tbp.make_weight_planes(torch.from_numpy(w), w_bits=8, variant="booth",
                                level="bitplane", block=32)
    tj, tt = jbp.truncate_weight_planes(wj, 4), tbp.truncate_weight_planes(wt, 4)
    x4 = np.minimum(np.asarray(jbp.shift_requantize(jnp.asarray(x8), 8, 4, "booth")), 7)
    x4 = x4.astype(np.int8)
    got_j = jops.fused_linear(jnp.asarray(x4), tj.packed, None, a_bits=4, variant="booth",
                              backend="interpret", bm=8, bn=8)
    got_t = tops.fused_linear(torch.from_numpy(x4), tt.packed, None, a_bits=4,
                              variant="booth")
    np.testing.assert_array_equal(np.asarray(got_j), t2n(got_t))


@pytest.mark.parametrize("level,backend", [("bitplane", "jnp"), ("digit", "interpret")])
def test_plane_matmul_plain_equals_reference(level, backend, rng):
    """Booth radix-256 digits against the Pallas kernel (interpret), bit
    planes against the reference's oracle."""
    a = rng.integers(-128, 128, (7, 32)).astype(np.int32)
    w = rng.integers(-128, 128, (32, 6)).astype(np.int32)
    dec = jbp.to_bitplanes if level == "bitplane" else jbp.to_digits
    da, dw = dec(jnp.asarray(a), 8, "booth"), dec(jnp.asarray(w), 8, "booth")
    pw_j = jops._pair_weights(da.weights, dw.weights)
    got_j = jax.jit(
        lambda x, y, p: jops.plane_matmul(x, y, p, backend=backend, bm=8, bn=8, bk=32)
    )(da.planes.astype(jnp.int8), dw.planes.astype(jnp.int8), pw_j)
    got_t = plane_mm.plane_matmul(j2t(da.planes).to(torch.int8), j2t(dw.planes).to(torch.int8),
                                  j2t(pw_j))
    np.testing.assert_array_equal(np.asarray(got_j), t2n(got_t))
    np.testing.assert_array_equal(t2n(got_t), a.astype(np.int64) @ w)


def test_plane_matmul_packed_plain_is_exact(rng):
    """The packed route's plain version through the dispatcher."""
    a = rng.integers(-8, 8, (5, 70)).astype(np.int32)
    w = rng.integers(-8, 8, (70, 6)).astype(np.int32)
    ta = tbp.to_bitplanes(torch.from_numpy(a), 4, "booth")
    tw = tbp.to_bitplanes(torch.from_numpy(w), 4, "booth")
    pw = _wrap_weights([x * y for x in ta.weights for y in tw.weights])
    got_t = tops.plane_matmul_packed(
        tbp.pack_planes(ta.planes, axis=-1, ternary=True),
        tbp.pack_planes(tw.planes, axis=-2, ternary=True), pw, backend="torch")
    np.testing.assert_array_equal(t2n(got_t), a.astype(np.int64) @ w)


def test_backend_resolution():
    assert tops.resolve_backend("auto", torch.device("cpu")) == "torch"
    assert tops.resolve_backend("auto", torch.device("cuda")) == "cuda"
    assert tops.resolve_backend("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.resolve_backend("cuda", torch.device("cpu"))
    with pytest.raises(ValueError):
        tops.resolve_backend("pallas", None)
    x = torch.zeros((2, 32), dtype=torch.int8)
    pt = tbp.pack_decomposition(tbp.to_bitplanes(torch.zeros((32, 4), dtype=torch.int32), 8, "booth"),
                                axis=-2, variant="booth", block=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.fused_linear(x, pt, None, a_bits=8, variant="booth", backend="cuda")


def test_wrapper_rejects_global_planar_layout(rng):
    x, w = _operands(rng, 2, 40, 3, 8, 8)
    pt = tbp.pack_decomposition(tbp.to_bitplanes(torch.from_numpy(w), 8, "booth"),
                                axis=-2, variant="booth", block=None)
    pw = _wrap_weights([1] * 64)
    with pytest.raises(ValueError, match="blocked-layout"):
        plane_mm_fused.fused_plane_linear(torch.from_numpy(x), pt, pw, a_bits=8, variant="booth")
