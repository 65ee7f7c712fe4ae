"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no
host mode) and import no JAX, so they run on a GPU machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core import bitplanes as tbp
from repro_torch.core.bitserial import _wrap_weights
from repro_torch.kernels import plane_mm, plane_mm_fused, plane_mm_packed


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,a_bits,w_bits", [("booth", 8, 8), ("sbmwc", 8, 4), ("booth", 4, 4)])
@pytest.mark.parametrize("m,k,n", [(1, 33, 16), (5, 700, 90), (33, 1024, 257)])
def test_fused_kernel_equals_plain_on_card(cuda_device, variant, a_bits, w_bits, m, k, n):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m * 1000 + k)
    alo, ahi = tbp.signed_range(a_bits)
    wlo, whi = tbp.signed_range(w_bits)
    x = torch.randint(alo, ahi + 1, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    w = torch.randint(wlo, whi + 1, (k, n), generator=g, device=cuda_device, dtype=torch.int32)
    for block in (32, 512):
        pk = tbp.pack_decomposition(tbp.to_bitplanes(w, w_bits, variant), axis=-2,
                                    variant=variant, block=block)
        pw = _wrap_weights([a * b for a in tbp.plane_weights(a_bits, variant)
                            for b in pk.weights], device=cuda_device)
        kw = dict(a_bits=a_bits, variant=variant)
        assert torch.equal(plane_mm_fused.fused_plane_linear(x, pk, pw, **kw),
                           plane_mm_fused.fused_plane_linear_plain(x, pk, pw, **kw))
        ep = dict(a_scale=torch.rand((m, 1), generator=g, device=cuda_device) * 0.01,
                  w_scale=torch.rand((1, n), generator=g, device=cuda_device) * 0.01,
                  bias=torch.randn((n,), generator=g, device=cuda_device))
        for act in ("none", "silu", "gelu"):
            assert torch.equal(
                plane_mm_fused.fused_plane_linear(x, pk, pw, **kw, **ep, activation=act),
                plane_mm_fused.fused_plane_linear_plain(x, pk, pw, **kw, **ep, activation=act))


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["bitplane", "digit"])
@pytest.mark.parametrize("m,k,n", [(1, 33, 16), (4, 4096, 1024), (40, 1000, 129)])
def test_plane_matmul_kernel_equals_plain_on_card(cuda_device, level, m, k, n):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda_device, dtype=torch.int8)
    dec = tbp.to_bitplanes if level == "bitplane" else tbp.to_digits
    da, dw = dec(x, 8, "booth"), dec(w, 8, "booth")
    pw = _wrap_weights([a * b for a in da.weights for b in dw.weights], device=cuda_device)
    a_pl, w_pl = da.planes.contiguous(), dw.planes.contiguous()
    got = plane_mm.plane_matmul(a_pl, w_pl, pw)
    assert torch.equal(got, plane_mm.plane_matmul_plain(a_pl, w_pl, pw))
    assert torch.equal(got.double(), x.double() @ w.double())


@pytest.mark.cuda
@pytest.mark.parametrize("variant,a_bits,w_bits,block", [
    ("booth", 8, 8, 512), ("booth", 8, 8, None), ("sbmwc", 8, 8, None), ("booth", 4, 4, 32),
])
@pytest.mark.parametrize("m,k,n", [(1, 33, 16), (4, 4096, 1024), (40, 1000, 129)])
def test_packed_kernel_equals_plain_on_card(cuda_device, variant, a_bits, w_bits, block,
                                            m, k, n):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m * 7 + k + n)
    alo, ahi = tbp.signed_range(a_bits)
    wlo, whi = tbp.signed_range(w_bits)
    x = torch.randint(alo, ahi + 1, (m, k), generator=g, device=cuda_device, dtype=torch.int32)
    w = torch.randint(wlo, whi + 1, (k, n), generator=g, device=cuda_device, dtype=torch.int32)
    w[: k // 2] >>= 3  # the top planes of the first half of K are zero: gated tiles
    ternary = variant == "booth"
    da, dw = tbp.to_bitplanes(x, a_bits, variant), tbp.to_bitplanes(w, w_bits, variant)
    pa = tbp.pack_planes(da.planes, axis=-1, ternary=ternary, block=block)
    pk = tbp.pack_planes(dw.planes, axis=-2, ternary=ternary, block=block)
    pw = _wrap_weights([a * b for a in da.weights for b in dw.weights], device=cuda_device)
    got = plane_mm_packed.plane_matmul_packed(pa, pk, pw)
    assert torch.equal(got, plane_mm_packed.plane_matmul_packed_plain(pa, pk, pw))
    assert torch.equal(got, plane_mm_packed.plane_matmul_packed(pa, pk, pw, gate=True))
    assert torch.equal(got.double(), x.double() @ w.double())
