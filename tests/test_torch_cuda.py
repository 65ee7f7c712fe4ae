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

from _torch_words import corrupt_words


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
    da, dw = tbp.to_bitplanes(x, a_bits, variant), tbp.to_bitplanes(w, w_bits, variant)
    pa = tbp.pack_decomposition(da, axis=-1, variant=variant, block=block)
    pk = tbp.pack_decomposition(dw, axis=-2, variant=variant, block=block)
    pw = _wrap_weights([a * b for a in da.weights for b in dw.weights], device=cuda_device)
    got = plane_mm_packed.plane_matmul_packed(pa, pk, pw)
    assert torch.equal(got, plane_mm_packed.plane_matmul_packed_plain(pa, pk, pw))
    assert torch.equal(got, plane_mm_packed.plane_matmul_packed(pa, pk, pw, gate=True))
    assert torch.equal(got.double(), x.double() @ w.double())


def _ints(g, bits, variant, shape, dev):
    lo, hi = (0, (1 << bits) - 1) if variant == "unsigned" else tbp.signed_range(bits)
    return torch.randint(lo, hi + 1, shape, generator=g, device=dev, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,a_bits,m,k,n,corrupt", [
    ("booth", 8, 5, 700, 90, True),
    ("booth", 8, 256, 1024, 130, True),
    ("unsigned", 8, 17, 300, 64, False),
    ("unsigned", 8, 4, 96, 33, True),
    ("booth", 1, 1, 64, 16, False),
    ("booth", 3, 100, 256, 257, True),
    ("sbmwc", 5, 17, 520, 129, False),
])
def test_fused_kernel_corrupt_unsigned_ragged_on_card(cuda_device, variant, a_bits, m, k, n,
                                                      corrupt):
    """Bit-equal to the plain version for any words (a flipped bit, a sign
    bit without its magnitude bit), unsigned activations, a_bits 1-8,
    ragged M and N, and M = 256 (eight 32-row tiles)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m * 31 + k + n)
    x = _ints(g, a_bits, variant, (m, k), cuda_device).to(torch.int8)
    w = _ints(g, 8, variant, (k, n), cuda_device)
    pk = tbp.pack_decomposition(tbp.to_bitplanes(w, 8, variant), axis=-2, variant=variant,
                                block=512)
    if corrupt:
        pk = corrupt_words(pk, g)
    pw = _wrap_weights([a * b for a in tbp.plane_weights(a_bits, variant)
                        for b in pk.weights], device=cuda_device)
    kw = dict(a_bits=a_bits, variant=variant)
    assert torch.equal(plane_mm_fused.fused_plane_linear(x, pk, pw, **kw),
                       plane_mm_fused.fused_plane_linear_plain(x, pk, pw, **kw))
    ep = dict(a_scale=torch.rand((m, 1), generator=g, device=cuda_device) * 0.01,
              w_scale=torch.rand((1, n), generator=g, device=cuda_device) * 0.01,
              activation="silu")
    assert torch.equal(plane_mm_fused.fused_plane_linear(x, pk, pw, **kw, **ep),
                       plane_mm_fused.fused_plane_linear_plain(x, pk, pw, **kw, **ep))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,tier", [("booth", None), ("booth", 4), ("sbmwc", 6)])
def test_fused_kernel_compacted_and_truncated_cache_on_card(cuda_device, variant, tier):
    """A compacted cache (plane 0 dropped: its weights start at 2) and
    truncated tiers of it: the byte digits follow the plane weights."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(97)
    x = _ints(g, 8, variant, (6, 1000), cuda_device)
    w = _ints(g, 8, variant, (1000, 72), cuda_device) & ~1  # even: plane 0 is all zero
    wp = tbp.compact_weight_planes(tbp.make_weight_planes(w, w_bits=8, variant=variant,
                                                          level="bitplane"))
    assert len(wp.weights) == 7
    if tier is not None:
        wp = tbp.truncate_weight_planes(wp, tier)
        x = tbp.shift_requantize(x, 8, tier, variant).clamp(*tbp.signed_range(tier))
    a_bits = tier or 8
    pw = _wrap_weights([a * b for a in tbp.plane_weights(a_bits, variant)
                        for b in wp.packed.weights], device=cuda_device)
    kw = dict(a_bits=a_bits, variant=variant)
    xq = x.to(torch.int8)
    assert torch.equal(plane_mm_fused.fused_plane_linear(xq, wp.packed, pw, **kw),
                       plane_mm_fused.fused_plane_linear_plain(xq, wp.packed, pw, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,a_bits,w_bits,m,k,n,block,corrupt", [
    ("booth", 8, 8, 5, 1000, 90, None, True),
    ("booth", 8, 8, 256, 1000, 130, 512, True),
    ("unsigned", 8, 8, 17, 1000, 64, None, False),
    ("booth", 16, 8, 3, 200, 33, None, True),
    ("booth", 28, 8, 40, 300, 64, None, False),  # four activation digits: 64 KB staged
    ("sbmwc", 3, 8, 100, 520, 257, 128, True),
])
def test_packed_kernel_corrupt_unsigned_ragged_on_card(cuda_device, variant, a_bits, w_bits, m,
                                                       k, n, block, corrupt):
    """Bit-equal to the plain version for corrupted words on both sides,
    unsigned, 16- and 28-bit activations (two to four activation digits),
    packed K = 1000, ragged M and N, M = 256."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m * 17 + k + n)
    pa = tbp.pack_decomposition(tbp.to_bitplanes(_ints(g, a_bits, variant, (m, k), cuda_device),
                                                 a_bits, variant),
                                axis=-1, variant=variant, block=block)
    pk = tbp.pack_decomposition(tbp.to_bitplanes(_ints(g, w_bits, variant, (k, n), cuda_device),
                                                 w_bits, variant),
                                axis=-2, variant=variant, block=block)
    if corrupt:
        pa, pk = corrupt_words(pa, g), corrupt_words(pk, g)
    pw = _wrap_weights([a * b for a in pa.weights for b in pk.weights], device=cuda_device)
    assert torch.equal(plane_mm_packed.plane_matmul_packed(pa, pk, pw),
                       plane_mm_packed.plane_matmul_packed_plain(pa, pk, pw))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "packed"])
@pytest.mark.parametrize("case", ["perturbed_pw", "no_weights"])
def test_any_pair_weights_equal_plain_on_card(cuda_device, kernel, case):
    """Pair weights that are no outer product of the plane weights, and
    operands packed without plane weights, take the all-pairs path (decided
    on the host before any launch): the plain version's output, raw int32
    and bf16, in this process, which carries on."""
    import dataclasses

    g = torch.Generator(device=cuda_device)
    g.manual_seed(5 + len(case))
    w = torch.randint(-128, 128, (700, 90), generator=g, device=cuda_device, dtype=torch.int32)
    x = torch.randint(-128, 128, (5, 700), generator=g, device=cuda_device, dtype=torch.int32)
    pk = tbp.pack_decomposition(tbp.to_bitplanes(w, 8, "booth"), axis=-2, variant="booth", block=512)
    pa = tbp.pack_decomposition(tbp.to_bitplanes(x, 8, "booth"), axis=-1, variant="booth", block=512)
    wa = tbp.plane_weights(8, "booth") if kernel == "fused" else pa.weights
    pw = _wrap_weights([a * b for a in wa for b in pk.weights], device=cuda_device)
    if case == "perturbed_pw":
        pw[9] += 1  # not the outer product of the plane weights
    else:
        pa, pk = dataclasses.replace(pa, weights=()), dataclasses.replace(pk, weights=())
    n0 = plane_mm.plane_matmul.launches
    if kernel == "fused":
        kw = dict(a_bits=8, variant="booth")
        ep = dict(a_scale=torch.rand((5, 1), generator=g, device=cuda_device) * 0.01,
                  w_scale=torch.rand((1, 90), generator=g, device=cuda_device) * 0.01,
                  activation="gelu")
        xq = x.to(torch.int8)
        for e in ({}, ep):
            assert torch.equal(plane_mm_fused.fused_plane_linear(xq, pk, pw, **kw, **e),
                               plane_mm_fused.fused_plane_linear_plain(xq, pk, pw, **kw, **e))
    else:
        assert torch.equal(plane_mm_packed.plane_matmul_packed(pa, pk, pw),
                           plane_mm_packed.plane_matmul_packed_plain(pa, pk, pw))
    assert plane_mm.plane_matmul.launches > n0  # through the all-pairs kernel
    torch.cuda.synchronize()  # the context is still usable


@pytest.mark.cuda
@pytest.mark.parametrize("n_a,n_w,m,k,n,lo,hi", [
    (2, 2, 256, 1000, 300, -128, 128),  # digits, K and N not multiples of 16 (byte staging)
    (8, 8, 37, 4096, 257, -1, 2),  # 8 x 8 bit planes
    (20, 3, 5, 300, 96, -128, 128),  # more A planes than one launch takes
    (4, 4, 9, 4104, 4096, -2, 2),  # K split across blocks, one chunk ragged
    (1, 1, 1, 33, 16, -128, 128),
])
def test_plane_matmul_any_pair_weights_ragged_on_card(cuda_device, n_a, n_w, m, k, n, lo, hi):
    """Any int8 planes and int32 pair weights near +-2^31 (every product
    wraps), ragged M, N and K: bit-equal to the plain version."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n_a * 1000 + m + k + n)
    a = torch.randint(lo, hi, (n_a, m, k), generator=g, device=cuda_device, dtype=torch.int8)
    w = torch.randint(lo, hi, (n_w, k, n), generator=g, device=cuda_device, dtype=torch.int8)
    off = torch.randint(0, 64, (n_a * n_w,), generator=g, device=cuda_device)
    pw = torch.where(off % 2 == 0, 2**31 - 1 - off, -(2**31) + off).to(torch.int32)
    assert torch.equal(plane_mm.plane_matmul(a, w, pw), plane_mm.plane_matmul_plain(a, w, pw))
    for bm in (8, 16, 32):
        assert torch.equal(plane_mm.plane_matmul(a, w, pw, bm=bm),
                           plane_mm.plane_matmul_plain(a, w, pw))


def _paged_case(dev, g, b, hq, hkv, d, ps, lens):
    """Pools in a permuted page order, tables padded with the null page,
    which holds non-zero garbage; the same pools gathered into the dense
    (B, Hkv, S, D) view."""
    p = max(-(-n // ps) for n in lens) + 1
    n_pages = b * p + 1
    kq = torch.randint(-127, 128, (n_pages, ps, hkv, d), generator=g, device=dev, dtype=torch.int8)
    vq = torch.randint(-127, 128, (n_pages, ps, hkv, d), generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand((n_pages, ps, hkv), generator=g, device=dev) * 0.02 + 0.001
    vs = torch.rand((n_pages, ps, hkv), generator=g, device=dev) * 0.02 + 0.001
    perm = torch.randperm(n_pages - 1, generator=g, device=dev)[: b * p] + 1
    tables = perm.reshape(b, p).to(torch.int32)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        tables[i, -(-n // ps):] = 0
    q = torch.randn((b, hq, 1, d), generator=g, device=dev).to(torch.bfloat16)
    flat = tables.long().reshape(-1)

    def gather(pool):
        x = pool[flat].reshape(b, p * ps, *pool.shape[2:])
        return (x.permute(0, 2, 1) if x.ndim == 3 else x.permute(0, 2, 1, 3)).contiguous()

    return (q, kq, vq, ks, vs, tables, kv_lens), (gather(kq), gather(vq), gather(ks), gather(vs))


def _within(got, want, rtol=1e-5):
    """float32: the summation-order tolerance of max|want|; bf16: one bf16
    step of the element on top of it."""
    atol = rtol * max(1.0, float(want.float().abs().max()))
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
        atol = atol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool((diff <= atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d,ps,lens", [
    (8, 2, 16, 8, (37, 1, 48, 0)), (32, 8, 128, 16, (1, 16, 37, 272)),
])
def test_paged_attention_kernel_equals_plain_and_dense_kernel_on_card(cuda_device, hq, hkv, d,
                                                                     ps, lens):
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device)
    g.manual_seed(d + ps)
    args, (kd, vd, ksd, vsd) = _paged_case(cuda_device, g, len(lens), hq, hkv, d, ps, lens)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fa.paged_flash_attention(*args, out_dtype=out_dtype)
        assert _within(got, fa.paged_flash_attention_plain(*args, out_dtype=out_dtype))
        dense = fa.flash_attention(args[0], kd, vd, causal=False, kv_lens=args[6], k_scale=ksd,
                                   v_scale=vsd, block_q=1, block_k=ps, out_dtype=out_dtype)
        live = torch.tensor([n > 0 for n in lens], device=cuda_device)
        # lanes of length >= 1: the same bits; a lane of length 0 is finite
        assert torch.equal(got[live], dense[live])
        assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d,ps,lens", [
    (32, 8, 128, 16, (1, 16, 37, 272)),  # the engine's shape
    (32, 8, 128, 16, (4096, 3001, 129, 128, 1, 0, 2049, 640)),  # many splits, a lane of 0
    (8, 2, 64, 8, (5, 128, 129, 0)),  # head dim 64, on and past a split boundary
    (16, 2, 128, 32, (300, 0, 77)),  # 8 query heads a KV head: the whole n8 side
])
def test_paged_decode_body_equals_plain_and_dense_twin_on_card(cuda_device, hq, hkv, d, ps,
                                                               lens):
    """The split-KV decode body on the tensor cores (csrc/attn_decode.cuh):
    the paged kernel within the summation-order tolerance of its plain
    version (the null page holding garbage), bit-equal to the dense decode
    call on the gathered pools on every lane of length >= 1; a lane of
    length 0 gives 0."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device)
    g.manual_seed(sum(lens) + d)
    args, (kd, vd, ksd, vsd) = _paged_case(cuda_device, g, len(lens), hq, hkv, d, ps, lens)
    rows = hq // hkv
    assert fa.paged_body(torch.bfloat16, d, rows, True) == "tensor_core_decode"
    assert fa.dense_body(torch.bfloat16, torch.int8, 1, d, True, causal=False, lens=True,
                         rows=rows) == "tensor_core_decode"
    live = torch.tensor([n > 0 for n in lens], device=cuda_device)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fa.paged_flash_attention(*args, out_dtype=out_dtype)
        assert _within(got, fa.paged_flash_attention_plain(*args, out_dtype=out_dtype))
        dense = fa.flash_attention(args[0], kd, vd, causal=False, kv_lens=args[6], k_scale=ksd,
                                   v_scale=vsd, block_q=1, block_k=ps, out_dtype=out_dtype)
        assert torch.equal(got[live], dense[live])
        assert not bool(got[~live].any())
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(dense).all())


@pytest.mark.cuda
def test_paged_decode_replays_from_a_cuda_graph(cuda_device):
    """The paged kernel reads nothing back on the host, so a CUDA graph of
    the call replays it: new lengths and a new query in the captured buffers
    give the eager call's bits."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    args, _ = _paged_case(cuda_device, g, 4, 32, 8, 128, 16, (1, 16, 37, 272))
    q, kq, vq, ks, vs, tables, lens = args
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.paged_flash_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.paged_flash_attention(*args)
    lens.copy_(torch.tensor([0, 17, 36, 200], dtype=torch.int32, device=cuda_device))
    q.copy_(torch.randn(q.shape, generator=g, device=cuda_device).to(q.dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fa.paged_flash_attention(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,kv,sq,sk,bq,bk", [
    (True, "bf16", 64, 64, 32, 16), (False, "int8", 1, 80, 1, 16), (True, "f32", 40, 40, 8, 8),
    (True, "bf16", 16, 48, 16, 16),
])
def test_flash_attention_kernel_equals_plain_on_card(cuda_device, causal, kv, sq, sk, bq, bk):
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device)
    g.manual_seed(sq * 100 + sk)
    b, hq, hkv, d = 2, 8, 2, 64
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda_device).to(torch.bfloat16)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    if kv == "int8":
        k = torch.randint(-127, 128, (b, hkv, sk, d), generator=g, device=cuda_device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, hkv, sk, d), generator=g, device=cuda_device,
                          dtype=torch.int8)
        kw.update(k_scale=torch.rand((b, hkv, sk), generator=g, device=cuda_device) * 0.02,
                  v_scale=torch.rand((b, hkv, sk), generator=g, device=cuda_device) * 0.02,
                  kv_lens=torch.tensor([sk // 3, 0], dtype=torch.int32, device=cuda_device))
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        k = torch.randn((b, hkv, sk, d), generator=g, device=cuda_device).to(dt)
        v = torch.randn((b, hkv, sk, d), generator=g, device=cuda_device).to(dt)
        kw["kv_len"] = sk - 3
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fa.flash_attention(q, k, v, out_dtype=out_dtype, **kw)
        assert _within(got, fa.flash_attention_plain(q, k, v, out_dtype=out_dtype, **kw))
        assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv,causal,lens,sq,bq,bk,d", [
    ("bf16", True, None, 256, 128, 128, 128),
    ("bf16", False, (200, 0), 192, 64, 32, 64),
    ("int8", True, (256, 77), 256, 128, 128, 128),
    ("int8", False, (0, 130), 160, 32, 32, 64),
    ("int8", True, (512, 301), 512, 16, 64, 128),
])
def test_flash_attention_tensor_core_body_on_card(cuda_device, kv, causal, lens, sq, bq, bk, d):
    """The dense kernel's tensor-core body (bf16 q, bf16 or int8 K/V,
    block_q a multiple of 16) against its plain version, within the smoke's
    tolerance: float32 outputs within 1e-4 of max|plain|, bf16 within one
    bf16 step more; lanes of length 0 finite."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device)
    g.manual_seed(sq + bq + d)
    b, hq, hkv = 2, 8, 2
    assert fa.dense_body(torch.bfloat16, torch.int8 if kv == "int8" else torch.bfloat16, bq, d,
                         True) == "tensor_core"
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda_device).to(torch.bfloat16)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    if kv == "int8":
        k = torch.randint(-127, 128, (b, hkv, sq, d), generator=g, device=cuda_device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, hkv, sq, d), generator=g, device=cuda_device,
                          dtype=torch.int8)
        kw.update(k_scale=torch.rand((b, hkv, sq), generator=g, device=cuda_device) * 0.02,
                  v_scale=torch.rand((b, hkv, sq), generator=g, device=cuda_device) * 0.02)
    else:
        k = torch.randn((b, hkv, sq, d), generator=g, device=cuda_device).to(torch.bfloat16)
        v = torch.randn((b, hkv, sq, d), generator=g, device=cuda_device).to(torch.bfloat16)
    if lens is not None:
        kw["kv_lens"] = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fa.flash_attention(q, k, v, out_dtype=out_dtype, **kw)
        assert _within(got, fa.flash_attention_plain(q, k, v, out_dtype=out_dtype, **kw),
                       rtol=1e-4)
        assert bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# Compiled serving steps: the decode step replayed from a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_CELLS = {  # cell: (policy kwargs, engine kwargs, scan_layers, precision schedule)
    "fused": (dict(level="bitplane"), {}, True, {2: 4}),
    "digit": (dict(level="digit"), {}, True, None),
    "packed": (dict(level="bitplane", fuse_epilogue=False), {}, True, {2: 4}),
    "detect": (dict(level="bitplane", integrity="detect"), dict(audit_interval=1), False,
               {2: 4}),
    "detect_scan": (dict(level="bitplane", integrity="detect"), dict(audit_interval=1), True,
                    {2: 4}),
    "paged": (dict(level="bitplane"), dict(page_size=8, prefill_chunk=8), True, {2: 4}),
}


def _graph_engines(cell, dev, temps=(0.0, 0.0, 0.0)):
    """A graph engine and an eager one on the same weights (granite-3-8b
    reduced to 2 layers), and a workload of three requests."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.scheduler import Request

    pol_kw, eng_kw, scan, schedule = GRAPH_CELLS[cell]
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), scan_layers=scan)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, device=dev)
    policy = PrecisionPolicy.uniform(8, 8, **pol_kw)
    engines = [ContinuousBatchingEngine(cfg, params, policy, n_slots=2, max_len=32, device=dev,
                                        compile_steps=c, **eng_kw) for c in (True, False)]

    def requests():
        return [Request(rid=i, tokens=np.random.default_rng(i).integers(0, cfg.vocab_size, (s,)),
                        max_new_tokens=6, arrival_step=2 * i, temperature=t)
                for i, (s, t) in enumerate(zip((5, 11, 9), temps))]

    return engines, requests, schedule


def _serve_counted(engine, requests, schedule):
    from repro_torch.launch import graphs

    for fn in graphs.launch_counters().values():
        fn.launches = 0
    engine.set_precision(None)
    results, stats = engine.run(requests(), precision_schedule=schedule)
    return results, stats, {k: fn.launches for k, fn in graphs.launch_counters().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(GRAPH_CELLS))
def test_graph_replay_equals_eager_step_on_card(cuda_device, cell):
    """Every decode step replays from a graph (one per precision): tokens,
    the decode state's bytes, route calls, kernel launches and integrity
    counts equal the eager step's; in detect mode also after one flipped
    weight bit (alarms included)."""
    (graph, eager), requests, schedule = _graph_engines(cell, cuda_device)
    runs = [_serve_counted(e, requests, schedule) for e in (graph, eager)]
    expect = {None, (4, 4)} if schedule else {None}
    assert set(graph._compiled_graphs) == expect and not eager._compiled_graphs
    flips = [False, True] if "detect" in cell else [False]
    for flip in flips:
        if flip:
            for e in (graph, eager):
                # the top plane: every precision consumes it
                e.q_params["layers"][0]["mlp"]["gate_proj"]["w_planes"].packed.mag[-1, 0, 0] ^= 1
            runs = [_serve_counted(e, requests, schedule) for e in (graph, eager)]
        (rg, sg, lg), (re_, se, le) = runs
        assert sorted(rg) == sorted(re_) == [0, 1, 2]
        for rid in rg:
            assert (rg[rid] == re_[rid]).all(), (cell, flip, rid)
        assert sg["route_calls"] == se["route_calls"] and lg == le
        assert sg["decode_steps"] == se["decode_steps"]
        if "detect" in cell:
            assert sg["integrity"] == se["integrity"]
            if flip:
                assert sg["integrity"]["abft_alarms"] >= 1
                assert sg["integrity"]["audit_alarms"] >= 1
        for a, b in zip(graph._cache["layers"], eager._cache["layers"]):
            for key in a:
                assert torch.equal(a[key], b[key]), (cell, key)
    assert set(graph.capture_s) == expect


@pytest.mark.cuda
def test_graph_sampled_tokens_equal_eager_on_card(cuda_device):
    """At temperature > 0 the graph's registered generator, seeded per
    replay by the engine's formula, draws what the eager step's does."""
    (graph, eager), requests, schedule = _graph_engines("fused", cuda_device,
                                                        temps=(0.9, 0.0, 0.7))
    rg, _, _ = _serve_counted(graph, requests, schedule)
    re_, _, _ = _serve_counted(eager, requests, schedule)
    for rid in rg:
        assert (rg[rid] == re_[rid]).all(), rid


@pytest.mark.cuda
def test_fold_kernel_equals_plain_folds_on_card(cuda_device):
    """Ragged leaves of every dtype, one misaligned view, one leaf of
    several chunks; the per-slot folds of a cache with odd slot strides:
    bit-equal to the plain versions and to the kernel's chunked model, and
    a flipped bit moves its own total."""
    from repro_torch.core import integrity
    from repro_torch.kernels import fold
    from repro_torch.models.cache import cache_slot_checksums

    g = torch.Generator(device=cuda_device)
    g.manual_seed(11)
    big = torch.randint(0, 256, (3 * fold.CHUNK_BYTES + 1001,), generator=g,
                        device=cuda_device, dtype=torch.uint8)
    tree = {
        "i8": torch.randint(-128, 128, (3, 7), generator=g, device=cuda_device,
                            dtype=torch.int8),
        "i32": torch.randint(-(2**31), 2**31 - 1, (5, 13), generator=g, device=cuda_device,
                             dtype=torch.int32),
        "f32": torch.randn((4, 3), generator=g, device=cuda_device),
        "bf16": torch.randn((6, 5), generator=g, device=cuda_device).to(torch.bfloat16),
        "misaligned": big[3:],
        "empty": torch.zeros((0,), device=cuda_device),
    }
    want = integrity.tree_checksum(tree)
    got = fold.tree_fold(tree)
    assert int(got) == int(want)
    leaves = list(integrity._leaves(tree))
    assert int(fold.chunked_fold([t.cpu() for t in leaves], 1)[0]) == int(got)
    big[fold.CHUNK_BYTES + 77] ^= 8
    assert int(fold.tree_fold(tree)) != int(got)
    assert int(fold.tree_fold(tree)) == int(integrity.tree_checksum(tree))

    cache = {"step": torch.randint(0, 99, (3,), generator=g, device=cuda_device,
                                   dtype=torch.int32),
             "layers": [{"k_q": torch.randint(-128, 128, (3, 7, 5), generator=g,
                                              device=cuda_device, dtype=torch.int8),
                         "k_scale": torch.rand((3, 7), generator=g, device=cuda_device),
                         "len": torch.zeros((3,), dtype=torch.int32, device=cuda_device)}
                        for _ in range(2)]}
    sums = fold.slot_folds(cache)
    assert torch.equal(sums, cache_slot_checksums(cache))
    cache["layers"][1]["k_q"][1, 6, 4] ^= 1
    moved = (fold.slot_folds(cache) != sums).tolist()
    assert moved == [False, True, False]
    assert torch.equal(fold.slot_folds(cache), cache_slot_checksums(cache))


@pytest.mark.cuda
def test_capture_error_raises_and_runs_nothing_eagerly(cuda_device, monkeypatch):
    """A step that reads a value back cannot be captured: the engine raises
    and never runs the step eagerly in its place."""
    from repro_torch.launch import sampling

    (graph, _), requests, schedule = _graph_engines("fused", cuda_device)
    calls = []
    real = sampling.greedy

    def reads_back(logits, gen=None):
        calls.append(torch.cuda.is_current_stream_capturing())
        int(logits.argmax())  # a read-back: refused under capture
        return real(logits, gen)

    monkeypatch.setattr(sampling, "greedy", reads_back)
    graph.set_precision(None)
    with pytest.raises(RuntimeError):
        graph.run(requests()[:1])
    # the prefill's first token and the warm-up ran it eagerly; the capture
    # raised inside it, and nothing called it after
    assert calls[-1] is True and calls.count(True) == 1
    assert not graph._compiled_graphs
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["booth", "sbmwc"])
def test_systolic_simulator_on_card_equals_cpu(cuda_device, variant):
    """The cycle-accurate serial-MAC simulator (``core/systolic.py``) on the
    card gives its CPU result and the exact products (modulo 2^32, the
    int32 accumulator): every 8-bit pair, random 16-bit dot products of
    1000 values, and a product on the 64 x 16 array."""
    from repro_torch.core import systolic as sa

    g = torch.Generator()
    g.manual_seed(7)
    vals = torch.arange(-128, 128, dtype=torch.int32)
    mc, ml = (t[..., None] for t in torch.meshgrid(vals, vals, indexing="ij"))
    a = torch.randint(-(1 << 15), 1 << 15, (64, 1000), generator=g, dtype=torch.int32)
    b = torch.randint(-(1 << 15), 1 << 15, (64, 1000), generator=g, dtype=torch.int32)
    am = torch.randint(-(1 << 15), 1 << 15, (16, 100), generator=g, dtype=torch.int32)
    bm = torch.randint(-(1 << 15), 1 << 15, (100, 64), generator=g, dtype=torch.int32)
    cfg = sa.SAConfig(64, 16)

    def wrapped(t):
        return (((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)

    for call, exact in (
        (lambda d: sa.serial_mac_dot(mc.to(d), ml.to(d), 8, variant), (mc * ml)[..., 0]),
        (lambda d: sa.serial_mac_dot(a.to(d), b.to(d), 16, variant),
         wrapped((a.long() * b.long()).sum(dim=-1))),
        (lambda d: sa.serial_sa_matmul(am.to(d), bm.to(d), 16, cfg, variant),
         wrapped(am.long() @ bm.long())),
    ):
        got, cycles = call(cuda_device)
        host, host_cycles = call(torch.device("cpu"))
        assert got.is_cuda and cycles == host_cycles
        assert torch.equal(got.cpu(), host) and torch.equal(host, exact)


# ---------------------------------------------------------------------------
# Scrub-and-retry and paged integrity on the card
# ---------------------------------------------------------------------------


def _scrub_engines(dev, compile_steps=(True, False), **kw):
    """Scrub engines (granite-3-8b reduced, 2 unrolled layers) on one set of
    weights, and a workload of two requests arriving together."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.scheduler import Request

    cfg = dataclasses.replace(get_reduced("granite-3-8b"), scan_layers=False)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, device=dev)
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane", integrity="scrub")
    engines = [ContinuousBatchingEngine(cfg, params, policy, n_slots=2, max_len=24, device=dev,
                                        compile_steps=c, **kw) for c in compile_steps]

    def requests():
        return [Request(rid=i, tokens=np.random.default_rng(i).integers(0, cfg.vocab_size, (s,)),
                        max_new_tokens=8, arrival_step=0) for i, s in enumerate((4, 8))]

    return engines, requests


@pytest.mark.cuda
def test_scrub_in_place_keeps_addresses_on_card(cuda_device):
    """A scrub rebuilds the tree and copies it into the serving leaves:
    every leaf keeps its data_ptr, and the tree's fold (the kernel's)
    equals the load-time fingerprint again after a flipped bit."""
    from repro_torch.core import integrity
    from repro_torch.kernels import fold

    (eng,), _ = _scrub_engines(cuda_device, compile_steps=(True,))
    ptrs = [t.data_ptr() for t in integrity._leaves(eng.q_params)]
    ref = int(fold.tree_fold(eng.q_params))
    assert ref == eng._params_ref == int(integrity.tree_checksum(eng.q_params))
    eng.q_params["layers"][1]["attn"]["o_proj"]["w_planes"].packed.mag[0, 3, 5] ^= 1 << 9
    assert int(fold.tree_fold(eng.q_params)) != ref
    eng._scrub()
    assert [t.data_ptr() for t in integrity._leaves(eng.q_params)] == ptrs
    assert int(fold.tree_fold(eng.q_params)) == ref
    assert eng._scrubs == 1 and len(eng.scrub_s) == 1


@pytest.mark.cuda
def test_page_folds_equal_plain_on_card(cuda_device):
    """The paged cache's per-page and per-slot folds (two launches) equal
    paging.paged_checksums; a flipped bit moves its page alone."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import fold
    from repro_torch.models import paging

    cache = paging.paged_init_cache(get_reduced("granite-3-8b"), 3, 32, 8, 13, device=cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    for leaf in [cache["step"]] + [v for blk in cache["layers"] for v in blk.values()]:
        leaf.view(-1).view(torch.uint8).copy_(torch.randint(
            0, 256, (leaf.numel() * leaf.element_size(),), generator=g, device=cuda_device,
            dtype=torch.uint8))
    pages, slots = fold.page_folds(cache)
    want_p, want_s = paging.paged_checksums(cache)
    assert torch.equal(pages, want_p) and torch.equal(slots, want_s)
    cache["layers"][1]["k_scale"][7, 2, 1] *= 2
    moved = (fold.page_folds(cache)[0] != pages).nonzero().flatten().tolist()
    assert moved == [7]


@pytest.mark.cuda
def test_restored_and_replayed_decode_step_equals_eager_on_card(cuda_device):
    """Audits off, one weight bit flipped at iteration 3 (a decode step):
    the graph engine's alarmed step restores its state from the backup
    its graph wrote, scrubs and replays the same graph with the same seed;
    tokens and integrity counts equal the eager engine's and the clean
    run's, no precision is captured twice and every leaf keeps its
    address."""
    from repro_torch.core import integrity
    from repro_torch.runtime.faults import FaultInjector

    (graph, eager), requests = _scrub_engines(cuda_device, audit_interval=0)
    clean, _ = eager.run(requests())
    ptrs = [t.data_ptr() for t in integrity._leaves(graph.q_params)]
    rg, sg = graph.run(requests(), injector=FaultInjector("planes@3;seed=1"))
    re_, se = eager.run(requests(), injector=FaultInjector("planes@3;seed=1"))
    for rid in clean:
        assert (rg[rid] == clean[rid]).all() and (re_[rid] == clean[rid]).all(), rid
    assert sg["integrity"] == se["integrity"]
    assert sg["integrity"]["step_retries"] >= 1 and sg["integrity"]["scrubs"] >= 1
    assert list(graph.capture_s) == [None]
    assert [t.data_ptr() for t in integrity._leaves(graph.q_params)] == ptrs


def _autopilot_engines(dev, compile_steps=True, **kw):
    """An autopilot engine and a static one (granite-3-8b reduced to 2
    layers, 3 slots), and an uneven overload ramp whose slots fall out of
    step, so requests of different tiers decode side by side."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.autopilot import AutopilotPolicy
    from repro_torch.runtime.scheduler import Request

    cfg = get_reduced("granite-3-8b")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, device=dev)
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane")
    common = dict(n_slots=3, max_len=32, device=dev, compile_steps=compile_steps, **kw)
    ap = ContinuousBatchingEngine(cfg, params, policy, autopilot=AutopilotPolicy(
        sla_queue_steps=4, degrade_patience=2, upgrade_patience=4, cooldown_steps=2,
        shadow_frac=0.5), **common)
    static = ContinuousBatchingEngine(cfg, params, policy, **common)

    def requests():
        return [Request(rid=i, tokens=np.random.default_rng(i).integers(0, cfg.vocab_size, (s,)),
                        max_new_tokens=g_, arrival_step=i // 3)
                for i, (s, g_) in enumerate(zip((5, 9, 7, 6, 11, 4, 8, 5, 9, 6, 7, 10),
                                                (6, 3, 9, 4, 7, 10, 3, 5, 8, 4, 6, 9)))]

    return ap, static, requests


def _state_ptrs(engine):
    trees = [engine._cache, engine._tokens, engine._backup, engine._merge, engine._mask_dev]
    return [t.data_ptr() for tree in trees for t in _tensors(tree)]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@pytest.mark.cuda
def test_mixed_tier_step_equals_each_tiers_static_step_on_card(cuda_device):
    """Each mixed-tier step (a graph replay per tier, merged in place) is
    checked slot by slot against a static engine's single-tier step of the
    same pre-step state: every slot's KV rows, length and next token equal
    the static step of its admission tier's. Every request then equals the
    static run of its tier, and no state buffer moved."""
    ap, static, requests = _autopilot_engines(cuda_device)
    checked = []
    orig = ap._decode_checked

    def checked_step(step_i, passes, pass_of, *args, **kw):
        if len(passes) < 2:
            return orig(step_i, passes, pass_of, *args, **kw)
        pre = {"cache": [{k: v.clone() for k, v in blk.items()} for blk in ap._cache["layers"]],
               "step": ap._cache["step"].clone(), "tokens": ap._tokens.clone()}
        toks, kl = orig(step_i, passes, pass_of, *args, **kw)
        static._temps.copy_(ap._temps)
        for p, prec in enumerate(passes):
            static._cache["step"].copy_(pre["step"])
            for blk, saved in zip(static._cache["layers"], pre["cache"]):
                for k in blk:
                    blk[k].copy_(saved[k])
            static._tokens.copy_(pre["tokens"])
            out, _ = static._decode(step_i, prec)
            for s in [s for s in range(ap.n_slots) if pass_of[s] == p]:
                assert int(out[s]) == int(toks[s]), (step_i, s)
                for a, b in zip(ap._cache["layers"], static._cache["layers"]):
                    for k in a:
                        assert torch.equal(a[k][s], b[k][s]), (step_i, s, k)
        checked.append(step_i)
        return toks, kl

    ap._decode_checked = checked_step
    ap.run(requests())  # warm-up: captures each tier's graph
    ptrs = _state_ptrs(ap)
    results, stats = ap.run(requests())
    assert checked and stats["autopilot"]["mixed_steps"] > 0
    assert _state_ptrs(ap) == ptrs and not stats["capture_s"]
    tiers = stats["autopilot"]["request_tiers"]
    for name in set(tiers.values()):
        w = int(name.split("a")[0][1:])
        static.set_precision(None if w == 8 else w)
        ref, _ = static.run(requests())
        for rid in [r for r, t in tiers.items() if t == name and r in results]:
            assert (results[rid] == ref[rid]).all(), (name, rid)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_autopilot_graph_run_equals_eager_on_card(cuda_device, paged):
    """The autopilot's graph run (mixed-tier passes, merges and the shadow
    probe replayed) gives the eager run's tokens, switches, shed set and
    request tiers; its probe's KL agrees within 1e-5."""
    kw = dict(page_size=8) if paged else {}
    graph, _, requests = _autopilot_engines(cuda_device, **kw)
    eager, _, _ = _autopilot_engines(cuda_device, compile_steps=False, **kw)
    (rg, sg), (re_, se) = graph.run(requests()), eager.run(requests())
    ag, ae = sg["autopilot"], se["autopilot"]
    assert sorted(rg) == sorted(re_) and all((rg[r] == re_[r]).all() for r in rg)
    for key in ("switches", "request_tiers", "tier_tokens", "shed", "mixed_steps",
                "shadow_probes"):
        assert ag[key] == ae[key], key
    assert sg["failed"] == se["failed"]
    if ag["shadow_kl_ewma"] is not None:
        assert abs(ag["shadow_kl_ewma"] - ae["shadow_kl_ewma"]) <= 1e-5 * ae["shadow_kl_ewma"]


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["digit", "bitplane"])
def test_float32_oracle_within_bound_of_float64_on_card(cuda_device, level):
    """16-bit operands at one full-width shape (granite-3-8b's gate, M=4):
    the float32-accumulated oracle is within 1e-5 of max|exact| of the
    float64 product of the same int32 operands (bit-plane level on a
    narrower N: its 256 pair products are what the card would run)."""
    from repro_torch.core import bitserial

    g = torch.Generator(device=cuda_device)
    g.manual_seed(16)
    n = 12800 if level == "digit" else 512
    a = torch.randint(-(1 << 15), 1 << 15, (4, 4096), generator=g, device=cuda_device,
                      dtype=torch.int32)
    w = torch.randint(-(1 << 15), 1 << 15, (4096, n), generator=g, device=cuda_device,
                      dtype=torch.int32)
    got = bitserial.bitserial_matmul(a, w, a_bits=16, w_bits=16, level=level,
                                     accum_dtype=torch.float32)
    exact = a.double() @ w.double()
    assert got.dtype == torch.float32
    assert (got.double() - exact).abs().max() <= 1e-5 * exact.abs().max()


@pytest.mark.cuda
def test_lockstep_graph_replay_equals_eager_on_card(cuda_device):
    """The lockstep engine's decode steps replayed from graphs (one per
    precision) give the eager step's tokens, before and after an 8 -> 4
    dial; with bf16 KV they equal continuous batching at the same batch."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine, Engine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.scheduler import Request

    cfg = get_reduced("granite-3-8b")
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    params = init_params(cfg, g, device=cuda_device)
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 7))
    graph, eager = (Engine(cfg, params, policy, max_len=16, device=cuda_device,
                           compile_steps=c) for c in (True, False))
    for prec in (None, 4):
        graph.set_precision(prec)
        eager.set_precision(prec)
        tg, _ = graph.generate(prompts, 6)
        te, _ = eager.generate(prompts, 6)
        assert torch.equal(tg, te), prec
    assert set(graph._compiled_graphs) == {None, (4, 4)}
    graph.set_precision(None)
    tg, _ = graph.generate(prompts, 6)
    cb = ContinuousBatchingEngine(cfg, params, policy, n_slots=3, max_len=16, kv_quant=False,
                                  device=cuda_device)
    res, _ = cb.run([Request(rid=i, tokens=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    for i in range(3):
        assert (res[i] == tg[i].cpu().numpy()).all(), i


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", None), ("recurrentgemma-2b", 5)])
def test_family_graph_replay_equals_eager_on_card(cuda_device, arch, n_layers):
    """The SSM stack and the hybrid (one period and a 2-layer tail) at their
    reduced widths: the graph engine's tokens, launches and decode state
    (the SSM state, the conv rows, the RG-LRU ``h`` and the KV ring, bit
    for bit) equal the eager step's across an 8 -> 4 switch, with a prompt
    that fills the reduced hybrid's 16-row ring twice."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.scheduler import Request

    cfg = get_reduced(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    params = init_params(cfg, g, device=cuda_device)
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane")
    engines = [ContinuousBatchingEngine(cfg, params, policy, n_slots=2, max_len=48,
                                        device=cuda_device, compile_steps=c)
               for c in (True, False)]

    def requests():
        return [Request(rid=i, tokens=np.random.default_rng(i).integers(0, cfg.vocab_size, (s,)),
                        max_new_tokens=12, arrival_step=2 * i)
                for i, s in enumerate((8, 32, 16))]

    (rg, sg, lg), (re_, se, le) = [_serve_counted(e, requests, {4: 4}) for e in engines]
    assert set(engines[0]._compiled_graphs) == {None, (4, 4)}
    for rid in rg:
        assert (rg[rid] == re_[rid]).all(), rid
    assert sg["route_calls"] == se["route_calls"] and lg == le and lg["fused_plane_linear"] > 0
    for a, b in zip(engines[0]._cache["layers"], engines[1]._cache["layers"]):
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "internvl2-2b"])
def test_moe_and_vlm_graph_replay_equals_eager_on_card(cuda_device, arch):
    """The MoE decode step (the capacity dispatch, the per-call expert fake
    quantizers, the combine in k order) and the VLM's, at their reduced
    widths with the router dense: the graph engine's tokens, launches and
    cache equal the eager step's across an 8 -> 4 switch; at 2 slots a
    reduced scout's expert holds one decode copy, so free slots compete."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.scheduler import Request

    cfg = get_reduced(arch)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    params = init_params(cfg, g, device=cuda_device)
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane", keep_dense=("frontend", "router"))
    engines = [ContinuousBatchingEngine(cfg, params, policy, n_slots=2, max_len=48,
                                        device=cuda_device, compile_steps=c)
               for c in (True, False)]

    def requests():
        return [Request(rid=i, tokens=np.random.default_rng(i).integers(0, cfg.vocab_size, (s,)),
                        max_new_tokens=12, arrival_step=2 * i)
                for i, s in enumerate((8, 32, 16))]

    (rg, sg, lg), (re_, se, le) = [_serve_counted(e, requests, {4: 4}) for e in engines]
    assert set(engines[0]._compiled_graphs) == {None, (4, 4)}
    for rid in rg:
        assert (rg[rid] == re_[rid]).all(), rid
    assert sg["route_calls"] == se["route_calls"] and lg == le and lg["fused_plane_linear"] > 0
    for a, b in zip(engines[0]._cache["layers"], engines[1]._cache["layers"]):
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits,microbatches", [(0, 1), (8, 2)])
def test_train_step_on_card_equals_host_step(cuda_device, w_bits, microbatches):
    """One ``make_train_step`` step of the reduced granite-3-8b on the card
    against the same step on the host, from the same parameters and batch:
    the loss within 1e-3 relative, the gradient norm within 1e-2, and each
    updated bf16 leaf equal in at least 97% of its elements (the card's
    float32 sums take another order; the host's are held to the
    reference in test_torch_train.py)."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core import tree as tr
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.transformer import init_params, stack_layers
    from repro_torch.optim import OptimConfig

    cfg = get_reduced("granite-3-8b")
    g = torch.Generator()
    g.manual_seed(0)
    host = stack_layers(cfg, init_params(cfg, g))
    opt = OptimConfig(peak_lr=1e-3, total_steps=10)
    policy = PrecisionPolicy.uniform(w_bits, w_bits) if w_bits else PrecisionPolicy.off()
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33)))
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        params = tr.tree_map(lambda t: t.to(dev), host)
        state = init_opt_state(cfg, opt, params)
        batch = {"tokens": tok[:, :-1].to(dev), "targets": tok[:, 1:].to(dev)}
        step = make_train_step(cfg, opt, policy=policy, microbatches=microbatches)
        new, _, metrics = step(params, state, batch, 0)
        results.append((tr.tree_map(lambda t: t.cpu(), new), float(metrics["loss"]),
                        float(metrics["grad_norm"])))
    (hp, hl, hn), (cp, cl, cn) = results
    assert np.isclose(cl, hl, rtol=1e-3) and np.isclose(cn, hn, rtol=1e-2), (hl, cl, hn, cn)
    for (path, a), b in zip(tr.flatten_with_path(hp), tr.leaves(cp)):
        assert a.dtype == b.dtype
        assert (a == b).float().mean() >= 0.97, tr.path_key(path)


@pytest.mark.cuda
@pytest.mark.parametrize("route,level", [("fused_cached", "bitplane"), ("staged_packed", "bitplane"),
                                         ("staged", "digit"), ("cached_planes", "bitplane")])
@pytest.mark.parametrize("m,k,n", [(1, 33, 16), (5, 2000, 257), (40, 4096, 129)])
def test_every_tuner_candidate_equals_the_default_on_card(cuda_device, route, level, m, k, n):
    """Row tiles and K splits change a launch's geometry, never its result:
    every candidate the tuner ranks gives the default's output bit for bit
    (the fused kernel's raw accumulator and its bf16 epilogue), and the
    tuner's timer returns a finite time for each and puts every wrapper's
    launch count back."""
    from repro_torch.core import autotune
    from repro_torch.core.plan import PlanKey
    from repro_torch.launch import graphs

    cache = ("bitplane", "booth", 8, True, 512, False, 8, False) if route == "fused_cached" else None
    key = PlanKey(m=m, k=k, n=n, a_bits=8, w_bits=8, a_in_bits=8, w_in_bits=8, variant="booth",
                  level=level, mode="fully_serial", backend="cuda", accum="int32",
                  has_epilogue=route == "fused_cached", cache=cache, fused=None, packed=None,
                  bm=None, bn=None, bk=None)
    timer = autotune.KernelTimer()
    call = timer.route_call(key, route)
    cands = autotune.tile_candidates(key, route)
    for raw in ((False, True) if route == "fused_cached" else (False,)):
        want = call(cands[0][0], cands[0][3], raw=raw)
        for tiles in cands[1:]:
            assert torch.equal(call(tiles[0], tiles[3], raw=raw), want), (tiles, raw)
    before = {name: fn.launches for name, fn in graphs.launch_counters().items()}
    for tiles in cands:
        assert 0 < timer(key, route, tiles, repeats=1) < 1e6
    assert {name: fn.launches for name, fn in graphs.launch_counters().items()} == before


@pytest.mark.cuda
def test_tp_decode_step_graph_over_nccl_equals_eager_on_card(cuda_device, tmp_path):
    """A tensor-parallel decode step over an NCCL group of world size 1,
    captured in a CUDA graph with its collectives inside, replays the eager
    TP step's tokens, which equal the single-device step's."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch import graphs, mesh
    from repro_torch.launch.serve import _decode_body
    from repro_torch.launch.steps import make_cb_decode_step, make_tp_cb_decode_step
    from repro_torch.models.cache import init_cache
    from repro_torch.models.quant import quantize_params
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding.tp import shard_quantized

    cfg = get_reduced("granite-3-8b")
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    params = init_params(cfg, g, device=cuda_device)
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane")

    def state():
        # a cache with garbage history: random int8 KV, lengths 3 and 7
        gs = torch.Generator(device=cuda_device)
        gs.manual_seed(1)
        cache = init_cache(cfg, 2, 16, cfg.dtype, kv_quant=True, device=cuda_device)
        for blk in cache["layers"]:
            blk["k_q"].copy_(torch.randint(-127, 128, blk["k_q"].shape, generator=gs,
                                           device=cuda_device, dtype=torch.int8))
            blk["v_q"].copy_(torch.randint(-127, 128, blk["v_q"].shape, generator=gs,
                                           device=cuda_device, dtype=torch.int8))
            blk["k_scale"].fill_(0.01)
            blk["v_scale"].fill_(0.01)
            blk["len"].copy_(torch.tensor([3, 7], dtype=torch.int32))
        cache["step"].copy_(torch.tensor([3, 7], dtype=torch.int32))
        return {"cache": cache, "tokens": torch.tensor([[5], [9]], dtype=torch.int32,
                                                       device=cuda_device),
                "temps": torch.zeros((2,), dtype=torch.float32, device=cuda_device)}

    def run(body, graph=False):
        st = state()
        if not graph:
            return [body(st, None).cpu() for _ in range(4)]
        captured = graphs.CapturedStep(body, st, plan_mod.DEFAULT_REGISTRY,
                                       graphs.CudaGraphRunner(cuda_device))
        return [captured(i).cpu() for i in range(4)]

    single = run(_decode_body(make_cb_decode_step(cfg, policy),
                              quantize_params(params, policy, cfg=cfg, plane_cache=True), False))
    tp = mesh.init_tp_group(1, 0, str(tmp_path), backend="nccl")
    try:
        body = _decode_body(make_tp_cb_decode_step(cfg, tp, policy),
                            shard_quantized(params, policy, tp, cfg=cfg), False)
        eager = run(body)
        replayed = run(body, graph=True)
    finally:
        dist.destroy_process_group()
    for a, b, c in zip(single, eager, replayed):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 4])
def test_decode_attention_over_head_slices_is_bit_equal_on_card(cuda_device, size):
    """On the card the decode attention over one rank's heads gives the
    whole heads' bits (cuBLAS picks a batched product's reduction order by
    the batch count, so the heads are attended one at a time), at
    granite-3-8b's head shapes with an int8 cache."""
    from repro_torch.layers.attention import _decode_gqa

    g = torch.Generator(device=cuda_device)
    g.manual_seed(size)
    b, s, hq, hkv, d = 4, 272, 32, 8, 128
    q = torch.randn((b, 1, hq, d), generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=cuda_device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, hkv), generator=g, device=cuda_device) * 0.01
              for _ in range(2))
    valid = torch.arange(s, device=cuda_device)[None, :] < torch.tensor(
        [[1], [37], [200], [272]], device=cuda_device)
    whole = _decode_gqa(q, k, v, valid, ks, vs)
    hs, kh = hq // size, hkv // size
    for r in range(size):
        sl = slice(r * kh, (r + 1) * kh)
        part = _decode_gqa(q[:, :, r * hs:(r + 1) * hs], k[:, :, sl], v[:, :, sl], valid,
                           ks[:, :, sl], vs[:, :, sl])
        assert torch.equal(part, whole[:, :, r * hs:(r + 1) * hs]), f"rank {r}"


@pytest.mark.cuda
def test_shards_of_a_host_tree_equal_the_card_quantization(cuda_device):
    """A dense tree drawn on the card and kept on the host (each part moved
    there as it is drawn, ``init_params(each=)``) holds the card tree's
    values; its shard,
    sliced on the host and quantized on the card (a context of one rank),
    equals the single-device quantization of the card tree leaf for leaf,
    every leaf on the card."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.models.quant import quantize_params
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding.tp import TPContext, shard_quantized

    cfg = get_reduced("granite-3-8b")
    policy = PrecisionPolicy.uniform(8, 8, level="bitplane", integrity="detect")

    def draw(each=None):
        g = torch.Generator(device=cuda_device)
        g.manual_seed(0)
        return init_params(cfg, g, device=cuda_device, each=each)

    host = draw(lambda part, path: tree_map(lambda t: t.cpu(), part))
    card = draw()
    assert all(a.device.type == "cpu" and torch.equal(a, b.cpu())
               for a, b in zip(leaves(host), leaves(card)))

    def flat(node):
        if isinstance(node, torch.Tensor):
            return [node]
        if dataclasses.is_dataclass(node):
            return [t for f in dataclasses.fields(node) for t in flat(getattr(node, f.name))]
        if isinstance(node, (list, tuple)):
            return [t for v in node for t in flat(v)]
        if isinstance(node, dict):
            return [t for k in sorted(node) for t in flat(node[k])]
        return []

    got = flat(shard_quantized(host, policy, TPContext(size=1), cfg=cfg, device=cuda_device))
    want = flat(quantize_params(card, policy, cfg=cfg, plane_cache=True))
    assert len(got) == len(want)
    assert all(x.is_cuda and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_deepseek_coder_33b_across_four_cards_equals_one(tmp_path):
    """deepseek-coder-33b at full width, 16 of its 62 layers, over NCCL
    with CUDA graphs (the chip smoke's workload: 4 prompts of 32-256
    tokens, 16 new tokens, int8 KV, the 8 -> 4 switch at step 8): the
    greedy tokens at P=2 and P=4 (each rank loading its shard layer by
    layer) equal one card's. Prints each rank's card peak, card resident
    and host peak RSS (GiB)."""
    import json

    import _torch_tp_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    out = {p: spawn_ranks(ranks.rank_deepseek, p, device="cuda", args=(16,),
                       store_dir=str(tmp_path)) for p in (1, 2, 4)}
    for p, res in out.items():
        print(json.dumps({"check": "deepseek-coder-33b 16 layers", "P": p,
                          "memory_gib_per_rank (card peak, card resident, host peak RSS)":
                          res["memory"], "card": res["card"]}))
        assert not res["failed"] and sorted(res["tokens"]) == [0, 1, 2, 3]
        assert res["switches"] == [(8, (4, 4))]
    assert out[2]["tokens"] == out[1]["tokens"]
    assert out[4]["tokens"] == out[1]["tokens"]


def _card() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


@pytest.mark.cuda
def test_deepseek_coder_33b_mesh_training_across_four_cards(tmp_path):
    """deepseek-coder-33b at full width trained through ``TrainRun`` on
    (data, model) meshes of NCCL ranks, one card each (batch 8 x 256, 3
    steps, the third traced), all in one world of four ranks:

    * at 4 layers with AdamW, meshes (2,2), (4,1) and (1,4) give one card's
      losses (a world of one rank, started after the four have ended, so
      no rank shares its card): the first within 1e-3 (only the order of
      the sums differs), all within the reference's 2e-2 between meshes;
    * at 16 layers (8.94 G parameters: ~107 GB of bf16 parameters, bf16
      gradients and float32 AdamW state, more than one card holds) the
      (2,2) mesh trains;
    * a checkpoint written at (2,2) (1 layer, Adafactor: a small state to
      write) resumes at (4,1) through ``ElasticMesh`` with every parameter
      bit-equal.

    A run that takes longer than ``WATCHDOG_S`` makes every rank print its
    stacks and exit (a hung collective fails the test with its place). Prints per run the losses,
    the step ms (median), each rank's card peak and resident GiB, and the
    traced step's collective and kernel ms, with the card's name and power
    limit."""
    import dataclasses
    import json

    import numpy as np

    import _torch_mesh_ranks as ranks
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import TrainRun

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    card, full = _card(), get_config("deepseek-coder-33b")
    ck = str(tmp_path / "ckpt")

    def run(layers, model_axis, **kw):
        return TrainRun(cfg=dataclasses.replace(full, n_layers=layers), global_batch=8,
                        seq_len=256, model_axis=model_axis, log_every=1000,
                        **{"steps": 3, "gather_params": False, "profile_step": 2, **kw})

    mesh_runs = {"(2,2)": run(4, 2), "(4,1)": run(4, 1), "(1,4)": run(4, 4),
                 "(2,2) 16 layers": run(16, 2),
                 "save (2,2)": run(1, 2, steps=2, optimizer="adafactor", profile_step=None,
                                   gather_params=True, ckpt_dir=ck, ckpt_every=100),
                 "resume (4,1)": run(1, 1, steps=2, optimizer="adafactor", profile_step=None,
                                     gather_params=True, ckpt_dir=ck, ckpt_every=100)}
    got = spawn_ranks(ranks.rank_train_runs, 4, device="cuda", args=(
        mesh_runs, ("save (2,2)", "resume (4,1)"), WATCHDOG_S))
    got.update(spawn_ranks(ranks.rank_train_runs, 1, device="cuda",
                           args=({"(1,1)": run(4, 1, profile_step=None)}, None, WATCHDOG_S)))
    for name, r in got.items():
        if name == "bit_equal":
            continue
        print(json.dumps({"check": f"deepseek-coder-33b mesh training {name}", "card": card,
                          **{k: v for k, v in r.items() if k != "step_ms"},
                          "step_ms_median": float(np.median(r["step_ms"]))
                          if r["step_ms"] else None}), flush=True)
    one = got["(1,1)"]
    for name in ("(2,2)", "(4,1)", "(1,4)"):
        assert got[name]["losses"][0] == pytest.approx(one["losses"][0], rel=1e-3), name
        np.testing.assert_allclose(got[name]["losses"], one["losses"], rtol=2e-2, atol=2e-2)
    big = got["(2,2) 16 layers"]
    assert len(big["losses"]) == 3 and np.isfinite(big["losses"]).all()
    assert got["resume (4,1)"]["losses"] == []
    assert got["resume (4,1)"]["mesh"] == {"data": 4, "model": 1}
    assert got["bit_equal"] is True


#: seconds a run of the four-card test may take before its ranks print their
#: stacks and exit
WATCHDOG_S = 150
