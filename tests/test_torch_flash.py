"""Port parity of the flash-attention kernels' functions.

On the CPU the plain PyTorch versions (``kernels/flash_attention.py``) are
held against the reference's Pallas kernels run in interpret mode, and
the port's ``ops.flash_attention`` against the reference's jnp path, on
seeded numpy inputs. Tolerances: float32 outputs within 1e-5 of max|ref|
(the two sum the q.k and p.v products in different orders; the measured
gap is ~4e-7 at these sizes); bf16 outputs within one bf16 step of the
element plus that float32 tolerance (a float32 difference can flip one
rounding). The paged plain version equals the dense plain version on
gathered pools bit for bit, as the reference's kernels do. The Hopper
kernels are held against these plain versions on the card by
test_torch_cuda.py.

Two traps are pinned here: the kernels' causal mask is aligned to the top
left and the oracle's to the bottom right (they agree only when Sq == Sk),
and the serving path's ``_decode_gqa`` rounds the softmax weights to bf16
where the kernels keep float32 (close, not bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import paged_flash_attention as jpaged
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.layers.attention import _decode_gqa

from _torch_parity import t2n

F32_RTOL = 1e-5  # of max|ref|: summation order


def _close(got: torch.Tensor, want, what=""):
    """float32: within F32_RTOL of max|ref|; bf16: one bf16 step of the
    element on top of that."""
    want = np.asarray(want).astype(np.float32)
    g = t2n(got).astype(np.float32)
    atol = F32_RTOL * max(1.0, float(np.abs(want).max()))
    if got.dtype == torch.bfloat16:
        mag = np.maximum(np.abs(want), np.abs(g))
        step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        atol = atol + step
    bad = np.abs(g - want) > atol
    assert not bad.any(), f"{what}: {int(bad.sum())} elements off, max {np.abs(g - want).max()}"


def _arr(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _to_j(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else None)


def _to_t(a, dtype):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if dtype == "bf16" else t


DENSE_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, block_q, block_k, causal, q/kv dtype, extra)
    "causal_gqa": (2, 4, 2, 16, 16, 16, 8, 8, True, "f32", {}),
    "noncausal": (1, 2, 2, 8, 24, 16, 8, 8, False, "f32", {}),
    "kv_len_padding": (2, 4, 1, 8, 16, 16, 8, 8, False, "f32", {"kv_len": 11}),
    "kv_lens": (3, 4, 2, 8, 16, 16, 4, 8, True, "f32", {"kv_lens": [0, 5, 16]}),
    "int8_scales_bf16": (2, 4, 2, 1, 32, 16, 1, 8, False, "int8", {"kv_lens": [9, 32]}),
    "causal_sq_lt_sk": (1, 2, 1, 8, 16, 16, 8, 8, True, "f32", {}),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_plain_flash_attention_matches_reference_kernel(case):
    b, hq, hkv, sq, sk, d, bq, bk, causal, dt, extra = DENSE_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = _arr(rng, (b, hkv, sk, d), dt), _arr(rng, (b, hkv, sk, d), dt)
    jkw, tkw = {}, {}
    if "kv_len" in extra:
        jkw["kv_len"] = tkw["kv_len"] = extra["kv_len"]
    if "kv_lens" in extra:
        lens = np.asarray(extra["kv_lens"], np.int32)
        jkw["kv_lens"], tkw["kv_lens"] = jnp.asarray(lens), torch.from_numpy(lens)
    qd = "f32"
    if dt == "int8":  # a quantized cache: bf16 queries, scales folded in
        qd = "bf16"
        for name in ("k_scale", "v_scale"):
            sc = rng.uniform(0.001, 0.02, (b, hkv, sk)).astype(np.float32)
            jkw[name], tkw[name] = jnp.asarray(sc), torch.from_numpy(sc)
    want = jflash(_to_j(q, qd), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  block_q=bq, block_k=bk, interpret=True, **jkw)
    got = tfa.flash_attention(_to_t(q, qd), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, block_q=bq, block_k=bk, **tkw)
    assert got.dtype == (torch.bfloat16 if qd == "bf16" else torch.float32)
    _close(got, want, case)
    if case == "causal_sq_lt_sk":
        # trap: the kernel's causal mask is aligned to the top left, the
        # oracle's to the bottom right — the same inputs give other rows
        oracle = tref.attention_ref(_to_t(q, qd), torch.from_numpy(k), torch.from_numpy(v))
        _close(oracle, jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
               "attention_ref")
        assert not np.allclose(t2n(oracle), t2n(got), atol=1e-3)


def _paged_inputs(rng, b=3, hq=8, hkv=2, d=16, ps=8, p=6, lens=(37, 1, 48)):
    """Pools in a permuted page order, tables padded with the null page,
    which holds non-zero garbage."""
    n_pages = b * p + 1
    kq = rng.integers(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (n_pages, ps, hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (n_pages, ps, hkv)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages))[: b * p].reshape(b, p).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for i in range(b):
        tables[i, -(-int(lens[i]) // ps):] = 0
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    return q, kq, vq, ks, vs, tables, lens


def _gathered(pool, tables, scales=False):
    b, p = tables.shape
    g = pool[tables].reshape(b, p * pool.shape[1], *pool.shape[2:])
    return g.transpose(0, 2, 1) if scales else g.transpose(0, 2, 1, 3)


def test_plain_paged_matches_reference_kernel_and_dense_bit_for_bit():
    rng = np.random.default_rng(0)
    q, kq, vq, ks, vs, tables, lens = _paged_inputs(rng)
    jargs = [jnp.asarray(q, jnp.bfloat16)] + [jnp.asarray(a) for a in (kq, vq, ks, vs, tables, lens)]
    targs = [_to_t(q, "bf16")] + [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs, tables, lens)]
    want = jpaged(*jargs, interpret=True)
    got = tfa.paged_flash_attention(*targs)
    assert got.dtype == torch.bfloat16
    _close(got, want, "paged")
    for out_dtype in (torch.float32, torch.bfloat16):
        paged = tfa.paged_flash_attention(*targs, out_dtype=out_dtype)
        dense = tfa.flash_attention(
            targs[0], torch.from_numpy(_gathered(kq, tables).copy()),
            torch.from_numpy(_gathered(vq, tables).copy()), causal=False,
            kv_lens=torch.from_numpy(lens), k_scale=torch.from_numpy(_gathered(ks, tables, True).copy()),
            v_scale=torch.from_numpy(_gathered(vs, tables, True).copy()),
            block_q=1, block_k=kq.shape[1], out_dtype=out_dtype)
        assert torch.equal(paged, dense), out_dtype


def test_paged_kernel_function_is_close_to_decode_gqa_but_not_equal():
    """The serving path's ``_decode_gqa`` (used on gathered pools by the
    plain paged engine) rounds the softmax weights to bf16 before the
    value product; the kernels keep them in float32."""
    rng = np.random.default_rng(1)
    q, kq, vq, ks, vs, tables, lens = _paged_inputs(rng)
    qt = _to_t(q, "bf16")
    kernel = tfa.paged_flash_attention(
        qt, *(torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs, tables, lens)),
        out_dtype=torch.float32)
    s_max = tables.shape[1] * kq.shape[1]
    valid = torch.arange(s_max)[None, :] < torch.from_numpy(lens)[:, None].long()
    g = lambda pool: torch.from_numpy(pool[tables].reshape(len(lens), s_max, *pool.shape[2:]).copy())  # noqa: E731
    serving = _decode_gqa(qt.permute(0, 2, 1, 3), g(kq), g(vq), valid, g(ks), g(vs))
    serving = serving.permute(0, 2, 1, 3)
    diff = (kernel - serving).abs()
    assert float(diff.max()) <= 2.0**-8 * float(serving.abs().max())
    assert float(diff.max()) > 0


@pytest.mark.parametrize("quant", [False, True])
def test_ops_flash_attention_matches_reference_jnp_path(quant):
    rng = np.random.default_rng(5 + quant)
    b, hq, hkv, sq, sk, d = 2, 4, 2, 5, 11, 16
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if quant:
        k, v = _arr(rng, (b, hkv, sk, d), "int8"), _arr(rng, (b, hkv, sk, d), "int8")
        for name in ("k_scale", "v_scale"):
            sc = rng.uniform(0.001, 0.02, (b, hkv, sk)).astype(np.float32)
            kw_j[name], kw_t[name] = jnp.asarray(sc), torch.from_numpy(sc)
        lens = np.array([7, 11], np.int32)
        kw_j["kv_lens"], kw_t["kv_lens"] = jnp.asarray(lens), torch.from_numpy(lens)
    else:
        k, v = _arr(rng, (b, hkv, sk, d), "f32"), _arr(rng, (b, hkv, sk, d), "f32")
    qd = "bf16" if quant else "f32"
    want = jops.flash_attention(_to_j(q, qd), jnp.asarray(k), jnp.asarray(v), backend="jnp",
                                causal=not quant, **kw_j)
    got = tops.flash_attention(_to_t(q, qd), torch.from_numpy(k), torch.from_numpy(v),
                               causal=not quant, **kw_t)
    _close(got, want, f"ops quant={quant}")


def test_wrappers_raise_the_reference_errors():
    """Every ValueError of the reference wrappers, with the same words."""
    q = torch.zeros((2, 4, 1, 16), dtype=torch.bfloat16)
    pool = torch.zeros((5, 8, 2, 16), dtype=torch.int8)
    scale = torch.zeros((5, 8, 2))
    tables = torch.zeros((2, 3), dtype=torch.int32)
    lens = torch.zeros((2,), dtype=torch.int32)
    paged = tfa.paged_flash_attention
    with pytest.raises(ValueError, match="block_tables"):
        paged(q, pool, pool, scale, scale, torch.zeros((3, 3), dtype=torch.int32), lens)
    with pytest.raises(ValueError, match="kv_lens"):
        paged(q, pool, pool, scale, scale, tables, torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError, match="v_scale_pool"):
        paged(q, pool, pool, scale, torch.zeros((5, 8, 3)), tables, lens)
    with pytest.raises(ValueError, match="GQA"):
        paged(torch.zeros((2, 3, 1, 16)), pool, pool, scale, scale, tables, lens)
    with pytest.raises(ValueError, match="tile"):
        paged(torch.zeros((2, 4, 3, 16)), pool, pool, scale, scale, tables, lens, block_q=2)

    dense = tfa.flash_attention
    qd, kd = torch.zeros((2, 4, 8, 16)), torch.zeros((2, 2, 16, 16))
    with pytest.raises(ValueError, match="GQA"):
        dense(torch.zeros((2, 3, 8, 16)), kd, kd)
    with pytest.raises(ValueError, match="tile"):
        dense(qd, kd, kd, block_q=3)
    with pytest.raises(ValueError, match="exclusive"):
        dense(qd, kd, kd, block_q=8, block_k=8, kv_len=4, kv_lens=torch.ones(2))
    with pytest.raises(ValueError, match="kv_lens"):
        dense(qd, kd, kd, block_q=8, block_k=8, kv_lens=torch.ones(3))
    with pytest.raises(ValueError, match="k_scale"):
        dense(qd, kd, kd, block_q=8, block_k=8, k_scale=torch.ones((2, 2, 8)))
    with pytest.raises(ValueError, match="out of range"):
        dense(qd, kd, kd, block_q=8, block_k=8, kv_len=17)
    # the reference raises the same words for the same arguments
    with pytest.raises(ValueError, match="exclusive"):
        jflash(jnp.zeros((2, 4, 8, 16)), jnp.zeros((2, 2, 16, 16)),
                            jnp.zeros((2, 2, 16, 16)), block_q=8, block_k=8, kv_len=4,
                            kv_lens=jnp.ones((2,), jnp.int32), interpret=True)


# The dense kernel's tensor-core body (csrc/attn_mma.cuh) rounds where the
# plain version does not: bf16 q.k products summed in float32, and the
# probabilities as a bf16 high and low part against bf16 V.
# ``mma_body_model`` is the plain model of that rounding; it must lie within
# the tolerance the chip smoke holds the kernel to, MMA_RTOL of max|plain|,
# of the plain version and of the reference's Pallas kernel.
MMA_RTOL = 1e-4

MMA_CASES = {
    # name: (K/V dtype, causal, kv_lens, block_q, block_k)
    "int8_causal_lens": ("int8", True, [128, 0], 64, 64),
    "int8_lens": ("int8", False, [77, 128], 64, 64),
    "bf16_causal": ("bf16", True, None, 64, 32),
    "bf16_lens": ("bf16", False, [100, 0], 32, 64),
}


@pytest.mark.parametrize("case", list(MMA_CASES))
def test_mma_body_model_within_the_smoke_tolerance(case):
    dt, causal, lens, bq, bk = MMA_CASES[case]
    b, hq, hkv, s, d = 2, 4, 2, 128, 64
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k, v = _arr(rng, (b, hkv, s, d), dt), _arr(rng, (b, hkv, s, d), dt)
    jkw, tkw = {}, {}
    if lens is not None:
        arr = np.asarray(lens, np.int32)
        jkw["kv_lens"], tkw["kv_lens"] = jnp.asarray(arr), torch.from_numpy(arr)
    if dt == "int8":
        for name in ("k_scale", "v_scale"):
            sc = rng.uniform(0.001, 0.02, (b, hkv, s)).astype(np.float32)
            jkw[name], tkw[name] = jnp.asarray(sc), torch.from_numpy(sc)
    qt, kt, vt = _to_t(q, "bf16"), _to_t(k, dt), _to_t(v, dt)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    assert tfa.dense_body(qt.dtype, kt.dtype, bq, d, True) == "tensor_core"
    model = tfa.mma_body_model(qt, kt, vt, **kw, **tkw)
    plain = tfa.flash_attention_plain(qt, kt, vt, out_dtype=torch.float32, **kw, **tkw)
    want = np.asarray(jflash(_to_j(q, "bf16"), _to_j(k, dt), _to_j(v, dt), interpret=True,
                             out_dtype=jnp.float32, **kw, **jkw))
    for ref, what in ((t2n(plain), "plain"), (want, "reference kernel")):
        err = float(np.abs(t2n(model) - ref).max())
        print(f"{case}: model vs {what}: {err / float(np.abs(ref).max()):.3g} of max|ref|")
        assert err <= MMA_RTOL * float(np.abs(ref).max()), (what, err)
    # the model rounds differently from the plain version (it is a model)
    assert not torch.equal(model, plain)


def test_dense_body_follows_the_arguments():
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    assert tfa.dense_body(bf, bf, 128, 128, True) == "tensor_core"
    assert tfa.dense_body(bf, i8, 16, 64, True) == "tensor_core"
    # decode, the paged kernel's twin: non-causal with per-lane lengths
    twin = dict(causal=False, lens=True, rows=4)
    assert tfa.dense_body(bf, i8, 1, 128, True, **twin) == "tensor_core_decode"
    assert tfa.dense_body(bf, i8, 8, 64, True, causal=False, lens=True, rows=8) == \
        "tensor_core_decode"
    for args in [(f32, bf, 128, 128, True),  # float32 q: the tensor cores would round
                 (bf, f32, 128, 128, True),
                 (bf, i8, 1, 128, True),  # a causal decode call
                 (bf, bf, 8, 128, True),
                 (bf, bf, 24, 128, True),
                 (bf, bf, 128, 16, True),  # a head dim the body is not built for
                 (bf, bf, 128, 128, False)]:  # unaligned operands
        assert tfa.dense_body(*args) == "cuda_core", args
    for args, kw in [((bf, i8, 1, 128, True), dict(twin, lens=False)),  # a static length
                     ((bf, bf, 1, 128, True), twin),  # bf16 K/V
                     ((f32, i8, 1, 128, True), twin),
                     ((bf, i8, 1, 16, True), twin),
                     ((bf, i8, 1, 128, False), twin),
                     ((bf, i8, 1, 128, True), dict(twin, rows=9))]:  # more than n8 rows
        assert tfa.dense_body(*args, **kw) == "cuda_core", (args, kw)


def test_paged_body_follows_the_arguments():
    bf, f32 = torch.bfloat16, torch.float32
    assert tfa.paged_body(bf, 128, 4, True) == "tensor_core_decode"
    assert tfa.paged_body(bf, 64, 8, True) == "tensor_core_decode"
    for args in [(f32, 128, 4, True), (bf, 16, 4, True), (bf, 128, 9, True),
                 (bf, 128, 4, False)]:
        assert tfa.paged_body(*args) == "cuda_core", args


def test_decode_launch_shape():
    """Splits of DECODE_SPLIT_KEYS positions whatever the batch; a workspace
    of one (m, l, o) partial per split, KV head and lane."""
    shape = tfa.decode_launch(4, 8, 4, 128, 17 * 16)
    assert shape == {"split_keys": 128, "splits": 3, "grid_blocks": 96, "combine_blocks": 32,
                     "workspace_bytes": 4 * 96 * (4 * 128 + 16)}
    assert tfa.decode_launch(64, 8, 4, 128, 4096)["splits"] == 32
    assert tfa.decode_launch(1, 1, 1, 64, 128)["splits"] == 1
    assert tfa.decode_launch(1, 1, 1, 64, 129)["splits"] == 2


# The split-KV decode body (csrc/attn_decode.cuh) on the tensor cores: bf16
# q.k products summed in float32, p * v_scale as a bf16 high and low part,
# splits of DECODE_SPLIT_KEYS positions merged in order. paged_decode_model is
# the plain model of that rounding; it must lie within DECODE_RTOL of
# max|ref| of the plain version and of the reference's Pallas kernel, the
# tolerance the card test holds the paged kernel to.
DECODE_RTOL = 1e-5

DECODE_CASES = {
    # name: (head_dim, page_size, lens): mid-page, on a split boundary, one
    # past it, a lane of length 0
    "d128": (128, 16, (37, 128, 129, 0)),
    "d64": (64, 8, (5, 129, 128, 0)),
}


def _decode_inputs(case):
    d, ps, lens = DECODE_CASES[case]
    rng = np.random.default_rng(d + ps)
    q, kq, vq, ks, vs, tables, lens = _paged_inputs(rng, b=len(lens), hq=8, hkv=2, d=d, ps=ps,
                                                   p=-(-max(lens) // ps) + 1, lens=lens)
    return q, kq, vq, ks, vs, tables, lens


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_decode_model_within_tolerance_of_plain_and_reference(case):
    q, kq, vq, ks, vs, tables, lens = _decode_inputs(case)
    targs = [_to_t(q, "bf16")] + [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs, tables, lens)]
    assert tfa.paged_body(targs[0].dtype, q.shape[-1], 4, True) == "tensor_core_decode"
    model = tfa.paged_decode_model(*targs)
    plain = tfa.paged_flash_attention_plain(*targs, out_dtype=torch.float32)
    want = np.asarray(jpaged(jnp.asarray(q, jnp.bfloat16),
                             *(jnp.asarray(a) for a in (kq, vq, ks, vs, tables, lens)),
                             out_dtype=jnp.float32, interpret=True))
    for ref, what in ((t2n(plain), "plain"), (want, "reference kernel")):
        err = float(np.abs(t2n(model) - ref).max())
        print(f"{case}: model vs {what}: {err / float(np.abs(ref).max()):.3g} of max|ref|")
        assert err <= DECODE_RTOL * float(np.abs(ref).max()), (what, err)
    assert not torch.any(model[3]), "a lane of length 0 gives 0"
    # the model rounds differently from the plain version (it is a model)
    assert not torch.equal(model, plain)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_decode_model_equals_its_dense_twin_on_gathered_pools(case):
    """The dense decode call runs the same body through a dense addressing,
    so its model on the gathered pools gives the same bits on every lane of
    length >= 1; a lane of length 0 is the dense plain version's equal
    weights over every position (finite), where the paged call gives 0."""
    q, kq, vq, ks, vs, tables, lens = _decode_inputs(case)
    qt = _to_t(q, "bf16")
    paged = tfa.paged_decode_model(qt, *(torch.from_numpy(a.copy())
                                         for a in (kq, vq, ks, vs, tables, lens)))
    g = lambda a, sc=False: torch.from_numpy(_gathered(a, tables, sc).copy())  # noqa: E731
    kw = dict(kv_lens=torch.from_numpy(lens), k_scale=g(ks, True), v_scale=g(vs, True))
    dense = tfa.dense_decode_model(qt, g(kq), g(vq), **kw)
    live = torch.from_numpy(lens > 0)
    assert torch.equal(paged[live], dense[live])
    assert bool(torch.isfinite(dense).all()) and bool(dense[~live].abs().sum() > 0)
    plain = tfa.flash_attention_plain(qt, g(kq), g(vq), causal=False, block_q=1,
                                      block_k=kq.shape[1], out_dtype=torch.float32, **kw)
    assert float((dense - plain).abs().max()) <= DECODE_RTOL * float(plain.abs().max())


def _mma_m16n8k16(a, b):
    """mma.sync.m16n8k16 on a warp's fragments: a[lane] four (lo, hi)
    register pairs of A (16 x 16, row), b[lane] two of B (16 x 8, col);
    returns each lane's four accumulators of A @ B."""
    am, bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, qd = lane >> 2, lane & 3
        for reg, (r, c) in enumerate(((g, 2 * qd), (g + 8, 2 * qd), (g, 2 * qd + 8),
                                      (g + 8, 2 * qd + 8))):
            am[r, c:c + 2] = a[lane][reg]
        bm[2 * qd:2 * qd + 2, g], bm[2 * qd + 8:2 * qd + 10, g] = b[lane]
    cm = am @ bm
    return [[cm[(l >> 2) + 8 * (e >> 1), 2 * (l & 3) + (e & 1)] for e in range(4)]
            for l in range(32)]


@pytest.mark.parametrize("d", tfa.MMA_HEAD_DIMS)
def test_decode_fragment_maps_replayed(d):
    """The decode body's index maps, replayed lane by lane in numpy: the
    swizzled stage rows, the permuted head dim of the K and V fragments, the
    Q fragments and the shuffles that turn S^T's accumulators into P^T's B
    fragments give S^T = K . Q^T and O^T = V^T . P^T for every warp tile;
    at D = 128 each 16-byte fragment read of a quarter warp hits 32
    distinct banks."""
    rng = np.random.default_rng(d)
    stage = tfa.DECODE_STAGE_KEYS
    k, v = (rng.integers(-128, 128, (stage, d)) for _ in range(2))
    qm, pm = rng.standard_normal((8, d)), rng.standard_normal((16, 8))

    def at(r, c):  # csrc/attn_decode.cuh chunk_at
        return (c ^ (r & (d // 16 - 1))) << 4

    sk, sv = np.zeros((stage, d)), np.zeros((stage, d))
    for r in range(stage):
        for c in range(d // 16):
            sk[r, at(r, c):at(r, c) + 16] = k[r, 16 * c:16 * c + 16]
            sv[r, at(r, c):at(r, c) + 16] = v[r, 16 * c:16 * c + 16]
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for w in range(tfa.DECODE_WARPS):
        tr = w * tfa.DECODE_TILE_KEYS
        reads = []  # (which read, lane, byte address)
        kw = []
        for lane, (g, qd) in enumerate(lanes):
            words = []
            for h in range(2):
                r = tr + g + 8 * h
                row = []
                for j in range(d // 64):
                    a = at(r, qd * (d // 64) + j)
                    reads.append((("k", h, j), lane, r * d + a))
                    row += [sk[r, a + 4 * i:a + 4 * i + 4] for i in range(4)]
                words.append(row)
            kw.append(words)
        qb = [[qm[g, qd * d // 4 + 2 * i:qd * d // 4 + 2 * i + 2] for i in range(d // 8)]
              for g, qd in lanes]
        s = np.zeros((32, 4))
        for kk in range(d // 16):
            s += _mma_m16n8k16([[kw[l][0][kk][:2], kw[l][1][kk][:2], kw[l][0][kk][2:],
                                 kw[l][1][kk][2:]] for l in range(32)],
                               [(qb[l][2 * kk], qb[l][2 * kk + 1]) for l in range(32)])
        for lane, (g, qd) in enumerate(lanes):
            for e in range(4):
                want = k[tr + g + 8 * (e >> 1)] @ qm[2 * qd + (e & 1)]
                assert abs(s[lane][e] - want) < 1e-9
        hl = [[pm[g + 8 * (e >> 1), 2 * qd + (e & 1)] for e in range(4)] for g, qd in lanes]
        pb = []
        for g, qd in lanes:
            x0, x1 = hl[8 * qd + (g >> 1)], hl[8 * qd + (g >> 1) + 4]
            odd = g & 1
            pb.append((np.array([x0[odd], x1[odd]]), np.array([x0[2 + odd], x1[2 + odd]])))
        vw = []
        for lane, (g, qd) in enumerate(lanes):
            rows = []
            for h in range(4):
                r = tr + 2 * qd + (h & 1) + 8 * (h >> 1)
                a = at(r, g * d // 8 >> 4) + (g * d // 8 & 15)
                reads.append((("v", h), lane, r * d + a))
                rows.append([sv[r, a + 4 * i:a + 4 * i + 4] for i in range(d // 32)])
            vw.append(rows)
        for mt in range(d // 16):
            wi, lo = mt >> 1, 2 * (mt & 1)
            o = _mma_m16n8k16(
                [[np.array([x[0][wi][lo], x[1][wi][lo]]), np.array([x[0][wi][lo + 1], x[1][wi][lo + 1]]),
                  np.array([x[2][wi][lo], x[3][wi][lo]]), np.array([x[2][wi][lo + 1], x[3][wi][lo + 1]])]
                 for x in vw], pb)
            for lane, (g, qd) in enumerate(lanes):
                for e in range(4):
                    dd = g * d // 8 + 2 * mt + (e >> 1)
                    assert abs(o[lane][e] - v[tr:tr + 16, dd] @ pm[:, 2 * qd + (e & 1)]) < 1e-9
        if d == 128:  # every read is 16 bytes: a quarter warp covers the 32 banks once
            for which in {r[0] for r in reads}:
                addr = [a for key, _, a in sorted(reads, key=lambda x: x[1]) if key == which]
                for qtr in range(4):
                    banks = {(a // 4 + i) % 32 for a in addr[8 * qtr:8 * qtr + 8] for i in range(4)}
                    assert len(banks) == 32, (which, qtr)
