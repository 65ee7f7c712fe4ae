"""Mamba2 SSD (state-space duality) block (the port of
``src/repro/layers/ssm.py``).

The chunked SSD algorithm turns the selective-state recurrence into small
matmuls: an intra-chunk product under a decay mask, chunk-final states,
a short recurrence over those states and a cross-chunk term. The in and
out projections go through :mod:`repro_torch.layers.linear` (the
bit-serial plans); the conv, the SSD scan and the recurrent state stay in
float32, as the reference keeps them, in plain PyTorch.

Decode is one recurrent step per token. It updates the cache in place —
the conv rows and the ``(B, H, P, N)`` float32 state — so a captured
decode step leaves its results in the buffers it reads.

The conv and the SSD (or the recurrent step) run inside ``torch.profiler``
ranges, ``family.conv`` and ``family.ssd``, so a profile attributes their
device time (free when no profiler runs).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.layers.linear import linear_init, projection


def ssm_init(gen, d_model: int, *, d_inner: int, n_heads: int, head_dim: int, d_state: int,
             conv_width: int = 4, dtype=torch.bfloat16, device=None):
    """Random parameters with the reference's distributions."""
    conv_dim = d_inner + 2 * d_state
    d_out = d_inner + conv_dim + n_heads  # in_proj emits [z, x, B, C, dt] fused

    def uniform(lo, hi, n):
        u = torch.rand((n,), generator=gen, dtype=torch.float32, device=device)
        return lo + (hi - lo) * u

    return {
        "in_proj": linear_init(gen, d_model, d_out, dtype, device),
        "out_proj": linear_init(gen, d_inner, d_model, dtype, device),
        "conv_w": torch.randn((conv_width, conv_dim), generator=gen, dtype=torch.float32,
                              device=device) * 0.1,
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=device),
        "A_log": torch.log(uniform(1.0, 16.0, n_heads)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.exp(uniform(1e-3, 1e-1, n_heads)) - 1.0),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _causal_conv(x, w, b, cache=None, cache_out=None):
    """Depthwise causal conv. x: (B, L, C) float32; w: (W, C). Returns
    ``(y, new_cache)``, the cache holding the last ``W - 1`` inputs.
    ``cache_out``: write the new cache into this tensor (the decode step's
    in-place update) and return it."""
    width = w.shape[0]
    if cache is None:
        ctx = torch.cat([x.new_zeros((x.shape[0], width - 1, x.shape[2])), x], dim=1)
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    length = x.shape[1]
    # tap 0's product fused into tap 1's, then one multiply-add per tap:
    # the FMAs the reference's compiled graph contracts, in its order
    y = ctx[:, 0:length, :] * w[0]
    if width > 1:
        y = torch.addcmul(ctx[:, 1:1 + length, :] * w[1], ctx[:, 0:length, :], w[0])
    for i in range(2, width):
        y = torch.addcmul(y, ctx[:, i:i + length, :], w[i])
    tail = ctx[:, ctx.shape[1] - (width - 1):, :]
    if cache_out is not None:
        cache_out.copy_(tail)
        return y + b, cache_out
    # a copy: a view of one row's tail would keep the whole (L + W - 1) x C
    # input alive in the cache
    return y + b, tail.to(torch.float32).clone()


def _segsum_decay(da):
    """``L[..., i, j] = exp(cum_i - cum_j)`` for ``i >= j``, else 0.
    da: (..., q); returns (..., q, q)."""
    q = da.shape[-1]
    cum = torch.cumsum(da, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=da.device))
    return torch.where(mask, torch.exp(diff), torch.zeros_like(diff))


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int):
    """Chunked SSD scan. x: (B,L,H,P); dt: (B,L,H); a: (H,) (negative);
    b_mat, c_mat: (B,L,N). Returns y (B,L,H,P) float32 and the final
    state (B,H,P,N). The contractions are two-operand einsums, as the
    reference factors them. The length must be a multiple of
    ``min(chunk, L)`` (the reference asserts it)."""
    bsz, length, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, length)
    if length % q:
        raise ValueError(f"seq {length} must divide chunk {q}")
    c_ = length // q
    f32 = torch.float32
    xr = x.reshape(bsz, c_, q, h, p).to(f32)
    dtr = dt.reshape(bsz, c_, q, h).to(f32)
    br = b_mat.reshape(bsz, c_, q, n).to(f32)
    cr = c_mat.reshape(bsz, c_, q, n).to(f32)

    da = dtr * a  # (B,C,Q,H)
    da_h = da.movedim(-1, -2)  # (B,C,H,Q)
    cum = torch.cumsum(da_h, dim=-1)
    big_l = _segsum_decay(da_h)  # (B,C,H,Q,Q)

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) L_ij dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)
    scaled_x = dtr[..., None] * xr  # (B,C,Q,H,P)
    lw = cb[:, :, None] * big_l  # (B,C,H,Q,Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", lw, scaled_x)

    # chunk-final states: s_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_states = torch.exp(cum[..., -1:] - cum)  # (B,C,H,Q)
    xw = decay_states[..., None] * scaled_x.movedim(2, 3)  # (B,C,H,Q,P)
    states = torch.einsum("bchjp,bcjn->bchpn", xw, br)

    # the recurrence over chunk states, from a zero state
    chunk_decay = torch.exp(cum[..., -1])  # (B,C,H)
    s_prev = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    s_in = []
    for c in range(c_):
        s_in.append(s_prev)  # the state entering chunk c
        s_prev = torch.addcmul(states[:, c], chunk_decay[:, c, :, None, None], s_prev)
    s_in = torch.stack(s_in, dim=1)  # (B,C,H,P,N)

    # cross-chunk: y_i += C_i . (exp(cum_i) s_in)
    cs = torch.einsum("bcin,bchpn->bcihp", cr, s_in)
    y_off = cs * torch.exp(cum).movedim(2, 3)[..., None]  # (B,C,Q,H,1)
    y = (y_diag + y_off).reshape(bsz, length, h, p)
    return y, s_prev


def ssm_apply(
    params,
    x: torch.Tensor,
    *,
    d_inner: int,
    n_heads: int,
    head_dim: int,
    d_state: int,
    conv_width: int = 4,
    chunk: int = 256,
    policy,
    training: bool = False,
    backend: str = "auto",
    name: str = "ssm",
    cache=None,
):
    """x: (B, S, d_model). Returns (out, new_cache). ``cache``:
    ``{'conv' (B, W-1, C), 'state' (B, H, P, N), 'len'}``, all but ``len``
    float32. One token per slot with a cache decodes, updating ``cache``
    in place and returning it; several tokens prefill from a zero state
    and return a new cache."""
    bsz, s, _ = x.shape
    la = projection(policy=policy, training=training, backend=backend)
    conv_dim = d_inner + 2 * d_state

    zxbcdt = la(params["in_proj"], x, name=f"{name}/in_proj")
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (B,S,H)
    a = -torch.exp(params["A_log"])  # (H,) negative

    decode = cache is not None and s == 1
    with record_function("family.conv"):
        xbc, new_conv = _causal_conv(
            xbc.to(torch.float32), params["conv_w"], params["conv_b"],
            None if cache is None else cache["conv"],
            cache_out=cache["conv"] if decode else None,
        )
    xbc = silu(xbc)
    xs = xbc[..., :d_inner]
    b_mat = xbc[..., d_inner:d_inner + d_state]
    c_mat = xbc[..., d_inner + d_state:]
    xh = xs.reshape(bsz, s, n_heads, head_dim)

    with record_function("family.ssd"):
        y, new_cache = _ssd_or_step(params, xh, dt, a, b_mat, c_mat, chunk, cache, new_conv,
                                    decode)
    y = y.reshape(bsz, s, d_inner)
    y = y * silu(z.to(torch.float32))
    return la(params["out_proj"], y.to(x.dtype), name=f"{name}/out_proj"), new_cache


def _ssd_or_step(params, xh, dt, a, b_mat, c_mat, chunk, cache, new_conv, decode):
    """The SSD over a prefill, or one recurrent decode step on ``cache``
    (in place); returns (y (B,S,H,P) float32, new cache)."""
    bsz, s = xh.shape[:2]
    if decode:  # one recurrent step, in place
        state = cache["state"]  # (B,H,P,N)
        da = dt[:, 0] * a  # (B,H)
        dbx = (dt[:, 0][:, :, None, None] * b_mat[:, 0][:, None, None, :]) \
            * xh[:, 0][:, :, :, None]
        state.copy_(torch.addcmul(dbx, torch.exp(da)[..., None, None], state))
        y = torch.einsum("bn,bhpn->bhp", c_mat[:, 0], state)
        y = torch.addcmul(y, params["D"][:, None], xh[:, 0])
        y = y[:, None]  # (B,1,H,P)
        cache["len"].add_(1)
        new_cache = cache
    else:
        y, final_state = ssd_chunked(xh, dt, a, b_mat, c_mat, chunk)
        y = torch.addcmul(y, params["D"][None, None, :, None], xh)
        new_cache = None
        if cache is not None:  # prefill fills the recurrent state
            new_cache = {
                "conv": new_conv,
                "state": final_state,
                "len": torch.full((bsz,), s, dtype=torch.int32, device=xh.device),
            }
    return y, new_cache
