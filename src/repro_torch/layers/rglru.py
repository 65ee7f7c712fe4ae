"""RecurrentGemma / Griffin recurrent block: causal conv + RG-LRU (the port
of ``src/repro/layers/rglru.py``).

The gated linear recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``
is associative, so prefill runs it as a log-depth scan; decode is one
step per token, updating the conv rows and ``h`` in place. The five
projections go through :mod:`repro_torch.layers.linear`; the recurrence
is elementwise float32, in plain PyTorch, inside the ``torch.profiler``
ranges ``family.conv`` and ``family.rglru``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels.plane_mm_fused import ACTIVATIONS
from repro_torch.layers.linear import linear_init, projection
from repro_torch.layers.ssm import _causal_conv, softplus

_C = 8.0  # RG-LRU temperature (Griffin)


def rglru_init(gen, d_model: int, lru_width: int, conv_width: int = 4,
               dtype=torch.bfloat16, device=None):
    """Random parameters with the reference's distributions."""
    lam = torch.linspace(0.9, 0.999, lru_width, dtype=torch.float64)
    return {
        "in_x": linear_init(gen, d_model, lru_width, dtype, device),
        "in_y": linear_init(gen, d_model, lru_width, dtype, device),
        "out": linear_init(gen, lru_width, d_model, dtype, device),
        "gate_a": linear_init(gen, lru_width, lru_width, dtype, device),
        "gate_x": linear_init(gen, lru_width, lru_width, dtype, device),
        "conv_w": torch.randn((conv_width, lru_width), generator=gen, dtype=torch.float32,
                              device=device) * 0.1,
        "conv_b": torch.zeros((lru_width,), dtype=torch.float32, device=device),
        # a = exp(-C * softplus(lam) * sigmoid(r)); a^C starts in ~[0.9, 0.999]
        "lam": torch.log(torch.expm1(lam)).to(torch.float32).to(device),
    }


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """Elements of ``even`` at even indices and of ``odd`` at odd ones."""
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.dim()
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = odd
    return out


def _sl(x: torch.Tensor, dim: int, start: int, stop, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """The inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along ``dim``,
    combined in the tree order of ``lax.associative_scan`` (pairs, a
    recursive scan of the pair results, then the even positions), so each
    state is computed as the reference computes it. Returns the scanned
    ``(a, h)``; the depth is log2 of the length, with no loop over
    positions."""

    def comb(lhs, rhs):
        a1, b1 = lhs
        a2, b2 = rhs
        return a1 * a2, torch.addcmul(b2, a2, b1)  # an FMA, as XLA contracts it

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = comb([_sl(e, dim, 0, n - 1, 2) for e in elems],
                       [_sl(e, dim, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = comb([_sl(e, dim, 0, e.shape[dim] - 1) for e in odd],
                        [_sl(e, dim, 2, None, 2) for e in elems])
        else:
            even = comb(odd, [_sl(e, dim, 2, None, 2) for e in elems])
        even = [torch.cat([_sl(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    return tuple(scan([a, b]))


def rglru_apply(
    params,
    x: torch.Tensor,
    *,
    lru_width: int,
    conv_width: int = 4,
    policy,
    training: bool = False,
    backend: str = "auto",
    name: str = "rglru",
    cache=None,
):
    """x: (B, S, d). Returns (out, new_cache ``{'conv','h','len'}``). One
    token per slot with a cache decodes, updating ``cache`` in place and
    returning it; several tokens prefill from a zero state into a new
    cache."""
    la = projection(policy=policy, training=training, backend=backend)
    f32 = torch.float32
    # gelu (tanh form) on the projection's bf16 output, outside its epilogue
    y_branch = ACTIVATIONS["gelu"](la(params["in_y"], x, name=f"{name}/in_y").to(f32))
    xb = la(params["in_x"], x, name=f"{name}/in_x")

    decode = cache is not None and x.shape[1] == 1
    with record_function("family.conv"):
        xc, new_conv = _causal_conv(
            xb.to(f32), params["conv_w"], params["conv_b"],
            None if cache is None else cache["conv"],
            cache_out=cache["conv"] if decode else None,
        )
    xc = xc.to(x.dtype)

    r = torch.sigmoid(la(params["gate_a"], xc, name=f"{name}/gate_a").to(f32))
    i = torch.sigmoid(la(params["gate_x"], xc, name=f"{name}/gate_x").to(f32))
    with record_function("family.rglru"):
        hs, new_cache = _recurrence(params, r, i, xc, cache, new_conv, decode)
    out = (hs * y_branch).to(x.dtype)
    return la(params["out"], out, name=f"{name}/out"), new_cache


def _recurrence(params, r, i, xc, cache, new_conv, decode):
    """The RG-LRU over a prefill (the scan), or one decode step on
    ``cache`` (in place); returns (h at every position, new cache)."""
    f32 = torch.float32
    log_a = -_C * softplus(params["lam"]) * r  # (B,S,W) <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xc.to(f32))

    if decode:
        h = cache["h"]
        h.copy_(torch.addcmul(gated_x[:, 0], a[:, 0], h))
        hs = h[:, None]
        cache["len"].add_(1)
        new_cache = cache
    else:
        _, hs = linear_scan(a, gated_x, dim=1)
        new_cache = None
        if cache is not None:
            new_cache = {
                "conv": new_conv,
                "h": hs[:, -1].contiguous(),
                "len": torch.full((xc.shape[0],), xc.shape[1], dtype=torch.int32,
                                  device=xc.device),
            }
    return hs, new_cache
