"""Plain PyTorch oracles: the plane-pair contraction (the reference every
plane kernel is held against) and naive softmax attention.

The products are taken by a floating-point matmul of the integer planes
and are exact: the dtype is chosen from the operands' value bound (float32
while ``K * max|a| * max|w| < 2^24`` — bit planes in {-1,0,1} up to 16M
deep — else float64, e.g. radix-256 digits whose products reach 2^14 per
term). A float32 matmul on the card must not round its inputs to TF32;
:func:`_exact_matmul` turns TF32 off around the call and restores the
setting. The int32 pair weighting then wraps exactly as the kernels do.
"""

from __future__ import annotations

import torch


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32 and a.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return a @ b


def _float_dtype(k: int, a: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    bound = k * int(a.abs().amax()) * int(w.abs().amax()) if a.numel() and w.numel() else 0
    return torch.float32 if bound < (1 << 24) else torch.float64


def plane_matmul_ref(
    a_planes: torch.Tensor, w_planes: torch.Tensor, pair_weights: torch.Tensor
) -> torch.Tensor:
    """sum_{i,j} pw[i*P_w+j] * (a_planes[i] @ w_planes[j]), int32 exact.

    ``a_planes`` (P_a, M, K), ``w_planes`` (P_w, K, N) integer; returns
    (M, N) int32. Weight planes are converted one at a time to bound the
    float working set at full model widths."""
    n_a, m, k = a_planes.shape
    n_w, k2, n = w_planes.shape
    if k != k2:
        raise ValueError(f"K mismatch {tuple(a_planes.shape)} vs {tuple(w_planes.shape)}")
    if pair_weights.shape != (n_a * n_w,):
        raise ValueError("pair_weights must have shape (P_a * P_w,)")
    dt = _float_dtype(k, a_planes, w_planes)
    a = a_planes.to(dt).reshape(n_a * m, k)
    pw = pair_weights.to(torch.int32).reshape(n_a, n_w)
    acc = torch.zeros((m, n), dtype=torch.int32, device=a_planes.device)
    for j in range(n_w):
        prods = _exact_matmul(a, w_planes[j].to(dt)).to(torch.int32).reshape(n_a, m, n)
        for i in range(n_a):
            acc += pw[i, j] * prods[i]
    return acc


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    kv_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Naive softmax attention with GQA broadcast. q: (B,Hq,Sq,D);
    k, v: (B,Hkv,Sk,D). ``kv_lens``: optional (B,) per-sequence valid KV
    lengths. The causal mask is aligned to the bottom right (query ``i``
    sees keys ``<= i + Sk - Sq``), as the reference's oracle aligns it;
    the flash kernels align theirs to the top left, and the two agree
    only when Sq == Sk."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d**-0.5
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = _exact_matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s * sm_scale
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, neg)
    if kv_lens is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
        s = torch.where(valid[:, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    out = _exact_matmul(p, v.to(torch.float32))
    return out.to(q.dtype)
