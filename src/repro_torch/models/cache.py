"""Decode-state (KV / SSM / RG-LRU) cache, slot-indexed.

The cache is ``{"step": (B,) int32, "layers": [per-layer dict]}``, one
block per layer in layer order (the reference stacks the blocks of its
scanned periods and keeps a tail; a sum or a lane select does not see
the difference): KV for a full-attention layer, a KV ring of
``min(window, max_len)`` rows for a sliding-window one, and float32
recurrent state (``conv`` rows plus ``state`` or ``h``) for an SSM or
RG-LRU layer. The
leading axis of every leaf is a **slot** for the continuous-batching
engine, each with its own length. :func:`insert_slot` writes a batch-1
prefill cache into one slot, overwriting the slot's whole extent (so
eviction is host bookkeeping only); it updates the slot cache in place,
which saves a copy of the whole cache per admission.

With ``kv_quant=True`` KV is stored int8 with per-(position, head) float32
scales (``k_q``/``k_scale``/``v_q``/``v_scale``). The paged layout
(``models.paging``) keeps the same ``{"step", "layers"}`` frame and leaf
names, with page pools and a block table per layer in place of the dense
extents; :func:`cache_kv_bytes` counts its pools.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

KV_SCALE_EPS = 1e-8
KV_QMAX = 127.0
# float32(1/127), a 0-dim host tensor (a scalar operand on any device),
# built once: never written
_KV_RECIP = torch.tensor(1.0 / KV_QMAX, dtype=torch.float32)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the trailing (head_dim) axis:
    x (..., D) -> (int8 (..., D), float32 scales (...,)). The scale is
    ``amax * float32(1/127)``: the reference quantizes KV only inside its
    compiled steps, where XLA turns the division by the constant into
    that multiply."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, KV_SCALE_EPS) * _KV_RECIP
    q = torch.clamp(torch.round(xf / scale[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the attention paths fold the scale
    into scores and probabilities instead of materializing this)."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _attn_cache(cfg: ModelConfig, batch: int, max_len: int, window: int, dtype,
                kv_quant: bool, device):
    """A layer's KV: ``max_len`` rows, or for a sliding window a ring of
    ``min(window, max_len)`` rows."""
    s = min(window, max_len) if window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if kv_quant:
        cache.update(
            k_q=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_q=torch.zeros(shape, dtype=torch.int8, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    else:
        cache.update(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )
    return cache


def _ssm_cache(cfg: ModelConfig, batch: int, device):
    """A Mamba2 layer's state: the conv's last ``W - 1`` inputs and the
    ``(H, P, N)`` SSD state, both float32."""
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=f32, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=f32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _rec_cache(cfg: ModelConfig, batch: int, device):
    """An RG-LRU layer's state: the conv rows and ``h``, float32."""
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width), dtype=f32,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=f32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                 kv_quant: bool, device):
    if kind in ("dense", "moe"):
        return _attn_cache(cfg, batch, max_len, 0, dtype, kv_quant, device)
    if kind == "attn":  # the hybrid's local attention: a ring
        return _attn_cache(cfg, batch, max_len, cfg.local_window, dtype, kv_quant, device)
    if kind == "ssm":
        return _ssm_cache(cfg, batch, device)
    if kind == "rec":
        return _rec_cache(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               kv_quant: bool = False, device=None):
    """The decode cache: ``batch`` slots, one block per layer (KV of
    ``max_len`` positions for a dense, MoE or VLM layer, a KV ring, or
    recurrent state). An encoder has no cache."""
    if not cfg.is_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode cache")
    return {
        "step": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [
            _block_cache(cfg, kind, batch, max_len, dtype, kv_quant, device)
            for kind in cfg.layer_kinds()
        ],
    }


def insert_slot(cache, seq_cache, slot: int):
    """Write the batch-1 ``seq_cache`` into slot ``slot`` of ``cache`` (in
    place; returns ``cache``). Both come from the same ``init_cache``
    configuration, so leaves match one for one; every leaf of the slot's
    extent is overwritten, which makes readmission leak-free."""
    if len(cache["layers"]) != len(seq_cache["layers"]):
        raise ValueError("insert_slot: caches have different layer counts")
    for blk, sblk in zip(cache["layers"], seq_cache["layers"]):
        if set(blk) != set(sblk):
            raise ValueError(
                f"insert_slot: leaf sets differ ({sorted(blk)} vs {sorted(sblk)}) "
                "— both caches must use the same kv_quant"
            )
        for key, leaf in blk.items():
            src = sblk[key][0]
            if src.shape != leaf.shape[1:]:
                raise ValueError(
                    f"insert_slot: leaf {key} has seq-cache shape {tuple(src.shape)}, "
                    f"slot-cache shape {tuple(leaf.shape[1:])} (check max_len)"
                )
            leaf[slot] = src.to(leaf.dtype)
    cache["step"][slot] = seq_cache["step"][0]
    return cache


def _mask(take, dev) -> torch.Tensor:
    if isinstance(take, torch.Tensor):
        return take.to(device=dev, dtype=torch.bool)
    return torch.as_tensor(np.asarray(take, bool), device=dev)


def _select(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor, out):
    """``where(mask, b, a)`` with ``mask`` along the leading axis, into
    ``out`` when given (in place: no new tensor)."""
    m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
    if out is None:
        return torch.where(m, b, a)
    return torch.where(m, b, a, out=out)


def select_slots(cache_a, cache_b, take_b, out=None):
    """Per-slot merge of two same-layout caches: slot ``i`` of the result
    comes from ``cache_b`` where ``take_b[i]`` else ``cache_a``.

    This is the mixed-tier decode combinator: the engine runs one decode
    pass per active precision tier from the same pre-step state and keeps
    each slot's post-step state from the pass of that slot's admission
    tier. Slot lanes are independent inside a step (per-row activation
    quantization, per-slot lengths), so the merge is a lane select along
    every leaf's leading (slot) axis. ``take_b``: an ``(n_slots,)`` bool
    vector (a device tensor, or host data). With ``out`` (a cache of the
    same layout, e.g. ``cache_a`` itself) the result is written into its
    leaves in place and ``out`` is returned."""
    mask = _mask(take_b, cache_a["step"].device)
    if out is None:
        return {
            "step": _select(cache_a["step"], cache_b["step"], mask, None),
            "layers": [
                {k: _select(ablk[k], bblk[k], mask, None) for k in ablk}
                for ablk, bblk in zip(cache_a["layers"], cache_b["layers"])
            ],
        }
    _select(cache_a["step"], cache_b["step"], mask, out["step"])
    for ablk, bblk, oblk in zip(cache_a["layers"], cache_b["layers"], out["layers"]):
        for k in ablk:
            _select(ablk[k], bblk[k], mask, oblk[k])
    return out


def quantize_scratch(scratch):
    """Quantize a raw (bf16) prefill cache into the int8 layout. Every
    prefill runs raw and quantizes here, after the fact, as the
    reference's does; recurrent blocks pass through."""
    layers = []
    for blk in scratch["layers"]:
        if "k" not in blk:
            layers.append(blk)
            continue
        kq, ks = quantize_kv(blk["k"])
        vq, vs = quantize_kv(blk["v"])
        layers.append({"len": blk["len"], "k_q": kq, "k_scale": ks, "v_q": vq, "v_scale": vs})
    return {"step": scratch["step"], "layers": layers}


_KV_LEAF_KEYS = frozenset({"k", "v", "k_q", "v_q", "k_scale", "v_scale"})


def cache_kv_bytes(cache) -> int:
    """Bytes of attention KV state (values + scales) held by ``cache``;
    recurrent state is not counted, as the reference does not count it."""
    return sum(
        leaf.numel() * leaf.element_size()
        for blk in cache["layers"]
        for key, leaf in blk.items()
        if key in _KV_LEAF_KEYS
    )


def cache_slot_checksums(cache) -> torch.Tensor:
    """Per-slot uint32 fold of the bytes of the whole decode cache (dense
    layout): ``(n_slots,)`` int64 holding uint32 values, on the cache's
    device. Entry ``i`` sums every byte of every leaf that belongs to slot
    ``i`` (the leading axis) modulo 2^32, so one flipped bit in slot ``i``'s
    KV, scales, recurrent state or lengths moves ``out[i]`` and only it — the reference's
    ``cache_slot_checksums``, value for value."""

    def fold(leaf: torch.Tensor) -> torch.Tensor:
        b = leaf.contiguous().view(torch.uint8)
        return b.reshape(leaf.shape[0], -1).sum(dim=1, dtype=torch.int64)

    total = fold(cache["step"])
    for blk in cache["layers"]:
        for leaf in blk.values():
            total = total + fold(leaf)
    return total & 0xFFFFFFFF
