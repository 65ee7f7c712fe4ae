"""Serving step functions: prefill and the continuous-batching decode step.

The factories take an optional ``precision=(a_bits, w_bits)`` runtime
dial: the policy is re-stamped with
:meth:`PrecisionPolicy.with_runtime_bits`, so every projection resolves
its plan at the dialed width (weight planes by MSB-prefix truncation of
the stored decomposition, activations quantized at the lower width).
Steps run eagerly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.launch import sampling
from repro_torch.models.cache import init_cache, quantize_scratch
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward


def _dial(policy, precision: Optional[Tuple[int, int]]):
    if precision is None or policy is None:
        return policy
    return policy.with_runtime_bits(*precision)


def make_prefill_step(
    cfg: ModelConfig,
    policy=None,
    max_len: Optional[int] = None,
    kv_quant: bool = False,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
):
    """prefill_step(params, tokens (B, S)) -> (last_logits (B, V), cache).

    The forward runs against a **raw** bf16 scratch of ``max_len``
    positions (attention over the whole extent under a length mask) and,
    with ``kv_quant``, quantizes it once at the end — the reference's
    schedule, so prefill logits and committed KV match it."""
    policy = _dial(policy, precision)

    def prefill_step(params, tokens):
        bsz, s = tokens.shape
        cache = init_cache(
            cfg, bsz, max_len or s, cfg.dtype, kv_quant=False, device=tokens.device
        )
        with torch.no_grad():
            logits, _aux, cache = forward(
                cfg, params, {"tokens": tokens}, policy=policy, cache=cache,
                last_only=True, backend=backend,
            )
        if kv_quant:
            cache = quantize_scratch(cache)
        return logits[:, -1, :], cache

    return prefill_step


def make_cb_decode_step(
    cfg: ModelConfig,
    policy=None,
    precision: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
):
    """One continuous-batching iteration over the whole slot array:
    cb_step(params, cache, tokens (B, 1), temps (B,), gen) ->
    (next_tokens (B, 1), cache). Every slot decodes one token at its own
    length; free slots compute too (their lanes are never read)."""
    policy = _dial(policy, precision)

    def cb_step(params, cache, tokens, temps, gen=None):
        with torch.no_grad():
            logits, _aux, cache = forward(
                cfg, params, {"tokens": tokens}, policy=policy, cache=cache,
                backend=backend,
            )
        logits = sampling.mask_vocab(logits[:, -1, :], cfg.vocab_size)
        next_tok = sampling.sample_tokens(logits, temps, gen)[:, None]
        return next_tok, cache

    return cb_step
