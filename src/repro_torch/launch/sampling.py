"""Token sampling for the serving engine.

``greedy`` is the deterministic default; :func:`sample_tokens` adds
per-row temperatures (Gumbel-max) — rows with temperature 0 take the
exact greedy argmax, so a greedy request is bit-identical whether or not
it shares a batch with sampled ones. The noise comes from a
``torch.Generator``; it cannot reproduce the reference's PRNG stream, so
only temperature-0 rows are comparable across the two packages.
"""

from __future__ import annotations

from typing import Optional

import torch


def mask_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-inf the padded-vocab columns so no sampler can pick them."""
    if logits.shape[-1] == vocab_size:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab_size, logits, torch.full_like(logits, float("-inf")))


def greedy(logits: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Argmax (first maximal index). logits (B, V) -> (B,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(
    logits: torch.Tensor, temps: torch.Tensor, gen: Optional[torch.Generator]
) -> torch.Tensor:
    """Per-row temperature sampling via the Gumbel-max trick; rows with
    ``temp == 0`` are exactly greedy (no noise enters them). The greedy and
    the sampled token are both computed and selected per row, as the
    reference's traced step does: no branch on ``temps``' values, so the
    step reads nothing back and replays from a CUDA graph."""
    greedy_tok = greedy(logits)
    lf = logits.to(torch.float32)
    u = torch.rand(lf.shape, generator=gen, dtype=torch.float32, device=lf.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny, max=1.0 - 2**-24)))
    t = torch.clamp_min(temps[:, None].to(torch.float32), 1e-6)
    sampled = torch.argmax(lf / t + g, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy_tok)


def make_sample_fn(temperature: float = 0.0):
    """A uniform-temperature ``sample_fn(logits, gen)`` for the lockstep
    engine's hook: greedy at temperature 0."""
    if temperature <= 0.0:
        return greedy

    def sample(logits, gen=None):
        temps = torch.full((logits.shape[0],), temperature, dtype=torch.float32,
                           device=logits.device)
        return sample_tokens(logits, temps, gen)

    return sample
