"""Corrupted packed words for the port's kernel tests (PyTorch only, so the
card's tests can use it without JAX)."""

import dataclasses

import torch


def corrupt_words(packed, gen: torch.Generator):
    """Flip one magnitude bit; on ternary words also set a sign bit whose
    magnitude bit is clear (plane value -2, which no valid pack holds)."""
    def pick(n):
        return int(torch.randint(n, (1,), generator=gen, device=gen.device))

    mag = packed.mag.clone().reshape(-1)
    mag[pick(mag.numel())] ^= 1 << pick(31)
    sign = packed.sign
    if sign is not None:
        sign = sign.clone().reshape(-1)
        j, bit = pick(mag.numel()), 1 << pick(31)
        mag[j] &= ~bit
        sign[j] |= bit
        sign = sign.reshape(packed.sign.shape)
    return dataclasses.replace(packed, mag=mag.reshape(packed.mag.shape), sign=sign)
