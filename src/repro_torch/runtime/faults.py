"""Seeded SEU fault injection for the serving integrity layer (the port of
``src/repro/runtime/faults.py``).

A :class:`FaultInjector` flips single bits, at seed-fixed sites and engine
iterations, in

* packed plane words / sign words (``planes`` / ``sign``),
* occupancy bitmaps (``occupancy``) and column checksums (``checksum``),
* epilogue weight scales (``scale``),
* int8 KV values (``kv``) and KV scales (``kv_scale``).

The engine plugs it in through ``serve.py --inject-faults SPEC``. Spec
grammar (comma-separated shots, optional seed)::

    SPEC  := SHOT ("," SHOT)* [";seed=" INT]
    SHOT  := SITE "@" STEP ["x" COUNT]

e.g. ``"planes@2,kv@5x2;seed=7"``: one plane-word flip before engine
iteration 2 and two KV flips before iteration 5, the RNG seeded with 7.

The candidate walk and the ``np.random.default_rng(seed)`` draws are the
reference's, so on the same tree the same leaf, byte and bit are hit. The
flip itself is made **in place**, on the leaf's own storage (a ``uint8``
view of the contiguous tensor and one indexed ``^=``): a captured CUDA
graph and the fold kernel's segment table hold the leaves' addresses, and
an upset in device memory changes bytes, not addresses. :meth:`FaultInjector.apply`
therefore returns the ``(params, cache)`` objects it was given. Every flip
is recorded as a :class:`FaultEvent`, so a harness can gate on 100%
detection.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import bitplanes as bp

FAULT_SITES = (
    "planes", "sign", "occupancy", "checksum", "scale", "kv", "kv_scale",
)

#: site -> PackedPlanes field holding the target words
_PACKED_FIELD = {"sign": "sign", "occupancy": "occupancy", "checksum": "checksum"}

_KV_KEYS = {
    "kv": ("k_q", "v_q", "k", "v"),
    "kv_scale": ("k_scale", "v_scale"),
}


@dataclasses.dataclass
class FaultEvent:
    """One injected single-bit flip (``category``: 'params' or 'kv')."""

    site: str
    step: int
    leaf: str  # path of the tensor hit
    byte: int  # flat byte index within the tensor
    bit: int  # bit within the byte
    category: str
    detected: bool = False


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed injection schedule: ``shots`` is a tuple of
    ``(site, step, count)``."""

    shots: tuple
    seed: int = 0

    @staticmethod
    def parse(spec: str) -> "FaultSpec":
        s = spec.strip()
        seed = 0
        if ";" in s:
            s, _, tail = s.partition(";")
            tail = tail.strip()
            if not tail.startswith("seed="):
                raise ValueError(f"bad fault spec tail {tail!r}: expected ';seed=N'")
            seed = int(tail[len("seed="):])
        shots = []
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            site, sep, at = part.partition("@")
            if not sep:
                raise ValueError(f"bad fault shot {part!r}: expected 'site@step[xN]'")
            site = site.strip()
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}; valid sites: {FAULT_SITES}")
            count = 1
            if "x" in at:
                at, _, c = at.partition("x")
                count = int(c)
            if count < 1:
                raise ValueError(f"fault count must be >= 1, got {count}")
            shots.append((site, int(at), count))
        if not shots:
            raise ValueError(f"empty fault spec {spec!r}")
        return FaultSpec(tuple(shots), seed)


def flip_bit(leaf: torch.Tensor, byte: int, bit: int) -> None:
    """Flip bit ``bit`` of byte ``byte`` (C order) of ``leaf``'s storage,
    in place: the tensor keeps its address."""
    if not leaf.is_contiguous():
        raise ValueError("fault injection flips bits of contiguous tensors only")
    flat = leaf.view(-1).view(torch.uint8)
    flat[byte] ^= 1 << bit


def _flip_random_bit(leaf: torch.Tensor, rng: np.random.Generator) -> tuple[int, int]:
    """Flip one uniformly random bit of ``leaf`` in place (the reference's
    draws: a byte, then a bit); returns the (byte, bit) site."""
    nbytes = leaf.numel() * leaf.element_size()
    byte = int(rng.integers(nbytes))
    bit = int(rng.integers(8))
    flip_bit(leaf, byte, bit)
    return byte, bit


def _walk(node: Any, path: str, pred, out: list) -> None:
    """Collect (path, container, key) triples for entries matching
    ``pred(key, value)``; recurses through dicts, lists and tuples and stops
    at :class:`~repro_torch.core.bitplanes.WeightPlanes` nodes (matched as
    whole values), as the reference's walk does."""
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return
    for k, v in items:
        p = f"{path}/{k}"
        if pred(k, v):
            out.append((p, node, k))
        else:
            _walk(v, p, pred, out)


class FaultInjector:
    """Applies a :class:`FaultSpec` to the serving state between steps.

    Deterministic: the same (spec, seed, tree structure) sequence flips the
    same bits, the property the fault-injection gates rely on.
    """

    def __init__(self, spec, seed: Optional[int] = None):
        if isinstance(spec, str):
            spec = FaultSpec.parse(spec)
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed if seed is None else seed)
        self.events: list[FaultEvent] = []

    def due(self, step: int) -> list:
        return [(site, count) for site, at, count in self.spec.shots if at == step]

    def pending_after(self, step: int) -> bool:
        return any(at >= step for _, at, _ in self.spec.shots)

    # -- detection bookkeeping ---------------------------------------------

    def mark_detected(self, category: str, step: int) -> list[FaultEvent]:
        """Mark every still-undetected event of ``category`` injected at or
        before ``step`` as detected (a detection signal of that category
        fired). Returns the newly marked events."""
        hit = []
        for e in self.events:
            if not e.detected and e.category == category and e.step <= step:
                e.detected = True
                hit.append(e)
        return hit

    @property
    def undetected(self) -> list[FaultEvent]:
        return [e for e in self.events if not e.detected]

    # -- injection ----------------------------------------------------------

    def apply(self, step: int, params: Any, cache: Any = None):
        """Inject every shot due at engine iteration ``step``, in place.
        Returns ``(params, cache)``, the objects given."""
        for site, count in self.due(step):
            for _ in range(count):
                if site in _KV_KEYS:
                    if cache is None:
                        raise ValueError(f"fault site {site!r} needs a KV cache to target")
                    self._hit_kv(site, step, cache)
                elif site == "scale":
                    self._hit_scale(step, params)
                else:
                    self._hit_planes(site, step, params)
        return params, cache

    def _pick(self, cands: list, what: str):
        if not cands:
            raise ValueError(f"no injection candidates for site {what!r}")
        return cands[int(self.rng.integers(len(cands)))]

    def _hit(self, site: str, step: int, path: str, leaf: torch.Tensor, category: str) -> None:
        byte, bit = _flip_random_bit(leaf, self.rng)
        self.events.append(FaultEvent(site, step, path, byte, bit, category))

    def _hit_planes(self, site: str, step: int, params: Any) -> None:
        cands: list = []
        _walk(params, "",
              lambda k, v: k == "w_planes" and isinstance(v, bp.WeightPlanes), cands)
        if site != "planes":
            # sbmwc packs no sign words and checksums ride only in integrity
            # caches: restrict to caches that store the target
            field = _PACKED_FIELD[site]
            cands = [c for c in cands if getattr(c[1][c[2]].packed, field) is not None]
        path, container, key = self._pick(cands, site)
        wp: bp.WeightPlanes = container[key]
        if site == "planes":
            # the words the executor consumes: the raw planes where the cache
            # keeps them (the host), the packed magnitude words otherwise
            if wp.planes is not None:
                leaf, field = wp.planes, "planes"
            else:
                leaf, field = wp.packed.mag, "mag"
        else:
            leaf = getattr(wp.packed, field)
        self._hit(site, step, f"{path}.{field}", leaf, "params")

    def _hit_scale(self, step: int, params: Any) -> None:
        cands: list = []
        _walk(params, "", lambda k, v: k == "w_scale", cands)
        path, container, key = self._pick(cands, "scale")
        self._hit("scale", step, path, container[key], "params")

    def _hit_kv(self, site: str, step: int, cache: Any) -> None:
        keys = _KV_KEYS[site]
        cands: list = []
        _walk(cache, "", lambda k, v: k in keys, cands)
        path, container, key = self._pick(cands, site)
        self._hit(site, step, path, container[key], "kv")


__all__ = ["FAULT_SITES", "FaultEvent", "FaultSpec", "FaultInjector", "flip_bit"]
