"""Per-layer runtime-configurable precision — the paper's headline feature.

bitSMM's MACs are synthesized for a maximum width (16 bits) but run at any
effective precision 1–16, so "different layers (or groups of parameters)
can use different bit-widths" (paper §V). :class:`PrecisionPolicy` is that
dial in software: it maps layer names to (weight_bits, activation_bits)
and selects the execution level/variant of the bit-serial matmul.

Bit-widths are resolved into execution plans once per (layer shape,
precision); changing the runtime dial selects sibling plans against the
same stored weights, as the accelerator's effective width is a register
programmed between matmuls.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional, Tuple

MAX_BITS = 16  # the paper's synthesis-time maximum


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    w_bits: Optional[int] = None  # None -> dense bf16 path (technique off)
    a_bits: Optional[int] = None

    def __post_init__(self):
        for b in (self.w_bits, self.a_bits):
            if b is not None and not 1 <= b <= MAX_BITS:
                raise ValueError(f"bits must be in [1, {MAX_BITS}], got {b}")
        if (self.w_bits is None) != (self.a_bits is None):
            raise ValueError("w_bits and a_bits must both be set or both None")

    @property
    def active(self) -> bool:
        return self.w_bits is not None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-layer bit-width assignment.

    ``default``: precision for layers not matched by ``overrides``.
    ``overrides``: ordered mapping of regex -> LayerPrecision; first match
    wins. Layer names are hierarchical, e.g. ``"layers/attn/q_proj"``,
    ``"layers/moe/expert"``, ``"lm_head"``.
    ``variant``/``level``/``mode``: how matmuls lower (see core.bitserial).
    ``fuse_epilogue``: ``None`` = auto (the fully-fused linear kernel —
    in-kernel activation bit-slicing + dequant/bias/activation epilogue —
    on the CUDA bitplane path); ``False`` forces the staged kernels + a
    separate epilogue (bit-identical, for A/B comparison); ``True`` raises
    for configs the fused kernel cannot serve (on the plain torch backend
    it computes the bit-identical staged parity result instead).
    """

    default: LayerPrecision = LayerPrecision()
    overrides: Tuple[Tuple[str, LayerPrecision], ...] = ()
    variant: str = "booth"
    level: str = "digit"
    mode: str = "fully_serial"
    fuse_epilogue: Optional[bool] = None
    #: Runtime precision dial: ``(a_bits, w_bits)`` ceiling applied on top
    #: of the configured per-layer bits (never raising them). The paper's
    #: effective-width register: the *configured* bits are the synthesis/
    #: storage width (weights are stored and decomposed at them), the
    #: runtime bits are what a step actually consumes — weight planes by
    #: MSB-prefix truncation of the existing decomposition, activations by
    #: quantizing at the lower width directly (they are per-token anyway).
    #: ``None`` entries leave that operand at its configured width.
    runtime_bits: Optional[Tuple[Optional[int], Optional[int]]] = None
    #: Occupancy-gated sparse plane execution (DESIGN.md §8): ``"off"``
    #: issues every plane-pair pass; ``"gate"`` predicates each pass
    #: on pack-time weight occupancy AND'd with dynamic activation
    #: occupancy (kernels; the plain version has no passes to skip);
    #: ``"compact"`` additionally drops entirely-zero weight planes from
    #: the serving cache at quantize time, shrinking the plane-pair grid
    #: itself on every backend. All three are bit-identical.
    sparsity: str = "off"
    #: ABFT integrity mode (DESIGN.md §9): ``"off"`` = no checks;
    #: ``"detect"`` stores column checksums in the plane cache and
    #: verifies the row-sum identity at every checked matmul (alarms
    #: tallied per plan); ``"scrub"`` = detect + the serving engine
    #: rebuilds the corrupt cache from the checkpoint source and retries
    #: the step. Requires the bitplane level (the checksums live in the
    #: packed plane cache).
    integrity: str = "off"

    def __post_init__(self):
        if self.runtime_bits is not None:
            for b in self.runtime_bits:
                if b is not None and not 1 <= b <= MAX_BITS:
                    raise ValueError(f"runtime bits must be in [1, {MAX_BITS}], got {b}")
        if self.sparsity not in ("off", "gate", "compact"):
            raise ValueError(
                f"sparsity must be 'off', 'gate' or 'compact', got {self.sparsity!r}"
            )
        if self.integrity not in ("off", "detect", "scrub"):
            raise ValueError(
                f"integrity must be 'off', 'detect' or 'scrub', got {self.integrity!r}"
            )
        if self.integrity != "off" and self.level != "bitplane":
            raise ValueError(
                "integrity-checked execution needs level='bitplane' (the "
                f"ABFT checksums live in the packed plane cache), got {self.level!r}"
            )

    @staticmethod
    def off() -> "PrecisionPolicy":
        """Dense bf16 everywhere (technique disabled — the reference)."""
        return PrecisionPolicy()

    @staticmethod
    def uniform(
        w_bits: int,
        a_bits: Optional[int] = None,
        *,
        variant: str = "booth",
        level: str = "digit",
        mode: str = "fully_serial",
        keep_dense: Tuple[str, ...] = (),
        fuse_epilogue: Optional[bool] = None,
        sparsity: str = "off",
        integrity: str = "off",
    ) -> "PrecisionPolicy":
        """Same precision everywhere except ``keep_dense`` layer patterns."""
        a_bits = w_bits if a_bits is None else a_bits
        overrides = tuple((pat, LayerPrecision()) for pat in keep_dense)
        return PrecisionPolicy(
            default=LayerPrecision(w_bits, a_bits),
            overrides=overrides,
            variant=variant,
            level=level,
            mode=mode,
            fuse_epilogue=fuse_epilogue,
            sparsity=sparsity,
            integrity=integrity,
        )

    @staticmethod
    def from_dict(spec: Mapping[str, Tuple[Optional[int], Optional[int]]], **kw) -> "PrecisionPolicy":
        """e.g. ``{"": (8, 8), "lm_head": (None, None), "layers/0/": (4, 4)}``
        — empty pattern is the default."""
        default = LayerPrecision(*spec.get("", (None, None)))
        overrides = tuple(
            (pat, LayerPrecision(*bits)) for pat, bits in spec.items() if pat
        )
        return PrecisionPolicy(default=default, overrides=overrides, **kw)

    def lookup(self, layer_name: str) -> LayerPrecision:
        for pattern, prec in self.overrides:
            if re.search(pattern, layer_name):
                return prec
        return self.default

    def with_runtime_bits(
        self, a_bits: Optional[int], w_bits: Optional[int] = None
    ) -> "PrecisionPolicy":
        """Policy copy with the runtime precision dial set (pass ``None``
        for both to clear it). ``w_bits`` defaults to ``a_bits``."""
        if a_bits is None and w_bits is None:
            return dataclasses.replace(self, runtime_bits=None)
        return dataclasses.replace(
            self, runtime_bits=(a_bits, a_bits if w_bits is None else w_bits)
        )

    def effective(self, prec: LayerPrecision) -> LayerPrecision:
        """Apply the runtime dial to a configured layer precision: the
        executed width is ``min(configured, runtime)`` per operand (a dial
        can only lower precision — the stored decomposition has no planes
        above the configured width)."""
        if self.runtime_bits is None or not prec.active:
            return prec
        ra, rw = self.runtime_bits
        return LayerPrecision(
            w_bits=min(prec.w_bits, rw) if rw else prec.w_bits,
            a_bits=min(prec.a_bits, ra) if ra else prec.a_bits,
        )

    def lookup_effective(self, layer_name: str) -> LayerPrecision:
        """:meth:`lookup` with the runtime dial applied."""
        return self.effective(self.lookup(layer_name))

    def storage_width(self) -> Optional[int]:
        """Widest configured (pre-dial) weight width across the default
        and every override, or ``None`` when the policy is fully dense.
        This is the width weights are stored and decomposed at — the
        ceiling any runtime dial or autopilot tier must stay under,
        since MSB-prefix truncation has no planes above it."""
        widths = [p.w_bits for _, p in self.overrides if p.active]
        if self.default.active:
            widths.append(self.default.w_bits)
        return max(widths) if widths else None

    def describe(self) -> str:
        lines = [
            f"PrecisionPolicy(level={self.level}, variant={self.variant}, mode={self.mode})",
            f"  default: w{self.default.w_bits}/a{self.default.a_bits}",
        ]
        for pat, p in self.overrides:
            lines.append(f"  {pat!r}: w{p.w_bits}/a{p.a_bits}")
        return "\n".join(lines)
