"""Core numerics: precision policy, quantization, plane decompositions, plans
and their tile autotuner. The reference's exports (``src/repro/core``) but
``booth_nonzero_digit_count`` and ``systolic``, the cycle model (ROADMAP
item 14b)."""

from repro_torch.core.bitplanes import (
    PlaneDecomposition,
    shift_requantize,
    signed_range,
    to_bitplanes,
    to_digits,
    truncate_weight_planes,
)
from repro_torch.core.bitserial import (
    bitserial_matmul,
    plane_pass_count,
    quantized_matmul,
)
from repro_torch.core.precision import MAX_BITS, LayerPrecision, PrecisionPolicy
from repro_torch.core.plan import (
    DEFAULT_REGISTRY,
    MatmulPlan,
    PlanKey,
    PlanRegistry,
    make_plan,
    plan_for_operands,
)
from repro_torch.core.quantize import (
    Quantized,
    dequantize,
    fake_quant,
    quantization_error,
    quantize,
)

__all__ = [
    "PlaneDecomposition",
    "shift_requantize",
    "signed_range",
    "to_bitplanes",
    "to_digits",
    "truncate_weight_planes",
    "bitserial_matmul",
    "plane_pass_count",
    "quantized_matmul",
    "MAX_BITS",
    "LayerPrecision",
    "PrecisionPolicy",
    "DEFAULT_REGISTRY",
    "MatmulPlan",
    "PlanKey",
    "PlanRegistry",
    "make_plan",
    "plan_for_operands",
    "Quantized",
    "dequantize",
    "fake_quant",
    "quantization_error",
    "quantize",
]
