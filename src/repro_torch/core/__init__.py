"""Core numerics: precision policy, quantization, plane decompositions, plans
and their tile autotuner, and the paper's systolic cycle and MAC model
(``systolic``). The reference's exports (``src/repro/core``)."""

from repro_torch.core import systolic
from repro_torch.core.bitplanes import (
    PlaneDecomposition,
    booth_nonzero_digit_count,
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
    "systolic",
    "PlaneDecomposition",
    "booth_nonzero_digit_count",
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
