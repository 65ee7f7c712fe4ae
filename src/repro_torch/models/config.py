"""Model configuration: one dataclass for the ten architectures — the
dense decoders, the mixture-of-experts decoders (``moe``), the Mamba2 SSD
stack (``ssm``), the Griffin hybrid (``hybrid``: RG-LRU and
local-attention blocks in a repeated period), the audio encoder
(``encoder``) and the vision-language decoder (``vlm``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 500000.0
    causal: bool = True
    local_window: int = 0  # sliding-window size of the hybrid's attention layers
    # mlp
    d_ff: int = 0
    act: str = "swiglu"  # swiglu | geglu | gelu (a plain, ungated MLP)
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_impl: str = "gshard_ep"  # gshard_ep (capacity-bounded) | global_sort (dropless)
    #: 0 = dropless; > 0 bounds each expert's buffer to cf * T * k / E copies
    moe_capacity_factor: float = 0.0
    # ssm (mamba2)
    ssm_d_inner: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 0
    conv_width: int = 4
    ssd_chunk: int = 256
    # hybrid (recurrentgemma): the layer pattern, repeated; the remainder
    # of n_layers is a tail of the pattern's first kinds
    period: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    # modality front end: a projection of precomputed features
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0
    num_patches: int = 0  # vlm: image patches put in front of the text
    # misc
    tie_embeddings: bool = False
    attn_chunk: int = 1024  # online-softmax KV chunk
    #: True names the layers of the repeated periods ``layers/<kind>`` and
    #: those of the tail ``layers/tail/<kind>`` (the JAX scanned-stack
    #: names); False names every layer ``layers/<i>/<kind>`` for per-layer
    #: precision overrides, as the reference's unrolled stack does
    scan_layers: bool = True
    #: training: scanned periods per checkpointed region; > 1 nests the
    #: checkpoints (one saved residual per group, recompute per period)
    remat_group: int = 1
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the padded vocabulary the
        reference shards; samplers mask the padding columns)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True when decode state is sub-quadratic (SSM / windowed hybrid)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer block kinds, length ``n_layers``."""
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.family == "hybrid":
            if not self.period:
                raise ValueError("a hybrid config needs a period pattern")
            reps = -(-self.n_layers // len(self.period))
            return (self.period * reps)[: self.n_layers]
        if self.family == "moe":
            return ("moe",) * self.n_layers
        return ("dense",) * self.n_layers

    def param_count(self) -> int:
        """Approximate parameter count (embeddings and blocks), the
        reference's: the roofline's ``6 * N * D`` reads it."""
        d = self.d_model
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings and self.family != "encoder":
            n += d * self.vocab_size  # head
        if self.family == "encoder":
            n += d * self.vocab_size
        if self.frontend != "none":
            n += self.frontend_dim * d
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        for kind in self.layer_kinds():
            n += 2 * d  # norms
            if kind in ("dense", "moe"):
                n += attn
            if kind == "dense":
                n += 3 * d * self.d_ff
            elif kind == "moe":
                n += d * self.n_experts + self.n_experts * 3 * d * self.moe_d_ff
            elif kind == "ssm":
                conv_dim = self.ssm_d_inner + 2 * self.ssm_state
                n += d * (self.ssm_d_inner + conv_dim + self.ssm_heads)
                n += self.ssm_d_inner * d + self.conv_width * conv_dim
            elif kind == "rec":
                w = self.lru_width
                n += 2 * d * w + w * d + 2 * w * w + self.conv_width * w
            elif kind == "attn":
                n += attn + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters active per token (an MoE layer runs ``top_k`` of its
        experts)."""
        n = self.param_count()
        if self.family != "moe":
            return n
        return n - self.n_layers * (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff

    def period_layout(self) -> tuple[Tuple[str, ...], int]:
        """``(period, n_full)``: the repeated pattern and how many whole
        periods the reference's scanned stack holds; layers from
        ``n_full * len(period)`` on are its unrolled tail."""
        kinds = self.layer_kinds()
        period = self.period if self.period else kinds[:1]
        return period, self.n_layers // max(len(period), 1)

    def layer_name(self, i: int) -> str:
        """Layer ``i``'s name prefix: the reference's ``layers/<kind>`` in a
        scanned period, ``layers/tail/<kind>`` in the tail, and
        ``layers/<i>/<kind>`` when the stack is unrolled."""
        kind = self.layer_kinds()[i]
        if not self.scan_layers:
            return f"layers/{i}/{kind}"
        period, n_full = self.period_layout()
        if i < n_full * len(period):
            return f"layers/{kind}"
        return f"layers/tail/{kind}"

    def param_path(self, i: int) -> str:
        """Layer ``i``'s path in the reference's parameter tree:
        ``/periods/b<j>_<kind>`` in a scanned period, ``/tail/<t>`` in the
        tail, ``/layers/<i>`` unrolled (policy lookups key on it)."""
        if not self.scan_layers:
            return f"/layers/{i}"
        period, n_full = self.period_layout()
        plen = len(period)
        if i < n_full * plen:
            return f"/periods/b{i % plen}_{period[i % plen]}"
        return f"/tail/{i - n_full * plen}"


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) evaluation cell of the dry run."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """The reference's skip rules (its DESIGN.md §5): (applies, reason)."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    if shape.kind == "prefill" and not cfg.is_decoder:
        return True, "encoder forward pass (no cache)"
    return True, ""
