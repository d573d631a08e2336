"""Model / run configuration dataclasses.

One ``ModelConfig`` describes any architecture in the assigned pool; family-
specific behaviour is driven by fields (MoE, MLA, SSM, hybrid, cross-attn,
window pattern) rather than subclasses, so every model flows through the
same ``models/transformer.py`` assembly and the same launcher.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- attention pattern ---
    # Repeating per-layer sliding-window pattern; 0 = global attention.
    # e.g. gemma3: (1024,)*5 + (0,) -> 5 local : 1 global.
    window_pattern: Tuple[int, ...] = (0,)
    # Explicit global-attention layer ids (hymba: first/middle/last); when
    # set, these layers get window 0 and all others window_pattern[0].
    global_layer_ids: Tuple[int, ...] = ()
    rope_theta: float = 10000.0
    # separate rope base for global layers (gemma3 uses 1M global / 10k local)
    rope_theta_global: float = 0.0  # 0 -> same as rope_theta
    use_qk_norm: bool = False
    # Sequence-parallel attention (shard q-sequence over the model axis,
    # replicate K/V): avoids GSPMD's partial-sum score all-reduces when KV
    # head counts tile the model axis badly.  None = auto (enabled when
    # model_size % num_kv_heads != 0); measured per-arch in EXPERIMENTS.md.
    seq_parallel_attn: Optional[bool] = None
    # Residual-stream sharding between blocks: "" = the global default
    # (specs.ACTIVATION_SHARDING, d_model over the model axis), "dp_seq" =
    # sequence over the model axis (pairs with seq_parallel_attn: no
    # boundary reshard around attention), "dp" = batch-only.
    activation_sharding: str = ""

    # --- MLA (DeepSeek multi-head latent attention) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden size
    first_dense_layers: int = 0    # leading layers with dense FFN (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0             # N (dstate); 0 -> no SSM path
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # P (headdim)
    ssm_chunk: int = 64            # Q (SSD chunk length)
    ssm_conv_width: int = 4

    # --- hybrid (hymba: parallel attention + SSM heads per layer) ---
    hybrid: bool = False

    # --- cross-attention conditioning (vlm / audio) ---
    # "interleaved": one cross-attn layer before every `cross_attn_group`
    # self-attn layers (llama-3.2-vision). "every": cross-attn inside every
    # layer (musicgen text conditioning). "" = none.
    cross_attn_mode: str = ""
    cross_attn_group: int = 4      # self layers per cross layer (interleaved)
    cond_len: int = 64             # stub frontend sequence length
    cond_dim: int = 0              # 0 -> d_model

    # --- misc ---
    act: str = "silu"              # silu (SwiGLU) | gelu
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    vocab_layout: str = "cyclic"   # paper section 2.2/3.2 embedding layout
    remat: bool = True             # activation checkpointing in train
    attn_chunk_q: int = 1024       # chunked (flash-style) attention tiles
    attn_chunk_kv: int = 2048
    source: str = ""               # citation for the config

    # --- where a published model departs from its registry twin ---
    # Class-level defaults, not fields, so that a registry config's fields
    # stay the JAX package's, field for field; ``PublishedConfig`` makes
    # them fields.  The defaults are what every registry config computes.
    norm_topk_prob: ClassVar[bool] = True   # renormalise the top-k gates
    yarn_factor: ClassVar[float] = 0.0      # YaRN rope scaling; <= 1: none
    yarn_original_max_pos: ClassVar[int] = 4096
    yarn_beta_fast: ClassVar[float] = 32.0
    yarn_beta_slow: ClassVar[float] = 1.0
    yarn_mscale: ClassVar[float] = 1.0
    yarn_mscale_all_dim: ClassVar[float] = 0.0
    seq_aux: ClassVar[bool] = False         # balance loss per sequence
    scale_embed: ClassVar[bool] = True      # embeddings times sqrt(d_model)
    experts_held: ClassVar[int] = 0         # routed experts on this device
    expert_rank: ClassVar[int] = 0          # which: e = rank (mod E / held)

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.num_heads

    @property
    def cond_dim_(self) -> int:
        return self.cond_dim or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def held_experts_(self) -> int:
        """The routed experts this device holds (all unless a share is
        set): experts ``e = expert_rank (mod num_experts / held)``, the
        cyclic placement of expert parallelism."""
        return self.experts_held or self.num_experts

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_state > 0 and not self.hybrid and self.num_heads == 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def window_for_layer(self, layer: int) -> int:
        if self.global_layer_ids:
            return 0 if layer in self.global_layer_ids else self.window_pattern[0]
        return self.window_pattern[layer % len(self.window_pattern)]

    def windows(self) -> Tuple[int, ...]:
        return tuple(self.window_for_layer(l) for l in range(self.num_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer attends globally over unbounded context (SSM or
        all-window attention) -- the long_500k eligibility rule uses this
        plus the hybrid/gemma carve-outs (DESIGN.md)."""
        if not self.has_attention:
            return True
        return all(w > 0 for w in self.windows())

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        n = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.has_attention:
            if self.use_mla:
                r, dr, dn, dv = (self.kv_lora_rank, self.qk_rope_dim,
                                 self.qk_nope_dim, self.v_head_dim)
                h = self.num_heads
                per_layer += d * h * (dn + dr) + d * (r + dr) \
                    + r * h * (dn + dv) + h * dv * d
            else:
                per_layer += d * hd * (self.num_heads * 2
                                       + self.num_kv_heads * 2)
        if self.ssm_state > 0:
            di, nst = self.d_inner, self.ssm_state
            per_layer += d * (2 * di + 2 * nst + self.ssm_heads) + di * d
        if self.is_moe:
            fe = self.moe_d_ff or f
            per_layer += d * self.num_experts * 3 * fe / self.num_layers * \
                max(self.num_layers - self.first_dense_layers, 0)
            per_layer += d * self.num_experts  # router
            if self.num_shared_experts:
                per_layer += 3 * d * fe * self.num_shared_experts
            if self.first_dense_layers:
                per_layer += 3 * d * f * self.first_dense_layers / self.num_layers
        else:
            per_layer += 3 * d * f
        return int(n + self.num_layers * per_layer)

    def active_param_count(self) -> int:
        """Active (per-token) parameters, for MoE MODEL_FLOPS."""
        if not self.is_moe:
            return self.param_count()
        fe = self.moe_d_ff or self.d_ff
        total = self.param_count()
        moe_layers = self.num_layers - self.first_dense_layers
        all_experts = moe_layers * self.num_experts * 3 * self.d_model * fe
        active = moe_layers * self.top_k * 3 * self.d_model * fe
        return int(total - all_experts + active)


@dataclasses.dataclass(frozen=True)
class PublishedConfig(ModelConfig):
    """A ``ModelConfig`` with the settings in which a published model
    departs from its registry twin as fields (``ModelConfig`` holds their
    defaults): raw or renormalised top-k gates, YaRN rope scaling (the
    factor, the original context, the correction rotations ``beta_fast``
    and ``beta_slow``, ``mscale`` and ``mscale_all_dim``), the balance
    loss per sequence, the embedding scale, and the expert-parallel share
    this device holds (``experts_held`` of ``num_experts``, rank
    ``expert_rank``)."""

    norm_topk_prob: bool = True
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    seq_aux: bool = False
    scale_embed: bool = True
    experts_held: int = 0
    expert_rank: int = 0

    def __post_init__(self):
        held = self.held_experts_
        if self.num_experts and (self.num_experts % held
                                 or not 0 <= self.expert_rank
                                 < self.num_experts // held):
            raise ValueError(
                f"{held} held experts of {self.num_experts} at rank "
                f"{self.expert_rank}: the share must split the experts")


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop settings for the end-to-end drivers."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    seed: int = 0
    microbatch: int = 0  # 0 -> no gradient accumulation
