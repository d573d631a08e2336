"""musicgen-medium [audio]: decoder-only transformer over EnCodec tokens
with text-conditioning cross-attention in every layer [arXiv:2306.05284].

Backbone only, per the assignment carve-out: the EnCodec codec and the T5
text encoder are stubbed -- ``input_specs`` provides the conditioning
embeddings.  48L, d_model 1536, 24 heads (kv=24 -> plain MHA), d_ff 6144,
vocab 2048 (one codebook stream; the delay-pattern interleave is a data-
pipeline concern, not an architecture one).  MusicGen's sinusoidal
positions are adapted to RoPE (TPU-native choice; noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    cross_attn_mode="every",
    cond_len=64,               # T5 text-conditioning tokens (stub frontend)
    cond_dim=1536,
    act="gelu",
    tie_embeddings=False,
    source="arXiv:2306.05284",
)
