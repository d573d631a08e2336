"""hymba-1.5b [hybrid]: parallel attention + mamba heads in every layer
[arXiv:2411.13676].

32L, d_model 1600, 25 attention heads / 5 kv heads (head_dim 64) fused in
parallel with SSD heads (ssm_state 16, d_inner 3200 -> 50 SSD heads);
per-path output RMSNorm + learned scalar mixing (the paper's per-head beta
simplified to per-path -- DESIGN.md).  Sliding window 1024 everywhere except
3 global layers (first / middle / last).  Hymba's 128 learnable meta tokens
are omitted (prompt-side concern; noted in DESIGN.md).  vocab 32001."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    hybrid=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    # Q=64: the SSD intra-chunk tensor is [B, Nc, Q, Q, H] f32 (50 SSD
    # heads here); Q=64 halves it against Q=128 at identical math (the SSD
    # is chunk-invariant: tests/test_torch_lm_layers.py holds it).
    ssm_chunk=64,
    window_pattern=(1024,),
    global_layer_ids=(0, 15, 31),
    tie_embeddings=True,
    source="arXiv:2411.13676",
)
