"""llama-3.2-vision-11b [vlm]: text backbone with gated cross-attention
image layers interleaved 1:4 [hf:meta-llama/Llama-3.2-11B-Vision].

40 layers total = 8 gated cross-attn layers + 32 self-attn layers
(one cross layer before every 4 self layers).  The ViT vision encoder +
projector is the stubbed frontend (assignment carve-out): ``input_specs``
provides projected patch embeddings [B, 6404, d_model] (4 tiles x 1601
patches)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,                 # 8 cross + 32 self
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    cross_attn_mode="interleaved",
    cross_attn_group=4,
    cond_len=6404,                 # 4 image tiles x 1601 patch embeddings
    cond_dim=4096,                 # post-projector (stub outputs d_model)
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
