"""glm4-9b [dense]: RoPE + extreme GQA (kv=2) [hf:THUDM/glm-4-9b].
40L, d_model 4096, 32 heads / 2 kv heads, d_ff 13696, vocab 151552.
GLM4's partial-rotary (50%) is simplified to full rotary (noted in
DESIGN.md); it does not change any sharded shape."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    rope_theta=10000.0,
    tie_embeddings=False,
    source="hf:THUDM/glm-4-9b",
)
