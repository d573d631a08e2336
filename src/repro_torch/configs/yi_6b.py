"""yi-6b [dense]: llama-architecture with aggressive GQA (kv=4)
[arXiv:2403.04652].  32L, d_model 4096, 32 heads / 4 kv heads, d_ff 11008,
vocab 64000, RoPE theta 5e6, SwiGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    source="arXiv:2403.04652",
)
