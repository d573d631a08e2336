"""llama4-scout-17b-a16e [moe]: 16-expert top-1 MoE with a shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model 5120, 40 heads / 8 kv heads, expert d_ff 8192, vocab 202048.
Llama-4's "early fusion" multimodality concerns the tokenizer/frontend; the
assigned backbone is the text decoder, which is what we build (the vision
tokens would arrive as ordinary embedded positions)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    num_experts=16,
    top_k=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    rope_theta=500000.0,
    use_qk_norm=True,
    # the JAX package's sequence-parallel attention layout on a mesh; one
    # device (the port's serving path) does not read it
    seq_parallel_attn=True,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
