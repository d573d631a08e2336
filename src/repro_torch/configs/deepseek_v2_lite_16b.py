"""deepseek-v2-lite-16b [moe]: MLA (kv_lora 512) + fine-grained MoE
[arXiv:2405.04434].

27L, d_model 2048, 16 heads, vocab 102400.  MoE: 64 routed experts top-6 +
2 shared experts, per-expert d_ff 1408; the first layer keeps a dense FFN
(d_ff 10944), as in the model card.  NOTE: the assignment line says both
"64e top-6" and "160 routed"; the model card has 64 routed + 2 shared,
matching the primary "64e" spec, which is what we build (DESIGN.md).

MLA: kv_lora_rank 512, decoupled RoPE dim 64, qk_nope 128, v_head 128.
Decode uses the absorbed-matmul latent path (attention.py)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,               # MLA: effectively per-head latent KV
    d_ff=10944,                    # dense FFN of layer 0
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    moe_d_ff=1408,                 # the assignment's d_ff=1408 (per expert)
    first_dense_layers=1,
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2405.04434",
)
