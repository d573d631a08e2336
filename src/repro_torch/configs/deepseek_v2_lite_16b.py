"""deepseek-v2-lite-16b [moe]: MLA (kv_lora 512) + fine-grained MoE
[arXiv:2405.04434].

27L, d_model 2048, 16 heads, vocab 102400.  MoE: 64 routed experts top-6 +
2 shared experts, per-expert d_ff 1408; the first layer keeps a dense FFN
(d_ff 10944), as in the model card.  NOTE: the assignment line says both
"64e top-6" and "160 routed"; the model card has 64 routed + 2 shared,
matching the primary "64e" spec, which is what we build (DESIGN.md).

MLA: kv_lora_rank 512, decoupled RoPE dim 64, qk_nope 128, v_head 128.
Decode uses the absorbed-matmul latent path (attention.py).

``CONFIG`` is the JAX package's twin and departs from the published model
in four places: it renormalises the top-6 gates (published:
``norm_topk_prob: false``), applies plain RoPE (published: YaRN, factor 40
over 4,096 original positions, with the softmax scale times mscale^2),
scales the embeddings by sqrt(d_model) (published: unscaled) and takes the
load-balance loss over the whole batch at weight 0.01 (published:
``seq_aux: true``, per sequence).  ``published`` builds the published
model from its ``config.json`` keys (``PUBLISHED``), cut to one device's
share."""
from repro_torch.configs.base import ModelConfig, PublishedConfig

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

# https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json
PUBLISHED = {
    "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 10944, "kv_lora_rank": 512,
    "moe_intermediate_size": 1408, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-6,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_method": "greedy",
    "v_head_dim": 128, "vocab_size": 102400,
}

# the balance loss's weight, which the keys above do not give: assumed
AUX_ALPHA = 0.001


def published(keys: dict = PUBLISHED, *, num_layers: int = 0,
              experts_held: int = 0, expert_rank: int = 0,
              vocab_size: int = 0, dtype: str = "bfloat16",
              aux_alpha: float = AUX_ALPHA) -> PublishedConfig:
    """The published model from its ``config.json`` ``keys``, cut to one
    device's share: ``num_layers`` (the leading dense layer among them),
    ``experts_held`` of the routed experts in each expert layer (experts
    ``e = expert_rank (mod n_routed_experts / experts_held)``; the router
    keeps all of them) and the first ``vocab_size`` rows of the vocabulary
    for the embedding and the head.  0 keeps the published count.  Raw
    top-k gates, YaRN, unscaled embeddings and the balance loss per
    sequence at weight ``aux_alpha``."""
    if keys.get("q_lora_rank") is not None or keys.get(
            "routed_scaling_factor", 1) != 1 or keys.get(
            "scoring_func", "softmax") != "softmax" or keys.get(
            "topk_method", "greedy") != "greedy" or keys.get(
            "hidden_act", "silu") != "silu":
        raise ValueError("only DeepSeek-V2-Lite's attention, router and "
                         "experts: no query compression, greedy softmax "
                         "top-k, scaling 1, SwiGLU")
    rs = keys["rope_scaling"]
    return PublishedConfig(
        name="deepseek-v2-lite",
        arch_type="moe",
        num_layers=num_layers or keys["num_hidden_layers"],
        d_model=keys["hidden_size"],
        num_heads=keys["num_attention_heads"],
        num_kv_heads=keys["num_key_value_heads"],
        d_ff=keys["intermediate_size"],
        vocab_size=vocab_size or keys["vocab_size"],
        use_mla=True,
        kv_lora_rank=keys["kv_lora_rank"],
        qk_rope_dim=keys["qk_rope_head_dim"],
        qk_nope_dim=keys["qk_nope_head_dim"],
        v_head_dim=keys["v_head_dim"],
        num_experts=keys["n_routed_experts"],
        top_k=keys["num_experts_per_tok"],
        num_shared_experts=keys["n_shared_experts"],
        moe_d_ff=keys["moe_intermediate_size"],
        first_dense_layers=keys["first_k_dense_replace"],
        router_aux_weight=aux_alpha,
        rope_theta=float(keys["rope_theta"]),
        tie_embeddings=keys["tie_word_embeddings"],
        norm_eps=keys["rms_norm_eps"],
        dtype=dtype,
        source="https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite",
        norm_topk_prob=keys["norm_topk_prob"],
        yarn_factor=float(rs["factor"]),
        yarn_original_max_pos=int(rs["original_max_position_embeddings"]),
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]),
        yarn_mscale=float(rs["mscale"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]),
        seq_aux=keys["seq_aux"],
        scale_embed=False,
        experts_held=experts_held,
        expert_rank=expert_rank,
    )
