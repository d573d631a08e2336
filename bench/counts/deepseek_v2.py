"""The model FLOPs of a DeepSeek-V2 training step at a configuration's cut
widths: three times the forward's products (the backward's two for each),
with no rematerialisation counted.  Each product ``[m, k] @ [k, n]`` is
``2 m k n``; attention counts the causal half of each sequence's scores
(``S (S + 1) / 2`` pairs a head) for ``q k`` and for ``p v``; the routed
experts count the (token, held expert) pairs the step computed, which the
program counts (``lm.moe.held_pairs``)."""
from __future__ import annotations


def forward_flops(config: dict, rows: int, seq_len: int,
                  held_pairs: float) -> float:
    """The forward's FLOPs of ``rows`` sequences of ``seq_len`` tokens
    whose expert layers computed ``held_pairs`` (token, held expert)
    pairs in all (``config``: the configuration file's keys)."""
    d = config["hidden_size"]
    h = config["num_attention_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, r = config["v_head_dim"], config["kv_lora_rank"]
    layers = config["num_hidden_layers"]
    dense = config["first_k_dense_replace"]
    experts = config.get("published", {}).get("n_routed_experts",
                                               config["n_routed_experts"])
    f = config["moe_intermediate_size"]
    tokens = rows * seq_len
    mla = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    pairs = rows * h * seq_len * (seq_len + 1) / 2
    per_token = (layers * mla
                 + dense * 3 * d * config["intermediate_size"]
                 + (layers - dense) * (d * experts
                                       + 3 * d * f
                                       * config["n_shared_experts"])
                 + d * config["vocab_size"])
    return 2.0 * (tokens * per_token + layers * pairs * (dn + dr + dv)
                  + held_pairs * 3 * d * f)


def step_flops(config: dict, rows: int, seq_len: int,
               held_pairs: float) -> float:
    """A training step's: forward and backward, ``3 x forward_flops``."""
    return 3.0 * forward_flops(config, rows, seq_len, held_pairs)
