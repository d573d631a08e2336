"""mamba2-370m [ssm]: attention-free SSD (state-space duality)
[arXiv:2405.21060].

48L, d_model 1024, d_inner 2048 (expand 2), head_dim 64 -> 32 SSD heads,
ssm_state N=128, causal-conv width 4, vocab 50280.  No attention, no MLP
(the mamba block is the whole layer).  Decode is O(1) state -- long_500k
is this family's natural shape.

Arch-applicability note (DESIGN.md): token-level MH sampling does not apply
to an attention-free LM; the paper's infrastructure (cyclic vocab-sharded
embeddings + additive delta aggregation) still does."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,                   # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
