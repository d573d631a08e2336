"""gemma3-4b [dense]: 5:1 local(1024-window):global attention, 128k context
[hf:google/gemma-3-4b-pt].

34L, d_model 2560, 8 heads / 4 kv heads (head_dim 256 per the model card),
d_ff 10240, vocab 262144 (the largest vocabulary in the pool -- the best
showcase for the paper's cyclic frequency-ordered embedding sharding).
Local layers use RoPE theta 10k, global layers 1M.  qk-norm on.  Because
only 1/6 of layers attend globally and the rest have a 1024 window, this
config runs the long_500k shape (sequence-sharded cache decode path)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    rope_theta=10000.0,
    rope_theta_global=1_000_000.0,
    use_qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-4b-pt",
)
