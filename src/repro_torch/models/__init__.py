"""The LM scaffold: norms, RoPE, MLPs and the cyclic embedding (``layers``), attention (GQA, sliding window, MLA, cross), MoE, the Mamba-2 SSD block and the transformer that assembles them."""
