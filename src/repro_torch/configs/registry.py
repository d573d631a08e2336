"""Architecture registry: ``--arch <id>`` resolution, per-shape input specs
(``(shape, torch.dtype)`` stand-ins -- no allocation), decode-cache shape
builders, and reduced smoke variants for CPU tests.

The twin of the JAX package's ``configs/registry.py``: the same archs,
smoke variants and shapes; a spec is a ``(shape, dtype)`` tuple where the
JAX package has a ``jax.ShapeDtypeStruct``.  The serving engine allocates
its decode cache from ``cache_shapes``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_4b, glm4_9b,
                                 hymba_1_5b, llama32_vision_11b,
                                 llama4_scout_17b, mamba2_370m,
                                 musicgen_medium, phi3_medium_14b, yi_6b)
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        musicgen_medium.CONFIG,
        yi_6b.CONFIG,
        glm4_9b.CONFIG,
        phi3_medium_14b.CONFIG,
        llama32_vision_11b.CONFIG,
        deepseek_v2_lite_16b.CONFIG,
        llama4_scout_17b.CONFIG,
        gemma3_4b.CONFIG,
        mamba2_370m.CONFIG,
        hymba_1_5b.CONFIG,
    ]
}

# long_500k eligibility: SSM / hybrid / mostly-sliding-window archs run it;
# pure full-attention archs skip.
LONG_CONTEXT_ARCHS = {"mamba2-370m", "hymba-1.5b", "gemma3-4b"}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def shape_supported(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS or cfg.name.startswith("smoke-")
    return True


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def cond_spec(cfg: ModelConfig, batch: int):
    if not cfg.cross_attn_mode:
        return None
    return (batch, cfg.cond_len, cfg.cond_dim_), torch_dtype(cfg.dtype)


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``(shape, dtype)`` tree mirroring transformer.py's decode caches:
    ``{"main": {...}, "dense": {...}}``, each leaf stacked over its layers."""
    from repro_torch.models.transformer import layer_plan  # avoid a cycle
    plan = layer_plan(cfg)
    dt = torch_dtype(cfg.dtype)

    def attn_entry(n):
        if cfg.use_mla:
            return {
                "ckv": ((n, batch, seq_len, cfg.kv_lora_rank), dt),
                "krope": ((n, batch, seq_len, cfg.qk_rope_dim), dt),
            }
        return {
            "k": ((n, batch, seq_len, cfg.num_kv_heads, cfg.head_dim_), dt),
            "v": ((n, batch, seq_len, cfg.num_kv_heads, cfg.head_dim_), dt),
        }

    def ssm_entry(n):
        return {
            "ssm": ((n, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), torch.float32),
            "conv": ((n, batch, cfg.ssm_conv_width - 1,
                      cfg.d_inner + 2 * cfg.ssm_state), dt),
        }

    n = plan["main"]
    if cfg.ssm_state > 0 and not cfg.hybrid:
        main = ssm_entry(n)
    elif cfg.hybrid:
        main = {**attn_entry(n), **ssm_entry(n)}
    else:
        main = attn_entry(n)

    caches = {"main": main}
    if plan["dense"]:
        caches["dense"] = attn_entry(plan["dense"])
    return caches


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Stand-in inputs for one (arch, shape) pair, keyed by the step
    function's kwargs.  ``kind`` selects train_step / prefill / serve_step."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {
            "tokens": ((b, s), i32),
            "targets": ((b, s), i32),
            "mask": ((b, s), torch.float32),
        }
    elif shape.kind == "prefill":
        specs = {"tokens": ((b, s), i32)}
    else:  # decode: ONE token against a seq_len cache
        specs = {
            "token": ((b,), i32),
            "pos": ((), i32),
            "caches": cache_shapes(cfg, b, s),
        }
    c = cond_spec(cfg, b)
    if c is not None:
        specs["cond"] = c
    return specs


# ---------------------------------------------------------------------------
# Reduced smoke variants (2 layers, d_model <= 512, <= 4 experts)
# ---------------------------------------------------------------------------

_SMOKE_COMMON = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512,
                     head_dim=32, dtype="float32", remat=False,
                     attn_chunk_q=32, attn_chunk_kv=32, cond_len=8)


def smoke_variant(name: str) -> ModelConfig:
    """Same family, tiny dims: one forward/decode must run on CPU."""
    cfg = get(name)
    over = dict(_SMOKE_COMMON)
    over["name"] = f"smoke-{name}"
    if cfg.has_attention:
        over["num_heads"] = 4
        over["num_kv_heads"] = 4 if cfg.num_kv_heads == cfg.num_heads else 2
    if cfg.use_mla:
        over.update(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
                    v_head_dim=32)
    if cfg.is_moe:
        over.update(num_experts=4, top_k=min(cfg.top_k, 2),
                    moe_d_ff=64,
                    num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.ssm_state > 0:
        over.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.window_pattern != (0,):
        over["window_pattern"] = tuple(8 if w else 0 for w in cfg.window_pattern)
    if cfg.global_layer_ids:
        over["global_layer_ids"] = (0,)
    if cfg.cross_attn_mode == "interleaved":
        over["cross_attn_group"] = 1     # 2 layers = 1 cross + 1 self
    if cfg.cond_dim:
        over["cond_dim"] = 64
    return dataclasses.replace(cfg, **over)


def all_arch_names():
    return sorted(ARCHS)


__all__ = ["ARCHS", "INPUT_SHAPES", "LONG_CONTEXT_ARCHS", "all_arch_names",
           "cache_shapes", "cond_spec", "get", "input_specs",
           "shape_supported", "smoke_variant", "torch_dtype"]
