"""MLA's causal core behind ``models.attention.mla_attention`` on the CPU:
its plain version is the chunked core that ``MLA.forward`` ran before the
fused kernel (the query and key concatenated, the RoPE key expanded to
every head, V padded to the query width), bitwise, forward and the five
inputs' gradients; the wrapper's checks; the step's ``lm.attn.fused``
counter.  The kernel itself is tested on the card (``test_torch_cuda.py``).
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import deepseek_v2_lite_16b as ds
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import mla_attention as fused
from repro_torch.models import attention as attn
from repro_torch.obs import ObsConfig, ObsSession
from repro_torch.train import loop

DN, DR, DV = 128, 64, 128        # DeepSeek-V2-Lite's head parts


def _inputs(b, t, h, dtype=torch.bfloat16, seed=0):
    """The projections as ``MLA.forward`` has them: q_nope and q_rope as
    views of one [B, T, H, dn + dr] tensor, k_rope one row a token."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    q = randn(b, t, h, DN + DR)
    return (q[..., :DN], q[..., DN:], randn(b, t, h, DN), randn(b, t, DR),
            randn(b, t, h, DV))


def _todays_core(qn, qr, k_nope, krope, val, scale, q_chunk, kv_chunk):
    """``MLA.forward``'s core before ``mla_attention``, as it was written."""
    b, t, h, dn = qn.shape
    dr, dv = qr.shape[-1], val.shape[-1]
    positions = torch.arange(t, dtype=torch.int64)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, t, h, dr)], dim=-1)
    vp = torch.nn.functional.pad(val, (0, (dn + dr) - dv))
    out = attn._attend_chunked(q[:, :, :, None, :], k, vp, positions,
                               positions, causal=True, window=0,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               scale=scale)
    return out[..., 0, :dv]


def _run(fn, args, grad_out):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*leaves)
    (out.float() * grad_out).sum().backward()
    return out.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("chunks", [(1024, 2048), (32, 64)],
                         ids=["cfg-chunks", "small-chunks"])
@pytest.mark.parametrize("h", [16, 4])
@pytest.mark.parametrize("t", [64, 100, 257])
def test_plain_version_is_todays_core_bitwise(t, h, chunks):
    """Forward and the gradients of all five inputs equal the old core's
    bits; the small chunks visit several tiles and a ragged last one."""
    qc, kc = chunks
    scale = 0.1147
    args = _inputs(2, t, h, seed=t + h)
    g = torch.randn((2, t, h, DV), generator=torch.Generator().manual_seed(1))
    want, want_g = _run(lambda *a: _todays_core(*a, scale, qc, kc), args, g)
    got, got_g = _run(
        lambda qn, qr, kn, kr, v: attn.mla_attention(
            qn.contiguous(), qr.contiguous(), kn, kr, v, scale, q_chunk=qc,
            kv_chunk=kc), args, g)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t, h, DV)
    assert torch.equal(got, want)
    for name, a, b in zip(("q_nope", "q_rope", "k_nope", "k_rope", "v"),
                          got_g, want_g):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_mla_forward_calls_the_core_once_a_layer():
    """``MLA.forward`` gives what it gave through the old core (the same
    bits, from the same projections)."""
    cfg = ds.published(dict(ds.PUBLISHED, hidden_size=64,
                            num_attention_heads=4, kv_lora_rank=32,
                            num_hidden_layers=2, vocab_size=256),
                       dtype="bfloat16")
    cfg = dataclasses.replace(cfg, attn_chunk_q=16, attn_chunk_kv=32)
    layer = attn.MLA(cfg, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((2, 40, 64), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    pos = torch.arange(40)
    got, _ = layer(x, positions=pos)
    wq, w_uk, w_uv, wo = layer.weights()
    rope, scale = layer._rope(x.device)
    qn, qr = layer._q(x, pos, wq, rope)
    ckv, krope = layer._compress(x, pos, rope)
    k_nope = (ckv @ w_uk).reshape(2, 40, 4, DN)
    val = (ckv @ w_uv).reshape(2, 40, 4, DV)
    core = _todays_core(qn, qr, k_nope, krope, val, scale, 16, 32)
    assert torch.equal(got, core.reshape(2, 40, 4 * DV) @ wo)


def _good():
    qn, qr, kn, kr, v = _inputs(1, 8, 2)
    return dict(q_nope=qn.contiguous(), q_rope=qr.contiguous(), k_nope=kn,
                k_rope=kr, v=v)


@pytest.mark.parametrize("change,match", [
    (lambda a: a.update(k_rope=a["k_nope"][..., :DR].contiguous()),
     "k_rope must have shape"),
    (lambda a: a.update(v=a["v"][:, :4].contiguous()), "v must have shape"),
    (lambda a: a.update(q_rope=a["q_rope"][..., :32].contiguous()),
     "k_rope must have shape"),
    (lambda a: a.update(q_nope=a["q_nope"][0]), r"q_nope must be \[B, T"),
    (lambda a: a.update(v=a["v"].float()), "all five must agree"),
    (lambda a: a.update(**{k: x.double() for k, x in a.items()}),
     "no core for torch.float64"),
    (lambda a: a.update(k_nope=a["k_nope"].transpose(1, 2).contiguous()
                        .transpose(1, 2)), "k_nope must be contiguous"),
    (lambda a: a.update(q_nope=torch.cat([a["q_nope"], a["q_rope"]], -1)
                        [..., :DN]), "q_nope must be contiguous"),
], ids=["k_rope-per-head", "v-short", "rope-widths-differ", "q-3d",
        "dtypes-differ", "float64", "k-transposed", "q-a-view"])
def test_the_wrapper_refuses_what_it_cannot_take(change, match):
    args = _good()
    attn.mla_attention(**args, scale=0.1)
    change(args)
    with pytest.raises(ValueError, match=match):
        attn.mla_attention(**args, scale=0.1)


def test_the_kernel_takes_power_of_two_head_parts():
    """The kernels are built for DeepSeek-V2-Lite's head parts alone
    (powers of two, 128 + 64 query/key and 128 value columns); other
    powers of two are refused."""
    assert fused.supported(128, 64, 128) and fused.DIMS == (128, 64, 128)
    for dims in ((64, 32, 64), (128, 128, 128), (32, 16, 32), (128, 64, 64),
                 (192, 64, 128)):
        assert not fused.supported(*dims), dims


def test_operands_off_16_bytes_are_copied():
    """The kernels copy rows 16 bytes at a time: a contiguous view that
    starts elsewhere is copied, an aligned tensor passed as it is."""
    base = torch.arange(33, dtype=torch.bfloat16)
    view = base[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = fused.aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert fused.aligned(base) is base


def test_the_cpu_launches_no_kernel():
    before = fused.launch_counts()
    _run(lambda *a: attn.mla_attention(*a, 0.1), [
        x.contiguous() for x in _inputs(1, 16, 2)],
        torch.ones((1, 16, 2, DV)))
    assert fused.launch_counts() == before


def test_the_step_counts_its_mla_cores():
    """With an obs session, ``lm.attn.fused`` counts each layer's core of
    each microbatch once (the recompute not): on the CPU every call takes
    the chunked core.  Without one, nothing."""
    cfg = ds.published(dict(ds.PUBLISHED, hidden_size=64,
                            num_attention_heads=4, kv_lora_rank=32,
                            qk_rope_head_dim=16, qk_nope_head_dim=32,
                            v_head_dim=32, intermediate_size=128,
                            moe_intermediate_size=32, n_routed_experts=8,
                            num_hidden_layers=3, vocab_size=256),
                       dtype="float32")
    tc = TrainConfig(microbatch=2)
    state = loop.init_state(3, cfg, device="cpu")
    step = loop.make_train_step(cfg, tc)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 256, (4, 24), generator=g)
    obs = ObsSession(ObsConfig(enabled=True, metrics=False)).install()
    try:
        step(state, tok, tok.roll(-1, 1), torch.ones(4, 24))
    finally:
        obs.close(save=False)
    counters = {e["name"]: e["args"] for e in obs.tracer.events()
                if e.get("ph") == "C"}
    assert counters["lm.attn.fused"] == {"fwd": 0, "bwd": 0,
                                         "chunked": 3 * 2}
