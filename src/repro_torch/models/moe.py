"""Mixture-of-Experts with expert-parallel all-to-all dispatch.

The twin of the JAX package's ``models/moe.py``.  This block is the
paper's parameter-server pattern moved onto experts: experts are placed on
model-axis shards **cyclically** (expert ``e`` lives on shard ``e mod M``
at local index ``e div M`` -- paper section 2.2), tokens are *pushed* to
their experts through fixed-capacity buffers (the paper's bounded message
buffers, section 3.3: overflow is dropped), and results are *pulled* back
by the symmetric all-to-all.

Paths:
  * ``moe_block_dense`` -- every expert on every token, gate-masked: exact,
    no drops; the single-device path;
  * ``moe_block_held`` -- one expert-parallel rank's share on one device
    (``cfg.experts_held`` of the experts, ``cfg.expert_rank``'s in the
    cyclic placement): routed over all experts, only the (token, held
    expert) pairs computed, grouped by expert, with no capacity; the
    other ranks' experts and the exchange are left out;
  * ``moe_block_spmd`` -- one rank's part on a mesh: two-level grouping
    (destination-shard buckets, then local-expert buckets) and a pair of
    model-group all-to-alls, every buffer capacity-bounded;
  * ``moe_block_spmd_emulated`` -- the whole mesh's function, drops
    included, in one process (the tests' and the card check's reference).

On a mesh the stored expert stack is this rank's block of the cyclic
physical order, ``[E/M, D/dp, F]`` (``w_down``: ``[E/M, F/dp, D]``; the
rules' ``P(model, dp, None)``); dim 1 is all-gathered over the data group
per use, and its gradient reduce-scattered back (the experts' whole
data-parallel sum).  The shared experts are a tensor-parallel MLP on the
replicated hidden.  The all-to-alls carry gradients back the same way,
the router's gradient is summed over the model ranks (each routes its
own tokens), and the load-balance loss is the single device's, of the
whole batch (``aux_stats`` summed over the world).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (MLP, all_to_all, apply_mlp, block,
                                       dtype_of, full_shape, gather_dim,
                                       mesh_sum, model_copy, normal_, param)
from repro_torch.obs import marks
from repro_torch.sharding.specs import SINGLE, MeshCtx


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Experts(nn.Module):
    """Per-expert SwiGLU weights, stacked over the expert axis (on a mesh:
    this rank's ``[E/M, D/dp, F]`` block of the cyclic order)."""

    def __init__(self, e: int, d: int, fe: int, dtype, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__()
        el = block(e, ctx.model_size, "experts")
        dp = ctx.dp_size
        self.w_gate = param((el, block(d, dp, "expert d_model"), fe), dtype,
                            device, full=(e, d, fe))
        self.w_up = param((el, block(d, dp, "expert d_model"), fe), dtype,
                          device, full=(e, d, fe))
        self.w_down = param((el, block(fe, dp, "expert d_ff"), d), dtype,
                            device, full=(e, fe, d))

    def reset_parameters(self, g: torch.Generator) -> None:
        _, d, fe = full_shape(self.w_gate)
        normal_(self.w_gate, d ** -0.5, g)
        normal_(self.w_up, d ** -0.5, g)
        normal_(self.w_down, fe ** -0.5, g)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        fe = cfg.moe_d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        self.cfg, self.ctx = cfg, ctx
        # the capacity factor of the expert-parallel path (the config's,
        # unless a caller sets another); ``drops`` adds up the (dropped,
        # routed) (token, expert) pairs of this rank's calls
        self.capacity_factor = cfg.capacity_factor
        self.drops = (0, 0)
        self.count_drops = True        # off while remat recomputes a layer
        self.last_routed = None
        self.router = param((d, e), torch.float32, device)
        held = cfg.held_experts_
        if held != e and ctx.mesh is not None:
            raise ValueError(f"{held} of {e} experts held: a share is a "
                             "single device's (no mesh)")
        self.experts = Experts(held, d, fe, dt, device, ctx=ctx)
        if cfg.num_shared_experts > 0:
            self.shared = MLP(d, fe * cfg.num_shared_experts, dt, device,
                              ctx=ctx)

    def reset_parameters(self, g: torch.Generator) -> None:
        normal_(self.router, self.router.shape[0] ** -0.5, g)
        self.experts.reset_parameters(g)
        if self.cfg.num_shared_experts > 0:
            self.shared.reset_parameters(g)

    def forward(self, x: torch.Tensor):
        return moe_block(self, x, self.cfg, self.ctx)


def _route(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
           router: Optional[torch.Tensor] = None):
    """Top-k routing.  x: [T, D] -> (gates [T,k], experts [T,k], the
    router's probabilities [T, E]); ``router`` is the router as this rank
    uses it (``moe.router`` by default).  Ties go to the lower expert id,
    as XLA's ``top_k`` breaks them (the expert-parallel path's padding
    rows are zeros, whose probabilities all tie, and they take buffer
    slots).  The gates are the top-k probabilities renormalised to sum
    to 1, or the raw probabilities where ``cfg.norm_topk_prob`` is off."""
    logits = x.to(torch.float32) @ (moe.router if router is None
                                    else router)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]
    if not cfg.norm_topk_prob:
        return vals, ids, probs
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return gates, ids, probs


def aux_stats(ids: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
              rows: int) -> torch.Tensor:
    """What the load-balance loss needs of the first ``rows`` rows (the
    rest are padding), as sums over rows: ``[E]`` routed (token, expert)
    counts, ``[E]`` router probabilities and the row count, ``[2E + 1]``
    float32 (summed over the ranks, they give the whole batch's loss)."""
    e = cfg.num_experts
    flat = ids[:rows].reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device))
    n = torch.full((1,), float(rows), dtype=torch.float32,
                   device=probs.device)
    return torch.cat([counts, probs[:rows].sum(0), n])


def aux_from_stats(stats: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The load-balance loss of the rows whose ``aux_stats`` were added."""
    e = cfg.num_experts
    n = stats[2 * e]
    frac = stats[:e] / (n * cfg.top_k)
    return e * torch.sum(frac * (stats[e:2 * e] / n))


def balance_loss(ids: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
                 seqs: int = 1) -> torch.Tensor:
    """The load-balance loss of ``ids [T, k]`` and ``probs [T, E]``, the
    rows ``seqs`` sequences of ``T / seqs`` tokens each: of the whole
    batch (``aux_stats``), or with ``cfg.seq_aux`` the mean over the
    sequences of each one's (DeepSeek-V2's expert-level balance loss:
    ``E / (S k) sum_i count_i P_i``, ``P_i`` its mean probability)."""
    if not cfg.seq_aux:
        return aux_from_stats(aux_stats(ids, probs, cfg, ids.shape[0]), cfg)
    e, k = cfg.num_experts, cfg.top_k
    s = ids.shape[0] // seqs
    counts = torch.zeros((seqs, e), dtype=torch.float32,
                         device=probs.device).scatter_add_(
        1, ids.reshape(seqs, s * k),
        torch.ones((seqs, s * k), dtype=torch.float32, device=probs.device))
    frac = counts / (s * k)
    return e * torch.sum(frac * probs.reshape(seqs, s, e).mean(1)) / seqs


def moe_block_dense(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                    seqs: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, D], ``seqs`` sequences.  Exact MoE (no capacity drops);
    O(E) compute."""
    gates, ids, probs = _route(moe, x, cfg)
    aux = balance_loss(ids, probs, cfg, seqs)
    t = x.shape[0]
    # [T, E] combined gate per expert
    gate_e = torch.zeros((t, cfg.num_experts), dtype=x.dtype,
                         device=x.device).scatter_add_(1, ids,
                                                       gates.to(x.dtype))
    we = moe.experts
    h = torch.einsum("td,edf->tef", x, we.w_gate)
    u = torch.einsum("td,edf->tef", x, we.w_up)
    y = torch.einsum("tef,efd->ted", F.silu(h) * u, we.w_down)
    out = torch.einsum("ted,te->td", y, gate_e)
    if cfg.num_shared_experts > 0:
        out = out + moe.shared(x, cfg.act)
    return out, aux


def held_pairs(ids: torch.Tensor, cfg: ModelConfig):
    """The (token, expert) pairs of ``ids [T, k]`` whose expert this
    device holds (``e = rank (mod E / held)``, local index ``e div (E /
    held)``), grouped by local expert, in token order within each.
    Returns the pairs' flat indices into ``ids`` and each held expert's
    count, a host list: the one wait of the path."""
    held = cfg.held_experts_
    m = cfg.num_experts // held
    flat = ids.reshape(-1)
    local = torch.where(flat % m == cfg.expert_rank, flat // m, held)
    counts = torch.bincount(local, minlength=held + 1)[:held].tolist()
    order = torch.argsort(local, stable=True)
    return order[:sum(counts)], counts


def moe_block_held(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                   seqs: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, D], ``seqs`` sequences.  This device's share of the MoE: the
    router's ``E`` float32 outputs and top-k over all of them, then only
    the pairs of the held experts (``held_pairs``), each held expert's
    SwiGLU on its own rows (one product an expert, no capacity, nothing
    dropped or padded), the rows times their gates added back into their
    tokens in float32, rounded once, and the shared experts added.  With
    every expert held it is ``moe_block_dense``'s function.  Returns
    ``(y, aux)``, the balance loss over all ``E`` experts."""
    t, d = x.shape
    k = cfg.top_k
    with marks.span("lm.moe.route"):
        gates, ids, probs = _route(moe, x, cfg)
        aux = balance_loss(ids, probs, cfg, seqs)
        pairs, counts = held_pairs(ids, cfg)
        tok = pairs // k
        rows = x[tok]
    marks.held(counts)
    we = moe.experts
    with marks.span("lm.moe.experts"):
        ys = [_expert_ffn(we.w_gate[j], we.w_up[j], we.w_down[j], r)
              for j, r in enumerate(torch.split(rows, counts)) if len(r)]
        shared = (apply_mlp(moe.shared, x, cfg.act)
                  if cfg.num_shared_experts > 0 else None)
    with marks.span("lm.moe.combine"):
        g = gates.reshape(-1)[pairs].to(torch.float32)
        out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        if ys:
            out = out.index_add(0, tok, torch.cat(ys).to(torch.float32)
                                * g[:, None])
        out = out.to(x.dtype)
        moe.last_routed = out.detach()
        if shared is not None:
            out = out + shared
    return out, aux


# ---------------------------------------------------------------------------
# Expert-parallel path: one rank's three phases
# ---------------------------------------------------------------------------

def _group_by(dst: torch.Tensor, num_groups: int, capacity: int):
    """Each row's slot within its destination group: the count of earlier
    rows with the same destination (token order).  Returns (pos [R],
    keep [R] bool); rows past a group's capacity are dropped -- the bounded
    buffer of paper section 3.3."""
    oh = F.one_hot(dst.to(torch.int64), num_groups).to(torch.int32)
    pos = torch.gather(torch.cumsum(oh, dim=0) - 1, 1,
                       dst.to(torch.int64)[:, None])[:, 0]
    return pos, pos < capacity


class _Sent(NamedTuple):
    """What a rank keeps from its push for the combine."""
    gates: torch.Tensor        # [t, k] float32
    tok_idx: torch.Tensor      # [t*k] token of each (token, expert) pair
    slot: torch.Tensor         # [t*k] its row in the send buffer
    keep: torch.Tensor         # [t*k] it fit its destination's capacity
    cap1: int
    ids: torch.Tensor          # [t, k] the experts
    probs: torch.Tensor        # [t, E] the router's probabilities


def _cap1(t: int, cfg: ModelConfig, m: int, cf: float) -> int:
    """The reference's capacity per destination shard."""
    return _round_up(int(t * cfg.top_k / m * cf) + 1, 8)


def _cap2(cap1: int, cfg: ModelConfig, m: int, cf: float) -> int:
    """The reference's capacity per local expert."""
    return _round_up(int(m * cap1 / max(cfg.num_experts // m, 1) * cf) + 1,
                     8)


def moe_dispatch(moe: MoE, x_loc: torch.Tensor, cfg: ModelConfig, m: int,
                 cf: float, router: Optional[torch.Tensor] = None):
    """Level 1: route this rank's ``t`` tokens and bucket the (token,
    expert) pairs by destination shard ``e mod m``.  Returns the send
    buffer ``[m * cap1, d + 1]`` (the activations plus the local-expert id
    ``e div m`` in channel ``d``, in the activation dtype; -1 marks an
    empty slot) and what the combine needs.  ``router``: the router as
    this rank uses it (``moe.router`` by default)."""
    t, d = x_loc.shape
    k = cfg.top_k
    gates, ids, probs = _route(moe, x_loc, cfg, router)
    flat_e = ids.reshape(t * k)
    tok_idx = torch.arange(t, device=x_loc.device).repeat_interleave(k)
    dst = flat_e % m                       # cyclic placement (paper 2.2)
    le = flat_e // m                       # local expert id at dst
    cap1 = _cap1(t, cfg, m, cf)
    pos1, keep1 = _group_by(dst, m, cap1)
    slot = dst * cap1 + torch.where(keep1, pos1, m * cap1)  # overflow: drop
    payload = torch.cat([x_loc[tok_idx], le.to(x_loc.dtype)[:, None]], -1)
    send = x_loc.new_zeros((m * cap1 + 1, d + 1))
    send[slot[keep1]] = payload[keep1]
    filled = torch.zeros(m * cap1 + 1, dtype=torch.bool, device=x_loc.device)
    filled[slot[keep1]] = True
    send = send[:m * cap1]
    send[:, d] = torch.where(filled[:m * cap1], send[:, d],
                             torch.full((), -1.0, dtype=send.dtype,
                                        device=send.device))
    return send, _Sent(gates, tok_idx, slot, keep1, cap1, ids, probs)


def _expert_ffn(w_gate, w_up, w_down, xg: torch.Tensor) -> torch.Tensor:
    """xg: [E_local, C, D] -> [E_local, C, D] (per-expert SwiGLU); or one
    expert's ``[C, D]`` rows with its ``[D, F]`` weights."""
    mm = torch.bmm if xg.dim() == 3 else torch.matmul
    return mm(F.silu(mm(xg, w_gate)) * mm(xg, w_up), w_down)


def moe_experts(recv: torch.Tensor, we, cfg: ModelConfig, m: int,
                cf: float):
    """Level 2: bucket the received rows by local expert, run each local
    expert on its bucket, and return the rows in the order received
    (dropped and empty rows zero) and the count of rows this level drops.
    ``we``: this rank's ``(w_gate, w_up, w_down)``, ``[E/m, D, F]``."""
    d = recv.shape[1] - 1
    e_local = cfg.num_experts // m
    cap2 = _cap2(recv.shape[0] // m, cfg, m, cf)
    rx, rle = recv[:, :d], recv[:, d].to(torch.int32)
    valid = rle >= 0
    le2 = torch.where(valid, rle, 0)
    pos2, keep2 = _group_by(le2, e_local, cap2)
    keep2 = keep2 & valid
    slot2 = le2 * cap2 + torch.where(keep2, pos2, e_local * cap2)
    xg = recv.new_zeros((e_local * cap2 + 1, d))
    xg[slot2[keep2].to(torch.int64)] = rx[keep2]
    yg = _expert_ffn(*we, xg[:-1].view(e_local, cap2, d)).reshape(
        e_local * cap2, d)
    rows = yg[slot2.clamp(max=e_local * cap2 - 1).to(torch.int64)]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return torch.where(keep2[:, None], rows, zero), \
        int((valid & ~keep2).sum())


def moe_combine(back: torch.Tensor, sent: _Sent, x_loc: torch.Tensor,
                k: int) -> torch.Tensor:
    """The pulled rows times their gates (the gates rounded to the
    activation dtype, as the dense path's), added into each token in
    expert order in float32 and rounded once: the dense path's gate-
    weighted sum up to float32 order (the reference adds the products
    into the activation dtype; in float32 the two are the same)."""
    m_cap = back.shape[0]
    rows = back[sent.slot.clamp(max=m_cap - 1)]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    rows = torch.where(sent.keep[:, None], rows, zero)
    gates = sent.gates.to(x_loc.dtype).to(torch.float32).reshape(-1, 1)
    vals = (rows.to(torch.float32) * gates).view(x_loc.shape[0], k, -1)
    out = torch.zeros(x_loc.shape, dtype=torch.float32, device=x_loc.device)
    for j in range(k):
        out = out + vals[:, j]
    return out.to(x_loc.dtype)


def _expert_weights(moe: MoE) -> tuple:
    """This rank's expert stack, dim 1 all-gathered over the data group
    (ZeRO storage, gathered per use).  Each data row computes with them on
    its own tokens, so the backward reduce-scatters their gradient over
    the data group: that is these leaves' whole data-parallel sum."""
    we = moe.experts
    comm = moe.ctx.comm
    w = (we.w_gate, we.w_up, we.w_down)
    if comm is None or comm.data == 1:
        return w
    return tuple(gather_dim(t, comm, "data", 1, "experts", False)
                 for t in w)


def moe_block_spmd(moe: MoE, x_loc: torch.Tensor, cfg: ModelConfig,
                   ctx: MeshCtx, rows: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's routed experts on its ``t`` tokens ``x_loc [t, D]``:
    push to the owners (model all-to-all), the local experts, pull back
    (the reverse all-to-all), combine; the all-to-alls carry gradients
    back the same way.  Returns ``(y [t, D], aux)``: ``aux`` is the
    single device's load-balance loss of the whole batch (every rank's
    ``aux_stats`` of its first ``rows`` rows, the real ones, added over
    the world; the gradient of the sum passes through).  The shared
    experts are not in ``y`` (``moe_block`` adds them)."""
    comm = ctx.comm
    m, cf = ctx.model_size, moe.capacity_factor
    # the router sees this rank's tokens alone: its gradient is partial
    router = model_copy(moe.router, ctx, "router")
    send, sent = moe_dispatch(moe, x_loc, cfg, m, cf, router)
    recv = all_to_all(send, comm, "model", "moe_push")
    out, drop2 = moe_experts(recv, _expert_weights(moe), cfg, m, cf)
    back = all_to_all(out, comm, "model", "moe_pull")
    y = moe_combine(back, sent, x_loc, cfg.top_k)
    if moe.count_drops:
        moe.drops = (moe.drops[0] + int((~sent.keep).sum()) + drop2,
                     moe.drops[1] + sent.keep.numel())
    stats = aux_stats(sent.ids, sent.probs, cfg,
                      x_loc.shape[0] if rows is None else rows)
    return y, aux_from_stats(mesh_sum(stats, comm, ("data", "model"),
                                      "moe_aux"), cfg)


def moe_block(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[MeshCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, D] in/out (on a mesh: this rank's batch slice, replicated
    over the model axis).  Without a mesh the dense path.  On a mesh, the
    reference's dispatch: the flat tokens of the whole batch padded to a
    multiple of the world size, rank ``r`` taking rows ``[r t, (r+1) t)``;
    after the pull an all-gather over the model group rebuilds the
    replicated hidden.  Where this data row's tokens do not split over the
    model ranks (a decode batch smaller than the model axis), the rank's
    rows cross data rows: the tokens are all-gathered over the data axis
    first and the output over the world after.  Without a mesh, a device
    that holds a share of the experts runs ``moe_block_held``."""
    b, s, d = x.shape
    ctx = ctx if ctx is not None else moe.ctx
    comm = ctx.comm if ctx is not None else None
    if comm is None:
        block_fn = (moe_block_held if cfg.held_experts_ != cfg.num_experts
                    else moe_block_dense)
        y, aux = block_fn(moe, x.reshape(b * s, d), cfg, b)
        return y.reshape(b, s, d), aux
    flat = x.reshape(b * s, d)
    m = comm.model
    if (b * s) % m == 0:
        t = b * s // m
        i = comm.model_idx
        x_loc = model_copy(flat, ctx, "moe_in")[i * t:(i + 1) * t]
        y_loc, aux = moe_block_spmd(moe, x_loc, cfg, ctx)
        y = gather_dim(y_loc, comm, "model", 0, "moe_gather", True)
    else:
        if torch.is_grad_enabled():
            raise ValueError(
                f"{b * s} tokens a data row do not split over {m} model "
                "ranks: the rows that cross data rows (decode) have no "
                "backward")
        glob = comm.all_gather(flat, "data", tag="moe_gather")
        total = glob.shape[0]
        tpad = _round_up(total, comm.world)
        glob = F.pad(glob, (0, 0, 0, tpad - total))
        t = tpad // comm.world
        r = comm.rank
        y_loc, aux = moe_block_spmd(moe, glob[r * t:(r + 1) * t], cfg, ctx,
                                    rows=min(max(total - r * t, 0), t))
        y_all = comm.all_gather(y_loc, ("data", "model"),
                                tag="moe_gather")[:total]
        j = comm.data_idx
        y = y_all[j * b * s:(j + 1) * b * s]
    moe.last_routed = y.detach()       # the routed part, for the checks
    if cfg.num_shared_experts > 0:
        y = y + apply_mlp(moe.shared, flat, cfg.act)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# The whole mesh in one process
# ---------------------------------------------------------------------------

class EmulatedMoE(NamedTuple):
    y: torch.Tensor            # [B, S, D]: routed (+ shared) output
    aux: torch.Tensor          # the whole batch's (the port's mesh's)
    aux_mean: torch.Tensor     # the ranks' own, averaged (the reference's)
    routed: List[torch.Tensor]  # each rank's routed rows [t, D]
    dropped: int               # (token, expert) pairs dropped, both levels
    pairs: int                 # (token, expert) pairs routed


def moe_block_spmd_emulated(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                            dp: int, m: int,
                            capacity_factor: Optional[float] = None,
                            shared: bool = True) -> EmulatedMoE:
    """The function a ``dp x m`` mesh computes, drops included, in one
    process: ``moe`` holds the single-device (logical) weights, ``x`` the
    whole batch ``[B, S, D]``.  Every rank's phases run in turn with the
    same operations as ``moe_block_spmd``; the all-to-alls become
    re-slicings.  ``aux`` is the port's mesh's (the whole batch's load
    balance, the single device's); ``aux_mean`` the reference mesh's
    (each rank's over its rows, padding included, averaged)."""
    b, s, d = x.shape
    world = dp * m
    cf = moe.capacity_factor if capacity_factor is None else capacity_factor
    flat = x.reshape(b * s, d)
    total = b * s
    tpad = _round_up(total, world)
    glob = F.pad(flat, (0, 0, 0, tpad - total))
    t = tpad // world
    sends, sents = [], []
    for r in range(world):
        send, sent = moe_dispatch(moe, glob[r * t:(r + 1) * t], cfg, m, cf)
        sends.append(send)
        sents.append(sent)
    cap1 = sents[0].cap1
    we = moe.experts
    rows, dropped = [], 0
    for r in range(world):
        row, j = divmod(r, m)
        recv = torch.cat([sends[row * m + i][j * cap1:(j + 1) * cap1]
                          for i in range(m)])
        mine = (we.w_gate[j::m], we.w_up[j::m], we.w_down[j::m])
        out, drop2 = moe_experts(recv, mine, cfg, m, cf)
        rows.append(out)
        dropped += drop2
    routed = []
    for r in range(world):
        row, i = divmod(r, m)
        back = torch.cat([rows[row * m + j][i * cap1:(i + 1) * cap1]
                          for j in range(m)])
        routed.append(moe_combine(back, sents[r], glob[r * t:(r + 1) * t],
                                  cfg.top_k))
        dropped += int((~sents[r].keep).sum())
    y = torch.cat(routed)[:total]
    if shared and cfg.num_shared_experts > 0:
        y = y + apply_mlp(moe.shared, flat, cfg.act)
    aux = aux_from_stats(sum(
        aux_stats(st.ids, st.probs, cfg, min(max(total - r * t, 0), t))
        for r, st in enumerate(sents)), cfg)
    aux_mean = torch.stack([aux_from_stats(aux_stats(st.ids, st.probs, cfg,
                                                     t), cfg)
                            for st in sents]).sum() / world
    return EmulatedMoE(y.reshape(b, s, d), aux, aux_mean, routed, dropped,
                       sum(st.keep.numel() for st in sents))
