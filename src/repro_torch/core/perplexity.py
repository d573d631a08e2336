"""Held-out perplexity (paper Table 1 / Figure 6), in PyTorch.

The point estimates shared by every algorithm:

  θ_dk = (n_dk + α) / (N_d + Kα)        φ_wk = (n_wk + β) / (n_k + Vβ)

  perplexity = exp( - Σ_i log Σ_k θ_{d_i,k} φ_{w_i,k} / N )

Held-out documents are scored by *fold-in*: half of each document's tokens
estimate θ_d (with φ frozen), the other half are scored.
"""
from __future__ import annotations

import torch

# log_likelihood forms the [N, K] gathered rows this many elements at a time
_CHUNK_ELEMS = 1 << 26


def theta_from_counts(ndk: torch.Tensor, alpha: float) -> torch.Tensor:
    k = ndk.shape[-1]
    nd = ndk.sum(-1, keepdim=True)
    return (ndk + alpha) / (nd + k * alpha)


def phi_from_counts(nwk: torch.Tensor, nk: torch.Tensor,
                    beta: float) -> torch.Tensor:
    v = nwk.shape[0]
    return (nwk + beta) / (nk[None, :] + v * beta)


def log_likelihood(w: torch.Tensor, d: torch.Tensor, valid: torch.Tensor,
                   theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Σ_i log p(w_i | θ_{d_i}, φ) over valid tokens.  The [N, K] gathered
    rows are formed ``_CHUNK_ELEMS`` elements at a time (256 MB of float32),
    so a corpus of millions of tokens at K = 1000 fits beside the model."""
    step = max(1, _CHUNK_ELEMS // max(phi.shape[1], 1))
    total = torch.zeros((), dtype=torch.float32, device=phi.device)
    for lo in range(0, w.shape[0], step):
        sl = slice(lo, lo + step)
        p = (theta[d[sl].long()] * phi[w[sl].long()]).sum(-1)
        logp = torch.log(torch.clamp_min(p, 1e-30))
        total = total + torch.where(valid[sl], logp,
                                    torch.zeros_like(logp)).sum()
    return total


def fold_in_theta(w: torch.Tensor, d: torch.Tensor, valid: torch.Tensor,
                  phi: torch.Tensor, num_docs: int, alpha: float,
                  num_iters: int = 20) -> torch.Tensor:
    """Estimate θ for held-out docs with φ frozen (EM on responsibilities)."""
    k = phi.shape[1]
    d = d.long()
    ndk = torch.ones((num_docs, k), dtype=torch.float32, device=phi.device)
    phi_rows = phi[w.long()]                                  # [N, K]
    wgt = valid.to(torch.float32)[:, None]
    for _ in range(num_iters):
        theta = theta_from_counts(ndk, alpha)
        resp = theta[d] * phi_rows
        resp = resp / torch.clamp_min(resp.sum(-1, keepdim=True), 1e-30)
        ndk = torch.zeros_like(ndk).index_add_(0, d, resp * wgt)
    return theta_from_counts(ndk, alpha)


def heldout_perplexity(fold_w, fold_d, fold_valid, eval_w, eval_d, eval_valid,
                       phi, num_docs: int, alpha: float) -> torch.Tensor:
    """Fold-in on one half of each held-out doc, score the other half."""
    theta = fold_in_theta(fold_w, fold_d, fold_valid, phi, num_docs, alpha)
    ll = log_likelihood(eval_w, eval_d, eval_valid, theta, phi)
    n = torch.clamp_min(eval_valid.sum(), 1)
    return torch.exp(-ll / n)


def training_perplexity(w, d, valid, ndk, nwk_dense, nk,
                        alpha: float, beta: float) -> torch.Tensor:
    """In-sample perplexity (what paper Fig. 6 tracks over wall-time)."""
    theta = theta_from_counts(ndk.to(torch.float32), alpha)
    phi = phi_from_counts(nwk_dense.to(torch.float32),
                          nk.to(torch.float32), beta)
    ll = log_likelihood(w, d, valid, theta, phi)
    n = torch.clamp_min(valid.sum(), 1)
    return torch.exp(-ll / n)


def stream_training_perplexity(reader, nwk_dense, nk, alpha: float,
                               beta: float, device=None) -> float:
    """In-sample perplexity over a whole sharded stream, on ``device``
    (the card unless the caller passes another).

    ``phi`` comes from the global count tables (numpy or tensors); each
    shard contributes its log-likelihood with ``theta`` rebuilt from the
    shard's persisted assignments -- the same "assignments are data, counts
    are derived" discipline the streamed trainer uses.  One pass, one shard
    resident at a time; this is how planes without a resident
    ``SamplerState`` (the network plane) evaluate.
    """
    import numpy as np

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    phi = phi_from_counts(torch.as_tensor(nwk_dense).to(dev, torch.float32),
                          torch.as_tensor(nk).to(dev, torch.float32), beta)
    k = phi.shape[1]
    meta = reader.meta
    pos = np.arange(meta.tokens_per_shard)
    total_ll, total_n = 0.0, 0
    for sid in range(meta.num_shards):
        shard = reader.shard(sid)
        if shard.z is None:
            raise FileNotFoundError(f"shard {sid} has no z file")
        valid_np = pos < shard.n_tokens
        d = np.asarray(shard.d)
        ndk = np.zeros((meta.doc_cap, k), np.int32)
        np.add.at(ndk, (d, np.asarray(shard.z)), valid_np.astype(np.int32))
        theta = theta_from_counts(torch.from_numpy(ndk).to(dev,
                                                           torch.float32),
                                  alpha)
        ll = log_likelihood(*(torch.as_tensor(np.array(x), device=dev)
                              for x in (shard.w, d, valid_np)), theta, phi)
        total_ll += float(ll)
        total_n += int(shard.n_tokens)
    return float(np.exp(-total_ll / max(total_n, 1)))
