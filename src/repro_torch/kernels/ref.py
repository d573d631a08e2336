"""Plain PyTorch versions of the hand-written kernels (the ``ref.py``
contract): the same functions, on the same arguments, written as tensor
code.  The CPU path runs them; on the card they are what each kernel is
held against."""
from __future__ import annotations

import torch

from repro_torch import rng as jrng
from repro_torch.core import alias as alias_mod
from repro_torch.core import lightlda as lda


def mh_sample_ref(rng: "lda.MHRandoms", z0, w, d, nwk, ndk, nk, aprob,
                  aalias, cfg: "lda.LDAConfig",
                  frozen: bool = False) -> torch.Tensor:
    """Plain version of ``kernels/mh_sample.py``: gather each token's rows
    by index, then run the vectorised MH chain."""
    wl, dl = w.long(), d.long()
    return lda.mh_chain(rng, z0, nwk[wl], ndk[dl], nk, aprob[wl], aalias[wl],
                        cfg, frozen=frozen)


def mh_draws_train_ref(key: torch.Tensor, d_b, z_snapshot, doc_start,
                       doc_len, batch: int,
                       cfg: "lda.LDAConfig") -> "lda.MHRandoms":
    """Plain version of ``kernels/mh_draws.py::mh_draws_train_cuda``: the
    eager composition ``draw_mh_randoms(key, make_doc_draw(...))``."""
    doc_draw = lda.make_doc_draw(d_b, z_snapshot, doc_start, doc_len, cfg)
    return lda.draw_mh_randoms(key, doc_draw, batch, cfg)


def mh_draws_foldin_ref(doc_keys: torch.Tensor, sweep: int, z, nd,
                        cfg: "lda.LDAConfig") -> "lda.MHRandoms":
    """Plain version of ``kernels/mh_draws.py::mh_draws_foldin_cuda``:
    ``infer.foldin._doc_randoms`` at ``fold_in(doc_keys, sweep)``, its
    [B, S, L] arrays laid out as [S, B*L]."""
    from repro_torch.infer.foldin import _doc_randoms

    b, l = z.shape
    return lda.MHRandoms(*(
        r.transpose(0, 1).reshape(cfg.mh_steps, b * l).contiguous()
        for r in _doc_randoms(jrng.fold_in(doc_keys, sweep), z, nd, cfg)))


def alias_build_ref(weights: torch.Tensor) -> "alias_mod.AliasTable":
    """Plain version of ``kernels/alias_build.py``: Vose construction; the
    kernel's tables equal these bitwise."""
    return alias_mod.build_alias_rows(weights)


def _in_range(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >= 0) & (x < n)


def delta_push_ref(rows, z_old, z_new, changed, num_rows: int,
                   num_topics: int, out=None, docs=None, ndk_out=None,
                   nk_out=None) -> torch.Tensor:
    """Plain version of ``kernels/delta_push.py::delta_push_cuda``: for
    changed tokens, -1 at ``z_old`` and +1 at ``z_new`` by one
    ``index_put_`` with accumulate per destination -- ``out`` [num_rows, K]
    int32 (zeros if None) at ``rows``, ``ndk_out`` [D, K] at ``docs`` and
    ``nk_out`` [K], each when given.  Rows and topics outside a
    destination add nothing there.  Returns ``out``."""
    if out is None:
        out = torch.zeros((num_rows, num_topics), dtype=torch.int32,
                          device=rows.device)
    m = (changed != 0).to(torch.int32)
    cols, vals = torch.cat([z_old, z_new]), torch.cat([-m, m])
    delta_apply_coo_ref(torch.cat([rows, rows]), cols, vals, num_rows,
                        num_topics, out=out)
    if ndk_out is not None:
        delta_apply_coo_ref(torch.cat([docs, docs]), cols, vals,
                            ndk_out.shape[0], num_topics, out=ndk_out)
    if nk_out is not None:
        delta_apply_coo_ref(torch.zeros_like(cols), cols, vals, 1,
                            num_topics, out=nk_out.view(1, num_topics))
    return out


def delta_apply_coo_ref(rows, cols, vals, num_rows: int, num_topics: int,
                        out=None) -> torch.Tensor:
    """Plain version of ``kernels/delta_push.py::delta_apply_coo_cuda``:
    ``vals`` added at ``(rows, cols)`` into ``out`` [num_rows, K] int32
    (zeros if None) by one ``index_put_`` with accumulate; value-0 padding
    and entries outside the matrix add nothing."""
    if out is None:
        out = torch.zeros((num_rows, num_topics), dtype=torch.int32,
                          device=rows.device)
    ok = _in_range(rows, num_rows) & _in_range(cols, num_topics)
    flat = (torch.where(ok, rows, 0).long() * num_topics
            + torch.where(ok, cols, 0).long())
    vals = torch.where(ok, vals.to(torch.int32), 0)
    out.view(-1).index_put_((flat,), vals, accumulate=True)
    return out
