"""The SPMD parameter server on the in-memory corpus: the port's ranks (4
gloo processes, one intra-op thread each, mesh 2 x 2 or 4 x 1) against the
JAX package's SPMD plane under 4 forced host devices.

The JAX side runs once per module, in a subprocess started by this file
itself (``python test_torch_spmd.py --jax-ref out.npz`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, which must be set
before jax is imported); it writes every reference case to one npz.  The
port's rank programs for the collective and carried-sweep cases run the
same way (``--rank R``).  Held bitwise: ``shard_tokens``, the collectives
and ``SpmdBackend``'s four moments against their numpy definitions,
``init_distributed_state``, one ``make_spmd_sweep`` from a carried JAX
state (z, n_dk, n_wk, n_k), and whole SPMD fits for the dense, hybrid and
COO routes at staleness 0 and 1 and mesh_model 1 and 2 (physical n_wk and
n_k).  The perplexity history is held within rtol 1e-5 of the JAX
package's ``training_perplexity`` on host copies of the JAX run (the JAX
plane's own perplexity raises on its model-sharded table).
"""
import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
W, K, BLOCK, SWEEPS, SEED = 4, 8, 256, 3, 3
CORPUS = dict(num_docs=60, vocab_size=200, true_topics=5, seed=1)
# (name, job knobs, mesh_model): dense / hybrid / COO, staleness 0 and 1,
# mesh_model 1 and 2
PLANE_CASES = [
    ("dense_s0_m2", {}, 2),
    ("dense_s1_m1", {"staleness": 1}, 1),
    ("hot_s1_m2", {"hot_words": 64, "staleness": 1}, 2),
    ("hot_s0_m1", {"hot_words": 64}, 1),
    ("coo_s0_m2", {"hot_words": 0}, 2),
    ("coo_s1_m2", {"hot_words": 0, "staleness": 1}, 2),
]
PPL_CASE = "hot_s1_m2"
CARRY = dict(init_seed=5, key_seed=11, staleness=1, hot_words=64, model=2)
QUIET = dict(log_fn=lambda *a: None)


def _env(**extra) -> dict:
    path = os.pathsep.join(p for p in (str(SRC), os.environ.get(
        "PYTHONPATH", "")) if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **extra)


def _case(name):
    return next(c for c in PLANE_CASES if c[0] == name)


# ---------------------------------------------------------------------------
# The JAX reference (run as a subprocess under 4 forced host devices).
# ---------------------------------------------------------------------------

def _jax_reference(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import api, ps
    from repro.api.session import init_distributed_state, make_spmd_sweep
    from repro.core import lightlda as lda
    from repro.core import perplexity as ppl
    from repro.data.corpus import synthetic_corpus

    assert jax.device_count() == W, jax.device_count()
    corp = synthetic_corpus(**CORPUS)
    res = {}
    for name, kw, mm in PLANE_CASES:
        job = api.LDAJob(corpus=corp, num_topics=K, block_tokens=BLOCK,
                         sweeps=SWEEPS, eval_every=0, backend="spmd",
                         mesh_model=mm, seed=SEED, **kw)
        r = api.Session(job, **QUIET).run()
        res[f"{name}__nwk"] = np.asarray(r.nwk.value)
        res[f"{name}__nk"] = np.asarray(r.nk.value)

    def host(x):
        return jnp.asarray(np.asarray(x))

    # the plane's loop by hand, with training_perplexity on host copies
    _, kw, mm = _case(PPL_CASE)
    cfg = lda.LDAConfig(num_topics=K, vocab_size=corp.vocab_size,
                        block_tokens=BLOCK, num_shards=mm)
    mesh = jax.make_mesh((W // mm, mm), ("data", "model"))
    key = jax.random.PRNGKey(SEED)
    w, d, valid, ds, dl, z, ndk, nwk, nk = init_distributed_state(
        corp, cfg, W, key)
    fn = jax.jit(make_spmd_sweep(
        mesh, cfg, staleness=kw.get("staleness", 0),
        route=ps.route_for(kw.get("hot_words"), cfg.V)))
    nwk_val, dmax, hist = nwk.value, ndk.shape[1], []
    for _ in range(SWEEPS):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, W)
        z, ndk, nwk_val, nk = fn(w, d, z, valid, ds, dl, ndk, nwk_val, nk,
                                 keys)
        full = ps.client_for(cfg).wrap_matrix(host(nwk_val),
                                              cfg.V).to_dense()
        hist.append(float(ppl.training_perplexity(
            host(w).reshape(-1),
            (host(d) + jnp.arange(W)[:, None] * dmax).reshape(-1),
            host(valid).reshape(-1), host(ndk).reshape(W * dmax, K), full,
            host(nk), cfg.alpha, cfg.beta)))
    res["ppl__history"] = np.asarray(hist)
    res["ppl__nwk"] = np.asarray(nwk_val)

    # one carried sweep from init_distributed_state
    mm = CARRY["model"]
    cfg = lda.LDAConfig(num_topics=K, vocab_size=corp.vocab_size,
                        block_tokens=BLOCK, num_shards=mm)
    mesh = jax.make_mesh((W // mm, mm), ("data", "model"))
    state = init_distributed_state(corp, cfg, W,
                                   jax.random.PRNGKey(CARRY["init_seed"]))
    names = ("w", "d", "valid", "doc_start", "doc_len", "z", "ndk")
    for n, x in zip(names, state[:7]):
        res[f"in__{n}"] = np.asarray(x)
    res["in__nwk"] = np.asarray(state[7].value)
    res["in__nk"] = np.asarray(state[8])
    keys = jax.random.split(jax.random.PRNGKey(CARRY["key_seed"]), W)
    res["in__keys"] = np.asarray(keys)
    res["cfg"] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
    fn = jax.jit(make_spmd_sweep(
        mesh, cfg, staleness=CARRY["staleness"],
        route=ps.HybridRoute(hot_words=CARRY["hot_words"])))
    w, d, valid, ds, dl, z, ndk, nwk, nk = state
    out_z, out_ndk, out_nwk, out_nk = fn(w, d, z, valid, ds, dl, ndk,
                                         nwk.value, nk, keys)
    for n, x in (("z", out_z), ("ndk", out_ndk), ("nwk", out_nwk),
                 ("nk", out_nk)):
        res[f"out__{n}"] = np.asarray(x)
    np.savez(out, **res)


@pytest.fixture(scope="module", autouse=True)
def jax_ref_proc(tmp_path_factory):
    """Start the JAX reference at once, so the port-only tests run while
    it compiles."""
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE), "--jax-ref", str(out)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)
    log.close()


@pytest.fixture(scope="module")
def jax_ref(jax_ref_proc):
    proc, out = jax_ref_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, out.with_suffix(".log").read_text()[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Rank programs for the collective and carried-sweep cases.
# ---------------------------------------------------------------------------

def _rank_main(args) -> None:
    import torch

    from repro_torch.launch.mesh import Mesh

    torch.set_num_threads(1)
    data = W // args.model
    mesh = Mesh.init(args.rank, data, args.model, "gloo",
                     torch.device("cpu"),
                     os.path.join(args.run_dir, "store"), 60.0)
    try:
        out = (_rank_collectives(mesh) if args.case == "collectives"
               else _rank_carry(mesh, args.ref))
        np.savez(os.path.join(args.run_dir, f"out{args.rank}.npz"), **out)
    finally:
        mesh.close()


def _rank_inputs(rank: int):
    """Each rank's distinct inputs to the collectives."""
    i32 = np.int32
    return {"shard": (np.arange(3 * 5).reshape(3, 5) + 1000 * rank).astype(i32),
            "delta": (np.arange(6 * 5).reshape(6, 5) * (rank + 1)).astype(i32),
            "vec": (np.arange(7) * (rank + 1) - 3).astype(i32),
            "coo": (np.arange(3) + 10 * rank).astype(i32),
            "full": (np.arange(6 * 5).reshape(6, 5) + 7).astype(i32)}


def _rank_collectives(mesh) -> dict:
    import torch

    from repro_torch.core.pserver import (DistributedMatrix, spmd_pull_all,
                                          spmd_push_reduce)
    from repro_torch.ps import SpmdBackend

    x = {k: torch.from_numpy(v) for k, v in _rank_inputs(mesh.rank).items()}
    be = SpmdBackend(axis_name=("data", "model"), model_axis="model",
                     mesh=mesh)
    local = DistributedMatrix(x["shard"], num_rows=5, num_shards=mesh.model)
    full = DistributedMatrix(x["full"], num_rows=5, num_shards=mesh.model)
    out = {"pull": spmd_pull_all(x["shard"], "model", mesh=mesh),
           "push": spmd_push_reduce(x["delta"], "model", mesh=mesh),
           "pull_full": be.pull_full(local).value,
           "reduce": be.reduce(x["vec"]),
           "gather_concat": be.gather_concat(x["coo"]),
           "localize": be.localize(full).value,
           "coords": torch.tensor([mesh.rank, mesh.data_idx,
                                   mesh.model_idx])}
    return {k: v.numpy() for k, v in out.items()}


def _rank_carry(mesh, ref_path: str) -> dict:
    import torch

    from repro_torch import convert, ps
    from repro_torch.api.model import cfg_from_dict
    from repro_torch.api.session import make_spmd_sweep

    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    cfg_dict = json.loads(str(ref["cfg"]))
    names = ("w", "d", "valid", "doc_start", "doc_len", "z", "ndk", "nwk",
             "nk")
    st = convert.spmd_state_from_arrays(*(ref[f"in__{n}"] for n in names),
                                        cfg_dict, mesh)
    fn = make_spmd_sweep(mesh, cfg_from_dict(cfg_dict),
                         staleness=CARRY["staleness"],
                         route=ps.HybridRoute(hot_words=CARRY["hot_words"]))
    key = torch.from_numpy(ref["in__keys"][mesh.rank].astype(np.int64))
    z, ndk, nwk, nk = fn(st.w, st.d, st.z, st.valid, st.doc_start,
                         st.doc_len, st.ndk, st.nwk.value, st.nk.value, key)
    return {"z": z.numpy(), "ndk": ndk.numpy(), "nwk": nwk.numpy(),
            "nk": nk.numpy()}


def _run_ranks(tmp_path, case: str, model: int = 2, ref=None,
               timeout: float = 180.0) -> list:
    run = tmp_path / case
    run.mkdir()
    procs = []
    for r in range(W):
        log = open(run / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE), "--rank", str(r), "--model",
             str(model), "--run-dir", str(run), "--case", case,
             "--ref", str(ref or "")], env=_env(),
            stdin=subprocess.DEVNULL, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        for r, (p, log) in enumerate(procs):
            rc = p.wait(timeout=timeout)
            log.close()
            assert rc == 0, (run / f"rank{r}.log").read_text()[-4000:]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    out = []
    for r in range(W):
        with np.load(run / f"out{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards,block", [(4, 256), (3, 128), (80, 64)],
                         ids=["4x256", "3x128", "more_shards_than_docs"])
def test_shard_tokens_byte_equal(shards, block):
    from repro.data.corpus import shard_tokens as jshard
    from repro.data.corpus import synthetic_corpus as jcorpus
    from repro_torch.data.corpus import shard_tokens as tshard
    from repro_torch.data.corpus import synthetic_corpus as tcorpus

    jout = jshard(jcorpus(**CORPUS), shards, block)
    tout = tshard(tcorpus(**CORPUS), shards, block)
    assert len(tout) == len(jout) == shards
    for js, ts in zip(jout, tout):
        for ja, ta in zip(js, ts):
            assert ta.dtype == ja.dtype and ta.shape == ja.shape
            assert ta.tobytes() == ja.tobytes()
    if shards > CORPUS["num_docs"]:
        assert any(not s[2].any() and s[0].shape == (block,) for s in tout)


def test_collectives_and_backend_moments_on_four_ranks(tmp_path):
    """``spmd_pull_all``, ``spmd_push_reduce`` and ``SpmdBackend``'s four
    moments on a 2 x 2 mesh of gloo ranks, against their definitions:
    concatenate over the axis (the JAX package's order: data, then model,
    for a coordinate buffer), sum then slice."""
    out = _run_ranks(tmp_path, "collectives", model=2)
    data, model = W // 2, 2
    inp = [_rank_inputs(r) for r in range(W)]
    for r, got in enumerate(out):
        di, mi = r // model, r % model
        row = [di * model + m for m in range(model)]
        np.testing.assert_array_equal(got["coords"], [r, di, mi])
        pull = np.concatenate([inp[q]["shard"] for q in row])
        np.testing.assert_array_equal(got["pull"], pull)
        np.testing.assert_array_equal(got["pull_full"], pull)
        total = sum(inp[q]["delta"] for q in row)
        np.testing.assert_array_equal(got["push"], total[mi * 3:mi * 3 + 3])
        np.testing.assert_array_equal(got["reduce"],
                                      sum(i["vec"] for i in inp))
        order = [d * model + m for m in range(model) for d in range(data)]
        np.testing.assert_array_equal(
            got["gather_concat"],
            np.concatenate([inp[q]["coo"] for q in order]))
        np.testing.assert_array_equal(got["localize"],
                                      inp[r]["full"][mi * 3:mi * 3 + 3])


def _job(pkg, mm, **kw):
    api = pkg.api
    corp = pkg.corpus.synthetic_corpus(**CORPUS)
    return api.LDAJob(corpus=corp, num_topics=K, block_tokens=BLOCK,
                      sweeps=SWEEPS, backend="spmd", mesh_model=mm,
                      seed=SEED, **kw)


def _tokens() -> int:
    from repro_torch.data.corpus import synthetic_corpus
    return synthetic_corpus(**CORPUS).num_tokens


def _cfg(mm):
    from repro_torch.core.lightlda import LDAConfig
    return LDAConfig(num_topics=K, vocab_size=CORPUS["vocab_size"],
                     block_tokens=BLOCK, num_shards=mm)


class _Pkg:
    def __init__(self, api, corpus):
        self.api, self.corpus = api, corpus


def _torch_pkg():
    import repro_torch.api as api
    from repro_torch.data import corpus
    return _Pkg(api, corpus)


def test_error_texts_match_jax(tmp_path):
    """The JAX package's texts: the divisibility error (up to its remedy,
    which here is ``devices=``), the checkpoint refusal of a view, and
    the job validation of an SPMD job."""
    import repro.api as japi
    from repro.api import session as jsess
    from repro.data import corpus as jcorpus
    import repro_torch.api as tapi
    from repro_torch.api import session as tsess

    jpkg, tpkg = _Pkg(japi, jcorpus), _torch_pkg()
    with pytest.raises(ValueError) as je:
        jsess.Session(_job(jpkg, 2, eval_every=0), **QUIET).run()
    with pytest.raises(ValueError) as te:
        tsess.Session(_job(tpkg, 2, eval_every=0), device="cpu", devices=1,
                      **QUIET).run()
    assert str(te.value).split("adjust")[0] == \
        str(je.value).split("adjust")[0]
    assert "device count 1 is not divisible by mesh_model=2" in str(te.value)
    with pytest.raises(ValueError, match="device count 6 is not divisible"):
        tsess.Session(_job(tpkg, 4, eval_every=0), device="cpu", devices=6,
                      **QUIET).run()

    with pytest.raises(ValueError) as je:
        jsess._SpmdPlane(None, None, None, 1).checkpoint(None, "x")

    class Save(tapi.Callback):
        def on_sweep_end(self, view):
            view.save(str(tmp_path / "ck.npz"))

    with pytest.raises(ValueError) as te:
        tapi.APSLDA(_job(tpkg, 2, eval_every=0), device="cpu", devices=2,
                    **QUIET).fit([Save()])
    assert str(te.value) == str(je.value)

    bad = dict(model_blocks=4, mesh_model=0, num_shards=3,
               checkpoint_path=str(tmp_path / "c.npz"))
    probs = []
    for pkg in (jpkg, tpkg):
        kw = dict(bad)
        kw["checkpoint"] = pkg.api.CheckpointPolicy(
            path=kw.pop("checkpoint_path"))
        with pytest.raises(pkg.api.JobValidationError) as e:
            _job(pkg, kw.pop("mesh_model"), **kw).validate()
        probs.append(e.value.problems)
    assert probs[0] == probs[1] and len(probs[1]) >= 3


def test_a_dead_rank_makes_the_run_raise():
    """A helper rank SIGKILLed mid-run: ``fit`` raises within its bound,
    and no rank process or run directory is left behind."""
    import repro_torch.api as tapi

    class Kill(tapi.Callback):
        def on_fit_start(self, info):
            self.info = info

        def on_sweep_end(self, view):
            if view.step == 1:
                os.kill(self.info["helper_pids"][0], signal.SIGKILL)

    kill = Kill()
    job = dataclasses.replace(_job(_torch_pkg(), 2, eval_every=0),
                              sweeps=40)
    t0 = time.time()
    with pytest.raises(RuntimeError):
        tapi.APSLDA(job, device="cpu", devices=W, **QUIET).fit([kill])
    assert time.time() - t0 < 90
    for pid in kill.info["helper_pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert not os.path.exists(kill.info["rank_logs"])


def test_init_distributed_state_bitwise(jax_ref):
    from repro_torch import rng as jrng
    from repro_torch.api.model import cfg_from_dict
    from repro_torch.api.session import init_distributed_state
    from repro_torch.data.corpus import synthetic_corpus

    cfg = cfg_from_dict(json.loads(str(jax_ref["cfg"])))
    got = init_distributed_state(synthetic_corpus(**CORPUS), cfg, W,
                                 jrng.PRNGKey(CARRY["init_seed"]),
                                 device="cpu")
    names = ("w", "d", "valid", "doc_start", "doc_len", "z", "ndk")
    for n, x in zip(names, got[:7]):
        np.testing.assert_array_equal(x.numpy(), jax_ref[f"in__{n}"],
                                      err_msg=n)
    np.testing.assert_array_equal(got[7].value.numpy(), jax_ref["in__nwk"])
    np.testing.assert_array_equal(got[8].numpy(), jax_ref["in__nk"])


def test_carried_spmd_sweep_bitwise(jax_ref, tmp_path):
    """One ``make_spmd_sweep`` on each of 4 ranks, from the JAX package's
    ``init_distributed_state`` carried across (``convert``), equals the
    JAX sweep in every rank's z and n_dk, its server rows of n_wk, and
    n_k."""
    ref = tmp_path / "ref.npz"
    np.savez(ref, **jax_ref)
    out = _run_ranks(tmp_path, "carry", model=CARRY["model"], ref=ref)
    rps = jax_ref["out__nwk"].shape[0] // CARRY["model"]
    changed = 0
    for r, got in enumerate(out):
        mi = r % CARRY["model"]
        np.testing.assert_array_equal(got["z"], jax_ref["out__z"][r])
        np.testing.assert_array_equal(got["ndk"], jax_ref["out__ndk"][r])
        np.testing.assert_array_equal(
            got["nwk"], jax_ref["out__nwk"][mi * rps:(mi + 1) * rps])
        np.testing.assert_array_equal(got["nk"], jax_ref["out__nk"])
        changed += int((got["z"] != jax_ref["in__z"][r]).sum())
    assert changed > 0


@pytest.mark.parametrize("name", [c[0] for c in PLANE_CASES])
def test_memory_plane_bitwise_vs_jax(jax_ref, one_thread, name):
    """A whole SPMD fit on 4 gloo ranks == the JAX SPMD plane on 4 forced
    host devices: the physical n_wk and n_k bitwise.  The perplexity case
    also evaluates every sweep: its history is within rtol 1e-5 of the
    JAX package's ``training_perplexity`` on host copies, and evaluating
    perturbs nothing."""
    import torch

    from repro_torch.api.session import Session
    from repro_torch.core import lightlda as tlda

    _, kw, mm = _case(name)
    ev = 1 if name == PPL_CASE else 0
    res = Session(_job(_torch_pkg(), mm, eval_every=ev, **kw), device="cpu",
                  devices=W, **QUIET).run()
    np.testing.assert_array_equal(res.nwk.value.numpy(),
                                  jax_ref[f"{name}__nwk"])
    np.testing.assert_array_equal(res.nk.value.numpy(),
                                  jax_ref[f"{name}__nk"])
    info = res.info
    assert (info["mode"], info["workers"], info["mesh_model"],
            info["collective"]) == ("spmd", W, mm, "gloo")
    assert len(info["ranks"]) == W
    assert all(r["steps"] == SWEEPS for r in info["ranks"])
    # the whole mesh's state: its counts are the histogram of its z
    st = res.state
    nwk, nk, ndk = tlda.rebuild_counts(st.w, st.d, st.z, st.valid,
                                       st.ndk.shape[0], _cfg(mm))
    assert torch.equal(nwk.to_dense(), st.nwk.to_dense())
    assert torch.equal(nk.value, st.nk.value) and torch.equal(ndk, st.ndk)
    assert int(st.nk.value.sum()) == int(st.valid.sum()) == _tokens()
    if ev:
        np.testing.assert_array_equal(jax_ref["ppl__nwk"],
                                      jax_ref[f"{name}__nwk"])
        got = [row["perplexity"] for row in res.history]
        np.testing.assert_allclose(got, jax_ref["ppl__history"], rtol=1e-5)
        assert got[-1] < got[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax-ref", default="")
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--run-dir", default="")
    ap.add_argument("--case", default="")
    ap.add_argument("--ref", default="")
    a = ap.parse_args()
    if a.jax_ref:
        _jax_reference(a.jax_ref)
    else:
        _rank_main(a)
