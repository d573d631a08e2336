"""The SPMD parameter server over a shard stream: the port's ranks (4 gloo
processes, one intra-op thread each) against the JAX package's streamed
SPMD plane under 4 forced host devices.

The JAX side runs once per module in a subprocess started by this file
(``python test_torch_spmd_stream.py --jax-ref out.npz``, with ``XLA_FLAGS``
set before jax is imported) and writes every reference case to one npz:
for the dense, hybrid and COO routes, the physical n_wk, n_k and every
shard's z file after 2 epochs, which the port's plane must equal bitwise
and which must conserve counts (n_wk and n_k are the histogram of the z
files); the perplexity history of one case, from the JAX package's
``training_perplexity`` on host copies of the last visit (the JAX plane's
own perplexity raises on its model-sharded table), within rtol 1e-5; and
the JAX package's texts for a stream whose shard count does not split
over the ranks and one whose shards do not split into blocks.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
W, K, BLOCK, EPOCHS, SEED = 4, 8, 256, 2, 7
CORPUS = dict(num_docs=60, vocab_size=200, true_topics=5, seed=1)
TOKENS_PER_SHARD = 512                       # 8 shards: 2 visits an epoch
# (name, job knobs, mesh_model)
STREAM_CASES = [
    ("dense_s1_m2", {"staleness": 1}, 2),
    ("hot_s0_m1", {"hot_words": 64}, 1),
    ("coo_s1_m2", {"hot_words": 0, "staleness": 1}, 2),
]
PPL_CASE = "dense_s1_m2"
# probed for the error cases: a shard count that does not split over 4
# ranks, and shards that do not split into blocks
RESHARD_TPS = (768, 1024, 1280, 1536)
UNBLOCKED_TPS = (384, 640, 896, 1152, 1408)
QUIET = dict(log_fn=lambda *a: None)


def _env(**extra) -> dict:
    path = os.pathsep.join(p for p in (str(SRC), os.environ.get(
        "PYTHONPATH", "")) if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **extra)


def _case(name):
    return next(c for c in STREAM_CASES if c[0] == name)


def _write(stream_mod, corp, path, tps):
    stream_mod.write_sharded(str(path), corp, tokens_per_shard=tps)
    return stream_mod.ShardedCorpusReader(str(path))


# ---------------------------------------------------------------------------
# The JAX reference (run as a subprocess under 4 forced host devices).
# ---------------------------------------------------------------------------

def _jax_reference(out: str) -> None:
    import tempfile

    import jax
    import jax.numpy as jnp

    from repro import api, ps
    from repro.api import session as sess
    from repro.api.callbacks import EvalCallback
    from repro.core import perplexity as ppl
    from repro.data import stream as stream_mod
    from repro.data.corpus import synthetic_corpus

    assert jax.device_count() == W, jax.device_count()
    corp = synthetic_corpus(**CORPUS)
    tmp = Path(tempfile.mkdtemp())
    res = {}

    def job(path, mm, **kw):
        return api.LDAJob(stream_dir=str(path), num_topics=K,
                          block_tokens=BLOCK, epochs=EPOCHS, backend="spmd",
                          mesh_model=mm, seed=SEED, **kw)

    for name, kw, mm in STREAM_CASES:
        reader = _write(stream_mod, corp, tmp / name, TOKENS_PER_SHARD)
        r = api.Session(job(tmp / name, mm, eval_every=0, **kw),
                        **QUIET).run()
        res[f"{name}__nwk"] = np.asarray(r.nwk.value)
        res[f"{name}__nk"] = np.asarray(r.nk.value)
        res[f"{name}__z"] = np.stack([reader.read_z(s) for s in
                                      range(reader.num_shards)])

    class HostPerplexity(sess._StreamSpmdPlane):
        """The JAX plane, its perplexity on host copies of the last
        visit's arrays and counts."""

        def perplexity(self, view):
            w, d, valid, ndk, _ = (jnp.asarray(np.asarray(x))
                                   for x in self._last_group)
            dmax = ndk.shape[1]
            full = ps.client_for(self.cfg).wrap_matrix(
                jnp.asarray(np.asarray(self.nwk_val)), self.cfg.V).to_dense()
            return float(ppl.training_perplexity(
                w.reshape(-1),
                (d + jnp.arange(self.workers)[:, None] * dmax).reshape(-1),
                valid.reshape(-1), ndk.reshape(self.workers * dmax, K), full,
                jnp.asarray(np.asarray(self.nk_val)), self.cfg.alpha,
                self.cfg.beta))

    name, kw, mm = _case(PPL_CASE)
    j = job(tmp / "ppl", mm, eval_every=1, **kw)
    reader = _write(stream_mod, corp, tmp / "ppl", TOKENS_PER_SHARD)
    plane = HostPerplexity(reader, j.lda_config(reader.meta.vocab_size),
                           j.exec_config(), EPOCHS, seed=SEED,
                           mesh_model=mm, **QUIET)
    ev = EvalCallback(every=1, include_last=False, **QUIET)
    sess._run_loop(plane, [ev])
    res["ppl__history"] = np.asarray([r["perplexity"] for r in ev.history])
    res["ppl__nwk"] = np.asarray(plane.nwk_val)

    for key, probes in (("reshard", RESHARD_TPS),
                        ("unblocked", UNBLOCKED_TPS)):
        for tps in probes:
            reader = _write(stream_mod, corp, tmp / f"{key}{tps}", tps)
            splits = reader.num_shards % W == 0
            if splits == (key == "unblocked"):
                break
        with_error = job(tmp / f"{key}{tps}", 2, eval_every=0)
        try:
            api.Session(with_error, **QUIET).run()
        except ValueError as e:
            res[f"{key}__text"] = np.asarray(str(e))
            res[f"{key}__tps"] = np.asarray(tps)
    np.savez(out, **res)


@pytest.fixture(scope="module", autouse=True)
def jax_ref_proc(tmp_path_factory):
    """Start the JAX reference at once; the port's runs overlap it."""
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
def port_runs(tmp_path_factory):
    """Every case on the port's streamed SPMD plane (4 gloo ranks), run
    while the JAX reference compiles: ``{name: (result, reader)}``."""
    import torch

    from repro_torch import api
    from repro_torch.data import stream as stream_mod
    from repro_torch.data.corpus import synthetic_corpus

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    corp = synthetic_corpus(**CORPUS)
    tmp = tmp_path_factory.mktemp("port_stream")
    out = {}
    try:
        for name, kw, mm in STREAM_CASES:
            reader = _write(stream_mod, corp, tmp / name, TOKENS_PER_SHARD)
            job = api.LDAJob(stream_dir=str(tmp / name), num_topics=K,
                             block_tokens=BLOCK, epochs=EPOCHS,
                             backend="spmd", mesh_model=mm, seed=SEED,
                             eval_every=1 if name == PPL_CASE else 0, **kw)
            out[name] = (api.Session(job, device="cpu", devices=W,
                                     **QUIET).run(), reader)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("name", [c[0] for c in STREAM_CASES])
def test_stream_plane_conserves_counts(port_runs, name):
    """After 2 epochs the counts are the histogram of the z files (every
    push exactly once), the token mass is the corpus's, and every rank
    ran every visit."""
    from repro_torch.data import stream as stream_mod
    from repro_torch.data.corpus import synthetic_corpus

    res, reader = port_runs[name]
    rw, rk = stream_mod.rebuild_counts_from_stream(reader, K)
    np.testing.assert_array_equal(res.nwk.to_dense().numpy(), rw)
    np.testing.assert_array_equal(res.nk.value.numpy(), rk)
    assert int(rk.sum()) == synthetic_corpus(**CORPUS).num_tokens
    info = res.info
    visits = EPOCHS * reader.num_shards // W
    assert (info["mode"], info["workers"], info["collective"]) == (
        "stream_spmd", W, "gloo")
    assert [r["steps"] for r in info["ranks"]] == [visits] * W


@pytest.mark.parametrize("name", [c[0] for c in STREAM_CASES])
def test_stream_plane_bitwise_vs_jax(jax_ref, port_runs, name):
    """The physical n_wk, n_k and every z file equal the JAX plane's."""
    res, reader = port_runs[name]
    np.testing.assert_array_equal(res.nwk.value.numpy(),
                                  jax_ref[f"{name}__nwk"])
    np.testing.assert_array_equal(res.nk.value.numpy(),
                                  jax_ref[f"{name}__nk"])
    for s in range(reader.num_shards):
        np.testing.assert_array_equal(reader.read_z(s),
                                      jax_ref[f"{name}__z"][s], err_msg=s)


def test_stream_perplexity_matches_training_perplexity(jax_ref, port_runs):
    res, _ = port_runs[PPL_CASE]
    np.testing.assert_array_equal(jax_ref["ppl__nwk"],
                                  jax_ref[f"{PPL_CASE}__nwk"])
    got = [row["perplexity"] for row in res.history]
    assert len(got) == EPOCHS * 2
    np.testing.assert_allclose(got, jax_ref["ppl__history"], rtol=1e-5)


@pytest.mark.parametrize("key", ["reshard", "unblocked"])
def test_stream_errors_match_jax(jax_ref, tmp_path, key):
    """A stream whose shard count does not split over the ranks, or whose
    shards do not split into blocks, is refused with the JAX package's
    text, before any rank starts."""
    from repro_torch import api
    from repro_torch.data import stream as stream_mod
    from repro_torch.data.corpus import synthetic_corpus

    tps = int(jax_ref[f"{key}__tps"])
    _write(stream_mod, synthetic_corpus(**CORPUS), tmp_path / "s", tps)
    job = api.LDAJob(stream_dir=str(tmp_path / "s"), num_topics=K,
                     block_tokens=BLOCK, epochs=1, backend="spmd",
                     mesh_model=2, eval_every=0)
    with pytest.raises(ValueError) as e:
        api.Session(job, device="cpu", devices=W, **QUIET).run()
    assert str(e.value) == str(jax_ref[f"{key}__text"])
    assert ("re-shard" in str(e.value)) == (key == "reshard")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax-ref", required=True)
    _jax_reference(ap.parse_args().jax_ref)
