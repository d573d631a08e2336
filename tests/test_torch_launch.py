"""The port's launchers against the JAX package's: ``repro_torch.launch.lda``
on the CPU writes the JAX launcher's perplexities (within rtol 1e-5) in
memory and stream modes, checkpoint and resume included; SPMD, which the
port does not have, exits naming its ROADMAP item, and ``--backend net``
runs to the end; the serving launcher's
selftest passes; both refuse to start without a card unless given
``--device cpu``."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import lda as jlaunch
from repro_torch.launch import lda as tlaunch
from repro_torch.launch import topic_serve as tserve

SMALL = ["--docs", "100", "--vocab", "300", "-k", "8", "--true-topics", "6",
         "--mean-doc-len", "40", "--block-tokens", "256", "--seed", "3"]


def _jax_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["repro.launch.lda", *argv])
    jlaunch.main()


def _ppl(out):
    with open(os.path.join(out, "history.json")) as f:
        return [row["perplexity"] for row in json.load(f)]


def _both(monkeypatch, tmp_path, argv, tag):
    """Run both launchers on ``argv`` with their own ``--out`` (and stream
    dir, where ``{dir}`` stands in ``argv``); return both perplexities."""
    got = {}
    for pkg in ("jax", "torch"):
        out = str(tmp_path / f"{pkg}_{tag}")
        args = [a.replace("{dir}", str(tmp_path / f"{pkg}_stream"))
                for a in argv] + ["--out", out]
        if pkg == "jax":
            _jax_main(monkeypatch, args)
        else:
            assert tlaunch.main(args + ["--device", "cpu"]) == 0
        got[pkg] = _ppl(out)
    return got["torch"], got["jax"]


def test_memory_run_matches_jax(monkeypatch, tmp_path, capsys):
    ck = str(tmp_path / "mem_ck.npz")
    t, j = _both(monkeypatch, tmp_path,
                 SMALL + ["--sweeps", "3", "--eval-every", "1",
                          "--hot-words", "30", "--checkpoint", ck], "mem")
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert len(t) == 3 and t[-1] < t[0]
    assert "checkpointed assignments" in capsys.readouterr().out
    assert os.path.exists(ck)


@pytest.mark.parametrize("mode", [[], ["--model-blocks", "4",
                                       "--staleness", "1"]],
                         ids=["snapshot", "blocked"])
def test_stream_run_and_resume_match_jax(monkeypatch, tmp_path, capsys,
                                         mode):
    stream = SMALL + mode + ["--stream-dir", "{dir}",
                             "--stream-shard-tokens", "1024",
                             "--eval-every", "3"]
    t, j = _both(monkeypatch, tmp_path,
                 stream + ["--epochs", "2", "--checkpoint-every", "2"], "a")
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert len(t) == 3
    # the same --out: the default checkpoint lies there
    t, j = _both(monkeypatch, tmp_path,
                 stream + ["--epochs", "3", "--resume"], "a")
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert len(t) == 1
    out = capsys.readouterr().out
    assert out.count("[stream] resumed at epoch 2 pos 0") == 2
    # the stream directories and checkpoints stayed interchangeable
    for name in sorted(os.listdir(tmp_path / "jax_stream")):
        assert ((tmp_path / "jax_stream" / name).read_bytes()
                == (tmp_path / "torch_stream" / name).read_bytes()), name
    assert ((tmp_path / "jax_a" / "stream_ckpt.npz").exists()
            and (tmp_path / "torch_a" / "stream_ckpt.npz").exists())


@pytest.mark.parametrize("kw", [dict(hot_words=30),
                                dict(model_blocks=4, staleness=1)],
                         ids=["snapshot", "blocked"])
def test_run_single_matches_jax(kw):
    from repro.core import lightlda as jlda
    from repro.data.corpus import synthetic_corpus as jcorpus
    from repro_torch.core import lightlda as tlda
    from repro_torch.data.corpus import synthetic_corpus as tcorpus

    cargs = dict(num_docs=60, vocab_size=200, true_topics=5, seed=2)
    cfg = dict(num_topics=8, vocab_size=200, block_tokens=512)
    run = dict(sweeps=3, seed=4, eval_every=1, **kw)
    jst, jhist = jlaunch.run_single(jcorpus(**cargs), jlda.LDAConfig(**cfg),
                                    out=None, **run)
    tst, thist = tlaunch.run_single(tcorpus(**cargs), tlda.LDAConfig(**cfg),
                                    device="cpu", **run)
    np.testing.assert_array_equal(tst.nwk.to_dense().numpy(),
                                  np.asarray(jst.nwk.to_dense()))
    np.testing.assert_array_equal(tst.nk.value.numpy(),
                                  np.asarray(jst.nk.value))
    np.testing.assert_array_equal(tst.z.numpy(), np.asarray(jst.z))
    assert len(thist) == len(jhist) == 3
    np.testing.assert_allclose([r["perplexity"] for r in thist],
                               [r["perplexity"] for r in jhist], rtol=1e-5)


NET = ["--backend", "net", "--eval-every", "1"]


@pytest.mark.parametrize("argv,item", [
    (["--devices", "4"], "ROADMAP A, 'SPMD'"),
    (NET + ["--workers", "1", "--sweeps", "2"],
     "ROADMAP A, 'Network parameter server'"),
    (NET + ["--workers", "2", "--server", "{server}", "--stream-dir",
            "{dir}", "--stream-shard-tokens", "1024", "--epochs", "2"],
     "ROADMAP A, 'Network parameter server'"),
])
def test_unported_planes_exit_naming_their_item(monkeypatch, tmp_path,
                                                capsys, argv, item):
    """SPMD is not ported: the launcher exits naming its ROADMAP item.  The
    network PS (``item``'s other entry) is ported: ``--backend net`` runs
    to the end -- with one worker its final perplexity is the JAX
    launcher's on the same argv -- and ``--server`` trains two workers
    against a ``launch.ps_server`` process, conserving counts there."""
    if "--backend" not in argv:
        with pytest.raises(SystemExit) as exc:
            tlaunch.main(SMALL + argv + ["--device", "cpu", "--out",
                                         str(tmp_path)])
        assert exc.value.code != 0
        assert item in capsys.readouterr().err
        assert not (tmp_path / "history.json").exists()
        return
    if "--server" not in argv:
        t, j = _both(monkeypatch, tmp_path, SMALL + argv, "net")
        assert len(t) == len(j) >= 4
        np.testing.assert_allclose(t[-1], j[-1], rtol=1e-5)
        out = capsys.readouterr()
        assert "net training done: 1 workers" in out.out
        assert item not in out.err
        return
    import subprocess

    from repro_torch.data import corpus as tcorpus
    from repro_torch.data import stream as tstream
    from repro_torch.launch.net_smoke import wait_for_address
    from repro_torch.ps.net import NetClient, wire
    sdir, ready = str(tmp_path / "s"), str(tmp_path / "ps.addr")
    tstream.write_sharded(sdir, tcorpus.synthetic_corpus(
        100, 300, true_topics=6, mean_doc_len=40, seed=3), 1024)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    srv = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.ps_server",
         "--stream-dir", sdir, "--topics", "8", "--ready-file", ready,
         "--quiet"], env=env, stdin=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        address = wait_for_address(srv, ready)
        argv = [a.replace("{server}", address).replace("{dir}", sdir)
                for a in argv]
        assert tlaunch.main(SMALL + argv + ["--device", "cpu", "--out",
                                            str(tmp_path)]) == 0
        assert len(_ppl(str(tmp_path))) == 10
        ctl = NetClient.connect(address, name="test", role="ctl")
        rw, rk = tstream.rebuild_counts_from_stream(
            tstream.ShardedCorpusReader(sdir), 8)
        np.testing.assert_array_equal(ctl.pull_full(wire.MAT_NWK), rw)
        np.testing.assert_array_equal(ctl.pull_full(wire.MAT_NK), rk)
        assert ctl.status()["leases"]["done"] == 10
        ctl.shutdown()
        ctl.close()
        assert srv.wait(timeout=30) == 0
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait(timeout=30)


def test_topic_serve_selftest_on_the_cpu(capsys):
    rc = tserve.main(["--selftest", "--device", "cpu", "--docs", "160",
                      "--vocab", "400", "--sweeps", "6", "--serve-docs",
                      "8", "--foldin-sweeps", "12", "--foldin-burnin", "4",
                      "--client-requests", "4", "--refresh-sweeps", "3",
                      "--publish-every", "3", "--block-tokens", "2048"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "selftest OK" in out
    assert "snapshot swaps under load" in out


@pytest.mark.parametrize("main", [tlaunch.main, tserve.main],
                         ids=["lda", "topic_serve"])
def test_launchers_default_to_the_card(main, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(SystemExit) as exc:
        main(["--out", str(tmp_path)] if main is tlaunch.main
             else ["--selftest"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
