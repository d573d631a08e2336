"""Package rules of the port: it imports neither jax nor the JAX package,
runs on the card unless asked for the CPU, and dispatches each kernel on
the tensor's device; plus parity of the small modules it copied (corpus,
perplexity, obs)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                            .parts).replace(".__init__", "")
                  for p in PKG.rglob("*.py"))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {_modules()!r}: importlib.import_module(m.rstrip('.'))\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_source_has_no_jax_or_repro_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro(\.|\s|$)|"
                         r"from repro(\.| import))", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    # the training slice's modules are among them, and the stream,
    # checkpoint, serving facade, launchers, tiered storage, autotuner,
    # timer, the Spark-LDA baselines, the trace replay and the report, the
    # LM serving path, the LM training path, LM serving and training on a
    # mesh
    for mod in ("core/pserver.py", "ps/client.py", "ps/routes.py",
                "train/async_exec.py", "api/session.py", "api/job.py",
                "kernels/delta_push.py", "core/coherence.py",
                "data/stream.py", "train/checkpoint.py", "serve/__init__.py",
                "serve/topic_service.py", "launch/__init__.py",
                "launch/lda.py", "launch/topic_serve.py", "ps/coldstore.py",
                "ps/tiered.py", "ps/autotune.py", "obs/timing.py",
                "core/lda_em.py", "core/lda_online.py", "obs/exec_trace.py",
                "launch/obs_report.py", "configs/base.py",
                "configs/registry.py", "configs/gemma3_4b.py",
                "sharding/specs.py", "models/layers.py",
                "models/attention.py", "models/moe.py", "models/ssm.py",
                "models/transformer.py", "serve/engine.py",
                "launch/serve.py", "data/lm_data.py", "train/optimizer.py",
                "train/loop.py", "launch/train.py", "launch/mesh.py",
                "serve/mesh_worker.py", "launch/dryrun.py",
                "train/mesh_worker.py"):
        assert PKG / mod in files, mod
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_stream_module_imports_no_torch():
    """``data.stream`` is a feeder-host pipeline: numpy only."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "import repro_torch.data.stream\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('torch.')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the trainer entry points below ``api``: a launcher that calls one of them
# bypasses the session (its planes, callbacks and checkpoint policy)
TRAINER_CALL = re.compile(
    r"\b(?:fit_lda(?:_stream)?|stream_fit|memory_fit|pipelined_sweep|"
    r"snapshot_sweep|make_(?:stream_)?executor|init_stream)\s*\(")


def test_launchers_orchestrate_only_through_api():
    offenders = []
    files = sorted((PKG / "launch").rglob("*.py"))
    assert len(files) == 10     # __init__, lda, topic_serve, ps_server,
    #                             net_smoke, mesh, obs_report, serve, train,
    #                             dryrun
    for path in files:
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if TRAINER_CALL.search(line):
                offenders.append(f"{path.relative_to(ROOT)}:{lineno}: "
                                 f"{line.strip()}")
    assert not offenders, (
        "repro_torch/launch must orchestrate training through "
        "repro_torch.api (LDAJob + APSLDA/Session) or the serve facade:\n"
        + "\n".join(offenders))


def test_topic_model_defaults_to_the_card():
    from repro_torch.api import TopicModel, resolve_device
    from repro_torch.core.lightlda import LDAConfig
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    cfg = LDAConfig(num_topics=3, vocab_size=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopicModel(np.ones((5, 3), np.int32), np.full(3, 5), cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    m = TopicModel(np.ones((5, 3), np.int32), np.full(3, 5), cfg,
                   device="cpu")
    assert m.snapshot.device.type == "cpu"


def test_ops_dispatch_on_device():
    from repro_torch.kernels import ops
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.alias_build(meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.delta_push(meta[0].int(), meta[0].int(), meta[0].int(),
                       meta[0].bool(), 4, 3,
                       out=torch.empty((4, 3), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.delta_push(meta[0].int(), meta[0].int(), meta[0].int(),
                       meta[0].bool(), 4, 3,
                       out=torch.empty((4, 3), device="meta"),
                       docs=meta[0].int(),
                       ndk_out=torch.empty((2, 3), device="meta"),
                       nk_out=torch.empty(3, device="meta"))
    from repro_torch.core.lightlda import LDAConfig
    cfg = LDAConfig(num_topics=3, vocab_size=5)
    key = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.mh_draws_train(key, meta[0].int(), meta[0].int(), meta[0].int(),
                           meta[0].int(), 3, cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.mh_draws_foldin(torch.zeros((4, 2), dtype=torch.int64,
                                        device="meta"), 0, meta.int(),
                            meta[:, 0].int(), cfg)
    for draw in (lambda k: ops.split(k, 3), lambda k: ops.fold_in(k, 1),
                 lambda k: ops.randint(k, (4,), 0, 3)):
        with pytest.raises(ValueError, match="no kernel for device"):
            draw(key)
    names = {"mh_sample", "alias_build", "delta_push", "delta_apply_coo",
             "mh_draws_train", "mh_draws_foldin", "threefry_keys",
             "threefry_randint"}
    assert set(ops.launch_counts()) == names
    ops.KERNELS["mh_sample"].launches = 7
    ops.KERNELS["delta_apply_coo"].launches = 2
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(names, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a plain version themselves: given a CPU
    tensor they raise (ops routes CPU tensors to ``ref`` instead)."""
    from repro_torch.core.lightlda import LDAConfig
    from repro_torch.kernels import alias_build, mh_sample
    with pytest.raises(ValueError, match="CUDA"):
        alias_build.alias_build_cuda(torch.ones((2, 3)))
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mh_sample.mh_sample_cuda(None, z, z, z, None, None, None, None, None,
                                 LDAConfig(num_topics=3, vocab_size=5))


def test_build_names_library_by_source_hash():
    from repro_torch.kernels import _build, ops
    a = _build.library_path("mh_sample")
    b = _build.library_path("alias_build")
    assert a.parent == b.parent == ROOT / "build" / "kernels"
    # both delta kernels live in one source, built once
    assert ops.KERNELS["delta_push"].source == "delta_push"
    assert ops.KERNELS["delta_apply_coo"].source == "delta_push"
    assert {k.source for k in ops.KERNELS.values()} == {
        p.stem for p in _build.CSRC.glob("*.cu")}
    assert a.name.startswith("mh_sample-") and a.suffix == ".so"
    assert a != b
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_corpus_matches_jax_package():
    from repro.data import corpus as jcorpus
    from repro_torch.data import corpus as tcorpus
    a = jcorpus.synthetic_corpus(30, 80, true_topics=5, seed=3)
    b = tcorpus.synthetic_corpus(30, 80, true_topics=5, seed=3)
    for name in ("w", "d", "doc_start", "doc_len", "word_freq"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert b.num_tokens == a.num_tokens and b.num_docs == a.num_docs


def test_perplexity_matches_jax_package():
    from repro.core import perplexity as jppl
    from repro_torch.core import perplexity as tppl
    rng = np.random.default_rng(2)
    nwk = rng.integers(0, 20, (15, 4)).astype(np.float32)
    nk = nwk.sum(0)
    ndk = rng.integers(0, 9, (6, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tppl.phi_from_counts(torch.from_numpy(nwk), torch.from_numpy(nk),
                             0.01).numpy(),
        np.asarray(jppl.phi_from_counts(jnp.asarray(nwk), jnp.asarray(nk),
                                        0.01)))
    np.testing.assert_allclose(
        tppl.theta_from_counts(torch.from_numpy(ndk), 0.1).numpy(),
        np.asarray(jppl.theta_from_counts(jnp.asarray(ndk), 0.1)),
        rtol=1e-6)
    w = rng.integers(0, 15, 40).astype(np.int32)
    d = rng.integers(0, 6, 40).astype(np.int32)
    valid = rng.random(40) < 0.9
    z = rng.integers(0, 4, 40).astype(np.int32)
    args = (w, d, valid, ndk, nwk, nk)
    want = float(jppl.training_perplexity(*map(jnp.asarray, args), 0.1, 0.01))
    got = float(tppl.training_perplexity(*map(torch.from_numpy, args), 0.1,
                                          0.01))
    assert got == pytest.approx(want, rel=1e-5)
    phi = jppl.phi_from_counts(jnp.asarray(nwk), jnp.asarray(nk), 0.01)
    want = float(jppl.heldout_perplexity(
        *map(jnp.asarray, (w, d, valid, w, z % 6, valid)), phi, 6, 0.1))
    got = float(tppl.heldout_perplexity(
        *map(torch.from_numpy, (w, d, valid, w, (z % 6).astype(np.int32),
                                valid)),
        torch.from_numpy(np.asarray(phi)), 6, 0.1))
    assert got == pytest.approx(want, rel=1e-4)


def test_obs_session_records_spans_and_metrics(tmp_path):
    from repro_torch import obs
    cfg = obs.ObsConfig(enabled=True, out_dir=str(tmp_path))
    assert obs.span("x") is obs.NULL_SPAN            # no session installed
    with obs.session(cfg) as s:
        with obs.span("snapshot.build", cat="snapshot") as sp:
            sp.sync_on(torch.ones(3))
        obs.metrics_registry().histogram("serve.request_ms").record(2.5)
        assert obs.tracer_for(obs.ObsConfig(enabled=False)) is None
        assert obs.metrics_for(None) is s.metrics
    events = json.loads(Path(cfg.trace_path).read_text())["traceEvents"]
    assert any(e.get("name") == "snapshot.build" for e in events)
    rows = obs.load_jsonl(cfg.metrics_path)
    assert rows[0]["name"] == "serve.request_ms" and rows[0]["count"] == 1


@pytest.mark.parametrize("frac", [0.001, 0.025, 0.1, 0.5, 1.0])
def test_corpus_subset_matches_jax_package(frac):
    """``Corpus.subset`` (the paper's 2.5 %-10 % subset scaling): the same
    tokens, documents and vocabulary order as the JAX package's."""
    from repro.data import corpus as jcorpus
    from repro_torch.data import corpus as tcorpus
    a = jcorpus.synthetic_corpus(200, 300, true_topics=6, seed=4)
    b = tcorpus.synthetic_corpus(200, 300, true_topics=6, seed=4)
    sa, sb = a.subset(frac, seed=1), b.subset(frac, seed=1)
    for name in ("w", "d", "doc_start", "doc_len", "word_freq"):
        np.testing.assert_array_equal(getattr(sb, name), getattr(sa, name))
        assert getattr(sb, name).dtype == getattr(sa, name).dtype
    assert (sb.num_docs, sb.num_tokens, sb.vocab_size) == (
        sa.num_docs, sa.num_tokens, sa.vocab_size)
    assert sb.num_docs == max(1, int(200 * frac))


def test_examples_twins_import_neither_jax_nor_repro():
    """The six ``examples/*_torch.py`` twins are the port's: none imports
    jax or the JAX package (their wrappers' argv names ``repro_torch``)."""
    pattern = re.compile(r"^\s*(import jax|from jax|import repro(\.|\s|$)|"
                         r"from repro(\.| import))", re.M)
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [p.name for p in twins] == [
        "lda_distributed_torch.py", "quickstart_torch.py",
        "serve_lm_torch.py", "serve_topics_torch.py",
        "stream_train_torch.py", "train_lm_torch.py"]
    for p in twins:
        text = p.read_text()
        assert not pattern.search(text), p
        assert '"repro.' not in text, p
