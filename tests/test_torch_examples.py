"""The six ``examples/*_torch.py`` twins on the CPU.

``quickstart_torch``, ``stream_train_torch`` and ``serve_topics_torch``
print what the unchanged JAX examples print (each pair run in
subprocesses at once, the JAX side under ``JAX_PLATFORMS=cpu``), once the
masks of ``MASKS`` have taken out timing and throughput figures, temp
paths, the port's device suffixes and the JAX route's Pallas switch.
Each wrapper keeps its argv in a module-level list: the JAX twin's list
literal (read with ``ast``, never imported) with ``repro.`` ->
``repro_torch.``, and ``--device`` added by its ``command``.

``examples/lda_distributed.py`` fails in the JAX package itself (its SPMD
gather raises ``ShardingTypeError``, ROADMAP C.1), so it cannot anchor
its twin: ``lda_distributed_torch.py``'s final counts are held instead to
the port's ``Session`` run in this process on the same job, bitwise.  The
two LM wrappers run to exit 0 (the port draws LM weights from a
``torch.Generator``, so their tokens are not the JAX package's).  With no
card and no ``--device cpu`` every twin stops with the port's device
message.
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
TIMEOUT = 600

# (pattern, replacement), applied line by line to both outputs
MASKS = [
    # the in-memory trainer's sweep lines: "(5.0s, 175,046 tok/s)"
    (r"\(\d+\.\d+s, [\d,]+ tok/s\)", "(<s>, <tok/s>)"),
    # the streamed trainer's visit and done lines: "(2,885 tok/s)"
    (r"\([\d,]+ tok/s\)", "(<tok/s>)"),
    # "... tokens in 1.8s", "trained 20 sweeps in 3.7s", "48 docs in 3.00s"
    (r" in \d+\.\d+s", " in <s>"),
    (r"\(\d+\.\d+ docs/s\)", "(<docs/s>)"),
    (r"end-to-end \d+\.\d+s", "end-to-end <s>"),
    # the stream example's temp directory
    (r"/\S*lda_stream_[^/\s]+/", "<tmp>/"),
    # the port's device suffixes: TopicModel's repr, topic_serve's corpus
    (r", device=cpu\)", ")"),
    (r", on cpu$", ""),
    # the JAX route's repr names its Pallas interpret switch, which the
    # port's routes do not have
    (r", use_kernel=None\)", ")"),
]
WRAPPERS = ("serve_topics", "lda_distributed", "serve_lm", "train_lm")


def _mask(text):
    out = []
    for line in text.splitlines():
        for pat, rep in MASKS:
            line = re.sub(pat, rep, line)
        out.append(line)
    return out


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _start(argv, **env):
    return subprocess.Popen([sys.executable, *argv], cwd=str(ROOT),
                            env=_env(**env), stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT)
    return proc.returncode, out, err


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  EX / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file, started at once so that they overlap:
    the three JAX examples, their twins on the CPU, the wrappers on the CPU
    and the wrappers with no ``--device``."""
    tmp = tmp_path_factory.mktemp("examples")
    jax_env = dict(JAX_PLATFORMS="cpu")
    port_env = dict(OMP_NUM_THREADS="2")
    procs = {}
    for name in ("quickstart", "stream_train", "serve_topics"):
        procs["jax", name] = _start([str(EX / f"{name}.py")], **jax_env)
        procs["port", name] = _start(
            [str(EX / f"{name}_torch.py"), "--device", "cpu"], **port_env)
    procs["port", "lda_distributed"] = _start(
        [str(EX / "lda_distributed_torch.py"), "--device", "cpu", "--out",
         str(tmp / "lda"), "--save-counts", str(tmp / "counts.npz")],
        **port_env)
    procs["port", "serve_lm"] = _start(
        [str(EX / "serve_lm_torch.py"), "--device", "cpu"], **port_env)
    procs["port", "train_lm"] = _start(
        [str(EX / "train_lm_torch.py"), "--small", "--steps", "3",
         "--device", "cpu", "--out", str(tmp / "train")], **port_env)
    for name in WRAPPERS:
        procs["nodevice", name] = _start([str(EX / f"{name}_torch.py")],
                                         CUDA_VISIBLE_DEVICES="")
    yield procs, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


@pytest.mark.parametrize("name", ["quickstart", "stream_train",
                                  "serve_topics"])
def test_twin_prints_the_jax_example(runs, name):
    procs, _ = runs
    jrc, jout, jerr = _finish(procs["jax", name])
    trc, tout, terr = _finish(procs["port", name])
    assert jrc == 0, jerr[-3000:]
    assert trc == 0, terr[-3000:]
    want, got = _mask(jout), _mask(tout)
    assert len(want) >= 8
    assert got == want
    if name == "quickstart":
        assert any("final perplexity" in line for line in got)
    elif name == "stream_train":
        assert any(line.startswith("conservation check OK") for line in got)
    else:
        assert any("best docs" in line for line in got)


def _jax_cmds():
    """Each JAX wrapper's ``cmd = [...]`` list literals, ``sys.executable``
    dropped and a ``Name`` read as a ``{name}`` placeholder."""
    cmds = {}
    for name in WRAPPERS:
        tree = ast.parse((EX / f"{name}.py").read_text())
        lists = []
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and getattr(node.targets[0], "id", "") == "cmd"):
                items = node.value.elts
                assert ast.unparse(items[0]) == "sys.executable"
                lists.append([i.value if isinstance(i, ast.Constant)
                              else "{" + i.id + "}" for i in items[1:]])
        cmds[name] = lists
    return cmds


def test_wrapper_argv_is_the_jax_twins():
    cmds = _jax_cmds()

    def port(argv):
        return [a.replace("repro.", "repro_torch.", 1) if a.startswith(
            "repro.") else a for a in argv]

    for name in ("serve_topics", "lda_distributed", "serve_lm"):
        mod = _load(name)
        (want,) = cmds[name]
        assert mod.ARGV == port(want), name
        assert mod.command("cpu") == [sys.executable, *mod.ARGV,
                                      "--device", "cpu"]
        assert mod.command()[-2:] == ["--device", "cuda"]
    mod = _load("train_lm")
    small, full = cmds["train_lm"]
    assert (mod.SMALL_ARGV, mod.FULL_ARGV) == (port(small), port(full))
    assert mod.command("50", small=False) == [
        sys.executable, *[a.format(steps="50") for a in mod.FULL_ARGV],
        "--device", "cuda"]
    assert "--smoke" in mod.command("3", small=True, device="cpu")


def test_lda_distributed_equals_the_session(runs):
    """The wrapper's 8 gloo ranks on the CPU against ``Session`` on the
    same job in this process: final n_wk and n_k bitwise, the same
    perplexities, which fall."""
    from repro_torch import api
    from repro_torch.data.corpus import synthetic_corpus

    procs, tmp = runs
    rc, out, err = _finish(procs["port", "lda_distributed"])
    assert rc == 0, err[-3000:]
    assert "mesh data=4 x model=2 (8 workers, 2 servers)" in out
    assert "[lda] kernel launches over 8 ranks (gloo): " in out
    # the launcher's defaults for what the argv leaves out
    corp = synthetic_corpus(600, 1500, true_topics=20, mean_doc_len=80,
                            seed=0)
    job = api.LDAJob(corpus=corp, num_topics=30, mh_steps=2,
                     block_tokens=8192, staleness=2, hot_words=200, seed=0,
                     eval_every=10, sweeps=30, backend=api.SPMD,
                     mesh_model=2)
    want = api.Session(job, device="cpu", devices=8,
                       log_fn=lambda *a: None).run()
    got = np.load(tmp / "counts.npz")
    np.testing.assert_array_equal(got["nwk"], want.nwk.to_dense().numpy())
    np.testing.assert_array_equal(got["nk"], want.nk.value.numpy())
    assert int(got["nk"].sum()) == corp.num_tokens
    with open(tmp / "lda" / "history.json") as f:
        ppl = [row["perplexity"] for row in json.load(f)]
    assert ppl == [row["perplexity"] for row in want.history]
    assert len(ppl) == 3 and ppl[0] > ppl[1] > ppl[2]


def test_lm_wrappers_run_on_the_cpu(runs):
    procs, tmp = runs
    rc, out, err = _finish(procs["port", "serve_lm"])
    assert rc == 0, err[-3000:]
    assert "generated (8, 48) tokens" in out
    rc, out, err = _finish(procs["port", "train_lm"])
    assert rc == 0, err[-3000:]
    assert "smoke-yi-6b" in out and "steps=3" in out
    assert re.search(r"\[train\] loss \d+\.\d+ -> \d+\.\d+", out)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_without_a_card_needs_device_cpu(runs, name):
    procs, _ = runs
    rc, out, err = _finish(procs["nodevice", name])
    assert rc == 2
    assert "no CUDA device available" in err and "--device cpu" in err


@pytest.mark.parametrize("name", ["quickstart", "stream_train"])
def test_in_process_twin_without_a_card_needs_device_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main()
