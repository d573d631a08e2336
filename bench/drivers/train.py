"""The training driver: ``repro_torch``'s in-memory training session, timed
sweep after sweep, and checked against the plain reference.

Set-up makes the corpus on the device from the seed, builds one
``repro_torch.api.Session`` over it and runs the traffic's warm sweeps
through ``Session.run``, the path ``APSLDA(job).fit()`` takes.  The window
then calls ``Session.run`` on that same session, one sweep a call, until
``seconds`` have passed, and closes with a synchronise.  The session has no
hook to stop a run of many sweeps, so the job asks for one sweep a call;
a call continues the state and the random stream of the one before.

Once the window has closed and the peak memory has been read, the program's
state is freed but for what is judged: the initial topics, the topics
before and after the window's last sweep and the count tables after it.
The reference (``bench/reference``) draws the initial topics again from the
seed, re-runs the last sweep from the topics before it (the program's own
state: a sweep follows from nothing else) and rebuilds the counts.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from bench.reference import lightlda as ref
from bench.traffic import corpus as corpus_gen

CHECKS = ("init_z", "sweep_z", "counts")


def model_of(config: dict) -> "ref.Model":
    return ref.Model(int(config["vocab_size"]), int(config["num_topics"]),
                     float(config["alpha"]), float(config["beta"]),
                     int(config["mh_steps"]))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def job_of(config: dict, traffic: dict, tokens, seed: int):
    from repro_torch.api import HybridRoute, LDAJob
    from repro_torch.data.corpus import Corpus

    host = [t.cpu().numpy() for t in (tokens.w, tokens.d, tokens.doc_len)]
    doc_len = host[2]
    doc_start = (np.cumsum(doc_len) - doc_len).astype(np.int32)
    corp = Corpus(host[0], host[1], doc_start, doc_len,
                  int(config["vocab_size"]), tokens.word_freq.cpu().numpy())
    job = traffic["job"]
    return LDAJob(corpus=corp, num_topics=int(config["num_topics"]),
                  vocab_size=int(config["vocab_size"]),
                  alpha=float(config["alpha"]), beta=float(config["beta"]),
                  mh_steps=int(config["mh_steps"]),
                  model_blocks=int(job["model_blocks"]),
                  staleness=int(job["staleness"]),
                  route=HybridRoute(hot_words=int(job["hot_words"])),
                  sweeps=1, eval_every=0, seed=seed)


class _Window:
    """What the traced run adds around the window: the program's obs
    session (its ``exec.*`` spans) and the profiler, writing its trace
    under ``TMPDIR``."""

    def __init__(self, device):
        from repro_torch.obs import ObsConfig, ObsSession

        self.obs = ObsSession(ObsConfig(enabled=True, metrics=False))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.dir = tempfile.TemporaryDirectory()

    def __enter__(self):
        self.obs.install()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.obs.close(save=False)

    def read(self):
        from bench import trace as tr

        path = os.path.join(self.dir.name, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            return tr.load(path), self.obs.tracer.events()
        finally:
            self.dir.cleanup()


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=lambda m: None, control=None) -> dict:
    """One run of a training cell: set-up, the window, the check.  Returns
    the end-to-end values, the context the per-layer readers take, the
    numbers compared and the device's readings.  ``control`` (a dtype
    name, such as "bfloat16") judges the control instead of the program:
    the reference's last sweep in that dtype put in the program's place."""
    from repro_torch.api import Session

    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    m = model_of(config)
    marks = [("start", t_start), ("imported", time.perf_counter())]
    tokens = corpus_gen.make_corpus(traffic["corpus"], m.vocab, seed, device)
    n = int(tokens.w.shape[0])
    job = job_of(config, traffic, tokens, seed)
    marks.append(("corpus", time.perf_counter()))
    session = Session(job, log_fn=lambda msg: None, device=device)
    state, _, info = session.make_step()
    z_init = state.z[:n].clone()
    _sync(device)
    marks.append(("session", time.perf_counter()))
    warm = int(traffic["warm_sweeps"])
    for _ in range(warm):
        state = session.run().state
    _sync(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log(f"[bench] {n} tokens, {info['n_blocks']} blocks, group "
        f"{info['group']}, {info.get('token_cap')} slots a group; set-up "
        f"{setup_s:.3f} s: " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))

    # the topics before each sweep: a sweep writes a new tensor and leaves
    # its input as it was, so the last sweep's input is what the reference
    # starts from
    sweeps = 0
    window = _Window(device) if trace else None
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.window"):
            while True:
                z_prev = state.z
                with torch.profiler.record_function("bench.sweep"):
                    state = session.run().state
                sweeps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    out = {"z_final": state.z[:n], "nwk": state.nwk.to_dense(),
           "nk": state.nk.value, "ndk": state.ndk, "z_prev": z_prev[:n]}
    del state, session
    trace_data, spans = window.read() if window is not None else (None, None)

    t_check = time.perf_counter()
    numbers = check(tokens, out, z_init, m, traffic, seed,
                    warm + sweeps - 1, control)
    log(f"[bench] {sweeps} sweeps in {window_s:.3f} s; reference "
        f"{time.perf_counter() - t_check:.3f} s")
    return {
        "e2e": {"train_tokens_per_s": sweeps * n / window_s,
                "setup_s": setup_s},
        "ctx": {"trace": trace_data, "spans": spans, "sweeps": sweeps,
                "shape": {"tokens": n, "vocab": m.vocab, "topics": m.topics,
                          "docs": int(tokens.doc_len.shape[0]),
                          "mh_steps": m.mh_steps}},
        "checks": [(name, numbers[name], limits[name]) for name in CHECKS],
        "attempted": sweeps, "failed": 0, "memory_peak_bytes": peak,
    }


def check(tokens, out: dict, z_init, m: "ref.Model", traffic: dict,
          seed: int, last_sweep: int, control=None) -> dict:
    """The numbers compared: initial topics that differ from the seed's
    draw, topics after the last sweep that differ from the reference's
    re-run of it, and count-table entries that differ from the reference's
    counts of its topics.  With ``control``, the last sweep and its counts
    judged are the reference's in that dtype from the same start."""
    job = traffic["job"]
    n_docs = int(tokens.doc_len.shape[0])
    docs = ref.docs_of(tokens.w, tokens.d, n_docs)
    init = ref.init_topics(seed, tokens.w.shape[0], m.topics, z_init.device)
    grp = ref.groups(tokens.w, m.vocab, int(job["model_blocks"]),
                     int(job["staleness"]))
    z_ref = ref.sweep(out["z_prev"], docs, grp,
                      ref.sweep_key(seed, last_sweep), m)
    nwk, nk, ndk = ref.counts(tokens.w, tokens.d, z_ref, m.vocab, m.topics,
                              n_docs)
    if control is not None:
        z = ref.sweep(out["z_prev"], docs, grp,
                      ref.sweep_key(seed, last_sweep), m,
                      dtype=getattr(torch, control))
        c = ref.counts(tokens.w, tokens.d, z, m.vocab, m.topics, n_docs)
        out = dict(out, z_final=z, nwk=c[0], nk=c[1], ndk=c[2])
    return {
        "init_z": int((init != z_init).sum()),
        "sweep_z": int((z_ref != out["z_final"]).sum()),
        "counts": int((nwk != out["nwk"]).sum() + (nk != out["nk"]).sum()
                      + (ndk != out["ndk"]).sum()),
    }
