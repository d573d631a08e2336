"""Device spans and counters of a model's training step.

With an obs session installed, ``step`` opens the step's ``DeviceSpans``
(``obs.trace``) on the tracer's ``[device]`` lane, ``cat`` the device type
("cuda" on the card): the whole step, and inside it the spans the model
and the loop mark by name (``span``: a forward part or the optimizer;
``backward``: a module's backward, between autograd hooks on its output's
and its input's gradients).  The counters the step was told of (``held``;
``attention``: which core MLA's calls took) go on the tracer as Chrome
counter events when it ends.  A
rematerialised layer's recompute marks nothing (``paused``): it runs
inside the backward spans.

Without a session every call is one lookup and nothing more, and nothing
recorded feeds back into the step.  Stdlib only at import, as the rest of
``obs``.
"""
from __future__ import annotations

import contextlib
from typing import Any, List, Optional

from repro_torch.obs import runtime
from repro_torch.obs.trace import DeviceSpans

_step: Optional["_Step"] = None
_paused = 0
_NULL = contextlib.nullcontext()


class _Step:
    def __init__(self, tr, spans: DeviceSpans):
        self.tr, self.spans = tr, spans
        self.held: List[int] = []        # tokens of each held expert
        self.attn = {"fwd": 0, "bwd": 0, "chunked": 0}

    def finish(self) -> None:
        self.spans.end()
        if any(self.attn.values()):
            self.tr.counter("lm.attn.fused", **self.attn)
        if self.held:
            self.tr.counter("lm.moe.held_pairs", pairs=sum(self.held))
            self.tr.counter("lm.moe.expert_tokens", max=max(self.held),
                            mean=sum(self.held) / len(self.held))


def _live() -> Optional[_Step]:
    return _step if not _paused else None


@contextlib.contextmanager
def step(device: Any, name: str = "lm.step.device"):
    """The step's spans and counters while an obs session is installed
    (and no step is open already); else nothing."""
    global _step
    tr = runtime.tracer()
    if tr is None or _step is not None:
        yield
        return
    _step = _Step(tr, tr.device_spans(device, name))
    try:
        yield
    finally:
        st, _step = _step, None
        st.finish()


@contextlib.contextmanager
def _open(st: _Step, name: str):
    span = st.spans.open(name)
    try:
        yield
    finally:
        st.spans.close(span)


def span(name: str):
    """A context marking a forward part (or the optimizer) of the open
    step."""
    st = _live()
    return _NULL if st is None else _open(st, name)


def backward(name: str, inp, out) -> None:
    """Mark the backward of the module that made ``out`` from ``inp``:
    from ``out``'s gradient (its first node's turn) to ``inp``'s (the
    module's last)."""
    st = _live()
    if st is None or not (inp.requires_grad and out.requires_grad):
        return
    box = []

    def begin(grad):
        box.append(st.spans.open(name))

    def done(grad):
        if box:
            st.spans.close(box.pop())

    out.register_hook(begin)
    inp.register_hook(done)


def held(counts) -> None:
    """The tokens of each held expert of one MoE layer's forward."""
    st = _live()
    if st is not None:
        st.held.extend(int(c) for c in counts)


def attention(kind: str) -> None:
    """One MLA core call: ``"fwd"`` or ``"bwd"`` of the fused kernel, or
    ``"chunked"`` (the plain core)."""
    st = _live()
    if st is not None:
        st.attn[kind] += 1


@contextlib.contextmanager
def paused():
    """Nothing is marked inside (a rematerialised layer's recompute)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1
