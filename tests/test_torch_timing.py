"""The port's shared timer (``repro_torch.obs.timing``) against the JAX
package's ``repro.obs.timing``: the same global iteration sequence, the
warmup call outside every window, best-of-repeats arithmetic, a device
synchronise of everything the carry holds, and a ``bench.<label>`` span
per repeat when an obs session is installed."""
import time

import pytest

torch = pytest.importorskip("torch")

from repro.obs import timing as jtiming
from repro_torch import obs as tobs
from repro_torch.obs import timing as ttiming


def _counting_step(seen):
    def step(carry, i):
        seen.append(i)
        return carry + 1
    return step


@pytest.mark.parametrize("iters,repeats,warmup", [(3, 2, True), (1, 1, True),
                                                  (4, 3, False)])
def test_time_loop_sequence_equals_jax(iters, repeats, warmup):
    runs = {}
    for name, mod in (("torch", ttiming), ("jax", jtiming)):
        seen = []
        carry, tm = mod.time_loop(_counting_step(seen), 0, iters,
                                  repeats=repeats, warmup=warmup, label="t")
        runs[name] = (seen, carry, len(tm.times_s), tm.iters, tm.label)
    assert runs["torch"] == runs["jax"]
    seen, carry = runs["torch"][:2]
    assert seen == list(range(iters * repeats + warmup))
    assert carry == len(seen)


def test_warmup_stays_outside_the_window():
    """The first call (on the card: the kernels' build) must never land in
    a timed repeat."""
    def step(carry, i):
        if i == 0:
            time.sleep(0.3)
        return carry

    _, tm = ttiming.time_loop(step, None, 2, repeats=2)
    assert max(tm.times_s) < 0.3
    _, cold = ttiming.time_loop(step, None, 2, repeats=1, warmup=False)
    assert cold.best_s >= 0.3


def test_timer_result_arithmetic_equals_jax():
    times = [0.5, 0.25, 0.4]
    t = ttiming.TimerResult("x", 4, list(times))
    j = jtiming.TimerResult("x", 4, list(times))
    assert (t.best_s, t.mean_s, t.ms_per_iter(), t.best_rate(10.0)) == (
        j.best_s, j.mean_s, j.ms_per_iter(), j.best_rate(10.0))
    assert t.best_rate(10.0) == pytest.approx(40.0 / 0.25)


def test_sync_walks_the_carry():
    """The window closes on every CUDA tensor the carry holds; a CPU tensor
    or a host value holds none."""
    x = torch.zeros(3)
    nested = {"a": (x, [x, 1.5]), "b": None}
    assert ttiming.cuda_devices(nested) == set()
    ttiming.synchronize(nested)
    seen = []
    _, tm = ttiming.time_loop(lambda c, i: (seen.append(i), c)[1], nested,
                              2, sync=lambda c: c["a"])
    assert seen == [0, 1, 2] and tm.best_s >= 0
    with pytest.raises(ValueError):
        ttiming.time_loop(lambda c, i: c, None, 0)


def test_repeats_are_traced_as_bench_spans():
    s = tobs.ObsSession(tobs.ObsConfig(enabled=True)).install()
    try:
        ttiming.time_loop(lambda c, i: c, None, 3, repeats=2, label="probe")
        events = [e for e in s.tracer.events()
                  if e.get("name") == "bench.probe"]
    finally:
        s.close(save=False)
    assert len(events) == 2
    assert all(e["args"]["iters"] == 3 for e in events)
