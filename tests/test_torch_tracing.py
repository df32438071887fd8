"""The port's spans and counters on the CPU: ``utils/profiling.py::span``
(a ``port.`` range under a torch profiler, the shared no-op without one),
the feed's ``data/pipeline.py::FeedCounters`` through
``cli/common.py::chunked_feed`` (starved waits, source reads, stacking and
pinning, the ``port.feed.wait`` span), ``parallel/steps.py::StepGraph``'s
counters and its ``port.step.prologue`` span, and the CLIs' epoch line
that reads them.  The graphed path's counters on the card are
``tests/test_torch_cuda_kernels.py::test_step_graph_counts_and_prologue_spans``."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.data import pipeline as TP
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.utils import profiling
from torch_tmp import tmp_path  # noqa: F401  (a fixture)

CPU = torch.device("cpu")
K = 3
DELAY = 0.04  # seconds a slow source or consumer sleeps an item


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_a_file():
    """One intra-op thread for the file's torch work (restored after): the
    six-worker run's thread pools otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_events(prof, name: str) -> list:
    """The profile's ``name`` events, as (start, end) in microseconds."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name]


def batches(n: int, rows: int = 2, delay: float = 0.0, start: int = 0):
    """``n`` one-array batch tuples, the i-th filled with ``start + i``,
    each ``next()`` sleeping ``delay`` first."""
    for i in range(n):
        if delay:
            time.sleep(delay)
        yield (np.full((rows, 3), start + i, np.int64),)


# --- span ---------------------------------------------------------------------


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """No profiler recording: every span is one shared object, and entering
    it makes no profiler range."""
    def refuse(name):
        raise AssertionError(f"a range {name!r} made with no profiler on")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert profiling.span("feed.wait") is profiling.span("step.prologue") is profiling.NO_SPAN
    with profiling.span("step.prologue") as entered:
        torch.ones(4) + 1
    assert entered is None


def test_span_under_the_profiler_is_a_port_event(tmp_path):
    """Under ``torch.profiler.profile`` on the CPU a span is one event named
    ``port.<name>``, around the ops run inside it, and a ``cpu_op`` in the
    trace file, not a ``user_annotation`` (which the profiler would copy
    onto the device's timeline); after the profiler the span is the no-op
    again."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("x") is not profiling.NO_SPAN
        with profiling.span("step.prologue"):
            torch.ones(8) + 1
        torch.ones(8) * 2
    (outer,) = port_events(prof, "port.step.prologue")
    inner = port_events(prof, "aten::add")
    assert len(inner) == 1 and outer[0] <= inner[0][0] <= inner[0][1] <= outer[1]
    (mul,) = port_events(prof, "aten::mul")
    assert mul[0] >= outer[1]
    assert not [e for e in prof.events() if e.name.startswith("port.") and e.name != "port.step.prologue"]
    assert profiling.span("x") is profiling.NO_SPAN
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        cats = [e.get("cat") for e in json.load(f)["traceEvents"] if e.get("name") == "port.step.prologue"]
    assert cats == ["cpu_op"]


# --- the feed's counters --------------------------------------------------------


@pytest.mark.parametrize("k", [1, K])
def test_feed_counts_a_slow_source_as_starved(k):
    """A source that sleeps before each batch and a consumer that takes
    each chunk at once: the main thread's waits find the queue empty, the
    blocked seconds are most of the source's, and ``read_s`` holds every
    sleep.  The batches arrive whole and in order."""
    n = 6
    feed = TC.chunked_feed(CPU, k, batches(n, delay=DELAY))
    assert feed.counters.snapshot() == {"starved": 0, "starved_s": 0.0, "read_s": 0.0, "pin_s": 0.0}
    chunks = list(feed)
    got = np.concatenate([chunk[0][:m, :, 0].numpy() for chunk, m in chunks]).ravel()
    np.testing.assert_array_equal(got, np.repeat(np.arange(n), 2))
    c = feed.counters.snapshot()
    assert c["read_s"] >= n * DELAY
    assert c["starved"] >= len(chunks)
    assert 0.5 * n * DELAY <= c["starved_s"] <= c["read_s"] + 1.0
    assert c["pin_s"] < c["read_s"]


@pytest.mark.parametrize("k", [1, K])
def test_feed_keeps_up_with_a_slow_consumer(k):
    """A source ready at once and a consumer that sleeps after each chunk:
    after the first chunk (the threads just started) the queue is full
    whenever the main thread asks, so no later wait, or at most one, finds
    it empty, and the reads take next to nothing; the consumer's sleeps
    are in no counter."""
    n = 12
    feed = TC.chunked_feed(CPU, k, batches(n))
    next(feed)
    time.sleep(DELAY)
    before = feed.counters.snapshot()
    for _ in feed:
        time.sleep(DELAY)
    c = {key: v - before[key] for key, v in feed.counters.snapshot().items()}
    slept = DELAY * (n // k)
    assert c["starved"] <= 1
    assert c["starved_s"] < 0.25 * slept
    assert c["read_s"] < 0.25 * slept and c["pin_s"] < 0.25 * slept


@pytest.mark.parametrize("k", [1, K])
def test_feed_counts_each_source_on_its_own(k):
    """Two sources at different paces: each source's reads in its own slot
    (written by its own thread), and the stacking and pinning in one slot a
    producer: the chunk thread at K > 1, each source's thread at K = 1.
    ``snapshot`` sums the slots."""
    n = 6
    feed = TC.chunked_feed(CPU, k, batches(n, delay=DELAY / 4), batches(n, delay=DELAY))
    chunks = list(feed)
    assert sum(m for _, m in chunks) == n
    c = feed.counters
    assert len(c.reads) == 2 and len(c.pins) == (2 if k == 1 else 1)
    assert n * DELAY / 4 <= c.reads[0] < n * DELAY <= c.reads[1]
    assert all(p > 0.0 for p in c.pins)
    snap = c.snapshot()
    assert snap["read_s"] == sum(c.reads) and snap["pin_s"] == sum(c.pins)


@pytest.mark.parametrize("k", [1, K])
def test_feed_waits_are_port_spans(k):
    """Under the profiler every wait of the main thread for a chunk is one
    ``port.feed.wait`` event (K > 1: one a chunk and one for the end; K =
    1: one a source a batch and the first source's end), and the time in
    them holds the starved seconds."""
    n = 7
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feed = TC.chunked_feed(CPU, k, batches(n, delay=DELAY / 4), batches(n, rows=4, start=100))
        chunks = list(feed)
    waits = port_events(prof, "port.feed.wait")
    assert len(waits) == (len(chunks) + 1 if k > 1 else 2 * n + 1)
    assert sum(b - a for a, b in waits) / 1e6 >= 0.9 * feed.counters.starved_s


def test_feed_counters_over_a_stretch():
    """A caller reads the counters before and after a stretch of chunks:
    each number only grows, and the stretch's reads hold its sources'
    sleeps."""
    feed = TC.chunked_feed(CPU, K, batches(4 * K, delay=DELAY / 2))
    next(feed)
    before = feed.counters.snapshot()
    next(feed)
    next(feed)
    after = feed.counters.snapshot()
    feed.close()
    assert all(after[key] >= before[key] for key in before)
    assert after["read_s"] - before["read_s"] >= (K - 1) * DELAY / 2


def test_feed_close_stops_its_threads():
    """``close`` on a feed taken partway stops the chunk thread and both
    source threads."""
    def endless():
        i = 0
        while True:
            yield (np.full((2, 3), i),)
            i += 1

    before = set(threading.enumerate())
    feed = TC.chunked_feed(CPU, K, endless(), endless())
    next(feed)
    started = set(threading.enumerate()) - before
    assert len(started) == 3
    feed.close()
    for t in started:
        t.join(timeout=15.0)
        assert not t.is_alive()


def test_prefetch_to_device_counts_into_its_slot():
    """``prefetch_to_device`` with counters: its thread's pinning in
    ``pins[slot]`` and the consumer's waits counted; without, nothing is
    counted and the batches are the same."""
    counters = TP.FeedCounters(sources=2, pinners=2)
    got = list(TP.prefetch_to_device(batches(4, delay=DELAY / 4), CPU, counters=counters, slot=1))
    plain = list(TP.prefetch_to_device(batches(4), CPU))
    for (a,), (b,) in zip(got, plain, strict=True):
        assert torch.equal(a, b)
    assert counters.pins[0] == 0.0 < counters.pins[1]
    assert counters.starved >= 1 and counters.reads == [0.0, 0.0]


# --- StepGraph ------------------------------------------------------------------


def _runner(prologue: bool) -> TS.StepGraph:
    body = lambda x: {"v": x * 2.0}
    views = (lambda x: (x + 0.0,)) if prologue else None
    return TS.StepGraph("t", body, views, body, lambda: None, K, CPU)


def test_step_graph_counts_eager_steps_on_the_cpu():
    """On the CPU every step is eager: ``eager_steps`` counts them, no
    replay or capture, and the prologue (not run) makes no span."""
    runner = _runner(prologue=True)
    chunk = (torch.arange(K, dtype=torch.float32).reshape(K, 1),)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run(chunk, K)
        runner.run(chunk, 2)
    assert runner.counts() == {"eager_steps": K + 2, "replays": 0, "captures": 0, "capture_s": 0.0}
    assert not port_events(prof, "port.step.prologue")


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "none"])
def test_step_graph_prologue_is_a_span(prologue):
    """The card's path with the replay replaced by an eager call of the
    body: the first step eager, then each step's prologue one
    ``port.step.prologue`` event; a step without a prologue makes none."""
    runner = _runner(prologue)
    runner.graphed = True
    runner._replay = lambda inputs: runner.body(*inputs)
    chunk = (torch.arange(K, dtype=torch.float32).reshape(K, 1),)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = runner.run(chunk, K)
        runner.run(chunk, K)
    assert torch.equal(out["v"], chunk[0] * 2.0)
    assert runner.counts()["eager_steps"] == 1
    assert len(port_events(prof, "port.step.prologue")) == (2 * K - 1 if prologue else 0)


def test_epoch_line_reads_the_counters():
    """``StretchCounters``: the feed's and the step's counters since the
    reader was made, and nothing of models that keep no counter."""
    counters = TP.FeedCounters(sources=2, pinners=1)
    feed = TC.Feed(iter(()), counters)
    step = _runner(prologue=False)
    stretch = TC.StretchCounters(feed, step)
    counters.starved, counters.starved_s, counters.reads, counters.pins = 3, 0.25, [0.5, 0.25], [0.125]
    step.eager_steps, step.replays, step.captures, step.capture_s = 1, 7, 2, 0.75
    assert stretch.line() == (
        "feed starved 0.250 s in 3 waits, read 0.750 s, pin 0.125 s; "
        "step 1 eager, 7 replays, 2 captures (0.750 s)")
