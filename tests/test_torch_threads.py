"""The port's process-wide CUDA state under several threads (thread-mode
``repro_torch.dist`` workers share one process).

What can be shown without a card is shown here: ``exec.graph.eager()``
and a graph's owned scratch (``kernels._build.owned_scratch``) are each
thread's own, no launch count is lost when threads count at once
(``kernels._build.bump``), and a capture's accounting window
(``kernels._build.capture_counts``) takes back its own thread's launches
only, while another thread's launches in that window are counted once
it closes.  The captures themselves, and the launch counts of a
thread-mode run, are held on the card by ``chip_smoke.py`` phase 4e.
"""

import os
import sys
import threading

import torch

from repro_torch.exec import graph
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import ops as conv_ops


def _in_thread(fn):
    out = {}

    def run():
        out["value"] = fn()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return out["value"]


def test_eager_is_the_entering_threads_own():
    cuda = torch.device("cuda")
    with graph.eager():
        assert not graph.enabled(cuda)
        assert _in_thread(lambda: graph.enabled(cuda))
    entered = threading.Event()
    leave = threading.Event()

    def other():
        with graph.eager():
            entered.set()
            leave.wait(timeout=30)

    t = threading.Thread(target=other)
    t.start()
    assert entered.wait(timeout=30)
    assert graph.enabled(cuda)          # the other thread's eager()
    leave.set()
    t.join(timeout=30)


def test_owned_scratch_is_the_building_threads_own():
    cpu = torch.device("cpu")
    mine: dict = {}
    with _build.owned_scratch(mine):
        a = _build.scratch(cpu, "ws", 8, torch.float32)
        assert mine["ws"] is a
        assert not _in_thread(lambda: bool(_build._OWNED))

        def other():
            theirs: dict = {}
            with _build.owned_scratch(theirs):
                b = _build.scratch(cpu, "ws", 4, torch.float32)
            return theirs, b

        theirs, b = _in_thread(other)
        assert theirs["ws"] is b and b is not a
        assert mine == {"ws": a}
        assert _build._OWNED.items == [mine]
    assert not _build._OWNED


def test_counts_from_many_threads_are_not_lost():
    """More threads than cores counting at once, the interpreter
    switching threads as often as it can: no count is lost."""
    before = conv_ops.launch_count()
    n_threads, n = 4 * (os.cpu_count() or 2), 2000
    barrier = threading.Barrier(n_threads)

    def count():
        barrier.wait()
        for _ in range(n):
            _build.bump(conv_ops._counts, "conv2d_fused")

    threads = [threading.Thread(target=count) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert conv_ops.launch_count() == before + n_threads * n
    finally:
        sys.setswitchinterval(interval)
        conv_ops._counts["conv2d_fused"] = before


def test_a_capture_takes_back_its_own_threads_launches_only():
    """Thread A records three launches in its capture window while
    thread B counts five real ones: A takes back its three, and B's five
    stand once A's window closes."""
    before = conv_ops.launch_count()
    opened, b_started = threading.Event(), threading.Event()
    b_done = threading.Event()

    def thread_b():
        opened.wait(timeout=30)
        b_started.set()
        for _ in range(5):
            _build.bump(conv_ops._counts, "conv2d_fused")
        b_done.set()

    t = threading.Thread(target=thread_b)
    t.start()
    try:
        with _build.capture_counts() as delta:
            opened.set()
            assert b_started.wait(timeout=30)
            # B is held at its first count until this window closes
            assert not b_done.wait(timeout=0.2)
            for _ in range(3):
                _build.bump(conv_ops._counts, "conv2d_fused")
        t.join(timeout=30)
        assert b_done.is_set()
        table = _build.COUNT_TABLES.index(conv_ops._counts)
        assert delta[table] == {"conv2d_fused": 3}
        assert conv_ops.launch_count() == before + 5
        _build.credit(delta, 2)                  # two replays
        assert conv_ops.launch_count() == before + 11
    finally:
        conv_ops._counts["conv2d_fused"] = before
