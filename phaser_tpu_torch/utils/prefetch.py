"""Background prefetch for streaming ingest.

The reference overlaps BAM decode with allele mapping via Unix pipes
(`samtools view | ... | call_read_variant_map.py`, phaser.py:1346 — three
concurrent processes). phaser_tpu's in-process equivalent: a bounded-queue
prefetch thread that decodes the NEXT window (io.bam.iter_bam_stream —
native BGZF inflate runs with the GIL released inside the C library)
while the main thread packs tensors and runs the device kernel on the
current one.

The producer threads are a pool kept for the process, so that the next
stream runs on a thread that a finished one left idle.  A thread of its
own for each stream made the process's resident memory grow by about a
stream's windows with every engine run in it: each new thread's decoded
windows fell in memory the allocator did not hand back or reuse.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, TypeVar

from . import trace

T = TypeVar("T")

_SENTINEL = object()
_tls = threading.local()
_idle: list = []                 # producer threads waiting for a stream
_idle_lock = threading.Lock()
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_idle.clear)


class _Producer(threading.Thread):
    """A daemon thread that runs one stream's producer after another,
    waiting among the idle ones in between."""

    def __init__(self):
        super().__init__(daemon=True, name="phaser-tpu-prefetch")
        self.jobs: "queue.SimpleQueue" = queue.SimpleQueue()

    def run(self):
        while True:
            self.jobs.get()()
            with _idle_lock:
                _idle.append(self)


def _start_producer(job: Callable[[], None]) -> None:
    """Runs `job` on an idle producer thread, or on a new one."""
    with _idle_lock:
        worker = _idle.pop() if _idle else None
    if worker is None:
        worker = _Producer()
        worker.start()
    worker.jobs.put(job)


def consumer_counts() -> Dict[str, int]:
    """{"stream_waits": items this thread has taken from `iter_prefetch`
    queues, the end of each included}: the counter that tells a
    consumer's wait span from other spans of the same name."""
    return {"stream_waits": getattr(_tls, "waits", 0)}


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def iter_prefetch(it: Iterable[T], depth: int = 2,
                  parent: Optional[trace.Span] = None,
                  counters: Optional[Callable[[], Dict[str, int]]] = None
                  ) -> Iterator[T]:
    """Iterate `it` on a daemon thread, yielding items through a bounded
    queue of `depth` in-flight items. Exceptions from the producer are
    re-raised at the consumer's next(); abandoning the iterator stops the
    producer within one queue slot.  Each item the producer takes from
    `it` is a `decode window` span on its thread, under `parent` (the
    span the caller records the run in; None records nothing), with the
    increase of `counters` (read on the producer's thread) inside it; the
    time the producer waits for room in a full queue is a `prefetch
    blocked` span there.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put_stoppable(item) -> bool:
        """Blocking put that honors the stop event (an abandoned consumer
        must not pin the producer — and its decoded windows — forever)."""
        if stop.is_set():
            return False
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        with trace.span("prefetch blocked"):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
        return False

    def _produce():
        try:
            with trace.under(parent):
                src = iter(it)
                while True:
                    with trace.span("decode window", counters):
                        item = next(src, _SENTINEL)
                    if item is _SENTINEL:
                        break
                    if not _put_stoppable(item):
                        return
            _put_stoppable(_SENTINEL)
        except BaseException as exc:  # propagate to consumer
            _put_stoppable(_Failure(exc))

    _start_producer(_produce)
    try:
        while True:
            item = q.get()
            _tls.waits = getattr(_tls, "waits", 0) + 1
            if item is _SENTINEL:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
