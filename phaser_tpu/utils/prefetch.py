"""Background prefetch for streaming ingest.

The reference overlaps BAM decode with allele mapping via Unix pipes
(`samtools view | ... | call_read_variant_map.py`, phaser.py:1346 — three
concurrent processes). phaser_tpu's in-process equivalent: a bounded-queue
prefetch thread that decodes the NEXT window (io.bam.iter_bam_stream —
native BGZF inflate runs with the GIL released inside the C library)
while the main thread packs tensors and runs the device kernel on the
current one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def iter_prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a daemon thread, yielding items through a bounded
    queue of `depth` in-flight items. Exceptions from the producer are
    re-raised at the consumer's next(); abandoning the iterator stops the
    producer within one queue slot.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put_stoppable(item) -> bool:
        """Blocking put that honors the stop event (an abandoned consumer
        must not pin the producer — and its decoded windows — forever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in it:
                if not _put_stoppable(item):
                    return
            _put_stoppable(_SENTINEL)
        except BaseException as exc:  # propagate to consumer
            _put_stoppable(_Failure(exc))

    t = threading.Thread(target=_produce, daemon=True,
                         name="phaser-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
