"""paddle.reader legacy decorators: composable reader transforms for
the batch()-style API.

Port of ``paddle_tpu/reader.py``, framework-free and copied as it
is: ``shuffle`` draws from Python's ``random``, so the same
``random.seed`` gives the same order in both packages."""
from __future__ import annotations

import itertools
import random as _random

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "ComposeNotAligned",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    data = None

    def gen():
        nonlocal data
        if data is None:
            data = list(reader())
        return iter(data)

    return gen


def map_readers(func, *readers):
    def gen():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return gen


def shuffle(reader, buf_size):
    def gen():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        _random.shuffle(buf)
        yield from buf

    return gen


def chain(*readers):
    def gen():
        return itertools.chain(*[r() for r in readers])

    return gen


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    def gen():
        its = [r() for r in readers]
        _END = object()
        for items in itertools.zip_longest(*its, fillvalue=_END):
            if any(it is _END for it in items):
                if check_alignment and not all(it is _END for it in items):
                    raise ComposeNotAligned(
                        "composed readers have different lengths")
                break
            out = []
            for it in items:
                out.extend(it if isinstance(it, tuple) else (it,))
            yield tuple(out)

    return gen


def buffered(reader, size):
    import queue
    import threading

    def gen():
        q = queue.Queue(maxsize=size)
        END = object()

        def fill():
            try:
                for item in reader():
                    q.put(item)
                q.put(END)
            except BaseException as e:   # surface errors, don't deadlock
                q.put(("__reader_error__", e))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is END:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] == "__reader_error__":
                raise item[1]
            yield item

    return gen


def firstn(reader, n):
    def gen():
        return itertools.islice(reader(), n)

    return gen


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Threaded map with bounded in-flight items (reference decorator.py
    xmap_readers): at most ``buffer_size`` futures outstanding — works
    with infinite readers and bounds memory."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        ex = ThreadPoolExecutor(process_num)
        pending = deque()
        try:
            for item in reader():
                pending.append(ex.submit(mapper, item))
                if len(pending) >= max(buffer_size, 1):
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()
            # never join worker threads here: an abandoned generator is
            # finalized during GC/interpreter teardown where joining hangs
            ex.shutdown(wait=False, cancel_futures=True)

    return gen


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    return chain(*readers)
