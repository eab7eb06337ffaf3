"""Unique-name generator (reference: python/paddle/utils/unique_name.py →
python/paddle/fluid/unique_name.py UniqueNameGenerator).

Port of ``paddle_tpu/utils/unique_name.py``: ``key_0``, ``key_1``, ...
per key, from one process-wide generator that ``guard`` swaps. ``static``
names its variables and operators from this same generator
(``static.unique_name`` re-exports it), as the reference's ``static``
does."""
from __future__ import annotations

import contextlib
import threading


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}
        self._lock = threading.Lock()

    def __call__(self, key):
        with self._lock:
            n = self.ids.get(key, 0)
            self.ids[key] = n + 1
        return f"{self.prefix}{key}_{n}"


_generator = UniqueNameGenerator()


def generate(key):
    return _generator(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
