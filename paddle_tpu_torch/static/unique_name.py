"""Unique names for a program's variables: port of
``paddle_tpu/utils/unique_name.py`` (``key_0``, ``key_1``, ... per key,
a generator swapped in by ``guard``)."""
import contextlib
import threading

__all__ = ["UniqueNameGenerator", "generate", "switch", "guard"]


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
