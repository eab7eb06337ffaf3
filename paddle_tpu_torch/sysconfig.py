"""paddle.sysconfig parity: port of ``paddle_tpu/sysconfig.py``, pointing
at the port's native runtime sources and its build directory."""
import os

__all__ = ["get_include", "get_lib"]

_ROOT = os.path.dirname(os.path.abspath(__file__))


def get_include():
    return os.path.join(_ROOT, "runtime", "csrc")


def get_lib():
    from .runtime import _BUILD_DIR
    return _BUILD_DIR
