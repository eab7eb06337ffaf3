"""paddle_tpu_torch.utils — framework utilities.

Port of ``paddle_tpu/utils/__init__.py`` (reference analogue:
python/paddle/utils: unique_name, the deprecated decorator,
install_check, the cpp_extension custom-op toolchain). ``run_check``
takes its train step on the default place: the card, or the CPU after
``set_device("cpu")``.
"""
from . import unique_name  # noqa: F401


def deprecated(update_to="", since="", reason="", level=0):
    """Parity decorator (python/paddle/utils/deprecated.py): warn once."""
    import functools
    import warnings

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"API {fn.__name__} is deprecated since {since}"
            if update_to:
                msg += f", use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def try_import(module_name, err_msg=None):
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(
            err_msg or f"package {module_name} is required but not installed")


def run_check():
    """Smoke-check the install (reference:
    python/paddle/utils/install_check.py): a tiny train step on the
    default place. The reference adds a sharded matmul when more than one
    device is visible; with more than one card the port raises, since its
    mesh is not ported (ROADMAP Queue 1 item 13)."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt

    x = pt.to_tensor(np.random.rand(4, 8).astype("float32"))
    w = pt.Parameter(np.random.rand(8, 2).astype("float32"))
    loss = pt.mean(pt.matmul(x, w))
    loss.backward()
    if w.grad is None or w.grad.shape != [8, 2]:
        raise RuntimeError("run_check: the train step gave no gradient")
    place = pt.get_device()
    ndev = torch.cuda.device_count() if place.startswith("gpu") else 1
    if ndev > 1:
        raise NotImplementedError(
            f"run_check's sharded matmul over {ndev} cards is not ported "
            "(ROADMAP, Queue 1 item 13: multi-card training)")
    print(f"paddle_tpu_torch is installed successfully! ({ndev} device(s) "
          f"available, the step ran on {place})")

from . import enforce  # noqa: F401,E402


def require_version(min_version, max_version=None):
    """paddle.utils.require_version parity against our __version__."""
    from .. import __version__

    def parse(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())

    cur = parse(__version__)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {__version__} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {__version__} > allowed {max_version}")
    return True
