"""Activation recompute (``fleet.utils.recompute``).

Port of ``paddle_tpu/parallel/recompute_util.py``. The JAX package
rematerialises with ``jax.checkpoint`` under jit and calls the function
plainly on eager tensors; the port runs ``torch.utils.checkpoint``: the
function's activations are dropped after the forward and recomputed in
the backward, with the same gradients. It always takes torch's
non-reentrant checkpoint, which sends gradients to the parameters the
function closes over whether or not its inputs require grad;
``use_reentrant`` is accepted for the reference's signature.
"""
import functools

from torch.utils import checkpoint as _ckpt

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """``function(*args, **kwargs)`` (a module's ``forward`` or a
    callable) with its activations recomputed in the backward."""
    fn = function.forward if hasattr(function, "forward") else function
    if kwargs:
        fn = functools.partial(fn, **kwargs)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute over segments of a sequence of layers:
    ``ctx["segments"]`` segments (1 by default), each one ``recompute``
    call over its layers in order."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    seg_size = max(1, len(funcs) // max(1, segments))
    out = args
    for i in range(0, len(funcs), seg_size):
        seg = funcs[i:i + seg_size]

        def run_seg(*inner, _seg=seg):
            cur = inner
            for f in _seg:
                cur = f(*cur) if isinstance(cur, tuple) else f(cur)
                if not isinstance(cur, tuple):
                    cur = (cur,)
            return cur if len(cur) > 1 else cur[0]

        out = recompute(run_seg, *out, **kwargs)
        if not isinstance(out, tuple):
            out = (out,)
    return out if len(out) > 1 else out[0]
