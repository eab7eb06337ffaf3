"""paddle.incubate.nn.functional parity: the fused functional ops.

Port of ``paddle_tpu/incubate/nn/functional.py``:

- ``fused_linear``: ``x @ w (+ bias)``, plain torch as in the reference;
- ``fused_linear_activation``: ``act(x @ y + bias)`` through
  ``fused_gemm_epilogue`` (K7, ``ops.kernels.gemm_epilogue``), forward
  and backward;
- ``fused_matmul_bias``: a 2-D ``y`` without ``transpose_x`` goes to K7;
  otherwise a matmul plus add, as the reference does it;
- ``fused_rotary_position_embedding`` (``ops.rope``'s): q and k through
  ``apply_rotary_qk``, one K6 launch on the card without
  ``position_ids``.

The other functions of the reference module run no kernel and are not
ported yet: they raise ``NotImplementedError`` (ROADMAP, Queue 1 item
15).
"""
from ...ops.kernels.gemm_epilogue import fused_gemm_epilogue
from ...ops.rope import fused_rotary_position_embedding

__all__ = ["fused_linear", "fused_linear_activation", "fused_matmul_bias",
           "fused_rotary_position_embedding"]

_TODO = "ROADMAP, Queue 1 item 15: the rest of the API surface"


def _reverse(t):
    """``jnp``'s ``.T``: every axis reversed (a transpose in 2-D)."""
    return t.permute(*reversed(range(t.dim())))


def _swap_last(t):
    """paddle matmul's ``transpose_x``/``transpose_y``: the last two axes
    swapped, a 1-D operand left as it is."""
    return t.transpose(-1, -2) if t.dim() > 1 else t


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight (+ bias)``; ``transpose_weight`` takes ``weight.T``."""
    out = x @ (_reverse(weight) if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    """cublasLt epilogue parity: ``act(x @ y + bias)`` in one pass, K7
    on the card (x's leading dims flattened), its plain version on the
    CPU; differentiable in x, y and bias. ``activation`` is ``none``,
    ``relu`` or ``gelu`` (the tanh form)."""
    a = _reverse(x) if trans_x else x
    b = _reverse(y) if trans_y else y
    return fused_gemm_epilogue(a, b, bias, activation)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """Reference incubate ``fused_matmul_bias``: a 2-D ``y`` without
    ``transpose_x`` runs K7 (no activation); batched or transposed-x
    operands take a matmul plus add."""
    if y.dim() == 2 and not transpose_x:
        return fused_linear_activation(x, y, bias, trans_x=False,
                                       trans_y=transpose_y,
                                       activation="none")
    out = (_swap_last(x) if transpose_x else x) @ \
        (_swap_last(y) if transpose_y else y)
    return out if bias is None else out + bias


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"incubate.nn.functional.{name} is not ported ({_TODO})")
    fn.__name__ = fn.__qualname__ = name
    return fn


fused_multi_transformer = _not_ported("fused_multi_transformer")
fused_multi_head_attention = _not_ported("fused_multi_head_attention")
fused_feedforward = _not_ported("fused_feedforward")
fused_ec_moe = _not_ported("fused_ec_moe")
fused_bias_dropout_residual_layer_norm = _not_ported(
    "fused_bias_dropout_residual_layer_norm")
fused_dropout_add = _not_ported("fused_dropout_add")
fused_rms_norm = _not_ported("fused_rms_norm")
fused_layer_norm = _not_ported("fused_layer_norm")
swiglu = _not_ported("swiglu")
fused_softmax_mask = _not_ported("fused_softmax_mask")
fused_softmax_mask_upper_triangle = _not_ported(
    "fused_softmax_mask_upper_triangle")
