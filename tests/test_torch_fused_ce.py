"""``ops.fused_ce.fused_linear_cross_entropy`` against the JAX
package's (``tests/test_functional_tail.py:212-242``) on the CPU: the
loss and the gradients of hidden and weight at ``chunk_size`` 12 (four
full chunks of 48 tokens) and 13 (a tail chunk), ``reduction="sum"`` on
``[B, S, H]`` input, all within 1e-6 (loss) and 1e-5 (gradients) of the
reference's and of the materialized logits' cross-entropy; bf16 inputs
against the port's own materialized loss; any other reduction raises
``ValueError``; the backward recomputes each chunk's logits, so a
chunk's f32 logits are never saved.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

T, H, V = 48, 16, 50


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, H)).astype("float32"),
            (rng.normal(size=(H, V)) * 0.1).astype("float32"),
            rng.integers(0, V, T).astype("int32"))


def _reference(h, w, l, **kw):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as jfce
    shape = kw.pop("shape", None)

    def f(h_, w_):
        hh = h_ if shape is None else h_.reshape(*shape, H)
        ll = jnp.asarray(l) if shape is None else jnp.asarray(l).reshape(
            shape)
        return jfce(hh, w_, ll, **kw)

    loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h),
                                                           jnp.asarray(w))
    return float(loss), np.asarray(gh), np.asarray(gw)


def _port(h, w, l, **kw):
    shape = kw.pop("shape", None)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    hh = th if shape is None else th.reshape(*shape, H)
    ll = torch.tensor(l) if shape is None else torch.tensor(l).reshape(shape)
    loss = fused_linear_cross_entropy(hh, tw, ll, **kw)
    loss.backward()
    return loss.item(), th.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("kw", [
    {"chunk_size": 12}, {"chunk_size": 13}, {"chunk_size": 1024},
    {"chunk_size": 12, "reduction": "sum", "shape": (4, 12)}],
    ids=["chunk12", "chunk13_tail", "one_chunk", "sum_3d"])
def test_matches_the_reference_values_and_gradients(kw):
    h, w, l = _inputs()
    got = _port(h, w, l, **dict(kw))
    want = _reference(h, w, l, **dict(kw))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, wn in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, wn, rtol=1e-4, atol=1e-5)


def test_matches_the_materialized_cross_entropy():
    h, w, l = _inputs(1)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    plain = torch.nn.functional.cross_entropy(th @ tw, torch.tensor(l).long())
    plain.backward()
    got = _port(h, w, l, chunk_size=13)
    np.testing.assert_allclose(got[0], plain.item(), rtol=1e-6)
    np.testing.assert_allclose(got[1], th.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], tw.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_bf16_inputs_take_f32_statistics():
    h, w, l = _inputs(2)
    hb = torch.tensor(h).bfloat16().requires_grad_()
    wb = torch.tensor(w).bfloat16().requires_grad_()
    loss = fused_linear_cross_entropy(hb, wb, torch.tensor(l), chunk_size=16)
    assert loss.dtype == torch.float32
    loss.backward()
    assert hb.grad.dtype == wb.grad.dtype == torch.bfloat16
    hr = hb.detach().clone().requires_grad_()
    wr = wb.detach().clone().requires_grad_()
    plain = torch.nn.functional.cross_entropy((hr @ wr).float(),
                                              torch.tensor(l).long())
    plain.backward()
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=1e-6)
    np.testing.assert_allclose(wb.grad.float().numpy(),
                               wr.grad.float().numpy(), rtol=2e-2, atol=1e-3)


def test_other_reductions_raise():
    h, w, l = _inputs()
    with pytest.raises(ValueError, match="reduction"):
        fused_linear_cross_entropy(torch.tensor(h), torch.tensor(w),
                                   torch.tensor(l), reduction="none")


def test_the_chunks_logits_are_not_saved():
    """What autograd keeps for the backward is the inputs' views: no
    tensor of a chunk's ``[c, V]`` logits."""
    h, w, l = _inputs(3)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    th = torch.tensor(h, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fused_linear_cross_entropy(th, torch.tensor(w), torch.tensor(l),
                                   chunk_size=12)
    assert saved and (12, V) not in saved, saved
