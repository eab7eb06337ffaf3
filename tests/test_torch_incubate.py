"""The port's ``incubate.nn.functional`` against the JAX package's, on
the CPU: the incubate cases of ``tests/test_parity_tail.py``
(``fused_multi_transformer``) and of ``tests/test_debug_aux.py`` (the
fused softmax masks), and the other fused ops, each run through both
packages on the same numpy inputs made from a seed:

- values and gradients within ``TOL`` (f32);
- dropouts under one ``seed()`` draw the reference's masks;
- ``fused_multi_transformer``: pre- and post-LN without a cache (causal
  attention, the flash kernel's route), with a mask, the growing cache
  and the static (``time_step``) cache, static equal to growing, the
  caller's mask honoured, and the static write clamped as
  ``jax.lax.dynamic_update_slice`` clamps it.

The layers, ``fused_ec_moe``, the optimizers, ``forward_grad`` and the
auto-checkpoint are held in ``tests/test_torch_incubate_layers.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x, np.float64)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _carry(jl, tl):
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    missing, unexpected = tl.set_state_dict(sd)
    assert missing == [] and unexpected == [], (missing, unexpected)


def _pair(make):
    jl, tl = make(jt), make(pt)
    _carry(jl, tl)
    return jl, tl


def _both(fn, arrays, **kw):
    """``fn(package, tensors, **kw)`` in both packages on the same
    arrays: (port's, reference's)."""
    return tuple(fn(m, {k: m.to_tensor(v) for k, v in arrays.items()},
                    **kw) for m in (pt, jt))


# ------------------------------------------------- fused_multi_transformer

D, L, H = 16, 2, 4


def _mt_weights(seed, layers=L, d=D):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)

    return dict(
        ln_scales=[mk(d) + 1.0 for _ in range(layers)],
        ln_biases=[mk(d) for _ in range(layers)],
        qkv_weights=[mk(d, 3 * d) for _ in range(layers)],
        qkv_biases=[mk(3 * d) for _ in range(layers)],
        linear_weights=[mk(d, d) for _ in range(layers)],
        linear_biases=[mk(d) for _ in range(layers)],
        ffn_ln_scales=[mk(d) + 1.0 for _ in range(layers)],
        ffn_ln_biases=[mk(d) for _ in range(layers)],
        ffn1_weights=[mk(d, 4 * d) for _ in range(layers)],
        ffn1_biases=[mk(4 * d) for _ in range(layers)],
        ffn2_weights=[mk(4 * d, d) for _ in range(layers)],
        ffn2_biases=[mk(d) for _ in range(layers)])


def _mt_args(m, w, **kw):
    args = {k: [m.to_tensor(a) for a in v] for k, v in w.items()}
    return dict(args, trans_qkvw=False, num_heads=H, **kw)


def _imt(m):
    return m.incubate.nn.functional.fused_multi_transformer


def test_fused_multi_transformer_modes_and_cache():
    w = _mt_weights(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, D)).astype(np.float32)
    step = rng.standard_normal((1, 1, D)).astype(np.float32)
    res = []
    for m in (pt, jt):
        f, a = _imt(m), _mt_args(m, w)
        out = f(m.to_tensor(x), **a)
        out_post = f(m.to_tensor(x), pre_layer_norm=False, **a)
        assert out.shape == [1, 6, D]
        assert not np.allclose(out.numpy(), out_post.numpy())
        with pytest.raises(ValueError):
            f(m.to_tensor(x), **{**a, "num_heads": None})
        empty = [m.to_tensor(np.zeros((2, 1, H, 0, D // H), "float32"))
                 for _ in range(L)]
        prefill, caches = f(m.to_tensor(x), cache_kvs=empty, **a)
        dec, caches2 = f(m.to_tensor(step), cache_kvs=caches, **a)
        assert dec.shape == [1, 1, D] and caches2[0].shape[3] == 7
        res.append((out, out_post, prefill, dec, caches2[1]))
    for g, wnt, what in zip(res[0], res[1], ("pre-LN", "post-LN", "prefill",
                                             "decode", "cache")):
        _close(g, wnt, what=what)


def test_fused_multi_transformer_without_cache_is_causal_attention():
    """No cache, no mask: causal attention (the flash kernel on the
    card); with ``attn_mask`` the composition, values the reference's."""
    w = _mt_weights(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    mask = np.where(rng.random((2, 1, 5, 5)) < 0.3, -1e9, 0.0).astype(
        np.float32)
    got, want = _both(lambda m, t: _imt(m)(t["x"], attn_mask=t["mask"],
                                           **_mt_args(m, w)),
                      {"x": x, "mask": mask})
    _close(got, want)
    y = pt.to_tensor(x)
    first = _imt(pt)(y[:, :3], **_mt_args(pt, w))
    _close(_imt(pt)(y, **_mt_args(pt, w))[:, :3], first)


def test_static_cache_matches_growing_cache():
    rng = np.random.default_rng(0)
    w = _mt_weights(4)
    t_max = 12
    x = rng.standard_normal((1, 4, D)).astype(np.float32)
    steps = [rng.standard_normal((1, 1, D)).astype(np.float32)
             for _ in range(3)]
    outs = {}
    for m in (pt, jt):
        f, a = _imt(m), _mt_args(m, w)
        empty = [m.to_tensor(np.zeros((2, 1, H, 0, D // H), "float32"))
                 for _ in range(L)]
        ref_out, caches = f(m.to_tensor(x), cache_kvs=empty, **a)
        ref_tokens = []
        for s in steps:
            o, caches = f(m.to_tensor(s), cache_kvs=caches, **a)
            ref_tokens.append(o.numpy())
        fixed = [m.to_tensor(np.zeros((2, 1, H, t_max, D // H), "float32"))
                 for _ in range(L)]
        out0, fixed = f(m.to_tensor(x), cache_kvs=fixed, time_step=0, **a)
        _close(out0, ref_out, 1e-4)
        toks = []
        for t, (s, want) in enumerate(zip(steps, ref_tokens)):
            o, fixed = f(m.to_tensor(s), cache_kvs=fixed, time_step=4 + t,
                         **a)
            assert fixed[0].shape[3] == t_max
            _close(o, want, 1e-4)
            toks.append(o)
        outs[m] = (out0, toks, fixed[0])
    for g, wnt in zip([outs[pt][0]] + outs[pt][1] + [outs[pt][2]],
                      [outs[jt][0]] + outs[jt][1] + [outs[jt][2]]):
        _close(g, wnt)


def test_static_cache_decode_honors_attn_mask():
    rng = np.random.default_rng(4)
    w = _mt_weights(5, layers=1)
    t_max = 8
    x = rng.standard_normal((1, 1, D)).astype(np.float32)
    cache = rng.standard_normal((2, 1, H, t_max, D // H)).astype(
        np.float32) * 0.1
    pad = np.zeros((1, 1, 1, t_max), "float32")
    pad[..., :3] = -1e9                       # positions 0-2: left padding
    res = []
    for m in (pt, jt):
        f, a = _imt(m), _mt_args(m, w)
        masked, _ = f(m.to_tensor(x), cache_kvs=[m.to_tensor(cache)],
                      time_step=4, attn_mask=m.to_tensor(pad), **a)
        plain, _ = f(m.to_tensor(x), cache_kvs=[m.to_tensor(cache)],
                     time_step=4, **a)
        assert not np.allclose(masked.numpy(), plain.numpy())
        res.append((masked, plain))
    for g, wnt in zip(*res):
        _close(g, wnt)


@pytest.mark.parametrize("time_step", [6, 9, 20])
def test_static_cache_write_is_clamped(time_step):
    """A chunk of 3 rows at ``time_step`` past ``T - 3`` lands at rows
    ``T - 3 ..`` (``jax.lax.dynamic_update_slice`` clamps the start);
    the decode mask keeps the unclamped step, as the reference's."""
    rng = np.random.default_rng(time_step)
    w = _mt_weights(6, layers=1)
    t_max = 8
    x = rng.standard_normal((2, 3, D)).astype(np.float32)
    cache = rng.standard_normal((2, 2, H, t_max, D // H)).astype(np.float32)
    res = []
    for m in (pt, jt):
        out, (c,) = _imt(m)(m.to_tensor(x), cache_kvs=[m.to_tensor(cache)],
                            time_step=time_step, **_mt_args(m, w))
        res.append((out, c))
    _close(res[0][1], res[1][1], what="cache")
    _close(res[0][0], res[1][0], what="out")
    start = min(time_step, t_max - 3)
    got = res[0][1].numpy()
    np.testing.assert_array_equal(got[:, :, :, :start], cache[:, :, :, :start])
    assert not np.allclose(got[:, :, :, start:], cache[:, :, :, start:])


def test_fused_multi_transformer_dropout_draws_the_references_masks():
    w = _mt_weights(7)
    x = np.random.default_rng(7).standard_normal((2, 4, D)).astype(
        np.float32)
    res = []
    for m in (pt, jt):
        m.seed(11)
        res.append(_imt(m)(m.to_tensor(x), dropout_rate=0.3, training=True,
                           **_mt_args(m, w)))
    _close(*res)


# ------------------------------------------------------- the other ops

def _attn_weights(seed, d=16):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=0.2):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return {"x": mk(2, 6, d, scale=1.0), "qkv_weight": mk(d, 3 * d),
            "linear_weight": mk(d, d), "qkv_bias": mk(3 * d),
            "linear_bias": mk(d), "ln_scale": mk(d) + 1.0, "ln_bias": mk(d),
            "w1": mk(d, 4 * d), "w2": mk(4 * d, d), "b1": mk(4 * d),
            "b2": mk(d)}


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_fused_multi_head_attention(pre, dropout):
    a = _attn_weights(8)

    def run(m, t):
        x = t["x"]
        x.stop_gradient = False
        m.seed(3)
        out = m.incubate.nn.functional.fused_multi_head_attention(
            x, t["qkv_weight"], t["linear_weight"], pre_layer_norm=pre,
            pre_ln_scale=t["ln_scale"], pre_ln_bias=t["ln_bias"],
            ln_scale=t["ln_scale"], ln_bias=t["ln_bias"],
            qkv_bias=t["qkv_bias"], linear_bias=t["linear_bias"],
            dropout_rate=dropout, attn_dropout_rate=dropout, num_heads=4)
        (out * out).sum().backward()
        return out, x.grad

    for g, w in zip(*_both(run, a)):
        _close(g, w)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_feedforward(pre, act):
    a = _attn_weights(9)

    def run(m, t):
        x = t["x"]
        x.stop_gradient = False
        m.seed(4)
        out = m.incubate.nn.functional.fused_feedforward(
            x, t["w1"], t["w2"], t["b1"], t["b2"], t["ln_scale"],
            t["ln_bias"], t["ln_scale"], t["ln_bias"], dropout1_rate=0.1,
            dropout2_rate=0.2, activation=act, pre_layer_norm=pre)
        (out * out).sum().backward()
        return out, x.grad

    for g, w in zip(*_both(run, a)):
        _close(g, w)


def test_swiglu_rms_norm_layer_norm_and_dropout_add():
    rng = np.random.default_rng(10)
    arrays = {"x": rng.standard_normal((3, 8)).astype(np.float32),
              "y": rng.standard_normal((3, 8)).astype(np.float32),
              "w": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}

    def run(m, t):
        IF = m.incubate.nn.functional
        m.seed(5)
        return (IF.swiglu(t["x"]), IF.swiglu(t["x"], t["y"]),
                IF.fused_rms_norm(t["x"], t["w"]),
                IF.fused_rms_norm(t["x"], t["w"], t["b"], epsilon=1e-5),
                IF.fused_layer_norm(t["x"], t["w"], t["b"]),
                IF.fused_dropout_add(t["x"], t["y"], p=0.25),
                IF.fused_bias_dropout_residual_layer_norm(
                    t["x"], t["y"], t["b"], t["w"], t["b"],
                    dropout_rate=0.3),
                IF.fused_linear(t["x"], t["y"], t["b"][:3],
                                transpose_weight=True),
                IF.fused_matmul_bias(t["x"], t["y"], t["b"][:3],
                                     transpose_y=True))

    for i, (g, w) in enumerate(zip(*_both(run, arrays))):
        _close(g, w, what=str(i))


# ---------------------------------------------------------- softmax masks

def test_softmax_mask_fuse():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 2, 4, 4).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 4, 4) < 0.3, -10000.0,
                    0.0).astype(np.float32)
    got, want = _both(lambda m, t: m.incubate.softmax_mask_fuse(
        t["x"], t["mask"]), {"x": x, "mask": mask})
    e = np.exp((x + mask) - (x + mask).max(-1, keepdims=True))
    np.testing.assert_allclose(got.numpy(), e / e.sum(-1, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    _close(got, want, 1e-6)


def test_softmax_mask_fuse_upper_triangle_and_its_gradient():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 5, 5).astype(np.float32)
    g = rng.randn(1, 2, 5, 5).astype(np.float32)

    def run(m, t):
        xt = t["x"]
        xt.stop_gradient = False
        out = m.incubate.softmax_mask_fuse_upper_triangle(xt)
        (out * t["g"]).sum().backward()
        return out, xt.grad

    (out, grad), (jout, jgrad) = _both(run, {"x": x, "g": g})
    for i in range(5):
        row = out.numpy()[0, 0, i]
        assert np.allclose(row[i + 1:], 0)
        np.testing.assert_allclose(row[:i + 1].sum(), 1.0, rtol=1e-5)
    _close(out, jout, 1e-6)
    _close(grad, jgrad, 1e-6)
    assert np.all(grad.numpy()[np.triu(np.ones((5, 5)), 1)[None, None]
                               .repeat(2, 1).astype(bool)] == 0)
