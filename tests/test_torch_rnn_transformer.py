"""The port's recurrent layers and Transformer stack
(``paddle_tpu_torch/nn/rnn.py``, ``transformer.py``) against the JAX
package's, on the CPU: ``tests/test_rnn_transformer.py`` case by case.

Each case runs one script on ``paddle_tpu`` and on ``paddle_tpu_torch``
under the same seed: the numpy oracles of the original hold for the port,
and the two packages agree (weights drawn from the same keys: the
recurrent cells' uniform ones bit for bit, the Linear layers' normal
ones within 3 ulps; results within ``TOL``). Then the stacks with the
reference's weights carried across by ``set_state_dict``, forward and
backward within ``TOL``; and on the card's rules, K4 exactly where the
reference takes its Pallas kernel.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _np(t):
    if torch.is_tensor(t):
        return t.detach().double().numpy()
    if isinstance(t, np.ndarray):
        return t.astype(np.float64)
    return np.asarray(t.numpy(), dtype=np.float64)


def both(script, seed=0):
    """``script(m)`` on the port, then on the reference, each under
    ``seed``; the results (nested lists of tensors) compared within TOL.
    Returns the port's."""
    pt.seed(seed)
    got = script(pt)
    jt.seed(seed)
    want = script(jt)

    def cmp(g, w, where):
        if isinstance(g, (list, tuple)):
            for i, (a, b) in enumerate(zip(g, w)):
                cmp(a, b, f"{where}.{i}")
        elif g is not None and not isinstance(g, (int, float, str, bool)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL,
                                       err_msg=where)
    cmp(got, want, "out")
    return got


def _sig(v):
    return 1 / (1 + np.exp(-v))


class TestCells:
    def test_simple_rnn_cell_oracle(self):
        def s(m):
            cell = m.nn.SimpleRNNCell(4, 6)
            x, h = m.randn([3, 4]), m.randn([3, 6])
            out, new_h = cell(x, h)
            return [out, new_h, cell.weight_ih, cell.weight_hh,
                    cell.bias_ih, cell.bias_hh, x, h]
        out, new_h, wi, wh, bi, bh, x, h = both(s)
        ref = np.tanh(_np(x) @ _np(wi).T + _np(bi) + _np(h) @ _np(wh).T
                      + _np(bh))
        np.testing.assert_allclose(_np(out), ref, atol=1e-5)
        np.testing.assert_allclose(_np(new_h), ref, atol=1e-5)

    def test_lstm_cell_oracle(self):
        def s(m):
            cell = m.nn.LSTMCell(4, 5)
            x, h, c = m.randn([2, 4]), m.randn([2, 5]), m.randn([2, 5])
            out, (h2, c2) = cell(x, (h, c))
            return [out, h2, c2, x, h, c, cell.weight_ih, cell.weight_hh,
                    cell.bias_ih, cell.bias_hh]
        out, h2, c2, x, h, c, wi, wh, bi, bh = both(s)
        gates = _np(x) @ _np(wi).T + _np(bi) + _np(h) @ _np(wh).T + _np(bh)
        i, f, g, o = np.split(gates, 4, axis=-1)
        c_ref = _sig(f) * _np(c) + _sig(i) * np.tanh(g)
        h_ref = _sig(o) * np.tanh(c_ref)
        np.testing.assert_allclose(_np(h2), h_ref, atol=1e-5)
        np.testing.assert_allclose(_np(c2), c_ref, atol=1e-5)
        np.testing.assert_allclose(_np(out), h_ref, atol=1e-5)

    def test_gru_cell_oracle(self):
        def s(m):
            cell = m.nn.GRUCell(3, 4)
            x, h = m.randn([2, 3]), m.randn([2, 4])
            out, _ = cell(x, h)
            return [out, x, h, cell.weight_ih, cell.weight_hh, cell.bias_ih,
                    cell.bias_hh]
        out, x, h, wi, wh, bi, bh = both(s)
        xg = _np(x) @ _np(wi).T + _np(bi)
        hg = _np(h) @ _np(wh).T + _np(bh)
        x_r, x_z, x_c = np.split(xg, 3, -1)
        h_r, h_z, h_c = np.split(hg, 3, -1)
        r, z = _sig(x_r + h_r), _sig(x_z + h_z)
        ref = z * _np(h) + (1 - z) * np.tanh(x_c + r * h_c)
        np.testing.assert_allclose(_np(out), ref, atol=1e-5)


class TestRNNWrappers:
    def test_scan_matches_stepwise(self):
        def s(m):
            cell = m.nn.LSTMCell(4, 5)
            x = m.randn([2, 7, 4])
            outs, (hf, cf) = m.nn.RNN(cell)(x)
            h, c = m.zeros([2, 5]), m.zeros([2, 5])
            steps = []
            for t in range(7):
                o, (h, c) = cell(m.to_tensor(x.numpy()[:, t]), (h, c))
                steps.append(o.numpy())
            return [outs, hf, cf, np.stack(steps, axis=1), h, c]
        outs, hf, cf, ref, h, c = both(s)
        np.testing.assert_allclose(_np(outs), ref, atol=1e-5)
        np.testing.assert_allclose(_np(hf), _np(h), atol=1e-5)
        np.testing.assert_allclose(_np(cf), _np(c), atol=1e-5)

    def test_sequence_length_masks(self):
        def s(m):
            rnn = m.nn.RNN(m.nn.GRUCell(3, 4))
            x = m.randn([2, 6, 3])
            sl = m.to_tensor(np.array([4, 6], dtype=np.int32))
            outs, fin = rnn(x, sequence_length=sl)
            full, _ = rnn(x)
            return [outs, fin, full]
        outs, fin, full = both(s)
        o = _np(outs)
        assert np.allclose(o[0, 4:], 0.0)
        assert not np.allclose(o[1, 5], 0.0)
        np.testing.assert_allclose(_np(fin)[0], _np(full)[0, 3], atol=1e-5)

    def test_birnn_and_stacked(self):
        def s(m):
            lstm = m.nn.LSTM(8, 16, num_layers=2, direction="bidirect")
            x = m.randn([3, 5, 8])
            outs, (h, c) = lstm(x)
            birnn = m.nn.BiRNN(m.nn.SimpleRNNCell(8, 6),
                               m.nn.SimpleRNNCell(8, 6))
            o2, (ff, fb) = birnn(x)
            return [outs, h, c, o2, ff, fb]
        outs, h, c, o2, ff, fb = both(s)
        assert list(outs.shape) == [3, 5, 32]
        assert list(h.shape) == [4, 3, 16] and list(c.shape) == [4, 3, 16]
        assert list(o2.shape) == [3, 5, 12]

    def test_gru_layer_shapes_and_grad(self):
        def s(m):
            gru = m.nn.GRU(4, 8, num_layers=1)
            x = m.randn([2, 5, 4])
            x.stop_gradient = False
            outs, h = gru(x)
            outs.sum().backward()
            return [outs, h, gru._cells[0].weight_ih.grad, x.grad]
        outs, h, g, gx = both(s)
        assert list(outs.shape) == [2, 5, 8] and list(h.shape) == [1, 2, 8]
        assert g is not None and np.isfinite(_np(g)).all()

    def test_time_major(self):
        def s(m):
            outs, h = m.nn.SimpleRNN(4, 6, time_major=True)(
                m.randn([5, 2, 4]))
            return [outs, h]
        outs, h = both(s)
        assert list(outs.shape) == [5, 2, 6]


class TestTransformer:
    def test_mha_self_attention_oracle(self):
        def s(m):
            mha = m.nn.MultiHeadAttention(16, 4)
            mha.eval()
            x = m.randn([2, 5, 16])
            return [mha(x), x] + [getattr(mha, p + "_proj").weight
                                  for p in "qkvo" if p != "o"] + [
                mha.out_proj.weight, mha.q_proj.bias, mha.k_proj.bias,
                mha.v_proj.bias, mha.out_proj.bias]
        out, x, wq, wk, wv, wo, bq, bk, bv, bo = both(s)
        B, S, H, D = 2, 5, 4, 4
        q, k, v = ((_np(x) @ _np(w) + _np(b)).reshape(B, S, H, D)
                   .transpose(0, 2, 1, 3)
                   for w, b in ((wq, bq), (wk, bk), (wv, bv)))
        sc = q @ k.transpose(0, 1, 3, 2) / np.sqrt(D)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        o = (p @ v).transpose(0, 2, 1, 3).reshape(B, S, 16)
        np.testing.assert_allclose(_np(out), o @ _np(wo) + _np(bo),
                                   atol=2e-3, rtol=2e-3)

    def test_mha_bool_and_float_mask_agree(self):
        keep = np.tril(np.ones((1, 1, 4, 4), dtype=bool))
        fmask = np.where(keep, 0.0, -1e9).astype(np.float32)

        def s(m):
            mha = m.nn.MultiHeadAttention(8, 2)
            mha.eval()
            x = m.randn([1, 4, 8])
            return [mha(x, attn_mask=m.to_tensor(keep)),
                    mha(x, attn_mask=m.to_tensor(fmask))]
        out_b, out_f = both(s)
        np.testing.assert_allclose(_np(out_b), _np(out_f), atol=1e-5)

    def test_mha_cache_decode_matches_full(self):
        causal = np.tril(np.ones((1, 1, 6, 6), dtype=bool))

        def s(m):
            mha = m.nn.MultiHeadAttention(8, 2)
            mha.eval()
            x = m.randn([1, 6, 8])
            full = mha(x, attn_mask=m.to_tensor(causal))
            cache = mha.gen_cache(m.zeros([1, 0, 8]))
            steps = []
            for t in range(6):
                xt = m.to_tensor(x.numpy()[:, t:t + 1])
                o, cache = mha(xt, xt, xt, None, cache)
                steps.append(o.numpy())
            return [full, np.concatenate(steps, axis=1), cache.k]
        full, inc, k = both(s)
        np.testing.assert_allclose(inc, _np(full), atol=1e-4, rtol=1e-4)
        assert list(k.shape) == [1, 6, 2, 4]

    def test_encoder_decoder_shapes(self):
        def s(m):
            model = m.nn.Transformer(d_model=16, nhead=2,
                                     num_encoder_layers=2,
                                     num_decoder_layers=2,
                                     dim_feedforward=32, dropout=0.0)
            model.eval()
            src, tgt = m.randn([2, 6, 16]), m.randn([2, 4, 16])
            mask = model.generate_square_subsequent_mask(4)
            return [model(src, tgt), mask, model(src, tgt, tgt_mask=mask)]
        out, mask, out2 = both(s)
        assert list(out.shape) == [2, 4, 16] and list(mask.shape) == [4, 4]
        assert isinstance(mask, pt.Tensor)
        assert np.isfinite(_np(out2)).all()

    def test_encoder_layers_independent_params(self):
        for m in (jt, pt):
            enc = m.nn.TransformerEncoder(
                m.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 3)
            names = [n for n, _ in enc.named_parameters()]
            assert len(names) == len(set(names)) == 3 * 16
        assert names == [n for n, _ in jt.nn.TransformerEncoder(
            jt.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
            3).named_parameters()]

    def test_encoder_grad_flows(self):
        def s(m):
            enc = m.nn.TransformerEncoder(
                m.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2)
            out = enc(m.randn([2, 3, 8]))
            out.sum().backward()
            return [out] + [p.grad for _, p in enc.named_parameters()]
        grads = both(s)[1:]
        assert all(g is not None for g in grads)


class TestReviewRegressions:
    def test_lstm_list_initial_states(self):
        def s(m):
            lstm = m.nn.LSTM(4, 8)
            x = m.randn([2, 5, 4])
            h0, c0 = m.zeros([1, 2, 8]), m.zeros([1, 2, 8])
            return [lstm(x, (h0, c0))[0], lstm(x, [h0, c0])[0]]
        out_t, out_l = both(s)
        np.testing.assert_allclose(_np(out_t), _np(out_l))

    def test_gen_cache_seeded_with_kv(self):
        def s(m):
            mha = m.nn.MultiHeadAttention(8, 2)
            mha.eval()
            x = m.randn([1, 3, 8])
            cache = mha.gen_cache(m.randn([1, 2, 2, 4]),
                                  m.randn([1, 2, 2, 4]))
            assert isinstance(cache, m.nn.MultiHeadAttention.Cache)
            o, cache2 = mha(x, x, x, None, cache)
            return [o, cache2.k, cache2.v]
        o, k, v = both(s)
        assert list(k.shape) == [1, 5, 2, 4]

    def test_unknown_activation_raises(self):
        with pytest.raises(ValueError):
            pt.nn.TransformerEncoderLayer(8, 2, 16, activation="not_an_act")


def _carry(jl, tl):
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert tl.set_state_dict(sd) == ([], [])


STACKS = {
    "LSTM_bidirect_seqlen": (
        lambda m: m.nn.LSTM(5, 6, num_layers=2, direction="bidirect"),
        (3, 7, 5), True),
    "GRU_time_major": (lambda m: m.nn.GRU(5, 6, num_layers=2,
                                          time_major=True), (7, 3, 5), False),
    "SimpleRNN_relu": (lambda m: m.nn.SimpleRNN(5, 6, activation="relu"),
                       (3, 7, 5), False),
    "EncoderLayer_pre_norm": (lambda m: m.nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, normalize_before=True, activation="gelu"),
        (2, 5, 16), False),
    "MHA_need_weights": (lambda m: m.nn.MultiHeadAttention(
        16, 2, need_weights=True), (2, 5, 16), False),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stack_with_carried_weights(name):
    make, shape, seqlen = STACKS[name]
    jl, tl = make(jt), make(pt)
    _carry(jl, tl)
    jl.eval()
    tl.eval()
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jx = jt.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x).requires_grad_()
    extra = {}
    if seqlen:
        extra = {"sequence_length": np.array([7, 3, 5], np.int32)}
    jo = jl(jx, **{k: jt.to_tensor(v) for k, v in extra.items()})
    to = tl(tx, **{k: torch.tensor(v) for k, v in extra.items()})
    jo0, to0 = (jo[0], to[0]) if isinstance(jo, tuple) else (jo, to)
    np.testing.assert_allclose(_np(to0), _np(jo0), rtol=TOL, atol=TOL)
    if name == "MHA_need_weights":
        np.testing.assert_allclose(_np(to[1]), _np(jo[1]), rtol=TOL,
                                   atol=TOL)
    jo0.sum().backward()
    to0.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), rtol=TOL,
                               atol=TOL)
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jp[n].grad), rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_transformer_carried_forward_and_backward_with_masks():
    make = lambda m: m.nn.Transformer(  # noqa: E731
        d_model=16, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
        dim_feedforward=24, dropout=0.0)
    jl, tl = make(jt), make(pt)
    _carry(jl, tl)
    rng = np.random.default_rng(4)
    src = rng.standard_normal((2, 6, 16)).astype(np.float32)
    tgt = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jo = jl(jt.to_tensor(src), jt.to_tensor(tgt),
            tgt_mask=jl.generate_square_subsequent_mask(5))
    to = tl(torch.tensor(src), torch.tensor(tgt),
            tgt_mask=tl.generate_square_subsequent_mask(5))
    assert isinstance(to, pt.Tensor)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=TOL, atol=TOL)
    jo.sum().backward()
    to.sum().backward()
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jp[n].grad), rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_attention_takes_k4_exactly_where_the_reference_takes_pallas(
        monkeypatch):
    """No mask and no dropout rate: the flash-attention path (K4's plain
    version here); a mask or ``dropout > 0`` (while training or not): the
    composition, as the reference checks ``dropout_p == 0.0``."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 4, 16, generator=torch.Generator().manual_seed(0))
    mha = pt.nn.MultiHeadAttention(16, 2)
    mha.eval()
    mha(x)
    assert calls == [1]
    mha(x, attn_mask=torch.zeros(1, 1, 4, 4))
    mha.dropout = 0.1
    mha(x)
    assert calls == [1]
    enc = pt.nn.TransformerEncoderLayer(16, 2, 32)     # paddle's defaults
    enc.train()
    enc(x)
    assert calls == [1]
    enc = pt.nn.TransformerEncoderLayer(16, 2, 32, attn_dropout=0.0)
    enc(x)
    assert calls == [1, 1]
