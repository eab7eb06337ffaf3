"""The port's BERT, DiT and Qwen-VL (``paddle_tpu_torch/models/bert.py``,
``dit.py``, ``qwen_vl.py``, ``_stem.py``) and its ``LlamaModel`` against
the JAX package's, on the CPU: ``tests/test_bert.py`` and
``tests/test_dit_multimodal.py`` case by case.

Each case builds the reference model, carries its parameters into the
port's with ``models.bridge.load_jax_params`` (the zero-initialised
adaLN and final projections of DiT drawn anew first, so that they carry
signal), runs the same inputs through both and holds the port to the
reference: logits and losses within ``TOL`` (f32), gradients within
``GRAD_RTOL`` of each tensor's largest value (the key projections'
biases, zero in exact arithmetic, of ``GRAD_FLOOR`` of the model's
largest gradient), ``QwenVL.generate``'s
greedy and seeded-sampled tokens equal. The attention routing is the
reference's: ``bert_base()``'s dropout rate keeps BERT off the flash
kernel (K4) even in eval, DiT and the ViT take it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu.core import random as jrandom
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import dit as jdit
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import qwen_vl as jqwen
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import models as tm
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import dit as tdit
from paddle_tpu_torch.models import qwen_vl as tqwen
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-5
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-4
ZERO_GRAD = "k_proj.bias"


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


def close(got, want, tol=TOL, what="value"):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def bridge(ref, port, rng=None, redraw=()):
    """The reference's parameters into ``port`` (and back into ``ref``
    for the names in ``redraw``, drawn N(0, 0.05) from ``rng`` first)."""
    arrays = {n: np.array(p.numpy()) for n, p in ref.named_parameters()}
    if redraw:
        new = {n: (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
               for n, a in arrays.items() if any(k in n for k in redraw)}
        ref.set_state_dict({n: a.copy() for n, a in new.items()})
        arrays.update(new)
    tm.load_jax_params(port, arrays)
    return port


def grads_close(ref, port):
    """Every parameter's gradient within ``GRAD_RTOL`` of its largest
    value; the key projections' biases (``ZERO_GRAD``) within
    ``GRAD_RTOL`` of ``GRAD_FLOOR`` of the model's largest gradient (a
    softmax ignores a shift of its row, so theirs is zero in exact
    arithmetic and rounding noise on both sides)."""
    tgrads = dict(port.named_parameters())
    wants = {name: None if p.grad is None else _np(p.grad)
             for name, p in ref.named_parameters()}
    top = max(np.abs(w).max() for w in wants.values() if w is not None)
    n = 0
    for name, want in wants.items():
        got = tgrads[name].grad
        if want is None:
            assert got is None or not got.abs().max(), name
            continue
        scale = max(np.abs(want).max(),
                    GRAD_FLOOR * top if name.endswith(ZERO_GRAD) else 0.0)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
        n += 1
    assert n > 0


def _ids(rng, b, s, vocab, dtype=np.int32):
    return rng.randint(0, vocab, size=(b, s)).astype(dtype)


def _t(a):
    return torch.tensor(np.asarray(a))


class _K4Spy:
    """Counts the calls ``nn.functional`` makes of the flash-attention
    entry (its CPU plain version here, the kernels on the card)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = TF._fa.flash_attention

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)
        monkeypatch.setattr(TF._fa, "flash_attention", spy)


# ================================================================ BERT
class TestBert:
    def _pair(self, cls, cfg, *args):
        ref = getattr(jbert, cls)(cfg, *args)
        port = getattr(tbert, cls)(tbert.BertConfig(**vars(cfg)), *args)
        ref.eval()
        port.eval()
        return ref, bridge(ref, port)

    def test_bert_model_shapes(self):
        rng = np.random.RandomState(0)
        ref, port = self._pair("BertModel", jbert.bert_tiny())
        ids = _ids(rng, 2, 16, 128)
        seq, pooled = port(_t(ids))
        assert list(seq.shape) == [2, 16, 64]
        assert list(pooled.shape) == [2, 64]
        rseq, rpooled = ref(jt.to_tensor(ids))
        close(seq, rseq, what="sequence")
        close(pooled, rpooled, what="pooled")

    def test_pretraining_loss_grads_and_steps(self):
        rng = np.random.RandomState(1)
        ref, port = self._pair("BertForPretraining", jbert.bert_tiny())
        ids = _ids(rng, 4, 16, 128)
        labels = _ids(rng, 4, 16, 128)
        nsp = rng.randint(0, 2, size=(4,)).astype(np.int32)
        mlm, ns = port(_t(ids))
        loss = port.loss(mlm, ns, labels, nsp)
        rmlm, rns = ref(jt.to_tensor(ids))
        rloss = ref.loss(rmlm, rns, jt.to_tensor(labels), jt.to_tensor(nsp))
        close(mlm, rmlm, what="mlm logits")
        close(ns, rns, what="nsp logits")
        close(loss, rloss, what="loss")
        loss.backward()
        rloss.backward()
        grads_close(ref, port)
        # the reference's descent (its own test is slow-marked): a few
        # AdamW steps on the port, the loss falls
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=port.parameters())
        opt.clear_grad()
        losses = []
        for _ in range(4):
            mlm, ns = port(_t(ids))
            loss = port.loss(mlm, ns, labels, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_sequence_classification(self):
        rng = np.random.RandomState(2)
        ref, port = self._pair("BertForSequenceClassification",
                               jbert.bert_tiny(), 3)
        ids = _ids(rng, 2, 16, 128)
        out = port(_t(ids))
        assert tuple(out.shape) == (2, 3)
        close(out, ref(jt.to_tensor(ids)), what="class logits")

    def test_masked_labels_ignore_index(self):
        rng = np.random.RandomState(3)
        ref, port = self._pair("BertForPretraining", jbert.bert_tiny())
        ids = _ids(rng, 2, 8, 128)
        labels = np.full((2, 8), -100, np.int32)
        labels[0, 3] = 7              # one supervised position
        nsp = np.array([0, 1], np.int32)
        mlm, ns = port(_t(ids))
        loss = port.loss(mlm, ns, labels, nsp)
        assert np.isfinite(float(loss))
        rmlm, rns = ref(jt.to_tensor(ids))
        close(loss, ref.loss(rmlm, rns, jt.to_tensor(labels),
                             jt.to_tensor(nsp)), what="loss")

    def test_attention_mask_masks_padding(self):
        rng = np.random.RandomState(4)
        ref, port = self._pair("BertModel", jbert.bert_tiny())
        ids = _ids(rng, 2, 8, 128)
        mask = np.ones((2, 8), np.int32)
        mask[:, 6:] = 0               # the last two tokens are padding
        full, _ = port(_t(ids))
        masked, _ = port(_t(ids), attention_mask=_t(mask))
        assert np.isfinite(_np(masked)).all()
        assert not np.allclose(_np(masked)[:, :6], _np(full)[:, :6])
        rmasked, _ = ref(jt.to_tensor(ids),
                         attention_mask=jt.to_tensor(mask))
        close(masked, rmasked, what="masked sequence")
        # a bool keep-mask passes through to the encoder's conversion
        bmasked, _ = port(_t(ids), attention_mask=_t(mask.astype(bool)))
        rb, _ = ref(jt.to_tensor(ids),
                    attention_mask=jt.to_tensor(mask.astype(bool)))
        close(bmasked, rb, what="bool-masked sequence")

    def test_token_types_and_positions(self):
        rng = np.random.RandomState(5)
        ref, port = self._pair("BertModel", jbert.bert_tiny())
        ids = _ids(rng, 2, 8, 128)
        types = _ids(rng, 2, 8, 2)
        pos = np.arange(8, 16, dtype=np.int32)
        seq, _ = port(_t(ids), token_type_ids=_t(types),
                      position_ids=_t(pos))
        rseq, _ = ref(jt.to_tensor(ids), token_type_ids=jt.to_tensor(types),
                      position_ids=jt.to_tensor(pos))
        close(seq, rseq, what="sequence")

    @pytest.mark.parametrize("dropout,masked,k4", [
        (0.0, False, 2), (0.0, True, 0), (0.1, False, 0)])
    def test_attention_routing_is_the_references(self, monkeypatch,
                                                 dropout, masked, k4):
        """K4 exactly where the reference takes its Pallas kernel: no
        mask and a zero dropout rate, whatever the mode (bert_base's
        0.1 keeps it off in eval too)."""
        spy = _K4Spy(monkeypatch)
        model = tbert.BertModel(tbert.bert_tiny(dropout=dropout))
        model.eval()
        ids = _t(np.ones((1, 8), np.int32))
        mask = _t(np.ones((1, 8), np.int32)) if masked else None
        model(ids, attention_mask=mask)
        assert spy.calls == k4

    def test_bert_base_widths(self):
        cfg = tbert.bert_base()
        assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
                cfg.intermediate_size, cfg.vocab_size,
                cfg.dropout) == (768, 12, 12, 3072, 30522, 0.1)
        assert vars(cfg) == vars(jbert.bert_base())

    def test_state_dict_keys_are_the_references(self):
        ref = jbert.BertForPretraining(jbert.bert_tiny())
        port = tbert.BertForPretraining(tbert.bert_tiny())
        assert set(port.state_dict()) == set(ref.state_dict())
        assert set(tm.export_params(port)) == set(ref.state_dict())


# ================================================================= DiT
_REDRAW = ("ada", "final_layer.linear")


class TestDiT:
    def _pair(self, seed=0, cls="DiTForDiffusion"):
        rng = np.random.RandomState(seed)
        ref = getattr(jdit, cls)(jdit.dit_tiny())
        port = getattr(tdit, cls)(tdit.dit_tiny())
        return rng, ref, bridge(ref, port, rng, _REDRAW)

    def test_forward_shapes(self):
        rng, ref, port = self._pair(0)
        x = rng.randn(2, 3, 8, 8).astype(np.float32)
        t = np.array([0, 500], np.int32)
        y = np.array([1, 2], np.int32)
        out = port(_t(x), _t(t), _t(y))
        assert list(out.shape) == [2, 3, 8, 8]
        close(out, ref(jt.to_tensor(x), jt.to_tensor(t), jt.to_tensor(y)),
              what="eps prediction")
        # unconditional (no label)
        close(port(_t(x), _t(t)), ref(jt.to_tensor(x), jt.to_tensor(t)),
              what="unconditional")

    def test_diffusion_loss_and_grads(self):
        rng, ref, port = self._pair(1)
        x0 = rng.randn(2, 3, 8, 8).astype(np.float32)
        t = np.array([10, 990], np.int32)
        noise = rng.randn(2, 3, 8, 8).astype(np.float32)
        y = np.array([3, 10], np.int32)        # 10: the null label
        loss = port.loss(_t(x0), _t(t), _t(noise), _t(y))
        rloss = ref.loss(jt.to_tensor(x0), jt.to_tensor(t),
                         jt.to_tensor(noise), jt.to_tensor(y))
        assert np.isfinite(float(loss))
        close(loss, rloss, what="loss")
        loss.backward()
        rloss.backward()
        blk = port.dit.blocks[0]
        for p in (blk.qkv.weight, blk.ada.weight,
                  port.dit.patch_embed.weight, port.dit.pos_embed):
            assert p.grad is not None and torch.isfinite(p.grad).all()
        grads_close(ref, port)

    def test_add_noise_and_schedule(self):
        rng, ref, port = self._pair(2)
        close(port.alphas_cumprod, np.asarray(ref.alphas_cumprod),
              what="alphas_cumprod")
        x0 = rng.randn(3, 3, 8, 8).astype(np.float32)
        noise = rng.randn(3, 3, 8, 8).astype(np.float32)
        t = np.array([0, 499, 999], np.int32)
        close(port.add_noise(_t(x0), _t(noise), _t(t)),
              ref.add_noise(jt.to_tensor(x0), jt.to_tensor(noise),
                            jt.to_tensor(t)), what="x_t")
        # a constant, not a parameter: outside the state dict
        assert "alphas_cumprod" not in port.state_dict()
        assert set(port.state_dict()) == set(ref.state_dict())

    def test_timestep_embedding(self):
        """Within 1e-4: at t = 999 an angle carries an f32 ulp of 6.1e-5,
        and the two libraries' f32 ``exp`` differ in the last bit for 14
        of the 128 frequencies."""
        import jax.numpy as jnp
        t = np.array([0, 3, 500, 999], np.int32)
        for dim in (256, 7):
            close(tdit.timestep_embedding(_t(t), dim),
                  np.asarray(jdit.timestep_embedding(jnp.asarray(t), dim)),
                  tol=1e-4, what=f"dim {dim}")

    def test_adaln_zero_identity_at_init(self):
        """adaLN-Zero: the gates start at 0, so each block is the
        identity and the final layer outputs 0."""
        m = tdit.DiT(tdit.dit_tiny())
        x = _t(np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32))
        out = m(x, _t(np.array([3, 7], np.int32)))
        np.testing.assert_allclose(_np(out), 0.0, atol=1e-6)
        h = torch.randn(2, m.cfg.num_patches, m.cfg.hidden_size)
        c = torch.randn(2, m.cfg.hidden_size)
        torch.testing.assert_close(m.blocks[0](h, c), h, rtol=0, atol=0)

    def test_training_reduces_loss(self):
        rng, _, port = self._pair(4)
        opt = pt.optimizer.AdamW(learning_rate=3e-3,
                                 parameters=port.parameters())
        x0 = _t(rng.randn(4, 3, 8, 8).astype(np.float32))
        t = _t(np.array([5, 105, 505, 905], np.int32))
        noise = _t(rng.randn(4, 3, 8, 8).astype(np.float32))
        losses = []
        for _ in range(6):
            loss = port.loss(x0, t, noise)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_attention_takes_k4(self, monkeypatch):
        spy = _K4Spy(monkeypatch)
        _, _, port = self._pair(5)
        port(_t(np.zeros((1, 3, 8, 8), np.float32)),
             _t(np.array([1], np.int32)))
        assert spy.calls == port.cfg.num_layers

    def test_dit_s_4_widths(self):
        cfg = tdit.dit_s_4()
        assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
                cfg.patch_size, cfg.image_size, cfg.in_channels,
                cfg.num_classes, cfg.num_patches) == (384, 12, 6, 4, 32, 4,
                                                       1000, 64)
        assert vars(cfg) == vars(jdit.dit_s_4())

    def test_auto_parallel_shard_raises_naming_item_13(self):
        with pytest.raises(NotImplementedError, match="item 13"):
            tdit.shard_dit(tdit.DiT(tdit.dit_tiny()), None)


# ============================================================= Qwen-VL
class TestQwenVL:
    def _pair(self):
        ref = jqwen.QwenVL(jqwen.qwen_vl_tiny())
        port = tqwen.QwenVL(tqwen.qwen_vl_tiny())
        return ref, bridge(ref, port)

    def test_multimodal_forward(self):
        rng = np.random.RandomState(0)
        ref, port = self._pair()
        ids = _ids(rng, 2, 32, 256)
        px = rng.randn(2, 3, 16, 16).astype(np.float32)
        logits = port(_t(ids), _t(px))
        n_vis = port.cfg.vision.num_patches
        assert list(logits.shape) == [2, n_vis + 32, 256]
        close(logits, ref(jt.to_tensor(ids), jt.to_tensor(px)),
              what="joint logits")

    def test_text_only_forward(self):
        rng = np.random.RandomState(1)
        ref, port = self._pair()
        ids = _ids(rng, 2, 16, 256)
        logits = port(_t(ids))
        assert list(logits.shape) == [2, 16, 256]
        close(logits, ref(jt.to_tensor(ids)), what="text logits")

    def test_loss_masks_visual_prefix_and_grads_flow(self):
        rng = np.random.RandomState(2)
        ref, port = self._pair()
        ids = _ids(rng, 2, 32, 256)
        px = rng.randn(2, 3, 16, 16).astype(np.float32)
        loss = port.loss(port(_t(ids), _t(px)), _t(ids))
        rloss = ref.loss(ref(jt.to_tensor(ids), jt.to_tensor(px)),
                         jt.to_tensor(ids))
        assert np.isfinite(float(loss))
        close(loss, rloss, what="loss")
        loss.backward()
        rloss.backward()
        assert port.visual.blocks[0].qkv.weight.grad is not None
        assert port.projector.weight.grad is not None
        assert port.lm_head.weight.grad is not None
        grads_close(ref, port)

    @pytest.mark.parametrize("mode", ["greedy", "sampled"])
    def test_generate_tokens_are_the_references(self, mode):
        rng = np.random.RandomState(3)
        ref, port = self._pair()
        ids = _ids(rng, 2, 8, 256)
        px = rng.randn(2, 3, 16, 16).astype(np.float32)
        kw = {} if mode == "greedy" else dict(
            do_sample=True, temperature=0.8, top_k=50, top_p=0.95, seed=7)
        got = port.generate(_t(ids), _t(px), max_new_tokens=8, **kw)
        want = ref.generate(jt.to_tensor(ids), jt.to_tensor(px),
                            max_new_tokens=8, **kw)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
        # text only
        got = port.generate(_t(ids), max_new_tokens=4, **kw)
        want = ref.generate(jt.to_tensor(ids), max_new_tokens=4, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))

    def test_generate_keeps_at_most_four_bundles(self):
        _, port = self._pair()
        ids = np.ones((1, 4), np.int32)
        for cache_len in (24, 32, 40, 48, 56):
            port.generate(_t(ids), max_new_tokens=2,
                          max_cache_len=cache_len)
        assert list(port._pt_decode_cache) == [
            ("_pt_vl_bundle", n) for n in (32, 40, 48, 56)]
        with pytest.raises(ValueError, match="exceeds max_cache_len"):
            port.generate(_t(ids), _t(np.zeros((1, 3, 16, 16), np.float32)),
                          max_new_tokens=8, max_cache_len=20)

    def test_unseeded_sampling_draws_its_seed_from_numpy(self):
        _, port = self._pair()
        ids = _t(np.ones((1, 4), np.int32))
        np.random.seed(11)
        a = port.generate(ids, max_new_tokens=6, do_sample=True)
        np.random.seed(11)
        seed = int(np.random.randint(0, 2**31))
        b = port.generate(ids, max_new_tokens=6, do_sample=True, seed=seed)
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_bf16_casts_visual_tokens_to_the_text_dtype(self):
        port = tqwen.QwenVL(tqwen.qwen_vl_tiny(), dtype="bfloat16")
        assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
        rng = np.random.RandomState(4)
        logits = port(_t(_ids(rng, 1, 8, 256)),
                      _t(rng.randn(1, 3, 16, 16)).to(torch.bfloat16))
        assert logits.dtype == torch.bfloat16
        assert torch.isfinite(logits.float()).all()

    def test_state_dict_keys_are_the_references(self):
        ref, port = self._pair()
        assert set(port.state_dict()) == set(ref.state_dict())
        assert {n for n in port.state_dict()
                if n.startswith("language_model.")} == {
            n for n in ref.state_dict() if n.startswith("language_model.")}

    def test_qwen_vl_default_widths(self):
        cfg = tqwen.QwenVLConfig()
        assert (cfg.vision.num_patches, cfg.vision.hidden_size,
                cfg.vision.num_layers, cfg.text.hidden_size,
                cfg.text.num_layers) == (256, 1024, 24, 4096, 32)

    def test_auto_parallel_shard_raises_naming_item_13(self):
        with pytest.raises(NotImplementedError, match="item 13"):
            tqwen.shard_qwen_vl(None, None)
        from paddle_tpu_torch.models._stem import shard_params_by_name
        with pytest.raises(NotImplementedError, match="item 13"):
            shard_params_by_name(None, None, ("qkv",))


# ======================================================== the backbone
def test_llama_model_is_the_references():
    rng = np.random.RandomState(0)
    cfg = jllama.llama_tiny()
    ref = jllama.LlamaModel(cfg)
    port = tm.LlamaModel(tm.llama_tiny(), device="cpu")
    bridge(ref, port)
    assert set(port.state_dict()) == set(ref.state_dict())
    ids = _ids(rng, 2, 12, 256)
    close(port(_t(ids)), ref(jt.to_tensor(ids)), what="hidden")
    close(port.embed_tokens(_t(ids)), ref.embed_tokens(jt.to_tensor(ids)),
          what="embed_tokens")
    x = rng.randn(2, 5, 64).astype(np.float32)
    close(port.norm(_t(x)), ref.norm(jt.to_tensor(x)), what="norm")
    close(port.layers[0](_t(x)), ref.layers[0](jt.to_tensor(x)),
          what="block")


def test_llama_model_draws_the_references_weights():
    """Under one ``seed()`` a ``LlamaModel`` is the reference's, weight for
    weight (the normal draws within ``NORMAL_ULPS``), and the global key
    has moved as far; the ``LlamaForCausalLM`` around one draws from its
    own seed and leaves the global key alone."""
    cfg = jllama.llama_tiny()
    jt.seed(5)
    ref = jllama.LlamaModel(cfg)
    pt.seed(5)
    port = tm.LlamaModel(tm.llama_tiny(), device="cpu")
    _same_weights(port, ref)
    before = pt.get_rng_state()
    lm = tm.LlamaForCausalLM(tm.llama_tiny(), device="cpu", seed=3)
    assert pt.get_rng_state()[1] == before[1]
    assert not torch.equal(lm.model.embed_tokens.weight,
                           port.embed_tokens.weight)


def test_qwen_vl_draws_the_references_weights():
    """Under one ``seed()`` the whole ``QwenVL`` (the ViT, the projector,
    the text tower and the head) is the reference's."""
    jt.seed(9)
    ref = jqwen.QwenVL(jqwen.qwen_vl_tiny())
    pt.seed(9)
    port = tqwen.QwenVL(tqwen.qwen_vl_tiny(), device="cpu")
    _same_weights(port, ref)


# the normal draws within 3 f32 ulps (tests/test_torch_nn_init.py: their
# transcendentals are torch's and XLA's), and Xavier's scaling of them
# one rounding more
NORMAL_ULPS = 4


def _same_weights(port, ref):
    """Every parameter of ``port`` is ``ref``'s within ``NORMAL_ULPS``
    (the constant ones exactly), and the next key of the two global
    streams is the same."""
    want = {n: np.asarray(p.numpy(), np.float32)
            for n, p in ref.named_parameters()}
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().numpy()
        iw, ig = (np.where(a < 0, -(a & 0x7FFFFFFF), a) for a in (
            x.view(np.int32).astype(np.int64) for x in (w, g)))
        assert np.abs(ig - iw).max() <= NORMAL_ULPS, name
    assert np.array_equal(np.asarray(jrandom.next_key()),
                          prng.key_numpy(trandom.next_key()))
