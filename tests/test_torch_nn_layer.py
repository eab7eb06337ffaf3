"""The port's ``nn.Layer`` and its containers
(``paddle_tpu_torch/nn/layer.py``) against the JAX package's, on the
CPU: structured names through nested ``Sequential`` / ``LayerList`` /
``LayerDict``, each shared parameter once; hooks and their removal;
``train`` / ``eval``; buffers (``persistable=False`` out of the state
dict); ``astype``; ``set_state_dict``'s missing and unexpected names; a
``Tensor`` in and a ``Tensor`` out, gradients reaching the parameters;
and where a ``Layer`` is a ``torch.nn.Module`` (pinned in ROADMAP Queue
3).
"""
import collections
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def _net(m):
    nn = m.nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)
            self.norm = nn.LayerNorm(4)
            self.register_buffer("steps", m.to_tensor(np.zeros(2,
                                                               np.float32)))
            self.register_buffer("scratch", m.to_tensor(
                np.ones(2, np.float32)), persistable=False)

        def forward(self, x):
            return self.norm(self.fc(x))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            shared = nn.Linear(4, 4)
            self.stem = nn.Sequential(("proj", shared), ("act", nn.ReLU()))
            self.blocks = nn.LayerList([Block(), Block()])
            self.heads = nn.LayerDict({"a": nn.Linear(4, 4), "b": shared})
            self.bn = nn.BatchNorm1D(4)

        def forward(self, x):
            x = self.stem(x)
            for b in self.blocks:
                x = b(x)
            return self.bn(self.heads["a"](x) + self.heads["b"](x))

    return Net()


def test_structured_names_match_the_reference():
    jn, tn = _net(jt), _net(pt)
    assert [n for n, _ in tn.named_parameters()] == \
        [n for n, _ in jn.named_parameters()]
    assert list(tn.state_dict()) == list(jn.state_dict())
    assert "blocks.0.scratch" not in tn.state_dict()
    assert [n for n, _ in tn.named_sublayers()] == \
        [n for n, _ in jn.named_sublayers()]
    assert [n for n, _ in tn.named_buffers()] == \
        [n for n, _ in jn.named_buffers()]
    assert len(tn.parameters()) == len(jn.parameters())
    assert len(tn.sublayers(include_self=True)) == \
        len(jn.sublayers(include_self=True))
    assert len(tn.blocks) == 2 and tn.heads["a"].weight.shape[1] == 4
    assert isinstance(tn, torch.nn.Module)


def test_set_state_dict_carries_the_references_weights():
    jn, tn = _net(jt), _net(pt)
    sd = {k: np.asarray(v.numpy()) for k, v in jn.state_dict().items()}
    sd["extra"] = np.zeros(1, np.float32)
    del sd["bn._mean"]
    missing, unexpected = tn.set_state_dict(sd)
    assert missing == ["bn._mean"] and unexpected == ["extra"]
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    jn.set_state_dict({k: v for k, v in jn.state_dict().items()})
    tn.eval()
    jn.eval()
    tn.bn._mean.zero_()
    got = tn(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jn(jt.to_tensor(x)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        tn.set_state_dict({"stem.proj.weight": np.zeros((2, 2),
                                                          np.float32)})


def test_hooks_and_their_removal():
    calls = []
    for m in (jt, pt):
        lin = m.nn.Linear(3, 3)
        h1 = lin.register_forward_pre_hook(
            lambda layer, inp: calls.append(("pre", type(layer).__name__))
            or (inp[0] * 2,))
        h2 = lin.register_forward_post_hook(
            lambda layer, inp, out: out * 0 + 1)
        x = m.to_tensor(np.ones((1, 3), np.float32))
        assert np.all(lin(x).numpy() == 1)
        h1.remove()
        h2.remove()
        w = np.asarray(lin.weight.numpy())
        b = np.asarray(lin.bias.numpy())
        np.testing.assert_allclose(lin(x).numpy(), np.ones((1, 3)) @ w + b,
                                   rtol=1e-6)
    assert calls == [("pre", "Linear")] * 2


def test_train_eval_and_dropout():
    for m in (jt, pt):
        net = m.nn.Sequential(m.nn.Linear(4, 4), m.nn.Dropout(0.5))
        assert net.training and net[1].training
        net.eval()
        assert not net.training and not net[1].training
        x = m.to_tensor(np.ones((2, 4), np.float32))
        a, b = net(x).numpy(), net(x).numpy()
        assert np.array_equal(a, b)
        net.train()
        assert net[1].training


def test_astype_casts_the_floating_parameters_only():
    for m in (jt, pt):
        net = m.nn.Sequential(m.nn.Linear(2, 2), m.nn.BatchNorm1D(2))
        net.astype("bfloat16")
        assert all("bfloat16" in str(p.dtype) for p in net.parameters())
        assert "float32" in str(net[1]._mean.dtype)
    net = pt.nn.Linear(2, 2).bfloat16()
    assert net.weight.dtype == torch.bfloat16
    net.float()
    assert net.weight.dtype == torch.float32
    assert net.to(dtype="float16").weight.dtype == torch.float16


def test_a_tensor_in_gives_a_tensor_out_and_gradients():
    net = _net(pt)
    x = pt.to_tensor(np.ones((2, 4), np.float32), stop_gradient=False)
    y = net(x)
    assert isinstance(y, pt.Tensor) and not y.stop_gradient
    y.sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    assert x.grad is not None
    out = net(torch.ones(2, 4))
    assert type(out) is torch.Tensor


def test_parameter_api_on_a_layers_weight():
    lin = pt.nn.Linear(3, 2)
    w = lin.weight
    assert isinstance(w, torch.nn.Parameter) and not w.stop_gradient
    w.set_value(np.full((3, 2), 0.5, np.float32))
    assert np.all(w.numpy() == 0.5)
    w.stop_gradient = True
    assert not w.requires_grad and not w.trainable
    w.trainable = True
    assert not w.stop_gradient
    shared = pt.wrap(lin.weight) if hasattr(pt, "wrap") else \
        pt.core.tensor.wrap(lin.weight)
    assert shared.value is lin.weight
    c = copy.deepcopy(lin)
    c.weight.name = "copied"
    assert c.weight.optimize_attr == {"learning_rate": 1.0}
    assert c.full_name() == lin.full_name()


def test_assigning_a_paddle_parameter_shares_its_leaf():
    layer = pt.nn.Layer()
    p = pt.Parameter(np.ones(3, np.float32))
    layer.w = p
    assert [n for n, _ in layer.named_parameters()] == ["w"]
    assert p.value is layer.w
    (layer.w * 2).sum().backward()
    assert np.all(p.grad.numpy() == 2.0)


def test_parameter_list_layer_dict_and_layer_list_edits():
    for m in (jt, pt):
        pl = m.nn.ParameterList([m.create_parameter([2], "float32")
                                 for _ in range(2)])
        pl.append(m.create_parameter([3], "float32"))
        assert len(pl) == 3 and list(pl[2].shape) == [3]
        ll = m.nn.LayerList([m.nn.Linear(1, 1)])
        ll.insert(0, m.nn.Linear(2, 2))
        ll.extend([m.nn.Linear(3, 3)])
        assert [layer.weight.shape[0] for layer in ll] == [2, 1, 3]
        assert len(ll[0:2]) == 2 and ll[-1].weight.shape[0] == 3
        ld = m.nn.LayerDict()
        ld["x"] = m.nn.Linear(1, 1)
        ld.update({"y": m.nn.Linear(1, 2)})
        del ld["x"]
        assert list(ld.keys()) == ["y"]
    od = collections.OrderedDict([("a", pt.nn.ReLU()), ("b", pt.nn.Tanh())])
    seq = pt.nn.Sequential(od)
    assert [n for n, _ in seq.named_children()] == ["a", "b"]


def test_apply_visits_self_first_and_raw_params():
    for m in (jt, pt):
        order = []
        net = m.nn.Sequential(m.nn.Linear(1, 1), m.nn.ReLU())
        net.apply(lambda layer: order.append(type(layer).__name__))
        assert order[0] == "Sequential" and len(order) == 3
    net = pt.nn.Linear(2, 2)
    raw = net.raw_params()
    assert set(raw) == {"weight", "bias"}
    net.load_raw_params({"bias": torch.full((2,), 7.0)})
    assert torch.equal(net.bias.detach(), torch.full((2,), 7.0))


def test_a_layer_goes_through_an_optimizer_and_torch_export():
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                           pt.nn.Linear(8, 1))
    opt = pt.optimizer.AdamW(learning_rate=0.05,
                             parameters=net.parameters())
    x = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
    y = x.sum(-1, keepdim=True)
    first = None
    for _ in range(20):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        first = first if first is not None else float(loss)
    assert float(loss) < first
    ep = torch.export.export(net, (x,))
    assert torch.allclose(ep.module()(x), net(x))


def test_pinned_differences_from_the_reference():
    """Pinned (ROADMAP Queue 3): a layer's parameter is one torch leaf,
    so ``trainable`` and ``stop_gradient`` are one flag (the reference
    keeps two); ``Layer.to(device)`` moves the layer (the reference's
    ignores the device); ``state_dict`` holds torch tensors."""
    j, t = jt.nn.Linear(2, 2), pt.nn.Linear(2, 2)
    j.weight.stop_gradient = True
    t.weight.stop_gradient = True
    assert j.weight.trainable and not t.weight.trainable
    t.to("cpu")
    assert t.weight.device.type == "cpu"
    assert all(isinstance(v, torch.Tensor) for v in t.state_dict().values())


def test_building_a_model_draws_nothing_from_the_global_stream():
    """GPT, Mixtral and Llama draw their own weights from their ``seed``
    (their projections' and tables' ``reset_parameters`` are theirs): the
    global key is untouched and the weights do not depend on it, so the
    serving phases' models are the ones of the slices before ``nn``'s
    layers drew from the global stream."""
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         MixtralForCausalLM, gpt2_tiny,
                                         llama_tiny, mixtral_tiny)
    for cls, cfg in ((GPTForCausalLM, gpt2_tiny()),
                     (MixtralForCausalLM, mixtral_tiny()),
                     (LlamaForCausalLM, llama_tiny())):
        weights = []
        for s in (0, 1):
            pt.seed(s)
            before = pt.get_rng_state()
            m = cls(cfg, device="cpu")
            key, count = pt.get_rng_state()
            assert count == before[1] and torch.equal(key, before[0])
            weights.append(m.state_dict())
        for k, v in weights[0].items():
            assert torch.equal(v, weights[1][k]), (cls.__name__, k)
