"""The port's paddle API surface against the JAX package's.

- The top level, ``Tensor``'s methods, ``nn``, ``static`` and ``jit``
  are the reference's (``dir(paddle_tpu)``, ``dir(paddle_tpu.Tensor)``,
  ``dir(paddle_tpu.nn)``, ...: the names that are not modules) less
  ``NOT_YET`` (``NOT_YET_METHODS``, ``NN_NOT_YET``), a set in which every
  name says the ROADMAP Queue 1 item that brings it; the set only
  shrinks (a name ported in a later slice leaves it, and the test fails
  while it is still listed). ``PORT_ONLY`` lists the port's own
  additions, ``REF_IMPORT_LEAKS`` names the reference has by an import.
  Each package's own submodules, every one imported first, are the
  reference's up to two named lists; so neither comparison depends on
  which modules other tests imported in the same process. The
  quantization and incubate modules (``SLICE_IMPORT_LEAKS``) are the
  reference's less its import leaks, and none of their names is a stub
  but incubate's aliases over ``geometric`` (``INCUBATE_NOT_YET``), which
  raise naming item 15.7.
- The default place is the card: ``to_tensor`` without a card and
  without ``set_device("cpu")`` raises; it never falls back.
- A ``Tensor`` passed to ``nn.functional`` and to the port's
  ``nn.Linear`` comes back as a ``Tensor`` with gradients reaching the
  module's parameters; ``rms_norm`` and ``flash_attention`` (K5, K4) on
  Tensors match the JAX package's, values and gradients.
- The slice as a whole: ``chip_smoke.api_block`` (the card phase
  ``tensor_api``'s block) at small widths, the port's paddle API against
  the JAX package's, loss and gradients, and bitwise against
  ``chip_smoke.direct_block`` (the same block in torch over the kernel
  wrappers).
"""
import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

NOT_YET = {
    "DataParallel": "item 13 (multi-card training)",
}
# nn's names not ported yet (none: layers_tail came with item 15.3)
NN_NOT_YET = {}
# names the port's nn adds: its Layer's hook handle, ParamAttr (the
# reference has it at the top level only), set_state_dict for any torch
# module, and the clip's tree form
NN_PORT_ONLY = {"HookRemoveHelper", "ParamAttr", "set_state_dict",
                "clip_by_global_norm_tree"}
# the reference adds these methods when paddle_tpu.sparse is imported (by
# another test in the same process)
NOT_YET_METHODS = {"to_sparse_coo": "item 15.7 (sparse)",
                   "to_sparse_csr": "item 15.7 (sparse)"}
# names the port adds: its device resolution and the NaN/Inf switch at the
# top level (the reference reaches it through runtime.set_flags)
PORT_ONLY = {"resolve_device", "set_nan_inf_check"}
# static's and jit's names the reference has only by an import of its own
# modules' (neither is API): the ``from __future__ import annotations``
# feature object and static's JAX dtype converter
REF_IMPORT_LEAKS = {
    "static": {"annotations", "to_jax_dtype"},
    "jit": {"annotations", "Tensor", "param_substitution"},
}
# each package's own submodules (every one imported first) that the other
# lacks: the port's copy of the reference's utils.unique_name, which
# static imports
SUBMODULES_NOT_YET = {"nn": {}, "static": {}, "jit": {}, "incubate": {},
                      "quantization": {}}
SUBMODULES_PORT_ONLY = {"nn": set(), "static": {"unique_name"},
                        "jit": set(), "incubate": set(),
                        "quantization": set()}
# the quantization and incubate slice (item 15.6a): each module's names
# are the reference's less its import leaks (``from __future__ import
# annotations`` and the reference's own Tensor helpers)
SLICE_IMPORT_LEAKS = {
    "quantization": set(), "nn.quant": set(), "incubate": set(),
    "incubate.nn": set(),
    "incubate.nn.functional": {"annotations", "Tensor", "dispatch",
                               "unwrap"},
    "incubate.autograd": set(),
    "incubate.optimizer": {"annotations", "unwrap"},
    "incubate.checkpoint": {"annotations"},
    "regularizer": {"annotations"}, "callbacks": set(),
    "ops.fused_ce": {"annotations"},
}
# incubate's aliases over paddle.geometric: in both, the port's raising
INCUBATE_NOT_YET = {
    name: "item 15.7 (geometric)"
    for name in ("segment_max", "segment_mean", "segment_min",
                 "segment_sum", "graph_send_recv", "graph_reindex",
                 "graph_sample_neighbors", "graph_khop_sampler")}
# the port's subpackages among the reference's top-level modules
SUBPACKAGES = ("amp", "autograd", "core", "jit", "nn", "ops", "optimizer",
               "hapi", "io", "metric", "reliability", "parallel", "models",
               "incubate", "static", "inference", "quantization",
               "telemetry", "device", "regularizer", "callbacks")


def _public(mod_or_cls, modules):
    out = set()
    for n in dir(mod_or_cls):
        if n.startswith("_"):
            continue
        if modules is not None and isinstance(getattr(mod_or_cls, n, None),
                                              types.ModuleType):
            modules.add(n)
            continue
        out.add(n)
    return out


@pytest.fixture
def on_cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def _own_submodules(pkg):
    """The names of ``pkg``'s own submodules, every one imported first
    (so the set does not depend on what other tests imported)."""
    for info in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{info.name}")
    return {n for n in dir(pkg) if not n.startswith("_")
            and isinstance(getattr(pkg, n), types.ModuleType)
            and getattr(pkg, n).__name__.startswith(pkg.__name__ + ".")}


def _pair(sub):
    return (importlib.import_module(f"paddle_tpu.{sub}"),
            importlib.import_module(f"paddle_tpu_torch.{sub}"))


def test_every_not_yet_name_names_its_item():
    for table in (NOT_YET, NOT_YET_METHODS, NN_NOT_YET, INCUBATE_NOT_YET,
                  *SUBMODULES_NOT_YET.values()):
        for name, item in table.items():
            assert item.startswith("item 1"), (name, item)


def test_top_level_is_the_references_less_the_named_set():
    mods = set()
    ref = _public(jt, mods)
    port = _public(pt, mods)
    assert ref - port == set(NOT_YET), sorted((ref - port) ^ set(NOT_YET))
    assert port - ref == PORT_ONLY, sorted(port - ref)


def test_nn_is_the_references_less_the_named_set():
    """``dir(paddle_tpu.nn)``'s names that are not modules, less
    ``NN_NOT_YET``, are the port's ``nn``'s less its own additions (the
    submodules: ``test_own_submodules_are_the_named_lists``)."""
    jnn, tnn = _pair("nn")
    ref = _public(jnn, set())
    port = _public(tnn, set())
    assert ref - port == set(NN_NOT_YET), sorted((ref - port)
                                                 ^ set(NN_NOT_YET))
    assert port - ref == NN_PORT_ONLY, sorted(port - ref)


@pytest.mark.parametrize("sub", ["static", "jit"])
def test_static_and_jit_are_the_references(sub):
    """``dir(paddle_tpu.static)`` and ``dir(paddle_tpu.jit)``'s names that
    are not modules are the port's, but the reference's import leaks."""
    ref_mod, port_mod = _pair(sub)
    ref = _public(ref_mod, set())
    port = _public(port_mod, set())
    assert ref - port == REF_IMPORT_LEAKS[sub], sorted(ref - port)
    assert port <= ref, sorted(port - ref)


@pytest.mark.parametrize("sub", ["nn", "static", "jit", "incubate",
                                 "quantization"])
def test_own_submodules_are_the_named_lists(sub):
    ref_mod, port_mod = _pair(sub)
    ref, port = _own_submodules(ref_mod), _own_submodules(port_mod)
    assert ref - port == set(SUBMODULES_NOT_YET[sub]), sorted(ref - port)
    assert port - ref == SUBMODULES_PORT_ONLY[sub], sorted(port - ref)


@pytest.mark.parametrize("sub", sorted(SLICE_IMPORT_LEAKS))
def test_quantization_and_incubate_are_the_references(sub):
    """Every name of the reference's ``quantization``, ``nn.quant``,
    ``incubate`` (and its ``nn``, ``nn.functional``, ``autograd``,
    ``optimizer``, ``checkpoint``), ``regularizer``, ``callbacks`` and
    ``ops.fused_ce`` is the port's, less the reference's import leaks;
    the port adds none."""
    ref_mod, port_mod = _pair(sub)
    ref = _public(ref_mod, set())
    port = _public(port_mod, set())
    assert ref - port == SLICE_IMPORT_LEAKS[sub], sorted(ref - port)
    assert port <= ref, sorted(port - ref)


@pytest.mark.parametrize("name", sorted(INCUBATE_NOT_YET))
def test_incubate_geometric_aliases_raise_naming_their_item(name):
    fn = getattr(importlib.import_module("paddle_tpu_torch.incubate"), name)
    with pytest.raises(NotImplementedError, match="item 15.7"):
        fn(None, None, None)


def test_slice_names_do_not_raise_not_implemented():
    """No name of the slice is a stub: constructing the fused layers,
    the quantizers and the observers raises nothing (the geometric
    aliases excepted, above)."""
    from paddle_tpu_torch import incubate, quantization
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.nn import quant
    place = tdevice._default[0]
    pt.set_device("cpu")
    try:
        made = [inn.FusedMultiHeadAttention(8, 2), inn.FusedFeedForward(8, 16),
                inn.FusedTransformerEncoderLayer(8, 2, 16),
                inn.FusedMultiTransformer(8, 2, 16), inn.FusedLinear(8, 8),
                inn.FusedBiasDropoutResidualLayerNorm(8),
                inn.FusedEcMoe(8, 16, 2), quant.Stub()]
        lin = pt.nn.Linear(4, 4)
        for name in ("AbsmaxObserver", "EMAObserver", "AVGObserver",
                     "HistObserver", "KLObserver", "MSEObserver",
                     "FakeQuanterWithAbsMaxObserver",
                     "FakeQuanterChannelWiseAbsMax"):
            made.append(getattr(quantization, name)()._instance(lin))
        assert all(isinstance(m, pt.nn.Layer) for m in made)
        assert incubate.LookAhead(pt.optimizer.SGD(
            parameters=lin.parameters())).k == 5
    finally:
        tdevice._default[0] = place


def test_enable_static_switches_in_dynamic_mode():
    assert pt.in_dynamic_mode()
    pt.enable_static()
    try:
        assert not pt.in_dynamic_mode()
    finally:
        pt.disable_static()
    assert pt.in_dynamic_mode()
    pt.disable_static()             # off already: nothing happens
    assert pt.in_dynamic_mode()


def test_tensor_methods_are_the_references_less_the_named_set():
    ref = _public(jt.Tensor, None)
    port = _public(pt.Tensor, None)
    assert ref - port == set(NOT_YET_METHODS) & ref, sorted(ref - port)
    assert not set(NOT_YET_METHODS) & port
    assert port <= ref, sorted(port - ref)


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackages_resolve(name):
    assert isinstance(getattr(pt, name), types.ModuleType)


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError):
        pt.no_such_op


def test_default_place_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    place = tdevice._default[0]
    tdevice._default[0] = None
    try:
        for make in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]),
                     lambda: pt.arange(3), lambda: pt.to_tensor(
                         np.ones(2), place="gpu")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        assert not pt.is_compiled_with_cuda()
        assert pt.to_tensor([1.0], place="cpu").value.device.type == "cpu"
        assert pt.to_tensor([1.0], place=pt.CPUPlace()).value.device.type \
            == "cpu"
        pt.set_device("cpu")
        assert pt.get_device() == "cpu"
        assert pt.to_tensor([1.0]).value.device.type == "cpu"
    finally:
        tdevice._default[0] = place


def test_an_op_keeps_its_inputs_device(on_cpu):
    x = pt.to_tensor(torch.ones(3, dtype=torch.float64))
    assert x.dtype == pt.float32                   # canonical
    assert (x + 1.0).value.device.type == "cpu"
    assert pt.zeros_like(x).value.device.type == "cpu"


def test_functional_and_linear_return_the_kind_they_were_given(on_cpu):
    from paddle_tpu_torch import nn
    lin = nn.Linear(4, 3, device="cpu")
    x = pt.to_tensor(np.ones((2, 4), np.float32), stop_gradient=False)
    y = lin(x)
    assert isinstance(y, pt.Tensor) and not y.stop_gradient
    out = nn.functional.relu(y).sum()
    assert isinstance(out, pt.Tensor)
    out.backward()
    assert lin.weight.grad is not None and lin.bias.grad is not None
    assert x.grad is not None
    t = torch.ones(2, 4)
    assert type(lin(t)) is torch.Tensor
    assert type(nn.functional.relu(t)) is torch.Tensor
    assert type(pt.relu(t)) is torch.Tensor


def test_functional_ops_are_flat_names():
    from paddle_tpu_torch.nn import functional as F
    for name in ("relu", "softmax", "log_softmax", "linear", "l1_loss",
                 "kl_div", "label_smooth", "cosine_similarity"):
        assert getattr(pt, name) is getattr(F, name)


def _kernel_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((2, 16, 32)).astype(np.float32),
            "w": rng.uniform(0.5, 1.5, 32).astype(np.float32),
            "q": rng.standard_normal((2, 16, 4, 8)).astype(np.float32),
            "k": rng.standard_normal((2, 16, 4, 8)).astype(np.float32),
            "v": rng.standard_normal((2, 16, 4, 8)).astype(np.float32)}


def _kernel_script(m, a):
    F = m.nn.functional
    ts = {k: m.to_tensor(v, stop_gradient=False) for k, v in a.items()}
    r = F.rms_norm(ts["x"], ts["w"])
    o = F.flash_attention(ts["q"], ts["k"], ts["v"], causal=True)
    if isinstance(o, tuple):
        o = o[0]
    (r.sum() * 0.5 + (o * o).sum()).backward()
    return [r, o] + [ts[k].grad for k in ("x", "w", "q", "k", "v")]


def test_rms_norm_and_flash_attention_on_tensors_match_jax(on_cpu):
    a = _kernel_inputs()
    got = _kernel_script(pt, a)
    want = _kernel_script(jt, a)
    assert all(isinstance(g, pt.Tensor) for g in got)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   atol=2e-5, rtol=2e-5, err_msg=str(i))


def _block_inputs(m, wn, xn, **kw):
    return ({k: m.to_tensor(v, stop_gradient=False, **kw)
             for k, v in wn.items()}, m.to_tensor(xn, **kw))


def test_the_blocks_api_path_matches_jax_and_the_direct_block(on_cpu):
    heads = 4
    wn = chip_smoke.block_weights(np, 32, 48, seed=0)
    xn = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32)
    pw, px = _block_inputs(pt, wn, xn)
    jw, jx = _block_inputs(jt, wn, xn)
    lp = chip_smoke.api_block(pt, pw, px, heads)
    lj = chip_smoke.api_block(jt, jw, jx, heads)
    lp.backward()
    lj.backward()
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj.numpy()),
                               atol=1e-6, rtol=1e-5)
    for k in wn:
        np.testing.assert_allclose(pw[k].grad.numpy(),
                                   np.asarray(jw[k].grad.numpy()),
                                   atol=1e-6, rtol=2e-4, err_msg=k)
    tw = {k: torch.tensor(v).requires_grad_() for k, v in wn.items()}
    ld = chip_smoke.direct_block(torch, tw, torch.tensor(xn), heads)
    ld.backward()
    assert torch.equal(lp.value, ld.detach())
    for k in wn:
        assert torch.equal(pw[k].grad.value, tw[k].grad), k
