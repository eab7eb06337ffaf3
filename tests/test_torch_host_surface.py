"""The surface of the port's host-side slice against the JAX package's.

For ``reader``, ``device``, ``utils`` (and its ``enforce``,
``unique_name``, ``cpp_extension``), ``runtime``, ``profiler``,
``cost_model``, ``sysconfig`` and ``parallel.moe`` (and its ``gate``,
``layer``, ``grad_clip``): the names that are not modules are the
reference's, less ``REF_ONLY`` and plus ``PORT_ONLY``, each entry with
its reason. The top level reaches each lazily, as the reference's
``__getattr__`` does. ``static`` and ``utils`` share one name counter.

``device`` keeps the reference's names and maps them onto this card:
the pinned differences (``cuda.is_available``, ``is_compiled_with_cuda``
— the top level's own function —, ``get_cudnn_version``,
``get_all_device_type``, ``is_compiled_with_custom_device("tpu")``)
describe the card, not the reference's TPU build; on the CPU place the
streams and events keep the reference's barrier semantics and
``memory_stats`` is ``{}``; without a card and without the CPU place
they raise; on the card ``memory_stats`` has the reference's keys from
torch's allocator.
"""
import importlib
import types

import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

SLICE = ("reader", "device", "utils", "utils.enforce", "utils.unique_name",
         "utils.cpp_extension", "runtime", "profiler", "cost_model",
         "sysconfig", "parallel.moe", "parallel.moe.gate",
         "parallel.moe.layer", "parallel.moe.grad_clip")
# the reference's names the port lacks, by reason
REF_ONLY = {
    # ``from __future__ import annotations``'s feature object
    "device": {"annotations"},
    # the mesh helpers the reference imports for its expert-parallel
    # all_to_all and psum (item 13's four-card part)
    "parallel.moe.layer": {"P", "axis_or_none"},
    "parallel.moe.grad_clip": {"axis_or_none"},
}
# the port's own names: device resolution and the tensor API's places,
# which the port's entry points import from ``device``
PORT_ONLY = {
    "device": {"resolve_device", "default_device", "default_place",
               "place_to_device", "CPUPlace", "CUDAPlace",
               "CUDAPinnedPlace"},
}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("sub", SLICE)
def test_names_are_the_references_up_to_the_named_sets(sub):
    ref = _public(importlib.import_module(f"paddle_tpu.{sub}"))
    port = _public(importlib.import_module(f"paddle_tpu_torch.{sub}"))
    assert ref - port == REF_ONLY.get(sub, set()), sorted(ref - port)
    assert port - ref == PORT_ONLY.get(sub, set()), sorted(port - ref)


@pytest.mark.parametrize("name", ["reader", "utils", "runtime", "profiler",
                                  "cost_model", "sysconfig", "device"])
def test_top_level_reaches_each_module(name):
    mod = getattr(pt, name)
    assert isinstance(mod, types.ModuleType)
    assert mod.__name__ == f"paddle_tpu_torch.{name}"
    assert isinstance(getattr(jt, name), types.ModuleType)


def test_static_and_utils_share_one_counter():
    from paddle_tpu_torch.static import unique_name as sun
    from paddle_tpu_torch.utils import unique_name as uun
    with uun.guard():
        assert [uun.generate("v"), sun.generate("v"),
                uun.generate("v")] == ["v_0", "v_1", "v_2"]


# ----------------------------------------------- device: pinned differences

def test_device_describes_this_card(monkeypatch):
    d = pt.device
    assert d.is_compiled_with_cuda is pt.is_compiled_with_cuda
    for avail in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: avail)
        monkeypatch.setattr(torch.backends.cudnn, "version", lambda: 90100)
        assert d.cuda.is_available() is avail is d.is_compiled_with_cuda()
        assert d.get_all_device_type() == (["cpu", "gpu"] if avail
                                           else ["cpu"])
        assert d.get_cudnn_version() == (90100 if avail else None)
        assert d.is_compiled_with_custom_device("tpu") is False
    # the reference's TPU build answers the other way
    assert jt.device.is_compiled_with_custom_device("tpu") is True
    assert jt.device.is_compiled_with_cuda() is False
    assert jt.device.get_cudnn_version() is None


@pytest.fixture
def on_cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def test_cpu_place_keeps_the_barrier_semantics(on_cpu):
    d = pt.device
    s = d.Stream()
    e = s.record_event()
    assert e.query() and s.query() and e.elapsed_time(d.Event()) == 0.0
    s.wait_event(e)
    s.wait_stream(d.current_stream())
    with d.stream_guard(s):
        assert d.set_stream(s) is s
    d.synchronize()
    assert d.memory_stats() == {}
    assert d.cuda.memory_allocated() == 0 and d.cuda.synchronize() is None


def test_without_a_card_streams_events_and_stats_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    place = tdevice._default[0]
    tdevice._default[0] = None
    try:
        for make in (pt.device.Stream, pt.device.Event,
                     pt.device.current_stream, pt.device.synchronize,
                     pt.device.memory_stats):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    finally:
        tdevice._default[0] = place


def test_memory_stats_on_the_card_has_the_references_keys(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 9})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1, 80))
    assert pt.device.memory_stats("gpu:0") == {
        "bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 80}
    assert pt.device.cuda.max_memory_allocated("gpu:0") == 9
