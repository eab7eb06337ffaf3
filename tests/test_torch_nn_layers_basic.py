"""Every layer class of ``nn.layers_basic`` in the port against the JAX
package's, on the CPU: one case per class (several for the convolutions,
pools, norms and resampling), the reference's weights carried across by
``set_state_dict`` over its ``state_dict()`` as numpy, the same inputs
made from a seed with numpy, then forward and backward (a random
cotangent): outputs, input gradients and parameter gradients within
``TOL`` (f32; convolutions and pools accumulate in another order:
``TOL_CONV``). The dropout layers draw the reference's masks under the
same seed. Also ``BatchNorm2D``'s running statistics after three
training steps and then in eval, and ``SpectralNorm``'s power iteration
over three calls.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice

TOL = 2e-5
TOL_CONV = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _rand(*shape, seed=0, lo=None):
    rng = np.random.default_rng(seed + sum(shape))
    if lo is not None:
        return rng.uniform(lo, 1.0, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _carry(jl, tl):
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    missing, unexpected = tl.set_state_dict(sd)
    assert missing == [] and unexpected == [], (missing, unexpected)


def _close(a, b, tol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def check(make, inputs, tol=TOL, train=False, seed=0, diff=None,
          steps=1):
    """Build ``make(m)`` in both packages, carry the weights, run forward
    and backward ``steps`` times under ``seed``; compare everything."""
    jl, tl = make(jt), make(pt)
    _carry(jl, tl)
    if not train:
        jl.eval()
        tl.eval()
    diff = diff if diff is not None else [
        np.issubdtype(x.dtype, np.floating) for x in inputs]
    for step in range(steps):
        jx = [jt.to_tensor(x, stop_gradient=not d)
              for x, d in zip(inputs, diff)]
        tx = [torch.tensor(x).requires_grad_(d)
              for x, d in zip(inputs, diff)]
        jt.seed(seed + step)
        pt.seed(seed + step)
        jo = jl(*jx)
        to = tl(*tx)
        _close(to.detach().numpy(), jo.numpy(), tol, "out")
        cot = _rand(*to.shape, seed=7) if to.dim() else np.float32(1.3)
        (jo * jt.to_tensor(cot)).sum().backward()
        (to * torch.tensor(cot)).sum().backward()
        for i, (j, t, d) in enumerate(zip(jx, tx, diff)):
            if d:
                _close(t.grad.numpy(), j.grad.numpy(), tol, f"dx{i}")
        jp = dict(jl.named_parameters())
        for name, p in tl.named_parameters():
            if jp[name].grad is None:
                assert p.grad is None or not p.grad.any(), name
                continue
            _close(p.grad.numpy(), jp[name].grad.numpy(), tol, "d" + name)
    return jl, tl


def _instance_norm(m, dims, c):
    """The reference's ``InstanceNorm*D`` passes its scale and shift to
    ``F.instance_norm`` as keywords, which its dispatch does not unwrap,
    so it fails on a Tensor that records a gradient; its functional form
    with them positional is the oracle for the port's layer."""
    layer = getattr(m.nn, "InstanceNorm" + dims)(c, epsilon=1e-4)
    if m is jt:
        layer.forward = lambda x: jt.nn.functional.instance_norm(
            x, None, None, layer.weight, layer.bias, True, 0.9, 1e-4)
    return layer



CASES = {
    "Identity": (lambda m: m.nn.Identity(), [_rand(3, 4)]),
    "Linear": (lambda m: m.nn.Linear(4, 3), [_rand(2, 5, 4)]),
    "Linear_no_bias": (lambda m: m.nn.Linear(4, 3, bias_attr=False),
                       [_rand(2, 4)]),
    "Embedding": (lambda m: m.nn.Embedding(10, 4, padding_idx=2),
                  [np.array([[1, 2, 3], [2, 9, 0]], np.int32)]),
    "Dropout": (lambda m: m.nn.Dropout(0.4), [_rand(4, 6)]),
    "Dropout_axis": (lambda m: m.nn.Dropout(0.4, axis=1), [_rand(4, 6)]),
    "Dropout_downscale": (lambda m: m.nn.Dropout(
        0.4, mode="downscale_in_infer"), [_rand(4, 6)]),
    "Dropout2D": (lambda m: m.nn.Dropout2D(0.5), [_rand(2, 3, 4, 4)]),
    "Dropout3D": (lambda m: m.nn.Dropout3D(0.5), [_rand(2, 3, 2, 3, 3)]),
    "AlphaDropout": (lambda m: m.nn.AlphaDropout(0.3), [_rand(5, 7)]),
    "Flatten": (lambda m: m.nn.Flatten(), [_rand(2, 3, 4)]),
    "Unflatten": (lambda m: m.nn.Unflatten(1, [2, 3]), [_rand(2, 6, 4)]),
    "Pad1D": (lambda m: m.nn.Pad1D([1, 2]), [_rand(2, 3, 4)]),
    "Pad2D": (lambda m: m.nn.Pad2D([1, 0, 2, 1], mode="reflect"),
              [_rand(1, 2, 4, 5)]),
    "Pad3D": (lambda m: m.nn.Pad3D([1, 1, 0, 1, 1, 0], value=0.5),
              [_rand(1, 1, 2, 3, 3)]),
    "CosineSimilarity": (lambda m: m.nn.CosineSimilarity(axis=1),
                         [_rand(3, 5), _rand(3, 5, seed=1)]),
    "Bilinear": (lambda m: m.nn.Bilinear(3, 4, 5),
                 [_rand(2, 3), _rand(2, 4)]),
    "Conv1D": (lambda m: m.nn.Conv1D(4, 6, 3, stride=2, padding=1,
                                     groups=2), [_rand(2, 4, 9)]),
    "Conv1D_NLC_same": (lambda m: m.nn.Conv1D(3, 4, 3, padding="SAME",
                                              data_format="NLC"),
                        [_rand(2, 7, 3)]),
    "Conv2D": (lambda m: m.nn.Conv2D(3, 4, 3, dilation=2, padding=[1, 2]),
               [_rand(2, 3, 8, 9)]),
    "Conv2D_pairs": (lambda m: m.nn.Conv2D(2, 2, (2, 3), stride=(2, 1),
                                           padding=[0, 1, 2, 0]),
                     [_rand(1, 2, 6, 7)]),
    "Conv2D_NHWC_same": (lambda m: m.nn.Conv2D(4, 4, 3, stride=2,
                                               padding="SAME", groups=4,
                                               data_format="NHWC"),
                         [_rand(2, 7, 6, 4)]),
    "Conv2D_valid": (lambda m: m.nn.Conv2D(2, 3, 3, padding="VALID"),
                     [_rand(1, 2, 5, 5)]),
    "Conv3D": (lambda m: m.nn.Conv3D(2, 3, 2, padding=1),
               [_rand(1, 2, 3, 4, 4)]),
    "Conv1DTranspose": (lambda m: m.nn.Conv1DTranspose(3, 4, 3, stride=2,
                                                       padding=1),
                        [_rand(2, 3, 5)]),
    "Conv2DTranspose": (lambda m: m.nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
        [_rand(2, 4, 4, 5)]),
    "Conv2DTranspose_dilated": (lambda m: m.nn.Conv2DTranspose(
        2, 3, (2, 3), stride=(1, 2), dilation=2), [_rand(1, 2, 3, 4)]),
    "Conv3DTranspose": (lambda m: m.nn.Conv3DTranspose(2, 2, 2, stride=2),
                        [_rand(1, 2, 2, 3, 2)]),
    "LayerNorm": (lambda m: m.nn.LayerNorm([3, 4]), [_rand(2, 3, 4)]),
    "RMSNorm": (lambda m: m.nn.RMSNorm(8), [_rand(2, 3, 8)]),
    "BatchNorm": (lambda m: m.nn.BatchNorm(3), [_rand(4, 3, 2, 2)]),
    "BatchNorm1D": (lambda m: m.nn.BatchNorm1D(3), [_rand(4, 3, 5)]),
    "BatchNorm2D_NHWC": (lambda m: m.nn.BatchNorm2D(3, data_format="NHWC"),
                         [_rand(2, 4, 4, 3)]),
    "BatchNorm3D": (lambda m: m.nn.BatchNorm3D(2), [_rand(2, 2, 2, 3, 3)]),
    "SyncBatchNorm": (lambda m: m.nn.SyncBatchNorm(3), [_rand(4, 3, 2, 2)]),
    "GroupNorm": (lambda m: m.nn.GroupNorm(2, 4), [_rand(2, 4, 3, 3)]),
    "InstanceNorm1D": (lambda m: _instance_norm(m, "1D", 3),
                       [_rand(2, 3, 6)]),
    "InstanceNorm2D": (lambda m: _instance_norm(m, "2D", 3),
                       [_rand(2, 3, 4, 4)]),
    "InstanceNorm3D": (lambda m: _instance_norm(m, "3D", 2),
                       [_rand(1, 2, 2, 3, 3)]),
    "LocalResponseNorm": (lambda m: m.nn.LocalResponseNorm(3),
                          [_rand(2, 5, 3, 3)]),
    "PReLU": (lambda m: m.nn.PReLU(3, init=0.1), [_rand(2, 3, 4)]),
    "PReLU_one": (lambda m: m.nn.PReLU(), [_rand(2, 3, 4)]),
    "Maxout": (lambda m: m.nn.Maxout(2), [_rand(2, 6, 3)]),
    "PixelShuffle": (lambda m: m.nn.PixelShuffle(2), [_rand(1, 8, 3, 3)]),
    "PixelShuffle_NHWC": (lambda m: m.nn.PixelShuffle(
        2, data_format="NHWC"), [_rand(1, 3, 3, 8)]),
}

ACTIVATIONS = {
    "ReLU": {}, "ReLU6": {}, "GELU": {}, "GELU_tanh": {"approximate": True},
    "SiLU": {}, "Swish": {}, "LeakyReLU": {"negative_slope": 0.2},
    "ELU": {"alpha": 0.5}, "CELU": {"alpha": 0.7}, "SELU": {}, "RReLU": {},
    "Sigmoid": None, "LogSigmoid": None, "Tanh": None, "Tanhshrink": {},
    "Hardshrink": {}, "Softshrink": {"threshold": 0.3}, "Hardsigmoid": {},
    "Hardswish": {}, "Hardtanh": {}, "Mish": {}, "Softmax": {"axis": 1},
    "LogSoftmax": {}, "Softplus": {"beta": 2.0}, "Softsign": {},
    "ThresholdedReLU": {"threshold": 0.2}, "GLU": {"axis": 1},
}
for _n, _kw in ACTIVATIONS.items():
    _cls = _n.split("_")[0]
    CASES[_n] = ((lambda c, kw: lambda m: getattr(m.nn, c)(**(kw or {})))(
        _cls, _kw), [_rand(3, 4, 5)])

POOLS = {
    "MaxPool1D": ((3,), {"stride": 2, "padding": 1}, (2, 3, 9)),
    "MaxPool2D": ((2,), {}, (2, 3, 6, 6)),
    "MaxPool2D_same": ((3,), {"stride": 2, "padding": "SAME"},
                       (1, 2, 7, 6)),
    "MaxPool3D": ((2,), {"stride": 1, "padding": 1}, (1, 2, 3, 3, 3)),
    "AvgPool1D": ((3,), {"stride": 2, "padding": 1}, (2, 3, 9)),
    "AvgPool1D_inclusive": ((3,), {"stride": 2, "padding": 1,
                                   "exclusive": False}, (2, 3, 9)),
    "AvgPool2D": ((3,), {"stride": 2, "padding": 1}, (2, 2, 7, 7)),
    "AvgPool2D_ceil": ((3,), {"stride": 2, "ceil_mode": True},
                       (2, 2, 7, 8)),
    "AvgPool2D_NHWC": ((2,), {"data_format": "NHWC"}, (2, 6, 4, 3)),
    "AvgPool3D": ((2,), {"padding": 1, "exclusive": False},
                  (1, 2, 3, 4, 3)),
    "AdaptiveAvgPool1D": ((4,), {}, (2, 3, 10)),
    "AdaptiveAvgPool2D": (((3, 2),), {}, (2, 3, 7, 6)),
    "AdaptiveAvgPool2D_NHWC": ((2,), {"data_format": "NHWC"},
                               (1, 5, 4, 3)),
    "AdaptiveAvgPool3D": ((2,), {}, (1, 2, 5, 4, 3)),
    "AdaptiveMaxPool1D": ((3,), {}, (2, 3, 10)),
    "AdaptiveMaxPool2D": (((3, 4),), {}, (2, 3, 7, 8)),
}
for _n, (_a, _kw, _shape) in POOLS.items():
    CASES[_n] = ((lambda c, a, kw: lambda m: getattr(m.nn, c)(*a, **kw))(
        _n.split("_")[0], _a, _kw), [_rand(*_shape)])

RESAMPLE = {
    "Upsample_nearest_up": ({"scale_factor": 2}, (1, 2, 3, 4)),
    "Upsample_nearest_down": ({"size": [2, 3]}, (1, 2, 5, 7)),
    "Upsample_bilinear_up": ({"size": [7, 5], "mode": "bilinear"},
                             (1, 2, 3, 4)),
    "Upsample_bilinear_down": ({"size": [3, 2], "mode": "bilinear"},
                               (1, 2, 7, 5)),
    "Upsample_bicubic_up": ({"scale_factor": 2, "mode": "bicubic"},
                            (1, 1, 4, 3)),
    "Upsample_bicubic_down": ({"size": [3, 3], "mode": "bicubic"},
                              (1, 1, 8, 7)),
    "Upsample_linear": ({"size": [9], "mode": "linear",
                         "data_format": "NCL"}, (2, 3, 4)),
    "Upsample_trilinear": ({"size": [3, 5, 2], "mode": "trilinear",
                            "data_format": "NCDHW"}, (1, 2, 2, 3, 4)),
    "Upsample_NHWC": ({"size": [5, 6], "mode": "bilinear",
                       "data_format": "NHWC"}, (1, 3, 4, 2)),
    "UpsamplingBilinear2D": ({"scale_factor": 2}, (1, 2, 3, 3)),
    "UpsamplingNearest2D": ({"scale_factor": 3}, (1, 2, 2, 3)),
}
for _n, (_kw, _shape) in RESAMPLE.items():
    CASES[_n] = ((lambda c, kw: lambda m: getattr(m.nn, c)(**kw))(
        _n.split("_")[0], _kw), [_rand(*_shape)])

_LBL = np.array([1, 0, 3, 2, 1], np.int32)
_PM = np.array([1, -1, 1, 1, -1], np.float32)
LOSSES = {
    "CrossEntropyLoss": (lambda m: m.nn.CrossEntropyLoss(),
                         [_rand(5, 4), _LBL], [True, False]),
    "MSELoss": (lambda m: m.nn.MSELoss(), [_rand(3, 4), _rand(3, 4, seed=1)],
                None),
    "L1Loss": (lambda m: m.nn.L1Loss(reduction="sum"),
               [_rand(3, 4), _rand(3, 4, seed=1)], None),
    "NLLLoss": (lambda m: m.nn.NLLLoss(ignore_index=3),
                [_rand(5, 4), _LBL], [True, False]),
    "BCELoss": (lambda m: m.nn.BCELoss(),
                [_rand(3, 4, lo=0.05), _rand(3, 4, seed=2, lo=0.0)], None),
    "BCEWithLogitsLoss": (lambda m: m.nn.BCEWithLogitsLoss(),
                          [_rand(3, 4), _rand(3, 4, seed=2, lo=0.0)], None),
    "KLDivLoss": (lambda m: m.nn.KLDivLoss(),
                  [_rand(3, 4), _rand(3, 4, seed=2, lo=0.01)], None),
    "SmoothL1Loss": (lambda m: m.nn.SmoothL1Loss(delta=0.5),
                     [_rand(3, 4), _rand(3, 4, seed=1)], None),
    "MarginRankingLoss": (lambda m: m.nn.MarginRankingLoss(margin=0.1),
                          [_rand(5), _rand(5, seed=1), _PM],
                          [True, True, False]),
    "CosineEmbeddingLoss": (lambda m: m.nn.CosineEmbeddingLoss(margin=0.2),
                            [_rand(5, 3), _rand(5, 3, seed=1), _PM],
                            [True, True, False]),
    "TripletMarginLoss": (lambda m: m.nn.TripletMarginLoss(swap=True),
                          [_rand(4, 3), _rand(4, 3, seed=1),
                           _rand(4, 3, seed=2)], None),
    "HingeEmbeddingLoss": (lambda m: m.nn.HingeEmbeddingLoss(),
                           [_rand(5), _PM], [True, False]),
}

TRAIN = {"Dropout", "Dropout_axis", "Dropout2D", "Dropout3D", "AlphaDropout",
         "BatchNorm", "BatchNorm1D", "BatchNorm2D_NHWC", "BatchNorm3D",
         "SyncBatchNorm"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_the_reference(name):
    make, inputs = CASES[name]
    conv = any(k in name for k in ("Conv", "Pool", "Upsample", "Upsampling"))
    check(make, inputs, tol=TOL_CONV if conv else TOL, train=name in TRAIN)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_the_reference(name):
    make, inputs, diff = LOSSES[name]
    check(make, inputs, diff=diff)


def test_every_class_has_a_case():
    names = {n.split("_")[0] for n in list(CASES) + list(LOSSES)}
    missing = set(pt.nn.layers_basic.__all__) - names - {"SpectralNorm"}
    assert not missing, sorted(missing)


def test_batch_norm_running_stats_after_three_steps_then_eval():
    make = lambda m: m.nn.BatchNorm2D(3, momentum=0.8)  # noqa: E731
    xs = [_rand(4, 3, 2, 2, seed=s) for s in range(3)]
    jl, tl = make(jt), make(pt)
    for x in xs:
        jl(jt.to_tensor(x))
        tl(torch.tensor(x))
    for k in ("_mean", "_variance"):
        _close(tl.state_dict()[k].numpy(),
               np.asarray(jl.state_dict()[k].numpy()), 1e-6, k)
    jl.eval()
    tl.eval()
    x = _rand(2, 3, 2, 2, seed=9)
    _close(tl(torch.tensor(x)).detach().numpy(),
           jl(jt.to_tensor(x)).numpy(), TOL, "eval")


def test_embedding_padding_row_and_sparse():
    pt.seed(1)
    jt.seed(1)
    j = jt.nn.Embedding(6, 3, padding_idx=4, sparse=True)
    t = pt.nn.Embedding(6, 3, padding_idx=4, sparse=True)
    assert not t.weight[4].any()
    np.testing.assert_allclose(t.weight.numpy(), j.weight.numpy(),
                               rtol=4e-7, atol=0)


def test_spectral_norm_over_three_calls():
    make = lambda m: m.nn.SpectralNorm([4, 3, 2], dim=1,  # noqa: E731
                                       power_iters=2)
    jl, tl = make(jt), make(pt)
    w = _rand(4, 3, 2)
    for _ in range(3):
        jw = jt.to_tensor(w, stop_gradient=False)
        tw = torch.tensor(w).requires_grad_()
        jo, to = jl(jw), tl(tw)
        _close(to.detach().numpy(), jo.numpy(), TOL, "out")
        (jo * 2).sum().backward()
        (to * 2).sum().backward()
        _close(tw.grad.numpy(), jw.grad.numpy(), TOL, "dw")
    for k in ("weight_u", "weight_v"):
        _close(tl.state_dict()[k].numpy(),
               np.asarray(jl.state_dict()[k].numpy()), TOL, k)


def test_conv_weights_under_one_seed_are_the_references():
    jt.seed(12)
    pt.seed(12)
    j = jt.nn.Conv2D(3, 4, 3, groups=1)
    t = pt.nn.Conv2D(3, 4, 3, groups=1)
    assert np.array_equal(t.weight.numpy(), np.asarray(j.weight.numpy()))
    assert list(t.state_dict()) == list(j.state_dict())


# -- nn.utils: the reparameterisations and the parameter vectors


def _utils_pair(make):
    jl, tl = make(jt), make(pt)
    _carry(jl, tl)
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1, None], ids=str)
def test_weight_norm_and_its_removal(dim):
    jl, tl = _utils_pair(lambda m: m.nn.Linear(4, 3))
    jt.nn.utils.weight_norm(jl, dim=dim)
    pt.nn.utils.weight_norm(tl, dim=dim)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    x = _rand(2, 4)
    for _ in range(2):
        jx, tx = jt.to_tensor(x), torch.tensor(x)
        jo, to = jl(jx), tl(tx)
        _close(to.detach().numpy(), jo.numpy(), TOL, "out")
        jo.sum().backward()
        to.sum().backward()
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        _close(p.grad.numpy(), jp[n].grad.numpy(), TOL, n)
    jt.nn.utils.remove_weight_norm(jl)
    pt.nn.utils.remove_weight_norm(tl)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]
    _close(tl.weight.numpy(), np.asarray(jl.weight.numpy()), TOL, "folded")


def test_spectral_norm_on_a_layer():
    jl, tl = _utils_pair(lambda m: m.nn.Conv2D(2, 3, 3))
    jt.nn.utils.spectral_norm(jl, n_power_iterations=2)
    pt.nn.utils.spectral_norm(tl, n_power_iterations=2)
    x = _rand(1, 2, 5, 5)
    for _ in range(2):
        jo, to = jl(jt.to_tensor(x)), tl(torch.tensor(x))
        _close(to.detach().numpy(), jo.numpy(), TOL_CONV, "out")
        jo.sum().backward()
        to.sum().backward()
    _close(tl.weight_orig.grad.numpy(), jl.weight_orig.grad.numpy(),
           TOL_CONV, "dweight_orig")


def test_parameter_vectors_and_clip_grad_norm():
    jl, tl = _utils_pair(lambda m: m.nn.Sequential(m.nn.Linear(3, 4),
                                                   m.nn.Linear(4, 2)))
    jv = jt.nn.utils.parameters_to_vector(jl.parameters())
    tv = pt.nn.utils.parameters_to_vector(tl.parameters())
    assert type(tv) is torch.Tensor
    _close(tv.detach().numpy(), jv.numpy(), 0, "vector")
    new = np.arange(tv.numel(), dtype=np.float32) / 10
    jt.nn.utils.vector_to_parameters(jt.to_tensor(new), jl.parameters())
    pt.nn.utils.vector_to_parameters(torch.tensor(new), tl.parameters())
    for (n, a), (_, b) in zip(tl.named_parameters(), jl.named_parameters()):
        _close(a.numpy(), np.asarray(b.numpy()), 0, n)
    x = _rand(5, 3)
    jl(jt.to_tensor(x)).sum().backward()
    tl(torch.tensor(x)).sum().backward()
    for norm in (2.0, float("inf")):
        jt_total = jt.nn.utils.clip_grad_norm_(jl.parameters(), 0.5,
                                               norm_type=norm)
        pt_total = pt.nn.utils.clip_grad_norm_(tl.parameters(), 0.5,
                                               norm_type=norm)
        _close(pt_total.numpy(), jt_total.numpy(), TOL, "total")
        for (n, a), (_, b) in zip(tl.named_parameters(),
                                  jl.named_parameters()):
            _close(a.grad.numpy(), b.grad.numpy(), TOL, n)
    tp = [pt.Parameter(np.ones(3, np.float32))]
    assert isinstance(pt.nn.utils.parameters_to_vector(tp), pt.Tensor)
