"""The port's ``fft``, ``signal`` and ``linalg`` (``paddle_tpu_torch/
fft.py``, ``signal.py``, ``linalg.py``) against the JAX package's, on the
CPU, from numpy inputs drawn from a seed.

The transforms are ``torch.fft``'s against ``jnp.fft``'s (both pocketfft
on the CPU): complex and real outputs within ``TOL`` of the output's
largest magnitude, the gradients of a seeded weighted sum of ``|out|``
through the tape within ``GRAD_TOL``; the frequencies exactly. ``linalg``
is the op table under the reference's names.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu import fft as jfft
from paddle_tpu import linalg as jlinalg
from paddle_tpu import signal as jsignal
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import fft as tfft
from paddle_tpu_torch import linalg as tlinalg
from paddle_tpu_torch import signal as tsignal

TOL = 2e-6
GRAD_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def close(got, want, tol=TOL):
    g, w = np.asarray(got.numpy()), np.asarray(want.numpy())
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    scale = max(1.0, float(np.abs(w).max(initial=0.0)))
    err = float(np.abs(g.astype(np.complex128) - w).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def both(jfn, tfn, arrays, kwargs, grad=True):
    """``jfn`` and ``tfn`` on the same arrays; with ``grad`` the inputs'
    gradients of ``sum(w * |out|)`` too."""
    jx = [jt.to_tensor(a, stop_gradient=not grad) for a in arrays]
    tx = [pt.to_tensor(a, stop_gradient=not grad) for a in arrays]
    jo, to = jfn(*jx, **kwargs), tfn(*tx, **kwargs)
    close(to, jo)
    if grad:
        w = np.random.default_rng(9).uniform(0.5, 1.5, tuple(jo.shape))
        w = w.astype(np.float32)
        (jt.abs(jo) * jt.to_tensor(w)).sum().backward()
        (pt.abs(to) * pt.to_tensor(w)).sum().backward()
        for a, b in zip(tx, jx):
            close(a.grad, b.grad, GRAD_TOL)


def real(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def cplx(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ------------------------------------------------------------------ fft


@pytest.mark.parametrize("name", ["fft", "ifft", "rfft", "irfft", "hfft",
                                  "ihfft"])
@pytest.mark.parametrize("n,axis,norm", [(None, -1, "backward"),
                                         (12, 0, "ortho"),
                                         (7, -1, "forward")])
def test_1d_transforms(name, n, axis, norm):
    complex_in = name in ("fft", "ifft", "irfft", "hfft")
    x = cplx(6, 10, seed=1) if complex_in else real(6, 10, seed=1)
    both(getattr(jfft, name), getattr(tfft, name), [x],
         dict(n=n, axis=axis, norm=norm), grad=not complex_in)


@pytest.mark.parametrize("name", ["fftn", "ifftn", "rfftn", "irfftn",
                                  "fft2", "ifft2", "rfft2", "irfft2"])
@pytest.mark.parametrize("norm", ["backward", "ortho"])
def test_nd_transforms(name, norm):
    complex_in = name.startswith(("ifft", "irfft", "fft"))
    x = cplx(3, 6, 8, seed=2) if complex_in else real(3, 6, 8, seed=2)
    kw = dict(norm=norm)
    if name.endswith("n"):
        kw.update(s=(5, 8), axes=(0, 2))
    else:
        kw.update(s=(6, 10))
    both(getattr(jfft, name), getattr(tfft, name), [x], kw,
         grad=not complex_in)
    both(getattr(jfft, name), getattr(tfft, name), [x], dict(norm=norm),
         grad=False)


@pytest.mark.parametrize("name", ["hfftn", "ihfftn", "hfft2", "ihfft2"])
@pytest.mark.parametrize("norm", ["backward", "forward", "ortho"])
def test_hermitian_nd(name, norm):
    x = cplx(4, 6, 5, seed=3) if name.startswith("h") else \
        real(4, 6, 5, seed=3)
    both(getattr(jfft, name), getattr(tfft, name), [x], dict(norm=norm),
         grad=False)
    kw = dict(s=(4, 8), axes=(0, 1)) if name.endswith("n") else \
        dict(s=(6, 8))
    both(getattr(jfft, name), getattr(tfft, name), [x], dict(norm=norm, **kw),
         grad=not name.startswith("h"))


def test_integer_input_is_float32():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    both(jfft.fft, tfft.fft, [x], {}, grad=False)
    both(jfft.rfftn, tfft.rfftn, [x], {}, grad=False)


@pytest.mark.parametrize("n,d,dtype", [(8, 1.0, "float32"), (9, 0.1,
                                                              "float32"),
                                       (10, 0.5, "float64")])
def test_frequencies_exact(n, d, dtype):
    for name in ("fftfreq", "rfftfreq"):
        got = getattr(tfft, name)(n, d, dtype=dtype)
        want = getattr(jfft, name)(n, d, dtype=dtype)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert got.numpy().dtype == want.numpy().dtype


@pytest.mark.parametrize("axes", [None, (0,), (1, 2)])
def test_shifts(axes):
    x = real(3, 4, 5, seed=4)
    for name in ("fftshift", "ifftshift"):
        both(getattr(jfft, name), getattr(tfft, name), [x],
             dict(axes=axes))


def test_invalid_norm_raises():
    with pytest.raises(ValueError):
        tfft.fft(pt.to_tensor(real(4)), norm="bogus")
    with pytest.raises(ValueError):
        tfft.hfftn(pt.to_tensor(cplx(4)), norm="bogus")


def test_torch_tensors_in_give_torch_tensors_out():
    x = real(2, 8, seed=5)
    got = tfft.rfft(torch.tensor(x))
    assert type(got) is torch.Tensor
    np.testing.assert_allclose(got.numpy(), np.fft.rfft(x), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------- signal


@pytest.mark.parametrize("shape,axis", [((20,), -1), ((20,), 0),
                                        ((3, 20), -1), ((20, 3), 0),
                                        ((2, 3, 20), -1), ((20, 2, 3), 0)])
@pytest.mark.parametrize("frame_length,hop", [(5, 3), (8, 8), (4, 1)])
def test_frame_and_overlap_add(shape, axis, frame_length, hop):
    x = real(*shape, seed=6)
    both(jsignal.frame, tsignal.frame, [x],
         dict(frame_length=frame_length, hop_length=hop, axis=axis))
    frames = jsignal.frame(jt.to_tensor(x), frame_length, hop,
                           axis=axis).numpy()
    both(jsignal.overlap_add, tsignal.overlap_add, [frames],
         dict(hop_length=hop, axis=axis))


def test_frame_refuses_bad_arguments():
    x = pt.to_tensor(real(10))
    with pytest.raises(ValueError):
        tsignal.frame(x, 11, 2)
    with pytest.raises(ValueError):
        tsignal.frame(x, 4, 0)


STFT = [
    dict(n_fft=16),
    dict(n_fft=16, hop_length=5, center=False),
    dict(n_fft=16, hop_length=4, win_length=10, pad_mode="constant"),
    dict(n_fft=12, hop_length=3, pad_mode="edge", normalized=True),
    dict(n_fft=8, hop_length=2, pad_mode="symmetric", onesided=False),
    dict(n_fft=16, window="hann"),
]


def _kw(kw, pkg):
    kw = dict(kw)
    if kw.get("window") == "hann":
        w = np.hanning(kw["n_fft"] + 1)[:-1].astype(np.float32)
        kw["window"] = pkg.to_tensor(w)
    return kw


@pytest.mark.parametrize("kw", STFT, ids=[str(i) for i in range(len(STFT))])
@pytest.mark.parametrize("batched", [False, True])
def test_stft_values_and_grads(kw, batched):
    x = real(2, 70, seed=7) if batched else real(70, seed=7)
    jx = jt.to_tensor(x, stop_gradient=False)
    tx = pt.to_tensor(x, stop_gradient=False)
    jo = jsignal.stft(jx, **_kw(kw, jt))
    to = tsignal.stft(tx, **_kw(kw, pt))
    close(to, jo)
    w = np.random.default_rng(8).uniform(0.5, 1.5, tuple(jo.shape))
    w = w.astype(np.float32)
    (jt.abs(jo) * jt.to_tensor(w)).sum().backward()
    (pt.abs(to) * pt.to_tensor(w)).sum().backward()
    close(tx.grad, jx.grad, GRAD_TOL)


@pytest.mark.parametrize("kw", [dict(n_fft=16), dict(n_fft=16, hop_length=4,
                                                     win_length=12),
                                dict(n_fft=12, hop_length=3,
                                     normalized=True),
                                dict(n_fft=16, window="hann", center=False)])
@pytest.mark.parametrize("length", [None, 60])
def test_istft_values(kw, length):
    x = real(2, 70, seed=10)
    spec = jsignal.stft(jt.to_tensor(x), **_kw(kw, jt)).numpy()
    jo = jsignal.istft(jt.to_tensor(spec), length=length, **_kw(kw, jt))
    to = tsignal.istft(pt.to_tensor(spec), length=length, **_kw(kw, pt))
    close(to, jo)


def test_istft_of_stft_is_the_signal():
    x = real(3, 64, seed=11)
    spec = tsignal.stft(pt.to_tensor(x), 16, 4)
    back = tsignal.istft(spec, 16, 4, length=64)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- linalg


def test_linalg_names_are_the_op_table():
    from paddle_tpu_torch.ops.registry import OPS
    assert tlinalg.__all__ == jlinalg.__all__
    for name in tlinalg.__all__:
        assert getattr(tlinalg, name) is OPS[
            "inverse" if name == "inv" else name]


@pytest.mark.parametrize("name,args", [
    ("inv", ()), ("det", ()), ("slogdet", ()), ("matrix_power", (3,)),
    ("norm", ()), ("pinv", ()), ("matrix_rank", ()), ("cond", ()),
    ("eigvalsh", ())])
def test_linalg_values(name, args):
    a = real(4, 4, seed=12) + 4 * np.eye(4, dtype=np.float32)
    if name == "eigvalsh":
        a = a + a.T
    want = getattr(jlinalg, name)(jt.to_tensor(a), *args)
    got = getattr(tlinalg, name)(pt.to_tensor(a), *args)
    for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                    want if isinstance(want, (list, tuple)) else [want]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)
