"""The port's ``vision.transforms`` against the JAX package's, on the CPU:
every public name, each on seeded numpy images (HWC uint8 and float,
HW gray), the random ones under one ``np.random.seed`` in both packages.

Both are numpy but ``resize``, which the reference runs through
``jax.image.resize`` (XLA, jitted) and the port through its own numpy
copy of ``scale_and_translate``'s weights: its output is held within
``RESIZE_TOL`` of the image's range at shrink and grow factors in all
three modes (XLA may contract the sample positions' multiply-add into an
FMA and sums in its own order). Everything else is held equal within
``TOL`` (float32 round-off of the same numpy expression), and a random
transform must leave numpy's global state where the reference leaves it
(the same draws in the same order). ``to_tensor``, ``normalize`` and
``erase`` of a tensor give CPU tensors.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.vision import transforms as TT

TOL = 1e-6
RESIZE_TOL = 1e-5       # of the image's range (255 or 1)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def host(x):
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def same(got, want, tol=TOL):
    g, w = host(got), host(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    scale = max(1.0, float(np.abs(w.astype(np.float64)).max(initial=0.0)))
    err = float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max(
        initial=0.0))
    assert err <= tol * scale, (err, scale)


def image(seed=0, shape=(20, 24, 3), dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 1, shape).astype(dtype)


# ----------------------------------------------------------- functional


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(7, 9), (13, 24), (45, 31), (20, 60), 11,
                                  40])
def test_resize_shrinks_and_grows_as_jax_image(mode, size):
    img = image(1)
    want = JT.resize(img, size, mode)
    got = TT.resize(img, size, mode)
    same(got, want, RESIZE_TOL)
    gray = image(2, (17, 13), np.float32)
    same(TT.resize(gray, size, mode), JT.resize(gray, size, mode),
         RESIZE_TOL)


@pytest.mark.parametrize("img", [image(3), image(4, (9, 11, 3), np.float32),
                                 image(5, (8, 10))])
@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_to_tensor_makes_a_cpu_tensor(img, fmt):
    got = TT.to_tensor(img, fmt)
    assert isinstance(got, pt.Tensor) and got._value.device.type == "cpu"
    same(got, JT.to_tensor(img, fmt))


def test_normalize_arrays_and_tensors():
    img = image(6, (3, 8, 9), np.float32)
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]
    same(TT.normalize(img, mean, std), JT.normalize(img, mean, std))
    hwc = img.transpose(1, 2, 0).copy()
    same(TT.normalize(hwc, mean, std, "HWC"),
         JT.normalize(hwc, mean, std, "HWC"))
    got = TT.normalize(TT.to_tensor(img), mean, std)
    assert isinstance(got, pt.Tensor) and got._value.device.type == "cpu"
    same(got, JT.normalize(JT.to_tensor(img), mean, std))
    same(TT.normalize(torch.tensor(img), mean, std),
         JT.normalize(img, mean, std))


@pytest.mark.parametrize("name,args", [
    ("hflip", ()), ("vflip", ()), ("crop", (2, 3, 10, 12)),
    ("center_crop", (9,)), ("center_crop", ((8, 14),)),
    ("pad", (3,)), ("pad", ((1, 2),)), ("pad", ((1, 2, 3, 4), 7)),
    ("pad", ((2, 1, 0, 3), 0, "reflect")), ("pad", (2, 0, "edge")),
    ("to_grayscale", ()), ("to_grayscale", (3,)),
    ("adjust_brightness", (1.3,)), ("adjust_contrast", (0.6,)),
    ("adjust_saturation", (1.7,)), ("adjust_hue", (0.2,)),
    ("adjust_hue", (-0.45,)), ("affine", (15.0, (2, -1), 1.1, 5.0)),
    ("affine", (-30.0, (0, 0), 0.9, (4.0, 2.0), "bilinear", 9)),
    ("rotate", (33.0,)), ("rotate", (-70.0, "bilinear", False, (5, 6), 3)),
    ("perspective", ([(0, 0), (23, 0), (23, 19), (0, 19)],
                     [(2, 1), (20, 3), (22, 18), (1, 17)])),
    ("erase", (2, 3, 5, 6, 0)), ("erase", (1, 1, 4, 4, 7.5))])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_functional_transforms_match(name, args, kind):
    img = image(7) if kind == "uint8" else image(8, (20, 24, 3), np.float32)
    same(getattr(TT, name)(img, *args), getattr(JT, name)(img, *args))


def test_erase_of_a_tensor_and_of_chw():
    chw = image(9, (3, 10, 12), np.float32)
    got = TT.erase(TT.to_tensor(chw), 2, 3, 4, 5, 0.5)
    assert isinstance(got, pt.Tensor) and got._value.device.type == "cpu"
    same(got, JT.erase(JT.to_tensor(chw), 2, 3, 4, 5, 0.5))
    same(TT.erase(chw, 1, 2, 3, 4, 9.0), JT.erase(chw, 1, 2, 3, 4, 9.0))


def test_adjust_hue_refuses_out_of_range():
    with pytest.raises(ValueError):
        TT.adjust_hue(image(10), 0.7)


# -------------------------------------------------------------- classes


DETERMINISTIC = [
    ("ToTensor", (), {}), ("ToTensor", ("HWC",), {}),
    ("Resize", ((10, 14),), {}), ("Resize", (30, "bicubic"), {}),
    ("CenterCrop", (12,), {}), ("Transpose", (), {}),
    ("Transpose", ((1, 0, 2),), {}), ("Pad", ((1, 2, 3, 4), 5), {}),
    ("Pad", (2, 0, "symmetric"), {}), ("Grayscale", (3,), {}),
]


@pytest.mark.parametrize("name,args,kw", DETERMINISTIC,
                         ids=[f"{d[0]}{i}" for i, d in
                              enumerate(DETERMINISTIC)])
def test_deterministic_classes_match(name, args, kw):
    img = image(11)
    same(getattr(TT, name)(*args, **kw)(img),
         getattr(JT, name)(*args, **kw)(img),
         RESIZE_TOL if name == "Resize" else TOL)


def test_normalize_and_compose_pipeline():
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]

    def pipe(T):
        return T.Compose([T.Resize((16, 18)), T.CenterCrop(14),
                          T.ToTensor(), T.Normalize(mean, std)])

    got = pipe(TT)(image(12))
    assert isinstance(got, pt.Tensor)
    same(got, pipe(JT)(image(12)), RESIZE_TOL)
    # a scalar mean and std, on an array
    a = image(13, (3, 5, 6), np.float32)
    same(TT.Normalize(0.5, 0.25)(a), JT.Normalize(0.5, 0.25)(a))


RANDOM = [
    ("RandomCrop", (12,), {}), ("RandomCrop", ((10, 14), 3), {}),
    ("RandomHorizontalFlip", (), {}), ("RandomVerticalFlip", (0.7,), {}),
    ("RandomResizedCrop", (16,), {}),
    ("RandomResizedCrop", ((12, 20), (0.5, 0.9), (0.5, 2.0), "nearest"),
     {}),
    ("BrightnessTransform", (0.4,), {}), ("ContrastTransform", (0.5,), {}),
    ("SaturationTransform", (0.6,), {}), ("HueTransform", (0.3,), {}),
    ("ColorJitter", (0.4, 0.4, 0.4, 0.1), {}),
    ("ColorJitter", (0.2, 0, 0.3, 0), {}),
    ("RandomRotation", (25,), {}), ("RandomRotation", ((-10, 40),),
                                    {"fill": 4, "center": (3, 5)}),
    ("RandomAffine", (20,), {"translate": (0.1, 0.2), "scale": (0.8, 1.2),
                             "shear": 8}),
    ("RandomAffine", ((-5, 5),), {"shear": (2, 6)}),
    ("RandomPerspective", (), {"prob": 0.6, "distortion_scale": 0.4}),
    ("RandomErasing", (), {"prob": 0.7, "value": 3}),
    ("RandomErasing", (), {"prob": 1.0, "scale": (0.3, 0.6)}),
]


@pytest.mark.parametrize("name,args,kw", RANDOM,
                         ids=[f"{d[0]}{i}" for i, d in enumerate(RANDOM)])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_random_classes_draw_as_the_reference(name, args, kw, kind):
    """Six images through each, under one seed: equal outputs, and
    numpy's global state left where the reference leaves it."""
    imgs = [image(20 + i) if kind == "uint8"
            else image(20 + i, (20, 24, 3), np.float32) for i in range(6)]
    tol = RESIZE_TOL if name == "RandomResizedCrop" else TOL
    np.random.seed(5)
    want = [getattr(JT, name)(*args, **kw)(a) for a in imgs]
    after_ref = np.random.get_state()[1].copy()
    np.random.seed(5)
    got = [getattr(TT, name)(*args, **kw)(a) for a in imgs]
    np.testing.assert_array_equal(np.random.get_state()[1], after_ref)
    for g, w in zip(got, want):
        same(g, w, tol)


def test_every_public_name_is_tested():
    """The port's names are the reference's, and each is held to it
    above (``Compose`` and ``Normalize`` in the pipeline,
    ``resize``, ``to_tensor``, ``normalize`` and ``erase`` on their
    own)."""
    assert sorted(TT.__all__) == sorted(JT.__all__)
    functional = {"hflip", "vflip", "crop", "center_crop", "pad",
                  "to_grayscale", "adjust_brightness", "adjust_contrast",
                  "adjust_saturation", "adjust_hue", "affine", "rotate",
                  "perspective", "erase"}
    seen = functional | {d[0] for d in DETERMINISTIC + RANDOM} | {
        "Compose", "Normalize", "resize", "to_tensor", "normalize"}
    assert set(JT.__all__) == seen, sorted(set(JT.__all__) ^ seen)
