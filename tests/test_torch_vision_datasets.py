"""The port's ``vision.datasets`` against the JAX package's, on the CPU.

Each test writes its own files under ``tmp_path`` (the datasets read
local files; nothing is downloaded): MNIST / FashionMNIST idx files, gzipped
and not, Cifar10 / Cifar100 python pickles, class folders of JPEG, PNG
and ``.npy`` images for ``DatasetFolder`` and ``ImageFolder``, a Flowers
JPEG folder with its ``.mat`` labels and set ids, a VOC2012 layout. Both
packages read the same files: every sample (image, label, mask) equal;
without a file each falls back to ``FakeData``, equal too. Then the
port's ``io.DataLoader`` with two workers over a ``DatasetFolder`` and
``ToTensor`` / ``Normalize``: batched CPU tensors equal to the samples
stacked by hand. Last, the slice's surface: the public names of
``vision`` and its four modules, ``fft``, ``signal`` and ``linalg`` are
the reference's, and the entry points raise without a device.
"""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.vision import datasets as JD
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import transforms as TT


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = tdevice._default[0]
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place


def host(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def same_items(tds, jds, n=None):
    assert len(tds) == len(jds)
    for i in range(len(jds) if n is None else n):
        t, j = tds[i], jds[i]
        assert len(t) == len(j)
        for a, b in zip(t, j):
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def write_idx(path, arr, gz):
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        if arr.ndim == 3:
            f.write(struct.pack(">IIII", 2051, *arr.shape))
        else:
            f.write(struct.pack(">II", 2049, arr.shape[0]))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("gz", [True, False])
def test_mnist_idx_files(tmp_path, cls, gz):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (9, 28, 28))
    labels = rng.integers(0, 10, 9)
    sfx = ".gz" if gz else ""
    ip, lp = str(tmp_path / f"img{sfx}"), str(tmp_path / f"lab{sfx}")
    write_idx(ip, imgs, gz)
    write_idx(lp, labels, gz)
    tds = getattr(TD, cls)(ip, lp)
    jds = getattr(JD, cls)(ip, lp)
    same_items(tds, jds)
    assert tds[3][0].shape == (1, 28, 28)


@pytest.mark.parametrize("cls,key,classes", [("Cifar10", b"labels", 10),
                                             ("Cifar100", b"fine_labels",
                                              100)])
def test_cifar_pickles(tmp_path, cls, key, classes):
    rng = np.random.default_rng(1)
    d = {b"data": rng.integers(0, 256, (7, 3072)).astype(np.uint8),
         key: rng.integers(0, classes, 7).tolist()}
    path = str(tmp_path / "batch")
    with open(path, "wb") as f:
        pickle.dump(d, f)
    same_items(getattr(TD, cls)(path), getattr(JD, cls)(path))


@pytest.mark.parametrize("cls,args", [
    ("MNIST", ()), ("Cifar10", ()), ("Cifar100", ()), ("Flowers", ()),
    ("VOC2012", ()), ("MNIST", (None, None, "test"))])
def test_fallbacks_are_the_references_fake_data(cls, args):
    same_items(getattr(TD, cls)(*args), getattr(JD, cls)(*args), n=5)


def test_fake_data_with_a_transform():
    t = TD.FakeData(8, (3, 6, 5), 4, transform=TT.Normalize(0.5, 0.5),
                    seed=3)
    j = JD.FakeData(8, (3, 6, 5), 4, transform=JT.Normalize(0.5, 0.5),
                    seed=3)
    same_items(t, j)


def write_images(root, rng, classes=("cat", "dog", "owl"), n=3):
    from PIL import Image
    for ci, c in enumerate(classes):
        os.makedirs(os.path.join(root, c))
        for k in range(n):
            arr = rng.integers(0, 256, (12 + k, 10 + ci, 3)).astype(np.uint8)
            base = os.path.join(root, c, f"{k:02d}")
            if k == 0:
                Image.fromarray(arr).save(base + ".png")
            elif k == 1:
                np.save(base + ".npy", arr.astype(np.float32) / 255.0)
            else:
                Image.fromarray(arr).save(base + ".jpg", quality=90)
        open(os.path.join(root, c, "notes.txt"), "w").close()


def test_dataset_folder_and_image_folder(tmp_path):
    rng = np.random.default_rng(2)
    root = str(tmp_path / "train")
    write_images(root, rng)
    tds, jds = TD.DatasetFolder(root), JD.DatasetFolder(root)
    assert tds.class_to_idx == jds.class_to_idx
    assert tds.samples == jds.samples
    same_items(tds, jds)
    flat = str(tmp_path / "train" / "dog")
    same_items(TD.ImageFolder(flat), JD.ImageFolder(flat))


def test_flowers_from_a_jpeg_folder_and_mat_labels(tmp_path):
    from PIL import Image
    from scipy.io import savemat
    rng = np.random.default_rng(4)
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    for k in range(6):
        Image.fromarray(rng.integers(0, 256, (9, 11, 3)).astype(
            np.uint8)).save(str(jpg / f"image_{k:05d}.jpg"))
    savemat(str(tmp_path / "labels.mat"),
            {"labels": rng.integers(1, 103, (1, 6))})
    savemat(str(tmp_path / "setid.mat"),
            {"trnid": np.array([[1, 3, 5]]), "valid": np.array([[2]]),
             "tstid": np.array([[4, 6]])})
    for mode in ("train", "valid", "test"):
        args = (str(jpg), str(tmp_path / "labels.mat"),
                str(tmp_path / "setid.mat"), mode)
        same_items(TD.Flowers(*args), JD.Flowers(*args))
    with pytest.raises(ValueError):
        TD.Flowers(str(jpg))


def test_voc2012_layout(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(5)
    (tmp_path / "JPEGImages").mkdir()
    (tmp_path / "SegmentationClass").mkdir()
    for k in range(3):
        Image.fromarray(rng.integers(0, 256, (8, 10, 3)).astype(
            np.uint8)).save(str(tmp_path / "JPEGImages" / f"{k}.jpg"))
        Image.fromarray(rng.integers(0, 21, (8, 10)).astype(
            np.uint8)).save(str(tmp_path / "SegmentationClass" / f"{k}.png"))
    same_items(TD.VOC2012(str(tmp_path)), JD.VOC2012(str(tmp_path)))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError):
        TD.VOC2012(str(empty))


def test_dataloader_workers_batch_tensors_from_transforms(tmp_path):
    rng = np.random.default_rng(6)
    root = str(tmp_path / "train")
    write_images(root, rng, n=4)
    tf = TT.Compose([TT.Resize((8, 8)), TT.ToTensor(),
                     TT.Normalize([0.5] * 3, [0.25] * 3)])
    ds = TD.DatasetFolder(root, transform=tf,
                          extensions=(".jpg", ".png"))
    loader = DataLoader(ds, batch_size=3, shuffle=False, num_workers=2)
    batches = list(loader)
    imgs = torch.cat([b[0] for b in batches])
    labels = np.concatenate([np.asarray(b[1]) for b in batches])
    assert isinstance(batches[0][0], torch.Tensor)
    assert imgs.device.type == "cpu" and tuple(imgs.shape[1:]) == (3, 8, 8)
    want = np.stack([ds[i][0].numpy() for i in range(len(ds))])
    np.testing.assert_array_equal(imgs.numpy(), want)
    np.testing.assert_array_equal(labels,
                                  [ds[i][1] for i in range(len(ds))])


SURFACE = ["vision", "vision.transforms", "vision.models", "vision.ops",
           "vision.datasets", "fft", "signal", "linalg"]


@pytest.mark.parametrize("sub", SURFACE)
def test_public_names_are_the_references(sub):
    """Each module's ``__all__`` (the ``vision`` package's public names)
    is the reference's, each name the same kind of object, reached from
    ``paddle_tpu_torch`` by attribute as from ``paddle_tpu``."""
    import importlib
    import inspect

    import paddle_tpu as jt

    def public(mod):
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in dir(mod) if not n.startswith("_")]
        return set(names)

    ref = importlib.import_module(f"paddle_tpu.{sub}")
    port = importlib.import_module(f"paddle_tpu_torch.{sub}")
    assert public(port) == public(ref), sorted(public(port) ^ public(ref))
    for n in public(ref):
        a, b = getattr(ref, n), getattr(port, n)
        assert inspect.isclass(a) == inspect.isclass(b), n
        assert inspect.ismodule(a) == inspect.ismodule(b), n
    head, *rest = sub.split(".")
    mod = getattr(pt, head)
    for part in rest:
        mod = getattr(mod, part)
    assert mod is port
    assert getattr(jt, head) is importlib.import_module(f"paddle_tpu.{head}")


def test_entry_points_raise_without_a_device(monkeypatch, tmp_path):
    """Without ``set_device("cpu")`` the default place is the card: the
    models, the host ops' results and the frequencies raise rather than
    fall back to the CPU, and a CPU tensor in keeps its device."""
    from paddle_tpu_torch import fft as tfft
    from paddle_tpu_torch.vision import models as TM
    from paddle_tpu_torch.vision import ops as TV
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "b.bin"
    path.write_bytes(b"\x01\x02")
    boxes = np.array([[0, 0, 4, 4], [1, 1, 5, 5]], np.float32)
    place = tdevice._default[0]
    tdevice._default[0] = None
    try:
        for make in (lambda: TM.resnet18(num_classes=2),
                     lambda: TM.mobilenet_v2(scale=0.25),
                     lambda: TV.read_file(str(path)),
                     lambda: TV.nms(boxes, 0.5),
                     lambda: tfft.fftfreq(8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        keep = TV.nms(torch.tensor(boxes), 0.5)
        assert keep.device.type == "cpu"
    finally:
        tdevice._default[0] = place


def test_model_fit_trains_a_vision_layer_over_a_folder(tmp_path):
    """``hapi.Model`` over an ``nn.Layer`` network: its ``parameters()``
    is a list (the reference's API), which ``Model._device`` once took
    for an iterator. Two AdamW steps over a ``DatasetFolder`` through a
    two-worker loader, as the card's data path runs them."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision import models as TM

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    write_images(str(tmp_path), np.random.default_rng(7), n=4)
    tf = TT.Compose([TT.RandomResizedCrop(32), TT.RandomHorizontalFlip(),
                     TT.ToTensor(), TT.Normalize([0.5] * 3, [0.25] * 3)])
    ds = TD.DatasetFolder(str(tmp_path), transform=tf,
                          extensions=(".jpg", ".png"))
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True,
                        num_workers=2)
    pt.seed(0)
    net = TM.mobilenet_v2(scale=0.25, num_classes=3)
    before = [p.detach().clone() for p in net.parameters()]
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=net.parameters()),
        loss=pt.nn.CrossEntropyLoss())
    rec = Losses()
    model.fit(loader, epochs=1, verbose=0, callbacks=[rec])
    assert len(rec.losses) == 2 and np.isfinite(rec.losses).all()
    assert any(not torch.equal(a, p) for a, p in
               zip(before, net.parameters()))
