"""paddle.vision.datasets: port of ``paddle_tpu/vision/datasets.py``.

The datasets read local files, as the reference's do (it has no
downloader): MNIST and FashionMNIST from idx files (gzipped or not),
Cifar10 and Cifar100 from the python pickle, DatasetFolder and
ImageFolder through PIL (or ``.npy``), Flowers from a JPEG folder and
its ``.mat`` labels, VOC2012 from ``JPEGImages/`` and
``SegmentationClass/``. Without a file each falls back to ``FakeData``,
whose sample ``idx`` is drawn from ``np.random.RandomState(seed +
idx)``, so both packages give the same arrays. Samples are numpy arrays
(the transforms make tensors) and the datasets sit on the port's
``io.Dataset``.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataloader import Dataset

__all__ = ["FakeData", "MNIST", "Cifar10", "DatasetFolder", "ImageFolder"]


class FakeData(Dataset):
    def __init__(self, num_samples=1000, image_shape=(3, 32, 32),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = np.asarray(rng.randint(0, self.num_classes), np.int64)
        if self.transform:
            img = self.transform(img)
        return img, label


class MNIST(Dataset):
    """idx-format loader (reference MNIST minus the downloader)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.transform = transform
        if image_path and os.path.exists(image_path):
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        else:
            fake = FakeData(1000 if mode == "train" else 100,
                            (1, 28, 28), 10)
            self.images = np.stack([fake[i][0][0] for i in range(len(fake))])
            self.labels = np.stack([fake[i][1] for i in range(len(fake))])

    @staticmethod
    def _read_images(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols).astype(np.float32) / 255.0

    @staticmethod
    def _read_labels(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx][None]  # [1, 28, 28]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            import pickle
            with open(data_file, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            self.images = d[b"data"].reshape(-1, 3, 32, 32).astype(
                np.float32) / 255.0
            self.labels = np.asarray(d[b"labels"], np.int64)
        else:
            fake = FakeData(1000 if mode == "train" else 100, (3, 32, 32), 10)
            self.images = np.stack([fake[i][0] for i in range(len(fake))])
            self.labels = np.stack([fake[i][1] for i in range(len(fake))])

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=IMG_EXTENSIONS,
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError as e:
            raise RuntimeError("install PIL or use .npy images") from e

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, np.asarray(label, np.int64)


class ImageFolder(DatasetFolder):
    def __init__(self, root, loader=None, extensions=IMG_EXTENSIONS,
                 transform=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        self.samples = [os.path.join(root, f) for f in sorted(os.listdir(root))
                        if f.lower().endswith(extensions)]

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform:
            img = self.transform(img)
        return (img,)

    def __len__(self):
        return len(self.samples)


class FashionMNIST(MNIST):
    """Same idx format as MNIST (reference vision/datasets/mnist.py
    FashionMNIST subclass)."""


class Cifar100(Cifar10):
    """CIFAR-100 python pickle format (fine labels)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            import pickle
            with open(data_file, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            self.images = d[b"data"].reshape(-1, 3, 32, 32).astype(
                np.float32) / 255.0
            self.labels = np.asarray(d[b"fine_labels"], np.int64)
        else:
            fake = FakeData(1000 if mode == "train" else 100, (3, 32, 32),
                            100)
            self.images = np.stack([fake[i][0] for i in range(len(fake))])
            self.labels = np.stack([fake[i][1] for i in range(len(fake))])


class Flowers(Dataset):
    """Oxford-102 flowers layout (jpg folder + labels .mat or fake)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False, backend=None):
        self.transform = transform
        if data_file and os.path.isdir(data_file):
            files = sorted(f for f in os.listdir(data_file)
                           if f.lower().endswith((".jpg", ".jpeg")))
            self.samples = [os.path.join(data_file, f) for f in files]
            if label_file:
                from scipy.io import loadmat
                labels = loadmat(label_file)["labels"].reshape(-1) - 1
                if setid_file:
                    key = {"train": "trnid", "valid": "valid",
                           "test": "tstid"}[mode]
                    ids = loadmat(setid_file)[key].reshape(-1) - 1
                    self.samples = [self.samples[i] for i in ids]
                    labels = labels[ids]
                self.labels = labels.astype(np.int64)
            else:
                raise ValueError(
                    "Flowers with real data needs label_file "
                    "(imagelabels.mat); labels cannot be inferred from "
                    "filenames")
        else:
            fake = FakeData(200 if mode == "train" else 50, (3, 64, 64), 102)
            self.images = np.stack([fake[i][0] for i in range(len(fake))])
            self.labels = np.stack([fake[i][1] for i in range(len(fake))])
            self.samples = None

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        if self.samples is not None:
            from PIL import Image
            img = np.asarray(Image.open(self.samples[idx]).convert("RGB"),
                             np.float32).transpose(2, 0, 1) / 255.0
        else:
            img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]


class VOC2012(Dataset):
    """Pascal VOC 2012 segmentation layout (JPEGImages/ +
    SegmentationClass/); fake data without a data_file."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        self.pairs = []
        if data_file and os.path.isdir(data_file):
            jdir = os.path.join(data_file, "JPEGImages")
            sdir = os.path.join(data_file, "SegmentationClass")
            for f in sorted(os.listdir(sdir)) if os.path.isdir(sdir) else []:
                stem = os.path.splitext(f)[0]
                self.pairs.append((os.path.join(jdir, stem + ".jpg"),
                                   os.path.join(sdir, f)))
            if not self.pairs:
                raise ValueError(
                    f"no segmentation samples under {data_file!r} "
                    "(expected JPEGImages/ + SegmentationClass/)")
        else:
            fake = FakeData(50, (3, 64, 64), 21)
            self.images = np.stack([fake[i][0] for i in range(len(fake))])
            self.masks = np.stack(
                [np.zeros((64, 64), np.int64) for _ in range(len(fake))])

    def __len__(self):
        return len(self.pairs) if self.pairs else len(self.images)

    def __getitem__(self, idx):
        if self.pairs:
            from PIL import Image
            img = np.asarray(Image.open(self.pairs[idx][0]).convert("RGB"),
                             np.float32).transpose(2, 0, 1) / 255.0
            mask = np.asarray(Image.open(self.pairs[idx][1]), np.int64)
        else:
            img, mask = self.images[idx], self.masks[idx]
        if self.transform:
            img = self.transform(img)
        return img, mask


__all__ += ["FashionMNIST", "Cifar100", "Flowers", "VOC2012"]
