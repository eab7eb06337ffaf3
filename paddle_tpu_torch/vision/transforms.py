"""paddle.vision.transforms: port of ``paddle_tpu/vision/transforms.py``.

Host-side image preprocessing in numpy, as in the reference: images are
HWC (or HW) arrays as from the cv2 backend, CHW after ``ToTensor``. The
random transforms draw from numpy's global state in the reference's
order, so one ``np.random.seed`` gives the same crops, flips and jitters
in both packages. ``to_tensor``, ``normalize`` of a tensor and ``erase``
of a tensor make paddle ``Tensor``s on the CPU: they run inside forked
``DataLoader`` workers, which never touch the card
(``io/dataloader.py``); ``hapi.Model`` moves each batch to the card.

``resize`` is ``jax.image.resize`` as the reference calls it, in numpy:
``scale_and_translate``'s weight matrix (half-pixel centres; the kernel
widened by ``in / out`` when shrinking, which antialiases; Keys' cubic at
a = -0.5; columns normalised; samples outside the input zeroed) applied
one axis at a time in float32, and nearest as ``floor((i + 0.5) * in /
out)``. ``torch.nn.functional.interpolate`` would differ on both counts
(its bicubic takes a = -0.75, its antialias treats the edges its own
way).
"""
import numbers

import numpy as np
import torch

from ..core.tensor import Tensor, to_tensor as _to_tensor

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "ContrastTransform", "Pad",
           "RandomResizedCrop", "to_tensor", "normalize", "resize",
           "hflip", "vflip", "center_crop", "crop", "pad"]


def _chw(img):
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[None]
    elif a.ndim == 3 and a.shape[-1] in (1, 3, 4):
        a = a.transpose(2, 0, 1)
    return a


def _cpu_tensor(a):
    return _to_tensor(np.ascontiguousarray(a), place="cpu")


def _host(img):
    """A tensor's value as a numpy array; anything else as an array."""
    if isinstance(img, Tensor):
        return img.numpy()
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_tensor(img, data_format="CHW"):
    """float32, divided by 255 when its largest value exceeds 1.5; CHW
    unless ``data_format`` says HWC; a CPU ``Tensor``."""
    a = np.asarray(img).astype(np.float32)
    if a.max() > 1.5:
        a = a / 255.0
    if data_format == "CHW":
        a = _chw(a)
    return _cpu_tensor(a)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = isinstance(img, (Tensor, torch.Tensor))
    a = _host(img) if is_tensor else np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    out = (a - mean) / std
    return _cpu_tensor(out) if is_tensor else out


# ------------------------------------------------------------- resize


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


def _weight_mat(in_size, out_size, kernel):
    """``jax.image``'s ``compute_weight_mat(in, out, out / in, 0)``:
    ``[in, out]`` float32."""
    inv = np.float32(1.0 / (out_size / in_size))
    kscale = np.maximum(inv, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * inv - np.float32(0.5)
    x = np.abs(sample[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None]) / kscale
    w = kernel(x).astype(np.float32)
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def _resize_array(a, out_shape, method):
    if method == "nearest":
        for d in range(a.ndim):
            m, n = a.shape[d], out_shape[d]
            if m == n:
                continue
            off = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                           * np.float32(m) / np.float32(n)).astype(np.int64)
            a = np.take(a, off, axis=d)
        return a
    kernel = _triangle if method == "linear" else _keys_cubic
    a = a.astype(np.float32)
    for d in range(a.ndim):
        m, n = a.shape[d], out_shape[d]
        if m == n:
            continue
        w = _weight_mat(m, n, kernel)
        a = np.moveaxis(np.tensordot(a, w, axes=([d], [0])), -1, d)
    return a.astype(np.float32)


def resize(img, size, interpolation="bilinear"):
    """Resize an HWC (or HW) image to ``size`` ((h, w), or the shorter
    side for an int) as ``jax.image.resize``: float32 out."""
    a = np.asarray(img)
    if isinstance(size, int):
        h, w = a.shape[0], a.shape[1]
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic"}[interpolation]
    out_shape = tuple(size) + a.shape[2:]
    return _resize_array(a.astype(np.float32), out_shape, method)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    a = np.asarray(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = a.shape[0], a.shape[1]
    th, tw = output_size
    return crop(a, (h - th) // 2, (w - tw) // 2, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    a = np.asarray(img)
    if isinstance(padding, int):
        padding = (padding,) * 4
    left, top, right, bottom = padding if len(padding) == 4 else \
        (padding[0], padding[1], padding[0], padding[1])
    width = [(top, bottom), (left, right)] + [(0, 0)] * (a.ndim - 2)
    if padding_mode == "constant":
        return np.pad(a, width, constant_values=fill)
    return np.pad(a, width, mode=padding_mode)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def _apply_image(self, img):
        a = np.asarray(img)
        if self.padding:
            a = pad(a, self.padding)
        h, w = a.shape[0], a.shape[1]
        th, tw = self.size
        top = np.random.randint(0, max(h - th, 0) + 1)
        left = np.random.randint(0, max(w - tw, 0) + 1)
        return crop(a, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        a = np.asarray(img)
        h, w = a.shape[0], a.shape[1]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                top = np.random.randint(0, h - ch + 1)
                left = np.random.randint(0, w - cw + 1)
                return resize(crop(a, top, left, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(a, min(h, w)), self.size,
                      self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return np.asarray(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return np.asarray(img).transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        a = np.asarray(img, np.float32)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return np.clip(a * factor, 0, 255 if a.max() > 1.5 else 1.0)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        a = np.asarray(img, np.float32)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        mean = a.mean()
        return np.clip((a - mean) * factor + mean,
                       0, 255 if a.max() > 1.5 else 1.0)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


# ------------------------------------------------- the functional tail


def _hwc(img):
    a = np.asarray(img)
    return a[:, :, None] if a.ndim == 2 else a


def _clip_like(a, ref):
    return np.clip(a, 0, 255.0 if np.asarray(ref).max() > 1.5 else 1.0)


def to_grayscale(img, num_output_channels=1):
    a = _hwc(img).astype(np.float32)
    gray = a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114 \
        if a.shape[-1] >= 3 else a[..., 0]
    out = np.repeat(gray[..., None], num_output_channels, -1)
    return out.astype(np.asarray(img).dtype)


def adjust_brightness(img, brightness_factor):
    a = _hwc(img).astype(np.float32)
    return _clip_like(a * brightness_factor, img).astype(np.float32)


def adjust_contrast(img, contrast_factor):
    a = _hwc(img).astype(np.float32)
    mean = to_grayscale(a).mean()
    return _clip_like((a - mean) * contrast_factor + mean,
                      img).astype(np.float32)


def adjust_saturation(img, saturation_factor):
    a = _hwc(img).astype(np.float32)
    gray = to_grayscale(a, 3).astype(np.float32)
    return _clip_like(gray + saturation_factor * (a - gray),
                      img).astype(np.float32)


def adjust_hue(img, hue_factor):
    """Shift the hue by ``hue_factor`` (in [-0.5, 0.5]) through a
    vectorised RGB <-> HSV round trip."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a = _hwc(img).astype(np.float32)
    scale = 255.0 if np.asarray(img).max() > 1.5 else 1.0
    rgb = a[..., :3] / scale
    mx, mn = rgb.max(-1), rgb.min(-1)
    d = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(mx == r, ((g - b) / d) % 6,
                 np.where(mx == g, (b - r) / d + 2, (r - g) / d + 4)) / 6.0
    s = np.where(mx > 0, d / (mx + 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6).astype(np.int32)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = i % 6
    out = np.choose(i[..., None],
                    [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
                     np.stack([p, v, t], -1), np.stack([p, q, v], -1),
                     np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return (out * scale).astype(np.float32)


def _warp(img, inv_matrix, fill=0.0):
    """Inverse-map bilinear warp: ``out(x) = img(M @ x)`` for a 3 x 3
    ``M``."""
    a = _hwc(img).astype(np.float32)
    h, w = a.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1)
    src = inv_matrix @ coords
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    x0, y0 = np.floor(sx), np.floor(sy)
    dx, dy = sx - x0, sy - y0

    def at(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = a[np.clip(iy, 0, h - 1).astype(int),
              np.clip(ix, 0, w - 1).astype(int)]
        return np.where(inb[:, None], v, fill)

    out = (at(x0, y0) * ((1 - dx) * (1 - dy))[:, None]
           + at(x0 + 1, y0) * (dx * (1 - dy))[:, None]
           + at(x0, y0 + 1) * ((1 - dx) * dy)[:, None]
           + at(x0 + 1, y0 + 1) * (dx * dy)[:, None])
    return out.reshape(h, w, a.shape[-1]).astype(np.float32)


def _affine_matrix(angle, translate, scale, shear, center):
    rot = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate
    # forward: T(center) R S Sh T(-center) + translate
    rs = np.array([
        [np.cos(rot + sy) / np.cos(sy),
         -np.cos(rot + sy) * np.tan(sx) / np.cos(sy) - np.sin(rot), 0],
        [np.sin(rot + sy) / np.cos(sy),
         -np.sin(rot + sy) * np.tan(sx) / np.cos(sy) + np.cos(rot), 0],
        [0, 0, 1]], np.float32) * scale
    rs[2, 2] = 1.0
    pre = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]], np.float32)
    post = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    return pre @ rs @ post


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    a = _hwc(img)
    h, w = a.shape[:2]
    if np.isscalar(shear):
        shear = (float(shear), 0.0)
    center = center or ((w - 1) * 0.5, (h - 1) * 0.5)
    m = _affine_matrix(angle, translate, scale, shear, center)
    return _warp(a, np.linalg.inv(m), fill)


def rotate(img, angle, interpolation="bilinear", expand=False, center=None,
           fill=0):
    return affine(img, angle=angle, center=center, fill=fill)


def _homography(src_pts, dst_pts):
    A = []
    for (x, y), (u, v) in zip(src_pts, dst_pts):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    b = np.array([c for p in dst_pts for c in p], np.float32)
    h8 = np.linalg.lstsq(np.array(A, np.float32), b, rcond=None)[0]
    return np.append(h8, 1.0).reshape(3, 3)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    m = _homography(startpoints, endpoints)   # maps start -> end
    return _warp(img, np.linalg.inv(m), fill)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase ``[i:i+h, j:j+w]`` with ``v``: a tensor is CHW (a CPU
    ``Tensor`` comes back), an array HWC or CHW by its last axis."""
    if isinstance(img, (Tensor, torch.Tensor)):
        a = _host(img).copy()
        a[..., i:i + h, j:j + w] = v
        return _cpu_tensor(a)
    a = np.asarray(img).copy()
    if a.ndim == 3 and a.shape[-1] in (1, 3, 4):   # HWC
        a[i:i + h, j:j + w] = v
    else:
        a[..., i:i + h, j:j + w] = v
    return a


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        f = np.random.uniform(-self.value, self.value)
        return adjust_hue(img, f)


class ColorJitter(BaseTransform):
    """Brightness, contrast, saturation and hue in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        for t in np.random.permutation(len(self.transforms)):
            img = self.transforms[int(t)]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="bilinear", expand=False,
                 center=None, fill=0, keys=None):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="bilinear", fill=0, center=None, keys=None):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = _hwc(img)
        h, w = a.shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0
        if self.translate:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        if self.shear is None:
            sh = 0.0
        elif np.isscalar(self.shear):
            sh = np.random.uniform(-self.shear, self.shear)
        else:
            sh = np.random.uniform(self.shear[0], self.shear[1])
        return affine(a, angle, (tx, ty), sc, (sh, 0.0), fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="bilinear", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = _hwc(img)
        h, w = a.shape[:2]
        d = self.distortion_scale
        dw, dh = int(d * w // 2), int(d * h // 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, dw + 1), np.random.randint(0, dh + 1)),
               (w - 1 - np.random.randint(0, dw + 1),
                np.random.randint(0, dh + 1)),
               (w - 1 - np.random.randint(0, dw + 1),
                h - 1 - np.random.randint(0, dh + 1)),
               (np.random.randint(0, dw + 1),
                h - 1 - np.random.randint(0, dh + 1))]
        return perspective(a, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    """Cutout-style erasing of an HWC or CHW array."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = _hwc(np.asarray(img))
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                return erase(a, i, j, eh, ew, self.value)
        return a


__all__ += ["SaturationTransform", "HueTransform", "ColorJitter",
            "Grayscale", "RandomRotation", "RandomAffine",
            "RandomPerspective", "RandomErasing", "to_grayscale",
            "adjust_brightness", "adjust_contrast", "adjust_saturation",
            "adjust_hue", "affine", "rotate", "perspective", "erase"]
