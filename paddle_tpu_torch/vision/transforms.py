"""Vision transforms: counterpart of ``paddle_tpu/vision/transforms.py``,
numpy host-side preprocessing of CHW (or HWC) float arrays, class for
class. ``Resize`` reproduces ``jax.image.resize(..., method="bilinear")``
(which the JAX transform calls) in numpy: a triangle kernel at half-pixel
centres, widened by the scale when shrinking (antialiasing), as one
weight matrix a resized axis (``_resize_weights``)."""

from __future__ import annotations

import numpy as np

__all__ = ["Compose", "Normalize", "Resize", "ToTensor", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "Transpose", "Pad",
           "BaseTransform", "BrightnessTransform", "ContrastTransform",
           "SaturationTransform", "HueTransform", "ColorJitter",
           "Grayscale", "RandomVerticalFlip", "RandomRotation",
           "RandomResizedCrop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        return ((np.asarray(img, np.float32) - self.mean) / self.std)


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3) and self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.transpose(np.asarray(img), self.order)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` weights of ``jax.image.resize``'s linear
    kernel for one axis (its ``compute_weight_mat`` with scale ``out /
    in``, no translation, antialias on)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = ((np.arange(out_size, dtype=np.float32) + 0.5)
              * np.float32(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / np.float32(kernel_scale)
    w = np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize(arr: np.ndarray, target) -> np.ndarray:
    """Resize every axis whose size differs from ``target``'s."""
    out = arr
    for ax, (n_in, n_out) in enumerate(zip(arr.shape, target)):
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out)
        out = np.moveaxis(np.tensordot(out, w, axes=([ax], [0])), -1, ax)
    return out.astype(np.float32)


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3)
        target = ((arr.shape[0],) + self.size) if chw else (self.size + arr.shape[2:])
        return _resize(arr, target)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-2:]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[..., i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            pads = [(0, 0)] * (arr.ndim - 2) + [(p, p), (p, p)]
            arr = np.pad(arr, pads)
        h, w = arr.shape[-2:]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[..., i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[..., ::-1].copy()
        return np.asarray(img)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        arr = np.asarray(img)
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)
        pads = [(0, 0)] * (arr.ndim - 2) + [(p[1], p[3]), (p[0], p[2])]
        return np.pad(arr, pads, constant_values=self.fill)


class BaseTransform:
    """Base class with the reference's keys/params contract
    (reference: transforms.py BaseTransform) — subclasses implement
    `_apply_image`."""

    def __init__(self, keys=None):
        self.keys = keys

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, img):
        return self._apply_image(img)


def _hwc(arr):
    """Return (img_hwc float32, was_chw) for a CHW or HWC array."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        return arr.transpose(1, 2, 0), True
    return arr, False


def _restore(img, was_chw):
    return img.transpose(2, 0, 1) if was_chw else img


class BrightnessTransform(BaseTransform):
    """reference: transforms.py BrightnessTransform — scale by a random
    factor in [max(0, 1-value), 1+value]."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("brightness value should be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return np.asarray(img, np.float32)
        f = np.random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return np.asarray(img, np.float32) * f


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return np.asarray(img, np.float32)
        f = np.random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        arr = np.asarray(img, np.float32)
        mean = arr.mean()
        return (arr - mean) * f + mean


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("saturation value should be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return np.asarray(img, np.float32)
        f = np.random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        arr, chw = _hwc(img)
        gray = arr @ np.array([0.299, 0.587, 0.114], np.float32) \
            if arr.ndim == 3 and arr.shape[-1] == 3 else arr
        gray = gray[..., None] if gray.ndim == 2 else gray
        return _restore(arr * f + gray * (1 - f), chw)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return np.asarray(img, np.float32)
        arr, chw = _hwc(img)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return _restore(arr, chw)
        shift = np.random.uniform(-self.value, self.value)
        scale = 255.0 if arr.max() > 1.5 else 1.0
        x = arr / scale
        # RGB -> HSV hue rotation -> RGB (vectorized)
        mx = x.max(-1)
        mn = x.min(-1)
        diff = mx - mn + 1e-12
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        h = np.where(mx == r, (g - b) / diff % 6,
                     np.where(mx == g, (b - r) / diff + 2,
                              (r - g) / diff + 4)) / 6.0
        h = (h + shift) % 1.0
        s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
        v = mx
        i = np.floor(h * 6).astype(np.int32) % 6
        f = h * 6 - np.floor(h * 6)
        p = v * (1 - s)
        q = v * (1 - f * s)
        t = v * (1 - (1 - f) * s)
        out = np.zeros_like(x)
        for idx, (rr, gg, bb) in enumerate(
                [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                 (v, p, q)]):
            m = i == idx
            out[..., 0] = np.where(m, rr, out[..., 0])
            out[..., 1] = np.where(m, gg, out[..., 1])
            out[..., 2] = np.where(m, bb, out[..., 2])
        return _restore(out * scale, chw)


class ColorJitter(BaseTransform):
    """reference: transforms.py ColorJitter — random order of the four
    component transforms."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.parts = [BrightnessTransform(brightness),
                      ContrastTransform(contrast),
                      SaturationTransform(saturation),
                      HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.parts))
        for i in order:
            img = self.parts[i](img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        arr, chw = _hwc(img)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
        else:
            gray = arr[..., 0] if arr.ndim == 3 else arr
        out = np.repeat(gray[..., None], self.num_output_channels, axis=-1)
        return _restore(out, chw)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr, chw = _hwc(img)
        if np.random.random() < self.prob:
            arr = arr[::-1].copy()
        return _restore(arr, chw)


class RandomRotation(BaseTransform):
    """Rotation by a random angle in `degrees` (reference: transforms.py
    RandomRotation). Nearest-neighbor sampling (the only interpolation
    implemented; other modes raise); honors expand and center."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if interpolation not in ("nearest",):
            raise NotImplementedError(
                f"interpolation {interpolation!r}: only 'nearest' is "
                "implemented")
        if isinstance(degrees, (int, float)):
            if degrees < 0:
                raise ValueError("degrees should be non-negative")
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        arr, chw = _hwc(img)
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        H, W = arr.shape[:2]
        ca, sa = np.cos(angle), np.sin(angle)
        if self.expand:
            # canvas large enough for the whole rotated image
            OH = int(np.ceil(abs(H * ca) + abs(W * sa) - 1e-9))
            OW = int(np.ceil(abs(W * ca) + abs(H * sa) - 1e-9))
        else:
            OH, OW = H, W
        if self.center is not None:
            cx_src, cy_src = float(self.center[0]), float(self.center[1])
        else:
            cy_src, cx_src = (H - 1) / 2.0, (W - 1) / 2.0
        cy_dst, cx_dst = (OH - 1) / 2.0, (OW - 1) / 2.0
        if not self.expand:
            cy_dst, cx_dst = cy_src, cx_src
        yy, xx = np.meshgrid(np.arange(OH), np.arange(OW), indexing="ij")
        src_y = ca * (yy - cy_dst) + sa * (xx - cx_dst) + cy_src
        src_x = -sa * (yy - cy_dst) + ca * (xx - cx_dst) + cx_src
        sy = np.round(src_y).astype(np.int64)
        sx = np.round(src_x).astype(np.int64)
        valid = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
        out_shape = (OH, OW) + arr.shape[2:]
        out = np.full(out_shape, self.fill, dtype=np.float32)
        out[valid] = arr[sy[valid], sx[valid]]
        return _restore(out, chw)


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop then resize (reference: transforms.py
    RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        arr, chw = _hwc(img)
        H, W = arr.shape[:2]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                i = np.random.randint(0, H - h + 1)
                j = np.random.randint(0, W - w + 1)
                crop = arr[i:i + h, j:j + w]
                break
        else:
            s = min(H, W)
            i, j = (H - s) // 2, (W - s) // 2
            crop = arr[i:i + s, j:j + s]
        return self._resize(_restore(crop, chw))
