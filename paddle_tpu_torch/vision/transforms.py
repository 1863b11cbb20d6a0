"""Vision transforms on numpy HWC images: port of
paddle_tpu/vision/transforms.py (reference: python/paddle/vision/
transforms/). Host numpy, as the reference's; the functional
``to_tensor`` returns a Tensor of the port (the ``ToTensor`` transform
keeps returning the CHW float array a DataLoader batches)."""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, dtype=np.float32) / 255.0
        if img.ndim == 2:
            img = img[:, :, None]
        if self.data_format == "CHW":
            img = np.transpose(img, (2, 0, 1))
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32).reshape(-1)
        self.std = np.asarray(std, dtype=np.float32).reshape(-1)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, dtype=np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


def _resize_weights(in_size, out_size):
    """[in, out] weights of a bilinear resize along one axis, antialiased
    when shrinking: jax.image.resize's ``scale_and_translate`` with the
    triangle kernel, in float32."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3) \
            and img.shape[2] not in (1, 3)
        axes = (1, 2) if chw else (0, 1)
        out = img.astype(np.float32)
        for ax, n in zip(axes, self.size):
            if out.shape[ax] == n:
                continue
            w = _resize_weights(out.shape[ax], n)
            out = np.moveaxis(np.tensordot(np.moveaxis(out, ax, -1), w,
                                           axes=([-1], [0])), -1, ax)
        return out.astype(img.dtype)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return img[:, ::-1] if img.ndim == 2 else img[:, ::-1, :]
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        if self.padding:
            p = self.padding
            pad = [(p, p), (p, p)] + ([(0, 0)] if img.ndim == 3 else [])
            img = np.pad(img, pad, mode="constant")
        h, w = img.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        return img[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


def to_tensor(img, data_format="CHW"):
    """The image as a float Tensor in [0, 1] (on the current place)."""
    from ..tensor import to_tensor as _to_tensor
    return _to_tensor(ToTensor(data_format)(img))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size)(img)


def hflip(img):
    return img[:, ::-1] if np.asarray(img).ndim == 2 else np.asarray(img)[:, ::-1, :]


# ---------------------------------------------------------------------------
# the rest of the reference's transforms/{transforms,functional}.py: color
# ops, geometric warps, random augmentations. All operate on numpy HWC (or HW) images; geometric ops
# share one inverse-warp bilinear sampler.
# ---------------------------------------------------------------------------

def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        return img[:, :, None], True
    return img, False


def vflip(img):
    img = np.asarray(img)
    return img[::-1] if img.ndim == 2 else img[::-1, :, :]


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    img, was2d = _as_hwc(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    spec = [(top, bottom), (left, right), (0, 0)]
    if padding_mode == "constant":
        out = np.pad(img, spec, mode="constant", constant_values=fill)
    else:
        mode = {"edge": "edge", "reflect": "reflect",
                "symmetric": "symmetric"}[padding_mode]
        out = np.pad(img, spec, mode=mode)
    return out[:, :, 0] if was2d else out


def erase(img, i, j, h, w, v, inplace=False):
    """Cut out the [i:i+h, j:j+w] patch and fill with ``v`` (reference:
    functional.erase)."""
    img = np.asarray(img) if inplace else np.array(img, copy=True)
    img[i:i + h, j:j + w] = v
    return img


def adjust_brightness(img, brightness_factor):
    img = np.asarray(img)
    out = img.astype(np.float32) * brightness_factor
    return np.clip(out, 0, 255).astype(img.dtype) \
        if np.issubdtype(img.dtype, np.integer) else out


def to_grayscale(img, num_output_channels=1):
    img, _ = _as_hwc(img)
    w = np.asarray([0.299, 0.587, 0.114], np.float32)[: img.shape[-1]]
    w = w / w.sum()
    gray = (img.astype(np.float32) @ w)[..., None]
    gray = np.repeat(gray, num_output_channels, axis=-1)
    return gray.astype(img.dtype) if np.issubdtype(img.dtype, np.integer) \
        else gray


def adjust_contrast(img, contrast_factor):
    img = np.asarray(img)
    mean = to_grayscale(img).astype(np.float32).mean()
    out = mean + (img.astype(np.float32) - mean) * contrast_factor
    return np.clip(out, 0, 255).astype(img.dtype) \
        if np.issubdtype(img.dtype, np.integer) else out


def adjust_saturation(img, saturation_factor):
    img = np.asarray(img)
    gray = to_grayscale(img, img.shape[-1] if img.ndim == 3 else 1)
    out = gray.astype(np.float32) + (
        img.astype(np.float32) - gray.astype(np.float32)
    ) * saturation_factor
    return np.clip(out, 0, 255).astype(img.dtype) \
        if np.issubdtype(img.dtype, np.integer) else out


def adjust_hue(img, hue_factor):
    """Shift hue by ``hue_factor`` (in [-0.5, 0.5] turns) through an
    RGB->HSV->RGB round trip (reference: functional.adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = np.asarray(img)
    orig_dtype = img.dtype
    x = img.astype(np.float32)
    scale = 255.0 if np.issubdtype(orig_dtype, np.integer) else 1.0
    x = x / scale
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc, minc = x.max(-1), x.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    dz = np.maximum(delta, 1e-12)
    h = np.select(
        [maxc == r, maxc == g],
        [(g - b) / dz % 6, (b - r) / dz + 2],
        (r - g) / dz + 4) / 6.0
    h = np.where(delta > 0, h, 0)
    h = (h + hue_factor) % 1.0
    # HSV -> RGB
    i = np.floor(h * 6).astype(np.int32)
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i % 6
    out = np.choose(
        i[..., None] * 0 + np.arange(3)[None, None, :] * 0 + i[..., None],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    out = out * scale
    return np.clip(out, 0, 255).astype(orig_dtype) \
        if np.issubdtype(orig_dtype, np.integer) else out


def _inverse_warp(img, minv, fill=0, nearest=False):
    """Sample img at coordinates minv @ [x_out, y_out, 1] into a
    same-size canvas (bilinear or nearest, constant fill outside)."""
    img_a, was2d = _as_hwc(img)
    out = _inverse_warp_into(img_a, np.zeros_like(img_a), minv, fill,
                             nearest=nearest)
    return out[:, :, 0] if was2d else out


def _inverse_warp_into(img, canvas, minv, fill=0, nearest=False):
    """Core sampler: for each output pixel of ``canvas``, sample ``img``
    at minv @ [x_out, y_out, 1]."""
    img, _ = _as_hwc(img)
    h, w = canvas.shape[:2]
    sh, sw = img.shape[:2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1).astype(np.float64)
    src = minv @ coords
    if src.shape[0] == 3:       # projective: divide by w
        src = src[:2] / np.maximum(np.abs(src[2:3]), 1e-12) \
            * np.sign(src[2:3])
    sx, sy = src[0], src[1]
    if nearest:
        sx, sy = np.round(sx), np.round(sy)
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    dx, dy = sx - x0, sy - y0
    out = np.zeros((h * w, img.shape[2]), np.float32)
    acc_w = np.zeros(h * w, np.float32)
    for ox, oy, wgt in ((0, 0, (1 - dx) * (1 - dy)),
                        (1, 0, dx * (1 - dy)),
                        (0, 1, (1 - dx) * dy),
                        (1, 1, dx * dy)):
        xi, yi = x0 + ox, y0 + oy
        ok = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
        xi_c, yi_c = np.clip(xi, 0, sw - 1), np.clip(yi, 0, sh - 1)
        out += np.where(ok, wgt, 0)[:, None].astype(np.float32) \
            * img[yi_c, xi_c].astype(np.float32)
        acc_w += np.where(ok, wgt, 0).astype(np.float32)
    out = np.where(acc_w[:, None] > 1e-8, out / np.maximum(
        acc_w[:, None], 1e-8), fill)
    out = out.reshape(h, w, img.shape[2])
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(out, 0, 255).astype(img.dtype)
    return out


def _affine_inv_matrix(angle, translate, scale, shear, center):
    """Inverse of the forward affine (rotate+shear+scale about center,
    then translate) — what the output-to-input sampler needs."""
    a = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate
    # forward: T(center) R(a) Sh(sx, sy) S(scale) T(-center) then T(t)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    sh = np.array([[1, np.tan(sx)], [np.tan(sy), 1]])
    m = rot @ sh * scale
    full = np.eye(3)
    full[:2, :2] = m
    full[:2, 2] = [cx + tx - m[0] @ [cx, cy], cy + ty - m[1] @ [cx, cy]]
    return np.linalg.inv(full)


def rotate(img, angle, interpolation="bilinear", expand=False,
           center=None, fill=0):
    img_a = np.asarray(img)
    h, w = img_a.shape[:2]
    c = center if center is not None else ((w - 1) / 2, (h - 1) / 2)
    if not expand:
        minv = _affine_inv_matrix(-angle, (0, 0), 1.0, (0, 0), c)
        return _inverse_warp(img_a, minv, fill,
                             nearest=interpolation == "nearest")
    # expand: canvas grows to hold every rotated corner; the sampler's
    # inverse map shifts by the new canvas offset
    a = np.deg2rad(angle)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                       np.float64) - np.asarray(c)
    rc = corners @ rot.T
    nw = int(np.ceil(rc[:, 0].max() - rc[:, 0].min())) + 1
    nh = int(np.ceil(rc[:, 1].max() - rc[:, 1].min())) + 1
    # output pixel -> center the new canvas, rotate back, re-center
    full = np.eye(3)
    full[:2, :2] = rot.T          # inverse rotation
    off = np.array([(nw - 1) / 2, (nh - 1) / 2])
    full[:2, 2] = np.asarray(c) - rot.T @ off
    shaped = np.zeros((nh, nw) + img_a.shape[2:], img_a.dtype)
    out = _inverse_warp_into(img_a, shaped, full,
                             fill, nearest=interpolation == "nearest")
    return out


def affine(img, angle, translate, scale, shear, interpolation="bilinear",
           fill=0, center=None):
    img_a = np.asarray(img)
    h, w = img_a.shape[:2]
    if np.isscalar(shear):
        shear = (float(shear), 0.0)
    c = center if center is not None else ((w - 1) / 2, (h - 1) / 2)
    minv = _affine_inv_matrix(-angle, translate, scale, shear, c)
    return _inverse_warp(img_a, minv, fill)


def _homography(src_pts, dst_pts):
    """8-DoF projective transform mapping src -> dst (4 point pairs)."""
    A, b = [], []
    for (x, y), (u, v) in zip(src_pts, dst_pts):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A, np.float64),
                        np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    """Warp so that ``startpoints`` map to ``endpoints`` (reference:
    functional.perspective; sampler uses the inverse map)."""
    minv = _homography(endpoints, startpoints)
    return _inverse_warp(np.asarray(img), minv, fill)


# ------------------------------------------------------------ transforms

class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if np.random.rand() < self.prob else img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding, self.fill = padding, fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class Transpose(BaseTransform):
    """HWC -> CHW (reference: transforms.Transpose, default (2, 0, 1))."""

    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        return np.transpose(img, self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order
    (reference: transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation),
                   HueTransform(hue)]

    def _apply_image(self, img):
        for i in np.random.permutation(len(self.ts)):
            img = self.ts[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.center, self.fill = center, fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.translate, self.scale_rng = translate, scale
        self.shear = shear
        self.fill, self.center = fill, center

    def _apply_image(self, img):
        h, w = np.asarray(img).shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        scale = np.random.uniform(*self.scale_rng) if self.scale_rng else 1.0
        shear = 0.0
        if self.shear is not None:
            s = (-self.shear, self.shear) if np.isscalar(self.shear) \
                else self.shear
            shear = np.random.uniform(s[0], s[1])
        return affine(img, angle, (tx, ty), scale, shear, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0):
        self.prob, self.distortion_scale = prob, distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        h, w = np.asarray(img).shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, dx + 1),
                np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1)),
               (np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1))]
        return perspective(img, start, end, fill=self.fill)


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop resized to ``size`` (reference:
    transforms.RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio = scale, ratio

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                patch = crop(img, i, j, ch, cw)
                return Resize(self.size)(patch)
        return Resize(self.size)(CenterCrop(min(h, w))(img))


class RandomErasing(BaseTransform):
    """Random cutout with value/random fill (reference:
    transforms.RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value = value

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        img = np.asarray(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target / ar)))
            ew = int(round(np.sqrt(target * ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                v = self.value if self.value != "random" else \
                    np.random.rand(eh, ew, *img.shape[2:]) * 255
                return erase(img, i, j, eh, ew, v)
        return img
