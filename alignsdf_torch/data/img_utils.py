"""Image reading and augmentation in numpy and PIL, without OpenCV (the
JAX package's ``data/img_utils.py``; reference utils/img_utils.py:15-27,
106-207).

``load_img`` reads what the JAX package's ``cv2.imread(path, IMREAD_COLOR |
IMREAD_IGNORE_ORIENTATION)`` reads, through PIL: three channels whatever the
file holds (gray, palette and CMYK converted), no EXIF transpose.  Both
libraries decode JPEG with libjpeg-turbo's default (islow) IDCT and fancy
upsampling, so the pixels agree bit for bit on baseline, progressive and
subsampled files; a CMYK file's conversion to RGB differs by at most one
level.  ``read_image_unchanged`` reads what ``IMREAD_UNCHANGED`` reads, which
the LMDB packer stores.

The JAX package warps the training patch with ``cv2.warpAffine``; the card's
machine has no cv2, so ``warp_affine_linear`` computes the same bilinear warp
with a constant-0 border.  It follows OpenCV 5's float kernel for 8-bit
images: the inverse matrix in float32, source coordinates
``fma(x, M0, y * M1 + M2)``, the three lerps of the bilinear blend as fused
multiply-adds, rounded to nearest even.  A float32 fma is taken exactly
from a float64 product and sum (a product of float32 values fits float64's
mantissa), so the result equals OpenCV 5's bit for bit on the inputs the
tests use.  OpenCV 4's fixed-point path (1/32-pixel coordinates, 15-bit
weights) differs from both by up to a few levels.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_img(path: str, order: str = "RGB") -> np.ndarray:
    """uint8 (H, W, 3) in ``order`` ("RGB" or "BGR"); a file that is missing
    or does not decode raises IOError, as the JAX package's ``load_img``."""
    try:
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
    except OSError as e:
        raise IOError(f"Fail to read {path}") from e
    return np.ascontiguousarray(img[:, :, ::-1]) if order == "BGR" else img


# PIL mode -> the mode IMREAD_UNCHANGED's channels correspond to
_UNCHANGED_MODES = {"L": "L", "RGB": "RGB", "RGBA": "RGBA", "LA": "RGBA", "CMYK": "RGB"}


def read_image_unchanged(path: str) -> np.ndarray:
    """The 8-bit image as ``cv2.imread(path, IMREAD_UNCHANGED)`` reads it:
    2-D for gray, BGR for colour (a CMYK JPEG converted), BGRA with an alpha
    channel (a palette with transparency expanded); no EXIF transpose.
    Another mode (e.g. 16-bit gray) raises IOError."""
    try:
        with Image.open(path) as im:
            mode = (("RGBA" if "transparency" in im.info else "RGB") if im.mode == "P"
                    else _UNCHANGED_MODES.get(im.mode))
            if mode is None:
                raise IOError(f"{path}: PIL mode {im.mode} is not read")
            img = np.asarray(im if im.mode == mode else im.convert(mode), np.uint8)
    except OSError as e:
        raise IOError(f"Fail to read {path}") from e
    if img.ndim == 3:  # RGB(A) -> BGR(A)
        img = img[:, :, [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC normalized with ImageNet statistics
    (reference utils/data.py:67-71)."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def get_aug_config(dataset: str, enable_flip: bool = False,
                   rng: Optional[random.Random] = None,
                   np_rng: Optional[np.random.RandomState] = None):
    """Random augmentation parameters (reference utils/img_utils.py:106-130),
    drawn in the JAX package's order from the same generators."""
    rng = rng or random
    np_rng = np_rng or np.random
    if "obman" in dataset:
        scale_factor, rot_factor, color_factor = 0.25, 45, 0.3
        scale = np.clip(np_rng.randn(), -1.0, 1.0) * scale_factor + 1.0
    else:
        scale_factor, rot_factor, color_factor = 0.25, 15, 0.2
        scale = np.clip(np_rng.randn(), -1.0, 0.0) * scale_factor + 1.0
    rot = np.clip(np_rng.randn(), -2.0, 2.0) * rot_factor if rng.random() <= 0.6 else 0
    do_flip = bool(enable_flip and rng.random() <= 0.5)
    c_up, c_low = 1.0 + color_factor, 1.0 - color_factor
    color_scale = [rng.uniform(c_low, c_up) for _ in range(3)]
    do_occlusion = rng.random() <= 0.5
    return scale, rot, do_flip, color_scale, do_occlusion


def rotate_2d(pt: np.ndarray, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32)


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affine map taking three source points to three destination
    points, float64 (``cv2.getAffineTransform``: a 6x6 solve in double)."""
    a = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for i in range(3):  # OpenCV's row order: (x, y, 1) for u, then for v
        a[2 * i, 0:2] = a[2 * i + 1, 3:5] = src[i]
        a[2 * i, 2] = a[2 * i + 1, 5] = 1.0
        b[2 * i], b[2 * i + 1] = dst[i]
    return np.linalg.solve(a, b).reshape(2, 3)


def gen_trans_from_patch_cv(c_x, c_y, src_width, src_height, dst_width, dst_height,
                            scale, rot, inv=False) -> np.ndarray:
    """Affine patch transform (reference utils/img_utils.py:176-207)."""
    src_w = src_width * scale
    src_h = src_height * scale
    src_center = np.array([c_x, c_y], np.float32)
    rot_rad = np.pi * rot / 180
    src_downdir = rotate_2d(np.array([0, src_h * 0.5], np.float32), rot_rad)
    src_rightdir = rotate_2d(np.array([src_w * 0.5, 0], np.float32), rot_rad)

    dst_center = np.array([dst_width * 0.5, dst_height * 0.5], np.float32)
    dst_downdir = np.array([0, dst_height * 0.5], np.float32)
    dst_rightdir = np.array([dst_width * 0.5, 0], np.float32)

    src = np.stack([src_center, src_center + src_downdir, src_center + src_rightdir])
    dst = np.stack([dst_center, dst_center + dst_downdir, dst_center + dst_rightdir])

    if inv:
        return affine_from_points(np.float32(dst), np.float32(src))
    return affine_from_points(np.float32(src), np.float32(dst))


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``'s arithmetic, in double."""
    m = np.asarray(m, np.float64).reshape(-1)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a12, a21, a22 = m[4] * d, -m[1] * d, -m[3] * d, m[0] * d
    return np.array([a11, a12, -a11 * m[2] - a12 * m[5],
                     a21, a22, -a21 * m[2] - a22 * m[5]])


def _fma32(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 a * b + c with one rounding, for float32 values held in any
    float type: their product is exact in float64."""
    r = b.astype(np.float64)
    r *= a
    r += c
    return r.astype(np.float32)


def warp_affine_linear(img: np.ndarray, m: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpAffine(img, m, (width, height), flags=INTER_LINEAR)`` for a
    uint8 HWC image, border constant 0."""
    inv = _invert_affine(m).astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[None, :]
    ys = np.arange(height, dtype=np.float32)[:, None]
    grid = np.broadcast_to(xs, (height, width))
    sx = _fma32(inv[0], grid, ys * inv[1] + inv[2])
    sy = _fma32(inv[3], grid, ys * inv[4] + inv[5])
    fx, fy = np.floor(sx), np.floor(sy)
    h, w, c = img.shape
    # two pixels of zeros around the image: a tap pair clipped into the
    # margin reads zeros, as every tap outside the image does; a pixel's
    # channels packed in 4 bytes gather as one word
    padded = np.zeros((h + 4, w + 4, 4), np.uint8)
    padded[2:-2, 2:-2, :c] = img
    words = padded.view(np.uint32).reshape(-1)
    idx = ((np.clip(fy, -2, h).astype(np.int64) + 2) * (w + 4)
           + np.clip(fx, -2, w).astype(np.int64) + 2)

    def tap(offset: int) -> np.ndarray:  # (height, width, 4) uint8
        return np.take(words, idx + offset).view(np.uint8).reshape(height, width, 4)

    p00 = tap(0)
    alpha, beta = sx - fx, sy - fy
    if not (alpha.any() or beta.any()):  # on the pixel grid (no rotation): a copy
        return np.ascontiguousarray(p00[..., :c])
    # the fractions per channel, contiguous (numpy broadcasts a trailing 1 slowly)
    alpha = np.repeat(alpha[..., None].astype(np.float64), 4, axis=2)
    beta = np.repeat(beta[..., None].astype(np.float64), 4, axis=2)
    p00, p01, p10, p11 = (t.astype(np.float32) for t in (p00, tap(1), tap(w + 4), tap(w + 5)))
    # the products of integer differences and float32 fractions are exact
    # in float64, so each lerp rounds once, as a float32 fma does
    v0 = _fma32(alpha, p01 - p00, p00)
    v1 = _fma32(alpha, p11 - p10, p10)
    v = _fma32(beta, v1 - v0, v0)
    return np.ascontiguousarray(np.clip(np.rint(v), 0, 255).astype(np.uint8)[..., :c])


def synthetic_occlusion(img: np.ndarray, bbox: List[float],
                        rng: Optional[random.Random] = None,
                        np_rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """A copy of ``img`` with a random box inside ``bbox`` filled with
    uniform noise (the JAX package's ``data/img_utils.py:88-102``, from
    reference utils/img_utils.py:133-173): boxes are drawn from ``rng``
    until one lies inside the image, the noise from ``np_rng``."""
    rng = rng or random
    np_rng = np_rng or np.random
    img = img.copy()
    img_height, img_width, _ = img.shape
    while True:
        area = (rng.random() * 0.7) * bbox[2] * bbox[3]
        ratio = rng.random() * (1 / 0.3 - 0.3) + 0.3
        synth_h = math.sqrt(area * ratio)
        synth_w = math.sqrt(area / ratio)
        synth_xmin = rng.random() * (bbox[2] - synth_w - 1) + bbox[0]
        synth_ymin = rng.random() * (bbox[3] - synth_h - 1) + bbox[1]
        if (synth_xmin >= 0 and synth_ymin >= 0
                and synth_xmin + synth_w < img_width
                and synth_ymin + synth_h < img_height):
            xmin, ymin = int(synth_xmin), int(synth_ymin)
            w, h = int(synth_w), int(synth_h)
            img[ymin:ymin + h, xmin:xmin + w, :] = np_rng.rand(h, w, 3) * 255
            return img


def generate_patch_image(img: np.ndarray, bbox: List[float], input_shape,
                         do_flip: bool, scale: float, rot: float, do_occlusion: bool = False,
                         rng: Optional[random.Random] = None,
                         np_rng: Optional[np.random.RandomState] = None):
    """Crop/warp the image to the model input patch, with optional synthetic
    occlusion (``synthetic_occlusion``, drawn from ``rng`` and ``np_rng``)
    and horizontal flip (reference utils/img_utils.py:133-173)."""
    if do_occlusion:
        img = synthetic_occlusion(img, bbox, rng, np_rng)
    img_width = img.shape[1]

    bb_c_x = float(bbox[0] + 0.5 * bbox[2])
    bb_c_y = float(bbox[1] + 0.5 * bbox[3])

    if do_flip:
        img = img[:, ::-1, :]
        bb_c_x = img_width - bb_c_x - 1

    trans = gen_trans_from_patch_cv(
        bb_c_x, bb_c_y, float(bbox[2]), float(bbox[3]),
        input_shape[1], input_shape[0], scale, rot, inv=False,
    )
    patch = warp_affine_linear(img, trans, int(input_shape[1]), int(input_shape[0]))
    return patch, trans
