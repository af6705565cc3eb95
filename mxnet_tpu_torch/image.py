"""Host-side image decode/encode/augmentation.

The port's copy of ``mxnet_tpu/image.py`` (the reference's OpenCV-backed
image path, ``src/io/image_augmenter.h``/``image_aug_default.cc``).  Decode
runs on the host's CPUs (the reference's OMP decode threads,
iter_image_recordio.cc:184-234); augmented uint8/float arrays go to the
device once per batch.  Uses OpenCV when importable, else PIL — both are
decode-only dependencies, never on the compute path.
"""
from __future__ import annotations

import io as _io

import numpy as _np

__all__ = ["imdecode_bytes", "imencode", "augment", "imresize"]

try:
    import cv2 as _cv2
except Exception:  # pragma: no cover
    _cv2 = None
try:
    from PIL import Image as _PILImage
except Exception:  # pragma: no cover
    _PILImage = None


def imdecode_bytes(buf, iscolor=1):
    """Decode an encoded image buffer to an HWC uint8 RGB array."""
    buf = bytes(buf)
    if _cv2 is not None:
        flag = _cv2.IMREAD_COLOR if iscolor != 0 else _cv2.IMREAD_GRAYSCALE
        img = _cv2.imdecode(_np.frombuffer(buf, dtype=_np.uint8), flag)
        if img is None:
            raise ValueError("cannot decode image")
        if img.ndim == 2:
            img = img[:, :, None]
        else:
            img = _cv2.cvtColor(img, _cv2.COLOR_BGR2RGB)
        return img
    if _PILImage is not None:
        img = _PILImage.open(_io.BytesIO(buf))
        img = img.convert("L" if iscolor == 0 else "RGB")
        arr = _np.asarray(img, dtype=_np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    raise ImportError("image decoding requires cv2 or PIL")


def imencode(img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 array to JPEG/PNG bytes."""
    img = _np.asarray(img, dtype=_np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if _cv2 is not None:
        enc = img if img.shape[2] == 1 else _cv2.cvtColor(img, _cv2.COLOR_RGB2BGR)
        params = [_cv2.IMWRITE_JPEG_QUALITY, quality] \
            if img_fmt.lower() in (".jpg", ".jpeg") else []
        ok, buf = _cv2.imencode(img_fmt, enc, params)
        if not ok:
            raise ValueError("cannot encode image")
        return buf.tobytes()
    if _PILImage is not None:
        mode = "L" if img.shape[2] == 1 else "RGB"
        pimg = _PILImage.fromarray(img.squeeze() if mode == "L" else img, mode)
        bio = _io.BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        pimg.save(bio, format=fmt, quality=quality)
        return bio.getvalue()
    raise ImportError("image encoding requires cv2 or PIL")


def imresize(img, w, h):
    if _cv2 is not None:
        out = _cv2.resize(img, (w, h), interpolation=_cv2.INTER_LINEAR)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    pimg = _PILImage.fromarray(img.squeeze() if img.shape[2] == 1 else img)
    out = _np.asarray(pimg.resize((w, h), _PILImage.BILINEAR), dtype=img.dtype)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def _jitter_hsl(img, dh, ds, dl, rng):
    """Random hue/saturation/lightness shift (image_aug_default.cc HSL).

    Offsets are drawn uniform in [-d, d] per channel, matching the
    reference's random_h/random_s/random_l semantics on 0-255 images.
    """
    if dh <= 0 and ds <= 0 and dl <= 0:
        return img
    if img.shape[2] != 3 or _cv2 is None:
        # grayscale or no cv2: lightness jitter only
        off = rng.uniform(-dl, dl) if dl > 0 else 0.0
        return _np.clip(img.astype(_np.float32) + off, 0, 255).astype(img.dtype)
    hls = _cv2.cvtColor(img, _cv2.COLOR_RGB2HLS).astype(_np.float32)
    if dh > 0:
        hls[:, :, 0] = (hls[:, :, 0] + rng.uniform(-dh, dh) * 180.0 / 255.0) % 180.0
    if dl > 0:
        hls[:, :, 1] = hls[:, :, 1] + rng.uniform(-dl, dl)
    if ds > 0:
        hls[:, :, 2] = hls[:, :, 2] + rng.uniform(-ds, ds)
    hls = _np.clip(hls, 0, 255)
    hls[:, :, 0] = _np.clip(hls[:, :, 0], 0, 179)
    return _cv2.cvtColor(hls.astype(_np.uint8), _cv2.COLOR_HLS2RGB)


def _affine_warp(img, M, out_w, out_h, fill_value=255):
    """Inverse-map affine warp with bilinear sampling and constant fill —
    the numpy form of the reference's cv::warpAffine(M, BORDER_CONSTANT,
    fill_value) geometry path."""
    if _cv2 is not None:
        out = _cv2.warpAffine(
            img, M[:2], (out_w, out_h), flags=_cv2.INTER_LINEAR,
            borderMode=_cv2.BORDER_CONSTANT,
            borderValue=tuple([float(fill_value)] * 3))
        if out.ndim == 2:
            out = out[:, :, None]
        return out.astype(img.dtype)
    A = _np.vstack([M[:2], [0.0, 0.0, 1.0]])
    Ainv = _np.linalg.inv(A)
    ys, xs = _np.mgrid[0:out_h, 0:out_w]
    src_x = Ainv[0, 0] * xs + Ainv[0, 1] * ys + Ainv[0, 2]
    src_y = Ainv[1, 0] * xs + Ainv[1, 1] * ys + Ainv[1, 2]
    h, w = img.shape[:2]
    x0 = _np.floor(src_x).astype(_np.int64)
    y0 = _np.floor(src_y).astype(_np.int64)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    out = _np.full((out_h, out_w, img.shape[2]), float(fill_value))
    valid = (src_x >= 0) & (src_x <= w - 1) & (src_y >= 0) & (src_y <= h - 1)
    x0c = _np.clip(x0, 0, w - 2)
    y0c = _np.clip(y0, 0, h - 2)
    f = img.astype(_np.float64)
    samp = (f[y0c, x0c] * (1 - fx) * (1 - fy)
            + f[y0c, x0c + 1] * fx * (1 - fy)
            + f[y0c + 1, x0c] * (1 - fx) * fy
            + f[y0c + 1, x0c + 1] * fx * fy)
    out[valid] = samp[valid]
    return _np.clip(out, 0, 255).astype(img.dtype)


def augment(img, data_shape, rand_crop=False, rand_mirror=False, rng=None,
            max_rotate_angle=0, rotate=-1, min_random_scale=1.0,
            max_random_scale=1.0, max_aspect_ratio=0.0,
            max_shear_ratio=0.0, min_crop_size=-1, max_crop_size=-1,
            min_img_size=0.0, max_img_size=1e10, pad=0, fill_value=255,
            random_h=0, random_s=0, random_l=0):
    """Default augmenter (parity: image_aug_default.cc
    DefaultImageAugmenter): affine scale/aspect/shear/rotate with
    constant fill, pad, random-size or fixed crop to data_shape (C,H,W),
    mirror, HSL jitter.  All knobs default off, matching the reference's
    ImageRecordIter parameter defaults."""
    rng = rng or _np.random
    c, th, tw = data_shape
    if (min_crop_size > 0) != (max_crop_size > 0):
        raise ValueError("min_crop_size and max_crop_size must be set "
                         "together (reference CHECK)")
    if min_crop_size > 0 and min_crop_size > max_crop_size:
        raise ValueError("min_crop_size must be <= max_crop_size")
    use_affine = (max_rotate_angle > 0 or rotate > 0
                  or max_shear_ratio > 0.0 or max_aspect_ratio > 0.0
                  or min_img_size != 0.0 or max_img_size != 1e10)
    if use_affine:
        # the reference's combined matrix (image_aug_default.cc): shear s,
        # rotation (a, b), scale split across axes by the aspect ratio
        s = rng.uniform(0, 1) * max_shear_ratio * 2 - max_shear_ratio
        angle = int(rng.uniform(-max_rotate_angle, max_rotate_angle)) \
            if max_rotate_angle > 0 else 0
        if rotate > 0:
            angle = rotate
        a = _np.cos(angle / 180.0 * _np.pi)
        b = _np.sin(angle / 180.0 * _np.pi)
        scale = rng.uniform(min_random_scale, max_random_scale)
        ratio = rng.uniform(0, 1) * max_aspect_ratio * 2 \
            - max_aspect_ratio + 1
        hs = 2 * scale / (1 + ratio)
        ws = ratio * hs
        h, w = img.shape[:2]
        new_w = max(min_img_size, min(max_img_size, scale * w))
        new_h = max(min_img_size, min(max_img_size, scale * h))
        M = _np.zeros((2, 3))
        M[0, 0] = hs * a - s * b * ws
        M[1, 0] = -b * ws
        M[0, 1] = hs * b + s * a * ws
        M[1, 1] = a * ws
        ori_cw = M[0, 0] * w + M[0, 1] * h
        ori_ch = M[1, 0] * w + M[1, 1] * h
        M[0, 2] = (new_w - ori_cw) / 2
        M[1, 2] = (new_h - ori_ch) / 2
        img = _affine_warp(img, M, int(round(new_w)), int(round(new_h)),
                           fill_value)
    elif max_random_scale != 1.0 or min_random_scale != 1.0:
        s = rng.uniform(min_random_scale, max_random_scale)
        h, w = img.shape[:2]
        img = imresize(img, max(tw, int(w * s + 0.5)), max(th, int(h * s + 0.5)))
    if pad > 0:
        img = _np.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                      constant_values=fill_value)
    if min_crop_size > 0 and max_crop_size > 0:
        # random square crop in [min, max] then resize to the target
        # (image_aug_default.cc random-crop-size branch)
        h, w = img.shape[:2]
        hi = min(max_crop_size, min(h, w))
        lo = min(min_crop_size, hi)
        size = int(rng.uniform(0, 1) * (hi - lo + 1)) + lo \
            if hi > lo else hi
        y, x = h - size, w - size
        if rand_crop:
            y = rng.randint(0, y + 1)
            x = rng.randint(0, x + 1)
        else:
            y //= 2
            x //= 2
        img = imresize(img[y:y + size, x:x + size], tw, th)
    h, w = img.shape[:2]
    # upscale if needed so a crop fits
    if h < th or w < tw:
        scale = max(th / h, tw / w)
        img = imresize(img, max(tw, int(w * scale + 0.5)),
                       max(th, int(h * scale + 0.5)))
        h, w = img.shape[:2]
    if rand_crop:
        y = rng.randint(0, h - th + 1)
        x = rng.randint(0, w - tw + 1)
    else:
        y = (h - th) // 2
        x = (w - tw) // 2
    img = img[y:y + th, x:x + tw]
    if rand_mirror and rng.randint(0, 2):
        img = img[:, ::-1]
    if random_h or random_s or random_l:
        img = _jitter_hsl(img, random_h, random_s, random_l, rng)
    if img.shape[2] != c:
        if c == 1:
            img = img.mean(axis=2, keepdims=True).astype(img.dtype)
        else:
            img = _np.repeat(img[:, :, :1], c, axis=2)
    return img
