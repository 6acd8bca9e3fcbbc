"""XYB (opsin) color transform, forward and inverse.

Mirrors enc_xyb.cc:43-106 (LinearRGBToXYB) and dec_xyb-inl.h:37-85
(XybToRgb), in NumPy; the device render program's JAX versions live
in ops/pipeline.py (rgb_to_xyb_jax, xyb_to_rgb_jax).
"""

from __future__ import annotations

import numpy as np

from ..io.headers import (
    DEFAULT_INVERSE_OPSIN_MATRIX,
    OPSIN_ABSORBANCE_BIAS,
    OPSIN_ABSORBANCE_MATRIX,
)

_M = np.array(OPSIN_ABSORBANCE_MATRIX, dtype=np.float64)
_MINV = np.array(DEFAULT_INVERSE_OPSIN_MATRIX, dtype=np.float64)
_BIAS = OPSIN_ABSORBANCE_BIAS
_CBRT_BIAS = _BIAS ** (1.0 / 3.0)


def linear_rgb_to_xyb(rgb: np.ndarray) -> np.ndarray:
    """rgb: (3, H, W) linear [0,1] -> xyb (3, H, W).

    dtype-following: float32 input stays float32 end-to-end (the
    reference's encode path is float32, enc_xyb.cc), anything else
    computes in float64 (metrics callers)."""
    dt = np.float32 if rgb.dtype == np.float32 else np.float64
    m = _M.astype(dt)
    bias = dt(_BIAS)
    r, g, b = rgb[0], rgb[1], rgb[2]
    mixed = np.stack([
        m[0, 0] * r + m[0, 1] * g + m[0, 2] * b + bias,
        m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + bias,
        m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + bias,
    ])
    mixed = np.maximum(mixed, 0.0)
    cbrt = np.cbrt(mixed) - dt(_CBRT_BIAS)
    return np.stack([
        dt(0.5) * (cbrt[0] - cbrt[1]),
        dt(0.5) * (cbrt[0] + cbrt[1]),
        cbrt[2],
    ])


def xyb_to_linear_rgb(xyb: np.ndarray) -> np.ndarray:
    """Inverse of linear_rgb_to_xyb (dtype-following like the forward)."""
    dt = np.float32 if xyb.dtype == np.float32 else np.float64
    x, y, b = xyb[0], xyb[1], xyb[2]
    cb = dt(_CBRT_BIAS)
    bias = dt(_BIAS)
    gr = y + x + cb
    gg = y - x + cb
    gb = b + cb
    mixed = np.stack([gr ** 3 - bias, gg ** 3 - bias, gb ** 3 - bias])
    return np.einsum("ij,j...->i...", _MINV.astype(dt), mixed)


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """sRGB transfer function inverse ([0,1] -> linear)."""
    srgb = np.asarray(srgb, dtype=np.float64)
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4)


_SRGB_U8_LUT = None


def srgb_u8_to_linear(img_u8: np.ndarray) -> np.ndarray:
    """uint8 sRGB -> linear float32 via a 256-entry LUT (values computed
    in float64 then rounded once; the reference encoder's pixel path is
    float32, enc_xyb.cc / dec_external_image.cc)."""
    global _SRGB_U8_LUT
    if _SRGB_U8_LUT is None:
        _SRGB_U8_LUT = srgb_to_linear(
            np.arange(256) / 255.0).astype(np.float32)
    return _SRGB_U8_LUT[img_u8]


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(linear <= 0.0031308, linear * 12.92,
                    1.055 * linear ** (1 / 2.4) - 0.055)


_SRGB_ENC_THR = None


def linear_to_srgb_u8(linear: np.ndarray) -> np.ndarray:
    """round(linear_to_srgb(x) * 255) clamped to uint8, computed as one
    searchsorted against the 255 linear-domain decision thresholds (the
    transfer function is monotone, so quantization commutes with it) —
    replaces a full-image pow with ~8 comparisons/pixel.  Matches the
    float path except exactly AT a threshold (half-up vs numpy's
    round-half-even), which no real pow output lands on."""
    global _SRGB_ENC_THR
    if _SRGB_ENC_THR is None:
        v = (np.arange(1, 256) - 0.5) / 255.0
        _SRGB_ENC_THR = srgb_to_linear(v).astype(np.float32)
    lin32 = np.ascontiguousarray(linear, dtype=np.float32)
    from ..native_ext import get_lib, srgb_u8_native

    out = srgb_u8_native(get_lib(), lin32, _SRGB_ENC_THR)
    if out is not None:
        return out
    out = np.searchsorted(_SRGB_ENC_THR, lin32.ravel(), side="left")
    return out.reshape(lin32.shape).astype(np.uint8)
