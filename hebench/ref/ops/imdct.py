"""IMDCT (``imdct_half``, libavcodec/mdct.c:124-159) in float64 NumPy,
and the same transform as a matrix product at TF32 precision.

``imdct_half_ref`` is the plain transform: pre-rotation, an inverse FFT,
post-rotation, in float64.  ``imdct_half_tf32`` is the benchmark's
control: the transform as ``c @ M`` with both operands rounded to TF32
(8-bit exponent, 10-bit mantissa, round to nearest even) and the products
summed in float32, as a GPU's tensor cores do a float32 matrix product
with TF32 allowed.  A decode whose PCM reads as this one does is computed
below float32.
"""
from __future__ import annotations

import functools

import numpy as np


# ---------------------------------------------------------------------------
# numpy reference algorithm (float64): direct port of mdct.c:61-159 semantics
# ---------------------------------------------------------------------------
def _split_radix_permutation(i: int, n: int, inverse: bool) -> int:
    """fft.c:56-63."""
    if n <= 2:
        return i & 1
    m = n >> 1
    if not (i & m):
        return _split_radix_permutation(i, m, inverse) * 2
    m >>= 1
    if inverse == (not (i & m)):
        return _split_radix_permutation(i, m, inverse) * 4 + 1
    return _split_radix_permutation(i, m, inverse) * 4 - 1


def _revtab(nbits: int, inverse: bool = True) -> np.ndarray:
    n = 1 << nbits
    rt = np.zeros(n, np.int64)
    for i in range(n):
        rt[-_split_radix_permutation(i, n, inverse) & (n - 1)] = i
    return rt


def imdct_half_ref(c: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Reference ``ff_imdct_half`` in float64 numpy (mdct.c:124-159),
    validated bitwise-close against the C build (tools/ref_harness).

    c: [..., N/2] MDCT coefficients -> [..., N/2] (the middle half of the
    inverse transform).  ``scale`` as in ff_mdct_init (negative scale flips
    the twiddle theta by N/4, used by the SBR analysis QMF).
    """
    c = np.asarray(c, np.float64)
    n2 = c.shape[-1]
    n = 2 * n2
    n4 = n // 4
    n8 = n // 8
    theta = 1.0 / 8.0 + (n4 if scale < 0 else 0)
    s = np.sqrt(abs(scale))
    alpha = 2 * np.pi * (np.arange(n4) + theta) / n
    tcos = -np.cos(alpha) * s
    tsin = -np.sin(alpha) * s

    in1 = c[..., 0::2][..., :n4]
    in2 = c[..., ::-1][..., 0::2][..., :n4]
    # CMUL(z[j].re, z[j].im, in2, in1, tcos, tsin); the revtab scatter feeds
    # ff_fft_calc(inverse=1), which computes the *unnormalized inverse DFT*
    # of the naturally-ordered sequence (verified against the C build).
    z = (in2 * tcos - in1 * tsin) + 1j * (in2 * tsin + in1 * tcos)
    z = np.fft.ifft(z, axis=-1) * n4

    out = np.zeros(c.shape, np.float64)
    k = np.arange(n8)
    zr1 = z[..., n8 - 1 - k]
    zr2 = z[..., n8 + k]
    # post rotation + reorder (mdct.c:150-158)
    out[..., 2 * (n8 - 1 - k)] = zr1.imag * tsin[n8 - 1 - k] - zr1.real * tcos[n8 - 1 - k]
    out[..., 2 * (n8 + k) + 1] = zr1.imag * tcos[n8 - 1 - k] + zr1.real * tsin[n8 - 1 - k]
    out[..., 2 * (n8 + k)] = zr2.imag * tsin[n8 + k] - zr2.real * tcos[n8 + k]
    out[..., 2 * (n8 - 1 - k) + 1] = zr2.imag * tcos[n8 + k] + zr2.real * tsin[n8 + k]
    return out


@functools.cache
def imdct_half_matrix(n2: int, scale: float = 1.0,
                      dtype=np.float32) -> np.ndarray:
    """[n2, n2] matrix M with imdct_half(c) == c @ M (row-vector convention),
    built by running the float64 reference algorithm on the identity."""
    return imdct_half_ref(np.eye(n2), scale).astype(dtype)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even), returned as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def imdct_half_tf32(c: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """``imdct_half_ref`` as a matrix product with TF32 operands and a
    float32 sum -> float32 [..., N/2]."""
    c = np.asarray(c, np.float32)
    m = tf32_round(imdct_half_matrix(c.shape[-1], scale))
    return np.matmul(tf32_round(c), m, dtype=np.float32)
