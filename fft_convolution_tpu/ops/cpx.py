"""Packed halfcomplex arithmetic over real ``[..., 2, B]`` arrays.

The engines keep no complex dtype (ops/fft.py), so spectra are stored as stacked
(re, im) float32 planes with the Nyquist bin packed into ``im[..., 0]``
(see ``ops/fft.py``).  The product of two such spectra is the ordinary
complex product on bins 1..B-1, and the *real* products DC*DC and
Nyquist*Nyquist on the packed lane 0 — one masked select.

This module is the counterpart of ``complex_multiply_accumulate``
(``src/fft_convolver.rs:62-74``), decomposed into real ops.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _lane0_mask(b: int) -> np.ndarray:
    m = np.zeros((b,), np.float32)
    m[0] = 1.0
    return m


def pmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Packed product: complex multiply on bins >= 1, real DC and Nyquist
    products on lane 0.  Shapes broadcast over leading axes."""
    m0 = jnp.asarray(_lane0_mask(a.shape[-1]))
    ar, ai = a[..., 0, :], a[..., 1, :]
    br, bi = b[..., 0, :], b[..., 1, :]
    cross = ai * bi
    re = ar * br - cross * (1.0 - m0)     # lane 0: pure DC*DC
    im = (ar * bi + ai * br) * (1.0 - m0) + cross * m0  # lane 0: Nyq*Nyq
    return jnp.stack([re, im], axis=-2)


def pmul_sum(a: jnp.ndarray, b: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Masked sum over the partition axis of packed products — the fused
    spectral MAC: ``sum_i mask[i] * a[i] (*) b[i]``.

    ``a``, ``b``: [..., N, 2, B]; ``mask``: [N] float or bool.  Returns
    [..., 2, B].  Decomposed so XLA fuses the whole reduction into one elementwise
    pass; leading axes (e.g. farm voices) batch transparently.
    """
    m = mask.astype(a.dtype)[:, None]
    ar, ai = a[..., 0, :], a[..., 1, :]
    br, bi = b[..., 0, :], b[..., 1, :]
    rr = jnp.sum(m * ar * br, axis=-2)
    ii = jnp.sum(m * ai * bi, axis=-2)
    ri = jnp.sum(m * ar * bi, axis=-2)
    ir = jnp.sum(m * ai * br, axis=-2)
    m0 = jnp.asarray(_lane0_mask(a.shape[-1]))
    re = rr - ii * (1.0 - m0)
    im = (ri + ir) * (1.0 - m0) + ii * m0
    return jnp.stack([re, im], axis=-2)
