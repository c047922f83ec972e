"""Plane-packed bf16 complex storage: one uint32 word per spectral bin.

The farm's bf16 tail option (``ReverbFarm(tail_dtype=jnp.bfloat16)``)
halves the device-memory traffic of the tail MAC (pure bandwidth,
``src/fft_convolver.rs:62-74`` batched over voices).  Its storage packs
the two bf16 halves of one complex bin into a single 32-bit word:

    word = (bits(re_bf16) << 16) | bits(im_bf16)

* storage stays 32-bit wide, so the packed arrays keep the f32 path's
  shapes minus the plane axis;
* unpacking is two elementwise integer ops: ``word & 0xFFFF0000``
  reinterpreted as f32 IS the exact f32 value of ``re`` (bf16 -> f32 is
  "append 16 zero bits"), and ``word << 16`` likewise gives ``im``;
* numerics are bit-identical to separate-plane bf16 storage (same
  round-to-nearest-even on store, exact upcast on load).

Arrays drop the leading plane axis: a separate-plane ``[2, rows, L]``
f32/bf16 array becomes a ``[rows, L]`` uint32 array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pack_c32(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Round ``re``/``im`` (f32, same shape) to bf16 and pack into one
    uint32 word each: ``(bits(re) << 16) | bits(im)``."""
    rb = jax.lax.bitcast_convert_type(
        re.astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    ib = jax.lax.bitcast_convert_type(
        im.astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    return (rb << 16) | ib


def pack_c32_planes(a: jnp.ndarray) -> jnp.ndarray:
    """Pack a planes-leading ``[2, ...]`` f32 array to ``[...]`` uint32."""
    return pack_c32(a[0], a[1])


def unpack_c32(w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact f32 (re, im) from packed words — two elementwise int ops and
    free bitcasts per operand (bf16 -> f32 is zero-extension)."""
    re = jax.lax.bitcast_convert_type(w & jnp.uint32(0xFFFF0000),
                                      jnp.float32)
    im = jax.lax.bitcast_convert_type(w << 16, jnp.float32)
    return re, im
