"""Spectral multiply-accumulate over the frequency-delay line.

The hot op of the framework — counterpart of ``complex_multiply_accumulate``
looped over partitions (``src/fft_convolver.rs:62-74,244-261``).  The
reference walks the ring partition-by-partition on the CPU; here the entire
reduction is one masked gather + packed product + sum that XLA fuses into a
single pass over the ``[seg_count, 2, B]`` spectra.  It is the semantic
reference used by the sequential engine cores.
"""

from __future__ import annotations

import jax.numpy as jnp

from .cpx import pmul_sum


def fdl_mac(
    segments: jnp.ndarray,      # f32 [seg_count, 2, B] input-block spectra ring
    segments_ir: jnp.ndarray,   # f32 [seg_count, 2, B] IR partition spectra
    current: jnp.ndarray,       # i32 [] ring head (reference `current`)
    active: jnp.ndarray,        # i32 [] active partition count
) -> jnp.ndarray:
    """``pre_multiplied`` reduction over partitions 1..active-1.

    Reproduces the ring-indexed loop at ``src/fft_convolver.rs:244-255``:
    ``pre += segments_ir[i] * segments[(current + i) % active]`` for
    ``i in 1..active``.  ``active`` may be traced (it changes on ``update``);
    indices are masked rather than branched so shapes stay static.
    """
    seg_count = segments.shape[0]
    idx = jnp.arange(seg_count, dtype=jnp.int32)
    active_safe = jnp.maximum(active, 1)
    audio_idx = (current + idx) % active_safe
    gathered = jnp.take(segments, audio_idx, axis=0)
    mask = (idx >= 1) & (idx < active)
    return pmul_sum(segments_ir, gathered, mask)

