"""Public stateful API — the JAX counterpart of the reference's
``Convolution`` trait (``src/lib.rs:5-14``).

The contract is identical:

* ``init(response, max_block_size, max_response_length)`` — constructor;
* ``update(response)`` — real-time-safe IR swap.  In the reference this means
  "no heap allocations" (``src/lib.rs:8``); here it means the update is a
  jitted fixed-shape program compiled once at ``init`` time — no tracing,
  no compilation, no host-side allocation on the hot path;
* ``reset()`` — clear input-side state;
* ``process(input) -> output`` — accepts arbitrary input lengths, chunked
  against the internal block buffer exactly like the reference while-loop
  (``src/fft_convolver.rs:222-294``).

Engines are thin host wrappers around the pure functional cores in
``models/``; all array state lives on the device as a pytree, so cloning
(``Clone`` in the reference) is ``snapshot()``/``restore()`` and a full
engine checkpoint is just the pytree.
"""

from __future__ import annotations

import functools
from typing import Protocol, runtime_checkable

import jax
import jax.numpy as jnp
import numpy as np

from .models import uniform


@runtime_checkable
class Convolution(Protocol):
    """Python protocol mirroring ``trait Convolution`` (``src/lib.rs:5-14``)."""

    def update(self, response) -> None: ...
    def reset(self) -> None: ...
    def process(self, input) -> np.ndarray: ...


# ---------------------------------------------------------------------------
# jit caches — one compiled program per static engine config
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_block(cfg: uniform.UniformConfig):
    return jax.jit(functools.partial(uniform.process_block, cfg))


@functools.lru_cache(maxsize=None)
def _jit_partial(cfg: uniform.UniformConfig):
    return jax.jit(functools.partial(uniform.process_partial, cfg))


@functools.lru_cache(maxsize=None)
def _jit_stream(cfg: uniform.UniformConfig):
    return jax.jit(functools.partial(uniform.process_stream, cfg))


@functools.lru_cache(maxsize=None)
def _jit_stream_khat(cfg: uniform.UniformConfig):
    return jax.jit(functools.partial(uniform.stream_khat, cfg),
                   static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _jit_update(cfg: uniform.UniformConfig):
    return jax.jit(functools.partial(uniform.update, cfg))


@functools.lru_cache(maxsize=None)
def _jit_reset(cfg: uniform.UniformConfig):
    del cfg  # reset is config-independent but cached per-config for locality
    return jax.jit(uniform.reset)


class FFTConvolver:
    """Uniform partitioned convolution engine — stateful wrapper over
    ``models.uniform`` with the exact ``FFTConvolver`` contract
    (``src/fft_convolver.rs:86-307``)."""

    def __init__(self, response, block_size: int, max_response_length: int):
        response = np.asarray(response, np.float32)
        if max_response_length < response.shape[0]:
            raise ValueError(
                "max_response_length must be at least the length of the "
                "initial impulse response"
            )
        self.cfg = uniform.make_config(block_size, max_response_length)
        # init == update on a zero state, through the SAME compiled program
        # later update() calls use, so init-time and update-time IR spectra
        # are bit-identical (the reference shares one code path,
        # src/fft_convolver.rs:131-142 vs :193-207)
        padded = np.zeros(self.cfg.seg_count * self.cfg.block_size, np.float32)
        padded[: response.shape[0]] = response
        self.state = _jit_update(self.cfg)(
            uniform.zero_state(self.cfg),
            jnp.asarray(padded),
            jnp.asarray(self.cfg.ir_len, jnp.int32),
        )
        # host shadow of input_fill: drives the chunking loop without a
        # device sync per call (kept in lockstep with state.input_fill)
        self._fill = 0
        # stream-MAC kernel meta-spectra (models.uniform.stream_khat),
        # cached per meta-DFT length m: input-independent between IR
        # updates, one third of the stream MAC's matmul work per call
        self._khat_cache = {}

    # -- trait methods ------------------------------------------------------

    def update(self, response) -> None:
        """RT-safe IR swap (``src/fft_convolver.rs:174-213``)."""
        response = np.asarray(response, np.float32)
        new_len = response.shape[0]
        if new_len > self.cfg.ir_len:
            raise ValueError("New impulse response is longer than initialized length")
        if self.cfg.ir_len == 0:
            return
        padded = np.zeros(self.cfg.seg_count * self.cfg.block_size, np.float32)
        padded[:new_len] = response
        self.state = _jit_update(self.cfg)(
            self.state, jnp.asarray(padded), jnp.asarray(new_len, jnp.int32)
        )
        # cached khat belongs to the OLD table/mask
        self._khat_cache.clear()

    def reset(self) -> None:
        self.state = _jit_reset(self.cfg)(self.state)
        self._fill = 0

    def process(self, input) -> np.ndarray:
        """Arbitrary-length processing (``src/fft_convolver.rs:215-295``).

        Block-aligned streams take the scanned fast path (one device program
        for all blocks); other sizes run the sub-block chunking loop.
        """
        x = np.asarray(input, np.float32)
        n = x.shape[0]
        b = self.cfg.block_size
        if n == 0:
            return np.zeros((0,), np.float32)
        if self._fill == 0 and n % b == 0:
            self.state, y = _jit_stream(self.cfg)(
                self.state, jnp.reshape(x, (-1, b)),
                kern_hat=self._get_khat(n // b),
            )
            return np.asarray(y).reshape(-1)
        return self._process_chunked(x)

    def _get_khat(self, t: int):
        """Cached input-independent stream-MAC kernel meta-spectra for a
        ``t``-block stream (``models.uniform.stream_khat``), or ``None``
        when the stream routes around the conv fast path.  Coherence:
        ``update``/``restore`` clear the cache; clones get their own."""
        b = self.cfg.block_size
        if not (b <= 2048 and t >= 8):  # the conv fast path's static gate
            return None
        from .ops.fft import next_power_of_two

        m = (next_power_of_two(self.cfg.seg_count - 1 + t)
             if self.cfg.seg_count > 1 else next_power_of_two(t))
        kh = self._khat_cache.get(m)
        if kh is None:
            kh = _jit_stream_khat(self.cfg)(self.state, t)
            self._khat_cache[m] = kh
        return kh

    def _process_chunked(self, x: np.ndarray) -> np.ndarray:
        b = self.cfg.block_size
        n = x.shape[0]
        out = np.empty(n, np.float32)
        partial = _jit_partial(self.cfg)
        processed = 0
        while processed < n:
            processing = min(n - processed, b - self._fill)
            chunk = np.zeros(b, np.float32)
            chunk[:processing] = x[processed : processed + processing]
            offset = self._fill
            self.state, y_full = partial(
                self.state, jnp.asarray(chunk), jnp.asarray(processing, jnp.int32)
            )
            out[processed : processed + processing] = np.asarray(y_full)[
                offset : offset + processing
            ]
            self._fill = (self._fill + processing) % b
            processed += processing
        return out

    # -- state management (the reference's `Clone`, `src/lib.rs:5`) ---------

    def snapshot(self):
        """Engine state as a pytree — checkpoint/resume is a plain value copy."""
        return (self.state, self._fill)

    def restore(self, snap) -> None:
        self.state, self._fill = snap
        # the snapshot may carry a different IR table than the cached khat
        self._khat_cache.clear()

    def clone(self) -> "FFTConvolver":
        other = object.__new__(FFTConvolver)
        other.cfg = self.cfg
        other.state = self.state  # immutable pytree: sharing is safe
        other._fill = self._fill
        # own cache: an update() on either must not leave the other
        # reading khat of the wrong table
        other._khat_cache = dict(self._khat_cache)
        return other
