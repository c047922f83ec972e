"""Crossfade convolver — artifact-free impulse-response switching.

Stateful wrapper re-designing ``CrossfadeConvolver<T>``
(``src/crossfade_convolver.rs:3-105``): TWO instances of any wrapped
``Convolution`` engine run every block (2x compute) and a sample-accurate
equal-power crossfader mixes between them; ``update`` re-inits the inactive
engine and fades into it, with a single pending-response slot if an update
arrives mid-fade (``:51-64``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .models import crossfade, uniform


@functools.lru_cache(maxsize=None)
def _jit_mix(cfg: crossfade.CrossfaderConfig, length: int):
    del length  # shape captured by the traced arrays; key keeps cache tidy
    return jax.jit(functools.partial(crossfade.mix_block, cfg))


@functools.lru_cache(maxsize=None)
def _jit_fused_stream(ucfg: uniform.UniformConfig,
                      cf_cfg: crossfade.CrossfaderConfig):
    """Both engines + the sample-accurate mixer in ONE device program.

    The naive wrapper costs 3+ host<->device round trips per block (engine A,
    engine B, mix); fused, a whole block-aligned stream is one dispatch: the
    two engines run as a 2-voice farm (``src/crossfade_convolver.rs:72-73``
    — both convolvers process every block) and the crossfader's closed-form
    block mix runs on-device.
    """
    @jax.jit
    def run(sa, sb, cf, blocks, kha=None, khb=None):
        # the two streams run with the SAME shapes as standalone engines so
        # XLA lowers them identically — outputs stay within the reference's
        # 1e-6 engine-equivalence contract (a vmapped 2-voice formulation
        # changes matmul shapes and drifts to ~1e-5).  kha/khb: each
        # engine's cached kernel meta-DFT (api.FFTConvolver._get_khat).
        sa2, ya = uniform.process_stream(ucfg, sa, blocks, kern_hat=kha)
        sb2, yb = uniform.process_stream(ucfg, sb, blocks, kern_hat=khb)
        cf2, y = crossfade.mix_block(cf_cfg, cf, ya.reshape(-1), yb.reshape(-1))
        return sa2, sb2, cf2, y

    return run


class CrossfadeConvolver:
    """Generic over the wrapped engine (``CrossfadeConvolver<Convolver>``):
    any object with the ``Convolution`` protocol plus ``clone()`` works —
    :class:`~fft_convolution_tpu.api.FFTConvolver` or
    :class:`~fft_convolution_tpu.api_two_stage.TwoStageFFTConvolver`
    (whose ``update`` raises, exactly as the generic would panic upstream).
    """

    def __init__(self, convolver, max_response_length: int,
                 max_buffer_size: int, crossfade_samples: int):
        """``CrossfadeConvolver::new`` (``src/crossfade_convolver.rs:20-43``):
        hold_samples = min(max_buffer_size, max_response_length)."""
        self.convolver_a = convolver.clone()
        self.convolver_b = convolver
        self.cf_cfg = crossfade.CrossfaderConfig(
            fading_samples=crossfade_samples,
            hold_samples=min(max_buffer_size, max_response_length),
        )
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response = np.zeros(max_response_length, np.float32)
        self.response_pending = False

    @classmethod
    def init(cls, engine_cls, response, max_block_size: int,
             max_response_length: int) -> "CrossfadeConvolver":
        """``Convolution::init`` impl (``src/crossfade_convolver.rs:46-49``):
        note the upstream quirk that crossfade_samples and the stored-response
        capacity are ``response.len()``, not ``max_response_length``."""
        convolver = engine_cls(response, max_block_size, max_response_length)
        n = int(np.asarray(response).shape[0])
        return cls(convolver, n, max_block_size, n)

    @property
    def cfg(self):
        """The wrapped engines' static config (both engines share it) —
        what block-driven hosts such as ``RealTimeDispatcher`` read."""
        return self.convolver_a.cfg

    def is_crossfading(self) -> bool:
        """(``src/crossfade_convolver.rs:85-92``)"""
        return bool(self.cf_state.approaching)

    def _swap(self, response) -> None:
        """``swap`` (``src/crossfade_convolver.rs:94-105``): update the
        INACTIVE engine, fade toward it."""
        if int(self.cf_state.target) == crossfade.TARGET_A:
            self.convolver_b.update(response)
            self.cf_state = crossfade.fade_into(
                self.cf_cfg, self.cf_state, crossfade.TARGET_B
            )
        else:
            self.convolver_a.update(response)
            self.cf_state = crossfade.fade_into(
                self.cf_cfg, self.cf_state, crossfade.TARGET_A
            )

    def update(self, response) -> None:
        """(``src/crossfade_convolver.rs:51-64``) — single pending slot;
        updates while fading overwrite the stored response."""
        if not self.is_crossfading():
            self._swap(response)
            self.response_pending = False
            return
        response = np.asarray(response, np.float32)
        if response.shape[0] > self.stored_response.shape[0]:
            raise ValueError("response longer than stored-response capacity")
        self.stored_response[: response.shape[0]] = response
        self.stored_response[response.shape[0]:] = 0.0
        self.response_pending = True

    def _can_fuse(self, n: int) -> bool:
        from .api import FFTConvolver

        return (
            type(self.convolver_a) is FFTConvolver
            and type(self.convolver_b) is FFTConvolver
            and self.convolver_a.cfg == self.convolver_b.cfg
            and self.convolver_a._fill == 0
            and self.convolver_b._fill == 0
            and n > 0
            and n % self.convolver_a.cfg.block_size == 0
        )

    def process(self, input) -> np.ndarray:
        """(``src/crossfade_convolver.rs:66-78``): apply a pending swap at
        block top, run BOTH engines, mix per-sample.

        Block-aligned uniform-engine streams take the fused single-dispatch
        path (both engines + mixer in one program)."""
        if not self.is_crossfading() and self.response_pending:
            self._swap(self.stored_response)
            self.response_pending = False
        x = np.asarray(input, np.float32)
        if self._can_fuse(x.shape[0]):
            ucfg = self.convolver_a.cfg
            blocks = jnp.reshape(jnp.asarray(x), (-1, ucfg.block_size))
            t = blocks.shape[0]
            sa, sb, self.cf_state, y = _jit_fused_stream(ucfg, self.cf_cfg)(
                self.convolver_a.state, self.convolver_b.state,
                self.cf_state, blocks,
                kha=self.convolver_a._get_khat(t),
                khb=self.convolver_b._get_khat(t),
            )
            self.convolver_a.state = sa
            self.convolver_b.state = sb
            return np.asarray(y)
        buffer_a = self.convolver_a.process(x)
        buffer_b = self.convolver_b.process(x)
        self.cf_state, y = _jit_mix(self.cf_cfg, x.shape[0])(
            self.cf_state, buffer_a, buffer_b
        )
        return np.asarray(y)

    def reset(self) -> None:
        """``todo!()`` upstream (``src/crossfade_convolver.rs:80-82``) —
        surface matched.  See :meth:`reset_extension`."""
        raise NotImplementedError(
            "CrossfadeConvolver.reset is unimplemented upstream "
            "(src/crossfade_convolver.rs:80-82); reset_extension() is the "
            "documented extension"
        )

    def reset_extension(self) -> None:
        """EXTENSION (clearly marked — NOT reference surface): reset both
        engines, return the crossfader to Reached(A), drop any pending
        response."""
        self.convolver_a.reset()
        self.convolver_b.reset()
        self.cf_state = crossfade.new_state(self.cf_cfg)
        self.stored_response[:] = 0.0
        self.response_pending = False

    def snapshot(self):
        return (
            self.convolver_a.snapshot(),
            self.convolver_b.snapshot(),
            self.cf_state,
            self.stored_response.copy(),
            self.response_pending,
        )

    def restore(self, snap) -> None:
        a, b, cf, stored, pending = snap
        self.convolver_a.restore(a)
        self.convolver_b.restore(b)
        self.cf_state = cf
        self.stored_response = stored.copy()
        self.response_pending = pending

    def clone(self) -> "CrossfadeConvolver":
        """Value-copy of the whole wrapper (the reference derives ``Clone``,
        ``src/crossfade_convolver.rs:10``)."""
        other = object.__new__(CrossfadeConvolver)
        other.convolver_a = self.convolver_a.clone()
        other.convolver_b = self.convolver_b.clone()
        other.cf_cfg = self.cf_cfg
        other.cf_state = self.cf_state
        other.stored_response = self.stored_response.copy()
        other.response_pending = self.response_pending
        return other
