"""Stateful wrapper for the two-stage convolver — the ``Convolution``
implementation of ``TwoStageFFTConvolver`` (``src/fft_convolver.rs:339-512``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .models import two_stage, uniform


@functools.lru_cache(maxsize=None)
def _jit_block(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.process_block, cfg))


@functools.lru_cache(maxsize=None)
def _jit_partial(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.process_partial, cfg))


@functools.lru_cache(maxsize=None)
def _jit_stream(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.process_stream, cfg))


@functools.lru_cache(maxsize=None)
def _jit_stream_aligned(cfg: two_stage.TwoStageConfig, assume_clean: bool = False):
    return jax.jit(functools.partial(two_stage.process_stream_aligned, cfg,
                                     assume_clean_small=assume_clean))


@functools.lru_cache(maxsize=None)
def _jit_stream_khats(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.stream_khats, cfg),
                   static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def _jit_stream_aligned_chrono(cfg: two_stage.TwoStageConfig,
                               assume_clean: bool = False):
    # the (hist, pos) pair is donated so the per-call T-row history write
    # is in place — an undonated [h_cap, 2, tb] buffer would copy whole
    # per call, re-paying the glue the CHRONO convention removes
    return jax.jit(functools.partial(two_stage.process_stream_aligned, cfg,
                                     assume_clean_small=assume_clean),
                   donate_argnames=("tail_chrono",))


@functools.lru_cache(maxsize=None)
def _jit_tail_to_chrono(cfg: two_stage.TwoStageConfig, h_cap: int):
    return jax.jit(functools.partial(two_stage.tail_to_chrono, cfg,
                                     h_cap=h_cap))


@functools.lru_cache(maxsize=None)
def _jit_tail_from_chrono(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.tail_from_chrono, cfg))


@functools.lru_cache(maxsize=None)
def _jit_tail_compact(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.tail_chrono_compact, cfg),
                   donate_argnames=("tail_chrono",))


@functools.lru_cache(maxsize=None)
def _jit_reset(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.reset, cfg))


@functools.lru_cache(maxsize=None)
def _jit_update_ext(cfg: two_stage.TwoStageConfig):
    return jax.jit(functools.partial(two_stage.update, cfg))


class TwoStageFFTConvolver:
    """Non-uniform (head/tail) partitioned convolution engine.

    The reference restricts ``process`` to ``input.len() <= head_block_size``
    (assert at ``src/fft_convolver.rs:414``).  This wrapper accepts that
    surface and, as a documented extension, also accepts longer block-aligned
    streams (processed head-block by head-block through the scanned fast
    path) — the natural device streaming call.
    """

    def __init__(self, response, block_size: int, max_response_length: int):
        if block_size & (block_size - 1) or block_size == 0:
            # The jitted schedule indexes period buffers at head-block
            # granularity; non-pow2 heads would need the reference's
            # sample-level re-chunking. Explicit > silently wrong.
            raise ValueError("TwoStageFFTConvolver requires a power-of-two block_size")
        self.cfg, self.state = two_stage.init(response, block_size, max_response_length)
        self._fill = 0         # host shadow of tail_input_fill % head_block
        self._period_fill = 0  # host shadow of tail_input_fill (period position)
        # head/tail0 stream-MAC kernel meta-spectra
        # (models.two_stage.stream_khats), cached per aligned-stream
        # (T, want_tail): input-independent between IR updates
        self._khat_cache = {}
        # CHRONO sliding-window big tail (VERDICT r4 #1): aligned stream
        # calls keep the tail history chronological — the glue-free conv
        # core serves every call length.  (hist, pos) rides beside
        # self.state while active; _tail_pos is the host shadow that
        # routes compaction; _tail_full gates entry (after an update that
        # SHRINKS the tail's active count, the reference semantics scramble
        # the ring history mod the new count — only the ring paths
        # reproduce that, so chrono stays off until a full-length update).
        self._tail_chrono = None
        self._tail_pos = 0
        self._tail_full = self.cfg.tail is not None
        # host shadow of the aligned path's full-clean-ring guard on the
        # fused small streams: init pads the IR to every stage's capacity,
        # so BOTH small stages are fully active from the start and stay so
        # until an update shrinks them — statically known, so the safety
        # cond (and its compiled fallback subtree, a fusion barrier on the
        # op-count-bound short call) is elided at trace time when True
        self._small_full = (self.cfg.tail0 is not None
                            and self.cfg.head == self.cfg.tail0)
        self._chrono_h_cap = (
            uniform.chrono_capacity(self.cfg.tail)
            if self.cfg.tail is not None and self.cfg.tail.seg_count > 1
            else 0
        )

    def update(self, response) -> None:
        """``todo!()`` in the reference (``src/fft_convolver.rs:408-410``) —
        surface matched.  Use :class:`CrossfadeConvolver` for live IR swaps."""
        raise NotImplementedError(
            "TwoStageFFTConvolver.update is unimplemented upstream "
            "(src/fft_convolver.rs:408-410); wrap in CrossfadeConvolver "
            "for artifact-free IR switching"
        )

    def update_extension(self, response) -> None:
        """EXTENSION (clearly marked — NOT reference surface): RT-safe IR
        swap for the two-stage engine, stage-wise semantics documented at
        :func:`models.two_stage.update`.  For reference-faithful live IR
        switching use :class:`CrossfadeConvolver`."""
        response = np.asarray(response, np.float32)
        # capacity is the init max_response_length, reconstructed from the
        # stage IR caps (src/fft_convolver.rs:352-384)
        cap = self.cfg.head.ir_len
        if self.cfg.tail0 is not None:
            cap = self.cfg.tail_block + self.cfg.tail0.ir_len
        if self.cfg.tail is not None:
            cap = 2 * self.cfg.tail_block + self.cfg.tail.ir_len
        if response.shape[0] > cap:
            raise ValueError("New impulse response is longer than initialized length")
        padded = np.zeros(cap, np.float32)
        padded[: response.shape[0]] = response
        self._exit_chrono()
        self.state = _jit_update_ext(self.cfg)(
            self.state, jnp.asarray(padded),
            jnp.asarray(response.shape[0], jnp.int32),
        )
        # cached khats belong to the OLD stage tables
        self._khat_cache.clear()
        # chrono re-entry requires a FULL tail ring (active == seg_count);
        # a shorter IR shrinks the tail's active count and the sequential
        # ring semantics (history scrambled mod the new count) take over
        if self.cfg.tail is not None:
            t_len = max(response.shape[0] - 2 * self.cfg.tail_block, 0)
            active = -(-t_len // self.cfg.tail_block)
            self._tail_full = active == self.cfg.tail.seg_count
        # the fused-small-streams clean shadow: a shorter IR shrinks the
        # small stages' active counts (uniform.update re-derives them from
        # new_len) and the runtime-guarded program takes over
        if self.cfg.tail0 is not None and self.cfg.head == self.cfg.tail0:
            b = self.cfg.head_block
            n_len = response.shape[0]
            h_act = -(-min(n_len, self.cfg.head.ir_len) // b)
            t0_len = min(max(n_len - self.cfg.tail_block, 0),
                         self.cfg.tail0.ir_len)
            t0_act = -(-t0_len // b)
            self._small_full = (h_act == self.cfg.head.seg_count
                                and t0_act == self.cfg.tail0.seg_count)

    def _exit_chrono(self) -> None:
        """Convert the big tail back to the standard ring before any
        sequential/ring-path consumer (scan, partial, update, reset,
        snapshot, clone) touches the state."""
        if self._tail_chrono is not None:
            self.state = _jit_tail_from_chrono(self.cfg)(
                self.state, self._tail_chrono
            )
            self._tail_chrono = None
            self._tail_pos = 0

    def reset(self) -> None:
        self._exit_chrono()
        self.state = _jit_reset(self.cfg)(self.state)
        self._fill = 0
        self._period_fill = 0

    def process(self, input) -> np.ndarray:
        x = np.asarray(input, np.float32)
        n = x.shape[0]
        b = self.cfg.head_block
        tb = self.cfg.tail_block
        if n == 0:
            return np.zeros((0,), np.float32)
        if self._fill == 0 and n % b == 0:
            # split at period boundaries so the bulk of any long stream runs
            # on the aligned batched path; ragged period edges use the scan
            pre = 0 if self._period_fill == 0 else min(n, tb - self._period_fill)
            aligned = ((n - pre) // tb) * tb
            pieces = []
            for lo, hi, aligned_piece in (
                (0, pre, False),
                (pre, pre + aligned, True),
                (pre + aligned, n, False),
            ):
                if hi > lo:
                    if not aligned_piece:
                        self._exit_chrono()
                        self.state, y = _jit_stream(self.cfg)(
                            self.state, jnp.reshape(x[lo:hi], (-1, b))
                        )
                    else:
                        y = self._process_aligned(x[lo:hi])
                    pieces.append(np.asarray(y).reshape(-1))
            self._period_fill = (self._period_fill + n) % tb
            return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
        return self._process_chunked(x)

    def _process_aligned(self, x: np.ndarray):
        """Period-aligned fast path: CHRONO sliding-window big tail when
        eligible (full tail ring, call fits the history buffer), the
        guarded ring path otherwise.  Both serve the cached
        input-independent kernel meta-DFTs (keyed per (T, want_tail): head
        and tail0 may round to different meta lengths, and a T key can
        never serve a mismatched pair)."""
        b = self.cfg.head_block
        t = x.shape[0] // b
        q = t // self.cfg.period
        h_cap = self._chrono_h_cap
        use_chrono = (
            h_cap > 0 and self._tail_full
            and uniform.chrono_fits(self.cfg.tail, h_cap,
                                    self.cfg.tail.seg_count - 1, q)
        )
        khat_key = (t, use_chrono)
        khats = self._khat_cache.get(khat_key)
        if khats is None:
            # want_tail: force the tail khat on for chrono (it serves every
            # call length); leave the ring path on the measured policy
            khats = _jit_stream_khats(self.cfg)(
                self.state, t, True if use_chrono else None
            )
            self._khat_cache[khat_key] = khats
        if not use_chrono:
            self._exit_chrono()
            self.state, y = _jit_stream_aligned(self.cfg, self._small_full)(
                self.state, jnp.reshape(x, (-1, b)), khats=khats
            )
            return y
        n_t = self.cfg.tail.seg_count
        if self._tail_chrono is None:
            self.state, self._tail_chrono = _jit_tail_to_chrono(
                self.cfg, h_cap
            )(self.state)
            self._tail_pos = n_t - 1
        elif not uniform.chrono_fits(self.cfg.tail, h_cap,
                                     self._tail_pos, q):
            self._tail_chrono = _jit_tail_compact(self.cfg)(self._tail_chrono)
            self._tail_pos = n_t - 1
        self.state, self._tail_chrono, y = _jit_stream_aligned_chrono(
            self.cfg, self._small_full
        )(self.state, jnp.reshape(x, (-1, b)), khats=khats,
          tail_chrono=self._tail_chrono)
        self._tail_pos += q
        return y

    def _process_chunked(self, x: np.ndarray) -> np.ndarray:
        self._exit_chrono()
        b = self.cfg.head_block
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
            self._period_fill = (self._period_fill + processing) % self.cfg.tail_block
            processed += processing
        return out

    def snapshot(self):
        # normalized to the standard ring convention: snapshots outlive the
        # session, and the live chrono hist buffer is DONATED by the next
        # process call (a chrono-mode snapshot would alias freed memory)
        self._exit_chrono()
        return (self.state, self._fill, self._period_fill, self._tail_full,
                self._small_full)

    def restore(self, snap) -> None:
        self._tail_chrono = None
        self._tail_pos = 0
        if len(snap) == 4:
            # older snapshot without the clean shadow: recompute it from
            # the snapshot's own ring scalars (cold path, 3 scalar fetches)
            st = snap[0]
            full = self.cfg.tail0 is not None and self.cfg.head == self.cfg.tail0
            if full:
                n_h = self.cfg.head.seg_count
                full = (int(st.head.active_segs) == n_h
                        and int(st.tail0.active_segs) == n_h
                        and int(st.head.current) == int(st.tail0.current)
                        and int(st.head.current) < n_h)
            snap = (*snap, full)
        (self.state, self._fill, self._period_fill, self._tail_full,
         self._small_full) = snap
        # the snapshot may carry different stage tables than the cached khats
        self._khat_cache.clear()

    def clone(self) -> "TwoStageFFTConvolver":
        # ring-normalize first: a shared chrono hist would be donated by
        # whichever clone processes next, corrupting the other
        self._exit_chrono()
        other = object.__new__(TwoStageFFTConvolver)
        other.cfg = self.cfg
        other.state = self.state
        other._fill = self._fill
        other._period_fill = self._period_fill
        other._tail_chrono = None
        other._tail_pos = 0
        other._tail_full = self._tail_full
        other._small_full = self._small_full
        other._chrono_h_cap = self._chrono_h_cap
        # own cache: an update on either must not leave the other reading
        # khats of the wrong tables
        other._khat_cache = dict(self._khat_cache)
        return other
