"""Uniform partitioned FFT convolution (frequency-delay line, overlap-add).

JAX re-design of the reference ``FFTConvolver``
(``src/fft_convolver.rs:86-307``).  The Rust engine mutates ring buffers in
place; here the engine is a pure state-transition function

    ``state, y = process_block(config, state, x)``

with the state as a pytree (so it scans, vmaps, shards, and checkpoints for
free) and all shapes static under ``jit``.  Semantics are bit-faithful to the
reference, including the subtle ones:

* ``init`` pads the IR to ``max_response_length`` so trailing all-zero
  segments ARE active until the first ``update`` (``src/fft_convolver.rs:111-118``);
* ``block_size`` is rounded up to the next power of two (``:115``),
  FFT size is ``2 * block_size`` (``:116``);
* the ring head ``current`` DECREMENTS and wraps to ``active_seg_count - 1``
  (``:287-291``); ring reads are ``(current + i) % active_seg_count`` (``:248``);
* ``update`` keeps the input history (``segments``, ``current``,
  ``input_buffer``) but zeroes ``overlap``/accumulators and re-FFTs the IR
  into existing storage (``:174-213``) — an RT-safe, allocation-free swap;
* sub-block ``process`` calls re-run the forward FFT of the partially filled
  input buffer so output has zero added latency (``:222-294``);
* ``active_seg_count == 0`` outputs zeros and leaves state untouched (``:216-219``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops.cpx import pmul, pmul_sum
from ..ops.fft import (
    causal_conv_khat,
    causal_conv_time,
    copy_and_pad,
    ir_to_spectra,
    irdft_block,
    next_power_of_two,
    rdft_block,
)
from ..ops.spectral import fdl_mac


@dataclasses.dataclass(frozen=True)
class UniformConfig:
    """Static (trace-time) configuration of a uniform convolver.

    Hashable so it can be a ``jit`` static argument; everything that varies
    at runtime lives in :class:`UniformState`.
    """

    block_size: int          # power of two (reference rounds up, :115)
    seg_count: int           # ceil(ir_len / block_size)               (:117)
    ir_len: int              # max_response_length after padding       (:111-113)

    @property
    def fft_size(self) -> int:
        return 2 * self.block_size

    @property
    def spec_shape(self) -> tuple:
        # packed halfcomplex layout (see ops/fft.py): [2, block_size],
        # Nyquist in im[0] — lane-aligned, no 129-bin padding waste
        return (2, self.block_size)


class UniformState(NamedTuple):
    """Runtime state pytree — the struct fields of ``FFTConvolver``
    (``src/fft_convolver.rs:86-102``) as fixed-shape arrays."""

    segments: jnp.ndarray        # f32 [seg_count, 2, B] input spectra ring (packed)
    segments_ir: jnp.ndarray     # f32 [seg_count, 2, B] IR partition spectra (packed)
    overlap: jnp.ndarray         # f32 [block_size] OLA tail
    input_buffer: jnp.ndarray    # f32 [block_size] sub-block accumulation
    pre_multiplied: jnp.ndarray  # f32 [2, B] spectral accumulator (packed)
    current: jnp.ndarray         # int32 [] ring head
    input_fill: jnp.ndarray      # int32 [] valid samples in input_buffer
    active_segs: jnp.ndarray     # int32 [] active partition count


def make_config(block_size: int, max_response_length: int) -> UniformConfig:
    block = next_power_of_two(block_size)
    ir_len = max_response_length
    seg_count = max(1, math.ceil(ir_len / block)) if ir_len > 0 else 1
    return UniformConfig(block_size=block, seg_count=seg_count, ir_len=ir_len)


def zero_state(cfg: UniformConfig) -> UniformState:
    """All-zero state for ``cfg`` (segments_ir included, active = 0)."""
    return UniformState(
        segments=jnp.zeros((cfg.seg_count,) + cfg.spec_shape, jnp.float32),
        segments_ir=jnp.zeros((cfg.seg_count,) + cfg.spec_shape, jnp.float32),
        overlap=jnp.zeros((cfg.block_size,), jnp.float32),
        input_buffer=jnp.zeros((cfg.block_size,), jnp.float32),
        pre_multiplied=jnp.zeros(cfg.spec_shape, jnp.float32),
        current=jnp.zeros((), jnp.int32),
        input_fill=jnp.zeros((), jnp.int32),
        active_segs=jnp.zeros((), jnp.int32),
    )


def init(
    response: jnp.ndarray, block_size: int, max_response_length: int
) -> Tuple[UniformConfig, UniformState]:
    """``Convolution::init`` (``src/fft_convolver.rs:105-172``).

    Raises ``ValueError`` where the reference panics (``:106-110``).

    Built as ``update`` applied to a zero state so that init-time and
    update-time IR spectra come from the *same* program — the reference
    gets this for free by sharing one code path (``:131-142`` vs
    ``:193-207``); with XLA, eager-vs-jit rounding differences would
    otherwise break the 1e-6 equivalence contract of
    ``fft_convolver_update_is_reset`` (``src/tests.rs:18-59``).
    """
    response = jnp.asarray(response, jnp.float32)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    cfg = make_config(block_size, max_response_length)
    padded = copy_and_pad(response, cfg.seg_count * cfg.block_size)
    # active = ceil(ir_len / B): trailing zero segments are live (:117-118)
    state = update(
        cfg, zero_state(cfg), padded, jnp.asarray(cfg.ir_len, jnp.int32)
    )
    return cfg, state


def empty(block_size: int) -> Tuple[UniformConfig, UniformState]:
    """``FFTConvolver::default()`` — an engine with ``active_seg_count == 0``
    that outputs zeros (used for absent two-stage tail stages,
    ``src/fft_convolver.rs:367,383``)."""
    cfg = make_config(block_size, 0)
    _, state = init(jnp.zeros((0,), jnp.float32), block_size, block_size)
    state = state._replace(active_segs=jnp.zeros((), jnp.int32))
    return cfg, state


def update(cfg: UniformConfig, state: UniformState, response_padded: jnp.ndarray,
           new_len: jnp.ndarray) -> UniformState:
    """RT-safe IR swap (``src/fft_convolver.rs:174-213``), jittable.

    ``response_padded`` must be the new IR zero-padded to ``cfg.ir_len``
    (host wrapper enforces the length-check panic, ``:177-179``);
    ``new_len`` is the actual (traced) response length.

    Keeps input history (``segments``, ``current``, ``input_buffer``,
    ``input_fill``) so past input keeps convolving with the NEW IR;
    discards the one-block OLA tail and accumulators (``:185-188``).
    Zero-padding of ``response_padded`` makes the re-FFT of segments past
    the new active count produce zeros, matching the explicit clear at
    ``:210-212``.
    """
    new_active = jnp.ceil(new_len.astype(jnp.float32) / cfg.block_size).astype(jnp.int32)
    segments_ir = ir_to_spectra(response_padded, cfg.block_size, cfg.seg_count)
    return state._replace(
        segments_ir=segments_ir,
        overlap=jnp.zeros_like(state.overlap),
        pre_multiplied=jnp.zeros_like(state.pre_multiplied),
        active_segs=new_active,
    )


def reset(state: UniformState) -> UniformState:
    """``Convolution::reset`` (``src/fft_convolver.rs:296-307``): clears all
    input-side state, keeps ``segments_ir`` and ``active_segs``."""
    return state._replace(
        segments=jnp.zeros_like(state.segments),
        overlap=jnp.zeros_like(state.overlap),
        input_buffer=jnp.zeros_like(state.input_buffer),
        pre_multiplied=jnp.zeros_like(state.pre_multiplied),
        current=jnp.zeros_like(state.current),
        input_fill=jnp.zeros_like(state.input_fill),
    )


def _engine_step(cfg: UniformConfig, state: UniformState, buffer_spec: jnp.ndarray,
                 recompute_pre: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """Shared spectral core of a (sub-)block: write the forward spectrum into
    the ring, form ``conv = pre_multiplied + segments[current] * ir[0]``, and
    inverse-transform (``src/fft_convolver.rs:234-267``).

    Returns updated state (ring + pre_multiplied) and the full ``2B`` IFFT
    buffer (overlap handling differs between block/sub-block callers).
    """
    segments = jax.lax.dynamic_update_index_in_dim(
        state.segments, buffer_spec, state.current, axis=0
    )
    pre = jax.lax.cond(
        recompute_pre,
        lambda: fdl_mac(segments, state.segments_ir, state.current, state.active_segs),
        lambda: state.pre_multiplied,
    )
    conv = pre + pmul(buffer_spec, state.segments_ir[0])
    fft_buffer = irdft_block(conv, cfg.fft_size)
    return state._replace(segments=segments, pre_multiplied=pre), fft_buffer


def _advance_ring(state: UniformState, fft_buffer: jnp.ndarray) -> UniformState:
    """Block-completion bookkeeping (``src/fft_convolver.rs:278-292``):
    clear the input buffer, save the new overlap, decrement the ring head."""
    b = state.overlap.shape[0]
    current = jnp.where(
        state.current > 0, state.current - 1, state.active_segs - 1
    ).astype(jnp.int32)
    return state._replace(
        input_buffer=jnp.zeros_like(state.input_buffer),
        input_fill=jnp.zeros_like(state.input_fill),
        overlap=fft_buffer[b:],
        current=current,
    )


def process_block(cfg: UniformConfig, state: UniformState,
                  x: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """Process exactly one full block of ``block_size`` samples.

    Fast path of ``process`` (``src/fft_convolver.rs:215-295``) for the
    block-aligned streaming case (``input_buffer`` empty, one full block):
    one iteration of the reference while-loop with
    ``input_buffer_was_empty == true``.
    """

    def inactive() -> Tuple[UniformState, jnp.ndarray]:
        return state, jnp.zeros((cfg.block_size,), jnp.float32)

    def active() -> Tuple[UniformState, jnp.ndarray]:
        spec = rdft_block(x, cfg.fft_size)
        st, fft_buffer = _engine_step(cfg, state, spec, jnp.asarray(True))
        y = fft_buffer[: cfg.block_size] + state.overlap
        return _advance_ring(st, fft_buffer), y

    return jax.lax.cond(state.active_segs == 0, inactive, active)


def process_partial(cfg: UniformConfig, state: UniformState, chunk_padded: jnp.ndarray,
                    length: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """One iteration of the reference sub-block while-loop
    (``src/fft_convolver.rs:222-294``) for arbitrary chunk sizes.

    ``chunk_padded`` is the chunk left-aligned in a ``[block_size]`` buffer;
    ``length`` (traced) is the valid sample count, guaranteed by the host
    chunker to satisfy ``input_fill + length <= block_size``.  Returns the
    full ``block_size`` output lane ``fft_buffer[:B] + overlap``; the caller
    slices ``[input_fill : input_fill+length]`` out of it.
    """
    b = cfg.block_size

    def inactive() -> Tuple[UniformState, jnp.ndarray]:
        return state, jnp.zeros((b,), jnp.float32)

    def active() -> Tuple[UniformState, jnp.ndarray]:
        offset = state.input_fill
        pos = jnp.arange(b, dtype=jnp.int32)
        take = (pos >= offset) & (pos < offset + length)
        shifted = jnp.roll(chunk_padded, offset)
        input_buffer = jnp.where(take, shifted, state.input_buffer)
        spec = rdft_block(input_buffer, cfg.fft_size)
        st = state._replace(input_buffer=input_buffer)
        st, fft_buffer = _engine_step(cfg, st, spec, offset == 0)
        y_full = fft_buffer[:b] + state.overlap
        fill = offset + length
        st = st._replace(input_fill=fill.astype(jnp.int32))
        st = jax.lax.cond(
            fill == b, lambda s: _advance_ring(s, fft_buffer), lambda s: s, st
        )
        return st, y_full

    return jax.lax.cond(state.active_segs == 0, inactive, active)


def process_stream_scan(cfg: UniformConfig, state: UniformState,
                        blocks: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """Plain scan of :func:`process_block` — the semantic reference for
    :func:`process_stream` (kept for cross-checking in tests)."""

    def step(st, x):
        return process_block(cfg, st, x)

    return jax.lax.scan(step, state, blocks)


def _stream_ring_scan(cfg: UniformConfig, state: UniformState,
                      specs: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """Semi-batched stream core: forward/inverse DFTs are hoisted by the
    caller; this scans only the FDL ring recurrence (write one spectrum
    row, masked MAC, emit ``conv[t]``).  Mirrors the sequential ops 1:1,
    including the shrunk-ring transient where ``current >= active_segs``
    writes land in dead slots (``src/fft_convolver.rs:236-291``).

    With a full ring (``active == seg_count``) the per-step partition
    pairing uses a contiguous window of a doubled IR table instead of a row
    gather: stored row j pairs
    ``ir[(j - current) mod N]`` = ``ir2[N - current + j]``.
    """
    n = cfg.seg_count

    def step_gather(carry, spec):
        segments, current, _pre = carry
        segments = jax.lax.dynamic_update_index_in_dim(
            segments, spec, current, axis=0
        )
        pre = fdl_mac(segments, state.segments_ir, current, state.active_segs)
        conv = pre + pmul(spec, state.segments_ir[0])
        current = jnp.where(
            current > 0, current - 1, state.active_segs - 1
        ).astype(jnp.int32)
        return (segments, current, pre), conv

    def run_gather():
        return jax.lax.scan(
            step_gather, (state.segments, state.current, state.pre_multiplied), specs
        )

    (segments, current, pre), convs = jax.lax.cond(
        state.active_segs == n,
        lambda: _ring_scan_sliced(cfg, state, specs),
        run_gather,
    )
    return state._replace(segments=segments, current=current, pre_multiplied=pre), convs


def _ring_scan_sliced(cfg: UniformConfig, state: UniformState, specs: jnp.ndarray):
    """Full-ring scan core (precondition ``active == seg_count``): the
    per-step IR pairing is a doubled-table dynamic slice — no gather, no
    cond (vmap-safe)."""
    n = cfg.seg_count
    ir2 = jnp.concatenate([state.segments_ir, state.segments_ir], axis=0)
    j = jnp.arange(n, dtype=jnp.int32)

    def step(carry, spec):
        segments, current, _pre = carry
        segments = jax.lax.dynamic_update_index_in_dim(
            segments, spec, current, axis=0
        )
        rolled = jax.lax.dynamic_slice(
            ir2, (n - current, 0, 0), (n, 2, cfg.block_size)
        )
        pre = pmul_sum(rolled, segments, j != current)
        conv = pre + pmul(spec, state.segments_ir[0])
        current = jnp.where(current > 0, current - 1, n - 1).astype(jnp.int32)
        return (segments, current, pre), conv

    return jax.lax.scan(
        step, (state.segments, state.current, state.pre_multiplied), specs
    )


def stream_khat(cfg: UniformConfig, state: UniformState, t: int):
    """Precompute the stream MAC's kernel meta-spectra for ``T = t``-block
    calls of :func:`process_stream` — :func:`ops.fft.causal_conv_khat` of
    the ACTIVITY-MASKED IR table (the mask is part of the kernel, so the
    precompute stays valid for engines shrunk by ``update``).

    Input-independent between IR updates; inline it is one of the three
    equal-sized meta-DFT applications of every stream call.  Jittable;
    valid for any ``T`` with the same ``next_power_of_two(N - 1 + T)``
    (checked at trace time by :func:`ops.fft.causal_conv_time`).  Only
    consumed by the conv fast path — the ring-scan fallback and the
    huge-block path ignore it.
    """
    n = cfg.seg_count
    m = next_power_of_two(n - 1 + t) if n > 1 else next_power_of_two(t)
    i = jnp.arange(n, dtype=jnp.int32)
    kern = jnp.where(
        (i < state.active_segs)[:, None, None], state.segments_ir, 0.0
    )
    return causal_conv_khat(kern, m)


def _stream_conv(cfg: UniformConfig, state: UniformState,
                 specs: jnp.ndarray,
                 assume_full_ring: bool = False,
                 kern_hat=None) -> Tuple[UniformState, jnp.ndarray]:
    """Fully parallel stream core: the FDL recurrence
    ``conv[t] = sum_i IR[i] (*) X[t-i]`` is a causal convolution along the
    block axis, computed with a second DFT along that axis
    (``ops.fft.causal_conv_time``) over the extended spectrum sequence
    (ring history ++ new spectra) — zero sequential steps, all matmuls.

    Precondition: ``current < active_segs`` (a clean ring).  The caller
    guards with :func:`_stream_ring_scan` otherwise.
    """
    n = cfg.seg_count
    b = cfg.block_size
    t = specs.shape[0]
    active = state.active_segs
    active_safe = jnp.maximum(active, 1)
    current = state.current

    # chronological history: E[k] holds X[-(N-1-k)] at ring slot
    # (current + delay) % active  [delays >= active are kernel-masked].
    # Instead of an arbitrary row gather: with a FULL ring (active == N,
    # the overwhelmingly common case) the history is one contiguous window
    # of the doubled ring, reversed — a dynamic slice instead of a gather.
    def hist_slice():
        seg2 = jnp.concatenate([state.segments, state.segments], axis=0)
        window = jax.lax.dynamic_slice(
            seg2, (current + 1, 0, 0), (max(n - 1, 1), 2, b)
        )
        return jnp.flip(window, axis=0)[: n - 1]

    def hist_gather():
        k = jnp.arange(n - 1, dtype=jnp.int32)
        return jnp.take(
            state.segments, (current + (n - 1 - k)) % active_safe, axis=0
        )

    if n > 1:
        if assume_full_ring:
            # static fast path (vmap callers: a traced cond would execute
            # BOTH branches per voice) — precondition active == seg_count
            hist = hist_slice()
        else:
            hist = jax.lax.cond(active == n, hist_slice, hist_gather)
        # fold the meta-DFT zero pad into this concat (ext lands at m
        # rows exactly, making causal_conv_time's _pad_rows a no-op
        # instead of a second full-array materialization); the rebuild
        # reads below only touch rows < N-1+T, so the zeros are inert
        m = next_power_of_two(n - 1 + t)
        parts = [hist, specs]
        if m > n - 1 + t:
            parts.append(jnp.zeros((m - (n - 1 + t),) + specs.shape[1:],
                                   specs.dtype))
        ext = jnp.concatenate(parts, axis=0)                # [m, 2, B]
    else:
        ext = specs

    # activity-masked kernel; the MAC over the whole stream runs as a
    # second DFT along the block axis (ops.fft.causal_conv_time) — all
    # matmuls instead of a grouped convolution.
    # The mask materializes a full copy of the IR table (the flagship
    # program's single biggest op by HLO cost estimate), so the common
    # full-ring case skips it behind a scalar cond.  A precomputed
    # ``kern_hat`` (:func:`stream_khat`, already mask-folded) skips BOTH
    # the mask and the kernel-side meta-DFT.
    if kern_hat is not None:
        kern = state.segments_ir  # shape source only — khat replaces its DFT
    elif assume_full_ring:
        kern = state.segments_ir
    else:
        i = jnp.arange(n, dtype=jnp.int32)
        kern = jax.lax.cond(
            active == n,
            lambda: state.segments_ir,
            lambda: jnp.where(
                (i < active)[:, None, None], state.segments_ir, 0.0
            ),
        )
    convs = causal_conv_time(ext, kern, t, kern_hat=kern_hat)  # [T, 2, B]

    # rebuild the ring: current' points at the NEXT write slot; slot at
    # offset d from it holds X[T-d] (d=0 wraps to the oldest, delay=active)
    current_f = jnp.mod(current - t, active_safe).astype(jnp.int32)

    def rebuild_roll():
        # full ring: the delay-ordered window byd[d-1] = ext[N-1+T-d] is a
        # static reversed slice; placing byd[d-1] at slot (current'+d) % N
        # is a roll.  pre_multiplied comes from the identity the sequential
        # engine defines it by (conv = pre + current (*) ir[0],
        # src/fft_convolver.rs:256-261):  pre = conv[T-1] - X[T-1] (*) ir[0]
        # — O(B) instead of the masked MAC's O(N*B) re-read of the whole
        # IR table + window (the corr cores use the same identity)
        byd = jnp.flip(jax.lax.slice_in_dim(ext, t - 1, t - 1 + n, axis=0), axis=0)
        segments = jnp.roll(byd, current_f + 1, axis=0)
        pre = convs[-1] - pmul(specs[-1], state.segments_ir[0])
        return segments, pre

    def rebuild_gather():
        s = jnp.arange(n, dtype=jnp.int32)
        d = jnp.mod(s - current_f, active_safe)
        d_eff = jnp.where(d == 0, active_safe, d)
        gathered = jnp.take(ext, (n - 1) + t - d_eff, axis=0)
        segments = jnp.where(
            (s < active)[:, None, None], gathered, state.segments
        )
        # pre_multiplied must equal the sequential value after the last
        # block — at the PRE-decrement head (src/fft_convolver.rs:244-287)
        pre = fdl_mac(
            segments, state.segments_ir, (current_f + 1) % active_safe, active
        )
        return segments, pre

    if assume_full_ring:
        segments, pre = rebuild_roll()
    else:
        segments, pre = jax.lax.cond(active == n, rebuild_roll, rebuild_gather)
    return state._replace(
        segments=segments, current=current_f, pre_multiplied=pre
    ), convs


def stream_scan_unguarded(cfg: UniformConfig, state: UniformState,
                          blocks: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """Hoisted-DFT ring-scan stream without safety conds (vmap-friendly;
    preferred over the conv core for huge blocks or very short streams).

    Uses the gather step rather than the doubled-IR slice: vmapped farm
    voices would pay 2x IR memory each for the doubled table, and the
    two-stage tails this serves have few segments (gathers stay cheap).
    """
    b = cfg.block_size
    specs = rdft_block(blocks, cfg.fft_size)

    def step(carry, spec):
        segments, current, _pre = carry
        segments = jax.lax.dynamic_update_index_in_dim(
            segments, spec, current, axis=0
        )
        pre = fdl_mac(segments, state.segments_ir, current, state.active_segs)
        conv = pre + pmul(spec, state.segments_ir[0])
        current = jnp.where(
            current > 0, current - 1, state.active_segs - 1
        ).astype(jnp.int32)
        return (segments, current, pre), conv

    (segments, current, pre), convs = jax.lax.scan(
        step, (state.segments, state.current, state.pre_multiplied), specs
    )
    new_state = state._replace(
        segments=segments, current=current, pre_multiplied=pre
    )
    outs = irdft_block(convs, cfg.fft_size)
    tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    return new_state._replace(overlap=outs[-1, b:]), y


def stream_scan_sliced_unguarded(cfg: UniformConfig, state: UniformState,
                                 blocks: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """Hoisted-DFT ring-scan stream on the sliced (doubled-IR) core — no
    gathers, no conds; vmap-safe with lockstep ring heads.  Preconditions:
    full clean ring.  Costs 2x IR memory transiently (the doubled table);
    preferred for farm tails where vmapped gathers are pathological."""
    b = cfg.block_size
    specs = rdft_block(blocks, cfg.fft_size)
    (segments, current, pre), convs = _ring_scan_sliced(cfg, state, specs)
    new_state = state._replace(
        segments=segments, current=current, pre_multiplied=pre
    )
    outs = irdft_block(convs, cfg.fft_size)
    tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    return new_state._replace(overlap=outs[-1, b:]), y


# extra periodic rows on the rebased farm-tail IR table: supports streams of
# up to this many blocks per call (farm periods per stream call)
CORR_EXTRA_ROWS = 16


def stream_corr_rebased_unguarded(cfg: UniformConfig, state: UniformState,
                                  blocks: jnp.ndarray
                                  ) -> Tuple[UniformState, jnp.ndarray]:
    """Few-block stream core with the MAC batched as a CORRELATION — the
    farm big-tail engine (T small, segments huge).

    State convention (farm2-internal, REBASED ring):

    * ``state.current == 0`` at every call boundary — after processing the
      call's T blocks the ring is rolled by T (one static roll) so the next
      call starts rebased;
    * ``state.segments_ir`` is the periodically EXTENDED IR table
      ``[N + CORR_EXTRA_ROWS, 2, B]`` (row ``N + r`` repeats row ``r``).

    With ``cur == 0``, block ``t`` of the call has ``cur_t = (-t) mod N``,
    so its rolled pairing is ``ir[(j + t) mod N] = irext[j + t]`` — a
    STATIC slice of the extended table, and every correction index
    (``slot_s = (N - s) mod N``, ``ir[t - s]``) is a Python constant:

        conv[t] = sum_j old[j] (*) irext[t : t+N][j]
                + sum_{s<=t} (spec[s] - old[slot_s]) (*) irext[t - s]

    No dynamic slices, no gathers, no per-call table build; the ring and
    each window are read once per output block.  The sliced ring scan it
    replaces spent half its HBM traffic rebuilding a doubled table per call
    (measured: farm tail 8.6 -> 7.2 ms at 32 voices x 60 s, and the table
    memory drops from 2N to N + 16 rows).

    Preconditions (farm lockstep): full clean REBASED ring
    (``active == seg_count``, ``current == 0``) and
    ``T <= CORR_EXTRA_ROWS``.  Output-equivalent to the sequential ring
    scan (the internal slot labeling differs by the rebase rotation).
    """
    b = cfg.block_size
    n = cfg.seg_count
    t_blocks = blocks.shape[0]
    assert t_blocks <= min(cfg.seg_count, CORR_EXTRA_ROWS), (
        f"correlation core supports at most min(seg_count, "
        f"{CORR_EXTRA_ROWS}) blocks per call (got {t_blocks}, seg_count "
        f"{cfg.seg_count}): beyond seg_count the call would overwrite a "
        f"ring slot it already wrote, and the static correction indices "
        f"assume delay t - s < seg_count"
    )
    specs = rdft_block(blocks, cfg.fft_size)          # [T, 2, B]
    irext = state.segments_ir                         # [N + E, 2, B]
    old = state.segments
    ones = jnp.ones((n,), jnp.float32)

    convs = []
    for t in range(t_blocks):
        wt = jax.lax.slice_in_dim(irext, t, t + n, axis=0)   # static
        acc = pmul_sum(wt, old, ones)
        for s in range(t + 1):
            slot = (n - s) % n                               # static
            acc = acc + pmul(specs[s] - old[slot], irext[t - s])
        convs.append(acc)
    convs = jnp.stack(convs)

    # write the new spectra at their (pre-rebase) slots, then rebase the
    # ring by T so current stays 0: new[(r + T) mod N] = written[r]
    segments = old
    for s in range(t_blocks):
        slot = (n - s) % n
        segments = segments.at[slot].set(specs[s])
    segments = jnp.roll(segments, t_blocks, axis=0)
    pre = convs[-1] - pmul(specs[-1], irext[0])

    outs = irdft_block(convs, cfg.fft_size)
    tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    return state._replace(
        segments=segments, pre_multiplied=pre,
        overlap=outs[-1, b:],
    ), y


def stream_corr_phased_unguarded(cfg: UniformConfig, state: UniformState,
                                 blocks: jnp.ndarray
                                 ) -> Tuple[UniformState, jnp.ndarray]:
    """Roll-free variant of :func:`stream_corr_rebased_unguarded`: instead
    of rolling the whole ring back to ``current == 0`` after every call (a
    full ring read+write of HBM traffic and two ring-sized temporaries —
    the dominant per-voice memory term in the reverb-farm OOM dump), the
    ring rows stay FIXED and a phase scalar carried in ``state.current``
    moves the IR window instead.

    State convention (farm2-internal, PHASED ring):

    * ``state.current`` holds the phase ``q``, incremented by T per call
      (mod N); ``q == 0`` is bit-identical to the rebased layout;
    * ``state.segments_ir`` is the DOUBLED periodic IR table
      ``[2 * N + CORR_EXTRA_ROWS, 2, B]`` (row ``x`` holds
      ``ir_spec[x mod N]``).

    Derivation (mapping the rebased indices through the accumulated roll):
    with ``U[x] = rebased_old[(x - p) mod N]`` and ``q = (N - p) mod N``,

        conv[t] = sum_x U[x] (*) ext2[q + t : q + t + N][x]
                + sum_{s<=t} (spec[s] - U[row_s]) (*) ext2[t - s],
        row_s   = (N - q - s) mod N            (the slot about to be written)
        U[row_s] <- spec[s];   q' = (q + T) mod N

    The window start ``q + t`` is a lockstep traced scalar (shared across
    vmapped voices — one batched dynamic slice, not a per-voice gather),
    every other index is static, and with donation the T single-row writes
    are in-place: per call the ring is READ T times and written T rows,
    never copied.  Costs ``N - CORR_EXTRA_ROWS`` more IR-table rows than
    the rebased core; saves the roll's full-ring copy (memory) and its
    read+write (time).  Output-equivalent to the rebased core for any
    sequence of calls (phase wraps mod N regardless of ``N % T``).

    Preconditions (farm lockstep): full clean ring and
    ``T <= min(N, CORR_EXTRA_ROWS)``.
    """
    b = cfg.block_size
    n = cfg.seg_count
    t_blocks = blocks.shape[0]
    assert t_blocks <= min(cfg.seg_count, CORR_EXTRA_ROWS), (
        f"correlation core supports at most min(seg_count, "
        f"{CORR_EXTRA_ROWS}) blocks per call (got {t_blocks}, seg_count "
        f"{cfg.seg_count})"
    )
    specs = rdft_block(blocks, cfg.fft_size)          # [T, 2, B]
    ext2 = state.segments_ir                          # [2N + E, 2, B]
    u = state.segments                                # [N, 2, B] (phased)
    q = state.current                                 # phase scalar
    ones = jnp.ones((n,), jnp.float32)

    convs = []
    for t in range(t_blocks):
        wt = jax.lax.dynamic_slice_in_dim(ext2, q + t, n, axis=0)
        acc = pmul_sum(wt, u, ones)
        for s in range(t + 1):
            row_s = jnp.mod(n - q - s, n)
            u_old = jax.lax.dynamic_slice_in_dim(u, row_s, 1, axis=0)[0]
            acc = acc + pmul(specs[s] - u_old, ext2[t - s])
        convs.append(acc)
    convs = jnp.stack(convs)

    for s in range(t_blocks):
        row_s = jnp.mod(n - q - s, n)
        u = jax.lax.dynamic_update_slice_in_dim(u, specs[s][None], row_s, axis=0)
    pre = convs[-1] - pmul(specs[-1], ext2[0])

    outs = irdft_block(convs, cfg.fft_size)
    tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    return state._replace(
        segments=u, pre_multiplied=pre,
        current=jnp.mod(q + t_blocks, n).astype(jnp.int32),
        overlap=outs[-1, b:],
    ), y


def stream_conv_unguarded(cfg: UniformConfig, state: UniformState,
                          blocks: jnp.ndarray) -> Tuple[UniformState, jnp.ndarray]:
    """The conv-HLO stream without the safety conds — preconditions
    ``0 < active_segs`` and ``current < active_segs`` checked by the caller.
    vmap-friendly (no data-dependent cond that vmap would turn into
    execute-both-branches selects): the reverb farm maps this over voices.
    Precondition: full clean ring (``active == seg_count``, ``current <
    active``) — holds for any engine not shrunk by an update.
    """
    b = cfg.block_size
    specs = rdft_block(blocks, cfg.fft_size)
    new_state, convs = _stream_conv(cfg, state, specs, assume_full_ring=True)
    outs = irdft_block(convs, cfg.fft_size)
    tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    return new_state._replace(overlap=outs[-1, b:]), y


def stream_conv_farm(cfg: UniformConfig, state: UniformState,
                     vx: jnp.ndarray,
                     kern_hat=None) -> Tuple[UniformState, jnp.ndarray]:
    """Farm-native conv stream: ``state`` leaves carry a leading voice axis
    V, ``vx`` is ``[V, T, B]``; voices fold into the grouped-conv channel
    axis MANUALLY (``C = V * 2B``) — vmapping a conv with per-voice kernels
    hits a pathological batching rule (~45x slower measured).

    Preconditions (lockstep farm): full clean rings on every voice
    (``active == seg_count``, ``current < active``) and identical ``current``
    across voices (they always process the same number of blocks).
    """
    v, t = vx.shape[0], vx.shape[1]
    n, b = cfg.seg_count, cfg.block_size
    current = state.current[0]
    active_n = jnp.asarray(n, jnp.int32)

    specs = rdft_block(vx, cfg.fft_size)                     # [V, T, 2, B]

    if n > 1:
        seg2 = jnp.concatenate([state.segments, state.segments], axis=1)
        window = jax.lax.dynamic_slice(
            seg2, (0, current + 1, 0, 0), (v, n - 1, 2, b)
        )
        hist = jnp.flip(window, axis=1)
        # fold the meta-DFT zero pad into the concat (see _stream_conv)
        m = next_power_of_two(n - 1 + t)
        parts = [hist, specs]
        if m > n - 1 + t:
            parts.append(jnp.zeros((v, m - (n - 1 + t), 2, b), jnp.float32))
        ext = jnp.concatenate(parts, axis=1)                 # [V, m, 2, B]
    else:
        ext = specs

    # the MAC over the whole stream is a second DFT along the block axis
    # (ops.fft.causal_conv_time) — all matmuls, batched over voices;
    # kern_hat (parallel.farm.farm_khat) hoists the kernel-side meta-DFT
    convs = causal_conv_time(ext, state.segments_ir, t,
                             kern_hat=kern_hat)              # [V, T, 2, B]

    # ring rebuild (shared indices across voices); pre via the sequential
    # identity pre = conv[T-1] - X[T-1] (*) ir[0] — O(B) per voice instead
    # of a whole-IR-table masked MAC (see _stream_conv.rebuild_roll)
    current_f = jnp.mod(current - t, active_n).astype(jnp.int32)
    byd = jnp.flip(jax.lax.slice_in_dim(ext, t - 1, t - 1 + n, axis=1), axis=1)
    segments = jnp.roll(byd, current_f + 1, axis=1)
    pre = convs[:, -1] - pmul(specs[:, -1], state.segments_ir[:, 0])

    outs = irdft_block(convs, cfg.fft_size)                  # [V, T, 2B]
    tails = jnp.concatenate([state.overlap[:, None], outs[:, :-1, b:]], axis=1)
    ys = outs[:, :, :b] + tails
    new_state = state._replace(
        segments=segments,
        current=jnp.broadcast_to(current_f, (v,)),
        pre_multiplied=pre,
        overlap=outs[:, -1, b:],
    )
    return new_state, ys


# ---------------------------------------------------------------------------
# CHRONO sliding-window history (the conv core without its glue)
# ---------------------------------------------------------------------------
#
# The time-DFT conv core on the standard decrementing ring pays, per call,
# a doubled-ring concat + history slice + flip + ext concat on the way IN
# and a delay-ordered flip + roll rebuild on the way OUT — glue around a
# MAC that is nearly flat in call length.  The ring exists to serve the
# SEQUENTIAL schedule; a batched stream only ever needs the last N-1
# spectra OLDEST-FIRST — exactly a chronological buffer.
#
# CHRONO convention: history lives PLANE-SEPARATED in a pair of
# [h_cap, B] buffers `hist = (hist_re, hist_im)`, written left to right;
# `pos` rows are occupied and rows >= pos are ZERO (maintained at
# conversion/compaction), so the m-row window sliced at pos - (N-1) is
# value-identical to the ring path's hist++specs++zeros ext — same DFT
# input, same outputs, no flips, no concats, no roll.  Plane separation is
# load-bearing, not aesthetic: a single [h_cap, 2, B] buffer gets voted
# into a plane-interleaved T(2,128) layout by the spec-write's operand
# inside larger programs, after which extracting each plane for the
# meta-DFT costs a half-wasted read + an 8x-amplified T(1,128) write —
# measured as the single biggest op of the first full-stream chrono
# compile (~235k cycles, the whole glue saving given back).  Same trap
# family as farm2's plane folds.  The ring fields of UniformState are NOT
# used: callers carry (hist, pos) alongside a state whose `segments` is a
# [1, 2, B] placeholder (so no stale multi-MB ring rides through every
# jit call), and convert at the sequential/batched boundary with
# ring_to_chrono / chrono_to_ring.  Invariant: pos >= N - 1 (conversion
# and compaction both establish it).


def chrono_capacity(cfg: UniformConfig, t_hint: int = 0) -> int:
    """Default ``hist`` row capacity: enough slack that compaction (one
    h_cap-row pass) amortizes over many calls, and always >= the meta-DFT
    window ``m = npo2(N - 1 + T)`` of a ``t_hint``-block call."""
    n = cfg.seg_count
    return next_power_of_two(max(4 * n, n - 1 + t_hint, 8))


def chrono_fits(cfg: UniformConfig, h_cap: int, pos: int, t: int) -> bool:
    """Host-side routing predicate (``pos`` is the caller's host shadow):
    True iff a ``t``-block call fits the buffer without compaction."""
    n = cfg.seg_count
    m = next_power_of_two(n - 1 + t) if n > 1 else next_power_of_two(t)
    return pos + t <= h_cap and pos - (n - 1) + m <= h_cap


def ring_to_chrono(cfg: UniformConfig, state: UniformState, h_cap: int
                   ) -> Tuple[UniformState, tuple, jnp.ndarray]:
    """Standard ring -> CHRONO: returns ``(state', hist, pos)`` with the
    ring's last ``N - 1`` spectra placed oldest-first at rows ``[:N-1]`` of
    the plane-separated pair ``hist = (hist_re, hist_im)``, ``pos = N - 1``,
    and ``state'.segments`` a ``[1, 2, B]`` placeholder.

    Precondition (caller owns it): full clean ring (``active == seg_count``,
    ``current < seg_count``).  Cost: one ext-build's worth of copies — paid
    only at the sequential/batched boundary, not per call.
    """
    n, b = cfg.seg_count, cfg.block_size
    hist_re = jnp.zeros((h_cap, b), jnp.float32)
    hist_im = jnp.zeros((h_cap, b), jnp.float32)
    if n > 1:
        seg2 = jnp.concatenate([state.segments, state.segments], axis=0)
        window = jnp.flip(jax.lax.dynamic_slice(
            seg2, (state.current + 1, 0, 0), (n - 1, 2, b)
        ), axis=0)                                  # lags N-1..1 oldest-first
        hist_re = jax.lax.dynamic_update_slice(hist_re, window[:, 0], (0, 0))
        hist_im = jax.lax.dynamic_update_slice(hist_im, window[:, 1], (0, 0))
    pos = jnp.asarray(n - 1, jnp.int32)
    placeholder = jnp.zeros((1, 2, b), jnp.float32)
    return state._replace(
        segments=placeholder, current=jnp.zeros((), jnp.int32)
    ), (hist_re, hist_im), pos


def chrono_to_ring(cfg: UniformConfig, state: UniformState,
                   hist: tuple, pos: jnp.ndarray) -> UniformState:
    """CHRONO -> standard ring, choosing ``current = N - 1``: slot ``d - 1``
    holds lag ``d`` (``ring[(current + d) % N]`` convention), and the
    next-write slot ``N - 1`` — whose content the sequential engine never
    reads before overwriting (``fdl_mac`` skips the head slot) — is zeroed.
    Exactly interoperable with every sequential/ring-path consumer."""
    n, b = cfg.seg_count, cfg.block_size
    hist_re, hist_im = hist
    if n > 1:
        win_re = jax.lax.dynamic_slice(hist_re, (pos - (n - 1), 0), (n - 1, b))
        win_im = jax.lax.dynamic_slice(hist_im, (pos - (n - 1), 0), (n - 1, b))
        window = jnp.stack([win_re, win_im], axis=1)  # oldest-first lags
        ring = jnp.concatenate(
            [jnp.flip(window, axis=0), jnp.zeros((1, 2, b), jnp.float32)],
            axis=0,
        )
    else:
        ring = jnp.zeros((1, 2, b), jnp.float32)
    return state._replace(
        segments=ring, current=jnp.asarray(n - 1, jnp.int32)
    )


def chrono_compact(cfg: UniformConfig, hist: tuple, pos: jnp.ndarray
                   ) -> Tuple[tuple, jnp.ndarray]:
    """Move the live ``N - 1``-row history window back to the buffer start
    and re-zero everything after it (one ``h_cap``-row pass per plane).
    The caller routes here off its HOST shadow of ``pos`` when the next
    call would overrun — keeping the hot path free of in-jit conds whose
    both-branch copies would defeat donation."""
    n, b = cfg.seg_count, cfg.block_size
    hist_re, hist_im = hist

    def one(h):
        fresh = jnp.zeros_like(h)
        if n > 1:
            window = jax.lax.dynamic_slice(h, (pos - (n - 1), 0), (n - 1, b))
            fresh = jax.lax.dynamic_update_slice(fresh, window, (0, 0))
        return fresh

    return (one(hist_re), one(hist_im)), jnp.asarray(n - 1, jnp.int32)


def stream_conv_chrono_unguarded(
    cfg: UniformConfig, state: UniformState,
    hist: tuple, pos: jnp.ndarray,
    blocks: jnp.ndarray, kern_hat=None,
) -> Tuple[UniformState, tuple, jnp.ndarray, jnp.ndarray]:
    """Time-DFT conv stream on the CHRONO convention — the glue-free form
    of :func:`stream_conv_unguarded` (VERDICT r4 #1): write the T new
    spectra at rows ``[pos, pos+T)`` of each history plane (in place under
    donation), slice the m-row meta-DFT window ending ``N - 1`` rows
    before them, MAC, OLA.  No doubled-ring concat, no flips, no ext
    concat, no rebuild roll — and no plane extraction either: the
    plane-separated slices feed :func:`ops.fft.causal_conv_time` directly
    (its tuple-``ext`` form).

    Preconditions (caller owns them): CHRONO state with rows >= ``pos``
    zero and ``pos >= N - 1``; the call fits (:func:`chrono_fits` — compact
    first otherwise); ``current < active`` ring cleanliness is inherited
    from the conversion precondition.  A shrunk ``active`` is handled by
    the activity-masked kernel (``kern_hat`` from :func:`stream_khat`, or
    the in-call mask) — chronological history has no mod-``active`` slot
    scrambling, so callers that must reproduce the reference's post-shrink
    ring semantics exactly must stay on the ring paths.

    Returns ``(state', hist', pos', y)``.
    """
    b = cfg.block_size
    n = cfg.seg_count
    t = blocks.shape[0]
    m = next_power_of_two(n - 1 + t) if n > 1 else next_power_of_two(t)
    hist_re, hist_im = hist
    h_cap = hist_re.shape[0]
    assert m <= h_cap, (
        f"chrono buffer of {h_cap} rows cannot serve a {t}-block call "
        f"(meta window m={m}); size it with chrono_capacity(cfg, t)"
    )
    specs = rdft_block(blocks, cfg.fft_size)                 # [T, 2, B]
    hist_re = jax.lax.dynamic_update_slice(hist_re, specs[:, 0], (pos, 0))
    hist_im = jax.lax.dynamic_update_slice(hist_im, specs[:, 1], (pos, 0))
    start = pos - (n - 1) if n > 1 else pos
    e_re = jax.lax.dynamic_slice(hist_re, (start, 0), (m, b))
    e_im = jax.lax.dynamic_slice(hist_im, (start, 0), (m, b))
    if kern_hat is None:
        i = jnp.arange(n, dtype=jnp.int32)
        kern = jnp.where(
            (i < state.active_segs)[:, None, None], state.segments_ir, 0.0
        )
    else:
        kern = state.segments_ir  # shape source only — khat replaces its DFT
    convs = causal_conv_time((e_re, e_im), kern, t, kern_hat=kern_hat, m=m)
    # pre via the sequential identity (see _stream_conv.rebuild_roll)
    pre = convs[-1] - pmul(specs[-1], state.segments_ir[0])
    outs = irdft_block(convs, cfg.fft_size)                  # [T, 2B]
    tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    new_state = state._replace(pre_multiplied=pre, overlap=outs[-1, b:])
    return new_state, (hist_re, hist_im), (pos + t).astype(jnp.int32), y


# ---------------------------------------------------------------------------
# stream-core decision tree (authoritative; DESIGN.md §4b renders the table)
# ---------------------------------------------------------------------------
#
# The file carries eight stream cores because three orthogonal axes each
# fork the fast path: STATE CONVENTION (standard ring / rebased ring /
# phased ring / chrono window), GUARDING (in-jit safety conds vs unguarded
# preconditions a vmapping caller must own), and MAC FORMULATION
# (sequential scan vs time-DFT conv vs correlation windows).  choose_stream_core() encodes
# which core serves which regime; the unguarded cores ASSERT their static
# preconditions where they can (call-length bounds) and document the
# runtime ones (full clean ring) here and in their docstrings.

STREAM_CORES = {
    "process_stream_scan": "semantic reference; any state; slow (per-block "
                           "dispatch latency dominates)",
    "process_stream": "guarded dispatcher — use this unless vmapping: conv "
                      "core when block <= 2048 and T >= 8 or a kern_hat is "
                      "supplied, exact ring scan otherwise / for shrunk-ring "
                      "transients",
    "stream_scan_unguarded": "hoisted-DFT gather ring scan; tolerates "
                             "active < seg_count; no safety conds (vmap-"
                             "safe); few-segment engines (gathers cheap)",
    "stream_scan_sliced_unguarded": "hoisted-DFT sliced ring scan (doubled "
                                    "IR table, no gathers); REQUIRES full "
                                    "clean ring; 2x IR memory transient",
    "stream_conv_unguarded": "time-DFT conv core; REQUIRES full clean "
                             "ring; the vmapped-farm small-stage core",
    "stream_corr_rebased_unguarded": "correlation windows on a REBASED ring "
                                     "(current == 0, [N+E] extended table); "
                                     "T <= min(N, CORR_EXTRA_ROWS); rolls "
                                     "the ring back each call",
    "stream_corr_phased_unguarded": "correlation windows, roll-free PHASED "
                                    "ring ([2N+E] doubled table, phase in "
                                    "current); T <= min(N, CORR_EXTRA_ROWS); "
                                    "the farm big-tail core's single-voice "
                                    "form",
    "stream_conv_chrono_unguarded": "time-DFT conv core on the CHRONO "
                                    "sliding-window convention ([h_cap] "
                                    "chronological hist + pos, zero glue); "
                                    "REQUIRES conversion via ring_to_chrono "
                                    "and host-routed compaction; the single-"
                                    "voice two-stage big-tail stream core",
}


def choose_stream_core(cfg: UniformConfig, t: int, *,
                       batched: bool = False,
                       full_clean_ring: bool = False,
                       ring_convention: str = "standard",
                       kern_hat: bool = False) -> str:
    """Name of the preferred stream core for a ``t``-block call.

    ``batched``: the caller vmaps over voices (lockstep scalars), so
    in-jit safety conds are off the table (vmap executes both branches).
    ``full_clean_ring``: the caller guarantees ``active == seg_count and
    current < active`` (any engine never shrunk by ``update``).
    ``ring_convention``: ``"standard"`` | ``"rebased"`` | ``"phased"`` —
    the corr cores require their own state layout (extended IR tables),
    chosen at init by the farm.
    ``kern_hat``: a precomputed :func:`stream_khat` is supplied.

    Mirrors the live dispatch in :func:`process_stream` (whose guarded
    cond this function cannot replace — it answers "which core WILL/"
    "should run", for callers wiring unguarded paths and for tests).
    """
    if ring_convention in ("rebased", "phased"):
        if not (full_clean_ring and t <= min(cfg.seg_count, CORR_EXTRA_ROWS)):
            raise ValueError(
                "corr cores require a full clean ring and "
                f"T <= min(seg_count, {CORR_EXTRA_ROWS})"
            )
        return ("stream_corr_phased_unguarded" if ring_convention == "phased"
                else "stream_corr_rebased_unguarded")
    if not batched and not full_clean_ring:
        return "process_stream"   # guarded dispatcher owns the safety conds
    use_conv = (cfg.block_size <= 2048 and t >= 8) or kern_hat
    if use_conv and full_clean_ring:
        return "stream_conv_unguarded"
    if full_clean_ring:
        return "stream_scan_sliced_unguarded"
    return "stream_scan_unguarded"


def process_stream(cfg: UniformConfig, state: UniformState,
                   blocks: jnp.ndarray,
                   kern_hat=None) -> Tuple[UniformState, jnp.ndarray]:
    """Batched streaming over ``[T, block_size]`` — the device-side
    replacement for the caller's audio-callback loop
    (``examples/compare_partitioned.rs:30-48``).

    ``kern_hat``: optional :func:`stream_khat` precompute for this call's
    ``T`` — hoists the input-independent kernel meta-DFT (one third of
    the stream MAC's matmul work) out of the call.  Recompute after
    ``update``; ignored by the ring-scan fallback and huge-block paths.

    A naive scan of :func:`process_block` leaves the device idle: every scan
    iteration dispatches two small DFT matmuls whose latency dominates.
    Here nothing sequential remains at all:

    * forward DFTs of ALL T input blocks: one ``[T, 2B] @ basis`` matmul;
    * the spectral MAC over the frequency-delay line: a second DFT along
      the block axis (``ops.fft.causal_conv_time`` inside
      :func:`_stream_conv`), with an in-jit fallback to the exact ring scan
      for the shrunk-ring transient;
    * inverse DFTs of all T conv spectra: one matmul;
    * overlap-add: a vectorized shift (``y[t] = out[t,:B] + out[t-1,B:]``
      with the carried ``overlap`` seeding t=0).

    Results match the sequential path within f32 reassociation; state
    evolution (``segments``, ``current``, ``pre_multiplied``, ``overlap``)
    is reproduced exactly.
    """
    b = cfg.block_size
    t = blocks.shape[0]

    def inactive() -> Tuple[UniformState, jnp.ndarray]:
        return state, jnp.zeros((t, b), jnp.float32)

    def active() -> Tuple[UniformState, jnp.ndarray]:
        specs = rdft_block(blocks, cfg.fft_size)  # [T, 2, B] — one matmul
        # static cost choice: the time-DFT core amortizes its block-axis
        # transforms over long streams of small blocks; for huge blocks
        # (two-stage tails) or very short streams the hoisted-DFT ring scan
        # is cheaper.  A caller-precomputed ``kern_hat`` overrides the
        # block-size heuristic: with the kernel-side meta-DFT hoisted, the
        # conv core reads the ring ONCE per call instead of once per block
        # — at the flagship tail shape (57 segments x 8192 lanes, 62
        # blocks/call) the ring scan moves ~7.5 MB x T of HBM while the
        # conv core's meta-DFT passes are ~flat in T (the caller gates the
        # khat build on enough blocks per call: two_stage.stream_khats)
        use_conv = (cfg.block_size <= 2048 and t >= 8) or kern_hat is not None
        if use_conv:
            new_state, convs = jax.lax.cond(
                state.current < state.active_segs,
                lambda: _stream_conv(cfg, state, specs, kern_hat=kern_hat),
                lambda: _stream_ring_scan(cfg, state, specs),
            )
        else:
            new_state, convs = _stream_ring_scan(cfg, state, specs)
        outs = irdft_block(convs, cfg.fft_size)  # [T, 2B] — one matmul
        tails = jnp.concatenate([state.overlap[None], outs[:-1, b:]], axis=0)
        y = outs[:, :b] + tails
        return new_state._replace(overlap=outs[-1, b:]), y

    return jax.lax.cond(state.active_segs == 0, inactive, active)
