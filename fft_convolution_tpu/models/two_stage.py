"""Two-stage (non-uniform partition) FFT convolution.

JAX re-design of ``TwoStageFFTConvolver``
(``src/fft_convolver.rs:323-526``): a small-block *head* convolver gives low
latency while two large-block *tail* stages give efficiency, with the tail
outputs precomputed one period ahead (double-buffered) so the per-block cost
stays flat.  García's closed form picks the optimal tail block size
(``compute_tail_block_size``, ``:516-526``).

The reference schedules the stages with data-dependent ifs inside its
while-loop; here the schedule is a pure function of the intra-period position
carried in the state, expressed with ``lax.cond`` on scalars so the whole
step stays one compiled program — the heavy tail FFT executes only on the
block that completes a period, exactly like the reference's
``std::mem::swap`` double-buffer dance (``:473-486``).

IR split (``:352-384``):
* head:   ``ir[0 .. min(max_len, T)]``           at ``head_block``
* tail0:  ``ir[T .. T + min(max_len - T, T)]``   at ``head_block``
* tail:   ``ir[2T ..]``                          at ``tail_block``
where ``T = tail_block``.  Absent stages are Default (zero-output) engines.

``update`` is ``todo!()`` in the reference (``:408-410``); we match the
surface with ``NotImplementedError`` (live IR switching goes through the
crossfade wrapper, as upstream intends).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cpx import pmul_sum
from ..ops.fft import (causal_conv_khat, causal_conv_multi, irdft_block,
                       next_power_of_two, rdft_block)
from . import uniform

# FFT cost constant k relative to a multiply-add, as suggested by García and
# used verbatim by the reference (``src/fft_convolver.rs:514-516``).
FFT_K = 1.5


def compute_tail_block_size(head_len: int, response_len: int) -> int:
    """García's optimal two-stage partition ("Optimal Filter Partition for
    Efficient Convolution with Short Input/Output Delay") — float32 math
    matching ``src/fft_convolver.rs:520-526`` exactly."""
    kn = np.float32(FFT_K * head_len) / np.float32(2.0 * np.log(2.0))
    b = -kn + np.float32(np.sqrt(np.float32(kn * kn) + np.float32(response_len) * np.float32(head_len)))
    b = max(float(b), float(head_len))
    return next_power_of_two(int(b))


@dataclasses.dataclass(frozen=True)
class TwoStageConfig:
    head_block: int
    tail_block: int
    head: uniform.UniformConfig
    tail0: Optional[uniform.UniformConfig]   # None when max_len <= tail_block
    tail: Optional[uniform.UniformConfig]    # None when max_len <= 2*tail_block

    @property
    def period(self) -> int:
        """Head blocks per tail period."""
        return self.tail_block // self.head_block


class TwoStageState(NamedTuple):
    """``TwoStageFFTConvolver`` struct fields (``src/fft_convolver.rs:324-337``)."""

    head: uniform.UniformState
    tail0: uniform.UniformState
    tail: uniform.UniformState
    tail_output0: jnp.ndarray       # f32 [tail_block]
    tail_precalc0: jnp.ndarray      # f32 [tail_block]
    tail_output: jnp.ndarray        # f32 [tail_block]
    tail_precalc: jnp.ndarray       # f32 [tail_block]
    tail_input: jnp.ndarray         # f32 [tail_block]
    tail_fill: jnp.ndarray          # i32 []
    precalc_pos: jnp.ndarray        # i32 []


def init(
    response: jnp.ndarray, block_size: int, max_response_length: int
) -> Tuple[TwoStageConfig, TwoStageState]:
    """``Convolution::init`` (``src/fft_convolver.rs:340-406``)."""
    response = np.asarray(response, np.float32)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    head_block = block_size
    tail_block = compute_tail_block_size(block_size, max_response_length)
    padded = np.zeros(max_response_length, np.float32)
    padded[: response.shape[0]] = response

    head_ir_len = min(max_response_length, tail_block)
    head_cfg, head_state = uniform.init(padded[:head_ir_len], head_block, head_ir_len)

    if max_response_length > tail_block:
        t0_len = min(max_response_length - tail_block, tail_block)
        tail0_cfg, tail0_state = uniform.init(
            padded[tail_block : tail_block + t0_len], head_block, t0_len
        )
    else:
        tail0_cfg, tail0_state = None, None
    if tail0_cfg is None:
        _, tail0_state = uniform.empty(head_block)

    if max_response_length > 2 * tail_block:
        t_len = max_response_length - 2 * tail_block
        tail_cfg, tail_state = uniform.init(
            padded[2 * tail_block :], tail_block, t_len
        )
    else:
        tail_cfg, tail_state = None, None
    if tail_cfg is None:
        _, tail_state = uniform.empty(tail_block)

    cfg = TwoStageConfig(
        head_block=head_block,
        tail_block=tail_block,
        head=head_cfg,
        tail0=tail0_cfg,
        tail=tail_cfg,
    )
    # distinct arrays per field: a shared zeros buffer cannot be donated
    # more than once by downstream jits
    def zeros_t():
        return jnp.zeros((tail_block,), jnp.float32)

    state = TwoStageState(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=zeros_t(),
        tail_precalc0=zeros_t(),
        tail_output=zeros_t(),
        tail_precalc=zeros_t(),
        tail_input=zeros_t(),
        tail_fill=jnp.zeros((), jnp.int32),
        precalc_pos=jnp.zeros((), jnp.int32),
    )
    return cfg, state


def update(cfg: TwoStageConfig, state: TwoStageState, response_padded: jnp.ndarray,
           new_len: jnp.ndarray) -> TwoStageState:
    """EXTENSION — the reference leaves ``update`` as ``todo!()``
    (``src/fft_convolver.rs:408-410``); the public wrapper keeps that
    surface and exposes this as ``update_extension``.

    Semantics follow the uniform engine's RT-safe swap (``:174-213``)
    stage-wise: each stage re-derives its IR slice (head ``[0..T]``, tail0
    ``[T..2T]``, tail ``[2T..]``, as at init ``:352-384``), input history
    and the period schedule are kept, and pending outputs (the
    precalculated tail double-buffers — the analogue of the uniform
    engine's discarded ``overlap``) are zeroed.

    ``response_padded`` must be zero-padded to the init
    ``max_response_length``; ``new_len`` is the actual (traced) length.
    """
    tb = cfg.tail_block
    zeros_t = jnp.zeros_like(state.tail_input)

    head_cap = cfg.head.ir_len
    head_state = uniform.update(
        cfg.head, state.head,
        copy_and_pad_static(response_padded[:head_cap],
                            cfg.head.seg_count * cfg.head.block_size),
        jnp.minimum(new_len, head_cap).astype(jnp.int32),
    )

    if cfg.tail0 is not None:
        cap0 = cfg.tail0.ir_len
        tail0_state = uniform.update(
            cfg.tail0, state.tail0,
            copy_and_pad_static(response_padded[tb:tb + cap0],
                                cfg.tail0.seg_count * cfg.tail0.block_size),
            jnp.clip(new_len - tb, 0, cap0).astype(jnp.int32),
        )
    else:
        tail0_state = state.tail0

    if cfg.tail is not None:
        cap_t = cfg.tail.ir_len
        tail_state = uniform.update(
            cfg.tail, state.tail,
            copy_and_pad_static(response_padded[2 * tb:2 * tb + cap_t],
                                cfg.tail.seg_count * cfg.tail.block_size),
            jnp.clip(new_len - 2 * tb, 0, cap_t).astype(jnp.int32),
        )
    else:
        tail_state = state.tail

    return state._replace(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=zeros_t,
        tail_precalc0=zeros_t,
        tail_output=zeros_t,
        tail_precalc=zeros_t,
    )


def copy_and_pad_static(x: jnp.ndarray, total: int) -> jnp.ndarray:
    if x.shape[0] == total:
        return x
    return jnp.pad(x, (0, total - x.shape[0]))


def reset(cfg: TwoStageConfig, state: TwoStageState) -> TwoStageState:
    """``Convolution::reset`` (``src/fft_convolver.rs:497-511``)."""
    zeros_t = jnp.zeros_like(state.tail_input)
    return TwoStageState(
        head=uniform.reset(state.head),
        tail0=uniform.reset(state.tail0),
        tail=uniform.reset(state.tail),
        tail_output0=zeros_t,
        tail_precalc0=zeros_t,
        tail_output=zeros_t,
        tail_precalc=zeros_t,
        tail_input=zeros_t,
        tail_fill=jnp.zeros((), jnp.int32),
        precalc_pos=jnp.zeros((), jnp.int32),
    )


def process_block(cfg: TwoStageConfig, state: TwoStageState,
                  x: jnp.ndarray) -> Tuple[TwoStageState, jnp.ndarray]:
    """Process one full head block (``src/fft_convolver.rs:412-495``; the
    reference asserts ``input.len() <= head_block_size`` at ``:414``, and
    its own tests/benchmark always pass full blocks — the host wrapper
    handles smaller chunks).

    One iteration of the reference while-loop with ``processing ==
    head_block_size``: sum in both precalculated tail buffers at
    ``precalculated_pos`` (``:439-456``), append to the period input
    (``:459-461``), advance tail0 by one head block (``:464-476``), and at
    period end double-swap both precalc buffers and run the big tail
    convolver over the full period (``:479-491``).
    """
    b = cfg.head_block
    tb = cfg.tail_block

    head_state, y = uniform.process_block(cfg.head, state.head, x)

    pos = state.precalc_pos
    # Sum: 1st and 2nd-Nth tail blocks (:439-456). Buffers always exist
    # (allocated at tail_block, :370-371,386-387); absent stages leave zeros.
    y = y + jax.lax.dynamic_slice(state.tail_precalc0, (pos,), (b,))
    y = y + jax.lax.dynamic_slice(state.tail_precalc, (pos,), (b,))

    tail_input = jax.lax.dynamic_update_slice(state.tail_input, x, (state.tail_fill,))
    fill = state.tail_fill + b
    period_end = fill == tb

    # Convolution: 1st tail block — one head-block step per call (:464-476)
    if cfg.tail0 is not None:
        tail0_state, out0 = uniform.process_block(cfg.tail0, state.tail0, x)
        tail_output0 = jax.lax.dynamic_update_slice(
            state.tail_output0, out0, (state.tail_fill,)
        )
        tail_precalc0, tail_output0 = jax.lax.cond(
            period_end,
            lambda p, o: (o, p),
            lambda p, o: (p, o),
            state.tail_precalc0, tail_output0,
        )
    else:
        tail0_state = state.tail0
        tail_precalc0, tail_output0 = state.tail_precalc0, state.tail_output0

    # Convolution: 2nd-Nth tail blocks — the reference notes this "might be
    # done in some background thread" (:478); here it is a conditionally
    # executed large-block kernel inside the same compiled step (:479-486)
    if cfg.tail is not None:
        def run_tail(op):
            t_state, t_out, _t_pre, t_in = op
            new_state, new_out = uniform.process_block(cfg.tail, t_state, t_in)
            return new_state, new_out, t_out  # precalc <- old output (swap)

        def skip_tail(op):
            t_state, t_out, t_pre, _t_in = op
            return t_state, t_out, t_pre

        tail_state, tail_output, tail_precalc = jax.lax.cond(
            period_end, run_tail, skip_tail,
            (state.tail, state.tail_output, state.tail_precalc, tail_input),
        )
    else:
        tail_state = state.tail
        tail_output, tail_precalc = state.tail_output, state.tail_precalc

    # period-end counter reset (:488-491)
    new_fill = jnp.where(period_end, 0, fill).astype(jnp.int32)
    new_pos = jnp.where(period_end, 0, pos + b).astype(jnp.int32)

    return TwoStageState(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=tail_output0,
        tail_precalc0=tail_precalc0,
        tail_output=tail_output,
        tail_precalc=tail_precalc,
        tail_input=tail_input,
        tail_fill=new_fill,
        precalc_pos=new_pos,
    ), y


def process_partial(cfg: TwoStageConfig, state: TwoStageState,
                    chunk_padded: jnp.ndarray, length: jnp.ndarray
                    ) -> Tuple[TwoStageState, jnp.ndarray]:
    """One iteration of the reference sub-block while-loop
    (``src/fft_convolver.rs:427-494``) for chunks smaller than a head block.

    ``chunk_padded`` is the chunk left-aligned in a ``[head_block]`` buffer;
    the host chunker guarantees it does not cross a head-block boundary
    (``processing = min(remaining, head - fill % head)``, ``:429-432``).
    Returns the full head-block output lane; caller slices
    ``[fill % head : fill % head + length]``.

    Invariant exploited: ``precalculated_pos == tail_input_fill`` at all
    times (both advance by ``processing`` and reset together, ``:456,461,488-491``).
    """
    b = cfg.head_block
    tb = cfg.tail_block
    fill = state.tail_fill
    offset = fill % b

    head_state, y_full = uniform.process_partial(
        cfg.head, state.head, chunk_padded, length
    )

    # Sum both precalculated tails: chunk sample j (at lane offset+j) gets
    # precalc[fill + j] = precalc[fill - offset + lane] (:439-456)
    base = fill - offset  # head-block aligned, >= 0
    y_full = y_full + jax.lax.dynamic_slice(state.tail_precalc0, (base,), (b,))
    y_full = y_full + jax.lax.dynamic_slice(state.tail_precalc, (base,), (b,))

    # Fill period input buffer (:459-461): masked roll placement
    pos_lanes = jnp.arange(tb, dtype=jnp.int32)
    take = (pos_lanes >= fill) & (pos_lanes < fill + length)
    shifted = jnp.roll(jnp.pad(chunk_padded, (0, tb - b)), fill)
    tail_input = jnp.where(take, shifted, state.tail_input)
    new_fill = fill + length

    head_boundary = (new_fill % b) == 0
    period_end = new_fill == tb

    if cfg.tail0 is not None:
        def run_tail0(op):
            t0_state, t_out0, t_pre0 = op
            head_chunk = jax.lax.dynamic_slice(tail_input, (new_fill - b,), (b,))
            t0_state, out0 = uniform.process_block(cfg.tail0, t0_state, head_chunk)
            t_out0 = jax.lax.dynamic_update_slice(t_out0, out0, (new_fill - b,))
            t_pre0, t_out0 = jax.lax.cond(
                period_end, lambda p, o: (o, p), lambda p, o: (p, o), t_pre0, t_out0
            )
            return t0_state, t_out0, t_pre0

        tail0_state, tail_output0, tail_precalc0 = jax.lax.cond(
            head_boundary, run_tail0, lambda op: op,
            (state.tail0, state.tail_output0, state.tail_precalc0),
        )
    else:
        tail0_state = state.tail0
        tail_output0, tail_precalc0 = state.tail_output0, state.tail_precalc0

    if cfg.tail is not None:
        def run_tail(op):
            t_state, t_out, _t_pre = op
            new_state, new_out = uniform.process_block(cfg.tail, t_state, tail_input)
            return new_state, new_out, t_out

        tail_state, tail_output, tail_precalc = jax.lax.cond(
            period_end, run_tail, lambda op: op,
            (state.tail, state.tail_output, state.tail_precalc),
        )
    else:
        tail_state = state.tail
        tail_output, tail_precalc = state.tail_output, state.tail_precalc

    new_fill = jnp.where(period_end, 0, new_fill).astype(jnp.int32)

    return TwoStageState(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=tail_output0,
        tail_precalc0=tail_precalc0,
        tail_output=tail_output,
        tail_precalc=tail_precalc,
        tail_input=tail_input,
        tail_fill=new_fill,
        precalc_pos=new_fill,  # invariant: pos == fill
    ), y_full


def process_stream(cfg: TwoStageConfig, state: TwoStageState,
                   blocks: jnp.ndarray) -> Tuple[TwoStageState, jnp.ndarray]:
    """Scan :func:`process_block` over a ``[T, head_block]`` stream."""

    def step(st, x):
        return process_block(cfg, st, x)

    return jax.lax.scan(step, state, blocks)


# The fused front end has two formulations of its side passes (the
# first-period subtract and the exit-state reconstruction):
#
# * MULTI (short calls): both are row windows of ONE tail0-kernel conv
#   against the shared ext, so the whole front end is one forward
#   meta-DFT + one lane-stacked inverse (causal_conv_multi).  Minimal op
#   CHAIN — but the t0 channel adds a full extra lane block across the
#   union window [0, n + t), whose bytes scale with t.
# * SEPARATE (long calls): the side passes run as their own small convs
#   (meta sizes 2n and npo2(n - 1 + nrec), both flat in t) — more
#   serialized ops, asymptotically fewer bytes.
#
# Extra inverse traffic of MULTI ~ (t + n) * B * 8 bytes * ~3 passes;
# extra chain of SEPARATE ~ 2 conv pipelines ~ 15-30 us of latency-bound
# small matmuls.  They cross around t + n ~ 2k rows at B = 128 lanes
# (~6 MB ~ the same 10-20 us) — short-call serving sits far below, the
# flagship's T = 3968 call far above.
FUSED_MULTI_MAX_ROWS = 2048


def fused_uses_multi(cfg: TwoStageConfig, t: int) -> bool:
    """Whether a ``t``-block fused call uses the single shared-transform
    MULTI formulation (see :data:`FUSED_MULTI_MAX_ROWS`).  Static — keys
    both :func:`stream_khats`'s dict shape and the compiled program."""
    return t + cfg.head.seg_count <= FUSED_MULTI_MAX_ROWS


def _fused_small_streams(cfg, st_h, st_t0, blocks, precalc0, khats):
    """Head and tail0 streams through ONE shared front end AND one
    COMBINED 2n-segment kernel — the single-voice analogue of the farm's
    fused heads (:func:`parallel.farm2._heads_fused`).

    With the same config, both stages' input rings are IDENTICAL by
    construction, so one forward DFT and one ring rebuild serve both; and
    since the period equals the head segment count, tail0's one-period
    output delay is a kernel shift of ``n`` segments — so the conv over
    ``concat(head_table, tail0_table)`` produces
    ``head(x) + delay_1_period(tail0(x))`` directly.  The two side passes
    (first-period subtract, exit-state reconstruction) are row windows of
    ONE tail0-kernel conv against the SAME ext, so the whole front end is
    ONE forward meta-DFT + ONE lane-stacked inverse
    (:func:`ops.fft.causal_conv_multi`) + ONE inverse block-DFT — short
    calls are latency-bound chains of small matmuls, and this is the
    minimal chain.

    Window bookkeeping (all exact, not approximations):

    * the ring provides the full ``n``-row history window; delayed-kernel
      lags beyond it read the meta-DFT's zero pad (``m`` is sized so the
      circular wrap lands in padding);
    * the sequential schedule's contract says the FIRST period's tail0
      contribution comes from ``tail_precalc0`` (last call's output), so
      the in-window delayed terms the combined kernel produces for
      ``t < p`` are subtracted back out — rows ``[0, p)`` of the tail0
      conv, whose lags see only the history window (the old triangular
      pass), and the OLA seam at row ``p`` adds tail0's carried overlap;
    * the exit state (tail0's overlap, ``tail_precalc0``/``tail_output0``
      = tail0's last two OLA'd periods, and the head overlap without the
      delayed part) is reconstructed exactly from rows
      ``[t + n - nrec, t + n)`` of the same tail0 conv (``nrec = min(q, 2)
      * p + 1`` raw blocks).

    Precondition (caller guards with a ``lax.cond``): full clean rings —
    ``active == seg_count`` and ``current < seg_count`` on both stages,
    equal ``current``.  Outputs and state evolution match the separate
    streams (the equivalence tests pin this).

    Returns ``(st_h', st_t0', y_with_tail0 [T, b], new_precalc0 [tb],
    new_output0 [tb])``.
    """
    ucfg = cfg.head
    b = ucfg.block_size
    n = ucfg.seg_count
    p = cfg.period
    assert p == n, "fused small streams require period == head seg_count"
    t = blocks.shape[0]
    q = t // p
    kh = khats if khats is not None else {}
    specs = rdft_block(blocks, ucfg.fft_size)                # [T, 2, B]
    seg2 = jnp.concatenate([st_h.segments, st_h.segments], axis=0)
    window = jnp.flip(jax.lax.dynamic_slice(
        seg2, (st_h.current + 1, 0, 0), (n, 2, b)
    ), axis=0)                                   # blocks -n..-1 oldest-first
    # fold the meta-DFT zero pad (m_comb - n - T rows, the wrap slack the
    # combined kernel's docstring requires) into this concat — ext lands
    # at m_comb rows exactly and causal_conv_multi's _pad_rows is a no-op
    # instead of a second full-array materialization.  The slices below
    # (byd) use explicit end indices < n + T, so the zero rows are inert
    # for them.
    m_comb = next_power_of_two(t + 2 * n - 1)
    ext = jnp.concatenate(
        [window, specs, jnp.zeros((m_comb - n - t, 2, b), jnp.float32)],
        axis=0,
    )                                                        # [m_comb, 2, B]

    nrec = min(q, 2) * p + 1
    kern_comb = kh.get("comb")
    if kern_comb is None:
        kern_comb = jnp.concatenate(
            [st_h.segments_ir, st_t0.segments_ir], axis=0)
    if fused_uses_multi(cfg, t):
        # MULTI: one shared forward meta-DFT + one lane-stacked inverse
        # serve all three passes (causal_conv_multi): the combined
        # head+tail0 kernel's main conv, and the tail0-only full conv
        # whose row windows ARE the first-period triangular subtract
        # (rows [0, p): history-window-only lags, the in-window delayed
        # terms) and the exact exit-state reconstruction (its top rows:
        # tail0's raw blocks for the last min(q, 2) periods + 1).  Short
        # calls are a serialized chain of small matmuls, so collapsing
        # three conv pipelines into one is the short-call latency fix
        # (VERDICT r4 #1's head-bound remainder).
        kern_t0 = kh.get("t0f")
        conv, t0full = causal_conv_multi(
            ext,
            [kern_comb,
             kern_t0 if kern_t0 is not None else st_t0.segments_ir],
            windows=[(n, t), (0, n + t)], m=m_comb,
        )                                    # [T, 2, B], [n + T, 2, B]
        # rows [0, p) of the tail0 conv = the first-period subtract
        w = jax.lax.slice_in_dim(t0full, 0, p, axis=0)       # [p, 2, B]
        # rows [t + n - nrec, t + n) = tail0's raw rec rows
        conv0 = jax.lax.slice_in_dim(t0full, t + n - nrec, t + n, axis=0)
    else:
        # SEPARATE: side passes as their own small convs, meta sizes flat
        # in t (see FUSED_MULTI_MAX_ROWS); each still folds its lane-0
        # conjugate correction into its stacked inverse
        conv = causal_conv_multi(ext, [kern_comb], [(n, t)], m=m_comb)[0]
        kern_t0s = kh.get("small")
        ext_w = jnp.concatenate(
            [jnp.zeros((n - 1, 2, b), jnp.float32), window,
             jnp.zeros((1, 2, b), jnp.float32)], axis=0
        )                                                    # [2n, 2, B]
        w = causal_conv_multi(
            ext_w,
            [kern_t0s if kern_t0s is not None else st_t0.segments_ir],
            [(n - 1, p)], m=2 * n,
        )[0]                                                 # [p, 2, B]
        m_rec = next_power_of_two(n - 1 + nrec)
        start = t - nrec + 1
        # slice straight to m_rec rows when ext's folded zero slack
        # covers it (rows >= n + T are the appended zeros)
        end = start + m_rec if start + m_rec <= m_comb else t + n
        ext_rec = jax.lax.slice_in_dim(ext, start, end, axis=0)
        kern_rec = kh.get("rec")
        conv0 = causal_conv_multi(
            ext_rec,
            [kern_rec if kern_rec is not None else st_t0.segments_ir],
            [(n - 1, nrec)], m=m_rec,
        )[0]                                                 # [nrec, 2, B]

    # subtract the in-window delayed terms for the first period (their
    # contribution is carried in tail_precalc0 by contract)
    conv = jnp.concatenate([conv[:p] - w, conv[p:]], axis=0)

    # one stacked inverse block-DFT for the stream rows + the rec rows
    raw = irdft_block(jnp.concatenate([conv, conv0], axis=0),
                      ucfg.fft_size)                 # [T + nrec, 2B]
    outs = raw[:t]
    raw0 = raw[t:]                                           # [nrec, 2B]
    tails = jnp.concatenate([st_h.overlap[None], outs[:-1, b:]], axis=0)
    y = outs[:, :b] + tails
    # the first period's tail0 contribution is the carried time-domain
    # tail_precalc0 (the contract the sequential schedule keeps)
    y = jnp.concatenate([y[:p] + precalc0.reshape(p, b), y[p:]], axis=0)
    if t > p:
        # OLA seam: row p's tail is row p-1's second half, which is
        # head-only after the subtract — the delayed part's seam tail is
        # tail0's carried overlap (= its last raw block's second half)
        y = y.at[p].add(st_t0.overlap)
    out0_rows = raw0[1:, :b] + raw0[:-1, b:]      # blocks [t - nrec + 1, t)
    new_precalc0 = out0_rows[-p:].reshape(p * b)
    new_output0 = (out0_rows[:p].reshape(p * b) if q >= 2 else precalc0)

    # shared ring rebuild (full-ring roll fast path, the guarded case)
    current_f = jnp.mod(st_h.current - t, n).astype(jnp.int32)
    byd = jnp.flip(jax.lax.slice_in_dim(ext, t, t + n, axis=0), axis=0)
    segments = jnp.roll(byd, current_f + 1, axis=0)
    i = jnp.arange(n, dtype=jnp.int32)
    pre_h = pmul_sum(st_h.segments_ir, byd, i >= 1)
    pre_0 = pmul_sum(st_t0.segments_ir, byd, i >= 1)
    # the head's own OLA tail, without the delayed part riding in the
    # combined rows (raw0[-(p+1)] is tail0's raw block t-1-p); for t == p
    # the last row sits in the W-subtracted first period and is already
    # head-only
    head_overlap = (outs[-1, b:] - raw0[-(p + 1), b:] if t > p
                    else outs[-1, b:])
    st_h2 = st_h._replace(
        segments=segments, current=current_f,
        pre_multiplied=pre_h,
        overlap=head_overlap,
    )
    # distinct ring buffer for tail0: two pytree leaves must never share
    # one array (donation rejects a buffer donated twice — see init)
    st_t02 = st_t0._replace(
        segments=jnp.copy(segments), current=current_f,
        pre_multiplied=pre_0, overlap=raw0[-1, b:],
    )
    return st_h2, st_t02, y, new_precalc0, new_output0


# Big-tail routing policy: the ring scan reads the whole ring + a
# doubled-table window PER BLOCK (~2 x N x fft x 4 bytes each step, so
# scan bytes ~ q * N), while the conv core's meta-DFT passes each cost
# ~m = next_power_of_two(N - 1 + q) rows and are nearly flat in q.  The
# conv core is taken when q * N >= RATIO * m (a crossover not yet
# re-measured on the GPU).
TAIL_CONV_RATIO = 5


def tail_uses_conv_core(cfg: TwoStageConfig, t: int) -> bool:
    """Whether a ``t``-head-block aligned call routes its big tail through
    the khat-served conv core (see :data:`TAIL_CONV_RATIO`)."""
    if cfg.tail is None:
        return False
    q = t // cfg.period
    n = cfg.tail.seg_count
    m = next_power_of_two(n - 1 + q) if n > 1 else next_power_of_two(q)
    return q * n >= TAIL_CONV_RATIO * m


def stream_khats(cfg: TwoStageConfig, state: TwoStageState, t: int,
                 want_tail: Optional[bool] = None):
    """Precompute the kernel meta-spectra for ``T = t``-block aligned
    stream calls — input-independent between IR updates, one third of
    each stage's meta-DFT matmul work hoisted out of every call.

    Returns a dict: ``head``/``t0`` are the per-stage khats
    (:func:`models.uniform.stream_khat`) for the separate-stream paths;
    when the stage configs fuse, ``comb`` is the combined 2n-segment
    kernel's khat, joined by ``t0f`` (the tail0-table khat at the same
    meta size — the MULTI shared-transform form) or ``small``/``rec``
    (the SEPARATE side-pass khats) per :func:`fused_uses_multi`.  When
    :func:`tail_uses_conv_core` says the call is long enough, ``tail``
    is the BIG tail's khat: supplying it flips the tail from the
    sequential ring scan (whole-ring HBM reads per block) to the batched
    time-DFT conv core (:func:`models.uniform._stream_conv` via
    ``kern_hat``), whose traffic is nearly flat in the call length.
    ``want_tail`` overrides that policy (static) — the CHRONO tail path
    serves EVERY call length through the conv core, so its callers force
    the tail khat on.  Jittable; pass to :func:`process_stream_aligned`
    as ``khats=``.
    """
    out = {
        "head": uniform.stream_khat(cfg.head, state.head, t),
        "t0": (uniform.stream_khat(cfg.tail0, state.tail0, t)
               if cfg.tail0 is not None else None),
    }
    use_tail = (tail_uses_conv_core(cfg, t) if want_tail is None
                else (want_tail and cfg.tail is not None))
    if use_tail:
        out["tail"] = uniform.stream_khat(cfg.tail, state.tail,
                                          t // cfg.period)
    if cfg.tail0 is not None and cfg.head == cfg.tail0:
        n = cfg.head.seg_count
        kern = jnp.concatenate(
            [state.head.segments_ir, state.tail0.segments_ir], axis=0
        )
        m_comb = next_power_of_two(t + 2 * n - 1)
        out["comb"] = causal_conv_khat(kern, m_comb)
        if fused_uses_multi(cfg, t):
            out["t0f"] = causal_conv_khat(state.tail0.segments_ir, m_comb)
        else:
            q = t // cfg.period
            nrec = min(q, 2) * cfg.period + 1
            out["small"] = causal_conv_khat(state.tail0.segments_ir, 2 * n)
            out["rec"] = causal_conv_khat(state.tail0.segments_ir,
                                          next_power_of_two(n - 1 + nrec))
    return out


def tail_to_chrono(cfg: TwoStageConfig, state: TwoStageState, h_cap: int
                   ) -> Tuple[TwoStageState, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Move the BIG tail's ring into the CHRONO sliding-window convention
    (:func:`models.uniform.ring_to_chrono`) — ``state.tail.segments``
    becomes a placeholder; the returned ``(hist, pos)`` pair rides
    alongside (donated by the wrapper so per-call writes are in place).
    Precondition: full clean tail ring."""
    assert cfg.tail is not None
    tail_state, hist, pos = uniform.ring_to_chrono(cfg.tail, state.tail, h_cap)
    return state._replace(tail=tail_state), (hist, pos)


def tail_from_chrono(cfg: TwoStageConfig, state: TwoStageState,
                     tail_chrono: Tuple[jnp.ndarray, jnp.ndarray]
                     ) -> TwoStageState:
    """Rebuild the BIG tail's standard ring from the CHRONO pair — the
    inverse boundary conversion (:func:`models.uniform.chrono_to_ring`);
    every sequential/ring-path consumer interoperates with the result."""
    assert cfg.tail is not None
    hist, pos = tail_chrono
    return state._replace(
        tail=uniform.chrono_to_ring(cfg.tail, state.tail, hist, pos)
    )


def tail_chrono_compact(cfg: TwoStageConfig,
                        tail_chrono: Tuple[jnp.ndarray, jnp.ndarray]
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-routed buffer compaction (:func:`models.uniform.chrono_compact`)
    — the wrapper calls this off its host ``pos`` shadow when the next
    call would overrun the buffer."""
    assert cfg.tail is not None
    hist, pos = tail_chrono
    return uniform.chrono_compact(cfg.tail, hist, pos)


def process_stream_aligned(cfg: TwoStageConfig, state: TwoStageState,
                           blocks: jnp.ndarray,
                           small_stream=None,
                           big_stream=None,
                           khats=None,
                           fuse_small: bool = True,
                           tail_chrono=None,
                           assume_clean_small: bool = False,
                           ) -> Tuple[TwoStageState, jnp.ndarray]:
    """Period-aligned batched streaming — the device throughput path.

    Requires ``state.tail_fill == 0`` and ``T % period == 0`` (the host
    wrapper checks).  Exploits the structure the sequential schedule hides:
    the double-buffered precalculated tails (``src/fft_convolver.rs:439-456,
    473-486``) make the three stages *independent* streams whose outputs sum
    with fixed period delays:

        y = head(x) + delay_1_period(tail0(x)) + delay_2_periods(tail(x))

    where tail0 runs at the head block size over the same blocks and tail
    runs at the tail block size over period-sized superblocks.  The delays
    are exactly the reference's swap schedule: precalc0 holds the previous
    period's tail0 output, and the main tail's swap-then-process means its
    contribution surfaces two periods after its input (consistent with its
    IR offset of ``2 * tail_block``).  Each stage is a batched uniform
    stream (batched DFTs), so nothing sequential remains but the tiny
    per-block MAC recurrences inside each stage.

    Carried state reproduces the sequential double-buffer contents exactly,
    so fast and scan paths can interleave freely.

    ``tail_chrono``: optional ``(hist, pos)`` CHRONO pair for the big tail
    (:func:`tail_to_chrono`).  When given, ``state.tail`` must be in the
    CHRONO convention, the big tail runs the glue-free sliding-window conv
    core for EVERY call length (build ``khats`` with ``want_tail=True``),
    and the return becomes ``(state', tail_chrono', y)``.  The caller owns
    compaction (:func:`tail_chrono_compact`, routed off its host ``pos``
    shadow) and should donate the pair so the per-call history write is in
    place.
    """
    b = cfg.head_block
    tb = cfg.tail_block
    p = cfg.period
    t = blocks.shape[0]
    q = t // p
    assert q * p == t, "process_stream_aligned requires T % period == 0"
    assert tail_chrono is None or cfg.tail is not None, (
        "tail_chrono requires a main tail stage"
    )
    # pluggable per-stage stream cores: the vmapped farm passes unguarded
    # cores so voice-batching does not turn the safety conds into
    # execute-both-branches selects.  khats (:func:`stream_khats`) only
    # apply to the DEFAULT small stream — custom cores manage their own.
    kh_head, kh_t0, kh_tail = (
        (khats.get("head"), khats.get("t0"), khats.get("tail"))
        if khats is not None else (None, None, None)
    )
    default_small = small_stream is None
    if default_small:
        def small_stream(ucfg, ust, blk, _kh=None):
            return uniform.process_stream(ucfg, ust, blk, kern_hat=_kh)
    else:
        _user_small = small_stream

        def small_stream(ucfg, ust, blk, _kh=None):
            del _kh
            return _user_small(ucfg, ust, blk)
    if big_stream is None:
        # a precomputed tail khat (stream_khats' "tail" entry) routes the
        # big tail through the batched time-DFT conv core instead of the
        # per-block ring scan — the dominant byte mover of long aligned
        # calls (uniform.process_stream picks the core off kern_hat)
        def big_stream(ucfg, ust, blk):
            return uniform.process_stream(ucfg, ust, blk, kern_hat=kh_tail)

    # fused head+tail0 front end: with identical stage configs the two
    # rings are equal by construction, so one forward DFT / ring rebuild
    # and ONE combined 2n-segment kernel serve both (_fused_small_streams)
    # — guarded by the full-clean-ring scalars, falling back to the two
    # separate streams for shrunk/ragged engines
    fuse = (fuse_small and default_small and cfg.tail0 is not None
            and cfg.head == cfg.tail0)
    if fuse and assume_clean_small:
        # STATIC clean specialization: the wrapper's host shadows prove the
        # full-clean-ring precondition (both small stages fully active since
        # init — init pads the IR to every stage's capacity — and no
        # shrinking update since), so the safety cond AND the entire
        # separate-streams fallback subtree are elided at trace time.  The
        # cond is a fusion barrier and a sync point on the op-count-bound
        # short aligned call, and its boundary tuple copies + the
        # compiled-but-untaken branch are pure overhead when the predicate
        # is statically known.
        head_state, tail0_state, y, new_precalc0, new_output0 = (
            _fused_small_streams(cfg, state.head, state.tail0, blocks,
                                 state.tail_precalc0, khats))
    elif fuse:
        n_h = cfg.head.seg_count
        clean = ((state.head.active_segs == n_h)
                 & (state.tail0.active_segs == n_h)
                 & (state.head.current < n_h)
                 & (state.head.current == state.tail0.current))

        def _separate():
            hs, yh = small_stream(cfg.head, state.head, blocks, kh_head)
            t0s, o0 = small_stream(cfg.tail0, state.tail0, blocks, kh_t0)
            per0 = o0.reshape(q, tb)
            # one-period delay, slot-wise into the period view (the
            # concatenate formulation materialized a [T, B] temp the
            # adder re-read — same fold as the two-period delay's)
            yq = yh.reshape(q, tb).at[0].add(state.tail_precalc0)
            if q >= 2:
                yq = yq.at[1:].add(per0[:-1])
            yf = yq.reshape(t, b)
            np0 = per0[-1]
            no0 = per0[-2] if q >= 2 else state.tail_precalc0
            return hs, t0s, yf, np0, no0

        head_state, tail0_state, y, new_precalc0, new_output0 = jax.lax.cond(
            clean,
            lambda: _fused_small_streams(
                cfg, state.head, state.tail0, blocks,
                state.tail_precalc0, khats
            ),
            _separate,
        )
    else:
        head_state, y = small_stream(cfg.head, state.head, blocks, kh_head)

        if cfg.tail0 is not None:
            tail0_state, out0 = small_stream(cfg.tail0, state.tail0, blocks,
                                             kh_t0)
            per0 = out0.reshape(q, tb)
            # slot-wise one-period delay fold (see _separate)
            yq = y.reshape(q, tb).at[0].add(state.tail_precalc0)
            if q >= 2:
                yq = yq.at[1:].add(per0[:-1])
            y = yq.reshape(t, b)
            new_precalc0 = per0[-1]
            new_output0 = per0[-2] if q >= 2 else state.tail_precalc0
        else:
            tail0_state = state.tail0
            new_precalc0, new_output0 = state.tail_precalc0, state.tail_output0

    if cfg.tail is not None:
        big = blocks.reshape(q, tb)
        if tail_chrono is not None:
            hist, pos = tail_chrono
            tail_state, hist, pos, out_t = uniform.stream_conv_chrono_unguarded(
                cfg.tail, state.tail, hist, pos, big, kern_hat=kh_tail
            )
            new_chrono = (hist, pos)
        else:
            tail_state, out_t = big_stream(cfg.tail, state.tail, big)
        # two-period delay line, slot-wise into the period view of y
        # (no concatenated [T, B] temp — same fold as farm2_stream's)
        yq = y.reshape(q, tb)
        yq = yq.at[0].add(state.tail_precalc)
        if q >= 2:
            yq = yq.at[1].add(state.tail_output)
        if q > 2:
            yq = yq.at[2:].add(out_t[:-2])
        y = yq.reshape(t, b)
        new_output = out_t[-1]
        new_precalc = out_t[-2] if q >= 2 else state.tail_output
    else:
        # absent main tail: its precalc/output buffers are permanently zero
        tail_state = state.tail
        new_precalc, new_output = state.tail_precalc, state.tail_output

    out_state = TwoStageState(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=new_output0,
        tail_precalc0=new_precalc0,
        tail_output=new_output,
        tail_precalc=new_precalc,
        tail_input=blocks[t - p:].reshape(tb),
        tail_fill=jnp.zeros((), jnp.int32),
        precalc_pos=jnp.zeros((), jnp.int32),
    )
    if tail_chrono is not None:
        return out_state, new_chrono, y
    return out_state, y
