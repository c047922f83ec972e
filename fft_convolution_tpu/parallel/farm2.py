"""Two-stage reverb farm: many voices x long IRs, production configuration.

The uniform farm (``farm.py``) is O(ir_len) per voice-block; for 60 s IRs
the two-stage engine cuts per-voice compute ~20x and shrinks the streaming
working set.  Voice count per device is bounded by the IR spectra themselves
instead of the uniform farm's ~45L bytes/voice.

Stage layout is chosen per axis order the hardware wants:

* **head / tail0** (small blocks, many rows of tiny spectra):
  VOICE-LEADING ``[V, ...]`` states run through ONE fused conv stream
  (:func:`_heads_fused`): with the big tail present both stages see the
  same input at the same block size and segment count, so they share a
  single ring history and a single forward/inverse time-DFT pipeline —
  and since the period equals the head segment count, tail0's one-period
  output delay folds into a COMBINED 2n-segment kernel
  (:func:`_combined_head_kernel`): one meta-product, one inverse.
  The tail0 state's ring leaf is DEAD inside farm2 (head's ring is the
  shared source of truth — see :func:`_heads_fused`).
* **big tail** (few steps, huge rows): a planes-outer FUSED-voice
  ``[2, rows, V*B]`` state driven by the roll-free phased correlation
  core (:func:`_tail_corr_phased_fused`).  The fused trailing axis is the
  load-bearing choice: with a separate voice axis, XLA's layout
  assignment can re-lay out the multi-GB ring/table for the loop interior
  (propagated from the DFT dots), materializing full-size entry/exit
  copies of both.  Fusing ``V*B`` removes the axis XLA wants to move,
  the plane pair outermost makes ``a[0]/a[1]`` contiguous halves instead
  of strided slices, and the phase-window dynamic slice cuts the rows
  axis.

All stage cores are *unguarded* (clean full rings are a farm invariant:
this farm exposes init + stream + batched full-capacity update, never a
ring-shrinking update).

Multi-device: head/tail0 leaves stack along the voice axis (axis 0); the
tail's big leaves shard along the fused ``V*B`` axis, which is voice-
chunked exactly when ``V`` divides by the mesh — :func:`farm2_shard`
places both over a ``('dp',)`` mesh with zero steady-state collectives.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import two_stage, uniform
from ..ops.cpx import pmul_sum
from ..ops.fft import (causal_conv_khat, causal_conv_time, ir_to_spectra,
                       irdft_block, irdft_pair, next_power_of_two,
                       rdft_block)
from ..ops.packing import pack_c32, pack_c32_planes, unpack_c32
from . import farm



def _tail_ext_index(n_t: int):
    """The doubled periodic tail table's row layout — ``2*n_t + E`` rows
    with row ``x`` holding IR segment ``x mod n_t``.  ONE definition:
    the phased core's window indexing, the batched update's rebuild, the
    per-voice update's slab build, and direct init all consume it, and a
    drifted copy would silently desynchronize them (the layout is
    load-bearing for ``_tail_corr_phased_fused``)."""
    rows = 2 * n_t + uniform.CORR_EXTRA_ROWS
    return rows, jnp.arange(rows) % n_t


def _fuse_po(a: jnp.ndarray) -> jnp.ndarray:
    """``[V, rows, 2, B] -> [2, rows, V*B]`` (planes-outer fused-voice)."""
    v, rows, _, b = a.shape
    return jnp.transpose(a, (2, 1, 0, 3)).reshape(2, rows, v * b)


def _init_tail_fused_direct(padded_tail: np.ndarray, tb: int,
                            tail_cfg: uniform.UniformConfig,
                            chunk: int = 8,
                            dtype=jnp.float32) -> uniform.UniformState:
    """Build the planes-outer fused-voice tail state STRAIGHT from the IR
    slice, in voice chunks written in place into the final doubled table
    (donated ``dynamic_update_slice``).

    The two-hop route (``farm.farm_init`` then :func:`_tail_fused_state`)
    materializes the voice-leading spectra table AND the padded IR slice
    as multi-GB device intermediates.  Direct construction peaks at
    table + ring + one voice-chunk transient.

    ``dtype=jnp.bfloat16`` builds PLANE-PACKED storage (ops/packing.py):
    big leaves are ``[rows, V*B]`` uint32 words instead of
    ``[2, rows, V*B]`` planes.
    """
    v, lt = padded_tail.shape
    n_t = tail_cfg.seg_count
    rows, ext_idx = _tail_ext_index(n_t)
    vb = v * tb
    packed = dtype == jnp.bfloat16

    pad_to = n_t * tb - lt

    @functools.partial(jax.jit, donate_argnums=(0,))
    def write(tab, chunk_ir, c0):
        spec = jax.lax.map(
            lambda r: ir_to_spectra(jnp.pad(r, (0, pad_to)), tb, n_t),
            chunk_ir,
        )                                               # [C, n, 2, B]
        ext = jnp.take(spec, ext_idx, axis=1)           # [C, rows, 2, B]
        c = chunk_ir.shape[0]
        fused = jnp.transpose(ext, (2, 1, 0, 3)).reshape(2, rows, c * tb)
        if packed:
            return jax.lax.dynamic_update_slice(
                tab, pack_c32_planes(fused), (0, c0)
            )
        return jax.lax.dynamic_update_slice(
            tab, fused.astype(dtype), (0, 0, c0)
        )

    if packed:
        table = jnp.zeros((rows, vb), jnp.uint32)
    else:
        table = jnp.zeros((2, rows, vb), dtype)
    for c0 in range(0, v, chunk):
        piece = np.ascontiguousarray(padded_tail[c0: c0 + chunk])
        table = write(table, jnp.asarray(piece), jnp.asarray(c0 * tb, jnp.int32))

    return uniform.UniformState(
        segments=(jnp.zeros((n_t, vb), jnp.uint32) if packed
                  else jnp.zeros((2, n_t, vb), dtype)),
        segments_ir=table,
        overlap=jnp.zeros((v, tb), jnp.float32),
        input_buffer=jnp.zeros((v, tb), jnp.float32),
        pre_multiplied=jnp.zeros((2, vb), jnp.float32),
        current=jnp.zeros((), jnp.int32),
        input_fill=jnp.zeros((), jnp.int32),
        active_segs=jnp.full((), n_t, jnp.int32),
    )


@functools.partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
def _tail_fused_state(tail_state_v: uniform.UniformState,
                      n_t: int) -> uniform.UniformState:
    """Convert a voice-leading tail stage state (from ``farm.farm_init``)
    to the farm2-internal planes-outer fused-voice phased convention: big
    leaves ``[2, rows, V*B]`` (see module docstring for why this exact
    shape), doubled periodic IR table, lockstep scalars.

    Jitted with the input donated: at production voice counts the doubled
    table is ~6 GB, and one fused program lets XLA build it straight from
    the donated voice-leading spectra instead of materializing the
    concatenated intermediate as a second multi-GB buffer."""
    ext_idx = jnp.arange(n_t + uniform.CORR_EXTRA_ROWS) % n_t
    table_v = tail_state_v.segments_ir                     # [V, n, 2, B]
    table_v = jnp.concatenate(
        [table_v, jnp.take(table_v, ext_idx, axis=1)], axis=1
    )                                                      # [V, 2n+E, 2, B]
    return uniform.UniformState(
        segments=_fuse_po(tail_state_v.segments),          # [2, n, VB]
        segments_ir=_fuse_po(table_v),                     # [2, 2n+E, VB]
        overlap=tail_state_v.overlap,                      # [V, B]
        input_buffer=tail_state_v.input_buffer,            # [V, B]
        pre_multiplied=jnp.swapaxes(tail_state_v.pre_multiplied, 0, 1)
        .reshape(2, -1),                                   # [2, VB]
        current=tail_state_v.current[0],                   # phase (lockstep)
        input_fill=tail_state_v.input_fill[0],
        active_segs=tail_state_v.active_segs[0],
    )


# tail periods per stream call, keyed by the tail's storage bytes per
# plane (4: f32, 2: packed bf16) — the call length the capacity model
# and the benchmark's farm cells assume
DEFAULT_PERIODS_PER_CALL = {4: 8, 2: 2}

# device memory the "auto" capacity budget leaves free for the input and
# output stream, DFT bases and compiled executables
BUDGET_HEADROOM_BYTES = 2e9


def device_budget_bytes(device=None):
    """The farm's ``"auto"`` capacity budget in bytes: the device's
    allocatable memory (``memory_stats()["bytes_limit"]``) less
    :data:`BUDGET_HEADROOM_BYTES`, or ``None`` where the device reports
    no memory statistics (the CPU backend)."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return float(stats["bytes_limit"]) - BUDGET_HEADROOM_BYTES


def farm2_bytes_per_voice(block: int, ir_len: int, t_blocks: int,
                          tail_item: int = 4) -> int:
    """HBM bytes per farm2 voice, derived from the engine shapes instead of
    a hand-measured constant — the capacity model behind
    :func:`farm2_init`'s eager guard and ``benchmarks/configs.py``'s voice
    sizing (the reference analogue is the init-contract panic,
    ``src/fft_convolver.rs:106-110``: refuse impossible configurations at
    construction, not mid-stream).

    Exact state: three uniform stages (input-spectra ring + IR table; the
    big tail's table is the DOUBLED periodic table of the phased corr core,
    2N + CORR_EXTRA_ROWS rows) plus the five tail-period buffers.
    Estimated transients: the head stages' time-DFT intermediates (~6
    arrays at the padded block-axis length M) and ~1 ring-sized temporary
    in the tail correlation core (an IR window that fails to fuse; the
    roll-free phased core has no ring copy — the rebased core's roll cost
    TWO extra ring-size buffers, confirmed by the r2 OOM dump at 137
    voices).  The stream donates its state, so the state is NOT doubled
    per call.  A 1.08 factor covers layout padding of the big arrays.

    ``t_blocks`` is the stream call length the transients scale with;
    ``tail_item=2`` models the plane-packed bf16 table's per-plane-
    equivalent bytes (both storage widths are 32-bit words).
    """
    tb = two_stage.compute_tail_block_size(block, ir_len)

    def stage(n_segs: int, b: int, extra_ir_rows: int = 0, item: int = 4) -> int:
        ring = n_segs * 2 * b * item
        ir_tab = (n_segs + extra_ir_rows) * 2 * b * item
        return ring + ir_tab + 4 * b * 4   # + overlap/input/pre buffers

    # the big tail pads to a multiple of 8 segments (farm2_init)
    sub = 8
    n_h = -(-min(ir_len, tb) // block)
    n_t0 = -(-min(max(ir_len - tb, 0), tb) // block)
    n_t = -(- -(-max(ir_len - 2 * tb, 0) // tb) // sub) * sub
    state = (
        stage(n_h, block) + stage(n_t0, block)
        + stage(n_t, tb, extra_ir_rows=n_t + uniform.CORR_EXTRA_ROWS,
                item=tail_item)
        + 5 * tb * 4
    )
    m = next_power_of_two(2 * max(n_h, n_t0) - 1 + t_blocks)
    # the khat-served stream keeps the head-kernel meta-spectra resident:
    # ONE combined 2n-segment kernel x [m, B] x (re, im) f32 per voice
    # (farm2_head_khat of _combined_head_kernel)
    state += m * block * 4 * 2
    transients = 6 * m * 2 * block * 4          # one combined head pipeline
    transients += 1 * n_t * 2 * tb * 4          # tail corr-core temp
    return int((state + transients) * 1.08)


def farm2_init(irs, block_size: int, max_response_length: int,
               tail_dtype=jnp.float32, hbm_budget_bytes="auto",
               ) -> Tuple[two_stage.TwoStageConfig, two_stage.TwoStageState]:
    """Initialize V two-stage voices from ``irs [V, ir_len]``; returns the
    shared static config and a stacked state pytree.

    Mirrors ``TwoStageFFTConvolver::init`` (``src/fft_convolver.rs:340-406``)
    per voice, with each stage built through the batched farm initializer
    (one batched DFT per stage instead of V python loops).

    ``tail_dtype=jnp.bfloat16`` stores the big tail's IR table and input
    ring at bf16 precision (all arithmetic stays f32): the tail MAC is
    pure HBM bandwidth, so this halves both the dominant per-call traffic
    and the per-voice memory (~2x loadable voices).  Storage is
    PLANE-PACKED uint32 words — re/im bf16 halves of each bin in one
    32-bit word (ops/packing.py).  Accuracy: the tail contribution carries bf16's ~3 significant
    decimal digits (~1e-3 relative) instead of the f32 engines' 1e-5
    parity — appropriate for the reverb-tail part of the response,
    opt-in for throughput serving.

    ``hbm_budget_bytes`` — eager capacity guard (the init-contract-panic
    analogue, ``src/fft_convolver.rs:106-110``): a farm whose estimated
    footprint (:func:`farm2_bytes_per_voice` x V) exceeds the budget
    raises an actionable ``ValueError`` instead of dying later as an
    opaque device RESOURCE_EXHAUSTED.  ``"auto"`` uses
    :func:`device_budget_bytes` (the device's allocatable memory less
    headroom; no check where the device reports no memory statistics,
    as the CPU backend does); pass a number to pin the budget
    (per-device budget for sharded farms), or ``None`` to disable.
    """
    irs = np.asarray(irs, np.float32)
    v = irs.shape[0]
    if max_response_length < irs.shape[1]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    if hbm_budget_bytes == "auto":
        hbm_budget_bytes = device_budget_bytes()
    if hbm_budget_bytes is not None:
        tail_item = 2 if tail_dtype == jnp.bfloat16 else 4
        # transient model at the default call length per storage
        # (DEFAULT_PERIODS_PER_CALL)
        q_est = DEFAULT_PERIODS_PER_CALL[tail_item]
        tb_est = two_stage.compute_tail_block_size(
            block_size, max_response_length
        )
        per_voice = farm2_bytes_per_voice(
            block_size, max_response_length,
            q_est * (tb_est // block_size), tail_item,
        )
        est = v * per_voice
        if est > hbm_budget_bytes:
            fit = max(1, int(hbm_budget_bytes // per_voice))
            raise ValueError(
                f"farm of {v} voices x {max_response_length} samples needs "
                f"~{est / 1e9:.2f} GB (~{per_voice / 1e6:.1f} MB/voice incl. "
                f"stream transients) > the {hbm_budget_bytes / 1e9:.2f} GB "
                f"device budget — ~{fit} voices fit this budget"
                + ("" if tail_item == 2 else
                   "; tail_dtype=jnp.bfloat16 roughly halves the tail table")
                + ". Shard over a mesh (ReverbFarm(mesh=...)) for more, or "
                "pass hbm_budget_bytes=<bytes>/None to retune/disable this "
                "check (farm2_bytes_per_voice is the model)."
            )
    head_block = block_size
    tb = two_stage.compute_tail_block_size(block_size, max_response_length)
    padded = np.zeros((v, max_response_length), np.float32)
    padded[:, : irs.shape[1]] = irs

    head_len = min(max_response_length, tb)
    head_cfg, head_state = farm.farm_init(padded[:, :head_len], head_block, head_len)

    if max_response_length > tb:
        t0_len = min(max_response_length - tb, tb)
        tail0_cfg, tail0_state = farm.farm_init(
            padded[:, tb : tb + t0_len], head_block, t0_len
        )
    else:
        tail0_cfg = None
        _, t0s = uniform.empty(head_block)
        tail0_state = jax.tree.map(lambda l: jnp.broadcast_to(l, (v,) + l.shape), t0s)

    if max_response_length > 2 * tb:
        # pad the big tail to a multiple of 8 segments: trailing zero
        # segments are live-but-silent exactly like init's zero padding
        # (src/fft_convolver.rs:111-118)
        sub = 8
        t_len = -(-(max_response_length - 2 * tb) // (sub * tb)) * (sub * tb)
        tail_cfg = uniform.make_config(tb, t_len)
        tail_state = _init_tail_fused_direct(
            padded[:, 2 * tb :], tb, tail_cfg, dtype=tail_dtype
        )
    else:
        tail_cfg = None
        _, ts = uniform.empty(tb)
        tail_state = jax.tree.map(lambda l: jnp.broadcast_to(l, (v,) + l.shape), ts)

    cfg = two_stage.TwoStageConfig(
        head_block=head_block, tail_block=tb,
        head=head_cfg, tail0=tail0_cfg, tail=tail_cfg,
    )
    # distinct arrays per field: donation rejects one buffer donated twice
    def zeros_t():
        return jnp.zeros((v, tb), jnp.float32)

    state = two_stage.TwoStageState(
        head=head_state, tail0=tail0_state, tail=tail_state,
        tail_output0=zeros_t(), tail_precalc0=zeros_t(),
        tail_output=zeros_t(), tail_precalc=zeros_t(),
        tail_input=zeros_t(),
        tail_fill=jnp.zeros((v,), jnp.int32),
        precalc_pos=jnp.zeros((v,), jnp.int32),
    )
    return cfg, state


def farm2_update(cfg: two_stage.TwoStageConfig, state: two_stage.TwoStageState,
                 new_irs) -> two_stage.TwoStageState:
    """Batched RT-safe IR swap for the whole farm — the farm analogue of
    ``TwoStageFFTConvolver.update_extension`` (the reference ``update`` is
    ``todo!()``, ``src/fft_convolver.rs:408-410``; stage-wise semantics as
    :func:`models.two_stage.update`).

    Keeps every voice's input history and period phase, zeroes the pending
    precalculated tail outputs, and keeps every ring CLEAN (the unguarded
    stream cores' precondition) by declaring each stage's new IR at full
    stage capacity: ``new_irs`` is zero-padded per stage, and trailing
    zero-spectrum segments are live-but-silent exactly like init's padding
    (``src/fft_convolver.rs:111-118``).  Outputs therefore match per-voice
    engines updated with the response ZERO-PADDED TO CAPACITY — not the
    reference's shrinking update, whose smaller ``active_seg_count``
    re-indexes the ring history (``(current + i) % active``,
    ``src/fft_convolver.rs:248``) and pairs past input with different lags;
    the full-capacity form keeps every history block at its true delay
    (the linear-convolution splice), which is also what the farm's
    full-ring invariant requires.

    Call at a period boundary (``tail_fill == 0``) — the same invariant
    :func:`farm2_stream` keeps.  ``new_irs``: ``[V, L]`` with ``L`` at most
    the init ``max_response_length``.  Jittable; jit with
    ``donate_argnums`` on the state so the big-tail table rebuild (a
    voice-chunked scan) lands in place — without donation it costs one
    table-sized copy.
    """
    new_irs = jnp.asarray(new_irs, jnp.float32)
    v = new_irs.shape[0]
    tb = cfg.tail_block

    def stage_slice(lo: int, cap: int, total: int) -> jnp.ndarray:
        sl = new_irs[:, lo: lo + cap]
        return jnp.pad(sl, ((0, 0), (0, total - sl.shape[1])))

    cap_h = cfg.head.ir_len
    head = farm.farm_update(
        cfg.head, state.head,
        stage_slice(0, cap_h, cfg.head.seg_count * cfg.head.block_size),
        jnp.full((v,), cap_h, jnp.int32),
    )

    if cfg.tail0 is not None:
        cap0 = cfg.tail0.ir_len
        tail0 = farm.farm_update(
            cfg.tail0, state.tail0,
            stage_slice(tb, cap0, cfg.tail0.seg_count * cfg.tail0.block_size),
            jnp.full((v,), cap0, jnp.int32),
        )
    else:
        tail0 = state.tail0

    if cfg.tail is not None:
        n_t = cfg.tail.seg_count
        rows, ext_idx = _tail_ext_index(n_t)
        # rebuild the fused-voice doubled periodic table IN PLACE via a
        # voice-chunked scan (the whole-farm spectra + doubled table as
        # one expression peaked at ~9 GB of temps on top of live state at
        # production voice counts); the scan carry donates, so the peak
        # is one chunk's transient.  Chunk = largest divisor of V <= 8.
        # The chunk's tail slice is cut from new_irs INSIDE the scan body
        # (a [chunk, L] dynamic slice), not pre-padded for the whole farm —
        # a [V, n_t*tb] temp would add ~1.4 GB on top of the donated input
        # at V=128/60 s.
        chunk = next(c for c in range(min(8, v), 0, -1) if v % c == 0)
        lo_t = 2 * tb
        cap_t = min(cfg.tail.ir_len, max(new_irs.shape[1] - lo_t, 0))
        ir_len = new_irs.shape[1]

        def body(tab, idx):
            ch = jax.lax.dynamic_slice(
                new_irs, (idx * chunk, 0), (chunk, ir_len)
            )[:, lo_t: lo_t + cap_t]
            ch = jnp.pad(ch, ((0, 0), (0, n_t * tb - cap_t)))
            spec = jax.lax.map(
                lambda r: ir_to_spectra(r, tb, n_t), ch
            )                                           # [C, n, 2, B]
            ext = jnp.take(spec, ext_idx, axis=1)       # [C, rows, 2, B]

            def plane_slab(p):
                # [C, rows, B] -> [rows, C*B] per plane, without a
                # plane-axis-moving rank-4 transpose: a [2, rows, L] slab
                # operand inside the scan can make layout assignment
                # re-lay out the WHOLE multi-GB table
                return jnp.transpose(ext[:, :, p, :], (1, 0, 2)).reshape(
                    rows, chunk * tb
                )

            if tab.dtype == jnp.uint32:  # plane-packed bf16 storage
                tab = jax.lax.dynamic_update_slice(
                    tab, pack_c32(plane_slab(0), plane_slab(1)),
                    (0, idx * (chunk * tb))
                )
            else:
                for plane in range(2):
                    tab = jax.lax.dynamic_update_slice(
                        tab, plane_slab(plane)[None].astype(tab.dtype),
                        (plane, 0, idx * (chunk * tb))
                    )
            return tab, None

        table, _ = jax.lax.scan(
            body, state.tail.segments_ir,
            jnp.arange(v // chunk, dtype=jnp.int32),
        )
        tail = state.tail._replace(
            segments_ir=table,
            overlap=jnp.zeros_like(state.tail.overlap),
            pre_multiplied=jnp.zeros_like(state.tail.pre_multiplied),
        )
    else:
        tail = state.tail

    def zeros_t():
        return jnp.zeros_like(state.tail_input)

    # precalc_pos == 1 flags the next farm2_stream call to suppress the
    # first period's tail0 contribution (stage-wise update semantics —
    # see _heads_fused's suppress_first); only meaningful for the
    # big-tail farm (the short-IR farm streams per voice, where
    # precalc_pos is the real period counter and must stay 0)
    pos = (jnp.ones_like(state.precalc_pos) if cfg.tail is not None
           else state.precalc_pos)
    return state._replace(
        head=head, tail0=tail0, tail=tail,
        tail_output0=zeros_t(), tail_precalc0=zeros_t(),
        tail_output=zeros_t(), tail_precalc=zeros_t(),
        precalc_pos=pos,
    )


def farm2_update_voices(cfg: two_stage.TwoStageConfig,
                        state: two_stage.TwoStageState,
                        voice_idx, new_irs) -> two_stage.TwoStageState:
    """Per-voice RT-safe IR swap: :func:`farm2_update` semantics for a
    SUBSET of voices, at O(K/V) of the full rebuild's cost — the
    fleet-scale form of the reference's cheap ``update`` contract
    (``src/fft_convolver.rs:174-213``: one client swaps one IR without
    touching the other hundred).

    ``voice_idx``: ``[K]`` int32 in ``[0, V)`` (traced OK).  Duplicate
    indices are SUPPORTED iff their payload rows are identical — every
    write below is an idempotent set/``dynamic_update_slice``, so
    repeated (index, row) pairs land the same bytes twice.  This is a
    load-bearing contract: the ``ReverbFarm`` wrapper pads ``K`` to a
    power of two by repeating the last entry to bound its jit cache.
    Any future accumulate-style write (``.at[].add``) here must dedupe
    first.  Distinct indices with DIFFERENT payloads remain the caller's
    responsibility (the wrapper validates).
    ``new_irs``: ``[K, L]`` with ``L`` at most the init capacity.  Only
    the touched voices' head/tail0 table rows, the big tail's ``K`` column
    slabs in the fused ``[.., V*B]`` table, and their pending delay-line
    rows are written; all rings (input history) and the lockstep phase
    scalars are untouched, so the other voices' streams are bit-identical
    to a farm that never updated.

    ``precalc_pos`` rows of the touched voices are set to 1: the next
    :func:`farm2_stream` call suppresses the FIRST period's tail0
    contribution for exactly those voices (stage-wise update semantics
    zero the tail0 double-buffer — see :func:`_heads_fused`).

    Call at a period boundary, like :func:`farm2_update`.  Jittable; jit
    with ``donate_argnums`` on the state so the slab writes land in place.
    The tail slabs unroll as ``K`` sequential writes (compile time and
    program size are O(K)) — this is the SMALL-K fast path; for K near V
    use :func:`farm2_update`, whose chunked donated scan batches the
    spectra (the ``ReverbFarm`` wrapper routes K == V there and buckets
    other K to powers of two so the jit cache stays bounded).
    """
    new_irs = jnp.asarray(new_irs, jnp.float32)
    voice_idx = jnp.asarray(voice_idx, jnp.int32)
    k = new_irs.shape[0]
    ir_len = new_irs.shape[1]
    tb = cfg.tail_block

    def stage_slice(lo: int, cap: int, total: int) -> jnp.ndarray:
        sl = new_irs[:, lo: lo + cap]
        return jnp.pad(sl, ((0, 0), (0, total - sl.shape[1])))

    def stage_update(ucfg: uniform.UniformConfig, stage: uniform.UniformState,
                     lo: int) -> uniform.UniformState:
        cap = min(ucfg.ir_len, max(ir_len - lo, 0))
        padded = stage_slice(lo, cap, ucfg.seg_count * ucfg.block_size)
        spec = jax.vmap(
            lambda r: ir_to_spectra(r, ucfg.block_size, ucfg.seg_count)
        )(padded)                                      # [K, n, 2, B]
        return stage._replace(
            segments_ir=stage.segments_ir.at[voice_idx].set(spec),
            overlap=stage.overlap.at[voice_idx].set(0.0),
            pre_multiplied=stage.pre_multiplied.at[voice_idx].set(0.0),
        )

    head = stage_update(cfg.head, state.head, 0)
    tail0 = (stage_update(cfg.tail0, state.tail0, tb)
             if cfg.tail0 is not None else state.tail0)

    if cfg.tail is not None:
        n_t = cfg.tail.seg_count
        rows, ext_idx = _tail_ext_index(n_t)
        del rows  # slab writes span the full table height implicitly
        lo_t = 2 * tb
        cap_t = min(cfg.tail.ir_len, max(ir_len - lo_t, 0))
        table = state.tail.segments_ir
        pre_t = state.tail.pre_multiplied
        packed = table.dtype == jnp.uint32
        # batch the tail spectra builds in chunks (one batched DFT per
        # chunk, like stage_update's head build) instead of one serial
        # ir_to_spectra per voice — chunking keeps the transient at <= 8
        # voices' spectra while the build itself batches; only the table
        # SLAB WRITES stay sequential (per-plane dynamic_update_slice)
        chunk = min(k, 8)
        for c0 in range(0, k, chunk):
            c = min(chunk, k - c0)
            irs_c = jnp.pad(new_irs[c0: c0 + c, lo_t: lo_t + cap_t],
                            ((0, 0), (0, n_t * tb - cap_t)))
            exts = jax.vmap(
                lambda r: jnp.take(ir_to_spectra(r, tb, n_t), ext_idx,
                                   axis=0)
            )(irs_c)                              # [c, rows, 2, tb]
            if packed:
                words = pack_c32(exts[:, :, 0, :], exts[:, :, 1, :])
            for j in range(c0, c0 + c):
                col = voice_idx[j] * tb
                if packed:
                    table = jax.lax.dynamic_update_slice(
                        table, words[j - c0],
                        (jnp.asarray(0, jnp.int32), col),
                    )
                else:
                    # per-plane [1, rows, tb] writes (the layout hazard
                    # farm2_update documents)
                    for plane in range(2):
                        table = jax.lax.dynamic_update_slice(
                            table, exts[j - c0, :, plane, :][None],
                            (jnp.asarray(plane, jnp.int32),
                             jnp.asarray(0, jnp.int32), col),
                        )
                pre_t = jax.lax.dynamic_update_slice(
                    pre_t, jnp.zeros((2, tb), jnp.float32),
                    (jnp.asarray(0, jnp.int32), col),
                )
        tail = state.tail._replace(
            segments_ir=table, pre_multiplied=pre_t,
            overlap=state.tail.overlap.at[voice_idx].set(0.0),
        )
    else:
        tail = state.tail

    def zero_rows(a):
        return a.at[voice_idx].set(0.0)

    pos = (state.precalc_pos.at[voice_idx].set(1) if cfg.tail is not None
           else state.precalc_pos)
    return state._replace(
        head=head, tail0=tail0, tail=tail,
        tail_output0=zero_rows(state.tail_output0),
        tail_precalc0=zero_rows(state.tail_precalc0),
        tail_output=zero_rows(state.tail_output),
        tail_precalc=zero_rows(state.tail_precalc),
        precalc_pos=pos,
    )


def _lane0_fused(vb: int, b: int) -> jnp.ndarray:
    """1.0 at each voice's DC lane (position 0 mod ``b``) in the fused
    ``V*B`` axis — the per-voice DC/Nyquist packing mask."""
    return (jnp.arange(vb) % b == 0).astype(jnp.float32)


def _pmul_sum_fused(a: jnp.ndarray, b: jnp.ndarray, m0: jnp.ndarray) -> jnp.ndarray:
    """Packed-product sum over the rows axis in the planes-outer fused
    layout: ``a, b`` are ``[2, N, VB]``; returns ``[2, VB]``.  Same
    DC/Nyquist lane-0 packing as :func:`ops.cpx.pmul_sum`, with the mask
    repeated per voice (``m0 = _lane0_fused``).

    The per-lane mask is row-independent, so it distributes over the row
    sum: combining terms BEFORE reducing leaves two reductions over two
    derived arrays (instead of four), which XLA fuses into a single pass
    over the ring and window — the MAC is HBM-bound and every extra pass
    over the multi-GB operands is wall time.  Operands may be bf16-stored
    (the farm's opt-in tail dtype); arithmetic is f32."""
    ar, ai = a[0].astype(jnp.float32), a[1].astype(jnp.float32)
    br, bi = b[0].astype(jnp.float32), b[1].astype(jnp.float32)
    cross = ai * bi
    re = jnp.sum(ar * br - cross * (1.0 - m0), axis=0)
    im = jnp.sum((ar * bi + ai * br) * (1.0 - m0) + cross * m0, axis=0)
    return jnp.stack([re, im], axis=0)


def _pmul_sum_packed(aw: jnp.ndarray, bw: jnp.ndarray,
                     m0: jnp.ndarray) -> jnp.ndarray:
    """:func:`_pmul_sum_fused` over plane-packed uint32 operands
    ``[N, VB]`` (ops/packing.py): the unpack is elementwise integer ops
    that XLA fuses into the same single reduction pass."""
    ar, ai = unpack_c32(aw)
    br, bi = unpack_c32(bw)
    cross = ai * bi
    re = jnp.sum(ar * br - cross * (1.0 - m0), axis=0)
    im = jnp.sum((ar * bi + ai * br) * (1.0 - m0) + cross * m0, axis=0)
    return jnp.stack([re, im], axis=0)


def _tail_corr_phased_fused(cfg: uniform.UniformConfig,
                            state: uniform.UniformState,
                            blocks_rows: jnp.ndarray,
                            precision=jax.lax.Precision.HIGHEST,
                            ) -> Tuple[uniform.UniformState, jnp.ndarray]:
    """Planes-outer fused-voice batched phased correlation core — the farm
    big-tail engine.  Index math identical to
    :func:`models.uniform.stream_corr_phased_unguarded` (see its docstring
    for the derivation); the big arrays carry the packed plane pair
    outermost and the voice/lane axes FUSED (module docstring explains why
    this is the only copy-free layout):

    * ``state.segments``    ``[2, N, V*B]``    (phased ring)
    * ``state.segments_ir`` ``[2, 2N+E, V*B]`` (doubled periodic table)
    * ``state.current``     ``[]`` phase scalar (voices in lockstep)
    * ``blocks_rows``       ``[T, V, B]``
    """
    b = cfg.block_size
    n = cfg.seg_count
    t_blocks, v = blocks_rows.shape[0], blocks_rows.shape[1]
    assert t_blocks <= min(n, uniform.CORR_EXTRA_ROWS), (
        f"correlation core supports at most min(seg_count, "
        f"{uniform.CORR_EXTRA_ROWS}) blocks per call (got {t_blocks}, "
        f"seg_count {n})"
    )
    bs = cfg.fft_size // 2
    # [T, V, 2, Bs] -> planes-outer fused [T, 2, V*Bs] (input-sized
    # transpose, negligible next to the ring/table reads)
    specs = jnp.swapaxes(rdft_block(blocks_rows, cfg.fft_size, precision), 1, 2)
    specs = specs.reshape(t_blocks, 2, v * bs)
    ext2 = state.segments_ir           # [2, 2N+E, VB] (packed: [2N+E, VB])
    u = state.segments                 # [2, N, VB]    (packed: [N, VB])
    q = state.current
    m0 = _lane0_fused(v * bs, bs)
    packed = u.dtype == jnp.uint32     # plane-packed bf16 (ops/packing.py)

    vb = v * bs
    # base sums acc[t] = sum_x U[x] (*) ext2[q+t+x], per-step dynamic
    # windows: XLA fuses each slice into its consumer instead of
    # materializing a shared multi-GB window
    if packed:
        base = jnp.stack([
            _pmul_sum_packed(
                jax.lax.dynamic_slice_in_dim(ext2, q + t, n, axis=0),
                u, m0
            )
            for t in range(t_blocks)
        ])
    else:
        base = jnp.stack([
            _pmul_sum_fused(
                jax.lax.dynamic_slice_in_dim(ext2, q + t, n, axis=1),
                u, m0
            )
            for t in range(t_blocks)
        ])

    # corrections, planes-separate: every read of the big arrays here
    # is a single (plane, row) 1-D extraction — contiguous in the
    # default layout, so no layout preference propagates back to the
    # multi-GB table.  Packed storage has no plane axis: one uint32 row
    # read, unpacked in the consumer.
    def row1(a, plane, r):
        """a[plane, r] as a 1-D f32 [VB] read (r may be traced)."""
        return jax.lax.dynamic_slice(
            a, (plane, r, 0) if isinstance(r, int) else
               (jnp.asarray(plane, jnp.int32), r,
                jnp.asarray(0, jnp.int32)),
            (1, 1, vb),
        ).reshape(vb).astype(jnp.float32)

    def rows2(a, r):
        """(re, im) of row ``r``: packed word row unpacked, or the
        two plane reads."""
        if packed:
            w = jax.lax.dynamic_slice(
                a, (jnp.asarray(r, jnp.int32), jnp.asarray(0, jnp.int32)),
                (1, vb),
            ).reshape(vb)
            return unpack_c32(w)
        return row1(a, 0, r), row1(a, 1, r)

    convs = []
    for t in range(t_blocks):
        acc_re, acc_im = base[t, 0], base[t, 1]
        for s in range(t + 1):
            row_s = jnp.mod(n - q - s, n)
            u_re, u_im = rows2(u, row_s)
            dre = specs[s, 0] - u_re
            dim = specs[s, 1] - u_im
            kr, ki = rows2(ext2, t - s)
            cross = dim * ki
            acc_re = acc_re + dre * kr - cross * (1.0 - m0)
            acc_im = (acc_im + (dre * ki + dim * kr) * (1.0 - m0)
                      + cross * m0)
        convs.append(jnp.stack([acc_re, acc_im]))
    convs = jnp.stack(convs)                      # [T, 2, VB]

    k0r, k0i = rows2(ext2, 0)
    sr, si = specs[-1, 0], specs[-1, 1]
    cross0 = si * k0i
    pre = convs[-1] - jnp.stack([
        sr * k0r - cross0 * (1.0 - m0),
        (sr * k0i + si * k0r) * (1.0 - m0) + cross0 * m0,
    ])

    for s in range(t_blocks):
        row_s = jnp.mod(n - q - s, n)
        if packed:
            u = jax.lax.dynamic_update_slice_in_dim(
                u, pack_c32_planes(specs[s])[None], row_s, axis=0
            )
        else:
            u = jax.lax.dynamic_update_slice_in_dim(
                u, specs[s][:, None].astype(u.dtype), row_s, axis=1
            )

    # feed the inverse the two planes directly from the planes-outer
    # layout — a [T, 2, V, Bs] -> [T, V, 2, Bs] swap would copy the
    # whole output array per call
    c4 = convs.reshape(t_blocks, 2, v, bs)
    outs = irdft_pair(c4[:, 0], c4[:, 1], cfg.fft_size, precision)
    # outs: [T, V, 2B]
    tails = jnp.concatenate([state.overlap[None], outs[:-1, :, b:]], axis=0)
    y = outs[:, :, :b] + tails                        # [T, V, B]
    return state._replace(
        segments=u, pre_multiplied=pre,
        current=jnp.mod(q + t_blocks, n).astype(jnp.int32),
        overlap=outs[-1, :, b:],
    ), y


def _combined_head_kernel(st_h: uniform.UniformState,
                          st_t0: uniform.UniformState) -> jnp.ndarray:
    """The COMBINED head+tail0 kernel table ``[V, 2n, 2, B]``.

    With the big tail present, head and tail0 run at the same block size
    over the same input with ``head_len == t0_len == tail_block``, so the
    period is exactly ``n = seg_count`` head blocks — and tail0's
    one-PERIOD output delay equals a kernel shift of ``n`` segments in the
    frequency-delay line: segment ``n + j`` of the concatenated table is
    the spectrum of ``ir[tail_block + j*b ..]`` applied to the input from
    ``n + j`` blocks ago, which is precisely ``delay_1_period(tail0(x))``.
    One 2n-segment FDL therefore produces ``head + delayed tail0`` in ONE
    meta-product + ONE inverse meta-DFT (vs two of each for the stacked
    per-stage tables), at the cost of ``n`` extra rows of input-spectra
    history (carried in the otherwise-dead period buffers)."""
    return jnp.concatenate([st_h.segments_ir, st_t0.segments_ir], axis=1)


def farm2_head_khat(cfg: two_stage.TwoStageConfig,
                    state: two_stage.TwoStageState, t: int,
                    dft_precision: str = "highest",
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Precompute the combined head+tail0 kernel meta-spectra
    (:func:`ops.fft.causal_conv_khat` of :func:`_combined_head_kernel`)
    for ``T = t``-block stream calls.  Input-independent between IR
    updates — one third of the head MAC's matmul work hoisted out of
    every call.  Jittable; pass the result to :func:`farm2_stream` as
    ``head_khat=`` (valid for any ``T`` with the same
    ``next_power_of_two(2 * n - 1 + T)``)."""
    n = cfg.head.seg_count
    m = next_power_of_two(2 * n - 1 + t)
    kern = _combined_head_kernel(state.head, state.tail0)
    return causal_conv_khat(kern, m, _PRECISIONS[dft_precision])


def farm2_head_khat_voices(cfg: two_stage.TwoStageConfig,
                           state: two_stage.TwoStageState, t: int,
                           voice_idx,
                           dft_precision: str = "highest",
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The ``[K]``-voice slab of :func:`farm2_head_khat` — recompute only
    the voices touched by :func:`farm2_update_voices` and scatter the
    result into a cached farm-wide khat (``khat_re.at[voice_idx].set``),
    instead of rebuilding the whole farm's head meta-spectra."""
    voice_idx = jnp.asarray(voice_idx, jnp.int32)
    n = cfg.head.seg_count
    m = next_power_of_two(2 * n - 1 + t)
    kern = jnp.concatenate(
        [state.head.segments_ir[voice_idx],
         state.tail0.segments_ir[voice_idx]], axis=1,
    )                                             # [K, 2n, 2, B]
    return causal_conv_khat(kern, m, _PRECISIONS[dft_precision])


def _heads_state_out(st_h: uniform.UniformState, st_t0: uniform.UniformState,
                     ext: jnp.ndarray, outs: jnp.ndarray, t: int, n: int,
                     hist0: int):
    """Ring-rebuild/exit-state tail of the fused head path (full-ring
    roll fast path, lockstep scalars) — mirrors
    ``models.uniform._stream_conv.rebuild_roll``, batched over voices.
    ``hist0``: number of history rows preceding the new blocks in ``ext``
    (``ext[hist0 + j]`` is new block ``j``).  Farm invariant PRODUCED: only
    the head state's ring and OVERLAP are maintained — ``st_t0``'s
    ``segments``/``current``/``overlap`` leaves are retained untouched
    (DEAD within farm2; writing an identical second ring would either
    duplicate the roll or alias two output buffers, which donation
    rejects)."""
    v = ext.shape[0]
    b = st_h.overlap.shape[-1]
    current = st_h.current[0]
    current_f = jnp.mod(current - t, n).astype(jnp.int32)
    byd = jnp.flip(
        jax.lax.slice_in_dim(ext, hist0 + t - n, hist0 + t, axis=1), axis=1
    )                                               # blocks t-1..t-n
    segments = jnp.roll(byd, current_f + 1, axis=1)
    i = jnp.arange(n, dtype=jnp.int32)
    pre_h = pmul_sum(st_h.segments_ir, byd, i >= 1)           # [V, 2, B]
    pre_t0 = pmul_sum(st_t0.segments_ir, byd, i >= 1)

    currents = jnp.broadcast_to(current_f, (v,))
    st_h2 = st_h._replace(
        segments=segments, current=currents,
        pre_multiplied=pre_h, overlap=outs[:, -1, b:],
    )
    st_t02 = st_t0._replace(current=currents, pre_multiplied=pre_t0)
    # next call's old-half history: blocks t-2n+1 .. t-n-1 oldest-first =
    # ext rows [hist0 + t - 2n + 1, hist0 + t - n); always in range since
    # t >= p == n and hist0 >= n - 1
    new_hist = jax.lax.slice_in_dim(
        ext, hist0 + t - 2 * n + 1, hist0 + t - n, axis=1
    )                                               # [V, n-1, 2, B]
    return st_h2, st_t02, new_hist


def _heads_fused(cfg: two_stage.TwoStageConfig,
                 st_h: uniform.UniformState, st_t0: uniform.UniformState,
                 vx: jnp.ndarray, hist_prev: jnp.ndarray,
                 suppress_flags,
                 precision=jax.lax.Precision.HIGHEST, khat=None):
    """Fused head+tail0 farm stream over the COMBINED 2n-segment kernel
    (:func:`_combined_head_kernel`): one ring history, one forward/inverse
    time-DFT pipeline, ONE meta-product and ONE inverse meta-DFT produce
    ``head + delay_1_period(tail0)`` directly — the tail0 delay lives in
    the kernel's segment offset, not in a carried conv-spectra buffer.
    Relative to the stacked two-kernel formulation this removes a full
    meta-product, an inverse meta-DFT, the lane-0 correction's second
    pass, and the delayed-spectra concat, and halves khat residency; the
    meta size grows from ``npo2(n-1+T)`` to ``npo2(2n-1+T)``, equal for
    ``T >= 2n`` up to rounding (the production ``T = 2 periods`` call).

    ``hist_prev``: ``[V, n-1, 2, B]`` input spectra of blocks
    ``-(2n-1)..-(n+1)`` oldest-first (the old half of the 2n-1-row input
    window the 2n-segment FDL needs; the ring provides blocks ``-n..-1``).
    OLA is linear, so one overlap-add chain (the head's ``overlap``)
    serves the sum — exactly as the pre-inverse spectra-level sum did.

    ``suppress_flags``: ``[V]`` int32 — voices updated right before this
    call (1 = updated; :func:`farm2_update` sets all,
    :func:`farm2_update_voices` a subset).  Stage-wise update semantics
    zero the pending tail0 double-buffer, so those voices' first period
    must get NO tail0 contribution; the update zeroed their rows of
    ``hist_prev``'s storage (killing the old-half terms), and a small
    triangular pass over the ring window (meta size ``2n`` vs the main
    ``npo2(2n-1+T)``) subtracts the ring-sourced remainder, masked to the
    flagged voices, under a ``lax.cond`` on any-flagged.  The pass runs
    over ALL voices and masks (one post-update call pays an all-V
    triangular conv even for a 1-voice swap): gathering only flagged
    voices would retrace the stream per flag count — compile-shape
    stability wins over one small pass on one call.

    Farm invariant consumed: full clean lockstep rings.

    Returns ``(st_h', st_t0', y_combined [V,T,B], new_hist [V,n-1,2,B])``.
    """
    ucfg = cfg.head
    n = ucfg.seg_count
    b = ucfg.block_size
    p = cfg.period
    assert cfg.tail0 is not None and cfg.tail0.seg_count == n and p == n
    v, t = vx.shape[0], vx.shape[1]
    assert t % p == 0 and t >= p
    current = st_h.current[0]

    specs = rdft_block(vx, ucfg.fft_size, precision)         # [V, T, 2, B]
    seg2 = jnp.concatenate([st_h.segments, st_h.segments], axis=1)
    ring = jnp.flip(jax.lax.dynamic_slice(
        seg2, (0, current + 1, 0, 0), (v, n, 2, b)
    ), axis=1)                                    # blocks -n..-1 oldest-first
    # fold the meta-DFT zero pad into this concat: ext lands at m rows
    # exactly, so causal_conv_time's _pad_rows is a no-op instead of a
    # second full-array materialization (pad.212/213 in the cost mining,
    # ~2.6% of the V=128 stream)
    m_meta = next_power_of_two(2 * n - 1 + t)
    parts = ([hist_prev] if n > 1 else []) + [ring, specs]
    if m_meta > 2 * n - 1 + t:
        parts.append(
            jnp.zeros((v, m_meta - (2 * n - 1 + t), 2, b), jnp.float32)
        )
    ext = jnp.concatenate(parts, axis=1)          # [V, m_meta, 2, B]

    kern = _combined_head_kernel(st_h, st_t0)     # [V, 2n, 2, B]
    conv = causal_conv_time(ext, kern, t, precision,
                            kern_hat=khat)        # [V, T, 2, B]

    def _suppress(c):
        # triangular linear conv of the tail0 table with the ring window:
        # the first period's ring-sourced delayed terms (old-half terms
        # are already zero — the update zeroed the flagged voices' carry
        # storage), masked to the updated voices
        ext_w = jnp.concatenate(
            [jnp.zeros((v, n - 1, 2, b), jnp.float32), ring], axis=1
        )                                         # [V, 2n-1, 2, B]
        w = causal_conv_time(ext_w, st_t0.segments_ir, p, precision,
                             m=2 * n)             # [V, p, 2, B]
        mask = (suppress_flags == 1).astype(jnp.float32)[:, None, None, None]
        return jnp.concatenate([c[:, :p] - w * mask, c[:, p:]], axis=1)

    conv = jax.lax.cond(jnp.any(suppress_flags == 1), _suppress,
                        lambda c: c, conv)
    outs = irdft_block(conv, ucfg.fft_size, precision)        # [V, T, 2B]
    tails = jnp.concatenate(
        [st_h.overlap[:, None], outs[:, :-1, b:]], axis=1
    )
    y = outs[:, :, :b] + tails

    st_h2, st_t02, new_hist = _heads_state_out(
        st_h, st_t0, ext, outs, t, n, 2 * n - 1
    )
    return st_h2, st_t02, y, new_hist


_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
    # bf16 operands/intermediates in the DFT matmul stages (ops/fft.py
    # _mm_mode): half the inter-stage traffic, ~1e-3 relative — the same accuracy tier as
    # the plane-packed bf16 tail storage, its intended pairing
    "bf16": "bf16",
}


def farm2_stream(cfg: two_stage.TwoStageConfig, state: two_stage.TwoStageState,
                 blocks: jnp.ndarray,
                 dft_precision: str = "highest",
                 head_khat=None,
                 tail_dft_precision: str | None = None,
                 ) -> Tuple[two_stage.TwoStageState, jnp.ndarray]:
    """Stream ``blocks [T, V, B]`` -> ``[T, V, B]``; requires period-aligned
    state (fresh or after period-multiple streams) and ``T % period == 0``.

    The three stages of the aligned decomposition
    (:func:`models.two_stage.process_stream_aligned`:
    ``y = head(x) + delay_1(tail0(x)) + delay_2(tail(x))``) run with the
    voice axis placed per stage — head+tail0 fused voice-leading through
    the COMBINED 2n-segment kernel (:func:`_heads_fused`; the tail0 delay
    lives in the kernel's segment offset), the big tail batched
    fused-voice — see the module docstring for why.

    ``head_khat``: optional precomputed :func:`farm2_head_khat` for this
    call's ``T`` — hoists the input-independent kernel meta-DFT out of the
    head MAC (recompute it after :func:`farm2_update`).

    ``tail_dft_precision``: precision spec for the BIG TAIL's forward /
    inverse block DFTs only (defaults to ``dft_precision``).  ``"bf16"``
    pairs with ``tail_dtype=bfloat16`` storage: the tail contribution
    already carries ~1e-3 relative, so running its rdft/irdft matmuls on
    bf16 operands costs no output tier.  The head stages keep their own precision (the early response
    carries the direct sound — its accuracy is the engine's parity
    story).
    """
    if cfg.tail is None:
        # short-IR farm (<= 2 tail blocks): no big tail to batch specially
        per_voice = functools.partial(
            two_stage.process_stream_aligned, cfg,
            small_stream=uniform.stream_conv_unguarded,
        )
        vx = jnp.swapaxes(blocks, 0, 1)
        st2, ys = farm.lockstep_vmap_stream(per_voice, state, vx)
        return st2, jnp.swapaxes(ys, 0, 1)

    b = cfg.head_block
    tb = cfg.tail_block
    p = cfg.period
    t, v = blocks.shape[0], blocks.shape[1]
    q = t // p
    assert q * p == t, "farm2_stream requires T % period == 0"

    vx = jnp.swapaxes(blocks, 0, 1)  # [V, T, B]

    prec = _PRECISIONS[dft_precision]

    # head + tail0 share one ring, one time-DFT pipeline, ONE combined
    # 2n-segment kernel (tail0's period delay lives in the kernel offset),
    # one inverse transform and one OLA chain.  farm2-internal convention:
    # the old half of the input-spectra window (blocks -(2n-1)..-(n+1)
    # oldest-first) lives in the two period buffers as separate planes —
    # tail_precalc0 = re [V, p*B], tail_output0 = im [V, p*B] (row n-1
    # zero); and precalc_pos[i] == 1 flags voice i as updated right
    # before this call (farm2_update sets all, farm2_update_voices a
    # subset), which must suppress that voice's first-period tail0
    # contribution (stage-wise update semantics zero the tail0
    # double-buffer — see _heads_fused's suppress_flags).
    n = cfg.head.seg_count
    hist_prev = jnp.stack(
        [state.tail_precalc0.reshape(v, p, b)[:, : n - 1],
         state.tail_output0.reshape(v, p, b)[:, : n - 1]],
        axis=2,
    )                                                   # [V, n-1, 2, B]
    head_state, tail0_state, y, new_hist = _heads_fused(
        cfg, state.head, state.tail0, vx, hist_prev,
        suppress_flags=state.precalc_pos,
        precision=prec, khat=head_khat,
    )                                                   # y [V, T, B]
    pad_row = ((0, 0), (0, p - (n - 1)), (0, 0))
    new_precalc0 = jnp.pad(new_hist[:, :, 0], pad_row).reshape(v, tb)
    new_output0 = jnp.pad(new_hist[:, :, 1], pad_row).reshape(v, tb)

    # big tail: two-period delay, fused-voice phased correlation core
    tprec = _PRECISIONS[tail_dft_precision or dft_precision]
    big_rows = jnp.swapaxes(vx.reshape(v, q, tb), 0, 1)  # [q, V, tb]
    tail_state, out_t = _tail_corr_phased_fused(
        cfg.tail, state.tail, big_rows, precision=tprec
    )
    out_tv = jnp.swapaxes(out_t, 0, 1)                   # [V, q, tb]
    # two-period delay line: add the delayed contributions into the
    # period view of y slot-wise (slot 0 <- pending precalc, slot 1 <-
    # pending output, slots 2.. <- this call's early outputs) — the
    # concatenate formulation materialized a full [V, T, B] temp that the
    # adder then re-read (cost mining flagged the concat)
    yq = y.reshape(v, q, tb)
    yq = yq.at[:, 0].add(state.tail_precalc)
    if q >= 2:
        yq = yq.at[:, 1].add(state.tail_output)
    if q > 2:
        yq = yq.at[:, 2:].add(out_tv[:, :-2])
    y = yq.reshape(v, t, b)
    new_output = out_tv[:, -1]
    new_precalc = out_tv[:, -2] if q >= 2 else state.tail_output

    st2 = two_stage.TwoStageState(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=new_output0,
        tail_precalc0=new_precalc0,
        tail_output=new_output,
        tail_precalc=new_precalc,
        tail_input=vx[:, (q - 1) * p:].reshape(v, tb),
        tail_fill=jnp.zeros((v,), jnp.int32),
        precalc_pos=jnp.zeros((v,), jnp.int32),
    )
    return st2, jnp.swapaxes(y, 0, 1)


def farm2_pspecs(state: two_stage.TwoStageState):
    """``PartitionSpec`` pytree for a farm2 state over a ``('dp',)`` mesh:
    voice axis 0 for the head-side leaves, the fused ``V*B`` axis for the
    big tail leaves (voice-chunked when ``V`` divides by the mesh size),
    replicated lockstep scalars.  Shared by :func:`farm2_shard` (GSPMD
    placement) and :func:`farm2_stream_sharded` (shard_map specs)."""
    from jax.sharding import PartitionSpec as P

    def head_side(st):
        return jax.tree.map(lambda l: P("dp") if l.ndim >= 1 else P(), st)

    # plane-packed bf16 storage drops the leading plane axis (rank 2:
    # [rows, V*B] uint32) — the fused V*B axis is the LAST one either way
    big = (P(None, "dp") if state.tail.segments.ndim == 2
           else P(None, None, "dp"))
    tail = uniform.UniformState(
        segments=big,
        segments_ir=big,
        overlap=P("dp"),
        input_buffer=P("dp"),
        pre_multiplied=P(None, "dp"),
        current=P(),
        input_fill=P(),
        active_segs=P(),
    )
    return state._replace(
        head=head_side(state.head),
        tail0=head_side(state.tail0),
        tail=tail,
        tail_output0=P("dp"),
        tail_precalc0=P("dp"),
        tail_output=P("dp"),
        tail_precalc=P("dp"),
        tail_input=P("dp"),
        tail_fill=P("dp"),
        precalc_pos=P("dp"),
    )


def farm2_shard(mesh, state: two_stage.TwoStageState) -> two_stage.TwoStageState:
    """Place a farm2 state over a ``('dp',)`` mesh per :func:`farm2_pspecs`."""
    from jax.sharding import NamedSharding

    return jax.tree.map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        state, farm2_pspecs(state),
    )


def farm2_stream_sharded(mesh, cfg: two_stage.TwoStageConfig,
                         state: two_stage.TwoStageState,
                         blocks: jnp.ndarray,
                         dft_precision: str = "highest",
                         head_khat=None,
                         tail_dft_precision: str | None = None,
                         ) -> Tuple[two_stage.TwoStageState, jnp.ndarray]:
    """:func:`farm2_stream` under ``shard_map`` over the mesh's ``'dp'``
    axis — pure data parallelism, zero collectives in the audio path: each
    device runs the full three-stage stream on its local voice shard.

    Under plain ``jit`` over a sharded state, GSPMD partitions the stream
    with scalar all-reduces per call (the ``jnp.any`` over the voices'
    update flags that gates the head stages' suppression ``cond``, and a
    lockstep index); inside ``shard_map`` each device sees only its local
    ``[.., V_local*B]`` shard and the compiled stream has no collective.
    ``V`` must divide by the mesh size (the fused ``V*B`` axis then splits
    voice-chunked); lockstep scalars replicate.
    """
    from jax.sharding import PartitionSpec as P

    if cfg.tail is None:
        # short-IR farm: per-voice lockstep path, GSPMD shards it cleanly
        return farm2_stream(cfg, state, blocks, dft_precision=dft_precision)

    specs = farm2_pspecs(state)
    x_spec = P(None, "dp", None)

    if head_khat is None:
        def local(st, x):
            return farm2_stream(cfg, st, x, dft_precision=dft_precision,
                                tail_dft_precision=tail_dft_precision)

        mapped = jax.shard_map(
            local, mesh=mesh,
            in_specs=(specs, x_spec), out_specs=(specs, x_spec),
            check_vma=False,
        )
        return mapped(state, blocks)

    kh_spec = (P("dp", None, None), P("dp", None, None))

    def local_kh(st, x, kh):
        return farm2_stream(cfg, st, x, dft_precision=dft_precision,
                            head_khat=kh,
                            tail_dft_precision=tail_dft_precision)

    mapped = jax.shard_map(
        local_kh, mesh=mesh,
        in_specs=(specs, x_spec, kh_spec), out_specs=(specs, x_spec),
        check_vma=False,
    )
    return mapped(state, blocks, head_khat)
