"""Sharded long-IR two-stage convolution: one voice, a multi-minute IR,
the big tail spanning devices.

The reference two-stage convolver (``src/fft_convolver.rs:323-526``) is a
single-core design; its only scale story is the comment that the 2nd-Nth
tail blocks "might be done in some background thread" (``:478``).  The
scale-out composes the two existing pieces (SURVEY.md §5's memory-budget
scenario):

* **head + tail0** stay replicated on every chip — they are tiny (both run
  at ``head_block`` over at most ``tail_block`` taps) and give the low
  latency, so duplicating them costs nothing and keeps the latency path
  collective-free;
* **the main tail** — where a 60 s IR keeps ~23 MB of partition spectra
  (SURVEY.md §5) — is the segment-axis-sharded FDL of
  :mod:`fft_convolution_tpu.parallel.partition`: each chip owns a slab of
  tail segments and one ``[2, B_tail]`` ``psum`` per tail *period* (not per
  head block) merges the partial spectra over NVLink (NCCL).

The schedule is :func:`models.two_stage.process_stream_aligned`'s 3-stream
delay decomposition, reused verbatim with the big-tail stream core swapped
for a ``lax.scan`` over the sharded FDL step:

    y = head(x) + delay_1_period(tail0(x)) + delay_2_periods(tail_sp(x))

so the cross-chip traffic is one ~1 KB psum every ``period`` head blocks —
the interconnect cost *amortizes* with IR length while the per-device memory shrinks
as 1/n_chips.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..models import two_stage, uniform
from . import partition


def init(mesh: Mesh, response, block_size: int, max_response_length: int
         ) -> Tuple[two_stage.TwoStageConfig, two_stage.TwoStageState]:
    """Two-stage ``init`` (``src/fft_convolver.rs:340-406``) with the main
    tail built as a sharded FDL over ``mesh``'s ``'sp'`` axis.

    Returns a :class:`two_stage.TwoStageConfig` whose ``tail`` is the
    partitioned (mesh-padded) tail config, and a
    :class:`two_stage.TwoStageState` whose ``tail`` leaf is a
    :class:`partition.ShardedFDLState`.  Requires the IR to actually reach
    the main tail (``max_response_length > 2 * tail_block``) — shorter IRs
    have nothing to shard; use the single-device engine.
    """
    response = np.asarray(response, np.float32)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    head_block = block_size
    tail_block = two_stage.compute_tail_block_size(block_size, max_response_length)
    if max_response_length <= 2 * tail_block:
        raise ValueError(
            f"IR of {max_response_length} taps never reaches the main tail "
            f"(tail_block={tail_block}); nothing to shard — use "
            "TwoStageFFTConvolver on one chip"
        )
    padded = np.zeros(max_response_length, np.float32)
    padded[: response.shape[0]] = response

    head_ir_len = min(max_response_length, tail_block)
    head_cfg, head_state = uniform.init(padded[:head_ir_len], head_block, head_ir_len)

    t0_len = min(max_response_length - tail_block, tail_block)
    tail0_cfg, tail0_state = uniform.init(
        padded[tail_block : tail_block + t0_len], head_block, t0_len
    )

    t_len = max_response_length - 2 * tail_block
    tail_cfg, tail_state = partition.init(
        mesh, padded[2 * tail_block :], tail_block, t_len
    )

    cfg = two_stage.TwoStageConfig(
        head_block=head_block,
        tail_block=tail_block,
        head=head_cfg,
        tail0=tail0_cfg,
        tail=tail_cfg,
    )

    def zeros_t():
        return jnp.zeros((tail_block,), jnp.float32)

    state = two_stage.TwoStageState(
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


def _raw_stream_aligned(cfg: two_stage.TwoStageConfig, mesh: Mesh):
    """Unjitted period-aligned stream: ``(state, blocks[T, head]) -> (state, y)``
    with the main tail scanned through the sharded FDL step."""
    raw_tail = partition._build_raw_step(cfg.tail, mesh)

    def big_stream(_tail_cfg, tail_state, big):
        # big: [q, tail_block]; one sharded FDL step (one psum) per period
        return jax.lax.scan(raw_tail, tail_state, big)

    def run(state, blocks):
        return two_stage.process_stream_aligned(
            cfg, state, blocks, big_stream=big_stream
        )

    return run


def build_stream_aligned(cfg: two_stage.TwoStageConfig, mesh: Mesh):
    """Jitted period-aligned sharded two-stage stream (donates state)."""
    return jax.jit(_raw_stream_aligned(cfg, mesh), donate_argnums=(0,))


def update(cfg: two_stage.TwoStageConfig, state: two_stage.TwoStageState,
           response_padded: jnp.ndarray, new_len: jnp.ndarray
           ) -> two_stage.TwoStageState:
    """EXTENSION (reference ``update`` is ``todo!()``,
    ``src/fft_convolver.rs:408-410``) — stage-wise RT-safe swap, the sharded
    analogue of :func:`models.two_stage.update`: head/tail0 via
    :func:`uniform.update`, the sharded tail via :func:`partition.update`,
    pending precalculated tails zeroed.

    Each zeroed field gets its OWN zeros array: the stream program donates
    the whole state, and XLA aliases identical jit outputs, so one shared
    zeros buffer would be donated four times (the CLAUDE.md donation
    invariant)."""
    tb = cfg.tail_block

    def zeros_t():
        return jnp.zeros_like(state.tail_input)

    head_cap = cfg.head.ir_len
    head_state = uniform.update(
        cfg.head, state.head,
        two_stage.copy_and_pad_static(
            response_padded[:head_cap], cfg.head.seg_count * cfg.head.block_size
        ),
        jnp.minimum(new_len, head_cap).astype(jnp.int32),
    )
    cap0 = cfg.tail0.ir_len
    tail0_state = uniform.update(
        cfg.tail0, state.tail0,
        two_stage.copy_and_pad_static(
            response_padded[tb:tb + cap0], cfg.tail0.seg_count * cfg.tail0.block_size
        ),
        jnp.clip(new_len - tb, 0, cap0).astype(jnp.int32),
    )
    tail_state = partition.update(
        cfg.tail, state.tail,
        two_stage.copy_and_pad_static(
            response_padded[2 * tb:2 * tb + cfg.tail.ir_len],
            cfg.tail.seg_count * cfg.tail.block_size,
        ),
        jnp.clip(new_len - 2 * tb, 0, cfg.tail.ir_len).astype(jnp.int32),
    )
    return state._replace(
        head=head_state,
        tail0=tail0_state,
        tail=tail_state,
        tail_output0=zeros_t(),
        tail_precalc0=zeros_t(),
        tail_output=zeros_t(),
        tail_precalc=zeros_t(),
    )


def reset(state: two_stage.TwoStageState) -> two_stage.TwoStageState:
    """``Convolution::reset`` (``src/fft_convolver.rs:497-511``) with the
    sharded tail reset via :func:`partition.reset`.  Distinct zeros per
    field — see :func:`update`."""

    def zeros_t():
        return jnp.zeros_like(state.tail_input)

    return state._replace(
        head=uniform.reset(state.head),
        tail0=uniform.reset(state.tail0),
        tail=partition.reset(state.tail),
        tail_output0=zeros_t(),
        tail_precalc0=zeros_t(),
        tail_output=zeros_t(),
        tail_precalc=zeros_t(),
        tail_input=zeros_t(),
        tail_fill=jnp.zeros((), jnp.int32),
        precalc_pos=jnp.zeros((), jnp.int32),
    )


class ShardedTwoStageConvolver:
    """``TwoStageFFTConvolver`` for IRs too long for one chip: the
    ``Convolution`` surface (``src/lib.rs:5-14``) with the main tail's
    frequency-delay line sharded over the mesh's ``'sp'`` axis.

    ``process`` takes period-aligned input (multiples of
    ``tail_block`` samples) — this is the serving path for giant IRs, not
    the arbitrary-chunk host API.  ``update`` raises like the reference's
    ``todo!()`` (``src/fft_convolver.rs:408-410``); ``update_extension`` is
    the implemented variant.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else partition.make_mesh()
        self.cfg, self.state = init(
            self.mesh, response, block_size, max_response_length
        )
        self._declared_max = max_response_length
        self._stream_cache: dict[int, object] = {}
        self._update = jax.jit(
            functools.partial(update, self.cfg), donate_argnums=(0,)
        )

    def process(self, input) -> np.ndarray:
        x = np.asarray(input, np.float32)
        tb = self.cfg.tail_block
        if x.shape[0] % tb:
            raise ValueError(
                f"ShardedTwoStageConvolver.process takes period-aligned input "
                f"(multiples of tail_block={tb} samples, got {x.shape[0]})"
            )
        if x.shape[0] == 0:
            return x
        b = self.cfg.head_block
        t = x.shape[0] // b
        run = self._stream_cache.get(t)
        if run is None:
            run = self._stream_cache[t] = build_stream_aligned(self.cfg, self.mesh)
        self.state, y = run(self.state, jnp.asarray(x.reshape(t, b)))
        return np.asarray(y).reshape(-1)

    def update(self, response) -> None:
        raise NotImplementedError(
            "TwoStageFFTConvolver::update is todo!() in the reference "
            "(src/fft_convolver.rs:408-410); use update_extension() or the "
            "crossfade wrapper"
        )

    def update_extension(self, response) -> None:
        response = np.asarray(response, np.float32)
        if response.shape[0] > self._declared_max:
            raise ValueError(
                "New impulse response is longer than initialized length"
            )
        if response.shape[0] == 0:
            return
        padded = np.zeros(self._declared_max, np.float32)
        padded[: response.shape[0]] = response
        self.state = self._update(
            self.state, jnp.asarray(padded),
            jnp.asarray(response.shape[0], jnp.int32),
        )

    def reset(self) -> None:
        self.state = reset(self.state)

    def snapshot(self):
        # copy: the stream/update programs donate their state argument
        return jax.tree.map(jnp.copy, self.state)

    def restore(self, snap) -> None:
        self.state = jax.tree.map(jnp.copy, snap)

    def clone(self) -> "ShardedTwoStageConvolver":
        other = object.__new__(ShardedTwoStageConvolver)
        other.mesh = self.mesh
        other.cfg = self.cfg
        other.state = jax.tree.map(jnp.copy, self.state)
        other._declared_max = self._declared_max
        other._stream_cache = {}
        other._update = self._update
        return other
