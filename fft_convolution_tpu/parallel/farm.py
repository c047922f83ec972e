"""Reverb farm: batched multi-channel / multi-IR convolution, single device
to full mesh.

The reference is strictly single-voice, single-thread (SURVEY.md §2:
parallelism ABSENT).  The scale story is pure data parallelism over
voices (channel x IR pairs):

* on one device, ``vmap`` stacks voice states along a leading axis and the
  whole farm advances in one fused program (batched DFTs, one big MAC);
* across devices, a 1-D ``('dp',)`` mesh shards the voice axis; the
  steady-state audio path has **zero cross-device collectives** — each
  device owns its voices end to end.

States stack because every voice shares one static ``UniformConfig``
(same block size / max IR length — a "farm profile").
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import uniform


# largest uniform farm init accepts: past this footprint the two-stage
# ReverbFarm, ~3x smaller per voice, is the engine for long-IR farms
UNIFORM_FARM_MAX_BYTES = 15e9


def farm_bytes_per_voice(block_size: int, max_response_length: int) -> int:
    """Device bytes per uniform-farm voice: the segments ring + IR spectra
    table dominate at ``2 x seg_count x 2 x fft_size/2`` f32 each, ~16L
    for the tables plus the doubled-IR stream window transient — ~45L
    total with L = ``max_response_length``.  Steeper than farm2's ~16L:
    the uniform engine keeps EVERY segment at the head block size, so
    long-IR many-voice farms should use :class:`api_farm.ReverbFarm`
    (two-stage farm2) instead — see :func:`farm_init`'s check."""
    cfg = uniform.make_config(block_size, max_response_length)
    # ring + IR spectra table: 2 leaves x [seg_count, 2, fft_size/2] f32
    # = ~16L resident; the stream core's doubled-ring history slice and
    # extended-window/rebuild transients empirically bring the peak to
    # ~45L (the measured figure behind CLAUDE.md's memory model)
    table = 2 * cfg.seg_count * 2 * (cfg.fft_size // 2) * 4
    return int(table * 2.8)


def farm_init(
    irs: jnp.ndarray, block_size: int, max_response_length: int
) -> Tuple[uniform.UniformConfig, uniform.UniformState]:
    """Initialize V voices from ``irs [V, ir_len]``.  Returns one shared
    config and a stacked state pytree with leading voice axis V.

    Memory ceiling: ~:func:`farm_bytes_per_voice` per voice (~45L —
    every segment is block-sized, unlike the two-stage farm2's ~16L).
    Farms whose estimated footprint exceeds :data:`UNIFORM_FARM_MAX_BYTES`
    raise eagerly with a pointer to :class:`api_farm.ReverbFarm` rather
    than OOMing mid-init."""
    irs = jnp.asarray(irs, jnp.float32)
    est = irs.shape[0] * farm_bytes_per_voice(block_size, max_response_length)
    if est > UNIFORM_FARM_MAX_BYTES:
        raise ValueError(
            f"uniform farm of {irs.shape[0]} voices x {max_response_length} "
            f"samples needs ~{est/1e9:.1f} GB (> the uniform farm's "
            f"{UNIFORM_FARM_MAX_BYTES/1e9:.0f} GB limit). Long-IR "
            "farms should use the two-stage ReverbFarm (parallel/farm2), "
            "whose per-voice memory is ~3x smaller, or shard this farm "
            "over a mesh (shard_farm)."
        )
    if max_response_length < irs.shape[-1]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    cfg = uniform.make_config(block_size, max_response_length)
    v = irs.shape[0]
    padded = jnp.pad(irs, ((0, 0), (0, cfg.seg_count * cfg.block_size - irs.shape[-1])))
    new_len = jnp.full((v,), cfg.ir_len, jnp.int32)
    zeros = jax.tree.map(
        lambda leaf: jnp.broadcast_to(leaf, (v,) + leaf.shape), uniform.zero_state(cfg)
    )
    # chunked map, not vmap: a fully batched 4-step DFT materializes ~6
    # full-size intermediates of the whole IR set, OOMing large farms at init
    batch = max(1, int(2e8 // max(1, cfg.seg_count * cfg.block_size * 8)))
    state = jax.jit(
        lambda z, p, n: jax.lax.map(
            lambda args: uniform.update(cfg, *args), (z, p, n),
            batch_size=min(batch, v),
        )
    )(zeros, padded, new_len)
    return cfg, state


def farm_update(cfg: uniform.UniformConfig, state: uniform.UniformState,
                irs_padded: jnp.ndarray, new_lens: jnp.ndarray) -> uniform.UniformState:
    """Batched RT-safe IR swap for all voices at once."""
    return jax.vmap(functools.partial(uniform.update, cfg))(state, irs_padded, new_lens)


def farm_step(cfg: uniform.UniformConfig, state: uniform.UniformState,
              x: jnp.ndarray) -> Tuple[uniform.UniformState, jnp.ndarray]:
    """One block for every voice: ``x [V, B] -> y [V, B]``."""
    return jax.vmap(functools.partial(uniform.process_block, cfg))(state, x)


def lockstep_vmap_stream(stream_fn, state, vx):
    """vmap a per-voice stream over the voice axis with all per-voice
    SCALAR state (current, fills, counters) passed UNBATCHED.

    Farm voices advance in lockstep (same block count every call), so these
    scalars are identical across voices; telling vmap so turns every
    ring dynamic-slice/roll into one shared-index operation instead of a
    per-voice gather.  1-D leaves are the former scalars.
    """
    axes = jax.tree.map(lambda leaf: None if leaf.ndim == 1 else 0, state)
    shared = jax.tree.map(
        lambda leaf: leaf[0] if leaf.ndim == 1 else leaf, state
    )
    st2, ys = jax.vmap(stream_fn, in_axes=(axes, 0), out_axes=(axes, 0))(
        shared, vx
    )
    v = vx.shape[0]
    st2 = jax.tree.map(
        lambda leaf, ax: leaf if ax == 0 else jnp.broadcast_to(leaf, (v,) + leaf.shape),
        st2, axes,
    )
    return st2, ys


def farm_khat(cfg: uniform.UniformConfig, state: uniform.UniformState,
              t: int):
    """Batched :func:`models.uniform.stream_khat` over the voice axis:
    the farm stream MAC's kernel meta-spectra for ``T = t``-block calls,
    input-independent between IR updates (rebuild after ``farm_update``).
    Pass to :func:`farm_stream` as ``kern_hat=``."""
    from ..ops.fft import causal_conv_khat, next_power_of_two

    n = cfg.seg_count
    m = next_power_of_two(n - 1 + t) if n > 1 else next_power_of_two(t)
    i = jnp.arange(n, dtype=jnp.int32)
    mask = (i[None, :] < state.active_segs[:, None])[:, :, None, None]
    return causal_conv_khat(jnp.where(mask, state.segments_ir, 0.0), m)


def farm_stream(cfg: uniform.UniformConfig, state: uniform.UniformState,
                blocks: jnp.ndarray,
                kern_hat=None) -> Tuple[uniform.UniformState, jnp.ndarray]:
    """Stream ``blocks [T, V, B]`` through the farm -> ``[T, V, B]``.

    Fast path: every voice's ring is full and clean and the voices are in
    lockstep -> vmap the fully parallel conv-HLO stream over voices with
    shared ring indices — one batched program with zero sequential steps.
    The predicate is reduced over ALL voices so the ``lax.cond`` stays
    unbatched (vmapping a cond would execute both branches per voice); the
    fallback is the exact per-block scan (which ignores ``kern_hat`` —
    only the conv fast path consumes the precomputed kernel meta-DFT).
    """
    vx = jnp.swapaxes(blocks, 0, 1)  # [V, T, B]

    clean = (
        jnp.all(state.active_segs == cfg.seg_count)
        & jnp.all(state.current == state.current[0])
        & jnp.all(state.current < state.active_segs)
    )

    def fast(st):
        st2, ys = uniform.stream_conv_farm(cfg, st, vx, kern_hat=kern_hat)
        return st2, jnp.swapaxes(ys, 0, 1)

    def slow(st):
        def step(s, xt):
            return farm_step(cfg, s, xt)

        return jax.lax.scan(step, st, blocks)

    return jax.lax.cond(clean, fast, slow, state)


# ---------------------------------------------------------------------------
# multi-device: shard the voice axis over a ('dp',) mesh
# ---------------------------------------------------------------------------

def make_farm_mesh(devices=None) -> Mesh:
    import numpy as np

    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), ("dp",))


def shard_farm(mesh: Mesh, state: uniform.UniformState) -> uniform.UniformState:
    """Place a stacked farm state with the voice axis sharded over 'dp'."""
    sharding = NamedSharding(mesh, P("dp"))
    return jax.tree.map(lambda leaf: jax.device_put(leaf, sharding), state)


def sharded_farm_stream(cfg: uniform.UniformConfig, mesh: Mesh):
    """Build a jitted sharded stream fn: blocks [T, V, B] with V sharded over
    'dp'.  No collectives in the audio path — pure data parallel over
    devices; XLA partitions the vmapped program per shard."""
    v_sharded = NamedSharding(mesh, P(None, "dp"))

    @functools.partial(
        jax.jit,
        in_shardings=(None, v_sharded),
        donate_argnums=(0,),
    )
    def run(state, blocks):
        return farm_stream(cfg, state, blocks)

    return run
