"""Segment-axis sharding: one voice, one giant IR, many chips.

For very long impulse responses (60 s @ 48 kHz = 2.88 M taps -> ~23 MB of
partition spectra per voice at B=128, SURVEY.md §5) the frequency-delay line
itself is the thing to shard.  This module partitions the FDL's segment axis
over an ``('sp',)`` mesh axis with ``shard_map``:

* ``segments`` (input-block spectra ring) is sharded by storage row;
* ``segments_ir`` is replicated (each chip reads only a circular window of
  it per block, and it never changes between updates);
* each chip computes its local masked spectral MAC, and one ``psum`` of a
  single ``[2, B]`` spectrum (~1 KB at B=128) merges the partial sums over
  NVLink (NCCL) — the only cross-device traffic in the steady-state audio path;
* the fresh input spectrum is computed replicated, so partition 0's product
  (``segments[current] * ir[0]``) needs no gather at all.

The ring gather is re-expressed gather-free: the reference pairs IR index
``i`` with stored row ``(current + i) % active`` (``src/fft_convolver.rs:248``),
so stored row ``j`` pairs with IR row ``(j - current) mod active`` — each
chip indexes the *replicated* IR with its own local window instead of
gathering remote segment rows.

In the steady state (``active == seg_count``, a full ring) that window is
CONTIGUOUS: each chip's slab ``j in [row0, row0 + local_rows)`` pairs IR rows
``(row0 - current) mod N .. + local_rows`` of a doubled IR table — one
dynamic slice per block instead of a row gather (``segments_ir`` is
therefore stored pre-doubled,
``[2 * seg_count, 2, B]``).  To make the full ring the steady state, ``init``
declares ``active = seg_count`` — equivalent to a reference convolver whose
``max_response_length`` is padded to the next mesh multiple (trailing all-
zero IR segments are live until the first update, ``src/fft_convolver.rs:118``,
and contribute nothing).  After an ``update`` shrinks ``active`` the step
falls back to the exact masked gather for the shrunk-ring transient.

``update``/``reset`` complete the ``Convolution`` contract
(``src/fft_convolver.rs:174-213,296-307``): update keeps the sharded input
history and ``current`` but re-FFTs the replicated IR tables, zeroes
``overlap``, and shrinks ``active``; reset clears the input side and keeps
the IR.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models import uniform
from ..ops.cpx import pmul, pmul_sum
from ..ops.fft import irdft_block, rdft_block


class ShardedFDLState(NamedTuple):
    """Distributed uniform-convolver state.  ``segments`` is sharded on its
    row axis over 'sp'; everything else is replicated.  ``segments_ir`` is
    stored DOUBLED (two copies stacked on the row axis) so the steady-state
    per-chip IR window is a dynamic slice, never a gather."""

    segments: jnp.ndarray      # f32 [seg_count, 2, B]      (sharded rows)
    segments_ir: jnp.ndarray   # f32 [2 * seg_count, 2, B]  (replicated, doubled)
    overlap: jnp.ndarray       # f32 [B]
    current: jnp.ndarray       # i32 []
    active_segs: jnp.ndarray   # i32 []


def make_mesh(devices=None, axis: str = "sp") -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def init(mesh: Mesh, response, block_size: int, max_response_length: int
         ) -> Tuple[uniform.UniformConfig, ShardedFDLState]:
    """Build a sharded FDL; seg_count is padded up to a multiple of the
    'sp' axis size so every sp shard owns an equal row slab.  The mesh may
    have other axes (e.g. a 2-D (dp, sp) serving mesh) — the FDL is sharded
    over 'sp' only and replicated over the rest."""
    n_shards = mesh.shape["sp"]
    cfg0 = uniform.make_config(block_size, max_response_length)
    seg_count = -(-cfg0.seg_count // n_shards) * n_shards
    cfg = uniform.UniformConfig(
        block_size=cfg0.block_size, seg_count=seg_count, ir_len=cfg0.ir_len
    )
    response = jnp.asarray(response, jnp.float32)
    if max_response_length < response.shape[0]:
        raise ValueError(
            "max_response_length must be at least the length of the initial "
            "impulse response"
        )
    padded = jnp.pad(response, (0, seg_count * cfg.block_size - response.shape[0]))
    from ..ops.fft import ir_to_spectra

    ir_spec = ir_to_spectra(padded, cfg.block_size, seg_count)
    state = ShardedFDLState(
        segments=jax.device_put(
            jnp.zeros((seg_count, 2, cfg.block_size), jnp.float32),
            NamedSharding(mesh, P("sp")),
        ),
        segments_ir=jax.device_put(
            jnp.concatenate([ir_spec, ir_spec], axis=0),
            NamedSharding(mesh, P()),
        ),
        overlap=jax.device_put(jnp.zeros((cfg.block_size,), jnp.float32),
                               NamedSharding(mesh, P())),
        current=jax.device_put(jnp.zeros((), jnp.int32), NamedSharding(mesh, P())),
        # the full (padded) ring is live — equivalent to a reference convolver
        # with max_response_length padded to the mesh multiple; trailing
        # zero-IR segments are active and contribute nothing (:117-118)
        active_segs=jax.device_put(
            jnp.asarray(seg_count, jnp.int32), NamedSharding(mesh, P())
        ),
    )
    return cfg, state


def update(cfg: uniform.UniformConfig, state: ShardedFDLState,
           response_padded: jnp.ndarray, new_len: jnp.ndarray
           ) -> ShardedFDLState:
    """RT-safe IR swap on the sharded FDL (``src/fft_convolver.rs:174-213``),
    jittable.  Keeps the sharded input history (``segments``, ``current``),
    re-FFTs the replicated doubled IR tables, zeroes the OLA ``overlap``,
    and shrinks ``active_segs``.  ``response_padded`` must be zero-padded to
    ``cfg.seg_count * cfg.block_size`` (zero rows past the new active count
    reproduce the explicit clear at ``:210-212``); the host wrapper enforces
    the length-check panic (``:177-179``)."""
    from ..ops.fft import ir_to_spectra

    new_active = jnp.ceil(
        new_len.astype(jnp.float32) / cfg.block_size
    ).astype(jnp.int32)
    ir_spec = ir_to_spectra(response_padded, cfg.block_size, cfg.seg_count)
    return state._replace(
        segments_ir=jnp.concatenate([ir_spec, ir_spec], axis=0),
        overlap=jnp.zeros_like(state.overlap),
        active_segs=new_active,
    )


def reset(state: ShardedFDLState) -> ShardedFDLState:
    """``Convolution::reset`` (``src/fft_convolver.rs:296-307``): clears all
    input-side state, keeps the IR tables and ``active_segs``.  zeros_like
    preserves each leaf's sharding."""
    return state._replace(
        segments=jnp.zeros_like(state.segments),
        overlap=jnp.zeros_like(state.overlap),
        current=jnp.zeros_like(state.current),
    )


def _build_raw_step(cfg: uniform.UniformConfig, mesh: Mesh):
    """Unjitted sharded block step: ``(state, x[B]) -> (state, y[B])``."""
    b = cfg.block_size
    n = cfg.seg_count
    # shard count is the 'sp' AXIS size, not the device count: on a
    # multi-axis mesh (e.g. (dp, sp)) P("sp") shards rows over sp only and
    # replicates over the other axes, so the slab each body instance sees
    # is n / |sp| rows.  (Using devices.size here silently mis-indexed the
    # ring on 2-D meshes.)
    n_shards = mesh.shape["sp"]
    local_rows = n // n_shards

    def local_step(seg_local, ir2, overlap, current, active, x):
        # shard_map body: seg_local [local_rows, 2, B]; ir2 is the full
        # replicated DOUBLED IR table [2N, 2, B]
        rank = jax.lax.axis_index("sp")
        row0 = rank * local_rows
        j = row0 + jnp.arange(local_rows, dtype=jnp.int32)  # global storage rows

        spec = rdft_block(x, 2 * b)  # replicated compute: one tiny DFT

        # write the fresh spectrum into the owner's local slab
        is_mine = (j == current)[:, None, None]
        seg_local = jnp.where(is_mine, spec[None], seg_local)

        # local masked MAC: stored row j pairs IR row (j - current) mod active
        def mac_sliced():
            # full ring (active == N, the steady state): the slab's IR rows
            # are one contiguous window of the doubled table — no gather
            start = jnp.mod(row0 - current, n)
            ir_rows = jax.lax.dynamic_slice(
                ir2, (start, 0, 0), (local_rows, 2, b)
            )
            return pmul_sum(ir_rows, seg_local, j != current)

        def mac_gather():
            # shrunk-ring transient after an update: exact masked gather
            active_safe = jnp.maximum(active, 1)
            ir_idx = jnp.mod(j - current, active_safe)
            mask = (j < active) & (ir_idx >= 1)
            ir_rows = jnp.take(ir2, ir_idx, axis=0)
            return pmul_sum(ir_rows, seg_local, mask)

        partial = jax.lax.cond(active == n, mac_sliced, mac_gather)
        pre = jax.lax.psum(partial, "sp")  # ~1 KB over NVLink

        conv = pre + pmul(spec, ir2[0])
        fft_buffer = irdft_block(conv, 2 * b)
        y = fft_buffer[:b] + overlap
        new_overlap = fft_buffer[b:]
        new_current = jnp.where(current > 0, current - 1, active - 1).astype(jnp.int32)
        return seg_local, new_overlap, new_current, y

    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("sp"), P(), P(), P(), P(), P()),
        out_specs=(P("sp"), P(), P(), P()),
        check_vma=False,
    )

    def step(state: ShardedFDLState, x: jnp.ndarray):
        seg, overlap, current, y = mapped(
            state.segments, state.segments_ir, state.overlap,
            state.current, state.active_segs, x,
        )
        return ShardedFDLState(
            segments=seg, segments_ir=state.segments_ir,
            overlap=overlap, current=current, active_segs=state.active_segs,
        ), y

    return step


def build_step(cfg: uniform.UniformConfig, mesh: Mesh):
    """Jitted sharded block step: ``(state, x[B]) -> (state, y[B])``."""
    return jax.jit(_build_raw_step(cfg, mesh), donate_argnums=(0,))


def build_stream(cfg: uniform.UniformConfig, mesh: Mesh):
    """Jitted sharded stream: ``(state, blocks[T, B]) -> (state, y[T, B])``."""
    raw = _build_raw_step(cfg, mesh)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run(state: ShardedFDLState, blocks: jnp.ndarray):
        return jax.lax.scan(raw, state, blocks)

    return run


def build_update(cfg: uniform.UniformConfig):
    """Jitted sharded IR swap: ``(state, padded_ir, new_len) -> state``."""
    return jax.jit(functools.partial(update, cfg), donate_argnums=(0,))


class ShardedFFTConvolver:
    """The ``Convolution`` contract over an ``('sp',)`` device mesh — one
    voice, one giant IR, ``seg_count`` frequency-delay-line rows sharded
    across chips (``src/lib.rs:5-14`` surface; the reference has no
    distributed layer, SURVEY.md §2).

    ``process`` takes block-aligned input (any multiple of ``block_size``) —
    this is the serving path for IRs too long for one chip, not the
    arbitrary-chunk host API (use :class:`api.FFTConvolver` for that).
    Equivalent to a single-device ``FFTConvolver`` whose
    ``max_response_length`` is padded up to a mesh multiple of segments.
    """

    def __init__(self, response, block_size: int, max_response_length: int,
                 mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.cfg, self.state = init(
            self.mesh, response, block_size, max_response_length
        )
        self._declared_max = max_response_length
        self._stream_cache: dict[int, object] = {}
        self._update = build_update(self.cfg)

    def process(self, input) -> np.ndarray:
        x = np.asarray(input, np.float32)
        b = self.cfg.block_size
        if x.shape[0] % b:
            raise ValueError(
                f"ShardedFFTConvolver.process takes block-aligned input "
                f"(multiples of {b} samples, got {x.shape[0]})"
            )
        if x.shape[0] == 0:
            return x
        t = x.shape[0] // b
        run = self._stream_cache.get(t)
        if run is None:
            run = self._stream_cache[t] = build_stream(self.cfg, self.mesh)
        self.state, y = run(self.state, jnp.asarray(x.reshape(t, b)))
        return np.asarray(y).reshape(-1)

    def update(self, response) -> None:
        """RT-safe IR swap (``src/fft_convolver.rs:174-213``)."""
        response = np.asarray(response, np.float32)
        if response.shape[0] > self._declared_max:
            raise ValueError(
                "New impulse response is longer than initialized length"
            )
        if self._declared_max == 0:
            return
        padded = np.zeros(self.cfg.seg_count * self.cfg.block_size, np.float32)
        padded[: response.shape[0]] = response
        self.state = self._update(
            self.state, jnp.asarray(padded),
            jnp.asarray(response.shape[0], jnp.int32),
        )

    def reset(self) -> None:
        self.state = reset(self.state)

    def snapshot(self):
        # copy: the stream/update programs donate their state argument, so a
        # live reference would be invalidated by the next process() call
        return jax.tree.map(jnp.copy, self.state)

    def restore(self, snap) -> None:
        self.state = jax.tree.map(jnp.copy, snap)

    def clone(self) -> "ShardedFFTConvolver":
        other = object.__new__(ShardedFFTConvolver)
        other.mesh = self.mesh
        other.cfg = self.cfg
        # deep copy: the stream/update programs donate their state argument,
        # so shared leaves would be invalidated by whichever twin runs first
        other.state = jax.tree.map(jnp.copy, self.state)
        other._declared_max = self._declared_max
        other._stream_cache = {}
        other._update = self._update
        return other
