"""ReverbFarm — the production many-voice serving engine, as a stateful
wrapper over :mod:`parallel.farm2`.

The reference crate is single-voice (``src/fft_convolver.rs`` is
single-threaded; its only nod to scale is the "background thread" comment
at ``:478``); the farm is this framework's own scale story: V two-stage
voices with DISTINCT long IRs batched on one device — fused head/tail0
streams, the fused-voice phased big tail, head-kernel meta-DFT cached per
IR epoch; the plane-packed bf16 tail fits roughly twice the voices.

Contract mirrors the per-voice :class:`TwoStageFFTConvolver` where it
can: ``process`` streams audio, ``update`` is the batched RT-safe IR swap
(the reference ``update`` is ``todo!()``, so this matches
``update_extension`` semantics), ``reset`` clears input state and keeps
the IR tables, ``snapshot``/``restore``/``clone`` are plain pytree value
copies (the ``Clone`` surface).  The farm-specific constraint: ``process``
consumes whole tail PERIODS (``T`` a multiple of ``period`` blocks) — the
aligned decomposition's invariant, checked eagerly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .models import two_stage, uniform
from .ops.fft import next_power_of_two
from .parallel import farm2


class ReverbFarm:
    """V-voice two-stage convolution farm on one device (or a ``('dp',)``
    mesh via ``mesh=``).

    Parameters
    ----------
    irs : [V, ir_len] float array — one impulse response per voice.
    block_size : head block size in samples (power of two).
    max_response_length : IR capacity per voice; ``update`` accepts any
        length up to this.
    tail_dtype : ``jnp.float32`` (default) or ``jnp.bfloat16`` — bf16
        stores the big tail's IR table and spectra ring at half the
        memory, with a ~1e-3 relative tolerance on the tail
        contribution.  Storage is plane-packed uint32 words
        (ops/packing.py).
    tail_dft_precision : precision spec for the big tail's forward /
        inverse block DFTs — "auto" (default) resolves to ``"highest"``;
        any explicit :data:`parallel.farm2._PRECISIONS` key is accepted.
    dft_precision : precision spec for the HEAD stages (block DFTs,
        combined-kernel meta-DFTs, cached khat) — "auto" resolves to
        "highest" for f32 farms (the early response is the engine's
        parity story) and to "bf16" for packed bf16 farms, the
        throughput tier (~6e-3 relative on the head+tail0
        contribution); pass dft_precision="highest" explicitly to keep
        parity-exact heads over a packed tail.
    mesh : optional ``jax.sharding.Mesh`` with a ``"dp"`` axis — the
        state shards over voices (``V`` must divide by the mesh size) and
        the stream runs under ``shard_map``
        (:func:`parallel.farm2.farm2_stream_sharded`), each device
        stepping its local voice shard with zero collectives in the
        audio path.
    hbm_budget_bytes : eager capacity guard — ``"auto"``
        (:func:`parallel.farm2.device_budget_bytes`: the device's
        allocatable memory less headroom, disabled where the device
        reports no memory statistics), a byte budget, or ``None``.  A farm
        whose estimated footprint (:func:`parallel.farm2.farm2_bytes_per_voice`
        x V) exceeds it raises a ``ValueError`` naming the estimate and
        the fitting voice count at construction, instead of an opaque
        device RESOURCE_EXHAUSTED mid-init (the init-contract-panic
        analogue, ``src/fft_convolver.rs:106-110``).
    """

    # update_voices slab cap: subsets larger than this are applied as
    # consecutive <=8-voice chunks, which bounds the update's transient
    # memory next to the live multi-GB state
    update_voices_chunk = 8

    def __init__(self, irs, block_size: int, max_response_length: int,
                 *, tail_dtype=jnp.float32,
                 tail_dft_precision: str = "auto",
                 dft_precision: str = "auto", mesh=None,
                 hbm_budget_bytes="auto"):
        irs = np.asarray(irs, np.float32)
        if irs.ndim != 2:
            raise ValueError("irs must be [voices, ir_len]")
        # eager capacity guard (farm2_bytes_per_voice model): an oversized
        # farm raises an actionable ValueError at construction instead of
        # an opaque device RESOURCE_EXHAUSTED mid-init/stream
        self.cfg, state = farm2.farm2_init(
            irs, block_size, max_response_length, tail_dtype=tail_dtype,
            hbm_budget_bytes=hbm_budget_bytes,
        )
        if tail_dft_precision == "auto":
            tail_dft_precision = "highest"
        if tail_dft_precision not in farm2._PRECISIONS:
            raise ValueError(
                f"tail_dft_precision {tail_dft_precision!r} not one of "
                f"{sorted(farm2._PRECISIONS)} (or 'auto')"
            )
        self._tail_dft_precision = tail_dft_precision
        # head-stage transform precision: the plane-packed bf16 farm IS
        # the opt-in throughput tier, so its heads default to bf16 too
        if dft_precision == "auto":
            dft_precision = ("bf16" if tail_dtype == jnp.bfloat16
                             else "highest")
        if dft_precision not in farm2._PRECISIONS:
            raise ValueError(
                f"dft_precision {dft_precision!r} not one of "
                f"{sorted(farm2._PRECISIONS)} (or 'auto')"
            )
        self._dft_precision = dft_precision
        if mesh is not None and "dp" not in mesh.axis_names:
            raise ValueError("farm mesh needs a 'dp' axis")
        if mesh is not None and irs.shape[0] % mesh.size != 0:
            raise ValueError(
                f"voices ({irs.shape[0]}) must divide by the mesh size "
                f"({mesh.size}) — the fused V*B tail axis shards "
                "voice-chunked"
            )
        self.voices = irs.shape[0]
        self.block_size = self.cfg.head_block
        self.max_response_length = max_response_length
        self.mesh = mesh
        if mesh is not None:
            state = farm2.farm2_shard(mesh, state)
        self.state = state
        # per-call block ceiling: the phased tail core consumes whole
        # periods and supports a bounded number per call (the correction
        # indices assume it) — enforced eagerly in process() so users get
        # a ValueError, not an in-trace assert
        if self.cfg.tail is not None:
            q_max = min(self.cfg.tail.seg_count, uniform.CORR_EXTRA_ROWS)
            self.max_blocks_per_call = q_max * self.cfg.period
        else:
            self.max_blocks_per_call = None
        # donated state: the stream's in-place ring-row writes are the
        # point of the roll-free phased core — without donation every call
        # copies the multi-GB tail ring (snapshot/restore/clone already
        # copy, so no live aliases remain).  Under a mesh the stream runs
        # inside shard_map, where it compiles with no collective
        # (farm2_stream_sharded's docstring).
        if mesh is not None:
            stream_fn = functools.partial(
                farm2.farm2_stream_sharded, mesh, self.cfg,
                dft_precision=dft_precision,
                tail_dft_precision=tail_dft_precision,
            )
        else:
            stream_fn = functools.partial(
                farm2.farm2_stream, self.cfg,
                dft_precision=dft_precision,
                tail_dft_precision=tail_dft_precision,
            )
        self._stream = jax.jit(stream_fn, donate_argnums=(0,))
        self._update = jax.jit(
            functools.partial(farm2.farm2_update, self.cfg),
            donate_argnums=(0,),
        )
        # per-voice-count K jit cache for farm2_update_voices (K is a
        # shape, so each subset size compiles once)
        self._update_voices_jit = jax.jit(
            functools.partial(farm2.farm2_update_voices, self.cfg),
            donate_argnums=(0,),
        )
        self._khat_voices_jit = jax.jit(
            functools.partial(farm2.farm2_head_khat_voices, self.cfg,
                              dft_precision=dft_precision),
            static_argnums=(1,),
        )
        # head-kernel meta-spectra (farm2_head_khat), cached per meta-DFT
        # length m: input-independent between IR updates, and recomputing
        # it inline was a third of the head MAC's matmul work per call
        self._khat_fn = jax.jit(
            functools.partial(farm2.farm2_head_khat, self.cfg,
                              dft_precision=dft_precision),
            static_argnums=(1,),
        )
        self._khat_cache = {}
        self._khat_t_for_m = {}  # which T built each cached meta length

    @property
    def period(self) -> int:
        """Head blocks per tail period — ``process`` length granularity."""
        return self.cfg.period

    @property
    def tail_block(self) -> int:
        return self.cfg.tail_block

    def process(self, blocks) -> np.ndarray:
        """Stream ``[T, V, block_size]`` -> ``[T, V, block_size]``;
        ``T`` must be a positive multiple of ``period`` and at most
        ``max_blocks_per_call`` (the phased tail core's per-call bound —
        split longer streams into consecutive calls)."""
        blocks = jnp.asarray(blocks, jnp.float32)
        t = blocks.shape[0]
        if blocks.ndim != 3 or blocks.shape[1] != self.voices or \
                blocks.shape[2] != self.block_size:
            raise ValueError(
                f"expected [T, {self.voices}, {self.block_size}] blocks, "
                f"got {blocks.shape}"
            )
        if t == 0 or t % self.period != 0:
            raise ValueError(
                f"T={t} must be a positive multiple of the tail period "
                f"({self.period} blocks) — the aligned farm consumes whole "
                "tail periods"
            )
        if self.max_blocks_per_call is not None and \
                t > self.max_blocks_per_call:
            raise ValueError(
                f"T={t} exceeds the farm's per-call ceiling of "
                f"{self.max_blocks_per_call} blocks "
                f"({self.max_blocks_per_call // self.period} tail periods) "
                "— split the stream "
                "into consecutive process() calls"
            )
        if self.cfg.tail is not None:
            m = next_power_of_two(2 * self.cfg.head.seg_count - 1 + t)
            khat = self._khat_cache.get(m)
            if khat is None:
                khat = self._khat_fn(self.state, t)
                self._khat_cache[m] = khat
                self._khat_t_for_m[m] = t
        else:
            khat = None
        self.state, y = self._stream(self.state, blocks, head_khat=khat)
        return np.asarray(y)

    def update(self, new_irs) -> None:
        """Batched RT-safe IR swap at a period boundary: keeps every
        voice's input history, zeroes pending tail outputs
        (``TwoStageFFTConvolver.update_extension`` semantics per voice;
        reference ``update`` is ``todo!()``, ``src/fft_convolver.rs:408``).
        """
        new_irs = np.asarray(new_irs, np.float32)
        if new_irs.shape[0] != self.voices:
            raise ValueError(
                f"expected {self.voices} new responses, got {new_irs.shape[0]}"
            )
        if new_irs.shape[1] > self.max_response_length:
            raise ValueError(
                f"new responses ({new_irs.shape[1]}) exceed the farm's "
                f"response capacity ({self.max_response_length})"
            )
        self.state = self._update(self.state, jnp.asarray(new_irs))
        # the cached head-kernel meta-spectra belong to the OLD tables
        self._khat_cache.clear()
        self._khat_t_for_m.clear()

    def update_voice(self, voice: int, new_ir) -> None:
        """Per-voice RT-safe IR swap — one client swaps one IR without
        paying the whole farm's rebuild (O(1/V) of :meth:`update`'s cost;
        the reference's cheap-``update`` contract,
        ``src/fft_convolver.rs:174-213``, at fleet scale)."""
        self.update_voices([voice], np.asarray(new_ir, np.float32)[None])

    def update_voices(self, voice_idx, new_irs) -> None:
        """RT-safe IR swap for a SUBSET of voices at a period boundary
        (:func:`parallel.farm2.farm2_update_voices`): only the touched
        voices' stage table rows / tail column slabs are re-DFT'd and
        written, their pending tail outputs zeroed, and the cached head
        khats patched in place (per-voice slab recompute) instead of a
        farm-wide rebuild.  Untouched voices' streams are bit-identical
        to a farm that never updated."""
        new_irs = np.asarray(new_irs, np.float32)
        idx = np.asarray(voice_idx, np.int64).reshape(-1)
        if new_irs.ndim != 2 or new_irs.shape[0] != idx.shape[0]:
            raise ValueError(
                f"expected [{idx.shape[0]}, L] new responses for "
                f"{idx.shape[0]} voices, got {new_irs.shape}"
            )
        if idx.size == 0:
            return
        if len(np.unique(idx)) != idx.size:
            raise ValueError("voice_idx must be distinct")
        if idx.min() < 0 or idx.max() >= self.voices:
            raise ValueError(
                f"voice_idx out of range [0, {self.voices})"
            )
        if new_irs.shape[1] > self.max_response_length:
            raise ValueError(
                f"new responses ({new_irs.shape[1]}) exceed the farm's "
                f"response capacity ({self.max_response_length})"
            )
        if idx.size == self.voices:
            # all voices: the batched rebuild's chunked donated scan beats
            # K unrolled per-voice writes (same semantics — pinned by test)
            full = np.empty_like(new_irs)
            full[idx] = new_irs
            self.update(full)
            return
        if idx.size > self.update_voices_chunk:
            # split into <=chunk slabs of DISTINCT voices: bounds the
            # update's transients next to the live state, and caps the
            # per-K jit cache at {1, 2, 4, 8}.
            for s in range(0, int(idx.size), self.update_voices_chunk):
                e = min(s + self.update_voices_chunk, int(idx.size))
                self.update_voices(idx[s:e], new_irs[s:e])
            return
        # bucket K to the next power of two by REPEATING the last entry —
        # scatter/slab writes of identical rows are idempotent — so the
        # per-shape jit cache holds at most log2(chunk) executables instead
        # of one multi-GB-aliased program per distinct subset size
        k_pad = 1 << (int(idx.size) - 1).bit_length()
        pad = k_pad - idx.size
        idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        new_irs = np.concatenate(
            [new_irs, np.repeat(new_irs[-1:], pad, axis=0)], axis=0
        )
        vidx = jnp.asarray(idx, jnp.int32)
        self.state = self._update_voices_jit(
            self.state, vidx, jnp.asarray(new_irs)
        )
        # patch cached head khats in place: recompute only the touched
        # voices' slabs against the NEW tables
        if self.cfg.tail is not None:
            patched = {}
            for m, (kre, kim) in self._khat_cache.items():
                t = self._khat_t_for_m.get(m)
                if t is None:
                    continue
                sre, sim = self._khat_voices_jit(self.state, t, vidx)
                patched[m] = (kre.at[vidx].set(sre), kim.at[vidx].set(sim))
            self._khat_cache = patched

    def reset(self) -> None:
        """Clear all input state; keep the IR tables
        (``FFTConvolver::reset`` semantics, ``src/fft_convolver.rs:296``)."""
        st = self.state

        def zero(leaf):
            return jnp.zeros_like(leaf)

        def reset_stage(stage):
            return stage._replace(
                segments=zero(stage.segments),
                overlap=zero(stage.overlap),
                input_buffer=zero(stage.input_buffer),
                pre_multiplied=zero(stage.pre_multiplied),
                current=zero(stage.current),
                input_fill=zero(stage.input_fill),
            )

        self.state = st._replace(
            head=reset_stage(st.head),
            tail0=reset_stage(st.tail0),
            tail=reset_stage(st.tail),
            tail_output0=zero(st.tail_output0),
            tail_precalc0=zero(st.tail_precalc0),
            tail_output=zero(st.tail_output),
            tail_precalc=zero(st.tail_precalc),
            tail_input=zero(st.tail_input),
            tail_fill=zero(st.tail_fill),
            precalc_pos=zero(st.precalc_pos),
        )

    # --- Clone surface (reference `Clone`, pytree state is a value) -------
    def snapshot(self) -> two_stage.TwoStageState:
        return jax.tree.map(jnp.copy, self.state)

    def restore(self, snap: two_stage.TwoStageState) -> None:
        self.state = jax.tree.map(jnp.copy, snap)
        # the snapshot may carry different IR tables than the cached khat
        self._khat_cache.clear()
        self._khat_t_for_m.clear()

    def clone(self) -> "ReverbFarm":
        c = object.__new__(ReverbFarm)
        c.__dict__.update(self.__dict__)
        c.state = self.snapshot()
        # own cache: an update() on either instance must not leave the
        # other reading khat of the wrong IR tables
        c._khat_cache = dict(self._khat_cache)
        c._khat_t_for_m = dict(self._khat_t_for_m)
        return c
