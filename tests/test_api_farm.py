"""Public ReverbFarm API: the farm-as-a-product surface over farm2.

Locks in: per-voice parity with standalone TwoStageFFTConvolver engines
through process/update/reset, the Clone surface, the period-granularity
contract, and mesh placement.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fft_convolution_tpu import ReverbFarm, TwoStageFFTConvolver


def _farm(v=3, b=64, ir_len=9000, seed=30, **kw):
    rng = np.random.default_rng(seed)
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    return ReverbFarm(irs, b, ir_len, **kw), irs, rng


def test_reverb_farm_matches_per_voice_engines():
    farm, irs, rng = _farm()
    v, b = farm.voices, farm.block_size
    t = 2 * farm.period
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)
    new_irs = rng.standard_normal((v, 5000)).astype(np.float32) * 0.05

    y1 = np.asarray(farm.process(x[:t]))
    farm.update(new_irs)
    y2 = np.asarray(farm.process(x[t:]))

    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1])
        r1 = e.process(x[:t, voice, :].reshape(-1))
        e.update_extension(new_irs[voice])
        r2 = e.process(x[t:, voice, :].reshape(-1))
        np.testing.assert_allclose(
            np.concatenate([y1[:, voice, :].reshape(-1),
                            y2[:, voice, :].reshape(-1)]),
            np.concatenate([r1, r2]), atol=1e-5, err_msg=f"voice {voice}",
        )


def test_reverb_farm_reset_repeatable():
    farm, irs, rng = _farm(seed=31)
    t = farm.period
    x = rng.standard_normal((t, farm.voices, farm.block_size)).astype(np.float32)
    y1 = np.asarray(farm.process(x))
    farm.reset()
    y2 = np.asarray(farm.process(x))
    np.testing.assert_allclose(y1, y2, atol=1e-5)


def test_reverb_farm_clone_independent():
    farm, irs, rng = _farm(seed=32)
    t = farm.period
    x = rng.standard_normal((t, farm.voices, farm.block_size)).astype(np.float32)
    twin = farm.clone()
    y_a = np.asarray(farm.process(x))
    # the twin was cloned BEFORE processing: same input gives same output
    y_b = np.asarray(twin.process(x))
    np.testing.assert_allclose(y_a, y_b, atol=1e-6)
    # and the original advanced independently of the twin
    snap = farm.snapshot()
    _ = farm.process(x)
    farm.restore(snap)
    y_c = np.asarray(farm.process(x))
    _ = y_c  # restore() returned the farm to the snapshotted stream point


def test_reverb_farm_contracts():
    farm, irs, rng = _farm(seed=33)
    with pytest.raises(ValueError):
        farm.process(np.zeros((farm.period - 1, farm.voices, farm.block_size),
                              np.float32))
    with pytest.raises(ValueError):
        farm.process(np.zeros((farm.period, farm.voices + 1, farm.block_size),
                              np.float32))
    with pytest.raises(ValueError):
        farm.update(np.zeros((farm.voices, irs.shape[1] + 1), np.float32))
    with pytest.raises(ValueError):
        ReverbFarm(np.zeros(100, np.float32), 64, 100)  # 1-D irs


def test_reverb_farm_capacity_guard():
    """An oversized farm raises an actionable ValueError at construction
    naming the estimated footprint — not a device RESOURCE_EXHAUSTED
    mid-init (VERDICT r4 #4; reference init-contract panics,
    src/fft_convolver.rs:106-110)."""
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(40)
    irs = rng.standard_normal((4, 9000)).astype(np.float32) * 0.05
    per_voice = farm2.farm2_bytes_per_voice(64, 9000, t_blocks=8 * 16)
    assert per_voice > 0
    with pytest.raises(ValueError, match="GB"):
        ReverbFarm(irs, 64, 9000, hbm_budget_bytes=2 * per_voice)
    with pytest.raises(ValueError, match="voices fit"):
        farm2.farm2_init(irs, 64, 9000, hbm_budget_bytes=2 * per_voice)
    # a budget that fits constructs normally; None disables the check
    farm = ReverbFarm(irs, 64, 9000, hbm_budget_bytes=16 * per_voice)
    assert farm.voices == 4
    ReverbFarm(irs, 64, 9000, hbm_budget_bytes=None)


@pytest.mark.parametrize("stats, budget", [
    ({"bytes_limit": 60_000_000_000, "bytes_in_use": 0}, 58e9),
    ({"bytes_in_use": 0}, None),
    (None, None),
])
def test_farm_auto_budget_follows_device_memory(stats, budget, monkeypatch):
    """The "auto" capacity budget is the device's bytes_limit less the
    stated headroom, and no budget where the device reports no memory
    statistics (the CPU backend); farm2_init applies it."""
    from fft_convolution_tpu.parallel import farm2

    class Dev:
        def __init__(self, s):
            self.s = s

        def memory_stats(self):
            return self.s

    assert farm2.device_budget_bytes(Dev(stats)) == budget
    if budget is not None:
        assert budget == stats["bytes_limit"] - farm2.BUDGET_HEADROOM_BYTES
    # the auto guard reads the default device: a budget below one voice's
    # footprint raises, no statistics constructs
    per_voice = farm2.farm2_bytes_per_voice(64, 9000, t_blocks=8 * 16)
    tiny = {"bytes_limit": farm2.BUDGET_HEADROOM_BYTES + per_voice // 2}
    dev = Dev(stats if budget is None else tiny)
    monkeypatch.setattr(farm2.jax, "devices", lambda: [dev])
    irs = np.zeros((2, 9000), np.float32)
    if budget is None:
        farm2.farm2_init(irs, 64, 9000)
    else:
        with pytest.raises(ValueError, match="voices fit"):
            farm2.farm2_init(irs, 64, 9000)


def test_reverb_farm_per_call_ceiling():
    """T beyond the phased core's per-call bound is a clean ValueError
    (not an in-trace AssertionError), and exactly-at-ceiling still works."""
    farm, irs, rng = _farm(seed=36)
    assert farm.max_blocks_per_call is not None
    assert farm.max_blocks_per_call % farm.period == 0
    too_long = farm.max_blocks_per_call + farm.period
    with pytest.raises(ValueError, match="per-call ceiling"):
        farm.process(np.zeros((too_long, farm.voices, farm.block_size),
                              np.float32))
    x = rng.standard_normal(
        (farm.max_blocks_per_call, farm.voices, farm.block_size)
    ).astype(np.float32)
    y = farm.process(x)
    assert isinstance(y, np.ndarray) and y.shape == x.shape


def test_reverb_farm_mesh_shard_map():
    """A mesh farm runs the stream under shard_map (each device steps its
    local voice shard with no collective) and must match the
    single-device farm; a voice count that does not divide the mesh must
    raise eagerly."""
    from fft_convolution_tpu.parallel import farm as farm_mod

    mesh = farm_mod.make_farm_mesh()
    v = mesh.devices.size
    rng = np.random.default_rng(43)
    irs = rng.standard_normal((v, 9000)).astype(np.float32) * 0.05
    with pytest.raises(ValueError, match="divide"):
        ReverbFarm(irs[: v - 1], 64, 9000, mesh=mesh)
    farm = ReverbFarm(irs, 64, 9000, mesh=mesh)
    ref = ReverbFarm(irs, 64, 9000)
    t = farm.period
    for _ in range(2):
        x = rng.standard_normal((t, v, 64)).astype(np.float32)
        np.testing.assert_allclose(
            farm.process(x), ref.process(x), atol=1e-5
        )


def test_reverb_farm_on_mesh():
    from fft_convolution_tpu.parallel import farm as farm_mod

    mesh = farm_mod.make_farm_mesh()
    v = 2 * mesh.devices.size
    rng = np.random.default_rng(34)
    irs = rng.standard_normal((v, 9000)).astype(np.float32) * 0.05
    farm = ReverbFarm(irs, 64, 9000, mesh=mesh)
    ref = ReverbFarm(irs, 64, 9000)
    t = farm.period
    x = rng.standard_normal((t, v, 64)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(farm.process(x)), np.asarray(ref.process(x)), atol=1e-5
    )


def test_reverb_farm_varying_call_lengths():
    """The fused head path's input-window history carry must hold across
    calls of DIFFERENT lengths (T = p, 2p, p), including immediately
    after an update (the suppressed first period at T = p)."""
    farm, irs, rng = _farm(seed=37)
    v, b, p = farm.voices, farm.block_size, farm.period
    x = rng.standard_normal((4 * p, v, b)).astype(np.float32)
    new_irs = rng.standard_normal((v, 7000)).astype(np.float32) * 0.05

    ys = [np.asarray(farm.process(x[:p]))]
    ys.append(np.asarray(farm.process(x[p:3 * p])))
    farm.update(new_irs)
    ys.append(np.asarray(farm.process(x[3 * p:])))  # T = p right after update
    y = np.concatenate(ys, axis=0)

    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1])
        r1 = e.process(x[:3 * p, voice].reshape(-1))
        e.update_extension(new_irs[voice])
        r2 = e.process(x[3 * p:, voice].reshape(-1))
        np.testing.assert_allclose(
            y[:, voice].reshape(-1), np.concatenate([r1, r2]),
            atol=1e-5, err_msg=f"voice {voice}",
        )


def test_reverb_farm_update_voice_matches_engines():
    """Per-voice update: the touched voice behaves like a standalone
    engine that got update_extension; untouched voices are bit-identical
    to never having updated."""
    farm, irs, rng = _farm(seed=44)
    v, b, p = farm.voices, farm.block_size, farm.period
    t = 2 * p
    x = rng.standard_normal((3 * t, v, b)).astype(np.float32)
    new_ir = rng.standard_normal(6000).astype(np.float32) * 0.05

    twin = farm.clone()  # never updated — pins the untouched voices
    y1 = np.asarray(farm.process(x[:t]))   # populates the khat cache
    _ = twin.process(x[:t])
    farm.update_voice(1, new_ir)
    y2 = np.asarray(farm.process(x[t:2 * t]))
    y3 = np.asarray(farm.process(x[2 * t:]))
    z2 = np.asarray(twin.process(x[t:2 * t]))
    z3 = np.asarray(twin.process(x[2 * t:]))

    # untouched voices: same stream as the never-updated twin
    keep = [0, 2]
    np.testing.assert_array_equal(y2[:, keep], z2[:, keep])
    np.testing.assert_array_equal(y3[:, keep], z3[:, keep])

    # every voice vs its standalone engine.  The farm declares updates at
    # FULL stage capacity (full clean rings are the farm invariant), so
    # the per-voice oracle is an engine updated with the response
    # zero-padded to capacity — a shrinking engine update re-indexes its
    # ring history (reference shrink semantics), which the farm
    # deliberately does not reproduce (farm2_update's docstring).
    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1])
        r1 = e.process(x[:t, voice].reshape(-1))
        if voice == 1:
            e.update_extension(np.pad(new_ir, (0, irs.shape[1] - len(new_ir))))
        r23 = e.process(x[t:, voice].reshape(-1))
        np.testing.assert_allclose(
            np.concatenate([y1[:, voice].reshape(-1),
                            y2[:, voice].reshape(-1),
                            y3[:, voice].reshape(-1)]),
            np.concatenate([r1, r23]), atol=1e-5, err_msg=f"voice {voice}",
        )


def test_reverb_farm_update_voices_subset_and_contracts():
    """Multi-voice subset update, the all-voices equivalence with the
    batched update, and the eager contract checks."""
    import pytest

    farm, irs, rng = _farm(v=4, seed=45)
    v, b, p = farm.voices, farm.block_size, farm.period
    t = 2 * p
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)
    new_irs = rng.standard_normal((v, 7000)).astype(np.float32) * 0.05

    # all-voices subset update == batched full update (same stream after)
    a = farm.clone()
    bfarm = farm.clone()
    _ = a.process(x[:t]); _ = bfarm.process(x[:t])
    a.update_voices(np.arange(v), new_irs)
    bfarm.update(new_irs)
    np.testing.assert_allclose(
        np.asarray(a.process(x[t:])), np.asarray(bfarm.process(x[t:])),
        atol=1e-6,
    )

    # subset {0, 3}
    c = farm.clone()
    _ = c.process(x[:t])
    c.update_voices([3, 0], new_irs[[3, 0]])
    y = np.asarray(c.process(x[t:]))
    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1])
        _ = e.process(x[:t, voice].reshape(-1))
        if voice in (0, 3):
            e.update_extension(new_irs[voice])
        r = e.process(x[t:, voice].reshape(-1))
        np.testing.assert_allclose(
            y[:, voice].reshape(-1), r, atol=1e-5, err_msg=f"voice {voice}"
        )

    # chunked slab path (K > update_voices_chunk splits into consecutive
    # <=chunk calls, bounding the update's transients): force chunk=2 so
    # K=3 exercises it
    # on the small farm, and pin equivalence against one batched call.
    d = farm.clone()
    e2 = farm.clone()
    _ = d.process(x[:t]); _ = e2.process(x[:t])
    d.update_voices_chunk = 2
    d.update_voices([0, 2, 3], new_irs[[0, 2, 3]])
    e2.update_voices([0, 2, 3], new_irs[[0, 2, 3]])
    np.testing.assert_allclose(
        np.asarray(d.process(x[t:])), np.asarray(e2.process(x[t:])),
        atol=1e-6,
    )

    with pytest.raises(ValueError, match="distinct"):
        farm.update_voices([1, 1], new_irs[:2])
    with pytest.raises(ValueError, match="range"):
        farm.update_voices([v], new_irs[:1])
    with pytest.raises(ValueError, match="capacity"):
        farm.update_voice(0, np.zeros(irs.shape[1] + 1, np.float32))
    with pytest.raises(ValueError, match="expected"):
        farm.update_voices([0, 1], new_irs[:1])


def test_reverb_farm_update_voice_short_ir_farm():
    """Per-voice update on the short-IR farm (no big tail stage)."""
    farm, irs, rng = _farm(ir_len=120, seed=46)
    assert farm.cfg.tail is None
    v, b, p = farm.voices, farm.block_size, farm.period
    t = 2 * p
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)
    new_ir = rng.standard_normal(100).astype(np.float32) * 0.05
    _ = farm.process(x[:t])
    farm.update_voice(2, new_ir)
    y = np.asarray(farm.process(x[t:]))
    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1])
        _ = e.process(x[:t, voice].reshape(-1))
        if voice == 2:
            e.update_extension(new_ir)
        r = e.process(x[t:, voice].reshape(-1))
        np.testing.assert_allclose(
            y[:, voice].reshape(-1), r, atol=1e-5, err_msg=f"voice {voice}"
        )


def test_reverb_farm_head_dft_precision_bf16():
    """The opt-in bf16 head-transform tier tracks the highest-precision
    farm within its documented ~1e-2 relative tolerance, and bogus
    precision specs raise eagerly."""
    farm, irs, rng = _farm(seed=47)
    fast = ReverbFarm(irs, 64, irs.shape[1], dft_precision="bf16",
                      tail_dtype=jnp.bfloat16)
    v, b, p = farm.voices, farm.block_size, farm.period
    x = rng.standard_normal((2 * p, v, b)).astype(np.float32)
    ya = np.asarray(farm.process(x))
    yb = np.asarray(fast.process(x))
    rel = np.abs(ya - yb).max() / max(np.abs(ya).max(), 1e-30)
    assert rel < 2e-2, rel
    with pytest.raises(ValueError, match="dft_precision"):
        ReverbFarm(irs, 64, irs.shape[1], dft_precision="bogus")


def test_reverb_farm_update_voice_on_mesh():
    """Per-voice update on a dp-sharded farm (row scatters + fused-axis
    column slab updates under GSPMD) must match the single-device farm."""
    from fft_convolution_tpu.parallel import farm as farm_mod

    mesh = farm_mod.make_farm_mesh()
    v = mesh.devices.size
    rng = np.random.default_rng(51)
    irs = rng.standard_normal((v, 9000)).astype(np.float32) * 0.05
    farm = ReverbFarm(irs, 64, 9000, mesh=mesh)
    ref = ReverbFarm(irs, 64, 9000)
    t = 2 * farm.period
    x = rng.standard_normal((2 * t, v, 64)).astype(np.float32)
    new_ir = rng.standard_normal(6000).astype(np.float32) * 0.05
    np.testing.assert_allclose(farm.process(x[:t]), ref.process(x[:t]),
                               atol=1e-5)
    farm.update_voice(1, new_ir)
    ref.update_voice(1, new_ir)
    np.testing.assert_allclose(farm.process(x[t:]), ref.process(x[t:]),
                               atol=1e-5)


def test_reverb_farm_update_voices_packed_storage():
    """Per-voice update on the plane-packed bf16 farm: the uint32 column
    slab write must match the batched rebuild word for word (same f32
    spectra, same bf16 rounding), and untouched voices stay bit-identical."""
    rng = np.random.default_rng(49)
    v, b, ir_len = 4, 64, 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    farm = ReverbFarm(irs, b, ir_len, tail_dtype=jnp.bfloat16)
    assert farm.state.tail.segments_ir.dtype == jnp.uint32
    p = farm.period
    t = 2 * p
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)
    new_irs = rng.standard_normal((v, 7000)).astype(np.float32) * 0.05

    a = farm.clone()
    bfarm = farm.clone()
    _ = a.process(x[:t]); _ = bfarm.process(x[:t])
    a.update_voices(np.arange(v), new_irs)
    bfarm.update(new_irs)
    np.testing.assert_array_equal(
        np.asarray(a.state.tail.segments_ir),
        np.asarray(bfarm.state.tail.segments_ir),
    )
    np.testing.assert_allclose(
        np.asarray(a.process(x[t:])), np.asarray(bfarm.process(x[t:])),
        atol=1e-6,
    )

    c = farm.clone()
    twin = farm.clone()
    _ = c.process(x[:t]); _ = twin.process(x[:t])
    c.update_voice(2, new_irs[2])
    yc = np.asarray(c.process(x[t:]))
    yt = np.asarray(twin.process(x[t:]))
    keep = [0, 1, 3]
    np.testing.assert_array_equal(yc[:, keep], yt[:, keep])


def test_reverb_farm_random_update_schedule():
    """Randomized interleaving of streams, per-voice updates (random
    subsets/lengths), full updates, and resets vs standalone engines —
    the adversarial schedule the pointwise tests can't enumerate.
    Farm update semantics: oracle engines get the response zero-padded
    to capacity (full-ring invariant, see PARITY.md #5)."""
    farm, irs, rng = _farm(v=4, seed=48)
    v, b, p = farm.voices, farm.block_size, farm.period
    cap = irs.shape[1]
    engines = [TwoStageFFTConvolver(irs[i], b, cap) for i in range(v)]

    for step in range(10):
        action = rng.integers(0, 4)
        if action == 0 and step > 0:           # per-voice subset update
            k = int(rng.integers(1, v + 1))
            idx = rng.permutation(v)[:k]
            new = (rng.standard_normal(
                (k, int(rng.integers(100, cap + 1)))) * 0.05
            ).astype(np.float32)
            farm.update_voices(idx, new)
            for j, voice in enumerate(idx):
                engines[voice].update_extension(
                    np.pad(new[j], (0, cap - new.shape[1])))
        elif action == 1 and step > 0:         # full farm update
            new = (rng.standard_normal((v, cap)) * 0.05).astype(np.float32)
            farm.update(new)
            for voice in range(v):
                engines[voice].update_extension(new[voice])
        elif action == 2 and step > 3:         # reset
            farm.reset()
            for e in engines:
                e.reset()
        t = int(rng.integers(1, 3)) * p        # stream 1-2 periods
        x = rng.standard_normal((t, v, b)).astype(np.float32)
        y = np.asarray(farm.process(x))
        for voice in range(v):
            r = engines[voice].process(x[:, voice].reshape(-1))
            scale = max(np.abs(r).max(), 1.0)
            np.testing.assert_allclose(
                y[:, voice].reshape(-1), r, atol=2e-5 * scale,
                err_msg=f"step {step} voice {voice}",
            )


def test_reverb_farm_long_call():
    """A T = 8-period call (the f32 production shape) exercises the
    delay line's third slot branch: this call's early big-tail outputs
    land in period slots 2.. of the same call's output."""
    farm, irs, rng = _farm(seed=41)
    v, b, p = farm.voices, farm.block_size, farm.period
    x = rng.standard_normal((8 * p, v, b)).astype(np.float32)
    y = np.asarray(farm.process(x))
    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, irs.shape[1])
        r = e.process(x[:, voice].reshape(-1))
        np.testing.assert_allclose(
            y[:, voice].reshape(-1), r, atol=1e-5,
            err_msg=f"voice {voice}",
        )
