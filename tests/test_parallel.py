"""Scale-out tests on the 8-virtual-device CPU mesh.

The reference has no parallelism (SURVEY.md §2); these tests lock in the
scale-out story: vmap farms match per-voice processing exactly, and
the shard_map paths (voice-sharded farm, segment-sharded FDL) match the
single-device engine bit-for-bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fft_convolution_tpu import FFTConvolver
from fft_convolution_tpu.models import uniform
from fft_convolution_tpu.parallel import farm, partition, two_stage_sp


def test_vmap_farm_matches_loop():
    rng = np.random.default_rng(10)
    v, b, t = 4, 64, 20
    irs = rng.standard_normal((v, 300)).astype(np.float32) * 0.1
    x = rng.standard_normal((t, v, b)).astype(np.float32)

    cfg, state = farm.farm_init(jnp.asarray(irs), b, 300)
    _, y = jax.jit(functools.partial(farm.farm_stream, cfg))(state, jnp.asarray(x))
    y = np.asarray(y)

    for voice in range(v):
        c = FFTConvolver(irs[voice], b, 300)
        y_ref = c.process(x[:, voice, :].reshape(-1))
        np.testing.assert_allclose(y[:, voice, :].reshape(-1), y_ref, atol=1e-5)


def test_sharded_farm_matches_unsharded():
    rng = np.random.default_rng(11)
    v, b, t = 8, 64, 12
    irs = rng.standard_normal((v, 256)).astype(np.float32) * 0.1
    x = rng.standard_normal((t, v, b)).astype(np.float32)

    cfg, state = farm.farm_init(jnp.asarray(irs), b, 256)
    _, y_ref = jax.jit(functools.partial(farm.farm_stream, cfg))(state, jnp.asarray(x))

    mesh = farm.make_farm_mesh()
    assert mesh.devices.size == 8
    cfg2, state2 = farm.farm_init(jnp.asarray(irs), b, 256)
    state2 = farm.shard_farm(mesh, state2)
    run = farm.sharded_farm_stream(cfg2, mesh)
    _, y = run(state2, jnp.asarray(x))
    # partitioned execution reorders the f32 reductions slightly
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-5)


def test_segment_sharded_fdl_matches_uniform():
    """The 'sp'-sharded FDL (distributed MAC + psum) must reproduce the
    single-device engine exactly, including full ring wraparound."""
    rng = np.random.default_rng(12)
    b = 64
    ir = rng.standard_normal(b * 16).astype(np.float32) * 0.1  # 16 segments / 8 devs
    t = 40  # > 2 ring periods
    x = rng.standard_normal((t, b)).astype(np.float32)

    mesh = partition.make_mesh()
    cfg, state = partition.init(mesh, ir, b, len(ir))
    run = partition.build_stream(cfg, mesh)
    _, y = run(state, jnp.asarray(x))

    c = FFTConvolver(ir, b, len(ir))
    y_ref = c.process(x.reshape(-1))
    np.testing.assert_allclose(np.asarray(y).reshape(-1), y_ref, atol=1e-5)


def test_segment_sharded_padding():
    """seg_count not divisible by the mesh size: rows pad, output unchanged."""
    rng = np.random.default_rng(13)
    b = 64
    ir = rng.standard_normal(b * 5 + 17).astype(np.float32) * 0.1  # 6 segs -> pad to 8
    x = rng.standard_normal((16, b)).astype(np.float32)

    mesh = partition.make_mesh()
    cfg, state = partition.init(mesh, ir, b, len(ir))
    assert cfg.seg_count % mesh.devices.size == 0
    run = partition.build_stream(cfg, mesh)
    _, y = run(state, jnp.asarray(x))

    c = FFTConvolver(ir, b, len(ir))
    y_ref = c.process(x.reshape(-1))
    np.testing.assert_allclose(np.asarray(y).reshape(-1), y_ref, atol=1e-5)


def test_segment_sharded_fdl_on_2d_mesh():
    """Regression: the FDL is sharded over the 'sp' AXIS, not the device
    count.  On a multi-axis (dp, sp) serving mesh P("sp") gives each body
    instance seg_count/|sp| rows; sizing the slab by devices.size silently
    mis-indexed the ring (caught only past the first block, which is why
    the single-step dryrun missed it)."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(21)
    b = 64
    ir = rng.standard_normal(b * 8).astype(np.float32) * 0.1
    x = rng.standard_normal((24, b)).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))
    cfg, state = partition.init(mesh, ir, b, len(ir))
    assert cfg.seg_count % 4 == 0
    run = partition.build_stream(cfg, mesh)
    state, y = run(state, jnp.asarray(x))

    c = FFTConvolver(ir, b, len(ir))
    y_ref = c.process(x.reshape(-1))
    np.testing.assert_allclose(np.asarray(y).reshape(-1), y_ref, atol=1e-5)

    # and the update path under the 2-D mesh
    ir_b = rng.standard_normal(b * 3).astype(np.float32) * 0.1
    padded = np.zeros(cfg.seg_count * b, np.float32)
    padded[: len(ir_b)] = ir_b
    state = jax.jit(functools.partial(partition.update, cfg))(
        state, jnp.asarray(padded), jnp.asarray(len(ir_b), jnp.int32)
    )
    _, y2 = run(state, jnp.asarray(x))
    c.update(ir_b)
    np.testing.assert_allclose(
        np.asarray(y2).reshape(-1), c.process(x.reshape(-1)), atol=1e-5
    )


def test_farm_update_batched():
    rng = np.random.default_rng(14)
    v, b = 3, 64
    irs = rng.standard_normal((v, 256)).astype(np.float32) * 0.1
    new_irs = rng.standard_normal((v, 256)).astype(np.float32) * 0.1
    x = rng.standard_normal((6, v, b)).astype(np.float32)

    cfg, state = farm.farm_init(jnp.asarray(irs), b, 256)
    stream = jax.jit(functools.partial(farm.farm_stream, cfg))
    state, _ = stream(state, jnp.asarray(x[:3]))
    padded = jnp.pad(jnp.asarray(new_irs), ((0, 0), (0, cfg.seg_count * cfg.block_size - 256)))
    state = jax.jit(functools.partial(farm.farm_update, cfg))(
        state, padded, jnp.full((v,), 256, jnp.int32)
    )
    _, y = stream(state, jnp.asarray(x[3:]))
    y = np.asarray(y)

    for voice in range(v):
        c = FFTConvolver(irs[voice], b, 256)
        c.process(x[:3, voice, :].reshape(-1))
        c.update(new_irs[voice])
        y_ref = c.process(x[3:, voice, :].reshape(-1))
        np.testing.assert_allclose(y[:, voice, :].reshape(-1), y_ref, atol=1e-5)


def test_two_stage_farm_matches_per_voice():
    from fft_convolution_tpu import TwoStageFFTConvolver
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(15)
    v, b = 3, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    cfg, state = farm2.farm2_init(irs, b, ir_len)
    p = cfg.period
    t = 3 * p
    x = rng.standard_normal((t, v, b)).astype(np.float32)

    run = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    state, y1 = run(state, jnp.asarray(x))
    state, y2 = run(state, jnp.asarray(x))  # continuation across calls
    y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=0)

    for voice in range(v):
        c = TwoStageFFTConvolver(irs[voice], b, ir_len)
        y_ref = c.process(np.concatenate([x, x], axis=0)[:, voice, :].reshape(-1))
        np.testing.assert_allclose(
            y[:, voice, :].reshape(-1), y_ref, atol=1e-5,
            err_msg=f"voice {voice}",
        )


def test_farm2_sharded_matches_unsharded():
    """farm2_shard places head-side leaves voice-axis-0 and the big-tail
    rows-leading leaves voice-axis-2 over a ('dp',) mesh; the jitted stream
    on the sharded state must match the unsharded farm (zero steady-state
    collectives — pure dp over the voice axis)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(26)
    v, b = 8, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    cfg, state = farm2.farm2_init(irs, b, ir_len)
    assert cfg.tail is not None  # the rows-leading tail path must be live
    t = 2 * cfg.period
    x = rng.standard_normal((t, v, b)).astype(np.float32)

    run = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    state_ref = jax.tree.map(jnp.copy, state)
    state_ref, y_ref1 = run(state_ref, jnp.asarray(x))
    _, y_ref2 = run(state_ref, jnp.asarray(x))

    mesh = farm.make_farm_mesh()
    assert mesh.devices.size == 8
    sstate = farm2.farm2_shard(mesh, state)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "dp")))
    sstate, y1 = run(sstate, xs)
    _, y2 = run(sstate, xs)

    np.testing.assert_allclose(np.asarray(y1), np.asarray(y_ref1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y_ref2), atol=1e-5)


def test_farm2_bf16_tail_close_to_f32():
    """Opt-in bf16 tail storage (table + ring): outputs must track the f32
    farm within bf16's ~3 significant digits.  The head/tail0 stages stay
    exact, so overall error is bounded by the tail contribution's
    precision."""
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(28)
    v, b = 2, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05

    cfg_f, state_f = farm2.farm2_init(irs, b, ir_len)
    cfg_b, state_b = farm2.farm2_init(irs, b, ir_len, tail_dtype=jnp.bfloat16)
    # bf16 tail storage is plane-packed uint32 words (ops/packing.py)
    assert state_b.tail.segments_ir.dtype == jnp.uint32
    assert state_b.tail.segments_ir.ndim == 2
    assert cfg_b.tail.seg_count % 8 == 0
    t = 2 * cfg_f.period
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)

    run_f = jax.jit(functools.partial(farm2.farm2_stream, cfg_f))
    run_b = jax.jit(functools.partial(farm2.farm2_stream, cfg_b))

    state_f, y_f1 = run_f(state_f, jnp.asarray(x[:t]))
    state_b, y_b1 = run_b(state_b, jnp.asarray(x[:t]))
    _, y_f2 = run_f(state_f, jnp.asarray(x[t:]))
    _, y_b2 = run_b(state_b, jnp.asarray(x[t:]))

    y_f = np.concatenate([np.asarray(y_f1), np.asarray(y_f2)])
    y_b = np.concatenate([np.asarray(y_b1), np.asarray(y_b2)])
    scale = np.max(np.abs(y_f))
    assert np.max(np.abs(y_b - y_f)) < 2e-2 * scale


def test_farm2_bf16_tail_dft_precision():
    """tail_dft_precision="bf16" (bf16 operands in the big tail's forward/
    inverse block DFT matmuls, ops/fft._mm_mode) stays in the same ~1e-3
    accuracy tier as the packed bf16 storage it pairs with, and leaves the
    head stages bit-exact (they carry the direct sound).  Measured on this
    seed: storage-only 1.8e-3 rel, storage+bf16 DFTs 4.3e-3 rel."""
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(29)
    v, b = 3, 128
    sr = 4000
    ir_len = 8 * sr
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.01

    cfg, state_f = farm2.farm2_init(irs, b, ir_len)
    _, state_b = farm2.farm2_init(irs, b, ir_len, tail_dtype=jnp.bfloat16)
    t = 2 * cfg.period
    xs = rng.standard_normal((4, t, v, b)).astype(np.float32)

    run_f = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    run_b = jax.jit(functools.partial(
        farm2.farm2_stream, cfg, tail_dft_precision="bf16"
    ))
    ys_f, ys_b = [], []
    sf, sb = state_f, state_b
    for x in xs:
        sf, yf = run_f(sf, jnp.asarray(x))
        sb, yb = run_b(sb, jnp.asarray(x))
        ys_f.append(np.asarray(yf))
        ys_b.append(np.asarray(yb))
    y_f = np.concatenate(ys_f)
    y_b = np.concatenate(ys_b)
    scale = np.max(np.abs(y_f))
    assert np.max(np.abs(y_b - y_f)) < 1e-2 * scale
    # the first two periods have no tail contribution (two-period delay):
    # head+tail0 run at full precision regardless of the tail knob
    np.testing.assert_allclose(ys_b[0], ys_f[0], atol=1e-5 * scale)


def test_farm2_update_batched():
    """Batched farm IR swap at a period boundary: every voice must match a
    standalone two-stage engine's update_extension (the farm keeps rings
    clean via full-capacity zero-padding; trailing zero segments are
    live-but-silent, src/fft_convolver.rs:111-118)."""
    from fft_convolution_tpu import TwoStageFFTConvolver
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(25)
    v, b = 3, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    new_irs = rng.standard_normal((v, 5000)).astype(np.float32) * 0.05

    cfg, state = farm2.farm2_init(irs, b, ir_len)
    t = 2 * cfg.period
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)

    run = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    state, y1 = run(state, jnp.asarray(x[:t]))
    state = jax.jit(functools.partial(farm2.farm2_update, cfg))(
        state, jnp.asarray(new_irs)
    )
    state, y2 = run(state, jnp.asarray(x[t:]))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=0)

    for voice in range(v):
        c = TwoStageFFTConvolver(irs[voice], b, ir_len)
        r1 = c.process(x[:t, voice, :].reshape(-1))
        c.update_extension(new_irs[voice])
        r2 = c.process(x[t:, voice, :].reshape(-1))
        np.testing.assert_allclose(
            y[:, voice, :].reshape(-1), np.concatenate([r1, r2]), atol=1e-5,
            err_msg=f"voice {voice}",
        )


def test_sharded_update_matches_uniform_mid_stream():
    """Sharded update() mid-stream (shrink + transient, src/fft_convolver.rs:
    174-213): outputs must match the single-device engine's update at 1e-5,
    INCLUDING the shrunk-ring transient where current >= active."""
    rng = np.random.default_rng(16)
    b = 64
    ir_a = rng.standard_normal(b * 16).astype(np.float32) * 0.1  # 16 segs / 8 devs
    ir_b = rng.standard_normal(b * 5).astype(np.float32) * 0.1   # shrink to 5
    x = rng.standard_normal((48, b)).astype(np.float32)

    sh = partition.ShardedFFTConvolver(ir_a, b, len(ir_a))
    y1 = sh.process(x[:13].reshape(-1))   # current walks into [11..15] zone
    sh.update(ir_b)                        # active 16 -> 5 while current = 3
    y2 = sh.process(x[13:].reshape(-1))

    c = FFTConvolver(ir_a, b, len(ir_a))
    r1 = c.process(x[:13].reshape(-1))
    c.update(ir_b)
    r2 = c.process(x[13:].reshape(-1))

    np.testing.assert_allclose(y1, r1, atol=1e-5)
    np.testing.assert_allclose(y2, r2, atol=1e-5)


def test_sharded_update_shrunk_ring_transient():
    """Update while current >= new active count: writes land in dead slots
    until the head decrements below active (the gather fallback path)."""
    rng = np.random.default_rng(17)
    b = 64
    ir_a = rng.standard_normal(b * 16).astype(np.float32) * 0.1
    ir_b = rng.standard_normal(b * 2).astype(np.float32) * 0.1
    x = rng.standard_normal((40, b)).astype(np.float32)

    sh = partition.ShardedFFTConvolver(ir_a, b, len(ir_a))
    c = FFTConvolver(ir_a, b, len(ir_a))
    # after 2 blocks current = 14 (decrementing ring), far above active = 2
    np.testing.assert_allclose(
        sh.process(x[:2].reshape(-1)), c.process(x[:2].reshape(-1)), atol=1e-5
    )
    sh.update(ir_b)
    c.update(ir_b)
    np.testing.assert_allclose(
        sh.process(x[2:].reshape(-1)), c.process(x[2:].reshape(-1)), atol=1e-5
    )


def test_sharded_update_padded_seg_count():
    """seg_count padding (6 -> 8 rows): the sharded engine equals a reference
    convolver with max_response_length padded to the mesh multiple."""
    rng = np.random.default_rng(18)
    b = 64
    ir_a = rng.standard_normal(b * 5 + 17).astype(np.float32) * 0.1  # 6 segs
    ir_b = rng.standard_normal(b * 3).astype(np.float32) * 0.1
    x = rng.standard_normal((32, b)).astype(np.float32)

    sh = partition.ShardedFFTConvolver(ir_a, b, len(ir_a))
    assert sh.cfg.seg_count == 8
    c = FFTConvolver(ir_a, b, 8 * b)  # the documented padded-max equivalent
    np.testing.assert_allclose(
        sh.process(x[:11].reshape(-1)), c.process(x[:11].reshape(-1)), atol=1e-5
    )
    sh.update(ir_b)
    c.update(ir_b)
    np.testing.assert_allclose(
        sh.process(x[11:].reshape(-1)), c.process(x[11:].reshape(-1)), atol=1e-5
    )
    with np.testing.assert_raises(Exception):
        sh.update(np.zeros(len(ir_a) + 1, np.float32))  # longer than declared


def test_sharded_reset_repeatable():
    """reset() clears input state, keeps the IR (src/fft_convolver.rs:296-307)."""
    rng = np.random.default_rng(19)
    b = 64
    ir = rng.standard_normal(b * 16).astype(np.float32) * 0.1
    x = rng.standard_normal((16, b)).astype(np.float32)

    sh = partition.ShardedFFTConvolver(ir, b, len(ir))
    y1 = sh.process(x.reshape(-1))
    sh.reset()
    y2 = sh.process(x.reshape(-1))
    np.testing.assert_allclose(y1, y2, atol=1e-6)


def test_sharded_two_stage_matches_single_device():
    """Sharded long-IR two-stage (head/tail0 replicated, main tail sp-sharded):
    must match the single-device TwoStageFFTConvolver at 1e-5 across calls."""
    from fft_convolution_tpu import TwoStageFFTConvolver

    rng = np.random.default_rng(22)
    b = 64
    ir_len = 4096
    ir = rng.standard_normal(ir_len).astype(np.float32) * 0.05

    sh = two_stage_sp.ShardedTwoStageConvolver(ir, b, ir_len)
    assert sh.cfg.tail_block == 512 and sh.cfg.period == 8
    ref = TwoStageFFTConvolver(ir, b, ir_len)

    x = rng.standard_normal(4 * sh.cfg.tail_block).astype(np.float32)
    # two calls: state carries across jit invocations
    half = len(x) // 2
    y = np.concatenate([sh.process(x[:half]), sh.process(x[half:])])
    y_ref = ref.process(x)
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_sharded_two_stage_update_reset_clone():
    from fft_convolution_tpu import TwoStageFFTConvolver

    rng = np.random.default_rng(23)
    b = 64
    ir_len = 4096
    ir_a = rng.standard_normal(ir_len).astype(np.float32) * 0.05
    ir_b = rng.standard_normal(2000).astype(np.float32) * 0.05

    sh = two_stage_sp.ShardedTwoStageConvolver(ir_a, b, ir_len)
    ref = TwoStageFFTConvolver(ir_a, b, ir_len)
    tb = sh.cfg.tail_block
    x = rng.standard_normal(4 * tb).astype(np.float32)

    # update surface matches the reference todo!(); extension matches the
    # single-device extension semantics
    with np.testing.assert_raises(NotImplementedError):
        sh.update(ir_b)
    np.testing.assert_allclose(
        sh.process(x[: 2 * tb]), ref.process(x[: 2 * tb]), atol=1e-5
    )
    snap = sh.snapshot()
    sh.update_extension(ir_b)
    ref.update_extension(ir_b)
    y_updated = ref.process(x[2 * tb :])
    np.testing.assert_allclose(sh.process(x[2 * tb :]), y_updated, atol=1e-5)

    # restore + clone independence: the twin takes the update, the restored
    # original continues on the old IR
    sh.restore(snap)
    twin = sh.clone()
    twin.update_extension(ir_b)
    np.testing.assert_allclose(twin.process(x[2 * tb :]), y_updated, atol=1e-5)
    ref2 = TwoStageFFTConvolver(ir_a, b, ir_len)
    ref2.process(x[: 2 * tb])
    np.testing.assert_allclose(
        sh.process(x[2 * tb :]), ref2.process(x[2 * tb :]), atol=1e-5
    )

    # reset repeatability (src/fft_convolver.rs:497-511)
    sh2 = two_stage_sp.ShardedTwoStageConvolver(ir_a, b, ir_len)
    y1 = sh2.process(x)
    sh2.reset()
    y2 = sh2.process(x)
    np.testing.assert_allclose(y1, y2, atol=1e-6)

    # too-short IR: nothing reaches the main tail
    with np.testing.assert_raises(ValueError):
        two_stage_sp.ShardedTwoStageConvolver(ir_b, b, 600)
    # misaligned input
    with np.testing.assert_raises(ValueError):
        sh.process(np.zeros(tb + b, np.float32))


def test_crossfade_wraps_sharded_engine():
    """Engine-genericity across chips: CrossfadeConvolver<T> accepts the
    sharded FDL (the reference wrapper is generic over any Convolution,
    src/crossfade_convolver.rs:3-17) — live artifact-free IR switching on
    an IR that spans the mesh."""
    from fft_convolution_tpu import CrossfadeConvolver

    rng = np.random.default_rng(24)
    b = 64
    ir_a = rng.standard_normal(b * 8).astype(np.float32) * 0.1
    ir_b = rng.standard_normal(b * 8).astype(np.float32) * 0.1
    x = rng.standard_normal((24, b)).astype(np.float32)

    cf_sh = CrossfadeConvolver(
        partition.ShardedFFTConvolver(ir_a, b, len(ir_a)), len(ir_a), b, 128
    )
    cf_ref = CrossfadeConvolver(FFTConvolver(ir_a, b, len(ir_a)), len(ir_a), b, 128)

    y1 = [cf_sh.process(x[:8].reshape(-1)), cf_ref.process(x[:8].reshape(-1))]
    cf_sh.update(ir_b)
    cf_ref.update(ir_b)
    y2 = [cf_sh.process(x[8:].reshape(-1)), cf_ref.process(x[8:].reshape(-1))]
    np.testing.assert_allclose(y1[0], y1[1], atol=1e-5)
    np.testing.assert_allclose(y2[0], y2[1], atol=1e-5)
    # fade actually moved: post-update output differs from the no-update run
    cf_none = CrossfadeConvolver(
        partition.ShardedFFTConvolver(ir_a, b, len(ir_a)), len(ir_a), b, 128
    )
    cf_none.process(x[:8].reshape(-1))
    assert np.max(np.abs(y2[0] - cf_none.process(x[8:].reshape(-1)))) > 1e-3


def test_sharded_clone_independent():
    rng = np.random.default_rng(20)
    b = 64
    ir = rng.standard_normal(b * 8).astype(np.float32) * 0.1
    x = rng.standard_normal((8, b)).astype(np.float32)

    sh = partition.ShardedFFTConvolver(ir, b, len(ir))
    sh.process(x[:4].reshape(-1))
    twin = sh.clone()
    twin.update(rng.standard_normal(b).astype(np.float32) * 0.1)
    twin.process(x[4:].reshape(-1))
    # original unaffected
    ref = partition.ShardedFFTConvolver(ir, b, len(ir))
    ref.process(x[:4].reshape(-1))
    np.testing.assert_allclose(
        sh.process(x[4:].reshape(-1)), ref.process(x[4:].reshape(-1)), atol=1e-6
    )


def test_farm2_head_khat_parity():
    """Precomputed head-kernel meta-spectra (farm2_head_khat) must give
    bit-identical streams to the inline kernel DFT — same matmul program,
    just hoisted — and a WRONG-m khat must be rejected eagerly."""
    import pytest

    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(41)
    v, b = 3, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    cfg, state = farm2.farm2_init(irs, b, ir_len)
    assert cfg.tail is not None
    t = 2 * cfg.period
    x = rng.standard_normal((t, v, b)).astype(np.float32)

    khat = jax.jit(functools.partial(
        farm2.farm2_head_khat, cfg), static_argnums=(1,))(state, t)
    run = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    run_k = jax.jit(functools.partial(farm2.farm2_stream, cfg))

    state_ref = jax.tree.map(jnp.copy, state)
    for call in range(2):
        state_ref, y_ref = run(state_ref, jnp.asarray(x))
        state, y = run_k(state, jnp.asarray(x), head_khat=khat)
        np.testing.assert_array_equal(
            np.asarray(y), np.asarray(y_ref), err_msg=f"call {call}"
        )

    bad = jax.jit(functools.partial(
        farm2.farm2_head_khat, cfg), static_argnums=(1,))(state, 16 * t)
    with pytest.raises(ValueError, match="meta-bins"):
        run_k(state, jnp.asarray(x), head_khat=bad)


def test_reverb_farm_khat_cache_coherent():
    """ReverbFarm's khat cache must be invalidated by update() and
    restore(), and clones must not share cache mutations."""
    from fft_convolution_tpu import ReverbFarm, TwoStageFFTConvolver

    rng = np.random.default_rng(42)
    v, b, ir_len = 2, 64, 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    new_irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    farm = ReverbFarm(irs, b, ir_len)
    t = farm.period
    x = rng.standard_normal((3 * t, v, b)).astype(np.float32)

    y1 = farm.process(x[:t])
    assert farm._khat_cache  # populated
    twin = farm.clone()
    snap = farm.snapshot()
    farm.update(new_irs)
    assert not farm._khat_cache  # invalidated by update
    y2 = farm.process(x[t:2 * t])
    # the clone kept the OLD irs; its stream must use the OLD khat
    y2_twin = twin.process(x[t:2 * t])
    # the restored farm rewinds to the OLD irs mid-cache
    farm.restore(snap)
    y2_restored = farm.process(x[t:2 * t])
    np.testing.assert_allclose(y2_twin, y2_restored, atol=1e-6)

    for voice in range(v):
        e = TwoStageFFTConvolver(irs[voice], b, ir_len)
        r1 = e.process(x[:t, voice, :].reshape(-1))
        e.update_extension(new_irs[voice])
        r2 = e.process(x[t:2 * t, voice, :].reshape(-1))
        np.testing.assert_allclose(
            y1[:, voice, :].reshape(-1), r1, atol=1e-5)
        np.testing.assert_allclose(
            y2[:, voice, :].reshape(-1), r2, atol=1e-5,
            err_msg=f"voice {voice}: stale khat after update()?")


def test_farm2_bf16_update_packed_table():
    """farm2_update must rebuild the PACKED uint32 tail table correctly:
    post-update streams track the f32 farm at bf16 tolerance."""
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(43)
    v, b = 2, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    new_irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05

    cfg_f, state_f = farm2.farm2_init(irs, b, ir_len)
    cfg_b, state_b = farm2.farm2_init(irs, b, ir_len, tail_dtype=jnp.bfloat16)
    t = 2 * cfg_f.period
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)

    run_f = jax.jit(functools.partial(farm2.farm2_stream, cfg_f))
    run_b = jax.jit(functools.partial(farm2.farm2_stream, cfg_b))
    upd_f = jax.jit(functools.partial(farm2.farm2_update, cfg_f))
    upd_b = jax.jit(functools.partial(farm2.farm2_update, cfg_b))

    state_f, _ = run_f(state_f, jnp.asarray(x[:t]))
    state_b, _ = run_b(state_b, jnp.asarray(x[:t]))
    state_f = upd_f(state_f, jnp.asarray(new_irs))
    state_b = upd_b(state_b, jnp.asarray(new_irs))
    assert state_b.tail.segments_ir.dtype == jnp.uint32
    _, y_f = run_f(state_f, jnp.asarray(x[t:]))
    _, y_b = run_b(state_b, jnp.asarray(x[t:]))
    scale = np.max(np.abs(np.asarray(y_f)))
    assert np.max(np.abs(np.asarray(y_b) - np.asarray(y_f))) < 2e-2 * scale


def test_farm2_stream_sharded_packed():
    """The shard_map stream (farm2_stream_sharded) with PACKED bf16 tail
    storage: the rank-2 uint32 table's fused V*B axis shards voice-chunked
    (farm2_pspecs' P(None, 'dp')), each device stepping its local shard —
    must track the unsharded bf16 farm exactly (same state, same
    arithmetic)."""
    from fft_convolution_tpu.parallel import farm2

    rng = np.random.default_rng(44)
    v, b = 8, 64
    ir_len = 9000
    irs = rng.standard_normal((v, ir_len)).astype(np.float32) * 0.05
    cfg, state = farm2.farm2_init(irs, b, ir_len, tail_dtype=jnp.bfloat16)
    assert state.tail.segments.ndim == 2  # plane-packed uint32 path
    t = 2 * cfg.period
    x = rng.standard_normal((2 * t, v, b)).astype(np.float32)

    run_ref = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    state_ref = jax.tree.map(jnp.copy, state)
    state_ref, y_ref1 = run_ref(state_ref, jnp.asarray(x[:t]))
    _, y_ref2 = run_ref(state_ref, jnp.asarray(x[t:]))

    mesh = farm.make_farm_mesh()
    run_sm = jax.jit(functools.partial(
        farm2.farm2_stream_sharded, mesh, cfg
    ))
    sstate = farm2.farm2_shard(mesh, state)
    sstate, y1 = run_sm(sstate, jnp.asarray(x[:t]))
    _, y2 = run_sm(sstate, jnp.asarray(x[t:]))

    np.testing.assert_allclose(np.asarray(y1), np.asarray(y_ref1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y_ref2), atol=1e-5)


def test_uniform_farm_memory_ceiling():
    """A uniform farm that cannot fit one chip must raise eagerly with a
    pointer to the two-stage ReverbFarm, not OOM mid-init."""
    import pytest

    with pytest.raises(ValueError, match="ReverbFarm"):
        farm.farm_init(np.zeros((256, 48000 * 60), np.float32), 128,
                       48000 * 60)
    assert farm.farm_bytes_per_voice(128, 48000 * 60) > 100e6


def test_farm_khat_exact():
    """farm_stream served with farm_khat must match the inline-khat stream
    bit-for-bit (same matmul program, hoisted), incl. a shrunk voice."""
    import functools

    import numpy as np

    from fft_convolution_tpu.parallel import farm

    rng = np.random.default_rng(52)
    v, b = 3, 64
    irs = rng.standard_normal((v, b * 7)).astype(np.float32) * 0.1
    cfg, state = farm.farm_init(jnp.asarray(irs), b, b * 7)
    t = 16
    x = jnp.asarray(rng.standard_normal((t, v, b)).astype(np.float32))

    kh = jax.jit(functools.partial(farm.farm_khat, cfg),
                 static_argnums=(1,))(state, t)
    run = jax.jit(functools.partial(farm.farm_stream, cfg))
    s1, y1 = run(state, x)
    s2, y2 = run(state, x, kern_hat=kh)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    np.testing.assert_array_equal(np.asarray(s1.segments),
                                  np.asarray(s2.segments))

    # shrink one voice's IR mid-stream: the mask is part of the khat
    short = np.zeros((v, b * 7), np.float32)
    short[:, : b * 3] = rng.standard_normal((v, b * 3)).astype(np.float32)
    state3 = farm.farm_update(cfg, s1, jnp.asarray(short),
                              jnp.full((v,), b * 3, jnp.int32))
    kh3 = jax.jit(functools.partial(farm.farm_khat, cfg),
                  static_argnums=(1,))(state3, t)
    s4, y4 = run(state3, x)
    _, y5 = run(state3, x, kern_hat=kh3)
    np.testing.assert_array_equal(np.asarray(y4), np.asarray(y5))
