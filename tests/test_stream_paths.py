"""Cross-checks between streaming implementations.

Every engine has one semantic reference (the per-block scan mirroring the
reference while-loop) and faster batched paths; these tests pin them to each
other, including state handoff when paths interleave mid-stream.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fft_convolution_tpu.models import two_stage, uniform
from fft_convolution_tpu.ops.fft import generate_sinusoid


def test_uniform_batched_stream_matches_scan():
    rng = np.random.default_rng(20)
    ir = rng.standard_normal(3000).astype(np.float32) * 0.1
    cfg, state = uniform.init(ir, 64, len(ir))
    x = jnp.asarray(rng.standard_normal((101, 64)).astype(np.float32))

    s_scan, y_scan = jax.jit(functools.partial(uniform.process_stream_scan, cfg))(state, x)
    s_fast, y_fast = jax.jit(functools.partial(uniform.process_stream, cfg))(state, x)

    np.testing.assert_allclose(np.asarray(y_fast), np.asarray(y_scan), atol=1e-5)
    for a, b, name in zip(s_fast, s_scan, uniform.UniformState._fields):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-4, err_msg=f"state field {name}"
        )


def test_uniform_batched_stream_state_handoff():
    """fast -> scan -> fast interleaving must equal pure scan."""
    rng = np.random.default_rng(21)
    ir = rng.standard_normal(1000).astype(np.float32) * 0.1
    cfg, s0 = uniform.init(ir, 64, len(ir))
    x = rng.standard_normal((60, 64)).astype(np.float32)

    scan = jax.jit(functools.partial(uniform.process_stream_scan, cfg))
    fast = jax.jit(functools.partial(uniform.process_stream, cfg))

    s_ref, y_ref = scan(s0, jnp.asarray(x))

    s = s0
    ys = []
    for fn, lo, hi in [(fast, 0, 20), (scan, 20, 41), (fast, 41, 60)]:
        s, y = fn(s, jnp.asarray(x[lo:hi]))
        ys.append(np.asarray(y))
    np.testing.assert_allclose(
        np.concatenate(ys), np.asarray(y_ref), atol=1e-5
    )


def test_two_stage_aligned_matches_scan():
    rng = np.random.default_rng(22)
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    cfg, state = two_stage.init(ir, 64, len(ir))
    p = cfg.period
    q = 5
    x = jnp.asarray(rng.standard_normal((q * p, 64)).astype(np.float32))

    s_scan, y_scan = jax.jit(functools.partial(two_stage.process_stream, cfg))(state, x)
    s_fast, y_fast = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg))(state, x)

    np.testing.assert_allclose(np.asarray(y_fast), np.asarray(y_scan), atol=1e-5)
    flat_scan, _ = jax.tree.flatten(s_scan)
    flat_fast, treedef = jax.tree.flatten(s_fast)
    for a, b in zip(flat_fast, flat_scan):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_two_stage_aligned_single_period_and_handoff():
    """q = 1 edge case, then continue with the scan path mid-period."""
    rng = np.random.default_rng(23)
    ir = rng.standard_normal(9000).astype(np.float32) * 0.05
    cfg, s0 = two_stage.init(ir, 64, len(ir))
    p = cfg.period
    x = rng.standard_normal(((2 * p) + 3, 64)).astype(np.float32)

    scan = jax.jit(functools.partial(two_stage.process_stream, cfg))
    fast = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg))

    s_ref, y_ref = scan(s0, jnp.asarray(x))

    s = s0
    ys = []
    s, y = fast(s, jnp.asarray(x[:p])); ys.append(np.asarray(y))       # q=1
    s, y = fast(s, jnp.asarray(x[p:2 * p])); ys.append(np.asarray(y))  # q=1 again
    s, y = scan(s, jnp.asarray(x[2 * p:])); ys.append(np.asarray(y))   # ragged tail
    np.testing.assert_allclose(
        np.concatenate(ys), np.asarray(y_ref), atol=1e-5
    )


def test_two_stage_wrapper_uses_aligned_path():
    """End-to-end through the public API with a period-multiple input, vs
    the uniform engine (the reference's own equivalence, tests.rs:148-175)."""
    from fft_convolution_tpu import FFTConvolver, TwoStageFFTConvolver

    block = 64
    response = generate_sinusoid(12000, 1000.0, 44100.0, 0.1)
    a = FFTConvolver(response, block // 2, len(response))
    b = TwoStageFFTConvolver(response, block, len(response))
    n = b.cfg.tail_block * 4
    x = generate_sinusoid(n, 1300.0, 44100.0, 0.1)
    y_a = a.process(x)
    y_b = b.process(x)  # n % tail_block == 0 -> aligned path
    np.testing.assert_allclose(y_a, y_b, atol=1e-5)


def test_stream_corr_phased_matches_sequential():
    """The roll-free phased corr core (doubled periodic IR table, phase in
    ``current``) must match the sequential scan across calls with varying
    lengths — the phase walks every residue mod seg_count, covering the
    ``n - q - s == n`` and wraparound edges."""
    rng = np.random.default_rng(61)
    b = 64
    n_segs = 5
    ir = rng.standard_normal(b * n_segs).astype(np.float32) * 0.1
    cfg, state = uniform.init(ir, b, len(ir))
    assert cfg.seg_count == n_segs

    ext_idx = jnp.arange(n_segs + uniform.CORR_EXTRA_ROWS) % n_segs
    ph_state = state._replace(
        segments_ir=jnp.concatenate(
            [state.segments_ir, jnp.take(state.segments_ir, ext_idx, axis=0)],
            axis=0,
        )
    )
    run_ph = jax.jit(functools.partial(uniform.stream_corr_phased_unguarded, cfg))
    run_ref = jax.jit(functools.partial(uniform.process_stream_scan, cfg))

    for call, t in enumerate([2, 3, 1, 5, 4, 2, 2]):
        x = rng.standard_normal((t, b)).astype(np.float32)
        ph_state, y = run_ph(ph_state, jnp.asarray(x))
        state, y_ref = run_ref(state, jnp.asarray(x))
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(y_ref), atol=1e-5,
            err_msg=f"call {call} (T={t})",
        )
        np.testing.assert_allclose(
            np.asarray(ph_state.overlap), np.asarray(state.overlap),
            atol=1e-5)


def test_stream_corr_rebased_matches_sequential():
    """The correlation tail core (rebased-ring state convention: extended IR
    table, current pinned at 0) must match the sequential block scan's
    OUTPUTS across calls, ring wraparound, and varying call lengths — the
    internal slot labeling legitimately differs by the rebase rotation, so
    state correctness is covered by the cross-call continuation."""
    rng = np.random.default_rng(60)
    b = 64
    n_segs = 5
    ir = rng.standard_normal(b * n_segs).astype(np.float32) * 0.1
    cfg, state = uniform.init(ir, b, len(ir))
    assert cfg.seg_count == n_segs

    ext_idx = jnp.arange(uniform.CORR_EXTRA_ROWS) % n_segs
    corr_state = state._replace(
        segments_ir=jnp.concatenate(
            [state.segments_ir, jnp.take(state.segments_ir, ext_idx, axis=0)],
            axis=0,
        )
    )
    run_corr = jax.jit(functools.partial(uniform.stream_corr_rebased_unguarded, cfg))
    run_ref = jax.jit(functools.partial(uniform.process_stream_scan, cfg))

    for call, t in enumerate([2, 3, 1, 5, 4]):  # q varies, wraps the ring
        x = rng.standard_normal((t, b)).astype(np.float32)
        corr_state, y = run_corr(corr_state, jnp.asarray(x))
        state, y_ref = run_ref(state, jnp.asarray(x))
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(y_ref), atol=1e-5,
            err_msg=f"call {call} (T={t})",
        )
        np.testing.assert_allclose(
            np.asarray(corr_state.overlap), np.asarray(state.overlap),
            atol=1e-5)


def test_stream_khat_exact_and_coherent():
    """The precomputed stream-MAC kernel meta-DFT (uniform.stream_khat /
    two_stage.stream_khats) must give BIT-identical streams (same matmul
    program, hoisted), and the wrapper caches must be invalidated by
    update()/update_extension() — a stale khat would silently serve the
    old IR."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu import FFTConvolver, TwoStageFFTConvolver
    from fft_convolution_tpu.models import two_stage, uniform

    rng = np.random.default_rng(50)
    b = 64
    ir = rng.standard_normal(2000).astype(np.float32) * 0.1
    t = 32
    x = rng.standard_normal((t, b)).astype(np.float32)

    # core-level exactness, incl. a shrunk-active engine (masked kernel)
    cfg, state = uniform.init(ir, b, len(ir))
    short = rng.standard_normal(900).astype(np.float32) * 0.1
    padded = np.zeros(cfg.seg_count * b, np.float32)
    padded[:900] = short
    state = uniform.update(cfg, state, jnp.asarray(padded),
                           jnp.asarray(900, jnp.int32))
    kh = jax.jit(functools.partial(uniform.stream_khat, cfg),
                 static_argnums=(1,))(state, t)
    run = jax.jit(functools.partial(uniform.process_stream, cfg))
    s1, y1 = run(state, jnp.asarray(x))
    s2, y2 = run(state, jnp.asarray(x), kern_hat=kh)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    np.testing.assert_array_equal(np.asarray(s1.segments),
                                  np.asarray(s2.segments))

    # two-stage aligned core with khats
    ir_l = rng.standard_normal(60000).astype(np.float32) * 0.02
    tcfg, tstate = two_stage.init(ir_l, b, len(ir_l))
    tt = 2 * tcfg.period
    xs = rng.standard_normal((tt, b)).astype(np.float32)
    khs = jax.jit(functools.partial(two_stage.stream_khats, tcfg),
                  static_argnums=(1,))(tstate, tt)
    runa = jax.jit(functools.partial(two_stage.process_stream_aligned, tcfg))
    _, ya = runa(tstate, jnp.asarray(xs))
    _, yb = runa(tstate, jnp.asarray(xs), khats=khs)
    # f32-roundoff only: the fused front end computes the inline khat on
    # the STACKED stage kernels (one batched meta-DFT) while stream_khats
    # computes per-stage then stacks — same math, different matmul batch
    np.testing.assert_allclose(np.asarray(ya), np.asarray(yb), atol=2e-6)

    # wrapper cache coherence across update()
    c = FFTConvolver(ir, b, len(ir))
    c.process(x.reshape(-1))
    assert c._khat_cache
    c.update(short)
    assert not c._khat_cache
    y_upd = c.process(x.reshape(-1))
    c_ref = FFTConvolver(ir, b, len(ir))
    c_ref.process(x.reshape(-1))
    c_ref.update(short)
    # same stream via the chunked path (khat-free) on a twin
    np.testing.assert_allclose(
        y_upd,
        np.concatenate([c_ref.process(x.reshape(-1)[i: i + b])
                        for i in range(0, t * b, b)]),
        atol=1e-5,
    )

    e = TwoStageFFTConvolver(ir_l, b, len(ir_l))
    e.process(xs.reshape(-1))
    assert e._khat_cache
    e.update_extension(rng.standard_normal(50000).astype(np.float32) * 0.02)
    assert not e._khat_cache


def test_uniform_big_block_khat_routes_conv_core():
    """A supplied kern_hat flips huge-block streams (block > 2048, the
    two-stage big tail regime) from the sequential ring scan to the
    batched time-DFT conv core — outputs and state must match the scan."""
    rng = np.random.default_rng(63)
    block = 4096  # > the 2048 static heuristic: scan unless khat supplied
    ir = rng.standard_normal(150000).astype(np.float32) * 0.02
    cfg, state = uniform.init(ir, block, len(ir))
    t = 12
    x = jnp.asarray(rng.standard_normal((t, block)).astype(np.float32))
    kh = jax.jit(functools.partial(uniform.stream_khat, cfg),
                 static_argnums=(1,))(state, t)
    run = jax.jit(functools.partial(uniform.process_stream, cfg))
    s_scan, y_scan = run(state, x)
    s_conv, y_conv = run(state, x, kern_hat=kh)
    scale = float(np.abs(np.asarray(y_scan)).max())
    np.testing.assert_allclose(np.asarray(y_conv), np.asarray(y_scan),
                               atol=1e-5 * max(scale, 1.0))
    for a, b, name in zip(s_conv, s_scan, uniform.UniformState._fields):
        b = np.asarray(b)
        tol = 1e-5 * max(float(np.abs(b).max()) if b.size else 1.0, 1.0)
        np.testing.assert_allclose(
            np.asarray(a), b, atol=tol,
            err_msg=f"state field {name}",
        )


def test_two_stage_tail_khat_conv_core_matches():
    """Aligned streams served with the big-tail khat (long-enough calls ->
    conv-core tail, two_stage.tail_uses_conv_core) must match the
    khat-free aligned path (ring-scan tail) across chained calls — the
    second call's output exposes the first call's tail contribution (two
    periods delayed) AND the tail ring state the conv core left behind."""
    rng = np.random.default_rng(64)
    ir = rng.standard_normal(150000).astype(np.float32) * 0.02
    cfg, state = two_stage.init(ir, 64, len(ir))
    assert cfg.tail is not None and cfg.tail.block_size > 2048
    q = next(q for q in range(1, 65)
             if two_stage.tail_uses_conv_core(cfg, q * cfg.period))
    t = q * cfg.period
    khs = jax.jit(functools.partial(two_stage.stream_khats, cfg),
                  static_argnums=(1,))(state, t)
    assert "tail" in khs, "tail khat missing at the conv-core threshold"
    run = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg))
    x1 = jnp.asarray(rng.standard_normal((t, 64)).astype(np.float32))
    x2 = jnp.asarray(rng.standard_normal((t, 64)).astype(np.float32))
    sa, ya1 = run(state, x1, khats=khs)
    sa, ya2 = run(sa, x2, khats=khs)
    sb, yb1 = run(state, x1)
    sb, yb2 = run(sb, x2)
    scale = float(np.abs(np.asarray(yb2)).max())
    np.testing.assert_allclose(np.asarray(ya1), np.asarray(yb1),
                               atol=1e-5 * max(scale, 1.0))
    np.testing.assert_allclose(np.asarray(ya2), np.asarray(yb2),
                               atol=1e-5 * max(scale, 1.0))
    for a, b in zip(jax.tree.leaves(sa), jax.tree.leaves(sb)):
        b = np.asarray(b)
        tol = 1e-5 * max(float(np.abs(b).max()) if b.size else 1.0, 1.0)
        np.testing.assert_allclose(np.asarray(a), b, atol=tol)


def test_two_stage_wrapper_long_call_conv_tail():
    """A single process() call long enough to flip the big tail onto the
    conv core (q*N >= 5*m) must match the uniform engine end to end —
    the wrapper-level pin of the tail routing.  Since r05 the wrapper's
    aligned calls serve the big tail through the CHRONO sliding-window
    conv core for EVERY eligible length (khat cache keyed (T, chrono)),
    so the conv-core khat is present at this q either way."""
    from fft_convolution_tpu import FFTConvolver, TwoStageFFTConvolver

    rng = np.random.default_rng(65)
    ir = rng.standard_normal(12000).astype(np.float32) * 0.05
    b = TwoStageFFTConvolver(ir, 64, len(ir))
    q = next(qq for qq in range(1, 129)
             if two_stage.tail_uses_conv_core(b.cfg, qq * b.cfg.period))
    n = q * b.cfg.tail_block
    x = rng.standard_normal(n).astype(np.float32) * 0.3
    a = FFTConvolver(ir, 32, len(ir))
    y_a = a.process(x)
    y_b = b.process(x)  # one aligned call of q periods -> conv-core tail
    t = q * b.cfg.period
    assert b._tail_chrono is not None  # chrono engaged on the aligned call
    assert (t, True) in b._khat_cache
    assert "tail" in b._khat_cache[(t, True)]
    np.testing.assert_allclose(y_b, y_a, atol=1e-5 * max(np.abs(y_a).max(), 1))


def test_choose_stream_core_decision_tree():
    """The chooser mirrors the live dispatch and refuses the unguarded
    corr cores unless their state-convention preconditions are declared;
    the corr cores themselves assert their call-length bound."""
    import pytest

    choose = uniform.choose_stream_core
    cfg_small = uniform.make_config(64, 3000)      # block 64, conv regime
    cfg_big = uniform.make_config(8192, 500000)    # two-stage tail regime

    # guarded dispatcher unless the caller owns the preconditions
    assert choose(cfg_small, 32) == "process_stream"
    # vmapped lockstep farm: conv core at small blocks, sliced scan at big
    assert choose(cfg_small, 32, batched=True,
                  full_clean_ring=True) == "stream_conv_unguarded"
    assert choose(cfg_big, 4, batched=True,
                  full_clean_ring=True) == "stream_scan_sliced_unguarded"
    # a kern_hat flips huge blocks onto the conv core (the r04 tail route)
    assert choose(cfg_big, 62, full_clean_ring=True,
                  kern_hat=True) == "stream_conv_unguarded"
    # shrunk-ring vmapped engines: gather scan tolerates active < N
    assert choose(cfg_small, 4, batched=True) == "stream_scan_unguarded"
    # corr cores need their own state layout + the static T bound
    assert choose(cfg_big, 8, full_clean_ring=True,
                  ring_convention="phased"
                  ) == "stream_corr_phased_unguarded"
    assert choose(cfg_big, 8, full_clean_ring=True,
                  ring_convention="rebased"
                  ) == "stream_corr_rebased_unguarded"
    with pytest.raises(ValueError, match="corr cores"):
        choose(cfg_big, 8, ring_convention="phased")  # no clean-ring claim
    with pytest.raises(ValueError, match="corr cores"):
        choose(cfg_big, uniform.CORR_EXTRA_ROWS + 1, full_clean_ring=True,
               ring_convention="phased")

    # the corr cores enforce the same bound at trace time
    rng = np.random.default_rng(70)
    ir = rng.standard_normal(64 * 5).astype(np.float32)
    cfg, state = uniform.init(ir, 64, len(ir))
    x = jnp.asarray(rng.standard_normal(
        (uniform.CORR_EXTRA_ROWS + 1, 64)).astype(np.float32))
    with pytest.raises(AssertionError, match="correlation core"):
        uniform.stream_corr_phased_unguarded(cfg, state, x)
    with pytest.raises(AssertionError, match="correlation core"):
        uniform.stream_corr_rebased_unguarded(cfg, state, x)


def test_irdft_pair_matches_interleaved():
    """irdft_pair (planes taken separately — what the fused-voice farm
    tail hands it) must equal irdft_block on the interleaved [..., 2, B]
    layout, for both the direct and 4-step size regimes and for output
    rows beyond the lane-0 specials."""
    from fft_convolution_tpu.ops.fft import _DIRECT_MAX, irdft_block, irdft_pair

    rng = np.random.default_rng(31)
    for fft_size in (256, 2 * _DIRECT_MAX, 8 * _DIRECT_MAX):
        b = fft_size // 2
        p = jnp.asarray(rng.standard_normal((3, 5, 2, b)).astype(np.float32))
        a = np.asarray(jax.jit(
            functools.partial(irdft_block, fft_size=fft_size))(p))
        bpair = np.asarray(jax.jit(
            functools.partial(irdft_pair, fft_size=fft_size)
        )(p[..., 0, :], p[..., 1, :]))
        np.testing.assert_allclose(bpair, a, atol=1e-6 * max(np.abs(a).max(), 1))


def test_fused_separate_branch_matches_multi_and_scan(monkeypatch):
    """The fused front end's two side-pass formulations (MULTI shared
    transform vs SEPARATE small convs — two_stage.fused_uses_multi routes
    on T) must agree with each other and with the sequential per-block
    reference, including the carried exit state."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu.models import two_stage

    rng = np.random.default_rng(51)
    b = 64
    ir_l = rng.standard_normal(60000).astype(np.float32) * 0.02
    cfg, state = two_stage.init(ir_l, b, len(ir_l))
    tt = 3 * cfg.period
    xs = jnp.asarray(rng.standard_normal((tt, b)).astype(np.float32) * 0.3)
    x2 = jnp.asarray(rng.standard_normal((tt, b)).astype(np.float32) * 0.3)

    assert two_stage.fused_uses_multi(cfg, tt)

    def run(branch_max):
        monkeypatch.setattr(two_stage, "FUSED_MULTI_MAX_ROWS", branch_max)
        khs = jax.jit(functools.partial(two_stage.stream_khats, cfg),
                      static_argnums=(1,))(state, tt)
        runa = jax.jit(
            functools.partial(two_stage.process_stream_aligned, cfg))
        st, y1 = runa(state, xs, khats=khs)
        st, y2 = runa(st, x2, khats=khs)
        return np.asarray(y1), np.asarray(y2)

    multi = run(1 << 30)
    sep = run(0)          # force the SEPARATE side-pass branch
    for a, c in zip(multi, sep):
        np.testing.assert_allclose(c, a, atol=2e-6)

    # sequential per-block reference
    st, yr1 = jax.jit(functools.partial(two_stage.process_stream, cfg))(
        state, xs)
    _, yr2 = jax.jit(functools.partial(two_stage.process_stream, cfg))(
        st, x2)
    scale = max(float(jnp.abs(yr1).max()), 1.0)
    np.testing.assert_allclose(sep[0], np.asarray(yr1), atol=1e-5 * scale)
    np.testing.assert_allclose(sep[1], np.asarray(yr2), atol=1e-5 * scale)


def test_aligned_assume_clean_small_bit_exact():
    """The statically-clean specialization (``assume_clean_small=True`` —
    the cond + fallback subtree elided at trace time) is BIT-exact against
    the runtime-guarded program on a clean state, in both the ring-khat and
    CHRONO forms.  The wrapper routes on its ``_small_full`` host shadow,
    so this is the equivalence that shadow asserts."""
    rng = np.random.default_rng(31)
    ir = (rng.standard_normal(12000) * 0.01).astype(np.float32)
    cfg, state = two_stage.init(ir, 64, len(ir))
    t = 2 * cfg.period
    x = jnp.asarray(rng.standard_normal((t, 64)).astype(np.float32))

    def exact(tree_a, tree_b):
        for a, b in zip(jax.tree.leaves(tree_a), jax.tree.leaves(tree_b)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    kh = jax.jit(functools.partial(two_stage.stream_khats, cfg),
                 static_argnums=(1, 2))(state, t, None)
    ref = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg))(
        state, x, khats=kh)
    spec = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg,
                                     assume_clean_small=True))(
        state, x, khats=kh)
    exact(spec, ref)

    # CHRONO form (the production short-call program)
    n_t = cfg.tail.seg_count
    q = t // cfg.period
    m = uniform.next_power_of_two(n_t - 1 + q)
    h_cap = uniform.next_power_of_two(m + 4 * q)
    kh2 = jax.jit(functools.partial(two_stage.stream_khats, cfg),
                  static_argnums=(1, 2))(state, t, True)
    st_c, chrono = jax.jit(functools.partial(
        two_stage.tail_to_chrono, cfg, h_cap=h_cap))(state)
    ref_c = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg))(
        st_c, x, khats=kh2, tail_chrono=chrono)
    spec_c = jax.jit(functools.partial(
        two_stage.process_stream_aligned, cfg, assume_clean_small=True))(
        st_c, x, khats=kh2, tail_chrono=chrono)
    exact(spec_c, ref_c)


def test_wrapper_small_full_shadow_routing():
    """``_small_full`` host-shadow lifecycle: True from init (init pads the
    IR to every stage's capacity), False after a SHRINKING update (the
    guarded program takes over), True again after a full-length update —
    and the wrapper stays sample-correct across all three regimes."""
    from fft_convolution_tpu import TwoStageFFTConvolver

    rng = np.random.default_rng(32)
    ir = (rng.standard_normal(12000) * 0.01).astype(np.float32)
    c = TwoStageFFTConvolver(ir, 64, len(ir))
    assert c._small_full
    p = c.cfg.period

    x = rng.standard_normal(2 * p * 64).astype(np.float32)
    y0 = c.process(x)

    short = ir[: c.cfg.tail_block // 2]     # shrinks the small stages
    c.update_extension(short)
    assert not c._small_full
    # (a pristine same-IR engine's history differs from c's kept history
    # by contract — compare against the sequential scan path of c itself)
    warm = rng.standard_normal(2 * p * 64).astype(np.float32)
    c.process(warm)
    snap = c.snapshot()
    y_aligned = c.process(x)
    c.restore(snap)
    # force the sequential per-block path for the same input
    y_seq = c._process_chunked(x)
    scale = max(float(np.abs(y_aligned).max()), 1.0)
    np.testing.assert_allclose(y_seq, y_aligned, atol=2e-5 * scale)

    c.update_extension(ir)                  # full-length: shadow returns
    assert c._small_full
    assert np.isfinite(y0).all()
