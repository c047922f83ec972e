"""CHRONO sliding-window tail history (VERDICT r4 #1).

The chrono convention replaces the big tail's decrementing ring with a
chronological history buffer for aligned stream calls, removing the
per-call ext-build / flip / rebuild-roll glue.  These
tests pin it to the ring paths: same outputs, exact state reconstruction
at the conversion boundary, compaction transparency, and wrapper routing
(sequential interleaving, update/reset/snapshot/clone).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fft_convolution_tpu import TwoStageFFTConvolver
from fft_convolution_tpu.models import two_stage, uniform


def _chrono_run(cfg, state, chunks, h_cap, kern_hat_for=None):
    """Drive the chrono core over a list of [T, B] chunks with host-routed
    compaction, mirroring the wrapper's shadow-pos logic; returns the
    reconstructed ring state and the concatenated output."""
    state, hist, pos = uniform.ring_to_chrono(cfg, state, h_cap)
    pos_host = cfg.seg_count - 1
    ys = []
    for blocks in chunks:
        t = blocks.shape[0]
        if not uniform.chrono_fits(cfg, h_cap, pos_host, t):
            hist, pos = uniform.chrono_compact(cfg, hist, pos)
            pos_host = cfg.seg_count - 1
        kh = kern_hat_for(t) if kern_hat_for is not None else None
        state, hist, pos, y = uniform.stream_conv_chrono_unguarded(
            cfg, state, hist, pos, jnp.asarray(blocks), kern_hat=kh
        )
        pos_host += t
        ys.append(np.asarray(y))
    return uniform.chrono_to_ring(cfg, state, hist, pos), np.concatenate(ys)


def test_chrono_core_matches_ring_stream():
    """Multi-call chrono streaming == the guarded ring stream: outputs to
    1e-5 and the reconstructed ring state interoperates exactly (continue
    both on the sequential scan and compare)."""
    rng = np.random.default_rng(50)
    ir = rng.standard_normal(3000).astype(np.float32) * 0.1
    cfg, s0 = uniform.init(ir, 64, len(ir))
    lens = [8, 3, 17, 1, 12]
    chunks = [rng.standard_normal((t, 64)).astype(np.float32) for t in lens]

    stream = jax.jit(functools.partial(uniform.process_stream, cfg))
    s_ref = s0
    y_ref = []
    for c in chunks:
        s_ref, y = stream(s_ref, jnp.asarray(c))
        y_ref.append(np.asarray(y))
    y_ref = np.concatenate(y_ref)

    h_cap = uniform.chrono_capacity(cfg, max(lens))
    s_chr, y_chr = _chrono_run(cfg, s0, chunks, h_cap)
    np.testing.assert_allclose(y_chr, y_ref, atol=1e-5)

    # the reconstructed ring must continue IDENTICALLY on the scan path
    tail = rng.standard_normal((cfg.seg_count + 3, 64)).astype(np.float32)
    scan = jax.jit(functools.partial(uniform.process_stream_scan, cfg))
    _, y_cont_ref = scan(s_ref, jnp.asarray(tail))
    _, y_cont_chr = scan(s_chr, jnp.asarray(tail))
    np.testing.assert_allclose(
        np.asarray(y_cont_chr), np.asarray(y_cont_ref), atol=1e-5
    )


def test_chrono_compaction_is_transparent():
    """A buffer barely larger than one call forces compaction nearly every
    call; outputs must not change."""
    rng = np.random.default_rng(51)
    ir = rng.standard_normal(1500).astype(np.float32) * 0.1
    cfg, s0 = uniform.init(ir, 64, len(ir))
    n = cfg.seg_count
    t = 6
    chunks = [rng.standard_normal((t, 64)).astype(np.float32)
              for _ in range(10)]

    stream = jax.jit(functools.partial(uniform.process_stream, cfg))
    s_ref = s0
    y_ref = []
    for c in chunks:
        s_ref, y = stream(s_ref, jnp.asarray(c))
        y_ref.append(np.asarray(y))

    h_tight = uniform.next_power_of_two(max(n - 1 + t, 2 * (n - 1)))
    assert h_tight < uniform.chrono_capacity(cfg, t)  # genuinely tight
    _, y_chr = _chrono_run(cfg, s0, chunks, h_tight)
    np.testing.assert_allclose(y_chr, np.concatenate(y_ref), atol=1e-5)


def test_chrono_core_khat_served():
    """A precomputed stream_khat must serve the chrono core bit-identically
    to its in-call kernel path (same meta-DFT inputs)."""
    rng = np.random.default_rng(52)
    ir = rng.standard_normal(2000).astype(np.float32) * 0.1
    cfg, s0 = uniform.init(ir, 64, len(ir))
    t = 9
    chunks = [rng.standard_normal((t, 64)).astype(np.float32)
              for _ in range(3)]
    h_cap = uniform.chrono_capacity(cfg, t)
    kh = jax.jit(functools.partial(uniform.stream_khat, cfg),
                 static_argnums=(1,))(s0, t)
    _, y_plain = _chrono_run(cfg, s0, chunks, h_cap)
    _, y_khat = _chrono_run(cfg, s0, chunks, h_cap, kern_hat_for=lambda _: kh)
    np.testing.assert_array_equal(y_khat, y_plain)


def test_two_stage_chrono_aligned_matches_scan():
    """The aligned path with a CHRONO big tail == the sequential scan over
    a multi-call sequence, and tail_from_chrono hands back a state the
    scan path continues exactly."""
    rng = np.random.default_rng(53)
    ir = rng.standard_normal(60000).astype(np.float32) * 0.02
    cfg, s0 = two_stage.init(ir, 64, len(ir))
    assert cfg.tail is not None and cfg.tail.seg_count > 1
    p = cfg.period
    qs = [2, 1, 4, 3]
    chunks = [rng.standard_normal((q * p, 64)).astype(np.float32)
              for q in qs]

    scan = jax.jit(functools.partial(two_stage.process_stream, cfg))
    s_ref = s0
    y_ref = []
    for c in chunks:
        s_ref, y = scan(s_ref, jnp.asarray(c))
        y_ref.append(np.asarray(y).ravel())
    y_ref = np.concatenate(y_ref)

    h_cap = uniform.chrono_capacity(cfg.tail, max(qs))
    to_chrono = jax.jit(functools.partial(two_stage.tail_to_chrono, cfg,
                                          h_cap=h_cap))
    from_chrono = jax.jit(functools.partial(two_stage.tail_from_chrono, cfg))
    khats_fn = jax.jit(functools.partial(two_stage.stream_khats, cfg),
                       static_argnums=(1, 2))
    run = jax.jit(functools.partial(two_stage.process_stream_aligned, cfg))

    s, chrono = to_chrono(s0)
    ys = []
    for c in chunks:
        kh = khats_fn(s, c.shape[0], True)
        s, chrono, y = run(s, jnp.asarray(c), khats=kh, tail_chrono=chrono)
        ys.append(np.asarray(y).ravel())
    np.testing.assert_allclose(np.concatenate(ys), y_ref, atol=1e-5)

    s = from_chrono(s, chrono)
    tail = rng.standard_normal((p + 5, 64)).astype(np.float32)
    _, y_cont_ref = scan(s_ref, jnp.asarray(tail))
    _, y_cont_chr = scan(s, jnp.asarray(tail))
    np.testing.assert_allclose(
        np.asarray(y_cont_chr), np.asarray(y_cont_ref), atol=1e-5
    )


def test_wrapper_chrono_routing_and_interleaving():
    """The public wrapper enters chrono on aligned calls, exits for ragged
    / sequential pieces, and the whole interleaved stream matches the
    np.convolve golden."""
    rng = np.random.default_rng(54)
    ir = rng.standard_normal(50000).astype(np.float32) * 0.02
    sig = rng.standard_normal(400000).astype(np.float32) * 0.3
    conv = TwoStageFFTConvolver(ir, 64, len(ir))
    tb = conv.cfg.tail_block

    out = []
    cuts = [2 * tb, 2 * tb + 3 * tb, 2 * tb + 3 * tb + 777]
    lo = 0
    for hi in cuts + [len(sig)]:
        out.append(np.asarray(conv.process(sig[lo:hi])))
        if lo == 0:
            # first call is period-aligned: chrono must actually engage
            assert conv._tail_chrono is not None
        lo = hi
    y = np.concatenate(out)
    g = np.convolve(sig, ir)[: len(sig)]
    err = np.max(np.abs(y - g)) / np.max(np.abs(g))
    assert err < 1e-5, err
    # the 777-sample ragged piece must have forced chrono exit
    assert conv._tail_chrono is None


def test_wrapper_chrono_many_calls_compaction():
    """Enough aligned calls to cross the history buffer's capacity several
    times (host-routed compaction), vs golden."""
    rng = np.random.default_rng(55)
    ir = rng.standard_normal(30000).astype(np.float32) * 0.02
    conv = TwoStageFFTConvolver(ir, 64, len(ir))
    tb = conv.cfg.tail_block
    n_t = conv.cfg.tail.seg_count
    h_cap = conv._chrono_h_cap
    q = 4
    calls = (h_cap - (n_t - 1)) // q + 3   # crosses capacity at least once
    sig = rng.standard_normal(calls * q * tb).astype(np.float32) * 0.3
    out = []
    for i in range(calls):
        out.append(np.asarray(conv.process(sig[i * q * tb:(i + 1) * q * tb])))
    assert conv._tail_pos <= h_cap
    y = np.concatenate(out)
    g = np.convolve(sig, ir)[: len(sig)]
    err = np.max(np.abs(y - g)) / np.max(np.abs(g))
    assert err < 1e-5, err


def test_wrapper_chrono_update_reset_snapshot_clone():
    """Lifecycle ops ring-normalize correctly: update_extension with a
    full-length IR re-enters chrono, a shorter IR falls back to the ring
    paths (reference shrink semantics), reset/snapshot/restore/clone all
    behave across the mode boundary."""
    rng = np.random.default_rng(56)
    cap = 40000
    ir = rng.standard_normal(cap).astype(np.float32) * 0.02
    ir2 = rng.standard_normal(cap).astype(np.float32) * 0.02
    conv = TwoStageFFTConvolver(ir, 64, cap)
    tb = conv.cfg.tail_block
    sig = rng.standard_normal(6 * tb).astype(np.float32) * 0.3

    conv.process(sig[: 2 * tb])
    assert conv._tail_chrono is not None
    snap = conv.snapshot()                      # ring-normalizes
    assert conv._tail_chrono is None

    conv.process(sig[2 * tb: 4 * tb])           # chrono again
    conv.restore(snap)
    assert conv._tail_chrono is None
    y_a = np.asarray(conv.process(sig[2 * tb: 4 * tb]))

    conv.restore(snap)
    other = conv.clone()
    y_b = np.asarray(other.process(sig[2 * tb: 4 * tb]))
    np.testing.assert_allclose(y_a, y_b, atol=1e-6)

    # full-length update: chrono re-enters afterwards
    conv.restore(snap)
    conv.update_extension(ir2)
    assert conv._tail_full
    conv.process(sig[2 * tb: 4 * tb])
    assert conv._tail_chrono is not None

    # short update shrinks the tail's active count: ring mode from then on
    conv.update_extension(ir2[: cap - 2 * conv.cfg.tail_block])
    assert not conv._tail_full
    conv.process(sig[4 * tb: 6 * tb])
    assert conv._tail_chrono is None

    conv.reset()
    y_r = np.asarray(conv.process(sig[: 2 * tb]))
    fresh = TwoStageFFTConvolver(
        ir2[: cap - 2 * conv.cfg.tail_block], 64, cap
    )
    y_f = np.asarray(fresh.process(sig[: 2 * tb]))
    np.testing.assert_allclose(y_r, y_f, atol=1e-5)


def test_wrapper_chrono_vs_forced_ring_outputs():
    """Same stream through the wrapper twice — chrono enabled vs disabled
    (h_cap forced to 0) — must agree to f32 stream tolerance."""
    rng = np.random.default_rng(57)
    ir = rng.standard_normal(45000).astype(np.float32) * 0.02
    a = TwoStageFFTConvolver(ir, 64, len(ir))
    b = TwoStageFFTConvolver(ir, 64, len(ir))
    b._chrono_h_cap = 0                         # force the ring paths
    tb = a.cfg.tail_block
    sig = rng.standard_normal(7 * tb).astype(np.float32) * 0.3
    for lo, hi in [(0, 2 * tb), (2 * tb, 3 * tb), (3 * tb, 7 * tb)]:
        ya = np.asarray(a.process(sig[lo:hi]))
        yb = np.asarray(b.process(sig[lo:hi]))
        np.testing.assert_allclose(ya, yb, atol=2e-5)
    assert a._tail_chrono is not None and b._tail_chrono is None


if __name__ == "__main__":
    import sys
    sys.exit(pytest.main([__file__, "-v"]))
