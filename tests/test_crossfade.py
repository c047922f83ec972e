"""Crossfade convolver + crossfader tests.

Reference tests reproduced:
* ``test_crossfader``                     (``src/crossfade_convolver.rs:281-316``)
* ``test_crossfade_convolver_passthrough``(``src/crossfade_convolver.rs:107-124``)
* ``test_crossfade_convolver``            (``src/tests.rs:61-117``)
"""

import numpy as np
import pytest

from fft_convolution_tpu import CrossfadeConvolver, FFTConvolver
from fft_convolution_tpu.models import crossfade
from fft_convolution_tpu.ops.fft import generate_sinusoid

SAMPLE_RATE = 44100.0


def test_crossfader_state_machine():
    """Hold phase, ramp, exact endpoint snap — both directions
    (``src/crossfade_convolver.rs:281-316``), sample-by-sample."""
    hold = 4
    fading = 4
    cfg = crossfade.CrossfaderConfig(fading_samples=fading, hold_samples=hold)
    st = crossfade.new_state(cfg)
    sample_a, sample_b = 1.0, 10.0

    def start(t):
        return sample_b if t == crossfade.TARGET_A else sample_a

    def end(t):
        return sample_a if t == crossfade.TARGET_A else sample_b

    for target in (crossfade.TARGET_B, crossfade.TARGET_A):
        st = crossfade.fade_into(cfg, st, target)
        for i in range(hold + fading):
            st, y = crossfade.mix_block(
                cfg, st,
                np.full(1, sample_a, np.float32),
                np.full(1, sample_b, np.float32),
            )
            v = float(y[0])
            if i < hold:
                assert bool(st.approaching)
                assert v == start(target)
            elif i < hold + fading - 1:
                assert bool(st.approaching)
                assert v != start(target) and v != end(target)
            else:
                assert v == end(target)
                assert not bool(st.approaching)


def test_crossfader_blockwise_equals_samplewise():
    """The vectorized closed form must match per-sample stepping across
    arbitrary block boundaries (incl. mid-hold and mid-ramp splits)."""
    cfg = crossfade.CrossfaderConfig(fading_samples=512, hold_samples=300)
    rng = np.random.default_rng(9)
    a = rng.standard_normal(2048).astype(np.float32)
    b = rng.standard_normal(2048).astype(np.float32)

    st1 = crossfade.fade_into(cfg, crossfade.new_state(cfg), crossfade.TARGET_B)
    ys = []
    for i in range(2048):
        st1, y = crossfade.mix_block(cfg, st1, a[i : i + 1], b[i : i + 1])
        ys.append(float(y[0]))

    st2 = crossfade.fade_into(cfg, crossfade.new_state(cfg), crossfade.TARGET_B)
    pieces, pos = [], 0
    for size in (7, 250, 100, 470, 64, 512, 645):
        st2, y = crossfade.mix_block(cfg, st2, a[pos : pos + size], b[pos : pos + size])
        pieces.append(np.asarray(y))
        pos += size
    np.testing.assert_allclose(
        np.concatenate(pieces), np.asarray(ys, np.float32), atol=1e-6
    )


def test_passthrough():
    """(``src/crossfade_convolver.rs:107-124``)"""
    response = np.zeros(1024, np.float32)
    response[0] = 1.0
    inner = FFTConvolver(response, 1024, len(response))
    convolver = CrossfadeConvolver(inner, 1024, 1024, 1024)
    output = convolver.process(np.ones(1024, np.float32))
    np.testing.assert_allclose(output, 1.0, atol=1e-6)


def test_crossfade_convolver():
    """Old IR before update; 50/50 mix at the crossover sample
    (block_size/2 - 1 after hold); new IR after the fade completes
    (``src/tests.rs:61-117``)."""
    block_size = 512
    response_a = generate_sinusoid(block_size, 1000.0, SAMPLE_RATE, 1.0)
    response_b = generate_sinusoid(block_size, 2000.0, SAMPLE_RATE, 0.7)
    convolver_a = FFTConvolver(response_a, block_size, len(response_a))
    convolver_b = FFTConvolver(response_b, block_size, len(response_b))
    cc = CrossfadeConvolver(convolver_a.clone(), block_size, block_size, block_size)

    num_input_blocks = 16
    input = generate_sinusoid(num_input_blocks * block_size, 1300.0, SAMPLE_RATE, 1.0)
    update_index = 8

    for i in range(num_input_blocks):
        if i == update_index:
            cc.update(response_b)
        chunk = input[i * block_size : (i + 1) * block_size]
        out_cc = cc.process(chunk)
        out_a = convolver_a.process(chunk)
        if i >= update_index:
            out_b = convolver_b.process(chunk)
        if i <= update_index:
            np.testing.assert_allclose(out_a, out_cc, atol=1e-6)
        elif i == update_index + 1:
            crossover = block_size // 2 - 1
            assert abs(
                out_cc[crossover] - (out_a[crossover] * 0.5 + out_b[crossover] * 0.5)
            ) < 1e-6
        else:
            np.testing.assert_allclose(out_b, out_cc, atol=1e-6)


def test_pending_response_slot():
    """An update during a fade is deferred to fade completion; later updates
    overwrite the single pending slot (``src/crossfade_convolver.rs:51-64``)."""
    block_size = 128
    ra = np.zeros(block_size, np.float32); ra[0] = 1.0
    rb = np.zeros(block_size, np.float32); rb[0] = 0.5
    rc = np.zeros(block_size, np.float32); rc[0] = 0.25
    inner = FFTConvolver(ra, block_size, block_size)
    cc = CrossfadeConvolver(inner, block_size, block_size, block_size)
    x = np.ones(block_size, np.float32)

    cc.update(rb)                 # starts fade A->B
    assert cc.is_crossfading()
    cc.update(rc)                 # mid-fade: pending slot
    assert cc.response_pending
    cc.process(x)                 # hold+ramp spans 2 blocks (256 samples)
    cc.process(x)
    assert not cc.is_crossfading()
    y = cc.process(x)             # pending swap applies at block top
    # fade toward rc is now in progress or complete; run it out
    for _ in range(4):
        y = cc.process(x)
    np.testing.assert_allclose(y, 0.25, atol=1e-6)


def test_reset_unimplemented():
    """Surface parity (``src/crossfade_convolver.rs:80-82``)."""
    inner = FFTConvolver(np.ones(64, np.float32), 64, 64)
    cc = CrossfadeConvolver(inner, 64, 64, 64)
    with pytest.raises(NotImplementedError):
        cc.reset()


def test_alternative_mixers():
    """Linear / sqrt / cosine mixers (dead code upstream, ``:130-158``)
    produce the documented gains."""
    for mixer, v, expected in [
        ("linear", 0.25, 1.0 * 0.75 + 10.0 * 0.25),
        ("sqrt", 0.25, np.sqrt(0.75) + 10.0 * np.sqrt(0.25)),
        ("cosine", 0.5, np.cos(np.pi / 4) + 10.0 * np.sin(np.pi / 4)),
        ("raised_cosine", 0.5, 0.5 + 10.0 * 0.5),
    ]:
        cfg = crossfade.CrossfaderConfig(4, 0, mixer=mixer)
        st = crossfade.new_state(cfg)._replace(
            approaching=np.asarray(True),
            counter=np.asarray(0, np.int32),
            mix_value=np.asarray(v - 0.25, np.float32),
        )
        _, y = crossfade.mix_block(
            cfg, st, np.full(1, 1.0, np.float32), np.full(1, 10.0, np.float32)
        )
        np.testing.assert_allclose(float(y[0]), expected, atol=1e-6)


def test_ragged_sizes_match_fused_path():
    """Ragged process() sizes (unfused fallback) must agree with the fused
    block-aligned path."""
    rng = np.random.default_rng(50)
    ir = rng.standard_normal(400).astype(np.float32) * 0.1
    x = rng.standard_normal(128 * 12).astype(np.float32)

    def make():
        return CrossfadeConvolver(FFTConvolver(ir, 128, 400), 400, 128, 300)

    cc_fused = make()
    y_fused = [cc_fused.process(x[i * 256:(i + 1) * 256]) for i in range(6)]

    cc_ragged = make()
    sizes = [100, 156, 256, 200, 56, 256] + [128] * 2 + [256]
    assert sum(sizes) == 128 * 12
    pieces, pos = [], 0
    for s in sizes:
        pieces.append(cc_ragged.process(x[pos:pos + s]))
        pos += s
    np.testing.assert_allclose(
        np.concatenate(pieces), np.concatenate(y_fused), atol=1e-5
    )


def test_two_stage_inner_engine():
    """CrossfadeConvolver is generic over the engine (reference
    CrossfadeConvolver<T>); a two-stage inner works for processing, and
    update propagates the inner NotImplementedError exactly as the generic
    would hit the upstream todo!() panic."""
    from fft_convolution_tpu import TwoStageFFTConvolver

    response = np.zeros(1024, np.float32)
    response[0] = 1.0
    inner = TwoStageFFTConvolver(response, 128, 1024)
    cc = CrossfadeConvolver(inner, 1024, 128, 256)
    y = cc.process(np.ones(128, np.float32))
    np.testing.assert_allclose(y, 1.0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        cc.update(response)


def test_clone_independent():
    """clone() is a value copy (reference derives Clone): diverging one copy
    must not affect the other."""
    rng = np.random.default_rng(51)
    ir = rng.standard_normal(256).astype(np.float32) * 0.1
    cc = CrossfadeConvolver(FFTConvolver(ir, 64, 256), 256, 64, 128)
    x = rng.standard_normal(64 * 4).astype(np.float32)
    cc.process(x[:128])
    twin = cc.clone()
    y1 = cc.process(x[128:])
    twin.update(rng.standard_normal(100).astype(np.float32) * 0.1)
    y_twin_later = twin.process(x[128:])
    # original's continuation is unaffected by the twin's update
    cc2 = CrossfadeConvolver(FFTConvolver(ir, 64, 256), 256, 64, 128)
    cc2.process(x[:128])
    y_ref = cc2.process(x[128:])
    np.testing.assert_allclose(y1, y_ref, atol=1e-6)
    assert np.abs(y_twin_later - y1).max() > 0  # the twin did diverge


def test_zero_fade_length_clamps_to_instant_switch():
    """fading_samples == 0 (e.g. a zero-length response) must not divide by
    zero; it clamps to a 1-sample (instant) fade."""
    cfg = crossfade.CrossfaderConfig(fading_samples=0, hold_samples=0)
    assert cfg.fading_samples == 1
    st = crossfade.new_state(cfg)
    assert np.isfinite(float(st.step))


@pytest.mark.parametrize("call", ["block", "half_blocks"])
def test_hold_then_ramp_sample_exact(call):
    """During the hold the output is engine A's sample for sample; the
    block after starts the ramp; after the fade the output is engine B's
    (silent here, so any leak of A shows) — the Crossfader state machine
    (``src/crossfade_convolver.rs:242-278``) composed with both engines,
    through the fused block-aligned program and the unfused ragged path."""
    rng = np.random.default_rng(53)
    b = 128
    ir1 = rng.standard_normal(2 * b).astype(np.float32) * 0.1
    ir2 = np.zeros(2 * b, np.float32)
    x = rng.standard_normal(6 * b).astype(np.float32)

    def process(cc, blk):
        if call == "block":
            return cc.process(blk)
        return np.concatenate([cc.process(blk[: b // 2 + 3]),
                               cc.process(blk[b // 2 + 3:])])

    def make():
        return CrossfadeConvolver(FFTConvolver(ir1, b, len(ir1)), len(ir1), b,
                                  2 * b)

    plain = make()
    y_plain = [process(plain, x[t * b:(t + 1) * b]) for t in range(6)]
    cc = make()
    process(cc, x[:b])
    cc.update(ir2)
    # hold_samples == block_size: the next block is pure A
    np.testing.assert_array_equal(process(cc, x[b:2 * b]), y_plain[1])
    assert np.abs(process(cc, x[2 * b:3 * b]) - y_plain[2]).max() > 1e-4
    for t in range(3, 6):
        y = process(cc, x[t * b:(t + 1) * b])
    assert not cc.is_crossfading()
    np.testing.assert_allclose(y, np.zeros(b), atol=1e-6)


def test_snapshot_restore_reset_extension_and_capacity():
    """snapshot/restore repeats a block exactly, reset_extension returns to
    a power-on state, a mid-fade update longer than the stored-response
    capacity raises, and ``cfg`` is the engines' shared config."""
    rng = np.random.default_rng(52)
    b = 128
    ir = rng.standard_normal(3 * b).astype(np.float32) * 0.1
    inner = FFTConvolver(ir, b, len(ir))
    cc = CrossfadeConvolver(inner, len(ir), b, b)
    assert cc.cfg == inner.cfg
    x = rng.standard_normal(6 * b).astype(np.float32)
    cc.process(x[:b])
    cc.update(rng.standard_normal(2 * b).astype(np.float32) * 0.1)
    assert cc.is_crossfading()
    with pytest.raises(ValueError):
        cc.update(np.ones(len(ir) + 1, np.float32))
    snap = cc.snapshot()
    y1 = cc.process(x[b:2 * b])
    cc.restore(snap)
    np.testing.assert_array_equal(cc.process(x[b:2 * b]), y1)

    cc.reset_extension()
    assert not cc.is_crossfading() and not cc.response_pending
    ya = [cc.process(x[t * b:(t + 1) * b]) for t in range(3)]
    cc.reset_extension()
    yb = [cc.process(x[t * b:(t + 1) * b]) for t in range(3)]
    np.testing.assert_array_equal(np.concatenate(ya), np.concatenate(yb))
