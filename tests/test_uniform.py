"""Uniform FFTConvolver tests — ports of the reference suite (SURVEY.md §4)
plus golden checks against direct convolution that the reference lacks.

Reference tests reproduced here:
* ``test_fft_convolver_passthrough``      (``src/fft_convolver.rs:309-321``)
* ``fft_convolver_update_is_reset``       (``src/tests.rs:18-59``)
* ``block_size_equal``                    (``src/tests.rs:119-146``)
* ``reset_fftconvolver``                  (``src/tests.rs:177-216``)
"""

import numpy as np
import pytest

from fft_convolution_tpu import FFTConvolver
from fft_convolution_tpu.ops.fft import generate_sinusoid

SAMPLE_RATE = 44100.0


def test_passthrough():
    """δ-impulse IR ⇒ identity, tol 1e-6 (``src/fft_convolver.rs:309-321``)."""
    response = np.zeros(1024, np.float32)
    response[0] = 1.0
    convolver = FFTConvolver(response, 1024, len(response))
    output = convolver.process(np.ones(1024, np.float32))
    np.testing.assert_allclose(output, 1.0, atol=1e-6)


def test_golden_direct_convolution():
    """Output must equal direct time-domain convolution (not in the reference
    suite — a golden check the equivalence tests can't provide)."""
    rng = np.random.default_rng(0)
    ir = rng.standard_normal(300).astype(np.float32) * 0.1
    x = rng.standard_normal(1024).astype(np.float32)
    convolver = FFTConvolver(ir, 64, len(ir))
    y = convolver.process(x)
    expected = np.convolve(x.astype(np.float64), ir.astype(np.float64))[:1024]
    np.testing.assert_allclose(y, expected, atol=1e-5)


def test_update_is_reset():
    """``update(new_ir)`` mid-stream matches a fresh convolver of the new IR
    for single-segment IRs (``src/tests.rs:18-59``)."""
    block_size = 512
    response_a = generate_sinusoid(block_size, 1000.0, SAMPLE_RATE, 1.0)
    response_b = generate_sinusoid(block_size, 2000.0, SAMPLE_RATE, 0.7)
    convolver_a = FFTConvolver(response_a, block_size, len(response_a))
    convolver_b = FFTConvolver(response_b, block_size, len(response_b))
    convolver_update = FFTConvolver(response_a, block_size, len(response_a))

    num_input_blocks = 16
    input = generate_sinusoid(num_input_blocks * block_size, 1300.0, SAMPLE_RATE, 1.0)
    update_index = 8

    for i in range(num_input_blocks):
        if i == update_index:
            convolver_update.update(response_b)
        chunk = input[i * block_size : (i + 1) * block_size]
        out_update = convolver_update.process(chunk)
        if i < update_index:
            out_a = convolver_a.process(chunk)
            np.testing.assert_allclose(out_a, out_update, atol=1e-6)
        else:
            out_b = convolver_b.process(chunk)
            np.testing.assert_allclose(out_b, out_update, atol=1e-6)


def test_block_size_equal():
    """Block-size invariance over 1000 blocks (``src/tests.rs:119-146``)."""
    block_size = 128
    num_input_blocks = 1000
    response = generate_sinusoid(block_size, 1000.0, SAMPLE_RATE, 0.1)
    convolver_a = FFTConvolver(response, block_size // 2, len(response))
    convolver_b = FFTConvolver(response, block_size, len(response))
    input = generate_sinusoid(num_input_blocks * block_size, 1300.0, SAMPLE_RATE, 0.1)
    for i in range(num_input_blocks):
        chunk = input[i * block_size : (i + 1) * block_size]
        out_a = convolver_a.process(chunk)
        out_b = convolver_b.process(chunk)
        np.testing.assert_allclose(out_a, out_b, atol=1e-5)


def test_reset_repeatable():
    """``reset()`` makes reprocessing bit-repeatable within 1e-5
    (``src/tests.rs:177-216``)."""
    block_size = 64
    n_blocks = 1000
    response = generate_sinusoid(12000, 1000.0, SAMPLE_RATE, 0.1)
    convolver = FFTConvolver(response, block_size, len(response))
    input = generate_sinusoid(n_blocks * block_size, 1300.0, SAMPLE_RATE, 0.1)

    output_a = convolver.process(input)
    convolver.reset()
    output_b = convolver.process(input)
    np.testing.assert_allclose(output_a, output_b, atol=1e-5)


def test_subblock_chunking_matches_block_aligned():
    """Arbitrary process() call sizes must bit-match block-aligned streaming
    (the reference while-loop contract, ``src/fft_convolver.rs:222-294``)."""
    rng = np.random.default_rng(1)
    ir = rng.standard_normal(500).astype(np.float32) * 0.1
    x = rng.standard_normal(2048).astype(np.float32)
    ref = FFTConvolver(ir, 128, len(ir))
    y_ref = ref.process(x)

    odd = FFTConvolver(ir, 128, len(ir))
    pieces = []
    sizes = [1, 7, 128, 13, 200, 64, 500, 300, 835]
    assert sum(sizes) == 2048
    pos = 0
    for s in sizes:
        pieces.append(odd.process(x[pos : pos + s]))
        pos += s
    y_odd = np.concatenate(pieces)
    np.testing.assert_allclose(y_odd, y_ref, atol=1e-5)


def test_init_panics_on_long_ir():
    """Init contract violation raises (reference panic, ``src/fft_convolver.rs:106-110``)."""
    with pytest.raises(ValueError):
        FFTConvolver(np.ones(100, np.float32), 64, 50)


def test_update_panics_on_long_ir():
    """(``src/fft_convolver.rs:177-179``)"""
    convolver = FFTConvolver(np.ones(100, np.float32), 64, 100)
    with pytest.raises(ValueError):
        convolver.update(np.ones(101, np.float32))


def test_update_shrinks_active_segments():
    """A shorter IR after update must produce the shorter convolution
    (active_seg_count shrink, ``src/fft_convolver.rs:190,210-212``)."""
    rng = np.random.default_rng(2)
    ir_long = rng.standard_normal(512).astype(np.float32) * 0.1
    ir_short = rng.standard_normal(100).astype(np.float32) * 0.1
    x = rng.standard_normal(1024).astype(np.float32)

    c = FFTConvolver(ir_long, 64, 512)
    c.update(ir_short)
    y = c.process(x)
    expected = np.convolve(x.astype(np.float64), ir_short.astype(np.float64))[:1024]
    np.testing.assert_allclose(y, expected, atol=1e-5)


def test_update_midstream_keeps_history_analytic_golden():
    """Mid-stream multi-segment update against an ANALYTIC golden — a
    case the equivalence suites miss (``test_update_is_reset`` is
    single-segment, where kept history reduces to the cleared overlap).

    Reference contract (``src/fft_convolver.rs:174-213``): the input
    spectra ring is KEPT — past input keeps convolving with the NEW IR —
    while the one-block OLA ``overlap`` is cleared, so the first
    post-update block is missing the spill of every
    (input block ``t-B-iB``, segment ``i``) pair into block ``t``.

    The update IR is zero-padded to the full init length: init makes all
    ``seg_count`` partitions live (``:117-118``), so a shorter update
    changes ``active_seg_count`` and the kept ring re-indexes modulo the
    new count (``:244-249``) — the reference's own scrambled transient,
    reproduced here but not analytically golden-able (covered by the
    stream-vs-sequential equivalence in test_stream_paths/fuzz).
    """
    rng = np.random.default_rng(17)
    B, maxr = 128, 768          # 6 partitions, all live after init
    ir = rng.standard_normal(512).astype(np.float32) * 0.05
    ir2 = rng.standard_normal(520).astype(np.float32) * 0.05
    n_pre, n_post = 8 * B, 8 * B
    x = rng.standard_normal(n_pre + n_post).astype(np.float32)

    eng = FFTConvolver(ir, B, maxr)
    _ = eng.process(x[:n_pre])
    eng.update(np.pad(ir2, (0, maxr - ir2.size)))   # active stays 6
    y = np.asarray(eng.process(x[n_pre:]))

    g = np.convolve(x.astype(np.float64), ir2.astype(np.float64))
    g = g[n_pre : n_pre + n_post]
    spill = np.zeros(B - 1)
    for i in range(maxr // B):
        seg = np.zeros(B)
        seg[: max(0, min(B, ir2.size - i * B))] = ir2[i * B : (i + 1) * B]
        lo = n_pre - B - i * B
        spill += np.convolve(x[lo : lo + B].astype(np.float64), seg)[B:]
    g[: B - 1] -= spill
    np.testing.assert_allclose(y, g, atol=1e-5)


def test_block_size_rounded_to_power_of_two():
    """block_size 100 rounds to 128 (``src/fft_convolver.rs:115``); results
    must still match a pow2-constructed engine."""
    rng = np.random.default_rng(3)
    ir = rng.standard_normal(256).astype(np.float32) * 0.1
    x = rng.standard_normal(512).astype(np.float32)
    y_a = FFTConvolver(ir, 100, 256).process(x)
    y_b = FFTConvolver(ir, 128, 256).process(x)
    np.testing.assert_allclose(y_a, y_b, atol=1e-6)


def test_snapshot_restore():
    """Engine state is a pytree: snapshot/restore (the reference's `Clone`,
    ``src/lib.rs:5``) round-trips exactly."""
    rng = np.random.default_rng(4)
    ir = rng.standard_normal(256).astype(np.float32) * 0.1
    x = rng.standard_normal(640).astype(np.float32)
    c = FFTConvolver(ir, 64, 256)
    c.process(x[:320])
    snap = c.snapshot()
    y1 = c.process(x[320:])
    c.restore(snap)
    y2 = c.process(x[320:])
    np.testing.assert_array_equal(y1, y2)


def test_fft_plan_wrapper_surface():
    """L0 public surface parity: Fft init/forward/inverse roundtrip
    (``src/fft_convolver.rs:29-50``) and the helpers."""
    from fft_convolution_tpu.ops import Fft, complex_size, copy_and_pad

    assert complex_size(256) == 129
    fft = Fft(256)
    rng = np.random.default_rng(80)
    x = rng.standard_normal(256).astype(np.float32)
    spec = fft.forward(x)
    assert spec.shape == (2, 128)
    back = np.asarray(fft.inverse(spec))
    np.testing.assert_allclose(back, x, atol=1e-5)

    padded = np.asarray(copy_and_pad(x[:100], 256))
    np.testing.assert_array_equal(padded[:100], x[:100])
    np.testing.assert_array_equal(padded[100:], 0)

    # arbitrary EVEN lengths <= 1024 plan via the direct basis (realfft plans
    # any length; odd and large-non-pow2 are the documented PARITY.md gaps)
    fft = Fft(100)
    x100 = rng.standard_normal(100).astype(np.float32)
    ref = np.fft.rfft(x100.astype(np.float64))
    spec = np.asarray(fft.forward(x100))
    np.testing.assert_allclose(spec[0, 1:], ref[1:50].real, atol=1e-4)
    np.testing.assert_allclose(spec[1, 1:], ref[1:50].imag, atol=1e-4)
    np.testing.assert_allclose(spec[0, 0], ref[0].real, atol=1e-4)
    np.testing.assert_allclose(spec[1, 0], ref[50].real, atol=1e-4)
    np.testing.assert_allclose(np.asarray(fft.inverse(spec)), x100, atol=1e-5)

    with pytest.raises(ValueError):
        Fft(101)  # odd
    with pytest.raises(ValueError):
        Fft(2050)  # > direct max and not a power of two


def test_roofline_accounting():
    """MFU/HBM accounting sanity: positive, 4-step beats direct-basis FLOPs
    at large n, and the flagship config lands in a plausible band."""
    from fft_convolution_tpu.models import two_stage
    from fft_convolution_tpu.utils import roofline

    big = roofline._rdft_cost(1, 16384)
    assert big.flops < 2.0 * 16384 * 16384  # 4-step strictly beats direct

    cfg, _ = two_stage.init(np.zeros(480000, np.float32), 128, 480000)
    c = roofline.two_stage_stream_cost(cfg, 2048)
    assert 1e9 < c.flops < 1e11
    assert 1e7 < c.bytes < 1e10
    u = roofline.utilization(c, 1e-3, roofline.peaks_for("NVIDIA H100 80GB HBM3"))
    assert set(u) == {"mfu", "hbm_util", "gflops", "gbps"}
    assert u["mfu"] > 0 and u["hbm_util"] > 0


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "cpu",
])
def test_roofline_peak_table(kind):
    """Peaks are keyed by the device_kind JAX reports: the H100 SXM data
    sheet's figures, and an error (never a default) for any other device."""
    from fft_convolution_tpu.utils import roofline

    if kind == "NVIDIA H100 80GB HBM3":
        p = roofline.peaks_for(kind)
        assert (p.hbm_bps, p.f32_flops, p.bf16_flops) == (3.35e12, 67e12, 989e12)
    else:
        with pytest.raises(KeyError, match="no published peaks"):
            roofline.peaks_for(kind)


@pytest.mark.parametrize("engine, block, ir_len", [
    ("uniform", 16, 77), ("uniform", 64, 300), ("two_stage", 16, 700),
])
def test_per_block_ring_wraparound_matches_float64(engine, block, ir_len):
    """One block per ``process`` call for several trips around the
    partition ring (and, two-stage, around the tail period) against a
    float64 direct convolution."""
    from fft_convolution_tpu import FFTConvolver, TwoStageFFTConvolver

    rng = np.random.default_rng(block + ir_len)
    ir = rng.standard_normal(ir_len).astype(np.float32) * 0.1
    cls = FFTConvolver if engine == "uniform" else TwoStageFFTConvolver
    conv = cls(ir, block, ir_len)
    n_blocks = 4 * (-(-ir_len // block)) + 3
    if engine == "two_stage":
        assert conv.cfg.tail is not None
        n_blocks = max(n_blocks, 3 * conv.cfg.tail_block // block + 3)
    x = rng.standard_normal(n_blocks * block).astype(np.float32)
    got = np.concatenate([conv.process(x[i * block:(i + 1) * block])
                          for i in range(n_blocks)])
    ref = np.convolve(x.astype(np.float64), ir.astype(np.float64))[: len(x)]
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
