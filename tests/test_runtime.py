"""Native host-runtime tests: ring buffer, block assembler, WAV codec,
streaming front-end — native C++ and Python fallback must agree."""

import ctypes
import os

import numpy as np
import pytest

from fft_convolution_tpu import FFTConvolver
from fft_convolution_tpu import runtime
from fft_convolution_tpu.runtime.chunker import BlockAssembler, RingBuffer
from fft_convolution_tpu.runtime.stream import StreamingConvolver


def test_native_builds():
    assert runtime.available(), "native host runtime failed to build"


@pytest.mark.parametrize("force_python", [False, True])
def test_ring_buffer(force_python):
    rb = RingBuffer(100, force_python=force_python)
    assert rb.capacity == 128
    rng = np.random.default_rng(0)
    data = rng.standard_normal(300).astype(np.float32)
    out = []
    pos = 0
    while pos < 300 or rb.readable():
        if pos < 300:
            pos += rb.write(data[pos : pos + 37])
        got = rb.read(23)
        out.append(got)
    out = np.concatenate(out)
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("force_python", [False, True])
def test_block_assembler(force_python):
    ba = BlockAssembler(64, force_python=force_python)
    rng = np.random.default_rng(1)
    data = rng.standard_normal(1000).astype(np.float32)
    blocks = []
    pos = 0
    for size in [1, 63, 64, 100, 7, 500, 265]:
        blocks.append(ba.push(data[pos : pos + size]))
        pos += size
    assert pos == 1000
    got = np.concatenate([b.reshape(-1) for b in blocks])
    n_full = (1000 // 64) * 64
    np.testing.assert_array_equal(got, data[:n_full])
    assert ba.fill == 1000 - n_full
    # partial peek returns the remainder zero-padded
    peek = ba.peek()
    np.testing.assert_array_equal(peek[: ba.fill], data[n_full:])
    np.testing.assert_array_equal(peek[ba.fill :], 0)


def test_native_wav_roundtrip(tmp_path):
    lib = runtime.load()
    assert lib is not None
    rng = np.random.default_rng(2)
    samples = (rng.standard_normal(4096) * 0.3).clip(-1, 1).astype(np.float32)
    path = str(tmp_path / "t.wav").encode()
    r = lib.wav_write_mono16(
        path, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), 48000,
    )
    assert r == 0
    sr = ctypes.c_uint32(0)
    n = lib.wav_read_mono16(path, None, 0, ctypes.byref(sr))
    assert n == 4096 and sr.value == 48000
    out = np.empty(4096, np.float32)
    n = lib.wav_read_mono16(
        path, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 4096,
        ctypes.byref(sr),
    )
    assert n == 4096
    np.testing.assert_allclose(out, samples, atol=1.0 / 32767)


def test_native_wav_matches_python_writer(tmp_path):
    """Native and stdlib writers must produce byte-identical files."""
    from fft_convolution_tpu.utils.audio import save_wav

    lib = runtime.load()
    rng = np.random.default_rng(3)
    samples = (rng.standard_normal(1000) * 0.5).clip(-1, 1).astype(np.float32)
    p1 = str(tmp_path / "native.wav")
    p2 = str(tmp_path / "python.wav")
    lib.wav_write_mono16(
        p1.encode(), samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), 44100,
    )
    save_wav(p2, samples, 44100)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_streaming_convolver_matches_engine():
    rng = np.random.default_rng(4)
    ir = rng.standard_normal(500).astype(np.float32) * 0.1
    x = rng.standard_normal(2048).astype(np.float32)

    direct = FFTConvolver(ir, 128, len(ir))
    y_ref = direct.process(x)

    s = StreamingConvolver(FFTConvolver(ir, 128, len(ir)))
    pieces, pos = [], 0
    for size in [441, 441, 441, 300, 128, 256, 41]:
        pieces.append(s.push(x[pos : pos + size]))
        pos += size
    assert pos == 2048
    np.testing.assert_allclose(np.concatenate(pieces), y_ref, atol=1e-5)


def test_realtime_dispatcher_pipeline():
    """Producer -> lock-free ring -> dispatcher thread -> ring -> consumer
    must reproduce direct processing exactly (whole blocks only)."""
    from fft_convolution_tpu.runtime.dispatcher import RealTimeDispatcher

    rng = np.random.default_rng(70)
    ir = rng.standard_normal(500).astype(np.float32) * 0.1
    x = rng.standard_normal(128 * 16).astype(np.float32)

    direct = FFTConvolver(ir, 128, len(ir))
    y_ref = direct.process(x)

    engine = FFTConvolver(ir, 128, len(ir))
    with RealTimeDispatcher(engine, capacity_blocks=32) as d:
        pos = 0
        while pos < len(x):
            pos += d.push(x[pos : pos + 441])
        d.drain()
        got = d.pull(len(x))
    assert d.blocks_processed == 16
    assert d.underruns == 0
    np.testing.assert_allclose(got, y_ref, atol=1e-5)


def test_dispatcher_drain_waits_for_slow_engine():
    """drain() must wait for a block that is mid-engine.process even when the
    input ring already looks empty.  A 30 ms/block engine (a slow remote
    device's dispatch cost) made the old
    counter-settled-across-one-poll heuristic return early and pull() replace
    the final block with zeros."""
    import time

    from fft_convolution_tpu.runtime.dispatcher import RealTimeDispatcher

    rng = np.random.default_rng(71)
    ir = rng.standard_normal(500).astype(np.float32) * 0.1
    x = rng.standard_normal(128 * 4).astype(np.float32)

    direct = FFTConvolver(ir, 128, len(ir))
    y_ref = direct.process(x)

    class SlowEngine:
        def __init__(self, inner):
            self.inner = inner
            self.cfg = inner.cfg

        def process(self, block):
            time.sleep(0.03)
            return self.inner.process(block)

    engine = SlowEngine(FFTConvolver(ir, 128, len(ir)))
    with RealTimeDispatcher(engine, capacity_blocks=32) as d:
        pos = 0
        while pos < len(x):
            pos += d.push(x[pos : pos + 441])
        d.drain()
        assert d.blocks_processed == 4
        got = d.pull(len(x))
    assert d.underruns == 0
    np.testing.assert_allclose(got, y_ref, atol=1e-5)
