"""Recorded-golden parity (SURVEY.md §4: "parity vs recorded outputs of
examples/compare_partitioned.rs").

The checked-in golden (``tests/golden/compare_partitioned.npz``, regenerate
with ``tests/golden/make_golden.py``) is the float64 direct convolution of
the reference example's exact workload (``examples/compare_partitioned.rs:
9-26``): 128k-tap 1 kHz sinusoid IR, 1.3 kHz input, block 64, 1000 blocks.
Both engines must stay within the reference's 1000-block stream tolerance
of 1e-5 (``src/tests.rs:126``).
"""

import pathlib

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden" / "compare_partitioned.npz"
SR = 44100
BLOCK = 64
N_BLOCKS = 1000


def _workload():
    from fft_convolution_tpu.ops.fft import generate_sinusoid

    ir = generate_sinusoid(128_000, 1000.0, SR, 0.1)
    x = generate_sinusoid(BLOCK * N_BLOCKS, 1300.0, SR, 0.1)
    y = np.load(GOLDEN)["y"]
    assert y.shape == (BLOCK * N_BLOCKS,)
    return ir, x, y


def test_golden_is_reproducible():
    """The committed artifact matches its regeneration script.  Within
    rtol=1e-6, not bit for bit: a float64 sum rounded to float32 can move
    by one float32 ulp (~6e-8 relative) across numpy builds, whose
    ``np.convolve`` may sum in another order."""
    ir, x, y = _workload()
    fresh = np.convolve(
        x.astype(np.float64), ir.astype(np.float64)
    )[: len(x)].astype(np.float32)
    np.testing.assert_allclose(fresh, y, rtol=1e-6, atol=0)


def test_uniform_matches_recorded_golden():
    from fft_convolution_tpu import FFTConvolver

    ir, x, y = _workload()
    conv = FFTConvolver(ir, BLOCK, len(ir))
    got = conv.process(x)
    err = np.max(np.abs(got - y))
    assert err <= 1e-5, f"uniform vs recorded golden: {err}"


def test_two_stage_matches_recorded_golden():
    from fft_convolution_tpu import TwoStageFFTConvolver

    ir, x, y = _workload()
    conv = TwoStageFFTConvolver(ir, BLOCK, len(ir))
    got = conv.process(x)
    err = np.max(np.abs(got - y))
    assert err <= 1e-5, f"two-stage vs recorded golden: {err}"


@pytest.mark.parametrize("which", ["uniform", "two_stage"])
def test_per_block_serving_matches_recorded_golden(which):
    """The per-block serving call (one ``process`` per block, as a
    real-time host drives the engines) holds the recorded-golden contract."""
    from fft_convolution_tpu import FFTConvolver, TwoStageFFTConvolver

    ir, x, y = _workload()
    if which == "uniform":
        conv = FFTConvolver(ir, BLOCK, len(ir))
    else:
        conv = TwoStageFFTConvolver(ir, BLOCK, len(ir))
    got = np.concatenate([
        conv.process(x[i * BLOCK:(i + 1) * BLOCK]) for i in range(N_BLOCKS)
    ])
    err = np.max(np.abs(got - y))
    assert err <= 1e-5, f"{which} vs recorded golden: {err}"
