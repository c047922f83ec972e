"""Reverb farm demo: many voices, distinct IRs, one program.

Runs a small two-stage farm (the production configuration for long IRs —
see parallel/farm2.py), verifies one voice against a standalone engine, and
reports the aggregate realtime factor.

Usage: python examples/reverb_farm.py [--voices 8] [--ir-seconds 4] [--cpu]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voices", type=int, default=8)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu import TwoStageFFTConvolver
    from fft_convolution_tpu.parallel import farm2

    sr = 48000
    block = 128
    v = args.voices
    ir_len = int(args.ir_seconds * sr)

    rng = np.random.default_rng(0)
    decay = np.exp(-np.arange(ir_len) / (sr * args.ir_seconds / 6))
    irs = (rng.standard_normal((v, ir_len)) * decay * 0.02).astype(np.float32)

    cfg, state = farm2.farm2_init(irs, block, ir_len)
    t = 2 * cfg.period
    x = (rng.standard_normal((t, v, block)) * 0.3).astype(np.float32)

    run = jax.jit(functools.partial(farm2.farm2_stream, cfg))
    xd = jnp.asarray(x)  # stage input on device outside the timed region
    state2, ys = run(state, xd)
    jax.block_until_ready(ys)

    t0 = time.perf_counter()
    state2, ys = run(state, xd)
    jax.block_until_ready(ys)
    wall = time.perf_counter() - t0
    audio = t * block / sr
    print(f"{v} voices x {args.ir_seconds:.1f} s IRs: {audio:.2f} s audio in "
          f"{wall*1e3:.1f} ms wall (one dispatch)")

    ref = TwoStageFFTConvolver(irs[0], block, ir_len)
    y_ref = ref.process(x[:, 0, :].reshape(-1))
    n_check = min(4096, len(y_ref))
    first = np.asarray(ys[:, 0, :].reshape(-1)[:n_check])
    err = float(np.abs(first - y_ref[:n_check]).max())
    print(f"voice 0 vs standalone engine: max abs diff {err:.2e}")
    assert err < 1e-5


if __name__ == "__main__":
    main()
