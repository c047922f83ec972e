"""Giant-IR multi-chip serving demo: one voice, an IR spanning the mesh.

Builds an n-device mesh (virtual CPU devices by default, so it runs
anywhere), serves a long IR through the sharded two-stage engine
(parallel/two_stage_sp.py: head/tail0 replicated per chip for latency, the
main tail's frequency-delay line sharded over 'sp' with one ~1 KB psum per
tail period), cross-checks against the single-device engine, and reports
the per-chip memory split.

The reference is single-core (`src/fft_convolver.rs`, SURVEY.md §2:
parallelism ABSENT); this is the scale-out story for the SURVEY §5
memory-budget scenario (a 60 s IR keeps ~23 MB of partition spectra).

Usage: python examples/giant_ir_multichip.py [--devices 8] [--ir-seconds 2]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--ir-seconds", type=float, default=2.0)
    args = ap.parse_args()

    # self-provision a virtual CPU mesh (same recipe as __graft_entry__)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from fft_convolution_tpu import ShardedTwoStageConvolver, TwoStageFFTConvolver

    sr = 48000
    block = 128
    ir_len = int(args.ir_seconds * sr)
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(ir_len) * 0.01).astype(np.float32)

    sh = ShardedTwoStageConvolver(ir, block, ir_len)
    n_sp = sh.mesh.shape["sp"]
    tb = sh.cfg.tail_block
    tail_rows = sh.cfg.tail.seg_count
    tail_bytes = tail_rows * 2 * tb * 4          # input-spectra ring
    tail_bytes += 2 * tail_rows * 2 * tb * 4     # doubled IR table (replicated)
    head_bytes = (sh.cfg.head.seg_count + sh.cfg.tail0.seg_count) * 2 * block * 4 * 2
    print(f"mesh: {n_sp} chips over 'sp'; tail_block={tb}, period={sh.cfg.period}")
    print(f"tail ring: {tail_rows} segments, {tail_rows * 2 * tb * 4 / 1e6:.1f} MB "
          f"-> {tail_rows * 2 * tb * 4 / n_sp / 1e6:.2f} MB/chip; "
          f"head+tail0 (replicated): {head_bytes / 1e6:.2f} MB/chip")
    print(f"ICI traffic: one {2 * tb * 4 / 1024:.0f} KB psum per {tb} samples "
          f"({tb / sr * 1e3:.1f} ms of audio)")

    x = (rng.standard_normal(4 * tb) * 0.5).astype(np.float32)
    y = sh.process(x)

    ref = TwoStageFFTConvolver(ir, block, ir_len)
    y_ref = ref.process(x)
    err = float(np.max(np.abs(y - y_ref)))
    print(f"max_abs_diff vs single-device engine: {err:.2e}")
    assert err < 1e-5
    print("OK")


if __name__ == "__main__":
    main()
