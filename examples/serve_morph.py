"""Deployment-shaped serving demo: morph-while-serving through the
real-time dispatcher.

The full production stack in one script:

    audio callback (odd-size host buffers, never blocks)
      └─ RealTimeDispatcher (native lock-free rings + block assembler)
           └─ CrossfadeConvolver (both engines and the sample-accurate
              raised-cosine crossfader in ONE device program per block)

Mid-stream, `update(ir_b)` triggers an RT-safe morph: the inactive
engine's tables are rebuilt by a fixed-shape jitted program and the
crossfader holds, ramps, and endpoint-snaps exactly like the reference
(`src/crossfade_convolver.rs:242-278`).  A second update landing
mid-fade parks in the single pending-response slot (`:51-64`).

The reference's analogue is the caller-owned audio callback around
`CrossfadeConvolver` (`examples/compare_partitioned.rs:30-48`); here the
callback side is the native SPSC rings and the engine is the fused
crossfade program.

Usage: python -m examples.serve_morph [--blocks N] [--wav out.wav] [--cpu]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from fft_convolution_tpu import CrossfadeConvolver, FFTConvolver
from fft_convolution_tpu.runtime.dispatcher import RealTimeDispatcher

SR = 48_000


def main() -> None:
    n_blocks = 96
    wav_path = None
    argv = sys.argv
    for i, a in enumerate(argv):
        if a == "--blocks":
            n_blocks = int(argv[i + 1])
        elif a == "--wav":
            wav_path = argv[i + 1]

    block = 128
    ir_len = 2048
    rng = np.random.default_rng(5)
    decay = np.exp(-np.arange(ir_len) / 300).astype(np.float32)
    ir_a = (rng.standard_normal(ir_len).astype(np.float32) * decay) * 0.2
    ir_b = -(rng.standard_normal(ir_len).astype(np.float32) * decay) * 0.2

    engine = CrossfadeConvolver(
        FFTConvolver(ir_a, block, ir_len), ir_len, block, 4 * block
    )
    # room for the whole run's output: the demo pulls only what is ready
    # while it pushes, and drains the rest at the end
    disp = RealTimeDispatcher(engine, capacity_blocks=n_blocks)
    disp.start()

    # the "audio callback": odd-size pushes (441 = 10 ms at 44.1 kHz), a
    # morph trigger a third of the way in, pulls trailing the pushes
    total = n_blocks * block
    x = (rng.standard_normal(total).astype(np.float32) * 0.3)
    out = []
    pushed = 0
    morph_at = total // 3
    morphed = False
    t0 = time.perf_counter()
    while pushed < total:
        n = min(441, total - pushed)
        accepted = disp.push(x[pushed:pushed + n])
        pushed += accepted
        if not morphed and pushed >= morph_at:
            t_m = time.perf_counter()
            engine.update(ir_b)  # RT-safe: fixed-shape jit, no realloc
            print(f"morph trigger: {1e3 * (time.perf_counter() - t_m):.2f} ms "
                  f"(is_crossfading={engine.is_crossfading()})")
            morphed = True
        got = disp.pull(min(disp.available(), n))
        if len(got):
            out.append(got)
    disp.drain(timeout=60.0)
    out.append(disp.pull(disp.available()))
    disp.stop()
    wall = time.perf_counter() - t0

    y = np.concatenate(out) if out else np.zeros(0, np.float32)
    audio_s = total / SR
    print(f"served {disp.blocks_processed} blocks ({audio_s:.2f} s audio) "
          f"in {wall:.2f} s wall — {audio_s / wall:.1f}x realtime "
          f"end-to-end, underruns={disp.underruns}")

    # parity: before the morph the output must be ir_a's convolution
    # (needs the morph to land after the IR tail — tiny --blocks runs
    # morph too early for a clean pre-morph window)
    check = min(morph_at - ir_len, 4 * block)
    if check > 0:
        golden = np.convolve(x.astype(np.float64), ir_a.astype(np.float64))
        err = np.max(np.abs(y[:check] - golden[:check]))
        print(f"pre-morph parity vs np.convolve: {err:.3e}")
        assert err < 1e-4, err
    else:
        print("pre-morph parity window empty at this --blocks; skipped")

    if wav_path:
        from fft_convolution_tpu.utils.audio import save_wav

        save_wav(wav_path, y, SR)
        print(f"wrote {wav_path}")


if __name__ == "__main__":
    main()
