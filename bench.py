"""Headline benchmark: real-time factor of the flagship convolver on one GPU.

Config (BASELINE.md): mono two-stage partitioned convolution, block = 128,
10 s 48 kHz impulse response, one card.  Streams T blocks through the
period-aligned engine core as the ``TwoStageFFTConvolver`` wrapper serves
it (device-resident state, cached kernel meta-spectra, chronological
big-tail history) and reports xRT = audio seconds / seconds per call, the
median over timed calls after warm-up, each ended by ``block_until_ready``.
``vs_baseline`` is the ratio against the 1000x north-star target (the
reference publishes no numbers — BASELINE.md).  Per-block latency is the
p50/p99 of single-block ``process_block`` calls.

Correctness gate: the timed program's first output samples against a
float64 direct convolution, at the engines' 1e-5 relative contract.

Prints ONE JSON line on stdout, tagged with the device and the card's
power limit; diagnostics go to stderr.  Exits non-zero when JAX finds no
GPU or when the line carries an error.
"""

import functools
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fail(reason: str) -> int:
    print(json.dumps({
        "metric": "xRT_flagship_block128_10s_ir",
        "value": 0.0, "unit": "x_realtime", "vs_baseline": 0.0,
        "error": reason,
    }))
    return 1


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    devices = jax.devices()
    if devices[0].platform != "gpu":
        return fail(f"needs a GPU, JAX found {devices[0].platform}")

    from fft_convolution_tpu.models import two_stage, uniform
    from fft_convolution_tpu.utils import roofline
    from fft_convolution_tpu.utils.compile_cache import enable_compile_cache
    from fft_convolution_tpu.utils.profiling import gpu_cards

    enable_compile_cache()
    peaks = roofline.peaks_for(devices[0].device_kind)

    sr = 48000
    block = 128
    ir_seconds = 10
    # multiple of the tail period (8192/128 = 64), chosen to FILL the
    # combined head kernel's meta-DFT: ext rows = T + 2n - 1 = 4095 of the
    # m = 4096 meta
    t_blocks = 3968
    warm, reps = 3, 20

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(ir_seconds * sr) * 0.01).astype(np.float32)
    t0 = time.perf_counter()
    cfg, state = two_stage.init(ir, block, len(ir))
    log(f"flagship: two-stage block={block} tail={cfg.tail_block} "
        f"ir={ir_seconds}s@{sr}Hz on {devices[0].device_kind} "
        f"(init {time.perf_counter()-t0:.1f}s)")
    x = jnp.asarray(rng.standard_normal((t_blocks, block)).astype(np.float32))

    # the head/tail0 kernel meta-DFTs are input-independent — the wrapper
    # caches them per IR epoch, so the benchmarked stream serves with them;
    # want_tail=True: the big tail streams through the CHRONO sliding window
    khats = jax.jit(
        functools.partial(two_stage.stream_khats, cfg), static_argnums=(1, 2),
    )(state, t_blocks, True)
    # chrono history sized for every timed call (the wrapper compacts on
    # the host between calls; this loop does not)
    q_call = t_blocks // cfg.period
    m_tail = uniform.next_power_of_two(cfg.tail.seg_count - 1 + q_call)
    h_cap = uniform.next_power_of_two(m_tail + (warm + reps + 2) * q_call)
    st, chrono = jax.jit(functools.partial(
        two_stage.tail_to_chrono, cfg, h_cap=h_cap))(state)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def stream(s, chr_, xs, kh):
        # assume_clean_small mirrors the wrapper's default (host
        # _small_full shadow; a fresh init is clean)
        return two_stage.process_stream_aligned(
            cfg, s, xs, khats=kh, tail_chrono=chr_, assume_clean_small=True)

    t0 = time.perf_counter()
    st, chrono, y = stream(st, chrono, x, khats)
    y.block_until_ready()
    log(f"stream compile+first call: {time.perf_counter() - t0:.1f} s")
    # only the first n_check IR taps reach the first n_check outputs
    n_check = 4096
    got = np.asarray(y).reshape(-1)[:n_check].astype(np.float64)
    exp = np.convolve(np.asarray(x).reshape(-1)[:n_check].astype(np.float64),
                      ir[:n_check].astype(np.float64))[:n_check]
    err = float(np.abs(got - exp).max() / np.abs(exp).max())
    log(f"parity vs direct convolution (first {n_check} samples): {err:.3e}")
    if not err <= 1e-5:
        return fail(f"parity failure {err:.3e}")

    times = []
    for i in range(warm - 1 + reps):
        t0 = time.perf_counter()
        st, chrono, y = stream(st, chrono, x, khats)
        y.block_until_ready()
        if i >= warm - 1:
            times.append(time.perf_counter() - t0)
    wall = float(np.median(times))
    audio = t_blocks * block / sr
    xrt = audio / wall
    log(f"stream: median {wall*1e3:.3f} ms (min {min(times)*1e3:.3f}) per "
        f"{audio:.2f} s audio over {reps} calls")
    util = roofline.utilization(
        roofline.two_stage_stream_cost(cfg, t_blocks), wall, peaks)
    log(f"roofline (algorithmic bytes and FLOPs): {util['gflops']:.0f} "
        f"GFLOP/s ({util['mfu']*100:.2f}% of f32 peak), {util['gbps']:.0f} "
        f"GB/s ({util['hbm_util']*100:.1f}% of HBM peak)")

    # per-block latency of the single-block serving step
    step = jax.jit(functools.partial(two_stage.process_block, cfg),
                   donate_argnums=(0,))
    lat = []
    s = state
    for i in range(520):
        t0 = time.perf_counter()
        s, yb = step(s, x[i])
        yb.block_until_ready()
        if i >= 20:
            lat.append(time.perf_counter() - t0)
    p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
    log(f"two-stage per-block latency: p50 {p50:.4f} ms, p99 {p99:.4f} ms")

    print(json.dumps({
        "metric": "xRT_flagship_block128_10s_ir",
        "value": round(xrt, 1),
        "unit": "x_realtime",
        "vs_baseline": round(xrt / 1000.0, 3),
        "p50_block_latency_ms": round(p50, 4),
        "p99_block_latency_ms": round(p99, 4),
        "parity_rel_err": err,
        "mfu": round(util["mfu"], 5),
        "hbm_util": round(util["hbm_util"], 4),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": gpu_cards(),
    }))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # noqa: BLE001 - the caller reads one JSON line
        import traceback

        traceback.print_exc(file=sys.stderr)
        rc = fail(f"{type(e).__name__}: {e}")
    sys.exit(rc)
