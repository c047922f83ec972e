"""The five benchmark configurations from BASELINE.json.

Each config returns ``(name, run)`` where ``run()`` measures the workload on
the current GPU and returns a dict of metrics.  Every timed call ends in
``block_until_ready`` after warm-up (:func:`_time_call`).

Run all: ``python -m benchmarks.run_all``.
"""

from __future__ import annotations

import functools
import time

SR = 48000


def _time_call(fn, state, x, aux=None, warm=2, reps=10):
    """Median seconds of one ``fn(state, x[, aux])`` stream call.

    The state is donated and threaded from call to call (multi-GB farm
    states would otherwise exist twice); each call is timed to its
    ``block_until_ready``.
    """
    import jax
    import numpy as np

    @functools.partial(jax.jit, donate_argnums=(0,))
    def call(st, xs, ax):
        return fn(st, xs) if ax is None else fn(st, xs, ax)

    times = []
    st = state
    for i in range(warm + reps):
        t0 = time.perf_counter()
        st, y = call(st, x, aux)
        jax.block_until_ready(y)
        if i >= warm:
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def config1_mono_parity():
    """Mono FFTConvolver, block=128, 1 s 48 kHz IR — CPU-parity semantics of
    examples/compare_partitioned.rs (reference config 1)."""
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu.models import uniform

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    cfg, state = uniform.init(ir, 128, len(ir))
    # fill the stream MAC's meta-DFT exactly: N - 1 + T = npo2 (T = 1024
    # zero-padded a third of every meta pass)
    from fft_convolution_tpu.ops.fft import next_power_of_two

    t = next_power_of_two(cfg.seg_count + 1023) - cfg.seg_count + 1
    x = jnp.asarray(rng.standard_normal((t, 128)).astype(np.float32))
    import jax

    kh = jax.jit(functools.partial(uniform.stream_khat, cfg),
                 static_argnums=(1,))(state, t)
    wall = _time_call(
        lambda st, xs, k: uniform.process_stream(cfg, st, xs, kern_hat=k),
        state, x, aux=kh,
    )
    audio = t * 128 / SR
    return {"xrt": audio / wall, "us_per_block": wall / t * 1e6}


def config2_stereo():
    """Stereo uniform convolution, block=256, 5 s hall IR — a 2-voice farm."""
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu.parallel import farm

    rng = np.random.default_rng(1)
    irs = (rng.standard_normal((2, 5 * SR)) * 0.01).astype(np.float32)
    cfg, state = farm.farm_init(jnp.asarray(irs), 256, 5 * SR)
    # serve with the precomputed kernel meta-DFT (farm_khat) at a
    # meta-filling stream length (N - 1 + T = npo2)
    from fft_convolution_tpu.ops.fft import next_power_of_two

    t = next_power_of_two(cfg.seg_count + 511) - cfg.seg_count + 1
    x = jnp.asarray(rng.standard_normal((t, 2, 256)).astype(np.float32))
    import jax

    kh = jax.jit(functools.partial(farm.farm_khat, cfg),
                 static_argnums=(1,))(state, t)
    wall = _time_call(
        lambda st, xs, k: farm.farm_stream(cfg, st, xs, kern_hat=k),
        state, x, aux=kh,
    )
    audio = t * 256 / SR
    return {"xrt": audio / wall, "us_per_block": wall / t * 1e6}


def config3_two_stage_30s():
    """Two-stage non-uniform partitions, head=128, 30 s cathedral IR.
    (Garcia's formula picks the optimal tail size; the 4096 in BASELINE.json
    is advisory — we keep the reference's closed form.)"""
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu.models import two_stage

    rng = np.random.default_rng(2)
    ir = (rng.standard_normal(30 * SR) * 0.005).astype(np.float32)
    cfg, state = two_stage.init(ir, 128, len(ir))
    # throughput batch comparable to the flagship's (10.6 s audio/dispatch)
    t = 32 * cfg.period
    x = jnp.asarray(rng.standard_normal((t, 128)).astype(np.float32))
    import jax

    from fft_convolution_tpu.models import uniform

    # the wrapper's aligned route: khat-served CHRONO sliding-window big
    # tail.  History sized for every timed call (h_cap >= m + calls*q —
    # the wrapper compacts on the host between calls; this loop does not).
    q = t // cfg.period
    m_t = uniform.next_power_of_two(cfg.tail.seg_count - 1 + q)
    h_cap = uniform.next_power_of_two(m_t + 14 * q)
    khats = jax.jit(
        functools.partial(two_stage.stream_khats, cfg),
        static_argnums=(1, 2))(state, t, True)
    st_c, chrono = jax.jit(functools.partial(
        two_stage.tail_to_chrono, cfg, h_cap=h_cap))(state)

    def run(carry, xs, kh):
        st, chr_ = carry
        # assume_clean_small: the wrapper's production default off its
        # _small_full host shadow (fresh-init states are always clean)
        st, chr_, y = two_stage.process_stream_aligned(
            cfg, st, xs, khats=kh, tail_chrono=chr_,
            assume_clean_small=True)
        return (st, chr_), y

    wall = _time_call(run, (st_c, chrono), x, aux=khats)
    audio = t * 128 / SR
    return {"xrt": audio / wall, "us_per_block": wall / t * 1e6,
            "tail_block": cfg.tail_block}


def config4_crossfade_morph():
    """Crossfade A/B morph: both engines + the sample-accurate mixer every
    block (2x compute by design, src/crossfade_convolver.rs:66-78), measured
    on the fused single-program stream path while a fade is in progress
    (worst case: hold + ramp + mixer all active).  The host-side morph
    trigger (RT-safe update of the inactive engine) is timed separately."""
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu import CrossfadeConvolver, FFTConvolver
    from fft_convolution_tpu.api_crossfade import _jit_fused_stream
    from fft_convolution_tpu.models import crossfade

    rng = np.random.default_rng(3)
    block = 128
    ir_a = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    ir_b = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    inner = FFTConvolver(ir_a, block, SR)
    # fade longer than the whole timed region so every measured sample is
    # mid-ramp (hold + raised-cosine mixer + both engines active)
    cc = CrossfadeConvolver(inner, SR, block, 10 * SR)
    cc.update(ir_b)
    assert cc.is_crossfading()

    # meta-filling stream length (N - 1 + T = npo2) for both engines
    from fft_convolution_tpu.ops.fft import next_power_of_two

    n_segs = cc.convolver_a.cfg.seg_count
    t = next_power_of_two(n_segs + 255) - n_segs + 1
    x = jnp.asarray(rng.standard_normal((t, block)).astype(np.float32))
    fused = _jit_fused_stream(cc.convolver_a.cfg, cc.cf_cfg)
    # both engines' cached kernel meta-DFTs (input-independent per IR
    # epoch) — production process() serves with them
    kha = cc.convolver_a._get_khat(t)
    khb = cc.convolver_b._get_khat(t)

    def run(op, xs, kh):
        sa, sb, cf = op
        sa, sb, cf, y = fused(sa, sb, cf, xs, kha=kh[0], khb=kh[1])
        return (sa, sb, cf), y

    # copy: _time_call donates its state, and the live wrapper states are
    # reused for the morph-trigger timing below (tiny at this config)
    import jax

    state0 = jax.tree.map(
        jnp.copy, (cc.convolver_a.state, cc.convolver_b.state, cc.cf_state)
    )
    wall = _time_call(run, state0, x, aux=(kha, khb))
    audio = t * block / SR

    # morph trigger latency: jitted update of the inactive engine
    t0 = time.perf_counter()
    for _ in range(5):
        cc.convolver_b.update(ir_a)
    update_ms = (time.perf_counter() - t0) / 5 * 1e3
    return {"xrt": audio / wall, "us_per_block": wall / t * 1e6,
            "morph_update_ms": update_ms}


def farm2_bytes_per_voice(block: int, ir_len: int, t_blocks: int,
                          tail_item: int = 4) -> int:
    """Moved to :func:`fft_convolution_tpu.parallel.farm2.farm2_bytes_per_voice`
    (it now backs farm2_init's eager capacity guard); re-exported here for
    the benchmark scripts."""
    from fft_convolution_tpu.parallel.farm2 import farm2_bytes_per_voice as f

    return f(block, ir_len, t_blocks, tail_item)


def config5_reverb_farm(voices: int = 1024, ir_seconds: int = 60,
                        tail_dtype=None):
    """Batched reverb farm: ``voices`` channels with distinct long IRs on
    one card, using the two-stage farm (parallel/farm2.py — the production
    engine for 60 s IRs).  Voice count is capped by the derived per-voice
    memory model (:func:`farm2_bytes_per_voice`) against the device's
    budget (:func:`farm2.device_budget_bytes`).  Reports aggregate
    realtime voices per card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fft_convolution_tpu.models import two_stage
    from fft_convolution_tpu.parallel import farm2

    block = 128
    hbm = farm2.device_budget_bytes()
    ir_len = ir_seconds * SR
    tail_dtype = tail_dtype if tail_dtype is not None else jnp.float32
    tail_item = jnp.dtype(tail_dtype).itemsize
    tb = two_stage.compute_tail_block_size(block, ir_len)
    # periods per call per storage; the voice sizing uses the same call
    # length (head transients scale with it)
    q = farm2.DEFAULT_PERIODS_PER_CALL[tail_item]
    t_blocks = q * (tb // block)
    per_voice = farm2_bytes_per_voice(block, ir_len, t_blocks, tail_item)
    voices = int(min(voices, max(1, hbm // per_voice)))

    rng = np.random.default_rng(4)
    irs = rng.standard_normal((voices, ir_seconds * SR), dtype=np.float32) * 0.002
    cfg, state = farm2.farm2_init(irs, block, ir_seconds * SR,
                                  tail_dtype=tail_dtype)
    t = q * cfg.period
    x = jnp.asarray(rng.standard_normal((t, voices, block)).astype(np.float32))
    # serve with the precomputed head-kernel meta-DFT, as ReverbFarm does
    # (khat is input-independent between IR updates); packed farms default
    # to the bf16 head-transform tier, like ReverbFarm's dft_precision="auto"
    prec = "bf16" if tail_item == 2 else "highest"
    khat = jax.jit(functools.partial(farm2.farm2_head_khat, cfg,
                                     dft_precision=prec),
                   static_argnums=(1,))(state, t)
    wall = _time_call(
        lambda st, xs, kh: farm2.farm2_stream(cfg, st, xs,
                                              dft_precision=prec,
                                              head_khat=kh),
        state, x, aux=khat,
    )
    audio = t * block / SR
    xrt = audio / wall
    return {"voices": voices, "xrt_per_voice": xrt,
            "realtime_voices": round(xrt * voices),
            "tail_block": cfg.tail_block,
            "us_per_block_all_voices": wall / t * 1e6}


def config5b_reverb_farm_bf16():
    """Config 5 with the opt-in bf16 tail storage (farm2_init tail_dtype):
    ~half the per-voice memory and tail traffic at a documented ~1e-3
    relative tolerance on the tail contribution."""
    import jax.numpy as jnp

    return config5_reverb_farm(tail_dtype=jnp.bfloat16)


ALL = {
    "mono_block128_1s": config1_mono_parity,
    "stereo_block256_5s": config2_stereo,
    "two_stage_30s": config3_two_stage_30s,
    "crossfade_morph": config4_crossfade_morph,
    "reverb_farm": config5_reverb_farm,
    "reverb_farm_bf16": config5b_reverb_farm_bf16,
}
