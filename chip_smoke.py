"""Run the convolver's main path once on an NVIDIA GPU and check its output.

Usage::

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --chips 4   # four cards: the voice-sharded reverb
                                     # farm and the segment-sharded two-stage
                                     # engine, each against one card

One card, at the sizes of the BASELINE.json configurations:

1. device — refuse anything but a GPU; print the card, its power limit,
   JAX's version and the memory JAX may allocate.
2. flagship — ``TwoStageFFTConvolver``, block 128, 10 s 48 kHz IR, fed
   ~10 s of audio in 441-sample host buffers and in period-aligned long
   calls, against a float64 reference; ``reset()`` then repeats exactly.
3. uniform and crossfade — ``FFTConvolver`` (1 s IR) across a mid-stream
   ``update()`` against its analytic golden, and a ``CrossfadeConvolver``
   A/B morph every 0.5 s.
4. farm — ``ReverbFarm`` of 128 voices with distinct 60 s IRs, f32 then
   bf16 tail storage, three voices against float64, ``update_voices`` on
   two voices, and the time of the big-tail core.
5. timings — per-block latency of the public ``process`` calls.

Every phase prints its results on lines of its own, each with the card.
The last line is the JSON contract line, printed only when every phase
passed; any failure exits non-zero.  The script has no CPU path.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import sys
import time
import traceback

import numpy as np

SR = 48000
BLOCK = 128
QUANTUM_MS = BLOCK / SR * 1e3          # the 128-frame render quantum
F32_REL = 1e-5                          # the engines' golden contract
BF16_REL = 1e-2                         # bf16 tail (~1e-3) + bf16 heads (~6e-3)
COLLECTIVES = ("all-gather", "all-reduce", "collective-permute",
               "all-to-all", "reduce-scatter")


class SmokeFailure(Exception):
    """A phase's output broke its stated bound."""


@dataclasses.dataclass
class Context:
    card: str           # nvidia-smi name and power limit
    devices: list       # the cards the phases run on
    peaks: object       # utils.roofline.Peaks of the card


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(ctx: Context, phase: str, text: str) -> None:
    print(f"{phase}: {text} [{ctx.card}]", flush=True)


def contract_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


def ref_conv(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """First ``len(x)`` samples of ``x * h``, in float64 (an FFT product:
    exact to ~1e-12 relative, where a direct sum over 10^5-10^6 taps would
    take minutes on the host)."""
    n = len(x)
    h = np.asarray(h, np.float64)[:n]
    size = 1 << (n + len(h) - 1).bit_length()
    spec = np.fft.rfft(np.asarray(x, np.float64), size) * np.fft.rfft(h, size)
    return np.fft.irfft(spec, size)[:n]


def rel_err(y, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(y, np.float64) - ref))
                 / np.max(np.abs(ref)))


def percentiles_ms(fn, n: int, warm: int = 20):
    """p50 and p99 wall time of ``fn()`` in ms after ``warm`` calls; ``fn``
    must wait for its result (``block_until_ready`` or a host copy)."""
    for _ in range(warm):
        fn()
    times = np.empty(n)
    for i in range(n):
        t0 = time.perf_counter()
        fn()
        times[i] = time.perf_counter() - t0
    return (float(np.percentile(times, 50)) * 1e3,
            float(np.percentile(times, 99)) * 1e3)


def peak_bytes(device) -> int:
    return int(device.memory_stats()["peak_bytes_in_use"])


# ---------------------------------------------------------------- one card


def flagship(ctx: Context) -> None:
    from fft_convolution_tpu import TwoStageFFTConvolver

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(10 * SR) * 0.01).astype(np.float32)
    conv = TwoStageFFTConvolver(ir, BLOCK, len(ir))
    tb = conv.cfg.tail_block
    periods, per_call = 60, 10                  # 60 x 8192 samples = 10.24 s
    x = (rng.standard_normal(periods * tb) * 0.5).astype(np.float32)
    ref = ref_conv(x, ir)

    y_buf = np.concatenate([conv.process(x[s:s + 441])
                            for s in range(0, len(x), 441)])
    err_buf = rel_err(y_buf, ref)

    def aligned():
        conv.reset()
        step = per_call * tb
        return np.concatenate([conv.process(x[s:s + step])
                               for s in range(0, len(x), step)])

    y_al = aligned()
    err_al = rel_err(y_al, ref)
    identical = np.array_equal(aligned(), y_al)
    say(ctx, "flagship", f"TwoStageFFTConvolver block {BLOCK}, 10 s IR, "
        f"{len(x) / SR:.2f} s audio: 441-sample buffers rel err {err_buf:.3e}, "
        f"{per_call}-period calls rel err {err_al:.3e} (bound {F32_REL:g}); "
        f"reset() repeat identical={identical}")
    check(err_buf <= F32_REL, f"flagship 441-sample buffers rel err {err_buf:.3e}")
    check(err_al <= F32_REL, f"flagship aligned calls rel err {err_al:.3e}")
    check(identical, "flagship output after reset() differs from the first run")


def uniform_and_crossfade(ctx: Context) -> None:
    from fft_convolution_tpu import CrossfadeConvolver, FFTConvolver

    rng = np.random.default_rng(1)
    ir_a = (rng.standard_normal(SR) * 0.02).astype(np.float32)
    ir_b = (rng.standard_normal(SR) * 0.02).astype(np.float32)

    # mid-stream update: the input history stays and convolves with the new
    # IR; the one-block overlap is cleared, so the first post-update block
    # lacks the spill of every (block, segment) pair into it
    x = (rng.standard_normal(2 * SR) * 0.5).astype(np.float32)
    t = (SR // BLOCK) * BLOCK
    conv = FFTConvolver(ir_a, BLOCK, SR)
    y1 = conv.process(x[:t])
    conv.update(ir_b)
    y2 = conv.process(x[t:])
    g2 = ref_conv(x, ir_b)[t:]
    spill = np.zeros(BLOCK - 1)
    x64, b64 = x.astype(np.float64), ir_b.astype(np.float64)
    for i in range(SR // BLOCK + 1):
        seg = b64[i * BLOCK:(i + 1) * BLOCK]
        if len(seg) and t - BLOCK - i * BLOCK >= 0:
            lo = t - BLOCK - i * BLOCK
            spill += np.convolve(x64[lo:lo + BLOCK], seg)[BLOCK:BLOCK + BLOCK - 1]
    g2[:BLOCK - 1] -= spill
    err1, err2 = rel_err(y1, ref_conv(x[:t], ir_a)), rel_err(y2, g2)
    say(ctx, "uniform", f"FFTConvolver block {BLOCK}, 1 s IR: before update "
        f"rel err {err1:.3e}, after update {err2:.3e} (bound {F32_REL:g})")
    check(err1 <= F32_REL, f"uniform pre-update rel err {err1:.3e}")
    check(err2 <= F32_REL, f"uniform post-update rel err {err2:.3e}")

    # A/B morph every 0.5 s (BASELINE config 4), one 128-sample block per call
    fade = SR // 4
    cc = CrossfadeConvolver(FFTConvolver(ir_a, BLOCK, SR), SR, BLOCK, fade)
    n_blocks, morph = 3 * 188, 188              # morphs at 24064, 48128
    x = (rng.standard_normal(n_blocks * BLOCK) * 0.5).astype(np.float32)
    ys = []
    for i in range(n_blocks):
        if i and i % morph == 0:
            cc.update(ir_b if (i // morph) % 2 else ir_a)
        ys.append(cc.process(x[i * BLOCK:(i + 1) * BLOCK]))
    y = np.concatenate(ys)
    ref_a, ref_b = ref_conv(x, ir_a), ref_conv(x, ir_b)
    u1, u2 = morph * BLOCK, 2 * morph * BLOCK
    settled = BLOCK + fade + BLOCK              # hold, ramp, one spare block
    errs = {
        "A before morph": rel_err(y[:u1], ref_a[:u1]),
        "B after fade": rel_err(y[u1 + settled:u2], ref_b[u1 + settled:u2]),
        "A after fade back": rel_err(y[u2 + settled:], ref_a[u2 + settled:]),
    }
    say(ctx, "crossfade", "CrossfadeConvolver A/B morph every 0.5 s, "
        f"{fade}-sample fade: " + ", ".join(f"{k} rel err {v:.3e}"
                                           for k, v in errs.items())
        + f" (bound {F32_REL:g})")
    for k, v in errs.items():
        check(v <= F32_REL, f"crossfade {k} rel err {v:.3e}")


def farm(ctx: Context) -> None:
    import gc

    import jax.numpy as jnp

    from fft_convolution_tpu import ReverbFarm

    rng = np.random.default_rng(2)
    voices, ir_len = 128, 60 * SR
    irs = rng.standard_normal((voices, ir_len), dtype=np.float32) * 0.002
    dev = ctx.devices[0]
    for dtype, bound in ((jnp.float32, F32_REL), (jnp.bfloat16, BF16_REL)):
        name = jnp.dtype(dtype).name
        t0 = time.perf_counter()
        fm = ReverbFarm(irs, BLOCK, ir_len, tail_dtype=dtype)
        init_s = time.perf_counter() - t0
        t = 2 * fm.period
        calls = 3               # the big tail enters two periods in
        x = rng.standard_normal((calls * t, voices, BLOCK), dtype=np.float32)
        y = np.concatenate([fm.process(x[c * t:(c + 1) * t])
                            for c in range(calls)])
        errs = {}
        for v in (0, voices // 2, voices - 1):
            errs[v] = rel_err(y[:, v].reshape(-1),
                              ref_conv(x[:, v].reshape(-1), irs[v]))
        say(ctx, "farm", f"ReverbFarm {voices} voices x 60 s IRs, {name} "
            f"tail, init {init_s:.1f} s, {calls} calls of {t} blocks: "
            + ", ".join(f"voice {v} rel err {e:.3e}" for v, e in errs.items())
            + f" (bound {bound:g}); peak_bytes_in_use {peak_bytes(dev)}")
        for v, e in errs.items():
            check(e <= bound, f"farm {name} voice {v} rel err {e:.3e}")

        if dtype == jnp.float32:
            twin = fm.clone()
            touched = [1, voices - 2]
            fm.update_voices(touched, rng.standard_normal(
                (2, ir_len), dtype=np.float32) * 0.002)
            xn = rng.standard_normal((t, voices, BLOCK), dtype=np.float32)
            ya, yb = fm.process(xn), twin.process(xn)
            rest = [v for v in range(voices) if v not in touched]
            same = np.array_equal(ya[:, rest], yb[:, rest])
            moved = float(np.abs(ya[:, touched] - yb[:, touched]).max())
            say(ctx, "farm", f"update_voices({touched}): untouched voices "
                f"bit-identical={same}, touched voices max change {moved:.3e}")
            check(same, "update_voices changed an untouched voice")
            check(moved > 0, "update_voices left the touched voices unchanged")
            del twin
        tail_core_time(ctx, fm, name)
        del fm
        gc.collect()


def tail_core_time(ctx: Context, fm, name: str) -> None:
    """ms per call of the farm's big-tail core (the jnp phased correlation
    core) at the default call length, and the device-memory rate its ring
    and table-window bytes imply.  Consumes the farm's tail state."""
    import jax
    import jax.numpy as jnp

    from fft_convolution_tpu.parallel import farm2

    tcfg = fm.cfg.tail
    packed = fm.state.tail.segments.dtype == jnp.uint32
    q = farm2.DEFAULT_PERIODS_PER_CALL[2 if packed else 4]
    vb = fm.voices * fm.cfg.tail_block
    n = tcfg.seg_count
    core = jax.jit(functools.partial(farm2._tail_corr_phased_fused, tcfg),
                   donate_argnums=(0,))
    rows = jnp.asarray(np.random.default_rng(3).standard_normal(
        (q, fm.voices, fm.cfg.tail_block), dtype=np.float32))
    st = [fm.state.tail]
    fm.state = None

    def call():
        st[0], y = core(st[0], rows)
        y.block_until_ready()

    p50, p99 = percentiles_ms(call, n=20, warm=3)
    bytes_per_complex = 4 if packed else 8
    floor = bytes_per_complex * vb * (n + (n + q - 1))
    share = floor / (p50 * 1e-3) / ctx.peaks.hbm_bps
    say(ctx, "timings", f"farm big-tail core (plain XLA), {fm.voices} voices, "
        f"{name} tail, {q} tail blocks per call: p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms; ring + table window {floor / 1e9:.3f} GB per call = "
        f"{share:.1%} of the {ctx.peaks.hbm_bps / 1e12:.2f} TB/s peak at p50")


def timings(ctx: Context) -> None:
    from fft_convolution_tpu import (CrossfadeConvolver, FFTConvolver,
                                     TwoStageFFTConvolver)

    rng = np.random.default_rng(4)
    ir = (rng.standard_normal(10 * SR) * 0.01).astype(np.float32)
    blocks = (rng.standard_normal((64, BLOCK)) * 0.5).astype(np.float32)
    engines = {
        "FFTConvolver.process, 10 s IR": FFTConvolver(ir, BLOCK, len(ir)),
        "TwoStageFFTConvolver.process, 10 s IR":
            TwoStageFFTConvolver(ir, BLOCK, len(ir)),
    }
    ir_a, ir_b = (ir[:SR], ir[SR:2 * SR])
    # a fade longer than the warm-up and timed blocks together, so every
    # timed block is mid-fade (both engines and the mixer run)
    cc = CrossfadeConvolver(FFTConvolver(ir_a, BLOCK, SR), SR, BLOCK,
                            1024 * BLOCK)
    cc.update(ir_b)
    engines["CrossfadeConvolver.process mid-fade, 1 s IRs"] = cc
    for label, eng in engines.items():
        i = [0]

        def one_block():
            eng.process(blocks[i[0] % len(blocks)])
            i[0] += 1

        p50, p99 = percentiles_ms(one_block, n=500)
        say(ctx, "timings", f"{label}, one {BLOCK}-sample block per call: "
            f"p50 {p50:.4f} ms, p99 {p99:.4f} ms (quantum {QUANTUM_MS:.2f} ms)")
    check(cc.is_crossfading(), "crossfade timing left the fade")


# -------------------------------------------------------------- four cards


def farm_dp4(ctx: Context) -> None:
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fft_convolution_tpu import ReverbFarm

    rng = np.random.default_rng(5)
    voices, ir_len = 128, 60 * SR
    irs = rng.standard_normal((voices, ir_len), dtype=np.float32) * 0.002
    mesh = Mesh(np.array(ctx.devices), ("dp",))
    sharded = ReverbFarm(irs, BLOCK, ir_len, mesh=mesh)
    one = ReverbFarm(irs, BLOCK, ir_len)
    t = 2 * one.period
    errs = []
    for _ in range(3):
        x = rng.standard_normal((t, voices, BLOCK), dtype=np.float32)
        errs.append(rel_err(sharded.process(x), one.process(x)))
    shard_devs = [s.device for s in sharded.state.tail.segments_ir.addressable_shards]
    khat = next(iter(sharded._khat_cache.values()))
    hlo = sharded._stream.lower(sharded.state, jnp.asarray(x),
                                head_khat=khat).compile().as_text()
    counts = {c: hlo.count(f" {c}(") + hlo.count(f" {c}-start(")
              for c in COLLECTIVES}
    say(ctx, "farm_dp4", f"ReverbFarm {voices} voices x 60 s IRs over a "
        f"('dp',) mesh of {len(ctx.devices)} cards vs one card: per-call rel "
        f"err {', '.join(f'{e:.3e}' for e in errs)} (bound {F32_REL:g}); "
        f"tail shards on {len(set(shard_devs))} distinct cards; compiled "
        f"stream collectives {counts}; peak_bytes_in_use per card "
        f"{[peak_bytes(d) for d in ctx.devices]}")
    for e in errs:
        check(e <= F32_REL, f"sharded farm rel err {e:.3e}")
    check(len(set(shard_devs)) == len(ctx.devices),
          f"farm tail shards sit on {len(set(shard_devs))} cards")
    check(counts["all-gather"] == 0 and counts["all-reduce"] == 0,
          f"sharded farm stream compiled with collectives {counts}")


def two_stage_sp4(ctx: Context) -> None:
    from fft_convolution_tpu import (ShardedTwoStageConvolver,
                                     TwoStageFFTConvolver)
    from fft_convolution_tpu.parallel import partition

    rng = np.random.default_rng(6)
    ir = rng.standard_normal(60 * SR, dtype=np.float32) * 0.002
    mesh = partition.make_mesh(ctx.devices)
    sharded = ShardedTwoStageConvolver(ir, BLOCK, len(ir), mesh=mesh)
    one = TwoStageFFTConvolver(ir, BLOCK, len(ir))
    step = 4 * sharded.cfg.tail_block
    errs = []
    for _ in range(2):
        x = (rng.standard_normal(step) * 0.5).astype(np.float32)
        errs.append(rel_err(sharded.process(x), one.process(x)))
    say(ctx, "two_stage_sp4", f"ShardedTwoStageConvolver, 60 s IR, sp="
        f"{len(ctx.devices)} vs TwoStageFFTConvolver on one card: per-call "
        f"rel err {', '.join(f'{e:.3e}' for e in errs)} (bound {F32_REL:g})")
    for e in errs:
        check(e <= F32_REL, f"sharded two-stage rel err {e:.3e}")


# ------------------------------------------------------------------ driver


def select_phases(chips: int):
    if chips == 1:
        return [flagship, uniform_and_crossfade, farm, timings]
    if chips == 4:
        return [farm_dp4, two_stage_sp4]
    raise ValueError(f"--chips takes 1 or 4, not {chips}")


class CacheEvents:
    """Counts JAX's persistent compilation-cache events in this process."""

    def __init__(self):
        import jax

        self.counts = collections.Counter()
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_kwargs) -> None:
        if event.startswith("/jax/compilation_cache/"):
            self.counts[event.rsplit("/", 1)[1]] += 1

    def line(self, since: collections.Counter) -> str:
        d = self.counts - since
        return (f"compile cache requests {d['compile_requests_use_cache']}, "
                f"hits {d['cache_hits']}, writes {d['cache_misses']}")


def run_phases(phases, ctx: Context, events=None) -> int:
    """Run ``phases`` in order; stop at the first failure and return 1."""
    for phase in phases:
        since = collections.Counter(events.counts) if events else None
        t0 = time.perf_counter()
        try:
            phase(ctx)
        except Exception as e:  # noqa: BLE001 - report, then fail the run
            traceback.print_exc()
            print(f"FAIL {phase.__name__}: {type(e).__name__}: {e}", flush=True)
            return 1
        extra = f"; {events.line(since)}" if events else ""
        say(ctx, phase.__name__, f"passed in {time.perf_counter() - t0:.1f} s"
            + extra)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} cards, "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 2
    phases = select_phases(args.chips)

    from fft_convolution_tpu.utils.compile_cache import enable_compile_cache
    from fft_convolution_tpu.utils.profiling import gpu_cards
    from fft_convolution_tpu.utils.roofline import peaks_for

    cache_dir = enable_compile_cache()
    ctx = Context(card=gpu_cards(), devices=devices[:args.chips],
                  peaks=peaks_for(devices[0].device_kind))
    print(f"gpu: {ctx.card}", flush=True)
    say(ctx, "device", f"{len(devices)} x {devices[0].device_kind}, jax "
        f"{jax.__version__}, bytes_limit "
        f"{[d.memory_stats()['bytes_limit'] for d in ctx.devices]}, "
        f"compile cache {cache_dir}")
    rc = run_phases(phases, ctx, CacheEvents())
    if rc:
        return rc
    print(contract_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
