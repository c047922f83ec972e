"""Roofline accounting: algorithmic FLOPs and device-memory bytes for the
engine paths, and the published peaks they are divided by.

The reference reports only wall time (``examples/compare_partitioned.rs:
36-53``); "fast" there is relative to real time.  On an accelerator the
honest denominator is the silicon: bench.py uses these counts to report

* ``mfu``      — algorithmic FLOPs / peak f32 FLOP/s
* ``hbm_util`` — algorithmic bytes moved / peak device-memory bandwidth

Counts are *algorithmic* (what the math requires, assuming each
materialized intermediate is written + read once): XLA fusion can move
fewer bytes, so both figures are utilization estimates, not measurements
of traffic.  Peaks come from :data:`PEAKS`, keyed by the ``device_kind``
JAX reports; a device missing from the table is an error.
"""

from __future__ import annotations

import dataclasses

from ..models import two_stage, uniform
from ..ops.fft import _DIRECT_MAX, _split_factors, next_power_of_two


@dataclasses.dataclass(frozen=True)
class Peaks:
    hbm_bps: float      # device-memory bandwidth, bytes/s
    f32_flops: float    # float32 outside the tensor cores — the rate the
                        # engines' Precision.HIGHEST f32 matmuls get
    bf16_flops: float   # dense bf16 tensor-core rate


# NVIDIA H100 SXM data sheet (dense rates, no sparsity, 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(hbm_bps=3.35e12, f32_flops=67e12,
                                   bf16_flops=989e12),
}


def peaks_for(device_kind: str) -> Peaks:
    """The published peaks of ``device_kind``; raises ``KeyError`` for a
    device that is not in :data:`PEAKS` (no peak is assumed)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


def _rdft_cost(batch: int, n: int) -> Cost:
    """Forward or inverse packed real DFT of length n (ops.fft.rdft_block):
    one [batch, n] @ [n, n] basis matmul up to ``_DIRECT_MAX``, the Bailey
    4-step factorization above it."""
    if n <= _DIRECT_MAX:
        return Cost(
            flops=2.0 * batch * n * n,
            bytes=4.0 * (batch * n * 2 + n * n),
        )
    n1, n2 = _split_factors(n)
    return Cost(
        flops=batch * (8.0 * n * (n1 + n2) + 6.0 * n),
        bytes=4.0 * batch * n * 2 * 3,
    )


def _cdft4_cost(batch: int, m: int, lanes: int) -> Cost:
    """One complex meta-DFT along a length-m axis with ``lanes`` lanes
    (ops.fft._cdft4_axis2): a direct basis matmul up to
    ``_DIRECT_META_MAX`` (one in+out pass), else 8 matmul-equivalents
    over the split factors plus the twiddle multiply."""
    from ..ops.fft import _DIRECT_META_MAX

    if m <= _DIRECT_META_MAX:
        # in + out passes plus the [m, m] (cos, sin) basis read — the
        # basis is negligible at production lane widths (m=256: 0.5 MB vs
        # ~33 MB of data) but keeps the estimate honest for narrow-lane
        # batches, and bench.py derives its slope-sanity floor from this
        return Cost(
            flops=batch * lanes * 8.0 * m * m,
            bytes=4.0 * (batch * m * lanes * 2 * 2 + 2.0 * m * m),
        )
    n1, n2 = _split_factors(m)
    flops = batch * lanes * (8.0 * m * (n1 + n2) + 6.0 * m)
    # read re+im in, write re+im out, plus one twiddle-sized temp pass
    bytes_ = 4.0 * batch * (m * lanes * 2 * 3)
    return Cost(flops, bytes_)


def stream_conv_cost(cfg: uniform.UniformConfig, t: int,
                     khat_hoisted: bool = False) -> Cost:
    """uniform.stream_conv_unguarded (time-DFT core) over T blocks.
    ``khat_hoisted``: the kernel-side meta-DFT is precomputed
    (uniform.stream_khat) — its forward pass drops out and the call only
    READS the khat arrays."""
    n, b = cfg.seg_count, cfg.block_size
    fft = cfg.fft_size
    lt = n - 1 + t
    m = next_power_of_two(lt)
    lanes = b  # packed [2, B] treated as one complex lane set of width B
    c = _rdft_cost(t, fft)                     # forward DFTs
    if khat_hoisted:
        c += _cdft4_cost(1, m, lanes)                 # ehat forward only
        c += Cost(flops=0.0, bytes=4.0 * m * lanes * 2)   # khat read
    else:
        c += _cdft4_cost(1, m, lanes).scaled(2)       # ehat + khat forward
    c += Cost(flops=6.0 * m * lanes, bytes=4.0 * m * lanes * 2 * 2)  # product
    c += _cdft4_cost(1, m, lanes)                     # inverse
    c += _rdft_cost(t, fft)                    # inverse DFTs
    # state traffic: read IR spectra + ring history, write ring
    c += Cost(flops=0.0, bytes=4.0 * (2 * n * 2 * b + t * 2 * b))
    return c


def stream_scan_sliced_cost(cfg: uniform.UniformConfig, t: int) -> Cost:
    """uniform.stream_scan_sliced_unguarded over T (tail-sized) blocks."""
    n, b = cfg.seg_count, cfg.block_size
    fft = cfg.fft_size
    c = _rdft_cost(t, fft) + _rdft_cost(t, fft)
    # per step: masked MAC over n packed rows (8 flops/complex point) and
    # reads of ring + doubled IR window
    per_step = Cost(
        flops=8.0 * n * b,
        bytes=4.0 * (2 * n * 2 * b + 2 * b * 3),
    )
    c += per_step.scaled(t)
    c += Cost(flops=0.0, bytes=4.0 * 2 * n * 2 * b)   # doubled-table build
    return c


def fused_heads_cost(cfg: two_stage.TwoStageConfig, t: int,
                     khat_hoisted: bool = False) -> Cost:
    """two_stage._fused_small_streams: ONE combined 2n-segment stream
    produces head + delayed tail0 (one meta-product, one inverse), plus
    the two small side passes (first-period subtract, exit-state rec).
    ``khat_hoisted``: served with precomputed stream_khats (the kernel
    meta-DFTs drop to khat reads)."""
    ucfg = cfg.head
    n, b = ucfg.seg_count, ucfg.block_size
    fft = ucfg.fft_size
    p = cfg.period
    q = t // p
    m = next_power_of_two(t + 2 * n - 1)

    def meta(msize: int) -> Cost:
        if khat_hoisted:
            return _cdft4_cost(1, msize, b) + Cost(
                flops=0.0, bytes=4.0 * msize * b * 2
            )
        return _cdft4_cost(1, msize, b).scaled(2)

    c = _rdft_cost(t, fft)                       # shared forward DFTs
    c += meta(m)                                 # ehat fwd (+ khat)
    c += Cost(flops=6.0 * m * b, bytes=4.0 * m * b * 2 * 2)   # product
    c += _cdft4_cost(1, m, b)                    # inverse
    c += _rdft_cost(t, fft)                      # inverse DFTs
    c += meta(2 * n)                             # first-period subtract
    nrec = min(q, 2) * p + 1
    c += meta(next_power_of_two(n - 1 + nrec))
    c += _rdft_cost(nrec, fft)                   # exit-state rec pass
    # state traffic: read both IR spectra tables + ring, write ring
    c += Cost(flops=0.0, bytes=4.0 * (2 * n * 2 * b * 2 + t * 2 * b))
    return c


def two_stage_stream_cost(cfg: two_stage.TwoStageConfig, t: int,
                          khat_hoisted: bool = True) -> Cost:
    """two_stage.process_stream_aligned over T head blocks (T % period == 0).
    ``khat_hoisted=True`` models the production khat-served call
    (api_two_stage/bench both cache stream_khats per IR epoch), including
    the big tail's conv-core routing policy
    (two_stage.tail_uses_conv_core / TAIL_CONV_RATIO)."""
    q = t // cfg.period
    if cfg.tail0 is not None and cfg.head == cfg.tail0:
        c = fused_heads_cost(cfg, t, khat_hoisted)
    else:
        c = stream_conv_cost(cfg.head, t, khat_hoisted)
        if cfg.tail0 is not None:
            c += stream_conv_cost(cfg.tail0, t, khat_hoisted)
    if cfg.tail is not None:
        if khat_hoisted and two_stage.tail_uses_conv_core(cfg, t):
            c += stream_conv_cost(cfg.tail, q, khat_hoisted=True)
        else:
            c += stream_scan_sliced_cost(cfg.tail, q)
    # the three-way output sum
    c += Cost(flops=2.0 * t * cfg.head_block, bytes=4.0 * 4 * t * cfg.head_block)
    return c


def utilization(cost: Cost, wall_seconds: float, peaks: Peaks) -> dict:
    return {
        "mfu": cost.flops / wall_seconds / peaks.f32_flops,
        "hbm_util": cost.bytes / wall_seconds / peaks.hbm_bps,
        "gflops": cost.flops / wall_seconds / 1e9,
        "gbps": cost.bytes / wall_seconds / 1e9,
    }
