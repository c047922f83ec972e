"""Real-DFT engine and DSP helpers — the JAX counterpart of the
reference's L0 layer (``src/fft_convolver.rs:8-84``).

The reference wraps ``realfft``/``rustfft`` CPU plans (``src/fft_convolver.rs:8-50``).
Here the transform is a **DFT-as-matmul** over real arrays (the design
was first built for an accelerator with no FFT op and no complex dtype;
whether ``jnp.fft`` on complex64 serves better on the GPU is an open
measurement):

* small transforms (n <= ``_DIRECT_MAX``) are a single real matmul against a
  precomputed ``[n, 2B]`` basis;
* large transforms use Bailey's 4-step factorization ``n = n1 * n2``: an
  ``n2``-point DFT stage (matmul), a twiddle multiply (elementwise), and an
  ``n1``-point DFT stage (matmul).

Every matmul passes ``precision=HIGHEST`` unless a caller opts into the
bf16 tier: a float32 matmul at default precision may run in TF32, which
keeps ~3 decimal digits — far outside the 1e-5 parity contract.

Spectra use the classic *halfcomplex packing*: a real transform of length
``n = 2B`` has ``B+1`` bins, of which bins 0 and B (DC, Nyquist) are purely
real.  We store ``re[0..B-1]`` and ``im[0..B-1]`` with ``im[0]`` holding the
Nyquist real value, giving a ``[..., 2, B]`` array whose last dim is the
block size — a power of two with **zero padding waste** (vs. the
B+1 = 129-bin layout that would force padding to 256).  All complex
arithmetic is decomposed into real elementwise ops in ``cpx.py``.

Normalization matches the reference: unnormalized forward
(``Fft::forward``, ``src/fft_convolver.rs:36-39``), ``1/n`` on the inverse
(``Fft::inverse``, ``:41-49``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Largest transform done as one direct basis matmul. Above this, the 4-step
# factorization keeps the basis O(sqrt(n)^2) and the error O(log n) stages.
_DIRECT_MAX = 1024


def _mm_mode(precision):
    """Resolve a transform precision spec into
    ``(lax_matmul_precision, operand_dtype)``.

    ``precision`` is a ``jax.lax.Precision`` (operands stay f32;
    HIGHEST is the parity-exact default) or the string ``"bf16"``:
    operands, DFT matrices, and stage intermediates are cast to
    bfloat16 — half the operand and inter-stage traffic, at ~1e-3
    relative accuracy.  That is
    the same tier as the farm's plane-packed bf16 tail storage
    (``ops/packing.py``), its intended consumer: an opt-in throughput
    mode for reverb-tail content, never the default (the 1e-6 parity
    tests pin HIGHEST)."""
    if precision == "bf16":
        return jax.lax.Precision.DEFAULT, jnp.bfloat16
    return precision, None


def _opcast(a: jnp.ndarray, od) -> jnp.ndarray:
    """Cast a matmul operand / stage intermediate for :func:`_mm_mode`'s
    dtype (no-op in the f32 modes).  XLA fuses the convert into the
    operand read, so f32 producers feeding bf16 matmuls cost nothing
    extra; materialized bf16 intermediates halve their HBM bytes."""
    return a if od is None else a.astype(od)


def complex_size(size: int) -> int:
    """Number of rFFT bins for a real transform of length ``size``
    (``complex_size``, ``src/fft_convolver.rs:52-54``).  The packed layout
    stores the same information in ``size // 2`` lanes."""
    return size // 2 + 1


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (n=0 -> 1), matching Rust's
    ``usize::next_power_of_two`` (``src/fft_convolver.rs:115,525``)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def copy_and_pad(src: jnp.ndarray, total: int) -> jnp.ndarray:
    """Copy ``src`` and zero-fill to length ``total``
    (``copy_and_pad``, ``src/fft_convolver.rs:56-60``)."""
    src = jnp.asarray(src)
    if src.shape[-1] > total:
        raise ValueError(f"src longer ({src.shape[-1]}) than pad target {total}")
    pad = [(0, 0)] * (src.ndim - 1) + [(0, total - src.shape[-1])]
    return jnp.pad(src, pad)


def _split_factors(n: int) -> tuple[int, int]:
    """n = n1 * n2 with n1 >= n2, both powers of two near sqrt(n)."""
    m = n.bit_length() - 1
    n1 = 1 << ((m + 1) // 2)
    return n1, n // n1


# ---------------------------------------------------------------------------
# basis construction (host-side, float64 -> float32 for maximum basis accuracy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rdft_basis(n: int) -> np.ndarray:
    """Forward packed-rDFT basis F [n, 2B]: ``x @ F -> [re | im]`` with
    ``im[0]`` = Nyquist.  Unnormalized forward transform."""
    b = n // 2
    i = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(b, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * i * k / n
    cos = np.cos(ang)
    sin = -np.sin(ang)
    sin[:, 0] = np.cos(np.pi * i[:, 0])  # Nyquist real part in im[0]
    return np.concatenate([cos, sin], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _irdft_basis(n: int) -> np.ndarray:
    """Inverse packed-rDFT basis G [2B, n]: ``packed @ G -> x``; includes the
    reference's 1/n normalization (``src/fft_convolver.rs:44-46``)."""
    b = n // 2
    i = np.arange(n, dtype=np.float64)[None, :]
    k = np.arange(b, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * i / n
    cos_rows = 2.0 * np.cos(ang) / n
    cos_rows[0, :] = 1.0 / n                      # DC counted once
    sin_rows = -2.0 * np.sin(ang) / n
    sin_rows[0, :] = np.cos(np.pi * i[0, :]) / n  # Nyquist row from im[0]
    return np.concatenate([cos_rows, sin_rows], axis=0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_mats(m: int, sign: float) -> tuple[np.ndarray, np.ndarray]:
    """m-point DFT matrix (cos, sin) with exponent sign (-1 fwd, +1 inv)."""
    i = np.arange(m, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(i, i) / m
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, sign: float,
              factors: tuple[int, int] | None = None,
              ) -> tuple[np.ndarray, np.ndarray]:
    """4-step twiddle factors w^(i1*k2), shaped [k2=n2, i1=n1]."""
    n1, n2 = _split_factors(n) if factors is None else factors
    k2 = np.arange(n2, dtype=np.float64)[:, None]
    i1 = np.arange(n1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k2 * i1 / n
    return np.cos(ang).astype(np.float32), (sign * np.sin(ang)).astype(np.float32)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _irdft_direct(p: jnp.ndarray, n: int, precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    hp, od = _mm_mode(precision)
    basis = _opcast(jnp.asarray(_irdft_basis(n)), od)
    flat = _opcast(p.reshape(p.shape[:-2] + (n,)), od)
    return jnp.matmul(flat, basis, preferred_element_type=jnp.float32, precision=hp)


def _dft4_real(x: jnp.ndarray, n: int, precision=jax.lax.Precision.HIGHEST) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bailey 4-step forward DFT of real input over the last axis; ``x``
    may be SHORTER than ``n`` — the implicit zero tail is folded by
    row-slicing the stage-1 DFT matrix instead of padding the input
    (the standard overlap-add callers transform length-``n/2`` blocks,
    so this both removes a whole-input pad pass and HALVES the stage-1
    matmul).

    Returns full-spectrum (re, im), each [..., n].  Stage 1 exploits the
    real input (2 matmuls instead of 4).
    """
    n1, n2 = _split_factors(n)
    hp, od = _mm_mode(precision)
    batch = x.shape[:-1]
    length = x.shape[-1]
    rows = -(-length // n1)
    if rows * n1 != length:
        x = copy_and_pad(x, rows * n1)
    a = _opcast(x.reshape(batch + (rows, n1)), od)        # A[i2, i1]
    c2, s2 = (_opcast(jnp.asarray(np.ascontiguousarray(m[:, :rows])), od)
              for m in _dft_mats(n2, -1.0))
    # stage 1: DFT_n2 along (the live rows of) i2 -> G[k2, i1]
    g_re = jnp.einsum("ki,...ij->...kj", c2, a, preferred_element_type=jnp.float32, precision=hp)
    g_im = jnp.einsum("ki,...ij->...kj", s2, a, preferred_element_type=jnp.float32, precision=hp)
    # stage 2: twiddle w^(i1*k2)
    t_re, t_im = (jnp.asarray(m) for m in _twiddles(n, -1.0))
    h_re = _opcast(g_re * t_re - g_im * t_im, od)
    h_im = _opcast(g_re * t_im + g_im * t_re, od)
    # stage 3: DFT_n1 along i1 -> Y[k2, k1]
    c1, s1 = (_opcast(jnp.asarray(m), od) for m in _dft_mats(n1, -1.0))
    y_re = jnp.matmul(h_re, c1, preferred_element_type=jnp.float32, precision=hp) - jnp.matmul(
        h_im, s1, preferred_element_type=jnp.float32, precision=hp
    )
    y_im = jnp.matmul(h_re, s1, preferred_element_type=jnp.float32, precision=hp) + jnp.matmul(
        h_im, c1, preferred_element_type=jnp.float32, precision=hp
    )
    # X[k1*n2 + k2] = Y[k2, k1]
    re = jnp.swapaxes(y_re, -1, -2).reshape(batch + (n,))
    im = jnp.swapaxes(y_im, -1, -2).reshape(batch + (n,))
    return re, im


def _rdft_4step(x: jnp.ndarray, n: int, precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    b = n // 2
    re, im = _dft4_real(x, n, precision)
    p_re = re[..., :b]
    p_im = jnp.concatenate([re[..., b : b + 1], im[..., 1:b]], axis=-1)
    return jnp.stack([p_re, p_im], axis=-2)


def _cidft4_real(re: jnp.ndarray, im: jnp.ndarray, m: int,
                 precision=jax.lax.Precision.HIGHEST,
                 scale: float = 1.0) -> jnp.ndarray:
    """Real part of the +sign (inverse-direction, unnormalized) complex
    4-step DFT along the LAST axis: ``out[t] = Re sum_k (re+i im)[k]
    e^{+2i pi k t / m}``.  Final stage computes only the real part
    (2 matmuls).  ``scale`` folds a normalization into the final-stage
    matrices (host-side), so callers avoid a full-array scaling pass."""
    batch = re.shape[:-1]
    n1, n2 = _split_factors(m)
    hp, od = _mm_mode(precision)
    a_re = _opcast(re.reshape(batch + (n2, n1)), od)
    a_im = _opcast(im.reshape(batch + (n2, n1)), od)
    c2, s2 = (_opcast(jnp.asarray(x), od) for x in _dft_mats(n2, 1.0))

    def mm(mat, arr):
        return jnp.einsum("ki,...ij->...kj", mat, arr,
                          preferred_element_type=jnp.float32,
                          precision=hp)

    g_re = mm(c2, a_re) - mm(s2, a_im)
    g_im = mm(c2, a_im) + mm(s2, a_re)
    t_re, t_im = (jnp.asarray(x) for x in _twiddles(m, 1.0))
    h_re = _opcast(g_re * t_re - g_im * t_im, od)
    h_im = _opcast(g_re * t_im + g_im * t_re, od)
    c1, s1 = (_opcast(jnp.asarray(np.float32(scale) * x), od)
              for x in _dft_mats(n1, 1.0))
    y_re = jnp.matmul(h_re, c1, preferred_element_type=jnp.float32,
                      precision=hp) - jnp.matmul(
        h_im, s1, preferred_element_type=jnp.float32, precision=hp
    )
    return jnp.swapaxes(y_re, -1, -2).reshape(batch + (m,))


@functools.lru_cache(maxsize=None)
def _odd_twiddles(b: int) -> tuple[np.ndarray, np.ndarray]:
    """``w[k] = e^{+i pi k / b}`` — the odd-output twiddle of the even/odd
    split real inverse."""
    k = np.arange(b, dtype=np.float64)
    ang = np.pi * k / b
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _irdft_4step(p: jnp.ndarray, n: int, precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Inverse real DFT via the even/odd decimation identity — NO Hermitian
    extension: with half-spectrum ``H`` (packed) and ``G = [H0/2, H1..]``,

        out[2 tau + r] = (2/n) Re IDFT_b(G * w_r)[tau] + (1/n) (-1)^r Nyq,
        w_0 = 1,  w_1[k] = e^{+i pi k / b}

    i.e. two half-length real-part inverse 4-steps and a lane interleave.
    Materializing the length-``n`` Hermitian extension would take two
    last-axis reverses; this form has none, and does ~30% fewer matmul
    FLOPs besides (two b-point stages vs one 2b-point)."""
    return _irdft_4step_pair(p[..., 0, :], p[..., 1, :], n, precision)


def _irdft_4step_pair(p_re: jnp.ndarray, p_im: jnp.ndarray, n: int,
                      precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """:func:`_irdft_4step` on separate packed planes ``[..., B]`` — what
    planes-outer fused-voice callers have in hand (indexing their plane
    axis is free; re-laying out to the interleaved ``[..., 2, B]`` interface
    would copy the whole array)."""
    b = n // 2
    nyq = p_im[..., :1]
    # lane-0 fixups (halve DC re, zero the Nyquist-carrying im) as masked
    # multiplies, NOT 1-lane concats — a 1-lane concat shifts every other
    # element of the last axis; these fuse into the twiddle elementwise
    # stage instead
    m0 = jnp.zeros((b,), jnp.float32).at[0].set(1.0)
    g_re = p_re * (1.0 - 0.5 * m0)
    g_im = p_im * (1.0 - m0)

    wr, wi = (jnp.asarray(x) for x in _odd_twiddles(b))
    g1_re = g_re * wr - g_im * wi
    g1_im = g_re * wi + g_im * wr

    # the 2/n and 1/n normalizations fold into the inverse matrices and
    # the (lane-1) Nyquist term — no whole-array scaling pass
    nyq_n = nyq * np.float32(1.0 / n)
    even = _cidft4_real(g_re, g_im, b, precision, scale=2.0 / n) + nyq_n
    odd = _cidft4_real(g1_re, g1_im, b, precision, scale=2.0 / n) - nyq_n
    return jnp.stack([even, odd], axis=-1).reshape(p_re.shape[:-1] + (n,))


# Largest meta-DFT done as ONE direct complex matmul along axis -2.  The
# 4-step costs ~16*m*sqrt(m) flops/lane vs the direct's 8*m^2 (sqrt(m)/2
# more), but materializes THREE serialized stage temps of the full
# [..., m, L] array; below this m the direct path's single full-contraction
# matmul plus one in/out pass is taken — the flagship tail meta (m=128,
# L=8192) and the two-stage side passes live here.
_DIRECT_META_MAX = 256


def _cdft_direct_axis2(re: jnp.ndarray, im: jnp.ndarray, m: int, sign: float,
                       precision, scale: float,
                       out_rows: tuple[int, int] | None,
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Direct complex DFT along axis -2: 4 real matmuls against the
    [m, m] f64-built basis (rows sliced to ``out_rows``)."""
    hp, od = _mm_mode(precision)
    c, s = _dft_mats(m, sign)
    if out_rows is not None:
        r_lo, r_cnt = out_rows
        c = c[r_lo: r_lo + r_cnt]
        s = s[r_lo: r_lo + r_cnt]
    c = _opcast(jnp.asarray(np.float32(scale) * c), od)
    s = _opcast(jnp.asarray(np.float32(scale) * s), od)
    a_re, a_im = _opcast(re, od), _opcast(im, od)

    def mm(mat, arr):  # [k, i] x [..., i, L] -> [..., k, L]
        return jnp.einsum("ki,...il->...kl", mat, arr,
                          preferred_element_type=jnp.float32, precision=hp)

    out_re = mm(c, a_re) - mm(s, a_im)
    out_im = mm(s, a_re) + mm(c, a_im)
    return out_re, out_im


def _cdft4_axis2(re: jnp.ndarray, im: jnp.ndarray, m: int, sign: float,
                 precision=jax.lax.Precision.HIGHEST,
                 scale: float = 1.0,
                 factors: tuple[int, int] | None = None,
                 out_rows: tuple[int, int] | None = None,
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Complex DFT of length ``m`` (power of two) along axis -2 of
    ``[..., m, L]`` arrays — one direct basis matmul up to
    ``_DIRECT_META_MAX``, Bailey 4-step above it (every stage a matmul
    over the time axis, lanes untouched).  Unnormalized;
    ``sign=-1`` forward, ``+1`` inverse.
    ``scale`` folds a normalization (e.g. the inverse's 1/m) into the
    final-stage matrices — saves a whole-array pass per call.
    ``factors``: override the (n1, n2) split (default near-sqrt);
    forcing factors also forces the 4-step path.
    ``out_rows``: ``(start, count)`` — produce ONLY output rows
    ``[start, start + count)``.  Output row ``k1*n2 + k2`` lives in final-
    stage column ``k1``, so a row range needs only ``ceil``-covering k1
    columns: the final matmuls, their twiddled operand's last write, and
    the swap re-layout all shrink proportionally (the overlap-save callers
    keep ~half the rows — see ``causal_conv_time``)."""
    if factors is None and m <= _DIRECT_META_MAX:
        return _cdft_direct_axis2(re, im, m, sign, precision, scale, out_rows)
    n1, n2 = _split_factors(m) if factors is None else factors
    assert n1 * n2 == m, (n1, n2, m)
    batch = re.shape[:-2]
    lanes = re.shape[-1]
    hp, od = _mm_mode(precision)
    a_re = _opcast(re.reshape(batch + (n2, n1, lanes)), od)
    a_im = _opcast(im.reshape(batch + (n2, n1, lanes)), od)
    c2, s2 = (_opcast(jnp.asarray(x), od) for x in _dft_mats(n2, sign))

    def mm2(mat, arr):  # contract the n2 axis: [k2,i2] x [..., i2, i1, L]
        return jnp.einsum("ki,...ijl->...kjl", mat, arr,
                          preferred_element_type=jnp.float32, precision=hp)

    g_re = mm2(c2, a_re) - mm2(s2, a_im)
    g_im = mm2(c2, a_im) + mm2(s2, a_re)
    t_re, t_im = (jnp.asarray(x)[..., None]
                  for x in _twiddles(m, sign, (n1, n2)))
    h_re = _opcast(g_re * t_re - g_im * t_im, od)
    h_im = _opcast(g_re * t_im + g_im * t_re, od)
    c1m, s1m = (_opcast(jnp.asarray(np.float32(scale) * x), od)
                for x in _dft_mats(n1, sign))
    k1_lo = 0
    n_rows = m
    if out_rows is not None:
        r_lo, r_cnt = out_rows
        assert 0 <= r_lo and r_lo + r_cnt <= m, (out_rows, m)
        k1_lo = r_lo // n2
        k1_hi = -(-(r_lo + r_cnt) // n2)
        c1m = c1m[:, k1_lo:k1_hi]
        s1m = s1m[:, k1_lo:k1_hi]
        n_rows = (k1_hi - k1_lo) * n2

    def mm1(mat, arr):  # contract the n1 axis: [..., k2, i1, L] x [i1, k1]
        return jnp.einsum("...kjl,jm->...kml", arr, mat,
                          preferred_element_type=jnp.float32, precision=hp)

    y_re = mm1(c1m, h_re) - mm1(s1m, h_im)
    y_im = mm1(s1m, h_re) + mm1(c1m, h_im)
    # X[k1*n2 + k2] = Y[k2, k1] -> swap then flatten
    out_re = jnp.swapaxes(y_re, -3, -2).reshape(batch + (n_rows, lanes))
    out_im = jnp.swapaxes(y_im, -3, -2).reshape(batch + (n_rows, lanes))
    if out_rows is not None:
        off = r_lo - k1_lo * n2
        out_re = jax.lax.slice_in_dim(out_re, off, off + r_cnt, axis=-2)
        out_im = jax.lax.slice_in_dim(out_im, off, off + r_cnt, axis=-2)
    return out_re, out_im


def _pad_rows(x: jnp.ndarray, m: int) -> jnp.ndarray:
    if m == x.shape[-2]:
        # hot callers build ext at m rows exactly (zeros folded into
        # their existing history++blocks concat) — a 0-row jnp.pad still
        # lowered to a full-array copy in the compiled farm stream
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, m - x.shape[-2]), (0, 0)]
    return jnp.pad(x, pad)


def causal_conv_khat(kern: jnp.ndarray, m: int,
                     precision=jax.lax.Precision.HIGHEST,
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The input-independent half of :func:`causal_conv_time`: the kernel
    spectra table's block-axis DFT, zero-padded to ``m`` meta-bins.

    The table only changes on IR update, yet inline it is one third of the
    stream MAC's matmul work (and its largest intermediate) recomputed
    every call — precompute once per (table, m) and pass as ``kern_hat=``.
    ``m`` must be ``next_power_of_two(ext_rows)`` of the stream call it
    will serve.  Returns ``(khat_re, khat_im)``, each ``[..., m, B]``.
    """
    k_re = _pad_rows(kern[..., 0, :], m)
    k_im = _pad_rows(kern[..., 1, :], m)
    return _cdft4_axis2(k_re, k_im, m, -1.0, precision)


def causal_conv_time(ext: jnp.ndarray, kern: jnp.ndarray, t_out: int,
                     precision=jax.lax.Precision.HIGHEST,
                     kern_hat: tuple[jnp.ndarray, jnp.ndarray] | None = None,
                     m: int | None = None,
                     row0: int | None = None,
                     ) -> jnp.ndarray:
    """``out[t] = sum_i kern[i] (*) ext[N-1+t-i]`` — the frequency-delay-line
    MAC over a whole stream, computed by a SECOND DFT along the block axis
    (overlap-save at the meta level) — all matmuls instead of a grouped
    convolution.

    ``ext``: [..., Lt, 2, B] packed spectra (block history ++ new blocks);
    ``kern``: [..., N, 2, B] packed IR partition spectra.  Per audio lane,
    the packed (re, im) pair is treated as one complex sequence along t, so
    one complex circular convolution yields exactly the (rr - ii, ri + ir)
    components of the packed product; lane 0 (DC & Nyquist, both real) needs
    rr and ii separately, recovered from one extra spectral product with the
    index-reversed conjugate kernel spectrum on that single lane.

    ``kern_hat``: optional precomputed :func:`causal_conv_khat` of ``kern``
    at this call's ``m`` — skips the kernel-side meta-DFT (the table is
    input-independent; hot streaming paths precompute it at IR-set time).

    ``m``: optional meta-DFT size override (must be a power of two
    ``>= len(ext)``).  A caller slicing output rows where the circular
    indices wrap must size ``m`` so wrapped reads land in the zero pad
    (``m >= lt + max_wrap``) — used by the combined head+tail0 kernel,
    whose first rows deliberately read zeros for out-of-window history.

    ``row0``: optional output-row offset override (default ``N - 1``, the
    full-history position).  ``row0 = h`` with ``h`` history rows in
    ``ext`` yields ``out[t] = sum_i kern[i] (*) spec[t - i]`` where
    ``ext[h + t]`` is new block ``t`` — rows whose lag exceeds the
    available history read the zero pad (see ``m``).

    ``ext`` may also be a TUPLE ``(e_re, e_im)`` of ``[..., Lt, B]``
    plane-separated arrays — callers whose history is stored
    plane-separated (the CHRONO sliding window) pass the planes directly
    and skip the ``ext[..., p, :]`` extraction, which on a
    plane-interleaved ``T(2,128)`` layout costs a half-wasted read plus an
    8x-amplified ``T(1,128)`` write (the dominant op of the first chrono
    full-stream compile, ~235k cycles at config-3 shape).
    """
    if isinstance(ext, tuple):
        e_re_raw, e_im_raw = ext
        lt = e_re_raw.shape[-2]
        b = e_re_raw.shape[-1]
    else:
        lt = ext.shape[-3]
        b = ext.shape[-1]
    n = kern.shape[-3]
    if m is None:
        m = next_power_of_two(lt)
    elif m < lt or m & (m - 1):
        raise ValueError(f"m={m} must be a power of two >= len(ext)={lt}")

    if isinstance(ext, tuple):
        e_re = _pad_rows(e_re_raw, m)
        e_im = _pad_rows(e_im_raw, m)
    else:
        e_re = _pad_rows(ext[..., 0, :], m)
        e_im = _pad_rows(ext[..., 1, :], m)

    ehat_re, ehat_im = _cdft4_axis2(e_re, e_im, m, -1.0, precision)
    if kern_hat is None:
        khat_re, khat_im = causal_conv_khat(kern, m, precision)
    else:
        khat_re, khat_im = kern_hat
        if khat_re.shape[-2] != m:
            raise ValueError(
                f"kern_hat was built for m={khat_re.shape[-2]} meta-bins "
                f"but this stream call needs m={m}"
            )

    # main product: IDFT gives (rr - ii) + i (ri + ir) per lane; the 1/m
    # normalization rides inside the inverse's final matmul stage, and the
    # output-row window [r0, r0 + t_out) folds into its final-stage
    # matrix columns (out_rows) — overlap-save discards ~half the rows,
    # so computing/materializing only the kept k1 blocks saves ~40% of
    # each inverse's final stage + re-layout
    r0 = n - 1 if row0 is None else row0
    z_re = ehat_re * khat_re - ehat_im * khat_im
    z_im = ehat_re * khat_im + ehat_im * khat_re
    main_re, main_im = _cdft4_axis2(z_re, z_im, m, 1.0, precision,
                                    scale=1.0 / m, out_rows=(r0, t_out))

    # lane-0 correction: conv with conj(kern) gives (rr + ii) + i (ir - ri);
    # DFT(conj(k))[f] = conj(K[-f mod M]) — no extra forward DFT needed
    kc_re = jnp.roll(jnp.flip(khat_re[..., :1], axis=-2), 1, axis=-2)
    kc_im = -jnp.roll(jnp.flip(khat_im[..., :1], axis=-2), 1, axis=-2)
    e0_re, e0_im = ehat_re[..., :1], ehat_im[..., :1]
    zc_re = e0_re * kc_re - e0_im * kc_im
    zc_im = e0_re * kc_im + e0_im * kc_re
    conj_re, _ = _cdft4_axis2(zc_re, zc_im, m, 1.0, precision,
                              scale=1.0 / m, out_rows=(r0, t_out))
    # main_re: rr - ii (lanes >= 1: final re); main_im: ri + ir;
    # conj_re: rr + ii (lane 0 only)

    # lane-0 merge as a masked select, NOT a last-axis concatenate — a
    # 1-lane concat shifts every other element into a copy
    rr0 = (main_re[..., :1] + conj_re) * 0.5
    ii0 = (conj_re - main_re[..., :1]) * 0.5
    m0 = jnp.zeros((b,), jnp.float32).at[0].set(1.0)
    re = main_re * (1.0 - m0) + rr0 * m0
    im = main_im * (1.0 - m0) + ii0 * m0
    return jnp.stack([re, im], axis=-2)  # [..., T, 2, B]


def causal_conv_multi(ext, kerns: list, windows: list,
                      m: int | None = None,
                      precision=jax.lax.Precision.HIGHEST) -> list:
    """Several :func:`causal_conv_time` convolutions against ONE shared
    ``ext``, computed with ONE forward meta-DFT and ONE lane-stacked
    inverse — the latency-bound short-call form (a 2-period single-voice
    call is a serialized chain of small matmuls; every separate conv pays
    a full forward + two inverse meta-DFT chains, while stacking along
    lanes widens one matmul instead).

    The lane-0 (DC & Nyquist) conjugate corrections — a separate 1-lane
    inverse DFT chain per conv in :func:`causal_conv_time` — ride the SAME
    stacked inverse as one extra 128-lane block holding all ``k``
    correction lanes.

    ``ext``: ``[Lt, 2, B]`` packed spectra or a ``(e_re, e_im)`` tuple of
    ``[Lt, B]`` planes (the CHRONO form).  ``kerns``: list whose entries
    are either precomputed :func:`causal_conv_khat` tuples at this ``m``
    or raw ``[N, 2, B]`` kernel tables (DFT'd inline).  ``windows``: list
    of ``(row0, count)`` output-row windows, one per kernel, with
    :func:`causal_conv_time`'s ``row0`` semantics; the single inverse
    materializes the UNION row range and each result is sliced from it.
    Callers own the wrap-safety bound (``m`` large enough that every
    window's out-of-range history reads land in ``ext``'s zero pad).

    Returns a list of ``[count_i, 2, B]`` packed outputs, exactly equal
    (same matmul sequence modulo stacking) to per-kernel
    ``causal_conv_time(ext, kern_i, count_i, m=m, row0=row0_i)`` calls.
    """
    assert len(kerns) == len(windows) and kerns, (len(kerns), len(windows))
    if isinstance(ext, tuple):
        e_re_raw, e_im_raw = ext
        lt = e_re_raw.shape[-2]
        b = e_re_raw.shape[-1]
    else:
        lt = ext.shape[-3]
        b = ext.shape[-1]
    if m is None:
        m = next_power_of_two(lt)
    elif m < lt or m & (m - 1):
        raise ValueError(f"m={m} must be a power of two >= len(ext)={lt}")

    if isinstance(ext, tuple):
        e_re = _pad_rows(e_re_raw, m)
        e_im = _pad_rows(e_im_raw, m)
    else:
        e_re = _pad_rows(ext[..., 0, :], m)
        e_im = _pad_rows(ext[..., 1, :], m)
    ehat_re, ehat_im = _cdft4_axis2(e_re, e_im, m, -1.0, precision)
    e0_re, e0_im = ehat_re[..., :1], ehat_im[..., :1]

    k = len(kerns)
    cw = 128  # conj-correction block width: one lane tile holds all k lanes
    assert k <= cw, k
    zs_re, zs_im, zc_res, zc_ims = [], [], [], []
    for kern in kerns:
        if isinstance(kern, tuple):
            khat_re, khat_im = kern
            if khat_re.shape[-2] != m:
                raise ValueError(
                    f"kern_hat was built for m={khat_re.shape[-2]} meta-bins "
                    f"but this stream call needs m={m}"
                )
        else:
            khat_re, khat_im = causal_conv_khat(kern, m, precision)
        zs_re.append(ehat_re * khat_re - ehat_im * khat_im)
        zs_im.append(ehat_re * khat_im + ehat_im * khat_re)
        # lane-0 conj product: DFT(conj(k))[f] = conj(K[-f mod M])
        kc_re = jnp.roll(jnp.flip(khat_re[..., :1], axis=-2), 1, axis=-2)
        kc_im = -jnp.roll(jnp.flip(khat_im[..., :1], axis=-2), 1, axis=-2)
        zc_res.append(e0_re * kc_re - e0_im * kc_im)
        zc_ims.append(e0_re * kc_im + e0_im * kc_re)

    zshape = zc_res[0].shape[:-1] + (cw - k,)
    c_re = jnp.concatenate(zc_res + [jnp.zeros(zshape, jnp.float32)], axis=-1)
    c_im = jnp.concatenate(zc_ims + [jnp.zeros(zshape, jnp.float32)], axis=-1)
    z_re = jnp.concatenate(zs_re + [c_re], axis=-1)      # [..., m, k*B + 128]
    z_im = jnp.concatenate(zs_im + [c_im], axis=-1)

    r_lo = min(w[0] for w in windows)
    r_hi = max(w[0] + w[1] for w in windows)
    out_re, out_im = _cdft4_axis2(z_re, z_im, m, 1.0, precision,
                                  scale=1.0 / m, out_rows=(r_lo, r_hi - r_lo))

    m0 = jnp.zeros((b,), jnp.float32).at[0].set(1.0)
    results = []
    for i, (r0, cnt) in enumerate(windows):
        main_re = jax.lax.slice_in_dim(
            out_re[..., i * b:(i + 1) * b], r0 - r_lo, r0 - r_lo + cnt,
            axis=-2)
        main_im = jax.lax.slice_in_dim(
            out_im[..., i * b:(i + 1) * b], r0 - r_lo, r0 - r_lo + cnt,
            axis=-2)
        conj_re = jax.lax.slice_in_dim(
            out_re[..., k * b + i: k * b + i + 1], r0 - r_lo,
            r0 - r_lo + cnt, axis=-2)
        # main_re: rr - ii (lanes >= 1: final re); conj_re: rr + ii (lane 0)
        rr0 = (main_re[..., :1] + conj_re) * 0.5
        ii0 = (conj_re - main_re[..., :1]) * 0.5
        re = main_re * (1.0 - m0) + rr0 * m0
        im = main_im * (1.0 - m0) + ii0 * m0
        results.append(jnp.stack([re, im], axis=-2))     # [..., cnt, 2, B]
    return results


def rdft_block(x: jnp.ndarray, fft_size: int,
               precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Forward packed real DFT of a block zero-padded to ``fft_size``.

    Equivalent to ``copy_and_pad`` + ``Fft::forward``
    (``src/fft_convolver.rs:36-39,56-60``).  Last axis is the transform;
    leading axes batch into one matmul.  ``precision`` defaults to the
    parity-exact HIGHEST; throughput paths (the reverb farm) may opt into
    a lower tier — never change the default, the 1e-6 parity tests
    depend on it.

    The zero pad is FOLDED into the transform instead of materialized:
    padded rows contribute nothing, so the basis (direct) / stage-1
    matrix (4-step) is row-sliced to the live input length — removes a
    whole-input pad pass per call, and halves the first matmul for the
    standard half-length overlap-add blocks."""
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-1] > fft_size:
        raise ValueError(
            f"input length {x.shape[-1]} exceeds fft_size {fft_size}"
        )
    if fft_size <= _DIRECT_MAX:
        hp, od = _mm_mode(precision)
        basis = _opcast(jnp.asarray(
            np.ascontiguousarray(_rdft_basis(fft_size)[: x.shape[-1]])
        ), od)
        packed = jnp.matmul(_opcast(x, od), basis,
                            preferred_element_type=jnp.float32,
                            precision=hp)
        return packed.reshape(x.shape[:-1] + (2, fft_size // 2))
    return _rdft_4step(x, fft_size, precision)


def irdft_block(p: jnp.ndarray, fft_size: int,
                precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Inverse packed real DFT with 1/n normalization, matching
    ``Fft::inverse`` (``src/fft_convolver.rs:41-49``)."""
    if fft_size <= _DIRECT_MAX:
        return _irdft_direct(p, fft_size, precision)
    return _irdft_4step(p, fft_size, precision)


def irdft_pair(p_re: jnp.ndarray, p_im: jnp.ndarray, fft_size: int,
               precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """:func:`irdft_block` taking the two packed planes separately
    (``[..., B]`` each, lanes last).  Planes-outer fused-voice callers
    (the farm tail) index their plane axis instead of transposing to the
    interleaved ``[..., 2, B]`` interface — that transpose was a measured
    full-array re-layout copy per stream call (farm2.py cost mining)."""
    if fft_size <= _DIRECT_MAX:
        return _irdft_direct(jnp.stack([p_re, p_im], axis=-2), fft_size,
                             precision)
    return _irdft_4step_pair(p_re, p_im, fft_size, precision)


def ir_to_spectra(ir_padded: jnp.ndarray, block_size: int, seg_count: int) -> jnp.ndarray:
    """Partition an IR into ``seg_count`` blocks and transform each, zero-
    padded to ``2*block_size`` — one batched matmul replacing the
    reference's per-segment loop (``src/fft_convolver.rs:131-142``).
    Returns packed spectra [seg_count, 2, block_size]."""
    segs = jnp.reshape(jnp.asarray(ir_padded, jnp.float32), (seg_count, block_size))
    return rdft_block(segs, 2 * block_size)


def generate_sinusoid(num_samples: int, freq: float, sample_rate: float, gain: float) -> np.ndarray:
    """Test-signal generator mirroring ``examples/util/mod.rs:7-19`` /
    ``src/tests.rs:9-16`` (computed in float64, cast to float32)."""
    i = np.arange(num_samples, dtype=np.float64)
    return (gain * np.sin(2.0 * np.pi * freq * i / sample_rate)).astype(np.float32)


class Fft:
    """Plan-style convenience wrapper over the packed real DFT — the public
    surface of the reference's ``Fft`` struct (``src/fft_convolver.rs:29-50``:
    ``init``/``forward``/``inverse`` with 1/len-normalized inverse).

    Under XLA there are no plans to own; this class just pins a transform
    length and dispatches to :func:`rdft_block`/:func:`irdft_block`.
    """

    def __init__(self, length: int = 0):
        self.length = 0
        self.init(length)

    def init(self, length: int) -> None:
        """Pin a transform length.  Any even length <= ``_DIRECT_MAX`` plans
        through the direct basis (the basis construction is generic); larger
        lengths must be powers of two for the 4-step split.  Odd lengths are
        a documented divergence from realfft (PARITY.md): the packed
        halfcomplex layout needs a Nyquist bin, and the convolution engines
        only ever transform at ``2 * block_size``."""
        if length:
            if length < 2 or length % 2:
                raise ValueError("transform length must be even and >= 2")
            if length > _DIRECT_MAX and (length & (length - 1)):
                raise ValueError(
                    f"transform lengths > {_DIRECT_MAX} must be powers of two"
                    " (Bailey 4-step path)"
                )
        self.length = length

    def forward(self, x) -> jnp.ndarray:
        """Unnormalized forward transform -> packed [..., 2, length//2]."""
        return rdft_block(jnp.asarray(x, jnp.float32), self.length)

    def inverse(self, packed) -> jnp.ndarray:
        """Inverse transform with 1/len normalization -> [..., length]."""
        return irdft_block(jnp.asarray(packed, jnp.float32), self.length)
