"""Crossfader: sample-accurate equal-power fade state machine.

JAX re-design of ``Crossfader`` + mixers
(``src/crossfade_convolver.rs:126-279``).  The reference advances the state
machine one sample at a time; a per-sample Python/device loop would be the
worst possible device program, so the whole block is evaluated in closed
form: given the state at block start, every sample's phase (hold / ramp /
snapped / reached) and mix value are pure functions of the sample index,
computed as one vectorized ``where`` cascade.

Semantics reproduced exactly (quirks included):

* ``fade_into`` flips the sign of ``mix_value_step`` each fade
  (``:216-240``), so mix_value ramps 0 -> -1 -> 0 -> ... — the raised-cosine
  gain ``cos^2(pi/2 * v)`` is even, so the fade is still monotone;
* hold phase: while ``counter <= 0`` the OLD side is output unchanged
  (``:251-257``) — this covers the new convolver's pipeline fill;
* exact endpoint snap when ``counter == fading_samples`` (``:261-273``):
  state becomes ``Reached`` and ``mix_value`` snaps to 0/1;
* ``Reached`` passes the target through untouched (``:244-247``).

Mixers: the active one is ``RaisedCosineMixer`` (``:162-169``,
amplitude-complementary, gains sum to 1); Linear / SquareRoot / Cosine exist
upstream as dead code (``:130-158``) and are provided here as selectable
alternatives.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

# Target encoding: 0 = A, 1 = B (``Target`` enum, src/crossfade_convolver.rs:171-175)
TARGET_A = 0
TARGET_B = 1


def raised_cosine_gain(v: jnp.ndarray) -> jnp.ndarray:
    """gain1 = cos^2(pi/2 * v); gain2 = 1 - gain1 (``:162-169``)."""
    c = jnp.cos((np.pi / 2.0) * v)
    return c * c


def linear_gain(v: jnp.ndarray) -> jnp.ndarray:
    """gain1 = 1 - v (``LinearMixer``, ``:130-136``)."""
    return 1.0 - v


def square_root_gain(v: jnp.ndarray) -> jnp.ndarray:
    """gain1 = sqrt(1 - v) — NOT complementary: gain2 = sqrt(v)
    (``SquareRootMixer``, ``:138-146``); handled specially in mix."""
    return jnp.sqrt(jnp.maximum(1.0 - v, 0.0))


def cosine_gain(v: jnp.ndarray) -> jnp.ndarray:
    """gain1 = cos(pi/2 v), gain2 = sin(pi/2 v) (``CosineMixer``, ``:149-158``)."""
    return jnp.cos((np.pi / 2.0) * v)


_COMPLEMENTARY = {"raised_cosine": True, "linear": True, "sqrt": False, "cosine": False}
_GAIN_FNS = {
    "raised_cosine": raised_cosine_gain,
    "linear": linear_gain,
    "sqrt": square_root_gain,
    "cosine": cosine_gain,
}


def _gain2(mixer: str, v: jnp.ndarray, g1: jnp.ndarray) -> jnp.ndarray:
    if _COMPLEMENTARY[mixer]:
        return 1.0 - g1
    if mixer == "sqrt":
        return jnp.sqrt(jnp.maximum(v, 0.0))
    return jnp.sin((np.pi / 2.0) * v)


@dataclasses.dataclass(frozen=True)
class CrossfaderConfig:
    fading_samples: int   # ``:195`` (as i64 upstream)
    hold_samples: int     # ``:196``
    mixer: str = "raised_cosine"

    def __post_init__(self):
        # The reference accepts fading_samples == 0 because Rust f32 1.0/0 is
        # inf; here it would be a ZeroDivisionError in new_state.  Clamp to 1:
        # a zero-length fade becomes an instant (1-sample) switch.
        if self.fading_samples < 1:
            object.__setattr__(self, "fading_samples", 1)


class CrossfaderState(NamedTuple):
    """``Crossfader`` runtime fields (``src/crossfade_convolver.rs:192-201``)."""

    target: jnp.ndarray       # i32 [] 0=A 1=B
    approaching: jnp.ndarray  # bool [] (FadingState::Approaching vs Reached)
    counter: jnp.ndarray      # i32 []
    mix_value: jnp.ndarray    # f32 []
    step: jnp.ndarray         # f32 [] mix_value_step (sign flips per fade)


def new_state(cfg: CrossfaderConfig) -> CrossfaderState:
    """``Crossfader::new`` (``:203-214``): Reached(A), step = 1/fading."""
    return CrossfaderState(
        target=jnp.asarray(TARGET_A, jnp.int32),
        approaching=jnp.asarray(False),
        counter=jnp.zeros((), jnp.int32),
        mix_value=jnp.zeros((), jnp.float32),
        step=jnp.asarray(1.0 / cfg.fading_samples, jnp.float32),
    )


def fade_into(cfg: CrossfaderConfig, st: CrossfaderState, target: int) -> CrossfaderState:
    """``Crossfader::fade_into`` (``:216-240``), pure-functional.

    Host-side orchestration (runs between blocks) so plain jnp ops on
    concrete scalars are fine; no jit needed.
    """
    if int(st.target) == target:
        return st
    if not bool(st.approaching):
        # Reached -> start hold then ramp (:223-227)
        return st._replace(
            target=jnp.asarray(target, jnp.int32),
            approaching=jnp.asarray(True),
            counter=jnp.asarray(-cfg.hold_samples, jnp.int32),
            step=-st.step,
        )
    if int(st.counter) >= 0:
        # mid-ramp reversal (:231-234)
        return st._replace(
            target=jnp.asarray(target, jnp.int32),
            counter=jnp.asarray(cfg.fading_samples, jnp.int32) - st.counter,
            step=-st.step,
        )
    # reversal during hold: instantly Reached(new target) (:235-237)
    return st._replace(
        target=jnp.asarray(target, jnp.int32),
        approaching=jnp.asarray(False),
    )


def mix_block(cfg: CrossfaderConfig, st: CrossfaderState,
              a: jnp.ndarray, b: jnp.ndarray) -> Tuple[CrossfaderState, jnp.ndarray]:
    """Vectorized ``Crossfader::mix`` over a block (``:242-278``).

    Per-sample recurrence unrolled in closed form: with entry counter c0,
    sample i (0-based) sees counter ``c_i = c0 + i + 1`` and mix value
    ``v_i = v0 + step * max(0, c_i) - step * max(0, c0)`` (increments only
    happen while ``c > 0``).  Phases:

    * Reached: pass-through of the target (:244-247)
    * hold (``c_i <= 0``): output the OLD side (:251-257)
    * snap (``c_i >= fading``): output the target exactly (:261-273)
    * ramp: mixer gains at ``v_i`` (:275)

    ``step = 1/fading_samples`` is exact in binary for pow2 fade lengths, so
    the closed form is bit-identical to the reference's repeated addition in
    the common case (and strictly better conditioned otherwise).
    """
    n = a.shape[0]
    i = jnp.arange(n, dtype=jnp.int32)
    fading = jnp.asarray(cfg.fading_samples, jnp.int32)

    is_b = st.target == TARGET_B
    new_side = jnp.where(is_b, b, a)
    old_side = jnp.where(is_b, a, b)

    c = st.counter + i + 1
    inc = jnp.maximum(0, c) - jnp.maximum(0, st.counter)
    v = st.mix_value + st.step * inc.astype(jnp.float32)

    g1 = _GAIN_FNS[cfg.mixer](v)
    g2 = _gain2(cfg.mixer, v, g1)
    ramped = a * g1 + b * g2

    approaching_out = jnp.where(
        c <= 0, old_side, jnp.where(c >= fading, new_side, ramped)
    )
    reached_out = new_side
    y = jnp.where(st.approaching, approaching_out, reached_out)

    # end-of-block state (:259-273): counter stops at fading; mix snaps
    c_end = st.counter + n
    reached_now = st.approaching & (c_end >= fading)
    inc_end = jnp.maximum(0, jnp.minimum(c_end, fading)) - jnp.maximum(0, st.counter)
    v_end = st.mix_value + st.step * inc_end.astype(jnp.float32)
    endpoint = jnp.where(is_b, 1.0, 0.0).astype(jnp.float32)
    new_state_ = CrossfaderState(
        target=st.target,
        approaching=st.approaching & ~reached_now,
        counter=jnp.where(
            st.approaching, jnp.minimum(c_end, fading), st.counter
        ).astype(jnp.int32),
        mix_value=jnp.where(
            reached_now, endpoint, jnp.where(st.approaching, v_end, st.mix_value)
        ).astype(jnp.float32),
        step=st.step,
    )
    return new_state_, y
