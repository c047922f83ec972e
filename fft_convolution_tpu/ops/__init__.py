"""FFT + DSP primitives (the reference's L0 layer,
``src/fft_convolver.rs:8-84``).

Public L0 surface (mirroring the reference's ``pub`` items):
``Fft``, ``complex_size``, ``copy_and_pad`` (src/fft_convolver.rs:29-60),
``pmul``/``pmul_sum`` (the packed counterparts of
``complex_multiply_accumulate``, :62-74).
"""

from .cpx import pmul, pmul_sum
from .fft import (
    Fft,
    causal_conv_khat,
    causal_conv_time,
    complex_size,
    copy_and_pad,
    irdft_block,
    next_power_of_two,
    rdft_block,
)

__all__ = [
    "Fft", "causal_conv_khat", "causal_conv_time", "complex_size",
    "copy_and_pad", "irdft_block", "next_power_of_two", "rdft_block",
    "pmul", "pmul_sum",
]
