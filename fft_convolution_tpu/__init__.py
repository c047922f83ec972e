"""fft_convolution_tpu — partitioned FFT convolution framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
Sin-tel/fft-convolution Rust crate: real-time-safe uniform and non-uniform
(two-stage) partitioned convolution with artifact-free impulse-response
switching — pure state-transition functions over pytree state,
``lax.scan`` streaming, ``vmap`` channel/IR batching, and ``shard_map``
scale-out over device meshes.

Public surface (mirrors ``trait Convolution``, reference ``src/lib.rs:5-14``):

* :class:`~fft_convolution_tpu.api.Convolution` — the protocol
* :class:`~fft_convolution_tpu.api.FFTConvolver` — uniform partitions
* :class:`~fft_convolution_tpu.models.two_stage` engine — non-uniform head/tail
* :class:`~fft_convolution_tpu.models.crossfade` engine — click-free IR morphing
"""

from .api import Convolution, FFTConvolver

__all__ = [
    "Convolution",
    "FFTConvolver",
    "TwoStageFFTConvolver",
    "CrossfadeConvolver",
    "ShardedFFTConvolver",
    "ShardedTwoStageConvolver",
    "ReverbFarm",
]


def __getattr__(name):
    # lazy imports keep `import fft_convolution_tpu` light
    if name == "TwoStageFFTConvolver":
        from .api_two_stage import TwoStageFFTConvolver
        return TwoStageFFTConvolver
    if name == "CrossfadeConvolver":
        from .api_crossfade import CrossfadeConvolver
        return CrossfadeConvolver
    if name == "ShardedFFTConvolver":
        from .parallel.partition import ShardedFFTConvolver
        return ShardedFFTConvolver
    if name == "ShardedTwoStageConvolver":
        from .parallel.two_stage_sp import ShardedTwoStageConvolver
        return ShardedTwoStageConvolver
    if name == "ReverbFarm":
        from .api_farm import ReverbFarm
        return ReverbFarm
    raise AttributeError(name)
