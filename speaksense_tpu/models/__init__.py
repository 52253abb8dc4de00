"""Model zoo: JAX Whisper encoder/decoder families.

Replaces the reference's L0 native inference engine (whisper.cpp behind the
whisper-rs FFI — SURVEY.md §1 L0, /root/reference/src/asr/whisper.rs) with a
JAX implementation: stacked-layer `lax.scan` transformer blocks, bf16
matmuls with f32 normalization/softmax, per-slot KV caches shaped for
continuous batching, and sharding-annotatable parameter pytrees.
"""

from speaksense_tpu.models.whisper import (  # noqa: F401
    WhisperDims,
    MODEL_DIMS,
    init_params,
    encode,
    decode_prefill,
    decode_step,
    init_cache,
)
