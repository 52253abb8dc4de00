"""Native (C++) host-side kernels, loaded via ctypes with numpy fallback.

The reference's native surface is whisper.cpp/ggml itself; here JAX owns
the compute path, and native code accelerates the host runtime: checkpoint
dequantization (ggml_kernels.cc) and PCM decode. Build happens lazily on
first use (g++ is in the image; see build.py) and every entry point falls
back to the pure-numpy implementation when the toolchain or the .so is
unavailable.
"""

from speaksense_tpu.native.loader import (  # noqa: F401
    native_available,
    dequantize_native,
    pcm16_to_f32_native,
)
