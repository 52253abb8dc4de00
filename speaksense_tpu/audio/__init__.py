"""Audio frontend: ingestion, resampling, DSP (denoise/VAD/quality), and the
log-mel feature extractor feeding the on-device encoder.

Rebuild of /root/reference/src/audio/mod.rs (1,056 LoC of Rust DSP): the
host-side pieces (file parsing, ffmpeg shim, resample, denoise, VAD, quality
metrics) live in numpy/scipy; the log-mel spectrogram — the piece that feeds
the model — runs on-device (jnp matmul formulation, Pallas-fusable).
"""

from speaksense_tpu.audio.mel import (  # noqa: F401
    N_FFT,
    HOP_LENGTH,
    SAMPLE_RATE,
    N_SAMPLES,
    N_FRAMES,
    mel_filter_bank,
    log_mel_spectrogram,
)
