"""Log-mel spectrogram, formulated for the accelerator.

Replaces the mel frontend of whisper.cpp (the reference consumes it via
`state.full` — /root/reference/src/asr/whisper.rs:75 — and whisper.cpp computes
the mel internally on CPU threads). Here the STFT is expressed as
frame-gather + two matmuls (window ⊙ frames) @ [cos|sin] DFT basis so XLA maps
it onto matrix products; the mel projection and log/clamp fuse behind it.
A hand-written Pallas mel kernel was tried and removed — it never beat the
fused XLA path at any production shape.

Conventions (identical to openai/whisper & whisper.cpp):
  sample rate 16 kHz, n_fft 400, hop 160, periodic Hann window, reflect
  padding, power spectrum of the first 3000 frames per 30 s window, Slaney
  mel filterbank (80 or 128 bins), log10 clamped at 1e-10, dynamic-range
  clamp to (max - 8.0), scaled (x + 4) / 4.
Output layout is time-major (B, n_frames, n_mels) — channels-last feeds the
encoder conv stem without a transpose.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    """Slaney-scale Hz→mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = freq / f_sp
    return np.where(freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = f_sp * mel
    return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(n_mels: int, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1).

    Numerically matches librosa.filters.mel(norm="slaney", htk=False), which is
    what openai/whisper ships as precomputed filters and what whisper.cpp reads
    from the ggml file header. ggml-loaded filters (ckpt/ggml.py) take
    precedence when available; this function covers HF/synthetic checkpoints.
    """
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_basis(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis: returns (cos, sin) each (n_fft, n_fft//2+1),
    already multiplied by the periodic Hann window so the STFT is exactly
    frames @ basis."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def _frame_indices(num_frames: int, n_fft: int = N_FFT, hop: int = HOP_LENGTH) -> np.ndarray:
    starts = np.arange(num_frames) * hop
    return starts[:, None] + np.arange(n_fft)[None, :]


@functools.partial(jax.jit, static_argnames=("n_mels", "num_frames"))
def _log_mel_jit(audio: jax.Array, filters: jax.Array, n_mels: int, num_frames: int) -> jax.Array:
    # audio: (B, n_samples). Reflect-pad n_fft//2 on both sides (torch.stft center=True).
    pad = N_FFT // 2
    x = jnp.pad(audio, ((0, 0), (pad, pad)), mode="reflect")
    idx = jnp.asarray(_frame_indices(num_frames))
    frames = x[:, idx]  # (B, num_frames, n_fft) — gather; XLA fuses this
    cos_b, sin_b = _dft_basis()
    cos_b, sin_b = jnp.asarray(cos_b), jnp.asarray(sin_b)
    # HIGHEST precision: f32 matmuls otherwise may run in TF32 (GPU) or
    # bf16 passes; the log10 feature domain needs true f32 (these matmuls
    # are a negligible fraction of total FLOPs).
    hi = jax.lax.Precision.HIGHEST
    re = jnp.einsum("btf,fk->btk", frames, cos_b, precision=hi, preferred_element_type=jnp.float32)
    im = jnp.einsum("btf,fk->btk", frames, sin_b, precision=hi, preferred_element_type=jnp.float32)
    power = re * re + im * im  # (B, T, n_freqs)
    mel = jnp.einsum("btk,mk->btm", power, filters, precision=hi, preferred_element_type=jnp.float32)
    log_spec = jnp.log10(jnp.maximum(mel, 1e-10))
    max_val = jnp.max(log_spec, axis=(1, 2), keepdims=True)
    log_spec = jnp.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(
    audio: np.ndarray | jax.Array,
    n_mels: int = 80,
    filters: np.ndarray | None = None,
    pad_to_chunk: bool = True,
) -> jax.Array:
    """Compute (B, n_frames, n_mels) log-mel features.

    audio: float32 PCM at 16 kHz, shape (n,) or (B, n). When pad_to_chunk,
    audio is zero-padded to a whole 30 s window (reference feeds whisper.cpp
    fixed 30 s windows — /root/reference/src/schedule/processors/transcribe.rs:105).
    """
    a = jnp.asarray(audio, dtype=jnp.float32)
    if a.ndim == 1:
        a = a[None, :]
    n = a.shape[-1]
    if pad_to_chunk:
        target = ((max(n, 1) + N_SAMPLES - 1) // N_SAMPLES) * N_SAMPLES
        if target != n:
            a = jnp.pad(a, ((0, 0), (0, target - n)))
        n = target
    num_frames = n // HOP_LENGTH
    if filters is None:
        filters = mel_filter_bank(n_mels)
    return _log_mel_jit(a, jnp.asarray(filters), n_mels, num_frames)
