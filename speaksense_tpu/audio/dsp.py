"""Denoise / gain DSP (host-side, vectorized numpy).

Behavior mirror of /root/reference/src/audio/mod.rs:
- DenoiseConfig defaults (frame 2048, overlap .75, strength .2, gate .003 —
  mod.rs:41-61)
- noise-type classifier by inter-frame spectral variance (:533-578)
- spectral subtraction (:581-623) / Wiener filter (:626-662) / both for mixed
  noise (denoise_audio, :507-530), each Hann-windowed overlap-add (:711-735)
- noise/signal spectrum estimation (:665-708), noise gate (:495-499),
  preemphasis (:261-269), normalize (:408-411), noise floor (:744-762)

Implementation is frame-matrix numpy (sliding_window_view + one batched FFT)
rather than the reference's per-frame rayon loop — the whole 2048-frame
pipeline is a handful of BLAS/FFT calls. This stage stays host-side on
purpose: it runs per ~5 s chunk (tens of microseconds), while the mel+model
path owns the accelerator.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


@dataclass
class DenoiseConfig:
    frame_size: int = 2048
    overlap: float = 0.75
    strength: float = 0.2
    noise_gate: float = 0.003
    enable_noise_reduction: bool = True
    threshold: float = 0.002
    # The reference's overlap-add applies a x10 post gain (mod.rs:731 —
    # "Increase amplification factor"). Kept for behavior parity; set to 1.0
    # for unity-gain denoising.
    post_gain: float = 10.0


class NoiseType(enum.Enum):
    STATIONARY = "stationary"
    NON_STATIONARY = "non_stationary"
    MIXED = "mixed"


def _hann(n: int) -> np.ndarray:
    # reference hann_window uses the symmetric (size-1) denominator (mod.rs:501-503)
    i = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)


def _frames(x: np.ndarray, frame: int, step: int) -> np.ndarray:
    """Strided overlapping frames (num_frames, frame); empty-safe."""
    if x.size < frame:
        return np.zeros((0, frame), np.float32)
    return np.lib.stride_tricks.sliding_window_view(x, frame)[::step]


def preemphasis(x: np.ndarray, coefficient: float = 0.97) -> np.ndarray:
    if x.size == 0:
        return x.astype(np.float32)
    out = np.empty_like(x, np.float32)
    out[0] = x[0]
    out[1:] = x[1:] - coefficient * x[:-1]
    return out


def normalize_audio(x: np.ndarray) -> np.ndarray:
    peak = np.abs(x).max() if x.size else 1.0
    if peak == 0:
        return x.astype(np.float32)
    return (x / peak).astype(np.float32)


def convert_to_mono(x: np.ndarray, num_channels: int) -> np.ndarray:
    if num_channels <= 1:
        return np.asarray(x, np.float32)
    n = (x.size // num_channels) * num_channels
    return x[:n].reshape(-1, num_channels).mean(axis=1).astype(np.float32)


def apply_noise_gate(x: np.ndarray, gate: float) -> np.ndarray:
    return np.where(np.abs(x) < gate, 0.0, x).astype(np.float32)


def estimate_noise_floor(x: np.ndarray, frame_size: int = 1024) -> float:
    """Mean energy of the quietest 10% of frames (mod.rs:744-762)."""
    if x.size == 0:
        return 0.0
    n_full = x.size // frame_size
    energies = []
    if n_full:
        energies.extend((x[: n_full * frame_size].reshape(-1, frame_size) ** 2).mean(axis=1))
    rem = x[n_full * frame_size :]
    if rem.size:
        energies.append(float((rem**2).mean()))
    energies = np.sort(np.asarray(energies))
    k = max(1, int(len(energies) * 0.1))
    return float(energies[:k].mean())


def _power_frames(x: np.ndarray, frame_size: int, window: np.ndarray) -> np.ndarray:
    """Power spectra of consecutive non-overlapping full frames, full-bin
    layout (frame_size bins, like the reference's complex FFT)."""
    n = x.size // frame_size
    if n == 0:
        return np.zeros((0, frame_size), np.float32)
    fr = x[: n * frame_size].reshape(n, frame_size) * window[None, :]
    spec = np.fft.fft(fr, axis=1)
    return (spec.real**2 + spec.imag**2).astype(np.float32)


def analyze_noise_characteristics(x: np.ndarray, frame_size: int) -> NoiseType:
    """Inter-frame power-spectrum variance classifier (mod.rs:533-578)."""
    window = _hann(frame_size)
    ps = _power_frames(x, frame_size, window)
    if ps.shape[0] < 2:
        return NoiseType.STATIONARY
    diffs = ((ps[1:] - ps[:-1]) ** 2).sum(axis=1) / frame_size
    normalized = diffs.sum() / max(x.size, 1)
    if normalized < 0.1:
        return NoiseType.STATIONARY
    if normalized > 0.5:
        return NoiseType.NON_STATIONARY
    return NoiseType.MIXED


def estimate_noise_spectrum(x: np.ndarray, frame_size: int, num_frames: int = 20) -> np.ndarray:
    """Mean power over the first `num_frames` frames (mod.rs:665-686). Keeps
    the reference's /num_frames normalization even when fewer frames exist."""
    window = _hann(frame_size)
    ps = _power_frames(x, frame_size, window)[:num_frames]
    if ps.shape[0] == 0:
        return np.zeros((frame_size,), np.float32)
    return ps.sum(axis=0) / num_frames


def estimate_signal_spectrum(x: np.ndarray, frame_size: int) -> np.ndarray:
    window = _hann(frame_size)
    ps = _power_frames(x, frame_size, window)
    if ps.shape[0] == 0:
        return np.zeros((frame_size,), np.float32)
    return ps.mean(axis=0)


def _overlap_add(frames_td: np.ndarray, out_len: int, step: int, window: np.ndarray,
                 post_gain: float) -> np.ndarray:
    """Windowed overlap-add with window^2 normalization (mod.rs:711-735)."""
    out = np.zeros((out_len,), np.float32)
    norm = np.zeros((out_len,), np.float32)
    frame_size = frames_td.shape[1]
    w2 = window * window
    for i in range(frames_td.shape[0]):
        start = i * step
        end = min(start + frame_size, out_len)
        span = end - start
        if span <= 0:
            break
        out[start:end] += frames_td[i, :span] * window[:span]
        norm[start:end] += w2[:span]
    # Floor the normalizer: near stream edges only a window tail covers a
    # sample, and spectral gains spread energy into regions where w ~ 0 —
    # dividing by ~0 amplifies that leakage unboundedly (the reference's OLA
    # has this defect; SURVEY.md §7 sanctions fixing it). Interior samples at
    # 75% overlap have norm ~ 1.5 and are unaffected.
    out = out / np.maximum(norm, 0.5) * post_gain
    return out


def spectral_subtraction(x: np.ndarray, frame_size: int, overlap: float,
                         strength: float, post_gain: float = 10.0) -> np.ndarray:
    """Frequency-dependent gentle spectral subtraction (mod.rs:581-623)."""
    step = max(1, int(frame_size * (1.0 - overlap)))
    window = _hann(frame_size)
    fr = _frames(x, frame_size, step)
    if fr.shape[0] == 0:
        return np.asarray(x, np.float32)
    noise = estimate_noise_spectrum(x, frame_size)
    spec = np.fft.fft(fr * window[None, :], axis=1)
    power = (spec.real**2 + spec.imag**2).astype(np.float32)
    alpha, beta = 1.0, 0.1
    freq_factor = np.minimum(np.arange(frame_size, dtype=np.float32) / frame_size, 1.0)
    freq_strength = strength * (1.0 - 0.3 * freq_factor)
    ratio = noise[None, :] / (power + 1e-6)
    gain = np.sqrt(np.maximum(1.0 - alpha * np.power(ratio, freq_strength[None, :]), beta))
    td = np.fft.ifft(spec * gain, axis=1).real.astype(np.float32)
    # NOTE: the reference feeds rustfft's UNNORMALIZED inverse into OLA, so its
    # output carries an extra xframe_size scale (masked downstream by the
    # log-mel max normalization). We synthesize at unity gain — same audible
    # content, sane amplitudes (SURVEY.md §7 "replicate the contract, fix the
    # bug").
    return _overlap_add(td, x.size, step, window, post_gain)


def wiener_filter(x: np.ndarray, frame_size: int, overlap: float, strength: float,
                  post_gain: float = 10.0) -> np.ndarray:
    """Power-ratio Wiener gain (mod.rs:626-662)."""
    step = max(1, int(frame_size * (1.0 - overlap)))
    window = _hann(frame_size)
    fr = _frames(x, frame_size, step)
    if fr.shape[0] == 0:
        return np.asarray(x, np.float32)
    noise = estimate_noise_spectrum(x, frame_size)
    signal = estimate_signal_spectrum(x, frame_size)
    snr = signal / (noise + 1e-6)
    gain = np.power(snr / (1.0 + snr), strength * 0.7).astype(np.float32)
    spec = np.fft.fft(fr * window[None, :], axis=1)
    td = np.fft.ifft(spec * gain[None, :], axis=1).real.astype(np.float32)
    return _overlap_add(td, x.size, step, window, post_gain)


def denoise_audio(x: np.ndarray, config: DenoiseConfig | None = None) -> np.ndarray:
    """Route by noise type (mod.rs:507-530): stationary -> spectral
    subtraction, non-stationary -> Wiener, mixed -> both in sequence."""
    config = config or DenoiseConfig()
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x
    kind = analyze_noise_characteristics(x, config.frame_size)
    if kind is NoiseType.STATIONARY:
        return spectral_subtraction(x, config.frame_size, config.overlap,
                                    config.strength, config.post_gain)
    if kind is NoiseType.NON_STATIONARY:
        return wiener_filter(x, config.frame_size, config.overlap,
                             config.strength, config.post_gain)
    y = spectral_subtraction(x, config.frame_size, config.overlap,
                             config.strength, config.post_gain)
    return wiener_filter(y, config.frame_size, config.overlap,
                         config.strength, config.post_gain)


# ---------------------------------------------------------------------------
# JAX (on-device) denoise — jit-composable mirror of denoise_audio
# ---------------------------------------------------------------------------
# Rationale: host-side denoise cost about a third of serving throughput at
# 64 streams in an earlier measurement; the FFT work is trivial next to the
# encoder, so the device runs it inside the admission
# program (audio -> denoise -> log-mel -> encode in ONE dispatch). Semantics
# mirror the numpy path (same classifier/gains/OLA, f32/complex64); all
# branches are computed and the per-input branch is selected with
# jnp.where, which is the jit-able form of the host path's if/elif.

def _denoise_jax_single(x, frame_size: int, overlap: float, strength: float,
                        post_gain: float, branch: str | None = None):
    import jax.numpy as jnp

    n = x.shape[0]
    if n < frame_size:  # too short to frame (numpy path returns input)
        return x
    window = jnp.asarray(_hann(frame_size))
    step = max(1, int(frame_size * (1.0 - overlap)))

    def power_frames(sig):
        nf = n // frame_size
        fr = sig[: nf * frame_size].reshape(nf, frame_size) * window[None, :]
        spec = jnp.fft.fft(fr, axis=1)
        return (spec.real**2 + spec.imag**2).astype(jnp.float32)

    def classify(sig):
        ps = power_frames(sig)
        diffs = ((ps[1:] - ps[:-1]) ** 2).sum(axis=1) / frame_size
        return diffs.sum() / max(n, 1)  # normalized variance scalar

    def noise_spectrum(sig, num_frames: int = 20):
        ps = power_frames(sig)[:num_frames]
        return ps.sum(axis=0) / num_frames

    def frames(sig):
        nf = (n - frame_size) // step + 1
        idx = jnp.arange(nf)[:, None] * step + jnp.arange(frame_size)[None, :]
        return sig[idx]

    def overlap_add(td):
        nf = td.shape[0]
        idx = jnp.arange(nf)[:, None] * step + jnp.arange(frame_size)[None, :]
        contrib = td * window[None, :]
        out = jnp.zeros((n + frame_size,), jnp.float32).at[idx].add(contrib)[:n]
        norm = jnp.zeros((n + frame_size,), jnp.float32).at[idx].add(
            jnp.broadcast_to(window * window, td.shape))[:n]
        return out / jnp.maximum(norm, 0.5) * post_gain

    def spectral(sig):
        fr = frames(sig)
        noise = noise_spectrum(sig)
        spec = jnp.fft.fft(fr * window[None, :], axis=1)
        power = (spec.real**2 + spec.imag**2).astype(jnp.float32)
        alpha, beta = 1.0, 0.1
        freq_factor = jnp.minimum(
            jnp.arange(frame_size, dtype=jnp.float32) / frame_size, 1.0)
        freq_strength = strength * (1.0 - 0.3 * freq_factor)
        ratio = noise[None, :] / (power + 1e-6)
        gain = jnp.sqrt(jnp.maximum(
            1.0 - alpha * jnp.power(ratio, freq_strength[None, :]), beta))
        td = jnp.fft.ifft(spec * gain, axis=1).real.astype(jnp.float32)
        return overlap_add(td)

    def wiener(sig):
        fr = frames(sig)
        noise = noise_spectrum(sig)
        signal = power_frames(sig).mean(axis=0)
        snr = signal / (noise + 1e-6)
        gain = jnp.power(snr / (1.0 + snr), strength * 0.7).astype(jnp.float32)
        spec = jnp.fft.fft(fr * window[None, :], axis=1)
        td = jnp.fft.ifft(spec * gain[None, :], axis=1).real.astype(jnp.float32)
        return overlap_add(td)

    # branch pinned statically (host-side classifier, see classify_noise):
    # the program computes ONE denoise path instead of all three, which
    # cost serving throughput in an earlier measurement
    if branch == "spectral":
        return spectral(x)
    if branch == "wiener":
        return wiener(x)
    if branch == "mixed":
        return wiener(spectral(x))
    v = classify(x)
    y_s = spectral(x)
    y_w = wiener(x)
    y_m = wiener(y_s)
    # mod.rs:507-530 routing: <0.1 stationary, >0.5 non-stationary, else both
    return jnp.where(v < 0.1, y_s, jnp.where(v > 0.5, y_w, y_m))


def classify_noise(x: np.ndarray, frame_size: int = 2048) -> str:
    """Host-side branch pick for the device denoise (numpy classifier,
    ~1-2 ms for a 5 s chunk): returns the _denoise_jax_single branch name."""
    kind = analyze_noise_characteristics(np.asarray(x, np.float32), frame_size)
    return {NoiseType.STATIONARY: "spectral",
            NoiseType.NON_STATIONARY: "wiener",
            NoiseType.MIXED: "mixed"}[kind]


def denoise_audio_jax(x, config: DenoiseConfig | None = None,
                      branch: str | None = None):
    """Device-side denoise: x (n,) or (B, n) f32 -> same shape. Matches
    denoise_audio's routing/gains; compose inside jit (slot admission).
    branch ('spectral'|'wiener'|'mixed', from classify_noise) pins the DSP
    path statically so only one branch is computed; None selects on
    device (computes all three)."""
    import jax
    import jax.numpy as jnp

    config = config or DenoiseConfig()
    x = jnp.asarray(x, jnp.float32)
    single = lambda row: _denoise_jax_single(
        row, config.frame_size, config.overlap, config.strength,
        config.post_gain, branch=branch)
    if x.ndim == 1:
        return single(x)
    return jax.vmap(single)(x)
