"""Whisper-style audio preprocessing — the analogue of
examples/mtmd/mtmd-audio.cpp (whisper_preprocessor).

The port's own copy of the JAX package's ``runtime/mtmd_audio.py`` (numpy
only, the same bits):

  * 16 kHz mono samples -> log-mel spectrogram: periodic Hann window 400,
    hop 160, |FFT|^2, 128-bin slaney mel filterbank (the reference embeds
    the same filterbank precomputed at x1000 scale — get_128_bins),
    log10 clamp 1e-10, (max-8) floor, (x+4)/4 normalization
  * reflective 200-sample pad at both ends + 30 s of zero padding at the
    end, then split into 3000-frame chunks (the clip audio graph's fixed
    input length); the trailing incomplete chunk is dropped
"""
from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MEL = 128
CHUNK_FRAMES = 3000


def mel_filters(n_mels: int = N_MEL, n_fft: int = N_FFT,
                sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized mel filterbank — identical to the reference's
    whisper_precalc_filters::get_128_bins (its table stores x1000 values
    and divides back at load; verified entry-by-entry)."""
    fmin, fmax = 0.0, sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, float)
        lin = f / (200.0 / 3)
        logstep = np.log(6.4) / 27.0
        return np.where(f >= 1000.0,
                        (1000.0 / (200.0 / 3)) + np.log(
                            np.maximum(f, 1e-10) / 1000.0) / logstep, lin)

    def mel_to_hz(m):
        m = np.asarray(m, float)
        lin = (200.0 / 3) * m
        logstep = np.log(6.4) / 27.0
        brk = 1000.0 / (200.0 / 3)
        return np.where(m >= brk, 1000.0 * np.exp(logstep * (m - brk)), lin)

    mels = np.linspace(float(hz_to_mel(fmin)), float(hz_to_mel(fmax)),
                       n_mels + 2)
    hz = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    w = np.zeros((n_mels, len(fft_freqs)), np.float64)
    for m in range(n_mels):
        lower = (fft_freqs - hz[m]) / (hz[m + 1] - hz[m])
        upper = (hz[m + 2] - fft_freqs) / (hz[m + 2] - hz[m + 1])
        w[m] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz[2:n_mels + 2] - hz[:n_mels])
    w *= enorm[:, None]
    return w.astype(np.float32)


_FILTERS: np.ndarray | None = None


def log_mel_spectrogram(samples: np.ndarray) -> np.ndarray:
    """samples: float32 16 kHz mono -> (n_mel, n_len) normalized log-mel
    (log_mel_spectrogram, mtmd-audio.cpp:196-279)."""
    global _FILTERS
    if _FILTERS is None:
        _FILTERS = mel_filters()
    samples = np.asarray(samples, np.float32)
    n = len(samples)
    pad_side = N_FFT // 2
    pad_end = SAMPLE_RATE * 30
    padded = np.concatenate([
        samples[1:1 + pad_side][::-1],                     # reflect front
        samples,
        np.zeros(pad_end + pad_side, np.float32),          # 30 s + tail pad
    ])
    n_len = (len(padded) - N_FFT) // HOP
    # periodic hann
    hann = (0.5 * (1 - np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT))
            ).astype(np.float32)
    # frames limited like the reference: i < n_samples/hop + 1
    n_active = min(n // HOP + 1 + pad_side // HOP + 1, n_len)
    idx = np.arange(n_active)[:, None] * HOP + np.arange(N_FFT)[None, :]
    frames = padded[idx] * hann
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2        # (T, 201)
    mel = spec @ _FILTERS.T                                  # (T, 128)
    logmel = np.log10(np.maximum(mel, 1e-10)).T              # (128, T)
    out = np.full((N_MEL, n_len), np.log10(1e-10), np.float32)
    out[:, :n_active] = logmel
    mmax = out.max() - 8.0
    out = np.maximum(out, mmax)
    return ((out + 4.0) / 4.0).astype(np.float32)


def preprocess_audio(samples: np.ndarray) -> list[np.ndarray]:
    """Full-length mel split into 3000-frame chunks
    (preprocess_audio, mtmd-audio.cpp:281-330)."""
    mel = log_mel_spectrogram(samples)
    chunks = []
    for off in range(0, mel.shape[1], CHUNK_FRAMES):
        if mel.shape[1] - off < CHUNK_FRAMES:
            break      # trailing incomplete chunk is always padding
        chunks.append(mel[:, off:off + CHUNK_FRAMES])
    return chunks
