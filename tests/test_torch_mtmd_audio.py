"""The port's copy of the whisper preprocessor (runtime/mtmd_audio.py)
against the JAX package's on the CPU: the slaney mel filterbank, the
log-mel spectrogram and the 3,000-frame chunks, bit for bit (both are the
same numpy arithmetic)."""
import numpy as np
import pytest

from ik_llama_cpp_tpu.runtime import mtmd_audio as JA
from ik_llama_cpp_tpu_torch.runtime import mtmd_audio as TA


def _samples(seconds: float, seed: int = 0) -> np.ndarray:
    """Two tones and a little noise at 16 kHz."""
    t = np.arange(int(16000 * seconds), dtype=np.float32) / 16000
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234 * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("n_mels,n_fft", [(128, 400), (80, 400), (64, 512)])
def test_mel_filters_bit_for_bit(n_mels, n_fft):
    a = JA.mel_filters(n_mels, n_fft)
    b = TA.mel_filters(n_mels, n_fft)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("seconds", [0.02, 1.0, 7.3])
def test_log_mel_bit_for_bit(seconds):
    s = _samples(seconds, seed=int(seconds * 10))
    a, b = JA.log_mel_spectrogram(s), TA.log_mel_spectrogram(s)
    assert a.shape == b.shape == (JA.N_MEL, a.shape[1])
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seconds,n_chunks", [(0.5, 1), (29.5, 1), (30.0, 2), (31.0, 2)])
def test_chunks_bit_for_bit(seconds, n_chunks):
    """3,000-frame chunks, the trailing partial one dropped: 30 s of audio
    or more makes a second chunk of the 30 s of padding."""
    s = _samples(seconds, seed=3)
    a, b = JA.preprocess_audio(s), TA.preprocess_audio(s)
    assert len(a) == len(b) == n_chunks
    assert all(x.shape == (128, TA.CHUNK_FRAMES) and np.array_equal(x, y) for x, y in zip(a, b))
