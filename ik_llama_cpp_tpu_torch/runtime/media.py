"""Media decoding for the multimodal path: PNG images without PIL, other
image formats through PIL where it imports, and WAV audio.

The JAX package decodes every image with PIL (``server/app.py``
``_extract_images``). The port's server may run where PIL is missing, so a
PNG goes through ``decode_png``, a stdlib decoder (zlib and the five row
filters; 8-bit gray, gray + alpha, RGB and RGBA, and palette images of 1,
2, 4 or 8 bits; not interlaced). Any other format is handed to PIL when it
imports, and is otherwise refused with a ``ValueError`` that names it.

``decode_wav`` is the port's copy of the JAX server's: PCM16 WAV to mono
float32 16 kHz samples, raw float32 bytes passed through.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# channels of each colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The filtered scanlines (a filter byte, then ``stride`` bytes each) as
    a (height, stride) uint8 array of the image's bytes."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        base = y * (stride + 1)
        kind = raw[base]
        line = np.frombuffer(raw, np.uint8, stride, base + 1)
        if kind == 0:
            cur = line.copy()
        elif kind == 1:          # Sub: a running sum a channel, modulo 256
            pad = (-stride) % bpp
            cur = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(cur, axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif kind == 2:          # Up
            cur = line + prior
        elif kind in (3, 4):     # Average, Paeth: each byte needs the one before
            x = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = x[i - bpp] if i >= bpp else 0
                if kind == 3:
                    x[i] = (x[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    x[i] = (x[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(x), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's pixels as an (H, W, 3) uint8 RGB array, as PIL's
    ``Image.open(...).convert("RGB")`` gives them (alpha dropped, gray
    repeated, palette entries looked up)."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError("PNG: interlaced images are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: colour type {ctype}")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"PNG: bit depth {depth} of colour type {ctype} is not supported")
    ch = _CHANNELS[ctype]
    stride = (width * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG: truncated image data")
    rows = _unfilter(raw, height, stride, max(1, ch * depth // 8))
    if ctype == 3:
        if plte is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        if depth < 8:
            bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
            weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
            rows = (bits * weights).sum(-1).astype(np.uint8)
        return plte[rows[:, :width]]
    px = rows.reshape(height, width, ch)
    if ch <= 2:                    # gray (+ alpha): the gray value thrice
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes as an (H, W, 3) uint8 RGB array: a PNG by
    ``decode_png``, any other format by PIL where it imports."""
    if data[:8] == PNG_MAGIC:
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"image format {_format_name(data)} needs PIL, which is not "
                         "installed; send a PNG") from None
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _format_name(data: bytes) -> str:
    for magic, name in ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
                        (b"RIFF", "WEBP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF")):
        if data.startswith(magic):
            return name
    return f"(first bytes {data[:8]!r})"


def decode_wav(data: bytes) -> np.ndarray:
    """Base64-decoded WAV bytes -> mono float32 16 kHz samples (the
    input_audio path; reference: miniaudio decode in mtmd-helper). Accepts
    PCM16 WAV; raw f32 little-endian blobs pass through unchanged."""
    import wave
    if data[:4] != b"RIFF":
        return np.frombuffer(data, np.float32).copy()
    with wave.open(io.BytesIO(data)) as w:
        n_ch, width, rate = w.getnchannels(), w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"only PCM16 WAV supported, got sample width {width}")
    samples = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if n_ch > 1:
        samples = samples.reshape(-1, n_ch).mean(axis=1)
    if rate != 16000:
        # linear resample to the whisper preprocessor's fixed 16 kHz
        n_out = int(round(len(samples) * 16000 / rate))
        x_old = np.linspace(0.0, 1.0, len(samples), endpoint=False)
        x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
        samples = np.interp(x_new, x_old, samples).astype(np.float32)
    return samples


def encode_png(rgb: np.ndarray, filters=(1, 2, 3, 4, 0)) -> bytes:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG whose row y carries the
    filter ``filters[y % len(filters)]``: a fixture for the decoder's tests
    and for the server's image requests."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    bpp, out = 3, bytearray()
    prior = np.zeros(w * 3, np.int32)
    for y in range(h):
        cur = rgb[y].reshape(-1).astype(np.int32)
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        out.append(kind)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))
