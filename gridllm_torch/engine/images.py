"""Host-side image preprocessing for the vision models (the CLIP pipeline).

The counterpart of the JAX package's engine/images.py, which runs HF
CLIPImageProcessor's llava-1.5 steps through PIL: RGB, a shortest-edge
bicubic resize to `image_size` (the long side truncated, as transformers
computes it), a center crop, × 1/255, and normalization by the CLIP mean
and standard deviation. The card's machine has no PIL, so this module does
the two steps PIL did for PNG itself:

- `decode_png`: the chunks (CRC-checked), zlib, the five row filters (None,
  Sub, Up, Average, Paeth; reconstructed along anti-diagonals, so every
  step is one vectorized operation over the pixels that depend only on
  finished ones), bit depths 1, 2 and 4 (gray, palette) and 8 (every color
  type), then PIL's convert("RGB"): gray replicated, alpha dropped, palette
  looked up. Interlaced (Adam7) and 16-bit images are refused with an
  error that names them.
- `resize_bicubic`: PIL's `Image.resize(..., BICUBIC)` on 8-bit RGB: the
  cubic kernel with a = -0.5, its support widened by the downscale factor,
  coefficients normalized and fixed to 22 fractional bits, a horizontal
  pass then a vertical pass, each rounded to 8 bits. Bit-equal to PIL's.

Any other format (JPEG, WebP, ...) is decoded through PIL where PIL is
importable; where it is not, `ImageError` (a ValueError: the engine fails
the request non-retryably) names the format.
"""

from __future__ import annotations

import base64
import io
import struct
import zlib

import numpy as np

# CLIP normalization constants (OPENAI_CLIP_MEAN/STD)
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type → (channels, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)), 4: (2, (8,)),
              6: (4, (8,))}
_PNG_TYPE_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
# fixed-point fraction bits of PIL's 8-bit resampling coefficients
_PRECISION_BITS = 32 - 8 - 2


class ImageError(ValueError):
    """An image payload this module cannot turn into pixels."""


def _format_name(raw: bytes) -> str:
    for magic, name in ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
                        (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF")):
        if raw.startswith(magic):
            return name
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WebP"
    return "unrecognized"


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _unfilter(filtered: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct PNG scanlines: filtered [H, stride] bytes, kinds [H] the
    filter type of each row, bpp the bytes of one pixel (at least 1).
    Byte (r, i) depends on (r, i - bpp), (r - 1, i) and (r - 1, i - bpp):
    with pixel columns p = i // bpp, every (r, p) on one anti-diagonal
    r + p = d depends only on earlier diagonals, so each diagonal is one
    vectorized step over its pixels and their bpp bytes. In the row-major
    layout padded with a zero row above and a zero pixel left (the
    filters' missing neighbours are 0), a diagonal's pixels lie n_px apart:
    each step reads and writes strided views, with no gather."""
    h, stride = filtered.shape
    n_px = -(-stride // bpp)
    w1 = n_px + 1
    f = np.zeros((h + 1, w1, bpp), np.int16)
    f.reshape(h + 1, w1 * bpp)[1:, bpp:bpp + stride] = filtered
    kind = np.zeros((h + 1, w1, 1), np.int16)
    kind[1:, 1:] = kinds.astype(np.int16)[:, None, None]
    f, kind = f.reshape(-1, bpp), kind.reshape(-1, 1)
    out = np.zeros_like(f)
    for d in range(h + n_px - 1):
        r0, r1 = max(0, d - n_px + 1), min(h - 1, d)
        # padded flat index of (r, d - r): (r + 1) * w1 + d - r + 1
        i0 = r0 * n_px + w1 + d + 1
        i1 = r1 * n_px + w1 + d + 2
        a = out[i0 - 1:i1 - 1:n_px]              # left
        b = out[i0 - w1:i1 - w1:n_px]            # up
        c = out[i0 - w1 - 1:i1 - w1 - 1:n_px]    # up-left
        ab = a + b
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(ab - 2 * c)
        paeth = np.where(pa <= np.minimum(pb, pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kind[i0:i1:n_px], (0, a, b, ab >> 1, paeth))
        out[i0:i1:n_px] = (f[i0:i1:n_px] + pred) & 0xFF
    out = out.reshape(h + 1, w1 * bpp)[1:, bpp:bpp + stride]
    return out.astype(np.uint8)


def _unpack(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """[H, stride] bytes of `depth`-bit samples (most significant first) →
    [H, n] sample values."""
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)      # MSB first
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :n]


def decode_png(raw: bytes) -> np.ndarray:
    """A PNG file → [H, W, 3] uint8 RGB, as PIL's
    `Image.open(...).convert("RGB")` gives it."""
    if not raw.startswith(_PNG_SIG):
        raise ImageError("not a PNG file")
    pos, ihdr, palette, idat = len(_PNG_SIG), None, None, []
    while True:
        if pos + 8 > len(raw):
            raise ImageError("PNG: truncated before IEND")
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        crc = raw[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageError(f"PNG: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ImageError(f"PNG: bad CRC in the {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ImageError("PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ImageError("PNG: interlaced (Adam7) images are not supported; "
                         "send a non-interlaced PNG")
    if depth == 16:
        raise ImageError("PNG: 16-bit images are not supported; send an 8-bit PNG")
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ImageError(f"PNG: bit depth {depth} with color type {ctype} is not supported")
    if ctype == 3 and palette is None:
        raise ImageError("PNG: a palette image without a PLTE chunk")
    channels = _PNG_TYPES[ctype][0]
    bits = channels * depth
    stride = -(-width * bits // 8)
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageError(f"PNG: corrupt image data ({e})") from None
    if len(data) < height * (stride + 1):
        raise ImageError("PNG: image data shorter than the image")
    rows = np.frombuffer(data, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    if int(rows[:, 0].max(initial=0)) > 4:
        raise ImageError("PNG: unknown row filter type")
    samples = _unpack(_unfilter(rows[:, 1:], rows[:, 0], max(1, bits // 8)), depth,
                      width * channels).reshape(height, width, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[samples[..., 0]]
    if ctype in (0, 4):   # gray (with alpha): the gray replicated
        gray = samples[..., 0]
        if depth < 8:
            gray = (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def decode_image(raw: bytes) -> np.ndarray:
    """Image bytes → [H, W, 3] uint8 RGB: PNG by `decode_png`, any other
    format through PIL where PIL is importable."""
    if raw.startswith(_PNG_SIG):
        return decode_png(raw)
    fmt = _format_name(raw)
    try:
        from PIL import Image
    except ImportError:
        raise ImageError(f"{fmt} image: only PNG is decoded without PIL, which is not "
                         "installed here; send the image as PNG") from None
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    except Exception as e:   # noqa: BLE001 — PIL raises several types
        raise ImageError(f"{fmt} image: cannot decode ({e})") from None


# ---------------------------------------------------------------------------
# PIL's bicubic resampling
# ---------------------------------------------------------------------------


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the box
    [0, in_size): (first input index [out], fixed-point taps [out, ksize],
    zero past each output's own tap count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; the bounds are clamped after
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = _bicubic(((x[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one)).astype(np.int64)
    return xmin, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass of uint8 img along `axis` (1: horizontal,
    0: vertical), rounded as PIL rounds (add half, shift, clip)."""
    xmin, kk = _coeffs(img.shape[axis], out_size)
    last = img.shape[axis] - 1
    shape = list(img.shape)
    shape[axis] = out_size
    # int32 as PIL's accumulator: at most 255 · 2^22 · (the sum of the
    # positive taps, under 1.25) plus the half, below 2^31
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    bcast = [1] * img.ndim
    bcast[axis] = out_size
    kk = kk.astype(np.int32)
    for j in range(kk.shape[1]):
        taps = np.take(img, np.minimum(xmin + j, last), axis=axis).astype(np.int32)
        acc += taps * kk[:, j].reshape(bcast)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, C] uint8 → [height, width, C] uint8, PIL's
    `Image.resize((width, height), Image.Resampling.BICUBIC)`: the
    horizontal pass, then the vertical one, each only when its size
    changes."""
    if img.shape[1] != width:
        img = _pass(img, width, axis=1)
    if img.shape[0] != height:
        img = _pass(img, height, axis=0)
    return img


# ---------------------------------------------------------------------------
# the CLIP pipeline
# ---------------------------------------------------------------------------


def preprocess_images(images_b64: list, image_size: int) -> np.ndarray:
    """base64 (or raw-bytes) images → [N, 3, S, S] float32 pixel values."""
    out = []
    for item in images_b64:
        try:
            raw = base64.b64decode(item, validate=False) if isinstance(item, str) \
                else bytes(item)
        except ValueError as e:
            raise ImageError(f"image is not valid base64 ({e})") from None
        img = decode_image(raw)
        h, w = img.shape[:2]
        # shortest-edge resize; the long side TRUNCATES (transformers'
        # get_resize_output_image_size uses int())
        if w <= h:
            nw, nh = image_size, max(1, int(h * image_size / w))
        else:
            nw, nh = max(1, int(w * image_size / h)), image_size
        img = resize_bicubic(img, nw, nh)
        left, top = (nw - image_size) // 2, (nh - image_size) // 2
        img = img[top:top + image_size, left:left + image_size]
        arr = img.astype(np.float32) / 255.0                 # [S, S, 3]
        arr = (arr - _MEAN) / _STD
        out.append(arr.transpose(2, 0, 1))                   # [3, S, S]
    return np.stack(out)
