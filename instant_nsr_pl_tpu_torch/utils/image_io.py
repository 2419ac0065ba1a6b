"""Image input without PIL or cv2: PNG and JPEG decoders and Pillow's bicubic
resize.

The JAX package's loaders read images with ``PIL.Image.open``, resize them
with ``Image.BICUBIC`` and take a mask's luma with ``convert("L")``
(``datasets/blender.py``, ``datasets/dtu.py``). The card's Python has neither
PIL nor cv2, so the port carries its own:

- :func:`read_png` returns what ``np.asarray(PIL.Image.open(path))`` returns,
  bit for bit, with PIL's mode name: colour types 0, 2, 3 (PLTE, tRNS), 4
  and 6, bit depths 1-16, filters 0-4, Adam7 interlacing, IDAT split over
  chunks, every chunk's CRC checked. Anything it cannot read raises a
  ``ValueError`` naming the file; it never returns part of an image. The
  scanlines are unfiltered by ``png_unfilter.cc``, built with g++ at first
  use into ``instant_nsr_pl_tpu_torch/_build/`` (a missing compiler raises).
- :func:`png_size` reads (width, height) from IHDR alone.
- :func:`read_jpeg` returns what ``np.asarray(PIL.Image.open(path))``
  returns for a JPEG with PIL 12.1.0 / libjpeg-turbo 3.1.3 at their
  defaults, bit for bit, with PIL's mode (``L`` for one component, ``RGB``
  for three): Huffman-coded 8-bit baseline, extended-sequential and
  progressive frames, restart intervals, 4:4:4 / 4:2:2 / 4:2:0 sampling,
  YCbCr or Adobe RGB; libjpeg's accurate integer IDCT, fancy upsampling and
  fixed-point colour conversion. EXIF orientation and ICC profiles are
  ignored, as ``Image.open`` ignores them. Arithmetic-coded, lossless,
  hierarchical and 12-bit files, other sampling factors, and 4-component
  files raise a ``ValueError`` naming the file (PIL would open a CMYK / YCCK
  file as ``CMYK``, which the JAX loader would read as RGB; the port
  refuses it), as does truncated or corrupt entropy-coded data, where PIL
  raises ``OSError``. The decode is ``jpeg_decode.cc``, built with g++ at
  first use as ``png_unfilter.cc`` is; a call releases the GIL, so images
  decode in parallel on threads.
- :func:`jpeg_size` reads (width, height) from the frame header.
- :func:`read_image` picks PNG or JPEG by the file's first bytes; any other
  file raises a ``ValueError`` naming it.
- :func:`resize_bicubic` is Pillow's ``Image.resize(size, Image.BICUBIC)``
  on uint8 L, LA, RGB and RGBA images (``libImaging/Resample.c``): the cubic
  with a = -0.5, its support widened by the downscale factor, coefficients
  in 22-bit fixed point, the horizontal pass then the vertical with 8-bit
  rounding between them; LA and RGBA go through premultiplied ``La`` /
  ``RGBa`` and back, as ``Image.resize`` does.
- :func:`to_luma` is Pillow's ``convert("L")`` (ITU-R 601 weights in 16-bit
  fixed point).
"""

from __future__ import annotations

import ctypes
import math
import struct
import zlib
from pathlib import Path

import numpy as np

from instant_nsr_pl_tpu_torch.ops import cuda_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"  # SOI and the first marker (PIL's JpegImagePlugin._accept)
# (bit depth, colour type) -> the mode PIL opens the file in
# (PIL.PngImagePlugin._MODES)
_MODES = {
    (1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
    (8, 2): "RGB", (16, 2): "RGB",
    (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
    (8, 4): "LA", (16, 4): "RGBA",
    (8, 6): "RGBA", (16, 6): "RGBA",
}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))

_SRC = Path(__file__).with_name("png_unfilter.cc")
_JPEG_SRC = Path(__file__).with_name("jpeg_decode.cc")


def _unfilter_lib():
    """The g++ build of ``png_unfilter.cc`` (``ops/cuda_build.py``
    ``host_library``)."""
    lib = cuda_build.host_library(_SRC)
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p]
    return lib


def _chunks(data, path):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: truncated {ctype.decode('latin-1')} chunk")
        body = data[pos + 8:end - 4]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: CRC mismatch in the {ctype.decode('latin-1')} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end


def _header(data, path):
    chunks = _chunks(data, path)
    ctype, body = next(chunks)
    if ctype != b"IHDR" or len(body) != 13:
        raise ValueError(f"{path}: the first chunk is not a 13-byte IHDR")
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if (depth, colour) not in _MODES:
        raise ValueError(f"{path}: bit depth {depth} with colour type {colour} is not PNG")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"{path}: unknown compression {comp}, filter method {filt} or "
                         f"interlace method {interlace}")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image ({w}x{h})")
    return (w, h, depth, colour, interlace), chunks


def png_size(path):
    """(width, height) from the IHDR chunk (``cv2.imread(path).shape[1::-1]``)."""
    with open(path, "rb") as f:
        data = f.read(33)  # signature and IHDR
    (w, h, *_), _ = _header(data, path)
    return w, h


def _unfilter(raw, offset, rows, stride, bpp, path):
    need = rows * (stride + 1)
    if offset + need > len(raw):
        raise ValueError(f"{path}: truncated image data")
    out = np.empty((rows, stride), np.uint8)
    src = np.frombuffer(raw, np.uint8, count=need, offset=offset)
    rc = _unfilter_lib().png_unfilter(src.ctypes.data, rows, stride, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"{path}: unknown filter type in scanline {-rc - 1}")
    return out, offset + need


def _samples(rows, width, channels, depth):
    """Unfiltered scanlines (rows, stride) -> samples (rows, width, channels),
    uint8 below 16 bits (sub-byte depths unpacked, not scaled), else uint16."""
    n = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(n, width, channels)
    if depth == 16:
        return rows.view(">u2")[:, :width * channels].reshape(n, width, channels).astype(np.uint16)
    bits = np.unpackbits(rows, axis=1).reshape(n, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width, None]


def _decode(path):
    """(samples (h, w, c), bit depth, colour type, palette (n, 3) or None)
    of a PNG file. Ancillary chunks (tRNS among them: PIL's array ignores
    it) are skipped."""
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, colour, interlace), chunks = _header(data, path)
    palette, idat = None, []
    for ctype, body in chunks:
        if ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            if len(body) % 3 or not body:
                raise ValueError(f"{path}: PLTE of {len(body)} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IHDR" or not ctype[0] & 0x20 and ctype != b"IEND":
            raise ValueError(f"{path}: unexpected critical chunk {ctype.decode('latin-1')}")
    if not idat:
        raise ValueError(f"{path}: no IDAT chunk")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if not inflater.eof:
        raise ValueError(f"{path}: truncated image data (the zlib stream does not end)")
    channels = _CHANNELS[colour]
    bits = channels * depth
    bpp = max(1, bits // 8)
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, h, (w * bits + 7) // 8, bpp, path)
        samples = _samples(rows, w, channels, depth)
    else:
        samples = np.zeros((h, w, channels), dtype)
        offset = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            rows, offset = _unfilter(raw, offset, ph, (pw * bits + 7) // 8, bpp, path)
            samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    return samples, depth, colour, palette


def _pil_array(samples, depth, colour):
    """The array and mode PIL gives for decoded samples (its unpackers:
    L;2 / L;4 scaled to 8 bits, 16-bit colour reduced to its high bytes,
    16-bit grey with alpha opened as RGBA)."""
    mode = _MODES[(depth, colour)]
    if colour == 0:
        s = samples[..., 0]
        if depth == 1:
            return s.astype(bool), mode
        if depth in (2, 4):
            return (s * (0x55 if depth == 2 else 0x11)).astype(np.uint8), mode
        if depth == 16:
            return s.astype("<u2"), mode
        return s.copy(), mode
    if colour == 3:
        return samples[..., 0].copy(), mode
    if depth == 16:
        hi = (samples >> 8).astype(np.uint8)
        if colour == 4:  # LA;16B -> RGBA
            hi = hi[..., [0, 0, 0, 1]]
        return np.ascontiguousarray(hi), mode
    return np.ascontiguousarray(samples), mode


def read_png(path, convert=None):
    """``(np.asarray(PIL.Image.open(path)), PIL's mode)``; with
    ``convert="L"``, ``Image.open(path).convert("L")`` and ``"L"``."""
    samples, depth, colour, palette = _decode(path)
    array, mode = _pil_array(samples, depth, colour)
    if convert is None:
        return array, mode
    if convert != "L":
        raise ValueError(f"{path}: read_png converts only to 'L', not {convert!r}")
    if mode == "P":
        lut = to_luma(np.pad(palette, ((0, 256 - len(palette)), (0, 0))), "RGB")
        return lut[array], "L"
    return to_luma(array, mode), "L"


# -- JPEG --------------------------------------------------------------------

def _jpeg_lib():
    """The g++ build of ``jpeg_decode.cc`` (``ops/cuda_build.py``
    ``host_library``)."""
    lib = cuda_build.host_library(_JPEG_SRC)
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    return lib


def _jpeg_header(data, path):
    """(width, height, components) from the frame header; raises on a file
    the decoder refuses before its first scan."""
    info = (ctypes.c_int64 * 3)()
    err = ctypes.create_string_buffer(512)
    if _jpeg_lib().jpeg_header(data, len(data), info, err, len(err)) != 0:
        raise ValueError(f"{path}: {err.value.decode('latin-1')}")
    return info[0], info[1], info[2]


def jpeg_size(path):
    """(width, height) of a JPEG from its frame header."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, _ = _jpeg_header(data, path)
    return w, h


def read_jpeg(path, convert=None):
    """``(np.asarray(PIL.Image.open(path)), PIL's mode)`` of a JPEG; with
    ``convert="L"``, ``Image.open(path).convert("L")`` and ``"L"``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] != JPEG_SIGNATURE:
        raise ValueError(f"{path}: not a JPEG file (bad signature)")
    w, h, c = _jpeg_header(data, path)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(512)
    if _jpeg_lib().jpeg_decode(data, len(data), out.ctypes.data, out.size, err, len(err)) != 0:
        raise ValueError(f"{path}: {err.value.decode('latin-1')}")
    mode = "RGB" if c == 3 else "L"
    if convert is None:
        return out, mode
    if convert != "L":
        raise ValueError(f"{path}: read_jpeg converts only to 'L', not {convert!r}")
    return to_luma(out, mode), "L"


def read_image(path, convert=None):
    """``read_png`` or ``read_jpeg`` by the file's first bytes; any other
    file raises a ``ValueError`` naming it."""
    with open(path, "rb") as f:
        magic = f.read(len(PNG_SIGNATURE))
    if magic == PNG_SIGNATURE:
        return read_png(path, convert=convert)
    if magic[:3] == JPEG_SIGNATURE:
        return read_jpeg(path, convert=convert)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file; the port reads only those two")


def to_luma(array, mode):
    """Pillow's ``convert("L")`` of an array in ``mode`` (1, L, LA, I;16,
    RGB, RGBA): L = (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    a = np.asarray(array)
    if mode == "L":
        return a.astype(np.uint8, copy=True)
    if mode == "1":
        return np.where(a, 255, 0).astype(np.uint8)
    if mode == "LA":
        return a[..., 0].copy()
    if mode == "I;16":
        return np.minimum(a, 255).astype(np.uint8)
    if mode in ("RGB", "RGBA"):
        c = a[..., :3].astype(np.uint32)
        return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16
                ).astype(np.uint8)
    raise ValueError(f"to_luma: no conversion from mode {mode!r}")


# -- Pillow's bicubic resample (libImaging/Resample.c) ---------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic_filter(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size, out_size):
    """``precompute_coeffs`` then ``normalize_coeffs_8bpc``: each output
    pixel's first input pixel (out,) and its fixed-point weights (out, k)."""
    scale = filterscale = float(in_size) / out_size
    filterscale = max(filterscale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # the weights' sum in C's order
        w = np.where(x < xmax, _bicubic_filter((x + xmin - center + 0.5) * ss), 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    one = float(1 << _PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int64)
    return xmin, kk


def _resample_axis(img, out_size, axis):
    """One 8-bit pass along ``axis`` (1: horizontal, 0: vertical) of an
    (h, w, c) uint8 image. The weights go into a dense (out, in) matrix and
    the pass is one float64 product: every term is an integer below 2^31 and
    every sum below 2^53, so the product is exact, as Pillow's int32 sums."""
    in_size = img.shape[axis]
    xmin, kk = _coefficients(in_size, out_size)
    m = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for x in range(kk.shape[1]):
        idx = xmin + x
        ok = idx < in_size  # weights past xmax are 0
        m[rows[ok], idx[ok]] = kk[ok, x]
    x = np.moveaxis(img, axis, -1)  # (..., in)
    acc = (x.reshape(-1, in_size).astype(np.float64) @ m.T).reshape(x.shape[:-1] + (out_size,))
    acc += float(1 << (_PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / float(1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def _premultiply(img):
    """RGBA -> RGBa / LA -> La: c * a / 255 rounded as Pillow's MULDIV255."""
    out = img.copy()
    alpha = img[..., -1:].astype(np.uint32)
    t = img[..., :-1].astype(np.uint32) * alpha + 128
    out[..., :-1] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(img):
    """RGBa -> RGBA / La -> LA: c * 255 // a clipped, unchanged where a is 0
    or 255 (Pillow's rgba2rgbA)."""
    out = img.copy()
    alpha = img[..., -1:].astype(np.uint32)
    c = img[..., :-1].astype(np.uint32)
    div = np.minimum(c * 255 // np.maximum(alpha, 1), 255)
    out[..., :-1] = np.where((alpha == 0) | (alpha == 255), c, div)
    return out


def resize_bicubic(img, size):
    """Pillow's ``Image.fromarray(img).resize(size, Image.BICUBIC)`` of a
    uint8 image (h, w) L, (h, w, 2) LA, (h, w, 3) RGB or (h, w, 4) RGBA;
    ``size`` is (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                          and img.shape[2] not in (2, 3, 4)):
        raise ValueError(f"resize_bicubic: expected a uint8 L, LA, RGB or RGBA image, got "
                         f"{img.dtype} {img.shape}")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize_bicubic: bad size {size}")
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    alpha = x.shape[2] in (2, 4)
    if alpha:
        x = _premultiply(x)
    if w != x.shape[1]:
        x = _resample_axis(x, w, 1)
    if h != x.shape[0]:
        x = _resample_axis(x, h, 0)
    if alpha:
        x = _unpremultiply(x)
    return x[..., 0] if gray else x
