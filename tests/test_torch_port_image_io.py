"""The port's image input (``instant_nsr_pl_tpu_torch/utils/image_io.py``)
against PIL, which the JAX package's loaders use: ``read_png`` bit-equal to
``np.asarray(PIL.Image.open(path))`` (the array, its dtype and PIL's mode) on
data80's PNGs, on PNGs that PIL writes and on PNGs that a small encoder here
writes with every filter type, Adam7 and split IDAT chunks; ``read_png(...,
convert="L")`` and ``to_luma`` equal to ``convert("L")``; ``resize_bicubic``
within 1/255 of ``Image.resize(..., Image.BICUBIC)`` (the share of equal
bytes is printed; on Pillow 12.1 it is 1.0); broken files raise a
ValueError naming the file."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from instant_nsr_pl_tpu_torch.utils import image_io

Image = pytest.importorskip("PIL.Image")

ROOT = Path(__file__).resolve().parents[1]
DATA80 = ROOT / "data80" / "blender"
WIDTHS = (1, 3, 17)


def _pil(path, convert=None):
    im = Image.open(path)
    if convert:
        im = im.convert(convert)
    return np.asarray(im), im.mode


def _assert_same(path):
    got, mode = image_io.read_png(path)
    ref, ref_mode = _pil(path)
    assert mode == ref_mode, (mode, ref_mode)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape,
                                                               ref.shape)
    assert np.array_equal(got, ref)
    luma, luma_mode = image_io.read_png(path, convert="L")
    assert luma_mode == "L" and np.array_equal(luma, _pil(path, "L")[0])


def _filter_types(path):
    data = path.read_bytes()
    pos, idat = 8, b""
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IHDR":
            w, h = struct.unpack(">II", data[pos + 8:pos + 16])
        elif ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw[::w * 4 + 1][:h]


@pytest.mark.parametrize("name", ["train/r_45.png", "train/r_46.png", "test/r_0.png"])
def test_read_png_data80_bit_equal(name):
    path = DATA80 / name
    assert (_filter_types(path) == 4).sum() > 200  # Paeth rows, sequential along a row
    _assert_same(path)
    assert image_io.png_size(path) == (800, 800)


_PIL_CASES = [("1", bool, None), ("L", np.uint8, None), ("LA", np.uint8, 2),
              ("I;16", np.uint16, None), ("RGB", np.uint8, 3), ("RGBA", np.uint8, 4),
              ("P1", np.uint8, None), ("P2", np.uint8, None), ("P4", np.uint8, None),
              ("P8", np.uint8, None), ("P4-tRNS", np.uint8, None), ("P8-tRNS", np.uint8, None)]


@pytest.mark.parametrize("case", [c[0] for c in _PIL_CASES])
def test_read_png_pil_written(case, tmp_path):
    _, dtype, channels = next(c for c in _PIL_CASES if c[0] == case)
    rng = np.random.RandomState(len(case))
    for w in WIDTHS:
        h = 6
        shape = (h, w) if channels is None else (h, w, channels)
        if case.startswith("P"):
            bits = int(case[1])
            a = rng.randint(0, 1 << bits, shape).astype(np.uint8)
            im = Image.frombytes("P", (w, h), a.tobytes())
            im.putpalette(list(rng.randint(0, 256, 3 * (1 << bits))))
            kw = {"bits": bits}
            if case.endswith("tRNS"):
                kw["transparency"] = bytes(rng.randint(0, 256, 1 << bits).astype(np.uint8))
        else:
            hi = 2 if dtype is bool else 65536 if dtype is np.uint16 else 256
            a = rng.randint(0, hi, shape).astype(dtype)
            mode = case
            im = (Image.fromarray(a) if mode in ("1", "I;16") else
                  Image.frombytes(mode, (w, h), a.tobytes()))
            kw = {}
        for optimize in (False, True):
            path = tmp_path / f"{case}-{w}-{optimize}.png"
            im.save(path, optimize=optimize, **kw)
            _assert_same(path)


# ---------------------------------------------------------------------------
# a small encoder: every filter type, Adam7, IDAT split in small chunks
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _scanline(samples, depth):
    """One row of samples (w, c) as packed big-endian bytes."""
    flat = samples.reshape(-1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    bits = ((flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def _filter(ftype, cur, prev, bpp):
    """A scanline's bytes filtered with ``ftype`` (without the type byte)."""
    cur = np.frombuffer(cur, np.uint8).astype(np.int64)
    prev = np.frombuffer(prev, np.uint8).astype(np.int64) if prev else np.zeros_like(cur)
    n = len(cur)
    a = np.concatenate([np.zeros(bpp, np.int64), cur])[:n]
    c = np.concatenate([np.zeros(bpp, np.int64), prev])[:n]
    b = prev
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((cur - pred) % 256).astype(np.uint8).tobytes()


def _encode(samples, depth, colour, interlace, palette=None, trns=None, bad_filter=False):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, row_no = b"", 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        prev = None
        for r in range(sub.shape[0]):
            line = _scanline(sub[r], depth)
            ftype = row_no % 5
            raw += bytes([7 if bad_filter and row_no == 1 else ftype])
            raw += _filter(ftype, line, prev, bpp)
            prev, row_no = line, row_no + 1
    z = zlib.compress(raw, 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                                                0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for i in range(0, len(z), 7):
        out += _chunk(b"IDAT", z[i:i + 7])
    return out + _chunk(b"IEND", b"")


_ENCODER_CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
                  (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _random_png(colour, depth, w, h, rng, interlace, **kw):
    samples = rng.randint(0, 1 << depth, (h, w, _CHANNELS[colour])).astype(np.int64)
    palette = trns = None
    if colour == 3:
        palette = rng.randint(0, 256, (1 << depth, 3)).astype(np.uint8)
        trns = bytes(rng.randint(0, 256, 1 << depth).astype(np.uint8))
    elif colour in (0, 2) and depth == 8:
        trns = struct.pack(">" + "H" * _CHANNELS[colour], *samples[0, 0])
    return _encode(samples, depth, colour, interlace, palette, trns, **kw)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", _ENCODER_CASES,
                         ids=[f"c{c}d{d}" for c, d in _ENCODER_CASES])
def test_read_png_every_filter(colour, depth, interlace, tmp_path):
    rng = np.random.RandomState(colour * 100 + depth * 2 + interlace)
    for w in WIDTHS:
        for h in (1, 9):
            path = tmp_path / f"{w}x{h}.png"
            path.write_bytes(_random_png(colour, depth, w, h, rng, interlace))
            _assert_same(path)


def _broken(kind, tmp_path):
    rng = np.random.RandomState(5)
    good = _random_png(6, 8, 17, 9, rng, 0)
    if kind == "signature":
        data = b"\x89PNX" + good[4:]
    elif kind == "crc":
        i = good.index(b"IDAT") + 6
        data = good[:i] + bytes([good[i] ^ 1]) + good[i + 1:]
    elif kind == "truncated":
        data = good[:len(good) // 2]
    elif kind == "no_iend":
        data = good[:-12]
    elif kind == "filter":
        data = _random_png(6, 8, 17, 9, rng, 0, bad_filter=True)
    elif kind == "short_data":  # a whole zlib stream that holds too few rows
        raw = zlib.compress(b"\0" * 10)
        data = (good[:33] + _chunk(b"IDAT", raw) + _chunk(b"IEND", b""))
    elif kind == "no_palette":
        data = good[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", 17, 9, 8, 3, 0, 0, 0)) + good[33:]
    else:
        data = good[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", 17, 9, 3, 2, 0, 0, 0)) + good[33:]
    path = tmp_path / f"{kind}.png"
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("kind", ["signature", "crc", "truncated", "no_iend", "filter",
                                  "short_data", "no_palette", "bad_depth"])
def test_read_png_rejects(kind, tmp_path):
    path = _broken(kind, tmp_path)
    with pytest.raises(ValueError, match=kind + r"\.png"):
        image_io.read_png(path)


def test_png_size_reads_ihdr_only(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "x.png"
    data = _random_png(2, 8, 17, 9, rng, 1)
    path.write_bytes(data[:33])  # nothing past IHDR
    assert image_io.png_size(path) == (17, 9)


# ---------------------------------------------------------------------------
# resize and luma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [2, 4, 3.5, 1 / 1.5], ids=["down2", "down4", "down3.5",
                                                             "up1.5"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_resize_bicubic_matches_pil(mode, factor):
    rng = np.random.RandomState(3)
    channels = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[mode]
    equal = total = 0
    for H, W in ((37, 53), (64, 48)):
        a = rng.randint(0, 256, (H, W) + channels).astype(np.uint8)
        if mode in ("LA", "RGBA"):  # transparent and opaque pixels between the rest
            a[..., -1][rng.rand(H, W) < 0.3] = 0
            a[..., -1][rng.rand(H, W) < 0.3] = 255
        size = (max(1, int(W / factor + 0.5)), max(1, int(H / factor + 0.5)))
        ref = np.asarray(Image.frombytes(mode, (W, H), a.tobytes()).resize(size, Image.BICUBIC))
        got = image_io.resize_bicubic(a, size)
        assert got.shape == ref.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        equal += int((got == ref).sum())
        total += ref.size
    print(f"resize_bicubic {mode} x{factor}: {equal / total:.6f} of bytes equal to PIL")


def test_resize_bicubic_data80():
    """A data80 view at img_wh 400x400 (RGBA through RGBa), and unchanged
    when the size already matches."""
    a, _ = image_io.read_png(DATA80 / "val" / "r_1.png")
    ref = np.asarray(Image.open(DATA80 / "val" / "r_1.png").resize((400, 400), Image.BICUBIC))
    got = image_io.resize_bicubic(a, (400, 400))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    print(f"resize_bicubic data80 800 -> 400: {(got == ref).mean():.6f} of bytes equal to PIL")
    assert np.array_equal(image_io.resize_bicubic(a, (800, 800)), a)
    with pytest.raises(ValueError):
        image_io.resize_bicubic(a.astype(np.float32), (400, 400))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "I;16", "RGB", "RGBA"])
def test_to_luma_matches_pil_convert(mode):
    rng = np.random.RandomState(4)
    h, w = 7, 11
    if mode == "1":
        a = rng.rand(h, w) > 0.5
        im = Image.fromarray(a)
    elif mode == "I;16":
        a = rng.randint(0, 600, (h, w)).astype(np.uint16)
        im = Image.fromarray(a)
    else:
        ch = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[mode]
        a = rng.randint(0, 256, (h, w) + ch).astype(np.uint8)
        im = Image.frombytes(mode, (w, h), a.tobytes())
    assert im.mode == mode
    assert np.array_equal(image_io.to_luma(a, mode), np.asarray(im.convert("L")))
