"""The port's JPEG decoder (``utils/image_io.py`` ``read_jpeg``,
``utils/jpeg_decode.cc``) against PIL 12.1.0 / libjpeg-turbo 3.1.3, and the
COLMAP loader on a JPEG capture against the JAX package's loader.

Tolerance: none. ``read_jpeg`` must return ``np.asarray(Image.open(path))``
and ``Image.open(path).mode`` to the bit, on hypothesis-drawn images (1-67
pixels a side; 4:4:4, 4:2:2 and 4:2:0; qualities 1-100; baseline or
progressive; optimised Huffman tables; restart intervals) and on the
committed fixtures, and every refusal raises a ``ValueError`` naming the
file. The loaders' images, masks and directions are equal to the bit.

The fixtures under ``tests/fixtures/jpeg/`` are written by this file's
script mode with PIL (and the port's COLMAP export of the procedural scene):

    PYTHONPATH=. python tests/test_torch_port_jpeg.py --write-fixtures

(``--rates`` instead prints PIL's and the port's decode rates on this
machine.) ``digests.json`` keeps each fixture's PIL array digest (sha256 of
its bytes, shape, mode) and the JAX loader's digests on the capture, for
the card, which has no PIL: ``chip_smoke.py``'s jpeg phase and
``tests/test_torch_port_cuda.py`` hold the port to them. The tests here
re-derive every digest with PIL and the JAX loader, so the committed
expectations cannot drift from the reference.
"""

import hashlib
import io
import json
import pathlib
import shutil
import struct
import sys
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu.datasets.colmap as j_colmap
import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets.colmap as t_colmap
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.utils import image_io

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
DIGESTS = FIXTURES / "digests.json"
CAPTURE = "colmap"  # the capture's folder under FIXTURES
CAPTURE_VIEWS, CAPTURE_SIZE = 24, 160
# the loader's settings the digests are taken at (chip_smoke.py trains
# configs/nerf-colmap.yaml with these dataset settings)
LOADER_CONFIG = {"name": "colmap", "img_downscale": 2, "up_est_method": "camera",
                 "center_est_method": "lookat", "n_test_traj_steps": 3, "apply_mask": False}


def digest(a):
    """sha256 of an array's bytes (C order)."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def scene_image(w, h, seed, noise=5.0):
    """A photo-like uint8 RGB image: smooth colour fields, hard edges, a
    few saturated patches (which reach the IDCT's range limit) and mild
    noise (its standard deviation ``noise``)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(xx / 23.0 + yy / 41.0),
                    128 + 90 * np.cos(xx / 37.0 - yy / 19.0),
                    (xx * 3 + yy * 5) % 256], -1)
    img[(xx // 16 + yy // 16) % 5 == 0] = [250, 30, 20]
    img[: h // 6, : w // 5] = [255, 255, 255]
    img[-(h // 6):, -(w // 5):] = [0, 0, 255]
    img += rs.randn(h, w, 3) * noise
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


# name -> (width, height, grey, PIL save options)
SMALL_FIXTURES = {
    "baseline_444.jpg": (256, 192, False, {"quality": 75, "subsampling": 0}),
    "baseline_422.jpg": (256, 192, False, {"quality": 75, "subsampling": 1}),
    "baseline_420.jpg": (256, 192, False, {"quality": 75, "subsampling": 2}),
    "grey.jpg": (256, 192, True, {"quality": 75}),
    "progressive_420.jpg": (256, 192, False, {"quality": 80, "subsampling": 2,
                                              "progressive": True}),
    "progressive_grey.jpg": (200, 150, True, {"quality": 80, "progressive": True}),
    "optimize_444.jpg": (256, 192, False, {"quality": 85, "subsampling": 0, "optimize": True}),
    "restart_420.jpg": (256, 192, False, {"quality": 75, "subsampling": 2,
                                          "restart_marker_blocks": 3}),
    "odd_37x23_420.jpg": (37, 23, False, {"quality": 90, "subsampling": 2}),
    "odd_101x67_422_progressive.jpg": (101, 67, False, {"quality": 70, "subsampling": 1,
                                                        "progressive": True}),
    "q5_420.jpg": (256, 192, False, {"quality": 5, "subsampling": 2}),
    "q100_444.jpg": (128, 96, False, {"quality": 100, "subsampling": 0}),
    "adobe_rgb.jpg": (128, 96, False, {"quality": 90, "subsampling": 0, "keep_rgb": True}),
    "tiny_3x2_420.jpg": (3, 2, False, {"quality": 90, "subsampling": 2}),
}
LARGE_FIXTURE = ("large_1024x768_progressive_420.jpg", 1024, 768,
                 {"quality": 85, "subsampling": 2, "progressive": True})


def _pil_entry(path):
    im = Image.open(path)
    a = np.asarray(im)
    return {"sha256": digest(a), "shape": list(a.shape), "mode": im.mode}


def fixture_paths():
    """Every committed JPEG fixture, relative to FIXTURES, sorted."""
    return sorted(p.relative_to(FIXTURES).as_posix() for p in FIXTURES.rglob("*.jpg"))


def loader_digests(dm):
    """The train split's arrays of a loader (either package's)."""
    ds = dm.train
    arrays = {"images": ds.all_images, "masks": ds.all_fg_masks, "directions": ds.directions}
    return {k: {"sha256": digest(np.asarray(v, np.float32)), "shape": list(np.shape(v))}
            for k, v in arrays.items()}


def jax_loader(root):
    j_colmap.ColmapDatasetBase._cache = {}
    dm = j_reg.datasets.make("colmap", j_config({**LOADER_CONFIG, "root_dir": str(root)}))
    dm.setup("fit")
    j_colmap.ColmapDatasetBase._cache = {}
    return dm


def port_loader(root):
    t_colmap.ColmapDatasetBase._cache = {}
    dm = t_reg.datasets.make("colmap", t_config({**LOADER_CONFIG, "root_dir": str(root)}))
    dm.setup("fit")
    t_colmap.ColmapDatasetBase._cache = {}
    return dm


def write_capture(out):
    """The procedural scene's COLMAP export (``--backdrop 10``) re-encoded as
    JPEG q90 4:2:0, with the views' foreground masks as grey JPEGs."""
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make

    with tempfile.TemporaryDirectory() as tmp:
        assert t_make.main(["--out", tmp, "--format", "colmap", "--size", str(CAPTURE_SIZE),
                            "--n-train", str(CAPTURE_VIEWS), "--backdrop", "10"]) == 0
        src = pathlib.Path(tmp) / "colmap"
        shutil.rmtree(out, ignore_errors=True)
        (out / "sparse" / "0").mkdir(parents=True)
        (out / "images").mkdir()
        (out / "masks").mkdir()
        for name in ("cameras.bin", "points3D.bin"):
            shutil.copy(src / "sparse" / "0" / name, out / "sparse" / "0" / name)
        images_bin = (src / "sparse" / "0" / "images.bin").read_bytes()
        n = images_bin.count(b".png\x00")
        assert n == CAPTURE_VIEWS
        (out / "sparse" / "0" / "images.bin").write_bytes(
            images_bin.replace(b".png\x00", b".jpg\x00"))
        splits = t_make._splits(CAPTURE_SIZE, CAPTURE_VIEWS, 0, 0, 0.8, ("train",))
        masks = splits["train"].all_fg_masks
        for i in range(CAPTURE_VIEWS):
            rgb = Image.open(src / "images" / f"img_{i:04d}.png")
            rgb.save(out / "images" / f"img_{i:04d}.jpg", quality=90, subsampling=2)
            Image.fromarray(t_make._to_u8(masks[i])).save(out / "masks" / f"img_{i:04d}.jpg",
                                                          quality=90)


def write_fixtures():
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for old in FIXTURES.glob("*.jpg"):
        old.unlink()
    for i, (name, (w, h, grey, kw)) in enumerate(sorted(SMALL_FIXTURES.items())):
        img = scene_image(w, h, i)
        Image.fromarray(img[..., 1] if grey else img).save(FIXTURES / name, **kw)
    name, w, h, kw = LARGE_FIXTURE
    Image.fromarray(scene_image(w, h, 99, noise=2.0)).save(FIXTURES / name, **kw)
    write_capture(FIXTURES / CAPTURE)
    out = {"pil": {p: _pil_entry(FIXTURES / p) for p in fixture_paths()},
           "loader": {"config": {**LOADER_CONFIG, "root_dir": CAPTURE},
                      **loader_digests(jax_loader(FIXTURES / CAPTURE))}}
    DIGESTS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"wrote {len(out['pil'])} JPEG fixtures and {DIGESTS.name} under {FIXTURES}: "
          f"{total / 1024:.1f} KiB")


# ---------------------------------------------------------------------------
# read_jpeg against PIL
# ---------------------------------------------------------------------------

def _check_equal(path):
    im = Image.open(path)
    ref = np.asarray(im)
    got, mode = image_io.read_jpeg(path)
    assert mode == im.mode
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@st.composite
def _jpegs(draw):
    w = draw(st.integers(1, 67))
    h = draw(st.integers(1, 67))
    grey = draw(st.booleans())
    content = draw(st.sampled_from(["noise", "scene", "flat", "saturated"]))
    seed = draw(st.integers(0, 2**16))
    rs = np.random.RandomState(seed)
    if content == "noise":
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
    elif content == "scene":
        img = scene_image(w, h, seed)
    elif content == "flat":
        img = np.full((h, w, 3), rs.randint(0, 256, 3), np.uint8)
    else:  # pure primaries: the colour conversion's and the IDCT's clamps
        img = (rs.randint(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    kw = {"quality": draw(st.integers(1, 100)),
          "progressive": draw(st.booleans()),
          "optimize": draw(st.booleans())}
    if not grey:
        kw["subsampling"] = draw(st.sampled_from([0, 1, 2]))
    restart = draw(st.sampled_from([0, 0, 1, 2, 5]))
    if restart:
        kw["restart_marker_blocks"] = restart
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if grey else img).save(buf, "JPEG", **kw)
    return buf.getvalue()


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(data=_jpegs())
def test_read_jpeg_matches_pil_on_drawn_images(tmp_path_factory, data):
    path = tmp_path_factory.getbasetemp() / "drawn.jpg"
    path.write_bytes(data)
    _check_equal(path)


@pytest.mark.parametrize("name", [*sorted(SMALL_FIXTURES), LARGE_FIXTURE[0]])
def test_read_jpeg_matches_pil_on_fixtures(name):
    """The committed fixtures: equal to PIL to the bit, and PIL's digests
    equal to the committed ones (what the card holds the port to)."""
    path = FIXTURES / name
    got = _check_equal(path)
    want = json.loads(DIGESTS.read_text())["pil"][name]
    assert _pil_entry(path) == want
    assert [digest(got), list(got.shape)] == [want["sha256"], want["shape"]]
    assert image_io.jpeg_size(path) == Image.open(path).size


def _special_bytes(kind):
    img = scene_image(56, 40, 6)
    buf = io.BytesIO()
    if kind == "sof1_16bit_tables":  # tables too coarse for baseline: SOF1, 16-bit DQT
        q = [[min(1000, 2 + 15 * i) for i in range(64)]] * 2
        Image.fromarray(img).save(buf, "JPEG", qtables=q, subsampling=2)
    else:  # an EXIF orientation and an ICC profile, which Image.open leaves alone
        exif = Image.Exif()
        exif[0x0112] = 6
        Image.fromarray(img).save(buf, "JPEG", quality=80, exif=exif.tobytes(),
                                  icc_profile=bytes(range(256)) * 12)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["sof1_16bit_tables", "exif_icc"])
def test_read_jpeg_matches_pil_on_special_files(kind, tmp_path):
    """An extended-sequential frame with 16-bit quantisation tables, and a
    file with EXIF orientation 6 and an ICC profile (not applied, as PIL
    does not apply them in ``Image.open``): equal to PIL."""
    data = _special_bytes(kind)
    marker = {"sof1_16bit_tables": b"\xff\xc1", "exif_icc": b"\xff\xe2"}[kind]
    assert marker in data
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    _check_equal(path)


def test_fixture_set_is_complete_and_small():
    """digests.json covers every committed JPEG (the capture's too), each
    equal to PIL; the whole folder stays under 500 KB."""
    digests = json.loads(DIGESTS.read_text())
    assert sorted(digests["pil"]) == fixture_paths()
    assert len([p for p in fixture_paths() if p.startswith(CAPTURE)]) == 2 * CAPTURE_VIEWS
    for rel in fixture_paths():
        if rel.startswith(CAPTURE):
            got, mode = image_io.read_jpeg(FIXTURES / rel)
            assert [digest(got), list(got.shape), mode] == [
                digests["pil"][rel][k] for k in ("sha256", "shape", "mode")]
            assert _pil_entry(FIXTURES / rel) == digests["pil"][rel]
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 500_000, total


def test_read_jpeg_convert_l_matches_pil():
    for name in ("baseline_420.jpg", "grey.jpg", "adobe_rgb.jpg"):
        ref = np.asarray(Image.open(FIXTURES / name).convert("L"))
        got, mode = image_io.read_jpeg(FIXTURES / name, convert="L")
        assert mode == "L"
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _baseline_bytes():
    buf = io.BytesIO()
    Image.fromarray(scene_image(48, 32, 1)).save(buf, "JPEG", quality=80, subsampling=2)
    return buf.getvalue()


def _progressive_bytes():
    buf = io.BytesIO()
    Image.fromarray(scene_image(48, 32, 2)).save(buf, "JPEG", quality=80, subsampling=2,
                                                progressive=True)
    return buf.getvalue()


def _segments(data):
    """(offset of the 0xFF, marker code) of each marker before the first
    scan's data, and of each SOS."""
    out, p = [], 2
    while p < len(data):
        code = data[p + 1]
        out.append((p, code))
        if code == 0xD9:
            break
        length = struct.unpack(">H", data[p + 2:p + 4])[0]
        p += 2 + length
        if code == 0xDA:  # skip the entropy-coded data to the next marker
            while not (data[p] == 0xFF and data[p + 1] not in (0x00, *range(0xD0, 0xD8))):
                p += 1
    return out


def _patch_sof(data, code=None, precision=None, components=None):
    b = bytearray(data)
    p = next(off for off, c in _segments(data) if c in (0xC0, 0xC1, 0xC2))
    if code is not None:
        b[p + 1] = code
    if precision is not None:
        b[p + 4] = precision
    if components is not None:  # the first component's sampling byte
        b[p + 11] = components
    return bytes(b)


def _cmyk_bytes():
    buf = io.BytesIO()
    Image.fromarray(scene_image(32, 32, 3)).convert("CMYK").save(buf, "JPEG", quality=80)
    return buf.getvalue()


def _gif_bytes():
    buf = io.BytesIO()
    Image.fromarray(scene_image(16, 16, 4)).convert("P").save(buf, "GIF")
    return buf.getvalue()


def _early_scans(data, keep):
    """A progressive file cut after its first ``keep`` scans, then EOI: its
    AC coefficients stay unrefined, which libjpeg would smooth."""
    sos = [off for off, c in _segments(data) if c == 0xDA]
    return data[:sos[keep]] + b"\xff\xd9"


REFUSALS = {
    "cmyk": (_cmyk_bytes, "4 components"),
    "truncated_half": (lambda: _baseline_bytes()[: len(_baseline_bytes()) // 2],
                       "truncated"),
    "truncated_no_eoi": (lambda: _baseline_bytes()[:-2], "truncated"),
    "truncated_header": (lambda: _baseline_bytes()[:100], "truncated"),
    "truncated_progressive": (lambda: _progressive_bytes()[: 2 * len(_progressive_bytes()) // 3],
                              "truncated"),
    "corrupt_entropy": (lambda: _baseline_bytes()[:-40] + b"\xff" * 38 + b"\xff\xd9",
                        "truncated or corrupt"),
    "arithmetic": (lambda: _patch_sof(_baseline_bytes(), code=0xC9), "arithmetic"),
    "lossless": (lambda: _patch_sof(_baseline_bytes(), code=0xC3), "lossless"),
    "hierarchical": (lambda: _patch_sof(_baseline_bytes(), code=0xC5), "hierarchical"),
    "twelve_bit": (lambda: _patch_sof(_baseline_bytes(), precision=12), "12-bit"),
    "sampling_4x1": (lambda: _patch_sof(_baseline_bytes(), components=0x41), "sampling"),
    "unrefined_progressive": (lambda: _early_scans(_progressive_bytes(), 3), "unrefined"),
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_read_jpeg_refuses(kind, tmp_path):
    """Each refusal is a ValueError naming the file and the reason; no part
    of an image is returned. PIL reads none of these as this JPEG either:
    it opens CMYK as ``CMYK``, raises OSError on truncated data, and
    smooths unrefined progressive blocks."""
    make, reason = REFUSALS[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=f"{kind}.jpg: .*{reason}"):
        image_io.read_jpeg(path)
    if kind == "cmyk":
        assert Image.open(path).mode == "CMYK"
    if kind.startswith("truncated"):
        with pytest.raises(OSError):
            Image.open(path).load()


def test_read_image_picks_png_or_jpeg(tmp_path):
    """``read_image`` by magic bytes: a PNG through ``read_png``, a JPEG
    through ``read_jpeg`` whatever its suffix, a GIF a ValueError naming it."""
    img = scene_image(20, 12, 5)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray(img).save(tmp_path / "b.png", format="JPEG", quality=90)
    (tmp_path / "c.jpg").write_bytes(_gif_bytes())
    got, mode = image_io.read_image(tmp_path / "a.png")
    assert mode == "RGB"
    np.testing.assert_array_equal(got, img)
    got, mode = image_io.read_image(tmp_path / "b.png", convert="L")
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "b.png").convert("L")))
    with pytest.raises(ValueError, match="c.jpg: neither a PNG nor a JPEG"):
        image_io.read_image(tmp_path / "c.jpg")
    with pytest.raises(ValueError, match="c.jpg: not a JPEG"):
        image_io.read_jpeg(tmp_path / "c.jpg")


# ---------------------------------------------------------------------------
# the COLMAP loader on the JPEG capture
# ---------------------------------------------------------------------------

def test_jpeg_capture_loader_matches_jax_and_digests():
    """The committed capture (24 views, JPEG images and masks) through both
    loaders at ``LOADER_CONFIG``: images, masks and directions equal to the
    bit, and the JAX loader's digests equal to the committed ones."""
    root = FIXTURES / CAPTURE
    j_dm, t_dm = jax_loader(root), port_loader(root)
    j, t = j_dm.train, t_dm.train
    np.testing.assert_array_equal(t.all_images, j.all_images)
    np.testing.assert_array_equal(t.all_fg_masks, j.all_fg_masks)
    np.testing.assert_array_equal(t.directions, j.directions)
    np.testing.assert_allclose(t.all_c2w, j.all_c2w, rtol=0, atol=1e-6)
    assert t.all_images.shape == (CAPTURE_VIEWS, 80, 80, 3)
    assert 0.0 < float(t.all_fg_masks.mean()) < 1.0
    want = json.loads(DIGESTS.read_text())["loader"]
    assert want["config"] == {**LOADER_CONFIG, "root_dir": CAPTURE}
    assert {k: want[k] for k in ("images", "masks", "directions")} == loader_digests(j_dm)
    assert loader_digests(t_dm) == loader_digests(j_dm)
    assert set(t.load_seconds) == {"decode", "resize"}


def decode_rates():
    """PIL's and ``read_jpeg``'s decode rates on this machine, megapixels per
    second: the largest fixture (median of 10 decodes) and the capture's
    images one after another (median of 5 passes)."""
    import statistics
    import time

    want = json.loads(DIGESTS.read_text())["pil"]
    large = max(want, key=lambda p: np.prod(want[p]["shape"][:2]))
    capture = [p for p in sorted(want) if p.startswith(f"{CAPTURE}/images/")]
    for label, paths, reps in ((large, [large], 10), (f"{CAPTURE}/images", capture, 5)):
        mp = sum(np.prod(want[p]["shape"][:2]) for p in paths) / 1e6
        for name, decode in (("PIL", lambda p: np.asarray(Image.open(p))),
                             ("read_jpeg", image_io.read_jpeg)):
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                for p in paths:
                    decode(FIXTURES / p)
                walls.append(time.perf_counter() - t0)
            print(f"{label} ({len(paths)} files, {mp:.3f} MP): {name} "
                  f"{mp / statistics.median(walls):.1f} MP/s")


if __name__ == "__main__":
    if sys.argv[1:] == ["--rates"]:
        decode_rates()
        sys.exit(0)
    if sys.argv[1:] != ["--write-fixtures"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_jpeg.py "
                 "--write-fixtures | --rates")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixtures()
