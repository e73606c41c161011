"""Arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG, which the
port's reader refused before, against PIL over libjpeg-turbo 3.1.3 on the
CPU: every committed fixture (`tools/make_torch_fixtures.py --jpeg-arith`)
equal to PIL's array in dtype, shape and bytes; the two identities that
check the fixture writers without the port's reader; the native lossless
undifferencing against its plain version; seeded flips and truncations;
each refusal PIL makes, named; PIL's 64 KiB read blocks, which an
arithmetic-coded scan may not run past; and datasets and metrics reading
such files as the JAX package does.
"""

import hashlib
import io
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_io

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
FIXTURES = ROOT / "tests" / "torch_fixtures"
_KINDS = ("jpeg_arith_", "jpeg_lossless_", "jpeg_probe_arith", "jpeg_probe_lossless",
          "tif_jpeg_arith", "tif_jpeg_lossless")
COMMITTED = sorted(p for p in FORMATS.rglob("*") if p.is_file() and p.suffix != ".npy"
                   and (p.name.startswith(_KINDS) or p.parent.name == "colmap_jpeg_arith"
                        or p.parent.parent.name == "metrics_jpeg_arith"))
S420 = ((2, 2), (1, 1), (1, 1))


def _image(h, w, c=3, seed=0):
    """Smooth colour with noise, uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9), 128 + 127 * np.cos(x / 11)], -1)[..., :c]
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _same_as_pil(blob, name="case.jpg"):
    """The port's array equals PIL's, or both refuse (the port naming the
    file). Returns whether PIL decoded it."""
    want = _pil(blob)
    if want is None:
        with pytest.raises(ValueError, match=rf"^{name}: "):
            image_io.decode_image(blob, name)
        return False
    got = image_io.decode_image(blob, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return True


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _segment(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


# ---- committed fixtures -------------------------------------------------------------

def _npy(path: Path) -> Path:
    npy = path.with_suffix(".npy")
    if npy.exists():
        return npy
    return path.parent.parent / "pil" / f"{path.parent.name}_{path.stem}.npy"


@pytest.mark.parametrize("path", COMMITTED, ids=lambda p: str(p.relative_to(FORMATS)))
def test_committed_arith_and_lossless_fixture_is_pils_array(path):
    want = np.asarray(Image.open(path))
    card = np.load(_npy(path))
    assert card.dtype == want.dtype and card.tobytes() == want.tobytes()
    got = image_io.read_image(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_committed_fixtures_meet_every_mode():
    names = {p.name for p in COMMITTED}
    for part in ["arith_seq_420", "dac_restart", "arith_seq_grey", "adobe_rgb", "arith_cmyk",
                 "arith_ycck", "arith_prog_420", "prog_partial_ac", "prog_partial_refine",
                 "prog_grey_dc", "arith_damaged", "prog_damaged", "lossless_grey",
                 "grey_jfif", "p7_pt2", "lossless_restart", "lossless_420", "411_restart",
                 "separate_scans", "separate_v2_restart", "lossless_cmyk", "lossless_damaged",
                 "tif_jpeg_arith_ycbcr420", "tif_jpeg_arith_rgb_progressive",
                 "tif_jpeg_lossless_rgb", "tif_jpeg_lossless_grey"] + [
            f"lossless_p{p}" for p in range(1, 8)]:
        assert any(part in n for n in names), part
    assert sum(p.stat().st_size + _npy(p).stat().st_size for p in COMMITTED) < 2 << 20


def test_scene_size_views_equal_pils_decode():
    """The three 1296x832 views (arithmetic sequential and progressive, each
    under PIL's 64 KiB block, and lossless) against the dtype, shape and
    SHA-256 of PIL's decode, which is the view itself."""
    from tools.make_torch_fixtures import ARITH_SCENES
    from wast3d_tpu_torch.utils import png

    view = png.read_png(str(FIXTURES / "pil_decode" / "scene_1296x832_420.png"))
    for name in ARITH_SCENES:
        path = FIXTURES / "jpeg_arith" / f"{name}.jpeg"
        got = image_io.read_image(str(path))
        record = json.loads((FIXTURES / "pil_decode" / f"{name}_jpeg.json").read_text())
        assert record == {"dtype": str(got.dtype), "shape": list(got.shape),
                          "sha256": hashlib.sha256(got.tobytes()).hexdigest()}
        assert got.tobytes() == view.tobytes()
        if "arith" in name:
            assert path.stat().st_size < 65536


# ---- the writers' identities ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(restart_interval=3), dict(dac={0: 0x52, 16: 9}),
                                dict(scans=iw.PROGRESSIVE_3),
                                dict(scans=iw.PROGRESSIVE_3, restart_interval=2,
                                     dac={1: 0x31, 17: 1})],
                         ids=["sequential", "restart", "dac", "progressive", "progressive_rst"])
@pytest.mark.parametrize("seed", [1, 2])
def test_arithmetic_transcode_decodes_to_its_huffman_source(kw, seed):
    """PIL's Huffman JPEG coded again coefficient for coefficient by the
    arithmetic coder (jpegtran -arithmetic's rewrite): PIL decodes both to
    the same array, which holds the writer's Table D.2 and coder to
    libjpeg's; the port reads it too."""
    rng = np.random.default_rng(seed)
    img = _image(40 + 8 * seed, 56, 3, seed)
    src = _pil_jpeg(img, quality=int(rng.integers(70, 96)), subsampling=seed % 3)
    blob = iw.jpeg_transcode(src, **kw)
    assert (b"\xff\xca" if "scans" in kw else b"\xff\xc9") in blob
    want = np.asarray(Image.open(io.BytesIO(src)))
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), want)
    assert image_io.decode_image(blob, "t.jpg").tobytes() == want.tobytes()
    grey = _pil_jpeg(img[..., 1], quality=80)
    kw = dict(kw, scans=iw.PROGRESSIVE_1) if "scans" in kw else kw
    assert np.array_equal(_pil(iw.jpeg_transcode(grey, **kw)), _pil(grey))


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_file_decodes_to_its_source(predictor):
    """At Pt = 0 and 1 x 1 sampling a lossless file decodes in PIL to its
    samples, RGB (no JFIF marker) and grey, with and without restarts; the
    port reads each the same."""
    img = _image(33, 47, 3, predictor)
    for blob, want in ((iw.jpeg_lossless_bytes(img, predictor=predictor), img),
                       (iw.jpeg_lossless_bytes(img, predictor=predictor, restart_interval=94),
                        img),
                       (iw.jpeg_lossless_bytes(img[..., 2], predictor=predictor), img[..., 2])):
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), want)
        got = image_io.decode_image(blob, "l.jpg")
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


def test_subsampled_lossless_is_replicated():
    """libjpeg-turbo upsamples a lossless file by replication (no context
    rows, so no fancy filter): PIL's array is each stored plane repeated."""
    img = _image(31, 45, 3, 4)
    for sampling in (S420, ((2, 1), (1, 1), (1, 1)), ((1, 1), (1, 2), (2, 2))):
        blob = iw.jpeg_lossless_bytes(img, predictor=1, sampling=sampling)
        assert _same_as_pil(blob)
        got = image_io.decode_image(blob, "s.jpg")
        hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
        for c, (h, v) in enumerate(sampling):
            plane = got[::vmax // v, ::hmax // h, c]
            rep = np.repeat(np.repeat(plane, vmax // v, 0), hmax // h, 1)[:31, :45]
            assert np.array_equal(got[..., c], rep)


# ---- the native undifferencing ------------------------------------------------------------

@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt", [0, 3])
def test_native_undifferencing_equals_its_plain_version(predictor, pt):
    rng = np.random.default_rng(predictor * 10 + pt)
    for spread in (6, 300, 40000):
        diff = rng.integers(-spread, spread, (9, 23)).astype(np.int32)
        diff[4, 5] = 32768
        for reset in (0, 4):
            want = image_io.jpeg_undifference_reference(diff, predictor, pt, reset)
            got = native.jpeg_undifference(diff, predictor, pt, reset)
            assert got.dtype == np.uint8 and np.array_equal(got, want)


# ---- damaged files ------------------------------------------------------------------------

_FUZZ = r"""
import io, json, sys, warnings
import numpy as np
sys.path.insert(0, sys.argv[1])
from PIL import Image
from wast3d_tpu_torch.utils import image_io

def pil(blob):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None

blob = open(sys.argv[2], "rb").read()
rng = np.random.default_rng(int(sys.argv[3]))
step = int(sys.argv[4])
cases = [blob[:n] for n in range(0, len(blob), step)]
for i in range(400):
    f = bytearray(blob)
    for _ in range(1 + i % 3):
        f[int(rng.integers(0, len(f)))] ^= 1 << int(rng.integers(0, 8))
    cases.append(bytes(f))
out = {"cases": len(cases), "equal": 0, "both_raise": 0, "port_refuses": 0, "differ": [],
       "pil_refuses": [], "bad": []}
for k, case in enumerate(cases):
    want = pil(case)
    try:
        got = image_io.decode_image(case, "fuzz.jpg")
    except ValueError as e:
        if not str(e).startswith("fuzz.jpg: "):
            out["bad"].append(str(e))
        out["both_raise" if want is None else "port_refuses"] += 1
        continue
    except Exception as e:
        out["bad"].append(repr(e))
        continue
    if want is None:
        out["pil_refuses"].append(k)
    elif want.dtype != got.dtype or want.shape != got.shape or want.tobytes() != got.tobytes():
        out["differ"].append(k)
    else:
        out["equal"] += 1
print(json.dumps(out))
"""


@pytest.mark.parametrize("probe,step", [("jpeg_probe_arith_restart.jpg", 1),
                                        ("jpeg_probe_arith_progressive.jpg", 1),
                                        ("jpeg_probe_lossless_restart.jpg", 4)])
def test_seeded_flips_and_truncations_raise_or_equal_pil(probe, step):
    """Prefixes of a probe file (every byte, or every fourth of the larger
    lossless one) and 400 seeded flips of one to three bits: each raises a
    ValueError naming the file or gives PIL's array, in a child process
    with a time limit. No file PIL decodes is refused here."""
    path = FORMATS / probe
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(ROOT), str(path), "24", str(step)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["differ"] == [] and got["pil_refuses"] == [], got
    assert got["port_refuses"] == 0, got
    assert got["equal"] > 150 and got["both_raise"] >= path.stat().st_size // step


def test_marker_in_arithmetic_data_feeds_zeros_and_restarts_recover():
    """A marker inside arithmetic-coded data: zeros from there on (PIL
    decodes), a bad magnitude or run leaves the rest of its restart interval
    untouched, renumbered and missing restart markers resync as libjpeg's
    resync does; each equal to PIL."""
    img = iw.rgb_to_ycc(_image(48, 64, 3, 5))
    blob = iw.jpeg_bytes(img, S420, quality=90, arithmetic=True, restart_interval=2)
    at = [i for i in range(len(blob) - 1) if blob[i] == 0xFF and 0xD0 <= blob[i + 1] <= 0xD7]
    for k, m in ((1, 0xD4), (2, 0xD0), (3, 0xD1)):
        bad = bytearray(blob)
        bad[at[k] + 1] = m
        assert _same_as_pil(bytes(bad))
    assert _same_as_pil(blob[:at[2]] + blob[at[2] + 2:])
    mid = (at[3] + at[4]) // 2
    assert _same_as_pil(blob[:mid] + b"\xff\xd9" + blob[mid + 2:])
    decoded = 0
    for shift in range(0, 64, 3):  # a run of ones: magnitudes and runs overflow
        bad = bytearray(blob)
        bad[at[1] + 2 + shift % 20: at[1] + 6 + shift % 20] = b"\xfe\xfe\xfe\xfe"
        decoded += _same_as_pil(bytes(bad))
    assert decoded > 10
    prog = iw.jpeg_bytes(img, S420, quality=90, arithmetic=True, scans=iw.PROGRESSIVE_3)
    sos = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    for k in (2, 5, 8):  # a scan's data cut in half, its end a marker
        end = sos[k + 1]
        half = (sos[k] + end) // 2
        assert _same_as_pil(prog[:half] + prog[end:])


def test_lossless_data_ending_early_gives_centre_grey_rows():
    """A lossless scan cut by a marker: the rows after it are CENTERJSAMPLE,
    as jdlhuff.c zeroes them and restarts the predictors, with and without
    a point transform."""
    img = _image(24, 40, 3, 6)
    for pt in (0, 2):
        blob = iw.jpeg_lossless_bytes(img, predictor=5, point_transform=pt)
        start = blob.index(b"\xff\xda") + 2 + 12
        cut = blob[:start + (len(blob) - start) // 3] + b"\xff\xd9"
        assert _same_as_pil(cut)
        got = image_io.decode_image(cut, "cut.jpg")
        assert (got[-4:] == 128).all()


# ---- refusals -----------------------------------------------------------------------------

def _retyped(blob, old, new):
    i = blob.index(bytes([0xFF, old]))
    return blob[:i + 1] + bytes([new]) + blob[i + 2:]


def _refused(blob, pattern, name="r.jpg"):
    assert _pil(blob) is None
    with pytest.raises(ValueError, match=rf"^{name}: .*{pattern}"):
        image_io.decode_image(blob, name)


def test_refusals_name_the_marker_or_the_rule():
    img = _image(24, 32, 3, 7)
    lossless = iw.jpeg_lossless_bytes(img, predictor=1)
    _refused(_retyped(lossless, 0xC3, 0xCB), r"SOF11 \(0xFFCB\)")
    arith = iw.jpeg_bytes(iw.rgb_to_ycc(img), S420, arithmetic=True)
    for sof in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        _refused(_retyped(arith, 0xC9, sof), rf"SOF{sof - 0xC0} \(0xFF{sof:02X}\)")
    _refused(iw.jpeg_lossless_bytes(img[..., 0], precision=12), "12-bit")
    _refused(iw.jpeg_lossless_bytes(img, jfif=True), "colour conversion")
    _refused(iw.jpeg_lossless_bytes(img, adobe_transform=1), "colour conversion")
    cmyk = np.concatenate([img, img[..., :1]], axis=2)
    _refused(iw.jpeg_lossless_bytes(cmyk, adobe_transform=2), "YCCK")
    sos = lossless.index(b"\xff\xda") + 4 + 1 + 6
    for off, val, why in ((0, 0, "predictor 0"), (0, 8, "predictor 8"), (1, 1, "Se 1"),
                          (2, 0x10, "Ah 1"), (2, 8, "point transform 8")):
        bad = bytearray(lossless)
        bad[sos + off] = val
        _refused(bytes(bad), f"bad lossless scan .*{why}")
    no_dht = lossless[:2] + b"".join(
        s for s in _segments(lossless) if s[1] != 0xC4) + lossless[lossless.index(b"\xff\xda"):]
    _refused(no_dht, "undefined Huffman table")
    rst = iw.jpeg_lossless_bytes(img, predictor=1, restart_interval=32)
    bad = bytearray(rst)
    bad[rst.index(b"\xff\xdd") + 5] = 16  # half a row of 32 MCUs
    _refused(bytes(bad), "restart interval .* MCU rows")
    tif = iw.tiff_bytes(iw.rgb_to_ycc(img), 6, compression=7, rows_per_strip=8,
                        jpeg=dict(sampling=S420, subsampling=(2, 2), lossless=dict(predictor=1)))
    _refused(tif, "colour conversion", "r.tif")


def _segments(blob):
    out, pos = [], 2
    while blob[pos + 1] != 0xDA:
        n = 2 + (blob[pos + 2] << 8 | blob[pos + 3])
        out.append(blob[pos:pos + n])
        pos += n
    return out


def test_arithmetic_scans_must_fit_pils_read_blocks(monkeypatch):
    """PIL hands libjpeg 64 KiB at a time (`ImageFile.MAXBLOCK`, its default,
    which the JAX package's readers run with; another test file raises it
    for PIL's encoder) and libjpeg's arithmetic decoder cannot wait for
    more: a sequential file of 51 KB decodes, one of 80 KB raises; 64 KiB of
    comment before the frame moves the first block's end, and the file then
    decodes when its scan lies inside the second block."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)
    rng = np.random.default_rng(2)
    com = _segment(0xFE, b"x" * 65533)
    for n, fits in ((160, True), (200, False)):
        img = iw.rgb_to_ycc((rng.random((n, n, 3)) * 255).astype(np.uint8))
        blob = iw.jpeg_bytes(img, ((1, 1),) * 3, quality=95, arithmetic=True)
        assert _same_as_pil(blob) == fits
        if not fits:
            _refused(blob, "64 KiB")
        assert _same_as_pil(blob[:2] + com + blob[2:]) == (len(blob) + len(com) <= 131072)
    huffman = iw.jpeg_bytes(img, ((1, 1),) * 3, quality=95)
    assert len(huffman) > 65536 and _same_as_pil(huffman)  # a Huffman scan suspends


# ---- JPEG in TIFF -----------------------------------------------------------------------

@pytest.mark.parametrize("jpeg,photo,decodes", [
    (dict(sampling=S420, subsampling=(2, 2), arithmetic=True, restart_interval=3), 6, True),
    (dict(sampling=S420, subsampling=(2, 2), arithmetic=True, scans=iw.PROGRESSIVE_3), 6, True),
    (dict(arithmetic=True, dac={0: 0x43, 16: 2}), 2, True),
    (dict(lossless=dict(predictor=4, restart_interval=40)), 2, True),
    (dict(lossless=dict(predictor=7, point_transform=2)), 1, True),
    (dict(sampling=S420, subsampling=(2, 2), lossless=dict(predictor=1)), 6, False)],
    ids=["ycbcr420_arith", "ycbcr420_arith_prog", "rgb_arith_dac", "rgb_lossless",
         "grey_lossless_pt2", "ycbcr420_lossless_refused"])
def test_jpeg_in_tiff_as_pils_libtiff_reads_it(jpeg, photo, decodes):
    """JPEG strips of a TIFF read as PIL's libtiff reads them; libjpeg will
    not turn a lossless stream's YCbCr into RGB."""
    img = _image(40, 40, 3, 8)
    samples = iw.rgb_to_ycc(img) if photo == 6 else img[..., 0] if photo == 1 else img
    blob = iw.tiff_bytes(samples, photo, compression=7, rows_per_strip=16, jpeg=jpeg)
    assert _same_as_pil(blob, "t.tif") == decodes


# ---- datasets and metrics -----------------------------------------------------------------

def test_colmap_scene_of_arith_and_lossless_views_equals_jaxs(tmp_path):
    """The six COLMAP views (arithmetic sequential with DAC and restarts,
    arithmetic progressive, lossless with separate scans, lossless predictor
    7 with a point transform, lossless 4:2:0, arithmetic JPEG-in-TIFF):
    both packages' scenes and cameras alike, each view PIL's decode."""
    from wast3d_tpu.scene import datasets as jds

    src = tmp_path / "colmap"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    views = FORMATS / "colmap_jpeg_arith"
    shutil.copytree(views, src / "images_arith", ignore=shutil.ignore_patterns("*.npy"))
    names = {p.stem: p.name for p in views.iterdir() if p.suffix != ".npy"}
    path = str(src / "sparse" / "0" / "images.bin")
    cm.write_images_binary({k: v._replace(name=names[Path(v.name).stem])
                            for k, v in cm.read_images_binary(path).items()}, path)
    t = tds.read_colmap_scene(str(src), "images_arith", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_arith", eval_split=True)
    cams_t, cams_j = t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras
    assert len(cams_t) == len(cams_j) == 6
    for a, b in zip(cams_t, cams_j):
        assert (a.image_name, a.width, a.height) == (b.image_name, b.width, b.height)
        assert a.image.dtype == b.image.dtype and a.image.tobytes() == b.image.tobytes()
        want = np.load(views / f"{a.image_name}.npy")
        assert a.image.tobytes() == (want.astype(np.float32) / 255.0).tobytes()


def test_metrics_read_an_arith_and_lossless_method_directory_as_jax_does():
    from wast3d_tpu.eval import metrics as jmetrics
    from wast3d_tpu_torch.eval import metrics as tmetrics

    method = FORMATS / "metrics_jpeg_arith"
    a = tmetrics._read_images(str(method / "renders"), str(method / "gt"))
    b = jmetrics._read_images(str(method / "renders"), str(method / "gt"))
    assert a[2] == b[2] == ["00000.jpg", "00001.jpg"]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype == np.float32 and x.tobytes() == y.tobytes()
