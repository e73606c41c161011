"""Damaged and partly refined JPEGs read as PIL reads them (libjpeg-turbo
3.1 behind JpegImagePlugin's own walk over the markers), on the CPU:
`native/jpeg.cpp` and `utils/image_io._jpeg_walk`.

The probe files are the damaged-JPEG census's (`tools/jpeg_flip_census.py`,
written by `tools/make_torch_fixtures.py`). Every damaged file either raises
a ValueError that starts with its name or gives PIL's array (dtype, shape
and bytes); the partly refined files give PIL's block-smoothed array bit for
bit.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.utils import image_io

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
PROBES = ("jpeg_probe_420.jpg", "jpeg_probe_444_restart.jpg", "jpeg_probe_420_progressive.jpg")
SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "444": ((1, 1),) * 3,
             "422": ((2, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
             "grey": ((1, 1),), "grey_h2v2": ((2, 2),)}


def _image(h, w, seed=0):
    """Smooth colour with noise, uint8 YCbCr."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9)], -1)
    return iw.rgb_to_ycc(np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8))


def _pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _same_as_pil(blob, name="case.jpg"):
    """The port gives PIL's array, or both refuse (the port naming the file)."""
    want = _pil(blob)
    if want is None:
        with pytest.raises(ValueError, match=rf"^{name}: "):
            image_io.decode_image(blob, name)
        return False
    got = image_io.decode_image(blob, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return True


# ---- damaged files --------------------------------------------------------------------

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
cases = [("cut", blob[:n]) for n in range(len(blob))]
for i in range(600):
    f = bytearray(blob)
    for _ in range(1 + i % 3):
        f[int(rng.integers(0, len(f)))] ^= 1 << int(rng.integers(0, 8))
    cases.append(("flip", bytes(f)))
out = {"cases": len(cases), "equal": 0, "both_raise": 0, "port_refuses": 0, "differ": [],
       "pil_refuses": [], "bad": []}
for k, (kind, case) in enumerate(cases):
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


@pytest.mark.parametrize("probe", PROBES)
def test_seeded_flips_and_truncations_raise_or_equal_pil(probe):
    """Every prefix of a probe file and 600 seeded flips of one to three
    bits (the census's files): each raises a ValueError naming the file or
    gives PIL's array, in a child process with a time limit. PIL refuses
    every prefix (it wants the data up to EOI); the count of files PIL
    decodes and the port refuses is reported and stays small."""
    path = FORMATS / probe
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(ROOT), str(path), "21"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["differ"] == [] and got["pil_refuses"] == [], got
    assert got["equal"] > 250 and got["both_raise"] >= path.stat().st_size
    print(f"{probe}: {got['port_refuses']} of {got['cases']} files PIL decodes and the port "
          "refuses")
    assert got["port_refuses"] <= 0.01 * got["cases"], got


def test_census_tool_finds_no_breach_on_a_small_file():
    """`tools/jpeg_flip_census.py` over every single-bit flip of a 16x16
    grey baseline file: no breach of the contract, and its table adds up."""
    from tools import jpeg_flip_census as census

    blob = iw.jpeg_bytes(_image(16, 16, 5)[..., 0], SAMPLINGS["grey"], quality=80)
    table, breaches = census.census(blob, workers=1)
    assert breaches == {k: [] for k in breaches}, breaches
    assert sum(map(sum, table.values())) == len(blob) * 8
    assert table["entropy-coded data"][0] > 0
    assert "| **total** |" in census.render("small.jpg", blob, table)


def _entropy_start(blob):
    sos = blob.index(b"\xff\xda")
    return sos + 2 + (blob[sos + 2] << 8 | blob[sos + 3])


def test_bad_huffman_codes_restart_resyncs_and_markers_in_the_data():
    """libjpeg-turbo's recoveries, each against PIL: a code no table holds
    (17 bits of symbol 0), a restart marker renumbered (resynced), a marker
    in the middle of the data (zeros, then the rest of the segment grey),
    and a scan's data ending in an unknown marker."""
    img = _image(40, 56, 7)
    base = iw.jpeg_bytes(img, SAMPLINGS["420"], quality=90)
    start = _entropy_start(base)
    ones = base[:start + 20] + b"\xfe\xfe\xfe\xfe" + base[start + 24:]  # 1-bits: no code
    assert _same_as_pil(ones)
    rst = iw.jpeg_bytes(img, SAMPLINGS["444"], quality=90, restart_interval=2)
    at = [i for i in range(len(rst) - 1) if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    for k, m in ((1, 0xD3), (2, 0xD0), (3, 0xD1), (0, 0xD7)):
        bad = bytearray(rst)
        bad[at[k] + 1] = m
        assert _same_as_pil(bytes(bad))
    missing = rst[:at[2]] + rst[at[2] + 2:]  # a restart marker dropped
    assert _same_as_pil(missing)
    mid = len(base) // 2
    assert _same_as_pil(base[:mid] + b"\xff\xd9" + base[mid + 2:])
    assert not _same_as_pil(base[:mid] + b"\xff\x02" + base[mid + 2:])  # unknown marker


def test_tables_as_libjpeg_checks_them():
    """Annex K's tables stand in for a sequential file without DHT (not a
    progressive one); a DC table with a symbol over 15, or a code of all
    ones, is refused when a scan uses it; a sequential scan's odd Ss / Se /
    Ah / Al are only warned about."""
    img = _image(24, 32, 9)
    for scans in (None, iw.PROGRESSIVE_3):
        blob = iw.jpeg_bytes(img, SAMPLINGS["420"], quality=85, scans=scans)
        no_dht, pos = blob[:2], 2
        while blob[pos + 1] != 0xDA:
            n = 2 + (blob[pos + 2] << 8 | blob[pos + 3])
            if blob[pos + 1] != 0xC4:
                no_dht += blob[pos:pos + n]
            pos += n
        assert _same_as_pil(no_dht + blob[pos:]) == (scans is None)
    blob = bytearray(iw.jpeg_bytes(img, SAMPLINGS["420"], quality=85))
    dht = blob.index(b"\xff\xc4")
    big = bytearray(blob)
    big[dht + 5 + 16 + 11] = 16  # the DC table's last symbol: 16
    assert not _same_as_pil(bytes(big))
    counts = bytearray(blob)
    counts[dht + 5] = 2  # two 1-bit codes: the all-ones code is taken
    assert not _same_as_pil(bytes(counts))
    sos = blob.index(b"\xff\xda")
    odd = bytearray(blob)
    odd[sos + 2 + 2 + 1 + 6:sos + 2 + 2 + 1 + 9] = b"\x01\x20\x11"
    assert _same_as_pil(bytes(odd))


def test_pils_marker_walk_refusals_raise():
    """What JpegImagePlugin refuses before libjpeg runs: a third byte other
    than FF, a marker it does not know, a DQT table cut short, a JFIF APP0
    shorter than its version, a SOF of 12-bit samples or 2 components, a
    segment past the end of the file, no SOS."""
    blob = iw.jpeg_bytes(_image(16, 24, 2), SAMPLINGS["420"], quality=85)
    dqt, app0, sof = blob.index(b"\xff\xdb"), blob.index(b"\xff\xe0"), blob.index(b"\xff\xc0")
    cases = {"third byte": b"\xff\xd8\x00" + blob[3:],
             "unknown marker": blob[:2] + b"\xff\x05\x00\x02" + blob[2:],
             "short dqt": blob[:dqt + 2] + b"\x00\x43\x10" + blob[dqt + 5:],
             "short jfif": blob[:app0 + 2] + b"\x00\x07JFIF\x00" + blob[app0 + 18:],
             "12-bit": blob[:sof + 4] + b"\x0c" + blob[sof + 5:],
             "2 components": blob[:sof + 9] + b"\x02" + blob[sof + 10:],
             "past the end": blob[:app0 + 2] + b"\xff\xf0",
             "no sos": blob[:blob.index(b"\xff\xda")]}
    for what, case in cases.items():
        assert _pil(case) is None, what
        with pytest.raises(ValueError, match=r"^w\.jpg: "):
            image_io.decode_image(case, "w.jpg")
    lenient = blob[:2] + b"\xff\xfe\x00\x05abc" + b"\x00\x00" + blob[2:]  # a COM, junk after it
    assert _same_as_pil(lenient)


def test_truncated_files_raise_as_pil():
    """A sequential file cut in its data raises where PIL raises: where
    libjpeg's bit buffer, which reads up to 57 bits ahead, runs out before
    the last MCU; a file cut only in its last bytes may still decode."""
    for size, seed in (((16, 24), 4), ((64, 80), 5)):
        blob = iw.jpeg_bytes(_image(*size, seed), SAMPLINGS["444"], quality=85)
        refused = 0
        for n in range(_entropy_start(blob), len(blob)):
            refused += not _same_as_pil(blob[:n], "t.jpg")
        assert refused > (len(blob) - _entropy_start(blob)) // 2
        with pytest.raises(ValueError, match=r"^t\.jpg: .*truncated"):
            image_io.decode_image(blob[:_entropy_start(blob) + 3], "t.jpg")


# ---- block smoothing -------------------------------------------------------------------

CUTS = {"dc": 1, "dc_ac1": 2, "unrefined": -1}


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("kind", sorted(SAMPLINGS))
@pytest.mark.parametrize("size", [(37, 53), (8, 8), (64, 96)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_partly_refined_progressive_equals_pil(size, kind, cut):
    """Files that end after the DC scans, after the first AC band, or with
    every scan but the last refinement: libjpeg smooths their blocks
    (decompress_smooth_data), and the port gives PIL's array bit for bit."""
    img = _image(*size, seed=size[0] + len(kind))
    grey = kind.startswith("grey")
    script = iw.PROGRESSIVE_1 if grey else iw.PROGRESSIVE_3
    blob = iw.jpeg_bytes(img[..., 0] if grey else img, SAMPLINGS[kind], quality=75,
                         scans=script[:CUTS[cut]])
    assert _same_as_pil(blob)


@pytest.mark.parametrize("name", ["jpeg_partial_dc", "jpeg_partial_dc_ac1",
                                  "jpeg_partial_unrefined", "jpeg_partial_grey_dc",
                                  "jpeg_damaged_huffman", "jpeg_damaged_three_bits",
                                  "jpeg_damaged_restart", "jpeg_damaged_marker"])
def test_committed_damaged_and_partial_fixtures_are_pils(name):
    """The committed files the card checks: PIL's array in the .npy, the
    port's equal to it, and the file really damaged or partly refined."""
    path = FORMATS / f"{name}.jpg"
    want = np.load(path.with_suffix(".npy"))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(image_io.read_image(str(path)), want)
    blob = path.read_bytes()
    if "partial" in name:
        assert blob.count(b"\xff\xda") < (6 if "grey" in name else 10)
    else:
        assert b"\xff\xd9" in blob[:-2] or blob.count(b"\xff\xda") == 1


def test_scene_size_damaged_and_unrefined_jpegs_equal_pils_decode():
    """The 1296x832 files of `tests/torch_fixtures/codecs/` decode to PIL's
    committed decode (`pil_decode/<name>.png`), and so does PIL."""
    from wast3d_tpu_torch.utils.png import read_png

    fixtures = ROOT / "tests" / "torch_fixtures"
    for name in ("scene_1296x832_damaged", "scene_1296x832_unrefined"):
        path = fixtures / "codecs" / f"{name}.jpg"
        want = read_png(str(fixtures / "pil_decode" / f"{name}.png"))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
        got = image_io.read_image(str(path))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---- the IDCT -----------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [3, 60, 900, 12000, 32767])
def test_native_idct_equals_its_plain_version(scale):
    """The SIMD islow arithmetic (16-bit dequantisation and sums, saturating
    packs, the DC-only shortcut) in `jpeg.cpp` against
    `image_io.jpeg_idct_reference`, with coefficients and quantisers up to
    overflow."""
    rng = np.random.default_rng(scale)
    coef = np.clip(rng.standard_normal((600, 64)) * scale, -32768, 32767).astype(np.int16)
    coef[::3, 8:] = 0  # rows 1-7 zero: the shortcut
    coef[1::5] = np.where(rng.random((len(coef[1::5]), 64)) < 0.9, 0, coef[1::5])
    qt = rng.integers(1, 65536 if scale > 1000 else 120, 64).astype(np.uint16)
    np.testing.assert_array_equal(native.jpeg_idct(coef, qt),
                                  image_io.jpeg_idct_reference(coef, qt))
