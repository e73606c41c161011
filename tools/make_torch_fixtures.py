#!/usr/bin/env python3
"""Write the port's committed test fixtures under `tests/torch_fixtures/`.

    python3 tools/make_torch_fixtures.py             # everything
    python3 tools/make_torch_fixtures.py --formats   # only the image-format files
    python3 tools/make_torch_fixtures.py --raster    # only the TIFF / Netpbm / TGA / QOI ones
    python3 tools/make_torch_fixtures.py --codecs    # only the damaged-JPEG and TIFF-codec ones
    python3 tools/make_torch_fixtures.py --readers   # only the ZSTD TIFF, ICO ... Sun ones
    python3 tools/make_torch_fixtures.py --jpeg2000  # only the JPEG 2000 and ICNS ones
    python3 tools/make_torch_fixtures.py --jpeg-arith  # only the arithmetic / lossless JPEGs
    python3 tools/make_torch_fixtures.py --plugins   # only old-style JPEG TIFF, BLP ... XVThumb

Needs PIL (it writes the JPEGs and records PIL's decode of each), so it runs
where the tests run, not on the card. It writes, from seeds:

- `colmap_jpeg/`: a COLMAP scene of 6 views at 200x150 around a procedural
  scene of coloured Gaussians; `images/view_<i>.jpg` (quality 90, PIL's
  default 4:2:0) are renders of that scene by the port's plain renderer on
  the CPU, and `sparse/0/{cameras,images,points3D}.bin` come from the port's
  COLMAP writers (PINHOLE cameras; points: the Gaussians' centres and
  colours, jittered);
- `jpeg/`: a 1296x832 render (the size of a 360-scene `images_4` view) at
  quality 85, 4:2:0, and a 250x131 crop at quality 95, 4:4:4;
- `pil_decode/<name>.png`: PIL's decode of every JPEG above, for the card,
  which has no PIL;
- progressive twins (PIL's `progressive=True`, the same quality and
  sampling, so the same coefficients): `jpeg/<name>_progressive.jpg` of the
  two JPEGs above (the crop's with restart markers every 3 blocks) and
  `colmap_jpeg/images_progressive/view_<i>.jpg`; PIL decodes each to its
  twin's pixels (checked here), so `pil_decode/<name>.png` is its decode;
- `png/`: an Adam7 RGBA PNG at 67x45 and an all-Paeth RGBA PNG at 200x150
  (`utils/png.encode_png`; PIL does not write either), crops of the render
  with a procedural alpha, and `pil_decode/<name>.png`, PIL's decode of
  each;
- `resize/`: PIL's default resize (bicubic) of the 1296x832 JPEG's decode
  to 648x416 and 432x277, and of a 1700x96 strip (the decode with its first
  404 columns appended, first 96 rows) to 1600x90, the size
  `build_cameras` gives a 1700-wide image at `-r -1`;
and under `tests/format_fixtures/`, from the 1296x832 JPEG's decode
(`--formats` writes only these):

- one small file (at most 64x48) of each kind
  `utils/image_io.read_image` reads, cut from the 1296x832 decode
  (`FORMAT_CASES`): PNG at every colour type and bit depth (palette with
  tRNS, Adam7, a bad IDAT CRC), JPEG at 4:4:0, 4:1:1, 3:1, 1:4 and mixed
  sampling, CMYK, YCCK, Adobe RGB (`tools/image_writers.jpeg_bytes`, since
  PIL writes none of these) and a progressive CMYK file from PIL, BMP
  (palettes, RLE8 / RLE4, 16- to 32-bit, bitfields, top-down) and TIFF
  (L, LA, RGB(A), 16-bit, big-endian, PackBits / LZW / Deflate, predictor
  2, and files from PIL's own writer); beside each, `<name>.npy`,
  `np.asarray(PIL.Image.open(f))` with its dtype;
- `colmap_440/view_<i>.jpg`: PIL's decode of each `colmap_jpeg` view
  re-encoded at 4:4:0, quality 90 (a portrait rotated without
  re-encoding), with PIL's decode beside it as `view_<i>.npy`; a copy of
  `colmap_jpeg` with these as its images is a COLMAP scene;
- `metrics_jpeg/{renders,gt}/0000<i>.jpg`: a method directory of two
  64x48 views, renders from PIL (4:2:0) and ground truths at 4:4:0 and
  4:1:1, with PIL's decodes in `metrics_jpeg/pil/`;
- WebP and GIF (`webp_gif_cases`): lossy at several qualities, methods and
  sizes (1x1, 1xN, Nx1, 17x13) and with each VP8 option PIL's writer does
  not reach (the simple filter, sharpness 1-7, one segment, 2-8 token
  partitions; `tools/webp_encoder.py`), lossy with an ALPH chunk of each
  compression and filter, lossless at effort 0 and 100, exact, near-lossless
  and from 2, 4, 16 and 256 colours, animations of 2 and 3 frames (one with a
  first frame smaller than its canvas, at an offset), and GIF from P, L and
  1-bit images, interlaced, with transparency, with a local colour table and
  with a first image smaller than its screen (`tools/image_writers.gif_bytes`);
- `colmap_webp/view_<i>.webp`: the `colmap_jpeg` views (PIL's decode) as
  lossy WebP at quality 90, PIL's decode beside each as `view_<i>.npy`;
- `metrics_webp/{renders,gt}/0000<i>.webp`: a method directory of two 64x48
  views (lossy renders; a lossless and a lossy-with-alpha ground truth),
  PIL's decodes in `metrics_webp/pil/`;
- TIFF layouts and sample kinds, Netpbm, TGA and QOI (`raster_cases`,
  written alone by `--raster`): tiles with partial edge tiles, separate
  planes in strips and tiles, fill order 2, bilevel, palette at 1/2/4/8
  bits, CMYK, 32-bit float (predictor 3), 32-bit and signed 16-bit integers,
  JPEG in RGB and in YCbCr at 4:2:0 / 4:2:2 / 4:4:4 with shared or inline
  tables, an Orientation tag; P1-P6 at maxvals 1000, 4095 and 65535, Pf in
  both byte orders; TGA types 1/2/3/9/10/11 at 1-32 bits, colour maps from
  a first entry, ID fields, both origins, run-length packets within rows
  and literals across rows; QOI RGB and RGBA, from PIL too;
- `metrics_tga_ppm/{renders,gt}/`: a method directory of two 64x48 views,
  `00000.tga` (run-length, 24-bit) and `00001.ppm` (P6), PIL's decodes in
  `metrics_tga_ppm/pil/`;
- damaged and partly refined JPEGs and TIFF codecs (`codec_cases`, written
  alone by `--codecs`): the damaged-JPEG census's three probe files (a
  32x48 4:2:0 baseline, a 4:4:4 baseline with a restart every 4 MCUs, a
  progressive 4:2:0 with libjpeg's scan script; `tools/jpeg_flip_census.py`),
  progressive files that end after the DC scans, after the first AC band
  and before the last refinement (and a grey one after its DC scan),
  damaged files PIL decodes (entropy-coded bits flipped, a restart marker
  renumbered, an EOI in the middle of the data), CCITT bilevel TIFFs (RLE,
  Group 3 1-D and 2-D, with fill bits, Group 4; PIL's coding of each strip,
  both photometrics and fill orders), LZMA, BigTIFF, YCbCr at every
  subsampling libtiff reads (LZW, Deflate, separate planes, uncompressed
  planes, ReferenceBlackWhite and YCbCrCoefficients), CIELab and 12-bit
  grey; `colmap_codecs/view_<i>`: the first three COLMAP views as a damaged
  JPEG, a partly refined JPEG and a YCbCr 4:2:0 LZW TIFF; and
  `tests/torch_fixtures/codecs/`: the 1296x832 view damaged (three bits of
  PIL's JPEG) and partly refined (`jpeg_bytes`, every scan but the last),
  with PIL's decode of each in `pil_decode/<name>.png`;
- ZSTD TIFF and the small readers (`reader_cases`, written alone by
  `--readers`): ZSTD TIFFs from PIL's libtiff (RGB in one strip and in
  many, L, RGBA, 16-bit, predictor 2, 32-bit float with predictor 3) and
  from `tiff_bytes` with the `zstandard` package (tiles, separate planes,
  big-endian, frames cut into 1 KiB blocks, and frames built by hand with
  raw, RLE and RLE-literal blocks), together meeting every block, literals,
  Huffman-weights and sequence-table kind of the format; YCbCr in tiles
  (1x1, 2x1, 2x2, 4x2, 4x4 under ZSTD, LZW, Deflate or PackBits, separate
  planes); ICO (PIL's PNG entries, DIB entries at 1, 4, 8, 24 and 32 bits
  with AND masks, several sizes), CUR (1-, 8-, 24- and 32-bit), DDS in every
  pixel format PIL reads (its own DXT1 / DXT3 / DXT5 / BC2 / BC3 / BC5 and
  uncompressed files, and seeded random BCn blocks in DDS headers:
  BC1-BC7, BC5 and BC6H signed, fourCC and DXGI), PSD (raw and PackBits in
  every mode), SGI (PIL's and run-length at 8 and 16 bits), PCX (PIL's, and
  2- and 4-plane 1-bit, odd strides), Sun raster (every depth, raw and
  run-length, colour maps); `colmap_readers/view_<i>`: the six COLMAP views
  as a ZSTD TIFF, a tiled YCbCr ZSTD TIFF, PSD, SGI, PCX and Sun raster;
  `metrics_zstd_psd/`: a method directory of a ZSTD TIFF and a PSD view;
  and `tests/torch_fixtures/zstd/`: the 1296x832 view as ZSTD TIFFs from
  PIL, in one strip and in PIL's default strips, with the dtype, shape and
  SHA-256 of PIL's decode of seeded random BC7 and BC1 blocks at 1296x832
  in `pil_decode/scene_1296x832_{bc7,bc1}_dds.json`;
- arithmetic-coded and lossless JPEG (`jpeg_arith_cases`, written alone by
  `--jpeg-arith`): PIL's JPEG of the crop transcoded coefficient for
  coefficient to SOF9 (with DAC and a restart interval) and SOF10, and
  `tools/image_writers` files of every mode (4:4:4 with DAC, grey with
  restarts, Adobe RGB, CMYK, YCCK, progressive with restarts and DAC,
  partly refined ones, damaged ones PIL decodes; lossless at each predictor,
  a point transform, restarts, grey, 4:2:0, 4:1:1, a scan a component,
  the restart-inside-an-iMCU-row case, Adobe RGB ids, CMYK, damaged), the
  census's three new probes, and JPEG-in-TIFF arithmetic-coded (YCbCr
  4:2:0, progressive tiles) and lossless (RGB, grey with a point
  transform); `colmap_jpeg_arith/view_<i>`: the six COLMAP views as an
  arithmetic-coded JPEG with DAC and restarts, an arithmetic-coded
  progressive one, lossless files with a scan a component, with predictor
  7 and a point transform, and at 4:2:0, and an arithmetic-coded
  JPEG-YCbCr TIFF (a one-channel view does not train in either package);
  `metrics_jpeg_arith/`: a method directory of arithmetic-coded renders
  and arithmetic progressive / lossless ground truths; and
  `tests/torch_fixtures/jpeg_arith/` (`.jpeg`, which the globs over
  `*.jpg` there skip): the 1296x832 JPEG transcoded to SOF9 and SOF10 (each
  under PIL's 64 KiB read block) and its decode as a lossless file, each
  with PIL's hash in `pil_decode/<name>_jpeg.json`;
and, with `--formats` too, `tests/torch_fixtures/webp/`: the 1296x832 view
as lossy WebP at quality 90 (PIL's decode in
`pil_decode/scene_1296x832_q90_webp.png`) and an 800x800 RGBA lossless WebP
of the view's top-left corner with the green of its top-right corner as
alpha, which decodes to that source exactly; and, with `--formats` or
`--raster`, `tests/torch_fixtures/tiff/scene_1296x832_jpeg_ycbcr420_tiled.tif`
(the view as JPEG in YCbCr 4:2:0, 256x256 tiles, quality 90) with the dtype,
shape and SHA-256 of PIL's array of it in
`pil_decode/scene_1296x832_jpeg_ycbcr420_tiled_tif.json`.
"""

from __future__ import annotations

import io
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_fixtures")
FORMATS = os.path.join(ROOT, "tests", "format_fixtures")
VIEWS, W, H = 6, 200, 150
FOCAL = 180.0


def procedural_scene(n=3000, seed=7):
    from wast3d_tpu_torch.core.sh import rgb_to_sh
    from wast3d_tpu_torch.scene.gaussians import from_arrays

    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * np.array([0.8, 0.5, 0.8])
    rgb = 0.5 + 0.4 * np.stack([np.sin(2 * xyz[:, 0]), np.cos(3 * xyz[:, 1]),
                                np.sin(xyz[:, 2] + 1)], 1)
    return from_arrays(
        xyz=xyz, features_dc=rgb_to_sh(rgb.astype(np.float32))[:, None, :],
        features_rest=np.zeros((n, 15, 3), np.float32),
        scaling=np.log(rng.uniform(0.02, 0.08, (n, 3))),
        rotation=np.tile([[1.0, 0, 0, 0]], (n, 1)),
        opacity=np.log(0.8 / 0.2) * np.ones((n, 1)), device="cpu"), xyz, rgb


def rotmat2qvec(R):
    """COLMAP's rotmat2qvec: (w, x, y, z) with w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def look_at(eye):
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, -1.0, 0.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])  # world -> camera rows


def render(scene, R_wc, t, w, h, focal):
    from wast3d_tpu_torch.core.camera import focal2fov, make_camera
    from wast3d_tpu_torch.ops.rasterizer import api

    cam = make_camera(R=R_wc.T, t=t, fovx=focal2fov(focal, w), fovy=focal2fov(focal, h),
                      width=w, height=h, device="cpu")
    with torch.no_grad():
        out = api.render(cam, scene, torch.tensor([0.1, 0.1, 0.15]), device="cpu",
                         settings=api.RasterizeSettings(renderer="tiled"))
    return (np.clip(out["render"].numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)


def save_jpeg(path, img, decodes, progressive=None, twin_kw=None, **kw):
    """A baseline JPEG and PIL's decode of it; with `progressive` (a path),
    its progressive twin too (`twin_kw` added to its options), checked to
    decode to the same pixels."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    name = os.path.splitext(os.path.basename(path))[0]
    decoded = np.asarray(Image.open(path))
    write_png_up(os.path.join(decodes, name + ".png"), decoded)
    if progressive:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", progressive=True, **kw, **(twin_kw or {}))
        with open(progressive, "wb") as f:
            f.write(buf.getvalue())
        if not np.array_equal(np.asarray(Image.open(progressive)), decoded):
            raise AssertionError(f"{progressive}: PIL's decode differs from its twin's")
    return decoded


def alpha_channel(h, w):
    """A procedural alpha with 0 and 255 runs and ramps between them."""
    y, x = np.mgrid[0:h, 0:w]
    a = 127.5 + 160 * np.sin(x / 9.0) * np.cos(y / 7.0)
    return np.clip(a, 0, 255).astype(np.uint8)


def write_png_up(path, img):
    """An 8-bit grey, grey+alpha, RGB or RGBA PNG whose rows all use the Up
    filter (type 2), at zlib level 9: about half the bytes of
    `utils/png.write_png`'s unfiltered rows on these images."""
    import struct
    import zlib

    img = img if img.ndim == 3 else img[:, :, None]
    h, w, c = img.shape  # grey, grey+alpha, RGB or RGBA
    rows = img.reshape(h, w * c).astype(np.int16)
    up = (rows - np.concatenate([np.zeros((1, w * c), np.int16), rows[:-1]])) & 0xFF
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up.astype(np.uint8)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)) + chunk(b"IEND", b""))


def _ycc(rgb):
    from tools.image_writers import rgb_to_ycc

    return rgb_to_ycc(rgb)


def format_cases(src):
    """(name, bytes) of every `formats/` file, cut from `src` (uint8 RGB)."""
    from PIL import Image

    from tools.image_writers import bmp_bytes, jpeg_bytes, png_bytes, tiff_bytes

    rng = np.random.default_rng(17)
    crop = src[300:348, 500:564]  # 48 x 64
    grey = crop.mean(axis=2).astype(np.uint8)
    alpha = alpha_channel(48, 64)
    rgba = np.concatenate([crop, alpha[..., None]], axis=2)
    wide16 = (rgba.astype(np.uint16) * 257 + rng.integers(0, 257, rgba.shape)).astype(np.uint16)
    pal = rng.integers(0, 256, (256, 3))
    idx = (grey // 16).astype(np.uint8)  # 16 levels: palette indices
    out = []

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    # PNG: (name, samples, bits, colour type, options)
    for name, vals, bits, ctype, kw in (
            ("png_grey1_adam7", grey[:17, :31] > 120, 1, 0, dict(interlace=True)),
            ("png_grey2", grey[:20, :33] >> 6, 2, 0, dict(filter_type=1)),
            ("png_grey4_adam7", grey[:21, :29] >> 4, 4, 0, dict(interlace=True, filter_type=4)),
            ("png_grey16", wide16[..., 0], 16, 0, dict(filter_type=4)),
            ("png_grey16_adam7", wide16[:13, :17, 0], 16, 0, dict(interlace=True)),
            ("png_rgb16", wide16[..., :3], 16, 2, dict(filter_type=3)),
            ("png_rgba16", wide16, 16, 6, dict(filter_type=4)),
            ("png_rgba16_adam7", wide16[:45, :37], 16, 6, dict(interlace=True, filter_type=2)),
            ("png_la16", wide16[:30, :40, [0, 3]], 16, 4, dict(filter_type=4)),
            ("png_pal1", idx[:9, :23] & 1, 1, 3, dict(palette=pal[:2])),
            ("png_pal2_trns", idx[:11, :19] & 3, 2, 3,
             dict(palette=pal[:4], trns=b"\x00\x80", filter_type=1)),
            ("png_pal4_adam7", idx[:31, :45], 4, 3, dict(palette=pal[:16], interlace=True)),
            ("png_pal8_trns", grey, 8, 3, dict(palette=pal, trns=bytes(range(0, 256, 2)),
                                                  filter_type=4)),
            ("png_rgb_trns", crop, 8, 2, dict(trns=b"\x00\x10\x00\x20\x00\x30",
                                                extra=[(b"gAMA", b"\x00\x00\xb1\x8f")])),
            ("png_rgba_bad_idat_crc", rgba, 8, 6, dict(bad_idat_crc=True, idat_parts=3)),
            ("png_grey16_width1", wide16[:, :1, 0], 16, 0, dict(filter_type=4))):
        out.append((name + ".png", png_bytes(vals.astype(np.uint16 if bits == 16 else np.uint8),
                                             bits, ctype, **kw)))

    # JPEG: samplings libjpeg-turbo upsamples with h1v2 (4:4:0), int_upsample
    # (4:1:1, 3:1, 1:4) and a mix; 4 components; Adobe RGB.
    ycc = _ycc(crop)
    for name, img, sampling, kw in (
            ("jpeg_440", ycc, ((1, 2), (1, 1), (1, 1)), {}),
            ("jpeg_440_odd", ycc[:29, :37], ((1, 2), (1, 1), (1, 1)), {}),
            ("jpeg_440_width1", ycc[:, :1], ((1, 2), (1, 1), (1, 1)), {}),
            ("jpeg_411", ycc, ((4, 1), (1, 1), (1, 1)), {}),
            ("jpeg_411_odd", ycc[:17, :45], ((4, 1), (1, 1), (1, 1)), {}),
            ("jpeg_h3v1", ycc[:33, :47], ((3, 1), (1, 1), (1, 1)), {}),
            ("jpeg_h1v4", ycc[:45, :27], ((1, 4), (1, 1), (1, 1)), {}),
            ("jpeg_mixed", ycc[:41, :59], ((2, 2), (2, 1), (1, 2)), {}),
            ("jpeg_grey_h2v2", ycc[:, :, 0], ((2, 2),), {}),
            ("jpeg_cmyk", np.concatenate([255 - crop, alpha[..., None]], 2),
             ((1, 1),) * 4, dict(adobe_transform=0)),
            ("jpeg_cmyk_no_adobe", np.concatenate([crop, alpha[..., None]], 2)[:21, :30],
             ((2, 1), (1, 1), (1, 1), (2, 1)), {}),
            ("jpeg_ycck", np.concatenate([_ycc(255 - crop), alpha[..., None]], 2),
             ((2, 2), (1, 1), (1, 1), (2, 2)), dict(adobe_transform=2)),
            ("jpeg_ycck_440", np.concatenate([_ycc(crop), 255 - alpha[..., None]], 2)[:37],
             ((1, 2), (1, 1), (1, 1), (1, 2)), dict(adobe_transform=2)),
            ("jpeg_rgb_adobe", crop[:23, :50], ((1, 1),) * 3, dict(adobe_transform=0))):
        out.append((name + ".jpg", jpeg_bytes(img, sampling, quality=85, **kw)))
    out.append(("jpeg_cmyk_progressive.jpg",
                pil(Image.fromarray(crop).convert("CMYK"), "JPEG", quality=90, progressive=True)))

    # BMP
    bw = np.array([[0, 0, 0], [255, 255, 255]])
    greys = np.repeat(np.arange(256)[:, None], 3, axis=1)
    for name, blob in (
            ("bmp_pal1", bmp_bytes(idx[:13, :29] & 1, 1, pal[:2])),
            ("bmp_bw1", bmp_bytes(grey[:13, :29] > 120, 1, bw)),
            ("bmp_pal4", bmp_bytes(idx[:, :37], 4, pal[:16])),
            ("bmp_pal8", bmp_bytes(grey, 8, pal)),
            ("bmp_grey8_topdown", bmp_bytes(grey[:, :43], 8, greys, top_down=True)),
            ("bmp_rle8", bmp_bytes(idx * 16, 8, pal, compression=1)),
            ("bmp_rle4_topdown", bmp_bytes(idx[:, :45], 4, pal[:16], compression=2,
                                           top_down=True)),
            ("bmp_rgb555", bmp_bytes(crop[:, :31], 16)),
            ("bmp_rgb565", bmp_bytes(crop[:, :31], 16, compression=3,
                                     masks=(0xF800, 0x7E0, 0x1F))),
            ("bmp_rgb24", bmp_bytes(crop[:, :41], 24)),
            ("bmp_rgb24_width1", bmp_bytes(crop[:, :1], 24, top_down=True)),
            ("bmp_rgbx32", bmp_bytes(rgba, 32)),
            ("bmp_bgra32_v4", bmp_bytes(rgba, 32, compression=3,
                                        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                        header_size=108)),
            ("bmp_abgr32_v2", bmp_bytes(rgba[:30, :33], 32, compression=3,
                                        masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                                        header_size=56, top_down=True)),
            ("bmp_pil_rgba", pil(Image.fromarray(rgba[:25, :35]), "BMP")),
            ("bmp_pil_p", pil(Image.fromarray(crop).quantize(12), "BMP"))):
        out.append((name + ".bmp", blob))

    # TIFF
    smooth = crop.copy()
    for name, vals, photometric, kw in (
            ("tif_l_none", grey[:, :33], 1, {}),
            ("tif_l_packbits_strips", grey, 1, dict(compression=32773, rows_per_strip=5)),
            ("tif_l_white_lzw", grey[:21], 0, dict(compression=5)),
            ("tif_la_lzw_pred", np.stack([grey, alpha], 2), 1,
             dict(compression=5, predictor=2, extra_samples=(2,))),
            ("tif_rgb_lzw_pred", smooth, 2, dict(compression=5, predictor=2, rows_per_strip=16)),
            ("tif_rgb_mm_deflate", smooth[:19, :51], 2, dict(compression=8, byteorder=">")),
            ("tif_rgba_deflate_pred", rgba, 2, dict(compression=32946, predictor=2,
                                                    extra_samples=(2,))),
            ("tif_rgba_associated", rgba, 2, dict(compression=5, extra_samples=(1,))),
            ("tif_rgbx", rgba[:, :29], 2, dict(compression=32773, extra_samples=(0,))),
            ("tif_i16_lzw_pred", wide16[..., 0], 1, dict(compression=5, predictor=2)),
            ("tif_i16_mm", wide16[:27, :, 0], 1, dict(byteorder=">", rows_per_strip=7)),
            ("tif_rgb16_deflate_pred", wide16[..., :3], 2, dict(compression=8, predictor=2)),
            ("tif_rgba16_mm_lzw", wide16[:33], 2, dict(compression=5, byteorder=">",
                                                      extra_samples=(2,))),
            ("tif_rgba16_associated", wide16[:20, :20], 2, dict(extra_samples=(1,)))):
        out.append((name + ".tif", tiff_bytes(vals, photometric, **kw)))
    out.append(("tif_pil_rgba_lzw.tif", pil(Image.fromarray(rgba[:40, :50]), "TIFF",
                                            compression="tiff_lzw")))
    out.append(("tif_pil_rgb_packbits.tif", pil(Image.fromarray(crop[:31]), "TIFF",
                                                compression="packbits")))
    return out + webp_gif_cases(crop, alpha)


def webp_gif_cases(crop, alpha):
    """(name, bytes) of the WebP and GIF files (module docstring), from the
    48x64 crop and its alpha."""
    from PIL import Image

    from tools import webp_encoder as we
    from tools.image_writers import gif_bytes

    rgba = np.concatenate([crop, alpha[..., None]], axis=2)
    grey = crop.mean(axis=2).astype(np.uint8)
    out = []

    def pil(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    rgb_im = Image.fromarray(crop)
    for name, blob in (
            ("webp_lossy_q5", pil(rgb_im, "WEBP", quality=5)),
            ("webp_lossy_q50", pil(rgb_im, "WEBP", quality=50)),
            ("webp_lossy_q90_m0", pil(rgb_im, "WEBP", quality=90, method=0)),
            ("webp_lossy_q100_m6", pil(rgb_im, "WEBP", quality=100, method=6)),
            ("webp_lossy_1x1", pil(Image.fromarray(crop[:1, :1]), "WEBP", quality=80)),
            ("webp_lossy_1x37", pil(Image.fromarray(crop[:1, :37]), "WEBP", quality=80)),
            ("webp_lossy_29x1", pil(Image.fromarray(crop[:29, :1]), "WEBP", quality=80)),
            ("webp_lossy_17x13", pil(Image.fromarray(crop[:17, :13]), "WEBP", quality=80)),
            ("webp_lossy_from_l", pil(Image.fromarray(grey), "WEBP", quality=70)),
            ("webp_lossy_opaque_rgba", pil(Image.fromarray(np.concatenate(
                [crop, np.full_like(alpha[..., None], 255)], 2)), "WEBP", quality=70)),
            ("webp_lossy_simple_f0", we.encode(crop, filter_type=0, filter_strength=0)),
            ("webp_lossy_simple_f100", we.encode(crop, filter_type=0, filter_strength=100,
                                                 filter_sharpness=6)),
            *((f"webp_lossy_sharp{k}", we.encode(crop[:40, :40 + k], filter_strength=80,
                                                 filter_sharpness=k)) for k in range(1, 8)),
            ("webp_lossy_seg1", we.encode(crop, segments=1, quality=60)),
            ("webp_lossy_seg2_sns100", we.encode(crop, segments=2, sns_strength=100)),
            ("webp_lossy_parts2", we.encode(crop, partitions=1, method=0)),
            ("webp_lossy_parts4", we.encode(crop, partitions=2, method=1, quality=95)),
            ("webp_lossy_parts8", we.encode(crop, partitions=3, method=2, filter_type=0,
                                            filter_strength=40)),
            ("webp_alpha_pil", pil(Image.fromarray(rgba), "WEBP", quality=80)),
            ("webp_alpha_enc_raw", we.encode(rgba, alpha_compression=0)),
            ("webp_alpha_enc_q50", we.encode(rgba, alpha_quality=50, alpha_filtering=2)),
            *((f"webp_alpha_{c}_{f}", we.with_alpha(we.encode(crop[:31, :47], quality=60),
                                                    we.alpha_chunk(alpha[:31, :47], ci, fi)))
              for ci, c in enumerate(("raw", "lossless"))
              for fi, f in enumerate(("none", "horizontal", "vertical", "gradient"))),
            ("webp_lossless_e0", pil(rgb_im, "WEBP", lossless=True, quality=0, method=0)),
            ("webp_lossless_e100", pil(rgb_im, "WEBP", lossless=True, quality=100, method=6)),
            ("webp_lossless_rgba", pil(Image.fromarray(rgba), "WEBP", lossless=True)),
            ("webp_lossless_exact", pil(Image.fromarray(np.where(
                (alpha < 60)[..., None], rgba * np.array([1, 1, 1, 0], np.uint8), rgba)),
                "WEBP", lossless=True, exact=True)),
            ("webp_lossless_from_l", pil(Image.fromarray(grey), "WEBP", lossless=True)),
            ("webp_lossless_near40", we.encode(crop, lossless=1, near_lossless=40)),
            *((f"webp_lossless_{n}colours", pil(Image.fromarray(
                crop[:37, :53]).quantize(n).convert("RGB"), "WEBP", lossless=True))
              for n in (2, 4, 16, 256))):
        out.append((name + ".webp", blob))

    frames = [Image.fromarray(np.roll(crop, 9 * i, axis=1)) for i in range(3)]
    small = we.encode(crop[10:30, 8:36], quality=85)
    small_rgba = we.encode(rgba[10:30, 8:36], quality=85)
    out += [("webp_anim2_lossy.webp", pil(frames[0], "WEBP", save_all=True,
                                          append_images=frames[1:2], quality=80, duration=40)),
            ("webp_anim3_lossless.webp", pil(frames[0], "WEBP", save_all=True,
                                             append_images=frames[1:], lossless=True,
                                             duration=40)),
            ("webp_anim_offset.webp", we.animation((64, 48), [
                dict(file=small, x=12, y=6), dict(file=we.encode(crop, lossless=1), x=0, y=0),
                dict(file=small, x=2, y=4)])),
            ("webp_anim_offset_rgba.webp", we.animation((64, 48), [
                dict(file=small_rgba, x=30, y=22), dict(file=we.encode(rgba), x=0, y=0)],
                alpha=True))]

    quant = rgb_im.quantize(64)
    idx = np.asarray(quant)
    pal = np.asarray(quant.getpalette()[:3 * 64], np.uint8).reshape(64, 3)
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, axis=1)
    out += [("gif_p.gif", pil(Image.fromarray(crop).convert("P"), "GIF")),
            ("gif_l.gif", pil(Image.fromarray(grey), "GIF")),
            ("gif_1bit.gif", pil(Image.fromarray(grey > 120), "GIF")),
            ("gif_interlaced.gif", pil(quant, "GIF", interlace=True)),
            ("gif_transparency.gif", pil(quant, "GIF", transparency=5)),
            ("gif_local_table.gif", gif_bytes(idx[:33, :41], pal, local=True,
                                              screen_palette=pal[:2])),
            ("gif_local_grey_ramp.gif", gif_bytes(idx[:20, :30] % 16, ramp, local=True,
                                                  screen_palette=pal)),
            ("gif_partial.gif", gif_bytes(idx[5:30, 7:40], pal, screen=(64, 48),
                                          offset=(11, 9))),
            ("gif_partial_interlaced_trns.gif", gif_bytes(idx[:21, :27], pal, screen=(50, 40),
                                                          offset=(20, 17), interlace=True,
                                                          transparency=7)),
            ("gif_past_screen.gif", gif_bytes(idx[:30, :40], pal, screen=(32, 24),
                                              offset=(10, 12)))]
    return out


def write_dataset_webps(src):
    """`tests/torch_fixtures/webp/` (module docstring); `src` is the 1296x832
    view's decode."""
    from PIL import Image

    from tools import webp_encoder as we

    d = os.path.join(OUT, "webp")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    path = os.path.join(d, "scene_1296x832_q90.webp")
    Image.fromarray(src).save(path, "WEBP", quality=90)
    write_png_up(os.path.join(OUT, "pil_decode", "scene_1296x832_q90_webp.png"),
                 np.asarray(Image.open(path)))
    with open(os.path.join(d, "rgba_800_lossless.webp"), "wb") as f:
        f.write(we.encode(rgba_800(src), lossless=1, exact=1))


def rgba_800(src):
    """The 800x800 RGBA source of `webp/rgba_800_lossless.webp`."""
    return np.concatenate([src[:800, :800], src[:800, -800:, 1:2]], axis=2)


RASTER_SHA = os.path.join(OUT, "pil_decode", "scene_1296x832_jpeg_ycbcr420_tiled_tif.json")


def raster_cases(crop, alpha):
    """(name, bytes) of the TIFF layouts and sample kinds, Netpbm, TGA and
    QOI files (module docstring), from the 48x64 crop and its alpha."""
    from PIL import Image

    from tools.image_writers import pnm_bytes, qoi_bytes, rgb_to_ycc, tga_bytes, tiff_bytes

    rng = np.random.default_rng(18)
    grey = crop.mean(axis=2).astype(np.uint8)
    rgba = np.concatenate([crop, alpha[..., None]], axis=2)
    cmyk = np.concatenate([255 - crop, alpha[..., None]], axis=2)
    wide16 = (rgba.astype(np.uint16) * 257 + rng.integers(0, 257, rgba.shape)).astype(np.uint16)
    depth = (grey.astype(np.float32) / 37.0 - 3.0) ** 3  # float samples of either sign
    ints = (grey.astype(np.int32) - 128) * 16_777_259
    cmap = rng.integers(0, 65536, 3 * 256)
    odd = (45, 61)  # partial edge tiles and strips
    ycc = rgb_to_ycc(crop)
    out = []
    for name, vals, photometric, kw in (
            ("tif_tiled_rgb_lzw_pred", crop[:45, :61], 2,
             dict(compression=5, predictor=2, tile=(16, 16))),
            ("tif_tiled_rgba_deflate_mm", rgba[:45, :61], 2,
             dict(compression=8, tile=(32, 16), byteorder=">", extra_samples=(2,))),
            ("tif_tiled_l_raw", grey[:45, :61], 1, dict(tile=(16, 32))),
            ("tif_tiled_rgb16_lzw_pred", wide16[:45, :61, :3], 2,
             dict(compression=5, predictor=2, tile=(16, 16))),
            ("tif_planar_rgb_strips_packbits", crop, 2,
             dict(compression=32773, planar=2, rows_per_strip=7)),
            ("tif_planar_rgba_tiles_lzw_pred", rgba[:45, :61], 2,
             dict(compression=5, predictor=2, planar=2, tile=(16, 16), extra_samples=(2,))),
            ("tif_planar_rgb_raw_tiles", crop[:45, :61], 2, dict(planar=2, tile=(16, 16))),
            ("tif_planar_cmyk_raw_strips", cmyk, 5, dict(planar=2, rows_per_strip=10)),
            ("tif_fill2_l_lzw", grey, 1, dict(compression=5, fill_order=2, rows_per_strip=9)),
            ("tif_fill2_rgb_raw", crop, 2, dict(fill_order=2)),
            ("tif_fill2_bilevel_packbits", grey > 120, 1,
             dict(bits=1, compression=32773, fill_order=2, rows_per_strip=8)),
            ("tif_bilevel_white_raw", grey[:, :61] > 100, 0, dict(bits=1, rows_per_strip=16)),
            ("tif_bilevel_black_deflate_tiles", grey[:45] > 140, 1,
             dict(bits=1, compression=8, tile=(16, 16))),
            ("tif_pal1_lzw", grey > 128, 3, dict(bits=1, compression=5, colormap=cmap[:6])),
            ("tif_pal2_raw", grey[:, :59] >> 6, 3, dict(bits=2, colormap=cmap[:12])),
            ("tif_pal4_tiles_deflate", grey[:45, :61] >> 4, 3,
             dict(bits=4, compression=32946, tile=(16, 16), colormap=cmap[:48])),
            ("tif_pal8_packbits", grey, 3, dict(compression=32773, colormap=cmap)),
            ("tif_pal8_planar_lzw_pred", grey, 3,
             dict(compression=5, predictor=2, planar=2, colormap=cmap)),
            ("tif_grey4_white_lzw", grey >> 4, 0, dict(bits=4, compression=5)),
            ("tif_cmyk_lzw", cmyk, 5, dict(compression=5, rows_per_strip=12)),
            ("tif_cmyk16_mm", wide16[:30], 5, dict(byteorder=">", rows_per_strip=8)),
            ("tif_f32_tiles_deflate_pred3", depth[:45, :61], 1,
             dict(compression=8, predictor=3, sample_format=3, tile=(16, 16))),
            ("tif_f32_mm_lzw_pred3", depth, 1,
             dict(compression=5, predictor=3, sample_format=3, byteorder=">",
                  rows_per_strip=16)),
            ("tif_f32_raw_mm", depth[:, :40], 1, dict(sample_format=3, byteorder=">")),
            ("tif_f32_white_deflate", depth[:20], 0, dict(compression=32946, sample_format=3)),
            ("tif_i32_lzw_pred2", ints, 1, dict(compression=5, predictor=2, sample_format=2)),
            ("tif_i32_mm_raw", ints[:31], 1, dict(sample_format=2, byteorder=">")),
            ("tif_u32_raw", ints.view(np.uint32)[:, :50], 1, {}),
            ("tif_i16s_deflate_pred2", (ints >> 14).astype(np.int16), 1,
             dict(compression=8, predictor=2, sample_format=2)),
            ("tif_i16s_mm_raw", (ints >> 15).astype(np.int16)[:40], 1,
             dict(sample_format=2, byteorder=">")),
            ("tif_i16s_mm_lzw", (ints >> 15).astype(np.int16)[:33], 1,
             dict(compression=5, sample_format=2, byteorder=">")),
            ("tif_jpeg_ycbcr420_tiles", ycc[:45, :61], 6,
             dict(compression=7, tile=(16, 16), jpeg=dict(sampling=((2, 2), (1, 1), (1, 1)),
                                                         subsampling=(2, 2)))),
            ("tif_jpeg_ycbcr422_strips", ycc[:45, :61], 6,
             dict(compression=7, rows_per_strip=16,
                  jpeg=dict(sampling=((2, 1), (1, 1), (1, 1)), subsampling=(2, 1),
                            quality=80))),
            ("tif_jpeg_ycbcr420_inline_tables", ycc, 6,
             dict(compression=7, rows_per_strip=8,
                  jpeg=dict(sampling=((2, 2), (1, 1), (1, 1)), tables=False))),
            ("tif_jpeg_ycbcr444_mm_tiles", ycc[:, :61], 6,
             dict(compression=7, byteorder=">", tile=(32, 32),
                  jpeg=dict(sampling=((1, 1),) * 3, subsampling=(1, 1), quality=95))),
            ("tif_jpeg_rgb_tiles", crop[:45, :61], 2,
             dict(compression=7, tile=(16, 16), jpeg=dict(quality=85))),
            ("tif_jpeg_grey_strips", grey[:37], 1, dict(compression=7, rows_per_strip=16)),
            ("tif_jpeg_cmyk_strips", cmyk[:40], 5, dict(compression=7, rows_per_strip=24)),
            ("tif_orientation6_lzw", crop[:30, :48], 2,
             dict(compression=5, tags=[(274, 3, [6])]))):
        out.append((name + ".tif", tiff_bytes(vals, photometric, **kw)))
    levels = (grey.astype(np.int64) * 1000 // 255, grey.astype(np.int64) * 4095 // 255)
    for name, blob in (
            ("pnm_p1", pnm_bytes(grey[:20, :30] > 120, b"P1", comment=b" bits")),
            ("pnm_p1_packed", pnm_bytes(grey[:9, :13] > 90, b"P1", ascii_sep=b"")),
            ("pnm_p2", pnm_bytes(grey[:16, :24], b"P2", 255, ascii_sep=b"\n")),
            ("pnm_p2_1000", pnm_bytes(levels[0][:20, :20], b"P2", 1000, comment=b"x")),
            ("pnm_p3", pnm_bytes(crop[:12, :20], b"P3", 255, ascii_sep=b"\t")),
            ("pnm_p3_4095", pnm_bytes(levels[1][:10, :12, None].repeat(3, 2), b"P3", 4095)),
            ("pnm_p4", pnm_bytes(grey[:, :61] > 120, b"P4")),
            ("pnm_p5", pnm_bytes(grey, b"P5", 255, comment=b" grey")),
            ("pnm_p5_100", pnm_bytes(grey[:, :50] * 100 // 255, b"P5", 100)),
            ("pnm_p5_65535", pnm_bytes(wide16[..., 0], b"P5", 65535)),
            ("pnm_p5_4095", pnm_bytes(levels[1], b"P5", 4095, header_sep=b" ")),
            ("pnm_p6", pnm_bytes(crop, b"P6", 255)),
            ("pnm_p6_65535", pnm_bytes(wide16[..., :3], b"P6", 65535)),
            ("pnm_pf_little", pnm_bytes(depth, b"Pf", scale=-1.0)),
            ("pnm_pf_big", pnm_bytes(depth[:30], b"Pf", scale=2.5))):
        suffix = {b"P1": "pbm", b"P4": "pbm", b"P2": "pgm", b"P5": "pgm", b"Pf": "pfm"}.get(
            blob[:2], "ppm")
        out.append((f"{name}.{suffix}", blob))
    pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    bgr = np.ascontiguousarray(crop[..., ::-1])
    bgra = np.concatenate([bgr, alpha[..., None]], axis=2)
    runs = bgr.copy()
    runs[10:30, 5:50] = runs[10, 5]  # long runs inside rows
    p15 = (crop.astype(np.uint16) >> 3)
    p15 = ((p15[..., 0] << 10) | (p15[..., 1] << 5) | p15[..., 2] | (
        (alpha > 127).astype(np.uint16) << 15)).astype("<u2")
    for name, blob in (
            ("tga_t1_cmap24_first", tga_bytes(grey >> 2, 1, 8, pal[:200, :3], first_entry=5,
                                             id_field=b"colour map from entry 5")),
            ("tga_t1_cmap16_topdown", tga_bytes(grey >> 3, 1, 8, pal[:32, :2], map_depth=16,
                                               top_down=True)),
            ("tga_t2_24", tga_bytes(bgr, 2, 24)),
            ("tga_t2_32_right_to_left", tga_bytes(bgra, 2, 32, right_to_left=True,
                                                  descriptor=8)),
            ("tga_t2_16", tga_bytes(p15.view(np.uint8).reshape(48, 64, 2), 2, 16)),
            ("tga_t3_8_id", tga_bytes(grey, 3, 8, id_field=b"grey")),
            ("tga_t3_16", tga_bytes(np.stack([grey, alpha], 2), 3, 16, top_down=True)),
            ("tga_t3_1", tga_bytes(np.packbits(grey > 120, axis=1), 3, 1)),
            ("tga_t3_8_cmap", tga_bytes(grey, 3, 8, pal[:8, :3])),
            ("tga_t9_rle_cmap", tga_bytes(grey >> 4, 9, 8, pal[:16, :3], first_entry=2,
                                          rows_per_packet_run=1)),
            ("tga_t10_rle_24_rows", tga_bytes(runs, 10, 24, rows_per_packet_run=1)),
            ("tga_t10_rle_24_literals_across", tga_bytes(bgr, 10, 24, max_packet=100)),
            ("tga_t10_rle_32_topdown", tga_bytes(bgra, 10, 32, top_down=True,
                                                 rows_per_packet_run=1, descriptor=8)),
            ("tga_t10_rle_16", tga_bytes(p15.view(np.uint8).reshape(48, 64, 2), 10, 16,
                                         rows_per_packet_run=1)),
            ("tga_t11_rle_8", tga_bytes(grey >> 3 << 3, 11, 8, rows_per_packet_run=1)),
            ("tga_t11_rle_16_right_to_left", tga_bytes(np.stack([grey, alpha], 2), 11, 16,
                                                       rows_per_packet_run=1,
                                                       right_to_left=True))):
        out.append((name + ".tga", blob))
    smooth = np.concatenate([crop, alpha[..., None]], 2)
    out += [("qoi_rgb.qoi", qoi_bytes(crop)), ("qoi_rgba.qoi", qoi_bytes(smooth)),
            ("qoi_rgb_as_rgba.qoi", qoi_bytes(crop, channels=4)),
            ("qoi_rgba_only_rgba_ops.qoi", qoi_bytes(smooth[:20], ops=("rgba", "index"))),
            ("qoi_pil_rgba.qoi", _pil_bytes(Image.fromarray(smooth[:30, :40]), "QOI"))]
    return out


def _pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def write_raster(src):
    """The files of `raster_cases`, the TGA / PPM method directory and the
    1296x832 tiled JPEG TIFF (module docstring), leaving the other files of
    `tests/format_fixtures/` as they are; `src` is the 1296x832 view's
    decode."""
    import hashlib
    import json

    from PIL import Image

    from tools.image_writers import pnm_bytes, rgb_to_ycc, tga_bytes, tiff_bytes

    crop = src[300:348, 500:564]
    for name, blob in raster_cases(crop, alpha_channel(48, 64)):
        path = os.path.join(FORMATS, name)
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))
    metrics = os.path.join(FORMATS, "metrics_tga_ppm")
    shutil.rmtree(metrics, ignore_errors=True)
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    for i, (y, x) in enumerate(((240, 420), (540, 860))):
        render, gt = src[y:y + 48, x:x + 64], src[y + 1:y + 49, x + 3:x + 67]
        for d, img in (("renders", render), ("gt", gt)):
            name = f"{i:05d}." + ("tga" if i == 0 else "ppm")
            blob = (tga_bytes(np.ascontiguousarray(img[..., ::-1]), 10, 24,
                              rows_per_packet_run=1) if i == 0 else pnm_bytes(img, b"P6", 255))
            path = os.path.join(metrics, d, name)
            with open(path, "wb") as f:
                f.write(blob)
            np.save(os.path.join(metrics, "pil", f"{d}_{i:05d}.npy"), np.asarray(Image.open(path)))
    tiff = os.path.join(OUT, "tiff", "scene_1296x832_jpeg_ycbcr420_tiled.tif")
    os.makedirs(os.path.dirname(tiff), exist_ok=True)
    with open(tiff, "wb") as f:
        f.write(tiff_bytes(rgb_to_ycc(src), 6, compression=7, tile=(256, 256),
                           jpeg=dict(sampling=((2, 2), (1, 1), (1, 1)), subsampling=(2, 2),
                                     quality=90)))
    pil = np.asarray(Image.open(tiff))
    with open(RASTER_SHA, "w") as f:
        json.dump({"dtype": str(pil.dtype), "shape": list(pil.shape),
                   "sha256": hashlib.sha256(pil.tobytes()).hexdigest()}, f, indent=1)
        f.write("\n")


def write_formats(src):
    """`tests/format_fixtures/` (module docstring); `src` is the 1296x832
    view's decode."""
    from PIL import Image

    from tools.image_writers import jpeg_bytes

    def save(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))

    shutil.rmtree(FORMATS, ignore_errors=True)
    images, metrics = os.path.join(FORMATS, "colmap_440"), os.path.join(FORMATS, "metrics_jpeg")
    os.makedirs(images)
    for name, blob in format_cases(src):
        save(os.path.join(FORMATS, name), blob)
    for i in range(VIEWS):
        view = np.asarray(Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg")))
        save(os.path.join(images, f"view_{i}.jpg"),
             jpeg_bytes(_ycc(view), ((1, 2), (1, 1), (1, 1)), quality=90))
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    for i, (y, x, sampling) in enumerate(((200, 400, ((1, 2), (1, 1), (1, 1))),
                                          (500, 900, ((4, 1), (1, 1), (1, 1))))):
        name = f"{i:05d}.jpg"
        buf = io.BytesIO()
        Image.fromarray(src[y:y + 48, x:x + 64]).save(buf, "JPEG", quality=90)
        for d, blob in (("renders", buf.getvalue()),
                        ("gt", jpeg_bytes(_ycc(src[y + 1:y + 49, x + 2:x + 66]), sampling,
                                          quality=95))):
            path = os.path.join(metrics, d, name)
            with open(path, "wb") as f:
                f.write(blob)
            np.save(os.path.join(metrics, "pil", f"{d}_{i:05d}.npy"), np.asarray(Image.open(path)))
    colmap_webp = os.path.join(FORMATS, "colmap_webp")
    os.makedirs(colmap_webp)
    for i in range(VIEWS):
        view = Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg"))
        buf = io.BytesIO()
        view.save(buf, "WEBP", quality=90)
        save(os.path.join(colmap_webp, f"view_{i}.webp"), buf.getvalue())
    metrics = os.path.join(FORMATS, "metrics_webp")
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    for i, (y, x) in enumerate(((220, 380), (520, 880))):
        name = f"{i:05d}.webp"
        render = Image.fromarray(src[y:y + 48, x:x + 64])
        gt = src[y + 2:y + 50, x + 1:x + 65]
        buf, gt_buf = io.BytesIO(), io.BytesIO()
        render.save(buf, "WEBP", quality=85)
        if i == 0:
            Image.fromarray(gt).save(gt_buf, "WEBP", lossless=True)
        else:
            Image.fromarray(np.concatenate([gt, alpha_channel(48, 64)[..., None]], 2)).save(
                gt_buf, "WEBP", quality=92)
        for d, blob in (("renders", buf.getvalue()), ("gt", gt_buf.getvalue())):
            path = os.path.join(metrics, d, name)
            with open(path, "wb") as f:
                f.write(blob)
            np.save(os.path.join(metrics, "pil", f"{d}_{i:05d}.npy"), np.asarray(Image.open(path)))


CODECS = os.path.join(OUT, "codecs")  # the 1296x832 damaged / partly refined files


def probe_image(h=32, w=48, seed=21):
    """The damaged-JPEG census's seeded content: smooth colour and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def _flipped(blob, bits):
    out = bytearray(blob)
    for b in bits:
        out[b // 8] ^= 0x80 >> (b % 8)
    return bytes(out)


def damaged_jpeg(blob, seed, flips=1):
    """`blob` with `flips` bits of its entropy-coded data flipped, the first
    seeded choice that PIL still decodes to other pixels than the intact
    file's."""
    from PIL import Image

    start = blob.index(b"\xff\xda")
    start += 2 + (blob[start + 2] << 8 | blob[start + 3])
    intact = np.asarray(Image.open(io.BytesIO(blob)))
    rng = np.random.default_rng(seed)
    while True:
        bits = rng.integers(start * 8, (len(blob) - 2) * 8, flips)
        out = _flipped(blob, bits)
        try:
            got = np.asarray(Image.open(io.BytesIO(out)))
        except Exception:
            continue
        if not np.array_equal(got, intact):
            return out


def _ccitt_strips(bits, compression, rows_per_strip, t4=0):
    """PIL's (libtiff's) CCITT coding of each strip of a bool image."""
    from PIL import Image, TiffImagePlugin

    out = []
    for y in range(0, bits.shape[0], rows_per_strip):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if t4:
            info[292] = t4
        buf = io.BytesIO()
        Image.fromarray(bits[y:y + rows_per_strip]).save(buf, "TIFF", compression=compression,
                                                           tiffinfo=info)
        img = Image.open(io.BytesIO(buf.getvalue()))
        off, cnt = img.tag_v2[273][0], img.tag_v2[279][0]
        out.append(buf.getvalue()[off:off + cnt])
    return out


def codec_cases(crop):
    """(name, bytes) of the small damaged and partly refined JPEGs and of the
    TIFF codecs and sample kinds of `write_codecs` (module docstring)."""
    from tools.image_writers import (PROGRESSIVE_1, PROGRESSIVE_3, jpeg_bytes, rgb_to_ycc,
                                     tiff_bytes)

    out = []
    probe = rgb_to_ycc(probe_image())
    s420 = ((2, 2), (1, 1), (1, 1))
    base = jpeg_bytes(probe, s420, quality=90)
    rst = jpeg_bytes(probe, ((1, 1),) * 3, quality=90, restart_interval=4)
    out += [("jpeg_probe_420.jpg", base), ("jpeg_probe_444_restart.jpg", rst),
            ("jpeg_probe_420_progressive.jpg", jpeg_bytes(probe, s420, quality=90,
                                                          scans=PROGRESSIVE_3))]
    ycc = rgb_to_ycc(crop)
    for name, scans in (("dc", PROGRESSIVE_3[:1]), ("dc_ac1", PROGRESSIVE_3[:2]),
                        ("unrefined", PROGRESSIVE_3[:-1])):
        out.append((f"jpeg_partial_{name}.jpg", jpeg_bytes(ycc, s420, quality=85, scans=scans)))
    out.append(("jpeg_partial_grey_dc.jpg", jpeg_bytes(ycc[..., 0], ((1, 1),), quality=85,
                                                      scans=PROGRESSIVE_1[:1])))
    crop_rst = jpeg_bytes(ycc, ((1, 1),) * 3, quality=90, restart_interval=3)
    rst_at = [i for i in range(len(crop_rst) - 1)
              if crop_rst[i] == 0xFF and 0xD0 <= crop_rst[i + 1] <= 0xD7]
    out += [("jpeg_damaged_huffman.jpg", damaged_jpeg(jpeg_bytes(ycc, s420, quality=90), 3)),
            ("jpeg_damaged_three_bits.jpg", damaged_jpeg(jpeg_bytes(ycc, s420, quality=90), 4, 3)),
            ("jpeg_damaged_restart.jpg",  # RST1 read as RST3: resynced
             _flipped(crop_rst, [8 * rst_at[1] + 14])),
            ("jpeg_damaged_marker.jpg",  # an EOI in the middle of the data: zeros, then grey
             base[:len(base) // 2] + b"\xff\xd9" + base[len(base) // 2 + 2:])]
    bits = np.asarray(crop[..., 1] > 120)
    for name, comp, code, t4, photo, fill in (
            ("rle", "tiff_ccitt", 2, 0, 1, 1), ("g3_1d", "group3", 3, 0, 0, 1),
            ("g3_2d", "group3", 3, 1, 1, 2), ("g3_2d_fill", "group3", 3, 5, 0, 1),
            ("g4", "group4", 4, 0, 0, 1), ("g4_fill2", "group4", 4, 0, 1, 2)):
        out.append((f"tif_ccitt_{name}.tif", tiff_bytes(
            bits.astype(np.uint8), photo, compression=code, bits=1, rows_per_strip=16,
            encoded=_ccitt_strips(bits, comp, 16, t4), fill_order=fill,
            tags=[(292, 4, [t4])] if t4 else [])))
    out += [("tif_lzma_rgb.tif", tiff_bytes(crop, 2, compression=34925, rows_per_strip=16)),
            ("tif_lzma_rgb_pred2.tif", tiff_bytes(crop, 2, compression=34925, predictor=2)),
            ("tif_bigtiff_rgb.tif", tiff_bytes(crop, 2, bigtiff=True, rows_per_strip=16)),
            ("tif_bigtiff_lzw_tiles.tif", tiff_bytes(crop, 2, compression=5, bigtiff=True,
                                                     tile=(32, 32))),
            ("tif_bigtiff_lzma.tif", tiff_bytes(crop, 2, compression=34925, bigtiff=True))]
    for sh, sv in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
        out.append((f"tif_ycbcr_{sh}{sv}_lzw.tif", tiff_bytes(
            ycc, 6, compression=5, ycbcr_subsampling=(sh, sv), rows_per_strip=16)))
    out += [("tif_ycbcr_22_deflate.tif", tiff_bytes(ycc, 6, compression=8,
                                                     ycbcr_subsampling=(2, 2))),
            ("tif_ycbcr_22_refbw.tif", tiff_bytes(ycc, 6, compression=5, ycbcr_subsampling=(2, 2),
                                                  tags=[(529, 5, [2126, 10000, 7152, 10000, 722,
                                                                  10000]),
                                                        (532, 5, [16, 1, 235, 1, 128, 1, 240, 1,
                                                                  128, 1, 240, 1])])),
            ("tif_ycbcr_planar_deflate.tif", tiff_bytes(ycc, 6, compression=8, planar=2,
                                                        ycbcr_subsampling=(1, 1))),
            ("tif_ycbcr_planar_none.tif", tiff_bytes(ycc, 6, planar=2, ycbcr_subsampling=(1, 1))),
            ("tif_lab.tif", tiff_bytes(ycc, 8)),
            ("tif_lab_planar_lzw.tif", tiff_bytes(ycc, 8, compression=5, planar=2)),
            ("tif_i12.tif", tiff_bytes((crop[..., 0].astype(np.uint16) * 16 + crop[..., 1] % 16),
                                       1, bits=12)),
            ("tif_i12_deflate.tif", tiff_bytes((crop[..., 2].astype(np.uint16) * 16 + 9), 1,
                                               compression=8, bits=12, rows_per_strip=7))]
    return out


def codec_views(views):
    """The three views of the codec COLMAP copy (module docstring): a
    damaged JPEG, a partly refined progressive JPEG and a YCbCr 4:2:0 LZW
    TIFF of the first three COLMAP views' decodes."""
    from tools.image_writers import PROGRESSIVE_3, jpeg_bytes, rgb_to_ycc, tiff_bytes

    s420 = ((2, 2), (1, 1), (1, 1))
    return [("view_0.jpg", damaged_jpeg(jpeg_bytes(rgb_to_ycc(views[0]), s420, quality=90), 5)),
            ("view_1.jpg", jpeg_bytes(rgb_to_ycc(views[1]), s420, quality=90,
                                      scans=PROGRESSIVE_3[:-1])),
            ("view_2.tif", tiff_bytes(rgb_to_ycc(views[2]), 6, compression=5,
                                      ycbcr_subsampling=(2, 2), rows_per_strip=16))]


def write_codecs(src):
    """The files of `codec_cases` and `codec_views` under
    `tests/format_fixtures/` (PIL's array beside each), and the 1296x832
    damaged and partly refined JPEGs under `tests/torch_fixtures/codecs/`
    with PIL's decode of each in `pil_decode/<name>.png`; `src` is the
    1296x832 view's decode. The other fixtures stay as they are."""
    from PIL import Image

    from tools.image_writers import PROGRESSIVE_3, jpeg_bytes, rgb_to_ycc

    def save(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))

    for name, blob in codec_cases(src[300:348, 500:564]):
        save(os.path.join(FORMATS, name), blob)
    views_dir = os.path.join(FORMATS, "colmap_codecs")
    shutil.rmtree(views_dir, ignore_errors=True)
    os.makedirs(views_dir)
    views = [np.asarray(Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg")))
             for i in range(3)]
    for name, blob in codec_views(views):
        save(os.path.join(views_dir, name), blob)
    os.makedirs(CODECS, exist_ok=True)
    with open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg"), "rb") as f:
        scene = f.read()
    big = {"scene_1296x832_damaged": damaged_jpeg(scene, 6, 3),
           "scene_1296x832_unrefined": jpeg_bytes(rgb_to_ycc(src), ((2, 2), (1, 1), (1, 1)),
                                                  quality=85, scans=PROGRESSIVE_3[:-1])}
    for name, blob in big.items():
        path = os.path.join(CODECS, name + ".jpg")
        with open(path, "wb") as f:
            f.write(blob)
        write_png_up(os.path.join(OUT, "pil_decode", name + ".png"), np.asarray(Image.open(path)))


# The card's BCn checks: (name, DXGI format, payload seed) of the seeded
# random blocks at the 1296x832 view's size.
BCN_SCENES = (("scene_1296x832_bc7", 98, 22), ("scene_1296x832_bc1", 71, 23))
ZSTD_SCENES = ("scene_1296x832_zstd_onestrip", "scene_1296x832_zstd_strips")


def bcn_scene(dxgi, seed, width=1296, height=832):
    """The DDS of seeded random blocks the card checks against PIL's hash."""
    from tools.image_writers import dds_bytes

    size = 8 if dxgi in (70, 71, 79, 80) else 16
    payload = np.random.default_rng(seed).integers(
        0, 256, (-(-width // 4)) * (-(-height // 4)) * size, dtype=np.uint8).tobytes()
    return dds_bytes(width, height, payload, dxgi=dxgi)


def _designed(rng, n):
    """Bytes that make libzstd reach its rarer modes: a run of repeated
    segments each after one fixed byte (RLE literals), a small skewed
    alphabet (4-bit Huffman weights), a periodic pattern, zeros and noise."""
    segs = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(80)]
    parts = [b"".join(segs), b"".join(b"q" + x for x in segs),
             bytes(rng.choice(np.arange(6, dtype=np.uint8), 1500,
                              p=[.45, .25, .12, .1, .05, .03])),
             b"xyz" * 150, bytes(600), bytes(rng.integers(0, 256, 400, dtype=np.uint8))]
    return (b"".join(parts) * 3)[:n]


def reader_cases(crop):
    """(name, bytes) of the ZSTD, tiled-YCbCr and small-reader fixtures (module
    docstring); `crop` is a 48x64 RGB cut of the view."""
    from PIL import Image

    from tools import image_writers as iw

    rng = np.random.default_rng(31)
    alpha = alpha_channel(48, 64)
    grey16 = crop[..., 0].astype(np.uint16) * 257 + crop[..., 1]
    depth = (crop.astype(np.float32) / 255.0).mean(axis=2) * np.float32(40) - np.float32(3)

    def pil(img, fmt="TIFF", **kw):
        return _pil_bytes(Image.fromarray(img), fmt, **kw)

    def zstd(img, **kw):
        return pil(img, compression="zstd", **kw)

    designed = np.frombuffer(_designed(rng, 48 * 64 * 3), np.uint8).reshape(48, 64, 3)
    seqs = [(2, 4 + k % 4, 9) for k in range(40)]  # literal length 2, match 9: RLE tables
    hand = [iw.zstd_frame([("rle_literals", 0x80, 300), ("raw", bytes(range(256)) * 2),
                           ("rle", 7, 212)]),
            iw.zstd_frame([("raw_literals", designed[16:32].tobytes()[:1024])], checksum=True),
            iw.zstd_frame([("rle_sequences", bytes(range(90, 190)), seqs), ("rle", 200, 564)])]
    hand_img = np.frombuffer(b"".join(zstd_frame_content(f) for f in hand), np.uint8)
    out = [("tif_zstd_rgb.tif", zstd(crop)), ("tif_zstd_rgb_strips.tif", zstd(crop, tiffinfo={278: 5})),
           ("tif_zstd_l.tif", zstd(crop[..., 1])),
           ("tif_zstd_rgba.tif", zstd(np.concatenate([crop, alpha[..., None]], 2))),
           ("tif_zstd_i16.tif", zstd(grey16)), ("tif_zstd_i16_pred2.tif", zstd(grey16, tiffinfo={317: 2})),
           ("tif_zstd_rgb_pred2.tif", zstd(crop, tiffinfo={317: 2, 278: 16})),
           ("tif_zstd_f32_pred3.tif", zstd(depth, tiffinfo={317: 3})),
           ("tif_zstd_tiles.tif", iw.tiff_bytes(crop, 2, compression=50000, tile=(32, 32))),
           ("tif_zstd_tiles_pred2.tif", iw.tiff_bytes(crop, 2, compression=50000, tile=(16, 16),
                                                       predictor=2)),
           ("tif_zstd_planar.tif", iw.tiff_bytes(crop, 2, compression=50000, planar=2,
                                                 rows_per_strip=16)),
           ("tif_zstd_planar_tiles.tif", iw.tiff_bytes(crop, 2, compression=50000, planar=2,
                                                       tile=(32, 16))),
           ("tif_zstd_be16_pred2.tif", iw.tiff_bytes(crop.astype(np.uint16) * 257, 2,
                                                     compression=50000, byteorder=">",
                                                     predictor=2)),
           ("tif_zstd_f32_tiles_pred3.tif", iw.tiff_bytes(depth, 1, compression=50000,
                                                          predictor=3, sample_format=3,
                                                          tile=(16, 16))),
           ("tif_zstd_blocks_1k.tif", iw.tiff_bytes(designed, 2, compression=50000,
                                                    zstd=dict(level=19, window_log=10))),
           ("tif_zstd_blocks_2k.tif", iw.tiff_bytes(designed, 2, compression=50000,
                                                    zstd=dict(level=3, window_log=11))),
           ("tif_zstd_blocks_4k.tif", iw.tiff_bytes(designed, 2, compression=50000,
                                                    zstd=dict(level=19, window_log=12))),
           ("tif_zstd_alphabet.tif", iw.tiff_bytes(
               rng.choice(np.arange(6, dtype=np.uint8), (48, 64), p=[.45, .25, .12, .1, .05, .03]),
               1, compression=50000, zstd=dict(level=1, window_log=10))),
           ("tif_zstd_hand.tif", iw.tiff_bytes(hand_img.reshape(48, 64), 1, compression=50000,
                                               rows_per_strip=16, encoded=hand))]
    ycc = iw.rgb_to_ycc(crop)
    for sub, comp, tile in (((2, 2), 50000, (16, 16)), ((4, 4), 50000, (16, 16)),
                            ((4, 2), 5, (32, 16)), ((2, 1), 8, (16, 32)), ((1, 1), 32773, (32, 32)),
                            ((1, 2), 50000, (48, 16))):
        out.append((f"tif_ycbcr_tiled_{sub[0]}{sub[1]}_{comp}.tif",
                    iw.tiff_bytes(ycc, 6, compression=comp, ycbcr_subsampling=sub, tile=tile)))
    out.append(("tif_ycbcr_tiled_planar_50000.tif", iw.tiff_bytes(
        ycc, 6, compression=50000, planar=2, ycbcr_subsampling=(1, 1), tile=(16, 16))))
    out += _icon_cases(crop, alpha, rng) + _dds_cases(crop, alpha, rng)
    out += _psd_sgi_pcx_sun_cases(crop, alpha, rng)
    return out


def zstd_frame_content(frame):
    """The content of a frame (decoded with the `zstandard` package)."""
    import zstandard

    return zstandard.ZstdDecompressor().decompress(frame)


def _icon_cases(crop, alpha, rng):
    from PIL import Image

    from tools import image_writers as iw

    rgba = np.concatenate([crop, alpha[..., None]], 2)
    mask = crop[..., 2] > 140
    grey = crop[..., 1]
    pal256 = rng.integers(0, 256, (256, 3))

    def dib(img, bits, **kw):
        return iw.dib_bytes(img, bits, and_mask=mask[:img.shape[0], :img.shape[1]], **kw)

    png = _pil_bytes(Image.fromarray(rgba[:32, :32]), "PNG")
    out = [("ico_pil_png.ico", _pil_bytes(Image.fromarray(rgba), "ICO", sizes=[(16, 16), (32, 32)])),
           ("ico_pil_bmp.ico", _pil_bytes(Image.fromarray(rgba), "ICO", bitmap_format="bmp",
                                          sizes=[(16, 16), (32, 32)])),
           ("ico_dib32.ico", iw.icon_bytes([(dib(rgba[:32, :32], 32), 32, 32, 32, 0)])),
           ("ico_dib24.ico", iw.icon_bytes([(dib(crop[:16, :24], 24), 24, 16, 24, 0)])),
           ("ico_dib8.ico", iw.icon_bytes([(dib(grey[:32, :40], 8, palette=pal256), 40, 32, 8, 0)])),
           ("ico_dib8_grey.ico", iw.icon_bytes([(dib(grey[:16, :16], 8, palette=np.repeat(
               np.arange(256)[:, None], 3, 1)), 16, 16, 8, 0)])),
           ("ico_dib4.ico", iw.icon_bytes([(dib(grey[:16, :16] >> 4, 4,
                                                 palette=pal256[:16]), 16, 16, 4, 16)])),
           ("ico_dib1.ico", iw.icon_bytes([(dib(grey[:32, :32] >> 7, 1,
                                                 palette=[[0, 0, 80], [250, 240, 0]]), 32, 32, 1, 2)])),
           ("ico_entries.ico", iw.icon_bytes([(dib(grey[:16, :16], 8, palette=pal256), 16, 16, 8, 0),
                                              (png, 32, 32, 32, 0),
                                              (dib(rgba[:32, :32], 32), 32, 32, 32, 0),
                                              (dib(crop[:32, :32], 24), 32, 32, 24, 0)])),
           ("cur_dib1.cur", iw.icon_bytes([(dib(grey[:32, :32] >> 7, 1, palette=[[0, 0, 0], [255, 255, 255]]),
                                            32, 32, 3, 5)], cursor=True)),
           ("cur_dib8.cur", iw.icon_bytes([(dib(grey[:16, :16], 8, palette=pal256), 16, 16, 1, 1),
                                           (dib(grey[:32, :48], 8, palette=pal256), 48, 32, 2, 2)],
                                          cursor=True)),
           ("cur_dib24.cur", iw.icon_bytes([(dib(crop[:24, :24], 24), 24, 24, 0, 0)], cursor=True)),
           ("cur_dib32.cur", iw.icon_bytes([(dib(rgba[:32, :32], 32), 32, 32, 4, 4)], cursor=True))]
    return out


def _dds_cases(crop, alpha, rng):
    from PIL import Image

    from tools import image_writers as iw

    rgba = np.concatenate([crop, alpha[..., None]], 2)
    out = [(f"dds_pil_{f.lower()}.dds", _pil_bytes(Image.fromarray(rgba), "DDS", pixel_format=f))
           for f in ("DXT1", "DXT3", "DXT5", "BC2", "BC3")]
    out += [("dds_pil_bc5.dds", _pil_bytes(Image.fromarray(crop), "DDS", pixel_format="BC5")),
            ("dds_pil_rgb.dds", _pil_bytes(Image.fromarray(crop), "DDS")),
            ("dds_pil_rgba.dds", _pil_bytes(Image.fromarray(rgba), "DDS")),
            ("dds_pil_l.dds", _pil_bytes(Image.fromarray(crop[..., 0]), "DDS")),
            ("dds_pil_la.dds", _pil_bytes(Image.fromarray(rgba[..., 1:3], "LA"), "DDS"))]
    w, h = 61, 45  # partial edge blocks
    blocks = 16 * 12
    for name, size, kw in (("dxt1", 8, dict(fourcc="DXT1")), ("dxt3", 16, dict(fourcc="DXT3")),
                           ("dxt5", 16, dict(fourcc="DXT5")), ("bc4u", 8, dict(fourcc="BC4U")),
                           ("ati1", 8, dict(fourcc="ATI1")), ("bc5u", 16, dict(fourcc="BC5U")),
                           ("ati2", 16, dict(fourcc="ATI2")), ("bc5s", 16, dict(fourcc="BC5S")),
                           ("dxgi_bc1", 8, dict(dxgi=71)), ("dxgi_bc2", 16, dict(dxgi=74)),
                           ("dxgi_bc3", 16, dict(dxgi=77)), ("dxgi_bc4", 8, dict(dxgi=80)),
                           ("dxgi_bc5", 16, dict(dxgi=83)), ("dxgi_bc5s", 16, dict(dxgi=84)),
                           ("dxgi_bc6h_uf16", 16, dict(dxgi=95)),
                           ("dxgi_bc6h_sf16", 16, dict(dxgi=96)), ("dxgi_bc7", 16, dict(dxgi=98)),
                           ("dxgi_bc7_srgb", 16, dict(dxgi=99))):
        payload = rng.integers(0, 256, blocks * size, dtype=np.uint8)
        if name.startswith("dxgi_bc6h"):  # every mode, reserved ones too
            modes = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19])
            m = modes[np.arange(blocks) % len(modes)]
            b0 = payload[::16].astype(int)
            payload[::16] = np.where(m < 2, (b0 & ~3) | m, (b0 & ~31) | m)
        if name.startswith("dxgi_bc7"):  # every mode, and the empty one
            m = np.arange(blocks) % 9
            payload[::16] = np.where(m == 8, 0, ((payload[::16].astype(int) << 1 | 1) << m) & 255)
        out.append((f"dds_{name}.dds", iw.dds_bytes(w, h, payload.tobytes(), **kw)))
    px = rgba[:h, :w].astype(np.uint32)
    out += [("dds_argb8888.dds", iw.dds_bytes(w, h, (px[..., 2] | px[..., 1] << 8 | px[..., 0] << 16
                                                     | px[..., 3] << 24).astype("<u4").tobytes(),
                                              pf_flags=0x41, bitcount=32,
                                              masks=(0xff0000, 0xff00, 0xff, 0xff000000))),
            ("dds_rgb565.dds", iw.dds_bytes(w, h, rng.integers(0, 65536, w * h).astype("<u2").tobytes(),
                                            pf_flags=0x40, bitcount=16, masks=(0xf800, 0x7e0, 0x1f))),
            ("dds_a1r5g5b5.dds", iw.dds_bytes(w, h, rng.integers(0, 65536, w * h).astype("<u2").tobytes(),
                                              pf_flags=0x41, bitcount=16,
                                              masks=(0x7c00, 0x3e0, 0x1f, 0x8000))),
            ("dds_l8.dds", iw.dds_bytes(w, h, rgba[:h, :w, 0].tobytes(), pf_flags=0x20000, bitcount=8)),
            ("dds_p8.dds", iw.dds_bytes(w, h, rgba[:h, :w, 1].tobytes(), pf_flags=0x20, bitcount=8,
                                        palette=rng.integers(0, 256, 1024, dtype=np.uint8).tobytes())),
            ("dds_dxgi_rgba8.dds", iw.dds_bytes(w, h, rgba[:h, :w].tobytes(), dxgi=28))]
    return out


def _psd_sgi_pcx_sun_cases(crop, alpha, rng):
    from PIL import Image

    from tools import image_writers as iw

    rgba = np.concatenate([crop, alpha[..., None]], 2)
    planes, grey = crop.transpose(2, 0, 1), crop[..., 1]
    out = []
    for comp in (0, 1):
        tag = ("raw", "packbits")[comp]
        out += [(f"psd_rgb_{tag}.psd", iw.psd_bytes(planes, "RGB", comp)),
                (f"psd_rgba_{tag}.psd", iw.psd_bytes(rgba.transpose(2, 0, 1), "RGB", comp)),
                (f"psd_cmyk_{tag}.psd", iw.psd_bytes(255 - rgba.transpose(2, 0, 1), "CMYK", comp)),
                (f"psd_lab_{tag}.psd", iw.psd_bytes(planes, "LAB", comp)),
                (f"psd_l_{tag}.psd", iw.psd_bytes(grey[None], "L", comp)),
                (f"psd_p_{tag}.psd", iw.psd_bytes(grey[None], "P", comp,
                                                  palette=rng.integers(0, 256, (256, 3)))),
                (f"psd_1_{tag}.psd", iw.psd_bytes((grey[None] > 120).astype(np.uint8), "1", comp,
                                                  bits=1))]
    out.append(("psd_rgb_resources.psd", iw.psd_bytes(planes, "RGB", 1, resources=(
        b"8BIM\x03\xed\x00\x00\x00\x00\x00\x10" + bytes(16)
        + b"8BIM\x04\x0c\x03abc\x00\x00\x00\x03xyz\x00"))))
    out += [("sgi_pil_rgb.sgi", _pil_bytes(Image.fromarray(crop), "SGI")),
            ("sgi_pil_l.sgi", _pil_bytes(Image.fromarray(grey), "SGI")),
            ("sgi_pil_rgba.sgi", _pil_bytes(Image.fromarray(rgba), "SGI")),
            ("sgi_rle_rgb.sgi", iw.sgi_bytes(crop)), ("sgi_rle_l.sgi", iw.sgi_bytes(grey)),
            ("sgi_rle_rgba.sgi", iw.sgi_bytes(rgba)),
            ("sgi_rle16_rgb.sgi", iw.sgi_bytes(crop.astype(np.uint16) * 257 + 11)),
            ("sgi_raw16_l.sgi", iw.sgi_bytes(grey.astype(np.uint16) * 200, rle=False))]
    out += [("pcx_pil_rgb.pcx", _pil_bytes(Image.fromarray(crop), "PCX")),
            ("pcx_pil_l.pcx", _pil_bytes(Image.fromarray(grey), "PCX")),
            ("pcx_pil_p.pcx", _pil_bytes(Image.fromarray(crop).convert("P"), "PCX")),
            ("pcx_pil_1.pcx", _pil_bytes(Image.fromarray(grey > 120), "PCX")),
            ("pcx_rgb_odd.pcx", iw.pcx_bytes(crop[:, :61], 8, 3)),
            ("pcx_1bit_2planes.pcx", iw.pcx_bytes(grey[:, :40] >> 6, 1, 2)),
            ("pcx_1bit_4planes.pcx", iw.pcx_bytes(grey[:, :61] >> 4, 1, 4)),
            ("pcx_1bit_4planes_w3.pcx", iw.pcx_bytes(grey[:8, :3] >> 4, 1, 4))]
    pal = rng.integers(0, 256, (256, 3))
    for ftype in (1, 2, 3):
        out += [(f"sun_24_t{ftype}.ras", iw.sun_bytes(crop[:, :61], 24, ftype)),
                (f"sun_32_t{ftype}.ras", iw.sun_bytes(rgba[:, :61], 32, ftype)),
                (f"sun_8_t{ftype}.ras", iw.sun_bytes(grey[:, :61], 8, ftype)),
                (f"sun_8p_t{ftype}.ras", iw.sun_bytes(grey[:, :61], 8, ftype, palette=pal)),
                (f"sun_4_t{ftype}.ras", iw.sun_bytes(grey[:, :61] >> 4, 4, ftype)),
                (f"sun_4p_t{ftype}.ras", iw.sun_bytes(grey[:, :61] >> 4, 4, ftype, palette=pal[:16])),
                (f"sun_1_t{ftype}.ras", iw.sun_bytes(grey[:, :61] >> 7, 1, ftype))]
    return out


def reader_views(views):
    """The six COLMAP views of `colmap_readers/` (module docstring)."""
    from PIL import Image

    from tools import image_writers as iw

    return [("view_0.tif", _pil_bytes(Image.fromarray(views[0]), "TIFF", compression="zstd")),
            ("view_1.tif", iw.tiff_bytes(iw.rgb_to_ycc(views[1]), 6, compression=50000,
                                         ycbcr_subsampling=(2, 2), tile=(64, 64))),
            ("view_2.psd", iw.psd_bytes(views[2].transpose(2, 0, 1), "RGB", 1)),
            ("view_3.sgi", iw.sgi_bytes(views[3])),
            ("view_4.pcx", iw.pcx_bytes(views[4], 8, 3)),
            ("view_5.ras", iw.sun_bytes(views[5], 24, 2))]


def write_readers(src):
    """The files of `reader_cases` and `reader_views`, the ZSTD / PSD method
    directory, and the card's 1296x832 ZSTD TIFFs and BCn hashes (module
    docstring); `src` is the 1296x832 view's decode."""
    import hashlib
    import json

    from PIL import Image

    from tools.image_writers import psd_bytes

    def save(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))

    for name, blob in reader_cases(src[300:348, 500:564]):
        save(os.path.join(FORMATS, name), blob)
    views_dir = os.path.join(FORMATS, "colmap_readers")
    shutil.rmtree(views_dir, ignore_errors=True)
    os.makedirs(views_dir)
    views = [np.asarray(Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg")))
             for i in range(VIEWS)]
    for name, blob in reader_views(views):
        save(os.path.join(views_dir, name), blob)
    metrics = os.path.join(FORMATS, "metrics_zstd_psd")
    shutil.rmtree(metrics, ignore_errors=True)
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    for i, (y, x) in enumerate(((260, 440), (560, 840))):
        render, gt = src[y:y + 48, x:x + 64], src[y + 2:y + 50, x + 2:x + 66]
        for d, img in (("renders", render), ("gt", gt)):
            name = f"{i:05d}." + ("tif" if i == 0 else "psd")
            blob = (_pil_bytes(Image.fromarray(img), "TIFF", compression="zstd") if i == 0
                    else psd_bytes(img.transpose(2, 0, 1), "RGB", 1))
            path = os.path.join(metrics, d, name)
            with open(path, "wb") as f:
                f.write(blob)
            np.save(os.path.join(metrics, "pil", f"{d}_{i:05d}.npy"), np.asarray(Image.open(path)))
    zdir = os.path.join(OUT, "zstd")
    os.makedirs(zdir, exist_ok=True)
    for name, kw in zip(ZSTD_SCENES, ({"tiffinfo": {278: src.shape[0]}}, {})):
        path = os.path.join(zdir, name + ".tif")
        with open(path, "wb") as f:
            f.write(_pil_bytes(Image.fromarray(src), "TIFF", compression="zstd", **kw))
        assert np.array_equal(np.asarray(Image.open(path)), src)
    for name, dxgi, seed in BCN_SCENES:
        pil = np.asarray(Image.open(io.BytesIO(bcn_scene(dxgi, seed))))
        with open(os.path.join(OUT, "pil_decode", name + "_dds.json"), "w") as f:
            json.dump({"dtype": str(pil.dtype), "shape": list(pil.shape),
                       "sha256": hashlib.sha256(pil.tobytes()).hexdigest()}, f, indent=1)
            f.write("\n")


# The 1296x832 JPEG 2000 views the card decodes: (name, PIL's save options).
J2K_SCENES = (("scene_1296x832_lossless", "jp2", {}),
              ("scene_1296x832_97_layers", "jp2", dict(irreversible=True, quality_mode="rates",
                                                        quality_layers=[80, 40, 20])),
              ("scene_1296x832_tiled_rpcl", "j2k", dict(irreversible=True, tile_size=(256, 256),
                                                         progression="RPCL",
                                                         precinct_size=(64, 64),
                                                         quality_mode="rates",
                                                         quality_layers=[12])))


def _j2k_pil_cases(crop, alpha):
    """JPEG 2000 files from PIL's own writer (each option it has)."""
    from PIL import Image

    rgb = Image.fromarray(crop)
    rgba = Image.fromarray(np.concatenate([crop, alpha[..., None]], -1))
    grey = rgb.convert("L")
    i16 = Image.frombytes("I;16", grey.size, (np.asarray(grey).astype("<u2") * 257 + 3).tobytes())
    odd = Image.fromarray(crop[:37, :53])
    layers = dict(quality_mode="rates", quality_layers=[40, 10, 2])
    cases = [("rgb_lossless.jp2", rgb, {}), ("rgb_97.jp2", rgb, dict(irreversible=True)),
             ("rgb_97_layers.jp2", rgb, dict(irreversible=True, **layers)),
             ("rgb_db_layers.jp2", rgb, dict(quality_mode="dB", quality_layers=[30, 40, 50])),
             ("rgb_mct0.jp2", rgb, dict(mct=0)), ("rgb_97_mct0.j2k", rgb,
                                                   dict(irreversible=True, mct=0, no_jp2=True)),
             ("rgb_res1.j2k", rgb, dict(num_resolutions=1, no_jp2=True)),
             ("rgb_res3.jp2", rgb, dict(num_resolutions=3)),
             ("rgb_cblk16x32.jp2", rgb, dict(codeblock_size=(16, 32))),
             ("rgb_cblk4x4_97.j2k", rgb, dict(codeblock_size=(4, 4), irreversible=True,
                                               no_jp2=True)),
             ("rgb_prec32.jp2", rgb, dict(precinct_size=(32, 32))),
             ("rgb_tiles.jp2", rgb, dict(tile_size=(32, 32))),
             ("rgb_tile_offsets_97.j2k", rgb, dict(tile_size=(17, 13), tile_offset=(3, 2),
                                                    offset=(5, 7), irreversible=True,
                                                    no_jp2=True, num_resolutions=3)),
             ("rgb_plt.jp2", rgb, dict(plt=True)),
             ("rgb_signed.jp2", rgb, dict(signed=True)),
             ("rgb_97_signed.j2k", rgb, dict(signed=True, irreversible=True, no_jp2=True)),
             ("l.jp2", grey, {}), ("l_97.j2k", grey, dict(irreversible=True, no_jp2=True)),
             ("la.jp2", Image.fromarray(np.stack([np.asarray(grey), alpha], -1)), {}),
             ("rgba.jp2", rgba, {}), ("rgba_97_layers.jp2", rgba, dict(irreversible=True,
                                                                       **layers)),
             ("i16.jp2", i16, {}), ("i16_97.j2k", i16, dict(irreversible=True, no_jp2=True)),
             ("odd_53x37.jp2", odd, {}), ("odd_53x37_97.j2k", odd, dict(irreversible=True,
                                                                        no_jp2=True)),
             ("rgb_1x1.j2k", Image.fromarray(crop[:1, :1]), dict(no_jp2=True)),
             ("rgb_1x7_97.j2k", Image.fromarray(crop[:7, :1]), dict(no_jp2=True,
                                                                    irreversible=True)),
             ("rgb_7x1.j2k", Image.fromarray(crop[:1, :7]), dict(no_jp2=True))]
    for order in ("RLCP", "RPCL", "PCRL", "CPRL"):
        cases.append((f"rgb_{order.lower()}.j2k", rgb, dict(progression=order, no_jp2=True,
                                                             precinct_size=(32, 32), **layers)))
    return [(f"jpeg2000_{n}", _pil_bytes(img, "JPEG2000", **kw)) for n, img, kw in cases]


def _j2k_writer_cases(crop, alpha):
    """JPEG 2000 files from libopenjp2 through `tools/image_writers.j2k_bytes`
    (what PIL's options do not reach), and JP2 boxes edited by hand."""
    import struct

    from tools import image_writers as iw

    planes = [crop[..., c].astype(np.int32) for c in range(3)]
    grey = planes[1]
    p12 = [p * 16 + 15 for p in planes]  # near 4095 too: Pillow's 8-bit shift wraps there
    styles = {"lazy": 1, "reset": 2, "termall": 4, "causal": 8, "pterm": 16, "segsym": 32,
              "all": 63}
    out = []
    for name, sty in styles.items():
        out.append((f"style_{name}.j2k", iw.j2k_bytes(planes, style=sty, rates=(30, 8, 0))))
    out += [("style_all_97.j2k", iw.j2k_bytes(planes, style=63, irreversible=True,
                                              rates=(20, 0))),
            ("style_lazy_causal_97.j2k", iw.j2k_bytes(planes, style=9, irreversible=True,
                                                      cblk=(16, 16))),
            ("sop_eph.j2k", iw.j2k_bytes(planes, sop=True, eph=True, rates=(30, 0))),
            ("poc.j2k", iw.j2k_bytes(planes, pocs=[(0, 0, 1, 6, 3, 1), (0, 0, 3, 6, 3, 0)],
                                     rates=(40, 10, 0))),
            ("poc_cprl.j2k", iw.j2k_bytes(planes, pocs=[(0, 0, 2, 3, 3, 2), (3, 0, 2, 6, 3, 4)],
                                          rates=(40, 0))),
            ("roi.j2k", iw.j2k_bytes(planes, roi=(0, 10))),
            ("roi_97_layers.j2k", iw.j2k_bytes(planes, roi=(1, 6), irreversible=True,
                                               rates=(30, 0))),
            ("tileparts_r.j2k", iw.j2k_bytes(planes, tile=(32, 32), tile_parts="R")),
            ("tileparts_l.j2k", iw.j2k_bytes(planes, tile_parts="L", rates=(30, 10, 0))),
            ("tileparts_c.jp2", iw.j2k_bytes(planes, tile_parts="C", jp2=True)),
            ("sub420.j2k", iw.j2k_bytes([planes[0], planes[1][::2, ::2], planes[2][::2, ::2]],
                                        sampling=[(1, 1), (2, 2), (2, 2)], mct=False)),
            ("sub420_sycc.jp2", iw.j2k_bytes([planes[0], planes[1][::2, ::2],
                                              planes[2][::2, ::2]],
                                             sampling=[(1, 1), (2, 2), (2, 2)], mct=False,
                                             jp2=True, colour=3)),
            ("sub422_97.j2k", iw.j2k_bytes([planes[0], planes[1][:, ::2], planes[2][:, ::2]],
                                           sampling=[(1, 1), (2, 1), (2, 1)], mct=False,
                                           irreversible=True)),
            ("sub420_odd.j2k", iw.j2k_bytes([planes[0][:47, :63], planes[1][:47:2, :63:2],
                                             planes[2][:47:2, :63:2]],
                                            sampling=[(1, 1), (2, 2), (2, 2)], mct=False,
                                            offset=(1, 1))),
            ("sycc.jp2", iw.j2k_bytes(planes, jp2=True, colour=3, mct=False)),
            ("rgb12.jp2", iw.j2k_bytes(p12, prec=12, jp2=True)),
            ("rgb12_97.j2k", iw.j2k_bytes(p12, prec=12, irreversible=True)),
            ("rgb12_signed.j2k", iw.j2k_bytes([p - 2048 for p in p12], prec=12, signed=True)),
            ("rgb16.j2k", iw.j2k_bytes([p * 257 for p in planes], prec=16)),
            ("grey12.j2k", iw.j2k_bytes([p12[1]], prec=12)),
            ("grey9.jp2", iw.j2k_bytes([grey * 2 + 1], prec=9, jp2=True, colour=2)),
            ("grey4.j2k", iw.j2k_bytes([grey >> 4], prec=4)),
            ("grey1.j2k", iw.j2k_bytes([grey >> 7], prec=1)),
            ("grey16_97.jp2", iw.j2k_bytes([grey * 257], prec=16, jp2=True, colour=2,
                                           irreversible=True)),
            ("precincts_per_res.j2k", iw.j2k_bytes(planes, progression=2, precincts=[
                (5, 5), (4, 4), (3, 3), (2, 2), (1, 1), (1, 1)])),
            ("offset_odd_97.j2k", iw.j2k_bytes(planes, irreversible=True, offset=(3, 1),
                                               cblk=(32, 8)))]
    idx = (grey // 8).astype(np.int32)
    pal = np.random.default_rng(23).integers(0, 256, (32, 3)).astype(np.uint8)
    pclr = iw.jp2_box(b"pclr", struct.pack(">HB", 32, 3) + bytes([7, 7, 7]) + pal.tobytes())
    cmap = iw.jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c) for c in range(3)))
    srgb_grey = iw.j2k_bytes([idx], jp2=True, colour=1)
    four = iw.j2k_bytes(planes + [alpha.astype(np.int32)], jp2=True, mct=False)
    rgb_jp2 = iw.j2k_bytes(planes, jp2=True)
    cdef = iw.jp2_box(b"cdef", struct.pack(">H", 3) + b"".join(
        struct.pack(">HHH", c, 0, 3 - c) for c in range(3)))
    icc = iw.jp2_box(b"colr", bytes([2, 0, 0]) + bytes(range(128)))
    out += [("pclr.jp2", iw.jp2_edit(srgb_grey, add=[pclr, cmap])),
            ("pclr_alpha.jp2", iw.jp2_edit(iw.j2k_bytes([idx, alpha.astype(np.int32)], jp2=True,
                                                        colour=1, alpha=1), add=[pclr, cmap])),
            ("cmyk.jp2", iw.jp2_edit(four, enumcs=12)),
            ("sycc_alpha.jp2", iw.jp2_edit(four, enumcs=18)),
            ("cdef_swapped.jp2", iw.jp2_edit(rgb_jp2, add=[cdef])),
            ("icc_second_colr.jp2", iw.jp2_edit(rgb_jp2, add=[icc])),
            ("res_bpcc.jp2", iw.jp2_edit(rgb_jp2, add=[
                iw.jp2_box(b"res ", iw.jp2_box(b"resc", struct.pack(">HHHHBB", 72, 1, 72, 1, 0,
                                                                    0))),
                iw.jp2_box(b"bpcc", bytes([7, 7, 7]))])),
            ("ppt.j2k", iw.j2k_packed_headers(iw.j2k_bytes(planes, tile=(32, 32), sop=True,
                                                           eph=True, rates=(30, 0)), "PPT")),
            ("ppm.j2k", iw.j2k_packed_headers(iw.j2k_bytes(planes, tile=(32, 32),
                                                           rates=(30, 0)), "PPM",
                                              max_segment=200))]
    return [(f"jpeg2000_{n}", blob) for n, blob in out]


def _icns_cases(crop, alpha):
    """ICNS files (`tools/image_writers.icns_bytes`) of each entry kind PIL
    reads, at most 48 pixels a side."""
    from tools import image_writers as iw

    def png_of(img):
        return _pil_bytes(__import__("PIL.Image").Image.fromarray(img), "PNG")

    def runs(img):
        return b"".join(iw.icns_rle(img[..., c]) for c in range(3))

    def jp2_of(img, **kw):
        return _pil_bytes(__import__("PIL.Image").Image.fromarray(img), "JPEG2000", **kw)

    s16, s32, s48 = crop[:16, :16], crop[8:40, 16:48], crop[:48, 8:56]
    a16, a32, a48 = alpha[:16, :16], alpha[8:40, 16:48], alpha[:48, 8:56]
    rgba32 = np.concatenate([s32, a32[..., None]], -1)
    return [("icns_rle_mask_16.icns", iw.icns_bytes([(b"is32", runs(s16)),
                                                    (b"s8mk", a16.tobytes())])),
            ("icns_rle_32_no_mask.icns", iw.icns_bytes([(b"il32", runs(s32))])),
            ("icns_raw_mask_32.icns", iw.icns_bytes([(b"il32", s32.tobytes()),
                                                    (b"l8mk", a32.tobytes())])),
            ("icns_rle_mask_48.icns", iw.icns_bytes([(b"is32", runs(s16)),
                                                    (b"ih32", runs(s48)),
                                                    (b"h8mk", a48.tobytes())])),
            ("icns_png_rgb_16.icns", iw.icns_bytes([(b"icp4", png_of(s16))])),
            ("icns_png_rgba_32.icns", iw.icns_bytes([(b"icp5", png_of(rgba32)),
                                                    (b"is32", runs(s16))])),
            ("icns_png_retina_16.icns", iw.icns_bytes([(b"ic11", png_of(s32))])),
            ("icns_jp2_rgb_32.icns", iw.icns_bytes([(b"icp5", jp2_of(s32))])),
            ("icns_jp2_rgba_32.icns", iw.icns_bytes([(b"icp5", jp2_of(rgba32,
                                                                      irreversible=True))])),
            ("icns_j2k_grey_32.icns", iw.icns_bytes([(b"icp5", jp2_of(s32[..., 1],
                                                                      no_jp2=True))]))]


def jpeg2000_views(views):
    """The six COLMAP views of `colmap_jpeg2000/`: JPEG 2000 of each kind."""
    from PIL import Image

    from tools import image_writers as iw

    def pil(img, **kw):
        return _pil_bytes(Image.fromarray(img), "JPEG2000", **kw)

    v4 = [views[4][..., c].astype(np.int32) for c in range(3)]
    v5 = [views[5][..., c].astype(np.int32) for c in range(3)]
    return [("view_0.jp2", pil(views[0])),
            ("view_1.jp2", pil(views[1], irreversible=True, quality_mode="rates",
                               quality_layers=[40, 10, 4])),
            ("view_2.j2k", pil(views[2], no_jp2=True, tile_size=(64, 64), progression="RPCL",
                               precinct_size=(32, 32))),
            ("view_3.jp2", pil(views[3], irreversible=True, progression="CPRL",
                               codeblock_size=(32, 32), quality_mode="dB",
                               quality_layers=[38])),
            ("view_4.jp2", iw.j2k_bytes([v4[0], v4[1][::2, ::2], v4[2][::2, ::2]],
                                        sampling=[(1, 1), (2, 2), (2, 2)], mct=False,
                                        jp2=True, colour=3)),
            ("view_5.j2k", iw.j2k_bytes(v5, style=63, sop=True, eph=True, rates=(20, 0)))]


def write_jpeg2000(src):
    """The JPEG 2000 and ICNS fixtures (module docstring); `src` is the
    1296x832 view's decode."""
    import hashlib
    import json

    from PIL import Image

    def save(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))

    crop, alpha = src[560:608, 840:904], alpha_channel(48, 64)
    for name, blob in (_j2k_pil_cases(crop, alpha) + _j2k_writer_cases(crop, alpha)
                       + _icns_cases(crop, alpha)):
        save(os.path.join(FORMATS, name), blob)
    views_dir = os.path.join(FORMATS, "colmap_jpeg2000")
    shutil.rmtree(views_dir, ignore_errors=True)
    os.makedirs(views_dir)
    views = [np.asarray(Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg")))
             for i in range(VIEWS)]
    for name, blob in jpeg2000_views(views):
        save(os.path.join(views_dir, name), blob)
    metrics = os.path.join(FORMATS, "metrics_jpeg2000")
    shutil.rmtree(metrics, ignore_errors=True)
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    for i, (y, x) in enumerate(((300, 520), (620, 900))):
        render, gt = src[y:y + 48, x:x + 64], src[y + 2:y + 50, x + 2:x + 66]
        for d, img in (("renders", render), ("gt", gt)):
            kw = dict(no_jp2=i == 1, irreversible=d == "renders")
            path = os.path.join(metrics, d, f"{i:05d}." + ("j2k" if i == 1 else "jp2"))
            with open(path, "wb") as f:
                f.write(_pil_bytes(Image.fromarray(img), "JPEG2000", **kw))
            np.save(os.path.join(metrics, "pil", f"{d}_{i:05d}.npy"), np.asarray(Image.open(path)))
    jdir = os.path.join(OUT, "jpeg2000")
    shutil.rmtree(jdir, ignore_errors=True)
    os.makedirs(jdir)
    for name, ext, kw in J2K_SCENES:
        path = os.path.join(jdir, f"{name}.{ext}")
        with open(path, "wb") as f:
            f.write(_pil_bytes(Image.fromarray(src), "JPEG2000", no_jp2=ext == "j2k", **kw))
        pil = np.asarray(Image.open(path))
        if not kw:
            assert np.array_equal(pil, src)  # lossless: the card holds it to the view
        with open(os.path.join(OUT, "pil_decode", name + "_j2k.json"), "w") as f:
            json.dump({"dtype": str(pil.dtype), "shape": list(pil.shape),
                       "sha256": hashlib.sha256(pil.tobytes()).hexdigest()}, f, indent=1)
            f.write("\n")


# The 1296x832 arithmetic-coded and lossless views (`tests/torch_fixtures/jpeg_arith/`,
# `.jpeg` so that the globs over `*.jpg` there, which want a PNG twin, skip
# them): name, and what `arith_scenes` makes of the committed 4:2:0 view.
ARITH_SCENES = ("scene_1296x832_arith", "scene_1296x832_arith_progressive",
                "scene_1296x832_jpeg_lossless")
ARITH_DAC = {0: 0x31, 1: 0x20, 16: 8, 17: 3}  # L / U of DC tables 0-1, Kx of AC tables 0-1


def arith_scenes(blob, view):
    """{name: bytes} of `ARITH_SCENES` from PIL's 4:2:0 JPEG of the view
    (`blob`) and PIL's decode of it (`view`): the JPEG arithmetic-coded
    coefficient for coefficient (DAC, a restart every 54 MCUs, a row), and
    progressive under libjpeg's scan script; the decode as a lossless
    predictor-1 RGB file, which decodes to `view` exactly. An arithmetic
    file must fit PIL's 64 KiB read blocks, as these do (44-45 KB)."""
    from tools import image_writers as iw

    return {ARITH_SCENES[0]: iw.jpeg_transcode(blob, restart_interval=54, dac=ARITH_DAC),
            ARITH_SCENES[1]: iw.jpeg_transcode(blob, scans=iw.PROGRESSIVE_3),
            ARITH_SCENES[2]: iw.jpeg_lossless_bytes(view, predictor=1)}


def _pil_jpeg(img, **kw):
    from PIL import Image

    return _pil_bytes(Image.fromarray(img), "JPEG", **kw)


def jpeg_arith_cases(crop):
    """(name, bytes) of the arithmetic-coded and lossless JPEG fixtures, from
    the 48x64 crop (module docstring)."""
    from tools import image_writers as iw
    from tools.image_writers import PROGRESSIVE_1, PROGRESSIVE_3, rgb_to_ycc

    ycc, s420, s444 = rgb_to_ycc(crop), ((2, 2), (1, 1), (1, 1)), ((1, 1),) * 3
    grey = ycc[..., 0]
    cmyk = np.concatenate([crop, 255 - crop[..., :1]], axis=2)
    pil420 = _pil_jpeg(crop, quality=90)
    arith_seq = iw.jpeg_bytes(ycc, s420, quality=90, arithmetic=True, restart_interval=3)
    arith_prog = iw.jpeg_bytes(ycc, s420, quality=90, arithmetic=True, scans=PROGRESSIVE_3)
    lossless = iw.jpeg_lossless_bytes(crop, predictor=4, restart_interval=128)
    probe = probe_image()
    out = [
        ("jpeg_arith_seq_420.jpg", iw.jpeg_transcode(pil420)),
        ("jpeg_arith_seq_420_dac_restart.jpg", iw.jpeg_transcode(pil420, restart_interval=2,
                                                                  dac=ARITH_DAC)),
        ("jpeg_arith_seq_444_dac.jpg", iw.jpeg_bytes(ycc, s444, quality=95, arithmetic=True,
                                                     dac={0: 0x52, 1: 0x10, 16: 2, 17: 40})),
        ("jpeg_arith_seq_grey_restart.jpg", iw.jpeg_bytes(grey, ((1, 1),), quality=85,
                                                          arithmetic=True, restart_interval=5)),
        ("jpeg_arith_seq_422_adobe_rgb.jpg", iw.jpeg_bytes(crop, ((2, 1), (1, 1), (1, 1)),
                                                           arithmetic=True, adobe_transform=0)),
        ("jpeg_arith_cmyk.jpg", iw.jpeg_bytes(cmyk, ((1, 1),) * 4, arithmetic=True,
                                              adobe_transform=0)),
        ("jpeg_arith_ycck.jpg", iw.jpeg_bytes(np.concatenate([ycc, cmyk[..., 3:]], axis=2),
                                              ((2, 2), (1, 1), (1, 1), (2, 2)), arithmetic=True,
                                              adobe_transform=2)),
        ("jpeg_arith_seq_420_restart.jpg", arith_seq),
        ("jpeg_arith_prog_420.jpg", iw.jpeg_transcode(pil420, scans=PROGRESSIVE_3)),
        ("jpeg_arith_prog_420_dac_restart.jpg", iw.jpeg_bytes(
            ycc, s420, quality=90, arithmetic=True, scans=PROGRESSIVE_3, restart_interval=2,
            dac={0: 0x20, 1: 0x41, 16: 20, 17: 1})),
        ("jpeg_arith_prog_partial_ac.jpg", iw.jpeg_bytes(ycc, s420, quality=90, arithmetic=True,
                                                         scans=PROGRESSIVE_3[:4])),
        ("jpeg_arith_prog_partial_refine.jpg", iw.jpeg_bytes(
            ycc, s420, quality=90, arithmetic=True, scans=PROGRESSIVE_3[:8])),
        ("jpeg_arith_prog_grey_dc.jpg", iw.jpeg_bytes(grey, ((1, 1),), quality=85,
                                                      arithmetic=True, scans=PROGRESSIVE_1[:1])),
        ("jpeg_arith_prog_grey_restart.jpg", iw.jpeg_bytes(
            grey, ((1, 1),), quality=85, arithmetic=True, scans=PROGRESSIVE_1,
            restart_interval=7)),
        ("jpeg_arith_damaged.jpg", damaged_jpeg(arith_seq, 6)),
        ("jpeg_arith_prog_damaged.jpg", damaged_jpeg(arith_prog, 7, 2)),
        ("jpeg_lossless_grey.jpg", iw.jpeg_lossless_bytes(grey, predictor=1)),
        ("jpeg_lossless_grey_jfif_p5.jpg", iw.jpeg_lossless_bytes(grey, predictor=5, jfif=True)),
        ("jpeg_lossless_p7_pt2.jpg", iw.jpeg_lossless_bytes(crop, predictor=7,
                                                            point_transform=2)),
        ("jpeg_lossless_restart_p4.jpg", lossless),
        ("jpeg_lossless_420.jpg", iw.jpeg_lossless_bytes(crop, predictor=6, sampling=s420)),
        ("jpeg_lossless_411_restart.jpg", iw.jpeg_lossless_bytes(
            crop, predictor=2, sampling=((4, 1), (1, 1), (1, 1)), restart_interval=32)),
        ("jpeg_lossless_separate_scans.jpg", iw.jpeg_lossless_bytes(crop, predictor=3,
                                                                    separate=True)),
        # libjpeg resets the predictors of a non-interleaved scan's iMCU row
        # (here two rows of component 0) when a restart falls inside it,
        # before any of its rows is undifferenced: PIL's decode is not the
        # source, and the port's must be PIL's.
        ("jpeg_lossless_separate_v2_restart.jpg", iw.jpeg_lossless_bytes(
            crop, predictor=1, sampling=((1, 2), (1, 1), (1, 1)), separate=True,
            restart_interval=64)),
        ("jpeg_lossless_adobe_rgb_ids.jpg", iw.jpeg_lossless_bytes(crop, predictor=2,
                                                                   adobe_transform=0,
                                                                   ids=(82, 71, 66))),
        ("jpeg_lossless_cmyk.jpg", iw.jpeg_lossless_bytes(cmyk, predictor=7)),
        ("jpeg_lossless_damaged.jpg", damaged_jpeg(lossless, 8, 2)),
        ("jpeg_probe_arith_restart.jpg", iw.jpeg_bytes(rgb_to_ycc(probe), s420, quality=90,
                                                       arithmetic=True, restart_interval=2,
                                                       dac=ARITH_DAC)),
        ("jpeg_probe_arith_progressive.jpg", iw.jpeg_bytes(rgb_to_ycc(probe), s420, quality=90,
                                                           arithmetic=True, scans=PROGRESSIVE_3)),
        ("jpeg_probe_lossless_restart.jpg", iw.jpeg_lossless_bytes(probe, predictor=4,
                                                                   restart_interval=96)),
        ("tif_jpeg_arith_ycbcr420.tif", iw.tiff_bytes(
            ycc, 6, compression=7, rows_per_strip=16,
            jpeg=dict(sampling=s420, subsampling=(2, 2), arithmetic=True, dac=ARITH_DAC,
                      restart_interval=2))),
        ("tif_jpeg_arith_rgb_progressive_tiled.tif", iw.tiff_bytes(
            crop, 2, compression=7, tile=(32, 32), jpeg=dict(arithmetic=True,
                                                             scans=PROGRESSIVE_3))),
        ("tif_jpeg_lossless_rgb.tif", iw.tiff_bytes(crop, 2, compression=7, rows_per_strip=16,
                                                    jpeg=dict(lossless=dict(predictor=6)))),
        ("tif_jpeg_lossless_grey_pt1.tif", iw.tiff_bytes(
            grey, 1, compression=7, rows_per_strip=24,
            jpeg=dict(lossless=dict(predictor=1, point_transform=1))))]
    out += [(f"jpeg_lossless_p{p}.jpg", iw.jpeg_lossless_bytes(crop, predictor=p))
            for p in range(1, 8)]
    return out


def jpeg_arith_views(views):
    """The six COLMAP views of `colmap_jpeg_arith/`, from PIL's JPEGs of the
    `colmap_jpeg` views and their decodes (`views`)."""
    from tools import image_writers as iw

    blobs = [open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg"), "rb").read()
             for i in range(VIEWS)]
    s420 = ((2, 2), (1, 1), (1, 1))
    return [("view_0.jpg", iw.jpeg_transcode(blobs[0], restart_interval=5, dac=ARITH_DAC)),
            ("view_1.jpg", iw.jpeg_transcode(blobs[1], scans=iw.PROGRESSIVE_3)),
            ("view_2.jpg", iw.jpeg_lossless_bytes(views[2], predictor=1, separate=True,
                                                  restart_interval=400)),
            ("view_3.jpg", iw.jpeg_lossless_bytes(views[3], predictor=7, point_transform=1)),
            ("view_4.jpg", iw.jpeg_lossless_bytes(views[4], predictor=5, sampling=s420,
                                                  restart_interval=200)),
            ("view_5.tif", iw.tiff_bytes(iw.rgb_to_ycc(views[5]), 6, compression=7,
                                         rows_per_strip=32,
                                         jpeg=dict(sampling=s420, subsampling=(2, 2),
                                                   arithmetic=True)))]


def write_jpeg_arith(src):
    """The arithmetic-coded and lossless JPEG fixtures (module docstring);
    `src` is the 1296x832 view's decode."""
    import hashlib
    import json

    from PIL import Image

    def save(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))

    crop = src[560:608, 840:904]
    for name, blob in jpeg_arith_cases(crop):
        save(os.path.join(FORMATS, name), blob)
    views_dir = os.path.join(FORMATS, "colmap_jpeg_arith")
    shutil.rmtree(views_dir, ignore_errors=True)
    os.makedirs(views_dir)
    views = [np.asarray(Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg")))
             for i in range(VIEWS)]
    for name, blob in jpeg_arith_views(views):
        save(os.path.join(views_dir, name), blob)
    from tools import image_writers as iw

    metrics = os.path.join(FORMATS, "metrics_jpeg_arith")
    shutil.rmtree(metrics, ignore_errors=True)
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    for i, (y, x) in enumerate(((300, 520), (620, 900))):
        render, gt = src[y:y + 48, x:x + 64], src[y + 2:y + 50, x + 2:x + 66]
        for d, blob in (("renders", iw.jpeg_transcode(_pil_jpeg(render, quality=90),
                                                      restart_interval=4 if i else 0)),
                        ("gt", iw.jpeg_transcode(_pil_jpeg(gt, quality=95),
                                                 scans=iw.PROGRESSIVE_3) if i == 0
                         else iw.jpeg_lossless_bytes(gt, predictor=7))):
            path = os.path.join(metrics, d, f"{i:05d}.jpg")
            with open(path, "wb") as f:
                f.write(blob)
            np.save(os.path.join(metrics, "pil", f"{d}_{i:05d}.npy"), np.asarray(Image.open(path)))
    adir = os.path.join(OUT, "jpeg_arith")
    shutil.rmtree(adir, ignore_errors=True)
    os.makedirs(adir)
    with open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg"), "rb") as f:
        base = f.read()
    for name, blob in arith_scenes(base, src).items():
        path = os.path.join(adir, f"{name}.jpeg")
        with open(path, "wb") as f:
            f.write(blob)
        pil = np.asarray(Image.open(path))
        assert np.array_equal(pil, src)  # the same coefficients, or lossless: the view itself
        with open(os.path.join(OUT, "pil_decode", name + "_jpeg.json"), "w") as f:
            json.dump({"dtype": str(pil.dtype), "shape": list(pil.shape),
                       "sha256": hashlib.sha256(pil.tobytes()).hexdigest()}, f, indent=1)
            f.write("\n")


# The 1296 x 832 files the card times and holds to PIL's SHA-256
# (`pil_decode/<name>.json`), all built from seeds or the view by
# `plugin_scenes`: (name, what).
PLUGIN_SCENES = ("scene_1296x832_ojpeg_tables", "scene_1296x832_blp2_dxt1",
                 "scene_768x512_pcd")


def plugin_scenes(view):
    """{name: bytes} of the files in PLUGIN_SCENES: an old-style JPEG TIFF
    (table form, 4:2:0, 64-row strips) of the 1296 x 832 view, a BLP2 of
    seeded DXT1 blocks at that size, and a PhotoCD base image of seeded
    planes (orientation 0)."""
    from tools import image_writers as iw

    rng = np.random.default_rng(31)
    blocks = rng.integers(0, 256, 324 * 208 * 8, dtype=np.uint8).tobytes()
    planes = (rng.integers(0, 256, (512, 768), dtype=np.uint8),
              rng.integers(0, 256, (256, 384), dtype=np.uint8),
              rng.integers(0, 256, (256, 384), dtype=np.uint8))
    return {"scene_1296x832_ojpeg_tables": iw.ojpeg_tiff_bytes(
                iw.rgb_to_ycc(view), ((2, 2), (1, 1), (1, 1)), form="tables", quality=90,
                rows_per_strip=64, subsampling=(2, 2)),
            "scene_1296x832_blp2_dxt1": iw.blp_bytes(2, 1296, 832, blocks, encoding=2,
                                                     alpha=8, alpha_encoding=0),
            "scene_768x512_pcd": iw.pcd_bytes(*planes)}


def _pil_save(img, fmt, **kw):
    import io

    from PIL import Image

    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, fmt, **kw)
    return buf.getvalue()


def _jpeg_halves(blob):
    at = blob.index(b"\xff\xda")
    return blob[:at], blob[at:]


def plugin_cases(crop, alpha):
    """(name, bytes) of the committed files of `utils/image_plugins.py`'s
    formats and of old-style JPEG TIFF: each kind at most 64 x 48."""
    from PIL import Image

    from tools import image_writers as iw

    rng = np.random.default_rng(27)
    rgb = crop
    grey = np.asarray(Image.fromarray(crop).convert("L"))
    rgba = np.concatenate([crop, alpha[..., None]], axis=2)
    h, w = grey.shape
    quant = Image.fromarray(crop).quantize(64)
    idx = np.asarray(quant)
    bgra = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    s420, s422 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
    ycc = iw.rgb_to_ycc(rgb)
    head, rest = _jpeg_halves(_pil_save(rgb, "JPEG", quality=90))
    blocks = lambda n: rng.integers(0, 256, (-(-w // 4)) * (-(-h // 4)) * n,  # noqa: E731
                                    dtype=np.uint8).tobytes()
    rows = lambda a: np.ascontiguousarray(a[::-1])  # noqa: E731  (IM rows bottom-up)
    palette = rng.integers(0, 256, (256, 3))
    return [
        ("ojpeg_interchange_420.tif", iw.ojpeg_tiff_bytes(ycc, s420)),
        ("ojpeg_interchange_422_strip.tif", iw.ojpeg_tiff_bytes(ycc, s422, strips=True,
                                                                subsampling=(2, 2))),
        ("ojpeg_tables_420.tif", iw.ojpeg_tiff_bytes(ycc, s420, form="tables",
                                                     rows_per_strip=16, subsampling=(2, 2))),
        ("ojpeg_tables_444_photo2.tif", iw.ojpeg_tiff_bytes(ycc, ((1, 1),) * 3, form="tables",
                                                            rows_per_strip=8, photometric=2,
                                                            subsampling=(1, 1))),
        ("ojpeg_grey.tif", iw.ojpeg_tiff_bytes(grey, ((1, 1),), form="tables",
                                               rows_per_strip=16, photometric=1)),
        ("dib_pil_rgb.dib", _pil_save(rgb, "DIB")),
        ("dib_pal8.dib", iw.bmp_bytes(idx, 8, palette=np.asarray(quant.getpalette()[:768],
                                                                  np.uint8).reshape(-1, 3))[14:]),
        ("blp1_jpeg.blp", iw.blp_bytes(1, w, h, rest, compression=0, encoding=5,
                                       jpeg_header=head)),
        ("blp1_palette.blp", iw.blp_bytes(1, w, h, idx.tobytes(), palette=bgra, encoding=4)),
        ("blp2_pil.blp", _pil_save(quant, "BLP")),
        ("blp2_dxt1.blp", iw.blp_bytes(2, w, h, blocks(8), encoding=2, alpha=8,
                                       alpha_encoding=0)),
        ("blp2_dxt3.blp", iw.blp_bytes(2, w, h, blocks(16), encoding=2, alpha=8,
                                       alpha_encoding=1)),
        ("blp2_dxt5.blp", iw.blp_bytes(2, w, h, blocks(16), encoding=2, alpha=8,
                                       alpha_encoding=7)),
        ("dcx_pcx.dcx", iw.dcx_bytes([_pil_save(rgb, "PCX"), _pil_save(idx, "PCX")])),
        ("fits_8.fits", iw.fits_bytes(grey, 8)),
        ("fits_16.fits", iw.fits_bytes(grey.astype(np.int16) * 100 - 9000, 16,
                                       cards=["BZERO   =                32768"])),
        ("fits_m32.fits", iw.fits_bytes(grey.astype(np.float32) / 3 - 7, -32)),
        ("fits_m64.fits", iw.fits_bytes(grey.astype(np.float64) / 9, -64)),
        ("flc_brun.flc", iw.fli_bytes(w, h, [(4, iw.fli_color(palette)),
                                             (15, iw.fli_brun(idx))])),
        ("fli_ss2_lc.fli", iw.fli_bytes(w, h, [(11, iw.fli_color(palette, six_bits=True)),
                                               (7, iw.fli_ss2(idx)), (12, iw.fli_lc(idx, 5, 3))],
                                        flc=False)),
        ("ftex_dxt1.ftc", iw.ftex_bytes(w, h, 0, blocks(8))),
        ("ftex_rgb.ftu", iw.ftex_bytes(w, h, 1, rgb.tobytes())),
        ("gbr_v2_rgba.gbr", iw.gbr_bytes(rgba)),
        ("gbr_v1_l.gbr", iw.gbr_bytes(grey, version=1)),
        ("im_pil_rgb.im", _pil_save(rgb, "IM")),
        ("im_pil_p.im", _pil_save(quant, "IM")),
        ("im_rgb3.im", iw.im_bytes("RGB3 image", w, h, np.concatenate(
            [rows(rgb[..., c]).ravel() for c in (1, 0, 2)]).tobytes())),
        ("im_pa_lut.im", iw.im_bytes("PA image", w, h, np.ascontiguousarray(
            rows(rgba[..., :2]).transpose(0, 2, 1)).tobytes(), lut=palette)),
        ("im_bits12.im", iw.im_bytes("L*12 image", w, h, rng.integers(
            0, 256, (w * 12 + 7) // 8 * h, dtype=np.uint8).tobytes())),
        ("im_l16b.im", iw.im_bytes("L 16B image", w, h, rows(grey.astype(">u2") * 255)
                                   .tobytes())),
        ("imt_l.imt", iw.imt_bytes(grey)),
        ("iptc_l.iim", iw.iptc_bytes(grey.tobytes(), w, h, parts=2)),
        ("iptc_rgb_band2.iim", iw.iptc_bytes(grey.tobytes(), w, h, 3, 1, band=1)),
        ("mcidas_i16.mcidas", iw.mcidas_bytes(grey.astype(">u2") * 257, prefix=4)),
        ("msp_v1.msp", _pil_save(grey > 120, "MSP")),
        ("msp_v2.msp", iw.msp_bytes(grey > 120)),
        ("pixar.pxr", iw.pixar_bytes(rgb)),
        ("spider.spider", _pil_save(Image.fromarray(grey.astype(np.float32) / 5), "SPIDER")),
        ("xbm.xbm", _pil_save(grey > 120, "XBM")),
        ("xpm_p.xpm", iw.xpm_bytes(idx, np.asarray(quant.getpalette()[:192]).reshape(64, 3),
                                   bpp=2)),
        ("xpm_rgb.xpm", iw.xpm_bytes(rng.integers(0, 300, (h, w)),
                                     rng.integers(0, 256, (300, 3)), bpp=2)),
        ("xvthumb.xvthumb", iw.xvthumb_bytes(idx)),
    ]


def plugin_views(views):
    """The six COLMAP views of `colmap_plugins/`: old-style JPEG TIFFs in
    the interchange and table forms, a BLP1 JPEG, a BLP2 (PIL's writer, 256
    colours), an IM RGB (PIL's writer) and a PIXAR raster."""
    from PIL import Image

    from tools import image_writers as iw

    s420 = ((2, 2), (1, 1), (1, 1))
    head, rest = _jpeg_halves(_pil_save(views[2], "JPEG", quality=90))
    h, w = views[2].shape[:2]
    return [("view_0.tif", iw.ojpeg_tiff_bytes(iw.rgb_to_ycc(views[0]), s420, strips=True)),
            ("view_1.tif", iw.ojpeg_tiff_bytes(iw.rgb_to_ycc(views[1]), s420, form="tables",
                                               rows_per_strip=32, subsampling=(2, 2))),
            ("view_2.blp", iw.blp_bytes(1, w, h, rest, compression=0, encoding=5,
                                        jpeg_header=head)),
            ("view_3.blp", _pil_save(Image.fromarray(views[3]).quantize(256), "BLP")),
            ("view_4.im", _pil_save(views[4], "IM")),
            ("view_5.pxr", iw.pixar_bytes(views[5]))]


def write_plugins(src):
    """The old-style JPEG TIFF and image-plugin fixtures (module docstring);
    `src` is the 1296x832 view's decode."""
    import hashlib
    import json

    from PIL import Image

    from tools import image_writers as iw

    def save(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
        np.save(os.path.splitext(path)[0] + ".npy", np.asarray(Image.open(path)))

    crop = src[380:428, 200:264]
    y, x = np.mgrid[0:48, 0:64]
    alpha = ((x * 4 + y * 3) % 256).astype(np.uint8)
    for name, blob in plugin_cases(crop, alpha):
        save(os.path.join(FORMATS, name), blob)
    views_dir = os.path.join(FORMATS, "colmap_plugins")
    shutil.rmtree(views_dir, ignore_errors=True)
    os.makedirs(views_dir)
    views = [np.asarray(Image.open(os.path.join(OUT, "colmap_jpeg", "images", f"view_{i}.jpg")))
             for i in range(VIEWS)]
    for name, blob in plugin_views(views):
        save(os.path.join(views_dir, name), blob)
    metrics = os.path.join(FORMATS, "metrics_plugins")
    shutil.rmtree(metrics, ignore_errors=True)
    for d in ("renders", "gt", "pil"):
        os.makedirs(os.path.join(metrics, d))
    s420 = ((2, 2), (1, 1), (1, 1))
    for i, (yy, xx) in enumerate(((300, 520), (620, 900))):
        render, gt = src[yy:yy + 48, xx:xx + 64], src[yy + 2:yy + 50, xx + 2:xx + 66]
        for d, img in (("renders", render), ("gt", gt)):
            if i == 0:
                name = "00000.tif"
                blob = (iw.ojpeg_tiff_bytes(iw.rgb_to_ycc(img), s420, form="tables",
                                            rows_per_strip=16, subsampling=(2, 2))
                        if d == "renders" else iw.ojpeg_tiff_bytes(iw.rgb_to_ycc(img), s420))
            else:
                name = "00001.pxr"
                blob = iw.pixar_bytes(img)
            path = os.path.join(metrics, d, name)
            with open(path, "wb") as f:
                f.write(blob)
            np.save(os.path.join(metrics, "pil", f"{d}_{os.path.splitext(name)[0]}.npy"),
                    np.asarray(Image.open(path)))
    for name, blob in plugin_scenes(src).items():
        import io

        pil = np.asarray(Image.open(io.BytesIO(blob)))
        with open(os.path.join(OUT, "pil_decode", name + ".json"), "w") as f:
            json.dump({"dtype": str(pil.dtype), "shape": list(pil.shape),
                       "sha256": hashlib.sha256(pil.tobytes()).hexdigest()}, f, indent=1)
            f.write("\n")


def main(argv=None) -> int:
    from PIL import Image, ImageFile

    args = argv or sys.argv[1:]
    if "--plugins" in args:
        write_plugins(np.asarray(Image.open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg"))))
        return 0
    if "--jpeg-arith" in args:
        write_jpeg_arith(np.asarray(Image.open(os.path.join(OUT, "jpeg",
                                                            "scene_1296x832_420.jpg"))))
        return 0
    if "--jpeg2000" in args:
        write_jpeg2000(np.asarray(Image.open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg"))))
        return 0
    if "--readers" in args:
        write_readers(np.asarray(Image.open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg"))))
        return 0
    if "--codecs" in args:
        write_codecs(np.asarray(Image.open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg"))))
        return 0
    if "--formats" in args or "--raster" in args:
        decoded = np.asarray(Image.open(os.path.join(OUT, "jpeg", "scene_1296x832_420.jpg")))
        if "--formats" in args:
            write_formats(decoded)
            write_dataset_webps(decoded)
            write_codecs(decoded)
            write_readers(decoded)
            write_jpeg2000(decoded)
            write_jpeg_arith(decoded)
            write_plugins(decoded)
        write_raster(decoded)
        return 0

    from wast3d_tpu_torch.scene import colmap as cm
    from wast3d_tpu_torch.utils.png import encode_png

    ImageFile.MAXBLOCK = 1 << 22  # PIL's progressive encoder needs the room
    shutil.rmtree(OUT, ignore_errors=True)
    src = os.path.join(OUT, "colmap_jpeg")
    sparse, images = os.path.join(src, "sparse", "0"), os.path.join(src, "images")
    progressive = os.path.join(src, "images_progressive")
    decodes, jpeg = os.path.join(OUT, "pil_decode"), os.path.join(OUT, "jpeg")
    pngs, resized = os.path.join(OUT, "png"), os.path.join(OUT, "resize")
    for d in (sparse, images, progressive, decodes, jpeg, pngs, resized):
        os.makedirs(d)
    scene, xyz, rgb = procedural_scene()
    cams = {1: cm.ColmapCamera(1, "PINHOLE", W, H, np.array([FOCAL, FOCAL, W / 2, H / 2]))}
    imgs = {}
    for i in range(VIEWS):
        a = 2 * np.pi * i / VIEWS
        eye = np.array([3.2 * np.sin(a), -0.6, -3.2 * np.cos(a)])
        R_wc = look_at(eye)
        q = rotmat2qvec(R_wc)
        R_wc = cm.qvec2rotmat(q)  # exactly what the loader rebuilds
        t = -R_wc @ eye
        name = f"view_{i}.jpg"
        imgs[i + 1] = cm.ColmapImage(i + 1, q, t, 1, name)
        save_jpeg(os.path.join(images, name), render(scene, R_wc, t, W, H, FOCAL), decodes,
                  progressive=os.path.join(progressive, name), quality=90)
    cm.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    cm.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
    rng = np.random.default_rng(8)
    keep = rng.permutation(len(xyz))[:2000]
    cm.write_points3d_binary(xyz[keep] + rng.normal(scale=0.02, size=(2000, 3)),
                             np.clip(rgb[keep] * 255, 0, 255).astype(np.uint8),
                             os.path.join(sparse, "points3D.bin"))

    eye = np.array([2.0, -0.8, -2.6])
    R_wc = look_at(eye)
    big = render(scene, R_wc, -R_wc @ eye, 1296, 832, 1100.0)
    decoded = save_jpeg(os.path.join(jpeg, "scene_1296x832_420.jpg"), big, decodes,
                        progressive=os.path.join(jpeg, "scene_1296x832_420_progressive.jpg"),
                        quality=85, subsampling=2)
    save_jpeg(os.path.join(jpeg, "crop_250x131_444.jpg"), big[300:431, 500:750], decodes,
              progressive=os.path.join(jpeg, "crop_250x131_444_progressive.jpg"),
              twin_kw=dict(restart_marker_blocks=3), quality=95, subsampling=0)

    for name, crop, kw in (("adam7_rgba_67x45", big[400:445, 600:667], dict(interlace=True)),
                           ("paeth_rgba_200x150", big[200:350, 300:500], dict(filter_type=4))):
        rgba = np.concatenate([crop, alpha_channel(*crop.shape[:2])[..., None]], axis=2)
        path = os.path.join(pngs, name + ".png")
        with open(path, "wb") as f:
            f.write(encode_png(rgba, **kw))
        write_png_up(os.path.join(decodes, name + ".png"), np.asarray(Image.open(path)))
    wide = np.concatenate([decoded, decoded[:, :404]], axis=1)[:96]
    for name, img, size in (("scene_648x416", decoded, (648, 416)),
                            ("scene_432x277", decoded, (432, 277)),
                            ("wide_1600x90", wide, (1600, 90))):
        write_png_up(os.path.join(resized, name + ".png"),
                     np.asarray(Image.fromarray(img).resize(size)))
    write_formats(decoded)
    write_dataset_webps(decoded)
    write_codecs(decoded)
    write_readers(decoded)
    write_jpeg2000(decoded)
    write_jpeg_arith(decoded)
    write_plugins(decoded)
    write_raster(decoded)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
