"""Write the image files that ``scenes.build_config5_images`` and
``chip_smoke.py`` read, and Pillow's decode of each of them.

    python3 tests/torch_images/make_images.py

Needs Pillow and OpenCV (the port's package uses neither). The content is
smooth and made from seeded numpy, so that PNG and RLE compress and the
folder stays small. Writes, beside this script:

- the level's files: ``terrain_checker.jpg`` (512x512, 4:2:0, quality 85),
  ``sphere_skin.bmp`` (256x256, 24-bit), ``plaza_palette.png`` (128x128,
  8-bit palette with a tRNS chunk of partial alphas), ``sign_alpha.tga``
  (256x256, 32-bit RLE, alpha a vertical gradient), ``hud_movie.gif``
  (64x64, 3 frames, local palettes, a transparent index, disposal 2,
  40/60/100 ms) and ``hud_movie_apng.png`` (64x64, 3 frames blended over,
  50/70/90 ms);
- one file of each variant Pillow cannot write, written by hand
  (``tests/_torch_image_writers.py``): ``adam7.png`` (Adam7, 8-bit RGBA),
  ``rle4.bmp``, ``rle8.bmp``, ``tga16.tga`` (16-bit truecolour) and
  ``tiled_planar.tif`` (planar RGB in 16x16 tiles, Deflate, predictor 2);
- the level's AVI sprites: ``hud_mjpg.avi`` (64x64 MJPG 4:2:0, 4 frames
  at 12.5 fps, written by OpenCV's ``VideoWriter``) and ``hud_rle.avi``
  (64x64 8-bit MS RLE, 4 frames at 30000/1001 fps, written by hand);
- one small AVI per other codec the port reads (``AVI_CODECS``, 64x64, 4
  frames, hand-written): raw I420, YUY2, RGB555 and 8-bit palettised
  frames, MS RLE 4, MS Video 1 16 and PNG frames;
- ``expected.npz``: for each file, ``<file>:<frame>`` the reference's
  RGBA uint8 of every frame (Pillow's ``ImageSequence.Iterator`` and
  ``convert("RGBA")``; for an AVI, OpenCV's ``VideoCapture.read`` with
  alpha 255) and ``<file>:durations`` each frame's duration in ms as the
  reference's ``LoadMovie`` takes it (100 where Pillow reports none;
  ``1000 / CAP_PROP_FPS`` for an AVI).

Nothing imports this script.
"""

from __future__ import annotations

import os
import sys

import cv2
import numpy as np
from PIL import Image, ImageSequence

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from tests._torch_image_writers import (  # noqa: E402
    avi_bytes, avi_movie, movie_indices, msrle_frame, write_bmp_rle,
    write_png, write_tga16, write_tiff,
)

LEVEL = ("terrain_checker.jpg", "sphere_skin.bmp", "plaza_palette.png",
         "sign_alpha.tga", "hud_movie.gif", "hud_movie_apng.png")
VARIANTS = ("adam7.png", "rle4.bmp", "rle8.bmp", "tga16.tga",
            "tiled_planar.tif")
HUD_AVI = ("hud_mjpg.avi", "hud_rle.avi")
# The other codecs' AVIs: file name -> tests/_torch_image_writers.avi_movie
# variant.
AVI_CODECS = {"avi_i420.avi": "i420", "avi_yuy2.avi": "yuy2",
              "avi_rgb555.avi": "rgb555", "avi_pal8.avi": "pal8",
              "avi_msrle4.avi": "msrle4", "avi_cram16.avi": "cram16",
              "avi_mpng.avi": "mpng"}


def smooth(rng, h: int, w: int, bands: int, scale: float) -> np.ndarray:
    """(h, w, bands) float in [0, 1]: a few seeded low-frequency waves."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((h, w, bands))
    for b in range(bands):
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 2.0, 2) * np.pi / scale
            ph = rng.uniform(0, 2 * np.pi)
            out[..., b] += np.sin(x * fx + y * fy + ph)
    return (out - out.min()) / (out.max() - out.min())


def terrain_checker(rng) -> Image.Image:
    """Ballance's stone floor: 64-pixel tiles of two tones, each shaded by
    a smooth wave."""
    h = w = 512
    y, x = np.mgrid[0:h, 0:w]
    tile = ((x // 64 + y // 64) % 2).astype(np.float64)[..., None]
    light = np.array([0.88, 0.84, 0.70])
    dark = np.array([0.32, 0.36, 0.30])
    base = tile * light + (1 - tile) * dark
    img = base * (0.85 + 0.15 * smooth(rng, h, w, 3, 90.0))
    return Image.fromarray((img * 255).round().astype(np.uint8))


def sphere_skin(rng) -> Image.Image:
    h = w = 256
    y, x = np.mgrid[0:h, 0:w]
    stripes = (((x + y) // 32) % 2).astype(np.float64)[..., None]
    img = (0.25 + 0.55 * stripes * np.array([1.0, 0.45, 0.2])
           + 0.2 * smooth(rng, h, w, 3, 40.0))
    img = np.clip(img, 0, 1) * 255
    return Image.fromarray((img // 8 * 8).astype(np.uint8))


def plaza_palette(rng) -> Image.Image:
    rgb = (smooth(rng, 128, 128, 3, 30.0) * 255).astype(np.uint8)
    im = Image.fromarray(rgb).quantize(32)
    alphas = bytes(int(a) for a in np.linspace(0, 255, 32).round())
    im.info["transparency"] = alphas
    return im


def sign_alpha(rng) -> Image.Image:
    """32-bit RGBA: colour bands constant along each row (so RLE packs a
    row into a few runs), alpha a gradient from top to bottom."""
    h = w = 256
    rows = smooth(rng, h, 1, 3, 25.0)[:, 0]
    band = np.arange(w) // 64
    rgb = np.empty((h, w, 3))
    for b in range(4):
        rgb[:, band == b] = (rows * (0.5 + 0.5 * b / 3))[:, None]
    alpha = np.linspace(40, 255, h)[:, None].repeat(w, 1)
    img = np.concatenate([rgb * 255, alpha[..., None]], axis=2)
    return Image.fromarray(img.round().astype(np.uint8), "RGBA")


def movie_frames(rng, n: int = 3):
    """``n`` 64x64 RGB frames: a disc moving over a smooth ground."""
    frames = []
    y, x = np.mgrid[0:64, 0:64]
    for k in range(n):
        ground = smooth(rng, 64, 64, 3, 20.0) * 0.6
        disc = (x - 16 - 14 * k) ** 2 + (y - 32) ** 2 < 100
        ground[disc] = (0.95, 0.75, 0.1)
        frames.append((ground * 255).astype(np.uint8))
    return frames


def write_level(rng) -> None:
    terrain_checker(rng).save(os.path.join(HERE, "terrain_checker.jpg"),
                              quality=85, subsampling=2)
    sphere_skin(rng).save(os.path.join(HERE, "sphere_skin.bmp"))
    plaza = plaza_palette(rng)
    plaza.save(os.path.join(HERE, "plaza_palette.png"),
               transparency=plaza.info["transparency"])
    sign_alpha(rng).save(os.path.join(HERE, "sign_alpha.tga"),
                         compression="tga_rle")
    gif = [Image.fromarray(f).quantize(24 + 8 * k)
           for k, f in enumerate(movie_frames(rng))]
    gif[0].save(os.path.join(HERE, "hud_movie.gif"), save_all=True,
                append_images=gif[1:], duration=[40, 60, 100], disposal=2,
                transparency=0, optimize=False, loop=0)
    apng = []
    for k, f in enumerate(movie_frames(rng)):
        a = np.full((64, 64, 1), 255, np.uint8)
        a[:, :16 + 16 * k] = 96 + 40 * k
        apng.append(Image.fromarray(np.concatenate([f, a], 2), "RGBA"))
    apng[0].save(os.path.join(HERE, "hud_movie_apng.png"), save_all=True,
                 append_images=apng[1:], duration=[50, 70, 90], blend=1,
                 disposal=0, loop=0)


def write_avis(rng) -> None:
    out = cv2.VideoWriter(os.path.join(HERE, "hud_mjpg.avi"),
                          cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"MJPG"),
                          12.5, (64, 64))
    for f in movie_frames(rng, 4):
        out.write(np.ascontiguousarray(f[..., ::-1]))
    out.release()
    idx = movie_indices(rng, 4, 64, 64, 256)
    pal = (smooth(rng, 16, 16, 3, 6.0).reshape(256, 3) * 255).astype(int)
    rle = [msrle_frame(f, idx[k - 1] if k else None, 8)
           for k, f in enumerate(idx)]
    with open(os.path.join(HERE, "hud_rle.avi"), "wb") as f:
        f.write(avi_bytes(rle, 64, 64, 1, 8, palette=pal, rate=30000,
                          scale=1001))
    for name, kind in AVI_CODECS.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(avi_movie(kind, rng, n=4, h=64, w=64))


def opencv_frames(path: str):
    """OpenCV's frames of a movie as the reference's ``LoadMovie`` takes
    them: RGBA uint8 (alpha 255) and ``1000 / fps`` ms each."""
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        rgba = np.full(f.shape[:2] + (4,), 255, np.uint8)
        rgba[..., :3] = f[..., 2::-1]
        frames.append(rgba)
    cap.release()
    dur = 1000.0 / fps if fps > 1e-3 else 100.0
    return frames, [dur] * len(frames)


def write_variants(rng) -> None:
    rgba = (smooth(rng, 29, 37, 4, 9.0) * 255).astype(np.uint8)
    write_png(os.path.join(HERE, "adam7.png"), rgba, 8, 6, interlace=True)
    pal = rng.integers(0, 256, (12, 3))
    idx = (smooth(rng, 30, 40, 1, 8.0)[..., 0] * 11.99).astype(np.uint8)
    write_bmp_rle(os.path.join(HERE, "rle4.bmp"), idx, pal, 4)
    pal = rng.integers(0, 256, (100, 3))
    idx = (smooth(rng, 36, 48, 1, 8.0)[..., 0] * 99.99).astype(np.uint8)
    write_bmp_rle(os.path.join(HERE, "rle8.bmp"), idx, pal, 8)
    rgba = (smooth(rng, 24, 32, 4, 7.0) * 255).astype(np.uint8)
    write_tga16(os.path.join(HERE, "tga16.tga"), rgba, alpha_bits=1)
    rgb = (smooth(rng, 40, 40, 3, 9.0) * 255).astype(np.uint8)
    write_tiff(os.path.join(HERE, "tiled_planar.tif"), rgb, 2, planar=True,
               tile=16, compression=8, predictor=2)


def pillow_frames(path: str):
    """Pillow's RGBA of every frame and each frame's duration, as the
    reference's ``LoadMovie`` takes them."""
    frames, durations = [], []
    for fr in ImageSequence.Iterator(Image.open(path)):
        frames.append(np.asarray(fr.convert("RGBA")))
        durations.append(float(fr.info.get("duration", 100.0)))
    return frames, durations


def expected() -> dict:
    out = {}
    for name in LEVEL + VARIANTS + HUD_AVI + tuple(AVI_CODECS):
        read = opencv_frames if name.endswith(".avi") else pillow_frames
        frames, durations = read(os.path.join(HERE, name))
        for k, f in enumerate(frames):
            out[f"{name}:{k}"] = f
        out[f"{name}:durations"] = np.asarray(durations, np.float64)
    return out


def main() -> None:
    rng = np.random.default_rng(23)
    write_level(rng)
    write_variants(rng)
    write_avis(np.random.default_rng(26))
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **expected())
    total = sum(os.path.getsize(os.path.join(HERE, f))
                for f in os.listdir(HERE))
    print(f"{HERE}: {total} bytes")


if __name__ == "__main__":
    main()
