"""DDS container parsing + DXT1/3/5 block decompression (host, numpy).

Carried from ``ckrenderengine_tpu.io.dds``: the same decode, array for
array. The reference's texture loader ingests DXT-compressed surfaces with
mipmaps (CKDX9RasterizerContext::LoadTexture, src/CKRasterizer/
CKDX9Rasterizer/CKDX9RasterizerContext.cpp:1836-2060, where the blocks are
handed to D3D). Here the blocks decode to RGBA float at load time on the
host and ride the regular texture-plane stack, which the deferred shade
samples.

All decoders are fully vectorized over blocks — a 1024x1024 DXT5 surface
decodes in a few ms.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode_dxt", "load_dds", "is_dds"]

_DDS_MAGIC = b"DDS "
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40
_DDPF_ALPHAPIXELS = 0x1
_DDSD_MIPMAPCOUNT = 0x20000


def _expand565(c):
    """(N,) uint16 RGB565 -> (N,3) float32 in [0,1] (bit-replication, the
    standard BC decode)."""
    r = ((c >> 11) & 31).astype(np.uint16)
    g = ((c >> 5) & 63).astype(np.uint16)
    b = (c & 31).astype(np.uint16)
    r = (r << 3) | (r >> 2)
    g = (g << 2) | (g >> 4)
    b = (b << 3) | (b >> 2)
    return np.stack([r, g, b], -1).astype(np.float32) / 255.0


def _color_blocks(c0, c1, bits, three_color_mode):
    """Decode the shared DXT color block: c0/c1 (N,) uint16, bits (N,)
    uint32, three_color_mode (N,) bool (DXT1 with c0<=c1).

    Returns rgb (N,16,3) float32 and transparent (N,16) bool (the 3-color
    mode's index-3 punch-through)."""
    p0 = _expand565(c0)
    p1 = _expand565(c1)
    # 4-color palette
    p2_4 = (2.0 * p0 + p1) / 3.0
    p3_4 = (p0 + 2.0 * p1) / 3.0
    # 3-color palette
    p2_3 = (p0 + p1) / 2.0
    mode3 = three_color_mode[:, None]
    p2 = np.where(mode3, p2_3, p2_4)
    p3 = np.where(mode3, 0.0, p3_4)
    palette = np.stack([p0, p1, p2, p3], 1)              # (N,4,3)
    k = np.arange(16, dtype=np.uint32)
    idx = (bits[:, None] >> (2 * k)[None, :]) & 3        # (N,16)
    rgb = np.take_along_axis(palette, idx[..., None].astype(np.int64), 1)
    transparent = three_color_mode[:, None] & (idx == 3)
    return rgb.astype(np.float32), transparent


def _assemble(block_px, width, height):
    """(N,16,C) per-block texels (row-major 4x4) -> (H,W,C) cropped image."""
    bw = (width + 3) // 4
    bh = (height + 3) // 4
    c = block_px.shape[-1]
    img = block_px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, c)
    return img[:height, :width]


def decode_dxt(data: bytes, width: int, height: int, fmt: str) -> np.ndarray:
    """Decompress one DXT1/DXT3/DXT5 surface to (H,W,4) float32 RGBA."""
    fmt = fmt.upper()
    bw = (width + 3) // 4
    bh = (height + 3) // 4
    n = bw * bh
    if fmt == "DXT1":
        raw = np.frombuffer(data, np.uint8, n * 8).reshape(n, 8)
        c0 = raw[:, 0:2].copy().view(np.uint16)[:, 0]
        c1 = raw[:, 2:4].copy().view(np.uint16)[:, 0]
        bits = raw[:, 4:8].copy().view(np.uint32)[:, 0]
        rgb, transparent = _color_blocks(c0, c1, bits, c0 <= c1)
        alpha = np.where(transparent, 0.0, 1.0).astype(np.float32)
    elif fmt in ("DXT3", "DXT5"):
        raw = np.frombuffer(data, np.uint8, n * 16).reshape(n, 16)
        c0 = raw[:, 8:10].copy().view(np.uint16)[:, 0]
        c1 = raw[:, 10:12].copy().view(np.uint16)[:, 0]
        bits = raw[:, 12:16].copy().view(np.uint32)[:, 0]
        # DXT3/5 color blocks always decode in 4-color mode
        rgb, _ = _color_blocks(c0, c1, bits, np.zeros(n, bool))
        if fmt == "DXT3":
            # explicit 4-bit alpha, texel k in nibble k of the 8 bytes
            a64 = raw[:, 0:8].copy().view(np.uint64)[:, 0]
            k = np.arange(16, dtype=np.uint64)
            a4 = (a64[:, None] >> (4 * k)[None, :]) & 0xF
            alpha = (a4.astype(np.float32) * 17.0) / 255.0
        else:
            a0 = raw[:, 0].astype(np.float32)
            a1 = raw[:, 1].astype(np.float32)
            # interpolated alpha palette (N,8)
            pal = np.empty((n, 8), np.float32)
            pal[:, 0] = a0
            pal[:, 1] = a1
            gt = a0 > a1
            for i in range(1, 7):
                pal[gt, i + 1] = ((7 - i) * a0[gt] + i * a1[gt]) / 7.0
            lt = ~gt
            for i in range(1, 5):
                pal[lt, i + 1] = ((5 - i) * a0[lt] + i * a1[lt]) / 5.0
            pal[lt, 6] = 0.0
            pal[lt, 7] = 255.0
            # 48-bit little-endian 3-bit indices
            a48 = np.zeros(n, np.uint64)
            for b in range(6):
                a48 |= raw[:, 2 + b].astype(np.uint64) << np.uint64(8 * b)
            k = np.arange(16, dtype=np.uint64)
            aidx = ((a48[:, None] >> (3 * k)[None, :]) & 7).astype(np.int64)
            alpha = np.take_along_axis(pal, aidx, 1) / 255.0
    else:
        raise ValueError(f"unsupported compressed format {fmt!r}")
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    return _assemble(rgba, width, height).astype(np.float32)


def _dxt_surface_size(width: int, height: int, fmt: str) -> int:
    bpb = 8 if fmt == "DXT1" else 16
    return ((width + 3) // 4) * ((height + 3) // 4) * bpb


def is_dds(data: bytes) -> bool:
    return len(data) >= 4 and data[:4] == _DDS_MAGIC


def load_dds(src) -> list[np.ndarray]:
    """Parse a DDS file (path, bytes, or file object) -> list of (H,W,4)
    float32 RGBA mip levels (level 0 first). Supports DXT1/3/5 and
    uncompressed masked RGB(A)."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif hasattr(src, "read"):
        data = src.read()
    else:
        with open(src, "rb") as f:
            data = f.read()
    if not is_dds(data):
        raise ValueError("not a DDS file")
    (size, flags, height, width, _pitch, _depth, mipcount) = struct.unpack_from(
        "<7I", data, 4)
    if size != 124:
        raise ValueError("bad DDS header size")
    pf_size, pf_flags, pf_fourcc, pf_rgbbits, rmask, gmask, bmask, amask = \
        struct.unpack_from("<II4sIIIII", data, 4 + 72)
    n_mips = mipcount if (flags & _DDSD_MIPMAPCOUNT) and mipcount else 1
    off = 4 + 124
    levels = []
    w, h = width, height
    if pf_flags & _DDPF_FOURCC:
        fmt = pf_fourcc.decode("ascii", "replace")
        for _ in range(max(n_mips, 1)):
            sz = _dxt_surface_size(w, h, fmt)
            levels.append(decode_dxt(data[off:off + sz], w, h, fmt))
            off += sz
            if w == 1 and h == 1:
                break
            w, h = max(w // 2, 1), max(h // 2, 1)
    else:
        bypp = pf_rgbbits // 8

        def shift_scale(mask):
            if mask == 0:
                return 0, 1.0
            sh = (mask & -mask).bit_length() - 1
            return sh, float(mask >> sh)

        for _ in range(max(n_mips, 1)):
            count = w * h
            raw = np.frombuffer(data, np.uint8, count * bypp, off)
            px = np.zeros(count, np.uint32)
            for b in range(bypp):
                px |= raw[b::bypp].astype(np.uint32) << np.uint32(8 * b)
            chans = []
            for mask in (rmask, gmask, bmask):
                sh, mx = shift_scale(mask)
                chans.append(((px >> sh) & (mask >> sh)).astype(np.float32)
                             / max(mx, 1.0))
            if (pf_flags & _DDPF_ALPHAPIXELS) and amask:
                sh, mx = shift_scale(amask)
                chans.append(((px >> sh) & (amask >> sh)).astype(np.float32)
                             / max(mx, 1.0))
            else:
                chans.append(np.ones(count, np.float32))
            levels.append(np.stack(chans, -1).reshape(h, w, 4))
            off += count * bypp
            if w == 1 and h == 1:
                break
            w, h = max(w // 2, 1), max(h // 2, 1)
    return levels
