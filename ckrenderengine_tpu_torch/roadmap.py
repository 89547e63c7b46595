"""Features of the reference package that this package does not carry yet.

Each raises ``NotImplementedError`` where it is first used, naming the item
of the port queue in ROADMAP.md that will bring it. A frame never renders
something different in their place.
"""

from __future__ import annotations

# ROADMAP.md "Port queue", in order.
PORT_QUEUE = {
    1: "GPU benchmark",
    14: "fonts other than TrueType outlines (CFF / OpenType .otf, "
        "collections, variable and bitmap-only fonts, unhinted fonts for "
        "the auto-hinter), right-to-left scripts other than Arabic and "
        "Hebrew (Syriac, Thaana, N'Ko) and their presentation forms, "
        "script shapers (Indic, Thai and the like), HarfBuzz's Arabic "
        "fallback shaping and Hebrew fallback mark positioning and "
        "presentation-form composition, GSUB reverse chaining and GPOS "
        "cursive lookups, more than one bidi "
        "isolate in a line, characters without a glyph or decomposition, "
        "TrueType opcodes outside the interpreter; movie "
        "sprites from video containers other than AVI (MP4, MOV, MKV, "
        "WebM, MPEG-PS/TS, FLV) and from AVI codecs the port does not "
        "decode (Cinepak, Indeo, MPEG-4 ASP, H.264, FFV1, HuffYUV, DV; "
        "RGB MJPEG and chroma samplings FFmpeg does not name; BI_RGB "
        "below 8 bits; frames whose size changes within a movie); and the "
        "image formats "
        "and variants the readers of io/imagefile.py refuse (WebP, JPEG "
        "2000, ICO, PCX, PPM, PSD and other formats; CMYK, arithmetic, "
        "12-bit and lossless JPEG; TIFF other than 8-bit L, LA, P, RGB, "
        "RGBA, or compressed other than PackBits, LZW and Deflate)",
}


def unported(what: str, item: int) -> NotImplementedError:
    """The error a not-yet-ported feature raises at its point of use."""
    return NotImplementedError(
        f"{what} is not ported to ckrenderengine_tpu_torch yet "
        f"(ROADMAP.md port queue item {item}: {PORT_QUEUE[item]})")
