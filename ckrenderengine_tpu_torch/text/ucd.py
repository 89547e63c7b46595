"""Character data that Python's :mod:`unicodedata` does not carry, as the
layout libraries that Pillow's text goes through know it.

- Scripts (``script_of``): the Unicode Script property over the blocks the
  port lays out (Latin, Greek, Cyrillic, Arabic, Hebrew and their Common
  and Inherited characters), as Scripts.txt 15.0 gives it; the ranges are
  the same in HarfBuzz 12.3.0's tables for these blocks.
- Bidi classes (``bidi_class``): Python's (Unicode 15.0) except where
  fribidi 1.0.8, whose tables stop at Unicode 12.1, still has the default
  class L for a character assigned later (``FRIBIDI_L``).
- Bidi_Mirroring_Glyph (``MIRROR``): BidiMirroring.txt 16.0, which is
  what HarfBuzz mirrors by in a right-to-left run.
- Bidi_Paired_Bracket (``BRACKETS``): fribidi 1.0.8's bracket ids, which
  fold compatibility forms onto their ASCII or CJK bracket (``U+207D``
  pairs like ``(``).
- Arabic joining types (``joining_type``): ArabicShaping.txt as HarfBuzz
  12.3.0 carries it over the Arabic block, ZWJ, ZWNJ and the isolates; a
  character not listed is transparent (T) if it is a nonspacing or
  enclosing mark or a format character, else non-joining (U).
- HarfBuzz's modified combining classes (``modified_class``): the Hebrew
  points and the Arabic harakat renumbered as HarfBuzz reorders them, and
  the Arabic modifier combining marks (``ARABIC_MCM``) that its Arabic
  shaper moves to the front of a run of marks (UTR #53).
- What HarfBuzz keeps in one grapheme when it reverses a run's graphemes
  besides marks and ZWJ: a pictograph after a ZWJ (``ZWJ_PICTOGRAPHIC``)
  and the halfwidth sound marks (``GRAPHEME_EXTEND``).
"""

from __future__ import annotations

import unicodedata

LATIN, GREEK, CYRILLIC, ARABIC, HEBREW = "Latn", "Grek", "Cyrl", "Arab", \
    "Hebr"
COMMON, INHERITED, UNKNOWN = "Zyyy", "Zinh", "Zzzz"

# Unicode Script property over the blocks this port lays out: ranges of
# Latin, Greek, Cyrillic, Arabic, Hebrew and Inherited, and of other
# scripts (None) inside those blocks; Common is what is left of the blocks
# in _COMMON_BLOCKS.
_SCRIPT_RANGES = (
    (0x0041, 0x005A, LATIN), (0x0061, 0x007A, LATIN), (0x00AA, 0x00AA, LATIN),
    (0x00BA, 0x00BA, LATIN), (0x00C0, 0x00D6, LATIN), (0x00D8, 0x00F6, LATIN),
    (0x00F8, 0x02B8, LATIN), (0x02E0, 0x02E4, LATIN), (0x02EA, 0x02EB, None),
    (0x0300, 0x036F, INHERITED), (0x0370, 0x0373, GREEK),
    (0x0375, 0x0377, GREEK), (0x037A, 0x037D, GREEK), (0x037F, 0x037F, GREEK),
    (0x0384, 0x0384, GREEK), (0x0386, 0x0386, GREEK), (0x0388, 0x03E1, GREEK),
    (0x03F0, 0x03FF, GREEK), (0x0400, 0x0484, CYRILLIC),
    (0x0485, 0x0486, INHERITED), (0x0487, 0x052F, CYRILLIC),
    (0x0591, 0x05C7, HEBREW), (0x05D0, 0x05EA, HEBREW),
    (0x05EF, 0x05F4, HEBREW), (0x0600, 0x0604, ARABIC),
    (0x0606, 0x060B, ARABIC), (0x060D, 0x061A, ARABIC),
    (0x061C, 0x061E, ARABIC), (0x0620, 0x063F, ARABIC),
    (0x0641, 0x064A, ARABIC), (0x064B, 0x0655, INHERITED),
    (0x0656, 0x066F, ARABIC), (0x0670, 0x0670, INHERITED),
    (0x0671, 0x06DC, ARABIC), (0x06DE, 0x06FF, ARABIC),
    (0x1C80, 0x1C88, CYRILLIC), (0x1D00, 0x1D25, LATIN),
    (0x1D26, 0x1D2A, GREEK), (0x1D2B, 0x1D2B, CYRILLIC),
    (0x1D2C, 0x1D5C, LATIN), (0x1D5D, 0x1D61, GREEK), (0x1D62, 0x1D65, LATIN),
    (0x1D66, 0x1D6A, GREEK), (0x1D6B, 0x1D77, LATIN),
    (0x1D78, 0x1D78, CYRILLIC), (0x1D79, 0x1DBE, LATIN),
    (0x1DBF, 0x1DBF, GREEK), (0x1DC0, 0x1DFF, INHERITED),
    (0x1E00, 0x1EFF, LATIN), (0x1F00, 0x1FFE, GREEK),
    (0x200C, 0x200D, INHERITED), (0x2071, 0x2071, LATIN),
    (0x207F, 0x207F, LATIN), (0x2090, 0x209C, LATIN),
    (0x20D0, 0x20F0, INHERITED), (0x2126, 0x2126, GREEK),
    (0x212A, 0x212B, LATIN), (0x2132, 0x2132, LATIN), (0x214E, 0x214E, LATIN),
    (0x2160, 0x2188, LATIN), (0x2800, 0x28FF, None), (0x2C60, 0x2C7F, LATIN),
    (0x2DE0, 0x2DFF, CYRILLIC), (0xA640, 0xA69F, CYRILLIC),
    (0xA722, 0xA787, LATIN), (0xA78B, 0xA7FF, LATIN), (0xAB30, 0xAB5A, LATIN),
    (0xAB5C, 0xAB64, LATIN), (0xAB65, 0xAB65, GREEK), (0xAB66, 0xAB69, LATIN),
    (0xFB00, 0xFB06, LATIN),
    (0xFE00, 0xFE0F, INHERITED), (0xFE20, 0xFE2D, INHERITED),
    (0xFE2E, 0xFE2F, CYRILLIC), (0xFF21, 0xFF3A, LATIN),
    (0xFF41, 0xFF5A, LATIN), (0xFF66, 0xFF6F, None), (0xFF71, 0xFF9D, None),
    (0xFFA0, 0xFFDC, None))
# Blocks whose characters are Common unless listed above.
_COMMON_BLOCKS = ((0x0000, 0x036F), (0x0370, 0x03FF), (0x0400, 0x052F),
                  (0x0590, 0x05FF), (0x0600, 0x06FF),
                  (0x1C80, 0x1C8F), (0x1D00, 0x1DFF), (0x1E00, 0x2BFF),
                  (0x2C60, 0x2C7F), (0x2DE0, 0x2DFF), (0x2E00, 0x2E7F),
                  (0xA640, 0xA69F), (0xA700, 0xA7FF), (0xAB30, 0xAB6F),
                  (0xFB00, 0xFB06), (0xFE00, 0xFE0F), (0xFE20, 0xFE2F),
                  (0xFE30, 0xFE4F), (0xFEFF, 0xFEFF), (0xFF00, 0xFFEF))


def script_of(ch: str) -> str | None:
    """The character's script, UNKNOWN for an unassigned or private-use
    code point, or None outside the blocks this port lays out."""
    c = ord(ch)
    if unicodedata.category(ch) in ("Cn", "Co"):
        return UNKNOWN
    for lo, hi, s in _SCRIPT_RANGES:
        if lo <= c <= hi:
            return s
    for lo, hi in _COMMON_BLOCKS:
        if lo <= c <= hi:
            # Greek and Coptic's Coptic letters.
            if 0x03E2 <= c <= 0x03EF:
                return None
            return COMMON
    return None


# Characters of the blocks above that fribidi 1.0.8 does not know (assigned
# after Unicode 12.1): it gives them class L.
FRIBIDI_L = ((0x1DFA, 0x1DFA), (0x20C0, 0x20C0), (0x2B97, 0x2B97),
             (0x2BBA, 0x2BBC), (0x2BC9, 0x2BC9), (0x2BD3, 0x2BEB),
             (0x2BF0, 0x2BFF), (0x2E4A, 0x2E5D), (0xAB6A, 0xAB6B))


def bidi_class(ch: str) -> str:
    """The bidi class fribidi 1.0.8 gives ``ch``."""
    c = ord(ch)
    for lo, hi in FRIBIDI_L:
        if lo <= c <= hi:
            return "L"
    return unicodedata.bidirectional(ch) or "L"


def _hex_pairs(text: str) -> dict:
    return {int(w[:4], 16): int(w[4:], 16) for w in text.split()}


# Bidi_Mirroring_Glyph, BidiMirroring.txt 16.0: (character, mirror) as
# eight hex digits.
MIRROR = _hex_pairs("""
    00280029 00290028 003C003E 003E003C 005B005D 005D005B 007B007D 007D007B
    00AB00BB 00BB00AB 0F3A0F3B 0F3B0F3A 0F3C0F3D 0F3D0F3C 169B169C 169C169B
    2039203A 203A2039 20452046 20462045 207D207E 207E207D 208D208E 208E208D
    2208220B 2209220C 220A220D 220B2208 220C2209 220D220A 221529F5 221F2BFE
    222029A3 2221299B 222229A0 22242AEE 223C223D 223D223C 224322CD 2245224C
    224C2245 22522253 22532252 22542255 22552254 22642265 22652264 22662267
    22672266 22682269 22692268 226A226B 226B226A 226E226F 226F226E 22702271
    22712270 22722273 22732272 22742275 22752274 22762277 22772276 22782279
    22792278 227A227B 227B227A 227C227D 227D227C 227E227F 227F227E 22802281
    22812280 22822283 22832282 22842285 22852284 22862287 22872286 22882289
    22892288 228A228B 228B228A 228F2290 2290228F 22912292 22922291 229829B8
    22A222A3 22A322A2 22A62ADE 22A82AE4 22A92AE3 22AB2AE5 22B022B1 22B122B0
    22B222B3 22B322B2 22B422B5 22B522B4 22B622B7 22B722B6 22B827DC 22C922CA
    22CA22C9 22CB22CC 22CC22CB 22CD2243 22D022D1 22D122D0 22D622D7 22D722D6
    22D822D9 22D922D8 22DA22DB 22DB22DA 22DC22DD 22DD22DC 22DE22DF 22DF22DE
    22E022E1 22E122E0 22E222E3 22E322E2 22E422E5 22E522E4 22E622E7 22E722E6
    22E822E9 22E922E8 22EA22EB 22EB22EA 22EC22ED 22ED22EC 22F022F1 22F122F0
    22F222FA 22F322FB 22F422FC 22F622FD 22F722FE 22FA22F2 22FB22F3 22FC22F4
    22FD22F6 22FE22F7 23082309 23092308 230A230B 230B230A 2329232A 232A2329
    27682769 27692768 276A276B 276B276A 276C276D 276D276C 276E276F 276F276E
    27702771 27712770 27722773 27732772 27742775 27752774 27C327C4 27C427C3
    27C527C6 27C627C5 27C827C9 27C927C8 27CB27CD 27CD27CB 27D527D6 27D627D5
    27DC22B8 27DD27DE 27DE27DD 27E227E3 27E327E2 27E427E5 27E527E4 27E627E7
    27E727E6 27E827E9 27E927E8 27EA27EB 27EB27EA 27EC27ED 27ED27EC 27EE27EF
    27EF27EE 29832984 29842983 29852986 29862985 29872988 29882987 2989298A
    298A2989 298B298C 298C298B 298D2990 298E298F 298F298E 2990298D 29912992
    29922991 29932994 29942993 29952996 29962995 29972998 29982997 299B2221
    29A02222 29A32220 29A429A5 29A529A4 29A829A9 29A929A8 29AA29AB 29AB29AA
    29AC29AD 29AD29AC 29AE29AF 29AF29AE 29B82298 29C029C1 29C129C0 29C429C5
    29C529C4 29CF29D0 29D029CF 29D129D2 29D229D1 29D429D5 29D529D4 29D829D9
    29D929D8 29DA29DB 29DB29DA 29E829E9 29E929E8 29F52215 29F829F9 29F929F8
    29FC29FD 29FD29FC 2A2B2A2C 2A2C2A2B 2A2D2A2E 2A2E2A2D 2A342A35 2A352A34
    2A3C2A3D 2A3D2A3C 2A642A65 2A652A64 2A792A7A 2A7A2A79 2A7B2A7C 2A7C2A7B
    2A7D2A7E 2A7E2A7D 2A7F2A80 2A802A7F 2A812A82 2A822A81 2A832A84 2A842A83
    2A852A86 2A862A85 2A872A88 2A882A87 2A892A8A 2A8A2A89 2A8B2A8C 2A8C2A8B
    2A8D2A8E 2A8E2A8D 2A8F2A90 2A902A8F 2A912A92 2A922A91 2A932A94 2A942A93
    2A952A96 2A962A95 2A972A98 2A982A97 2A992A9A 2A9A2A99 2A9B2A9C 2A9C2A9B
    2A9D2A9E 2A9E2A9D 2A9F2AA0 2AA02A9F 2AA12AA2 2AA22AA1 2AA62AA7 2AA72AA6
    2AA82AA9 2AA92AA8 2AAA2AAB 2AAB2AAA 2AAC2AAD 2AAD2AAC 2AAF2AB0 2AB02AAF
    2AB12AB2 2AB22AB1 2AB32AB4 2AB42AB3 2AB52AB6 2AB62AB5 2AB72AB8 2AB82AB7
    2AB92ABA 2ABA2AB9 2ABB2ABC 2ABC2ABB 2ABD2ABE 2ABE2ABD 2ABF2AC0 2AC02ABF
    2AC12AC2 2AC22AC1 2AC32AC4 2AC42AC3 2AC52AC6 2AC62AC5 2AC72AC8 2AC82AC7
    2AC92ACA 2ACA2AC9 2ACB2ACC 2ACC2ACB 2ACD2ACE 2ACE2ACD 2ACF2AD0 2AD02ACF
    2AD12AD2 2AD22AD1 2AD32AD4 2AD42AD3 2AD52AD6 2AD62AD5 2ADE22A6 2AE322A9
    2AE422A8 2AE522AB 2AEC2AED 2AED2AEC 2AEE2224 2AF72AF8 2AF82AF7 2AF92AFA
    2AFA2AF9 2BFE221F 2E022E03 2E032E02 2E042E05 2E052E04 2E092E0A 2E0A2E09
    2E0C2E0D 2E0D2E0C 2E1C2E1D 2E1D2E1C 2E202E21 2E212E20 2E222E23 2E232E22
    2E242E25 2E252E24 2E262E27 2E272E26 2E282E29 2E292E28 2E552E56 2E562E55
    2E572E58 2E582E57 2E592E5A 2E5A2E59 2E5B2E5C 2E5C2E5B 30083009 30093008
    300A300B 300B300A 300C300D 300D300C 300E300F 300F300E 30103011 30113010
    30143015 30153014 30163017 30173016 30183019 30193018 301A301B 301B301A
    FE59FE5A FE5AFE59 FE5BFE5C FE5CFE5B FE5DFE5E FE5EFE5D FE64FE65 FE65FE64
    FF08FF09 FF09FF08 FF1CFF1E FF1EFF1C FF3BFF3D FF3DFF3B FF5BFF5D FF5DFF5B
    FF5FFF60 FF60FF5F FF62FF63 FF63FF62
""")

# fribidi 1.0.8's bracket of each paired bracket: "<" opens, ">" closes,
# then the bracket id the pair shares.
BRACKETS = {int(w[:4], 16): (int(w[5:], 16), w[4] == "<") for w in """
    0028<0028 0029>0028 005B<005B 005D>005B 007B<007B 007D>007B 0F3A<0F3A
    0F3B>0F3A 0F3C<0F3C 0F3D>0F3C 169B<169B 169C>169B 2045<2045 2046>2045
    207D<0028 207E>0028 208D<0028 208E>0028 2308<2308 2309>2308 230A<230A
    230B>230A 2329<3008 232A>3008 2768<2768 2769>2768 276A<276A 276B>276A
    276C<276C 276D>276C 276E<276E 276F>276E 2770<2770 2771>2770 2772<2772
    2773>2772 2774<2774 2775>2774 27C5<27C5 27C6>27C5 27E6<27E6 27E7>27E6
    27E8<27E8 27E9>27E8 27EA<27EA 27EB>27EA 27EC<27EC 27ED>27EC 27EE<27EE
    27EF>27EE 2983<2983 2984>2983 2985<2985 2986>2985 2987<2987 2988>2987
    2989<2989 298A>2989 298B<298B 298C>298B 298D<298D 298E>298F 298F<298F
    2990>298D 2991<2991 2992>2991 2993<2993 2994>2993 2995<2995 2996>2995
    2997<2997 2998>2997 29D8<29D8 29D9>29D8 29DA<29DA 29DB>29DA 29FC<29FC
    29FD>29FC 2E22<2E22 2E23>2E22 2E24<2E24 2E25>2E24 2E26<2E26 2E27>2E26
    2E28<2E28 2E29>2E28 3008<3008 3009>3008 300A<300A 300B>300A 300C<300C
    300D>300C 300E<300E 300F>300E 3010<3010 3011>3010 3014<3014 3015>3014
    3016<3016 3017>3016 3018<3018 3019>3018 301A<301A 301B>301A FE59<0028
    FE5A>0028 FE5B<007B FE5C>007B FE5D<3014 FE5E>3014 FF08<0028 FF09>0028
    FF3B<005B FF3D>005B FF5B<007B FF5D>007B FF5F<2985 FF60>2985 FF62<300C
    FF63>300C
""".split()}


def _ranges(text: str) -> dict:
    out = {}
    for w in text.split():
        span, value = w.split(":")
        lo, _, hi = span.partition("-")
        for c in range(int(lo, 16), int(hi or lo, 16) + 1):
            out[c] = value
    return out


# Joining types that differ from the default of joining_type().
_JOINING = _ranges("""
    0600-0605:U 0620:D 0622-0625:R 0626:D 0627:R 0628:D 0629:R 062A-062E:D
    062F-0632:R 0633-063F:D 0640:C 0641-0647:D 0648:R 0649-064A:D
    066E-066F:D 0671-0673:R 0675-0677:R 0678-0687:D 0688-0699:R 069A-06BF:D
    06C0:R 06C1-06C2:D 06C3-06CB:R 06CC:D 06CD:R 06CE:D 06CF:R 06D0-06D1:D
    06D2-06D3:R 06D5:R 06DD:U 06EE-06EF:R 06FA-06FC:D 06FF:D 200C:U 200D:C
    2066-2069:U
""")


def joining_type(ch: str) -> str:
    """HarfBuzz's Arabic joining type of ``ch``: U, L, R, D, C or T."""
    got = _JOINING.get(ord(ch))
    if got is not None:
        return got
    return "T" if unicodedata.category(ch) in ("Mn", "Me", "Cf") else "U"


def _code_set(text: str) -> frozenset:
    out = set()
    for w in text.split():
        lo, _, hi = w.partition("-")
        out.update(range(int(lo, 16), int(hi or lo, 16) + 1))
    return frozenset(out)


# The characters HarfBuzz 12.3.0 keeps in one grapheme with a ZWJ before
# them (its emoji table over the blocks above), found by shaping "ZWJ c"
# in a run whose graphemes it reverses.
ZWJ_PICTOGRAPHIC = _code_set("""
    00A9 00AE 203C 2049 2122 2139 2194-2199 21A9-21AA 231A-231B 2328 23CF
    23E9-23F3 23F8-23FA 24C2 25AA-25AB 25B6 25C0 25FB-25FE 2600-2604 260E
    2611 2614-2615 2618 261D 2620 2622-2623 2626 262A 262E-262F 2638-263A
    2640 2642 2648-2653 265F-2660 2663 2665-2666 2668 267B 267E-267F
    2692-2697 2699 269B-269C 26A0-26A1 26A7 26AA-26AB 26B0-26B1 26BD-26BE
    26C4-26C5 26C8 26CE-26CF 26D1 26D3-26D4 26E9-26EA 26F0-26F5 26F7-26FA
    26FD 2702 2705 2708-270D 270F 2712 2714 2716 271D 2721 2728 2733-2734
    2744 2747 274C 274E 2753-2755 2757 2763-2764 2795-2797 27A1 27B0 27BF
    2934-2935 2B05-2B07 2B1B-2B1C 2B50 2B55
""")
# Characters HarfBuzz always keeps in the grapheme before them (Other_
# Grapheme_Extend that are not marks): the halfwidth sound marks.
GRAPHEME_EXTEND = _code_set("FF9E-FF9F")


# HarfBuzz's modified combining classes (hb-unicode.hh): the Hebrew
# fixed-position classes 10-26 in the order of the SBL Hebrew manual, and
# the Arabic classes 27-35 with shadda moved before the other harakat.
_MODIFIED = {10: 22, 11: 15, 12: 16, 13: 17, 14: 23, 15: 18, 16: 19, 17: 20,
             18: 21, 19: 14, 20: 24, 21: 12, 22: 25, 23: 13, 24: 10, 25: 11,
             26: 26, 27: 28, 28: 29, 29: 30, 30: 31, 31: 32, 32: 33, 33: 27,
             34: 34, 35: 35}


def modified_class(ch: str) -> int:
    """HarfBuzz's modified combining class of ``ch``."""
    ccc = unicodedata.combining(ch)
    return _MODIFIED.get(ccc, ccc)


# Arabic modifier combining marks (UTR #53) that HarfBuzz's Arabic shaper
# moves to the front of a run of marks of the same class (220 or 230).
ARABIC_MCM = frozenset((0x0654, 0x0655, 0x0658, 0x06DC, 0x06E3, 0x06E7,
                        0x06E8, 0x08CA, 0x08CB, 0x08CD, 0x08CE, 0x08CF,
                        0x08D3, 0x08F3))
