"""The TrueType bytecode interpreter and hinted glyph loader, as FreeType
2.14 runs them by default: interpreter version 40 ("minimal subpixel
hinting") with its backward-compatibility mode unless the font's ``prep``
opts out through ``INSTCTRL`` selector 3.

Coordinates are 26.6 fixed point held in Python ints; every product,
quotient and rounding is FreeType's own (``FT_MulFix``, ``FT_MulDiv``,
``FT_DivFix``, ``TT_DotFix14``, ``FT_Vector_NormLen``), so the hinted
outline is FreeType's to the 1/64 pixel. ``fpgm`` runs once per face,
``prep`` once per size; each glyph program starts from the state ``prep``
left (graphics state, CVT, storage, twilight zone). A composite is loaded
as FreeType loads it: each component hinted alone, transformed and offset
(rounded where its flag says), then the composite's own program over the
merged points. An opcode outside the instruction set raises
:func:`roadmap.unported`; so do fonts FreeType would hand to its
auto-hinter.
"""

from __future__ import annotations

from ..roadmap import unported
from . import sfnt

TOUCH_X = 0x08
TOUCH_Y = 0x10
TOUCH_BOTH = TOUCH_X | TOUCH_Y
MAX_INSTRUCTIONS = 1_000_000

# Round states (TT_Round_*).
RTHG, RTG, RTDG, RDTG, RUTG, ROFF, RSUPER, RSUPER45 = range(8)

# Values popped by each opcode before it runs (FreeType's Pop_Push_Count
# high nibble); the loop instructions pop their points themselves.
POPS = bytearray(256)
for _op, _n in {
        0x06: 2, 0x07: 2, 0x08: 2, 0x09: 2, 0x0A: 2, 0x0B: 2, 0x0F: 5,
        0x10: 1, 0x11: 1, 0x12: 1, 0x13: 1, 0x14: 1, 0x15: 1, 0x16: 1,
        0x17: 1, 0x1A: 1, 0x1C: 1, 0x1D: 1, 0x1E: 1, 0x1F: 1, 0x20: 1,
        0x21: 1, 0x23: 2, 0x25: 1, 0x26: 1, 0x27: 2, 0x29: 1, 0x2A: 2,
        0x2B: 1, 0x2C: 1, 0x2E: 1, 0x2F: 1, 0x34: 1, 0x35: 1, 0x36: 1,
        0x37: 1, 0x38: 1, 0x3A: 2, 0x3B: 2, 0x3E: 2, 0x3F: 2, 0x42: 2,
        0x43: 1, 0x44: 2, 0x45: 1, 0x46: 1, 0x47: 1, 0x48: 2, 0x49: 2,
        0x4A: 2, 0x50: 2, 0x51: 2, 0x52: 2, 0x53: 2, 0x54: 2, 0x55: 2,
        0x56: 1, 0x57: 1, 0x58: 1, 0x5A: 2, 0x5B: 2, 0x5C: 1, 0x5D: 1,
        0x5E: 1, 0x5F: 1, 0x60: 2, 0x61: 2, 0x62: 2, 0x63: 2, 0x64: 1,
        0x65: 1, 0x66: 1, 0x67: 1, 0x68: 1, 0x69: 1, 0x6A: 1, 0x6B: 1,
        0x6C: 1, 0x6D: 1, 0x6E: 1, 0x6F: 1, 0x70: 2, 0x71: 1, 0x72: 1,
        0x73: 1, 0x74: 1, 0x75: 1, 0x76: 1, 0x77: 1, 0x78: 2, 0x79: 2,
        0x7E: 1, 0x7F: 1, 0x81: 2, 0x82: 2, 0x85: 1, 0x86: 2, 0x87: 2,
        0x88: 1, 0x89: 1, 0x8A: 3, 0x8B: 2, 0x8C: 2, 0x8D: 1,
        0x8E: 2}.items():
    POPS[_op] = _n
for _op in range(0xC0, 0x100):
    POPS[_op] = 1 if _op < 0xE0 else 2

OPCODE_NAMES = {
    0x00: "SVTCA", 0x02: "SPVTCA", 0x04: "SFVTCA", 0x06: "SPVTL",
    0x08: "SFVTL", 0x0A: "SPVFS", 0x0B: "SFVFS", 0x0C: "GPV", 0x0D: "GFV",
    0x0E: "SFVTPV", 0x0F: "ISECT", 0x10: "SRP0", 0x11: "SRP1",
    0x12: "SRP2", 0x13: "SZP0", 0x14: "SZP1", 0x15: "SZP2", 0x16: "SZPS",
    0x17: "SLOOP", 0x18: "RTG", 0x19: "RTHG", 0x1A: "SMD", 0x1B: "ELSE",
    0x1C: "JMPR", 0x1D: "SCVTCI", 0x1E: "SSWCI", 0x1F: "SSW", 0x20: "DUP",
    0x21: "POP", 0x22: "CLEAR", 0x23: "SWAP", 0x24: "DEPTH", 0x25: "CINDEX",
    0x26: "MINDEX", 0x27: "ALIGNPTS", 0x29: "UTP", 0x2A: "LOOPCALL",
    0x2B: "CALL", 0x2C: "FDEF", 0x2D: "ENDF", 0x2E: "MDAP", 0x30: "IUP",
    0x32: "SHP", 0x34: "SHC", 0x36: "SHZ", 0x38: "SHPIX", 0x39: "IP",
    0x3A: "MSIRP", 0x3C: "ALIGNRP", 0x3D: "RTDG", 0x3E: "MIAP",
    0x40: "NPUSHB", 0x41: "NPUSHW", 0x42: "WS", 0x43: "RS", 0x44: "WCVTP",
    0x45: "RCVT", 0x46: "GC", 0x48: "SCFS", 0x49: "MD", 0x4A: "MD",
    0x4B: "MPPEM",
    0x4C: "MPS", 0x4D: "FLIPON", 0x4E: "FLIPOFF", 0x4F: "DEBUG",
    0x50: "LT", 0x51: "LTEQ", 0x52: "GT", 0x53: "GTEQ", 0x54: "EQ",
    0x55: "NEQ", 0x56: "ODD", 0x57: "EVEN", 0x58: "IF", 0x59: "EIF",
    0x5A: "AND", 0x5B: "OR", 0x5C: "NOT", 0x5D: "DELTAP1", 0x5E: "SDB",
    0x5F: "SDS", 0x60: "ADD", 0x61: "SUB", 0x62: "DIV", 0x63: "MUL",
    0x64: "ABS", 0x65: "NEG", 0x66: "FLOOR", 0x67: "CEILING",
    0x68: "ROUND", 0x6C: "NROUND", 0x70: "WCVTF", 0x71: "DELTAP2",
    0x72: "DELTAP3", 0x73: "DELTAC1", 0x74: "DELTAC2", 0x75: "DELTAC3",
    0x76: "SROUND", 0x77: "S45ROUND", 0x78: "JROT", 0x79: "JROF",
    0x7A: "ROFF", 0x7C: "RUTG", 0x7D: "RDTG", 0x7E: "SANGW", 0x7F: "AA",
    0x80: "FLIPPT", 0x81: "FLIPRGON", 0x82: "FLIPRGOFF", 0x85: "SCANCTRL",
    0x86: "SDPVTL", 0x88: "GETINFO", 0x89: "IDEF", 0x8A: "ROLL",
    0x8B: "MAX", 0x8C: "MIN", 0x8D: "SCANTYPE", 0x8E: "INSTCTRL",
    0x91: "GETVARIATION", 0x92: "GETDATA"}


def opcode_name(op: int) -> str:
    for base in (op, op & ~1, op & ~3):
        if base in OPCODE_NAMES:
            return OPCODE_NAMES[base]
    if 0xB0 <= op < 0xB8:
        return "PUSHB"
    if 0xB8 <= op < 0xC0:
        return "PUSHW"
    if op >= 0xE0:
        return "MIRP"
    if op >= 0xC0:
        return "MDRP"
    return f"0x{op:02X}"


# -- FreeType's fixed-point arithmetic ----------------------------------------

def mul_fix(a: int, b: int) -> int:
    """FT_MulFix: a*b/65536 rounded half away from zero."""
    ab = a * b
    return (ab + 0x8000 - (ab < 0)) >> 16


def mul_fix14(a: int, b: int) -> int:
    """TT_MulFix14: a*b/16384 rounded half away from zero."""
    ab = a * b
    return (ab + 0x2000 - (ab < 0)) >> 14


def dot_fix14(ax: int, ay: int, bx: int, by: int) -> int:
    """TT_DotFix14: (ax*bx + ay*by)/16384, rounded as FreeType does."""
    t = ax * bx + ay * by
    return (t + 0x2000 - (t < 0)) >> 14


def mul_div(a: int, b: int, c: int) -> int:
    """FT_MulDiv: a*b/c rounded half away from zero (0x7FFFFFFF for c=0)."""
    s = 1
    if a < 0:
        a, s = -a, -s
    if b < 0:
        b, s = -b, -s
    if c < 0:
        c, s = -c, -s
    d = (a * b + (c >> 1)) // c if c > 0 else 0x7FFFFFFF
    return -d if s < 0 else d


def mul_div_no_round(a: int, b: int, c: int) -> int:
    s = 1
    if a < 0:
        a, s = -a, -s
    if b < 0:
        b, s = -b, -s
    if c < 0:
        c, s = -c, -s
    d = (a * b) // c if c > 0 else 0x7FFFFFFF
    return -d if s < 0 else d


def div_fix(a: int, b: int) -> int:
    """FT_DivFix: a*65536/b rounded half away from zero."""
    s = 1
    if a < 0:
        a, s = -a, -s
    if b < 0:
        b, s = -b, -s
    q = ((a << 16) + (b >> 1)) // b if b > 0 else 0x7FFFFFFF
    return -q if s < 0 else q


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v & 0x80000000 else v


def vector_norm_len(x_: int, y_: int) -> tuple[int, int]:
    """FT_Vector_NormLen: the unit vector of (x_, y_) in 16.16."""
    sx = sy = 1
    x, y = x_, y_
    if x < 0:
        x, sx = -x, -1
    if y < 0:
        y, sy = -y, -1
    if x == 0:
        return 0, (sy * 0x10000 if y > 0 else y_)
    if y == 0:
        return sx * 0x10000, 0
    l = x + (y >> 1) if x > y else y + (x >> 1)
    shift = 31 - (l.bit_length() - 1)
    shift -= 15 + (l >= (0xAAAAAAAA >> shift))
    if shift > 0:
        x = (x << shift) & 0xFFFFFFFF
        y = (y << shift) & 0xFFFFFFFF
        l = x + (y >> 1) if x > y else y + (x >> 1)
    else:
        x >>= -shift
        y >>= -shift
        l >>= -shift
    b = 0x10000 - l
    xi, yi = _i32(x), _i32(y)
    while True:
        u = (xi + ((xi * b) >> 16)) & 0xFFFFFFFF
        v = (yi + ((yi * b) >> 16)) & 0xFFFFFFFF
        z = _cdiv(-_i32(u * u + v * v), 0x200)
        z = _cdiv(_i32(z * ((0x10000 + b) >> 8)), 0x10000)
        b += z
        if z <= 0:
            break
    return (-u if sx < 0 else u), (-v if sy < 0 else v)


def normalize(vx: int, vy: int):
    """The interpreter's Normalize: (vx, vy) as a 2.14 unit vector, or
    None for the zero vector (which leaves the target vector as it was)."""
    if vx == 0 and vy == 0:
        return None
    ux, uy = vector_norm_len(vx, vy)
    return _cdiv(ux, 4), _cdiv(uy, 4)


def pix_round(v: int) -> int:
    return (v + 32) & -64


# -- zones -------------------------------------------------------------------

class Zone:
    """Points of one zone: original (org), current (cur) and unscaled
    (orus) coordinates, tags (bit 0 on-curve, TOUCH_X, TOUCH_Y) and the
    contour ends."""

    __slots__ = ("ox", "oy", "cx", "cy", "ux", "uy", "tags", "ends", "n")

    def __init__(self, n: int, ends=()):
        self.ox = [0] * n
        self.oy = [0] * n
        self.cx = [0] * n
        self.cy = [0] * n
        self.ux = [0] * n
        self.uy = [0] * n
        self.tags = [0] * n
        self.ends = list(ends)
        self.n = n

    def copy(self) -> "Zone":
        z = Zone.__new__(Zone)
        z.ox, z.oy, z.cx, z.cy = self.ox[:], self.oy[:], self.cx[:], \
            self.cy[:]
        z.ux, z.uy, z.tags = self.ux[:], self.uy[:], self.tags[:]
        z.ends, z.n = self.ends[:], self.n
        return z


class _Abort(Exception):
    """An error that stops the program (FreeType keeps what it did)."""


class GraphicsState:
    __slots__ = ("rp0", "rp1", "rp2", "dvx", "dvy", "pvx", "pvy", "fvx",
                 "fvy", "loop", "min_dist", "round_state", "auto_flip",
                 "cvt_cutin", "sw_cutin", "sw_value", "delta_base",
                 "delta_shift", "instruct_control", "scan_control",
                 "scan_type", "gep0", "gep1", "gep2")

    def __init__(self):
        self.rp0 = self.rp1 = self.rp2 = 0
        self.dvx = self.pvx = self.fvx = 0x4000
        self.dvy = self.pvy = self.fvy = 0
        self.loop = 1
        self.min_dist = 64
        self.round_state = RTG
        self.auto_flip = True
        self.cvt_cutin = 68
        self.sw_cutin = 0
        self.sw_value = 0
        self.delta_base = 9
        self.delta_shift = 3
        self.instruct_control = 0
        self.scan_control = False
        self.scan_type = 0
        self.gep0 = self.gep1 = self.gep2 = 1

    def copy(self) -> "GraphicsState":
        g = GraphicsState.__new__(GraphicsState)
        for k in self.__slots__:
            setattr(g, k, getattr(self, k))
        return g


class FunctionDef:
    __slots__ = ("code", "start", "end")

    def __init__(self, code, start, end):
        self.code, self.start, self.end = code, start, end


# -- the interpreter ---------------------------------------------------------

class Interpreter:
    """One execution context: a size's CVT, storage, twilight zone and
    graphics state, and the function and instruction definitions of the
    face."""

    def __init__(self, font: sfnt.Font, ppem: int, scale: int,
                 functions: dict, idefs: dict):
        self.font = font
        self.ppem = ppem
        self.point_size = ppem * 64
        self.scale = scale
        self.x_scale = self.y_scale = scale
        self.functions = functions
        self.idefs = idefs
        self.gs = GraphicsState()
        self.cvt = []
        self.storage = [0] * max(font.max_storage, 0)
        self.twilight = Zone(font.max_twilight)
        self.pts = Zone(0)
        self.period, self.phase, self.threshold = 64, 0, 0
        self.in_glyph = False
        self.is_composite = False
        self.compat = False
        self.iupx = self.iupy = False
        self.count = 0

    # -- vectors and zones ------------------------------------------------
    def _compute_funcs(self):
        g = self.gs
        if g.fvx == 0x4000:
            f = g.pvx
        elif g.fvy == 0x4000:
            f = g.pvy
        else:
            f = dot_fix14(g.pvx, g.pvy, g.fvx, g.fvy)
        if -0x400 < f < 0x400:
            f = 0x4000
        self.fdotp = f

    def _zone(self, n):
        if n == 0:
            return self.twilight
        if n == 1:
            return self.pts
        raise _Abort

    def _set_zones(self):
        g = self.gs
        self.zp0 = self._zone(g.gep0)
        self.zp1 = self._zone(g.gep1)
        self.zp2 = self._zone(g.gep2)

    def _project(self, dx, dy):
        g = self.gs
        return dot_fix14(dx, dy, g.pvx, g.pvy)

    def _dualproj(self, dx, dy):
        g = self.gs
        return dot_fix14(dx, dy, g.dvx, g.dvy)

    def _move(self, z: Zone, p: int, d: int):
        """Direct_Move with the v40 backward-compatibility rules: no x
        moves, and no y moves once IUP ran on both axes."""
        g = self.gs
        if g.fvx:
            if not self.compat:
                z.cx[p] += mul_div(d, g.fvx, self.fdotp)
            z.tags[p] |= TOUCH_X
        if g.fvy:
            if not (self.compat and self.iupx and self.iupy):
                z.cy[p] += mul_div(d, g.fvy, self.fdotp)
            z.tags[p] |= TOUCH_Y

    def _move_orig(self, z: Zone, p: int, d: int):
        g = self.gs
        if g.fvx:
            z.ox[p] += mul_div(d, g.fvx, self.fdotp)
        if g.fvy:
            z.oy[p] += mul_div(d, g.fvy, self.fdotp)

    def _move_zp2(self, p, dx, dy, touch):
        """Move_Zp2_Point."""
        g, z = self.gs, self.zp2
        if g.fvx:
            if not self.compat:
                z.cx[p] += dx
            if touch:
                z.tags[p] |= TOUCH_X
        if g.fvy:
            if not (self.compat and self.iupx and self.iupy):
                z.cy[p] += dy
            if touch:
                z.tags[p] |= TOUCH_Y

    # -- rounding -----------------------------------------------------------
    def _round(self, d: int) -> int:
        s = self.gs.round_state
        if s == RTG:
            if d >= 0:
                v = (d + 32) & -64
                return v if v > 0 else 0
            v = -((32 - d) & -64)
            return v if v < 0 else 0
        if s == RTHG:
            if d >= 0:
                v = (d & -64) + 32
                return v if v >= 0 else 32
            v = -(((-d) & -64) + 32)
            return v if v <= 0 else -32
        if s == RTDG:
            if d >= 0:
                v = (d + 16) & -32
                return v if v > 0 else 0
            v = -((16 - d) & -32)
            return v if v < 0 else 0
        if s == RDTG:
            if d >= 0:
                v = d & -64
                return v if v > 0 else 0
            v = -((-d) & -64)
            return v if v < 0 else 0
        if s == RUTG:
            if d >= 0:
                v = (d + 63) & -64
                return v if v > 0 else 0
            v = -((63 - d) & -64)
            return v if v < 0 else 0
        if s == ROFF:
            return d
        if s == RSUPER:
            if d >= 0:
                v = ((d + self.threshold - self.phase) & -self.period) \
                    + self.phase
                return v if v >= 0 else self.phase
            v = -((self.threshold - self.phase - d) & -self.period) \
                - self.phase
            return v if v <= 0 else -self.phase
        # RSUPER45
        if d >= 0:
            v = _cdiv(d + self.threshold - self.phase, self.period) \
                * self.period + self.phase
            return v if v >= 0 else self.phase
        v = -(_cdiv(self.threshold - self.phase - d, self.period)
              * self.period) - self.phase
        return v if v <= 0 else -self.phase

    def _super_round(self, grid_period: int, sel: int):
        k = sel & 0xC0
        period = {0: grid_period // 2, 0x40: grid_period,
                  0x80: grid_period * 2, 0xC0: grid_period}[k]
        phase = (0, period // 4, period // 2, period * 3 // 4)[
            (sel & 0x30) >> 4]
        if sel & 0x0F == 0:
            threshold = period - 1
        else:
            threshold = _cdiv(((sel & 0x0F) - 4) * period, 8)
        self.period = period >> 8
        self.phase = phase >> 8
        self.threshold = threshold >> 8

    # -- running ------------------------------------------------------------
    def run(self, code: bytes, glyph: bool):
        """Run ``code``: the font program, the CVT program or a glyph
        program (TT_RunIns). Errors stop the program, as in FreeType when
        it is not pedantic."""
        self.in_glyph = glyph
        g = self.gs
        self.compat = not (g.instruct_control & 4)
        self.iupx = self.iupy = False
        self.count = 0
        self.stack = []
        self._compute_funcs()
        self._set_zones()
        try:
            self._exec(code, 0, len(code), None)
        except _Abort:
            pass

    def _exec(self, code, ip, end, fdef):
        st = self.stack
        ops = _OPS
        while ip < end:
            op = code[ip]
            self.count += 1
            if self.count > MAX_INSTRUCTIONS:
                raise _Abort
            if 0xB0 <= op <= 0xBF:
                if op < 0xB8:
                    n = op - 0xAF
                    st.extend(code[ip + 1:ip + 1 + n])
                    ip += 1 + n
                else:
                    n = op - 0xB7
                    for k in range(n):
                        v = (code[ip + 1 + 2 * k] << 8) | code[ip + 2 + 2 * k]
                        st.append(v - 0x10000 if v & 0x8000 else v)
                    ip += 1 + 2 * n
                continue
            if op == 0x40:
                n = code[ip + 1]
                st.extend(code[ip + 2:ip + 2 + n])
                ip += 2 + n
                continue
            if op == 0x41:
                n = code[ip + 1]
                for k in range(n):
                    v = (code[ip + 2 + 2 * k] << 8) | code[ip + 3 + 2 * k]
                    st.append(v - 0x10000 if v & 0x8000 else v)
                ip += 2 + 2 * n
                continue
            need = POPS[op]
            if len(st) < need:
                st[0:0] = [0] * (need - len(st))
            h = ops[op]
            if h is not None:
                h(self, op)
                ip += 1
                continue
            # flow control
            if op == 0x58:                                  # IF
                if st.pop() == 0:
                    ip = _skip_if(code, ip, end)
                    if ip is None:
                        return
                ip += 1
            elif op == 0x1B:                                # ELSE
                ip = _skip_else(code, ip, end)
                if ip is None:
                    return
                ip += 1
            elif op == 0x59:                                # EIF
                ip += 1
            elif op in (0x1C, 0x78, 0x79):                  # JMPR JROT JROF
                if op == 0x1C:
                    off = st.pop()
                else:
                    e = st.pop()
                    off = st.pop()
                    if (op == 0x78) != (e != 0):
                        ip += 1
                        continue
                if off == 0:
                    raise _Abort
                ip += off
                if ip < 0 or (fdef is not None and ip > fdef.end):
                    raise _Abort
            elif op in (0x2B, 0x2A):                        # CALL LOOPCALL
                fn = st.pop()
                cnt = st.pop() if op == 0x2A else 1
                f = self.functions.get(fn)
                if f is None:
                    raise _Abort
                for _ in range(cnt):
                    self._exec(f.code, f.start, f.end, f)
                ip += 1
            elif op == 0x2D:                                # ENDF
                if fdef is None:
                    raise _Abort
                return
            elif op in (0x2C, 0x89):                        # FDEF IDEF
                if self.in_glyph:
                    raise _Abort
                n = st.pop()
                start = ip + 1
                j = _skip_to_endf(code, ip, end)
                if j is None:
                    raise _Abort
                if op == 0x2C:
                    if n > 0xFFFF or (n not in self.functions and len(
                            self.functions) >= self.font.max_fdefs):
                        raise _Abort
                    self.functions[n] = FunctionDef(code, start, j)
                else:
                    self.idefs[n & 0xFF] = FunctionDef(code, start, j)
                ip = j + 1
            elif op == 0x4F:                                # DEBUG
                raise _Abort
            else:
                d = self.idefs.get(op)
                if d is None:
                    raise unported(
                        f"TrueType opcode {opcode_name(op)} (0x{op:02X}) "
                        f"in {self.font.name!r}", 14)
                self._exec(d.code, d.start, d.end, d)
                ip += 1
        if fdef is not None and ip >= len(code):
            raise _Abort


def _ins_len(code, ip):
    op = code[ip]
    if op == 0x40:
        return 2 + code[ip + 1]
    if op == 0x41:
        return 2 + 2 * code[ip + 1]
    if 0xB0 <= op <= 0xB7:
        return 1 + op - 0xAF
    if 0xB8 <= op <= 0xBF:
        return 1 + 2 * (op - 0xB7)
    return 1


def _skip_if(code, ip, end):
    """From a false IF at ``ip``: the index of its ELSE or EIF."""
    n = 1
    while True:
        ip += _ins_len(code, ip)
        if ip >= end:
            return None
        op = code[ip]
        if op == 0x58:
            n += 1
        elif op == 0x1B and n == 1:
            return ip
        elif op == 0x59:
            n -= 1
            if n == 0:
                return ip


def _skip_else(code, ip, end):
    n = 1
    while True:
        ip += _ins_len(code, ip)
        if ip >= end:
            return None
        op = code[ip]
        if op == 0x58:
            n += 1
        elif op == 0x59:
            n -= 1
            if n == 0:
                return ip


def _skip_to_endf(code, ip, end):
    while True:
        ip += _ins_len(code, ip)
        if ip >= end:
            return None
        op = code[ip]
        if op in (0x2C, 0x89):
            return None
        if op == 0x2D:
            return ip


# -- instruction handlers (h(interp, opcode)) --------------------------------

def _svtca(it, op):
    g = it.gs
    a = (op & 1) << 14
    b = a ^ 0x4000
    if op < 0x02:
        g.fvx, g.fvy = a, b
        g.pvx = g.dvx = a
        g.pvy = g.dvy = b
    elif op < 0x04:
        g.pvx = g.dvx = a
        g.pvy = g.dvy = b
    else:
        g.fvx, g.fvy = a, b
    it._compute_funcs()


def _sxvtl(it, op, a1, a2):
    """Ins_SxVTL: the unit vector from zp2[a1] to zp1[a2], rotated for the
    odd opcode; None where a point is out of range."""
    z1, z2 = it.zp1, it.zp2
    if not (0 <= a1 < z2.n and 0 <= a2 < z1.n):
        return None
    A = z1.cx[a2] - z2.cx[a1]
    B = z1.cy[a2] - z2.cy[a1]
    if A == 0 and B == 0:
        A, op = 0x4000, 0
    if op & 1:
        A, B = -B, A
    return normalize(A, B)


def _spvtl(it, op):
    st = it.stack
    a0 = st.pop()
    a1 = st.pop()
    v = _sxvtl(it, op, a0, a1)
    if v is not None:
        g = it.gs
        g.pvx, g.pvy = v
        g.dvx, g.dvy = v
        it._compute_funcs()


def _sfvtl(it, op):
    st = it.stack
    a0 = st.pop()
    a1 = st.pop()
    v = _sxvtl(it, op, a0, a1)
    if v is not None:
        it.gs.fvx, it.gs.fvy = v
        it._compute_funcs()


def _spvfs(it, op):
    st = it.stack
    y = _s16(st.pop())
    x = _s16(st.pop())
    v = normalize(x, y)
    g = it.gs
    if v is not None:
        if op == 0x0A:
            g.pvx, g.pvy = v
            g.dvx, g.dvy = v
        else:
            g.fvx, g.fvy = v
    it._compute_funcs()


def _s16(v):
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _gpv(it, op):
    g = it.gs
    if op == 0x0C:
        it.stack.extend((g.pvx, g.pvy))
    else:
        it.stack.extend((g.fvx, g.fvy))


def _sfvtpv(it, op):
    g = it.gs
    g.fvx, g.fvy = g.pvx, g.pvy
    it._compute_funcs()


def _isect(it, op):
    st = it.stack
    b1, b0, a1, a0, p = st.pop(), st.pop(), st.pop(), st.pop(), st.pop()
    z0, z1, z2 = it.zp0, it.zp1, it.zp2
    if not (0 <= b0 < z0.n and 0 <= b1 < z0.n and 0 <= a0 < z1.n
            and 0 <= a1 < z1.n and 0 <= p < z2.n):
        return
    dbx = z0.cx[b1] - z0.cx[b0]
    dby = z0.cy[b1] - z0.cy[b0]
    dax = z1.cx[a1] - z1.cx[a0]
    day = z1.cy[a1] - z1.cy[a0]
    dx = z0.cx[b0] - z1.cx[a0]
    dy = z0.cy[b0] - z1.cy[a0]
    disc = mul_div(dax, -dby, 0x40) + mul_div(day, dbx, 0x40)
    dotp = mul_div(dax, dbx, 0x40) + mul_div(day, dby, 0x40)
    if 19 * abs(disc) > abs(dotp):
        val = mul_div(dx, -dby, 0x40) + mul_div(dy, dbx, 0x40)
        z2.cx[p] = z1.cx[a0] + mul_div(val, dax, disc)
        z2.cy[p] = z1.cy[a0] + mul_div(val, day, disc)
    else:
        z2.cx[p] = _cdiv(z1.cx[a0] + z1.cx[a1] + z0.cx[b0] + z0.cx[b1], 4)
        z2.cy[p] = _cdiv(z1.cy[a0] + z1.cy[a1] + z0.cy[b0] + z0.cy[b1], 4)
    z2.tags[p] |= TOUCH_BOTH


def _srp(it, op):
    v = it.stack.pop() & 0xFFFF
    g = it.gs
    if op == 0x10:
        g.rp0 = v
    elif op == 0x11:
        g.rp1 = v
    else:
        g.rp2 = v


def _szp(it, op):
    n = it.stack.pop()
    if n not in (0, 1):
        return
    z = it.twilight if n == 0 else it.pts
    g = it.gs
    if op in (0x13, 0x16):
        it.zp0, g.gep0 = z, n
    if op in (0x14, 0x16):
        it.zp1, g.gep1 = z, n
    if op in (0x15, 0x16):
        it.zp2, g.gep2 = z, n


def _sloop(it, op):
    v = it.stack.pop()
    if v < 0:
        raise _Abort
    it.gs.loop = min(v, 0xFFFF)


def _set_round(it, op):
    it.gs.round_state = {0x18: RTG, 0x19: RTHG, 0x3D: RTDG, 0x7A: ROFF,
                         0x7C: RUTG, 0x7D: RDTG}[op]


def _smd(it, op):
    it.gs.min_dist = it.stack.pop()


def _scvtci(it, op):
    it.gs.cvt_cutin = it.stack.pop()


def _sswci(it, op):
    it.gs.sw_cutin = it.stack.pop()


def _ssw(it, op):
    it.gs.sw_value = mul_fix(it.stack.pop(), it.scale)


def _dup(it, op):
    v = it.stack.pop()
    it.stack.extend((v, v))


def _pop(it, op):
    it.stack.pop()


def _clear(it, op):
    it.stack.clear()


def _swap(it, op):
    st = it.stack
    st[-1], st[-2] = st[-2], st[-1]


def _depth(it, op):
    it.stack.append(len(it.stack))


def _cindex(it, op):
    st = it.stack
    k = st.pop()
    st.append(st[-k] if 0 < k <= len(st) else 0)


def _mindex(it, op):
    st = it.stack
    k = st.pop()
    if 0 < k <= len(st):
        st.append(st.pop(-k))


def _alignpts(it, op):
    st = it.stack
    p2 = st.pop() & 0xFFFF
    p1 = st.pop() & 0xFFFF
    z0, z1 = it.zp0, it.zp1
    if p1 >= z1.n or p2 >= z0.n:
        return
    d = _cdiv(it._project(z0.cx[p2] - z1.cx[p1], z0.cy[p2] - z1.cy[p1]), 2)
    it._move(z1, p1, d)
    it._move(z0, p2, -d)


def _utp(it, op):
    p = it.stack.pop() & 0xFFFF
    z = it.zp0
    if p >= z.n:
        return
    g = it.gs
    mask = 0xFF
    if g.fvx:
        mask &= ~TOUCH_X
    if g.fvy:
        mask &= ~TOUCH_Y
    z.tags[p] &= mask


def _mdap(it, op):
    p = it.stack.pop() & 0xFFFF
    z = it.zp0
    if p >= z.n:
        return
    if op & 1:
        cur = it._project(z.cx[p], z.cy[p])
        d = it._round(cur) - cur
    else:
        d = 0
    it._move(z, p, d)
    it.gs.rp0 = it.gs.rp1 = p


def _iup(it, op):
    z = it.pts
    if not z.ends:
        return
    if it.compat:
        if it.iupx and it.iupy:
            return
        if op & 1:
            it.iupx = True
        else:
            it.iupy = True
    if op & 1:
        mask, org, cur, orus = TOUCH_X, z.ox, z.cx, z.ux
    else:
        mask, org, cur, orus = TOUCH_Y, z.oy, z.cy, z.uy
    tags, n = z.tags, z.n
    point = 0
    for end in z.ends:
        first = point
        if end >= n:
            end = n - 1
        while point <= end and not tags[point] & mask:
            point += 1
        if point <= end:
            first_t = cur_t = point
            point += 1
            while point <= end:
                if tags[point] & mask:
                    _iup_interp(org, cur, orus, cur_t + 1, point - 1, cur_t,
                                point)
                    cur_t = point
                point += 1
            if cur_t == first_t:
                dx = cur[cur_t] - org[cur_t]
                if dx:
                    for i in range(first, end + 1):
                        if i != cur_t:
                            cur[i] += dx
            else:
                _iup_interp(org, cur, orus, cur_t + 1, end, cur_t, first_t)
                if first_t > 0:
                    _iup_interp(org, cur, orus, first, first_t - 1, cur_t,
                                first_t)
        point = end + 1


def _iup_interp(org, cur, orus, p1, p2, r1, r2):
    if p1 > p2:
        return
    o1, o2 = orus[r1], orus[r2]
    if o1 > o2:
        o1, o2, r1, r2 = o2, o1, r2, r1
    org1, org2, cur1, cur2 = org[r1], org[r2], cur[r1], cur[r2]
    d1, d2 = cur1 - org1, cur2 - org2
    if cur1 == cur2 or o1 == o2:
        for i in range(p1, p2 + 1):
            x = org[i]
            if x <= org1:
                x += d1
            elif x >= org2:
                x += d2
            else:
                x = cur1
            cur[i] = x
    else:
        scale = None
        for i in range(p1, p2 + 1):
            x = org[i]
            if x <= org1:
                x += d1
            elif x >= org2:
                x += d2
            else:
                if scale is None:
                    scale = div_fix(cur2 - cur1, o2 - o1)
                x = cur1 + mul_fix(orus[i] - o1, scale)
            cur[i] = x


def _point_displacement(it, op):
    """Compute_Point_Displacement: (dx, dy, zone, reference point)."""
    g = it.gs
    if op & 1:
        z, p = it.zp0, g.rp1
    else:
        z, p = it.zp1, g.rp2
    if p >= z.n:
        return None
    d = it._project(z.cx[p] - z.ox[p], z.cy[p] - z.oy[p])
    return (mul_div(d, g.fvx, it.fdotp), mul_div(d, g.fvy, it.fdotp), z, p)


def _pop_loop(it):
    st, g = it.stack, it.gs
    n = g.loop
    g.loop = 1
    if len(st) < n:
        return None
    pts = st[len(st) - n:][::-1]
    del st[len(st) - n:]
    return pts


def _shp(it, op):
    g = it.gs
    if len(it.stack) < g.loop:
        g.loop = 1
        return
    r = _point_displacement(it, op)
    if r is None:
        return
    dx, dy, _z, _p = r
    n2 = it.zp2.n
    for p in _pop_loop(it):
        if 0 <= p < n2:
            it._move_zp2(p, dx, dy, True)


def _shc(it, op):
    g = it.gs
    c = _s16(it.stack.pop())
    z2 = it.zp2
    bounds = 1 if g.gep2 == 0 else len(z2.ends)
    if not 0 <= c < bounds:
        return
    r = _point_displacement(it, op)
    if r is None:
        return
    dx, dy, zp, refp = r
    start = 0 if c == 0 else z2.ends[c - 1] + 1
    limit = z2.n if g.gep2 == 0 else z2.ends[c] + 1
    for i in range(start, limit):
        if zp is not z2 or refp != i:
            it._move_zp2(i, dx, dy, True)


def _shz(it, op):
    g = it.gs
    e = it.stack.pop()
    if not 0 <= e < 2:
        return
    r = _point_displacement(it, op)
    if r is None:
        return
    dx, dy, zp, refp = r
    z2 = it.zp2
    if g.gep2 == 0:
        limit = z2.n
    elif g.gep2 == 1 and z2.ends:
        limit = z2.ends[-1] + 1
    else:
        limit = 0
    for i in range(limit):
        if zp is not z2 or refp != i:
            it._move_zp2(i, dx, dy, False)


def _shpix(it, op):
    g = it.gs
    st = it.stack
    d = st.pop()
    if len(st) < g.loop:
        g.loop = 1
        return
    in_twilight = g.gep0 == 0 or g.gep1 == 0 or g.gep2 == 0
    dx = mul_fix14(d, g.fvx)
    dy = mul_fix14(d, g.fvy)
    z2 = it.zp2
    for p in _pop_loop(it):
        if not 0 <= p < z2.n:
            continue
        if it.compat:
            if in_twilight or (not (it.iupx and it.iupy) and (
                    (it.is_composite and g.fvy != 0)
                    or z2.tags[p] & TOUCH_Y)):
                it._move_zp2(p, 0, dy, True)
        else:
            it._move_zp2(p, dx, dy, True)


def _ip(it, op):
    g = it.gs
    st = it.stack
    if len(st) < g.loop:
        g.loop = 1
        return
    z0, z1, z2 = it.zp0, it.zp1, it.zp2
    twilight = g.gep0 == 0 or g.gep1 == 0 or g.gep2 == 0
    rp1, rp2 = g.rp1, g.rp2
    if rp1 >= z0.n:
        g.loop = 1
        del st[len(st) - g.loop:]
        return
    if twilight:
        bx, by = z0.ox[rp1], z0.oy[rp1]
    else:
        bx, by = z0.ux[rp1], z0.uy[rp1]
    cbx, cby = z0.cx[rp1], z0.cy[rp1]
    if rp2 >= z1.n:
        old_range = cur_range = 0
    else:
        if twilight:
            old_range = it._dualproj(z1.ox[rp2] - bx, z1.oy[rp2] - by)
        else:
            old_range = it._dualproj(z1.ux[rp2] - bx, z1.uy[rp2] - by)
        cur_range = it._project(z1.cx[rp2] - cbx, z1.cy[rp2] - cby)
    for p in _pop_loop(it):
        if not 0 <= p < z2.n:
            continue
        if twilight:
            org_dist = it._dualproj(z2.ox[p] - bx, z2.oy[p] - by)
        else:
            org_dist = it._dualproj(z2.ux[p] - bx, z2.uy[p] - by)
        cur_dist = it._project(z2.cx[p] - cbx, z2.cy[p] - cby)
        if org_dist:
            new_dist = (mul_div(org_dist, cur_range, old_range)
                        if old_range else org_dist)
        else:
            new_dist = 0
        it._move(z2, p, new_dist - cur_dist)


def _msirp(it, op):
    g = it.gs
    st = it.stack
    d = st.pop()
    p = st.pop() & 0xFFFF
    z0, z1 = it.zp0, it.zp1
    if p >= z1.n or g.rp0 >= z0.n:
        return
    if g.gep1 == 0:
        z1.ox[p], z1.oy[p] = z0.ox[g.rp0], z0.oy[g.rp0]
        it._move_orig(z1, p, d)
        z1.cx[p], z1.cy[p] = z1.ox[p], z1.oy[p]
    dist = it._project(z1.cx[p] - z0.cx[g.rp0], z1.cy[p] - z0.cy[g.rp0])
    it._move(z1, p, d - dist)
    g.rp1 = g.rp0
    g.rp2 = p
    if op & 1:
        g.rp0 = p


def _alignrp(it, op):
    g = it.gs
    z0, z1 = it.zp0, it.zp1
    if len(it.stack) < g.loop or g.rp0 >= z0.n:
        g.loop = 1
        return
    r = g.rp0
    for p in _pop_loop(it):
        if 0 <= p < z1.n:
            d = it._project(z1.cx[p] - z0.cx[r], z1.cy[p] - z0.cy[r])
            it._move(z1, p, -d)


def _miap(it, op):
    g = it.gs
    st = it.stack
    cvt_i = st.pop()
    p = st.pop() & 0xFFFF
    z0 = it.zp0
    if p >= z0.n or not 0 <= cvt_i < len(it.cvt):
        g.rp0 = g.rp1 = p
        return
    dist = it.cvt[cvt_i]
    if g.gep0 == 0:
        z0.ox[p] = mul_fix14(dist, g.fvx)
        z0.oy[p] = mul_fix14(dist, g.fvy)
        z0.cx[p], z0.cy[p] = z0.ox[p], z0.oy[p]
    org_dist = it._project(z0.cx[p], z0.cy[p])
    if op & 1:
        if abs(dist - org_dist) > g.cvt_cutin:
            dist = org_dist
        dist = it._round(dist)
    it._move(z0, p, dist - org_dist)
    g.rp0 = g.rp1 = p


def _ws(it, op):
    st = it.stack
    v = st.pop()
    i = st.pop()
    if 0 <= i < len(it.storage):
        it.storage[i] = v


def _rs(it, op):
    st = it.stack
    i = st.pop()
    st.append(it.storage[i] if 0 <= i < len(it.storage) else 0)


def _wcvtp(it, op):
    st = it.stack
    v = st.pop()
    i = st.pop()
    if 0 <= i < len(it.cvt):
        it.cvt[i] = v if op == 0x44 else mul_fix(v, it.scale)


def _rcvt(it, op):
    st = it.stack
    i = st.pop()
    st.append(it.cvt[i] if 0 <= i < len(it.cvt) else 0)


def _gc(it, op):
    st = it.stack
    p = st.pop()
    z = it.zp2
    if not 0 <= p < z.n:
        st.append(0)
    elif op & 1:
        st.append(it._dualproj(z.ox[p], z.oy[p]))
    else:
        st.append(it._project(z.cx[p], z.cy[p]))


def _scfs(it, op):
    st = it.stack
    v = st.pop()
    p = st.pop() & 0xFFFF
    z = it.zp2
    if p >= z.n:
        return
    k = it._project(z.cx[p], z.cy[p])
    it._move(z, p, v - k)
    if it.gs.gep2 == 0:
        z.ox[p], z.oy[p] = z.cx[p], z.cy[p]


def _md(it, op):
    st = it.stack
    k = st.pop() & 0xFFFF
    l = st.pop() & 0xFFFF
    z0, z1 = it.zp0, it.zp1
    g = it.gs
    if l >= z0.n or k >= z1.n:
        st.append(0)
        return
    if op & 1:
        d = it._project(z0.cx[l] - z1.cx[k], z0.cy[l] - z1.cy[k])
    elif g.gep0 == 0 or g.gep1 == 0:
        d = it._dualproj(z0.ox[l] - z1.ox[k], z0.oy[l] - z1.oy[k])
    else:
        d = mul_fix(it._dualproj(z0.ux[l] - z1.ux[k], z0.uy[l] - z1.uy[k]),
                    it.x_scale)
    st.append(d)


def _mppem(it, op):
    it.stack.append(it.ppem if op == 0x4B else it.point_size)


def _flip(it, op):
    it.gs.auto_flip = op == 0x4D


def _cmp(it, op):
    st = it.stack
    b = st.pop()
    a = st.pop()
    if op == 0x50:
        r = a < b
    elif op == 0x51:
        r = a <= b
    elif op == 0x52:
        r = a > b
    elif op == 0x53:
        r = a >= b
    elif op == 0x54:
        r = a == b
    else:
        r = a != b
    st.append(int(r))


def _odd(it, op):
    st = it.stack
    v = it._round(st.pop()) & 127
    st.append(int(v == 64) if op == 0x56 else int(v == 0))


def _logic(it, op):
    st = it.stack
    if op == 0x5C:
        st.append(int(st.pop() == 0))
        return
    b = st.pop()
    a = st.pop()
    st.append(int(bool(a) and bool(b)) if op == 0x5A
              else int(bool(a) or bool(b)))


def _deltap(it, op):
    st, g = it.stack, it.gs
    n = st.pop()
    z = it.zp0
    base = g.delta_base + {0x5D: 0, 0x71: 16, 0x72: 32}[op]
    for _ in range(n):
        if len(st) < 2:
            st.clear()
            return
        a = st.pop() & 0xFFFF
        b = st.pop()
        if a >= z.n:
            continue
        c = ((b & 0xF0) >> 4) + base
        if it.ppem != c:
            continue
        b = (b & 0xF) - 8
        if b >= 0:
            b += 1
        b *= 1 << (6 - g.delta_shift)
        if it.compat:
            if not (it.iupx and it.iupy) and (
                    (it.is_composite and g.fvy != 0) or z.tags[a] & TOUCH_Y):
                it._move(z, a, b)
        else:
            it._move(z, a, b)


def _deltac(it, op):
    st, g = it.stack, it.gs
    n = st.pop()
    base = g.delta_base + {0x73: 0, 0x74: 16, 0x75: 32}[op]
    for _ in range(n):
        if len(st) < 2:
            st.clear()
            return
        a = st.pop()
        b = st.pop()
        if not 0 <= a < len(it.cvt):
            continue
        c = ((b & 0xF0) >> 4) + base
        if it.ppem != c:
            continue
        b = (b & 0xF) - 8
        if b >= 0:
            b += 1
        it.cvt[a] += b * (1 << (6 - g.delta_shift))


def _sdb(it, op):
    it.gs.delta_base = it.stack.pop() & 0xFFFF


def _sds(it, op):
    v = it.stack.pop()
    if not 0 <= v <= 6:
        raise _Abort
    it.gs.delta_shift = v


def _arith(it, op):
    st = it.stack
    b = st.pop()
    a = st.pop()
    if op == 0x60:
        st.append(a + b)
    elif op == 0x61:
        st.append(a - b)
    elif op == 0x62:
        if b == 0:
            raise _Abort
        st.append(mul_div_no_round(a, 64, b))
    elif op == 0x63:
        st.append(mul_div(a, b, 64))
    elif op == 0x8B:
        st.append(max(a, b))
    else:
        st.append(min(a, b))


def _unary(it, op):
    st = it.stack
    v = st.pop()
    if op == 0x64:
        v = abs(v)
    elif op == 0x65:
        v = -v
    elif op == 0x66:
        v &= -64
    else:
        v = (v + 63) & -64
    st.append(v)


def _round_op(it, op):
    st = it.stack
    v = st.pop()
    st.append(it._round(v) if op < 0x6C else v)


def _sround(it, op):
    it._super_round(0x4000 if op == 0x76 else 0x2D41, it.stack.pop())
    it.gs.round_state = RSUPER if op == 0x76 else RSUPER45


def _noop1(it, op):
    it.stack.pop()


def _flippt(it, op):
    g = it.gs
    st = it.stack
    if it.compat and it.iupx and it.iupy:
        g.loop = 1
        return
    if len(st) < g.loop:
        g.loop = 1
        return
    z = it.pts
    for p in _pop_loop(it):
        if 0 <= p < z.n:
            z.tags[p] ^= 1


def _fliprg(it, op):
    st = it.stack
    k = st.pop() & 0xFFFF
    l = st.pop() & 0xFFFF
    if it.compat and it.iupx and it.iupy:
        return
    z = it.pts
    if k >= z.n or l >= z.n:
        return
    for i in range(l, k + 1):
        if op == 0x81:
            z.tags[i] |= 1
        else:
            z.tags[i] &= ~1


def _scanctrl(it, op):
    v = it.stack.pop()
    a = v & 0xFF
    g = it.gs
    if a == 0xFF:
        g.scan_control = True
        return
    if a == 0:
        g.scan_control = False
        return
    if v & 0x100 and it.ppem <= a:
        g.scan_control = True
    if v & 0x800 and it.ppem > a:
        g.scan_control = False


def _sdpvtl(it, op):
    st = it.stack
    p1 = st.pop() & 0xFFFF
    p2 = st.pop() & 0xFFFF
    z1, z2 = it.zp1, it.zp2
    if p2 >= z1.n or p1 >= z2.n:
        return
    g = it.gs
    o = op
    A = z1.ox[p2] - z2.ox[p1]
    B = z1.oy[p2] - z2.oy[p1]
    if A == 0 and B == 0:
        A, o = 0x4000, 0
    if o & 1:
        A, B = -B, A
    v = normalize(A, B)
    if v is not None:
        g.dvx, g.dvy = v
    A = z1.cx[p2] - z2.cx[p1]
    B = z1.cy[p2] - z2.cy[p1]
    if A == 0 and B == 0:
        A, o = 0x4000, 0
    if o & 1:
        A, B = -B, A
    v = normalize(A, B)
    if v is not None:
        g.pvx, g.pvy = v
    it._compute_funcs()


def _getinfo(it, op):
    st = it.stack
    sel = st.pop()
    k = 0
    if sel & 1:
        k = 40
    # v40 outside monochrome rendering: subpixel hinting (bit 13),
    # subpixel positioned (17), symmetrical smoothing (18), ClearType
    # hinting with grayscale rendering (19).
    if sel & 64:
        k |= 1 << 13
    if sel & 1024:
        k |= 1 << 17
    if sel & 2048:
        k |= 1 << 18
    if sel & 4096:
        k |= 1 << 19
    st.append(k)


def _roll(it, op):
    st = it.stack
    st[-3], st[-2], st[-1] = st[-2], st[-1], st[-3]


def _scantype(it, op):
    v = it.stack.pop()
    if v >= 0:
        it.gs.scan_type = v & 0xFFFF


def _instctrl(it, op):
    st = it.stack
    k = st.pop()
    l = st.pop()
    if not 1 <= k <= 3:
        return
    kf = 1 << (k - 1)
    if l != 0 and l != kf:
        return
    if it.in_glyph:
        return
    g = it.gs
    g.instruct_control = (g.instruct_control & ~kf) | l
    if k == 3:
        it.compat = l != 4


def _mdrp(it, op):
    g = it.gs
    p = it.stack.pop() & 0xFFFF
    z0, z1 = it.zp0, it.zp1
    r = g.rp0
    if p >= z1.n or r >= z0.n:
        g.rp1 = g.rp0
        g.rp2 = p
        if op & 16:
            g.rp0 = p
        return
    if g.gep0 == 0 or g.gep1 == 0:
        org = it._dualproj(z1.ox[p] - z0.ox[r], z1.oy[p] - z0.oy[r])
    else:
        org = mul_fix(it._dualproj(z1.ux[p] - z0.ux[r],
                                   z1.uy[p] - z0.uy[r]), it.x_scale)
    swc, swv = g.sw_cutin, g.sw_value
    if swc > 0 and swv - swc < org < swv + swc:
        org = swv if org >= 0 else -swv
    dist = it._round(org) if op & 4 else org
    if op & 8:
        md = g.min_dist
        if org >= 0:
            if dist < md:
                dist = md
        elif dist > -md:
            dist = -md
    cur = it._project(z1.cx[p] - z0.cx[r], z1.cy[p] - z0.cy[r])
    it._move(z1, p, dist - cur)
    g.rp1 = g.rp0
    g.rp2 = p
    if op & 16:
        g.rp0 = p


def _mirp(it, op):
    g = it.gs
    st = it.stack
    cvt_e = st.pop() + 1
    p = st.pop() & 0xFFFF
    z0, z1 = it.zp0, it.zp1
    r = g.rp0
    if p >= z1.n or not 0 <= cvt_e < len(it.cvt) + 1 or r >= z0.n:
        g.rp1 = g.rp0
        if op & 16:
            g.rp0 = p
        g.rp2 = p
        return
    cvt = it.cvt[cvt_e - 1] if cvt_e else 0
    if abs(cvt - g.sw_value) < g.sw_cutin:
        cvt = g.sw_value if cvt >= 0 else -g.sw_value
    if g.gep1 == 0:
        z1.ox[p] = z0.ox[r] + mul_fix14(cvt, g.fvx)
        z1.oy[p] = z0.oy[r] + mul_fix14(cvt, g.fvy)
        z1.cx[p], z1.cy[p] = z1.ox[p], z1.oy[p]
    org = it._dualproj(z1.ox[p] - z0.ox[r], z1.oy[p] - z0.oy[r])
    cur = it._project(z1.cx[p] - z0.cx[r], z1.cy[p] - z0.cy[r])
    if g.auto_flip and (org ^ cvt) < 0:
        cvt = -cvt
    if op & 4:
        if g.gep0 == g.gep1 and abs(cvt - org) > g.cvt_cutin:
            cvt = org
        dist = it._round(cvt)
    else:
        dist = cvt
    if op & 8:
        md = g.min_dist
        if org >= 0:
            if dist < md:
                dist = md
        elif dist > -md:
            dist = -md
    it._move(z1, p, dist - cur)
    g.rp1 = g.rp0
    if op & 16:
        g.rp0 = p
    g.rp2 = p


_OPS = [None] * 256
for _o in range(0x00, 0x06):
    _OPS[_o] = _svtca
_OPS[0x06] = _OPS[0x07] = _spvtl
_OPS[0x08] = _OPS[0x09] = _sfvtl
_OPS[0x0A] = _OPS[0x0B] = _spvfs
_OPS[0x0C] = _OPS[0x0D] = _gpv
_OPS[0x0E] = _sfvtpv
_OPS[0x0F] = _isect
_OPS[0x10] = _OPS[0x11] = _OPS[0x12] = _srp
for _o in range(0x13, 0x17):
    _OPS[_o] = _szp
_OPS[0x17] = _sloop
for _o in (0x18, 0x19, 0x3D, 0x7A, 0x7C, 0x7D):
    _OPS[_o] = _set_round
_OPS[0x1A] = _smd
_OPS[0x1D] = _scvtci
_OPS[0x1E] = _sswci
_OPS[0x1F] = _ssw
_OPS[0x20] = _dup
_OPS[0x21] = _pop
_OPS[0x22] = _clear
_OPS[0x23] = _swap
_OPS[0x24] = _depth
_OPS[0x25] = _cindex
_OPS[0x26] = _mindex
_OPS[0x27] = _alignpts
_OPS[0x29] = _utp
_OPS[0x2E] = _OPS[0x2F] = _mdap
_OPS[0x30] = _OPS[0x31] = _iup
_OPS[0x32] = _OPS[0x33] = _shp
_OPS[0x34] = _OPS[0x35] = _shc
_OPS[0x36] = _OPS[0x37] = _shz
_OPS[0x38] = _shpix
_OPS[0x39] = _ip
_OPS[0x3A] = _OPS[0x3B] = _msirp
_OPS[0x3C] = _alignrp
_OPS[0x3E] = _OPS[0x3F] = _miap
_OPS[0x42] = _ws
_OPS[0x43] = _rs
_OPS[0x44] = _OPS[0x70] = _wcvtp
_OPS[0x45] = _rcvt
_OPS[0x46] = _OPS[0x47] = _gc
_OPS[0x48] = _scfs
_OPS[0x49] = _OPS[0x4A] = _md
_OPS[0x4B] = _OPS[0x4C] = _mppem
_OPS[0x4D] = _OPS[0x4E] = _flip
for _o in range(0x50, 0x56):
    _OPS[_o] = _cmp
_OPS[0x56] = _OPS[0x57] = _odd
_OPS[0x5A] = _OPS[0x5B] = _OPS[0x5C] = _logic
_OPS[0x5D] = _OPS[0x71] = _OPS[0x72] = _deltap
_OPS[0x73] = _OPS[0x74] = _OPS[0x75] = _deltac
_OPS[0x5E] = _sdb
_OPS[0x5F] = _sds
for _o in (0x60, 0x61, 0x62, 0x63, 0x8B, 0x8C):
    _OPS[_o] = _arith
for _o in range(0x64, 0x68):
    _OPS[_o] = _unary
for _o in range(0x68, 0x70):
    _OPS[_o] = _round_op
_OPS[0x76] = _OPS[0x77] = _sround
_OPS[0x7E] = _OPS[0x7F] = _noop1
_OPS[0x80] = _flippt
_OPS[0x81] = _OPS[0x82] = _fliprg
_OPS[0x85] = _scanctrl
_OPS[0x86] = _OPS[0x87] = _sdpvtl
_OPS[0x88] = _getinfo
_OPS[0x8A] = _roll
_OPS[0x8D] = _scantype
_OPS[0x8E] = _instctrl
for _o in range(0xC0, 0xE0):
    _OPS[_o] = _mdrp
for _o in range(0xE0, 0x100):
    _OPS[_o] = _mirp


# -- faces, sizes and glyphs -------------------------------------------------

class Outline:
    """A hinted glyph outline: 26.6 points, on-curve flags, contour ends."""

    __slots__ = ("xs", "ys", "on", "ends")

    def __init__(self, xs, ys, on, ends):
        self.xs, self.ys, self.on, self.ends = xs, ys, on, ends

    def cbox(self):
        if not self.xs:
            return 0, 0, 0, 0
        return min(self.xs), min(self.ys), max(self.xs), max(self.ys)


class Face:
    """A font ready to hint: ``fpgm`` run once, its functions kept."""

    def __init__(self, font: sfnt.Font):
        self.font = font
        if font.max_ins_size == 0 or not font.fpgm:
            raise unported(f"unhinted TrueType font {font.name!r} (no "
                           "glyph instructions or no font program: FreeType "
                           "draws it with its auto-hinter)", 14)
        self.functions: dict = {}
        self.idefs: dict = {}
        it = Interpreter(font, 0, 0, self.functions, self.idefs)
        it.run(font.fpgm, glyph=False)
        o = font.os2
        self._v_top = o["typo_ascender"] if o else font.hhea_ascender
        self._v_height = abs((o["typo_ascender"] - o["typo_descender"])
                             if o else (font.hhea_ascender
                                        - font.hhea_descender))

    def size(self, ppem: int, hint: bool = True) -> "Size":
        return Size(self, ppem, hint)


class Size:
    """One pixel size: the scale, the scaled CVT and the state ``prep``
    leaves; :meth:`glyph` loads hinted outlines."""

    def __init__(self, face: Face, ppem: int, hint: bool = True):
        self.face = face
        font = face.font
        self.ppem = ppem
        self.scale = div_fix(ppem << 6, font.units_per_em)
        it = Interpreter(font, ppem, self.scale, face.functions, face.idefs)
        it.cvt = [mul_fix(int(v) * 64, self.scale >> 6) for v in font.cvt]
        it.run(font.prep, glyph=False)
        g = it.gs
        self.hinting = hint and not (g.instruct_control & 1)
        if g.instruct_control & 2:
            # INSTCTRL selector 2: glyph programs start from the default
            # graphics state, not the one prep left.
            g = GraphicsState()
        # What every glyph program starts from (tt_size_run_prep and
        # TT_Run_Context): the vectors on x, rp0-rp2 at 0, the glyph zone,
        # a loop of 1 and rounding to the grid.
        g.dvx = g.pvx = g.fvx = 0x4000
        g.dvy = g.pvy = g.fvy = 0
        g.rp0 = g.rp1 = g.rp2 = 0
        g.gep0 = g.gep1 = g.gep2 = 1
        g.loop = 1
        g.round_state = RTG
        self.gs = g
        self.cvt = it.cvt
        self.storage = it.storage
        self.twilight = it.twilight
        self.round_params = (it.period, it.phase, it.threshold)

    # -- glyph loading -------------------------------------------------------
    def glyph(self, gid: int) -> Outline:
        """The hinted outline of glyph ``gid`` (TT_Load_Glyph with
        FT_LOAD_DEFAULT), translated by the left phantom point."""
        self._xs, self._ys, self._on, self._ends = [], [], [], []
        self._load(gid, 0)
        xs = self._xs
        if self._pp[0][0]:
            dx = self._pp[0][0]
            xs = [x - dx for x in xs]
        return Outline(xs, self._ys, self._on, self._ends)

    def _metrics(self, gid, bbox):
        font = self.face.font
        lsb, adv = int(font.lsbs[gid]), int(font.advances[gid])
        x_min, y_max = bbox[0], bbox[3]
        tsb = self.face._v_top - y_max
        pp1 = [x_min - lsb, 0]
        pp2 = [pp1[0] + adv, 0]
        # tt_loader_set_pp under v40 grayscale hinting: the vertical
        # phantom points stand at half the advance.
        pp3 = [adv // 2, tsb + y_max]
        pp4 = [adv // 2, pp3[1] - self.face._v_height]
        return [pp1, pp2, pp3, pp4]

    def _scaled_pp(self, pp):
        s = self.scale
        return [[mul_fix(x, s), mul_fix(y, s)] for x, y in pp]

    def _interp(self) -> Interpreter:
        face = self.face
        it = Interpreter(face.font, self.ppem, self.scale, face.functions,
                         face.idefs)
        it.cvt = self.cvt[:]
        it.storage = self.storage[:]
        it.twilight = self.twilight.copy()
        it.period, it.phase, it.threshold = self.round_params
        return it

    def _hint(self, zone: Zone, program: bytes, composite: bool):
        """TT_Hint_Glyph over ``zone`` (its last four points the phantom
        points). Returns whether backward compatibility was on."""
        n = zone.n
        if program:
            zone.ox, zone.oy = zone.cx[:], zone.cy[:]
        if composite:
            zone.ux, zone.uy = zone.cx[:], zone.cy[:]
        zone.cx[n - 4] = pix_round(zone.cx[n - 4])
        zone.cx[n - 3] = pix_round(zone.cx[n - 3])
        zone.cy[n - 2] = pix_round(zone.cy[n - 2])
        zone.cy[n - 1] = pix_round(zone.cy[n - 1])
        compat = not (self.gs.instruct_control & 4)
        if program and self.hinting:
            it = self._interp()
            it.gs = self.gs.copy()
            it.pts = zone
            it.is_composite = composite
            if composite:
                it.x_scale = it.y_scale = 0x10000
            it.run(program, glyph=True)
            compat = it.compat
        return compat

    def _load(self, gid, depth):
        font = self.face.font
        if depth > 16:
            raise ValueError("composite glyph nested too deep")
        g = font.glyph(gid)
        if g is None:
            self._pp = self._scaled_pp(self._metrics(gid, (0, 0, 0, 0)))
            return
        pp = self._metrics(gid, g.bbox)
        s = self.scale
        if isinstance(g, sfnt.SimpleGlyph):
            n = len(g.xs)
            zone = Zone(n + 4, [int(e) for e in g.ends])
            ux = [int(v) for v in g.xs] + [p[0] for p in pp]
            uy = [int(v) for v in g.ys] + [p[1] for p in pp]
            zone.ux, zone.uy = ux, uy
            zone.cx = [mul_fix(v, s) for v in ux]
            zone.cy = [mul_fix(v, s) for v in uy]
            zone.tags = [int(v) for v in g.on] + [0, 0, 0, 0]
            self._pp = [[zone.cx[n + k], zone.cy[n + k]] for k in range(4)]
            compat = (self._hint(zone, g.program, False) if self.hinting
                      else True)
            if not compat:
                self._pp = [[zone.cx[n + k], zone.cy[n + k]]
                            for k in range(4)]
            base = len(self._xs)
            self._xs.extend(zone.cx[:n])
            self._ys.extend(zone.cy[:n])
            self._on.extend(t & 1 for t in zone.tags[:n])
            self._ends.extend(base + e for e in zone.ends)
            return
        # composite
        self._pp = self._scaled_pp(pp)
        start_point = len(self._xs)
        start_contour = len(self._ends)
        for c in g.components:
            saved = [p[:] for p in self._pp]
            nbase = len(self._xs)
            self._load(c.gid, depth + 1)
            if not c.flags & sfnt.USE_MY_METRICS:
                self._pp = saved
            if len(self._xs) == nbase:
                continue
            self._place(c, start_point, nbase)
        if (self.hinting and g.program and len(self._xs) > start_point
                and g.components[-1].flags & sfnt.HAVE_INSTRUCTIONS):
            n = len(self._xs) - start_point
            zone = Zone(n + 4, [e - start_point
                                for e in self._ends[start_contour:]])
            zone.cx = self._xs[start_point:] + [p[0] for p in self._pp]
            zone.cy = self._ys[start_point:] + [p[1] for p in self._pp]
            zone.tags = self._on[start_point:] + [0, 0, 0, 0]
            compat = self._hint(zone, g.program, True)
            if not compat:
                self._pp = [[zone.cx[n + k], zone.cy[n + k]]
                            for k in range(4)]
            self._xs[start_point:] = zone.cx[:n]
            self._ys[start_point:] = zone.cy[:n]
            self._on[start_point:] = [t & 1 for t in zone.tags[:n]]

    def _place(self, c, start_point, nbase):
        """TT_Process_Composite_Component: transform the new component's
        points and move them by its offset or onto its anchor point."""
        xs, ys = self._xs, self._ys
        flags = c.flags
        have_scale = flags & (sfnt.HAVE_SCALE | sfnt.HAVE_XY_SCALE
                              | sfnt.HAVE_2X2)
        if have_scale:
            for i in range(nbase, len(xs)):
                x, y = xs[i], ys[i]
                xs[i] = mul_fix(x, c.xx) + mul_fix(y, c.xy)
                ys[i] = mul_fix(x, c.yx) + mul_fix(y, c.yy)
        if not flags & sfnt.ARGS_ARE_XY_VALUES:
            k, l = c.arg1 + start_point, c.arg2 + nbase
            if k >= nbase or l >= len(xs):
                raise ValueError("invalid composite anchor points")
            x, y = xs[k] - xs[l], ys[k] - ys[l]
        else:
            x, y = c.arg1, c.arg2
            if not x and not y:
                return
            if have_scale and flags & sfnt.SCALED_COMPONENT_OFFSET:
                raise unported("composite offsets scaled by their "
                               "component's transform", 14)
            x = mul_fix(x, self.scale)
            y = mul_fix(y, self.scale)
            # In backward-compatibility mode the v40 interpreter hints no
            # x, so only y snaps to the grid; with it off x snaps too.
            if flags & sfnt.ROUND_XY_TO_GRID and self.hinting:
                y = pix_round(y)
                if self.gs.instruct_control & 4:
                    x = pix_round(x)
        if x or y:
            for i in range(nbase, len(xs)):
                xs[i] += x
                ys[i] += y
