"""CKStateChunk: identifier-chunked typed serialization.

Carried from ``ckrenderengine_tpu.io.statechunk`` byte for byte, so that a
chunk written by either package reads in the other. API mirror of the
reference's CKStateChunk system (used by every class's Save/Load, e.g. mesh
save src/CKMesh.cpp `Save`/`Load`/`ILoadVertices`, include/RCKMesh.h:
183-188): data is written under integer identifiers (WriteIdentifier then
typed writes), read back by seeking an identifier (SeekIdentifier) then
reading in order. The binary container is the ``CKC1`` tag-length-value
stream: ints and object ids as ``<q``, floats as ``<d``, arrays with their
numpy descr and shape, sub-chunks as nested streams.
"""

from __future__ import annotations

import io
import struct

import numpy as np

_MAGIC = b"CKC1"

# value type tags
_T_INT = 1
_T_FLOAT = 2
_T_STRING = 3
_T_ARRAY = 4
_T_OBJID = 5
_T_SUBCHUNK = 6


class CKStateChunk:
    def __init__(self):
        # identifier -> list of (type, value); preserved write order
        self._sections: dict[int, list] = {}
        self._order: list[int] = []
        self._current_write: list | None = None
        self._read_queue: list = []

    # -- writing ------------------------------------------------------------
    def WriteIdentifier(self, ident: int):
        ident = int(ident)
        if ident not in self._sections:
            self._sections[ident] = []
            self._order.append(ident)
        self._current_write = self._sections[ident]
        return self

    def _w(self, t, v):
        assert self._current_write is not None, "WriteIdentifier first"
        self._current_write.append((t, v))

    def WriteInt(self, v: int):
        self._w(_T_INT, int(v))

    def WriteDword(self, v: int):
        self._w(_T_INT, int(v) & 0xFFFFFFFF)

    def WriteFloat(self, v: float):
        self._w(_T_FLOAT, float(v))

    def WriteString(self, s: str):
        self._w(_T_STRING, str(s) if s is not None else "")

    def WriteArray(self, a):
        self._w(_T_ARRAY, np.asarray(a))

    WriteBuffer = WriteArray

    def WriteVector(self, v):
        self.WriteArray(np.asarray(v, np.float32).reshape(-1))

    def WriteMatrix(self, m):
        self.WriteArray(np.asarray(m, np.float32).reshape(4, 4))

    def WriteObjectID(self, obj_or_id):
        oid = obj_or_id if isinstance(obj_or_id, int) \
            else (obj_or_id.id if obj_or_id is not None else 0)
        self._w(_T_OBJID, int(oid))

    def WriteObject(self, obj):
        self.WriteObjectID(obj)

    def WriteSubChunk(self, sub: "CKStateChunk"):
        self._w(_T_SUBCHUNK, sub)

    # -- reading ------------------------------------------------------------
    def SeekIdentifier(self, ident: int) -> bool:
        sec = self._sections.get(int(ident))
        if sec is None:
            return False
        self._read_queue = list(sec)
        return True

    def _r(self, t):
        tt, v = self._read_queue.pop(0)
        assert tt == t, f"chunk type mismatch: want {t}, got {tt}"
        return v

    def ReadInt(self) -> int:
        return self._r(_T_INT)

    ReadDword = ReadInt

    def ReadFloat(self) -> float:
        return self._r(_T_FLOAT)

    def ReadString(self) -> str:
        return self._r(_T_STRING)

    def ReadArray(self) -> np.ndarray:
        return self._r(_T_ARRAY)

    ReadBuffer = ReadArray

    def ReadVector(self) -> np.ndarray:
        return self.ReadArray()

    def ReadMatrix(self) -> np.ndarray:
        return self.ReadArray()

    def ReadObjectID(self) -> int:
        return self._r(_T_OBJID)

    def ReadSubChunk(self) -> "CKStateChunk":
        return self._r(_T_SUBCHUNK)

    def HasIdentifier(self, ident: int) -> bool:
        return int(ident) in self._sections

    # -- remap (reference dependency remap on load/copy) ---------------------
    def RemapObjectIDs(self, mapping: dict[int, int], default: int = 0,
                       keep_unmapped: bool = False):
        """Remap object references after load; unmapped ids become ``default``
        (0 = null reference) so stale ids never alias foreign objects.
        ``keep_unmapped=True`` leaves unmapped ids in place instead — the
        same-context partial remap used by dependency-aware Copy (shared
        dependencies keep resolving to the original objects)."""
        for sec in self._sections.values():
            for i, (t, v) in enumerate(sec):
                if t == _T_OBJID:
                    if keep_unmapped:
                        sec[i] = (t, mapping.get(v, v))
                    else:
                        sec[i] = (t, mapping.get(v, default) if v else 0)
                elif t == _T_SUBCHUNK:
                    v.RemapObjectIDs(mapping, default, keep_unmapped)

    # -- binary container ----------------------------------------------------
    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        out.write(_MAGIC)
        out.write(struct.pack("<I", len(self._order)))
        for ident in self._order:
            sec = self._sections[ident]
            out.write(struct.pack("<iI", ident, len(sec)))
            for t, v in sec:
                out.write(struct.pack("<B", t))
                if t == _T_INT or t == _T_OBJID:
                    out.write(struct.pack("<q", v))
                elif t == _T_FLOAT:
                    out.write(struct.pack("<d", v))
                elif t == _T_STRING:
                    b = v.encode("utf-8")
                    out.write(struct.pack("<I", len(b)))
                    out.write(b)
                elif t == _T_ARRAY:
                    dt = np.lib.format.dtype_to_descr(v.dtype).encode()
                    out.write(struct.pack("<I", len(dt)))
                    out.write(dt)
                    out.write(struct.pack("<B", v.ndim))
                    for d in v.shape:
                        out.write(struct.pack("<q", d))
                    raw = np.ascontiguousarray(v).tobytes()
                    out.write(struct.pack("<Q", len(raw)))
                    out.write(raw)
                elif t == _T_SUBCHUNK:
                    raw = v.to_bytes()
                    out.write(struct.pack("<Q", len(raw)))
                    out.write(raw)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "CKStateChunk":
        inp = io.BytesIO(data)
        assert inp.read(4) == _MAGIC, "not a CKStateChunk stream"
        (nsec,) = struct.unpack("<I", inp.read(4))
        chunk = cls()
        for _ in range(nsec):
            ident, nval = struct.unpack("<iI", inp.read(8))
            sec = []
            for _ in range(nval):
                (t,) = struct.unpack("<B", inp.read(1))
                if t in (_T_INT, _T_OBJID):
                    (v,) = struct.unpack("<q", inp.read(8))
                elif t == _T_FLOAT:
                    (v,) = struct.unpack("<d", inp.read(8))
                elif t == _T_STRING:
                    (n,) = struct.unpack("<I", inp.read(4))
                    v = inp.read(n).decode("utf-8")
                elif t == _T_ARRAY:
                    (n,) = struct.unpack("<I", inp.read(4))
                    dt = np.dtype(inp.read(n).decode())
                    (ndim,) = struct.unpack("<B", inp.read(1))
                    shape = tuple(struct.unpack("<q", inp.read(8))[0]
                                  for _ in range(ndim))
                    (rawn,) = struct.unpack("<Q", inp.read(8))
                    v = np.frombuffer(inp.read(rawn), dt).reshape(shape).copy()
                elif t == _T_SUBCHUNK:
                    (rawn,) = struct.unpack("<Q", inp.read(8))
                    v = CKStateChunk.from_bytes(inp.read(rawn))
                else:
                    raise ValueError(f"bad chunk tag {t}")
                sec.append((t, v))
            chunk._sections[ident] = sec
            chunk._order.append(ident)
        return chunk

    def Clone(self) -> "CKStateChunk":
        return CKStateChunk.from_bytes(self.to_bytes())
