"""The port's CKStateChunk against the reference package's, on the CPU.

- Every value tag round-trips through the port's ``to_bytes`` /
  ``from_bytes``: ints, dwords, floats, strings, arrays of every dtype
  the serializer writes, object ids, matrices, vectors and sub-chunks.
- The same writes, made from a numpy seed, give the same bytes in both
  packages (exactly: the format is the contract between scene files), and
  each package reads the other's bytes back to the same values.
- ``RemapObjectIDs`` with and without ``keep_unmapped``, nested in
  sub-chunks, and ``Clone`` give the same bytes in both packages.
"""

import numpy as np
import pytest

from ckrenderengine_tpu.io.statechunk import CKStateChunk as JChunk
from ckrenderengine_tpu_torch.io.statechunk import CKStateChunk as TChunk

DTYPES = (np.float32, np.int32, np.uint8, np.uint32, np.float64, np.int64,
          np.uint16, np.bool_)


def _write(C, seed: int):
    """A chunk of class ``C`` written by a seeded script: three sections
    (one written to twice), every tag, arrays of every dtype in DTYPES at
    seeded shapes (empty ones too), and a sub-chunk holding ids and a
    second sub-chunk. Returns the chunk."""
    rng = np.random.default_rng(seed)
    ch = C()
    ch.WriteIdentifier(0x1001)
    ch.WriteInt(int(rng.integers(-2**40, 2**40)))
    ch.WriteDword(-1)
    ch.WriteFloat(float(rng.standard_normal()))
    ch.WriteString("ballance éè " + str(seed))
    ch.WriteString(None)
    for dt in DTYPES:
        shape = tuple(int(n) for n in rng.integers(0, 5, rng.integers(1, 4)))
        a = (rng.standard_normal(shape) * 100).astype(dt)
        ch.WriteArray(a)
    ch.WriteMatrix(rng.standard_normal((4, 4)))
    ch.WriteVector(rng.standard_normal(3))
    ch.WriteObjectID(int(rng.integers(1, 50)))
    ch.WriteObjectID(0)
    ch.WriteIdentifier(-7)
    sub = C()
    sub.WriteIdentifier(0x100C)
    sub.WriteObjectID(int(rng.integers(1, 50)))
    sub.WriteInt(3)
    inner = C()
    inner.WriteIdentifier(2)
    inner.WriteObjectID(int(rng.integers(1, 50)))
    sub.WriteSubChunk(inner)
    ch.WriteSubChunk(sub)
    ch.WriteObjectID(int(rng.integers(1, 50)))
    ch.WriteIdentifier(0x1001)          # a section written to again
    ch.WriteArray(np.zeros((0, 3), np.float32))
    ch.WriteInt(0)
    return ch


def _values(ch):
    """Every value of a chunk, sub-chunks expanded, in section order."""
    out = []
    for ident in ch._order:
        for t, v in ch._sections[ident]:
            if t == 6:
                out.append(("sub", _values(v)))
            elif isinstance(v, np.ndarray):
                out.append((t, v.dtype.str, v.shape, v.tobytes()))
            else:
                out.append((t, v))
        out.append(("section", ident))
    return out


def test_every_tag_round_trips():
    ch = TChunk()
    ch.WriteIdentifier(42)
    ch.WriteInt(-7)
    ch.WriteDword(-1)
    ch.WriteFloat(3.5)
    ch.WriteString("héllo")
    arrays = [(np.arange(12) % 3).astype(dt).reshape(3, 4) for dt in DTYPES]
    for a in arrays:
        ch.WriteArray(a)
    ch.WriteObjectID(99)
    ch.WriteIdentifier(43)
    ch.WriteMatrix(np.eye(4) * 2)
    ch.WriteVector((1.0, 2.0, 3.0, 4.0))
    sub = TChunk()
    sub.WriteIdentifier(7)
    sub.WriteFloat(-0.25)
    ch.WriteSubChunk(sub)

    back = TChunk.from_bytes(ch.to_bytes())
    assert back.HasIdentifier(42) and back.HasIdentifier(43)
    assert not back.SeekIdentifier(12345) and not back.HasIdentifier(44)
    assert back.SeekIdentifier(42)
    assert back.ReadInt() == -7
    assert back.ReadDword() == 0xFFFFFFFF
    assert back.ReadFloat() == 3.5
    assert back.ReadString() == "héllo"
    for a in arrays:
        got = back.ReadBuffer()
        assert got.dtype == a.dtype and np.array_equal(got, a)
    assert back.ReadObjectID() == 99
    assert back.SeekIdentifier(43)
    m = back.ReadMatrix()
    assert m.dtype == np.float32 and np.array_equal(m, np.eye(4) * 2)
    assert np.array_equal(back.ReadVector(), [1, 2, 3, 4])
    s = back.ReadSubChunk()
    assert s.SeekIdentifier(7) and s.ReadFloat() == -0.25
    # A read of the wrong type fails.
    assert back.SeekIdentifier(42)
    with pytest.raises(AssertionError, match="type mismatch"):
        back.ReadFloat()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bytes_equal_the_reference_and_read_across(seed):
    t, j = _write(TChunk, seed), _write(JChunk, seed)
    raw = t.to_bytes()
    assert raw == j.to_bytes()
    assert raw[:4] == b"CKC1"
    # Each package reads the other's bytes to the same values.
    assert _values(TChunk.from_bytes(j.to_bytes())) == _values(j)
    assert _values(JChunk.from_bytes(raw)) == _values(t)
    assert TChunk.from_bytes(raw).to_bytes() == raw


@pytest.mark.parametrize("keep_unmapped", [False, True])
def test_remap_object_ids_matches_the_reference(keep_unmapped):
    rng = np.random.default_rng(11)
    t, j = _write(TChunk, 5), _write(JChunk, 5)
    ids = sorted({v for _t, v in t._sections[0x1001] if _t == 5} | {1, 2})
    mapping = {int(i): int(i) + 100 for i in ids if rng.random() < 0.5}
    mapping.setdefault(ids[0], 500)
    for ch in (t, j):
        ch.RemapObjectIDs(mapping, keep_unmapped=keep_unmapped)
    assert t.to_bytes() == j.to_bytes()
    got = [v for _t, v in t._sections[0x1001] if _t == 5]
    sub = [v for _t, v in t._sections[-7] if _t == 6][0]
    inner = [v for _t, v in sub._sections[0x100C] if _t == 6][0]
    got += [v for _t, v in sub._sections[0x100C] if _t == 5]
    got += [v for _t, v in inner._sections[2] if _t == 5]
    for v in got:
        assert v == 0 or v in mapping.values() or (keep_unmapped
                                                   and v not in mapping)
    if not keep_unmapped:
        # Unmapped ids become null references, never aliases.
        assert all(v == 0 or v in mapping.values() for v in got)
    assert t.Clone().to_bytes() == j.Clone().to_bytes() == t.to_bytes()
