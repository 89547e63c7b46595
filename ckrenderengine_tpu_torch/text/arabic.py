"""HarfBuzz's Arabic shaper (hb-ot-shaper-arabic.cc) as far as the faces
the port draws need it: the joining state machine that gives each
character its form feature, and the reordering of modifier combining
marks in the normaliser.

The forms are applied by :mod:`shaping` as HarfBuzz plans them, one GSUB
stage each (``FORMS``), on the glyphs whose mask carries the form. The
fallback shaping from presentation forms (a face without Arabic forms in
GSUB) and ``stch`` are not ported.
"""

from __future__ import annotations

from .ucd import ARABIC_MCM, joining_type

# The form features in plan order, and the action of a character that
# takes none.
FORMS = ("isol", "fina", "fin2", "fin3", "medi", "med2", "init")
ISOL, FINA, FIN2, FIN3, MEDI, MED2, INIT, NONE = range(8)

# Columns of the state table by joining type (C joins as D).
_COLUMN = {"U": 0, "L": 1, "R": 2, "D": 3, "C": 3}

# (action for the previous character, action for this one, next state) by
# state and column: HarfBuzz's arabic_state_table without the Syriac
# ALAPH and DALATH RISH columns, which no character here has.
_STATE = (
    ((NONE, NONE, 0), (NONE, ISOL, 2), (NONE, ISOL, 1), (NONE, ISOL, 2)),
    ((NONE, NONE, 0), (NONE, ISOL, 2), (NONE, ISOL, 1), (NONE, ISOL, 2)),
    ((NONE, NONE, 0), (NONE, ISOL, 2), (INIT, FINA, 1), (INIT, FINA, 3)),
    ((NONE, NONE, 0), (NONE, ISOL, 2), (MEDI, FINA, 1), (MEDI, FINA, 3)),
    ((NONE, NONE, 0), (NONE, ISOL, 2), (MED2, ISOL, 1), (MED2, ISOL, 2)),
    ((NONE, NONE, 0), (NONE, ISOL, 2), (ISOL, ISOL, 1), (ISOL, ISOL, 2)),
    ((NONE, NONE, 0), (NONE, ISOL, 2), (NONE, ISOL, 1), (NONE, ISOL, 2)),
)


def joining(chars: list[str], before: str, after: str) -> list[int]:
    """The action (an index into FORMS, or NONE) of each character of the
    run ``chars``, with up to five characters of context ``before`` it
    (nearest first) and ``after`` it (HarfBuzz's arabic_joining)."""
    actions = [NONE] * len(chars)
    prev = None
    state = 0
    for ch in before:
        t = joining_type(ch)
        if t == "T":
            continue
        state = _STATE[state][_COLUMN[t]][2]
        break
    for i, ch in enumerate(chars):
        t = joining_type(ch)
        if t == "T":
            continue
        prev_action, action, nxt = _STATE[state][_COLUMN[t]]
        if prev_action != NONE and prev is not None:
            actions[prev] = prev_action
        actions[i] = action
        prev = i
        state = nxt
    for ch in after:
        t = joining_type(ch)
        if t == "T":
            continue
        prev_action = _STATE[state][_COLUMN[t]][0]
        if prev_action != NONE and prev is not None:
            actions[prev] = prev_action
        break
    return actions


def reorder_marks(buf: list, start: int, end: int):
    """HarfBuzz's reorder_marks_arabic on the sorted marks buf[start:end]:
    modifier combining marks of class 220, then of class 230, move to the
    front, renumbered 25 and 26 so the run stays sorted."""
    i = start
    for cc in (220, 230):
        while i < end and buf[i].mcc < cc:
            i += 1
        if i == end:
            break
        if buf[i].mcc > cc:
            continue
        j = i
        while j < end and buf[j].mcc == cc and ord(buf[j].char) in ARABIC_MCM:
            j += 1
        if i == j:
            continue
        moved = buf[i:j]
        buf[start + j - i:j] = buf[start:i]
        buf[start:start + j - i] = moved
        new_start = start + j - i
        for k in range(start, new_start):
            buf[k].mcc = 25 if cc == 220 else 26
        start = new_start
        i = j
