"""The Unicode Bidirectional Algorithm as fribidi 1.0.8 runs it for Raqm
(``fribidi_get_par_embedding_levels_ex`` with bracket types), on one line.

Pillow splits text at ``\\n`` and hands each line to Raqm, which asks
fribidi for the line's embedding levels with the paragraph direction left
to auto (P2-P3). fribidi applies X1-X10 (embeddings, overrides and
isolates, the explicit codes and BN removed by X9), W1-W7, N0 (bracket
pairs, with fribidi's bracket ids), N1-N2, I1-I2, and the first part of
L1 (separators, and whitespace and isolates before them or at the line's
end); a character X9 removed then takes the level of the character before
it (the paragraph level at the start). Raqm resets trailing whitespace,
BN and explicit codes to the paragraph level once more
(:func:`line_levels`).

Where fribidi 1.0.8 departs from the letter of UAX #9 this module
follows fribidi, as found by running both on generated strings:

- an FSI's direction comes from the first strong character after it at
  depth 0, the depth counted on past its PDI (:func:`_fsi_rtl`);
- W1 merges a run of NSMs into the run before it and, where the run after
  has the same type, that run too: an ON right after "ON NSM" is part of
  the first ON's run, so a bracket there pairs with nothing and takes the
  type N0 gives the run it joined (:func:`_brackets`);
- N0 looks back for a bracket pair's context over every earlier character
  of the same isolate depth, across level runs, and takes the embedding
  direction where it finds no strong type (not sos).

Two isolates in one line are not held to fribidi (it carries the last
strong type from one isolate to the next at the same depth); the shaper
refuses such a line.
"""

from __future__ import annotations

from .ucd import BRACKETS, bidi_class

MAX_DEPTH = 125
MAX_BRACKETS = 63
_STRONG = ("L", "R", "AL")
_ISOLATE_INIT = ("LRI", "RLI", "FSI")
_EMBED = ("LRE", "RLE", "LRO", "RLO")
_REMOVED = ("LRE", "RLE", "LRO", "RLO", "PDF", "BN")
_NI = ("B", "S", "WS", "ON", "LRI", "RLI", "FSI", "PDI")


def _first_strong(types, start, end) -> int | None:
    """P2-P3: 0 or 1 from the first strong character in [start, end),
    skipping isolated text, or None."""
    depth = 0
    for i in range(start, end):
        t = types[i]
        if t in _ISOLATE_INIT:
            depth += 1
        elif t == "PDI":
            if depth:
                depth -= 1
        elif t == "B":
            break
        elif depth == 0 and t in _STRONG:
            return 0 if t == "L" else 1
    return None


def _fsi_rtl(types, i) -> bool:
    """fribidi 1.0.8's direction of the FSI at ``i``: the first strong
    character after it at isolate depth 0, the depth counted from the FSI
    on without stopping at its PDI (so text past the PDI, inside a later
    isolate, decides where the FSI's own text has no strong character)."""
    depth = 0
    for j in range(i + 1, len(types)):
        t = types[j]
        if t == "PDI":
            depth -= 1
        elif t in _ISOLATE_INIT:
            depth += 1
        elif depth == 0 and t in _STRONG:
            return t != "L"
    return False


def _matching_pdi(types, i) -> int:
    """The index of the PDI matching the isolate initiator at ``i``, or
    len(types)."""
    depth = 1
    for j in range(i + 1, len(types)):
        t = types[j]
        if t in _ISOLATE_INIT:
            depth += 1
        elif t == "PDI":
            depth -= 1
            if depth == 0:
                return j
        elif t == "B":
            break
    return len(types)


def paragraph_levels(text: str) -> tuple[list[int], int]:
    """fribidi's embedding level of each character of ``text`` (one line)
    and the paragraph level."""
    n = len(text)
    orig = [bidi_class(ch) for ch in text]
    types = list(orig)
    base = _first_strong(types, 0, n) or 0
    levels = [base] * n

    # X1-X8.
    stack = [(base, None, False)]
    over_iso = over_emb = valid_iso = 0
    depth = [0] * n
    for i, t in enumerate(orig):
        depth[i] = valid_iso
        if t in _EMBED:
            rtl = t[0] == "R"
            lvl = stack[-1][0]
            new = (lvl + 1) | 1 if rtl else (lvl + 2) & ~1
            if new <= MAX_DEPTH and not over_iso and not over_emb:
                stack.append((new, None if t[2] == "E" else t[0], False))
            elif not over_iso:
                over_emb += 1
            levels[i] = stack[-1][0]
        elif t in _ISOLATE_INIT:
            lvl, override, _iso = stack[-1]
            levels[i] = lvl
            if override:
                types[i] = override
            if t == "FSI":
                rtl = _fsi_rtl(orig, i)
            else:
                rtl = t == "RLI"
            new = (lvl + 1) | 1 if rtl else (lvl + 2) & ~1
            if new <= MAX_DEPTH and not over_iso and not over_emb:
                valid_iso += 1
                stack.append((new, None, True))
            else:
                over_iso += 1
        elif t == "PDI":
            if over_iso:
                over_iso -= 1
            elif valid_iso:
                over_emb = 0
                while not stack[-1][2]:
                    stack.pop()
                stack.pop()
                valid_iso -= 1
                depth[i] = valid_iso
            lvl, override, _iso = stack[-1]
            levels[i] = lvl
            if override:
                types[i] = override
        elif t == "PDF":
            if over_iso:
                pass
            elif over_emb:
                over_emb -= 1
            elif not stack[-1][2] and len(stack) >= 2:
                stack.pop()
            levels[i] = stack[-1][0]
        elif t == "B":
            levels[i] = base
            stack = [(base, None, False)]
            over_iso = over_emb = valid_iso = 0
        elif t == "BN":
            levels[i] = stack[-1][0]
        else:
            lvl, override, _iso = stack[-1]
            levels[i] = lvl
            if override:
                types[i] = override

    # X9-X10: level runs of the characters X9 keeps, chained into
    # isolating run sequences.
    kept = [i for i in range(n) if orig[i] not in _REMOVED]
    runs = []
    for i in kept:
        if runs and levels[runs[-1][-1]] == levels[i]:
            runs[-1].append(i)
        else:
            runs.append([i])
    seqs = _chain(runs, orig, n)
    pos_in_kept = {i: k for k, i in enumerate(kept)}
    emb = list(levels)
    res = list(types)
    weak = []
    for seq in seqs:
        sos, eos, t_w1, t = _weak(seq, types, emb, base, kept, pos_in_kept,
                                  orig)
        for i, x in zip(seq, t):
            res[i] = x
        weak.append((sos, eos, t_w1))
    for seq, (_sos, _eos, t_w1) in zip(seqs, weak):
        _brackets(seq, types, res, t_w1, emb[seq[0]], depth, kept,
                  pos_in_kept, text)
    for seq, (sos, eos, _t) in zip(seqs, weak):
        _neutral_implicit(seq, res, emb[seq[0]], sos, eos, levels)

    # Characters removed by X9 take the level before them.
    for j in range(n):
        if orig[j] in _REMOVED:
            levels[j] = levels[j - 1] if j else base
    # L1, first part (fribidi): separators, and whitespace, isolates, BN
    # and explicit codes before a separator or at the end.
    state = True
    for j in range(n - 1, -1, -1):
        t = orig[j]
        if t in ("B", "S"):
            levels[j] = base
            state = True
        elif state and (t in ("WS", "BN") or t in _REMOVED
                        or t in _ISOLATE_INIT or t == "PDI"):
            levels[j] = base
        else:
            state = False
    return levels, base


def _chain(runs, orig, n):
    """BD13: level runs chained through matching isolate initiators and
    PDIs into isolating run sequences, in order of their first run."""
    seqs = []
    owner = {}
    for r in runs:
        first = r[0]
        if orig[first] == "PDI" and first in owner:
            seq = owner.pop(first)
            seq.extend(r)
        else:
            seq = list(r)
            seqs.append(seq)
        last = r[-1]
        if orig[last] in _ISOLATE_INIT:
            m = _matching_pdi(orig, last)
            if m < n:
                owner[m] = seq
    return seqs


def _weak(seq, types, emb, base, kept, pos_in_kept, orig):
    """sos, eos and W1-W7 over one isolating run sequence: (sos, eos, the
    types after W1, the types after W7)."""
    lvl = emb[seq[0]]
    k0 = pos_in_kept[seq[0]]
    prev_lvl = emb[kept[k0 - 1]] if k0 > 0 else base
    last = seq[-1]
    k1 = pos_in_kept[last]
    if orig[last] in _ISOLATE_INIT or k1 + 1 == len(kept):
        next_lvl = base
    else:
        next_lvl = emb[kept[k1 + 1]]
    sos = "R" if max(prev_lvl, lvl) & 1 else "L"
    eos = "R" if max(next_lvl, lvl) & 1 else "L"
    t = [types[i] for i in seq]
    m = len(t)
    # W1.
    prev = sos
    for k in range(m):
        if t[k] == "NSM":
            t[k] = "ON" if prev in _ISOLATE_INIT or prev == "PDI" else prev
        prev = t[k]
    t_w1 = list(t)
    # W2.
    last_strong = sos
    for k in range(m):
        if t[k] in _STRONG:
            last_strong = t[k]
        elif t[k] == "EN" and last_strong == "AL":
            t[k] = "AN"
    # W3.
    for k in range(m):
        if t[k] == "AL":
            t[k] = "R"
    # W4.
    for k in range(1, m - 1):
        if t[k] == "ES" and t[k - 1] == "EN" and t[k + 1] == "EN":
            t[k] = "EN"
        elif t[k] == "CS" and t[k - 1] == t[k + 1] and t[k - 1] in (
                "EN", "AN"):
            t[k] = t[k - 1]
    # W5.
    k = 0
    while k < m:
        if t[k] == "ET":
            e = k
            while e < m and t[e] == "ET":
                e += 1
            if (k > 0 and t[k - 1] == "EN") or (e < m and t[e] == "EN"):
                for j in range(k, e):
                    t[j] = "EN"
            k = e
        else:
            k += 1
    # W6.
    for k in range(m):
        if t[k] in ("ES", "ET", "CS"):
            t[k] = "ON"
    # W7.
    last_strong = sos
    for k in range(m):
        if t[k] in ("L", "R"):
            last_strong = t[k]
        elif t[k] == "EN" and last_strong == "L":
            t[k] = "L"
    return sos, eos, t_w1, t


def _strong(x):
    """L, R (R, EN and AN) or None."""
    return "R" if x in ("R", "EN", "AN") else ("L" if x == "L" else None)


def _brackets(seq, types, res, t_w1, lvl, depth, kept, pos_in_kept, text):
    """N0 over one isolating run sequence, on the resolved types ``res``
    of every kept character."""
    m = len(seq)
    e_dir = "R" if lvl & 1 else "L"
    pairs = []
    stack = []
    for k in range(m):
        i = seq[k]
        br = BRACKETS.get(ord(text[i]))
        if br is None or res[i] != "ON" or types[i] != "ON":
            continue
        # fribidi's W1 merges NSMs into the run before them, and the run
        # after them too where its type is the same: a bracket right
        # after "ON NSM" joins the run of the ON and is a bracket no more.
        j = k - 1
        while j >= 0 and types[seq[j]] == "NSM":
            j -= 1
        if 0 <= j < k - 1 and t_w1[j] == "ON":
            continue
        bid, is_open = br
        if is_open:
            if len(stack) == MAX_BRACKETS:
                break
            stack.append((bid, k))
        else:
            for s in range(len(stack) - 1, -1, -1):
                if stack[s][0] == bid:
                    pairs.append((stack[s][1], k))
                    del stack[s:]
                    break
    pairs.sort()
    for o, c in pairs:
        found_e = found_o = False
        for k in range(o + 1, c):
            s = _strong(res[seq[k]])
            if s == e_dir:
                found_e = True
                break
            if s is not None:
                found_o = True
        if found_e:
            new = e_dir
        elif found_o:
            # fribidi looks back for the context over every earlier
            # character of the same isolate depth, past the level run's
            # start, and takes the embedding direction where none is
            # strong.
            io = seq[o]
            ctx = e_dir
            for kk in range(pos_in_kept[io] - 1, -1, -1):
                i = kept[kk]
                s = _strong(res[i])
                if s is not None and depth[i] == depth[io]:
                    ctx = s
                    break
            new = ctx
        else:
            continue
        for b in (o, c):
            # The bracket's run in fribidi: itself, the NSMs after it and
            # an ON that W1 merged in after them, and so on.
            res[seq[b]] = new
            j = b + 1
            while j < m and types[seq[j]] == "NSM":
                while j < m and types[seq[j]] == "NSM":
                    res[seq[j]] = new
                    j += 1
                if j < m and types[seq[j]] == "ON":
                    res[seq[j]] = new
                    j += 1


def _neutral_implicit(seq, res, lvl, sos, eos, levels):
    """N1-N2 and I1-I2 over one isolating run sequence."""
    t = [res[i] for i in seq]
    m = len(t)
    e_dir = "R" if lvl & 1 else "L"
    k = 0
    while k < m:
        if t[k] in _NI:
            e = k
            while e < m and t[e] in _NI:
                e += 1
            before = _strong(t[k - 1]) if k > 0 else sos
            after = _strong(t[e]) if e < m else eos
            new = before if before == after else e_dir
            for j in range(k, e):
                t[j] = new
            k = e
        else:
            k += 1
    for k in range(m):
        i = seq[k]
        x = t[k]
        if lvl & 1:
            if x in ("L", "EN", "AN"):
                levels[i] = lvl + 1
        elif x == "R":
            levels[i] = lvl + 1
        elif x in ("AN", "EN"):
            levels[i] = lvl + 2


def line_levels(text: str) -> tuple[list[int], int]:
    """The levels Raqm runs by: :func:`paragraph_levels` with its own
    reset of trailing whitespace, BN and explicit codes (``L1``, part 4,
    in ``_raqm_reorder_runs``)."""
    levels, base = paragraph_levels(text)
    for j in range(len(text) - 1, -1, -1):
        if bidi_class(text[j]) in ("WS", "BN", "LRE", "RLE", "LRO", "RLO",
                                   "PDF"):
            levels[j] = base
        else:
            break
    return levels, base
