"""Spark ``parse_url`` (PROTOCOL/HOST/QUERY/PATH[, key]).

Counterpart of ``spark_rapids_jni_tpu/ops/parse_uri.py``.  Reference: the
RFC-3986-ish device validator/extractor ``parse_uri.cu:94-1005``
(semantics also modeled by ``tests/uri_oracle.py``, which mirrors
java.net.URI).  The reference runs a thread-per-row two-pass kernel; here
everything is whole-column vectorized over the padded char matrix, as in
the JAX package:

* component boundaries (first ``:/#?``, authority internals, last colon /
  bracket) are masked min/max reductions and pure position arithmetic;
* per-chunk character-class validation is one vectorized pass with
  neighbor-window logic for ``%XX`` escapes and UTF-8 multi-byte
  whitespace (the reference's ``skip_and_validate_special``); its
  escape-independent masks are computed once per call and shared by the
  chunks;
* the three stateful validators (IPv4 / IPv6 / domain-name) run as one
  fused loop over the extracted host window's columns (the reference's
  ``lax.scan``), a ~20-lane vector state, about 200 small ops a column,
  as many columns as the longest host in the batch.

Outputs match Spark's null semantics: a fatally invalid URI nulls every
part; an invalid-but-tolerated host nulls only HOST (parse_uri.cu:74-79).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar.column import StringColumn
from ._util import char_window
from .json_fast import _shift_right

PROTOCOL, HOST, AUTHORITY, PATH, FRAGMENT, QUERY, USERINFO, PORT, OPAQUE = \
    range(9)
_PARTS = {"PROTOCOL": PROTOCOL, "HOST": HOST, "QUERY": QUERY, "PATH": PATH,
          "AUTHORITY": AUTHORITY, "FRAGMENT": FRAGMENT, "USERINFO": USERINFO,
          "PORT": PORT, "OPAQUE": OPAQUE}

_w = torch.where


def _first_pos(mask, pos, L):
    """First position where mask holds, else L (int32[n])."""
    return _w(mask, pos, torch.full_like(pos, L)).amin(dim=1).to(torch.int32)


def _last_pos(mask, pos):
    """Last position where mask holds, else -1."""
    return _w(mask, pos, torch.full_like(pos, -1)).amax(dim=1).to(
        torch.int32)


def _pad_right(x, k):
    return torch.cat([x, torch.zeros((x.shape[0], k), dtype=x.dtype,
                                     device=x.device)], dim=1)


def _col_at(mat, idx):
    """``mat[i, idx[i]]`` (``idx`` in range)."""
    return torch.gather(mat, 1, idx.long()[:, None])[:, 0]


def _is_alpha(c):
    return ((c >= ord("a")) & (c <= ord("z"))) | ((c >= ord("A"))
                                                  & (c <= ord("Z")))


def _is_num(c):
    return (c >= ord("0")) & (c <= ord("9"))


def _is_hexd(c):
    return _is_num(c) | ((c >= ord("a")) & (c <= ord("f"))) \
        | ((c >= ord("A")) & (c <= ord("F")))


# ---------------------------------------------------------------------------
# chunk validation: char classes + escape/UTF-8 "special" handling
# ---------------------------------------------------------------------------

def _special_parts(chars, nxt1, nxt2):
    """The escape-independent halves of the reference's
    skip_and_validate_special masks: ``(is_pct, pct_ok, near_pct, in_mb,
    mb_bad)``.  :func:`_special_masks` combines them with
    ``allow_invalid_escapes``."""
    c = chars.to(torch.int32)
    n1 = nxt1.to(torch.int32)
    n2 = nxt2.to(torch.int32)
    is_pct = c == ord("%")
    pct_ok = _is_hexd(n1) & _is_hexd(n2)
    near_pct = is_pct | _shift_right(is_pct, 1) | _shift_right(is_pct, 2)

    lead2 = (c >> 5) == 0b110
    lead3 = (c >> 4) == 0b1110
    lead4 = (c >> 3) == 0b11110
    contb = (c >> 6) == 0b10
    is_lead = lead2 | lead3 | lead4
    prev_lead2p = _shift_right(is_lead, 1)
    prev_lead34 = _shift_right(lead3 | lead4, 2)
    prev_lead4 = _shift_right(lead4, 3)
    in_mb = is_lead | ((prev_lead2p | prev_lead34 | prev_lead4) & contb)

    # packed code checks (the reference packs the char bytes big-endian)
    code2 = (c << 8) | n1
    code3 = (c << 16) | (n1 << 8) | n2
    cont_bad = (lead2 & ((n1 >> 6) != 0b10)) \
        | (lead3 & (((n1 >> 6) != 0b10) | ((n2 >> 6) != 0b10))) \
        | (lead4 & (((n1 >> 6) != 0b10) | ((n2 >> 6) != 0b10)))
    ws_bad = (lead2 & (code2 >= 0xC280) & (code2 <= 0xC2A0)) \
        | (lead3 & ((code3 == 0xE19A80)
                    | ((code3 >= 0xE28080) & (code3 <= 0xE2808A))
                    | (code3 == 0xE280AF) | (code3 == 0xE280A8)
                    | (code3 == 0xE2819F) | (code3 == 0xE38080)))
    mb_bad = is_lead & (cont_bad | ws_bad)
    return is_pct, pct_ok, near_pct, in_mb, mb_bad


def _special_masks(parts, allow_invalid_escapes):
    """Per-position exemption + validity for the reference's
    skip_and_validate_special.

    Returns (exempt, bad): ``exempt`` marks positions the per-chunk char
    predicate must NOT see (escape hex pairs, UTF-8 sequences); ``bad``
    marks positions that invalidate the whole chunk when inside it.
    ``allow_invalid_escapes`` is ``[n, 1]`` bool."""
    is_pct, pct_ok, near_pct, in_mb, mb_bad = parts
    in_escape = near_pct & ~allow_invalid_escapes
    esc_bad = is_pct & ~pct_ok & ~allow_invalid_escapes
    return in_escape | in_mb, esc_bad | mb_bad


def _chunk_valid(ok_char, chars, parts, pos, start, end,
                 allow_invalid_escapes=False):
    """Vectorized validate_chunk over the [start, end) span of each row."""
    if isinstance(allow_invalid_escapes, bool):
        allow = torch.full((chars.shape[0], 1), allow_invalid_escapes,
                           dtype=torch.bool, device=chars.device)
    else:
        allow = allow_invalid_escapes[:, None]
    exempt, bad = _special_masks(parts, allow)
    inside = (pos >= start[:, None]) & (pos < end[:, None])
    fn_bad = inside & ~exempt & ~ok_char(chars.to(torch.int32))
    return ~(inside & bad).any(dim=1) & ~fn_bad.any(dim=1)


def _scheme_ok(chars, pos, start, end):
    c = chars.to(torch.int32)
    inside = (pos >= start[:, None]) & (pos < end[:, None])
    first = pos == start[:, None]
    ok = _w(first, _is_alpha(c),
            _is_alpha(c) | _is_num(c) | (c == ord("+")) | (c == ord("-"))
            | (c == ord(".")))
    nonempty = end > start
    return nonempty & ~(inside & ~ok).any(dim=1)


def _q_ok(c):
    return ((c == ord("!")) | (c == ord('"')) | (c == ord("$"))
            | ((c >= ord("&")) & (c <= ord(";"))) | (c == ord("="))
            | ((c >= ord("?")) & (c <= ord("]")) & (c != ord("\\")))
            | ((c >= ord("a")) & (c <= ord("z"))) | (c == ord("_"))
            | (c == ord("~")))


def _auth_ok(c):
    # '%' is appended conditionally by the caller via allow_invalid_escapes
    return ((c == ord("!")) | (c == ord("$"))
            | ((c >= ord("&")) & (c <= ord(";")) & (c != ord("/")))
            | (c == ord("="))
            | ((c >= ord("@")) & (c <= ord("_")) & (c != ord("^"))
               & (c != ord("\\")))
            | ((c >= ord("a")) & (c <= ord("z"))) | (c == ord("~")))


def _path_ok(c):
    return ((c == ord("!")) | (c == ord("$"))
            | ((c >= ord("&")) & (c <= ord(";"))) | (c == ord("="))
            | ((c >= ord("@")) & (c <= ord("Z"))) | (c == ord("_"))
            | ((c >= ord("a")) & (c <= ord("z"))) | (c == ord("~")))


def _opaque_ok(c):
    return ((c == ord("!")) | (c == ord("$"))
            | ((c >= ord("&")) & (c <= ord(";"))) | (c == ord("="))
            | ((c >= ord("?")) & (c <= ord("]")) & (c != ord("\\")))
            | (c == ord("_")) | (c == ord("~"))
            | ((c >= ord("a")) & (c <= ord("z"))))


def _userinfo_ok(c):
    return (c != ord("[")) & (c != ord("]"))


# ---------------------------------------------------------------------------
# host validation (the one sequential piece: fused ipv4/ipv6/domain loop)
# ---------------------------------------------------------------------------

def _host_step(st, j, c):
    """One host-window column ``c`` (at column ``j``) of the three
    validators, for all rows."""
    c = c.to(torch.int32)
    act = j < st["len"]
    isd = _is_num(c)
    # ---- ipv6 ----
    v6 = st["v6ok"]
    colon = c == ord(":")
    period = c == ord(".")
    pct = c == ord("%")
    openb = c == ord("[")
    closeb = c == ord("]")
    dc_now = colon & (st["prev"] == ord(":"))
    v6 = v6 & ~(act & openb & (st["nopen"] >= 1))
    v6 = v6 & ~(act & closeb & (st["nclose"] >= 1))
    v6 = v6 & ~(act & closeb & (st["nper"] > 0)
                & (st["ahex"] | (st["addr"] > 255)))
    ncolon = st["ncol"] + (act & colon).to(torch.int32)
    v6 = v6 & ~(act & dc_now & st["dc"])
    dc = st["dc"] | (act & dc_now)
    v6 = v6 & ~(act & colon & ((ncolon > 8) | ((ncolon == 8) & ~dc)))
    v6 = v6 & ~(act & colon & ((st["nper"] > 0) | (st["npct"] > 0)))
    nper = st["nper"] + (act & period).to(torch.int32)
    v6 = v6 & ~(act & period & (
        (st["npct"] > 0) | (nper > 3) | st["ahex"] | (st["addr"] > 255)
        | ((st["ncol"] != 6) & ~st["dc"]) | (st["ncol"] >= 8)))
    npct = st["npct"] + (act & pct).to(torch.int32)
    v6 = v6 & ~(act & pct & (npct > 1))
    v6 = v6 & ~(act & pct & (st["nper"] > 0)
                & (st["ahex"] | (st["addr"] > 255)))
    is_af = (c >= ord("a")) & (c <= ord("f"))
    is_AZ = (c >= ord("A")) & (c <= ord("Z"))
    other6 = act & ~(colon | period | pct | openb | closeb)
    digit_like = other6 & (st["npct"] == 0)
    v6 = v6 & ~(digit_like & (st["achars"] > 3))
    v6 = v6 & ~(digit_like & ~(is_af | is_AZ | isd))
    reset = act & (colon | period | pct)
    zero = torch.zeros_like(c)
    addr = _w(reset, zero, st["addr"])
    ahex = st["ahex"] & ~reset
    achars = _w(reset, zero, st["achars"])
    addr = _w(digit_like,
              addr * 10 + _w(is_af, 10 + c - ord("a"),
                             _w(is_AZ, 10 + c - ord("A"), c - ord("0"))),
              addr)
    ahex = ahex | (digit_like & (is_af | is_AZ))
    achars = _w(digit_like, achars + 1, achars)
    # ---- ipv4 ----
    v4 = st["v4ok"]
    v4 = v4 & ~(act & ~isd & ((j == 0) | ~period))
    v4 = v4 & ~(act & period & (st["a4chars"] == 0))
    a4 = _w(act & period, zero,
            _w(act & isd, st["a4"] * 10 + c - ord("0"), st["a4"]))
    a4chars = _w(act & period, zero,
                 _w(act & isd, st["a4chars"] + 1, st["a4chars"]))
    v4 = v4 & ~(act & isd & (a4 > 255))
    ndots = st["ndots"] + (act & period).to(torch.int32)
    # ---- domain ----
    dm = st["dmok"]
    alnum = _is_alpha(c) | isd
    dash = c == ord("-")
    dm = dm & ~(act & ~(alnum | dash | period))
    numeric_start = act & st["lastper"] & isd
    dm = dm & ~(act & dash & (st["lastper"] | (j == 0)
                              | (st["len"] - 1 == j)))
    dm = dm & ~(act & period & (st["lastdash"] | st["lastper"]
                                | (st["nbefore"] == 0)))
    lastper = _w(act, period, st["lastper"])
    lastdash = _w(act, dash, st["lastdash"])
    nbefore = _w(act & period, zero,
                 _w(act & alnum, st["nbefore"] + 1, st["nbefore"]))
    numstart = _w(act, numeric_start, st["numstart"])
    prev = _w(act, c, st["prev"])
    return {
        "len": st["len"], "prev": prev,
        "v6ok": v6, "dc": dc, "ncol": ncolon, "nper": nper,
        "npct": npct, "nopen": st["nopen"] + (act & openb).to(torch.int32),
        "nclose": st["nclose"] + (act & closeb).to(torch.int32),
        "addr": addr, "ahex": ahex, "achars": achars,
        "v4ok": v4, "a4": a4, "a4chars": a4chars, "ndots": ndots,
        "dmok": dm, "lastper": lastper, "lastdash": lastdash,
        "nbefore": nbefore, "numstart": numstart,
    }


def _validate_host(chars, lengths):
    """(valid, fatal) over extracted host windows [n, H].

    Port of validate_host + validate_ipv4/ipv6/domain (parse_uri.cu:
    165-398) as one loop with all three machines running in parallel.
    """
    n, H = chars.shape
    dev = chars.device
    pos = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
    inside = pos < lengths[:, None]
    c0 = chars[:, 0].to(torch.int32)
    last = _col_at(chars, (lengths - 1).clamp(0, H - 1))
    empty = lengths <= 0
    is_br = (c0 == ord("[")) & ~empty
    br_closed = last == ord("]")

    has_brackets = (inside & ((chars == ord("[")) | (chars == ord("]")))
                    ).any(dim=1)
    last_period = _last_pos(inside & (chars == ord(".")),
                            pos.expand(n, H))
    after_lp = _col_at(chars, (last_period + 1).clamp(0, H - 1))
    # domain-name route iff no period / trailing period / non-digit after
    domain_route = (last_period < 0) | (last_period == lengths - 1) \
        | ~_is_num(after_lp.to(torch.int32))

    z = torch.zeros((n,), dtype=torch.int32, device=dev)
    f = torch.zeros((n,), dtype=torch.bool, device=dev)
    t = torch.ones((n,), dtype=torch.bool, device=dev)
    st = {
        "len": lengths.to(torch.int32), "prev": z,
        "v6ok": t, "dc": f, "ncol": z, "nper": z, "npct": z,
        "nopen": z, "nclose": z, "addr": z, "ahex": f, "achars": z,
        "v4ok": t, "a4": z, "a4chars": z, "ndots": z,
        "dmok": t, "lastper": f, "lastdash": f, "nbefore": z, "numstart": f,
    }
    chars_t = chars.t()
    for j in range(H):
        st = _host_step(st, j, chars_t[j])
    v6 = st["v6ok"] & (lengths >= 2)
    v4 = st["v4ok"] & (st["a4chars"] > 0) & (st["ndots"] == 3)
    dm = st["dmok"] & ~st["numstart"]

    fatal = is_br & (~br_closed | ~v6)
    valid_br = is_br & br_closed & v6
    fatal = fatal | (~is_br & has_brackets & ~empty)
    valid_nb = ~is_br & ~has_brackets & _w(domain_route, dm, v4)
    valid = ~empty & (valid_br | (~is_br & ~has_brackets & valid_nb))
    fatal = fatal & ~empty
    return valid, fatal


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _parse(chars, lengths, validity, part, key):
    n, L = chars.shape
    dev = chars.device
    i32 = torch.int32
    pos = torch.arange(L, dtype=i32, device=dev)[None, :].expand(n, L)
    inside = pos < lengths[:, None]
    cpad = _pad_right(chars, 2)
    nxt1 = cpad[:, 1: L + 1]
    nxt2 = cpad[:, 2: L + 2]
    c = _w(inside, chars, torch.zeros_like(chars))
    parts = _special_parts(chars, nxt1, nxt2)

    def chunk_valid(ok_char, s, e, allow=False):
        return _chunk_valid(ok_char, chars, parts, pos, s, e, allow)

    def at(idx):
        return _col_at(cpad, idx.clamp(0, L)).to(i32)

    length = lengths.to(i32)
    col = _first_pos(inside & (c == ord(":")), pos, L)
    slash = _first_pos(inside & (c == ord("/")), pos, L)
    hash_ = _first_pos(inside & (c == ord("#")), pos, L)
    question = _first_pos(inside & (c == ord("?")), pos, L)
    nope = torch.full_like(col, L)
    zeros = torch.zeros((n,), dtype=i32, device=dev)

    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    has = {k: torch.zeros((n,), dtype=torch.bool, device=dev)
           for k in range(9)}
    spans = {k: (zeros, zeros) for k in range(9)}

    # ---- fragment ------------------------------------------------------
    has_hash = hash_ < length
    frag_s, frag_e = hash_ + 1, length
    frag_ok = chunk_valid(_opaque_ok, frag_s, frag_e)
    valid = valid & (~has_hash | frag_ok)
    has[FRAGMENT] = has_hash
    spans[FRAGMENT] = (frag_s, frag_e)
    length = _w(has_hash, hash_, length)
    col = _w(col > length, nope, col)
    slash = _w(slash > length, nope, slash)
    question = _w(question > length, nope, question)

    # ---- scheme --------------------------------------------------------
    has_scheme = (col < L) & (col < slash) & (col < hash_)
    scheme_ok = _scheme_ok(chars, pos, zeros, col)
    valid = valid & (~has_scheme | scheme_ok)
    has[PROTOCOL] = has_scheme
    spans[PROTOCOL] = (zeros, col)
    start = _w(has_scheme, col + 1, zeros)

    # ---- empty remainder: only an (empty) path survives, scheme dies ---
    empty_rest = length - start <= 0
    valid = valid & (~empty_rest | ~has_scheme)
    only_path = empty_rest & ~has_scheme
    # the reference OVERWRITES valid here (:608-614): an empty remainder
    # keeps only the empty path — the fragment bit is lost too
    has[FRAGMENT] = has[FRAGMENT] & ~empty_rest

    # ---- hierarchical vs opaque ----------------------------------------
    first_c = at(start)
    hier = ~empty_rest & ((first_c == ord("/")) | (start == 0))
    opaque = ~empty_rest & ~hier
    op_ok = chunk_valid(_opaque_ok, start, length)
    valid = valid & (~opaque | op_ok)
    has[OPAQUE] = opaque
    spans[OPAQUE] = (start, length)

    # ---- query ----------------------------------------------------------
    has_q = hier & (question < length) & (question >= start)
    q_s, q_e = question + 1, length
    q_ok = chunk_valid(_q_ok, q_s, q_e)
    valid = valid & (~has_q | q_ok)
    has[QUERY] = has_q
    spans[QUERY] = (q_s, q_e)
    path_end = _w(has_q, question, length)

    # ---- authority // --------------------------------------------------
    second_c = at(start + 1)
    has_auth = hier & (first_c == ord("/")) & (second_c == ord("/")) \
        & (start + 1 < length)
    auth_s = start + 2
    next_slash = _first_pos(inside & (c == ord("/"))
                            & (pos >= auth_s[:, None])
                            & (pos < path_end[:, None]), pos, L)
    have_ns = has_auth & (next_slash < path_end)
    auth_e = _w(have_ns, next_slash, torch.minimum(path_end, length))
    auth_nonempty = has_auth & (auth_e > auth_s)
    # ipv6-style authorities tolerate bare % (device routing suffix)
    a_first = at(auth_s)
    ipv6_auth = auth_nonempty & (auth_e - auth_s > 2) & (a_first == ord("["))
    auth_ok = chunk_valid(
        lambda ch: _auth_ok(ch) | (ipv6_auth[:, None] & (ch == ord("%"))),
        auth_s, auth_e, ipv6_auth)
    valid = valid & (~auth_nonempty | auth_ok)
    has[AUTHORITY] = auth_nonempty
    spans[AUTHORITY] = (auth_s, auth_e)

    # path: from next_slash (if any) else empty
    path_s = _w(has_auth, _w(have_ns, next_slash, length), start)
    path_e = _w(has_auth, _w(have_ns, path_end, length), path_end)
    path_s = _w(only_path, zeros, path_s)
    path_e = _w(only_path, zeros, path_e)
    has_path = hier | only_path
    p_ok = chunk_valid(_path_ok, path_s, path_e)
    valid = valid & (~has_path | p_ok)
    has[PATH] = has_path
    spans[PATH] = (path_s, path_e)

    # ---- userinfo / host / port inside the authority --------------------
    in_auth = inside & (pos >= auth_s[:, None]) & (pos < auth_e[:, None])
    amp = _first_pos(in_auth & (c == ord("@")), pos, L)
    has_amp = auth_nonempty & (amp < auth_e) & (amp > auth_s)
    ui_s, ui_e = auth_s, amp
    ui_ok = chunk_valid(_userinfo_ok, ui_s, ui_e)
    valid = valid & (~has_amp | ui_ok)
    has[USERINFO] = has_amp
    spans[USERINFO] = (ui_s, ui_e)
    host_s = _w(has_amp, amp + 1, auth_s)
    # last ':' and ']' at positions after userinfo
    in_host_zone = inside & (pos >= host_s[:, None]) \
        & (pos < auth_e[:, None])
    last_colon = _last_pos(in_host_zone & (c == ord(":")), pos)
    last_brk = _last_pos(in_host_zone & (c == ord("]")), pos)
    # the reference computes last_colon relative (i or i-amp-1) and tests
    # last_colon > 0: a colon at relative 0 does NOT make a port
    rel0 = last_colon == host_s
    has_port = auth_nonempty & (last_colon >= 0) & ~rel0 \
        & ((last_brk < 0) | (last_colon > last_brk))
    port_s, port_e = last_colon + 1, auth_e
    # (reference validate_port accepts any char — a preserved quirk)
    has[PORT] = has_port
    spans[PORT] = (port_s, port_e)
    host_e = _w(has_port, last_colon, auth_e)
    # extract the host window and validate it: the reference's window
    # is min(L, 256) wide; columns past the longest host change no
    # validator state, so the window stops there (one host read)
    hlen = (host_e - host_s).clamp(0, min(L, 256))
    H = max(1, int(hlen.max()) if n else 1)
    hwin = char_window(chars, host_s, hlen, H)
    host_valid, host_fatal = _validate_host(hwin, hlen)
    valid = valid & (~auth_nonempty | ~host_fatal)
    has[HOST] = auth_nonempty & host_valid
    spans[HOST] = (host_s, host_e)

    # ---- select the requested part --------------------------------------
    part_id = _PARTS[part]
    out_has = has[part_id] & valid & validity
    s, e = spans[part_id]

    if part_id == QUERY and key is not None:
        kb = key.encode()
        klen = len(kb)
        q_s_, q_e_ = spans[QUERY]
        in_q = inside & (pos >= q_s_[:, None]) & (pos < q_e_[:, None])
        # match at param starts: q_s or after '&'; needle then '='
        prev_chars = _shift_right(chars, 1)
        at_start = (pos == q_s_[:, None]) | (in_q & (prev_chars == ord("&")))
        match = torch.ones((n, L), dtype=torch.bool, device=dev)
        cp2 = _pad_right(chars, klen + 1)
        for k in range(klen):
            match = match & (cp2[:, k: L + k] == kb[k])
        match = match & (cp2[:, klen: L + klen] == ord("="))
        # reference stops the search once p + klen >= q_e
        match = match & at_start & ((pos + klen) < q_e_[:, None])
        mpos = _first_pos(match, pos, L)
        found = out_has & (mpos < L)
        v_s = mpos + klen + 1
        after_amp = _first_pos(
            inside & (c == ord("&")) & (pos >= v_s[:, None])
            & (pos < q_e_[:, None]), pos, L)
        v_e = torch.minimum(after_amp, q_e_)
        out_has = found
        s, e = v_s, v_e

    out_len = (e - s).clamp(0, L)
    out = char_window(chars, s, out_len, L)
    return out, _w(out_has, out_len, torch.zeros_like(out_len)), out_has


def parse_uri(col: StringColumn, part: str,
              key: Optional[str] = None) -> StringColumn:
    """Extract one URI component per row; invalid rows -> null.

    ``part`` is one of PROTOCOL/HOST/QUERY/PATH (plus the internal
    AUTHORITY/FRAGMENT/USERINFO/PORT/OPAQUE chunks); ``key`` filters the
    query to one parameter's value (Spark ``parse_url(url, 'QUERY', k)``).
    """
    part = part.upper()
    if part not in _PARTS:
        raise ValueError(f"unknown URI part {part!r}")
    if key is not None and part != "QUERY":
        raise ValueError("key filter is only valid with QUERY")
    from ..columnar.bucketed import BucketedStringColumn

    if isinstance(col, BucketedStringColumn):
        # per-bucket: each bucket's validator loop runs at ITS width
        return col.apply(lambda b: parse_uri(b, part, key))
    out, lens, has = _parse(col.chars, col.lengths, col.validity, part, key)
    return StringColumn(out, lens, has)


def parse_uri_query_with_column(col: StringColumn,
                                keys: StringColumn) -> StringColumn:
    """Per-row query-parameter extraction (reference ParseURI.java:82
    parseURIQueryWithColumn over parse_uri.cu's column-key kernel).

    Two stages: the shared validator/extractor pulls each row's QUERY
    span, then a vectorized matcher finds ``key=`` at parameter starts
    (query start or after ``&``) with the key length varying per row.
    Null keys or invalid URIs produce null rows.
    """
    if keys.num_rows != col.num_rows:
        raise ValueError("key column must match the URI column's row count")
    q = parse_uri(col, "QUERY")
    qc, ql, qv = q.chars, q.lengths, q.validity
    kc, kl, kv = keys.chars, keys.lengths, keys.validity
    n, L = qc.shape
    KL = kc.shape[1]
    i32 = torch.int32
    pos = torch.arange(L, dtype=i32, device=qc.device)[None, :].expand(n, L)
    in_q = pos < ql[:, None]

    prev = _shift_right(qc, 1)
    at_start = in_q & ((pos == 0) | (prev == ord("&")))

    qp = _pad_right(qc, KL + 1)
    match = torch.ones((n, L), dtype=torch.bool, device=qc.device)
    for j in range(KL):
        active = (j < kl)[:, None]
        match = match & (~active | (qp[:, j: L + j] == kc[:, j][:, None]))
    # '=' must follow the (per-row-length) key
    eq_idx = (pos + kl[:, None]).clamp(0, L + KL)
    eq_char = torch.gather(qp, 1, eq_idx.long())
    match = match & (eq_char == ord("="))
    match = match & at_start & ((pos + kl[:, None]) < ql[:, None])

    mpos = _first_pos(match, pos, L)
    found = qv & kv & (mpos < L)
    v_s = mpos + kl + 1
    amp = _first_pos((qc == ord("&")) & (pos >= v_s[:, None]) & in_q,
                     pos, L)
    v_e = torch.minimum(amp, ql)

    out_len = (v_e - v_s).clamp(0, L)
    out = char_window(qc, v_s, out_len, L)
    return StringColumn(out, _w(found, out_len, torch.zeros_like(out_len)),
                        found)
