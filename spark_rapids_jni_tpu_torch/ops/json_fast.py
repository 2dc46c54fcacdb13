"""Bit-parallel fast path for ``get_json_object`` (clean-document subset).

Counterpart of ``spark_rapids_jni_tpu/ops/json_fast.py``.  The general
engine (:mod:`.get_json_object`) walks the char columns one at a time;
this module re-expresses the common case as about 60 data-parallel
passes over the ``[n, L]`` char matrix (the simdjson stage-1 idea):
quote-parity prefix sums for the in-string mask, masked cumulative sums
for nesting depth, forward fills (running maxima) for grammar anchors,
and an unrolled walk over the JSONPath.

Reference semantics: ``json_parser.cuh`` (tokenizer) and
``get_json_object.cu:360-788`` (path evaluator), as modeled by
``tests/json_oracle.py``.

**Accept-list contract.**  The fast path only keeps rows it can prove it
handles exactly; everything else raises the per-row ``fallback`` flag and
the caller routes those rows through the scan machine.  A row falls back
when any of these hold:

* a backslash anywhere in the document (escapes, and the reference's
  ``\\uXXXX`` field-name-never-matches quirk, stay on the scan machine);
* a single-quote character anywhere (the two-quote-type automaton is not
  a parity sum);
* nesting depth > 16 (the owner-bracket forward-fill is per-depth);
* any local grammar check fails (the scan machine decides NULL);
* the matched value needs non-trivial rewriting: a float-containing or
  ``-0``-containing container copy, or control chars inside a container
  copy.  (Scalar float targets go through the scan machine's own
  ``_format_floats``.)

Two branches of the reference (``lax.cond``) are Python branches here,
each on one host read: the container compaction runs only when a live
row has a container target, the float formatter only when one has a
float target.  :data:`HOST_SYNCS` counts those reads.

Wildcard paths never enter the fast path (routing in
``get_json_object``).
"""

from __future__ import annotations

import torch

from . import float_to_string
from ._util import row_cummax, row_cumsum

MAX_FF_DEPTH = 16   # owner forward-fill depth budget; deeper rows fall back

# host reads the two branches made (a plain counter, reset by callers)
HOST_SYNCS = {"fast_path": 0}

# anchor kinds (token-level grammar elements)
A_NONE = 0
A_OBRACE = 1    # {
A_CBRACE = 2    # }
A_OBRK = 3      # [
A_CBRK = 4      # ]
A_COMMA = 5
A_COLON = 6
A_OPENQ = 7     # opening quote of a string
A_CLOSEQ = 8    # closing quote of a value string
A_FCLOSEQ = 9   # closing quote of a field-name string
A_VEND = 10     # last char of a number/literal run
A_START = 11    # virtual "before document" anchor


def _ffill_max(x):
    """Running maximum along the chars (forward fill of the latest index)."""
    return row_cummax(x)


def _first_true(mask, L):
    """Index of first True per row, L if none.  mask: bool [n, L]."""
    pos = torch.arange(L, dtype=torch.int32, device=mask.device)
    return torch.where(mask, pos[None, :], L).amin(dim=1)


def _take(mat, idx):
    """``mat[i, idx[i, j]]`` with ``idx`` clipped to the columns."""
    return torch.gather(mat, 1, idx.clamp(0, mat.shape[1] - 1).long())


def _gather_cols(mat, idx):
    """mat [n, L], idx [n] -> mat[i, idx[i]] with idx clipped."""
    return _take(mat, idx[:, None])[:, 0]


def _shift_right(x, k, fill=0):
    """``x[:, j - k]`` at column ``j``; ``fill`` in the first ``k``."""
    out = torch.full_like(x, fill)
    out[:, k:] = x[:, :max(x.shape[1] - k, 0)]
    return out


def _shift_left(x, k):
    """``x[:, j + k]`` at column ``j``; zero past the end."""
    out = torch.zeros_like(x)
    out[:, :x.shape[1] - k] = x[:, k:]
    return out


def fast_path(chars, lengths, validity, path_tuple, max_out):
    """Evaluate a wildcard-free JSONPath over clean documents.

    Returns ``(out_chars u8[n, max_out], out_lens i32[n], ok bool[n],
    fallback bool[n])``.  ``ok`` is meaningful only where ``fallback`` is
    False; callers must route fallback rows through the scan machine.
    """
    n, L = chars.shape
    dev = chars.device
    i32 = torch.int32
    pos = torch.arange(L, dtype=i32, device=dev)[None, :]
    lens = lengths.to(i32)
    inb = pos < lens[:, None]
    ch = torch.where(inb, chars, torch.zeros_like(chars))

    def C(s):
        return ch == ord(s)

    # ---- trigger 1: characters the fast path does not model ----------
    fb = (inb & (C("\\") | C("'"))).any(dim=1)
    bad = torch.zeros((n,), dtype=torch.bool, device=dev)

    # ---- in-string mask (double quotes only, no escapes) -------------
    isq = C('"')
    qpre = row_cumsum(isq)                            # inclusive
    open_q = isq & (qpre % 2 == 1)
    close_q = isq & (qpre % 2 == 0)
    content = (~isq) & ((qpre % 2) == 1) & inb       # strictly inside
    outside = inb & ~content & ~isq

    isws = C(" ") | C("\t") | C("\n") | C("\r")
    ws = outside & isws
    punct_chars = C("{") | C("}") | C("[") | C("]") | C(",") | C(":")
    punct = outside & punct_chars
    valch = outside & ~ws & ~punct_chars             # number/literal

    opens = outside & (C("{") | C("["))
    closes = outside & (C("}") | C("]"))
    delta = opens.to(i32) - closes.to(i32)
    depth_after = row_cumsum(delta)
    depth_before = depth_after - delta

    # ---- root span ---------------------------------------------------
    nonws = inb & ~isws
    root_start = _first_true(nonws, L)
    empty_doc = root_start >= lens                    # NULL, not fb
    c0 = _gather_cols(ch, root_start)
    root_is_container = (c0 == ord("{")) | (c0 == ord("["))
    # matching close of the root container: first close AFTER root_start
    # whose depth_after is 0
    close0 = closes & (depth_after == 0) & (pos > root_start[:, None])
    root_close = _first_true(close0, L)
    # scalar roots end at their token end (string close / run end)
    run_end = valch & ~_shift_left(valch, 1)

    def str_close_after(s):
        return _first_true(close_q & (pos > s[:, None]), L)

    def vend_at(s):
        return _first_true(run_end & (pos >= s[:, None]), L)

    root_end = torch.where(
        root_is_container, root_close,
        torch.where(c0 == ord('"'), str_close_after(root_start),
                    vend_at(root_start)))
    # a container root with no matching close, or a scalar root with no
    # token end, may still be junk the scan machine NULLs — fall back
    fb |= (~empty_doc) & (root_end >= L)
    span = (pos >= root_start[:, None]) & (pos <= root_end[:, None]) & inb

    # parity must close inside the root span (an unclosed string whose
    # quote count balances later in trailing junk would corrupt masks)
    qpre_end = _gather_cols(qpre, root_end)
    fb |= (~empty_doc) & (qpre_end % 2 != 0)
    # trailing junk is ignored by the reference; nothing after root_end
    # participates in any mask below
    fb |= (span & ~(depth_before >= 0)).any(dim=1)
    # a document of L chars cannot nest deeper than L // 2, so the
    # per-depth forward-fill budget shrinks with narrow columns
    ff_depth = max(1, min(MAX_FF_DEPTH, L // 2))
    maxd = torch.where(span, depth_after, torch.zeros_like(depth_after)
                       ).amax(dim=1)
    fb |= maxd > ff_depth

    # ---- owner container type per position ---------------------------
    # own_idx[d - 1][j] = index of the latest open bracket with
    # depth_after == d at or before j (the bracket owning level d)
    neg1 = torch.full((n, L), -1, dtype=i32, device=dev)
    zero_u8 = torch.zeros((), dtype=torch.uint8, device=dev)
    cont = torch.zeros((n, L), dtype=torch.uint8, device=dev)
    for d in range(1, ff_depth + 1):
        own = _ffill_max(torch.where(opens & span & (depth_after == d),
                                     pos.expand(n, L), neg1))
        oc = torch.where(own >= 0, _take(ch, own), zero_u8)
        # container char for a position with depth_before == d (0 = ROOT)
        cont = torch.where(depth_before == d, oc, cont)

    # ---- anchors and prev-anchor grammar -----------------------------
    run_start = valch & ~_shift_right(valch, 1, False)
    kind = torch.zeros((n, L), dtype=i32, device=dev)

    def setk(k, m, v):
        return torch.where(m, torch.full_like(k, v), k)

    kind = setk(kind, punct & C("{"), A_OBRACE)
    kind = setk(kind, punct & C("}"), A_CBRACE)
    kind = setk(kind, punct & C("["), A_OBRK)
    kind = setk(kind, punct & C("]"), A_CBRK)
    kind = setk(kind, punct & C(","), A_COMMA)
    kind = setk(kind, punct & C(":"), A_COLON)
    kind = setk(kind, open_q, A_OPENQ)
    kind = setk(kind, close_q, A_CLOSEQ)  # field/value split below
    kind = setk(kind, run_end, A_VEND)
    anchor = (kind != 0) & span

    # prev anchor kind/char before each position (START if none)
    prev_idx_incl = _ffill_max(torch.where(anchor, pos.expand(n, L), neg1))
    prev_idx = _shift_right(prev_idx_incl, 1, -1)
    a_start = torch.full_like(kind, A_START)
    prev_kind = torch.where(prev_idx >= 0, _take(kind, prev_idx), a_start)

    # field-name strings: an opening quote in an object context whose
    # previous anchor is '{' or ',' (value strings follow ':')
    is_fq_open = open_q & span & (cont == ord("{")) & (
        (prev_kind == A_OBRACE) | (prev_kind == A_COMMA))
    # propagate the field flag from each open quote to its close quote:
    # encode (position, flag) as pos*2+flag so the running max carries the
    # LATEST open quote's flag
    fq_ff = _ffill_max(torch.where(open_q, pos * 2 + is_fq_open.to(i32),
                                   neg1))
    close_is_field = close_q & (fq_ff >= 0) & (fq_ff % 2 == 1)
    kind = setk(kind, close_is_field, A_FCLOSEQ)
    prev_kind = torch.where(prev_idx >= 0, _take(kind, prev_idx), a_start)

    is_obj = cont == ord("{")
    is_arr = cont == ord("[")
    is_root_ctx = cont == 0

    pk = prev_kind
    value_end_kinds = ((pk == A_CLOSEQ) | (pk == A_CBRACE) | (pk == A_CBRK)
                       | (pk == A_VEND))
    value_start_ok = (
        (is_obj & (pk == A_COLON))
        | (is_arr & ((pk == A_OBRK) | (pk == A_COMMA)))
        | (is_root_ctx & (pk == A_START)))

    rule_ok = torch.ones((n, L), dtype=torch.bool, device=dev)

    def apply(mask, ok):
        """AND a rule into rule_ok at masked positions."""
        nonlocal rule_ok
        rule_ok = torch.where(mask & span, rule_ok & ok, rule_ok)

    apply(kind == A_OBRACE, value_start_ok)
    apply(kind == A_OBRK, value_start_ok)
    apply(run_start, value_start_ok)
    apply(open_q & ~is_fq_open, value_start_ok | (is_obj & (pk == A_COLON)))
    apply(kind == A_CBRACE, is_obj & ((pk == A_OBRACE) | value_end_kinds))
    apply(kind == A_CBRK, is_arr & ((pk == A_OBRK) | value_end_kinds))
    apply(kind == A_COMMA, (is_obj | is_arr) & value_end_kinds)
    apply(kind == A_COLON, is_obj & (pk == A_FCLOSEQ))
    # a field close-quote must be followed by ':' — equivalently no other
    # anchor may have a field-close as its previous anchor
    apply((kind != 0) & (kind != A_COLON) & (pk == A_FCLOSEQ),
          torch.zeros((n, L), dtype=torch.bool, device=dev))

    # ---- number / literal token validation ---------------------------
    isdig = (ch >= ord("0")) & (ch <= ord("9"))
    num_allowed = isdig | C("-") | C("+") | C(".") | C("e") | C("E")
    lit_allowed = (C("t") | C("r") | C("u") | C("e") | C("f") | C("a")
                   | C("l") | C("s") | C("n"))

    # first char of each run, forward-filled across the run
    rs_idx = _ffill_max(torch.where(run_start, pos.expand(n, L), neg1))
    rs_char = torch.where(rs_idx >= 0, _take(ch, rs_idx), zero_u8)
    is_lit_run = ((rs_char == ord("t")) | (rs_char == ord("f"))
                  | (rs_char == ord("n")))
    is_num_run = valch & ~is_lit_run
    lit_run = valch & is_lit_run

    apply(is_num_run, num_allowed)
    apply(lit_run, lit_allowed)

    # literal runs must be exactly true/false/null
    def win_eq(s_idx, lit):
        m = torch.ones((n,), dtype=torch.bool, device=dev)
        for i, b in enumerate(lit):
            m &= _gather_cols(ch, s_idx + i) == b
        return m

    lit_start = run_start & is_lit_run & span
    # run length at run START: this run's end = first run_end >= start
    # (a forward fill from the right)
    next_end_rev = _ffill_max(torch.flip(
        torch.where(run_end, (L - 1) - pos.expand(n, L), neg1), [1]))
    next_end = (L - 1) - torch.flip(next_end_rev, [1])
    run_len = torch.where(valch, next_end - rs_idx + 1,
                          torch.zeros_like(next_end))
    for lit, ll in ((b"true", 4), (b"false", 5), (b"null", 4)):
        sel = lit_start & (ch == lit[0])
        okm = None
        for i, b in enumerate(lit):
            okm_i = _take(ch, pos.expand(n, L) + i) == b
            okm = okm_i if i == 0 else (okm & okm_i)
        apply(sel, okm & (run_len == ll))

    # number grammar: local char rules + per-run aggregates
    prev_ch = _shift_right(ch, 1)
    next_ch = _shift_left(ch, 1)
    prev_dig = (prev_ch >= ord("0")) & (prev_ch <= ord("9"))
    next_dig = (next_ch >= ord("0")) & (next_ch <= ord("9"))
    is_e = is_num_run & (C("e") | C("E"))
    nn_ch = _shift_left(ch, 2)
    nn_dig = (nn_ch >= ord("0")) & (nn_ch <= ord("9"))
    prev_is_e = (prev_ch == ord("e")) | (prev_ch == ord("E"))
    apply(is_num_run & C("-"), run_start | prev_is_e)
    apply(is_num_run & C("+"), prev_is_e)
    apply(is_num_run & C("."), prev_dig & next_dig)
    apply(is_e, prev_dig & (next_dig | (
        ((next_ch == ord("+")) | (next_ch == ord("-"))) & nn_dig)))
    # leading zero: '0' at int-part start directly followed by a digit
    int_start = run_start | (prev_ch == ord("-")) & (rs_idx == pos - 1)
    apply(is_num_run & C("0") & int_start, ~next_dig)
    # at most one e / one dot, dot before e — per-run aggregates via
    # cumsum differences anchored at the run start
    cum_e = row_cumsum(is_e)
    cum_d = row_cumsum(is_num_run & C("."))
    zi = torch.zeros_like(cum_e)
    base_e = torch.where(rs_idx >= 0, _take(cum_e, rs_idx), zi)
    base_d = torch.where(rs_idx >= 0, _take(cum_d, rs_idx), zi)
    e_at_start = torch.where(rs_idx >= 0, _take(is_e.to(i32), rs_idx), zi)
    run_e = cum_e - base_e + e_at_start
    run_d = cum_d - base_d  # '.' can never be at run start (rule above)
    apply(is_e, run_e <= 1)
    apply(is_num_run & C("."), (run_d <= 1) & (run_e == 0))
    # digit budget (reference: <=1000 digits).  run_len <= 1000 implies
    # digits <= 1000 (sound accept); valid numbers of 1001-1007 chars with
    # <=1000 digits false-reject into the harmless fallback
    apply(run_start & is_num_run, run_len <= 1000)

    # any rule failure -> fall back (the scan machine decides NULL)
    fb |= (span & ~rule_ok).any(dim=1)

    # ---- path navigation (unrolled over the path) ---------------------
    cs = root_start
    alive = ~empty_doc
    for (ptype, parg) in path_tuple:
        ccur = _gather_cols(ch, cs)
        cd = _gather_cols(depth_after, cs)    # depth of contents
        # matching close of this container
        close_m = closes & (pos > cs[:, None]) & (
            depth_after == (cd - 1)[:, None]) & span
        cend = _first_true(close_m, L)
        if ptype == "named":
            name = parg
            k = len(name)
            bad |= alive & (ccur != ord("{"))
            alive &= ccur == ord("{")
            # candidate field quotes at this level inside (cs, cend)
            m = (kind == A_OPENQ) & is_fq_open & (
                depth_before == cd[:, None]) & (pos > cs[:, None]) & (
                pos < cend[:, None])
            for i, b in enumerate(name):
                m &= _take(ch, pos.expand(n, L) + 1 + i) == b
            m &= _take(ch, pos.expand(n, L) + 1 + k) == ord('"')
            q0 = _first_true(m, L)
            found = q0 < L
            bad |= alive & ~found
            alive &= found
            # value start: first non-ws after the colon after q0+k+1
            colon = _first_true((~isws) & inb & (pos > (q0 + k + 1)[:, None]),
                                L)
            vstart = _first_true((~isws) & inb & (pos > colon[:, None]), L)
            # matched null at a named step -> NULL overall
            vc = _gather_cols(ch, vstart)
            is_null = (vc == ord("n")) & win_eq(vstart, b"null")
            bad |= alive & is_null
            alive &= ~is_null
            cs = torch.where(alive, vstart, cs)
        else:  # ("index", i)
            idx = int(parg)
            bad |= alive & (ccur != ord("["))
            alive &= ccur == ord("[")
            first_elem = _first_true((~isws) & inb & (pos > cs[:, None]), L)
            empty_arr = _gather_cols(ch, first_elem) == ord("]")
            if idx == 0:
                bad |= alive & empty_arr
                alive &= ~empty_arr
                cs = torch.where(alive, first_elem, cs)
            else:
                commas = (kind == A_COMMA) & (
                    depth_before == cd[:, None]) & (pos > cs[:, None]) & (
                    pos < cend[:, None])
                ccount = row_cumsum(commas)
                target_comma = _first_true(commas & (ccount == idx), L)
                have = target_comma < L
                bad |= alive & ~have
                alive &= have
                estart = _first_true(
                    (~isws) & inb & (pos > target_comma[:, None]), L)
                cs = torch.where(alive, estart, cs)

    # ---- target classification & span --------------------------------
    tc = _gather_cols(ch, cs)
    t_is_str = tc == ord('"')
    t_is_cont = (tc == ord("{")) | (tc == ord("["))
    t_is_lit = (tc == ord("t")) | (tc == ord("f")) | (tc == ord("n"))
    t_is_num = alive & ~t_is_str & ~t_is_cont & ~t_is_lit

    td = _gather_cols(depth_after, cs)
    t_close = _first_true(closes & (pos > cs[:, None]) & (
        depth_after == (td - 1)[:, None]) & span, L)
    t_strclose = str_close_after(cs)
    t_vend = vend_at(cs)
    t_end = torch.where(t_is_cont, t_close,
                        torch.where(t_is_str, t_strclose, t_vend))

    in_tspan = (pos >= cs[:, None]) & (pos <= t_end[:, None])

    # container-copy fallback triggers: float numbers, "-0" ints,
    # control chars inside strings (all need rewriting)
    num_float_ch = is_num_run & (C(".") | is_e)
    t_has_float = (in_tspan & num_float_ch).any(dim=1)
    neg0 = run_start & C("-") & (next_ch == ord("0")) & (run_len == 2)
    t_has_neg0 = (in_tspan & neg0).any(dim=1)
    t_has_ctrl = (in_tspan & content & (ch < 0x20)).any(dim=1)
    fb |= alive & t_is_cont & (t_has_float | t_has_neg0 | t_has_ctrl)

    # scalar float target (no length bound: the shared formatter below
    # reads the same <=326-char window the scan machine does)
    t_tok_len = t_vend - cs + 1
    t_is_float = t_is_num & t_has_float

    # ---- materialization ---------------------------------------------
    W = int(max_out)
    outp = torch.arange(W, dtype=i32, device=dev)[None, :]
    zero_i = torch.zeros_like(cs)

    # verbatim channel (string content / int / literal)
    # string: span (cs+1, t_strclose); int/literal: [cs, t_vend]
    v_start = torch.where(t_is_str, cs + 1, cs)
    v_len = torch.where(t_is_str, t_strclose - cs - 1,
                        torch.where(t_is_cont, zero_i, t_vend - cs + 1))
    # "-0" -> "0"
    is_neg0_t = t_is_num & (_gather_cols(ch, cs) == ord("-")) & (
        _gather_cols(ch, cs + 1) == ord("0")) & (t_tok_len == 2)
    v_start = torch.where(is_neg0_t, cs + 1, v_start)
    v_len = torch.where(is_neg0_t, torch.ones_like(v_len), v_len)
    # verbatim bytes come from the document, so columns past L are zero
    Wv = min(W, L)
    outv = outp[:, :Wv]
    verb = torch.where(outv < v_len[:, None],
                       _take(ch, v_start[:, None] + outv), zero_u8)
    if Wv < W:
        verb = torch.cat([verb, torch.zeros((n, W - Wv), dtype=torch.uint8,
                                            device=dev)], dim=1)

    # container-compact channel: keep = non-ws within span (strings keep
    # everything incl. quotes); runs only when some live row has a
    # container target (one host read)
    HOST_SYNCS["fast_path"] += 1
    if bool((alive & t_is_cont).any()):
        from .strings import left_compact_rows

        keep = in_tspan & (content | isq | (outside & ~ws))
        packed, c_len = left_compact_rows(ch, keep)
    else:
        packed = torch.zeros((n, L), dtype=torch.uint8, device=dev)
        c_len = torch.zeros((n,), dtype=i32, device=dev)
    if W >= L:
        cont_out = torch.cat([packed, torch.zeros(
            (n, W - L), dtype=torch.uint8, device=dev)], dim=1)
    else:
        cont_out = packed[:, :W]
    cont_out = torch.where(outp < c_len[:, None], cont_out, zero_u8)

    # float channel: gather the token into a window, parse + format
    # (Ryu), the scan machine's own formatter; gated on any live float
    # target existing (one host read)
    HOST_SYNCS["fast_path"] += 1
    if bool((alive & t_is_float).any()):
        from .get_json_object import _format_floats

        fbytes3, flens2 = _format_floats(
            ch, cs[:, None], torch.where(t_is_float, t_tok_len,
                                         zero_i)[:, None], 1)
        fbytes, flens = fbytes3[:, 0], flens2[:, 0].to(i32)
    else:
        fbytes = torch.zeros((n, float_to_string.DOUBLE_JSON_W),
                             dtype=torch.uint8, device=dev)
        flens = torch.zeros((n,), dtype=i32, device=dev)
    FW = fbytes.shape[1]
    if W >= FW:
        float_out = torch.cat([fbytes, torch.zeros(
            (n, W - FW), dtype=torch.uint8, device=dev)], dim=1)
    else:
        float_out = fbytes[:, :W]
    float_out = torch.where(outp < flens[:, None], float_out, zero_u8)

    out_chars = torch.where(t_is_float[:, None], float_out,
                            torch.where(t_is_cont[:, None], cont_out, verb))
    out_lens = torch.where(t_is_float, flens,
                           torch.where(t_is_cont, c_len, v_len))

    ok = alive & ~bad & validity
    ok &= out_lens <= W   # overlong -> null (matches the scan machine)
    out_lens = torch.where(ok, out_lens, torch.zeros_like(out_lens))
    out_chars = torch.where(ok[:, None], out_chars, zero_u8)
    fb &= validity       # null rows never need the scan machine
    return out_chars, out_lens.to(i32), ok, fb
