"""Spark ``get_json_object``: a char-scan state machine over all rows.

Counterpart of ``spark_rapids_jni_tpu/ops/get_json_object.py``.
Reference: the CUDA thread-per-row pull parser + JSONPath context-stack
evaluator (``json_parser.cuh``, ``get_json_object.cu:360-788``; semantics
also modeled by ``tests/json_oracle.py``).  The machine is the JAX
package's, with the same semantics:

* **One pass over the char columns**: every row advances through char
  column ``j`` in lockstep; the carry (a dict of tensors) holds a
  vectorized tokenizer state (modes, a 64-bit nesting bitstack as two
  u32 lanes in int64 carriers) fused with the JSONPath evaluator state
  (a [n, 17] context stack of named/index containers being evaluated).
  All branching is masked vector selects.  The reference's ``lax.scan``
  is a Python loop over the L + 1 columns here, each step a few hundred
  small torch ops.
* **No byte is written during the scan.**  Each step records compact
  emission directives (a source span, a string-content expansion, a
  float re-format, or the char itself).  Output bytes materialize
  afterwards in one vectorized gather pass: each output position
  binary-searches its emitting step, then computes its byte from the
  source chars around that step.
* **Float normalization** rides the Ryu port: float tokens are collected
  into a side buffer, parsed with ``cast_string.string_to_float`` and
  re-formatted with Java ``Double.toString`` layout (quoted Infinity per
  ``ftos_converter.cuh:1154-1200``).

Supported paths: the full JSONPath subset of the reference — named
members, array indexes, and wildcards (all 12 evaluator case paths).

Spark quirks replicated: single-quoted strings, unescaped control chars,
no leading zeros, "-0" -> "0", number digit cap 1000, nesting cap 64,
path cap 16, a ``\\uXXXX`` escape in a field name never matches
(json_parser.cuh:983).

Routing (:func:`get_json_object`): wildcard-free paths run the
bit-parallel :func:`.json_fast.fast_path` first, and only its flagged
rows run the scan machine, in sub-batches of ``ceil(n / div)`` rows
(``json_fallback_div``) after ONE host read of the flagged count.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from ..columnar import types as T
from ..columnar.column import StringColumn
from . import cast_string, float_to_string
from ._util import device_table, host_table

MAX_NESTING = 64
MAX_PATH = 16
MAX_NUM_DIGITS = 1000
FLOAT_W = 26  # max formatted double width ("-2.2250738585072014E-308")

# host reads of the routing (``n_flagged``) and scan-machine runs
HOST_SYNCS = {"n_flagged": 0, "scan_runs": 0, "scan_rows": 0}

# ---------------------------------------------------------------------------
# tokenizer modes (carry `mode`)
# ---------------------------------------------------------------------------
M_VALUE = 0      # expecting start of a value (ws allowed)
M_STR = 1        # inside string content
M_ESC = 2        # after backslash
M_UHEX = 3       # inside \uXXXX hex run (ucnt counts)
M_NUM_SIGN = 4   # after leading '-'
M_NUM_LZ = 5     # after leading '0'
M_NUM_INT = 6    # in integer digits
M_NUM_DOT = 7    # just after '.'
M_NUM_FRAC = 8   # in fraction digits
M_NUM_E = 9      # just after e/E
M_NUM_ESIGN = 10  # after exponent sign
M_NUM_EXP = 11   # in exponent digits
M_LIT = 12       # inside true/false/null
M_AFTER = 13     # after a complete value (expect , ] } or eof)
M_FIELD = 14     # expecting field-name quote (ws allowed)
M_COLON = 15     # expecting ':' (ws allowed)
M_DONE = 16      # top-level value complete (trailing bytes ignored)
M_ERR = 17

# value/field events (phase A)
EV_NONE = 0
EV_STR = 1
EV_NUM = 2
EV_TRUE = 3
EV_FALSE = 4
EV_NULL = 5
EV_SOBJ = 6
EV_SARR = 7
EV_FIELD = 8

# end events (phase B)
EB_NONE = 0
EB_EOBJ = 1
EB_EARR = 2

# evaluator row modes
EVM_NORM = 0
EVM_COPY = 1
EVM_SKIP = 2

# context kinds (the reference's case-path numbers) / wait states
K2 = 2      # case 2: matched FLATTEN array — iterate, no brackets
K_OBJ = 4   # case 4: object, named instruction
K5 = 5      # case 5: double wildcard — '[' + flatten children
K6 = 6      # case 6: single wildcard, raw/flatten — buffered child + gap
K7 = 7      # case 7: single wildcard, quoted — '[' + quoted children
K_ARR = 9   # cases 8/9: array, index instruction (8 = quoted child style)
W_FIELDSCAN = 0   # scanning fields for the named match
W_SKIPVAL = 1     # consuming the value of a non-matching field
W_VALUE = 2       # next value event is the matched target
W_SKIPREST = 3    # skipping to this container's end
W_IDX = 4         # skipping cnt more elements; cnt==0 -> next value is target
W_ELEMS = 5       # array iteration: every element is evaluated

# write styles (reference write_style RAW/QUOTED/FLATTEN)
S_RAW = 0
S_QUOTED = 1
S_FLATTEN = 2

# string-content emission flags (per step)
SF_NONE = 0
SF_CONTENT = 1   # plain string content char
SF_ESCCHAR = 2   # the char after a backslash
SF_UHEXLAST = 3  # 4th hex digit of \uXXXX: emits the decoded UTF-8
SF_QUOTE = 4     # open/close quote emitting '"' (escaped style only)

# path instruction types
P_NAMED = 0
P_INDEX = 1
P_WILD = 2

host_table("json_lit", np.asarray(
    [list(b"true\x00"), list(b"false"), list(b"null\x00")],
    dtype=np.uint8).reshape(-1))
host_table("json_lit_len", np.asarray([4, 5, 4], dtype=np.int32))
_SHORT_ESC_CODE = np.zeros((32,), np.uint8)
for _ctrl, _esc in ((8, "b"), (9, "t"), (10, "n"), (12, "f"), (13, "r")):
    _SHORT_ESC_CODE[_ctrl] = ord(_esc)
_ESC_DECODE = np.arange(256, dtype=np.uint8)
for _ctrl, _esc in ((8, "b"), (12, "f"), (10, "n"), (13, "r"), (9, "t")):
    _ESC_DECODE[ord(_esc)] = _ctrl
host_table("json_short_esc", _SHORT_ESC_CODE)
host_table("json_esc_decode", _ESC_DECODE)


def parse_path(path: str):
    """'$.a[3].b' -> instruction tuples (same surface as JSONUtils.java)."""
    out = []
    i = 0
    if path.startswith("$"):
        i = 1
    while i < len(path):
        c = path[i]
        if c == ".":
            i += 1
            j = i
            while j < len(path) and path[j] not in ".[":
                j += 1
            name = path[i:j]
            out.append(("wildcard",) if name == "*"
                       else ("named", name.encode()))
            i = j
        elif c == "[":
            j = path.index("]", i)
            inner = path[i + 1: j].strip()
            if inner == "*":
                out.append(("wildcard",))
            elif inner.startswith("'"):
                out.append(("named", inner.strip("'").encode()))
            else:
                out.append(("index", int(inner)))
            i = j + 1
        else:
            raise ValueError(f"bad JSONPath {path!r} at offset {i}")
    return out


@functools.lru_cache(maxsize=64)
def _pack_path(instructions: tuple, device: torch.device):
    """Host: instruction tuples -> (types[P], indexes[P], names[P,W],
    nlen[P], depth) as tensors on ``device``, built and copied there once
    per path."""
    if len(instructions) > MAX_PATH:
        raise ValueError(f"path deeper than {MAX_PATH}")
    types, indexes, names = [], [], []
    for ins in instructions:
        if ins[0] == "named":
            types.append(P_NAMED)
            indexes.append(0)
            names.append(ins[1])
        elif ins[0] == "index":
            types.append(P_INDEX)
            indexes.append(int(ins[1]))
            names.append(b"")
        elif ins[0] == "wildcard":
            types.append(P_WILD)
            indexes.append(0)
            names.append(b"")
        else:
            raise ValueError(f"unknown path instruction {ins!r}")
    P = max(1, len(instructions))
    W = max(1, max((len(nm) for nm in names), default=1))
    t = np.zeros((P,), np.int32)
    ix = np.zeros((P,), np.int32)
    nc = np.zeros((P, W), np.uint8)
    nl = np.zeros((P,), np.int32)
    for k, (ty, iv, nm) in enumerate(zip(types, indexes, names)):
        t[k] = ty
        ix[k] = iv
        nc[k, : len(nm)] = np.frombuffer(nm, np.uint8)
        nl[k] = len(nm)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return dev(t), dev(ix), dev(nc), dev(nl), len(instructions)


# ---------------------------------------------------------------------------
# the scan step
# ---------------------------------------------------------------------------

_w = torch.where  # shorthand: the step is hundreds of masked selects


def _step(P, ptypes, pindexes, pnames, pnamelens, st, j, c, events=False):
    """One char column ``c`` (at column ``j``) for all rows.  Pure
    masked-vector logic; returns the new carry and the step's
    emission directives.  ``events=True`` adds the raw token events
    (``ev_a``, ``ev_b``, ``span_s``, ``span_len``) to the directives, for
    ``from_json``'s recorder; :func:`get_json_object` leaves them out, so
    its scan stacks only the lanes it reads."""
    n = c.shape[0]
    dev = c.device
    i32 = torch.int32
    FALSE = torch.zeros((n,), dtype=torch.bool, device=dev)

    alive = (j <= st["length"]) & (st["mode"] != M_ERR) \
        & (st["mode"] != M_DONE)
    at_eof = st["length"] == j
    mode = st["mode"]

    def eq(ch):
        return c == ord(ch)

    is_ws = (c == 32) | (c == 9) | (c == 10) | (c == 13)
    is_digit = (c >= ord("0")) & (c <= ord("9"))
    is_hex = is_digit | ((c >= 65) & (c <= 70)) | ((c >= 97) & (c <= 102))
    is_e = eq("e") | eq("E")
    in_obj_bit = _stack_top(st["cstack_lo"], st["cstack_hi"], st["depth"])

    # ---- 1. number completion (shares its step with the delimiter char) --
    num_modes = (mode >= M_NUM_SIGN) & (mode <= M_NUM_EXP)
    num_cont = _w(
        mode == M_NUM_SIGN, is_digit,
        _w(mode == M_NUM_LZ, eq(".") | is_e,
           _w(mode == M_NUM_INT, is_digit | eq(".") | is_e,
              _w(mode == M_NUM_DOT, is_digit,
                 _w(mode == M_NUM_FRAC, is_digit | is_e,
                    _w(mode == M_NUM_E, is_digit | eq("+") | eq("-"),
                       is_digit))))))  # M_NUM_ESIGN / M_NUM_EXP
    num_cont = num_cont & ~at_eof
    # a digit directly after a leading zero is a tokenize error ("01"),
    # not a completed "0" token (try_unsigned_number, json_parser.cuh:1076)
    lz_digit_err = alive & (mode == M_NUM_LZ) & is_digit & ~at_eof
    num_completes = alive & num_modes & ~num_cont & ~lz_digit_err
    num_ok_state = ((mode == M_NUM_LZ) | (mode == M_NUM_INT)
                    | (mode == M_NUM_FRAC) | (mode == M_NUM_EXP))
    ndig_ok = st["ndig"] <= MAX_NUM_DIGITS
    num_valid = num_completes & num_ok_state & ndig_ok
    num_err = (num_completes & ~(num_ok_state & ndig_ok)) | lz_digit_err
    # after a valid number the delimiter char is processed in M_AFTER below
    eff_mode = _w(num_valid, M_AFTER, mode)

    ev_a = _w(num_valid, EV_NUM, torch.zeros_like(mode))
    ev_num_float = st["numf"]
    ev_span_start = st["tok_start"]
    ev_span_len = j - st["tok_start"]
    err = num_err

    # ---- 2. per-mode tokenizer transitions ------------------------------
    new_mode = eff_mode
    new_depth = st["depth"]
    clo, chi = st["cstack_lo"], st["cstack_hi"]
    new_allow_close = st["allow_close"]
    new_quote = st["quote"]
    new_sfield = st["sfield"]
    new_tok = st["tok_start"]
    new_ndig = st["ndig"]
    new_numf = st["numf"]
    new_ucnt = st["ucnt"]
    new_lid = st["lit_id"]
    new_lpos = st["lit_pos"]
    ev_b = torch.zeros((n,), dtype=i32, device=dev)

    # -- M_VALUE: value start ------------------------------------------
    mv = alive & (eff_mode == M_VALUE) & ~at_eof
    open_obj = mv & eq("{")
    open_arr = mv & eq("[")
    depth_ok = st["depth"] < MAX_NESTING
    ev_a = _w(open_obj & depth_ok, EV_SOBJ, ev_a)
    ev_a = _w(open_arr & depth_ok, EV_SARR, ev_a)
    err = err | ((open_obj | open_arr) & ~depth_ok)
    push = (open_obj | open_arr) & depth_ok
    clo, chi = _stack_push(clo, chi, st["depth"], open_obj, push)
    new_depth = _w(push, st["depth"] + 1, new_depth)
    # after '{' expect field-or-'}'; after '[' expect value-or-']'
    new_mode = _w(open_obj & depth_ok, M_FIELD, new_mode)
    new_mode = _w(open_arr & depth_ok, M_VALUE, new_mode)
    new_allow_close = new_allow_close | push

    sq = mv & (eq('"') | eq("'"))
    new_mode = _w(sq, M_STR, new_mode)
    new_quote = _w(sq, c, new_quote)
    new_sfield = new_sfield & ~sq
    new_tok = _w(sq, j, new_tok)

    lit = mv & (eq("t") | eq("f") | eq("n"))
    new_mode = _w(lit, M_LIT, new_mode)
    new_lid = _w(lit, _w(eq("t"), 0, _w(eq("f"), 1, 2)).to(i32), new_lid)
    new_lpos = _w(lit, 1, new_lpos)
    new_tok = _w(lit, j, new_tok)

    num0 = mv & (eq("-") | is_digit)
    new_mode = _w(num0, _w(eq("-"), M_NUM_SIGN,
                           _w(eq("0"), M_NUM_LZ, M_NUM_INT)).to(i32),
                  new_mode)
    new_tok = _w(num0, j, new_tok)
    new_ndig = _w(num0, is_digit.to(i32), new_ndig)
    new_numf = new_numf & ~num0

    arr_close = mv & eq("]") & st["allow_close"] & (st["depth"] > 0) \
        & ~in_obj_bit
    ev_b = _w(arr_close, EB_EARR, ev_b)
    new_depth = _w(arr_close, st["depth"] - 1, new_depth)
    new_mode = _w(arr_close, M_AFTER, new_mode)

    bad_v = mv & ~(is_ws | open_obj | open_arr | sq | lit | num0 | arr_close)
    err = err | bad_v

    # -- M_FIELD: field-name start (or immediate '}') ------------------
    mf = alive & (eff_mode == M_FIELD) & ~at_eof
    fq = mf & (eq('"') | eq("'"))
    new_mode = _w(fq, M_STR, new_mode)
    new_quote = _w(fq, c, new_quote)
    new_sfield = new_sfield | fq
    new_tok = _w(fq, j, new_tok)
    obj_close = mf & eq("}") & st["allow_close"] & (st["depth"] > 0) \
        & in_obj_bit
    ev_b = _w(obj_close, EB_EOBJ, ev_b)
    new_depth = _w(obj_close, st["depth"] - 1, new_depth)
    new_mode = _w(obj_close, M_AFTER, new_mode)
    err = err | (mf & ~(is_ws | fq | obj_close))
    # field-match trackers reset at field start
    new_fmok = st["fm_ok"] | fq
    new_fmpos = _w(fq, 0, st["fm_pos"])

    # -- M_COLON --------------------------------------------------------
    mc = alive & (eff_mode == M_COLON) & ~at_eof
    col = mc & eq(":")
    new_mode = _w(col, M_VALUE, new_mode)
    new_allow_close = new_allow_close & ~col
    err = err | (mc & ~(is_ws | col))

    # -- M_AFTER: between values ---------------------------------------
    ma = alive & (eff_mode == M_AFTER) & ~at_eof
    top = ma & (st["depth"] == 0)
    # trailing content after the root value is ignored (reference SUCCESS)
    new_mode = _w(top & ~is_ws, M_DONE, new_mode)
    comma = ma & ~top & eq(",")
    new_mode = _w(comma, _w(in_obj_bit, M_FIELD, M_VALUE).to(i32), new_mode)
    new_allow_close = new_allow_close & ~comma
    close_o = ma & ~top & eq("}") & in_obj_bit
    close_a = ma & ~top & eq("]") & ~in_obj_bit
    ev_b = _w(close_o, EB_EOBJ, _w(close_a, EB_EARR, ev_b))
    new_depth = _w(close_o | close_a, st["depth"] - 1, new_depth)
    new_mode = _w(close_o | close_a, M_AFTER, new_mode)
    err = err | (ma & ~top & ~(is_ws | comma | close_o | close_a))

    # -- M_STR / M_ESC / M_UHEX ----------------------------------------
    ms = alive & (eff_mode == M_STR) & ~at_eof
    quote_close = ms & (c == st["quote"])
    backslash = ms & (c == 0x5C)
    content = ms & ~quote_close & ~backslash
    new_mode = _w(backslash, M_ESC, new_mode)
    new_mode = _w(quote_close & st["sfield"], M_COLON, new_mode)
    new_mode = _w(quote_close & ~st["sfield"], M_AFTER, new_mode)
    ev_a = _w(quote_close, _w(st["sfield"], EV_FIELD, EV_STR).to(i32), ev_a)
    ev_span_start = _w(quote_close, st["tok_start"], ev_span_start)
    ev_span_len = _w(quote_close, j + 1 - st["tok_start"], ev_span_len)

    me = alive & (eff_mode == M_ESC) & ~at_eof
    esc_short = me & (eq('"') | eq("'") | (c == 0x5C) | eq("/") | eq("b")
                      | eq("f") | eq("n") | eq("r") | eq("t"))
    esc_u = me & eq("u")
    new_mode = _w(esc_short, M_STR, new_mode)
    new_mode = _w(esc_u, M_UHEX, new_mode)
    new_ucnt = _w(esc_u, 0, new_ucnt)
    err = err | (me & ~(esc_short | esc_u))

    mu = alive & (eff_mode == M_UHEX) & ~at_eof
    uhex_ok = mu & is_hex
    new_ucnt = _w(uhex_ok, st["ucnt"] + 1, new_ucnt)
    uhex_done = uhex_ok & (st["ucnt"] == 3)
    new_mode = _w(uhex_done, M_STR, new_mode)
    err = err | (mu & ~is_hex)

    # -- M_LIT ----------------------------------------------------------
    ml = alive & (eff_mode == M_LIT) & ~at_eof
    lit_tab = device_table("json_lit", dev)
    expected = lit_tab[(st["lit_id"] * 5
                        + st["lit_pos"].clamp(max=4)).long()]
    lit_ok = ml & (c == expected)
    new_lpos = _w(lit_ok, st["lit_pos"] + 1, new_lpos)
    lit_len = device_table("json_lit_len", dev)[st["lit_id"].long()]
    lit_done = lit_ok & (st["lit_pos"] + 1 == lit_len)
    new_mode = _w(lit_done, M_AFTER, new_mode)
    ev_a = _w(lit_done, _w(st["lit_id"] == 0, EV_TRUE,
                           _w(st["lit_id"] == 1, EV_FALSE,
                              EV_NULL)).to(i32), ev_a)
    ev_span_start = _w(lit_done, st["tok_start"], ev_span_start)
    ev_span_len = _w(lit_done, j + 1 - st["tok_start"], ev_span_len)
    err = err | (ml & ~lit_ok)

    # -- number digit / float tracking ---------------------------------
    mnum = alive & num_modes & num_cont
    new_ndig = _w(mnum & is_digit, st["ndig"] + 1, new_ndig)
    new_numf = new_numf | (mnum & (eq(".") | is_e))
    num_next = _w(
        eff_mode == M_NUM_SIGN, _w(eq("0"), M_NUM_LZ, M_NUM_INT),
        _w((eff_mode == M_NUM_LZ) | (eff_mode == M_NUM_INT),
           _w(eq("."), M_NUM_DOT, _w(is_e, M_NUM_E, M_NUM_INT)),
           _w((eff_mode == M_NUM_DOT) | (eff_mode == M_NUM_FRAC),
              _w(is_digit, M_NUM_FRAC, M_NUM_E),
              _w(eff_mode == M_NUM_E,
                 _w(is_digit, M_NUM_EXP, M_NUM_ESIGN),
                 M_NUM_EXP))))
    new_mode = _w(mnum, num_next.to(i32), new_mode)

    # -- EOF ------------------------------------------------------------
    eof_live = alive & at_eof
    eof_ok = eof_live & (((eff_mode == M_AFTER) | (eff_mode == M_DONE))
                         & (new_depth == 0))
    new_mode = _w(eof_ok, M_DONE, new_mode)
    err = err | (eof_live & ~eof_ok)

    err = err & alive
    new_mode = _w(err, M_ERR, new_mode)

    # ======================================================================
    # evaluator (the reference's 12 case paths, re-expressed as wait-state
    # transitions on a per-row context stack — see module docstring)
    # ======================================================================
    ev_alive = ~st["ev_done"] & ~st["ev_fail"]
    tok_err = err & ev_alive  # tokenizer error while still evaluating
    evnorm = ev_alive & (st["evm"] == EVM_NORM)
    lvl = st["depth"]  # container level for start events

    sp = st["sp"]
    D = st["k_kind"].shape[1]
    slot = torch.arange(D, dtype=i32, device=dev)[None, :]
    top_sel = slot == (sp - 1)[:, None]
    top_ix = (sp - 1).clamp(0, D - 1).long()[:, None]
    has_ctx = sp > 0
    # a stack deeper than its D slots (nested flatten arrays) has no top
    # slot: its lanes read as zero, as the reference's one-hot select does
    top_in = has_ctx & (sp <= D)

    def top_get(a, ix=top_ix, has=top_in):
        v = torch.gather(a, 1, ix)[:, 0]
        return _w(has, v, torch.zeros_like(v))

    top_kind = top_get(st["k_kind"])
    top_wait = top_get(st["k_wait"])
    top_cpi = top_get(st["k_cpi"])
    top_cnt = top_get(st["k_cnt"])
    top_depth = top_get(st["k_depth"])
    top_chstyle = top_get(st["k_chstyle"])
    top_sadep = top_get(st["k_sadep"])
    top_sempty = top_get(st["k_sempty"])
    top_gap = top_get(st["k_gap"])

    # who expects the next value event, at what path offset, in what style?
    expect_skip = has_ctx & (
        (top_wait == W_SKIPVAL)
        | ((top_wait == W_IDX) & (top_cnt > 0))
        | (top_wait == W_SKIPREST))
    child_pi = top_cpi  # 0 without a context
    child_style = top_chstyle  # S_RAW (0) without a context
    matched = child_pi >= P  # path fully consumed at this value
    expect_target = ~expect_skip & (
        ~has_ctx & st["root_wait"]
        | (has_ctx & ((top_wait == W_VALUE) | (top_wait == W_ELEMS)
                      | ((top_wait == W_IDX) & (top_cnt == 0)))))

    is_valev = (ev_a >= EV_STR) & (ev_a <= EV_SARR)
    is_term = (ev_a >= EV_STR) & (ev_a <= EV_NULL)
    is_cont = (ev_a == EV_SOBJ) | (ev_a == EV_SARR)
    valev = evnorm & is_valev

    upd = {k: st[k] for k in (
        "ev_done", "ev_fail", "root_dirty", "root_wait", "k_kind", "k_wait",
        "k_cpi", "k_cnt", "k_depth", "k_dirty", "k_chstyle", "k_sadep",
        "k_sempty", "k_gap", "sp", "evm", "base_depth", "g_adep",
        "g_empty")}
    upd["root_wait"] = upd["root_wait"] & ~valev

    # generator comma state at step entry (json_generator.need_comma)
    gnc = (st["g_adep"] > 0) & ~st["g_empty"]

    # ---- value_done bookkeeping (shared by several paths) -------------
    # routing of a completed child value's dirty onto the expecting slot:
    #  root         -> root_dirty=d, ev_done
    #  W_VALUE      -> ctx.dirty+=d; d>0 ? wait=W_SKIPREST : row fail (case 4)
    #  W_IDX cnt==0 -> ctx.dirty+=d; wait=W_SKIPREST              (case 8/9)
    #  W_ELEMS      -> ctx.dirty+=d                           (cases 2/5/6/7)
    def value_done(cond, d, sel, waits, hasc):
        root_done = cond & ~hasc
        upd["ev_done"] = upd["ev_done"] | root_done
        upd["root_dirty"] = _w(root_done, d, upd["root_dirty"])
        on_value = cond & hasc & (waits == W_VALUE)
        upd["ev_fail"] = upd["ev_fail"] | (on_value & (d == 0))
        on_idx = cond & hasc & (waits == W_IDX)
        on_elems = cond & hasc & (waits == W_ELEMS)
        dm = (on_value | on_idx | on_elems)[:, None] & sel
        upd["k_dirty"] = _w(dm, upd["k_dirty"] + d[:, None], upd["k_dirty"])
        wm = (on_value | on_idx)[:, None] & sel
        upd["k_wait"] = _w(wm, W_SKIPREST, upd["k_wait"])

    # ---- terminal values under NORM -----------------------------------
    term = valev & is_term
    # a null target under a matched *field* fails the whole row (case 4's
    # "meets null token" check); elsewhere null is a copyable value
    null_fail = term & (ev_a == EV_NULL) & has_ctx & (top_wait == W_VALUE) \
        & ~expect_skip
    upd["ev_fail"] = upd["ev_fail"] | null_fail
    # skip-expectant: consume silently
    t_skip = term & expect_skip
    sv = t_skip & (top_wait == W_SKIPVAL)
    si = t_skip & (top_wait == W_IDX)
    upd["k_wait"] = _w(sv[:, None] & top_sel, W_FIELDSCAN, upd["k_wait"])
    upd["k_cnt"] = _w(si[:, None] & top_sel, upd["k_cnt"] - 1, upd["k_cnt"])
    # target terminal: dirty = matched (unmatched leftover path over a
    # terminal is reference case 12 -> dirty 0)
    t_tgt = term & expect_target & ~null_fail
    value_done(t_tgt, (t_tgt & matched).to(i32), top_sel, top_wait, has_ctx)

    # ---- container values under NORM ----------------------------------
    cont = valev & is_cont
    c_skip = cont & expect_skip
    upd["evm"] = _w(c_skip, EVM_SKIP, upd["evm"])
    upd["base_depth"] = _w(c_skip, lvl, upd["base_depth"])
    c_tgt = cont & expect_target
    # matched FLATTEN array -> case 2 (iterate without brackets);
    # any other matched container -> escaped verbatim copy (case 3)
    c_flat = c_tgt & matched & (ev_a == EV_SARR) & (child_style == S_FLATTEN)
    c_copy = c_tgt & matched & ~c_flat
    upd["evm"] = _w(c_copy, EVM_COPY, upd["evm"])
    upd["base_depth"] = _w(c_copy, lvl, upd["base_depth"])
    # descend: dispatch the next path instruction (cases 4,5,6,7,8,9,12)
    c_desc = c_tgt & ~matched
    pmax = ptypes.shape[0] - 1
    pi0 = child_pi.clamp(0, pmax).long()
    ins_t = ptypes[pi0]
    ins_ix = pindexes[pi0]
    has2 = child_pi + 1 < P
    ins2_w = has2 & (ptypes[(child_pi + 1).clamp(0, pmax).long()] == P_WILD)
    sarr = ev_a == EV_SARR
    p4 = c_desc & (ev_a == EV_SOBJ) & (ins_t == P_NAMED)
    p5 = c_desc & sarr & (ins_t == P_WILD) & ins2_w
    p6 = (c_desc & sarr & (ins_t == P_WILD) & ~ins2_w
          & (child_style != S_QUOTED))
    p7 = (c_desc & sarr & (ins_t == P_WILD) & ~ins2_w
          & (child_style == S_QUOTED))
    p8 = c_desc & sarr & (ins_t == P_INDEX) & ins2_w
    p9 = c_desc & sarr & (ins_t == P_INDEX) & ~ins2_w
    mismatch = c_desc & ~(p4 | p5 | p6 | p7 | p8 | p9)
    upd["evm"] = _w(mismatch, EVM_SKIP, upd["evm"])
    upd["base_depth"] = _w(mismatch, lvl, upd["base_depth"])
    # (a mismatched target skip routes as value_done(0) at skip exit)

    do_push = p4 | p5 | p6 | p7 | p8 | p9 | c_flat
    new_sel = slot == sp[:, None]
    pushm = do_push[:, None] & new_sel
    kind = _w(p4, K_OBJ, _w(p5, K5, _w(p6, K6, _w(p7, K7, _w(
        c_flat, K2, K_ARR))))).to(i32)
    wait0 = _w(p4, W_FIELDSCAN, _w(p8 | p9, W_IDX, W_ELEMS)).to(i32)
    cpi0 = _w(p5, child_pi + 2, _w(c_flat, child_pi, child_pi + 1))
    chst0 = _w(p4 | p9, child_style,
               _w(p6, _w(child_style == S_RAW, S_QUOTED,
                         S_FLATTEN).to(i32),
                  _w(p7 | p8, S_QUOTED, S_FLATTEN).to(i32)))  # 2/5: FLATTEN
    upd["k_kind"] = _w(pushm, kind[:, None], upd["k_kind"])
    upd["k_wait"] = _w(pushm, wait0[:, None], upd["k_wait"])
    upd["k_cpi"] = _w(pushm, cpi0[:, None], upd["k_cpi"])
    upd["k_cnt"] = _w(pushm, ins_ix[:, None], upd["k_cnt"])
    upd["k_depth"] = _w(pushm, lvl[:, None], upd["k_depth"])
    upd["k_dirty"] = _w(pushm, 0, upd["k_dirty"])
    upd["k_chstyle"] = _w(pushm, chst0[:, None], upd["k_chstyle"])
    upd["sp"] = _w(do_push, sp + 1, upd["sp"])
    # case 5/7 write their '[' at first enter (with parent comma)
    open_arr57 = p5 | p7
    upd["g_adep"] = _w(open_arr57, st["g_adep"] + 1, upd["g_adep"])
    upd["g_empty"] = upd["g_empty"] | open_arr57
    # case 6: buffer child output behind a 2-byte gap [',', '['] whose keep
    # flags resolve at END (write_child_raw_value's insert logic)
    push6 = pushm & p6[:, None]
    upd["k_sadep"] = _w(push6, st["g_adep"][:, None], upd["k_sadep"])
    upd["k_sempty"] = _w(push6, st["g_empty"][:, None], upd["k_sempty"])
    upd["k_gap"] = _w(push6, j, upd["k_gap"])
    upd["g_adep"] = _w(p6, 1, upd["g_adep"])
    upd["g_empty"] = upd["g_empty"] | p6

    # ---- FIELD events ---------------------------------------------------
    fieldev = evnorm & (ev_a == EV_FIELD) & has_ctx \
        & (top_wait == W_FIELDSCAN)
    name_ins = (top_cpi - 1).clamp(0, pmax).long()  # case 4's instruction
    name_len = pnamelens[name_ins]
    name_match = st["fm_ok"] & (st["fm_pos"] == name_len)
    upd["k_wait"] = _w((fieldev & name_match)[:, None] & top_sel, W_VALUE,
                       upd["k_wait"])
    upd["k_wait"] = _w((fieldev & ~name_match)[:, None] & top_sel,
                       W_SKIPVAL, upd["k_wait"])

    # ---- field-name matching accumulators (during string scan) ---------
    scanning_field = ev_alive & (st["evm"] == EVM_NORM) & st["sfield"] \
        & has_ctx & (top_wait == W_FIELDSCAN)
    nm_w = pnames.shape[1]
    want = pnames.reshape(-1)[name_ins * nm_w
                              + st["fm_pos"].clamp(0, nm_w - 1).long()]
    unit_raw = scanning_field & content
    dec = device_table("json_esc_decode", dev)[c.long()]
    unit_esc = scanning_field & me & esc_short
    unit = _w(unit_esc, dec, c)
    has_unit = unit_raw | unit_esc
    ok_unit = has_unit & (st["fm_pos"] < name_len) & (unit == want)
    new_fmok2 = new_fmok & ~(has_unit & ~ok_unit)
    # the reference never matches a field containing a \uXXXX escape
    new_fmok2 = new_fmok2 & ~(scanning_field & esc_u)
    new_fmpos2 = new_fmpos + has_unit.to(i32)

    # ---- phase B: END events under NORM --------------------------------
    # A number can complete on the same char as its container's close
    # (phase A then phase B in one step), so wait/dirty must be read AFTER
    # phase A's updates.
    top_wait_b = top_get(upd["k_wait"])
    top_dirty_b = top_get(upd["k_dirty"])
    endev = evnorm & (ev_b != EB_NONE)
    lvl_closed = new_depth  # after decrement == level of the closed one
    on_top = endev & has_ctx & (top_depth == lvl_closed)
    # case 8/9 W_IDX: array ended before the target index -> row fails
    upd["ev_fail"] = upd["ev_fail"] | (on_top & (top_kind == K_ARR)
                                       & (top_wait_b == W_IDX))
    iter_kind = (top_kind == K2) | (top_kind == K5) | (top_kind == K6) \
        | (top_kind == K7)
    # case 6 finishing with nothing written: reference leaves the context
    # unfinished and errors out on the next dispatch -> row is null
    end6 = on_top & (top_kind == K6)
    upd["ev_fail"] = upd["ev_fail"] | (end6 & (top_dirty_b == 0))
    pop = on_top & (
        ((top_kind == K_OBJ) & ((top_wait_b == W_FIELDSCAN)
                                | (top_wait_b == W_SKIPREST)))
        | ((top_kind == K_ARR) & (top_wait_b == W_SKIPREST))
        | iter_kind)
    # case 5/7 close their bracket; case 6 commits its buffered child
    end57 = on_top & ((top_kind == K5) | (top_kind == K7))
    upd["g_adep"] = _w(end57, upd["g_adep"] - 1, upd["g_adep"])
    upd["g_empty"] = upd["g_empty"] & ~end57
    par_nc = (top_sadep > 0) & ~top_sempty
    commit6 = end6 & (top_dirty_b > 0)
    upd["g_adep"] = _w(commit6, top_sadep, upd["g_adep"])
    upd["g_empty"] = upd["g_empty"] & ~commit6
    patch_tgt = _w(commit6, top_gap, torch.full_like(top_gap, -1))
    patch_k0 = commit6 & par_nc
    patch_k1 = commit6 & (top_dirty_b > 1)

    pop_dirty = _w(pop, top_dirty_b, torch.zeros_like(top_dirty_b))
    upd["sp"] = _w(pop, upd["sp"] - 1, upd["sp"])
    # route the popped dirty to the NEW top (the expecting slot below)
    sp2 = upd["sp"]
    top_sel2 = slot == (sp2 - 1)[:, None]
    has_ctx2 = sp2 > 0
    top_ix2 = (sp2 - 1).clamp(0, D - 1).long()[:, None]
    top_in2 = has_ctx2 & (sp2 <= D)
    top_wait2 = top_get(upd["k_wait"], top_ix2, top_in2)

    value_done(pop, pop_dirty, top_sel2, top_wait2, has_ctx2)

    # ---- COPY / SKIP mode exits ----------------------------------------
    inmode = ev_alive & (st["evm"] != EVM_NORM)
    mode_exit = inmode & (ev_b != EB_NONE) & (new_depth == st["base_depth"])
    exit_copy = mode_exit & (st["evm"] == EVM_COPY)
    exit_skip = mode_exit & (st["evm"] == EVM_SKIP)
    upd["evm"] = _w(mode_exit, EVM_NORM, upd["evm"])
    # copy completion = value_done(1) on the expecting slot
    value_done(exit_copy, exit_copy.to(i32), top_sel2, top_wait2, has_ctx2)
    # skip completion: route by the expecting slot's wait state
    sk_v = exit_skip & has_ctx2 & (top_wait2 == W_SKIPVAL)
    upd["k_wait"] = _w(sk_v[:, None] & top_sel2, W_FIELDSCAN, upd["k_wait"])
    sk_i = exit_skip & has_ctx2 & (top_wait2 == W_IDX)
    sk_i_consume = sk_i & (top_get(upd["k_cnt"], top_ix2, top_in2) > 0)
    upd["k_cnt"] = _w(sk_i_consume[:, None] & top_sel2, upd["k_cnt"] - 1,
                      upd["k_cnt"])
    # skip of a mismatched target (case 12) -> value_done(0)
    sk_tgt = exit_skip & (sk_i & ~sk_i_consume
                          | (has_ctx2 & ((top_wait2 == W_VALUE)
                                         | (top_wait2 == W_ELEMS)))
                          | ~has_ctx2)
    value_done(sk_tgt, torch.zeros((n,), dtype=i32, device=dev), top_sel2,
               top_wait2, has_ctx2)

    upd["ev_fail"] = upd["ev_fail"] | tok_err

    # ======================================================================
    # emissions
    # ======================================================================
    copying = ev_alive & (st["evm"] == EVM_COPY)
    # matched terminal starting now? set per-char emit flags for str/lit
    tgt_now = evnorm & expect_target & matched & ~expect_skip
    t_str_start = tgt_now & sq
    t_lit_start = tgt_now & lit
    t_start = t_str_start | t_lit_start
    new_term_emit = (st["term_emit"] | t_start) & ~(quote_close | lit_done)
    term_emitting = st["term_emit"] | t_start
    # terminal style: RAW -> bare/unescaped (case 1); QUOTED/FLATTEN ->
    # escaped with quotes (case 3 on a terminal)
    t_esc_now = child_style != S_RAW
    term_esc = _w(t_start, t_esc_now, st["term_esc"])

    in_str_emit = (copying | term_emitting) & (ms | me | mu | sq | fq)
    esc_style = copying | (term_emitting & term_esc)

    sf = torch.zeros((n,), dtype=i32, device=dev)
    sf = _w(in_str_emit & content, SF_CONTENT, sf)
    sf = _w(in_str_emit & me & esc_short, SF_ESCCHAR, sf)
    sf = _w(in_str_emit & uhex_done, SF_UHEXLAST, sf)
    sf = _w(esc_style & in_str_emit & (sq | fq | quote_close), SF_QUOTE, sf)

    # self-emission: copy-mode structural chars + literal chars.  The
    # copied container's own '{'/'[' arrives on the step that ENTERS copy
    # mode (evm still NORM in the carry), hence copying | c_copy.
    copying_now = copying | c_copy
    self_emit = copying_now & (open_obj | open_arr | close_o | close_a
                               | obj_close | arr_close | comma | col
                               | (ml & lit_ok))
    # a literal's first char ('t'/'f'/'n') arrives while still in M_VALUE
    self_emit = self_emit | (copying & lit) | t_lit_start
    self_emit = self_emit | (term_emitting & ml & lit_ok)

    # number emission: at EV_NUM when copying or matched target
    num_emit = (ev_a == EV_NUM) & (copying | tgt_now)
    int_emit = num_emit & ~ev_num_float
    # "-0" normalizes to "0" (write_unescaped_text, json_parser.cuh:1420)
    is_neg0 = int_emit & (ev_span_len == 2) & st["neg0"]
    src_start = _w(is_neg0, ev_span_start + 1, ev_span_start)
    src_len = _w(int_emit, _w(is_neg0, torch.ones_like(ev_span_len),
                              ev_span_len), torch.zeros_like(ev_span_len))
    flt_emit = num_emit & ev_num_float
    fidx = _w(flt_emit, st["nfloat"], torch.full_like(st["nfloat"], -1))
    new_nfloat = st["nfloat"] + flt_emit.to(i32)
    new_neg0 = _w(num0, eq("-"), st["neg0"])
    new_neg0 = new_neg0 & ~(mnum & is_digit & (eff_mode != M_NUM_SIGN))
    new_neg0 = new_neg0 & ~(mnum & (eff_mode == M_NUM_SIGN) & ~eq("0"))

    # generator writes in NORM mode: a leading comma where needed, and the
    # '[' of case 5/7.  Writes happen at: terminal string/literal starts,
    # number completions, copy entries, case 5/7/6 pushes, case 6 commits.
    write_evt = t_start | (num_emit & ~copying) | c_copy | open_arr57
    # case 6's committing comma lives in its gap slot, not here
    pre_comma = write_evt & gnc & ~open_arr57
    upd["g_empty"] = upd["g_empty"] & ~(write_evt & ~open_arr57 & ~p6)
    u8 = torch.uint8
    zero8 = torch.zeros((n,), dtype=u8, device=dev)
    pre_b0 = _w(pre_comma | open_arr57 | p6, torch.full_like(zero8, ord(",")),
                zero8)
    pre_b1 = _w(open_arr57 | p6, torch.full_like(zero8, ord("[")), zero8)
    pre_k0 = pre_comma | (open_arr57 & gnc)   # gap steps resolve via patch
    pre_k1 = open_arr57
    pre_gap = p6
    # case 5/7/6-commit closing bracket emits after this step's content
    post_br = end57 | (commit6 & (top_dirty_b > 1))

    ys = {
        "sf": sf.to(u8),
        "esc": esc_style,
        "self": self_emit,
        "src_start": src_start.to(i32),
        "src_len": src_len.to(i32),
        "fidx": fidx.to(i32),
        "fstart": _w(flt_emit, ev_span_start,
                     torch.full_like(ev_span_start, -1)).to(i32),
        "flen": _w(flt_emit, ev_span_len,
                   torch.zeros_like(ev_span_len)).to(i32),
        "pre_b0": pre_b0,
        "pre_b1": pre_b1,
        "pre_k0": pre_k0,
        "pre_k1": pre_k1,
        "pre_gap": pre_gap,
        "post_br": post_br,
        "patch_tgt": patch_tgt.to(i32),
        "patch_k0": patch_k0,
        "patch_k1": patch_k1,
    }
    if events:
        ys.update(ev_a=ev_a.to(i32), ev_b=ev_b.to(i32),
                  span_s=ev_span_start.to(i32),
                  span_len=ev_span_len.to(i32))

    out = {
        "mode": new_mode, "depth": new_depth,
        "cstack_lo": clo, "cstack_hi": chi,
        "allow_close": new_allow_close, "quote": new_quote,
        "sfield": new_sfield, "tok_start": new_tok,
        "ndig": new_ndig, "numf": new_numf, "ucnt": new_ucnt,
        "lit_id": new_lid, "lit_pos": new_lpos,
        "length": st["length"],
        "fm_ok": new_fmok2, "fm_pos": new_fmpos2,
        "term_emit": new_term_emit, "term_esc": term_esc,
        "nfloat": new_nfloat, "neg0": new_neg0,
        **upd,
    }
    # keep every carry lane in its own dtype (scalar selects promote)
    out = {k: v if v.dtype == st[k].dtype else v.to(st[k].dtype)
           for k, v in out.items()}
    return out, ys


def _stack_push(lo, hi, depth, is_obj, do):
    """Set bit `depth` of the 64-bit (lo, hi) stack to is_obj where do.
    Each half is a u32 lane in an int64 carrier."""
    in_lo = depth < 32
    one = torch.ones_like(lo)
    zero = torch.zeros_like(lo)
    bit_lo = _w(do & in_lo, one << depth.clamp(0, 31).to(torch.int64), zero)
    bit_hi = _w(do & ~in_lo, one << (depth - 32).clamp(0, 31).to(
        torch.int64), zero)
    lo = _w(do & in_lo & is_obj, lo | bit_lo, lo & ~bit_lo)
    hi = _w(do & ~in_lo & is_obj, hi | bit_hi, hi & ~bit_hi)
    return lo, hi


def _stack_top(lo, hi, depth):
    """Bit at level depth-1: True = object context."""
    d = (depth - 1).clamp(min=0).to(torch.int64)
    b_lo = (lo >> d.clamp(max=31)) & 1
    b_hi = (hi >> (d - 32).clamp(0, 31)) & 1
    return _w(d < 32, b_lo, b_hi) == 1


# ---------------------------------------------------------------------------
# output materialization
# ---------------------------------------------------------------------------

def _is_short_esc(c):
    return (c == 8) | (c == 9) | (c == 10) | (c == 12) | (c == 13)


def _hex_val(c):
    c = c.to(torch.int32)
    return _w(c >= ord("a"), c - ord("a") + 10,
              _w(c >= ord("A"), c - ord("A") + 10, c - ord("0")))


def _hex4(prev3, c4):
    """Decode 4 hex chars: prev3 = [p-3, p-2, p-1] stacked last axis."""
    return ((_hex_val(prev3[..., 0]) << 12) | (_hex_val(prev3[..., 1]) << 8)
            | (_hex_val(prev3[..., 2]) << 4) | _hex_val(c4))


def _utf8_width(cp):
    return _w(cp < 0x80, 1, _w(cp < 0x800, 2, 3))


def _str_emit_len(chars_at, prev3, flag, esc):
    """Per-position emission length for the string channel.

    chars_at: the source char at the position; prev3: chars at p-3..p-1
    (for \\uXXXX decode, p is the 4th hex digit).
    """
    c = chars_at.to(torch.int32)
    # SF_CONTENT
    ctrl = c < 32
    content_esc = _w(c == ord('"'), 2, _w(ctrl & _is_short_esc(c), 2,
                                          _w(ctrl, 6, 1)))
    content_len = _w(esc, content_esc, 1)
    # SF_ESCCHAR
    two = ((c == ord('"')) | (c == 0x5C) | (c == ord("b")) | (c == ord("f"))
           | (c == ord("n")) | (c == ord("r")) | (c == ord("t")))
    escchar_len = _w(esc & two, 2, 1)
    # SF_UHEXLAST: UTF-8 width of the decoded code point
    uhex_len = _utf8_width(_hex4(prev3, c))
    out = _w(flag == SF_CONTENT, content_len,
             _w(flag == SF_ESCCHAR, escchar_len,
                _w(flag == SF_UHEXLAST, uhex_len,
                   _w(flag == SF_QUOTE, 1, 0))))
    return out.to(torch.int32)


def _str_emit_byte(c, prev3, flag, esc, off):
    """Byte `off` of the string-channel emission at a position."""
    dev = c.device
    c32 = c.to(torch.int32)
    # SF_CONTENT bytes
    ctrl = c32 < 32
    short = _is_short_esc(c32)
    hexlo = _w(c32 % 16 < 10, ord("0") + c32 % 16, ord("A") + c32 % 16 - 10)
    u6 = _w(off == 0, ord("\\"), _w(off == 1, ord("u"), _w(
        (off == 2) | (off == 3), ord("0"), _w(
            off == 4, _w(c32 >= 16, ord("1"), ord("0")), hexlo))))
    short_code = device_table("json_short_esc", dev)[(c32 % 32).long()].to(
        torch.int32)
    content_esc = _w(
        c32 == ord('"'), _w(off == 0, ord("\\"), ord('"')),
        _w(ctrl & short, _w(off == 0, ord("\\"), short_code),
           _w(ctrl, u6, c32)))
    content_b = _w(esc, content_esc, c32)
    # SF_ESCCHAR bytes
    dec = device_table("json_esc_decode", dev)[c.long()].to(torch.int32)
    esc2 = _w(off == 0, ord("\\"),
              _w(c32 == ord('"'), ord('"'), _w(c32 == 0x5C, ord("\\"), c32)))
    two = ((c32 == ord('"')) | (c32 == 0x5C) | (c32 == ord("b"))
           | (c32 == ord("f")) | (c32 == ord("n")) | (c32 == ord("r"))
           | (c32 == ord("t")))
    escchar_b = _w(esc & two, esc2, dec)
    # SF_UHEXLAST: UTF-8 bytes of code point
    cp = _hex4(prev3, c)
    w = _utf8_width(cp)
    b0 = _w(w == 1, cp, _w(w == 2, 0xC0 | (cp >> 6), 0xE0 | (cp >> 12)))
    b1 = _w(w == 2, 0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F))
    b2 = 0x80 | (cp & 0x3F)
    uhex_b = _w(off == 0, b0, _w(off == 1, b1, b2))
    out = _w(flag == SF_CONTENT, content_b,
             _w(flag == SF_ESCCHAR, escchar_b,
                _w(flag == SF_UHEXLAST, uhex_b, ord('"'))))
    return out.to(torch.uint8)


def _materialize(chars, ys, fail, float_bytes, float_lens, max_out):
    """ys [n, L+1] directive tensors -> (out_chars [n, max_out], out_lens)."""
    n, L1 = ys["sf"].shape
    dev = chars.device
    i32 = torch.int32
    # chars padded with one EOF column to align with L+1 steps
    cpad = torch.cat([chars, torch.zeros((n, 1), dtype=chars.dtype,
                                         device=dev)], dim=1)

    def shifted(k):
        out = torch.zeros_like(cpad)
        out[:, k:] = cpad[:, :L1 - k]
        return out

    prev3 = torch.stack([shifted(k) for k in (3, 2, 1)], dim=-1)
    # resolve case-6 gap keeps: patch events scatter onto their gap steps
    pvalid = ys["patch_tgt"] >= 0
    ptgt = _w(pvalid, ys["patch_tgt"].clamp(0, L1 - 1),
              torch.full_like(ys["patch_tgt"], L1)).long()
    zb = torch.zeros((n, L1 + 1), dtype=torch.bool, device=dev)
    gk0 = zb.scatter(1, ptgt, ys["patch_k0"])[:, :L1]
    gk1 = zb.scatter(1, ptgt, ys["patch_k1"])[:, :L1]
    pre_k0 = _w(ys["pre_gap"], gk0, ys["pre_k0"])
    pre_k1 = _w(ys["pre_gap"], gk1, ys["pre_k1"])
    pre_len = pre_k0.to(i32) + pre_k1.to(i32)
    post_len = ys["post_br"].to(i32)
    sf = ys["sf"].to(i32)
    slen = _w(sf > 0, _str_emit_len(cpad, prev3, sf, ys["esc"]),
              torch.zeros_like(sf))
    F = float_lens.shape[1]
    has_f = ys["fidx"] >= 0
    fidx_c = ys["fidx"].clamp(0, F - 1).long()
    flen = _w(has_f, torch.gather(float_lens, 1, fidx_c),
              torch.zeros_like(sf))
    step_len = (pre_len + slen + ys["src_len"] + flen
                + ys["self"].to(i32) + post_len)
    step_len = _w(fail[:, None], torch.zeros_like(step_len), step_len)
    cum = torch.cumsum(step_len, dim=1, dtype=i32)
    total = cum[:, -1]

    pos = torch.arange(max_out, dtype=i32, device=dev)[None, :]
    # emitting step for each output byte: first step with cum > pos
    step = torch.searchsorted(cum.contiguous(),
                              pos.expand(n, max_out).contiguous(),
                              right=True).clamp(0, L1 - 1)
    cum0 = torch.cat([torch.zeros((n, 1), dtype=i32, device=dev), cum],
                     dim=1)
    base = torch.gather(cum0, 1, step)
    off = pos - base

    def g(a):
        return torch.gather(a, 1, step)

    sf_s = g(sf)
    esc_s = g(ys["esc"])
    slen_s = g(slen)
    srcs_s = g(ys["src_start"])
    srcl_s = g(ys["src_len"])
    fidx_s = g(ys["fidx"])
    flen_s = g(flen)
    c_s = g(cpad)
    prek0_s = g(pre_k0)
    preb0_s = g(ys["pre_b0"])
    preb1_s = g(ys["pre_b1"])
    prel_s = g(pre_len)
    self_s = g(ys["self"].to(i32))
    prev3_s = torch.stack([g(prev3[..., k]) for k in range(3)], dim=-1)

    off2 = off - prel_s
    in_pre = off < prel_s
    in_str = ~in_pre & (off2 < slen_s)
    in_src = ~in_pre & ~in_str & (off2 < slen_s + srcl_s)
    in_flt = ~in_pre & ~in_str & ~in_src & (off2 < slen_s + srcl_s + flen_s)
    in_self = (~in_pre & ~in_str & ~in_src & ~in_flt
               & (off2 < slen_s + srcl_s + flen_s + self_s))

    b_pre = _w((off == 0) & prek0_s, preb0_s, preb1_s)
    b_str = _str_emit_byte(c_s, prev3_s, sf_s, esc_s, off2)
    src_pos = (srcs_s + (off2 - slen_s)).clamp(0, chars.shape[1] - 1)
    b_src = torch.gather(cpad, 1, src_pos.long())
    # the float byte: row i's float fidx at offset k, through a flat view
    FB = float_bytes.shape[2]
    fflat = float_bytes.reshape(n, F * FB)
    fk = (off2 - slen_s - srcl_s).clamp(0, FLOAT_W - 1)
    b_flt = torch.gather(fflat, 1,
                         (fidx_s.clamp(0, F - 1) * FB + fk).long())
    bracket = torch.full_like(c_s, ord("]"))
    out = _w(in_pre, b_pre, _w(in_str, b_str, _w(in_src, b_src, _w(
        in_flt, b_flt, _w(in_self, c_s, bracket)))))
    out = _w(pos < total[:, None], out, torch.zeros_like(out))
    # a row overflowing the buffer cannot be represented: null it rather
    # than return a silently truncated string
    total = _w(total > max_out, torch.full_like(total, -1), total)
    return out, total


def _format_floats(chars, fstarts, flens, F):
    """Parse + Java-format the float tokens: returns (bytes [n,F,28], lens).

    The Spark cast kernel this reuses reads at most 4 exponent digits
    (matching ``cast_string_to_float.cu:523``), but JSON normalization
    follows stod: any exponent length is legal, saturating to ±Inf / 0.
    So the exponent is canonicalized first — leading zeros stripped and
    values beyond 4 digits clamped to ±9999 (anything past ±9999 is far
    beyond double range, so the clamp is value-preserving).
    """
    n, L = chars.shape
    dev = chars.device
    i32 = torch.int32
    W = min(L, 326)
    cpad = torch.cat([chars, torch.zeros((n, W), dtype=chars.dtype,
                                         device=dev)], dim=1)
    # substring extraction: gather a [n, F, W] window per float token
    idx = fstarts.clamp(0, L)[..., None] + torch.arange(W, dtype=i32,
                                                        device=dev)
    win = torch.gather(cpad, 1, idx.clamp(0, L + W - 1).reshape(
        n, F * W).long()).reshape(n, F, W)
    inlen = flens.clamp(0, W)
    pos = torch.arange(W, dtype=i32, device=dev)[None, None, :]
    mask = pos < inlen[..., None]
    zero8 = torch.zeros((), dtype=torch.uint8, device=dev)
    win = _w(mask, win, zero8)

    # canonicalize the exponent: [mantissa] 'e' sign DDDD (4 digits)
    is_e = ((win == ord("e")) | (win == ord("E"))) & mask
    e_pos = _w(is_e, pos, W).amin(dim=2)
    has_e = e_pos < inlen

    def at(p):
        return torch.gather(win, 2, p.clamp(0, W - 1)[..., None].long()
                            )[..., 0]

    sgn_c = at(e_pos + 1)
    has_sign = (sgn_c == ord("+")) | (sgn_c == ord("-"))
    neg = sgn_c == ord("-")
    d_start = e_pos + 1 + has_sign.to(i32)
    # first non-'0' digit of the run
    in_run = (pos >= d_start[..., None]) & mask
    nz = in_run & (win != ord("0"))
    nz_start = _w(nz, pos, W).amin(dim=2)
    sig = _w(nz_start >= inlen, torch.zeros_like(inlen), inlen - nz_start)
    d0, d1, d2, d3 = (at(nz_start), at(nz_start + 1), at(nz_start + 2),
                      at(nz_start + 3))

    def dv(c, k):
        # the u8 difference the reference forms, then int32
        d = (c.to(i32) - ord("0")) & 0xFF
        return _w(sig > k, d, torch.zeros_like(d))

    val4 = (dv(d0, 0) * _w(sig > 3, 1000, _w(sig > 2, 100,
                                              _w(sig > 1, 10, 1)))
            + dv(d1, 1) * _w(sig > 3, 100, _w(sig > 2, 10, 1))
            + dv(d2, 2) * _w(sig > 3, 10, 1) + dv(d3, 3))
    eval_ = _w(sig > 4, 9999, val4)
    # rebuild: chars past e_pos replaced by canonical exponent
    W2 = W + 6
    winp = torch.cat([win, torch.zeros((n, F, 6), dtype=win.dtype,
                                       device=dev)], dim=2)
    pos2 = torch.arange(W2, dtype=i32, device=dev)[None, None, :]
    rel = pos2 - e_pos[..., None]
    edig = [((eval_ // p) % 10 + ord("0")).to(torch.uint8)[..., None]
            for p in (1000, 100, 10, 1)]
    sign_ch = _w(neg, ord("-"), ord("+")).to(torch.uint8)[..., None]
    canon = _w(rel == 0, ord("e"),
               _w(rel == 1, sign_ch,
                  _w(rel == 2, edig[0],
                     _w(rel == 3, edig[1],
                        _w(rel == 4, edig[2],
                           _w(rel == 5, edig[3], zero8))))))
    use_canon = has_e[..., None] & (rel >= 0) & (rel < 6)
    win2 = _w(use_canon, canon, winp)
    len2 = _w(has_e, e_pos + 6, inlen)
    win2 = _w(pos2 < len2[..., None], win2, zero8)

    sc = StringColumn(win2.reshape(n * F, W2), len2.reshape(n * F),
                      torch.ones((n * F,), dtype=torch.bool, device=dev))
    vals = cast_string.string_to_float(sc, T.FLOAT64)
    fb, fl = float_to_string.double_to_json_string(vals.data)
    return fb.reshape(n, F, -1), fl.reshape(n, F).to(i32)


def _init_carry(lengths, n, dev):
    i32 = torch.int32
    D = MAX_PATH + 1

    def z(dtype=i32, shape=(n,)):
        return torch.zeros(shape, dtype=dtype, device=dev)

    b = torch.bool
    return {
        "mode": torch.full((n,), M_VALUE, dtype=i32, device=dev),
        "depth": z(), "cstack_lo": z(torch.int64), "cstack_hi": z(torch.int64),
        "allow_close": z(b), "quote": z(torch.uint8), "sfield": z(b),
        "tok_start": z(), "ndig": z(), "numf": z(b), "ucnt": z(),
        "lit_id": z(), "lit_pos": z(), "length": lengths.to(i32),
        "fm_ok": z(b), "fm_pos": z(), "term_emit": z(b), "term_esc": z(b),
        "nfloat": z(), "neg0": z(b),
        "evm": torch.full((n,), EVM_NORM, dtype=i32, device=dev),
        "base_depth": z(), "sp": z(),
        "root_wait": torch.ones((n,), dtype=b, device=dev),
        "root_dirty": z(), "ev_done": z(b), "ev_fail": z(b),
        "g_adep": z(), "g_empty": torch.ones((n,), dtype=b, device=dev),
        "k_kind": z(shape=(n, D)), "k_wait": z(shape=(n, D)),
        "k_cpi": z(shape=(n, D)), "k_cnt": z(shape=(n, D)),
        "k_depth": z(shape=(n, D)), "k_dirty": z(shape=(n, D)),
        "k_chstyle": z(shape=(n, D)), "k_sadep": z(shape=(n, D)),
        "k_sempty": z(b, (n, D)), "k_gap": z(shape=(n, D)),
    }


def _run(col_chars, col_lengths, col_validity, path_tuple, max_out):
    """The scan machine over every row: one step per char column."""
    instructions = list(path_tuple)
    n, L = col_chars.shape
    dev = col_chars.device
    i32 = torch.int32
    ptypes, pindexes, pnames, pnamelens, P = _pack_path(
        tuple(instructions), dev)
    HOST_SYNCS["scan_runs"] += 1
    HOST_SYNCS["scan_rows"] += n

    carry = _init_carry(col_lengths, n, dev)
    cpad_t = torch.cat([col_chars, torch.zeros((n, 1), dtype=col_chars.dtype,
                                               device=dev)], dim=1).t()
    steps = []
    for j in range(L + 1):
        carry, y = _step(P, ptypes, pindexes, pnames, pnamelens, carry, j,
                         cpad_t[j])
        steps.append(y)
    ys = {k: torch.stack([y[k] for y in steps], dim=1) for k in steps[0]}

    ok = carry["ev_done"] & ~carry["ev_fail"] & (carry["root_dirty"] > 0)
    fail = ~ok

    F = max(1, min(L, 1 + L // 4))
    # float span table: scatter the (rare) float events into [n, F]
    fvalid = ys["fidx"] >= 0
    fslot = _w(fvalid, ys["fidx"].clamp(0, F - 1),
               torch.full_like(ys["fidx"], F)).long()
    zf = torch.zeros((n, F + 1), dtype=i32, device=dev)
    fstarts = zf.scatter(1, fslot, _w(fvalid, ys["fstart"],
                                      torch.zeros_like(ys["fstart"])))[:, :F]
    flens_src = zf.scatter(1, fslot, _w(fvalid, ys["flen"],
                                        torch.zeros_like(ys["flen"])))[:, :F]
    float_bytes, float_lens = _format_floats(col_chars, fstarts, flens_src, F)

    out_chars, out_lens = _materialize(
        col_chars, ys, fail, float_bytes, float_lens, max_out)
    valid = col_validity & ok & (out_lens >= 0)
    return out_chars, _w(valid, out_lens, torch.zeros_like(out_lens)), valid


def _run_hybrid(col_chars, col_lengths, col_validity, path_tuple, max_out):
    """Bit-parallel fast path with whole-batch scan-machine fallback: if
    ANY row flags, the whole batch runs the scan machine (one host read).
    The ``json_fallback_div=0`` engine; the default routing is
    :func:`_run_hybrid_compact`, which scans only the flagged rows."""
    from . import json_fast

    fast_c, fast_l, fast_ok, fb = json_fast.fast_path(
        col_chars, col_lengths, col_validity, path_tuple, max_out)
    HOST_SYNCS["n_flagged"] += 1
    if bool(fb.any()):
        return _run(col_chars, col_lengths, col_validity, path_tuple,
                    max_out)
    return fast_c, fast_l, fast_ok


def _run_hybrid_compact(col_chars, col_lengths, col_validity, path_tuple,
                        max_out, cap=0):
    """Fast path + fixed-capacity per-row fallback compaction.

    Flagged rows are compacted: after one host read of their count, a
    host loop of ``ceil(n_flagged / cap)`` iterations gathers up to
    ``cap`` flagged rows a time into a ``[cap, L]`` sub-batch, runs the
    scan machine on it, and scatters the results back over the fast
    engine's output: zero iterations for a clean batch, one for the
    common low-dirty case, ``ceil(n / cap)`` when every row is dirty.
    The scan machine stays the semantics of every flagged row
    (``get_json_object.cu:360-420``'s per-row parser is the oracle for
    both engines).
    """
    from . import json_fast

    n, L = col_chars.shape
    dev = col_chars.device
    C = int(cap) if cap and cap > 0 else n
    C = max(1, min(C, n))

    fast_c, fast_l, fast_ok, fb = json_fast.fast_path(
        col_chars, col_lengths, col_validity, path_tuple, max_out)
    HOST_SYNCS["n_flagged"] += 1
    nfb = int(fb.sum())
    if nfb == 0:
        return fast_c, fast_l, fast_ok
    iters = -(-nfb // C)
    # the flagged rows' indices in order, padded with n (a discard row)
    fbi = fb.to(torch.int64)
    ranks = torch.cumsum(fbi, dim=0) - fbi
    slots = iters * C
    flagged = torch.full((slots + 1,), n, dtype=torch.int64, device=dev)
    flagged.scatter_(0, _w(fb, ranks, torch.full_like(ranks, slots)),
                     torch.arange(n, dtype=torch.int64, device=dev))

    out_c = torch.cat([fast_c, torch.zeros((1, fast_c.shape[1]),
                                           dtype=fast_c.dtype, device=dev)])
    out_l = torch.cat([fast_l, torch.zeros((1,), dtype=fast_l.dtype,
                                           device=dev)])
    out_v = torch.cat([fast_ok, torch.zeros((1,), dtype=torch.bool,
                                            device=dev)])
    for r in range(iters):
        pos = flagged[r * C:(r + 1) * C]
        gpos = pos.clamp(max=n - 1)
        live = pos < n
        sc, sl, sv = _run(col_chars[gpos], col_lengths[gpos],
                          col_validity[gpos] & live, path_tuple, max_out)
        out_c[pos] = sc
        out_l[pos] = sl
        out_v[pos] = sv & live
    return out_c[:n], out_l[:n], out_v[:n]


def get_json_object(col, path: Union[str, Sequence], max_out: int = 0):
    """Evaluate a JSONPath against every row; invalid/no-match rows -> null.

    ``max_out`` pins the output char-matrix width (default 6*L+20 covers
    the worst-case escape expansion; lower it to trade memory when inputs
    are known tame — overlong results then clamp to null).

    A :class:`~..columnar.bucketed.BucketedStringColumn` input evaluates
    per bucket — each bucket's scan runs only that bucket's width — and
    returns a bucketed result (``.merge()`` for a flat column).

    Knobs: ``json_max_out``, ``json_fast_path``, ``json_fallback_div``
    and ``json_scan_unroll`` (accepted for the reference's surface; the
    loop here has no unroll and the value changes no result).
    """
    from .. import config
    from ..columnar.bucketed import BucketedStringColumn

    if isinstance(col, BucketedStringColumn):
        return col.apply(lambda b: get_json_object(b, path, max_out))
    instructions = parse_path(path) if isinstance(path, str) else list(path)
    if len(instructions) > MAX_PATH:
        raise ValueError(f"path deeper than {MAX_PATH}")
    L = col.max_len
    if max_out <= 0:
        max_out = config.get("json_max_out")
    if max_out <= 0:
        # provable worst case: every source byte expands to at most 6
        # output bytes (control char -> \u00XX in escaped style); floats
        # emit <= srclen+9; case-6 brackets add <=3 per '[' char
        max_out = 6 * L + 20
    use_fast = bool(config.get("json_fast_path")) and not any(
        i[0] == "wildcard" for i in instructions)
    args = (col.chars, col.lengths, col.validity, tuple(instructions),
            max_out)
    if use_fast:
        div = int(config.get("json_fallback_div"))
        if div > 0:
            n = col.chars.shape[0]
            out = _run_hybrid_compact(*args, cap=max(1, -(-n // div)))
        else:
            out = _run_hybrid(*args)
    else:
        out = _run(*args)
    out_chars, out_lens, valid = out
    return StringColumn(out_chars, out_lens, valid)
