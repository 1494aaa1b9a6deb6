"""Byte-level regular expressions compiled to dense DFAs.

The grammar-compilation substrate of on-device constrained decoding: the
port's own copy of the JAX package's ``constrain/regex_dfa.py``, unchanged
but for this paragraph. A pattern — hand-written, or lowered from a JSON
Schema by :mod:`.grammar` — becomes a dense
``[n_states, 256] -> next_state`` byte-transition table plus per-state
accept flags. :func:`.grammar.lift_to_tokens` then
walks every *token's* byte string through this table once, producing the
token-level DFA the decode chunk threads on device.

Bytes — not characters — are the alphabet because that is what tokenizers
emit: a multi-byte UTF-8 character split across two tokens must advance the
grammar state mid-character, and a byte DFA does that for free.

Supported syntax (a deliberate subset; anything else raises
:class:`GrammarError` at compile time, never mis-compiles silently):

  literals        UTF-8 encoded; metacharacters escaped with ``\\``
  ``.``           any byte except ``\\n``
  ``[...]``       byte classes: single-byte chars, ranges ``a-z``,
                  leading ``^`` negation, ``\\xHH`` escapes
  ``\\xHH \\n \\r \\t \\d \\w \\s``  escapes (classes expand to byte sets)
  ``(...)`` ``|``                 grouping, alternation
  ``* + ? {m} {m,} {m,n}``        repetition (bounded forms expand —
                                  keep bounds modest)

NFA construction is Thompson's, determinization is subset construction,
and the result is trimmed to *useful* states (reachable from start AND
able to reach an accept state) — the property the token-level lift relies
on to guarantee a constrained generation can never paint itself into a
dead end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class GrammarError(ValueError):
    """The grammar (regex or schema) cannot be compiled: unsupported
    syntax, malformed structure, or a size-cap blowout. Maps to HTTP 400
    (invalid_request_error)."""


class GrammarUnsatisfiable(GrammarError):
    """The grammar compiled but admits no completion under this tokenizer —
    every path from the start state dead-ends before an accept state (e.g.
    a required character has no producing token in the vocabulary). Maps
    to HTTP 422 (grammar_error): the request was well-formed, the
    (grammar, tokenizer) pair cannot be served."""


# A pathological schema (deep nesting x wide alternation) must fail fast,
# not OOM the server compiling a million-state automaton.
MAX_NFA_STATES = 50_000
MAX_DFA_STATES = 5_000
MAX_REPEAT = 1_000  # {m,n} expansion bound

NEWLINE = 0x0A
ANY_BYTE = frozenset(range(256))
DOT = frozenset(b for b in range(256) if b != NEWLINE)
DIGITS = frozenset(range(0x30, 0x3A))
WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F])
SPACE = frozenset(b" \t\r\n\f\v")


# ---- AST -------------------------------------------------------------------
#
# Nodes are plain tuples — tiny, hashable, easy to build programmatically
# from the schema lowering:
#   ("lit", bytes)                 the byte string, in sequence
#   ("class", frozenset[int])      one byte drawn from the set
#   ("seq", (node, ...))           concatenation
#   ("alt", (node, ...))           alternation
#   ("rep", node, lo, hi|None)     between lo and hi copies (None = inf)


def lit(text) -> tuple:
    """Literal node from str (UTF-8 encoded) or bytes."""
    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    return ("lit", data)


def cls(byte_set) -> tuple:
    s = frozenset(int(b) for b in byte_set)
    if not s or any(not 0 <= b <= 255 for b in s):
        raise GrammarError(f"invalid byte class: {sorted(byte_set)[:8]!r}")
    return ("class", s)


def seq(*nodes) -> tuple:
    flat = []
    for n in nodes:
        if n[0] == "seq":
            flat.extend(n[1])
        else:
            flat.append(n)
    if len(flat) == 1:
        return flat[0]
    return ("seq", tuple(flat))


def alt(*nodes) -> tuple:
    if not nodes:
        raise GrammarError("empty alternation")
    if len(nodes) == 1:
        return nodes[0]
    return ("alt", tuple(nodes))


def rep(node, lo: int, hi: "int | None") -> tuple:
    if lo < 0 or (hi is not None and (hi < lo or hi > MAX_REPEAT)) \
            or lo > MAX_REPEAT:
        raise GrammarError(f"repetition bounds out of range: {{{lo},{hi}}}")
    return ("rep", node, lo, hi)


def opt(node) -> tuple:
    return rep(node, 0, 1)


EPSILON = ("lit", b"")


# ---- pattern parser --------------------------------------------------------

_META = set("\\.[](){}|*+?")


class _Parser:
    """Recursive-descent parser for the supported pattern subset."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> GrammarError:
        return GrammarError(f"regex error at position {self.i}: {msg} "
                            f"(pattern {self.p!r})")

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def take(self) -> str:
        ch = self.peek()
        self.i += 1
        return ch

    def parse(self) -> tuple:
        node = self.alternation()
        if self.i != len(self.p):
            raise self.error(f"unexpected {self.peek()!r}")
        return node

    def alternation(self) -> tuple:
        branches = [self.concat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.concat())
        return alt(*branches)

    def concat(self) -> tuple:
        parts = []
        while self.peek() and self.peek() not in "|)":
            parts.append(self.repeat())
        if not parts:
            return EPSILON
        return seq(*parts)

    def repeat(self) -> tuple:
        node = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                node = rep(node, 0, None)
            elif ch == "+":
                self.take()
                node = rep(node, 1, None)
            elif ch == "?":
                self.take()
                node = rep(node, 0, 1)
            elif ch == "{":
                node = rep(node, *self.bounds())
            else:
                return node

    def bounds(self) -> tuple:
        assert self.take() == "{"
        spec = ""
        while self.peek() and self.peek() != "}":
            spec += self.take()
        if self.take() != "}":
            raise self.error("unterminated {m,n}")
        try:
            if "," not in spec:
                lo = hi = int(spec)
            else:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s.strip() else None
        except ValueError:
            raise self.error(f"malformed bounds {{{spec}}}") from None
        return lo, hi

    def atom(self) -> tuple:
        ch = self.peek()
        if not ch:
            raise self.error("dangling operator")
        if ch == "(":
            self.take()
            node = self.alternation()
            if self.take() != ")":
                raise self.error("unbalanced parenthesis")
            return node
        if ch == "[":
            return self.char_class()
        if ch == ".":
            self.take()
            return ("class", DOT)
        if ch == "\\":
            return self.escape(in_class=False)
        if ch in "*+?{":
            raise self.error(f"nothing to repeat before {ch!r}")
        if ch in ")]}|":
            raise self.error(f"unexpected {ch!r}")
        self.take()
        return lit(ch)

    def escape(self, in_class: bool):
        assert self.take() == "\\"
        ch = self.take()
        if not ch:
            raise self.error("dangling backslash")
        if ch == "x":
            hexs = self.take() + self.take()
            try:
                b = int(hexs, 16)
            except ValueError:
                raise self.error(f"malformed \\x{hexs}") from None
            return b if in_class else lit(bytes([b]))
        simple = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B,
                  "0": 0x00}
        if ch in simple:
            return simple[ch] if in_class else lit(bytes([simple[ch]]))
        classes = {"d": DIGITS, "w": WORD, "s": SPACE}
        if ch in classes:
            return classes[ch] if in_class else ("class", classes[ch])
        if ch in _META or ch in "-^/\"'":
            b = ord(ch)
            if b > 255:
                raise self.error(f"cannot escape non-byte char {ch!r}")
            return b if in_class else lit(bytes([b]))
        raise self.error(f"unsupported escape \\{ch}")

    def char_class(self) -> tuple:
        assert self.take() == "["
        negate = False
        if self.peek() == "^":
            negate = True
            self.take()
        members: set[int] = set()

        def one() -> "int | frozenset":
            c = self.peek()
            if c == "\\":
                return self.escape(in_class=True)
            self.take()
            b = ord(c)
            if b > 255:
                raise self.error(
                    f"non-byte character {c!r} in class (classes are "
                    "byte-level; use explicit \\xHH bytes for UTF-8)")
            return b

        while self.peek() and self.peek() != "]":
            lo = one()
            if isinstance(lo, frozenset):
                members |= lo
                continue
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hi = one()
                if isinstance(hi, frozenset) or hi < lo:
                    raise self.error("malformed class range")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        if self.take() != "]":
            raise self.error("unterminated character class")
        if negate:
            members = set(ANY_BYTE) - members
        if not members:
            raise self.error("empty character class")
        return ("class", frozenset(members))


def parse(pattern: str) -> tuple:
    """Pattern string → AST node. Raises :class:`GrammarError` on anything
    outside the supported subset."""
    if not isinstance(pattern, str) or not pattern:
        raise GrammarError("pattern must be a non-empty string")
    return _Parser(pattern).parse()


# ---- Thompson NFA ----------------------------------------------------------


class _NFA:
    """Fragment-at-a-time Thompson construction. State transitions are
    either epsilon edges or byte-set edges."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []

    def state(self) -> int:
        if len(self.eps) >= MAX_NFA_STATES:
            raise GrammarError(
                f"grammar too large (> {MAX_NFA_STATES} NFA states) — "
                "reduce nesting depth, repetition bounds, or alternation "
                "width")
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node) -> tuple[int, int]:
        """Returns (entry, exit) of the node's fragment."""
        kind = node[0]
        if kind == "lit":
            entry = cur = self.state()
            for b in node[1]:
                nxt = self.state()
                self.edges[cur].append((frozenset((b,)), nxt))
                cur = nxt
            return entry, cur
        if kind == "class":
            entry, exit_ = self.state(), self.state()
            self.edges[entry].append((node[1], exit_))
            return entry, exit_
        if kind == "seq":
            entry, cur = self.state(), None
            prev_exit = entry
            for child in node[1]:
                c_in, c_out = self.build(child)
                self.eps[prev_exit].append(c_in)
                prev_exit = c_out
            return entry, prev_exit
        if kind == "alt":
            entry, exit_ = self.state(), self.state()
            for child in node[1]:
                c_in, c_out = self.build(child)
                self.eps[entry].append(c_in)
                self.eps[c_out].append(exit_)
            return entry, exit_
        if kind == "rep":
            _, child, lo, hi = node
            entry = self.state()
            prev = entry
            # lo mandatory copies…
            for _ in range(lo):
                c_in, c_out = self.build(child)
                self.eps[prev].append(c_in)
                prev = c_out
            exit_ = self.state()
            if hi is None:
                # …then a Kleene loop
                c_in, c_out = self.build(child)
                self.eps[prev].append(c_in)
                self.eps[c_out].append(c_in)
                self.eps[c_out].append(exit_)
                self.eps[prev].append(exit_)
            else:
                # …then hi-lo optional copies, each skippable to the exit
                self.eps[prev].append(exit_)
                for _ in range(hi - lo):
                    c_in, c_out = self.build(child)
                    self.eps[prev].append(c_in)
                    self.eps[c_out].append(exit_)
                    prev = c_out
            return entry, exit_
        raise GrammarError(f"unknown AST node {kind!r}")


# ---- DFA -------------------------------------------------------------------


@dataclass
class ByteDFA:
    """Dense byte-level DFA. ``trans[s, b]`` is the next state on byte ``b``
    from state ``s`` (−1 = no transition); ``accept[s]`` marks states where
    the consumed input is a complete match. Trimmed: every state is
    reachable from ``start`` and can reach an accept state."""

    trans: np.ndarray   # [n_states, 256] int32
    accept: np.ndarray  # [n_states] bool
    start: int

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])

    def advance(self, state: int, data: bytes) -> int:
        """Walk ``data`` from ``state``; −1 the moment a byte has no edge."""
        for b in data:
            if state < 0:
                return -1
            state = int(self.trans[state, b])
        return state

    def matches(self, data: bytes) -> bool:
        s = self.advance(self.start, data)
        return s >= 0 and bool(self.accept[s])


def compile_ast(node) -> ByteDFA:
    """AST → trimmed dense byte DFA (Thompson + subset construction)."""
    nfa = _NFA()
    entry, exit_ = nfa.build(node)

    def closure(states: frozenset) -> frozenset:
        stack, out = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset((entry,)))
    index: dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = np.full((256,), -1, np.int32)
        # byte → union of targets across the member states' edges
        moves: dict[int, set[int]] = {}
        for s in cur:
            for byte_set, tgt in nfa.edges[s]:
                for b in byte_set:
                    moves.setdefault(b, set()).add(tgt)
        # group identical target sets so closure runs once per distinct set
        grouped: dict[frozenset, list[int]] = {}
        for b, tgts in moves.items():
            grouped.setdefault(frozenset(tgts), []).append(b)
        for tgts, bs in grouped.items():
            nxt = closure(tgts)
            j = index.get(nxt)
            if j is None:
                if len(order) >= MAX_DFA_STATES:
                    raise GrammarError(
                        f"grammar too large (> {MAX_DFA_STATES} DFA "
                        "states) — simplify the schema or pattern")
                j = len(order)
                index[nxt] = j
                order.append(nxt)
            row[bs] = j
        rows.append(row)
    trans = np.stack(rows) if rows else np.full((1, 256), -1, np.int32)
    accept = np.array([exit_ in s for s in order], bool)

    # Trim to useful states: reachable (all are, by construction) AND able
    # to reach accept. Transitions into useless states are removed; if the
    # start state itself is useless the pattern matches nothing.
    n = trans.shape[0]
    live = accept.copy()
    changed = True
    while changed:
        changed = False
        tgt_live = np.where(trans >= 0, live[np.clip(trans, 0, n - 1)], False)
        new_live = live | tgt_live.any(axis=1)
        if (new_live != live).any():
            live = new_live
            changed = True
    if not live[0]:
        raise GrammarUnsatisfiable("the pattern matches no string at all")
    remap = np.full((n,), -1, np.int32)
    remap[live] = np.arange(int(live.sum()), dtype=np.int32)
    trans = np.where((trans >= 0) & live[np.clip(trans, 0, n - 1)],
                     remap[np.clip(trans, 0, n - 1)], -1).astype(np.int32)
    trans = trans[live]
    accept = accept[live]
    return ByteDFA(trans=trans, accept=accept, start=int(remap[0]))


def compile_pattern(pattern: str) -> ByteDFA:
    """Pattern string → trimmed byte DFA."""
    return compile_ast(parse(pattern))
