"""Grammar compilation: ``response_format`` → token-level DFA tables.

The host half of on-device constrained decoding: the port's own copy of the
JAX package's ``constrain/grammar.py``, with the same tables for the same
inputs. Three grammar sources, one pipeline:

  ``{"type": "json_object"}``          a generic JSON *object* grammar with
                                       bounded nesting depth
  ``{"type": "json_schema", ...}``     a JSON Schema subset lowered to a
                                       byte-level regular grammar
  ``{"type": "regex", "pattern": …}``  a raw pattern (extension — vLLM-style
                                       guided decoding)

Each lowers to a byte DFA (:mod:`.regex_dfa`), then :func:`lift_to_tokens`
walks every vocabulary token's byte string through it once, yielding a
dense ``[n_states, vocab] -> next_state`` table plus per-state accept flags
— the arrays the engine writes into its device arena and the decode program
gathers per sampled token, with zero host round-trips.

Generated JSON is **canonical**: no whitespace between structural tokens,
object properties in schema order (all treated as required), strings
restricted to printable ASCII plus the standard short escapes. Canonical
form keeps the automaton small and the output trivially ``json.loads``-able;
it is a strict subset of what the schema admits, never a superset.

Compilation is cached per (grammar, tokenizer) — the tables are pure
functions of that pair. The module keeps its own counters of cache hits,
misses and compile seconds (:func:`compile_cache_info`), where the JAX
package feeds its metrics registry.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from quorum_tpu_torch.constrain.regex_dfa import (
    ByteDFA,
    GrammarError,
    GrammarUnsatisfiable,
    alt,
    cls,
    compile_ast,
    lit,
    opt,
    parse,
    rep,
    seq,
)

__all__ = [
    "CompiledGrammar",
    "GrammarError",
    "GrammarUnsatisfiable",
    "compile_response_format",
    "json_value_ast",
    "lift_to_tokens",
    "schema_ast",
]

# Nesting budget for schema recursion and the generic JSON grammar: state
# count grows roughly geometrically with depth (78/362/1498 byte-DFA states
# at depth 1/2/3) and the token table is [n_states, vocab] int32, so depth
# buys memory at vocab width — 2 keeps a 128k-vocab json_object table under
# ~190 MB while covering object-of-objects-of-scalars payloads
# (docs/structured_output.md has the footprint table).
DEFAULT_JSON_DEPTH = 2
MAX_SCHEMA_DEPTH = 8
# String-content bytes: printable ASCII minus '"' and '\' (escapes handle
# those). Restricting to ASCII keeps every accepted string valid UTF-8 under
# any tokenizer and the automaton a single state per character class.
_STR_PLAIN = frozenset(
    b for b in range(0x20, 0x7F) if b not in (0x22, 0x5C))
_ESCAPABLE = frozenset(b'"\\/bfnrt')
_DIGIT = frozenset(range(0x30, 0x3A))
_DIGIT19 = frozenset(range(0x31, 0x3A))


def _string_ast(min_len: int = 0, max_len: "int | None" = None) -> tuple:
    """A JSON string literal: ``"`` content ``"`` with length bounds on the
    content *characters* (plain byte or two-byte escape each)."""
    char = alt(cls(_STR_PLAIN), seq(lit("\\"), cls(_ESCAPABLE)))
    return seq(lit('"'), rep(char, min_len, max_len), lit('"'))


def _integer_ast() -> tuple:
    return seq(opt(lit("-")),
               alt(lit("0"), seq(cls(_DIGIT19), rep(cls(_DIGIT), 0, None))))


def _number_ast() -> tuple:
    frac = seq(lit("."), rep(cls(_DIGIT), 1, None))
    exp = seq(alt(lit("e"), lit("E")),
              opt(alt(lit("+"), lit("-"))),
              rep(cls(_DIGIT), 1, None))
    return seq(_integer_ast(), opt(frac), opt(exp))


def _scalar_literal(value) -> tuple:
    """A JSON scalar as a literal node (enum/const members)."""
    if isinstance(value, bool) or value is None \
            or isinstance(value, (int, float, str)):
        return lit(json.dumps(value, ensure_ascii=True,
                              separators=(",", ":")))
    raise GrammarError(
        f"enum/const members must be JSON scalars, got {type(value).__name__}")


def json_value_ast(depth: int = DEFAULT_JSON_DEPTH) -> tuple:
    """Generic JSON *value* with containers nested at most ``depth`` deep."""
    scalar = alt(_string_ast(), _number_ast(),
                 lit("true"), lit("false"), lit("null"))
    if depth <= 0:
        return scalar
    inner = json_value_ast(depth - 1)
    arr = seq(lit("["), opt(seq(inner, rep(seq(lit(","), inner), 0, None))),
              lit("]"))
    pair = seq(_string_ast(), lit(":"), inner)
    objm = seq(lit("{"), opt(seq(pair, rep(seq(lit(","), pair), 0, None))),
               lit("}"))
    return alt(scalar, arr, objm)


def json_object_ast(depth: int = DEFAULT_JSON_DEPTH) -> tuple:
    """The ``json_object`` mode grammar: the TOP level must be an object
    (the OpenAI contract), with generic values below it."""
    inner = json_value_ast(depth - 1)
    pair = seq(_string_ast(), lit(":"), inner)
    return seq(lit("{"), opt(seq(pair, rep(seq(lit(","), pair), 0, None))),
               lit("}"))


_UNSUPPORTED_KEYS = (
    "$ref", "$defs", "definitions", "allOf", "not", "patternProperties",
    "if", "then", "else", "dependentSchemas", "pattern",
    # Validating keywords the automaton cannot enforce. Listing them here
    # turns them into 400s — the module contract is "a constraint we
    # cannot honor must fail loudly, never silently loosen" (an ignored
    # `minimum` would return a 200 whose content fails jsonschema).
    "minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum",
    "multipleOf", "minProperties", "maxProperties", "uniqueItems",
    "contains", "propertyNames", "additionalItems", "prefixItems",
)


def schema_ast(schema, depth: int = MAX_SCHEMA_DEPTH) -> tuple:
    """JSON Schema (subset) → AST.

    Supported: ``type`` (string/integer/number/boolean/null/object/array,
    or a list of those), ``enum``/``const`` of scalars, ``properties``
    (emitted in schema order, ALL treated as required — canonical form),
    ``items`` + ``minItems``/``maxItems``, ``minLength``/``maxLength`` on
    strings, ``oneOf``/``anyOf``. Everything else in ``_UNSUPPORTED_KEYS``
    raises :class:`GrammarError` — a constraint we cannot honor must 400,
    never silently loosen.
    """
    if depth <= 0:
        raise GrammarError(
            f"schema nesting exceeds the supported depth ({MAX_SCHEMA_DEPTH})")
    if schema is True or schema == {}:
        return json_value_ast()
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got {schema!r}")
    for key in _UNSUPPORTED_KEYS:
        if key in schema:
            raise GrammarError(
                f"unsupported JSON Schema keyword {key!r} (see "
                "docs/structured_output.md for the supported subset)")
    if "enum" in schema:
        return alt(*[_scalar_literal(v) for v in schema["enum"]])
    if "const" in schema:
        return _scalar_literal(schema["const"])
    for comb in ("oneOf", "anyOf"):
        if comb in schema:
            subs = schema[comb]
            if not isinstance(subs, list) or not subs:
                raise GrammarError(f"{comb!r} must be a non-empty array")
            return alt(*[schema_ast(s, depth - 1) for s in subs])
    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise GrammarError("'type' must not be an empty array")
        return alt(*[schema_ast({**schema, "type": one}, depth - 1)
                     for one in t])
    if t == "string":
        min_len = int(schema.get("minLength", 0))
        max_len = schema.get("maxLength")
        max_len = int(max_len) if max_len is not None else None
        if min_len < 0 or (max_len is not None and max_len < min_len):
            raise GrammarError(
                f"bad string length bounds [{min_len}, {max_len}]")
        return _string_ast(min_len, max_len)
    if t == "integer":
        return _integer_ast()
    if t == "number":
        return _number_ast()
    if t == "boolean":
        return alt(lit("true"), lit("false"))
    if t == "null":
        return lit("null")
    if t == "array":
        items = schema.get("items", {})
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        hi = int(hi) if hi is not None else None
        if lo < 0 or (hi is not None and hi < lo):
            raise GrammarError(f"bad array bounds [{lo}, {hi}]")
        if hi == 0:
            return lit("[]")
        item = schema_ast(items, depth - 1)
        body = seq(item, rep(seq(lit(","), item), max(0, lo - 1),
                             None if hi is None else hi - 1))
        return seq(lit("["), body if lo >= 1 else opt(body), lit("]"))
    if t == "object":
        props = schema.get("properties")
        if not props:
            return json_object_ast()
        if not isinstance(props, dict):
            raise GrammarError("'properties' must be an object")
        # Canonical form emits EVERY declared property, so any `required`
        # subset of the declared names is satisfied by construction; a
        # required name with no declared shape cannot be honored.
        missing = [r for r in schema.get("required", []) if r not in props]
        if missing:
            raise GrammarError(
                f"'required' names properties not in 'properties': "
                f"{missing}")
        parts = [lit("{")]
        for i, (name, sub) in enumerate(props.items()):
            if i:
                parts.append(lit(","))
            parts.append(lit(json.dumps(str(name), ensure_ascii=True)))
            parts.append(lit(":"))
            parts.append(schema_ast(sub, depth - 1))
        parts.append(lit("}"))
        return seq(*parts)
    if t is None:
        # no type, no enum/const/oneOf: any JSON value
        return json_value_ast()
    raise GrammarError(f"unsupported schema type {t!r}")


# ---- token lifting ---------------------------------------------------------


@dataclass(frozen=True)
class CompiledGrammar:
    """The device-ready token DFA for one (grammar, tokenizer) pair.

    ``trans[s, t]`` is the LOCAL next state after emitting token ``t`` from
    state ``s`` (−1 = token not allowed); ``accept[s]`` marks states where
    the emitted text is a complete match — the only states where EOS is
    allowed. The engine offsets local states into its device arena
    (engine.py ``_ensure_grammar``) so concurrent grammars share one pair
    of uploaded tables. Trimmed at the TOKEN level: every state can reach
    an accept state through real vocabulary tokens, so a constrained
    generation can never enter a state with nothing allowed.
    """

    trans: np.ndarray          # [n_states, vocab] int32
    accept: np.ndarray         # [n_states] bool
    start: int
    key: tuple = field(compare=False, default=())

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.trans.shape[1])

    @property
    def table_bytes(self) -> int:
        return self.trans.nbytes + self.accept.nbytes

    def allowed(self, state: int) -> np.ndarray:
        """[vocab] bool — the state's allow-mask (EOS excluded)."""
        return self.trans[state] >= 0

    def advance_tokens(self, state: int, ids) -> int:
        """Host-side walk (tests, prompt-tail probes): −1 on a disallowed
        token."""
        for t in ids:
            if state < 0:
                return -1
            state = int(self.trans[state, int(t)])
        return state


def _token_byte_table(tokenizer, vocab_size: int) -> "list[bytes | None]":
    """Per-token byte strings; ``None`` marks tokens constrained decoding
    must never emit (specials, zero-text ids — an epsilon token would let
    the model stall the grammar forever)."""
    if hasattr(tokenizer, "token_byte"):  # ByteTokenizer
        out = [tokenizer.token_byte(i) or None for i in range(vocab_size)]
        return out
    hf = getattr(tokenizer, "_t", None)
    if hf is not None:
        return _hf_token_bytes(hf, vocab_size)
    raise GrammarError(
        "tokenizer does not expose a token→bytes mapping; constrained "
        "decoding needs one to lift the grammar to token level")


_BYTE_FALLBACK = None  # compiled lazily (regex over <0xHH> fallback tokens)


def _hf_token_bytes(hf, vocab_size: int) -> "list[bytes | None]":
    """Byte table for a HuggingFace tokenizer.

    The decoding convention is detected ONCE per vocabulary — mixing the
    two per token silently mis-compiles (e.g. 'ü' is a legitimate
    sentencepiece token whose chars happen to sit in the GPT-2 byte
    alphabet, but its bytes are the UTF-8 pair, not the GPT-2-mapped
    single byte):

    - **GPT-2 byte-level** vocabularies (space marker 'Ġ' — a character
      that only arises from bytes_to_unicode) map every token through the
      published bytes↔unicode table; tokens with characters outside the
      table are treated as specials (disallowed).
    - **sentencepiece** vocabularies map '▁' to space, ``<0xHH>``
      byte-fallback tokens to their single raw byte, and everything else
      through UTF-8.
    """
    import re

    global _BYTE_FALLBACK
    if _BYTE_FALLBACK is None:
        _BYTE_FALLBACK = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
    # GPT-2 bytes_to_unicode inverse (the standard published mapping).
    bs = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    uni2byte = {chr(c): b for b, c in zip(bs, cs)}
    special = set(getattr(hf, "all_special_ids", []) or [])
    toks = hf.convert_ids_to_tokens(list(range(vocab_size)))
    bytelevel = any(isinstance(t, str) and ("Ġ" in t or "Ċ" in t)
                    for t in toks)
    out: "list[bytes | None]" = []
    for i, tok in enumerate(toks):
        if i in special or not isinstance(tok, str) or not tok:
            out.append(None)
            continue
        if bytelevel:
            if all(ch in uni2byte for ch in tok):
                data = bytes(uni2byte[ch] for ch in tok)
            else:
                data = b""  # added/special token outside the byte alphabet
        else:
            m = _BYTE_FALLBACK.match(tok)
            if m:
                data = bytes([int(m.group(1), 16)])
            else:
                data = tok.replace("▁", " ").encode("utf-8")
        out.append(data or None)
    return out


def lift_to_tokens(dfa: ByteDFA, token_bytes: "list[bytes | None]",
                   ) -> CompiledGrammar:
    """Byte DFA → token DFA over the vocabulary.

    Each token's byte string is walked through the byte table once
    (duplicate byte strings — e.g. a folding byte tokenizer — share the
    walk). The result is trimmed at the token level: a byte-reachable
    state that no *token* path can carry to an accept state is removed and
    every transition into it dropped, so the device-side allow-mask is
    never empty in a reachable non-accept state. Unsatisfiable grammars
    (the start state itself cannot reach accept) raise
    :class:`GrammarUnsatisfiable`.
    """
    n = dfa.n_states
    vocab = len(token_bytes)
    trans = np.full((n, vocab), -1, np.int32)
    states = np.arange(n, dtype=np.int32)
    walk_cache: dict[bytes, np.ndarray] = {}
    for t, data in enumerate(token_bytes):
        if not data:
            continue
        col = walk_cache.get(data)
        if col is None:
            col = states.copy()
            for b in data:
                alive = col >= 0
                col = np.where(alive, dfa.trans[np.clip(col, 0, n - 1), b],
                               -1).astype(np.int32)
            walk_cache[data] = col
        trans[:, t] = col
    accept = dfa.accept.copy()

    # Token-level usefulness: accept-reaching through TOKEN transitions.
    live = accept.copy()
    changed = True
    while changed:
        changed = False
        tgt_live = np.where(trans >= 0, live[np.clip(trans, 0, n - 1)], False)
        new_live = live | tgt_live.any(axis=1)
        if (new_live != live).any():
            live = new_live
            changed = True
    if not live[dfa.start]:
        raise GrammarUnsatisfiable(
            "no tokenization of any grammar-accepted string exists in this "
            "vocabulary — the grammar requires bytes no token can produce")
    remap = np.full((n,), -1, np.int32)
    remap[live] = np.arange(int(live.sum()), dtype=np.int32)
    trans = np.where((trans >= 0) & live[np.clip(trans, 0, n - 1)],
                     remap[np.clip(trans, 0, n - 1)], -1).astype(np.int32)
    trans = trans[live]
    accept = accept[live]
    return CompiledGrammar(trans=trans, accept=accept,
                           start=int(remap[dfa.start]))


# ---- response_format entry point + compile cache ---------------------------

_CACHE_MAX = 64
_cache: "OrderedDict[tuple, CompiledGrammar]" = OrderedDict()
_cache_lock = threading.Lock()
# Cache hits, misses and the seconds spent compiling misses, since import
# (under _cache_lock).
_stats = {"hits": 0, "misses": 0, "compile_seconds": 0.0}


def _tokenizer_key(tokenizer, vocab_size: int) -> tuple:
    hf = getattr(tokenizer, "_t", None)
    if hf is not None:
        return ("hf", str(getattr(hf, "name_or_path", id(hf))), vocab_size)
    return (type(tokenizer).__name__, vocab_size)


def compile_cache_info() -> dict:
    """Entries and capacity of the compile cache, and its hit, miss and
    compile-seconds counters."""
    with _cache_lock:
        return {"entries": len(_cache), "max": _CACHE_MAX, **_stats}


def clear_compile_cache() -> None:
    with _cache_lock:
        _cache.clear()


def _grammar_key(rf: dict) -> tuple:
    kind = rf.get("type")
    if kind == "json_object":
        return ("json_object", DEFAULT_JSON_DEPTH)
    if kind == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict):
            raise GrammarError(
                "response_format.json_schema must be an object")
        schema = js.get("schema")
        if not isinstance(schema, (dict, bool)):
            raise GrammarError(
                "response_format.json_schema.schema must be an object")
        return ("json_schema",
                json.dumps(schema, sort_keys=True, separators=(",", ":")))
    if kind == "regex":
        pattern = rf.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError(
                "response_format.pattern must be a non-empty string for "
                "type 'regex'")
        return ("regex", pattern)
    raise GrammarError(
        f"unsupported response_format type {kind!r} "
        "(text, json_object, json_schema, or regex)")


def _build_ast(key: tuple, rf: dict) -> tuple:
    kind = key[0]
    if kind == "json_object":
        return json_object_ast(DEFAULT_JSON_DEPTH)
    if kind == "json_schema":
        return schema_ast(rf["json_schema"]["schema"])
    return parse(rf["pattern"])


def compile_response_format(rf: dict, tokenizer,
                            vocab_size: int) -> "CompiledGrammar | None":
    """An OpenAI ``response_format`` dict → cached :class:`CompiledGrammar`
    (``None`` for type ``text``). Raises :class:`GrammarError` (→ 400) on
    malformed/unsupported grammars and :class:`GrammarUnsatisfiable`
    (→ 422) when the grammar admits nothing under this tokenizer."""
    if not isinstance(rf, dict):
        raise GrammarError("response_format must be an object")
    if rf.get("type") in (None, "text"):
        return None
    gkey = _grammar_key(rf)
    key = gkey + _tokenizer_key(tokenizer, vocab_size)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.move_to_end(key)
            _stats["hits"] += 1
            return hit
        _stats["misses"] += 1
    t0 = time.perf_counter()
    dfa = compile_ast(_build_ast(gkey, rf))
    grammar = lift_to_tokens(dfa, _token_byte_table(tokenizer, vocab_size))
    grammar = CompiledGrammar(trans=grammar.trans, accept=grammar.accept,
                              start=grammar.start, key=key)
    with _cache_lock:
        _stats["compile_seconds"] += time.perf_counter() - t0
        _cache[key] = grammar
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
    return grammar
