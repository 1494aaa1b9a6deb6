"""The port's host grammar compiler (``quorum_tpu_torch.constrain``) against
the JAX package's (``quorum_tpu.constrain``, tests/test_constrain.py).

The same ``response_format`` through both compilers, over the same
tokenizer, gives equal ``trans``, ``accept`` and ``start`` arrays: JSON
mode, the JSON Schema subset (properties in order, scalars and arrays with
bounds, enum/const/oneOf, a required subset, nesting to the depth bound),
raw regexes, the byte tokenizer at vocab 512 and 128 256, and the
sentencepiece and GPT-2 byte-level conventions of a HuggingFace vocabulary
(a stand-in object, as in tests/test_constrain.py). The byte-level DFAs of
the regex layer are equal too. Malformed and unsatisfiable inputs raise the
same error class with the same message in both. The port's compile cache
counts its hits, misses and compile seconds.
"""

import numpy as np
import pytest

from quorum_tpu import constrain as jc
from quorum_tpu.constrain import grammar as jgrammar
from quorum_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from quorum_tpu_torch import constrain as tc
from quorum_tpu_torch.constrain import grammar as tgrammar
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer

SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "dir": {"enum": ["N", "S"]},
    "n": {"type": "integer"}}}


def _schema(schema):
    return {"type": "json_schema", "json_schema": {"schema": schema}}


def _regex(pattern):
    return {"type": "regex", "pattern": pattern}


# (case id) → response_format
FORMATS = {
    "json_object": {"type": "json_object"},
    "props_in_order": _schema(SCHEMA),
    "number": _schema({"type": "number"}),
    "null": _schema({"type": "null"}),
    "integer_or_null": _schema({"type": ["integer", "null"]}),
    "array_bounds": _schema({"type": "array", "items": {"type": "integer"},
                             "minItems": 1, "maxItems": 3}),
    "string_bounds": _schema({"type": "string", "minLength": 2, "maxLength": 4}),
    "enum": _schema({"enum": ["N", "S", 3, None]}),
    "const": _schema({"const": "fixed"}),
    "one_of": _schema({"oneOf": [{"type": "integer"}, {"type": "boolean"}]}),
    "required_subset": _schema({"type": "object", "properties": {
        "a": {"type": "boolean"}, "b": {"type": "null"}}, "required": ["a"]}),
    "nested_depth": _schema({"type": "object", "properties": {
        "o": {"type": "object", "properties": {
            "a": {"type": "array", "items": {"type": "boolean"}, "maxItems": 2}}}}}),
    "boolean_schema": _schema(True),
    "regex_alt": _regex("ab|ac"),
    "regex_bounded": _regex("[a-c]{2,4}"),
    "regex_negated": _regex(r'"[^"\\]*"'),
    "regex_hex": _regex(r"\x41+"),
    "regex_integer": _regex(r"-?(0|[1-9]\d*)"),
    "regex_phone": _regex("[0-9]{3}-[0-9]{4}"),
    "regex_wildcard": _regex("[\\x00-\\xff]*"),
}


def _same(jg, tg):
    assert tg.trans.dtype == jg.trans.dtype and tg.accept.dtype == jg.accept.dtype
    assert np.array_equal(tg.trans, jg.trans)
    assert np.array_equal(tg.accept, jg.accept)
    assert tg.start == jg.start
    assert tg.key == jg.key


def _both(rf, vocab):
    jg = jc.compile_response_format(rf, JaxByteTokenizer(vocab), vocab)
    tg = tc.compile_response_format(rf, ByteTokenizer(vocab), vocab)
    return jg, tg


@pytest.mark.parametrize("case", list(FORMATS))
def test_byte_tokenizer_tables_equal_at_vocab_512(case):
    jg, tg = _both(FORMATS[case], 512)
    _same(jg, tg)
    assert tg.vocab_size == 512 and tg.table_bytes == tg.trans.nbytes + tg.accept.nbytes


@pytest.mark.parametrize("case", ["props_in_order", "regex_phone"])
def test_byte_tokenizer_tables_equal_at_vocab_128256(case):
    """llama-3-8b's vocabulary: every id folds onto a byte."""
    jg, tg = _both(FORMATS[case], 128256)
    _same(jg, tg)
    assert tg.trans.shape == (tg.n_states, 128256)


@pytest.mark.parametrize("pattern", ["ab|ac", "[a-c]{2,4}", r'"[^"\\]*"', r"\x41+",
                                     r"-?(0|[1-9]\d*)", "abc|abd", ".", r"\d\w\s+"])
def test_byte_dfas_equal(pattern):
    jd, td = jc.compile_pattern(pattern), tc.compile_pattern(pattern)
    assert np.array_equal(td.trans, jd.trans) and np.array_equal(td.accept, jd.accept)
    assert td.start == jd.start


@pytest.mark.parametrize("depth", [1, 2])
def test_json_value_dfas_equal(depth):
    jd, td = jc.compile_ast(jc.json_value_ast(depth)), tc.compile_ast(tc.json_value_ast(depth))
    assert np.array_equal(td.trans, jd.trans) and np.array_equal(td.accept, jd.accept)
    jo = jc.compile_ast(jgrammar.json_object_ast(depth))
    to = tc.compile_ast(tgrammar.json_object_ast(depth))
    assert np.array_equal(to.trans, jo.trans) and np.array_equal(to.accept, jo.accept)


# ---- HuggingFace vocabularies (stand-ins) --------------------------------------

class _FakeHF:
    """The slice of an HF tokenizer the byte table reads."""

    def __init__(self, tokens, specials=()):
        self._tokens = tokens
        self.all_special_ids = list(specials)

    def convert_ids_to_tokens(self, ids):
        return [self._tokens[i] for i in ids]


class _HFTok:
    """An HFTokenizer-shaped wrapper: the compiler finds the HF object at
    ``_t``, as on the port's ``engine/tokenizer.HFTokenizer``."""

    def __init__(self, hf):
        self._t = hf


def _gpt2_unicode():
    bs = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _sentencepiece_vocab():
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    pieces += ["▁hi", '{"', '":', "true", "false", "ok", "▁the", "ü", "12", '"}']
    return _FakeHF(pieces, specials=[0, 1, 2])


def _gpt2_vocab():
    u = _gpt2_unicode()
    pieces = [u[b] for b in range(256)]
    pieces += ["Ġhi", u[ord("{")] + u[ord('"')], "true", "false", "ok", "12",
               u[ord('"')] + u[ord(":")], "<|end|>☃", "Ġ" + "the"]
    return _FakeHF(pieces, specials=[len(pieces) - 2])


VOCABS = {"sentencepiece": _sentencepiece_vocab, "gpt2": _gpt2_vocab}


@pytest.mark.parametrize("vocab", list(VOCABS))
def test_hf_byte_tables_equal(vocab):
    hf = VOCABS[vocab]()
    n = len(hf._tokens)
    assert tgrammar._hf_token_bytes(hf, n) == jgrammar._hf_token_bytes(hf, n)


@pytest.mark.parametrize("case", ["json_object", "props_in_order", "regex_phone",
                                  "enum", "regex_negated"])
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_hf_vocab_tables_equal(vocab, case):
    hf = VOCABS[vocab]()
    n = len(hf._tokens)
    jg = jc.compile_response_format(FORMATS[case], _HFTok(hf), n)
    tg = tc.compile_response_format(FORMATS[case], _HFTok(hf), n)
    assert np.array_equal(tg.trans, jg.trans) and np.array_equal(tg.accept, jg.accept)
    assert tg.start == jg.start


# ---- errors: the same class and message ----------------------------------------

def _error(fn, *args):
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("rf", [
    {"type": "json_schema"},
    {"type": "json_schema", "json_schema": {}},
    {"type": "json_schema", "json_schema": {"schema": "x"}},
    {"type": "regex"},
    {"type": "regex", "pattern": ""},
    {"type": "regex", "pattern": "a(?=b)"},
    {"type": "xml"},
    "json",
    _schema({"$ref": "#/x"}),
    _schema({"type": "integer", "minimum": 0}),
    _schema({"type": "object", "properties": {"a": {"type": "boolean"}}, "required": ["c"]}),
], ids=lambda rf: str(rf)[:40])
def test_malformed_formats_raise_the_same_error(rf):
    got = _error(tc.compile_response_format, rf, ByteTokenizer(512), 512)
    want = _error(jc.compile_response_format, rf, JaxByteTokenizer(512), 512)
    assert got == want
    assert got[0] == "GrammarError"


@pytest.mark.parametrize("pattern", ["a(?=b)", "(", "a{5,2}", "[z-a]", "", "a\\q"])
def test_regex_syntax_errors_are_the_same(pattern):
    assert _error(tc.compile_pattern, pattern) == _error(jc.compile_pattern, pattern)


def test_unsatisfiable_vocab_raises_the_same_error():
    # vocab 20 → 17 byte slots: '{' (0x7b) has no producing token.
    got = _error(tc.compile_response_format, {"type": "json_object"}, ByteTokenizer(20), 20)
    want = _error(jc.compile_response_format, {"type": "json_object"},
                  JaxByteTokenizer(20), 20)
    assert got == want and got[0] == "GrammarUnsatisfiable"
    assert issubclass(tc.GrammarUnsatisfiable, tc.GrammarError)


def test_text_is_no_grammar():
    assert tc.compile_response_format({"type": "text"}, ByteTokenizer(512), 512) is None


# ---- the compile cache and its counters ----------------------------------------

def test_compile_cache_counts_hits_misses_and_seconds():
    tc.clear_compile_cache()
    tok = ByteTokenizer(512)
    rf = _regex("ab+c")
    info0 = tc.compile_cache_info()
    g1 = tc.compile_response_format(rf, tok, 512)
    g2 = tc.compile_response_format(rf, tok, 512)
    assert g2 is g1  # cached per (grammar, tokenizer)
    info = tc.compile_cache_info()
    assert info["misses"] == info0["misses"] + 1
    assert info["hits"] == info0["hits"] + 1
    assert info["compile_seconds"] > info0["compile_seconds"]
    assert info["entries"] == 1 and info["max"] == 64
    g3 = tc.compile_response_format(rf, ByteTokenizer(300), 300)  # another tokenizer key
    assert g3 is not g1 and g3.vocab_size == 300
    assert tc.compile_cache_info()["misses"] == info0["misses"] + 2


def test_port_compiler_imports_nothing_of_jax():
    import ast
    import pathlib

    for path in pathlib.Path(tc.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n == "jax" or n.startswith(("jax.", "quorum_tpu."))
                               or n == "quorum_tpu" for n in names), (path, names)
