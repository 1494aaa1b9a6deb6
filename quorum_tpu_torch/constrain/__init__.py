"""On-device constrained decoding: ``response_format`` grammars compiled to
token-level DFA masks — the port's own copy of the JAX package's host
compiler (it imports nothing of it).

Host half: :func:`compile_response_format` lowers JSON mode / a JSON Schema
subset / a regex into a dense ``[n_states, vocab]`` token-transition table
plus per-state accept flags, cached per (grammar, tokenizer). Device half:
the engine writes the tables into its grammar arena and threads a per-row
DFA state through every decode program — each sampled token is masked by
its state's allow-set and advances the state on the device, with no host
round-trip at any ``decode_pipeline`` depth (``engine/engine.py``).
"""

from quorum_tpu_torch.constrain.grammar import (
    CompiledGrammar,
    GrammarError,
    GrammarUnsatisfiable,
    clear_compile_cache,
    compile_cache_info,
    compile_response_format,
    json_value_ast,
    lift_to_tokens,
    schema_ast,
)
from quorum_tpu_torch.constrain.regex_dfa import (
    ByteDFA,
    compile_ast,
    compile_pattern,
    parse,
)

__all__ = [
    "ByteDFA",
    "CompiledGrammar",
    "GrammarError",
    "GrammarUnsatisfiable",
    "clear_compile_cache",
    "compile_ast",
    "compile_cache_info",
    "compile_pattern",
    "compile_response_format",
    "json_value_ast",
    "lift_to_tokens",
    "parse",
    "schema_ast",
]
