"""Tokenization for in-process ``cuda://`` backends.

The default is the deterministic byte-level tokenizer of the JAX package
(pad/bos/eos + one id per UTF-8 byte): no vocabulary files, works with every
ModelSpec, and makes generated text a pure function of (weights, prompt,
sampler, seed). A local HuggingFace tokenizer directory can replace it (a ``ckpt=``
checkpoint's own, or ``$QUORUM_TPU_TOKENIZER_PATH``); ``transformers`` is
imported only then, and where it is missing the byte tokenizer serves.

Incremental detokenization is UTF-8-boundary-safe: a multi-byte character
split across decode steps is held back until complete.
"""

from __future__ import annotations

import codecs
import logging
import os
from typing import Sequence

from quorum_tpu_torch.oai import flatten_content

logger = logging.getLogger(__name__)

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_OFFSET = 3


class ByteTokenizer:
    """UTF-8 byte tokenizer with pad/bos/eos specials."""

    def __init__(self, vocab_size: int):
        if vocab_size < _OFFSET + 1:
            raise ValueError(f"vocab_size {vocab_size} too small (need ≥ {_OFFSET + 1})")
        self.vocab_size = vocab_size
        self.byte_slots = min(256, vocab_size - _OFFSET)
        self.pad_id = PAD_ID
        self.bos_id = BOS_ID
        self.eos_id = EOS_ID

    def encode(self, text: str) -> list[int]:
        return [_OFFSET + (b % self.byte_slots) for b in text.encode("utf-8")]

    def token_byte(self, token_id: int) -> bytes:
        """Any non-special id maps to a byte by folding modulo the byte slots
        (the model samples over its full vocab)."""
        if token_id < _OFFSET or token_id >= self.vocab_size:
            return b""
        return bytes([(token_id - _OFFSET) % self.byte_slots])

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.token_byte(t) for t in ids).decode("utf-8", errors="replace")

    def detokenizer(self) -> "IncrementalDetokenizer":
        return IncrementalDetokenizer(self)

    def render_chat(self, messages: Sequence[dict]) -> str:
        return render_chat(messages)


class IncrementalDetokenizer:
    """Feed token ids one at a time; get back only *complete* UTF-8 text."""

    def __init__(self, tokenizer: ByteTokenizer):
        self._tok = tokenizer
        self._decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def feed(self, token_id: int) -> str:
        return self._decoder.decode(self._tok.token_byte(token_id))

    def flush(self) -> str:
        return self._decoder.decode(b"", final=True)


class HFTokenizer:
    """A local HuggingFace tokenizer directory (no downloads)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # lazy; heavy and optional

        self._t = AutoTokenizer.from_pretrained(path, local_files_only=True)
        eos = self._t.eos_token_id
        self.eos_id = EOS_ID if eos is None else int(eos)

    def encode(self, text: str) -> list[int]:
        return list(self._t.encode(text, add_special_tokens=False))

    def decode(self, ids: Sequence[int]) -> str:
        return self._t.decode(list(ids), skip_special_tokens=True)

    def detokenizer(self) -> "HFIncrementalDetokenizer":
        return HFIncrementalDetokenizer(self)

    def render_chat(self, messages: Sequence[dict]) -> str:
        """The checkpoint's own chat template when it ships one; the static
        fallback otherwise, or (with a warning) when the template raises."""
        if getattr(self._t, "chat_template", None):
            normalized = [{"role": m.get("role", "user"),
                           "content": flatten_content(m.get("content"))} for m in messages]
            try:
                return self._t.apply_chat_template(normalized, tokenize=False,
                                                   add_generation_prompt=True)
            except Exception:
                logger.warning("chat_template failed; using the static fallback template",
                               exc_info=True)
        return render_chat(messages)


class HFIncrementalDetokenizer:
    """Prefix-diff incremental detokenizer for subword vocabularies."""

    def __init__(self, tokenizer: HFTokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._emitted = 0

    def feed(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        if text.endswith("�"):
            return ""
        out = text[self._emitted:]
        self._emitted = len(text)
        return out

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        out = text[self._emitted:]
        self._emitted = len(text)
        return out


def get_tokenizer(vocab_size: int, path: str | None = None):
    """An explicit local HF directory (a ``ckpt=`` backend's checkpoint),
    else ``$QUORUM_TPU_TOKENIZER_PATH``, else the deterministic byte
    tokenizer. A directory that fails to load (no ``transformers``, broken
    files) or holds more ids than the model's vocab falls back to bytes,
    with a warning."""
    path = path or os.environ.get("QUORUM_TPU_TOKENIZER_PATH", "")
    if path:
        try:
            hf = HFTokenizer(path)
        except Exception:
            logger.warning("failed to load the tokenizer at %s: using bytes", path,
                           exc_info=True)
        else:
            if len(hf._t) <= vocab_size:
                return hf
            logger.warning("tokenizer at %s has %d ids, model vocab is %d: using bytes",
                           path, len(hf._t), vocab_size)
    return ByteTokenizer(vocab_size)


def render_chat(messages: Sequence[dict]) -> str:
    """Deterministic fallback chat template: ``role: content`` lines plus the
    assistant cue."""
    lines = [f"{m.get('role', 'user')}: {flatten_content(m.get('content'))}" for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)
