"""Serialization of prefix-store chunk chains: the migration wire format (a
copy of the JAX package's ``cache/prefix_wire.py`` over torch tensors; the
bytes are the same for the same chains).

A JSON manifest (token chains plus each array's dtype, shape and offset)
followed by the raw array bytes, in the cache's native representation as
the store holds it (``kv_quant=int8`` chains travel at half the bytes).

Layout::

    MAGIC  b"QTPX1\\n"
    u64    manifest length (big-endian)
    bytes  manifest JSON (utf-8)
    bytes  concatenated array payloads (C-order, offsets in the manifest)

Manifest::

    {"version": 1,
     "chunk_tokens": C,
     "chains": [{"tokens": [...],                 # chunk-aligned token ids
                 "chunks": [[{"dtype": "...", "shape": [...],
                              "offset": N, "nbytes": N}, ...],  # per leaf
                            ...]},                              # per chunk
                ...]}

The parser validates structure (magic, counts, bounds) and leaves the
cache-layout checks (leaf count, dtype and shape per leaf) to the engine,
which knows its cache (``InferenceEngine.import_prefix_chunks``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import torch

MAGIC = b"QTPX1\n"
_LEN_BYTES = 8


class WireError(ValueError):
    """The blob is not a valid prefix-chunk wire payload."""


def _dtype_name(dt: torch.dtype) -> str:
    """Dtypes travel by name ("bfloat16", "float32", "int8"), as numpy
    names them."""
    return str(dt).removeprefix("torch.")


def _resolve_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None) if str(name).isidentifier() else None
    if not isinstance(dt, torch.dtype):
        raise WireError(f"unknown array dtype {name!r}")
    return dt


def _raw(a: torch.Tensor) -> bytes:
    """A tensor's bytes in C order."""
    return a.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@dataclass
class Chain:
    """One deserialized chunk chain: ``tokens`` (chunk-aligned) plus the
    per-chunk payloads, each a list of host arrays in cache-leaf order."""

    tokens: list[int]
    payloads: list[list[torch.Tensor]]

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for chunk in self.payloads for a in chunk)


def serialize_chains(
    chains: list[tuple[list[int], list[list[torch.Tensor]]]],
    chunk_tokens: int,
) -> bytes:
    """``(tokens, per-chunk payload lists)`` chains → one wire blob."""
    manifest_chains = []
    parts: list[bytes] = []
    offset = 0
    for tokens, payloads in chains:
        chunk_rows = []
        for arrays in payloads:
            row = []
            for a in arrays:
                raw = _raw(a)
                row.append({"dtype": _dtype_name(a.dtype),
                            "shape": list(a.shape),
                            "offset": offset, "nbytes": len(raw)})
                parts.append(raw)
                offset += len(raw)
            chunk_rows.append(row)
        manifest_chains.append(
            {"tokens": [int(t) for t in tokens], "chunks": chunk_rows})
    manifest = json.dumps({
        "version": 1,
        "chunk_tokens": int(chunk_tokens),
        "chains": manifest_chains,
    }).encode()
    return b"".join(
        [MAGIC, len(manifest).to_bytes(_LEN_BYTES, "big"), manifest] + parts)


def parse(blob: bytes) -> tuple[int, list[Chain]]:
    """Wire blob → ``(chunk_tokens, chains)``. Array payloads are copies,
    never views into ``blob``: the importing store holds them long after
    the request body is gone."""
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise WireError("prefix-chunk payload must be bytes")
    blob = bytes(blob)
    if not blob.startswith(MAGIC):
        raise WireError("bad magic: not a prefix-chunk payload")
    head = len(MAGIC) + _LEN_BYTES
    if len(blob) < head:
        raise WireError("truncated header")
    mlen = int.from_bytes(blob[len(MAGIC):head], "big")
    if head + mlen > len(blob):
        raise WireError("manifest length exceeds payload")
    try:
        manifest = json.loads(blob[head:head + mlen])
    except json.JSONDecodeError as e:
        raise WireError(f"unparseable manifest: {e}") from e
    if not isinstance(manifest, dict) or manifest.get("version") != 1:
        raise WireError("unsupported prefix-chunk payload version")
    chunk_tokens = manifest.get("chunk_tokens")
    if not isinstance(chunk_tokens, int) or chunk_tokens < 1:
        raise WireError(f"bad chunk_tokens: {chunk_tokens!r}")
    body = blob[head + mlen:]
    chains: list[Chain] = []
    for entry in manifest.get("chains", []):
        tokens = entry.get("tokens") if isinstance(entry, dict) else None
        chunks = entry.get("chunks", []) if isinstance(entry, dict) else None
        if (not isinstance(tokens, list) or not isinstance(chunks, list)
                or not all(isinstance(t, int) for t in tokens)
                or len(tokens) % chunk_tokens
                or len(tokens) // chunk_tokens != len(chunks)
                or not all(isinstance(row, list) for row in chunks)):
            raise WireError("chain tokens not chunk-aligned to its payloads")
        payloads = []
        for row in chunks:
            arrays = []
            for spec in row:
                try:
                    dtype = _resolve_dtype(spec["dtype"])
                    shape = tuple(int(d) for d in spec["shape"])
                    off, n = int(spec["offset"]), int(spec["nbytes"])
                except (KeyError, TypeError, ValueError) as e:
                    raise WireError(f"bad array spec: {e}") from e
                if off < 0 or n < 0 or off + n > len(body):
                    raise WireError("array bytes out of payload bounds")
                count = 1
                for d in shape:
                    count *= d
                want = dtype.itemsize * count
                if want != n:
                    raise WireError(
                        f"array spec {shape}/{dtype} wants {want} bytes, "
                        f"manifest says {n}")
                arrays.append(torch.frombuffer(bytearray(body[off:off + n]), dtype=dtype)
                              .reshape(shape) if n else torch.empty(shape, dtype=dtype))
            payloads.append(arrays)
        chains.append(Chain(tokens=[int(t) for t in tokens],
                            payloads=payloads))
    return chunk_tokens, chains


def stats(blob: bytes) -> dict:
    """Summary of a wire blob without copying array payloads."""
    if not blob.startswith(MAGIC):
        raise WireError("bad magic: not a prefix-chunk payload")
    head = len(MAGIC) + _LEN_BYTES
    mlen = int.from_bytes(blob[len(MAGIC):head], "big")
    manifest = json.loads(blob[head:head + mlen])
    chains = manifest.get("chains", [])
    return {
        "chunk_tokens": manifest.get("chunk_tokens"),
        "chains": len(chains),
        "chunks": sum(len(c.get("chunks", [])) for c in chains),
        "tokens": sum(len(c.get("tokens", [])) for c in chains),
        "payload_bytes": len(blob) - head - mlen,
    }
