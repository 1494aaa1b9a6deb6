"""Local HuggingFace checkpoint directory → (ModelSpec, the port's params).

The port's copy of the JAX package's ``models/hf_loader.py``: the same
``config.json`` → ModelSpec inference (gpt2, llama, mistral, qwen2, gemma,
mixtral) and the same weight mapping, producing the tree
``models/init.py`` produces (per-layer weights stacked ``[L, …]``,
projections input-major ``[d_in, d_out]``) in the spec's dtype, on the
requested device. Nothing is ever fetched from a network.

Reading needs no package beyond torch:

- ``*.safetensors`` (one file or shards) are read here: an 8-byte
  little-endian header length, a JSON header (``dtype``, ``shape``,
  ``data_offsets`` per tensor), then the raw bytes, each tensor mapped
  with ``mmap`` and viewed with ``torch.frombuffer``;
- ``pytorch_model*.bin`` goes through ``torch.load(weights_only=True)``.

Memory: every leaf is allocated once on the device in the spec's dtype and
filled tensor by tensor (layer by layer for ``[L, …]`` leaves), each
checkpoint tensor converted on its way in. A tensor is mapped only while
it is copied (its raw bytes cross to the card through a 64 MB page-locked
buffer), so the host holds one tensor's pages at a time, never a float32
copy of the model (the JAX loader converts to float32 and stacks there).

``quant="int8"`` quantizes on the device as it fills: a leaf of
``QUANT_REDUCE_AXIS`` is allocated as its int8 leaf (``models/quant.py``
layout), and each checkpoint tensor — or each layer slice of a stacked
leaf — is filled into a staging buffer in the spec's dtype and quantized
into its slice, so the bf16 checkpoint never exists whole on the device.
The result equals ``quantize_params`` of the bf16 load bit for bit. On a
mesh rank each tensor is staged whole, quantized whole and then cut with
its scales, so the rank's leaf equals the cut of that tree bit for bit.

Conventions: HF ``nn.Linear`` stores ``[out, in]`` (transposed on load);
GPT-2's ``Conv1D`` stores ``[in, out]`` (taken as is) and fuses q/k/v in
``c_attn`` (split); ``o_proj.bias`` fills ``bo`` only where it exists;
Mixtral's experts stack in gate (``w1``), up (``w3``), down (``w2``)
order on an ``experts`` axis; an untied head without ``lm_head.weight`` is
``tok_emb.T``. RoPE needs no permutation (the same half-split convention
as HF Llama).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import mmap
import struct
from pathlib import Path
from typing import Any

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.quant import QUANT_REDUCE_AXIS, leaf_shapes, quantize_cut

logger = logging.getLogger(__name__)

Params = dict

# safetensors dtype tags → torch dtypes.
ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


# ---- raw tensor access -----------------------------------------------------


class SafetensorsFile:
    """One ``.safetensors`` file. ``get`` maps one tensor's bytes
    (copy-on-write, so ``torch.frombuffer`` gets a writable buffer; nothing
    is ever written) and returns a CPU tensor viewing them; ``release``
    unmaps them, so a load holds one tensor's pages at a time."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        (n,) = struct.unpack("<Q", self._f.read(8))
        header = json.loads(self._f.read(n))
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self.entries: dict[str, dict] = header
        self._maps: dict[str, list[mmap.mmap]] = {}

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        ent = self.entries[name]
        dtype = ST_DTYPES.get(ent["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has unsupported dtype {ent['dtype']!r}")
        shape = tuple(ent["shape"])
        begin, end = ent["data_offsets"]
        start, end = self._base + begin, self._base + end
        if end == start:
            return torch.empty(shape, dtype=dtype)
        lo = start - start % mmap.ALLOCATIONGRANULARITY
        mm = mmap.mmap(self._f.fileno(), end - lo, offset=lo, access=mmap.ACCESS_COPY)
        self._maps.setdefault(name, []).append(mm)
        count = (end - start) // dtype.itemsize
        return torch.frombuffer(mm, dtype=dtype, count=count, offset=start - lo).reshape(shape)

    def release(self, name: str) -> None:
        """Unmap the tensor's pages. A view still alive keeps its mapping
        until it is collected."""
        for mm in self._maps.pop(name, []):
            with contextlib.suppress(BufferError):
                mm.close()

    def close(self) -> None:
        for name in list(self._maps):
            self.release(name)
        self._f.close()


ST_TAGS = {dt: tag for tag, dt in ST_DTYPES.items()}

# Host → card copies go through a page-locked buffer of this size, reused
# chunk by chunk (a pageable copy runs at a fraction of the rate).
STAGE_BYTES = 64 << 20


class HostStage:
    """One page-locked buffer of ``STAGE_BYTES`` through which tensors cross
    between the host and the card piece by piece, so neither side ever holds
    a second whole copy of a tensor (allocated at first use)."""

    def __init__(self):
        self._buf: torch.Tensor | None = None

    def _stage(self) -> torch.Tensor:
        if self._buf is None:
            self._buf = torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
        return self._buf

    def fill(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst`` (contiguous, any device) ← the host tensor ``src``, raw
        bytes of the same dtype and element count."""
        out = dst.view(-1).view(torch.uint8)
        flat = src.contiguous().reshape(-1).view(torch.uint8)
        if out.numel() != flat.numel():
            raise ValueError(f"{flat.numel()} bytes into a {out.numel()}-byte tensor")
        if dst.device.type == "cpu":
            out.copy_(flat)
            return
        stage = self._stage()
        stream = torch.cuda.current_stream(dst.device)
        for o in range(0, flat.numel(), STAGE_BYTES):
            m = min(STAGE_BYTES, flat.numel() - o)
            stage[:m].copy_(flat[o:o + m])
            out[o:o + m].copy_(stage[:m], non_blocking=True)
            stream.synchronize()  # the buffer is refilled next

    def pieces(self, src: torch.Tensor):
        """The raw bytes of ``src`` (any device) as host buffers of at most
        ``STAGE_BYTES``, each valid until the next is taken."""
        flat = src.contiguous().view(-1).view(torch.uint8)
        if src.device.type == "cpu":
            yield flat.numpy()
            return
        stage = self._stage()
        for o in range(0, flat.numel(), STAGE_BYTES):
            m = min(STAGE_BYTES, flat.numel() - o)
            stage[:m].copy_(flat[o:o + m])  # synchronous: the host reads it next
            yield stage[:m].numpy()


def write_safetensors(path: str | Path, tensors: dict[str, torch.Tensor],
                      metadata: dict[str, str] | None = None,
                      stage: HostStage | None = None) -> int:
    """``tensors`` (on any device) as one ``.safetensors`` file, the format
    :class:`SafetensorsFile` reads: 8-byte little-endian header length, the
    JSON header (padded with spaces to 8 bytes; ``metadata`` under
    ``__metadata__``), the raw bytes in the header's order. Each tensor
    crosses to the host through ``stage`` piece by piece. Returns the bytes
    written."""
    stage = stage or HostStage()
    header: dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in ST_TAGS:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors tag")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            for piece in stage.pieces(t):
                f.write(piece)
    return 8 + len(raw) + off


class _TensorDir:
    """Name → CPU tensor access over a checkpoint directory: its
    safetensors shards, else its ``pytorch_model*.bin`` files."""

    def __init__(self, path: Path):
        self.path = path
        self._files: list[SafetensorsFile] = []
        self._where: dict[str, SafetensorsFile] = {}
        self._tensors: dict[str, torch.Tensor] = {}
        st_files = sorted(path.glob("*.safetensors"))
        if st_files:
            for f in st_files:
                sf = SafetensorsFile(f)
                self._files.append(sf)
                self._where.update((name, sf) for name in sf.keys())
            return
        bins = sorted(path.glob("pytorch_model*.bin"))
        if bins:
            for f in bins:
                self._tensors.update(torch.load(f, map_location="cpu", weights_only=True))
            return
        raise FileNotFoundError(f"No *.safetensors or pytorch_model*.bin in {path}")

    def __contains__(self, name: str) -> bool:
        return name in self._where or name in self._tensors

    def get(self, name: str) -> torch.Tensor | None:
        sf = self._where.get(name)
        if sf is not None:
            return sf.get(name)
        return self._tensors.get(name)

    def req(self, name: str) -> torch.Tensor:
        t = self.get(name)
        if t is None:
            raise KeyError(f"Missing tensor {name!r} in {self.path}")
        return t

    def release(self, name: str) -> None:
        sf = self._where.get(name)
        if sf is not None:
            sf.release(name)

    def close(self) -> None:
        for sf in self._files:
            sf.close()


# ---- spec inference (a copy of the JAX package's) --------------------------


def spec_from_hf_config(cfg: dict[str, Any]) -> ModelSpec:
    """``config.json`` → ModelSpec for the supported families."""
    mt = cfg.get("model_type", "")
    if mt == "gpt2":
        d = cfg["n_embd"]
        heads = cfg["n_head"]
        return ModelSpec(
            family="gpt2", vocab_size=cfg["vocab_size"], d_model=d,
            n_layers=cfg["n_layer"], n_heads=heads, n_kv_heads=heads,
            head_dim=d // heads, d_ff=cfg.get("n_inner") or 4 * d,
            max_seq=cfg.get("n_positions", 1024), norm="layernorm",
            norm_eps=cfg.get("layer_norm_epsilon", 1e-5), pos="learned",
            act="gelu", use_bias=True, tied_lm_head=True,
        ).validate()
    if mt in ("llama", "mistral", "qwen2"):
        d = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return ModelSpec(
            family="llama", vocab_size=cfg["vocab_size"], d_model=d,
            n_layers=cfg["num_hidden_layers"], n_heads=heads,
            n_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or d // heads,
            d_ff=cfg["intermediate_size"],
            max_seq=cfg.get("max_position_embeddings", 4096),
            norm="rmsnorm", norm_eps=cfg.get("rms_norm_eps", 1e-5),
            pos="rope", rope_theta=float(cfg.get("rope_theta", 10000.0)),
            act="swiglu",
            use_bias=bool(cfg.get("attention_bias", mt == "qwen2")),
            tied_lm_head=bool(cfg.get("tie_word_embeddings", False)),
            # mistral v0.1-style sliding window; null/absent = full causal.
            # qwen2 is deliberately not windowed: HF applies its window per
            # layer (none in stock configs) and this runtime has one global
            # window, so full causal matches stock HF behavior.
            sliding_window=(int(cfg.get("sliding_window") or 0)
                            if mt == "mistral" else 0),
            **_rope_scaling_fields(cfg),
        ).validate()
    if mt == "gemma":
        d = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return ModelSpec(
            family="gemma", vocab_size=cfg["vocab_size"], d_model=d,
            n_layers=cfg["num_hidden_layers"], n_heads=heads,
            n_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or d // heads,
            d_ff=cfg["intermediate_size"],
            max_seq=cfg.get("max_position_embeddings", 8192),
            norm="rmsnorm", norm_eps=cfg.get("rms_norm_eps", 1e-6),
            norm_offset=1.0,                    # gemma RMSNorm applies (1 + w)
            pos="rope", rope_theta=float(cfg.get("rope_theta", 10000.0)),
            act="geglu",                        # GELU-gated MLP
            emb_scale=float(d) ** 0.5,          # embeddings scaled by sqrt(d)
            use_bias=bool(cfg.get("attention_bias", False)),
            tied_lm_head=bool(cfg.get("tie_word_embeddings", True)),
            **_rope_scaling_fields(cfg),
        ).validate()
    if mt == "mixtral":
        d = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return ModelSpec(
            family="mixtral", vocab_size=cfg["vocab_size"], d_model=d,
            n_layers=cfg["num_hidden_layers"], n_heads=heads,
            n_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or d // heads,
            d_ff=cfg["intermediate_size"],
            max_seq=cfg.get("max_position_embeddings", 4096),
            norm="rmsnorm", norm_eps=cfg.get("rms_norm_eps", 1e-5),
            pos="rope", rope_theta=float(cfg.get("rope_theta", 1e6)),
            act="swiglu", use_bias=False,
            tied_lm_head=bool(cfg.get("tie_word_embeddings", False)),
            n_experts=cfg["num_local_experts"],
            experts_per_token=cfg["num_experts_per_tok"],
            **_rope_scaling_fields(cfg),
        ).validate()
    raise ValueError(f"Unsupported model_type {mt!r}")


def _rope_scaling_fields(cfg: dict) -> dict:
    """HF ``rope_scaling`` → ModelSpec fields. Only the llama3 recipe (the
    3.1/3.2 checkpoints) is implemented; other types fail loudly — a model
    served with unscaled frequencies would degrade past its original
    context without any error."""
    rs = cfg.get("rope_scaling")
    if not rs:
        return {}
    rtype = rs.get("rope_type") or rs.get("type") or "default"
    if rtype == "default":
        return {}
    if rtype != "llama3":
        raise ValueError(
            f"Unsupported rope_scaling type {rtype!r} (only 'llama3')")
    return {
        "rope_scaling": "llama3",
        "rope_scaling_factor": float(rs.get("factor", 8.0)),
        "rope_low_freq_factor": float(rs.get("low_freq_factor", 1.0)),
        "rope_high_freq_factor": float(rs.get("high_freq_factor", 4.0)),
        "rope_original_max_seq": int(
            rs.get("original_max_position_embeddings", 8192)),
    }


# ---- weight mapping --------------------------------------------------------


class _QSlot:
    """A slice of a quantized leaf to fill: ``dst`` the int8 leaf (or one
    index of it), ``shape`` the slice's shape in the JAX layout, ``axis``
    its reduce axis."""

    def __init__(self, dst: dict, shape: tuple, axis: int):
        self.dst, self.shape, self.axis = dst, shape, axis

    def __getitem__(self, idx) -> "_QSlot":
        idx = idx if isinstance(idx, tuple) else (idx,)
        return _QSlot({k: v[idx] for k, v in self.dst.items()}, self.shape[len(idx):], self.axis)


class _Filler:
    """Allocates leaves on the device in the spec's dtype (int8 leaves with
    ``quant``) and fills them from checkpoint tensors, one tensor at a
    time. With ``cut`` (a mesh rank's ``parallel/sharding.RankCut``) every
    leaf is the rank's share: its stage's layers, its experts, its tp cut
    of each tensor, sliced from the mapped tensor on the host before any
    byte moves; a tensor of a layer or expert the rank does not hold is
    never read, nor a leaf it does not hold at all."""

    def __init__(self, t: _TensorDir, device: torch.device, dtype: torch.dtype,
                 quant: str | None = None, cut=None):
        self.t, self.device, self.dtype, self.quant = t, device, dtype, quant
        self.cut = cut
        self._stage = HostStage()

    def empty(self, *shape: int, name: str = ""):
        """A leaf of ``shape`` (the JAX layout); with ``quant`` and a
        quantized ``name``, its int8 leaf, filled slice by slice; with a
        cut, the rank's share of it (None for a leaf it does not hold)."""
        if self.cut is not None:
            if not self.cut.keeps(name):
                return None
            shape = tuple(self.cut(name, torch.empty(shape, device="meta")).shape)
        if self.quant and name in QUANT_REDUCE_AXIS:
            axis = QUANT_REDUCE_AXIS[name]
            dst = {k: torch.empty(s, dtype=torch.int8 if k == "q8" else torch.float32,
                                  device=self.device)
                   for k, s in leaf_shapes(shape, axis).items()}
            return _QSlot(dst, shape, axis)
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def put(self, dst, src: torch.Tensor, transpose: bool = False, cut=None) -> None:
        """Fill ``dst`` from ``src``; ``cut`` (an int8 slot on a mesh rank):
        ``src`` is the whole tensor, quantized whole on the device and then
        cut with its scales (``models/quant.quantize_cut``), so a row-parallel
        leaf's scales are each channel's amax over its whole contraction
        axis."""
        want = dst.shape if isinstance(dst, _QSlot) else tuple(dst.shape)
        whole = tuple(src.shape[::-1] if transpose else src.shape)
        shape = whole if cut is None else tuple(cut(torch.empty(whole, device="meta")).shape)
        if shape != tuple(want):
            raise ValueError(f"checkpoint tensor of shape {shape} where the spec needs "
                             f"{tuple(want)}")
        if self.device.type != "cpu":
            src = self._to_device(src)  # the raw bytes over; transpose and cast there
        if isinstance(dst, _QSlot):
            stage = torch.empty(whole, dtype=self.dtype, device=self.device)
            stage.copy_(src.T if transpose else src)
            for k, v in quantize_cut(stage, dst.axis, cut).items():
                dst.dst[k].copy_(v)
            return
        dst.copy_(src.T if transpose else src)

    def _quant_cut(self, leaf: str, layer_part: bool):
        """The cut an int8 leaf of a mesh rank takes after its whole tensor
        is quantized (None where the rank's part is read pre-cut)."""
        if self.cut is None or not (self.quant and leaf in QUANT_REDUCE_AXIS):
            return None
        return lambda x: self.cut(leaf, x, layer_part)

    def _to_device(self, src: torch.Tensor) -> torch.Tensor:
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        self._stage.fill(out, src)
        return out

    def _part(self, leaf: str, src: torch.Tensor, transpose: bool, layer_part: bool):
        """The rank's cut of checkpoint tensor ``src`` (the HF layout; the
        JAX layout is its transpose when ``transpose``), as a host tensor in
        the HF layout holding only those bytes."""
        if self.cut is None:
            return src
        jax = src.T if transpose else src
        part = self.cut(leaf, jax, layer_part)
        if part is jax:
            return src
        return (part.T if transpose else part).contiguous()

    def _index(self, i: int, expert: int | None):
        """Where layer ``i`` (expert ``expert``) lands in a rank's leaf, or
        None when the rank does not hold it."""
        if self.cut is None:
            return i if expert is None else (i, expert)
        lo, hi = self.cut.layers
        if not lo <= i < hi:
            return None
        if expert is None:
            return i - lo
        e_lo, e_hi = self.cut.experts
        return (i - lo, expert - e_lo) if e_lo <= expert < e_hi else None

    def fill_at(self, blocks: dict, leaf: str, i: int, name: str = "", transpose: bool = False,
                expert: int | None = None, src: torch.Tensor | None = None) -> None:
        """Layer ``i`` (of expert ``expert``) of ``blocks[leaf]`` from
        checkpoint tensor ``name`` (or the given ``src``), cut to the rank's
        share; skipped, unread, where the rank does not hold it."""
        idx = self._index(i, expert)
        if idx is None:
            return
        own = src is None
        if own:
            src = self.t.req(name)
        qcut = self._quant_cut(leaf, True) if expert is None else None
        if expert is None and qcut is None:
            src = self._part(leaf, src, transpose, True)
        self.put(blocks[leaf][idx], src, transpose, cut=qcut)
        if own:
            self.t.release(name)

    def fill(self, dst, name: str, transpose: bool = False):
        self.put(dst, self.t.req(name), transpose)
        self.t.release(name)
        return dst

    def leaf(self, name: str, transpose: bool = False, leaf: str = ""):
        """One checkpoint tensor as a whole leaf (``leaf``: the tree's name
        for it, which decides whether it is quantized and how a rank cuts
        it); None, unread, for a leaf the rank does not hold."""
        if self.cut is not None and not self.cut.keeps(leaf):
            return None
        src = self.t.req(name)
        dst = self.empty(*(src.shape[::-1] if transpose else src.shape), name=leaf)
        qcut = self._quant_cut(leaf, False)
        self.put(dst, src if qcut else self._part(leaf, src, transpose, False), transpose,
                 cut=qcut)
        self.t.release(name)
        return _done(dst)


def _done(leaf):
    """A filled leaf as the tree holds it (an int8 leaf's dict)."""
    return leaf.dst if isinstance(leaf, _QSlot) else leaf


def _load_gpt2(t: _TensorDir, spec: ModelSpec, f: _Filler) -> Params:
    # transformers may prefix with "transformer."
    p = "transformer." if "transformer.wte.weight" in t else ""
    L, D, F = spec.n_layers, spec.d_model, spec.d_ff
    shapes = {"attn_norm_w": (L, D), "attn_norm_b": (L, D), "wo": (L, D, D), "bo": (L, D),
              "mlp_norm_w": (L, D), "mlp_norm_b": (L, D), "w_up": (L, D, F), "b_up": (L, F),
              "w_down": (L, F, D), "b_down": (L, D), "wq": (L, D, D), "wk": (L, D, D),
              "wv": (L, D, D), "bq": (L, D), "bk": (L, D), "bv": (L, D)}
    blocks = {k: f.empty(*v, name=k) for k, v in shapes.items()}
    for i in range(L):
        pre = f"{p}h.{i}."
        f.fill_at(blocks, "attn_norm_w", i, pre + "ln_1.weight")
        f.fill_at(blocks, "attn_norm_b", i, pre + "ln_1.bias")
        if f._index(i, None) is not None:
            w = t.req(pre + "attn.c_attn.weight")  # Conv1D [in, 3D]
            b = t.req(pre + "attn.c_attn.bias")    # [3D]
            for j, (wn, bn) in enumerate((("wq", "bq"), ("wk", "bk"), ("wv", "bv"))):
                f.fill_at(blocks, wn, i, src=w[:, j * D:(j + 1) * D])
                f.fill_at(blocks, bn, i, src=b[j * D:(j + 1) * D])
            t.release(pre + "attn.c_attn.weight")
        f.fill_at(blocks, "wo", i, pre + "attn.c_proj.weight")  # [in=D, out=D]
        f.fill_at(blocks, "bo", i, pre + "attn.c_proj.bias")
        f.fill_at(blocks, "mlp_norm_w", i, pre + "ln_2.weight")
        f.fill_at(blocks, "mlp_norm_b", i, pre + "ln_2.bias")
        f.fill_at(blocks, "w_up", i, pre + "mlp.c_fc.weight")     # [D, F]
        f.fill_at(blocks, "b_up", i, pre + "mlp.c_fc.bias")
        f.fill_at(blocks, "w_down", i, pre + "mlp.c_proj.weight")  # [F, D]
        f.fill_at(blocks, "b_down", i, pre + "mlp.c_proj.bias")
    blocks = {k: _done(v) for k, v in blocks.items()}
    blocks["w_gate"] = None
    return {
        "tok_emb": f.leaf(p + "wte.weight", leaf="tok_emb"),
        "pos_emb": f.leaf(p + "wpe.weight", leaf="pos_emb"),
        "final_norm_w": f.leaf(p + "ln_f.weight", leaf="final_norm_w"),
        "final_norm_b": f.leaf(p + "ln_f.bias", leaf="final_norm_b"),
        "lm_head": None,  # tied
        "blocks": blocks,
    }


def _load_llama_family(t: _TensorDir, spec: ModelSpec, f: _Filler) -> Params:
    p = "model." if "model.embed_tokens.weight" in t else ""
    L, D, F, E = spec.n_layers, spec.d_model, spec.d_ff, spec.n_experts
    H, K = spec.n_heads * spec.head_dim, spec.n_kv_heads * spec.head_dim
    has_o_bias = f"{p}layers.0.self_attn.o_proj.bias" in t
    shapes: dict = {"attn_norm_w": (L, D), "wq": (L, D, H), "wk": (L, D, K), "wv": (L, D, K),
                    "wo": (L, H, D), "mlp_norm_w": (L, D)}
    if spec.use_bias:
        shapes.update(bq=(L, H), bk=(L, K), bv=(L, K))
        if has_o_bias:
            shapes.update(bo=(L, D))
    if spec.is_moe:
        shapes.update(router=(L, D, E), moe_w_gate=(L, E, D, F), moe_w_up=(L, E, D, F),
                      moe_w_down=(L, E, F, D))
    else:
        shapes.update(w_gate=(L, D, F), w_up=(L, D, F), w_down=(L, F, D))
    blocks = {k: f.empty(*v, name=k) for k, v in shapes.items()}
    for i in range(L):
        pre = f"{p}layers.{i}."
        f.fill_at(blocks, "attn_norm_w", i, pre + "input_layernorm.weight")
        for leaf, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
            f.fill_at(blocks, leaf, i, pre + f"self_attn.{proj}_proj.weight", transpose=True)
        if spec.use_bias:
            for leaf, proj in (("bq", "q"), ("bk", "k"), ("bv", "v")):
                f.fill_at(blocks, leaf, i, pre + f"self_attn.{proj}_proj.bias")
            if has_o_bias:  # llama attention_bias puts one on o_proj too
                f.fill_at(blocks, "bo", i, pre + "self_attn.o_proj.bias")
        f.fill_at(blocks, "mlp_norm_w", i, pre + "post_attention_layernorm.weight")
        if spec.is_moe:
            f.fill_at(blocks, "router", i, pre + "block_sparse_moe.gate.weight", transpose=True)
            for e in range(E):
                epre = pre + f"block_sparse_moe.experts.{e}."
                for leaf, w in (("moe_w_gate", "w1"), ("moe_w_up", "w3"), ("moe_w_down", "w2")):
                    # [D, F], [D, F], [F, D]
                    f.fill_at(blocks, leaf, i, epre + f"{w}.weight", transpose=True, expert=e)
        else:
            f.fill_at(blocks, "w_gate", i, pre + "mlp.gate_proj.weight", transpose=True)
            f.fill_at(blocks, "w_up", i, pre + "mlp.up_proj.weight", transpose=True)
            f.fill_at(blocks, "w_down", i, pre + "mlp.down_proj.weight", transpose=True)
    blocks = {k: _done(v) for k, v in blocks.items()}
    lm_head = None
    if not spec.tied_lm_head:
        # Without its own tensor the head is the embedding, transposed.
        head = "lm_head.weight" if "lm_head.weight" in t else p + "embed_tokens.weight"
        lm_head = f.leaf(head, transpose=True, leaf="lm_head")
    tok_emb = f.leaf(p + "embed_tokens.weight", leaf="tok_emb")
    if spec.norm == "rmsnorm":
        blocks.setdefault("attn_norm_b", None)
        blocks.setdefault("mlp_norm_b", None)
    if not spec.use_bias:
        blocks.update(bq=None, bk=None, bv=None)
    blocks.setdefault("bo", None)
    if not spec.is_moe:
        blocks.setdefault("b_up", None)
        blocks.setdefault("b_down", None)
    return {
        "tok_emb": tok_emb,
        "pos_emb": None,
        "final_norm_w": f.leaf(p + "norm.weight", leaf="final_norm_w"),
        "final_norm_b": None,
        "lm_head": lm_head,
        "blocks": blocks,
    }


def checkpoint_spec(path: str | Path, dtype: str | None = None) -> ModelSpec:
    """The spec of a local HF checkpoint (its ``config.json``), in ``dtype``
    when given."""
    spec = spec_from_hf_config(json.loads((Path(path) / "config.json").read_text()))
    return dataclasses.replace(spec, dtype=dtype) if dtype else spec


def load_hf_checkpoint(path: str | Path, dtype: str | None = None,
                       device=None, quant: str | None = None, *, mesh=None,
                       rank: int = 0) -> tuple[ModelSpec, Params]:
    """Load (spec, params) from a local HF checkpoint directory onto
    ``device`` (default cuda) in ``dtype`` (default the spec's bf16);
    ``quant="int8"`` quantizes each tensor on the device as it lands. With
    ``mesh`` (a ``parallel/mesh.Mesh`` or ``RankMesh``): rank ``rank``'s
    shard only (``parallel/sharding.rank_cut``), each tensor sliced on the
    host from the mapped file before it moves, bit for bit the matching
    cut of the whole tree."""
    path = Path(path)
    spec = checkpoint_spec(path, dtype)
    dev = resolve_device(device)
    cut = None
    if mesh is not None:
        from quorum_tpu_torch.parallel.sharding import rank_cut

        cut = rank_cut(spec, mesh, rank)
    tensors = _TensorDir(path)
    try:
        filler = _Filler(tensors, dev, getattr(torch, spec.dtype), quant, cut=cut)
        with torch.no_grad():
            if spec.family == "gpt2":
                params = _load_gpt2(tensors, spec, filler)
            else:
                params = _load_llama_family(tensors, spec, filler)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    finally:
        tensors.close()
    logger.info("Loaded %s checkpoint from %s (%d layers, vocab %d)",
                spec.family, path, spec.n_layers, spec.vocab_size)
    return spec, params
