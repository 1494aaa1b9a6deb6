"""Continuous-batching inference engine on torch tensors: the core of the JAX
package's ``InferenceEngine``, with the same public names and the same
default scheduler (ring depth 2, 512-token prefill segments, prefix reuse).

One engine holds one model's weights and a slot-batched KV cache
``[L, n_slots, K, max_seq, hd]`` on one device. All device work happens on
the engine's scheduler thread, on the device's current stream; callers talk
to it through thread-safe queues, so any number of threads can stream
concurrently. Each scheduler turn:

  1. **sweeps** cancelled rows (consumer gone, stop string hit): their
     slots are released at once, and tokens still arriving for them from
     chunks in flight count as overrun;
  2. **admits** pending requests into free slots. The slot is the free one
     whose resident tokens share the longest prefix with the prompt (ties:
     the least resident content, so a fresh prompt does not evict another
     conversation). A prompt with a reusable prefix (``prefix_cache``: at
     least ``MIN_PREFIX_REUSE`` tokens, capped at len−1, aligned down to a
     ``prefill_chunk`` multiple) or longer than ``prefill_chunk`` becomes a
     chunked admission; any other prompt is prefilled single-shot through
     kernel K1 (right-padded to a power-of-two bucket) and its first token
     is sampled in the same turn;
  3. advances every chunked admission by **one segment** of up to
     ``prefill_chunk`` tokens (``transformer.prefill_segment``) past the
     reused prefix. After the last segment the row registers — token = the
     last prompt token, length = len−1, the full budget — and the next
     decode chunk samples its first token;
  4. **fills the decode ring**: up to ``decode_pipeline`` dispatches stay
     in flight, each dispatched before the host blocks on the one before
     it. A dispatch is one chunk of ``decode_chunk`` steps, or with
     ``decode_loop=C`` up to C chunks back to back (``_effective_loop``:
     one under admission pressure, else the power-of-two cover of the
     longest remaining budget), with attention through kernel K2 and finish
     accounting on the device. On the card a dispatch is ONE replay of a
     CUDA graph captured per (steps, chunks, top-k/top-p, logprobs) key
     (``engine/graphs.py``); on the CPU the same program runs eagerly. Each
     copies its tokens and per-chunk valid counts into a pinned host buffer
     behind a CUDA event. The ring runs at depth 1 while an admission is in
     progress or could start (a chunk ahead would delay it), and
     dispatches ahead only while some row's budget reaches past the steps
     already in flight, and only onto a key already captured;
  5. **reaps** the oldest dispatch (blocking on its event) and delivers its
     tokens chunk by chunk, then every later dispatch that has already
     landed.

All device work of an engine runs on its scheduler thread, on the
engine's own stream on the card. Device state (tokens, lengths, live flags,
budgets) lives in fixed tensors that every dispatch and admission updates
in place — a graph reads the addresses it was captured with — and stream
order does the rest: a chunk dispatched before its predecessor is read
decodes from the right state, and an admission's cache writes land after
every chunk dispatched before them. On the CPU every call is synchronous;
the ring's bookkeeping (planned lengths, overrun, the clamps) runs all the
same. Tokens do not depend on the ring depth, ``decode_loop``, the segment
size or prefix reuse.

Sampling noise comes from one ``torch.Generator`` per request, on the
device, seeded with the request's seed, and is indexed by TOKEN: the n-th
token of a request reads the n-th draw of its generator, whatever program
samples it (a decode step, a verify turn that samples g+1 positions and
emits e of them, a fused draft→verify turn). Each row has a device ring of
draws ``_noise_ring[n mod R, row]``; before a dispatch the host tops every
sampling row's ring up, in token order, to the draws the dispatch can read
(``emitted`` + the tokens already in flight + the tokens it can emit), and
every program picks its slots from the row's device token counter
``_ntok``, which it advances by the tokens it emits. No generator is ever
rewound, and R (the most positions one dispatch samples; on a spec engine,
whose rows' counters the host only bounds, the ring depth times that) keeps
a slot from being overwritten before every dispatch that may read it has
run (writes and reads share the engine's stream). A single-shot
admission takes draw 0 for the first token at admission (counter 1), a
chunked one draws nothing until its first decode step (counter 0), so a
request's noise is a function of its seed and token index alone, whatever
it is co-batched with and however it is speculated. On the CPU its tokens
are then a pure function of (weights, prompt, sampler, seed). On the card a
row that rides a verify turn (also at draft length 0, beside a row that
drafts) takes its logits from ``decode_multi``'s plain attention, not from
K2 at T=1, so its tokens equal the plain engine's up to a near-tie, as the
JAX engine states of its own verify path.

Speculative decoding (the JAX engine's ``spec_decode=G``): a verify turn
scores ``[anchor token, g draft tokens]`` per row in one ``decode_multi``
forward (plain attention over a history bucket, cap-safe writes), samples
all g+1 positions from ``adjust_logits`` with the turn-start counts and each
position's token-indexed noise, accepts the longest draft prefix equal to
the sampled chain (``cumprod``) and emits it plus the model's own next
token, truncated at the first EOS and at the budget, with every per-row
state advanced on the device — so the ring holds verify turns like chunks.
Drafts come from prompt lookup (the lagged 2-gram index of each request's
history, continued by an optimistic cursor while turns are in flight) or,
with a draft model (``draft_spec``), from a fused draft→verify program: per
turn the draft model ingests the last emitted chain through a
``decode_multi`` of width g+1, extends g−1 greedy steps through K2, and the
target verifies — up to ``decode_loop`` turns per dispatch, with no host
input. A draft token is accepted only when it equals the token the model
itself samples there, so speculation changes speed, never content (on the
card, up to the near-tie above). Rows
with penalties or logprobs ride at draft length 0; constrained rows
verify through the ``"dfa_verify"`` variant (each position masked by its
draft-prefix DFA state). On the card every spec dispatch is one graph
replay (keys ``("verify", g, sort, lp, history)``, ``("dfa_verify", g,
sort, lp, history, bucket)``, ``("spec_loop", C, g, sort, lp, history[,
"dfa", bucket])``, ``history`` the power-of-two bucket the verify attention
reads); an engine whose traffic never drafts dispatches only the plain
keys.

The OpenAI knobs run inside the decode program (every key, no host round
trip per step): each row's ``logit_bias`` row, presence/frequency penalty
and generated-token counts are fixed ``[rows]`` / ``[rows, V]`` tensors;
every step samples from ``adjust_logits`` (bias added, penalties
subtracted) and scatters the sampled token into the row's counts. A
dispatch with a ``logprobs`` row (the ``want_lp`` key) also records each
step's logprob and top-20 alternatives, which reach the host through a
second pinned buffer behind the same event. The first token sees the bias
but no penalty on both admission routes.

Deadlines are the engine's: a request whose deadline has passed is shed at
submit; each scheduler turn sheds pending ones (``DeadlineExceeded``, stage
``queue``) and cancels admitting (``prefill``) and active (``decode``)
ones, and ``_effective_loop`` halves a megachunk until it fits the
tightest deadline by the per-chunk latency EWMA. A first capture holds the
scheduler for seconds at full depth; meanwhile a watcher thread answers
the deadlines that pass (``_deadline_watch``), and the next turn's sweep
releases their rows.

Constrained decoding (``submit(grammar=...)``, a ``CompiledGrammar`` of
``constrain/``): every admitted grammar's token-DFA rows live in one device
arena ``[bucket, V]`` int32 (next state, −1 = not allowed) plus ``[bucket]``
accept flags, at offsets that stay put for the arena's lifetime, behind the
FREE row 0 (everything allowed, a self-loop, accepting). Each row carries
its DFA state in ``_dfa`` (0 for an unconstrained request), written at every
admission. A dispatch with a grammar row runs the constrained program
variant under its own ``"dfa"``-tagged graph key: each step masks the row's
logits by its state's allow-set (EOS allowed exactly in accepting states),
samples, advances the state on the sampled token and counts the masked
entries, which ride back in the dispatch's token buffer. A dispatch with no
grammar row keeps the plain key and program. Constrained requests always
admit chunked, so their first token is sampled by a masked decode step.

Stacked engines (the JAX engine's ``members`` / ``ensemble`` knobs) hold M
weight sets in one member-stacked tree (``models/init.py``) and a cache of
M·S rows, row ``m·S + s`` being member m's slot s:

- ``members=M``: M independent streams, ``submit(member=i)``. Host slots
  are flat (M·S entries); each decode chunk advances every member's rows in
  one batched forward. Admission looks at the FIFO head of each member's
  queue. A head that is long or has a resident prefix becomes a chunked
  admission on its member's own best row; chunked admissions sharing a
  (segment bucket, history) pair advance in ONE stacked segment call, at
  most one per member. The remaining heads sharing the anchor's prompt
  bucket form a single-shot group that prefills in ONE dispatch into a
  slot index free for all of them (K1 once per layer with one row per
  member; absent members' rows are not written), falling back to the
  anchor alone. A lone member prefills through its own weight views.
  Member i's stream is a function of (member i's weights, prompt, sampler,
  seed). ``member_seeds=distinct`` seeds member i with seed+i, ``shared``
  gives every member the same weights.
- ``quorum_dedup=1`` (members, shared seeds): a full single-shot group
  carrying one prompt prefills it once on member 0's weights and copies the
  K/V into every member's row; sampling stays per member. (A prompt longer
  than ``prefill_chunk`` goes chunked per member, as in JAX.)
- ``ensemble=M``: one stream per slot; every model call runs the M weight
  sets and averages their logits in f32 before sampling; a segment writes
  the prompt into every weight set's row ``e·S + slot``.

int8, as the JAX engine's knobs: ``quant="int8"`` holds every large weight
as an int8 leaf with per-channel scales (``models/quant.py``; a random init
quantizes layer slice by layer slice, ``params=`` are quantized once), and
every product runs int8 × int8 → int32; ``kv_quant="int8"`` holds the cache
as int8 values with per-token scales, written quantized by every admission
route and read natively by K2q8 inside the decode graphs. Both compose with
each other and with every scheduler path; tier-0 reuse reads the int8 rows
as stored, so it stays exact. ``quorum_dedup`` refuses ``kv_quant``, as in
JAX.

Paged KV (``kv_pages=1``, the JAX engine's knob; ``cache/paging.py``): the
cache is a page pool plus one device page table ``[rows, max_seq/ps]`` that
the host writes in place at admission and release boundaries. Admission
reserves a request's whole span (prompt + budget + the speculative
overshoot); a span that can never fit the pool is a ``QueueFullError`` at
submit, one that fits later waits in the queue. Tier-0 reuse shares the
slot's retained page chain by reference, copying only a partly filled
boundary page; released chains stay as reuse donors until the pool needs
their pages (LRU). Every decode program gathers the window of its history
bucket through the table and hands it to K2 or K2q8 unchanged, so a paged
key is ``("paged", *dense key, history)``; a ``kv_pages=0`` engine's keys
and programs are the dense ones. Composes with members (a slot group's M
rows share one chain, reuse off), quorum_dedup, int8 KV, grammars and prompt
lookup; refuses ensembles and draft models, in JAX's words.

The host prefix store (``prefix_store="host"``; ``cache/prefix_store.py``):
a released slot's prefix is cloned out of the cache on the engine's stream
at the next scheduler turn and copied to pinned host memory, chunk by
chunk, by a worker thread on a side stream; an admission whose store match
beats the slot-resident reuse gets the tail past that overlap written back
into its slot (or pages) before its first segment, and prefills the rest.

The cache-free forwards (``engine/embed.py``, ``engine/score.py``) run on
the caller's thread, outside the scheduler, inside :meth:`forward_scope`:
on the card on a second stream of the engine's own, below the decode
ring's in priority, at most ``SCORE_GATE_SLOTS`` at once (``score_gate``).
On a mesh engine each forward sub-batch parks the ring at a turn boundary
(:meth:`forward_ranks`).

Lifecycle, as the JAX engine's: :meth:`drain` shuts submit (a
``QueueFullError`` with ``retry_after`` 1 s) and, with ``park``, retires
queued requests at once and active rows at the next scheduler turn
(``parked`` set before a clean end) through the cancel sweep's release;
:meth:`undrain` reopens. ``submit(resume_tokens=...)`` resumes a stream:
the delivered ids are regenerated — token-indexed noise makes draw n the
same whatever the dispatch shapes and admission path — and the replay
guard in :meth:`_emit` compares and swallows each, ending the stream with
:class:`ReplayDivergence` on a mismatch.

The QoS scheduler (``qos=True``, the JAX engine's knob; ``sched/``): every
request gets a dispatch class (``priority`` interactive / batch /
background, else derived from its deadline headroom); admission takes the
weighted-fair pick across classes, earliest deadline headroom first within
one; the cost model is the one shed point of ``submit`` (deadline, breaker,
queue full, pool span and, warm, the predictive infeasible-deadline shed,
each with its Retry-After); and a head that finds no row (or no pages) flags
a strictly lower-class resident row, which the next turn parks through the
ordinary release (``_sweep_preemptions``): its prefix stays resident, the
request rewinds to its submitted state (``begin_replay``) and re-enters the
queue at the head, and its delivered tokens are regenerated behind the
replay guard. With ``qos`` off, admission is FIFO and nothing is preempted;
the cost model still decides every shed.

Zero-drain staging (``zero_drain=True``, the JAX engine's knob): every
admission prefills chunked into a staging cache of the decode cache's
dense slot layout (dense even on a paged engine), on the engine's forward
stream, so segments share the card with the ring instead of queueing in it;
after each segment the rows it completed are sliced into pieces behind a
CUDA event, and at a later turn, once the event has passed, the pieces are
written into the claimed decode row on the ring's stream and the row
registers. The ring never clamps for an admission (``_admission_pressure``
is False), so ``admission_stall_seconds_total`` stays 0, and
``admission_overlap_total`` counts registrations onto a live ring. Tier-0
prefix reuse is off (the segments cannot attend over the decode cache); a
host prefix store restores into the staging row.

Disaggregated prefill/decode (``prefill_mesh=``, a ``parallel/mesh.Mesh``;
the JAX engine's ``disagg=P+D``): admissions run on their own device group.
This engine's device (or ``mesh``) is the decode group: the decode cache,
the slot state and the ring. The prefill group holds a second weight copy
(its tp cut on a group of several ranks, whose workers it starts) and the
staging cache, and a second scheduler thread, the prefill loop, takes the
queue: every admission is staged as under zero-drain, its pieces handed
off into the claimed decode row (``kv_transfer.transfer``; the route set
by the groups' layout) after the next segments are queued, and the decode
loop injects them and registers the row (the section at
``_prefill_scheduler``). The JAX engine's refusals hold in its words
(groups overlapping, a draft model, ``prefill_chunk`` 0, ``zero_drain``,
``quorum_dedup``); one-rank groups compose with what a one-device engine
composes with on the staged path, groups of several ranks with what a mesh
engine does; ``sp`` and ``pp`` inside the groups are refused by name.

Multi-rank engines (``mesh=``, a ``parallel/mesh.Mesh``; the JAX engine's
mesh argument, ``dp``, ``tp`` and ``sp`` axes): this engine is rank 0, on
the mesh's first device, and holds rank 0's shard of the weights and of the
KV cache (its kv heads, and with dp its dp group's block of the slot rows:
every row when dp does not divide ``n_slots``, the JAX package's rule); the
other ranks are worker processes
(``parallel/ranks.RankGroup``, each an ``engine/follower.Follower``). The
one scheduler is rank 0's. Before it issues a device program — a
single-shot admission, a segment, a decode dispatch — it sends the
workers a plan naming it and its host inputs, and each runs the same
program on its shard in the same order, so the collectives pair up. Rank 0 samples every row; each decode step
broadcasts its token, positions and write mask, so every rank feeds the
same token. With dp each dp group runs its own rows through the layers and
the step all-gathers the hidden states over dp (``models/transformer``), so
rank 0 samples every row with the single engine's noise and sampler state:
sampled streams equal the single engine's by construction. An admission
runs on the dp group that owns its slot. With sp > 1 every admission is single-shot and sequence-
parallel (ring or Ulysses, ``sp_impl``). A mesh over NCCL (ranks on cards
of their own) decodes from graphs that capture the collectives, on every
rank (a worker mirrors rank 0's warm-up step); one over gloo (ranks
sharing a card) decodes eagerly, as ``health()["mesh"]`` says. A worker
that exits is seen at once (``parallel/ranks``: rank 0's NCCL groups are
aborted, so no host read of ours waits on it); that, or a collective
failing, fails the engine's requests and opens its breaker for good: every
later submit is a 503 (``EngineBreakerOpen``); ``shutdown`` stops the
workers through one teardown of every rank and joins them (killed past a
timeout). The dense and MoE families (experts cut over tp), every tp size
(a dim tp does not divide is whole on every rank), both admission routes,
tier-0 reuse, the request knobs and deadlines, QoS, drain, park and resume
carry; a local checkpoint (``ckpt=``, :func:`get_engine_from_ckpt` with a
mesh) is read by every rank, each its own cut. On dp and tp meshes (and
disaggregated groups cut by tp) int8 carries: each rank's int8 leaves are
the cut of the whole quantized tree (scales of whole channels), a
row-parallel product quantizes its input with the whole row's amax (a max
all-reduce over tp) and sums its int32 accumulators over tp, and each
rank's int8 cache holds its kv heads (K2q8 reads them). So do stacked
members (each rank its cut of every weight set, its cache rows ``m·S + s``
for its dp group's slots; ``quorum_dedup`` copies member 0's rows on every
rank), ensembles (every worker runs each weight set, rank 0 averages the
logits) and grammars (rank 0 alone holds the arena and the DFA state; the
workers' steps are the plain ones). So do paging, the host store and
zero-drain (the staging stream over process groups of its own). So does
speculation: a verify turn is ``decode_multi`` at each rank's heads, its
anchor, drafts, positions and write mask broadcast by rank 0 (the
workers' ``verify`` plan; over NCCL a graph of its own per width, turns
and history, with the warm-up turn mirrored); prompt lookup and grammar
filtering stay on rank 0's host, and a draft model runs whole on rank 0
(the JAX engine keeps its draft runtime off the mesh too). And so do the
cache-free forwards: on rank 0's dp group, each rank at its heads over a
forward stream and tp groups of their own, a sub-batch at a time with the
ring parked (:meth:`forward_ranks`, ``engine/embed.py``). On sp meshes
int8, speculation and the forwards carry too: an admission quantizes the
K/V it all-gathers over sp, a verify turn runs at each rank's heads
replicated over sp (the cache's position axis is whole on every sp rank),
and a forward runs its T/sp sequence block over ring or Ulysses attention
on forward groups of its own (the blocks' hidden states all-gathered). Under sp and pp the JAX engine's
refusals of members, ensembles, grammars and (pp) speculation hold in its
words.

Pipeline-staged engines (a mesh with pp > 1; the JAX engine's ``pp=K``):
this rank is stage 0 and holds the embedding, the final norm, the head and
its L/pp layers; each worker a later stage's layers and their cache. A
decode dispatch runs ``parallel/pipeline.staged_decode_chunk`` / ``_loop``
(the slot rows as pp row groups flowing stage to stage; keys ``("pp",
…)``, the JAX engine's families ``pp_plain`` / ``pp_loop``), an admission
``staged_prefill`` (single-shot only: ``prefill_chunk`` is 0, as under
sp). int8 weights and KV carry: each stage holds its layers' cut of the
whole quantized tree and their int8 cache, which the staged decode reads
through K2q8. A forward (embeddings, scoring) runs stage by stage on the
forward stream (``parallel/pipeline.staged_forward_hidden``: K1 at each
stage's layers, the last stage's output back to stage 0 for the final
norm and the head) with the ring parked. The JAX engine's pp refusals hold
in its words (zero_drain, sp, tp or dp beside pp, members and ensembles,
speculation, pp not dividing the layers or the slots); the port refuses
``prefix_store`` there by name (single-shot admission);
``quorum_tpu_decode_stage_occupancy{stage=}`` counts each row group's live
rows.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator

import torch

from quorum_tpu_torch import faults, resolve_device
from quorum_tpu_torch import observability as obs
from quorum_tpu_torch.breaker import Breaker
from quorum_tpu_torch.cache import kv_transfer, prefix_wire
from quorum_tpu_torch.cache.paging import (PageAllocator, copy_member_pages, init_paged_cache,
                                           paged_copy_page, validate_page_config)
from quorum_tpu_torch.cache.prefix_store import DEFAULT_PREFIX_STORE_BYTES, PrefixStore
from quorum_tpu_torch.engine.graphs import DecodeGraphs
from quorum_tpu_torch.models.convert import shard_params
from quorum_tpu_torch.models.init import (check_quant, init_params, init_params_shard,
                                          init_params_stacked, init_params_stacked_shard)
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.quant import is_quantized, jax_layout_params, quantize_params
from quorum_tpu_torch.models.transformer import (broadcast_member_rows, decode_chunk,
                                                 decode_loop, decode_multi, decode_step,
                                                 host_to_device, init_cache, member_params,
                                                 prefill, prefill_segment)
from quorum_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP
from quorum_tpu_torch.parallel.ranks import RankGroup, WorkerLost, to_host
from quorum_tpu_torch.parallel.pipeline import (staged_decode_chunk, staged_decode_loop,
                                                staged_prefill)
from quorum_tpu_torch.parallel.sharding import rank_kv_index, stage_layers
from quorum_tpu_torch.parallel.ulysses import ulysses_supported
from quorum_tpu_torch.ops.sampling import (TOP_LOGPROBS, SamplerConfig, adjust_logits,
                                           apply_token_mask, gumbel_noise, sample_token_rows,
                                           token_logprobs)
from quorum_tpu_torch.sched import (PRIORITY_CLASSES, CostModel, PreemptionController,
                                   SchedPolicy)
from quorum_tpu_torch.telemetry import tracecontext
from quorum_tpu_torch.telemetry.latency import LatencyModel
from quorum_tpu_torch.telemetry.recorder import RECORDER as FLIGHT

logger = logging.getLogger(__name__)

MIN_BUCKET = 16
DEFAULT_SLOTS = 4
DEFAULT_MAX_PENDING = 128
DEFAULT_DECODE_CHUNK = 8
# Chunked prefill: prompts longer than this prefill one segment per
# scheduler turn, with decode chunks in between.
DEFAULT_PREFILL_CHUNK = 512
# Decode dispatches kept in flight; the host blocks only on the oldest.
DEFAULT_DECODE_PIPELINE = 2
# Megachunk decode: chunks one dispatch may cover (decode_loop=C; 1 = one
# chunk per dispatch). Bounded so one dispatch cannot hold the card for
# seconds; floored to a power of two, since every per-dispatch clamp halves.
DEFAULT_DECODE_LOOP = 1
MAX_DECODE_LOOP = 64
# Prefix reuse below this many tokens is not worth a chunked admission.
MIN_PREFIX_REUSE = 16
# EWMA weight of the per-chunk dispatch-to-reap latency that the deadline
# clamp of ``_effective_loop`` estimates a dispatch's length from.
CHUNK_EWMA_ALPHA = 0.3
# The grammar arena (the JAX engine's constants): it resets, once no
# request references a grammar, only after growing past KEEP states (a
# steady one-grammar workload keeps its table and offset), and it never
# grows past MAX states — a state is V × 4 bytes, so at V = 128 256 the cap
# is 4.2 GB; past it a NEW grammar's request fails alone.
CONSTRAIN_ARENA_KEEP = 4096
CONSTRAIN_ARENA_MAX = 8192
# Speculative decoding: the largest draft length an engine verifies.
MAX_SPEC_DECODE = 16
# Prefix store: snapshots waiting for the worker at most (each holds a
# device copy of its slice until fetched); past it a snapshot is dropped,
# a future store miss.
SNAP_QUEUE_MAX = 8
# How often the watcher answers deadlines while a capture holds the scheduler.
DEADLINE_WATCH_S = 0.005
# A stacked engine's single-shot group waits at most this long after its
# oldest member's submit for the other members' heads: two of the
# interpreter's 5 ms switch intervals, so a group submitted from threads
# that lose the interpreter lock to the scheduler in between still admits
# as one dispatch.
MEMBER_GROUP_WAIT_S = 0.01
# Embedding and scoring forwards in flight per engine (``score_gate``): they
# run on the request's thread, outside the scheduler's queue, so this bounds
# the device work they add beside live decode; a request past it is a 503.
SCORE_GATE_SLOTS = 2
# CUDA priority of the decode ring's stream (lower runs first); the forward
# stream keeps the default 0. ``scripts/torch_ring_priority_ab.py`` holds
# −1 against 0.
RING_STREAM_PRIORITY = -1


class QueueFullError(Exception):
    """The admission queue is at capacity (callers map it to a 503)."""


class EngineBreakerOpen(Exception):
    """The engine's failure breaker is open: repeated failed scheduler turns
    inside the sliding window mean new admissions would likely hit the same
    fault. Surface as a 503 with ``Retry-After: ceil(retry_after)``."""

    def __init__(self, retry_after: float):
        super().__init__(f"engine circuit breaker is open; retry in {retry_after:.1f}s")
        self.retry_after = retry_after


class DeadlineExceeded(Exception):
    """A request ran past its deadline. ``stage`` names where the scheduler
    caught it: ``"queue"`` — shed while still pending, never served (a 503
    with Retry-After, safe to retry elsewhere); ``"prefill"``/``"decode"``
    — cancelled after admission (a 504, the work is lost)."""

    def __init__(self, stage: str):
        super().__init__(f"request deadline exceeded ({stage})")
        self.stage = stage


class ReplayDivergence(RuntimeError):
    """A replay guard byte-compare failed: a token regenerated for a resumed
    stream (``submit(resume_tokens=...)``) did not equal the token already
    delivered to the client. The stream fails with this distinct error, so a
    caller can tell "this resume must not be retried" apart from an ordinary
    transport failure it may fail over."""

    def __init__(self, position: int, regenerated: int | None = None,
                 delivered: int | None = None, *, message: str | None = None):
        super().__init__(
            message if message is not None else
            f"replay diverged at position {position}: regenerated token "
            f"{regenerated} != delivered token {delivered}")
        self.position = position


class GrammarArenaFull(RuntimeError):
    """The device grammar arena is at capacity (CONSTRAIN_ARENA_MAX) and
    cannot place another distinct grammar until constrained traffic
    quiesces and the arena resets. Raised for the one request (a 503:
    retryable; resident grammars keep serving)."""


def prefill_bucket(n: int, max_seq: int) -> int:
    """Smallest power-of-two ≥ n, clamped to [MIN_BUCKET, max_seq]."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, max_seq)


def resolve_decode_loop(decode_loop: int) -> int:
    """``decode_loop`` as an engine runs it: in [1, MAX_DECODE_LOOP] or a
    ValueError, floored to a power of two."""
    if not 1 <= int(decode_loop) <= MAX_DECODE_LOOP:
        raise ValueError(f"decode_loop={decode_loop} out of range [1, {MAX_DECODE_LOOP}]")
    return 1 << (int(decode_loop).bit_length() - 1)


def aligned_prefill_chunk(prefill_chunk: int, max_seq: int) -> int:
    """The segment size an engine runs: ``prefill_chunk`` rounded down to a
    power of two that divides ``max_seq`` (segment offsets then never cross
    it), 0 — chunking off — below ``MIN_BUCKET``."""
    c = 1
    while c * 2 <= min(prefill_chunk, max_seq):
        c *= 2
    while c >= MIN_BUCKET and max_seq % c:
        c //= 2
    return c if c >= MIN_BUCKET and max_seq % c == 0 else 0


@dataclass
class GenerationResult:
    token_ids: list[int] = field(default_factory=list)
    finish_reason: str = "length"  # "stop" when EOS was hit

    @property
    def completion_tokens(self) -> int:
        return len(self.token_ids)


class _Request:
    """One queued/active generation; tokens flow to the consumer via ``out``
    as ``("tok", id)``, then one ``("end", reason)`` or ``("err", exc)``.
    ``hist`` is the prompt plus every delivered token. ``pp``/``fp`` are the
    presence/frequency penalties, ``bias_row`` a ``[V]`` f32 CPU tensor
    (None: no bias), ``want_lp`` -1 for no logprobs, else the number of
    alternatives asked for; ``lp`` gets one ``(logprob, top_ids, top_lps)``
    record per delivered token, appended before the token is put on
    ``out``. ``deadline`` is absolute ``time.monotonic()`` or None.
    ``grammar`` is a ``CompiledGrammar`` or None; ``g_start`` its start
    state in the engine's arena, set when the grammar is placed, and
    ``dfa_host`` the host's shadow of its LOCAL state (−1: unknown), which
    only the grammar-aware draft filter reads. ``n_drawn`` counts the
    noise draws taken from ``generator`` (draw n is token n's).

    Prompt-lookup state: ``ngram`` maps each 2-gram of ``hist`` to the
    position of its second token, "lagged" — a pair is recorded only once a
    token follows it, so the trailing pair is never in the index and every
    stored position has a continuation; ``spec_state`` is the optimistic
    draft cursor while turns are in flight (None: none), ``n_inflight`` the
    dispatches in flight that carry this request.

    Tracing: ``trace`` is the request trace bound where ``submit`` ran (the
    scheduler appends its spans there), ``rid`` the flight-recorder
    correlation id (the trace's W3C trace-id, else a fresh one),
    ``t_submit`` the submit stamp (``time.perf_counter``) and ``tspans``
    the last span and turn count of each per-turn span kind.
    ``deadline_answered``: its DeadlineExceeded frame went out (the
    consumer is gone); the scheduler's sweep has yet to release it.

    Lifecycle: ``replay`` is the list of already-delivered token ids a
    resumed stream must regenerate before anything new reaches ``out``
    (None: not resuming); ``parked`` is set, before the end frame, when a
    draining engine retired the stream mid-generation (its consumer
    finishes it ``"parked"``).

    QoS: ``priority`` and ``tenant`` as submitted, ``sched_class`` the
    dispatch class ``submit`` resolved, ``n_preempts`` how often it was
    preempted (the budget against livelock, and the admission's epoch:
    dispatches issued before a preemption no longer deliver to it),
    ``preempt_flag`` set under ``_cond`` while a park order for it is
    outstanding, ``t_admit`` the last admission stamp (``perf_counter``;
    the cost model's service clock)."""

    __slots__ = ("prompt_ids", "budget", "sampler", "seed", "eos_id", "cancel",
                 "chunk_hint", "out", "emitted", "generator", "member", "hist",
                 "pp", "fp", "bias_row", "want_lp", "lp", "deadline", "grammar", "g_start",
                 "dfa_host", "n_drawn", "ngram", "spec_state", "n_inflight", "trace", "rid",
                 "t_submit", "tspans", "deadline_answered", "replay", "parked", "priority",
                 "tenant", "sched_class", "n_preempts", "preempt_flag", "t_admit")

    def __init__(self, prompt_ids, budget, sampler: SamplerConfig, seed, eos_id, cancel,
                 chunk_hint, member=0, pp=0.0, fp=0.0, bias_row=None, want_lp=-1,
                 deadline=None, grammar=None, priority=None, tenant=None):
        self.grammar = grammar
        self.g_start = 0
        self.dfa_host = grammar.start if grammar is not None else 0
        self.n_drawn = 0
        self.member = member
        self.pp = float(pp)
        self.fp = float(fp)
        self.bias_row = bias_row
        self.want_lp = int(want_lp)
        self.lp: list = []
        self.deadline = deadline
        self.prompt_ids = prompt_ids
        self.budget = budget
        self.sampler = sampler
        self.seed = seed
        self.eos_id = eos_id
        self.cancel = cancel
        self.chunk_hint = chunk_hint
        self.out: queue.Queue = queue.Queue()
        self.emitted = 0
        self.generator: torch.Generator | None = None
        self.hist: list[int] = list(prompt_ids)
        self.ngram: dict = {(prompt_ids[n - 2], prompt_ids[n - 1]): n - 1
                            for n in range(2, len(prompt_ids))}
        self.spec_state = None
        self.n_inflight = 0
        self.trace = obs.current_trace()
        if self.trace is not None:
            self.rid = self.trace.trace_id or self.trace.request_id
        else:
            self.rid = tracecontext.new_trace_id()
            obs.TRACE_PROPAGATED.inc(source="engine")
        self.t_submit = time.perf_counter()
        self.tspans: dict = {}
        self.deadline_answered = False
        self.replay: list[int] | None = None
        self.parked = False
        self.priority = priority
        self.tenant = tenant
        self.sched_class = "batch"
        self.n_preempts = 0
        self.preempt_flag = False
        self.t_admit: float | None = None

    def begin_replay(self) -> int:
        """Rewind to the as-submitted request for a preemption resume and
        record the delivered tokens as the replay expectation (after any
        not yet re-swallowed from an earlier preemption). Host state goes
        back to the prompt: ``hist``, the 2-gram index, the DFA shadow, the
        draft cursor, ``emitted``, ``n_inflight`` and the noise index
        ``n_drawn`` (the generator is reseeded when the row registers or
        admits single-shot, so token n reads draw n again). ``lp`` stays:
        its records were delivered, the replay guard appends none, and a
        logprobs request is never a victim. Re-admission rides the
        ordinary admission routes; :meth:`InferenceEngine._emit`'s guard
        swallows the regenerated tokens. Returns the parked token count."""
        generated = self.hist[len(self.prompt_ids):]
        self.replay = generated + (self.replay or [])
        prompt = self.prompt_ids
        self.hist = list(prompt)
        self.ngram = {(prompt[n - 2], prompt[n - 1]): n - 1 for n in range(2, len(prompt))}
        self.dfa_host = self.grammar.start if self.grammar is not None else 0
        self.spec_state = None
        self.emitted = 0
        self.n_inflight = 0
        self.n_drawn = 0
        self.generator = None
        self.n_preempts += 1
        self.t_admit = None
        return len(generated)

    @property
    def spec_draft_ok(self) -> bool:
        """May carry a nonzero draft length in a speculative dispatch (the
        JAX engine's rule). Sampled, biased and constrained rows qualify:
        the verify turn samples every position with the row's own noise,
        its static bias and its draft-prefix grammar state. Rows with
        presence/frequency penalties (which depend on the counts position by
        position) or logprobs (one record per token) ride at draft length 0:
        a −1 sentinel draft never matches, so they emit exactly the model's
        own next token."""
        return self.pp == 0.0 and self.fp == 0.0 and self.want_lp < 0


class _Admission:
    """An in-progress chunked prefill of one request into ``slot`` (a flat
    row), advanced one segment per scheduler turn. ``offset`` starts at the
    reused prefix (``offset0``): the row's cache already holds those
    positions of this prompt. Zero-drain staging: positions ``[0, handed)``
    of the staging row are queued as pieces for the decode row,
    ``final_sent`` marks the whole prompt queued (the register waits in
    the queue behind its pieces), and ``dead`` makes the queue drop this
    admission's pieces (it was released: its decode row may already hold
    another request)."""

    __slots__ = ("req", "slot", "offset", "offset0", "restored", "t_start", "handed",
                 "final_sent", "dead")

    def __init__(self, req: _Request, slot: int, offset: int = 0, restored: int = 0):
        self.req = req
        self.slot = slot
        self.offset = offset
        self.offset0 = offset
        self.restored = restored  # of offset0, the tokens the prefix store restored
        self.t_start = time.perf_counter()
        self.handed = 0
        self.final_sent = False
        self.dead = False


class _InflightChunk:
    """One dispatched, not yet read decode dispatch of ``n_chunks`` chunks.
    ``host`` receives its ``[n_chunks, rows, n_steps + 1]`` tokens and
    per-chunk valid counts (a pinned buffer on the card, returned to the
    pool only after the reap); ``lp`` receives the
    ``[n_chunks, n_steps, rows, 1 + 2·TOP_LOGPROBS]`` logprob records of a
    ``want_lp`` dispatch (None otherwise), pooled and copied the same way;
    ``event`` marks the copies' completion on the stream (None on the CPU,
    where the copies have happened). ``active`` holds the (row, request)
    pairs dispatched, ``t0`` the dispatch time. A ``constrained`` dispatch's
    ``host`` has one more column per row: its masked vocabulary entries
    over the chunk. A ``spec_turn`` dispatch is ``n_chunks`` verify turns
    of ``n_steps`` = g+1 sampled positions each, a row's valid count its
    emitted tokens; ``drafted`` is the real draft tokens per turn.
    ``family`` is the key's program family (:func:`program_family`),
    ``seq`` the flight recorder's dispatch number, ``depth`` the ring depth
    it was issued at, and ``timing`` the CUDA-event pair recorded around its
    graph replay (None on the CPU), read at reap. ``epochs`` holds each
    active request's ``n_preempts`` at issue: a preempted request no
    longer takes this dispatch's tokens (nor counts it in flight), even
    once it is re-admitted into the same row."""

    __slots__ = ("active", "n_steps", "n_chunks", "host", "lp", "event", "t0", "constrained",
                 "spec_turn", "drafted", "family", "seq", "depth", "timing", "t_issue",
                 "t_ready", "epochs")

    def __init__(self, active, n_steps, n_chunks, host, event, lp=None, constrained=False,
                 spec_turn=False, drafted=0):
        self.family = "unknown"
        self.seq = 0
        self.depth = 0
        self.timing = None
        # Host stamps of the dispatch's issue and of the first probe that
        # found its outputs landed (the CPU's device-time attribution).
        self.t_issue = self.t_ready = None
        self.spec_turn = spec_turn
        self.drafted = drafted
        self.constrained = constrained
        self.active = active
        self.epochs = [r.n_preempts for _, r in active]
        self.n_steps = n_steps
        self.n_chunks = n_chunks
        self.host = host
        self.lp = lp
        self.event = event
        self.t0 = time.perf_counter()

    @property
    def tokens_ahead(self) -> int:
        """Upper bound on the tokens this dispatch can produce per row."""
        return self.n_steps * self.n_chunks

    def carries(self) -> list[tuple[int, _Request]]:
        """The (row, request) pairs this dispatch still serves: those not
        preempted since it was issued."""
        return [(i, r) for (i, r), ep in zip(self.active, self.epochs) if r.n_preempts == ep]

    def ready(self) -> bool:
        """True once the chunk's tokens are on the host (a non-blocking probe)."""
        ok = self.event is None or self.event.query()
        if ok and self.t_ready is None:
            self.t_ready = time.perf_counter()
        return ok

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _bite(n_left: int, pos: int, max_seq: int, bite: int) -> int:
    """Tokens one draft ``decode_multi`` call takes: at most ``bite``,
    rounded up to a power of two (few shapes), never letting the pad-write
    span ``[pos, pos + T)`` run past ``max_seq`` (``len(hist) <= max_seq``
    keeps it ≥ 1)."""
    t = min(bite, n_left, max_seq - pos)
    t = 1 << (t - 1).bit_length()
    return t >> 1 if t > max_seq - pos else t


class _DraftRuntime:
    """Draft-model state for speculative decoding (``draft_spec``): the JAX
    engine's ``_DraftRuntime``. A small model proposes each verify turn's
    g-token draft instead of prompt lookup. Correctness never depends on
    the draft: a token is accepted only when it equals the one the target
    itself samples there, so stale, random or mid-resync draft state costs
    acceptance only. Everything runs on the engine's scheduler thread.

    State: the draft model's own dense cache (one row per engine row), per
    row the request it tracks (``reqs``) and the tokens fed (``synced``),
    and the fused loop's chain carry: the last verify turn's emitted tokens
    per row (``chain [rows, g+1]``, ``chain_n [rows]``), which the next
    turn re-ingests through a ``decode_multi`` of the verify's own width.
    The serving path is the fused program (``InferenceEngine._spec_loop_program``);
    the host work here is :meth:`resync`, which brings a newly assigned
    row's cache to the request's history in ``decode_multi`` bites of at
    most ``BITE`` tokens before its first fused dispatch.
    :meth:`draft_all` (advance in bites, then g−1 greedy ``decode_step``
    extensions) is the host-paced reference the unit tests drive. Drafted
    and pad positions sit past ``synced`` and the next ingest overwrites
    them: nothing is ever rolled back."""

    BITE = 16  # the most tokens one advance call feeds (T: powers of two up to it)

    def __init__(self, spec: ModelSpec, target_spec: ModelSpec, rows: int, device,
                 seed: int = 0, params=None):
        if spec.vocab_size != target_spec.vocab_size:
            raise ValueError(
                f"draft model vocab {spec.vocab_size} != target vocab "
                f"{target_spec.vocab_size}: drafted ids would be meaningless "
                "(and can index out of the target embedding)")
        if spec.max_seq < target_spec.max_seq:
            raise ValueError(
                f"draft model max_seq {spec.max_seq} < target max_seq "
                f"{target_spec.max_seq}: the draft cache must hold every "
                "position the target can reach")
        self.spec = spec.validate()
        self.device = device
        self.params = params if params is not None else init_params(spec, seed, device)
        self.rows = rows
        self.ck, self.cv = init_cache(spec, rows, device=device)
        self.synced = [0] * rows
        self.reqs: list = [None] * rows
        self.chain: torch.Tensor | None = None
        self.chain_n: torch.Tensor | None = None
        self.chain_w = 0

    def _advance(self, tokens: list[list[int]], lengths: list[int], wmask: list[bool],
                 history: int) -> torch.Tensor:
        """One draft ``decode_multi`` over every row (writes only where
        ``wmask``); the greedy next token after each fed position."""
        dev = self.device
        logits, _, _ = decode_multi(
            self.params, self.spec, host_to_device(tokens, torch.long, dev),
            host_to_device(lengths, torch.int32, dev), self.ck, self.cv,
            write_mask=host_to_device(wmask, torch.bool, dev), history=history)
        return logits.argmax(dim=-1)

    def _history(self, n: int, g: int) -> int:
        return prefill_bucket(min(n + g + 1, self.spec.max_seq), self.spec.max_seq)

    def draft_all(self, active, g: int) -> dict:
        """g-token draft per active row: feed the unsynced history, then
        extend greedily. Returns ``{row: [t0 .. t_{g-1}]}``."""
        for i, r in active:
            if self.reqs[i] is not r:  # row reassigned: full resync
                self.reqs[i] = r
                self.synced[i] = 0
        max_seq = self.spec.max_seq
        history = self._history(max(len(r.hist) for _, r in active), g)
        # Feed hist[pos:] (at least one token: hist[-1] again when synced —
        # the same write, done only for its next-token logits).
        rem = {i: max(1, len(r.hist) - self.synced[i]) for i, r in active}
        pos = {i: len(r.hist) - rem[i] for i, r in active}
        first: dict[int, int] = {}
        while any(v > 0 for v in rem.values()):
            left = [i for i, _ in active if rem[i] > 0]
            t = _bite(max(rem[i] for i in left), max(pos[i] for i in left), max_seq, self.BITE)
            tokens = [[0] * t for _ in range(self.rows)]
            lengths, wmask = [0] * self.rows, [False] * self.rows
            for i, r in active:
                if rem[i] <= 0:
                    continue
                k = min(rem[i], t)
                seg = r.hist[pos[i]:pos[i] + k]
                tokens[i] = seg + [seg[-1]] * (t - k)
                lengths[i], wmask[i] = pos[i], True
            nxt = self._advance(tokens, lengths, wmask, history).tolist()
            for i, r in active:
                if rem[i] <= 0:
                    continue
                k = min(rem[i], t)
                pos[i] += k
                rem[i] -= k
                if rem[i] == 0:
                    first[i] = nxt[i][k - 1]
                    self.synced[i] = len(r.hist)
        drafts = {i: [first[i]] for i, _ in active}
        if g > 1:
            dev = self.device
            token = [0] * self.rows
            lengths, wmask = [0] * self.rows, [False] * self.rows
            for i, r in active:
                token[i], lengths[i], wmask[i] = first[i], len(r.hist), True
            tok = host_to_device(token, torch.long, dev)
            lens = host_to_device(lengths, torch.int32, dev)
            live = host_to_device(wmask, torch.bool, dev)
            steps = []
            for _ in range(g - 1):
                logits, _, _ = decode_step(self.params, self.spec, tok,
                                           lens.clamp(max=max_seq - 1), self.ck, self.cv,
                                           write_mask=live)
                tok = logits.argmax(dim=-1)
                lens = lens + 1
                steps.append(tok)
            rest = torch.stack(steps, dim=1).tolist()
            for i, _ in active:
                drafts[i].extend(rest[i])
        return drafts

    def ensure_chain(self, g: int) -> None:
        """Allocate the fused loop's chain carry at width g+1; a new width
        forgets every row's assignment, so :meth:`resync` rebuilds a coherent
        chain (draft quality only)."""
        if self.chain_w == g + 1:
            return
        self.chain = torch.zeros((self.rows, g + 1), dtype=torch.long, device=self.device)
        self.chain_n = torch.ones((self.rows,), dtype=torch.long, device=self.device)
        self.chain_w = g + 1
        self.reqs = [None] * self.rows

    def resync(self, i: int, r, g: int) -> None:
        """Bring draft row ``i`` to the fused loop's invariant for a newly
        assigned request: the cache holds ``hist[:-1]`` and the chain holds
        the one token the target anchors on (``hist[-1]``, which the fused
        ingest writes at the target's ``lengths``). Its calls run on the
        engine's stream behind any fused dispatch still writing the row:
        the later write wins, and pad writes land past the true length."""
        self.reqs[i] = r
        n = len(r.hist) - 1
        self.synced[i] = n
        self.chain[i, 0] = r.hist[-1]
        self.chain_n[i] = 1
        history = self._history(len(r.hist), g)
        pos = 0
        while pos < n:
            t = _bite(n - pos, pos, self.spec.max_seq, self.BITE)
            k = min(n - pos, t)
            seg = r.hist[pos:pos + k]
            tokens = [[0] * t for _ in range(self.rows)]
            tokens[i] = seg + [seg[-1]] * (t - k)
            lengths, wmask = [0] * self.rows, [False] * self.rows
            lengths[i], wmask[i] = pos, True
            self._advance(tokens, lengths, wmask, history)
            pos += k


class InferenceEngine:
    """One loaded model on one device (or rank 0 of a mesh), serving many
    requests concurrently."""

    def __init__(
        self,
        spec: ModelSpec,
        *,
        device=None,
        seed: int = 0,
        decode_chunk: int = DEFAULT_DECODE_CHUNK,
        decode_pipeline: int = DEFAULT_DECODE_PIPELINE,
        decode_loop: int = DEFAULT_DECODE_LOOP,
        prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
        prefix_cache: bool = True,
        params=None,
        n_slots: int = DEFAULT_SLOTS,
        max_pending: int = DEFAULT_MAX_PENDING,
        members: int = 1,
        member_seeds: str = "distinct",
        quorum_dedup: bool = False,
        ensemble: int = 1,
        quant: str | None = None,
        kv_quant: str | None = None,
        spec_decode: int = 0,
        draft_spec: ModelSpec | None = None,
        draft_seed: int = 0,
        draft_params=None,
        kv_pages: bool = False,
        kv_page_size: int = 0,
        kv_pool_pages: int = 0,
        prefix_store: str | None = None,
        prefix_store_bytes: int = DEFAULT_PREFIX_STORE_BYTES,
        prefix_store_chunk: int = 0,
        qos: bool = False,
        zero_drain: bool = False,
        mesh=None,
        sp_impl: str = "ring",
        ckpt: tuple[str, str] | None = None,
        prefill_mesh=None,
    ):
        self.spec = spec.validate()
        # A mesh engine (``mesh``, a parallel/mesh.Mesh): this engine is
        # rank 0, on the mesh's first device; the other ranks are worker
        # processes started below (the module docstring's "Multi-rank
        # engines").
        self.mesh = mesh
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_impl {sp_impl!r} (ring or ulysses)")
        self.sp_impl = sp_impl
        self._use_sp = mesh is not None and mesh.shape[AXIS_SP] > 1
        # Pipeline-staged decode (pp > 1): this rank is stage 0
        # (parallel/pipeline.py).
        self.decode_pp = 1 if mesh is None else mesh.shape[AXIS_PP]
        if ckpt is not None and (mesh is None or params is not None):
            raise ValueError("ckpt= (each rank loads its own cut) is for mesh engines "
                             "without params=")
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.devices[0]:
                raise ValueError(f"device={device} is not the mesh's rank-0 device "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.members = max(1, int(members))
        self.ensemble = max(1, int(ensemble))
        self.quant, self.kv_quant = check_quant_knobs(quant, kv_quant)
        # Disaggregated prefill/decode (``prefill_mesh``, the JAX engine's
        # disagg=P+D; the module docstring's section): the decode group is
        # this engine's device, the prefill group's device holds a second
        # weight copy and the staging cache.
        self.prefill_mesh = prefill_mesh
        self.disagg = prefill_mesh is not None
        self.prefill_sp = 1
        self.prefill_device = self.device
        if self.disagg:
            _check_disagg_knobs(self, spec, mesh, prefill_mesh, draft_spec, prefill_chunk,
                                zero_drain)
            self.prefill_device = prefill_mesh.devices[0]
        # Zero-drain staging: every admission prefills chunked into the
        # staging cache and its rows reach the decode row at a later turn.
        self.zero_drain = bool(zero_drain)
        if self.zero_drain and aligned_prefill_chunk(int(prefill_chunk), spec.max_seq) <= 0:
            raise ValueError(
                "zero_drain requires chunked prefill (prefill_chunk >= "
                "16 after power-of-two alignment): admissions prefill "
                "into the staging cache segment by segment and inject "
                "at a reap boundary — the single-shot admit program "
                "blocks the host on its first-token fetch, which "
                "behind a full dispatch ring is exactly the stall "
                "zero_drain exists to remove")
        self.staged = self.zero_drain or self.disagg
        _check_stack_knobs(self.members, self.ensemble, member_seeds, quorum_dedup,
                           self.kv_quant, self.staged)
        if spec.is_moe and max(self.members, self.ensemble) > 1:
            knob = "members" if self.members > 1 else "ensemble"
            raise ValueError(
                f"{knob}={max(self.members, self.ensemble)} does not compose with an MoE "
                "spec on cuda:// engines yet: the stacked weight sets carry no expert "
                f"leaves; serve one {knob}=1 engine per weight set")
        self.member_seeds = member_seeds
        self.quorum_dedup = bool(quorum_dedup)
        stack = max(self.members, self.ensemble)
        self._ranks: RankGroup | None = None
        self._rmesh = None
        # The prefill group's ranks beside rank 0 of it (disagg with a
        # prefill group of several ranks; ``_start_prefill_group``).
        self._pranks: RankGroup | None = None
        self._prmesh = None
        given = params
        for m in (mesh, prefill_mesh if self.disagg and prefill_mesh.size > 1 else None):
            if m is not None:
                _check_mesh_knobs(self, spec, m, sp_impl, spec_decode, draft_spec, kv_pages,
                                  prefix_store, n_slots)
        self.decode_chunk = max(1, int(decode_chunk))
        self.decode_pipeline = max(1, int(decode_pipeline))
        self.decode_loop = resolve_decode_loop(decode_loop)
        self.prefill_chunk = aligned_prefill_chunk(int(prefill_chunk), spec.max_seq)
        if self._use_sp or self.decode_pp > 1:
            # The JAX engine's rule: the sp ring (or Ulysses) IS the long-
            # prompt answer; every admission prefills single-shot. A
            # pipeline-staged engine admits single-shot too, stage by stage
            # (parallel/pipeline.staged_prefill).
            self.prefill_chunk = 0
        # Reuse rides the segment path (the suffix prefills at an offset).
        # Off under staging: the resident K/V lives in the decode cache,
        # which the staging segments cannot attend over (the host prefix
        # store restores into the staging row instead).
        self.prefix_cache = bool(prefix_cache) and self.prefill_chunk > 0 and not self.staged
        self.n_slots = max(1, int(n_slots))
        # A stacked engine absorbs the whole fan-out's admissions in one
        # queue: M members carry the capacity M separate engines would have.
        self.max_pending = max(1, int(max_pending)) * self.members
        # Host slot space is flat across members: row m·S + s is member m's
        # slot s (S rows when members == 1). The cache holds one row per
        # slot per weight set.
        self._rows = self.members * self.n_slots
        # Speculative decoding: draft length g (0 = off), and the draft
        # model's runtime when one proposes the drafts (the JAX engine's
        # guards, word for word).
        self.spec_decode = max(0, min(int(spec_decode), MAX_SPEC_DECODE))
        if draft_spec is not None:
            if self.members > 1 or self.ensemble > 1:
                raise ValueError(
                    "draft-model decoding (spec_model=/spec_ckpt=) does "
                    "not compose with members/ensemble engines")
            if self.spec_decode <= 0:
                raise ValueError(
                    "a draft model requires spec_decode > 0 (the backend "
                    "defaults spec_decode=4 when spec_model=/spec_ckpt= is "
                    "set and spec_decode= is absent; an explicit 0 means "
                    "off — drop the draft knob instead)")
        # Paging and the store before any rank starts: their refusals come
        # first, and a mesh's workers build their caches from the pool.
        self._init_paging(kv_pages, kv_page_size, kv_pool_pages, draft_spec)
        self._init_store(prefix_store, prefix_store_bytes, prefix_store_chunk)
        # One seed per weight set (members or ensemble).
        self._seeds = ([seed] * stack if member_seeds == "shared"
                       else [seed + i for i in range(stack)])
        if params is not None:
            emb = params["tok_emb"]["q8"] if is_quantized(params["tok_emb"]) else params["tok_emb"]
            if (emb.dim() == 3) != (stack > 1) or (stack > 1 and emb.shape[0] != stack):
                raise ValueError(f"params must be a {stack}-member stacked tree"
                                 if stack > 1 else "params must be a single-model tree")
        if mesh is not None:
            params = self._start_ranks(spec, mesh, seed, params, n_slots, ckpt)
        elif params is None:
            if stack > 1:
                params = init_params_stacked(spec, self._seeds, self.device, quant=self.quant)
            else:
                params = init_params(spec, seed, self.device, quant=self.quant)
        elif self.quant:
            params = quantize_params(params)
        self.params = params
        # The prefill group's weights (``_start_prefill_group``).
        self._prefill_params = None
        if self.disagg:
            try:
                self._prefill_params = self._start_prefill_group(spec, seed, given, n_slots,
                                                                 ckpt)
            except BaseException:
                if self._ranks is not None:
                    self._ranks.stop()
                raise
        self._draft_rt = None
        if draft_spec is not None:
            # The draft model runs on this device alone (rank 0 of a mesh;
            # the workers verify what it drafts).
            self._draft_rt = _DraftRuntime(draft_spec, self.spec, self._rows, self.device,
                                           seed=draft_seed, params=draft_params)
        n_kv, held, layers = None, self.n_slots, None
        if mesh is not None:
            n_kv = len(rank_kv_index(spec.n_heads, spec.n_kv_heads, mesh.shape["tp"], 0))
            lo, hi, _ = self._rmesh.slots
            held = hi - lo  # rank 0's dp block of each weight set's slots
            lo, hi = stage_layers(spec.n_layers, self.decode_pp, 0)
            layers = hi - lo  # stage 0's layers
        if self.kv_pages:
            # One device table shared by both sides, rewritten in place (a
            # mesh rank's: its cut of the pool, its dp group's rows).
            self._ck, self._cv = init_paged_cache(
                spec, held, self.kv_pool_pages, self.kv_page_size,
                kv_quant=self.kv_quant, members=self.members if self.members > 1 else None,
                device=self.device, n_kv_heads=n_kv)
            self._table = self._ck.table
        else:
            self._ck, self._cv = init_cache(spec, stack * held, device=self.device,
                                            kv_quant=self.kv_quant, n_kv_heads=n_kv,
                                            layers=layers)
        # The staging cache of a zero-drain engine: the decode cache's dense
        # slot layout (staging row i stages decode row i), dense even on a
        # paged engine, in the cache's representation. Its bytes are
        # 2 × layers × rows × kv_heads × max_seq × head_dim × the element
        # size (+ the int8 sides' f32 scales).
        self._sck = self._scv = None
        if self.staged:
            # Under disagg the prefill group's rank 0 cut (every row); on a
            # zero-drain mesh rank 0's, as its decode cache's (its kv heads,
            # its rows).
            if self.disagg:
                held, n_kv = self.n_slots, (None if self._prmesh is None else len(
                    rank_kv_index(spec.n_heads, spec.n_kv_heads, self._prmesh.tp_size, 0)))
            self._sck, self._scv = init_cache(spec, stack * held, device=self.prefill_device,
                                              kv_quant=self.kv_quant, n_kv_heads=n_kv)
        # Staged rows on their way to the decode cache: ("kv", admission,
        # [(row, chunk)], start, event) pieces and ("final", admission)
        # registers, in order (``_drain_handoffs``).
        self._handoffs: deque = deque()
        self.n_admission_overlap = 0
        # Under disagg the prefill loop's pieces wait in its outbox until
        # their handoff (``_commit_handoffs``); the route is the groups'
        # layout's, chosen here (``kv_transfer.handoff_route``).
        self._outbox: deque = deque()
        self.n_kv_handoffs = 0
        self.kv_handoff_bytes = 0
        self.kv_handoff_s = 0.0
        self.handoff_route = (kv_transfer.handoff_route(prefill_mesh, mesh)
                              if self.disagg else None)
        # Per-row decode state, device-resident between chunks, and the
        # static inputs of a decode dispatch (its active rows, the drafts of
        # a verify turn, which rows may draft in a fused turn). Updated in
        # place only: graphs read these addresses.
        s, dev = self._rows, self.device
        self._mask = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._draft_buf = torch.full((s, max(1, self.spec_decode)), -1, dtype=torch.long,
                                     device=dev)
        self._spec_ok = torch.zeros((s,), dtype=torch.bool, device=dev)
        # Token-indexed sampling noise: row i's draw n at slot n mod R, and
        # each row's next token index. R covers a dispatch's reach
        # (``_draw_noise``): one dispatch's positions on a plain engine, the
        # ring depth's on a spec engine.
        per_dispatch = max(self.decode_chunk * self.decode_loop,
                           (self.spec_decode + 1) * (self.decode_loop if draft_spec else 1))
        depth = self.decode_pipeline if self.spec_decode else 1
        self._noise_ring = torch.zeros((depth * per_dispatch, s, spec.vocab_size),
                                       dtype=torch.float32, device=dev)
        self._ntok = torch.zeros((s,), dtype=torch.long, device=dev)
        self._token = torch.zeros((s,), dtype=torch.long, device=dev)
        self._lengths = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._live = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._budget = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._eos = torch.full((s,), -1, dtype=torch.int32, device=dev)
        self._temp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._topp = torch.ones((s,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._noise = torch.zeros((s, spec.vocab_size), dtype=torch.float32, device=dev)
        # The OpenAI knobs per row: penalties, generated-token counts (what
        # the penalties act on) and the logit-bias row. A row's bias is
        # written only when its request sets one, else zeroed on the device.
        self._pp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._fp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._counts = torch.zeros((s, spec.vocab_size), dtype=torch.int32, device=dev)
        self._bias = torch.zeros((s, spec.vocab_size), dtype=torch.float32, device=dev)
        # Each row's grammar-DFA state (a GLOBAL arena index; 0 = FREE),
        # read and advanced by the constrained program variant only.
        self._dfa = torch.zeros((s,), dtype=torch.int32, device=dev)
        # The grammar arena: placed grammars' offsets (by grammar key), the
        # states in use (row 0 is FREE) and the device tables, allocated at
        # the first grammar, padded to a power-of-two bucket of states.
        self._g_offsets: dict = {}
        self._g_states = 1
        self._g_trans: torch.Tensor | None = None   # [bucket, V] int32
        self._g_accept: torch.Tensor | None = None  # [bucket] bool
        self._g_bucket = 0
        self.n_constrained = 0
        self.n_constrain_masked = 0

        self._slots: list[_Request | None] = [None] * s
        # Tokens whose K/V each row's cache holds from position 0: what a
        # later prompt may reuse.
        self._resident: list[list[int]] = [[] for _ in range(s)]
        self._claimed: set[int] = set()  # rows held by chunked admissions
        self._admitting: list[_Admission] = []
        self._inflight: deque[_InflightChunk] = deque()
        self._host_pool: dict[tuple, list[torch.Tensor]] = {}
        self._pending: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self.n_requests = 0
        self.n_tokens = 0
        self.n_member_tokens = [0] * self.members
        self.n_failures = 0
        self.n_cancelled = 0
        self.n_rebuilds = 0
        self.n_admissions = 0
        self.n_admission_dispatches = 0  # single-shot prefills; a coalesced group is one
        self.n_prefill_segments = 0  # segment calls; a coalesced member group is one
        # Prefill tokens the dedup route did not recompute, and its admissions.
        self.quorum_dedup_tokens = 0
        self.quorum_dedup_prefills = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.n_decode_chunks = 0
        self.n_decode_steps = 0
        self.n_decode_rows = 0
        self.n_overlapped = 0  # chunks dispatched ahead of the read
        self.n_loop_chunks = 0  # chunks of dispatches that had a live row
        self.n_graph_warmup_steps = 0  # eager decode steps run before the first capture
        self.n_overrun = 0
        self.n_deadline_exceeded = 0
        self.n_deadline_clamps = 0  # dispatches the deadline clamp shortened
        # Speculation, as the JAX engine counts it: executed verify turns,
        # draft tokens proposed and accepted, spec dispatches issued ahead.
        self.n_spec_turns = 0
        self.n_spec_accepted = 0
        self.n_spec_drafted = 0
        self.n_spec_overlapped = 0
        # Draft-model decode steps run (each launches K2 once per draft
        # layer): the extension steps captured in each fused graph times its
        # replays, plus the eager warm-up turns before a first capture.
        self.n_draft_steps = 0
        # Program keys dispatched (graph keys on the card; recorded on every
        # device): which program families an engine's traffic reached.
        self.dispatched_keys: set = set()
        self._deadline_clamped = False
        self._program_issued = False  # a dispatch's program ran on the engine's state
        # Per-chunk dispatch-to-reap latency (s), EWMA; 0 until the first reap.
        self._chunk_ewma_s = 0.0
        self.admission_stall_s = 0.0  # wall time the ring spent clamped for admissions
        self._clamp_t0: float | None = None
        self.drain_gap_s = 0.0  # host time from a chunk's tokens landing to delivery
        # Robustness and telemetry: the failure breaker that gates submit;
        # this engine's tag on flight-recorder events; the dispatch
        # sequence pairing a ring entry's dispatch and reap events; the
        # per-family device-time model.
        self.breaker = Breaker()
        self._tag = f"engine-{id(self):x}"
        self._dispatch_seq = 0
        self.latency = LatencyModel(alpha=CHUNK_EWMA_ALPHA)
        # The QoS scheduler: the admission policy and the preemption
        # controller act only with ``qos``; the cost model is always the
        # submit path's one shed point. Park orders (row, victim,
        # beneficiary) wait for the next turn (``_sweep_preemptions``).
        self.qos = bool(qos)
        self._policy = SchedPolicy()
        self._preempt = PreemptionController()
        self.cost_model = CostModel(self.latency)
        self._preempt_pending: list[tuple[int, _Request, _Request]] = []
        self.n_preemptions = 0
        self.n_preempted_tokens = 0
        # Embedding and scoring forwards (engine/embed.py, engine/score.py)
        # admitted at once, by the backends' gate.
        self.score_gate = threading.Semaphore(SCORE_GATE_SLOTS)
        # A mesh engine's forward sub-batches park the scheduler one at a
        # time (``_ring_parked``).
        self._fwd_lock = threading.Lock()
        self._park_want = self._parked = False
        # The drain lifecycle: ``draining`` shuts submit (a retryable 503);
        # with ``_draining_park`` every resident stream is retired at the
        # next scheduler turn with a ``parked`` finish. Replayed tokens are
        # the regenerated ones a resume's guard swallowed.
        self.draining = False
        self._draining_park = False
        self.n_drain_parked = 0
        self.n_replayed_tokens = 0
        # On the card: the engine's own stream (after the set-up above), its
        # decode graphs, and the stream the cache-free forwards run on — a
        # second one, so a long forward shares the SMs with live decode
        # rather than queueing behind the ring. The ring's stream has the
        # higher priority: as a forward's blocks retire, the SMs go to
        # pending decode blocks first, and a stream's tokens keep coming.
        # A zero-drain engine stages on a third stream of its own, so its
        # segments queue neither behind the ring nor behind a forward.
        self._stream = self._graphs = self._fwd_stream = self._stage_stream = None
        self._handoff_stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device, priority=RING_STREAM_PRIORITY)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            # A mesh over gloo stages its collectives through the host,
            # which no graph can capture: that engine decodes eagerly.
            if self._rmesh is None or self._rmesh.graphs_ok:
                self._graphs = DecodeGraphs(self.device, self._stream, hold=self._deadline_watch)
            self._fwd_stream = torch.cuda.Stream(self.device)
            self._fwd_stream.wait_stream(torch.cuda.current_stream(self.device))
            if self.staged:
                # Under disagg on the prefill group's device, whose work
                # the set-up above (its weight copy, the staging cache)
                # queued on that device's current stream.
                dev = self.prefill_device
                self._stage_stream = torch.cuda.Stream(dev)
                self._stage_stream.wait_stream(torch.cuda.current_stream(dev))
            if self.disagg:
                self._handoff_stream = torch.cuda.Stream(self.device)
                self._handoff_stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.prefix_store is not None:
            self._snap_thread.start()
        self._thread = threading.Thread(target=self._scheduler, daemon=True,
                                        name="quorum-torch-scheduler")
        self._thread.start()
        self._prefill_thread = None
        if self.disagg:
            self._prefill_thread = threading.Thread(target=self._prefill_scheduler, daemon=True,
                                                    name="quorum-torch-prefill")
            self._prefill_thread.start()

    # ---- public API -------------------------------------------------------

    def submit(
        self,
        prompt_ids: list[int],
        *,
        max_new_tokens: int = 64,
        sampler: SamplerConfig | None = None,
        seed: int = 0,
        eos_id: int | None = None,
        cancel: threading.Event | None = None,
        decode_chunk: int | None = None,
        member: int = 0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        logit_bias=None,  # [vocab] f32 additive bias (tensor or array), or None
        logprobs: int = -1,  # >= 0: record per-token logprobs + that many tops
        deadline: float | None = None,  # absolute time.monotonic() deadline
        grammar=None,  # CompiledGrammar: constrained decoding (structured output)
        resume_tokens: list[int] | None = None,  # already-delivered ids to replay
        priority: str | None = None,  # QoS class: interactive, batch or background
        tenant: str | None = None,  # QoS weighted-fair accounting bucket
    ) -> _Request | None:
        """Enqueue a generation for weight set ``member`` and return its
        handle (``None`` when there is nothing to generate). Every shed
        goes through the cost model (``sched/cost.py``), in its order:
        :class:`DeadlineExceeded` (stage ``queue``) when ``deadline`` has
        already passed (or, with ``qos``, when warm queue evidence says it
        cannot survive the queue), :class:`EngineBreakerOpen` while the
        failure breaker rejects new admissions, and :class:`QueueFullError`
        with the cost model's text and ``retry_after`` when the queue is at
        capacity or (paged) the request's span exceeds the page pool. A
        draining engine raises ``QueueFullError`` (``retry_after`` 1 s)
        first. ``priority`` (one of ``PRIORITY_CLASSES``, else a
        ValueError) and ``tenant`` act only on a ``qos`` engine.
        ``deadline`` bounds the request's
        whole life: pending past it, it is shed (stage ``queue``); admitted,
        it is cancelled with a ``DeadlineExceeded`` error frame. When
        ``logprobs`` >= 0 the handle's ``lp`` list carries one ``(logprob,
        top_ids, top_lps)`` record per yielded token. Penalties follow the
        OpenAI contract (presence: flat once a token has been generated;
        frequency: scaled by its count) over this request's generated
        tokens. A ``grammar`` constrains every sampled token to its
        language; the stream ends with EOS once the grammar completes.

        ``resume_tokens`` resumes a stream this or another engine already
        delivered part of: the request admits as usual, regenerates those
        ids from (prompt, seed, sampler) — sampling noise is drawn per token
        index, so draw n is the same as on first delivery — and
        :meth:`_emit`'s replay guard compares each with the delivered id and
        swallows it before anything new reaches the consumer. A mismatch
        ends the stream with :class:`ReplayDivergence`, never a silent
        fork. Out-of-vocabulary ids and a journal longer than the budget
        are ``ValueError``s."""
        if not 0 <= member < self.members:
            raise ValueError(
                f"member {member} out of range for a {self.members}-member engine")
        if priority is not None and priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {PRIORITY_CLASSES}, "
                f"got {priority!r}")
        if self._ranks_lost():
            # A lost rank never comes back: every submit is a fast 503.
            raise EngineBreakerOpen(self.breaker.retry_after())
        if self.draining:
            # A draining engine admits nothing new: the 503 this becomes is
            # a failure before the first byte, which a router fails over.
            err = QueueFullError("engine draining")
            err.retry_after = 1.0
            raise err
        spec = self.spec
        if grammar is not None:
            # The JAX engine's preconditions: grammar completion
            # finishes the row by forcing EOS, and the first token must be
            # sampled by a masked decode step (a chunked admission).
            if eos_id is None:
                raise ValueError(
                    "constrained decoding requires an EOS id: grammar "
                    "completion finishes the row by forcing EOS on device")
            if self.prefill_chunk <= 0:
                raise ValueError(
                    "constrained decoding requires chunked prefill "
                    "(prefill_chunk >= 16 after power-of-two alignment): "
                    "the first constrained token is sampled by a masked "
                    "decode chunk, not inside the single-shot admit "
                    "program — unavailable with sp>1 or prefill_chunk=0")
            if grammar.vocab_size != spec.vocab_size:
                raise ValueError(
                    f"grammar compiled for vocab {grammar.vocab_size} does "
                    f"not match the model vocab {spec.vocab_size}")
        bias_row = None
        if logit_bias is not None:
            bias_row = torch.as_tensor(logit_bias, dtype=torch.float32).reshape(-1).cpu()
            if bias_row.shape[0] != spec.vocab_size:
                raise ValueError(f"logit_bias has {bias_row.shape[0]} entries, the "
                                 f"vocabulary {spec.vocab_size}")
        # Keep the most recent context if the prompt exceeds the window,
        # reserving at least one position to generate into.
        prompt = list(prompt_ids)[-(spec.max_seq - 1):] or [0]
        budget = min(int(max_new_tokens), spec.max_seq - len(prompt))
        if budget <= 0 or (cancel is not None and cancel.is_set()):
            return None
        replay = None
        if resume_tokens:
            replay = [int(t) for t in resume_tokens]
            if any(not 0 <= t < spec.vocab_size for t in replay):
                raise ValueError("resume_tokens contains out-of-vocabulary ids")
            if len(replay) > budget:
                raise ValueError(
                    f"resume_tokens longer ({len(replay)}) than the "
                    f"generation budget ({budget})")
        req = _Request(prompt, budget, sampler or SamplerConfig(), int(seed), eos_id,
                       cancel if cancel is not None else threading.Event(), decode_chunk,
                       member, pp=presence_penalty, fp=frequency_penalty, bias_row=bias_row,
                       want_lp=logprobs, deadline=deadline, grammar=grammar,
                       priority=priority, tenant=tenant)
        req.replay = replay
        now = time.monotonic()
        req.sched_class = self._policy.classify(priority, deadline, now)
        shed = self.cost_model.presubmit(now=now, deadline=deadline, breaker=self.breaker)
        if shed is not None:
            self._raise_shed(shed)
        with self._cond:
            if self._stop:
                raise RuntimeError("engine has been shut down")
            # A span that can never fit the page pool is shed now; one that
            # fits only later waits in the queue.
            shed = self.cost_model.queue_check(
                now=now, deadline=deadline, n_pending=len(self._pending),
                max_pending=self.max_pending, qos=self.qos,
                page_need=self._paged_need(len(prompt), budget) if self.kv_pages else 0,
                pool_pages=self.kv_pool_pages if self.kv_pages else 0)
            if shed is not None:
                self._raise_shed(shed)
            self._pending.append(req)
            self.n_requests += 1
            self._cond.notify_all()
        return req

    def _raise_shed(self, shed) -> None:
        """Raise a cost-model :class:`~quorum_tpu_torch.sched.ShedDecision`
        as the engine's exception: a deadline shed counts like the
        scheduler's queue-stage expiry, a capacity shed carries the model's
        Retry-After hint on the ``QueueFullError``. ``_cond`` may be held
        (it is re-entrant)."""
        if shed.kind == "deadline":
            with self._cond:  # callers' threads race the scheduler's counts
                self.n_deadline_exceeded += 1
            obs.DEADLINE_EXCEEDED.inc(stage="queue")
            raise DeadlineExceeded("queue")
        if shed.kind == "breaker":
            raise EngineBreakerOpen(shed.retry_after)
        err = QueueFullError(shed.detail)
        err.retry_after = shed.retry_after
        raise err

    def stream_results(self, req: _Request | None) -> Iterator[int]:
        """Yield a submitted request's tokens as the scheduler produces them."""
        if req is None:
            return
        try:
            while True:
                kind, val = req.out.get()
                if kind == "tok":
                    yield val
                elif kind == "end":
                    return
                else:
                    raise val
        finally:
            # Consumer gone (or done): release the slot at the next boundary.
            req.cancel.set()

    def generate_stream(self, prompt_ids: list[int], *, max_new_tokens: int = 64,
                        sampler: SamplerConfig | None = None, seed: int = 0,
                        eos_id: int | None = None, cancel: threading.Event | None = None,
                        decode_chunk: int | None = None, member: int = 0,
                        **knobs) -> Iterator[int]:
        """Yield generated token ids as they are produced (the EOS token, when
        hit, is the last id yielded). ``knobs`` are :meth:`submit`'s."""
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens, sampler=sampler,
                          seed=seed, eos_id=eos_id, cancel=cancel, decode_chunk=decode_chunk,
                          member=member, **knobs)
        yield from self.stream_results(req)

    def generate(self, prompt_ids: list[int], *, max_new_tokens: int = 64,
                 sampler: SamplerConfig | None = None, seed: int = 0,
                 eos_id: int | None = None, member: int = 0) -> GenerationResult:
        out = GenerationResult()
        for t in self.generate_stream(prompt_ids, max_new_tokens=max_new_tokens,
                                      sampler=sampler, seed=seed, eos_id=eos_id,
                                      member=member):
            out.token_ids.append(t)
        if eos_id is not None and out.token_ids and out.token_ids[-1] == eos_id:
            out.token_ids.pop()
            out.finish_reason = "stop"
        return out

    def metrics(self) -> dict:
        """Scheduler/capacity counters (the JAX engine's names; the
        ``decode_graph_*`` ones are the port's: captures, their seconds,
        replays, the graphs' pool bytes and the eager warm-up steps, all 0
        on the CPU; ``spec_draft_steps_total`` counts the draft model's
        decode steps, K2's launches per draft layer on the card).
        ``decode_chunks_total`` counts every dispatch,
        verify turns included; ``decode_steps_total`` only the plain
        chunks' steps. The ``prefix_store_restore_*`` and
        ``prefix_store_snapshot_bytes_total`` ones are the port's: the
        restores' blocking seconds and the bytes moved each way. The drain
        lifecycle's: ``draining`` (1 while submit is shut),
        ``drain_parked_total`` (streams a park retired) and
        ``replayed_tokens_total`` (regenerated tokens a resume's or a
        preemption's guard swallowed). The QoS scheduler's: ``qos``,
        ``preemptions_total``, ``preempted_tokens_total`` (delivered tokens
        the victims parked) and ``predictive_sheds_total``; zero-drain
        staging's: ``zero_drain`` and ``admission_overlap_total``
        (staged admissions that registered onto a live ring); disaggregated
        serving's (the JAX engine's): ``disagg``, ``prefill_sp``, each
        group's devices and occupancy, and the handoffs' count, bytes and
        seconds."""
        g = self._graphs
        with self._cond:
            return {
                "slots": self._rows,
                "members": self.members,
                "busy_slots": sum(1 for r in self._slots if r is not None),
                "admitting": len(self._admitting),
                "pending": len(self._pending),
                "queue_limit": self.max_pending,
                "requests_total": self.n_requests,
                "tokens_total": self.n_tokens,
                "member_tokens_total": list(self.n_member_tokens),
                "failures_total": self.n_failures,
                "cancellations_total": self.n_cancelled,
                "rebuilds_total": self.n_rebuilds,
                "admissions_total": self.n_admissions,
                "admission_dispatches_total": self.n_admission_dispatches,
                "prefill_segments_total": self.n_prefill_segments,
                "prefix_hits_total": self.prefix_hits,
                "prefix_tokens_saved_total": self.prefix_tokens_saved,
                "quorum_dedup_tokens_total": self.quorum_dedup_tokens,
                "quorum_dedup_prefills_total": self.quorum_dedup_prefills,
                "decode_chunks_total": self.n_decode_chunks,
                "decode_steps_total": self.n_decode_steps,
                "decode_busy_rows_total": self.n_decode_rows,
                "overlapped_chunks_total": self.n_overlapped,
                "overrun_tokens_total": self.n_overrun,
                "constrained_requests_total": self.n_constrained,
                "constrain_masked_tokens_total": self.n_constrain_masked,
                "deadline_exceeded_total": self.n_deadline_exceeded,
                "spec_turns_total": self.n_spec_turns,
                "spec_accepted_total": self.n_spec_accepted,
                "spec_draft_tokens_total": self.n_spec_drafted,
                "spec_overlapped_total": self.n_spec_overlapped,
                "spec_draft_steps_total": self.n_draft_steps,
                "deadline_clamps_total": self.n_deadline_clamps,
                "breaker_state": self.breaker.state_code,
                "decode_pipeline": self.decode_pipeline,
                "decode_loop": self.decode_loop,
                "decode_loop_chunks_total": self.n_loop_chunks,
                "decode_graph_captures_total": g.captures if g else 0,
                "decode_graph_capture_seconds_total": round(g.capture_seconds, 6) if g else 0.0,
                "decode_graph_replays_total": g.replays if g else 0,
                "decode_graph_pool_bytes": g.pool_bytes if g else 0,
                "decode_graph_warmup_steps_total": self.n_graph_warmup_steps,
                "prefill_chunk": self.prefill_chunk,
                "kv_pages": 1 if self.kv_pages else 0,
                "kv_page_size": self.kv_page_size,
                "kv_pages_allocated": self._page_alloc.allocated_pages if self.kv_pages else 0,
                "kv_pages_free": self._page_alloc.free_pages if self.kv_pages else 0,
                "kv_page_alias_hits_total": self.kv_page_alias_hits,
                "kv_page_cow_copies_total": self.kv_page_cow_copies,
                "prefix_store_hits_total": self.prefix_store_hits,
                "prefix_store_restored_tokens_total": self.prefix_store_tokens_restored,
                "prefix_store_snapshots_dropped_total": self.prefix_store_snapshots_dropped,
                "prefix_store_restore_seconds_total": round(self.prefix_store_restore_s, 6),
                "prefix_store_restore_bytes_total": self.prefix_store_restore_bytes,
                "prefix_store_snapshot_bytes_total": self.prefix_store_snapshot_bytes,
                "prefix_store_evictions_total": (self.prefix_store.n_evictions
                                                 if self.prefix_store is not None else 0),
                "prefix_store_bytes": (self.prefix_store.bytes_held
                                       if self.prefix_store is not None else 0),
                "prefix_store_entries": (self.prefix_store.n_entries
                                         if self.prefix_store is not None else 0),
                "inflight_chunks": len(self._inflight),
                "zero_drain": 1 if self.zero_drain else 0,
                "decode_pp": self.decode_pp,
                "disagg": 1 if self.disagg else 0,
                "prefill_sp": self.prefill_sp,
                "prefill_group_devices": self.prefill_mesh.size if self.disagg else 0,
                "decode_group_devices": ((self.mesh.size if self.mesh is not None else 1)
                                         if self.disagg else 0),
                "prefill_group_active": len(self._admitting) if self.disagg else 0,
                "decode_group_active": (sum(1 for r in self._slots if r is not None)
                                        if self.disagg else 0),
                "kv_handoffs_total": self.n_kv_handoffs,
                "kv_handoff_bytes_total": self.kv_handoff_bytes,
                "kv_handoff_seconds_total": round(self.kv_handoff_s, 6),
                "admission_overlap_total": self.n_admission_overlap,
                "admission_stall_seconds_total": round(self.admission_stall_s, 6),
                "drain_gap_seconds_total": round(self.drain_gap_s, 6),
                "qos": 1 if self.qos else 0,
                "preemptions_total": self.n_preemptions,
                "preempted_tokens_total": self.n_preempted_tokens,
                "predictive_sheds_total": self.cost_model.n_predictive_sheds,
                "replayed_tokens_total": self.n_replayed_tokens,
                "draining": 1 if self.draining else 0,
                "drain_parked_total": self.n_drain_parked,
            }

    def health(self) -> dict:
        """Liveness signals for /health and /ready: every field is an
        observation (thread liveness, breaker state, queue depth), never a
        hardcoded OK. Host state only: no device sync."""
        with self._cond:
            pending, stopped = len(self._pending), self._stop
        return {
            "scheduler_alive": self._thread.is_alive() and not stopped,
            # The second loop of a disaggregated engine (the prefill
            # group's); a colocated engine has one loop.
            "prefill_scheduler_alive": (self._prefill_thread.is_alive() and not stopped
                                        if self.disagg else True),
            "snapshot_worker_alive": (self.prefix_store is None
                                      or self._snap_thread.is_alive()),
            "breaker": self.breaker.state,
            "pending": pending,
            "queue_limit": self.max_pending,
            "rebuilds_total": self.n_rebuilds,
            # A draining engine still answers /health but sheds /ready.
            "draining": self.draining,
            # A mesh engine: its ranks, their backend, whether every worker
            # is alive, and how it decodes (graphs over NCCL on a card;
            # eagerly over gloo, whose collectives go through the host).
            "mesh": None if self.mesh is None else {
                "ranks": self.mesh.size, "shape": self.mesh.shape,
                "backend": self.mesh.backend, "sp_impl": self.sp_impl,
                # The slot rows' layout over dp: each dp group's block, or
                # every row on every group when dp does not divide them.
                "dp": self.mesh.shape["dp"],
                # Pipeline stages (pp > 1: staged decode and admission).
                "decode_pp": self.decode_pp,
                "slot_rows": ("sharded" if self._rmesh.splits_slots else "replicated"),
                "rank0_rows": list(self._rmesh.slots[:2]),
                "workers_alive": self._ranks.lost is None and len(self._ranks.alive_pids())
                == self.mesh.size - 1,
                "decode": ("graphs" if self._graphs is not None
                           else "eager (gloo)" if self.device.type == "cuda" else "eager")},
            # Disaggregated serving: each group's devices and the handoff's
            # route (chosen from the layout before the first handoff).
            "disagg": None if not self.disagg else {
                "prefill_devices": [str(d) for d in self.prefill_mesh.devices],
                "decode_devices": ([str(d) for d in self.mesh.devices] if self.mesh is not None
                                   else [str(self.device)]),
                "prefill_workers_alive": (self._pranks is None or (
                    self._pranks.lost is None
                    and len(self._pranks.alive_pids()) == self.prefill_mesh.size - 1)),
                "route": self.handoff_route},
        }

    def busy(self) -> bool:
        """Whether a slot holds a request: read without the lock, a hint
        for the forwards' sub-batch budget (``embed.forward_budget``)."""
        return any(r is not None for r in self._slots)

    @contextlib.contextmanager
    def forward_scope(self) -> Iterator[None]:
        """Where an embedding or scoring forward runs, on the caller's
        thread: without autograd, and on the card on the engine's forward
        stream. The host syncs only when it fetches the results."""
        with torch.no_grad():
            if self._fwd_stream is None:
                yield
                return
            with torch.cuda.device(self.device), torch.cuda.stream(self._fwd_stream):
                yield

    @contextlib.contextmanager
    def forward_ranks(self, tokens: torch.Tensor, lengths: torch.Tensor, member: int | None,
                      spans=(), plain_attention: bool = False) -> Iterator:
        """Around one cache-free forward sub-batch of rank 0 (inside
        :meth:`forward_scope`): yields the mesh it runs over. On one device
        None: the forward runs beside the ring. On a mesh engine the
        scheduler first parks at a turn boundary with its streams drained
        (:meth:`_ring_parked`), the workers of rank 0's dp group get the
        plan that runs the same forward (host ``tokens [b, t]`` and
        ``lengths [b]``, the weight set ``member`` of a stacked engine, the
        scored ``spans``), the body runs over rank 0's forward view
        (``RankMesh.fwd``: tp, sp and pp groups of its own;
        ``engine/embed.py``), and the forward stream drains before the ring
        resumes. NCCL kernels of two communicators
        running at once on a rank may each wait for a peer that runs the
        other first: a forward's all-reduce beside the verify turns' on four
        H100s hung both ranks, so a forward never runs beside the ring's
        collectives; a live stream waits one sub-batch at a time."""
        if self._ranks is None:
            yield None
            return
        with self._ring_parked():
            self._plan("forward", tokens.numpy(), lengths.numpy(), member, list(spans),
                       bool(plain_attention))
            try:
                yield self._rmesh.fwd
            finally:
                if self._fwd_stream is not None:
                    self._fwd_stream.synchronize()

    @contextlib.contextmanager
    def _ring_parked(self) -> Iterator[None]:
        """Hold the scheduler parked at a turn boundary, its ring and
        staging streams drained (``_park_ring``), for the duration; one
        holder at a time (``_fwd_lock``)."""
        with self._fwd_lock:
            with self._cond:
                self._park_want = True
                self._cond.notify_all()
                while not self._parked:
                    if self._stop or not self._thread.is_alive():
                        self._park_want = False
                        raise RuntimeError("the engine's scheduler is not running")
                    self._cond.wait(0.05)
            try:
                yield
            finally:
                with self._cond:
                    self._park_want = False
                    self._cond.notify_all()

    def _park_ring(self) -> None:
        """The scheduler's half of :meth:`_ring_parked`: drain the device
        work it issued (the dispatches in flight stay in the ring, their
        outputs ready for their reap), then wait until the holder lets go."""
        for stream in (self._stream, self._stage_stream):
            if stream is not None:
                stream.synchronize()
        with self._cond:
            self._parked = True
            self._cond.notify_all()
            while self._park_want and not self._stop:
                self._cond.wait()
            self._parked = False

    def drain(self, park: bool = False) -> dict:
        """Begin a graceful drain: submit sheds with a retryable
        ``QueueFullError`` from now on, and residents either finish
        (default) or are parked (``park=True``): queued requests end
        ``parked`` at once, active rows at the next scheduler turn
        (:meth:`_sweep_drain_parks`). Idempotent; returns
        :meth:`drain_status`."""
        parked_pending: list[_Request] = []
        with self._cond:
            self.draining = True
            if park:
                self._draining_park = True
                # Queued requests never touched device state: retired here,
                # not after rows that are being parked themselves.
                parked_pending = list(self._pending)
                self._pending.clear()
                self.n_drain_parked += len(parked_pending)
            self._cond.notify_all()
        for r in parked_pending:
            r.parked = True
            r.out.put(("end", None))
            FLIGHT.record("drain-park", rid=r.rid, engine=self._tag, loop="decode", row=-1,
                          emitted=r.emitted)
        return self.drain_status()

    def undrain(self) -> dict:
        """Reopen submit (clears both drain flags); returns
        :meth:`drain_status`."""
        with self._cond:
            self.draining = False
            self._draining_park = False
            self._cond.notify_all()
        return self.drain_status()

    def drain_status(self) -> dict:
        """Drain progress: ``resident`` counts every stream still attached
        (active rows, chunked admissions, the queue); 0 means the engine
        holds no client state."""
        with self._cond:
            busy = sum(1 for r in self._slots if r is not None)
            return {"draining": self.draining, "park": self._draining_park,
                    "resident": busy + len(self._admitting) + len(self._pending),
                    "parked_total": self.n_drain_parked}

    def shutdown(self, timeout: float = 30.0) -> None:
        """Cancel pending/active requests, join the scheduler thread, and drop
        the weights and cache so a shut-down engine holds no device memory."""
        with self._cond:
            self._stop = True
            for r in (list(self._slots) + list(self._pending)
                      + [a.req for a in self._admitting]):
                if r is not None:
                    r.cancel.set()
            self._cond.notify_all()
        if self._prefill_thread is not None:
            self._prefill_thread.join(timeout=timeout)
        self._thread.join(timeout=timeout)
        if self.prefix_store is not None:
            self._snap_queue.put(None)
            self._snap_thread.join(timeout=timeout)
            self.prefix_store.clear()
        if self._ranks is not None:
            if not self._thread.is_alive() and self._graphs is not None:
                # Our graphs hold their NCCL collectives' resources, which
                # the groups' shutdown waits for: destroy them first.
                self._stream.synchronize()
                self._graphs.clear()
                torch.cuda.synchronize(self.device)
            # Workers stop (killed past the timeout) even when a device call
            # of ours still runs: a collective waiting on them then fails.
            self._ranks.stop(timeout_s=min(timeout, 30.0))
        if self._pranks is not None:
            self._pranks.stop(timeout_s=min(timeout, 30.0))
        if self._thread.is_alive() or (self._prefill_thread is not None
                                       and self._prefill_thread.is_alive()):
            return  # a device call is still running; the GC reclaims state later
        if self._stream is not None:
            self._stream.synchronize()  # nothing of ours may still read what we free
            self._fwd_stream.synchronize()
            for extra in (self._stage_stream, self._handoff_stream):
                if extra is not None:
                    extra.synchronize()
            if self._graphs is not None:
                self._graphs.clear()
        self.params = self._prefill_params = None
        self._ck = self._cv = self._table = None
        self._sck = self._scv = None
        self._handoffs.clear()
        self._outbox.clear()
        self._draft_rt = None
        self._g_trans = self._g_accept = None
        self._host_pool.clear()

    # ---- multi-rank engines ------------------------------------------------

    def _start_ranks(self, spec: ModelSpec, mesh, seed: int, params, n_slots: int,
                     ckpt: tuple[str, str] | None = None):
        """Start the mesh's worker ranks (``parallel/ranks.RankGroup``; each
        builds an ``engine/follower.Follower``), build this rank's shard of
        the weights while they start, then join the groups. Returns rank
        0's shard. Given ``params`` (a full tree, member-stacked on a
        stacked engine) are cut for every rank (quantized whole first with
        ``quant``) and the workers' cuts sent at their spawn; given
        ``ckpt`` (a local HF checkpoint's path and dtype) every rank reads
        its own cut from the mapped files (``models/hf_loader``) and
        nothing is shipped; else every rank draws its own cut of
        ``init_params(spec, seed, quant=)`` (of ``init_params_stacked`` over
        the weight sets' seeds on a stacked engine)."""
        self._ranks = RankGroup(mesh, setup=self._follower_setup(mesh, spec, seed, params,
                                                                 n_slots, ckpt, decode=True),
                                staging=self.zero_drain, forward=True).spawn()
        try:
            mine = self._rank_weights(spec, mesh, seed, params, ckpt, self.device)
            self._rmesh = self._ranks.join()
            self._rmesh.hold_slots(max(1, int(n_slots)))
        except BaseException:
            self._ranks.stop()
            raise
        return mine

    def _follower_setup(self, mesh, spec: ModelSpec, seed: int, params, n_slots: int,
                        ckpt: tuple[str, str] | None, decode: bool = False):
        """The ``RankGroup`` set-up of a worker of ``mesh``: its Follower
        and the engine knobs that shape its weights and cache (a
        ``params=`` engine ships each worker its cut, int8 leaves in the
        JAX package's layout); a ``decode`` group's cache is paged with
        ``kv_pages`` and has a staging cache beside it with ``zero_drain``
        (a disaggregated prefill group's cache is its cut of the staging
        cache)."""
        dtype = None  # a plain leaf's (int8 leaves keep int8 and float32 scales)
        if params is not None:
            dtype = str(params["blocks"]["attn_norm_w"].dtype).removeprefix("torch.")
        knobs = dict(spec=spec, seed=int(seed), rows=max(1, int(n_slots)), sp_impl=self.sp_impl,
                     ckpt=ckpt, quant=self.quant, kv_quant=self.kv_quant, seeds=self._seeds,
                     members=self.members, ensemble=self.ensemble,
                     kv_pages=((self.kv_pool_pages, self.kv_page_size)
                               if decode and self.kv_pages else None),
                     zero_drain=decode and self.zero_drain)

        def setup(rank: int):
            shard = None
            if params is not None:
                cut = shard_params(params, mesh, rank, spec, quant=self.quant)
                shard = (to_host(jax_layout_params(cut)), dtype)
            return ("quorum_tpu_torch.engine.follower:Follower", dict(knobs, shard=shard))

        return setup

    def _rank_weights(self, spec: ModelSpec, mesh, seed: int, params,
                      ckpt: tuple[str, str] | None, device):
        """Rank 0's cut of the weights on ``mesh`` (:meth:`_start_ranks`)."""
        if ckpt is not None:
            from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint

            return load_hf_checkpoint(ckpt[0], dtype=ckpt[1], device=device, quant=self.quant,
                                      mesh=mesh, rank=0)[1]
        if params is not None:
            return shard_params(params, mesh, 0, spec, quant=self.quant)
        if max(self.members, self.ensemble) > 1:
            return init_params_stacked_shard(spec, self._seeds, mesh, 0, device,
                                             quant=self.quant)
        return init_params_shard(spec, seed, mesh, 0, device, quant=self.quant)

    def _start_prefill_group(self, spec: ModelSpec, seed: int, given, n_slots: int,
                             ckpt: tuple[str, str] | None):
        """The prefill group's weights on its first device (disagg): with
        one device beside a one-device decode group, a copy of the decode
        weights (the same tensors when both share a device); beside a
        decode mesh, the whole weights drawn or read there; a group of
        several ranks starts its workers (``engine/follower.Follower``s
        whose cache is their cut of the staging cache) as
        :meth:`_start_ranks` does and returns rank 0's cut."""
        pm, dev = self.prefill_mesh, self.prefill_device
        if pm.size == 1:
            if self.mesh is None:
                return _params_on(self.params, dev)
            if ckpt is not None:
                from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint

                return load_hf_checkpoint(ckpt[0], dtype=ckpt[1], device=dev,
                                          quant=self.quant)[1]
            if given is not None:
                return _params_on(quantize_params(given) if self.quant else given, dev)
            if max(self.members, self.ensemble) > 1:
                return init_params_stacked(spec, self._seeds, dev, quant=self.quant)
            return init_params(spec, seed, dev, quant=self.quant)
        self._pranks = RankGroup(pm, setup=self._follower_setup(pm, spec, seed, given, n_slots,
                                                                ckpt)).spawn()
        try:
            mine = self._rank_weights(spec, pm, seed, given, ckpt, dev)
            self._prmesh = self._pranks.join()
            self._prmesh.hold_slots(max(1, int(n_slots)))
        except BaseException:
            self._pranks.stop()
            self._pranks = None
            raise
        return mine

    def _pplan(self, op: str, *args) -> None:
        """:meth:`_plan` for the prefill group's workers (disagg); a lost
        one raises ``WorkerLost`` and opens the breaker for good."""
        if self._pranks is not None:
            try:
                self._pranks.plan(op, *args)
            except WorkerLost:
                self.breaker.trip()
                raise

    def prefill_rank_reports(self, reset_peak: bool = False) -> list[dict]:
        """The prefill group's workers' ``Follower.report`` (disagg with a
        prefill group of several ranks; empty otherwise)."""
        if self._pranks is None:
            return []
        return self._pranks.plan("report", reset_peak, False, reply=True)

    def _plan(self, op: str, *args) -> None:
        """Send the workers the plan of the device program rank 0 is about
        to issue (a no-op without a mesh). A lost worker raises
        ``WorkerLost`` and trips the breaker."""
        if self._ranks is not None:
            if self._ranks_lost():
                raise self._ranks.lost
            self._ranks.plan(op, *args)

    def _ranks_lost(self) -> bool:
        """Whether a worker rank is gone (checked now); the first time,
        the breaker opens at once and stays open: every later submit is a
        503 (``EngineBreakerOpen``)."""
        if self._ranks is None:
            return False
        if self._ranks.lost is None:
            try:
                self._ranks.check()
                return False
            except WorkerLost as e:
                logger.error("engine lost a rank of its mesh: %s", e)
                FLIGHT.record("breaker", engine=self._tag, state="open",
                              error=str(e)[:200])
        self.breaker.trip()
        return True

    def _raise_if_rank_lost(self) -> None:
        """After a host read of device outputs: a worker lost meanwhile
        (its groups aborted under the read) voids them."""
        if self._ranks is not None and self._ranks.lost is not None:
            self._ranks_lost()
            raise self._ranks.lost

    def rank_reports(self, reset_peak: bool = False, digest: bool = False) -> list[dict]:
        """Every worker rank's ``Follower.report`` (rank 1 first): its
        pipeline stage, the tokens it fed per row since the last report,
        its launches, collectives, bytes and peak memory, and with
        ``digest`` its weight leaves' fingerprints. [] without a mesh.
        Called from any thread while the engine is idle (it is a plan)."""
        if self._ranks is None or self._ranks.size == 1:
            return []
        return self._ranks.plan("report", reset_peak, digest, reply=True)

    def worker_pids(self) -> list[int]:
        """The live worker ranks' process ids ([] without a mesh)."""
        return [] if self._ranks is None else self._ranks.alive_pids()

    # ---- paged KV and the host prefix store: construction ------------------

    def _init_paging(self, kv_pages, kv_page_size, kv_pool_pages, draft_spec) -> None:
        """Paged KV slot memory (``kv_pages=1``), with the JAX engine's
        checks and defaults: the page size defaults to ``prefill_chunk``
        (else ``min(64, max_seq)``), the pool to the dense rectangle's
        ``n_slots × max_seq / page_size`` pages. The host owns the page
        table (``_table_host [n_slots, max_pages]``, under ``_cond``) and
        uploads it in place at admission and release boundaries; one claim
        count per slot group (on a stacked engine the M member rows of slot
        s share ONE chain, each member reading its own pool copy)."""
        self.kv_pages = bool(kv_pages)
        self.kv_page_size = self.kv_pool_pages = 0
        self._page_alloc: PageAllocator | None = None
        self.kv_page_alias_hits = self.kv_page_cow_copies = 0
        if not self.kv_pages:
            return
        if self.ensemble > 1:
            raise ValueError(
                "kv_pages=1 does not compose with ensemble>1: member m "
                "reads its history through its OWN pool copy — "
                "pool[m, table[m, slot]] — but the host allocator keeps "
                f"one page chain per slot group ({self.n_slots} "
                f"chains), not one per member row ({self.ensemble}x"
                f"{self.n_slots}), so per-member tables can never "
                "diverge. Stacked members=M share each slot group's "
                "history by construction (one prompt per group, one "
                "chain) and compose; consensus rows would need "
                "per-member chains — run ensemble cells dense or drop "
                "one knob")
        if draft_spec is not None:
            raise ValueError(
                "kv_pages=1 does not compose with a draft model "
                "(spec_model=/spec_ckpt=): the draft runtime keeps its "
                "own dense cache and the fused draft→verify scan would "
                "mix layouts in one program — prompt-lookup "
                "spec_decode composes")
        ps = int(kv_page_size) or self.prefill_chunk or min(64, self.spec.max_seq)
        validate_page_config(self.spec.max_seq, ps)
        self.kv_page_size = ps
        mp = self.spec.max_seq // ps
        n_data = int(kv_pool_pages) or self.n_slots * mp
        if n_data < 1:
            raise ValueError(f"kv_pool_pages={kv_pool_pages} must be >= 1")
        self.kv_pool_pages = n_data
        self._page_alloc = PageAllocator(n_data, ps)
        self._table_host = torch.zeros((self.n_slots, mp), dtype=torch.int32)
        self._page_claims = [0] * self.n_slots
        self._table_dirty = False

    def _init_store(self, prefix_store, prefix_store_bytes, prefix_store_chunk) -> None:
        """The host prefix store (``prefix_store=host``), with the JAX
        engine's checks: released slots' prefixes are snapshotted to host
        RAM by a worker thread, and an admission whose store match beats
        the slot-resident reuse restores it and prefills only the tail."""
        mode = (prefix_store or "").strip().lower() or None
        if mode not in (None, "host"):
            raise ValueError(
                f"unsupported prefix_store mode {prefix_store!r} "
                "(host or none)")
        self.prefix_store: PrefixStore | None = None
        # Releases whose snapshot waits for the next scheduler turn, and
        # the snapshots not yet handed to the worker.
        self._pending_snaps: list[tuple[int, list[int]]] = []
        self._snap_backlog = 0
        self.prefix_store_hits = 0
        self.prefix_store_tokens_restored = 0
        self.prefix_store_snapshots_dropped = 0
        self.prefix_store_restore_s = 0.0
        self.prefix_store_restore_bytes = 0
        self.prefix_store_snapshot_bytes = 0
        if not mode:
            return
        if self.members > 1:
            raise ValueError(
                "prefix_store does not compose with members>1: the "
                "stacked cache carries a member axis the single-slot "
                "snapshot/restore programs do not address — run "
                "separate engines or drop prefix_store")
        if self.ensemble > 1:
            raise ValueError(
                "prefix_store does not compose with ensemble>1 (the "
                "member-stacked cache is not snapshot/restored)")
        if self.prefill_chunk <= 0:
            raise ValueError(
                "prefix_store requires chunked prefill (prefill_chunk "
                ">= 16 after power-of-two alignment): restoring a "
                "prefix prefills only the tail, through the segment "
                "machinery")
        chunk = int(prefix_store_chunk) or self.prefill_chunk
        if chunk > self.spec.max_seq:
            raise ValueError(
                f"prefix_store_chunk={chunk} exceeds max_seq="
                f"{self.spec.max_seq}: no prefix could ever be stored")
        self.prefix_store = PrefixStore(chunk, int(prefix_store_bytes))
        self._snap_queue: queue.Queue = queue.Queue()
        # Started with the scheduler thread, once the engine is built.
        self._snap_thread = threading.Thread(target=self._snapshot_worker, daemon=True,
                                             name="quorum-torch-prefix-store")

    # ---- paged KV bookkeeping (kv_pages=1) ---------------------------------
    #
    # Admission reserves a row's FULL page span up front (prompt + budget +
    # the speculative overshoot), so a live row's table entries never change
    # while it decodes and a short pool sheds or queues at admission instead
    # of failing a running stream. Allocator and mirror change under _cond;
    # the COW copies and the table upload run on the scheduler thread, on
    # the engine's stream, before the admission's first cache write.
    #
    # A row whose entries change while a dispatch issued earlier still
    # reads them is dead in that dispatch or was released by the host: a
    # released row is masked out of every later dispatch, and a dispatch
    # issued before the release runs before the upload and the new
    # tenant's writes (one stream), which overwrite whatever it wrote.

    def _paged_note_occupancy(self) -> None:
        """Refresh the pool-occupancy gauges after an allocator change
        (caller holds ``_cond``); last writer wins across engines."""
        a = self._page_alloc
        obs.KV_PAGES_ALLOCATED.set(a.allocated_pages)
        obs.KV_PAGES_FREE.set(a.free_pages)

    def _paged_need(self, n_prompt: int, budget: int) -> int:
        """Pages covering every position a request could write: prompt,
        budget and the speculative-verify overshoot (a verify turn writes
        up to spec_decode+1 positions past the accepted length)."""
        need_t = min(self.spec.max_seq, n_prompt + budget + self.spec_decode + 1)
        return self._page_alloc.pages_for(need_t)

    def _paged_fits(self, row: int, req: _Request) -> bool:
        """Whether a claim of ``row`` for ``req`` can succeed after LRU
        reclaim: the admission's head-of-line check (caller holds
        ``_cond``). A fresh claim of a slot group may drop its OWN retained
        donor, so those pages count as available too."""
        a = self._page_alloc
        sg = row % self.n_slots
        n_need = self._paged_need(len(req.prompt_ids), req.budget)
        if self._page_claims[sg]:
            n_need -= len(a.chain(sg) or [])
            return n_need <= a.free_pages + a.reclaimable_pages(protect=(sg,))
        return n_need <= a.free_pages + a.reclaimable_pages()

    def _paged_reclaim(self, n: int, protect=()) -> bool:
        """Evict least-recently-retained chains until ``n`` pages are free
        (caller holds ``_cond``). An evicted row loses its resident prefix:
        its KV bytes are gone."""
        a = self._page_alloc
        while a.free_pages < n:
            victim = a.evict_lru(protect=protect)
            if victim is None:
                return False
            if not self._page_claims[victim]:
                for m in range(self.members):
                    self._resident[m * self.n_slots + victim] = []
                self._table_host[victim, :] = 0
            self._table_dirty = True
        return True

    def _paged_claim(self, row: int, req: _Request, reuse: int):
        """Reserve flat row ``row``'s full page span for ``req`` (caller
        holds ``_cond``): ``(reuse, cow_pairs)`` — the tier-0 reuse, clamped
        to what the slot's retained chain still covers, and the (dst, src)
        boundary pages to copy before the admission's first write — or
        None when the pool cannot cover the span even after reclaim.

        Reuse SHARES the retained chain's pages (refcount bump; the donor
        entry stays), and a partly filled boundary page is replaced by a
        private copy. On stacked engines reuse is 0: the M member rows of a
        slot group share one chain, and a later member joining a live
        chain only extends it."""
        a = self._page_alloc
        sg = row % self.n_slots
        ps = self.kv_page_size
        n_need = self._paged_need(len(req.prompt_ids), req.budget)
        cow: list[tuple[int, int]] = []
        if self.members > 1:
            reuse = 0
        if self._page_claims[sg]:
            chain = a.chain(sg) or []
            extra = n_need - len(chain)
            if extra > 0:
                if not self._paged_reclaim(extra, protect=(sg,)):
                    return None
                fresh = a.alloc(extra)
                if fresh is None:  # pragma: no cover - reclaim guarantees
                    return None
                base = len(chain)
                a.extend(sg, fresh)
                self._table_host[sg, base:base + extra] = torch.tensor(fresh, dtype=torch.int32)
                self._table_dirty = True
                self._paged_note_occupancy()
            self._page_claims[sg] += 1
            return 0, cow
        held = a.retained_chain(sg)
        if reuse and (held is None or len(held) * ps < reuse):
            reuse = 0
        p_keep = a.pages_for(reuse)
        partial = bool(reuse % ps)
        n_new = n_need - p_keep + (1 if partial else 0)
        # Share the reused prefix BEFORE any donor drop or reclaim.
        keep = a.share(held[:p_keep]) if p_keep else []
        if n_new > a.free_pages:
            # The group's own retained donor is a page source for its own
            # claim (the kept prefix survives through the share above).
            a.drop_retained(sg)
        fresh: list[int] = []
        if n_new > 0:
            if not self._paged_reclaim(n_new, protect=(sg,)):
                if keep:
                    a.free(keep)
                return None
            got = a.alloc(n_new)
            if got is None:  # pragma: no cover - reclaim guarantees
                if keep:
                    a.free(keep)
                return None
            fresh = got
        a.touch(sg)
        if partial:
            repl = fresh.pop()
            cow.append((repl, keep[-1]))
            a.free([keep[-1]])
            keep[-1] = repl
        chain = keep + fresh
        a.assign(sg, chain)
        self._table_host[sg, :] = 0
        self._table_host[sg, :len(chain)] = torch.tensor(chain, dtype=torch.int32)
        self._table_dirty = True
        self._page_claims[sg] = 1
        if reuse:
            self.kv_page_alias_hits += 1
            obs.KV_PAGE_ALIAS_HITS.inc()
        self._paged_note_occupancy()
        return reuse, cow

    def _paged_release_row(self, row: int) -> None:
        """Drop one live claim on ``row``'s slot group (caller holds
        ``_cond``); with the last one, retain the chain's pages covering the
        resident tokens as a reuse donor and clear the table's tail. No-op
        on dense engines."""
        if not self.kv_pages:
            return
        a = self._page_alloc
        sg = row % self.n_slots
        if not self._page_claims[sg]:
            return
        self._page_claims[sg] -= 1
        if self._page_claims[sg]:
            return
        keep = 0 if self.members > 1 else len(self._resident[sg])
        chain = a.chain(sg) or []
        a.release(sg, keep_tokens=keep)
        self._paged_note_occupancy()
        kept = min(a.pages_for(keep), len(chain))
        if len(chain) > kept:
            self._table_host[sg, kept:len(chain)] = 0
            self._table_dirty = True

    def _paged_sync_table(self) -> None:
        """Upload the host table into the device table IN PLACE, on the
        engine's stream (graphs captured its address), each member's rows
        offset into that member's pool copy. The source is a fresh pinned
        tensor per upload: the caching host allocator keeps its block until
        the copy has run, so a later upload never overwrites a copy still
        queued. On a mesh every worker gets the whole table first (a
        ``table`` plan; each keeps its dp group's rows) and rank 0 uploads
        its own rows."""
        if not self.kv_pages:
            return
        with self._cond:
            if not self._table_dirty:
                return
            tab = self._table_host.clone()
            self._table_dirty = False
        m = self.members
        if m > 1:
            off = (torch.arange(m, dtype=torch.int32) * (self.kv_pool_pages + 1))
            tab = tab.repeat(m, 1) + off.repeat_interleave(self.n_slots)[:, None]
        if self._ranks is not None:
            self._plan("table", tab.numpy())
            lo, hi, _ = self._rmesh.slots
            tab = tab.view(m, self.n_slots, -1)[:, lo:hi].reshape(-1, tab.shape[-1])
        self._table.copy_(self._staged(tab), non_blocking=True)

    def _paged_install(self, cow) -> None:
        """The device half of a claim: the copy-on-write page copies (on
        every rank of a mesh: each pool holds every page id), then the
        table upload, on the engine's stream before the admission's first
        cache write."""
        if cow:
            self._plan("cow", cow)
        for dst, src in cow:
            paged_copy_page(self._ck, dst, src, members=self.members)
            paged_copy_page(self._cv, dst, src, members=self.members)
            self.kv_page_cow_copies += 1
            obs.KV_PAGE_COW_COPIES.inc()
        self._paged_sync_table()

    def _paged_claim_or_fail(self, req: _Request, slot: int, reuse: int) -> int | None:
        """Claim ``slot``'s pages for ``req`` and install them; the reuse
        the claim allows, or None (the request failed) when the pool came
        up short after the fits check."""
        with self._cond:
            claim = self._paged_claim(slot, req, reuse)
        if claim is None:
            self.n_failures += 1
            req.out.put(("err", RuntimeError(
                "kv page claim failed after passing the fits check")))
            return None
        self._paged_install(claim[1])
        return claim[0]

    # ---- the host prefix store ---------------------------------------------

    def _queue_snapshot(self, slot: int) -> None:
        """Note a released slot whose prefix should reach the store (caller
        holds ``_cond``); the slice is issued at the next scheduler turn
        (``_dispatch_snapshots``), before any admission can claim it."""
        if self.prefix_store is None:
            return
        tokens = self._resident[slot]
        c = self.prefix_store.chunk_tokens
        n = len(tokens) - len(tokens) % c
        if n >= max(c, MIN_PREFIX_REUSE):
            self._pending_snaps.append((slot, tokens[:n]))
            self._snap_backlog += 1

    def _dispatch_snapshots(self) -> None:
        """Issue the deferred snapshot slices (scheduler thread, lock not
        held): only the chunks the store does not cover yet, cloned out of
        the cache on the engine's stream (a slot re-admitted at once cannot
        change them), handed to the worker behind an event."""
        if self.prefix_store is None:
            return
        with self._cond:
            pending, self._pending_snaps = self._pending_snaps, []
        for slot, tokens in pending:
            try:
                with self._cond:
                    stale = self._resident[slot][:len(tokens)] != tokens
                if stale:
                    continue
                if self._snap_queue.qsize() >= SNAP_QUEUE_MAX:
                    self.prefix_store_snapshots_dropped += 1
                    continue
                have = self.prefix_store.covered(tokens)
                if have >= len(tokens):
                    continue
                # On a mesh the holding group gathers its heads over tp
                # (and sends them over dp to rank 0's), in plan order.
                self._plan("snapshot", slot, have, len(tokens) - have)
                payload = kv_transfer.snapshot_rows((self._ck, self._cv), slot, have,
                                                    len(tokens) - have, self._rmesh, self.spec)
                event = None
                if self._stream is not None:
                    event = torch.cuda.Event()
                    event.record()
                self._snap_queue.put((tokens, have, payload, event))
            except Exception:
                # Snapshots are opportunistic: a failure loses one.
                logger.exception("prefix-store snapshot dispatch failed")
            finally:
                with self._cond:
                    self._snap_backlog -= 1

    def _snapshot_worker(self) -> None:
        """Copy dispatched snapshot slices to the host, chunk by chunk into
        pinned buffers on a side stream (after the slice's event), and
        insert them into the store."""
        side = None
        while True:
            item = self._snap_queue.get()
            try:
                if item is None:
                    return
                tokens, have, payload, event = item
                faults.fire("engine.snapshot")
                c = self.prefix_store.chunk_tokens
                leaves = kv_transfer.chunk_leaves(payload)
                n_chunks = (len(tokens) - have) // c
                parts = [[x[:, :, i * c:(i + 1) * c] for x in leaves] for i in range(n_chunks)]
                if event is None:
                    chunks = [kv_transfer.fetch_to_host(part) for part in parts]
                else:
                    if side is None:
                        torch.cuda.set_device(self.device)
                        side = torch.cuda.Stream(self.device)
                    with torch.cuda.stream(side):
                        side.wait_event(event)
                        chunks = [kv_transfer.fetch_to_host(part, out=[
                            torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in part])
                            for part in parts]
                        done = torch.cuda.Event()
                        done.record()
                    done.synchronize()
                del parts
                del payload, leaves
                self.prefix_store_snapshot_bytes += sum(a.nbytes for ch in chunks for a in ch)
                self.prefix_store.insert(tokens, have, chunks)
            except Exception:
                logger.exception("prefix-store snapshot insert failed")
            finally:
                self._snap_queue.task_done()

    def drain_prefix_store(self) -> None:
        """Block until every snapshot queued so far is in the store (tests
        and measurements; serving never waits): engine quiescence first (a
        finished request's slot is released just after its end sentinel),
        then the deferred slices, then the worker's queue."""
        if self.prefix_store is None:
            return
        while True:
            with self._cond:
                busy = (bool(self._pending) or bool(self._admitting) or any(self._slots)
                        or bool(self._inflight) or self._snap_backlog)
                if busy:
                    self._cond.notify_all()
            if busy:
                time.sleep(0.002)
                continue
            self._snap_queue.join()
            with self._cond:
                if not self._snap_backlog:
                    return

    def _wire_leaf_specs(self) -> list[tuple[tuple, torch.dtype]]:
        """(shape, dtype) of each leaf of a one-chunk wire payload."""
        spec, c = self.spec, self.prefix_store.chunk_tokens
        vals = (spec.n_layers, spec.n_kv_heads, c, spec.head_dim)
        if self.kv_quant:
            side = [(vals, torch.int8), (vals[:3], torch.float32)]
        else:
            side = [(vals, getattr(torch, spec.dtype))]
        return side * 2

    def export_prefix_chunks(self, max_bytes: int | None = None) -> bytes:
        """The store's restorable chunk chains in the migration wire format
        (``cache/prefix_wire.py``). Host work only."""
        if self.prefix_store is None:
            raise ValueError(
                "no host prefix store on this engine (prefix_store=host "
                "is not configured)")
        return prefix_wire.serialize_chains(
            self.prefix_store.export_chains(max_bytes=max_bytes),
            self.prefix_store.chunk_tokens)

    def import_prefix_chunks(self, blob: bytes) -> dict:
        """Seed the store from a wire blob, validated against this engine's
        cache layout (chunk size, leaf count, each leaf's dtype and shape)
        before anything is inserted. Returns the insert accounting."""
        if self.prefix_store is None:
            raise ValueError(
                "no host prefix store on this engine (prefix_store=host "
                "is not configured)")
        chunk_tokens, chains = prefix_wire.parse(blob)
        c = self.prefix_store.chunk_tokens
        if chunk_tokens != c:
            raise ValueError(
                f"payload chunk_tokens={chunk_tokens} does not match this "
                f"engine's prefix_store_chunk={c}")
        expected = self._wire_leaf_specs()
        for chain in chains:
            for arrays in chain.payloads:
                if len(arrays) != len(expected):
                    raise ValueError(
                        f"chunk carries {len(arrays)} arrays, this cache "
                        f"has {len(expected)} leaves")
                for a, (shape, dtype) in zip(arrays, expected):
                    if tuple(a.shape) != shape or a.dtype != dtype:
                        raise ValueError(
                            f"chunk leaf {tuple(a.shape)}/{a.dtype} does not "
                            f"match the cache layout {shape}/{dtype}")
        tokens_imported = chains_imported = 0
        for chain in chains:
            got = self.prefix_store.import_chain(chain.tokens, chain.payloads)
            if got:
                chains_imported += 1
                tokens_imported += got
        return {"chains": len(chains), "chains_imported": chains_imported,
                "tokens_imported": tokens_imported,
                "store_bytes": self.prefix_store.bytes_held,
                "store_entries": self.prefix_store.n_entries}

    def _store_lookup(self, prompt: list[int], slot_reuse: int):
        """``(restore_len, chunk payloads, first chunk index)`` when the
        store's longest match beats the slot-resident reuse, else None.
        The restore length obeys ``_reuse_len``'s rules: capped at len−1,
        aligned down to a ``prefill_chunk`` multiple, at least
        ``MIN_PREFIX_REUSE``."""
        if self.prefix_store is None:
            return None
        cap = len(prompt) - 1
        matched, payloads = self.prefix_store.longest_match(prompt[:cap])
        r = min(matched, cap)
        if self.prefill_chunk:
            r -= r % self.prefill_chunk
        if r < MIN_PREFIX_REUSE or r <= slot_reuse:
            return None
        return r, payloads

    def _restore_into(self, req: _Request, slot: int, start: int, end: int,
                      payloads, stage: bool = False) -> None:
        """Write the stored prefix's positions ``[start, end)`` into
        ``slot``'s cache rows (a paged slot's reserved pages), chunk by
        chunk from the host, on the current stream: only the tail past
        the slot-resident overlap ``[0, start)`` moves. ``stage`` writes
        the staging row instead (zero-drain: the tail's segments attend
        over it there, and the whole prefix reaches the decode row with the
        pieces). Blocks until the copies have landed: the restore's honest
        latency, observed on the restore histogram and as a
        ``prefix-restore`` span of ``req``."""
        t0 = time.perf_counter()
        c = self.prefix_store.chunk_tokens
        q8 = self.kv_quant is not None
        moved = 0
        # On a mesh each chunk goes from rank 0 to the ranks holding the
        # row, over the group that writes it (``kv_transfer.restore_rows``).
        if stage and self.disagg:
            mesh, plan = self._prmesh, self._pplan
        elif stage:
            mesh, plan = (None if self._rmesh is None else self._rmesh.stage), self._plan
        else:
            mesh, plan = self._rmesh, self._plan
        for k in range(start // c, -(-end // c)):
            lo, hi = max(start, k * c), min(end, (k + 1) * c)
            leaves = [x.to(self.prefill_device if stage else self.device,
                           non_blocking=True)[:, :, lo - k * c:hi - k * c].contiguous()
                      for x in payloads[k]]
            moved += sum(x.nbytes for x in leaves)
            plan("restore", slot, lo, hi - lo, stage)
            kv_transfer.restore_rows((self._sck, self._scv) if stage else (self._ck, self._cv),
                                     kv_transfer.chunk_from_leaves(leaves, q8), slot, lo,
                                     hi - lo, mesh, self.spec)
        if (self.prefill_device if stage else self.device).type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        t1 = time.perf_counter()
        obs.PREFIX_STORE_RESTORE.observe(t1 - t0)
        self._observe_device_time("restore", t1 - t0)
        obs.PREFIX_STORE_HITS.inc()
        obs.PREFIX_STORE_RESTORED_TOKENS.inc(end - start)
        self.prefix_store_hits += 1
        self.prefix_store_tokens_restored += end - start
        self.prefix_store_restore_s += t1 - t0
        self.prefix_store_restore_bytes += moved
        if req.trace is not None:
            req.trace.add_span_abs("prefix-restore", t0, t1, tokens=end - start, slot=slot)

    # ---- telemetry: traces, the flight recorder, device time --------------

    # Per-turn spans of one kind kept per request; past it a kind's last
    # span is extended (steps and accepted summed, turns counted).
    TURN_SPAN_CAP = 32

    def _turn_span(self, req: _Request, name: str, t0: float, t1: float, **meta) -> None:
        """Record one decode or verify turn on ``req``'s trace."""
        trace = req.trace
        if trace is None:
            return
        span, count = req.tspans.get(name, (None, 0))
        count += 1
        if span is not None and count > self.TURN_SPAN_CAP:
            span.end = trace.rel(t1)
            for k in ("steps", "accepted"):
                if k in meta and isinstance(span.meta.get(k), int):
                    span.meta[k] += meta[k]
            if "occupancy" in meta:
                span.meta["occupancy"] = max(span.meta.get("occupancy", 0), meta["occupancy"])
            span.meta["coalesced_turns"] = count - self.TURN_SPAN_CAP + 1
        else:
            span = trace.add_span_abs(name, t0, t1, **meta)
        req.tspans[name] = (span, count)

    def _note_admitted(self, req: _Request) -> None:
        """A pending request just claimed a row: close its queue wait (the
        histogram, the cost model's queue-wait EWMA, its ``queue-wait``
        span) and record the admission. A resumed victim's submit-to-admit
        gap holds its earlier service: no queue-wait observation."""
        now = time.perf_counter()
        req.t_admit = now
        if req.n_preempts == 0:
            obs.QUEUE_WAIT.observe(now - req.t_submit)
            self.cost_model.observe_queue_wait(now - req.t_submit)
        FLIGHT.record("admit", rid=req.rid, engine=self._tag, loop=self._admit_loop,
                      queue_wait_s=round(now - req.t_submit, 6))
        if req.trace is not None:
            req.trace.add_span_abs("queue-wait", req.t_submit, now, member=req.member)

    def _observe_device_time(self, family: str, seconds: float) -> None:
        """One per-family device-time observation: the engine's latency
        model and the process-wide ``quorum_tpu_dispatch_device_seconds``."""
        self.latency.observe(family, seconds)
        obs.DISPATCH_DEVICE_SECONDS.observe(max(0.0, seconds), family=family)

    def _record_breaker_failure(self) -> None:
        """Feed the failure breaker; on the transition to open only, record
        the breaker event and dump the flight recorder."""
        was_open = self.breaker.state == "open"
        self.breaker.record_failure()
        if not was_open and self.breaker.state == "open":
            FLIGHT.record("breaker", engine=self._tag, state="open")
            FLIGHT.dump("breaker-open")

    # ---- scheduler --------------------------------------------------------

    def _scheduler(self) -> None:
        try:
            if self._stream is None:
                self._schedule_forever()
            else:
                torch.cuda.set_device(self.device)
                with torch.cuda.stream(self._stream):
                    self._schedule_forever()
        except BaseException as e:
            # The thread is going away: no request may wait on it forever.
            logger.exception("engine scheduler thread died")
            with self._cond:
                self._stop = True
                doomed = ([r for r in self._slots if r is not None] + list(self._pending)
                          + [a.req for a in self._admitting])
                self._slots = [None] * self._rows
                self._pending.clear()
                self._admitting.clear()
                self._inflight.clear()
            for r in doomed:
                r.out.put(("err", RuntimeError(f"engine scheduler died: {e!r}")))
            raise

    def _has_work(self) -> bool:
        """Caller holds ``_cond``. Under disagg the queue and the admissions
        are the prefill loop's work (:meth:`_prefill_work`), not this
        loop's."""
        return bool((not self.disagg and (self._pending or self._admitting))
                    or any(self._slots) or self._inflight
                    or self._pending_snaps or self._handoffs)

    def _schedule_forever(self) -> None:
        """The JAX engine's turn order: deadlines, preemptions, drain
        parks, admissions (start, one segment each, then under zero-drain
        the staged pieces and registers), then the ring."""
        while True:
            with self._cond:
                while not (self._stop or self._has_work() or self._park_want):
                    if self.disagg:
                        obs.DECODE_GROUP_ACTIVE.set(sum(1 for r in self._slots
                                                        if r is not None))
                    self._cond.wait()
            if self._park_want:  # a forward on the ranks (``_ring_parked``)
                self._park_ring()
                continue
            with self._cond:
                if self._stop and not self._has_work():
                    if not (self.disagg and self._prefill_thread.is_alive()):
                        return
                    # The prefill loop still hands off its last pieces.
                    self._cond.wait(0.01)
                    continue
            try:
                with torch.no_grad():
                    self._sweep_deadlines()
                    self._sweep_preemptions()
                    self._sweep_drain_parks()
                    if self.disagg:
                        # The decode-side state work the colocated loop
                        # runs inside _start_admissions.
                        self._maybe_reset_arena()
                        self._dispatch_snapshots()
                    else:
                        self._start_admissions()
                        self._step_admissions()
                    if self.staged:
                        self._drain_handoffs()
                    if any(self._slots) or self._inflight:
                        self._run_chunk_steps()
                    else:
                        # No decode work: an idle gap must never read as stall.
                        self._note_admission_clamp(False)
            except Exception as e:  # keep serving: fail only the entangled requests
                logger.exception("engine scheduler turn failed")
                self._fail_all(e)

    # ---- admission --------------------------------------------------------

    @staticmethod
    def _lcp(a: list[int], b: list[int]) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _pick_slot(self, prompt: list[int], member: int = 0) -> tuple[int | None, int]:
        """(best free row of ``member``, its resident prefix shared with
        ``prompt``): the longest match wins, then the shortest resident
        content, so a request with no match lands on an empty row instead of
        evicting another conversation's reusable history. Caller holds
        ``_cond``."""
        best, best_score = None, None
        lo = member * self.n_slots
        for i in range(lo, lo + self.n_slots):
            if self._slots[i] is not None or i in self._claimed:
                continue
            lcp = self._lcp(self._resident[i], prompt) if self.prefix_cache else 0
            score = (lcp, -len(self._resident[i]))
            if best_score is None or score > best_score:
                best, best_score = i, score
        return best, best_score[0] if best_score else 0

    def _reuse_len(self, lcp: int, n_prompt: int) -> int:
        """Usable reuse: capped at n_prompt−1 (the last prompt token must run
        through a segment so the first decode step has its logits), aligned
        down to a ``prefill_chunk`` multiple (segment offsets stay aligned),
        zero below ``MIN_PREFIX_REUSE``."""
        reuse = min(lcp, n_prompt - 1)
        if self.prefill_chunk:
            reuse -= reuse % self.prefill_chunk
        return reuse if reuse >= MIN_PREFIX_REUSE else 0

    def _goes_chunked(self, req: _Request, reuse: int) -> bool:
        """A reused prefix, a prompt longer than one segment, a grammar
        (whatever the prompt's length: the single-shot admission samples
        the first token before any mask could apply) or a staging engine
        admits chunked."""
        return (bool(reuse) or req.grammar is not None or self.staged
                or (self.prefill_chunk > 0 and len(req.prompt_ids) > self.prefill_chunk))

    def _place_grammar(self, req: _Request) -> bool:
        """Place ``req``'s grammar in the arena (no lock held: a new table
        is a host-to-device copy) and note its start state; on failure
        (``GrammarArenaFull``) fail the request alone. True when ``req``
        may admit."""
        if req.grammar is None:
            return True
        try:
            req.g_start = self._ensure_grammar(req.grammar)
        except Exception as e:
            logger.warning("grammar placement failed: %s", e)
            self.n_failures += 1
            req.out.put(("err", e))
            return False
        self.n_constrained += 1
        return True

    def _claim_chunked(self, req: _Request, slot: int, reuse: int,
                       offset: int | None = None) -> None:
        """Start a chunked admission of ``req`` into ``slot`` past ``reuse``
        resident tokens (``offset``: past a restored prefix that ends
        there). Caller holds ``_cond``."""
        if reuse:
            self.prefix_hits += 1
            self.prefix_tokens_saved += reuse
        restored = 0 if offset is None else offset - reuse
        offset = reuse if offset is None else offset
        self._claimed.add(slot)
        # Beyond the valid prefix the row is in flux; advertise only what is valid.
        self._resident[slot] = req.prompt_ids[:offset]
        self._admitting.append(_Admission(req, slot, offset=offset, restored=restored))

    def _start_admissions(self) -> None:
        """Admit pending requests into free rows: the FIFO head, or with
        ``qos`` the policy's weighted-fair pick (charged when popped). A
        head that finds no row, or no pages, may flag a lower-class
        resident for parking (``_maybe_flag_preemption_locked``) and waits.
        Under zero-drain and disagg every admission is staged
        (``_admit_staged``); under disagg this runs on the prefill loop."""
        if not self.disagg:
            self._maybe_reset_arena()
            self._dispatch_snapshots()
        if self.members > 1:
            self._start_admissions_members()
            return
        while True:
            with self._cond:
                if not self._pending:
                    return
                idx = (0 if not self.qos or len(self._pending) <= 1
                       else self._policy.pick(self._pending, time.monotonic()))
                head = self._pending[idx]
                slot, lcp = self._pick_slot(head.prompt_ids)
                if slot is None:
                    self._maybe_flag_preemption_locked(head)
                    return
                if self.kv_pages and not self._paged_fits(slot, head):
                    # The head waits for pages (order kept): releases wake
                    # us; a lower-class row's claim is a page source too.
                    self._maybe_flag_preemption_locked(head)
                    return
                req = head
                del self._pending[idx]
                if self.qos:
                    self._policy.charge(req)
                if req.cancel.is_set():
                    self.n_cancelled += 1
                    req.out.put(("end", None))
                    continue
                reuse = self._reuse_len(lcp, len(req.prompt_ids))
            self._note_admitted(req)
            if self.staged:
                self._admit_staged(req, slot)
                continue
            # Only this thread claims rows: ``slot`` is still free.
            if not self._place_grammar(req):
                continue
            if self.kv_pages:
                reuse = self._paged_claim_or_fail(req, slot, reuse)
                if reuse is None:
                    continue
            restore = self._store_lookup(req.prompt_ids, reuse)
            if restore is not None:
                n_restore, payloads = restore
                with self._cond:
                    self._claim_chunked(req, slot, reuse, offset=n_restore)
                self._restore_into(req, slot, reuse, n_restore, payloads)
                continue
            if self._goes_chunked(req, reuse):
                with self._cond:
                    self._claim_chunked(req, slot, reuse)
                continue
            with self._cond:
                self._resident[slot] = []
            try:
                self._admit(req, slot)
            except Exception as e:
                # This request's own prefill failed: doom it alone; the slot
                # never activated, so its page claim unwinds.
                logger.exception("admission failed")
                with self._cond:
                    self._paged_release_row(slot)
                self.n_failures += 1
                req.out.put(("err", e))

    def _prompt_tokens(self, prompts: list[list[int]], bucket: int,
                       device=None) -> torch.Tensor:
        """Right-padded ``[len(prompts), bucket]`` tokens on the device (or
        ``device``; an empty prompt stands for an absent member)."""
        return host_to_device([p + [0] * (bucket - len(p)) for p in prompts], torch.long,
                              device or self.device)

    def _lengths_of(self, prompts: list[list[int]]) -> torch.Tensor:
        # An absent member's length is 1: it keeps the last-token gather valid.
        return host_to_device([max(1, len(p)) for p in prompts], torch.int32, self.device)

    def _admit(self, req: _Request, slot: int) -> None:
        """Single-shot admission: prefill the prompt into ``slot`` and sample
        its first token (one host read). An ensemble prefills the prompt
        through every weight set (rows ``e·S + slot``) and samples from the
        members' mean logits."""
        faults.fire("engine.admit")
        t0 = time.perf_counter()
        spec, n_ens = self.spec, self.ensemble
        bucket = prefill_bucket(len(req.prompt_ids), spec.max_seq)
        prompts = [req.prompt_ids] * n_ens
        tokens, lengths = self._prompt_tokens(prompts, bucket), self._lengths_of(prompts)
        if n_ens > 1:
            rows = [e * self.n_slots + slot for e in range(n_ens)]
            self._plan("prefill", prompts, bucket, None, rows)
            logits, _, _ = prefill(self.params, spec, tokens, lengths, self._ck, self._cv,
                                   rows=rows, mesh=self._rmesh)
            logits = logits.mean(0, keepdim=True)
        elif self.decode_pp > 1:
            self._plan("prefill", prompts, bucket, slot)
            logits, _, _ = staged_prefill(self.params, spec, tokens, lengths, self._ck,
                                          self._cv, slot, self._rmesh)
        else:
            self._plan("prefill", prompts, bucket, slot)
            logits, _, _ = prefill(self.params, spec, tokens, lengths, self._ck, self._cv,
                                   slot=slot, mesh=self._rmesh, sp_impl=self.sp_impl)
        self.n_admission_dispatches += 1
        (first,), (lp,) = self._start_rows([req], [slot], logits)
        t1 = time.perf_counter()
        # The admission blocks on its first token: dispatch to fetch is the
        # prefill's time.
        obs.PREFILL.observe(t1 - t0)
        self._observe_device_time("single_shot", t1 - t0)
        self.breaker.record_success()  # a half-open probe admitted cleanly
        if req.trace is not None:
            req.trace.add_span_abs("prefill", t0, t1, tokens=len(req.prompt_ids),
                                   bucket=bucket, slot=slot, reused=0, restored=0)
        with self._cond:
            self._resident[slot] = list(req.prompt_ids)
            if not self._emit(req, first, lp):
                self._slots[slot] = req

    def _start_rows(self, reqs: list[_Request], rows: list[int],
                    logits: torch.Tensor) -> tuple[list[int], list]:
        """Sample each admitted request's first token from its row of
        ``logits`` plus the row's logit bias (no penalty: nothing has been
        generated yet) and set its row's decode state, counts = one-hot of
        that token; one host read (it waits for the chunks in flight, which
        is why admissions clamp the ring to depth 1). Finish state: the
        admission already produced token 1, so the remaining budget is
        budget-1; a row is live unless that first token exhausted it or WAS
        the EOS. Returns the first tokens and, per request, its logprob
        record (None unless it asked for logprobs)."""
        dev, vocab = self.device, self.spec.vocab_size
        idx = (slice(rows[0], rows[0] + 1) if len(rows) == 1
               else host_to_device(rows, torch.long, dev))

        def col(values, dtype):
            return host_to_device(values, dtype, dev)

        for r, row in zip(reqs, rows):
            self._set_knobs(r, row)
            if not r.sampler.greedy:
                r.generator = torch.Generator(device=dev).manual_seed(r.seed)
                gumbel_noise(vocab, r.generator, out=self._noise[row])
                r.n_drawn = 1
        self._ntok[idx] = 1  # the next token is token 1
        self._temp[idx] = col([r.sampler.temperature for r in reqs], torch.float32)
        self._topp[idx] = col([r.sampler.top_p for r in reqs], torch.float32)
        self._topk[idx] = col([r.sampler.top_k for r in reqs], torch.int32)
        self._dfa[idx] = 0  # single-shot admissions are never constrained
        restrict = any(r.sampler.restricts and not r.sampler.greedy for r in reqs)
        adj = logits.float() + self._bias[idx]
        first = sample_token_rows(adj, self._temp[idx], self._topp[idx], self._topk[idx],
                                  self._noise[idx], restrict=restrict)
        self._counts[idx] = torch.zeros_like(self._counts[idx]).scatter_(1, first[:, None], 1)
        eos = col([r.eos_id if r.eos_id is not None else -1 for r in reqs], torch.int32)
        budget = col([r.budget for r in reqs], torch.int32)
        self._token[idx] = first
        self._lengths[idx] = col([len(r.prompt_ids) for r in reqs], torch.int32)
        self._live[idx] = (first != eos) & (budget > 1)
        self._budget[idx] = budget - 1
        self._eos[idx] = eos
        self.n_admissions += len(reqs)
        firsts = first.tolist()
        self._raise_if_rank_lost()
        lps: list = [None] * len(reqs)
        if any(r.want_lp >= 0 for r in reqs):
            s_lp, top_ix, top_lp = (t.tolist() for t in token_logprobs(adj, first))
            lps = [(s_lp[j], top_ix[j], top_lp[j]) if r.want_lp >= 0 else None
                   for j, r in enumerate(reqs)]
        return firsts, lps

    def _set_knobs(self, req: _Request, row: int) -> None:
        """Write ``req``'s penalties and logit bias into ``row`` (a bias row
        only when the request sets one: the others are zeroed on the
        device, with no host copy)."""
        self._pp[row] = req.pp
        self._fp[row] = req.fp
        if req.bias_row is None:
            self._bias[row].zero_()
        else:
            self._bias[row].copy_(self._staged(req.bias_row), non_blocking=True)

    def _step_admissions(self) -> None:
        """Advance every chunked admission by ONE segment — the interleaving
        unit: decode chunks for active rows run between any two segments.
        On a stacked engine, admissions sharing a (segment bucket, history
        bucket) pair coalesce into one stacked call, at most one admission
        per member in it. A staged admission whose prompt is all queued
        waits for its register in the handoff queue."""
        groups: dict[tuple[int, int], list[_Admission]] = {}
        for adm in list(self._admitting):
            if adm.dead or (self.disagg and adm.final_sent):
                continue  # under disagg the decode loop registers (or ends) it
            if adm.req.cancel.is_set():
                self.n_cancelled += 1
                adm.req.out.put(("end", None))
                self._release_admission(adm)
                continue
            if adm.final_sent:
                continue
            seg = min(self.prefill_chunk, len(adm.req.prompt_ids) - adm.offset)
            key = (prefill_bucket(seg, self.prefill_chunk),
                   prefill_bucket(adm.offset + seg, self.spec.max_seq))
            groups.setdefault(key, []).append(adm)
        for (bucket, history), adms in groups.items():
            while adms:
                batch: dict[int, _Admission] = {}
                rest: list[_Admission] = []
                for adm in adms:
                    m = adm.slot // self.n_slots
                    if m in batch:
                        rest.append(adm)
                    else:
                        batch[m] = adm
                adms = rest
                try:
                    self._run_segments(batch, bucket, history)
                except Exception as e:
                    # These admissions' segment failed: doom them alone;
                    # active decodes and other admissions continue.
                    logger.exception("prefill segment failed")
                    self._fail_admissions(list(batch.values()), e)

    def _run_segments(self, batch: dict[int, _Admission], bucket: int, history: int) -> None:
        """One segment call: batch row m is member m's admission on a stacked
        engine (absent members write nothing; a lone member runs through
        its own weight views), else the one admission, repeated into every
        weight set's row on an ensemble. Under zero-drain the segment writes
        the staging rows, on the staging stream, and the rows it completed
        are queued as pieces (``_stage_piece``); after the last segment the
        register is queued behind them."""
        faults.fire("engine.prefill_segment")
        chunk, s = self.prefill_chunk, self.n_slots
        params = self._prefill_params if self.disagg else self.params
        member = None
        if self.members > 1 and len(batch) > 1:
            per_row = [batch.get(m) for m in range(self.members)]
            rows = [a.slot if a is not None else None for a in per_row]
        elif self.members > 1:
            (member, adm), = batch.items()
            params, per_row, rows = member_params(params, member), [adm], [adm.slot]
        else:
            (adm,) = batch.values()
            per_row = [adm] * self.ensemble
            rows = [e * s + adm.slot for e in range(self.ensemble)]
        segs = [a.req.prompt_ids[a.offset:a.offset + chunk] if a is not None else []
                for a in per_row]
        cache = (self._sck, self._scv) if self.staged else (self._ck, self._cv)
        offsets = [a.offset if a is not None else 0 for a in per_row]
        n_valid = [len(seg) for seg in segs]
        t0 = time.perf_counter()
        mesh = self._prmesh if self.disagg else self._rmesh
        if self.disagg:
            self._pplan("segment", segs, bucket, offsets, rows, history, n_valid, member)
        elif self.staged and mesh is not None:
            # A zero-drain mesh: every rank stages on its staging stream,
            # over the staging groups, and slices this segment's pieces.
            mesh = mesh.stage
            cuts = [(row, adm.handed, min(adm.offset + chunk, len(adm.req.prompt_ids))
                     - adm.handed) for adm in batch.values() for row in self._piece_rows(adm)]
            self._plan("segment", segs, bucket, offsets, rows, history, n_valid, member, cuts)
        else:
            self._plan("segment", segs, bucket, offsets, rows, history, n_valid, member)
        with self._stage_scope():
            prefill_segment(params, self.spec,
                            self._prompt_tokens(segs, bucket, self.prefill_device), offsets,
                            *cache, rows=rows, history=history, n_valid=n_valid, mesh=mesh)
            for adm in batch.values():
                adm.offset = min(adm.offset + chunk, len(adm.req.prompt_ids))
                if self.staged:
                    self._stage_piece(adm)
        # Enqueue time on the card (the segment does not block): a lower
        # bound, labelled by its family all the same.
        self._observe_device_time("mseg" if self.members > 1 else "seg",
                                  time.perf_counter() - t0)
        FLIGHT.record("segment", engine=self._tag, loop=self._admit_loop, t=t0, bucket=bucket,
                      history=history, rids=[a.req.rid for a in batch.values()],
                      offsets=[a.offset for a in batch.values()])
        self.n_prefill_segments += 1
        for adm in batch.values():
            prompt = adm.req.prompt_ids
            if self.staged:
                if adm.offset >= len(prompt):
                    adm.final_sent = True
                    (self._outbox if self.disagg else self._handoffs).append(
                        ("final", adm, None, 0, None))
                continue
            with self._cond:
                self._resident[adm.slot] = prompt[:adm.offset]
            if adm.offset >= len(prompt):
                self._finish_admission(adm)

    def _finish_admission(self, adm: _Admission) -> None:
        """Register a fully prefilled row: token = the last prompt token at
        position len−1, the full budget, live while the budget is positive.
        Nothing is sampled (and no noise drawn) here: the next decode chunk
        recomputes the last position's logits and samples token 1."""
        req, i = adm.req, adm.slot
        prompt = req.prompt_ids
        t_reg = time.perf_counter()
        if not req.sampler.greedy:
            req.generator = torch.Generator(device=self.device).manual_seed(req.seed)
        # Scalar fills on the device: no host read, no stream sync.
        self._token[i] = prompt[-1]
        self._lengths[i] = len(prompt) - 1
        self._temp[i] = req.sampler.temperature
        self._topp[i] = req.sampler.top_p
        self._topk[i] = req.sampler.top_k
        self._live[i] = req.budget > 0
        self._budget[i] = req.budget
        self._eos[i] = req.eos_id if req.eos_id is not None else -1
        self._dfa[i] = req.g_start if req.grammar is not None else 0
        self._ntok[i] = 0
        self._set_knobs(req, i)
        self._counts[i].zero_()
        self.n_admissions += 1
        t1 = time.perf_counter()
        self._observe_device_time("register", t1 - t_reg)
        FLIGHT.record("register", rid=req.rid, engine=self._tag, loop="decode", slot=i,
                      tokens=len(prompt), reused=adm.offset0, restored=adm.restored)
        # From slot claim to cache-complete: the decode turns interleaved
        # between segments are the latency this admission saw.
        obs.PREFILL.observe(t1 - adm.t_start)
        if req.trace is not None:
            req.trace.add_span_abs("prefill", adm.t_start, t1, tokens=len(prompt), slot=i,
                                   chunked=True, reused=adm.offset0, restored=adm.restored)
        with self._cond:
            self._slots[i] = req
        self._release_admission(adm)
        self.breaker.record_success()

    def _release_admission(self, adm: _Admission) -> None:
        """Drop a finished, cancelled or failed admission (its staged pieces
        still queued are dropped with it)."""
        adm.dead = True
        with self._cond:
            if adm in self._admitting:
                self._admitting.remove(adm)
            self._claimed.discard(adm.slot)
            if self._slots[adm.slot] is not adm.req:
                # Cancelled or failed before the row went live.
                self._paged_release_row(adm.slot)
            if self.disagg:
                self._cond.notify_all()

    def _fail_admissions(self, adms: list[_Admission], exc: Exception) -> None:
        for adm in adms:
            with self._cond:
                self._resident[adm.slot] = []  # the row's content is unknown now
            self._release_admission(adm)
            self.n_failures += 1
            adm.req.out.put(("err", exc))

    # ---- zero-drain staging (zero_drain=1) ----------------------------------
    #
    # Streams on the card: segments (and a store restore into the staging
    # row) run on the engine's staging stream, which nothing else uses (on
    # the forward stream a segment would queue behind an embedding or
    # scoring forward for as long as it runs); each piece is sliced there
    # right after its segment and an event recorded behind it. The injection
    # writes the piece into the decode row on the ring's stream after
    # waiting on that event, and only at a turn where the event has already
    # passed while the ring has work (so the ring never waits for a
    # segment). The hazards this rules out:
    #
    # - an injection reading a staging row before its segment ran: it
    #   reads the piece, sliced after the segment on the same stream, and
    #   waits on the event behind the slice;
    # - a segment overwriting a staging row an injection has not read: the
    #   injection never reads the staging row, only the piece (a copy);
    #   the piece's memory is marked as used by the ring's stream
    #   (``record_stream``), so it is not reused before the write ran;
    # - a decode replay in flight writing the claimed row after the
    #   injection: the injection is enqueued on the ring's stream behind
    #   every dispatch issued before it, and a claimed row is not in the
    #   mask of any dispatch issued before its register, so no replay
    #   writes it (decode writes are gated by mask & live);
    # - a first capture beside a running segment: the capture and the
    #   segment's launches are issued by this one thread, one after the
    #   other, and a capture in thread-local mode ignores work already
    #   queued on another stream.
    #
    # Failures: a staged admission whose restore, segment, injection or
    # register fails is doomed alone (``_fail_admissions``: released and
    # marked dead, its queued pieces dropped, a paged claim unwound);
    # active rows, other admissions and the queue go on, and nothing is
    # rebuilt. The staging cache is never rebuilt: torch donates no
    # buffers, so a failed call cannot consume it, and a failure leaves
    # garbage only in the failed admission's own staging row, at positions
    # the row's next admission writes (from 0, or from its restore) before
    # any segment attends over them. A failure that breaks the device
    # context takes the whole engine, which no rebuild would help.

    def _stage_scope(self):
        """Where segments run: a zero-drain engine's on the card on its
        staging stream, every other on the current stream (the ring's)."""
        if self._stage_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stage_stream)

    def _admit_staged(self, req: _Request, slot: int, claimed: bool = False) -> None:
        """Claim decode row ``slot`` for ``req`` and start its staged
        admission: every segment prefills into the staging row, from the
        host prefix store's match when there is one (restored into the
        staging row first). A paged row's pages are reserved here unless
        the caller ``claimed`` them; the table is uploaded before the first
        injection. Grammar placement waits for the register."""
        try:
            faults.fire("engine.admit")
            restore = self._store_lookup(req.prompt_ids, 0)
            if self.kv_pages and not claimed:
                with self._cond:
                    claim = self._paged_claim(slot, req, 0)
                if claim is None:
                    raise RuntimeError("kv page claim failed after passing the fits check")
        except Exception as e:
            # Nothing was claimed yet: the request fails alone.
            logger.exception("staged admission failed")
            self.n_failures += 1
            req.out.put(("err", e))
            return
        offset = restore[0] if restore is not None else 0
        adm = _Admission(req, slot, offset=offset, restored=offset)
        FLIGHT.record("stage-admit", rid=req.rid, engine=self._tag, loop=self._admit_loop,
                      slot=slot,
                      restored=offset)
        with self._cond:
            self._claimed.add(slot)
            self._resident[slot] = []
            self._admitting.append(adm)
        if restore is not None:
            try:
                with self._stage_scope():
                    self._restore_into(req, slot, 0, offset, restore[1], stage=True)
            except Exception as e:
                logger.exception("staging restore failed")
                self._fail_admissions([adm], e)

    def _stage_piece(self, adm: _Admission) -> None:
        """Queue staging positions ``[handed, offset)`` of ``adm``'s rows
        (its flat row; on an ensemble the slot's row of every weight set)
        as one piece: slices (copies) on the current stream, then an event
        behind them (None on the CPU)."""
        lo, hi = adm.handed, adm.offset
        if hi <= lo:
            return
        pieces = [(row, self._staged_rows(row, lo, hi - lo)) for row in self._piece_rows(adm)]
        event = None
        if self._stage_stream is not None:
            event = torch.cuda.Event()
            event.record()
        adm.handed = hi
        (self._outbox if self.disagg else self._handoffs).append(("kv", adm, pieces, lo, event))

    def _piece_rows(self, adm: _Admission) -> list[int]:
        """The flat rows a piece of ``adm`` covers: its row; on an ensemble
        the slot's row of every weight set."""
        if self.members > 1:
            return [adm.slot]
        return [e * self.n_slots + adm.slot for e in range(self.ensemble)]

    def _staged_rows(self, row: int, lo: int, n: int):
        """Staging positions ``[lo, lo+n)`` of ``row`` as a wire chunk of
        every kv head: on a prefill group of several ranks each rank's
        entries gathered over its tp (``kv_transfer.gather_heads``; the
        workers take part through a ``handoff`` plan). On a zero-drain mesh
        rank 0's own entries, where its dp group holds the row (None
        elsewhere): every rank injects its own."""
        if not self.disagg and self._rmesh is not None:
            local = kv_transfer.local_row(self._rmesh, row)
            return (None if local is None else
                    kv_transfer.slice_rows((self._sck, self._scv), local, lo, n))
        chunk = kv_transfer.slice_rows((self._sck, self._scv), row, lo, n)
        if self._prmesh is None:
            return chunk
        self._pplan("handoff", row, lo, n)
        return kv_transfer.gather_heads(chunk, self._prmesh, self.spec)

    def _drain_handoffs(self) -> None:
        """Inject queued pieces into their claimed decode rows and register
        the admissions whose prompt is all injected, in queue order. A
        piece whose segment is still running stays queued while the ring
        has work (a later turn takes it); with nothing to decode the host
        waits for it. A dead admission's entries are dropped: its row may
        already hold another request. Scheduler thread only."""
        while self._handoffs:
            kind, adm, pieces, start, event = self._handoffs[0]
            if not adm.dead and event is not None and not event.query():
                with self._cond:
                    busy = any(r is not None for r in self._slots)
                if busy or self._inflight:
                    return
                event.synchronize()
            self._handoffs.popleft()
            if adm.dead:
                if kind == "kv" and self._zero_drain_mesh:
                    self._plan("drop_pieces", [(row, start) for row, _ in pieces])
                continue
            if kind == "kv":
                self._inject(adm, pieces, start, event)
            else:
                self._register_staged(adm)

    @property
    def _zero_drain_mesh(self) -> bool:
        """A colocated zero-drain engine of several ranks: each rank stages
        its own entries and injects them itself."""
        return self.zero_drain and self._ranks is not None

    def _inject(self, adm: _Admission, pieces, start: int, event) -> None:
        """Write one piece into the decode cache on the ring's stream, after
        the table upload (paged) and the piece's event. On a zero-drain
        mesh every rank holding the row writes its own entries of it, a
        local copy (``stage_inject``); a disaggregated decode group of
        several ranks gets the whole piece broadcast from rank 0, each rank
        writing its entries."""
        try:
            self._paged_sync_table()
            if event is not None:
                self._stream.wait_event(event)
            for row, chunk in pieces:
                if self._zero_drain_mesh:
                    self._plan("stage_inject", row, start)
                    if chunk is None:
                        continue
                    kv_transfer.write_rows((self._ck, self._cv), chunk,
                                           kv_transfer.local_row(self._rmesh, row), start)
                else:
                    n = kv_transfer.chunk_leaves(chunk)[0].shape[2]
                    self._plan("inject", row, start, n)
                    kv_transfer.restore_rows((self._ck, self._cv), chunk, row, start, n,
                                             self._rmesh, self.spec)
                if self._stream is not None:
                    for leaf in kv_transfer.chunk_leaves(chunk):
                        leaf.record_stream(self._stream)
            FLIGHT.record("inject", rid=adm.req.rid, engine=self._tag, loop="decode",
                          slot=adm.slot, tokens=adm.handed - start)
        except Exception as e:
            logger.exception("staged injection failed")
            self._fail_admissions([adm], e)

    def _register_staged(self, adm: _Admission) -> None:
        """Register a fully injected admission (grammar placed now: the
        arena is decode-side state); a registration onto a live ring counts
        in ``admission_overlap_total``."""
        req = adm.req
        if req.cancel.is_set():
            self.n_cancelled += 1
            req.out.put(("end", None))
            self._release_admission(adm)
            return
        if not self._place_grammar(req):
            self._release_admission(adm)
            return
        try:
            with self._cond:
                self._resident[adm.slot] = list(req.prompt_ids)
                live = any(r is not None for r in self._slots)
            if live or self._inflight:
                self.n_admission_overlap += 1
                obs.ADMISSION_OVERLAP.inc()
            self._finish_admission(adm)
        except Exception as e:
            logger.exception("staged register failed")
            self._fail_admissions([adm], e)

    # ---- disaggregated prefill/decode (prefill_mesh=, disagg=P+D) ----------
    #
    # Two loops share the engine's state under ``_cond``. The prefill loop
    # (:meth:`_prefill_scheduler`, on the prefill group's device) takes the
    # queue: it admits into the staging cache there, runs every segment and
    # slices each segment's rows into pieces, exactly as a zero-drain
    # admission does, but queues them in its ``_outbox``; each piece's
    # handoff (:meth:`_commit_handoffs`: ``kv_transfer.transfer``, a copy
    # onto the decode group's device on the handoff stream, after the
    # segment's event) is made at the next turn, once the next segments
    # are queued, so the copy of chunk i overlaps the prefill of chunk
    # i+1; the moved pieces and the register go into ``_handoffs``. The
    # decode loop (:meth:`_scheduler`) keeps the ring, the decode-side
    # state (grammar arena, prefix snapshots) and ``_drain_handoffs``:
    # every write into the decode cache and every register stays on one
    # thread. An admission is the prefill loop's until its register is
    # queued, then the decode loop's. A failed handoff (the
    # ``engine.kv_handoff`` fault site, or a copy that raises) dooms only its
    # own admission: no retry, no other route (the route is the layout's).

    @property
    def _admit_loop(self) -> str:
        """The flight recorder's ``loop`` of admission events."""
        return "prefill" if self.disagg else "decode"

    def _prefill_work(self) -> bool:
        """Whether the prefill loop has work now: pieces to hand off, an
        admission with segments to run (or cancelled before its register
        was queued), or a pending request that could claim a row. Caller
        holds ``_cond``."""
        if self._outbox:
            return True
        for a in self._admitting:
            if not a.final_sent and not a.dead:
                return True
        if not self._pending:
            return False
        s = self.n_slots
        for m in {r.member for r in self._pending}:
            for i in range(m * s, (m + 1) * s):
                if self._slots[i] is None and i not in self._claimed:
                    return True
        return False

    def _prefill_scheduler(self) -> None:
        """The prefill group's loop (disagg only): admit, one segment per
        admission, hand off the pieces of earlier turns (all of them when
        no segment is left to overlap), until stopped and idle."""
        if self.prefill_device.type == "cuda":
            torch.cuda.set_device(self.prefill_device)
        while True:
            with self._cond:
                while not (self._stop or self._prefill_work()):
                    obs.PREFILL_GROUP_ACTIVE.set(len(self._admitting))
                    self._cond.wait()
                if self._stop and not self._prefill_work():
                    return
            obs.PREFILL_GROUP_ACTIVE.set(len(self._admitting))
            try:
                with torch.no_grad():
                    self._start_admissions()
                    older = len(self._outbox)
                    self._step_admissions()
                    more = any(not a.final_sent and not a.dead for a in list(self._admitting))
                    self._commit_handoffs(older if more else len(self._outbox))
            except Exception as e:  # the prefill group's blast radius only
                logger.exception("prefill loop turn failed")
                with self._cond:
                    adms = [a for a in self._admitting if not a.final_sent]
                self._record_breaker_failure()
                self._fail_admissions(adms, e)

    def _commit_handoffs(self, n: int) -> None:
        """Hand off the first ``n`` outbox entries, in order: each piece
        moves onto the decode group's device (``kv_transfer.transfer``,
        which blocks this loop until it lands) and joins ``_handoffs`` with
        the register markers behind it. The ``engine.kv_handoff`` fault
        site fires before each move; a failure dooms that admission."""
        for _ in range(n):
            kind, adm, pieces, start, event = self._outbox.popleft()
            if adm.dead:
                continue
            if kind == "kv":
                try:
                    faults.fire("engine.kv_handoff")
                    t0 = time.perf_counter()
                    moved, n_bytes, secs = [], 0, 0.0
                    for row, chunk in pieces:
                        out, b, dt, route = kv_transfer.transfer(
                            chunk, self.device, route=self.handoff_route,
                            stream=self._handoff_stream, after=event)
                        moved.append((row, out))
                        n_bytes, secs = n_bytes + b, secs + dt
                    self.n_kv_handoffs += 1
                    self.kv_handoff_bytes += n_bytes
                    self.kv_handoff_s += secs
                    if adm.req.trace is not None:
                        adm.req.trace.add_span_abs("kv-handoff", t0, time.perf_counter(),
                                                   slot=adm.slot, bytes=n_bytes, route=route)
                    FLIGHT.record("handoff", rid=adm.req.rid, engine=self._tag, loop="prefill",
                                  slot=adm.slot, bytes=n_bytes, route=route)
                except Exception as e:
                    logger.exception("kv handoff failed")
                    self._fail_admissions([adm], e)
                    continue
                entry = ("kv", adm, moved, start, None)
            else:
                entry = ("final", adm, None, 0, None)
            with self._cond:
                self._handoffs.append(entry)
                self._cond.notify_all()

    # ---- stacked members: the JAX engine's ``_start_admissions_members`` ----

    def _common_free_row(self, members) -> int | None:
        """The slot index free (and unclaimed) for EVERY given member, the
        one with the least resident content across them winning — a fresh
        admission should not evict a reusable prefix. Caller holds
        ``_cond``."""
        best, best_load = None, None
        s = self.n_slots
        for row in range(s):
            if not all(self._slots[m * s + row] is None and m * s + row not in self._claimed
                       for m in members):
                continue
            load = sum(len(self._resident[m * s + row]) for m in members)
            if best_load is None or load < best_load:
                best, best_load = row, load
        return best

    def _start_admissions_members(self) -> None:
        """Candidates are the FIFO head of each member's queue. Until every
        member has a head, they wait up to ``MEMBER_GROUP_WAIT_S`` after the
        oldest head's submit (decode turns run meanwhile), so a group whose
        submits the scheduler thread interleaves still coalesces. A head that
        has a resident prefix on one of its member's free rows, is longer
        than ``prefill_chunk`` or carries a grammar becomes a chunked
        admission on that row.
        Otherwise, anchored on each head in FIFO order, the heads sharing
        the anchor's prompt bucket form a single-shot group admitted in one
        dispatch into a common free slot index; when the group has none,
        the anchor alone (so one busy member's full slots never starve idle
        members). With ``qos`` the heads come in the policy's order and
        every popped request is charged; when no head has a row, each may
        flag a lower-class victim among its own member's rows. Under
        zero-drain every head is staged on its member's best row."""
        max_seq = self.spec.max_seq
        routed = False  # a head was routed this turn: the rest go now too
        while True:
            with self._cond:
                if not self._pending:
                    return
                heads: list[_Request] = []
                seen: set[int] = set()
                src = (self._policy.order(self._pending, time.monotonic()) if self.qos
                       else self._pending)
                for r in src:
                    if r.member not in seen:
                        seen.add(r.member)
                        heads.append(r)
                wait = (0.0 if routed or len(heads) == self.members else
                        heads[0].t_submit + MEMBER_GROUP_WAIT_S - time.perf_counter())
                if wait > 0:
                    # The group's other members may be on their way.
                    if any(self._slots) or self._admitting or self._inflight:
                        return  # decode runs meanwhile; a later turn routes it
                    self._cond.wait(wait)  # a member's submit wakes us
                    continue
                chunked = None
                for r in heads:
                    slot, lcp = self._pick_slot(r.prompt_ids, r.member)
                    if slot is None:
                        continue
                    reuse = self._reuse_len(lcp, len(r.prompt_ids))
                    if self._goes_chunked(r, reuse):
                        if self.kv_pages:
                            claim = self._paged_claim(slot, r, reuse)
                            if claim is None:
                                continue  # this member waits for pages
                            reuse = claim[0]  # 0 on stacked engines: no copy
                        self._pending.remove(r)
                        if self.qos:
                            self._policy.charge(r)
                        chunked = (r, slot, reuse)
                        break
                if chunked is None:
                    row = None
                    for anchor in heads:
                        bucket = prefill_bucket(len(anchor.prompt_ids), max_seq)
                        group = {h.member: h for h in heads
                                 if prefill_bucket(len(h.prompt_ids), max_seq) == bucket}
                        row = self._common_free_row(group)
                        if row is None and len(group) > 1:
                            group = {anchor.member: anchor}
                            row = self._common_free_row(group)
                        if row is not None:
                            break
                    if row is None:
                        # No head has a usable row this turn: each may park a
                        # lower-class row of its own member (member-local).
                        for h in heads:
                            self._maybe_flag_preemption_locked(h)
                        return
                    if self.kv_pages:
                        # One claim per group member on the slot group's
                        # shared chain, sized by the largest need.
                        n_claimed = 0
                        for r in group.values():
                            if self._paged_claim(row, r, 0) is None:
                                break
                            n_claimed += 1
                        if n_claimed < len(group):
                            for _ in range(n_claimed):
                                self._paged_release_row(row)
                            return  # the group waits for pages
                    for r in group.values():
                        self._pending.remove(r)
                        if self.qos:
                            self._policy.charge(r)
                routed = True
            self._paged_sync_table()
            if chunked is not None:
                # Only this thread claims rows: ``slot`` is still free.
                r, slot, reuse = chunked
                self._note_admitted(r)
                if self.staged:
                    self._admit_staged(r, slot, claimed=True)
                elif self._place_grammar(r):
                    with self._cond:
                        self._claim_chunked(r, slot, reuse)
                else:
                    with self._cond:
                        self._paged_release_row(slot)
                continue  # route the remaining heads
            self._admit_members(group, row, bucket)

    def _admit_members(self, group: dict[int, _Request], row: int, bucket: int) -> None:
        """One coalesced admission of ``group`` (member → request) into slot
        index ``row``: one prefill dispatch, then per-member sampling."""
        n_mem, s = self.members, self.n_slots
        live: dict[int, _Request] = {}
        for m in sorted(group):
            req = group[m]
            if req.cancel.is_set():
                self.n_cancelled += 1
                req.out.put(("end", None))
                with self._cond:
                    self._paged_release_row(m * s + row)  # its claim on the group
            else:
                live[m] = req
        if not live:
            return
        spec, members = self.spec, list(live)
        rows = [m * s + row for m in members]
        with self._cond:
            for flat in rows:
                self._resident[flat] = []
        prompt = live[members[0]].prompt_ids
        # Dedup: a FULL group carrying one prompt on shared weights has one
        # K/V for every member; partial groups and per-member prompts take
        # the M-row prefill (the tokens are the same either way).
        use_dedup = (self.quorum_dedup and len(live) == n_mem
                     and all(r.prompt_ids == prompt for r in live.values()))
        for req in live.values():
            self._note_admitted(req)
        try:
            faults.fire("engine.admit")
            t0 = time.perf_counter()
            if use_dedup or len(live) == 1:
                # One prompt through one member's weight views (member 0's
                # under dedup): 1/M of the stacked prefill's work.
                dedup = use_dedup
                if use_dedup and self.kv_pages:
                    # Member 0's pages into every member's pool copy.
                    with self._cond:
                        chain = list(self._page_alloc.chain(row) or [])
                    dedup = chain[:self._page_alloc.pages_for(len(prompt))]
                self._plan("prefill", [prompt], bucket, rows[0], None, members[0], dedup)
                logits, _, _ = prefill(member_params(self.params, members[0]), spec,
                                       self._prompt_tokens([prompt], bucket),
                                       self._lengths_of([prompt]), self._ck, self._cv,
                                       slot=rows[0], mesh=self._rmesh)
                if use_dedup and self.kv_pages:
                    copy_member_pages((self._ck, self._cv), dedup, n_mem)
                elif use_dedup:
                    broadcast_member_rows(self._ck, self._cv, n_mem, row, len(prompt),
                                          self._rmesh)
                if use_dedup:
                    logits = logits.expand(n_mem, -1)
            else:
                prompts = [live[m].prompt_ids if m in live else [] for m in range(n_mem)]
                flat = [m * s + row if m in live else None for m in range(n_mem)]
                self._plan("prefill", prompts, bucket, None, flat)
                logits, _, _ = prefill(self.params, spec, self._prompt_tokens(prompts, bucket),
                                       self._lengths_of(prompts), self._ck, self._cv,
                                       rows=flat, mesh=self._rmesh)
                if len(live) < n_mem:
                    logits = logits[host_to_device(members, torch.long, self.device)]
            self.n_admission_dispatches += 1
            firsts, lps = self._start_rows(list(live.values()), rows, logits)
            t1 = time.perf_counter()
        except Exception as e:
            # The group's own prefill failed: doom its members alone; no
            # row went live, so their page claims unwind.
            logger.exception("admission failed")
            with self._cond:
                for flat in rows:
                    self._paged_release_row(flat)
            for req in live.values():
                self.n_failures += 1
                req.out.put(("err", e))
            return
        obs.PREFILL.observe(t1 - t0)
        self._observe_device_time("dedup" if use_dedup else "single_shot", t1 - t0)
        if use_dedup:
            self.quorum_dedup_tokens += (n_mem - 1) * len(prompt)
            self.quorum_dedup_prefills += 1
            obs.QUORUM_DEDUP_TOKENS.inc((n_mem - 1) * len(prompt))
        self.breaker.record_success()
        for req in live.values():
            if req.trace is not None:
                req.trace.add_span_abs("prefill", t0, t1, tokens=len(req.prompt_ids),
                                       bucket=bucket, slot=row, coalesced=len(live), reused=0,
                                       restored=0, dedup=int(use_dedup))
        with self._cond:
            for flat, req, first, lp in zip(rows, live.values(), firsts, lps):
                self._resident[flat] = list(req.prompt_ids)
                if not self._emit(req, first, lp):
                    self._slots[flat] = req

    # ---- the decode ring --------------------------------------------------

    def _active_rows(self) -> list[tuple[int, _Request]]:
        with self._cond:
            return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def _release_slot(self, i: int, req: _Request) -> None:
        """Free a finished, cancelled or parked row. Its cache holds K/V
        for everything but the last delivered token (never fed back): that
        prefix stays reusable. The row's occupancy feeds the cost model's
        service EWMA. Caller holds ``_cond``."""
        self._slots[i] = None
        self._resident[i] = req.hist[:-1]
        self._paged_release_row(i)
        if req.t_admit is not None:
            self.cost_model.observe_service(time.perf_counter() - req.t_admit)
        self._queue_snapshot(i)
        if self.disagg:
            self._cond.notify_all()  # the prefill loop may admit into the row

    def _sweep_cancelled(self) -> None:
        """Release rows whose consumer went away (or hit a stop string): they
        leave every chunk not yet dispatched."""
        for i, r in self._active_rows():
            if r.cancel.is_set():
                self.n_cancelled += 1
                r.out.put(("end", None))
                with self._cond:
                    self._release_slot(i, r)

    def _sweep_drain_parks(self) -> None:
        """Drain with park: retire every active row at this turn's start,
        through the cancel sweep's release — the row leaves every chunk not
        yet dispatched, tokens of chunks in flight for it count as overrun,
        a later admission's writes land behind those chunks in stream
        order, and a paged row's pages go back to the pool. Its prefix stays
        resident for reuse, as a finished stream's would. The consumer sees
        ``parked`` then a clean end, never an error."""
        if not self._draining_park:
            return
        for i, req in self._active_rows():
            with self._cond:
                if self._slots[i] is not req or req.cancel.is_set():
                    continue  # finished or cancelled since: the cancel sweep's
                self._release_slot(i, req)
                self.n_drain_parked += 1
            req.parked = True  # before the end frame: read when the stream ends
            req.out.put(("end", None))
            FLIGHT.record("drain-park", rid=req.rid, engine=self._tag, loop="decode", row=i,
                          emitted=req.emitted)

    # ---- QoS preemption (qos=1) ---------------------------------------------

    def _maybe_flag_preemption_locked(self, head: _Request) -> None:
        """The picked admission found no usable row (or no pages): with
        ``qos``, flag ONE strictly lower-class resident row of the head's
        member for parking at the next turn (:meth:`_sweep_preemptions`).
        Caller holds ``_cond``. Ensemble engines never preempt (a row is
        one request across every weight set); one park order is
        outstanding per beneficiary."""
        if not self.qos or head.cancel.is_set() or head.preempt_flag:
            return
        if self.ensemble != 1:
            return
        if any(b is head for _, _, b in self._preempt_pending):
            return
        lo = head.member * self.n_slots
        picked = self._preempt.pick_victim(head, self._slots, lo, lo + self.n_slots)
        if picked is None:
            return
        row, victim = picked
        victim.preempt_flag = True
        self._preempt_pending.append((row, victim, head))
        self._cond.notify_all()

    def _sweep_preemptions(self) -> None:
        """Execute the park orders at this turn's start. Parking is the
        ordinary release (``_release_slot``): the victim's K/V stays
        resident (a paged row's pages stay retained as a reuse donor, a
        host prefix store snapshots it), dispatches in flight that carry it
        no longer deliver to it (its epoch moved), and later dispatches
        leave the row out. The victim then rewinds (``begin_replay``) and
        re-enters the queue at the head; its resume regenerates the
        delivered tokens behind the replay guard. An ``engine.preempt``
        fault mid-park dooms the victim alone."""
        if not self.qos:
            return
        with self._cond:
            if not self._preempt_pending:
                return
            work = list(self._preempt_pending)
            self._preempt_pending.clear()
        for row, victim, ben in work:
            try:
                faults.fire("engine.preempt")
                with self._cond:
                    if self._slots[row] is not victim or victim.cancel.is_set():
                        victim.preempt_flag = False  # finished or cancelled since
                        continue
                    self._release_slot(row, victim)
                    parked = victim.begin_replay()
                    victim.preempt_flag = False
                    self._pending.appendleft(victim)
                    self.n_preemptions += 1
                    self.n_preempted_tokens += parked
                    self._cond.notify_all()
                if self._draft_rt is not None:
                    self._draft_rt.reqs[row] = None  # resync the draft row on re-admission
                obs.PREEMPTIONS.inc(**{"class": victim.sched_class})
                obs.PREEMPTED_TOKENS.inc(parked)
                FLIGHT.record("preempt", rid=victim.rid, engine=self._tag, loop="decode",
                              row=row, victim_class=victim.sched_class, beneficiary=ben.rid,
                              parked_tokens=parked)
            except Exception as e:
                with self._cond:
                    victim.preempt_flag = False
                    if self._slots[row] is victim:
                        self._release_slot(row, victim)
                    if victim in self._pending:
                        self._pending.remove(victim)
                    self.n_failures += 1
                victim.out.put(("err", e))
                victim.cancel.set()
                FLIGHT.record("preempt-fault", rid=victim.rid, engine=self._tag,
                              loop="decode", row=row, error=f"{type(e).__name__}: {e}"[:200])

    def _expire(self, req: _Request, stage: str) -> None:
        """Retire one request past its deadline: the error frame first (the
        consumer must see DeadlineExceeded, not a clean end), then cancel,
        so work in flight masks the row out at the next boundary."""
        self._answer_deadline(req, stage)
        req.cancel.set()

    def _answer_deadline(self, req: _Request, stage: str) -> None:
        """Count ``req``'s deadline and send its error frame, once (the
        watcher may have answered it during a capture)."""
        with self._cond:  # submit's shed and the watcher count from other threads
            if req.deadline_answered:
                return
            req.deadline_answered = True
            self.n_deadline_exceeded += 1
        obs.DEADLINE_EXCEEDED.inc(stage=stage)
        if req.trace is not None:
            now = time.perf_counter()
            req.trace.add_span_abs("deadline-exceeded", now, now, stage=stage)
        FLIGHT.record("deadline", rid=req.rid, engine=self._tag, loop="decode", stage=stage)
        req.out.put(("err", DeadlineExceeded(stage)))

    @contextlib.contextmanager
    def _deadline_watch(self) -> Iterator[None]:
        """Held around a graph capture (``DecodeGraphs(hold=)``), which keeps
        the scheduler thread for seconds at full depth: a watcher thread
        answers the deadlines that pass meanwhile, so each client gets its
        DeadlineExceeded on time. Queued requests are shed outright; an
        admitting or active row only gets its frame (it rides the dispatch
        under capture, and the reap skips its tokens) and the next turn's
        sweep releases it."""
        done = threading.Event()

        def watch() -> None:
            while not done.wait(DEADLINE_WATCH_S):
                now = time.monotonic()
                with self._cond:
                    shed = [r for r in self._pending if self.cost_model.expired(r, now)]
                    for r in shed:
                        self._pending.remove(r)
                    held = ([(a.req, "prefill") for a in self._admitting]
                            + [(r, "decode") for r in self._slots if r is not None])
                for r in shed:
                    self._expire(r, "queue")
                for r, stage in held:
                    if self.cost_model.expired(r, now):
                        self._answer_deadline(r, stage)

        th = threading.Thread(target=watch, daemon=True, name="quorum-torch-deadline-watch")
        th.start()
        try:
            yield
        finally:
            done.set()
            th.join()

    def _sweep_deadlines(self) -> None:
        """Once per scheduler turn: shed pending requests past their deadline
        (stage ``queue``: never served, a 503 the client can retry
        elsewhere) and cancel admitted ones (``prefill`` while chunked
        admission runs, ``decode`` once active: a 504, the work is lost).
        Runs on the scheduler thread, so it cannot race the cancel sweep.
        Rows the deadline watch answered during a capture are released here
        too (their consumer may have cancelled since: still a deadline).
        The expiry predicate is the cost model's; with ``qos`` the sweep
        also sets the per-class queue-depth gauge. A staged admission's
        release marks it dead, so its queued pieces are dropped."""
        now = time.monotonic()
        expired = self.cost_model.expired
        with self._cond:
            shed = [r for r in self._pending if expired(r, now)]
            for r in shed:
                self._pending.remove(r)
            late_adm = [a for a in self._admitting
                        if expired(a.req, now) or a.req.deadline_answered]
            late_active = [(i, r) for i, r in enumerate(self._slots)
                           if r is not None and (expired(r, now) or r.deadline_answered)]
            depths = self._policy.queue_depths(self._pending) if self.qos else {}
        for cls, n in depths.items():
            obs.SCHED_QUEUE_DEPTH.set(n, **{"class": cls})
        for r in shed:
            self._expire(r, "queue")
        for a in late_adm:
            self._expire(a.req, "prefill")
            self._release_admission(a)
        for i, r in late_active:
            self._expire(r, "decode")
            with self._cond:
                if self._slots[i] is r:
                    self._release_slot(i, r)

    def _run_chunk_steps(self) -> None:
        self._sweep_cancelled()
        if not self._active_rows():
            self._note_admission_clamp(False)
            self._note_stage_occupancy([])  # drained stages read 0
            self._drain_inflight()
            return
        self._fill_inflight()
        if self._inflight:
            self._reap_oldest()
            # Chunks behind the oldest whose tokens already landed are
            # delivered now, not a turn later.
            while self._inflight and self._inflight[0].ready():
                self._reap_oldest()

    def _admission_pressure(self) -> bool:
        """A chunked admission is mid-prefill, or a pending request could
        claim a row right now (pending requests with no free row are not
        pressure: a deeper ring finishes rows sooner). Never under
        zero-drain staging: that is the knob's contract — the segments run
        on another stream into the staging cache, and the injection and
        register are small writes at a turn's boundary. Caller holds
        ``_cond``."""
        if self.staged:
            return False
        if self._admitting:
            return True
        s = self.n_slots
        for m in {r.member for r in self._pending}:
            for i in range(m * s, (m + 1) * s):
                if self._slots[i] is None and i not in self._claimed:
                    return True
        return False

    def _target_depth(self) -> int:
        """Ring depth right now: 1 under admission pressure (every chunk
        ahead would delay the admission by a chunk of device time) or
        shutdown, else ``decode_pipeline``."""
        with self._cond:
            clamped = not self._stop and self._admission_pressure()
            stop = self._stop
        self._note_admission_clamp(clamped)
        return 1 if clamped or stop else self.decode_pipeline

    def _note_admission_clamp(self, clamped: bool) -> None:
        """Accumulate the wall time the ring spends clamped to depth 1 for an
        admission (``admission_stall_seconds_total``): only the span between
        consecutive clamped observations counts, so an idle gap never reads
        as stall. An engine whose ring cannot clamp (depth 1 and
        ``decode_loop=1``) records nothing."""
        if self.decode_pipeline <= 1 and self.decode_loop <= 1:
            return
        now = time.monotonic()
        # Clamp transitions ride the flight recorder (changes only).
        if clamped and self._clamp_t0 is None:
            FLIGHT.record("clamp", engine=self._tag, loop="decode", state="on")
        elif not clamped and self._clamp_t0 is not None:
            FLIGHT.record("clamp", engine=self._tag, loop="decode", state="off",
                          stalled_s=round(self.admission_stall_s, 6))
        if clamped and self._clamp_t0 is not None:
            self.admission_stall_s += now - self._clamp_t0
            obs.ADMISSION_STALL_SECONDS.inc(now - self._clamp_t0)
        self._clamp_t0 = now if clamped else None

    def _fill_inflight(self) -> None:
        target = self._target_depth()
        while len(self._inflight) < target:
            active = [(i, r) for i, r in self._active_rows()
                      if not (r.cancel.is_set() or r.deadline_answered)]
            if not active:
                return
            depth = len(self._inflight)
            # Steps already in flight: an upper bound on how far rows get
            # before this dispatch runs (rows that finish on device stop short).
            ahead = sum(c.tokens_ahead for c in self._inflight)
            if depth > 0 and not any(r.budget - r.emitted > ahead for _, r in active):
                return  # no row could still be decoding in a dispatch issued now
            g = self.spec_decode
            if g > 0 and any(r.spec_draft_ok for _, r in active):
                disp = self._try_spec_dispatch(active, g, ahead, depth)
                if disp == "dispatched":
                    continue
                if disp == "stop":
                    return
                # "chunk": no draft anywhere, none in flight — a plain chunk.
            if (depth > 0 and self._graphs is not None
                    and self._dispatch_key(active) not in self._graphs):
                # Only dispatch ahead onto a captured graph: a capture would
                # hold back the delivery of the chunks already computed.
                return
            self._inflight.append(self._dispatch_chunk(active))
            for _, r in active:
                r.n_inflight += 1
            if depth > 0:
                self.n_overlapped += 1
            self._note_stage_occupancy(active)

    def _note_stage_occupancy(self, active) -> None:
        """Per-stage decode occupancy for pipeline-staged engines
        (``quorum_tpu_decode_stage_occupancy{stage=}``): stage g's rows are
        the contiguous row group [g·S/pp, (g+1)·S/pp), its microbatch slot
        in the staged ring. Refreshed on every dispatch and on the idle
        transition; a no-op at pp == 1 (the family keeps its bare 0
        sample). The JAX engine's, word for word."""
        if self.decode_pp <= 1:
            return
        sg = self._rows // self.decode_pp
        for g in range(self.decode_pp):
            n = sum(1 for i, _ in active if g * sg <= i < (g + 1) * sg)
            obs.DECODE_STAGE_OCCUPANCY.set(n, stage=str(g))

    def _dispatch_key(self, active) -> tuple:
        """(steps per chunk, chunks, top-k/top-p sort, logprobs) of the
        dispatch ``active`` would get now: the graph key. Penalties and the
        bias are in every program, so they add no key. A dispatch with a
        grammar row runs the constrained variant, keyed
        ``("dfa", steps, chunks, sort, logprobs, arena bucket)``; one with
        none keeps the plain 4-tuple and the plain program. A paged engine's
        key is ``("paged", *that key, history)``: its program gathers a
        window of ``history`` positions (``_history``). A pipeline-staged
        engine's key is ``("pp", *that key)``: its program is the staged
        schedule (``parallel/pipeline.py``), never an unstaged one."""
        n_steps = max(1, min(r.chunk_hint or self.decode_chunk for _, r in active))
        ahead = sum(c.tokens_ahead for c in self._inflight)
        restrict = any(r.sampler.restricts and not r.sampler.greedy for _, r in active)
        want_lp = any(r.want_lp >= 0 for _, r in active)
        constrained = any(r.grammar is not None for _, r in active)

        def key(c):
            base = (n_steps, c, restrict, want_lp)
            base = ("dfa", *base, self._g_bucket) if constrained else base
            if self.decode_pp > 1:
                return ("pp", *base)
            if self.kv_pages:
                return ("paged", *base, self._history(active, ahead, n_steps * c))
            return base

        return key(self._loop_count(active, n_steps, ahead, key))

    def _history(self, active, ahead: int, n_pos: int) -> int:
        """The power-of-two bucket of the longest position any row of
        ``active`` can reach in a dispatch of ``n_pos`` positions after
        ``ahead`` in flight (the JAX engine's rule): the window a paged
        program gathers and a verify turn's attention reads."""
        max_seq = self.spec.max_seq
        planned = max(len(r.prompt_ids) + r.emitted for _, r in active) + ahead
        return prefill_bucket(min(planned + n_pos, max_seq), max_seq)

    def _loop_count(self, active, n_steps: int, ahead: int, key) -> int:
        """``_effective_loop``'s chunk (or fused turn) count; when the
        deadline clamped it, the largest count below that is already
        captured (a first capture costs seconds at full depth, more than the
        clamp saves), if there is one."""
        c = self._effective_loop(active, n_steps, ahead)
        if self._deadline_clamped and self._graphs is not None:
            c = next((k for k in (c >> i for i in range(c.bit_length()))
                      if key(k) in self._graphs), c)
        return c

    def _effective_loop(self, active, n_steps: int, ahead: int) -> int:
        """Chunks THIS dispatch may cover (1..``decode_loop``), clamped so
        the fusion never costs what it saves (the JAX engine's clamps):

        - **admission pressure** → 1: an admission waits for the ring to
          drain, and a C-chunk dispatch in it would stretch that wait C×;
        - **remaining budgets**: no more chunks than the longest still-live
          row can fill past the steps already in flight, rounded up to a
          power of two (log-many graph keys, not one per tail length);
        - **deadlines**: one dispatch must not outlive the tightest deadline
          of an active OR a queued request (the deadline sweep runs only
          between dispatches). Estimated from the per-chunk
          dispatch-to-reap EWMA and halved, staying a power of two, until
          it fits; no estimate yet (no reap) leaves C as it is. Unlike the
          JAX engine's clamp, the slack also leaves room for the chunks
          already in flight, which run before this dispatch does: at ring
          depth 2 a C-chunk dispatch behind another would otherwise push
          the sweep up to 2C chunks past the deadline. A clamped dispatch
          prefers a chunk count already captured (``_dispatch_key``)."""
        self._deadline_clamped = False
        c = self.decode_loop
        if c <= 1 or not active:
            return 1
        with self._cond:
            if self._admission_pressure():
                return 1
            # Queued requests with no free row press no admission, but the
            # sweep that sheds them waits for this dispatch to end.
            waiting = [r.deadline for r in self._pending if r.deadline is not None]
        rem = max(r.budget - r.emitted - ahead for _, r in active)
        if rem <= 0:
            return 1
        need = -(-rem // n_steps)
        cap = 1
        while cap < need:
            cap <<= 1
        c = min(c, cap)
        deadlines = waiting + [r.deadline for _, r in active if r.deadline is not None]
        if deadlines and self._chunk_ewma_s > 0.0:
            queued = sum(d.n_chunks for d in self._inflight)
            slack = min(deadlines) - time.monotonic() - queued * self._chunk_ewma_s
            while c > 1 and c * self._chunk_ewma_s > max(slack, 0.0):
                c //= 2
                self._deadline_clamped = True
        return c

    def _draw_noise(self, active, n_pos: int) -> None:
        """Top up the noise ring of every sampling row in ``active`` for a
        dispatch that samples up to ``n_pos`` positions. A row's device
        token counter is then at most ``emitted + ahead``, ``ahead`` being
        the tokens of the dispatches in flight that carry the row, so the
        dispatch reads draws below ``emitted + ahead + n_pos``, drawn here
        in token order. A slot is overwritten only by draw ``n + R``: every
        dispatch issued before the write reads its draws first (stream
        order), and R ≥ ``slack + n_pos`` keeps this dispatch's own, where
        ``slack`` is how far below that bound the counter may be. A plain
        engine's live rows advance by exactly the steps in flight (slack 0,
        R = one dispatch's positions); a spec engine's verify turns emit
        an unknown count (slack ``ahead``, R = the ring depth × one
        dispatch's positions). Greedy rows draw nothing."""
        ahead: dict[int, int] = {}
        for c in self._inflight:
            for _, r in c.carries():
                ahead[id(r)] = ahead.get(id(r), 0) + c.tokens_ahead
        rows = [(i, r, r.emitted + ahead.get(id(r), 0) + n_pos)
                for i, r in active if not r.sampler.greedy]
        slack = max((ahead.get(id(r), 0) for _, r, _ in rows), default=0)
        ring = self._ring_for(n_pos + (slack if self.spec_decode else 0))
        depth, vocab = ring.shape[0], self.spec.vocab_size
        for i, r, reach in rows:
            for n in range(r.n_drawn, reach):
                gumbel_noise(vocab, r.generator, out=ring[n % depth, i])
            r.n_drawn = max(r.n_drawn, reach)

    def _ring_for(self, need: int) -> torch.Tensor:
        """The noise ring, deepened to ``need`` slots when a dispatch reaches
        further (a request's chunk hint above ``decode_chunk``): after a
        stream sync every graph that read the old ring is dropped and each
        sampling row's draws not yet read move to their slots in the new
        one."""
        old = self._noise_ring
        if old.shape[0] >= need:
            return old
        if self._graphs is not None:
            self._stream.synchronize()  # no dispatch in flight reads the old ring
            self._graphs.clear()
        new = torch.zeros((need, *old.shape[1:]), dtype=old.dtype, device=self.device)
        ntok = self._ntok.tolist()
        with self._cond:
            rows = [(i, r) for i, r in enumerate(self._slots) if r is not None]
        for i, r in rows:
            for n in range(ntok[i], r.n_drawn):
                new[n % need, i].copy_(old[n % old.shape[0], i])
        self._noise_ring = new
        return new

    def _noise_at(self, ntok: torch.Tensor) -> torch.Tensor:
        """``[rows, *ntok.shape[1:], V]`` draws at token indices ``ntok``
        (``[rows]`` or ``[rows, n]``), read from the ring on the device."""
        ring = self._noise_ring
        rows = torch.arange(ntok.shape[0], device=ntok.device)
        rows = rows.view(-1, *([1] * (ntok.dim() - 1)))
        return ring[torch.remainder(ntok, ring.shape[0]), rows]

    # ---- constrained decoding: the grammar arena ---------------------------

    def _ensure_grammar(self, grammar) -> int:
        """Place a compiled grammar's token-DFA rows in the arena (scheduler
        thread, no lock held) and return the GLOBAL start state a request
        decoding under it begins in. Idempotent per grammar: its offset
        stays put for the arena's lifetime, so rows' device states stay
        valid as other grammars come and go. A new grammar's rows are
        copied in place when they fit the current bucket; past it the
        tables move to a larger bucket (``_fit_arena``)."""
        key = grammar.key or ("anon", id(grammar))
        off = self._g_offsets.get(key)
        if off is None:
            if grammar.vocab_size != self.spec.vocab_size:
                raise ValueError(
                    f"grammar compiled for vocab {grammar.vocab_size} "
                    f"cannot constrain a vocab-{self.spec.vocab_size} model")
            if self._g_states + grammar.n_states > CONSTRAIN_ARENA_MAX:
                raise GrammarArenaFull(
                    f"grammar arena at capacity ({self._g_states} of "
                    f"{CONSTRAIN_ARENA_MAX} states; this grammar needs "
                    f"{grammar.n_states} more) — retry after constrained "
                    "traffic quiesces")
            off = self._g_states
            self._fit_arena(off + grammar.n_states)
            trans = torch.from_numpy(grammar.trans)
            rows = torch.where(trans >= 0, trans + off, -1)
            accept = torch.from_numpy(grammar.accept.astype(bool))
            end = off + grammar.n_states
            self._g_trans[off:end].copy_(self._staged(rows), non_blocking=True)
            self._g_accept[off:end].copy_(self._staged(accept), non_blocking=True)
            self._g_states = end
            self._g_offsets[key] = off
        return off + grammar.start

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the source of an asynchronous host-to-device copy."""
        return t.pin_memory() if self.device.type == "cuda" else t

    def _fit_arena(self, n_states: int) -> None:
        """Make the tables hold ``n_states`` states, padded to a power-of-two
        bucket (padding rows allow and accept nothing). Within the bucket
        nothing moves; a larger bucket gets new tables with the old rows
        copied in, and every constrained graph, captured on the old
        tables' addresses, is dropped."""
        bucket = 1
        while bucket < n_states:
            bucket <<= 1
        if bucket == self._g_bucket:
            return
        vocab, dev = self.spec.vocab_size, self.device
        trans = torch.full((bucket, vocab), -1, dtype=torch.int32, device=dev)
        accept = torch.zeros((bucket,), dtype=torch.bool, device=dev)
        if self._g_trans is None:
            trans[0] = 0  # FREE: every token allowed, a self-loop, accepting
            accept[0] = True
        else:
            self._drop_constrained_graphs()
            trans[:self._g_bucket].copy_(self._g_trans)
            accept[:self._g_bucket].copy_(self._g_accept)
        self._g_trans, self._g_accept, self._g_bucket = trans, accept, bucket

    def _drop_constrained_graphs(self) -> None:
        """Drop the graphs of the constrained variant once no dispatch in
        flight replays them: they read the arena tables at the addresses
        they were captured with, which are about to go."""
        if self._graphs is not None:
            self._stream.synchronize()
            self._graphs.drop(_constrained_key)

    def _maybe_reset_arena(self) -> None:
        """Drop the arena once it has grown past CONSTRAIN_ARENA_KEEP states
        AND no request (active, admitting or pending) references a grammar:
        the only moment offsets may move. Every row's state returns to FREE,
        so no stale state can index the next, smaller tables. Below the
        threshold the arena stays as a warm cache."""
        if self._g_states <= CONSTRAIN_ARENA_KEEP:
            return
        with self._cond:
            busy = (any(r is not None and r.grammar is not None for r in self._slots)
                    or any(a.req.grammar is not None for a in self._admitting)
                    or any(r.grammar is not None for r in self._pending))
        if busy:
            return
        self._drop_constrained_graphs()
        self._dfa.zero_()
        self._g_offsets = {}
        self._g_states = 1
        self._g_trans = self._g_accept = None
        self._g_bucket = 0

    def _decode_program(self, n_steps: int, n_chunks: int, restrict: bool, want_lp: bool,
                        constrained: bool = False,
                        history: int | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One decode dispatch over the rows set in ``_mask``: ``decode_chunk``
        for one chunk, ``decode_loop`` for more. Every step samples from
        ``adjust_logits`` (each row's bias, penalties and counts) and adds
        the sampled token to the row's counts. Reads the noise drawn ahead
        (each row's token-indexed draws in ``_noise_ring``), updates the per-row
        state in place and returns ``[n_chunks, rows, n_steps + 1]`` int64
        (each chunk's tokens, then each row's valid count) and, when
        ``want_lp``, ``[n_chunks, n_steps, rows, 1 + 2·TOP_LOGPROBS]`` f32
        (the sampled token's logprob, the top logprobs, then their ids,
        exact in f32 below 2^24), else None. The card captures it once per
        key and replays it; nothing in it syncs the host.

        ``constrained`` (the JAX engine's grammar variant): each step
        gathers every row's arena row ``trans[dfa]`` [rows, V], allows the
        tokens with a next state ≥ 0 and EOS exactly where the state
        accepts, masks before sampling, advances the state of each live
        row whose token is not EOS, and counts the masked entries of live
        constrained rows (state > 0): a last column of the token output,
        per row summed over the chunk's steps. Each row's noise is its next
        token's draw (``_ntok``, advanced per live step). ``history`` is a
        paged cache's gathered window (None on a dense cache)."""
        n_top = min(TOP_LOGPROBS, self.spec.vocab_size)
        trans, eos = self._g_trans, self._eos

        def sample_fn(logits, live, carry):
            ntok, counts = carry[:2]
            adj = adjust_logits(logits, self._bias, counts, self._pp, self._fp)
            if constrained:
                dfa = carry[2]
                allow = self._allow(dfa)  # [rows, V]
                adj = apply_token_mask(adj, allow)
            nxt = sample_token_rows(adj, self._temp, self._topp, self._topk,
                                    self._noise_at(ntok), restrict=restrict)
            counts = counts.scatter_add(1, nxt[:, None], live[:, None].to(counts.dtype))
            ntok = ntok + live.to(ntok.dtype)
            aux = ()
            if want_lp:
                s_lp, top_ix, top_lp = token_logprobs(adj, nxt, n_top)
                aux = (torch.cat([s_lp[:, None], top_lp, top_ix.float()], dim=-1),)
            if not constrained:
                return nxt, (ntok, counts), aux
            masked = (~allow & (live & (dfa > 0))[:, None]).sum(dim=1)
            nxt_state = trans[dfa.long(), nxt]
            dfa = torch.where(live & (nxt != eos) & (nxt_state >= 0), nxt_state, dfa)
            return nxt, (ntok, counts, dfa), aux + (masked,)

        # Inactive slots run the forward (the batch is static) but their K/V
        # write is masked off; rows that finished on device stay dead.
        live0 = self._mask & self._live & (self._budget > 0)
        carry0 = ((self._ntok, self._counts, self._dfa) if constrained
                  else (self._ntok, self._counts))
        args = (self._token, self._lengths, live0, self._budget, self._eos, self._ck, self._cv,
                sample_fn, carry0)
        if self.decode_pp > 1:
            # Pipeline-staged (parallel/pipeline.py): the same contracts as
            # a row-group pipeline over the stages, this rank stage 0.
            if n_chunks == 1:
                toks, _, n_valid, live, budget, _, _, lengths, carry, aux = staged_decode_chunk(
                    self.params, self.spec, self._rmesh, n_steps, *args)
                toks, n_valid, token = toks[None], n_valid[None], toks[:, -1]
                aux = tuple(a[None] for a in aux)
            else:
                toks, n_valid, token, live, budget, _, _, lengths, carry, aux = (
                    staged_decode_loop(self.params, self.spec, self._rmesh, n_steps, n_chunks,
                                       *args))
        elif n_chunks == 1:
            toks, _, n_valid, live, budget, _, _, lengths, carry, aux = decode_chunk(
                self.params, self.spec, n_steps, *args, ensemble=self.ensemble, history=history,
                mesh=self._rmesh)
            toks, n_valid, token = toks[None], n_valid[None], toks[:, -1]
            aux = tuple(a[None] for a in aux)
        else:
            toks, n_valid, token, live, budget, _, _, lengths, carry, aux = decode_loop(
                self.params, self.spec, n_steps, n_chunks, *args, ensemble=self.ensemble,
                history=history, mesh=self._rmesh)
        # Rows outside this dispatch's active set keep their state.
        self._live.copy_(torch.where(self._mask, live, self._live))
        self._token.copy_(torch.where(self._mask, token, self._token))
        self._counts.copy_(torch.where(self._mask[:, None], carry[1], self._counts))
        self._ntok.copy_(torch.where(self._mask, carry[0], self._ntok))
        self._budget.copy_(budget)
        self._lengths.copy_(lengths)
        cols = [toks, n_valid[..., None].to(toks.dtype)]
        if constrained:
            self._dfa.copy_(torch.where(self._mask, carry[2], self._dfa))
            cols.append(aux[-1].sum(dim=1)[..., None].to(toks.dtype))  # [C, rows, 1]
        return torch.cat(cols, dim=-1), aux[0] if want_lp else None

    def _warm_up(self, history: int | None = None) -> None:
        """One eager decode step with no row active (every write masked, no
        state changed), on the capture stream, before the first capture: it
        makes the lazy state a graph must not allocate (K2's scratch for the
        stream, RoPE tables, cuBLAS's workspace, the logprob variant's
        top-k). It launches K2 once per layer
        (``decode_graph_warmup_steps_total``). A paged engine warms each
        history bucket before its first capture: K2q8's scratch is sized
        from the window it reads."""
        mask = self._mask.clone()
        self._mask.zero_()
        self._decode_program(1, 1, True, True, history=history)
        self._mask.copy_(mask)
        self.n_graph_warmup_steps += 1

    def _dispatch_chunk(self, active: list[tuple[int, _Request]]) -> _InflightChunk:
        """Issue one decode dispatch over ``active`` and the copy of its
        tokens to the host, without waiting for either: one graph replay on
        the card. The ``engine.decode`` fault site fires first, on the host,
        before anything is enqueued."""
        faults.fire("engine.decode")
        key = self._dispatch_key(active)
        history = key[-1] if key[0] == "paged" else None
        body = key[1:-1] if key[0] == "paged" else key[1:] if key[0] == "pp" else key
        constrained = body[0] == "dfa"
        program = (*body[1:5], True) if constrained else body
        n_steps, n_chunks = program[:2]
        self.n_deadline_clamps += self._deadline_clamped
        self._set_mask(active)
        self._draw_noise(active, n_steps * n_chunks)
        self.n_decode_steps += n_steps * n_chunks
        return self._issue(key, lambda: self._decode_program(*program, history=history), active,
                           n_steps, n_chunks, constrained)

    def _set_mask(self, active) -> None:
        flags = [False] * self._rows
        for i, _ in active:
            flags[i] = True
        host_to_device(flags, torch.bool, self.device, out=self._mask)

    def _issue(self, key: tuple, program, active, n_steps: int, n_chunks: int,
               constrained: bool, spec_turn: bool = False, drafted: int = 0,
               warm_up=None, history: int | None = None) -> _InflightChunk:
        """Run one dispatch's program (one graph replay on the card, eagerly
        on the CPU) and enqueue the copy of its outputs to the host. A spec
        dispatch brings the ``warm_up`` of its key family (``key[0]``) and
        its verify turns' ``history`` bucket. On the card a pair of timing
        events brackets the replay on the engine's stream (outside any
        capture), read at reap; the flight recorder gets the dispatch
        event. From here on the dispatch's program runs on the engine's
        state (``_program_issued``)."""
        if self._ranks is not None:
            # The workers' half: the same steps (a spec dispatch's verify
            # turns: n_chunks turns of n_steps = g+1 positions), and the
            # eager warm-up step or turn a first capture runs first (a paged
            # key's window rides along).
            paged = key[0] == "paged"
            if spec_turn:
                warm = self._graphs is not None and self._graphs.will_warm(
                    key, _spec_family(key))
                self._plan("verify", n_steps, n_chunks, warm, history)
            else:
                warm = self._graphs is not None and self._graphs.will_warm(
                    key, ("paged", key[-1]) if paged else None)
                self._plan("decode", n_steps, n_chunks, warm, key[-1] if paged else None)
        self._program_issued = True
        self.dispatched_keys.add(key)
        t_issue = time.perf_counter()
        timing = None
        if self._graphs is None:
            out, lp = program()
        else:
            timing = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            if spec_turn:
                out, lp = self._graphs.replay(key, program, warm_up,
                                              family=_spec_family(key), timing=timing)
            elif key[0] == "paged":
                out, lp = self._graphs.replay(key, program, lambda: self._warm_up(key[-1]),
                                              family=("paged", key[-1]), timing=timing)
            else:
                out, lp = self._graphs.replay(key, program, self._warm_up, timing=timing)
        host, lp_host, event = out, lp, None
        if self.device.type == "cuda":
            # Enqueued right after the replay: the next dispatch's replay
            # rewrites ``out`` and ``lp`` only after these copies read them.
            host = self._pinned(out)
            lp_host = None if lp is None else self._pinned(lp)
            event = torch.cuda.Event()
            event.record()
        self.n_decode_chunks += 1
        self.n_decode_rows += len(active)
        c = _InflightChunk(active, n_steps, n_chunks, host, event, lp=lp_host,
                           constrained=constrained, spec_turn=spec_turn, drafted=drafted)
        self._dispatch_seq += 1
        c.family, c.seq, c.depth = program_family(key), self._dispatch_seq, len(self._inflight)
        c.timing, c.t_issue = timing, t_issue
        FLIGHT.record("dispatch", engine=self._tag, loop="decode", t=t_issue, seq=c.seq,
                      family=c.family, depth=c.depth, chunks=n_chunks, steps=n_steps,
                      **({"drafted": drafted} if spec_turn else {}),
                      rids=[r.rid for _, r in active])
        obs.PIPELINE_DEPTH.set(c.depth + 1)
        return c

    # ---- speculative decoding ----------------------------------------------

    def _spec_key(self, active, g: int, n_turns: int, ahead: int) -> tuple:
        """The graph key of a spec dispatch over ``active``: a verify turn
        ``("verify", g, sort, lp, history)`` (constrained: ``("dfa_verify",
        g, sort, lp, history, arena bucket)``) or ``n_turns`` fused
        draft→verify turns ``("spec_loop", C, g, sort, lp, history[, "dfa",
        arena bucket])``. ``history`` is the power-of-two bucket of the
        longest position any row can reach in the dispatch (the JAX
        engine's rule): the verify's plain attention reads ``[0, history)``
        of each row, not the whole window."""
        restrict = any(r.sampler.restricts and not r.sampler.greedy for _, r in active)
        want_lp = any(r.want_lp >= 0 for _, r in active)
        constrained = any(r.grammar is not None for _, r in active)
        history = self._history(active, ahead, (g + 1) * n_turns)
        if self._draft_rt is None:
            key = ("verify", g, restrict, want_lp, history)
            if constrained:
                key = ("dfa_verify", *key[1:], self._g_bucket)
            return ("paged", *key) if self.kv_pages else key
        key = ("spec_loop", n_turns, g, restrict, want_lp, history)
        return (*key, "dfa", self._g_bucket) if constrained else key

    def _try_spec_dispatch(self, active, g: int, ahead: int, depth: int) -> str:
        """Try to make the next ring entry a speculative dispatch (the JAX
        engine's rules). Returns ``"dispatched"`` (an entry was appended),
        ``"chunk"`` (no draft anywhere and no verify turn in flight: a plain
        chunk should go instead) or ``"stop"`` (leave the ring as it is: a
        verify turn is in flight or a row looks repetitive but is only stale,
        so a chunk now would run rows past the host's view and spoil every
        later draft; or the key is not captured yet and a capture would
        hold back the dispatches in flight; or a fused engine must resync a
        reassigned row, which waits for the ring to drain)."""
        rt = self._draft_rt
        n_turns = 1
        self._deadline_clamped = False  # a verify turn is one turn: nothing to clamp
        if rt is not None:
            n_turns = self._loop_count(active, g + 1, ahead,
                                       lambda c: self._spec_key(active, g, c, ahead))
        key = self._spec_key(active, g, n_turns, ahead)
        if depth > 0 and self._graphs is not None and key not in self._graphs:
            return "stop"
        if rt is not None and depth > 0 and any(rt.reqs[i] is not r for i, r in active):
            return "stop"
        drafts: dict[int, list[int]] = {}
        if rt is None:
            for i, r in active:
                if r.spec_draft_ok:
                    d = self._form_draft(r, g)
                    if d is not None:
                        drafts[i] = d
            if not drafts:
                # A draftless verify turn emits one token per dispatch and
                # forfeits the chunk's amortization for nothing.
                if any(c.spec_turn for c in self._inflight):
                    return "stop"
                if any(r.spec_draft_ok and r.n_inflight > 0
                       and (r.spec_state is not None
                            or (len(r.hist) >= 4
                                and (r.hist[-2], r.hist[-1]) in r.ngram))
                       for _, r in active):
                    # A repetitive row only stale (dispatches in flight hide
                    # its true tail): hold the ring; it drains within K reaps
                    # and a fresh draft re-engages speculation. Rows with no
                    # n-gram signal never hold it.
                    return "stop"
                return "chunk"
        self.n_deadline_clamps += self._deadline_clamped
        self._program_issued = False
        try:
            faults.fire("engine.verify")
            chunk = self._dispatch_spec(key, active, g, n_turns, drafts)
        except Exception as exc:
            if self._program_issued:
                raise  # it ran on the engine's state: the turn's failure (``_fail_all``)
            self._contain_verify_failure(active, exc)
            return "stop"
        self._inflight.append(chunk)
        for _, r in active:
            r.n_inflight += 1
        if depth > 0:
            self.n_overlapped += 1
            self.n_spec_overlapped += 1
        return "dispatched"

    def _dispatch_spec(self, key: tuple, active, g: int, n_turns: int,
                       drafts: dict) -> _InflightChunk:
        """Issue one speculative dispatch: a verify turn over host-formed
        drafts (``_draft_buf``, −1 = no draft), or ``n_turns`` fused
        draft→verify turns whose drafts the device makes (``_spec_ok``
        marks the rows that may draft). Before a key family's first capture
        its program runs once eagerly with no row active, making the lazy
        state a capture must not allocate."""
        constrained = _constrained_key(key)
        body = key[1:] if key[0] == "paged" else key
        restrict, want_lp, history = body[3:6] if body[0] == "spec_loop" else body[2:5]
        rt = self._draft_rt
        self._set_mask(active)
        if rt is None:
            rows = [[-1] * g for _ in range(self._rows)]
            drafted = 0
            for i, d in drafts.items():
                rows[i] = list(d)
                drafted += sum(1 for t in d if t >= 0)
            host_to_device(rows, torch.long, self.device, out=self._draft_buf[:, :g])

            def program():
                return self._verify_program(g, restrict, want_lp, constrained, history)
        else:
            rt.ensure_chain(g)
            for i, r in active:
                if rt.reqs[i] is not r:
                    rt.resync(i, r, g)
            ok = [False] * self._rows
            for i, r in active:
                ok[i] = r.spec_draft_ok
            host_to_device(ok, torch.bool, self.device, out=self._spec_ok)
            drafted = g * sum(ok)

            def program():
                return self._spec_loop_program(n_turns, g, restrict, want_lp, constrained,
                                               history)
        self._draw_noise(active, (g + 1) * n_turns)
        if rt is not None:
            self.n_draft_steps += (g - 1) * n_turns
        return self._issue(key, program, active, g + 1, n_turns, constrained,
                           spec_turn=True, drafted=drafted,
                           warm_up=lambda: self._warm_spec(g, restrict, want_lp, constrained,
                                                           history), history=history)

    def _contain_verify_failure(self, active, exc: Exception) -> None:
        """A speculative dispatch failed (fault injection, host-side error)
        before its program was issued (``_issue``: a capture, a replay or
        the eager program): doom only this turn's rows. What the dispatch
        enqueued before that writes only its own inputs, which every
        dispatch rewrites (the mask, the drafts, the draft flags), and the
        turn's own rows (their noise, the fused draft's resync of a
        reassigned row, which waits for an empty ring). Older dispatches in
        flight reap normally (their tokens for the released rows count as
        overrun) and pending requests keep their place. A failure once the
        program was issued is the scheduler turn's, and ``_fail_all`` takes
        it: the port's counterpart of the JAX engine's donated-buffer
        check."""
        FLIGHT.record("containment", engine=self._tag, loop="decode", site="verify",
                      error=f"{type(exc).__name__}: {exc}"[:200],
                      rids=[r.rid for _, r in active])
        FLIGHT.dump("containment")
        self.n_failures += len(active)
        for _, r in active:
            if r.trace is not None:
                now = time.perf_counter()
                r.trace.add_span_abs("engine-failure", now, now, error=type(exc).__name__,
                                     contained=True)
            r.out.put(("err", exc))
        with self._cond:
            for i, r in active:
                if self._slots[i] is r:
                    self._release_slot(i, r)

    def _warm_spec(self, g: int, restrict: bool, want_lp: bool, constrained: bool,
                   history: int) -> None:
        """One eager spec turn with no row active (every write masked, no
        state changed) on the capture stream: K2's scratch at the draft's
        shapes, its RoPE tables, the batched products' workspaces. A fused
        turn launches K2 once per draft layer and extension step
        (``spec_draft_steps_total``)."""
        mask = self._mask.clone()
        self._mask.zero_()
        if self._draft_rt is None:
            self._verify_program(g, restrict, want_lp, constrained, history)
        else:
            self._spec_loop_program(1, g, restrict, want_lp, constrained, history)
            self.n_draft_steps += g - 1
        self._mask.copy_(mask)

    def _state(self) -> dict:
        return {"token": self._token, "lengths": self._lengths, "live": self._live,
                "budget": self._budget, "ntok": self._ntok, "counts": self._counts,
                "dfa": self._dfa}

    def _set_state(self, st: dict) -> None:
        for name, t in st.items():
            getattr(self, "_" + name).copy_(t)

    def _allow(self, states: torch.Tensor) -> torch.Tensor:
        """The grammar allow-set of arena states ``[rows, ...]`` →
        ``[rows, ..., V]``: next state ≥ 0, EOS exactly where the state
        accepts (and the row has an EOS)."""
        eos = self._eos.view(-1, *([1] * states.dim()))
        vocab = torch.arange(self.spec.vocab_size, device=states.device)
        eos_ok = (self._g_accept[states.long()] & (self._eos >= 0).view(
            -1, *([1] * (states.dim() - 1))))[..., None]
        return torch.where(vocab == eos, eos_ok, self._g_trans[states.long()] >= 0)

    def _verify_turn(self, st: dict, draft: torch.Tensor, g: int, restrict: bool,
                     want_lp: bool, constrained: bool, history: int):
        """One verify turn over the rows in ``_mask`` (the JAX engine's
        ``_verify_core``): a ``decode_multi`` over ``[anchor, g drafts]``
        (−1 sentinels gather token 0 and are never accepted), every
        position's logits adjusted with the turn-start counts (exact: rows
        that may emit more than one token have no penalty, and a static
        bias), all g+1 positions sampled at once, each with the row's draw
        for that token index, then chain acceptance ``cumprod(draft ==
        sampled[:, :-1])``, emission cut at the first EOS and at the budget.
        ``constrained`` walks the arena over the draft up front and masks
        position j by its draft-prefix state's allow-set; the carried state
        advances over the emitted chain. Returns the new state and
        ``(sampled [rows, g+1], e [rows], lp [g+1, rows, 41] | None,
        masked [rows] | None)``."""
        n, vocab = g + 1, self.spec.vocab_size
        token, lengths, budget, counts, ntok, dfa = (
            st[k] for k in ("token", "lengths", "budget", "counts", "ntok", "dfa"))
        eos = self._eos
        live = self._mask & st["live"] & (budget > 0)
        tokens = torch.cat([torch.where(live, token, 0)[:, None], draft.clamp(min=0)], dim=1)
        logits, _, _ = decode_multi(self.params, self.spec, tokens, torch.where(live, lengths, 0),
                                    self._ck, self._cv, write_mask=live, history=history,
                                    clamp_writes=True, ensemble=self.ensemble, mesh=self._rmesh)
        adj = adjust_logits(logits, self._bias[:, None], counts[:, None], self._pp[:, None],
                            self._fp[:, None])                                # [rows, n, V]
        rows = adj.shape[0]
        if constrained:
            states = [dfa]
            for j in range(g):
                d = draft[:, j]
                nxt = self._g_trans[states[-1].long(), d.clamp(min=0)]
                states.append(torch.where((d >= 0) & (nxt >= 0), nxt, torch.zeros_like(nxt)))
            states = torch.stack(states, dim=1)                               # [rows, n]
            allow = self._allow(states)                                       # [rows, n, V]
            adj = apply_token_mask(adj, allow)
        j = torch.arange(n, device=adj.device)
        noise = self._noise_at(ntok[:, None] + j[None, :])                    # [rows, n, V]

        def per_pos(t):
            return t.repeat_interleave(n)

        flat = adj.reshape(rows * n, vocab)
        sampled = sample_token_rows(flat, per_pos(self._temp), per_pos(self._topp),
                                    per_pos(self._topk), noise.reshape(rows * n, vocab),
                                    restrict=restrict).view(rows, n)
        ok = torch.cumprod((draft == sampled[:, :-1]).to(torch.int32), dim=1)
        not_eos = (sampled[:, :-1] != eos[:, None]) | (eos < 0)[:, None]
        cont = ok.bool() & not_eos & (budget[:, None] > j[None, 1:])
        emit = torch.cat([torch.ones_like(ok[:, :1]), torch.cumprod(cont.to(torch.int32), 1)],
                         dim=1) * live[:, None].to(torch.int32)               # [rows, n]
        e = emit.sum(dim=1)
        e1 = e.clamp(min=1)
        last = sampled.gather(1, (e1 - 1)[:, None].long())[:, 0]
        budget_new = budget - e.to(budget.dtype)
        fin = live & ((last == eos) | (budget_new <= 0))
        new = {
            "token": torch.where(live, last, token),
            "lengths": lengths + e.to(lengths.dtype),
            "live": torch.where(self._mask, live & ~fin, st["live"]),
            "budget": budget_new,
            "ntok": ntok + e.to(ntok.dtype),
            "counts": counts.scatter_add(1, sampled, emit.to(counts.dtype)),
            "dfa": dfa,
        }
        lp = masked = None
        if want_lp:
            s_lp, top_ix, top_lp = token_logprobs(flat, sampled.reshape(-1),
                                                  min(TOP_LOGPROBS, vocab))
            lp = torch.cat([s_lp[:, None], top_lp, top_ix.float()], dim=-1)
            lp = lp.view(rows, n, -1).transpose(0, 1)
        if constrained:
            con = live & (dfa > 0)
            masked = (~allow & con[:, None, None] & (emit[:, :, None] > 0)).sum(dim=(1, 2))
            st_last = states.gather(1, (e1 - 1)[:, None].long())[:, 0]
            nd = self._g_trans[st_last.long(), last]
            adv = (last != eos) & (nd >= 0)
            new["dfa"] = torch.where(live, torch.where(adv, nd, st_last), dfa)
        return new, (sampled, e, lp, masked)

    def _spec_out(self, sampled, e, masked) -> torch.Tensor:
        """One turn's token columns: ``[rows, g+1]`` sampled tokens, the
        emitted count (and the masked entries of a constrained turn)."""
        cols = [sampled, e[:, None].to(sampled.dtype)]
        if masked is not None:
            cols.append(masked[:, None].to(sampled.dtype))
        return torch.cat(cols, dim=1)

    def _verify_program(self, g: int, restrict: bool, want_lp: bool, constrained: bool,
                        history: int):
        """One verify turn over ``_draft_buf``: returns ``[1, rows, g+2]``
        int64 (g+1 sampled tokens, then the emitted count; constrained: one
        more column, the masked entries) and, when ``want_lp``, ``[1, g+1,
        rows, 1 + 2·TOP_LOGPROBS]`` records — a chunk's payload with
        n_steps = g+1."""
        new, (sampled, e, lp, masked) = self._verify_turn(
            self._state(), self._draft_buf[:, :g], g, restrict, want_lp, constrained, history)
        self._set_state(new)
        return self._spec_out(sampled, e, masked)[None], None if lp is None else lp[None]

    def _spec_loop_program(self, n_turns: int, g: int, restrict: bool, want_lp: bool,
                           constrained: bool, history: int):
        """Up to ``n_turns`` fused draft→verify turns (the JAX engine's
        ``_spec_loop_fn``). Each turn: (1) the draft model ingests the last
        verify turn's emitted chain (ending at the target's carried token)
        through a ``decode_multi`` of width g+1 — the verify's own width, so
        an oracle draft's K/V reassociates like the target's — and picks
        its first token; (2) g−1 greedy draft steps through ``decode_step``
        (K2 on the card), each pick masked by its draft-prefix grammar state
        when constrained; (3) the verify turn, rows that may not draft
        (``_spec_ok`` False) carrying −1 sentinels. A turn no row enters
        runs with every write masked and returns zeros (the megachunk's
        skipped chunk). Returns ``[n_turns, rows, g+2(+1)]`` and, when
        ``want_lp``, ``[n_turns, g+1, rows, 41]``."""
        rt = self._draft_rt
        dspec = rt.spec
        st = self._state()
        chain, chain_n = rt.chain, rt.chain_n
        col = torch.arange(g + 1, device=chain.device)
        outs, lps = [], []

        def pick(lg, state):
            lg = lg.float()
            if constrained:
                lg = apply_token_mask(lg, self._allow(state))
            return lg.argmax(dim=-1)

        for _ in range(n_turns):
            live = self._mask & st["live"] & (st["budget"] > 0)
            entered = live.any()
            feed = chain.gather(1, torch.minimum(col[None, :], chain_n[:, None] - 1))
            pos0 = torch.where(live, st["lengths"] - chain_n.to(st["lengths"].dtype) + 1, 0)
            dlg, _, _ = decode_multi(rt.params, dspec, feed, pos0, rt.ck, rt.cv,
                                     write_mask=live, history=history, clamp_writes=True)
            dlg = dlg.gather(1, (chain_n - 1).view(-1, 1, 1).expand(-1, 1, dlg.shape[-1]))[:, 0]
            state = st["dfa"]
            tok = pick(dlg, state)
            drafted = [tok]
            dlen = torch.where(live, st["lengths"] + 1, 0)
            for _ in range(g - 1):
                # Near the cap extension writes past max_seq land on its last
                # position: draft cache only, rewritten as the stream gets
                # there (the verify drops its own out-of-range writes).
                lg, _, _ = decode_step(rt.params, dspec, tok, dlen.clamp(max=dspec.max_seq - 1),
                                       rt.ck, rt.cv, write_mask=live)
                if constrained:
                    nd = self._g_trans[state.long(), tok]
                    state = torch.where(nd >= 0, nd, torch.zeros_like(nd))
                tok = pick(lg, state)
                drafted.append(tok)
                dlen = dlen + 1
            draft = torch.where(self._spec_ok[:, None], torch.stack(drafted, dim=1), -1)
            st, (sampled, e, lp, masked) = self._verify_turn(st, draft, g, restrict, want_lp,
                                                             constrained, history)
            chain = torch.where(live[:, None], sampled, chain)
            chain_n = torch.where(live, e.clamp(min=1).to(chain_n.dtype), chain_n)
            out = self._spec_out(sampled, e, masked)
            outs.append(torch.where(entered, out, torch.zeros_like(out)))
            if lp is not None:
                lps.append(torch.where(entered, lp, torch.zeros_like(lp)))
        self._set_state(st)
        rt.chain.copy_(chain)
        rt.chain_n.copy_(chain_n)
        return torch.stack(outs), torch.stack(lps) if lps else None

    def _form_draft(self, req: _Request, g: int) -> list[int] | None:
        """Per-row prompt-lookup draft for the next verify dispatch (the JAX
        engine's). Nothing in flight for the row: :meth:`_draft` on the true
        history, remembering its source when the draft is the index's own
        continuation. Turns in flight: continue from that source,
        assuming the in-flight turns accept in full — a full-accept turn
        emits its g drafts plus one undrafted bonus token, and the next
        turn's first draft proposes that turn's own first sample, so the
        cursor skips one between drafts; off the real history it re-anchors
        through the index on the last two optimistic tokens. A wrong
        assumption costs acceptance only: the reap resets the cursor."""
        if req.n_inflight == 0:
            d = self._draft(req, g)
            req.spec_state = None
            if d is None:
                return None
            if req.grammar is not None:
                d = self._filter_draft(req, req.dfa_host, d)
            if d is not None and all(t >= 0 for t in d) and len(req.hist) >= 4:
                pos = req.ngram.get((req.hist[-2], req.hist[-1]))
                if pos is not None:
                    cont = req.hist[pos + 1:pos + 1 + g]
                    if d == cont + [cont[-1]] * (g - len(cont)):
                        opt = (req.hist + d)[-2:]
                        odfa = self._advance_local(req, req.dfa_host, d)
                        req.spec_state = (pos + 1 + g, opt[0], opt[1], odfa)
            return d
        state = req.spec_state
        if state is None:
            return None
        cont: list[int] = []
        truncated = False
        for k in range(g + 1):
            step = self._spec_take(req, state)
            if step is None:
                state = None
                break
            state, tok = step
            if req.grammar is not None:
                src, t1, t2, odfa = state
                odfa = int(req.grammar.trans[odfa, tok]) if odfa >= 0 else -1
                if odfa < 0:
                    # The optimistic stream leaves the grammar here: the
                    # full-accept assumption cannot extend past it.
                    state = None
                    truncated = True
                    break
                state = (src, t1, t2, odfa)
            if k >= 1:  # the first token taken is the undrafted bonus
                cont.append(tok)
        req.spec_state = state
        if not cont:
            return None
        if len(cont) < g:
            cont = cont + [-1 if truncated else cont[-1]] * (g - len(cont))
        return cont

    @staticmethod
    def _spec_take(req: _Request, state):
        """Advance the optimistic cursor one source token: ``(new state,
        token)``, or None when it dies. Off the real history it re-anchors
        through the index on the optimistic stream's trailing pair."""
        src, t1, t2, odfa = state
        if src >= len(req.hist):
            pos = req.ngram.get((t1, t2))
            if pos is None or pos + 1 >= len(req.hist):
                return None
            src = pos + 1
        tok = req.hist[src]
        return (src + 1, t2, tok, odfa), tok

    @staticmethod
    def _advance_local(req: _Request, state: int, d: list[int]) -> int:
        """Walk a host-side LOCAL DFA state over draft tokens (−1 = unknown,
        stays unknown). Draft quality only: the device mask decides."""
        if req.grammar is None:
            return -1
        for t in d:
            if state < 0 or t < 0:
                return -1
            state = int(req.grammar.trans[state, t])
        return state

    @staticmethod
    def _filter_draft(req: _Request, state: int, d: list[int]):
        """Cut a prompt-lookup draft at its first token the grammar refuses
        from the LOCAL ``state`` (−1: unknown, no filtering), padding with
        −1 sentinels: the draft never proposes a token the mask would
        remove. A stale state costs acceptance only."""
        if state < 0:
            return d
        out: list[int] = []
        for t in d:
            if t < 0:
                break
            nxt = int(req.grammar.trans[state, t])
            if nxt < 0:
                break
            out.append(t)
            state = nxt
        if not out:
            return None
        return out + [-1] * (len(d) - len(out))

    @staticmethod
    def _draft(req: _Request, g: int) -> list[int] | None:
        """Prompt-lookup draft: the most recent earlier occurrence of the
        trailing 2-gram, continued for g tokens (the last one repeated when
        the history runs out). Suggestions only: verification accepts a
        token iff it equals what the model itself samples there."""
        hist = req.hist
        if len(hist) < 4:
            return None
        pos = req.ngram.get((hist[-2], hist[-1]))
        if pos is None:
            return None
        cont = hist[pos + 1:pos + 1 + g]
        return cont + [cont[-1]] * (g - len(cont))

    def _pinned(self, src: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer from the pool (by shape and dtype), with an
        asynchronous copy of ``src`` into it enqueued on the stream."""
        pool = self._host_pool.setdefault((tuple(src.shape), src.dtype), [])
        buf = pool.pop() if pool else torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        return buf.copy_(src, non_blocking=True)

    def _reap_oldest(self) -> None:
        """Block on the oldest chunk in flight and deliver its tokens; feed
        the per-chunk latency EWMA (dispatch to delivery over the chunks a
        row entered) that the deadline clamp reads."""
        c = self._inflight.popleft()
        t0 = time.perf_counter()
        done, n_exec, delivered = self._emit_chunk(c)
        t1 = time.perf_counter()
        obs.DECODE_CHUNK.observe(t1 - t0)
        # Device time by family: on the card the replay's CUDA events (both
        # complete: the reap waited on an event recorded after them), on
        # the CPU issue to the first stamp the outputs were seen landed.
        t_ready = c.t_ready if c.t_ready is not None else t1
        device_s = (c.timing[0].elapsed_time(c.timing[1]) / 1e3 if c.timing is not None
                    else t_ready - c.t_issue)
        self._observe_device_time(c.family, device_s)
        FLIGHT.record("reap", engine=self._tag, loop="decode", seq=c.seq, family=c.family,
                      depth=c.depth, t_issue=round(c.t_issue, 6), t_ready=round(t_ready, 6),
                      device_s=round(device_s, 6), chunks=n_exec, spec=c.spec_turn,
                      rids=[r.rid for _, r in c.active])
        obs.PIPELINE_DEPTH.set(len(self._inflight))
        # Per executed chunk or verify turn: the deadline clamp estimates a
        # fused dispatch's length from the same EWMA either way.
        per_chunk = (time.perf_counter() - c.t0) / max(1, n_exec)
        self._chunk_ewma_s = (per_chunk if self._chunk_ewma_s == 0.0 else
                              (1 - CHUNK_EWMA_ALPHA) * self._chunk_ewma_s
                              + CHUNK_EWMA_ALPHA * per_chunk)
        for _, req in c.carries():
            req.n_inflight = max(0, req.n_inflight - 1)
        if c.spec_turn:
            self.n_spec_turns += n_exec
            self.n_spec_drafted += c.drafted * n_exec
            obs.SPEC_TURNS.inc(n_exec)
            obs.SPEC_DRAFT_TOKENS.inc(c.drafted * n_exec)
            for i, req in c.active:
                got, segs = delivered.get(i, (0, 0))
                if req.spec_state is not None and (segs < c.n_chunks
                                                   or got < segs * c.n_steps):
                    # A rejection breaks the full-accept assumption every
                    # pipelined draft was formed under.
                    req.spec_state = None
                if self._slots[i] is req or i in done:
                    self._turn_span(req, "spec-verify", t0, t1, drafted=c.n_steps - 1,
                                    accepted=max(0, got - max(1, segs)),
                                    occupancy=len(c.active), depth=c.depth,
                                    inflight=round(t0 - c.t_issue, 6))
        else:
            self.n_loop_chunks += n_exec
            obs.DECODE_LOOP_CHUNKS.observe(n_exec)
            meta = {"chunks": c.n_chunks} if c.n_chunks > 1 else {}
            for i, req in c.active:
                if self._slots[i] is req or i in done:
                    self._turn_span(req, "decode", t0, t1, steps=c.n_steps,
                                    occupancy=len(c.active), depth=c.depth,
                                    inflight=round(t0 - c.t_issue, 6), **meta)
        if c.event is not None:  # the buffers may be reused only now
            for buf in (c.host, c.lp):
                if buf is not None:
                    self._host_pool[(tuple(buf.shape), buf.dtype)].append(buf)
        if done:
            with self._cond:
                for i, req in c.active:
                    if i in done and self._slots[i] is req:
                        self._release_slot(i, req)

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._reap_oldest()

    def _emit_chunk(self, c: _InflightChunk) -> tuple[set[int], int, dict]:
        """Deliver one dispatch's tokens, its chunks (or verify turns) in
        order: row i's on-device valid count in each bounds its delivery
        there (a row that finished in chunk 0 produced nothing in chunk 1).
        Tokens for a row released (or re-admitted) while the dispatch was in
        flight, or past a host-side finish in an earlier chunk or step,
        count as overrun. A verify turn's tokens beyond the row's first are
        its accepted drafts. Returns the rows that finished, the chunks or
        turns a live row entered, and per row (tokens delivered, chunks
        with a delivery)."""
        c.wait()
        host = c.host.tolist()
        self._raise_if_rank_lost()  # an abort ended the wait: the tokens are void
        lps = c.lp.tolist() if c.lp is not None else None
        n_top = min(TOP_LOGPROBS, self.spec.vocab_size)
        t_fetch = time.perf_counter()
        if c.constrained:  # the masked counts ride the token copy: no extra sync
            n_masked = sum(row[c.n_steps + 1] for seg in host for row in seg)
            self.n_constrain_masked += n_masked
            if n_masked:
                obs.CONSTRAIN_MASKED_TOKENS.inc(n_masked)
        done: set[int] = set()
        delivered: dict[int, tuple[int, int]] = {}
        n_exec = 0
        for ci, seg in enumerate(host):
            if not any(row[c.n_steps] for row in seg):
                continue  # no row entered this chunk (JAX's skipped chunk)
            n_exec += 1
            for (i, req), epoch in zip(c.active, c.epochs):
                k = seg[i][c.n_steps]
                if not k:
                    continue
                if (self._slots[i] is not req or i in done or req.deadline_answered
                        or req.n_preempts != epoch):
                    self.n_overrun += k
                    continue
                got = 0
                for j in range(k):
                    got += 1
                    lp = None
                    if lps is not None and req.want_lp >= 0:
                        rec = lps[ci][j][i]
                        lp = (rec[0], [int(t) for t in rec[1 + n_top:]], rec[1:1 + n_top])
                    if self._emit(req, seg[i][j], lp):
                        done.add(i)
                        break
                self.n_overrun += k - got
                d0, s0 = delivered.get(i, (0, 0))
                delivered[i] = (d0 + got, s0 + 1)
                if c.spec_turn:
                    acc = max(0, got - 1)
                    self.n_spec_accepted += acc
                    obs.SPEC_ACCEPTED_TOKENS.inc(acc)
                    obs.SPEC_ACCEPTANCE.observe(acc)
        self.drain_gap_s += time.perf_counter() - t_fetch
        return done, n_exec, delivered

    def _emit(self, req: _Request, tok: int, lp=None) -> bool:
        """Deliver one token (its logprob record ``lp`` first, when there
        is one); returns True when the request just finished.

        The replay guard: while ``req.replay`` holds ids, the token is one
        the consumer already has. It is compared with the delivered id and
        swallowed — history, the 2-gram index and the DFA shadow advance as
        on first delivery, but nothing is queued or counted as a new token.
        A mismatch ends the stream with :class:`ReplayDivergence`."""
        if req.cancel.is_set():
            self.n_cancelled += 1
            req.out.put(("end", None))
            return True
        replaying = req.replay is not None
        if replaying:
            expect = req.replay.pop(0)
            if not req.replay:
                req.replay = None
            if tok != expect:
                req.replay = None
                req.out.put(("err", ReplayDivergence(req.emitted, tok, expect)))
                req.cancel.set()
                return True
        elif lp is not None:
            req.lp.append(lp)
        req.emitted += 1
        hist = req.hist
        hist.append(tok)
        if len(hist) >= 3:  # the lagged 2-gram index (see _Request)
            req.ngram[(hist[-3], hist[-2])] = len(hist) - 2
        if req.grammar is not None and req.dfa_host >= 0 and tok != req.eos_id:
            # The host's shadow of the LOCAL DFA state, for the draft
            # filter; a dead transition means it lost sync: unknown.
            req.dfa_host = int(req.grammar.trans[req.dfa_host, tok])
        if replaying:
            # Delivered before: swallowed. A journal never holds an EOS (it
            # ended the stream then), but it may cover the whole budget.
            self.n_replayed_tokens += 1
            if req.emitted >= req.budget:
                req.out.put(("end", "length"))
                return True
            return False
        self.n_tokens += 1
        self.n_member_tokens[req.member] += 1
        req.out.put(("tok", tok))
        if req.eos_id is not None and tok == req.eos_id:
            req.out.put(("end", "stop"))
            return True
        if req.emitted >= req.budget:
            req.out.put(("end", "length"))
            return True
        return False

    def _fail_all(self, exc: Exception) -> None:
        """A scheduler turn failed: fail the requests whose rows were active
        or admitting and forget what every row held; pending requests stay
        queued. Staged pieces are dropped; the staging cache itself stays
        (the zero-drain section gives the rule)."""
        with self._cond:
            doomed = ([r for r in self._slots if r is not None]
                      + [a.req for a in self._admitting])
            for a in self._admitting:
                a.dead = True  # their staged pieces are dropped
            if self._zero_drain_mesh and self._handoffs and not self._ranks_lost():
                try:
                    self._plan("drop_pieces", None)
                except Exception:
                    logger.exception("dropping the workers' staged pieces failed")
            self._handoffs.clear()
            self._slots = [None] * self._rows
            self._admitting.clear()
            self._claimed.clear()
            self._inflight.clear()
            self._resident = [[] for _ in range(self._rows)]
            self._snap_backlog -= len(self._pending_snaps)
            self._pending_snaps = []
            if self.kv_pages:
                # No row survives: every chain and claim goes, the table
                # points at the sinks again at the next upload.
                self._page_alloc.reset()
                self._table_host.zero_()
                self._page_claims = [0] * self.n_slots
                self._table_dirty = True
            self.n_rebuilds += 1
            self._cond.notify_all()
        obs.PIPELINE_DEPTH.set(0)
        # The post-mortem artifact: the ring holds the timeline that led
        # here. Then the breaker: a retry storm of a poison pill opens it.
        FLIGHT.record("fail-all", engine=self._tag, loop="decode",
                      error=f"{type(exc).__name__}: {exc}"[:200], doomed=len(doomed),
                      rids=[r.rid for r in doomed])
        FLIGHT.dump("fail-all")
        if not self._ranks_lost():  # a lost rank tripped it for good
            self._record_breaker_failure()
        for r in doomed:
            self.n_failures += 1
            if r.trace is not None:
                now = time.perf_counter()
                r.trace.add_span_abs("engine-failure", now, now, error=type(exc).__name__,
                                     contained=False)
            r.out.put(("err", exc))


def _constrained_key(key: tuple) -> bool:
    """A graph key of a constrained program variant (it reads the grammar
    arena's tables)."""
    return any(k in ("dfa", "dfa_verify") for k in key if isinstance(k, str))


def _spec_family(key: tuple) -> str:
    """The warm-up family of a speculative dispatch's key (its program)."""
    return key[1] if key[0] == "paged" else key[0]


def program_family(key: tuple) -> str:
    """The JAX engine's program-family name of a dispatch key, the label of
    its device time: ``plain`` / ``loop`` (one chunk or more),
    ``dfa`` / ``loop_dfa`` (the grammar variant), ``verify``,
    ``dfa_verify``, ``spec_loop`` / ``spec_loop_dfa`` (fused draft→verify),
    each with a ``paged_`` prefix on a paged engine, and ``pp_`` on a
    pipeline-staged one (``pp_plain``, ``pp_loop``)."""
    if key[0] == "pp":
        return "pp_" + program_family(key[1:])
    if key[0] == "paged":
        return "paged_" + program_family(key[1:-1] if key[1] not in ("verify", "dfa_verify")
                                         else key[1:])
    if key[0] in ("verify", "dfa_verify"):
        return key[0]
    if key[0] == "spec_loop":
        return "spec_loop_dfa" if "dfa" in key[1:] else "spec_loop"
    constrained = key[0] == "dfa"
    n_chunks = key[2] if constrained else key[1]
    return ("loop_dfa" if constrained else "loop") if n_chunks > 1 else (
        "dfa" if constrained else "plain")


def check_quant_knobs(quant: str | None, kv_quant: str | None) -> tuple[str | None, str | None]:
    """The JAX engine's checks of ``quant`` and ``kv_quant``, word for word;
    each knob as the engine keeps it (None when off)."""
    quant = check_quant(quant)
    if kv_quant not in (None, "", "int8"):
        raise ValueError(
            f"unsupported kv_quant mode {kv_quant!r} (int8 or none)")
    return quant, kv_quant or None


def _check_stack_knobs(members: int, ensemble: int, member_seeds: str,
                       quorum_dedup: bool, kv_quant: str | None = None,
                       staged: bool = False) -> None:
    """The JAX engine's rejections of the stacked knobs, word for word."""
    if members > 1 and ensemble > 1:
        raise ValueError(
            "members (stacked fan-out streams) and ensemble "
            "(consensus decoding) are mutually exclusive")
    if member_seeds not in ("distinct", "shared"):
        raise ValueError(
            f"unknown member_seeds {member_seeds!r} (distinct or shared)")
    if member_seeds == "shared" and ensemble > 1:
        raise ValueError(
            "member_seeds=shared does not compose with ensemble>1: all "
            f"{ensemble} consensus members would init identical "
            "weights, so the averaged logits ARE member 0's logits — "
            "consensus over M copies of one model is just the model")
    if quorum_dedup:
        if members <= 1:
            raise ValueError(
                "quorum_dedup=1 requires members>1: there is no second "
                "member to share the prefill with")
        if member_seeds != "shared":
            raise ValueError(
                "quorum_dedup=1 requires member_seeds=shared: with "
                "distinct seeds member m's cache row must hold "
                "K_m = f_{W_m}(prompt) — M different projections of one "
                "prompt, which broadcasting member 0's K_0 cannot "
                "produce; add member_seeds=shared (one weight set, M "
                "sampling streams) or drop quorum_dedup")
        if staged:
            raise ValueError(
                "quorum_dedup=1 does not compose with disagg/zero_drain: "
                "staged engines admit every prompt through the chunked "
                "segment path, and the dedup broadcast rides the "
                "member-coalesced single-shot program — drop one knob")
        if kv_quant:
            raise ValueError(
                "quorum_dedup=1 does not compose with kv_quant=int8: "
                "the broadcast scatters raw K/V; the quantized cache's "
                "(values, scales) pair would need a second quantizing "
                "scatter the program does not carry — drop one knob")


_ENGINES: dict[tuple, InferenceEngine] = {}
_ENGINES_LOCK = threading.Lock()


_NOT_ON_MESH = "not yet on a multi-rank engine"


def _params_on(params, device):
    """A params tree (quantized leaves are dicts) on ``device``: the same
    tensors where they already live there, else copies."""
    if params is None or isinstance(params, torch.Tensor):
        return None if params is None else params.to(device)
    return {k: _params_on(v, device) for k, v in params.items()}


def _check_disagg_knobs(eng: InferenceEngine, spec: ModelSpec, mesh, prefill_mesh, draft_spec,
                        prefill_chunk: int, zero_drain: bool) -> None:
    """A disaggregated engine's refusals, the JAX engine's, in its words
    and order, then what the port does not serve yet, by name. Two
    one-rank groups may share a device (the CPU, or one card through this
    API: SMs shared, a correctness set-up); groups of several ranks never
    do."""
    decode = ([str(d) for d in mesh.devices] if mesh is not None else [str(eng.device)])
    prefill = [str(d) for d in prefill_mesh.devices]
    overlap = set(decode) & set(prefill) - {"cpu"}
    if overlap and (len(decode) > 1 or len(prefill) > 1):
        raise ValueError(
            f"disagg device groups must be disjoint; {len(overlap)} "
            "device(s) appear in both the prefill and decode mesh")
    if draft_spec is not None:
        raise ValueError(
            "draft-model speculation (spec_model=/spec_ckpt=) does "
            "not compose with disagg: the draft runtime is not "
            "group-placed (prompt-lookup spec_decode composes)")
    if mesh is not None and mesh.shape[AXIS_SP] > 1:
        raise ValueError(
            "sp>1 in the decode group does not compose with "
            "disagg: sequence-parallel serving disables chunked "
            "prefill, which every disaggregated admission rides — "
            "under disagg, sp= shards the PREFILL group instead")
    if aligned_prefill_chunk(int(prefill_chunk), spec.max_seq) <= 0:
        raise ValueError(
            "disagg requires chunked prefill (prefill_chunk >= 16 "
            "after power-of-two alignment): admissions prefill "
            "into the prefill group's staging cache segment by "
            "segment and register on the decode group — the "
            "single-shot admit program samples its first token "
            "inside prefill, on the wrong device group")
    if zero_drain:
        raise ValueError(
            "zero_drain=1 does not compose with disagg=P+D: "
            "disaggregated admissions already run on their own "
            "device group with the ring at full depth — zero-drain "
            "is structural there (drop one knob)")
    for what, m, axis in (("prefill", prefill_mesh, AXIS_SP), ("decode", mesh, AXIS_PP),
                          ("prefill", prefill_mesh, AXIS_DP), ("decode", mesh, AXIS_DP),
                          ("prefill", prefill_mesh, AXIS_PP), ("decode", mesh, AXIS_SP)):
        if m is not None and m.shape[axis] > 1:
            raise ValueError(
                f"disagg with {axis}={m.shape[axis]} in the {what} group is not served by "
                "cuda:// engines yet: tp= cuts each group")


def check_pp_axes(mesh_shape: dict) -> None:
    """The JAX engine's refusal of tp or dp beside pp, in its words (the
    staged schedule runs tp=1/dp=1 within each stage)."""
    npp = mesh_shape.get(AXIS_PP, 1)
    if npp > 1 and (mesh_shape.get(AXIS_TP, 1) > 1 or mesh_shape.get(AXIS_DP, 1) > 1):
        raise ValueError(
            f"pipeline-staged decode runs tp=1/dp=1 within each "
            f"stage (pp={npp} with tp="
            f"{mesh_shape.get(AXIS_TP, 1)}, dp="
            f"{mesh_shape.get(AXIS_DP, 1)} on the decode mesh): "
            "make pp the whole group, or drop one knob")


def _check_pp_knobs(eng: InferenceEngine, spec: ModelSpec, mesh, spec_decode: int,
                    draft_spec, n_slots: int) -> None:
    """A pipeline-staged engine's refusals (pp > 1), the JAX engine's, word
    for word."""
    npp = eng.decode_pp
    if eng.zero_drain:
        raise ValueError(
            "pp>1 does not compose with zero_drain=1: staged-"
            "injection admissions write one stage's KV shard from "
            "outside the stage ring — use disagg=P+D&pp=K (the "
            "handoff feeds stage-sharded rows) or drop one knob")
    if eng._use_sp:
        raise ValueError(
            "pp>1 does not compose with sp>1 on the decode mesh: "
            "the staged row-group schedule owns the non-tp axes — "
            "under disagg, sp= shards the PREFILL group instead")
    check_pp_axes(dict(mesh.shape))
    if eng.members > 1 or eng.ensemble > 1:
        raise ValueError(
            "pp>1 does not compose with members/ensemble engines: "
            "the staged decode program is not member-vmapped — run "
            "separate cells or drop one knob")
    if int(spec_decode) > 0 or draft_spec is not None:
        raise ValueError(
            "pp>1 does not compose with spec_decode/spec_model: "
            "verify turns run the full layer stack in one program, "
            "which is exactly what a staged decode group cannot "
            "hold — drop one knob")
    if spec.n_layers % npp:
        raise ValueError(
            f"pp={npp} does not divide n_layers="
            f"{spec.n_layers}: stages hold equal contiguous "
            "layer shards — pick a dividing pp or pad the model")
    if max(1, int(n_slots)) % npp:
        raise ValueError(
            f"pp={npp} does not divide slots={max(1, int(n_slots))}: the "
            "slot batch splits into pp row groups (the pipeline's "
            "microbatches) — pick slots as a multiple of pp")


def _check_mesh_knobs(eng: InferenceEngine, spec: ModelSpec, mesh, sp_impl: str,
                      spec_decode: int, draft_spec, kv_pages: bool, prefix_store,
                      n_slots: int) -> None:
    """A mesh engine's refusals: the JAX engine's pipeline and sequence-
    parallel ones in its words, then what the port's mesh path does not
    carry yet (``prefix_store`` on pp), by name. Every tp serves (a dim tp
    does not divide is whole on every rank, ``parallel/sharding``)."""
    if eng.decode_pp > 1:
        _check_pp_knobs(eng, spec, mesh, spec_decode, draft_spec, n_slots)
        if kv_pages:
            raise ValueError(
                "kv_pages=1 does not compose with pp>1: the staged "
                "decode schedule shards the cache's layer axis across "
                "stages, and the page pool's layer axis would need a "
                "per-stage page table — drop one knob")
    if eng._use_sp:
        if sp_impl == "ulysses" and not ulysses_supported(spec.n_heads, spec.n_kv_heads, mesh):
            raise ValueError(
                f"sp_impl=ulysses needs the per-device head counts "
                f"to split over sp "
                f"(heads={spec.n_heads}, "
                f"kv_heads={spec.n_kv_heads}, mesh "
                f"{dict(mesh.shape)}) — a silent dense "
                "fallback would replicate full attention at "
                "exactly the lengths sp exists for")
        if spec.sliding_window > 0 and sp_impl == "ring":
            raise ValueError(
                "sliding_window specs (mistral) do not compose with "
                "ring-attention sp>1 (full causal attention would "
                "silently widen the receptive field); use "
                "sp_impl=ulysses, whose full-sequence local attention "
                "applies windows unchanged")
        if eng.ensemble > 1:
            raise ValueError(
                "ensemble decoding does not compose with sp>1 "
                "(ring attention inside the member vmap)")
        if eng.members > 1:
            raise ValueError(
                "members does not compose with sp>1 "
                "(ring attention inside the member vmap)")
        if kv_pages:
            raise ValueError(
                "kv_pages=1 does not compose with sp>1: ring attention "
                "shards the position axis, which the page-table "
                "indirection scatters — drop one knob")
        if prefix_store:
            raise ValueError(
                "prefix_store does not compose with sp>1: sequence-"
                "parallel serving disables chunked prefill, which the "
                "restore path's nonzero-offset tail prefill rides")
        if eng.zero_drain:
            # The JAX engine turns chunked prefill off under sp before its
            # zero-drain check, which then refuses in these words.
            raise ValueError(
                "zero_drain requires chunked prefill (prefill_chunk >= "
                "16 after power-of-two alignment): admissions prefill "
                "into the staging cache segment by segment and inject "
                "at a reap boundary — the single-shot admit program "
                "blocks the host on its first-token fetch, which "
                "behind a full dispatch ring is exactly the stall "
                "zero_drain exists to remove")
    if eng.decode_pp > 1 and prefix_store:
        # The JAX engine serves it there, chunking its pp admissions; the
        # port's pipeline-staged engine admits single-shot.
        raise ValueError(f"prefix_store: {_NOT_ON_MESH} with pp>1 (dp and tp serve it)")


def get_engine(
    spec: ModelSpec,
    *,
    device=None,
    seed: int = 0,
    n_slots: int = DEFAULT_SLOTS,
    decode_chunk: int = DEFAULT_DECODE_CHUNK,
    decode_pipeline: int = DEFAULT_DECODE_PIPELINE,
    decode_loop: int = DEFAULT_DECODE_LOOP,
    prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
    prefix_cache: bool = True,
    max_pending: int = DEFAULT_MAX_PENDING,
    members: int = 1,
    member_seeds: str = "distinct",
    quorum_dedup: bool = False,
    ensemble: int = 1,
    quant: str | None = None,
    kv_quant: str | None = None,
    spec_decode: int = 0,
    draft_spec: ModelSpec | None = None,
    draft_seed: int = 0,
    draft_ckpt: str | None = None,
    kv_pages: bool = False,
    kv_page_size: int = 0,
    kv_pool_pages: int = 0,
    prefix_store: str | None = None,
    prefix_store_bytes: int = DEFAULT_PREFIX_STORE_BYTES,
    prefix_store_chunk: int = 0,
    qos: bool = False,
    zero_drain: bool = False,
    mesh=None,
    sp_impl: str = "ring",
    prefill_mesh=None,
) -> InferenceEngine:
    """Engines are keyed by weight identity (spec, seed, device or mesh, members,
    ensemble, member_seeds when members > 1, quant), by the cache
    representation (``kv_quant``), by ``quorum_dedup`` and by speculation
    (``spec_decode`` and the draft: its spec and seed, or its checkpoint's
    real path) and the page layout (``kv_pages`` with its page size and
    pool, as the JAX engine keys it), which are structural: backends that
    differ only in dispatch knobs share one set of weights, so ``members=M&member=i`` backends
    share one engine and a dedup URL never shares a non-dedup engine.
    ``draft_ckpt`` loads a local HF checkpoint as the draft model, its
    window raised to the target's (:func:`_load_draft_ckpt`). ``n_slots``,
    ``max_pending``, ``decode_pipeline``, ``decode_loop`` and
    ``prefill_chunk`` apply at first construction, as do the ``prefix_store``
    knobs (as on ``tpu://``). ``prefix_cache`` is not structural: a ``prefix_cache=0``
    from ANY backend turns reuse off on the shared engine (an explicit
    opt-out wins over a sharing default). ``zero_drain`` is structural (the
    staging cache and the staged routing exist from construction), so it
    is part of the key. ``qos`` is not: it is host policy only, and an
    explicit ``qos=True`` from any backend turns it on for the shared
    engine (an opt-in wins). ``device`` defaults to cuda and raises when
    there is none; a ``mesh`` (``parallel/mesh.Mesh``) puts rank 0 on its
    first device and is part of the key, as is ``sp_impl`` when sp > 1
    (inert otherwise, as the JAX engine keys it). ``prefill_mesh`` (disagg)
    is structural too: the prefill group carries a second weight copy and
    the staging cache, so colocated and disaggregated engines never share."""
    import os

    if draft_ckpt and draft_spec is not None:
        raise ValueError("draft_spec and draft_ckpt are mutually exclusive")
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    members, ensemble = max(1, int(members)), max(1, int(ensemble))
    draft_ckpt = os.path.realpath(draft_ckpt) if draft_ckpt else None
    sp_key = sp_impl if mesh is not None and mesh.shape[AXIS_SP] > 1 else None
    key = (spec, int(seed), str(dev), mesh, sp_key, members, ensemble,
           member_seeds if members > 1 else None, bool(quorum_dedup), quant or None,
           kv_quant or None, int(spec_decode), draft_spec,
           int(draft_seed) if draft_spec is not None else None, draft_ckpt,
           (True, int(kv_page_size), int(kv_pool_pages)) if kv_pages else None,
           bool(zero_drain),
           tuple(map(str, prefill_mesh.devices)) if prefill_mesh is not None else None)
    with _ENGINES_LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            draft_params = None
            if draft_ckpt:
                draft_spec, draft_params = _load_draft_ckpt(draft_ckpt, spec.max_seq, dev)
            eng = _ENGINES[key] = InferenceEngine(
                spec, device=dev, seed=seed, n_slots=n_slots, decode_chunk=decode_chunk,
                decode_pipeline=decode_pipeline, decode_loop=decode_loop,
                prefill_chunk=prefill_chunk,
                prefix_cache=prefix_cache, max_pending=max_pending, members=members,
                member_seeds=member_seeds, quorum_dedup=quorum_dedup, ensemble=ensemble,
                quant=quant, kv_quant=kv_quant, spec_decode=spec_decode,
                draft_spec=draft_spec, draft_seed=draft_seed, draft_params=draft_params,
                kv_pages=kv_pages, kv_page_size=kv_page_size, kv_pool_pages=kv_pool_pages,
                prefix_store=prefix_store, prefix_store_bytes=prefix_store_bytes,
                prefix_store_chunk=prefix_store_chunk, qos=qos, zero_drain=zero_drain,
                mesh=mesh, sp_impl=sp_impl, prefill_mesh=prefill_mesh)
        else:
            eng.prefix_cache = eng.prefix_cache and bool(prefix_cache)
            eng.qos = eng.qos or bool(qos)
        return eng


def _load_draft_ckpt(draft_ckpt: str, target_max_seq: int, device, dtype: str | None = None):
    """(spec, params) of a draft checkpoint, window-matched to the target:
    the draft cache must hold every position the target can reach, so its
    ``max_seq`` is raised to the target's (RoPE tables extend; positions
    past the draft's trained range can only lower acceptance — drafts are
    speed only). The engine's draft runtime checks the vocabularies."""
    import dataclasses

    from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint

    dspec, dparams = load_hf_checkpoint(draft_ckpt, dtype=dtype, device=device)
    if dspec.max_seq < target_max_seq:
        dspec = dataclasses.replace(dspec, max_seq=target_max_seq)
    return dspec, dparams


CKPT_ENSEMBLE_ERROR = ("ensemble members are seeded random inits; a "
                       "checkpoint provides only one weight set")
CKPT_MEMBERS_ERROR = ("stacked members are seeded random inits; a "
                      "checkpoint provides only one weight set")


def get_engine_from_ckpt(
    ckpt_path: str,
    *,
    dtype: str | None = None,
    device=None,
    n_slots: int = DEFAULT_SLOTS,
    decode_chunk: int = DEFAULT_DECODE_CHUNK,
    decode_pipeline: int = DEFAULT_DECODE_PIPELINE,
    decode_loop: int = DEFAULT_DECODE_LOOP,
    prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
    prefix_cache: bool = True,
    max_pending: int = DEFAULT_MAX_PENDING,
    ensemble: int = 1,
    quant: str | None = None,
    kv_quant: str | None = None,
    spec_decode: int = 0,
    draft_spec: ModelSpec | None = None,
    draft_seed: int = 0,
    draft_ckpt: str | None = None,
    kv_pages: bool = False,
    kv_page_size: int = 0,
    kv_pool_pages: int = 0,
    prefix_store: str | None = None,
    prefix_store_bytes: int = DEFAULT_PREFIX_STORE_BYTES,
    prefix_store_chunk: int = 0,
    qos: bool = False,
    zero_drain: bool = False,
    mesh=None,
    sp_impl: str = "ring",
    prefill_mesh=None,
) -> InferenceEngine:
    """An engine over a local HF checkpoint directory
    (``models/hf_loader.py``). Keyed by (real path, effective dtype,
    device or mesh, quant, kv_quant, spec_decode, the draft: its spec and
    seed or its checkpoint's real path, which follows the target's
    ``dtype``; ``sp_impl`` when sp > 1). On a ``mesh`` every rank reads
    only its own cut of the checkpoint from the mapped files, rank 0 too:
    nothing is loaded whole or shipped to the workers, which open the
    checkpoint themselves;
    ``quant="int8"`` quantizes on the device as
    the checkpoint is read, never holding its bf16 form whole. Backends
    pointing at one checkpoint share its weights on the card, and
    ``dtype=None`` hits the entry of the default dtype, so a checkpoint is
    never loaded twice. The dispatch knobs apply at first
    construction, ``prefix_cache``, ``qos`` and ``zero_drain`` (keyed) as
    in :func:`get_engine`. ``ensemble`` >
    1 is refused before the checkpoint is read (its members are seeded
    random inits; a checkpoint holds one weight set)."""
    import os

    from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint

    if ensemble > 1:
        raise ValueError(CKPT_ENSEMBLE_ERROR)
    quant, kv_quant = check_quant_knobs(quant, kv_quant)
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    if draft_ckpt and draft_spec is not None:
        raise ValueError("draft_spec and draft_ckpt are mutually exclusive")
    resolved = os.path.realpath(ckpt_path)
    draft_resolved = os.path.realpath(draft_ckpt) if draft_ckpt else None
    eff_dtype = dtype or ModelSpec().dtype
    sp_key = sp_impl if mesh is not None and mesh.shape[AXIS_SP] > 1 else None
    key = ("ckpt", resolved, eff_dtype, str(dev), mesh, sp_key, quant, kv_quant,
           int(spec_decode), draft_spec, int(draft_seed) if draft_spec is not None else None,
           draft_resolved, (True, int(kv_page_size), int(kv_pool_pages)) if kv_pages else None,
           bool(zero_drain),
           tuple(map(str, prefill_mesh.devices)) if prefill_mesh is not None else None)
    with _ENGINES_LOCK:
        eng = _ENGINES.get(key)
        if eng is None and mesh is not None:
            from quorum_tpu_torch.models.hf_loader import checkpoint_spec

            eng = _ENGINES[key] = InferenceEngine(
                checkpoint_spec(resolved, eff_dtype), mesh=mesh, sp_impl=sp_impl,
                ckpt=(resolved, eff_dtype), n_slots=n_slots, decode_chunk=decode_chunk,
                decode_pipeline=decode_pipeline, decode_loop=decode_loop,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                max_pending=max_pending, quant=quant, kv_quant=kv_quant,
                spec_decode=spec_decode, draft_spec=draft_spec, draft_seed=draft_seed,
                kv_pages=kv_pages, prefix_store=prefix_store, qos=qos, zero_drain=zero_drain,
                prefill_mesh=prefill_mesh)
        elif eng is None:
            spec, params = load_hf_checkpoint(resolved, dtype=eff_dtype, device=dev,
                                              quant=quant)
            draft_params = None
            if draft_resolved:
                # The draft follows the target's dtype: a mixed pair rounds
                # differently and lowers acceptance for nothing.
                draft_spec, draft_params = _load_draft_ckpt(draft_resolved, spec.max_seq,
                                                            dev, dtype=eff_dtype)
            eng = _ENGINES[key] = InferenceEngine(
                spec, device=dev, params=params, n_slots=n_slots, decode_chunk=decode_chunk,
                decode_pipeline=decode_pipeline, decode_loop=decode_loop,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                max_pending=max_pending, quant=quant, kv_quant=kv_quant,
                spec_decode=spec_decode, draft_spec=draft_spec, draft_seed=draft_seed,
                draft_params=draft_params, kv_pages=kv_pages, kv_page_size=kv_page_size,
                kv_pool_pages=kv_pool_pages, prefix_store=prefix_store,
                prefix_store_bytes=prefix_store_bytes, prefix_store_chunk=prefix_store_chunk,
                qos=qos, zero_drain=zero_drain, prefill_mesh=prefill_mesh)
        else:
            eng.prefix_cache = eng.prefix_cache and bool(prefix_cache)
            eng.qos = eng.qos or bool(qos)
        return eng


def release_engine(engine: InferenceEngine, timeout: float = 30.0) -> None:
    """Shut ONE engine down and evict it from the shared cache (hot reload
    of a dropped backend): without the eviction, the cache's reference keeps
    its weights, KV cache and graphs on the card."""
    with _ENGINES_LOCK:
        for key, eng in list(_ENGINES.items()):
            if eng is engine:
                del _ENGINES[key]
    engine.shutdown(timeout=timeout)


def shutdown_all_engines(timeout: float = 30.0) -> None:
    with _ENGINES_LOCK:
        engines = list(_ENGINES.values())
        _ENGINES.clear()
    for eng in engines:
        eng.shutdown(timeout=timeout)
