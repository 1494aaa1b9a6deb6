"""Continuous-batching inference engine on torch tensors: the core of the JAX
package's ``InferenceEngine``, with the same public names.

One engine holds one model's weights and a slot-batched KV cache
``[L, n_slots, K, max_seq, hd]`` on one device. All device work happens on
the engine's scheduler thread; callers talk to it through thread-safe
queues, so any number of threads can stream concurrently. Each scheduler
turn:

  1. **admits** pending requests into free slots, single-shot: the whole
     prompt (right-padded to a power-of-two bucket) is prefilled into the
     slot's cache row through kernel K1 and the first token is sampled in
     the same turn — the ``_admit_fn`` semantics of the JAX engine,
     including its finish rule (the row stays live unless that first token
     was EOS or exhausted the budget);
  2. runs one **decode chunk** over all slots (``decode_chunk`` steps,
     attention through kernel K2) with on-device finish accounting, then
     reads the chunk's tokens and per-row valid counts back in ONE host
     read and delivers them.

Sampling noise comes from one ``torch.Generator`` per request, on the
device, seeded with the request's seed: a request's tokens are a pure
function of (weights, prompt, sampler, seed), whatever it is co-batched
with. The JAX engine's decode ring (``decode_pipeline`` > 1), chunked
prefill, prefix reuse, penalties, grammars and logprobs are not ported yet;
tokens do not depend on the ring depth.

Stacked engines (the JAX engine's ``members`` / ``ensemble`` knobs) hold M
weight sets in one member-stacked tree (``models/init.py``) and a cache of
M·S rows, row ``m·S + s`` being member m's slot s:

- ``members=M``: M independent streams, ``submit(member=i)``. Host slots
  are flat (M·S entries); each decode chunk advances every member's rows in
  one batched forward. Admission is single-shot and member-coalesced: the
  FIFO head of each member's queue is a candidate, the heads sharing the
  anchor's prompt bucket form a group that prefills in ONE dispatch into a
  slot index free for all of them (K1 once per layer with one row per
  member; absent members' rows are not written), falling back to the anchor
  alone. A lone member prefills through its own weight views. Member i's
  stream is a function of (member i's weights, prompt, sampler, seed),
  whatever the other members do. ``member_seeds=distinct`` seeds member i
  with seed+i, ``shared`` gives every member the same weights.
- ``quorum_dedup=1`` (members, shared seeds): a full group carrying one
  prompt prefills it once on member 0's weights and copies the K/V into
  every member's row; sampling stays per member.
- ``ensemble=M``: one stream per slot; every model call runs the M weight
  sets and averages their logits in f32 before sampling.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.init import init_params, init_params_stacked
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.transformer import decode_chunk, init_cache, member_params, prefill
from quorum_tpu_torch.ops.sampling import SamplerConfig, gumbel_noise, sample_token_rows

logger = logging.getLogger(__name__)

MIN_BUCKET = 16
DEFAULT_SLOTS = 4
DEFAULT_MAX_PENDING = 128
DEFAULT_DECODE_CHUNK = 8


class QueueFullError(Exception):
    """The admission queue is at capacity (callers map it to a 503)."""


def prefill_bucket(n: int, max_seq: int) -> int:
    """Smallest power-of-two ≥ n, clamped to [MIN_BUCKET, max_seq]."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, max_seq)


@dataclass
class GenerationResult:
    token_ids: list[int] = field(default_factory=list)
    finish_reason: str = "length"  # "stop" when EOS was hit

    @property
    def completion_tokens(self) -> int:
        return len(self.token_ids)


class _Request:
    """One queued/active generation; tokens flow to the consumer via ``out``
    as ``("tok", id)``, then one ``("end", reason)`` or ``("err", exc)``."""

    __slots__ = ("prompt_ids", "budget", "sampler", "seed", "eos_id", "cancel",
                 "chunk_hint", "out", "emitted", "generator", "member")

    def __init__(self, prompt_ids, budget, sampler: SamplerConfig, seed, eos_id, cancel,
                 chunk_hint, member=0):
        self.member = member
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


class InferenceEngine:
    """One loaded model on one device, serving many requests concurrently."""

    def __init__(
        self,
        spec: ModelSpec,
        *,
        device=None,
        seed: int = 0,
        decode_chunk: int = DEFAULT_DECODE_CHUNK,
        params=None,
        n_slots: int = DEFAULT_SLOTS,
        max_pending: int = DEFAULT_MAX_PENDING,
        members: int = 1,
        member_seeds: str = "distinct",
        quorum_dedup: bool = False,
        ensemble: int = 1,
    ):
        self.spec = spec.validate()
        self.device = resolve_device(device)
        self.members = max(1, int(members))
        self.ensemble = max(1, int(ensemble))
        _check_stack_knobs(self.members, self.ensemble, member_seeds, quorum_dedup)
        self.member_seeds = member_seeds
        self.quorum_dedup = bool(quorum_dedup)
        stack = max(self.members, self.ensemble)
        if params is None:
            if stack > 1:
                seeds = ([seed] * stack if member_seeds == "shared"
                         else [seed + i for i in range(stack)])
                params = init_params_stacked(spec, seeds, self.device)
            else:
                params = init_params(spec, seed, self.device)
        elif (params["tok_emb"].dim() == 3) != (stack > 1) or (
                stack > 1 and params["tok_emb"].shape[0] != stack):
            raise ValueError(f"params must be a {stack}-member stacked tree"
                             if stack > 1 else "params must be a single-model tree")
        self.params = params
        self.decode_chunk = max(1, int(decode_chunk))
        self.n_slots = max(1, int(n_slots))
        # A stacked engine absorbs the whole fan-out's admissions in one
        # queue: M members carry the capacity M separate engines would have.
        self.max_pending = max(1, int(max_pending)) * self.members
        # Host slot space is flat across members: row m·S + s is member m's
        # slot s (S rows when members == 1). The cache holds one row per
        # slot per weight set.
        self._rows = self.members * self.n_slots
        self._ck, self._cv = init_cache(spec, stack * self.n_slots, device=self.device)
        # Per-row decode state, device-resident between chunks.
        s, dev = self._rows, self.device
        self._token = torch.zeros((s,), dtype=torch.long, device=dev)
        self._lengths = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._live = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._budget = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._eos = torch.full((s,), -1, dtype=torch.int32, device=dev)
        self._temp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._topp = torch.ones((s,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._noise = torch.zeros((s, spec.vocab_size), dtype=torch.float32, device=dev)

        self._slots: list[_Request | None] = [None] * s
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
        self.n_admission_dispatches = 0  # prefills; a coalesced member group is one
        # Prefill tokens the dedup route did not recompute, and its admissions.
        self.quorum_dedup_tokens = 0
        self.quorum_dedup_prefills = 0
        self.n_decode_chunks = 0
        self.n_decode_steps = 0
        self.n_decode_rows = 0
        self.n_overrun = 0
        self._thread = threading.Thread(target=self._scheduler, daemon=True,
                                        name="quorum-torch-scheduler")
        self._thread.start()

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
    ) -> _Request | None:
        """Enqueue a generation for weight set ``member`` and return its
        handle (``None`` when there is nothing to generate). Raises
        :class:`QueueFullError` synchronously when the admission queue is at
        capacity."""
        if not 0 <= member < self.members:
            raise ValueError(
                f"member {member} out of range for a {self.members}-member engine")
        spec = self.spec
        # Keep the most recent context if the prompt exceeds the window,
        # reserving at least one position to generate into.
        prompt = list(prompt_ids)[-(spec.max_seq - 1):] or [0]
        budget = min(int(max_new_tokens), spec.max_seq - len(prompt))
        if budget <= 0 or (cancel is not None and cancel.is_set()):
            return None
        req = _Request(prompt, budget, sampler or SamplerConfig(), int(seed), eos_id,
                       cancel if cancel is not None else threading.Event(), decode_chunk,
                       member)
        with self._cond:
            if self._stop:
                raise RuntimeError("engine has been shut down")
            if len(self._pending) >= self.max_pending:
                raise QueueFullError(f"admission queue full ({self.max_pending} pending)")
            self._pending.append(req)
            self.n_requests += 1
            self._cond.notify_all()
        return req

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
                        decode_chunk: int | None = None, member: int = 0) -> Iterator[int]:
        """Yield generated token ids as they are produced (the EOS token, when
        hit, is the last id yielded)."""
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens, sampler=sampler,
                          seed=seed, eos_id=eos_id, cancel=cancel, decode_chunk=decode_chunk,
                          member=member)
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
        """Scheduler/capacity counters."""
        with self._cond:
            return {
                "slots": self._rows,
                "members": self.members,
                "busy_slots": sum(1 for r in self._slots if r is not None),
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
                "quorum_dedup_tokens_total": self.quorum_dedup_tokens,
                "quorum_dedup_prefills_total": self.quorum_dedup_prefills,
                "decode_chunks_total": self.n_decode_chunks,
                "decode_steps_total": self.n_decode_steps,
                "decode_busy_rows_total": self.n_decode_rows,
                "overrun_tokens_total": self.n_overrun,
            }

    def health(self) -> dict:
        """Liveness signals for /health: every field is an observation."""
        with self._cond:
            pending, stopped = len(self._pending), self._stop
        return {
            "scheduler_alive": self._thread.is_alive() and not stopped,
            "pending": pending,
            "queue_limit": self.max_pending,
            "rebuilds_total": self.n_rebuilds,
        }

    def shutdown(self, timeout: float = 30.0) -> None:
        """Cancel pending/active requests, join the scheduler thread, and drop
        the weights and cache so a shut-down engine holds no device memory."""
        with self._cond:
            self._stop = True
            for r in list(self._slots) + list(self._pending):
                if r is not None:
                    r.cancel.set()
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            return  # a device call is still running; the GC reclaims state later
        self.params = None
        self._ck = self._cv = None

    # ---- scheduler --------------------------------------------------------

    def _scheduler(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._schedule_forever()
        except BaseException as e:
            # The thread is going away: no request may wait on it forever.
            logger.exception("engine scheduler thread died")
            with self._cond:
                self._stop = True
                doomed = [r for r in self._slots if r is not None] + list(self._pending)
                self._slots = [None] * self._rows
                self._pending.clear()
            for r in doomed:
                r.out.put(("err", RuntimeError(f"engine scheduler died: {e!r}")))
            raise

    def _schedule_forever(self) -> None:
        while True:
            with self._cond:
                while not (self._stop or self._pending or any(self._slots)):
                    self._cond.wait()
                if self._stop and not (self._pending or any(self._slots)):
                    return
            try:
                with torch.no_grad():
                    self._start_admissions()
                    if any(self._slots):
                        self._run_chunk()
            except Exception as e:  # keep serving: fail only the entangled requests
                logger.exception("engine scheduler turn failed")
                self._fail_all(e)

    def _start_admissions(self) -> None:
        if self.members > 1:
            self._start_admissions_members()
            return
        while True:
            with self._cond:
                if not self._pending:
                    return
                slot = next((i for i, r in enumerate(self._slots) if r is None), None)
                if slot is None:
                    return
                req = self._pending.popleft()
            if req.cancel.is_set():
                self.n_cancelled += 1
                req.out.put(("end", None))
                continue
            try:
                self._admit(req, slot)
            except Exception as e:
                # This request's own prefill failed: doom it alone; the slot
                # never activated.
                logger.exception("admission failed")
                self.n_failures += 1
                req.out.put(("err", e))

    def _prompt_tokens(self, prompts: list[list[int]], bucket: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Right-padded ``[len(prompts), bucket]`` tokens and their lengths
        on the device (an empty prompt stands for an absent member: one pad
        token, length 1, keeps the last-token gather valid)."""
        tokens = torch.zeros((len(prompts), bucket), dtype=torch.long)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = torch.tensor(p, dtype=torch.long)
        lengths = torch.tensor([max(1, len(p)) for p in prompts], dtype=torch.int32)
        return tokens.to(self.device), lengths.to(self.device)

    def _admit(self, req: _Request, slot: int) -> None:
        """Single-shot admission: prefill the prompt into ``slot`` and sample
        its first token (one host read). An ensemble prefills the prompt
        through every weight set (rows ``e·S + slot``) and samples from the
        members' mean logits."""
        spec, n_ens = self.spec, self.ensemble
        bucket = prefill_bucket(len(req.prompt_ids), spec.max_seq)
        tokens, lengths = self._prompt_tokens([req.prompt_ids] * n_ens, bucket)
        if n_ens > 1:
            logits, _, _ = prefill(self.params, spec, tokens, lengths, self._ck, self._cv,
                                   rows=[e * self.n_slots + slot for e in range(n_ens)])
            logits = logits.mean(0, keepdim=True)
        else:
            logits, _, _ = prefill(self.params, spec, tokens, lengths, self._ck, self._cv,
                                   slot=slot)
        self.n_admission_dispatches += 1
        (first,) = self._start_rows([req], [slot], logits)
        if not self._emit(req, first):
            with self._cond:
                self._slots[slot] = req

    def _start_rows(self, reqs: list[_Request], rows: list[int], logits: torch.Tensor) -> list[int]:
        """Sample each admitted request's first token from its row of
        ``logits`` and set its row's decode state; one host read. Finish
        state: the admission already produced token 1, so the remaining
        budget is budget-1; a row is live unless that first token exhausted
        it or WAS the EOS."""
        dev, vocab = self.device, self.spec.vocab_size
        idx = (slice(rows[0], rows[0] + 1) if len(rows) == 1
               else torch.tensor(rows, dtype=torch.long, device=dev))

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=dev)

        for r, row in zip(reqs, rows):
            if not r.sampler.greedy:
                r.generator = torch.Generator(device=dev).manual_seed(r.seed)
                gumbel_noise(vocab, r.generator, out=self._noise[row])
        self._temp[idx] = col([r.sampler.temperature for r in reqs], torch.float32)
        self._topp[idx] = col([r.sampler.top_p for r in reqs], torch.float32)
        self._topk[idx] = col([r.sampler.top_k for r in reqs], torch.int32)
        restrict = any(r.sampler.restricts and not r.sampler.greedy for r in reqs)
        first = sample_token_rows(logits, self._temp[idx], self._topp[idx], self._topk[idx],
                                  self._noise[idx], restrict=restrict)
        eos = col([r.eos_id if r.eos_id is not None else -1 for r in reqs], torch.int32)
        budget = col([r.budget for r in reqs], torch.int32)
        self._token[idx] = first
        self._lengths[idx] = col([len(r.prompt_ids) for r in reqs], torch.int32)
        self._live[idx] = (first != eos) & (budget > 1)
        self._budget[idx] = budget - 1
        self._eos[idx] = eos
        self.n_admissions += len(reqs)
        return first.tolist()

    # ---- stacked members: the single-shot route of the JAX engine's
    # ``_start_admissions_members`` / ``_admit_members`` ----------------------

    def _common_free_row(self, members) -> int | None:
        """The first slot index free for EVERY given member. Caller holds
        ``_cond``."""
        s = self.n_slots
        return next((row for row in range(s)
                     if all(self._slots[m * s + row] is None for m in members)), None)

    def _start_admissions_members(self) -> None:
        """Candidates are the FIFO head of each member's queue. Anchored on
        each head in FIFO order, the heads sharing the anchor's prompt bucket
        form a group admitted in one dispatch into a common free slot
        index; when the group has none, the anchor alone (so one busy
        member's full slots never starve idle members)."""
        max_seq = self.spec.max_seq
        while True:
            with self._cond:
                if not self._pending:
                    return
                heads: list[_Request] = []
                seen: set[int] = set()
                for r in self._pending:
                    if r.member not in seen:
                        seen.add(r.member)
                        heads.append(r)
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
                    return  # no head has a usable row this turn
                for r in group.values():
                    self._pending.remove(r)
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
            else:
                live[m] = req
        if not live:
            return
        spec, members = self.spec, list(live)
        rows = [m * s + row for m in members]
        prompt = live[members[0]].prompt_ids
        # Dedup: a FULL group carrying one prompt on shared weights has one
        # K/V for every member; partial groups and per-member prompts take
        # the M-row prefill (the tokens are the same either way).
        use_dedup = (self.quorum_dedup and len(live) == n_mem
                     and all(r.prompt_ids == prompt for r in live.values()))
        try:
            if use_dedup or len(live) == 1:
                # One prompt through one member's weight views (member 0's
                # under dedup): 1/M of the stacked prefill's work.
                tokens, lengths = self._prompt_tokens([prompt], bucket)
                logits, _, _ = prefill(member_params(self.params, members[0]), spec, tokens,
                                       lengths, self._ck, self._cv, slot=rows[0])
                if use_dedup:
                    n = len(prompt)
                    for cache in (self._ck, self._cv):
                        by_member = cache.view(cache.shape[0], n_mem, s, *cache.shape[2:])
                        by_member[:, 1:, row, :, :n].copy_(
                            by_member[:, :1, row, :, :n].expand(-1, n_mem - 1, -1, -1, -1))
                    logits = logits.expand(n_mem, -1)
            else:
                tokens, lengths = self._prompt_tokens(
                    [live[m].prompt_ids if m in live else [] for m in range(n_mem)], bucket)
                logits, _, _ = prefill(self.params, spec, tokens, lengths, self._ck, self._cv,
                                       rows=[m * s + row if m in live else None
                                             for m in range(n_mem)])
                if len(live) < n_mem:
                    logits = logits[torch.tensor(members, device=self.device)]
            self.n_admission_dispatches += 1
            firsts = self._start_rows(list(live.values()), rows, logits)
        except Exception as e:
            # The group's own prefill failed: doom its members alone; no
            # row went live.
            logger.exception("admission failed")
            for req in live.values():
                self.n_failures += 1
                req.out.put(("err", e))
            return
        if use_dedup:
            self.quorum_dedup_tokens += (n_mem - 1) * len(prompt)
            self.quorum_dedup_prefills += 1
        for flat, req, first in zip(rows, live.values(), firsts):
            if not self._emit(req, first):
                with self._cond:
                    self._slots[flat] = req

    def _sweep_cancelled(self) -> None:
        """Release rows whose consumer went away (or hit a stop string)."""
        with self._cond:
            active = [(i, r) for i, r in enumerate(self._slots) if r is not None]
        for i, r in active:
            if r.cancel.is_set():
                self.n_cancelled += 1
                r.out.put(("end", None))
                with self._cond:
                    self._slots[i] = None

    def _run_chunk(self) -> None:
        """One batched decode chunk over every active slot, one host read."""
        self._sweep_cancelled()
        with self._cond:
            active = [(i, r) for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return
        n_steps = max(1, min(r.chunk_hint or self.decode_chunk for _, r in active))
        mask = torch.zeros((self._rows,), dtype=torch.bool)
        for i, _ in active:
            mask[i] = True
        mask = mask.to(self.device)
        # Inactive slots run the forward (the batch is static) but their K/V
        # write is masked off; rows that finished on device stay dead.
        live0 = mask & self._live & (self._budget > 0)
        sampling = [(i, r) for i, r in active if not r.sampler.greedy]
        restrict = any(r.sampler.restricts for _, r in sampling)
        vocab = self.spec.vocab_size

        def sample_fn(logits, live, carry):
            for i, r in sampling:  # one draw per step from each sampling row's stream
                gumbel_noise(vocab, r.generator, out=self._noise[i])
            nxt = sample_token_rows(logits, self._temp, self._topp, self._topk, self._noise,
                                    restrict=restrict)
            return nxt, carry, ()

        (toks, _valid, n_valid, live_end, self._budget, _, _, self._lengths, _, _) = decode_chunk(
            self.params, self.spec, n_steps, self._token, self._lengths, live0, self._budget,
            self._eos, self._ck, self._cv, sample_fn, None, ensemble=self.ensemble)
        # Rows outside this chunk's active set keep their state.
        self._live = torch.where(mask, live_end, self._live)
        self._token = torch.where(mask, toks[:, -1], self._token)
        host = torch.cat([toks, n_valid[:, None].to(toks.dtype)], dim=1).cpu().tolist()
        self.n_decode_chunks += 1
        self.n_decode_steps += n_steps
        self.n_decode_rows += len(active)
        done = []
        for i, req in active:
            k = host[i][n_steps]
            got = 0
            for j in range(k):
                got += 1
                if self._emit(req, host[i][j]):
                    done.append(i)
                    break
            self.n_overrun += k - got
        if done:
            with self._cond:
                for i in done:
                    self._slots[i] = None

    def _emit(self, req: _Request, tok: int) -> bool:
        """Deliver one token; returns True when the request just finished."""
        if req.cancel.is_set():
            self.n_cancelled += 1
            req.out.put(("end", None))
            return True
        req.emitted += 1
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
        """A decode turn failed: fail the requests whose rows were in it and
        free their slots; pending requests stay queued."""
        with self._cond:
            doomed = [r for r in self._slots if r is not None]
            self._slots = [None] * self._rows
            self.n_rebuilds += 1
        for r in doomed:
            self.n_failures += 1
            r.out.put(("err", exc))


def _check_stack_knobs(members: int, ensemble: int, member_seeds: str,
                       quorum_dedup: bool) -> None:
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


_ENGINES: dict[tuple, InferenceEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(
    spec: ModelSpec,
    *,
    device=None,
    seed: int = 0,
    n_slots: int = DEFAULT_SLOTS,
    decode_chunk: int = DEFAULT_DECODE_CHUNK,
    max_pending: int = DEFAULT_MAX_PENDING,
    members: int = 1,
    member_seeds: str = "distinct",
    quorum_dedup: bool = False,
    ensemble: int = 1,
) -> InferenceEngine:
    """Engines are keyed by weight identity (spec, seed, device, members,
    ensemble, member_seeds when members > 1) and by ``quorum_dedup``, which
    is structural: backends that differ only in dispatch knobs share one set
    of weights, so ``members=M&member=i`` backends share one engine and a
    dedup URL never shares a non-dedup engine. ``n_slots`` and
    ``max_pending`` apply at first construction. ``device`` defaults to
    cuda and raises when there is none."""
    dev = resolve_device(device)
    members, ensemble = max(1, int(members)), max(1, int(ensemble))
    key = (spec, int(seed), str(dev), members, ensemble,
           member_seeds if members > 1 else None, bool(quorum_dedup))
    with _ENGINES_LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            eng = _ENGINES[key] = InferenceEngine(
                spec, device=dev, seed=seed, n_slots=n_slots, decode_chunk=decode_chunk,
                max_pending=max_pending, members=members, member_seeds=member_seeds,
                quorum_dedup=quorum_dedup, ensemble=ensemble)
        return eng


def shutdown_all_engines(timeout: float = 30.0) -> None:
    with _ENGINES_LOCK:
        engines = list(_ENGINES.values())
        _ENGINES.clear()
    for eng in engines:
        eng.shutdown(timeout=timeout)
