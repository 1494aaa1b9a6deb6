"""Training step: next-token cross-entropy and AdamW over the params tree,
on one device. The port of the JAX package's ``training/trainer.py``.

The forward is the serving model's own ``forward_logits``, differentiated,
with ``plain_attention=True``: the JAX trainer's forward is XLA's plain
attention too (the kernels have no backward; their wrappers refuse inputs
that require grad). ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), JAX's ``jax.checkpoint`` per
scanned layer.

Gradients of the stacked ``[L, …]`` block leaves: autograd through
``leaf[l]`` would make a whole-leaf zero tensor per layer in the backward
(16 GB of writes a layer at llama-3-8b). Instead each layer's slice is a
leaf of its own (a detached view), whose ``.grad`` is preset to the same
slice of one zeroed gradient tree: autograd accumulates into it in place, so
the backward writes each layer's gradient once, into the tree the
optimizer reads. The whole-tree leaves (embedding, head, final norm) get the
same treatment whole.

JAX's ``mesh`` argument is ``device=`` for one device, or ``mesh=`` (a
``parallel/comm.RankMesh``) at rank level: each rank holds its tp cut of
the state (``models/init.init_params_shard``; replicated over dp) and runs
the same step on its dp group's rows, as DDP ranks do. Where the JAX
package gets global semantics from GSPMD, the port adds them: the tp
collectives of the forward are differentiable (``models/transformer``), so
every tp rank computes the whole loss; the loss divides the sum of the
rows' nll by the count of non-pad targets over the whole global batch (the
per-rank count all-reduced over dp first), so unequal padding across ranks
gives the one-device loss; the gradients are summed over dp in float32 and
cast once; clipping's global norm sums the squares of cut leaves over tp
and counts replicated ones once (``training/optim.global_norm``). A mesh
with pp > 1 (dp × pp only, the JAX package's rule) trains through the
pipelined step of ``parallel/pipeline.py`` (``make_pp_train_step``, GPipe
over ``n_micro`` microbatches), which :func:`train_init` and
:func:`make_train_step` reach with such a mesh. sp-sharded training is not
ported: a mesh with sp > 1 is refused. A spawned group of ranks is driven
through ``RankGroup.run`` with :func:`train_steps`. The step updates the
state in place (JAX donates it) and returns it.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.init import init_params, init_params_shard
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.transformer import forward_logits
from quorum_tpu_torch.parallel.sharding import kv_sharers
from quorum_tpu_torch.training.optim import (CHUNK, Optimizer, global_norm, linear_schedule,
                                             tree_leaves, tree_map,
                                             warmup_cosine_decay_schedule)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # 0-d int32, on the host


def loss_fn(params, spec: ModelSpec, tokens: torch.Tensor, remat: bool = True,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``tokens`` [B, T] (0 = pad):
    log-softmax in f32 off the model's logits, pad targets masked out of the
    mean. On a ``mesh`` (a ``RankMesh``; ``tokens`` the rank's dp rows) the
    mean is the global batch's: this rank's nll sum over the count of
    non-pad targets of every dp group's rows; the ranks' values sum over
    dp to the global loss."""
    logits = forward_logits(params, spec, tokens[:, :-1], plain_attention=True, remat=remat,
                            mesh=mesh)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (targets != 0).float()
    count = torch.sum(mask)
    if mesh is not None:
        count = mesh.dp.all_reduce(count.detach().clone())
    return torch.sum(nll * mask) / torch.clamp_min(count, 1.0)


def _grad_leaves(params, grads):
    """A tree like ``params`` whose leaves require grad and accumulate into
    ``grads``: block leaves as lists of per-layer slices (``transformer.
    _layer`` indexes a list as it indexes a stacked tensor)."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    out = {k: (None if v is None else leaf(v, grads[k]))
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: (None if v is None else [leaf(v[l], grads["blocks"][k][l])
                                                 for l in range(v.shape[0])])
                     for k, v in params["blocks"].items()}
    return out


def value_and_grad(params, spec: ModelSpec, tokens: torch.Tensor, remat: bool = True,
                   mesh=None, comm: dict | None = None):
    """``(loss, grads)`` of :func:`loss_fn`: ``grads`` a new tree like
    ``params`` (each leaf in its dtype), filled by one backward. On a
    ``mesh`` the loss is the global batch's and the gradients are summed
    over dp (:func:`dp_sum_grads`; ``comm`` accumulates its seconds and
    bytes)."""
    grads = tree_map(torch.zeros_like, params)
    with torch.enable_grad():
        loss = loss_fn(_grad_leaves(params, grads), spec, tokens, remat, mesh)
        loss.backward()
    loss = loss.detach()
    if mesh is not None:
        dp_sum_grads(grads, mesh, comm)
        loss = mesh.dp.all_reduce(loss.clone())
    return loss, grads


@torch.no_grad()
def dp_sum_grads(grads, mesh, comm: dict | None = None) -> None:
    """Sum every gradient leaf over the mesh's dp group, in place: in
    float32 (a 16-bit leaf widened piece by piece, ``CHUNK`` elements at a
    time, summed, and cast back once), as the tp all-reduces sum f32
    partial products. ``comm``: ``grad_allreduce_s`` and
    ``grad_allreduce_bytes`` (the float32 bytes each rank contributes)
    grow by this call's."""
    if mesh.dp_size == 1:
        return
    t0 = time.perf_counter()
    sent = 0
    for leaf in tree_leaves(grads):
        flat = leaf.view(-1)
        for i in range(0, flat.numel(), CHUNK):
            piece = flat[i:i + CHUNK]
            wide = piece if piece.dtype == torch.float32 else piece.float()
            mesh.dp.all_reduce(wide)
            if wide is not piece:
                piece.copy_(wide)
            sent += wide.numel() * 4
    if comm is not None:
        if grads and tree_leaves(grads)[0].is_cuda:
            torch.cuda.synchronize(mesh.device)
        comm["grad_allreduce_s"] = comm.get("grad_allreduce_s", 0.0) + time.perf_counter() - t0
        comm["grad_allreduce_bytes"] = comm.get("grad_allreduce_bytes", 0) + sent


def make_optimizer(
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    *,
    warmup_steps: int = 0,
    total_steps: int | None = None,
    grad_clip: float | None = None,
    accum_steps: int = 1,
) -> Optimizer:
    """The JAX trainer's recipe: AdamW (b1 0.9, b2 0.95) at ``lr`` —
    constant, or with ``warmup_steps``/``total_steps`` a linear warmup and
    cosine decay (``decay_steps`` = ``total_steps``, warmup included), or
    with ``warmup_steps`` alone a linear warmup —; optional global-norm
    clipping (``grad_clip``); optional accumulation of ``accum_steps``
    micro-batches in an f32 running mean. For micro-batches with equal
    real-token counts the accumulated update equals one step over all of
    them (the loss is normalized per micro-batch)."""
    if total_steps is not None:
        if warmup_steps >= total_steps:
            raise ValueError(
                f"warmup_steps={warmup_steps} must be < total_steps="
                f"{total_steps} (no decay budget left)")
        sched = warmup_cosine_decay_schedule(0.0, lr, max(0, warmup_steps), max(1, total_steps))
    elif warmup_steps > 0:
        sched = linear_schedule(0.0, lr, warmup_steps)
    else:
        sched = lr
    return Optimizer(sched, weight_decay=weight_decay, grad_clip=grad_clip,
                     accum_steps=accum_steps)


def check_train_mesh(spec: ModelSpec, mesh) -> None:
    """Refuse what the mesh forms of training do not carry, by name: sp
    (not ported), pp beside tp or sp and pp not dividing the layers (the
    JAX package's words, ``parallel/pipeline._check_pp_mesh``), and MoE
    specs. Every tp trains: a dim tp does not divide is whole on every rank
    (``parallel/sharding``), and a leaf whose rank gradient is partial (kv
    projections whole or shared by several ranks) has it summed over the
    ranks that hold it (``models/transformer``)."""
    shape = mesh.mesh.shape
    if shape["pp"] > 1:
        from quorum_tpu_torch.parallel.pipeline import _check_pp_mesh

        _check_pp_mesh(mesh, spec)
    elif shape["sp"] > 1:
        raise ValueError(f"training on a mesh with sp > 1 ({dict(shape)}) is not ported "
                         "yet: dp, tp and pp are")
    if spec.is_moe:
        raise ValueError("MoE specs are not yet on a multi-rank trainer")


def train_init(spec: ModelSpec, *, device="cuda", seed: int = 0,
               optimizer: Optimizer | None = None, mesh=None) -> TrainState:
    """A TrainState on ``device``: the port's seeded init (``models/init``),
    the optimizer's zero state, step 0. With ``mesh`` (a ``RankMesh``) the
    state is this rank's tp cut of the same init, on the rank's device."""
    opt = optimizer or make_optimizer()
    if mesh is None:
        params = init_params(spec, seed, device=resolve_device(device))
    else:
        check_train_mesh(spec, mesh)
        params = init_params_shard(spec, seed, mesh, mesh.rank, mesh.device)
    return TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))


def make_train_step(spec: ModelSpec, *, device="cuda", optimizer: Optimizer | None = None,
                    remat: bool = True, grads_hook=None, mesh=None, n_micro: int = 2):
    """``step(state, tokens) -> (state, loss)``: one optimizer step on
    ``tokens`` [B, T] (any integer array; moved to ``device``). The params
    and the optimizer state are updated in place; ``loss`` is a 0-d f32
    tensor on the device. ``grads_hook(state, loss, grads)``, when given,
    runs between the backward and the optimizer's update (instrumentation:
    timing the two halves, reading the gradients before clipping scales
    them).

    With ``mesh`` (a ``RankMesh``; every rank of the mesh calls the step in
    the same order) ``tokens`` are this rank's dp group's rows
    (``parallel/distributed.assemble_global_batch`` cuts them) and ``loss``
    is the global batch's, the same on every rank. ``step.comm`` holds the
    dp gradient all-reduce's seconds and bytes so far. A mesh with pp > 1
    gets the pipelined step (``parallel/pipeline.make_pp_train_step``,
    ``n_micro`` microbatches)."""
    opt = optimizer or make_optimizer()
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None:
        check_train_mesh(spec, mesh)
        if mesh.pp_size > 1:
            from quorum_tpu_torch.parallel.pipeline import make_pp_train_step

            return make_pp_train_step(spec, mesh, n_micro=n_micro, optimizer=opt, remat=remat,
                                      grads_hook=grads_hook)
    cut: list = []  # the params' tp-cut flags, built at the first step

    def step(state: TrainState, tokens) -> tuple[TrainState, torch.Tensor]:
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
        loss, grads = value_and_grad(state.params, spec, tokens, remat, mesh, step.comm)
        if grads_hook is not None:
            grads_hook(state, loss, grads)
        if mesh is None:
            opt_state = opt.update(grads, state.opt_state, state.params)
        else:
            if not cut:
                cut.append(tp_cut_flags(state.params, spec, mesh))
            opt_state = opt.update(grads, state.opt_state, state.params, mesh=mesh,
                                   cut=cut[0])
        return TrainState(state.params, opt_state, state.step + 1), loss

    step.comm = {"grad_allreduce_s": 0.0, "grad_allreduce_bytes": 0}
    return step


def tp_cut_flags(params, spec: ModelSpec, mesh=None):
    """A tree like ``params``: True where the leaf is a tp rank's cut (its
    shape is not the whole leaf's), False where it is replicated, and
    ``"shared"`` where it is a cut another rank holds too (kv heads shared by
    several ranks, ``parallel/sharding.kv_sharers``) and not this rank's to
    count in the global norm: the first of those ranks counts it."""
    whole = init_params(spec, device="meta")
    flags = tree_map(lambda p, w: tuple(p.shape) != tuple(w.shape), params, whole)
    if mesh is not None:
        sharers = kv_sharers(spec.n_heads, spec.n_kv_heads, mesh.tp_size, mesh.tp_rank)
        if sharers[0] != mesh.tp_rank:
            for name in ("wk", "wv", "bk", "bv"):
                if flags["blocks"].get(name):
                    flags["blocks"][name] = "shared"
    return flags


def train_steps(spec: ModelSpec, tokens, *, mesh, seed: int = 0, steps: int = 1,
                opt: dict | None = None, remat: bool = True, params=None,
                resume: str | None = None, save: str | None = None,
                return_params: bool = False, digest: bool = False, n_micro: int = 2,
                return_grads: bool = False) -> dict:
    """A ``RankGroup.run`` driver: every rank builds its cut of the state
    (from ``seed``; or ``params``, a whole host tree of numpy arrays cut by
    ``models/convert.shard_params``; or the checkpoint at ``resume``), takes
    its dp rows of the global batch ``tokens`` [B, T] and runs ``steps``
    steps of the recipe ``make_optimizer(**opt)``; with ``save`` the state
    is saved there afterwards (``training/checkpoint.save_checkpoint``,
    every rank taking part). Returns the losses, each step's seconds, the dp
    all-reduce's seconds and bytes, each step's gradient norm (the whole
    tree's, before clipping), and with ``return_params`` the rank's
    params (``return_grads``: the last step's gradients, before clipping).
    A pp mesh runs the pipelined step over ``n_micro`` microbatches."""
    from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
    from quorum_tpu_torch.parallel.distributed import assemble_global_batch

    optimizer = make_optimizer(**(opt or {}))
    if resume is not None:
        from quorum_tpu_torch.training.checkpoint import restore_checkpoint

        check_train_mesh(spec, mesh)
        state = restore_checkpoint(resume, spec, optimizer=optimizer, mesh=mesh)
    elif params is None:
        state = train_init(spec, seed=seed, optimizer=optimizer, mesh=mesh)
    else:
        check_train_mesh(spec, mesh)
        whole = params_from_numpy(params, device=mesh.device, dtype=spec.dtype)
        mine = shard_params(whole, mesh, mesh.rank, spec)
        del whole
        state = TrainState(mine, optimizer.init(mine), torch.zeros((), dtype=torch.int32))
    rows = None if tokens is None else assemble_global_batch(tokens, mesh, len(tokens))
    norms: list[float] = []
    cut = tp_cut_flags(state.params, spec, mesh)

    last: dict = {}

    def record_norm(st, loss, grads):  # the whole tree's norm, before clipping
        norms.append(float(global_norm(grads, mesh=mesh, cut=cut)))
        if return_grads:
            last["grads"] = tree_map(torch.clone, grads)

    step = make_train_step(spec, optimizer=optimizer, remat=remat, mesh=mesh,
                           grads_hook=record_norm, n_micro=n_micro)
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, rows)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    out = {"losses": losses, "grad_norms": norms, "step_s": seconds, **step.comm,
           "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                          if mesh.device.type == "cuda" else 0)}
    if save is not None:
        from quorum_tpu_torch.training.checkpoint import save_checkpoint

        out["saved_bytes"] = save_checkpoint(save, state, mesh=mesh, spec=spec)
    if digest:
        from quorum_tpu_torch.training.checkpoint import tree_digest

        out["digest"] = {"params": tree_digest(state.params),
                         "opt_state": tree_digest(state.opt_state)}
    if return_params:
        out["params"] = state.params
    if return_grads:
        out["grads"] = last["grads"]
    return out
