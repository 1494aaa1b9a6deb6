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

JAX's ``mesh`` argument is ``device`` here: the mesh forms (dp/tp/sp
sharded states, the multi-process dp step, the pipeline-parallel step) wait
for the port's ``parallel/``. The step updates the state in place (JAX
donates it) and returns it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.transformer import forward_logits
from quorum_tpu_torch.training.optim import (Optimizer, linear_schedule, tree_map,
                                             warmup_cosine_decay_schedule)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # 0-d int32, on the host


def loss_fn(params, spec: ModelSpec, tokens: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over ``tokens`` [B, T] (0 = pad):
    log-softmax in f32 off the model's logits, pad targets masked out of the
    mean."""
    logits = forward_logits(params, spec, tokens[:, :-1], plain_attention=True, remat=remat)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (targets != 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


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


def value_and_grad(params, spec: ModelSpec, tokens: torch.Tensor, remat: bool = True):
    """``(loss, grads)`` of :func:`loss_fn`: ``grads`` a new tree like
    ``params`` (each leaf in its dtype), filled by one backward."""
    grads = tree_map(torch.zeros_like, params)
    with torch.enable_grad():
        loss = loss_fn(_grad_leaves(params, grads), spec, tokens, remat)
        loss.backward()
    return loss.detach(), grads


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


def train_init(spec: ModelSpec, *, device="cuda", seed: int = 0,
               optimizer: Optimizer | None = None) -> TrainState:
    """A TrainState on ``device``: the port's seeded init (``models/init``),
    the optimizer's zero state, step 0."""
    opt = optimizer or make_optimizer()
    params = init_params(spec, seed, device=resolve_device(device))
    return TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))


def make_train_step(spec: ModelSpec, *, device="cuda", optimizer: Optimizer | None = None,
                    remat: bool = True, grads_hook=None):
    """``step(state, tokens) -> (state, loss)``: one optimizer step on
    ``tokens`` [B, T] (any integer array; moved to ``device``). The params
    and the optimizer state are updated in place; ``loss`` is a 0-d f32
    tensor on the device. ``grads_hook(state, loss, grads)``, when given,
    runs between the backward and the optimizer's update (instrumentation:
    timing the two halves, reading the gradients before clipping scales
    them)."""
    opt = optimizer or make_optimizer()
    dev = resolve_device(device)

    def step(state: TrainState, tokens) -> tuple[TrainState, torch.Tensor]:
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
        loss, grads = value_and_grad(state.params, spec, tokens, remat)
        if grads_hook is not None:
            grads_hook(state, loss, grads)
        opt_state = opt.update(grads, state.opt_state, state.params)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return step
