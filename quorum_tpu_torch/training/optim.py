"""The port's counterpart of the optax pieces the trainer's recipe composes
(``training/trainer.make_optimizer``): AdamW, the learning-rate schedules,
global-norm clipping and gradient accumulation (``optax.MultiSteps`` behind
the JAX trainer's f32 cast).

State: the same tree optax keeps, leaf for leaf, in the same NamedTuples
(:class:`EmptyState`, :class:`ScaleByAdamState`,
:class:`ScaleByScheduleState`, :class:`MultiStepsState`) nested the same way,
so a JAX TrainState carries across (``models/convert.
train_state_from_numpy``) and a checkpoint holds the same items:

- ``adamw``: ``ScaleByAdamState(count, mu, nu)``, the moments in the
  params' dtype (bf16 moments for bf16 params, as optax keeps them), then
  the weight decay's ``EmptyState`` and the learning rate's state: an
  ``EmptyState`` for a constant rate, ``ScaleByScheduleState(count)`` for a
  schedule;
- ``clip_by_global_norm`` in front: ``(EmptyState(), <adamw>)``;
- accumulation: ``(EmptyState(), MultiStepsState(mini_step,
  gradient_step, inner_opt_state, acc_grads, skip_state=()))``. As in
  optax, the f32 micro-gradients make the accumulator f32 after the first
  micro-step and promote the inner moments to f32 with it (optax selects
  between the old and the new inner state with ``jnp.where``, which
  promotes).

The counts are 0-d int32 tensors on the host, whatever device the params
are on: the learning rate of a step is computed from them with no device
read. The schedules count as optax counts: the first update uses count 0
(a warmup's first rate is its ``init_value``, 0 in the recipe), and
``warmup_cosine_decay_schedule``'s ``decay_steps`` includes the warmup.

``Optimizer.update`` applies the update to the params IN PLACE (optax's
``update`` and ``apply_updates`` in one pass) under ``torch.no_grad``, leaf
by leaf and within a leaf in pieces of ``CHUNK`` elements, so no temporary
is larger than a piece: at llama-3-8b a whole-model temporary (a
``foreach`` over every leaf, an f32 copy of the params) would be 16–32 GB
more than the card holds beside the state. The gradients are scratch: clipping
scales them in place.

Arithmetic follows optax's order (moments, bias correction, ``m / (sqrt(v̂)
+ eps)``, ``+ wd·p``, ``× −lr``, ``p + u``) with scalars rounded to the
tensor's dtype as JAX rounds weak-typed scalars; the moments update as
``mu.lerp_(g, 1 − b1)`` and ``nu·b2 + (1 − b2)·g²`` (one rounding fewer than
optax's two products and a sum). The global norm sums the squares in f32 and
rounds once to the gradients' dtype (optax sums bf16 squares in bf16).
On a mesh (``update(..., mesh=, cut=)``, a tp rank's cut of the state) the
squares of cut leaves are summed over tp and those of replicated leaves
counted once, so the norm is the whole tree's; on a pp mesh each stage's
sum is summed over the stages. AdamW and weight decay stay elementwise on
each shard.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

Schedule = Callable[[int], float]

# Elements of a leaf one pass of the update works on at a time.
CHUNK = 1 << 25
# AdamW's constants in the trainer's recipe (optax's eps).
B1, B2, EPS = 0.9, 0.95, 1e-8
_INT32_MAX = 2**31 - 1


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: a transformation that keeps nothing."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class MultiStepsState(NamedTuple):
    mini_step: torch.Tensor
    gradient_step: torch.Tensor
    inner_opt_state: Any
    acc_grads: Any
    skip_state: Any = ()


STATE_TYPES = {cls.__name__: cls for cls in
               (EmptyState, ScaleByAdamState, ScaleByScheduleState, MultiStepsState)}


# ---- trees -----------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a params-shaped tree (nested dicts, None
    leaves kept), with the matching leaves of ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a params-shaped tree, in its order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: +1, saturating at the int32 maximum."""
    return _count(min(int(count) + 1, _INT32_MAX))


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX rounds a weak-typed scalar before
    an operation with a tensor of that dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _pieces(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


# ---- schedules (f32, as optax computes them) --------------------------------

_F32 = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(_F32(value))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init_value`` at count 0, a straight line
    to ``end_value`` over ``transition_steps`` counts, then flat; a
    non-positive ``transition_steps`` is ``init_value`` always."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = min(max(int(count), 0), transition_steps)
        frac = _F32(1) - _F32(c) / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` to 0 (alpha 0, exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = _F32(min(float(count), float(decay_steps)))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return float(_F32(init_value) * cosine)

    return schedule


def join_schedules(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule, fed
    the count since that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value``, then a cosine to
    0; ``decay_steps`` counts the warmup too."""
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps)],
        [warmup_steps])


# ---- the optimizer ---------------------------------------------------------


class Optimizer:
    """AdamW (b1 ``B1``, b2 ``B2``, eps ``EPS``) at ``learning_rate`` (a
    float or a schedule over the update count) with decoupled
    ``weight_decay`` on every leaf, optional
    ``grad_clip`` (global norm) in front, optional accumulation over
    ``accum_steps`` micro-batches (f32 running mean; the inner update runs
    on the last micro-batch of each window, the params are untouched on the
    others)."""

    def __init__(self, learning_rate: float | Schedule, *, weight_decay: float = 0.0,
                 grad_clip: float | None = None, accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.accum_steps = accum_steps

    # -- state ---------------------------------------------------------------

    def init(self, params) -> Any:
        """optax's ``init`` of the same recipe: zero moments in each leaf's
        dtype, zero counts, and with accumulation a zero accumulator in the
        params' dtypes."""
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        inner = (ScaleByAdamState(_count(), tree_map(zeros, params), tree_map(zeros, params)),
                 EmptyState(),
                 ScaleByScheduleState(_count()) if callable(self.learning_rate) else EmptyState())
        if self.grad_clip is not None:
            inner = (EmptyState(), inner)
        if self.accum_steps > 1:
            return (EmptyState(), MultiStepsState(_count(), _count(), inner,
                                                  tree_map(zeros, params), ()))
        return inner

    # -- update --------------------------------------------------------------

    @torch.no_grad()
    def update(self, grads, state, params, *, mesh=None, cut=None) -> Any:
        """One optimizer step: ``params`` updated in place; returns the new
        state (its tensors updated in place where their dtype stays). On a
        ``mesh`` (a ``RankMesh``), ``cut`` (a tree of bools like the params:
        the leaves that are tp cuts) makes clipping's norm the whole
        tree's."""
        if self.accum_steps == 1:
            return self._inner_update(grads, state, params, mesh, cut)
        _, ms = state
        k = self.accum_steps
        mini = int(ms.mini_step)
        acc = tree_map(lambda a, g: _welford(a, g, mini), ms.acc_grads, grads)
        if mini == k - 1:
            inner = self._inner_update(acc, ms.inner_opt_state, params, mesh, cut)
            tree_map(torch.Tensor.zero_, acc)
            gstep = _inc(ms.gradient_step)
        else:
            inner = _promote_moments(ms.inner_opt_state, acc)
            gstep = ms.gradient_step.clone()
        return (EmptyState(), MultiStepsState(_count((mini + 1) % k), gstep, inner, acc, ()))

    def _inner_update(self, grads, state, params, mesh=None, cut=None):
        if self.grad_clip is not None:
            clip_state, state = state
            clip_by_global_norm_(grads, self.grad_clip, mesh=mesh, cut=cut)
        adam, decay_state, lr_state = state
        count = _inc(adam.count)
        lr = (self.learning_rate(int(lr_state.count)) if callable(self.learning_rate)
              else self.learning_rate)
        bc1 = float(_F32(1) - _F32(B1) ** _F32(int(count)))
        bc2 = float(_F32(1) - _F32(B2) ** _F32(int(count)))
        mu = tree_map(lambda m, g: _promoted(m, g.dtype), adam.mu, grads)
        nu = tree_map(lambda v, g: _promoted(v, g.dtype), adam.nu, grads)
        tree_map(lambda p, g, m0, v0, m, v: self._adamw_leaf(p, g, m0, v0, m, v, lr, bc1, bc2),
                 params, grads, adam.mu, adam.nu, mu, nu)
        new = (ScaleByAdamState(count, mu, nu), decay_state,
               ScaleByScheduleState(_inc(lr_state.count)) if callable(self.learning_rate)
               else lr_state)
        return (clip_state, new) if self.grad_clip is not None else new

    def _adamw_leaf(self, p, g, mu0, nu0, mu, nu, lr, bc1, bc2) -> None:
        """One leaf: ``mu``/``nu`` the moments to write (``mu0``/``nu0`` or
        their promoted copies), ``p`` updated in place."""
        dt = mu.dtype
        w1, w2 = _rounded(1 - B1, dt), _rounded(1 - B2, dt)
        b2, eps = _rounded(B2, dt), _rounded(EPS, dt)
        bc1, bc2 = _rounded(bc1, dt), _rounded(bc2, dt)
        wd, neg_lr = _rounded(self.weight_decay, p.dtype), _rounded(-lr, dt)
        for pc, gc, m0, v0, mc, vc in zip(*(_pieces(t) for t in (p, g, mu0, nu0, mu, nu))):
            if mc.data_ptr() != m0.data_ptr():
                mc.copy_(m0)
                vc.copy_(v0)
            gc = gc.to(dt)
            mc.lerp_(gc, w1)
            vc.mul_(b2).addcmul_(gc, gc, value=w2)
            u = (mc / bc1).div_((vc / bc2).sqrt_().add_(eps))
            u.add_(pc, alpha=wd).mul_(neg_lr)
            pc.add_(u)


def _promoted(t: torch.Tensor, g_dtype: torch.dtype) -> torch.Tensor:
    """A moment in the dtype optax's update gives it: its own, or promoted
    with the gradients' (a new tensor, filled by the update)."""
    dt = torch.promote_types(t.dtype, g_dtype)
    return t if dt == t.dtype else torch.empty(t.shape, dtype=dt, device=t.device)


def _promote_moments(state, grads):
    """The inner state after a micro-step that emits no update: optax keeps
    the old values in the dtypes the update would have given (promoted with
    the f32 micro-gradients)."""
    if isinstance(state, ScaleByAdamState):
        def up(m, g):
            out = _promoted(m, g.dtype)
            return m if out is m else out.copy_(m)
        return ScaleByAdamState(state.count, tree_map(up, state.mu, grads),
                                tree_map(up, state.nu, grads))
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(_promote_moments(s, grads) for s in state)
    return state


def _welford(acc: torch.Tensor, g: torch.Tensor, mini: int) -> torch.Tensor:
    """``acc + (g_f32 − acc) / (mini + 1)``, the running mean over the
    window, in f32 (a new f32 accumulator where it was not f32 yet)."""
    out = acc if acc.dtype == torch.float32 else torch.empty(acc.shape, dtype=torch.float32,
                                                            device=acc.device)
    for oc, ac, gc in zip(_pieces(out), _pieces(acc), _pieces(g)):
        oc.copy_(ac.float() + (gc.float() - ac) / (mini + 1))
    return out


def _square_sum(leaves) -> torch.Tensor | None:
    total = None
    for leaf in leaves:
        for c in _pieces(leaf):
            s = torch.sum(torch.square(c.float()))
            total = s if total is None else total + s
    return total


@torch.no_grad()
def global_norm(grads, *, mesh=None, cut=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, accumulated in f32 (a
    0-d f32 tensor on the leaves' device). On a ``mesh``, ``cut`` (a tree
    of flags like ``grads``, ``trainer.tp_cut_flags``) names the tp-cut
    leaves: their squares are summed over tp, the replicated leaves'
    counted once, and a cut another rank counts (``"shared"``) not here.
    On a pp mesh (tp 1 beside it) every leaf lives on one stage: the
    stages' sums of squares are summed over pp before the root, so every
    stage scales by the whole tree's norm."""
    if mesh is not None and mesh.pp_size > 1:
        local = _square_sum(tree_leaves(grads))
        return torch.sqrt(mesh.pp.all_reduce(local.reshape(1).clone())[0])
    if mesh is None or mesh.tp_size == 1:
        return torch.sqrt(_square_sum(tree_leaves(grads)))
    flags = []
    tree_map(flags.append, cut)
    leaves = tree_leaves(grads)
    mine = _square_sum([g for g, c in zip(leaves, flags) if c is True])
    once = _square_sum([g for g, c in zip(leaves, flags) if c is False])
    dev = leaves[0].device
    mine = torch.zeros((), device=dev) if mine is None else mine
    total = mesh.tp.all_reduce(mine.reshape(1).clone())[0]
    return torch.sqrt(total if once is None else total + once)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, *, mesh=None, cut=None) -> float:
    """optax's ``clip_by_global_norm`` in place: when the global norm
    (rounded to the gradients' dtype) is not below ``max_norm``, every leaf
    becomes ``(g / norm) · max_norm``. Returns the norm (one host read).
    ``mesh``/``cut``: :func:`global_norm`'s, on a tp rank's cut."""
    leaves = tree_leaves(grads)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    norm = _rounded(float(global_norm(grads, mesh=mesh, cut=cut)), dtype)
    if not norm < max_norm:
        for leaf in leaves:
            n = _rounded(norm, leaf.dtype)
            for c in _pieces(leaf):
                c.div_(n).mul_(_rounded(max_norm, leaf.dtype))
    return norm
