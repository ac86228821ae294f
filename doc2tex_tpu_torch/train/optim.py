"""Optimizers with optax's arithmetic and state layout (counterpart of
``doc2tex_tpu.train.optim``).

The JAX package builds every optimizer from optax transformations; this
module rebuilds the ones it uses, with the same update rules, the same
order of operations and the same state structure:

- a parameter tree is ``{state-dict key: tensor}`` (the module's
  ``named_parameters()``), and a transformation is ``init(params) ->
  state`` plus ``update(updates, state, params) -> (updates, state)``;
- states are NamedTuples with optax's class and field names, a chain's
  state is a tuple, counts are Python ints.  ``state_to_flax`` lays a
  state out as ``flax.serialization.to_state_dict`` lays the optax state
  out (parameter trees as flax nested dicts, conv kernels in HWIO), so the
  JAX package's ``load_checkpoint`` restores it; ``state_from_flax``
  reads such a layout back and raises where it does not fit.

Where optax and ``torch.optim`` differ, this follows optax:

- ``clip_by_global_norm`` scales by ``(g / norm) * max_norm`` when norm >=
  max_norm (``clip_grad_norm_`` multiplies by ``max_norm / (norm + 1e-6)``);
- adamw: ``eps`` outside the square root, and the decay ``wd * p`` added to
  the Adam direction before the learning rate scales both (not applied to
  the weights first);
- the decay mask is "ndim > 1", which is the same on flax's and the port's
  shapes (``cls_token`` (1, 1, D) is decayed);
- the schedule reads the update count before it is incremented, so the
  first update uses lr(0); under ``MultiSteps`` the inner state (and with it
  the schedule) moves once per applied update;
- adagrad starts its accumulator at 0.1 with eps 1e-7, adadelta has rho
  0.9 and eps 1e-6, lamb eps 1e-6.

AdamP projects per row of the flax layout (conv kernels as HWIO), as the
JAX function does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..weights import tree_from_flax, tree_to_flax

_F = np.float32


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: int
    mu: dict
    nu: dict


class MaskedState(NamedTuple):
    inner_state: Any


class ScaleByScheduleState(NamedTuple):
    count: int


class TraceState(NamedTuple):
    trace: dict


class ScaleByRssState(NamedTuple):
    sum_of_squares: dict


class ScaleByAdaDeltaState(NamedTuple):
    e_g: dict
    e_x: dict


class MadgradState(NamedTuple):
    count: int
    grad_sum: dict
    grad_sum_sq: dict
    x0: dict


class AdampState(NamedTuple):
    count: int
    mu: dict
    nu: dict


class LookaheadState(NamedTuple):
    count: int
    slow: dict
    inner: Any


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: dict
    skip_state: tuple = ()


def _zeros(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _power(decay: float, count: int) -> float:
    """``decay ** count`` in float32, as JAX promotes the pair."""
    return float(np.power(_F(decay), _F(count)))


def global_norm(tree):
    """sqrt of the sum of squares over every leaf (0-d tensor)."""
    leaves = list(tree.values())
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


def _empty_init(params):
    return EmptyState()


def identity() -> GradientTransformation:
    return GradientTransformation(_empty_init, lambda u, s, p=None: (u, s))


def chain(*txs) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm) * max_norm)
                for k, g in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(0, _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        keys = list(updates)
        g = [updates[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state.mu[k] for k in keys], b1))
        sq = torch._foreach_mul(g, g)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                torch._foreach_mul([state.nu[k] for k in keys], b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1.0 - _power(b1, count))
        nu_hat = torch._foreach_div(nu, 1.0 - _power(b2, count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        out = torch._foreach_div(mu_hat, denom)
        return (dict(zip(keys, out)),
                ScaleByAdamState(count, dict(zip(keys, mu)), dict(zip(keys, nu))))

    return GradientTransformation(init, update)


def masked(inner: GradientTransformation, mask: dict) -> GradientTransformation:
    """``inner`` on the leaves where ``mask`` is True; the rest pass."""
    def pick(tree):
        return {k: v for k, v in tree.items() if mask[k]}

    def init(params):
        return MaskedState(inner.init(pick(params)))

    def update(updates, state, params=None):
        sub, inner_state = inner.update(pick(updates), state.inner_state,
                                        None if params is None else pick(params))
        return {k: sub.get(k, u) for k, u in updates.items()}, MaskedState(inner_state)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float, mask: dict | None = None) -> GradientTransformation:
    def update(updates, state, params=None):
        return {k: g + weight_decay * params[k] for k, g in updates.items()}, state

    tx = GradientTransformation(_empty_init, update)
    return masked(tx, mask) if mask is not None else tx


def scale_by_schedule(step_size_fn: Callable) -> GradientTransformation:
    def update(updates, state, params=None):
        step_size = step_size_fn(state.count)
        keys = list(updates)
        out = torch._foreach_mul([updates[k] for k in keys], step_size)
        return dict(zip(keys, out)), ScaleByScheduleState(state.count + 1)

    return GradientTransformation(lambda params: ScaleByScheduleState(0), update)


def scale(step_size: float) -> GradientTransformation:
    return GradientTransformation(
        _empty_init, lambda u, s, p=None: ({k: step_size * g for k, g in u.items()}, s))


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> GradientTransformation:
    """``optax.adam``: ``scale_by_adam`` then ``scale_by_learning_rate``
    (a chain of two, as optax's state is laid out)."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    def init(params):
        return ScaleByRssState({k: torch.full_like(v, initial_accumulator_value)
                                for k, v in params.items()})

    def update(updates, state, params=None):
        ss = {k: g * g + state.sum_of_squares[k] for k, g in updates.items()}
        out = {k: torch.where(ss[k] > 0, torch.rsqrt(ss[k] + eps), 0.0) * g
               for k, g in updates.items()}
        return out, ScaleByRssState(ss)

    return GradientTransformation(init, update)


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6):
    def init(params):
        return ScaleByAdaDeltaState(_zeros(params), _zeros(params))

    def update(updates, state, params=None):
        e_g = {k: (1 - rho) * g ** 2 + rho * state.e_g[k] for k, g in updates.items()}
        out = {k: (torch.sqrt(state.e_x[k] + eps) / torch.sqrt(e_g[k] + eps)) * g
               for k, g in updates.items()}
        e_x = {k: (1 - rho) * u ** 2 + rho * state.e_x[k] for k, u in out.items()}
        return out, ScaleByAdaDeltaState(e_g, e_x)

    return GradientTransformation(init, update)


def scale_by_trust_ratio():
    def update(updates, state, params=None):
        out = {}
        for k, u in updates.items():
            p_norm = torch.sqrt(torch.sum(params[k] * params[k]))
            u_norm = torch.sqrt(torch.sum(u * u))
            ratio = p_norm / u_norm
            out[k] = u * torch.where((p_norm == 0.0) | (u_norm == 0.0), 1.0, ratio)
        return out, state

    return GradientTransformation(_empty_init, update)


def trace(decay: float):
    def update(updates, state, params=None):
        new = {k: g + decay * state.trace[k] for k, g in updates.items()}
        return new, TraceState(new)

    return GradientTransformation(lambda params: TraceState(_zeros(params)), update)


def _lr(learning_rate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else float(_F(learning_rate))


def madgrad(learning_rate, momentum: float = 0.9, eps: float = 1e-6):
    """MADGRAD, as the JAX package's transform writes it."""
    def init(params):
        return MadgradState(0, _zeros(params), _zeros(params),
                            {k: v.clone() for k, v in params.items()})

    def update(updates, state, params=None):
        k = state.count
        lamb = float(_F(_lr(learning_rate, k)) * np.sqrt(_F(k) + _F(1.0)))
        gs = {n: state.grad_sum[n] + lamb * g for n, g in updates.items()}
        gss = {n: state.grad_sum_sq[n] + lamb * g * g for n, g in updates.items()}
        out = {}
        for n, p in params.items():
            rms = gss[n].pow(1.0 / 3.0) + eps
            z = state.x0[n] - gs[n] / rms
            out[n] = (momentum * p + (1 - momentum) * z) - p
        return out, MadgradState(k + 1, gs, gss, state.x0)

    return GradientTransformation(init, update)


def _flax_rows(key: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` in the flax layout (a 4-D kernel as HWIO) as (shape[0], -1)."""
    if key.split(".")[-1] == "kernel" and t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return t.reshape(t.shape[0], -1)


def _from_flax_rows(key: str, rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if key.split(".")[-1] == "kernel" and like.dim() == 4:
        o, i, h, w = like.shape
        return rows.reshape(h, w, i, o).permute(3, 2, 0, 1)
    return rows.reshape(like.shape)


def adamp(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, delta: float = 0.1, wd_ratio: float = 0.1,
          mask: dict | None = None):
    """AdamP, as the JAX package's transform writes it: Adam projected onto
    the tangent space of scale-invariant weights (per row of the flax
    layout) when the gradient-weight cosine is below delta / sqrt(dim)."""
    def init(params):
        return AdampState(0, _zeros(params), _zeros(params))

    def project(key, p, perturb):
        if p.dim() < 2:
            return perturb, 1.0
        pv, gv = _flax_rows(key, p), _flax_rows(key, perturb)
        dot = torch.sum(pv * gv, dim=1)
        cos = dot.abs() / (torch.linalg.norm(pv, dim=1) * torch.linalg.norm(gv, dim=1) + eps)
        apply = torch.max(cos) < delta / np.sqrt(pv.shape[1])
        p_n = pv / (torch.linalg.norm(pv, dim=1, keepdim=True) + eps)
        projected = gv - p_n * torch.sum(p_n * gv, dim=1, keepdim=True)
        out = _from_flax_rows(key, torch.where(apply, projected, gv), p)
        return out, torch.where(apply, wd_ratio, 1.0)

    def update(updates, state, params=None):
        count = state.count + 1
        lr = _lr(learning_rate, state.count)
        bc1 = _F(1.0) - _F(_power(b1, count))
        bc2 = _F(1.0) - _F(_power(b2, count))
        mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in updates.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g * g for k, g in updates.items()}
        out = {}
        for k, p in params.items():
            denom = torch.sqrt(nu[k]) / float(np.sqrt(bc2)) + eps
            perturb, wd = project(k, p, mu[k] / denom)
            new = -float(_F(lr) / bc1) * perturb
            if weight_decay > 0 and (mask is None or mask[k]):
                new = new - float(_F(lr) * _F(weight_decay)) * wd * p
            out[k] = new
        return out, AdampState(count, mu, nu)

    return GradientTransformation(init, update)


def lookahead(inner: GradientTransformation, sync_period: int = 6,
              slow_step_size: float = 0.5) -> GradientTransformation:
    """Every ``sync_period`` updates, pull the weights halfway back toward
    a slow copy and make that the new slow copy (the JAX package's own
    wrapper, timm's Lookahead)."""
    def init(params):
        return LookaheadState(0, {k: v.clone() for k, v in params.items()},
                              inner.init(params))

    def update(updates, state, params=None):
        updates, inner_state = inner.update(updates, state.inner, params)
        count = state.count + 1
        if count % sync_period:
            return updates, LookaheadState(count, state.slow, inner_state)
        slow = {k: s + slow_step_size * ((params[k] + updates[k]) - s)
                for k, s in state.slow.items()}
        return ({k: slow[k] - params[k] for k in updates},
                LookaheadState(count, slow, inner_state))

    return GradientTransformation(init, update)


class MultiSteps:
    """Gradient accumulation (``optax.MultiSteps``, gradient mean): the
    running mean of ``every_k`` gradients goes through the inner
    transformation on every k-th call; the other calls return zero
    updates and leave the inner state as it was."""

    def __init__(self, opt: GradientTransformation, every_k_schedule: int):
        self.inner_opt = opt
        self.every_k = every_k_schedule

    def init(self, params) -> MultiStepsState:
        return MultiStepsState(0, 0, self.inner_opt.init(params), _zeros(params))

    def update(self, updates, state: MultiStepsState, params=None):
        n = state.mini_step
        acc = {k: state.acc_grads[k] + (g - state.acc_grads[k]) / (n + 1)
               for k, g in updates.items()}
        if n != self.every_k - 1:
            return (_zeros(updates),
                    MultiStepsState(n + 1, state.gradient_step, state.inner_opt_state, acc))
        final, inner_state = self.inner_opt.update(acc, state.inner_opt_state, params)
        return final, MultiStepsState(0, state.gradient_step + 1, inner_state, _zeros(acc))


def decay_mask(params) -> dict:
    """True where weight decay applies: ndim > 1 (biases and other 1-D
    leaves are exempt)."""
    return {k: v.dim() > 1 for k, v in params.items()}


def create_optimizer(params, opt: str = "adamw", lr: float = 5e-4,
                     weight_decay: float = 0.0, momentum: float = 0.9,
                     filter_bias_and_bn: bool = True, schedule: Callable | None = None,
                     grad_clip: float = 0.0, accum_grad: int = 1, **kwargs):
    """The update chain: clip -> optimizer (decay mask) -> lookahead ->
    accumulation, for adamw, adam, adamp, adadelta, adagrad, lamb, madgrad,
    sgd and the ``lookahead_`` prefix."""
    learning_rate = schedule if schedule is not None else lr
    mask = decay_mask(params) if (filter_bias_and_bn and weight_decay) else None
    wd = weight_decay
    use_lookahead = opt.startswith("lookahead_")
    if use_lookahead:
        opt = opt[len("lookahead_"):]

    if opt == "adamw":
        tx = chain(scale_by_adam(), add_decayed_weights(wd, mask),
                   scale_by_learning_rate(learning_rate))
    elif opt == "adam":
        tx = chain(scale_by_adam(), scale_by_learning_rate(learning_rate))
    elif opt == "adamp":
        tx = adamp(learning_rate, weight_decay=wd, mask=mask)
    elif opt == "adadelta":
        tx = chain(add_decayed_weights(0.0), scale_by_adadelta(),
                   scale_by_learning_rate(learning_rate))
    elif opt == "adagrad":
        tx = chain(scale_by_rss(), scale_by_learning_rate(learning_rate))
    elif opt == "lamb":
        tx = chain(scale_by_adam(eps=1e-6), add_decayed_weights(wd, mask),
                   scale_by_trust_ratio(), scale_by_learning_rate(learning_rate))
    elif opt == "madgrad":
        tx = madgrad(learning_rate, momentum=momentum)
    elif opt == "sgd":
        tx = chain(trace(momentum) if momentum is not None else identity(),
                   scale_by_learning_rate(learning_rate))
    else:
        raise ValueError(f"unknown optimizer {opt!r}")

    tx = chain(*([clip_by_global_norm(grad_clip)] if grad_clip and grad_clip > 0 else []), tx)
    if use_lookahead:
        tx = lookahead(tx, sync_period=6, slow_step_size=0.5)
    if accum_grad > 1:
        tx = MultiSteps(tx, every_k_schedule=accum_grad)
    return tx


def optimizer_from_config(config, params):
    from .schedule import schedule_from_config

    oc = dict(config["optimizer"])
    schedule = schedule_from_config(config) if config.get("scheduler", True) else None
    return create_optimizer(
        params, opt=oc.get("opt", "adamw"), lr=oc.get("lr", 5e-4),
        weight_decay=oc.get("weight_decay", 0.0), momentum=oc.get("momentum", 0.9),
        filter_bias_and_bn=config.get("filter_bias_and_bn", True), schedule=schedule,
        grad_clip=config.get("grad_clip", 0.0), accum_grad=config.get("accum_grad", 1))


# --- the optax state layout ------------------------------------------------

def state_to_flax(state) -> Any:
    """An optimizer state in ``flax.serialization.to_state_dict``'s layout
    of the matching optax state: NamedTuples as {field: ...}, tuples as
    {"0": ...}, parameter trees as flax nested dicts, counts as int32."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return {f: state_to_flax(getattr(state, f)) for f in state._fields}
    if isinstance(state, tuple):
        return {str(i): state_to_flax(s) for i, s in enumerate(state)}
    if isinstance(state, dict):
        return tree_to_flax(state)
    if isinstance(state, int):
        return np.asarray(state, np.int32)
    raise TypeError(f"unexpected optimizer state leaf {type(state).__name__}")


def state_from_flax(template, tree, where: str = "opt_state"):
    """The inverse of ``state_to_flax`` onto ``template`` (this
    optimizer's own ``init`` state): each tree takes the template's keys,
    shapes and device.  Raises ValueError naming the first place where
    ``tree`` does not fit."""
    def fit(keys, want):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where}: expected keys {sorted(want)}, got {got}")

    if isinstance(template, tuple) and hasattr(template, "_fields"):
        fit(tree, template._fields)
        return type(template)(*[state_from_flax(getattr(template, f), tree[f], f"{where}/{f}")
                                for f in template._fields])
    if isinstance(template, tuple):
        fit(tree, [str(i) for i in range(len(template))])
        return tuple(state_from_flax(t, tree[str(i)], f"{where}/{i}")
                     for i, t in enumerate(template))
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where}: expected a parameter tree, got {type(tree).__name__}")
        try:
            return tree_from_flax(tree, template)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
    if isinstance(template, int):
        arr = np.asarray(tree)
        if arr.shape != () or arr.dtype.kind not in "iu":
            raise ValueError(f"{where}: expected an integer count, got {arr.dtype} {arr.shape}")
        return int(arr)
    raise TypeError(f"unexpected optimizer state leaf {type(template).__name__}")
