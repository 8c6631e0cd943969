"""The learning-rate schedule and the dense optimizers
(``cikm2020_dmt_tpu/train/optim.py`` ``make_optimizer``).

``make_optimizer(cfg)`` gives an ``Optimizer``: ``init(params)`` the state
(tensors on the params' device, the step count a tensor, so a step needs
no host synchronisation) and ``update(params, grads, state)`` the new
params and state.  Each one is optax's formula (the JAX package's
optimizers), not ``torch.optim``'s, which puts eps elsewhere:

- ``adam``: the reference's ``f32_math(optax.adam(...))`` written out:
  float32 moments whatever the parameter type, float32 update math, and
  for a low-precision (bfloat16) parameter the update is rounded to its
  type and then added in that type, two roundings, as optax's
  ``apply_updates`` does (``torch.optim.Adam`` keeps bfloat16 moments);
  on the card one multi-tensor kernel does every leaf's step
  (``ops/adam.py``), with the same bits as the step leaf by leaf;
- ``sgd``, ``adagrad`` (accumulator from 0.1, ``g * rsqrt(acc + 1e-7)``
  where acc > 0), ``rmsprop`` (decay 0.9, eps 1e-10 inside the root),
  ``adadelta`` (rho 0.9, eps 1e-6) and ``ftrl`` (the JAX package's
  FTRL-Proximal): state in the parameter's type, as optax keeps it; the
  learning rate is cast to the gradient's type before it scales it.

State keys: adam ``m``, ``v``, ``count``; sgd ``count``; adagrad
``sum_of_squares``, ``count``; rmsprop ``nu``, ``count``; adadelta
``e_g``, ``e_x``, ``count``; ftrl ``n``, ``z``, ``step``.  ``count`` is
the update count before this step (it picks the rate); ftrl picks it by
its step after the increment, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.config import DMTConfig
from ..nn.layers import tree_map
from ..ops.adam import B1, B2, adam_dense


def piecewise_constant(boundaries, rates):
    """lr(step) = rates[i] for step in (boundaries[i-1], boundaries[i]]
    (tf.train.piecewise_constant); a rates list shorter than
    len(boundaries) + 1 is padded with its last rate.  ``step`` is an
    integer tensor; the rate comes back as a float32 tensor on its
    device."""
    rates = tuple(rates) + (rates[-1],) * (len(boundaries) + 1 - len(rates))

    def schedule(step: torch.Tensor) -> torch.Tensor:
        b = torch.tensor(boundaries, dtype=torch.int64, device=step.device)
        r = torch.tensor(rates, dtype=torch.float32, device=step.device)
        return r[(step > b).sum()]

    return schedule


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (params, grads, state) -> (params, state)


def _device(params) -> torch.device:
    """The device of the first tensor of a param tree."""
    if isinstance(params, torch.Tensor):
        return params.device
    for sub in (params.values() if isinstance(params, dict) else params):
        device = _device(sub)
        if device is not None:
            return device
    return None


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=_device(params))


def adam_init(params) -> dict:
    """Zero float32 moments for every leaf, and the update count."""
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": _count(params)}


def adam_update(params, grads, state: dict, schedule):
    """One Adam step on every leaf; returns (new params, new state).
    ``grads`` has the tree of ``params``; lr = schedule(count) with the
    pre-increment count, bias correction by count + 1 (optax).  The leaves
    go through ``ops/adam.py`` ``adam_dense``: those on the card into a few
    launches of one kernel, those on the CPU one by one."""
    count, lr, bc1, bc2 = adam_scalars(state["count"], schedule)
    new = iter(adam_dense(zip_leaves(params, grads, state["m"], state["v"]),
                          lr, bc1, bc2))
    new_p, m, v = _map_leaves(lambda _: next(new), 3, params)
    return new_p, {"m": m, "v": v, "count": count}


def adam_scalars(count: torch.Tensor, schedule):
    """The step after ``count`` updates: (count + 1, its rate, the bias
    corrections 1 - b1^(count + 1) and 1 - b2^(count + 1)), tensors on
    ``count``'s device."""
    after = count + 1
    lr = schedule(count)
    c = after.float()
    bc1 = 1.0 - torch.pow(torch.tensor(B1, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, device=c.device), c)
    return after, lr, bc1, bc2


def zip_leaves(*trees) -> list:
    """The tuples of the leaves of trees of one structure, in the order in
    which ``_map_leaves`` visits them."""
    out = []
    _map_leaves(lambda *leaf: out.append(leaf) or (), 0, *trees)
    return out


def _map_leaves(fn, n_out: int, *trees):
    """``fn(*leaves) -> n_out values`` over the leaves of trees of one
    structure; returns the ``n_out`` result trees."""
    first = trees[0]
    if isinstance(first, dict):
        parts = {k: _map_leaves(fn, n_out, *(t[k] for t in trees))
                 for k in first}
        return tuple({k: r[i] for k, r in parts.items()}
                     for i in range(n_out))
    if isinstance(first, (list, tuple)):
        parts = [_map_leaves(fn, n_out, *args) for args in zip(*trees)]
        return tuple([r[i] for r in parts] for i in range(n_out))
    return fn(*trees)


def _k(value: float, like: torch.Tensor):
    """A constant in ``like``'s type: JAX rounds a Python constant to a
    bfloat16 operand's type before the operation, torch would use it
    unrounded."""
    if like.dtype == torch.float32:
        return value
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _scaled(schedule, count, updates):
    """optax ``scale_by_learning_rate``: -lr(count), cast to each
    update's type, times the update."""
    neg = -schedule(count)
    return tree_map(lambda u: neg.to(u.dtype) * u, updates)


def _apply(params, updates):
    """optax ``apply_updates``: p + u, in p's type."""
    return _map_leaves(lambda p, u: ((p + u).to(p.dtype),), 1, params,
                       updates)[0]


def _sgd(schedule) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(params, grads, state):
        count = state["count"]
        return (_apply(params, _scaled(schedule, count, grads)),
                {"count": count + 1})

    return Optimizer(init, update)


def _adagrad(schedule, initial: float = 0.1, eps: float = 1e-7
             ) -> Optimizer:
    """optax ``adagrad``: ``scale_by_rss`` then the rate."""
    def init(params):
        return {"sum_of_squares": tree_map(
                    lambda t: torch.full_like(t, initial), params),
                "count": _count(params)}

    def leaf(g, acc):
        acc = g * g + acc
        inv = torch.where(acc > 0, torch.rsqrt(acc + _k(eps, acc)),
                          torch.zeros((), dtype=acc.dtype, device=acc.device))
        return inv * g, acc

    def update(params, grads, state):
        u, acc = _map_leaves(leaf, 2, grads, state["sum_of_squares"])
        count = state["count"]
        return (_apply(params, _scaled(schedule, count, u)),
                {"sum_of_squares": acc, "count": count + 1})

    return Optimizer(init, update)


def _rmsprop(schedule, decay: float = 0.9, eps: float = 1e-10
             ) -> Optimizer:
    """optax ``rmsprop``: ``scale_by_rms`` (eps inside the root, no bias
    correction, nu from 0) then the rate."""
    def init(params):
        return {"nu": tree_map(torch.zeros_like, params),
                "count": _count(params)}

    def leaf(g, nu):
        nu = _k(1 - decay, g) * (g * g) + _k(decay, nu) * nu
        return torch.rsqrt(nu + _k(eps, nu)) * g, nu

    def update(params, grads, state):
        u, nu = _map_leaves(leaf, 2, grads, state["nu"])
        count = state["count"]
        return (_apply(params, _scaled(schedule, count, u)),
                {"nu": nu, "count": count + 1})

    return Optimizer(init, update)


def _adadelta(schedule, rho: float = 0.9, eps: float = 1e-6) -> Optimizer:
    """optax ``adadelta``: ``scale_by_adadelta`` then the rate (its weight
    decay is 0)."""
    def init(params):
        return {"e_g": tree_map(torch.zeros_like, params),
                "e_x": tree_map(torch.zeros_like, params),
                "count": _count(params)}

    def leaf(g, e_g, e_x):
        c, r, e = _k(1 - rho, g), _k(rho, g), _k(eps, g)
        e_g = c * (g * g) + r * e_g
        u = torch.sqrt(e_x + e) / torch.sqrt(e_g + e) * g
        return u, e_g, c * (u * u) + r * e_x

    def update(params, grads, state):
        u, e_g, e_x = _map_leaves(leaf, 3, grads, state["e_g"],
                                  state["e_x"])
        count = state["count"]
        return (_apply(params, _scaled(schedule, count, u)),
                {"e_g": e_g, "e_x": e_x, "count": count + 1})

    return Optimizer(init, update)


def _ftrl(schedule, initial: float = 0.1) -> Optimizer:
    """The JAX package's FTRL-Proximal (tf.train.FtrlOptimizer defaults:
    learning-rate power -0.5, no l1 or l2), rate by the incremented step.
    The rate is a float32 tensor, so the sums that meet it (sigma, z and
    the new weight) are float32, as JAX promotes them; the new weight is
    applied as ``w + (w_new - w)`` in the param's type."""
    def init(params):
        return {"n": tree_map(lambda t: torch.full_like(t, initial), params),
                "z": tree_map(torch.zeros_like, params),
                "step": _count(params)}

    def update(params, grads, state):
        step = state["step"] + 1
        lr = schedule(step)

        def leaf(w, g, n, z):
            n_new = n + g * g
            root = n_new.pow(0.5)
            sigma = (root - n.pow(0.5)).float() / lr
            z_new = z + g - sigma * w
            w_new = torch.where(z_new.abs() <= 0.0,
                                torch.zeros_like(z_new),
                                -z_new / (root.float() / lr + 0.0))
            return (w + (w_new - w)).to(w.dtype), n_new, z_new

        new_p, n, z = _map_leaves(leaf, 3, params, grads, state["n"],
                                  state["z"])
        return new_p, {"n": n, "z": z, "step": step}

    return Optimizer(init, update)


def make_optimizer(cfg: DMTConfig) -> Optimizer:
    """The optimizer ``cfg.optimizer`` names, on the piecewise-constant
    schedule of ``cfg.step_boundary`` / ``cfg.learning_rate``."""
    schedule = piecewise_constant(cfg.step_boundary, cfg.learning_rate)
    name = cfg.optimizer.lower()
    if name == "adam":
        return Optimizer(adam_init, lambda params, grads, state: adam_update(
            params, grads, state, schedule))
    makers = {"sgd": _sgd, "adagrad": _adagrad, "rmsprop": _rmsprop,
              "adadelta": _adadelta, "ftrl": _ftrl}
    if name not in makers:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return makers[name](schedule)
