"""The learning-rate schedule and the dense Adam update
(``cikm2020_dmt_tpu/train/optim.py``).

``adam_update`` is the reference's ``f32_math(optax.adam(...))`` written
out: float32 moments whatever the parameter type, float32 update math, and
for a low-precision (bfloat16) parameter the update is rounded to its type
and then added in that type, two roundings, as optax's ``apply_updates``
does.  ``torch.optim.Adam`` is not that function: on bfloat16 parameters
it keeps bfloat16 moments.  All state stays on the device (the step count
is a tensor), so a step needs no host synchronisation.
"""

from __future__ import annotations

import torch

from ..nn.layers import tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8  # TF1 AdamOptimizer defaults


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


def adam_init(params) -> dict:
    """Zero float32 moments for every leaf, and the update count."""
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    device = params["emb"][next(iter(params["emb"]))].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int64, device=device)}


def adam_update(params, grads, state: dict, schedule):
    """One Adam step on every leaf; returns (new params, new state).
    ``grads`` has the tree of ``params``; lr = schedule(count) with the
    pre-increment count, bias correction by count + 1 (optax)."""
    count = state["count"] + 1
    lr = schedule(state["count"])
    c = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(B1, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, device=c.device), c)

    def leaf(p, g, m, v):
        g32 = g.float()
        m_new = (1.0 - B1) * g32 + B1 * m
        v_new = (1.0 - B2) * (g32 * g32) + B2 * v
        u = (-lr) * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS))
        return p + u.to(p.dtype), m_new, v_new

    new_p, m, v = _map3(leaf, params, grads, state["m"], state["v"])
    return new_p, {"m": m, "v": v, "count": count}


def _map3(fn, p, g, m, v):
    """``fn(p, g, m, v) -> (p', m', v')`` over the leaves of four trees of
    one structure; returns the three result trees."""
    if isinstance(p, dict):
        parts = {k: _map3(fn, p[k], g[k], m[k], v[k]) for k in p}
        return tuple({k: r[i] for k, r in parts.items()} for i in range(3))
    if isinstance(p, (list, tuple)):
        parts = [_map3(fn, *args) for args in zip(p, g, m, v)]
        return tuple([r[i] for r in parts] for i in range(3))
    return fn(p, g, m, v)
