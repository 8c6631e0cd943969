"""Core functional layers: dense, batch norm, MLP stacks, dropout and
layer norm.

Params are plain nested dicts of tensors with the reference layout: a dense
layer is ``{"w": [in, out], "b": [out]}``, an MLP is ``{"layer{i}":
{"dense": ..., "bn": ...}, "out": {"dense": ..., "bn": ...}}`` (``"bn"``
only with batch norm).  Initializers take an explicit ``torch.Generator``
and create their tensors on the generator's device.  Batch norm's moving
statistics live in a separate ``state`` tree, ``{"layer{i}":
{"moving_mean", "moving_var"}, ...}``, which ``bn_state`` builds from the
params; without batch norm the state is ``{}``.

Numerical semantics follow ``cikm2020_dmt_tpu/nn/layers.py``: dense towers
use truncated-normal(0.1) weights and a constant bias, transformer and
embedding weights glorot-uniform, batch norm eps=1e-4 inside the inverse
square root with the population variance and moving statistics that start
at zero, and layer norm puts eps=1e-8 inside the square root with float32
statistics.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core import mesh as meshlib

Params = dict
State = dict
Init = Callable[[torch.Generator, tuple, torch.dtype], torch.Tensor]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of a param tree (nested dicts and
    lists; tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def truncated_normal(stddev: float = 0.1) -> Init:
    """stddev * N(0, 1) truncated to [-2, 2]."""
    def init(gen, shape, dtype=torch.float32):
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                    2.0 * stddev, generator=gen)
        return t.to(dtype)
    return init


def glorot_uniform() -> Init:
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), fans from the last
    two dims (tf.layers.dense / xavier default)."""
    def init(gen, shape, dtype=torch.float32):
        limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        t = torch.empty(shape, dtype=dtype, device=gen.device)
        return t.uniform_(-limit, limit, generator=gen)
    return init


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               w_init: Optional[Init] = None, bias_init: float = 0.0,
               dtype=torch.float32) -> Params:
    w_init = w_init or truncated_normal(0.1)
    return {
        "w": w_init(gen, (in_dim, out_dim), dtype),
        "b": torch.full((out_dim,), bias_init, dtype=dtype, device=gen.device),
    }


def dense_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


def dropout_keep(gen: torch.Generator, x: torch.Tensor,
                 keep_prob: float) -> torch.Tensor:
    """tf.nn.dropout semantics: keep each element with probability
    ``keep_prob`` and scale the kept ones by ``1 / keep_prob``.  The draw
    comes from ``gen``, which must live on ``x``'s device."""
    if keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dropout_rate(gen: torch.Generator, x: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """tf.layers.dropout semantics: drop each element with probability
    ``rate``."""
    return dropout_keep(gen, x, 1.0 - rate)


# ---------------------------------------------------------------------------
# Batch norm (the reference's hand-rolled one, moving stats in a state tree)
# ---------------------------------------------------------------------------


def batchnorm_init(gen: torch.Generator, dim: int,
                   dtype=torch.float32) -> Params:
    init = truncated_normal(0.1)
    return {"scale": init(gen, (dim,), dtype),
            "shift": init(gen, (dim,), dtype)}


def bn_state(params):
    """The zero moving statistics of every batch-norm layer of a param
    tree, in the reference's state tree: a dict holding ``"bn"`` becomes
    ``{"moving_mean", "moving_var"}`` (zeros in the param dtype), a
    subtree without batch norm is left out, so a model without it has the
    state ``{}``."""
    if isinstance(params, dict):
        if "bn" in params:
            z = params["bn"]["scale"]
            return {"moving_mean": torch.zeros_like(z),
                    "moving_var": torch.zeros_like(z)}
        out = {k: bn_state(v) for k, v in params.items()}
        return {k: v for k, v in out.items() if v}
    if isinstance(params, (list, tuple)):
        out = [bn_state(v) for v in params]
        return out if any(out) else {}
    return {}


def batchnorm_apply(params: Params, state: State, x: torch.Tensor, *,
                    train: bool, decay: float, eps: float = 1e-4
                    ) -> tuple[torch.Tensor, State]:
    """``(x - mean) * rsqrt(var + eps) * scale + shift`` over the batch
    axis.  In training the batch's mean and population variance (summed in
    float32, kept in x's dtype) normalize, and the moving statistics
    become ``moving * decay + batch * (1 - decay)`` (no gradient flows into
    them); in eval the moving statistics normalize, cast to x's dtype.
    During a step on a data mesh (``core.mesh.active``) the statistics are
    the global batch's, as in the JAX package."""
    if train:
        xf = x.float()
        mesh = meshlib.current()
        if mesh is None:
            mean = xf.mean(dim=0).to(x.dtype)
            var = xf.var(dim=0, unbiased=False).to(x.dtype)
        else:
            # the global batch's statistics (each rank holds an equal
            # slice): the sum, then the sum of squared deviations from
            # the global mean, over every rank, with their gradient
            n = xf.shape[0] * mesh.size
            mean32 = meshlib.all_reduce_sum(xf.sum(dim=0), mesh) / n
            dev = xf - mean32
            var = (meshlib.all_reduce_sum((dev * dev).sum(dim=0), mesh)
                   / n).to(x.dtype)
            mean = mean32.to(x.dtype)
        new_state = {
            "moving_mean": (state["moving_mean"] * decay
                            + mean.detach() * (1 - decay)),
            "moving_var": (state["moving_var"] * decay
                           + var.detach() * (1 - decay))}
    else:
        mean, var = state["moving_mean"], state["moving_var"]
        new_state = state
    inv = torch.rsqrt(var.to(x.dtype) + eps)
    y = ((x - mean.to(x.dtype)) * inv * params["scale"].to(x.dtype)
         + params["shift"].to(x.dtype))
    return y, new_state


# ---------------------------------------------------------------------------
# MLP stack: reference dense layers (dense -> bn -> activation -> dropout),
# hidden relu layers and an optional linear output
# ---------------------------------------------------------------------------


def dense_layer_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                     bias_init: float, is_bn: bool = False,
                     w_init: Optional[Init] = None,
                     dtype=torch.float32) -> Params:
    params: Params = {"dense": dense_init(gen, in_dim, out_dim,
                                          w_init=w_init, bias_init=bias_init,
                                          dtype=dtype)}
    if is_bn:
        params["bn"] = batchnorm_init(gen, out_dim, dtype)
    return params


def dense_layer_apply(params: Params, state: State, x: torch.Tensor, *,
                      relu: bool, keep_prob: float = 1.0,
                      train: bool = False, is_bn: bool = False,
                      is_dropout: bool = False, bn_decay: float = 0.999,
                      gen: Optional[torch.Generator] = None
                      ) -> tuple[torch.Tensor, State]:
    y = dense_apply(params["dense"], x)
    new_state = state
    if is_bn:
        y, new_state = batchnorm_apply(params["bn"], state, y, train=train,
                                       decay=bn_decay)
    if relu:
        y = torch.relu(y)
    if is_dropout and train and keep_prob < 1.0:
        y = dropout_keep(gen, y, keep_prob)
    return y, new_state


def mlp_init(gen: torch.Generator, in_dim: int, hidden: tuple[int, ...],
             out_dim: Optional[int], *, is_bn: bool = False,
             out_bias_init: float = 0.0, hidden_bias_init: float = 0.1,
             w_init: Optional[Init] = None, dtype=torch.float32) -> Params:
    """With ``is_bn`` every layer, the output included, has a batch norm
    after its dense product; ``bn_state`` gives its moving statistics."""
    params: Params = {}
    dim = in_dim
    for i, size in enumerate(hidden):
        params[f"layer{i}"] = dense_layer_init(
            gen, dim, size, bias_init=hidden_bias_init, is_bn=is_bn,
            w_init=w_init, dtype=dtype)
        dim = size
    if out_dim is not None:
        params["out"] = dense_layer_init(
            gen, dim, out_dim, bias_init=out_bias_init, is_bn=is_bn,
            w_init=w_init, dtype=dtype)
    return params


def mlp_apply(params: Params, state: State, x: torch.Tensor, *,
              keep_probs: tuple[float, ...] = (), train: bool = False,
              is_bn: bool = False, is_dropout: bool = False,
              bn_decay: float = 0.999,
              gen: Optional[torch.Generator] = None
              ) -> tuple[torch.Tensor, State]:
    """Relu hidden layers, linear output; returns (y, new state).  In
    training with ``is_dropout``, hidden layer i keeps with
    ``keep_probs[i]``."""
    new_state: State = {}
    y = x
    n_hidden = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_hidden):
        name = f"layer{i}"
        kp = keep_probs[i] if i < len(keep_probs) else 1.0
        y, st = dense_layer_apply(
            params[name], state.get(name, {}), y, relu=True, keep_prob=kp,
            train=train, is_bn=is_bn, is_dropout=is_dropout,
            bn_decay=bn_decay, gen=gen)
        if st:
            new_state[name] = st
    if "out" in params:
        y, st = dense_layer_apply(
            params["out"], state.get("out", {}), y, relu=False, train=train,
            is_bn=is_bn, bn_decay=bn_decay)
        if st:
            new_state["out"] = st
    return y, new_state


# ---------------------------------------------------------------------------
# Layer norm
# ---------------------------------------------------------------------------


def layer_norm_init(gen: torch.Generator, dim: int,
                    dtype=torch.float32) -> Params:
    return {"gamma": torch.ones((dim,), dtype=dtype, device=gen.device),
            "beta": torch.zeros((dim,), dtype=dtype, device=gen.device)}


def layer_norm_apply(params: Params, x: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """Reference ln: eps inside the sqrt, population variance, float32
    statistics whatever the input dtype; the output keeps x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normalized = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return (params["gamma"].to(x.dtype) * normalized
            + params["beta"].to(x.dtype))
