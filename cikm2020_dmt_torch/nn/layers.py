"""Core functional layers: dense, MLP stacks, dropout and layer norm.

Params are plain nested dicts of tensors with the reference layout: a dense
layer is ``{"w": [in, out], "b": [out]}``, an MLP is ``{"layer{i}":
{"dense": ...}, "out": {"dense": ...}}``.  Initializers take an explicit
``torch.Generator`` and create their tensors on the generator's device.

Numerical semantics follow ``cikm2020_dmt_tpu/nn/layers.py``: dense towers
use truncated-normal(0.1) weights and a constant bias, transformer and
embedding weights glorot-uniform, and layer norm puts eps=1e-8 inside the
square root with float32 statistics.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Params = dict
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
# MLP stack (hidden relu layers + optional linear output)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, in_dim: int, hidden: tuple[int, ...],
             out_dim: Optional[int], *, is_bn: bool = False,
             out_bias_init: float = 0.0, hidden_bias_init: float = 0.1,
             w_init: Optional[Init] = None, dtype=torch.float32) -> Params:
    if is_bn:
        raise NotImplementedError("batch-norm MLPs are not ported yet")
    params: Params = {}
    dim = in_dim
    for i, size in enumerate(hidden):
        params[f"layer{i}"] = {"dense": dense_init(
            gen, dim, size, w_init=w_init, bias_init=hidden_bias_init,
            dtype=dtype)}
        dim = size
    if out_dim is not None:
        params["out"] = {"dense": dense_init(
            gen, dim, out_dim, w_init=w_init, bias_init=out_bias_init,
            dtype=dtype)}
    return params


def mlp_apply(params: Params, x: torch.Tensor, *,
              keep_probs: tuple[float, ...] = (), train: bool = False,
              is_dropout: bool = False,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Relu hidden layers, linear output.  In training with
    ``is_dropout``, hidden layer i keeps with ``keep_probs[i]``."""
    y = x
    n_hidden = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_hidden):
        y = torch.relu(dense_apply(params[f"layer{i}"]["dense"], y))
        kp = keep_probs[i] if i < len(keep_probs) else 1.0
        if is_dropout and train and kp < 1.0:
            y = dropout_keep(gen, y, kp)
    if "out" in params:
        y = dense_apply(params["out"]["dense"], y)
    return y


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
