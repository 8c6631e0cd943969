"""Plain PyTorch reference of the training step: the forward and loss of
``reference/model.py``, autograd's backward, Adam on every dense leaf
(optax's formula: float32 moments, the update rounded to the leaf's type
and added in it) and LazyAdam on the touched row groups of each lazy
table (``ModelConf.lazy_tables``).  Rows of a lazy table are gathered
once per step from the id union; their gradient is the float32 sum of
the lookups' cotangents, rounded once to the table's type."""

from __future__ import annotations

import torch

from . import model

B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_at(conf, step: int, device) -> torch.Tensor:
    """Piecewise-constant rate of update number ``step`` (from 0)."""
    rates = tuple(conf.learning_rate)
    rates += (rates[-1],) * (len(conf.step_boundary) + 1 - len(rates))
    i = sum(step > b for b in conf.step_boundary)
    return torch.tensor(rates[i], dtype=torch.float32, device=device)


def leaves(tree, prefix=()):
    """(path, tensor) of every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _union(conf, batch, name, table, group):
    ids = torch.cat([batch[s.feature + model.IDS].reshape(-1).long()
                     for s in conf.embeddings if s.table == name])
    ids = ids.clamp(0, table.shape[0] - 1)
    ugroups = torch.unique(ids // group)
    uids = (ugroups[:, None] * group
            + torch.arange(group, device=ids.device)).reshape(-1)
    return ugroups, uids


class Reference:
    """The training state of the reference: params, dense Adam moments,
    lazy tables' row moments, and the update count."""

    def __init__(self, conf, params: dict):
        self.conf = conf
        self.params = params
        self.lazy = conf.lazy_tables()
        self.dense = [(p, t) for p, t in leaves(params)
                      if not (p[0] == "emb" and p[1] in self.lazy)]
        self.m = {p: torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for p, t in self.dense}
        self.v = {p: torch.zeros_like(m) for p, m in self.m.items()}
        self.mv = {n: torch.zeros((2,) + tuple(params["emb"][n].shape),
                                  dtype=torch.float32,
                                  device=params["emb"][n].device)
                   for n in self.lazy}
        self.count = 0

    def step(self, batch: dict, gen: torch.Generator, half: bool = False):
        """One step; returns (loss, {path: float32 gradient}).  ``half``
        (a planted fault) takes the mean over the first half of the batch
        only."""
        conf = self.conf
        if half:
            n = batch["mask"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        diff = {p: t.detach().requires_grad_() for p, t in self.dense}
        params: dict = {}
        for p, t in diff.items():
            model.tree_set(params, p, t)
        lazy = {}
        for name, group in self.lazy.items():
            table = self.params["emb"][name]
            ugroups, uids = _union(conf, batch, name, table, group)
            rows = table.index_select(0, uids.clamp(max=table.shape[0] - 1))
            lazy[name] = {"group": group, "ugroups": ugroups, "uids": uids,
                          "rows": rows,
                          "grid": rows.float().requires_grad_()}
            params.setdefault("emb", {})[name] = table
        logits, bias = model.forward(conf, params, batch,
                                     model.Lookups(lazy), train=True,
                                     gen=gen)
        loss = model.loss(conf, logits, bias, batch["mask"])
        wrt = list(diff.values()) + [z["grid"] for z in lazy.values()]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        out = {}
        with torch.no_grad():
            lr = lr_at(conf, self.count, loss.device)
            self.count += 1
            c = torch.tensor(float(self.count), device=loss.device)
            bc1 = 1.0 - torch.pow(torch.tensor(B1, device=c.device), c)
            bc2 = 1.0 - torch.pow(torch.tensor(B2, device=c.device), c)
            new = {}
            for (p, t), g in zip(self.dense, grads[:len(self.dense)]):
                g32 = g.float()
                out[p] = g32
                m = (1.0 - B1) * g32 + B1 * self.m[p]
                v = (1.0 - B2) * (g32 * g32) + B2 * self.v[p]
                u = (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + EPS))
                new[p] = t + u.to(t.dtype)
                self.m[p], self.v[p] = m, v
            self.dense = [(p, new[p]) for p, _ in self.dense]
            for p, t in self.dense:
                model.tree_set(self.params, p, t)
            for (name, z), g in zip(lazy.items(), grads[len(self.dense):]):
                table, mv = self.params["emb"][name], self.mv[name]
                R = table.shape[0]
                g32 = g.to(table.dtype).float()
                out[("emb", name)] = g32
                uids = z["uids"]
                keep = uids < R
                safe = uids.clamp(max=R - 1)
                mu = B1 * mv[0].index_select(0, safe) + (1.0 - B1) * g32
                vu = B2 * mv[1].index_select(0, safe) + (1.0 - B2) * g32 * g32
                mhat = mu / bc1
                vhat = vu / bc2
                pn = (z["rows"].float() - lr * mhat / (torch.sqrt(vhat) + EPS)
                      ).to(table.dtype)
                idx = uids[keep]
                table.index_copy_(0, idx, pn[keep])
                mv[0].index_copy_(0, idx, mu[keep])
                mv[1].index_copy_(0, idx, vu[keep])
        return float(loss.detach()), out


def run(conf, params: dict, batches: list, gen: torch.Generator,
        steps: int = 3, half: bool = False) -> dict:
    """``steps`` reference steps on ``batches`` in turn, from ``params``
    (updated in place where a lazy table is): each step's loss, the first
    step's gradient norm by leaf, and each leaf's change after the last
    step, as norms in float64 of float32 values."""
    initial = {p: t.detach().clone() for p, t in leaves(params)}
    ref = Reference(conf, params)
    losses, grad_norms = [], {}
    for i in range(steps):
        loss, grads = ref.step(batches[i % len(batches)], gen, half=half)
        losses.append(loss)
        if i == 0:
            grad_norms = {p: float(g.double().norm())
                          for p, g in grads.items()}
        del grads
    change = {}
    for p, t in leaves(ref.params):
        change[p] = float((t.double() - initial[p].double()).norm())
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change,
            "bf16": [p for p, t in leaves(ref.params)
                     if t.dtype == torch.bfloat16]}
