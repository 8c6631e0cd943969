"""The port's ``embed_mlp`` (``models/zoo.py`` ``EmbedMLP``) as a plain
model of the benchmark, at the interface of ``perfbench/models/``: the
dense features and each id feature's mean-pooled rows, concatenated,
through a relu MLP to one logit; the single-task loss (sigmoid cross
entropy against the click label, by class weight); Scores blended from
the one probability.

Written as a module of ``perfbench/models/`` (its relative imports are
that package's): the tests point ``models.MODEL_DIR`` at this folder."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..modelconf import ModelConf, floats, ints
from ..reference import model

WIDTHS = {"hidden_units": (512, 256, 128)}


@dataclasses.dataclass(kw_only=True)
class Conf(ModelConf):
    hidden_units: tuple
    export_weight: tuple


def read(cp) -> dict:
    return dict(hidden_units=ints(cp.get("model", "hidden_units")),
                export_weight=floats(cp.get("export_model", "export_weight")))


def check(conf, cp) -> None:
    def value(key, default):
        return cp.get("model", key, fallback=default).strip().lower()

    if conf.attention_pairs or cp.get("embedding", "sim_embed",
                                      fallback="").strip():
        raise ValueError(f"{conf.name}: the plain embed_mlp pools every "
                         "feature; it covers no attention or sim features")
    for key, want in (("is_bn", "false"), ("is_dropout", "false"),
                      ("single_task_raw_label", "false"),
                      ("is_use_feature", "true"), ("output_units", "1")):
        if value(key, want) != want:
            raise ValueError(f"{conf.name}: the plain embed_mlp covers "
                             f"{key} = {want} only")
    if float(value("wnd_wd", "0")) > 1e-5:
        raise ValueError(f"{conf.name}: the plain embed_mlp has no L2 term")


def _n_in(conf) -> int:
    return conf.feature_dimension + sum(s.dim for s in conf.embeddings)


def layout(conf) -> list:
    out = [(("emb", name), (rows, dim),
            "bfloat16" if conf.table_dtype_is_bf16(rows) else "float32",
            ("uniform", math.sqrt(6.0 / (rows + dim))))
           for name, (rows, dim) in conf.tables(conf.embeddings).items()]
    dims = (_n_in(conf),) + tuple(conf.hidden_units) + (1,)
    names = [f"layer{i}" for i in range(len(conf.hidden_units))] + ["out"]
    for name, a, b in zip(names, dims, dims[1:]):
        out += [(("mlp", name, "dense", "w"), (a, b), "float32",
                 ("uniform", model.DENSE_LIMIT)),
                (("mlp", name, "dense", "b"), (b,), "float32",
                 ("const", 0.0 if name == "out" else 0.1))]
    return out


def forward(conf, params, batch, lookups, *, train, gen=None):
    """[B] logits."""
    parts = [batch["features"]]
    for s in conf.embeddings:
        grid = lookups.take(s.table, params["emb"][s.table],
                            batch[s.feature + model.IDS])
        parts.append(model.pool_mean(grid, batch[s.feature + model.WTS],
                                     batch[s.feature + model.LEN]))
    h = torch.cat(parts, -1).float()
    mlp = params["mlp"]
    for i in range(len(conf.hidden_units)):
        d = mlp[f"layer{i}"]["dense"]
        h = torch.relu(h @ d["w"] + d["b"])
    d = mlp["out"]["dense"]
    return (h @ d["w"] + d["b"]).reshape(-1)


def loss(conf, out, batch):
    mask = batch["mask"]
    xent = torch.nn.functional.binary_cross_entropy_with_logits(
        out, mask[:, 1:5].sum(-1), reduction="none")
    w = torch.tensor([v for _, v in conf.train_weight], dtype=mask.dtype,
                     device=mask.device)
    return (mask * w[None, :] * xent[:, None]).mean(0).sum()


def scores(conf, out):
    p = torch.sigmoid(out)
    w0, w1 = conf.export_weight
    return (w0 * p + w1 * p) / float(w0 + w1), p, p


def _mlp_macs(conf) -> float:
    dims = (_n_in(conf),) + tuple(conf.hidden_units) + (1,)
    return float(sum(a * b for a, b in zip(dims, dims[1:])))


def train_step_ops(conf, lens) -> float:
    B = len(next(iter(lens.values())))
    pool = sum(float(lens[s.feature].sum()) * s.dim for s in conf.embeddings)
    return 3 * 2 * (pool + B * _mlp_macs(conf))


def request_ops(conf, lens, candidates) -> float:
    pool = sum(float(lens[s.feature]) * s.dim if s.side == "u"
               else candidates * s.dim for s in conf.embeddings)
    return 2 * (pool + candidates * _mlp_macs(conf))


def train_kernel_s(conf, lens_list) -> dict:
    return {}


def serve_kernel_s(conf, lens_list, candidates) -> dict:
    return {}
