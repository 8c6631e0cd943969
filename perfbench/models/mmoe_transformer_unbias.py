"""DMT's ``mmoe_transformer_unbias`` in the benchmark: its own keys of the
frozen ``.conf``, what its plain reference covers, and the reference
(``reference/model.py``) and work counts (``work.py``) it hands on to.
The interface is ``perfbench/models/__init__.py``'s."""

from __future__ import annotations

import dataclasses

from .. import work
from ..modelconf import ModelConf, floats, ints
from ..reference import model
from ..work import request_ops, train_step_ops  # noqa: F401 - the interface

WIDTHS = {"d_model": 80, "d_ff": 320, "num_heads": 4}


@dataclasses.dataclass(kw_only=True)
class Conf(ModelConf):
    hidden_bottom: tuple
    hidden_task: tuple
    hidden_bias: tuple
    num_experts: int
    d_model: int
    d_ff: int
    num_heads: int
    blocks_encode: int
    blocks_decode: int
    maxlen_k: int
    dropout: float
    position: str
    dropout_rate_bias: tuple
    loss_weight: tuple
    loss_unbias_method: str
    loss_ctr_rel_method: str
    export_weight: tuple


def read(cp) -> dict:
    def get(section, key):
        return cp.get(section, key).strip()

    def model(key):
        return get("model", key)

    def tr(key):
        return model("transformer_" + key)

    return dict(
        hidden_bottom=ints(model("hidden_units_bottom")),
        hidden_task=ints(model("hidden_units_task")),
        hidden_bias=ints(model("hidden_units_bias")),
        num_experts=int(model("num_experts")),
        d_model=int(tr("d_model")),
        d_ff=int(tr("d_ff")),
        num_heads=int(tr("num_heads")),
        blocks_encode=int(tr("num_blocks_encode")),
        blocks_decode=int(tr("num_blocks_decode")),
        maxlen_k=int(tr("maxlen_k")),
        dropout=float(tr("dropout_rate")),
        position=tr("position_encoding_method"),
        dropout_rate_bias=floats(model("dropout_rate_bias")),
        loss_weight=floats(get("parameter", "loss_weight")),
        loss_unbias_method=model("loss_unbias_method"),
        loss_ctr_rel_method=model("loss_ctr_rel_method"),
        export_weight=floats(get("export_model", "export_weight")))


def check(conf, cp) -> None:
    if conf.position != "position_learn":
        raise ValueError(f"{conf.name}: the plain reference covers position "
                         f"'position_learn', not {conf.position!r}")
    for key in ("is_bn", "is_dropout", "transformer_is_trans_input_by_mlp",
                "transformer_is_trans_out_concat_item",
                "transformer_is_decoder_add_pos_emb", "propensity_em"):
        if (cp.has_option("model", key)
                and cp.get("model", key).strip().lower() == "true"):
            raise ValueError(f"{conf.name}: the plain reference does not "
                             f"cover {key} = true")


layout = model.layout


def forward(conf, params, batch, lookups, *, train, gen=None):
    """((click, order), bias) logits; serving's forward leaves out the
    bias net (bias None)."""
    return model.forward(conf, params, batch, lookups, train=train, gen=gen,
                         with_bias=train)


def loss(conf, out, batch):
    return model.loss(conf, out[0], out[1], batch["mask"])


def scores(conf, out):
    return model.scores(conf, out[0])


def train_kernel_s(conf, lens_list) -> dict:
    """The fused block's work on 1 + 1 stacks, the attention kernels' on
    the others."""
    D, F = conf.d_model, conf.d_ff
    out = {"block_s": 0.0, "attention_s": 0.0}
    for lens in lens_list:
        for t in work.group_lens(conf, lens):
            if conf.blocks_encode == 1 and conf.blocks_decode == 1:
                out["block_s"] += work.least_s(*work.block_train_work(t, D, F))
            else:
                out["attention_s"] += work.least_s(*work.attention_train_work(
                    t, D, conf.blocks_encode, conf.blocks_decode))
    return out


def serve_kernel_s(conf, lens_list, candidates) -> dict:
    """The fused block forward's work: the user's rows once a request, the
    query path once a candidate."""
    D, F = conf.d_model, conf.d_ff
    least = 0.0
    for lens in lens_list:
        for g in conf.attention_pairs:
            least += work.least_s(*work.block_serve_work(
                lens[g[0][0]], candidates, D, F))
    return {"block_s": least}
