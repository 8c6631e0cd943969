"""The benchmark's own reading of a model configuration.

A configuration is two files under ``perfbench/configs/``: ``<name>.conf``,
the frozen model config in the reference's INI format, and
``<name>.json``, which names the config file, its public source, the
deployment it stands for, the sizes assumed and the keys reduced, and the
``settings``: storage and update choices that the INI format does not
carry (batch size, the row count from which a table is stored bfloat16,
the lazy-Adam plan).  Both sides of a run read the same two files: the
program through its own config loader, with ``settings`` as overrides,
and the traffic generators and the plain reference through ``load``
below, which imports nothing of the program.
"""

from __future__ import annotations

import configparser
import json
import os
import re
from dataclasses import dataclass, field

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")
_SEQ_LEN = re.compile(r"_(\d+)$")


@dataclass(frozen=True)
class Spec:
    """One entry of the embedding list ``Table:rows:dim:feature:side``."""
    table: str
    rows: int
    dim: int
    feature: str
    side: str          # "i": one id per candidate; "u": the user's row

    @property
    def max_len(self) -> int:
        """Padded length: a sequence's trailing ``_N``, 1 for ``item_*``,
        else 10."""
        m = _SEQ_LEN.search(self.feature)
        if m:
            return int(m.group(1))
        return 1 if self.feature.startswith("item_") else 10


@dataclass
class ModelConf:
    name: str
    model_type: str
    feature_dimension: int
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
    learning_rate: tuple
    step_boundary: tuple
    weight_ctr: tuple
    weight_ecvr: tuple
    train_weight: tuple
    embeddings: tuple
    embeddings_bias: tuple
    attention_pairs: tuple
    attention_ts: tuple
    zero_pad: bool
    settings: dict = field(default_factory=dict)

    @property
    def features(self) -> tuple:
        """Every id feature once (main specs first, then the bias net's),
        in the order the batch lays them out."""
        seen = {}
        for s in self.embeddings + self.embeddings_bias:
            seen.setdefault(s.feature, s)
        return tuple(seen.values())

    def tables(self, specs) -> dict:
        """Table name -> (rows, dim), in order of first use."""
        out = {}
        for s in specs:
            out.setdefault(s.table, (s.rows, s.dim))
        return out

    def table_dtype_is_bf16(self, rows: int) -> bool:
        t = int(self.settings["table_bf16_threshold"])
        return 0 < t <= rows

    def lazy_tables(self) -> dict:
        """Table -> rows updated together (the lazy-Adam unit): tables of
        at least ``dedup_rows_threshold`` rows that no timestamp feature
        reads; a group is ``128 // dim`` rows where the table is stored
        lane-packed (``pack_rows_threshold``), else 1."""
        ts = set(self.attention_ts)
        out = {}
        by_table: dict = {}
        for s in self.embeddings:
            by_table.setdefault(s.table, []).append(s)
        for name, specs in by_table.items():
            rows, dim = specs[0].rows, specs[0].dim
            if (max(s.rows for s in specs)
                    >= int(self.settings["dedup_rows_threshold"])
                    and not any(s.feature in ts for s in specs)):
                packed = rows >= int(self.settings["pack_rows_threshold"])
                out[name] = (128 // dim if packed and 128 % dim == 0
                             and dim < 128 else 1)
        return out


def _specs(text: str) -> tuple:
    out = []
    for item in (text or "").split("#"):
        item = item.strip()
        if item:
            t, r, d, f, side = item.split(":")
            out.append(Spec(t, int(r), int(d), f, side))
    return tuple(out)


def _pairs(text: str) -> tuple:
    groups = []
    for g in (text or "").split("|"):
        g = g.strip()
        if g:
            groups.append(tuple(tuple(p.split(":")) for p in g.split("#")))
    return tuple(groups)


def _weights(text: str) -> tuple:
    pairs = []
    for item in text.split(","):
        if item.strip():
            c, w = item.split(":")
            pairs.append((int(c), float(w)))
    return tuple(sorted(pairs))


def _floats(text: str) -> tuple:
    return tuple(float(x) for x in text.split(",") if x.strip())


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(",") if x.strip())


def meta(name: str) -> dict:
    """The configuration's JSON file."""
    with open(os.path.join(CONFIG_DIR, name + ".json")) as f:
        return json.load(f)


def conf_path(name: str) -> str:
    return os.path.join(CONFIG_DIR, meta(name)["conf"])


def load(name: str, **settings) -> ModelConf:
    """The configuration ``name``, with ``settings`` overriding those of
    its JSON file (tests shrink a copy this way)."""
    m = meta(name)
    cp = configparser.ConfigParser(interpolation=None)
    with open(os.path.join(CONFIG_DIR, m["conf"])) as f:
        cp.read_string(f.read())

    def get(section, key):
        return cp.get(section, key).strip()

    def model(key):
        return get("model", key)

    def tr(key):
        return model("transformer_" + key)

    st = dict(m["settings"])
    st.update(settings)
    conf = ModelConf(
        name=name,
        model_type=model("model_type"),
        feature_dimension=int(model("feature_dimension")),
        hidden_bottom=_ints(model("hidden_units_bottom")),
        hidden_task=_ints(model("hidden_units_task")),
        hidden_bias=_ints(model("hidden_units_bias")),
        num_experts=int(model("num_experts")),
        d_model=int(tr("d_model")),
        d_ff=int(tr("d_ff")),
        num_heads=int(tr("num_heads")),
        blocks_encode=int(tr("num_blocks_encode")),
        blocks_decode=int(tr("num_blocks_decode")),
        maxlen_k=int(tr("maxlen_k")),
        dropout=float(tr("dropout_rate")),
        position=tr("position_encoding_method"),
        dropout_rate_bias=_floats(model("dropout_rate_bias")),
        loss_weight=_floats(get("parameter", "loss_weight")),
        loss_unbias_method=model("loss_unbias_method"),
        loss_ctr_rel_method=model("loss_ctr_rel_method"),
        export_weight=_floats(get("export_model", "export_weight")),
        learning_rate=_floats(model("learning_rate")),
        step_boundary=_ints(model("step_boundary")),
        weight_ctr=_weights(get("class_weight", "weight_ctr")),
        weight_ecvr=_weights(get("class_weight", "weight_ecvr")),
        train_weight=_weights(get("class_weight", "train_weight")),
        embeddings=_specs(get("embedding", "emb")),
        embeddings_bias=_specs(get("embedding", "emb_bias")),
        attention_pairs=_pairs(get("embedding", "attention_embed")),
        attention_ts=tuple(t.strip() for t in get(
            "embedding", "attention_embed_seq_ts").split("|") if t.strip()),
        zero_pad=model("zero_pad").lower() in ("true", "1", "yes"),
        settings=st)
    for key, want in (("model_type", "mmoe_transformer_unbias"),
                      ("position", "position_learn")):
        if getattr(conf, key) != want:
            raise ValueError(f"{name}: the plain reference covers {key} "
                             f"{want!r}, not {getattr(conf, key)!r}")
    for key in ("is_bn", "is_dropout", "transformer_is_trans_input_by_mlp",
                "transformer_is_trans_out_concat_item",
                "transformer_is_decoder_add_pos_emb", "propensity_em"):
        if cp.has_option("model", key) and model(key).lower() == "true":
            raise ValueError(f"{name}: the plain reference does not cover "
                             f"{key} = true")
    return conf


def with_tables(conf: ModelConf, rows: dict) -> ModelConf:
    """A copy whose tables have the given row counts (tests at a small
    size): ``rows`` maps a table name to its rows."""
    import dataclasses

    def cut(specs):
        return tuple(dataclasses.replace(s, rows=rows.get(s.table, s.rows))
                     for s in specs)
    return dataclasses.replace(conf, embeddings=cut(conf.embeddings),
                               embeddings_bias=cut(conf.embeddings_bias))
