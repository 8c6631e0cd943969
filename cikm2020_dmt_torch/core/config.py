"""Typed configuration: the port's own copy of the reference INI schema.

Same mini-DSLs and the same fields as ``cikm2020_dmt_tpu/core/config.py``,
so one ``.conf`` file configures both packages:

- embedding spec    ``Name:id_size:dim:feature_name:{i|u}#...``
- attention pairs   ``seq_feat:item_feat#...|...`` one group per behavior
  sequence (click / order / cart)
- ts features       ``ts_feat|ts_feat|...``
- class weights     ``label:weight,...`` sorted by label

Fields that only steer TPU layouts or the training loop (packing, dedup,
sharding, lazy Adam, input pipeline) are kept so that configs round-trip;
the serving path reads the model, embedding and export fields.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Mapping


# ---------------------------------------------------------------------------
# DSL parsers
# ---------------------------------------------------------------------------


def parse_csv_ints(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x.strip() != "")


def parse_csv_floats(s: str) -> tuple[float, ...]:
    return tuple(float(x) for x in s.split(",") if x.strip() != "")


def parse_class_weights(s: str) -> tuple[tuple[int, float], ...]:
    """``"0:1.0,1:15.0,..."`` -> ((0, 1.0), (1, 15.0), ...) sorted by label;
    the labels define the mask columns."""
    pairs = []
    for item in s.split(","):
        item = item.strip()
        if not item:
            continue
        label, weight = item.split(":")
        pairs.append((int(label), float(weight)))
    return tuple(sorted(pairs))


@dataclass(frozen=True)
class EmbeddingSpec:
    """One entry of the embedding DSL."""

    table: str          # embedding (vocab) name, e.g. "Sku"
    id_size: int        # total rows incl. OOV buckets, e.g. 5_000_000
    dim: int            # embedding dim
    feature: str        # input feature name, e.g. "clk_seq_sku_7d_50"
    side: str           # "i" (item) or "u" (user)


def parse_embedding_spec(s: str) -> tuple[EmbeddingSpec, ...]:
    s = s.strip()
    if len(s) <= 2:
        return ()
    out = []
    for item in s.split("#"):
        f = item.split(":")
        out.append(EmbeddingSpec(f[0], int(f[1]), int(f[2]), f[3],
                                 f[4] if len(f) > 4 else "i"))
    return tuple(out)


def parse_attention_pairs(s: str) -> tuple[tuple[tuple[str, str], ...], ...]:
    """``"a:x#b:y|c:x#d:y"`` -> (((a,x),(b,y)), ((c,x),(d,y))): outer groups
    are the behavior sequences, inner pairs map a sequence feature to the
    matching target-item feature."""
    s = s.strip()
    if len(s) <= 2:
        return ()
    groups = []
    for group in s.split("|"):
        pairs = []
        for pair in group.split("#"):
            a, b = pair.split(":")
            pairs.append((a.strip(), b.strip()))
        groups.append(tuple(pairs))
    return tuple(groups)


def parse_ts_features(s: str) -> tuple[str, ...]:
    s = s.strip()
    if len(s) <= 1:
        return ()
    return tuple(x.strip() for x in s.split("|"))


def parse_sim_pairs(s: str) -> tuple[tuple[str, str], ...]:
    s = s.strip()
    if len(s) <= 2:
        return ()
    out = []
    for pair in s.split("#"):
        a, b = pair.split(":")
        out.append((a.strip(), b.strip()))
    return tuple(out)


_SEQ_LEN_RE = re.compile(r"_(\d+)$")


def feature_max_len(feature: str, default: int = 10) -> int:
    """Static padded length for an id feature: the trailing ``_N`` of a
    sequence feature's name, 1 for ``item_*`` features, else ``default``."""
    m = _SEQ_LEN_RE.search(feature)
    if m:
        return int(m.group(1))
    if feature.startswith("item_"):
        return 1
    return default


# ---------------------------------------------------------------------------
# Config dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransformerConfig:
    """Deep Interest Transformer hparams."""

    d_model: int = 80
    d_ff: int = 320
    num_heads: int = 4
    num_blocks_encode: int = 1
    num_blocks_decode: int = 1
    maxlen_k: int = 50
    maxlen_q: int = 1
    dropout_rate: float = 0.1
    is_trans_input_by_mlp: bool = False
    # one of: position_sin_cos | position_learn | time_add | time_concat | none
    position_encoding_method: str = "position_learn"
    is_trans_out_concat_item: bool = False
    is_trans_out_by_mlp: bool = False
    is_decoder_add_pos_emb: bool = False


@dataclass(frozen=True)
class DMTConfig:
    # ---- model ----
    model_type: str = "mmoe_transformer_unbias"
    feature_dimension: int = 615
    output_units: int = 1
    hidden_units: tuple[int, ...] = (512, 256, 128)
    hidden_units_bottom: tuple[int, ...] = (512, 256, 128)
    hidden_units_task: tuple[int, ...] = (32,)
    hidden_units_bias: tuple[int, ...] = (32, 16)
    num_experts: int = 4
    is_use_feature: bool = True

    # regularization
    optimizer: str = "adam"
    dropout: tuple[float, ...] = (0.5, 0.7, 0.8)
    dropout_bottom: tuple[float, ...] = (0.5, 0.7, 0.8)      # keep-probs
    dropout_task: tuple[float, ...] = (1.0,)
    dropout_rate_bias: tuple[float, ...] = (0.5, 0.5)        # drop-rates
    is_bn: bool = False
    bn_decay: float = 0.999
    is_dropout: bool = False
    wnd_wd: float = 0.0
    l2_emb_lambda: float = 0.01

    # schedule
    epoch_num: int = 2
    batch_size: int = 2048
    test_batch_size: int = 4096
    validation_batch_size: int = 4096
    validate_step: int = 1000
    shuffle_size: int = 100000
    total_example_num: int = 0
    max_iter_step: int = 10_000_000
    learning_rate: tuple[float, ...] = (0.001, 0.0001)
    step_boundary: tuple[int, ...] = (300_000_000,)

    # losses
    loss_weight: tuple[float, ...] = (1.0, 1.0)
    loss_weight_method: str = "fixed"         # fixed | uncertainty
    loss_unbias_method: str = "two_head_add"  # two_head_add | two_head_multiply
    loss_ctr_rel_method: str = "ctr_rel"      # ctr | ctr_rel
    single_task_raw_label: bool = False
    export_weight: tuple[float, ...] = (1.0, 1.0)
    # serving: int8 storage for tables with >= this many rows (0 = off)
    export_int8_rows: int = 0
    weight_ctr: tuple[tuple[int, float], ...] = parse_class_weights(
        "0:1.0,1:15.0,2:15.0,4:15.0,5:15.0")
    weight_ecvr: tuple[tuple[int, float], ...] = parse_class_weights(
        "0:1.0,1:1.0,2:1.0,4:400.0,5:400.0")
    train_weight: tuple[tuple[int, float], ...] = parse_class_weights(
        "0:1.0,1:15.0,2:15.0,4:400.0,5:400.0")
    valid_weight: tuple[tuple[int, float], ...] = parse_class_weights(
        "0:1.0,1:15.0,2:15.0,4:400.0,5:400.0")

    # unbias / propensity
    propensity_em: bool = False
    propensity_em_type: str = "page"          # position | page

    # transformer
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    zero_pad: bool = True

    # ---- embeddings ----
    embeddings: tuple[EmbeddingSpec, ...] = ()
    embeddings_bias: tuple[EmbeddingSpec, ...] = ()
    attention_pairs: tuple[tuple[tuple[str, str], ...], ...] = ()
    attention_ts: tuple[str, ...] = ()
    sim_embed: tuple[tuple[str, str], ...] = ()
    update_emb: str = ""

    # default static length cap for uncapped multi-id features
    default_id_len: int = 10

    # ---- schema ----
    header_schema: tuple[str, ...] = (
        "expid", "pin", "expo_time", "sid", "pos", "sku", "uuid",
        "click_time", "order_id", "label", "reqsig", "page", "index")

    # ---- paths ----
    output_path: str = ""
    summary_path: str = ""
    train_data_path: str = ""
    train_data_mean_path: str = ""
    train_data_std_path: str = ""
    train_data_stat_path: str = ""
    validation_data_path: str = ""
    test_data_path: str = ""
    test_data_path_ord: str = ""
    checkpoint: str = ""
    vocab_path: str = ""
    tag: str = "dmt"

    # ---- numerics and storage ----
    seed: int = 131
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # bf16 storage for embedding tables with at least this many logical
    # rows (0 disables); lookups return the table dtype
    table_bf16_threshold: int = 500

    # ---- TPU layout and training-loop knobs, kept so configs round-trip
    # with the reference package; the serving path does not read them ----
    shard_rows_threshold: int = 100_000
    unit_weights: bool = False
    packed_transfer: bool = True
    dedup_grads: bool = True
    dedup_rows_threshold: int = 1_000_000
    dedup_budget_div: int = 8
    lazy_overflow_exact: bool = True
    dedup_exact_rows_max: int = 0
    onehot_bwd_rows_max: int = 4096
    onehot_bwd_bf16: bool = False
    lazy_adam: bool = True
    shard_seq_exchange: bool = True
    full_mesh_tables: bool = True
    # the reference stores tables with >= pack_rows_threshold rows as
    # 128-lane packed rows; convert.py unpacks them to logical [R, D]
    packed_tables: bool = True
    pack_rows_threshold: int = 500_000
    grid_bf16: bool = False
    fms_grad_bf16: bool = False
    mesh_data: int = 0
    mesh_model: int = 1
    data_workers: int = 0
    data_cache_bytes: int = 1 << 29

    # -------------------------------------------------------------------
    @property
    def model_path(self) -> str:
        return os.path.join(self.output_path or ".", self.tag + ".model")

    @property
    def train_result_path(self) -> str:
        return os.path.join(self.output_path or ".", self.tag + ".train.result")

    @property
    def validation_result_path(self) -> str:
        return os.path.join(self.output_path or ".",
                            self.tag + ".validation.result")

    @property
    def labels(self) -> tuple[int, ...]:
        return tuple(l for l, _ in self.train_weight)

    @property
    def num_label_classes(self) -> int:
        return len(self.train_weight)

    @property
    def is_unbias_model(self) -> bool:
        return "unbias" in self.model_type

    @property
    def is_transformer_model(self) -> bool:
        return "transformer" in self.model_type

    @property
    def is_multi_task(self) -> bool:
        return self.model_type in (
            "multi_task", "mmoe", "multi_task_transformer", "mmoe_transformer",
            "mmoe_transformer_unbias")

    @property
    def is_use_seq_ts(self) -> bool:
        return len(self.attention_ts) >= 1

    def weight_vector(self, pairs: tuple[tuple[int, float], ...]) -> tuple[float, ...]:
        return tuple(w for _, w in pairs)

    def id_feature_names(self) -> tuple[str, ...]:
        """All id feature names (main + bias), deduped, order-preserving."""
        seen: dict[str, None] = {}
        for spec in self.embeddings + self.embeddings_bias:
            seen.setdefault(spec.feature, None)
        return tuple(seen)

    def feature_to_spec(self) -> Mapping[str, EmbeddingSpec]:
        out: dict[str, EmbeddingSpec] = {}
        for spec in self.embeddings + self.embeddings_bias:
            out.setdefault(spec.feature, spec)
        return out

    def replace(self, **kw) -> "DMTConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------------
    @classmethod
    def from_ini(cls, path: str, **overrides) -> "DMTConfig":
        """Load a reference-format INI file (e.g. conf/dmt.conf)."""
        cp = configparser.ConfigParser(interpolation=None)
        with open(path) as f:
            cp.read_string(f.read())

        def get(section: str, option: str, default=None):
            try:
                return cp.get(section, option)
            except (configparser.NoSectionError, configparser.NoOptionError):
                return default

        def get_bool(section, option, default):
            v = get(section, option)
            if v is None:
                return default
            return v.strip().lower() in ("true", "1", "yes")

        def get_int(section, option, default):
            v = get(section, option)
            return default if v is None else int(v)

        def get_float(section, option, default):
            v = get(section, option)
            return default if v is None else float(v)

        def ints(section, option, default):
            return parse_csv_ints(get(section, option, "") or "") or default

        def floats(section, option, default):
            return parse_csv_floats(get(section, option, "") or "") or default

        d = cls()  # defaults
        t = d.transformer

        def tget(kind, name):
            getter = {"int": get_int, "float": get_float, "bool": get_bool}[kind]
            return getter("model", "transformer_" + name, getattr(t, name))

        transformer = TransformerConfig(
            d_model=tget("int", "d_model"),
            d_ff=tget("int", "d_ff"),
            num_heads=tget("int", "num_heads"),
            num_blocks_encode=tget("int", "num_blocks_encode"),
            num_blocks_decode=tget("int", "num_blocks_decode"),
            maxlen_k=tget("int", "maxlen_k"),
            maxlen_q=tget("int", "maxlen_q"),
            dropout_rate=tget("float", "dropout_rate"),
            is_trans_input_by_mlp=tget("bool", "is_trans_input_by_mlp"),
            position_encoding_method=get(
                "model", "transformer_position_encoding_method",
                t.position_encoding_method),
            is_trans_out_concat_item=tget("bool", "is_trans_out_concat_item"),
            is_trans_out_by_mlp=tget("bool", "is_trans_out_by_mlp"),
            is_decoder_add_pos_emb=tget("bool", "is_decoder_add_pos_emb"),
        )

        def weights(option, default):
            v = get("class_weight", option)
            return default if v is None else parse_class_weights(v)

        def pathopt(option, default):
            return get("path", option, default) or ""

        tag = os.path.basename(path)
        if tag.endswith(".conf"):
            tag = tag[: -len(".conf")]

        cfg = cls(
            model_type=get("model", "model_type", d.model_type),
            feature_dimension=get_int("model", "feature_dimension", d.feature_dimension),
            output_units=get_int("model", "output_units", d.output_units),
            hidden_units=ints("model", "hidden_units", d.hidden_units),
            hidden_units_bottom=ints("model", "hidden_units_bottom", d.hidden_units_bottom),
            hidden_units_task=ints("model", "hidden_units_task", d.hidden_units_task),
            hidden_units_bias=ints("model", "hidden_units_bias", d.hidden_units_bias),
            num_experts=get_int("model", "num_experts", d.num_experts),
            is_use_feature=get_bool("model", "is_use_feature", d.is_use_feature),
            optimizer=get("model", "optimizer", d.optimizer),
            dropout=floats("model", "dropout", d.dropout),
            dropout_bottom=floats("model", "dropout_bottom", d.dropout_bottom),
            dropout_task=floats("model", "dropout_task", d.dropout_task),
            dropout_rate_bias=floats("model", "dropout_rate_bias", d.dropout_rate_bias),
            is_bn=get_bool("model", "is_bn", d.is_bn),
            bn_decay=get_float("model", "bn_decay", d.bn_decay),
            is_dropout=get_bool("model", "is_dropout", d.is_dropout),
            wnd_wd=get_float("model", "wnd_wd", d.wnd_wd),
            l2_emb_lambda=get_float("model", "l2_emb_lambda", d.l2_emb_lambda),
            epoch_num=get_int("model", "epoch_num", d.epoch_num),
            batch_size=get_int("model", "batch_size", d.batch_size),
            test_batch_size=get_int("model", "test_batch_size", d.test_batch_size),
            validation_batch_size=get_int("model", "validation_batch_size",
                                          d.validation_batch_size),
            validate_step=get_int("model", "validate_step", d.validate_step),
            shuffle_size=get_int("model", "shuffle_size", d.shuffle_size),
            total_example_num=get_int("model", "total_example_num", d.total_example_num),
            max_iter_step=get_int("model", "max_iter_step", d.max_iter_step),
            learning_rate=floats("model", "learning_rate", d.learning_rate),
            step_boundary=ints("model", "step_boundary", d.step_boundary),
            loss_weight=floats("parameter", "loss_weight", d.loss_weight),
            loss_weight_method=get("parameter", "loss_weight_method",
                                   d.loss_weight_method),
            loss_unbias_method=get("model", "loss_unbias_method", d.loss_unbias_method),
            loss_ctr_rel_method=get("model", "loss_ctr_rel_method",
                                    d.loss_ctr_rel_method),
            single_task_raw_label=get_bool("model", "single_task_raw_label",
                                           d.single_task_raw_label),
            export_weight=floats("export_model", "export_weight", d.export_weight),
            export_int8_rows=get_int("export_model", "export_int8_rows",
                                     d.export_int8_rows),
            weight_ctr=weights("weight_ctr", d.weight_ctr),
            weight_ecvr=weights("weight_ecvr", d.weight_ecvr),
            train_weight=weights("train_weight", d.train_weight),
            valid_weight=weights("valid_weight", d.valid_weight),
            propensity_em=get_bool("model", "propensity_em", d.propensity_em),
            propensity_em_type=get("model", "propensity_em_type", d.propensity_em_type),
            transformer=transformer,
            zero_pad=get_bool("model", "zero_pad", d.zero_pad),
            embeddings=parse_embedding_spec(get("embedding", "emb", "") or ""),
            embeddings_bias=parse_embedding_spec(get("embedding", "emb_bias", "") or ""),
            attention_pairs=parse_attention_pairs(
                get("embedding", "attention_embed", "") or ""),
            attention_ts=parse_ts_features(
                get("embedding", "attention_embed_seq_ts", "") or ""),
            sim_embed=parse_sim_pairs(get("embedding", "sim_embed", "") or ""),
            update_emb=get("embedding", "update_emb", "") or "",
            header_schema=tuple(s.strip() for s in get(
                "schema", "header_schema", ",".join(d.header_schema)).split(",")),
            output_path=pathopt("output_path", d.output_path),
            summary_path=pathopt("summary_path", d.summary_path),
            train_data_path=pathopt("train_data_path", d.train_data_path),
            train_data_mean_path=pathopt("train_data_mean_path", d.train_data_mean_path),
            train_data_std_path=pathopt("train_data_std_path", d.train_data_std_path),
            train_data_stat_path=pathopt("train_data_stat_path", d.train_data_stat_path),
            validation_data_path=pathopt("validation_data_path", d.validation_data_path),
            test_data_path=pathopt("test_data_path", d.test_data_path),
            test_data_path_ord=pathopt("test_data_path_ord", d.test_data_path),
            checkpoint=pathopt("checkpoint", d.checkpoint),
            vocab_path=pathopt("vocab_path", d.vocab_path),
            tag=tag,
        )
        if overrides:
            cfg = cfg.replace(**overrides)
        return cfg

    def recompute_max_steps(self, label_counts: tuple[int, ...],
                            num_replicas: int = 1) -> "DMTConfig":
        """Caps ``max_iter_step`` at epochs x examples / (batch x
        replicas), the examples summed over the label-count stat file's
        counts (reference recsys_conf.py:144-151)."""
        total = sum(label_counts)
        total_step = int(self.epoch_num * total
                         / (self.batch_size * max(1, num_replicas)))
        return self.replace(total_example_num=total,
                            max_iter_step=min(self.max_iter_step, total_step))
