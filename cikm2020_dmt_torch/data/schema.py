"""Feature schema: the static, fixed-shape batch layout.

Every ragged id feature becomes an (ids[B,L], wts[B,L], len[B]) triple
padded to a per-feature static cap L: sequence caps come from the feature
name (``clk_seq_sku_7d_50`` -> 50), single-id item features get L=1.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.config import DMTConfig, EmbeddingSpec, feature_max_len


@dataclass(frozen=True)
class IdFeature:
    name: str
    table: str
    id_size: int
    dim: int
    side: str       # "i" | "u"
    max_len: int
    is_bias: bool   # belongs to the bias-net embedding group


@dataclass(frozen=True)
class FeatureSchema:
    dense_dim: int
    num_classes: int
    id_features: tuple[IdFeature, ...]
    header_schema: tuple[str, ...]

    @classmethod
    def from_config(cls, cfg: DMTConfig) -> "FeatureSchema":
        feats: dict[str, IdFeature] = {}

        def add(spec: EmbeddingSpec, is_bias: bool) -> None:
            if spec.feature in feats:
                return
            feats[spec.feature] = IdFeature(
                name=spec.feature,
                table=spec.table,
                id_size=spec.id_size,
                dim=spec.dim,
                side=spec.side,
                max_len=feature_max_len(spec.feature, cfg.default_id_len),
                is_bias=is_bias,
            )

        for spec in cfg.embeddings:
            add(spec, is_bias=False)
        for spec in cfg.embeddings_bias:
            add(spec, is_bias=True)

        return cls(
            dense_dim=cfg.feature_dimension,
            num_classes=cfg.num_label_classes,
            id_features=tuple(feats.values()),
            header_schema=cfg.header_schema,
        )

    def wanted_feature_names(self) -> frozenset[bytes]:
        """Feature names to materialize from each Example (selective parse)."""
        names = {b"label", b"mask", b"features", b"header"}
        for f in self.id_features:
            names.add(f.name.encode())
            names.add((f.name + "Wts").encode())
        return frozenset(names)

    def feature(self, name: str) -> IdFeature:
        for f in self.id_features:
            if f.name == name:
                return f
        raise KeyError(name)

    @property
    def header_index(self) -> dict[str, int]:
        return {name: i for i, name in enumerate(self.header_schema)}
