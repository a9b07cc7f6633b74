"""gcn-cora: 2-layer GCN, hidden 16, sym-normalized mean agg
[arXiv:1609.02907]. d_feat/n_classes are shape-dependent (the four
assigned graph shapes carry their own feature widths)."""
import dataclasses

from repro_torch.configs.base import GNNConfig

FULL = GNNConfig(
    name="gcn-cora", n_layers=2, d_hidden=16, d_feat=1433, n_classes=7,
    aggregator="mean", norm="sym",
)

SMOKE = GNNConfig(
    name="gcn-cora-smoke", n_layers=2, d_hidden=8, d_feat=32, n_classes=4,
    aggregator="mean", norm="sym",
)


def with_shape(d_feat: int, n_classes: int = 7) -> GNNConfig:
    return dataclasses.replace(FULL, d_feat=d_feat, n_classes=n_classes)
