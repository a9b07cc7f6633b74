"""dcn-v2: cross-network v2 over criteo 13 dense + 26 sparse
[arXiv:2008.13535]."""
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.vocabs import criteo_vocabs

FULL = RecsysConfig(
    name="dcn-v2", interaction="cross", n_dense=13,
    vocab_sizes=criteo_vocabs(26), embed_dim=16,
    n_cross_layers=3, mlp_dims=(1024, 1024, 512),
)

SMOKE = RecsysConfig(
    name="dcn-v2-smoke", interaction="cross", n_dense=4,
    vocab_sizes=(64, 32, 128, 16), embed_dim=8,
    n_cross_layers=2, mlp_dims=(32, 16),
)
