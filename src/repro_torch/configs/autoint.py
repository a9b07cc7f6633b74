"""autoint: self-attention feature interaction over 39 criteo fields
[arXiv:1810.11921]."""
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.vocabs import criteo_vocabs

FULL = RecsysConfig(
    name="autoint", interaction="self-attn", n_dense=0,
    vocab_sizes=criteo_vocabs(39), embed_dim=16,
    n_attn_layers=3, n_attn_heads=2, d_attn=32, mlp_dims=(),
)

SMOKE = RecsysConfig(
    name="autoint-smoke", interaction="self-attn", n_dense=0,
    vocab_sizes=(64, 32, 128, 16), embed_dim=8,
    n_attn_layers=2, n_attn_heads=2, d_attn=16, mlp_dims=(),
)
