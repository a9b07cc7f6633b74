"""din: target-attention over user behaviour history [arXiv:1706.06978].
Field 0 is the target item; history ids index field 0's vocabulary."""
from repro_torch.configs.base import RecsysConfig

_ITEM_VOCAB = 1_000_000
FULL = RecsysConfig(
    name="din", interaction="target-attn", n_dense=0,
    vocab_sizes=(_ITEM_VOCAB, 100_000, 10_000, 1_000, 100),  # item, shop, cate, brand, segment
    embed_dim=18, seq_len=100, attn_mlp_dims=(80, 40), mlp_dims=(200, 80),
)

SMOKE = RecsysConfig(
    name="din-smoke", interaction="target-attn", n_dense=0,
    vocab_sizes=(256, 64, 16), embed_dim=8, seq_len=12,
    attn_mlp_dims=(16, 8), mlp_dims=(32, 16),
)
