"""two-tower-retrieval: MLP towers + dot, in-batch sampled softmax
[Yi et al., RecSys'19].  The retrieval_cand serving shape is answered by the
paper's ANN engine over item-tower embeddings."""

from repro_torch.configs.base import RecsysConfig

FULL = RecsysConfig(
    name="two-tower-retrieval", interaction="dot", n_dense=0,
    # 8 user-side fields + 8 item-side fields
    vocab_sizes=(50_000_000, 1_000_000, 100_000, 10_000, 1_000, 500, 100, 50,
                 10_000_000, 1_000_000, 100_000, 10_000, 1_000, 500, 100, 50),
    embed_dim=256, tower_mlp_dims=(1024, 512, 256), mlp_dims=(),
)

SMOKE = RecsysConfig(
    name="two-tower-smoke", interaction="dot", n_dense=0,
    vocab_sizes=(512, 64, 256, 32), embed_dim=16,
    tower_mlp_dims=(64, 32), mlp_dims=(),
)
