"""kimi-k2-1t-a32b: trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2 paper-table].  At full width it trains only across cards
(the mesh, ROADMAP M17); one card holds it cut in depth."""
from repro_torch.configs.base import LMConfig, MoEConfig

FULL = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_head=128, d_ff=2048, vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
    rope_theta=1_000_000.0, full_attention=True,
)

SMOKE = LMConfig(
    name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=64, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1),
    remat=False, dtype="float32", full_attention=True,
)
