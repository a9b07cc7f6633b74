"""phi3.5-moe-42b-a6.6b: 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE]."""
from repro_torch.configs.base import LMConfig, MoEConfig

FULL = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=6400, vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    rope_theta=10_000.0, full_attention=True,
)

SMOKE = LMConfig(
    name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=96, vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
    remat=False, dtype="float32", full_attention=True,
)
