"""gemma3-12b: dense GQA with a 5:1 local:global sliding-window pattern
[hf:google/gemma-3 family]."""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_head=256, d_ff=15360, vocab_size=262144, sliding_window=1024,
    local_global=(5, 1), rope_theta=1_000_000.0, full_attention=False,
)

SMOKE = LMConfig(
    name="gemma3-12b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab_size=256, sliding_window=8, local_global=(2, 1),
    remat=False, dtype="float32", full_attention=False,
)
