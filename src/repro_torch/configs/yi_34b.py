"""yi-34b: llama-arch dense GQA transformer [arXiv:2403.04652]."""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_head=128, d_ff=20480, vocab_size=64000, rope_theta=5_000_000.0,
    full_attention=True, pad_heads_to=64,  # 56 % 16 != 0: zero-masked pad heads
)

SMOKE = LMConfig(
    name="yi-34b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab_size=256, remat=False, dtype="float32",
    full_attention=True,
)
