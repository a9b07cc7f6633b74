"""llama3.2-1b: small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_head=64, d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
    tie_embeddings=True, full_attention=True,
)

SMOKE = LMConfig(
    name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab_size=256, tie_embeddings=True, remat=False,
    dtype="float32", full_attention=True,
)
