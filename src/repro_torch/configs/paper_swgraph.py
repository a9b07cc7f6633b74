"""The paper's own architecture: non-metric SW-graph retrieval configs.

One config per (dataset family x distance) headline case of SS3."""
from repro_torch.configs.base import RetrievalConfig

WIKI8_KL = RetrievalConfig(name="wiki8-kl", distance="kl", dim=8)
WIKI128_KL = RetrievalConfig(name="wiki128-kl", distance="kl", dim=128)
RCV128_IS = RetrievalConfig(name="rcv128-is", distance="itakura_saito", dim=128)
RANDHIST32_RENYI2 = RetrievalConfig(
    name="randhist32-renyi2", distance="renyi_2", dim=32
)
MANNER_BM25 = RetrievalConfig(name="manner-bm25", distance="bm25", dim=2048,
                              n_db=146_000)

SMOKE = RetrievalConfig(name="retrieval-smoke", distance="kl", dim=16,
                        n_db=2_000, NN=8, ef_construction=40, ef_search=48)
