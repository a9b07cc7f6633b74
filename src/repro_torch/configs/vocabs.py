"""Deterministic criteo-like per-field vocabulary sizes (PyTorch port of
``repro.configs.vocabs``).

Criteo Kaggle's 26 categorical fields span ~10 to ~10M rows with a heavy
tail; this generator reproduces that profile deterministically (total ~29M
rows at 26 fields).
"""


def criteo_vocabs(n_fields: int):
    sizes = []
    big = [10_000_000, 8_000_000, 5_000_000, 3_000_000, 2_000_000]
    mid = [500_000, 300_000, 100_000, 50_000, 20_000, 10_000]
    for i in range(n_fields):
        if i < len(big):
            sizes.append(big[i])
        elif i < len(big) + len(mid):
            sizes.append(mid[i - len(big)])
        else:
            sizes.append(max(10, 5000 >> (i % 8)))
    return tuple(sizes)
