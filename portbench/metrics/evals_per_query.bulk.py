"""Distance evaluations per query in the window: the ``n_evals`` that the
searcher returns, summed over every answer, over the queries answered
(``core/batched_beam.py``; the paper's hardware-free cost unit)."""


def read(run):
    q = run.counters.get("queries")
    ev = run.counters.get("evals")
    if not q or ev is None:
        return None
    return ev / q
