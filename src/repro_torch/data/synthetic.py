"""Synthetic collections (PyTorch port of ``repro.data.synthetic``).

  RandHist-d   : uniform samples from the d-simplex (Dirichlet(1,...,1)).
  Wiki-d/RCV-d : LDA-like topic histograms, sparse Dirichlet(alpha << 1).
  Manner       : Zipf-sampled term counts with the BM25 views: query = raw
                 TF, document = saturated TF x IDF, and the natural
                 shared-sqrt(IDF) symmetrization of Eq. (4).
  LM tokens    : squared-uniform (Zipf-ish) token streams with shifted labels.
  recsys       : criteo-like CTR batches (per-field categorical ids, dense
                 features, behaviour histories).
  graphs       : a skewed random edge list with node features and labels.

Draws come from a seeded ``numpy.random.Generator`` and are then moved to the
device as float32.  They cannot reproduce ``jax.random``, so tests that
compare the two packages feed the port ``repro``'s arrays (for text, its
term counts through ``TextCollection.from_counts``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distances import EPS, neg_inner_product
from repro_torch.core.symmetrize import ViewedDistance


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    x = np.maximum(x.astype(np.float32), np.float32(EPS))
    x /= x.sum(axis=-1, keepdims=True)
    return torch.from_numpy(x).to(resolve_device(device))


def random_histograms(rng: np.random.Generator, n: int, d: int, device="cuda"):
    """RandHist-d: uniform on the simplex, floored at EPS (paper's setup)."""
    return _to_device(rng.dirichlet(np.ones(d), size=n), device)


def lda_like_histograms(rng: np.random.Generator, n: int, d: int, alpha: float = 0.08,
                        device="cuda"):
    """Wiki-d / RCV-d proxy: concentrated Dirichlet topic histograms."""
    return _to_device(rng.dirichlet(np.full(d, alpha), size=n), device)


def make_histogram_dataset(name: str, rng: np.random.Generator, n: int, d: int,
                           device="cuda"):
    """The histogram family ``name`` names: ``randhist*`` or ``wiki*`` /
    ``rcv*``; any other name raises ``ValueError``."""
    if name.startswith("randhist"):
        return random_histograms(rng, n, d, device=device)
    if name.startswith(("wiki", "rcv")):
        return lda_like_histograms(rng, n, d, device=device)
    raise ValueError(name)


def split_queries(X, n_queries: int, rng: np.random.Generator):
    """Paper protocol: random split into queries and indexable points."""
    perm = torch.from_numpy(rng.permutation(X.shape[0])).to(X.device)
    return X[perm[:n_queries]], X[perm[n_queries:]]


@dataclasses.dataclass
class TextCollection:
    """Term-count matrix and the role-dependent BM25 views.

    ``counts`` is the raw (n, V) term-count matrix (hashed vocabulary).
    ``bm25()`` is the paper's BM25 as a ``ViewedDistance``: left (document)
    view = saturated TF x IDF, right (query) view = raw TF.  ``natural()``
    is the Eq.-4 shared-sqrt(IDF) symmetrization.
    """

    counts: torch.Tensor  # (n, V) float32 term counts
    idf: torch.Tensor  # (V,)
    avg_len: float
    k1: float = 1.2
    b: float = 0.75

    @classmethod
    def from_counts(cls, counts) -> "TextCollection":
        """The collection over a (n, V) float32 count tensor: document
        frequencies, IDF and the mean document length from the counts."""
        n = counts.shape[0]
        df = torch.sum(counts > 0, dim=0).to(torch.float32)
        idf = torch.log(1.0 + (n - df + 0.5) / (df + 0.5))
        avg_len = float(np.mean(counts.sum(dim=1).double().cpu().numpy()))
        return cls(counts=counts, idf=idf, avg_len=avg_len)

    def _saturated_tf(self, C):
        length = torch.sum(C, dim=-1, keepdim=True)
        denom = C + self.k1 * (1.0 - self.b + self.b * length / self.avg_len)
        return C * (self.k1 + 1.0) / torch.clamp(denom, min=1e-9)

    def doc_view(self, C):
        return self._saturated_tf(C) * self.idf.to(C.device)[None, :]

    def query_view(self, C):
        return C  # raw query term frequencies (standard BM25)

    def natural_view(self, C):
        return self._saturated_tf(C) * torch.sqrt(self.idf.to(C.device))[None, :]

    def bm25(self) -> ViewedDistance:
        return ViewedDistance(neg_inner_product("bm25"), left_view=self.doc_view,
                              right_view=self.query_view, view_name="bm25")

    def natural(self) -> ViewedDistance:
        return ViewedDistance(neg_inner_product("bm25nat"), left_view=self.natural_view,
                              right_view=self.natural_view, view_name="natural")


def text_collection(rng: np.random.Generator, n: int, vocab: int = 2048, mean_len: int = 60,
                    device="cuda") -> TextCollection:
    """Zipf(1.1)-sampled documents of Poisson(mean_len) terms (at least 5)
    -> hashed term-count matrix (the Manner proxy), on ``device``."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -1.1
    probs /= probs.sum()
    lengths = np.maximum(rng.poisson(mean_len, n), 5)
    counts = np.zeros((n, vocab), dtype=np.float32)
    for i in range(n):
        np.add.at(counts[i], rng.choice(vocab, size=int(lengths[i]), p=probs), 1.0)
    return TextCollection.from_counts(torch.from_numpy(counts).to(resolve_device(device)))


def tokens_from_uniforms(u: np.ndarray, vocab_size: int) -> dict:
    """(B, T + 1) float32 uniforms in [0, 1) -> {"tokens", "labels"} (B, T)
    int64 CPU tensors: tokens ``u * u * (V - 1)`` truncated (squared
    uniforms put the mass on low ids, Zipf-ish), labels shifted by one."""
    toks = torch.from_numpy((u * u * (vocab_size - 1)).astype(np.int64))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def token_batches(rng: np.random.Generator, vocab_size: int, batch: int, seq_len: int,
                  n_batches: int, device="cuda"):
    """``n_batches`` synthetic LM batches on ``device``, each from
    (batch, seq_len + 1) float32 uniforms of ``rng`` (``tokens_from_uniforms``)."""
    dev = resolve_device(device)
    for _ in range(n_batches):
        u = rng.random((batch, seq_len + 1), dtype=np.float32)
        yield {k: v.to(dev) for k, v in tokens_from_uniforms(u, vocab_size).items()}


def recsys_batch(rng: np.random.Generator, batch: int, vocab_sizes, device="cuda", *,
                 n_dense: int = 0, seq_len: int = 0) -> dict:
    """One synthetic CTR batch on ``device``: ``sparse_ids`` (batch, F) int32,
    field f's ids ``uniform**2 * (v_f - 1)`` truncated (Zipf-ish, low ids
    hot), and ``label`` Bernoulli(0.25) float32.  With ``n_dense``, ``dense``
    (batch, n_dense) N(0, 1) float32; with ``seq_len``, DIN's behaviour
    history: ``history`` (batch, seq_len) int32 ids of field 0's vocabulary,
    ``uniform**2 * (vocab_sizes[0] - 1)`` truncated, and ``hist_len`` (batch,)
    int32 in [1, seq_len].  The dense and history draws come after the ids
    and the label, so a batch without them is drawn as before."""
    dev = resolve_device(device)
    sparse = np.stack([(rng.random(batch, dtype=np.float32) ** 2 * (v - 1)).astype(np.int32)
                       for v in vocab_sizes], axis=1)
    label = (rng.random(batch) < 0.25).astype(np.float32)
    out = {"sparse_ids": sparse, "label": label}
    if n_dense:
        out["dense"] = rng.standard_normal((batch, n_dense), dtype=np.float32)
    if seq_len:
        u = rng.random((batch, seq_len), dtype=np.float32)
        out["history"] = (u ** 2 * (vocab_sizes[0] - 1)).astype(np.int32)
        out["hist_len"] = rng.integers(1, seq_len + 1, batch, dtype=np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int = 8, device="cuda") -> dict:
    """A random directed edge list with features and labels, on ``device``:
    ``senders`` ``u**1.5 * (n - 1)`` truncated (skewed to low ids, as a
    preferential attachment would), ``receivers`` ``u * (n - 1)``, both int32;
    ``features`` N(0, 0.25) float32 (n, d_feat); ``labels`` int32 in
    [0, n_classes)."""
    dev = resolve_device(device)
    src = (rng.random(n_edges, dtype=np.float32) ** 1.5 * (n_nodes - 1)).astype(np.int32)
    dst = (rng.random(n_edges, dtype=np.float32) * (n_nodes - 1)).astype(np.int32)
    feats = rng.standard_normal((n_nodes, d_feat), dtype=np.float32)
    feats *= np.float32(0.5)
    labels = rng.integers(0, n_classes, n_nodes, dtype=np.int32)
    return {name: torch.from_numpy(a).to(dev) for name, a in
            (("senders", src), ("receivers", dst), ("features", feats), ("labels", labels))}
