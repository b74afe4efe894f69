"""Offline word/sentence embeddings for text-modality analysis (the port's
copy of ``eval/text_embeddings.py``, numpy only).

Replacement for the reference's FastText+SIF pipeline
(multimodal_compare/eval/mnistsvhn_helper.py:81-181: gensim FastText training
``fetch_emb``, inverse-frequency weights ``fetch_weights``, weighted
averaging ``apply_weights`` and first-principal-component removal
``apply_pc``).  gensim/nltk aren't in this image and no pretrained vectors
can be downloaded, so the word vectors come from truncated SVD of the PPMI
co-occurrence matrix (Levy & Goldberg 2014 — count-based skip-gram
equivalent); the SIF sentence-embedding math (Arora et al. 2017) is kept
exactly: w(t) = a / (a + p(t)), subtract the first principal component.

API::

    emb = SIFEmbeddings(dim=64, window=3, min_occur=2).fit(sentences)
    vecs = emb.embed(sentences)           # (N, dim)
    sim = emb.similarity("big red square", "small red square")
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Dict, List, Sequence

import numpy as np


class OrderedCounter(Counter, OrderedDict):
    """Counter remembering first-encounter order (reference helper:16-23)."""

    def __repr__(self):
        return "%s(%r)" % (self.__class__.__name__, OrderedDict(self))

    def __reduce__(self):
        return self.__class__, (OrderedDict(self),)


def _tokenize(s: str) -> List[str]:
    return s.lower().split()


class SIFEmbeddings:
    def __init__(self, dim: int = 64, window: int = 3, min_occur: int = 1,
                 a: float = 1e-3):
        self.dim = dim
        self.window = window        # reference lenWindow
        self.min_occur = min_occur  # reference minOccur
        self.a = a
        self.vocab: Dict[str, int] = {}
        self.word_vectors: np.ndarray = None
        self.weights: np.ndarray = None
        self.pc: np.ndarray = None

    # -- fitting ------------------------------------------------------------

    def fit(self, sentences: Sequence[str]) -> "SIFEmbeddings":
        counts = OrderedCounter()
        toks = [_tokenize(s) for s in sentences]
        for t in toks:
            counts.update(t)
        # filter BEFORE assigning ids: enumerate over the unfiltered
        # counter leaves gaps, and a kept word could get an id >= V
        kept = [w for w, c in counts.items() if c >= self.min_occur]
        self.vocab = {w: i for i, w in enumerate(kept)}
        V = len(self.vocab)
        assert V > 0, "empty vocabulary"
        # symmetric co-occurrence within the window; the diagonal counts the
        # word with itself so interchangeable words (identical contexts, e.g.
        # color names in a templated grammar) still get distinct vectors —
        # the role FastText's subword channel plays in the reference
        co = np.zeros((V, V), np.float64)
        for t in toks:
            ids = [self.vocab[w] for w in t if w in self.vocab]
            for i, wi in enumerate(ids):
                co[wi, wi] += 1.0
                for j in range(max(0, i - self.window),
                               min(len(ids), i + self.window + 1)):
                    if j != i:
                        co[wi, ids[j]] += 1.0
        # PPMI + truncated SVD (count-based skip-gram; Levy & Goldberg 2014)
        total = co.sum() + 1e-12
        pw = co.sum(1, keepdims=True) / total
        pc_ = co.sum(0, keepdims=True) / total
        pmi = np.log((co / total + 1e-12) / (pw * pc_ + 1e-12))
        ppmi = np.maximum(pmi, 0.0)
        u, s, _ = np.linalg.svd(ppmi, full_matrices=False)
        k = min(self.dim, V)
        vecs = u[:, :k] * np.sqrt(s[:k])[None]
        if k < self.dim:
            vecs = np.pad(vecs, ((0, 0), (0, self.dim - k)))
        self.word_vectors = vecs.astype(np.float32)
        # SIF weights a / (a + p(w))  (reference fetch_weights:116-147)
        freqs = np.array([counts[w] for w in self.vocab], np.float64)
        p = freqs / freqs.sum()
        self.weights = (self.a / (self.a + p)).astype(np.float32)
        # first principal component of the training sentence embeddings
        raw = self._weighted_avg(toks)
        raw_c = raw - raw.mean(0, keepdims=True)
        _, _, vt = np.linalg.svd(raw_c, full_matrices=False)
        self.pc = vt[0].astype(np.float32)
        return self

    # -- embedding ------------------------------------------------------------

    def _weighted_avg(self, token_lists) -> np.ndarray:
        out = np.zeros((len(token_lists), self.dim), np.float32)
        for i, t in enumerate(token_lists):
            ids = [self.vocab[w] for w in t if w in self.vocab]
            if ids:
                out[i] = (self.word_vectors[ids]
                          * self.weights[ids][:, None]).mean(0)
        return out

    def embed(self, sentences: Sequence[str],
              remove_pc: bool = True) -> np.ndarray:
        """SIF sentence embeddings (reference apply_weights + apply_pc)."""
        emb = self._weighted_avg([_tokenize(s) for s in sentences])
        if remove_pc and self.pc is not None:
            emb = emb - np.outer(emb @ self.pc, self.pc)
        return emb

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.embed([a, b])
        na, nb = np.linalg.norm(va), np.linalg.norm(vb)
        if na == 0 or nb == 0:
            return 0.0
        return float(va @ vb / (na * nb))


def text_embedding_analysis(gt_sentences: Sequence[str],
                            recon_sentences: Sequence[str],
                            dim: int = 64) -> Dict[str, float]:
    """Mean embedding cosine between ground-truth and reconstructed captions
    plus a random-pairing baseline — the reference's embedding-space text
    quality analysis, made offline."""
    emb = SIFEmbeddings(dim=dim).fit(list(gt_sentences))
    g = emb.embed(gt_sentences)
    r = emb.embed(recon_sentences)

    def _cos(x, y):
        n = np.linalg.norm(x, axis=1) * np.linalg.norm(y, axis=1) + 1e-9
        return (x * y).sum(1) / n

    matched = float(np.mean(_cos(g, r)))
    rng = np.random.default_rng(0)
    shuffled = float(np.mean(_cos(g, r[rng.permutation(len(r))])))
    return {"embedding_cosine": matched,
            "embedding_cosine_shuffled_baseline": shuffled}
