"""Binary bag-of-words vocabulary tree for ORB descriptors (numpy only; a
copy of ``lsd_tpu/slam/bow.py``).

Plays the role of the reference's vendored DBoW2 + ORBvoc
(slam/localization/src/global_localization.cpp ORB retrieval thread,
slam/common/ORBSLAM + DBoW2, ORB vocabulary asset slam/data/ORBvoc.zip):
hierarchical k-majority clustering of 256-bit ORB descriptors into a
branching^levels word vocabulary, TF-IDF weighted bag-of-words vectors,
and an inverted index for sublinear candidate retrieval over large
keyframe databases.  Unlike the reference we train the vocabulary from
the map's own descriptors at load time instead of shipping a 40 MB
pre-trained asset — per-map vocabularies are smaller and at least as
discriminative on the map they index.

All distance math is vectorized numpy: Hamming via popcount lookup on
XOR bytes; centroids via bitwise majority vote.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(1).astype(np.uint16)


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 32) x (M, 32) uint8 -> (N, M) uint16 Hamming distances."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return _POPCOUNT[x].sum(axis=-1)


def _majority(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of (N, 32) uint8 descriptors."""
    bits = np.unpackbits(descs, axis=1)           # (N, 256)
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj)


def _kmajority(descs: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """k-means with Hamming metric + majority centroids.
    Returns (centroids (k, 32), assignment (N,))."""
    n = len(descs)
    k = min(k, n)
    centroids = descs[rng.choice(n, k, replace=False)].copy()
    assign = np.zeros(n, np.int32)
    for _ in range(iters):
        d = hamming(descs, centroids)
        new_assign = d.argmin(axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(k):
            members = descs[assign == c]
            if len(members):
                centroids[c] = _majority(members)
            else:   # re-seed empty cluster at the farthest point
                centroids[c] = descs[d.min(axis=1).argmax()]
    return centroids, assign


class BinaryVocabulary:
    """Hierarchical k-majority tree; leaves are visual words."""

    def __init__(self, branching: int = 8, levels: int = 3, seed: int = 0):
        self.branching = branching
        self.levels = levels
        self.seed = seed
        # flattened tree: per node, its centroid + child slice or word id
        self.node_centroids: List[np.ndarray] = []   # (k_i, 32) per node
        self.node_children: List[np.ndarray] = []    # child node ids, -1=leaf
        self.node_words: List[np.ndarray] = []       # word ids at leaves
        self.n_words = 0
        self.idf: Optional[np.ndarray] = None

    def fit(self, descriptors: np.ndarray) -> "BinaryVocabulary":
        descs = np.ascontiguousarray(descriptors, np.uint8).reshape(-1, 32)
        if len(descs) < 2:
            raise ValueError("need >= 2 descriptors to build a vocabulary")
        rng = np.random.default_rng(self.seed)
        self.node_centroids, self.node_children, self.node_words = [], [], []
        self.n_words = 0
        self._build(descs, level=0, rng=rng)
        # document frequency on the training set (one "document" per
        # descriptor batch is unavailable here, so idf starts uniform and
        # is refined by the database as entries are added)
        self.idf = np.ones(self.n_words, np.float32)
        return self

    def _build(self, descs: np.ndarray, level: int,
               rng: np.random.Generator) -> int:
        node = len(self.node_centroids)
        self.node_centroids.append(np.zeros((0, 32), np.uint8))
        self.node_children.append(np.zeros(0, np.int32))
        self.node_words.append(np.zeros(0, np.int32))
        cents, assign = _kmajority(descs, self.branching, rng)
        self.node_centroids[node] = cents
        k = len(cents)
        if level + 1 >= self.levels or len(descs) <= self.branching:
            words = np.arange(self.n_words, self.n_words + k, dtype=np.int32)
            self.n_words += k
            self.node_children[node] = np.full(k, -1, np.int32)
            self.node_words[node] = words
            return node
        children = np.zeros(k, np.int32)
        words = np.full(k, -1, np.int32)
        for c in range(k):
            members = descs[assign == c]
            if len(members) >= 2:
                children[c] = self._build(members, level + 1, rng)
            else:
                children[c] = -1
                words[c] = self.n_words
                self.n_words += 1
        self.node_children[node] = children
        self.node_words[node] = words
        return node

    def words(self, descriptors: np.ndarray) -> np.ndarray:
        """Quantize (N, 32) descriptors -> (N,) word ids."""
        descs = np.ascontiguousarray(descriptors, np.uint8).reshape(-1, 32)
        out = np.zeros(len(descs), np.int32)
        for i, d in enumerate(descs):
            node = 0
            while True:
                cents = self.node_centroids[node]
                c = int(hamming(d[None], cents)[0].argmin())
                child = self.node_children[node][c]
                if child < 0:
                    out[i] = self.node_words[node][c]
                    break
                node = int(child)
        return out

    def bow(self, descriptors: np.ndarray) -> Dict[int, float]:
        """L1-normalized TF-IDF bag-of-words vector."""
        w = self.words(descriptors)
        ids, counts = np.unique(w, return_counts=True)
        tf = counts.astype(np.float32) / len(w)
        weights = tf * self.idf[ids]
        s = weights.sum()
        if s <= 0:
            return {}
        return {int(i): float(v / s) for i, v in zip(ids, weights)}


def bow_similarity(a: Dict[int, float], b: Dict[int, float]) -> float:
    """DBoW2 L1 score: sum over common words of |ai| + |bi| - |ai - bi|
    (in [0, 2]; identical vectors score 2)."""
    score = 0.0
    for w, va in a.items():
        vb = b.get(w)
        if vb is not None:
            score += abs(va) + abs(vb) - abs(va - vb)
    return score


class BowDatabase:
    """Inverted-index retrieval database over BoW vectors."""

    def __init__(self, vocab: BinaryVocabulary):
        self.vocab = vocab
        self.vectors: List[Dict[int, float]] = []
        self.ids: List[int] = []
        self.inverted: Dict[int, List[int]] = {}
        self._doc_freq = np.zeros(vocab.n_words, np.int64)

    def __len__(self) -> int:
        return len(self.ids)

    def add(self, entry_id: int, descriptors: np.ndarray) -> None:
        vec = self.vocab.bow(descriptors)
        idx = len(self.vectors)
        self.vectors.append(vec)
        self.ids.append(int(entry_id))
        for w in vec:
            self.inverted.setdefault(w, []).append(idx)
            self._doc_freq[w] += 1
        # refresh idf every so often (cheap; keeps weights meaningful)
        if len(self.vectors) % 64 == 0:
            n = len(self.vectors)
            df = np.maximum(self._doc_freq, 1)
            self.vocab.idf = np.log(n / df).astype(np.float32) + 1.0

    def query(self, descriptors: np.ndarray, top_k: int = 5
              ) -> List[Tuple[int, float]]:
        """-> [(entry_id, score)] best-first; only entries sharing at
        least one word are scored (the inverted-index speedup)."""
        vec = self.vocab.bow(descriptors)
        if not vec:
            return []
        candidates: Dict[int, float] = {}
        for w, va in vec.items():
            for idx in self.inverted.get(w, ()):
                vb = self.vectors[idx].get(w, 0.0)
                candidates[idx] = candidates.get(idx, 0.0) + \
                    abs(va) + abs(vb) - abs(va - vb)
        ranked = sorted(candidates.items(), key=lambda kv: -kv[1])
        return [(self.ids[i], s) for i, s in ranked[:top_k]]
