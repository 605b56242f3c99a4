"""Visual (ORB) relocalization (cv2 and numpy only; a copy of
``lsd_tpu/slam/visual_reloc.py``).

Re-derivation of the reference's image-retrieval relocalization path
(slam/localization/src/global_localization.cpp ORB thread: DBoW2 bag-of-
words retrieval over keyframe images from the vendored ORB-SLAM subset,
then GICP verification).  Here: cv2 ORB descriptors per keyframe, candidate
retrieval by descriptor matching with a Lowe ratio test, returning ranked
keyframe candidates that the caller verifies with ICP (same flow as the
ScanContext path in localization.py).

Retrieval scales two ways: small maps use exact brute-force ratio-test
matching; past ``bow_threshold`` keyframes a DBoW2-style vocabulary tree
(slam/bow.py) is trained from the map's own descriptors and an inverted
index narrows each query to BoW candidates before geometric verification
— the reference's ORBvoc+DBoW2 role, without the pre-trained asset.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class VisualRelocDB:
    def __init__(self, n_features: int = 500, ratio: float = 0.75,
                 bow_threshold: int = 50):
        # OpenCV is imported here, not with the module: importing the port
        # must not need it
        try:
            import cv2
        except ImportError as exc:
            raise RuntimeError("cv2 unavailable; visual reloc disabled") from exc
        self.cv2 = cv2
        self.orb = cv2.ORB_create(nfeatures=n_features)
        self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
        self.ratio = ratio
        self.entries: List[Tuple[int, np.ndarray]] = []   # (keyframe id, desc)
        self.bow_threshold = bow_threshold
        self._bow_db = None     # built lazily once entries exceed threshold

    def _describe(self, image) -> Optional[np.ndarray]:
        if isinstance(image, (bytes, bytearray)):
            image = self.cv2.imdecode(np.frombuffer(image, np.uint8),
                                      self.cv2.IMREAD_GRAYSCALE)
        elif image.ndim == 3:
            image = self.cv2.cvtColor(image, self.cv2.COLOR_BGR2GRAY)
        if image is None:
            return None
        _kp, desc = self.orb.detectAndCompute(image, None)
        return desc

    def add(self, keyframe_id: int, image) -> bool:
        desc = self._describe(image)
        if desc is None or len(desc) < 8:
            return False
        self.entries.append((int(keyframe_id), desc))
        if self._bow_db is not None:
            self._bow_db.add(len(self.entries) - 1, desc)
        return True

    def __len__(self) -> int:
        return len(self.entries)

    def build_bow_index(self, branching: int = 8, levels: int = 3) -> None:
        """Train a vocabulary from the stored descriptors and index every
        entry; subsequent queries retrieve via the inverted index."""
        from .bow import BinaryVocabulary, BowDatabase
        all_desc = np.concatenate([d for _, d in self.entries], axis=0)
        # cap training set for speed — vocabulary quality saturates fast
        if len(all_desc) > 20000:
            sel = np.random.default_rng(0).choice(len(all_desc), 20000,
                                                  replace=False)
            all_desc = all_desc[sel]
        vocab = BinaryVocabulary(branching=branching, levels=levels).fit(
            all_desc)
        self._bow_db = BowDatabase(vocab)
        for idx, (_, desc) in enumerate(self.entries):
            self._bow_db.add(idx, desc)

    def _candidate_indices(self, q: np.ndarray, top_k: int) -> List[int]:
        if self._bow_db is None and len(self.entries) > self.bow_threshold:
            self.build_bow_index()
        if self._bow_db is not None:
            # over-fetch candidates: geometric verification re-ranks
            return [i for i, _ in self._bow_db.query(q, top_k=top_k * 4)]
        return list(range(len(self.entries)))

    def query(self, image, top_k: int = 3,
              min_matches: int = 15) -> List[Tuple[int, int]]:
        """-> [(keyframe_id, n_good_matches)] ranked best-first."""
        q = self._describe(image)
        if q is None or len(q) < 8:
            return []
        scored = []
        for idx in self._candidate_indices(q, top_k):
            kid, desc = self.entries[idx]
            knn = self.matcher.knnMatch(q, desc, k=2)
            good = 0
            for pair in knn:
                if len(pair) == 2 and pair[0].distance < self.ratio * pair[1].distance:
                    good += 1
            if good >= min_matches:
                scored.append((kid, good))
        scored.sort(key=lambda kv: -kv[1])
        return scored[:top_k]
