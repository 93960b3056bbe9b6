"""Vocabulary: VocabWord, VocabCache, VocabConstructor, Huffman coding.

Reference: `models/word2vec/VocabWord.java` (a SequenceElement with
frequency + Huffman codes/points), `wordstore/inmemory/AbstractCache`
(word↔index maps, frequency), `models/word2vec/wordstore/
VocabConstructor.java` (corpus scan, min-frequency pruning) and
`graph/huffman/` (code assignment for hierarchical softmax).

The port's own copy of `deeplearning4j_tpu/nlp/vocab.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional


class VocabWord:
    """One vocabulary element (reference `VocabWord.java`)."""

    __slots__ = ("word", "frequency", "index", "codes", "points")

    def __init__(self, word: str, frequency: float = 1.0):
        self.word = word
        self.frequency = frequency
        self.index = -1
        self.codes: List[int] = []    # Huffman bits, root→leaf
        self.points: List[int] = []   # inner-node indices, root→leaf

    def increment(self, by: float = 1.0):
        self.frequency += by

    def __repr__(self):
        return f"VocabWord({self.word!r}, f={self.frequency})"


class VocabCache:
    """word↔index↔VocabWord store (reference `AbstractCache.java`)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0.0

    def add_token(self, vw: VocabWord):
        if vw.word in self._words:
            self._words[vw.word].increment(vw.frequency)
        else:
            self._words[vw.word] = vw

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.frequency if vw else 0.0

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, idx: int) -> str:
        return self._by_index[idx].word

    def element_at_index(self, idx: int) -> VocabWord:
        return self._by_index[idx]

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def finalize_vocab(self):
        """Assign indices by descending frequency (reference sorts by
        frequency so negative-sampling tables are cache-friendly)."""
        self._by_index = sorted(self._words.values(),
                                key=lambda v: (-v.frequency, v.word))
        for i, vw in enumerate(self._by_index):
            vw.index = i
        self.total_word_count = sum(v.frequency for v in self._by_index)


def build_huffman(cache: VocabCache) -> int:
    """Assign Huffman codes/points to every word (reference
    `graph/huffman/GraphHuffman.java` / word2vec Huffman). Returns the
    number of inner nodes (= hierarchical-softmax table rows needed)."""
    n = cache.num_words()
    if n == 0:
        return 0
    heap = [(vw.frequency, i, ("leaf", i)) for i, vw in
            enumerate(cache._by_index)]
    heapq.heapify(heap)
    next_inner = 0
    children: Dict[int, tuple] = {}
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        inner = next_inner
        next_inner += 1
        children[inner] = (n1, n2)
        heapq.heappush(heap, (f1 + f2, n + inner, ("inner", inner)))
    # walk the tree assigning codes
    _, _, root = heap[0]
    stack = [(root, [], [])]
    while stack:
        node, codes, points = stack.pop()
        kind, idx = node
        if kind == "leaf":
            vw = cache._by_index[idx]
            vw.codes = codes
            vw.points = points
        else:
            left, right = children[idx]
            stack.append((left, codes + [0], points + [idx]))
            stack.append((right, codes + [1], points + [idx]))
    return next_inner


class VocabConstructor:
    """Builds a VocabCache from token sequences (reference
    `VocabConstructor.java:buildJointVocabulary`)."""

    def __init__(self, min_word_frequency: int = 1, build_huffman_tree: bool = True):
        self.min_word_frequency = min_word_frequency
        self.build_huffman_tree = build_huffman_tree

    def build(self, sequences: Iterable[List[str]]) -> VocabCache:
        cache = VocabCache()
        for tokens in sequences:
            for tok in tokens:
                cache.add_token(VocabWord(tok))
        if self.min_word_frequency > 1:
            cache._words = {w: vw for w, vw in cache._words.items()
                            if vw.frequency >= self.min_word_frequency}
        cache.finalize_vocab()
        if self.build_huffman_tree:
            build_huffman(cache)
        return cache
