"""Dictionary-driven CJK segmentation through the TokenizerFactory seam
(counterpart of `deeplearning4j_tpu/nlp/cjk.py`; host Python).

Reference role: `deeplearning4j-nlp-chinese` (bundles the ansj
segmenter, ~9.5k LoC) and `deeplearning4j-nlp-japanese` (bundles
kuromoji, `com/atilika/kuromoji/`, ~6.8k LoC) ship TokenizerFactory
implementations whose `create()` runs a real segmenter instead of
whitespace splitting. Those engines are third-party dictionaries+code;
what this module reproduces is the *capability*: a working
non-whitespace segmenter driving the same seam, so CJK corpora train
through Word2Vec/SequenceVectors unchanged.

Algorithm: unigram-frequency DP over the word lattice (the same shape
ansj/jieba use): every dictionary word starting at position i adds an
edge i→i+len(w) with cost -log p(w); unknown single characters get a
floor probability; the min-cost path is the segmentation. Viterbi over
a DAG — O(n · max_word_len).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenPreProcess,
    Tokenizer,
    TokenizerFactory,
)

# Characters that never join words: CJK + ASCII punctuation, whitespace.
_PUNCT = set("，。！？；：、「」『』（）《》·…—,.!?;:()[]{}\"' \t\n\r")


class DictionarySegmenter:
    """Unigram-DP word segmenter over a frequency dictionary."""

    def __init__(self, freqs: Dict[str, float],
                 unknown_log_prob: float = -13.0):
        if not freqs:
            raise ValueError("empty dictionary")
        self.max_len = max(len(w) for w in freqs)
        total = float(sum(freqs.values()))
        self._logp = {w: math.log(f / total) for w, f in freqs.items()}
        self.unknown_log_prob = unknown_log_prob

    @classmethod
    def from_word_list(cls, words: Iterable[str], **kw):
        """Uniform frequencies; longer words still win via fewer edges."""
        return cls({w: 1.0 for w in words}, **kw)

    def segment(self, text: str) -> List[str]:
        out: List[str] = []
        for run in self._runs(text):
            if len(run) == 1 or self._is_foreign(run):
                out.append(run)
            else:
                out.extend(self._dp(run))
        return out

    # ---------------------------------------------------------------- impl
    @staticmethod
    def _is_foreign(run: str) -> bool:
        # whitespace-delimited latin/number runs pass through whole
        return all(ord(c) < 0x2E80 for c in run)

    @staticmethod
    def _runs(text: str):
        """Split into maximal runs of non-punctuation, also breaking at
        script boundaries so embedded latin/number tokens ("GPU和TPU")
        pass through whole instead of entering the CJK lattice."""
        cur: List[str] = []
        cur_foreign = False
        for c in text:
            if c in _PUNCT:
                if cur:
                    yield "".join(cur)
                    cur = []
                continue
            foreign = ord(c) < 0x2E80
            if cur and foreign != cur_foreign:
                yield "".join(cur)
                cur = []
            cur.append(c)
            cur_foreign = foreign
        if cur:
            yield "".join(cur)

    def _dp(self, run: str) -> List[str]:
        n = len(run)
        # best[i] = (cost to segment run[:i], start of last word)
        INF = float("inf")
        best_cost = [INF] * (n + 1)
        best_prev = [0] * (n + 1)
        best_cost[0] = 0.0
        for i in range(n):
            if best_cost[i] == INF:
                continue
            # unknown single char — floor edge keeps the DP connected
            c1 = best_cost[i] - self.unknown_log_prob
            if c1 < best_cost[i + 1]:
                best_cost[i + 1] = c1
                best_prev[i + 1] = i
            for L in range(1, min(self.max_len, n - i) + 1):
                w = run[i:i + L]
                lp = self._logp.get(w)
                if lp is None:
                    continue
                c = best_cost[i] - lp
                if c < best_cost[i + L]:
                    best_cost[i + L] = c
                    best_prev[i + L] = i
        words = []
        j = n
        while j > 0:
            i = best_prev[j]
            words.append(run[i:j])
            j = i
        words.reverse()
        return words


class CJKTokenizer(Tokenizer):
    def __init__(self, sentence: str, segmenter: DictionarySegmenter,
                 preprocessor: Optional[TokenPreProcess] = None):
        super().__init__(segmenter.segment(sentence), preprocessor)


class CJKTokenizerFactory(TokenizerFactory):
    """The nlp-chinese/-japanese TokenizerFactory role: constructed
    from a frequency dictionary (or plain word list), produces
    tokenizers that really segment."""

    def __init__(self, dictionary, preprocessor: Optional[TokenPreProcess] = None):
        if isinstance(dictionary, DictionarySegmenter):
            self.segmenter = dictionary
        elif isinstance(dictionary, dict):
            self.segmenter = DictionarySegmenter(dictionary)
        else:
            self.segmenter = DictionarySegmenter.from_word_list(dictionary)
        self.preprocessor = preprocessor

    def create(self, sentence: str) -> Tokenizer:
        return CJKTokenizer(sentence, self.segmenter, self.preprocessor)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.preprocessor = pre
        return self
