"""Korean tokenization through the TokenizerFactory seam (counterpart
of `deeplearning4j_tpu/nlp/korean.py`; host Python).

Reference role: `deeplearning4j-nlp-korean` (`KoreanTokenizer.java:34`,
83 LoC) wraps the twitter-korean-text processor, whose load-bearing
behavior for embedding pipelines is MORPHEME separation: Korean spaces
delimit eojeol (word + attached particles/endings), so a whitespace
tokenizer conflates 고양이가/고양이는/고양이를 into distinct "words".
This module reproduces that capability at seed scale: whitespace
pre-split, then longest-suffix separation of josa (case particles) and
common eomi (verb/adjective endings) from the stem, with hangul-final
(batchim) agreement checks for the particle alternations (이/가, 은/는,
을/를, 과/와, 으로/로).

Like the reference (twitter-korean-text emits particles as their own
tokens), stems and particles both surface as tokens; `pos_keep`
filters to content morphemes for embedding corpora (same knob as
`nlp/japanese.py`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenPreProcess,
    Tokenizer,
    TokenizerFactory,
)

# (suffix, needs_batchim) — None: either; True: only after a final
# consonant; False: only after a vowel. Longest match wins.
_JOSA = [
    ("에게서", None), ("으로부터", True), ("로부터", False), ("에서", None),
    ("에게", None), ("부터", None), ("까지", None), ("처럼", None),
    ("보다", None), ("하고", None), ("이나", True), ("마다", None),
    ("으로", True), ("로", False), ("와", False), ("과", True),
    ("은", True), ("는", False), ("이", True), ("가", False),
    ("을", True), ("를", False), ("의", None), ("에", None),
    ("도", None), ("만", None), ("나", False), ("요", None),
]

_EOMI = [
    ("했습니다", None), ("했다", None), ("해요", None),   # 하다 light verb
    ("습니다", True), ("ㅂ니다", False), ("었습니다", None), ("았습니다", None),
    ("어요", None), ("아요", None), ("예요", False), ("이에요", True),
    ("었다", None), ("았다", None), ("는다", None), ("ㄴ다", None),
    ("지만", None), ("면서", None), ("려고", None), ("어서", None),
    ("아서", None), ("고", None), ("면", None), ("다", None),
]


def _is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7A3


def _has_batchim(ch: str) -> bool:
    """Does the syllable end in a final consonant? (jongseong != 0 in
    the Unicode hangul-syllable decomposition)."""
    return _is_hangul(ch) and (ord(ch) - 0xAC00) % 28 != 0


def _split_suffix(word: str, table, min_stem: int = 1):
    """Longest matching suffix whose batchim constraint agrees with the
    stem's last syllable; None if nothing splits."""
    for suffix, needs in sorted(table, key=lambda e: -len(e[0])):
        if not word.endswith(suffix):
            continue
        stem = word[: len(word) - len(suffix)]
        if len(stem) < min_stem or not all(_is_hangul(c) for c in stem):
            continue
        if needs is not None and _has_batchim(stem[-1]) != needs:
            continue
        return stem, suffix
    return None


class KoreanSegmenter:
    """Eojeol → morphemes: (surface, pos) with pos in
    {noun-ish "stem", "josa", "eomi", "other"}."""

    def tokenize_with_pos(self, text: str) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for word in text.split():
            word = word.strip(".,!?;:()[]{}\"'…「」")
            if not word:
                continue
            if not all(_is_hangul(c) for c in word):
                out.append((word, "other"))
                continue
            hit = _split_suffix(word, _JOSA)
            if hit:
                out.append((hit[0], "stem"))
                out.append((hit[1], "josa"))
                continue
            hit = _split_suffix(word, _EOMI, min_stem=1)
            if hit:
                out.append((hit[0], "stem"))
                out.append((hit[1], "eomi"))
                continue
            out.append((word, "stem"))
        return out

    def segment(self, text: str) -> List[str]:
        return [s for s, _ in self.tokenize_with_pos(text)]


#: content morphemes for embedding corpora (drop particles/endings)
CONTENT_POS = frozenset({"stem", "other"})


class KoreanTokenizer(Tokenizer):
    def __init__(self, sentence: str, segmenter: KoreanSegmenter,
                 preprocessor: Optional[TokenPreProcess] = None,
                 pos_keep: Optional[frozenset] = None):
        toks = (segmenter.segment(sentence) if pos_keep is None else
                [s for s, pos in segmenter.tokenize_with_pos(sentence)
                 if pos in pos_keep])
        super().__init__(toks, preprocessor)


class KoreanTokenizerFactory(TokenizerFactory):
    """Reference `KoreanTokenizerFactory.java` seam."""

    def __init__(self, segmenter: Optional[KoreanSegmenter] = None,
                 preprocessor: Optional[TokenPreProcess] = None,
                 pos_keep: Optional[frozenset] = None):
        self.segmenter = segmenter or KoreanSegmenter()
        self.preprocessor = preprocessor
        self.pos_keep = pos_keep

    def create(self, sentence: str) -> Tokenizer:
        return KoreanTokenizer(sentence, self.segmenter,
                               self.preprocessor, self.pos_keep)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.preprocessor = pre
        return self
