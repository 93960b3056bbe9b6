"""Japanese morphological segmentation through the TokenizerFactory
seam (Kuromoji role; counterpart of `deeplearning4j_tpu/nlp/japanese.py`,
host Python over the port's own copy of `nlp/data/ja_dict.tsv`).

Reference role: `deeplearning4j-nlp-japanese` bundles the Kuromoji
tokenizer (~6.8k LoC under `com/atilika/kuromoji/`) behind a
TokenizerFactory so Japanese corpora — written without spaces — drive
Word2Vec/SequenceVectors unchanged. This module reproduces the
*capability* with the same algorithmic shape Kuromoji uses, at seed-
dictionary scale:

- a **morpheme lattice**: every dictionary entry (surface, POS, cost)
  matching at position i adds an edge i → i+len(surface);
- **unknown-word invocation by character class** (kanji / hiragana /
  katakana / latin / digit runs get class-specific candidate edges and
  costs — the kuromoji `unk.def` idea), so OOV text still segments;
- **joint Viterbi over (position, POS)** minimizing word cost +
  POS-bigram connection cost — the same min-sum recurrence as
  `util/viterbi.py` (`Viterbi.java` role), specialized to the
  variable-length-edge DAG a word lattice is.

`JapaneseTokenizerFactory` plugs the segmenter into the text pipeline;
`tokenize_with_pos` exposes the POS tags for downstream filtering
(kuromoji's Token.getPartOfSpeech surface).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenPreProcess,
    Tokenizer,
    TokenizerFactory,
)

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "data", "ja_dict.tsv")

POS_TAGS = ("noun", "verb", "adj", "particle", "aux", "adverb",
            "prefix", "suffix", "unk", "punct")

# POS-bigram connection costs (the kuromoji matrix.def role, seed
# scale): favored transitions — particle after content word, content
# word after particle, aux after verb/adj — are cheap; doubled
# particles or aux after particle are penalized.
_CONN_DEFAULT = 1000.0
_CONN = {
    ("noun", "particle"): 0.0, ("verb", "particle"): 100.0,
    ("adj", "particle"): 200.0, ("particle", "noun"): 0.0,
    ("particle", "verb"): 100.0, ("particle", "adj"): 200.0,
    ("particle", "adverb"): 300.0, ("particle", "particle"): 1800.0,
    ("verb", "aux"): 0.0, ("adj", "aux"): 100.0, ("noun", "aux"): 400.0,
    ("aux", "particle"): 600.0, ("adverb", "verb"): 100.0,
    ("adverb", "adj"): 100.0, ("noun", "noun"): 900.0,
    ("noun", "suffix"): 0.0, ("prefix", "noun"): 0.0,
    ("BOS", "noun"): 0.0, ("BOS", "verb"): 400.0, ("BOS", "adverb"): 300.0,
    ("BOS", "adj"): 400.0, ("BOS", "prefix"): 300.0,
    ("BOS", "particle"): 1500.0,
}

_PUNCT = set("、。！？…・「」『』（）【】；：,.!?;:()[]{}\"' \t\n\r　")


def _char_class(ch: str) -> str:
    o = ord(ch)
    if ch in _PUNCT:
        return "punct"
    if 0x4E00 <= o <= 0x9FFF or ch in "々〆ヶ":
        return "kanji"
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or ch == "ー":
        return "katakana"
    if ch.isdigit() or 0xFF10 <= o <= 0xFF19:
        return "digit"
    if (ch.isascii() and ch.isalpha()) or 0xFF21 <= o <= 0xFF3A \
            or 0xFF41 <= o <= 0xFF5A:   # fullwidth A-Z / a-z only —
        return "latin"                  # the gap (FF3B-FF40) is punct
    return "other"


# unknown-word candidate policy per character class (unk.def role):
# (group whole same-class run?, cost per candidate)
_UNK = {
    "kanji": (False, 9000.0),      # kanji: single-char candidates
    "hiragana": (False, 11000.0),  # hiragana is mostly function words —
                                   # heavily penalized so dictionary
                                   # entries win
    "katakana": (True, 6000.0),    # katakana runs are usually one
                                   # loanword — group the run
    "latin": (True, 5000.0),
    "digit": (True, 5000.0),
    "other": (False, 12000.0),
}


def load_seed_dictionary(path: Optional[str] = None) -> Dict[str, List[Tuple[str, float]]]:
    """surface → [(pos, cost), ...] from the committed TSV."""
    entries: Dict[str, List[Tuple[str, float]]] = {}
    with open(path or _DATA, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            surface, pos, cost = line.split("\t")
            entries.setdefault(surface, []).append((pos, float(cost)))
    return entries


class JapaneseSegmenter:
    """Lattice + Viterbi morphological segmenter (Kuromoji role)."""

    def __init__(self, entries: Optional[Dict] = None,
                 user_entries: Optional[Iterable[Tuple[str, str, float]]] = None,
                 conn: Optional[Dict] = None):
        base = load_seed_dictionary() if entries is None else entries
        # copy the value lists too — appending user entries must not
        # mutate a caller-shared dictionary
        self.entries = {s: list(v) for s, v in base.items()}
        for surface, pos, cost in (user_entries or ()):
            self.entries.setdefault(surface, []).append((pos, float(cost)))
        self.max_len = max((len(s) for s in self.entries), default=1)
        self.conn = _CONN if conn is None else conn

    def _conn_cost(self, prev_pos: str, pos: str) -> float:
        return self.conn.get((prev_pos, pos), _CONN_DEFAULT)

    def tokenize_with_pos(self, text: str) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        run: List[str] = []
        for ch in text:
            if ch in _PUNCT:
                if run:
                    out.extend(self._viterbi("".join(run)))
                    run = []
            else:
                run.append(ch)
        if run:
            out.extend(self._viterbi("".join(run)))
        return out

    def segment(self, text: str) -> List[str]:
        return [s for s, _ in self.tokenize_with_pos(text)]

    # ------------------------------------------------------------- lattice
    def _candidates(self, text: str, i: int):
        """Edges starting at position i: dictionary matches + class-
        driven unknown words. Yields (surface, pos, cost)."""
        n = len(text)
        found_dict = False
        for L in range(1, min(self.max_len, n - i) + 1):
            surface = text[i:i + L]
            for pos, cost in self.entries.get(surface, ()):
                found_dict = True
                yield surface, pos, cost
        cls = _char_class(text[i])
        group, unk_cost = _UNK.get(cls, _UNK["other"])
        if group:
            j = i + 1
            while j < n and _char_class(text[j]) == cls:
                j += 1
            yield text[i:j], "unk", unk_cost
        if not found_dict or not group:
            # single-char fallback keeps the lattice connected even
            # when no dictionary edge covers position i
            yield text[i], "unk", unk_cost

    def _viterbi(self, text: str) -> List[Tuple[str, str]]:
        """Min-cost path through the (position, POS) lattice — the
        `util/viterbi.py` min-sum recurrence on a variable-edge DAG."""
        n = len(text)
        # best[(i, pos)] = (cost, back-pointer (j, prev_pos, surface))
        INF = math.inf
        best: Dict[Tuple[int, str], Tuple[float, Optional[Tuple]]] = {
            (0, "BOS"): (0.0, None)}
        frontier: Dict[int, List[str]] = {0: ["BOS"]}
        for i in range(n):
            states = frontier.pop(i, [])
            if not states:
                continue
            for surface, pos, wcost in self._candidates(text, i):
                j = i + len(surface)
                for prev_pos in states:
                    base = best[(i, prev_pos)][0]
                    cost = base + wcost + self._conn_cost(prev_pos, pos)
                    key = (j, pos)
                    if cost < best.get(key, (INF, None))[0]:
                        best[key] = (cost,
                                     (i, prev_pos, surface))
                        if pos not in frontier.setdefault(j, []):
                            frontier[j].append(pos)
        # pick the cheapest end state and walk back
        end = min(((c, pos) for (j, pos), (c, _) in best.items() if j == n),
                  default=None)
        if end is None:    # unreachable text (shouldn't happen)
            return [(text, "unk")]
        pos = end[1]
        i = n
        toks: List[Tuple[str, str]] = []
        while i > 0:
            _, bp = best[(i, pos)]
            j, prev_pos, surface = bp
            toks.append((surface, pos))
            i, pos = j, prev_pos
        toks.reverse()
        return toks


class JapaneseTokenizer(Tokenizer):
    def __init__(self, sentence: str, segmenter: JapaneseSegmenter,
                 preprocessor: Optional[TokenPreProcess] = None,
                 pos_keep: Optional[frozenset] = None):
        toks = (segmenter.segment(sentence) if pos_keep is None else
                [s for s, pos in segmenter.tokenize_with_pos(sentence)
                 if pos in pos_keep])
        super().__init__(toks, preprocessor)


#: content-word POS set for embedding training — the standard Kuromoji
#: usage pattern (filter particles/auxiliaries by POS before word2vec)
CONTENT_POS = frozenset({"noun", "verb", "adj", "adverb", "prefix",
                         "suffix", "unk"})


class JapaneseTokenizerFactory(TokenizerFactory):
    """Reference role: kuromoji's `JapaneseTokenizerFactory`
    (deeplearning4j-nlp-japanese) — a drop-in TokenizerFactory whose
    `create()` runs morphological analysis instead of whitespace
    splitting. `pos_keep` optionally filters tokens by POS (e.g.
    `CONTENT_POS` drops particles/aux — the usual preprocessing for
    embedding corpora, where function words are noise)."""

    def __init__(self, segmenter: Optional[JapaneseSegmenter] = None,
                 preprocessor: Optional[TokenPreProcess] = None,
                 pos_keep: Optional[frozenset] = None):
        self.segmenter = segmenter or JapaneseSegmenter()
        self.preprocessor = preprocessor
        self.pos_keep = pos_keep

    def create(self, sentence: str) -> Tokenizer:
        return JapaneseTokenizer(sentence, self.segmenter,
                                 self.preprocessor, self.pos_keep)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.preprocessor = pre
        return self
