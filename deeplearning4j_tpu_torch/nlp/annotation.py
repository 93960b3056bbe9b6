"""UIMA-style annotation pipeline (counterpart of
`deeplearning4j_tpu/nlp/annotation.py`; host Python).

Reference role: `deeplearning4j-nlp-uima` (3,212 LoC) wires Apache
UIMA AnalysisEngines — SentenceAnnotator, TokenizerAnnotator,
PoStagger, StemmerAnnotator — into the text pipeline via
`UimaSentenceIterator` / `UimaTokenizerFactory`: documents flow
through a CAS (typed annotation store), and downstream iterators read
the annotated spans. UIMA itself is a framework, not an algorithm —
what this module reproduces is that architecture:

- `AnnotatedDocument` (CAS role): immutable text + typed, offset-keyed
  `Annotation` spans with a feature dict;
- `Annotator` protocol (AnalysisEngine role) + `AnnotationPipeline`
  (aggregate engine role): each annotator reads existing annotations
  and adds its own;
- built-in annotators: sentence segmentation, tokenization (pluggable
  `TokenizerFactory` — the CJK/Japanese/Korean segmenters drop in),
  POS tagging (lexicon + suffix-rule English tagger by default,
  pluggable), and a suffix stemmer (SnowballProgram role);
- pipeline-fed iterators: `AnnotationSentenceIterator`
  (`UimaSentenceIterator` role) and `AnnotationTokenizerFactory`
  (`UimaTokenizerFactory` role) so Word2Vec/ParagraphVectors consume
  annotated corpora unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, List, Optional

from deeplearning4j_tpu_torch.nlp.sentenceiterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenPreProcess,
    Tokenizer,
    TokenizerFactory,
)


@dataclasses.dataclass
class Annotation:
    """One typed span over the document text (UIMA `AnnotationFS`)."""

    type: str
    begin: int
    end: int
    features: Dict[str, object] = dataclasses.field(default_factory=dict)


class AnnotatedDocument:
    """The CAS: one immutable text + accumulated annotations."""

    def __init__(self, text: str):
        self.text = text
        self.annotations: List[Annotation] = []

    def add(self, type: str, begin: int, end: int, **features) -> Annotation:
        a = Annotation(type, begin, end, dict(features))
        self.annotations.append(a)
        return a

    def select(self, type: str) -> List[Annotation]:
        """Spans of one type in document order (UIMA `select`)."""
        return sorted((a for a in self.annotations if a.type == type),
                      key=lambda a: (a.begin, a.end))

    def covered_text(self, a: Annotation) -> str:
        return self.text[a.begin:a.end]

    def covered(self, type: str, within: Annotation) -> List[Annotation]:
        """Spans of `type` inside `within` (UIMA `selectCovered`)."""
        return [a for a in self.select(type)
                if a.begin >= within.begin and a.end <= within.end]


class Annotator:
    """AnalysisEngine role: reads the CAS, adds annotations."""

    def process(self, doc: AnnotatedDocument) -> None:
        raise NotImplementedError


class AnnotationPipeline(Annotator):
    """Aggregate engine: run annotators in order (UIMA
    `AggregateBuilder`)."""

    def __init__(self, annotators: Iterable[Annotator]):
        self.annotators = list(annotators)

    def process(self, doc: AnnotatedDocument) -> None:
        for a in self.annotators:
            a.process(doc)

    def annotate(self, text: str) -> AnnotatedDocument:
        doc = AnnotatedDocument(text)
        self.process(doc)
        return doc


# ------------------------------------------------------------ annotators
_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "st", "vs", "e.g", "i.e",
           "etc", "jr", "sr", "inc", "fig"}


class SentenceAnnotator(Annotator):
    """Rule-based sentence segmentation (the UIMA SentenceAnnotator
    slot): split on ./!/? followed by whitespace + an uppercase or
    non-latin start, with an abbreviation guard."""

    _BOUNDARY = re.compile(r"[.!?。！？]+[\s]+")

    def process(self, doc: AnnotatedDocument) -> None:
        text = doc.text
        start = 0
        for m in self._BOUNDARY.finditer(text):
            prev = text[start:m.start()].rstrip()
            last_word = prev.rsplit(None, 1)[-1].lower() if prev else ""
            if last_word.rstrip(".") in _ABBREV:
                continue
            end = m.start() + len(m.group().rstrip())
            if end > start:
                doc.add("sentence", start, end)
            start = m.end()
        tail = text[start:].strip()
        if tail:
            doc.add("sentence", start + text[start:].index(tail[0]),
                    start + text[start:].index(tail[0]) + len(tail))


class TokenAnnotator(Annotator):
    """Tokenize each sentence span; any `TokenizerFactory` plugs in
    (whitespace/punct default; CJK/Japanese/Korean factories work
    unchanged). Token offsets are recovered by left-to-right search
    within the sentence."""

    def __init__(self, factory: Optional[TokenizerFactory] = None):
        self.factory = factory

    _DEFAULT = re.compile(r"\w+(?:['’]\w+)?", re.UNICODE)

    def process(self, doc: AnnotatedDocument) -> None:
        sentences = doc.select("sentence") or [
            doc.add("sentence", 0, len(doc.text))]
        for s in sentences:
            stext = doc.covered_text(s)
            if self.factory is None:
                for m in self._DEFAULT.finditer(stext):
                    doc.add("token", s.begin + m.start(),
                            s.begin + m.end())
                continue
            cursor = 0
            for tok in self.factory.create(stext).get_tokens():
                at = stext.find(tok, cursor)
                if at < 0:    # preprocessor rewrote the surface: fall
                    at = cursor   # back to cursor-anchored placement
                doc.add("token", s.begin + at, s.begin + at + len(tok),
                        surface=tok)
                cursor = at + len(tok)


# tiny English POS lexicon + suffix rules (the PoStagger slot — same
# architecture as the UIMA HMM tagger wrapper: lexicon first, then
# morphology, then default-noun)
_POS_LEXICON = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "is": "VB", "are": "VB", "was": "VB", "were": "VB", "be": "VB",
    "has": "VB", "have": "VB", "had": "VB", "do": "VB", "does": "VB",
    "and": "CC", "or": "CC", "but": "CC",
    "in": "IN", "on": "IN", "at": "IN", "of": "IN", "for": "IN",
    "to": "IN", "with": "IN", "from": "IN", "by": "IN",
    "he": "PRP", "she": "PRP", "it": "PRP", "they": "PRP", "we": "PRP",
    "i": "PRP", "you": "PRP",
    "not": "RB", "very": "RB", "quickly": "RB",
}
_POS_SUFFIX = [("ing", "VBG"), ("ed", "VBD"), ("ly", "RB"), ("s", "NNS"),
               ("tion", "NN"), ("ness", "NN"), ("ful", "JJ"),
               ("ous", "JJ"), ("ive", "JJ"), ("able", "JJ")]


def default_pos_tagger(token: str) -> str:
    low = token.lower()
    if low in _POS_LEXICON:
        return _POS_LEXICON[low]
    if low[:1].isdigit():
        return "CD"
    for suf, tag in _POS_SUFFIX:
        if len(low) > len(suf) + 2 and low.endswith(suf):
            return tag
    if token[:1].isupper():
        return "NNP"
    return "NN"


class POSAnnotator(Annotator):
    """Tag every token span with a `pos` feature."""

    def __init__(self, tagger: Optional[Callable[[str], str]] = None):
        self.tagger = tagger or default_pos_tagger

    def process(self, doc: AnnotatedDocument) -> None:
        for t in doc.select("token"):
            t.features["pos"] = self.tagger(
                t.features.get("surface", doc.covered_text(t)))


class StemAnnotator(Annotator):
    """Suffix stemmer (`StemmerAnnotator`/Snowball role): adds a
    `stem` feature used by stem-normalized vocabularies."""

    _RULES = [("ational", "ate"), ("ization", "ize"), ("fulness", "ful"),
              ("iveness", "ive"), ("ousness", "ous"), ("ies", "y"),
              ("sses", "ss"), ("ing", ""), ("edly", ""), ("ed", ""),
              ("ly", ""), ("s", "")]

    def process(self, doc: AnnotatedDocument) -> None:
        for t in doc.select("token"):
            w = t.features.get("surface", doc.covered_text(t)).lower()
            for suf, rep in self._RULES:
                if len(w) > len(suf) + 2 and w.endswith(suf):
                    w = w[: len(w) - len(suf)] + rep
                    break
            t.features["stem"] = w


def default_pipeline(tokenizer_factory=None, pos=True, stem=False):
    anns: List[Annotator] = [SentenceAnnotator(),
                             TokenAnnotator(tokenizer_factory)]
    if pos:
        anns.append(POSAnnotator())
    if stem:
        anns.append(StemAnnotator())
    return AnnotationPipeline(anns)


# ---------------------------------------------------- pipeline-fed seams
class AnnotationSentenceIterator(SentenceIterator):
    """`UimaSentenceIterator` role: documents → pipeline → one sentence
    per `next_sentence()`."""

    def __init__(self, documents: Iterable[str],
                 pipeline: Optional[AnnotationPipeline] = None):
        self.documents = list(documents)
        self.pipeline = pipeline or AnnotationPipeline(
            [SentenceAnnotator()])
        self.reset()

    def reset(self) -> None:
        self._sentences: List[str] = []
        for d in self.documents:
            doc = self.pipeline.annotate(d)
            self._sentences.extend(
                doc.covered_text(s) for s in doc.select("sentence"))
        self._idx = 0

    def has_next(self) -> bool:
        return self._idx < len(self._sentences)

    def next_sentence(self) -> str:
        s = self._sentences[self._idx]
        self._idx += 1
        return s


class AnnotationTokenizerFactory(TokenizerFactory):
    """`UimaTokenizerFactory` role: create() runs the pipeline over the
    sentence; `pos_keep` filters tokens by POS tag, `use_stems=True`
    emits stem features instead of surfaces."""

    def __init__(self, pipeline: Optional[AnnotationPipeline] = None,
                 preprocessor: Optional[TokenPreProcess] = None,
                 pos_keep: Optional[frozenset] = None,
                 use_stems: bool = False):
        self.pipeline = pipeline or default_pipeline(
            pos=True, stem=use_stems)
        self.preprocessor = preprocessor
        self.pos_keep = pos_keep
        self.use_stems = use_stems

    def create(self, sentence: str) -> Tokenizer:
        doc = self.pipeline.annotate(sentence)
        toks = []
        for t in doc.select("token"):
            if self.pos_keep is not None and \
                    t.features.get("pos") not in self.pos_keep:
                continue
            if self.use_stems and "stem" in t.features:
                toks.append(t.features["stem"])
            else:
                toks.append(t.features.get("surface",
                                           doc.covered_text(t)))
        return Tokenizer(toks, self.preprocessor)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.preprocessor = pre
        return self
