"""Stop-word handling.

Reference: `deeplearning4j-nlp/.../text/stopwords/StopWords.java` (loads
a bundled `stopwords` resource list) and its use as a token filter in
the text pipelines. Here the default English list ships inline, the
class supports custom lists/files, and `StopWordsRemover` plugs into
the tokenizer-factory pre-processor seam (`TokenPreProcess`) so any
tokenizer drops stop words in-stream.

The port's own copy of `deeplearning4j_tpu/nlp/stopwords.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from deeplearning4j_tpu_torch.nlp.tokenization import TokenPreProcess

# The classic English stop-word list (the reference bundles an
# equivalent resource file).
_DEFAULT_STOPWORDS = """
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll
he's her here here's hers herself him himself his how how's i i'd i'll
i'm i've if in into is isn't it it's its itself let's me more most
mustn't my myself no nor not of off on once only or other ought our
ours ourselves out over own same shan't she she'd she'll she's should
shouldn't so some such than that that's the their theirs them themselves
then there there's these they they'd they'll they're they've this those
through to too under until up very was wasn't we we'd we'll we're we've
were weren't what what's when when's where where's which while who who's
whom why why's with won't would wouldn't you you'd you'll you're you've
your yours yourself yourselves
""".split()


class StopWords:
    """Holds a stop-word set (reference `StopWords.getStopWords()`)."""

    _default: Optional["StopWords"] = None

    def __init__(self, words: Optional[Iterable[str]] = None,
                 case_sensitive: bool = False):
        self.case_sensitive = case_sensitive
        src = _DEFAULT_STOPWORDS if words is None else words
        self.words = set(w if case_sensitive else w.lower() for w in src)

    @classmethod
    def get_stop_words(cls) -> List[str]:
        return sorted(cls.default().words)

    @classmethod
    def default(cls) -> "StopWords":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    @classmethod
    def from_file(cls, path: str, **kw) -> "StopWords":
        with open(path) as f:
            return cls([line.strip() for line in f if line.strip()], **kw)

    def is_stop_word(self, token: str) -> bool:
        t = token if self.case_sensitive else token.lower()
        return t in self.words

    def filter(self, tokens: Iterable[str]) -> List[str]:
        return [t for t in tokens if not self.is_stop_word(t)]

    def __contains__(self, token: str) -> bool:
        return self.is_stop_word(token)

    def __len__(self):
        return len(self.words)


class StopWordsRemover(TokenPreProcess):
    """TokenPreProcess that maps stop words to "" (tokenizers drop empty
    tokens) — the filter seam the reference wires through
    `TokenizerFactory.setTokenPreProcessor`."""

    def __init__(self, stop_words: Optional[StopWords] = None,
                 inner: Optional[TokenPreProcess] = None):
        self.stop_words = stop_words or StopWords.default()
        self.inner = inner

    def pre_process(self, token: str) -> str:
        if self.inner is not None:
            token = self.inner.pre_process(token)
        return "" if self.stop_words.is_stop_word(token) else token
