"""Tokenizers, token preprocessors, factories.

Reference: `text/tokenization/tokenizer/*` +
`tokenizerfactory/DefaultTokenizerFactory.java` — Tokenizer iterates
tokens of one string; TokenPreProcess normalises each token; factories
stamp out configured tokenizers per sentence. (UIMA/Kuromoji/ansj
language plug-ins are third-party segmenters in the reference; the
factory protocol here is the plug-in point for equivalents.)

The port's own copy of `deeplearning4j_tpu/nlp/tokenization.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from typing import List, Optional


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/specials (reference
    `preprocessor/CommonPreprocessor.java`)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer for plurals/edges (reference
    `preprocessor/EndingPreProcessor.java`)."""

    def pre_process(self, token: str) -> str:
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class Tokenizer:
    """Token stream over one sentence (reference `tokenizer/Tokenizer.java`)."""

    def __init__(self, tokens: List[str], preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor
        self._idx = 0

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._idx]
        self._idx += 1
        return self._pre.pre_process(tok) if self._pre else tok

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenizer (reference `DefaultTokenizer.java` uses
    StringTokenizer)."""

    def __init__(self, sentence: str, preprocessor=None):
        super().__init__(sentence.split(), preprocessor)


class NGramTokenizer(Tokenizer):
    """Sliding n-gram tokens (reference `NGramTokenizer.java`)."""

    def __init__(self, sentence: str, min_n: int, max_n: int, preprocessor=None):
        base = DefaultTokenizer(sentence, preprocessor).get_tokens()
        tokens = list(base) if min_n == 1 else []
        for n in range(max(2, min_n), max_n + 1):
            for i in range(len(base) - n + 1):
                tokens.append(" ".join(base[i:i + n]))
        super().__init__(tokens, None)


class TokenizerFactory:
    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess) -> "TokenizerFactory":
        self._pre = pre
        return self


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self, preprocessor: Optional[TokenPreProcess] = None):
        self._pre = preprocessor

    def create(self, sentence: str) -> Tokenizer:
        return DefaultTokenizer(sentence, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n: int = 1, max_n: int = 2,
                 preprocessor: Optional[TokenPreProcess] = None):
        self.min_n, self.max_n = min_n, max_n
        self._pre = preprocessor

    def create(self, sentence: str) -> Tokenizer:
        return NGramTokenizer(sentence, self.min_n, self.max_n, self._pre)
