"""Word-vector serialization (counterpart of
`deeplearning4j_tpu/nlp/serializer.py`; each package reads the other's
files: the formats are the same bytes).

Reference: `models/embeddings/loader/WordVectorSerializer.java`
(2,824 LoC) — Google word2vec binary + text formats and DL4J's own
formats. The two interchange formats implemented here are the ones
other tools read/write:

- Google BINARY: header "V D\\n", then per word: "word " + D float32 LE
  + "\\n" (`writeWordVectors`/`readBinaryModel` semantics)
- TEXT: one "word v1 v2 ... vD" line per word (`loadTxtVectors`)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors, SequenceVectorsConfig
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord


def _check_word(word: str) -> str:
    """Both interchange formats delimit words by whitespace; tokens with
    spaces/newlines (e.g. n-grams) cannot round-trip — fail at write
    time rather than corrupt the file."""
    if any(c.isspace() for c in word):
        raise ValueError(
            f"word {word!r} contains whitespace — not representable in the "
            "word2vec text/binary formats (join n-grams with '_' first)")
    return word


class WordVectorSerializer:
    # ----------------------------------------------------------- binary
    @staticmethod
    def write_binary(vectors: SequenceVectors, path):
        path = Path(path)
        V = vectors.vocab.num_words()
        D = vectors.conf.vector_length
        with open(path, "wb") as f:
            f.write(f"{V} {D}\n".encode())
            for i in range(V):
                word = _check_word(vectors.vocab.word_at_index(i))
                f.write(word.encode("utf-8") + b" ")
                f.write(np.asarray(vectors.syn0[i], np.float32).tobytes())
                f.write(b"\n")

    @staticmethod
    def read_binary(path, device="cuda") -> SequenceVectors:
        path = Path(path)
        with open(path, "rb") as f:
            header = b""
            while not header.endswith(b"\n"):
                header += f.read(1)
            V, D = (int(x) for x in header.split())
            words, rows = [], []
            for _ in range(V):
                word = b""
                while True:
                    ch = f.read(1)
                    if ch in (b" ", b""):
                        break
                    word += ch
                words.append(word.decode("utf-8"))
                rows.append(np.frombuffer(f.read(4 * D), np.float32))
                nl = f.read(1)
                if nl not in (b"\n", b""):  # some writers omit the newline
                    f.seek(-1, 1)
        cache = VocabCache()
        for w in words:
            cache.add_token(VocabWord(w))
        cache.finalize_vocab()
        table = np.zeros((V, D), np.float32)
        for w, r in zip(words, rows):
            table[cache.index_of(w)] = r
        return WordVectorSerializer._assemble(cache, table, path, device)

    # ------------------------------------------------------------- text
    @staticmethod
    def write_text(vectors: SequenceVectors, path):
        with open(path, "w", encoding="utf-8") as f:
            for i in range(vectors.vocab.num_words()):
                vec = " ".join(f"{v:.6f}" for v in np.asarray(vectors.syn0[i]))
                f.write(f"{_check_word(vectors.vocab.word_at_index(i))} {vec}\n")

    @staticmethod
    def read_text(path, device="cuda") -> SequenceVectors:
        words, rows = [], []
        first = True
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if not line.strip():
                    continue
                if (first and len(parts) == 2
                        and parts[0].isdigit() and parts[1].isdigit()):
                    first = False
                    continue  # optional "V D" header
                first = False
                words.append(parts[0])
                rows.append(np.array([float(x) for x in parts[1:]], np.float32))
        if not rows:
            raise ValueError(f"{path}: no vectors found")
        cache = VocabCache()
        for w in words:
            cache.add_token(VocabWord(w))
        cache.finalize_vocab()
        table = np.zeros((len(words), len(rows[0])), np.float32)
        for w, r in zip(words, rows):
            table[cache.index_of(w)] = r
        return WordVectorSerializer._assemble(cache, table, path, device)

    @staticmethod
    def _assemble(cache: VocabCache, table: np.ndarray, path,
                  device) -> SequenceVectors:
        # finalize_vocab may reorder by frequency (all 1.0 → ties by word);
        # reindex table rows to the cache order
        sv = SequenceVectors(SequenceVectorsConfig(vector_length=table.shape[1]),
                             device=device)
        sv.vocab = cache
        sv.syn0 = table
        sv.syn1neg = np.zeros_like(table)
        sv.syn1 = np.zeros_like(table)
        return sv
