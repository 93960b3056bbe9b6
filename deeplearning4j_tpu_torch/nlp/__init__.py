"""NLP stack (counterpart of `deeplearning4j_tpu/nlp/`; reference:
deeplearning4j-nlp-parent, SURVEY.md §2.5).

The SequenceVectors engine batches the reference's Hogwild per-pair
updates (`SequenceVectors.java:294-296`): the host packs (center,
context, negatives) batches, the device runs one step per batch —
gathers, batched dot products and scatter-adds on `device` (CUDA by
default); skip-gram/CBOW, hierarchical softmax and negative sampling,
subsampling, lr decay. Word2Vec, ParagraphVectors, GloVe and the graph
embeddings (`deeplearning4j_tpu_torch.graph`) train through it; the
tokenizers, iterators, vocab, vectorizers and the word-vector formats
are host code.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    Tokenizer,
    DefaultTokenizer,
    NGramTokenizer,
    TokenizerFactory,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    CommonPreprocessor,
    EndingPreProcessor,
)
from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    SentenceIterator,
    BasicLineIterator,
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelledDocument,
    LabelAwareIterator,
    SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabWord, VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors, SequenceVectorsConfig
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.paragraphvectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.bagofwords import CountVectorizer, TfidfVectorizer
from deeplearning4j_tpu_torch.nlp.iterator import CnnSentenceDataSetIterator
from deeplearning4j_tpu_torch.nlp.stopwords import StopWords, StopWordsRemover
from deeplearning4j_tpu_torch.nlp.invertedindex import InvertedIndex
from deeplearning4j_tpu_torch.nlp.documentiterator import (
    CollectionDocumentIterator,
    DocumentIterator,
    FileDocumentIterator,
    FileLabelAwareIterator,
    FilenamesLabelAwareIterator,
)
