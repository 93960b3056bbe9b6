"""Word2Vec skip-gram with stopword filtering and nearest-word queries
(reference Word2VecRawTextExample role)."""
from deeplearning4j_tpu_torch.nlp import StopWordsRemover, Word2Vec
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.scripts import _common

SENTENCES = [
    "the king rules the kingdom",
    "the queen rules the kingdom",
    "a dog chases the cat",
    "a cat chases the mouse",
    "the king and the queen sit on thrones",
    "dogs and cats are animals",
] * 50
EPOCHS = 5


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    tf = DefaultTokenizerFactory()
    tf.set_token_pre_processor(StopWordsRemover())
    w2v = Word2Vec(sentence_iterator=SENTENCES, tokenizer_factory=tf,
                   layer_size=32, window_size=3, negative_sample=5,
                   epochs=EPOCHS, min_word_frequency=2, seed=1,
                   device=device)
    w2v.fit()
    print("king ~", w2v.words_nearest("king", 3))
    print("sim(king, queen) =", round(w2v.similarity("king", "queen"), 3))
    print("sim(king, mouse) =", round(w2v.similarity("king", "mouse"), 3))
    return w2v


if __name__ == "__main__":
    main()
