"""Word2Vec over raw (unspaced) Chinese text via the CJK tokenizer
seam (reference role: deeplearning4j-nlp-chinese's ansj
TokenizerFactory). The dictionary-DP segmenter turns character runs
into words; Word2Vec then trains exactly as it does for English."""
from deeplearning4j_tpu_torch.nlp.cjk import CJKTokenizerFactory
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.scripts import _common

LEXICON = {
    "猫": 50, "狗": 50, "鱼": 40, "肉": 40, "吃": 60, "喜欢": 60,
    "宠物": 30, "可爱": 25, "公园": 20, "玩": 25,
    "银行": 40, "股票": 40, "市场": 40, "价格": 30, "投资": 25,
    "上涨": 20, "我": 80, "的": 100, "在": 60, "和": 60, "了": 60,
}

CORPUS = [
    "我的猫喜欢吃鱼", "狗在公园玩", "我喜欢我的狗", "宠物猫吃鱼和肉",
    "可爱的猫在玩", "狗喜欢吃肉",
    "股票价格上涨了", "投资股票的价格", "银行投资市场", "价格在市场上涨",
] * 8
EPOCHS = 4


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    w2v = Word2Vec(sentence_iterator=CORPUS,
                   tokenizer_factory=CJKTokenizerFactory(LEXICON),
                   layer_size=24, window_size=3, min_word_frequency=2,
                   negative_sample=5, epochs=EPOCHS, seed=7, device=device)
    w2v.fit()
    print("nearest to 猫:", w2v.words_nearest("猫", top_n=4))
    print("nearest to 股票:", w2v.words_nearest("股票", top_n=4))
    print("sim(猫,狗) =", round(w2v.similarity("猫", "狗"), 3),
          " sim(猫,股票) =", round(w2v.similarity("猫", "股票"), 3))
    return w2v


if __name__ == "__main__":
    main()
