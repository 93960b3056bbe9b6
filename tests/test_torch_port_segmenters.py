"""The port's segmenters and annotation pipeline
(`deeplearning4j_tpu_torch/nlp/{cjk,japanese,korean,annotation}.py`) held
against the JAX package's on the CPU.

- Every case of tests/test_nlp_{cjk,japanese,korean,annotation}.py on
  the port (the Word2Vec fits on the CPU).
- Token streams, POS tags, stems, sentence spans and feature dicts equal
  to JAX's on those tests' corpora and sentences.
- The port's copy of `nlp/data/ja_dict.tsv` byte for byte the JAX
  package's.
- Word2Vec through each tokenizer factory fitted from one seed in both
  packages: the vocab equal and the tables within FIT_ATOL (every draw is
  numpy, in the same order).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import functools
import os

import numpy as np
import pytest

import deeplearning4j_tpu.nlp as JN
from deeplearning4j_tpu.nlp import annotation as JA
from deeplearning4j_tpu.nlp import cjk as JC
from deeplearning4j_tpu.nlp import japanese as JJ
from deeplearning4j_tpu.nlp import korean as JK
import deeplearning4j_tpu_torch.nlp as PN
from deeplearning4j_tpu_torch.nlp import annotation as PA
from deeplearning4j_tpu_torch.nlp import cjk as PC
from deeplearning4j_tpu_torch.nlp import japanese as PJ
from deeplearning4j_tpu_torch.nlp import korean as PK
from deeplearning4j_tpu_torch.nlp.tokenization import TokenPreProcess

CPU = "cpu"
FIT_ATOL = 1e-6

LEXICON = {
    "猫": 50, "狗": 50, "兔子": 30, "动物": 40, "宠物": 30,
    "吃": 60, "喜欢": 60, "鱼": 40, "肉": 40, "米饭": 30, "苹果": 30,
    "银行": 40, "股票": 40, "市场": 40, "价格": 30, "经济": 30,
    "上涨": 20, "下跌": 20, "投资": 25,
    "我": 80, "的": 100, "在": 60, "和": 60, "了": 60, "很": 40,
    "今天": 30, "可爱": 25, "跑": 20, "玩": 25, "公园": 20,
}
ZH = (["我的猫喜欢吃鱼", "狗在公园跑和玩", "兔子很可爱", "猫和狗很可爱",
       "我喜欢我的狗", "宠物猫吃鱼和肉", "兔子吃苹果", "狗喜欢吃肉",
       "可爱的猫在玩", "动物喜欢在公园玩", "股票价格上涨了",
       "银行和市场的经济", "投资股票的价格", "市场价格下跌了",
       "经济和银行的投资", "今天股票上涨", "银行投资市场", "价格在市场上涨"]
      * 6)
JA_ = ([
    "猫は魚を食べる", "犬は肉を食べる", "兎はりんごを食べる",
    "猫は公園で遊んだ", "犬は公園で遊んだ", "兎は庭で遊んだ",
    "猫は可愛い動物です", "犬は可愛い動物です", "兎は可愛い動物です",
    "猫は水を飲んだ", "犬は水を飲んだ", "猫は家で走った", "犬は家で走った",
    "銀行は株に投資する", "会社は株に投資する", "銀行は経済に投資する",
    "会社は経済に投資する", "株価が今日上がった", "価格が今日上がった",
    "株価が市場で下がった", "価格が市場で下がった", "銀行はお金を買った",
    "会社はお金を買った", "株価が市場で上がった", "価格が今日下がった"]
    * 6)
KO = ["고양이가 물고기를 먹었다", "고양이는 공원에서 놀았다",
      "고양이를 친구가 보았다"] * 4
EN = ["the cat chased the mouse", "the dog chased the cat",
      "banks move markets", "markets follow banks"] * 6
# extra probes of each segmenter's test file
ZH_PROBES = ["兔子吃米饭", "猫写字", "猫喜欢鱼，狗喜欢肉。", "GPU和TPU", "深度学习"]
JA_PROBES = ["株価が上がった", "銀行の投資は高いです", "猫とにわとりが庭にいる",
             "私はトヨタの株を買った", "ABCは東京で123円", "猫が鮫を見た",
             "猫は魚、犬は肉。", "深層学習は新しいです"]
KO_PROBES = ["은행이", "고양이가", "사자는", "투자했다", "읽었습니다",
             "학생이 학생은 학생을", "TPU 학습", "먹었다."]
EN_PROBES = ["The cat sat. The dog ran! Did it rain? Yes.",
             "Dr. Smith arrived. He sat down.",
             "The cat is running quickly.", "cats running played",
             "The cat sat on the mat. The dog barked.",
             "Markets rose today. Banks invested heavily."]


class Tag(TokenPreProcess):
    def pre_process(self, t):
        return f"<{t}>"


# ------------------------------------------------ tests/test_nlp_cjk.py
class TestCJK:
    def test_segments_known_words(self):
        seg = PC.DictionarySegmenter(LEXICON)
        assert seg.segment("我的猫喜欢吃鱼") == ["我", "的", "猫", "喜欢", "吃",
                                           "鱼"]
        assert seg.segment("股票价格上涨了") == ["股票", "价格", "上涨", "了"]

    def test_prefers_dictionary_words_over_chars(self):
        toks = PC.DictionarySegmenter(LEXICON).segment("兔子吃米饭")
        assert "兔子" in toks and "米饭" in toks

    def test_unknown_chars_fall_back_to_singles(self):
        assert PC.DictionarySegmenter(LEXICON).segment("猫写字") == [
            "猫", "写", "字"]

    def test_punctuation_splits_runs(self):
        toks = PC.DictionarySegmenter(LEXICON).segment("猫喜欢鱼，狗喜欢肉。")
        assert "，" not in toks and "。" not in toks
        assert toks.count("喜欢") == 2

    def test_latin_runs_pass_through(self):
        assert PC.DictionarySegmenter(LEXICON).segment("GPU和TPU") == [
            "GPU", "和", "TPU"]

    def test_from_word_list(self):
        seg = PC.DictionarySegmenter.from_word_list(["深度", "学习"])
        assert seg.segment("深度学习") == ["深度", "学习"]

    def test_seam_contract(self):
        tok = PC.CJKTokenizerFactory(LEXICON).create("我的猫喜欢吃鱼")
        assert tok.count_tokens() == 6
        assert tok.has_more_tokens()
        assert tok.next_token() == "我"

    def test_preprocessor_applied(self):
        tf = PC.CJKTokenizerFactory(LEXICON).set_token_pre_processor(Tag())
        assert tf.create("猫吃鱼").get_tokens() == ["<猫>", "<吃>", "<鱼>"]


# ------------------------------------------- tests/test_nlp_japanese.py
class TestJapanese:
    def setup_method(self):
        self.seg = PJ.JapaneseSegmenter()

    def test_segments_particles_and_inflections(self):
        assert self.seg.segment("猫は魚を食べる") == ["猫", "は", "魚", "を",
                                               "食べる"]
        assert self.seg.segment("株価が上がった") == ["株価", "が", "上がった"]

    def test_pos_tags(self):
        assert self.seg.tokenize_with_pos("銀行の投資は高いです") == [
            ("銀行", "noun"), ("の", "particle"), ("投資", "noun"),
            ("は", "particle"), ("高い", "adj"), ("です", "aux")]

    def test_lattice_resolves_ambiguity(self):
        toks = self.seg.segment("猫とにわとりが庭にいる")
        assert "にわとり" in toks and "庭" in toks

    def test_unknown_katakana_run_groups(self):
        assert ("トヨタ", "unk") in self.seg.tokenize_with_pos(
            "私はトヨタの株を買った")

    def test_unknown_latin_and_digit_runs(self):
        toks = self.seg.segment("ABCは東京で123円")
        assert "ABC" in toks and "123" in toks and "円" in toks

    def test_unknown_kanji_falls_to_singles(self):
        assert "鮫" in self.seg.segment("猫が鮫を見た")

    def test_punctuation_splits(self):
        toks = self.seg.segment("猫は魚、犬は肉。")
        assert "、" not in toks and "。" not in toks
        assert toks.count("は") == 2

    def test_user_dictionary_extends_seed(self):
        seg = PJ.JapaneseSegmenter(user_entries=[("深層学習", "noun", 2500.0)])
        assert "深層学習" in seg.segment("深層学習は新しいです")

    def test_seed_dictionary_loads(self):
        d = PJ.load_seed_dictionary()
        assert len(d) > 80
        assert any(pos == "particle" for pos, _ in d["は"])

    def test_seam_contract(self):
        tok = PJ.JapaneseTokenizerFactory().create("猫は魚を食べる")
        assert tok.count_tokens() == 5
        assert tok.next_token() == "猫"

    def test_preprocessor_applied(self):
        tf = PJ.JapaneseTokenizerFactory().set_token_pre_processor(Tag())
        assert tf.create("猫は魚").get_tokens() == ["<猫>", "<は>", "<魚>"]


# --------------------------------------------- tests/test_nlp_korean.py
class TestKorean:
    def setup_method(self):
        self.seg = PK.KoreanSegmenter()

    def test_josa_split_with_batchim_agreement(self):
        assert self.seg.tokenize_with_pos("은행이") == [("은행", "stem"),
                                                    ("이", "josa")]
        assert self.seg.tokenize_with_pos("고양이가") == [("고양이", "stem"),
                                                     ("가", "josa")]
        assert ("사자", "stem") in self.seg.tokenize_with_pos("사자는")

    def test_object_topic_particles(self):
        assert self.seg.segment("고양이가 물고기를 먹었다") == [
            "고양이", "가", "물고기", "를", "먹", "었다"]

    def test_eomi_split(self):
        assert self.seg.tokenize_with_pos("투자했다") == [("투자", "stem"),
                                                     ("했다", "eomi")]
        assert self.seg.tokenize_with_pos("읽었습니다") == [
            ("읽", "stem"), ("었습니다", "eomi")]

    def test_same_stem_across_particles(self):
        assert {self.seg.tokenize_with_pos(e)[0]
                for e in ("학생이", "학생은", "학생을")} == {("학생", "stem")}

    def test_non_hangul_passes_through(self):
        assert ("TPU", "other") in self.seg.tokenize_with_pos("TPU 학습")

    def test_punctuation_stripped(self):
        assert self.seg.segment("먹었다.") == ["먹", "었다"]

    def test_seam_contract(self):
        tok = PK.KoreanTokenizerFactory().create("고양이가 물고기를 먹었다")
        assert tok.count_tokens() == 6
        assert tok.next_token() == "고양이"

    def test_pos_filter_keeps_content(self):
        tf = PK.KoreanTokenizerFactory(pos_keep=PK.CONTENT_POS)
        assert tf.create("고양이가 물고기를 먹었다").get_tokens() == [
            "고양이", "물고기", "먹"]

    def test_preprocessor_applied(self):
        class Low(TokenPreProcess):
            def pre_process(self, t):
                return t.lower()

        tf = PK.KoreanTokenizerFactory(pos_keep=PK.CONTENT_POS)
        tf.set_token_pre_processor(Low())
        assert tf.create("TPU 학습").get_tokens() == ["tpu", "학습"]


# ----------------------------------------- tests/test_nlp_annotation.py
class TestAnnotation:
    def _sentences(self, text):
        doc = PA.AnnotationPipeline([PA.SentenceAnnotator()]).annotate(text)
        return [doc.covered_text(s) for s in doc.select("sentence")]

    def test_splits_on_terminators(self):
        assert self._sentences("The cat sat. The dog ran! Did it rain? "
                               "Yes.") == ["The cat sat.", "The dog ran!",
                                           "Did it rain?", "Yes."]

    def test_abbreviation_guard(self):
        assert self._sentences("Dr. Smith arrived. He sat down.") == [
            "Dr. Smith arrived.", "He sat down."]

    def test_offsets_cover_original_text(self):
        text = "One sentence here. And two."
        doc = PA.AnnotationPipeline([PA.SentenceAnnotator()]).annotate(text)
        for a in doc.select("sentence"):
            assert text[a.begin:a.end] == doc.covered_text(a)

    def test_tokens_within_sentences(self):
        doc = PA.default_pipeline().annotate("The cat sat. Dogs run quickly.")
        toks0 = doc.covered("token", doc.select("sentence")[0])
        assert [doc.covered_text(t) for t in toks0] == ["The", "cat", "sat"]

    def test_pos_features(self):
        doc = PA.default_pipeline().annotate("The cat is running quickly.")
        tags = {doc.covered_text(t): t.features["pos"]
                for t in doc.select("token")}
        assert (tags["The"], tags["is"], tags["running"], tags["quickly"],
                tags["cat"]) == ("DT", "VB", "VBG", "RB", "NN")

    def test_stemmer(self):
        doc = PA.default_pipeline(stem=True).annotate("cats running played")
        assert [t.features["stem"] for t in doc.select("token")] == [
            "cat", "runn", "play"]

    def test_pluggable_tokenizer_factory(self):
        tf = PC.CJKTokenizerFactory({"深度": 1.0, "学习": 1.0})
        doc = PA.AnnotationPipeline(
            [PA.SentenceAnnotator(), PA.TokenAnnotator(tf)]).annotate("深度学习")
        assert [t.features["surface"] for t in doc.select("token")] == [
            "深度", "学习"]

    def test_sentence_iterator(self):
        it = PA.AnnotationSentenceIterator(EN_PROBES[4:])
        out = []
        while it.has_next():
            out.append(it.next_sentence())
        assert len(out) == 4 and out[0] == "The cat sat on the mat."
        it.reset()
        assert it.has_next()

    def test_tokenizer_factory_pos_filter(self):
        tf = PA.AnnotationTokenizerFactory(
            pos_keep=frozenset({"NN", "NNS", "NNP", "VBD"}))
        toks = tf.create("The cat sat on the big mat").get_tokens()
        assert "The" not in toks and "on" not in toks
        assert "cat" in toks and "mat" in toks


# --------------------------------------------------- streams against JAX
def test_ja_dict_bytes_equal_jax():
    here = os.path.dirname(os.path.abspath(PJ.__file__))
    with open(os.path.join(here, "data", "ja_dict.tsv"), "rb") as f:
        got = f.read()
    with open(JJ._DATA, "rb") as f:
        assert got == f.read()
    assert PJ._DATA != JJ._DATA
    assert PJ.load_seed_dictionary() == JJ.load_seed_dictionary()


def test_cjk_streams_equal_jax():
    got, want = (PC.DictionarySegmenter(LEXICON),
                 JC.DictionarySegmenter(LEXICON))
    for s in ZH[:18] + ZH_PROBES:
        assert got.segment(s) == want.segment(s)
    tf_p = PC.CJKTokenizerFactory(LEXICON).set_token_pre_processor(Tag())
    tf_j = JC.CJKTokenizerFactory(LEXICON).set_token_pre_processor(Tag())
    assert tf_p.create(ZH[0]).get_tokens() == tf_j.create(ZH[0]).get_tokens()


def test_japanese_streams_and_tags_equal_jax():
    got, want = PJ.JapaneseSegmenter(), JJ.JapaneseSegmenter()
    for s in JA_[:25] + JA_PROBES:
        assert got.tokenize_with_pos(s) == want.tokenize_with_pos(s)
    for keep in (None, PJ.CONTENT_POS):
        assert ([PJ.JapaneseTokenizerFactory(pos_keep=keep).create(
            s).get_tokens() for s in JA_[:25]]
                == [JJ.JapaneseTokenizerFactory(pos_keep=keep).create(
                    s).get_tokens() for s in JA_[:25]])
    assert PJ.CONTENT_POS == JJ.CONTENT_POS


def test_korean_streams_and_tags_equal_jax():
    got, want = PK.KoreanSegmenter(), JK.KoreanSegmenter()
    for s in KO[:3] + KO_PROBES:
        assert got.tokenize_with_pos(s) == want.tokenize_with_pos(s)
    assert PK.CONTENT_POS == JK.CONTENT_POS


def test_annotations_equal_jax():
    for stem in (False, True):
        pp, jp = (PA.default_pipeline(stem=stem),
                  JA.default_pipeline(stem=stem))
        for text in EN_PROBES + EN[:4]:
            got, want = pp.annotate(text), jp.annotate(text)
            assert ([(a.type, a.begin, a.end, a.features)
                     for a in got.annotations]
                    == [(a.type, a.begin, a.end, a.features)
                        for a in want.annotations])
    fp = PA.AnnotationTokenizerFactory(use_stems=True)
    fj = JA.AnnotationTokenizerFactory(use_stems=True)
    for text in EN_PROBES:
        assert fp.create(text).get_tokens() == fj.create(text).get_tokens()
    it_p, it_j = (PA.AnnotationSentenceIterator(EN_PROBES),
                  JA.AnnotationSentenceIterator(EN_PROBES))
    assert it_p._sentences == it_j._sentences


# ------------------------------------------ Word2Vec through each factory
_FITS = {
    "cjk": (ZH, lambda m: m.CJKTokenizerFactory(LEXICON), (PC, JC),
            dict(layer_size=24, window_size=3, min_word_frequency=2,
                 negative_sample=5, learning_rate=0.05, epochs=4,
                 batch_size=512, seed=11)),
    "japanese": (JA_, lambda m: m.JapaneseTokenizerFactory(
        pos_keep=m.CONTENT_POS), (PJ, JJ),
        dict(layer_size=24, window_size=3, min_word_frequency=2,
             negative_sample=5, learning_rate=0.05, epochs=16,
             batch_size=128, seed=7)),
    "korean": (KO, lambda m: m.KoreanTokenizerFactory(
        pos_keep=m.CONTENT_POS), (PK, JK),
        dict(layer_size=8, window_size=2, min_word_frequency=2, epochs=1,
             batch_size=64, seed=0)),
    "annotation": (EN, lambda m: m.AnnotationTokenizerFactory(), (PA, JA),
                   dict(layer_size=8, window_size=2, min_word_frequency=2,
                        epochs=1, batch_size=64, seed=0)),
}


@functools.lru_cache(maxsize=None)
def _fit_pair(name):
    corpus, factory, (pm, jm), kw = _FITS[name]
    j = JN.Word2Vec(sentence_iterator=corpus, tokenizer_factory=factory(jm),
                    **kw).fit()
    p = PN.Word2Vec(sentence_iterator=corpus, tokenizer_factory=factory(pm),
                    device=CPU, **kw).fit()
    return j, p


@pytest.mark.parametrize("name", sorted(_FITS))
def test_word2vec_through_factory_matches_jax(name):
    j, p = _fit_pair(name)
    assert p.vocab.words() == j.vocab.words()
    for t in ("syn0", "syn1neg"):
        np.testing.assert_allclose(getattr(p, t), getattr(j, t), rtol=0,
                                   atol=FIT_ATOL)


def test_chinese_word2vec_topic_structure():
    _, w2v = _fit_pair("cjk")
    assert w2v.has_word("股票") and w2v.has_word("猫")
    assert not w2v.has_word("我的猫喜欢吃鱼")
    assert w2v.similarity("猫", "狗") > w2v.similarity("猫", "股票")
    finance = {"股票", "市场", "价格", "经济", "投资", "上涨", "下跌"}
    assert len(finance.intersection(w2v.words_nearest("银行", top_n=5))) >= 2


def test_japanese_word2vec_topic_structure():
    _, w2v = _fit_pair("japanese")
    assert w2v.has_word("株価") and w2v.has_word("猫")
    assert not w2v.has_word("猫は魚を食べる")
    assert not w2v.has_word("は") and not w2v.has_word("を")
    assert w2v.similarity("銀行", "会社") > w2v.similarity("銀行", "猫")
    assert w2v.similarity("猫", "犬") > w2v.similarity("猫", "株価")
    finance = {"会社", "株価", "市場", "価格", "株", "投資", "経済", "お金"}
    assert len(finance.intersection(w2v.words_nearest("銀行", top_n=6))) >= 2


def test_korean_vocab_collapses_case_forms():
    _, w2v = _fit_pair("korean")
    assert w2v.has_word("고양이")
    assert not w2v.has_word("고양이가") and not w2v.has_word("고양이는")


def test_word2vec_through_annotation_factory():
    _, w2v = _fit_pair("annotation")
    assert w2v.has_word("cat") and w2v.has_word("markets")
