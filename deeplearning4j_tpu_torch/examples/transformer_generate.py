"""Autoregressive text generation with KV caches (transformer
counterpart of the char-LSTM `rnn_time_step` sampling): train a small
word-level LM on this repository's docs, then decode with
`zoo.transformer.generate` (sampled, top-p) and `beam_search`."""
import re

import numpy as np

from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM, beam_search, generate)

EPOCHS = 3
SAMPLE_TOKENS = 24
BEAM_TOKENS = 12


def load_tokens():
    """The words of the repository's README.md and docs/*.md (the
    repository root holds this package)."""
    repo = _common.REPO_ROOT
    text = "\n".join(p.read_text(errors="ignore")
                     for p in [repo / "README.md",
                               *sorted((repo / "docs").glob("*.md"))])
    return re.findall(r"[a-z][a-z0-9_]+", text.lower())


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    toks = load_tokens()
    vocab = sorted(set(toks))
    V, T = len(vocab), 32
    idx = {w: i for i, w in enumerate(vocab)}
    ids = np.array([idx[w] for w in toks], np.int32)
    n = (len(ids) - 1) // T
    x = ids[:n * T].reshape(n, T).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[ids[1:n * T + 1].reshape(n, T)]

    net = TransformerLM(vocab_size=V, d_model=64, n_layers=2, n_heads=4,
                        max_len=64, seed=5).init(device=device)
    net.fit(x, y, epochs=EPOCHS, batch_size=32, steps_per_execution=4)
    print("loss:", net.score_value)

    prompt_words = ["the", "reference"]
    prompt = np.array([[idx[w] for w in prompt_words]])
    out = generate(net, prompt, SAMPLE_TOKENS, temperature=0.8, top_p=0.9,
                   rng=0)
    print("sampled:", " ".join(prompt_words)
          + " " + " ".join(vocab[i] for i in out[0]))

    beams, scores = beam_search(net, prompt, BEAM_TOKENS, beam_width=4,
                                device=device)
    beams, scores = np.asarray(beams), np.asarray(scores)
    print("best beam (%.2f):" % scores[0, 0], " ".join(prompt_words)
          + " " + " ".join(vocab[i] for i in beams[0, 0]))
    return out, beams


if __name__ == "__main__":
    main()
