"""Character-level LSTM text generation (GravesLSTM example role):
train on a tiny corpus, then sample with rnn_time_step streaming."""
import numpy as np

from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.zoo.textgenlstm import TextGenerationLSTM

CORPUS = ("the quick brown fox jumps over the lazy dog. "
          "pack my box with five dozen liquor jugs. ") * 40
EPOCHS = 20
SAMPLE_CHARS = 120


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    chars = sorted(set(CORPUS))
    idx = {c: i for i, c in enumerate(chars)}
    V, T = len(chars), 40
    ids = np.array([idx[c] for c in CORPUS])
    starts = np.arange(0, len(ids) - T - 1, T // 2)
    x = np.eye(V, dtype=np.float32)[np.stack([ids[s:s + T] for s in starts])]
    y = np.eye(V, dtype=np.float32)[np.stack([ids[s + 1:s + T + 1] for s in starts])]

    net = TextGenerationLSTM(vocab_size=V, hidden=128).init(device=device)
    net.fit(x, y, epochs=EPOCHS, batch_size=32, steps_per_execution=4)

    # streaming sampling
    net.rnn_clear_previous_state()
    rng = np.random.default_rng(0)
    cur = idx["t"]
    out = ["t"]
    for _ in range(SAMPLE_CHARS):
        probs = net.rnn_time_step(
            np.eye(V, dtype=np.float32)[[cur]])[0].double().cpu().numpy()
        cur = int(rng.choice(V, p=probs / probs.sum()))
        out.append(chars[cur])
    text = "".join(out)
    print(text)
    return text


if __name__ == "__main__":
    main()
