"""Write the ModelSerializer bridge fixtures with the JAX package:

    JAX_PLATFORMS=cpu python tests/fixtures/make_bridge_fixtures.py [OUT]

OUT defaults to tests/fixtures/bridge/. It holds

- `lm_config.json`: the JAX `configuration.json` (`to_json(indent=2)`)
  of the full-width smoke LM (deeplearning4j_tpu/bench.py:716-720:
  vocab 512, d_model 256, 4 blocks, 8 heads, ff x4, max_len 512), fp32;
- `lm_config_mixed_bf16.json`: the same with `dtype_policy`
  `mixed_bf16`;
- `lm_small.zip`: the JAX `ModelSerializer` zip of a small LM (`SMALL`)
  after `STEPS` Adam steps at B=`B`, with its updater state. Its head W
  is scaled by `HEAD_SCALE` after init, so greedy decoding is decisive
  (random heads give near-tie probabilities);
- `lm_small_golden.npz`: from the JAX net restored from that zip,
  `output()` on stored ids [2, 64], greedy tokens of 2 prompts, and the
  loss, per-leaf float64 sums and sums of squares after one more
  `fit` step on stored windows (with the ids of its labels).

`tests/test_torch_port_bridge.py` regenerates all of it in a temporary
directory and holds it to the committed files.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SMOKE = dict(vocab_size=512, d_model=256, n_layers=4, n_heads=8,
             ff_multiplier=4, max_len=512)
SMALL = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
             ff_multiplier=4, max_len=64)
SEED, HEAD_SCALE, STEPS, B = 7, 8.0, 3, 4
N_PROMPTS, PROMPT_LEN, N_TOKENS = 2, 8, 16
# least gap between the two most probable tokens along the greedy path
# (JAX's own full-sequence output): far above fp32 noise between
# implementations, so equal tokens test the model, not rounding
MIN_MARGIN = 1e-3


def windows(seed: int, n: int):
    """n windows of max_len - 1 ids (float-carried, as `fit` takes them)
    and the ids of their next-token labels."""
    V, T = SMALL["vocab_size"], SMALL["max_len"]
    seq = np.random.default_rng(seed).integers(0, V, (n, T))
    return seq[:, :-1].astype(np.float32), seq[:, 1:]


def one_hot(ids):
    return np.eye(SMALL["vocab_size"], dtype=np.float32)[ids]


def make(out: str) -> None:
    from deeplearning4j_tpu.nd.dtype import mixed_bf16
    from deeplearning4j_tpu.util.serializer import ModelSerializer
    from deeplearning4j_tpu.zoo.transformer import TransformerLM, generate

    os.makedirs(out, exist_ok=True)
    conf = TransformerLM(**SMOKE).conf()
    with open(os.path.join(out, "lm_config.json"), "w") as f:
        f.write(conf.to_json(indent=2))
    conf.dtype_policy = mixed_bf16()
    with open(os.path.join(out, "lm_config_mixed_bf16.json"), "w") as f:
        f.write(conf.to_json(indent=2))

    net = TransformerLM(**SMALL, seed=SEED).init()
    head = str(len(net.layers) - 1)
    net.params[head]["W"] = net.params[head]["W"] * HEAD_SCALE
    x, y = windows(1, STEPS * B)
    net.fit(x, one_hot(y), epochs=1, batch_size=B, shuffle=False)
    zip_path = os.path.join(out, "lm_small.zip")
    ModelSerializer.write_model(net, zip_path)

    net = ModelSerializer.restore_model(zip_path)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, SMALL["vocab_size"], (2, SMALL["max_len"]))
    probs = np.asarray(net.output(ids))
    prompts = rng.integers(0, SMALL["vocab_size"], (N_PROMPTS, PROMPT_LEN))
    tokens = np.asarray(generate(net, prompts, N_TOKENS, temperature=0))
    seq = np.concatenate([prompts, tokens], axis=1)
    p = np.asarray(net.output(seq))[:, PROMPT_LEN - 1:-1]
    top2 = np.sort(p, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    if margin < MIN_MARGIN:
        raise SystemExit(f"greedy margin {margin} under {MIN_MARGIN}: "
                         f"the tokens would compare rounding")
    sx, sy = windows(3, B)
    net.fit(sx, one_hot(sy), epochs=1, batch_size=B, shuffle=False)
    golden = dict(ids=ids, probs=probs, prompts=prompts, tokens=tokens,
                  margin=np.float64(margin), step_x=sx, step_y=sy,
                  loss=np.float64(net.score_value),
                  iteration_count=np.int64(net.iteration_count))
    for lk, lp in net.params.items():
        for name, arr in lp.items():
            a = np.asarray(arr, np.float64)
            golden[f"sum/{lk}/{name}"] = a.sum()
            golden[f"sumsq/{lk}/{name}"] = (a * a).sum()
    np.savez(os.path.join(out, "lm_small_golden.npz"), **golden)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    make(sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "bridge"))
