"""Long-context training recipe: sequence parallelism + remat.

The levers for sequences that don't fit one card's memory:
1. `sequence_parallel="ring"` (or "ulysses") on the transformer blocks —
   the time axis shards over a mesh "seq" axis; K/V blocks rotate
   around the ring (the carry flash kernel folds each chunk) or heads
   redistribute via all-to-all (Ulysses).
2. `remat=True` — intra-block activations are recomputed in backward
   instead of stored (one extra forward of FLOPs, a big memory cut).
3. The mesh rides the `sequence_sharding` context; the config carries
   only the strategy name, so checkpoints stay portable.

The mesh is `parallel.make_mesh` over `N_SEQ` devices: the visible
cards when there are that many, else the given device repeated (a ring
on one card runs its shards in turn).
"""
import numpy as np

from deeplearning4j_tpu_torch.parallel import (
    MeshSpec, make_mesh, sequence_sharding)
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM

N_SEQ = 4
EPOCHS = 3


def main(argv=None):
    from deeplearning4j_tpu_torch.examples.distributed_training import (
        mesh_devices)
    device = _common.parse_device(argv, __doc__)
    rng = np.random.default_rng(0)
    devices = mesh_devices(device, N_SEQ)
    n_seq = len(devices)
    V, B, T = 64, 4, 32 * n_seq              # T shards n_seq-ways
    ids = rng.integers(0, V, (B, T))
    x = ids.astype(np.float32)
    y = np.eye(V, dtype=np.float32)[(ids + 1) % V]   # next-token targets

    lm = TransformerLM(vocab_size=V, d_model=32, n_layers=2, n_heads=8,
                       max_len=T, sequence_parallel="ring", remat=True)
    net = lm.init(device=device)

    mesh = make_mesh(MeshSpec.of(seq=n_seq), devices=devices)
    with sequence_sharding(mesh, axis="seq"):
        net.fit(x, y, epochs=EPOCHS, batch_size=B, shuffle=False)
    print("loss after", EPOCHS, "epochs:", round(net.score_value, 4))

    # inference outside the context takes the local path — same
    # numerics, no mesh needed
    out = net.output(x)
    print("output shape:", tuple(out.shape))
    return net


if __name__ == "__main__":
    main()
