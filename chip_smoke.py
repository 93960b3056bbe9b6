"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain checks
    python3 chip_smoke.py --profile       # torch.profiler breakdown only
                                          # (with a restore + a fit step,
                                          # and ResNet-50 fit steps)
    python3 chip_smoke.py --warmup-trial  # long-context LM: Adam(1e-3)
                                          # with and without a warmup
    python3 chip_smoke.py --zoo-lr-trial  # GoogLeNet and VGG16: the
                                          # loss under four Nesterov rates
    python3 chip_smoke.py --layers-rest   # build + phase 13 alone
    python3 chip_smoke.py --profile-layers-rest  # phase 13's --profile
                                          # rows alone
    python3 chip_smoke.py --yolo-lr-trial # YOLOv2: the loss under four
                                          # Nesterov rates
    python3 chip_smoke.py --runtime       # build + phase 14 alone
    python3 chip_smoke.py --runtime-probe # phase 14's determinism probe
                                          # and profiled spe 1 / spe 4

Phases, in order:
  1. build every kernel of `deeplearning4j_tpu_torch/kernels/csrc/` with
     nvcc (one process per source, all at once) and print the seconds;
     check with `cuobjdump -sass` that every instance of the flash
     kernels (the backward's dQ and dK/dV and the forward's finalize and
     carry modes; fp32 and bf16, D 32/64/128, causal or not) runs
     tensor-core instructions (HMMA or HGMMA), and print each one's
     registers, stack and local memory (`cuobjdump -res-usage`);
  2. hold each kernel against its plain PyTorch version on the card, in
     fp32 and bf16, at the main path's shapes and at ragged ones, and
     time kernel, plain version and the one-call PyTorch yardstick
     (`F.layer_norm`, `F.scaled_dot_product_attention` and its
     backward, `torch.optim.Adam(fused=True).step()` — timed only, the
     port never calls them). Fused Adam runs at the LM's block run (4
     blocks x 16 leaves, 3.16 M elements, one launch) and at the
     long-context LM's (8 blocks, 128 leaves, two launches), with fp32
     and with bf16 gradients (`mixed_bf16`'s), and must be bit-equal to
     its plain version; both are timed at the LM's run. The threefry
     kernels (`csrc/threefry.cu`) must be bit-equal to their plain
     versions: dropout in fp32 and bf16 at [16, 511, 256] with p = 0.9,
     at a ragged length and on an offset view, the raw words against
     `threefry_bits_plain` (an index range past 2^32 too), and the
     per-row-key words (`threefry_bits_rows`: 8 slots' keys, vocab 512
     and a ragged 77) against theirs; dropout is timed beside
     `F.dropout` (Philox bits: the same work, another draw), the words
     with no yardstick. LayerNorm also runs at a width
     past a warp's registers ([64, 2304]) and at phase 8's decode rows
     ([8, 256]: 8 slots; [32, 256]: 8 slots x a 4-position speculative
     score), timed there too. Phase 6's shapes are checked
     too: LayerNorm and residual LayerNorm at [16384, 512], the flash
     forward, dQ and dK/dV at the ring's chunk [8, 512, 8, 64], where
     dQ and dK/dV are also timed, diagonal (causal) and visible, beside
     SDPA's backward, and at the local attention [8, 2048, 8, 64],
     where the causal forward, dQ and dK/dV are timed beside SDPA and
     its backward; dQ and dK/dV also run at Tq != Tk. The
     carry fold runs at that chunk (a diag fold, a visible fold, a
     chain of the two) and ragged (Tq 300, Tk 200, D 32 and 128); no
     one PyTorch call computes it, so it has no yardstick. The forward
     (with its backward) and a chain of two carry folds also run on
     q, k, v views that start off 16-byte alignment;
  3. scoring: `TransformerLM(vocab 512, d_model 256, 4 layers, 8 heads,
     ff x4, max_len 512)` with random weights from a numpy seed loaded
     through `from_jax_params`, `output()` at B=16, T=512 on the card,
     held against the same port run on the CPU;
  4. serving: a `GenerationServer` (8 slots, block_len 16, pool for 8
     full-budget streams + the garbage block) after `warmup`, 24 greedy
     requests (seeded prompt lengths 16-300, 64 tokens) and 4 sampled
     ones (temperature 0.8, top_p 0.9, JAX keys); every greedy stream
     must equal the port's `generate()` on the card; the sampled streams,
     and sampled `generate()` of the same prompts, are held by margin to
     the CPU port's from the same keys (`sampled_margin`: equal, or first
     apart where the CPU's noisy logits are within eps of a tie, eps the
     largest log-probability difference card vs CPU), near-ties counted;
  5. training: the same LM (random weights, unscaled head) `fit` with
     Adam(1e-3) on windows of T = 511 from a seeded period-64 token
     cycle, one-hot next-token labels: (a) 3 steps at B=8 on the card
     and on the CPU from identical params, loss per step and every
     param held card against CPU; (b) 20 timed steps at B=16 on the
     card, the loss must fall; the backward and Adam kernels must have
     launched; (c) the same under `dtype_policy="mixed_bf16"` (bf16
     compute on an fp32 master): 3 steps card against CPU, step 0's
     loss within 1e-2; 20 timed steps on the (b) windows, the loss must
     fall and end within 5% of (b)'s initial loss of (b)'s final loss,
     params and Adam's m and v fp32 after it, and every kernel's bf16
     instance launched (fused Adam's with bf16 gradients) and no fp32
     one;
  6. sequence-parallel training: the repo's long-context LM config
     (`deeplearning4j_tpu/bench.py:769-773`: vocab 512, d_model 512, 8
     layers, 8 heads, ff x4, max_len 2048) with
     `sequence_parallel="ring"` under `sequence_sharding` of a 4-way
     `seq` mesh that repeats the card (T_local = 512): (a) `output()`
     at [8, 2048] in the context against the same net's local
     `output()` (and the Ulysses setting likewise), the ring forward
     launching the carry kernel 10 times a layer; (b) ring against
     local from identical params: dq, dk, dv of the ring attention
     against the local flash attention at [8, 2048, 8, 64], every
     leaf's gradient of one backward, then 3 `fit` steps at B=8, loss
     per step and every param; (c) 10 timed steps each, ring and local: ms/step,
     tokens/s, peak memory; the loss must fall; (d) the local arm again
     under `mixed_bf16`, with (c)'s gates against the fp32 local arm and
     phase 5's launch and master checks. Adam runs at `LONG_LR` here
     (its note says why);
  7. the ModelSerializer bridge (`util/serializer.py`): (a) the net of
     phase 3's LM built from the JAX-written `configuration.json`
     (tests/fixtures/bridge/lm_config.json), whose `to_dict()` and text
     it must write back unchanged; (b) phase 3's params, 3 `fit` steps at
     B=8 (T = 511), `write_model` and `restore_model(device="cuda")`:
     params, Adam's m and v and the counters bit-equal, `output()` at
     [16, 512] bit-equal, greedy `generate()` of 4 prompts x 32 tokens
     token-equal, then 3 more steps on both nets with equal losses and
     params (bit for bit; else within TRAIN_LOSS_RTOL and GRAD_RTOL,
     naming the kernels that are not deterministic); the zip's bytes
     and the write and restore seconds are printed; (c) the same from
     the JAX `mixed_bf16` configuration: the restored policy is mixed,
     the master fp32, and the steps launch each kernel's bf16 instance
     and no fp32 one; (d) the JAX-written zip of a small LM
     (tests/fixtures/bridge/lm_small.zip) restored on the card:
     `output()` within OUTPUT_ATOL of JAX's stored probabilities, greedy
     tokens equal to JAX's, and one more step from JAX's Adam state
     within GOLDEN_LOSS_ATOL in loss and GOLDEN_SUM_RTOL in each leaf's
     sum and sum of squares;
  8. serving features on phase 3's LM and params (8 slots, block_len
     16), each arm beside its vanilla fp32 run in the same call for
     tok/s, greedy streams held by margin (`zoo.transformer.
     stream_agreement`: equal, or first apart at a near-tie of the
     reference, whose top-1/top-2 gap is at most the largest difference
     between one 4-wide score and 4 single-token decodes measured on the
     card for that arm; near-ties are reported): (1) `mixed_bf16`, phase
     4's 24 greedy requests x 64 tokens through the server, streams
     against mixed `generate()`, teacher-forced probabilities within
     MIXED_DECODE_ATOL of the fp32 net's, only bf16 kernel instances
     launched (LayerNorm's), the bf16 pool's bytes against fp32's;
     (2) int8 weights: the tree's weight bytes against fp32's, streams
     against int8 `generate()`, teacher-forced top-1 agreement with fp32
     >= INT8_TOP1_MIN and its largest probability error; (3) speculative
     decoding at k = 4 with drafting kept on: the n-gram proposer on
     prompts cut from `lm_corpus`'s seeded cycle and the truncated
     drafter (half the blocks) on phase 4's prompts, streams against the
     non-speculative engine's, acceptance, tokens per dispatch and tok/s;
     and `spec_sampled` (acceptance, streams in the vocab and of the
     right length, held by margin to the CPU engine's from the same
     keys, an acceptance or resample near-tie allowed at the first
     difference); (4) shared prefixes: a 256-token prefix and 16
     distinct suffixes, registered (streams against private ones, blocks
     saved, forks) and through the radix cache (hits, evictions);
  9. regularized training, each arm beside its twin: (a) phase 3's LM
     with `Dropout(0.9)` on the blocks, l2 1e-4 and elementwise gradient
     clipping at 1.0, fp32 and `mixed_bf16`: 3 steps at [8, 511] card
     against CPU from the same params and threefry keys (phase 5's
     gates), then 20 timed steps at [16, 511] beside the undropped twin;
     flash, both LayerNorms, fused Adam and dropout must launch; (b) the
     per-leaf arm (`clip_l2_per_layer` 1.0, `max_norm` 1.0, a
     MaxNormConstraint(1.0) on the output layer and GaussianNoise(0.05)
     on its input, `DropConnect(0.95)` and attention dropout 0.9 on the
     blocks): 3 steps at [2, 511] card against CPU; no packed run, so no
     fused-Adam launch, and no flash launch (the masked softmax carries
     the attention dropout); (c) the long-context LM under `mixed_bf16`:
     `Dropout(0.9)`, 10 timed steps beside the undropped twin; ring and
     Ulysses (4-way mesh on the card) against local mixed over 3 steps
     (step 0 within 1e-2, every step within 5% of the initial loss) and
     `output()` within MIXED_DECODE_ATOL; (d) `TransformerClassifier` at
     the LM's width (8 classes, dropout 0.9, AVG pooling, Adam 3e-5) on
     padded batches with seeded lengths 16-511 and the features mask: 3
     steps at B=8 card against CPU, 20 timed at B=16, then `evaluate()`
     and `evaluate_roc_multi_class()` of 256 held-out sequences, the
     card net against its CPU copy (equal counts, or apart only at
     near-ties of the CPU's probabilities);
 10. ResNet-50 and the ComputationGraph (`phase_resnet`): (a) the zoo
     ResNet-50 at full width and depth as the JAX benchmark's
     accelerator setting trains it (224x224x3, 1000 classes,
     Nesterovs(0.005, 0.9), l2 1e-4, weights from the zoo's seed): 3
     steps at batch 2 on the card and on the CPU (fp32, TF32 off), the
     loss of each step and inference `output()` within 1e-4, params and
     running statistics (whole tree) within 1e-3 and Nesterov's v within
     0.1; then 20 timed steps after 3 warm-up ones at batch 128 on one
     repeated batch resident on the card, fp32 and mixed_bf16 (ms/step,
     images/s, peak memory, the loss must fall, mixed's step 0 within
     1e-2 of fp32's and its final loss in phase 5's band), and
     `output()` of the batch under both policies; (b) the JAX-written
     graph zip (tests/fixtures/bridge/resnet_small.zip: two bottleneck
     blocks) restored on the card against JAX's stored outputs and next
     step, running statistics included, then 3 steps and a write and
     restore, bit-equal; (c) the smoke LM's layer list built with
     `graph_builder`, `score()` and 3 Adam steps against the layer list
     from the same params, fp32 and mixed_bf16, each kernel of GRAPH_
     KERNELS launched from the graph (fused Adam through its packed run);
     and the mixed step's BatchNorm in JAX's rounding order (bf16
     elementwise ops) against the parent's `F.batch_norm`, A B B A on one
     net: ms/step and one profiled step's kernel launches each;
 11. recurrent (`phase_recurrent`): `TextGenerationLSTM()` at the JAX
     benchmark's char-RNN setting (vocab 77, two GravesLSTM(256), TBPTT
     50; `deeplearning4j_tpu/bench.py:673-697`): (a) `init(seed)` on the
     card and on the CPU (equal within 1e-6), 3 TBPTT iterations at
     [4, 100] (two chunks each), fp32, loss and every param card vs CPU
     within 1e-4, mixed_bf16's first loss within 1e-2 of fp32's, its
     carries bf16; (b) 20 timed iterations of one repeated [64, 100]
     batch, fp32 and mixed_bf16: ms/iteration, chars/s, peak memory, the
     loss falling, and one profiled iteration's device kernel launches,
     device ms, busy share and device ms by part; (c) the committed
     char-LM (`init_pretrained(TEXT)`, sha256 checked): `output()` of 16
     windows of 100 chars of SURVEY.md card vs CPU within 1e-5 with the
     argmax accuracy equal window by window, `rnn_time_step` one char at
     a time against `output()` within 1e-5, 200 greedy chars printed;
     (d) a GravesBidirectionalLSTM -> LastTimeStep -> OutputLayer
     classifier on padded batches with the features mask (one row all
     padding) and a SimpleRnn net, 3 steps each card vs CPU within 1e-4;
 12. the CNN zoo (`phase_cnn_zoo`, fp32 with TF32 off unless an arm is
     mixed_bf16): (a) LeNet, the JAX benchmark's configuration 0
     (`deeplearning4j_tpu/bench.py:643-668`): the packaged MNIST
     checkpoint (`init_pretrained(MNIST)`, sha256 checked) on the 297
     held-out digits of tests/fixtures/digits (the generator's recipe:
     x / 16, bilinear to 28x28, `default_rng(0)` order), output() card
     vs CPU within 1e-5, `evaluate()` accuracy equal and 0.9764 as the
     manifest says; the fine-tune at batch 128, Adam(1e-3), over
     distinct batches of the other 1500 digits: 3 steps card vs CPU
     (fp32: losses within 1e-4, params within 3x the CPU's distance to a
     twin with 1e-6 noise on its weights, an Sgd twin's params within
     1e-4; mixed_bf16: losses within 1e-2), then 20 timed steps after 3
     in each dtype (ms/step, images/s, peak memory) and the held-out
     accuracy after them at least 0.95; (b) GoogLeNet at 224, 1000
     classes, the zoo's Nesterovs(1e-2, 0.9) and l2 5e-4: 2 steps at
     batch 2 card vs CPU from the card's `init(seed)` (losses within
     1e-4, params within 1e-3 over the whole tree, output() within
     1e-4), 20 timed steps after 3 at batch 128 on a repeated batch,
     fp32 and mixed_bf16 (the loss falls, mixed's step 0 within 1e-2 of
     fp32's); (c) VGG16 likewise at 224, 1 step at batch 2, timed at
     batch 64, at Nesterovs(VGG_LR, 0.9) (its note says why); (d)
     AlexNet 224, SimpleCNN 48, VGG19 224, InceptionResNetV1 160 (5/10/5
     blocks) and FaceNet 96 at their constructor defaults: `init(seed)`
     card vs CPU within 1e-6 of each tensor's largest value, output()
     at batch 2 within 1e-4, one fit step's loss within 1e-4, the
     embeddings' row norms 1 within 1e-5, 10 timed steps at batch 32;
     (e) LRN (GoogLeNet's stem shapes) and CnnToFeedForward in bf16 card
     vs CPU (`lrn_bf16_bound`; bit-equal). It prints `[cnn_zoo]` lines
     and the phase's seconds;
 13. the remaining layer families (`phase_layers_rest`, fp32 with TF32
     off unless an arm is mixed_bf16): (a) YOLOv2 at darknet's
     `cfg/yolov2.cfg` widths (`yolo2_conf`: Darknet-19 with BatchNorm
     and leaky 0.1, the passthrough through SpaceToDepthLayer(2) and a
     merge, the five anchors, 425 = 5 x 85 outputs, Nesterovs(YOLO_LR,
     0.9), l2 5e-4, per-layer gradient renormalization) on seeded
     images and boxes (`yolo_labels`):
     `init(seed)` card vs CPU within 1e-5, output() and the detections
     at 0.5 (near-ties counted) at 416, 3 steps at batch 2 (step 0
     within 1e-4, then the noisy-twin rule, running statistics too),
     then 10 timed steps after 3 at 608 and batch 8, fp32 and
     mixed_bf16; (b) the smoke LM with a MixtureOfExperts (8 experts,
     top-2, hidden 1024) after each of its 4 blocks (`moe_lm_conf`):
     output() card vs CPU, the selected experts (near-ties counted) and
     the per-expert token fractions, 3 Adam steps (step 0's loss and
     load-balance loss within 1e-4, then the noisy-twin rule against a
     weight-noise twin), 10 timed steps at [16, 511] in both dtypes with
     the flash and LayerNorm kernels launched; MultiHeadAttention(256 -> 512, 8 heads)
     forward and backward card vs CPU, flash at head dim 64; (c) on the
     digits at 28x28: dl4j-examples' VAE (784 -> [256, 256] -> 2,
     Bernoulli, RmsProp(1e-3)) pretrained one epoch card vs CPU (an Sgd
     twin's ELBO within 1e-4 each step, the RmsProp arm by a
     weight-noise twin), 3 timed epochs and `reconstruction_probability`
     of the 297 held-out digits; a DBN of RBMs 784-1000-500-250-30 (step
     0's flipped samples counted, the free energy and params after one
     epoch a layer by the noisy-twin rule) fine-tuned on the labels
     (held-out accuracy above 0.5); a graph's AutoEncoder(784 -> 500)
     node through `graph.pretrain`; (d) the other new layers forward and
     backward card vs CPU in fp32 (1e-5) and bf16 (2 ulps of each row's
     largest), masks included, and a FrozenLayer conv and BatchNorm
     bit-equal after 3 `fit` steps. It prints `[layers_rest]` lines;
 14. the training runtime (`phase_runtime`, fp32 with TF32 off unless an
     arm is mixed_bf16): (a) the long-context LM (phase 6's config) at
     [8, 2048], Adam(LONG_LR), on 32 seeded windows shuffled by one
     stream over 4 epochs (16 steps), in fp32 and mixed_bf16: one step's
     gradients twice from one state, equal (else the leaves are named);
     16 steps at steps_per_execution 4 bit-equal to 16 at 1 (ms/step of
     both, timed in turns spe 1, 4, 4, 1); a run
     with an AsyncCheckpointer (keep_last 2) through a CheckpointListener
     every 4 steps and a PreemptionListener at step 10, then
     `MultiLayerNetwork.resume` (the newest checkpoint, 8) trained to 16:
     params, Adam's m and v and the counters bit-equal to the
     uninterrupted run (write seconds and MB, resume seconds); the newest
     checkpoint corrupted, the resume falls back to 4 and replays to the
     same bits; remat none, full and dots_saveable for 3 steps each,
     bit-equal, with their ms/step and peak memory (their launches,
     recompute included, are reported apart and left out of the
     phase's); (b) `beam_search` on phase 3's LM (head x8) at B 4, prompt
     64, 32 tokens, beam 4 card vs CPU by margin (near-ties counted,
     BEAM_ATOL), beam 1 against greedy `generate()`, ms a token step; on
     the committed char-LM (sha256 checked) card vs CPU exactly with '.'
     as eos, ranked raw and with the GNMT length penalty 0.6; (c) LeNet
     at batch 128 on the digits under `line_gradient_descent`,
     `conjugate_gradient` and `lbfgs`, 5 iterations over 3 batches:
     iterations 0-1's losses card vs CPU within SOLVER_ATOL, the loss
     falling, ms an iteration; (d) the packaged LeNet through
     TransferLearning (conv stack frozen, the head re-drawn, Sgd(0.1))
     on the digits standardized by NormalizerStandardize, an
     EarlyStoppingTrainer (MaxEpochs 5, ScoreImprovement 2) scored by the
     297 held-out digits' loss: best epoch equal card vs CPU and its
     score within ES_ATOL, the held-out accuracy, a run stopped after 2
     epochs and resumed with `fit(resume=True)` to the same result, and
     the best model's zip with the normalizer restored on the card to
     the same output; (e) NCHW `data_format` on LeNet and a two-input,
     two-output graph fit over MultiDataSets, card vs CPU. It prints
     `[runtime]` lines;
and prints the `{"kernels": [...]}` line (launch counts from phases 3
to 14, each > 0; the counts of each phase on a `[launches]` line), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failed check exits nonzero without
the last line. Without CUDA it exits 2 and prints no result. It turns
TF32 off for matmuls and convolutions (PyTorch lets cuDNN run fp32
convolutions in TF32 by default) and leaves
`torch.backends.cudnn.benchmark` at its default (off).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# peak rates (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, fp32
# (CUDA cores) and bf16 (tensor cores) operations/s, and fp32-accurate
# products on the tensor cores as 3xTF32 (three TF32 products each, at
# the data sheet's 495 TFLOP/s TF32): the least time an fp32 flash
# kernel needs, since its products can run there
HBM_BPS = 3.35e12
SPIN_CYCLES = 2_000_000      # ~1 ms at the H100's 1.98 GHz boost clock
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3,
            # 32-bit integer operations on the CUDA cores: 64 INT32 lanes
            # an SM (Hopper architecture white paper) x 132 SMs x the
            # 1.98 GHz boost clock
            "int32": 64 * 132 * 1.98e9}
# integer operations a threefry word costs: 20 rounds of add, rotate and
# xor, 5 key injections of two adds each (one with a round constant),
# the key's parity word and the index split (csrc/threefry.cu)
THREEFRY_OPS = 80
FLASH_RATE = {"float32": "tf32x3", "bfloat16": "bfloat16"}

LN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -4}        # 1 bf16 ulp at |y|<16
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2 ** -5}     # 1 bf16 ulp at |o|<4
# flash backward: fp32 sums over up to 512 keys/queries in another
# order than the plain einsums; bf16: 2 ulp of the largest |value|
# (each side rounds its own fp32 sum once)
BWD_ATOL_F32 = 1e-4
OUTPUT_ATOL = 1e-4    # softmax probs, card vs CPU, fp32 (TF32 off)
# carry fold against its plain version: the state is unnormalised, so
# its scale grows with the chunk (l up to Tk, acc up to l * max|v|);
# each of m, l and acc is held to 2e-5 of max(1, its own largest
# |value|), for fp32 and bf16 inputs alike (both sides upcast the
# inputs and compute the fp32 state, so they differ by fp32 rounding)
CARRY_RTOL = 2e-5
# training, card vs CPU (fp32, TF32 off): loss per step relative, and
# each param's relative Frobenius difference after the steps. The key
# bias attn_bk has a gradient that is zero up to rounding (softmax is
# shift invariant per query row), so Adam moves it by noise of up to
# lr (1-b1)/sqrt(1-b2) a step (Kingma & Ba, 2.1) on each side: it is
# held to twice that bound per step instead.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_RTOL = 1e-3
# ring against local gradients on one batch (fp32, TF32 off), relative
# Frobenius: dq, dk, dv of the attention alone, and every leaf of the
# LM's backward but attn_bk (its true gradient is zero, so each side
# returns its own rounding noise; dK reaches attn_Wk's gradient and
# the attention-level check). Both sides sum the same terms in
# another order, so these are far tighter than the param limit above:
# a dK or dV off by a scale would fail them, where Adam's steps (about
# lr * sign(g) each) would not show it
ATTN_GRAD_RTOL = 1e-5
GRAD_RTOL = 1e-4


# mixed_bf16 (phases 5-6): step 0's loss card against CPU (both bf16,
# with GEMM and softmax sums in another order on each side), and the
# band of a mixed run's final loss around the fp32 arm's: 5% of the
# fp32 arm's initial loss (the JAX package's documented band,
# deeplearning4j_tpu tests/test_dtype_policy.py:170-186,
# docs/PRECISION.md)
MIXED = "mixed_bf16"
MIXED_STEP0_RTOL = 1e-2
MIXED_BAND = 0.05
# the kernel instances a mixed_bf16 `fit` must launch, each in bf16
# (fused Adam's: bf16 gradients onto the fp32 params and moments)
MIXED_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "fused_adam")


def adam_step_max(lr=1e-3, steps=1):
    """lr (1 - b1) / sqrt(1 - b2), the bound on one Adam step above, at
    the largest rate of the first `steps` steps (`lr` may be a
    schedule)."""
    if hasattr(lr, "value_at"):
        lr = max(float(lr.value_at(s)) for s in range(steps))
    return lr * 0.1 / 0.001 ** 0.5


LM = dict(vocab=512, d_model=256, n_layers=4, n_heads=8, ff=4, max_len=512)
# the long-context config (deeplearning4j_tpu/bench.py:769-773), trained
# at T = max_len on a 4-way ring
LM_LONG = dict(vocab=512, d_model=512, n_layers=8, n_heads=8, ff=4,
               max_len=2048)
SEQ_P = 4
# Adam's rate for the long-context training: at the zoo's 1e-3 this LM
# (pre-LN blocks, no final LayerNorm) diverges in its first 10 steps, on
# the ring and locally alike (measured 12.24 -> 36.70 at [8, 2048] on an
# H100, 10.8 -> 30.4 at [2, 256] on a CPU); at 1e-4 the loss falls. A
# linear warmup to 1e-3 does not stop it (`--warmup-trial`: with
# WarmupCosineSchedule(1e-3, W, 40) for W = 5, 10 and 20 the loss climbs
# once the rate passes about 5e-4, in fp32 and in mixed_bf16)
LONG_LR = 1e-4


# ------------------------------------------------------------------ helpers
class Failures(list):
    def check(self, ok: bool, what: str):
        ok = bool(ok)
        if not ok:
            self.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def timer(device, fn, iters=20, warmup=3, flush=None):
    """Median ms of `fn()` over `iters` calls; CUDA events on the card,
    each launch after a write of `flush` (a buffer larger than L2) so the
    inputs come cold from device memory, as the model's layers find them.
    A ~1 ms device spin (`torch.cuda._sleep`) goes first, so the host
    has queued the events and the launch before the card reaches them:
    the events then time the device work, not the host's launch
    overhead (a wrapper that spends longer on the host than its kernel
    takes would otherwise be timed by its host side)."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush.add_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bwd_tol(dtype: str, ref_maxabs: float) -> float:
    if dtype == "float32":
        return BWD_ATOL_F32
    return float(2 * 2.0 ** (np.floor(np.log2(max(ref_maxabs, 2 ** -60)))
                             - 7))


def block_shapes(cfg):
    """The leaf shapes of the LM's run of transformer blocks (16 per
    block), the run one fused-Adam launch updates."""
    d = cfg["d_model"]
    ff = d * cfg["ff"]
    one = [(d, d)] * 4 + [(d,)] * 8 + [(d, ff), (ff,), (ff, d), (d,)]
    return one * cfg["n_layers"]


def lm_corpus(cfg, n: int, seed: int, period: int = 64, T=None):
    """n training windows of length T (default max_len - 1) from a
    seeded period-`period` token cycle (float-carried ids, as `fit`
    takes them) with one-hot next-token labels."""
    rng = np.random.default_rng(seed)
    V, T = cfg["vocab"], T or cfg["max_len"] - 1
    pattern = rng.choice(V, period, replace=False)
    tokens = np.tile(pattern, (n + T) // period + 2)
    X = np.stack([tokens[i:i + T] for i in range(n)])
    Y = np.stack([tokens[i + 1:i + T + 1] for i in range(n)])
    return X.astype(np.float32), np.eye(V, dtype=np.float32)[Y]


def random_lm_params(cfg, seed: int, head_scale: float):
    """JAX-keyed numpy params ({"<layer>": {name: array}}) for the zoo
    TransformerLM, Xavier-normal from a numpy seed; the output head is
    scaled by `head_scale` so greedy logits are decisive."""
    rng = np.random.default_rng(seed)
    V, d, ff = cfg["vocab"], cfg["d_model"], cfg["d_model"] * cfg["ff"]

    def w(n_in, n_out, scale=1.0):
        std = (2.0 / (n_in + n_out)) ** 0.5 * scale
        return (rng.standard_normal((n_in, n_out)) * std).astype(np.float32)

    def b(n):
        return (rng.standard_normal(n) * 0.02).astype(np.float32)

    params = {"0": {"W": w(V, d), "b": b(d)}}
    for i in range(cfg["n_layers"]):
        p = {}
        for n in ("q", "k", "v", "o"):
            p[f"attn_W{n}"] = w(d, d)
            p[f"attn_b{n}"] = b(d)
        for n in ("ln1", "ln2"):
            p[f"{n}_gamma"] = (1 + rng.standard_normal(d) * 0.1).astype(
                np.float32)
            p[f"{n}_beta"] = b(d)
        p.update(ff_W1=w(d, ff), ff_b1=b(ff), ff_W2=w(ff, d), ff_b2=b(d))
        params[str(2 + i)] = p
    params[str(2 + cfg["n_layers"])] = {"W": w(d, V, head_scale), "b": b(V)}
    return params


def build_lm(cfg, device, params, sequence_parallel=None, lr=None,
             dtype_policy=None):
    """The zoo TransformerLM with `params` loaded; `lr` (a rate or a
    schedule) replaces the learning rate of its Adam(1e-3) on every
    layer; `dtype_policy` goes to `init`."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    net = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                        ff_multiplier=cfg["ff"], max_len=cfg["max_len"],
                        sequence_parallel=sequence_parallel).init(
                            device=device, dtype_policy=dtype_policy)
    if lr is not None:
        for layer in net.layers:
            layer.updater = Adam(lr)
    return from_jax_params(net, params)


def param_diff(got, want):
    """Worst relative Frobenius difference over every param but the
    `attn_bk`s, as ((rel, "layer/name")), and the largest |difference|
    of an `attn_bk` (held to Adam's step bound instead)."""
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    pg, pw = to_jax_params(got), to_jax_params(want)
    worst, worst_bk = (0.0, ""), 0.0
    for lk, lp in pw.items():
        for name, w in lp.items():
            diff = pg[lk][name] - w
            if name == "attn_bk":
                worst_bk = max(worst_bk, float(np.abs(diff).max()))
                continue
            rel = float(np.linalg.norm(diff) / np.linalg.norm(w))
            worst = max(worst, (rel, f"{lk}/{name}"))
    return worst, worst_bk


# ------------------------------------------------------------ phase 1: build
# a backward kernel's mangled name: kind, dtype (f = float), D, causal
_BWD_KERNEL = re.compile(
    r"flash_bwd_(dq|dkv)_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E")
# a forward kernel's: dtype, D, causal (diag in carry mode), carry
_FWD_KERNEL = re.compile(
    r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])ELb([01])E")
# `cuobjdump -sass`: a function's heading; `cuobjdump -res-usage`: a
# function's heading and, on the next line, its "KEY:value" resources
_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
_RES_FUNCTION = re.compile(r"^\s*Function\s+(\S+):\s*\n(.*)$", re.M)
_MMA_OPS = ("HMMA", "HGMMA")


def _bwd_instances(names):
    """{(kind, dtype, D, causal): mangled name} of the backward kernels
    among `names`."""
    out = {}
    for fn in names:
        m = _BWD_KERNEL.search(fn)
        if m:
            kind, dt, D, causal = m.groups()
            out[(kind, "float32" if dt == "f" else "bfloat16", int(D),
                 causal == "1")] = fn
    return out


def _fwd_instances(names):
    """{(mode, dtype, D, causal): mangled name} of the forward kernel's
    instances among `names`; mode "fwd" (finalize) or "carry", where
    causal is the diag mask."""
    out = {}
    for fn in names:
        m = _FWD_KERNEL.search(fn)
        if m:
            dt, D, causal, carry = m.groups()
            out[("carry" if carry == "1" else "fwd",
                 "float32" if dt == "f" else "bfloat16", int(D),
                 causal == "1")] = fn
    return out


def mma_counts(sass_text: str):
    """{mangled kernel name: {"HMMA": n, "HGMMA": n}}: the tensor-core
    instructions in each function of a `cuobjdump -sass` listing."""
    heads = list(_SASS_FUNCTION.finditer(sass_text))
    out = {}
    for i, m in enumerate(heads):
        end = heads[i + 1].start() if i + 1 < len(heads) else len(sass_text)
        body = sass_text[m.end():end]
        out[m.group(1)] = {op: len(re.findall(rf"\b{op}\.", body))
                           for op in _MMA_OPS}
    return out


def res_usage(text: str):
    """{mangled kernel name: {"REG": n, "STACK": bytes, "LOCAL": bytes,
    ...}} from a `cuobjdump -res-usage` listing: registers a thread,
    and its stack frame and local memory (where spills go)."""
    return {m.group(1): {k: int(v) for k, v in
                         re.findall(r"([A-Z_]+(?:\[\d+\])?):(\d+)",
                                    m.group(2))}
            for m in _RES_FUNCTION.finditer(text)}


def _cuobjdump(flag: str, lib) -> str:
    from deeplearning4j_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, flag, str(lib)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump {flag} {lib}: {proc.stderr}")
    return proc.stdout


def _sass_rows(lib, instances, prefix):
    """One row per instance of a library's kernels (`instances` finds
    them by their mangled names): its tensor-core instructions (HMMA for
    mma.sync, HGMMA for wgmma) and its registers, stack and local memory
    (where spills go)."""
    counts = mma_counts(_cuobjdump("-sass", lib))
    usage = res_usage(_cuobjdump("-res-usage", lib))
    rows = []
    for (kind, dt, D, causal), fn in sorted(instances(counts).items()):
        use = usage.get(fn, {})
        rows.append(dict(kernel=prefix + kind, dtype=dt, D=D, causal=causal,
                         **counts[fn], registers=use.get("REG"),
                         stack=use.get("STACK"), local=use.get("LOCAL")))
    return rows


def phase_build(report, fails):
    from deeplearning4j_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {sorted(paths)} in {report['build_s']:.2f} s", flush=True)
    # the flash kernels must run on the tensor cores: every bf16 and fp32
    # instance (D 32/64/128, causal or not) of the backward's two kernels
    # and of the forward's two modes has HMMA (mma.sync) or HGMMA (wgmma)
    # in its SASS; registers, stack and local memory are reported beside
    for key, lib, instances, prefix, kinds in (
            ("bwd_sass", "flash_attention_bwd", _bwd_instances,
             "flash_attention_bwd_", ("dq", "dkv")),
            ("fwd_sass", "flash_attention", _fwd_instances,
             "flash_attention_", ("fwd", "carry"))):
        rows = report[key] = _sass_rows(paths[lib], instances, prefix)
        for kind in kinds:
            for dt in ("float32", "bfloat16"):
                mine = [r for r in rows
                        if r["kernel"] == prefix + kind and r["dtype"] == dt]
                fails.check(len(mine) == 6 and all(
                    r["HMMA"] + r["HGMMA"] > 0 for r in mine),
                    f"SASS of {prefix}{kind} {dt}: want HMMA/HGMMA in all "
                    f"6 instances (D 32/64/128, causal or not), got "
                    f"{[(r['D'], r['causal'], r['HMMA'], r['HGMMA']) for r in mine]}")
        for r in rows:
            print(f"[build] {r['kernel']} {r['dtype']} D={r['D']} causal="
                  f"{r['causal']}: HMMA {r['HMMA']}, HGMMA {r['HGMMA']}, "
                  f"registers {r['registers']}, stack {r['stack']} B, local "
                  f"{r['local']} B", flush=True)


# ---------------------------------------------------- phase 2: kernel checks
def phase_kernels(device, report, fails, small=False):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import layernorm as ln

    flush = (torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                         device=device) if device.type == "cuda" else None)
    gen = torch.Generator().manual_seed(0)

    def rnd(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(
            device, dtype)

    main_rows = 16 * 512 if not small else 64
    # "long": phase 6's rows (B * T of the long-context LM, d_model);
    # "ring_chunk": its ring chunk [B, T / P, H, D]
    long_rows, long_d = ((8 * LM_LONG["max_len"], LM_LONG["d_model"])
                         if not small else (128, 64))
    # "wide": a row wider than a warp keeps in registers (a block a row);
    # "decode" / "decode_k": phase 8's serving rows, S = 8 slots and
    # S x K = 32 positions of a speculative score, at d_model 256
    ln_cases = [("main", main_rows, 256), ("ragged", 1000, 257),
                ("odd", 37, 33), ("long", long_rows, long_d),
                ("wide", 64, 2304), ("decode", 8, 256),
                ("decode_k", 32, 256)]
    # "long": phase 6's local attention [B, T, H, D]; "misaligned": q, k
    # and v are views that start off 16-byte alignment (the wrappers copy
    # them for the kernels' 16-byte row copies)
    fl_cases = ([("main", 16, 512, 8, 32), ("ragged", 2, 300, 4, 64),
                 ("wide", 2, 300, 2, 128),
                 ("ring_chunk", 8, LM_LONG["max_len"] // SEQ_P, 8, 64),
                 ("long", 8, LM_LONG["max_len"], LM_LONG["n_heads"],
                  LM_LONG["d_model"] // LM_LONG["n_heads"]),
                 ("misaligned", 2, 300, 4, 64)]
                if not small else
                [("main", 2, 70, 2, 32), ("ring_chunk", 2, 32, 2, 64),
                 ("long", 1, 160, 2, 64), ("misaligned", 1, 40, 2, 32)])
    bwd_ragged = ([("ragged_tq_tk", 2, 300, 200, 4, 64),
                   ("ragged_tq_tk", 2, 200, 300, 2, 128)]
                  if not small else [("ragged_tq_tk", 1, 40, 24, 2, 32)])
    checks, timings = [], {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        es = torch.tensor([], dtype=dt).element_size()
        for case, R, D in ln_cases:
            x = rnd((R, D), dt, 2.0, 0.5)
            h = rnd((R, D), dt)
            g, b = rnd((D,), dt, 0.1, 1.0), rnd((D,), dt, 0.1)
            y, m, r = ln.layer_norm_fwd(x, g, b)
            y0, m0, r0 = ln.layer_norm_plain(x, g, b)
            err = (y.float() - y0.float()).abs().max().item()
            serr = max((m - m0).abs().max().item(),
                       ((r - r0) / r0).abs().max().item())
            s, y2, _, _ = ln.residual_layer_norm_fwd(x, h, g, b)
            s0, y20, _, _ = ln.residual_layer_norm_plain(x, h, g, b)
            err2 = max((y2.float() - y20.float()).abs().max().item(),
                       (s.float() - s0.float()).abs().max().item())
            for name, e in (("layer_norm", err), ("residual_layer_norm",
                                                   err2)):
                ok = fails.check(e <= LN_TOL[dt_name] and serr <= 1e-5,
                                 f"{name} {case} {dt_name} R={R} D={D}: "
                                 f"max_abs_err {e} (tol {LN_TOL[dt_name]})"
                                 f", stats err {serr}")
                checks.append(dict(kernel=name, case=case, dtype=dt_name,
                                   shape=[R, D], max_abs_err=e,
                                   tol=LN_TOL[dt_name], ok=ok))
            if case in ("decode", "decode_k"):
                ln_bytes = 2 * R * D * es + 2 * D * es + 2 * R * 4
                timings[("layer_norm", dt_name, case)] = dict(
                    shape=[R, D], max_abs_err=err,
                    ms=timer(device, lambda: ln.layer_norm_fwd(x, g, b),
                             flush=flush),
                    plain_ms=timer(device,
                                   lambda: ln.layer_norm_plain(x, g, b),
                                   flush=flush),
                    library_ms=timer(device, lambda: F.layer_norm(
                        x, (D,), g, b, 1e-5), flush=flush),
                    bound=bound(ln_bytes, 8.0 * R * D, "float32"))
            if case != "main":
                continue
            ln_bytes = 2 * R * D * es + 2 * D * es + 2 * R * 4
            timings[("layer_norm", dt_name)] = dict(
                shape=[R, D], max_abs_err=err,
                ms=timer(device, lambda: ln.layer_norm_fwd(x, g, b),
                         flush=flush),
                plain_ms=timer(device, lambda: ln.layer_norm_plain(x, g, b),
                               flush=flush),
                library_ms=timer(device, lambda: F.layer_norm(
                    x, (D,), g, b, 1e-5), flush=flush),
                bound=bound(ln_bytes, 8.0 * R * D, "float32"))
            timings[("residual_layer_norm", dt_name)] = dict(
                shape=[R, D], max_abs_err=err2,
                ms=timer(device, lambda: ln.residual_layer_norm_fwd(
                    x, h, g, b), flush=flush),
                plain_ms=timer(device, lambda: ln.residual_layer_norm_plain(
                    x, h, g, b), flush=flush),
                library_ms=None,
                bound=bound(ln_bytes + 2 * R * D * es, 9.0 * R * D,
                            "float32"))
        for case, B, T, H, Dh in fl_cases:
            q, k, v = (rnd((B, T, H, Dh), dt) for _ in range(3))
            if case == "misaligned":
                q, k, v = (off_alignment(a) for a in (q, k, v))
            for causal in (True, False):
                o, lse = fa.flash_attention_fwd(q, k, v, causal)
                o0, lse0 = fa.flash_attention_plain(q, k, v, causal)
                e = (o.float() - o0.float()).abs().max().item()
                el = (lse - lse0).abs().max().item()
                ok = fails.check(
                    e <= FLASH_TOL[dt_name] and el <= 1e-4,
                    f"flash_attention_fwd {case} {dt_name} causal={causal} "
                    f"{[B, T, H, Dh]}: max_abs_err {e} (tol "
                    f"{FLASH_TOL[dt_name]}), lse err {el}")
                checks.append(dict(kernel="flash_attention_fwd", case=case,
                                   dtype=dt_name, causal=causal,
                                   shape=[B, T, H, Dh], max_abs_err=e,
                                   lse_err=el, tol=FLASH_TOL[dt_name],
                                   ok=ok))
                do = rnd((B, T, H, Dh), dt)
                delta = fa.attention_delta(do, o)
                bwd = (q, k, v, do, lse, delta, causal)
                bwd_errs = _bwd_checks(bwd, case, dt_name, checks, fails)
                if case == "ring_chunk":     # diag and visible chunks
                    timings.update(_bwd_timings(
                        device, flush, bwd, bwd_errs, dt_name,
                        ("ring_chunk_diag" if causal
                         else "ring_chunk_visible",)))
                if causal and case in ("main", "long"):
                    tag = () if case == "main" else (case,)
                    timings[("flash_attention_fwd", dt_name, *tag)] = (
                        _fwd_timing(device, flush, q, k, v, e, dt_name))
                    timings.update(_bwd_timings(device, flush, bwd, bwd_errs,
                                                dt_name, tag))
        # the backward kernels alone at Tq != Tk, both ways round
        for case, B, Tq, Tk, H, Dh in bwd_ragged:
            q, do = (rnd((B, Tq, H, Dh), dt) for _ in range(2))
            k, v = (rnd((B, Tk, H, Dh), dt) for _ in range(2))
            for causal in (True, False):
                o, lse = fa.flash_attention_fwd(q, k, v, causal)
                _bwd_checks((q, k, v, do, lse, fa.attention_delta(do, o),
                             causal), case, dt_name, checks, fails)
        timings.update(_carry_checks(device, checks, fails, flush, rnd,
                                     dt_name, dt, small))
    timings.update(_adam_checks(device, checks, fails, flush, rnd,
                                dict(LM, d_model=64) if small else LM,
                                "lm_block_run", timed=True))
    timings.update(_dropout_checks(device, checks, fails, flush, rnd,
                                   small))
    _adam_checks(device, checks, fails, flush, rnd,
                 dict(LM_LONG, d_model=32) if small else LM_LONG,
                 "long_block_run", timed=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    report["kernel_checks"] = checks
    report["kernel_timings"] = {"/".join(k): v
                                for k, v in timings.items()}
    for k, t in report["kernel_timings"].items():
        print(f"[kernels] {k} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}), max_abs_err "
              f"{t['max_abs_err']:.3g}", flush=True)
    return timings


def off_alignment(t):
    """A view holding t's values that starts one element past a 16-byte
    boundary, so none of its rows is 16-byte aligned."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _fwd_timing(device, flush, q, k, v, err, dt_name):
    """The causal forward kernel's time on q, k, v beside its plain
    version and the yardstick, SDPA (o only) at the same shape."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    B, T, H, Dh = q.shape
    bthd, bht = B * T * H * Dh, B * H * T
    pairs = B * H * T * (T + 1) / 2           # visible (q, k) pairs
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    return dict(
        shape=[B, T, H, Dh], max_abs_err=err,
        ms=timer(device, lambda: fa.flash_attention_fwd(q, k, v, True),
                 flush=flush),
        plain_ms=timer(device, lambda: fa.flash_attention_plain(
            q, k, v, True), iters=10, flush=flush),
        library_ms=timer(device, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush=flush),
        bound=bound(4 * bthd * q.element_size() + bht * 4, 4.0 * Dh * pairs,
                    FLASH_RATE[dt_name]))


def _bwd_checks(bwd, case, dt_name, checks, fails):
    """The dQ and dK/dV kernels on `bwd` = (q, k, v, do, lse, delta,
    causal) against their plain versions, each held to `bwd_tol` of its
    largest |value|; returns {kernel: max_abs_err}."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    q, k, causal = bwd[0], bwd[1], bwd[-1]
    dq = fa.flash_attention_bwd_dq(*bwd)
    dq0 = fa.flash_attention_bwd_dq_plain(*bwd)
    dk, dv = fa.flash_attention_bwd_dkv(*bwd)
    dk0, dv0 = fa.flash_attention_bwd_dkv_plain(*bwd)
    errs = {}
    for name, pairs in (
            ("flash_attention_bwd_dq", [(dq, dq0)]),
            ("flash_attention_bwd_dkv", [(dk, dk0), (dv, dv0)])):
        e_b = max((a.float() - b.float()).abs().max().item()
                  for a, b in pairs)
        ref = max(b.float().abs().max().item() for _, b in pairs)
        tol = bwd_tol(dt_name, ref)
        ok = fails.check(
            e_b <= tol, f"{name} {case} {dt_name} causal={causal} q "
            f"{list(q.shape)} Tk {k.shape[1]}: max_abs_err {e_b} (tol "
            f"{tol}, max |ref| {ref})")
        checks.append(dict(kernel=name, case=case, dtype=dt_name,
                           causal=causal, shape=list(q.shape),
                           tk=k.shape[1], max_abs_err=e_b, max_abs_ref=ref,
                           tol=tol, ok=ok))
        errs[name] = e_b
    return errs


def _bwd_timings(device, flush, bwd, errs, dt_name, tag):
    """Times of the dQ and dK/dV kernels on `bwd` = (q, k, v, do, lse,
    delta, causal), beside their plain versions and the yardstick, SDPA's
    backward (dq, dk and dv in one call) at the same shape; keyed
    (kernel, dtype, *tag)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    q, k, v, do, _, _, causal = bwd
    B, T, H, Dh = q.shape
    es = q.element_size()
    bthd, bht = B * T * H * Dh, B * H * T
    pairs = B * H * T * (T + 1) / 2 if causal else B * H * T * T
    ql, kl, vl = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    dol = do.transpose(1, 2)
    lib_bwd = timer(device, lambda: torch.autograd.grad(
        ol, (ql, kl, vl), dol, retain_graph=True), flush=flush)
    del ol
    out = {}
    for name, fn, plain, nbytes, flops in (
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dq_plain, 5 * bthd * es + 2 * bht * 4,
             6.0 * Dh * pairs),
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_plain, 6 * bthd * es + 2 * bht * 4,
             8.0 * Dh * pairs)):
        out[(name, dt_name, *tag)] = dict(
            shape=[B, T, H, Dh], causal=causal, max_abs_err=errs[name],
            ms=timer(device, lambda: fn(*bwd), flush=flush),
            plain_ms=timer(device, lambda: plain(*bwd), iters=10,
                           flush=flush),
            library_ms=lib_bwd,
            bound=bound(nbytes, flops, FLASH_RATE[dt_name]))
    return out


def _carry_checks(device, checks, fails, flush, rnd, dt_name, dt, small):
    """The carry fold against its plain version at the ring's chunk
    shape ([8, 512, 8, 64]: B, T_local, H, D of phase 6): a diag fold
    from the fresh state, a visible fold from a seeded one, and a chain
    of the two; a ragged visible fold (Tq 300, Tk 200) at D = 32 and
    128. Times the main visible and diag folds (in place, so the timed
    state keeps folding). No one PyTorch call computes an unnormalised
    fold, so there is no library yardstick."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    main = (2, 64, 2, 32) if small else (8, 512, 8, 64)
    ragged = [(2, 30, 20, 2, 32)] if small else [(2, 300, 200, 4, 32),
                                                 (2, 300, 200, 4, 128)]

    def fresh(B, Tq, H, D):
        return [torch.full((B, H, Tq), fa.NEG_INF, device=device),
                torch.zeros((B, H, Tq), device=device),
                torch.zeros((B, H, Tq, D), device=device)]

    def seeded(B, Tq, H, D):
        return [rnd((B, H, Tq), torch.float32, 1.0, 2.0),
                rnd((B, H, Tq), torch.float32, 1.0).abs() + 1.0,
                rnd((B, H, Tq, D), torch.float32)]

    def check(case, q, folds, state):
        """Run `folds` [(k, v, diag)] through the kernel and the plain
        version from copies of `state`; hold m, l and acc each to
        CARRY_RTOL of its own scale; return the worst error."""
        st, ref = [t.clone() for t in state], [t.clone() for t in state]
        for k, v, diag in folds:
            fa.flash_attention_carry(q, k, v, *st, diag=diag)
            fa.flash_attention_carry_plain(q, k, v, *ref, diag)
        errs = [(a - b).abs().max().item() for a, b in zip(st, ref)]
        tols = [CARRY_RTOL * max(1.0, b.abs().max().item()) for b in ref]
        diags = [d for _, _, d in folds]
        ok = fails.check(all(e <= t for e, t in zip(errs, tols)),
                         f"flash_attention_carry {case} {dt_name} "
                         f"diag={diags} q {list(q.shape)}: max_abs_err "
                         f"m, l, acc {errs} (tol {tols})")
        checks.append(dict(kernel="flash_attention_carry", case=case,
                           dtype=dt_name, diag=diags, shape=list(q.shape),
                           tk=[k.shape[1] for k, _, _ in folds],
                           max_abs_err=max(errs), max_abs_err_m_l_acc=errs,
                           tol_m_l_acc=tols, ok=ok))
        return max(errs)

    B, T, H, D = main
    q, k, v, k2, v2 = (rnd((B, T, H, D), dt) for _ in range(5))
    e_diag = check("main", q, [(k, v, True)], fresh(B, T, H, D))
    e_vis = check("main", q, [(k2, v2, False)], seeded(B, T, H, D))
    check("chain", q, [(k, v, True), (k2, v2, False)], fresh(B, T, H, D))
    for Bq, Tq, Tk, Hq, Dq in ragged:
        qr = rnd((Bq, Tq, Hq, Dq), dt)
        kr, vr = (rnd((Bq, Tk, Hq, Dq), dt) for _ in range(2))
        check("ragged", qr, [(kr, vr, False)], seeded(Bq, Tq, Hq, Dq))
    # q, k, v as views off 16-byte alignment: a diag fold, then a visible
    Bq, Tq, _, Hq, Dq = ragged[0]
    qm, km, vm, km2, vm2 = (off_alignment(rnd((Bq, Tq, Hq, Dq), dt))
                            for _ in range(5))
    check("misaligned", qm, [(km, vm, True), (km2, vm2, False)],
          fresh(Bq, Tq, Hq, Dq))
    es = q.element_size()
    state_bytes = 2 * (2 * B * H * T * 4 + B * H * T * D * 4)  # r + w
    timings = {}
    for name, diag, err, pairs in (
            ("flash_attention_carry", False, e_vis, B * H * T * T),
            ("flash_attention_carry_diag", True, e_diag,
             B * H * T * (T + 1) / 2)):
        st, ref = seeded(B, T, H, D), seeded(B, T, H, D)
        timings[(name, dt_name)] = dict(
            shape=[B, T, H, D], max_abs_err=err,
            ms=timer(device, lambda: fa.flash_attention_carry(
                q, k, v, *st, diag=diag), flush=flush),
            plain_ms=timer(device, lambda: fa.flash_attention_carry_plain(
                q, k, v, *ref, diag), iters=10, flush=flush),
            library_ms=None,
            bound=bound(3 * B * T * H * D * es + state_bytes,
                        4.0 * D * pairs, FLASH_RATE[dt_name]))
    return timings


def _adam_checks(device, checks, fails, flush, rnd, cfg, case, timed):
    """Fused Adam at the block run of `cfg` against its plain version:
    bit-equal with fp32 grads and with bf16 grads (upcast on load), in
    as many launches as its leaves need (`MAX_LEAVES` a launch); with
    `timed`, timed beside `torch.optim.Adam(fused=True).step()` on the
    same tensors."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.kernels import fused_adam as fad
    shapes = block_shapes(cfg)
    want_launches = (-(-len(shapes) // fad.MAX_LEAVES)
                     if device.type == "cuda" else 0)
    n = int(sum(np.prod(s) for s in shapes))
    upd, step = Adam(1e-3), 9
    timings = {}
    for g_name, g_dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        p = [rnd(s, torch.float32, 0.05) for s in shapes]
        g = [rnd(s, g_dt, 1e-3) for s in shapes]
        m = [rnd(s, torch.float32, 1e-4) for s in shapes]
        v = [rnd(s, torch.float32, 1e-6).abs() for s in shapes]
        pa, ma, va = ([t.clone() for t in ts] for ts in (p, m, v))
        n0 = K.LAUNCHES["fused_adam"]
        fad.adam_update_packed(upd, pa, g, ma, va, step)
        launches = K.LAUNCHES["fused_adam"] - n0
        fad.adam_update_plain(upd, p, g, m, v, step)
        err = max((a - b).abs().max().item()
                  for a, b in zip(pa + ma + va, p + m + v))
        ok = fails.check(err == 0 and launches == want_launches,
                         f"fused_adam {case} grads {g_name} [{n}] "
                         f"({len(shapes)} leaves, {launches} launches, want "
                         f"{want_launches}): max_abs_err {err} (must be "
                         f"bit-equal)")
        checks.append(dict(kernel="fused_adam", case=case, dtype=g_name,
                           shape=[n], leaves=len(shapes), launches=launches,
                           max_abs_err=err, tol=0.0, ok=ok))
        if not timed:
            continue
        # bytes: p, m, v read and written in fp32, the grads read once
        t = dict(shape=[n], max_abs_err=err,
                 ms=timer(device, lambda: fad.adam_update_packed(
                     upd, pa, g, ma, va, step), flush=flush),
                 plain_ms=timer(device, lambda: fad.adam_update_plain(
                     upd, p, g, m, v, step), flush=flush),
                 library_ms=None,
                 bound=bound((6 * 4 + g[0].element_size()) * n, 10.0 * n,
                             "float32"))
        if g_name == "float32":
            # torch's fused Adam takes grads in the params' dtype only, so
            # the bf16-grad instance has no one-call yardstick
            params = [torch.nn.Parameter(t_.clone()) for t_ in p]
            for q_, g_ in zip(params, g):
                q_.grad = g_.clone()
            opt = torch.optim.Adam(params, lr=1e-3,
                                   fused=device.type == "cuda")
            t["library_ms"] = timer(device, opt.step, flush=flush)
        timings[("fused_adam", g_name)] = t
    return timings


def _dropout_checks(device, checks, fails, flush, rnd, small):
    """The threefry kernels against their plain versions, bit for bit:
    dropout (fp32 and bf16) at the smoke LM's residual [16, 511, 256]
    with p = 0.9, at a ragged length and on an offset view, and the raw
    words (an index range past 2^32 too) against `threefry_bits_plain`;
    timed at [16, 511, 256] beside `F.dropout` (Philox bits, not
    JAX's: the same work, another draw)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.common import prng
    from deeplearning4j_tpu_torch.kernels import dropout as kd
    key = prng.fold_in(prng.fold_in(prng.key(12346), 3), 2)
    main = (16, 511, 256) if not small else (2, 31, 16)
    timings = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        cases = [("main", rnd(main, dt), 0.9),
                 ("ragged", rnd((3, 1001), dt), 0.8),
                 ("offset_view", rnd((5, 4099), dt)[1:, 3:4000], 0.5)]
        for case, x, p in cases:
            n0 = K.LAUNCHES["dropout"]
            y = kd.dropout_fwd(x, key, p)
            launched = K.LAUNCHES["dropout"] - n0
            y0 = kd.dropout_plain(x, key, p)
            err = (y.float() - y0.float()).abs().max().item()
            equal = bool(torch.equal(y, y0))
            ok = fails.check(
                equal and launched == (device.type == "cuda"),
                f"dropout {case} {dt_name} {list(x.shape)} p={p}: "
                f"bit-equal {equal}, max_abs_err {err}, launches "
                f"{launched}")
            checks.append(dict(kernel="dropout", case=case, dtype=dt_name,
                               shape=list(x.shape), p=p, max_abs_err=err,
                               tol=0.0, ok=ok))
            if case != "main" or dt_name != "float32":
                continue
            n = x.numel()
            timings[("dropout", dt_name)] = dict(
                shape=list(x.shape), max_abs_err=err,
                ms=timer(device, lambda: kd.dropout_fwd(x, key, p),
                         flush=flush),
                plain_ms=timer(device, lambda: kd.dropout_plain(x, key, p),
                               flush=flush),
                library_ms=timer(device, lambda: F.dropout(
                    x, 1 - p, training=True), flush=flush),
                # x read and y written once; the mask is recomputed in
                # the backward, never stored
                bound=bound(2 * n * x.element_size(), THREEFRY_OPS * n,
                            "int32"))
    for case, n, offset in (("main", int(np.prod(main)), 0),
                            ("high_word", 4099, 2 ** 32 - 1000)):
        w = kd.threefry_bits(key, n, device, offset)
        w0 = kd.threefry_bits_plain(key, n, device, offset)
        err = int((w - w0).abs().max().item())
        ok = fails.check(bool(torch.equal(w, w0)),
                         f"threefry_bits {case} [{n}] offset {offset}: "
                         f"max abs difference {err}")
        checks.append(dict(kernel="threefry_bits", case=case,
                           dtype="uint32", shape=[n], offset=offset,
                           max_abs_err=err, tol=0, ok=ok))
        if case == "main":
            timings[("threefry_bits", "float32")] = dict(
                shape=[n], max_abs_err=err,
                ms=timer(device, lambda: kd.threefry_bits(key, n, device),
                         flush=flush),
                plain_ms=timer(device, lambda: kd.threefry_bits_plain(key, n,
                                                               device),
                               flush=flush),
                library_ms=None,
                bound=bound(4 * n, THREEFRY_OPS * n, "int32"))
    # per-row keys (the serving sampler's draw: 8 slots, each under its
    # own request's key), at the smoke LM's vocab and a ragged one
    keys = prng.fold_in_rows(
        prng.keys_tensor([prng.key(100 + i) for i in range(8)]),
        torch.arange(8) * 37).to(device)
    for case, n in (("main", 512), ("ragged", 77)):
        w = kd.threefry_bits_rows(keys, n)
        w0 = kd.threefry_bits_rows_plain(keys, n)
        err = int((w - w0).abs().max().item())
        ok = fails.check(bool(torch.equal(w, w0)) and w.shape == (8, n),
                         f"threefry_rows {case} [8, {n}]: max abs "
                         f"difference {err}")
        checks.append(dict(kernel="threefry_rows", case=case,
                           dtype="uint32", shape=[8, n], max_abs_err=err,
                           tol=0, ok=ok))
        if case == "main":
            timings[("threefry_rows", "float32")] = dict(
                shape=[8, n], max_abs_err=err,
                ms=timer(device, lambda: kd.threefry_bits_rows(keys, n),
                         flush=flush),
                plain_ms=timer(device, lambda: kd.threefry_bits_rows_plain(
                    keys, n), flush=flush),
                library_ms=None,
                # the [8, 2] keys read, the words written once
                bound=bound(8 * 8 + 4 * 8 * n, THREEFRY_OPS * 8 * n,
                            "int32"))
    return timings


# ------------------------------------------------------- phase 3: scoring
def phase_scoring(device, report, fails, cfg, B, T):
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    params = random_lm_params(cfg, seed=1234, head_scale=4.0)
    net = build_lm(cfg, device, params)
    ids = np.random.default_rng(7).integers(0, cfg["vocab"], (B, T))
    K.reset_launches()
    out = net.output(ids)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    ms = timer(device, lambda: net.output(ids), iters=5, warmup=1)
    ref = build_lm(cfg, "cpu", params).output(ids)
    err = (out.cpu() - ref).abs().max().item()
    fails.check(tuple(out.shape) == (B, T, cfg["vocab"])
                and bool(torch.isfinite(out).all()),
                f"output() shape/finite: {tuple(out.shape)}")
    fails.check(err <= OUTPUT_ATOL,
                f"output() card vs CPU max_abs_err {err} (tol {OUTPUT_ATOL})")
    report["scoring"] = dict(B=B, T=T, max_abs_err_vs_cpu=err, ms=ms,
                             launches=launches)
    print(f"[scoring] output() [{B}, {T}] on {device}: {ms:.3f} ms, "
          f"max_abs_err vs CPU {err:.3g}, launches {launches}", flush=True)
    return net, launches


# -------------------------------------- sampled streams, card against CPU
SAMPLED_NOISE_ATOL = 1e-5    # the Gumbel noise, card's logs against CPU's


def cpu_twin(net):
    """A copy of `net` (params, state, configuration) on the CPU."""
    import copy
    return copy.deepcopy(net).to("cpu")


def engine_streams(net, reqs, n_tok, **engine_kw):
    """Token lists of `reqs` ([(prompt, {temperature, top_p, rng})]) from
    one PagedDecodeEngine of `engine_kw` on net's device, all admitted at
    once and stepped with its default dispatch (a request's sampled
    stream does not depend on the rest)."""
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    max_len = net.layers[1].max_len
    eng = PagedDecodeEngine(net, n_slots=len(reqs), block_len=16,
                            n_blocks=len(reqs) * (max_len // 16) + 1,
                            device=net.device, **engine_kw)
    admitted = eng.admit_many([dict(prompt_ids=p, n_tokens=n_tok, **a)
                               for p, a in reqs])
    out = {s: [int(f)] for s, f, _ in admitted}
    while eng.active.any():
        for s, toks in eng.step()[0].items():
            out[s].extend(int(t) for t in toks)
    return [out[s] for s, _, _ in admitted]


def engine_noise(key, n, V):
    """[n, V]: token t's Gumbel noise under `fold_in(key, t)`, the
    engine's draw (on the CPU)."""
    import torch
    from deeplearning4j_tpu_torch.common import prng
    from deeplearning4j_tpu_torch.zoo.transformer import request_key
    kt = prng.keys_tensor([request_key(key)] * n)
    return prng.gumbel_rows(prng.fold_in_rows(kt, torch.arange(n)), V)


def generate_noise(key, n, V, B=1, row=0):
    """[n, V]: row `row` of generate()'s [B, V] draw at each step (the
    key split once a step)."""
    import torch
    from deeplearning4j_tpu_torch.common import prng
    from deeplearning4j_tpu_torch.zoo.transformer import request_key
    k, rows = request_key(key), []
    for _ in range(n):
        k, sub = prng.split(k)
        rows.append(prng.gumbel(sub, (B, V))[row])
    return torch.stack(rows)


def _spec_near(key, t, logits_t, tokens, eps):
    """A speculative token t decided at a near-tie: its acceptance
    uniform (fold 1 of `fold_in(key, t)`) within eps of q_t(x) for x one
    of the two streams' tokens (a flipped acceptance emits the draft on
    one side), or its resample's noisy logits (fold 2) within eps of a
    tie."""
    import torch
    from deeplearning4j_tpu_torch.common import prng
    from deeplearning4j_tpu_torch.zoo.transformer import request_key
    kt = prng.fold_in(request_key(key), t)
    u = float(prng.uniform(prng.fold_in(kt, 1), ()))
    q = torch.softmax(torch.as_tensor(logits_t), -1).numpy()
    if any(abs(u - q[x]) <= eps for x in tokens):
        return True
    z = np.sort(logits_t + prng.gumbel(prng.fold_in(kt, 2),
                                       (len(logits_t),)).numpy())
    return bool(z[-1] - z[-2] <= eps)


def sampled_margin(cpu_net, card_net, prompts, ref, got, noise_of, temp,
                   top_p=None, spec_keys=None):
    """Sampled streams by margin (`zoo.transformer.stream_agreement` on
    noisy logits): `ref` the CPU port's streams, `got` the card's, from
    the same keys. Token t's noisy logits are the CPU's
    `filter_logits(log(p_t) / temp, top_p)` (teacher-forced) plus its
    noise (`noise_of(i, n)`); a stream may first differ only where their
    top-1/top-2 gap is within eps, the largest |log p| difference
    between the card's and the CPU's teacher-forced probabilities over
    temp, plus SAMPLED_NOISE_ATOL (speculative streams: also at
    `_spec_near`). Returns (indices that disagree, near-ties, eps)."""
    import torch
    from deeplearning4j_tpu_torch.zoo.transformer import (
        filter_logits, stream_agreement)
    bad, ties, eps_max = [], 0, 0.0
    for i, (p, r, g) in enumerate(zip(prompts, ref, got)):
        lc = np.log(np.clip(tf(cpu_net, p, r), 1e-9, None))
        lg = np.log(np.clip(tf(card_net, p, r), 1e-9, None))
        eps = float(np.abs(lc - lg).max()) / temp + SAMPLED_NOISE_ATOL
        eps_max = max(eps_max, eps)
        logits = torch.as_tensor(lc / temp, dtype=torch.float32)
        if top_p is not None:
            logits = filter_logits(logits, None,
                                   torch.full((len(lc), 1), float(top_p)))
        logits = logits.numpy()
        z = logits + noise_of(i, len(r)).numpy()
        rep = stream_agreement(r, g, z, eps)
        ties += rep["near_ties"]
        ok = rep["ok"]
        if (not ok and spec_keys is not None and len(g) == len(r)
                and rep["first_diff"] is not None):
            t = rep["first_diff"]
            ok = _spec_near(spec_keys[i], t, logits[t], (r[t], g[t]), eps)
        if not ok:
            bad.append(i)
    return bad, ties, eps_max


# ------------------------------------------------------- phase 4: serving
def phase_serving(device, report, fails, net, n_greedy, n_sampled, n_tok,
                  len_range):
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.serving import GenerationServer
    from deeplearning4j_tpu_torch.zoo.transformer import generate

    max_len = net.layers[1].max_len
    bl, n_slots = 16, 8
    srv = GenerationServer(net, n_slots=n_slots, block_len=bl,
                           n_blocks=n_slots * (max_len // bl) + 1,
                           device=device)
    t0 = time.perf_counter()
    srv.warmup(64, 4)
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    V = net.layers[-1].n_out
    lens = rng.integers(len_range[0], len_range[1] + 1,
                        n_greedy + n_sampled)
    prompts = [rng.integers(0, V, n) for n in lens]
    K.reset_launches()
    srv.start()
    try:
        t0 = time.perf_counter()
        streams = [srv.generate_async(p, n_tok) for p in prompts[:n_greedy]]
        streams += [srv.generate_async(p, n_tok, temperature=0.8, top_p=0.9,
                                       rng=100 + i)
                    for i, p in enumerate(prompts[n_greedy:])]
        results = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    n_total = sum(len(r) for r in results)
    ttft = sorted((s.t_first - s.t_submit) * 1e3 for s in streams)
    mismatched = []
    for i in range(n_greedy):
        want = generate(net, prompts[i][None], n_tok, temperature=0)[0]
        if not np.array_equal(results[i], want):
            mismatched.append(i)
    sampled_ok = all(len(r) == n_tok and ((r >= 0) & (r < V)).all()
                     for r in results[n_greedy:])
    # sampled: the engine's and generate()'s streams against the CPU
    # port's from the same keys, by margin
    cpu = cpu_twin(net)
    s_prompts = prompts[n_greedy:]
    s_reqs = [(p, dict(temperature=0.8, top_p=0.9, rng=100 + i))
              for i, p in enumerate(s_prompts)]
    cpu_streams = engine_streams(cpu, s_reqs, n_tok)
    bad_eng, ties_eng, eps_eng = sampled_margin(
        cpu, net, s_prompts, cpu_streams,
        [r.tolist() for r in results[n_greedy:]],
        lambda i, n: engine_noise(100 + i, n, V), 0.8, 0.9)
    gen_card = [generate(net, p[None], n_tok, temperature=0.8, top_p=0.9,
                         rng=200 + i)[0].tolist()
                for i, p in enumerate(s_prompts)]
    gen_cpu = [generate(cpu, p[None], n_tok, temperature=0.8, top_p=0.9,
                        rng=200 + i)[0].tolist()
               for i, p in enumerate(s_prompts)]
    bad_gen, ties_gen, eps_gen = sampled_margin(
        cpu, net, s_prompts, gen_cpu, gen_card,
        lambda i, n: generate_noise(200 + i, n, V), 0.8, 0.9)
    sampled_match = sum(np.array_equal(a, b) for a, b in zip(
        cpu_streams, results[n_greedy:]))
    fails.check(not mismatched,
                f"greedy streams differ from generate(): {mismatched}")
    fails.check(sampled_ok, "sampled streams out of vocab or wrong length")
    fails.check(not bad_eng, f"sampled engine streams card vs CPU apart "
                f"beyond a near-tie: {bad_eng} (eps {eps_eng})")
    fails.check(not bad_gen, f"sampled generate() card vs CPU apart "
                f"beyond a near-tie: {bad_gen} (eps {eps_gen})")
    fails.check(all(len(r) == n_tok for r in results[:n_greedy]),
                "greedy stream lengths")
    report["serving"] = dict(
        requests=len(streams), greedy=n_greedy, sampled=n_sampled,
        n_tokens=n_tok, prompt_lens=[int(n) for n in lens],
        warmup_s=warm_s, wall_s=wall, tokens=n_total,
        tokens_per_s=n_total / wall, ttft_ms_p50=float(np.median(ttft)),
        ttft_ms_max=float(ttft[-1]), greedy_mismatched=mismatched,
        sampled_equal_to_cpu=int(sampled_match),
        sampled_near_ties=dict(engine=int(ties_eng), generate=int(ties_gen)),
        sampled_eps=dict(engine=eps_eng, generate=eps_gen),
        launches=launches, preempted=srv.engine.evict_requeue_total)
    print(f"[serving] {len(streams)} requests x {n_tok} tokens on {device}: "
          f"{n_total / wall:.1f} tok/s, TTFT p50 {np.median(ttft):.1f} ms "
          f"max {ttft[-1]:.1f} ms (this card's own numbers), greedy "
          f"mismatches {mismatched}, sampled streams equal to the CPU "
          f"port's {sampled_match}/{n_sampled} (near-ties: engine "
          f"{ties_eng}, generate {ties_gen}), launches {launches}",
          flush=True)
    return launches


# ------------------------------------------------------ phase 5: training
def _fit_steps(net, X, Y, B):
    """One `fit` step per B-row batch, in order (a `DataSet` each, which
    neither container shuffles); the loss of each."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    losses = []
    for i in range(0, len(X), B):
        net.fit(DataSet(X[i:i + B], Y[i:i + B]), batch_size=B)
        losses.append(net.score_value)
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    return losses


def _timed_fit(net, X, Y, B, ctx=None):
    """One warm step on X[:B], then the rest of X timed, inside `ctx`:
    ms/step, tokens/s, the losses, peak memory, and the launches (the
    counts are zeroed just before the timed steps and read just after),
    by kernel and by kernel and dtype."""
    import contextlib

    import torch
    from deeplearning4j_tpu_torch import kernels as K
    on_card = net.device.type == "cuda"
    with ctx or contextlib.nullcontext():
        _fit_steps(net, X[:B], Y[:B], B)                  # warm
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        losses = _fit_steps(net, X[B:], Y[B:], B)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        by_dtype = dict(sorted(K.LAUNCHES_BY_DTYPE.items()))
    n = len(losses)
    return dict(steps=n, wall_s=wall, ms_per_step=wall / n * 1e3,
                tokens_per_s=B * X.shape[1] * n / wall,
                loss_first=losses[0], loss_last=losses[-1], losses=losses,
                peak_mem_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None),
                launches=launches, launches_by_dtype=by_dtype)


def _master_is_fp32(net) -> bool:
    """Params and updater state all fp32 (the mixed policy's master)."""
    import torch
    return (all(p.dtype == torch.float32 for p in net.parameters())
            and all(t.dtype == torch.float32
                    for lst in net.updater_state.values()
                    for st in lst.values() for t in st.values()))


def _mixed_checks(fails, what, mixed, fp32, net, on_card):
    """A mixed_bf16 timed arm against its fp32 arm: the loss falls and
    ends within MIXED_BAND of the fp32 arm's initial loss of the fp32
    arm's final loss; the master stays fp32; every MIXED_KERNELS bf16
    instance launched and no fp32 one."""
    losses = mixed["losses"]
    fails.check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"{what} mixed_bf16 loss did not fall: {losses[0]} -> "
                f"{losses[-1]}")
    gap = abs(mixed["loss_last"] - fp32["loss_last"])
    fails.check(gap <= MIXED_BAND * fp32["loss_first"],
                f"{what} mixed_bf16 final loss {mixed['loss_last']} vs fp32 "
                f"{fp32['loss_last']}: gap {gap} over {MIXED_BAND} x the "
                f"fp32 initial loss {fp32['loss_first']}")
    fails.check(_master_is_fp32(net),
                f"{what} mixed_bf16: params or Adam state left fp32")
    if on_card:
        got = mixed["launches_by_dtype"]
        missing = [k for k in MIXED_KERNELS if not got.get(f"{k}/bfloat16")]
        fp32_launches = {k: n for k, n in got.items()
                         if k.endswith("/float32")}
        fails.check(not missing and not fp32_launches,
                    f"{what} mixed_bf16 launches {got}: bf16 instances "
                    f"missing {missing}, fp32 launched {fp32_launches}")
    return gap


def phase_training(device, report, fails, cfg, B_check, n_check, B, n_steps):
    """(a) card against CPU over n_check steps from identical params;
    (b) n_steps timed steps on the card, the loss must fall; (c) both
    again under mixed_bf16 (step 0's loss card against CPU; the timed
    arm against (b)). Returns the launch counts of (b) and (c)'s timed
    steps."""
    params = random_lm_params(cfg, seed=4321, head_scale=1.0)
    X, Y = lm_corpus(cfg, B_check * n_check, seed=5)
    card = build_lm(cfg, device, params)
    t0 = time.perf_counter()
    l_card = _fit_steps(card, X, Y, B_check)
    card_s = time.perf_counter() - t0
    cpu = build_lm(cfg, "cpu", params)
    t0 = time.perf_counter()
    l_cpu = _fit_steps(cpu, X, Y, B_check)
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    fails.check(loss_err <= TRAIN_LOSS_RTOL and all(np.isfinite(l_card)),
                f"training loss card vs CPU rel err {loss_err} (tol "
                f"{TRAIN_LOSS_RTOL}): card {l_card}, CPU {l_cpu}")
    worst, worst_bk = param_diff(card, cpu)
    bk_tol = 2 * n_check * adam_step_max()
    fails.check(worst[0] <= TRAIN_PARAM_RTOL and worst_bk <= bk_tol,
                f"training params card vs CPU: worst rel Frobenius "
                f"{worst[0]} at {worst[1]} (tol {TRAIN_PARAM_RTOL}), "
                f"attn_bk max abs {worst_bk} (tol {bk_tol})")
    del card, cpu

    # (c, first half) mixed_bf16, card against CPU from the same params
    m_card = _fit_steps(build_lm(cfg, device, params, dtype_policy=MIXED),
                        X, Y, B_check)
    m_cpu = _fit_steps(build_lm(cfg, "cpu", params, dtype_policy=MIXED),
                       X, Y, B_check)
    m_step0 = abs(m_card[0] - m_cpu[0]) / abs(m_cpu[0])
    fails.check(m_step0 <= MIXED_STEP0_RTOL and all(np.isfinite(m_card)),
                f"mixed_bf16 training step 0 loss card vs CPU rel err "
                f"{m_step0} (tol {MIXED_STEP0_RTOL}): card {m_card}, CPU "
                f"{m_cpu}")

    X, Y = lm_corpus(cfg, B * (n_steps + 1), seed=6)
    T = cfg["max_len"] - 1
    timed = _timed_fit(build_lm(cfg, device, params), X, Y, B)
    losses = timed["losses"]
    fails.check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"training loss did not fall: {losses[0]} -> {losses[-1]}")
    net = build_lm(cfg, device, params, dtype_policy=MIXED)
    mixed = _timed_fit(net, X, Y, B)
    gap = _mixed_checks(fails, "training", mixed, timed, net,
                        device.type == "cuda")
    del net
    report["training"] = dict(
        check=dict(B=B_check, T=T, steps=n_check, loss_card=l_card,
                   loss_cpu=l_cpu, loss_max_rel_err=loss_err,
                   param_worst_rel_frobenius=worst[0],
                   param_worst_at=worst[1], attn_bk_max_abs=worst_bk,
                   card_s=card_s, cpu_s=cpu_s),
        timed=dict(B=B, T=T, **timed),
        mixed=dict(check=dict(B=B_check, T=T, steps=n_check,
                              loss_card=m_card, loss_cpu=m_cpu,
                              step0_rel_err=m_step0),
                   timed=dict(B=B, T=T, **mixed),
                   final_loss_gap_vs_fp32=gap))
    print(f"[training] card vs CPU {n_check} steps at [{B_check}, {T}]: loss "
          f"max rel err {loss_err:.3g}, worst param rel Frobenius "
          f"{worst[0]:.3g} ({worst[1]}), attn_bk max abs {worst_bk:.3g}; "
          f"{n_steps} steps at [{B}, {T}] on {device}: "
          f"{timed['ms_per_step']:.2f} ms/step, "
          f"{timed['tokens_per_s']:.0f} tokens/s, peak "
          f"{timed['peak_mem_gb']} GB, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, launches {timed['launches']}", flush=True)
    print(f"[training] mixed_bf16: step 0 card vs CPU rel err "
          f"{m_step0:.3g}; {n_steps} steps {mixed['ms_per_step']:.2f} "
          f"ms/step, {mixed['tokens_per_s']:.0f} tokens/s, peak "
          f"{mixed['peak_mem_gb']} GB, loss {mixed['loss_first']:.4f} -> "
          f"{mixed['loss_last']:.4f} (fp32 {losses[-1]:.4f}, gap "
          f"{gap:.4f}), launches by dtype {mixed['launches_by_dtype']}",
          flush=True)
    return {k: timed["launches"][k] + mixed["launches"][k]
            for k in timed["launches"]}


# ----------------------------------------- phase 6: sequence-parallel training
def _rel(got, want):
    """Relative Frobenius difference ||got - want|| / ||want||."""
    return float((got - want).norm() / want.norm())


def _leaf_grads(net, X, Y):
    """{"layer/name": gradient} of every leaf for one backward of the
    loss on (X, Y), as `fit` takes it; no update."""
    params = list(net.parameters())
    try:
        for p in params:
            p.requires_grad_(True)
        net._loss_fn(net._features(X), net._labels(Y)).backward()
        return {f"{i}/{n}": t.grad.detach().clone()
                for i, layer in enumerate(net.layers)
                for n, t in layer.jax_param_map().items()}
    finally:
        for p in params:
            p.requires_grad_(False)
            p.grad = None


def _ring_attention_grads(device, mesh, B, T, H, Dh):
    """{o, dq, dk, dv: relative Frobenius difference} of the causal
    flash ring over `mesh` against the local flash attention, on one
    seeded [B, T, H, Dh] batch and output gradient."""
    import torch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention)
    from deeplearning4j_tpu_torch.parallel import sequence_parallel_attention
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((B, T, H, Dh), generator=gen).to(device)
                   for _ in range(4))
    sides = []
    for fn in (lambda *a: sequence_parallel_attention(
                   *a, mesh, causal=True, use_flash=True),
               lambda *a: flash_attention(*a, True)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        sides.append([o.detach()] + [t.grad for t in leaves])
    return {n: _rel(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"),
                                             *sides)}


def phase_sequence_parallel(device, report, fails, cfg, B, n_check, n_steps):
    """(a) ring (and Ulysses) `output()` in the context against the same
    net's local `output()`; (b) n_check `fit` steps ring against local
    from identical params; (c) n_steps timed steps of each, the loss must
    fall; (d) the local arm's timed steps under mixed_bf16, held to (c)'s
    local arm. Returns the launch counts of the timed steps."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, make_mesh, sequence_sharding)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    P, T, L = SEQ_P, cfg["max_len"], cfg["n_layers"]
    mesh = make_mesh(MeshSpec.of(seq=P), devices=[device] * P)
    per_fwd = L * P * (P + 1) // 2      # causal: the diag + past chunks
    out = dict(B=B, T=T, P=P, T_local=T // P, layers=L,
               carry_launches_per_forward=per_fwd)

    # (a) scoring through the ring and Ulysses
    params = random_lm_params(cfg, seed=2468, head_scale=4.0)
    ids = np.random.default_rng(9).integers(0, cfg["vocab"], (B, T))
    errs = {}
    for sp in ("ring", "ulysses"):
        net = build_lm(cfg, device, params, sequence_parallel=sp)
        K.reset_launches()
        with sequence_sharding(mesh):
            got = net.output(ids)
        sync()
        launches = dict(K.LAUNCHES)
        want = net.output(ids)                # no context: the local path
        errs[sp] = (got - want).abs().max().item()
        fails.check(tuple(got.shape) == (B, T, cfg["vocab"])
                    and bool(torch.isfinite(got).all())
                    and errs[sp] <= OUTPUT_ATOL,
                    f"{sp} output() vs local: shape {tuple(got.shape)}, "
                    f"max_abs_err {errs[sp]} (tol {OUTPUT_ATOL})")
        if sp == "ring" and on_card:
            fails.check(launches["flash_attention_carry"] == per_fwd
                        and launches["flash_attention_fwd"] == 0,
                        f"ring output(): {launches} (want "
                        f"flash_attention_carry == {per_fwd})")
        out[f"{sp}_output"] = dict(max_abs_err_vs_local=errs[sp],
                                   launches=launches)
        del net, got, want

    # (b) ring against local training
    params = random_lm_params(cfg, seed=8642, head_scale=1.0)
    X, Y = lm_corpus(cfg, B * n_check, seed=7, T=T)
    ring = build_lm(cfg, device, params, sequence_parallel="ring",
                    lr=LONG_LR)
    local = build_lm(cfg, device, params, lr=LONG_LR)
    # the gradients first: the attention's alone, then the LM's leaves
    H = cfg["n_heads"]
    attn = _ring_attention_grads(device, mesh, B, T, H, cfg["d_model"] // H)
    fails.check(all(r <= ATTN_GRAD_RTOL for r in attn.values()),
                f"ring attention vs local flash attention at "
                f"{[B, T, H, cfg['d_model'] // H]}: relative Frobenius "
                f"{attn} (tol {ATTN_GRAD_RTOL})")
    with sequence_sharding(mesh):
        g_ring = _leaf_grads(ring, X[:B], Y[:B])
    g_local = _leaf_grads(local, X[:B], Y[:B])
    grad_rel = {k: _rel(g_ring[k], w) for k, w in g_local.items()
                if not k.endswith("/attn_bk")}
    worst_g = max(grad_rel.items(), key=lambda kv: kv[1])
    bad = {k: r for k, r in grad_rel.items() if not r <= GRAD_RTOL}
    fails.check(not bad, f"ring gradients vs local: relative Frobenius "
                f"over {GRAD_RTOL}: {bad}")
    del g_ring, g_local
    with sequence_sharding(mesh):
        l_ring = _fit_steps(ring, X, Y, B)
    l_local = _fit_steps(local, X, Y, B)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_ring, l_local))
    worst, worst_bk = param_diff(ring, local)
    bk_tol = 2 * n_check * adam_step_max(LONG_LR, n_check)
    fails.check(loss_err <= TRAIN_LOSS_RTOL and all(np.isfinite(l_ring)),
                f"ring training loss vs local rel err {loss_err} (tol "
                f"{TRAIN_LOSS_RTOL}): ring {l_ring}, local {l_local}")
    fails.check(worst[0] <= TRAIN_PARAM_RTOL and worst_bk <= bk_tol,
                f"ring training params vs local: worst rel Frobenius "
                f"{worst[0]} at {worst[1]} (tol {TRAIN_PARAM_RTOL}), "
                f"attn_bk max abs {worst_bk} (tol {bk_tol})")
    out["check"] = dict(attention_grad_rel_frobenius=attn,
                        grad_worst_rel_frobenius=worst_g[1],
                        grad_worst_at=worst_g[0],
                        steps=n_check, loss_ring=l_ring, loss_local=l_local,
                        loss_max_rel_err=loss_err,
                        param_worst_rel_frobenius=worst[0],
                        param_worst_at=worst[1], attn_bk_max_abs=worst_bk)
    del ring, local

    # (c) timed: ring, then local, each after one warm step; (d) the
    # local arm under mixed_bf16
    X, Y = lm_corpus(cfg, B * (n_steps + 1), seed=8, T=T)
    for arm in ("ring", "local", "local_mixed"):
        net = build_lm(cfg, device, params,
                       sequence_parallel="ring" if arm == "ring" else None,
                       lr=LONG_LR,
                       dtype_policy=MIXED if arm == "local_mixed" else None)
        out[arm] = _timed_fit(net, X, Y, B, sequence_sharding(mesh)
                              if arm == "ring" else None)
        if arm == "local_mixed":
            out["mixed_final_loss_gap_vs_local"] = _mixed_checks(
                fails, "local long-context", out[arm], out["local"], net,
                on_card)
        else:
            losses = out[arm]["losses"]
            fails.check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                        f"{arm} training loss did not fall: {losses[0]} -> "
                        f"{losses[-1]}")
        del net
    ring_launches = out["ring"]["launches"]
    if on_card:
        want = n_steps * per_fwd
        fails.check(all(ring_launches[k] == want for k in (
            "flash_attention_carry", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv"))
            and ring_launches["flash_attention_fwd"] == 0,
            f"ring training launches {ring_launches} (want {want} carry, "
            f"dQ and dK/dV launches)")
    report["sequence_parallel"] = out
    r, lo, mx = out["ring"], out["local"], out["local_mixed"]
    print(f"[sequence_parallel] seq={P} ring over [{B}, {T}] on {device}: "
          f"output() vs local {errs['ring']:.3g} (ulysses "
          f"{errs['ulysses']:.3g}); attention vs local "
          f"{', '.join(f'{k} {r:.3g}' for k, r in attn.items())}, worst "
          f"leaf gradient {worst_g[1]:.3g} ({worst_g[0]}); {n_check} "
          f"steps ring vs local loss "
          f"rel err {loss_err:.3g}, worst param {worst[0]:.3g} "
          f"({worst[1]}), attn_bk {worst_bk:.3g}; ring "
          f"{r['ms_per_step']:.2f} ms/step {r['tokens_per_s']:.0f} tok/s "
          f"peak {r['peak_mem_gb']} GB, local {lo['ms_per_step']:.2f} "
          f"ms/step {lo['tokens_per_s']:.0f} tok/s peak {lo['peak_mem_gb']} "
          f"GB; ring loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}, "
          f"launches {ring_launches}", flush=True)
    print(f"[sequence_parallel] local mixed_bf16 over [{B}, {T}]: "
          f"{mx['ms_per_step']:.2f} ms/step {mx['tokens_per_s']:.0f} tok/s "
          f"peak {mx['peak_mem_gb']} GB, loss {mx['loss_first']:.4f} -> "
          f"{mx['loss_last']:.4f} (fp32 local {lo['loss_first']:.4f} -> "
          f"{lo['loss_last']:.4f}), launches by dtype "
          f"{mx['launches_by_dtype']}", flush=True)
    return {k: sum(out[a]["launches"][k] for a in ("ring", "local",
                                                    "local_mixed"))
            for k in ring_launches}


# ---------------------------------------------------------- phase 7: bridge
BRIDGE = os.path.join(HERE, "tests", "fixtures", "bridge")
# (d): the JAX-written zip's next step, card against JAX: the loss to
# this absolute difference, and each leaf's float64 sum and sum of
# squares to this relative one; `attn_bk` (whose gradient is zero up to
# rounding, so each side takes its own Adam noise step) to the bound
# that two steps of at most `adam_step_max()` each allow
GOLDEN_LOSS_ATOL = 1e-4
GOLDEN_SUM_RTOL = 1e-4


def _trees_equal(a, b) -> bool:
    """Two nested {key: array} trees with the same keys and bit-equal
    arrays."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def _nondeterministic_kernels(device, cfg, B, T):
    """Each kernel of phase 7's fp32 path run twice on the same inputs at
    the path's shapes: the names of those whose two results differ."""
    import torch
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import fused_adam as fad
    from deeplearning4j_tpu_torch.kernels import layernorm as ln
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(device)
    D, H = cfg["d_model"], cfg["n_heads"]
    x, h, g, b = rnd(B * T, D), rnd(B * T, D), rnd(D), rnd(D)
    q, k, v, do = (rnd(B, T, H, D // H) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    bwd = (q, k, v, do, lse, fa.attention_delta(do, o), True)
    shapes = block_shapes(cfg)
    p0, g0, m0 = ([rnd(*s) * 0.05 for s in shapes] for _ in range(3))
    v0 = [rnd(*s).abs() * 1e-4 for s in shapes]

    def adam():
        p, m, v = ([t.clone() for t in ts] for ts in (p0, m0, v0))
        fad.adam_update_packed(Adam(1e-3), p, g0, m, v, 9)
        return p + m + v
    runs = {
        "layer_norm": lambda: ln.layer_norm_fwd(x, g, b),
        "residual_layer_norm": lambda: ln.residual_layer_norm_fwd(x, h, g,
                                                                  b),
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v, True),
        "flash_attention_bwd_dq": lambda: (fa.flash_attention_bwd_dq(*bwd),),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(*bwd),
        "fused_adam": adam,
    }
    return [name for name, fn in runs.items()
            if not all(torch.equal(a, c) for a, c in zip(fn(), fn()))]


def _round_trip(device, fails, tag, conf_text, params, X, Y, B, n_steps,
                tmp):
    """Build a net from `conf_text` (its `to_dict()` must equal the
    text's), load `params`, fit `n_steps` at B, write the zip and restore
    it on `device`; params, updater state and counters must be bit-equal.
    Returns (source, restored, row of numbers)."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.jax_params import (
        from_jax_params, to_jax_params, to_jax_updater_state)
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    conf = MultiLayerConfiguration.from_json(conf_text)
    fails.check(conf.to_dict() == json.loads(conf_text)
                and conf.to_json(indent=2) == conf_text,
                f"bridge {tag}: the configuration does not write back the "
                f"JAX text")
    src = from_jax_params(MultiLayerNetwork(conf, device=device), params)
    losses = _fit_steps(src, X[:B * n_steps], Y[:B * n_steps], B)
    path = os.path.join(tmp, f"{tag}.zip")
    t0 = time.perf_counter()
    ModelSerializer.write_model(src, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dst = ModelSerializer.restore_model(path, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state_equal = (_trees_equal(to_jax_params(dst), to_jax_params(src))
                   and _trees_equal(to_jax_updater_state(dst),
                                    to_jax_updater_state(src)))
    counts = ((dst.iteration_count, dst.epoch_count)
              == (src.iteration_count, src.epoch_count) == (n_steps,
                                                            n_steps))
    fails.check(state_equal and counts,
                f"bridge {tag}: restored params/m/v bit-equal {state_equal}"
                f", counters {(dst.iteration_count, dst.epoch_count)} vs "
                f"{(src.iteration_count, src.epoch_count)}")
    return src, dst, dict(zip_bytes=os.path.getsize(path), write_s=write_s,
                          restore_s=restore_s, losses_before=losses,
                          state_bit_equal=state_equal)


def _resume_pair(device, fails, tag, src, dst, X, Y, B, cfg):
    """The same steps on the source net and on the restored one: equal
    losses and params, bit for bit where the kernels are deterministic,
    else within TRAIN_LOSS_RTOL and GRAD_RTOL, naming the kernels that
    are not."""
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    la = _fit_steps(src, X, Y, B)
    lb = _fit_steps(dst, X, Y, B)
    pa, pb = to_jax_params(src), to_jax_params(dst)
    row = dict(losses_source=la, losses_restored=lb,
               bit_equal=la == lb and _trees_equal(pa, pb))
    if not row["bit_equal"]:
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        worst, worst_bk = param_diff(dst, src)
        bk_tol = 2 * len(la) * adam_step_max()
        row.update(loss_rel_err=loss_err, param_worst_rel=worst[0],
                   param_worst_at=worst[1], attn_bk_max_abs=worst_bk,
                   nondeterministic=_nondeterministic_kernels(
                       device, cfg, B, X.shape[1]))
        fails.check(loss_err <= TRAIN_LOSS_RTOL and worst[0] <= GRAD_RTOL
                    and worst_bk <= bk_tol,
                    f"bridge {tag}: resumed steps differ: loss rel err "
                    f"{loss_err}, worst param rel {worst}, attn_bk max abs "
                    f"{worst_bk} (tol {bk_tol}); kernels not deterministic: "
                    f"{row['nondeterministic']}")
    return row


def check_jax_fixture(device, fails):
    """(d) The JAX-written zip and golden (tests/fixtures/bridge) on
    `device`: `output()` on the stored ids within OUTPUT_ATOL of JAX's
    probabilities, greedy tokens equal, and one more `fit` step from
    JAX's Adam state: the loss within GOLDEN_LOSS_ATOL, each leaf's sum
    and sum of squares within GOLDEN_SUM_RTOL (attn_bk: the Adam-noise
    bound). Returns (row, launches of the net's calls)."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    g = np.load(os.path.join(BRIDGE, "lm_small_golden.npz"))
    net = ModelSerializer.restore_model(os.path.join(BRIDGE, "lm_small.zip"),
                                        device=device)
    K.reset_launches()
    err = (net.output(g["ids"]).cpu() - torch.from_numpy(g["probs"])
           ).abs().max().item()
    tokens = generate(net, g["prompts"], g["tokens"].shape[1],
                      temperature=0)
    V = net.layers[-1].n_out
    net.fit(g["step_x"], np.eye(V, dtype=np.float32)[g["step_y"]],
            batch_size=len(g["step_x"]), shuffle=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    loss_err = abs(net.score_value - float(g["loss"]))
    bk_step = 2 * adam_step_max()          # each side's step at most one
    worst, worst_bk = (0.0, ""), (0.0, "")
    for lk, lp in to_jax_params(net).items():
        for name, a in lp.items():
            a = a.astype(np.float64)
            s, ss = a.sum(), (a * a).sum()
            s0, ss0 = float(g[f"sum/{lk}/{name}"]), float(
                g[f"sumsq/{lk}/{name}"])
            if name == "attn_bk":
                # sum: n steps of bk_step; sum of squares: bk_step times
                # sum |a + a0| <= sqrt(n ss) + sqrt(n ss0)
                n = a.size
                r = max(abs(s - s0) / (n * bk_step), abs(ss - ss0) / (
                    bk_step * (np.sqrt(n * ss) + np.sqrt(n * ss0))))
                worst_bk = max(worst_bk, (float(r), f"{lk}/{name}"))
                continue
            r = max(abs(s - s0) / abs(s0), abs(ss - ss0) / abs(ss0))
            worst = max(worst, (float(r), f"{lk}/{name}"))
    tokens_equal = bool(np.array_equal(tokens, g["tokens"]))
    fails.check(err <= OUTPUT_ATOL, f"bridge JAX zip: output() max_abs_err "
                f"{err} vs JAX (tol {OUTPUT_ATOL})")
    fails.check(tokens_equal, f"bridge JAX zip: greedy tokens {tokens} vs "
                f"JAX {g['tokens']}")
    fails.check(net.iteration_count == int(g["iteration_count"])
                and loss_err <= GOLDEN_LOSS_ATOL,
                f"bridge JAX zip: next step loss {net.score_value} vs JAX "
                f"{float(g['loss'])} (tol {GOLDEN_LOSS_ATOL}), iteration "
                f"{net.iteration_count}")
    fails.check(worst[0] <= GOLDEN_SUM_RTOL and worst_bk[0] <= 1.0,
                f"bridge JAX zip: leaf sums after the step: worst rel "
                f"{worst} (tol {GOLDEN_SUM_RTOL}), attn_bk over its bound "
                f"{worst_bk}")
    return dict(output_max_abs_err=err, tokens_equal=tokens_equal,
                loss=net.score_value, loss_jax=float(g["loss"]),
                loss_abs_err=loss_err, leaf_sum_worst_rel=worst[0],
                leaf_sum_worst_at=worst[1], attn_bk_share_of_bound=worst_bk[0],
                greedy_margin_jax=float(g["margin"])), launches


def phase_bridge(device, report, fails, small=False):
    """The ModelSerializer bridge on `device`: (a) the net from the JAX
    `configuration.json` of the smoke LM (phase 3's config); (b) phase
    3's params, 3 `fit` steps, write, restore, bit-equal state,
    `output()` and greedy decoding, then 3 more steps on both; (c) the
    same from the mixed_bf16 configuration, bf16 kernels only; (d) the
    JAX-written zip against JAX's golden. Returns the launches of
    (b)-(d), each counted from zero just before it."""
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.zoo.transformer import (
        TransformerLM, generate)
    if small:
        cfg, B, n, T_out, n_prompts, n_tok = (
            dict(LM, n_layers=2, max_len=128), 2, 2, 40, 2, 8)
        lm = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                           n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                           ff_multiplier=cfg["ff"], max_len=cfg["max_len"])
        conf = lm.conf()
        text = conf.to_json(indent=2)
        conf.dtype_policy = MIXED
        text_mixed = conf.to_json(indent=2)
    else:
        cfg, B, n, T_out, n_prompts, n_tok = LM, 8, 3, 512, 4, 32
        with open(os.path.join(BRIDGE, "lm_config.json")) as f:
            text = f.read()
        with open(os.path.join(BRIDGE, "lm_config_mixed_bf16.json")) as f:
            text_mixed = f.read()
    params = random_lm_params(cfg, seed=1234, head_scale=4.0)
    X, Y = lm_corpus(cfg, 2 * B * n, seed=12)
    launches = {k: 0 for k in KERNEL_META}

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)
    rows = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        # (a) + (b)
        K.reset_launches()
        src, dst, row = _round_trip(device, fails, "fp32", text, params, X,
                                    Y, B, n, tmp)
        rng = np.random.default_rng(13)
        ids = rng.integers(0, cfg["vocab"], (16 if not small else 2, T_out))
        out_equal = bool(torch.equal(src.output(ids), dst.output(ids)))
        prompts = rng.integers(0, cfg["vocab"], (n_prompts, 64 if not small
                                                 else 12))
        tok_equal = bool(np.array_equal(
            generate(src, prompts, n_tok, temperature=0),
            generate(dst, prompts, n_tok, temperature=0)))
        fails.check(out_equal, "bridge fp32: output() of the restored net "
                    "is not bit-equal")
        fails.check(tok_equal, "bridge fp32: greedy tokens of the restored "
                    "net differ")
        row.update(output_bit_equal=out_equal, greedy_tokens_equal=tok_equal,
                   resume=_resume_pair(device, fails, "fp32", src, dst,
                                       X[B * n:], Y[B * n:], B, cfg))
        if device.type == "cuda":
            torch.cuda.synchronize()
        add(K.LAUNCHES)
        rows["fp32"] = row
        del src, dst
        # (c) mixed_bf16
        K.reset_launches()
        src, dst, row = _round_trip(device, fails, "mixed_bf16", text_mixed,
                                    params, X, Y, B, n, tmp)
        fails.check(src.dtype.name == dst.dtype.name == MIXED,
                    f"bridge mixed: policies {src.dtype.name}, "
                    f"{dst.dtype.name}")
        row["resume"] = _resume_pair(device, fails, "mixed_bf16", src, dst,
                                     X[B * n:], Y[B * n:], B, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize()
        by_dtype = dict(sorted(K.LAUNCHES_BY_DTYPE.items()))
        add(K.LAUNCHES)
        fails.check(_master_is_fp32(src) and _master_is_fp32(dst),
                    "bridge mixed: params or Adam state left fp32")
        if device.type == "cuda":
            missing = [k for k in MIXED_KERNELS
                       if not by_dtype.get(f"{k}/bfloat16")]
            f32 = {k: v for k, v in by_dtype.items()
                   if k.endswith("/float32")}
            fails.check(not missing and not f32,
                        f"bridge mixed: launches {by_dtype}: bf16 instances "
                        f"missing {missing}, fp32 launched {f32}")
        row["launches_by_dtype"] = by_dtype
        rows["mixed_bf16"] = row
        del src, dst
    # (d) the JAX-written zip
    rows["jax_zip"], counts = check_jax_fixture(device, fails)
    add(counts)
    report["bridge"] = dict(B=B, T=X.shape[1], steps=n, **rows,
                            launches=launches)
    for tag in ("fp32", "mixed_bf16"):
        r = rows[tag]
        print(f"[bridge] {tag}: zip {r['zip_bytes']} bytes, write "
              f"{r['write_s']:.3f} s, restore {r['restore_s']:.3f} s on "
              f"{device}; state bit-equal {r['state_bit_equal']}, resumed "
              f"steps bit-equal {r['resume']['bit_equal']} (losses "
              f"{r['resume']['losses_source']} vs "
              f"{r['resume']['losses_restored']})", flush=True)
    r = rows["fp32"]
    print(f"[bridge] fp32: output() bit-equal {r['output_bit_equal']}, "
          f"greedy tokens equal {r['greedy_tokens_equal']}; mixed launches "
          f"by dtype {rows['mixed_bf16']['launches_by_dtype']}", flush=True)
    d = rows["jax_zip"]
    print(f"[bridge] JAX zip: output() max_abs_err {d['output_max_abs_err']:.3g}"
          f", tokens equal {d['tokens_equal']}, next step loss "
          f"{d['loss']:.6f} vs JAX {d['loss_jax']:.6f}, leaf sums worst rel "
          f"{d['leaf_sum_worst_rel']:.3g} ({d['leaf_sum_worst_at']}), "
          f"attn_bk {d['attn_bk_share_of_bound']:.3g} of its bound; "
          f"launches {launches}", flush=True)
    return launches


# ------------------------------------------- phase 8: serving features
# mixed_bf16 decoding against the fp32 net, by teacher forcing: a logit
# of the smoke LM (|logit| < 32, head scaled by 4) rounded to bf16 moves
# by up to 2^-4, a probability by up to p(1-p) times the accumulated
# logit error; the stated bound is 2^-3
MIXED_DECODE_ATOL = 2.0 ** -3
INT8_TOP1_MIN = 0.95
SPEC_K = 4


def _serve(net, reqs, n_tok, warm_len, **kw):
    """One warmed server over `reqs` ([(prompt, {generate_async
    kwargs})]): (token lists, wall seconds, launches by kernel and by
    dtype of the run, the engine). The launch counts start at 0 just
    before the requests are submitted."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.serving import GenerationServer
    max_len = net.layers[1].max_len
    bl = 16
    n_slots = kw.pop("n_slots", 8)
    prefixes = kw.pop("prefixes", ())
    srv = GenerationServer(net, n_slots=n_slots, block_len=bl,
                           n_blocks=n_slots * (max_len // bl) + 1,
                           device=net.device, **kw)
    for p in prefixes:
        srv.register_prefix(p)
    srv.warmup(warm_len, 4)
    K.reset_launches()
    srv.start()
    try:
        t0 = time.perf_counter()
        streams = [srv.generate_async(p, n_tok, **a) for p, a in reqs]
        out = [s.result(timeout=600).tolist() for s in streams]
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    return (out, wall, dict(K.LAUNCHES),
            dict(sorted(K.LAUNCHES_BY_DTYPE.items())), srv.engine)


def _wide_vs_single(net, prompts, K=SPEC_K, **kw):
    """The largest probability difference between one K-wide score and K
    single-token decodes on the same pool, in an engine of `kw`'s
    configuration over `prompts` (the batch-variance of this card's
    matmuls at the serving shapes)."""
    import torch
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    max_len = net.layers[1].max_len
    eng = PagedDecodeEngine(net, n_slots=len(prompts), block_len=16,
                            n_blocks=len(prompts) * (max_len // 16) + 1,
                            device=net.device, **kw)
    eng.admit_many([dict(prompt_ids=p, n_tokens=K + 1) for p in prompts])
    S = eng.n_slots
    rng = np.random.default_rng(3)
    token_mat = np.concatenate(
        [eng.last_token[:, None], rng.integers(0, eng.vocab, (S, K - 1))], 1)
    n_valid = np.full(S, K)
    eng._grow_block_tables({s: K for s in range(S)})
    saved = [(k.clone(), v.clone()) for k, v in eng.pool.kv]
    with torch.no_grad(), eng._weights():
        wide = eng._score(token_mat, eng.pos, n_valid)
        for (k, v), (k0, v0) in zip(eng.pool.kv, saved):
            k.copy_(k0)
            v.copy_(v0)
        pos = torch.as_tensor(eng.pos, device=net.device)
        bt = torch.as_tensor(eng.block_tables, device=net.device)
        single = torch.stack([eng._walk(
            eng._plan, torch.as_tensor(token_mat[:, j], device=net.device),
            pos + j, bt) for j in range(K)], dim=1)
    return float((wide - single).abs().max())


def _agreement(net, prompts, want, got, eps, quantize=None):
    """Greedy streams by margin (`zoo.transformer.stream_agreement`):
    (indices that disagree, near-ties of the references)."""
    from deeplearning4j_tpu_torch.zoo.transformer import (
        stream_agreement, teacher_forced_probs)
    bad, ties = [], 0
    for i, (p, w, g) in enumerate(zip(prompts, want, got)):
        r = stream_agreement(w, g, teacher_forced_probs(
            net, p, w, quantize=quantize), eps)
        ties += r["near_ties"]
        if not r["ok"]:
            bad.append(i)
    return bad, ties


def tf(net, prompt, tokens, quantize=None):
    """The decode path's teacher-forced probabilities (numpy)."""
    from deeplearning4j_tpu_torch.zoo.transformer import teacher_forced_probs
    return teacher_forced_probs(net, prompt, tokens, quantize=quantize)


def _generate_each(net, prompts, n_tok, **kw):
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    return [generate(net, np.asarray(p)[None], n_tok, temperature=0,
                     **kw)[0].tolist() for p in prompts]


def phase_serving_features(device, report, fails, cfg, small=False):
    """Phase 8 on `device`, phase 3's LM and params: (1) `mixed_bf16`
    serving, (2) int8 weights, (3) speculative decoding (n-gram on cyclic
    prompts, the truncated drafter on random ones, sampled), (4) shared
    prefixes, registered and radix, each beside its vanilla fp32 run in
    this call. Returns the launches of the served runs."""
    from deeplearning4j_tpu_torch.nd import quant
    params = random_lm_params(cfg, seed=1234, head_scale=4.0)
    net = build_lm(cfg, device, params)
    mixed = build_lm(cfg, device, params, dtype_policy=MIXED)
    V = cfg["vocab"]
    # phase 4's traffic: its 24 greedy prompts (seed 11, lengths
    # 16-300), 64 tokens each
    n_req, n_tok, n_extra, lo_hi = ((6, 8, 2, (3, 60)) if small
                                    else (24, 64, 4, (16, 300)))
    n_slots = 4 if small else 8
    rng = np.random.default_rng(11)
    lens = rng.integers(lo_hi[0], lo_hi[1] + 1, n_req + n_extra)
    prompts = [rng.integers(0, V, n) for n in lens][:n_req]
    lens = lens[:n_req]
    greedy = [(p, {}) for p in prompts]
    rng = np.random.default_rng(808)
    warm = int(max(lens))
    rows, launches = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def serve(n, reqs, name, **kw):
        out, wall, counts, by_dtype, eng = _serve(
            n, reqs, n_tok, kw.pop("warm_len", warm), n_slots=n_slots, **kw)
        add(counts)
        tok = sum(len(t) for t in out)
        row = dict(tokens=tok, wall_s=wall, tokens_per_s=tok / wall,
                   launches=counts, launches_by_dtype=by_dtype)
        rows[name] = row
        return out, row, eng

    # the vanilla fp32 runs of the three traffic sets
    van, van_row, _ = serve(net, greedy, "vanilla_fp32")
    eps32 = _wide_vs_single(net, prompts[:n_slots])
    bad, ties = _agreement(net, prompts, _generate_each(net, prompts, n_tok),
                           van, eps32)
    fails.check(not bad, f"serving_features vanilla: streams {bad} differ "
                         f"from generate()")
    van_row.update(eps=eps32, near_ties=ties)

    # (1) mixed_bf16
    ref = _generate_each(mixed, prompts, n_tok)
    got, row, eng = serve(mixed, greedy, "mixed_bf16")
    eps = _wide_vs_single(mixed, prompts[:n_slots])
    bad, ties = _agreement(mixed, prompts, ref, got, eps)
    err = max(float(np.abs(tf(mixed, p, w) - tf(net, p, w)).max())
              for p, w in zip(prompts, ref))
    f32 = {k: v for k, v in row["launches_by_dtype"].items()
           if k.endswith("/float32")}
    fails.check(not bad, f"serving_features mixed: streams {bad} differ "
                         f"from mixed generate()")
    fails.check(err <= MIXED_DECODE_ATOL,
                f"serving_features mixed: teacher-forced probs "
                f"{err} from fp32 (tol {MIXED_DECODE_ATOL})")
    if device.type == "cuda":
        fails.check(row["launches_by_dtype"].get("layer_norm/bfloat16", 0)
                    > 0 and not f32,
                    f"serving_features mixed: launches by dtype "
                    f"{row['launches_by_dtype']}")
    fp32_pool = 2 * eng.pool.nbytes
    row.update(eps=eps, near_ties=ties, probs_max_err_vs_fp32=err,
               pool_bytes=eng.pool.nbytes, pool_bytes_fp32=fp32_pool,
               pool_dtype=str(eng.pool.kv[0][0].dtype),
               speedup_vs_vanilla=row["tokens_per_s"]
               / van_row["tokens_per_s"])
    fails.check(eng.pool.kv[0][0].dtype == mixed.dtype.compute_dtype,
                "serving_features mixed: pool not bf16")

    # (2) int8 weights
    q = quant.serving_params(net, "int8")
    fp = quant.serving_params(net, None)
    mm = quant.quantized_weight_keys(net)
    mm_bytes = [quant.weight_bytes({lk: {k: t.params[lk][k] for k in ks}
                                    for lk, ks in mm.items()})
                for t in (q, fp)]
    ref = _generate_each(net, prompts, n_tok, quantize="int8")
    got, row, _ = serve(net, greedy, "int8", quantize="int8")
    eps = _wide_vs_single(net, prompts[:n_slots], quantize="int8")
    bad, ties = _agreement(net, prompts, ref, got, eps, quantize="int8")
    agree = errs = 0.0
    n_pos = 0
    for p, w in zip(prompts, van):
        a, b = tf(net, p, w, quantize="int8"), tf(net, p, w)
        agree += float((a.argmax(-1) == b.argmax(-1)).sum())
        n_pos += len(w)
        errs = max(errs, float(np.abs(a - b).max()))
    top1 = agree / n_pos
    fails.check(not bad, f"serving_features int8: streams {bad} differ "
                         f"from int8 generate()")
    fails.check(top1 >= INT8_TOP1_MIN, f"serving_features int8: top-1 "
                                       f"agreement {top1} with fp32")
    row.update(eps=eps, near_ties=ties, weight_bytes=quant.weight_bytes(
        q.params), weight_bytes_fp32=quant.weight_bytes(fp.params),
        matmul_weight_bytes=mm_bytes[0], matmul_weight_bytes_fp32=mm_bytes[1],
        top1_agreement_vs_fp32=top1, probs_max_err_vs_fp32=errs,
        speedup_vs_vanilla=row["tokens_per_s"] / van_row["tokens_per_s"])

    # (3) speculative decoding, k = SPEC_K, drafting kept on (floor 0)
    X, _ = lm_corpus(cfg, n_req, seed=8, T=int(max(lens)))
    cyc = [X[i, :n].astype(np.int64) for i, n in enumerate(lens)]
    cyc_van, cyc_row, _ = serve(net, [(p, {}) for p in cyc], "vanilla_cyclic")
    spec_kw = dict(speculative=SPEC_K, spec_accept_floor=0.0)
    for name, reqs, base, base_row, kw in (
            ("spec_ngram", [(p, {}) for p in cyc], cyc_van, cyc_row, {}),
            ("spec_truncated", greedy, van, van_row,
             dict(spec_draft_layers=cfg["n_layers"] // 2))):
        got, row, eng = serve(net, reqs, name, **spec_kw, **kw)
        ps = [p for p, _ in reqs]
        bad, ties = _agreement(net, ps, base, got, eps32)
        fails.check(not bad, f"serving_features {name}: streams {bad} "
                             f"differ from the non-speculative engine's")
        row.update(near_ties=ties, eps=eps32,
                   accept_rate=(eng.spec_accepted_total
                                / max(1, eng.spec_proposed_total)),
                   proposed=eng.spec_proposed_total,
                   accepted=eng.spec_accepted_total,
                   proposed_by=dict(eng.spec_proposed_by),
                   accepted_by=dict(eng.spec_accepted_by),
                   tokens_per_dispatch=(eng.spec_emitted_total
                                        / max(1, eng.spec_dispatches_total)),
                   draft_dispatches=eng.spec_draft_dispatches_total,
                   speedup_vs_vanilla=row["tokens_per_s"]
                   / base_row["tokens_per_s"])
        fails.check(eng.spec_dispatches_total > 0,
                    f"serving_features {name}: no speculative dispatch")
    sampled = [(p, dict(temperature=0.8, top_p=0.9, rng=700 + i))
               for i, p in enumerate(prompts)]
    _, s_van_row, _ = serve(net, sampled, "vanilla_sampled")
    got, row, eng = serve(net, sampled, "spec_sampled", spec_sampled=True,
                          **spec_kw)
    fails.check(all(len(t) == n_tok and 0 <= min(t) and max(t) < V
                    for t in got),
                "serving_features spec_sampled: streams out of vocab or of "
                "the wrong length")
    cpu = cpu_twin(net)
    cpu_got = engine_streams(cpu, sampled, n_tok, speculative=SPEC_K,
                             spec_sampled=True)
    s_prompts = [p for p, _ in sampled]
    keys = [a["rng"] for _, a in sampled]
    bad, ties, eps_s = sampled_margin(
        cpu, net, s_prompts, cpu_got, got,
        lambda i, n: engine_noise(keys[i], n, V), 0.8, 0.9, spec_keys=keys)
    fails.check(not bad, f"serving_features spec_sampled card vs CPU apart "
                f"beyond a near-tie: {bad} (eps {eps_s})")
    row.update(card_vs_cpu_apart=bad, near_ties=ties, eps=eps_s,
               equal_to_cpu=sum(a == b for a, b in zip(got, cpu_got)))
    row.update(accept_rate=(eng.spec_accepted_total
                            / max(1, eng.spec_proposed_total)),
               proposed=eng.spec_proposed_total,
               tokens_per_dispatch=(eng.spec_emitted_total
                                    / max(1, eng.spec_dispatches_total)),
               speedup_vs_vanilla=row["tokens_per_s"]
               / s_van_row["tokens_per_s"])

    # (4) shared prefixes: one long system prompt, distinct suffixes
    n_pre = 16 if small else 256
    prefix = rng.integers(0, V, n_pre)
    sfx = rng.integers(8, 41, n_slots * 2)
    pre_prompts = [np.concatenate([prefix, rng.integers(0, V, n)])
                   for n in sfx]
    pre_reqs = [(p, {}) for p in pre_prompts]
    pwarm = int(max(len(p) for p in pre_prompts))
    private, p_row, _ = serve(net, pre_reqs, "vanilla_prefix",
                              warm_len=pwarm)
    for name, kw in (("prefix_registered", dict(prefixes=[prefix])),
                     ("prefix_radix", dict(prefix_cache="radix"))):
        got, row, eng = serve(net, pre_reqs, name, warm_len=pwarm, **kw)
        bad, ties = _agreement(net, pre_prompts, private, got, eps32)
        fails.check(not bad, f"serving_features {name}: streams {bad} "
                             f"differ from the private ones")
        fails.check(eng.prefix_hits_total > 0,
                    f"serving_features {name}: no prefix hit")
        row.update(near_ties=ties, eps=eps32, hits=eng.prefix_hits_total,
                   tokens_saved=eng.prefix_tokens_saved_total,
                   blocks_saved=eng.prefix_tokens_saved_total // 16,
                   forks=eng.prefix_forks_total,
                   radix_hit_tokens=eng.radix_hit_tokens_total,
                   radix_evictions=eng.radix_evictions_total,
                   speedup_vs_vanilla=row["tokens_per_s"]
                   / p_row["tokens_per_s"])
    report["serving_features"] = dict(
        n_slots=n_slots, block_len=16, requests=n_req, n_tokens=n_tok,
        prefix_len=n_pre, spec_k=SPEC_K, arms=rows, launches=launches)
    for name, r in rows.items():
        extra = {k: v for k, v in r.items()
                 if k not in ("launches", "launches_by_dtype", "tokens",
                              "wall_s")}
        print(f"[serving_features] {name} on {device}: {r['tokens']} tokens "
              f"in {r['wall_s']:.3f} s; {json.dumps(extra, default=str)}",
              flush=True)
    print(f"[serving_features] mixed_bf16 launches by dtype "
          f"{rows['mixed_bf16']['launches_by_dtype']}; phase launches "
          f"{launches}", flush=True)
    return launches



# ------------------------------------------------ phase 9: regularized
# the classifier of arm (d): the smoke LM's width, 8 classes
CLS = dict(LM, classes=8)
# (d) held-out examples for evaluate() and evaluate_roc_multi_class()
N_EVAL = 256
# Adam's rate for the classifier: at the zoo's 1e-3 its loss jumps after
# the first step in both packages (measured on a CPU at vocab 64, d_model
# 256, 2 blocks, [16, 63]: the port 3.31 -> 14.66, the JAX package 4.02
# -> 7.83, with or without dropout); at full width on a CPU over (d)'s
# 21 batches, 3e-4 climbs to 13.3, 1e-4 wanders between 2.5 and 5.6, and
# 3e-5 falls from 5.31 to 2.09. Its single-batch losses are noisy (the
# batches' lengths differ), so (d) holds the mean of the last 5 timed
# steps below the mean of the first 5
CLS_LR = 3e-5
CLS_LOSS_WINDOW = 5
# the fields of arm (a) (the blocks' residual dropout, l2 on every layer,
# elementwise clipping: every run still packs) and of arm (b) (per-layer
# clipping and max_norm keep JAX from packing, so fused Adam must not
# launch; DropConnect, attention dropout, a max-norm constraint on the
# output layer, and Gaussian noise on its input, whose normal draw takes
# the threefry words kernel)
ARM_A = dict(dropout=0.9, l2=1e-4, gn="clip_elementwise_absolute_value",
             gn_threshold=1.0)
ARM_B = dict(gn="clip_l2_per_layer", gn_threshold=1.0, max_norm=1.0,
             out_constraint=1.0, drop_connect=0.95, attention_dropout=0.9,
             out_noise=0.05)
# the kernels a regularized LM step must launch, each more than once
REG_LM_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
                  "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                  "fused_adam", "dropout")


def regularize(net, *, dropout=None, l2=None, gn=None, gn_threshold=1.0,
               max_norm=None, out_constraint=None, drop_connect=None,
               attention_dropout=None, out_noise=None):
    """Set training fields on a built net, as a configuration would:
    `Dropout(dropout)`, `DropConnect(drop_connect)` and
    `attention_dropout` on every transformer block, `l2` on every layer
    with params, the gradient normalization and `max_norm` on the
    configuration, a `MaxNormConstraint(out_constraint)` on the output
    layer and `GaussianNoise(out_noise)` on its input."""
    from deeplearning4j_tpu_torch.nn.conf.constraints import (
        MaxNormConstraint)
    from deeplearning4j_tpu_torch.nn.conf.dropout import (
        Dropout, GaussianNoise)
    from deeplearning4j_tpu_torch.nn.conf.weightnoise import DropConnect
    from deeplearning4j_tpu_torch.nn.layers import TransformerEncoderBlock
    for layer in net.layers:
        if isinstance(layer, TransformerEncoderBlock):
            if dropout is not None:
                layer.dropout = Dropout(dropout)
            if drop_connect is not None:
                layer.weight_noise = DropConnect(drop_connect)
            if attention_dropout is not None:
                layer.attention_dropout = attention_dropout
        if l2 is not None and layer.jax_param_map():
            layer.l2 = l2
    if gn is not None:
        net.conf.gradient_normalization = gn
        net.conf.gradient_normalization_threshold = gn_threshold
    if max_norm is not None:
        net.conf.max_norm = max_norm
    out = net.layers[-1]
    if out_constraint is not None:
        out.constraints = [MaxNormConstraint(out_constraint)]
    if out_noise is not None:
        out.dropout = GaussianNoise(out_noise)
    return net


def _card_vs_cpu(fails, what, card, cpu, l_card, l_cpu, n_check, mixed):
    """Phase 5's gates: fp32, the loss per step within TRAIN_LOSS_RTOL and
    every param within TRAIN_PARAM_RTOL (attn_bk to Adam's step bound);
    mixed_bf16, step 0's loss within MIXED_STEP0_RTOL."""
    if mixed:
        err = abs(l_card[0] - l_cpu[0]) / abs(l_cpu[0])
        fails.check(err <= MIXED_STEP0_RTOL and all(np.isfinite(l_card)),
                    f"{what} mixed_bf16 step 0 loss card vs CPU rel err "
                    f"{err} (tol {MIXED_STEP0_RTOL}): card {l_card}, CPU "
                    f"{l_cpu}")
        return dict(loss_card=l_card, loss_cpu=l_cpu, step0_rel_err=err)
    err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    fails.check(err <= TRAIN_LOSS_RTOL and all(np.isfinite(l_card)),
                f"{what} loss card vs CPU rel err {err} (tol "
                f"{TRAIN_LOSS_RTOL}): card {l_card}, CPU {l_cpu}")
    worst, worst_bk = param_diff(card, cpu)
    bk_tol = 2 * n_check * adam_step_max()
    fails.check(worst[0] <= TRAIN_PARAM_RTOL and worst_bk <= bk_tol,
                f"{what} params card vs CPU: worst rel Frobenius "
                f"{worst[0]} at {worst[1]} (tol {TRAIN_PARAM_RTOL}), "
                f"attn_bk max abs {worst_bk} (tol {bk_tol})")
    return dict(loss_card=l_card, loss_cpu=l_cpu, loss_max_rel_err=err,
                param_worst_rel_frobenius=worst[0], param_worst_at=worst[1],
                attn_bk_max_abs=worst_bk)


def _launched(fails, what, launches, kernels, absent=()):
    """Every kernel of `kernels` launched, none of `absent`."""
    fails.check(all(launches.get(k, 0) > 0 for k in kernels)
                and not any(launches.get(k, 0) for k in absent),
                f"{what} launches {launches}: want {list(kernels)} > 0 and "
                f"{list(absent)} == 0")


def _falls(fails, what, losses, window=1):
    """The mean of the last `window` losses below the mean of the first
    `window`, every loss finite."""
    first, last = np.mean(losses[:window]), np.mean(losses[-window:])
    fails.check(all(np.isfinite(losses)) and last < first,
                f"{what} loss did not fall: {first} -> {last} (means of "
                f"{window}: {losses})")


def _reg_arm_a(device, fails, cfg, B_check, n_check, B, n_steps, on_card):
    """(a) the smoke LM with ARM_A's fields, fp32 and mixed_bf16: card
    against CPU over n_check steps from identical params and keys, then
    n_steps timed steps beside the undropped twin."""
    params = random_lm_params(cfg, seed=1357, head_scale=1.0)
    X, Y = lm_corpus(cfg, B_check * n_check, seed=11)
    out, launches = {}, {}
    for tag, policy in (("fp32", None), ("mixed", MIXED)):
        card = regularize(build_lm(cfg, device, params, dtype_policy=policy),
                          **ARM_A)
        cpu = regularize(build_lm(cfg, "cpu", params, dtype_policy=policy),
                         **ARM_A)
        l_card = _fit_steps(card, X, Y, B_check)
        l_cpu = _fit_steps(cpu, X, Y, B_check)
        out[f"{tag}_check"] = _card_vs_cpu(
            fails, f"regularized LM {tag}", card, cpu, l_card, l_cpu,
            n_check, policy is not None)
        del card, cpu
    Xt, Yt = lm_corpus(cfg, B * (n_steps + 1), seed=12)
    for tag, policy in (("fp32", None), ("mixed", MIXED)):
        out[f"{tag}_twin"] = _timed_fit(build_lm(cfg, device, params,
                                                 dtype_policy=policy),
                                        Xt, Yt, B)
        net = regularize(build_lm(cfg, device, params, dtype_policy=policy),
                         **ARM_A)
        out[f"{tag}_timed"] = t = _timed_fit(net, Xt, Yt, B)
        _falls(fails, f"regularized LM {tag}", t["losses"])
        if on_card:
            _launched(fails, f"regularized LM {tag}", t["launches"],
                      REG_LM_KERNELS)
        if policy is not None:
            out["mixed_final_loss_gap_vs_fp32"] = _mixed_checks(
                fails, "regularized LM", t, out["fp32_timed"], net, on_card)
        launches = {k: launches.get(k, 0) + n
                    for k, n in t["launches"].items()}
        del net
    return out, launches


def _reg_arm_b(device, fails, cfg, B_check, n_check, on_card):
    """(b) ARM_B's per-leaf fields: no packed run, so no fused Adam; the
    plain masked-softmax attention carries the attention dropout (no
    flash launch); card against CPU over n_check steps."""
    from deeplearning4j_tpu_torch import kernels as K
    params = random_lm_params(cfg, seed=9753, head_scale=1.0)
    X, Y = lm_corpus(cfg, B_check * n_check, seed=13)
    card = regularize(build_lm(cfg, device, params), **ARM_B)
    cpu = regularize(build_lm(cfg, "cpu", params), **ARM_B)
    runs = card._packed_runs()
    fails.check(runs == [], f"per-leaf arm packs runs {runs}")
    K.reset_launches()
    t0 = time.perf_counter()
    l_card = _fit_steps(card, X, Y, B_check)
    card_ms = (time.perf_counter() - t0) / n_check * 1e3
    launches = dict(K.LAUNCHES)
    l_cpu = _fit_steps(cpu, X, Y, B_check)
    out = _card_vs_cpu(fails, "per-leaf arm", card, cpu, l_card, l_cpu,
                       n_check, False)
    if on_card:
        _launched(fails, "per-leaf arm", launches,
                  ("layer_norm", "residual_layer_norm", "dropout",
                   "threefry_bits"),
                  absent=("fused_adam", "flash_attention_fwd",
                          "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv"))
    out.update(B=B_check, T=X.shape[1], ms_per_step=card_ms,
               launches=launches, packed_runs=runs)
    return out, launches


def _reg_arm_c(device, fails, cfg, B, n_check, n_steps, on_card):
    """(c) the long-context LM under mixed_bf16: Dropout(0.9) on the
    blocks, n_steps timed beside the undropped twin; then ring and
    Ulysses (the 4-way seq mesh on the one card) against the local path,
    n_check steps each from identical params, and `output()` in the
    context."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, make_mesh, sequence_sharding)
    T = cfg["max_len"]
    params = random_lm_params(cfg, seed=8642, head_scale=1.0)
    Xt, Yt = lm_corpus(cfg, B * (n_steps + 1), seed=14, T=T)
    out, launches = {}, {}
    for arm, drop in (("twin", None), ("dropout", 0.9)):
        net = regularize(build_lm(cfg, device, params, lr=LONG_LR,
                                  dtype_policy=MIXED), dropout=drop)
        out[arm] = t = _timed_fit(net, Xt, Yt, B)
        _falls(fails, f"long-context mixed {arm}", t["losses"])
        if on_card and drop is not None:
            got = t["launches_by_dtype"]
            want = [f"{k}/bfloat16" for k in MIXED_KERNELS + ("dropout",)]
            fails.check(all(got.get(k) for k in want)
                        and not any(k.endswith("/float32") for k in got),
                        f"long-context mixed dropout launches {got}: want "
                        f"{want} and no fp32 instance")
        launches = {k: launches.get(k, 0) + n
                    for k, n in t["launches"].items()}
        del net
    mesh = make_mesh(MeshSpec.of(seq=SEQ_P), devices=[device] * SEQ_P)
    X, Y = lm_corpus(cfg, B * n_check, seed=15, T=T)
    ids = X[:B].astype(np.int64)
    local = build_lm(cfg, device, params, lr=LONG_LR, dtype_policy=MIXED)
    want_out = local.output(ids)
    l_local = _fit_steps(local, X, Y, B)
    out["local_losses"] = l_local
    del local
    for sp in ("ring", "ulysses"):
        net = build_lm(cfg, device, params, sequence_parallel=sp,
                       lr=LONG_LR, dtype_policy=MIXED)
        K.reset_launches()
        with sequence_sharding(mesh):
            got_out = net.output(ids)
            l_sp = _fit_steps(net, X, Y, B)
        sp_launches = dict(K.LAUNCHES)
        by_dtype = dict(sorted(K.LAUNCHES_BY_DTYPE.items()))
        err = (got_out - want_out).abs().max().item()
        step0 = abs(l_sp[0] - l_local[0]) / l_local[0]
        gap = max(abs(a - b) for a, b in zip(l_sp, l_local))
        fails.check(err <= MIXED_DECODE_ATOL
                    and bool(torch.isfinite(got_out).all()),
                    f"{sp} mixed output() vs local mixed max_abs_err {err} "
                    f"(tol {MIXED_DECODE_ATOL})")
        fails.check(step0 <= MIXED_STEP0_RTOL
                    and gap <= MIXED_BAND * l_local[0],
                    f"{sp} mixed training vs local mixed: step 0 rel err "
                    f"{step0} (tol {MIXED_STEP0_RTOL}), largest gap {gap} "
                    f"(tol {MIXED_BAND} x {l_local[0]}): {l_sp} vs "
                    f"{l_local}")
        fails.check(_master_is_fp32(net), f"{sp} mixed: master not fp32")
        if on_card and sp == "ring":
            fails.check(by_dtype.get("flash_attention_carry/bfloat16", 0) > 0
                        and not by_dtype.get("flash_attention_carry/float32"),
                        f"ring mixed launches by dtype {by_dtype}")
        out[sp] = dict(output_max_abs_err_vs_local=err, losses=l_sp,
                       step0_rel_err=step0, largest_loss_gap=gap,
                       launches_by_dtype=by_dtype)
        launches = {k: launches.get(k, 0) + n
                    for k, n in sp_launches.items()}
        del net
    return out, launches


def classifier_data(cfg, n, seed, T=None):
    """Padded token windows for the classifier: n sequences of seeded
    lengths 16..T (T = max_len - 1), 0 past each length, the features
    mask, and one-hot labels by a rule the model can learn: a class-c
    sequence draws each token from class c's band of the vocabulary with
    probability 0.7, else from the whole vocabulary."""
    rng = np.random.default_rng(seed)
    V, C = cfg["vocab"], cfg["classes"]
    T = T or cfg["max_len"] - 1
    lengths = rng.integers(min(16, T), T + 1, n)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    cls = rng.integers(0, C, n)
    band = (V - 1) // C
    own = 1 + cls[:, None] * band + rng.integers(0, band, (n, T))
    ids = np.where(rng.random((n, T)) < 0.7, own,
                   rng.integers(1, V, (n, T))) * mask
    return (ids.astype(np.float32), mask,
            np.eye(C, dtype=np.float32)[cls])


def build_classifier(cfg, device, seed=77):
    """The zoo TransformerClassifier (dropout 0.9, AVG pooling) with
    weights from a CPU generator seeded with `seed` and Adam(CLS_LR)."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.zoo.transformer import (
        TransformerClassifier)
    net = TransformerClassifier(
        cfg["vocab"], cfg["classes"], d_model=cfg["d_model"],
        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        ff_multiplier=cfg["ff"], max_len=cfg["max_len"], dropout=0.9,
        pooling="avg").init(seed, device=device)
    for layer in net.layers:
        layer.updater = Adam(CLS_LR)
    return net


def _ds_steps(net, X, M, Y, B):
    """One `fit` step per B-row padded batch (a `DataSet` with its
    features mask), in order; the loss of each."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    losses = []
    for i in range(0, len(X), B):
        net.fit(DataSet(X[i:i + B], Y[i:i + B], features_mask=M[i:i + B]),
                batch_size=B)
        losses.append(net.score_value)
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    return losses


def _reg_arm_d(device, fails, cfg, B_check, n_check, B, n_steps, n_eval,
               on_card):
    """(d) the TransformerClassifier on padded batches with its features
    mask: card against CPU over n_check steps, n_steps timed, then
    `evaluate()` and `evaluate_roc_multi_class()` on n_eval held-out
    sequences, the trained card net against its copy on the CPU."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.util.jax_params import (
        from_jax_params, to_jax_params)
    X, M, Y = classifier_data(cfg, B_check * n_check, seed=21)
    card, cpu = build_classifier(cfg, device), build_classifier(cfg, "cpu")
    l_card = _ds_steps(card, X, M, Y, B_check)
    l_cpu = _ds_steps(cpu, X, M, Y, B_check)
    out = dict(check=_card_vs_cpu(fails, "classifier", card, cpu, l_card,
                                  l_cpu, n_check, False))
    del card, cpu
    Xt, Mt, Yt = classifier_data(cfg, B * (n_steps + 1), seed=22)
    net = build_classifier(cfg, device)
    _ds_steps(net, Xt[:B], Mt[:B], Yt[:B], B)                  # warm
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = _ds_steps(net, Xt[B:], Mt[B:], Yt[B:], B)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    _falls(fails, "classifier", losses, min(CLS_LOSS_WINDOW,
                                            len(losses) // 2 or 1))
    if on_card:
        _launched(fails, "classifier", launches,
                  ("layer_norm", "residual_layer_norm", "fused_adam",
                   "dropout"),
                  absent=("flash_attention_fwd",))
    out["timed"] = dict(B=B, T=Xt.shape[1], steps=n_steps, wall_s=wall,
                        ms_per_step=wall / n_steps * 1e3,
                        tokens_per_s=float(Mt[B:].sum()) / wall,
                        loss_first=losses[0], loss_last=losses[-1],
                        losses=losses, launches=launches,
                        peak_mem_gb=(torch.cuda.max_memory_allocated()
                                     / 2 ** 30 if on_card else None))
    # evaluation: the trained net on the card and its copy on the CPU
    Xe, Me, Ye = classifier_data(cfg, n_eval, seed=23)
    ds = DataSet(Xe, Ye, features_mask=Me)
    twin = from_jax_params(build_classifier(cfg, "cpu"), to_jax_params(net))
    t0 = time.perf_counter()
    e_card, r_card = net.evaluate(ds), net.evaluate_roc_multi_class(ds)
    eval_s = time.perf_counter() - t0
    e_cpu, r_cpu = twin.evaluate(ds), twin.evaluate_roc_multi_class(ds)
    p_card = net.output(Xe, mask=Me).cpu().numpy()
    p_cpu = twin.output(Xe, mask=Me).numpy()
    top2 = np.sort(p_cpu, -1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    apart = np.flatnonzero(p_card.argmax(-1) != p_cpu.argmax(-1))
    near_ties = [int(i) for i in apart if margin[i] <= 2 * OUTPUT_ATOL]
    same_counts = np.array_equal(e_card.confusion.matrix,
                                 e_cpu.confusion.matrix)
    fails.check(same_counts or len(near_ties) == len(apart),
                f"classifier evaluate() card vs CPU: confusion matrices "
                f"differ at examples {apart.tolist()}, of which near-ties "
                f"(top-2 margin <= {2 * OUTPUT_ATOL}) {near_ties}")
    auc_err = max(abs(r_card.calculate_auc(c) - r_cpu.calculate_auc(c))
                  for c in range(cfg["classes"]))
    prob_err = float(np.abs(p_card - p_cpu).max())
    fails.check(auc_err <= 1e-3 and prob_err <= OUTPUT_ATOL,
                f"classifier card vs CPU: AUC max abs err {auc_err} (tol "
                f"1e-3), probabilities max_abs_err {prob_err} (tol "
                f"{OUTPUT_ATOL})")
    out["evaluate"] = dict(n=n_eval, accuracy_card=e_card.accuracy(),
                           accuracy_cpu=e_cpu.accuracy(),
                           same_counts=bool(same_counts),
                           examples_apart=apart.tolist(),
                           near_ties=near_ties,
                           average_auc_card=r_card.calculate_average_auc(),
                           auc_max_abs_err=auc_err,
                           prob_max_abs_err=prob_err, card_s=eval_s)
    return out, launches


def phase_regularized(device, report, fails, small=False):
    """Phase 9: training with what a real configuration sets, arms
    (a)-(d) (each beside its twin in this call). Returns the launch
    counts of the arms' card runs."""
    on_card = device.type == "cuda"
    cfg = dict(LM, n_layers=2, max_len=64) if small else LM
    long_cfg = (dict(LM_LONG, vocab=64, d_model=64, n_layers=2, max_len=64)
                if small else LM_LONG)
    cls_cfg = dict(CLS, n_layers=2, max_len=64, vocab=64) if small else CLS
    out, total = {}, {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    t0 = time.perf_counter()
    out["a"], l = _reg_arm_a(device, fails, cfg,
                             *((2, 2, 2, 3) if small else (8, 3, 16, 20)),
                             on_card)
    add(l)
    out["b"], l = _reg_arm_b(device, fails, cfg, 2, 2 if small else 3,
                             on_card)
    add(l)
    out["c"], l = _reg_arm_c(device, fails, long_cfg,
                             *((2, 2, 3) if small else (8, 3, 10)), on_card)
    add(l)
    out["d"], l = _reg_arm_d(device, fails, cls_cfg,
                             *((2, 2, 4, 3, 16) if small
                               else (8, 3, 16, 20, N_EVAL)), on_card)
    add(l)
    out["seconds"] = time.perf_counter() - t0
    report["regularized"] = out
    a, b, c, d = out["a"], out["b"], out["c"], out["d"]
    for tag in ("fp32", "mixed"):
        tw, tm = a[f"{tag}_twin"], a[f"{tag}_timed"]
        print(f"[regularized] (a) smoke LM {tag} [{tm['steps']} steps, "
              f"B 16]: {tm['ms_per_step']:.2f} ms/step vs undropped twin "
              f"{tw['ms_per_step']:.2f} ms/step (+"
              f"{tm['ms_per_step'] - tw['ms_per_step']:.2f}), "
              f"{tm['tokens_per_s']:.0f} tok/s, loss "
              f"{tm['loss_first']:.4f} -> {tm['loss_last']:.4f}; card vs "
              f"CPU {a[f'{tag}_check']}; launches {tm['launches']}",
              flush=True)
    print(f"[regularized] (b) per-leaf arm: card vs CPU loss rel err "
          f"{b['loss_max_rel_err']:.3g}, worst param "
          f"{b['param_worst_rel_frobenius']:.3g} ({b['param_worst_at']}), "
          f"{b['ms_per_step']:.2f} ms/step at [{b['B']}, {b['T']}], packed "
          f"runs {b['packed_runs']}, launches {b['launches']}", flush=True)
    print(f"[regularized] (c) long-context mixed: dropout "
          f"{c['dropout']['ms_per_step']:.2f} ms/step vs twin "
          f"{c['twin']['ms_per_step']:.2f}, loss "
          f"{c['dropout']['loss_first']:.4f} -> "
          f"{c['dropout']['loss_last']:.4f}; ring vs local step 0 "
          f"{c['ring']['step0_rel_err']:.3g}, output "
          f"{c['ring']['output_max_abs_err_vs_local']:.3g}; ulysses step 0 "
          f"{c['ulysses']['step0_rel_err']:.3g}, output "
          f"{c['ulysses']['output_max_abs_err_vs_local']:.3g}", flush=True)
    print(f"[regularized] (d) classifier: card vs CPU {d['check']}; "
          f"{d['timed']['ms_per_step']:.2f} ms/step, loss "
          f"{d['timed']['loss_first']:.4f} -> {d['timed']['loss_last']:.4f};"
          f" evaluate {d['evaluate']}", flush=True)
    return total


# ------------------------------------- phase 10: ResNet-50 and the graph
# ResNet-50 as the JAX benchmark's accelerator setting trains it
# (deeplearning4j_tpu/bench.py:244-271): 224x224x3, 1000 classes, batch
# 128, the zoo's configuration (l2 1e-4, WeightInit.RELU) with the
# benchmark's Nesterovs(0.005, 0.9) override (:250-259), one repeated
# batch of standard-normal images with one-hot labels, resident on the
# card. Weights are the port's own draws from the zoo's seed.
RESNET = dict(size=224, classes=1000, B=128, steps=20, warmup=3,
              B_check=2, n_check=3)
# the CPU rehearsal: 64x64 (at 32x32 and batch 2 the last stage's
# BatchNorm sees 2 values a channel, and one step at RESNET_LR takes the
# loss from 7.2 to 1.0e13 in the JAX package and from 9.0 to 4.8e9 in
# the port, CPU)
RESNET_SMALL = dict(size=64, classes=10, B=2, steps=2, warmup=1,
                    B_check=2, n_check=2)
RESNET_LR = 0.005
# card against CPU (fp32, TF32 off). ResNet-50's training at batch 2 is
# chaotic: the CPU against itself, with 1e-7 relative noise on the
# images, moves the first gradient by 2.8% (whole tree) and, after 3
# steps at RESNET_LR, the params by 3.8%, the running statistics by
# 3.1% and Nesterov's v by 118% (measured on the CPU of an H100 host;
# the card against the CPU: 2.3%, 3.7%, 3.1%, 117%). So step 0's loss is held
# to TRAIN_LOSS_RTOL, and every later loss, the params, the running
# statistics and v after the steps to RESNET_NOISE_FACTOR times the
# CPU's own distance to its noisy twin (plus TRAIN_LOSS_RTOL of the
# loss); inference `output()` is held at equal weights (the card net's,
# copied to the CPU) to OUTPUT_ATOL.
RESNET_NOISE = 1e-7
RESNET_NOISE_FACTOR = 3.0
# (c): the kernels the LM's graph must launch
GRAPH_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "fused_adam")


def resnet_images(n: int, size: int, classes: int, seed: int):
    """n standard-normal NHWC images and one-hot labels (numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3), dtype=np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def build_resnet(device, size, classes, dtype_policy=None):
    """The zoo ResNet-50 with every layer's updater Nesterovs(RESNET_LR,
    0.9), JAX's weights for the zoo's seed (drawn on the device: card
    and CPU agree to erfinv's last place)."""
    from deeplearning4j_tpu_torch.common.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    model = ResNet50(num_classes=classes, height=size, width=size)
    conf = model.conf()
    for node in conf.nodes.values():
        if node.layer is not None:
            node.layer.updater = Nesterovs(RESNET_LR, 0.9)
    return ComputationGraph(conf, device=device,
                            dtype_policy=dtype_policy).init(model.seed)


def _tree_rel(got, want):
    """Whole-tree relative Frobenius difference of two {key: {name:
    array}} trees, and the worst leaf's (rel, "key/name")."""
    num = den = 0.0
    worst = (0.0, "")
    for lk, lv in want.items():
        for name, w in lv.items():
            d = float(np.sum((got[lk][name].astype(np.float64) - w) ** 2))
            s = float(np.sum(w.astype(np.float64) ** 2))
            num, den = num + d, den + s
            worst = max(worst, (float(np.sqrt(d / max(s, 1e-30))),
                                f"{lk}/{name}"))
    return float(np.sqrt(num / max(den, 1e-30))), worst


def _velocity(net):
    """Nesterov's v as a {key: {name: array}} tree."""
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_updater_state
    return {lk: {pk: st["v"] for pk, st in lv.items()}
            for lk, lv in to_jax_updater_state(net).items()}


def _resnet_card_vs_cpu(device, fails, size, classes, B, n):
    """`n` fit steps at B from the same weights on `device`, on the CPU
    and on the CPU with RESNET_NOISE on the images: step 0's loss card
    against CPU within TRAIN_LOSS_RTOL; the later losses, the params,
    the BatchNorm running statistics and Nesterov's v (whole tree)
    within RESNET_NOISE_FACTOR of the CPU's distance to its noisy twin;
    inference `output()` of the card net against its params and state
    on the CPU within OUTPUT_ATOL."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.util.jax_params import (
        to_jax_params, to_jax_state)
    X, Y = resnet_images(B * n, size, classes, seed=21)
    noisy = X * (1 + RESNET_NOISE * np.random.default_rng(9).standard_normal(
        X.shape, dtype=np.float32))
    nets, losses, secs = [], [], []
    for dev, XX in ((device, X), ("cpu", X), ("cpu", noisy)):
        net = build_resnet(dev, size, classes)
        t0 = time.perf_counter()
        ls = []
        for i in range(0, B * n, B):
            net.fit(DataSet(XX[i:i + B], Y[i:i + B]), batch_size=B)
            ls.append(net.score_value)
        secs.append(time.perf_counter() - t0)
        nets.append(net)
        losses.append(ls)
    card, cpu, twin = nets
    step0 = abs(losses[0][0] - losses[1][0]) / abs(losses[1][0])
    fails.check(step0 <= TRAIN_LOSS_RTOL and all(np.isfinite(losses[0])),
                f"resnet step 0 loss card vs CPU rel err {step0} (tol "
                f"{TRAIN_LOSS_RTOL}): card {losses[0]}, CPU {losses[1]}")
    rows = {}
    for name, get in (("params", to_jax_params), ("state", to_jax_state),
                      ("v", _velocity)):
        got, want, ref = get(card), get(cpu), get(twin)
        rows[name] = (*_tree_rel(got, want), _tree_rel(ref, want)[0])
    for i, (a, b, c) in enumerate(zip(*losses)):
        rows[f"loss_{i}"] = (abs(a - b), None, abs(c - b))
    for name, (rel, _, self_rel) in rows.items():
        if name == "loss_0":
            continue
        tol = RESNET_NOISE_FACTOR * self_rel + (
            TRAIN_LOSS_RTOL * abs(losses[1][int(name[5:])])
            if name.startswith("loss") else 0.0)
        fails.check(rel <= tol, f"resnet card vs CPU {name} after {n} "
                    f"steps: {rel} over {RESNET_NOISE_FACTOR} x the CPU's "
                    f"distance to its noisy twin {self_rel} (tol {tol})")
    twin_of_card = _copy_to(card, "cpu")
    x, _ = resnet_images(B, size, classes, seed=22)
    out = card.output(x)
    out_err = (out.cpu() - twin_of_card.output(x)).abs().max().item()
    fails.check(out_err <= OUTPUT_ATOL and tuple(out.shape) == (B, classes)
                and bool(torch.isfinite(out).all()),
                f"resnet output() card vs CPU at the card's weights "
                f"max_abs_err {out_err} (tol {OUTPUT_ATOL}), shape "
                f"{tuple(out.shape)}")
    # a random ResNet's softmax saturates; its pooled features do not
    feat = card.feed_forward(x)["avgpool"].cpu()
    ref = twin_of_card.feed_forward(x)["avgpool"]
    feat_err = ((feat - ref).abs().max() / ref.abs().max()).item()
    fails.check(feat_err <= OUTPUT_ATOL,
                f"resnet pooled features card vs CPU at the card's weights: "
                f"max err {feat_err} of the largest (tol {OUTPUT_ATOL})")
    return dict(B=B, steps=n, loss_card=losses[0], loss_cpu=losses[1],
                loss_cpu_noisy=losses[2], step0_rel_err=step0,
                output_max_abs_err=out_err, features_max_rel_err=feat_err,
                distances={k: dict(card_vs_cpu=v[0], worst_leaf=v[1],
                                   cpu_vs_noisy_cpu=v[2])
                           for k, v in rows.items()},
                card_s=secs[0], cpu_s=secs[1])


def _resnet_timed(device, size, classes, B, steps, warmup, policy=None):
    """`warmup` then `steps` timed `fit` steps of one repeated batch on
    the device (the data resident there, as the JAX benchmark's), then
    inference `output()` of the batch: ms/step, images/s, peak memory,
    the losses and launches of the steps, and output()'s ms and
    images/s."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.datasets import DataSet
    net = build_resnet(device, size, classes, dtype_policy=policy)
    x, y = resnet_images(B, size, classes, seed=23)
    ds = DataSet(torch.from_numpy(x).to(device),
                 torch.from_numpy(y).to(device))
    K.reset_launches()
    out = _timed_steps(device, net, [ds] * (warmup + steps), B, warmup)
    out.update(size=size, launches=dict(K.LAUNCHES))
    out["output_ms"] = timer(device, lambda: net.output(ds.features),
                             iters=5, warmup=2)
    out["output_images_per_s"] = B / out["output_ms"] * 1e3
    del net
    return out


def _mixed_bn_ab(device, size, classes, B, steps, warmup):
    """The mixed_bf16 ResNet-50 step with BatchNormalization in JAX's
    rounding order (this port's form: bf16 elementwise ops in PyTorch)
    against the parent's form (`F.batch_norm` reading bf16, fp32 inside),
    A, B, B, A on one net in one process: each arm's ms/step over
    `steps` timed steps after `warmup`, and one profiled step's device
    kernel launches and device ms."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers.normalization import (
        BatchNormalization as BN)
    jax_order = BN._normalize_rounded

    def library(self, x, train, gamma, beta, dims, stats=None):
        return self._normalize_library(x, train, gamma, beta)
    arms = {"jax_order": jax_order, "library": library}
    net = build_resnet(device, size, classes, dtype_policy=MIXED)
    x, y = resnet_images(B, size, classes, seed=23)
    ds = DataSet(torch.from_numpy(x).to(device),
                 torch.from_numpy(y).to(device))
    on_card = device.type == "cuda"
    ms = {k: [] for k in arms}
    prof = {}
    try:
        for name in ("jax_order", "library", "library", "jax_order"):
            BN._normalize_rounded = arms[name]
            for _ in range(warmup):
                net.fit(ds, batch_size=B)
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                net.fit(ds, batch_size=B)
            if on_card:
                torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / steps * 1e3)
            if on_card and name not in prof:
                p = _profiled(lambda: net.fit(ds, batch_size=B))
                prof[name] = dict(launches=p["launches"],
                                  device_ms=p["device_ms"],
                                  batchnorm_ms=p["groups_ms"].get(
                                      "batchnorm", 0.0),
                                  other_ms=p["groups_ms"].get("other", 0.0))
    finally:
        BN._normalize_rounded = jax_order
    del net
    return dict(B=B, steps=steps, warmup=warmup, order="A B B A",
                ms_per_step={k: v for k, v in ms.items()},
                ms_per_step_mean={k: float(np.mean(v))
                                  for k, v in ms.items()},
                profiled=prof)


def _graph_fixture(device, fails, tmp):
    """(b) The JAX-written graph zip (tests/fixtures/bridge/
    resnet_small.zip) on `device`: `output()` of the stored images within
    OUTPUT_ATOL of JAX's (inference reads the restored running
    statistics), one more `fit` step against JAX's golden (loss within
    GOLDEN_LOSS_ATOL, each param's and each running statistic's sum and
    sum of squares within GOLDEN_SUM_RTOL of its scale), 3 more steps,
    then a write and restore: params, running state, v, counters and
    `output()` bit-equal."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.util.jax_params import (
        to_jax_params, to_jax_state, to_jax_updater_state)
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    g = np.load(os.path.join(BRIDGE, "resnet_small_golden.npz"))
    net = ModelSerializer.restore_model(
        os.path.join(BRIDGE, "resnet_small.zip"), device=device)
    err = (net.output(g["x"]).cpu() - torch.from_numpy(g["probs"])
           ).abs().max().item()
    B = len(g["step_x"])
    net.fit(DataSet(g["step_x"], g["step_y"]), batch_size=B)
    loss = net.score_value
    loss_err = abs(loss - float(g["loss"]))
    worst = (0.0, "")
    for tag, tree in (("param", to_jax_params(net)),
                      ("state", to_jax_state(net))):
        for lk, lv in tree.items():
            for name, a in lv.items():
                a = a.astype(np.float64)
                k = f"{tag}/{lk}/{name}"
                s0, ss0 = float(g[f"sum/{k}"]), float(g[f"sumsq/{k}"])
                scale = np.sqrt(a.size * ss0) or 1.0
                r = max(abs(a.sum() - s0) / scale,
                        abs((a * a).sum() - ss0) / max(ss0, 1e-30))
                worst = max(worst, (float(r), k))
    fails.check(err <= OUTPUT_ATOL, f"graph bridge: JAX zip output() "
                f"max_abs_err {err} (tol {OUTPUT_ATOL})")
    fails.check(net.iteration_count == int(g["iteration_count"])
                and loss_err <= GOLDEN_LOSS_ATOL,
                f"graph bridge: next step loss {loss} vs JAX "
                f"{float(g['loss'])} (tol {GOLDEN_LOSS_ATOL})")
    fails.check(worst[0] <= GOLDEN_SUM_RTOL, f"graph bridge: sums after "
                f"the step, worst {worst} (tol {GOLDEN_SUM_RTOL})")
    size = g["x"].shape[1]
    X, Y = resnet_images(3 * B, size, g["probs"].shape[1], seed=24)
    for i in range(0, 3 * B, B):
        net.fit(DataSet(X[i:i + B], Y[i:i + B]), batch_size=B)
    path = os.path.join(tmp, "graph.zip")
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore_model(path, device=device)
    equal = (_trees_equal(to_jax_params(back), to_jax_params(net))
             and _trees_equal(to_jax_state(back), to_jax_state(net))
             and _trees_equal(to_jax_updater_state(back),
                              to_jax_updater_state(net))
             and (back.iteration_count, back.epoch_count)
             == (net.iteration_count, net.epoch_count)
             and bool(torch.equal(back.output(g["x"]), net.output(g["x"]))))
    fails.check(equal, "graph bridge: the port's graph zip does not restore "
                "bit-equal (params, running state, v, counters, output)")
    return dict(output_max_abs_err=err, loss=loss,
                loss_jax=float(g["loss"]), loss_abs_err=loss_err,
                sums_worst=worst[0], sums_worst_at=worst[1],
                round_trip_bit_equal=equal, zip_bytes=os.path.getsize(path))


def graph_lm(cfg, device, params, dtype_policy=None):
    """The smoke LM's layer list built with `graph_builder` as a chain of
    layer nodes named by the layer's index (so its trees are keyed as the
    MultiLayerNetwork's), with `params` loaded."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    conf = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                         n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                         ff_multiplier=cfg["ff"],
                         max_len=cfg["max_len"]).conf()
    g = NeuralNetConfiguration.builder().seed(conf.seed).graph_builder()
    g.add_inputs("ids")
    prev = "ids"
    for i, layer in enumerate(conf.layers):
        g.add_layer(str(i), layer, prev)
        prev = str(i)
    g.set_outputs(prev)
    net = ComputationGraph(g.build(), device=device,
                           dtype_policy=dtype_policy)
    return from_jax_params(net, params)


def _graph_lm_arm(device, fails, cfg, B, n, policy):
    """(c) The LM as a graph against the LM as a layer list, from the
    same params: `score()` and `n` Adam steps (losses, params); the
    graph's launches, counted over its own calls."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.datasets import DataSet
    params = random_lm_params(cfg, seed=4321, head_scale=1.0)
    X, Y = lm_corpus(cfg, B * (n + 1), seed=25)
    mln = build_lm(cfg, device, params, dtype_policy=policy)
    net = graph_lm(cfg, device, params, dtype_policy=policy)
    test = DataSet(X[-B:], Y[-B:])
    s_mln = mln.score(test)
    K.reset_launches()
    s_graph = net.score(test)

    def steps(model):
        losses = []
        for i in range(0, B * n, B):
            model.fit(DataSet(X[i:i + B], Y[i:i + B]), batch_size=B)
            losses.append(model.score_value)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return losses
    l_graph = steps(net)
    launches, by_dtype = dict(K.LAUNCHES), dict(K.LAUNCHES_BY_DTYPE)
    l_mln = steps(mln)
    tol = MIXED_STEP0_RTOL if policy else TRAIN_LOSS_RTOL
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip([s_graph] + l_graph, [s_mln] + l_mln))
    worst, worst_bk = param_diff(net, mln)
    bk_tol = 2 * n * adam_step_max()
    tag = policy or "float32"
    fails.check(loss_err <= tol and all(np.isfinite(l_graph)),
                f"graph LM {tag}: score and losses vs the layer list rel "
                f"err {loss_err} (tol {tol}): {[s_graph] + l_graph} vs "
                f"{[s_mln] + l_mln}")
    fails.check(worst[0] <= TRAIN_PARAM_RTOL and worst_bk <= bk_tol,
                f"graph LM {tag}: params vs the layer list worst rel "
                f"{worst} (tol {TRAIN_PARAM_RTOL}), attn_bk {worst_bk}")
    if device.type == "cuda":
        missing = [k for k in GRAPH_KERNELS if not launches.get(k)]
        fails.check(not missing, f"graph LM {tag}: kernels never launched "
                    f"from ComputationGraph: {missing} ({launches})")
    return dict(B=B, steps=n, score=s_graph, score_layer_list=s_mln,
                losses=l_graph, losses_layer_list=l_mln,
                loss_max_rel_err=loss_err, param_worst_rel=worst[0],
                param_worst_at=worst[1], attn_bk_max_abs=worst_bk,
                packed_runs=net._packed_runs(), launches=launches,
                launches_by_dtype=by_dtype)


def phase_resnet(device, report, fails, small=False):
    """ResNet-50 and the ComputationGraph on `device`: (a) card against
    CPU, fp32, then the timed steps and inference in fp32 and mixed_bf16
    (the loss must fall; mixed's step 0 within MIXED_STEP0_RTOL of fp32's
    and its final loss within MIXED_BAND of the fp32 arm's initial loss
    of fp32's final loss); (b) the JAX-written graph zip and a round
    trip; (c) the smoke LM as a graph against the layer list, fp32 and
    mixed_bf16. `small` (the CPU rehearsal, RESNET_SMALL) keeps every
    check but (a)'s falling and band gates. Returns the launches of (a)'s
    timed steps and (b)-(c), each counted from zero just before it."""
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import kernels as K
    c = RESNET_SMALL if small else RESNET
    size, classes = c["size"], c["classes"]
    lm_cfg = dict(LM, n_layers=2, max_len=64) if small else LM
    total = {k: 0 for k in KERNEL_META}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)
    out = {}
    t0 = time.perf_counter()
    out["check"] = _resnet_card_vs_cpu(device, fails, size, classes,
                                       c["B_check"], c["n_check"])
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        out[tag] = _resnet_timed(device, size, classes, c["B"], c["steps"],
                                 c["warmup"], policy)
        add(out[tag]["launches"])
        ls = out[tag]["losses"]
        fails.check(all(np.isfinite(ls)) and (small or ls[-1] < ls[0]),
                    f"resnet {tag} loss did not fall: {ls}")
    f, m = out["float32"], out["mixed_bf16"]
    step0 = abs(m["losses"][0] - f["losses"][0]) / abs(f["losses"][0])
    gap = abs(m["loss_last"] - f["loss_last"])
    # the band's gates hold at the benchmark's batch; the rehearsal's
    # batch of 2 moves step 0 by 6% in bf16, and its losses bounce
    fails.check(small or step0 <= MIXED_STEP0_RTOL,
                f"resnet mixed_bf16 step 0 loss {m['losses'][0]} vs fp32 "
                f"{f['losses'][0]}: rel {step0} (tol {MIXED_STEP0_RTOL})")
    fails.check(small or gap <= MIXED_BAND * f["loss_first"],
                f"resnet mixed_bf16 final loss {m['loss_last']} vs fp32 "
                f"{f['loss_last']}: gap {gap} over {MIXED_BAND} x the fp32 "
                f"initial loss {f['loss_first']}")
    out["mixed_step0_rel"], out["mixed_final_gap"] = step0, gap
    out["mixed_bn_ab"] = ab = _mixed_bn_ab(
        device, size, classes, c["B"], max(1, c["steps"] // 2),
        c["warmup"])
    print(f"[resnet] mixed BatchNorm A/B ({ab['order']}, {ab['steps']} "
          f"steps an arm at batch {ab['B']}): JAX's rounding order "
          f"{ab['ms_per_step']['jax_order']} ms/step, the parent's "
          f"F.batch_norm {ab['ms_per_step']['library']} ms/step; one "
          f"profiled step: {ab['profiled']}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        K.reset_launches()
        out["graph_bridge"] = _graph_fixture(device, fails, tmp)
        if device.type == "cuda":
            torch.cuda.synchronize()
        add(K.LAUNCHES)
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        out[f"graph_lm_{tag}"] = r = _graph_lm_arm(
            device, fails, lm_cfg, 2 if small else 8, 3, policy)
        add(r["launches"])
    out["seconds"] = time.perf_counter() - t0
    report["resnet"] = out
    k = out["check"]
    dist = ", ".join(f"{n} {d['card_vs_cpu']:.3g} (CPU vs noisy CPU "
                     f"{d['cpu_vs_noisy_cpu']:.3g})"
                     for n, d in k["distances"].items())
    print(f"[resnet] card vs CPU {k['steps']} steps at [{k['B']}, {size}, "
          f"{size}, 3]: step 0 loss rel err {k['step0_rel_err']:.3g}, "
          f"output() at equal weights {k['output_max_abs_err']:.3g}, "
          f"pooled features {k['features_max_rel_err']:.3g}; "
          f"distances after the steps: {dist}; losses card "
          f"{k['loss_card']}, CPU {k['loss_cpu']}", flush=True)
    for tag in ("float32", "mixed_bf16"):
        r = out[tag]
        print(f"[resnet] {tag} [{r['B']}, {size}, {size}, 3], {r['steps']} "
              f"steps after {r['warmup']}: {r['ms_per_step']:.2f} ms/step, "
              f"{r['images_per_s']:.1f} images/s, peak {r['peak_mem_gb']} "
              f"GB, loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}; "
              f"output() {r['output_ms']:.2f} ms, "
              f"{r['output_images_per_s']:.1f} images/s", flush=True)
    b = out["graph_bridge"]
    print(f"[resnet] (b) JAX graph zip: output() max_abs_err "
          f"{b['output_max_abs_err']:.3g}, next step loss {b['loss']:.6f} vs "
          f"JAX {b['loss_jax']:.6f}, sums worst {b['sums_worst']:.3g} "
          f"({b['sums_worst_at']}); round trip bit-equal "
          f"{b['round_trip_bit_equal']}", flush=True)
    for tag in ("float32", "mixed_bf16"):
        r = out[f"graph_lm_{tag}"]
        print(f"[resnet] (c) LM as a graph, {tag}: vs the layer list loss "
              f"rel {r['loss_max_rel_err']:.3g}, params worst "
              f"{r['param_worst_rel']:.3g} ({r['param_worst_at']}); packed "
              f"runs {r['packed_runs']}; launches {r['launches']}",
              flush=True)
    print(f"[resnet] phase seconds {out['seconds']:.1f}", flush=True)
    return total


# ------------------------------------------------- phase 11: recurrent
# the char-RNN of the JAX benchmark's configuration 2 (bench.py:673-697:
# TextGenerationLSTM, vocab 77, two GravesLSTM(256), TBPTT 50, T 100)
CHAR = dict(B_check=4, T=100, n_check=3, B=64, iters=20, warmup=2)
CHAR_SMALL = dict(B_check=2, T=20, n_check=2, B=4, iters=3, warmup=1,
                  hidden=16, tbptt=10)
CHAR_TOL = 1e-4          # card vs CPU, fp32: loss and params (TF32 off)
# RmsProp divides each gradient by its own running RMS, so a leaf whose
# gradient is small (the peepholes) moves by about lr whatever rounding
# made it: the CPU against itself with 1e-7 relative noise on the
# weights moves 1_pF by 2.6e-4 after 3 iterations (CPU, H 256). The
# zoo's RmsProp arm holds its params to CHAR_NOISE_FACTOR times the
# CPU's distance to a twin with CHAR_NOISE on its initial weights (or
# CHAR_TOL, the larger); an Sgd twin holds every param to CHAR_TOL.
CHAR_NOISE, CHAR_NOISE_FACTOR, CHAR_SGD_LR = 1e-6, 3.0, 0.1
CHAR_LM_ATOL = 1e-5      # the committed char-LM: card vs CPU, stream
N_WINDOWS, N_GREEDY = 16, 200
SURVEY = os.path.join(HERE, "SURVEY.md")


def char_ids(n_chars: int, offset: int = 0):
    """`n_chars` ids of SURVEY.md (a fixed text of the repo) under the
    committed char-LM's charset (the unknown slot for the rest)."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    charset = TextGenerationLSTM.pretrained_charset()
    with open(SURVEY, errors="ignore") as f:
        text = f.read()[offset:offset + n_chars]
    idx = {c: i for i, c in enumerate(charset)}
    return np.asarray([idx.get(c, len(charset)) for c in text], np.int64)


def char_windows(B: int, T: int, offset: int = 0):
    """B windows of T one-hot chars and their next-char one-hot labels."""
    ids = char_ids(B * T + 1, offset)
    eye = np.eye(77, dtype=np.float32)
    return eye[ids[:-1].reshape(B, T)], eye[ids[1:].reshape(B, T)]


def _fit_losses(net, X, Y, B):
    losses = []
    for i in range(0, len(X), B):
        net.fit(X[i:i + B], Y[i:i + B], batch_size=B, shuffle=False)
        losses.append(net.score_value)
    return losses


def _params_rel_by_leaf(a, b):
    """{"<key>_<param>": relative Frobenius difference} of two nets."""
    pb = dict(b.param_table())
    out = {}
    for k, t in a.param_table().items():
        w = pb[k].detach().cpu().double()
        out[k] = float((t.detach().cpu().double() - w).norm()
                       / w.norm().clamp_min(1e-30))
    return out


def _params_rel(a, b):
    """The worst relative Frobenius difference between two nets' params,
    as (rel, "<key>_<param>")."""
    k, v = max(_params_rel_by_leaf(a, b).items(), key=lambda kv: kv[1])
    return v, k


def _char_card_vs_cpu(device, fails, c, small):
    """(a) TextGenerationLSTM from `init(seed)` on the card and on the
    CPU (the inits within 1e-6), then `n_check` TBPTT iterations at
    [B_check, T] (two chunks each), fp32: under the zoo's RmsProp every
    loss within CHAR_TOL and each param within the larger of CHAR_TOL and
    CHAR_NOISE_FACTOR x the CPU's distance to its noisy twin; with
    Sgd(CHAR_SGD_LR) on every layer, every loss and every param within
    CHAR_TOL. mixed_bf16: bf16 carries, the first loss within
    MIXED_STEP0_RTOL of the fp32 one."""
    import torch
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    kw = dict(hidden=c["hidden"], tbptt_length=c["tbptt"]) if small else {}
    X, Y = char_windows(c["B_check"] * c["n_check"], c["T"])
    out = {}

    def pair(sgd):
        nets = [TextGenerationLSTM(**kw).init(device=d)
                for d in (device, "cpu", "cpu")]
        if sgd:
            for net in nets:
                for layer in net.layers:
                    layer.updater = Sgd(CHAR_SGD_LR)
        with torch.no_grad():
            g = torch.Generator().manual_seed(5)
            for t in nets[2].parameters():
                t.mul_(1 + CHAR_NOISE * torch.randn(t.shape, generator=g))
        return nets
    card, cpu, noisy = pair(False)
    init_rel = _params_rel(card, cpu)
    fails.check(init_rel[0] <= 1e-6, f"recurrent init(seed) card vs CPU: "
                f"{init_rel[0]} at {init_rel[1]}")
    arms = {}
    for arm, nets in (("rmsprop", (card, cpu, noisy)),
                      ("sgd", pair(True)[:2])):
        ls = [_fit_losses(n, X, Y, c["B_check"]) for n in nets]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(ls[0], ls[1]))
        fails.check(loss_err <= CHAR_TOL and all(np.isfinite(ls[0])),
                    f"recurrent {arm} TBPTT loss card vs CPU rel {loss_err}"
                    f" (tol {CHAR_TOL}): {ls[0]} vs {ls[1]}")
        d = _params_rel_by_leaf(nets[0], nets[1])
        if arm == "rmsprop":
            twin = _params_rel_by_leaf(nets[2], nets[1])
            tol = {k: max(CHAR_TOL, CHAR_NOISE_FACTOR * twin[k]) for k in d}
        else:
            twin, tol = None, {k: CHAR_TOL for k in d}
        bad = {k: (d[k], tol[k]) for k in d if d[k] > tol[k]}
        fails.check(not bad, f"recurrent {arm} TBPTT params card vs CPU "
                    f"over tolerance: {bad}")
        worst = max(d.items(), key=lambda kv: kv[1])
        arms[arm] = dict(loss_card=ls[0], loss_cpu=ls[1],
                         loss_max_rel_err=loss_err, param_rel=d,
                         param_worst=worst, twin_rel=twin)
    mixed = TextGenerationLSTM(**kw).init(device=device, dtype_policy=MIXED)
    carry = mixed.init_carries(2)
    fails.check(all(t.dtype == mixed.dtype.compute_dtype
                    for ca in carry.values() for t in ca),
                f"recurrent mixed carries not bf16: "
                f"{[t.dtype for ca in carry.values() for t in ca]}")
    l0 = arms["rmsprop"]["loss_card"][0]
    l_mixed = _fit_losses(mixed, X[:c["B_check"]], Y[:c["B_check"]],
                          c["B_check"])
    step0 = abs(l_mixed[0] - l0) / abs(l0)
    fails.check(step0 <= MIXED_STEP0_RTOL, f"recurrent mixed_bf16 step 0 "
                f"{l_mixed[0]} vs fp32 {l0}: rel {step0}")
    out.update(init_max_rel=init_rel[0], arms=arms, mixed_step0=l_mixed[0],
               mixed_step0_rel=step0, B=c["B_check"], T=c["T"],
               iterations=c["n_check"])
    return out


def _char_timed(device, fails, c, policy, small):
    """(b) `iters` TBPTT iterations of one repeated [B, T] batch after
    `warmup`: ms/iteration, chars/s, peak memory, the losses, the port's
    kernel launches, and one profiled iteration's device kernel launches
    (the plain per-step loop's cost) and busy share."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    kw = dict(hidden=c["hidden"], tbptt_length=c["tbptt"]) if small else {}
    net = TextGenerationLSTM(**kw).init(device=device, dtype_policy=policy)
    from deeplearning4j_tpu_torch.datasets import DataSet
    X, Y = char_windows(c["B"], c["T"], offset=7)
    ds = DataSet(torch.from_numpy(X).to(device), torch.from_numpy(Y).to(device))
    losses = []
    for _ in range(c["warmup"]):
        net.fit(ds, batch_size=c["B"])
        losses.append(net.score_value)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    for _ in range(c["iters"]):
        net.fit(ds, batch_size=c["B"])
        losses.append(net.score_value)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    prof = (_profiled(lambda: net.fit(ds, batch_size=c["B"]))
            if on_card else None)
    _falls(fails, f"recurrent {policy or 'float32'} timed", losses)
    return dict(B=c["B"], T=c["T"], iters=c["iters"], warmup=c["warmup"],
                ms_per_iter=wall / c["iters"] * 1e3,
                chars_per_s=c["B"] * c["T"] * c["iters"] / wall,
                peak_mem_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None),
                losses=losses, loss_first=losses[0], loss_last=losses[-1],
                launches=launches,
                device_launches_per_iter=None if prof is None
                else prof["launches"],
                device_ms_per_iter=None if prof is None
                else prof["device_ms"],
                busy_share=None if prof is None else prof["busy_share"],
                device_ms_by_part=None if prof is None
                else prof["groups_ms"])


def _char_lm(device, fails, small):
    """(c) The committed char-LM: `init_pretrained(TEXT)` (sha256 checked)
    on the card and on the CPU, `output()` of N_WINDOWS held-out windows
    of 100 chars card vs CPU within CHAR_LM_ATOL with the argmax accuracy
    equal window by window, `rnn_time_step` one char at a time over one
    window against `output()`, and N_GREEDY greedy chars from a fixed
    prompt (printed)."""
    import torch
    from deeplearning4j_tpu_torch.zoo import (
        PretrainedType, TextGenerationLSTM)
    model = TextGenerationLSTM()
    t0 = time.perf_counter()
    card = model.init_pretrained(PretrainedType.TEXT, device=device)
    restore_s = time.perf_counter() - t0
    cpu = model.init_pretrained(PretrainedType.TEXT, device="cpu")
    n_win = 2 if small else N_WINDOWS
    X, Y = char_windows(n_win, 100, offset=20000)
    got = card.output(X).cpu().numpy()
    want = cpu.output(X).numpy()
    err = float(np.abs(got - want).max())
    labels = Y.argmax(-1)
    acc_card = (got.argmax(-1) == labels).mean(axis=1)
    acc_cpu = (want.argmax(-1) == labels).mean(axis=1)
    fails.check(err <= CHAR_LM_ATOL, f"char-LM output() card vs CPU "
                f"{err} (tol {CHAR_LM_ATOL})")
    fails.check(np.array_equal(acc_card, acc_cpu), f"char-LM accuracy per "
                f"window card {acc_card} vs CPU {acc_cpu}")
    card.rnn_clear_previous_state()
    steps = torch.stack([card.rnn_time_step(X[:1, t]) for t in range(100)],
                        dim=1).cpu().numpy()
    stream_err = float(np.abs(steps - got[:1]).max())
    fails.check(stream_err <= CHAR_LM_ATOL, f"char-LM rnn_time_step vs "
                f"output() {stream_err} (tol {CHAR_LM_ATOL})")
    charset = TextGenerationLSTM.pretrained_charset()
    prompt = char_ids(40, offset=1000)
    card.rnn_clear_previous_state()
    eye = np.eye(77, dtype=np.float32)
    probs = card.rnn_time_step(eye[prompt][None])[:, -1]
    chars = []
    for _ in range(20 if small else N_GREEDY):
        nxt = int(probs.argmax(-1)[0])
        chars.append(charset[nxt] if nxt < len(charset) else "?")
        probs = card.rnn_time_step(eye[[nxt]])
    text = "".join(chars)
    print(f"[recurrent] (c) greedy from {''.join(charset[i] if i < len(charset) else '?' for i in prompt)!r}: {text!r}",
          flush=True)
    return dict(restore_s=restore_s, windows=n_win, max_abs_err=err,
                accuracy_card=float(acc_card.mean()),
                accuracy_cpu=float(acc_cpu.mean()),
                stream_vs_output_max_abs_err=stream_err, greedy=text)


def _small_recurrent_nets(device):
    """(d) A GravesBidirectionalLSTM -> LastTimeStep -> OutputLayer
    classifier and a SimpleRnn -> RnnOutputLayer net, small widths, from
    one seed."""
    from deeplearning4j_tpu_torch.common.updaters import RmsProp
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        GravesBidirectionalLSTM, LastTimeStep, OutputLayer, RnnOutputLayer,
        SimpleRnn)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def base():
        return (NeuralNetConfiguration.builder().seed(9)
                .updater(RmsProp(1e-2)).list())
    cls = (base().layer(GravesBidirectionalLSTM(n_out=32))
           .layer(LastTimeStep()).layer(OutputLayer(n_out=5,
                                                    activation="softmax"))
           .set_input_type(InputType.recurrent(12)).build())
    rnn = (base().layer(SimpleRnn(n_out=32))
           .layer(RnnOutputLayer(n_out=12, activation="softmax"))
           .set_input_type(InputType.recurrent(12)).build())
    return (MultiLayerNetwork(cls, device=device).init(),
            MultiLayerNetwork(rnn, device=device).init())


def _small_recurrent_card_vs_cpu(device, fails):
    """(d) Both small nets, 3 steps card against CPU within CHAR_TOL: the
    classifier on padded batches (seeded lengths, one row all padding)
    with the features mask, the SimpleRnn on dense sequences."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(31)
    B, T = 8, 30
    x = rng.standard_normal((3 * B, T, 12)).astype(np.float32)
    lens = rng.integers(1, T + 1, 3 * B)
    lens[1] = 0
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    y_cls = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 3 * B)]
    y_seq = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (3 * B, T))]
    out = {}
    for name, which, y, m in (("bidirectional_last_step", 0, y_cls, mask),
                              ("simple_rnn", 1, y_seq, None)):
        nets = [_small_recurrent_nets(d)[which] for d in (device, "cpu")]
        losses = []
        for net in nets:
            ls = []
            for i in range(0, 3 * B, B):
                net.fit(DataSet(x[i:i + B], y[i:i + B],
                                None if m is None else m[i:i + B]))
                ls.append(net.score_value)
            losses.append(ls)
        err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        worst = _params_rel(*nets)
        fails.check(err <= CHAR_TOL and worst[0] <= CHAR_TOL,
                    f"recurrent (d) {name} card vs CPU: loss rel {err}, "
                    f"params {worst[0]} at {worst[1]} (tol {CHAR_TOL})")
        out[name] = dict(loss_card=losses[0], loss_cpu=losses[1],
                         loss_max_rel_err=err, param_worst_rel=worst[0])
    return out


def phase_recurrent(device, report, fails, small=False):
    """Phase 11 on `device`: (a) TextGenerationLSTM card against CPU from
    `init(seed)`, (b) timed TBPTT fp32 and mixed_bf16, (c) the committed
    char-LM, (d) the bidirectional classifier with masks and a SimpleRnn
    net. Returns the port's kernel launches of (b)-(d) (the LSTM path
    runs no kernel of its own; init draws its words with threefry_bits),
    counted from zero just before each."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    c = CHAR_SMALL if small else CHAR
    total = {k: 0 for k in KERNEL_META}
    out = {}
    t0 = time.perf_counter()
    out["check"] = _char_card_vs_cpu(device, fails, c, small)
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        K.reset_launches()
        out[tag] = _char_timed(device, fails, c, policy, small)
        for k in total:
            total[k] += K.LAUNCHES.get(k, 0)
    f, m = out["float32"], out["mixed_bf16"]
    K.reset_launches()
    out["char_lm"] = _char_lm(device, fails, small)
    out["small_nets"] = _small_recurrent_card_vs_cpu(device, fails)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in total:
        total[k] += K.LAUNCHES.get(k, 0)
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    report["recurrent"] = out
    a = out["check"]
    for arm, r in a["arms"].items():
        twin = ("" if r["twin_rel"] is None else
                f", the CPU's noisy twin there "
                f"{r['twin_rel'][r['param_worst'][0]]:.3g}")
        print(f"[recurrent] (a) {arm}: card vs CPU {a['iterations']} TBPTT "
              f"iterations at [{a['B']}, {a['T']}]: init max rel "
              f"{a['init_max_rel']:.3g}, loss rel "
              f"{r['loss_max_rel_err']:.3g}, params worst "
              f"{r['param_worst'][1]:.3g} ({r['param_worst'][0]}){twin}",
              flush=True)
    print(f"[recurrent] (a) mixed step 0 rel {a['mixed_step0_rel']:.3g}",
          flush=True)
    for tag, r in (("float32", f), ("mixed_bf16", m)):
        print(f"[recurrent] (b) {tag} [{r['B']}, {r['T']}] {r['iters']} "
              f"iterations: {r['ms_per_iter']:.2f} ms/iteration, "
              f"{r['chars_per_s']:.1f} chars/s, peak {r['peak_mem_gb']} GB, "
              f"loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}, device "
              f"launches/iteration {r['device_launches_per_iter']}, device "
              f"ms/iteration {r['device_ms_per_iter']}, busy "
              f"{r['busy_share']}, by part {r['device_ms_by_part']}",
              flush=True)
    lm = out["char_lm"]
    print(f"[recurrent] (c) char-LM restore {lm['restore_s']:.2f} s, "
          f"output() of {lm['windows']} windows card vs CPU "
          f"{lm['max_abs_err']:.3g}, accuracy {lm['accuracy_card']:.4f} "
          f"(CPU {lm['accuracy_cpu']:.4f}), rnn_time_step vs output() "
          f"{lm['stream_vs_output_max_abs_err']:.3g}", flush=True)
    for name, r in out["small_nets"].items():
        print(f"[recurrent] (d) {name}: loss rel {r['loss_max_rel_err']:.3g}"
              f", params {r['param_worst_rel']:.3g}", flush=True)
    print(f"[recurrent] launches {total}; phase seconds "
          f"{out['seconds']:.1f}", flush=True)
    return total


# ------------------------------------------------- phase 12: the CNN zoo
DIGITS = os.path.join(HERE, "tests", "fixtures", "digits", "digits_8x8.npz")
N_HELD_OUT = 297          # the packaged LeNet's held-out digits
LENET_ATOL = 1e-5         # LeNet output() card vs CPU, and the card's
LENET_MIN_ACCURACY = 0.95  # held-out accuracy after the fine-tune
# LeNet's fine-tune card vs CPU (fp32, TF32 off): the loss of each step
# within ZOO_LOSS_ATOL (absolute; its losses are about 0.03-0.4). Adam
# divides each gradient by its own RMS, so an element whose gradient is
# zero up to rounding (a near-dead unit of the trained net) moves by
# about lr either side whatever made it: the Adam arm's params are held
# to ZOO_NOISE_FACTOR x the CPU's distance to a twin with ZOO_NOISE
# relative noise on its restored weights (phase 11's rule), and an Sgd
# twin (every layer at Sgd(ZOO_SGD_LR)) holds each param to
# ZOO_SGD_RTOL. The distance saturates once every such element has
# flipped: with 1e-6 weight noise the CPU's twin sits 3.92e-5 (whole
# tree) from the CPU, as the card does (3.92e-5, H100); with 1e-7 noise
# on the digits it sits only 2.4e-7 away (CPU, H100 host).
ZOO_LOSS_ATOL = 1e-4
ZOO_NOISE, ZOO_NOISE_FACTOR = 1e-6, 3.0
ZOO_SGD_LR, ZOO_SGD_RTOL = 0.1, 1e-4
# VGG16's timed steps train at Nesterovs(VGG_LR, 0.9): at the zoo's 1e-2
# VGG16 diverges from its own init on the repeated batch (38.07 ->
# 458.4 -> 2.6e9 -> nan at batch 64 on an H100; 42.7 -> 5.5e6 -> nan at
# batch 4 on a CPU), in both dtypes; at 3e-3 and 1e-3 the loss falls
# (`--zoo-lr-trial`, H100 80GB HBM3). GoogLeNet keeps the zoo's 1e-2.
VGG_LR = 1e-3
ZOO_INIT_RTOL = 1e-6      # init(seed) card vs CPU, of each tensor's largest
EMBED_NORM_ATOL = 1e-5    # FaceNet's and InceptionResNetV1's embeddings
# the phase at the JAX benchmark's and the zoo's sizes, and its CPU
# rehearsal (every model shrunk in input size and depth where it has a
# depth knob; the checks stay)
ZOO = dict(lenet_B=128, n_check=3, warmup=3, steps=20, googlenet_B=128,
           vgg_B=64, B_check=2, googlenet_check=2, vgg_check=1,
           other_B=32, other_steps=10, googlenet={}, vgg={},
           others={"AlexNet": {}, "SimpleCNN": {}, "VGG19": {},
                   "InceptionResNetV1": {}, "FaceNetNN4Small2": {}})
ZOO_SMALL = dict(lenet_B=16, n_check=2, warmup=1, steps=2, googlenet_B=2,
                 vgg_B=2, B_check=2, googlenet_check=1, vgg_check=1,
                 other_B=2, other_steps=1,
                 googlenet=dict(height=64, width=64, num_classes=10),
                 vgg=dict(height=32, width=32, num_classes=10),
                 others={"AlexNet": dict(height=96, width=96),
                         "SimpleCNN": dict(height=16, width=16),
                         "VGG19": dict(height=32, width=32, num_classes=10),
                         "InceptionResNetV1": dict(
                             height=80, width=80, blocks35=1, blocks17=1,
                             blocks8=1),
                         "FaceNetNN4Small2": dict(height=64, width=64)})
# LRN under mixed_bf16, card vs CPU port (and the port vs JAX in the
# tests): both take the window as the difference of two bf16 cumsums,
# each summed in its own order, so the window may be off by a few bf16
# ulps of the row's largest cumsum S (LRN_WINDOW_ULPS of them), which
# moves y by |y| beta alpha dW / k; the elementwise chain after it
# (alpha win, k +, pow, the divide) rounds in bf16 on each side, up to
# LRN_ROUND_ULPS of the row's largest |y| apart (2 measured against
# JAX, CPU, channels 3-192)
LRN_WINDOW_ULPS, LRN_ROUND_ULPS = 16, 4


def bf16_ulp(a):
    """One bf16 ulp at |a| (numpy, elementwise; 2^-133 at 0)."""
    a = np.maximum(np.abs(np.asarray(a, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def lrn_bf16_bound(layer, x, y):
    """The per-element bound above for `layer` (a LocalResponse-
    Normalization) on bf16 input x (numpy fp32 view) with output y: the
    window term at the row's largest cumsum S plus LRN_ROUND_ULPS ulps
    of the row's largest |y|."""
    x = np.asarray(x, np.float32)
    S = np.cumsum(x.astype(np.float64) ** 2, axis=-1)[..., -1:]
    dw = LRN_WINDOW_ULPS * bf16_ulp(S)
    window = np.abs(y) * layer.beta * layer.alpha * dw / layer.k
    row = np.abs(y).max(axis=-1, keepdims=True)
    return window + LRN_ROUND_ULPS * bf16_ulp(row)


def digits_28x28():
    """The committed 8x8 digits (tests/fixtures/digits, scikit-learn's
    `load_digits`) as the packaged LeNet's generator
    (deeplearning4j_tpu/tests/make_zoo_pretrained.py) prepared them: x /
    16, bilinear 8 -> 28 (`F.interpolate`, align_corners=False, within
    3e-7 of `jax.image.resize`), in `default_rng(0).permutation` order,
    the first N_HELD_OUT held out. Returns NHWC [N, 28, 28, 1] fp32 and
    one-hot labels (numpy)."""
    import torch
    import torch.nn.functional as F
    d = np.load(DIGITS)
    x = torch.from_numpy(d["images"].astype(np.float32) / 16.0)[:, None]
    x = F.interpolate(x, size=(28, 28), mode="bilinear",
                      align_corners=False)[:, 0, :, :, None].numpy()
    y = np.eye(10, dtype=np.float32)[d["target"]]
    order = np.random.default_rng(0).permutation(len(x))
    return x[order], y[order]


def digit_batches(X, Y, B, n, seed):
    """`n` batches of B distinct digits each, in a seeded order (a fresh
    permutation of X at each pass), as (X, Y) of n * B rows, batch after
    batch."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([rng.permutation(len(X))
                          for _ in range(-(-n * B // len(X)))])[:n * B]
    return X[idx], Y[idx]


def _copy_to(net, device, dtype_policy=None):
    """A twin of `net` on `device` (under `dtype_policy`, the
    configuration's by default): its configuration, params, running
    state and iteration count (a fresh updater state)."""
    twin = type(net)(net.conf, device=device, dtype_policy=dtype_policy)
    twin.load_state_dict({k: v.to(device) for k, v in
                          net.state_dict().items()})
    twin.iteration_count = net.iteration_count
    return twin


def _near_tie_rows(want, got, eps):
    """Rows whose argmax differs, and whether each is a near-tie of
    `want` (its top-2 gap within eps)."""
    rows = np.nonzero(want.argmax(-1) != got.argmax(-1))[0]
    top2 = np.sort(want[rows], axis=-1)[:, -2:]
    return rows, bool(np.all(top2[:, 1] - top2[:, 0] <= eps))


def _lenet_digits(device, fails, c, small):
    """(a) The packaged LeNet on real digits: restored on the card and on
    the CPU (sha256 checked), output() of the held-out digits within
    LENET_ATOL, `evaluate()` accuracy equal on both sides and to the
    manifest's; then the fine-tune at the JAX benchmark's accelerator
    setting (batch 128, Adam(1e-3)) over distinct batches of the other
    digits: `n_check` steps card vs CPU (fp32: `_lenet_twins`;
    mixed_bf16: losses within MIXED_STEP0_RTOL), and
    `steps` timed after `warmup` in each dtype, the held-out accuracy
    after it at least LENET_MIN_ACCURACY (not in the `small` rehearsal,
    whose two steps at batch 16 follow the restored net's first
    oversized Adam step)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import LeNet, PretrainedType
    from deeplearning4j_tpu_torch.zoo.base import packaged_weight_entry
    X, Y = digits_28x28()
    Xh, Yh, Xt, Yt = X[:N_HELD_OUT], Y[:N_HELD_OUT], X[N_HELD_OUT:], \
        Y[N_HELD_OUT:]
    manifest = packaged_weight_entry("lenet_mnist.zip")
    model = LeNet()
    t0 = time.perf_counter()
    card = model.init_pretrained(PretrainedType.MNIST, device=device)
    restore_s = time.perf_counter() - t0
    cpu = model.init_pretrained(PretrainedType.MNIST, device="cpu")
    got, want = card.output(Xh).cpu().numpy(), cpu.output(Xh).numpy()
    err = float(np.abs(got - want).max())
    acc = {name: net.evaluate(DataSet(Xh, Yh)).accuracy()
           for name, net in (("card", card), ("cpu", cpu))}
    rows, ties = _near_tie_rows(want, got, 2 * err)
    fails.check(err <= LENET_ATOL, f"lenet digits output() card vs CPU "
                f"{err} (tol {LENET_ATOL})")
    fails.check(round(acc["cpu"], 4) == manifest["holdout_accuracy"]
                and (acc["card"] == acc["cpu"] or ties),
                f"lenet digits accuracy card {acc['card']} CPU {acc['cpu']}"
                f" vs the manifest's {manifest['holdout_accuracy']}; rows "
                f"apart {rows.tolist()} (near-ties {ties})")
    out = dict(restore_s=restore_s, output_max_abs_err=err,
               accuracy_card=acc["card"], accuracy_cpu=acc["cpu"],
               rows_apart=rows.tolist(), sha256=manifest["sha256"],
               iteration_restored=card.iteration_count)
    B, n = c["lenet_B"], c["n_check"]
    Xb, Yb = digit_batches(Xt, Yt, B, n, seed=12)
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        nets = [_copy_to(card, device, policy), _copy_to(cpu, "cpu", policy)]
        ls = [_fit_steps(net, Xb, Yb, B) for net in nets]
        r = dict(loss_card=ls[0], loss_cpu=ls[1])
        if policy:
            e = max(abs(a - b) / abs(b) for a, b in zip(*ls))
            fails.check(e <= MIXED_STEP0_RTOL and all(np.isfinite(ls[0])),
                        f"lenet fine-tune mixed_bf16 losses card vs CPU rel "
                        f"{e} (tol {MIXED_STEP0_RTOL}): {ls}")
            r["loss_max_rel_err"] = e
        else:
            r.update(_lenet_twins(device, fails, card, cpu, Xb, Yb, B, ls,
                                  nets))
        out[f"check_{tag}"] = r
        # the timed fine-tune: distinct batches resident on the card
        net = nets[0]
        X2, Y2 = (torch.from_numpy(a).to(device) for a in digit_batches(
            Xt, Yt, B, c["warmup"] + c["steps"], seed=14))
        data = [DataSet(X2[i:i + B], Y2[i:i + B])
                for i in range(0, len(X2), B)]
        out[tag] = t = _timed_steps(device, net, data, B, c["warmup"])
        t["accuracy_after"] = net.evaluate(DataSet(Xh, Yh)).accuracy()
        fails.check(small or t["accuracy_after"] >= LENET_MIN_ACCURACY,
                    f"lenet {tag} held-out accuracy after the fine-tune "
                    f"{t['accuracy_after']} (min {LENET_MIN_ACCURACY})")
    return out


def _lenet_twins(device, fails, card, cpu, X, Y, B, ls, nets):
    """The fp32 fine-tune's gates: losses card vs CPU within
    ZOO_LOSS_ATOL; the Adam arm's params within ZOO_NOISE_FACTOR x the
    CPU's distance to its twin with ZOO_NOISE on the restored weights;
    the Sgd twin's (card and CPU at Sgd(ZOO_SGD_LR)) losses likewise and
    each param within ZOO_SGD_RTOL."""
    import torch
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    twin = _copy_to(cpu, "cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        for t in twin.parameters():
            t.mul_(1 + ZOO_NOISE * torch.randn(t.shape, generator=g))
    l_twin = _fit_steps(twin, X, Y, B)
    e = max(abs(a - b) for a, b in zip(ls[0], ls[1]))
    d, worst = _tree_rel(to_jax_params(nets[0]), to_jax_params(nets[1]))
    self_d = _tree_rel(to_jax_params(twin), to_jax_params(nets[1]))[0]
    fails.check(e <= ZOO_LOSS_ATOL and all(np.isfinite(ls[0])),
                f"lenet fine-tune losses card vs CPU {e} (tol "
                f"{ZOO_LOSS_ATOL}): {ls}")
    fails.check(d <= ZOO_NOISE_FACTOR * self_d,
                f"lenet fine-tune params card vs CPU {d} (worst {worst}) "
                f"over {ZOO_NOISE_FACTOR} x the CPU's distance to its "
                f"noisy twin {self_d}")
    sgd = [_copy_to(card, device), _copy_to(cpu, "cpu")]
    for net in sgd:
        for layer in net.layers:
            layer.updater = Sgd(ZOO_SGD_LR)
    l_sgd = [_fit_steps(net, X, Y, B) for net in sgd]
    e_sgd = max(abs(a - b) for a, b in zip(*l_sgd))
    leaves = _params_rel_by_leaf(*sgd)
    bad = {k: v for k, v in leaves.items() if v > ZOO_SGD_RTOL}
    fails.check(e_sgd <= ZOO_LOSS_ATOL and not bad,
                f"lenet Sgd twin card vs CPU: losses {e_sgd} (tol "
                f"{ZOO_LOSS_ATOL}), params over {ZOO_SGD_RTOL}: {bad}")
    return dict(loss_max_abs_err=e, params_rel=d, params_worst=worst,
                params_cpu_vs_noisy_cpu=self_d, loss_cpu_noisy=l_twin,
                sgd_loss_max_abs_err=e_sgd,
                sgd_params_worst=max(leaves.items(), key=lambda kv: kv[1]))


def _timed_steps(device, net, data, B, warmup):
    """`fit` of each DataSet of `data` (the first `warmup` untimed): ms per
    timed step, images/s, peak memory and every loss."""
    import torch
    on_card = device.type == "cuda"
    losses = []
    for ds in data[:warmup]:
        net.fit(ds, batch_size=B)
        losses.append(net.score_value)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for ds in data[warmup:]:
        net.fit(ds, batch_size=B)
        losses.append(net.score_value)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(data) - warmup
    return dict(B=B, steps=steps, warmup=warmup,
                ms_per_step=wall / steps * 1e3,
                images_per_s=B * steps / wall,
                peak_mem_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None),
                losses=losses, loss_first=losses[0], loss_last=losses[-1])


def _zoo_model(name, kw):
    from deeplearning4j_tpu_torch import zoo
    return getattr(zoo, name)(**kw)


def _zoo_init(model, device, lr=None, dtype_policy=None):
    """`model.init()` on `device`, every layer at Nesterovs(lr, 0.9) when
    `lr` is given."""
    from deeplearning4j_tpu_torch.common.updaters import Nesterovs
    net = model.init(device=device, dtype_policy=dtype_policy)
    if lr is not None:
        for layer in net.layers:
            layer.updater = Nesterovs(lr, 0.9)
    return net


def _zoo_card_vs_cpu(device, fails, name, kw, B, n, lr=None):
    """(b)-(c) The zoo model `name` drawn by `init(seed)` on the card and
    copied to the CPU: the features before the output layer at those
    weights within OUTPUT_ATOL of their largest |value| (a random net's
    1000-way softmax saturates, its features do not), then `n` fit
    steps at batch B of seeded images on each, every loss within
    TRAIN_LOSS_RTOL, every param within TRAIN_PARAM_RTOL (whole tree)
    and output() after the steps within OUTPUT_ATOL."""
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    model = _zoo_model(name, kw)
    size, classes = model.height, model.num_classes
    card = _zoo_init(model, device, lr)
    cpu = _copy_to(card, "cpu")
    X, Y = resnet_images(B * (n + 1), size, classes, seed=41)
    f_card, f_cpu = (_penultimate(net, X[B * n:]) for net in (card, cpu))
    f_err = float((f_card.cpu() - f_cpu).abs().max() / f_cpu.abs().max())
    fails.check(f_err <= OUTPUT_ATOL, f"{name} features card vs CPU at "
                f"init {f_err} of the largest (tol {OUTPUT_ATOL})")
    ls = [_fit_steps(net, X[:B * n], Y[:B * n], B) for net in (card, cpu)]
    e = max(abs(a - b) / abs(b) for a, b in zip(*ls))
    d, worst = _tree_rel(to_jax_params(card), to_jax_params(cpu))
    x = X[B * n:]
    o_card = card.output(x).cpu().numpy()
    o_err = float(np.abs(o_card - cpu.output(x).numpy()).max())
    fails.check(e <= TRAIN_LOSS_RTOL and all(np.isfinite(ls[0])),
                f"{name} losses card vs CPU rel {e} (tol "
                f"{TRAIN_LOSS_RTOL}): {ls}")
    fails.check(d <= TRAIN_PARAM_RTOL, f"{name} params card vs CPU {d} "
                f"(worst leaf {worst}, tol {TRAIN_PARAM_RTOL})")
    fails.check(o_err <= OUTPUT_ATOL and o_card.shape == (B, classes),
                f"{name} output() card vs CPU {o_err} (tol {OUTPUT_ATOL})")
    return dict(B=B, steps=n, size=size, features_max_rel_err=f_err,
                loss_card=ls[0], loss_cpu=ls[1], loss_max_rel_err=e,
                params_rel=d, params_worst=worst, output_max_abs_err=o_err)


def _penultimate(net, x):
    """The activation that enters the output layer: a graph's "avgpool"
    node (GoogLeNet's global pooling), a layer list's last hidden layer
    (VGG's fc2)."""
    acts = net.feed_forward(x)
    return acts["avgpool"] if isinstance(acts, dict) else acts[-2]


def _zoo_timed_pair(device, fails, name, kw, B, c, small, lr=None):
    """(b)-(c) `steps` timed fit steps after `warmup` on one repeated
    batch resident on the card, fp32 and mixed_bf16, from the same
    weights: the loss must fall and mixed's step 0 lie within
    MIXED_STEP0_RTOL of fp32's (gates that hold at the phase's batch,
    not at the `small` rehearsal's batch of 2)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    model = _zoo_model(name, kw)
    x, y = resnet_images(B, model.height, model.num_classes, seed=43)
    ds = DataSet(torch.from_numpy(x).to(device),
                 torch.from_numpy(y).to(device))
    out = {}
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        net = _zoo_init(model, device, lr, policy)
        out[tag] = _timed_steps(device, net, [ds] * (c["warmup"]
                                                     + c["steps"]),
                                B, c["warmup"])
        del net
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if not small:
            _falls(fails, f"{name} {tag} timed", out[tag]["losses"])
    f, m = out["float32"]["losses"][0], out["mixed_bf16"]["losses"][0]
    out["mixed_step0_rel"] = step0 = abs(m - f) / abs(f)
    fails.check(small or step0 <= MIXED_STEP0_RTOL, f"{name} mixed_bf16 "
                f"step 0 {m} vs fp32 {f}: rel {step0} (tol "
                f"{MIXED_STEP0_RTOL})")
    return out


def _zoo_other(device, fails, name, kw, c):
    """(d) One of the five other models at its constructor defaults:
    `init(seed)` card vs CPU within ZOO_INIT_RTOL of each tensor's
    largest |value|, output() at batch B_check within OUTPUT_ATOL, one
    fit step card vs CPU (loss within TRAIN_LOSS_RTOL), the embeddings'
    row norms where the model has them, then `other_steps` timed steps
    at batch other_B on the card."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    model = _zoo_model(name, kw)
    size, classes, B = model.height, model.num_classes, c["B_check"]
    t0 = time.perf_counter()
    card = model.init(device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cpu = model.init(device="cpu")
    pc, pp = to_jax_params(card), to_jax_params(cpu)
    init_err = max(float(np.abs(pc[k][n] - a).max()
                         / max(float(np.abs(a).max()), 1e-30))
                   for k, lv in pp.items() for n, a in lv.items())
    X, Y = resnet_images(2 * B, size, classes, seed=45)
    o_card = card.output(X[:B]).cpu().numpy()
    o_err = float(np.abs(o_card - cpu.output(X[:B]).numpy()).max())
    r = dict(size=size, params=card.num_params(), init_s=init_s,
             init_max_rel_err=init_err, output_max_abs_err=o_err)
    if "embeddings" in getattr(card.conf, "nodes", {}):
        emb = card.feed_forward(X[:B])["embeddings"].float()
        norm_err = float((emb.norm(dim=-1) - 1).abs().max())
        fails.check(norm_err <= EMBED_NORM_ATOL, f"{name} embeddings row "
                    f"norms off 1 by {norm_err} (tol {EMBED_NORM_ATOL})")
        r["embedding_norm_max_err"] = norm_err
    ls = [_fit_steps(net, X[B:], Y[B:], B) for net in (card, cpu)]
    e = abs(ls[0][0] - ls[1][0]) / abs(ls[1][0])
    fails.check(init_err <= ZOO_INIT_RTOL, f"{name} init(seed) card vs CPU "
                f"{init_err} of each tensor's largest (tol {ZOO_INIT_RTOL})")
    fails.check(o_err <= OUTPUT_ATOL and o_card.shape == (B, classes),
                f"{name} output() card vs CPU {o_err} (tol {OUTPUT_ATOL})")
    fails.check(e <= TRAIN_LOSS_RTOL and np.isfinite(ls[0][0]),
                f"{name} fit step card vs CPU rel {e} (tol "
                f"{TRAIN_LOSS_RTOL}): {ls}")
    r.update(loss_card=ls[0][0], loss_cpu=ls[1][0], loss_rel_err=e)
    del cpu
    Bt = c["other_B"]
    x, y = resnet_images(Bt, size, classes, seed=46)
    ds = DataSet(torch.from_numpy(x).to(device),
                 torch.from_numpy(y).to(device))
    t = _timed_steps(device, card, [ds] * (1 + c["other_steps"]), Bt, 1)
    r.update(timed_B=Bt, timed_steps=t["steps"],
             ms_per_step=t["ms_per_step"], images_per_s=t["images_per_s"],
             peak_mem_gb=t["peak_mem_gb"])
    del card
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return r


def _zoo_bounds(device, fails):
    """(e) LRN at GoogLeNet's two stem shapes and CnnToFeedForward at
    LeNet's, bf16 (mixed_bf16's compute dtype), card vs CPU: LRN within
    `lrn_bf16_bound`, the flatten bit-equal."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor)
    from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization
    out, rng = {}, np.random.default_rng(47)
    lrn = LocalResponseNormalization()
    for C in (64, 192):
        x = (3 * rng.standard_normal((2, 56, 56, C))).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = lrn(xb.to(device)).float().cpu().numpy()
        want = lrn(xb).float().numpy()
        bnd = lrn_bf16_bound(lrn, xb.float().numpy(), want)
        over = float((np.abs(got - want) / bnd).max())
        fails.check(over <= 1.0, f"LRN bf16 [2, 56, 56, {C}] card vs CPU "
                    f"at {over} of the bound")
        out[f"lrn_bf16_C{C}"] = dict(
            max_abs_err=float(np.abs(got - want).max()),
            share_of_bound=over)
    pp = CnnToFeedForwardPreProcessor(4, 4, 50)
    x = torch.from_numpy(rng.standard_normal((128, 4, 4, 50)).astype(
        np.float32)).to(torch.bfloat16)
    eq = bool(torch.equal(pp.pre_process(x.to(device)).cpu(),
                          pp.pre_process(x)))
    fails.check(eq, "CnnToFeedForward bf16 card vs CPU not bit-equal")
    out["cnn_to_ff_bf16_bit_equal"] = eq
    return out


def phase_cnn_zoo(device, report, fails, small=False):
    """Phase 12 on `device` (fp32 with TF32 off unless an arm says
    mixed_bf16): (a) the packaged LeNet on real digits and its
    fine-tune, (b) GoogLeNet and (c) VGG16 at full width and depth card
    vs CPU and timed in both dtypes, (d) the five other CNNs at their
    constructor defaults, (e) LRN and CnnToFeedForward in bf16 card vs
    CPU. `small` (the CPU rehearsal, ZOO_SMALL) keeps every check.
    Returns the port's kernel launches of the phase (init's
    threefry_bits, the dense layers' dropout)."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    c = ZOO_SMALL if small else ZOO
    out = {}
    t0 = time.perf_counter()
    K.reset_launches()
    out["lenet"] = _lenet_digits(device, fails, c, small)
    for name, B, n, key, lr in (
            ("GoogLeNet", c["googlenet_B"], c["googlenet_check"],
             "googlenet", None),
            ("VGG16", c["vgg_B"], c["vgg_check"], "vgg", VGG_LR)):
        out[name] = dict(
            check=_zoo_card_vs_cpu(device, fails, name, c[key],
                                   c["B_check"], n, lr),
            **_zoo_timed_pair(device, fails, name, c[key], B, c, small, lr))
    for name, kw in c["others"].items():
        out[name] = _zoo_other(device, fails, name, kw, c)
    out["bounds"] = _zoo_bounds(device, fails)
    if device.type == "cuda":
        torch.cuda.synchronize()
    total = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    report["cnn_zoo"] = out
    le = out["lenet"]
    print(f"[cnn_zoo] (a) LeNet restored in {le['restore_s']:.2f} s "
          f"(sha256 {le['sha256'][:12]}..., iteration "
          f"{le['iteration_restored']}): output() of {N_HELD_OUT} held-out "
          f"digits card vs CPU {le['output_max_abs_err']:.3g}, accuracy "
          f"card {le['accuracy_card']:.4f} CPU {le['accuracy_cpu']:.4f}; "
          f"fine-tune check fp32 loss "
          f"{le['check_float32']['loss_max_abs_err']:.3g}, params "
          f"{le['check_float32']['params_rel']:.3g} (CPU vs noisy CPU "
          f"{le['check_float32']['params_cpu_vs_noisy_cpu']:.3g}), Sgd twin "
          f"loss {le['check_float32']['sgd_loss_max_abs_err']:.3g}, params "
          f"worst {le['check_float32']['sgd_params_worst']}; mixed loss rel "
          f"{le['check_mixed_bf16']['loss_max_rel_err']:.3g}", flush=True)
    for tag in ("float32", "mixed_bf16"):
        r = le[tag]
        print(f"[cnn_zoo] (a) LeNet {tag} batch {r['B']}, {r['steps']} "
              f"distinct batches after {r['warmup']}: {r['ms_per_step']:.3f}"
              f" ms/step, {r['images_per_s']:.1f} images/s, peak "
              f"{r['peak_mem_gb']} GB, loss {r['loss_first']:.4f} -> "
              f"{r['loss_last']:.4f}, held-out accuracy after "
              f"{r['accuracy_after']:.4f}", flush=True)
    for name in ("GoogLeNet", "VGG16"):
        r, k = out[name], out[name]["check"]
        print(f"[cnn_zoo] ({'b' if name == 'GoogLeNet' else 'c'}) {name} "
              f"{k['size']}x{k['size']} card vs CPU {k['steps']} steps at "
              f"batch {k['B']}: features at init "
              f"{k['features_max_rel_err']:.3g}, loss rel "
              f"{k['loss_max_rel_err']:.3g}, params "
              f"{k['params_rel']:.3g} (worst {k['params_worst'][1]} "
              f"{k['params_worst'][0]:.3g}), output() "
              f"{k['output_max_abs_err']:.3g}; mixed step 0 rel "
              f"{r['mixed_step0_rel']:.3g}", flush=True)
        for tag in ("float32", "mixed_bf16"):
            t = r[tag]
            print(f"[cnn_zoo] {name} {tag} batch {t['B']}, {t['steps']} "
                  f"steps after {t['warmup']}: {t['ms_per_step']:.2f} "
                  f"ms/step, {t['images_per_s']:.1f} images/s, peak "
                  f"{t['peak_mem_gb']} GB, loss {t['loss_first']:.4f} -> "
                  f"{t['loss_last']:.4f}", flush=True)
    for name in c["others"]:
        r = out[name]
        print(f"[cnn_zoo] (d) {name} {r['size']}x{r['size']} "
              f"({r['params']} params): init {r['init_s']:.2f} s, init card "
              f"vs CPU {r['init_max_rel_err']:.3g}, output() "
              f"{r['output_max_abs_err']:.3g}, fit step loss rel "
              f"{r['loss_rel_err']:.3g}"
              + (f", embedding norms {r['embedding_norm_max_err']:.3g}"
                 if "embedding_norm_max_err" in r else "")
              + f"; {r['timed_steps']} steps at batch {r['timed_B']}: "
              f"{r['ms_per_step']:.2f} ms/step, {r['images_per_s']:.1f} "
              f"images/s, peak {r['peak_mem_gb']} GB", flush=True)
    print(f"[cnn_zoo] (e) bf16 card vs CPU: {out['bounds']}", flush=True)
    print(f"[cnn_zoo] launches {total}; phase seconds "
          f"{out['seconds']:.1f}", flush=True)
    return total


# --------------------------------- phase 13: the remaining layer families
# YOLOv2 at darknet's `cfg/yolov2.cfg` widths (Redmon & Farhadi,
# YOLO9000, 2016), which DL4J's zoo YOLO2 follows: the Darknet-19 body as
# (filters, kernel) convolutions, each without a bias and followed by
# BatchNorm with leaky 0.1; "M" is a 2x2/2 max pool, "P" marks the map the
# passthrough takes (38x38x512 at 608). Then the passthrough (a 1x1 conv to
# 64, SpaceToDepthLayer(2), merged before the 1024-wide map), a 3x3 conv to
# 1024 and a 1x1 conv to A x (5 + C) with a bias and no activation. The
# SpaceToDepthLayer follows JAX's order, not darknet's `reorg`: darknet's
# yolov2.weights would not load into this net unchanged.
YOLO_BODY = ((32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M",
             (256, 3), (128, 1), (256, 3), "M", (512, 3), (256, 1), (512, 3),
             (256, 1), (512, 3), "P", "M", (1024, 3), (512, 1), (1024, 3),
             (512, 1), (1024, 3), (1024, 3), (1024, 3))
YOLO_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                (7.88282, 3.52778), (9.77052, 9.16828))
# the cfg's learning_rate, momentum and decay (DL4J has no plain momentum
# SGD: Nesterovs), minibatch 8 (batch=64, subdivisions=8); the card-vs-CPU
# steps run at 416 (grid 13: the same weights serve any multiple of 32).
# The cfg ramps the rate up over its first 1000 batches (burn_in), which
# DL4J has no counterpart for; DL4J's zoo YOLO2 renormalizes each layer's
# gradient to L2 norm 1 instead (RenormalizeL2PerLayer, threshold 1),
# and so does this net: without it the loss jumps to several times its
# level within 13 steps at every rate from 3e-5 to 1e-3 and reaches NaN at
# 1e-3 (`--yolo-lr-trial`, H100 80GB HBM3; at 1e-4, NaN in one of two
# runs of this phase); with it the loss falls step by step at all four
YOLO_LR, YOLO_MOMENTUM, YOLO_L2 = 1e-3, 0.9, 5e-4
YOLO_GN = ("renormalize_l2_per_layer", 1.0)
YOLO = dict(size=608, classes=80, width=1.0, B=8, warmup=3, steps=10,
            check_size=416, B_check=2, n_check=3)
YOLO_SMALL = dict(size=64, classes=4, width=1 / 16, B=2, warmup=1, steps=1,
                  check_size=64, B_check=2, n_check=3)
YOLO_INIT_RTOL = 1e-5     # init(seed) card vs CPU, of each tensor's largest
YOLO_THRESHOLD = 0.5      # get_predicted_objects
# mixed_bf16's step 0 against fp32's: the 425 detection channels reach the
# fp32 loss rounded to bf16, and exp(tw), exp(th) and the sigmoids carry
# that rounding into 1805 anchors an image (2.5% on an H100, where the
# LM's 1e-2 band was set for a softmax over logits)
YOLO_MIXED_STEP0_RTOL = MIXED_BAND
PHASE13_NOISE, PHASE13_NOISE_FACTOR = 1e-7, 3.0   # the noisy-twin rule
# the twin for YOLOv2's steps, the MoE LM (its routing flips at near-ties
# after a step) and the VAE's RmsProp (which moves every near-zero
# gradient by about 4.5 lr): a CPU twin with this relative noise on its
# initial weights (token ids take no input noise); the VAE also has an
# Sgd twin held step by step
PHASE13_WEIGHT_NOISE = 1e-6
VAE_SGD_LR = 1e-4
# the MoE LM: the smoke LM (phase 3's) with a MixtureOfExperts after each
# block: 8 experts, top-2 (Mixtral 8x7B's), hidden 1024, load balance 0.01,
# phase 5's Adam(1e-3); card vs CPU at B_check (the CPU's share of the
# phase's time), timed at [16, 511]
MOE_LM = dict(LM, n_experts=8, top_k=2, hidden=1024, coef=0.01)
MOE = dict(B=16, B_check=2, n_check=3, warmup=3, steps=10)
MOE_SMALL = dict(B=2, B_check=2, n_check=2, warmup=1, steps=1)
MOE_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# MultiHeadAttention with n_out != n_in: flash at head dim 512 / 8 = 64
MHA_WIDE = dict(n_in=256, n_out=512, n_heads=8, B=8, T=512)
# dl4j-examples' VaeMNIST2dPlots: 784 -> [256, 256] -> 2 -> [256, 256],
# Bernoulli reconstruction, leaky relu, RmsProp(1e-3), l2 1e-4 (inert in
# pretrain), batch 128; the deep belief net at Hinton & Salakhutdinov's
# (Science 2006) encoder widths, binary RBMs, CD-1; a denoising
# AutoEncoder(784 -> 500, corruption 0.3) node in a graph
VAE = dict(enc=(256, 256), latent=2, dec=(256, 256), lr=1e-3, l2=1e-4,
           B=128, timed_epochs=3)
DBN_WIDTHS = (1000, 500, 250, 30)
DBN_FIT_EPOCHS = 10
AE = dict(n_out=500, corruption=0.3)
PRETRAIN_RTOL = 1e-4      # the fp32 ELBO of each step, card vs CPU
LAYER_ATOL = 1e-5         # (d) fp32, of each result's largest |value|
LAYER_BF16_ULPS = 2       # (d) bf16, of each row's largest |value|


def yolo2_conf(size, classes, width=1.0, seed=42, lr=YOLO_LR,
               renormalize=True):
    """The YOLOv2 graph (YOLO_BODY, the passthrough, the head and the
    cfg's five anchors, lambda_coord 5, lambda_no_obj 0.5) over
    size x size x 3 images, every width scaled by `width` (the tests'
    and the rehearsal's small nets), Nesterovs(lr, 0.9), l2 YOLO_L2 and
    YOLO_GN's per-layer gradient renormalization (`renormalize=False`,
    the lr trial's other arm, leaves it out)."""
    from deeplearning4j_tpu_torch.common.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, SpaceToDepthLayer,
        SubsamplingLayer, Yolo2OutputLayer)
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Nesterovs(lr, YOLO_MOMENTUM)).l2(YOLO_L2)
         .weight_init("relu"))
    if renormalize:
        b.gradient_normalization(*YOLO_GN)
    g = (b.graph_builder().add_inputs("input")
         .set_input_types(InputType.convolutional(size, size, 3)))

    def conv_bn(name, prev, filters, k):
        g.add_layer(name, ConvolutionLayer(
            n_out=max(2, int(filters * width)), kernel_size=(k, k),
            convolution_mode="same", has_bias=False), prev)
        g.add_layer(name + "_bn", BatchNormalization(
            activation="leakyrelu:0.1"), name)
        return name + "_bn"

    prev = passthrough = "input"
    for i, item in enumerate(YOLO_BODY):
        if item == "M":
            g.add_layer(f"pool{i}", SubsamplingLayer(
                pooling_type="max", kernel_size=(2, 2), stride=(2, 2)), prev)
            prev = f"pool{i}"
        elif item == "P":
            passthrough = prev
        else:
            prev = conv_bn(f"conv{i}", prev, *item)
    g.add_layer("reorg", SpaceToDepthLayer(block_size=2),
                conv_bn("passthrough", passthrough, 64, 1))
    g.add_vertex("route", MergeVertex(), "reorg", prev)
    g.add_layer("detect", ConvolutionLayer(
        n_out=len(YOLO_ANCHORS) * (5 + classes), kernel_size=(1, 1),
        convolution_mode="same"), conv_bn("head", "route", 1024, 3))
    g.add_layer("yolo", Yolo2OutputLayer(anchors=YOLO_ANCHORS,
                                         lambda_coord=5.0,
                                         lambda_no_obj=0.5), "detect")
    return g.set_outputs("yolo").build()


def yolo_labels(n, grid, classes, seed):
    """[n, grid, grid, 4 + classes] YOLO labels: 1-6 boxes an image from
    `default_rng(seed)`, centers uniform over the grid, sides uniform in
    [0.3, max(0.6, grid / 2)] cells (never under 0.1 cell: sqrt(wh) is
    steep there), each in its center's cell as (x1, y1, x2, y2) in grid
    units with a one-hot class of `classes`."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n, grid, grid, 4 + classes), np.float32)
    for b in range(n):
        for _ in range(int(rng.integers(1, 7))):
            cx, cy = rng.uniform(0, grid, 2)
            w, h = rng.uniform(0.3, max(0.6, grid / 2), 2)
            row = y[b, int(cy), int(cx)]
            row[:] = 0
            row[:4] = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
            row[4 + int(rng.integers(0, classes))] = 1.0
    return y


def _init_rel(a, b):
    """The worst param of two nets, each relative to the tensor's
    largest |value|."""
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    pa, pb = to_jax_params(a), to_jax_params(b)
    return max(float(np.abs(pa[k][n] - w).max()
                     / max(float(np.abs(w).max()), 1e-30))
               for k, lv in pb.items() for n, w in lv.items())


def _weight_noisy(net, seed):
    """A CPU copy of `net` with PHASE13_WEIGHT_NOISE relative noise on
    every param."""
    import torch
    twin = _copy_to(net, "cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for t in twin.parameters():
            t.mul_(1 + PHASE13_WEIGHT_NOISE * torch.randn(t.shape,
                                                          generator=g))
    twin.params_changed()
    return twin


def _noisy_twin_checks(fails, what, card, cpu, twin, losses, extra=()):
    """Step 0's loss card vs CPU within TRAIN_LOSS_RTOL; every later loss
    and the whole param tree (and each (name, getter) of `extra`) within
    PHASE13_NOISE_FACTOR x the CPU's distance to its noisy twin."""
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    lc, lp, lt = losses
    step0 = abs(lc[0] - lp[0]) / max(abs(lp[0]), 1e-30)
    fails.check(step0 <= TRAIN_LOSS_RTOL and all(np.isfinite(lc)),
                f"{what} step 0 loss card vs CPU rel {step0} (tol "
                f"{TRAIN_LOSS_RTOL}): card {lc}, CPU {lp}")
    rows = {}
    for name, get in (("params", to_jax_params),) + tuple(extra):
        got, want, ref = get(card), get(cpu), get(twin)
        rows[name] = (_tree_rel(got, want)[0], _tree_rel(ref, want)[0])
    for i in range(1, len(lp)):
        rows[f"loss_{i}"] = (abs(lc[i] - lp[i]), abs(lt[i] - lp[i]))
    for name, (rel, self_rel) in rows.items():
        tol = PHASE13_NOISE_FACTOR * self_rel + (
            TRAIN_LOSS_RTOL * abs(lp[int(name[5:])])
            if name.startswith("loss") else 0.0)
        fails.check(rel <= tol, f"{what} card vs CPU {name}: {rel} over "
                    f"{PHASE13_NOISE_FACTOR} x the CPU's distance to its "
                    f"noisy twin {self_rel} (tol {tol})")
    return dict(step0_rel_err=step0, loss_card=lc, loss_cpu=lp,
                loss_cpu_noisy=lt,
                distances={k: dict(card_vs_cpu=a, cpu_vs_noisy_cpu=b)
                           for k, (a, b) in rows.items()})


def _yolo_card_vs_cpu(device, fails, c):
    """(a) YOLOv2 at `check_size`: `init(seed)` on the card and on the
    CPU within YOLO_INIT_RTOL; output() of the card's weights on both
    within OUTPUT_ATOL of the largest |value|, and the detections at
    YOLO_THRESHOLD equal apart from near-ties (a confidence within the
    largest card-vs-CPU confidence difference of the threshold); then
    `n_check` steps at B_check from the card's weights on the card, the
    CPU and a CPU twin with PHASE13_WEIGHT_NOISE on its weights
    (BatchNorm at batch 2 is chaotic after step 0: `_noisy_twin_checks`,
    running statistics included; cuDNN's fp32 sums over 3x3x1024 windows
    sit further from the CPU's than 1e-7 noise on the images moves them:
    4.89 against 0.54 in step 1's loss on an H100)."""
    import torch
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_state
    size, B, n = c["check_size"], c["B_check"], c["n_check"]
    conf = yolo2_conf(size, c["classes"], c["width"])
    t0 = time.perf_counter()
    card = ComputationGraph(conf, device=device).init()
    if device.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_err = _init_rel(card, ComputationGraph(conf, device="cpu").init())
    fails.check(init_err <= YOLO_INIT_RTOL, f"yolo init(seed) card vs CPU "
                f"{init_err} of each tensor's largest (tol {YOLO_INIT_RTOL})")
    cpu = _copy_to(card, "cpu")
    x, _ = resnet_images(B * (n + 1), size, 1, seed=51)
    grid = size // 32
    y = yolo_labels(B * n, grid, c["classes"], seed=52)
    o_card = card.output(x[B * n:]).cpu()
    o_cpu = cpu.output(x[B * n:])
    o_err = float((o_card - o_cpu).abs().max() / o_cpu.abs().max().clamp(
        min=1.0))
    fails.check(o_err <= OUTPUT_ATOL and tuple(o_card.shape) == (
        B, grid, grid, len(YOLO_ANCHORS) * (5 + c["classes"])),
        f"yolo output() card vs CPU {o_err} (tol {OUTPUT_ATOL}), shape "
        f"{tuple(o_card.shape)}")
    layer = cpu.conf.nodes["yolo"].layer
    conf_c = o_card.reshape(B, grid, grid, len(YOLO_ANCHORS), -1)[..., 4]
    conf_p = o_cpu.reshape(B, grid, grid, len(YOLO_ANCHORS), -1)[..., 4]
    eps = float((conf_c - conf_p).abs().max())
    keys_c = {tuple(k) for k in np.argwhere(conf_c.numpy() >= YOLO_THRESHOLD)}
    keys_p = {tuple(k) for k in np.argwhere(conf_p.numpy() >= YOLO_THRESHOLD)}
    apart = keys_c ^ keys_p
    near = all(abs(float(conf_p[k]) - YOLO_THRESHOLD) <= eps for k in apart)
    n_det = len(layer.get_predicted_objects(o_card, YOLO_THRESHOLD))
    fails.check(near and n_det == len(keys_c), f"yolo detections card vs "
                f"CPU differ beyond near-ties: {len(apart)} apart, eps {eps}")
    nets, losses, secs = [card, cpu, _weight_noisy(card, 53)], [], []
    for net in nets:
        t0 = time.perf_counter()
        losses.append(_fit_steps(net, x[:B * n], y, B))
        secs.append(time.perf_counter() - t0)
    r = _noisy_twin_checks(fails, "yolo", *nets, losses,
                           extra=(("state", to_jax_state),))
    r.update(size=size, B=B, steps=n, init_s=init_s,
             init_max_rel_err=init_err, params=card.num_params(),
             output_max_rel_err=o_err, detections_card=len(keys_c),
             detections_cpu=len(keys_p), detections_apart=len(apart),
             detection_eps=eps, card_s=secs[0], cpu_s=secs[1])
    return r


def _yolo_timed(device, fails, c, small):
    """(a) YOLOv2 at `size` (608: grid 19), batch B of seeded images and
    labels resident on the card, `warmup` then `steps` timed `fit` steps,
    fp32 and mixed_bf16 from the same seed: ms/step, images/s, peak
    memory; the loss must fall (not in the rehearsal) and mixed's step 0
    lie within YOLO_MIXED_STEP0_RTOL of fp32's."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = yolo2_conf(c["size"], c["classes"], c["width"])
    x, _ = resnet_images(c["B"], c["size"], 1, seed=54)
    y = yolo_labels(c["B"], c["size"] // 32, c["classes"], seed=55)
    ds = DataSet(torch.from_numpy(x).to(device), torch.from_numpy(y).to(
        device))
    out = {}
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        net = ComputationGraph(conf, device=device,
                               dtype_policy=policy).init()
        out[tag] = _timed_steps(device, net, [ds] * (c["warmup"]
                                                     + c["steps"]),
                                c["B"], c["warmup"])
        if tag == "float32":
            out["params"] = net.num_params()
        del net
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if not small:
            _falls(fails, f"yolo {tag} timed", out[tag]["losses"])
    f, m = out["float32"]["losses"][0], out["mixed_bf16"]["losses"][0]
    out["mixed_step0_rel"] = step0 = abs(m - f) / abs(f)
    fails.check(step0 <= YOLO_MIXED_STEP0_RTOL, f"yolo mixed_bf16 step 0 {m}"
                f" vs fp32 {f}: rel {step0} (tol {YOLO_MIXED_STEP0_RTOL})")
    return out


def moe_lm_conf(cfg, seed=123):
    """The MoE LM: Embedding, positional encoding, then n_layers x (a
    causal TransformerEncoderBlock, a MixtureOfExperts), and the softmax
    RnnOutputLayer; Adam(1e-3) and Xavier on every layer, as the zoo
    LM's. The configuration is made from the layer list, every width
    given: the list builder would put a RnnToFeedForward preprocessor
    before each MixtureOfExperts (a feed-forward layer to it), which
    takes [B, T, F] as it is."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (
        EmbeddingLayer, MixtureOfExperts, PositionalEncodingLayer,
        RnnOutputLayer, TransformerEncoderBlock)
    V, d = cfg["vocab"], cfg["d_model"]
    layers = [EmbeddingLayer(n_in=V, n_out=d, time_series_input=True),
              PositionalEncodingLayer(n_out=d, max_len=cfg["max_len"])]
    for _ in range(cfg["n_layers"]):
        layers.append(TransformerEncoderBlock(
            n_in=d, n_heads=cfg["n_heads"], ff_multiplier=cfg["ff"],
            causal=True, cache_len=cfg["max_len"]))
        layers.append(MixtureOfExperts(
            n_in=d, n_out=d, n_experts=cfg["n_experts"],
            hidden_size=cfg["hidden"], top_k=cfg["top_k"],
            load_balance_coef=cfg["coef"]))
    layers.append(RnnOutputLayer(n_in=d, n_out=V, activation="softmax",
                                 loss="mcxent"))
    for layer in layers:
        layer.updater = Adam(1e-3)
    return MultiLayerConfiguration(layers=layers, seed=seed)


def _moe_positions(net):
    return [i for i, layer in enumerate(net.layers)
            if layer.layer_name == "mixture_of_experts"]


def _moe_aux(net, x):
    """The load-balance loss the next training step adds (every MoE
    layer's, summed), from a training forward under that step's key."""
    import torch
    x = net._features(x)
    st = {}
    with torch.no_grad():
        net._policy_call(lambda: net._forward(
            x, upto=len(net.layers) - 1, train=True,
            rng=net._step_key(net.iteration_count), new_state=st))
    return float(net._pop_aux(st))


def _moe_selected(net, x):
    """Each MoE layer's selected experts [N, E] (bool, numpy) on x, from
    its input in inference mode."""
    import torch
    acts = net.feed_forward(x)
    out = []
    with torch.no_grad():
        for i in _moe_positions(net):
            layer = net.layers[i]
            h = acts[i - 1]
            gates, _ = net._policy_call(lambda: layer.gate(h))
            out.append((gates.reshape(-1, layer.n_experts) > 0).cpu().numpy())
    return out


def _moe_steps(nets, X, Y, B):
    """`fit` of each net over X in B-row steps: the losses and the
    load-balance losses (before each step) of each net."""
    ls, aux = [[] for _ in nets], [[] for _ in nets]
    for j, net in enumerate(nets):
        for i in range(0, len(X), B):
            aux[j].append(_moe_aux(net, X[i:i + B]))
            ls[j] += _fit_steps(net, X[i:i + B], Y[i:i + B], B)
    return ls, aux


def _moe_card_vs_cpu(device, fails, cfg, c):
    """(b) The MoE LM from `init(seed)` on the card and its copy on the
    CPU: output() at [B_check, max_len] within OUTPUT_ATOL; the experts
    each token selects, equal apart from near-ties (counted); the
    per-expert token fractions; then `n_check` steps at [B_check,
    max_len - 1] by the noisy-twin rule against a CPU twin with
    PHASE13_WEIGHT_NOISE on its weights: step 0's loss and load-balance
    loss within TRAIN_LOSS_RTOL, the later ones and the params within
    PHASE13_NOISE_FACTOR x the twin's distance. After a step a token
    whose top-2 is a near-tie can route to another expert on each side,
    a jump in the loss no updater avoids (an Sgd(0.1) twin's
    load-balance loss was 5% apart by step 2, Adam's 0.6%, on an
    H100)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    B, n = c["B_check"], c["n_check"]
    card = MultiLayerNetwork(moe_lm_conf(cfg), device=device).init()
    cpu = _copy_to(card, "cpu")
    ids = np.random.default_rng(61).integers(0, cfg["vocab"],
                                             (B, cfg["max_len"]))
    o_card = card.output(ids).cpu()
    o_err = float((o_card - cpu.output(ids)).abs().max())
    fails.check(o_err <= OUTPUT_ATOL, f"moe LM output() card vs CPU {o_err} "
                f"(tol {OUTPUT_ATOL})")
    sel_c, sel_p = _moe_selected(card, ids), _moe_selected(cpu, ids)
    apart = [int((a != b).any(axis=-1).sum()) for a, b in zip(sel_c, sel_p)]
    fracs = [a.mean(axis=0).tolist() for a in sel_p]
    frac_err = max(float(np.abs(a.mean(0) - b.mean(0)).max())
                   for a, b in zip(sel_c, sel_p))
    tokens = B * cfg["max_len"]
    fails.check(frac_err <= max(apart) / tokens + 1e-12, f"moe expert "
                f"fractions card vs CPU {frac_err} beyond the {apart} "
                f"near-tie tokens of {tokens}")
    X, Y = lm_corpus(cfg, B * n, seed=62)
    twin = _weight_noisy(card, 64)
    ls, aux = _moe_steps([card, cpu, twin], X, Y, B)
    r = _noisy_twin_checks(fails, "moe LM", card, cpu, twin, ls)
    for i in range(n):
        d, self_d = abs(aux[0][i] - aux[1][i]), abs(aux[2][i] - aux[1][i])
        tol = TRAIN_LOSS_RTOL * abs(aux[1][i]) + (
            PHASE13_NOISE_FACTOR * self_d if i else 0.0)
        fails.check(d <= tol, f"moe LM load-balance loss {i} card vs CPU "
                    f"{d} (tol {tol}, twin {self_d})")
    fails.check(not any(card.net_state.values()), "moe LM kept state")
    r.update(B=B, steps=n, output_max_abs_err=o_err,
             selection_apart_tokens=apart, tokens=tokens,
             expert_fractions_cpu=fracs, fraction_max_err=frac_err,
             aux_card=aux[0], aux_cpu=aux[1], aux_cpu_noisy=aux[2],
             params=card.num_params())
    return r


def _moe_timed(device, fails, cfg, c, small):
    """(b) `warmup` then `steps` timed `fit` steps of the MoE LM on one
    repeated [B, max_len - 1] batch resident on the card, fp32 and
    mixed_bf16: ms/step, tokens/s, peak memory, the phase-5 kernels'
    launches; the loss must fall (not in the rehearsal)."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    X, Y = lm_corpus(cfg, c["B"], seed=63)
    ds = DataSet(torch.from_numpy(X).long().to(device),
                 torch.from_numpy(Y).to(device))
    out = {}
    for tag, policy in (("float32", None), ("mixed_bf16", MIXED)):
        before = dict(K.LAUNCHES)
        net = MultiLayerNetwork(moe_lm_conf(cfg), device=device,
                                dtype_policy=policy).init()
        r = _timed_steps(device, net, [ds] * (c["warmup"] + c["steps"]),
                         c["B"], c["warmup"])
        r["tokens_per_s"] = r["images_per_s"] * X.shape[1]
        r["launches"] = {k: K.LAUNCHES[k] - before.get(k, 0)
                         for k in K.LAUNCHES}
        out[tag] = r
        del net
        if device.type == "cuda":
            torch.cuda.empty_cache()
            _launched(fails, f"moe LM {tag}", r["launches"], MOE_KERNELS)
        if not small:
            _falls(fails, f"moe LM {tag} timed", r["losses"])
    return out


def _mha_wide(device, fails, small):
    """(b) MultiHeadAttention(n_in 256, n_out 512, 8 heads, causal) at
    [8, 512]: the forward and the gradients of x and every param, card
    vs CPU from one init, within OUTPUT_ATOL and GRAD_RTOL of each
    result's largest |value| (bk's gradient, zero up to rounding, within
    GRAD_RTOL of Wk's largest on both sides); flash runs at head dim
    64."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.common import prng
    from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
    c = dict(MHA_WIDE, B=2, T=64) if small else MHA_WIDE
    layer = MultiHeadAttention(n_in=c["n_in"], n_out=c["n_out"],
                               n_heads=c["n_heads"], causal=True)
    layer.init_weights(prng.key(71))
    x = torch.from_numpy(np.random.default_rng(72).standard_normal(
        (c["B"], c["T"], c["n_in"]), dtype=np.float32))
    r = torch.from_numpy(np.random.default_rng(73).standard_normal(
        (c["B"], c["T"], c["n_out"]), dtype=np.float32))
    res, before = [], dict(K.LAUNCHES)
    for dev in (device, torch.device("cpu")):
        lay = layer.clone().to(dev)
        lay.load_state_dict(layer.state_dict())
        xx = x.to(dev).detach().clone().requires_grad_(True)
        params = lay.jax_param_map()
        for t in params.values():
            t.requires_grad_(True)
        y = lay(xx)
        (y * r.to(dev)).sum().backward()
        res.append({"y": y.detach().cpu(), "x": xx.grad.cpu(),
                    **{k: t.grad.cpu() for k, t in params.items()}})
    errs = {k: float((res[0][k] - v).abs().max() / v.abs().max())
            for k, v in res[1].items()}
    # bk's gradient is zero up to rounding (softmax is shift-invariant
    # along each query's keys): both sides must be noise next to Wk's
    bk_noise = max(float(r_["bk"].abs().max()) for r_ in res) / float(
        res[1]["Wk"].abs().max())
    errs["bk"] = bk_noise
    fails.check(errs["y"] <= OUTPUT_ATOL and all(
        e <= GRAD_RTOL for k, e in errs.items() if k != "y"),
        f"MultiHeadAttention n_out != n_in card vs CPU {errs} (tol "
        f"{OUTPUT_ATOL}, {GRAD_RTOL}; bk: its largest |gradient| over Wk's)")
    launches = {k: K.LAUNCHES[k] - before.get(k, 0) for k in K.LAUNCHES}
    if device.type == "cuda":
        _launched(fails, "MultiHeadAttention n_out != n_in", launches,
                  ("flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv"))
    return dict(shape=[c["B"], c["T"], c["n_in"], c["n_out"]],
                head_dim=layer.head_dim, max_rel_err=errs)


def _digits_flat():
    X, Y = digits_28x28()
    X = X.reshape(len(X), -1)
    return X[N_HELD_OUT:], Y[N_HELD_OUT:], X[:N_HELD_OUT], Y[:N_HELD_OUT]


def vae_conf(seed=12345, updater=None):
    """dl4j-examples' VaeMNIST2dPlots VAE as a one-layer net (RmsProp, or
    `updater`)."""
    from deeplearning4j_tpu_torch.common.updaters import RmsProp
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BernoulliReconstructionDistribution, VariationalAutoencoder)
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or RmsProp(VAE["lr"])).weight_init("xavier")
            .l2(VAE["l2"]).list()
            .layer(VariationalAutoencoder(
                n_out=VAE["latent"], encoder_layer_sizes=VAE["enc"],
                decoder_layer_sizes=VAE["dec"],
                reconstruction_distribution=(
                    BernoulliReconstructionDistribution("sigmoid")),
                pzx_activation="identity", activation="leakyrelu"))
            .set_input_type(InputType.feed_forward(784)).build())


def dbn_conf(seed=12345):
    """The deep belief net: binary RBMs 784-1000-500-250-30 (CD-1), then a
    softmax OutputLayer(10); Adam(1e-3) for `pretrain` and `fit`."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import RBM, OutputLayer
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
         .weight_init("xavier").list())
    for w in DBN_WIDTHS:
        b.layer(RBM(n_out=w, k=1))
    return (b.layer(OutputLayer(n_out=10, activation="softmax",
                                loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())


def ae_graph_conf(seed=12345):
    """A graph with a denoising AutoEncoder node (784 -> 500, corruption
    0.3) under a softmax output; Sgd(0.1)."""
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import AutoEncoder, OutputLayer
    return (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1))
            .weight_init("xavier").graph_builder().add_inputs("digits")
            .set_input_types(InputType.feed_forward(784))
            .add_layer("ae", AutoEncoder(n_out=AE["n_out"],
                                         corruption_level=AE["corruption"]),
                       "digits")
            .add_layer("out", OutputLayer(n_out=10, activation="softmax",
                                          loss="mcxent"), "ae")
            .set_outputs("out").build())


def _pretrain_losses(net):
    return {k: [float(v) for v in ls] for k, ls in net.pretrain_losses.items()}


def _vae_arm(device, fails, Xt, Xh, small):
    """(c) The VAE, one epoch of `pretrain` at batch 128 from one init on
    the card and on the CPU: an Sgd(VAE_SGD_LR) twin's negative ELBO of
    every step within PRETRAIN_RTOL (relative); the example's RmsProp arm
    (whose first steps move every param by about 4.5 lr whatever its
    gradient, so rounding flips the near-zero ones) by the noisy-twin
    rule against a CPU twin with PHASE13_WEIGHT_NOISE on its weights;
    then `timed_epochs` more on the card (ms/step), and
    `reconstruction_probability` of the held-out digits, the card's
    layer on both devices under one key, within PRETRAIN_RTOL."""
    import torch
    from deeplearning4j_tpu_torch.common import prng
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    B = VAE["B"]
    card = MultiLayerNetwork(vae_conf(), device=device).init()
    sgd = MultiLayerNetwork(vae_conf(updater=Sgd(VAE_SGD_LR)),
                            device=device)
    sgd.load_state_dict(card.state_dict())
    s_nets = [sgd, _copy_to(sgd, "cpu")]
    for net in s_nets:
        net.pretrain(Xt, epochs=1, batch_size=B)
    lc, lp = (_pretrain_losses(n)["0"] for n in s_nets)
    e = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    fails.check(e <= PRETRAIN_RTOL and all(np.isfinite(lc)), f"vae Sgd twin "
                f"ELBO card vs CPU rel {e} (tol {PRETRAIN_RTOL}): {lc} vs "
                f"{lp}")
    nets = [card, _copy_to(card, "cpu"), _weight_noisy(card, 77)]
    for net in nets:
        net.pretrain(Xt, epochs=1, batch_size=B)
    r = _noisy_twin_checks(fails, "vae (RmsProp)", *nets,
                           [_pretrain_losses(n)["0"] for n in nets])
    n_ep = 1 if small else VAE["timed_epochs"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.pretrain(Xt, epochs=n_ep, batch_size=B)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = n_ep * -(-len(Xt) // B)
    timed = _pretrain_losses(card)["0"]
    key = prng.key(74)
    twin = _copy_to(card, "cpu")
    rp_c = card.layers[0].reconstruction_probability(
        torch.from_numpy(Xh).to(device), key).cpu()
    rp_p = twin.layers[0].reconstruction_probability(torch.from_numpy(Xh),
                                                     key)
    rp_err = float(((rp_c - rp_p).abs() / rp_p.abs()).max())
    fails.check(rp_err <= PRETRAIN_RTOL and bool(torch.isfinite(rp_c).all()),
                f"vae reconstruction_probability card vs CPU rel {rp_err} "
                f"(tol {PRETRAIN_RTOL})")
    r.update(B=B, steps_check=len(lc), sgd_elbo_card=lc, sgd_elbo_cpu=lp,
             sgd_elbo_max_rel_err=e, timed_epochs=n_ep, timed_steps=steps,
             ms_per_step=wall / steps * 1e3, elbo_timed_first=timed[0],
             elbo_timed_last=timed[-1], recon_logp_mean=float(rp_p.mean()),
             recon_logp_max_rel_err=rp_err, params=card.num_params())
    return r


def _rbm_flips(card, cpu, X):
    """Step 0 of the first RBM's CD-1, card vs CPU from one init and
    under pretrain's first key (step 0 of layer 0): the hidden and
    visible samples that differ (u within rounding of its mean), and the
    loss of each."""
    import torch
    from deeplearning4j_tpu_torch.common import prng
    key = prng.fold_in(prng.key(card.conf.seed + 2), 0)
    out = []
    for net in (card, cpu):
        layer = net.layers[0]
        x = torch.from_numpy(X).to(net.device)
        with torch.no_grad():
            h = layer.sample_h(prng.fold_in(key, 0), x)
            v = layer.sample_v(prng.fold_in(key, 1), h)
            loss = float(layer.pretrain_loss(x, key))
        out.append((h.cpu(), v.cpu(), loss))
    (hc, vc, lc), (hp, vp, lp) = out
    return dict(hidden_flips=int((hc != hp).sum()), hidden=hc.numel(),
                visible_flips=int((vc != vp).sum()), visible=vc.numel(),
                loss_card=lc, loss_cpu=lp)


def _free_energy(net, X):
    import torch
    with torch.no_grad():
        return float(net.layers[0].free_energy(
            torch.from_numpy(X).to(net.device)).mean())


def _dbn_arm(device, fails, Xt, Yt, Xh, Yh, small):
    """(c) The deep belief net: step 0's flips (card vs CPU) counted, and
    step 0's loss held to TRAIN_LOSS_RTOL where none flipped; `pretrain`
    one epoch a layer on the card, the CPU and the CPU with PHASE13_NOISE
    on the digits, the first RBM's mean free energy of the held-out
    digits and the param tree within PHASE13_NOISE_FACTOR x the CPU's
    distance to its twin; then `fit` on the digit labels on the card and
    the held-out accuracy (above chance)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
    B = VAE["B"]
    card = MultiLayerNetwork(dbn_conf(), device=device).init()
    cpu, twin = _copy_to(card, "cpu"), _copy_to(card, "cpu")
    flips = _rbm_flips(card, cpu, Xt[:B])
    if flips["hidden_flips"] == 0 and flips["visible_flips"] == 0:
        e0 = abs(flips["loss_card"] - flips["loss_cpu"]) / abs(
            flips["loss_cpu"])
        fails.check(e0 <= TRAIN_LOSS_RTOL, f"dbn step 0 loss card vs CPU "
                    f"with no flip: rel {e0} (tol {TRAIN_LOSS_RTOL})")
    noisy = Xt * (1 + PHASE13_NOISE * np.random.default_rng(75)
                  .standard_normal(Xt.shape, dtype=np.float32))
    t0 = time.perf_counter()
    card.pretrain(Xt, epochs=1, batch_size=B)
    pre_s = time.perf_counter() - t0
    cpu.pretrain(Xt, epochs=1, batch_size=B)
    twin.pretrain(noisy, epochs=1, batch_size=B)
    fe = [_free_energy(n, Xh) for n in (card, cpu, twin)]
    d_fe, self_fe = abs(fe[0] - fe[1]), abs(fe[2] - fe[1])
    d_p, self_p = (_tree_rel(to_jax_params(card), to_jax_params(cpu))[0],
                   _tree_rel(to_jax_params(twin), to_jax_params(cpu))[0])
    tol_fe = PHASE13_NOISE_FACTOR * self_fe + TRAIN_LOSS_RTOL * abs(fe[1])
    fails.check(d_fe <= tol_fe and d_p <= PHASE13_NOISE_FACTOR * self_p,
                f"dbn after pretrain card vs CPU: free energy {d_fe} (tol "
                f"{tol_fe}), params {d_p} (CPU vs noisy twin {self_p})")
    losses = {k: (v[0], v[-1]) for k, v in _pretrain_losses(card).items()}
    t0 = time.perf_counter()
    card.fit(Xt, Yt, epochs=2 if small else DBN_FIT_EPOCHS, batch_size=B)
    fit_s = time.perf_counter() - t0
    acc = card.evaluate(DataSet(Xh, Yh)).accuracy()
    if not small:
        fails.check(acc > 0.5, f"dbn held-out accuracy {acc} after fit")
    return dict(B=B, flips_step0=flips, free_energy=fe,
                free_energy_dist=d_fe, free_energy_self=self_fe,
                params_rel=d_p, params_self=self_p,
                pretrain_loss_first_last=losses, pretrain_s=pre_s,
                fit_epochs=2 if small else DBN_FIT_EPOCHS, fit_s=fit_s,
                held_out_accuracy=acc, params=card.num_params())


def _ae_arm(device, fails, Xt):
    """(c) The graph's AutoEncoder node pretrained one epoch through
    `graph.pretrain` on the card, the CPU and the CPU with PHASE13_NOISE
    on the digits (`_noisy_twin_checks` on the step losses and params)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    B = VAE["B"]
    card = ComputationGraph(ae_graph_conf(), device=device).init()
    nets = [card, _copy_to(card, "cpu"), _copy_to(card, "cpu")]
    noisy = Xt * (1 + PHASE13_NOISE * np.random.default_rng(76)
                  .standard_normal(Xt.shape, dtype=np.float32))
    for net, xx in zip(nets, (Xt, Xt, noisy)):
        net.pretrain(xx, epochs=1, batch_size=B)
    losses = [_pretrain_losses(n)["ae"] for n in nets]
    r = _noisy_twin_checks(fails, "autoencoder graph pretrain", *nets,
                           losses)
    r["B"] = B
    return r


def _layer_cases():
    """(d) The other new layers at moderate shapes: (name, layer, input
    shape, mask length or None)."""
    from deeplearning4j_tpu_torch.nn.layers import (
        Convolution1DLayer, LossLayer, PermuteLayer, PoolHelperLayer,
        ReshapeLayer, SeparableConvolution2D, Subsampling1DLayer,
        Upsampling1D, Upsampling2D, ZeroPadding1DLayer)
    return [
        ("conv1d", Convolution1DLayer(n_in=64, n_out=128, kernel_size=5,
                                      stride=2, padding=2,
                                      activation="relu"), (8, 200, 64), 200),
        ("subsampling1d", Subsampling1DLayer(kernel_size=3, stride=2,
                                             padding=1), (8, 200, 64), 200),
        ("upsampling1d", Upsampling1D(size=2), (8, 100, 64), 100),
        ("upsampling2d", Upsampling2D(size=2), (8, 38, 38, 64), None),
        ("zeropadding1d", ZeroPadding1DLayer(pad=(2, 3)), (8, 100, 64),
         None),
        ("separable_conv2d_dm2", SeparableConvolution2D(
            n_in=32, n_out=64, kernel_size=(3, 3), depth_multiplier=2,
            convolution_mode="same", activation="relu"),
         (8, 56, 56, 32), None),
        ("reshape", ReshapeLayer(target_shape=(100 * 64,)), (8, 100, 64),
         None),
        ("permute", PermuteLayer(dims=(3, 1, 2)), (8, 38, 38, 64), None),
        ("pool_helper", PoolHelperLayer(), (8, 57, 57, 64), None),
        ("loss_layer", LossLayer(activation="softmax"), (64, 100), None)]


def _layer_pair(layer, device, x, dtype, mask=None):
    """The layer's forward and the gradients of sum(y * r) in x and its
    params on `device` in `dtype`, and its forward_mask of `mask`."""
    import torch
    lay = layer.clone().to(device).to(dtype)
    lay.load_state_dict({k: v.to(dtype) for k, v in layer.state_dict().items()})
    xx = x.to(device, dtype).detach().clone().requires_grad_(True)
    params = lay.jax_param_map()
    for t in params.values():
        t.requires_grad_(True)
    if layer.layer_name == "loss":
        y = lay(xx)
        labels = torch.eye(x.shape[-1])[torch.arange(x.shape[0])
                                        % x.shape[-1]]
        loss = lay.compute_loss(xx, labels.to(device, dtype))
        loss.float().backward()
    else:
        y = lay(xx)
        r = torch.from_numpy(np.random.default_rng(81).standard_normal(
            tuple(y.shape), dtype=np.float32))
        (y.float() * r.to(device)).sum().backward()
    res = {"y": y.detach().float().cpu(), "x": xx.grad.float().cpu(),
           **{k: t.grad.float().cpu() for k, t in params.items()}}
    if mask is not None:
        res["mask"] = lay.forward_mask(mask.to(device)).cpu()
    return res


def _layers_card_vs_cpu(device, fails):
    """(d) Each layer of `_layer_cases`, forward and backward, card vs
    CPU from one init: fp32 within LAYER_ATOL of each result's largest
    |value|, bf16 within LAYER_BF16_ULPS bf16 ulps of each row's largest
    |value| of the CPU's result, forward masks equal."""
    import torch
    from deeplearning4j_tpu_torch.common import prng
    out = {}
    for i, (name, layer, shape, T) in enumerate(_layer_cases()):
        layer.init_weights(prng.key(90 + i))
        x = torch.from_numpy(np.random.default_rng(91 + i).standard_normal(
            shape, dtype=np.float32))
        mask = None
        if T is not None:
            lens = np.random.default_rng(92).integers(T // 4, T + 1,
                                                      shape[0])
            mask = torch.from_numpy((np.arange(T)[None] < lens[:, None])
                                    .astype(np.float32))
        row = {}
        for dt, tag in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
            got = _layer_pair(layer, device, x, dt, mask)
            want = _layer_pair(layer, torch.device("cpu"), x, dt, mask)
            errs = {}
            for k, w in want.items():
                if k == "mask":
                    errs[k] = float((got[k] != w).sum())
                    continue
                d = (got[k] - w).abs()
                if dt == torch.float32:
                    errs[k] = float(d.max() / w.abs().max().clamp(min=1e-30))
                else:
                    top = w.abs().reshape(-1, w.shape[-1]).amax(-1) \
                        if w.ndim else w.abs().reshape(1)
                    ulp = torch.exp2(torch.floor(torch.log2(
                        top.clamp(min=2.0 ** -126))) - 7)
                    errs[k] = float((d.reshape(-1, d.shape[-1] if d.ndim
                                               else 1).amax(-1)
                                     / ulp).max())
            tol = LAYER_ATOL if dt == torch.float32 else LAYER_BF16_ULPS
            fails.check(all(v <= tol for k, v in errs.items()
                            if k != "mask") and errs.get("mask", 0) == 0,
                        f"{name} {tag} card vs CPU {errs} (tol {tol}"
                        f"{' ulps' if dt != torch.float32 else ''})")
            row[tag] = errs
        out[name] = row
    return out


def _frozen_in_training(device, fails):
    """(d) A net with a trained conv before a FrozenLayer(conv) and a
    FrozenLayer(BatchNormalization): after 3 `fit` steps on the card the
    frozen params and running statistics are bit-equal to their start
    and the trained conv moved."""
    from deeplearning4j_tpu_torch.common.updaters import Nesterovs
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, ConvolutionLayer, FrozenLayer,
        GlobalPoolingLayer, OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.jax_params import (
        to_jax_params, to_jax_state)
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Nesterovs(0.05, 0.9)).l2(1e-4).list()
            .layer(ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                    activation="relu"))
            .layer(FrozenLayer(layer=ConvolutionLayer(
                n_in=32, n_out=32, kernel_size=(3, 3))))
            .layer(FrozenLayer(layer=BatchNormalization(n_out=32)))
            .layer(GlobalPoolingLayer())
            .layer(OutputLayer(n_out=10))
            .set_input_type(InputType.convolutional(32, 32, 3)).build())
    net = MultiLayerNetwork(conf, device=device).init()
    p0, s0 = to_jax_params(net), to_jax_state(net)
    x, y = resnet_images(3 * 16, 32, 10, seed=93)
    for i in range(0, 48, 16):
        net.fit(DataSet(x[i:i + 16], y[i:i + 16]), batch_size=16)
    p1, s1 = to_jax_params(net), to_jax_state(net)
    same = all(np.array_equal(p1[k][n], p0[k][n]) for k in ("1", "2")
               for n in p0[k]) and all(
        np.array_equal(s1[k][n], s0[k][n]) for k in s0 for n in s0[k])
    moved = not np.array_equal(p1["0"]["W"], p0["0"]["W"])
    fails.check(same and moved, f"FrozenLayer in training: frozen params "
                f"and state bit-equal {same}, trained conv moved {moved}")
    return dict(frozen_bit_equal=same, trained_moved=moved)


def phase_layers_rest(device, report, fails, small=False):
    """Phase 13 on `device` (fp32 with TF32 off unless an arm says
    mixed_bf16): (a) YOLOv2, (b) the MoE LM and MultiHeadAttention with
    n_out != n_in, (c) VAE, DBN and AutoEncoder pretraining on the
    digits, (d) the other new layers card vs CPU. `small` (the CPU
    rehearsal) shrinks the nets and keeps the checks. Returns the port's
    kernel launches of the phase."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    yc = YOLO_SMALL if small else YOLO
    mc = MOE_SMALL if small else MOE
    cfg = (dict(MOE_LM, d_model=64, n_layers=2, max_len=64, hidden=128,
                vocab=64) if small else MOE_LM)
    out = {}
    t0 = time.perf_counter()
    K.reset_launches()
    out["yolo"] = dict(check=_yolo_card_vs_cpu(device, fails, yc),
                       **_yolo_timed(device, fails, yc, small))
    out["moe_lm"] = dict(check=_moe_card_vs_cpu(device, fails, cfg, mc),
                         **_moe_timed(device, fails, cfg, mc, small))
    out["mha_n_out"] = _mha_wide(device, fails, small)
    Xt, Yt, Xh, Yh = _digits_flat()
    if small:
        Xt, Yt = Xt[:256], Yt[:256]
    out["vae"] = _vae_arm(device, fails, Xt, Xh, small)
    out["dbn"] = _dbn_arm(device, fails, Xt, Yt, Xh, Yh, small)
    out["autoencoder"] = _ae_arm(device, fails, Xt)
    out["layers"] = _layers_card_vs_cpu(device, fails)
    out["frozen"] = _frozen_in_training(device, fails)
    if device.type == "cuda":
        torch.cuda.synchronize()
    total = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t0
    report["layers_rest"] = out
    _print_layers_rest(out)
    return total


def _print_layers_rest(out):
    y, k = out["yolo"], out["yolo"]["check"]
    print(f"[layers_rest] (a) YOLOv2 {k['size']}x{k['size']} "
          f"({k['params']} params): init {k['init_s']:.2f} s, card vs CPU "
          f"init {k['init_max_rel_err']:.3g}, output() "
          f"{k['output_max_rel_err']:.3g}, detections card "
          f"{k['detections_card']} CPU {k['detections_cpu']} apart "
          f"{k['detections_apart']} (eps {k['detection_eps']:.3g}); "
          f"{k['steps']} steps at batch {k['B']}: step 0 loss rel "
          f"{k['step0_rel_err']:.3g}, distances {k['distances']}; mixed "
          f"step 0 rel {y['mixed_step0_rel']:.3g}", flush=True)
    for tag in ("float32", "mixed_bf16"):
        t = y[tag]
        print(f"[layers_rest] YOLOv2 {tag} batch {t['B']}, {t['steps']} "
              f"steps after {t['warmup']}: {t['ms_per_step']:.2f} ms/step, "
              f"{t['images_per_s']:.1f} images/s, peak {t['peak_mem_gb']} "
              f"GB, loss {t['loss_first']:.4f} -> {t['loss_last']:.4f}",
              flush=True)
    m, k = out["moe_lm"], out["moe_lm"]["check"]
    print(f"[layers_rest] (b) MoE LM ({k['params']} params) card vs CPU at "
          f"batch {k['B']}: output() {k['output_max_abs_err']:.3g}, "
          f"selection apart {k['selection_apart_tokens']} of {k['tokens']} "
          f"tokens, fractions err {k['fraction_max_err']:.3g}; step 0 rel "
          f"{k['step0_rel_err']:.3g}, distances {k['distances']}, aux card "
          f"{k['aux_card']} CPU {k['aux_cpu']} noisy {k['aux_cpu_noisy']}; "
          f"expert fractions (CPU) "
          f"{[[round(f, 3) for f in fr] for fr in k['expert_fractions_cpu']]}",
          flush=True)
    for tag in ("float32", "mixed_bf16"):
        t = m[tag]
        print(f"[layers_rest] MoE LM {tag} batch {t['B']}: "
              f"{t['ms_per_step']:.2f} ms/step, {t['tokens_per_s']:.1f} "
              f"tokens/s, peak {t['peak_mem_gb']} GB, loss "
              f"{t['loss_first']:.4f} -> {t['loss_last']:.4f}, launches "
              f"{ {k: v for k, v in t['launches'].items() if v} }",
              flush=True)
    print(f"[layers_rest] (b) MultiHeadAttention n_out != n_in "
          f"{out['mha_n_out']}", flush=True)
    v = out["vae"]
    print(f"[layers_rest] (c) VAE ({v['params']} params): Sgd twin ELBO card "
          f"vs CPU rel {v['sgd_elbo_max_rel_err']:.3g} over "
          f"{v['steps_check']} steps ({v['sgd_elbo_cpu'][0]:.3f} -> "
          f"{v['sgd_elbo_cpu'][-1]:.3f}); RmsProp step 0 rel "
          f"{v['step0_rel_err']:.3g}, distances {v['distances']}, ELBO "
          f"{v['loss_cpu'][0]:.3f} -> {v['loss_cpu'][-1]:.3f}; "
          f"{v['timed_epochs']} epochs {v['ms_per_step']:.3f} ms/step "
          f"(ELBO {v['elbo_timed_first']:.3f} -> {v['elbo_timed_last']:.3f})"
          f"; held-out log p(x) {v['recon_logp_mean']:.3f}, card vs CPU rel "
          f"{v['recon_logp_max_rel_err']:.3g}", flush=True)
    d = out["dbn"]
    print(f"[layers_rest] (c) DBN ({d['params']} params): step-0 flips "
          f"{d['flips_step0']}; after pretrain free energy "
          f"{d['free_energy']} (card vs CPU {d['free_energy_dist']:.3g}, "
          f"CPU vs noisy {d['free_energy_self']:.3g}), params "
          f"{d['params_rel']:.3g} (noisy {d['params_self']:.3g}); pretrain "
          f"{d['pretrain_s']:.2f} s; fit {d['fit_epochs']} epochs "
          f"{d['fit_s']:.2f} s, held-out accuracy {d['held_out_accuracy']}",
          flush=True)
    a = out["autoencoder"]
    print(f"[layers_rest] (c) AutoEncoder graph pretrain: step 0 rel "
          f"{a['step0_rel_err']:.3g}, distances {a['distances']}",
          flush=True)
    print(f"[layers_rest] (d) layers card vs CPU {out['layers']}; frozen "
          f"{out['frozen']}", flush=True)
    print(f"[layers_rest] launches {out['launches']}; phase seconds "
          f"{out['seconds']:.1f}", flush=True)


# ------------------------------------------------ phase 14: the runtime
# (a) the long-context LM's runtime arm: 32 windows, batches of 8,
# shuffled by one seeded stream, 4 epochs = 16 steps; checkpoints every
# 4 steps, a kill at step 10
RUNTIME = dict(B=8, windows=32, epochs=4, spe=4, every=4, kill_at=10,
               remat_steps=3)
RUNTIME_SMALL = dict(B=2, windows=8, epochs=4, spe=4, every=4, kill_at=10,
                     remat_steps=2)
RUNTIME_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
                   "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                   "fused_adam")
# (b) beam search on the smoke LM and the committed char-LM
BEAM = dict(B=4, prompt=64, tokens=32, width=4, char_B=4, char_prompt=50,
            char_tokens=64)
BEAM_SMALL = dict(B=2, prompt=8, tokens=6, width=3, char_B=2,
                  char_prompt=10, char_tokens=8)
# a beam's summed log-probability card vs CPU (32 tokens, fp32, TF32
# off): the beams of a row are equal, or the card's beams re-scored on
# the CPU are within this of the CPU's (a near-tie, counted)
BEAM_ATOL = 1e-3
# the char-LM's beam scores card vs CPU: CHAR_LM_ATOL a token (a score
# sums n_tokens log-probabilities)
CHAR_LENGTH_PENALTY = 0.6
# (c) the solvers on LeNet, (d) early stopping on the packaged LeNet
SOLVER = dict(B=128, batches=3, iters=5)
SOLVER_SMALL = dict(B=16, batches=2, iters=2)
SOLVER_ATOL = 1e-5       # iteration 0's loss, card vs CPU
ES = dict(B=128, max_epochs=5, patience=2, lr=0.1, interrupt_after=2)
ES_SMALL = dict(B=64, max_epochs=3, patience=2, lr=0.1, interrupt_after=1)
ES_ATOL = 1e-5           # the best held-out score, card vs CPU
FORMAT_ATOL = 1e-5       # (e) outputs and losses card vs CPU


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _runtime_iter(X, Y, B):
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    return ArrayDataSetIterator(X, Y, batch_size=B, shuffle=True, seed=14)


def _state_diff(a, b):
    """The names of the params and Adam moments of two nets that are not
    bit-equal, and whether the counters agree."""
    import torch
    bad = []
    for (key, la), (_, lb) in zip(a.keyed(), b.keyed()):
        for name, t in la.jax_param_map().items():
            if not torch.equal(t, lb.jax_param_map()[name]):
                bad.append(f"{key}/{name}")
    for key, lst in a.updater_state.items():
        for name, st in lst.items():
            for slot, t in st.items():
                if not torch.equal(t, b.updater_state[key][name][slot]):
                    bad.append(f"{key}/{name}/{slot}")
    same = (a.iteration_count == b.iteration_count
            and a.epoch_count == b.epoch_count)
    return bad, same


def _lm_runtime_arm(device, fails, cfg, c, policy, params, small):
    """(a) one dtype: 16 steps at spe 1 (the reference) and at spe 4, the
    interrupted run with its checkpoints, the resume, the fallback past
    a corrupted newest checkpoint, and the three remat policies. Returns
    (numbers, remat launches)."""
    import shutil
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import fault
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    tag = policy or "float32"
    X, Y = lm_corpus(cfg, c["windows"], seed=14)
    E, B = c["epochs"], c["B"]
    n_steps = E * c["windows"] // B

    def build():
        return build_lm(cfg, device, params, lr=LONG_LR,
                        dtype_policy=policy)

    def fit(net, spe=1, listeners=()):
        it = _runtime_iter(X, Y, B)
        for listener in listeners:
            net.add_listener(listener)
        _sync(device)
        t0 = time.perf_counter()
        net.fit(it, epochs=E, steps_per_execution=spe)
        _sync(device)
        return time.perf_counter() - t0

    out = dict(steps=n_steps)
    warm = build()
    warm.fit(X[:B], Y[:B], batch_size=B, shuffle=False)
    # every gradient of one step, twice from the same state: the leaves
    # whose two results differ name a step that is not deterministic
    xs, ys = warm._features(X[:B]), warm._labels(Y[:B])
    grads = []
    for _ in range(2):
        _, g, _ = warm._loss_and_grads(lambda st: warm._loss_fn(
            xs, ys, train=True, rng=warm._step_key(0), new_state=st))
        grads.append({n: g[id(p)].clone()
                      for n, p in warm.named_parameters()})
    out["grad_rerun_differs"] = [n for n in grads[0]
                                 if not torch.equal(grads[0][n],
                                                    grads[1][n])]
    fails.check(not out["grad_rerun_differs"], f"runtime {tag}: a step's "
                f"gradients differ from run to run at "
                f"{out['grad_rerun_differs'][:6]}")
    del warm, grads, xs, ys
    # spe 1 and spe 4 in turns (A B B A): the first of each is compared
    ref = build()
    spe1 = [fit(ref)]
    grouped = build()
    spe4 = [fit(grouped, spe=c["spe"])]
    bad, same = _state_diff(ref, grouped)
    out["spe4_bit_equal"] = not bad and same
    fails.check(out["spe4_bit_equal"], f"runtime {tag}: spe {c['spe']} is "
                f"not bit-equal to spe 1 ({bad[:4]}, counters {same})")
    del grouped
    spe4.append(fit(build(), spe=c["spe"]))
    spe1.append(fit(build()))
    out["spe1_ms_per_step"] = [t / n_steps * 1e3 for t in spe1]
    out["spe4_ms_per_step"] = [t / n_steps * 1e3 for t in spe4]
    tmp = tempfile.mkdtemp(prefix="runtime_ckpt_")
    try:
        net, it = build(), _runtime_iter(X, Y, B)
        ck = fault.AsyncCheckpointer(tmp, keep_last=2)
        net.add_listener(fault.CheckpointListener(ck, frequency=c["every"],
                                                  iterator=it))
        net.add_listener(fault.PreemptionListener(c["kill_at"]))
        killed = False
        try:
            net.fit(it, epochs=E)
        except fault.SimulatedPreemption:
            killed = True
        ck.wait()
        out["checkpoints"] = ck.steps()
        out["checkpoint_write_s"], nbytes = ck.last_write
        out["checkpoint_mb"] = nbytes / 2 ** 20
        fails.check(killed and out["checkpoints"] == [4, 8],
                    f"runtime {tag}: killed {killed}, checkpoints "
                    f"{out['checkpoints']} (want [4, 8])")
        del net
        t0 = time.perf_counter()
        it2 = _runtime_iter(X, Y, B)
        resumed = MultiLayerNetwork.resume(tmp, device=device, iterator=it2)
        _sync(device)
        out["resume_s"] = time.perf_counter() - t0
        out["resumed_at"] = resumed.iteration_count
        fails.check(resumed.dtype.to_dict() == ref.dtype.to_dict(),
                    f"runtime {tag}: resumed under {resumed.dtype.to_dict()}")
        resumed.fit(it2, epochs=E - resumed.epoch_count)
        bad, same = _state_diff(ref, resumed)
        out["resume_bit_equal"] = not bad and same
        fails.check(out["resume_bit_equal"], f"runtime {tag}: the resumed "
                    f"run is not bit-equal to the uninterrupted one "
                    f"({bad[:4]}, counters {same})")
        del resumed
        fault.corrupt_checkpoint(tmp, mode="flip")
        it3 = _runtime_iter(X, Y, B)
        fallback = MultiLayerNetwork.resume(tmp, device=device, iterator=it3)
        out["fallback_at"] = fallback.iteration_count
        fallback.fit(it3, epochs=E - fallback.epoch_count)
        bad, same = _state_diff(ref, fallback)
        out["fallback_bit_equal"] = (out["fallback_at"] == 4 and not bad
                                     and same)
        fails.check(out["fallback_bit_equal"], f"runtime {tag}: after the "
                    f"newest checkpoint was corrupted, resumed at "
                    f"{out['fallback_at']} (want 4) and bit-equal "
                    f"{not bad and same} ({bad[:4]})")
        del fallback
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del ref
    # remat: 3 steps under each policy from the same params (the launches
    # here count the recompute and are reported apart)
    before = dict(K.LAUNCHES)
    nets, out["remat"] = {}, {}
    Xr, Yr = X[:B * c["remat_steps"]], Y[:B * c["remat_steps"]]
    for rp in ("none", "full", "dots_saveable"):
        net = build()
        for layer in net.layers:
            if type(layer).__name__ == "TransformerEncoderBlock":
                layer.remat_policy = rp
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.perf_counter()
        net.fit(Xr, Yr, batch_size=B, shuffle=False)
        _sync(device)
        out["remat"][rp] = dict(
            ms_per_step=(time.perf_counter() - t0) / c["remat_steps"] * 1e3,
            peak_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                     if device.type == "cuda" else None))
        nets[rp] = net
        if rp != "none":
            bad, _ = _state_diff(nets["none"], net)
            out["remat"][rp]["bit_equal"] = not bad
            fails.check(not bad, f"runtime {tag}: remat {rp} is not "
                        f"bit-equal to no remat ({bad[:4]})")
            del nets[rp]
    remat_launches = {k: K.LAUNCHES[k] - before.get(k, 0)
                      for k in K.LAUNCHES}
    for k, n in remat_launches.items():
        K.LAUNCHES[k] -= n
    return out, remat_launches


def _beam_rescore(net, prompt, seqs):
    """The summed log(clip(p, 1e-9)) of each of `seqs` [W, n] after
    `prompt` under `net` (one full forward each)."""
    import torch
    scores = []
    for seq in seqs:
        x = np.concatenate([prompt, seq])[None].astype(np.int64)
        with torch.no_grad():
            p = net.output(x)[0].float().cpu().numpy()
        rows = p[len(prompt) - 1:len(prompt) - 1 + len(seq)]
        lp = np.log(np.clip(rows[np.arange(len(seq)), seq], 1e-9, None))
        scores.append(float(lp.astype(np.float32).sum()))
    return np.asarray(scores)


def _beam_lm(device, fails, cfg, c):
    """(b) the smoke LM (random weights, head x8): beams card vs CPU by
    margin, beam_width 1 against greedy generate(), ms a token step."""
    from deeplearning4j_tpu_torch.zoo.transformer import (
        beam_search, generate)
    params = random_lm_params(cfg, seed=141, head_scale=8.0)
    card, cpu = (build_lm(cfg, d, params) for d in (device, "cpu"))
    prompts = np.random.default_rng(142).integers(
        0, cfg["vocab"], (c["B"], c["prompt"]))
    beam_search(card, prompts[:1], 2, beam_width=c["width"], device=device)
    _sync(device)
    t0 = time.perf_counter()
    ids, scores = beam_search(card, prompts, c["tokens"],
                              beam_width=c["width"], device=device)
    _sync(device)
    secs = time.perf_counter() - t0
    want_ids, want_scores = beam_search(cpu, prompts, c["tokens"],
                                        beam_width=c["width"], device="cpu")
    near, ok = 0, True
    for b in range(c["B"]):
        if np.array_equal(ids[b], want_ids[b]):
            err = float(np.abs(scores[b] - want_scores[b]).max())
            ok &= fails.check(err <= BEAM_ATOL, f"beam row {b}: scores "
                              f"card vs CPU {err} (tol {BEAM_ATOL})")
            continue
        got = np.sort(_beam_rescore(cpu, prompts[b], ids[b]))
        gap = float(np.abs(got - np.sort(want_scores[b])).max())
        near += 1
        ok &= fails.check(gap <= BEAM_ATOL, f"beam row {b}: the card's "
                          f"beams differ and re-score {gap} from the CPU's "
                          f"(tol {BEAM_ATOL})")
    one, _ = beam_search(card, prompts, c["tokens"], beam_width=1,
                         device=device)
    greedy = generate(card, prompts, c["tokens"], temperature=0.0)
    fails.check(np.array_equal(one[:, 0], greedy),
                "beam_width 1 is not greedy generate()'s stream")
    steps = c["tokens"] * c["B"] * c["width"]
    return dict(rows=c["B"], beams=c["width"], tokens=c["tokens"],
                near_ties=near, seconds=secs,
                ms_per_token_step=secs / c["tokens"] * 1e3,
                beam_tokens_per_s=steps / secs)


def _beam_char_lm(device, fails, c):
    """(b) the committed char-LM (sha256 checked): beams card vs CPU
    exactly (ids, scores within CHAR_BEAM_ATOL), with '.' as eos and the
    GNMT length penalty's ranking, against the raw ranking too."""
    from deeplearning4j_tpu_torch.zoo import (
        PretrainedType, TextGenerationLSTM)
    from deeplearning4j_tpu_torch.zoo.transformer import beam_search
    model = TextGenerationLSTM()
    card = model.init_pretrained(PretrainedType.TEXT, device=device)
    cpu = model.init_pretrained(PretrainedType.TEXT, device="cpu")
    charset = TextGenerationLSTM.pretrained_charset()
    eos = charset.index(".") if "." in charset else 0
    prompts = np.stack([char_ids(c["char_prompt"], offset=3000 + 700 * b)
                        for b in range(c["char_B"])])
    out = {}
    for lp in (0.0, CHAR_LENGTH_PENALTY):
        kw = dict(beam_width=4, eos_id=eos, length_penalty=lp)
        _sync(device)
        t0 = time.perf_counter()
        ids, scores = beam_search(card, prompts, c["char_tokens"],
                                  device=device, **kw)
        _sync(device)
        secs = time.perf_counter() - t0
        wids, wscores = beam_search(cpu, prompts, c["char_tokens"],
                                    device="cpu", **kw)
        err = float(np.abs(scores - wscores).max())
        same = bool(np.array_equal(ids, wids))
        tol = CHAR_LM_ATOL * c["char_tokens"]
        fails.check(same and err <= tol, f"char-LM beams (length_penalty "
                    f"{lp}) card vs CPU: ids equal {same}, scores {err} "
                    f"(tol {tol})")
        hits = np.cumsum(ids == eos, axis=2) > 0
        lengths = np.where(hits.any(2), hits.argmax(2) + 1,
                           c["char_tokens"])
        norm = scores / ((5.0 + lengths) / 6.0) ** lp
        fails.check(np.all(np.diff(norm, axis=1) <= 1e-6),
                    f"char-LM beams not ranked by the length-normalized "
                    f"score (length_penalty {lp})")
        best = "".join(charset[i] if i < len(charset) else "?"
                       for i in ids[0, 0])
        out[f"lp_{lp}"] = dict(max_abs_err=err, ids_equal=same,
                               seconds=secs, eos_hits=int(hits.any(2).sum()),
                               best=best)
    return out


def _digit_sets(small):
    X, Y = digits_28x28()
    Xh, Yh, Xt, Yt = (X[:N_HELD_OUT], Y[:N_HELD_OUT], X[N_HELD_OUT:],
                      Y[N_HELD_OUT:])
    if small:
        Xh, Yh, Xt, Yt = Xh[:64], Yh[:64], Xt[:256], Yt[:256]
    return Xh, Yh, Xt, Yt


def _solver_arm(device, fails, c, small):
    """(c) LeNet (bench.py:643-668) at batch c["B"] with each line-search
    algorithm for `iters` iterations over `batches` batches: iteration
    0's loss and the first iteration's, card vs CPU from the same
    params; the loss falls; ms a solver iteration."""
    from deeplearning4j_tpu_torch.zoo import LeNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    _, _, Xt, Yt = _digit_sets(small)
    B = c["B"]
    out = {}
    for algo in ("line_gradient_descent", "conjugate_gradient", "lbfgs"):
        conf = LeNet().conf()
        conf.optimization_algo, conf.max_iterations = algo, c["iters"]
        card = MultiLayerNetwork(conf, device=device).init()
        cpu = _copy_to(card, "cpu")
        cpu.conf.max_iterations = 1
        cpu.fit(Xt[:B], Yt[:B], batch_size=B, shuffle=False)
        want = cpu._solver.scores
        scores, iters = [], 0
        _sync(device)
        t0 = time.perf_counter()
        for i in range(c["batches"]):
            card.fit(Xt[i * B:(i + 1) * B], Yt[i * B:(i + 1) * B],
                     batch_size=B, shuffle=False)
            scores.append(list(card._solver.scores))
            iters += len(card._solver.scores) - 1
        _sync(device)
        secs = time.perf_counter() - t0
        err = max(abs(a - b) for a, b in zip(scores[0][:2], want[:2]))
        fails.check(err <= SOLVER_ATOL, f"{algo}: iterations 0-1 loss card "
                    f"vs CPU {err} (tol {SOLVER_ATOL})")
        fails.check(all(s[-1] < s[0] for s in scores),
                    f"{algo}: the loss did not fall within a batch "
                    f"({[(s[0], s[-1]) for s in scores]})")
        out[algo] = dict(iter0_err=err, scores=scores,
                         ms_per_iteration=secs / max(iters, 1) * 1e3)
    return out


def _es_arm(device, fails, c, small):
    """(d) the packaged LeNet through TransferLearning (conv stack frozen,
    the head re-drawn by n_out_replace, Sgd fine-tune), the digits
    standardized by NormalizerStandardize, EarlyStoppingTrainer with
    MaxEpochs and ScoreImprovement scored on the held-out digits: card
    against CPU, an interrupted run resumed, and the zip with the
    normalizer restored on the card."""
    import shutil
    import tempfile
    import torch
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.datasets import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        NormalizerStandardize)
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
    from deeplearning4j_tpu_torch.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet, PretrainedType
    Xh, Yh, Xt, Yt = _digit_sets(small)
    norm = NormalizerStandardize().fit(DataSet(Xt, Yt))
    Xt, Xh = norm.transform(Xt), norm.transform(Xh)
    base = LeNet().init_pretrained(PretrainedType.MNIST, device="cpu")

    def tl(dev):
        return (TransferLearning.Builder(base)
                .fine_tune_configuration(FineTuneConfiguration(
                    updater=Sgd(c["lr"])))
                .set_feature_extractor(3).n_out_replace(5, 10)
                .build(device=dev))

    def conf(max_epochs):
        return EarlyStoppingConfiguration(
            score_calculator=DataSetLossCalculator(ArrayDataSetIterator(
                Xh, Yh, batch_size=c["B"])),
            model_saver=InMemoryModelSaver(),
            epoch_termination_conditions=[
                MaxEpochsTerminationCondition(max_epochs),
                ScoreImprovementEpochTerminationCondition(c["patience"])])

    def data():
        return ArrayDataSetIterator(Xt, Yt, batch_size=c["B"], shuffle=True,
                                    seed=15)

    def run(dev, max_epochs=None, **kw):
        net = tl(dev)
        trainer = EarlyStoppingTrainer(
            conf(max_epochs or c["max_epochs"]), net, data(), device=dev,
            **{k: v for k, v in kw.items() if k == "checkpointer"})
        return net, trainer.fit(**{k: v for k, v in kw.items()
                                   if k == "resume"})

    net = tl(device)
    frozen = [type(l).__name__ for l in net.layers]
    fails.check(frozen[:4] == ["FrozenLayer"] * 4, f"TL layers {frozen}")
    _sync(device)
    t0 = time.perf_counter()
    _, res = run(device)
    _sync(device)
    secs = time.perf_counter() - t0
    _, cres = run("cpu")
    err = abs(res.best_model_score - cres.best_model_score)
    fails.check(res.best_model_epoch == cres.best_model_epoch
                and err <= ES_ATOL, f"early stopping card vs CPU: best "
                f"epoch {res.best_model_epoch} vs {cres.best_model_epoch}, "
                f"best score {err} apart (tol {ES_ATOL})")
    acc = res.best_model.evaluate(DataSet(Xh, Yh)).accuracy()
    tmp = tempfile.mkdtemp(prefix="runtime_es_")
    try:
        _, r1 = run(device, max_epochs=c["interrupt_after"],
                    checkpointer=os.path.join(tmp, "ckpt"))
        _, r2 = run(device, checkpointer=os.path.join(tmp, "ckpt"),
                    resume=True)
        fails.check(r2.best_model_epoch == res.best_model_epoch
                    and r2.best_model_score == res.best_model_score
                    and r2.total_epochs == res.total_epochs,
                    f"early stopping resumed after {r1.total_epochs} "
                    f"epochs: best epoch {r2.best_model_epoch}, score "
                    f"{r2.best_model_score}, epochs {r2.total_epochs} vs "
                    f"{res.best_model_epoch}, {res.best_model_score}, "
                    f"{res.total_epochs}")
        path = os.path.join(tmp, "best.zip")
        ModelSerializer.write_model(res.best_model, path)
        ModelSerializer.add_normalizer_to_model(path, norm)
        back = ModelSerializer.restore_model(path, device=device)
        bnorm = ModelSerializer.restore_normalizer_from_file(path)
        Xr = bnorm.transform(_digit_sets(small)[0])
        same = torch.equal(back.output(Xr), res.best_model.output(Xh))
        fails.check(same and np.array_equal(Xr, Xh), "the zip with the "
                    "normalizer did not restore the best model's output")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(best_epoch=res.best_model_epoch,
                best_score=res.best_model_score, cpu_best_score=
                cres.best_model_score, score_err=err,
                total_epochs=res.total_epochs,
                reason=res.termination_reason.value,
                scores={str(k): v for k, v in res.score_vs_epoch.items()},
                held_out_accuracy=acc, seconds=secs,
                normalizer_mean=float(norm.mean.reshape(-1)[0]),
                normalizer_std=float(norm.std.reshape(-1)[0]))


def _format_arm(device, fails, small):
    """(e) NCHW on LeNet and a two-input graph over a MultiDataSet, card
    vs CPU."""
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.datasets.multidataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.zoo import LeNet
    Xh, Yh, Xt, Yt = _digit_sets(small)
    B = 32 if small else 128
    x = np.transpose(Xt[:B], (0, 3, 1, 2)).copy()
    card = LeNet(updater=Sgd(0.05)).init(device=device)
    cpu = _copy_to(card, "cpu")
    got = card.output(x, data_format="NCHW").cpu().numpy()
    err = float(np.abs(got - cpu.output(x, data_format="NCHW").numpy()
                       ).max())
    native = float(np.abs(got - card.output(Xt[:B]).cpu().numpy()).max())
    card.fit(x, Yt[:B], batch_size=B, data_format="NCHW", shuffle=False)
    cpu.fit(x, Yt[:B], batch_size=B, data_format="NCHW", shuffle=False)
    lerr = abs(card.score_value - cpu.score_value)
    fails.check(err <= FORMAT_ATOL and native == 0.0 and lerr <= FORMAT_ATOL,
                f"NCHW LeNet card vs CPU: output {err}, vs native {native},"
                f" loss {lerr} (tol {FORMAT_ATOL})")
    g = ComputationGraphConfiguration.graph_builder(
        NeuralNetConfiguration.builder().seed(2).updater(Sgd(0.1)))
    g.add_inputs("pixels", "mean_row")
    g.add_vertex("merged", MergeVertex(), "pixels", "mean_row")
    g.add_layer("hidden", DenseLayer(n_in=784 + 28, n_out=256,
                                     activation="relu"), "merged")
    g.add_layer("digit", OutputLayer(n_in=256, n_out=10,
                                     activation="softmax", loss="mcxent"),
                "hidden")
    g.add_layer("ink", OutputLayer(n_in=256, n_out=1,
                                   activation="identity", loss="mse"),
                "hidden")
    g.set_outputs("digit", "ink")
    gconf = g.build()
    flat = Xt.reshape(len(Xt), -1)
    mds = [MultiDataSet(features=[flat[i:i + B], Xt[i:i + B].mean(2)[..., 0]],
                        labels=[Yt[i:i + B], flat[i:i + B].mean(1,
                                                              keepdims=True)])
           for i in range(0, 3 * B, B)]
    nets = [ComputationGraph(gconf, device=d).init() for d in (device,
                                                                "cpu")]
    for net in nets:
        net.fit(mds)
    gerr = max(float(np.abs(a.detach().cpu().numpy()
                            - b.detach().numpy()).max())
               for (_, a), (_, b) in zip(nets[0].param_table().items(),
                                         nets[1].param_table().items()))
    fails.check(gerr <= FORMAT_ATOL, f"two-input graph over MultiDataSet "
                f"card vs CPU params {gerr} (tol {FORMAT_ATOL})")
    return dict(nchw_output_err=err, nchw_loss_err=lerr,
                graph_param_err=gerr, graph_steps=nets[0].iteration_count)


def phase_runtime(device, report, fails, small=False):
    """Phase 14 on `device` (fp32 with TF32 off unless an arm is
    mixed_bf16): (a) the long-context LM's training runtime, (b)
    beam_search, (c) the line-search solvers, (d) early stopping,
    transfer learning and the normalizer, (e) NCHW and a MultiDataSet
    graph. `small` (the CPU rehearsal) shrinks the nets and data and
    keeps the checks. Returns the port's kernel launches of the phase,
    remat's recompute launches left out (reported apart)."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    c = RUNTIME_SMALL if small else RUNTIME
    cfg = (dict(LM_LONG, vocab=64, d_model=64, n_layers=2, max_len=64)
           if small else LM_LONG)
    bc = BEAM_SMALL if small else BEAM
    beam_cfg = dict(LM, n_layers=2, max_len=128) if small else LM
    out = dict(config=dict(cfg, B=c["B"], T=cfg["max_len"] - 1,
                           lr=LONG_LR))
    t0 = time.perf_counter()
    # torch.utils.checkpoint's first call loads its machinery (about 7 s
    # on the card's machine): once here, outside the timed remat steps
    x = torch.zeros(2, device=device, requires_grad=True)
    torch.utils.checkpoint.checkpoint(lambda a: (a * 2).sum(), x,
                                      use_reentrant=False).backward()
    out["checkpoint_first_call_s"] = time.perf_counter() - t0
    K.reset_launches()
    params = random_lm_params(cfg, seed=140, head_scale=1.0)
    out["lm"], remat = {}, {}
    for policy in (None, MIXED):
        tag = policy or "float32"
        out["lm"][tag], rl = _lm_runtime_arm(device, fails, cfg, c, policy,
                                             params, small)
        remat[tag] = {k: v for k, v in rl.items() if v}
    out["remat_launches"] = remat
    lm_launches = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    if device.type == "cuda":
        for k in RUNTIME_KERNELS:
            fails.check(lm_launches[k] > 0, f"runtime: kernel {k} did not "
                        f"launch on the long-context LM")
    out["beam_lm"] = _beam_lm(device, fails, beam_cfg, bc)
    out["beam_char_lm"] = _beam_char_lm(device, fails, bc)
    out["solvers"] = _solver_arm(device, fails,
                                 SOLVER_SMALL if small else SOLVER, small)
    out["early_stopping"] = _es_arm(device, fails,
                                    ES_SMALL if small else ES, small)
    out["formats"] = _format_arm(device, fails, small)
    _sync(device)
    total = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    out["launches"], out["lm_launches"] = total, lm_launches
    out["seconds"] = time.perf_counter() - t0
    report["runtime"] = out
    _print_runtime(out)
    return total


def _print_runtime(out):
    for tag, a in out["lm"].items():
        rm = " ".join(f"{k} {v['ms_per_step']:.1f} ms {v['peak_gb']} GB"
                      f"{'' if k == 'none' else ' bit-equal ' + str(v['bit_equal'])}"
                      for k, v in a["remat"].items())
        print(f"[runtime] (a) LM {tag} [{out['config']['B']}, "
              f"{out['config']['T']}]: grads rerun differ at "
              f"{a['grad_rerun_differs'][:4]}; ms/step in turns spe1 "
              f"{a['spe1_ms_per_step'][0]:.1f}, spe4 "
              f"{a['spe4_ms_per_step'][0]:.1f}, spe4 "
              f"{a['spe4_ms_per_step'][1]:.1f}, spe1 "
              f"{a['spe1_ms_per_step'][1]:.1f} (bit-equal "
              f"{a['spe4_bit_equal']}); checkpoints "
              f"{a['checkpoints']} write {a['checkpoint_write_s']:.3f} s "
              f"{a['checkpoint_mb']:.1f} MB; resume {a['resume_s']:.3f} s "
              f"at {a['resumed_at']} bit-equal {a['resume_bit_equal']}; "
              f"fallback at {a['fallback_at']} bit-equal "
              f"{a['fallback_bit_equal']}; remat: {rm}", flush=True)
    b = out["beam_lm"]
    print(f"[runtime] (b) beam LM {b['rows']}x{b['beams']} beams "
          f"{b['tokens']} tokens: {b['ms_per_token_step']:.2f} ms a token "
          f"step, {b['beam_tokens_per_s']:.0f} beam tokens/s, near-ties "
          f"{b['near_ties']}", flush=True)
    for k, v in out["beam_char_lm"].items():
        print(f"[runtime] (b) char-LM beams {k}: ids equal {v['ids_equal']}"
              f", max err {v['max_abs_err']:.2e}, {v['seconds']:.3f} s, "
              f"eos beams {v['eos_hits']}, best {v['best']!r}", flush=True)
    for k, v in out["solvers"].items():
        print(f"[runtime] (c) {k}: iter-0 err {v['iter0_err']:.2e}, "
              f"{v['ms_per_iteration']:.1f} ms/iteration, losses "
              f"{[(round(s[0], 4), round(s[-1], 4)) for s in v['scores']]}",
              flush=True)
    e = out["early_stopping"]
    print(f"[runtime] (d) early stopping: best epoch {e['best_epoch']} "
          f"score {e['best_score']:.6f} (CPU {e['cpu_best_score']:.6f}), "
          f"{e['total_epochs']} epochs ({e['reason']}), held-out accuracy "
          f"{e['held_out_accuracy']:.4f}, {e['seconds']:.1f} s", flush=True)
    f = out["formats"]
    print(f"[runtime] (e) NCHW output err {f['nchw_output_err']:.2e}, loss "
          f"err {f['nchw_loss_err']:.2e}; MultiDataSet graph param err "
          f"{f['graph_param_err']:.2e}; remat launches "
          f"{out['remat_launches']}; phase {out['seconds']:.1f} s",
          flush=True)


# ------------------------------------------------- --profile: time breakdown
def _profile_summary(prof, wall_ms, top=12):
    rows = []
    for ev in prof.key_averages():
        # device-side kernel events only: a CPU op (aten::mm) also
        # carries the device time of the kernels it launched
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {}
    for name, ms, _ in rows:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                launches=int(sum(r[2] for r in rows)),
                groups_ms=dict(sorted(groups.items(), key=lambda g: -g[1])),
                top=[dict(name=n[:90], ms=ms, count=c)
                     for n, ms, c in rows[:top]])


def _kernel_group(name: str) -> str:
    """The part of a step a kernel event belongs to, from its name: the
    port's own kernels by their entry names; cuDNN's convolutions (their
    forward, data- and weight-gradient kernels, implicit GEMMs included)
    and the layout transposes it may put around them; batch norm;
    pooling (PyTorch's max and avg pool kernels); cumsum (PyTorch's scan
    kernel: LRN's window sums in the CNN zoo); the channel
    concatenations of a graph's merges; copies; library GEMMs by
    cuBLAS's and CUTLASS's names; the rest elementwise and reductions
    (LRN's pow and divide among them, so `_lrn_ms` times the layer
    apart)."""
    n = name.lower()
    for key, group in (("flash_fwd", "flash forward"),
                       ("flash_bwd_dq", "flash dQ"),
                       ("flash_bwd_dkv", "flash dK/dV"),
                       ("ln_warp", "layernorm"), ("ln_block", "layernorm"),
                       ("adam_kernel", "fused adam"),
                       ("nchwtonhwc", "layout transposes"),
                       ("nhwctonchw", "layout transposes"),
                       ("max_pool", "pooling"), ("avg_pool", "pooling"),
                       ("scan_innermost", "cumsum"),
                       ("catarray", "merge copies")):
        if key in n:
            return group
    if "batch_norm" in n or "batchnorm" in n or "bn_" in n:
        return "batchnorm"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                            "cudnn", "winograd")):
        return "conv"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "gemm"
    return "other"


def _profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall)


def _train_step_phases(net, X, Y, repeats=5):
    """Median ms of the parts of one `fit` step (as `_fit_step` runs
    them), each ended by a synchronize, so a part counts the longer of
    its host and its device work: batch (iterator slice, id checks,
    host-to-device copies), forward + loss, backward, update."""
    import torch
    from deeplearning4j_tpu_torch.datasets import as_iterator
    rows = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        ds = next(iter(as_iterator(X, Y, batch_size=len(X), shuffle=False)))
        x, y = net._features(ds.features), net._labels(ds.labels)
        mark()
        params = list(net.parameters())
        try:
            for p in params:
                p.requires_grad_(True)
            loss = net._loss_fn(x, y)
            mark()
            loss.backward()
            mark()
            net._apply_updates(net.iteration_count)
            mark()
        finally:
            for p in params:
                p.requires_grad_(False)
                p.grad = None
        rows.append(np.diff(marks) * 1e3)
    med = np.median(rows, axis=0)
    return dict(zip(("batch_ms", "forward_loss_ms", "backward_ms",
                     "update_ms"), map(float, med)))


def profile_paths(device):
    """Where the time goes: torch.profiler over (1) `output()` on
    [16, 512] ids, (2) one 8-wide admission wave of 128-token prompts,
    (3) 32 decode dispatches of the paged engine with 8 active slots,
    and the same under `mixed_bf16` and with int8 weights, and 8
    speculative (k = 4) dispatches,
    (4) one `fit` step (Adam) on [16, 511] windows, with the step's
    parts timed apart (`_train_step_phases`), and (5) one long-context
    `fit` step at [8, 2048] through the 4-way ring and (6) locally,
    and (7) `restore_model` of the LM's zip followed by one `fit` step
    at [8, 511], and (8) one ResNet-50 `fit` step at phase 10's batch
    128 of 224x224 images, fp32 and mixed_bf16, and (9) one char-RNN
    TBPTT iteration at phase 11's [64, 100], fp32 and mixed_bf16, and
    (10) phase 12's LeNet (batch 128), GoogLeNet (batch 128, its LRN
    timed apart) and VGG16 (batch 64) `fit` steps, fp32 and mixed_bf16.
    Per path: host wall ms,
    summed device ms of the kernels seen (one stream, so kernels do not
    overlap), busy share = device / wall, launches, device ms by part
    (`_kernel_group`), and the kernels with the most device time."""
    import torch
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    net = build_lm(LM, device, random_lm_params(LM, 1234, 4.0))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, LM["vocab"], (16, 512))
    net.output(ids)                                   # build + warm
    out = {"scoring_output_16x512": _profiled(lambda: net.output(ids))}
    eng = PagedDecodeEngine(net, n_slots=8, block_len=16,
                            n_blocks=8 * 32 + 1, device=device)
    reqs = [dict(prompt_ids=rng.integers(0, LM["vocab"], 128),
                 n_tokens=40) for _ in range(8)]
    eng.admit_many(reqs)                              # warm
    while eng.active.any():
        eng.step()
    out["serving_prefill_wave_8x128"] = _profiled(
        lambda: eng.admit_many(reqs))
    out["serving_decode_32_dispatches_8_slots"] = _profiled(
        lambda: [eng.step() for _ in range(32)])
    # phase 8's decode modes: mixed_bf16, int8, and k=4 speculation
    mixed = build_lm(LM, device, random_lm_params(LM, 1234, 4.0),
                     dtype_policy=MIXED)
    for tag, n, kw, n_disp in (
            ("mixed_bf16", mixed, {}, 32), ("int8", net,
                                            dict(quantize="int8"), 32),
            ("spec_k4", net, dict(speculative=4), 8)):
        e = PagedDecodeEngine(n, n_slots=8, block_len=16,
                              n_blocks=8 * 32 + 1, device=device, **kw)
        e.admit_many(reqs)                            # warm
        while e.active.any():
            e.step()
        e.admit_many(reqs)
        out[f"serving_decode_{n_disp}_dispatches_8_slots_{tag}"] = \
            _profiled(lambda: [e.step() for _ in range(n_disp)])
    del mixed
    X, Y = lm_corpus(LM, 32, seed=6)
    train = build_lm(LM, device, random_lm_params(LM, 4321, 1.0))
    train.fit(X[:16], Y[:16], batch_size=16, shuffle=False)        # warm
    out["training_step_16x511"] = _profiled(
        lambda: train.fit(X[16:], Y[16:], batch_size=16, shuffle=False))
    out["training_step_16x511"]["phases"] = _train_step_phases(
        train, X[16:], Y[16:])
    del train
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, make_mesh, sequence_sharding)
    mesh = make_mesh(MeshSpec.of(seq=SEQ_P), devices=[device] * SEQ_P)
    T = LM_LONG["max_len"]
    X, Y = lm_corpus(LM_LONG, 16, seed=8, T=T)
    long = build_lm(LM_LONG, device, random_lm_params(LM_LONG, 8642, 1.0),
                    sequence_parallel="ring", lr=LONG_LR)
    with sequence_sharding(mesh):
        long.fit(X[:8], Y[:8], batch_size=8, shuffle=False)      # warm
        out[f"training_step_ring_8x{T}"] = _profiled(
            lambda: long.fit(X[8:], Y[8:], batch_size=8, shuffle=False))
    long.fit(X[:8], Y[:8], batch_size=8, shuffle=False)          # warm
    out[f"training_step_local_8x{T}"] = _profiled(
        lambda: long.fit(X[8:], Y[8:], batch_size=8, shuffle=False))
    del long
    # the same two training steps under mixed_bf16
    X, Y = lm_corpus(LM, 32, seed=6)
    train = build_lm(LM, device, random_lm_params(LM, 4321, 1.0),
                     dtype_policy=MIXED)
    train.fit(X[:16], Y[:16], batch_size=16, shuffle=False)        # warm
    out["training_step_16x511_mixed"] = _profiled(
        lambda: train.fit(X[16:], Y[16:], batch_size=16, shuffle=False))
    del train
    X, Y = lm_corpus(LM_LONG, 16, seed=8, T=T)
    long = build_lm(LM_LONG, device, random_lm_params(LM_LONG, 8642, 1.0),
                    lr=LONG_LR, dtype_policy=MIXED)
    long.fit(X[:8], Y[:8], batch_size=8, shuffle=False)          # warm
    out[f"training_step_local_8x{T}_mixed"] = _profiled(
        lambda: long.fit(X[8:], Y[8:], batch_size=8, shuffle=False))
    # (7) the bridge: restore the smoke LM's zip, then one `fit` step
    import tempfile
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    X, Y = lm_corpus(LM, 16, seed=6)
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        path = os.path.join(tmp, "lm.zip")
        ModelSerializer.write_model(
            build_lm(LM, device, random_lm_params(LM, 1234, 4.0)), path)
        ModelSerializer.restore_model(path, device=device).fit(
            X[:8], Y[:8], batch_size=8, shuffle=False)          # warm
        out["bridge_restore_and_step_8x511"] = _profiled(
            lambda: ModelSerializer.restore_model(path, device=device).fit(
                X[8:], Y[8:], batch_size=8, shuffle=False))
    # (8) ResNet-50 (phase 10's configuration), one `fit` step at batch
    # 128 on the resident batch, fp32 and mixed_bf16
    from deeplearning4j_tpu_torch.datasets import DataSet
    c = RESNET
    x, y = resnet_images(c["B"], c["size"], c["classes"], seed=23)
    ds = DataSet(torch.from_numpy(x).to(device),
                 torch.from_numpy(y).to(device))
    for tag, policy in (("", None), ("_mixed", MIXED)):
        net = build_resnet(device, c["size"], c["classes"],
                           dtype_policy=policy)
        for _ in range(2):
            net.fit(ds, batch_size=c["B"])                        # warm
        out[f"resnet50_step_{c['B']}x{c['size']}{tag}"] = _profiled(
            lambda: net.fit(ds, batch_size=c["B"]))
        del net
    # (9) the char-RNN (phase 11's TextGenerationLSTM), one TBPTT
    # iteration at [64, 100] (two chunks), fp32 and mixed_bf16
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    X, Y = char_windows(CHAR["B"], CHAR["T"], offset=7)
    ds = DataSet(torch.from_numpy(X).to(device),
                 torch.from_numpy(Y).to(device))
    for tag, policy in (("", None), ("_mixed", MIXED)):
        net = TextGenerationLSTM().init(device=device, dtype_policy=policy)
        for _ in range(2):
            net.fit(ds, batch_size=CHAR["B"])                      # warm
        out[f"char_rnn_iteration_{CHAR['B']}x{CHAR['T']}{tag}"] = _profiled(
            lambda: net.fit(ds, batch_size=CHAR["B"]))
        del net
    # (10) phase 12's LeNet, GoogLeNet and VGG16, one `fit` step each,
    # fp32 and mixed_bf16, GoogLeNet's LRN layers timed apart
    out.update(profile_cnn_zoo(device))
    # (11) phase 13's YOLOv2 and MoE LM steps, their loss and MoE apart
    out.update(profile_layers_rest(device))
    _print_profile(out)
    return out


def _print_profile(out):
    for k, v in out.items():
        groups = ", ".join(f"{g} {ms:.3f}" for g, ms in v["groups_ms"].items())
        print(f"[profile] {k}: wall {v['wall_ms']:.3f} ms, device "
              f"{v['device_ms']:.3f} ms, busy {v['busy_share']:.3f}, "
              f"launches {v['launches']}; device ms by part: {groups}",
              v.get("phases", ""),
              f"LRN forward+backward apart {v['lrn_ms']:.3f} ms"
              if "lrn_ms" in v else "",
              f"loss forward+backward apart {v['loss_ms']:.3f} ms"
              if "loss_ms" in v else "",
              f"MoE layers forward+backward apart {v['moe_ms']:.3f} ms"
              if "moe_ms" in v else "", flush=True)


def _lrn_ms(device, shapes, dtype):
    """Device ms of one LRN forward and backward at each shape (CUDA
    events, `timer`), summed: the LRN share of a step, which the kernel
    names cannot tell apart from other elementwise work."""
    import torch
    from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization
    lrn, total = LocalResponseNormalization(), 0.0
    for shape in shapes:
        x = torch.randn(shape, device=device, dtype=dtype,
                        requires_grad=True)
        g = torch.randn(shape, device=device, dtype=dtype)
        total += timer(device, lambda: lrn(x).backward(g), iters=10)
    return total


def profile_cnn_zoo(device):
    """Phase 12's timed steps under the profiler (`_profiled`), fp32 and
    mixed_bf16: one LeNet `fit` step at batch 128 of the digits, one
    GoogLeNet step at batch 128 of 224x224 images with `lrn_ms` (its two
    stem LRN layers' forward and backward timed apart), one VGG16 step
    at batch 64 (at VGG_LR)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import LeNet, PretrainedType
    X, Y = digits_28x28()
    X3, Y3 = (torch.from_numpy(a).to(device) for a in digit_batches(
        X[N_HELD_OUT:], Y[N_HELD_OUT:], 128, 3, seed=14))
    lenet = [DataSet(X3[i:i + 128], Y3[i:i + 128]) for i in (0, 128, 256)]
    out = {}
    for tag, policy, dt in (("", None, torch.float32),
                            ("_mixed", MIXED, torch.bfloat16)):
        net = _copy_to(LeNet().init_pretrained(PretrainedType.MNIST,
                                               device=device),
                       device, policy)
        for ds in lenet[:2]:
            net.fit(ds, batch_size=128)                           # warm
        out[f"lenet_step_128x28{tag}"] = _profiled(
            lambda: net.fit(lenet[2], batch_size=128))
        for name, B, lr in (("GoogLeNet", 128, None), ("VGG16", 64, VGG_LR)):
            x, y = resnet_images(B, 224, 1000, seed=43)
            ds = DataSet(torch.from_numpy(x).to(device),
                         torch.from_numpy(y).to(device))
            net = _zoo_init(_zoo_model(name, {}), device, lr, policy)
            for _ in range(2):
                net.fit(ds, batch_size=B)                         # warm
            p = _profiled(lambda: net.fit(ds, batch_size=B))
            if name == "GoogLeNet":
                p["lrn_ms"] = _lrn_ms(device, [(B, 56, 56, 64),
                                               (B, 56, 56, 192)], dt)
            out[f"{name.lower()}_step_{B}x224{tag}"] = p
            del net
            torch.cuda.empty_cache()
    return out


def profile_layers_rest(device):
    """Phase 13's timed steps under the profiler (`_profiled`), fp32 and
    mixed_bf16: one YOLOv2 `fit` step at 608 and batch 8, with its loss
    (the Yolo2 layer's compute_loss forward and backward) timed apart,
    and one MoE LM step at [16, 511], with one MixtureOfExperts layer's
    forward and backward timed apart (x 4 layers: "MoE apart"; its
    einsums are cuBLAS GEMMs by name, as the blocks' are)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    c, out = YOLO, {}
    x, _ = resnet_images(c["B"], c["size"], 1, seed=54)
    y = yolo_labels(c["B"], c["size"] // 32, c["classes"], seed=55)
    yds = DataSet(torch.from_numpy(x).to(device), torch.from_numpy(y).to(
        device))
    X, Y = lm_corpus(MOE_LM, MOE["B"], seed=63)
    mds = DataSet(torch.from_numpy(X).long().to(device),
                  torch.from_numpy(Y).to(device))
    grid = c["size"] // 32
    for tag, policy, dt in (("", None, torch.float32),
                            ("_mixed", MIXED, torch.bfloat16)):
        net = ComputationGraph(yolo2_conf(c["size"], c["classes"]),
                               device=device, dtype_policy=policy).init()
        for _ in range(2):
            net.fit(yds, batch_size=c["B"])                       # warm
        p = _profiled(lambda: net.fit(yds, batch_size=c["B"]))
        layer = net.conf.nodes["yolo"].layer
        t = torch.randn((c["B"], grid, grid, len(YOLO_ANCHORS) * (
            5 + c["classes"])), device=device, requires_grad=True)
        p["loss_ms"] = timer(device, lambda: layer.compute_loss(
            t, yds.labels).backward(), iters=10)
        out[f"yolo2_step_{c['B']}x{c['size']}{tag}"] = p
        del net
        torch.cuda.empty_cache()
        net = MultiLayerNetwork(moe_lm_conf(MOE_LM), device=device,
                                dtype_policy=policy).init()
        for _ in range(2):
            net.fit(mds, batch_size=MOE["B"])                     # warm
        p = _profiled(lambda: net.fit(mds, batch_size=MOE["B"]))
        moe = net.layers[_moe_positions(net)[0]].clone().to(device)
        moe.load_state_dict(net.layers[_moe_positions(net)[0]].state_dict())
        moe.to(dt)
        for q in moe.parameters():
            q.requires_grad_(True)
        h = torch.randn((MOE["B"], X.shape[1], MOE_LM["d_model"]),
                        device=device, dtype=dt, requires_grad=True)
        p["moe_ms"] = len(_moe_positions(net)) * timer(
            device, lambda: moe(h, train=True, new_state={}).float().sum()
            .backward(), iters=10)
        out[f"moe_lm_step_{MOE['B']}x{X.shape[1]}{tag}"] = p
        del net, moe
        torch.cuda.empty_cache()
    return out


# ------------------------------------- --runtime-probe: phase 14's whys
def runtime_probe(device, steps=8):
    """Two questions behind phase 14's numbers, on the long-context LM
    at [8, 2048]: (1) which leaves of one fp32 step's gradients differ
    when the step runs twice from one state, with the port's
    fixed-order embedding gradient and with `F.embedding`'s own; (2)
    spe 1 against spe 4 in turns (1, 4, 4, 1), `steps` steps each under
    torch.profiler, fp32 and mixed_bf16: wall and device ms a step and
    the host-to-device copies' ms a step."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.nn.layers import feedforward as ff
    cfg = LM_LONG
    params = random_lm_params(cfg, seed=140, head_scale=1.0)
    X, Y = lm_corpus(cfg, 8 * steps, seed=14)
    out = {"determinism": {}, "spe": {}}
    net = build_lm(cfg, device, params, lr=LONG_LR)
    xs, ys = net._features(X[:8]), net._labels(Y[:8])

    def grads():
        _, g, _ = net._loss_and_grads(lambda st: net._loss_fn(
            xs, ys, train=True, rng=net._step_key(0), new_state=st))
        return {n: g[id(p)].clone() for n, p in net.named_parameters()}
    fixed = ff._FixedOrderEmbedding.apply
    for arm, apply in (("fixed_order", fixed),
                       ("f_embedding", lambda idx, w: F.embedding(idx, w))):
        ff._FixedOrderEmbedding.apply = apply
        try:
            a, b = grads(), grads()
        finally:
            ff._FixedOrderEmbedding.apply = fixed
        out["determinism"][arm] = {
            n: float((a[n] - b[n]).abs().max()) for n in a
            if not torch.equal(a[n], b[n])}
    del net
    for policy in (None, MIXED):
        rows = []
        for spe in (1, 4, 4, 1):
            net = build_lm(cfg, device, params, lr=LONG_LR,
                           dtype_policy=policy)
            net.fit(X[:8], Y[:8], batch_size=8, shuffle=False)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                net.fit(_runtime_iter(X, Y, 8), steps_per_execution=spe)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev = sum(e.device_time_total for e in prof.key_averages()
                      if "CUDA" in str(e.device_type))
            h2d = sum(e.device_time_total for e in prof.key_averages()
                      if "HtoD" in e.key)
            rows.append(dict(spe=spe, wall_ms=wall / steps * 1e3,
                             device_ms=dev / steps / 1e3,
                             h2d_ms=h2d / steps / 1e3))
            del net
        out["spe"][policy or "float32"] = rows
    for arm, bad in out["determinism"].items():
        print(f"[runtime-probe] gradients run twice, {arm}: leaves that "
              f"differ {bad}", flush=True)
    for tag, rows in out["spe"].items():
        print(f"[runtime-probe] {tag} profiled, in turns: " + "; ".join(
            f"spe {r['spe']} wall {r['wall_ms']:.1f} device "
            f"{r['device_ms']:.1f} h2d {r['h2d_ms']:.2f} ms/step"
            for r in rows), flush=True)
    return out


# ---------------------------------------- --warmup-trial: long-context lr
def warmup_trial(device, steps=40, warmups=(5, 10, 20)):
    """The long-context LM's local arm (phase 6's params and windows) at
    the zoo's Adam(1e-3), constant and under `WarmupCosineSchedule(1e-3,
    W, steps)` for each W, `steps` steps each at [8, 2048], in fp32 and
    under mixed_bf16: the loss of every step, its largest value, and
    whether it ended below where it began."""
    from deeplearning4j_tpu_torch.common.schedules import WarmupCosineSchedule
    B, T = 8, LM_LONG["max_len"]
    params = random_lm_params(LM_LONG, seed=8642, head_scale=1.0)
    X, Y = lm_corpus(LM_LONG, B * steps, seed=8, T=T)
    rates = [("adam_1e-3", 1e-3)] + [
        (f"warmup_cosine_W{w}", WarmupCosineSchedule(1e-3, w, steps))
        for w in warmups]
    out = {}
    for policy in (None, MIXED):
        for name, lr in rates:
            net = build_lm(LM_LONG, device, params, lr=lr,
                           dtype_policy=policy)
            t0 = time.perf_counter()
            losses = _fit_steps(net, X, Y, B)
            key = f"{name}/{policy or 'float32'}"
            out[key] = dict(losses=losses, first=losses[0],
                            max=max(losses), last=losses[-1],
                            fell=bool(losses[-1] < losses[0]),
                            seconds=time.perf_counter() - t0)
            print(f"[warmup_trial] {key}: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, max {max(losses):.4f}; every 5th: "
                  f"{[round(x, 3) for x in losses[::5]]}", flush=True)
            del net
    return out


# --------------------------------------------- --zoo-lr-trial: VGG16's rate
def zoo_lr_trial(device, steps=10, rates=(1e-2, 3e-3, 1e-3, 1e-4)):
    """GoogLeNet at batch 128 and VGG16 at batch 64 (224x224, 1000
    classes, phase 12's repeated batch), `steps` fp32 steps from the
    zoo's weights under Nesterovs(lr, 0.9) for each rate: every loss and
    whether it ended below where it began."""
    import torch
    from deeplearning4j_tpu_torch.common.updaters import Nesterovs
    from deeplearning4j_tpu_torch.datasets import DataSet
    out = {}
    for name, B in (("GoogLeNet", 128), ("VGG16", 64)):
        x, y = resnet_images(B, 224, 1000, seed=43)
        ds = DataSet(torch.from_numpy(x).to(device),
                     torch.from_numpy(y).to(device))
        for lr in rates:
            net = _zoo_model(name, {}).init(device=device)
            for layer in net.layers:
                layer.updater = Nesterovs(lr, 0.9)
            losses = []
            for _ in range(steps):
                net.fit(ds, batch_size=B)
                losses.append(net.score_value)
            key = f"{name}/{lr:g}"
            out[key] = dict(losses=losses, fell=bool(losses[-1] < losses[0]))
            print(f"[zoo_lr_trial] {key}: {[round(v, 4) for v in losses]}",
                  flush=True)
            del net
            torch.cuda.empty_cache()
    return out


def yolo_lr_trial(device, steps=13, rates=(1e-3, 3e-4, 1e-4, 3e-5)):
    """YOLOv2 at phase 13's 608 and batch 8 on its repeated batch, `steps`
    fp32 steps from `init(seed)` under Nesterovs(lr, 0.9) for each rate,
    without and with YOLO_GN's per-layer renormalization: every loss and
    whether it ended finite below where it began."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    c = YOLO
    x, _ = resnet_images(c["B"], c["size"], 1, seed=54)
    y = yolo_labels(c["B"], c["size"] // 32, c["classes"], seed=55)
    ds = DataSet(torch.from_numpy(x).to(device), torch.from_numpy(y).to(
        device))
    out = {}
    for renorm in (False, True):
        for lr in rates:
            net = ComputationGraph(yolo2_conf(
                c["size"], c["classes"], lr=lr, renormalize=renorm),
                device=device).init()
            losses = []
            for _ in range(steps):
                net.fit(ds, batch_size=c["B"])
                losses.append(net.score_value)
            key = f"{'renormalized' if renorm else 'plain'}/{lr:g}"
            out[key] = dict(losses=losses, fell=bool(
                np.isfinite(losses[-1]) and losses[-1] < losses[0]))
            print(f"[yolo_lr_trial] {key}: "
                  f"{[round(v, 3) for v in losses]}", flush=True)
            del net
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- driver
KERNEL_META = {
    "layer_norm": ("deeplearning4j_tpu_torch/kernels/csrc/layernorm.cu",
                   "deeplearning4j_tpu/kernels/layernorm.py:55"),
    "residual_layer_norm": (
        "deeplearning4j_tpu_torch/kernels/csrc/layernorm.cu",
        "deeplearning4j_tpu/kernels/layernorm.py:67"),
    "flash_attention_fwd": (
        "deeplearning4j_tpu_torch/kernels/csrc/flash_attention.cu",
        "deeplearning4j_tpu/kernels/flash_attention.py:87"),
    "flash_attention_carry": (
        "deeplearning4j_tpu_torch/kernels/csrc/flash_attention.cu",
        "deeplearning4j_tpu/kernels/flash_attention.py:87 (carry mode)"),
    "flash_attention_bwd_dq": (
        "deeplearning4j_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
        "deeplearning4j_tpu/kernels/flash_attention.py:265"),
    "flash_attention_bwd_dkv": (
        "deeplearning4j_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
        "deeplearning4j_tpu/kernels/flash_attention.py:307"),
    "fused_adam": ("deeplearning4j_tpu_torch/kernels/csrc/fused_adam.cu",
                   "deeplearning4j_tpu/kernels/fused_adam.py:78"),
    # no Pallas kernel: XLA's fusion of the threefry draw into its use
    "dropout": ("deeplearning4j_tpu_torch/kernels/csrc/threefry.cu",
                "deeplearning4j_tpu/nn/conf/dropout.py:63 "
                "(jax.random.bernoulli, an XLA fusion)"),
    "threefry_bits": ("deeplearning4j_tpu_torch/kernels/csrc/threefry.cu",
                      "deeplearning4j_tpu/nn/conf/dropout.py:117 "
                      "(jax.random.normal's bits, an XLA fusion)"),
    # no Pallas kernel: the vmap of jax.random.categorical over the
    # slots' keys, an XLA fusion
    "threefry_rows": ("deeplearning4j_tpu_torch/kernels/csrc/threefry.cu",
                      "deeplearning4j_tpu/serving/engine.py:525 "
                      "(vmap(jax.random.categorical)'s bits, an XLA "
                      "fusion)"),
}


def run(device, *, small=False, kernels_only=False):
    """All phases on `device`; returns (report, failures)."""
    import torch
    report, fails = {"device": str(device)}, Failures()
    timings, launches = {}, {k: 0 for k in KERNEL_META}

    def phase(name, fn, *a):
        try:
            return fn(*a)
        except Exception:  # noqa: BLE001 — record, fail the run, go on
            traceback.print_exc()
            fails.append(f"phase {name} raised")
            return None

    if device.type == "cuda":
        phase("build", phase_build, report, fails)
    timings = phase("kernels", phase_kernels, device, report, fails,
                    small) or {}
    if not kernels_only:
        cfg = dict(LM, n_layers=2, max_len=128) if small else LM
        B, T = (2, 40) if small else (16, 512)
        l3 = l4 = None
        res = phase("scoring", phase_scoring, device, report, fails, cfg, B, T)
        if res is not None:
            net, l3 = res
            for k in launches:
                launches[k] += l3.get(k, 0)
            l4 = phase("serving", phase_serving, device, report, fails, net,
                       6 if small else 24, 2 if small else 4,
                       8 if small else 64, (3, 60) if small else (16, 300))
            for k in launches:
                launches[k] += (l4 or {}).get(k, 0)
        l5 = phase("training", phase_training, device, report, fails, cfg,
                   *((2, 2, 2, 4) if small else (8, 3, 16, 20)))
        for k in launches:
            launches[k] += (l5 or {}).get(k, 0)
        long_cfg = (dict(LM_LONG, vocab=64, d_model=64, n_layers=2,
                         max_len=64) if small else LM_LONG)
        l6 = phase("sequence_parallel", phase_sequence_parallel, device,
                   report, fails, long_cfg,
                   *((2, 2, 3) if small else (8, 3, 10)))
        for k in launches:
            launches[k] += (l6 or {}).get(k, 0)
        l7 = phase("bridge", phase_bridge, device, report, fails, small)
        for k in launches:
            launches[k] += (l7 or {}).get(k, 0)
        l8 = phase("serving_features", phase_serving_features, device,
                   report, fails, cfg, small)
        for k in launches:
            launches[k] += (l8 or {}).get(k, 0)
        l9 = phase("regularized", phase_regularized, device, report, fails,
                   small)
        for k in launches:
            launches[k] += (l9 or {}).get(k, 0)
        l10 = phase("resnet", phase_resnet, device, report, fails, small)
        for k in launches:
            launches[k] += (l10 or {}).get(k, 0)
        l11 = phase("recurrent", phase_recurrent, device, report, fails,
                    small)
        for k in launches:
            launches[k] += (l11 or {}).get(k, 0)
        l12 = phase("cnn_zoo", phase_cnn_zoo, device, report, fails, small)
        for k in launches:
            launches[k] += (l12 or {}).get(k, 0)
        l13 = phase("layers_rest", phase_layers_rest, device, report, fails,
                    small)
        for k in launches:
            launches[k] += (l13 or {}).get(k, 0)
        l14 = phase("runtime", phase_runtime, device, report, fails, small)
        for k in launches:
            launches[k] += (l14 or {}).get(k, 0)
        report["launches_by_phase"] = {
            n: {k: v for k, v in l.items() if v}
            for n, l in (("3", l3), ("4", l4), ("5", l5), ("6", l6),
                         ("7", l7), ("8", l8), ("9", l9), ("10", l10),
                         ("11", l11), ("12", l12), ("13", l13),
                         ("14", l14)) if l}
        print(f"[launches] by phase: {report['launches_by_phase']}",
              flush=True)
        for k, n in launches.items():
            fails.check(n > 0, f"kernel {k} never launched on the main path")
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        t = timings.get((name, "float32"), {})
        b = t.get("bound", (None, None))
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=t.get("max_abs_err"),
                            ms=t.get("ms"), plain_ms=t.get("plain_ms"),
                            bound_ms=b[0], bound_by=b[1],
                            library_ms=t.get("library_ms")))
    report["kernels"] = kernels
    report["failures"] = list(fails)
    return report, fails


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 3
    # fp32 parity on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if "--profile" in argv:
        report, fails = {"profile": profile_paths(device)}, Failures()
        report["kernels"] = []
    elif "--warmup-trial" in argv:
        report, fails = {"warmup_trial": warmup_trial(device)}, Failures()
        report["kernels"] = []
    elif "--zoo-lr-trial" in argv:
        report, fails = {"zoo_lr_trial": zoo_lr_trial(device)}, Failures()
        report["kernels"] = []
    elif "--profile-layers-rest" in argv:
        report, fails = {"profile": profile_layers_rest(device)}, Failures()
        _print_profile(report["profile"])
        report["kernels"] = []
    elif "--yolo-lr-trial" in argv:
        report, fails = {"yolo_lr_trial": yolo_lr_trial(device)}, Failures()
        report["kernels"] = []
    elif "--layers-rest" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_layers_rest(device, report, fails)
        report["kernels"] = []
    elif "--runtime-probe" in argv:
        report, fails = {"runtime_probe": runtime_probe(device)}, Failures()
        report["kernels"] = []
    elif "--runtime" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_runtime(device, report, fails)
        report["kernels"] = []
    else:
        report, fails = run(device, kernels_only="--kernels-only" in argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report["nvidia_smi"] = smi[0] if smi else ""
    report["seconds"] = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"checks": report.get("kernel_checks", [])}))
    print(json.dumps({"kernels": report["kernels"]}))
    print(report["nvidia_smi"])
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed: {list(fails)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
