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
    python3 chip_smoke.py --telemetry     # build + phase 15 alone
    python3 chip_smoke.py --telemetry-probe  # phase 15's host-time
                                          # breakdown of a diagnostics step
    python3 chip_smoke.py --serving-plane # build + phase 16 alone
    python3 chip_smoke.py --parallel      # build + phase 17 alone
    python3 chip_smoke.py --multiprocess  # build + phase 18 alone
    python3 chip_smoke.py --elastic       # build + phase 19 alone
    python3 chip_smoke.py --fleet         # build + phase 20 alone
    python3 chip_smoke.py --tenancy       # build + phase 21 alone
    python3 chip_smoke.py --embeddings    # phase 22 alone (no kernel, no
                                          # build)
    python3 chip_smoke.py --clustering    # build + phase 23 alone
    python3 chip_smoke.py --import-io     # build + phase 24 alone
    python3 chip_smoke.py --ui            # build + phase 25 alone
    python3 chip_smoke.py --drivers       # build + phase 26 alone

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
     q, k, v views that start off 16-byte alignment. The Viterbi scan
     kernel (`csrc/viterbi.cu`) must equal its plain version, path and
     score bit for bit, at S = 2, 77, 512 and 1100 (more states than a
     block's threads), T = 1, a ragged T and tables full of ties with
     -inf transitions, and at phase 23 (c)'s two decodes, where it is
     timed (20 and 10 launches; the plain version's T steps take
     seconds, so its one call is timed by the host clock); no PyTorch
     call computes a decode, so it has no yardstick;
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
  8. serving features on phase 3's LM at half depth (`LM_CUT`), its
     params seeded (8 slots, block_len
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
     at half depth (`LM_CUT`; (b) and (d) too) with `Dropout(0.9)` on
     the blocks, l2 1e-4 and elementwise gradient
     clipping at 1.0, fp32 and `mixed_bf16`: 3 steps at [8, 511] card
     against CPU from the same params and threefry keys (phase 5's
     gates), then 20 timed steps at [16, 511] beside the undropped twin;
     flash, both LayerNorms, fused Adam and dropout must launch; (b) the
     per-leaf arm (`clip_l2_per_layer` 1.0, `max_norm` 1.0, a
     MaxNormConstraint(1.0) on the output layer and GaussianNoise(0.05)
     on its input, `DropConnect(0.95)` and attention dropout 0.9 on the
     blocks): 3 steps at [2, 511] card against CPU; no packed run, so no
     fused-Adam launch, and no flash launch (the masked softmax carries
     the attention dropout); (c) the long-context LM (at 2 of its 8
     layers, full width: `LM_LONG_QUARTER`) under `mixed_bf16`:
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
     mixed_bf16; (b) the smoke LM at 2 of its 4 blocks, full width
     (`MOE_LM_CUT`), with a MixtureOfExperts (8 experts, top-2, hidden
     1024) after each block (`moe_lm_conf`):
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
     arm is mixed_bf16): (a) the long-context LM (phase 6's config at 2
     of its 8 layers, full width: `LM_LONG_QUARTER`) at [8, 2048],
     Adam(LONG_LR), on 32 seeded windows shuffled by one
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
 15. training telemetry and the rest of the data plane
     (`phase_telemetry`, fp32 with TF32 off and mixed_bf16): (a) the
     long-context LM at [8, 2047] (phase 14's config: 2 layers since
     phase 19 joined the script, Adam(LONG_LR)), 6
     steps with diagnostics off and 6 under the `skip` watchdog with
     activation statistics at report_frequency 1: params and Adam's m
     and v bit-equal; the card's `_last_diagnostics` keys those of the
     CPU port's same net; one more step's statistics within DIAG_RTOL of
     the same statistics recomputed in float64 from that step's own
     params, gradients and activations; (b) Adam's rate inf at
     iteration 3 (a MapSchedule): `warn` bit-equal to the off run, NaN
     positions included; `skip` leaves p, m and v bit-equal to step 2's,
     counts one skip and one non-finite step, ends finite, and its 6
     losses at [1, 127] are held card vs CPU (fp32: TRAIN_LOSS_RTOL);
     `halt` raises NonFiniteGradientsError at iteration 3 naming layers;
     (c) with monitoring on (fp32) the diagnostics' d2h copies: 3 at
     report_frequency 2 over 6 steps, 2 for steps_per_execution 3; (d)
     one `fit/forward_backward` and one `fit/update` span a step in the
     Chrome trace (OUT_DIR/telemetry_trace.json) and the watchdog
     counters and `training_*` families in the exposition; (e) ms/step,
     device ms, launches and h2d ms a step (torch.profiler) with
     diagnostics off, on and skip, monitoring on, and
     DevicePrefetchIterator(depth=2) against the plain iterator (losses
     and params bit-equal; fp32 in turns: off, on, skip, off and plain,
     prefetch, prefetch, plain); (f) the packaged LeNet trained 3 steps
     at batch 128 from a CSV of the committed digits through
     RecordReaderDataSetIterator, bit-equal to the array iterator's run,
     and EvaluationBinary and EvaluationCalibration of its held-out
     outputs with the CPU's counts (or every moved prediction within
     twice the output difference of an edge); (g) the float64 gradient
     check of a conv net at the checker's default device, the card, and
     on the CPU. It prints `[telemetry]` lines;
 16. the serving request plane (`phase_serving_plane`) on phase 3's LM
     config at full width and half depth (`LM_CUT`) (seeded params,
     head x4), 8 slots, block_len
     16, each server warmed on its traffic's length buckets only (16-64;
     (f): 128): (a) a burst of 12 greedy and 4 sampled requests (prompts
     16-64, 32 tokens) run by the scheduler's loop body in this thread, once
     with monitoring off and once on: the streams token for token, the
     device-to-host reads (`HostReads`) and the dispatches equal, every
     request's trace sealed with its queued, prefill and decode phases,
     the serving families in the exposition; (b) on the threaded server
     with monitoring on, the goodput classes sum to the dispatched
     positions and the registry mirror equals the ledger, for a warmed
     run, a speculative (k 4) run and a run through `drain()`; (c) a
     burst of 24 against `slo_ttft_s` 0 (below any projected TTFT): some
     shed with ShedError, as many in `serving_shed_total`, in
     `slo_requests_bad_total` and as `shed` events with a reason on their
     traces; (d) 8 prompts handed from a PrefillWorker's engine to a
     DecodeWorker's through DLFP bytes continue bit-equal to the
     colocated streams, fp32 and mixed_bf16 (bf16 on the wire), with
     export + encode and decode + adopt ms and the frame's MB; (e)
     `decode_cost_report` and `xprof.roofline` at the H100's peaks: the
     predicted ms of a decode dispatch beside the measured one (8 slots);
     (f) tokens/s of the threaded server over 32 dispatches with 8 slots
     (8 requests, prompt 128, 33 tokens), monitoring off and on in turns
     off, on, on, off, twice, and the same requests driven in this thread
     the same way: the median host ms of a decode dispatch's scheduler
     iteration, off and on. It prints `[serving_plane]` lines;
 17. data-parallel training (`phase_parallel`, fp32 with TF32 off unless
     an arm is mixed_bf16) of the long-context LM (phase 6's config at
     `LM_LONG_QUARTER`'s depth, Adam(LONG_LR)) at the global batch [8, 2048]
     on a 4-way data axis that repeats the card
     (`make_mesh(MeshSpec.of(data=4), devices=[card] * 4)`: one
     [2, 2048] shard a replica, run one after the other, so no speed-up
     is claimed): (a) `ParallelTrainer` sync
     dense, bucketed and single-barrier, 3 steps against the single
     card's `fit` of the same batches (step 0's loss within 1e-5
     relative, every param within twice Adam's step bound), and the
     bucketed arm under mixed_bf16 (step 0 within 1e-2); (b) threshold
     with a tau per bucket keyed by layer, its losses within JAX's band
     (0.35 x the initial loss) of (a)'s dense, the error-feedback
     identity enc·tau + res_new = update + res_old checked per bucket
     and replica; (c) averaging every 2 steps, the replicas' params
     bit-equal after each round and apart before it; (d) dense_rs
     bit-equal to (a)'s bucketed dense in params and Adam state, and
     threshold_rs learning; (e) at a cut depth (full width), a threshold
     and an averaging run checkpointed at step 2, killed at 3, resumed
     by a new trainer and trained to 4, bit-equal to the uninterrupted
     run, and the threshold checkpoint resumed on 2 replicas with the
     residual's sum kept; (f) ParallelInference on phase 3's LM: 16
     threads each ask for one [1, 512] row, coalesced, within
     OUTPUT_ATOL of `output()` of the [16, 512] batch; (g) the packaged
     LeNet on the digits, on the card and on a CPU twin: an
     EarlyStoppingParallelTrainer and both training masters with stats,
     phase counts equal to the CPU's. For each mode (and the single
     card): ms/step, device ms and launches a step (torch.profiler),
     the host ms of the exchange and update (the step less its
     replicas' forward-backward), the training state the mode keeps
     and the step's peak memory above it. It prints
     `[parallel]` lines;
 18. multi-process training (`phase_multiprocess`, `--multiprocess`,
     fp32 with TF32 off, Adam(LONG_LR) unless a part says otherwise) of
     phase 17's LM, params and batches, every trainer's per-step losses
     held to its reference at 1e-4 and its params, where they are
     compared, at PARAM_MOTION_RTOL of the single card's motion: (a) 2
     processes (`initialize_multihost`) with 2 replicas each on the
     global 4-replica mesh, the global batch [8, 2048], over gloo staged
     through the host on one card (NCCL, one process per card, where
     there are two or more), dense bucketed and single barrier against
     the single card's `fit`, threshold against the one-process
     4-replica threshold run, 3 steps each; ms/step, the exchange's host
     ms and bytes across processes a step, the backend; (b) the bucketed
     run checkpointed behind the barrier manifests at step 2, stopped at
     3, resumed in 2 processes and trained to 4, bit-equal to the
     uninterrupted run (write and resume seconds); (c)
     `ShardedParallelTrainer` on model=2 x data=2 over the repeated card
     and across the 2 processes with the model axis outermost, against
     the single card's `fit`, with the params and slots a process holds
     whole and between steps (`held_bytes`; one process holds them once,
     each of two less than whole) and `torch.cuda.memory_allocated`;
     phase 13's MoE LM under `moe_param_specs` on expert=4, 2 steps, its
     losses the single card's; a `ShardedCheckpoint` round trip,
     `output()` equal; (d) `PipelineParallelTrainer` on pipe=4 (2 blocks
     a stage, 4 microbatches): one Sgd(0.05) step within JAX's rtol 2e-4
     / atol 1e-6 of the single card's, 3 Adam steps against the single
     card's, pipe=2 x data=2's SGD step, ms/step and the bubble share;
     (e) a graph LM with the ring on seq=4 (the carry kernel) against the
     local graph, and threshold with `skip` diagnostics bit-equal to
     diagnostics off. Each part's launches are counted apart, the
     references outside every part, and each part must launch its
     kernels (`MP_KERNELS`). It prints `[multiprocess]` lines;
 19. elastic training (`phase_elastic`, `--elastic`, fp32 with TF32 off,
     Adam(LONG_LR)) of the long-context LM at `LM_LONG_QUARTER`'s depth,
     global batch [8, 2048], 10 steps: (a) the survive-the-kill drill
     (`parallel/elastic_smoke.py`): a coordinator here and 2 worker
     processes over gloo on the one card (NCCL, one process per card,
     where there are two or more), one replica each, threshold mode;
     rank 1 SIGKILLs itself after step 3, the survivor gets the broken
     world back through `on_fatal="raise"`, tears it down (bounded),
     waits for the coordinator's next generation and re-forms alone in
     its own process from the step-2 checkpoint; the
     killed worker is relaunched once the
     survivor passes step 5, the shrunk world drains at step 6 and grows
     back to 2 until step 10. Held against two runs made here, outside
     every part: the scheduled run (`elastic_smoke.scheduled_reference`:
     the same schedule in this process, an `ElasticTrainer` over 2 -> 1
     -> 2 replicas of the card with a scripted membership and the same
     checkpoints), every worker's every step within 1e-4 of its loss
     in the same generation and the final params within
     PARAM_MOTION_RTOL of its motion; the uninterrupted 2-replica run,
     every step within JAX's drift band (0.25 x the initial loss). And:
     3 generations of widths 2, 1, 2, the residual restored at each
     resume, no step lost beyond the last checkpoint, the final params
     equal across workers; it prints the recovery split of the shrink
     and the regrow (detection, settle, re-init, resume), ms/step a
     generation, the drain check's host ms a step and the checkpoint's
     write and resume seconds; (b) an `ElasticTrainer` with its runtime
     seams stubbed over [card] x 4 -> x 2 -> x 4 (one join, one leave,
     scripted steps), dense sync, held to an uninterrupted 4-replica fit
     at TRAIN_LOSS_RTOL step by step and at PARAM_MOTION_RTOL of its
     motion; (c) during (a) the coordinator's status runs through
     `ingest_elastic_status` into a `MetricsAggregator` and an
     `AlertEngine` with `default_rule_pack(elastic_min_processes=2)`:
     elastic-shrink fires and resolves, the killed worker's federated
     series go stale and return, and `elastic_drains_total` and
     `elastic_resume_total` read as the runs did. Each part must launch
     its kernels (`ELASTIC_KERNELS`). It prints `[elastic]` lines;
 20. the serving fleet (`phase_fleet`, `--fleet`, fp32 with TF32 off) on
     phase 3's LM (`LM`, seeded params, head x4; 8 slots of block_len 16,
     a pool for 8 full-budget streams): (a) `fit` at [8, 511], Adam(1e-3),
     6 steps with `registry.publish_listener("lm", frequency=3)`, which
     publishes v1 and v2; each zip restored on the CPU equals the card's
     params at its step bit for bit; (b) a `FleetServer` deploys v1
     behind a `FleetRouter` with `warmup_prompt_len` the burst's length
     range, so it and every successor the swap and the resize build run
     the warmup grid over the burst's buckets only; a burst of 16 greedy and 4
     sampled requests (prompts 16-64, 64 tokens), `swap("lm")` to v2 in a
     background thread once the burst's first token is out, then 8
     requests past the pointer flip: no stream dropped, each tagged with
     the version that served it and held to that version's unswapped
     single-server streams of the same requests (greedy by
     `stream_agreement` at `_wide_vs_single`'s margin, sampled by phase
     8's `sampled_margin`, near-ties counted); v1's pin released and
     retention (keep_last 1) collects it; the swap's seconds and TTFT
     p50/p99 before the swap and past the flip; (c) a flood of twice the
     greedy prompts and the sampled ones: `FleetAutoscaler.check()`
     scales lm from 8 to 16 slots under queue pressure, no stream
     dropped, the decision record printed; (d) an `ElasticCoordinator`,
     a `ReplicaWorker` on the card and a `spawn_replica(...,
     device="cuda")` process that resolves v2 from the registry, a
     `ReplicaSet` and the router balancing 12 greedy and the 4 sampled
     requests; the process is SIGKILLed once its first reply chunk is
     in: every stream finishes, held to the reference, some migrated,
     the set converges to the survivor and a later request lands there
     (spawn-to-ready and kill-to-converged seconds, migrations; the
     process's own launches are not counted); (e) a `ServingRoute` over
     `LocalQueueTransport` restores v2's zip on the card at its first
     message and answers `output()` of [4, 128] through the router's
     output backend, within OUTPUT_ATOL of the CPU's `output()` of the
     zip. The references run outside every part; each part must launch
     its kernels (`FLEET_KERNELS`). The registry root lives under
     `chiprun_out/` and is deleted at the phase's end. It prints
     `[fleet]` lines;
 21. multi-tenant LoRA serving and online training (`phase_tenancy`,
     `--tenancy`, fp32 with TF32 off) on phase 3's LM (`LM`, seeded
     params, head unscaled), trained 10 steps at [8, 511] on the base
     task (the ids one place ahead in a seeded period-64 token cycle, as
     `scripts/tenant_loadtest.py`'s base) and published as v1: (a)
     tenants A and B, then (b) C, each attach a frozen rank-4 (alpha 8)
     adapter to the one training net and run an `OnlineTrainer` over a
     `StreamingDataSetIterator` on its own `LocalLogTransport` topic of
     `lm_example` records [2, 511] (A and B learn the cycle shifted by 2
     and 3, C fine-tunes the base task), batch 8, Adam(1e-3), with an
     `AdapterPublishListener` every 3 steps and a `CheckpointListener`
     (the cursor) every 3: A and B 6 steps; C's stream turns to shuffled
     labels after 3 clean steps for 3 and then runs clean for 9, under a
     loss-band `DriftGate` (band 0.02) on 8 held-out clean records that
     must trip, refuse at least one publish and let a later one
     through. Every adapter zip restored on the CPU equals the
     card's factors at its step bit for bit and is under 5% of the base
     zip; the base is bit-identical after all three; the factors update
     in one fused-Adam launch a step. (c) A's run again on v1 from the
     registry, stopped after step 4 with its newest checkpoint at 3;
     `OnlineTrainer.resume` rebuilds the net (the adapter attached again)
     and seeks a fresh stream to the cursor: the resumed losses and final
     factors equal (a)'s uninterrupted run bit for bit. (d) a
     `TenantFleet` over v1 deploys A, B and C at adapter v1 (8 slots,
     block_len 16, each, and each swap's successor, warmed by
     `TenantFleet`'s own step on the burst's buckets only) behind a
     `FleetRouter`; 8 greedy requests a tenant (prompts 16-64, 32
     tokens), each tenant swapped to adapter v2 once its first token is
     out, 4 more past its flip: no stream dropped, each tagged (tenant,
     version) and held to that composition's single-server stream by
     `stream_agreement` at `_wide_vs_single`'s margin (near-ties
     counted); `attach_adapter` + `generate` equals the composed tree's
     `generate`, and each tenant's v2 stream leaves the base's;
     `shared_base_copies()` is 1; `torch.cuda.memory_allocated` (with
     the idle servers' cuBLAS workspaces freed: each scheduler thread's
     cuBLAS handle takes one from the same allocator; the growth with
     them is printed too) grows per added tenant by at most its KV pool,
     its factors and half a base copy; the swap seconds and TTFT p50/p99 per tenant are
     printed. The references run outside every part; each part must
     launch its kernels (`TENANCY_KERNELS`). The registry root lives
     under `chiprun_out/` and is deleted at the phase's end. It prints
     `[tenancy]` lines;
 22. embeddings (`phase_embeddings`, `--embeddings`, fp32): the
     SequenceVectors engine and the graph library of
     `deeplearning4j_tpu_torch/{nlp,graph}/`, each card run held against
     the port's CPU path from the same seed: (a) the word2vec bench
     config (`deeplearning4j_tpu/bench.py:801-845`: a zipf corpus of 400
     x 250 tokens over 5000 words from `default_rng(3)`, skip-gram with
     negative sampling, layer 128, window 5, negative 5, batch 4096, 32
     batches a fused group, one epoch): the first group's syn0 and
     syn1neg within GROUP_RTOL of the CPU's, the whole fit within
     SCATTER_ORDER_FACTOR x the CPU's distance to a twin that scatters
     each batch in another order, the top-10 `words_nearest` of the 50
     most frequent words overlapping the CPU's by NEAREST_OVERLAP;
     words/s of a second fit from fresh tables (as the bench times it)
     beside the CPU's, `etl_stats`, and one group's kernel launches
     (torch.profiler); (b) the 100k-word vocab (`bench.py:847-877`:
     800 x 500 tokens, batch 8192, 16 a group): the first group against
     the CPU's (which stops there), words/s and the peak of
     `torch.cuda.memory_allocated`; (c) CBOW + NS, skip-gram + HS and
     CBOW + HS on `tests/test_nlp.py`'s topic corpus, card against CPU
     within EMBED_RTOL, in-topic similarity above cross-topic on the
     card; (d) ParagraphVectors DM and DBOW with `infer_vector`, GloVe,
     DeepWalk and Node2Vec on a two-community graph, card against CPU
     within EMBED_RTOL, each with its test's structure check; (e) the
     packaged `word2vec_docs.bin` read in place through the sha256
     check, on the card its `words_nearest` equal to the CPU's, written
     and read back bit-equal in the binary and text formats (text: to
     its printed decimals). It prints `[embeddings]` lines;
 23. clustering (`phase_clustering`, `--clustering`, fp32): the
     analysis libraries of `deeplearning4j_tpu_torch/{clustering,plot,
     util}/` and the segmenters of `nlp/`, each card run held against
     the port's CPU path from the same seed, on phase 22 (a)'s trained
     vectors (4829 words x 128; trained here when phase 22 did not
     run): (a) k-means, K 32, 100 iterations at most: the k-means++
     init equal, assignments equal off counted near-ties, centroids and
     cost within KMEANS_RTOL, iteration counts equal; ms and launches
     an iteration; (b) exact t-SNE: (i) the packaged
     `word2vec_docs.bin` (1032 x 64, through the sha256 check), each of
     the first TSNE_STEPS steps from the CPU's state within
     TSNE_STEP_RTOL (gains that flip counted), the free runs within it
     for TSNE_EXACT_STEPS steps and within TSNE_TWIN_FACTOR x the CPU's
     one-ulp twin at TSNE_STEPS (the map is chaotic there); (ii) the
     4829 vectors at JAX's defaults (perplexity 30, lr 200, 500 steps)
     on the card alone: the KL finite and lower at the end than past
     early exaggeration, each word's 10 nearest in the map overlapping
     its 10 nearest in 128-D (cosine) at 10x chance or more; ms,
     launches, device ms and busy share a step, P's host seconds, peak
     allocated; (c) Viterbi through the kernel: the noisy labels of a
     seeded metastable chain (T 65,536, S 77: the text LSTM's charset)
     and `viterbi_decode` at [8192, 512] (the smoke LM's vocab), path
     and score bit-equal to the plain version on the CPU, one launch a
     decode; (d) Word2Vec through the CJK, Japanese, Korean and
     annotation tokenizer factories on their tests' corpora, card
     against CPU within EMBED_RTOL, each with its test's structure
     check; (e) `NearestNeighborsServer` over the vectors: /knn and
     /knnnew for 8 queries equal to a brute force on the card. It
     prints `[clustering]` lines;
 24. Keras import and the IO layer (`phase_import_io`, `--import-io`,
     fp32 with TF32 off): the libhdf5 soname the port's HDF5 shim links
     against (probed up front, `modelimport.hdf5.libhdf5()`) and g++'s
     version are printed first. (a) Where a libhdf5 links: the five
     Keras-written fixtures of tests/fixtures/keras (sequential CNN,
     LSTM, functional, BatchNorm + SeparableConv2D, and the Keras 3
     weights-only file by name) imported on the card, each output held
     to Keras's own predictions at JAX's tolerance (KERAS_RTOL,
     KERAS_ATOL), and the compiled real_bn.h5 fitted KERAS_FIT_STEPS
     steps with its SGD, losses card against the port's CPU run within
     KERAS_FIT_ATOL; on a host without libhdf5, skipped with the reason;
     (b) the keras-applications ResNet-50 (resnet50_keras_arch.json:
     ZeroPadding, 53 biased convs, 53 BatchNorms with epsilon 1.001e-5,
     the 1000-way `predictions` Dense) at full width: seeded weights
     (moving statistics away from 0/1) written in the weights-only
     layout, imported through `ResNet50().init_pretrained(IMAGENET)`
     (its `pretrained_path` and `pretrained_checksum` serving the file),
     `output()` at [32, 224, 224, 3] held to the port's CPU import of the
     same file on the first 2 images within IMPORT_TOL of max|y| (pooled
     features too) with top-1 equal; file write, read, import seconds
     and output() ms; then the same weights as a compiled Keras 2 model
     (Adam(1e-4), categorical cross-entropy) through
     `import_keras_model_and_weights`, its Dense an mcxent OutputLayer,
     fitted 3 steps at batch 16 card against CPU (step 0 within
     TRAIN_LOSS_RTOL, later steps, params and running statistics by
     phase 10's noisy-twin rule), fused Adam launched every step. On a
     host without libhdf5 the files are `NpzArchive` twins (same names,
     an .npz behind them) and the architecture comes through
     `import_keras_configuration` / `config_from_dict`, the weights
     through the port's `_copy_weights`; (c) the CSV shim built with g++
     (`native_available()` asserted): a seeded 250,000 x 17 CSV (16
     float32 features at %.9g and a label in 0-9) parsed bit for bit
     (MB/s, rows/s), a file of quotes, comments, blank lines, ragged rows
     and non-numeric fields equal to the numpy path, and the first 65,536
     rows through `load_csv_dataset` into a `NetworkEstimator` (MLP
     16-256-256-10, Adam, batch 1024, one epoch) on the card: its first
     loss within ESTIMATOR_ATOL of the CPU estimator's, then `predict`
     and `score` on the held-out rows; (d) `ModelGuesser` on the card:
     the estimator's net as a port zip and its configuration JSON (and
     real_cnn.h5 where libhdf5 links) equal in class and outputs, bit for
     bit, to the direct loads, a weights-only .h5 refused; (e) S3 runs in
     the CPU tests only. It prints `[import]` lines;
 25. the training UI (`phase_ui`, `--ui`, fp32 with TF32 off):
     `deeplearning4j_tpu_torch/ui/` watching the smoke LM at full width.
     (a) 8 steps of `fit` at [16, 511] on the card with diagnostics on
     and a `StatsListener(collect_histograms=True)` into a
     `FileStatsStorage` under `build/`: step 0's report has the keys of
     the port's CPU run of the same step, its param magnitudes within
     UI_PARAM_RTOL, its update magnitudes and update:param ratios within
     UI_UPDATE_RTOL, its gradient magnitudes within GRAD_RTOL, its host
     histograms bin
     for bin but for values within UI_HIST_EDGE_RTOL of an edge; every
     report finite, every histogram summing to its leaf's size; the
     sqlite file reopened decodes to the same reports (the gradient
     magnitudes within GRAD_RTOL; param and update magnitudes wider, as
     Adam's first step moves an element whose gradient is near its eps
     by up to lr; the key biases by Adam's step bound); (b) fit ms/step
     and hand-written launches a step with no listener, a StatsListener
     into memory, and into the file with host histograms (diagnostics on
     in all three), and each mode's report bytes; (c) a `UIServer` on
     that file with the phase's registry and an `AlertEngine` of the
     default rule pack: every route 200 (the session on the pages that
     list sessions), `/api/reports` the 8 iterations, `/api/components`
     decoding through `component_from_json`, the training families on
     `/metrics`, no report of another device on `/profile` (run from the
     repository root, whose `PROFILE_aot/` holds the JAX package's TPU
     tables), and a child process posting the file's reports through a
     `RemoteUIStatsStorageRouter` to a second server's `/remote`, equal;
     (d) LeNet on phase 12's digits, 2 steps at batch 128 with a
     `ConvolutionalIterationListener`: the last step's grids within
     UI_GRAY_ATOL of the CPU's for the same params, its PNGs (written
     with the standard library) decoding to them, `/activations` serving
     them; (e) 4 greedy requests of 16 tokens through a monitored
     `GenerationServer` on the phase's LM, `/serving`'s requests and
     tokens equal to the server's results; phase 23's t-SNE map (under
     `--ui` alone: 10 exact steps on the packaged 1032 x 64 vectors)
     posted and drawn on `/tsne`. It prints `[ui]` lines;
 26. the repository's drivers on the port (`phase_drivers`, `--drivers`,
     fp32 with TF32 off), as a user runs them: (a) `scripts.serve_loadtest
     .main` in process at the smoke LM's widths (vocab 512, d256, 4
     layers, 8 heads), 8 slots, blocks of 16, 16-token prompts, 32
     tokens, 32 streams (four full waves; JAX's default is 128), with
     `--skip-fleet --skip-replicated --skip-spec` (phases 20 and 8 run
     those paths): every hard assert of its phases 1-3 (greedy parity
     against whole-batch `generate()`, near-ties recorded by margin;
     continuous beats sequential; p99 TTFT bounded; the int8 decode's
     weight-byte reduction >= 3.5x; incremental admission >= 2x
     upfront; mixed prompt lengths; the overload sheds); (b)
     `python -m deeplearning4j_tpu_torch.scripts.fault_drill --smoke
     --with-corruption --device cuda` as a subprocess started beside
     (a): a real SIGTERM at step 15, the newest checkpoint bit-flipped,
     the resumed lineage bit-identical to the uninterrupted one, and
     the seconds from the kill to its first resumed step; (c)
     `scripts.online_loop.main(["--smoke"])` and
     `scripts.tenant_loadtest.main(["--smoke"])` in process at JAX's
     drill widths, every hard assert, zero dropped streams; (d) each of
     the 12
     `deeplearning4j_tpu_torch.examples` on the card, its steps cut
     through its module constants (`DRIVER_EXAMPLE_CUTS`). Each driver
     writes its ledger under `OUT_DIR/drivers/`. It prints
     `[drivers]` lines;
and prints the `{"kernels": [...]}` line (launch counts from phases 3
to 21 and 23 to 26, each > 0; phase 22 runs none of these kernels, phase
23 only the Viterbi kernel, phase 24 only fused Adam, phases 25 and 26
the smoke LM's six; the counts of each phase, and of each part of phases
18 to 21 and 26, on a `[launches]` line), each phase's seconds on a
`[phases]` line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failed check exits nonzero without
the last line. Without CUDA it exits 2 and prints no result. It turns
TF32 off for matmuls and convolutions (PyTorch lets cuDNN run fp32
convolutions in TF32 by default) and leaves
`torch.backends.cudnn.benchmark` at its default (off).
"""

from __future__ import annotations

import io
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
# the long-context LM at half depth, full width: phase 18 runs it since
# phase 19 joined the script (its pipe=4 needs 4 blocks; phase 6 keeps
# all 8 layers); phases 9 (c), 14, 15, 17 and 19, whose CPU twins,
# references and processes carry host time, run it at a quarter (2
# layers; 4 before phase 19 and its scheduled reference joined the
# script, and phase 19 itself until phase 21 did), to keep the whole
# run under 600 s
LM_LONG_CUT = dict(LM_LONG, n_layers=4)
LM_LONG_QUARTER = dict(LM_LONG, n_layers=2)
# the smoke LM at half depth, full width: phases 8, 9 (a, b, d) and 16,
# whose CPU twins and host-bound serving loops take the most host time,
# run it since phase 19 joined the script (phases 3-5 and 7 keep its 4
# layers)
LM_CUT = dict(LM, n_layers=2)
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
             dtype_policy=None, diagnostics=None):
    """The zoo TransformerLM with `params` loaded; `lr` (a rate or a
    schedule) replaces the learning rate of its Adam(1e-3) on every
    layer; `dtype_policy` and `diagnostics` go to `init`."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    net = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                        ff_multiplier=cfg["ff"], max_len=cfg["max_len"],
                        sequence_parallel=sequence_parallel).init(
                            device=device, dtype_policy=dtype_policy,
                            diagnostics=diagnostics)
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
    (where spills go). The two cuobjdump listings run at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        sass, res = pool.map(lambda f: _cuobjdump(f, lib),
                             ("-sass", "-res-usage"))
    counts = mma_counts(sass)
    usage = res_usage(res)
    rows = []
    for (kind, dt, D, causal), fn in sorted(instances(counts).items()):
        use = usage.get(fn, {})
        rows.append(dict(kernel=prefix + kind, dtype=dt, D=D, causal=causal,
                         **counts[fn], registers=use.get("REG"),
                         stack=use.get("STACK"), local=use.get("LOCAL")))
    return rows


def phase_build(report, fails):
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {sorted(paths)} in {report['build_s']:.2f} s", flush=True)
    # both libraries' listings at once (four cuobjdump processes)
    todo = (("bwd_sass", "flash_attention_bwd", _bwd_instances,
             "flash_attention_bwd_", ("dq", "dkv")),
            ("fwd_sass", "flash_attention", _fwd_instances,
             "flash_attention_", ("fwd", "carry")))
    with ThreadPoolExecutor(2) as pool:
        listed = list(pool.map(lambda t: _sass_rows(paths[t[1]], t[2],
                                                    t[3]), todo))
    # the flash kernels must run on the tensor cores: every bf16 and fp32
    # instance (D 32/64/128, causal or not) of the backward's two kernels
    # and of the forward's two modes has HMMA (mma.sync) or HGMMA (wgmma)
    # in its SASS; registers, stack and local memory are reported beside
    for (key, _, _, prefix, kinds), rows in zip(todo, listed):
        report[key] = rows
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
    # head dims below 32, zero-padded by the wrappers: phase
    # 26's online drill (d32 / 4 heads), tenant drill and
    # transformer_text (d48 / 4), transformer_generate (d64 / 4)
    fl_cases += [("padded_d8", 16, 7, 4, 8), ("padded_d12", 16, 7, 4, 12),
                 ("padded_d16", 4, 31, 4, 16)]
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
    timings.update(_viterbi_checks(device, checks, fails, flush, small))
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
    # the long_context example's ring chunk [4, 32, 8, 4]: head dim 4,
    # zero-padded to 32 by the wrapper
    qp, kp, vp, kp2, vp2 = (rnd((4, 32, 8, 4), dt) for _ in range(5))
    check("padded_d4", qp, [(kp, vp, True), (kp2, vp2, False)],
          fresh(4, 32, 8, 4))
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
def viterbi_chain(T, S, seed, stay=0.98, flip=0.01):
    """Observations of a seeded metastable chain over S labels: the
    hidden label stays with probability `stay`, else hops uniformly, and
    each observation is a uniform draw instead with probability `flip`
    (phase 23 (c)'s noisy labels)."""
    rng = np.random.default_rng(seed)
    hops = np.flatnonzero(rng.random(T) >= stay)
    hidden = np.empty(T, np.int64)
    starts = np.concatenate([[0], hops, [T]])
    labels = rng.integers(0, S, len(starts) - 1)
    for a, b, lab in zip(starts[:-1], starts[1:], labels):
        hidden[a:b] = lab
    noisy = rng.random(T) < flip
    return np.where(noisy, rng.integers(0, S, T), hidden)


def viterbi_tables(T, S, seed):
    """Seeded row-normalised float32 log tables: emissions [T, S] (rows
    of softmax(2 z)), transitions [S, S] (rows of softmax(z)) and a
    prior [S]."""
    import torch
    g = torch.Generator().manual_seed(seed)
    em = torch.log_softmax(2 * torch.randn((T, S), generator=g), dim=1)
    tr = torch.log_softmax(torch.randn((S, S), generator=g), dim=1)
    pr = torch.log_softmax(torch.randn(S, generator=g), dim=0)
    return em, tr, pr


def viterbi_bound(T, S):
    """The decode's least time: 2 (T - 1) S^2 fp32 adds and compares
    (plus an add a state a step), and its inputs read and path and
    score written once."""
    nbytes = 4 * (T * S + S * S + S + T + 1)
    ops = 2.0 * (T - 1) * S * S + (T - 1) * S + S
    return bound(nbytes, ops, "float32")


def _viterbi_checks(device, checks, fails, flush, small):
    """The Viterbi scan kernel against its plain version on the same
    inputs, path and score bit for bit: S = 2, 77 (the text LSTM's
    charset), 512 (the smoke LM's vocab) and 1100 (more states than a
    block has threads), T = 1, a ragged T, tables full of ties with
    -inf transitions; timed at phase 23 (c)'s two shapes, the plain
    version once (its T steps are T launch rounds)."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.kernels import viterbi as kv
    t_start = time.perf_counter()
    cases = [("S2", 1000, 2), ("S77", 1000, 77), ("S512", 300, 512),
             ("S1100", 100, 1100), ("T1", 1, 77), ("ragged", 777, 77),
             ("ties", 500, 77)]
    if small:
        cases = [(c, min(T, 40), min(S, 33)) for c, T, S in cases]
    timings = {}
    for case, T, S in cases:
        em, tr, pr = viterbi_tables(T, S, seed=T + S)
        if case == "ties":
            # integer tables tie at every step; a banded chain with -inf
            # outside the band, and one state nothing reaches
            em = -torch.randint(0, 3, (T, S), generator=torch.Generator()
                                .manual_seed(3)).float()
            band = (torch.arange(S)[:, None] - torch.arange(S)[None, :]
                    ).abs() > 2
            tr = torch.zeros(S, S).masked_fill(band, float("-inf"))
            tr[:, S // 2] = float("-inf")
            pr = torch.zeros(S)
        em, tr, pr = (t.to(device) for t in (em, tr, pr))
        n0 = K.LAUNCHES["viterbi"]
        score, path = kv.viterbi(em, tr, pr)
        launched = K.LAUNCHES["viterbi"] - n0
        score0, path0 = kv.viterbi_plain(em, tr, pr)
        err = abs(score.item() - score0.item()) if torch.isfinite(
            score0) else 0.0
        equal = bool(torch.equal(path, path0) and torch.equal(score, score0))
        ok = fails.check(equal and launched == (device.type == "cuda"),
                         f"viterbi {case} [T {T}, S {S}]: path and score "
                         f"bit-equal {equal} (score {score.item()} vs "
                         f"{score0.item()}), launches {launched}")
        checks.append(dict(kernel="viterbi", case=case, dtype="float32",
                           shape=[T, S], max_abs_err=err, tol=0.0, ok=ok))
    # phase 23 (c)'s two decodes: the noisy-label chain through the
    # Viterbi class's tables, and viterbi_decode at the smoke LM's vocab
    from deeplearning4j_tpu_torch.util import Viterbi
    shapes = [("noisy_labels",) + VITERBI_CHAIN_SHAPE,
              ("lm_vocab",) + VITERBI_LM_SHAPE]
    if small:
        shapes = [(c, 300, min(S, 33)) for c, _, S in shapes]
    for case, T, S in shapes:
        if case == "noisy_labels":
            v = Viterbi(S, device="cpu")
            obs = viterbi_chain(T, S, seed=23)
            em = torch.from_numpy(v._log_emit[:, obs].T).float()
            tr = torch.from_numpy(v._log_trans).float()
            pr = torch.from_numpy(v._log_prior).float()
        else:
            em, tr, pr = viterbi_tables(T, S, seed=2323)
        em, tr, pr = (t.to(device) for t in (em, tr, pr))
        score, path = kv.viterbi(em, tr, pr)
        _sync(device)
        t0 = time.perf_counter()
        score0, path0 = kv.viterbi_plain(em, tr, pr)
        _sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = bool(torch.equal(path, path0) and torch.equal(score, score0))
        ok = fails.check(equal, f"viterbi {case} [T {T}, S {S}]: path and "
                                f"score bit-equal {equal}")
        checks.append(dict(kernel="viterbi", case=case, dtype="float32",
                           shape=[T, S], max_abs_err=0.0 if equal else None,
                           tol=0.0, ok=ok))
        key = ("viterbi", "float32") if case == "noisy_labels" else (
            "viterbi", "float32", case)
        timings[key] = dict(
            shape=[T, S], max_abs_err=abs(score.item() - score0.item()),
            ms=timer(device, lambda: kv.viterbi(em, tr, pr),
                     iters=20 if case == "noisy_labels" else 10, warmup=1,
                     flush=flush),
            # the plain version's T steps take seconds: the host clock
            # around its one call above, to a synchronize
            plain_ms=plain_ms,
            library_ms=None, bound=viterbi_bound(T, S))
    print(f"[kernels] viterbi checks and timings "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    return timings


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
    """One server over `reqs` ([(prompt, {generate_async kwargs})]),
    warmed by `GenerationServer.warmup(warm_len)` (a length or a
    (shortest, longest) range; None: not warmed): (token lists, wall
    seconds, launches by kernel and by dtype of the run, the engine). The
    launch counts start at 0 just before the requests are submitted."""
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
    if warm_len is not None:
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
    # each server warms on the traffic's length buckets only
    warm = (int(min(lens)), int(max(lens)))
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
    pool_bytes = eng.pool.device_bytes()
    row.update(eps=eps, near_ties=ties, probs_max_err_vs_fp32=err,
               pool_bytes=pool_bytes, pool_bytes_fp32=2 * pool_bytes,
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
    pwarm = (int(min(len(p) for p in pre_prompts)),
             int(max(len(p) for p in pre_prompts)))
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
    # evaluation: the trained net on the card through `evaluate()` and
    # `evaluate_roc_multi_class()`, against the same evaluators over its
    # copy's one `output()` on the CPU (each CPU forward over the held-out
    # set takes seconds; the evaluators read nothing but the outputs)
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
    Xe, Me, Ye = classifier_data(cfg, n_eval, seed=23)
    ds = DataSet(Xe, Ye, features_mask=Me)
    twin = from_jax_params(build_classifier(cfg, "cpu"), to_jax_params(net))
    t0 = time.perf_counter()
    e_card, r_card = net.evaluate(ds), net.evaluate_roc_multi_class(ds)
    eval_s = time.perf_counter() - t0
    p_card = net.output(Xe, mask=Me).cpu().numpy()
    p_cpu = twin.output(Xe, mask=Me).numpy()
    e_cpu, r_cpu = Evaluation(), ROCMultiClass()
    e_cpu.eval(Ye, p_cpu)
    r_cpu.eval(Ye, p_cpu)
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
    cfg = dict(LM, n_layers=2, max_len=64) if small else LM_CUT
    long_cfg = (dict(LM_LONG, vocab=64, d_model=64, n_layers=2, max_len=64)
                if small else LM_LONG_QUARTER)
    cls_cfg = (dict(CLS, n_layers=2, max_len=64, vocab=64) if small
               else dict(CLS, n_layers=LM_CUT["n_layers"]))
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


def graph_lm(cfg, device, params, dtype_policy=None, sequence_parallel=None):
    """The smoke LM's layer list built with `graph_builder` as a chain of
    layer nodes named by the layer's index (so its trees are keyed as the
    MultiLayerNetwork's), with `params` loaded; `sequence_parallel` goes
    to its attention layers."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    conf = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                         n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                         ff_multiplier=cfg["ff"],
                         max_len=cfg["max_len"],
                         sequence_parallel=sequence_parallel).conf()
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
# phase 13 runs it at 2 of its 4 blocks, full width, since phase 20 joined
# the script (the CPU twin's steps carry host time; phase 18 and
# `--profile-layers-rest` keep 4)
MOE_LM_CUT = dict(MOE_LM, n_layers=2)
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
                vocab=64) if small else MOE_LM_CUT)
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
    frozen = [getattr(l.updater, "name", None) for l in net.layers]
    fails.check(frozen[:4] == ["noop"] * 4 and "noop" not in frozen[4:],
                f"TL updaters {frozen}")
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
           if small else LM_LONG_QUARTER)
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


# ------------------------------------------ phase 15: telemetry and the data
TELEMETRY = dict(B=8, steps=6, poison_at=3, rf=2, spe=3, timed=3,
                 profiled=2, cpu_B=1, cpu_T=63, lenet_B=128, lenet_steps=3)
TELEMETRY_SMALL = dict(B=2, steps=6, poison_at=3, rf=2, spe=3, timed=2,
                       profiled=1, cpu_B=1, cpu_T=15, lenet_B=16,
                       lenet_steps=2)
TELEMETRY_KERNELS = RUNTIME_KERNELS
# the card's statistics against the same statistics recomputed in float64
# from the step's own tensors (params before and after, gradients,
# activations): relative to each value (an activation mean relative to
# its std)
DIAG_RTOL = 1e-5


def _tele_nets(cfg, device, params, policy):
    """A factory of the long-context LM on `device` at `policy` with
    Adam(`lr`) and `diagnostics` (a spec, or None: off), `params` loaded
    (`build_lm` without its `init` draws, which the load overwrites)."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    conf = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                         n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                         ff_multiplier=cfg["ff"],
                         max_len=cfg["max_len"]).conf()

    def build(diagnostics=None, lr=LONG_LR):
        net = MultiLayerNetwork(conf, device=device, dtype_policy=policy,
                                diagnostics=diagnostics)
        for layer in net.layers:
            layer.updater = Adam(lr)
        return from_jax_params(net, params)
    return build


def _tensors_of(net):
    """Clones of every param and Adam moment, keyed."""
    out = {k: t.detach().clone() for k, t in net.param_table().items()}
    for lk, lst in net.updater_state.items():
        for pk, st in lst.items():
            for sk, t in st.items():
                out[f"{lk}_{pk}/{sk}"] = t.detach().clone()
    return out


def _same_bits(a, b, nan_equal=False):
    """The keys of two `_tensors_of` whose tensors differ (NaN equal to
    NaN when `nan_equal`)."""
    import torch
    bad = []
    for k, u in a.items():
        v = b[k]
        same = (bool(torch.all((u == v) | (torch.isnan(u) & torch.isnan(v))))
                if nan_equal else torch.equal(u, v))
        if not same:
            bad.append(k)
    return bad


def _flat_keys(d):
    """A `_last_diagnostics` dict as its set of "<part>/<key>/<stat>"."""
    keys = {f"finite/{k}" for k in d["finite"]}
    for part in ("params", "activations"):
        keys |= {f"{part}/{k}/{s}" for k, st in d[part].items() for s in st}
    return keys


def _diag_reference(net, X1, Y1):
    """One more step of `net`, its statistics recomputed in float64 from
    the step's own tensors: the params before and after it, its
    gradients (the step is deterministic: a second backward from the same
    state and key gives the same bits, phase 14's probe) and each layer's
    output in that backward's forward. Returns the worst relative error
    of the card's statistics, and its key."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    def host(t):
        return t.detach().double().cpu()
    it = net.iteration_count
    old = {k: host(t) for k, t in net.param_table().items()}
    acts, hooks = {}, []
    for key, layer in list(net.keyed())[:-1]:
        hooks.append(layer.register_forward_hook(
            lambda m, i, o, key=key: acts.__setitem__(key, host(o))))
    xs, ys = net._features(X1), net._labels(Y1)
    try:
        _, grads, _ = net._loss_and_grads(lambda st: net._loss_fn(
            xs, ys, train=True, rng=net._step_key(it), new_state=st))
    finally:
        for h in hooks:
            h.remove()
    grads = net._normalize_gradients(grads)
    g = {f"{k}_{n}": host(grads[id(p)]) for k, layer in net.keyed()
         for n, p in layer.jax_param_map().items()}
    net.fit(DataSet(X1, Y1), batch_size=len(X1))
    new = {k: host(t) for k, t in net.param_table().items()}
    got = net._last_diagnostics
    worst = (0.0, "")

    def held(key, v, want, scale=None):
        nonlocal worst
        den = abs(want) if scale is None else scale
        err = abs(v - want) / den if den > 0 else abs(v - want)
        if err > worst[0]:
            worst = (err, key)
    for k, p in new.items():
        upd = old[k] - p
        w = {"param_mm": p.abs().mean(), "param_l2": p.norm(),
             "upd_mm": upd.abs().mean(), "upd_l2": upd.norm(),
             "grad_mm": g[k].abs().mean(), "grad_l2": g[k].norm()}
        w["ratio"] = w["upd_mm"] / (w["param_mm"] + 1e-12)
        for s, v in w.items():
            held(f"{k}.{s}", got["params"][k][s], float(v))
    for k, h in acts.items():
        std, mean = torch.std_mean(h, correction=0)
        st = got["activations"][k]
        held(f"{k}.mean", st["mean"], float(mean), scale=float(std))
        held(f"{k}.std", st["std"], float(std))
        held(f"{k}.dead", st["dead"], float((h == 0).double().mean()),
             scale=1.0)
    return worst


def _tele_parity(fails, build, cpu_build, X, Y, c, tag):
    """(a) diagnostics off against skip with activation statistics at
    report_frequency 1: params and moments bit-equal after the steps,
    the card's key set the CPU port's, the values within DIAG_RTOL of
    float64 recomputed from a further step's own tensors."""
    from deeplearning4j_tpu_torch.monitor import DiagnosticsConfig
    B, n = c["B"], c["steps"]
    spec = DiagnosticsConfig(watchdog="skip", activation_stats=True)
    off = build()
    l_off = _fit_steps(off, X[:B * n], Y[:B * n], B)
    t_off = _tensors_of(off)
    del off
    on = build(spec)
    l_on = _fit_steps(on, X[:B * n], Y[:B * n], B)
    bad = _same_bits(t_off, _tensors_of(on))
    out = dict(bit_equal=not bad and l_on == l_off, losses=l_on)
    fails.check(out["bit_equal"], f"telemetry {tag} (a): skip is not "
                f"bit-equal to off ({bad[:4]}; losses {l_off} / {l_on})")
    cpu = cpu_build(spec)
    cpu.fit(X[:1, :c["cpu_T"]], Y[:1, :c["cpu_T"]], batch_size=1)
    want, got = _flat_keys(cpu._last_diagnostics), _flat_keys(
        on._last_diagnostics)
    out["keys"] = len(got)
    fails.check(got == want, f"telemetry {tag} (a): the card's keys differ "
                f"from the CPU port's ({sorted(got ^ want)[:4]})")
    err, key = _diag_reference(on, X[B * n:B * (n + 1)],
                               Y[B * n:B * (n + 1)])
    out["stats_max_rel_err"], out["stats_worst_key"] = err, key
    fails.check(err <= DIAG_RTOL, f"telemetry {tag} (a): statistic {key} "
                f"{err} from its float64 recomputation (tol {DIAG_RTOL})")
    return out


def _tele_poison(fails, build, cpu_build, X, Y, c, tag):
    """(b) Adam's rate inf at iteration `poison_at`: warn keeps the off
    run's trajectory, NaN positions included; skip leaves p, m and v
    bit-equal to the step before, counts 1 skip and 1 non-finite step and
    ends finite, its losses held to the CPU port's same run at
    [cpu_B, cpu_T]; halt raises at the iteration with layer keys."""
    import torch
    from deeplearning4j_tpu_torch.common.schedules import MapSchedule
    from deeplearning4j_tpu_torch.monitor import NonFiniteGradientsError
    B, n, at = c["B"], c["steps"], c["poison_at"]
    lr = MapSchedule({0: LONG_LR, at: float("inf"), at + 1: LONG_LR})
    Xs, Ys = X[:B * n], Y[:B * n]
    out = {}
    off = build(lr=lr)
    _fit_steps(off, Xs, Ys, B)
    t_off = _tensors_of(off)
    del off
    warn = build("warn", lr=lr)
    _fit_steps(warn, Xs, Ys, B)
    bad = _same_bits(t_off, _tensors_of(warn), nan_equal=True)
    out["warn_equal_off"] = not bad and warn._diag.nonfinite_total >= 1
    fails.check(out["warn_equal_off"], f"telemetry {tag} (b): warn moved "
                f"the trajectory ({bad[:4]}) or saw no non-finite step")
    del warn, t_off
    skip = build("skip", lr=lr)
    losses = _fit_steps(skip, Xs[:B * at], Ys[:B * at], B)
    before = _tensors_of(skip)
    losses += _fit_steps(skip, Xs[B * at:B * (at + 1)],
                         Ys[B * at:B * (at + 1)], B)
    bad = _same_bits(before, _tensors_of(skip))
    losses += _fit_steps(skip, Xs[B * (at + 1):], Ys[B * (at + 1):], B)
    finite = all(bool(torch.isfinite(t).all())
                 for t in _tensors_of(skip).values())
    out.update(skip_unchanged=not bad, skipped=skip._diag.skipped_total,
               nonfinite=skip._diag.nonfinite_total, finite=finite,
               skip_losses=losses)
    fails.check(not bad and out["skipped"] == out["nonfinite"] == 1
                and finite, f"telemetry {tag} (b): skip changed {bad[:4]}, "
                f"skipped {out['skipped']} nonfinite {out['nonfinite']}, "
                f"finite {finite}")
    del skip
    # the same skip run at [cpu_B, cpu_T], card against the CPU port
    cb, ct = c["cpu_B"], c["cpu_T"]
    Xc, Yc = X[:cb * n, :ct], Y[:cb * n, :ct]
    small = [_fit_steps(b("skip", lr=lr), Xc, Yc, cb)
             for b in (build, cpu_build)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*small))
    out.update(cpu_losses=small[1], card_small_losses=small[0],
               cpu_loss_max_rel_err=rel)
    tol = TRAIN_LOSS_RTOL if tag == "float32" else MIXED_STEP0_RTOL
    fails.check(rel <= tol, f"telemetry {tag} (b): skip losses card vs "
                f"CPU rel {rel} (tol {tol})")
    halt = build("halt", lr=lr)
    try:
        _fit_steps(halt, Xs, Ys, B)
        out["halt"] = None
    except NonFiniteGradientsError as e:
        out["halt"] = dict(iteration=e.iteration, layers=len(e.layer_keys))
    fails.check(out["halt"] is not None and out["halt"]["iteration"] == at
                and out["halt"]["layers"] > 0,
                f"telemetry {tag} (b): halt raised {out['halt']}")
    return out


def _tele_transfers(fails, build, X, Y, c):
    """(c) the d2h reads (report_frequency `rf` over `steps` steps; spe
    `spe`) and (d) the spans and the exposition, with monitoring on; the
    Chrome trace is written to OUT_DIR/telemetry_trace.json."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import DiagnosticsConfig
    B, n = c["B"], c["steps"]
    reg = monitor.registry()

    def d2h():
        return reg.counter("jax_transfers_total", direction="d2h").value
    monitor.tracer().clear()
    os.makedirs(OUT_DIR, exist_ok=True)
    net = build(DiagnosticsConfig(report_frequency=c["rf"]))
    before = d2h()
    _fit_steps(net, X[:B * n], Y[:B * n], B)
    out = dict(d2h_cadence=d2h() - before)
    trace = json.loads(monitor.tracer().export_chrome_trace(
        os.path.join(OUT_DIR, "telemetry_trace.json")))
    spans = {}
    for ev in trace["traceEvents"]:
        spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    out["spans"] = spans
    del net
    net = build(True)
    before = d2h()
    net.fit(X[:B * n], Y[:B * n], batch_size=B, shuffle=False,
            steps_per_execution=c["spe"])
    out["d2h_spe"] = d2h() - before
    text = reg.exposition()
    need = ("watchdog_nonfinite_total ", "watchdog_skipped_total ",
            "training_grad_l2{", "training_update_ratio{",
            "training_activation_std{", "training_iterations_total{")
    out["exposition_missing"] = [f for f in need if f not in text]
    want_cad = -(-n // c["rf"])
    fails.check(out["d2h_cadence"] == want_cad and out["d2h_spe"] ==
                n // c["spe"], f"telemetry (c): d2h {out['d2h_cadence']} "
                f"(want {want_cad}), spe {out['d2h_spe']} (want "
                f"{n // c['spe']})")
    fails.check(spans.get("fit/forward_backward") == n
                and spans.get("fit/update") == n,
                f"telemetry (d): spans {spans} (want {n} of each)")
    fails.check(not out["exposition_missing"], f"telemetry (d): exposition "
                f"lacks {out['exposition_missing']}")
    return out


def _tele_timed(device, net, X, Y, B, k, p, it=None):
    """ms/step of `k` steps after one warm step, then `p` profiled steps
    (none when `p` is 0): device ms, launches and host-to-device copy ms
    per step. `it(X, Y)` makes the iterator (default: one `fit` per B-row
    DataSet)."""
    import torch
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)

    def steps(a, b):
        if it is None:
            return _fit_steps(net, X[a * B:b * B], Y[a * B:b * B], B)
        scores = CollectScoresListener()
        net.set_listeners(scores)
        net.fit(it(X[a * B:b * B], Y[a * B:b * B]))
        return [s for _, s in scores.scores]
    losses = steps(0, 1)
    _sync(device)
    t0 = time.perf_counter()
    losses += steps(1, 1 + k)
    _sync(device)
    out = dict(ms_per_step=(time.perf_counter() - t0) / k * 1e3)
    if p and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            losses += steps(1 + k, 1 + k + p)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        s = _profile_summary(prof, wall)
        h2d = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if "HtoD" in ev.key) / 1e3
        out.update(device_ms_per_step=s["device_ms"] / p,
                   launches_per_step=s["launches"] / p,
                   h2d_ms_per_step=h2d / p,
                   busy_share=s["busy_share"])
    elif p:
        losses += steps(1 + k, 1 + k + p)
    out["losses"] = losses
    return out


def _tele_times(device, fails, build, X, Y, c, tag):
    """(e) the overheads: diagnostics off, on (statistics, no watchdog)
    and skip (fp32: off again last); fp32 also monitoring on (diagnostics
    off) and DevicePrefetchIterator(depth=2) against the plain iterator
    (losses and params bit-equal)."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                                   DevicePrefetchIterator)
    from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.monitor.tracer import Tracer
    B, k, p = c["B"], c["timed"], c["profiled"]
    out = {}
    arms = [("diag_off", None, p), ("diag_on", True, p),
            ("diag_skip", "skip", p)]
    if tag == "float32":
        arms.append(("diag_off_again", None, 0))
    for name, spec, prof in arms:
        out[name] = _tele_timed(device, build(spec), X, Y, B, k, prof)
    if tag != "float32":
        return out
    monitor.enable(registry=MetricsRegistry(), tracer=Tracer())
    try:
        # host float math only: timed, not profiled
        out["monitor_on"] = _tele_timed(device, build(), X, Y, B, k, 0)
    finally:
        monitor.disable()

    def plain(x, y):
        return ArrayDataSetIterator(x, y, batch_size=B)

    def prefetch(x, y):
        return DevicePrefetchIterator(plain(x, y), depth=2, device=device)
    nets = {}
    for name, it, prof in (("plain_iterator", plain, p),
                           ("prefetch_depth2", prefetch, p),
                           ("prefetch_depth2_again", prefetch, 0),
                           ("plain_iterator_again", plain, 0)):
        nets[name] = net = build()
        out[name] = _tele_timed(device, net, X, Y, B, k, prof, it=it)
    bad = _same_bits(_tensors_of(nets["plain_iterator_again"]),
                     _tensors_of(nets["prefetch_depth2_again"]))
    out["prefetch_bit_equal"] = (
        not bad and out["plain_iterator_again"]["losses"]
        == out["prefetch_depth2_again"]["losses"])
    fails.check(out["prefetch_bit_equal"], f"telemetry (e): the prefetched "
                f"run is not bit-equal to the plain one ({bad[:4]})")
    return out


def _counts_or_ties(ev_card, ev_cpu, p_card, p_cpu, edges, fields):
    """Whether two evaluators' count fields are equal, else whether every
    prediction that changed bin or side sits within twice the largest
    card-vs-CPU difference of an edge (a near-tie, counted)."""
    same = all(np.array_equal(getattr(ev_card, f), getattr(ev_cpu, f))
               for f in fields)
    eps = 2 * float(np.abs(p_card - p_cpu).max())
    moved = np.searchsorted(edges, p_card) != np.searchsorted(edges, p_cpu)
    near = np.min(np.abs(p_cpu[..., None] - np.asarray(edges)), axis=-1)
    return same, int(moved.sum()), bool(np.all(near[moved] <= eps))


def _tele_data(device, fails, c):
    """(f) the packaged LeNet fed by RecordReaderDataSetIterator over a
    CSV of the committed digits, against the array iterator over the
    same rows (losses and params bit-equal); EvaluationBinary and
    EvaluationCalibration of the card's held-out outputs against the
    CPU's."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.datasets import (
        ArrayDataSetIterator, CSVRecordReader, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.eval import (EvaluationBinary,
                                               EvaluationCalibration)
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    from deeplearning4j_tpu_torch.datasets import DataSet, DataSetIterator
    from deeplearning4j_tpu_torch.zoo import LeNet, PretrainedType

    class Nhwc(DataSetIterator):
        """The record iterator's flat [B, 784] rows as LeNet's
        [B, 28, 28, 1]."""

        def __init__(self, base):
            self.base = base

        def reset(self):
            self.base.reset()

        def __iter__(self):
            for ds in self.base:
                yield DataSet(ds.features.reshape(-1, 28, 28, 1), ds.labels)
    X, Y = digits_28x28()
    B, n = c["lenet_B"], c["lenet_steps"]
    Xt, Yt = X[N_HELD_OUT:N_HELD_OUT + B * n], Y[N_HELD_OUT:
                                                 N_HELD_OUT + B * n]
    tmp = tempfile.mkdtemp(prefix="telemetry_csv_")
    try:
        path = os.path.join(tmp, "digits.csv")
        rows = np.concatenate([Xt.reshape(len(Xt), -1),
                               Yt.argmax(-1)[:, None]], axis=1)
        np.savetxt(path, rows, fmt="%.9g", delimiter=",")
        t0 = time.perf_counter()
        it = Nhwc(RecordReaderDataSetIterator(CSVRecordReader(path), B,
                                               label_index=784,
                                               num_classes=10))
        arrays = ArrayDataSetIterator(Xt, Yt, batch_size=B)
        out = dict(batches_equal=all(
            np.array_equal(a.features, b.features)
            and np.array_equal(a.labels, b.labels)
            for a, b in zip(it, arrays)))
        out["read_s"] = time.perf_counter() - t0
        # cuDNN's default backward algorithms are not deterministic: two
        # runs on equal batches are bit-equal only with deterministic ones
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        nets, losses = [], []
        try:
            for data in (it, arrays):
                net = LeNet().init_pretrained(PretrainedType.MNIST,
                                              device=device)
                scores = CollectScoresListener()
                net.set_listeners(scores)
                net.fit(data)
                nets.append(net)
                losses.append([s for _, s in scores.scores])
        finally:
            torch.backends.cudnn.deterministic = det
        out.update(seconds=time.perf_counter() - t0, losses=losses[0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = _same_bits(_tensors_of(nets[0]), _tensors_of(nets[1]))
    out["records_bit_equal"] = not bad and losses[0] == losses[1]
    fails.check(out["batches_equal"] and out["records_bit_equal"],
                f"telemetry (f): the record iterator's batches equal "
                f"{out['batches_equal']}, its run bit-equal to the array "
                f"iterator's {out['records_bit_equal']} ({bad[:4]}; "
                f"{losses})")
    Xh, Yh = X[:N_HELD_OUT], Y[:N_HELD_OUT]
    p_card = nets[0].output(Xh).cpu().numpy()
    p_cpu = _copy_to(nets[0], "cpu").output(Xh).numpy()
    evs = {}
    for side, p in (("card", p_card), ("cpu", p_cpu)):
        b, cal = EvaluationBinary(), EvaluationCalibration()
        b.eval(Yh, p)
        cal.eval(Yh, p)
        evs[side] = (b, cal)
    same_b, moved_b, ties_b = _counts_or_ties(
        evs["card"][0], evs["cpu"][0], p_card, p_cpu, [0.5],
        ("_tp", "_fp", "_tn", "_fn"))
    same_c, moved_c, ties_c = _counts_or_ties(
        evs["card"][1], evs["cpu"][1], p_card, p_cpu,
        [i / 10 for i in range(1, 10)],
        ("_bin_counts", "_bin_pos", "_prob_hist"))
    out.update(binary_counts_equal=same_b, binary_moved=moved_b,
               calibration_counts_equal=same_c, calibration_moved=moved_c,
               output_max_abs_err=float(np.abs(p_card - p_cpu).max()),
               binary_f1_class0=evs["card"][0].f1(0),
               ece_class0=evs["card"][1].expected_calibration_error(0))
    fails.check((same_b or ties_b) and (same_c or ties_c),
                f"telemetry (f): evaluation counts card vs CPU: binary "
                f"{same_b} ({moved_b} moved), calibration {same_c} "
                f"({moved_c} moved), not all near an edge")
    return out


def _tele_gradcheck(device, fails):
    """(g) the gradient checker at its default device (the card): a
    float64 twin of a conv, pooling and softmax net checked there through
    cuDNN and cuBLAS in float64, the same check on the CPU beside it."""
    from deeplearning4j_tpu_torch.gradientcheck import check_model_gradients
    from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer, OutputLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(42).list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                    stride=(1, 1), activation="tanh"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 2))
            .build())
    x = np.random.default_rng(0).standard_normal((3, 6, 6, 2))
    y = np.eye(2)[np.random.default_rng(1).integers(0, 2, 3)]
    t0 = time.perf_counter()
    net = MultiLayerNetwork(conf, device=device).init()
    if device.type == "cuda":
        ok, worst, bad = check_model_gradients(net, x, y)
    else:
        ok, worst, bad = check_model_gradients(net, x, y, device="cpu")
    seconds = time.perf_counter() - t0
    cok, cworst, _ = check_model_gradients(_copy_to(net, "cpu"), x, y,
                                           device="cpu")
    out = dict(ok=ok, max_rel_err=worst, cpu_ok=cok, cpu_max_rel_err=cworst,
               seconds=seconds)
    fails.check(ok and cok, f"telemetry (g): gradient check on "
                f"{device.type} {ok} (worst {worst:.2e}, {bad[:3]}), on the "
                f"CPU {cok} (worst {cworst:.2e})")
    return out


def phase_telemetry(device, report, fails, small=False):
    """Phase 15 on `device` (fp32 with TF32 off, and mixed_bf16): the
    long-context LM's diagnostics, watchdog, transfers, spans and
    overheads, and the data plane and evaluators on LeNet. `small` (the
    CPU rehearsal) shrinks the net and data and keeps the checks.
    Returns the phase's kernel launches."""
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.monitor.tracer import Tracer
    c = TELEMETRY_SMALL if small else TELEMETRY
    cfg = (dict(LM_LONG, vocab=64, d_model=64, n_layers=2, max_len=64)
           if small else LM_LONG_QUARTER)
    out = dict(config=dict(cfg, B=c["B"], T=cfg["max_len"] - 1,
                           lr=LONG_LR, steps=c["steps"]))
    t0 = time.perf_counter()
    K.reset_launches()
    params = random_lm_params(cfg, seed=150, head_scale=1.0)
    n_rows = c["B"] * (2 + c["timed"] + c["profiled"] + c["steps"])
    X, Y = lm_corpus(cfg, n_rows, seed=15)
    out["lm"] = {}
    for policy in (None, MIXED):
        tag = policy or "float32"
        build = _tele_nets(cfg, device, params, policy)
        cpu_build = _tele_nets(cfg, "cpu", params, policy)
        r = out["lm"][tag] = {}
        t1 = time.perf_counter()
        r["parity"] = _tele_parity(fails, build, cpu_build, X, Y, c, tag)
        if tag == "float32":
            monitor.enable(registry=MetricsRegistry(), tracer=Tracer())
        try:
            r["poison"] = _tele_poison(fails, build, cpu_build, X, Y, c,
                                       tag)
            if tag == "float32":
                r["transfers"] = _tele_transfers(fails, build, X, Y, c)
        finally:
            monitor.disable()
        r["times"] = _tele_times(device, fails, build, X, Y, c, tag)
        r["seconds"] = time.perf_counter() - t1
    lm_launches = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    if device.type == "cuda":
        for k in TELEMETRY_KERNELS:
            fails.check(lm_launches[k] > 0, f"telemetry: kernel {k} did not "
                        f"launch on the long-context LM")
    out["data"] = _tele_data(device, fails, c)
    out["gradcheck"] = _tele_gradcheck(device, fails)
    _sync(device)
    total = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    out["launches"], out["lm_launches"] = total, lm_launches
    out["seconds"] = time.perf_counter() - t0
    report["telemetry"] = out
    _print_telemetry(out)
    return total


def _print_telemetry(out):
    for tag, r in out["lm"].items():
        a, b = r["parity"], r["poison"]
        print(f"[telemetry] (a) LM {tag} [{out['config']['B']}, "
              f"{out['config']['T']}]: skip vs off bit-equal "
              f"{a['bit_equal']}; {a['keys']} keys as the CPU's; stats vs "
              f"float64 worst {a['stats_max_rel_err']:.2e} "
              f"({a['stats_worst_key']})", flush=True)
        print(f"[telemetry] (b) LM {tag} lr inf at 3: warn = off "
              f"{b['warn_equal_off']}; skip unchanged {b['skip_unchanged']}"
              f" skipped {b['skipped']} nonfinite {b['nonfinite']} finite "
              f"{b['finite']}; card vs CPU skip losses rel "
              f"{b['cpu_loss_max_rel_err']:.2e}; halt {b['halt']}",
              flush=True)
        if "transfers" in r:
            t = r["transfers"]
            print(f"[telemetry] (c) d2h rf 2: {t['d2h_cadence']}, spe 3: "
                  f"{t['d2h_spe']}; (d) spans {t['spans']}; exposition "
                  f"missing {t['exposition_missing']}", flush=True)
        times = " | ".join(
            f"{k} {v['ms_per_step']:.2f} ms/step"
            + (f", device {v['device_ms_per_step']:.2f} ms, "
               f"{v['launches_per_step']:.0f} launches, h2d "
               f"{v['h2d_ms_per_step']:.3f} ms"
               if "device_ms_per_step" in v else "")
            for k, v in r["times"].items() if isinstance(v, dict))
        print(f"[telemetry] (e) LM {tag}: {times}; prefetch bit-equal "
              f"{r['times'].get('prefetch_bit_equal')}; {r['seconds']:.1f} s",
              flush=True)
    d = out["data"]
    print(f"[telemetry] (f) LeNet from CSV records: batches equal "
          f"{d['batches_equal']}, run bit-equal {d['records_bit_equal']} "
          f"({d['seconds']:.2f} s); binary counts "
          f"equal {d['binary_counts_equal']} (moved {d['binary_moved']}), "
          f"calibration {d['calibration_counts_equal']} (moved "
          f"{d['calibration_moved']}); output err "
          f"{d['output_max_abs_err']:.2e}; phase {out['seconds']:.1f} s",
          flush=True)
    g = out["gradcheck"]
    print(f"[telemetry] (g) float64 gradient check at the default device: "
          f"{g['ok']}, worst rel {g['max_rel_err']:.2e} ({g['seconds']:.2f}"
          f" s); on the CPU {g['cpu_ok']}, {g['cpu_max_rel_err']:.2e}",
          flush=True)



def telemetry_probe(device, repeats=5):
    """Where a diagnostics step's host time goes (`--telemetry-probe`):
    the long-context LM at [8, 2047] with diagnostics on, fp32 and
    mixed, `fit` over one warm step and `repeats` more with monitoring
    on, each part of a step read from the spans the step records (no
    synchronize between them, so a part that waits for the card reads
    the wait): the forward and backward enqueued (`fit/forward_backward`
    less the parts inside it), `fit/snapshot`, `fit/apply_updates`,
    `fit/collect_and_gate`, `fit/read_loss` (the wait in `float(loss)`)
    and `fit/update` (the readback, `process`, and the monitor's
    listener). Medians over the steps after the warm one."""
    import torch
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import (
        DiagnosticsConfig, MetricsRegistry, Tracer)
    cfg, B = LM_LONG, 8
    params = random_lm_params(cfg, seed=150, head_scale=1.0)
    X, Y = lm_corpus(cfg, B * (repeats + 1), seed=15)
    inner = ("fit/snapshot", "fit/apply_updates", "fit/collect_and_gate",
             "fit/read_loss")
    out = {}
    for policy in (None, MIXED):
        net = _tele_nets(cfg, device, params, policy)(
            DiagnosticsConfig(report_frequency=1))
        tracer = Tracer()
        monitor.enable(registry=MetricsRegistry(), tracer=tracer)
        try:
            torch.cuda.synchronize()
            net.fit(X, Y, batch_size=B, shuffle=False)
            torch.cuda.synchronize()
        finally:
            monitor.disable()
        ms = {}
        for ev in tracer.events():
            if ev["ph"] == "X":
                ms.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
        steps = repeats + 1
        bad = {k: len(ms.get(k, [])) for k in inner + (
            "fit/forward_backward", "fit/update")
            if len(ms.get(k, [])) != steps}
        if bad:
            raise RuntimeError(f"telemetry probe: span counts {bad}, "
                               f"want {steps} each")
        fb = np.array(ms["fit/forward_backward"]) - sum(
            np.array(ms[k]) for k in inner)
        rows = {"forward_backward_enqueued": fb,
                **{k.split("/", 1)[1]: np.array(ms[k]) for k in inner},
                "process": np.array(ms["fit/update"])}
        med = {k: float(np.median(v[1:])) for k, v in rows.items()}
        out[policy or "float32"] = med
        print(f"[telemetry-probe] {policy or 'float32'} host ms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in med.items()),
              flush=True)
        del net
    return out

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
# ---------------------------------------------- phase 16: the request plane
SERVING_PLANE = dict(cfg=None, n_slots=8, block_len=16, greedy=12, sampled=4,
                     n_tok=32, lens=(16, 64), burst=24,
                     burst_tok=64, handoff=8, handoff_tok=32,
                     timed_prompt=128, dispatches=32, repeats=2,
                     cost_dispatches=32)
SERVING_PLANE_SMALL = dict(cfg=dict(LM, d_model=64, n_heads=4, n_layers=2,
                                    max_len=128),
                           n_slots=4, block_len=16, greedy=4, sampled=2,
                           n_tok=8, lens=(3, 24), burst=8,
                           burst_tok=16, handoff=3, handoff_tok=8,
                           timed_prompt=16, dispatches=6, repeats=1,
                           cost_dispatches=4)


class HostReads:
    """Counts the device-to-host reads the serving path makes
    (`Tensor.cpu`, `.item`, `.tolist`) while entered: reads of CUDA
    tensors on the card, every such call on the CPU (where they stand
    for the copies). The methods are wrapped on `torch.Tensor` for the
    window and restored after it."""

    NAMES = ("cpu", "item", "tolist")

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.n = 0

    def __enter__(self):
        import torch
        self._saved = {}
        for name in self.NAMES:
            own = name in torch.Tensor.__dict__
            orig = getattr(torch.Tensor, name)
            self._saved[name] = (own, orig)

            def counted(t, *a, _orig=orig, **k):
                if not self.cuda or t.is_cuda:
                    self.n += 1
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        import torch
        for name, (own, orig) in self._saved.items():
            if own:
                setattr(torch.Tensor, name, orig)
            else:
                delattr(torch.Tensor, name)
        return False


def drive_server(srv, reqs, n_tok, times=None):
    """Submit `reqs` ([(prompt, generate_async kwargs)]) to a built,
    unstarted server and run its scheduler's loop body
    (`_schedule_once`) in this thread until every stream ends: every
    request is queued before the first admission, so two runs see the
    same waves. `times`, a list, gets each iteration's host seconds.
    Returns the streams; the server is stopped after."""
    srv._running = True
    try:
        streams = [srv.generate_async(p, n_tok, **a) for p, a in reqs]
        for _ in range(100_000):
            if all(s._fut.done() for s in streams):
                break
            t0 = time.perf_counter()
            srv._schedule_once(srv.engine)
            if times is not None:
                times.append(time.perf_counter() - t0)
    finally:
        srv._running = False
        srv.stop()
    return streams


def _plane_server(net, c, warm=True, **kw):
    from deeplearning4j_tpu_torch.serving import GenerationServer
    max_len = net.layers[1].max_len
    bl = c["block_len"]
    srv = GenerationServer(net, n_slots=c["n_slots"], block_len=bl,
                           n_blocks=c["n_slots"] * (max_len // bl) + 1,
                           device=net.device, **kw)
    if warm:   # the traffic's length buckets only
        srv.warmup(c["lens"], 4)
    return srv


class _Monitored:
    """Monitoring on (a fresh registry and tracer) for the block, then
    off with the global sinks back."""

    def __enter__(self):
        from deeplearning4j_tpu_torch import monitor
        from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
        from deeplearning4j_tpu_torch.monitor.tracer import Tracer
        self.reg = monitor.enable(registry=MetricsRegistry(), tracer=Tracer())
        self.tracer = monitor.tracer()
        return self

    def __exit__(self, *exc):
        from deeplearning4j_tpu_torch import monitor
        monitor.disable()
        monitor._STATE.registry = monitor.GLOBAL_REGISTRY
        monitor._STATE.tracer = monitor.GLOBAL_TRACER
        return False


def _plane_sync(fails, net, c, reqs):
    """(a) One burst of greedy and sampled requests, monitoring off and
    on, driven in this thread: the streams token for token and the
    device-to-host reads (per decode dispatch too) equal."""
    runs = {}
    for tag in ("off", "on"):
        mon = _Monitored() if tag == "on" else None
        if mon is not None:
            mon.__enter__()
        try:
            srv = _plane_server(net, c)
            steps = [0]
            step = srv.engine.step

            def counted_step(**kw):
                steps[0] += 1
                return step(**kw)
            srv.engine.step = counted_step
            with HostReads(net.device) as reads:
                streams = drive_server(srv, reqs, c["n_tok"])
            runs[tag] = dict(
                tokens=[s.result(0).tolist() for s in streams],
                reads=reads.n, dispatches=steps[0],
                traces=[s.trace for s in streams],
                exposition=(mon.reg.exposition() if mon else None),
                goodput=srv.engine.goodput.snapshot())
        finally:
            if mon is not None:
                mon.__exit__()
    off, on = runs["off"], runs["on"]
    equal = off["tokens"] == on["tokens"]
    fails.check(equal, "serving_plane (a): monitoring on changed a stream")
    fails.check(off["reads"] == on["reads"]
                and off["dispatches"] == on["dispatches"],
                f"serving_plane (a): device-to-host reads off "
                f"{off['reads']} / on {on['reads']} over "
                f"{off['dispatches']} / {on['dispatches']} dispatches")
    traced = [t for t in on["traces"] if t is not None]
    fails.check(len(traced) == len(reqs)
                and all(t.finished and t.status == "ok"
                        and {p["name"] for p in t.phases}
                        >= {"queued", "prefill", "decode"} for t in traced),
                "serving_plane (a): a request's trace is missing a phase")
    fails.check(all(t is None for t in off["traces"]),
                "serving_plane (a): a trace was minted with monitoring off")
    expo = on["exposition"]
    fams = ("serving_requests_total", "serving_tokens_total",
            "serving_ttft_seconds", "serving_goodput_fraction",
            "serving_tokens_useful_total", "serving_step_seconds")
    fails.check(all(f in expo for f in fams),
                "serving_plane (a): a serving family is missing from the "
                "exposition")
    return dict(streams_equal=equal, reads_off=off["reads"],
                reads_on=on["reads"], dispatches=off["dispatches"],
                reads_per_dispatch=off["reads"] / max(1, off["dispatches"]),
                goodput=on["goodput"])


def _conserved(fails, eng, what, reg=None):
    from deeplearning4j_tpu_torch.monitor.goodput import (
        GOODPUT_COUNTER_FAMILIES)
    snap = eng.goodput.snapshot()
    ok = eng.goodput.conserved() and snap["dispatched_total"] > 0
    mirrored = True
    if reg is not None:
        mirrored = all(reg.counter(fam).value == snap[cls]
                       for cls, fam in GOODPUT_COUNTER_FAMILIES.items())
    fails.check(ok and mirrored, f"serving_plane (b) {what}: goodput "
                f"{snap} (conserved {ok}, mirrored {mirrored})")
    return snap


def _plane_goodput(fails, net, c, reqs):
    """(b) The goodput classes sum to the dispatched positions: a warmed
    run, a speculative run and a run through `drain()`, on the threaded
    server with monitoring on (the registry mirror equals the ledger)."""
    out = {}
    for what, kw in (("warmed", {}), ("speculative", dict(speculative=4))):
        with _Monitored() as mon:
            srv = _plane_server(net, c, **kw).start()
            try:
                for s in [srv.generate_async(p, c["n_tok"], **a)
                          for p, a in reqs]:
                    s.result(timeout=600)
            finally:
                srv.stop()
            snap = _conserved(fails, srv.engine, what, mon.reg)
        fails.check(snap["warmup"] > 0 and snap["useful"] > 0
                    and 0 < snap["goodput_fraction"] < 1,
                    f"serving_plane (b) {what}: {snap}")
        out[what] = dict(snap,
                         spec_dispatches=srv.engine.spec_dispatches_total)
    fails.check(out["speculative"]["spec_dispatches"] > 0,
                "serving_plane (b): the speculative run drafted nothing")
    with _Monitored() as mon:
        srv = _plane_server(net, c).start()
        try:
            streams = [srv.generate_async(p, c["n_tok"], **a)
                       for p, a in reqs]
            drained = srv.drain(timeout=600)
        finally:
            srv.stop()
        snap = _conserved(fails, srv.engine, "drain", mon.reg)
    fails.check(drained and all(len(s.result(0)) == c["n_tok"]
                                for s in streams) and snap["drain"] > 0,
                f"serving_plane (b) drain: drained {drained}, {snap}")
    out["drain"] = snap
    return out


def _plane_shed(fails, net, c, V):
    """(c) A burst against an `slo_ttft_s` below the projected TTFT: some
    requests shed with ShedError, the same number in
    `serving_shed_total`, in the SLO's bad counter and as a `shed` event
    with its reason on each shed request's trace."""
    from deeplearning4j_tpu_torch.monitor import SLOObjective
    from deeplearning4j_tpu_torch.serving import ShedError
    rng = np.random.default_rng(161)
    with _Monitored() as mon:
        srv = _plane_server(net, c, slo_ttft_s=0.0, name="plane",
                            slo=SLOObjective(ttft_s=600.0)).start()
        try:
            # one request first, so the scheduler has a tokens-a-second
            # estimate to project the burst's delay with
            srv.generate_async(rng.integers(0, V, 16), 8).result(timeout=600)
            streams = [srv.generate_async(rng.integers(0, V, 32),
                                          c["burst_tok"])
                       for _ in range(c["burst"])]
            shed, served = [], 0
            for s in streams:
                try:
                    s.result(timeout=600)
                    served += 1
                except ShedError:
                    shed.append(s)
        finally:
            srv.stop()
        reg = mon.reg
        n_counter = reg.counter("serving_shed_total",
                                server="plane").value
        n_bad = reg.counter("slo_requests_bad_total", model="plane").value
        n_good = reg.counter("slo_requests_good_total", model="plane").value
    reasons = [[e["args"].get("reason") for e in s.trace.events
                if e["name"] == "shed"] for s in shed]
    fails.check(len(shed) > 0 and n_counter == len(shed)
                and n_bad == len(shed) and n_good == served + 1
                and all(r and r[0] for r in reasons)
                and all(s.trace.status == "shed" for s in shed),
                f"serving_plane (c): shed {len(shed)}, serving_shed_total "
                f"{n_counter}, slo bad {n_bad}, good {n_good} of "
                f"{served + 1} served, reasons {reasons[:2]}")
    return dict(burst=c["burst"], shed=len(shed), served=served,
                serving_shed_total=n_counter, slo_bad=n_bad,
                slo_good=n_good, reason=reasons[0][0] if reasons else None)


def _plane_handoff(fails, net, c, V, tag):
    """(d) Every slot handed from a prefill engine to a decode engine
    through DLFP bytes continues bit-equal to the colocated stream (the
    same engine configuration admitting each prompt in a wave of its
    own and decoding them together); the export + encode and decode +
    adopt times, and the frames' MB."""
    from deeplearning4j_tpu_torch.serving import (
        DecodeWorker, PagedDecodeEngine, PrefillWorker, wire)
    rng = np.random.default_rng(162)
    lo, hi = c["lens"]
    prompts = [rng.integers(0, V, int(n))
               for n in rng.integers(lo, hi + 1, c["handoff"])]
    n_tok, dev = c["handoff_tok"], net.device
    max_len = net.layers[1].max_len
    kw = dict(n_slots=c["n_slots"], block_len=c["block_len"],
              n_blocks=c["n_slots"] * (max_len // c["block_len"]) + 1,
              device=dev)
    colo = PagedDecodeEngine(net, **kw)
    firsts, slots = [], []
    for p in prompts:
        slot, first, _ = colo.admit(p, n_tok)
        firsts.append(first)
        slots.append(slot)
    rest = {s: [] for s in slots}
    while colo.active.any():
        for s, toks in colo.step()[0].items():
            rest[s].extend(toks)
    want = [[f] + rest[s] for f, s in zip(firsts, slots)]
    pre, dec = PrefillWorker(net, **kw), DecodeWorker(net, **kw)
    export_ms, adopt_ms, mb = [], [], []
    got_first, adopted = [], []
    for i, p in enumerate(prompts):
        slot, first, _ = pre.engine.admit(p, n_tok, request_id=f"h{i}")
        _sync(dev)
        t0 = time.perf_counter()
        header, kv = pre.engine.export_handoff(slot)
        frame = wire.encode_handoff(header, kv)
        export_ms.append((time.perf_counter() - t0) * 1e3)
        pre.engine.evict(slot)
        mb.append(len(frame) / 2 ** 20)
        t0 = time.perf_counter()
        adopted.append(dec.adopt(frame))
        _sync(dev)
        adopt_ms.append((time.perf_counter() - t0) * 1e3)
        got_first.append(first)
    rest = dec.decode_to_completion(adopted)
    got = [[f] + rest[s] for f, s in zip(got_first, adopted)]
    bad = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    fails.check(not bad and all(len(g) == n_tok for g in got),
                f"serving_plane (d) {tag}: handed-off streams {bad} differ "
                f"from the colocated ones")
    return dict(slots=len(prompts), tokens=n_tok, streams_bit_equal=not bad,
                prompt_lens=[len(p) for p in prompts],
                frame_mb=mb, frame_mb_mean=float(np.mean(mb)),
                export_encode_ms=export_ms, decode_adopt_ms=adopt_ms,
                export_encode_ms_median=float(np.median(export_ms)),
                decode_adopt_ms_median=float(np.median(adopt_ms)),
                dtype=str(pre.engine.pool.kv[0][0].dtype))


def _plane_cost(fails, net, c, V):
    """(e) `decode_cost_report` and the roofline at the H100's peaks:
    the predicted ms of one decode dispatch beside the measured one (8
    active slots, the mean over `cost_dispatches` timed dispatches,
    synchronized)."""
    from deeplearning4j_tpu_torch.monitor import xprof
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    rng = np.random.default_rng(163)
    max_len = net.layers[1].max_len
    S, dev = c["n_slots"], net.device
    eng = PagedDecodeEngine(net, n_slots=S, block_len=c["block_len"],
                            n_blocks=S * (max_len // c["block_len"]) + 1,
                            device=dev)
    n = c["cost_dispatches"]
    reqs = [dict(prompt_ids=rng.integers(0, V, c["timed_prompt"]),
                 n_tokens=2 * n + 4) for _ in range(S)]
    eng.admit_many(reqs)
    for _ in range(3):
        eng.step()                                    # warm
    rep = eng.decode_cost_report()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    _sync(dev)
    measured = (time.perf_counter() - t0) / n * 1e3
    dtype = "bfloat16" if net.dtype.is_mixed else "float32"
    roof = xprof.roofline(rep["decode_flops_per_dispatch"],
                          rep["decode_bytes_per_step"]
                          * rep["steps_per_dispatch"], dtype=dtype)
    with _Monitored() as mon:
        xprof.publish_cost_report(dict(
            model="smoke_lm_decode", roofline=roof,
            per_op=dict(total_flops_per_step=rep["decode_flops_per_step"],
                        total_bytes_per_step=rep["decode_bytes_per_step"])))
        gauge = mon.reg.gauge("aot_cost_predicted_step_seconds",
                              model="smoke_lm_decode").value
    predicted = roof["predicted_step_seconds"] * 1e3
    fails.check(rep["decode_flops_per_step"] > 0 and measured > 0
                and gauge == roof["predicted_step_seconds"],
                f"serving_plane (e): cost report {rep}, measured "
                f"{measured} ms, gauge {gauge}")
    return dict(report=rep, roofline=roof, predicted_ms=predicted, measured_ms=measured,
                measured_over_predicted=measured / predicted)


def _plane_rate(fails, net, c, V):
    """(f) tokens/s of the threaded server over `dispatches` decode
    dispatches with every slot busy (n_slots requests of prompt
    `timed_prompt` and 1 + dispatches tokens), monitoring off and on in
    turns off, on, on, off, `repeats` times each; the median of each.
    Then monitoring's host cost a dispatch: the same requests driven in
    this thread (`drive_server`, the same waves on and off), the median
    host ms of the decode-only scheduler iterations of each arm."""
    rng = np.random.default_rng(164)
    prompts = [rng.integers(0, V, c["timed_prompt"])
               for _ in range(c["n_slots"])]
    n_tok = c["dispatches"] + 1
    rates = {"off": [], "on": []}
    host = {"off": [], "on": []}
    for threaded in (True, False):
        for _ in range(c["repeats"]):
            for tag in ("off", "on", "on", "off"):
                mon = _Monitored() if tag == "on" else None
                if mon is not None:
                    mon.__enter__()
                try:
                    # every prompt here is timed_prompt long: warm its
                    # bucket only (the grid below it serves nothing here)
                    srv = _plane_server(net, c, warm=False).warmup(
                        (c["timed_prompt"], c["timed_prompt"]), 4)
                    if threaded:
                        srv.start()
                        try:
                            t0 = time.perf_counter()
                            toks = sum(len(s.result(timeout=600)) for s in
                                       [srv.generate_async(p, n_tok)
                                        for p in prompts])
                            wall = time.perf_counter() - t0
                        finally:
                            srv.stop()
                        rates[tag].append(toks / wall)
                    else:
                        times = []
                        drive_server(srv, [(p, {}) for p in prompts], n_tok,
                                     times)
                        # the first iteration admits the wave
                        host[tag].extend(t * 1e3 for t in times[1:])
                finally:
                    if mon is not None:
                        mon.__exit__()
    off, on = (float(np.median(rates[k])) for k in ("off", "on"))
    ms_off, ms_on = (float(np.median(host[k])) for k in ("off", "on"))
    fails.check(off > 0 and on > 0 and ms_off > 0 and ms_on > 0,
                f"serving_plane (f): {rates}, {host}")
    return dict(tokens_per_s_off=off, tokens_per_s_on=on,
                on_over_off=on / off, all=rates,
                dispatch_ms_off=ms_off, dispatch_ms_on=ms_on,
                dispatch_ms_quartiles={
                    k: [float(q) for q in np.percentile(v, (25, 75))]
                    for k, v in host.items()},
                dispatches_timed=len(host["off"]),
                requests=c["n_slots"], n_tokens=n_tok)


def phase_serving_plane(device, report, fails, small=False):
    """Phase 16 on `device`: the serving request plane on the smoke LM
    at full width (phase 3's config, seeded params, head x4), 8 slots:
    (a) monitoring off and on bit-equal with the same host reads, (b)
    goodput conserved in a warmed, a speculative and a draining run,
    (c) SLO shedding counted alike in three places, (d) handoffs over
    DLFP bytes bit-equal to the colocated streams (fp32 and mixed_bf16),
    (e) the decode cost report and roofline against the measured
    dispatch, (f) tokens/s monitoring off and on. `small` (the CPU
    rehearsal) shrinks the net and the traffic. Returns the phase's
    kernel launches."""
    from deeplearning4j_tpu_torch import kernels as K
    c = SERVING_PLANE_SMALL if small else SERVING_PLANE
    cfg = c["cfg"] or LM_CUT
    t0 = time.perf_counter()
    params = random_lm_params(cfg, seed=1616, head_scale=4.0)
    net = build_lm(cfg, device, params)
    V = cfg["vocab"]
    rng = np.random.default_rng(160)
    lo, hi = c["lens"]
    prompts = [rng.integers(0, V, int(n)) for n in
               rng.integers(lo, hi + 1, c["greedy"] + c["sampled"])]
    reqs = [(p, {}) for p in prompts[:c["greedy"]]]
    reqs += [(p, dict(temperature=0.8, top_p=0.9, rng=1600 + i))
             for i, p in enumerate(prompts[c["greedy"]:])]
    out = dict(config=dict(cfg, n_slots=c["n_slots"],
                           block_len=c["block_len"]))
    K.reset_launches()
    out["sync"] = _plane_sync(fails, net, c, reqs)
    out["goodput"] = _plane_goodput(fails, net, c, reqs)
    out["shed"] = _plane_shed(fails, net, c, V)
    out["handoff"] = {"float32": _plane_handoff(fails, net, c, V,
                                                "float32")}
    mixed = build_lm(cfg, device, params, dtype_policy=MIXED)
    out["handoff"][MIXED] = _plane_handoff(fails, mixed, c, V, MIXED)
    del mixed
    out["cost"] = _plane_cost(fails, net, c, V)
    out["rate"] = _plane_rate(fails, net, c, V)
    _sync(device)
    launches = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    if device.type == "cuda":
        # the serving path's kernels: LayerNorm in every layer, the
        # per-row-key words for the sampled requests (prefill attends
        # through the KV-cache path, as in JAX, not flash)
        for k in ("layer_norm", "threefry_rows"):
            fails.check(launches[k] > 0, f"serving_plane: kernel {k} "
                                         f"never launched")
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["seconds"] = time.perf_counter() - t0
    report["serving_plane"] = out
    a, b, d = out["sync"], out["goodput"], out["handoff"]
    e, f, s = out["cost"], out["rate"], out["shed"]
    print(f"[serving_plane] (a) monitoring off/on streams equal "
          f"{a['streams_equal']}, host reads {a['reads_off']} / "
          f"{a['reads_on']} over {a['dispatches']} dispatches "
          f"({a['reads_per_dispatch']:.3f} a dispatch)", flush=True)
    for what, snap in b.items():
        print(f"[serving_plane] (b) goodput {what}: {snap}", flush=True)
    print(f"[serving_plane] (c) shed {s['shed']} of {s['burst']}: "
          f"serving_shed_total {s['serving_shed_total']}, slo bad "
          f"{s['slo_bad']}, good {s['slo_good']}; reason {s['reason']!r}",
          flush=True)
    for tag, h in d.items():
        print(f"[serving_plane] (d) handoff {tag}: {h['slots']} slots "
              f"bit-equal {h['streams_bit_equal']}, frame "
              f"{h['frame_mb_mean']:.4f} MB, export+encode "
              f"{h['export_encode_ms_median']:.3f} ms, decode+adopt "
              f"{h['decode_adopt_ms_median']:.3f} ms (medians)", flush=True)
    r = e["report"]
    print(f"[serving_plane] (e) decode dispatch: {r['weight_bytes']} weight "
          f"B ({r['matmul_weight_bytes']} matmul), "
          f"{r['decode_bytes_per_step']} B and {r['decode_flops_per_step']} "
          f"FLOP a step ({r['decode_matmul_flops_per_step']} matmul, "
          f"{r['decode_attention_flops_per_step']} attention); roofline "
          f"{e['predicted_ms']:.5f} ms ({e['roofline']['bound']}-bound) "
          f"against {e['measured_ms']:.4f} ms measured "
          f"({e['measured_over_predicted']:.1f}x)", flush=True)
    print(f"[serving_plane] (f) {f['requests']} x {f['n_tokens']} tokens: "
          f"{f['tokens_per_s_off']:.1f} tok/s monitoring off, "
          f"{f['tokens_per_s_on']:.1f} on ({f['on_over_off']:.4f}x); "
          f"all {f['all']}; a driven dispatch {f['dispatch_ms_off']:.4f} "
          f"host ms off, {f['dispatch_ms_on']:.4f} on (median of "
          f"{f['dispatches_timed']}; quartiles "
          f"{f['dispatch_ms_quartiles']})", flush=True)
    print(f"[serving_plane] {out['seconds']:.1f} s, launches "
          f"{out['launches']}", flush=True)
    return launches


# ------------------------------------------------------------ phase 17
# phase 17's configuration: the long-context LM (phase 6's), global
# batch [8, 2048] on a 4-way data axis that repeats the card; `ckpt`
# runs (e)'s kill-and-resume at a cut depth (full width) so its
# checkpoints stay small; `inf` is (f)'s ParallelInference load; `es`
# sizes (g)'s LeNet runs on the digits
PARALLEL = dict(cfg=None, B=8, steps=3, timed=1, ckpt_layers=1,
                inf_rows=16, es_train=256, es_batch=128, es_epochs=2)
PARALLEL_SMALL = dict(cfg=dict(LM_LONG, vocab=64, d_model=64, n_layers=2,
                               max_len=64),
                      B=8, steps=3, timed=1, ckpt_layers=1, inf_rows=8,
                      es_train=64, es_batch=16, es_epochs=2)
PARALLEL_KERNELS = ("layer_norm", "residual_layer_norm",
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "fused_adam")
PAR_N = 4                # replicas on the data axis


def _par_mesh(device, n=PAR_N):
    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
    return make_mesh(MeshSpec.of(data=n), devices=[device] * n)


def _par_batches(X, Y, B):
    from deeplearning4j_tpu_torch.datasets import DataSet
    return [DataSet(X[i:i + B], Y[i:i + B]) for i in range(0, len(X), B)]


def _par_fit(trainer, batches):
    """`trainer.fit` over `batches` (one step each) with the loss of
    every step read back (a listener makes the fit read it)."""
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    scores = CollectScoresListener()
    net = trainer.model
    net.set_listeners(scores)
    try:
        trainer.fit(list(batches))
    finally:
        net.set_listeners()
    return [s for _, s in scores.scores]


def _par_leaf_max(a, b):
    """The largest |a - b| over every param of two nets."""
    ta, tb = a.param_table(), b.param_table()
    return max(float((ta[k].float() - tb[k].float()).abs().max())
               for k in ta)


def _par_bits_equal(a, b):
    """Params and updater state bit for bit (names of the leaves that
    are not)."""
    import torch
    bad = [k for k, v in a.param_table().items()
           if not torch.equal(v, b.param_table()[k])]
    for lk, lst in a.updater_state.items():
        for pk, st in lst.items():
            for sk, v in st.items():
                if not torch.equal(v, b.updater_state[lk][pk][sk]):
                    bad.append(f"{lk}/{pk}/{sk}")
    return bad


def _par_state_gb(nets, trainer=None):
    """GB of the training state a mode keeps on the device: each
    distinct net's params, updater state and running state, and a
    trainer's replica stacks (residuals, the other replicas' updater
    states, the rs shards)."""
    seen, total = set(), 0

    def add(tree):
        nonlocal total
        if isinstance(tree, dict):
            for v in tree.values():
                add(v)
        elif id(tree) not in seen:
            seen.add(id(tree))
            total += tree.numel() * tree.element_size()
    for net in nets:
        add({k: layer.jax_param_map() for k, layer in net.keyed()})
        add(net.updater_state)
        add(net.net_state)
    if trainer is not None:
        for tree in ((trainer._res_r or [])
                     + (getattr(trainer, "_upd_r", None) or [])[1:]
                     + (getattr(trainer, "_rs_state", None) or [])):
            add(tree)
    return total / 1e9


def _par_timed(device, trainer, batches, profile):
    """ms/step of `batches` through `trainer.fit` (no loss read between
    steps), the host ms of the replicas' passes inside them (the rest of
    the step is the exchange and the update), the training state the
    mode keeps (`_par_state_gb`) and the steps' peak memory above what
    was allocated before them, and with
    `profile` one more step under torch.profiler: device ms and kernel
    launches a step."""
    import torch
    from deeplearning4j_tpu_torch.parallel import trainer as ptrainer
    pass_s = [0.0]
    real = ptrainer.ParallelTrainer._replica_pass

    def timed_pass(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return real(self, *a, **k)
        finally:
            pass_s[0] += time.perf_counter() - t0

    _sync(device)
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    ptrainer.ParallelTrainer._replica_pass = timed_pass
    try:
        t0 = time.perf_counter()
        trainer.fit(list(batches[:-1]))
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        ptrainer.ParallelTrainer._replica_pass = real
    k = len(batches) - 1
    out = dict(ms_per_step=wall / k * 1e3,
               exchange_update_host_ms_per_step=(wall - pass_s[0]) / k * 1e3
               if pass_s[0] else None,
               state_gb=_par_state_gb(set(trainer._nets()), trainer),
               step_gb=((torch.cuda.max_memory_allocated() - base) / 1e9
                        if device.type == "cuda" else None))
    if profile and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        # kernel events only: CPU-op recording would slow the step
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.fit(list(batches[-1:]))
            torch.cuda.synchronize()
            w = (time.perf_counter() - t0) * 1e3
        s = _profile_summary(prof, w)
        out.update(device_ms_per_step=s["device_ms"],
                   launches_per_step=s["launches"],
                   busy_share=s["busy_share"])
    else:
        trainer.fit(list(batches[-1:]))
    return out


def _par_single_timed(device, net, batches, profile):
    """The single-card `fit` beside the modes: the same measurements."""
    import torch
    _sync(device)
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for ds in batches[:-1]:
        net.fit(ds)
    _sync(device)
    k = len(batches) - 1
    out = dict(ms_per_step=(time.perf_counter() - t0) / k * 1e3,
               state_gb=_par_state_gb([net]),
               step_gb=((torch.cuda.max_memory_allocated() - base) / 1e9
                        if device.type == "cuda" else None))
    if profile and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        # kernel events only: CPU-op recording would slow the step
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(batches[-1])
            torch.cuda.synchronize()
            w = (time.perf_counter() - t0) * 1e3
        s = _profile_summary(prof, w)
        out.update(device_ms_per_step=s["device_ms"],
                   launches_per_step=s["launches"],
                   busy_share=s["busy_share"])
    else:
        net.fit(batches[-1])
    return out


def _par_ef_probe(fails, out):
    """Wrap `gradient_sharing.threshold_exchange` for a step: per bucket
    and replica, (update + old residual - new residual) / τ must be an
    integer in {-1, 0, 1} (the sent sign) and the mean of the sent
    values the shared update: enc·τ + res_new = update + res_old.
    Returns the restore function."""
    import torch
    from deeplearning4j_tpu_torch.parallel import gradient_sharing as gs
    real = gs.threshold_exchange
    worst = {"int": 0.0, "mean": 0.0, "buckets": 0, "sent": 0}

    def probe(deltas, residuals, tau, cfg, *, device, **kw):
        old = [{lk: {pk: t.clone() for pk, t in lr.items()}
                for lk, lr in r.items()} for r in residuals]
        dhat, res, new_tau, sp = real(deltas, residuals, tau, cfg,
                                      device=device, **kw)
        t = float(tau)
        for lk, ld in dhat.items():
            for pk, d in ld.items():
                sent = [(deltas[r][lk][pk] + old[r][lk][pk]
                         - res[r][lk][pk]).to(device)
                        for r in range(len(deltas))]
                enc = [s / t for s in sent]
                worst["int"] = max(worst["int"], max(
                    float((e - e.round()).abs().max()) for e in enc))
                ok = all(float(e.round().abs().max()) <= 1 for e in enc)
                if not ok:
                    worst["int"] = float("inf")
                worst["sent"] += int(sum(int((e.round() != 0).sum())
                                         for e in enc))
                mean = torch.stack(sent).mean(0)
                worst["mean"] = max(worst["mean"], float(
                    (mean - d).abs().max()) / t)
        worst["buckets"] += 1
        return dhat, res, new_tau, sp

    gs.threshold_exchange = probe

    def restore():
        gs.threshold_exchange = real
        out["ef_identity"] = dict(worst)
        # fp32 rounding of u + r - r': a few ulps of |u| over τ
        fails.check(worst["buckets"] > 0 and worst["sent"] > 0
                    and worst["int"] <= 1e-2 and worst["mean"] <= 1e-2,
                    f"parallel (b): error-feedback identity off: {worst}")
    return restore


def _par_resume(device, fails, cfg, c, params, X, Y, kw, tag):
    """(e) one kind: an uninterrupted run of 4 steps against a run
    checkpointed at step 2 and killed at 3, resumed by a new trainer and
    trained to 4: params and updater state bit-equal. Returns the
    checkpoint directory's meta and seconds."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch import fault
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    B = c["B"]
    batches = _par_batches(X[:4 * B], Y[:4 * B], B)
    mesh = _par_mesh(device)
    ref = build_lm(cfg, device, params, lr=LONG_LR)
    ParallelTrainer(ref, mesh, **kw).fit(ListDataSetIterator(batches))
    d = tempfile.mkdtemp(prefix=f"par_{tag}_", dir=OUT_DIR)
    try:
        net = build_lm(cfg, device, params, lr=LONG_LR)
        it = ListDataSetIterator(batches)
        ck = fault.AsyncCheckpointer(d)
        net.set_listeners(fault.CheckpointListener(ck, frequency=2,
                                                   iterator=None),
                          fault.PreemptionListener(
                              3, wait_for_checkpointer=ck))
        t0 = time.perf_counter()
        try:
            ParallelTrainer(net, mesh, **kw).fit(it)
        except fault.SimulatedPreemption:
            pass
        ck.wait()
        write_s = time.perf_counter() - t0
        meta = fault.checkpoint_meta(d)
        back = build_lm(cfg, device, params, lr=LONG_LR)
        t = ParallelTrainer(back, mesh, **kw)
        t0 = time.perf_counter()
        t.resume(d)
        resume_s = time.perf_counter() - t0
        fails.check(back.iteration_count == 2,
                    f"parallel (e) {tag}: resumed at "
                    f"{back.iteration_count}, not 2")
        t.fit(ListDataSetIterator(batches[2:]))
        bad = _par_bits_equal(ref, back)
        fails.check(not bad, f"parallel (e) {tag}: resumed run not "
                             f"bit-equal: {bad[:6]}")
        out = dict(kind=meta.get("trainer", {}).get("kind"),
                   bit_equal=not bad, write_s=write_s, resume_s=resume_s)
        if tag == "threshold":
            out["elastic"] = _par_elastic(device, fails, cfg, params, d)
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _par_elastic(device, fails, cfg, params, d):
    """(e) elastic: the 4-replica threshold checkpoint resumed on a
    2-replica mesh keeps Σ residual (the float64 sum rounded to
    float32)."""
    from deeplearning4j_tpu_torch import fault
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    state, _ = fault.load_latest_valid(d)
    old = state["arrays"]["trainer"]["residual_r"]
    net = build_lm(cfg, device, params, lr=LONG_LR)
    t = ParallelTrainer(net, _par_mesh(device, 2),
                        gradient_sharing="threshold")
    t.resume(d)
    t._threshold_state(True)
    new = t.threshold_residual()
    bad = [f"{lk}/{pk}" for lk in old for pk in old[lk]
           if not np.array_equal(
               new[lk][pk].sum(axis=0),
               old[lk][pk].sum(axis=0, dtype=np.float64).astype(np.float32))
           or new[lk][pk].shape[0] != 2]
    fails.check(not bad, f"parallel (e) elastic 4 -> 2: residual sum not "
                         f"kept: {bad[:6]}")
    return dict(sum_kept=not bad, leaves=sum(len(v) for v in old.values()))


def _par_inference(device, fails, c):
    """(f) ParallelInference on the smoke LM at full width: one [1, 512]
    request from each of 16 threads, coalesced, against `output()` of
    the [16, 512] batch."""
    import threading
    import torch
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    cfg = c["cfg"] or LM
    small_cfg = dict(LM, d_model=64, n_heads=4, n_layers=2, max_len=64) \
        if c["cfg"] else LM
    n = c["inf_rows"]
    net = build_lm(small_cfg, device,
                   random_lm_params(small_cfg, seed=1707, head_scale=4.0))
    rng = np.random.default_rng(171)
    X = rng.integers(0, small_cfg["vocab"],
                     (n, small_cfg["max_len"])).astype(np.float32)
    want = net.output(X).float().cpu().numpy()
    pi = ParallelInference(net, _par_mesh(device), batch_limit=64,
                           queue_limit_ms=500.0).start()
    futs, barrier = [None] * n, threading.Barrier(n)
    try:
        def call(i):
            barrier.wait()
            futs[i] = pi.output_async(X[i:i + 1])
        th = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        t0 = time.perf_counter()
        for t in th:
            t.start()
        for t in th:
            t.join()
        got = np.concatenate([f.result(timeout=120) for f in futs])
        wall = time.perf_counter() - t0
    finally:
        pi.shutdown()
    err = float(np.abs(got - want).max())
    fails.check(err <= OUTPUT_ATOL, f"parallel (f): ParallelInference "
                                    f"output {err:.3g} from output()")
    hist = list(pi.batch_size_history)
    fails.check(sum(hist) == n and max(hist) > 1,
                f"parallel (f): {n} callers not coalesced: {hist}")
    del torch, cfg
    return dict(rows=n, T=small_cfg["max_len"], max_abs_err=err,
                batches=hist, seconds=wall)


def _par_lenet(device, fails, c, small):
    """(g) the packaged LeNet on the digits, on the card and on a CPU
    twin: an EarlyStoppingParallelTrainer (MaxEpochs, held-out loss)
    and both training masters with stats; the phase counts must equal
    the CPU's."""
    from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                                   DataSet)
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingParallelTrainer)
    from deeplearning4j_tpu_torch.earlystopping import conditions as ec
    from deeplearning4j_tpu_torch.earlystopping.scorecalc import (
        DataSetLossCalculator)
    from deeplearning4j_tpu_torch.parallel import (
        ParameterAveragingTrainingMaster, SharedTrainingMaster)
    from deeplearning4j_tpu_torch.zoo import LeNet, PretrainedType
    X, Y = digits_28x28()
    Xh, Yh = X[:N_HELD_OUT], Y[:N_HELD_OUT]
    Xt, Yt = X[N_HELD_OUT:N_HELD_OUT + c["es_train"]], \
        Y[N_HELD_OUT:N_HELD_OUT + c["es_train"]]
    bs = c["es_batch"]
    out = {}
    for where in ("card", "cpu"):
        dev = device if where == "card" else _cpu()
        mesh = _par_mesh(dev)
        net = LeNet().init_pretrained(PretrainedType.MNIST, device=dev)
        conf = EarlyStoppingConfiguration(
            score_calculator=DataSetLossCalculator(
                ArrayDataSetIterator(Xh, Yh, batch_size=bs)),
            epoch_termination_conditions=[
                ec.MaxEpochsTerminationCondition(c["es_epochs"])])
        es = EarlyStoppingParallelTrainer(
            conf, net, ArrayDataSetIterator(Xt, Yt, batch_size=bs,
                                            shuffle=False),
            mesh, batch_size=bs).fit()
        pa = ParameterAveragingTrainingMaster(
            batch_size_per_worker=bs // PAR_N, averaging_frequency=2,
            mesh=mesh, collect_training_stats=True)
        pa.execute_training(net, (Xt, Yt), epochs=1)
        sh = SharedTrainingMaster(batch_size_per_worker=bs // PAR_N,
                                  mesh=mesh, collect_training_stats=True)
        sh.execute_training(net, (Xt, Yt), epochs=1)
        acc = net.evaluate(DataSet(Xh, Yh)).accuracy()
        out[where] = dict(
            es_best_epoch=es.best_model_epoch,
            es_scores={str(k): float(v) for k, v in es.score_vs_epoch.items()},
            averaging_phases=pa.get_training_stats().phase_counts(),
            averaging_rounds=pa.get_training_stats().round_count,
            averaging_ms=pa.get_training_stats().phase_totals_ms(),
            shared_phases=sh.get_training_stats().phase_counts(),
            shared_ms=sh.get_training_stats().phase_totals_ms(),
            held_out_accuracy=acc)
    a, b = out["card"], out["cpu"]
    for k in ("averaging_phases", "averaging_rounds", "shared_phases"):
        fails.check(a[k] == b[k], f"parallel (g): {k} card {a[k]} != CPU "
                                  f"{b[k]}")
    fails.check(all(np.isfinite(v) for v in a["es_scores"].values()),
                f"parallel (g): early-stopping scores {a['es_scores']}")
    if not small:
        fails.check(a["held_out_accuracy"] >= LENET_MIN_ACCURACY,
                    f"parallel (g): held-out accuracy "
                    f"{a['held_out_accuracy']:.4f}")
    return out


def _cpu():
    import torch
    return torch.device("cpu")


def phase_parallel(device, report, fails, small=False):
    """Phase 17 on `device`: data-parallel training of the long-context
    LM on a 4-way data axis that repeats the card (see the module
    docstring, 17 (a)-(g)). `small` (the CPU rehearsal) shrinks the LM
    and the digits. Returns the phase's kernel launches."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer
    c = PARALLEL_SMALL if small else PARALLEL
    cfg = c["cfg"] or LM_LONG_QUARTER
    B, n, k = c["B"], c["steps"], c["timed"]
    t_start = time.perf_counter()
    params = random_lm_params(cfg, seed=1717, head_scale=1.0)
    T = cfg["max_len"]
    X, Y = lm_corpus(cfg, B * (n + k + 1), seed=17, T=T)
    check = _par_batches(X[:n * B], Y[:n * B], B)
    timed = _par_batches(X[n * B:], Y[n * B:], B)
    mesh = _par_mesh(device)
    prof = device.type == "cuda"
    out = dict(config=dict(cfg, global_batch=[B, T], replicas=PAR_N,
                           rows_per_replica=B // PAR_N, lr=LONG_LR))
    K.reset_launches()

    bases = {}

    def lm(policy=None):
        """A fresh net from the seeded params (a copy of one built net a
        policy: `copy` is cheaper than `init` plus the params' load)."""
        if policy not in bases:
            bases[policy] = build_lm(cfg, device, params, lr=LONG_LR,
                                     dtype_policy=policy)
        return bases[policy].copy()

    # ---- (a) sync dense against the single card
    single = lm()
    scores = CollectScoresListener()
    single.set_listeners(scores)
    for ds in check:
        single.fit(ds)
    single.set_listeners()
    l_single = [s for _, s in scores.scores]
    runs, losses = {}, {}
    bound = adam_step_max(LONG_LR, n)
    for name, kw in (("dense_bucketed", dict(gradient_sharing="dense")),
                     ("dense_single_barrier",
                      dict(gradient_sharing="dense", bucketed=False))):
        net = lm()
        tr = ParallelTrainer(net, mesh, **kw)
        losses[name] = _par_fit(tr, check)
        rel0 = abs(losses[name][0] - l_single[0]) / abs(l_single[0])
        worst = _par_leaf_max(net, single)
        runs[name] = (net, tr)
        fails.check(rel0 <= TRAIN_LOSS_RTOL / 10,
                    f"parallel (a) {name}: step 0 loss {losses[name][0]} vs "
                    f"single card {l_single[0]} (rel {rel0:.3g})")
        fails.check(worst <= 2 * n * bound,
                    f"parallel (a) {name}: params {worst:.3g} from the "
                    f"single card's after {n} steps (Adam bound "
                    f"{2 * n * bound:.3g})")
        out[name] = dict(losses=losses[name], step0_rel=rel0,
                         params_max_abs=worst)
    out["single_card"] = dict(losses=l_single)
    parts = {"a_checks": time.perf_counter() - t_start}
    # the single card and the same step through the trainer, in turns
    times = {"single_card": _par_single_timed(device, single, timed, prof),
             "dense_single_barrier": _par_timed(
                 device, runs["dense_single_barrier"][1], timed, prof)}
    del single
    # the mixed arm of the dense exchange
    mixed_single = lm(MIXED)
    l_ms = _fit_steps(mixed_single, X[:B], Y[:B], B)
    del mixed_single
    mnet = lm(MIXED)
    mtr = ParallelTrainer(mnet, mesh, gradient_sharing="dense")
    l_mixed = _par_fit(mtr, check)
    rel_m = abs(l_mixed[0] - l_ms[0]) / abs(l_ms[0])
    fails.check(rel_m <= MIXED_STEP0_RTOL,
                f"parallel (a) mixed_bf16: step 0 {l_mixed[0]} vs single "
                f"{l_ms[0]} (rel {rel_m:.3g})")
    out["dense_mixed"] = dict(losses=l_mixed, step0_rel=rel_m,
                              single_step0=l_ms[0])
    times["dense_mixed"] = _par_timed(device, mtr, timed, prof)
    del mnet, mtr

    # ---- (b) threshold, bucketed; tau starts at the learning rate (the
    # scale of the updates it encodes: at the configuration's default
    # 1e-3, ten times Adam's steps at LONG_LR, nothing would be sent in
    # these steps and the identity would hold trivially)
    from deeplearning4j_tpu_torch.parallel import ThresholdConfig
    tnet = lm()
    ttr = ParallelTrainer(tnet, mesh, gradient_sharing="threshold",
                          threshold_config=ThresholdConfig(
                              initial_threshold=LONG_LR))
    restore = _par_ef_probe(fails, out)
    try:
        l_thr = _par_fit(ttr, check)
    finally:
        restore()
    init = l_single[0]
    band = max(abs(a - b) for a, b in zip(l_thr,
                                          losses["dense_bucketed"]))
    fails.check(band <= 0.35 * init,
                f"parallel (b): threshold {l_thr} outside JAX's band of "
                f"dense {losses['dense_bucketed']} (0.35 x {init:.4f})")
    tau = ttr._thr_tau
    fails.check(isinstance(tau, dict)
                and set(tau) == set(tnet.updater_state),
                "parallel (b): tau is not a tree keyed by layer")
    out["threshold"] = dict(losses=l_thr, band=band, band_limit=0.35 * init,
                            tau={k: float(v) for k, v in tau.items()})

    # ---- (d) dense_rs against (a)'s bucketed dense, bit for bit
    rnet = lm()
    rtr = ParallelTrainer(rnet, mesh, gradient_sharing="dense_rs")
    l_rs = _par_fit(rtr, check)
    bad = _par_bits_equal(runs["dense_bucketed"][0], rnet)
    fails.check(not bad, f"parallel (d): dense_rs not bit-equal to dense: "
                         f"{bad[:6]}")
    sharded = sum(v for lp in rtr._rs_plan().values() for v in lp.values())
    trs = lm()
    trs_tr = ParallelTrainer(trs, mesh, gradient_sharing="threshold_rs")
    l_trs = _par_fit(trs_tr, check + timed[:1])
    fails.check(l_trs[-1] < l_trs[0],
                f"parallel (d): threshold_rs did not learn: {l_trs}")
    out["dense_rs"] = dict(losses=l_rs, bit_equal=not bad,
                           sharded_leaves=sharded)
    out["threshold_rs"] = dict(losses=l_trs)
    times["dense_rs"] = _par_timed(device, rtr, timed, prof)
    times["threshold_rs"] = _par_timed(device, trs_tr, timed, prof)
    del rnet, rtr, trs, trs_tr

    # ---- timings of (a) and (b)
    times["dense_bucketed"] = _par_timed(
        device, runs["dense_bucketed"][1], timed, prof)
    runs.clear()
    times["threshold"] = _par_timed(device, ttr, timed, prof)
    del tnet, ttr

    # ---- (c) averaging every 2 steps: replicas equal after a round only
    anet = lm()
    atr = ParallelTrainer(anet, mesh, mode="averaging", averaging_frequency=2)
    seen = []

    class Probe(CollectScoresListener):
        def iteration_done(self, model, iteration, epoch, score, **kw):
            super().iteration_done(model, iteration, epoch, score, **kw)
            nets = atr._nets()
            a = nets[0].param_table()
            same = all(torch.equal(a[key], r.param_table()[key])
                       for r in nets[1:] for key in a)
            seen.append((iteration, same))

    probe = Probe()
    anet.set_listeners(probe)
    atr.fit(check + timed[:1])
    anet.set_listeners()
    want = [(i, (i + 1) % 2 == 0) for i, _ in seen]
    fails.check(seen == want and len(seen) == n + 1,
                f"parallel (c): replicas equal after rounds only: {seen}")
    out["averaging"] = dict(losses=[s for _, s in probe.scores],
                            equal_after_step=seen)
    times["averaging"] = _par_timed(device, atr, timed, prof)
    del anet, atr
    _sync(device)
    launches = {key: K.LAUNCHES.get(key, 0) for key in KERNEL_META}
    if device.type == "cuda":
        for key in PARALLEL_KERNELS:
            fails.check(launches[key] > 0,
                        f"parallel: kernel {key} never launched")

    parts["a_to_d"] = time.perf_counter() - t_start - sum(parts.values())
    # ---- (e) checkpoint and resume at the cut depth
    ccfg = dict(cfg, n_layers=c["ckpt_layers"])
    cparams = random_lm_params(ccfg, seed=1718, head_scale=1.0)
    out["resume"] = {
        tag: _par_resume(device, fails, ccfg, c, cparams, X, Y, kw, tag)
        for tag, kw in (("threshold", dict(gradient_sharing="threshold")),
                        ("averaging", dict(mode="averaging",
                                           averaging_frequency=3)))}
    parts["e"] = time.perf_counter() - t_start - sum(parts.values())
    # ---- (f) and (g)
    out["inference"] = _par_inference(device, fails, c)
    parts["f"] = time.perf_counter() - t_start - sum(parts.values())
    out["lenet"] = _par_lenet(device, fails, c, small)
    parts["g"] = time.perf_counter() - t_start - sum(parts.values())
    out["part_seconds"] = parts
    out["times"] = times
    out["launches"] = {key: v for key, v in launches.items() if v}
    out["seconds"] = time.perf_counter() - t_start
    report["parallel"] = out
    _print_parallel(out)
    return launches


def _print_parallel(out):
    def f(v, p=2):
        return "n/a" if v is None else f"{v:.{p}f}"
    for name in ("dense_bucketed", "dense_single_barrier"):
        a = out[name]
        print(f"[parallel] (a) {name}: losses {a['losses']}, step 0 rel "
              f"{a['step0_rel']:.3g}, params {a['params_max_abs']:.3g} from "
              f"the single card", flush=True)
    m = out["dense_mixed"]
    print(f"[parallel] (a) dense mixed_bf16: losses {m['losses']}, step 0 "
          f"rel {m['step0_rel']:.3g}", flush=True)
    b = out["threshold"]
    print(f"[parallel] (b) threshold: losses {b['losses']}, band "
          f"{b['band']:.4g} of {b['band_limit']:.4g}, EF identity "
          f"{out.get('ef_identity')}, tau {len(b['tau'])} layers", flush=True)
    print(f"[parallel] (c) averaging: equal after step "
          f"{out['averaging']['equal_after_step']}", flush=True)
    print(f"[parallel] (d) dense_rs bit-equal {out['dense_rs']['bit_equal']}"
          f" ({out['dense_rs']['sharded_leaves']} sharded leaves); "
          f"threshold_rs losses {out['threshold_rs']['losses']}", flush=True)
    for tag, r in out["resume"].items():
        print(f"[parallel] (e) {tag}: kind {r['kind']}, bit-equal "
              f"{r['bit_equal']}, write {r['write_s']:.2f} s, resume "
              f"{r['resume_s']:.2f} s"
              + (f", elastic 4 -> 2 {r['elastic']}" if "elastic" in r
                 else ""), flush=True)
    i = out["inference"]
    print(f"[parallel] (f) ParallelInference {i['rows']} callers x "
          f"[1, {i['T']}]: batches {i['batches']}, max abs err "
          f"{i['max_abs_err']:.3g}, {i['seconds']:.3f} s", flush=True)
    for where, g in out["lenet"].items():
        print(f"[parallel] (g) LeNet {where}: ES best epoch "
              f"{g['es_best_epoch']} {g['es_scores']}, averaging phases "
              f"{g['averaging_phases']} ({g['averaging_rounds']} rounds), "
              f"shared {g['shared_phases']}, held-out accuracy "
              f"{g['held_out_accuracy']:.4f}", flush=True)
    for name, t in out["times"].items():
        print(f"[parallel] {name}: {f(t['ms_per_step'])} ms/step, device "
              f"{f(t.get('device_ms_per_step'))} ms, launches "
              f"{t.get('launches_per_step', 'n/a')} a step, exchange+update "
              f"host {f(t.get('exchange_update_host_ms_per_step'))} ms, "
              f"state {f(t['state_gb'], 3)} GB, step peak above it "
              f"{f(t.get('step_gb'), 3)} GB", flush=True)
    print(f"[parallel] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 1) for k, v in out['part_seconds'].items()} }), "
          f"launches {out['launches']}", flush=True)


# --------------------------------------------------------------- phase 18
MP = dict(cfg=None, B=8, steps=3, procs=2, moe_B=4, moe_steps=2,
          graph_B=2, timeout=420)
MP_SMALL = dict(cfg=dict(LM_LONG, vocab=64, d_model=64, n_layers=4,
                         max_len=64),
                B=8, steps=3, procs=2, moe_B=2, moe_steps=2, graph_B=2,
                timeout=240)
MP_PARAMS_SEED, MP_DATA_SEED = 1717, 17     # phase 17's params and data
# the kernels each part of phase 18 launches on the card, counted from
# just before the part's trainer runs to just after (the references run
# outside the parts): (a), (b) and (c)'s two-process run in the workers,
# the rest in this process. The SGD steps of (d) launch no fused Adam,
# nor does the threshold exchange of (e) (each replica applies Adam per
# leaf, as in phase 17); the graph ring's attention is the carry kernel
# and its backward
MP_KERNELS = {
    "a": PARALLEL_KERNELS, "b": PARALLEL_KERNELS,
    "c_two_process": PARALLEL_KERNELS, "c": PARALLEL_KERNELS,
    "c_moe": MOE_KERNELS + ("fused_adam",),
    "d_sgd": tuple(k for k in PARALLEL_KERNELS if k != "fused_adam"),
    "d": PARALLEL_KERNELS,
    "e_ring": ("layer_norm", "residual_layer_norm", "flash_attention_carry",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    "e_diag": tuple(k for k in PARALLEL_KERNELS if k != "fused_adam")}
# JAX's pipeline parity tests take one Sgd(0.05) step and hold the params
# at rtol 2e-4, atol 1e-6 (tests/test_parallel_advanced.py:716-733)
PP_SGD_LR = 0.05
# a trainer held to the single card after a few Adam steps: each param's
# difference from the single card's relative to how far the single card
# moved it from the initial params (Frobenius; attn_bk, whose gradient
# is rounding noise, by Adam's step bound as above). A trainer that
# skips one of three steps is off by about 1/3, one that never updates
# by 1
PARAM_MOTION_RTOL = 1e-2


def _host_table(net):
    """A host copy of every param (never a view of a CPU net's own)."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in net.param_table().items()}


def param_motion_diff(got, want, init):
    """((worst |got - want| / |want - init|, its name), largest
    |got - want| of an attn_bk) over {name: array} param tables."""
    worst, worst_bk = (0.0, ""), 0.0
    for k, w in want.items():
        diff = got[k] - w
        if k.endswith("_attn_bk"):
            worst_bk = max(worst_bk, float(np.abs(diff).max()))
            continue
        moved = float(np.linalg.norm(w - init[k]))
        rel = (float(np.linalg.norm(diff)) / moved if moved
               else (0.0 if not diff.any() else float("inf")))
        worst = max(worst, (rel, k))
    return worst, worst_bk


class _PartLaunches:
    """Phase 18's launches by part: `start(part)` zeroes the counts just
    before a part's trainer runs and `stop()` adds them to the part's
    just after; what runs between parts counts nowhere."""

    def __init__(self):
        self.by_part = {}
        self._part = None

    def start(self, part):
        from deeplearning4j_tpu_torch import kernels as K
        K.reset_launches()
        self._part = part

    def stop(self):
        from deeplearning4j_tpu_torch import kernels as K
        self.add(self._part, K.LAUNCHES)
        self._part = None

    def add(self, part, counts):
        mine = self.by_part.setdefault(part, {})
        for k, v in counts.items():
            if v:
                mine[k] = mine.get(k, 0) + v


def _sharded_fit(tr, dev, fit):
    """`fit()` of the ShardedParallelTrainer `tr`, with its memory: the
    bytes of params and updater slots this process holds whole before
    the fit and at most between its steps (`held_bytes`, from the live
    tensors), and on the card `torch.cuda.memory_allocated` before the
    fit, at most between its steps, and at the fit's peak."""
    import torch
    whole = tr.held_bytes()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    r = fit()
    mem = dict(held_whole=whole, held_between_steps=max(
        s["held"] for s in tr.between_steps))
    if cuda:
        mem.update(allocated_before=before,
                   allocated_between_steps=max(
                       s["allocated"] for s in tr.between_steps),
                   allocated_peak=torch.cuda.max_memory_allocated(dev))
    return r, mem


def _mp_setup(c):
    cfg = c["cfg"] or LM_LONG_CUT
    params = random_lm_params(cfg, seed=MP_PARAMS_SEED, head_scale=1.0)
    X, Y = lm_corpus(cfg, c["B"] * (c["steps"] + 1), seed=MP_DATA_SEED,
                     T=cfg["max_len"])
    return cfg, params, X, Y, _par_batches(X, Y, c["B"])


def _mp_modes():
    from deeplearning4j_tpu_torch.parallel import ThresholdConfig
    return (("dense_bucketed", dict(gradient_sharing="dense")),
            ("dense_single_barrier", dict(gradient_sharing="dense",
                                          bucketed=False)),
            ("threshold", dict(gradient_sharing="threshold",
                               threshold_config=ThresholdConfig(
                                   initial_threshold=LONG_LR))))


def _mp_worker(argv):
    """One process of phase 18's multi-process runs (`--mp-worker rank n
    coordinator args-json`): (a) the three data-parallel modes on the
    global 4-replica mesh, (b) a barrier checkpoint at step 2, stopped at
    3, resumed to 4, (c) the sharded trainer with the model axis
    outermost, each part's launches apart. Prints one `MP_RESULT {json}`
    line."""
    import shutil

    import torch
    torch.set_num_threads(1)
    rank, n, coord = int(argv[0]), int(argv[1]), argv[2]
    args = json.loads(argv[3])
    c = MP_SMALL if args["small"] else MP
    from deeplearning4j_tpu_torch import fault
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, ParallelTrainer, ShardedParallelTrainer, make_mesh,
        multihost)
    if args["device"] == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    multihost.initialize_multihost(coord, n, rank, devices=[dev, dev],
                                   backend=args["backend"],
                                   initialization_timeout=c["timeout"])
    out = {"rank": rank, "backend": multihost.backend()}
    try:
        cfg, params, _, _, batches = _mp_setup(c)
        steps = c["steps"]
        mesh = make_mesh(MeshSpec.of(data=2 * n))
        rec = _PartLaunches()
        rec.start("a")
        runs = {}
        for name, kw in _mp_modes():
            net = build_lm(cfg, dev, params, lr=LONG_LR)
            tr = ParallelTrainer(net, mesh, **kw)
            use = batches if name == "dense_bucketed" else batches[:steps]
            losses, step_ms, st = _mp_fit_timed(tr, use, dev)
            runs[name] = net
            out[name] = dict(losses=losses, **st,
                             first_step_ms=step_ms[0],
                             ms_per_step=float(np.mean(step_ms[1:])))
            if name != "dense_bucketed":
                del net, tr
        rec.stop()
        # (b) the barrier checkpoint of the bucketed dense run
        d = args["ckpt_dir"]
        rec.start("b")
        net = build_lm(cfg, dev, params, lr=LONG_LR)
        ck = fault.AsyncCheckpointer(d)
        net.set_listeners(fault.CheckpointListener(ck, frequency=2),
                          fault.PreemptionListener(
                              3, wait_for_checkpointer=ck))
        t0 = time.perf_counter()
        try:
            ParallelTrainer(net, mesh, gradient_sharing="dense").fit(
                ListDataSetIterator(batches))
        except fault.SimulatedPreemption:
            pass
        ck.wait()
        write_s = time.perf_counter() - t0
        torch.distributed.barrier()
        del net
        back = build_lm(cfg, dev, params, lr=LONG_LR)
        t = ParallelTrainer(back, mesh, gradient_sharing="dense")
        t0 = time.perf_counter()
        t.resume(d)
        resume_s = time.perf_counter() - t0
        at = back.iteration_count
        t.fit(ListDataSetIterator(batches[2:]))
        rec.stop()
        bad = _par_bits_equal(runs["dense_bucketed"], back)
        out["b"] = dict(resumed_at=at, bit_equal=not bad, bad=bad[:6],
                        write_s=write_s, resume_s=resume_s)
        del back, t, runs
        torch.distributed.barrier()
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
        # (c) the sharded trainer, the model axis across the processes
        net = build_lm(cfg, dev, params, lr=LONG_LR)
        init = _host_table(net)
        tr = ShardedParallelTrainer(net, make_mesh(MeshSpec.of(
            model=2, data=n)))
        rec.start("c_two_process")
        (l_tp, step_ms, st), mem = _sharded_fit(
            tr, dev, lambda: _mp_fit_timed(tr, batches[:steps], dev))
        rec.stop()
        worst, worst_bk = param_motion_diff(
            _host_table(net), dict(np.load(args["ref_path"])), init)
        out["c"] = dict(losses=l_tp, param_motion=worst,
                        attn_bk_max_abs=worst_bk, **st,
                        first_step_ms=step_ms[0],
                        ms_per_step=float(np.mean(step_ms[1:])),
                        memory=mem)
        out["launches_by_part"] = rec.by_part
    finally:
        multihost.shutdown_multihost()
    print("MP_RESULT " + json.dumps(out), flush=True)


def _mp_fit_timed(trainer, batches, dev):
    """`trainer.fit` over `batches` one step each: the losses, each
    step's ms (host clock to the loss's read-back, which waits for the
    card), and the cross-process exchange's host ms, payload bytes and
    calls a step (`collectives.CrossProcess.stats`)."""
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    stamps = []

    class Stamp(CollectScoresListener):
        def iteration_done(self, model, iteration, epoch, score, **kw):
            super().iteration_done(model, iteration, epoch, score, **kw)
            stamps.append(time.perf_counter())

    probe = Stamp()
    net = trainer.model
    net.set_listeners(probe)
    xp = getattr(trainer, "_xp", None)
    before = dict(xp.stats) if xp is not None else {}
    _sync(dev)
    t0 = time.perf_counter()
    try:
        trainer.fit(list(batches))
    finally:
        net.set_listeners()
    n = len(batches)
    after = dict(xp.stats) if xp is not None else {}
    step_ms = list(np.diff([t0] + stamps) * 1e3)
    st = {f"{k}_per_step": (after.get(k, 0) - before.get(k, 0)) / n
          for k in ("bytes", "calls")}
    st["exchange_host_ms_per_step"] = (after.get("seconds", 0.0)
                                       - before.get("seconds", 0.0)) / n * 1e3
    return [s for _, s in probe.scores], step_ms, st


def _mp_spawn(c, device, backend, ckpt_dir, ref_path, small):
    """Phase 18's 2-process run: the workers' results, rank order;
    raises when one fails (its siblings killed) or the time runs out."""
    import socket

    from deeplearning4j_tpu_torch.parallel.multihost_smoke import _wait_all
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    args = json.dumps(dict(small=small, device=device.type, backend=backend,
                           ckpt_dir=ckpt_dir, ref_path=ref_path))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=HERE + (os.pathsep + os.environ["PYTHONPATH"]
                                  if os.environ.get("PYTHONPATH") else ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mp-worker",
         str(r), str(c["procs"]), coord, args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=HERE) for r in range(c["procs"])]
    results, timed_out = _wait_all(procs, c["timeout"])
    outs = []
    for rc, out, err in results:
        if rc != 0:
            raise RuntimeError(f"multiprocess worker rc={rc}"
                               f"{' (timed out)' if timed_out else ''}: "
                               f"{err[-2000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("MP_RESULT ")]
        outs.append(json.loads(line[-1][len("MP_RESULT "):]))
    return outs


def _sgd_lm(cfg, device, params, lr):
    """The LM with Sgd(lr) on every layer (and no Adam state)."""
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    net = build_lm(cfg, device, params)
    for layer in net.layers:
        layer.updater = Sgd(lr)
    net.updater_state = {k: {n: {} for n in lp}
                         for k, lp in net.updater_state.items()}
    return net


def _held(fails, what, losses, l_single, motion, steps):
    """A trainer's per-step losses held to the single card's at
    TRAIN_LOSS_RTOL, and its params (`motion`, `param_motion_diff`'s
    result) at PARAM_MOTION_RTOL, attn_bk by Adam's step bound. Returns
    the numbers for the report."""
    (worst, at), bk = motion
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l_single))
    bk_tol = 2 * steps * adam_step_max(LONG_LR, steps)
    fails.check(len(losses) == len(l_single) and rel <= TRAIN_LOSS_RTOL,
                f"multiprocess {what}: losses {losses} vs the single "
                f"card's {l_single} (rel {rel:.3g})")
    fails.check(worst <= PARAM_MOTION_RTOL and bk <= bk_tol,
                f"multiprocess {what}: params {worst:.3g} of the single "
                f"card's motion at {at} (tol {PARAM_MOTION_RTOL}), attn_bk "
                f"{bk:.3g} (tol {bk_tol:.3g})")
    return dict(loss_rel=rel, param_motion=worst, param_motion_at=at,
                attn_bk_max_abs=bk, attn_bk_tol=bk_tol)


def _mp_pipeline(device, fails, cfg, params, batches, l_single, want, init,
                 steps, out, rec):
    """(d): pipe=4 and pipe=2 x data=2 against the single card: one
    Sgd(PP_SGD_LR) step at JAX's rtol 2e-4 / atol 1e-6, and pipe=4's
    `steps` Adam steps held by `_held`; ms/step and the bubble share."""
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, PipelineParallelTrainer, make_mesh)
    B = len(batches[0].features)
    ref = _sgd_lm(cfg, device, params, PP_SGD_LR)
    ref.fit(batches[0])
    sgd_want = {k: v.detach().float().cpu()
                for k, v in ref.param_table().items()}
    del ref

    def sgd_err(net):
        worst = 0.0
        for k, v in net.param_table().items():
            g, w = v.detach().float().cpu(), sgd_want[k]
            worst = max(worst, float(((g - w).abs() - 2e-4 * w.abs())
                                     .max()))
        return worst
    r = {}
    for tag, spec, kw in (("pipe4", dict(pipe=4), dict(microbatches=4)),
                          ("pipe2_data2", dict(data=2, pipe=2),
                           dict(microbatches=2, data_axis="data"))):
        net = _sgd_lm(cfg, device, params, PP_SGD_LR)
        tr = PipelineParallelTrainer(net, make_mesh(MeshSpec.of(**spec),
                                     devices=[device] * 4), **kw)
        _sync(device)
        rec.start("d_sgd")
        t0 = time.perf_counter()
        tr.fit(batches[0].features, batches[0].labels, batch_size=B)
        _sync(device)
        sgd_ms = (time.perf_counter() - t0) * 1e3
        rec.stop()
        err = sgd_err(net)
        fails.check(err <= 1e-6, f"multiprocess (d) {tag}: Sgd({PP_SGD_LR}) "
                    f"step {err:.3g} past JAX's rtol 2e-4 / atol 1e-6 of "
                    f"the single card")
        r[tag] = dict(sgd_excess=err, sgd_step_ms=sgd_ms,
                      bubble_share=tr.bubble_share(),
                      stages=tr.n_stages, microbatches=tr.microbatches)
        del net, tr
    net = build_lm(cfg, device, params, lr=LONG_LR)
    tr = PipelineParallelTrainer(net, make_mesh(MeshSpec.of(pipe=4),
                                                devices=[device] * 4),
                                 microbatches=4)
    _sync(device)
    rec.start("d")
    t0 = time.perf_counter()
    losses = _par_fit(tr, batches[:steps])
    _sync(device)
    wall = time.perf_counter() - t0
    rec.stop()
    held = _held(fails, "(d) pipe4 Adam", losses, l_single,
                 param_motion_diff(_host_table(net), want, init), steps)
    r["pipe4"].update(adam_losses=losses, ms_per_step=wall / steps * 1e3,
                      **{f"adam_{k}": v for k, v in held.items()})
    out["d"] = r


def _mp_graph_and_diag(device, fails, cfg, params, batches, c, out, rec):
    """(e): the graph LM with a ring over seq=4 against the local graph
    (output and one step), and threshold with diagnostics on against
    off, bit-equal while `skip` never fires."""
    import torch
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, ParallelTrainer, ThresholdConfig, make_mesh,
        sequence_sharding)
    B = c["graph_B"]
    x, y = batches[0].features[:B], batches[0].labels[:B]
    local = graph_lm(cfg, device, params)
    ring = graph_lm(cfg, device, params, sequence_parallel="ring")
    for net in (local, ring):
        for layer in net.layers:
            layer.updater.learning_rate = LONG_LR
    o_local = local.output(x)
    local.fit(x, y, batch_size=B)
    mesh = make_mesh(MeshSpec.of(seq=SEQ_P), devices=[device] * SEQ_P)
    rec.start("e_ring")
    with sequence_sharding(mesh, axis="seq"):
        o_ring = ring.output(x)
        ring.fit(x, y, batch_size=B)
    _sync(device)
    rec.stop()
    o_local = o_local[0] if isinstance(o_local, list) else o_local
    o_ring = o_ring[0] if isinstance(o_ring, list) else o_ring
    err = float((o_ring.float() - o_local.float()).abs().max())
    rel = abs(ring.score_value - local.score_value) / abs(local.score_value)
    fails.check(err <= OUTPUT_ATOL, f"multiprocess (e) graph ring output "
                f"{err:.3g} from the local graph (tol {OUTPUT_ATOL})")
    fails.check(rel <= TRAIN_LOSS_RTOL, f"multiprocess (e) graph ring "
                f"step loss rel {rel:.3g}")
    del local, ring
    trees = []
    rec.start("e_diag")
    for diag in (None, "skip"):
        net = build_lm(cfg, device, params, lr=LONG_LR, diagnostics=diag)
        tr = ParallelTrainer(net, _par_mesh(device),
                             gradient_sharing="threshold",
                             threshold_config=ThresholdConfig(
                                 initial_threshold=LONG_LR))
        _par_fit(tr, batches[:c["steps"]])
        snap = {k: v.clone() for k, v in net.param_table().items()}
        for r_, tree in enumerate(tr._res_r):
            for lk, lp in tree.items():
                for pk, t in lp.items():
                    snap[f"res{r_}/{lk}/{pk}"] = t.clone()
        for lk, lst in net.updater_state.items():
            for pk, st in lst.items():
                for sk, t in st.items():
                    snap[f"upd/{lk}/{pk}/{sk}"] = t.clone()
        trees.append((snap, net._diag.skipped_total if diag else 0,
                      net._last_diagnostics))
        del net, tr
    _sync(device)
    rec.stop()
    bad = [k for k in trees[0][0]
           if not torch.equal(trees[0][0][k], trees[1][0][k])]
    fails.check(not bad and trees[1][1] == 0 and trees[1][2] is not None,
                f"multiprocess (e) threshold with diagnostics (skip) not "
                f"bit-equal to off: {bad[:6]}, skipped {trees[1][1]}")
    out["e"] = dict(graph_ring_output_err=err, graph_ring_loss_rel=rel,
                    diag_bit_equal=not bad, diag_skipped=trees[1][1],
                    diag_rows=sorted((trees[1][2] or {}).keys()))


def _mp_moe_and_checkpoint(device, fails, c, tr, net, ids, out, rec):
    """(c) continued: the MoE LM under moe_param_specs on expert=4
    against the single card, and a ShardedCheckpoint round trip of the
    sharded trainer's state."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, ShardedParallelTrainer, make_mesh, moe_param_specs)
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
        ShardedCheckpoint)
    mcfg = dict(MOE_LM, vocab=64, d_model=64, n_layers=2, max_len=64,
                hidden=128) if device.type == "cpu" else MOE_LM
    B, n = c["moe_B"], c["moe_steps"]
    X, Y = lm_corpus(mcfg, B * n, seed=62)
    single = MultiLayerNetwork(moe_lm_conf(mcfg), device=device).init()
    sharded = single.copy()
    l_single = _fit_steps(single, X, Y, B)
    mt = ShardedParallelTrainer(sharded, make_mesh(
        MeshSpec.of(data=1, expert=4), devices=[device] * 4),
        param_specs=moe_param_specs(sharded, "expert"))
    rec.start("c_moe")
    l_sh, mem = _sharded_fit(mt, device,
                             lambda: _par_fit(mt, _par_batches(X, Y, B)))
    rec.stop()
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_sh, l_single))
    fails.check(rel <= TRAIN_LOSS_RTOL, f"multiprocess (c) MoE on expert=4: "
                f"losses {l_sh} vs the single card's {l_single}")
    experts = sum(1 for lp in mt.param_specs.values() for sp in lp.values()
                  if "expert" in (sp or ()))
    out["c"]["moe"] = dict(losses=l_sh, single=l_single, rel=rel,
                           expert_sharded_leaves=experts, memory=mem)
    del single, sharded, mt
    d = tempfile.mkdtemp(prefix="sharded_", dir=OUT_DIR)
    try:
        want = net.output(ids)
        t0 = time.perf_counter()
        ShardedCheckpoint.save(os.path.join(d, "ck"), net, trainer=tr)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ShardedCheckpoint.restore(os.path.join(d, "ck"),
                                         device=device)
        restore_s = time.perf_counter() - t0
        same = torch.equal(back.output(ids), want)
        fails.check(same, "multiprocess (c) ShardedCheckpoint round trip: "
                    "output() changed")
        out["c"]["checkpoint"] = dict(output_equal=same, save_s=save_s,
                                      restore_s=restore_s)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_multiprocess(device, report, fails, small=False):
    """Phase 18 on `device` (see the module docstring, 18 (a)-(e)):
    multi-process data parallelism, barrier checkpoints, the sharded and
    pipelined trainers and the two repairs, on the long-context LM.
    `small` (the CPU rehearsal) shrinks the LM. Returns the phase's
    kernel launches, the sum of its parts' (the workers' included);
    each part's are in the report's `launches_by_part`."""
    import shutil
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, ParallelTrainer, ShardedParallelTrainer, make_mesh)
    c = MP_SMALL if small else MP
    t_start = time.perf_counter()
    cfg, params, X, Y, batches = _mp_setup(c)
    steps, B = c["steps"], c["B"]
    backend = ("nccl" if device.type == "cuda"
               and torch.cuda.device_count() >= 2 else "gloo")
    out = dict(config=dict(cfg, global_batch=[c["B"], cfg["max_len"]],
                           processes=c["procs"], replicas_per_process=2,
                           lr=LONG_LR, backend=backend))
    parts, rec = {}, _PartLaunches()
    # the references, outside every part: the single card's fit ((a)'s
    # dense modes, (c) and (d)) and (a)'s threshold in one process on
    # phase 17's 4-replica mesh
    single = build_lm(cfg, device, params, lr=LONG_LR)
    init = _host_table(single)
    l_single = _fit_steps(single, X[:steps * B], Y[:steps * B], B)
    want = _host_table(single)
    del single
    l_thr = _par_fit(ParallelTrainer(
        build_lm(cfg, device, params, lr=LONG_LR), _par_mesh(device),
        **dict(_mp_modes())["threshold"]), batches[:steps])
    d = tempfile.mkdtemp(prefix="mp_", dir=OUT_DIR)
    try:
        ref_path = os.path.join(d, "single.npz")
        np.savez(ref_path, **want)
        parts["refs"] = time.perf_counter() - t_start
        # ---- (a)-(c) in 2 processes
        t0 = time.perf_counter()
        workers = _mp_spawn(c, device, backend, os.path.join(d, "ckpt"),
                            ref_path, small)
        parts["workers"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    w0 = workers[0]
    a = {}
    for name, _ in _mp_modes():
        ref = l_thr if name == "threshold" else l_single
        got = w0[name]["losses"][:steps]
        err = max(abs(g - w) / abs(w) for g, w in zip(got, ref))
        same = all(w[name]["losses"] == w0[name]["losses"] for w in workers)
        fails.check(err <= TRAIN_LOSS_RTOL and same, f"multiprocess (a) "
                    f"{name}: 2-process losses {got} vs one process's {ref} "
                    f"(rel {err:.3g})")
        a[name] = dict(w0[name], one_process=ref, err=err)
    out["a"] = a
    out["backend"] = w0["backend"]
    b = w0["b"]
    fails.check(all(w["b"]["bit_equal"] and w["b"]["resumed_at"] == 2
                    for w in workers),
                f"multiprocess (b) barrier checkpoint resume: {b}")
    out["b"] = b
    cw = w0["c"]
    cw.update(_held(fails, "(c) 2-process sharded", cw["losses"], l_single,
                    (cw["param_motion"], cw["attn_bk_max_abs"]), steps))
    # each process keeps its half of the sharded leaves between steps
    fails.check(all(w["c"]["memory"]["held_between_steps"]
                    < w["c"]["memory"]["held_whole"] for w in workers),
                f"multiprocess (c) 2-process sharded: a process holds "
                f"{cw['memory']} bytes between steps, not less than whole")
    for w in workers:
        for part, counts in w["launches_by_part"].items():
            rec.add(part, counts)
    # ---- (c) the sharded trainer in this process
    t0 = time.perf_counter()
    net = build_lm(cfg, device, params, lr=LONG_LR)
    tr = ShardedParallelTrainer(net, make_mesh(MeshSpec.of(model=2, data=2),
                                               devices=[device] * 4))
    rec.start("c")
    tt = time.perf_counter()
    l_tp, mem = _sharded_fit(tr, device,
                             lambda: _par_fit(tr, batches[:steps]))
    _sync(device)
    tp_ms = (time.perf_counter() - tt) / steps * 1e3
    rec.stop()
    held = _held(fails, "(c) sharded", l_tp, l_single,
                 param_motion_diff(_host_table(net), want, init), steps)
    # one process holds every shard: the whole model, nothing twice
    fails.check(mem["held_between_steps"] == mem["held_whole"],
                f"multiprocess (c) sharded: {mem['held_between_steps']} "
                f"bytes held between steps, {mem['held_whole']} whole")
    out["c"] = dict(losses=l_tp, single=l_single, ms_per_step=tp_ms,
                    memory=mem, two_process=cw, **held)
    _mp_moe_and_checkpoint(device, fails, c, tr, net,
                           batches[0].features[:1], out, rec)
    del net, tr
    parts["c"] = time.perf_counter() - t0
    # ---- (d) the pipeline
    t0 = time.perf_counter()
    _mp_pipeline(device, fails, cfg, params, batches, l_single, want, init,
                 steps, out, rec)
    parts["d"] = time.perf_counter() - t0
    # ---- (e) the repairs
    t0 = time.perf_counter()
    _mp_graph_and_diag(device, fails, cfg, params, batches, c, out, rec)
    parts["e"] = time.perf_counter() - t0
    launches = {k: sum(p.get(k, 0) for p in rec.by_part.values())
                for k in KERNEL_META}
    if device.type == "cuda":
        for part, kernels in MP_KERNELS.items():
            _launched(fails, f"multiprocess part {part}",
                      rec.by_part.get(part, {}), kernels)
    out["part_seconds"] = parts
    out["launches_by_part"] = rec.by_part
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["seconds"] = time.perf_counter() - t_start
    report["multiprocess"] = out
    _print_multiprocess(out)
    return launches


def _mb(n):
    return "n/a" if n is None else f"{n / 1e6:.1f}"


def _print_multiprocess(out):
    print(f"[multiprocess] backend {out['backend']} "
          f"({out['config']['processes']} processes x "
          f"{out['config']['replicas_per_process']} replicas)", flush=True)
    for name, r in out["a"].items():
        print(f"[multiprocess] (a) {name}: losses {r['losses']} vs one "
              f"process {r['one_process']} (rel {r['err']:.3g}); "
              f"{r['ms_per_step']:.1f} ms/step after a first step of "
              f"{r['first_step_ms']:.1f}, exchange host "
              f"{r['exchange_host_ms_per_step']:.1f} ms, "
              f"{r['bytes_per_step'] / 1e6:.1f} MB across processes a "
              f"step", flush=True)
    b = out["b"]
    print(f"[multiprocess] (b) barrier checkpoint: resumed at "
          f"{b['resumed_at']}, bit-equal {b['bit_equal']}, write "
          f"{b['write_s']:.2f} s, resume {b['resume_s']:.2f} s", flush=True)
    for tag, r in (("model=2 x data=2, 1 process", out["c"]),
                   ("model=2 across 2 processes", out["c"]["two_process"])):
        m = r["memory"]
        print(f"[multiprocess] (c) sharded {tag}: loss rel "
              f"{r['loss_rel']:.3g}, params {r['param_motion']:.3g} of the "
              f"single card's motion, attn_bk {r['attn_bk_max_abs']:.3g}; "
              f"{r['ms_per_step']:.1f} ms/step; a process holds "
              f"{_mb(m['held_whole'])} MB of params and slots whole, "
              f"{_mb(m['held_between_steps'])} MB between steps; allocated "
              f"{_mb(m.get('allocated_before'))} MB before the fit, "
              f"{_mb(m.get('allocated_between_steps'))} MB between steps, "
              f"peak {_mb(m.get('allocated_peak'))} MB"
              + (f"; {r['bytes_per_step'] / 1e6:.1f} MB across processes "
                 f"a step in {r['calls_per_step']:.1f} calls"
                 if "bytes_per_step" in r else ""), flush=True)
    m, k = out["c"]["moe"], out["c"]["checkpoint"]
    print(f"[multiprocess] (c) MoE expert=4: losses {m['losses']} vs "
          f"{m['single']} (rel {m['rel']:.3g}), held "
          f"{_mb(m['memory']['held_whole'])} MB whole, "
          f"{_mb(m['memory']['held_between_steps'])} MB between steps; "
          f"ShardedCheckpoint output equal {k['output_equal']}, save "
          f"{k['save_s']:.2f} s, restore {k['restore_s']:.2f} s", flush=True)
    for tag, r in out["d"].items():
        print(f"[multiprocess] (d) {tag}: Sgd({PP_SGD_LR}) step excess "
              f"{r['sgd_excess']:.3g}, bubble {r['bubble_share']:.3f}"
              + (f", Adam loss rel {r['adam_loss_rel']:.3g}, params "
                 f"{r['adam_param_motion']:.3g} of the single card's "
                 f"motion, {r['ms_per_step']:.1f} ms/step"
                 if "ms_per_step" in r else ""), flush=True)
    e = out["e"]
    print(f"[multiprocess] (e) graph ring output err "
          f"{e['graph_ring_output_err']:.3g}, loss rel "
          f"{e['graph_ring_loss_rel']:.3g}; threshold diagnostics skip "
          f"bit-equal {e['diag_bit_equal']}", flush=True)
    print(f"[multiprocess] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 1) for k, v in out['part_seconds'].items()} }), "
          f"launches by part {out['launches_by_part']}", flush=True)


# ------------------------------------------------------------ phase 19
# phase 19's LM, steps and (b)'s scripted join and leave; the drill's
# scenario and control-plane timings are `parallel/elastic_smoke.py`'s
ELASTIC = dict(cfg=None, B=8, batches=10, join_at=3, leave_at=6)
# the CPU rehearsal's victim registers again within a few seconds, so
# the shrunk world lasts less than the default pack's 5 s hysteresis:
# the rehearsal's elastic-shrink rule fires after 1 s
ELASTIC_SMALL = dict(ELASTIC, cfg=dict(LM_LONG, vocab=64, d_model=64,
                                       n_layers=2, max_len=64),
                     for_s=1.0)
# the kernels each part of phase 19 launches on the card: (a)'s workers
# train in threshold mode, whose replicas apply Adam per leaf (phase 17),
# (b) in dense sync, through fused Adam
ELASTIC_KERNELS = {"a": tuple(k for k in PARALLEL_KERNELS
                              if k != "fused_adam"),
                   "b": PARALLEL_KERNELS}
ELASTIC_PARAMS_SEED, ELASTIC_DATA_SEED = 1919, 19


def _elastic_cfg(small):
    return (ELASTIC_SMALL if small else ELASTIC)["cfg"] or LM_LONG_QUARTER


def elastic_lm(device, small=False):
    """Phase 19's LM (the long-context config at `LM_LONG_QUARTER`'s depth,
    seeded params, Adam(LONG_LR)), built on `device`: the model builder
    the elastic drill's workers import."""
    cfg = _elastic_cfg(small)
    return build_lm(cfg, device, random_lm_params(
        cfg, seed=ELASTIC_PARAMS_SEED, head_scale=1.0), lr=LONG_LR)


def elastic_data(small=False):
    """Phase 19's windows: `batches` global batches of [B, max_len]."""
    c = ELASTIC_SMALL if small else ELASTIC
    cfg = _elastic_cfg(small)
    return lm_corpus(cfg, c["B"] * c["batches"], seed=ELASTIC_DATA_SEED,
                     T=cfg["max_len"])


def _elastic_spec(device, small):
    c = ELASTIC_SMALL if small else ELASTIC
    spec = dict(
        device=device.type, model="chip_smoke:elastic_lm",
        model_kwargs=dict(small=small), data="chip_smoke:elastic_data",
        data_kwargs=dict(small=small), batch=c["B"],
        trainer_kwargs=dict(threshold_config=dict(initial_threshold=LONG_LR)),
        pythonpath=HERE)
    if "for_s" in c:
        spec["for_s"] = c["for_s"]
    return spec


def _elastic_inprocess(device, fails, c, small, rec, ckpt_dir):
    """(b): an ElasticTrainer whose runtime seams are stubbed, its mesh
    following the plan ([card] * 4 alone, [card] * 2 with a second
    member), over one join and one leave (a listener waits at the scripted
    steps until the trainer's client sees the new generation), dense sync;
    held step by step to an uninterrupted 4-replica fit."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener, TrainingListener)
    from deeplearning4j_tpu_torch.parallel import elastic as el
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelTrainer
    from deeplearning4j_tpu_torch.parallel import make_mesh

    X, Y = elastic_data(small)

    def make_iter():
        return ArrayDataSetIterator(X, Y, batch_size=c["B"], shuffle=True,
                                    seed=11)

    ref = elastic_lm(device, small)
    init = _host_table(ref)
    scores = CollectScoresListener()
    ref.set_listeners(scores)
    t0 = time.perf_counter()
    ParallelTrainer(ref, _par_mesh(device)).fit(make_iter(), epochs=1,
                                                batch_size=c["B"])
    _sync(device)
    ref_s = time.perf_counter() - t0
    l_ref = [v for _, v in scores.scores]
    want = _host_table(ref)
    del ref

    class InProcess(el.ElasticTrainer):
        def _init_runtime(self, plan):
            pass

        def _teardown_runtime(self):
            pass

        def _mesh(self, plan):
            n = PAR_N if plan["num_processes"] == 1 else PAR_N // 2
            return make_mesh(MeshSpec.of(data=n), devices=[device] * n)

    reg = monitor.enable(monitor.MetricsRegistry(), jit_compile=False,
                         device_memory=False)
    co = el.ElasticCoordinator(settle_s=0.05, grace_s=60.0, tick_s=0.01,
                               min_members=1).start()
    losses, stamps = {}, []
    try:
        et = InProcess(lambda: elastic_lm(device, small), config=el.
                       ElasticConfig(control_address=co.address, token="w0",
                                     heartbeat_interval_s=0.02),
                       ckpt_dir=ckpt_dir, ckpt_frequency=10 ** 6,
                       keep_last=2)
        fake = el.ElasticClient(co.address, "zz-joiner",
                                heartbeat_interval_s=0.02)

        class Script(TrainingListener):
            def iteration_done(self, model, iteration, epoch, score, **kw):
                losses[iteration] = float(score)
                stamps.append(time.perf_counter())
                step, gen = iteration + 1, et.client.generation()
                if step == c["join_at"]:
                    fake.register()
                    fake.start_heartbeats()
                elif step == c["leave_at"]:
                    fake.stop()
                    fake.leave("shrink")
                else:
                    return
                deadline = time.time() + 60
                while et.client.generation() == gen:
                    if time.time() > deadline:
                        raise RuntimeError(f"no generation after step "
                                           f"{step}")
                    time.sleep(0.005)

        rec.start("b")
        t0 = time.perf_counter()
        model = et.fit(make_iter, epochs=1, batch_size=c["B"],
                       extra_listeners=lambda gen: [Script()])
        _sync(device)
        run_s = time.perf_counter() - t0
        rec.stop()
        snap = reg.snapshot()
    finally:
        co.stop()
        monitor.disable()
    got = [losses.get(i) for i in range(len(l_ref))]
    rel = max(abs(a - b) / abs(b) if a is not None else float("inf")
              for a, b in zip(got, l_ref))
    (motion, at), bk = param_motion_diff(_host_table(model), want, init)
    hist = et.history
    fails.check(rel <= TRAIN_LOSS_RTOL,
                f"elastic (b): losses {got} vs the uninterrupted fit's "
                f"{l_ref} (rel {rel:.3g})")
    fails.check(motion <= PARAM_MOTION_RTOL,
                f"elastic (b): params {motion:.3g} of the uninterrupted "
                f"fit's motion at {at} (tol {PARAM_MOTION_RTOL})")
    fails.check([h["n_workers"] for h in hist] == [PAR_N, PAR_N // 2, PAR_N]
                and [h["step"] for h in hist]
                == [0, c["join_at"], c["leave_at"]]
                and all(h["resumed"] for h in hist[1:]),
                f"elastic (b): generations {hist}")

    def value(name):
        vals = snap.get(name, {}).get("values", [])
        return vals[0]["value"] if vals else None
    read = dict(elastic_generation=value("elastic_generation"),
                elastic_drains_total=value("elastic_drains_total"),
                elastic_resume_total=value("elastic_resume_total"))
    fails.check(read == dict(elastic_generation=float(hist[-1]["generation"]),
                             elastic_drains_total=2.0,
                             elastic_resume_total=2.0),
                f"elastic (b): the registry reads {read}, the run drained "
                f"twice and resumed twice into generation "
                f"{hist[-1]['generation']}")
    gaps = np.diff(stamps) * 1e3
    return dict(losses=got, reference=l_ref, loss_rel=rel,
                param_motion=motion, attn_bk_max_abs=bk, history=hist,
                metrics=read, reference_s=ref_s, run_s=run_s,
                ms_per_step_median=float(np.median(gaps)) if len(gaps) else
                None)


def phase_elastic(device, report, fails, small=False):
    """Phase 19 on `device` (see the module docstring, 19 (a)-(c)): the
    elastic runtime on the long-context LM. `small` (the CPU rehearsal)
    shrinks the LM. Returns the phase's kernel launches, the sum of its
    parts' ((a)'s workers' included); each part's are in the report's
    `launches_by_part`."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel import elastic_smoke
    c = ELASTIC_SMALL if small else ELASTIC
    t_start = time.perf_counter()
    cfg = _elastic_cfg(small)
    spec = _elastic_spec(device, small)
    es = elastic_smoke
    out = dict(config=dict(cfg, global_batch=[c["B"], cfg["max_len"]],
                           steps=c["batches"], processes=es.N_WORKERS,
                           lr=LONG_LR, backend="gloo" if device.type == "cpu"
                           or _cuda_count() < 2 else "nccl",
                           kill_at=es.KILL_AT, grow_after=es.GROW_AFTER,
                           grace_s=es.GRACE_S, settle_s=es.SETTLE_S))
    rec, parts = _PartLaunches(), {}
    os.makedirs(OUT_DIR, exist_ok=True)
    d = tempfile.mkdtemp(prefix="elastic_", dir=OUT_DIR)
    try:
        # ---- (a) and (c): the drill; its references outside every part
        t0 = time.perf_counter()
        refs = elastic_smoke.references(dict(elastic_smoke.DEFAULTS, **spec),
                                        os.path.join(d, "refs"))
        parts["a_reference"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            a = elastic_smoke.run_drill(work_dir=os.path.join(d, "drill"),
                                        refs=refs, **spec)
        except elastic_smoke.DrillFailed as e:
            fails.append(f"elastic (a): {str(e)[:3000]}")
            a = e.report
        except RuntimeError as e:
            fails.append(f"elastic (a): {str(e)[:3000]}")
            a = None
        parts["a"] = time.perf_counter() - t0
        if a is not None:
            rec.add("a", a.pop("launches"))
            out["a"] = a
        # ---- (b): drain, join and leave in dense sync, in this process
        t0 = time.perf_counter()
        out["b"] = _elastic_inprocess(device, fails, c, small, rec,
                                      os.path.join(d, "inproc"))
        parts["b"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    launches = {k: sum(p.get(k, 0) for p in rec.by_part.values())
                for k in KERNEL_META}
    if device.type == "cuda":
        for part, kernels in ELASTIC_KERNELS.items():
            _launched(fails, f"elastic part {part}", rec.by_part.get(part, {}),
                      kernels)
    out["part_seconds"] = parts
    out["launches_by_part"] = rec.by_part
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["seconds"] = time.perf_counter() - t_start
    report["elastic"] = out
    _print_elastic(out)
    return launches


def _cuda_count():
    import torch
    return torch.cuda.device_count()


def _fmt_s(x):
    return "n/a" if x is None else f"{x:.2f}"


def _print_elastic_steps(tl):
    by_gen = tl["ms_per_step"].items()
    print(f"[elastic] (a) ms/step by generation "
          f"{ {g: _fmt_s(v['ms_per_step']) for g, v in by_gen} }"
          f", first step s "
          f"{ {g: _fmt_s(v['first_step_s']) for g, v in by_gen} }"
          f"; drain check {tl['drain_check_host_ms']:.3f} host ms a "
          f"step; {tl['ckpt_writes']} checkpoint writes of "
          f"{_fmt_s(tl['ckpt_mb'])} MB, {_fmt_s(tl['ckpt_write_s'])} s "
          f"each; resume s {[round(x, 3) for x in tl['resume_s']]}",
          flush=True)


def _print_elastic(out):
    a = out.get("a")
    if a is not None:
        print(f"[elastic] (a) {a['n_workers']} workers, generations "
              f"{a['generations']} of widths {a['widths']}; against the "
              f"scheduled run: losses rel {a['schedule_loss_rel']:.3g}, "
              f"params {a['param_motion']:.3g} of its motion (at "
              f"{a['param_motion_at']}); against the uninterrupted run: "
              f"loss drift {a['max_loss_drift']:.4g} (band "
              f"{0.25 * a['initial_loss']:.4g}; the scheduled run's own "
              f"{a['schedule_drift']:.4g}), final params off by "
              f"{a['final_param_diff']:.3g}; steps lost "
              f"{a['steps_lost']}", flush=True)
        tl = a["timeline"]
        for what in ("shrink", "regrow"):
            t = tl.get(what)
            if t is None:
                continue
            rs = t["resume_split"]
            print(f"[elastic] (a) {what}: {t['total_s']:.2f} s to the "
                  f"survivor's first step (detection "
                  f"{t['detection_s']:.2f}, settle {t['settle_s']:.2f}, "
                  f"re-init {t['reinit_s']:.2f}, resume "
                  f"{t['resume_s']:.2f}: build {rs['build_s']:.2f}, "
                  f"restore {rs['restore_s']:.2f}, first step "
                  f"{rs['first_step_s']:.2f})", flush=True)
        if tl:
            _print_elastic_steps(tl)
        t = a["telemetry"]
        print(f"[elastic] (c) elastic-shrink {t['elastic_shrink']}, "
              f"worker-vanished {t['worker_vanished']}, w1 export age max "
              f"{t['export_age_max_s'].get('w1', 0):.1f} s, drains "
              f"{t['elastic_drains_total']}, resumes "
              f"{t['elastic_resume_total']}, reconfigurations "
              f"{t['elastic_reconfigurations_total']}", flush=True)
    b = out["b"]
    print(f"[elastic] (b) dense sync over a join and a leave: loss rel "
          f"{b['loss_rel']:.3g}, params {b['param_motion']:.3g} of the "
          f"uninterrupted fit's motion, widths "
          f"{[h['n_workers'] for h in b['history']]}, metrics "
          f"{b['metrics']}, median {_fmt_s(b['ms_per_step_median'])} ms "
          f"between steps", flush=True)
    print(f"[elastic] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 1) for k, v in out['part_seconds'].items()} }), "
          f"launches by part {out['launches_by_part']}", flush=True)


# ------------------------------------------------------------ phase 20
# phase 20's configuration: the smoke LM at full width and phase 3's
# depth (`LM`), seeded params (head x4); (a) fits `fit_steps` steps of
# [fit_B, max_len - 1] publishing every `publish_every`; the servers
# have `n_slots` slots of block_len 16 and a pool for that many
# full-budget streams; (b) bursts `greedy` + `sampled` requests of
# `n_tok` tokens (prompts `lens`, warmed on their buckets) and sends
# `after` more past the flip; (c) floods twice the greedy prompts
# and the sampled ones against `queue_high`; (d) floods `flood_greedy`
# greedy and the sampled requests across two replicas; (e) routes
# [route_B, route_T] token ids
FLEET = dict(cfg=None, fit_B=8, fit_steps=6, publish_every=3, n_slots=8,
             greedy=16, sampled=4, n_tok=64, lens=(16, 64), after=8,
             queue_high=8, flood_greedy=12, route_B=4, route_T=128,
             ready_timeout_s=300.0)
FLEET_SMALL = dict(FLEET, cfg=dict(LM, d_model=64, n_heads=4, n_layers=2,
                                   max_len=128),
                   fit_B=2, n_slots=4, greedy=8, sampled=2, n_tok=32,
                   lens=(3, 24), after=4, queue_high=2,
                   flood_greedy=8, route_B=2, route_T=32,
                   ready_timeout_s=120.0)
FLEET_BL = 16
# the kernels each part of phase 20 launches on the card: (a) trains
# (flash forward and backward, both LayerNorms, fused Adam); (b)-(d)
# serve greedy and sampled requests (LayerNorm, the per-row-key words;
# prefill attends through the KV-cache path, not flash); (e) runs
# `output()` (flash forward)
_SERVE_KERNELS = ("layer_norm", "threefry_rows")
FLEET_KERNELS = {"a": ("layer_norm", "residual_layer_norm",
                       "flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv", "fused_adam"),
                 "b": _SERVE_KERNELS, "c": _SERVE_KERNELS,
                 "d": _SERVE_KERNELS, "e": ("flash_attention_fwd",)}
FLEET_PARAMS_SEED, FLEET_DATA_SEED, FLEET_PROMPT_SEED = 2020, 20, 200


def _fleet_requests(cfg, c):
    """(b)'s burst: [(prompt, generate kwargs)], the greedy requests
    first, then the sampled ones (temperature 0.8, top_p 0.9, a [2]
    uint32 key each: the wire to a replica carries keys, not seeds)."""
    rng = np.random.default_rng(FLEET_PROMPT_SEED)
    lo, hi = c["lens"]
    n = c["greedy"] + c["sampled"]
    prompts = [rng.integers(0, cfg["vocab"], int(k))
               for k in rng.integers(lo, hi + 1, n)]
    reqs = [(p, {}) for p in prompts[:c["greedy"]]]
    reqs += [(p, dict(temperature=0.8, top_p=0.9,
                      rng=np.asarray([20, 2000 + i], np.uint32)))
             for i, p in enumerate(prompts[c["greedy"]:])]
    return reqs


def _fleet_server_kw(cfg, c):
    return dict(n_slots=c["n_slots"], block_len=FLEET_BL,
                n_blocks=c["n_slots"] * (cfg["max_len"] // FLEET_BL) + 1)


def _fleet_publish(device, fails, cfg, c, root, rec):
    """(a): `fit` with a publish listener every `publish_every` steps;
    each published zip, restored on the CPU, must equal the card's
    params at its step bit for bit."""
    import torch

    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    net = build_lm(cfg, device, random_lm_params(
        cfg, seed=FLEET_PARAMS_SEED, head_scale=4.0))
    X, Y = lm_corpus(cfg, c["fit_B"] * c["fit_steps"], seed=FLEET_DATA_SEED)
    reg = ModelRegistry(root)
    snaps = {}

    class Snapshot(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score, **info):
            if (iteration + 1) % c["publish_every"] == 0:
                snaps[iteration + 1] = {
                    k: t.detach().cpu().clone()
                    for k, t in model.param_table().items()}

    pub = reg.publish_listener("lm", frequency=c["publish_every"])
    net.add_listener(Snapshot())
    net.add_listener(pub)
    rec.start("a")
    t0 = time.perf_counter()
    net.fit(X, Y, batch_size=c["fit_B"], shuffle=False)
    _sync(device)
    fit_s = time.perf_counter() - t0
    rec.stop()
    want_steps = list(range(c["publish_every"], c["fit_steps"] + 1,
                            c["publish_every"]))
    fails.check(pub.published_steps == want_steps
                and pub.published_versions == [1, 2],
                f"fleet (a): published steps {pub.published_steps} "
                f"versions {pub.published_versions}, want {want_steps} "
                f"and [1, 2]")
    equal = {}
    for v, step in zip(pub.published_versions, pub.published_steps):
        cpu, rv = reg.resolve("lm", v, device="cpu")
        got = cpu.param_table()
        equal[v] = (rv == v and got.keys() == snaps[step].keys()
                    and all(torch.equal(got[k], snaps[step][k])
                            for k in got))
    fails.check(all(equal.values()) and len(equal) == 2,
                f"fleet (a): published zips against the card's params at "
                f"their steps: {equal}")
    return dict(steps=c["fit_steps"], published_steps=pub.published_steps,
                versions=pub.published_versions, bit_equal=equal,
                fit_s=fit_s, zip_mb=os.path.getsize(reg.path("lm", 2)) / 1e6)


def _fleet_refs(cfg, c, nets, reqs):
    """Each version's single-server streams of the burst (an unswapped
    server of the fleet's configuration, outside every part), the
    greedy margin of each version's net (`_wide_vs_single`) and a CPU
    twin for the sampled margin."""
    kw = _fleet_server_kw(cfg, c)
    refs, eps, cpus = {}, {}, {}
    greedy = [p for p, a in reqs if not a]
    for v, net in nets.items():
        refs[v] = _serve(net, reqs, c["n_tok"], None,
                         n_slots=kw["n_slots"])[0]
        eps[v] = _wide_vs_single(net, greedy[:c["n_slots"]])
        cpus[v] = cpu_twin(net)
    return refs, eps, cpus


def _fleet_hold(fails, what, cfg, nets, cpus, eps, reqs, refs, streams):
    """`streams`: [(request index, version, tokens)]. Each is held to its
    version's reference: greedy by `stream_agreement` at that version's
    margin, sampled by phase 8's rule (`sampled_margin`), near-ties
    counted."""
    bad, ties, equal = [], 0, 0
    for v in sorted({ver for _, ver, _ in streams}):
        mine = [(i, t) for i, ver, t in streams if ver == v]
        equal += sum(list(t) == list(refs[v][i]) for i, t in mine)
        g = [(i, t) for i, t in mine if not reqs[i][1]]
        s = [(i, t) for i, t in mine if reqs[i][1]]
        if g:
            b, n = _agreement(nets[v], [reqs[i][0] for i, _ in g],
                              [refs[v][i] for i, _ in g],
                              [list(t) for _, t in g], eps[v])
            bad += [(v, g[j][0]) for j in b]
            ties += n
        if s:
            keys = [reqs[i][1]["rng"] for i, _ in s]
            b, n, _ = sampled_margin(
                cpus[v], nets[v], [reqs[i][0] for i, _ in s],
                [refs[v][i] for i, _ in s], [list(t) for _, t in s],
                lambda j, n_, keys=keys: engine_noise(keys[j], n_,
                                                      cfg["vocab"]),
                0.8, 0.9)
            bad += [(v, s[j][0]) for j in b]
            ties += n
    fails.check(not bad, f"fleet {what}: streams apart from their "
                         f"version's single-server reference beyond a "
                         f"near-tie: {bad}")
    return dict(streams=len(streams), equal=equal, near_ties=ties,
                apart=bad)


def _results(streams, timeout=600):
    """(tokens or None, error or None) of each stream: a failed stream
    is counted as dropped by the caller's check."""
    out = []
    for s in streams:
        try:
            out.append((list(np.asarray(s.result(timeout))), None))
        except Exception as e:  # noqa: BLE001 — counted as dropped
            out.append((None, repr(e)))
    return out


def _pct(xs):
    if not xs:
        return None
    return [float(np.percentile(xs, 50)), float(np.percentile(xs, 99))]


def _wait(cond, timeout, what, every=0.001):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} within {timeout} s")
        time.sleep(every)


def _fleet_swap(fails, cfg, c, fleet, router, reqs, held, rec):
    """(b): deploy v1 behind the router, warmed (it and every successor)
    on the burst's buckets, burst, swap to v2 in a background thread
    once the burst's first token is out, then the `after` requests past
    the flip."""
    import threading
    n_tok = c["n_tok"]
    rec.start("b")
    t0 = time.perf_counter()
    fleet.deploy("lm", version=1, warmup_prompt_len=c["lens"],
                 **_fleet_server_kw(cfg, c))
    deploy_s = time.perf_counter() - t0
    burst = [router.submit("lm", p, n_tok, **a) for p, a in reqs]
    _wait(lambda: any(s.tokens for s in burst), 120,
          "the burst's first token")
    box = {}

    def swap():
        t = time.perf_counter()
        try:
            box["version"] = fleet.swap("lm", version=2)
        finally:
            box["seconds"] = time.perf_counter() - t
            box["t_end"] = time.monotonic()

    th = threading.Thread(target=swap, name="fleet-swap", daemon=True)
    t_swap = time.monotonic()
    th.start()
    try:
        _wait(lambda: fleet.version("lm") == 2 or not th.is_alive(), 600,
              "the swap's pointer flip")
        t_flip = time.monotonic()
        after = [router.submit("lm", reqs[i][0], n_tok)
                 for i in range(c["after"])]
        t_after = time.monotonic()
    finally:
        th.join(timeout=600)
    got = _results(burst + after)
    rec.stop()
    fails.check(box.get("version") == 2,
                f"fleet (b): swap returned {box.get('version')}")
    dropped = [i for i, (t, e) in enumerate(got) if e is not None
               or len(t) != n_tok]
    fails.check(not dropped, f"fleet (b): dropped or short streams "
                             f"{dropped}: {[got[i][1] for i in dropped]}")
    tags = [s.version for s in burst + after]
    fails.check(set(tags) <= {1, 2} and all(s.version == 2 for s in after),
                f"fleet (b): version tags {tags}")
    idx = list(range(len(reqs))) + list(range(c["after"]))
    hold = held([(i, s.version, t) for i, s, (t, _) in
                 zip(idx, burst + after, got) if t is not None], "(b)")
    ttft_before = [s.t_first - s.t_submit for s in burst]
    ttft_after = [s.t_first - s.t_submit for s in after]
    return dict(deploy_s=deploy_s, swap_s=box.get("seconds"),
                flip_after_s=t_flip - t_swap,
                after_submitted_before_swap_end=t_after < box.get(
                    "t_end", float("inf")),
                streams=len(got), dropped=len(dropped),
                v1_streams=tags.count(1), v2_streams=tags.count(2),
                ttft_before_p50_p99_s=_pct(ttft_before),
                ttft_after_flip_p50_p99_s=_pct(ttft_after), hold=hold)


def _fleet_scale(fails, cfg, c, fleet, router, reqs, held, rec):
    """(c): a flood past `queue_high`; `FleetAutoscaler.check()` scales
    lm to twice its slots (and blocks) with the swap machinery."""
    from deeplearning4j_tpu_torch.serving import FleetAutoscaler
    kw = _fleet_server_kw(cfg, c)
    scaler = FleetAutoscaler(fleet, queue_depth_high=c["queue_high"],
                             factor=2, max_slots=2 * kw["n_slots"],
                             max_blocks=2 * kw["n_blocks"])
    idx = list(range(c["greedy"])) * 2 + list(
        range(c["greedy"], c["greedy"] + c["sampled"]))
    rec.start("c")
    t0 = time.perf_counter()
    flood = [router.submit("lm", reqs[i][0], c["n_tok"], **reqs[i][1])
             for i in idx]
    made = scaler.check()
    scale_s = time.perf_counter() - t0
    got = _results(flood)
    rec.stop()
    n_slots = fleet.server("lm").engine.n_slots
    fails.check(len(made) == 1 and made[0]["after"]["n_slots"]
                == 2 * kw["n_slots"] and n_slots == 2 * kw["n_slots"],
                f"fleet (c): decisions {made}, slots now {n_slots}")
    dropped = [i for i, (t, e) in enumerate(got) if e is not None
               or len(t) != c["n_tok"]]
    fails.check(not dropped, f"fleet (c): dropped or short streams "
                             f"{dropped}")
    fails.check(all(s.version == 2 for s in flood),
                f"fleet (c): version tags {[s.version for s in flood]}")
    hold = held([(i, 2, t) for i, (t, _) in zip(idx, got)
                 if t is not None], "(c)")
    rec_ = dict(made[0]) if made else {}
    return dict(decision=rec_, scale_s=scale_s, streams=len(flood),
                dropped=len(dropped), hold=hold)


def _fleet_replicas(device, fails, cfg, c, root, net, reqs, held, rec):
    """(d): an in-process ReplicaWorker on `device` and a spawned replica
    process resolving lm v2 from the registry, both behind a coordinator;
    the router balances a flood over them and the process is SIGKILLed
    once its first reply chunk is in."""
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticCoordinator
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter, ReplicaSet, ReplicaWorker, spawn_replica)
    kw = _fleet_server_kw(cfg, c)
    n_tok = c["n_tok"]
    idx = list(range(c["flood_greedy"])) + list(
        range(c["greedy"], c["greedy"] + c["sampled"]))
    coord = ElasticCoordinator(settle_s=0.05, grace_s=1.0,
                               tick_s=0.05).start()
    worker = proc = rset = None
    try:
        worker = ReplicaWorker(net, model="lm", version=2,
                               coordinator=coord.address,
                               heartbeat_interval_s=0.05, device=device,
                               **kw).start()
        t0 = time.perf_counter()
        proc = spawn_replica(root, "lm", coordinator=coord.address,
                             version="2", ready_timeout_s=c[
                                 "ready_timeout_s"], device=device.type,
                             **kw)
        spawn_s = time.perf_counter() - t0
        rset = ReplicaSet(coord.address, "lm", refresh_s=0.05)
        router = FleetRouter()
        router.attach_replicas("lm", rset)

        def backends():
            rset.refresh(force=True)
            return sorted(t for t, _, _ in rset.backends())

        _wait(lambda: len(backends()) == 2, 60, "two replicas",
              every=0.05)
        rec.start("d")
        flood = [router.submit("lm", reqs[i][0], n_tok, **reqs[i][1])
                 for i in idx]
        on_proc = [s for s in flood if s.replica == proc.token]
        fails.check(bool(on_proc), "fleet (d): no stream went to the "
                                   "spawned replica")
        _wait(lambda: any(s.tokens for s in on_proc), 300,
              "the spawned replica's first reply chunk")
        t_kill = time.perf_counter()
        proc.kill()
        got = _results(flood)
        _wait(lambda: backends() == [worker.token]
              and set(rset._meta) == {worker.token}, 60,
              "the replica set's convergence to the survivor", every=0.05)
        converged_s = time.perf_counter() - t_kill
        later = router.submit("lm", reqs[0][0], n_tok)
        later_t = _results([later])[0]
        rec.stop()
    finally:
        if rset is not None:
            rset.close()
        if proc is not None:
            proc.stop()
        if worker is not None:
            worker.stop()
        coord.stop()
    dropped = [i for i, (t, e) in enumerate(got) if e is not None
               or len(t) != n_tok]
    fails.check(not dropped, f"fleet (d): dropped or short streams "
                             f"{dropped}: {[got[i][1] for i in dropped]}")
    migrations = sum(s.migrations for s in flood)
    fails.check(migrations > 0, "fleet (d): no stream migrated")
    fails.check(later.replica == worker.token and later_t[1] is None,
                f"fleet (d): the later request went to {later.replica} "
                f"({later_t[1]})")
    hold = held([(i, 2, t) for i, (t, _) in zip(idx + [0], got + [later_t])
                 if t is not None], "(d)")
    return dict(spawn_to_ready_s=spawn_s, kill_to_converged_s=converged_s,
                streams=len(flood), on_spawned=len(on_proc),
                migrations=migrations, dropped=len(dropped), hold=hold)


def _fleet_route(device, fails, cfg, c, path, router, rec):
    """(e): a ServingRoute over an in-process transport restores lm v2's
    zip on `device` at its first message and answers `output()` through
    the router's output backend, within OUTPUT_ATOL of the CPU's
    `output()` of the same zip."""
    from deeplearning4j_tpu_torch.streaming import (
        LocalQueueTransport, NDArrayConsumer, NDArrayPublisher, ServingRoute)
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    rng = np.random.default_rng(21)
    xs = [rng.integers(0, cfg["vocab"], (c["route_B"], c["route_T"]))
          for _ in range(2)]
    tr = LocalQueueTransport()
    pub = NDArrayPublisher(tr, "fleet.in")
    for x in xs:
        pub.publish(x)
    route = ServingRoute(tr, "fleet.in", "fleet.out", model_uri=str(path),
                         router=router, model_name="lm-route",
                         device=device)
    rec.start("e")
    t0 = time.perf_counter()
    served = route.run(max_messages=len(xs), timeout=5.0)
    _sync(device)
    route_s = time.perf_counter() - t0
    rec.stop()
    con = NDArrayConsumer(tr, "fleet.out")
    outs = [np.asarray(con.consume(timeout=5)) for _ in range(served)]
    cpu = ModelSerializer.restore_model(path, device="cpu")
    errs = [float(np.abs(o - cpu.output(x).numpy()).max())
            for o, x in zip(outs, xs)]
    fails.check(served == len(xs) and max(errs) <= OUTPUT_ATOL,
                f"fleet (e): {served} of {len(xs)} replies, output() card "
                f"vs CPU max abs err {errs} (tol {OUTPUT_ATOL})")
    return dict(served=served, shape=list(outs[0].shape),
                max_abs_err=max(errs), seconds=route_s)


def phase_fleet(device, report, fails, small=False):
    """Phase 20 on `device` (see the module docstring, 20 (a)-(e)): the
    serving fleet on the smoke LM. `small` (the CPU rehearsal) shrinks
    the LM and the traffic, and spawns the replica on the CPU. Returns
    the phase's kernel launches, the sum of its parts'; each part's are
    in the report's `launches_by_part`."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.serving import (
        FleetRouter, FleetServer, ModelRegistry)
    c = FLEET_SMALL if small else FLEET
    cfg = c["cfg"] or LM
    t_start = time.perf_counter()
    out = dict(config=dict(cfg, **_fleet_server_kw(cfg, c),
                           fit=[c["fit_B"], cfg["max_len"] - 1],
                           burst=[c["greedy"], c["sampled"], c["n_tok"]]))
    rec, parts = _PartLaunches(), {}
    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="fleet_registry_", dir=OUT_DIR)
    fleet = None
    try:
        t0 = time.perf_counter()
        out["a"] = _fleet_publish(device, fails, cfg, c, root, rec)
        parts["a"] = time.perf_counter() - t0
        # the references, outside every part: each version's net on the
        # card, restored from its zip as the fleet restores it
        t0 = time.perf_counter()
        reg = ModelRegistry(root)
        nets = {v: reg.resolve("lm", v, device=device)[0] for v in (1, 2)}
        reqs = _fleet_requests(cfg, c)
        refs, eps, cpus = _fleet_refs(cfg, c, nets, reqs)
        parts["references"] = time.perf_counter() - t0

        def held(streams, what):
            return _fleet_hold(fails, what, cfg, nets, cpus, eps, reqs,
                               refs, streams)

        # retention keeps one version: the swap's unpin collects v1
        fleet = FleetServer(ModelRegistry(root, keep_last=1), device=device)
        router = FleetRouter(fleet)
        t0 = time.perf_counter()
        out["b"] = _fleet_swap(fails, cfg, c, fleet, router, reqs, held,
                               rec)
        freg = fleet.registry
        out["b"]["pinned"] = sorted(freg.pinned())
        out["b"]["versions_left"] = freg.versions("lm")
        fails.check(freg.pinned() == {("lm", 2)}
                    and freg.versions("lm") == [2],
                    f"fleet (b): pins {freg.pinned()}, versions left "
                    f"{freg.versions('lm')}: v1's pin must be released and "
                    f"retention must collect it")
        parts["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["c"] = _fleet_scale(fails, cfg, c, fleet, router, reqs, held,
                                rec)
        parts["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["d"] = _fleet_replicas(device, fails, cfg, c, root, nets[2],
                                   reqs, held, rec)
        parts["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["e"] = _fleet_route(device, fails, cfg, c,
                                freg.path("lm", 2), router, rec)
        parts["e"] = time.perf_counter() - t0
    finally:
        if fleet is not None:
            fleet.stop()
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: sum(p.get(k, 0) for p in rec.by_part.values())
                for k in KERNEL_META}
    if device.type == "cuda":
        for part, kernels in FLEET_KERNELS.items():
            _launched(fails, f"fleet part {part}", rec.by_part.get(part, {}),
                      kernels)
    out["part_seconds"] = parts
    out["launches_by_part"] = rec.by_part
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["seconds"] = time.perf_counter() - t_start
    report["fleet"] = out
    _print_fleet(out)
    return launches


def _print_fleet(out):
    a, b, cc, d, e = (out[k] for k in "abcde")
    print(f"[fleet] (a) {a['steps']} fit steps in {a['fit_s']:.2f} s, "
          f"published v{a['versions']} at steps {a['published_steps']}, "
          f"zips ({a['zip_mb']:.2f} MB) bit-equal to the card's params "
          f"{a['bit_equal']}", flush=True)
    print(f"[fleet] (b) deploy {b['deploy_s']:.2f} s, swap "
          f"{_fmt_s(b['swap_s'])} s (flip {b['flip_after_s']:.2f} s in), "
          f"{b['streams']} streams ({b['v1_streams']} v1, {b['v2_streams']} "
          f"v2), dropped {b['dropped']}; TTFT p50/p99 s before the swap "
          f"{b['ttft_before_p50_p99_s']}, after the flip "
          f"{b['ttft_after_flip_p50_p99_s']} (submitted inside the swap: "
          f"{b['after_submitted_before_swap_end']}); held {b['hold']}; "
          f"pins {b['pinned']}, versions left {b['versions_left']}",
          flush=True)
    print(f"[fleet] (c) decision {cc['decision']}; {cc['streams']} streams, "
          f"dropped {cc['dropped']}, {cc['scale_s']:.2f} s to the scaled "
          f"server; held {cc['hold']}", flush=True)
    print(f"[fleet] (d) spawn-to-ready {d['spawn_to_ready_s']:.2f} s, "
          f"kill-to-converged {d['kill_to_converged_s']:.2f} s, "
          f"{d['streams']} streams ({d['on_spawned']} on the spawned "
          f"replica), {d['migrations']} migrations, dropped {d['dropped']}; "
          f"held {d['hold']}", flush=True)
    print(f"[fleet] (e) route: {e['served']} replies of {e['shape']}, "
          f"max abs err {e['max_abs_err']:.3g} against the CPU, "
          f"{e['seconds']:.2f} s", flush=True)
    print(f"[fleet] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 1) for k, v in out['part_seconds'].items()} }), "
          f"launches by part {out['launches_by_part']}", flush=True)


# the base trains `pretrain` steps on the base task (shift 1, as
# `scripts/tenant_loadtest.py`'s base does) before it is published; its
# head is unscaled, so the held-out loss starts near uniform's. A and B
# learn shifts 2 and 3; C fine-tunes the base task, whose held-out loss
# its shuffled labels (uniform over the vocabulary) can push up: a model
# worse than uniform on its task would improve on any labels, and no
# drift gate could see the drift
TENANCY = dict(cfg=None, B=8, steps=6, publish_every=3, ckpt_every=3,
               rank=4, alpha=8.0, lr=1e-3, pretrain=10, head=1.0,
               shifts=(2, 3, 1), drift=(3, 3, 9), heldout=8, band=0.02,
               resume_at=3,
               kill_after=4, n_slots=8, burst=8, after=4, n_tok=32,
               lens=(16, 64), equal_n=2, equal_len=16)
TENANCY_SMALL = dict(TENANCY, cfg=dict(LM, d_model=64, n_heads=4,
                                       n_layers=2, max_len=128),
                     B=2, rank=2, head=4.0, heldout=2, n_slots=4, burst=4,
                     after=2,
                     n_tok=16, lens=(3, 24), equal_len=8)
TENANTS = ("A", "B", "C")
# the kernels each part of phase 21 launches on the card: (a)-(c) train
# adapters (flash forward and backward, both LayerNorms, the factors'
# fused Adam); (d) serves greedy requests (LayerNorm; prefill attends
# through the KV-cache path, not flash)
_ADAPTER_TRAIN_KERNELS = ("layer_norm", "residual_layer_norm",
                          "flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv", "fused_adam")
TENANCY_KERNELS = {"a": _ADAPTER_TRAIN_KERNELS,
                   "b": _ADAPTER_TRAIN_KERNELS,
                   "c": _ADAPTER_TRAIN_KERNELS,
                   "d": ("layer_norm",)}
TENANCY_PARAMS_SEED, TENANCY_CYCLE_SEED, TENANCY_PROMPT_SEED = 2121, 21, 210
HALF_BASE = 0.5    # (d): a tenant may add at most half a base copy


def tenant_records(cfg, n, shift, seed, shuffled=False, period=64):
    """n records [2, T] (T = max_len - 1) of a task: windows of one
    seeded period-`period` token cycle (`lm_corpus`'s) at seeded starts,
    row 0 the input ids, row 1 the ids `shift` places ahead in the cycle
    (each tenant learns its own shift, as `scripts/tenant_loadtest.py`'s
    do); `shuffled` replaces row 1 by seeded random ids over the
    vocabulary (the drift)."""
    V, T = cfg["vocab"], cfg["max_len"] - 1
    cycle = np.random.default_rng(TENANCY_CYCLE_SEED).choice(
        V, period, replace=False)
    rng = np.random.default_rng(seed)
    idx = (rng.integers(0, period, n)[:, None] + np.arange(T)) % period
    y = (rng.integers(0, V, (n, T)) if shuffled
         else cycle[(idx + shift) % period])
    return np.stack([cycle[idx], y], axis=1).astype(np.int32)


def _tenant_stream(cfg, transport, topic, records, B):
    import functools

    from deeplearning4j_tpu_torch.online import (
        StreamingDataSetIterator, lm_example)
    from deeplearning4j_tpu_torch.streaming import serialize_ndarray
    for r in records:
        transport.send(topic, serialize_ndarray(r))
    return StreamingDataSetIterator(
        transport, topic, batch_size=B,
        record_to_example=functools.partial(lm_example,
                                            vocab_size=cfg["vocab"]),
        watermark_timeout_s=5.0, poll_s=0.02)


def _tenant_records_of(cfg, c, i):
    """Tenant i's stream: `steps` clean batches, and for the last tenant
    (C) the drift segment: `drift` = (clean, shuffled, clean) batches."""
    shift, B = c["shifts"][i], c["B"]
    if i < len(TENANTS) - 1:
        return tenant_records(cfg, c["steps"] * B, shift, 100 + i)
    n0, n1, n2 = (k * B for k in c["drift"])
    return np.concatenate([
        tenant_records(cfg, n0, shift, 100 + i),
        tenant_records(cfg, n1, shift, 200 + i, shuffled=True),
        tenant_records(cfg, n2, shift, 300 + i)])


def _steps_listener():
    """A training listener keeping each step's loss and a copy of the
    attached adapter's factors (on the card), by global step."""
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.tenancy import lora

    class Steps(TrainingListener):
        def __init__(self):
            self.losses, self.factors = {}, {}

        def iteration_done(self, model, iteration, epoch, score, **info):
            self.losses[iteration] = float(score)
            self.factors[iteration + 1] = lora.extract_adapter(model)

    return Steps()


def _tenant_train(device, fails, cfg, c, i, net, reg, transport, root,
                  rec, part):
    """One tenant's online adapter training on the shared base `net`
    (parts (a) and (b)): a fresh rank-`rank` adapter attached frozen, an
    OnlineTrainer over the tenant's stream with an AdapterPublishListener
    every `publish_every` steps and a CheckpointListener every
    `ckpt_every` (with the cursor); the last tenant's run has a
    loss-band DriftGate on held-out clean records gating the publishes.
    Returns the run's record; the adapter is stripped after."""
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.online import (
        DriftGate, OnlineTrainer, lm_example)
    from deeplearning4j_tpu_torch.tenancy import lora
    t, B = TENANTS[i], c["B"]
    records = _tenant_records_of(cfg, c, i)
    steps = len(records) // B
    gate = None
    if t == TENANTS[-1]:
        held = tenant_records(cfg, c["heldout"], c["shifts"][i], 400 + i)
        xy = [lm_example(r, vocab_size=cfg["vocab"]) for r in held]
        gate = DriftGate(DataSet(np.stack([a for a, _ in xy]),
                                 np.stack([b for _, b in xy])),
                         frequency=1, band=c["band"], metric="loss",
                         tag=f"tenant-{t}", printer=lambda s: None)
    listener = reg.adapter_publish_listener(
        "lm", t, base_version=1, rank=c["rank"], alpha=c["alpha"],
        frequency=c["publish_every"],
        gate=None if gate is None else gate.allow_publish)
    lora.attach_adapter(net, lora.init_adapter(net, rank=c["rank"],
                                               seed=100 + i),
                        rank=c["rank"], alpha=c["alpha"], frozen=True)
    seen = _steps_listener()
    it = _tenant_stream(cfg, transport, f"tenant-{t}", records, B)
    trainer = OnlineTrainer(
        net, it, checkpoint_dir=os.path.join(root, f"ckpt-{t}"),
        checkpoint_frequency=c["ckpt_every"], drift_gate=gate,
        listeners=[seen, listener])
    start = net.iteration_count
    rec.start(part)
    t0 = time.perf_counter()
    summary = trainer.run(max_steps=steps)
    _sync(device)
    fit_s = time.perf_counter() - t0
    fused = K.LAUNCHES["fused_adam"]
    rec.stop()
    lora.strip_adapter(net)
    out = dict(tenant=t, steps=summary["iterations"], fit_s=fit_s,
               start_iteration=start,
               losses=[seen.losses[k] for k in sorted(seen.losses)],
               versions=list(listener.published_versions),
               published_steps=list(listener.published_steps),
               gated_skips=listener.gated_skips,
               cursor=summary.get("cursor"))
    # the zips restored on the CPU against the card's factors at their
    # publish steps, bit for bit
    equal, nbytes = {}, {}
    for v, step in zip(listener.published_versions,
                       listener.published_steps):
        back, meta, _ = reg.resolve_adapter("lm", t, v)
        card = seen.factors[step]
        equal[v] = (meta["step"] == step and back.keys() == card.keys()
                    and all(back[lk].keys() == card[lk].keys()
                            and all(_equal_on_cpu(back[lk][pk][s],
                                                card[lk][pk][s])
                                    for pk in card[lk] for s in "BA")
                            for lk in card))
        nbytes[v] = os.path.getsize(reg.adapter_path("lm", t, v))
    out.update(bit_equal=equal, zip_bytes=nbytes,
               factor_bytes=lora.adapter_bytes(seen.factors[start + steps]),
               final=seen.factors[start + steps])
    fails.check(out["steps"] == steps and all(equal.values())
                and len(equal) >= 2,
                f"tenancy ({part}) {t}: {out['steps']} of {steps} steps, "
                f"publishes {listener.published_versions} at "
                f"{listener.published_steps}, zips against the card's "
                f"factors {equal}")
    if device.type == "cuda":
        # the factors' update is one fused-Adam launch a step (50 leaves
        # at rank 4 on the 4-block LM, one launch of up to 96)
        fails.check(fused == steps, f"tenancy ({part}) {t}: {fused} "
                                    f"fused-Adam launches in {steps} steps")
    out["fused_adam_launches"] = fused
    if gate is not None:
        out["gate"] = dict(trips=gate.trips, paused=gate.paused,
                           best=gate.best_score,
                           history=[(int(i_), float(s), bool(p))
                                    for i_, s, p in gate.history])
    return out


def _equal_on_cpu(a, b):
    """Two tensors bit for bit, wherever each lives."""
    import torch
    return bool(torch.equal(a.detach().cpu(), b.detach().cpu()))


def _tenancy_resume(device, fails, cfg, c, reg, root, ref, rec):
    """(c): tenant A's run again on a fresh copy of the base (v1 from
    the registry), checkpointed every `ckpt_every` steps and stopped
    after `kill_after` (past its last checkpoint, as a kill leaves it);
    `OnlineTrainer.resume` builds the net from the newest checkpoint
    (the adapter attached again) and seeks a fresh stream to its cursor;
    the resumed steps' losses and the final factors must equal (a)'s
    uninterrupted run bit for bit."""
    from deeplearning4j_tpu_torch.online import OnlineTrainer
    from deeplearning4j_tpu_torch.streaming import LocalLogTransport
    from deeplearning4j_tpu_torch.tenancy import lora
    B, steps = c["B"], c["steps"]
    records = _tenant_records_of(cfg, c, 0)
    ckpt = os.path.join(root, "ckpt-resume")
    net, _ = reg.resolve("lm", 1, device=device)
    lora.attach_adapter(net, lora.init_adapter(net, rank=c["rank"],
                                               seed=100),
                        rank=c["rank"], alpha=c["alpha"], frozen=True)
    rec.start("c")
    t0 = time.perf_counter()
    OnlineTrainer(net, _tenant_stream(cfg, LocalLogTransport(), "A",
                                      records, B),
                  checkpoint_dir=ckpt, checkpoint_frequency=c["ckpt_every"],
                  checkpoint_at_fit_end=False).run(max_steps=c["kill_after"])
    del net                       # the kill: only the checkpoint survives
    it = _tenant_stream(cfg, LocalLogTransport(), "A", records, B)
    t1 = time.perf_counter()
    tr = OnlineTrainer.resume(ckpt, it, device=device)
    resume_s = time.perf_counter() - t1
    at, cursor = tr.net.iteration_count, dict(it.cursor())
    seen = _steps_listener()
    tr.extra_listeners.append(seen)
    tr.run(max_steps=steps - at)
    _sync(device)
    total_s = time.perf_counter() - t0
    rec.stop()
    got = [seen.losses[k] for k in sorted(seen.losses)]
    want = ref["losses"][at:]
    final = lora.extract_adapter(tr.net)
    same = all(_equal_on_cpu(final[lk][pk][s], ref["final"][lk][pk][s])
               for lk in ref["final"] for pk in ref["final"][lk]
               for s in "BA")
    fails.check(at == c["resume_at"] and cursor["batch"] == at
                and got == want and same
                and tr.net.iteration_count == steps,
                f"tenancy (c): resumed at {at} (cursor {cursor}), losses "
                f"{got} against {want}, factors bit-equal {same}")
    return dict(resumed_at=at, cursor=cursor, losses=got, want=want,
                factors_bit_equal=same, resume_s=resume_s,
                seconds=total_s)


def _tenancy_requests(cfg, c):
    rng = np.random.default_rng(TENANCY_PROMPT_SEED)
    lo, hi = c["lens"]
    return [(rng.integers(0, cfg["vocab"], int(k)), {})
            for k in rng.integers(lo, hi + 1, c["burst"])]


def _tenancy_refs(cfg, c, base, reg, reqs):
    """Outside every part: each (tenant, adapter version)'s composed view
    of the training base (bit-identical to the fleet's base, checked in
    (a)), its single-server streams of the burst and its greedy margin;
    the same streams by `attach_adapter` + `generate` against the
    composed view's `generate`; the base's own stream."""
    from deeplearning4j_tpu_torch.nd import quant
    from deeplearning4j_tpu_torch.tenancy import lora
    from deeplearning4j_tpu_torch.tenancy.fleet import _TenantNetView
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    views, refs, eps, composed_eq, differs = {}, {}, {}, {}, {}
    greedy = [p for p, _ in reqs]
    L = min(c["equal_len"], *(len(p) for p in greedy[:c["equal_n"]]))
    short = np.stack([p[:L] for p in greedy[:c["equal_n"]]])
    base_stream = generate(base, short, c["n_tok"], temperature=0)
    for t in TENANTS:
        for v in (1, 2):
            ad, meta, _ = reg.resolve_adapter("lm", t, v)
            tree = lora.compose_serving_tree(
                base, quant.serving_params(base, None), ad,
                rank=int(meta["rank"]), alpha=float(meta["alpha"]))
            view = _TenantNetView(base, lambda _m, tree=tree: tree)
            views[(t, v)] = view
            refs[(t, v)] = _serve(view, reqs, c["n_tok"], None,
                                  n_slots=c["n_slots"])[0]
            eps[(t, v)] = _wide_vs_single(view, greedy[:c["n_slots"]])
        via_view = generate(views[(t, 2)], short, c["n_tok"], temperature=0)
        ad, meta, _ = reg.resolve_adapter("lm", t, 2)
        lora.attach_adapter(base, ad, rank=int(meta["rank"]),
                            alpha=float(meta["alpha"]))
        via_attach = generate(base, short, c["n_tok"], temperature=0)
        lora.strip_adapter(base)
        composed_eq[t] = bool(np.array_equal(via_view, via_attach))
        diff = np.flatnonzero((via_view != base_stream).any(axis=0))
        differs[t] = None if not diff.size else int(diff[0])
    return views, refs, eps, composed_eq, differs


def _pool_bytes(server):
    return sum(k.numel() * k.element_size() + v.numel() * v.element_size()
               for k, v in server.engine.pool.kv)


def _tenancy_fleet(device, fails, cfg, c, reg, base_zip, views, refs, eps,
                   reqs, rec):
    """(d): a TenantFleet over lm v1 deploys A, B and C at adapter v1
    (8 slots, block_len 16, each and each successor warmed on the
    burst's buckets only)
    behind a FleetRouter; a burst of `burst` greedy requests a tenant;
    each tenant swaps to adapter v2 in its own thread once its first
    token is out, then `after` more requests past its flip. Every stream
    is held to its (tenant, version)'s single-server reference; one base
    copy; memory per added tenant."""
    import threading

    import torch

    from deeplearning4j_tpu_torch.serving import FleetRouter
    from deeplearning4j_tpu_torch.tenancy import TenantFleet, lora
    kw = _fleet_server_kw(cfg, c)
    on_card = device.type == "cuda"

    def allocated():
        """(tensor bytes, with cuBLAS's workspaces) on the card: each
        server's scheduler thread gets its own cuBLAS handle, whose
        workspace (32 MiB on this card) comes from the same allocator,
        so the tensors are counted with the (idle) servers' workspaces
        freed."""
        if not on_card:
            return None, None
        torch.cuda.synchronize()
        raw = torch.cuda.memory_allocated(device)
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        return torch.cuda.memory_allocated(device), raw

    fleet = TenantFleet(reg, "lm", device=device)
    rec.start("d")
    try:
        router = FleetRouter(fleet)
        mem, deploy_s, pool = [allocated()], {}, {}
        for t in TENANTS:
            t0 = time.perf_counter()
            fleet.deploy(t, version=1, warmup_prompt_len=c["lens"], **kw)
            pool[t] = _pool_bytes(fleet.server(t))
            deploy_s[t] = time.perf_counter() - t0
            mem.append(allocated())
        copies = fleet.shared_base_copies()
        burst = {t: [router.submit(t, p, c["n_tok"]) for p, _ in reqs]
                 for t in TENANTS}
        box, threads, flips = {}, {}, {}

        def swap(t):
            t0 = time.perf_counter()
            try:
                box[t] = fleet.swap(t, version=2)
            finally:
                box[f"{t}_s"] = time.perf_counter() - t0

        for t in TENANTS:
            _wait(lambda t=t: any(s.tokens for s in burst[t]), 120,
                  f"tenant {t}'s first token")
            threads[t] = threading.Thread(target=swap, args=(t,),
                                          name=f"swap-{t}", daemon=True)
            flips[t] = time.monotonic()
            threads[t].start()
        after = {}
        for t in TENANTS:
            _wait(lambda t=t: fleet.version(t) == 2
                  or not threads[t].is_alive(), 600, f"{t}'s flip")
            flips[t] = time.monotonic() - flips[t]
            after[t] = [router.submit(t, reqs[i][0], c["n_tok"])
                        for i in range(c["after"])]
        for th in threads.values():
            th.join(timeout=600)
        got = {t: _results(burst[t] + after[t]) for t in TENANTS}
        copies_after = fleet.shared_base_copies()
        rec.stop()
    finally:
        fleet.stop()
    out = dict(deploy_s=deploy_s, shared_base_copies=[copies, copies_after],
               memory_allocated=[m for m, _ in mem],
               memory_with_workspaces=[r for _, r in mem], per_tenant={})
    streams = []
    for t in TENANTS:
        both = burst[t] + after[t]
        dropped = [i for i, (tok, e) in enumerate(got[t]) if e is not None
                   or len(tok) != c["n_tok"]]
        tags = [s.version for s in both]
        idx = list(range(len(reqs))) + list(range(c["after"]))
        streams += [(i, (t, s.version), tok) for i, s, (tok, _) in
                    zip(idx, both, got[t]) if tok is not None]
        fails.check(box.get(t) == 2 and not dropped
                    and set(tags) <= {1, 2}
                    and all(s.version == 2 for s in after[t]),
                    f"tenancy (d) {t}: swap {box.get(t)}, dropped {dropped}, "
                    f"tags {tags}")
        out["per_tenant"][t] = dict(
            swap_s=box.get(f"{t}_s"), flip_after_s=flips[t],
            streams=len(both), dropped=len(dropped),
            v1_streams=tags.count(1), v2_streams=tags.count(2),
            ttft_p50_p99_s=_pct([s.t_first - s.t_submit for s in both]),
            ttft_after_flip_p50_p99_s=_pct([s.t_first - s.t_submit
                                            for s in after[t]]))
    out["hold"] = _fleet_hold(fails, "(d)", cfg, views, {}, eps, reqs, refs,
                              streams)
    fails.check(copies == copies_after == 1,
                f"tenancy (d): shared_base_copies {copies}, "
                f"{copies_after} after the swaps")
    out["pool_bytes"] = pool
    if on_card:
        factors = lora.adapter_bytes(reg.resolve_adapter("lm", "A", 1)[0])
        grow = [b[0] - a[0] for a, b in zip(mem, mem[1:])]
        # the tenant's tensors and its thread's cuBLAS workspace (the
        # reading before was taken with every workspace freed)
        out["growth_with_workspaces"] = [b[1] - a[0]
                                         for a, b in zip(mem, mem[1:])]
        limit = [pool[t] + factors + HALF_BASE * base_zip for t in TENANTS]
        out.update(memory_growth=grow, memory_limit=limit)
        fails.check(all(g <= m for g, m in zip(grow, limit)),
                    f"tenancy (d): memory per added tenant {grow} bytes, "
                    f"limits {limit} (pool {pool}, factors {factors}, "
                    f"half a base {HALF_BASE * base_zip:.0f})")
    return out


def phase_tenancy(device, report, fails, small=False):
    """Phase 21 on `device` (see the module docstring, 21 (a)-(d)):
    multi-tenant LoRA serving and online training on the smoke LM.
    `small` (the CPU rehearsal) shrinks the LM and the traffic. Returns
    the phase's kernel launches, the sum of its parts'; each part's are
    in the report's `launches_by_part`."""
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.streaming import LocalLogTransport
    c = TENANCY_SMALL if small else TENANCY
    cfg = c["cfg"] or LM
    t_start = time.perf_counter()
    out = dict(config=dict(cfg, **_fleet_server_kw(cfg, c), rank=c["rank"],
                           alpha=c["alpha"], fit=[c["B"], cfg["max_len"] - 1],
                           burst=[c["burst"], c["after"], c["n_tok"]]))
    rec, parts = _PartLaunches(), {}
    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="tenancy_registry_", dir=OUT_DIR)
    try:
        from deeplearning4j_tpu_torch.online import lm_example
        base = build_lm(cfg, device, random_lm_params(
            cfg, seed=TENANCY_PARAMS_SEED, head_scale=c["head"]), lr=c["lr"])
        t0 = time.perf_counter()
        xy = [lm_example(r, vocab_size=cfg["vocab"]) for r in
              tenant_records(cfg, c["pretrain"] * c["B"], 1, 7)]
        base.fit(np.stack([x for x, _ in xy]), np.stack([y for _, y in xy]),
                 batch_size=c["B"], shuffle=False)
        base.iteration_count = base.epoch_count = 0
        parts["pretrain"] = time.perf_counter() - t0
        out["pretrain_loss"] = float(base.score_value)
        reg = ModelRegistry(os.path.join(root, "registry"), keep_last=8)
        assert reg.publish("lm", base) == 1
        base_zip = os.path.getsize(reg.path("lm", 1))
        before = {k: v.detach().clone()
                  for k, v in base.param_table().items()}
        transport = LocalLogTransport()
        runs = {}
        for i, t in enumerate(TENANTS):
            part = "b" if t == TENANTS[-1] else "a"
            t0 = time.perf_counter()
            runs[t] = _tenant_train(device, fails, cfg, c, i, base, reg,
                                    transport, root, rec, part)
            parts[part] = parts.get(part, 0.0) + time.perf_counter() - t0
        after = base.param_table()
        same = all(torch.equal(before[k], after[k]) for k in before)
        fractions = {t: max(r["zip_bytes"].values()) / base_zip
                     for t, r in runs.items()}
        fails.check(same, "tenancy (a): the base's params moved while the "
                          "tenants trained their adapters")
        fails.check(all(f < 0.05 for f in fractions.values()),
                    f"tenancy (a): adapter zip / base zip {fractions}")
        g = runs[TENANTS[-1]]
        gated = g["gated_skips"]
        tripped = [i for i, _, p in g["gate"]["history"] if p]
        published_after_trip = [s for s in g["published_steps"]
                                if tripped and s > tripped[0] + 1]
        fails.check(g["gate"]["trips"] >= 1 and gated >= 1
                    and bool(published_after_trip)
                    and not g["gate"]["paused"],
                    f"tenancy (b): drift gate trips {g['gate']['trips']}, "
                    f"gated publishes {gated}, published at "
                    f"{g['published_steps']}, paused at the end "
                    f"{g['gate']['paused']}, history {g['gate']['history']}")
        out["a"] = {t: {k: v for k, v in r.items() if k != "final"}
                    for t, r in runs.items()}
        out["a"]["base_bit_identical"] = same
        out["a"]["zip_fraction"] = fractions
        out["a"]["base_zip_bytes"] = base_zip
        t0 = time.perf_counter()
        out["c"] = _tenancy_resume(device, fails, cfg, c, reg, root,
                                   runs[TENANTS[0]], rec)
        parts["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reqs = _tenancy_requests(cfg, c)
        views, refs, eps, composed_eq, differs = _tenancy_refs(
            cfg, c, base, reg, reqs)
        parts["references"] = time.perf_counter() - t0
        fails.check(all(composed_eq.values()),
                    f"tenancy (d): attach_adapter + generate against the "
                    f"composed tree's generate {composed_eq}")
        fails.check(all(d is not None for d in differs.values()),
                    f"tenancy (d): first token where each tenant's v2 "
                    f"stream leaves the base's {differs}")
        del base
        t0 = time.perf_counter()
        out["d"] = _tenancy_fleet(device, fails, cfg, c, reg, base_zip,
                                  views, refs, eps, reqs, rec)
        out["d"].update(attach_equals_compose=composed_eq,
                        v2_leaves_base_at=differs)
        parts["d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: sum(p.get(k, 0) for p in rec.by_part.values())
                for k in KERNEL_META}
    if device.type == "cuda":
        for part, kernels in TENANCY_KERNELS.items():
            _launched(fails, f"tenancy part {part}",
                      rec.by_part.get(part, {}), kernels)
    out["part_seconds"] = parts
    out["launches_by_part"] = rec.by_part
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["seconds"] = time.perf_counter() - t_start
    report["tenancy"] = out
    _print_tenancy(out)
    return launches


def _print_tenancy(out):
    a, cc, d = out["a"], out["c"], out["d"]
    for t in TENANTS:
        r = a[t]
        gate = r.get("gate")
        print(f"[tenancy] {'(b)' if gate else '(a)'} tenant {t}: "
              f"{r['steps']} steps in {r['fit_s']:.2f} s, losses "
              f"{[round(x, 4) for x in r['losses']]}, adapter v"
              f"{r['versions']} at steps {r['published_steps']} "
              f"(zips {r['zip_bytes']} bytes, {a['zip_fraction'][t]:.4f} "
              f"of the base zip, bit-equal to the card {r['bit_equal']}), "
              f"gated {r['gated_skips']}, fused-Adam launches "
              f"{r['fused_adam_launches']}", flush=True)
        if gate:
            print(f"[tenancy] (b) drift gate: trips {gate['trips']}, best "
                  f"{gate['best']:.4f}, history (iteration, loss, paused) "
                  f"{[(i, round(s, 4), p) for i, s, p in gate['history']]}",
                  flush=True)
    print(f"[tenancy] (a) base bit-identical after every tenant trained: "
          f"{a['base_bit_identical']} (base zip {a['base_zip_bytes']} "
          f"bytes)", flush=True)
    print(f"[tenancy] (c) resumed at step {cc['resumed_at']} (cursor "
          f"{cc['cursor']}) in {cc['resume_s']:.2f} s: losses {cc['losses']}"
          f" against {cc['want']}, factors bit-equal "
          f"{cc['factors_bit_equal']}; {cc['seconds']:.2f} s", flush=True)
    print(f"[tenancy] (d) deploy s {_round(d['deploy_s'])}, "
          f"shared_base_copies {d['shared_base_copies']}, memory_allocated "
          f"{d['memory_allocated']} (growth {d.get('memory_growth')}, limit "
          f"{d.get('memory_limit')}; with cuBLAS's workspaces "
          f"{d.get('growth_with_workspaces')}); attach+generate == composed "
          f"{d['attach_equals_compose']}, v2 leaves the base's stream at "
          f"{d['v2_leaves_base_at']}", flush=True)
    for t, r in d["per_tenant"].items():
        print(f"[tenancy] (d) tenant {t}: swap {_fmt_s(r['swap_s'])} s "
              f"(flip {r['flip_after_s']:.3f} s in), {r['streams']} streams "
              f"({r['v1_streams']} v1, {r['v2_streams']} v2), dropped "
              f"{r['dropped']}; TTFT p50/p99 s {r['ttft_p50_p99_s']}, past "
              f"the flip {r['ttft_after_flip_p50_p99_s']}", flush=True)
    print(f"[tenancy] (d) held {d['hold']}", flush=True)
    print(f"[tenancy] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 1) for k, v in out['part_seconds'].items()} }), "
          f"launches by part {out['launches_by_part']}", flush=True)


# ------------------------------------------------------------ phase 22
# (a) the word2vec bench config (deeplearning4j_tpu/bench.py:801-845):
# a zipf corpus of 400 sentences x 250 tokens over 5000 words from
# default_rng(3); layer 128, window 5, negative 5, batch 4096, 32
# batches a fused group, one epoch
W2V = dict(vocab=5000, n_sent=400, sent_len=250, seed=3, sampler="choice",
           layer=128, window=5, negative=5, B=4096, k=32, top=50, top_n=10)
W2V_SMALL = dict(W2V, vocab=500, n_sent=40, sent_len=100, layer=32, B=256,
                 k=4, top=20)
# (b) the 100k-word vocab (bench.py:847-877): 800 x 500 tokens drawn by
# inverse CDF from default_rng(7), batch 8192, 16 batches a group
W2V_LARGE = dict(vocab=100_000, n_sent=800, sent_len=500, seed=7,
                 sampler="cdf", layer=128, window=5, negative=5, B=8192,
                 k=16)
W2V_LARGE_SMALL = dict(W2V_LARGE, vocab=5000, n_sent=40, sent_len=100,
                       layer=32, B=512, k=4)
GROUP_RTOL = 1e-5          # (a), (b): the first fused group's tables, card
#                            against CPU, of each table's largest |value|
SCATTER_ORDER_FACTOR = 4.0  # (a): the whole fit's card-CPU distance, at
#                            most this multiple of the CPU's distance to
#                            a twin that scatters each batch in another
#                            order (ROADMAP Hazards, ill-conditioned
#                            parity): atomics reorder the card's adds
NEAREST_OVERLAP = 0.9      # (a): top-10 words_nearest, card against CPU
EMBED_RTOL = 1e-3          # (c), (d): test-size fits, card against CPU,
#                            of each table's largest |value| (3-15 epochs
#                            at lr 0.05-0.25 amplify float32 rounding)
# (c), (d): tests/test_nlp.py's and tests/test_graph_lib.py's sizes
EMBED_MODES = ("cbow", "hs", "cbow_hs")
TOPIC_W2V = dict(layer_size=24, window_size=4, min_word_frequency=2,
                 learning_rate=0.05, epochs=3, batch_size=512, seed=7)
GRAPH_EMBED = dict(vector_size=16, window_size=4, walk_length=20,
                   walks_per_vertex=6, epochs=15, learning_rate=0.25,
                   batch_size=128, seed=11)
PACKAGED_QUERIES = 50      # (e): words_nearest of the first 50 words


def topic_corpus(n=400, seed=0):
    """Two-topic corpus (tests/test_nlp.py's `synthetic_corpus`): weather
    words co-occur, finance words co-occur, stop words sprinkled."""
    rng = np.random.default_rng(seed)
    weather = ["rain", "snow", "storm", "cloud", "wind", "sun"]
    finance = ["bank", "money", "stock", "market", "trade", "price"]
    shared = ["the", "a", "and", "of", "in"]
    sentences = []
    for _ in range(n):
        topic = weather if rng.random() < 0.5 else finance
        words = [topic[rng.integers(len(topic))] for _ in range(8)]
        for i in sorted(rng.integers(0, len(words), 2))[::-1]:
            words.insert(i, shared[rng.integers(len(shared))])
        sentences.append(" ".join(words))
    return sentences


def two_communities(graph_mod, n_per=8):
    """Two 8-cliques joined by one bridge edge, and each vertex's side."""
    g = graph_mod.Graph(2 * n_per)
    for base in (0, n_per):
        for i in range(n_per):
            for j in range(i + 1, n_per):
                g.add_edge(base + i, base + j, directed=False)
    g.add_edge(n_per - 1, n_per, directed=False)
    return g, [0] * n_per + [1] * n_per


def zipf_corpus(c):
    """The bench's corpus: (a) `rng.choice` with zipf probabilities,
    (b) inverse-CDF draws (`rng.choice` with p is O(V) a draw)."""
    rng = np.random.default_rng(c["seed"])
    probs = 1.0 / np.arange(1, c["vocab"] + 1)
    if c["sampler"] == "choice":
        probs /= probs.sum()
        return [[f"w{t}" for t in rng.choice(c["vocab"], c["sent_len"],
                                               p=probs)]
                for _ in range(c["n_sent"])]
    cdf = np.cumsum(probs / probs.sum())
    return [[f"w{t}" for t in np.searchsorted(cdf, rng.random(c["sent_len"]))]
            for _ in range(c["n_sent"])]


def _w2v_bench_model(c, device, vocab):
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    m = Word2Vec(layer_size=c["layer"], window_size=c["window"],
                 negative_sample=c["negative"], min_word_frequency=1,
                 epochs=1, batch_size=c["B"], device=device)
    m.conf.steps_per_flush = c["k"]
    m.vocab = vocab
    return m


class _StopFit(Exception):
    pass


class _FirstGroup:
    """Wraps a model's fused-group flush: after the first group, copies
    syn0 and syn1neg to the host (and, with `stop`, ends the fit)."""

    def __init__(self, model, stop=False):
        self.tables = None
        flush = model._flush_sg_neg_multi

        def first(c, x, lrs):
            loss = flush(c, x, lrs)
            if self.tables is None:
                self.tables = tuple(t.cpu().numpy().copy()
                                    for t in (model.syn0, model.syn1neg))
                if stop:
                    raise _StopFit()
            return loss

        model._flush_sg_neg_multi = first


class _ScatterOrderTwin:
    """Inside the context every skip-gram/neg step of the port feeds its
    batch's rows in a seeded random order: the same pairs, negatives and
    row counts, only the scatters' (and the loss sum's) order differs."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __enter__(self):
        import torch
        from deeplearning4j_tpu_torch.nlp import sequencevectors as sv
        self.sv, self.step = sv, sv._sg_neg_math

        def permuted(syn0, syn1neg, c, x, n, lr, trainable_from):
            p = torch.as_tensor(self.rng.permutation(c.shape[0]),
                                device=c.device)
            return self.step(syn0, syn1neg, c[p], x[p], n[p], lr,
                             trainable_from)

        sv._sg_neg_math = permuted
        return self

    def __exit__(self, *exc):
        self.sv._sg_neg_math = self.step


def _rel_dist(a, b):
    """max |a - b| over max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-30))


def _timed_w2v_fit(device, model, seqs):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(seqs)     # returns numpy tables: the fit's work is done
    return time.perf_counter() - t0


def _group_launches(device, model, seqs, total_words):
    """Kernel launches, device ms and busy share of one fused group
    (profiled on the card; None elsewhere)."""
    if device.type != "cuda":
        return None
    k = model.conf.steps_per_flush
    kind, c, x, lrs = next(iter(model._pair_work_items(
        seqs, None, total_words, k)))
    model._tables_to_device()
    model._trainable_from = 0
    try:
        prof = _profiled(lambda: model._flush_sg_neg_multi(c, x, lrs))
    finally:
        model._tables_to_host()
    return dict(kind=kind, batches=k, launches=prof["launches"],
                per_batch=prof["launches"] / k, device_ms=prof["device_ms"],
                wall_ms=prof["wall_ms"], busy_share=prof["busy_share"],
                groups_ms=prof["groups_ms"])


def _w2v_bench(device, fails, c, tag, keep=None):
    """(a): the bench config, card against CPU: the first fused group,
    the whole fit by the scatter-order twin, words_nearest; words/s of
    a warm fit on both. (b) (`tag` "b"): the first group only on the
    CPU, words/s and peak memory on the card. The warm fit's vectors go
    to `keep["vectors"]` when `keep` is a dict."""
    import torch

    from deeplearning4j_tpu_torch.nlp import VocabConstructor
    cpu = torch.device("cpu")
    out = dict(config={k: v for k, v in c.items()})
    t0 = time.perf_counter()
    seqs = zipf_corpus(c)
    vocab = VocabConstructor(min_word_frequency=1).build(seqs)
    words = sum(len(s) for s in seqs)
    out.update(words=words, vocab_words=vocab.num_words(),
               corpus_s=time.perf_counter() - t0)
    # each model's tables drawn before its timed fit (the draws `fit`
    # would make first), so a time covers the fit's own work
    card = _w2v_bench_model(c, device, vocab)
    card._init_tables()
    first_card = _FirstGroup(card)
    out["cold_fit_s"] = _timed_w2v_fit(device, card, seqs)
    out["table_bytes"] = int(card.syn0.nbytes + card.syn1neg.nbytes)
    cpu_m = _w2v_bench_model(c, cpu, vocab)
    cpu_m._init_tables()
    first_cpu = _FirstGroup(cpu_m, stop=(tag == "b"))
    try:
        out["cpu_fit_s"] = _timed_w2v_fit(cpu, cpu_m, seqs)
        out["cpu_words_per_s"] = words / out["cpu_fit_s"]
    except _StopFit:
        out["cpu_fit_s"] = None
    group = [_rel_dist(a, b) for a, b in zip(first_card.tables,
                                             first_cpu.tables)]
    out["first_group_rel"] = group
    fails.check(max(group) <= GROUP_RTOL,
                f"embeddings ({tag}): the first fused group's syn0/syn1neg "
                f"card against CPU {group} > {GROUP_RTOL} of the tables' "
                f"largest |value|")
    if tag == "a":
        with _ScatterOrderTwin(seed=1):
            twin = _w2v_bench_model(c, cpu, vocab).fit(seqs)
        d_card = max(_rel_dist(card.syn0, cpu_m.syn0),
                     _rel_dist(card.syn1neg, cpu_m.syn1neg))
        d_twin = max(_rel_dist(twin.syn0, cpu_m.syn0),
                     _rel_dist(twin.syn1neg, cpu_m.syn1neg))
        out.update(fit_rel_card=d_card, fit_rel_twin=d_twin)
        fails.check(d_card <= SCATTER_ORDER_FACTOR * d_twin,
                    f"embeddings (a): the whole fit, card against CPU "
                    f"{d_card:.3e} > {SCATTER_ORDER_FACTOR} x the CPU's "
                    f"scatter-order twin {d_twin:.3e}")
        words_top = [vocab.word_at_index(i) for i in range(c["top"])]
        share = float(np.mean([
            len(set(card.words_nearest(w, c["top_n"]))
                & set(cpu_m.words_nearest(w, c["top_n"]))) / c["top_n"]
            for w in words_top]))
        out["nearest_overlap"] = share
        fails.check(share >= NEAREST_OVERLAP,
                    f"embeddings (a): top-{c['top_n']} words_nearest of the "
                    f"{c['top']} most frequent words, card against CPU, "
                    f"overlap {share:.3f} < {NEAREST_OVERLAP}")
    out["cold_loss"] = card.last_loss
    card._init_tables()          # fresh tables: the timed fit, as bench's
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    out["warm_fit_s"] = _timed_w2v_fit(device, card, seqs)
    if keep is not None:   # phase 23 clusters, maps and serves them
        keep["vectors"] = np.array(card.syn0, np.float32)
    out["words_per_s"] = words / out["warm_fit_s"]
    out["etl"] = dict(card.etl_stats or {})
    out["loss"] = card.last_loss
    fails.check(np.isfinite(card.syn0).all() and np.isfinite(card.last_loss),
                f"embeddings ({tag}): non-finite tables or loss after the "
                f"warm fit")
    if device.type == "cuda":
        out["peak_allocated"] = int(torch.cuda.max_memory_allocated(device))
        out["allocated_before"] = int(base)
    out["group"] = _group_launches(device, card, seqs, words)
    return out


def _w2v_modes(device, fails):
    """(c): CBOW + NS, skip-gram + HS and CBOW + HS on the topic corpus,
    card against CPU; in-topic similarity beats cross-topic on the
    card."""
    import torch

    from deeplearning4j_tpu_torch.nlp import Word2Vec
    corpus = topic_corpus(400)
    out = {}
    for mode in EMBED_MODES:
        hs = mode in ("hs", "cbow_hs")
        kw = dict(TOPIC_W2V, negative_sample=0 if hs else 5,
                  use_hierarchic_softmax=hs,
                  cbow=mode in ("cbow", "cbow_hs"))
        t0 = time.perf_counter()
        card = Word2Vec(sentence_iterator=corpus, device=device, **kw).fit()
        t1 = time.perf_counter()
        cpu_m = Word2Vec(sentence_iterator=corpus, device=torch.device("cpu"),
                         **kw).fit()
        out_table = "syn1" if hs else "syn1neg"
        rel = [_rel_dist(card.syn0, cpu_m.syn0),
               _rel_dist(getattr(card, out_table), getattr(cpu_m, out_table))]
        in_topic = card.similarity("rain", "snow")
        cross = card.similarity("rain", "money")
        out[mode] = dict(rel=rel, in_topic=in_topic, cross=cross,
                         card_s=t1 - t0, cpu_s=time.perf_counter() - t1)
        fails.check(max(rel) <= EMBED_RTOL,
                    f"embeddings (c) {mode}: syn0/{out_table} card against "
                    f"CPU {rel} > {EMBED_RTOL}")
        fails.check(in_topic > cross, f"embeddings (c) {mode}: in-topic "
                                      f"{in_topic:.4f} <= cross {cross:.4f}")
    return out


def _embed_rest(device, fails):
    """(d): ParagraphVectors DM and DBOW with `infer_vector`, GloVe,
    DeepWalk and Node2Vec on the two-community graph, card against
    CPU."""
    import torch

    from deeplearning4j_tpu_torch import graph as G
    from deeplearning4j_tpu_torch.nlp import (
        Glove, LabelledDocument, ParagraphVectors)
    cpu = torch.device("cpu")
    out = {}

    def held(name, card, cpu_m, tables, extra=()):
        rel = [_rel_dist(getattr(card, t), getattr(cpu_m, t))
               for t in tables] + list(extra)
        out.setdefault(name, {})["rel"] = rel
        fails.check(max(rel) <= EMBED_RTOL,
                    f"embeddings (d) {name}: {tables} card against CPU "
                    f"{rel} > {EMBED_RTOL}")

    def cos(a, b):
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                     + 1e-9))

    corpus = topic_corpus(200)
    docs = [LabelledDocument(s, [f"DOC_{i}"]) for i, s in enumerate(corpus)]
    weather = [i for i, s in enumerate(corpus)
               if "rain" in s and "bank" not in s]
    finance = [i for i, s in enumerate(corpus)
               if "bank" in s and "rain" not in s]
    # tests/test_nlp.py's TestParagraphVectors: DBOW and DM at 3 epochs
    # (doc vectors), DBOW at 2 for infer_vector
    for name, dm, epochs in (("pv_dbow", False, 3), ("pv_dm", True, 3),
                             ("pv_infer", False, 2)):
        t0 = time.perf_counter()
        pair = [ParagraphVectors(documents=docs, layer_size=16,
                                 epochs=epochs, min_word_frequency=2, dm=dm,
                                 seed=3, device=d).fit() for d in (device, cpu)]
        card = pair[0]
        if name != "pv_infer":
            held(name, *pair, ("syn0", "syn1neg"))
            same = card.similarity_doc(f"DOC_{weather[0]}",
                                       f"DOC_{weather[1]}")
            diff = card.similarity_doc(f"DOC_{weather[0]}",
                                       f"DOC_{finance[0]}")
            out[name].update(same_doc=same, cross_doc=diff)
            fails.check(same > diff, f"embeddings (d) {name}: same-topic "
                                     f"doc similarity {same:.4f} <= "
                                     f"{diff:.4f}")
        else:
            inferred = [m.infer_vector("rain snow storm wind") for m in pair]
            held(name, *pair, ("syn0", "syn1neg"), [_rel_dist(*inferred)])
            rain = cos(inferred[0], card.get_word_vector("rain"))
            bank = cos(inferred[0], card.get_word_vector("bank"))
            out[name].update(infer_rain=rain, infer_bank=bank)
            fails.check(rain > bank, f"embeddings (d) {name}: the inferred "
                                     f"weather doc nearer bank {bank:.4f} "
                                     f"than rain {rain:.4f}")
        out[name]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seqs = [s.split() for s in topic_corpus(300)]
    pair = [Glove(layer_size=16, window=4, min_word_frequency=2, epochs=20,
                  learning_rate=0.05, seed=5, device=d).fit(seqs)
            for d in (device, cpu)]
    held("glove", *pair, ("syn0",))
    g_in, g_cross = (pair[0].similarity("rain", "snow"),
                     pair[0].similarity("rain", "money"))
    out["glove"].update(in_topic=g_in, cross=g_cross,
                        seconds=time.perf_counter() - t0)
    fails.check(g_in > g_cross, f"embeddings (d) glove: in-topic {g_in:.4f}"
                                f" <= cross {g_cross:.4f}")
    kw = GRAPH_EMBED
    for name in ("deepwalk", "node2vec"):
        t0 = time.perf_counter()
        pair = []
        for d in (device, cpu):
            g, labels = two_communities(G)
            m = (G.Node2Vec(p=1.0, q=4.0, device=d, **kw)
                 if name == "node2vec" else G.DeepWalk(device=d, **kw))
            m.fit_graph(g)
            pair.append(m)
        held(name, *pair, ("syn0", "syn1" if name == "deepwalk"
                           else "syn1neg"))
        vecs = np.stack([pair[0].get_vertex_vector(v)
                         for v in range(len(labels))])
        vecs = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        sims, lab = vecs @ vecs.T, np.array(labels)
        iu = np.triu_indices(len(labels), 1)
        same_side = (lab[:, None] == lab[None, :])[iu]
        score = float(sims[iu][same_side].mean()
                      - sims[iu][~same_side].mean())
        out[name].update(community_score=score,
                         seconds=time.perf_counter() - t0)
    # tests/test_graph_lib.py's bar: Node2Vec separates the communities,
    # at least as well as DeepWalk (less 0.05)
    n2v, dw = (out[n]["community_score"] for n in ("node2vec", "deepwalk"))
    fails.check(n2v > 0.5 and n2v >= dw - 0.05,
                f"embeddings (d): same- minus cross-community cosine, "
                f"Node2Vec {n2v:.4f}, DeepWalk {dw:.4f}")
    return out


def _packaged_vectors(device, fails):
    """(e): the packaged vectors read in place through the sha256 check,
    moved to the card: words_nearest equal to the CPU's; the binary and
    text formats written and read back bit-equal (text: to its six
    printed decimals)."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.nlp import WordVectorSerializer
    from deeplearning4j_tpu_torch.nlp.word2vec import load_packaged_word2vec
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card = load_packaged_word2vec(device=device)
    host = load_packaged_word2vec(device=cpu)
    words = card.vocab.words()
    queries = words[:PACKAGED_QUERIES]
    unequal = [w for w in queries
               if card.words_nearest(w, 10) != host.words_nearest(w, 10)]
    out = dict(words=len(words), vector_length=card.conf.vector_length,
               queries=len(queries), nearest_unequal=unequal)
    fails.check(card.device == device and not unequal,
                f"embeddings (e): packaged vectors' words_nearest on "
                f"{card.device} differ from the CPU's for {unequal}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        fb, ft = os.path.join(tmp, "v.bin"), os.path.join(tmp, "v.txt")
        WordVectorSerializer.write_binary(card, fb)
        WordVectorSerializer.write_text(card, ft)
        rb = WordVectorSerializer.read_binary(fb, device=cpu)
        rt = WordVectorSerializer.read_text(ft, device=cpu)
        printed = np.array([[float(f"{v:.6f}") for v in row]
                            for row in card.syn0], np.float32)
        out["binary_bytes"] = os.path.getsize(fb)
        out["text_bytes"] = os.path.getsize(ft)
    out["binary_bit_equal"] = bool(rb.vocab.words() == words
                                   and np.array_equal(rb.syn0, card.syn0))
    out["text_bit_equal"] = bool(rt.vocab.words() == words
                                 and np.array_equal(rt.syn0, printed))
    fails.check(out["binary_bit_equal"] and out["text_bit_equal"],
                f"embeddings (e): read back binary bit-equal "
                f"{out['binary_bit_equal']}, text bit-equal "
                f"{out['text_bit_equal']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_embeddings(device, report, fails, small=False, keep=None):
    """Phase 22 on `device` (see the module docstring, 22 (a)-(e)): the
    embedding engine and the graph library, card against the port's CPU
    path. `small` (the CPU rehearsal) shrinks (a)'s and (b)'s corpora;
    (c)-(e) run at their tests' sizes either way; (a)'s trained vectors
    go to `keep["vectors"]` when `keep` is a dict. Launches no
    hand-written kernel: returns {}."""
    t_start = time.perf_counter()
    out, parts = {}, {}
    for part, fn, args in (
            ("a", _w2v_bench, (W2V_SMALL if small else W2V, "a", keep)),
            ("b", _w2v_bench, (W2V_LARGE_SMALL if small else W2V_LARGE,
                               "b")),
            ("c", _w2v_modes, ()),
            ("d", _embed_rest, ()),
            ("e", _packaged_vectors, ())):
        t0 = time.perf_counter()
        out[part] = fn(device, fails, *args)
        parts[part] = time.perf_counter() - t0
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_start
    report["embeddings"] = out
    _print_embeddings(out)
    return {}


def _print_embeddings(out):
    for tag in ("a", "b"):
        r = out[tag]
        cfg = r["config"]
        g = r["group"] or {}
        print(f"[embeddings] ({tag}) {r['words']} words, vocab "
              f"{r['vocab_words']}, layer {cfg['layer']}, batch {cfg['B']} "
              f"x {cfg['k']} a group: words/s {r['words_per_s']:.1f} (warm "
              f"fit {r['warm_fit_s']:.3f} s; cold {r['cold_fit_s']:.3f} s; "
              f"CPU {_fmt_s(r.get('cpu_words_per_s'))} words/s), loss "
              f"{r['loss']:.4f}, etl {r['etl']}, tables {r['table_bytes']} bytes, peak allocated "
              f"{r.get('peak_allocated')}", flush=True)
        print(f"[embeddings] ({tag}) first group card vs CPU "
              f"{[f'{x:.2e}' for x in r['first_group_rel']]}; a group: "
              f"{g.get('launches')} launches ({g.get('per_batch')} a batch),"
              f" device ms {g.get('device_ms')}, wall ms {g.get('wall_ms')},"
              f" busy {g.get('busy_share')}", flush=True)
    a = out["a"]
    print(f"[embeddings] (a) whole fit card vs CPU {a['fit_rel_card']:.3e}, "
          f"scatter-order twin {a['fit_rel_twin']:.3e}; words_nearest "
          f"overlap {a['nearest_overlap']:.3f}", flush=True)
    for mode, r in out["c"].items():
        print(f"[embeddings] (c) {mode}: card vs CPU {r['rel']}, in-topic "
              f"{r['in_topic']:.4f} > cross {r['cross']:.4f}", flush=True)
    for name, r in out["d"].items():
        print(f"[embeddings] (d) {name}: card vs CPU "
              f"{[f'{x:.2e}' for x in r['rel']]}, "
              f"{ {k: round(v, 4) for k, v in r.items() if k != 'rel'} }",
              flush=True)
    e = out["e"]
    print(f"[embeddings] (e) packaged {e['words']} x {e['vector_length']}: "
          f"words_nearest of {e['queries']} equal on the card (unequal "
          f"{e['nearest_unequal']}), binary {e['binary_bytes']} bytes "
          f"bit-equal {e['binary_bit_equal']}, text {e['text_bytes']} "
          f"bytes bit-equal {e['text_bit_equal']}", flush=True)
    print(f"[embeddings] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 2) for k, v in out['part_seconds'].items()} })",
          flush=True)


# ----------------- phase 23: k-means, t-SNE, Viterbi, segmenters, kNN server
# (a), (b) (ii), (e): phase 22 (a)'s trained bench-config vectors (4829
# words x 128), handed over by `run` when phase 22 ran first, else
# trained once by `_bench_vectors`
KMEANS = dict(k=32, max_iterations=100, seed=0)
KMEANS_SMALL = dict(k=8, max_iterations=100, seed=0)
KMEANS_RTOL = 1e-5        # (a) centroids (of their largest |value|) and
#                           cost, card against CPU
KMEANS_PROFILE_STEPS = 5
KMEANS_TIE_RTOL = 1e-5    # (a) an assignment may differ only where its
#                           two squared distances differ by at most this
#                           share of |x|^2 + max |c|^2 (float32's
#                           x2 - 2 x.c + c2 cancels that much)
TSNE_STEPS = 20           # (b) (i): steps held card against CPU
TSNE_STEP_RTOL = 1e-4     # (b) (i): one step from the CPU's state, and
#                           the free runs' first TSNE_EXACT_STEPS, of
#                           the map's largest |value|
TSNE_EXACT_STEPS = 5
TSNE_TWIN_FACTOR = 10.0   # (b) (i): the free runs at step TSNE_STEPS,
#                           against the CPU's distance to a twin whose
#                           y0 moved by one float32 ulp (ROADMAP Hazards,
#                           ill-conditioned parity: the map is chaotic)
TSNE_KL_RTOL = 1e-5       # (b) (i): each step's KL, card against CPU
TSNE_BENCH_SMALL = dict(n_iter=100)
TSNE_NEIGHBOURS = 10      # (b) (ii): a word's nearest in the map and in
TSNE_CHANCE_FACTOR = 10.0  # 128-D (cosine) overlap by 10x chance
TSNE_PROFILE_STEPS = 5
VITERBI_CHAIN_SHAPE = (65536, 77)   # (c) T, S: the text LSTM's charset
VITERBI_LM_SHAPE = (8192, 512)      # (c) T, S: the smoke LM's vocab
SERVER_QUERIES = 8        # (e)
SERVER_K = 10
# (d) the corpora and fits of tests/test_nlp_{cjk,japanese,korean,
# annotation}.py
CJK_LEXICON = {
    "猫": 50, "狗": 50, "兔子": 30, "动物": 40, "宠物": 30,
    "吃": 60, "喜欢": 60, "鱼": 40, "肉": 40, "米饭": 30, "苹果": 30,
    "银行": 40, "股票": 40, "市场": 40, "价格": 30, "经济": 30,
    "上涨": 20, "下跌": 20, "投资": 25,
    "我": 80, "的": 100, "在": 60, "和": 60, "了": 60, "很": 40,
    "今天": 30, "可爱": 25, "跑": 20, "玩": 25, "公园": 20,
}
CJK_CORPUS = (["我的猫喜欢吃鱼", "狗在公园跑和玩", "兔子很可爱", "猫和狗很可爱",
               "我喜欢我的狗", "宠物猫吃鱼和肉", "兔子吃苹果", "狗喜欢吃肉",
               "可爱的猫在玩", "动物喜欢在公园玩", "股票价格上涨了",
               "银行和市场的经济", "投资股票的价格", "市场价格下跌了",
               "经济和银行的投资", "今天股票上涨", "银行投资市场",
               "价格在市场上涨"] * 6)
JA_CORPUS = ([
    "猫は魚を食べる", "犬は肉を食べる", "兎はりんごを食べる",
    "猫は公園で遊んだ", "犬は公園で遊んだ", "兎は庭で遊んだ",
    "猫は可愛い動物です", "犬は可愛い動物です", "兎は可愛い動物です",
    "猫は水を飲んだ", "犬は水を飲んだ", "猫は家で走った", "犬は家で走った",
    "銀行は株に投資する", "会社は株に投資する", "銀行は経済に投資する",
    "会社は経済に投資する", "株価が今日上がった", "価格が今日上がった",
    "株価が市場で下がった", "価格が市場で下がった", "銀行はお金を買った",
    "会社はお金を買った", "株価が市場で上がった", "価格が今日下がった"]
    * 6)
KO_CORPUS = ["고양이가 물고기를 먹었다", "고양이는 공원에서 놀았다",
             "고양이를 친구가 보았다"] * 4
ANNOTATION_CORPUS = ["the cat chased the mouse", "the dog chased the cat",
                     "banks move markets", "markets follow banks"] * 6


def _bench_vectors(device, small):
    """Phase 22 (a)'s vectors when phase 22 did not run: the bench
    config (W2V, or W2V_SMALL) trained once on `device`."""
    from deeplearning4j_tpu_torch.nlp import VocabConstructor
    c = W2V_SMALL if small else W2V
    seqs = zipf_corpus(c)
    vocab = VocabConstructor(min_word_frequency=1).build(seqs)
    m = _w2v_bench_model(c, device, vocab)
    m.fit(seqs)
    return np.array(m.syn0, np.float32)


def _kmeans(device, fails, vectors, c):
    """(a) k-means on the vectors, card against CPU: the init equal,
    assignments equal off counted near-ties, centroids and cost within
    KMEANS_RTOL, the iteration counts equal; ms and launches an
    iteration."""
    import torch
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering import kmeans as km
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    init = km.kmeans_pp_init(vectors, c["k"], c["seed"])
    init_s = time.perf_counter() - t0
    seen = []
    step = km._lloyd_step

    def first_centroids(points, centroids):
        # the centroids the first Lloyd step gets, and when it starts
        seen.append((centroids.cpu().numpy(), time.perf_counter()))
        km._lloyd_step = step
        return step(points, centroids)

    km._lloyd_step = first_centroids
    try:
        card = KMeansClustering(**c, device=device).apply_to(vectors)
        _sync(device)
        loop_s = time.perf_counter() - seen[0][1]
    finally:
        km._lloyd_step = step
    host = KMeansClustering(**c, device=cpu).apply_to(vectors)
    init_equal = bool(np.array_equal(seen[0][0], init))
    apart = np.flatnonzero(card.assignments != host.assignments)
    x = vectors.astype(np.float64)
    cen = host.centroids.astype(np.float64)
    x2, c2 = (x * x).sum(1), (cen * cen).sum(1)
    d2 = x2[:, None] - 2 * x @ cen.T + c2[None, :]
    scale = x2 + c2.max()
    ties = [int(i) for i in apart
            if abs(d2[i, card.assignments[i]] - d2[i, host.assignments[i]])
            <= KMEANS_TIE_RTOL * scale[i]]
    cen_rel = _rel_dist(card.centroids, host.centroids)
    cost_rel = abs(card.cost - host.cost) / abs(host.cost)
    fails.check(init_equal, "clustering (a): the k-means++ init on the card "
                            "differs from numpy's")
    fails.check(len(ties) == len(apart),
                f"clustering (a): assignments differ at {apart.tolist()}, "
                f"near-ties among them {ties}")
    fails.check(cen_rel <= KMEANS_RTOL and cost_rel <= KMEANS_RTOL
                and card.iterations == host.iterations,
                f"clustering (a): centroids rel {cen_rel:.3e}, cost rel "
                f"{cost_rel:.3e} (tol {KMEANS_RTOL}), iterations "
                f"{card.iterations} vs {host.iterations}")
    out = dict(points=list(vectors.shape), k=c["k"],
               iterations=card.iterations, iterations_cpu=host.iterations,
               cost=card.cost, cost_rel=cost_rel, centroids_rel=cen_rel,
               assignments_apart=apart.tolist(), near_ties=ties,
               init_s=init_s, loop_s=loop_s,
               ms_per_iteration=loop_s / card.iterations * 1e3,
               clusters=int(len(np.unique(card.assignments))))
    if device.type == "cuda":
        pts = torch.from_numpy(vectors).to(device)
        cen_d = torch.from_numpy(card.centroids).to(device)

        def steps():      # as apply_to runs them: the cost read each step
            for _ in range(KMEANS_PROFILE_STEPS):
                float(km._lloyd_step(pts, cen_d)[2])

        prof = _profiled(steps)
        out.update(
            launches_per_iteration=prof["launches"] / KMEANS_PROFILE_STEPS,
            device_ms_per_iteration=prof["device_ms"] / KMEANS_PROFILE_STEPS,
            busy_share=prof["busy_share"])
    return out


def _tsne_packaged(device, fails):
    """(b) (i) exact t-SNE of the packaged vectors at the defaults,
    card against CPU over the first TSNE_STEPS steps: each step from the
    CPU's state (y, velocity, gains) within TSNE_STEP_RTOL and its KL
    within TSNE_KL_RTOL, gains that flip counted; the free runs within
    TSNE_STEP_RTOL for TSNE_EXACT_STEPS steps and, at TSNE_STEPS, within
    TSNE_TWIN_FACTOR x the CPU's distance to its one-ulp twin."""
    import torch
    from deeplearning4j_tpu_torch.nlp.word2vec import load_packaged_word2vec
    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot.tsne import _tsne_step
    cpu = torch.device("cpu")
    x = np.asarray(load_packaged_word2vec(device=cpu).syn0, np.float64)
    card, host = Tsne(device=device), Tsne(device=cpu)
    t0 = time.perf_counter()
    p = host.input_affinities(x)
    p_s = time.perf_counter() - t0
    y0 = host.initial_map(len(x)).astype(np.float32)
    exag_end = min(100, host.n_iter // 4)
    pc = torch.from_numpy(p).float()
    pcs = (pc * host.early_exaggeration, pc)
    pds = tuple(t.to(device) for t in pcs)
    y = torch.from_numpy(y0.copy())
    v, g = torch.zeros_like(y), torch.ones_like(y)
    step_rel, kl_rel, flips, host_at = [], [], 0, {}
    for it in range(TSNE_STEPS):
        e = 0 if it < exag_end else 1
        yd, vd, gd = (t.to(device, copy=True) for t in (y, v, g))
        kl_d = _tsne_step(pds[e], yd, vd, gd, host.momentum,
                          host.learning_rate)
        kl_c = _tsne_step(pcs[e], y, v, g, host.momentum, host.learning_rate)
        step_rel.append(float((yd.cpu() - y).abs().max() / y.abs().max()))
        kl_rel.append(abs(float(kl_d) - float(kl_c)) / abs(float(kl_c)))
        flips += int((gd.cpu() != g).sum())
        if it + 1 in (TSNE_EXACT_STEPS, TSNE_STEPS):
            host_at[it + 1] = y.numpy().copy()
    twin0 = np.nextafter(y0, np.float32(np.inf))
    free, twin = {}, {}
    for n in (TSNE_EXACT_STEPS, TSNE_STEPS):
        scale = np.abs(host_at[n]).max()
        free[n] = float(np.abs(card.descend(p, y0, n)[0] - host_at[n]).max()
                        / scale)
        twin[n] = float(np.abs(host.descend(p, twin0, n)[0]
                               - host_at[n]).max() / scale)
    fails.check(max(step_rel) <= TSNE_STEP_RTOL and max(kl_rel)
                <= TSNE_KL_RTOL,
                f"clustering (b) (i): a t-SNE step card against CPU from "
                f"the same state {max(step_rel):.3e} of max|y| (tol "
                f"{TSNE_STEP_RTOL}), KL rel {max(kl_rel):.3e} (tol "
                f"{TSNE_KL_RTOL}); gains flipped {flips}")
    n1, n2 = TSNE_EXACT_STEPS, TSNE_STEPS
    fails.check(free[n1] <= TSNE_STEP_RTOL
                and free[n2] <= max(TSNE_STEP_RTOL,
                                    TSNE_TWIN_FACTOR * twin[n2]),
                f"clustering (b) (i): free runs card against CPU at step "
                f"{n1} {free[n1]:.3e} (tol {TSNE_STEP_RTOL}), at step {n2} "
                f"{free[n2]:.3e} (one-ulp twin {twin[n2]:.3e}, factor "
                f"{TSNE_TWIN_FACTOR})")
    return dict(points=list(x.shape), p_s=p_s, steps=TSNE_STEPS,
                step_rel_max=max(step_rel), kl_rel_max=max(kl_rel),
                gains_flipped=flips, free_rel=free, twin_rel=twin)


def _neighbour_overlap(device, x, y, k):
    """Mean share of each point's k nearest in the map `y` (euclidean)
    among its k nearest in `x` (cosine), on `device`."""
    import torch
    xt = torch.from_numpy(x).to(device, torch.float32)
    xt = xt / xt.norm(dim=1, keepdim=True).clamp_min(1e-12)
    sim = xt @ xt.T
    sim.fill_diagonal_(float("-inf"))
    near_x = sim.topk(k, dim=1).indices
    yt = torch.from_numpy(y).to(device, torch.float32)
    d = torch.cdist(yt, yt)
    d.fill_diagonal_(float("inf"))
    near_y = d.topk(k, dim=1, largest=False).indices
    hits = (near_x[:, :, None] == near_y[:, None, :]).any(-1).sum()
    return float(hits) / (k * len(x))


def _tsne_bench(device, fails, vectors, small):
    """(b) (ii) exact t-SNE of the vectors at the JAX defaults on the
    card alone: the KL finite and lower at the end than at the first
    step past early exaggeration; neighbours in the map overlap those in
    128-D (cosine) by TSNE_CHANCE_FACTOR x chance; ms, launches, device
    ms and busy share a step; P's host seconds; peak memory. Returns
    (out, the map)."""
    import torch
    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot.tsne import _tsne_step
    ts = Tsne(device=device, **(TSNE_BENCH_SMALL if small else {}))
    x = vectors.astype(np.float64)
    t0 = time.perf_counter()
    p = ts.input_affinities(x)
    p_s = time.perf_counter() - t0
    exag_end = min(100, ts.n_iter // 4)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    _sync(device)
    t0 = time.perf_counter()
    y, kl_end, kls = ts.descend(p, ts.initial_map(len(x)), ts.n_iter,
                                kl_steps=(exag_end - 1, exag_end))
    wall = time.perf_counter() - t0
    out = dict(points=list(x.shape), n_iter=ts.n_iter, p_s=p_s,
               ms_per_step=wall / ts.n_iter * 1e3, kl_end=kl_end,
               kl_last_exaggerated=kls[exag_end - 1],
               kl_first_plain=kls[exag_end])
    chance = TSNE_NEIGHBOURS / (len(x) - 1)
    out["overlap"] = _neighbour_overlap(device, x, y, TSNE_NEIGHBOURS)
    out["overlap_chance"] = chance
    fails.check(np.isfinite(y).all() and np.isfinite(kl_end)
                and kl_end < kls[exag_end],
                f"clustering (b) (ii): KL {kl_end} at the end against "
                f"{kls[exag_end]} at the first step past exaggeration "
                f"(finite map {bool(np.isfinite(y).all())})")
    fails.check(out["overlap"] >= TSNE_CHANCE_FACTOR * chance,
                f"clustering (b) (ii): {TSNE_NEIGHBOURS}-neighbour overlap "
                f"{out['overlap']:.4f} < {TSNE_CHANCE_FACTOR} x chance "
                f"{chance:.5f}")
    if device.type == "cuda":
        out["peak_allocated"] = int(torch.cuda.max_memory_allocated(device))
        out["allocated_before"] = int(base)
        pd = torch.from_numpy(p).to(device, torch.float32)
        yd = torch.from_numpy(y).to(device)
        vd, gd = torch.zeros_like(yd), torch.ones_like(yd)

        def steps():
            for _ in range(TSNE_PROFILE_STEPS):
                kl = _tsne_step(pd, yd, vd, gd, ts.final_momentum,
                                ts.learning_rate)
            return kl.item()

        prof = _profiled(steps)
        out.update(launches_per_step=prof["launches"] / TSNE_PROFILE_STEPS,
                   device_ms_per_step=prof["device_ms"] / TSNE_PROFILE_STEPS,
                   busy_share=prof["busy_share"])
    return out, y


def _viterbi_decodes(device, fails, small):
    """(c) the two decodes through the kernel on the card against the
    plain version on the CPU, path and score bit for bit: the noisy
    labels of a metastable chain (`Viterbi`) and `viterbi_decode` at the
    smoke LM's vocab (default prior). Returns (report, launches)."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    from deeplearning4j_tpu_torch.util import Viterbi, viterbi_decode
    cpu = torch.device("cpu")
    (T1, S1), (T2, S2) = ((VITERBI_CHAIN_SHAPE, VITERBI_LM_SHAPE)
                          if not small else ((2000, 77), (300, 64)))
    obs = viterbi_chain(T1, S1, seed=23)
    em, tr, _ = viterbi_tables(T2, S2, seed=2323)
    out, launches = {}, 0
    for case, card_fn, host_fn, shape in (
            ("noisy_labels",
             lambda: Viterbi(S1, device=device).decode(obs),
             lambda: Viterbi(S1, device=cpu).decode(obs), [T1, S1]),
            ("lm_vocab",
             lambda: viterbi_decode(em, tr, device=device),
             lambda: viterbi_decode(em, tr, device=cpu), [T2, S2])):
        n0 = K.LAUNCHES["viterbi"]
        _sync(device)
        t0 = time.perf_counter()
        s_card, p_card = card_fn()
        card_s = time.perf_counter() - t0
        n = K.LAUNCHES["viterbi"] - n0
        launches += n
        t0 = time.perf_counter()
        s_cpu, p_cpu = host_fn()
        cpu_s = time.perf_counter() - t0
        equal = bool(np.array_equal(p_card, p_cpu)
                     and np.float32(s_card) == np.float32(s_cpu))
        fails.check(equal and n == (device.type == "cuda"),
                    f"clustering (c) {case} {shape}: path and score card "
                    f"against CPU bit-equal {equal} ({s_card} vs {s_cpu}), "
                    f"launches {n}")
        out[case] = dict(shape=shape, score=s_card, bit_equal=equal,
                         launches=n, decode_s=card_s, cpu_s=cpu_s,
                         changed=(int((p_card != obs).sum())
                                  if case == "noisy_labels" else None))
    return out, launches


def _segmenter_fits(device, fails):
    """(d) Word2Vec through the CJK, Japanese, Korean and annotation
    tokenizer factories on their tests' corpora, card against CPU within
    EMBED_RTOL, each with its test's structure check on the card."""
    import torch
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp.annotation import (
        AnnotationTokenizerFactory)
    from deeplearning4j_tpu_torch.nlp.cjk import CJKTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.japanese import (
        CONTENT_POS as JA_CONTENT, JapaneseTokenizerFactory)
    from deeplearning4j_tpu_torch.nlp.korean import (
        CONTENT_POS as KO_CONTENT, KoreanTokenizerFactory)
    runs = {
        "cjk": (CJK_CORPUS, lambda: CJKTokenizerFactory(CJK_LEXICON),
                dict(layer_size=24, window_size=3, min_word_frequency=2,
                     negative_sample=5, learning_rate=0.05, epochs=4,
                     batch_size=512, seed=11)),
        "japanese": (JA_CORPUS,
                     lambda: JapaneseTokenizerFactory(pos_keep=JA_CONTENT),
                     dict(layer_size=24, window_size=3, min_word_frequency=2,
                          negative_sample=5, learning_rate=0.05, epochs=16,
                          batch_size=128, seed=7)),
        "korean": (KO_CORPUS,
                   lambda: KoreanTokenizerFactory(pos_keep=KO_CONTENT),
                   dict(layer_size=8, window_size=2, min_word_frequency=2,
                        epochs=1, batch_size=64, seed=0)),
        "annotation": (ANNOTATION_CORPUS, AnnotationTokenizerFactory,
                       dict(layer_size=8, window_size=2, min_word_frequency=2,
                            epochs=1, batch_size=64, seed=0)),
    }
    out = {}
    for name, (corpus, factory, kw) in runs.items():
        t0 = time.perf_counter()
        card, host = (Word2Vec(sentence_iterator=corpus,
                               tokenizer_factory=factory(), device=d,
                               **kw).fit()
                      for d in (device, torch.device("cpu")))
        rel = [_rel_dist(card.syn0, host.syn0),
               _rel_dist(card.syn1neg, host.syn1neg)]
        structure = _segmenter_structure(name, card)
        out[name] = dict(rel=rel, words=card.vocab.num_words(),
                         structure=structure,
                         seconds=time.perf_counter() - t0)
        fails.check(max(rel) <= EMBED_RTOL and all(structure.values()),
                    f"clustering (d) {name}: syn0/syn1neg card against CPU "
                    f"{rel} (tol {EMBED_RTOL}), structure {structure}")
    return out


def _segmenter_structure(name, w):
    """The structure check of each segmenter test's Word2Vec fit."""
    if name == "cjk":
        finance = {"股票", "市场", "价格", "经济", "投资", "上涨", "下跌"}
        return dict(
            vocab=w.has_word("股票") and w.has_word("猫")
            and not w.has_word("我的猫喜欢吃鱼"),
            topic=w.similarity("猫", "狗") > w.similarity("猫", "股票"),
            nearest=len(finance & set(w.words_nearest("银行", top_n=5))) >= 2)
    if name == "japanese":
        finance = {"会社", "株価", "市場", "価格", "株", "投資", "経済",
                   "お金"}
        return dict(
            vocab=w.has_word("株価") and w.has_word("猫")
            and not w.has_word("猫は魚を食べる") and not w.has_word("は")
            and not w.has_word("を"),
            frames=w.similarity("銀行", "会社") > w.similarity("銀行", "猫")
            and w.similarity("猫", "犬") > w.similarity("猫", "株価"),
            nearest=len(finance & set(w.words_nearest("銀行", top_n=6))) >= 2)
    if name == "korean":
        return dict(vocab=w.has_word("고양이") and not w.has_word("고양이가")
                    and not w.has_word("고양이는"))
    return dict(vocab=w.has_word("cat") and w.has_word("markets"))


def _nn_server(device, fails, vectors):
    """(e) `NearestNeighborsServer` over the vectors: /knn of stored
    points and /knnnew of moved ones (base64 float32 bodies) for
    SERVER_QUERIES queries, each equal to a brute force on `device`
    (float64 distances, as the VP-tree's)."""
    import torch
    from deeplearning4j_tpu_torch.clustering.server import (
        NearestNeighborsClient, NearestNeighborsServer)
    t0 = time.perf_counter()
    server = NearestNeighborsServer(vectors).start()
    build_s = time.perf_counter() - t0
    pts = torch.from_numpy(vectors).to(device, torch.float64)
    rng = np.random.default_rng(29)
    queries = rng.choice(len(vectors), SERVER_QUERIES, replace=False)
    wrong, dist_err, times = [], 0.0, []
    try:
        client = NearestNeighborsClient(f"http://127.0.0.1:{server.port}")
        for i in queries.tolist():
            for route in ("knn", "knnnew"):
                q = (vectors[i] if route == "knn"
                     else vectors[i] + np.float32(1e-3))
                t1 = time.perf_counter()
                res = (client.knn(i, SERVER_K) if route == "knn"
                       else client.knn_new(q, SERVER_K))["results"]
                times.append(time.perf_counter() - t1)
                qd = torch.from_numpy(q.astype(np.float32)).to(
                    device, torch.float64)
                d = ((pts - qd) ** 2).sum(1).sqrt()
                want_d, want = torch.sort(d, stable=True)
                want = want[:SERVER_K].cpu().tolist()
                got = [r["index"] for r in res]
                if got != want:
                    wrong.append((route, i, got, want))
                dist_err = max(dist_err, max(
                    abs(r["distance"] - float(w)) / max(float(w), 1e-30)
                    for r, w in zip(res, want_d[:SERVER_K].cpu())))
    finally:
        server.stop()
    fails.check(not wrong and dist_err <= 1e-9,
                f"clustering (e): kNN server against the brute force on "
                f"the card: unequal {wrong}, distance rel err {dist_err}")
    return dict(points=list(vectors.shape), queries=len(queries) * 2,
                k=SERVER_K, unequal=len(wrong), distance_rel_err=dist_err,
                tree_build_s=build_s, request_ms_median=float(
                    np.median(times) * 1e3))


def phase_clustering(device, report, fails, small=False, vectors=None,
                     keep=None):
    """Phase 23 on `device` (see the module docstring, 23 (a)-(e)):
    k-means, t-SNE, Viterbi, the segmenters and the kNN server, card
    against the port's CPU path. `small` (the CPU rehearsal) shrinks
    (a)-(c)'s sizes; (d) runs at its tests' sizes either way. Returns
    {"viterbi": launches} of (c)'s card decodes. `vectors` are phase 22
    (a)'s, trained here when None; (b) (ii)'s map goes into
    `keep["tsne"]` as (coords, source) when `keep` is given."""
    t_start = time.perf_counter()
    out, parts = {}, {}
    source = "phase 22 (a)"
    if vectors is None:
        vectors, source = _bench_vectors(device, small), "trained here"
    out["vectors"] = dict(shape=list(vectors.shape), source=source)
    launches = 0
    for part, fn, args in (
            ("a", _kmeans, (vectors, KMEANS_SMALL if small else KMEANS)),
            ("b_i", _tsne_packaged, ()),
            ("b_ii", _tsne_bench, (vectors, small)),
            ("c", _viterbi_decodes, (small,)),
            ("d", _segmenter_fits, ()),
            ("e", _nn_server, (vectors,))):
        t0 = time.perf_counter()
        res = fn(device, fails, *args)
        if part == "c":
            res, launches = res
        elif part == "b_ii":
            res, tsne_map = res
            if keep is not None:
                keep["tsne"] = (tsne_map, f"phase 23 (b) (ii), {source}")
        out[part] = res
        parts[part] = time.perf_counter() - t0
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_start
    report["clustering"] = out
    _print_clustering(out)
    return {"viterbi": launches}


def _print_clustering(out):
    a = out["a"]
    print(f"[clustering] vectors {out['vectors']}; (a) k-means K {a['k']} "
          f"on {a['points']}: {a['iterations']} iterations (CPU "
          f"{a['iterations_cpu']}), {a['ms_per_iteration']:.3f} ms an "
          f"iteration, launches an iteration "
          f"{a.get('launches_per_iteration')}, device ms "
          f"{a.get('device_ms_per_iteration')}, busy {a.get('busy_share')};"
          f" cost {a['cost']:.6g} rel {a['cost_rel']:.2e}, centroids rel "
          f"{a['centroids_rel']:.2e}, apart {a['assignments_apart']} "
          f"(near-ties {a['near_ties']})", flush=True)
    b = out["b_i"]
    print(f"[clustering] (b) (i) t-SNE {b['points']}: {b['steps']} steps "
          f"from the CPU's state {b['step_rel_max']:.2e} of max|y|, KL rel "
          f"{b['kl_rel_max']:.2e}, gains flipped {b['gains_flipped']}; free "
          f"runs {b['free_rel']} (one-ulp twin {b['twin_rel']}); P "
          f"{b['p_s']:.2f} s", flush=True)
    b = out["b_ii"]
    print(f"[clustering] (b) (ii) t-SNE {b['points']} x {b['n_iter']} "
          f"steps: {b['ms_per_step']:.3f} ms a step, launches a step "
          f"{b.get('launches_per_step')}, device ms "
          f"{b.get('device_ms_per_step')}, busy {b.get('busy_share')}; KL "
          f"{b['kl_first_plain']:.4f} -> {b['kl_end']:.4f}; "
          f"{TSNE_NEIGHBOURS}-neighbour overlap {b['overlap']:.4f} (chance "
          f"{b['overlap_chance']:.5f}); P {b['p_s']:.2f} s; peak allocated "
          f"{b.get('peak_allocated')}", flush=True)
    for case, r in out["c"].items():
        print(f"[clustering] (c) viterbi {case} {r['shape']}: "
              f"{r['decode_s'] * 1e3:.3f} ms a decode, {r['launches']} "
              f"launch(es), bit-equal to the CPU {r['bit_equal']} (CPU "
              f"{r['cpu_s']:.2f} s); labels changed {r['changed']}",
              flush=True)
    for name, r in out["d"].items():
        print(f"[clustering] (d) {name}: {r['words']} words, card vs CPU "
              f"{[f'{x:.2e}' for x in r['rel']]}, {r['structure']}",
              flush=True)
    e = out["e"]
    print(f"[clustering] (e) kNN server {e['points']}: {e['queries']} "
          f"queries, unequal {e['unequal']}, distance rel err "
          f"{e['distance_rel_err']:.1e}, tree {e['tree_build_s']:.2f} s, "
          f"{e['request_ms_median']:.2f} ms a request", flush=True)
    print(f"[clustering] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 2) for k, v in out['part_seconds'].items()} })",
          flush=True)


# ------------------------------------------------------------- phase 24
KERAS_FIXTURES = os.path.join(HERE, "tests", "fixtures", "keras")
RESNET_KERAS_ARCH = os.path.join(HERE, "deeplearning4j_tpu", "zoo", "weights",
                                 "resnet50_keras_arch.json")
# (a): JAX's tolerance against Keras's own predictions
# (tests/test_keras_real_golden.py:42-66), and real_bn's SGD fit, card
# against the port's CPU run
KERAS_RTOL, KERAS_ATOL = 1e-4, 1e-5
KERAS_FIT_ATOL = 1e-5
KERAS_FIT_STEPS = 2
REAL_FIXTURES = (("real_cnn", "cnn"), ("real_lstm", "lstm"),
                 ("real_func", "func"), ("real_bn", "bn"))
# (b): the imported keras-applications ResNet-50, card against the
# port's CPU import of the same file (of max|y|), at full width
IMPORT_B, IMPORT_REF_IMAGES, IMPORT_TOL = 32, 2, 1e-4
IMPORT_FT = dict(B=16, steps=3, lr=1e-4)
IMPORT_SMALL_SIZE = 32        # the CPU rehearsal's input (the arch's is 224)
# (c): a real tabular set's size (UCI covertype: 581,012 x 55)
CSV = dict(rows=250_000, features=16, classes=10, train=65_536, batch=1024)
CSV_SMALL = dict(CSV, rows=4096, train=2048, batch=64)
ESTIMATOR_ATOL = 1e-5
ESTIMATOR_MIN_SCORE = 0.5     # held-out accuracy (chance is 0.1)
# (c): a small file with every quirk the parser handles
CSV_QUIRKS = ('# a comment line\n"a","b",c\n1,2,3\n\n"4.5",x,6\r\n'
              '# another\n7,8\n9,"1,0",11,12\n  13 , 14 ,15\n'
              '\t16\t,"17" ,12abc\n')


class NpzArchive:
    """`Hdf5Archive`'s reads and writes over an .npz, for a host without
    libhdf5: groups, string attributes and float32 datasets at the same
    paths, so the same layout writer and the port's own weight copy
    (`KerasModelImport._copy_weights`) run over it unchanged."""

    def __init__(self, path, mode: str = "r"):
        self.path, self.mode = str(path), mode
        self._arrays, self._groups = {}, {"/"}
        self._attrs = {}
        if mode == "r":
            with np.load(self.path) as z:
                self._arrays = {k: z[k] for k in z.files}
            meta = json.loads(bytes(self._arrays.pop("__meta__")).decode())
            self._attrs, self._groups = meta["attrs"], set(meta["groups"])

    def close(self):
        if self.mode == "w":
            meta = json.dumps({"attrs": self._attrs,
                               "groups": sorted(self._groups)}).encode()
            with open(self.path, "wb") as f:
                np.savez(f, __meta__=np.frombuffer(meta, np.uint8),
                         **self._arrays)
            self.mode = "closed"

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @staticmethod
    def _key(path):
        return "/" + path.strip("/")

    def exists(self, path):
        return self._key(path) in self._groups or \
            self._key(path) in self._arrays

    def read_attr_string(self, attr, obj_path="/"):
        return self._attrs.get(f"{self._key(obj_path)}@{attr}")

    def read_attr_strings(self, attr, obj_path="/"):
        s = self.read_attr_string(attr, obj_path)
        return [] if not s else s.split("\n")

    def read_dataset(self, path):
        return self._arrays[self._key(path)]

    def create_group(self, path):
        self._groups.add(self._key(path))

    def write_attr_string(self, attr, value, obj_path="/"):
        self._attrs[f"{self._key(obj_path)}@{attr}"] = value

    def write_attr_strings(self, attr, values, obj_path="/"):
        self.write_attr_string(attr, "\n".join(values), obj_path)

    def write_dataset(self, path, data):
        self._arrays[self._key(path)] = np.ascontiguousarray(data,
                                                             np.float32)


def write_keras_weights(ar, layer_weights, root="/"):
    """The keras weights layout (tests/keras_fixture_util.py:21-40 and
    tests/test_keras_golden.py:245-256) through an archive opened for
    writing: `layer_names` on `root`, each layer's `weight_names`, and
    its datasets at `{root}/{lname}/{lname}/{w}:0`. Returns the bytes
    of float32 data written."""
    root = root.rstrip("/")
    if root:
        ar.create_group(root)
    ar.write_attr_strings("layer_names", [n for n, _ in layer_weights],
                          root or "/")
    nbytes = 0
    for lname, weights in layer_weights:
        ar.create_group(f"{root}/{lname}")
        ar.write_attr_strings("weight_names",
                              [f"{lname}/{w}:0" for w, _ in weights],
                              f"{root}/{lname}")
        if weights:
            ar.create_group(f"{root}/{lname}/{lname}")
        for w, arr in weights:
            ar.write_dataset(f"{root}/{lname}/{lname}/{w}:0", arr)
            nbytes += arr.nbytes
    return nbytes


def keras_resnet_arch(size=None):
    """The keras-applications ResNet-50 architecture (`model.to_json()`,
    committed beside the JAX package's zoo weights), its input cut to
    `size` x `size` when given."""
    with open(RESNET_KERAS_ARCH) as f:
        arch = json.load(f)
    if size is not None:
        arch["config"]["layers"][0]["config"]["batch_shape"] = [
            None, size, size, 3]
    return arch


def keras_resnet_weights(arch, seed=0):
    """[(keras layer name, [(weight name, array)])] for every layer of
    `arch` in its order, seeded: He-scaled conv kernels and biases, the
    BatchNorms' gamma, beta and moving statistics away from 1/0 (the
    moving variance in [1, 1.5)), and the 1000-way `predictions` Dense."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    conf = KerasModelImport.config_from_dict(arch)
    rng = np.random.default_rng(seed)
    out = []
    for lc in arch["config"]["layers"]:
        name, cls = lc["name"], lc["class_name"]
        node = conf.nodes.get(name)
        shapes = ({k: tuple(t.shape) for k, t in
                   node.layer.jax_param_map().items()}
                  if node is not None and node.layer is not None else {})
        if cls in ("Conv2D", "Dense"):
            w = shapes["W"]
            fan_in = int(np.prod(w[:-1]))
            gain = 2.0 if cls == "Conv2D" else 1.0
            out.append((name, [
                ("kernel", rng.standard_normal(w, dtype=np.float32)
                 * np.float32(np.sqrt(gain / fan_in))),
                ("bias", 0.1 * rng.standard_normal(w[-1:],
                                                   dtype=np.float32))]))
        elif cls == "BatchNormalization":
            c = shapes["gamma"]
            out.append((name, [
                ("gamma", 1 + 0.1 * rng.standard_normal(c, dtype=np.float32)),
                ("beta", 0.1 * rng.standard_normal(c, dtype=np.float32)),
                ("moving_mean", 0.1 * rng.standard_normal(c,
                                                          dtype=np.float32)),
                ("moving_variance", 1 + 0.5 * rng.random(c,
                                                         dtype=np.float32))]))
        else:
            out.append((name, []))
    return out


def _keras_training_config(lr):
    """A compiled model's `training_config`: Adam(lr) and categorical
    cross-entropy, as Keras 2 writes it."""
    return {"loss": "categorical_crossentropy", "metrics": [],
            "optimizer_config": {"class_name": "Adam", "config": {
                "learning_rate": lr, "beta_1": 0.9, "beta_2": 0.999,
                "epsilon": 1e-7, "amsgrad": False}}}


def _losses_listener():
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

    class Losses(TrainingListener):
        def __init__(self):
            self.losses = []

        def iteration_done(self, model, iteration, epoch, score, **info):
            self.losses.append(float(score))
    return Losses()


def _host(t):
    return t.detach().cpu().numpy()


def _keras_real(device, fails, hdf5):
    """(a) The five Keras-written fixtures on `device`, against Keras's
    own predictions; real_bn's SGD fit, card against the CPU."""
    if hdf5 is None:
        return dict(skipped="no libhdf5 on this host: the real .h5 "
                    "fixtures cannot be read (the CPU tests hold them)")
    import torch
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    preds = np.load(os.path.join(KERAS_FIXTURES, "predictions.npz"))
    out = {}
    for fname, key in REAL_FIXTURES:
        net = KerasModelImport.import_keras_model_and_weights(
            os.path.join(KERAS_FIXTURES, f"{fname}.h5"), device=device)
        got = net.output(preds[f"{key}_x"])
        got = _host(got[0] if isinstance(got, (list, tuple)) else got)
        err = float(np.abs(got - preds[f"{key}_y"]).max())
        fails.check(np.allclose(got, preds[f"{key}_y"], rtol=KERAS_RTOL,
                                atol=KERAS_ATOL),
                    f"import (a) {fname} against Keras's predictions: max "
                    f"err {err} (rtol {KERAS_RTOL}, atol {KERAS_ATOL})")
        out[fname] = err
    # the weights-only Keras 3 file, by name into a zeroed import
    net = KerasModelImport.import_keras_model_and_weights(
        os.path.join(KERAS_FIXTURES, "real_cnn.h5"), device=device)
    with torch.no_grad():
        for t in net.parameters():
            t.zero_()
    KerasModelImport.load_weights_into(
        net, os.path.join(KERAS_FIXTURES, "real_cnn.weights.h5"))
    got = _host(net.output(preds["cnn_x"]))
    err = float(np.abs(got - preds["cnn_y"]).max())
    fails.check(np.allclose(got, preds["cnn_y"], rtol=KERAS_RTOL,
                            atol=KERAS_ATOL),
                f"import (a) real_cnn.weights.h5 by name: max err {err}")
    out["real_cnn.weights"] = err
    # the compiled real_bn fitted with its own SGD, card against CPU
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    losses = []
    for dev in (device, "cpu"):
        net = KerasModelImport.import_keras_model_and_weights(
            os.path.join(KERAS_FIXTURES, "real_bn.h5"), device=dev)
        rec = _losses_listener()
        net.set_listeners(rec)
        for _ in range(KERAS_FIT_STEPS):
            net.fit(x, y, shuffle=False)
        losses.append(rec.losses)
    diff = float(np.abs(np.subtract(*losses)).max())
    fails.check(diff <= KERAS_FIT_ATOL and np.all(np.isfinite(losses)),
                f"import (a) real_bn fit card vs CPU: losses {losses}, "
                f"max diff {diff} (tol {KERAS_FIT_ATOL})")
    out["real_bn_fit"] = dict(card=losses[0], cpu=losses[1], diff=diff)
    return out


def _resnet_zoo(path, arch_name):
    """A ResNet50 zoo model serving `path` (its sha256) for IMAGENET,
    with `arch_name` (a name in the zoo's weights directory, or an
    absolute path) as its Keras architecture."""
    import hashlib
    from pathlib import Path
    from deeplearning4j_tpu_torch.zoo import ResNet50
    from deeplearning4j_tpu_torch.zoo.base import PretrainedType
    digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()

    class Served(ResNet50):
        keras_architecture = {PretrainedType.IMAGENET: arch_name}

        def pretrained_path(self, ptype):
            return Path(path)

        def pretrained_checksum(self, ptype):
            return digest
    return Served()


def _import_resnet(device, arch, hdf5, path, zoo=None, training_config=None):
    """The imported network on `device`. Where libhdf5 links: the zoo's
    `init_pretrained` (a weights-only file) or `import_keras_model_and_
    weights` (a compiled one). Else the architecture through
    `import_keras_configuration` (`arch` None: the committed file) or
    `config_from_dict`, and the archive twin's weights through the port's
    own `_copy_weights`."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.base import PretrainedType
    if hdf5 is not None:
        if zoo is not None:
            return zoo.init_pretrained(PretrainedType.IMAGENET, device=device)
        return KerasModelImport.import_keras_model_and_weights(
            path, device=device)
    conf = (KerasModelImport.import_keras_configuration(RESNET_KERAS_ARCH)
            if arch is None else
            KerasModelImport.config_from_dict(arch, training_config))
    net = ComputationGraph(conf, device=device).init()
    with NpzArchive(path) as twin:
        root = KerasModelImport._weights_root(twin)
        names = [(n, n) for n in twin.read_attr_strings("layer_names", root)
                 if n in conf.nodes]
        KerasModelImport._copy_weights(net, twin, names)
    return net


def _keras_resnet(device, fails, hdf5, small, tmp):
    """(b) The keras-applications ResNet-50 at full width: seeded weights
    written weights-only, imported through the zoo, `output()` at batch
    32 held to the CPU import; then the same weights as a compiled Keras
    model (Adam, categorical cross-entropy) imported and fitted."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.modelimport import Hdf5Archive
    from deeplearning4j_tpu_torch.util.jax_params import to_jax_state
    import deeplearning4j_tpu_torch.kernels as K
    size = IMPORT_SMALL_SIZE if small else 224
    arch = keras_resnet_arch(size if small else None)
    Archive = Hdf5Archive if hdf5 is not None else NpzArchive
    ext = ".h5" if hdf5 is not None else ".npz"
    weights = keras_resnet_weights(arch)
    out = dict(route=("h5: init_pretrained + import_keras_model_and_weights"
                      if hdf5 is not None else
                      "npz twin: import_keras_configuration + "
                      "_copy_weights"),
               size=size, tensors=sum(len(w) for _, w in weights),
               floats=int(sum(a.size for _, w in weights for _, a in w)))
    # (i) weights-only, through the zoo
    path = os.path.join(tmp, f"resnet50_weights{ext}")
    t0 = time.perf_counter()
    with Archive(path, "w") as ar:
        nbytes = write_keras_weights(ar, weights)
        ar.write_attr_string("backend", "tensorflow")
    out["write_s"] = time.perf_counter() - t0
    out["file_mb"] = os.path.getsize(path) / 1e6
    out["data_mb"] = nbytes / 1e6
    t0 = time.perf_counter()
    with Archive(path) as ar:
        for lname in ar.read_attr_strings("layer_names"):
            for wn in ar.read_attr_strings("weight_names", f"/{lname}"):
                ar.read_dataset(f"/{lname}/{wn}")
    out["read_s"] = time.perf_counter() - t0
    arch_name = "resnet50_keras_arch.json"
    if small:   # an absolute name: the zoo joins it to nothing
        arch_name = os.path.join(tmp, "resnet50_small_arch.json")
        with open(arch_name, "w") as f:
            json.dump(arch, f)
    zoo = _resnet_zoo(path, arch_name)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = _import_resnet(device, arch if small else None, hdf5, path, zoo)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = _import_resnet("cpu", arch if small else None, hdf5, path, zoo)
    out["cpu_import_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(24)
    B = 4 if small else IMPORT_B
    x = rng.standard_normal((B, size, size, 3), dtype=np.float32)
    y = net.output(x)
    n = IMPORT_REF_IMAGES
    want = _host(ref.output(x[:n]))
    got = _host(y)
    rel = float(np.abs(got[:n] - want).max() / np.abs(want).max())
    feat = _host(net.feed_forward(x[:n])["avg_pool"])
    feat_ref = _host(ref.feed_forward(x[:n])["avg_pool"])
    feat_rel = float(np.abs(feat - feat_ref).max() / np.abs(feat_ref).max())
    top1 = bool(np.array_equal(got[:n].argmax(-1), want.argmax(-1)))
    fails.check(rel <= IMPORT_TOL and feat_rel <= IMPORT_TOL and top1
                and got.shape == (B, 1000) and np.isfinite(got).all(),
                f"import (b) ResNet-50 output card vs CPU: {rel} of max|y| "
                f"(pooled features {feat_rel}, tol {IMPORT_TOL}), top-1 "
                f"equal {top1}, shape {got.shape}")
    state = to_jax_state(net)["conv1_bn"]
    moved = bool(np.abs(state["var"] - 1).max() > 0.01
                 and np.abs(state["mean"]).max() > 0.01)
    fails.check(moved, "import (b) conv1_bn's running state is not the "
                "file's moving statistics")
    out.update(output_rel=rel, features_rel=feat_rel, top1_equal=top1,
               max_prob=float(got.max()), eps=float(
                   net.conf.nodes["conv1_bn"].layer.eps),
               output_ms=timer(device, lambda: net.output(x), iters=5,
                               warmup=1))
    del net, ref
    # (ii) the same weights as a compiled Keras 2 model, fine-tuned
    tc = _keras_training_config(IMPORT_FT["lr"])
    path = os.path.join(tmp, f"resnet50_compiled{ext}")
    with Archive(path, "w") as ar:
        ar.write_attr_string("model_config", json.dumps(arch))
        ar.write_attr_string("training_config", json.dumps(tc))
        ar.write_attr_string("keras_version", "2.2.4")
        ar.write_attr_string("backend", "tensorflow")
        write_keras_weights(ar, weights, "/model_weights")
    B, steps = (2, 2) if small else (IMPORT_FT["B"], IMPORT_FT["steps"])
    X, Y = resnet_images(B * steps, size, 1000, seed=25)
    noisy = X * (1 + RESNET_NOISE * np.random.default_rng(9)
                 .standard_normal(X.shape, dtype=np.float32))
    nets = [_import_resnet(dev, keras_resnet_arch(size if small else None),
                           hdf5, path, training_config=tc)
            for dev in (device, "cpu")]
    # the noisy twin: a copy of the CPU import (the noise is on its images)
    nets.append(_copy_to(nets[1], "cpu"))
    losses, secs = [], []
    for fine, XX in zip(nets, (X, X, noisy)):
        rec = _losses_listener()
        fine.set_listeners(rec)
        n0 = K.LAUNCHES["fused_adam"]
        t0 = time.perf_counter()
        for i in range(0, B * steps, B):
            fine.fit(DataSet(XX[i:i + B], Y[i:i + B]), batch_size=B)
        if getattr(fine.device, "type", "") == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not losses:
            out["fused_adam_per_step"] = (K.LAUNCHES["fused_adam"]
                                          - n0) / steps
        losses.append(rec.losses)
    out["output_layer"] = type(
        nets[0].conf.nodes["predictions"].layer).__name__
    fails.check(out["output_layer"] == "OutputLayer",
                f"import (b) the compiled Dense became "
                f"{out['output_layer']}, not an OutputLayer")
    out["fine_tune"] = dict(B=B, steps=steps, card_s=secs[0],
                            cpu_s=secs[1], **_noisy_twin_checks(
                                fails, "import (b) ResNet-50 fine-tune",
                                *nets, losses,
                                extra=(("state", to_jax_state),)))
    # fused Adam updates packed runs only (JAX `graph.py:633-656`): the
    # imported graph has none, so its Adam runs per leaf, as JAX's does
    runs = nets[0]._packed_runs()
    out["packed_runs"] = len(runs)
    want = len(runs) if device.type == "cuda" else 0
    fails.check(out["fused_adam_per_step"] == want,
                f"import (b) fused Adam launched "
                f"{out['fused_adam_per_step']} times a fine-tune step, "
                f"the graph's packed runs {len(runs)}")
    return out


def _csv_estimator(device, fails, small, tmp):
    """(c) The CSV shim at a real tabular set's size, then its first rows
    into a NetworkEstimator on `device` against the CPU estimator."""
    import torch
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.datasets import native_csv
    from deeplearning4j_tpu_torch.ml import NetworkEstimator
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    import deeplearning4j_tpu_torch.kernels as K
    c = CSV_SMALL if small else CSV
    out = {}
    t0 = time.perf_counter()
    native = native_csv.native_available()
    out["build_s"] = time.perf_counter() - t0
    out["native"] = native
    fails.check(native, "import (c) the CSV shim did not build with g++")
    rng = np.random.default_rng(31)
    feats = rng.standard_normal((c["rows"], c["features"]),
                                dtype=np.float32)
    proj = rng.standard_normal((c["features"], c["classes"]),
                               dtype=np.float32)
    labels = (feats @ proj).argmax(-1).astype(np.float32)
    src = np.concatenate([feats, labels[:, None]], axis=1)
    path = os.path.join(tmp, "table.csv")
    t0 = time.perf_counter()
    buf = io.StringIO()
    np.savetxt(buf, src, fmt="%.9g", delimiter=",")
    text = buf.getvalue()
    with open(path, "w") as f:
        f.write(text)
    out["write_s"] = time.perf_counter() - t0
    out["mb"] = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    m = native_csv.load_csv_matrix(path)
    out["parse_s"] = time.perf_counter() - t0
    out["mb_per_s"] = out["mb"] / out["parse_s"]
    out["rows_per_s"] = c["rows"] / out["parse_s"]
    out["bit_equal"] = bool(m.shape == src.shape
                            and np.array_equal(m.view(np.uint32),
                                               src.view(np.uint32)))
    fails.check(out["bit_equal"], f"import (c) the parsed {m.shape} CSV "
                f"is not the source {src.shape} bit for bit")
    quirks = os.path.join(tmp, "quirks.csv")
    with open(quirks, "w") as f:
        f.write(CSV_QUIRKS)
    got = native_csv.load_csv_matrix(quirks, skip_header=1)
    want = native_csv._numpy_fallback(quirks, ",", 1)
    out["quirks_equal"] = bool(got.shape == want.shape and np.array_equal(
        got, want, equal_nan=True))
    fails.check(out["quirks_equal"], f"import (c) quirks file: shim {got} "
                f"against the numpy path {want}")
    head = os.path.join(tmp, "table_head.csv")
    end = -1
    for _ in range(c["train"]):
        end = text.index("\n", end + 1)
    with open(head, "w") as f:
        f.write(text[:end + 1])
    train = native_csv.load_csv_dataset(head, num_classes=c["classes"])
    held_x, held_y = feats[c["train"]:], labels[c["train"]:].astype(int)

    def conf():
        return (NeuralNetConfiguration.builder().seed(7)
                .updater(Adam(1e-3)).list()
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(OutputLayer(n_out=c["classes"], activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(c["features"]))
                .build())

    ests, firsts, secs = [], [], []
    n0 = K.LAUNCHES["fused_adam"]
    for dev in (device, torch.device("cpu")):
        rec = _losses_listener()

        def factory(dev=dev, rec=rec):
            return MultiLayerNetwork(conf(), device=dev).set_listeners(rec)
        est = NetworkEstimator(factory, epochs=1, batch_size=c["batch"],
                               num_classes=c["classes"], device=dev)
        t0 = time.perf_counter()
        est.fit(train.features, train.labels.argmax(-1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not ests:
            out["fused_adam"] = K.LAUNCHES["fused_adam"] - n0
            out["steps"] = len(rec.losses)
        ests.append(est)
        firsts.append(rec.losses[0])
    diff = abs(firsts[0] - firsts[1])
    fails.check(diff <= ESTIMATOR_ATOL,
                f"import (c) estimator first loss card {firsts[0]} vs CPU "
                f"{firsts[1]} (tol {ESTIMATOR_ATOL})")
    hx, hy = held_x, held_y
    pred = ests[0].predict(hx)
    agree = float((pred == ests[1].predict(hx)).mean())
    score = ests[0].score(hx, hy)
    fails.check(score >= ESTIMATOR_MIN_SCORE and pred.shape == hy.shape,
                f"import (c) estimator held-out accuracy {score} (min "
                f"{ESTIMATOR_MIN_SCORE})")
    out.update(first_loss=firsts, first_loss_diff=diff, epoch_s=secs[0],
               cpu_epoch_s=secs[1], score=score, cpu_score=ests[1].score(
                   hx, hy), predict_agreement=agree, train=c["train"],
               held=int(len(hy)))
    return out, ests[0]


def _guesser(device, fails, hdf5, est, tmp):
    """(d) ModelGuesser on `device` against the direct loads, bit for
    bit: a full Keras model (where libhdf5 links), the estimator's net as
    a port zip, and its configuration JSON; a weights-only .h5 refused."""
    import torch
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.guesser import ModelGuesser
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
    out = {}
    x = np.random.default_rng(41).standard_normal(
        (64, est.model_.layers[0].n_in), dtype=np.float32)

    def same(name, guessed, direct, xx):
        a, b = guessed.output(xx), direct.output(xx)
        ok = (type(guessed) is type(direct)
              and guessed.device == direct.device and torch.equal(a, b))
        fails.check(ok, f"import (d) guess of {name}: "
                    f"{type(guessed).__name__} on {guessed.device} against "
                    f"{type(direct).__name__} on {direct.device}, equal "
                    f"{torch.equal(a, b)}")
        out[name] = ok

    zpath = os.path.join(tmp, "estimator.zip")
    ModelSerializer.write_model(est.model_, zpath)
    same("zip", ModelGuesser.load_model_guess(zpath, device=device),
         ModelSerializer.restore_model(zpath, device=device), x)
    cpath = os.path.join(tmp, "estimator_conf.json")
    with open(cpath, "w") as f:
        f.write(est.model_.conf.to_json())
    same("config_json", ModelGuesser.load_model_guess(cpath, device=device),
         MultiLayerNetwork(ModelGuesser.load_config_guess(cpath),
                           device=device).init(), x)
    if hdf5 is None:
        out["h5"] = ("skipped: no libhdf5 on this host (the CPU tests "
                     "hold the .h5 guesses)")
        return out
    preds = np.load(os.path.join(KERAS_FIXTURES, "predictions.npz"))
    h5 = os.path.join(KERAS_FIXTURES, "real_cnn.h5")
    same("keras_h5", ModelGuesser.load_model_guess(h5, device=device),
         KerasModelImport.import_keras_model_and_weights(h5, device=device),
         preds["cnn_x"])
    try:
        ModelGuesser.load_model_guess(
            os.path.join(KERAS_FIXTURES, "real_cnn.weights.h5"),
            device=device)
        refused = False
    except ValueError:
        refused = True
    fails.check(refused, "import (d) a weights-only .h5 was not refused")
    out["weights_only_refused"] = refused
    return out


def phase_import_io(device, report, fails, small=False, hdf5="probe"):
    """Phase 24 on `device` (see the module docstring, 24 (a)-(e)):
    Keras import and the IO layer. `hdf5` is the libhdf5 soname to use
    ("probe": `modelimport.hdf5.libhdf5()`; None: this host has none,
    the route a host without it takes). Returns {"fused_adam":
    launches}."""
    import shutil
    import tempfile
    import deeplearning4j_tpu_torch.kernels as K
    from deeplearning4j_tpu_torch.modelimport import hdf5 as H5
    t_start = time.perf_counter()
    if hdf5 == "probe":
        hdf5 = H5.libhdf5()
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()
    out = dict(libhdf5=hdf5, gxx=gxx[0] if gxx else None)
    print(f"[import] libhdf5: {hdf5 or 'none of ' + ', '.join(H5.SONAMES)}"
          f" on this host; g++: {out['gxx']}", flush=True)
    parts = {}
    n0 = K.LAUNCHES["fused_adam"]
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="import_io_", dir=OUT_DIR)
    try:
        for part, fn, args in (
                ("a", _keras_real, (hdf5,)),
                ("b", _keras_resnet, (hdf5, small, tmp)),
                ("c", _csv_estimator, (small, tmp))):
            t0 = time.perf_counter()
            out[part] = fn(device, fails, *args)
            parts[part] = time.perf_counter() - t0
        out["c"], est = out["c"]
        t0 = time.perf_counter()
        out["d"] = _guesser(device, fails, hdf5, est, tmp)
        parts["d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["e"] = "S3: CPU tests only (no boto3 and no network here)"
    launches = K.LAUNCHES["fused_adam"] - n0
    out["launches"] = {"fused_adam": launches}
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_start
    report["import_io"] = out
    _print_import_io(out)
    return {"fused_adam": launches}


def _print_import_io(out):
    a = out["a"]
    if "skipped" in a:
        print(f"[import] (a) real Keras fixtures skipped: {a['skipped']}",
              flush=True)
    else:
        print(f"[import] (a) real Keras fixtures, max err against Keras's "
              f"predictions: { {k: v for k, v in a.items() if k != 'real_bn_fit'} }"
              f"; real_bn SGD fit card vs CPU {a['real_bn_fit']['diff']:.2e}"
              f" (losses {a['real_bn_fit']['card']})", flush=True)
    b = out["b"]
    ft = b["fine_tune"]
    print(f"[import] (b) ResNet-50 {b['size']}x{b['size']} via {b['route']}:"
          f" {b['tensors']} tensors, {b['floats']} floats, file "
          f"{b['file_mb']:.1f} MB; write {b['write_s']:.3f} s, read "
          f"{b['read_s']:.3f} s ({b['data_mb'] / b['read_s']:.1f} MB/s), "
          f"import {b['import_s']:.3f} s (CPU {b['cpu_import_s']:.3f} s), "
          f"output() at batch {IMPORT_B} {b['output_ms']:.3f} ms; card vs "
          f"CPU {b['output_rel']:.2e} of max|y| (pooled {b['features_rel']:.2e}"
          f"), top-1 equal {b['top1_equal']} (max prob {b['max_prob']:.4f}), "
          f"eps {b['eps']}", flush=True)
    print(f"[import] (b) compiled fine-tune ({b['output_layer']}) {ft['steps']}"
          f" steps at batch {ft['B']}: losses card {ft['loss_card']}, CPU "
          f"{ft['loss_cpu']}; step 0 rel {ft['step0_rel_err']:.2e}; fused "
          f"Adam {b.get('fused_adam_per_step')} a step (packed runs "
          f"{b['packed_runs']}); card {ft['card_s']:.2f}"
          f" s, CPU {ft['cpu_s']:.2f} s", flush=True)
    c = out["c"]
    print(f"[import] (c) CSV {c['mb']:.1f} MB (write {c['write_s']:.2f} s, "
          f"shim {c['native']}, built in {c['build_s']:.2f} s): parse "
          f"{c['parse_s']:.3f} s, {c['mb_per_s']:.1f} MB/s, "
          f"{c['rows_per_s']:.0f} rows/s, bit-equal {c['bit_equal']}, "
          f"quirks {c['quirks_equal']}; estimator {c['train']} rows x 1 "
          f"epoch ({c['steps']} steps, fused Adam {c['fused_adam']}): "
          f"{c['epoch_s']:.3f} s (CPU {c['cpu_epoch_s']:.3f} s), first loss "
          f"diff {c['first_loss_diff']:.2e}, held-out accuracy "
          f"{c['score']:.4f} (CPU {c['cpu_score']:.4f}, predictions agree "
          f"{c['predict_agreement']:.4f})", flush=True)
    print(f"[import] (d) ModelGuesser: {out['d']}; (e) {out['e']}",
          flush=True)
    print(f"[import] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 2) for k, v in out['part_seconds'].items()} })",
          flush=True)


# ------------------------------------------------------------------ phase 25
UI = dict(cfg=None, B=16, steps=8, timed=4, lenet_B=128,
          lenet_steps=2, n_slots=4, block_len=16, requests=4, prompt=16,
          tokens=16, tsne_steps=10)
UI_SMALL = dict(UI, cfg=dict(LM, d_model=64, n_heads=4, n_layers=2,
                             max_len=32),
                B=2, timed=2, lenet_B=16, tokens=4, prompt=4)
# (a) step 0's report card vs CPU, relative: the gradient magnitudes at
# GRAD_RTOL; param and update magnitudes and update:param ratios wider.
# Adam's first step is lr g / (|g| + eps): an element whose gradient is
# near eps moves by up to lr with the card's last-bit differences in g,
# so a leaf's mean |update| and mean |param| move with the few such
# elements (measured on an H100 80GB HBM3 at 700 W: 1.9e-4 and 5.3e-6
# at 4_attn_Wq and 4_attn_Wo, gradients 4.2e-6). They are held at
# TRAIN_PARAM_RTOL and a tenth of it. The key biases (`*_attn_bk`) train on noise
# (TRAIN_PARAM_RTOL's note): their magnitudes are held to Adam's step
# bound, their gradients and histograms are not compared
UI_PARAM_RTOL = TRAIN_PARAM_RTOL / 10
UI_UPDATE_RTOL = TRAIN_PARAM_RTOL
UI_HIST_EDGE_RTOL = 1e-5  # (a) a param this near a bin edge (of the range)
                          # may fall in either neighbour, card vs CPU
UI_GRAY_ATOL = 1         # (d) activation grids, card vs CPU, gray levels
UI_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
              "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "fused_adam")
UI_SESSION = "smoke_lm"
UI_ROUTES = ("/", "/train", "/train/overview", "/train/model",
             "/train/system", "/tsne", "/activations", "/profile",
             "/serving", "/events", "/alerts", "/metrics", "/api/sessions",
             "/api/profile", "/events?format=json", "/alerts?format=json",
             "/train/overview?lang=ja")
# the pages that list the storage's sessions
UI_SESSION_PAGES = ("/", "/train", "/train/overview", "/train/model",
                    "/train/system", "/api/sessions",
                    "/train/overview?lang=ja")

# a child process (argv: the repo root) imports the port, then reads
# "<sqlite path>\t<session>\t<URL>" from its stdin and posts every report
# of the session to that UIServer's /remote; started at the phase's
# start, so its interpreter and torch load while the card trains
_UI_REMOTE_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                         RemoteUIStatsStorageRouter)
db, session, url = sys.stdin.readline().rstrip("\n").split("\t")
router = RemoteUIStatsStorageRouter(url)
for report in FileStatsStorage(db).get_reports(session):
    router.put_report(report)
"""


class _TeeStorage:
    """A StatsStorage that keeps each report object it is given and
    passes it on to `inner`."""

    def __init__(self, inner):
        self.inner, self.reports = inner, []

    def put_report(self, report):
        self.reports.append(report)
        self.inner.put_report(report)


def png_pixels(png: bytes) -> np.ndarray:
    """The [H, W] uint8 pixels of an 8-bit grayscale PNG whose scanlines
    are unfiltered (the form `ui.convolutional.png_gray` writes)."""
    import struct
    import zlib
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w = 8, b"", None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[:10])
            if (depth, color) != (8, 0):
                raise ValueError(f"not 8-bit grayscale: {depth}, {color}")
        elif kind == b"IDAT":
            idat += data
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError("a filtered scanline")
    return rows[:, 1:].copy()


def _ui_finite(r) -> bool:
    vals = [r.score, r.memory_rss_mb]
    for table in (r.param_mean_magnitudes, r.update_mean_magnitudes,
                  r.gradient_mean_magnitudes, r.update_ratios):
        vals += list(table.values())
    for st in r.activation_stats.values():
        vals += list(st)
    for edges, _ in r.param_histograms.values():
        vals += list(edges)
    return bool(np.isfinite(vals).all())


def _ui_edge_ties(arr, edges, rtol):
    """Values within rtol (of the range) of an inner edge."""
    inner = np.asarray(edges[1:-1]).reshape(1, -1)
    scale = max(abs(edges[0]), abs(edges[-1]))
    d = np.abs(np.asarray(arr, np.float64).reshape(-1, 1) - inner)
    return int(np.sum(d.min(axis=1) <= rtol * scale))


def _ui_reports(device, fails, cfg, c, params, X, Y, db, reg):
    """(a) 8 steps of the smoke LM on the card with diagnostics, a
    StatsListener with host histograms into a FileStatsStorage; step 0's
    report against the port's CPU run of the same step; every report
    finite, every histogram summing to its leaf's size; the file
    reopened. Returns (out, the card net)."""
    import torch
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                             InMemoryStatsStorage,
                                             StatsListener)
    from deeplearning4j_tpu_torch.ui.stats import param_tree
    B, n = c["B"], c["steps"]
    tee = _TeeStorage(FileStatsStorage(db))
    net = build_lm(cfg, device, params, diagnostics=True)
    net.set_listeners(StatsListener(tee, session_id=UI_SESSION,
                                    collect_histograms=True))
    t0 = time.perf_counter()
    net.fit(X[:n * B], Y[:n * B], epochs=1, batch_size=B, shuffle=False)
    _sync(device)
    card_s = time.perf_counter() - t0
    reps = tee.reports
    # the monitor's count of the card run's steps (the CPU's step after
    # it counts too)
    iters = (reg.counter("training_iterations_total", model="default").value
             if reg is not None else None)
    cpu = build_lm(cfg, "cpu", params, diagnostics=True)
    mem = InMemoryStatsStorage()
    cpu.set_listeners(StatsListener(mem, session_id=UI_SESSION,
                                    collect_histograms=True))
    t0 = time.perf_counter()
    cpu.fit(X[:B], Y[:B], epochs=1, batch_size=B, shuffle=False)
    cpu_s = time.perf_counter() - t0
    want, got = mem.get_reports(UI_SESSION)[0], reps[0]
    sizes = {f"{lk}_{pk}": t.numel() for lk, lp in param_tree(net).items()
             for pk, t in lp.items()}
    out = dict(steps=len(reps), card_s=card_s, cpu_s=cpu_s,
               iterations=[r.iteration for r in reps], leaves=len(sizes))
    keys_equal = all(
        list(getattr(got, f)) == list(getattr(want, f))
        for f in ("param_mean_magnitudes", "update_mean_magnitudes",
                  "gradient_mean_magnitudes", "update_ratios",
                  "activation_stats", "param_histograms"))
    fails.check(keys_equal and set(got.param_mean_magnitudes) == set(sizes)
                and len(got.activation_stats) > 0,
                f"ui (a): step 0's keys differ from the CPU's: "
                f"{sorted(got.param_mean_magnitudes)} against "
                f"{sorted(want.param_mean_magnitudes)}")
    rel = {}
    for f, tol in (("param_mean_magnitudes", UI_PARAM_RTOL),
                   ("update_mean_magnitudes", UI_UPDATE_RTOL),
                   ("update_ratios", UI_UPDATE_RTOL),
                   ("gradient_mean_magnitudes", GRAD_RTOL)):
        g, w = getattr(got, f), getattr(want, f)
        worst = max((abs(g[k] - w[k]) / max(abs(w[k]), 1e-30), k)
                    for k in w if not k.endswith("_attn_bk"))
        rel[f] = worst[0]
        fails.check(worst[0] <= tol, f"ui (a): step 0 {f} card vs CPU "
                    f"{worst[0]:.3e} at {worst[1]} > {tol}")
    out["step0_rel"] = rel
    # the key biases: each element moves at most one Adam step on each
    # side, so their mean |p| and mean |update| differ by at most that
    bk = [k for k in want.param_mean_magnitudes if k.endswith("_attn_bk")]
    bk_abs = max([abs(got.param_mean_magnitudes[k]
                      - want.param_mean_magnitudes[k]) for k in bk]
                 + [abs(got.update_mean_magnitudes[k]
                        - want.update_mean_magnitudes[k]) for k in bk]
                 + [0.0])
    out["step0_attn_bk_abs"] = bk_abs
    fails.check(bk_abs <= 2 * adam_step_max(),
                f"ui (a): step 0 attn_bk magnitudes card vs CPU {bk_abs} > "
                f"{2 * adam_step_max()}")
    out["score_card_cpu"] = [got.score, want.score]
    # host histograms: step 0 bin for bin but for near-edge ties (counted
    # on the CPU's params), later reports by their count sums
    cpu_host = {f"{lk}_{pk}": t.detach().numpy()
                for lk, lp in param_tree(cpu).items()
                for pk, t in lp.items()}
    moved = ties = 0
    for k, (edges, counts) in got.param_histograms.items():
        if k.endswith("_attn_bk"):
            continue
        wedges, wcounts = want.param_histograms[k]
        fails.check(np.allclose(edges, wedges, rtol=1e-6,
                                atol=1e-7 * max(abs(wedges[0]),
                                                abs(wedges[-1]))),
                    f"ui (a): step 0 histogram edges of {k} differ")
        m = int(np.abs(np.subtract(counts, wcounts)).sum())
        if m:
            moved += m
            ties += _ui_edge_ties(cpu_host[k], wedges, UI_HIST_EDGE_RTOL)
    out["step0_hist_moved"], out["step0_hist_edge_ties"] = moved, ties
    fails.check(moved <= 2 * ties, f"ui (a): step 0 histograms moved "
                f"{moved} counts with {ties} near-edge values")
    sums_ok = all(sum(cnt) == sizes[k] for r in reps
                  for k, (_, cnt) in r.param_histograms.items())
    finite = all(_ui_finite(r) for r in reps)
    fails.check(sums_ok and finite and out["iterations"] == list(range(n)),
                f"ui (a): reports {out['iterations']}, finite {finite}, "
                f"histograms sum to their leaves {sums_ok}")
    back = FileStatsStorage(db).get_reports(UI_SESSION)
    out["reopened_equal"] = [r.encode() for r in back] == \
        [r.encode() for r in reps]
    fails.check(out["reopened_equal"], "ui (a): the reopened stats file "
                "decodes to other reports")
    out["report_bytes"] = len(reps[-1].encode())
    out["last"] = dict(score=reps[-1].score,
                       mean_ratio=float(np.mean(list(
                           reps[-1].update_ratios.values()))))
    out["training_iterations_total"] = iters
    return out, net


def _ui_costs(device, fails, net, X, Y, c, db):
    """(b) ms/step and hand-written launches a step of the card net's
    `fit` with no listener, with a StatsListener into memory, and into
    the sqlite file with host histograms (diagnostics stay on in all
    three), in turns off, memory, file, file, memory, off."""
    import deeplearning4j_tpu_torch.kernels as K
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                             InMemoryStatsStorage,
                                             StatsListener)
    B, k = c["B"], c["timed"]
    stores = {"memory": InMemoryStatsStorage(), "file": FileStatsStorage(db)}

    def listeners(mode):
        if mode == "off":
            return []
        return [StatsListener(stores[mode], session_id=f"ui_cost_{mode}",
                              collect_histograms=mode == "file")]

    times = {m: [] for m in ("off", "memory", "file")}
    launches = {}
    for mode in ("off", "memory", "file", "file", "memory", "off"):
        net.set_listeners(*listeners(mode))
        net.fit(X[:B], Y[:B], epochs=1, batch_size=B, shuffle=False)
        _sync(device)
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        net.fit(X[B:(1 + k) * B], Y[B:(1 + k) * B], epochs=1,
                batch_size=B, shuffle=False)
        _sync(device)
        times[mode].append((time.perf_counter() - t0) / k * 1e3)
        launches[mode] = {n: (K.LAUNCHES.get(n, 0) - before.get(n, 0)) / k
                          for n in UI_KERNELS}
    net.set_listeners()
    out = {m: dict(ms_per_step=float(np.median(t)), runs=t,
                   launches_per_step=launches[m]) for m, t in times.items()}
    out["report_bytes"] = {
        m: len(stores[m].get_reports(f"ui_cost_{m}")[-1].encode())
        for m in stores}
    fails.check(all(np.isfinite(v["ms_per_step"]) for v in
                    (out["off"], out["memory"], out["file"]))
                and launches["off"] == launches["memory"] == launches["file"],
                f"ui (b): launches a step differ between modes: {launches}")
    return out


def _ui_get(base, path):
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(base + path, timeout=60) as r:
        body, code = r.read(), r.status
    return code, body, (time.perf_counter() - t0) * 1e3


def _ui_dashboard(device, fails, base, db, c, child):
    """(c) every route 200 (the session on each page that lists
    sessions), the API's reports and components, the training families
    on /metrics, no other device's report on /profile, and the reports
    posted from a child process to a second server's /remote."""
    import torch
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage, UIServer,
                                             component_from_json)
    out, pages = {}, {}
    for path in UI_ROUTES + (f"/api/reports/{UI_SESSION}",
                             f"/api/components/{UI_SESSION}"):
        code, body, ms = _ui_get(base, path)
        pages[path] = dict(code=code, bytes=len(body), ms=ms)
        fails.check(code == 200, f"ui (c): GET {path} gave {code}")
        if path in UI_SESSION_PAGES:
            fails.check(UI_SESSION in body.decode(),
                        f"ui (c): {path} does not list {UI_SESSION}")
    out["pages"] = pages
    api = json.loads(_ui_get(base, f"/api/reports/{UI_SESSION}")[1])
    out["api_iterations"] = [r["iteration"] for r in api]
    fails.check(out["api_iterations"] == list(range(c["steps"])),
                f"ui (c): /api/reports gave {out['api_iterations']}")
    chart = component_from_json(
        _ui_get(base, f"/api/components/{UI_SESSION}")[1].decode())
    fails.check(len(chart.series) == 1 and len(chart.series[0][1]) ==
                c["steps"], "ui (c): /api/components did not decode to "
                "the score chart")
    metrics = _ui_get(base, "/metrics")[1].decode()
    fams = ("training_iterations_total", "training_score",
            "training_update_ratio", "training_grad_l2")
    out["metrics_families"] = {f: f in metrics for f in fams}
    fails.check(all(out["metrics_families"].values()),
                f"ui (c): /metrics lacks {out['metrics_families']}")
    prof = _ui_get(base, "/profile")[1].decode()
    reports = json.loads(_ui_get(base, "/api/profile")[1])
    kind = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    foreign = [m for m, r in reports.items()
               if str((r.get("roofline") or {}).get(
                   "device_kind", kind)) != kind]
    out["profile"] = dict(reports=sorted(reports), foreign=foreign,
                          tpu_on_page="tpu" in prof.lower())
    fails.check(not foreign and not out["profile"]["tpu_on_page"],
                f"ui (c): /profile shows another device's report "
                f"{out['profile']}")
    second = UIServer().start()
    try:
        t0 = time.perf_counter()
        _, err = child.communicate(
            f"{db}\t{UI_SESSION}\thttp://127.0.0.1:{second.port}\n",
            timeout=300)
        out["remote_s"] = time.perf_counter() - t0
        posted = second.storage.get_reports(UI_SESSION)
    finally:
        second.stop()
    want = FileStatsStorage(db).get_reports(UI_SESSION)
    out["remote_equal"] = (child.returncode == 0 and
                           [r.encode() for r in posted] ==
                           [r.encode() for r in want])
    fails.check(out["remote_equal"], f"ui (c): the reports posted to "
                f"/remote differ (child rc {child.returncode}: "
                f"{err[-2000:]})")
    return out


def _ui_activations(device, fails, server, base, c, tmp):
    """(d) LeNet on phase 12's digits, 2 steps on the card with a
    ConvolutionalIterationListener into `tmp` and the server: the last
    step's grids against the CPU's for the same params and example, the
    PNGs decoding to them, /activations serving them."""
    from deeplearning4j_tpu_torch.ui import ConvolutionalIterationListener
    from deeplearning4j_tpu_torch.ui.convolutional import activations_to_grid
    from deeplearning4j_tpu_torch.zoo import LeNet
    B, n = c["lenet_B"], c["lenet_steps"]
    X, Y = digits_28x28()
    net = LeNet().init(device=device)
    net.set_listeners(ConvolutionalIterationListener(
        output_dir=tmp, frequency=1, ui_server=server))
    t0 = time.perf_counter()
    net.fit(X[:n * B], Y[:n * B], epochs=1, batch_size=B, shuffle=False)
    _sync(device)
    out = dict(fit_s=time.perf_counter() - t0)
    x0 = X[(n - 1) * B:(n - 1) * B + 1]      # the last batch's first digit

    def grids(model):
        return {f"layer{li}": activations_to_grid(
                    a[0].float().cpu().numpy())
                for li, a in enumerate(model.feed_forward(x0))
                if a.ndim == 4}
    card, cpu = grids(net), grids(_copy_to(net, "cpu"))
    names = sorted(server._activations)
    out["grids"] = {k: list(v.shape) for k, v in card.items()}
    diff = max(int(np.abs(card[k].astype(np.int16) - cpu[k]).max())
               for k in card)
    out["max_gray_diff"] = diff
    png_ok = all(np.array_equal(png_pixels(server._activations[k]), card[k])
                 and np.array_equal(png_pixels(open(os.path.join(
                     tmp, f"iter{n - 1:06d}_{k}.png"), "rb").read()),
                     card[k]) for k in card)
    html = _ui_get(base, "/activations")[1].decode()
    served = all(k in html and _ui_get(base, f"/activations/img/{k}")[1]
                 == server._activations[k] for k in card)
    out.update(png_equal=png_ok, served=served, names=names,
               files=len(os.listdir(tmp)))
    fails.check(names == sorted(card) and len(card) >= 2
                and diff <= UI_GRAY_ATOL and png_ok and served
                and out["files"] == n * len(card),
                f"ui (d): grids {names} against {sorted(card)}, card vs "
                f"CPU {diff} gray levels, PNGs {png_ok}, served {served}, "
                f"files {out['files']}")
    return out


def _ui_serving(device, fails, server, base, net, cfg, c, tsne):
    """(e) 4 greedy requests through a monitored GenerationServer: the
    /serving rows against the server's own results; the t-SNE map
    posted and rendered."""
    from deeplearning4j_tpu_torch.serving import GenerationServer
    rng = np.random.default_rng(251)
    prompts = [rng.integers(0, cfg["vocab"], c["prompt"])
               for _ in range(c["requests"])]
    srv = GenerationServer(net, n_slots=c["n_slots"], n_blocks=16 *
                           c["n_slots"], block_len=c["block_len"],
                           device=device).start()
    try:
        t0 = time.perf_counter()
        streams = [srv.generate_async(p, c["tokens"]) for p in prompts]
        results = [s.result(timeout=300) for s in streams]
        serve_s = time.perf_counter() - t0
    finally:
        srv.stop()
    html = _ui_get(base, "/serving")[1].decode()

    def row(name):
        m = re.search(rf"<tr><td>{re.escape(name)}</td><td>(\d+)</td>", html)
        return int(m.group(1)) if m else None
    out = dict(requests=row("requests admitted"),
               tokens=row("tokens emitted"), serve_s=serve_s,
               own=dict(requests=len(results),
                        tokens=sum(len(r) for r in results)))
    fails.check(out["requests"] == out["own"]["requests"] == c["requests"]
                and out["tokens"] == out["own"]["tokens"]
                == c["requests"] * c["tokens"],
                f"ui (e): /serving shows {out['requests']} requests and "
                f"{out['tokens']} tokens, the server {out['own']}")
    coords, source = tsne
    server.post_tsne(source, coords)
    page = _ui_get(base, "/tsne")[1].decode()
    out["tsne"] = dict(source=source, points=len(coords),
                       circles=page.count("<circle"))
    fails.check(out["tsne"]["circles"] == len(coords) > 0,
                f"ui (e): /tsne drew {out['tsne']['circles']} of "
                f"{len(coords)} points")
    return out


def _ui_tsne_map(device, c):
    """A few exact t-SNE steps on the packaged word2vec vectors (1032 x
    64), when phase 23 has not made its map."""
    import torch
    from deeplearning4j_tpu_torch.nlp.word2vec import load_packaged_word2vec
    from deeplearning4j_tpu_torch.plot import Tsne
    x = np.asarray(load_packaged_word2vec(device=torch.device("cpu")).syn0,
                   np.float64)
    ts = Tsne(device=device)
    y, _, _ = ts.descend(ts.input_affinities(x), ts.initial_map(len(x)),
                         c["tsne_steps"])
    return y, f"packaged word2vec, {c['tsne_steps']} exact steps"


def phase_ui(device, report, fails, small=False, tsne=None):
    """Phase 25 on `device` (see the module docstring, 25 (a)-(e)): the
    training UI watching the smoke LM train. `tsne` is phase 23's map
    (coords, source); made here from the packaged vectors when None.
    Returns the phase's kernel launches."""
    import shutil
    import tempfile
    import deeplearning4j_tpu_torch.kernels as K
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import AlertEngine, default_rule_pack
    from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.monitor.tracer import Tracer
    from deeplearning4j_tpu_torch.ui import FileStatsStorage, UIServer
    c = UI_SMALL if small else UI
    cfg = c["cfg"] or LM
    t_start = time.perf_counter()
    out = dict(config=dict(cfg, B=c["B"], T=cfg["max_len"] - 1,
                           steps=c["steps"]))
    parts = {}
    root = os.path.join(HERE, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ui_", dir=root)
    db = os.path.join(tmp, "stats.db")
    params = random_lm_params(cfg, seed=250, head_scale=1.0)
    X, Y = lm_corpus(cfg, c["B"] * c["steps"], seed=25)
    reg, tracer = MetricsRegistry(), Tracer()
    server = None
    child = subprocess.Popen([sys.executable, "-c", _UI_REMOTE_CHILD, HERE],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    K.reset_launches()
    try:
        t0 = time.perf_counter()
        monitor.enable(registry=reg, tracer=tracer, jit_compile=False)
        try:
            out["a"], net = _ui_reports(device, fails, cfg, c, params, X, Y,
                                        db, reg)
        finally:
            monitor.disable()
        parts["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b"] = _ui_costs(device, fails, net, X, Y, c, db)
        parts["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = AlertEngine(reg, default_rule_pack(), registry=reg)
        eng.evaluate()
        server = UIServer(registry=reg).attach(
            FileStatsStorage(db)).attach_alerts(eng).start()
        base = f"http://127.0.0.1:{server.port}"
        out["c"] = _ui_dashboard(device, fails, base, db, c, child)
        parts["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["d"] = _ui_activations(device, fails, server, base, c,
                                   os.path.join(tmp, "grids"))
        parts["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if tsne is None:
            tsne = _ui_tsne_map(device, c)
        monitor.enable(registry=reg, tracer=tracer, jit_compile=False)
        try:
            out["e"] = _ui_serving(device, fails, server, base, net, cfg, c,
                                   tsne)
        finally:
            monitor.disable()
            monitor._STATE.registry = monitor.GLOBAL_REGISTRY
            monitor._STATE.tracer = monitor.GLOBAL_TRACER
        parts["e"] = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: K.LAUNCHES.get(k, 0) for k in KERNEL_META}
    if device.type == "cuda":
        _launched(fails, "ui", launches, UI_KERNELS)
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_start
    report["ui"] = out
    _print_ui(out)
    return launches


def _print_ui(out):
    a, b, c, d, e = (out[k] for k in "abcde")
    print(f"[ui] (a) {a['steps']} steps of {out['config']['B']}x"
          f"{out['config']['T']} with diagnostics and a StatsListener into "
          f"sqlite: card {a['card_s']:.2f} s, the CPU's step 0 "
          f"{a['cpu_s']:.2f} s; step 0 card vs CPU "
          f"{ {k: f'{v:.2e}' for k, v in a['step0_rel'].items()} } "
          f"(attn_bk {a['step0_attn_bk_abs']:.2e} abs), "
          f"histograms moved {a['step0_hist_moved']} counts "
          f"({a['step0_hist_edge_ties']} near-edge values); "
          f"{a['leaves']} leaves, report {a['report_bytes']} bytes, "
          f"reopened equal {a['reopened_equal']}", flush=True)
    print(f"[ui] (b) fit ms/step: no listener {b['off']['ms_per_step']:.3f},"
          f" in-memory {b['memory']['ms_per_step']:.3f}, sqlite + host "
          f"histograms {b['file']['ms_per_step']:.3f} (runs "
          f"{ {m: [round(t, 3) for t in b[m]['runs']] for m in ('off', 'memory', 'file')} }"
          f"); launches a step {b['off']['launches_per_step']}; report "
          f"bytes {b['report_bytes']}", flush=True)
    slow = max(c["pages"].items(), key=lambda kv: kv[1]["ms"])
    print(f"[ui] (c) {len(c['pages'])} routes 200; page ms median "
          f"{np.median([p['ms'] for p in c['pages'].values()]):.2f}, "
          f"slowest {slow[0]} {slow[1]['ms']:.2f} ({slow[1]['bytes']} "
          f"bytes); /profile {c['profile']}; /remote from a child "
          f"{c['remote_s']:.2f} s, equal {c['remote_equal']}", flush=True)
    print(f"[ui] (d) LeNet grids {d['grids']}: card vs CPU "
          f"{d['max_gray_diff']} gray levels, PNGs equal {d['png_equal']},"
          f" served {d['served']}; fit {d['fit_s']:.2f} s", flush=True)
    print(f"[ui] (e) /serving {e['requests']} requests, {e['tokens']} "
          f"tokens (server {e['own']}), {e['serve_s']:.2f} s; /tsne "
          f"{e['tsne']}", flush=True)
    print(f"[ui] {out['seconds']:.1f} s (parts "
          f"{ {k: round(v, 2) for k, v in out['part_seconds'].items()} }); "
          f"launches {out['launches']}", flush=True)


# ------------------------------------------------------------- phase 26
# (a) the serving load test at the smoke LM's widths (LM): only the
# traffic is cut (32 streams, JAX's default is 128); (c) the online and
# tenant drills at their own (JAX's) drill widths; (d) the examples with
# the steps cut through their module constants (DRIVER_EXAMPLE_CUTS)
DRIVERS = dict(
    serving=["--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
             "--n-layers", str(LM["n_layers"]), "--n-heads",
             str(LM["n_heads"]), "--n-slots", "8", "--block-len", "16",
             "--prompt-len", "16", "--n-tokens", "32", "--streams", "32",
             "--min-weight-reduction", "3.5"],
    online=[], tenant=[])
DRIVERS_SMALL = dict(
    serving=["--vocab", "101", "--d-model", "16", "--n-layers", "2",
             "--n-heads", "4", "--n-slots", "4", "--block-len", "4",
             "--prompt-len", "4", "--n-tokens", "8", "--streams", "16",
             "--steps-per-dispatch", "4", "--min-weight-reduction", "2.5"],
    online=[], tenant=["--traffic-inflight", "3"])
# the parts of the serving load test phase 26 skips: the fleet and the
# replicas run in phase 20, speculation, the shared prefix and radix in
# phase 8 (each mode also ran once alone: PERF.md)
DRIVER_SKIPS = ["--skip-fleet", "--skip-replicated", "--skip-spec"]
# (module constant, value) cuts of each example in phase 26: steps only
DRIVER_EXAMPLE_CUTS = {
    "char_lstm": dict(EPOCHS=4, SAMPLE_CHARS=40),
    "chinese_word2vec": {},
    "word2vec_basic": {},
    "distributed_training": dict(EPOCHS=5),
    "keras_import_pretrained": {},
    "long_context": {},
    "mnist_cnn": dict(N_TRAIN=2048, N_TEST=1000, EPOCHS=1),
    "object_detection": dict(EPOCHS=20),
    "training_diagnostics": {},
    "transfer_and_serve": dict(BASE_EPOCHS=10),
    "transformer_generate": dict(EPOCHS=1),
    "transformer_text": dict(EPOCHS=4),
}
DRIVER_EXAMPLE_CUTS_SMALL = {
    "char_lstm": dict(EPOCHS=1, SAMPLE_CHARS=10),
    "chinese_word2vec": dict(EPOCHS=1),
    "word2vec_basic": dict(EPOCHS=1),
    "distributed_training": dict(EPOCHS=2),
    "keras_import_pretrained": dict(FINETUNE_EPOCHS=1, N_EVAL=64),
    "long_context": dict(EPOCHS=1),
    "mnist_cnn": dict(N_TRAIN=256, N_TEST=256, EPOCHS=1),
    "object_detection": dict(EPOCHS=2, N_TRAIN=32),
    "training_diagnostics": dict(EPOCHS=1),
    "transfer_and_serve": dict(BASE_EPOCHS=2, TUNE_EPOCHS=1),
    "transformer_generate": dict(EPOCHS=1, SAMPLE_TOKENS=4, BEAM_TOKENS=4),
    "transformer_text": dict(EPOCHS=1, N_EXAMPLES=128),
}
DRIVER_KERNELS = ("layer_norm", "residual_layer_norm", "flash_attention_fwd",
                  "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                  "fused_adam")


def phase_drivers(device, report, fails, small=False):
    """Phase 26 on `device` (see the module docstring, 26 (a)-(d)): the
    repository's drivers and examples on the port. The fault drill (b)
    runs as a subprocess beside (a), as a user runs it. Returns the
    phase's kernel launches (in this process: (a), (c), (d))."""
    import importlib
    import deeplearning4j_tpu_torch.kernels as K
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.scripts import (
        online_loop, serve_loadtest, tenant_loadtest)
    c = DRIVERS_SMALL if small else DRIVERS
    cuts = DRIVER_EXAMPLE_CUTS_SMALL if small else DRIVER_EXAMPLE_CUTS
    dev = str(device)
    t_start = time.perf_counter()
    out, parts, by_part = {}, {}, {}
    ledgers = os.path.join(OUT_DIR, "drivers")
    os.makedirs(ledgers, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    drill = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.scripts.fault_drill",
         "--smoke", "--with-corruption", "--device", dev],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    t_drill = time.perf_counter()
    total = {k: 0 for k in KERNEL_META}

    def part(name, fn):
        K.reset_launches()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            parts[name] = time.perf_counter() - t0
            by_part[name] = {k: v for k, v in K.LAUNCHES.items() if v}
            for k in total:
                total[k] += K.LAUNCHES.get(k, 0)
            monitor.disable()

    try:
        # (a) the serving load test, in process, at the smoke LM's width
        path = os.path.join(ledgers, "serving.json")
        rc = part("a", lambda: serve_loadtest.main(
            c["serving"] + DRIVER_SKIPS + ["--device", dev, "--out", path]))
        fails.check(rc == 0, f"drivers (a) serve_loadtest exited {rc}")
        out["a"] = _drivers_serving(fails, path, small)

        # (c) the online and tenant drills, in process
        path = os.path.join(ledgers, "online.json")
        rc = part("c_online", lambda: online_loop.main(
            ["--smoke", "--device", dev, "--out", path] + c["online"]))
        fails.check(rc == 0, f"drivers (c) online_loop exited {rc}")
        with open(path) as f:
            v = json.load(f)
        out["c_online"] = dict(
            publishes=v["train"]["published_versions"],
            swaps=v["serving"]["swaps"], dropped=v["serving"]["dropped"],
            trips=v["train"]["drift_trips"],
            gated=v["train"]["publishes_gated"],
            streams=v["serving"]["streams_total"],
            parity=v["serving"]["parity"], platform=v["platform"])
        fails.check(out["c_online"]["dropped"] == 0,
                    f"drivers (c) online dropped "
                    f"{out['c_online']['dropped']} streams")
        path = os.path.join(ledgers, "tenancy.json")
        rc = part("c_tenant", lambda: tenant_loadtest.main(
            ["--smoke", "--device", dev, "--out", path] + c["tenant"]))
        fails.check(rc == 0, f"drivers (c) tenant_loadtest exited {rc}")
        out["c_tenant"] = _drivers_tenant(fails, path)

        # (d) the examples on the device, steps cut by module constants
        out["d"] = {}
        for name, cut in cuts.items():
            mod = importlib.import_module(
                f"deeplearning4j_tpu_torch.examples.{name}")
            saved = {k: getattr(mod, k) for k in cut}
            for k, v in cut.items():
                setattr(mod, k, v)
            try:
                part(f"d_{name}", lambda: mod.main(["--device", dev]))
                out["d"][name] = dict(ok=True, cut=cut,
                                      seconds=parts[f"d_{name}"])
            except Exception as e:  # noqa: BLE001 — recorded, fails below
                traceback.print_exc()
                out["d"][name] = dict(ok=False, cut=cut, error=repr(e))
                fails.append(f"drivers (d) example {name} raised {e!r}")
            finally:
                for k, v in saved.items():
                    setattr(mod, k, v)

        # (b) the fault drill's process, started with (a)
        stdout, stderr = drill.communicate(timeout=600)
        parts["b"] = time.perf_counter() - t_drill
        out["b"] = _drivers_drill(fails, drill.returncode, stdout, stderr)
    finally:
        if drill.poll() is None:
            drill.kill()
            drill.wait()
    if device.type == "cuda":
        _launched(fails, "drivers", total, DRIVER_KERNELS)
    out["launches"] = {k: v for k, v in total.items() if v}
    out["launches_by_part"] = by_part
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_start
    report["drivers"] = out
    _print_drivers(out)
    return total


def _drivers_serving(fails, path, small):
    """(a)'s ledger: JAX's blocks, every phase's numbers."""
    with open(path) as f:
        rec = json.load(f)
    s = rec["extras"]["serving"]
    q = rec["extras"]["serving_mixed_quantized"]
    fails.check(q["weight_bytes_reduction"] >= (2.5 if small else 3.5),
                f"drivers (a) int8 weight-byte reduction "
                f"{q['weight_bytes_reduction']}")
    fails.check(s["overload_shed"] >= 1, "drivers (a) overload shed nothing")
    return dict(platform=rec["platform"], tok_s=s["tokens_per_sec"],
                seq_tok_s=s["sequential_tokens_per_sec"],
                speedup=s["speedup_vs_sequential"],
                ttft_p50_ms=s["p50_ttft_ms"], ttft_p99_ms=s["p99_ttft_ms"],
                int8_tok_s=q["tokens_per_sec"],
                int8_ttft_p99_ms=q["p99_ttft_ms"],
                reduction=q["weight_bytes_reduction"],
                mm_reduction=q["matmul_weight_bytes_reduction"],
                shed=s["overload_shed"], served=s["overload_served"],
                parity=s["greedy_parity"],
                q_parity=q["greedy_parity_vs_quantized_generate"],
                near_ties=rec.get("near_ties"),
                admitted=(q["admitted_incremental"], q["admitted_upfront"]),
                goodput=rec["extras"]["goodput"]["goodput_fraction"])


def _drivers_tenant(fails, path):
    """(c)'s tenant ledger: publishes, swaps, drops, the gate."""
    with open(path) as f:
        t = json.load(f)["extras"]["serving_tenancy"]
    fails.check(t["dropped"] == 0,
                f"drivers (c) tenant dropped {t['dropped']} streams")
    return dict(publishes=t["online_adapter_publishes"], swaps=t["swaps"],
                dropped=t["dropped"], trips=t["drift"]["trips"],
                gated=t["drift"]["publishes_gated"],
                base_copies=t["shared_base_copies"], parity=t["parity"],
                light_share=t["fair_share"]["light_share"])


def _drivers_drill(fails, rc, stdout, stderr):
    """(b): the drill's exit code and its last line's verdict."""
    last = next((ln for ln in reversed(stdout.strip().splitlines())
                 if ln.startswith("{")), "{}")
    rep = json.loads(last).get("fault_drill", {})
    fails.check(rc == 0 and rep.get("ok") is True,
                f"drivers (b) fault drill rc {rc}: {rep.get('error')} "
                f"{stderr[-1500:]}")
    return dict(rc=rc, ok=rep.get("ok"), restarts=rep.get("restarts"),
                kill_to_resume_s=rep.get("kill_to_resume_s"),
                committed_at_kill=rep.get("committed_at_kill"),
                reference_s=rep.get("reference_s"),
                platform=rep.get("device"))


def _print_drivers(out):
    a, b = out.get("a", {}), out.get("b", {})
    if a:
        print(f"[drivers] (a) serve_loadtest on {a['platform']}: continuous "
              f"{a['tok_s']} tok/s, sequential {a['seq_tok_s']} "
              f"({a['speedup']}x), TTFT p50 {a['ttft_p50_ms']} ms p99 "
              f"{a['ttft_p99_ms']} ms; int8 {a['int8_tok_s']} tok/s, "
              f"weight bytes {a['reduction']}x (matmul "
              f"{a['mm_reduction']}x); shed {a['shed']}/"
              f"{a['shed'] + a['served']}; parity {a['parity']} / "
              f"{a['q_parity']}; admits {a['admitted']}; goodput "
              f"{a['goodput']}; {out['part_seconds']['a']:.2f} s",
              flush=True)
    if b:
        ktr = b.get("kill_to_resume_s")
        print(f"[drivers] (b) fault_drill --smoke --with-corruption: rc "
              f"{b['rc']}, bit-identical {b['ok']}, restarts "
              f"{b['restarts']}, kill to first resumed step "
              f"{ktr if ktr is None else round(ktr, 3)} s, committed at "
              f"the kill {b['committed_at_kill']}; "
              f"{out['part_seconds']['b']:.2f} s (its process beside (a), "
              f"(c), (d))",
              flush=True)
    for k in ("c_online", "c_tenant"):
        if k in out:
            v = out[k]
            print(f"[drivers] ({k}) publishes {v['publishes']}, swaps "
                  f"{v['swaps']}, dropped {v['dropped']}, gate trips "
                  f"{v['trips']} (gated {v['gated']}), parity "
                  f"{v['parity']}; {out['part_seconds'][k]:.2f} s",
                  flush=True)
    if "d" in out:
        print(f"[drivers] (d) examples "
              f"{ {n: round(r['seconds'], 2) if r['ok'] else 'FAIL' for n, r in out['d'].items()} }"
              f" s", flush=True)
    print(f"[drivers] {out['seconds']:.1f} s; launches {out['launches']}",
          flush=True)


def _round(d):
    return {k: round(v, 3) for k, v in d.items()}


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
    # no Pallas kernel: a lax.scan and a reverse scan, one XLA program
    "viterbi": ("deeplearning4j_tpu_torch/kernels/csrc/viterbi.cu",
                "deeplearning4j_tpu/util/viterbi.py:27 (_viterbi_core: "
                "lax.scan forward and reverse, an XLA program)"),
}


def run(device, *, small=False, kernels_only=False):
    """All phases on `device`; returns (report, failures)."""
    import torch
    report, fails = {"device": str(device)}, Failures()
    timings, launches = {}, {k: 0 for k in KERNEL_META}
    seconds = report["phase_seconds"] = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        except Exception:  # noqa: BLE001 — record, fail the run, go on
            traceback.print_exc()
            fails.append(f"phase {name} raised")
            return None
        finally:
            seconds[name] = round(time.perf_counter() - t0, 2)

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
                   report, fails, cfg if small else LM_CUT, small)
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
        l15 = phase("telemetry", phase_telemetry, device, report, fails,
                    small)
        for k in launches:
            launches[k] += (l15 or {}).get(k, 0)
        l16 = phase("serving_plane", phase_serving_plane, device, report,
                    fails, small)
        for k in launches:
            launches[k] += (l16 or {}).get(k, 0)
        l17 = phase("parallel", phase_parallel, device, report, fails, small)
        for k in launches:
            launches[k] += (l17 or {}).get(k, 0)
        l18 = phase("multiprocess", phase_multiprocess, device, report,
                    fails, small)
        for k in launches:
            launches[k] += (l18 or {}).get(k, 0)
        l19 = phase("elastic", phase_elastic, device, report, fails, small)
        for k in launches:
            launches[k] += (l19 or {}).get(k, 0)
        l20 = phase("fleet", phase_fleet, device, report, fails, small)
        for k in launches:
            launches[k] += (l20 or {}).get(k, 0)
        l21 = phase("tenancy", phase_tenancy, device, report, fails, small)
        for k in launches:
            launches[k] += (l21 or {}).get(k, 0)
        # phase 22 launches no hand-written kernel (its steps are torch
        # ops, as JAX's are XLA's)
        kept = {}
        phase("embeddings", phase_embeddings, device, report, fails, small,
              kept)
        l23 = phase("clustering", phase_clustering, device, report, fails,
                    small, kept.get("vectors"), kept)
        for k in launches:
            launches[k] += (l23 or {}).get(k, 0)
        l24 = phase("import_io", phase_import_io, device, report, fails,
                    small)
        for k in launches:
            launches[k] += (l24 or {}).get(k, 0)
        l25 = phase("ui", phase_ui, device, report, fails, small,
                    kept.get("tsne"))
        for k in launches:
            launches[k] += (l25 or {}).get(k, 0)
        l26 = phase("drivers", phase_drivers, device, report, fails, small)
        for k in launches:
            launches[k] += (l26 or {}).get(k, 0)
        report["launches_by_phase"] = {
            n: {k: v for k, v in l.items() if v}
            for n, l in (("3", l3), ("4", l4), ("5", l5), ("6", l6),
                         ("7", l7), ("8", l8), ("9", l9), ("10", l10),
                         ("11", l11), ("12", l12), ("13", l13),
                         ("14", l14), ("15", l15), ("16", l16),
                         ("17", l17), ("18", l18), ("19", l19),
                         ("20", l20), ("21", l21), ("23", l23),
                         ("24", l24), ("25", l25), ("26", l26)) if l}
        for part, counts in report.get("multiprocess", {}).get(
                "launches_by_part", {}).items():
            report["launches_by_phase"][f"18 {part}"] = counts
        for part, counts in report.get("elastic", {}).get(
                "launches_by_part", {}).items():
            report["launches_by_phase"][f"19 ({part})"] = counts
        for part, counts in report.get("fleet", {}).get(
                "launches_by_part", {}).items():
            report["launches_by_phase"][f"20 ({part})"] = counts
        for part, counts in report.get("tenancy", {}).get(
                "launches_by_part", {}).items():
            report["launches_by_phase"][f"21 ({part})"] = counts
        for part, counts in report.get("drivers", {}).get(
                "launches_by_part", {}).items():
            if counts:
                report["launches_by_phase"][f"26 ({part})"] = counts
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
    if argv[:1] == ["--mp-worker"]:
        # one process of phase 18's multi-process runs (spawned by
        # `_mp_spawn`, on the card or, in the CPU rehearsal, the CPU)
        sys.path.insert(0, HERE)
        _mp_worker(argv[1:])
        return 0
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
    elif "--telemetry-probe" in argv:
        report = {"telemetry_probe": telemetry_probe(device)}
        fails, report["kernels"] = Failures(), []
    elif "--telemetry" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_telemetry(device, report, fails)
        report["kernels"] = []
    elif "--serving-plane" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_serving_plane(device, report, fails)
        report["kernels"] = []
    elif "--parallel" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_parallel(device, report, fails)
        report["kernels"] = []
    elif "--multiprocess" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_multiprocess(device, report, fails)
        report["kernels"] = []
    elif "--elastic" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_elastic(device, report, fails)
        report["kernels"] = []
    elif "--fleet" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_fleet(device, report, fails)
        report["kernels"] = []
    elif "--tenancy" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_tenancy(device, report, fails)
        report["kernels"] = []
    elif "--embeddings" in argv:
        # phase 22 alone: it runs no hand-written kernel, so no build
        report, fails = {}, Failures()
        phase_embeddings(device, report, fails)
        report["kernels"] = []
    elif "--clustering" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_clustering(device, report, fails)
        report["kernels"] = []
    elif "--import-io" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_import_io(device, report, fails)
        report["kernels"] = []
    elif "--ui" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_ui(device, report, fails)
        report["kernels"] = []
    elif "--drivers" in argv:
        report, fails = {}, Failures()
        phase_build(report, fails)
        phase_drivers(device, report, fails)
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
    if report.get("phase_seconds"):
        print(f"[phases] seconds {json.dumps(report['phase_seconds'])}, "
              f"total {report['seconds']:.1f}")
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
