"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain checks
    python3 chip_smoke.py --profile       # torch.profiler breakdown only
                                          # (with a restore + a fit step)
    python3 chip_smoke.py --warmup-trial  # long-context LM: Adam(1e-3)
                                          # with and without a warmup

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
     its plain version; both are timed at the LM's run. LayerNorm also runs at a width
     past a warp's registers ([64, 2304]). Phase 6's shapes are checked
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
     ones (temperature 0.8, top_p 0.9); every greedy stream must equal
     the port's `generate()` on the card;
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
and prints the `{"kernels": [...]}` line (launch counts from phases 3
to 7, each > 0), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failed check exits nonzero without
the last line. Without CUDA it exits 2 and prints no result.
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
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
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
    # "wide": a row wider than a warp keeps in registers (a block a row)
    ln_cases = [("main", main_rows, 256), ("ragged", 1000, 257),
                ("odd", 37, 33), ("long", long_rows, long_d),
                ("wide", 64, 2304)]
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
    sampled_match = sum(
        np.array_equal(results[n_greedy + i], generate(
            net, prompts[n_greedy + i][None], n_tok, temperature=0.8,
            top_p=0.9, rng=100 + i)[0]) for i in range(n_sampled))
    fails.check(not mismatched,
                f"greedy streams differ from generate(): {mismatched}")
    fails.check(sampled_ok, "sampled streams out of vocab or wrong length")
    fails.check(all(len(r) == n_tok for r in results[:n_greedy]),
                "greedy stream lengths")
    report["serving"] = dict(
        requests=len(streams), greedy=n_greedy, sampled=n_sampled,
        n_tokens=n_tok, prompt_lens=[int(n) for n in lens],
        warmup_s=warm_s, wall_s=wall, tokens=n_total,
        tokens_per_s=n_total / wall, ttft_ms_p50=float(np.median(ttft)),
        ttft_ms_max=float(ttft[-1]), greedy_mismatched=mismatched,
        sampled_equal_to_generate=int(sampled_match), launches=launches,
        preempted=srv.engine.evict_requeue_total)
    print(f"[serving] {len(streams)} requests x {n_tok} tokens on {device}: "
          f"{n_total / wall:.1f} tok/s, TTFT p50 {np.median(ttft):.1f} ms "
          f"max {ttft[-1]:.1f} ms (this card's own numbers), greedy "
          f"mismatches {mismatched}, sampled == generate() "
          f"{sampled_match}/{n_sampled}, launches {launches}", flush=True)
    return launches


# ------------------------------------------------------ phase 5: training
def _fit_steps(net, X, Y, B):
    """One `fit` step per B-row batch, in order; the loss of each."""
    import torch
    losses = []
    for i in range(0, len(X), B):
        net.fit(X[i:i + B], Y[i:i + B], batch_size=B, shuffle=False)
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
    port's own kernels by their entry names, library GEMMs by cuBLAS's
    and CUTLASS's names, the rest elementwise and reductions."""
    n = name.lower()
    for key, group in (("flash_fwd", "flash forward"),
                       ("flash_bwd_dq", "flash dQ"),
                       ("flash_bwd_dkv", "flash dK/dV"),
                       ("ln_warp", "layernorm"), ("ln_block", "layernorm"),
                       ("adam_kernel", "fused adam")):
        if key in n:
            return group
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
    (4) one `fit` step (Adam) on [16, 511] windows, with the step's
    parts timed apart (`_train_step_phases`), and (5) one long-context
    `fit` step at [8, 2048] through the 4-way ring and (6) locally,
    and (7) `restore_model` of the LM's zip followed by one `fit` step
    at [8, 511]. Per path: host wall ms, summed device ms of the kernels seen (one
    stream, so kernels do not overlap), busy share = device / wall,
    launches, and the kernels with the most device time."""
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
    for k, v in out.items():
        groups = ", ".join(f"{g} {ms:.3f}" for g, ms in v["groups_ms"].items())
        print(f"[profile] {k}: wall {v['wall_ms']:.3f} ms, device "
              f"{v['device_ms']:.3f} ms, busy {v['busy_share']:.3f}, "
              f"launches {v['launches']}; device ms by part: {groups}",
              v.get("phases", ""), flush=True)
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
