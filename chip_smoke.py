"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain checks
    python3 chip_smoke.py --profile       # torch.profiler breakdown only

Phases, in order:
  1. build every kernel of `deeplearning4j_tpu_torch/kernels/csrc/` with
     nvcc (one process per source, all at once) and print the seconds;
  2. hold each kernel against its plain PyTorch version on the card, in
     fp32 and bf16, at the main path's shapes and at ragged ones, and
     time kernel, plain version and the one-call PyTorch yardstick
     (`F.layer_norm`, `F.scaled_dot_product_attention` — timed only,
     the port never calls them);
  3. scoring: `TransformerLM(vocab 512, d_model 256, 4 layers, 8 heads,
     ff x4, max_len 512)` with random weights from a numpy seed loaded
     through `from_jax_params`, `output()` at B=16, T=512 on the card,
     held against the same port run on the CPU;
  4. serving: a `GenerationServer` (8 slots, block_len 16, pool for 8
     full-budget streams + the garbage block) after `warmup`, 24 greedy
     requests (seeded prompt lengths 16-300, 64 tokens) and 4 sampled
     ones (temperature 0.8, top_p 0.9); every greedy stream must equal
     the port's `generate()` on the card;
and prints the `{"kernels": [...]}` line (launch counts from phases 3
and 4, each > 0), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failed check exits nonzero without
the last line. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# peak rates (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, fp32
# (CUDA cores) and bf16 (tensor cores) operations/s
HBM_BPS = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

LN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -4}        # 1 bf16 ulp at |y|<16
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2 ** -5}     # 1 bf16 ulp at |o|<4
OUTPUT_ATOL = 1e-4    # softmax probs, card vs CPU, fp32 (TF32 off)

LM = dict(vocab=512, d_model=256, n_layers=4, n_heads=8, ff=4, max_len=512)


# ------------------------------------------------------------------ helpers
class Failures(list):
    def check(self, ok: bool, what: str):
        if not ok:
            self.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def timer(device, fn, iters=20, warmup=3, flush=None):
    """Median ms of `fn()` over `iters` calls; CUDA events on the card,
    each launch after a write of `flush` (a buffer larger than L2) so the
    inputs come cold from device memory, as the model's layers find them."""
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


def build_lm(cfg, device, params):
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    net = TransformerLM(cfg["vocab"], d_model=cfg["d_model"],
                        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                        ff_multiplier=cfg["ff"],
                        max_len=cfg["max_len"]).init(device=device)
    return from_jax_params(net, params)


# ------------------------------------------------------------ phase 1: build
def phase_build(report):
    from deeplearning4j_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {sorted(paths)} in {report['build_s']:.2f} s", flush=True)


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
    ln_cases = [("main", main_rows, 256), ("ragged", 1000, 257),
                ("odd", 37, 33)]
    fl_cases = ([("main", 16, 512, 8, 32), ("ragged", 2, 300, 4, 64),
                 ("wide", 2, 300, 2, 128)] if not small else
                [("main", 2, 70, 2, 32)])
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
                if case != "main" or not causal:
                    continue
                es_ = q.element_size()
                nbytes = 4 * B * T * H * Dh * es_ + B * H * T * 4
                ops = 4.0 * Dh * B * H * T * (T + 1) / 2
                qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
                timings[("flash_attention_fwd", dt_name)] = dict(
                    shape=[B, T, H, Dh], max_abs_err=e,
                    ms=timer(device, lambda: fa.flash_attention_fwd(
                        q, k, v, True), flush=flush),
                    plain_ms=timer(device, lambda: fa.flash_attention_plain(
                        q, k, v, True), iters=10, flush=flush),
                    library_ms=timer(device, lambda:
                                     F.scaled_dot_product_attention(
                                         qt, kt, vt, is_causal=True),
                                     flush=flush),
                    bound=bound(nbytes, ops, dt_name))
    if device.type == "cuda":
        torch.cuda.synchronize()
    report["kernel_checks"] = checks
    report["kernel_timings"] = {f"{k[0]}/{k[1]}": v
                                for k, v in timings.items()}
    for k, t in report["kernel_timings"].items():
        print(f"[kernels] {k} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}), max_abs_err "
              f"{t['max_abs_err']:.3g}", flush=True)
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


# ------------------------------------------------- --profile: time breakdown
def _profile_summary(prof, wall_ms, top=8):
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
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                launches=int(sum(r[2] for r in rows)),
                top=[dict(name=n[:90], ms=ms, count=c)
                     for n, ms, c in rows[:top]])


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


def profile_paths(device):
    """Where the time goes: torch.profiler over (1) `output()` on
    [16, 512] ids, (2) one 8-wide admission wave of 128-token prompts and
    (3) 32 decode dispatches of the paged engine with 8 active slots.
    Per path: host wall ms, summed device ms of the kernels seen (one
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
    for k, v in out.items():
        print(f"[profile] {k}: wall {v['wall_ms']:.3f} ms, device "
              f"{v['device_ms']:.3f} ms, busy {v['busy_share']:.3f}, "
              f"launches {v['launches']}", flush=True)
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
        phase("build", phase_build, report)
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
