"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (a CPU tensor
never reaches the CUDA kernel); the JAX side runs the Pallas kernels in
interpret mode, as the JAX suite does. Inputs come from numpy with a
seed. The CUDA kernels themselves are held against the plain versions on
the card (the `cuda`-marked tests here, and `chip_smoke.py`).

Tolerances (fp32): LayerNorm atol 1e-5 (reduction order of the fp32 row
statistics differs); flash atol 2e-5 on o and lse (fp32 online softmax
against the plain whole-row softmax, different summation order).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import (
    _flash_forward,
    flash_attention as jax_flash,
)
from deeplearning4j_tpu.kernels.layernorm import (
    layer_norm as jax_ln,
    residual_layer_norm as jax_res_ln,
)
from deeplearning4j_tpu.nn.layers.normalization import (
    layer_norm_reference as jax_ln_ref,
)
from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.kernels.layernorm import (
    layer_norm,
    layer_norm_fwd,
    layer_norm_plain,
    residual_layer_norm,
    residual_layer_norm_fwd,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    layer_norm_reference,
)

LN_ATOL = 1e-5
FLASH_ATOL = 2e-5


def _ln_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    g = rng.standard_normal(D).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", [(4, 7, 32), (13, 33), (1, 5)])
def test_layer_norm_matches_pallas_interpret(shape):
    x, g, b = _ln_inputs(shape, 0)
    want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             1e-5, 8, True))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=LN_ATOL, rtol=0)


def test_layer_norm_stats_population_variance():
    x, g, b = _ln_inputs((6, 19), 1)
    _, mean, rstd = layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), 1e-5)
    assert mean.shape == (6, 1) and rstd.shape == (6, 1)
    np.testing.assert_allclose(mean.numpy()[:, 0], x.mean(-1), atol=1e-6)
    np.testing.assert_allclose(rstd.numpy()[:, 0],
                               1 / np.sqrt(x.var(-1) + 1e-5), rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 9, 16), (17, 31)])
def test_residual_layer_norm_matches_pallas_interpret(shape):
    x, g, b = _ln_inputs(shape, 2)
    h = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    s_want, y_want = jax_res_ln(jnp.asarray(x), jnp.asarray(h),
                                jnp.asarray(g), jnp.asarray(b), 1e-5, 8, True)
    s, y = residual_layer_norm(torch.from_numpy(x), torch.from_numpy(h),
                               torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), atol=0, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=LN_ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_reference_matches_jax(dtype):
    x, g, b = _ln_inputs((5, 24), 4)
    jd = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    td = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = np.asarray(jax_ln_ref(jnp.asarray(x, jd), jnp.asarray(g, jd),
                                 jnp.asarray(b, jd), 1e-5).astype(jnp.float32))
    got = layer_norm_reference(torch.from_numpy(x).to(td),
                               torch.from_numpy(g).to(td),
                               torch.from_numpy(b).to(td), 1e-5).float()
    # bf16: one bf16 ulp at |y| < 8 (the two frameworks round the fp32
    # normalised value identically but may differ in the last fp32 bit)
    atol = LN_ATOL if dtype is np.float32 else 2 ** -4
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_plain_layer_norm_agrees_with_reference_form():
    x, g, b = _ln_inputs((8, 40), 5)
    t = [torch.from_numpy(a) for a in (x, g, b)]
    y, _, _ = layer_norm_plain(*t, 1e-5)
    np.testing.assert_allclose(y.numpy(), layer_norm_reference(*t, 1e-5),
                               atol=LN_ATOL, rtol=0)


def _qkv(B, T, H, D, seed, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [45, 64])
def test_flash_matches_pallas_interpret(causal, T):
    """Ragged T over more than one 16-row tile on the JAX side."""
    q, k, v = _qkv(2, T, 2, 8, 6)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, 16, 16, True))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL, rtol=0)


def test_flash_lse_matches_pallas_interpret():
    q, k, v = _qkv(1, 37, 3, 16, 7, Tk=29)
    o_w, lse_w = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=16, block_k=8,
                                causal=False, interpret=True)
    o, lse = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                 False)
    assert lse.shape == (1, 3, 37)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), atol=FLASH_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w),
                               atol=FLASH_ATOL, rtol=0)


def test_cpu_tensors_never_launch_or_build(monkeypatch):
    """A CPU tensor takes the plain version: no launch is counted and
    the nvcc build is never reached (a CUDA-less machine never builds)."""
    def no_build(*a, **k):
        raise AssertionError("build reached from a CPU tensor")
    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(build, "load", no_build)
    K.reset_launches()
    x, g, b = (torch.from_numpy(a) for a in _ln_inputs((4, 32), 8))
    layer_norm(x, g, b)
    residual_layer_norm(x, x, g, b)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 1, 32, 9))
    flash_attention(q, k, v, True)
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_mixed_devices_rejected():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        K.on_cuda(x, torch.zeros(4, device="meta"))


def test_plain_flash_causal_matches_masked_softmax():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 11, 2, 32, 10))
    o, lse = flash_attention_plain(q, k, v, True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32)
    s = s.masked_fill(~torch.ones(11, 11, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=FLASH_ATOL)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=FLASH_ATOL)


# ------------------------------- chip_smoke's build reports (text only)
_RES_USAGE = """\
Fatbin elf code:
================
arch = sm_90a
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN4dl4j12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64ELb1EEEvNS0_7BwdArgsE:
  REG:168 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:1024 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN4dl4j12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li128ELb0EEEvNS0_7BwdArgsE:
  REG:255 STACK:24 SHARED:0 LOCAL:8 CONSTANT[0]:1024 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

_SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN4dl4j12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64ELb1EEEvNS0_7BwdArgsE
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.1688.F32.TF32 R4, R8, R14, R4 ;
        /*0120*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : _ZN4dl4j12_GLOBAL__N_116flash_fwd_kernelIfLi64ELb1ELb1EEEvv
        /*0100*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : wgmma_user
        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""


def test_res_usage_reads_registers_and_spills():
    import chip_smoke
    usage = chip_smoke.res_usage(_RES_USAGE)
    dq, dkv = usage.values()
    assert list(usage) == [
        "_ZN4dl4j12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64ELb1EEEvNS0_"
        "7BwdArgsE",
        "_ZN4dl4j12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li128"
        "ELb0EEEvNS0_7BwdArgsE"]
    assert (dq["REG"], dq["STACK"], dq["LOCAL"]) == (168, 0, 0)
    assert (dkv["REG"], dkv["STACK"], dkv["LOCAL"]) == (255, 24, 8)
    assert dkv["CONSTANT[0]"] == 1024
    assert chip_smoke._bwd_instances(usage) == {
        ("dq", "float32", 64, True): list(usage)[0],
        ("dkv", "bfloat16", 128, False): list(usage)[1]}


def test_mma_counts_per_sass_function():
    import chip_smoke
    counts = chip_smoke.mma_counts(_SASS)
    assert list(counts.values()) == [{"HMMA": 2, "HGMMA": 0},
                                     {"HMMA": 0, "HGMMA": 0},
                                     {"HMMA": 0, "HGMMA": 1}]
    assert chip_smoke.mma_counts("no functions here") == {}


_FWD = "_ZN4dl4j12_GLOBAL__N_116flash_fwd_kernelI{}Li{}ELb{}ELb{}EEEvNS0_7FwdArgsE"
_FWD_F32_CAUSAL = _FWD.format("f", 64, 1, 0)
_FWD_BF16_CARRY = _FWD.format("13__nv_bfloat16", 128, 0, 1)

_FWD_RES_USAGE = f"""\
Resource usage:
 Function {_FWD_F32_CAUSAL}:
  REG:154 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:1032 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function {_FWD_BF16_CARRY}:
  REG:232 STACK:16 SHARED:0 LOCAL:16 CONSTANT[0]:1032 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

_FWD_SASS = f"""\
\t\tFunction : {_FWD_F32_CAUSAL}
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t\tFunction : {_FWD_BF16_CARRY}
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R4, R8, R14, R4 ;
        /*0120*/                   HMMA.16816.F32.BF16 R6, R8, R16, R6 ;
"""


def test_fwd_instances_read_the_forward_mangled_names():
    import chip_smoke
    usage = chip_smoke.res_usage(_FWD_RES_USAGE)
    assert chip_smoke._fwd_instances(usage) == {
        ("fwd", "float32", 64, True): _FWD_F32_CAUSAL,
        ("carry", "bfloat16", 128, False): _FWD_BF16_CARRY}
    # neither kernel's pattern takes the other's names
    assert chip_smoke._bwd_instances(usage) == {}
    assert chip_smoke._fwd_instances(chip_smoke.res_usage(_RES_USAGE)) == {}
    # the legacy listing's forward (no mma) is still found, to be failed
    assert list(chip_smoke._fwd_instances(chip_smoke.mma_counts(_SASS))) == [
        ("carry", "float32", 64, True)]


def test_sass_rows_join_mma_counts_and_resources(monkeypatch):
    import chip_smoke
    listings = {"-sass": _FWD_SASS, "-res-usage": _FWD_RES_USAGE}
    monkeypatch.setattr(chip_smoke, "_cuobjdump",
                        lambda flag, lib: listings[flag])
    rows = chip_smoke._sass_rows("lib.so", chip_smoke._fwd_instances,
                                 "flash_attention_")
    assert rows == [
        dict(kernel="flash_attention_carry", dtype="bfloat16", D=128,
             causal=False, HMMA=3, HGMMA=0, registers=232, stack=16,
             local=16),
        dict(kernel="flash_attention_fwd", dtype="float32", D=64,
             causal=True, HMMA=1, HGMMA=0, registers=154, stack=0,
             local=0)]


# --------------------------------------------------- on the card (skip here)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2 ** -4)])
def test_cuda_layer_norm_kernels_match_plain(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, g, b = (torch.from_numpy(a).to("cuda", dtype)
               for a in _ln_inputs((1000, 257), 11))
    h = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)
                    ).to("cuda", dtype)
    y, m, r = layer_norm_fwd(x, g, b)
    y0, m0, r0 = layer_norm_plain(x, g, b)
    torch.testing.assert_close(y.float(), y0.float(), atol=atol, rtol=0)
    torch.testing.assert_close(m, m0, atol=1e-5, rtol=0)
    s, y, _, _ = residual_layer_norm_fwd(x, h, g, b)
    s0, y0 = x + h, layer_norm_plain(x + h, g, b)[0]
    torch.testing.assert_close(s, s0, atol=0, rtol=0)
    torch.testing.assert_close(y.float(), y0.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2 ** -5)])
def test_cuda_flash_kernel_matches_plain(D, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv(2, 300, 3, D, 12))
    for causal in (True, False):
        o, lse = flash_attention_fwd(q, k, v, causal)
        o0, lse0 = flash_attention_plain(q, k, v, causal)
        torch.testing.assert_close(o.float(), o0.float(), atol=atol, rtol=0)
        torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=0)


@pytest.mark.parametrize("D, Dk", [(1, 32), (4, 32), (8, 32), (12, 32),
                                   (32, 32), (33, 64), (64, 64), (96, 128),
                                   (128, 128)])
def test_small_head_dims_pad_to_a_kernel_dim(D, Dk):
    """A head dim the kernels are not built for is zero-padded to the
    next one (the Pallas kernel takes any head dim); above 128 raises."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    assert fa._kernel_dim(D) == Dk
    t = torch.randn(2, 3, 4, D)
    p = fa._pad_head(t, Dk)
    assert p.shape == (2, 3, 4, Dk) and torch.equal(p[..., :D], t)
    assert not p[..., D:].any()
    assert fa._pad_head(t, D) is t
    with pytest.raises(ValueError, match="above"):
        fa._kernel_dim(129)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 8, 12, 16])
def test_cuda_flash_pads_small_head_dims(D):
    """Forward and both backward kernels at a padded head dim against
    the plain versions at the real one (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    q, k, v, do = (torch.from_numpy(a).to("cuda") for a in
                   (*_qkv(2, 37, 4, D, 5), _qkv(2, 37, 4, D, 6)[0]))
    for causal in (True, False):
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        o0, lse0 = fa.flash_attention_plain(q, k, v, causal)
        torch.testing.assert_close(o, o0, atol=2e-5, rtol=0)
        torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=0)
        delta = fa.attention_delta(do, o0)
        bwd = (q, k, v, do, lse0, delta, causal)
        torch.testing.assert_close(fa.flash_attention_bwd_dq(*bwd),
                                   fa.flash_attention_bwd_dq_plain(*bwd),
                                   atol=2e-5, rtol=0)
        for a, b in zip(fa.flash_attention_bwd_dkv(*bwd),
                        fa.flash_attention_bwd_dkv_plain(*bwd)):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
