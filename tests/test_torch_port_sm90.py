"""The Hopper flash kernels' host side, on the CPU.

`csrc/flash_attention_sm90.cu` (the bf16 forward, both modes) and
`csrc/flash_attention_bwd_sm90.cu` (the bf16 dK/dV, and the dQ in bf16
and fp32) read their operands through TMA maps that `_tma_layout` works
out in Python; the wrappers send bf16 CUDA tensors to them, fp32 dQ too,
and the other fp32 ones to the `mma.sync` kernels; and
`chip_smoke.py` phase 1 finds their instances in `cuobjdump` listings
and requires wgmma (HGMMA) in each. None of that needs the card: the
layouts are numbers, the dispatch is checked with the library loader
replaced by a recorder (no launch), and the listings are synthetic.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import pytest
import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels import flash_attention as fa


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


# ------------------------------------------------------------ TMA layout
@pytest.mark.parametrize("dtype,D,cols,swizzle", [
    (torch.bfloat16, 32, 32, 64), (torch.bfloat16, 64, 64, 128),
    (torch.bfloat16, 128, 64, 128), (torch.float32, 32, 32, 128),
    (torch.float32, 64, 32, 128), (torch.float32, 128, 32, 128)])
def test_tma_layout_of_a_contiguous_tensor(dtype, D, cols, swizzle):
    """dims {D, H, T, B}, byte strides {h, t, b} (multiples of 16), a
    box of 128-byte rows (64 bf16 or 32 fp32 columns; 64-byte rows for
    bf16 at D = 32), so bf16 D = 128 loads as two boxes and fp32 D = 64
    and 128 as two and four, the swizzle as wide as a box row."""
    t = torch.zeros(2, 300, 4, D, dtype=dtype)
    es = t.element_size()
    assert fa._tma_layout(t, 128) == [D, 4, 300, 2, es * D, es * 4 * D,
                                      es * 300 * 4 * D, cols, 1, 128, 1,
                                      swizzle]
    L = fa._tma_layout(t, 64)
    assert L[9] == 64 and all(s % 16 == 0 for s in L[4:7])
    assert D // L[7] == D // cols


def test_tma_layout_follows_views_without_a_copy():
    """A sequence shard and a slice of the fused projections keep their
    strides in the map."""
    qkv = _bf16(2, 64, 3, 4, 32)
    q = qkv[:, :, 0]                       # [2, 64, 4, 32], t stride 384
    assert fa._tma_layout(q, 128)[4:7] == [64, 768, 49152]
    shard = q[:, 16:32]
    assert fa._tma_layout(shard, 128)[:4] == [32, 4, 16, 2]


@pytest.mark.parametrize("make", [
    lambda: _bf16(2, 40, 4, 65)[..., :64],               # row stride 130 B
    lambda: _bf16(1, 641)[:, 1:].view(1, 10, 1, 64),     # base off 16 B
    lambda: _bf16(2, 1, 4, 64).expand(2, 40, 4, 64),     # zero t stride
    lambda: _bf16(2, 40, 64, 4).transpose(2, 3),         # strided head dim
    lambda: _bf16(2, 40, 4, 48),                         # no kernel dim
    lambda: _f32(2, 40, 4, 65)[..., :64],                # row stride 260 B
    lambda: _f32(1, 641)[:, 1:].view(1, 10, 1, 64),      # base off 16 B
    lambda: _f32(2, 1, 4, 64).expand(2, 40, 4, 64),      # zero t stride
    lambda: _f32(2, 40, 64, 4).transpose(2, 3),          # strided head dim
    lambda: _f32(2, 40, 4, 48),                          # no kernel dim
    lambda: torch.zeros(2, 40, 4, 64, dtype=torch.float64),  # 8-byte elements
])
def test_tma_layout_refuses_what_a_map_cannot_describe(make):
    t = make()
    assert fa._tma_layout(t, 64) is None
    with pytest.raises(ValueError):
        fa._tma_maps((t, 64))


@pytest.mark.parametrize("make", [_bf16, _f32])
def test_tma_layout_refuses_boxes_past_256_rows(make):
    assert fa._tma_layout(make(1, 512, 1, 64), 512) is None


def test_kernel_layout_copies_what_tma_cannot_read():
    """The wrappers' `_kernel_layout` copies exactly the tensors the maps
    refuse at a kernel head dim, and the copy is describable."""
    bad = _bf16(2, 1, 4, 64).expand(2, 40, 4, 64)
    fixed = fa._kernel_layout(bad)
    assert fixed is not bad and fa._tma_layout(fixed, 64) is not None
    good = _bf16(2, 40, 4, 64)
    assert fa._kernel_layout(good) is good


# -------------------------------------------------------------- dispatch
class _Recorder:
    """Stands in for `build.load`: every entry a wrapper asks for is
    recorded with its library and returns status 0, launching nothing."""

    def __init__(self):
        self.calls = []

    def load(self, lib):
        rec = self

        class _Lib:
            def __getattr__(self, name):
                def entry(*args):
                    rec.calls.append((lib, name, args))
                    return 0
                entry.argtypes = None
                return entry
        return _Lib()


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(build, "load", rec.load)
    monkeypatch.setattr(K, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "stream_of", lambda t: None)
    monkeypatch.setattr(K, "LAUNCHES", dict.fromkeys(K.LAUNCHES, 0))
    monkeypatch.setattr(K, "LAUNCHES_BY_DTYPE", {})
    return rec


def _inputs(dtype, T=40, D=64):
    q, k, v, do = (torch.zeros(2, T, 4, D, dtype=dtype) for _ in range(4))
    lse, delta = (torch.zeros(2, 4, T) for _ in range(2))
    return q, k, v, do, lse, delta


def _entries(rec):
    return [(lib, name) for lib, name, _ in rec.calls]


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_goes_to_the_sm90_entries(recorder, causal):
    q, k, v, do, lse, delta = _inputs(torch.bfloat16)
    fa.flash_attention_fwd(q, k, v, causal)
    m, l, acc = torch.zeros(2, 4, 40), torch.zeros(2, 4, 40), torch.zeros(
        2, 4, 40, 64)
    fa.flash_attention_carry(q, k, v, m, l, acc, diag=causal)
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    assert _entries(recorder) == [
        ("flash_attention_sm90", "dl4j_flash_attention_fwd_sm90"),
        ("flash_attention_sm90", "dl4j_flash_attention_carry_sm90"),
        ("flash_attention_bwd_sm90", "dl4j_flash_attention_bwd_dkv_sm90"),
        ("flash_attention_bwd_sm90", "dl4j_flash_attention_bwd_dq_sm90")]
    # the launch counters keep their names
    assert K.LAUNCHES["flash_attention_fwd"] == 1
    assert K.LAUNCHES["flash_attention_carry"] == 1
    assert K.LAUNCHES["flash_attention_bwd_dkv"] == 1
    assert K.LAUNCHES_BY_DTYPE["flash_attention_bwd_dkv/bfloat16"] == 1
    # the forward's layout argument: 3 maps of 12 numbers, q's box 128
    # rows, k's and v's 128 (64 in carry mode); dK/dV's 4 maps, q's and
    # dO's box 64 rows
    fwd_maps = list(recorder.calls[0][2][12])
    assert len(fwd_maps) == 36 and fwd_maps[9] == fa.FWD_Q_ROWS == 128
    assert fwd_maps[21] == fwd_maps[33] == fa.FWD_KV_ROWS[64] == 128
    carry_maps = list(recorder.calls[1][2][13])
    assert [carry_maps[12 * i + 9] for i in range(3)] == [128, 64, 64]
    assert fa.CARRY_KV_ROWS == 64
    dkv_maps = list(recorder.calls[2][2][15])
    assert len(dkv_maps) == 48
    assert [dkv_maps[12 * i + 9] for i in range(4)] == [64, 128, 128, 64]
    # dQ's 4 maps: q's and dO's box 64 rows (a consumer warpgroup), k's
    # and v's 64 (the streamed tiles); dtype code 1
    dq_args = recorder.calls[3][2]
    dq_maps = list(dq_args[14])
    assert len(dq_maps) == 48 and dq_args[0] == 1
    assert [dq_maps[12 * i + 9] for i in range(4)] == [64, 64, 64, 64]
    assert fa.DQ_Q_ROWS[torch.bfloat16][64] == 64
    assert K.LAUNCHES_BY_DTYPE["flash_attention_bwd_dq/bfloat16"] == 1


def test_streamed_tiles_halve_at_head_dim_128(recorder):
    """At D = 128 the forward streams 64-key tiles, dK/dV 32-query tiles
    and dQ 32-key tiles (the registers of two tiles in flight), as the
    kernels expect."""
    q, k, v, do, lse, delta = _inputs(torch.bfloat16, D=128)
    fa.flash_attention_fwd(q, k, v, True)
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    fwd_maps = list(recorder.calls[0][2][12])
    assert [fwd_maps[12 * i + 9] for i in range(3)] == [128, 64, 64]
    dkv_maps = list(recorder.calls[1][2][15])
    assert [dkv_maps[12 * i + 9] for i in range(4)] == [32, 128, 128, 32]
    # and the bf16 dQ 32-key tiles (two tiles' scores in flight)
    dq_maps = list(recorder.calls[2][2][14])
    assert [dq_maps[12 * i + 9] for i in range(4)] == [64, 32, 32, 64]


def test_fp32_keeps_the_mma_sync_entries(recorder):
    """The fp32 forward (both modes) and dK/dV stay the mma.sync kernels;
    the fp32 dQ is the Hopper kernel (3xTF32 on tf32 wgmma)."""
    q, k, v, do, lse, delta = _inputs(torch.float32)
    fa.flash_attention_fwd(q, k, v, True)
    m, l, acc = torch.zeros(2, 4, 40), torch.zeros(2, 4, 40), torch.zeros(
        2, 4, 40, 64)
    fa.flash_attention_carry(q, k, v, m, l, acc, diag=False)
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    assert _entries(recorder) == [
        ("flash_attention", "dl4j_flash_attention_fwd"),
        ("flash_attention", "dl4j_flash_attention_carry"),
        ("flash_attention_bwd", "dl4j_flash_attention_bwd_dkv"),
        ("flash_attention_bwd_sm90", "dl4j_flash_attention_bwd_dq_sm90")]
    # {b, t, h} element strides, 3 a tensor
    assert list(recorder.calls[0][2][12]) == [40 * 256, 256, 64] * 3


@pytest.mark.parametrize("D,q_rows,kv_rows", [(32, 128, 32), (64, 64, 32),
                                              (128, 64, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_dq_goes_to_the_sm90_entry(recorder, D, q_rows, kv_rows,
                                        causal):
    """fp32 dQ: dtype code 0, 4 maps of 32-column fp32 boxes (128B
    swizzle), q's and dO's box 64 rows a consumer warpgroup (two at
    D = 32), k's and v's the streamed tile (32 keys, 16 at D = 128);
    counted as fp32."""
    q, k, v, do, lse, delta = _inputs(torch.float32, D=D)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    assert dq.shape == q.shape and dq.dtype == torch.float32
    assert _entries(recorder) == [
        ("flash_attention_bwd_sm90", "dl4j_flash_attention_bwd_dq_sm90")]
    args = recorder.calls[0][2]
    assert args[0] == 0 and args[1] == int(causal)
    maps = list(args[14])
    assert len(maps) == 48
    assert [maps[12 * i + 9] for i in range(4)] == [q_rows, kv_rows,
                                                    kv_rows, q_rows]
    assert all(maps[12 * i + 7] == 32 and maps[12 * i + 11] == 128
               for i in range(4))
    assert fa.DQ_Q_ROWS[torch.float32][D] == q_rows
    assert fa.DQ_KV_ROWS[torch.float32][D] == kv_rows
    assert K.LAUNCHES["flash_attention_bwd_dq"] == 1
    assert K.LAUNCHES_BY_DTYPE == {"flash_attention_bwd_dq/float32": 1}


def test_fp32_dq_small_head_dim_pads_to_a_mapped_kernel_dim(recorder):
    q, k, v, do, lse, delta = _inputs(torch.float32, D=12)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    assert dq.shape == (2, 40, 4, 12)
    maps = list(recorder.calls[0][2][14])
    assert maps[0] == 32 and maps[7] == 32 and maps[11] == 128


def test_bf16_small_head_dim_pads_to_a_mapped_kernel_dim(recorder):
    q, k, v, _, _, _ = _inputs(torch.bfloat16, D=12)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    assert o.shape == (2, 40, 4, 12)
    maps = list(recorder.calls[0][2][12])
    assert maps[0] == 32 and maps[11] == 64        # D 32: 64B swizzle


def test_a_failed_sm90_launch_raises(recorder, monkeypatch):
    """No fallback: a status the C entry returns is raised."""
    def failing(lib):
        class _Lib:
            def __getattr__(self, name):
                def entry(*args):
                    return 1
                entry.argtypes = None
                return entry
        return _Lib()
    monkeypatch.setattr(build, "load", failing)
    q, k, v, _, _, _ = _inputs(torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fa.flash_attention_fwd(q, k, v, True)


# ------------------------------------ chip_smoke phase 1 (listings only)
_SM90 = "_ZN4dl4j56_GLOBAL__N__90b3ddf4_23_flash_attention_sm90_cu_a8b80bdc"
_FWD90 = (_SM90 + "21flash_fwd_sm90_kernelILi{}ELb{}ELb{}EEEv14CUtensorMap_st"
          "S2_S2_NS0_7FwdArgsE")
_DKV90 = ("_ZN4dl4j60_GLOBAL__N__0e98fa7f_27_flash_attention_bwd_sm90_cu_"
          "579ebdf325flash_bwd_dkv_sm90_kernelILi{}ELb{}EEEv14CUtensorMap_st"
          "S2_S2_S2_NS0_7DkvArgsE")
# the dQ's: dtype f (fp32) or 13__nv_bfloat16, D, causal
_DQ90 = ("_ZN4dl4j60_GLOBAL__N__0e98fa7f_27_flash_attention_bwd_sm90_cu_"
         "579ebdf324flash_bwd_dq_sm90_kernelI{}Li{}ELb{}EEEv14CUtensorMap_st"
         "S2_S2_S2_NS0_6DqArgsE")
_DQ_DT = {"float32": "f", "bfloat16": "13__nv_bfloat16"}


def _listing(names, op):
    return "".join(f"\t\tFunction : {n}\n        /*0100*/  {op} R4, R8 ;\n"
                   for n in names)


def _res(names):
    return "Resource usage:\n" + "".join(
        f" Function {n}:\n  REG:168 STACK:0 SHARED:0 LOCAL:0 "
        f"CONSTANT[0]:1032\n" for n in names)


def test_sm90_instances_read_the_hopper_mangled_names():
    import chip_smoke
    fwd = [_FWD90.format(D, c, m) for D in (32, 64, 128) for c in (0, 1)
           for m in (0, 1)]
    dkv = [_DKV90.format(D, c) for D in (32, 64, 128) for c in (0, 1)]
    found = chip_smoke._fwd_sm90_instances(fwd)
    assert found[("carry", "bfloat16", 128, True)] == _FWD90.format(128, 1, 1)
    assert found[("fwd", "bfloat16", 32, False)] == _FWD90.format(32, 0, 0)
    assert len(found) == 12
    assert chip_smoke._bwd_sm90_instances(dkv) == {
        ("dkv", "bfloat16", D, c == 1): _DKV90.format(D, c)
        for D in (32, 64, 128) for c in (0, 1)}
    dq = [_DQ90.format(_DQ_DT[dt], D, c) for dt in _DQ_DT
          for D in (32, 64, 128) for c in (0, 1)]
    found = chip_smoke._bwd_sm90_instances(dkv + dq)
    assert len(found) == 18
    assert {key: n for key, n in found.items() if key[0] == "dq"} == {
        ("dq", dt, D, c == 1): _DQ90.format(_DQ_DT[dt], D, c)
        for dt in _DQ_DT for D in (32, 64, 128) for c in (0, 1)}
    # the mma.sync finders take none of the Hopper names, nor the reverse
    assert chip_smoke._fwd_instances(fwd + dkv + dq) == {}
    assert chip_smoke._bwd_instances(fwd + dkv + dq) == {}
    assert chip_smoke._fwd_sm90_instances(
        ["_ZN4dl4j12_GLOBAL__N_116flash_fwd_kernelIfLi64ELb1ELb0EEEvv"]) == {}


@pytest.mark.parametrize("op,ok", [("HGMMA.64x128x16.F32.BF16", True),
                                   ("HMMA.16816.F32.BF16", False)])
def test_phase_build_wants_hgmma_in_every_sm90_instance(monkeypatch, op, ok):
    import chip_smoke
    fwd = [_FWD90.format(D, c, m) for D in (32, 64, 128) for c in (0, 1)
           for m in (0, 1)]
    listings = {"-sass": _listing(fwd, op), "-res-usage": _res(fwd)}
    monkeypatch.setattr(chip_smoke, "_cuobjdump",
                        lambda flag, lib: listings[flag])
    _, _, find, prefix, want = chip_smoke.FLASH_LIBS[3]
    rows = chip_smoke._sass_rows("lib.so", find, prefix)
    assert len(rows) == 12 and rows[0]["registers"] == 168
    assert [c for c, _ in chip_smoke.flash_sass_checks(rows, prefix,
                                                       want)] == [ok, ok]


@pytest.mark.parametrize("op,ok", [("HGMMA.64x64x8.F32.TF32", True),
                                   ("HMMA.1688.F32.TF32", False)])
def test_phase_build_wants_hgmma_in_every_sm90_backward_instance(
        monkeypatch, op, ok):
    """The Hopper backward library: HGMMA in all 6 instances of the bf16
    dK/dV and of the dQ in each dtype."""
    import chip_smoke
    names = ([_DKV90.format(D, c) for D in (32, 64, 128) for c in (0, 1)]
             + [_DQ90.format(_DQ_DT[dt], D, c) for dt in _DQ_DT
                for D in (32, 64, 128) for c in (0, 1)])
    listings = {"-sass": _listing(names, op), "-res-usage": _res(names)}
    monkeypatch.setattr(chip_smoke, "_cuobjdump",
                        lambda flag, lib: listings[flag])
    key, lib, find, prefix, want = chip_smoke.FLASH_LIBS[2]
    assert (key, lib) == ("bwd_sm90_sass", "flash_attention_bwd_sm90")
    rows = chip_smoke._sass_rows("lib.so", find, prefix)
    assert len(rows) == 18
    assert sorted({(r["kernel"], r["dtype"]) for r in rows}) == [
        ("flash_attention_bwd_dkv", "bfloat16"),
        ("flash_attention_bwd_dq", "bfloat16"),
        ("flash_attention_bwd_dq", "float32")]
    assert [c for c, _ in chip_smoke.flash_sass_checks(rows, prefix,
                                                       want)] == [ok] * 3


def test_phase_build_wants_no_dq_left_in_the_mma_sync_backward():
    """A dQ instance (either dtype) still in the mma.sync backward library
    fails the check; fp32 dK/dV instances with HMMA pass."""
    import chip_smoke
    _, lib, _, prefix, want = chip_smoke.FLASH_LIBS[0]
    assert lib == "flash_attention_bwd"
    rows = [dict(kernel=prefix + "dkv", dtype="float32", D=D, causal=c,
                 HMMA=4, HGMMA=0) for D in (32, 64, 128) for c in (0, 1)]
    assert all(ok for ok, _ in chip_smoke.flash_sass_checks(rows, prefix,
                                                            want))
    for dt in ("float32", "bfloat16"):
        bad = rows + [dict(kernel=prefix + "dq", dtype=dt, D=64, causal=1,
                           HMMA=4, HGMMA=0)]
        assert not all(ok for ok, _ in chip_smoke.flash_sass_checks(
            bad, prefix, want))


def test_phase_build_wants_no_bf16_left_in_the_mma_sync_forward():
    """A bf16 forward instance still in the mma.sync library fails the
    check; fp32 instances with HMMA pass."""
    import chip_smoke
    _, _, _, prefix, want = chip_smoke.FLASH_LIBS[1]
    rows = [dict(kernel=prefix + kind, dtype=dt, D=D, causal=c, HMMA=4,
                 HGMMA=0) for kind in ("fwd", "carry")
            for dt in ("float32",) for D in (32, 64, 128) for c in (0, 1)]
    assert all(ok for ok, _ in chip_smoke.flash_sass_checks(rows, prefix,
                                                            want))
    rows.append(dict(kernel=prefix + "fwd", dtype="bfloat16", D=64,
                     causal=1, HMMA=4, HGMMA=0))
    assert not all(ok for ok, _ in chip_smoke.flash_sass_checks(rows, prefix,
                                                                want))


@pytest.mark.parametrize("code", ["C7512", "C7513"])
def test_phase_build_reads_serialised_wgmma_from_ptxas(code):
    """Phase 1 finds ptxas's notes that a kernel's wgmma products are
    serialised, with the kernel they name, and nothing in a clean log."""
    import chip_smoke
    name = _FWD90.format(64, 0, 1)
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           f"'sm_90a'\n"
           f"ptxas warning : ({code}) Potential Performance Loss: "
           f"wgmma.mma_async instructions are serialized due to "
           f"insufficient register resources for the wgmma pipeline in the "
           f"function '{name}'\n"
           f"ptxas info    : Used 168 registers, 0 bytes spill stores\n")
    assert chip_smoke.wgmma_serialised(log) == [(code, name)]
    clean = "\n".join(l for l in log.splitlines() if code not in l)
    assert chip_smoke.wgmma_serialised(clean) == []


def test_launch_counts_split_by_dtype_where_a_phase_reads_them(monkeypatch):
    """Phase launch counts carry each kernel's split by dtype, read from
    the counters reset with `K.LAUNCHES`, and add up key by key."""
    import chip_smoke
    monkeypatch.setattr(K, "LAUNCHES", dict.fromkeys(K.LAUNCHES, 0))
    monkeypatch.setattr(K, "LAUNCHES_BY_DTYPE", {})
    K.count_launch("flash_attention_fwd", torch.float32, 2)
    K.reset_launches()                       # a warm-up counts nowhere
    K.count_launch("flash_attention_fwd", torch.bfloat16, 3)
    first = chip_smoke.launch_counts()
    assert first["flash_attention_fwd"] == 3
    assert first["flash_attention_fwd/bfloat16"] == 3
    assert "flash_attention_fwd/float32" not in first
    K.reset_launches()
    K.count_launch("flash_attention_fwd", torch.float32, 4)
    total = chip_smoke.sum_counts(first, None, chip_smoke.launch_counts())
    assert total["flash_attention_fwd"] == 7
    assert (total["flash_attention_fwd/bfloat16"],
            total["flash_attention_fwd/float32"]) == (3, 4)


def test_dq_tiles_trial_edits_the_kept_source():
    """`chip_smoke.py --dq-tiles-trial` builds its block shapes by editing
    DqTiles lines of the source: each line it replaces is there, once, and
    each variant's q rows are the blocks its edits give."""
    import chip_smoke
    src = (build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    assert chip_smoke.DQ_TILES_TRIAL["kept"] == ({}, {})
    for name, (edits, rows) in chip_smoke.DQ_TILES_TRIAL.items():
        for old in edits:
            assert src.count(old) == 1, (name, old)
        for dt, by_d in rows.items():
            assert set(by_d) <= set(fa.HEAD_DIMS)
            assert all(r % 64 == 0 and r <= 256 for r in by_d.values())
