"""The port's kernels on the card against their plain versions.

Marked ``cuda``: they skip where no CUDA device is present (this file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only torch). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n,s,lo,hi", [(1024, 490, 256, 7, -127, 128),
                                           (1024, 72, 8, 255, 0, 256),
                                           (37, 19, 70, 1, -127, 128)])
def test_threshold_matmul_kernel_equals_plain(cuda, m, k, n, s, lo, hi):
    g = torch.Generator().manual_seed(m + k + n + s)
    x = torch.randint(lo, hi, (m, k), generator=g, dtype=torch.int32)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    acc = ref.int_matmul(x, w)
    t = torch.sort(torch.randint(int(acc.min()), int(acc.max()) + 1, (n, s),
                                 generator=g, dtype=torch.int32), dim=1).values
    x, w, t = x.to(cuda), w.to(cuda), t.to(cuda)
    before = ops.launches["threshold_matmul"]
    got = ops.threshold_matmul(x, w, t)
    torch.cuda.synchronize()
    assert ops.launches["threshold_matmul"] == before + 1
    assert torch.equal(got, ref.threshold_matmul_ref(x, w, t))


@pytest.mark.parametrize("k,stride,padding,c,w", [(1, 1, "SAME", 3, 15),
                                                  (4, 4, "SAME", 32, 15),
                                                  (3, 1, "VALID", 8, 15),
                                                  (5, 2, "SAME", 1, 15),
                                                  (3, 1, "SAME", 3, 120)])
def test_conv_threshold_kernel_equals_plain(cuda, k, stride, padding, c, w):
    """w = 120 gives 2-row blocks with a partial last block."""
    g = torch.Generator().manual_seed(k * 100 + stride * 10 + c)
    h = 15
    x = torch.randint(0, 256, (3, h, w, c), generator=g, dtype=torch.int32)
    w2d = torch.randint(-127, 128, (k * k * c, 6), generator=g,
                        dtype=torch.int8)
    t = torch.sort(torch.randint(-40000, 40000, (6, 255), generator=g,
                                 dtype=torch.int32), dim=1).values
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    kw = dict(kernel=k, stride=stride, padding=padding, out_h=oh, out_w=ow)
    want = ops.conv_threshold(x, w2d, t, **kw)          # plain, on the CPU
    got = ops.conv_threshold(x.to(cuda), w2d.to(cuda), t.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _codes(rng, shape, codes):
    from repro_torch.bench.kernel_bench import CODE_RANGES

    lo, hi = CODE_RANGES[codes]
    return rng.integers(lo, hi, shape).astype(np.int32)


# (M, K, N, S, bank kind, code range): every bank kind of the K4 checks,
# bank depths 1 to 1000 (searched: whole banks are padded to 2^k - 1
# steps, 1023 here) and 1024 and 2000 (past K1's shared-memory budget at the
# default
# tile (the chunked linear count), and every mma flavour: s8, u8, binary
# and codes wider than a byte (the byte split; K small enough that the
# sums fit int32)
TMM_BRANCH_CASES = [
    (300, 200, 72, 255, "sorted", "s8"), (300, 200, 72, 255, "unsorted", "u8"),
    (300, 200, 72, 255, "ties", "binary"), (300, 200, 72, 255, "mixed", "u8"),
    (300, 200, 72, 255, "extreme", "s8"), (257, 130, 40, 7, "sorted", "wide"),
    (257, 130, 40, 255, "mixed", "wide"), (129, 490, 70, 1000, "sorted", "u8"),
    (129, 490, 70, 1024, "mixed", "u8"),
    (129, 64, 33, 1, "unsorted", "s8"), (65, 33, 9, 2000, "mixed", "u8"),
    (65, 33, 9, 2000, "sorted", "s8")]


@pytest.mark.parametrize("m,k,n,s,kind,codes", TMM_BRANCH_CASES)
def test_threshold_matmul_kernel_every_bank_and_code_range_equals_plain(
        cuda, m, k, n, s, kind, codes):
    from repro_torch.bench.kernel_bench import bank_of_kind

    rng = np.random.default_rng(m * 7 + k + n + s)
    x = _codes(rng, (m, k), codes)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    t = bank_of_kind(rng, x.astype(np.int64) @ w, n, s, kind)
    x, w, t = (torch.from_numpy(a) for a in (x, w, t))
    want = ops.threshold_matmul(x, w, t)                 # plain, on the CPU
    for bm, bn in ((32, 32), tuple(ops.TMM_DEFAULT_TILE), (128, 128)):
        got = ops.threshold_matmul(x.to(cuda), w.to(cuda), t.to(cuda),
                                   block_m=bm, block_n=bn)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (bm, bn)


def test_threshold_matmul_kernel_mixes_flavours_across_k_tiles(cuda):
    """One row block whose 64-deep k tiles vote s8, u8 and the byte split
    in turn, then s8 again."""
    rng = np.random.default_rng(17)
    x = np.concatenate([rng.integers(-128, 128, (40, 64)),
                        rng.integers(0, 256, (40, 64)),
                        rng.integers(-5000, 5001, (40, 64)),
                        rng.integers(-128, 0, (40, 50))], axis=1)
    x = x.astype(np.int32)
    w = rng.integers(-127, 128, (x.shape[1], 24)).astype(np.int8)
    t = np.sort(rng.integers(-400000, 400000, (24, 255)),
                axis=1).astype(np.int32)
    x, w, t = (torch.from_numpy(a) for a in (x, w, t))
    want = ops.threshold_matmul(x, w, t)
    got = ops.threshold_matmul(x.to(cuda), w.to(cuda), t.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# (N, H, W, C, F, kernel, stride, padding, S, bank kind, code range): C
# of 1 and 3 (byte loads) and multiples of 4 (word loads, padded pixel
# stride from 32 channels), F past one 64-channel block, every bank kind,
# deep banks (1000 searched, 1024 and 6000 past the budget: the linear
# count), every mma
# flavour
CONV_BRANCH_CASES = [
    (3, 12, 12, 3, 32, 3, 1, "VALID", 255, "sorted", "s8"),
    (2, 16, 16, 3, 32, 1, 1, "SAME", 255, "unsorted", "s8"),
    (2, 16, 16, 32, 4, 4, 1, "SAME", 255, "mixed", "u8"),
    (2, 16, 16, 4, 32, 4, 1, "SAME", 255, "ties", "u8"),
    (2, 16, 16, 32, 32, 4, 4, "SAME", 255, "extreme", "u8"),
    (2, 10, 10, 8, 70, 3, 1, "VALID", 1, "sorted", "binary"),
    (2, 7, 9, 64, 130, 3, 1, "SAME", 7, "unsorted", "binary"),
    (2, 9, 9, 5, 6, 3, 2, "SAME", 7, "mixed", "wide"),
    (2, 9, 9, 8, 6, 3, 1, "SAME", 255, "sorted", "wide"),
    (2, 8, 8, 16, 24, 3, 1, "SAME", 1000, "sorted", "u8"),
    (2, 8, 8, 16, 24, 3, 1, "SAME", 1024, "sorted", "u8"),
    (1, 6, 7, 8, 33, 3, 1, "SAME", 6000, "mixed", "u8")]


@pytest.mark.parametrize("nb,h,wd,c,f,k,stride,padding,s,kind,codes",
                         CONV_BRANCH_CASES)
def test_conv_threshold_kernel_every_bank_and_code_range_equals_plain(
        cuda, nb, h, wd, c, f, k, stride, padding, s, kind, codes):
    from repro_torch.bench.kernel_bench import bank_of_kind
    from repro_torch.kernels.conv_threshold import direct_conv_acc, pad_input

    rng = np.random.default_rng(h * 100 + c * 10 + f + s)
    x = torch.from_numpy(_codes(rng, (nb, h, wd, c), codes))
    w2d = torch.from_numpy(rng.integers(-127, 128, (k * k * c, f)).astype(
        np.int8))
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-wd // stride)
    else:
        oh, ow = (h - k) // stride + 1, (wd - k) // stride + 1
    kw = dict(kernel=k, stride=stride, padding=padding, out_h=oh, out_w=ow)
    acc = direct_conv_acc(pad_input(x, **kw), w2d, kernel=k, stride=stride,
                          out_h=oh, out_w=ow)
    t = torch.from_numpy(bank_of_kind(rng, acc.numpy(), f, s, kind))
    want = ops.conv_threshold(x, w2d, t, **kw)          # plain, on the CPU
    for bh in (None, 1, 3):
        got = ops.conv_threshold(x.to(cuda), w2d.to(cuda), t.to(cuda),
                                 block_h=bh, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), bh


def test_threshold_kernel_variants_equal_plain(cuda):
    """The timing variants (banks streamed and counted step by step; dp4a
    on the CUDA cores) give the same codes as the kernels."""
    from repro_torch.kernels.conv_threshold import pad_input

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (130, 100)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-127, 128, (100, 70)).astype(np.int8))
    t = torch.from_numpy(np.sort(rng.integers(-2000000, 2000000, (70, 255)),
                                 axis=1).astype(np.int32))
    want = ops.threshold_matmul(x, w, t)
    for linear, cores in ((True, False), (False, True), (True, True)):
        got = ops._tmm_launch(x.to(cuda), w.to(cuda), t.to(cuda), 32, 32,
                              linear=linear, cores=cores)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (linear, cores)
    xc = torch.from_numpy(rng.integers(-127, 128, (2, 9, 9, 3)).astype(
        np.int32))
    w2d = torch.from_numpy(rng.integers(-127, 128, (27, 40)).astype(np.int8))
    tc = torch.from_numpy(np.sort(rng.integers(-30000, 30000, (40, 255)),
                                  axis=1).astype(np.int32))
    kw = dict(kernel=3, stride=1, padding="SAME", out_h=9, out_w=9)
    want = ops.conv_threshold(xc, w2d, tc, **kw)
    xp = pad_input(xc, **kw).to(cuda)
    for linear, cores in ((True, False), (False, True), (True, True)):
        got = ops._conv_launch(xp, w2d.to(cuda), tc.to(cuda), kernel=3,
                               stride=1, out_h=9, out_w=9, block_h=4,
                               linear=linear, cores=cores)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (linear, cores)


@pytest.mark.parametrize("name", ("threshold_matmul", "conv_threshold",
                                  "mlp_megakernel", "qmatmul"))
def test_threshold_kernels_run_on_the_int8_tensor_cores(cuda, name):
    import shutil
    import subprocess

    from repro_torch.kernels import _build

    (lib,) = _build.build_all([name])
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    assert "IMMA" in sass


@pytest.mark.parametrize("name", ("kws", "ad", "ic", "cnv"))
@pytest.mark.parametrize("lowering", ("direct", "im2col"))
def test_goldens_on_the_card(cuda, name, lowering):
    from repro_torch.core.qir import Graph
    from repro_torch.deploy import compile_graph

    graph = Graph.load(os.path.join(GOLDEN_DIR, f"{name}.qir.json"))
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))
    want = [data[k] for k in sorted(data.files) if k.startswith("stage_")]
    cm = compile_graph(graph, in_scale=graph.meta["in_scale"],
                       conv_lowering=lowering)
    for i, (got, w) in enumerate(zip(cm.stage_outputs(data["x"]), want)):
        got = got.cpu().numpy()
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got, w, err_msg=f"stage {i}")
        else:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)


def _chain(g, m, dims, steps, lo, hi):
    """Seeded codes, weights and per-stage banks drawn from each stage's
    own accumulator, for a chain of widths ``dims``."""
    x = torch.randint(lo, hi, (m, dims[0]), generator=g, dtype=torch.int32)
    weights, banks, h = [], [], x
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        acc = ref.int_matmul(h, w).reshape(-1)
        b = torch.sort(acc[torch.randint(0, acc.numel(), (n * s,),
                                         generator=g)].reshape(n, s),
                       dim=1).values
        h = ref.threshold_matmul_ref(h, w, b)
        weights.append(w)
        banks.append(b)
    return x, weights, banks


@pytest.mark.parametrize("m,dims,steps,lo,hi", [
    (1000, [490, 256, 256, 256], [7, 7, 7], -127, 128),
    (1024, [128, 72, 72, 8, 72, 72], [255] * 5, -127, 128),
    (333, [33, 5, 11, 512, 3, 100], [1, 7, 255, 7, 1], 0, 256),
    (17, [20, 16], [255], -127, 128),
    (1, [7, 9, 4], [3, 3], 0, 8)])
def test_mlp_megakernel_equals_plain(cuda, m, dims, steps, lo, hi):
    """Ragged M (not a multiple of the 8-row block), widths that are and
    are not multiples of 4, S in {1, 3, 7, 255}, signed first-layer
    codes."""
    g = torch.Generator().manual_seed(m + sum(dims))
    x, weights, banks = _chain(g, m, dims, steps, lo, hi)
    banks = [b.t().contiguous() for b in banks]          # step-major
    want = ref.mlp_megakernel_ref(x, weights, banks)
    before = ops.launches["mlp_megakernel"]
    got = ops.mlp_megakernel(x.to(cuda), [w.to(cuda) for w in weights],
                             [b.to(cuda) for b in banks])
    torch.cuda.synchronize()
    assert ops.launches["mlp_megakernel"] == before + 1
    assert torch.equal(got.cpu(), want)


def _chain_of_kind(rng, m, dims, steps, kind, codes):
    """numpy codes of one of ``kernel_bench.CODE_RANGES``, int8 weights and
    step-major banks of one of ``MT_BANK_KINDS`` from each stage's own
    accumulators, as torch tensors on the CPU."""
    from repro_torch.bench.kernel_bench import bank_of_kind

    h = _codes(rng, (m, dims[0]), codes).astype(np.int64)
    x = torch.as_tensor(h.astype(np.int32))
    weights, banks = [], []
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        acc = h @ w.astype(np.int64)
        t = bank_of_kind(rng, acc, n, s, kind)
        h = (acc[:, :, None] >= t[None]).sum(-1)
        weights.append(torch.as_tensor(w))
        banks.append(torch.as_tensor(t.T.copy()))
    return x, weights, banks


# (M, dims, steps, bank kind, code range): the edge cases of
# chip_smoke.py's K3_BRANCH_CASES — M of 1, 2, 15, 16, 17, 64; widths of
# 1, 8, 10, 12 and 500; 8 stages; the run whose weights stream; S of 1, 7,
# 255, 256 and 1000; unsorted and tied banks; every code range
K3_EDGE_CASES = (
    [(m, [490, 256, 256, 256], [7, 7, 7], "sorted", "s8")
     for m in (1, 2, 15, 16, 17, 64)]
    + [(17, [33, 1, 8, 10, 12, 500, 3], [7, 1, 255, 7, 1, 7], "sorted",
        "u8"),
       (300, [40, 24, 16, 8, 9, 30, 20, 12, 10], [3] * 8, "ties", "u8"),
       (64, [256, 1536, 1536, 256], [1, 1, 1], "sorted", "binary"),
       (130, [64, 72, 40, 24, 16], [1, 7, 255, 256], "unsorted", "s8"),
       (33, [72, 40, 24, 9], [1000, 255, 7], "mixed", "u8"),
       (257, [130, 72, 8, 72], [255, 255, 1000], "sorted", "wide")])


#: each edge case under the default plan and the pinned clusters and row
#: tiles whose plans fit (a host computation: the same on every machine)
K3_EDGE_PLANS = [case + (pin,) for case in K3_EDGE_CASES
                 for pin in ((None, None), (8, 8), (2, 16), (1, 64))
                 if ops.megakernel_plan(tuple(case[1]), tuple(case[2]),
                                        case[0], *pin)["fits"]]


@pytest.mark.parametrize("m,dims,steps,kind,codes,pin", K3_EDGE_PLANS)
def test_mlp_megakernel_edge_cases_equal_plain(cuda, m, dims, steps, kind,
                                               codes, pin):
    """K3 bit for bit against its plain version under the default plan and
    pinned clusters and row tiles, with packed weights; one cluster launch
    each."""
    rng = np.random.default_rng(m + sum(dims) + sum(steps))
    x, weights, banks = _chain_of_kind(rng, m, dims, steps, kind, codes)
    want = ref.mlp_megakernel_ref(x, weights, banks)
    packed = [ops.megakernel_pack_weights(w).to(cuda) for w in weights]
    before = ops.launches["mlp_megakernel"]
    got = ops.mlp_megakernel(x.to(cuda), packed, [b.to(cuda) for b in banks],
                             cluster=pin[0], block_m=pin[1])
    torch.cuda.synchronize()
    assert ops.launches["mlp_megakernel"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_mlp_megakernel_clusters_can_all_be_scheduled(cuda):
    """Every cluster size the plan may take is schedulable at a CTA's full
    shared memory; on a 132-SM card the counts are the plan's table."""
    got = [ops.megakernel_active_clusters(c, 232_448)
           for c in range(1, ops.MEGAKERNEL_MAX_CLUSTER + 1)]
    assert min(got) > 0
    props = torch.cuda.get_device_properties(0)
    if props.multi_processor_count == 132:
        assert tuple(got) == ops.MEGAKERNEL_ACTIVE_CLUSTERS


@pytest.mark.parametrize("m,k,n,relu,out_scale", [
    (1, 64, 40, True, 0.05), (1, 490, 256, True, None),
    (1024, 490, 256, True, 0.05), (1024, 128, 72, False, None),
    (4096, 4096, 4096, True, 0.125)])
def test_qmatmul_kernel_edge_shapes_equal_plain(cuda, m, k, n, relu,
                                                out_scale):
    """K5 at M = 1, the tiny models' dense shapes as the QAT layers give
    them, and 4096^3 (the 128 x 128 tile), bit for bit."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s = torch.rand(n, generator=g) * 9e-3 + 1e-3
    b = torch.randn(n, generator=g)
    kw = dict(relu=relu, out_scale=out_scale)
    x, w, s, b = x.to(cuda), w.to(cuda), s.to(cuda), b.to(cuda)
    got = ops.qmatmul(x, w, s, b, **kw)
    want = ref.qmatmul_ref(x, w, s, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ("kws", "ad", "ic", "cnv"))
@pytest.mark.parametrize("megakernel", (False, None))
def test_goldens_through_every_entry_point_on_the_card(cuda, name,
                                                       megakernel):
    """offline, streaming_host, streaming_compiled and a partly filled
    submit_wave on the card give the frozen outputs (integers exact,
    logits within 1e-5); in auto mode KWS, AD and CNV launch the
    megakernel once per offline call."""
    from repro_torch.core.qir import Graph
    from repro_torch.deploy import compile_graph

    graph = Graph.load(os.path.join(GOLDEN_DIR, f"{name}.qir.json"))
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))
    want = [data[k] for k in sorted(data.files) if k.startswith("stage_")][-1]
    x = data["x"]
    cm = compile_graph(graph, in_scale=graph.meta["in_scale"],
                       megakernel=megakernel)
    ops.reset_launches()
    y = cm.offline(x)
    torch.cuda.synchronize()
    fused = megakernel is None and name != "ic"
    assert ops.launches["mlp_megakernel"] == int(fused)
    outs = [y, cm.streaming_host(x, micro_batch=3)[0],
            cm.streaming_compiled(x, micro_batch=3)[0]]
    for got in outs:
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    valid = np.array([True, False, True])
    y_w, mask = cm.submit_wave(x[:3], valid=valid, micro_batch=4)
    np.testing.assert_allclose(y_w.cpu().numpy()[mask], want[:3][valid],
                               rtol=1e-5, atol=1e-5)


# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset, kv_len): GQA 32/8 and
# 4/2, the head dims 16/80/128, causal and not, window 32, a decode chunk
# (q_offset > 0, Sq < Sk), ragged Sq/Sk and kv_len below Sk
FLASH_CASES = [
    (1, 32, 8, 300, 300, 128, True, 0, 0, None),
    (2, 4, 2, 130, 130, 16, False, 0, 0, None),
    (1, 4, 2, 257, 257, 80, True, 32, 0, None),
    (2, 4, 2, 17, 95, 128, True, 0, 78, None),
    (1, 32, 8, 70, 133, 80, False, 0, 0, 101),
]

# the bf16 kernel's tile edges (128 query rows, 128 keys): Sq and Sk of
# 127, 129 and 255, and windows that cross a 128-key tile
FLASH_EDGE_CASES = [
    (1, 4, 2, 127, 127, 128, True, 0, 0, None),
    (2, 4, 2, 129, 129, 80, True, 0, 0, None),
    (1, 4, 2, 255, 255, 16, False, 0, 0, None),
    (1, 8, 2, 127, 255, 128, True, 0, 128, None),
    (1, 4, 2, 255, 129, 80, False, 0, 0, 127),
    (1, 4, 2, 255, 255, 128, True, 100, 0, None),
    (2, 4, 4, 129, 255, 128, False, 70, 100, 200),
]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_EDGE_CASES)
def test_flash_attention_kernel_equals_plain(cuda, case, dtype):
    """Within 1e-5 in float32 (sums in another order) and 2e-2 in bf16
    (the tensor-core kernel rounds P and the output to bf16), as the
    reference's kernel tests hold it; also on the model's (B, S, H, D)
    layout passed as strided views."""
    b, h, hkv, sq, sk, d, causal, window, q_offset, kv_len = case
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(sq * 7 + sk + d)
    q = torch.randn(b, sq, h, d, generator=g).to(dt).to(cuda)
    k = torch.randn(b, sk, hkv, d, generator=g).to(dt).to(cuda)
    v = torch.randn(b, sk, hkv, d, generator=g).to(dt).to(cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.backends.cuda.matmul.allow_tf32 = False     # a full-fp32 plain
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw)
    before = ops.launches["flash_attention"]
    for qq, kk, vv in ((q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)),
                       (q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous())):
        got = ops.flash_attention(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    assert ops.launches["flash_attention"] == before + 2


@pytest.mark.parametrize("m,c,steps", [(16, 8, 3), (128, 72, 255), (5, 3, 1),
                                       (24, 8, 300), (8, 40, 511),
                                       (1024, 72, 255), (97, 65, 65)])
def test_multi_threshold_kernel_equals_plain(cuda, m, c, steps):
    g = torch.Generator().manual_seed(m * 7 + c + steps)
    acc = torch.randint(-5000, 5000, (m, c), generator=g, dtype=torch.int32)
    thr = torch.sort(torch.randint(-4000, 4000, (c, steps), generator=g,
                                   dtype=torch.int32), dim=1).values
    want = ops.multi_threshold(acc, thr)                 # plain, on the CPU
    before = ops.launches["multi_threshold"]
    got = ops.multi_threshold(acc.to(cuda), thr.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches["multi_threshold"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,c,steps,kind", [
    (97, 65, 65, "unsorted"), (300, 40, 255, "unsorted"),
    (129, 72, 64, "ties"), (64, 9, 256, "ties"),
    (50, 33, 255, "extreme"), (7, 5, 4096, "extreme"),
    (300, 72, 255, "mixed"), (64, 40, 1024, "mixed"), (33, 20, 65, "mixed"),
    (200, 40, 63, "sorted"), (129, 33, 1024, "sorted"),
    (130, 32, 4096, "sorted"), (40, 3, 30000, "sorted")])
def test_multi_threshold_kernel_every_bank_kind_equals_plain(cuda, m, c,
                                                             steps, kind):
    """Sorted channels are searched, the others counted step by step, in
    the same call where a bank mixes them; deep banks take fewer channels
    per block (S 4096) or the chunked linear count (S 30000)."""
    from repro_torch.bench.kernel_bench import mt_inputs

    acc, thr = (torch.as_tensor(a) for a in mt_inputs(
        np.random.default_rng(m + c + steps), m, c, steps, kind))
    want = ops.multi_threshold(acc, thr)                 # plain, on the CPU
    before = ops.launches["multi_threshold"]
    got = ops.multi_threshold(acc.to(cuda), thr.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches["multi_threshold"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (100, 70, 50), (33, 200, 17),
                                   (512, 512, 512), (1, 3, 5)])
@pytest.mark.parametrize("relu,bias,out_scale", [(False, True, None),
                                                 (True, True, None),
                                                 (True, True, 0.125),
                                                 (False, False, 0.03),
                                                 (True, False, None)])
def test_qmatmul_kernel_equals_plain(cuda, m, k, n, relu, bias, out_scale):
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s = torch.rand(n, generator=g) * 9e-3 + 1e-3
    b = torch.randn(n, generator=g) if bias else None
    kw = dict(relu=relu, out_scale=out_scale)
    want = ops.qmatmul(x, w, s, b, **kw)                 # plain, on the CPU
    before = ops.launches["qmatmul"]
    got = ops.qmatmul(x.to(cuda), w.to(cuda), s.to(cuda),
                      None if b is None else b.to(cuda), **kw)
    torch.cuda.synchronize()
    assert ops.launches["qmatmul"] == before + 1
    assert got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,k,n", [(37, 70, 50), (4, 4096, 96),
                                   (129, 200, 17), (4096, 2048, 1024),
                                   (4, 32768, 8)])
def test_qmatmul_accumulator_mode_equals_plain(cuda, m, k, n):
    """K5's accumulator mode (``scale=None``) on both tiles: the int32
    sums of its plain version, bit for bit, codes at the extremes."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    x[0], w[:, 0] = -128, -127
    want = ops.qmatmul(x, w, None)                       # plain, on the CPU
    before = ops.launches["qmatmul"]
    got = ops.qmatmul(x.to(cuda), w.to(cuda), None)
    torch.cuda.synchronize()
    assert ops.launches["qmatmul"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m,k,n,s", [(37, 19, 70, 7), (1024, 490, 256, 7),
                                     (130, 65, 129, 255)])
def test_threshold_matmul_every_tile_equals_plain(cuda, m, k, n, s):
    g = torch.Generator().manual_seed(m + k + n + s)
    x = torch.randint(0, 256, (m, k), generator=g, dtype=torch.int32)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    acc = ref.int_matmul(x, w)
    t = torch.sort(torch.randint(int(acc.min()), int(acc.max()) + 1, (n, s),
                                 generator=g, dtype=torch.int32), dim=1).values
    want = ref.threshold_matmul_ref(x, w, t)
    x, w, t = x.to(cuda), w.to(cuda), t.to(cuda)
    for bm in ops.TMM_TILE_SIZES:
        for bn in ops.TMM_TILE_SIZES:
            got = ops.threshold_matmul(x, w, t, block_m=bm, block_n=bn)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (bm, bn)


@pytest.mark.parametrize("block_h", [1, 3, 8, 15])
def test_conv_threshold_row_blocks_equal_plain(cuda, block_h):
    g = torch.Generator().manual_seed(block_h)
    x = torch.randint(0, 256, (3, 15, 17, 5), generator=g, dtype=torch.int32)
    w2d = torch.randint(-127, 128, (45, 6), generator=g, dtype=torch.int8)
    t = torch.sort(torch.randint(-40000, 40000, (6, 255), generator=g,
                                 dtype=torch.int32), dim=1).values
    kw = dict(kernel=3, stride=1, padding="SAME", out_h=15, out_w=17)
    want = ops.conv_threshold(x, w2d, t, **kw)
    got = ops.conv_threshold(x.to(cuda), w2d.to(cuda), t.to(cuda),
                             block_h=block_h, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the serving stack on the card: events, streams, stream ordering
# ---------------------------------------------------------------------------

def _golden_on(name, device, megakernel=None):
    """The golden graph compiled on ``device``, its headless twin (the
    same schedule without the float head: integer codes out) and its
    input rows."""
    import dataclasses

    from repro_torch.core.qir import Graph
    from repro_torch.deploy import CompiledTinyModel, compile_graph

    graph = Graph.load(os.path.join(GOLDEN_DIR, f"{name}.qir.json"))
    x = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))["x"]
    cm = compile_graph(graph, in_scale=graph.meta["in_scale"], device=device,
                       megakernel=megakernel)
    head = CompiledTinyModel(
        dataclasses.replace(cm.schedule, stages=cm.schedule.stages[:-1]),
        device=cm.device, megakernel=cm.megakernel)
    return cm, head, x


def test_wave_handle_waits_on_its_cuda_event(cuda):
    from repro_torch.serve import Replica

    cm, head, x = _golden_on("kws", cuda)
    rep = Replica(index=0, model=head, device=cuda)
    assert rep.stream is not None and rep.stream != torch.cuda.current_stream()
    h = rep.submit(x[:3], micro_batch=4)
    assert isinstance(h._event, torch.cuda.Event)
    assert h.ready() in (True, False)          # a query, never a block
    y, mask = h.wait()
    assert h.ready() and h._event.query()
    assert mask.tolist() == [True, True, True, False]
    assert torch.equal(y[:3].cpu(), head.offline(x[:3]).cpu())


def test_two_replica_streams_on_one_card_equal_offline(cuda):
    """Two logical replicas sharing one executor on one card (two streams)
    under the async engine: every served row equals ``offline`` (codes bit
    for bit, logits within 1e-5), and both streams took waves."""
    from repro_torch.serve import (AsyncEngine, ManualClock, ReplicaPool,
                                   Router, RouterConfig)

    for model, exact in ((0, True), (1, False)):
        cm, head, x = _golden_on("ad", cuda)
        served = (head, cm)[model]
        pool = ReplicaPool(factory=lambda: served, devices=[cuda, cuda])
        assert pool.replicas[0].stream != pool.replicas[1].stream
        router = Router({"m": pool}, RouterConfig(micro_batch=2,
                                                  max_wait_ms=1.0),
                        clock=ManualClock(), engine=AsyncEngine())
        rows = np.concatenate([x] * 4)
        reqs = [router.submit("m", r) for r in rows]
        router.drain()
        want = served.offline(rows).cpu().numpy()
        got = np.stack([r.result for r in reqs])
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert all(r.n_dispatched > 0 for r in pool.replicas)


def test_replica_stream_waits_for_weights_packed_after_apply_tuned(cuda):
    """``apply_tuned`` re-packs K3's weights on the current stream; a wave
    submitted at once on a replica stream, while that work still queues
    behind a long kernel, must see the packed weights."""
    import dataclasses
    import tempfile

    from repro_torch.deploy.autotune import autotune_model
    from repro_torch.serve import Replica

    cm, head, x = _golden_on("kws", cuda)
    want = head.offline(x).cpu()
    with tempfile.TemporaryDirectory() as d:
        cfg = autotune_model(head, mode="model", directory=d, force=True)
    cfg = dataclasses.replace(cfg, segment_mode="megakernel")
    rep = Replica(index=0, model=head, device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)           # ~0.1 s on the current stream
    head.apply_tuned(cfg)                    # packing queues behind it
    assert head._mega_plans
    before = ops.launches["mlp_megakernel"]
    y, _ = rep.submit(x, micro_batch=x.shape[0]).wait()
    assert ops.launches["mlp_megakernel"] == before + 1
    assert torch.equal(y.cpu(), want)


def test_faulty_model_corrupts_a_cuda_wave_on_the_card(cuda):
    """A ``corrupt_output`` fault on a wave on the card is written on the
    device, caught by the integrity guard and retried; served rows equal
    ``offline``. A slowdown waits for the wave before stretching it."""
    from repro_torch.serve import (FaultPlan, FaultSpec, FaultyModel,
                                   ManualClock, ReplicaPool, Router,
                                   RouterConfig, SyncEngine, faulty_pool)

    cm, head, x = _golden_on("kws", cuda)
    clock = ManualClock()
    plan = FaultPlan([FaultSpec("corrupt_output", replica=0, wave=1),
                      FaultSpec("replica_slowdown", replica=0, wave=2,
                                factor=3.0)])
    pool = faulty_pool(ReplicaPool(head), plan, clock=clock)
    assert isinstance(pool.replicas[0].model, FaultyModel)
    router = Router({"kws": pool}, RouterConfig(micro_batch=2,
                                                max_wait_ms=1.0),
                    clock=clock, engine=SyncEngine())
    reqs = [router.submit("kws", x[i], arrival_t=0.0) for i in range(2)]
    router.drain()
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]),
                                  head.offline(x[:2]).cpu().numpy())
    assert router.stats()["kws"]["metrics"].fault_counts == {"integrity": 1}


def _head_inputs(m, k, n, seed):
    """Codes of an 8-bit stage (0..255) and Glorot-scale head weights, as
    the deployed heads get them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (m, k), generator=g, dtype=torch.int32)
    w = torch.randn((k, n), generator=g) * (2.0 / (k + n)) ** 0.5
    b = torch.randn((n,), generator=g) * 0.1
    return x, w, b


@pytest.mark.parametrize("m,k,n", [(1024, 72, 128), (1024, 256, 12),
                                   (1024, 512, 10), (37, 5, 3),
                                   (1000, 511, 12), (1, 256, 10),
                                   (7, 1, 128), (130, 300, 200)])
def test_float_head_rows_do_not_depend_on_the_row_count(cuda, m, k, n):
    """The float head's logits of any 64-row slice equal the same rows of
    the whole call bit for bit (cuBLAS's reduction depends on the shape;
    the kernel sums each output in one fixed order)."""
    x, w, b = (t.to(cuda) for t in _head_inputs(m, k, n, m + k + n))
    before = ops.launches["float_head"]
    whole = ops.float_head(x, w, 2.0 ** -5, b)
    for lo in range(0, m, 64):
        part = ops.float_head(x[lo:lo + 64].contiguous(), w, 2.0 ** -5, b)
        assert torch.equal(part, whole[lo:lo + 64])
    assert ops.launches["float_head"] == before + 1 + -(-m // 64)


@pytest.mark.parametrize("m,k,n", [
    (1024, 72, 128), (1024, 256, 12), (64, 512, 10), (1, 256, 10),
    # the tiles' edges: M of 1, 7, 1000 and 1024, K from 1 to 512 (ragged
    # against the 4-wide loads), N of 10, 12 and 128
    *[(m, k, n) for m in (1, 7, 1000, 1024) for k in (1, 3, 72, 257, 512)
      for n in (10, 12, 128)]])
def test_float_head_kernel_equals_plain(cuda, m, k, n):
    x, w, b = (t.to(cuda) for t in _head_inputs(m, k, n, 7 * m + n))
    got = ops.float_head(x, w, 2.0 ** -7, b)
    want = ref.float_head_ref(x, w, 2.0 ** -7, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _kws_train(model, dev, steps):
    """``train_tiny`` of ``model`` (a small KWS MLP, eval-mode BN as the
    benchmarks train it) on ``dev`` from seed-1 parameters and five seeded
    batches; returns (parameters, losses)."""
    from repro_torch.core.codesign import train_tiny

    r = np.random.default_rng(0)
    xs = [torch.tensor(r.standard_normal((32, model.in_dim)).astype(
        np.float32)) for _ in range(5)]
    ys = [torch.tensor(r.integers(0, model.n_classes, 32)) for _ in range(5)]

    def loss(net, batch):
        x, y = batch
        logits = model.apply(net, x, train=False)
        return torch.mean(torch.logsumexp(logits, -1)
                          - logits.gather(1, y[:, None])[:, 0])

    net = model.init(torch.Generator().manual_seed(1)).to(dev)
    _, losses = train_tiny(loss, net, lambda t: (xs[t].to(dev),
                                                 ys[t].to(dev)),
                           steps=steps, lr=3e-3)
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}, \
        losses


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """One ``train_tiny`` step of a small KWS MLP with 3-bit weights on
    the card and on the CPU from the same parameters and batch: the
    parameters within 1e-5, and the losses of five steps within 1e-3
    relative. Its activations stay in float32: with 3-bit activations the
    pre-activations sit on a lattice where many cancel to within float
    rounding of 0, so the ReLU masks that the straight-through gradient
    passes depend on the summation order
    (``test_torch_qat.py::test_low_bit_activation_gradients_hang_on_float_rounding``);
    that case is held by
    ``test_quantized_activation_forward_on_the_card_equals_the_cpu``."""
    from repro_torch.models.tiny import KWSMLP

    model = KWSMLP(in_dim=40, width=24, n_classes=5, act_bits=32)
    p_cpu, _ = _kws_train(model, "cpu", 1)
    p_gpu, _ = _kws_train(model, cuda, 1)
    for k, v in p_cpu.items():
        torch.testing.assert_close(p_gpu[k], v, rtol=1e-5, atol=1e-5)
    _, l_cpu = _kws_train(model, "cpu", 5)
    _, l_gpu = _kws_train(model, cuda, 5)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-3)


def test_quantized_activation_forward_on_the_card_equals_the_cpu(cuda):
    """The 3-bit KWS MLP's QAT forward on the card against the CPU, layer
    by layer from the same input: every activation code equals the CPU's
    but where the CPU's value sits on a rounding tie (y / s within 1e-4 of
    a half step); there the two differ by one step at most. With 3-bit activations the pre-activations are sums of a few
    lattice values, so exact ties are common and their rounding follows
    the summation order. The head on the same codes: within 1e-5."""
    from repro_torch.models.tiny import KWSMLP

    model = KWSMLP(in_dim=40, width=24, n_classes=5)
    r = np.random.default_rng(0)
    h = torch.tensor(r.standard_normal((64, 40)).astype(np.float32))
    nets = {dev: model.init(torch.Generator().manual_seed(1)).to(dev)
            for dev in ("cpu", "cuda")}
    with torch.no_grad():
        for i in range(3):
            pre, codes = {}, {}
            for dev, net in nets.items():
                layer = net.hidden[i]
                k, b = layer.fold()
                y = torch.relu(h.to(dev) @ layer.wq(k) + b)
                s = layer.aq.scale(y)
                pre[dev], codes[dev] = (y / s).cpu(), torch.round(y / s).cpu()
                out = layer(h.to(dev), train=False).cpu()
                torch.testing.assert_close(out, codes[dev] * s.cpu(),
                                           rtol=0, atol=0)
            off = codes["cuda"] != codes["cpu"]
            frac = pre["cpu"] - torch.floor(pre["cpu"])
            tie = (frac - 0.5).abs() < 1e-4
            assert bool((off <= tie).all()), f"layer {i}: off-tie codes"
            assert float((codes["cuda"] - codes["cpu"]).abs().max()) <= 1
            h = nets["cpu"].hidden[i](h, train=False)
        logits = {dev: net.head(h.to(dev), train=False).cpu()
                  for dev, net in nets.items()}
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-5,
                               atol=1e-5)


def test_graph_run_of_the_full_width_cnv_equals_the_cpu(cuda):
    """``Graph.run`` (the unfused reference of Table 6) on the card gives the
    CPU's outputs on the full-width CNV: its binary convs sum integers, and
    cuDNN's float32 algorithms put them up to 3.4e-5 off, flipping signs
    at the thresholds (argmax parity with the compiled model fell to 1 in
    8); ``conv2d_nhwc`` runs with cuDNN off."""
    from repro_torch.bench.models import cnv_graph

    g = cnv_graph(4)
    x = np.random.default_rng(5).integers(-127, 128, (8, 32, 32, 3))
    feeds = {g.inputs[0]: (x * g.meta["in_scale"]).astype(np.float32)}
    got, want = g.run(feeds, device=cuda), g.run(feeds, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert torch.backends.cudnn.enabled


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,q_off,kv_len", [
    (2, 8, 2, 300, 300, 128, True, 0, 0, None),
    (1, 4, 4, 129, 255, 80, False, 70, 100, 200),
    (2, 4, 1, 65, 200, 16, True, 32, 120, 150),
    (1, 2, 2, 5, 5, 16, True, 0, -3, None),
    # the tensor-core route's tile edges (64-row and 128-row tiles)
    *[(1, 4, 2, s, s, 128, True, 0, 0, None)
      for s in (63, 64, 65, 127, 128, 129, 255)],
    (1, 4, 4, 64, 129, 16, False, 0, 0, None),      # GQA 1, Sq != Sk
    (1, 8, 2, 127, 65, 80, False, 0, 0, None),      # GQA 4
    (2, 4, 2, 255, 255, 80, True, 40, 0, None),     # a window
    (1, 4, 2, 129, 128, 16, False, 33, 7, 100),     # window, offset, kv_len
    (2, 8, 4, 16, 255, 128, True, 0, 239, None),    # a decode chunk
    (1, 4, 2, 128, 128, 128, True, 0, -3, None),    # rows with no live key
    (1, 4, 2, 65, 129, 80, True, 0, 0, 0),          # kv_len 0
    (2, 16, 8, 4096, 4096, 128, True, 0, 0, None),  # the training shape
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_equals_plain(cuda, b, h, hkv, sq, sk, d,
                                                 causal, window, q_off,
                                                 kv_len, dtype):
    """K6's backward kernel against ``ref.flash_attention_bwd_ref`` on the
    forward kernel's lse: dQ, dK, dV within 1e-5 (float32) / 2e-2 (bf16)
    of the largest |gradient|; one launch a call; a second call equal bit
    for bit (no atomics decide a result). The bf16 cases walk the
    tensor-core route's edges: Sq and Sk around its 64- and 128-row
    tiles, GQA groups of 1, 2 and 4, each head dim, windows, a query
    offset of -3 and a decode chunk, kv_len 0, and the LM's training
    shape."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q, k, v, do = (torch.randn(b, s, n, d, generator=g, device=cuda).to(dt)
                   .transpose(1, 2)
                   for s, n in ((sq, h), (sk, hkv), (sk, hkv), (sq, h)))
    kw = dict(causal=causal, window=window, q_offset=q_off, kv_len=kv_len)
    out, lse = ops._flash_forward(q, k, v, causal, window, q_off,
                                  sk if kv_len is None else kv_len, True)
    before = ops.launches["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, a2, w in zip(got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, a2)
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((a.float() - w.float()).abs().max()) <= tol * scale


def test_flash_attention_bwd_copies_a_misaligned_d_out(cuda):
    """bf16 d_out and out come in whatever layout autograd hands over: a
    base off the 16-byte TMA rule is copied (the gradients equal those of
    an aligned copy bit for bit), while a misaligned q raises, as the
    forward's does."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, do = (torch.randn(1, n, 70, 128, generator=g, device=cuda)
                   .bfloat16() for n in (4, 2, 2, 4))
    out, lse = ops._flash_forward(q, k, v, True, 0, 0, 70, True)
    flat = torch.empty(do.numel() + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(do.shape)
    odd.copy_(do)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    got = ops.flash_attention_bwd(q, k, v, out, lse, odd)
    want = ops.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    qflat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_odd = qflat[1:].view(q.shape)
    q_odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention_bwd(q_odd, k, v, out, lse, do)


def test_flash_attention_autograd_launches_both_kernels(cuda):
    """Under autograd on CUDA tensors the forward kernel writes the lse and
    the backward kernel runs: one launch of each, gradients equal to the
    plain backward on the same lse."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 100, n, 128, generator=g, device=cuda)
               .bfloat16().transpose(1, 2).requires_grad_(True)
               for n in (8, 2, 2))
    do = torch.randn(1, 8, 100, 128, generator=g, device=cuda).bfloat16()
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 1
    qd, kd, vd, od = (t.detach() for t in (q, k, v, out))
    _, lse = ops._flash_forward(qd, kd, vd, True, 0, 0, 100, True)
    direct = ops.flash_attention_bwd(qd, kd, vd, od, lse, do)
    want = ref.flash_attention_bwd_ref(qd, kd, vd, od, lse, do)
    for a, d, w in zip(grads, direct, want):
        assert torch.equal(a, d)
        assert float((a.float() - w.float()).abs().max()) <= \
            2e-2 * float(w.float().abs().max())


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda, impl):
    """One step of the reduced internlm2 (float32, remat "full") from the
    same weights on the card and on the CPU: loss and metrics within
    1e-5, updated parameters within 2e-5, the bound the CPU tests hold the
    port's step to against the reference's (the card's float32 matmuls
    and K6's kernels sum in other orders, and AdamW's first step moves a
    parameter by lr g / (|g| + eps), which for a gradient near eps hangs
    on its last bits)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.pytree import leaves, tree_map
    from repro_torch.core.qir import full_fp32
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.steps import TrainState, make_train_step

    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              attn_impl=impl)
    m = Model(cfg)
    p_cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    opt = make_optimizer(base_lr=1e-3, warmup=1, total=10)
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=64).batch(0, 4)
    step = make_train_step(m, opt)
    ops.reset_launches()
    with full_fp32():
        s_gpu, met_gpu = step(TrainState(p_gpu, opt.init(p_gpu)), batch)
    torch.cuda.synchronize()
    n = cfg.n_layers if impl == "chunked" else 0
    assert ops.launches["flash_attention"] == 2 * n
    assert ops.launches["flash_attention_bwd"] == n
    s_cpu, met_cpu = step(TrainState(p_cpu, opt.init(p_cpu)), batch)
    for key in met_cpu:
        torch.testing.assert_close(met_gpu[key].cpu(), met_cpu[key],
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(leaves(s_gpu.params), leaves(s_cpu.params)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=2e-5)


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint.checkpoint import restore, save

    tree = {"w": torch.randn(4, 4).bfloat16(), "s": torch.tensor(3)}
    save(str(tmp_path), 1, tree)
    like = {"w": torch.empty(0, device=cuda), "s": torch.empty(0,
                                                               device=cuda)}
    got, step, _ = restore(str(tmp_path), like)
    assert step == 1 and got["w"].device.type == "cuda"
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].cpu(), tree["w"])
    assert int(got["s"]) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_on_the_card_equals_the_cpu(cuda, dtype):
    """The int8 serve path's linear: one K5 launch on the card, equal bit
    for bit to the same linear on the CPU (K5's plain version; the
    activation quantizer's elementwise ops round alike on both)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduced(),
                              dtype={torch.float32: "float32",
                                     torch.bfloat16: "bfloat16"}[dtype])
    g = torch.Generator().manual_seed(7)
    d = cfg.d_model
    q = layers.quantize_linear_params(
        {"w": (torch.randn((d, 3, 40), generator=g) * 0.1).to(dtype),
         "b": torch.randn((3, 40), generator=g).to(dtype)}, 8)
    x = (torch.randn((2, 37, d), generator=g) * 2).to(dtype)
    want = layers.linear_apply(cfg, q, x)
    before = ops.launches["qmatmul"]
    got = layers.linear_apply(cfg, {k: v.to(cuda) for k, v in q.items()},
                              x.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches["qmatmul"] == before + 1
    assert got.dtype == dtype and torch.equal(got.cpu(), want)

