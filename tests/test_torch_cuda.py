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
