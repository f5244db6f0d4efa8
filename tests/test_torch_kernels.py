"""The port's kernel wrappers on the CPU against the JAX package.

On CPU tensors ``repro_torch.kernels.ops`` runs each kernel's plain
version; these tests hold it against the Pallas kernel run in interpret
mode (``repro.kernels.ops``, ``interpret=True``) and against the reference
oracle, on the same numpy inputs. Integer outputs, so every comparison is
exact. Interpret-mode shapes stay tiny.
"""

import numpy as np
import pytest
import torch

from repro.kernels import conv_threshold as jct
from repro.kernels import ops as jops
from repro_torch.kernels import conv_threshold as tct
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _bank(rng, acc, n, s, sort=True):
    lo, hi = int(acc.min()) - 2, int(acc.max()) + 2
    t = rng.integers(lo, hi + 1, (n, s)).astype(np.int32)
    if s > 2:
        t[:, 1] = t[:, 0]                  # a duplicate threshold per channel
    return np.sort(t, axis=1) if sort else t


TMM_CASES = [
    # (M, K, N, S, lo, hi): ragged M/N/K, signed input codes and 0..255
    (5, 7, 9, 1, -127, 128),
    (13, 33, 17, 7, 0, 8),
    (3, 20, 6, 255, 0, 256),
    (9, 40, 130, 7, -127, 128),
    (1, 1, 1, 255, 0, 256),
]


@pytest.mark.parametrize("m,k,n,s,lo,hi", TMM_CASES)
def test_threshold_matmul_matches_pallas_interpret_and_ref(m, k, n, s, lo, hi):
    rng = np.random.default_rng(m * 1000 + k * 10 + s)
    x = rng.integers(lo, hi, (m, k)).astype(np.int32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    acc = x.astype(np.int64) @ w.astype(np.int64)
    t = _bank(rng, acc, n, s)
    want = np.asarray(jops.threshold_matmul(x, w, t, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jops.threshold_matmul_ref(x, w, t)))
    got = tops.threshold_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(t))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_matmul_unsorted_bank_counts_linearly():
    """The kernel counts the bank linearly, so an unsorted bank gives the
    reference oracle's count too."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 8, (11, 23)).astype(np.int32)
    w = rng.integers(-3, 4, (23, 5)).astype(np.int8)
    t = _bank(rng, x.astype(np.int64) @ w, 5, 7, sort=False)
    want = np.asarray(jops.threshold_matmul_ref(x, w, t))
    got = tops.threshold_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = [
    # (N, H, W, C, F, K, stride, padding, S)
    (2, 5, 7, 1, 3, 1, 1, "SAME", 3),
    (1, 7, 5, 3, 4, 3, 2, "SAME", 7),
    (2, 9, 9, 3, 2, 4, 4, "SAME", 1),
    (1, 9, 7, 1, 3, 3, 1, "VALID", 255),
    (1, 8, 11, 3, 2, 4, 2, "VALID", 7),
    (1, 9, 9, 1, 2, 3, 1, "SAME", 7),
]


@pytest.mark.parametrize("n,h,w,c,f,k,stride,padding,s", CONV_CASES)
def test_conv_threshold_matches_pallas_interpret(n, h, w, c, f, k, stride,
                                                 padding, s):
    rng = np.random.default_rng(h * 100 + w * 10 + k + stride)
    x = rng.integers(0, 256, (n, h, w, c)).astype(np.int32)
    w2d = rng.integers(-127, 128, (k * k * c, f)).astype(np.int8)
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    t = _bank(rng, np.array([-k * k * c * 127 * 60, k * k * c * 127 * 60]),
              f, s)
    kw = dict(kernel=k, stride=stride, padding=padding, out_h=oh, out_w=ow)
    want = np.asarray(jops.conv_threshold(x, w2d, t, interpret=True, **kw))
    got = tops.conv_threshold(torch.from_numpy(x), torch.from_numpy(w2d),
                              torch.from_numpy(t), **kw)
    assert got.shape == (n, oh, ow, f)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,stride,padding", [(1, 1, "SAME"), (3, 2, "SAME"),
                                              (4, 4, "SAME"), (3, 1, "VALID"),
                                              (5, 2, "VALID")])
def test_direct_conv_acc_matches_reference(k, stride, padding):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.integers(-127, 128, (2, 11, 9, 3)).astype(np.int32)
    w2d = rng.integers(-127, 128, (k * k * 3, 4)).astype(np.int8)
    if padding == "SAME":
        oh, ow = -(-11 // stride), -(-9 // stride)
        ph, pw = jct.same_pads(11, 9, oh, ow, stride, k)
        xp = np.pad(x, ((0, 0), ph, pw, (0, 0)))
    else:
        oh, ow = (11 - k) // stride + 1, (9 - k) // stride + 1
        xp = x
    want = np.asarray(jct.direct_conv_acc(xp, w2d, kernel=k, stride=stride,
                                          out_h=oh, out_w=ow))
    got = tct.direct_conv_acc(torch.from_numpy(xp), torch.from_numpy(w2d),
                              kernel=k, stride=stride, out_h=oh, out_w=ow)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,stride,kernel", [(5, 5, 1, 1), (16, 16, 4, 4),
                                               (11, 7, 2, 3), (9, 12, 3, 5),
                                               (4, 4, 1, 4)])
def test_host_helpers_match_reference(h, w, stride, kernel):
    oh, ow = -(-h // stride), -(-w // stride)
    assert tct.same_pads(h, w, oh, ow, stride, kernel) == \
        jct.same_pads(h, w, oh, ow, stride, kernel)
    for bh in (1, 2, 5):
        assert tct.band_rows(bh, stride, kernel) == \
            jct.band_rows(bh, stride, kernel)
    for out_ch in (1, 32, 4096):
        assert tct.plan_conv_blocks(oh, ow, out_ch) == \
            jops.plan_conv_blocks(oh, ow, out_ch)


@pytest.mark.parametrize("k,stride,padding", [(3, 2, "SAME"), (4, 1, "SAME"),
                                              (3, 1, "VALID")])
def test_pad_input_is_the_reference_same_split(k, stride, padding):
    x = np.arange(2 * 7 * 5 * 3, dtype=np.int32).reshape(2, 7, 5, 3)
    if padding == "SAME":
        oh, ow = -(-7 // stride), -(-5 // stride)
        want = np.pad(x, ((0, 0), *jct.same_pads(7, 5, oh, ow, stride, k),
                          (0, 0)))
    else:
        oh, ow = (7 - k) // stride + 1, (5 - k) // stride + 1
        want = x
    got = tct.pad_input(torch.from_numpy(x), kernel=k, stride=stride,
                        padding=padding, out_h=oh, out_w=ow)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_matmul_is_exact_at_int32_scale():
    rng = np.random.default_rng(3)
    a = rng.integers(-255, 256, (7, 4000)).astype(np.int32)
    b = rng.integers(-127, 128, (4000, 5)).astype(np.int8)
    got = tref.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 6), dtype=torch.int32)
    w = torch.zeros((6, 3), dtype=torch.int8)
    t = torch.zeros((3, 7), dtype=torch.int32)
    with pytest.raises(TypeError):
        tops.threshold_matmul(x.to(torch.int8), w, t)
    with pytest.raises(TypeError):
        tops.threshold_matmul(x, w.to(torch.int32), t)
    with pytest.raises(ValueError):
        tops.threshold_matmul(x, w[:5], t)
    with pytest.raises(ValueError):
        tops.threshold_matmul(torch.zeros((6, 4), dtype=torch.int32).T, w, t)
    xc = torch.zeros((1, 5, 5, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.conv_threshold(xc, torch.zeros((9, 3), dtype=torch.int8), t,
                            kernel=3, stride=1, padding="SAME", out_h=5,
                            out_w=5)
    with pytest.raises(ValueError):
        tops.conv_threshold(xc, torch.zeros((18, 3), dtype=torch.int8), t,
                            kernel=3, stride=1, padding="FULL", out_h=5,
                            out_w=5)


def test_cpu_path_does_not_count_launches():
    tops.reset_launches()
    x = torch.ones((2, 3), dtype=torch.int32)
    tops.threshold_matmul(x, torch.ones((3, 2), dtype=torch.int8),
                          torch.zeros((2, 1), dtype=torch.int32))
    tops.conv_threshold(torch.ones((1, 3, 3, 1), dtype=torch.int32),
                        torch.ones((1, 2), dtype=torch.int8),
                        torch.zeros((2, 1), dtype=torch.int32), kernel=1,
                        stride=1, padding="VALID", out_h=3, out_w=3)
    tops.mlp_megakernel(x, [torch.ones((3, 2), dtype=torch.int8),
                            torch.ones((2, 2), dtype=torch.int8)],
                        [torch.zeros((1, 2), dtype=torch.int32)] * 2)
    q = torch.ones((1, 2, 3, 16))
    tops.flash_attention(q, q, q)
    tops.multi_threshold(x, torch.zeros((3, 2), dtype=torch.int32))
    tops.qmatmul(torch.ones((2, 3), dtype=torch.int8),
                 torch.ones((3, 2), dtype=torch.int8), torch.ones(2),
                 out_scale=0.5)
    assert tops.launches == {"threshold_matmul": 0, "conv_threshold": 0,
                             "mlp_megakernel": 0, "flash_attention": 0,
                             "multi_threshold": 0, "qmatmul": 0,
                             "float_head": 0}


@pytest.mark.parametrize("n,h,w,c,f,k,stride,padding,s", [
    (2, 7, 9, 3, 5, 3, 1, "SAME", 7), (1, 9, 9, 8, 4, 3, 2, "VALID", 255),
    (2, 6, 6, 1, 3, 1, 1, "SAME", 3)])
def test_conv_threshold_unsorted_bank_counts_linearly(n, h, w, c, f, k,
                                                      stride, padding, s):
    """An unsorted bank (and one sorted channel beside unsorted ones) gives
    the Pallas kernel's count: the CUDA kernel searches only the channels
    whose bank does not fall and counts the others step by step."""
    rng = np.random.default_rng(n + h + c + s)
    x = rng.integers(0, 256, (n, h, w, c)).astype(np.int32)
    w2d = rng.integers(-127, 128, (k * k * c, f)).astype(np.int8)
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    kw = dict(kernel=k, stride=stride, padding=padding, out_h=oh, out_w=ow)
    acc = tct.direct_conv_acc(tct.pad_input(torch.from_numpy(x), **kw),
                              torch.from_numpy(w2d), kernel=k, stride=stride,
                              out_h=oh, out_w=ow).numpy()
    t = _bank(rng, acc, f, s, sort=False)
    t[0] = np.sort(t[0])
    want = np.asarray(jops.conv_threshold(x, w2d, t, interpret=True, **kw))
    got = tops.conv_threshold(torch.from_numpy(x), torch.from_numpy(w2d),
                              torch.from_numpy(t), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want < s).any()


@pytest.mark.parametrize("bm", tops.TMM_TILE_SIZES)
@pytest.mark.parametrize("bn", tops.TMM_TILE_SIZES)
def test_threshold_matmul_plan_searches_whole_banks_that_fit(bm, bn):
    # code and weight tiles, the accumulator tile, then the banks, padded
    # to 2^k - 1 steps: the deepest searched bank is the longest such
    # padding that fits
    tiles = (bm + bn) * tops.TMM_TILE_ROW_BYTES + bm * (bn + 1) * 4
    deepest = 1
    while (2 * deepest + 1) * bn * 4 + tiles <= tops.STAGE_SMEM_BYTES:
        deepest = 2 * deepest + 1
    for s in (1, 7, 255, deepest):
        plan = tops.threshold_matmul_plan(bm, bn, s)
        assert plan["search"] and plan["smem_bytes"] == \
            tiles + tops.search_steps(s) * bn * 4 <= tops.STAGE_SMEM_BYTES
    plan = tops.threshold_matmul_plan(bm, bn, deepest + 1)
    assert not plan["search"]
    assert plan["smem_bytes"] == tiles + tops.BANK_CHUNK_STEPS * bn * 4


def test_search_steps_pad_banks_to_a_power_of_two_less_one():
    assert [tops.search_steps(s) for s in (0, 1, 2, 3, 7, 8, 255, 256,
                                           1024, 2000)] == \
        [0, 1, 3, 3, 7, 15, 255, 511, 2047, 2047]


def test_threshold_matmul_plan_at_the_main_paths_banks():
    # KWS (S 7), AD and IC's 8-bit banks (S 255) and CNV's binary ones are
    # searched under every tile; 1000 steps (padded to 1023) only with 32
    # channels a block; 1024 (padded to 2047) under none
    for bm in tops.TMM_TILE_SIZES:
        for bn in tops.TMM_TILE_SIZES:
            assert all(tops.threshold_matmul_plan(bm, bn, s)["search"]
                       for s in (1, 7, 255))
            assert tops.threshold_matmul_plan(bm, bn, 1000)["search"] == \
                (bn == 32)
            assert not tops.threshold_matmul_plan(bm, bn, 1024)["search"]


def test_conv_threshold_plan_lays_out_a_block():
    # IC conv1 at full width: 32 channels in, 4 out, 4x4 SAME, S 255: 8
    # channels a block (256 pixels a pass), banks in 32 slots
    p = tops.conv_threshold_plan(32, 4, 4, 1, 35, 32, 32, 8, 255)
    assert p == {"block_h": 8, "block_n": 8, "pixel_stride": 48,
                 "k_chunk": 512, "samples_per_block": 1, "search": True,
                 "smem_bytes": 11 * 35 * 48 + 256 * 12 + 256 * 9 * 4
                 + 512 // 4 * 4 + 255 * 32 * 4 + 8 * (512 // 4 + 4) * 4}
    assert [tops.conv_threshold_plan(32, f, 4, 1, 35, 32, 32, 8, 255)[
        "block_n"] for f in (1, 8, 9, 16, 17, 32, 33, 256)] == \
        [8, 8, 16, 16, 32, 32, 64, 64]
    assert [tops.conv_pass_pixels(b) for b in tops.CONV_BLOCK_N] == \
        [256, 256, 128, 128]
    # thin input channels: padded to 4 (a zero fourth channel), 3x3x4 = 36
    # deep: two 32-deep steps
    p = tops.conv_threshold_plan(3, 64, 3, 1, 32, 30, 30, 9, 1)
    assert (p["block_n"], p["pixel_stride"], p["k_chunk"]) == (64, 4, 64)
    # pixel strides: C rounded up to 4, from 32 channels padded to 16 mod
    # 32 bytes
    assert [tops._pixel_stride(c) for c in (1, 3, 4, 8, 16, 32, 64, 128,
                                            256, 36)] == \
        [4, 4, 4, 8, 16, 48, 80, 144, 272, 48]
    # CNV conv5 at full width (one output pixel a sample): all 2304
    # weight rows of 64 channels fit, beside the bands of 8 samples
    p = tops.conv_threshold_plan(256, 256, 3, 1, 3, 1, 1, 1, 1,
                                 samples=1024)
    assert (p["k_chunk"], p["search"]) == (2304, True)
    assert p["samples_per_block"] == tops.CONV_MAX_SAMPLES == 8
    assert p["smem_bytes"] <= tops.STAGE_SMEM_BYTES
    # block pixels: 8192 over the k steps, within [256, 1024]
    assert [tops.conv_block_pixels(c, k) for c, k in
            ((3, 1), (4, 4), (32, 4), (64, 3), (256, 3))] == \
        [1024, 1024, 512, 455, 256]
    assert tops.conv_block_rows(30, 30, 3, 3) == 30       # 1024 pixels
    assert tops.conv_block_rows(28, 28, 64, 3) == 16      # 455 pixels
    # IC conv4 (4 x 4 outputs, 16 k steps: 512 pixels): at most 8 samples;
    # fewer in the batch cap it; a block of fewer rows than the image
    # covers one sample; 16 x 16 images of 1 k step: 4 samples
    assert tops.conv_threshold_plan(32, 4, 4, 1, 11, 4, 4, 4, 255,
                                    samples=1024)["samples_per_block"] == 8
    assert tops.conv_threshold_plan(32, 4, 4, 1, 11, 8, 8, 8, 255,
                                    samples=1024)["samples_per_block"] == 8
    assert tops.conv_threshold_plan(3, 32, 1, 1, 16, 16, 16, 16, 255,
                                    samples=1024)["samples_per_block"] == 4
    # a band too large for 8 samples: halved until it fits
    p = tops.conv_threshold_plan(1024, 64, 3, 1, 12, 1, 10, 1, 1,
                                 samples=1024)
    assert 1 <= p["samples_per_block"] < 8
    assert p["smem_bytes"] <= tops.STAGE_SMEM_BYTES
    assert tops.conv_threshold_plan(32, 4, 4, 1, 11, 4, 4, 4, 255,
                                    samples=3)["samples_per_block"] == 3
    assert tops.conv_threshold_plan(32, 4, 4, 1, 11, 4, 4, 2, 255,
                                    samples=1024)["samples_per_block"] == 1


def test_conv_threshold_plan_streams_what_does_not_fit():
    # a deep bank: counted in chunks, whatever its order
    p = tops.conv_threshold_plan(16, 24, 3, 1, 10, 8, 8, 8, 6000)
    assert not p["search"] and p["smem_bytes"] <= tops.STAGE_SMEM_BYTES
    assert tops.conv_threshold_plan(16, 24, 3, 1, 10, 8, 8, 8,
                                     1000)["search"]
    assert not tops.conv_threshold_plan(16, 24, 3, 1, 10, 8, 8, 8,
                                         1024)["search"]
    # weights too many for one chunk: streamed kc rows at a time
    p = tops.conv_threshold_plan(2048, 64, 3, 1, 5, 3, 3, 1, 1)
    assert p["k_chunk"] % 32 == 0 and p["k_chunk"] < 9 * 2048
    assert p["smem_bytes"] <= tops.STAGE_SMEM_BYTES
    # a band too tall: block_h halves until it fits
    p = tops.conv_threshold_plan(256, 32, 3, 1, 130, 128, 128, 64, 255)
    assert 1 <= p["block_h"] < 64
    assert p["smem_bytes"] <= tops.STAGE_SMEM_BYTES
    with pytest.raises(ValueError, match="does not fit"):
        tops.conv_threshold_plan(4096, 32, 3, 1, 64, 62, 62, 1, 1)


def _flavour(codes):
    """``flavour_of`` over the codes' range bits
    (``csrc/threshold_epilogue.cuh``): s8, u8, or the byte split."""
    neg, big = bool((codes < 0).any()), bool((codes > 127).any())
    if ((codes < -128) | (codes > 255)).any() or (neg and big):
        return "wide"
    return "s8" if neg else "u8"


def _replay_conv(x_pad, w2d, kernel, stride, out_h, out_w, block_h):
    """K2's accumulators as the kernel forms them, in numpy: per block of
    samples and rows the band's bytes at the plan's pixel stride (channels
    padded to 4 with zeros), the block's vote, A read at pixel base +
    (kh * WP + kw) * ps + c over the padded depth, the weights of padding
    channels and past the depth 0, one byte plane at a time added shifted
    (modulo 2^32)."""
    nb, _, wp, c = x_pad.shape
    f = w2d.shape[1]
    plan = tops.conv_threshold_plan(c, f, kernel, stride, wp, out_h, out_w,
                                    block_h, 1, samples=nb)
    ps, bh = plan["pixel_stride"], plan["block_h"]
    g = plan["samples_per_block"]
    cp = -(-c // 4) * 4                       # channels padded to 4
    ktot = kernel * kernel * cp
    kpad = -(-ktot // 32) * 32
    kk = np.arange(kpad)
    tap, ch = kk // cp, kk % cp
    off = np.where(kk < ktot,
                   ((tap // kernel) * wp + tap % kernel) * ps + ch, 0)
    wk = np.zeros((kpad, f), np.int64)
    real = (kk < ktot) & (ch < c)
    wk[real] = w2d[tap[real] * c + ch[real]]
    acc = np.zeros((nb, out_h, out_w, f), np.int64)
    for n0 in range(0, nb, g):
        ng = min(g, nb - n0)
        for oh0 in range(0, out_h, bh):
            rows = min(bh, out_h - oh0)
            brows = (rows - 1) * stride + kernel
            band = x_pad[n0:n0 + ng, oh0 * stride:oh0 * stride + brows]
            band = band.astype(np.int64)
            fl = _flavour(band)
            p = np.arange(ng * rows * out_w)
            gi, pl = p // (rows * out_w), p % (rows * out_w)
            pbase = ((gi * brows + (pl // out_w) * stride) * wp
                     + (pl % out_w) * stride) * ps
            blk = np.zeros((ng * rows * out_w, f), np.int64)
            for plane in range(4 if fl == "wide" else 1):
                byte = (band >> (8 * plane)) & 0xFF
                if fl == "s8" or plane == 3:
                    byte = np.where(byte > 127, byte - 256, byte)
                flat = np.zeros((ng * brows * wp, ps), np.int64)
                flat[:, :c] = byte.reshape(ng * brows * wp, c)
                a = flat.reshape(-1)[pbase[:, None] + off[None, :]]
                blk += (a @ wk) << (8 * plane)
            acc[n0:n0 + ng, oh0:oh0 + rows] = blk.reshape(ng, rows, out_w, f)
    acc = (acc + 2 ** 31) % 2 ** 32 - 2 ** 31
    return acc.astype(np.int32)


@pytest.mark.parametrize("c,k,stride,padding,lo,hi", [
    (3, 3, 1, "VALID", -127, 128), (3, 1, 1, "SAME", -127, 128),
    (32, 4, 1, "SAME", 0, 256), (4, 4, 4, "SAME", 0, 256),
    (8, 3, 1, "VALID", 0, 2), (5, 3, 2, "SAME", -70000, 70001),
    (64, 3, 1, "SAME", -300, 300)])
def test_conv_kernel_addressing_replay_equals_the_accumulator(
        c, k, stride, padding, lo, hi):
    """The implicit GEMM's address arithmetic and byte split, replayed,
    give the exact tap sums (the same formulas as csrc/conv_threshold.cu)."""
    rng = np.random.default_rng(c * 10 + k + stride)
    h, w, f = 11, 9, 6
    x = torch.from_numpy(rng.integers(lo, hi, (2, h, w, c)).astype(np.int32))
    w2d = torch.from_numpy(rng.integers(-127, 128, (k * k * c, f)).astype(
        np.int8))
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    xp = tct.pad_input(x, kernel=k, stride=stride, padding=padding,
                       out_h=oh, out_w=ow)
    want = tct.direct_conv_acc(xp, w2d, kernel=k, stride=stride, out_h=oh,
                               out_w=ow).numpy()
    for bh in (1, 4, oh):
        got = _replay_conv(xp.numpy(), w2d.numpy(), k, stride, oh, ow, bh)
        np.testing.assert_array_equal(got, want)
    # small images: several samples a block
    xs = xp[:, :k + 2 * stride, :k + 2 * stride]
    want = tct.direct_conv_acc(xs, w2d, kernel=k, stride=stride, out_h=3,
                               out_w=3).numpy()
    got = _replay_conv(np.concatenate([xs.numpy()] * 5), w2d.numpy(), k,
                       stride, 3, 3, 3)
    np.testing.assert_array_equal(got, np.concatenate([want] * 5))


def test_the_code_range_vote_picks_an_exact_flavour():
    assert _flavour(np.array([-127, 0, 127])) == "s8"
    assert _flavour(np.array([-128, 5])) == "s8"
    assert _flavour(np.array([0, 255])) == "u8"
    assert _flavour(np.array([0, 1])) == "u8"
    assert _flavour(np.array([-1, 128])) == "wide"
    assert _flavour(np.array([256])) == "wide"
    assert _flavour(np.array([-129])) == "wide"
