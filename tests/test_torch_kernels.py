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
    assert tops.launches == {"threshold_matmul": 0, "conv_threshold": 0,
                             "mlp_megakernel": 0, "flash_attention": 0}
