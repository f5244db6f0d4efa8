"""The port's K5 (``qmatmul``) and K4 (``multi_threshold``) wrappers and
K1's tiles on the CPU against the JAX package.

On CPU tensors ``repro_torch.kernels.ops`` runs each kernel's plain
version; these tests hold it against the Pallas kernel in interpret mode
(``repro.kernels.ops``, ``interpret=True``) and the reference oracle, on
the same numpy inputs, at the reference's own test shapes
(``tests/test_kernels.py``, the deep banks of ``tests/test_megakernel.py``).

Tolerances: K4 and every int8 output exact. K5's float32 output equals
the oracle ``repro.kernels.ref.qmatmul_ref`` bit for bit (same op order,
no fused multiply-add); against Pallas interpret, which differs from that
oracle by up to 1.2e-5 relative where the bias cancels the product (seed
0, 128x256x128), it is held within the reference's own tolerances: rtol
and atol 1e-5 with a bias (``tests/test_kernels.py:36``), rtol 1e-6
without (``tests/test_kernels.py:62``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import multi_threshold_ref as jmt_ref
from repro.kernels.ref import qmatmul_ref as jqm_ref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401


def _qmm_inputs(rng, m, k, n, lo=1e-3, hi=1e-2):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = rng.uniform(lo, hi, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, s, b


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (100, 70, 50), (128, 128, 128),
                                   (33, 200, 17), (256, 64, 192),
                                   (128, 256, 128)])
@pytest.mark.parametrize("relu", [False, True])
def test_qmatmul_plain_matches_pallas_interpret_and_oracle(m, k, n, relu):
    rng = np.random.default_rng(m * 1000 + k + n + relu)
    x, w, s, b = _qmm_inputs(rng, m, k, n)
    got = tops.qmatmul(*_t(x, w, s, b), relu=relu).numpy()
    oracle = np.asarray(jqm_ref(*_j(x, w, s, b), relu=relu))
    pallas = np.asarray(jops.qmatmul(*_j(x, w, s, b), relu=relu, block_m=32,
                                     block_n=32, block_k=32, interpret=True))
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


#: K5's accumulator mode: ragged M, N and K, decode's M = 4, and
#: grok-1's d_ff, the deepest contraction of any int8 linear (K = 32768)
ACC_SHAPES = [(37, 70, 50), (4, 4096, 96), (129, 200, 17), (4, 32768, 8)]


@pytest.mark.parametrize("m,k,n", ACC_SHAPES)
def test_qmatmul_accumulator_mode_equals_the_reference_int32_dot(m, k, n):
    """``scale=None``: the int32 sums, equal bit for bit to the
    reference's ``jax.lax.dot_general(..., preferred_element_type=
    jnp.int32)`` (its int8 linear's dot, ``repro.models.layers``), codes
    at the extremes included; and the two K blocks of a row-parallel
    split sum to the whole contraction's sums."""
    import jax

    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    x[0, :] = -128
    w[:, 0] = -127
    got = tops.qmatmul(*_t(x, w), None)
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    h = k // 2
    blocks = [tops.qmatmul(*_t(np.ascontiguousarray(x[:, part]),
                               w[part]), None)
              for part in (slice(0, h), slice(h, k))]
    halves = blocks[0] + blocks[1]
    assert torch.equal(halves, got)


def test_qmatmul_accumulator_mode_takes_no_epilogue():
    x, w = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3,
                                                            dtype=torch.int8)
    for kw in ({"relu": True}, {"out_scale": 0.5}):
        with pytest.raises(ValueError, match="accumulator"):
            tops.qmatmul(x, w, None, **kw)
    with pytest.raises(ValueError, match="accumulator"):
        tops.qmatmul(x, w, None, torch.zeros(3))
    with pytest.raises(ValueError, match="chain"):
        tops.qmatmul(x, w[:4], None)
    meta = tops.qmatmul(x.to("meta"), w.to("meta"), None)
    assert (meta.device.type, meta.dtype, tuple(meta.shape)) == (
        "meta", torch.int32, (4, 3))


@pytest.mark.parametrize("out_scale", [0.125, 0.5, 0.03, 0.3])
@pytest.mark.parametrize("relu", [False, True])
def test_qmatmul_requant_int8_exact(out_scale, relu):
    rng = np.random.default_rng(int(out_scale * 1000) + relu)
    x, w, s, b = _qmm_inputs(rng, 64, 48, 40, 1e-3, 5e-3)
    got = tops.qmatmul(*_t(x, w, s, b), relu=relu, out_scale=out_scale)
    assert got.dtype == torch.int8
    pallas = jops.qmatmul(*_j(x, w, s, b), relu=relu, out_scale=out_scale,
                          block_m=32, block_n=32, block_k=16, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jqm_ref(*_j(x, w, s, b), relu=relu,
                                        out_scale=out_scale)))


def test_qmatmul_no_bias():
    rng = np.random.default_rng(3)
    x, w, _, _ = _qmm_inputs(rng, 32, 32, 32)
    s = np.full((32,), 0.01, np.float32)
    got = tops.qmatmul(*_t(x, w, s)).numpy()
    pallas = jops.qmatmul(*_j(x, w, s), None, block_m=16, block_n=16,
                          block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(jqm_ref(*_j(x, w, s))))


def test_qmatmul_requant_multiplies_by_the_float32_reciprocal():
    """The Pallas kernel requantises as y * float32(1 / out_scale), not as
    y / out_scale (the oracle's form): the plain version follows the
    kernel, so a product that sits on a rounding tie under one form and
    not the other is rounded as the kernel rounds it."""
    out_scale = 0.03
    inv = np.float32(1.0 / out_scale)
    # float32 values next to the half-code points, where the two forms
    # can round to different codes
    half = ((np.arange(-100, 100) + 0.5) * np.float32(out_scale)).astype(
        np.float32)
    ys = np.concatenate([np.nextafter(half, np.float32(np.inf)), half,
                         np.nextafter(half, np.float32(-np.inf))])
    diff = ys[np.round(ys * inv) != np.round(ys / np.float32(out_scale))]
    assert diff.size
    y = diff[:1]
    x = torch.ones((1, 1), dtype=torch.int8)
    w = torch.ones((1, 1), dtype=torch.int8)
    got = tops.qmatmul(x, w, torch.as_tensor(y), out_scale=out_scale)
    want = np.clip(np.round(y * inv), -128, 127).astype(np.int8)
    np.testing.assert_array_equal(got.numpy()[0], want)
    assert want[0] != np.round(y[0] / np.float32(out_scale))


def test_qmatmul_rounds_half_to_even_and_clips():
    y = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 1000.0, -1000.0], np.float32)
    x = torch.ones((1, 1), dtype=torch.int8)
    got = tops.qmatmul(x, torch.ones((1, y.size), dtype=torch.int8),
                       torch.as_tensor(y), out_scale=1.0)
    np.testing.assert_array_equal(got.numpy()[0],
                                  [0, 2, 2, 0, -2, 127, -128])


def test_qmatmul_wrapper_checks_its_arguments():
    x = torch.ones((4, 3), dtype=torch.int8)
    w = torch.ones((3, 5), dtype=torch.int8)
    s = torch.ones(5)
    with pytest.raises(TypeError, match="int8"):
        tops.qmatmul(x.to(torch.int32), w, s)
    with pytest.raises(ValueError, match="do not chain"):
        tops.qmatmul(x, w[:2], s)
    with pytest.raises(ValueError, match="bias shape"):
        tops.qmatmul(x, w, s, torch.ones(4))
    with pytest.raises(ValueError, match="out_scale"):
        tops.qmatmul(x, w, s, out_scale=0.0)
    with pytest.raises(ValueError, match="contiguous"):
        tops.qmatmul(x, w.t().contiguous().t(), s)


# ---------------------------------------------------------------------------
# K4 multi_threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,c,steps", [(16, 8, 3), (37, 20, 7), (64, 12, 15),
                                       (128, 72, 255), (5, 3, 1),
                                       (16, 12, 256), (24, 8, 300),
                                       (8, 40, 511)])
def test_multi_threshold_plain_matches_pallas_interpret(m, c, steps):
    """The whole-bank body (S < 256) and the slab body (S >= 256, banks
    padded to 64-step slabs) of the TPU kernel, both equal to the plain
    version, which needs no padding."""
    rng = np.random.default_rng(m + c + steps)
    acc = rng.integers(-5000, 5000, (m, c)).astype(np.int32)
    thr = np.sort(rng.integers(-4000, 4000, (c, steps)),
                  axis=1).astype(np.int32)
    got = tops.multi_threshold(torch.as_tensor(acc), torch.as_tensor(thr))
    pallas = jops.multi_threshold(jnp.asarray(acc), jnp.asarray(thr),
                                  block_m=16, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmt_ref(jnp.asarray(acc), jnp.asarray(thr))))
    assert got.min() >= 0 and got.max() <= steps


def test_multi_threshold_counts_unsorted_banks_and_extremes():
    """A linear count: unsorted banks, duplicate steps and INT32 extremes
    count as the reference's oracle counts them."""
    i32 = np.iinfo(np.int32)
    acc = np.array([[i32.min, 0, i32.max], [5, 5, -5]], np.int32)
    thr = np.array([[i32.max, i32.min, 0, 0], [5, 5, 6, -1],
                    [i32.max, 3, i32.min, 9]], np.int32)
    got = tops.multi_threshold(torch.as_tensor(acc), torch.as_tensor(thr))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmt_ref(jnp.asarray(acc), jnp.asarray(thr))))


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "ties", "mixed",
                                  "extreme"])
@pytest.mark.parametrize("m,c,steps", [(9, 5, 7), (17, 33, 64), (6, 4, 300)])
def test_multi_threshold_every_bank_kind_matches_pallas_interpret(kind, m, c,
                                                                  steps):
    """The bank kinds the card checks (``kernel_bench.mt_inputs``): the
    plain version equals the TPU kernel's oracle, sorted or not, with ties
    and INT32 extremes, and the TPU kernel in interpret mode everywhere
    but where that kernel pads: its slab body (S >= 256) pads banks with
    INT32_MAX steps, which an INT32_MAX accumulator reaches, so there it
    counts the padding too."""
    from repro_torch.bench.kernel_bench import mt_inputs

    acc, thr = mt_inputs(np.random.default_rng(m * c + steps), m, c, steps,
                         kind)
    got = tops.multi_threshold(torch.as_tensor(acc), torch.as_tensor(thr))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmt_ref(jnp.asarray(acc), jnp.asarray(thr))))
    pallas = np.asarray(jops.multi_threshold(
        jnp.asarray(acc), jnp.asarray(thr), block_m=8, interpret=True))
    padded = (acc == np.iinfo(np.int32).max) & (steps >= 256)
    np.testing.assert_array_equal(got.numpy()[~padded], pallas[~padded])
    np.testing.assert_array_equal(pallas[padded],
                                  -(-steps // 64) * 64)   # 64-step slabs


def _lifted_count(bank: np.ndarray, a: int):
    """K4's search on one non-decreasing bank, step for step as
    ``csrc/multi_threshold.cu`` runs it: binary lifting over powers of two
    from the highest one at or below S. Returns (count, compares)."""
    s = len(bank)
    top = 1 if s else 0
    while top and 2 * top <= s:
        top *= 2
    cnt, compares, step = 0, 0, top
    while step:
        nxt = cnt + step
        t = bank[min(nxt, s) - 1]
        compares += 1
        cnt = nxt if (nxt <= s and t <= a) else cnt
        step //= 2
    return cnt, compares


@pytest.mark.parametrize("kind", ["sorted", "ties", "extreme"])
@pytest.mark.parametrize("steps", [0, 1, 2, 63, 64, 65, 255, 256, 511])
def test_multi_threshold_search_counts_like_the_linear_count(kind, steps):
    """On non-decreasing banks the kernel's upper-bound search gives the
    linear count, ties and extremes included, in ceil(log2(S + 1))
    compares."""
    from repro_torch.bench.kernel_bench import mt_inputs

    acc, thr = mt_inputs(np.random.default_rng(steps + 3), 16, 3,
                         max(steps, 1), kind)
    thr = thr[:, :steps]
    want = tops.multi_threshold(torch.as_tensor(acc),
                                torch.as_tensor(np.ascontiguousarray(thr)))
    for ch in range(thr.shape[0]):
        for r in range(acc.shape[0]):
            cnt, compares = _lifted_count(thr[ch], int(acc[r, ch]))
            assert cnt == int(want[r, ch])
            assert compares == steps.bit_length()


@pytest.mark.parametrize("c,s", [(72, 255), (72, 511), (8, 3), (3, 1),
                                 (1, 7), (2, 1023), (32, 4096), (40, 1023),
                                 (3, 28928), (3, 30000), (100, 0)])
def test_multi_threshold_plan_stages_whole_banks_or_counts_linearly(c, s):
    """Channels per block: 4 below 1024 steps, 1 above, no wider than C
    needs, banks within the shared memory the source reserves, 0 (the
    chunked linear count) only when one channel's bank does not fit;
    every choice is one the source instantiates."""
    src = (_build.CSRC / "multi_threshold.cu").read_text()
    smem = int(re.search(r"SMEM_MAX = (\d+);", src).group(1))
    assert "SMEM_MAX - 1024" in src
    assert tops.MT_BANK_SMEM_BYTES == smem - 1024
    fits = lambda bc: s * (bc + 1) * 4 <= tops.MT_BANK_SMEM_BYTES  # noqa
    bc = tops.multi_threshold_plan(c, s)
    if bc == 0:
        assert not fits(1)
        return
    assert fits(bc) and bc <= (4 if s < 1024 else 1)
    assert bc == 1 or bc // 2 < c
    assert bc == (4 if s < 1024 else 1) or bc >= c or not fits(2 * bc)
    assert f"case {bc}: return (int)launch_search<{bc}>" in src


def test_multi_threshold_wrapper_checks_its_arguments():
    acc = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not match"):
        tops.multi_threshold(acc, torch.zeros((2, 7), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        tops.multi_threshold(acc.to(torch.int64),
                             torch.zeros((3, 7), dtype=torch.int32))


# ---------------------------------------------------------------------------
# K1's tiles
# ---------------------------------------------------------------------------

def test_threshold_matmul_takes_every_tile_and_refuses_others():
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.integers(0, 8, (9, 13)), dtype=torch.int32)
    w = torch.as_tensor(rng.integers(-7, 8, (13, 6)), dtype=torch.int8)
    t = torch.sort(torch.as_tensor(rng.integers(-50, 50, (6, 7)),
                                   dtype=torch.int32), dim=1).values
    want = tref.threshold_matmul_ref(x, w, t)
    for bm in tops.TMM_TILE_SIZES:
        for bn in tops.TMM_TILE_SIZES:
            got = tops.threshold_matmul(x, w, t, block_m=bm, block_n=bn)
            assert torch.equal(got, want)
    for bad in ((16, 64), (64, 256), (0, 64)):
        with pytest.raises(ValueError, match="tile"):
            tops.threshold_matmul(x, w, t, block_m=bad[0], block_n=bad[1])


def test_kernel_constants_match_the_cuda_sources():
    """The tile set the wrapper admits is the set the source instantiates;
    the default tile is one of them; K4 and K5 have their entry points."""
    src = (_build.CSRC / "threshold_matmul.cu").read_text()
    tiles = set(re.findall(r"TILE\((\d+), (\d+)\)", src))
    want = {(str(a), str(b)) for a in tops.TMM_TILE_SIZES
            for b in tops.TMM_TILE_SIZES}
    assert tiles == want
    assert tops.TMM_DEFAULT_TILE[0] in tops.TMM_TILE_SIZES
    assert tops.TMM_DEFAULT_TILE[1] in tops.TMM_TILE_SIZES
    for name in ("multi_threshold", "qmatmul"):
        assert os.path.isfile(_build.CSRC / f"{name}.cu")
        assert name in tops.launches


@pytest.mark.parametrize("shape,want", [
    ((1, 1, 1), (0, 32, 64, 1, False)),
    ((512, 512, 512), (0, 32, 64, 128, True)),
    ((4096, 4096, 4096), (1, 128, 128, 1024, True)),
    ((1024, 490, 256), (0, 32, 64, 128, False)),
    ((1408, 64, 1536), (1, 128, 128, 132, True)),
    ((1280, 64, 1536), (0, 32, 64, 960, True))])
def test_qmatmul_plan_fills_the_card(shape, want):
    """K5's tile: 32 x 64 (4 warps) unless the 128 x 128 grid alone has the
    card's 132 blocks; 512^3 gives 128 blocks, 4096^3 1024 large ones; x
    goes through cp.async when K is a multiple of 16."""
    plan = tops.qmatmul_plan(*shape)
    assert (plan["tile"], plan["block_m"], plan["block_n"], plan["blocks"],
            plan["cp_async"]) == want


def test_qmatmul_tiles_match_the_cuda_source():
    """The tiles the plan names are the ones the source builds, in order
    of ``tile``, each with 4 or 8 warps of 16-row multiples."""
    src = (_build.CSRC / "qmatmul.cu").read_text()
    built = re.findall(r"return launch<(\d+), (\d+), (\d+), (\d+), (\d+)>",
                       src)
    assert [(int(a), int(b)) for a, b, *_ in built] == list(tops.QMM_TILES)
    for bm, bn, bk, wm, wn in (tuple(map(int, t)) for t in built):
        assert bm % (16 * wm) == 0 and bn % (8 * wn) == 0 and bk % 32 == 0
        assert wm * wn in (4, 8)
    assert "mma_tiles<MI, NI, true>" in src


def test_conv_threshold_row_block_changes_no_code():
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.integers(0, 16, (2, 9, 7, 3)), dtype=torch.int32)
    w = torch.as_tensor(rng.integers(-7, 8, (27, 5)), dtype=torch.int8)
    t = torch.sort(torch.as_tensor(rng.integers(-300, 300, (5, 15)),
                                   dtype=torch.int32), dim=1).values
    kw = dict(kernel=3, stride=1, padding="SAME", out_h=9, out_w=7)
    want = tops.conv_threshold(x, w, t, **kw)
    for bh in (1, 2, 4, 9, 100):
        assert torch.equal(tops.conv_threshold(x, w, t, block_h=bh, **kw),
                           want)
    with pytest.raises(ValueError, match="block_h"):
        tops.conv_threshold(x, w, t, block_h=0, **kw)


def test_kernel_bench_checking_pass_on_the_cpu():
    """The bench's K4/K5 cases through the wrappers' plain versions: each
    equals its plain version and its library call (the unfused chain,
    ``torch.searchsorted``), with the shapes and the work counted as the
    bench reports them; the bench itself refuses to run without a card."""
    from repro_torch.bench import kernel_bench as kb

    cases = kb.kernel_cases("cpu")
    assert [c["kernel"] for c in cases] == ["qmatmul", "multi_threshold",
                                            "multi_threshold"]
    assert kb.check_cases(cases) == {"qmatmul": 0, "multi_threshold": 0}
    assert cases[0]["ops"] == 2 * 512 ** 3
    assert cases[1]["ops"] == 1024 * 72 * 8       # a search of 255 steps
    assert kb.bound_by("qmatmul", cases[0]["bytes"], cases[0]["ops"]) == \
        "bytes"
    assert kb.bound_by("multi_threshold", cases[1]["bytes"],
                       cases[1]["ops"]) == "bytes"
    if not torch.cuda.is_available():
        assert kb.main([]) == 2


def test_kernel_bench_k4_bound_counts_a_binary_search():
    """K4's bound: ceil(log2(S + 1)) compares per element of a sorted
    bank (the search K4 runs), S per element of any other; at the bench's
    banks the bytes bound it (0.198 and 0.220 us at 3.35 TB/s)."""
    import math

    from repro_torch.bench import kernel_bench as kb

    for c in kb.kernel_cases("cpu")[1:]:
        m, ch = (int(v) for v in re.findall(r"[MC]=(\d+)", c["shape"]))
        steps = int(re.search(r"S=(\d+)", c["shape"]).group(1))
        assert c["ops"] == m * ch * math.ceil(math.log2(steps + 1))
        assert kb.bound_by("multi_threshold", c["bytes"], c["ops"]) == \
            "bytes"
    ad, deep = kb.kernel_cases("cpu")[1:]
    assert kb.bound_ms("multi_threshold", ad["bytes"], ad["ops"]) == \
        pytest.approx(1.98e-4, rel=1e-2)
    assert kb.bound_ms("multi_threshold", deep["bytes"], deep["ops"]) == \
        pytest.approx(2.20e-4, rel=1e-2)
    rng = np.random.default_rng(0)
    _, unsorted = kb.mt_inputs(rng, 4, 6, 100, "unsorted")
    _, mixed = kb.mt_inputs(rng, 4, 6, 100, "mixed")
    assert kb.mt_compares(10, torch.as_tensor(unsorted)) == 10 * 6 * 100
    assert kb.mt_compares(10, torch.as_tensor(mixed)) == \
        10 * (3 * 7 + 3 * 100)
    assert kb.mt_compares(10, torch.zeros((6, 0), dtype=torch.int32)) == 0
