"""The port's megakernel pieces on the CPU against the JAX package.

  * K3's plain version (``repro_torch.kernels.ops.mlp_megakernel`` on CPU
    tensors) against the reference's Pallas kernel in interpret mode and
    its jnp oracle, on the same numpy chains;
  * the byte accounting of ``core.bops`` against the reference's, at the
    same row block;
  * ``group_segments`` and the planner's (start, stop) against the
    reference's, on the four goldens, on full-width KWS and AD, and on the
    planner cases of ``tests/test_megakernel.py``; then the places where
    the port's Hopper budgets and stage limit rightly decide otherwise.

Everything compared is integers or byte counts, so every comparison is
exact. Interpret-mode shapes stay small.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bops as jbops
from repro.core.qir import Graph as JGraph
from repro.core.streamline import ThresholdDense as JTD
from repro.deploy import lower as jlower
from repro.kernels import ops as jops
from repro_torch.core import bops as tbops
from repro_torch.core.qir import Graph as TGraph
from repro_torch.core.streamline import ThresholdDense as TTD
from repro_torch.deploy import lower as tlower
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _chain(rng, in_dim, out_dims, steps, lo=0, hi=8):
    """numpy (x-range, weights, banks) for a chained stage run; banks are
    drawn from each stage's own accumulator so the counts spread."""
    weights, banks = [], []
    k = in_dim
    h = rng.integers(lo, hi, (64, in_dim)).astype(np.int64)
    for n, s in zip(out_dims, steps):
        w = rng.integers(-8, 9, (k, n)).astype(np.int8)
        acc = h @ w.astype(np.int64)
        b = np.sort(rng.choice(acc.reshape(-1), (n, s)), axis=1)
        weights.append(w)
        banks.append(b.astype(np.int32))
        h = (acc[:, :, None] >= b[None]).sum(-1)
        k = n
    return weights, banks


# the sweep of tests/test_megakernel.py, plus S = 255 in a chain and signed
# first-layer codes
KERNEL_CASES = [
    (16, 12, [24, 16], [7, 7], 0, 8),
    (12, 10, [18, 30, 6], [3, 15, 7], 0, 8),
    (8, 20, [16], [255], 0, 8),
    (33, 7, [9, 5, 11, 4], [7, 3, 3, 1], 0, 8),
    (21, 9, [12, 8], [255, 255], -127, 128),
    (5, 16, [8, 8, 4, 8, 8], [255, 1, 7, 255, 3], -127, 128),
]


@pytest.mark.parametrize("m,in_dim,out_dims,steps,lo,hi", KERNEL_CASES)
def test_mlp_megakernel_plain_equals_pallas_interpret_and_ref(
        m, in_dim, out_dims, steps, lo, hi):
    rng = np.random.default_rng(m * 100 + in_dim)
    weights, banks = _chain(rng, in_dim, out_dims, steps, lo, hi)
    x = rng.integers(lo, hi, (m, in_dim)).astype(np.int32)
    want = np.asarray(jops.mlp_megakernel(
        jnp.asarray(x), [jnp.asarray(w) for w in weights],
        [jnp.asarray(b) for b in banks], block_m=16, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jops.mlp_megakernel_ref(x, weights, banks)))
    tw = [torch.from_numpy(w) for w in weights]
    tb = [torch.from_numpy(b.T.copy()) for b in banks]    # step-major
    tops.reset_launches()
    got = tops.mlp_megakernel(torch.from_numpy(x), tw, tb)
    assert got.dtype == torch.int32 and got.shape == (m, out_dims[-1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert tops.launches["mlp_megakernel"] == 0   # plain versions count none


def test_mlp_megakernel_wrapper_checks_its_arguments():
    rng = np.random.default_rng(3)
    weights, banks = _chain(rng, 6, [5, 4], [3, 3])
    x = torch.zeros((4, 6), dtype=torch.int32)
    tw = [torch.from_numpy(w) for w in weights]
    tb = [torch.from_numpy(b.T.copy()) for b in banks]
    with pytest.raises(TypeError):
        tops.mlp_megakernel(x.to(torch.int64), tw, tb)
    with pytest.raises(ValueError, match="one of each"):
        tops.mlp_megakernel(x, tw, tb[:1])
    with pytest.raises(ValueError, match="does not follow"):
        tops.mlp_megakernel(x, tw[::-1], tb[::-1])
    with pytest.raises(ValueError, match="at most"):
        tops.mlp_megakernel(torch.zeros((2, 4), dtype=torch.int32),
                            [torch.zeros((4, 4), dtype=torch.int8)] * 9,
                            [torch.zeros((1, 4), dtype=torch.int32)] * 9)
    # chains whose code tiles do not fit one CTA's shared memory at the
    # smallest plan: a wide input, a wide intermediate width
    wide = tbops.MEGAKERNEL_SMEM_BYTES // (4 * tbops.MEGAKERNEL_BLOCK_M) + 1
    with pytest.raises(ValueError, match="shared memory"):
        tops.mlp_megakernel(torch.zeros((2, wide), dtype=torch.int32),
                            [torch.zeros((wide, 4), dtype=torch.int8)],
                            [torch.zeros((1, 4), dtype=torch.int32)])
    with pytest.raises(ValueError, match="shared memory"):
        tops.mlp_megakernel(torch.zeros((2, 8), dtype=torch.int32),
                            [torch.zeros((8, wide), dtype=torch.int8),
                             torch.zeros((wide, 8), dtype=torch.int8)],
                            [torch.zeros((1, wide), dtype=torch.int32),
                             torch.zeros((1, 8), dtype=torch.int32)])


def test_kernel_constants_match_the_cuda_source():
    """The constants the host plans with are the kernel's: threads, stage
    and cluster limits, the largest row tile, the streamed chunk, the
    residency flags and the shared memory of a CTA."""
    src = (_build.CSRC / "mlp_megakernel.cu").read_text()
    hdr = (_build.CSRC / "threshold_epilogue.cuh").read_text()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    assert const("NT") == tops.MEGAKERNEL_THREADS
    assert const("MAX_STAGES") == tbops.MEGAKERNEL_MAX_STAGES
    assert const("MAX_CLUSTER") == tops.MEGAKERNEL_MAX_CLUSTER
    assert const("MAX_BLOCK_M") == max(tops.MEGAKERNEL_ROW_TILES)
    assert min(tops.MEGAKERNEL_ROW_TILES) == tbops.MEGAKERNEL_BLOCK_M
    assert const("CHUNK_K") == tops.MEGAKERNEL_CHUNK_K
    assert const("WEIGHTS_RESIDENT") == tops._MK_WEIGHTS_RESIDENT
    assert const("BANKS_RESIDENT") == tops._MK_BANKS_RESIDENT
    assert const("SMEM_MAX", hdr) == tbops.MEGAKERNEL_SMEM_BYTES
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "mlp_megakernel" in _build.ENTRY_POINTS
    assert len(tops.MEGAKERNEL_ACTIVE_CLUSTERS) == tops.MEGAKERNEL_MAX_CLUSTER


# ---------------------------------------------------------------------------
# the host plan: cluster size, row tile, per-CTA layout
# ---------------------------------------------------------------------------

KWS = ((490, 256, 256, 256), (7, 7, 7))
AD = ((128, 72, 72, 8, 72, 72), (255,) * 5)
CNV_FC = ((256, 512, 512), (1, 1))
CNV_FC_GOLDEN = ((32, 32, 32), (1, 1))
WIDE_RUN = ((256, 1536, 1536, 256), (1, 1, 1))


def test_layout_of_a_cta_adds_up_by_hand():
    """Full-width KWS at the admission tile, 8 rows on 8 CTAs, all
    resident: code tiles 8 x (496 + 272) words, accumulators 8 x 40,
    weights 128 + 64 + 64 k words of 40 words, banks 3 x 7 x 32, a falls
    word per stage and the vote, each part rounded to 4 words."""
    lay = tops.megakernel_layout(*KWS, 8, 8, 3)
    assert lay["codes"] == 4 * 8 * (496 + 272)
    assert lay["acc"] == 4 * 8 * 40
    assert lay["weights"] == 4 * (128 + 64 + 64) * 40
    assert lay["banks"] == 4 * 3 * 7 * 32
    assert lay["flags"] == 4 * (3 * 4 + 4)
    assert lay["smem_bytes"] == 69_568 == sum(
        v for k, v in lay.items() if k != "smem_bytes")


@pytest.mark.parametrize("chain,m,want", [
    (KWS, None, (8, 8, True, True)), (KWS, 1, (8, 8, True, True)),
    (KWS, 1024, (2, 16, True, True)), (KWS, 4096, (1, 32, False, True)),
    (AD, None, (8, 8, True, True)), (AD, 1, (5, 8, True, True)),
    (AD, 1024, (3, 32, True, True)), (AD, 4096, (3, 64, True, True)),
    (CNV_FC, 1, (8, 8, True, True)), (CNV_FC, 1024, (2, 16, False, True)),
    (CNV_FC_GOLDEN, 1024, (2, 16, True, True)),
    (WIDE_RUN, None, (8, 8, False, True)),
    (WIDE_RUN, 1024, (2, 8, False, True))])
def test_plan_picks_cluster_row_tile_and_residency(chain, m, want):
    """The plan of the four models' runs and the planner tests' widest run
    (the choices ``bench/megakernel_sweep.py`` measured fastest, or within
    3.2% of it): a batch-1 query spreads over a large cluster; a 1024-row
    wave takes clusters of 2 or 3, whose grid the card runs in one wave;
    the widest run streams its weights; every plan fits one CTA."""
    plan = tops.megakernel_plan(*chain, m)
    assert plan["fits"]
    got = (plan["cluster"], plan["block_m"], plan["weights_resident"],
           plan["banks_resident"])
    assert got == want
    assert plan["smem_bytes"] == tops.megakernel_layout(
        *chain, plan["cluster"], plan["block_m"], plan["flags"])["smem_bytes"]
    assert plan["smem_bytes"] <= tbops.MEGAKERNEL_SMEM_BYTES


@pytest.mark.parametrize("cluster", range(1, 9))
@pytest.mark.parametrize("n", [1, 8, 9, 12, 72, 250, 512])
def test_cluster_split_covers_every_channel_once(cluster, n):
    """CTA j of a cluster owns n8 tiles [j T / C, (j + 1) T / C): together
    the CTAs cover every channel tile once, none holds more than the plan's
    slot count."""
    t = -(-n // 8)
    owned = []
    for j in range(cluster):
        lo, hi = j * t // cluster, (j + 1) * t // cluster
        assert hi - lo <= tops._mk_tiles(n, cluster)
        owned += range(lo, hi)
    assert owned == list(range(t))


def test_plan_pins_and_refuses():
    """Pinned choices come back as asked when they fit; a chain whose input
    tile does not fit one CTA fits no plan."""
    plan = tops.megakernel_plan(*KWS, 1024, 4, 32)
    assert (plan["cluster"], plan["block_m"]) == (4, 32) and plan["fits"]
    assert not tops.megakernel_plan((7300, 8, 8), (1, 1))["fits"]
    assert not tops.megakernel_plan((8, 7300, 8), (1, 1), 1)["fits"]


def test_weights_pack_into_words_of_four_k_bytes():
    """Word (q, n) of the packing holds w[4q .. 4q + 3, n] little-endian,
    zeros past K; the wrapper's plain version gives the same codes for the
    packed and the int8 weights."""
    rng = np.random.default_rng(11)
    for k, n in ((1, 1), (5, 3), (490, 12), (8, 9)):
        w = torch.as_tensor(rng.integers(-128, 128, (k, n)), dtype=torch.int8)
        words = tops.megakernel_pack_weights(w)
        assert words.dtype == torch.int32 and words.shape == (-(-k // 4), n)
        b = words.numpy().view(np.uint8).reshape(-(-k // 4), n, 4)
        full = np.zeros((4 * (-(-k // 4)), n), np.int8)
        full[:k] = w.numpy()
        np.testing.assert_array_equal(
            b.transpose(0, 2, 1).reshape(-1, n).view(np.int8), full)
    weights, banks = _chain(rng, 20, [16, 12], [7, 255])
    x = torch.as_tensor(rng.integers(0, 8, (7, 20)), dtype=torch.int32)
    tw = [torch.from_numpy(w) for w in weights]
    tb = [torch.from_numpy(b.T.copy()) for b in banks]
    want = tops.mlp_megakernel(x, tw, tb)
    got = tops.mlp_megakernel(x, [tops.megakernel_pack_weights(w)
                                  for w in tw], tb)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="packed"):
        tops.mlp_megakernel(x, [torch.zeros((20, 16), dtype=torch.int32),
                                tw[1]], tb)


def test_mk_launch_arguments_carry_the_plan():
    """The C launcher's arguments: the widths, steps and row count of the
    chain and the plan's cluster, row tile, residency flags and shared
    memory, which the launcher checks against its own layout."""
    rng = np.random.default_rng(12)
    weights, banks = _chain(rng, 33, [24, 8], [7, 255])
    x = torch.as_tensor(rng.integers(0, 8, (5, 33)), dtype=torch.int32)
    tw = [tops.megakernel_pack_weights(torch.from_numpy(w))
          for w in weights]
    tb = [torch.from_numpy(b.T.copy()) for b in banks]
    dims, steps = tops._mk_chain(x, tw, tb)
    assert (dims, steps) == ((33, 24, 8), (7, 255))
    plan = tops.megakernel_plan(dims, steps, 5)
    out = torch.empty((5, 8), dtype=torch.int32)
    keep, args = tops._mk_args(x, out, tw, tb, plan, dims, steps)
    assert args[6:] == (2, 5, plan["cluster"], plan["block_m"],
                        plan["flags"], plan["smem_bytes"])
    assert list(keep[2]) == [33, 24, 8] and list(keep[3]) == [7, 255]


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

def _stage_pair(rng, name, in_dim, out_dim, steps=7):
    """The same numpy stage as a reference and as a port stage."""
    w = rng.integers(-8, 9, (in_dim, out_dim)).astype(np.int8)
    t = np.sort(rng.integers(-60, 60, (out_dim, steps)), axis=1) \
        .astype(np.int32)
    j = jlower.FusedThresholdStage(
        name=name, stage=JTD(w_int=jnp.asarray(w), thresholds=jnp.asarray(t),
                             out_scale=0.25, act_bits=3),
        in_dim=in_dim, out_dim=out_dim, in_scale=1.0)
    p = tlower.FusedThresholdStage(
        name=name, stage=TTD(w_int=torch.from_numpy(w),
                             thresholds=torch.from_numpy(t),
                             out_scale=0.25, act_bits=3),
        in_dim=in_dim, out_dim=out_dim, in_scale=1.0)
    return j, p


def _run_pair(dims, steps=7, seed=0):
    rng = np.random.default_rng(seed)
    pairs = [_stage_pair(rng, f"d{i}", a, b, steps)
             for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    return [j for j, _ in pairs], [p for _, p in pairs]


@pytest.mark.parametrize("dims", [[16, 32, 24, 8], [490, 32, 32],
                                  [64, 48, 48, 12], [8, 8]])
@pytest.mark.parametrize("block_m", [8, 16, 128])
def test_byte_accounting_equals_reference(dims, block_m):
    js, ts = _run_pair(dims)
    assert tbops.megakernel_residency_bytes(ts, block_m=block_m) == \
        jbops.megakernel_residency_bytes(js, block_m=block_m)
    for rows in (1, 16, 1024):
        assert tbops.megakernel_traffic_bytes(ts, rows) == \
            jbops.megakernel_traffic_bytes(js, rows)
        assert tbops.staged_traffic_bytes(ts, rows) == \
            jbops.staged_traffic_bytes(js, rows)


def test_smem_of_the_kernel_never_exceeds_the_planned_tiles():
    """The shared memory a launch asks for is its plan's, as laid out part
    by part, and never above a CTA's 232,448 B — at every row count the
    wrapper plans, on the main path's chains and the planner tests'."""
    for dims in ([490, 256, 256, 256], [128, 72, 72, 8, 72, 72],
                 [256, 512, 512], [20, 16], [7, 9, 5, 11, 4],
                 [256, 1536, 1536, 256], [490, 256, 256, 256, 12]):
        steps = tuple([255] * (len(dims) - 1))
        for m in (None, 1, 2, 16, 17, 64, 1000, 1024, 4096):
            plan = tops.megakernel_plan(tuple(dims), steps, m)
            assert plan["fits"]
            lay = tops.megakernel_layout(tuple(dims), steps,
                                         plan["cluster"], plan["block_m"],
                                         plan["flags"])
            assert plan["smem_bytes"] == lay["smem_bytes"] <= \
                tbops.MEGAKERNEL_SMEM_BYTES


# ---------------------------------------------------------------------------
# segments and the planner
# ---------------------------------------------------------------------------

def _plans(js, ts, **kw):
    jseg = jlower.group_segments(js)
    tseg = tlower.group_segments(ts)
    assert [(s.start, s.stop, s.compiled) for s in tseg] == \
        [(s.start, s.stop, s.compiled) for s in jseg]
    out = []
    for a, b in zip(jseg, tseg):
        pj = jlower.plan_megakernel(js, a, **kw)
        pt = tlower.plan_megakernel(ts, b, **kw)
        out.append((None if pj is None else (pj.start, pj.stop),
                    None if pt is None else (pt.start, pt.stop)))
    return out


def _full_width(name):
    """Full-width KWS / AD as ``chip_smoke.py`` builds them with
    ``export_qmlp`` from numpy-seeded parameters
    (``repro_torch.bench.models``), as both packages' graphs (the QIR JSON
    is the same bytes)."""
    from repro_torch.bench import models

    dims, bits = {"kws": (models.KWS_DIMS, models.KWS_BITS),
                  "ad": (models.AD_DIMS, models.AD_BITS)}[name]
    s = models.mlp_graph(dims, bits, 2022).to_json()
    return JGraph.from_json(s), TGraph.from_json(s)


def _graphs(name):
    if name.startswith("full-"):
        return _full_width(name[len("full-"):])
    with open(os.path.join(GOLDEN_DIR, f"{name}.qir.json")) as f:
        s = f.read()
    return JGraph.from_json(s), TGraph.from_json(s)


@pytest.mark.parametrize("name", ["kws", "ad", "ic", "cnv", "full-kws",
                                  "full-ad"])
def test_segments_and_plans_equal_reference_on_models(name):
    jg, tg = _graphs(name)
    scale = jg.meta.get("in_scale", 1.0 / 127.0)
    js = jlower.lower_graph(jg, in_scale=scale).stages
    ts = tlower.lower_graph(tg, in_scale=scale).stages
    plans = _plans(js, ts)
    for pj, pt in plans:
        assert pt == pj
    admitted = [p for p, _ in plans if p is not None]
    assert len(admitted) == (0 if name == "ic" else 1)
    for pj, pt in _plans(js, ts, budget_bytes=64):
        assert pj is None and pt is None


def test_plan_admits_fused_run_and_accounts_bytes():
    js, ts = _run_pair([16, 32, 24, 8])
    (pair,) = _plans(js, ts)
    assert pair == ((0, 3), (0, 3))
    plan = tlower.plan_megakernel(ts, tlower.Segment(0, 3, compiled=True))
    res = tbops.megakernel_residency_bytes(ts)
    assert plan.block_m == tbops.MEGAKERNEL_BLOCK_M
    assert (plan.weight_bytes, plan.bank_bytes, plan.tile_bytes) == \
        (res["weight_bytes"], res["bank_bytes"], res["tile_bytes"])
    assert plan.total_bytes == res["total_bytes"]
    assert plan.budget_bytes == tbops.MEGAKERNEL_L2_BYTES


@pytest.mark.parametrize("case", ["short", "budget", "uncompiled"])
def test_plan_rejects_like_reference(case):
    js, ts = _run_pair([16, 32, 8])
    if case == "short":
        js, ts = js[:1], ts[:1]
        seg, kw = (0, 1, True), {}
    elif case == "budget":
        seg, kw = (0, 2, True), {"budget_bytes": 64}
    else:
        seg, kw = (0, 2, False), {}
    assert jlower.plan_megakernel(js, jlower.Segment(*seg), **kw) is None
    assert tlower.plan_megakernel(ts, tlower.Segment(*seg), **kw) is None


@pytest.mark.parametrize("lengths,want", [((2, 3), (3, 6)), ((3, 2), (0, 3)),
                                          ((2, 2), (0, 2)), ((1, 1), None)])
def test_plan_picks_longest_run_earlier_on_ties(lengths, want):
    """A non-fusable stage splits the segment; the longer run wins, the
    earlier one on a tie."""
    js, ts = _run_pair([8] * (sum(lengths) + 1))
    brk = object()
    a = lengths[0]
    js = js[:a] + [brk] + js[a:]
    ts = ts[:a] + [brk] + ts[a:]
    n = len(ts)
    pj = jlower.plan_megakernel(js, jlower.Segment(0, n, compiled=True))
    pt = tlower.plan_megakernel(ts, tlower.Segment(0, n, compiled=True))
    if want is None:
        assert pj is None and pt is None
    else:
        assert (pj.start, pj.stop) == (pt.start, pt.stop) == want


def test_hopper_budgets_differ_from_the_vmem_cap_where_they_should():
    """The port admits on its own budgets: a run whose weights exceed the
    reference's 2 MiB VMEM cap but fit L2 and whose tiles fit shared memory
    is admitted; a run with small weights whose input tile does not fit
    one block's shared memory is not."""
    js, ts = _run_pair([256, 1536, 1536, 256], steps=1)
    seg = (0, 3, True)
    assert jlower.plan_megakernel(js, jlower.Segment(*seg)) is None
    plan = tlower.plan_megakernel(ts, tlower.Segment(*seg))
    assert plan is not None and plan.tile_bytes <= tbops.MEGAKERNEL_SMEM_BYTES
    assert plan.weight_bytes > jbops.MEGAKERNEL_VMEM_BYTES
    _, ts = _run_pair([7300, 8, 8], steps=1)
    res = tbops.megakernel_residency_bytes(ts)
    assert res["tile_bytes"] > tbops.MEGAKERNEL_SMEM_BYTES
    assert res["weight_bytes"] + res["bank_bytes"] < (1 << 16)
    assert tlower.plan_megakernel(ts, tlower.Segment(0, 2, True)) is None


def test_plan_rejects_a_run_longer_than_one_launch_takes():
    """The reference fuses any number of stages; one launch of the port's
    kernel takes at most ``MEGAKERNEL_MAX_STAGES``, so a longer run stays
    staged (and the wrapper refuses it)."""
    n = tbops.MEGAKERNEL_MAX_STAGES
    for length, admitted in ((n, True), (n + 1, False)):
        js, ts = _run_pair([8] * (length + 1))
        seg = (0, length, True)
        assert jlower.plan_megakernel(js, jlower.Segment(*seg)) is not None
        plan = tlower.plan_megakernel(ts, tlower.Segment(*seg))
        assert (plan is not None) == admitted


def _runs(stages):
    """Every maximal run of fused dense stages in a stage list."""
    out, i = [], 0
    while i < len(stages):
        if isinstance(stages[i], tlower.FusedThresholdStage):
            j = i
            while j < len(stages) and isinstance(stages[j],
                                                 tlower.FusedThresholdStage):
                j += 1
            out.append(stages[i:j])
            i = j
        else:
            i += 1
    return out


@pytest.mark.parametrize("name", ["kws", "ad", "ic", "cnv", "full-kws",
                                  "full-ad", "planner"])
def test_admission_is_the_row_tile_budget_it_replaces(name):
    """The per-CTA plan admits exactly the runs that the budget it replaces
    admitted — the reference's tiles at 8 rows within one block's shared
    memory, weights and banks within L2, at most 8 stages — on the six
    model graphs and the planner tests' runs, the 2 MiB one included."""
    if name == "planner":
        runs = [_run_pair(d, steps=s)[1] for d, s in (
            ([16, 32, 24, 8], 7), ([16, 32, 8], 7), ([8] * 9, 7),
            ([8] * 10, 7), ([256, 1536, 1536, 256], 1), ([7300, 8, 8], 1),
            ([490, 256, 256, 256, 12], 7))]
    else:
        jg, tg = _graphs(name)
        scale = jg.meta.get("in_scale", 1.0 / 127.0)
        runs = _runs(tlower.lower_graph(tg, in_scale=scale).stages)
    assert runs or name == "ic"          # IC has no dense stage
    for run in runs:
        res = tbops.megakernel_residency_bytes(run, block_m=8)
        before = (len(run) <= tbops.MEGAKERNEL_MAX_STAGES
                  and res["tile_bytes"] <= tbops.MEGAKERNEL_SMEM_BYTES
                  and res["weight_bytes"] + res["bank_bytes"]
                  <= tbops.MEGAKERNEL_L2_BYTES)
        cta = tbops.megakernel_cta_plan(run)
        now = (len(run) <= tbops.MEGAKERNEL_MAX_STAGES and cta["fits"]
               and res["weight_bytes"] + res["bank_bytes"]
               <= tbops.MEGAKERNEL_L2_BYTES)
        assert now == before, [s.out_dim for s in run]
        if len(run) >= tlower.MEGAKERNEL_MIN_STAGES:
            plan = tlower.plan_megakernel(run, tlower.Segment(0, len(run),
                                                              True))
            assert (plan is not None) == now
            if plan is not None:
                assert (plan.cluster, plan.block_m) == (8, 8)
                assert plan.cta_bytes == cta["smem_bytes"]

