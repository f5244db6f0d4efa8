"""The port's ``core.bops`` and ``core.codesign.deploy_report`` against the
JAX package's on the same schedules.

On the four golden graphs, under both conv lowerings, the per-stage costs
(BOPs, weight bits, FLOPs, parameters, traffic), the schedule's total, the
banded conv input bytes at every row block and the traffic of a stage with
a tuned row block equal the reference's exactly (the same float
arithmetic, so ``==``). ``deploy_report`` is the reference's arithmetic
with the card's constants in place of the TPU's.
"""

import dataclasses
import os

import pytest

from repro.core import bops as jbops
from repro.core import codesign as jcodesign
from repro.core.qir import Graph as JGraph
from repro.deploy import compile_graph as jcompile
from repro_torch.core import bops as tbops
from repro_torch.core import codesign as tcodesign
from repro_torch.core.qir import Graph as TGraph
from repro_torch.deploy import compile_graph as tcompile

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODELS = ("kws", "ad", "ic", "cnv")


def _pair(name, lowering):
    with open(os.path.join(GOLDEN_DIR, f"{name}.qir.json")) as f:
        s = f.read()
    jg, tg = JGraph.from_json(s), TGraph.from_json(s)
    scale = jg.meta.get("in_scale", 1.0 / 127.0)
    jm = jcompile(jg, in_scale=scale, use_pallas=False,
                  conv_lowering=lowering)
    tm = tcompile(tg, in_scale=scale, device="cpu", conv_lowering=lowering)
    return jm.schedule.stages, tm.schedule.stages


def _layer(c):
    return dataclasses.asdict(c)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("lowering", ("direct", "im2col"))
def test_stage_and_schedule_cost_equal_reference(name, lowering):
    js, ts = _pair(name, lowering)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert tbops.stage_traffic_bytes(b) == jbops.stage_traffic_bytes(a)
        assert _layer(tbops.stage_cost(b)) == _layer(jbops.stage_cost(a))
    jc, tc = jbops.schedule_cost(js), tbops.schedule_cost(ts)
    assert [_layer(c) for c in tc.layers] == [_layer(c) for c in jc.layers]
    for prop in ("bops", "wm_bits", "flops", "n_params", "traffic_bytes"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.table() == jc.table()
    assert tc.cost_vs(tc) == jc.cost_vs(jc) == 1.0


@pytest.mark.parametrize("name", ("ic", "cnv"))
def test_conv_band_bytes_and_tuned_traffic_equal_reference(name):
    js, ts = _pair(name, "direct")
    convs = [(a, b) for a, b in zip(js, ts) if hasattr(b, "geom")]
    assert convs
    for a, b in convs:
        g = b.geom
        for bh in range(1, g.out_h + 2):
            assert tbops.conv_input_band_bytes(g, bh) == \
                jbops.conv_input_band_bytes(a.geom, bh)
            a.block_h, b.block_h = bh, bh
            assert tbops.stage_traffic_bytes(b) == \
                jbops.stage_traffic_bytes(a)
    assert tbops.schedule_cost(ts).traffic_bytes == \
        jbops.schedule_cost(js).traffic_bytes


@pytest.mark.parametrize("args", [(64, 32, 3, 8, 8, 100), (12, 490, 1, 3, 3, 1),
                                  (1, 1, 5, 1, 1, 7)])
def test_eq1_eq2_functions_equal_reference(args):
    m, n, k, b_a, b_w, hw = args
    assert tbops.conv_bops(m, n, k, b_a, b_w, hw) == \
        jbops.conv_bops(m, n, k, b_a, b_w, hw)
    assert tbops.dense_bops(m, n, b_a, b_w) == jbops.dense_bops(m, n, b_a, b_w)
    assert tbops.weight_memory_bits(m * n, b_w) == \
        jbops.weight_memory_bits(m * n, b_w)
    assert tbops.inference_cost(3.0, 5.0, 7.0, 11.0) == \
        jbops.inference_cost(3.0, 5.0, 7.0, 11.0)
    assert _layer(tbops.dense_cost("d", n, m, b_a, b_w)) == \
        _layer(jbops.dense_cost("d", n, m, b_a, b_w))
    assert _layer(tbops.conv_cost("c", n, m, k, hw, 2, b_a, b_w, False)) == \
        _layer(jbops.conv_cost("c", n, m, k, hw, 2, b_a, b_w, False))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("bits", (3, 8, 16))
def test_deploy_report_is_the_reference_arithmetic_on_the_card(
        name, bits, monkeypatch):
    """With the reference's TPU constants swapped for the card's, the
    reference's ``deploy_report`` gives the port's numbers; the card's
    constants are NVIDIA's H100 SXM figures."""
    js, ts = _pair(name, "direct")
    cost = tbops.schedule_cost(ts)
    for k in ("PEAK_INT8_OPS", "PEAK_BF16_FLOPS", "HBM_BW", "CHIP_WATTS"):
        monkeypatch.setattr(jcodesign, k, getattr(tcodesign, k))
    assert tcodesign.deploy_report(cost, batch=2, bits=bits) == \
        jcodesign.deploy_report(jbops.schedule_cost(js), batch=2, bits=bits)
    assert (tcodesign.PEAK_INT8_OPS, tcodesign.PEAK_BF16_FLOPS,
            tcodesign.HBM_BW, tcodesign.CHIP_WATTS) == \
        (1979e12, 989e12, 3.35e12, 700.0)
