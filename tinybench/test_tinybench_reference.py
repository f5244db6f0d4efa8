"""The plain reference against hand-worked graphs, and the control's
lower precision."""

import numpy as np
import pytest
import torch

from tinybench import layout
from tinybench.qir import QirGraph
from tinybench.reference import conv2d, logit_gap, reference_logits


def _tiny(pool: bool = False) -> dict:
    """x (3x3x1 codes, step 0.5) -> 2x2 VALID conv + bias -> ReLU -> 2-bit
    quantizer of step 1 -> flatten -> dense 4 -> 2."""
    g = QirGraph(meta={"in_scale": 0.5})
    g.const("w", np.array([[1, -1], [2, 0]], np.float32).reshape(2, 2, 1, 1))
    g.const("b", [0.5])
    g.add("Conv2D", "conv", ["x", "w", "b"], ["c"],
          attrs={"kernel": 2, "stride": 1, "padding": "VALID",
                 "in_shape": [3, 3, 1], "out_shape": [2, 2, 1]})
    g.add("Relu", "relu", ["c"], ["r"])
    g.add("Quant", "q", ["r"], ["h"], attrs={"scale": 1.0},
          quant={"bits": 2})
    g.add("Flatten", "flat", ["h"], ["f"], attrs={"in_shape": [2, 2, 1]})
    g.const("wd", [[1, 0], [0, 1], [1, 1], [-1, 2]])
    g.const("bd", [0.25, -0.25])
    g.add("Dense", "head", ["f", "wd", "bd"], ["logits"])
    return g.to_dict()


CODES = np.array([[2, 0, -2], [4, 2, 0], [0, 6, 2]], np.int8).reshape(
    1, 3, 3, 1)


def test_a_hand_worked_graph():
    # conv: 5.5, 3.5 / 1.5, 7.5 -> codes floor(v + 0.5) clipped to 3:
    # 3, 3, 2, 3 -> logits 3 + 2 - 3 + 0.25 and 3 + 2 + 6 - 0.25
    logits, nonzero = reference_logits(_tiny(), CODES)
    assert logits.tolist() == [[2.25, 10.75]]
    assert nonzero == {"q": 1.0}


def test_the_int4_control_changes_the_hand_worked_graph():
    control, _ = reference_logits(_tiny(), CODES, precision="int4")
    # codes 2..6 round to 0 on a grid of 16: the conv sees only its bias
    # 0.5, every code is 1: 1 + 1 - 1 + 0.25 and 1 + 1 + 2 - 0.25
    assert control.tolist() == [[1.25, 3.75]]
    assert logit_gap(control, np.array([[2.25, 10.75]])) > 0.1


def test_bipolar_quantizers_and_max_pool():
    g = QirGraph(meta={"in_scale": 1.0})
    g.const("w", np.ones((1, 1, 1, 1), np.float32))
    g.add("Conv2D", "conv", ["x", "w"], ["c"],
          attrs={"kernel": 1, "stride": 1, "padding": "VALID"})
    g.add("Quant", "s", ["c"], ["q"], attrs={"bipolar": True},
          quant={"bits": 1})
    g.add("MaxPool", "pool", ["q"], ["p"],
          attrs={"window": 2, "stride": 2, "padding": "VALID"})
    g.add("Flatten", "flat", ["p"], ["logits"])
    x = np.array([[-1, -2], [-3, 0]], np.int8).reshape(1, 2, 2, 1)
    out, share = reference_logits(g.to_dict(), x)
    assert out.tolist() == [[1.0]]          # x >= 0 at one tap
    assert share == {"s": 0.25}
    out, _ = reference_logits(g.to_dict(), -1 - np.abs(x))
    assert out.tolist() == [[0.0]]


@pytest.mark.parametrize("k, stride", [(4, 1), (4, 4), (1, 1), (3, 2)])
def test_same_convolution_equals_a_loop(k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.integers(-3, 4, (2, 8, 8, 3)).astype(np.float64)
    w = rng.integers(-2, 3, (k, k, 3, 5)).astype(np.float64)
    got = conv2d(torch.as_tensor(x), torch.as_tensor(w), stride,
                 "SAME").numpy()
    oh = -(-8 // stride)
    total = max((oh - 1) * stride + k - 8, 0)
    xp = np.pad(x, ((0, 0), (total // 2, total - total // 2),
                    (total // 2, total - total // 2), (0, 0)))
    want = np.zeros((2, oh, oh, 5))
    for i in range(oh):
        for j in range(oh):
            patch = xp[:, i * stride:i * stride + k, j * stride:j * stride + k]
            want[:, i, j] = np.einsum("nhwc,hwcf->nf", patch, w)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["ic_hls4ml", "cnv_w1a1"])
def test_generated_graphs_keep_every_stage_busy(name):
    cfg = layout.config(name)
    g = layout.graph_family(cfg["family"]).make_graph(cfg, 2 ** 31 + 3)
    x = np.random.default_rng(0).integers(-127, 128, (4, 32, 32, 3),
                                          dtype=np.int8)
    logits, nonzero = reference_logits(g, x)
    assert logits.shape == (4, cfg["n_classes"])
    assert all(0.2 < v < 0.8 for v in nonzero.values()), nonzero
    for control in ("int4", "bf16_head"):
        c, _ = reference_logits(g, x, precision=control)
        assert c.shape == logits.shape


def test_the_gap_of_missing_or_broken_answers_is_infinite():
    ref = np.ones((2, 3))
    assert logit_gap(np.ones((1, 3)), ref) == float("inf")
    assert logit_gap(np.full((2, 3), np.nan), ref) == float("inf")
    assert logit_gap(ref, ref) == 0.0
