"""The frozen counts against hand counts at the published shapes."""

import pytest

from tinybench import counts, layout

# multiply-adds by hand, a row: output pixels x filters x taps x channels
IC_MACS = (32 * 32 * 32 * 1 * 3 + 32 * 32 * 4 * 16 * 32
           + 32 * 32 * 32 * 16 * 4 + 8 * 8 * 32 * 16 * 32
           + 8 * 8 * 4 * 16 * 32 + 256 * 10)
CNV_MACS = (30 * 30 * 64 * 27 + 28 * 28 * 64 * 576 + 12 * 12 * 128 * 576
            + 10 * 10 * 128 * 1152 + 3 * 3 * 256 * 1152 + 1 * 1 * 256 * 2304
            + 256 * 512 + 512 * 512 + 512 * 10)


def _graph(name, seed=0):
    cfg = layout.config(name)
    return layout.graph_family(cfg["family"]).make_graph(cfg, seed)


@pytest.mark.parametrize("name, macs, mop", [("ic_hls4ml", IC_MACS, 10.9),
                                             ("cnv_w1a1", CNV_MACS, 118.9)])
def test_ops_per_inference_equal_the_hand_count(name, macs, mop):
    ops = counts.ops_per_inference(_graph(name))
    assert ops == 2 * macs
    assert round(ops / 1e6, 1) == mop


def test_cnv_holds_its_published_weights():
    g = _graph("cnv_w1a1")
    convs = sum(c["weights"] for c in counts.conv_layers(g))
    dense = counts.dense_macs(g)       # one weight a multiply-add a row
    assert convs + dense == layout.config("cnv_w1a1")["weights"] == 1542848


def test_conv_bytes_and_bound_by_hand():
    g = _graph("cnv_w1a1")
    conv1 = counts.conv_layers(g)[1]
    # 30x30x64 codes in, 28x28x64 out, 3x3x64x64 weights, one threshold
    # a bipolar channel at 4 bytes
    assert conv1 == {"name": "conv1", "in_codes": 57600, "out_codes": 50176,
                     "weights": 36864, "macs": 28901376, "thresholds": 64}
    assert counts.conv_bytes(conv1, 2) == 2 * (57600 + 50176) + 36864 + 256
    ic0 = counts.conv_layers(_graph("ic_hls4ml"))[0]
    assert ic0["thresholds"] == 32 * 255           # 8-bit codes: 255 steps
    b = counts.conv_bytes(conv1, 1024)
    ops = 2 * 1024 * conv1["macs"]
    assert counts.bound_s(ops, b) == max(b / 3.35e12, ops / 1979e12)
    assert counts.conv_threshold_bound_s(g, 1024) == pytest.approx(sum(
        counts.bound_s(2 * 1024 * c["macs"], counts.conv_bytes(c, 1024))
        for c in counts.conv_layers(g)))


@pytest.mark.parametrize("name, ok", [
    ("void conv_threshold_kernel<true, 64>(int const*, signed char const*)",
     True),
    ("conv_threshold_kernel", True),
    ("conv_threshold_kernel_v2", False),
    ("void my_conv_threshold_kernel<1>()", False)])
def test_kernel_names_match_whole(name, ok):
    assert counts.kernel_is(name, counts.CONV_THRESHOLD_KERNEL) is ok
