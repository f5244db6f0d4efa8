"""The trace's reduction and the per-layer readers on a hand-made trace."""

import types

import pytest

from tinybench import counts, layout, loadgen, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    ev = [_x("tinybench.window", "user_annotation", 1000.0, 10000.0),
          _x("tinybench.window", "gpu_user_annotation", 1000.0, 10000.0),
          _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 500, 400)]
    for t in (1000, 6000):          # two calls, 5 ms apart
        ev += [_x("tinybench.loadgen", "user_annotation", t, 100),
               _x("tinybench.call", "user_annotation", t + 100, 1900),
               _x("tinybench.copy_out", "user_annotation", t + 2000, 3000),
               _x("aten::copy_", "cpu_op", t + 150, 50),
               _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                  t + 500, 500),
               _x("void conv_threshold_kernel<true, 64>(int const*)",
                  "kernel", t + 1000, 2000),
               _x("void at::native::elementwise_kernel<128, 2>()", "kernel",
                  t + 3000, 500),
               _x("float_head_kernel", "kernel", t + 3500, 500),
               _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                  t + 4000, 100)]
    return ev


def _ctx(scenario="offline"):
    t = trace.summarize(_events())
    t.calls, t.rows = 2, 2048
    cfg = layout.config("cnv_w1a1")
    graph = layout.graph_family(cfg["family"]).make_graph(cfg, 0)
    rec = loadgen.Records(rows_per_call=1024, start_ns=0, first=[0, 1024],
                          sent_ns=[0, 10_000_000],
                          return_ns=[40_000, 10_050_000],
                          done_ns=[10_000_000, 20_000_000])
    return types.SimpleNamespace(
        scenario=scenario, rows_per_call=1024, graph=graph,
        ops_per_inference=counts.ops_per_inference(graph), window=rec,
        trace=t)


def test_the_window_and_its_busy_intervals():
    t = _ctx().trace
    assert t.window_s == pytest.approx(0.010)
    # the copy before the window is left out; each call keeps 3.6 ms busy
    assert t.busy_s == pytest.approx(0.0072)
    assert [n for _, _, n in t.spans] == ["loadgen", "call", "copy_out"] * 2
    # the idle 2.8 ms split over the host spans that overlap each gap:
    # [0, 0.5) loadgen 0.1 + call 0.4; [4.1, 5.5) copy_out 0.9 + loadgen
    # 0.1 + call 0.4; [9.1, 10) copy_out 0.9
    idle = t.idle_by_span()
    assert idle == pytest.approx({"loadgen": 0.0002, "call": 0.0008,
                                  "copy_out": 0.0018})
    bd = trace.breakdown(t)
    assert bd["device_ops"][0] == [
        "void conv_threshold_kernel<true, 64>(int const*)",
        pytest.approx(0.004)]
    assert bd["idle_gaps"][0] == ["copy_out", pytest.approx(0.0018)]


def test_the_readers_on_the_hand_made_trace():
    readers = layout.metric_readers()
    ctx = _ctx("offline")
    got = {n: r.read(ctx) for n, r in readers.items()}
    k2_bound = 2 * counts.conv_threshold_bound_s(ctx.graph, 1024)
    assert got["h2d_share.offline"] == pytest.approx(100 * 1000 / 7200)
    assert got["nontable_share.offline"] == pytest.approx(100 * 1000 / 7200)
    assert got["conv_threshold_roofline.offline"] == pytest.approx(
        100 * k2_bound / 0.004)
    assert got["device_idle.offline"] == pytest.approx(28.0)
    assert got["mfu.offline"] == pytest.approx(
        100 * 2048 * ctx.ops_per_inference / (0.02 * 1979e12))
    # the singlestream readers find nothing to read in an offline cell
    assert {n for n, v in got.items() if v is None} == {
        n for n in readers if n.endswith(".singlestream")}
    ss = _ctx("singlestream")
    assert readers["call_host_us.singlestream"].read(ss) == pytest.approx(45)
    assert readers["h2d_share.offline"].read(ss) is None


def test_a_roofline_reads_nothing_without_its_kernel():
    ctx = _ctx("offline")
    ctx.trace.ops = [o for o in ctx.trace.ops
                     if "conv_threshold" not in o.name]
    reader = layout.metric_readers()["conv_threshold_roofline.offline"]
    assert reader.read(ctx) is None


def test_one_window_annotation_is_required():
    with pytest.raises(ValueError):
        trace.summarize([e for e in _events()
                         if e["name"] != "tinybench.window"])
