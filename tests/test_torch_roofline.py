"""The port's roofline (``launch/roofline.py``) and the bench harness's
``roofline`` section against the reference's formulas.

The port keeps the reference's rows and formulas and swaps its TPU v5e
constants for the H100's (``core.codesign``: bf16 989e12 FLOP/s, int8
1979e12 OP/s, 3.35e12 B/s; NVLink 4 450e9 B/s per direction). So on the
same record each term equals the reference's term times the ratio of the
two constants (within ``RTOL``, float rounding of the ratio), the
useful-FLOPs ratio is identical, and the dominant term and the roofline
fraction follow. The dry run's records carry the rank-local step's
collective bytes, so the term is filled and "most collective-bound"
names a cell, in ``main`` and in the bench section; a record without
them (a strategy the port has no rank-local form of) prints ``n/a`` and
leaves that term out of ``dominant``.
"""

import json

import pytest

from repro.launch import roofline as jroof
from repro_torch.bench import run as bench_run
from repro_torch.core import codesign
from repro_torch.launch import roofline as troof

RTOL = 1e-12


def _fake_record(**kw):
    rec = {
        "arch": "llama3-8b", "shape": "train_4k", "mesh": "single",
        "tag": "baseline", "quant_bits": 16, "status": "ok",
        "n_devices": 256,
        "hlo_flops_per_device": 1e15,
        "collective_bytes_per_device": 5e10,
        "xla_cost_analysis": {"flops": 1e15, "bytes_accessed": 2e14},
        "memory_analysis": {"output_size_in_bytes": 1e12},
        "state_local_bytes": 1e9, "cache_local_bytes": 0,
    }
    rec.update(kw)
    return rec


def test_constants_are_the_cards():
    assert troof.PEAK_BF16 == codesign.PEAK_BF16_FLOPS == 989e12
    assert troof.PEAK_INT8 == codesign.PEAK_INT8_OPS == 1979e12
    assert troof.HBM_BW == codesign.HBM_BW == 3.35e12
    assert troof.NVLINK_BW == 450e9


@pytest.mark.parametrize("kw", [
    {}, {"quant_bits": 8},
    {"collective_bytes_per_device": 1e13},
    {"hlo_flops_per_device": 1e17, "collective_bytes_per_device": 0.0},
    {"shape": "prefill_32k", "arch": "jamba-v0.1-52b", "mesh": "multi",
     "n_devices": 512},
    {"shape": "decode_32k", "arch": "falcon-mamba-7b", "cache_local_bytes":
     3e10, "xla_cost_analysis": {"flops": 1e12, "bytes_accessed": 1e12}},
])
def test_terms_are_the_references_scaled_by_the_constants(kw):
    rec = _fake_record(**kw)
    want, got = jroof.analyze(rec), troof.analyze(rec)
    int8 = rec["quant_bits"] <= 8
    assert got.t_compute == pytest.approx(
        want.t_compute * ((jroof.PEAK_INT8 / troof.PEAK_INT8) if int8
                          else (jroof.PEAK_BF16 / troof.PEAK_BF16)),
        rel=RTOL)
    assert got.t_memory == pytest.approx(
        want.t_memory * jroof.HBM_BW / troof.HBM_BW, rel=RTOL)
    assert got.t_collective == pytest.approx(
        want.t_collective * jroof.ICI_BW / troof.NVLINK_BW, rel=RTOL)
    assert got.useful_ratio == want.useful_ratio
    assert got.model_flops == want.model_flops
    assert got.hlo_flops_per_dev == want.hlo_flops_per_dev
    terms = {"compute": got.t_compute, "memory": got.t_memory,
             "collective": got.t_collective}
    assert got.dominant == max(terms, key=terms.get)
    assert got.roofline_fraction == pytest.approx(
        got.model_flops / got.t_total_overlap
        / (rec["n_devices"] * troof.PEAK_BF16), rel=RTOL)


def test_quantized_cell_uses_the_int8_peak():
    r16 = troof.analyze(_fake_record())
    r8 = troof.analyze(_fake_record(quant_bits=8))
    assert r8.t_compute == pytest.approx(
        r16.t_compute * troof.PEAK_BF16 / troof.PEAK_INT8, rel=RTOL)


def test_dominant_term_selection():
    assert troof.analyze(_fake_record(
        collective_bytes_per_device=1e13)).dominant == "collective"
    assert troof.analyze(_fake_record(
        hlo_flops_per_device=1e17,
        collective_bytes_per_device=0.0)).dominant == "compute"


def test_a_record_without_collective_bytes_prints_na():
    row = troof.analyze(_fake_record(collective_bytes_per_device=None))
    assert row.t_collective is None
    assert row.dominant in ("compute", "memory")
    assert row.t_total_overlap == max(row.t_compute, row.t_memory)
    line = troof.render_table([row]).splitlines()[-1]
    assert "n/a" in line and row.dominant in line


def test_skipped_cells_pass_through():
    rec = {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "single",
           "tag": "baseline", "status": "skipped", "reason": "encoder-only"}
    row = troof.analyze(rec)
    assert row.status == "skipped"
    assert "skipped" in troof.render_table([row])
    assert troof.render_table([row]) == jroof.render_table(
        [jroof.analyze(rec)])


def _write_records(directory, recs):
    directory.mkdir(parents=True)
    for i, rec in enumerate(recs):
        with open(directory / f"{i}.json", "w") as f:
            json.dump(rec, f)


def test_main_and_the_bench_section(tmp_path, monkeypatch, capsys):
    recs = [_fake_record(collective_bytes_per_device=None),
            _fake_record(shape="decode_32k",
                         collective_bytes_per_device=None),
            {"arch": "hubert-xlarge", "shape": "decode_32k",
             "mesh": "single", "tag": "baseline", "status": "skipped",
             "reason": "encoder-only"}]
    _write_records(tmp_path / "artifacts" / "dryrun", recs)
    monkeypatch.chdir(tmp_path)
    troof.main(["--json-out", str(tmp_path / "rows.json")])
    out = capsys.readouterr().out
    assert "n/a" in out and "most collective-bound   : n/a" in out
    assert "worst roofline fraction : llama3-8b x decode_32k" in out
    with open(tmp_path / "rows.json") as f:
        assert len(json.load(f)) == 3
    assert bench_run.main(["--only", "roofline"]) == 0
    out = capsys.readouterr().out
    assert "paper-faithful baseline" in out and "1/1 sections ok" in out


def test_bench_section_without_artifacts(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert bench_run.main(["--only", "roofline"]) == 0
    assert "no artifacts/dryrun" in capsys.readouterr().out


def test_collective_bytes_name_the_most_collective_bound_cell(
        tmp_path, monkeypatch, capsys):
    """Records with the dry run's collective bytes: the term is bytes /
    NVLink's rate, the reference's term scaled by the constants' ratio,
    and ``main`` and the bench section name the cell whose collective term
    is the largest share of its bound."""
    heavy = _fake_record(shape="decode_32k", collective_bytes_per_device=1e13)
    light = _fake_record(collective_bytes_per_device=1e6)
    row = troof.analyze(heavy)
    assert row.t_collective == pytest.approx(1e13 / troof.NVLINK_BW,
                                             rel=RTOL)
    assert row.t_collective == pytest.approx(
        jroof.analyze(heavy).t_collective * jroof.ICI_BW / troof.NVLINK_BW,
        rel=RTOL)
    assert row.dominant == "collective"
    _write_records(tmp_path / "artifacts" / "dryrun", [light, heavy])
    monkeypatch.chdir(tmp_path)
    troof.main([])
    want = "most collective-bound   : llama3-8b x decode_32k"
    assert want in capsys.readouterr().out
    assert bench_run.main(["--only", "roofline"]) == 0
    assert want in capsys.readouterr().out
