"""The port's copy of the dataflow model against the JAX package's.

``repro_torch.core.dataflow`` is a copy of ``repro.core.dataflow`` (the
port imports nothing of the JAX package); on the same stages and token
counts both give the same cycles, occupancies, depths and stages — exact
equality, the model is integer arithmetic.
"""

import dataclasses

import pytest

from repro.core import dataflow as jdf
from repro_torch.core import dataflow as tdf

# (ii, latency, elems_in, elems_out) per stage
PIPELINES = [
    [(1, 1, 1, 1)],
    [(1, 3, 1, 1), (4, 4, 1, 1), (2, 9, 1, 1)],
    [(2, 5, 4, 2), (1, 2, 2, 1), (3, 3, 1, 3)],
    [(12, 12, 1, 1), (40, 40, 1, 1), (9, 9, 1, 1), (40, 40, 1, 1)],
    [(1, 1, 8, 8), (7, 20, 8, 1), (1, 4, 1, 1)],
]


def _stages(mod, spec):
    return [mod.Stage(name=f"s{i}", ii=a, latency=b, elems_in=c, elems_out=d)
            for i, (a, b, c, d) in enumerate(spec)]


@pytest.mark.parametrize("spec", PIPELINES)
@pytest.mark.parametrize("n_tokens", [1, 7, 64])
def test_simulate_pipeline_equals_reference(spec, n_tokens):
    depths = [16] * (len(spec) + 1)
    want = jdf.simulate_pipeline(_stages(jdf, spec), n_tokens, depths)
    got = tdf.simulate_pipeline(_stages(tdf, spec), n_tokens, depths)
    assert got == want


@pytest.mark.parametrize("spec", PIPELINES)
@pytest.mark.parametrize("n_tokens", [1, 16, 100])
def test_optimize_fifo_depths_equals_reference(spec, n_tokens):
    want = jdf.optimize_fifo_depths(_stages(jdf, spec), n_tokens)
    got = tdf.optimize_fifo_depths(_stages(tdf, spec), n_tokens)
    assert got == want
    assert got["throughput_preserved"]


@pytest.mark.parametrize("work", [1, 490 * 256, 8192, 8193, 10 ** 7])
@pytest.mark.parametrize("micro_batch", [0, 1, 16, 256])
def test_micro_batch_stage_equals_reference(work, micro_batch):
    want = jdf.micro_batch_stage("d", work, micro_batch)
    got = tdf.micro_batch_stage("d", work, micro_batch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (tdf.STAGE_ELEMS_PER_CYCLE, tdf.HOP_OVERHEAD_CYCLES) == \
        (jdf.STAGE_ELEMS_PER_CYCLE, jdf.HOP_OVERHEAD_CYCLES)


def test_pipeline_stage_helpers_equal_reference():
    dims = [490, 256, 256, 256, 12]
    for rf in (1, 4):
        assert [dataclasses.asdict(s) for s in
                tdf.mlp_pipeline_stages(dims, reuse_factor=rf)] == \
            [dataclasses.asdict(s) for s in
             jdf.mlp_pipeline_stages(dims, reuse_factor=rf)]
    shapes = [(3072, 7200, 4, 9), (7200, 6272, 2, 5)]
    assert [dataclasses.asdict(s) for s in tdf.conv_pipeline_stages(shapes)] \
        == [dataclasses.asdict(s) for s in jdf.conv_pipeline_stages(shapes)]
    for args in ((1.0, 1.0), (5.0, 1.0, 3.0), (1.0, 0.0)):
        assert tdf.prefetch_depth(*args) == jdf.prefetch_depth(*args)
