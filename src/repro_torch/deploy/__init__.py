"""repro_torch.deploy — QIR graph -> stage schedule -> executor, on torch.

    from repro_torch.core.qir import Graph
    from repro_torch.deploy import compile_graph
    cm = compile_graph(Graph.load("kws.qir.json"))   # on the CUDA card
    logits = cm.offline(x_int)            # planned runs: one megakernel each
    y, stats = cm.streaming_compiled(x_int, micro_batch=16)
    y_wave, mask = cm.submit_wave(x_int[:5], micro_batch=16)
"""

from repro_torch.deploy.executor import (  # noqa: F401
    DEFAULT_MICRO_BATCH,
    CompiledTinyModel,
    StreamingStats,
    compile_graph,
    stage_work,
)
from repro_torch.deploy.lower import (  # noqa: F401
    CONV_LOWERINGS,
    ConvGeom,
    FlattenStage,
    FloatHeadStage,
    FusedConvThresholdStage,
    FusedThresholdStage,
    IntPoolStage,
    MEGAKERNEL_MIN_STAGES,
    MegakernelSegment,
    RefChainStage,
    Segment,
    StageSchedule,
    default_conv_lowering,
    group_segments,
    im2col,
    lower_graph,
    plan_megakernel,
)
