"""repro_torch.deploy — QIR graph -> stage schedule -> executor, on torch.

    from repro_torch.core.qir import Graph
    from repro_torch.deploy import compile_graph
    cm = compile_graph(Graph.load("kws.qir.json"))   # on the CUDA card
    logits = cm.offline(x_int)
"""

from repro_torch.deploy.executor import (  # noqa: F401
    CompiledTinyModel,
    compile_graph,
)
from repro_torch.deploy.lower import (  # noqa: F401
    CONV_LOWERINGS,
    ConvGeom,
    FlattenStage,
    FloatHeadStage,
    FusedConvThresholdStage,
    FusedThresholdStage,
    IntPoolStage,
    RefChainStage,
    StageSchedule,
    default_conv_lowering,
    im2col,
    lower_graph,
)
