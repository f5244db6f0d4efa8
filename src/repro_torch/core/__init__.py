"""repro_torch.core — QIR, the quantizers, the quantized layers,
streamlining, the codesign driver and the search, on torch (ports of
``repro.core.qir``, ``quantizers``, ``qlayers``, ``streamline``,
``codesign`` and ``search``)."""

from repro_torch.core.qir import (  # noqa: F401
    Graph,
    LayerBits,
    Node,
    QuantSpec,
    eval_node,
    export_qmlp,
)
