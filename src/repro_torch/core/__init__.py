"""repro_torch.core — QIR, the deploy-side quantizers and streamlining, on
torch (ports of ``repro.core.qir``, ``quantizers`` and ``streamline``)."""

from repro_torch.core.qir import (  # noqa: F401
    Graph,
    LayerBits,
    Node,
    QuantSpec,
    eval_node,
    export_qmlp,
)
