"""repro_torch.obs — the injectable timer and the span/counter tracer.

Copies of ``repro.obs.timer`` and ``repro.obs.tracer``; the executor reads
both at module level. The exporters and reports come with a later slice.
"""

from repro_torch.obs import timer  # noqa: F401
from repro_torch.obs.tracer import (  # noqa: F401
    COUNTER,
    INSTANT,
    NULL_TRACER,
    SPAN,
    NullTracer,
    TraceEvent,
    Tracer,
)
