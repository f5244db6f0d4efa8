"""repro_torch.obs — the injectable timer, the span/counter tracer, the
trace exporters and the span-derived reports.

Copies of ``repro.obs.timer``, ``tracer``, ``export`` and ``report``; the
executor and the autotuner read the timer and the tracer at module level.
The exporters write the reference's bytes for the same events: Chrome
trace-event JSON (open it in https://ui.perfetto.dev) and flat JSONL.

    from repro_torch.obs import Tracer, export_chrome
    tracer = Tracer()
    cm = compile_graph(graph, tracer=tracer)
    cm.offline(x)
    export_chrome(tracer, "offline_trace.json")
"""

from repro_torch.obs import timer  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    chrome_events,
    chrome_json,
    export_chrome,
    export_jsonl,
    jsonl_lines,
)
from repro_torch.obs.report import (  # noqa: F401
    export_prediction_records,
    latency_percentiles,
    prediction_error,
    prediction_records,
    request_latencies_ms,
    stage_medians_ms,
)
from repro_torch.obs.tracer import (  # noqa: F401
    COUNTER,
    INSTANT,
    NULL_TRACER,
    SPAN,
    NullTracer,
    TraceEvent,
    Tracer,
)
