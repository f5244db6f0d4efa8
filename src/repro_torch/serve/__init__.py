"""repro_torch.serve — SLO-aware dynamic-batching inference server runtime.

The port of ``repro.serve``, the layer between request traffic and the
compiled streaming pipeline (``repro_torch.deploy``): a dynamic batcher
(``router``) coalesces arriving requests into padded micro-batch waves and
dispatches them through the executor's segment programs
(``CompiledTinyModel.submit_wave``, which launches K1, K2 and K3 on the
card), a replica pool (``replica``) places waves by least outstanding
work — on one card, one CUDA stream per replica —, an injectable dispatch
engine (``dispatch``) decides whether waves block in the submit path
(``SyncEngine``, the exact discrete-event default) or overlap across
replicas through an in-flight table (``AsyncEngine``: a CUDA event per
wave, completions reaped by the event loop), an admission controller
(``slo``) sheds load before the p99 budget blows, traffic generators
(``traffic``) produce seedable Poisson/bursty/diurnal/replay arrival
traces, and sliding-window metrics (``metrics``) report percentiles,
throughput, shed rate and wave occupancy. A seedable fault-injection
plane (``faults``) drives wave timeouts, replica crashes/slowdowns,
corrupt outputs and transient submit errors through a deterministic
schedule; the router answers with wave deadlines, bounded retries, a
replica health state machine and an output integrity guard. Everything
reads time through an injectable clock (``clock``), so under
``ManualClock`` the port's router gives the reference's latencies,
snapshot rows and trace bytes.

    from repro_torch.serve import Router, RouterConfig, poisson_trace
    router = Router({"ic": compiled}, RouterConfig(p99_budget_ms=50.0))
    done = router.run_trace("ic", poisson_trace(qps=200, n=512), make_query)
"""

from repro_torch.serve.clock import ManualClock, SystemClock  # noqa: F401
from repro_torch.serve.dispatch import (  # noqa: F401
    AsyncEngine,
    DispatchEngine,
    SyncEngine,
    WaveHandle,
)
from repro_torch.serve.faults import (  # noqa: F401
    DEFAULT_OUTPUT_BOUND,
    CorruptWave,
    FaultError,
    FaultPlan,
    FaultSpec,
    FaultyModel,
    NoReplicaAvailable,
    ReplicaCrashed,
    TransientSubmitError,
    WaveError,
    WaveTimeout,
    faulty_pool,
    wave_integrity_ok,
)
from repro_torch.serve.metrics import (  # noqa: F401
    MetricsSnapshot,
    ServeMetrics,
)
from repro_torch.serve.replica import Replica, ReplicaPool  # noqa: F401
from repro_torch.serve.router import (  # noqa: F401
    Router,
    RouterConfig,
    ServeRequest,
)
from repro_torch.serve.slo import (  # noqa: F401
    PredictedServiceModel,
    ServiceModel,
    SLOController,
    measure_wave_service_s,
    queued_waves,
    slo_operating_point,
)
from repro_torch.serve.traffic import (  # noqa: F401
    GENERATORS,
    Trace,
    diurnal_trace,
    mmpp_trace,
    poisson_trace,
    replay_trace,
)
