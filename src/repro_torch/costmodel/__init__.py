"""repro_torch.costmodel — the learned wave-cost predictor.

The port of ``repro.costmodel``: a deterministic feature extractor over
the static compiled structure (``features``, on the port's planners), a
reproducible training table harvested from traces and autotune audit
trails (``dataset``), and a small seedable pure-numpy predictor with
save/load artifacts (``model``; the shipped artifact is the reference's,
fitted to a synthetic bootstrap fleet, not to a chip's times). Its
consumer here is ``REPRO_AUTOTUNE=model`` (probe-free autotuning,
``deploy.autotune``) and the serving stack's cold-start admission
pricing (``repro_torch.serve.slo.PredictedServiceModel``).
"""

from repro_torch.costmodel.features import (
    FEATURE_NAMES,
    FEATURE_SCHEMA_VERSION,
    feature_vector,
    features_from_costs,
    features_from_model_cost,
    wave_features,
)
from repro_torch.costmodel.dataset import (
    DATASET_SCHEMA_VERSION,
    Dataset,
    build_dataset,
    compiled_feature_resolver,
    load_trace_records,
    rows_from_bench_doc,
    rows_from_trace_records,
    rows_from_tuned_config,
)
from repro_torch.costmodel.model import (
    WaveCostPredictor,
    bootstrap_rows,
    default_artifact_path,
    leave_one_model_out,
    load_default,
    make_default_artifact,
)

__all__ = [
    "FEATURE_NAMES",
    "FEATURE_SCHEMA_VERSION",
    "feature_vector",
    "features_from_costs",
    "features_from_model_cost",
    "wave_features",
    "DATASET_SCHEMA_VERSION",
    "Dataset",
    "build_dataset",
    "compiled_feature_resolver",
    "load_trace_records",
    "rows_from_bench_doc",
    "rows_from_trace_records",
    "rows_from_tuned_config",
    "WaveCostPredictor",
    "bootstrap_rows",
    "default_artifact_path",
    "leave_one_model_out",
    "load_default",
    "make_default_artifact",
]
