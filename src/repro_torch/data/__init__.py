"""repro_torch.data — the synthetic stand-in datasets (``synthetic``), a
numpy-only copy of ``repro.data.synthetic``, and the prefetching
``DataPipeline`` (``pipeline``)."""

from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImages,
    SyntheticMelWindows,
    SyntheticMFCC,
    SyntheticTokens,
)
