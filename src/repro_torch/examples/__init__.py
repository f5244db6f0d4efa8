"""repro_torch.examples — the paper's workflow end to end on the card:
``quickstart`` (one page: QAT, streamlining, the integer stages on K1)
and ``mlperf_tiny_codesign`` (search, bit-width descent, export, the
compiled deployment and its scenarios). Run each with
``python -m repro_torch.examples.<name>``."""
