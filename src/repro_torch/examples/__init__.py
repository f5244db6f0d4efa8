"""repro_torch.examples — the paper's workflow end to end on the card:
``quickstart`` (one page: QAT, streamlining, the integer stages on K1),
``mlperf_tiny_codesign`` (search, bit-width descent, export, the
compiled deployment and its scenarios), ``train_lm`` (LM training with
the data pipeline, the loop and checkpoints) and ``elastic_restart`` (a
straggler, the watchdog's restart and the resume). Run each with
``python -m repro_torch.examples.<name>``."""
