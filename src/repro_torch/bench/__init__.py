"""repro_torch.bench — the port's benchmarks on the card.

``kernel_bench`` is the counterpart of ``benchmarks/kernel_bench.py``
(``python -m repro_torch.bench.kernel_bench``); ``common`` holds the row,
banner and artifact helpers and the CUDA-graph timer; ``models`` builds
the full-width KWS and AD graphs that ``chip_smoke.py`` and the bench
share.
"""
