"""repro_torch.bench — the port's benchmarks on the card.

``kernel_bench`` is the counterpart of ``benchmarks/kernel_bench.py``
(``python -m repro_torch.bench.kernel_bench``); ``table1_models``,
``table4_ad_opts``, ``table5_latency_energy`` and ``fig2_bo_scan`` /
``fig3_asha_scan`` / ``fig4_quant_scan`` those of the paper's tables and
figures (QAT on the card for Tables 1 and 4 and Fig. 4); ``common`` holds
the row, banner and artifact helpers and the CUDA-graph timer; ``models``
builds the full-width KWS and AD graphs that ``chip_smoke.py`` and the
bench share.
"""
