"""repro_torch.bench — the port's benchmarks on the card.

``run`` is the harness (``python -m repro_torch.bench.run [--only ...]``),
the counterpart of ``benchmarks/run.py``: ``table1_models``,
``table2_fifo``, ``table3_fusion``, ``table4_ad_opts``,
``table5_latency_energy`` and ``table6_scenarios`` (the MLPerf Tiny
scenarios) for the paper's tables, ``fig2_bo_scan`` / ``fig3_asha_scan`` /
``fig4_quant_scan`` for its figures, ``kernel_bench``, ``serve_bench``,
``obs_bench`` and ``costmodel_bench`` for the kernels, the serving stack,
the tracer's overhead and the learned cost model.
``check_megakernel_residency`` checks the megakernel planner's byte
accounting; ``common`` holds the row, banner and artifact helpers and the
CUDA-graph timer; ``models`` builds the full-width Table-1 graphs that
``chip_smoke.py`` and the benches share.
"""
