#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``)
and the repository around this file; it adds ``src/`` to ``sys.path``
itself and imports nothing of JAX or of the JAX package. Phases, each of
which fails the run with a non-zero exit:

  1. build   — compile every kernel of the path from ``csrc/`` (one nvcc
               per source, in parallel), time printed;
  2. kernels — ``cuobjdump --dump-sass`` of the built K1, K2, K3 and K5
               libraries must show IMMA (int8 ``mma.sync``); each kernel
               against its plain PyTorch version on the card, exact
               integer equality: K1/K2 at ragged shapes, S in {1, 7, 255},
               K = 5 / stride 2 / C = 1; K1/K2 on every bank kind
               (sorted, unsorted, ties, INT32_MIN/MAX steps, sorted and
               unsorted channels in one bank), banks of 1000 steps
               (searched) and 1024 and more (past shared memory: the
               chunked linear count), and codes
               of every mma flavour (s8, u8, binary, and wider than a
               byte: the byte split), K1 also with k tiles of different
               flavours in one block, under 3 tiles / row blocks each
               (``K1_BRANCH_CASES``, ``K2_BRANCH_CASES``); K3 on chains
               of 1 to 5 stages, ragged M, widths up to 512, S in {1, 7,
               255}, signed first-layer codes, and over
               ``K3_BRANCH_CASES`` (M of 1, 2, 15, 16, 17, 64, 1000;
               widths 1, 8, 10, 12, 500 in one chain; 8 stages; the
               256-1536-1536-256 run, whose weights stream; S of 1, 7,
               255, 256, 1000; sorted, unsorted, tied and mixed banks;
               s8, u8, binary and wide codes) under its default plan and
               pinned clusters and row tiles;
  3. main path — ``compile_graph(device="cuda")`` of the four Table-1
               models at the paper's full width, from numpy-seeded
               parameters (``repro_torch.bench.models``): the KWS MLP
               (490-256x3-12, 3-bit) and AD autoencoder
               (128-72-72-8-72-72-128, 8-bit) by ``export_qmlp``, the IC
               CNN (32x32x3, filters 32-4-32-32-4, 8-bit, scales
               calibrated on seeded codes) and CNV-W1A1
               (64-64-128-128-256-256, FC 512-512-10) by ``export_qcnn``,
               each in both dispatch modes (staged, ``megakernel=False``;
               auto, the default); launch counters set to 0, one
               ``offline`` call of each model in each mode on a 1024-row
               batch, counters read (``MAIN_PATH_LAUNCHES``: staged K1
               3 / 5 / 0 / 2 and K2 0 / 0 / 5 / 6 for KWS / AD / IC / CNV;
               auto K3 once for KWS, AD and CNV, K2 5 / 6 for IC / CNV);
               then ``predict``. Every schedule ends in a float head
               (``float_head``, one launch an ``offline``: a repair, its
               per-output sum in one fixed order, so a row's logits do
               not depend on the batch); its kernel is held within 1e-5
               of its plain version and equal to both modes' logits.
               Every fused stage's kernel, and every
               planned K3 run, is then held against its plain version on
               its real main-path input (all 1024 rows), every stage's
               codes must hold some nonzero code, and every model's
               outputs equal the port on the CPU (integers exact, logits
               within 1e-5; on ``CPU_CHECK_ROWS`` of the rows for IC and
               CNV);
  4. goldens — the four golden graphs on the card under both conv
               lowerings equal their ``.golden.npz`` stage outputs;
  5. streaming — ``streaming_host``, ``streaming_compiled`` and a partly
               filled ``submit_wave`` of each model in both modes equal
               ``offline``: the integer codes (the schedule without its
               float head) bit for bit, the logits within 1e-5; K3
               launched once per ``streaming_compiled`` call in auto mode;
  6. times   — per kernel and main-path shape: kernel, plain version and
               library yardstick (device time: CUDA-graph replay timed with
               CUDA events, ``time_ms``), with the bound from bytes
               and int8 operations; K3 also beside the summed K1 times of
               the same stages, at batch 1 beside 1024 rows with the
               cluster size and row tile its plan took, and the card's
               active clusters of each size
               (``cudaOccupancyMaxActiveClusters``) beside the plan's
               table; ``offline`` ms per 1024-row batch in both
               modes; K1 under all 9 tiles on the full-width KWS and AD
               stages; then K1 and K2 step by step on every main-path
               stage (``phase_k12_split``): products by ``mma.sync`` or
               by dp4a on the CUDA cores, banks searched or counted step
               by step, each variant exact first;
  7. full width — the kernels at the paper's IC and CNV stage shapes on
               seeded codes and banks drawn from the accumulators, held
               against their plain versions and timed (``FULL_WIDTH_CONVS``,
               ``FULL_WIDTH_DENSE``, and K3 on CNV's 256-512-512 FC chain);
  8. attention — ``flash_attention`` (K6) against its plain version on
               seeded q/k/v (``FLASH_CASES``): GQA 32/8 and 4/2, head dims
               16/80/128, causal, not causal, window 32, a decode chunk
               (q_offset > 0, Sq < Sk), ragged lengths and ``kv_len``, the
               bf16 kernel's tile edges (Sq and Sk of 127, 129, 255,
               windows across a 128-key tile), as strided (B, S, H, D)
               views and contiguous; float32 (the CUDA-core kernel) within
               1e-5, bf16 (the tensor-core kernel) within 2e-2;
  9. LM path — ``Model(get_config("llama3-8b"))`` at full width, bf16,
               seeded ``init`` on the card; counters set to 0, one
               ``prefill`` of 1 x 4096 seeded tokens (the chunked branch
               under "auto"), counters read: exactly 32 K6 launches, no
               other kernel, finite logits; the first and last layers' K6
               launches held against the plain version on their real
               inputs; prefill and decode times. Then the same config cut to
               2 layers at full width, float32, S 512, "chunked", TF32
               off: logits on the card equal the port on the CPU within
               1e-4. Then ``ServeEngine`` (4 slots, max_len 256) on the
               full-width model in float32 (TF32 off) serves 8 seeded
               requests of 8-32 prompt tokens and 8 new tokens; every
               request finishes with the tokens of its own sequential
               greedy decode; last, a ``torch.profiler`` breakdown of one
               prefill and one decode step of the bf16 model (device time
               by kernel family, idle share, costliest kernels and host
               ops);
 10. K6 times — at the main path's shape on its layer-0 inputs: kernel,
               plain version and ``scaled_dot_product_attention`` (the
               library yardstick, never on the path), with the bound from
               bytes and bf16 tensor-core operations, beside the CUDA-core
               kernel's 8.116400 ms; ``cuobjdump --dump-sass`` of the built
               library counts its HGMMA (wgmma) instructions, and none
               fails the run;
 11. K4, K5 — ``multi_threshold`` and ``qmatmul`` against their plain
               versions, bit for bit: the reference's test shapes
               (``tests/test_kernels.py``, the deep banks of
               ``tests/test_megakernel.py``), ragged shapes, both K5
               output dtypes, ReLU on and off, no bias, out_scale 0.03 /
               0.07 / 0.3 (``MT_CASES``, ``QMM_CASES``: also M = 1 and
               the tiny models' dense shapes as the QAT layers give them);
               K5 at ``QMM_BIG`` = 4096^3, checked and timed beside its
               bound and its share of the int8 peak; K4 also on
               unsorted banks, ties, INT32_MIN/MAX, sorted and unsorted
               channels in one call, S 63/64/65/256/1024/4096 and 30000;
 12. K1 tiles — ``threshold_matmul`` under every tile of
               ``TMM_TILE_SIZES`` against its plain version;
 13. kernel bench — ``repro_torch.bench.kernel_bench``: counters to 0, its
               checking pass (one K5 launch at 512^3, two K4 launches at
               AD's bank and a 511-step bank), counters read; then its
               times (kernel, plain version, library call: ``torch._int_mm``
               and the epilogue ops, ``torch.searchsorted``; K4's bound
               counts a binary search's compares), the conv
               lowerings and megakernel-against-staged on full-width KWS
               and AD; ``chiprun_out/BENCH_torch_kernels.json``;
 14. autotune — ``autotune_model`` on the four full-width models,
               twice in probe mode, each search with its own temporary
               cache: both configs and every pair decision's medians and
               spreads printed, and whether the two searches agree; the
               tuned ``offline`` codes equal the untuned ones bit for bit,
               a third call loads the config from the cache without
               probing; then one model-mode search per model (the learned
               cost model, ``REPRO_AUTOTUNE=model``'s path, its own cache)
               that must make no probe and record ``source: "predicted"``,
               its micro-batch and dispatch printed beside the probe
               search's and its predicted wave ms beside the probed ms of
               the same candidate, its tuned codes equal to the untuned
               ones; last, five tuned KWS ``offline`` calls traced and
               exported by ``obs.export_chrome`` to
               ``chiprun_out/trace_kws_offline.json``, its byte count
               printed;
 15. scenarios — ``run_all_scenarios`` on the four tuned models
               (``compiled=cm``, ``model_cost=schedule_cost(...)``):
               p50/p90/p99, qps, roofline and measured energy per
               scenario beside the card's name and power limit, which must
               equal ``core.codesign.CHIP_WATTS``; streamed codes equal
               ``offline``; a batch-1 query's device time (CUDA-graph
               replay) beside the SingleStream p50, and its launches;
               ServerStreaming (the Server load through the router) last;
 16. serving — the serving stack (``repro_torch.serve``) on the four tuned
               models: ``slo_micro_batch`` and ``serve_bench.bench_model``
               at load fractions 0.7 and 1.1 (SLO micro-batch, p99 budget,
               saturation measured through the router, p50/p90/p99,
               achieved qps, shed rate, occupancy); per model, for its
               logits and for its codes (the headless schedule),
               ``server_streaming`` under ``SyncEngine`` with 512 Poisson
               queries at half the saturation, and the same trace through
               a ``Router`` over a two-replica ``ReplicaPool`` on the one
               card (two CUDA streams, one executor) under
               ``AsyncEngine``; counters set to 0 before each run and read
               after: K1/K2/K3 launches equal the waves served times one
               counted ``submit_wave``'s launches (plus the scenario's own
               ``offline`` check); every wave's rows and every result
               equal ``offline`` (codes bit for bit, logits within 1e-5)
               beside ``server_streaming``'s ``bit_exact_vs_offline``; the
               highest in-flight count, and "gpu" stamped on every wave
               span; KWS compiled staged serves the sync trace (K1, 3
               launches a wave); ``TinyModelServer`` serves the four
               tenants under ``AsyncEngine`` (64 requests each, every
               result equal to ``offline``); KWS's codes on a two-replica
               pool under ``faulty_pool`` (a ``replica_crash`` on replica
               0, a ``corrupt_output`` on replica 1): no admitted request
               lost, no corrupt row served, the fault counts the plan's;
               ``server_streaming``'s ``bit_exact_vs_offline`` (the
               reference's 1e-6 against ``offline`` of all served rows)
               must read true on all four models, logits and codes;
 17. QAT     — quantization-aware training on the card (``phase_qat``):
               ``ste_round`` / ``ste_clip`` / ``ste_sign`` forward and
               backward equal the CPU bit for bit; the quickstart
               (``repro_torch.examples.quickstart``) trains its 4-bit MLP,
               streamlines it and runs the stages on K1, whose codes equal
               the plain version's; Table 1's trainings at full width
               (``bench.table1_models``: KWS 490-256x3-12 3-bit 150 steps,
               AD 128-72-72-8-72-72-128 8-bit 120 steps): step ms (host
               clock, synchronised), first and last loss, QAT accuracy /
               AUC; each exported with frozen scales and deployed in both
               modes with launches counted (auto K3 1, staged K1 3 / 5,
               the float head 1), the deployed accuracy / AUC, every
               stage's codes equal the streamlined float reference
               (``float_ref_dense`` at the frozen scales), the codes
               ``Graph.run`` gives (float weights) counted beside, and the
               share of nonzero codes per stage beside the seeded
               models'.
 18. paper benches — the paper's remaining tables and the port's benches
               (``phase_paper_benches``): Table 2 (``bench.table2_fifo``,
               the FIFO pass); Table 3 (``bench.table3_fusion``: aten graph
               ops on the input's path must shrink when BN and ReLU merge,
               the caching allocator's peak, device time); K1 on the
               im2col lowering of full-width IC and CNV
               (``phase_im2col_k1``: counters set to 0 around one
               ``offline`` of Table 6's 48-row pool, one K1 launch a conv
               stage, each held against ``ref.threshold_matmul_ref`` bit for
               bit on its patch matrix and timed beside K2's launches of the
               direct lowering); Table 6 (``bench.table6_scenarios``) at
               its full query counts on the four full-width models,
               counters set to 0 before it and read after (K1, K2, K3 and
               the float head each launched), with its asserted equalities:
               direct == im2col, offline == host == compiled, and
               ServerStreaming ``bit_exact_vs_offline``; the obs bench at
               ``REPRO_FAST`` counts with its NullTracer bar (1.02)
               asserted; the megakernel residency check; the
               ``BENCH_torch_*.json`` artifacts and the trace under
               ``chiprun_out/``; its wall time printed.

 19. LM training — the LM's training path (``phase_lm_train``): the
               built ``flash_attention_bwd`` library must hold HGMMA
               (wgmma) instructions (bf16 runs on the tensor cores); K6's
               backward kernel (``flash_attention_bwd``) against its plain
               version (``ref.flash_attention_bwd_ref``) over
               ``FLASH_BWD_CASES`` in bf16 and float32 (ragged lengths on
               both sides of the 64- and 128-row tiles,
               GQA groups 1/2/4, windows, query offsets, rows with no live
               key, kv_len 0, head dims 16/80/128; dQ, dK, dV within
               ``FLASH_BWD_TOL`` of the largest |gradient|: bf16 2e-2,
               float32 1e-5), the forward's lse against the plain lse, a
               second call equal bit for bit; then (a) full-width
               internlm2-1.8b (24 layers, bf16, remat "full", S 4096) for
               ``TRAIN_STEPS`` steps of 4 sequences in 2 microbatches
               through ``DataPipeline`` and ``make_train_step``, counters
               set to 0 before and read after: exactly 2 x 24 K6 forward
               and 24 backward launches a microbatch and no other kernel;
               the first microbatch's backward launches of layers 23 and
               0 held against the plain version on their inputs; a finite
               loss whose mean over the last 4 steps is below the first;
               step ms, tokens/s, 6NT / step / 989e12 and peak memory; K6's
               backward timed beside its plain version, SDPA's backward,
               its bound (5 products) and the CUDA-core kernel's 30.500
               ms; (b) the same width cut to 2 layers under
               ``torch.use_deterministic_algorithms(True)``:
               ``run_training`` with a crash at step 3 and a resume ends
               with a checkpoint equal bit for bit to an uninterrupted
               run's, every run's step a ``StepProgram`` (one CUDA graph)
               and the resume a new program over a state of another seed
               (checkpoints under ``build/``, removed after; bytes, save
               and restore seconds printed); (c) ``weight_bits=8`` at 2
               layers, two steps with finite losses; (d)
               ``repro_torch.launch.train.main`` with ``--reduced`` on the
               card, its 10 steps through one graph. (b) runs in a child process whose environment sets
               ``CUBLAS_WORKSPACE_CONFIG`` before its CUDA starts: set in
               this process it would slow every later cuBLAS call.
 20. LM families — MoE, mamba, the jamba hybrid, M-RoPE and embedding
               inputs (``phase_families``): (a) full-width sublayers in
               float32 (TF32 off) on the card against the port on the CPU
               with the same weights, outputs within ``SUBLAYER_TOL`` (1e-4)
               of the largest |y|: a jamba MoE FFN (16 experts, top-2) and
               a llama4-scout one (top-1 and the shared expert) at 1 x 128
               tokens and at the 4-slot decode shape, their expert choices
               and drops equal (a token whose top-k margin is under 1e-6 is
               reported and left out); a jamba mamba mixer, prefill at S 512
               then 8 decode steps from its conv window and state; a
               qwen2-vl attention with M-RoPE positions at S 512 (naive, a
               temporal row that is not an arange) and S 4096 (K6); (b)
               jamba-v0.1-52b in bf16 at its published widths, 16 of its 32
               layers (its weight count must equal ``ArchConfig.n_params``):
               counters set to 0, one ``prefill`` of 1 x 4096 seeded tokens,
               counters read: exactly 2 K6 launches and no other kernel,
               finite logits; every K6 launch of phase 20's prefills held
               against the plain version within ``FAMILY_K6_TOL`` (max
               error 2e-2 of max |plain|, mean error 1e-2 of mean |plain|),
               and the plain attention without its first key tile shown to
               fail that check; prefill ms and peak memory; then
               ``ServeEngine`` (4 slots, max_len 256) twice on 8 seeded
               requests of 8-32 prompt tokens and 8 new tokens: both runs give the same tokens, and after
               every insert the slot's mamba conv windows and states equal
               the batch-1 prefill's bit for bit; the MoE choices the decode
               batch drops are counted; the second run, which has no check
               on its path, is the engine's reading; a decode step alone
               at batch 1 and batch 4; (c) falcon-mamba-7b at full width
               and depth in float32 (TF32 off): the engine against each
               request's own sequential greedy decode, and a decode step
               alone at batch 1 and batch 4; (d) qwen2-vl-2b and
               hubert-xlarge at full width and depth in bf16: one counted
               prefill at S 4096 from seeded embeddings (qwen2-vl with
               M-RoPE positions), K6 launched 28 and 48 times and nothing
               else, finite logits; each model's K6 timed at its layer-0
               inputs beside SDPA and its bound; (e) ``launch.serve`` and
               ``launch.train`` on jamba ``--reduced`` on the card. A
               ``torch.profiler`` split of jamba's prefill and of one decode
               step of jamba and of falcon-mamba at batch 4 and at batch 1
               (the device's idle share) runs last, after phase 9's.

 21. int8 serve — the LM's int8 serve path (``phase_int8_serve``):
               full-width llama3-8b (32 layers, published widths) in bf16
               and its ``Model.quantize_params(bits=8)`` tree, both held on
               the card (tree bytes and the quantize time printed);
               counters set to 0, one int8 ``prefill`` of 1 x 4096 seeded
               tokens, counters read: exactly ``K5_PER_PASS`` (7 linears x
               32 layers + the head = 225) K5 launches, 32 K6 launches and
               nothing else; every K5 launch of layers 0 and 31 and the
               head held against ``ref.qmatmul_ref`` bit for bit on its own
               activations; finite logits; the top-1 agreement of the int8
               logits with the bf16 ones printed; one decode step at batch
               4 counted (225 K5 launches); prefill and decode ms, int8 and
               bf16 in turns; peak memory; ``examples.serve_lm``'s loop
               (8 requests of 3-9 prompt tokens and 12 new tokens, 4
               slots: 96 tokens in about 22 engine steps, prompt steps
               most of them, so its tokens/s is a smoke reading, not the
               engine's throughput) on both trees; K5 timed at
               each of the prefill's five shapes (weighted by its launches
               for the kernels line) beside its plain version,
               ``torch._int_mm`` + the scale and its bound, and at the
               decode step's shapes. A ``torch.profiler`` split of the
               int8 prefill and decode step (K5's share of the device
               time) runs last (``phase_int8_profile``).
 22. mesh — the mesh layer on a one-rank NCCL group (``phase_mesh``):
               ``make_elastic_mesh(2)`` is (1, 1); ``make_ddp_compressed_
               step`` on the reference's least-squares toy, its loss
               falling under 0.05 of the first in 60 steps; ``moe_apply``
               under the mesh, plain and as a remat block, equal bit for
               bit to it without one, on a reduced jamba MoE sublayer
               (output, aux loss and gradients), the block's recompute
               run on autograd's device thread under the mesh; then ``python -m repro_torch.launch.train
               --reduced --model-parallel 2`` as a child process (its own
               group of one rank, a (1, 1) mesh, 4 steps).

 23. dry run — the dry run, the op-trace analysis and the roofline
               (``phase_dryrun``): (a) the cells of ``python -m
               repro_torch.launch.dryrun --all --mesh both`` in child
               processes, eight at a time (a cell a process for the SSM
               configs, an (arch, shape) pair for the others; the meta
               device, torch's fake process group of 512 ranks, whose
               internal module must import here; each cell traces rank
               0's step), then ``launch.roofline`` on the records for both
               meshes (the collective column filled on every ok cell, the
               most collective-bound cell named) and ``bench.run --only
               roofline`` in a directory that holds them; every ok cell
               has its collective bytes; the reference's bar
               (``tests/test_roofline_launch.py``): per mesh 40 cells, 32
               ok, 8 skipped, no error, every ok cell's useful ratio in
               (0, 1.5]; its wall time; the records go to
               ``chiprun_out/dryrun/``, the tables to
               ``chiprun_out/roofline.txt``. Then ``--all --mesh single``
               under ``--strategy seqpar`` and ``--strategy ep``, the same
               ``--jobs`` (``_dryrun_strategy``): the baseline's statuses,
               but under ``ep`` grok-1-314b's traced cells, errors that
               name the experts' dimension (8 experts on the 16-wide model
               axis, which the reference's jit refuses too; the run's exit
               code 1 for them alone); every ok cell with its collective
               bytes and no ``not_ported`` key; under ``seqpar`` every
               decode cell the baseline's FLOPs and collectives and every
               other ok cell reduce-scattering. (b) Three steps that fit one
               card (``DRYRUN_STEPS``): phase 19's internlm2-1.8b train
               step (4 x 4096, 2 microbatches, remat full), a bf16
               llama3-8b prefill of 1 x 4096 and its int8 prefill (K5),
               each traced on meta and then, with seeded weights, once on
               the card under the same analysis: equal FLOPs, argument
               bytes equal to the trees' bytes on both, the measured
               ``max_memory_allocated`` over the meta trace's peak in
               [0.5, 2.0], the same kernel calls, each call's count equal
               to its kernel row's ops (``k5_ops``, ``k6_ops``,
               ``k6_bwd_ops``) and the launch counters equal to the calls;
               then the step timed without the analysis beside its
               roofline row (compute, memory, the bound and the step's
               share of it).

 24. spmd — the SPMD train step over two ranks that share the card
               (``phase_spmd``): two child processes (this file with
               ``--spmd-worker``) in a ``gloo`` group over the card's
               tensors (NCCL refuses two ranks on one device; gloo takes
               the step's all-reduces and all-gathers of float32, bf16
               and int32 CUDA tensors), ``CUBLAS_WORKSPACE_CONFIG`` set in
               their environment. (a) Reduced llama3-8b in float32 (TF32
               off) with the chunked attention (K6), 8 x 64, on the
               ("data", "model") meshes (1, 2) and (2, 1) under
               ``launch.dryrun.arch_rules``, 3 steps each: the losses
               within rtol 2e-3 of one rank's on the same weights and
               batches (the reference's bar between its SPMD step and one
               device), the same on both ranks, and the first step's
               gradient blocks within 1e-5 of each leaf's largest |g| of
               the one-rank gradients' blocks. (b) internlm2-1.8b at its
               published widths, all 24 layers, bf16, remat "full", S
               4096, on (1, 2) (heads 8 / 8 kv heads 4 a rank, d_ff and
               vocab split): 2 sequences a step in one microbatch (cut
               from phase 19's 4 in 2, as two ranks share the card), 3
               steps; counters set to 0 before the steps and read after:
               K6 2 x 24 and its backward 24 a step on each rank, nothing
               else; every K6 and K6-backward launch of the first step
               held against its plain version (forward: 2e-2 of max
               |plain| and 1e-2 of mean |plain|, as phase 20; backward:
               2e-2 of the largest |gradient|, as phase 19); finite
               losses, equal on both ranks and within 1e-2 relative of
               one rank's (rank 0 alone, the same weights and batches);
               each rank's step ms (host clock: through gloo and the
               host, a smoke reading and not a tensor-parallel
               throughput) and peak memory; K6 and its backward timed at
               the rank-local shape (rows of the kernels line, with the
               launches of both ranks). (c) One step of reduced llama3-8b
               on (2, 1), saved with the state's spec tree (gathered,
               rank 0 writes), restored on one rank: equal to the
               gathered state bit for bit, and a step from it equal bit
               for bit to the one-rank step from the gathered state
               (deterministic algorithms on). A rank that fails ends the
               other and the phase; the ranks' logs go to
               ``chiprun_out/spmd_rank*.log``. Phase 26's (a) and (c) run
               in these ranks, after (b).

 25. spmd inference — mamba, the hybrid blocks, prefill and decode under
               a mesh (``phase_spmd_inference``): two ranks sharing the
               card over ``gloo`` as in phase 24 (this file with
               ``--spmd-inference-worker``; logs to
               ``chiprun_out/spmd_inference_rank*.log``). (a) Reduced
               falcon-mamba-7b and jamba-v0.1-52b (capacity factor 4: no
               drop under any dispatch grouping) in float32, 8 x 64, 3
               steps on (1, 2) and (2, 1): losses within rtol 2e-3 of one
               rank's, the same on both ranks. (b) falcon-mamba-7b at its
               published widths (d_model 4096, d_inner 8192: 4096 mixer
               channels a rank, the ``in_proj`` blocks exchanged by an
               all-to-all) cut to ``SPMD2_MAMBA_LAYERS`` (16) of its 64
               layers, bf16, remat full, one 4096-token sequence a step on
               (1, 2), 3 steps (the first under the op-trace analysis):
               losses within 1e-2 relative of one rank's (rank 0 alone),
               step ms and peak memory a rank. (c) llama3-8b whole on (1,
               2): a bf16 prefill of 1 x 4096 (every K6 launch held
               against its plain version at the rank-local 16 / 4 heads)
               and 4 decode steps at batch 4 against a 256-position cache
               split 128 / 128 over the ranks (slots at 17, 64, 100 and
               200), then the same on the int8 tree that
               ``quantize_params`` makes of the rank's blocks (K5, the
               row-parallel linears in its int32 accumulator mode; the
               launches of layers 0 and 31 and the head of the prefill,
               and of the first decode step, equal to the plain version
               bit for bit), and again on the int8 tree with float32
               activations (TF32 off; every K6 launch held against its
               plain version); counters set to 0 before and read after
               each. Rank 0's int8 blocks equal the blocks of the whole
               int8 tree bit for bit. Then rank 0 alone runs the whole
               trees: the bf16 logits within ``SPMD2_NOISE_FACTOR`` (3x
               the max, 2x the mean) of bf16's own noise (one rank's
               logits against its run with float32 activations, TF32
               off), the top-1 equal wherever one rank's top-2 margin
               exceeds twice the largest |diff|; on the int8 tree, layer
               0's seven K5 launches of the mesh take the leading blocks
               of one rank's codes and weights (and, column-parallel, its
               scales and outputs) bit for bit, and the two ranks' int32
               blocks of its two row-parallel launches sum to one rank's
               accumulator bit for bit (``SPMD2_K5_EXACT``); the
               float32-activation int8 prefill within ``SUBLAYER_TOL`` of
               one rank's largest |logit| with top-1 equal at every
               position; its decode steps and the bf16-activation int8
               logits are a reading beside the tree's noise; the top-1
               agreement over all positions is reported; decode step ms;
               K6 (bf16 and float32) and K5 (both modes) timed at the
               rank-local shapes (rows of the kernels line, with both
               ranks' launches). (d)
               jamba-v0.1-52b at its published widths cut to
               ``SPMD2_JAMBA_LAYERS`` (8: one group of 7 mamba mixers, an
               attention one and 4 MoE FFNs of 16 experts), in float32
               (TF32 off: at 4 decode tokens an expert takes one token,
               and bf16 noise flips near-tied routing choices), the
               rank's blocks drawn one rank at a time: a counted prefill
               of 1 x 4096 (K6 once a rank, held against its plain
               version and timed) and 4 decode steps, within
               ``SUBLAYER_TOL`` of rank 0 alone's largest |logit|. (e)
               The collectives of the real
               rank-local steps (the op-trace counter on CUDA tensors: the
               train step of (b), the prefills and first decode steps of
               (c)) equal, type by type in count and bytes, the same
               steps traced on meta over a fake group of two ranks
               (``launch.dryrun.rank_trees`` / ``trace_step``), printed
               beside phase 23's records of falcon-mamba-7b train_4k,
               llama3-8b prefill_32k and decode_32k (single-pod). Phase
               26's (b) and (d) run in these ranks.

 26. seqpar and ep — the sequence-parallel residual stream and expert
               parallelism on two ranks that share the card
               (``phase_seqpar_ep``); each run sits in phase 24's or 25's
               ranks beside the one-rank run it reuses (the same weights
               and inputs), its counters set to 0 before it and read
               after. (a) Phase 24 (b)'s internlm2-1.8b steps under
               ``seqpar`` (the residual stream in two 2048-position
               blocks): losses within 1e-2 of the same one rank's, equal
               on both ranks; K6 2 x 24 and its backward 24 a step at the
               baseline mesh's shapes (every launch of the first step held
               against its plain version); step ms and peak memory beside
               the baseline mesh's. (b) Phase 25 (c)'s bf16 prefill under
               ``seqpar`` on the same blocks: within ``SPMD2_NOISE_FACTOR``
               of bf16's noise against one rank, top-1 as (c); K6 32 a
               rank, held. (c) llama4-scout-17b-16e at its published
               widths cut to ``SEQEP_SCOUT_LAYERS`` (1) of its 48 layers
               and ``SEQEP_SCOUT_EXPERTS`` (4) of its 16 experts (with 16,
               two ranks and this process overflow the card at the
               optimizer update; with 8, one rank's step does), bf16, 2 x
               2048 a step (the naive attention: no K6), 3 steps under
               ``ep`` on (1, 2) (2 whole experts a rank, the shared expert
               whole) against rank 0
               alone: losses within 1e-2. (d)
               Phase 25 (d)'s jamba under ``ep``: the prefill and 4 decode
               steps within ``SUBLAYER_TOL`` of the same one rank's largest
               |logit|; K6 once a rank, held. (e) The collectives of (a)'s
               and (c)'s first steps, (b)'s prefill and (d)'s prefill and
               first decode step equal, type by type in count and bytes,
               the same steps traced on meta over a fake group of two ranks
               under the same rules (reduce-scatters under ``seqpar``).
 27. programs — the compiled programs (``core.programs.Program``: one
               CUDA graph per input shape, captured at the first call and
               replayed). (a) ``phase_programs``: the four Table-1 models
               at full width in both dispatch modes under phase 14's
               tuned configs: ``offline`` at 1 and 1024 rows, the codes
               (the schedule without its float head), every segment
               program of ``streaming_compiled`` at the tuned micro-batch
               and of ``submit_wave`` full and a third filled: each replay
               equals the eager run of the function its graph captured
               bit for bit, launches what that run launches and what the
               capture recorded (``offline``: ``MAIN_PATH_LAUNCHES`` and
               the head), and two replays do not alias;
               ``streaming_compiled`` and ``submit_wave`` give their
               segments' replays; ``apply_tuned`` drops every graph; a
               capture of a function that reads the host raises (twice:
               no eager fallback) and holds no graph (in a child process:
               an aborted capture can keep the caching allocator from
               handing memory back); a
               1-row ``offline`` eagerly and by replay, p50 and p90 of
               ``PROGRAM_TIMED_CALLS`` synchronised calls on the host
               clock, beside its device time. (b) ``_engine_programs``,
               run where phases 20 and 21 hold the models (llama3-8b
               whole in bf16 and int8, jamba at ``JAMBA_LAYERS``,
               falcon-mamba-7b whole in float32): ``ServeEngine``'s
               tokens through its decode and prefill graphs equal its
               eager steps' on the same 8 requests (4 slots); a decode
               step at ``PROGRAM_DECODE_CUR`` replayed and run eagerly
               from the same cache gives the same logits and caches bit
               for bit and the same launches (the int8 step's graph holds
               K5's 225); the step's host ms each way beside phases 9's
               and 21's eager readings; the profiles of phases 9, 20 and
               21 add the replayed step (``torch.profiler`` sees the
               graph's kernels): its busy and idle share.
 28. train programs — the training steps and the stage programs as CUDA
               graphs (``phase_train_programs``), in a child process
               (its graphs' pools stay out of this one). (a) KWS and AD QAT at
               phase 17's full width and steps through
               ``core.codesign.tiny_adam``'s step program and its eager
               function from the same initial parameters and batches:
               every loss, parameter and the counter bit for bit; host ms
               a step (p50 / p90, synchronised), device kernels, busy ms
               and idle share of one step each way (``torch.profiler``).
               (b) Under deterministic algorithms
               (``CUBLAS_WORKSPACE_CONFIG`` set before its CUDA starts):
               full-width internlm2-1.8b as phase 19 (a) trains it, 1 +
               ``TRAIN_PROGRAM_REPLAYS`` eager steps, then the same steps
               from the same seeded state through ``StepProgram`` (the
               first call warms up and captures, the rest replay):
               metrics, parameters, m, v and the counter bit for bit, K6
               and K6-backward launches of every replay equal the eager
               step's by the wrappers; step ms, peak memory and one step
               of each under ``torch.profiler`` (the card's activity);
               K6's forward timed on a caught launch of the eager steps.
               (c) Run inside phase 19: (b)'s crash and resume at depth 2
               go through step programs (the crash path saves the program
               run's state; a new model, state of another seed and program
               resume from it into that state's own tensors, equal to the
               uninterrupted run bit for bit), and (d)'s launcher on one
               rank runs its 10 steps through its program (one graph) and
               logs it. (d) The four Table-1 models at
               full width in both modes: ``stage_outputs`` and
               ``streaming_host`` replayed through the stage programs
               equal the same calls through each stage's eager function
               bit for bit, with the same launches; ``stage_latencies`` at
               1 row each way.

``python3 chip_smoke.py --mamba-gap`` runs only phase 25 (b)'s
falcon-mamba-7b cut to ``MAMBA_GAP_LAYERS`` layers, in bf16 and in
float32 (TF32 off), on (1, 2) and on one rank, and prints the losses and
the mesh's relative gap from one rank.

Phase 21 runs right after phase 9's serving, before phases 11-16.
Phase 16 runs after phase 15, phase 27 (a) after it, 17 after that, 18
after 17, phase 19 after it, 28 after 19, 20 after 28, 22 after those,
23 after 22, 24
after 23, 25 after 24, 26 after 25; the profiles of phases 9, 20 and 21
run last of all. The last lines are the kernels JSON line, the card's
name and power limit (``nvidia-smi``), and ``{"ok": true, "device":
{...}}``. Per-shape details go to
``chiprun_out/chip_smoke_details.json`` (the serving readings under
``"serving"``, training under ``"lm"`` / ``"train"``). Each kernel's
``launches`` comes from its own main path's counted run: phase 3 for
K1-K3 and the float head, phase 9's prefill and phase 20's three
counted prefills for K6 (32 + 2 + 28 + 48), phase 19's full-width
training for K6's backward, phase 13's checking pass for K4 and K5,
and for K5 also phase 21's int8 prefill (1 + 225); phase 24's counted
run adds its two ranks' launches to K6 (2 x 144) and its backward
(2 x 72); phase 25's add to K6 (2 x (32 + 32 + 32 + 1): the bf16, int8
and int8 float32-activation prefills of (c), jamba's of (d)) and to K5
(2 x 2 x 5 x 225: the int8 prefills and 4 decode steps of (c), 2 x 2 x
5 x 64 of them in the int32 accumulator mode); phase 26's add to K6
(2 x (144 + 32 + 1): (a), (b), (d)) and its backward (2 x 72: (a));
phase 28 (b)'s replays add theirs (``TRAIN_PROGRAM_REPLAYS`` x 2 x 24 x
2 to K6, x 2 x 24 to its backward).
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "golden")
BATCH = 1024
SEED = 2022
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
INT32_OPS_PER_S = 64 * 132 * 1.98e9  # H100 SXM CUDA-core int32 rate
                                     # (64 lanes/SM, 132 SMs, 1.98 GHz)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
LM_CONFIG = "llama3-8b"
LM_SEQ = 4096                    # prefill length: "auto" takes K6 above 2048
REPLACES = {
    "threshold_matmul": ("src/repro_torch/kernels/csrc/threshold_matmul.cu",
                         "src/repro/kernels/multi_threshold.py:163"),
    "conv_threshold": ("src/repro_torch/kernels/csrc/conv_threshold.cu",
                       "src/repro/kernels/conv_threshold.py:127"),
    "mlp_megakernel": ("src/repro_torch/kernels/csrc/mlp_megakernel.cu",
                       "src/repro/kernels/megakernel.py:81"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:96"),
    # K6's backward: the reference differentiates its jnp flash twin
    # (src/repro/models/attention.py:165); no TPU kernel of its own
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:96"),
    "multi_threshold": ("src/repro_torch/kernels/csrc/multi_threshold.cu",
                        "src/repro/kernels/multi_threshold.py:81"),
    "qmatmul": ("src/repro_torch/kernels/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:60"),
    # a repair, not a TPU kernel: the reference's float head expression
    "float_head": ("src/repro_torch/kernels/csrc/float_head.cu",
                   "src/repro/deploy/lower.py:441"),
}
#: the peak each kernel's operations are bounded by: integer MACs on the
#: int8 tensor-core rate, attention on the bf16 rate, K4's compares on the
#: CUDA cores' int32 rate
PEAK_OPS_PER_S = {"threshold_matmul": INT8_OPS_PER_S,
                  "conv_threshold": INT8_OPS_PER_S,
                  "mlp_megakernel": INT8_OPS_PER_S,
                  "flash_attention": BF16_OPS_PER_S,
                  "flash_attention_bwd": BF16_OPS_PER_S,
                  "multi_threshold": INT32_OPS_PER_S,
                  "qmatmul": INT8_OPS_PER_S,
                  "float_head": FP32_OPS_PER_S}
#: the kernels of the integer path (phase 3), of the LM path (phase 9) and
#: of the kernel bench (phase 13)
TINY_KERNELS = ("threshold_matmul", "conv_threshold", "mlp_megakernel")
#: the float head every Table-1 schedule ends in: one launch an offline call
HEAD_KERNEL = "float_head"
LM_KERNELS = ("flash_attention",)
#: the kernel only the LM's training path launches (phase 19)
TRAIN_KERNELS = ("flash_attention_bwd",)
BENCH_KERNELS = ("multi_threshold", "qmatmul")
#: the two dispatch modes of the main path: (label, ``megakernel=``)
MODES = (("staged", False), ("auto", None))
#: launches of one ``offline`` call of each model in each mode, in
#: ``TINY_KERNELS`` order (K1, K2, K3): staged, K1 runs the dense stages
#: (KWS 3, AD 5, CNV's two hidden FCs) and K2 the convs (IC 5, CNV 6);
#: auto, one K3 launch takes each MLP run (KWS, AD, CNV's FCs)
MAIN_PATH_LAUNCHES = {"kws/staged": (3, 0, 0), "ad/staged": (5, 0, 0),
                      "ic/staged": (0, 5, 0), "cnv/staged": (2, 6, 0),
                      "kws/auto": (0, 0, 1), "ad/auto": (0, 0, 1),
                      "ic/auto": (0, 5, 0), "cnv/auto": (0, 6, 1)}
#: rows of the 1024-row batch the CPU port computes to hold the card's
#: outputs against: all for the MLPs; 256 for IC and CNV, whose convs cost
#: the CPU's plain path billions of multiply-adds (the card's kernels are
#: held against their plain versions on the card at all 1024 rows)
CPU_CHECK_ROWS = {"ic": 256, "cnv": 256}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def load_models():
    """(name, graph, in_scale, x) for the four models of the main path, all
    at the paper's full width from numpy-seeded parameters
    (``repro_torch.bench.models``): KWS and AD by ``mlp_graph``, IC (its
    scales calibrated on seeded codes) and CNV by ``ic_graph`` /
    ``cnv_graph``; 1024 rows of seeded input codes in [-127, 127] each."""
    import numpy as np
    from repro_torch.bench.models import (AD_BITS, AD_DIMS, KWS_BITS,
                                          KWS_DIMS, cnv_graph, ic_graph,
                                          mlp_graph)

    rng = np.random.default_rng(SEED)
    models = [("kws", mlp_graph(KWS_DIMS, KWS_BITS, SEED + 1, name="kws"),
               1.0 / 127.0, (BATCH, KWS_DIMS[0])),
              ("ad", mlp_graph(AD_DIMS, AD_BITS, SEED + 2, name="ad"),
               1.0 / 127.0, (BATCH, AD_DIMS[0]))]
    for name, g in (("ic", ic_graph(SEED + 3)), ("cnv", cnv_graph(SEED + 4))):
        shape = tuple(g.nodes[0].attrs["in_shape"])
        models.append((name, g, g.meta["in_scale"], (BATCH,) + shape))
    return [(n, g, s, rng.integers(-127, 128, shp).astype(np.int32))
            for n, g, s, shp in models]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps=7, inner=20):
    """Device ms per call of ``fn`` by CUDA-graph replay
    (``repro_torch.bench.common.time_ms``)."""
    from repro_torch.bench.common import time_ms as device_ms

    return device_ms(fn, reps=reps, inner=inner)


def bound_ms(n_bytes, n_ops, ops_per_s=INT8_OPS_PER_S):
    """Least time for the work: bytes over HBM rate or operations over the
    kernel's tensor-core peak, whichever is larger (published H100 SXM
    peaks)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s) * 1e3


def k5_ops(m, k, n):
    """K5's operations: m k n multiply-adds, 2 each."""
    return 2 * m * k * n


def k6_ops(b, h, d, pairs):
    """K6's operations: two products of 2 d operations a live pair."""
    return 4 * b * h * d * pairs


def k6_bwd_ops(b, h, d, pairs):
    """K6 backward's operations for its bound: five products of 2 d
    operations a live pair (the kernel itself makes seven)."""
    return 10 * b * h * d * pairs


def bound_by(n_bytes, n_ops, ops_per_s):
    return ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / ops_per_s
            else "operations")


def tmm_cost(x, w, t):
    m, k = x.shape
    n, s = t.shape
    return (x.numel() * 4 + w.numel() + t.numel() * 4 + m * n * 4,
            2 * m * n * k)


def conv_cost(x, w, t, kernel, out_h, out_w):
    n, _, _, c = x.shape
    f = w.shape[1]
    return (x.numel() * 4 + w.numel() + t.numel() * 4
            + n * out_h * out_w * f * 4,
            2 * n * out_h * out_w * kernel * kernel * c * f)


def tmm_case(model, stage, x, w, t):
    """A timing case for ``threshold_matmul`` on (x, w, t)."""
    from repro_torch.kernels import ops, ref

    nbytes, nops = tmm_cost(x, w, t)
    return {"kernel": "threshold_matmul", "model": model, "stage": stage,
            "shape": f"M={x.shape[0]} K={x.shape[1]} N={w.shape[1]} "
                     f"S={t.shape[1]}",
            "run": lambda: ops.threshold_matmul(x, w, t),
            "plain": lambda: ref.threshold_matmul_ref(x, w, t),
            "library": _mm_library(x, w),
            "inputs": (x, w, t), "bytes": nbytes, "ops": nops}


def head_case(model, stage, x, w, b, in_scale):
    """A timing case for ``float_head`` on the head's main-path codes."""
    import torch
    from repro_torch.kernels import ops, ref

    m, k = x.shape
    n = w.shape[1]
    xf = x.to(torch.float32)
    return {"kernel": "float_head", "model": model, "stage": stage,
            "shape": f"M={m} K={k} N={n}",
            "run": lambda: ops.float_head(x, w, in_scale, b),
            "plain": lambda: ref.float_head_ref(x, w, in_scale, b),
            "library": lambda: torch.addmm(b, xf, w, alpha=in_scale),
            "library_is": "library (torch.addmm on float codes)",
            "inputs": (x, w, b), "bytes": (m * k + k * n + n + m * n) * 4,
            "ops": 2 * m * k * n}


def conv_case(model, stage, x, w, t, kw):
    """A timing case for ``conv_threshold`` on (x, w, t) with the conv
    geometry ``kw`` (kernel, stride, padding, out_h, out_w)."""
    from repro_torch.kernels import ops

    nbytes, nops = conv_cost(x, w, t, kw["kernel"], kw["out_h"], kw["out_w"])
    return {"kernel": "conv_threshold", "model": model, "stage": stage,
            "shape": f"N={x.shape[0]} {x.shape[1]}x{x.shape[2]}x"
                     f"{x.shape[3]} F={w.shape[1]} K={kw['kernel']} "
                     f"stride={kw['stride']} {kw['padding']} S={t.shape[1]}",
            "run": lambda: ops.conv_threshold(x, w, t, **kw),
            "plain": lambda: _conv_plain(x, w, t, **kw),
            "library": _conv_library(x, w, **kw),
            "inputs": (x, w, t), "geometry": kw, "bytes": nbytes,
            "ops": nops}


def chain_codes(x, weights, banks):
    """Each stage's input codes along a dense chain (plain versions): the
    inputs the staged K1 launches of the same run see."""
    from repro_torch.kernels import ref

    hs = [x]
    for w, b in zip(weights[:-1], banks[:-1]):
        hs.append(ref.threshold_matmul_ref(hs[-1], w, b))
    return hs


def mega_case(model, stages, x, weights, banks):
    """A timing case for ``mlp_megakernel`` on one dense run: x (M, K_0)
    int32, per-stage int8 weights and (N, S) banks (the stages'
    ``thresholds``), all on the card; the kernel takes the weights packed
    and the banks step-major, as the executor passes them (prepared once
    here, outside the timed call), its plain version the same banks.
    Beside them: the staged K1 launches of the same stages, the fp32
    ``torch.matmul`` chain of the accumulators alone (TF32 off), and the
    plan the wrapper takes (cluster size, row tile)."""
    import torch
    from repro_torch.kernels import ops, ref

    banks_sn = [b.t().contiguous() for b in banks]
    packed = [ops.megakernel_pack_weights(w) for w in weights]
    hs = chain_codes(x, weights, banks)
    hf = [h.to(torch.float32) for h in hs]
    wf = [w.to(torch.float32) for w in weights]
    torch.backends.cuda.matmul.allow_tf32 = False
    m = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    steps = [b.shape[1] for b in banks]
    nbytes = (x.numel() * 4 + m * dims[-1] * 4
              + sum(w.numel() for w in weights)
              + sum(b.numel() * 4 for b in banks))
    nops = 2 * m * sum(w.shape[0] * w.shape[1] for w in weights)
    return {"kernel": "mlp_megakernel", "model": model, "stage": stages,
            "shape": f"M={m} dims={'-'.join(map(str, dims))} "
                     f"S={'/'.join(map(str, steps))}",
            "run": lambda: ops.mlp_megakernel(x, packed, banks_sn),
            "plain": lambda: ref.mlp_megakernel_ref(x, weights, banks_sn),
            "library": lambda: [torch.matmul(h, w) for h, w in zip(hf, wf)],
            "staged": lambda: [ops.threshold_matmul(h, w, b) for h, w, b
                               in zip(hs, weights, banks)],
            "plan": ops.megakernel_plan(tuple(dims), tuple(steps), m),
            "inputs": (x, weights, banks), "bytes": nbytes, "ops": nops}


def phase_k3_occupancy():
    """The clusters of 1-8 K3 CTAs the card runs at once
    (``cudaOccupancyMaxActiveClusters`` at a CTA's full and smallest
    shared memory), beside ``ops.MEGAKERNEL_ACTIVE_CLUSTERS``, the H100
    table the plan prices waves with; a cluster size the card cannot run
    fails the run. Returns the table."""
    from repro_torch.kernels import ops

    table = {}
    for smem in (16_384, 232_448):
        table[smem] = [ops.megakernel_active_clusters(c, smem)
                       for c in range(1, ops.MEGAKERNEL_MAX_CLUSTER + 1)]
        check(min(table[smem]) > 0, f"K3: a cluster size of {table[smem]}"
                                    f" active clusters at {smem} B a CTA "
                                    f"cannot be scheduled")
        log(f"K3 active clusters of 1..{ops.MEGAKERNEL_MAX_CLUSTER} CTAs "
            f"at {smem} B a CTA: {table[smem]} (the plan's table "
            f"{list(ops.MEGAKERNEL_ACTIVE_CLUSTERS)})")
    return table


def mega_batch1_rows(rows_1024, cases):
    """Each K3 case again on its first row alone (a SingleStream query's
    shape), timed beside the 1024-row time; rows with no launches of the
    counted run. Logs the plan each took."""
    out = []
    for row, c in zip(rows_1024, cases):
        if c["kernel"] != "mlp_megakernel":
            continue
        x, weights, banks = c["inputs"]
        one = mega_case(c["model"], c["stage"], x[:1].contiguous(), weights,
                        banks)
        r1 = time_case(one)
        r1["launches"] = 0
        out.append(r1)
        p1, p = one["plan"], c["plan"]
        log(f"K3 {c['model']}/{c['stage']}: M=1 {r1['ms']:.6f} ms "
            f"({p1['cluster']} CTAs x {p1['block_m']} rows), M={x.shape[0]} "
            f"{row['ms']:.6f} ms ({p['cluster']} CTAs x {p['block_m']} "
            f"rows), staged K1 at M={x.shape[0]} "
            f"{row.get('staged_k1_ms', float('nan')):.6f} ms")
    return out


def _random_chain(g, m, dims, steps, lo, hi):
    """Seeded codes (M, dims[0]) in [lo, hi), int8 weights, and sorted
    (N, S) banks drawn from each stage's own accumulator so counts
    spread."""
    import torch
    from repro_torch.kernels import ref

    x = torch.randint(lo, hi, (m, dims[0]), generator=g, dtype=torch.int32)
    weights, banks, h = [], [], x
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        b = _banks(ref.int_matmul(h, w), n, s, g)
        h = ref.threshold_matmul_ref(h, w, b)
        weights.append(w)
        banks.append(b)
    return x, weights, banks


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# K1 checks beyond the models' own banks (M, K, N, S, bank kind, code
# range), each under the 32 x 32, default and 128 x 128 tiles: every bank
# kind of ``kernel_bench.bank_of_kind``, depths 1 to 1000 (searched: whole
# banks are padded to 2^k - 1 steps, 1023 here), 1024 and 2000 (past the
# default tile's shared memory: the chunked linear count), and every
# mma flavour (s8, u8, binary, and codes wider than a byte: the byte split,
# with K small enough that the sums fit int32)
K1_BRANCH_CASES = [
    (300, 200, 72, 255, "sorted", "s8"), (300, 200, 72, 255, "unsorted", "u8"),
    (300, 200, 72, 255, "ties", "binary"), (300, 200, 72, 255, "mixed", "u8"),
    (300, 200, 72, 255, "extreme", "s8"), (257, 130, 40, 7, "sorted", "wide"),
    (257, 130, 40, 255, "mixed", "wide"), (129, 490, 70, 1000, "sorted", "u8"),
    (129, 490, 70, 1024, "mixed", "u8"),
    (129, 64, 33, 1, "unsorted", "s8"), (65, 33, 9, 2000, "mixed", "u8"),
    (1024, 256, 40, 2000, "sorted", "s8")]
# K2 checks (N, H, W, C, F, kernel, stride, padding, S, bank kind, code
# range), each under the planned row block, 1 and 3 rows: C of 1, 3 and 5
# (byte loads) and multiples of 4 (word loads; a padded pixel stride from
# 32 channels), F past one 64-channel block, every bank kind, deep banks
# (1000 searched; 1024 and 6000 counted in chunks), every mma flavour
K2_BRANCH_CASES = [
    (3, 12, 12, 3, 32, 3, 1, "VALID", 255, "sorted", "s8"),
    (2, 16, 16, 3, 32, 1, 1, "SAME", 255, "unsorted", "s8"),
    (2, 16, 16, 32, 4, 4, 1, "SAME", 255, "mixed", "u8"),
    (2, 16, 16, 4, 32, 4, 1, "SAME", 255, "ties", "u8"),
    (2, 16, 16, 32, 32, 4, 4, "SAME", 255, "extreme", "u8"),
    (2, 10, 10, 8, 70, 3, 1, "VALID", 1, "sorted", "binary"),
    (2, 7, 9, 64, 130, 3, 1, "SAME", 7, "unsorted", "binary"),
    (2, 9, 9, 5, 6, 3, 2, "SAME", 7, "mixed", "wide"),
    (2, 9, 9, 8, 6, 3, 1, "SAME", 255, "sorted", "wide"),
    (2, 8, 8, 16, 24, 3, 1, "SAME", 1000, "sorted", "u8"),
    (2, 8, 8, 16, 24, 3, 1, "SAME", 1024, "sorted", "u8"),
    (1, 6, 7, 8, 33, 3, 1, "SAME", 6000, "mixed", "u8")]


# K3 checks (M, dims, steps, bank kind, code range), each under the
# default plan and pinned clusters / row tiles that fit: M of 1, 2, 15, 16,
# 17, 64 and 1000; widths of 1, 8, 10, 12 and 500 in one chain; an 8-stage
# chain; slices that do not fit a CTA (the weights stream through shared
# memory); S of 1, 7, 255, 256 and 1000; sorted, unsorted and tied banks;
# input codes of every flavour (s8, u8, binary, and wider than a byte:
# the byte split, with K_0 small enough that the sums fit int32)
K3_BRANCH_CASES = (
    [(m, [490, 256, 256, 256], [7, 7, 7], "sorted", "s8")
     for m in (1, 2, 15, 16, 17, 64, 1000)]
    + [(17, [33, 1, 8, 10, 12, 500, 3], [7, 1, 255, 7, 1, 7], "sorted",
        "u8"),
       (300, [40, 24, 16, 8, 9, 30, 20, 12, 10], [3] * 8, "ties", "u8"),
       (64, [256, 1536, 1536, 256], [1, 1, 1], "sorted", "binary"),
       (130, [64, 72, 40, 24, 16], [1, 7, 255, 256], "unsorted", "s8"),
       (33, [72, 40, 24, 9], [1000, 255, 7], "mixed", "u8"),
       (257, [130, 72, 8, 72], [255, 255, 1000], "sorted", "wide"),
       (1000, [128, 72, 72, 8, 72, 72], [255] * 5, "unsorted", "s8"),
       (1, [128, 72, 72, 8, 72, 72], [255] * 5, "ties", "binary")])


def _chain_of_kind(rng, m, dims, steps, kind, codes):
    """Seeded codes (M, dims[0]) of one of ``kernel_bench.CODE_RANGES`` on
    the card, int8 weights, and per-stage step-major (S, N) banks of one of
    ``kernel_bench.MT_BANK_KINDS`` drawn from each stage's accumulators."""
    import numpy as np
    import torch
    from repro_torch.bench.kernel_bench import bank_of_kind

    h = _codes(rng, (m, dims[0]), codes).astype(np.int64)
    x = torch.as_tensor(h.astype(np.int32)).cuda()
    ws, bs = [], []
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        acc = h @ w.astype(np.int64)
        t = bank_of_kind(rng, acc, n, s, kind)
        h = (acc[:, :, None] >= t[None]).sum(-1)
        ws.append(torch.as_tensor(w).cuda())
        bs.append(torch.as_tensor(t.T.copy()).cuda())
    return x, ws, bs


def _codes(rng, shape, codes):
    """Seeded int32 codes of one of ``kernel_bench.CODE_RANGES``."""
    from repro_torch.bench.kernel_bench import CODE_RANGES

    lo, hi = CODE_RANGES[codes]
    return rng.integers(lo, hi, shape).astype("int32")


def phase_kernels_synthetic():
    """Each kernel against its plain version at ragged shapes and the bank
    depths the models use; returns the largest |kernel - plain| per kernel."""
    import numpy as np
    import torch
    from repro_torch.bench.kernel_bench import bank_of_kind
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.conv_threshold import direct_conv_acc, pad_input

    g = torch.Generator().manual_seed(SEED)
    worst = dict.fromkeys(REPLACES, 0)
    for m, k, n, s, lo, hi in [(1, 1, 1, 1, -127, 128),
                               (37, 19, 70, 1, -127, 128),
                               (130, 65, 129, 7, 0, 8),
                               (257, 300, 100, 255, 0, 256),
                               (1000, 33, 3, 255, -127, 128)]:
        x = torch.randint(lo, hi, (m, k), generator=g, dtype=torch.int32)
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        acc = ref.int_matmul(x, w)
        t = torch.sort(torch.randint(int(acc.min()), int(acc.max()) + 1,
                                     (n, s), generator=g, dtype=torch.int32),
                       dim=1).values
        x, w, t = x.cuda(), w.cuda(), t.cuda()
        got = ops.threshold_matmul(x, w, t)
        want = ref.threshold_matmul_ref(x, w, t)
        err = int((got - want).abs().max())
        worst["threshold_matmul"] = max(worst["threshold_matmul"], err)
        check(err == 0, f"threshold_matmul {m}x{k}x{n} S={s}: max err {err}")
        log(f"kernel-check threshold_matmul M={m} K={k} N={n} S={s}: exact")
    for nb, h, wd, c, f, kk, st, pad, s in [
            (3, 11, 9, 1, 5, 5, 2, "SAME", 7),
            (2, 13, 13, 3, 6, 5, 2, "VALID", 255),
            (2, 7, 9, 5, 3, 3, 1, "SAME", 1),
            (1, 5, 5, 1, 2, 1, 1, "SAME", 3),
            # wide outputs: row blocks of 2 and 3 rows, the last one partial
            (2, 9, 120, 3, 4, 3, 1, "SAME", 7),
            (1, 11, 150, 2, 3, 4, 2, "VALID", 255)]:
        x = torch.randint(0, 256, (nb, h, wd, c), generator=g,
                          dtype=torch.int32).cuda()
        oh = -(-h // st) if pad == "SAME" else (h - kk) // st + 1
        ow = -(-wd // st) if pad == "SAME" else (wd - kk) // st + 1
        w = torch.randint(-127, 128, (kk * kk * c, f), generator=g,
                          dtype=torch.int8).cuda()
        t = torch.sort(torch.randint(-30000, 30000, (f, s), generator=g,
                                     dtype=torch.int32), dim=1).values.cuda()
        kw = dict(kernel=kk, stride=st, padding=pad, out_h=oh, out_w=ow)
        got = ops.conv_threshold(x, w, t, **kw)
        want = _conv_plain(x, w, t, **kw)
        err = int((got - want).abs().max())
        worst["conv_threshold"] = max(worst["conv_threshold"], err)
        check(err == 0, f"conv_threshold K={kk} s={st} {pad} C={c}: err {err}")
        log(f"kernel-check conv_threshold N={nb} {h}x{wd}x{c} F={f} K={kk} "
            f"stride={st} {pad} S={s}: exact")
    rng = np.random.default_rng(SEED + 10)
    for m, k, n, s, kind, codes in K1_BRANCH_CASES:
        x = _codes(rng, (m, k), codes)
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        t = bank_of_kind(rng, x.astype(np.int64) @ w, n, s, kind)
        x, w, t = (torch.as_tensor(a).cuda() for a in (x, w, t))
        want = ref.threshold_matmul_ref(x, w, t)
        for bm, bn in ((32, 32), tuple(ops.TMM_DEFAULT_TILE), (128, 128)):
            got = ops.threshold_matmul(x, w, t, block_m=bm, block_n=bn)
            err = int((got - want).abs().max())
            worst["threshold_matmul"] = max(worst["threshold_matmul"], err)
            check(err == 0, f"threshold_matmul M={m} K={k} N={n} S={s} "
                            f"{kind} bank, {codes} codes, tile {bm}x{bn}: "
                            f"max err {err}")
        plan = ops.threshold_matmul_plan(*ops.TMM_DEFAULT_TILE, s)
        log(f"kernel-check threshold_matmul M={m} K={k} N={n} S={s} {kind} "
            f"bank, {codes} codes ({'search' if plan['search'] else 'linear'}"
            f" at the default tile): exact under 3 tiles")
    # k tiles of one row block voting s8, u8, the byte split, then s8
    x = np.concatenate([rng.integers(-128, 128, (40, 64)),
                        rng.integers(0, 256, (40, 64)),
                        rng.integers(-5000, 5001, (40, 64)),
                        rng.integers(-128, 0, (40, 50))], axis=1)
    w = rng.integers(-127, 128, (x.shape[1], 24)).astype(np.int8)
    t = bank_of_kind(rng, x @ w, 24, 255, "sorted")
    x, w, t = (torch.as_tensor(a).cuda() for a in (x.astype(np.int32), w, t))
    err = int((ops.threshold_matmul(x, w, t)
               - ref.threshold_matmul_ref(x, w, t)).abs().max())
    check(err == 0, f"threshold_matmul with mixed k-tile flavours: err {err}")
    log("kernel-check threshold_matmul k tiles s8 / u8 / split / s8: exact")
    for nb, h, wd, c, f, kk, st, pad, s, kind, codes in K2_BRANCH_CASES:
        x = torch.as_tensor(_codes(rng, (nb, h, wd, c), codes)).cuda()
        w = torch.as_tensor(rng.integers(-127, 128, (kk * kk * c, f)).astype(
            np.int8)).cuda()
        oh = -(-h // st) if pad == "SAME" else (h - kk) // st + 1
        ow = -(-wd // st) if pad == "SAME" else (wd - kk) // st + 1
        kw = dict(kernel=kk, stride=st, padding=pad, out_h=oh, out_w=ow)
        acc = direct_conv_acc(pad_input(x, **kw), w, kernel=kk, stride=st,
                              out_h=oh, out_w=ow)
        t = torch.as_tensor(bank_of_kind(rng, acc.cpu().numpy(), f, s,
                                         kind)).cuda()
        want = _conv_plain(x, w, t, **kw)
        for bh in (None, 1, 3):
            got = ops.conv_threshold(x, w, t, block_h=bh, **kw)
            err = int((got - want).abs().max())
            worst["conv_threshold"] = max(worst["conv_threshold"], err)
            check(err == 0, f"conv_threshold N={nb} {h}x{wd}x{c} F={f} "
                            f"K={kk} s={st} {pad} S={s} {kind} bank, {codes} "
                            f"codes, block_h {bh}: err {err}")
        xp = pad_input(x, **kw)
        plan = ops.conv_threshold_plan(c, f, kk, st, xp.shape[2], oh, ow,
                                       ops.conv_block_rows(oh, ow, c, kk), s,
                                       samples=nb)
        log(f"kernel-check conv_threshold N={nb} {h}x{wd}x{c} F={f} K={kk} "
            f"stride={st} {pad} S={s} {kind} bank, {codes} codes "
            f"({'search' if plan['search'] else 'linear'}, pixel stride "
            f"{plan['pixel_stride']} B, k chunk {plan['k_chunk']}, "
            f"{plan['samples_per_block']} samples a block): exact "
            f"under 3 row blocks")
    for m, dims, steps, lo, hi in [
            (1, [1, 1], [1], -127, 128),
            (37, [19, 70, 9], [7, 255], -127, 128),
            (1000, [490, 256, 256, 256], [7, 7, 7], -127, 128),
            (1023, [128, 72, 72, 8, 72, 72], [255] * 5, -127, 128),
            (333, [33, 5, 11, 512, 3], [1, 7, 255, 7], 0, 256),
            (129, [512, 512, 512, 500], [1, 7, 1], 0, 2)]:
        x, ws, bs = _random_chain(g, m, dims, steps, lo, hi)
        x, ws = x.cuda(), [w.cuda() for w in ws]
        bs = [b.t().contiguous().cuda() for b in bs]
        got = ops.mlp_megakernel(x, ws, bs)
        want = ref.mlp_megakernel_ref(x, ws, bs)
        err = int((got - want).abs().max())
        worst["mlp_megakernel"] = max(worst["mlp_megakernel"], err)
        check(err == 0, f"mlp_megakernel M={m} dims={dims}: max err {err}")
        log(f"kernel-check mlp_megakernel M={m} dims={dims} S={steps}: "
            f"exact (nonzero share {float((want > 0).float().mean()):.3f})")
    for m, dims, steps, kind, codes in K3_BRANCH_CASES:
        x, ws, bs = _chain_of_kind(rng, m, dims, steps, kind, codes)
        want = ref.mlp_megakernel_ref(x, ws, bs)
        packed = [ops.megakernel_pack_weights(w) for w in ws]
        plans = []
        for pin in ((None, None), (8, 8), (2, 16), (1, 64)):
            plan = ops.megakernel_plan(tuple(dims), tuple(steps), m, *pin)
            if not plan["fits"] or plan in plans:
                continue
            plans.append(plan)
            got = ops.mlp_megakernel(x, packed, bs, cluster=plan["cluster"],
                                     block_m=plan["block_m"])
            err = int((got - want).abs().max())
            worst["mlp_megakernel"] = max(worst["mlp_megakernel"], err)
            check(err == 0, f"mlp_megakernel M={m} dims={dims} S={steps} "
                            f"{kind} banks, {codes} codes, cluster "
                            f"{plan['cluster']} x {plan['block_m']} rows: "
                            f"max err {err}")
        log(f"kernel-check mlp_megakernel M={m} dims={dims} S={steps} "
            f"{kind} banks, {codes} codes: exact under "
            + ", ".join(f"{p['cluster']} CTAs x {p['block_m']} rows "
                        f"({'resident' if p['weights_resident'] else 'streamed'}"
                        f" weights, {'resident' if p['banks_resident'] else 'global'}"
                        f" banks)" for p in plans))
    return worst


def _conv_plain(x, w, t, *, kernel, stride, padding, out_h, out_w):
    from repro_torch.kernels import ref
    from repro_torch.kernels.conv_threshold import pad_input

    xp = pad_input(x, kernel=kernel, stride=stride, padding=padding,
                   out_h=out_h, out_w=out_w)
    return ref.conv_threshold_ref(xp, w, t, kernel=kernel, stride=stride,
                                  out_h=out_h, out_w=out_w)


def phase_main_path(models):
    """Counters to 0, one ``offline`` call of each of the four models in
    each dispatch mode on the card, counters read; then ``predict``,
    outside the counted run. Returns ({(name, mode): (model, logits,
    pred)}, launches, launches per "name/mode")."""
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.kernels import ops

    compiled = {(n, mode): compile_graph(g, in_scale=s, device="cuda",
                                         conv_lowering="direct",
                                         megakernel=mk)
                for n, g, s, _ in models for mode, mk in MODES}
    xs = {n: torch.as_tensor(x).cuda() for n, _, _, x in models}
    torch.cuda.synchronize()
    per_run, logits = {}, {}
    ops.reset_launches()
    for (n, mode), cm in compiled.items():
        before = dict(ops.launches)
        logits[(n, mode)] = cm.offline(xs[n])
        per_run[f"{n}/{mode}"] = {k: ops.launches[k] - before[k]
                                  for k in before}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    results = {key: (cm, logits[key], cm.predict(xs[key[0]]))
               for key, cm in compiled.items()}
    log(f"main-path launches per offline call: {json.dumps(per_run)}")
    log(f"main-path launches (one offline call of each of the 4 models in "
        f"each of the 2 modes): {json.dumps(launches)}")
    for run, want in MAIN_PATH_LAUNCHES.items():
        for kname, k in zip(TINY_KERNELS, want):
            got = per_run[run][kname]
            check(got == k, f"{run} offline launched {kname} {got} times, "
                            f"expected {k}")
    for run, counts in per_run.items():
        check(counts[HEAD_KERNEL] == 1, f"{run} offline launched "
                                        f"{HEAD_KERNEL} {counts[HEAD_KERNEL]}"
                                        f" times, expected 1")
    for name in TINY_KERNELS + (HEAD_KERNEL,):
        check(launches[name] > 0, f"{name} was never launched on the main "
                                  f"path")
    for name in LM_KERNELS:
        check(launches[name] == 0, f"{name} launched on the integer path")
    log("main-path schedules end in: " + ", ".join(
        f"{n}/{mode} {type(cm.schedule.stages[-1]).__name__}"
        for (n, mode), cm in compiled.items()))
    return results, launches, per_run


def _plans(cm):
    """The megakernel runs the planner admits for ``cm``'s segments."""
    from repro_torch.deploy import plan_megakernel

    plans = [plan_megakernel(cm.schedule.stages, seg) for seg in cm.segments]
    return [p for p in plans if p is not None]


def phase_main_path_checks(models, results):
    """Both modes' outputs on the card equal the port on the CPU; every
    fused stage's kernel and every planned K3 run equals its plain version
    on its main-path input, the float head within 1e-5 and equal to both
    modes' logits. Returns (per-stage timing cases, each with the number
    of its launches in the counted run; the worst |kernel - plain| per
    kernel; each model's share of nonzero codes per stage)."""
    import numpy as np
    import torch
    from repro_torch.deploy import (FloatHeadStage, FusedConvThresholdStage,
                                    FusedThresholdStage, compile_graph)

    cases, worst, nonzero = [], dict.fromkeys(REPLACES, 0), {}
    for n, g, s, x in models:
        cm, logits, pred = results[(n, "staged")]
        auto, a_logits, a_pred = results[(n, "auto")]
        rows = CPU_CHECK_ROWS.get(n, len(x))
        cpu = compile_graph(g, in_scale=s, device="cpu",
                            conv_lowering="direct")
        want = cpu.stage_outputs(x[:rows])
        got = cm.stage_outputs(torch.as_tensor(x).cuda())
        for prog in cm._stage_programs.values():   # 1024-row graphs: the
            prog.clear()                           # LM phases need memory
        for i, (a, b) in enumerate(zip(got, want)):
            a = a[:rows].cpu()
            if b.dtype.is_floating_point:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            else:
                check(torch.equal(a, b), f"{n} stage {i}: CUDA != CPU")
        for mode, lg, pr in (("staged", logits, pred),
                             ("auto", a_logits, a_pred)):
            torch.testing.assert_close(lg[:rows].cpu(), want[-1], rtol=1e-5,
                                       atol=1e-5)
            check(torch.equal(pr[:rows].cpu(),
                              torch.argmax(want[-1], dim=-1)),
                  f"{n}[{mode}]: predict on CUDA != argmax on CPU")
        codes = [o for o in want[:-1] if not o.dtype.is_floating_point]
        nz = [float((c > 0).float().mean()) for c in codes]
        check(min(nz) > 0, f"{n}: a stage's codes are all 0 ({nz})")
        nonzero[n] = [round(v, 4) for v in nz]
        log(f"main-path {n}: {len(got)} stages equal the CPU port on "
            f"{rows} of {len(x)} rows (ints exact, logits within 1e-5 in "
            f"both modes; nonzero code share per stage "
            f"{[round(v, 3) for v in nz]}); predict == CPU argmax")
        plans = _plans(auto)
        for p in plans:
            run = auto.schedule.stages[p.start:p.stop]
            xi = (torch.as_tensor(x).cuda() if p.start == 0
                  else got[p.start - 1])
            xi = xi.to(torch.int32).contiguous()
            cases.append(mega_case(n, f"{run[0].name}..{run[-1].name}", xi,
                                   [st.stage.w_int for st in run],
                                   [st.stage.thresholds for st in run]))
            cases[-1]["launches"] = 1
            k_out, p_out = cases[-1]["run"](), cases[-1]["plain"]()
            err = int((k_out - p_out).abs().max())
            worst["mlp_megakernel"] = max(worst["mlp_megakernel"], err)
            check(err == 0 and torch.equal(k_out, got[p.stop - 1])
                  and torch.equal(k_out[:rows].cpu(), want[p.stop - 1]),
                  f"{n} {cases[-1]['stage']}: megakernel != plain / staged "
                  f"/ CPU (max err {err})")
            log(f"kernel-check mlp_megakernel {n}/{cases[-1]['stage']} "
                f"{cases[-1]['shape']}: exact, equals the CPU stages")
        head = cm.schedule.stages[-1]
        if isinstance(head, FloatHeadStage):
            xi = got[-2].to(torch.int32).contiguous()
            cases.append(head_case(n, head.name, xi, head.w, head.b,
                                   head.in_scale))
            cases[-1]["launches"] = 2          # once in each mode
            k_out, p_out = cases[-1]["run"](), cases[-1]["plain"]()
            err = float((k_out - p_out).abs().max())
            worst[HEAD_KERNEL] = max(worst[HEAD_KERNEL], err)
            torch.testing.assert_close(k_out, p_out, rtol=1e-5, atol=1e-5)
            check(torch.equal(k_out, got[-1]) and torch.equal(k_out, logits)
                  and torch.equal(k_out, a_logits),
                  f"{n} head: the kernel's logits differ from the staged / "
                  f"auto offline logits")
            log(f"kernel-check float_head {n}/{head.name} "
                f"{cases[-1]['shape']}: within 1e-5 of plain (max err "
                f"{err:.3g}), equal to both modes' offline logits")
        h = torch.as_tensor(x).cuda()
        for i, (st, out) in enumerate(zip(cm.schedule.stages, got)):
            if isinstance(st, FusedThresholdStage):
                xi = h.to(torch.int32).contiguous()
                cases.append(tmm_case(n, st.name, xi, st.stage.w_int,
                                      st.stage.thresholds))
            elif isinstance(st, FusedConvThresholdStage):
                gm = st.geom
                xi = h.reshape(-1, gm.in_h, gm.in_w, gm.in_ch).to(
                    torch.int32).contiguous()
                kw = dict(kernel=gm.kernel, stride=gm.stride,
                          padding=gm.padding, out_h=gm.out_h, out_w=gm.out_w)
                cases.append(conv_case(n, st.name, xi, st.stage.w_int,
                                       st.stage.thresholds, kw))
            else:
                h = out
                continue
            # once in the staged run; once more in the auto run unless a
            # planned megakernel covers the stage there
            cases[-1]["launches"] = 1 + all(not p.start <= i < p.stop
                                            for p in plans)
            k_out, p_out = cases[-1]["run"](), cases[-1]["plain"]()
            err = int((k_out - p_out).abs().max())
            kname = cases[-1]["kernel"]
            worst[kname] = max(worst[kname], err)
            check(err == 0 and torch.equal(k_out.reshape(out.shape), out),
                  f"{n} {st.name}: kernel != plain (max err {err})")
            log(f"kernel-check {cases[-1]['kernel']} {n}/{st.name} "
                f"{cases[-1]['shape']}: exact")
            h = out
    return cases, worst, nonzero


def _mm_library(x, w):
    """One fp32 ``torch.matmul`` of the accumulator alone (no threshold
    count): a partial yardstick, since no single library call computes the
    fused stage."""
    import torch

    xf, wf = x.to(torch.float32), w.to(torch.float32)
    return lambda: torch.matmul(xf, wf)


def _conv_library(x, w, *, kernel, stride, padding, out_h, out_w):
    """One fp32 cuDNN convolution of the accumulator alone (no threshold
    count, TF32 off, input pre-padded): a partial yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv_threshold import pad_input

    xf = pad_input(x.to(torch.float32), kernel=kernel, stride=stride,
                   padding=padding, out_h=out_h, out_w=out_w)
    xf = xf.permute(0, 3, 1, 2).contiguous()
    wf = w.to(torch.float32).reshape(kernel, kernel, x.shape[3],
                                     w.shape[1]).permute(3, 2, 0, 1)
    wf = wf.contiguous()
    torch.backends.cudnn.allow_tf32 = False
    return lambda: F.conv2d(xf, wf, stride=stride)


def phase_goldens():
    import numpy as np
    import torch
    from repro_torch.core.qir import Graph
    from repro_torch.deploy import compile_graph

    for name in ("kws", "ad", "ic", "cnv"):
        g = Graph.load(os.path.join(GOLDEN, f"{name}.qir.json"))
        data = np.load(os.path.join(GOLDEN, f"{name}.golden.npz"))
        want = [data[k] for k in sorted(data.files) if k.startswith("stage_")]
        for lowering in ("direct", "im2col"):
            cm = compile_graph(g, in_scale=g.meta["in_scale"], device="cuda",
                               conv_lowering=lowering)
            outs = cm.stage_outputs(data["x"])
            check(len(outs) == len(want), f"golden {name}: stage count")
            for i, (a, b) in enumerate(zip(outs, want)):
                a = a.cpu().numpy()
                if np.issubdtype(b.dtype, np.integer):
                    check(np.array_equal(a, b),
                          f"golden {name}[{lowering}] stage {i} differs")
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            log(f"golden {name}[{lowering}]: {len(outs)} stages equal "
                f"the .golden.npz")


def phase_streaming(models, results):
    """``streaming_host``, ``streaming_compiled`` and a partly filled
    ``submit_wave`` of every model in both modes on the card, against
    ``offline`` of the same model: the logits within 1e-5, and — through
    the same schedule without its float head — the integer codes bit for
    bit. Returns {"name/mode": whether the logits were bit for bit too}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.deploy import CompiledTinyModel
    from repro_torch.kernels import ops

    valid = np.arange(11) % 3 != 1           # 11 rows of a 16-row wave
    out = {}
    for n, _, _, x in models:
        xc = torch.as_tensor(x).cuda()
        for mode, mk in MODES:
            cm = results[(n, mode)][0]
            headless = CompiledTinyModel(
                dataclasses.replace(cm.schedule,
                                    stages=cm.schedule.stages[:-1]),
                device="cuda", megakernel=mk)
            flags = {}
            for model, kind in ((cm, "logits"), (headless, "codes")):
                y_off = model.offline(xc)
                y_host, _ = model.streaming_host(xc)
                ops.reset_launches()
                y_cmp, st = model.streaming_compiled(xc)
                torch.cuda.synchronize()
                k3 = ops.launches["mlp_megakernel"]
                want_k3 = int(mode == "auto" and n != "ic")
                check(k3 == want_k3, f"{n}[{mode}] streaming_compiled "
                                     f"({kind}) launched mlp_megakernel {k3} "
                                     f"times, expected {want_k3}")
                y_w, mask = model.submit_wave(x[:11], valid=valid)
                y_w = y_w[torch.as_tensor(mask).cuda()]
                y_v = y_off[:11][torch.as_tensor(valid).cuda()]
                for label, got, want in (("streaming_host", y_host, y_off),
                                         ("streaming_compiled", y_cmp, y_off),
                                         ("submit_wave", y_w, y_v)):
                    check(got.shape == want.shape, f"{n}[{mode}] {label} "
                          f"({kind}): shape {tuple(got.shape)}")
                    same = bool(torch.equal(got, want))
                    if kind == "codes":
                        check(same, f"{n}[{mode}] {label}: codes differ "
                                    f"from offline")
                    else:
                        torch.testing.assert_close(got, want, rtol=1e-5,
                                                   atol=1e-5)
                        flags[label] = same
            out[f"{n}/{mode}"] = flags
            log(f"streaming {n}[{mode}]: {st.n_micro} micro-batches of "
                f"{st.micro_batch}, megakernel runs {st.megakernel}; "
                f"host/compiled/wave codes equal offline bit for bit, logits "
                f"within 1e-5 (bit for bit: {flags})")
    return out


def time_case(c, reps=7, inner=20):
    """Kernel, plain-version and library times of one case, with its bound;
    the plain version gets 3 x 3 calls."""
    row = {k: c[k] for k in ("kernel", "model", "stage", "shape", "bytes",
                             "ops")}
    row["launches"] = c.get("launches", 0)
    row["ms"] = time_ms(c["run"], reps=reps, inner=inner)
    row["plain_ms"] = time_ms(c["plain"], reps=3, inner=3)
    row["library_ms"] = time_ms(c["library"], reps=reps, inner=inner)
    peak = c.get("peak", PEAK_OPS_PER_S[c["kernel"]])
    row["bound_ms"] = bound_ms(c["bytes"], c["ops"], peak)
    row["bound_by"] = bound_by(c["bytes"], c["ops"], peak)
    staged = ""
    if "staged" in c:
        row["staged_k1_ms"] = time_ms(c["staged"], reps=reps, inner=inner)
        staged = f", staged K1 {row['staged_k1_ms']:.6f} ms"
    if "plan" in c:
        row["cluster"] = c["plan"]["cluster"]
        row["block_m"] = c["plan"]["block_m"]
        staged += (f", {row['cluster']} CTAs a cluster x {row['block_m']} "
                   f"rows")
    log(f"time {row['kernel']} {row['model']}/{row['stage']} "
        f"{row['shape']}: kernel {row['ms']:.6f} ms, plain "
        f"{row['plain_ms']:.6f} ms, {c.get('library_is', 'library (partial)')} "
        f"{row['library_ms']:.6f} ms{staged}, bound {row['bound_ms']:.6f} "
        f"ms ({row['bound_by']})")
    return row


def phase_times(cases, results, models):
    import torch
    from repro_torch.obs import timer

    rows = [time_case(c) for c in cases]
    rows += mega_batch1_rows(rows, cases)
    e2e = {}
    for n, _, _, x in models:
        xc = torch.as_tensor(x).cuda()
        for mode, _ in MODES:
            cm = results[(n, mode)][0]
            cm.offline(xc)
            torch.cuda.synchronize()
            samples = []
            for _ in range(21):
                t0 = timer.now()
                cm.offline(xc)
                torch.cuda.synchronize()
                samples.append((timer.now() - t0) * 1e3)
            e2e[f"{n}/{mode}"] = statistics.median(samples)
            log(f"e2e offline {n}[{mode}]: {e2e[f'{n}/{mode}']:.6f} ms per "
                f"{x.shape[0]}-row batch (host clock, median of 21, "
                f"synchronised)")
    return rows, e2e


# The conv stages of the paper's IC (hls4ml v0.7: 32x32x3 input, SAME,
# 8-bit, S = 255) and CNV-W1A1 (32x32x3 input, 3x3 VALID, 64..256 channels,
# binary, S = 1; 2x2 pools after conv1 and conv3) and CNV's two 512-wide
# binary FC stages, from ``repro.models.tiny.ICModel`` / ``CNVModel``
# defaults: (model, stage, H, W, C, F, kernel, stride, padding, S).
FULL_WIDTH_CONVS = [
    ("ic", "conv0", 32, 32, 3, 32, 1, 1, "SAME", 255),
    ("ic", "conv1", 32, 32, 32, 4, 4, 1, "SAME", 255),
    ("ic", "conv2", 32, 32, 4, 32, 4, 1, "SAME", 255),
    ("ic", "conv3", 32, 32, 32, 32, 4, 4, "SAME", 255),
    ("ic", "conv4", 8, 8, 32, 4, 4, 1, "SAME", 255),
    ("cnv", "conv0", 32, 32, 3, 64, 3, 1, "VALID", 1),
    ("cnv", "conv1", 30, 30, 64, 64, 3, 1, "VALID", 1),
    ("cnv", "conv2", 14, 14, 64, 128, 3, 1, "VALID", 1),
    ("cnv", "conv3", 12, 12, 128, 128, 3, 1, "VALID", 1),
    ("cnv", "conv4", 5, 5, 128, 256, 3, 1, "VALID", 1),
    ("cnv", "conv5", 3, 3, 256, 256, 3, 1, "VALID", 1),
]
FULL_WIDTH_DENSE = [("cnv", "fc0", 256, 512, 1), ("cnv", "fc1", 512, 512, 1)]


def _banks(acc, n_ch, s, g):
    """(n_ch, s) sorted banks drawn from the accumulator's own values, so
    the counts spread over [0, s]."""
    import torch

    flat = acc.reshape(-1)
    idx = torch.randint(0, flat.numel(), (n_ch * s,), generator=g)
    return torch.sort(flat[idx.to(flat.device)].reshape(n_ch, s),
                      dim=1).values


def phase_full_width():
    """The kernels at the paper's full IC / CNV widths on a 1024-sample
    batch of seeded codes and banks spread over the accumulators' range
    (phase 3 drives the same shapes through the exported graphs): each
    held exactly against its plain version, then timed. Returns (rows,
    worst |kernel - plain| per kernel)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.conv_threshold import direct_conv_acc, pad_input

    g = torch.Generator().manual_seed(SEED + 3)
    cases, worst, nonzero = [], dict.fromkeys(REPLACES, 0), {}
    for model, stage, h, wd, c, f, k, st, pad, s in FULL_WIDTH_CONVS:
        first = stage == "conv0"
        lo, hi = ((-127, 128) if model == "ic" else (0, 256)) if first \
            else ((0, 256) if model == "ic" else (0, 2))
        wlo, whi = (-127, 128) if model == "ic" or first else (-2, 3)
        x = torch.randint(lo, hi, (BATCH, h, wd, c), generator=g,
                          dtype=torch.int32).cuda()
        w = torch.randint(wlo, whi, (k * k * c, f), generator=g,
                          dtype=torch.int8).cuda()
        oh = -(-h // st) if pad == "SAME" else (h - k) // st + 1
        ow = -(-wd // st) if pad == "SAME" else (wd - k) // st + 1
        kw = dict(kernel=k, stride=st, padding=pad, out_h=oh, out_w=ow)
        acc = direct_conv_acc(pad_input(x, **kw), w, kernel=k, stride=st,
                              out_h=oh, out_w=ow)
        t = _banks(acc, f, s, g)
        del acc
        cases.append(conv_case(model, stage, x, w, t, kw))
    for model, stage, k, n, s in FULL_WIDTH_DENSE:
        x = torch.randint(0, 2, (BATCH, k), generator=g,
                          dtype=torch.int32).cuda()
        w = torch.randint(-2, 3, (k, n), generator=g, dtype=torch.int8).cuda()
        t = _banks(ref.int_matmul(x, w), n, s, g)
        cases.append(tmm_case(model, stage, x, w, t))
    x, ws, bs = _random_chain(g, BATCH, [256, 512, 512], [1, 1], 0, 2)
    cases.append(mega_case("cnv", "fc0..fc1", x.cuda(),
                           [w.cuda() for w in ws], [b.cuda() for b in bs]))
    rows = []
    for c in cases:
        err = int((c["run"]() - c["plain"]()).abs().max())
        worst[c["kernel"]] = max(worst[c["kernel"]], err)
        check(err == 0, f"full-width {c['kernel']} {c['model']}/"
                        f"{c['stage']}: kernel != plain (max err {err})")
        log(f"kernel-check full-width {c['kernel']} {c['model']}/"
            f"{c['stage']} {c['shape']}: exact")
        rows.append(time_case(c, reps=5, inner=5))
        torch.cuda.empty_cache()
    rows += mega_batch1_rows(rows, cases)
    return rows, worst


# ---------------------------------------------------------------------------
# the LM path: K6 and the llama3-8b inference entry points
# ---------------------------------------------------------------------------

# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset, kv_len): GQA 32/8 and 4/2,
# head dims 16 (reduced configs), 80 (h2o-danube) and 128 (llama3); causal,
# not causal, window 32, a decode chunk (q_offset > 0, Sq < Sk), ragged
# Sq/Sk, kv_len below Sk, and the main path's shape; then the bf16
# kernel's tile edges (128 query rows, 128 keys): Sq and Sk of 127, 129
# and 255, and windows that cross a 128-key tile
FLASH_CASES = [
    (1, 32, 8, 4096, 4096, 128, True, 0, 0, None),
    (2, 32, 8, 300, 300, 128, True, 0, 0, None),
    (2, 4, 2, 130, 130, 16, False, 0, 0, None),
    (1, 4, 2, 257, 257, 80, True, 32, 0, None),
    (3, 4, 2, 100, 100, 16, True, 32, 0, None),
    (2, 4, 2, 17, 95, 128, True, 0, 78, None),
    (1, 32, 8, 1, 513, 128, True, 0, 512, None),
    (1, 32, 8, 70, 133, 80, False, 0, 0, 101),
    (2, 4, 2, 65, 200, 16, True, 32, 120, 150),
    (1, 4, 2, 127, 127, 128, True, 0, 0, None),
    (2, 4, 2, 129, 129, 80, True, 0, 0, None),
    (1, 4, 2, 255, 255, 16, False, 0, 0, None),
    (1, 8, 2, 127, 255, 128, True, 0, 128, None),
    (1, 4, 2, 255, 129, 80, False, 0, 0, 127),
    (1, 4, 2, 255, 255, 128, True, 100, 0, None),
    (2, 4, 4, 129, 255, 128, False, 70, 100, 200),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def flash_live_pairs(sq, sk, causal, window, q_offset, kv_len):
    """Unmasked (query, key) pairs of one head: what K6 must compute."""
    import numpy as np

    kv_len = sk if kv_len is None else kv_len
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, kv_len) if causal else np.full(sq, kv_len)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_case(label, q, k, v, kw, model=LM_CONFIG):
    """A timing case for ``flash_attention`` on (q, k, v), (B, H, S, D)
    views; the yardstick is one ``scaled_dot_product_attention`` call on
    the same tensors (GQA through ``enable_gqa``), causal or not as the
    case is. Its bound takes the peak of q's type: float32 runs outside
    the tensor cores."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = flash_live_pairs(sq, sk, kw["causal"], kw["window"],
                             kw["q_offset"], kw.get("kv_len"))
    esize = q.element_size()
    check(kw["window"] == 0 and kw["q_offset"] == 0 and sq == sk
          and kw.get("kv_len") in (None, sk),
          "the SDPA yardstick takes the main paths' plain masks only")
    causal = kw["causal"]
    return {"kernel": "flash_attention", "model": model, "stage": label,
            "shape": f"B={b} H={h} Hkv={k.shape[1]} Sq={sq} Sk={sk} D={d} "
                     f"{str(q.dtype).replace('torch.', '')} "
                     f"{'causal' if causal else 'not causal'}",
            "run": lambda: ops.flash_attention(q, k, v, **kw),
            "plain": lambda: ref.flash_attention_ref(q, k, v, **kw),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True),
            "library_is": "library (SDPA)",
            "bytes": (q.numel() * 2 + k.numel() + v.numel()) * esize,
            "ops": k6_ops(b, h, d, pairs),
            "peak": (FP32_OPS_PER_S if q.dtype == torch.float32
                     else BF16_OPS_PER_S)}


def phase_flash_synthetic():
    """K6 against its plain version at ``FLASH_CASES`` in both dtypes, on
    strided (B, S, H, D) views as the model passes them and on contiguous
    (B, H, S, D) tensors. Returns the worst |kernel - plain| per dtype."""
    import torch
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = dict.fromkeys(FLASH_TOL, 0.0)
    for b, h, hkv, sq, sk, d, causal, window, q_off, kv_len in FLASH_CASES:
        kw = dict(causal=causal, window=window, q_offset=q_off,
                  kv_len=kv_len)
        for dtype, tol in FLASH_TOL.items():
            dt = getattr(torch, dtype)
            q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dt)
            k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
            v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
            views = [t.transpose(1, 2) for t in (q, k, v)]
            want = ref.flash_attention_ref(*views, **kw).float()
            for layout, args in (("strided", views),
                                 ("contiguous",
                                  [t.contiguous() for t in views])):
                got = ops.flash_attention(*args, **kw)
                torch.cuda.synchronize()
                check(got.dtype == dt and got.shape == want.shape,
                      f"flash_attention {dtype} {layout}: {got.dtype} "
                      f"{tuple(got.shape)}")
                err = float((got.float() - want).abs().max())
                worst[dtype] = max(worst[dtype], err)
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=tol)
            log(f"kernel-check flash_attention B={b} H={h}/{hkv} Sq={sq} "
                f"Sk={sk} D={d} causal={causal} window={window} "
                f"q_offset={q_off} kv_len={kv_len} {dtype}: max err "
                f"{err:.3g} (strided and contiguous, tol {tol})")
            del q, k, v, views, want, got
    torch.cuda.empty_cache()
    return worst


def _busy_us(spans):
    """(the union's length, the whole span) of sorted (start, end)
    intervals, in their unit."""
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s, spans[-1][1] - spans[0][0]


def _device_breakdown(fn):
    """Device time of one call of ``fn`` by kernel family, from a
    ``torch.profiler`` trace: K6, K5, matmuls (cuBLAS), everything else; the
    busy time is the union of the kernels' intervals and the idle share is
    the rest of the span from the first kernel's start to the last one's
    end; the 8 costliest kernels and host ops (self CPU time). None when
    the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    top = {}
    for e in kern:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    host = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name] = (host.get(e.name, 0.0)
                            + e.self_cpu_time_total / 1e3)
    by = {"flash_attention": 0.0, "qmatmul": 0.0, "matmul": 0.0,
          "other": 0.0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    for e in kern:
        name = e.name.lower()
        fam = ("flash_attention" if "flash_attention" in name else
               "qmatmul" if "qmatmul" in name else
               "matmul" if any(t in name for t in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "sm90_"))
               else "other")
        by[fam] += e.time_range.elapsed_us() / 1e3
    busy, span = _busy_us(spans)
    return {"kernels": len(kern), "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
            "ms_by_family": by,
            "top_kernels_ms": dict(sorted(top.items(),
                                          key=lambda kv: -kv[1])[:8]),
            "top_host_ops_self_ms": dict(sorted(host.items(),
                                                key=lambda kv: -kv[1])[:8])}


def _host_ms(fn, n):
    """Median host-clock ms of ``n`` synchronised calls, after one."""
    import torch
    from repro_torch.obs import timer

    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(n):
        t0 = timer.now()
        fn()
        torch.cuda.synchronize()
        vals.append((timer.now() - t0) * 1e3)
    return statistics.median(vals)


def phase_lm_prefill():
    """Full-width llama3-8b in bf16: counters to 0, one ``prefill`` of
    1 x LM_SEQ seeded tokens, counters read; each K6 launch's inputs
    caught (the model's own q/k/v), the first and last layers' held
    against the plain version. Then prefill and decode times. Returns (launches, worst |kernel - plain|, K6's
    timing case on layer 0's inputs, details); the weights are freed on
    return."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    from repro_torch.obs import timer

    cfg = get_config(LM_CONFIG)
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    t0 = timer.now()
    with torch.inference_mode():
        params = model.init(g, device="cuda")
    torch.cuda.synchronize()
    init_s = timer.now() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"lm init {LM_CONFIG}: {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16) in {init_s:.3f} s")
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=g,
                           device="cuda")
    batch = {"tokens": tokens}

    real = ops.flash_attention
    caught = []

    def catch(q, k, v, **kw):
        out = real(q, k, v, **kw)
        caught.append((q, k, v, kw, out))
        return out

    ops.flash_attention = catch
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
    finally:
        ops.flash_attention = real
    log(f"lm main-path launches (one prefill, B=1 S={LM_SEQ}): "
        f"{json.dumps(launches)}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention {launches['flash_attention']} "
          f"times, expected {cfg.n_layers}")
    for name in TINY_KERNELS + TRAIN_KERNELS:
        check(launches[name] == 0, f"prefill launched {name}")
    check(logits.shape == (1, LM_SEQ, cfg.vocab)
          and logits.dtype == torch.float32, f"logits {logits.dtype} "
          f"{tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")

    worst = 0.0
    for i in (0, len(caught) - 1):
        q, k, v, kw, out = caught[i]
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = float((out.float() - want.float()).abs().max())
        worst = max(worst, err)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        log(f"kernel-check flash_attention layer {i} on its prefill inputs "
            f"{tuple(q.shape)} {q.dtype} (strides {q.stride()}): max err "
            f"{err:.3g} (tol 2e-2)")
        del want
    q0, k0, v0, kw0, _ = caught[0]
    case = flash_case("prefill layer 0", q0, k0, v0, kw0)
    case["launches"] = launches["flash_attention"]
    del caught, logits
    torch.cuda.empty_cache()

    prefill_ms = _host_ms(lambda: model.prefill(params, batch), 3)
    log(f"lm prefill {LM_CONFIG} bf16 B=1 S={LM_SEQ}: {prefill_ms:.3f} ms "
        f"(host clock, median of 3, synchronised)")
    decode = _decode_call(model, params, g)
    decode_ms = _host_ms(decode, 10)
    log(f"lm decode {LM_CONFIG} bf16 batch 4, cache 256: {decode_ms:.3f} ms "
        f"per step (host clock, median of 10, synchronised)")
    details = {"init_s": init_s, "n_params": n_params,
               "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
               "main_path_launches": launches}
    return launches, worst, case, details


#: K6 per launch at the prefill shape before this kernel's redesign: the
#: CUDA-core kernel on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md, §6)
K6_CUDA_CORE_MS = 8.116400


def sass_count(lib, opcode):
    """Instructions of ``opcode`` in the SASS of a built library
    (``cuobjdump --dump-sass`` beside nvcc)."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def phase_k6_times(case):
    """K6 at the main path's shape on its layer-0 inputs: kernel, plain
    version, SDPA and the bound, beside the CUDA-core kernel's time; and
    the HGMMA (wgmma) instructions of the built library, which must not be
    0: bf16 goes through the tensor cores. Returns (timing row,
    details)."""
    from repro_torch.kernels import _build

    row = time_case(case, reps=5, inner=10)
    (lib,) = _build.build_all(["flash_attention"])
    hgmma = sass_count(lib, "HGMMA")
    log(f"K6 sass: {hgmma} HGMMA instructions in {os.path.basename(lib)}")
    check(hgmma > 0, "the flash_attention library holds no HGMMA: the bf16 "
                     "kernel does not run on the tensor cores")
    per = row["ms"]
    log(f"K6 prefill shape ({case['shape']}): {per:.6f} ms per launch, "
        f"{per / row['bound_ms']:.2f}x its bound {row['bound_ms']:.6f} ms, "
        f"SDPA {row['library_ms']:.6f} ms ({per / row['library_ms']:.2f}x), "
        f"the CUDA-core kernel {K6_CUDA_CORE_MS:.6f} ms "
        f"({K6_CUDA_CORE_MS / per:.1f}x faster now)")
    return row, {"hgmma": hgmma, "ms": per, "bound_ms": row["bound_ms"],
                 "sdpa_ms": row["library_ms"],
                 "cuda_core_ms": K6_CUDA_CORE_MS}


def _decode_call(model, params, g, batch=4):
    """One decode step of ``batch`` (4 or 1) slots at positions 17..200 of
    a 256-long cache, as a closure (the cache is updated in place each
    call)."""
    import torch

    cache = model.cache_init(batch, 256, device="cuda")
    tok = torch.randint(0, model.cfg.vocab, (batch, 1), generator=g,
                        device="cuda")
    cur = torch.tensor([17, 64, 100, 200][:batch], dtype=torch.int32,
                       device="cuda")
    return lambda: model.decode_step(params, cache, tok, cur)


def _decode_ms(model, params, g):
    """Host ms of one decode step alone (median of 10, synchronised) at
    batch 1, as the engine steps a prompt into its slot, and at batch 4,
    the engine's decode batch."""
    return {f"batch{b}": _host_ms(_decode_call(model, params, g, b), 10)
            for b in (1, 4)}


def phase_lm_profile():
    """Last, because the profiler's tracing slows every later launch: the
    full-width bf16 model again (same seed), one prefill and one decode
    step under ``torch.profiler``, then decode timed once more to show the
    tracing's after-effect. Returns the breakdowns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    model = Model(get_config(LM_CONFIG))
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    with torch.inference_mode():
        params = model.init(g, device="cuda")
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (1, LM_SEQ),
                                     generator=g, device="cuda")}
    decode = _decode_call(model, params, g)
    model.prefill(params, batch)
    decode()
    replay = _replayed(decode)
    out = {"prefill": _device_breakdown(lambda: model.prefill(params, batch)),
           "decode": _device_breakdown(decode),
           "decode_replay": _device_breakdown(replay)}
    out["decode_ms_after_profiling"] = _host_ms(decode, 10)
    for k in ("prefill", "decode", "decode_replay"):
        log(f"lm profile {LM_CONFIG} bf16 {k}: {json.dumps(out[k])}")
    log(f"lm decode after profiling: {out['decode_ms_after_profiling']:.3f} "
        f"ms per step (host clock, median of 10, synchronised)")
    del params
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_depth_cut():
    """llama3-8b at full width cut to 2 layers, float32, S 512, "chunked"
    (K6 per layer), TF32 off: logits on the card against the port on the
    CPU with the same weights, within 1e-4. Returns the max |diff|."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.core.pytree import tree_map

    cfg = dataclasses.replace(get_config(LM_CONFIG), n_layers=2,
                              attn_impl="chunked", dtype="float32")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    with torch.inference_mode():
        params = model.init(g, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=g,
                           device="cuda")
    with full_fp32():
        before = ops.launches["flash_attention"]
        got = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        n_k6 = ops.launches["flash_attention"] - before
    check(n_k6 == cfg.n_layers, f"depth-cut prefill launched K6 {n_k6} "
                                f"times, expected {cfg.n_layers}")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    del params
    want = model.prefill(cpu_params, {"tokens": tokens.cpu()})
    err = float((got.cpu() - want).abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    log(f"lm depth cut {LM_CONFIG} 2 layers float32 S=512 chunked: card "
        f"equals the CPU port within 1e-4 (max |diff| {err:.3g}, K6 "
        f"launched {n_k6} times)")
    del cpu_params, got, want
    torch.cuda.empty_cache()
    return err


def _greedy(model, params, prompt, n_new, max_len):
    """Sequential single-request greedy decode (the engine's ground truth,
    as ``tests/test_serving.py`` has it)."""
    import torch

    cache = model.cache_init(1, max_len, device="cuda")
    toks, out = list(prompt), []
    for t in range(len(prompt) + n_new - 1):
        tok = torch.tensor([[toks[t]]], dtype=torch.int32, device="cuda")
        logits, cache = model.decode_step(params, cache, tok, t)
        nxt = int(torch.argmax(logits[0, 0]))
        if t >= len(prompt) - 1:
            out.append(nxt)
            if len(out) >= n_new:
                break
            toks.append(nxt)
    return out


def phase_lm_serving():
    """``ServeEngine`` on full-width llama3-8b in float32 (TF32 off: cuBLAS
    reduces differently by batch rows, which in bf16 can flip an argmax
    between the batched and the sequential run): 4 slots, max_len 256, 8
    seeded requests of 8-32 prompt tokens and 8 new tokens. Every request
    finishes, with its own sequential greedy decode's tokens. Returns the
    engine's stats."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.obs import timer
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(LM_CONFIG), dtype="float32")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    with torch.inference_mode():
        params = model.init(g, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in rng.integers(8, 33, 8)]
    with full_fp32():
        eng = ServeEngine(model, params, n_slots=4, max_len=256,
                          device="cuda")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        t0 = timer.now()
        for r in reqs:
            eng.submit(r)
        steps = eng.run_until_drained()
        torch.cuda.synchronize()
        engine_s = timer.now() - t0
        stats = eng.stats()
        check(len(eng.finished) == len(reqs), f"{len(eng.finished)} of "
                                              f"{len(reqs)} requests finished")
        for r in reqs:
            want = _greedy(model, params, r.prompt, 8, 256)
            check(r.output == want, f"request {r.uid}: engine {r.output} != "
                                    f"sequential {want}")
    stats.update(steps=steps, engine_s=engine_s,
                 prompt_tokens=int(sum(len(p) for p in prompts)),
                 new_tokens=int(sum(len(r.output) for r in reqs)))
    log(f"lm serving {LM_CONFIG} float32, 4 slots: {len(reqs)} requests, "
        f"{stats['prompt_tokens']} prompt and {stats['new_tokens']} new "
        f"tokens in {steps} engine steps, {engine_s:.3f} s; "
        f"{stats['throughput_tok_s']:.3f} tokens/s (new tokens over the "
        f"span, host clock); every request equals its sequential greedy "
        f"decode")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ---------------------------------------------------------------------------
# the measurement slice: K4, K5, K1's tiles, the kernel bench, the
# autotuner and the MLPerf scenarios
# ---------------------------------------------------------------------------

# K5 cases (M, K, N, relu, bias, out_scale): tests/test_kernels.py's shapes
# (both ReLU settings, the requant scales 0.125 / 0.5 / 0.03, no bias) and
# ragged ones, both output dtypes, non-power-of-two out_scale
QMM_CASES = ([(m, k, n, relu, True, None)
              for m, k, n in [(8, 16, 8), (100, 70, 50), (128, 128, 128),
                              (33, 200, 17), (256, 64, 192)]
              for relu in (False, True)]
             + [(64, 48, 40, True, True, o) for o in (0.125, 0.5, 0.03)]
             + [(32, 32, 32, False, False, None),
                (1, 1, 1, False, False, 0.3), (1, 3, 5, True, True, 0.07),
                (65, 33, 129, False, True, 0.3),
                (1000, 490, 257, True, False, 0.01),
                (513, 1031, 63, False, True, None),
                (512, 512, 512, True, True, 0.125)]
             # M = 1, and the tiny models' dense shapes as K5 sees them from
             # the QAT layers (KWS's first layer at batch 1 and 1024, AD's)
             + [(1, 64, 40, True, True, 0.05), (1, 490, 256, True, True, None),
                (1024, 490, 256, True, True, 0.05),
                (1024, 128, 72, False, True, None)])
#: K5's large shape: checked, then timed beside its bound and the int8 peak
QMM_BIG = (4096, 4096, 4096)
# K4 cases (M, C, S, bank kind of ``kernel_bench.mt_inputs``):
# tests/test_kernels.py's, tests/test_megakernel.py's deep banks (256, 300,
# 511), ragged ones, AD's bank; then unsorted banks, banks with ties,
# INT32_MIN/MAX steps and accumulators, sorted and unsorted channels in one
# call, S around the search's powers of two (63, 64, 65, 256, 1024) and
# deep banks: S 4096 (fewer channels per block) and S 30000 (the chunked
# linear count)
MT_CASES = ([(m, c, s, "sorted") for m, c, s in [
    (16, 8, 3), (37, 20, 7), (64, 12, 15), (128, 72, 255), (5, 3, 1),
    (16, 12, 256), (24, 8, 300), (8, 40, 511), (1, 1, 1), (1000, 33, 64),
    (97, 65, 65), (1024, 72, 255), (300, 257, 129), (200, 40, 63),
    (129, 33, 1024), (130, 32, 4096), (40, 3, 30000)]]
    + [(97, 65, 65, "unsorted"), (300, 40, 255, "unsorted"),
       (129, 72, 64, "ties"), (64, 9, 256, "ties"),
       (50, 33, 255, "extreme"), (7, 5, 4096, "extreme"),
       (300, 72, 255, "mixed"), (64, 40, 1024, "mixed"),
       (33, 20, 65, "mixed")])
# K1 tile checks (M, K, N, S, lo, hi), each under every tile
TILE_CASES = [(1, 1, 1, 1, -127, 128), (37, 19, 70, 7, -127, 128),
              (130, 65, 129, 255, 0, 256), (1024, 490, 256, 7, -127, 128),
              (257, 300, 100, 255, 0, 256)]


def phase_k4_k5():
    """K4 and K5 against their plain versions on the card, bit for bit,
    over ``MT_CASES`` and ``QMM_CASES``. Returns the worst |kernel - plain|
    per kernel."""
    import numpy as np
    import torch
    from repro_torch.bench.kernel_bench import mt_inputs
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 8)
    worst = {"multi_threshold": 0, "qmatmul": 0}
    for m, c, steps, kind in MT_CASES:
        a_np, t_np = mt_inputs(rng, m, c, steps, kind)
        acc = torch.as_tensor(a_np).cuda()
        thr = torch.as_tensor(t_np).cuda()
        got = ops.multi_threshold(acc, thr)
        want = ref.multi_threshold_ref(acc, thr)
        err = int((got.long() - want.long()).abs().max())
        worst["multi_threshold"] = max(worst["multi_threshold"], err)
        check(err == 0 and torch.equal(got, want),
              f"multi_threshold M={m} C={c} S={steps} {kind}: max err {err}")
        bc = ops.multi_threshold_plan(c, steps)
        log(f"kernel-check multi_threshold M={m} C={c} S={steps} {kind} "
            f"({f'{bc} channels per block' if bc else 'linear count'}): "
            f"exact")
    for m, k, n, relu, has_bias, out_scale in QMM_CASES:
        x = torch.as_tensor(rng.integers(-127, 128, (m, k)),
                            dtype=torch.int8).cuda()
        w = torch.as_tensor(rng.integers(-127, 128, (k, n)),
                            dtype=torch.int8).cuda()
        sc = torch.as_tensor(rng.uniform(1e-3, 1e-2, n),
                             dtype=torch.float32).cuda()
        b = (torch.as_tensor(rng.standard_normal(n),
                             dtype=torch.float32).cuda() if has_bias
             else None)
        kw = dict(relu=relu, out_scale=out_scale)
        got = ops.qmatmul(x, w, sc, b, **kw)
        want = ref.qmatmul_ref(x, w, sc, b, **kw)
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"qmatmul {m}x{k}x{n}: {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        worst["qmatmul"] = max(worst["qmatmul"], err)
        check(err == 0 and torch.equal(got, want),
              f"qmatmul M={m} K={k} N={n} relu={relu} bias={has_bias} "
              f"out_scale={out_scale}: max err {err}")
        log(f"kernel-check qmatmul M={m} K={k} N={n} relu={relu} "
            f"bias={has_bias} out_scale={out_scale} ({got.dtype}): exact, "
            f"tile {ops.qmatmul_plan(m, k, n)['block_m']} x "
            f"{ops.qmatmul_plan(m, k, n)['block_n']}")
    return worst, phase_k5_big(rng)


def phase_k5_big(rng):
    """K5 at ``QMM_BIG`` (ReLU, requant 0.125): held against its plain
    version bit for bit, then timed beside its bound (operations at the
    int8 tensor-core peak), its share of that peak, the plain version and
    the unfused ``torch._int_mm`` chain. Returns the row."""
    import torch
    from repro_torch.bench.kernel_bench import _unfused
    from repro_torch.kernels import ops, ref

    m, k, n = QMM_BIG
    x = torch.as_tensor(rng.integers(-127, 128, (m, k)),
                        dtype=torch.int8).cuda()
    w = torch.as_tensor(rng.integers(-127, 128, (k, n)),
                        dtype=torch.int8).cuda()
    sc = torch.as_tensor(rng.uniform(1e-3, 1e-2, n), dtype=torch.float32).cuda()
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).cuda()
    kw = dict(relu=True, out_scale=0.125)
    got = ops.qmatmul(x, w, sc, b, **kw)
    want = ref.qmatmul_ref(x, w, sc, b, **kw)
    check(torch.equal(got, want), f"qmatmul {m}x{k}x{n}: kernel != plain")
    del want
    nbytes, nops = m * k + k * n + 8 * n + m * n, k5_ops(m, k, n)
    row = {"kernel": "qmatmul", "shape": f"M={m} K={k} N={n} relu "
                                         f"out_scale=0.125",
           "bytes": nbytes, "ops": nops,
           "ms": time_ms(lambda: ops.qmatmul(x, w, sc, b, **kw), reps=5,
                         inner=5),
           "plain_ms": time_ms(lambda: ref.qmatmul_ref(x, w, sc, b, **kw),
                               reps=3, inner=1),
           "library_ms": time_ms(lambda: _unfused(x, w, sc, b, 0.125),
                                 reps=5, inner=5),
           "bound_ms": bound_ms(nbytes, nops, INT8_OPS_PER_S),
           "bound_by": bound_by(nbytes, nops, INT8_OPS_PER_S)}
    row["int8_peak_share"] = nops / (row["ms"] * 1e-3) / INT8_OPS_PER_S
    log(f"kernel-check qmatmul M={m} K={k} N={n}: exact; time "
        f"{row['ms']:.6f} ms (tile {ops.qmatmul_plan(m, k, n)['block_m']} x "
        f"{ops.qmatmul_plan(m, k, n)['block_n']}), plain "
        f"{row['plain_ms']:.6f} ms, torch._int_mm + epilogue ops "
        f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}), {row['int8_peak_share']:.1%} of the int8 "
        f"tensor-core peak")
    return row


def phase_k1_tiles():
    """Every K1 tile instantiation against the plain version (the K1
    tiling the autotuner picks from). Returns the worst error."""
    import torch
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(SEED + 9)
    worst = 0
    for m, k, n, s, lo, hi in TILE_CASES:
        x = torch.randint(lo, hi, (m, k), generator=g, dtype=torch.int32)
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        t = _banks(ref.int_matmul(x, w), n, s, g)
        x, w, t = x.cuda(), w.cuda(), t.cuda()
        want = ref.threshold_matmul_ref(x, w, t)
        for bm in ops.TMM_TILE_SIZES:
            for bn in ops.TMM_TILE_SIZES:
                got = ops.threshold_matmul(x, w, t, block_m=bm, block_n=bn)
                err = int((got - want).abs().max())
                worst = max(worst, err)
                check(err == 0, f"threshold_matmul tile {bm}x{bn} M={m} "
                                f"K={k} N={n} S={s}: max err {err}")
        log(f"kernel-check threshold_matmul M={m} K={k} N={n} S={s}: exact "
            f"under all {len(ops.TMM_TILE_SIZES) ** 2} tiles")
    return worst


def phase_k1_tile_times(cases):
    """K1 under every tile on the full-width KWS and AD stages' phase-3
    inputs (1024 rows): device ms per tile, the grid's blocks, and the
    tile ``deploy.autotune.plan_block_mn`` picks at 1024 rows. Returns
    {stage: {"bm x bn": ms}}."""
    from repro_torch.deploy.autotune import plan_block_mn
    from repro_torch.kernels import ops

    out = {}
    for c in cases:
        if c["kernel"] != "threshold_matmul" or c["model"] not in ("kws",
                                                                   "ad"):
            continue
        x, w, t = c["inputs"]
        times = {}
        for bm in ops.TMM_TILE_SIZES:
            for bn in ops.TMM_TILE_SIZES:
                times[f"{bm}x{bn}"] = time_ms(
                    lambda: ops.threshold_matmul(x, w, t, block_m=bm,
                                                 block_n=bn))
        plan = plan_block_mn(x.shape[1], w.shape[1], n_steps=t.shape[1],
                             wave_rows=x.shape[0])
        best = min(times, key=times.get)
        key = f"{c['model']}/{c['stage']}"
        out[key] = {"ms": times, "fastest": best,
                    "model_pick": f"{plan['block_m']}x{plan['block_n']}",
                    "default": "x".join(map(str, ops.TMM_DEFAULT_TILE))}
        log(f"K1 tiles {key} {c['shape']}: "
            + ", ".join(f"{k} {v:.6f}" for k, v in times.items())
            + f" ms; fastest {best}, model {out[key]['model_pick']}, "
              f"default {out[key]['default']}")
    return out


#: K1's tile in the timing split: the one its dp4a variant is built for
SPLIT_TILE = (32, 32)
#: the split's variants: (label, dp4a on the CUDA cores, banks counted
#: step by step)
SPLIT_VARIANTS = (("mma_search", False, False), ("mma_linear", False, True),
                  ("cores_search", True, False), ("cores_linear", True, True))


def phase_k12_split(cases):
    """K1 and K2 timed step by step on every main-path K1 / K2 stage, on
    its phase-3 input: products on the int8 tensor cores (mma.sync) or on
    the CUDA cores (dp4a), banks searched (whole in shared memory, sorted
    ones by binary lifting) or counted step by step (streamed in chunks
    of 64 steps). K1 runs at ``SPLIT_TILE``, K2 at its planned row block
    on the input padded once (kernel time alone). Each variant is held
    equal to the plain version first. Returns the rows and the sums per
    model and kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv_threshold import pad_input

    rows, sums = [], {}
    for c in cases:
        if c["kernel"] not in ("threshold_matmul", "conv_threshold"):
            continue
        x, w, t = c["inputs"]
        want = c["plain"]()
        if c["kernel"] == "threshold_matmul":
            def launch(cores, linear, x=x, w=w, t=t):
                return ops._tmm_launch(x, w, t, *SPLIT_TILE, linear=linear,
                                       cores=cores)
        else:
            kw = c["geometry"]
            xp = pad_input(x, **kw)
            bh = ops.conv_block_rows(kw["out_h"], kw["out_w"], x.shape[3],
                                     kw["kernel"])

            def launch(cores, linear, xp=xp, w=w, t=t, kw=kw, bh=bh):
                return ops._conv_launch(
                    xp, w, t, kernel=kw["kernel"], stride=kw["stride"],
                    out_h=kw["out_h"], out_w=kw["out_w"], block_h=bh,
                    linear=linear, cores=cores)
        row = {k: c[k] for k in ("kernel", "model", "stage", "shape")}
        for label, cores, linear in SPLIT_VARIANTS:
            fn = (lambda cores=cores, linear=linear: launch(cores, linear))
            check(torch.equal(fn(), want), f"{c['kernel']} {c['model']}/"
                  f"{c['stage']} {label}: != plain")
            row[label] = time_ms(fn)
        rows.append(row)
        key = f"{c['model']}/{c['kernel']}"
        sums[key] = {k: sums.get(key, {}).get(k, 0.0) + row[k]
                     for k, _, _ in SPLIT_VARIANTS}
        log(f"split {c['kernel']} {c['model']}/{c['stage']} {c['shape']}: "
            + ", ".join(f"{k} {row[k]:.6f}" for k, _, _ in SPLIT_VARIANTS)
            + " ms (all exact)")
    for key, v in sums.items():
        log(f"split sum {key}: "
            + ", ".join(f"{k} {x:.6f}" for k, x in v.items()) + " ms")
    return {"rows": rows, "sums": sums}


def phase_int8_sass():
    """IMMA (int8 mma.sync) instructions in the SASS of the built K1, K2,
    K3 and K5 libraries; none fails the run. Returns the counts."""
    from repro_torch.kernels import _build

    counts = {}
    for name in ("threshold_matmul", "conv_threshold", "mlp_megakernel",
                 "qmatmul"):
        (lib,) = _build.build_all([name])
        counts[name] = sass_count(lib, "IMMA")
        log(f"{name} sass: {counts[name]} IMMA instructions in "
            f"{os.path.basename(lib)}")
        check(counts[name] > 0, f"the {name} library holds no IMMA: its "
                                f"products do not run on the tensor cores")
    return counts


def phase_kernel_bench():
    """The kernel bench (``repro_torch.bench.kernel_bench``) on the card:
    counters to 0, the bench's checking pass (one launch of each K4 and
    K5 case, held exactly against the plain version and the library
    call), counters read; then its timing pass and its conv-lowering and
    megakernel sections, and ``BENCH_torch_kernels.json`` into
    ``chiprun_out/``. Returns (counted launches, kernels-line rows, worst
    |kernel - plain|, the bench's rows)."""
    import torch
    from repro_torch.bench import kernel_bench as kb
    from repro_torch.bench.common import emit_json
    from repro_torch.kernels import ops

    cases = kb.kernel_cases("cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    worst = kb.check_cases(cases)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    log(f"kernel bench launches (checking pass): {json.dumps(launches)}")
    for name in BENCH_KERNELS:
        check(launches[name] == sum(c["kernel"] == name for c in cases),
              f"the kernel bench launched {name} {launches[name]} times")
    for name in TINY_KERNELS + LM_KERNELS:
        check(launches[name] == 0, f"the kernel bench's checking pass "
                                   f"launched {name}")
    timed = kb.time_cases(cases)
    rows = []
    for r in timed:
        d = r["derived"]
        row = {"kernel": d["kernel"], "model": "kernel_bench",
               "stage": r["name"], "shape": d["shape"], "bytes": d["bytes"],
               "ops": d["ops"], "launches": 1, "ms": d["ms"],
               "plain_ms": d["plain_ms"], "library_ms": d["library_ms"]}
        peak = PEAK_OPS_PER_S[row["kernel"]]
        row["bound_ms"] = bound_ms(row["bytes"], row["ops"], peak)
        row["bound_by"] = bound_by(row["bytes"], row["ops"], peak)
        rows.append(row)
        log(f"time {row['kernel']} kernel_bench {row['shape']}: kernel "
            f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, "
            f"{d['library_is']} {row['library_ms']:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    extra = kb.conv_lowering_rows("cuda") + kb.megakernel_rows("cuda")
    for r in extra:
        log(f"bench {r['name']}: {r['us_per_call']:.3f} us "
            f"{json.dumps(r['derived'])}")
    emit_json("BENCH_torch_kernels.json",
              {"rows": timed + extra, "max_abs_err": worst,
               "device": torch.cuda.get_device_name(0)},
              os.path.join(ROOT, "chiprun_out"))
    return launches, rows, worst, timed + extra


def _headless(cm):
    """The same tuned schedule without its float head, same dispatch: its
    outputs are the integer codes."""
    import dataclasses

    from repro_torch.deploy import CompiledTinyModel

    return CompiledTinyModel(
        dataclasses.replace(cm.schedule, stages=cm.schedule.stages[:-1]),
        device=cm.device, megakernel=cm.megakernel)


#: what a tuned config decides: two searches agree when these are equal
TUNED_PICKS = ("micro_batch", "block_h", "block_mn", "segment_mode")


def _pair_decisions(cfg):
    """Each measured decision of a config: candidate -> (median ms, spread
    ms) for the micro-batches, K1's tiles and the dispatch modes."""
    out = {"micro_batch": {str(c["micro_batch"]): (c["probe_ms"],
                                                   c.get("probe_spread_ms"))
                           for c in cfg.candidates if "probe_ms" in c}}
    if cfg.block_mn_probe.get("probe_ms"):
        out["block_mn"] = {k: (v, cfg.block_mn_probe.get("spread_ms",
                                                         {}).get(k))
                           for k, v in cfg.block_mn_probe["probe_ms"].items()}
    elif cfg.block_mn_probe:
        out["block_mn"] = cfg.block_mn_probe.get("untimed")
    if cfg.segment_mode_model.get("probe_ms"):
        sp = cfg.segment_mode_model.get("spread_ms", {})
        out["segment_mode"] = {k: (v, sp.get(k)) for k, v in
                               cfg.segment_mode_model["probe_ms"].items()}
    return out


def phase_autotune(models, caches):
    """``autotune_model`` on the four full-width models, searched twice in
    probe mode, each search with its own cache of ``caches[:2]``: both
    configs printed with every pair decision's medians and spreads, and
    whether their picks agree (reported, not a failure: PERF.md gives any
    disagreement); the tuned ``offline`` of the first search equals the
    untuned one (codes bit for bit, logits within 1e-5); a further call
    returns the first config from its cache without probing. Then one
    model-mode search per model (the learned cost model, its own cache
    ``caches[2]``) on a fresh compile, with a probe that fails the run if
    called: its config must say ``source: "predicted"`` and hold no probe;
    its micro-batch and dispatch are printed beside the first probe
    search's, its predicted ms beside the probed ms of the candidates the
    probe search timed, and the 64-row pool under each search's config
    timed in turns; its tuned ``offline`` codes equal the untuned ones bit
    for bit. Returns ({name: tuned compiled model}, {name: agreement and the
    model-mode picks})."""
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.deploy.autotune import autotune_model

    def no_probe(cm, x, micro_batch):
        raise SmokeFailure("the second autotune call probed: the cache was "
                           "not read")

    def model_probe(cm, x, micro_batch):
        raise SmokeFailure("the model-mode search called a probe")

    tuned, agree = {}, {}
    for n, g, s, x in models:
        xc = torch.as_tensor(x).cuda()
        cm = compile_graph(g, in_scale=s, device="cuda",
                           conv_lowering="direct")
        y0, codes0 = cm.offline(xc), _headless(cm).offline(xc)
        cfgs = [autotune_model(cm, batch=64, directory=c, force=True)
                for c in caches[:2]]
        cfg = cfgs[0]
        again = autotune_model(cm, batch=64, directory=caches[0],
                               force=False, probe=no_probe)
        check(again == cfg, f"{n}: the cached config differs from the "
                            f"searched one")
        cm.apply_tuned(cfg)
        y1, codes1 = cm.offline(xc), _headless(cm).offline(xc)
        check(torch.equal(codes0, codes1),
              f"{n}: tuned offline codes differ from untuned")
        if y0.dtype.is_floating_point:
            torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
        else:
            check(torch.equal(y0, y1), f"{n}: tuned offline differs")
        picks = [{k: getattr(c, k) for k in TUNED_PICKS} for c in cfgs]
        agree[n] = {"agree": picks[0] == picks[1], "picks": picks,
                    "decisions": [_pair_decisions(c) for c in cfgs]}
        for i, c in enumerate(cfgs):
            shown = {k: getattr(c, k) for k in (
                "key", "platform", "micro_batch", "block_h", "block_mn",
                "segment_mode", "fifo_depths", "modeled_cycles",
                "modeled_traffic_bytes", "source")}
            log(f"autotune {n} search {i + 1}: {json.dumps(shown)}")
            log(f"autotune {n} search {i + 1} decisions (median ms, spread "
                f"ms): {json.dumps(agree[n]['decisions'][i])}")
        differ = [k for k in TUNED_PICKS if picks[0][k] != picks[1][k]]
        log(f"autotune {n}: the two searches "
            + (f"agree on {', '.join(TUNED_PICKS)}" if not differ
               else f"differ on {', '.join(differ)}"))
        log(f"autotune {n}: a third call loaded the config from the cache; "
            f"tuned offline codes equal untuned bit for bit")
        agree[n]["model"] = phase_autotune_model_mode(
            n, g, s, xc, codes0, cfg, cm, caches[2], model_probe)
        tuned[n] = cm
    log(f"autotune: the two searches agree on "
        f"{sum(a['agree'] for a in agree.values())} of {len(agree)} models; "
        f"the model-mode search picks the first search's micro-batch on "
        f"{sum(a['model']['same_micro_batch'] for a in agree.values())} and "
        f"its dispatch on "
        f"{sum(a['model']['same_dispatch'] for a in agree.values())} of "
        f"{len(agree)}")
    return tuned, agree


def _pool_in_turns(arms, x, rounds=7):
    """Median and spread ms of one synchronised ``streaming_compiled`` pass
    of ``x`` per arm ({label: (compiled model, micro-batch)}): one warm pass
    each, then ``rounds`` rounds with the arms in turns."""
    import torch
    from repro_torch.obs import timer

    def one(cm, mb):
        torch.cuda.synchronize()
        t0 = timer.now()
        cm.streaming_compiled(x, micro_batch=mb)
        torch.cuda.synchronize()
        return (timer.now() - t0) * 1e3

    for cm, mb in arms.values():
        one(cm, mb)
    ms = {label: [] for label in arms}
    for _ in range(rounds):
        for label, (cm, mb) in arms.items():
            ms[label].append(one(cm, mb))
    return {label: {"median_ms": statistics.median(v),
                    "spread_ms": max(v) - min(v)} for label, v in ms.items()}


def phase_autotune_model_mode(n, g, s, xc, codes0, probed, probed_cm, cache,
                              probe):
    """One ``REPRO_AUTOTUNE=model`` search (``mode="model"``) of a fresh
    compile of ``g``: no probe (``probe`` fails the run if called), no
    probe record, ``source: "predicted"``; the tuned codes equal
    ``codes0``. Returns its picks and predictions beside the probe search
    ``probed``, and the 64-row streaming pool of ``probed_cm`` (tuned by
    ``probed``) and of the model-mode compile, timed in turns."""
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.deploy.autotune import autotune_model, default_sample

    cm = compile_graph(g, in_scale=s, device="cuda", conv_lowering="direct")
    cfg = autotune_model(cm, batch=64, directory=cache, force=True,
                         mode="model", probe=probe)
    check(cfg.source == "predicted" and cfg.probe_ms is None
          and cfg.seed_stage_ms is None and not cfg.block_mn_probe
          and "probe_ms" not in cfg.segment_mode_model
          and all("probe_ms" not in c for c in cfg.candidates),
          f"{n}: the model-mode config holds a probe: {cfg.to_dict()}")
    cm.apply_tuned(cfg)
    check(torch.equal(_headless(cm).offline(xc), codes0),
          f"{n}: model-mode tuned offline codes differ from untuned")
    pool = _pool_in_turns({"probed": (probed_cm, probed.micro_batch),
                           "predicted": (cm, cfg.micro_batch)},
                          default_sample(cm, 64))
    pred = {c["micro_batch"]: c for c in cfg.candidates}
    cand = pred[cfg.micro_batch]
    # the candidates the probe search timed: predicted beside probed ms
    # for the same pool (n_micro waves of the micro-batch)
    pairs = {str(c["micro_batch"]): {
        "predicted_wave_ms": pred[c["micro_batch"]]["predicted_wave_ms"],
        "predicted_total_ms": pred[c["micro_batch"]]["predicted_total_ms"],
        "probed_total_ms": c["probe_ms"]}
        for c in probed.candidates if "probe_ms" in c}
    out = {"micro_batch": cfg.micro_batch, "segment_mode": cfg.segment_mode,
           "block_h": cfg.block_h, "block_mn": cfg.block_mn,
           "predicted_wave_ms": cand["predicted_wave_ms"],
           "predicted_total_ms": cand["predicted_total_ms"],
           "n_micro": cand["n_micro"], "probed_candidates": pairs,
           "dispatch_predicted_ms": cfg.segment_mode_model.get(
               "predicted_ms"),
           "dispatch_probed_ms": probed.segment_mode_model.get("probe_ms"),
           "same_micro_batch": cfg.micro_batch == probed.micro_batch,
           "same_dispatch": cfg.segment_mode == probed.segment_mode,
           "pool_ms": {k: (v["median_ms"], v["spread_ms"])
                       for k, v in pool.items()}}
    shown = ", ".join(
        f"mb {mb}: predicted {v['predicted_total_ms']:.6f} "
        f"({v['predicted_wave_ms']:.6f} a wave), probed "
        f"{v['probed_total_ms']:.6f}" for mb, v in pairs.items())
    log(f"autotune {n} model mode: micro-batch {cfg.micro_batch} (probe "
        f"search {probed.micro_batch}), dispatch {cfg.segment_mode} (probe "
        f"search {probed.segment_mode}); no probe, source {cfg.source}; "
        f"its pick predicted {cand['predicted_wave_ms']:.6f} ms a wave, "
        f"{cand['predicted_total_ms']:.6f} ms for the {cand['n_micro']}-"
        f"wave pool; the probe search's candidates, ms per pool: {shown}; "
        f"dispatch predicted at micro-batch {cfg.micro_batch} "
        f"{json.dumps(out['dispatch_predicted_ms'])}, probed at "
        f"{probed.micro_batch} {json.dumps(out['dispatch_probed_ms'])}; "
        f"the 64-row pool under each search's config, timed in turns "
        f"(median, spread ms): probed config {out['pool_ms']['probed']}, "
        f"predicted config {out['pool_ms']['predicted']}; tuned codes "
        f"equal untuned bit for bit")
    return out


def phase_trace_export(tuned, x, smi, calls=5):
    """Trace ``calls`` tuned KWS ``offline`` calls, each a synchronised
    span carrying the kernel launches it made and its logits' sum (a 0-d
    tensor on the card), and export them with ``obs.export_chrome`` to
    ``chiprun_out/trace_kws_offline.json``. Returns (path, bytes)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, export_chrome

    cm, xc = tuned["kws"], torch.as_tensor(x).cuda()
    tracer = Tracer()
    for i in range(calls):
        before = dict(ops.launches)
        with tracer.span("offline", cat="executor", tid=0, call=i,
                         rows=xc.shape[0], micro_batch=cm.default_micro_batch,
                         segment_mode=cm.tuned.segment_mode) as sp:
            y = cm.offline(xc)
            torch.cuda.synchronize()
            sp.set(logit_sum=y.sum(), **{
                k: ops.launches[k] - before[k] for k in before
                if ops.launches[k] != before[k]})
        tracer.counter("launches", sum(ops.launches[k] - before[k]
                                       for k in before), tid=1)
    path = export_chrome(
        tracer, os.path.join(ROOT, "chiprun_out", "trace_kws_offline.json"),
        process_names={0: "chip_smoke"},
        thread_names={(0, 0): "kws offline", (0, 1): "launches"},
        meta={"card": smi, "model": "kws", "source": cm.tuned.source})
    size = os.path.getsize(path)
    doc = json.load(open(path))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    check(len(spans) == calls and all(
        isinstance(e["args"]["logit_sum"], float) for e in spans),
        f"the exported trace holds {len(spans)} offline spans")
    log(f"trace: {calls} tuned KWS offline calls exported by export_chrome "
        f"to {os.path.relpath(path, ROOT)}, {size} bytes, "
        f"{len(doc['traceEvents'])} events")
    return os.path.relpath(path, ROOT), size


def phase_scenarios(models, tuned, smi):
    """``run_all_scenarios`` on the four tuned models with ``compiled=cm``
    and ``model_cost=schedule_cost(...)``: p50/p90/p99, qps, roofline and
    measured energy per scenario, printed beside the card's name and power
    limit, which must equal ``core.codesign.CHIP_WATTS``; the streamed
    codes equal ``offline``; then the device time of one batch-1 query
    (CUDA-graph replay, the query already on the card) beside the
    SingleStream p50, and the kernels it launches. Returns {name: {report
    rows, device ms, launches}}."""
    import numpy as np
    import torch
    from repro_torch.core.bops import schedule_cost
    from repro_torch.core.codesign import CHIP_WATTS
    from repro_torch.deploy.scenarios import run_all_scenarios
    from repro_torch.kernels import ops

    limit = float(smi.split(",")[-1].strip().split()[0])
    check(limit == CHIP_WATTS, f"power limit {limit} W differs from the "
                               f"energy model's {CHIP_WATTS} W")
    out = {}
    for n, _, _, x in models:
        cm = tuned[n]
        xc = torch.as_tensor(x).cuda()
        bits = max(getattr(st, "in_bits", 8) for st in cm.schedule.stages)
        reports = run_all_scenarios(
            cm.offline, lambda i, x=x: x[i % len(x)], n_queries=64,
            n_streams=8, offline_samples=BATCH, server_qps=200.0,
            model_cost=schedule_cost(cm.schedule.stages), bits=bits,
            compiled=cm)
        names = [r.scenario for r in reports]
        check(names == ["SingleStream", "MultiStream", "Offline", "Server",
                        "StreamingOffline", "ServerStreaming"],
              f"{n}: scenarios {names}")
        rows = []
        for r in reports:
            check(all(np.isfinite([r.p50_ms, r.p90_ms, r.p99_ms,
                                   r.throughput_qps, r.energy_proxy_uJ,
                                   r.measured_energy_uJ]))
                  and r.throughput_qps > 0, f"{n} {r.scenario}: {r.row()}")
            rows.append(r.row())
            log(f"scenario {n} {r.scenario} ({smi}): p50 {r.p50_ms:.6f} ms, "
                f"p90 {r.p90_ms:.6f} ms, p99 {r.p99_ms:.6f} ms, "
                f"{r.throughput_qps:.1f} qps, roofline "
                f"{r.energy_proxy_uJ:.6f} uJ, measured "
                f"{r.measured_energy_uJ:.3f} uJ")
        head = _headless(cm)
        y_s, st = head.streaming_compiled(xc,
                                          micro_batch=cm.default_micro_batch)
        check(torch.equal(y_s, head.offline(xc)),
              f"{n}: streamed codes differ from offline")
        log(f"scenario {n}: streamed codes (micro-batch {st.micro_batch}) "
            f"equal offline bit for bit")
        # the device's share of a SingleStream query: one batch-1 offline
        # call on a query already on the card, by CUDA-graph replay, and
        # the kernels it launches
        x1 = xc[:1].contiguous()
        before = dict(ops.launches)
        cm.offline(x1)
        torch.cuda.synchronize()
        per_query = {k: ops.launches[k] - before[k] for k in before
                     if ops.launches[k] != before[k]}
        dev_ms = time_ms(lambda: cm.offline(x1))
        p50 = reports[0].p50_ms
        log(f"scenario {n} SingleStream breakdown ({smi}): device "
            f"{dev_ms:.6f} ms of the {p50:.6f} ms p50 "
            f"({dev_ms / p50:.1%}), launches per query "
            f"{json.dumps(per_query)}")
        out[n] = {"reports": rows, "single_stream_device_ms": dev_ms,
                  "single_stream_launches": per_query}
    return out


#: the serving phase: the operating-point curve's load fractions
#: (``serve_bench``'s ``REPRO_FAST`` ones) and queries (eight waves of 64,
#: so the saturation probe fills its waves), the queries of the Server
#: runs on the router (at half the measured saturation), of each tenant
#: of the shim and of the fault run
SERVE_FRACTIONS = (0.7, 1.1)
SERVE_CURVE_QUERIES = 512
SERVE_QUERIES = 512
SERVE_LOAD = 0.5
SHIM_REQUESTS = 64
FAULT_QUERIES = 256


class _WaveRecorder:
    """A compiled model seen through its wave API, keeping every wave it
    served (input rows, output, mask) so each one can be held against
    ``offline`` afterwards; ``offline``, ``device`` and the micro-batch
    pass through."""

    def __init__(self, cm):
        self.cm = cm
        self.device = cm.device
        self.waves = []
        self.submit_ms = []          # host time of each submit_wave call

    @property
    def default_micro_batch(self):
        return self.cm.default_micro_batch

    def submit_wave(self, x, valid=None, micro_batch=None):
        import numpy as np
        from repro_torch.obs import timer

        t0 = timer.now()
        y, mask = self.cm.submit_wave(x, valid=valid, micro_batch=micro_batch)
        self.submit_ms.append((timer.now() - t0) * 1e3)
        self.waves.append((np.asarray(x).copy(), y, mask))
        return y, mask

    def offline(self, x):
        return self.cm.offline(x)


class _GcTimer:
    """Host time the Python garbage collector takes while installed
    (``gc.callbacks``): collections, total and longest ms."""

    def __enter__(self):
        import gc

        self.n, self.total_ms, self.max_ms, self._t0 = 0, 0.0, 0.0, None
        gc.callbacks.append(self)
        return self

    def __call__(self, phase, info):
        from repro_torch.obs import timer

        if phase == "start":
            self._t0 = timer.now()
        elif self._t0 is not None:
            ms = (timer.now() - self._t0) * 1e3
            self.n, self.total_ms = self.n + 1, self.total_ms + ms
            self.max_ms = max(self.max_ms, ms)

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self)

    def row(self):
        return {"collections": self.n, "total_ms": self.total_ms,
                "max_ms": self.max_ms}


def _reset_launches():
    """Synchronise, then set every launch counter to 0."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()


def _launches_now():
    """The K1/K2/K3 launch counts since the last reset, after a
    synchronise."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    return tuple(ops.launches[k] for k in TINY_KERNELS)


def _counted(fn):
    """The K1/K2/K3 launches of one call of ``fn``."""
    _reset_launches()
    fn()
    return _launches_now()


def _times(per, n):
    return tuple(a * n for a in per)


def _add(*ts):
    return tuple(sum(v) for v in zip(*ts))


def _hold(model, x, y, label):
    """``y`` against ``model.offline(x)``: integer codes bit for bit,
    logits within rtol = atol = 1e-5 (the repo's rule for the float head,
    ``tests/test_golden.py``). Returns the worst |difference| (0 for
    codes)."""
    import numpy as np
    import torch

    want = model.offline(x)
    got = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor)
                          else y).to(want.device)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: served {tuple(got.shape)} {got.dtype}, offline "
          f"{tuple(want.shape)} {want.dtype}")
    if want.dtype.is_floating_point:
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"{label}: logits differ from offline by up to {err} (max "
              f"|offline| {float(want.abs().max())})")
        return err
    check(torch.equal(got, want), f"{label}: served codes differ from "
                                  f"offline")
    return 0.0


def _hold_waves(rec, label, results=None):
    """Every wave a ``_WaveRecorder`` served, held against ``offline``.
    Each wave's valid rows against ``offline`` of the same padded wave:
    codes bit for bit, logits within 1e-5. Then all the waves' rows
    against one ``offline`` call on all their inputs: codes bit for bit;
    for logits the worst difference is measured (the float head's kernel
    sums in a fixed order, so it is 0; ``phase_serving`` holds
    ``server_streaming``'s own ``bit_exact_vs_offline``). ``results`` (the
    router's per-request rows, in dispatch order) must equal the waves'
    rows bit for bit. Returns a summary."""
    import numpy as np
    import torch

    cm = rec.cm
    same_shape, bitwise = 0.0, True
    for x, y, mask in rec.waves:
        n = x.shape[0]
        check(mask[:n].all() and not mask[n:].any(),
              f"{label}: a wave's mask {mask.tolist()}")
        pad = np.zeros((y.shape[0],) + x.shape[1:], x.dtype)
        pad[:n] = x
        want = cm.offline(pad)
        same = bool(torch.equal(y, want))
        bitwise = bitwise and same
        if want.dtype.is_floating_point:
            err = float((y - want).abs().max())
            check(torch.allclose(y, want, rtol=1e-5, atol=1e-5),
                  f"{label}: a wave's logits differ from offline of the "
                  f"same wave by up to {err}")
            same_shape = max(same_shape, err)
        else:
            check(same, f"{label}: a wave's codes differ from offline")
    xs = np.concatenate([x for x, _, _ in rec.waves])
    ys = torch.cat([y[:x.shape[0]] for x, y, _ in rec.waves])
    want = cm.offline(xs)
    if want.dtype.is_floating_point:
        cross = float((ys - want).abs().max())
    else:
        check(torch.equal(ys, want), f"{label}: served codes differ from "
                                     f"offline of all rows")
        cross = 0.0
    if results is not None:
        check(np.array_equal(np.stack(results), ys.cpu().numpy()),
              f"{label}: the router's results differ from its waves' rows")
    return {"waves": len(rec.waves), "same_shape_bitwise": bitwise,
            "worst_same_shape": same_shape, "worst_cross_shape": cross,
            "max_abs": float(want.abs().max()) if want.numel() else 0.0}


def _held_words(*held):
    """One log phrase for ``_hold_waves`` summaries."""
    hs = [h for h in held if h is not None]
    if all(h["same_shape_bitwise"] and h["worst_cross_shape"] == 0
           for h in hs):
        return "every served row equals offline bit for bit"
    return (f"every wave's logits equal offline of the same wave within "
            f"1e-5 (bit for bit: "
            f"{[h['same_shape_bitwise'] for h in hs]}, worst "
            f"{max(h['worst_same_shape'] for h in hs):.3g}); against "
            f"offline of all served rows at once the worst difference is "
            f"{max(h['worst_cross_shape'] for h in hs):.6g} of max "
            f"|logit| {max(h['max_abs'] for h in hs):.6g}")


def _wave_stream_ms(cm, x, mb, reps=20):
    """Median ms between CUDA events around one ``submit_wave`` of ``x``
    on the current stream: the wave's span on the card, its host-to-card
    copy included (a wave copies host data, so it cannot be captured in
    a CUDA graph)."""
    import torch

    ms = []
    for _ in range(reps + 2):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        cm.submit_wave(x, micro_batch=mb)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms[2:])


def phase_serving(models, tuned, smi):
    """The serving stack on the four tuned full-width models.

    Operating point: ``slo_micro_batch`` and ``serve_bench.bench_model``
    (load fractions ``SERVE_FRACTIONS``): the SLO micro-batch, the p99
    budget, the saturation measured through the router, and per load
    point p50/p90/p99, achieved qps, shed rate and occupancy. Then, per
    model and for both its logits (``cm``) and its codes (``_headless``):
    ``server_streaming`` under ``SyncEngine`` with ``SERVE_QUERIES``
    Poisson queries at ``SERVE_LOAD`` of the saturation, and the same
    trace through a ``Router`` over a two-replica ``ReplicaPool`` on the
    one card (two streams sharing the executor) under ``AsyncEngine``;
    counters set to 0 before each run and read after: K1/K2/K3 launches
    must equal the waves served times one counted ``submit_wave``'s
    launches (plus the scenario's own ``offline`` check); every wave's
    rows and every request's result are held against ``offline`` (codes
    bit for bit, logits within 1e-5), beside ``server_streaming``'s own
    ``bit_exact_vs_offline``; the async run's highest in-flight count and
    dispatch spans' platform ("gpu") are read from its trace. KWS
    compiled staged (``megakernel=False``) runs the same sync trace, so
    K1 (3 launches a wave) serves too. The ``TinyModelServer`` shim
    serves all four tenants under ``AsyncEngine``, ``SHIM_REQUESTS`` each,
    every result equal to ``offline``. Last, KWS's codes on a two-replica
    pool under ``faulty_pool`` (one ``replica_crash`` on replica 0, one
    ``corrupt_output`` on replica 1): no admitted request lost, no
    corrupt row served, the fault counts those of the plan. Returns the
    readings."""
    import numpy as np
    import torch
    from repro_torch.bench.serve_bench import bench_model
    from repro_torch.deploy import compile_graph
    from repro_torch.deploy.autotune import slo_micro_batch
    from repro_torch.deploy.scenarios import server_streaming
    from repro_torch.obs import Tracer, timer
    from repro_torch.serve import (AsyncEngine, FaultPlan, FaultSpec,
                                   ReplicaPool, Router, RouterConfig,
                                   SyncEngine, faulty_pool, poisson_trace)
    from repro_torch.serving.engine import TinyModelServer

    dev = torch.device("cuda")
    out = {"card": smi, "models": {}}
    for n, g, s, x in models:
        cm = tuned[n]
        mk = (lambda xx: lambda i: xx[i % len(xx)])(x)
        res = bench_model(n, cm, mk, n_queries=SERVE_CURVE_QUERIES,
                          fractions=SERVE_FRACTIONS)
        slo = slo_micro_batch(cm, res["p99_budget_ms"])
        mb, sat = res["micro_batch"], res["measured_saturation_qps"]
        for c in res["curve"]:
            log(f"serving {n} curve ({smi}): load {c['load_fraction']}, "
                f"offered {c['offered_qps']:.1f} qps, achieved "
                f"{c['achieved_qps']:.1f} qps, p50 {c['p50_ms']:.6f} ms, "
                f"p90 {c['p90_ms']:.6f} ms, p99 {c['p99_ms']:.6f} ms, shed "
                f"{c['shed_rate']:.4f}, occupancy "
                f"{c['wave_occupancy']:.4f}, met SLO {c['met_slo']}, "
                f"bit_exact_vs_offline {c['bit_exact_vs_offline']}")
        log(f"serving {n} operating point ({smi}): SLO micro-batch "
            f"{slo['micro_batch']} (slo_micro_batch at the "
            f"{res['p99_budget_ms']:.3f} ms budget; tuned "
            f"{cm.default_micro_batch}), bench wave {mb} at a quarter of "
            f"the budget, wave service {res['wave_service_ms']:.6f} ms, "
            f"measured saturation {sat:.1f} qps, operating point "
            + (f"{res['operating_point']['achieved_qps']:.1f} qps at load "
               f"{res['operating_point']['load_fraction']}"
               if res["operating_point"] else "none inside the SLO"))
        qps = SERVE_LOAD * sat
        trace = poisson_trace(qps=qps, n=SERVE_QUERIES, seed=SEED)
        runs = {}
        for label, model in (("logits", cm), ("codes", _headless(cm))):
            per_wave = _counted(lambda: model.submit_wave(x[:1],
                                                          micro_batch=mb))
            per_off = _counted(lambda: model.offline(x[:SERVE_QUERIES]))
            # sync: the MLPerf Server scenario over the router
            rec = _WaveRecorder(model)
            sync_trace = Tracer()
            _reset_launches()
            with _GcTimer() as gc_sync:
                rep = server_streaming(rec, mk, qps=qps,
                                       n_queries=SERVE_QUERIES, seed=SEED,
                                       micro_batch=mb, engine=SyncEngine(),
                                       warmup=1, tracer=sync_trace)
            got = _launches_now()
            held = _hold_waves(rec, f"{n} {label} sync waves")
            want = _add(_times(per_wave, held["waves"]), per_off)
            check(got == want, f"{n} {label} sync: launches {got}, "
                               f"expected {want} ({held['waves']} waves)")
            check(rep.extras.get("bit_exact_vs_offline") is True,
                  f"{n} {label} sync: server_streaming's "
                  f"bit_exact_vs_offline is "
                  f"{rep.extras.get('bit_exact_vs_offline')}")
            sync = {"report": rep.row(), "launches": got,
                    "per_wave": per_wave, "held": held,
                    "submit_ms_max": max(rec.submit_ms), "gc": gc_sync.row(),
                    "wave_service_p50_ms": statistics.median(
                        e.dur for e in sync_trace.spans("wave")) * 1e3,
                    "bit_exact_vs_offline":
                        rep.extras.get("bit_exact_vs_offline")}
            # async: two replicas, two streams, one executor
            rec = _WaveRecorder(model)
            tracer = Tracer()
            pool = ReplicaPool(factory=lambda: rec, devices=[dev, dev])
            check(pool.replicas[0].stream is not None
                  and pool.replicas[0].stream != pool.replicas[1].stream,
                  f"{n}: the two replicas share a stream")
            router = Router({n: pool}, RouterConfig(micro_batch=mb),
                            tracer=tracer, engine=AsyncEngine())
            pool.warm(x[:1], micro_batch=mb)     # each stream's first wave
            rec.waves.clear()
            rec.submit_ms.clear()
            _reset_launches()
            t0 = timer.now()
            with _GcTimer() as gc_async:
                reqs = router.run_trace(n, trace, mk)
            got = _launches_now()
            wall = timer.now() - t0
            served = [r for r in reqs if not r.shed]
            check(len(served) == SERVE_QUERIES,
                  f"{n} {label} async: {len(served)} of {SERVE_QUERIES} "
                  f"served")
            held_a = _hold_waves(rec, f"{n} {label} async waves",
                                 results=[r.result for r in reqs])
            waves = held_a["waves"]
            check(got == _times(per_wave, waves),
                  f"{n} {label} async: launches {got}, expected "
                  f"{_times(per_wave, waves)} ({waves} waves)")
            snap = router.stats()[n]["metrics"]
            peak = max(e.value for e in tracer.counters("inflight"))
            platforms = {e.args["platform"] for e in tracer.spans("wave")}
            check(platforms == {"gpu"}, f"{n}: wave spans stamped "
                                        f"{platforms}")
            lats = np.asarray([r.latency_s for r in served]) * 1e3
            asyn = {"row": snap.row(), "waves": waves, "launches": got,
                    "per_wave": per_wave, "max_inflight": peak,
                    "p50_ms": float(np.percentile(lats, 50)),
                    "p90_ms": float(np.percentile(lats, 90)),
                    "p99_ms": float(np.percentile(lats, 99)),
                    "qps": len(served) / max(wall, 1e-9), "held": held_a,
                    "submit_ms_median": statistics.median(rec.submit_ms),
                    "submit_ms_max": max(rec.submit_ms),
                    "gc": gc_async.row(),
                    "dispatched": [r.n_dispatched for r in pool.replicas]}
            runs[label] = {"sync": sync, "async": asyn}
            log(f"serving {n} {label} ({smi}): {SERVE_QUERIES} Poisson "
                f"queries at {qps:.1f} qps, wave {mb}; sync "
                f"(server_streaming): p50 {rep.p50_ms:.6f} ms, p90 "
                f"{rep.p90_ms:.6f} ms, p99 {rep.p99_ms:.6f} ms, "
                f"{rep.throughput_qps:.1f} qps, {held['waves']} waves, "
                f"occupancy {rep.extras['wave_occupancy']:.4f}, wave "
                f"service p50 {sync['wave_service_p50_ms']:.6f} ms; "
                f"async x2 streams: p50 {asyn['p50_ms']:.6f} ms, p90 "
                f"{asyn['p90_ms']:.6f} ms, p99 {asyn['p99_ms']:.6f} ms, "
                f"{asyn['qps']:.1f} qps, {waves} waves "
                f"({asyn['dispatched']} per replica), occupancy "
                f"{snap.mean_occupancy:.4f}, wave service p50 "
                f"{snap.wave_service_p50_ms:.6f} ms, highest in flight "
                f"{peak:.0f}, submit_wave host ms median "
                f"{asyn['submit_ms_median']:.6f} max "
                f"{asyn['submit_ms_max']:.6f} (sync max "
                f"{sync['submit_ms_max']:.6f}), gc "
                f"{json.dumps(gc_async.row())} (sync "
                f"{json.dumps(gc_sync.row())}); K1/K2/K3 launches a wave "
                f"{per_wave}, sync "
                f"{sync['launches']}, async {got}; " + _held_words(
                    held, held_a)
                + f"; server_streaming bit_exact_vs_offline "
                f"{sync['bit_exact_vs_offline']}")
        wave_ms = _wave_stream_ms(cm, x[:mb], mb)
        log(f"serving {n} ({smi}): one {mb}-row submit_wave spans "
            f"{wave_ms:.6f} ms on the card (CUDA events, copy included)")
        out["models"][n] = {
            "slo_micro_batch": slo["micro_batch"],
            "slo_candidates": slo["candidates"],
            "bench": {k: res[k] for k in (
                "micro_batch", "p99_budget_ms", "max_wait_ms",
                "measured_saturation_qps", "wave_service_ms", "curve",
                "operating_point")},
            "offered_qps": qps, "runs": runs, "wave_stream_ms": wave_ms}

    # KWS staged: K1 on the serve path
    n, g, s, x = models[0]
    staged = _headless(compile_graph(g, in_scale=s, device="cuda",
                                     megakernel=False))
    mb = out["models"][n]["bench"]["micro_batch"]
    qps = out["models"][n]["offered_qps"]
    per_wave = _counted(lambda: staged.submit_wave(x[:1], micro_batch=mb))
    per_off = _counted(lambda: staged.offline(x[:SERVE_QUERIES]))
    check(per_wave == (3, 0, 0), f"staged KWS launches {per_wave} a wave")
    rec = _WaveRecorder(staged)
    _reset_launches()
    rep = server_streaming(rec, lambda i: x[i % len(x)], qps=qps,
                           n_queries=SERVE_QUERIES, seed=SEED,
                           micro_batch=mb, engine=SyncEngine(), warmup=1)
    got = _launches_now()
    waves = _hold_waves(rec, "kws staged sync waves")["waves"]
    check(got == _add(_times(per_wave, waves), per_off),
          f"kws staged: launches {got} for {waves} waves")
    out["kws_staged"] = {"report": rep.row(), "waves": waves,
                         "launches": got, "per_wave": per_wave}
    log(f"serving kws staged ({smi}): p50 {rep.p50_ms:.6f} ms, p99 "
        f"{rep.p99_ms:.6f} ms, {rep.throughput_qps:.1f} qps, {waves} waves, "
        f"K1 {got[0]} launches ({per_wave[0]} a wave), codes equal offline "
        f"bit for bit")

    # the shim: four tenants, one router lane each
    recs = {m: _WaveRecorder(tuned[m]) for m, *_ in models}
    server = TinyModelServer(recs, engine=AsyncEngine())
    for m, _, _, xx in models:
        server.router.lanes[m].pool.warm(xx[:1])
        recs[m].waves.clear()
    reqs = {m: [server.submit(m, xx[i]) for i in range(SHIM_REQUESTS)]
            for m, _, _, xx in models}
    steps = server.run_until_drained()
    held = {}
    for m, *_ in models:
        check(all(r.result is not None for r in reqs[m]),
              f"shim: {m} has unserved requests")
        held[m] = _hold_waves(recs[m], f"shim {m}",
                              results=[r.result for r in reqs[m]])
    shim = {k: v for k, v in server.stats().items()}
    out["shim"] = {"steps": steps, "stats": shim, "held": held}
    log(f"serving shim ({smi}): TinyModelServer, {len(models)} tenants "
        f"x {SHIM_REQUESTS} requests under AsyncEngine in {steps} steps; "
        + "; ".join(f"{m}: {_held_words(h)}"
                    for m, h in held.items())
        + f"; {json.dumps(shim)}")

    # faults: a crash and a corrupt wave on a two-replica pool
    n, g, s, x = models[0]
    head = _headless(tuned[n])
    mb = out["models"][n]["bench"]["micro_batch"]
    plan = FaultPlan([FaultSpec("replica_crash", replica=0, wave=1,
                                duration_s=0.0),
                      FaultSpec("corrupt_output", replica=1, wave=1)])
    pool = ReplicaPool(factory=lambda: head, devices=[dev, dev])
    pool.warm(x[:1], micro_batch=mb)
    pool = faulty_pool(pool, plan)
    router = Router({n: pool}, RouterConfig(micro_batch=mb,
                                            retry_backoff_ms=0.5,
                                            max_retries=2),
                    engine=AsyncEngine())
    reqs = router.run_trace(n, poisson_trace(
        qps=out["models"][n]["offered_qps"], n=FAULT_QUERIES, seed=SEED + 1),
        lambda i: x[i % len(x)])
    snap = router.stats()[n]["metrics"]
    lost = [r.uid for r in reqs if r.shed or r.result is None]
    check(not lost, f"faults: admitted requests lost or shed: {lost[:8]}")
    _hold(head, np.stack([r.x for r in reqs]),
          np.stack([r.result for r in reqs]), "faults: served rows")
    injected = [r.model.n_injected for r in pool.replicas]
    check(injected == [1, 1] and snap.fault_counts == {
        "submit_error": 1, "integrity": 1},
        f"faults: injected {injected}, counted {snap.fault_counts}")
    out["faults"] = {"row": snap.row(), "injected": injected,
                     "health": [r.health for r in pool.replicas]}
    log(f"serving faults ({smi}): kws codes, 2 replicas, one replica_crash "
        f"(replica 0) and one corrupt_output (replica 1) in "
        f"{FAULT_QUERIES} queries: none lost, no corrupt row served, every "
        f"row equals offline bit for bit; fault counts "
        f"{json.dumps(snap.fault_counts)}, p99 {snap.p99_ms:.6f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 17: quantization-aware training on the card
# ---------------------------------------------------------------------------

def _ste_cases():
    """Seeded inputs for the straight-through functions: uniform values,
    exact halves (round half to even) and the clip / sign edges."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    x = torch.rand(4096, generator=g) * 8 - 4
    edges = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -1.0, 1.0, 0.0,
                          -0.0, 2.0, -2.0])
    return torch.cat([x, edges]), torch.randn(4096 + 12, generator=g)


def phase_qat(smi, seeded_nonzero):
    """Quantization-aware training on the card, then what it trained on
    the kernels. (1) ``ste_round`` / ``ste_clip`` / ``ste_sign`` forward
    and backward on the card equal the CPU bit for bit. (2) The quickstart
    trains its 4-bit MLP, streamlines it and runs the stages through
    ``threshold_matmul`` (K1): every stage's codes equal the plain
    version's. (3) Table 1's trainings at full width (KWS 490-256x3-12,
    3-bit, 150 steps; AD 128-72-72-8-72-72-128, 8-bit, 120 steps): each
    step's host ms (synchronised), first and last loss, the QAT
    accuracy / AUC; then each trained model exported with frozen scales
    and compiled in both modes, counters set to 0 around one ``offline``
    of the evaluation batch (auto: K3 once; staged: K1 3 / 5; the float
    head once), the deployed accuracy / AUC; the deployed codes of every
    stage (the last one by the mode's own dispatch: K3 or K1) equal the
    streamlined float reference (``float_ref_dense`` chained at the frozen
    scales, the MLP exports' oracle of ``tests/test_golden.py``) bit for
    bit, in both modes, and the codes ``Graph.run`` gives with the frozen
    scales (its Dense nodes keep the float weights) are counted beside;
    the share of nonzero codes per stage beside the seeded models'
    (``seeded_nonzero``, phase 3). Returns the readings."""
    import numpy as np
    import torch
    from repro_torch.bench import table1_models as t1
    from repro_torch.core import quantizers as q
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops

    out = {"card": smi}
    # (1) the STE functions' forward and backward, card against CPU
    x, g = _ste_cases()
    for name, fn in (("ste_round", q.ste_round),
                     ("ste_clip", lambda v: q.ste_clip(v, -1.0, 2.0)),
                     ("ste_sign", q.ste_sign)):
        res = []
        for dev in ("cpu", "cuda"):
            xd = x.detach().clone().to(dev).requires_grad_(True)
            y = fn(xd)
            y.backward(g.to(dev))
            res.append((y.detach().cpu(), xd.grad.cpu()))
        check(torch.equal(res[0][0], res[1][0])
              and torch.equal(res[0][1], res[1][1]),
              f"{name}: forward or gradient on the card differs from the "
              f"CPU")
    log(f"qat ste ({smi}): ste_round, ste_clip, ste_sign forward and "
        f"backward on the card equal the CPU bit for bit on "
        f"{x.numel()} seeded values")

    # (2) the quickstart: train, streamline, K1
    ops.reset_launches()
    t0 = _now()
    qs = quickstart.run("cuda", verbose=False)
    torch.cuda.synchronize()
    qs_s = _now() - t0
    for i, (a, b) in enumerate(zip(qs["codes"], qs["plain_codes"])):
        check(torch.equal(a, b), f"quickstart stage {i}: K1 codes differ "
                                 f"from the plain version")
    check(ops.launches["threshold_matmul"] == len(qs["stages"]),
          f"quickstart launched K1 {ops.launches['threshold_matmul']} "
          f"times for {len(qs['stages'])} stages")
    out["quickstart"] = {"loss_first": qs["losses"][0],
                         "loss_last": qs["losses"][-1],
                         "acc_float": qs["acc_float"],
                         "acc_kernel": qs["acc_kernel"], "seconds": qs_s}
    log(f"qat quickstart ({smi}): loss {qs['losses'][0]:.6f} -> "
        f"{qs['losses'][-1]:.6f}, float QAT accuracy {qs['acc_float']:.4f},"
        f" integer accuracy on K1 {qs['acc_kernel']:.4f} "
        f"({len(qs['stages'])} stages, K1 codes equal the plain version), "
        f"{qs_s:.3f} s")

    # (3) Table 1's two trainings at full width, then their deployment
    want = {"kws": {"auto": (0, 0, 1), "staged": (3, 0, 0)},
            "ad": {"auto": (0, 0, 1), "staged": (5, 0, 0)}}
    for name, train in (("kws", t1.train_kws), ("ad", t1.train_ad)):
        t0 = _now()
        r = train(device="cuda")
        train_s = _now() - t0
        dep = t1.deploy(r, name, "cuda")
        xe, ye = r["eval"]
        x_int = t1.quantize_input(xe, dep["in_scale"])
        oracle = t1.float_ref_codes(dep["graph"], x_int, dep["in_scale"])
        graph = t1.graph_codes(dep["graph"], x_int, dep["in_scale"],
                               device="cuda")
        row = {"steps": len(r["losses"]),
               "step_ms_median": statistics.median(r["step_ms"]),
               "steps_per_s": 1e3 / statistics.median(r["step_ms"]),
               "train_s": train_s, "loss_first": r["losses"][0],
               "loss_last": r["losses"][-1], "qat_quality": r["quality"],
               "in_scale": dep["in_scale"], "modes": {}}
        for mode, (cm, quality) in dep["modes"].items():
            xc = torch.as_tensor(x_int).cuda()
            _reset_launches()
            y = cm.offline(xc)
            got = _launches_now()
            heads = ops.launches[HEAD_KERNEL]
            check(got == want[name][mode] and heads == 1,
                  f"qat {name}[{mode}]: launches {got} and {heads} heads, "
                  f"expected {want[name][mode]} and 1")
            codes = [o.cpu().numpy() for o in cm.stage_outputs(xc)[:-1]]
            codes[-1] = _headless(cm).offline(xc).cpu().numpy()  # K3 / K1
            check(len(codes) == len(oracle) == len(graph),
                  f"qat {name}: {len(codes)} stages, {len(oracle)} oracle "
                  f"stages, {len(graph)} Quant nodes")
            for i, (c, fc) in enumerate(zip(codes, oracle)):
                check(np.array_equal(c, fc), f"qat {name}[{mode}] stage {i}: "
                      f"deployed codes differ from the streamlined float "
                      f"reference in {int((c != fc).sum())} of {c.size}")
            off_graph = [int((c != gc).sum()) for c, gc in zip(codes, graph)]
            check(y.shape == (len(ye), xe.shape[1] if name == "ad" else 12)
                  and bool(torch.isfinite(y).all()),
                  f"qat {name}[{mode}]: logits {tuple(y.shape)}, finite "
                  f"{bool(torch.isfinite(y).all())}")
            nz = [float((c > 0).mean()) for c in codes]
            row["modes"][mode] = {"quality": quality, "launches": got,
                                  "nonzero_share": nz,
                                  "codes_off_graph_run": off_graph}
        out[name] = row
        log(f"qat {name} ({smi}): {row['steps']} steps, step "
            f"{row['step_ms_median']:.6f} ms median ({row['steps_per_s']:.1f}"
            f" steps/s, host clock, synchronised), {train_s:.3f} s in all; "
            f"loss {row['loss_first']:.6f} -> {row['loss_last']:.6f}; QAT "
            f"{'accuracy' if name == 'kws' else 'AUC'} "
            f"{row['qat_quality']:.4f}, deployed (input scale "
            f"{dep['in_scale']}) auto {row['modes']['auto']['quality']:.4f} "
            f"(K1/K2/K3 {row['modes']['auto']['launches']}), staged "
            f"{row['modes']['staged']['quality']:.4f} (K1/K2/K3 "
            f"{row['modes']['staged']['launches']}); every stage's codes "
            f"equal the streamlined float reference (float_ref_dense at the "
            f"frozen scales) in both modes; codes that differ from "
            f"Graph.run (float weights) per stage {off_graph} of "
            f"{[c.size for c in codes]}; nonzero code share per stage "
            f"{[round(v, 4) for v in nz]}, seeded model's "
            f"{seeded_nonzero.get(name)}")
    return out


#: rows of Table 6's Offline pool of a conv model (the bench's full count):
#: the batch K1's im2col launches are held and timed at
TABLE6_CONV_ROWS = 48


class _Recorder:
    """Wraps one ``kernels.ops`` wrapper while active: every call's
    arguments are kept (the call still goes through the counted
    wrapper)."""

    def __init__(self, name):
        from repro_torch.kernels import ops

        self.ops, self.name, self.calls = ops, name, []
        self.real = getattr(ops, name)

    def __enter__(self):
        def record(*a, **k):
            self.calls.append((a, k))
            return self.real(*a, **k)
        setattr(self.ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.real)
        return False


def phase_im2col_k1(entries, smi):
    """K1 on the im2col lowering of full-width IC and CNV: counters set to 0
    around one eager ``offline`` (``_run_all``) of Table 6's Offline pool
    (48 rows) under
    ``conv_lowering="im2col"``; K1 launches one a conv stage (and CNV's
    hidden FCs run on K3 in auto dispatch); each K1 launch, on the patch
    matrix it was given, equals ``ref.threshold_matmul_ref`` bit for bit
    and is timed (CUDA-graph replay) beside K2's launches of the direct
    lowering on the same pool; the two lowerings' outputs are equal.
    Returns per model the launches and the summed device ms."""
    import numpy as np
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.kernels import ops, ref

    out = {}
    for name in ("IC-hls4ml", "IC-FINN-CNV"):
        cm, mk, _ = entries[name]
        x = torch.as_tensor(np.stack([mk(i) for i in range(TABLE6_CONV_ROWS)]),
                            device=cm.device)
        i2c = compile_graph(cm.graph, in_scale=cm.graph.meta["in_scale"],
                            device=cm.device, conv_lowering="im2col")
        n_conv = cm.schedule.n_fused_conv
        # ``offline``'s function run eagerly: a graph's replay (or its
        # capture) would pass the wrappers by (or twice)
        with _Recorder("threshold_matmul") as k1:
            _reset_launches()
            y_i2c = i2c._run_all(x)
            got = _launches_now()
        with _Recorder("conv_threshold") as k2:
            _reset_launches()
            y_dir = cm._run_all(x)
            got_dir = _launches_now()
        check(torch.equal(y_i2c, y_dir),
              f"{name}: im2col and direct lowerings differ")
        check(got[0] == len(k1.calls) >= n_conv and got[1] == 0
              and got_dir[1] == len(k2.calls) == n_conv,
              f"{name}: im2col launches {got} ({len(k1.calls)} recorded) "
              f"and direct {got_dir} for {n_conv} conv stages")
        conv_calls = k1.calls[:n_conv]     # the conv stages come first
        k1_ms, k2_ms, shapes = 0.0, 0.0, []
        for a, kw in k1.calls:
            xk, w, t = a
            y_k, y_p = ops.threshold_matmul(xk, w, t, **kw), \
                ref.threshold_matmul_ref(xk, w, t)
            check(torch.equal(y_k, y_p),
                  f"{name}: K1 on the im2col patches (M={xk.shape[0]} "
                  f"K={xk.shape[1]} N={w.shape[1]}) differs from its plain "
                  f"version by {int((y_k - y_p).abs().max())}")
        for a, kw in conv_calls:
            xk, w, t = a
            k1_ms += time_ms(lambda: ops.threshold_matmul(xk, w, t, **kw))
            shapes.append(f"M={xk.shape[0]} K={xk.shape[1]} "
                          f"N={w.shape[1]} S={t.shape[1]}")
        for a, kw in k2.calls:
            k2_ms += time_ms(lambda: ops.conv_threshold(*a, **kw))
        out[name] = {"k1_launches": got[0], "k3_launches": got[2],
                     "k1_conv_launches": len(conv_calls),
                     "k1_conv_ms": k1_ms, "k2_launches": got_dir[1],
                     "k2_ms": k2_ms, "k1_shapes": shapes}
        log(f"paper benches {name} im2col ({smi}): K1 {got[0]} launches "
            f"({len(conv_calls)} on conv patch matrices, each equal to its "
            f"plain version bit for bit; {shapes}), K3 {got[2]}; K1's conv "
            f"launches {k1_ms:.6f} ms against K2's {got_dir[1]} direct "
            f"launches {k2_ms:.6f} ms on {TABLE6_CONV_ROWS} rows (device "
            f"time); im2col output equals direct")
    return out


def phase_paper_benches(smi):
    """The paper's remaining tables and the port's benches on the card
    (phase 18): Table 2 (the FIFO pass, host only); Table 3 (the fusion
    ladder: aten graph ops on the input's path, the caching allocator's
    peak, device time); K1 on the im2col lowering of IC and CNV
    (``phase_im2col_k1``); Table 6 at its full query counts on the four
    full-width models, counters set to 0 before it and read after (K1, K2,
    K3 and the float head each launched), every equality it asserts (direct
    == im2col, offline == host == compiled, ServerStreaming bit-exact);
    the obs bench (the NullTracer bar, 1.02) at ``REPRO_FAST`` counts; the
    megakernel residency check. The cost-model bench is not run here: its
    LOMO and agreement bars fail on the card (``PERF.md`` §6). The
    artifacts go to ``chiprun_out/`` (``BENCH_torch_scenarios.json``,
    ``BENCH_torch_obs.json``, ``TRACE_torch_serve.json``). Returns the
    readings."""
    from repro_torch.bench import (check_megakernel_residency, obs_bench,
                                   table2_fifo, table3_fusion,
                                   table6_scenarios)
    from repro_torch.bench.common import emit_json
    from repro_torch.kernels import ops

    t_start = _now()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    saved = os.environ.get("REPRO_BENCH_DIR")
    os.environ["REPRO_BENCH_DIR"] = out_dir
    res = {"card": smi}
    try:
        with tempfile.TemporaryDirectory(
                prefix="autotune-", dir=os.path.join(ROOT, "build")) as tune:
            rows2 = table2_fifo.run()
            res["table2"] = [r["derived"] for r in rows2]
            rows3 = table3_fusion.run()
            res["table3"] = {r["name"]: dict(r["derived"],
                                             us_per_call=r["us_per_call"])
                             for r in rows3}
            d3 = [r["derived"] for r in rows3]
            check(d3[2]["graph_ops"] < d3[0]["graph_ops"]
                  and d3[3]["buffer_elems"] < d3[0]["buffer_elems"]
                  and all(d["temp_bytes"] is not None for d in d3),
                  f"table3: the ladder does not shrink: {d3}")

            entries = table6_scenarios.build_entries()
            res["im2col_k1"] = phase_im2col_k1(entries, smi)
            _reset_launches()
            t0 = _now()
            rows6, doc6 = table6_scenarios.run_entries(entries, fast=False,
                                                       tune_dir=tune)
            launches = dict(ops.launches)
            res["table6_s"] = _now() - t0
            check(all(launches[k] > 0 for k in TINY_KERNELS + (HEAD_KERNEL,)),
                  f"table6 launched {launches}")
            res["table6_launches"] = {k: launches[k] for k in
                                      TINY_KERNELS + (HEAD_KERNEL,)}
            emit_json("BENCH_torch_scenarios.json", doc6, out_dir)
            res["table6"] = doc6
            log(f"paper benches table6 ({smi}): {res['table6_s']:.3f} s, "
                f"launches {json.dumps(res['table6_launches'])}; direct == "
                f"im2col on IC and CNV, offline == host == compiled and "
                f"ServerStreaming bit-exact on all four models")

            rows_o, doc_o = obs_bench.run_entries(
                obs_bench.build_entries(fast=True), fast=True)
            emit_json("BENCH_torch_obs.json", doc_o, out_dir)
            res["obs"] = doc_o
            rc = check_megakernel_residency.main([])
            check(rc == 0, "megakernel residency check failed")
    finally:
        if saved is None:
            os.environ.pop("REPRO_BENCH_DIR", None)
        else:
            os.environ["REPRO_BENCH_DIR"] = saved
    res["seconds"] = _now() - t_start
    ov = next(iter(doc_o["null_overhead"].values()))
    log(f"paper benches ({smi}): {res['seconds']:.3f} s in all; NullTracer "
        f"ratio {ov['overhead_ratio']:.6f} (bar {ov['budget_ratio']}), "
        f"wall ratio {ov['wall_ratio']:.4f}, {ov['n_guarded_sites']} guarded "
        f"sites a call; residency check clean")
    return res


# ---------------------------------------------------------------------------
# phase 19: LM training (K6's backward kernel)
# ---------------------------------------------------------------------------

TRAIN_CONFIG = "internlm2-1.8b"
TRAIN_SEQ = 4096                 # the reference's train_4k length: K6 path
TRAIN_BATCH = 4                  # sequences a step ...
TRAIN_MICROBATCHES = 2           # ... in 2 microbatches of 2
TRAIN_STEPS = 8
TRAIN_CUT_LAYERS = 2             # depth of the resume and QAT runs
TRAIN_CUT_STEPS = 5
TRAIN_CRASH_AT = 3
#: K6's backward against its plain version: max |kernel - plain| over the
#: largest |plain gradient| of each of dQ, dK, dV (bf16 in the manner of
#: the forward's 2e-2; float32 computes in float32 on both sides)
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: (B, H, Hkv, Sq, Sk, D, causal, window, q_offset, kv_len): ragged
#: lengths, GQA groups of 1, 2 and 4, windows, query offsets (a decode
#: chunk, and -3: rows with no live key), kv_len down to 0, each head dim;
#: Sq and Sk on both sides of the bf16 route's 64- and 128-row tiles
FLASH_BWD_CASES = [
    (2, 8, 8, 130, 130, 16, True, 0, 0, None),
    (1, 8, 4, 257, 257, 80, True, 32, 0, None),
    (2, 8, 2, 17, 95, 128, True, 0, 78, None),
    (1, 4, 2, 129, 255, 128, False, 70, 100, 200),
    (1, 4, 1, 100, 100, 80, False, 0, 0, None),
    (1, 4, 2, 255, 255, 16, True, 0, 0, None),
    (1, 2, 2, 5, 5, 16, True, 0, -3, None),
    (1, 4, 2, 64, 64, 128, True, 0, 0, 0),
    (1, 16, 8, 1024, 1024, 128, True, 0, 0, None),
    *[(1, 4, 2, s, s, 128, True, 0, 0, None)
      for s in (63, 64, 65, 127, 128, 129, 255)],
    (1, 8, 2, 127, 65, 80, False, 0, 0, None),
    (2, 8, 4, 16, 255, 128, True, 0, 239, None),
    (1, 4, 2, 128, 128, 128, True, 0, -3, None),
    (1, 4, 2, 129, 128, 16, False, 33, 7, 100),
    (1, 4, 2, 65, 129, 80, True, 0, 0, 0),
]
#: K6's backward per launch at the training shape before its redesign:
#: the CUDA-core kernel on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md, §6)
K6_BWD_CUDA_CORE_MS = 30.500383


def _bwd_err(got, want):
    """(max |got - want| over dQ, dK, dV, the worst of them relative to
    its largest |want|)."""
    abs_err = rel = 0.0
    for a, b in zip(got, want):
        e = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        scale = float(b.float().abs().max()) if b.numel() else 0.0
        abs_err = max(abs_err, e)
        rel = max(rel, e / scale if scale > 0 else e)
    return abs_err, rel


def _check_bwd(label, q, k, v, out, lse, do, kw, got):
    """Hold one backward launch's (dq, dk, dv) against the plain version on
    the same inputs. Returns the max |kernel - plain|."""
    from repro_torch.kernels import ref

    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for a, b in zip(got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{label}: {a.dtype} {tuple(a.shape)} against {b.dtype} "
              f"{tuple(b.shape)}")
        check(bool(a.isfinite().all()), f"{label}: non-finite gradient")
    abs_err, rel = _bwd_err(got, want)
    tol = FLASH_BWD_TOL[str(q.dtype).replace("torch.", "")]
    check(rel <= tol, f"{label}: K6 backward off its plain version by "
                      f"{rel:.3g} of the largest gradient (tol {tol})")
    log(f"kernel-check flash_attention_bwd {label}: max err {abs_err:.3g}, "
        f"{rel:.3g} of the largest |gradient| (tol {tol})")
    return abs_err


def phase_flash_bwd_synthetic():
    """K6's backward kernel against its plain version over
    ``FLASH_BWD_CASES`` in both dtypes, on strided (B, S, H, D) views;
    the forward kernel's lse against the plain lse; each call launched
    once, and a second call equal bit for bit (no atomics). Returns the
    worst |kernel - plain|."""
    import torch
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for b, h, hkv, sq, sk, d, causal, window, q_off, kv_len in \
            FLASH_BWD_CASES:
        kw = dict(causal=causal, window=window, q_offset=q_off,
                  kv_len=kv_len)
        for dtype in FLASH_BWD_TOL:
            dt = getattr(torch, dtype)
            q, k, v, do = (
                torch.randn(b, s, n, d, generator=g, device="cuda").to(dt)
                .transpose(1, 2)
                for s, n in ((sq, h), (sk, hkv), (sk, hkv), (sq, h)))
            out, lse = ops._flash_forward(q, k, v, causal, window, q_off,
                                          sk if kv_len is None else kv_len,
                                          want_lse=True)
            _, lse_want = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                  **kw)
            live = torch.isfinite(lse_want)
            check(torch.equal(torch.isfinite(lse), live),
                  "K6's lse is +inf exactly on the rows with no live key")
            if bool(live.any()):
                torch.testing.assert_close(lse[live], lse_want[live],
                                           rtol=1e-5, atol=1e-4)
            before = ops.launches["flash_attention_bwd"]
            got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            check(ops.launches["flash_attention_bwd"] == before + 2,
                  "flash_attention_bwd launched once a call")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  "K6's backward is not deterministic")
            label = (f"B={b} H={h}/{hkv} Sq={sq} Sk={sk} D={d} "
                     f"causal={causal} window={window} q_offset={q_off} "
                     f"kv_len={kv_len} {dtype}")
            worst = max(worst, _check_bwd(label, q, k, v, out, lse, do, kw,
                                          got))
            del q, k, v, do, out, lse, got, again
    torch.cuda.empty_cache()
    return worst


def _train_state(cfg, seed, opt):
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.steps import TrainState

    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    return model, TrainState(params, opt.init(params))


def _bwd_case(q, k, v, out, lse, do, kw, launches, model=TRAIN_CONFIG,
              stage="train layer 0"):
    """K6 backward's timing row on one launch's inputs: kernel, plain
    version and SDPA's backward (the library yardstick: one autograd pass
    through ``scaled_dot_product_attention`` on the same q, k, v and dO,
    timed eagerly by CUDA events), with the bound from the bytes read and
    written once and 5 products of 2 D operations per live pair; the
    kernel's own count (7 products: S and dP are recomputed in the dQ
    kernel) is logged beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = flash_live_pairs(sq, sk, kw["causal"], kw["window"],
                             kw["q_offset"], kw.get("kv_len"))
    esize = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * esize + lse.numel() * 4
    nops = k6_bwd_ops(b, h, d, pairs)
    row = {"kernel": "flash_attention_bwd", "model": model,
           "stage": stage, "launches": launches,
           "shape": f"B={b} H={h} Hkv={k.shape[1]} Sq={sq} Sk={sk} D={d} "
                    f"{str(q.dtype).replace('torch.', '')} causal",
           "bytes": nbytes, "ops": nops}
    row["ms"] = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse,
                                                        do, **kw),
                        reps=3, inner=2)
    row["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, **kw), reps=3, inner=1)
    check(kw["causal"] and kw["window"] == 0 and sq == sk,
          "the SDPA yardstick takes the main path's plain causal mask only")
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                       enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o, (qs, ks, vs), do,  # noqa
                                           retain_graph=True)
    sdpa_bwd()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(5):
        sdpa_bwd()
    ev[1].record()
    ev[1].synchronize()
    row["library_ms"] = ev[0].elapsed_time(ev[1]) / 5
    peak = PEAK_OPS_PER_S["flash_attention_bwd"]
    row["bound_ms"] = bound_ms(nbytes, nops, peak)
    row["bound_by"] = bound_by(nbytes, nops, peak)
    kernel_ops = 14 * b * h * d * pairs
    split = _device_breakdown(lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, **kw))
    if split is not None:
        row["kernels_ms"] = {
            (re.findall(r"\w+_kernel", name) or [name])[0]: ms
            for name, ms in split["top_kernels_ms"].items()}
        log(f"flash_attention_bwd's kernels on one call (torch.profiler): "
            f"{json.dumps(row['kernels_ms'])}")
    log(f"time flash_attention_bwd {row['stage']} {row['shape']}: kernel "
        f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, library (SDPA "
        f"backward, eager) {row['library_ms']:.6f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}); {nops:.4g} "
        f"operations in 5 products ({nops / row['ms'] / 1e9:.1f} TFLOP/s), "
        f"the kernel's own 7 products {kernel_ops:.4g} "
        f"({kernel_ops / row['ms'] / 1e9:.1f} TFLOP/s); the CUDA-core "
        f"kernel {K6_BWD_CUDA_CORE_MS:.6f} ms "
        f"({K6_BWD_CUDA_CORE_MS / row['ms']:.1f}x faster now)")
    row["kernel_ops"] = kernel_ops
    del qs, ks, vs, o
    return row


def _train_full(smi):
    """(a) Full-width, full-depth internlm2-1.8b (bf16, remat "full", S
    4096, "auto" -> chunked) through ``DataPipeline`` and
    ``make_train_step`` for ``TRAIN_STEPS`` steps of 4 sequences in 2
    microbatches; counters set to 0 before the steps and read after; the
    first microbatch's backward launches of layers 23 and 0 caught and
    held against the plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import leaves
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.obs import timer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = get_config(TRAIN_CONFIG)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16"
          and (cfg.attn_impl == "chunked"
               or cfg.attn_impl == "auto" and TRAIN_SEQ > 2048),
          f"{TRAIN_CONFIG}: expected bf16, remat full and the chunked "
          f"attention (K6)")
    opt = make_optimizer(base_lr=3e-4, warmup=2, total=TRAIN_STEPS)
    model, state = _train_state(cfg, SEED + 8, opt)
    n_params = sum(t.numel() for t in leaves(state.params))
    step = make_train_step(model, opt, microbatches=TRAIN_MICROBATCHES)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, seed=SEED)

    real = ops.flash_attention_bwd
    calls = []
    caught = {}

    def catch(q, k, v, out, lse, do, **kw):
        got = real(q, k, v, out, lse, do, **kw)
        i = len(calls)
        calls.append(1)
        if i in (0, cfg.n_layers - 1):     # layer 23, then layer 0
            caught[cfg.n_layers - 1 - i] = tuple(
                t.detach().clone() for t in (q, k, v, out, lse, do)) + (
                kw, tuple(t.clone() for t in got))
        return got

    losses, step_s = [], []
    ops.flash_attention_bwd = catch
    try:
        with DataPipeline(lambda s: data.batch(s, TRAIN_BATCH)) as pipe:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            for i in range(TRAIN_STEPS):
                s, batch = next(pipe)
                check(s == i, f"the pipeline handed out step {s} at {i}")
                t0 = timer.now()
                state, met = step(state, batch)
                losses.append(float(met["loss"]))    # synchronises
                step_s.append(timer.now() - t0)
                log(f"lm train step {i + 1}: loss {losses[-1]:.6f}, "
                    f"grad_norm {float(met['grad_norm']):.6f}, lr "
                    f"{float(met['lr']):.3g}, {step_s[-1] * 1e3:.3f} ms")
            torch.cuda.synchronize()
            launches = dict(ops.launches)
    finally:
        ops.flash_attention_bwd = real
    peak = torch.cuda.max_memory_allocated()
    log(f"lm train launches ({TRAIN_STEPS} steps, {TRAIN_MICROBATCHES} "
        f"microbatches, {cfg.n_layers} layers, remat full): "
        f"{json.dumps(launches)}")
    per_mb = TRAIN_STEPS * TRAIN_MICROBATCHES * cfg.n_layers
    check(launches["flash_attention"] == 2 * per_mb,
          f"K6 forward launched {launches['flash_attention']} times, "
          f"expected {2 * per_mb} (a layer's forward and its recompute)")
    check(launches["flash_attention_bwd"] == per_mb,
          f"K6 backward launched {launches['flash_attention_bwd']} times, "
          f"expected {per_mb}")
    for name in TINY_KERNELS + (HEAD_KERNEL,) + BENCH_KERNELS:
        check(launches[name] == 0, f"training launched {name}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    tail = statistics.mean(losses[-4:])
    check(tail < losses[0], f"the loss did not fall: first {losses[0]}, "
                            f"mean of the last 4 {tail}")

    worst = 0.0
    for layer in sorted(caught):
        q, k, v, out, lse, do, kw, got = caught[layer]
        worst = max(worst, _check_bwd(
            f"layer {layer} on its training inputs {tuple(q.shape)} "
            f"(strides {q.stride()})", q, k, v, out, lse, do, kw, got))
    del state, model
    gc.collect()         # the train state sits in a reference cycle
    torch.cuda.empty_cache()
    q, k, v, out, lse, do, kw, _ = caught[0]
    row = _bwd_case(q, k, v, out, lse, do, kw,
                    launches["flash_attention_bwd"])
    del caught
    torch.cuda.empty_cache()

    steady = statistics.median(step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / steady / BF16_OPS_PER_S
    log(f"lm train {TRAIN_CONFIG} ({smi}): {n_params} parameters, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICROBATCHES} microbatches: "
        f"step {steady * 1e3:.3f} ms (median of steps 2-{TRAIN_STEPS}; "
        f"first {step_s[0] * 1e3:.3f} ms), {tokens / steady:.1f} tokens/s, "
        f"6NT / step / 989e12 = {mfu:.4f}, peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} B); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    details = {"n_params": n_params, "step_ms": [t * 1e3 for t in step_s],
               "steady_step_ms": steady * 1e3,
               "tokens_per_s": tokens / steady, "mfu_6nt": mfu,
               "peak_bytes": peak, "losses": losses,
               "main_path_launches": launches}
    return launches, worst, row, details


def _same_checkpoints(a, b):
    """Whether two checkpoint directories hold equal arrays, key by key."""
    import numpy as np
    from repro_torch.checkpoint.checkpoint import latest_step

    pa = os.path.join(a, f"step_{latest_step(a):010d}", "arrays.npz")
    pb = os.path.join(b, f"step_{latest_step(b):010d}", "arrays.npz")
    with np.load(pa) as za, np.load(pb) as zb:
        if sorted(za.files) != sorted(zb.files):
            return False, ["keys"]
        bad = [key for key in za.files
               if not np.array_equal(za[key], zb[key])]
    return not bad, bad


class _InjectedCrash(Exception):
    pass


#: cuBLAS's workspace setting that deterministic algorithms need, set in
#: the resume run's own process before its CUDA starts (set in this
#: process, it would slow every later cuBLAS call, the decode timing's
#: among them)
CUBLAS_DETERMINISTIC = ":4096:8"


def _train_resume_in_child(smi):
    """(b), run in a child process of this script whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA initialises; its log lines are
    passed on, its result comes back as JSON on its last line."""
    code = (f"import json, sys\nsys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
            f"import chip_smoke\n"
            f"res = chip_smoke._train_resume({smi!r})\n"
            f"print(json.dumps(res))\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_DETERMINISTIC)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    check(r.returncode == 0 and lines, f"the resume run failed (exit "
                                       f"{r.returncode}): {r.stderr[-4000:]}")
    return json.loads(lines[-1])


def _train_resume(smi):
    """(b) The full-width model cut to ``TRAIN_CUT_LAYERS`` layers under
    ``torch.use_deterministic_algorithms(True)`` (the caller sets
    ``CUBLAS_WORKSPACE_CONFIG``): ``run_training`` for ``TRAIN_CUT_STEPS``
    steps uninterrupted, and again with a crash at step
    ``TRAIN_CRASH_AT`` and a resume; the two final checkpoints must be
    equal bit for bit. Every run's step is a ``StepProgram`` (one CUDA
    graph over the run's state, as the launcher runs it; phase 28 (c)):
    the crash path saves the program run's state, and the resume is a new
    model, state (another seed) and program, restored in place.
    Checkpoints go to a temporary directory under ``build/``."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.core.programs import StepProgram
    from repro_torch.core.pytree import leaves
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.obs import timer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_CONFIG),
                              n_layers=TRAIN_CUT_LAYERS)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, seed=SEED)
    marks = {}

    def run(directory, hook=None, seed=SEED + 9):
        opt = make_optimizer(base_lr=3e-4, warmup=2, total=TRAIN_CUT_STEPS)
        model, state = _train_state(cfg, seed, opt)
        held = leaves(state)
        prog = StepProgram(make_train_step(model, opt, TRAIN_MICROBATCHES),
                           "cuda", name="train_step")
        lcfg = LoopConfig(total_steps=TRAIN_CUT_STEPS, ckpt_every=1000,
                          ckpt_dir=directory, keep_n=1, log_every=1)
        try:
            return run_training(prog, state,
                                lambda s: data.batch(s, TRAIN_BATCH), lcfg,
                                step_hook=hook)
        finally:
            check(len(prog) == 1 and all(
                a is b for a, b in zip(leaves(state), held)),
                f"lm train resume: the run held {len(prog)} graphs or left "
                f"other state tensors")
            del state, model, prog
            gc.collect()

    def crash(step):
        if step == TRAIN_CRASH_AT:
            marks["crash"] = timer.now()
            raise _InjectedCrash(f"injected crash at step {step}")

    def first_step(step):
        marks.setdefault("resumed", timer.now())

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == CUBLAS_DETERMINISTIC,
          "deterministic cuBLAS needs CUBLAS_WORKSPACE_CONFIG set before "
          "CUDA initialises")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm-train-", dir=os.path.join(ROOT,
                                                                "build"))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        whole_dir = os.path.join(tmp, "whole")
        crash_dir = os.path.join(tmp, "crash")
        whole = run(whole_dir)
        torch.cuda.empty_cache()
        try:
            run(crash_dir, crash)
            raise SmokeFailure("the injected crash did not propagate")
        except _InjectedCrash:
            save_s = timer.now() - marks["crash"]
        check(latest_step(crash_dir) == TRAIN_CRASH_AT,
              f"the crash path saved step {latest_step(crash_dir)}")
        ckpt = os.path.join(crash_dir, f"step_{TRAIN_CRASH_AT:010d}")
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                     for f in os.listdir(ckpt))
        torch.cuda.empty_cache()
        t0 = timer.now()
        # a new model, state (another seed: the restore overwrites it in
        # place) and program resume from the program run's checkpoint
        resumed = run(crash_dir, first_step, seed=SEED + 19)
        restore_s = marks["resumed"] - t0
        check(resumed.resumed_from == TRAIN_CRASH_AT
              and resumed.final_step == whole.final_step == TRAIN_CUT_STEPS,
              f"resumed from {resumed.resumed_from} to {resumed.final_step}")
        same, bad = _same_checkpoints(whole_dir, crash_dir)
        check(same, f"the resumed run's final state differs from the "
                    f"uninterrupted run's at {bad[:5]}")
        losses = [h["loss"] for h in whole.metrics_history]
        check([h["loss"] for h in resumed.metrics_history]
              == losses[TRAIN_CRASH_AT:],
              "the resumed run's losses differ from the uninterrupted run's")
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"lm train resume ({TRAIN_CONFIG} full width, {TRAIN_CUT_LAYERS} "
        f"layers, deterministic algorithms, every run through a step "
        f"program): crash at step {TRAIN_CRASH_AT}, a new program resumed "
        f"to {TRAIN_CUT_STEPS} from the checkpoint the program run wrote, "
        f"final state equal to the uninterrupted run bit for bit; checkpoint {nbytes} B, crash-path "
        f"save {save_s:.3f} s, restore {restore_s:.3f} s (host clock; "
        f"{smi}); losses {losses}")
    return {"checkpoint_bytes": nbytes, "crash_save_s": save_s,
            "restore_s": restore_s, "losses": losses}


def _train_quantized():
    """(c) ``weight_bits=8`` (QAT fake-quant) at full width, 2 layers: two
    steps with finite losses."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_CONFIG),
                              n_layers=TRAIN_CUT_LAYERS, weight_bits=8)
    opt = make_optimizer(base_lr=3e-4, warmup=1, total=2)
    model, state = _train_state(cfg, SEED + 10, opt)
    step = make_train_step(model, opt, microbatches=TRAIN_MICROBATCHES)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, seed=SEED)
    losses = []
    for i in range(2):
        state, met = step(state, data.batch(i, TRAIN_BATCH))
        losses.append(float(met["loss"]))
    check(all(math.isfinite(x) for x in losses), f"QAT losses {losses}")
    log(f"lm train QAT weight_bits=8 {TRAIN_CONFIG} {TRAIN_CUT_LAYERS} "
        f"layers: losses {losses}")
    del state, model
    torch.cuda.empty_cache()
    return losses


def _train_launcher():
    """(d) ``repro_torch.launch.train``'s ``main`` on the card (--reduced,
    10 steps), with a checkpoint every 5 steps under ``build/``: one rank,
    so every step goes through its step program (one CUDA graph, the state
    donated; phase 28 (c)), and the launcher's log says so."""
    import logging
    import shutil

    from repro_torch.core import programs
    from repro_torch.launch import train as launch_train

    calls = []
    real_call = programs.StepProgram.__call__

    def counted(self, state, batch):
        out = real_call(self, state, batch)
        calls.append(len(self))
        return out

    said = []
    handler = logging.Handler()
    handler.emit = lambda record: said.append(record.getMessage())
    logger = logging.getLogger("repro_torch.launch.train")
    logger.addHandler(handler)
    programs.StepProgram.__call__ = counted
    tmp = tempfile.mkdtemp(prefix="launch-train-",
                           dir=os.path.join(ROOT, "build"))
    try:
        res = launch_train.main(["--arch", TRAIN_CONFIG, "--reduced",
                                 "--steps", "10", "--batch", "4", "--seq",
                                 "64", "--ckpt-every", "5", "--ckpt-dir",
                                 tmp, "--device", "cuda"])
    finally:
        programs.StepProgram.__call__ = real_call
        logger.removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)
    check(res.final_step == 10 and res.resumed_from is None,
          f"launch.train ended at {res.final_step}")
    loss = res.metrics_history[-1]["loss"] if res.metrics_history else None
    check(loss is not None and math.isfinite(loss), f"launch loss {loss}")
    told = [m for m in said if m.startswith("train step:")]
    check(calls == [1] * 10 and told == [
        "train step: a CUDA graph program, state donated"],
          f"launch.train: {len(calls)} program steps holding {calls} graphs"
          f" and the log {told}, expected 10 through one graph")
    log(f"lm train launcher (--reduced, 10 steps, cuda): final loss "
        f"{loss:.6f}; its 10 steps went through its step program (one CUDA "
        f"graph), and it logged {told[0]!r}")
    return loss


def phase_lm_train(smi):
    """Phase 19: the LM's training path on the card. K6's backward against
    its plain version on synthetic cases, then (a) full width and depth,
    (b) crash and exact resume at depth 2, (c) QAT at depth 2, (d) the
    launcher. Returns (launches of (a), worst |kernel - plain| of K6's
    backward, its timing row, details)."""
    import torch
    from repro_torch.kernels import _build

    (lib,) = _build.build_all(["flash_attention_bwd"])
    hgmma = sass_count(lib, "HGMMA")
    log(f"K6 backward sass: {hgmma} HGMMA instructions in "
        f"{os.path.basename(lib)}")
    check(hgmma > 0, "the flash_attention_bwd library holds no HGMMA: the "
                     "bf16 backward does not run on the tensor cores")
    torch.cuda.empty_cache()
    worst = phase_flash_bwd_synthetic()
    launches, worst_main, row, details = _train_full(smi)
    details["hgmma"] = hgmma
    details["resume"] = _train_resume_in_child(smi)
    details["qat_losses"] = _train_quantized()
    details["launcher_loss"] = _train_launcher()
    return launches, max(worst, worst_main), row, details


# ---------------------------------------------------------------------------
# phase 20: the LM families (MoE, mamba, the jamba hybrid, M-RoPE and
# embedding inputs)
# ---------------------------------------------------------------------------

FAMILY_SEQ = 4096                # prefill length: "auto" takes K6 above 2048
JAMBA_CONFIG = "jamba-v0.1-52b"
JAMBA_LAYERS = 16                # of 32: two 8-sublayer groups, 48.5 GiB bf16
#: K6 launches of one prefill of each family model: one an attention layer
FAMILY_K6 = {JAMBA_CONFIG: 2, "qwen2-vl-2b": 28, "hubert-xlarge": 48}
FAMILY_MAMBA_SEQ = 512           # the mamba mixer's prefill (4 chunks of 128)
FAMILY_DECODE_STEPS = 8
SUBLAYER_TOL = 1e-4              # of the largest |y|: card against the CPU
#: K6 against its plain version on a family prefill's inputs (bf16):
#: max |kernel - plain| over max |plain|, and mean |kernel - plain| over
#: mean |plain|. One bf16 step is 2^-8 of a value, so rounding stays far
#: under both; the plain attention without its first 64-key tile must
#: break one of them on the same inputs, or the check has no power there.
FAMILY_K6_TOL = {"max": 2e-2, "mean": 1e-2}
TIE_MARGIN = 1e-6                # top-k margins under this are reported


def _family_cfg(name, **over):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), **over)


def _to_cpu(tree):
    from repro_torch.core.pytree import tree_map

    return tree_map(lambda t: t.cpu(), tree)


def _close_to_cpu(label, got, want, rows=None):
    """|card - CPU| at most ``SUBLAYER_TOL`` of the CPU's largest |y| (on
    ``rows`` of the leading axis when given); returns that ratio."""
    got, want = got.float().cpu(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = float(want.abs().max())
    ratio = float((got - want).abs().max()) / scale
    check(ratio <= SUBLAYER_TOL, f"{label}: the card differs from the CPU by "
                                 f"{ratio:.3g} of the largest |y| {scale:.4g}")
    return ratio


def _kept_choices(idx, n_experts, capacity):
    """Which of the token-major (T*k) expert choices fit their expert's
    ``capacity`` slots (the reference's rank-by-cumsum rule)."""
    import torch

    onehot = torch.nn.functional.one_hot(idx.reshape(-1).long(), n_experts)
    return (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1 < capacity


def _moe_sublayer(name, shapes, g):
    """One full-width MoE FFN in float32 on the card against the port on
    the CPU with the same weights, at each (batch, seq) of ``shapes``:
    equal expert choices and drops (a token whose top-k margin is under
    ``TIE_MARGIN`` is reported, and left out of the comparison), outputs
    within ``SUBLAYER_TOL``."""
    import torch
    from repro_torch.models import layers

    cfg = _family_cfg(name, dtype="float32")
    with torch.inference_mode():
        p = layers.moe_init(g, cfg, device="cuda")
    cpu = _to_cpu(p)
    out = {}
    for shape in shapes:
        x = torch.randn(*shape, cfg.d_model, generator=g, device="cuda")
        T, k, E = shape[0] * shape[1], cfg.moe_top_k, cfg.moe_experts
        with torch.inference_mode():
            y, aux = layers.moe_apply(cfg, p, x)
            _, _, idx = layers.moe_route(cfg, p, x)
            y_c, aux_c = layers.moe_apply(cfg, cpu, x.cpu())
            probs_c, _, idx_c = layers.moe_route(cfg, cpu, x.cpu())
        top = torch.sort(probs_c.reshape(T, E), dim=-1,
                         descending=True).values[:, :k + 1]
        margin = (top[:, :-1] - top[:, 1:]).amin(dim=-1)
        ties = (margin < TIE_MARGIN).nonzero().flatten().tolist()
        rows = torch.ones(T, dtype=torch.bool)
        rows[ties] = False
        idx, idx_c = idx.cpu().reshape(T, k), idx_c.reshape(T, k)
        label = f"{name} MoE FFN {shape[0]}x{shape[1]}"
        check(torch.equal(idx[rows], idx_c[rows]),
              f"{label}: expert choices differ from the CPU's")
        C = layers.moe_capacity(cfg, T)
        keep = _kept_choices(idx, E, C)
        keep_c = _kept_choices(idx_c, E, C)
        if not ties:
            check(torch.equal(keep, keep_c), f"{label}: drops differ")
        ratio = _close_to_cpu(label, y.reshape(T, -1), y_c.reshape(T, -1),
                              rows if ties else None)
        aux_err = abs(float(aux) - float(aux_c)) / float(aux_c)
        check(aux_err <= SUBLAYER_TOL, f"{label}: aux {float(aux)} against "
                                       f"{float(aux_c)}")
        out[f"{shape[0]}x{shape[1]}"] = {
            "capacity": C, "dropped": int((~keep).sum()),
            "tie_rows": ties, "min_margin": float(margin.min()),
            "max_rel_err": ratio, "aux_rel_err": aux_err}
        log(f"family {label} float32 (E {E}, top-{k}, capacity {C}"
            f"{', shared expert' if cfg.moe_shared_expert else ''}): "
            f"choices and drops equal the CPU's ({int((~keep).sum())} of "
            f"{T * k} dropped; {len(ties)} near-tie rows, least top-k margin "
            f"{float(margin.min()):.3g}); |card - CPU| {ratio:.3g} of the "
            f"largest |y|")
    del p, cpu
    torch.cuda.empty_cache()
    return out


def _mamba_sublayer(g):
    """One full-width jamba mamba mixer in float32: ``ssm_apply`` over
    ``FAMILY_MAMBA_SEQ`` tokens, then ``FAMILY_DECODE_STEPS`` decode steps
    from that prefill's conv window and state, on the card and on the
    CPU."""
    import torch
    from repro_torch.models import ssm

    cfg = _family_cfg(JAMBA_CONFIG, dtype="float32")
    S, n = FAMILY_MAMBA_SEQ, FAMILY_DECODE_STEPS
    with torch.inference_mode():
        p = ssm.ssm_init(g, cfg, device="cuda")
    x = torch.randn(1, S + n, cfg.d_model, generator=g, device="cuda")
    outs = {}
    for dev, params in (("cuda", p), ("cpu", _to_cpu(p))):
        xd = x.to(dev)
        with torch.inference_mode():
            y = ssm.ssm_apply(cfg, params, xd[:, :S])
            xs, _, dt, B_t, C_t, A, conv = ssm._mix(cfg, params, xd[:, :S])
            _, h = ssm.selective_scan_chunked(xs, dt, B_t, C_t, A,
                                              params["D"], cfg.ssm_chunk)
            cache = {"conv": conv.clone(), "h": h}
            steps = torch.cat([ssm.ssm_decode(cfg, params,
                                              xd[:, S + t:S + t + 1],
                                              cache)[0]
                               for t in range(n)], dim=1)
        outs[dev] = (y[0], steps[0], cache["h"][0])
    label = f"{JAMBA_CONFIG} mamba mixer"
    res = {"prefill": _close_to_cpu(f"{label} prefill S {S}",
                                    outs["cuda"][0], outs["cpu"][0]),
           "decode": _close_to_cpu(f"{label} {n} decode steps",
                                   outs["cuda"][1], outs["cpu"][1]),
           "state": _close_to_cpu(f"{label} state", outs["cuda"][2],
                                  outs["cpu"][2])}
    log(f"family {label} float32 (d_inner {cfg.d_inner}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}): prefill S {S} then {n} "
        f"decode steps from its state equal the CPU's; |card - CPU| over the "
        f"largest |y|: {json.dumps(res)}")
    del p, outs
    torch.cuda.empty_cache()
    return res


def _mrope_positions(g, S, arange_t):
    """(3, 1, S) M-RoPE positions on the card: a temporal row (an arange
    run, or increasing steps of 0-2) and h / w rows of a 64 x 64 grid."""
    import torch

    steps = torch.randint(0, 3, (1, S), generator=g, device="cuda")
    t = (torch.arange(S, device="cuda")[None] if arange_t
         else steps.cumsum(dim=1))
    hw = torch.randint(0, 64, (2, 1, S), generator=g, device="cuda")
    return torch.cat([t[None], hw]).to(torch.int32)


def _mrope_sublayer(g):
    """One full-width qwen2-vl attention (q/k/v biases, GQA 12/2, head dim
    128) in float32 with M-RoPE positions: at S 512 ("auto": the naive
    path) with a non-arange temporal row, and at ``FAMILY_SEQ`` (K6) with
    an arange one; h / w rows vary in both."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn

    cfg = _family_cfg("qwen2-vl-2b", dtype="float32")
    with torch.inference_mode():
        p = attn.attn_init(g, cfg, device="cuda")
    cpu = _to_cpu(p)
    res = {}
    for S, arange_t in ((512, False), (FAMILY_SEQ, True)):
        x = torch.randn(1, S, cfg.d_model, generator=g, device="cuda")
        pos = _mrope_positions(g, S, arange_t)
        with torch.inference_mode():
            before = ops.launches["flash_attention"]
            y = attn.attn_apply(cfg, p, x, pos)
            torch.cuda.synchronize()
            n_k6 = ops.launches["flash_attention"] - before
            y_c = attn.attn_apply(cfg, cpu, x.cpu(), pos.cpu())
        check(n_k6 == (1 if S > 2048 else 0), f"qwen2-vl attention S {S}: "
                                              f"K6 launched {n_k6} times")
        res[S] = _close_to_cpu(f"qwen2-vl M-RoPE attention S {S}", y[0],
                               y_c[0])
        log(f"family qwen2-vl-2b M-RoPE attention float32 S {S} "
            f"({'K6' if n_k6 else 'naive'}, temporal row "
            f"{'arange' if arange_t else 'not arange'}): |card - CPU| "
            f"{res[S]:.3g} of the largest |y|")
    del p, cpu
    torch.cuda.empty_cache()
    return res


def _counted_prefill(model, params, batch):
    """One ``prefill`` with the counters set to 0 just before it and read
    just after; every K6 launch's inputs and output caught. Returns
    (logits, launches, caught)."""
    import torch
    from repro_torch.kernels import ops

    real = ops.flash_attention
    caught = []

    def catch(q, k, v, **kw):
        out = real(q, k, v, **kw)
        caught.append((q, k, v, kw, out))
        return out

    ops.flash_attention = catch
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        logits = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
    finally:
        ops.flash_attention = real
    return logits, launches, caught


def _k6_error(out, want):
    """(max |out - want|, its ratios to ``want``: ``max`` over max |want|,
    ``mean`` over mean |want|, and ``max_plain``)."""
    d = (out.float() - want.float()).abs()
    w = want.float().abs()
    return float(d.max()), {"max": float(d.max() / w.max()),
                            "mean": float(d.mean() / w.mean()),
                            "max_plain": float(w.max())}


def _without_first_key_tile(q, k, v, kw):
    """The plain attention of ``q`` over all keys but the first 64: a K6
    that skipped its first key tile. Query positions shift with the keys,
    so the causal and window masks keep their place."""
    from repro_torch.kernels import ref

    kw = dict(kw)
    kw["q_offset"] = kw.get("q_offset", 0) - 64
    if kw.get("kv_len") is not None:
        kw["kv_len"] -= 64
    return ref.flash_attention_ref(q, k[:, :, 64:], v[:, :, 64:], **kw)


def _family_prefill(name, model, params, batch):
    """The counted prefill of a family model at ``FAMILY_SEQ``: exactly
    ``FAMILY_K6[name]`` K6 launches and no other kernel, finite float32
    logits; every K6 launch held against the plain version on its inputs
    (``FAMILY_K6_TOL``); the prefill's host ms (median of 3) and peak
    memory.
    Returns (launches, worst |kernel - plain|, K6 timing case, details)."""
    import torch
    from repro_torch.kernels import ref

    cfg = model.cfg
    logits, launches, caught = _counted_prefill(model, params, batch)
    log(f"family {name} main-path launches (one prefill, B=1 "
        f"S={FAMILY_SEQ}): {json.dumps(launches)}")
    check(launches["flash_attention"] == FAMILY_K6[name],
          f"{name} prefill launched flash_attention "
          f"{launches['flash_attention']} times, expected {FAMILY_K6[name]}")
    for k, n in launches.items():
        check(k == "flash_attention" or n == 0, f"{name} prefill launched {k}")
    check(logits.shape == (1, FAMILY_SEQ, cfg.vocab)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{name} logits {logits.dtype} {tuple(logits.shape)} not finite")
    worst = 0.0
    for i, (q, k, v, kw, out) in enumerate(caught):
        want = ref.flash_attention_ref(q, k, v, **kw)
        err, rel = _k6_error(out, want)
        worst = max(worst, err)
        log(f"kernel-check flash_attention {name} attention layer {i} on its "
            f"prefill inputs {tuple(q.shape)} {q.dtype}: max err {err:.3g}, "
            f"max |plain| {rel['max_plain']:.3g}, max err / max |plain| "
            f"{rel['max']:.3g}, mean err / mean |plain| {rel['mean']:.3g} "
            f"(tol {FAMILY_K6_TOL['max']:g} / {FAMILY_K6_TOL['mean']:g})")
        check(rel["max"] <= FAMILY_K6_TOL["max"]
              and rel["mean"] <= FAMILY_K6_TOL["mean"],
              f"{name} attention layer {i}: K6 differs from its plain "
              f"version by {rel['max']:.3g} of max |plain| and "
              f"{rel['mean']:.3g} of mean |plain|")
        if i == 0:
            _, cut = _k6_error(_without_first_key_tile(q, k, v, kw), want)
            log(f"kernel-check power {name}: the plain attention without "
                f"its first 64 keys is {cut['max']:.3g} of max |plain| and "
                f"{cut['mean']:.3g} of mean |plain| off")
            check(cut["max"] > FAMILY_K6_TOL["max"]
                  or cut["mean"] > FAMILY_K6_TOL["mean"],
                  f"{name}: a K6 that skipped a key tile would pass the "
                  f"check ({cut})")
        del want
    q0, k0, v0, kw0, _ = caught[0]
    case = flash_case("prefill attention layer 0", q0, k0, v0, kw0,
                      model=name)
    case["launches"] = launches["flash_attention"]
    del caught, logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _host_ms(lambda: model.prefill(params, batch), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"family {name} prefill {cfg.dtype} B=1 S={FAMILY_SEQ}: {ms:.3f} ms "
        f"(host clock, median of 3, synchronised), peak {peak:.3f} GiB")
    return launches, worst, case, {"prefill_ms": ms, "peak_gib": peak,
                                   "main_path_launches": launches}


def _family_model(name, seed, **over):
    """``Model`` of ``name`` at full width (``over`` replaces fields), its
    seeded weights on the card as inference tensors, whose count must equal
    ``ArchConfig.n_params``; returns (model, params, the generator, which
    drew them and draws the inputs next, details)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.obs import timer

    model = Model(_family_cfg(name, **over))
    g = torch.Generator(device="cuda").manual_seed(seed)
    gc.collect()         # an engine wrapped by _hold_slot_state is a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = timer.now()
    with torch.inference_mode():
        params = model.init(g, device="cuda")
    torch.cuda.synchronize()
    init_s = timer.now() - t0
    n = sum(t.numel() for t in _leaves(params))
    check(n == model.cfg.n_params(), f"{name}: {n} parameters, the config "
                                     f"counts {model.cfg.n_params()}")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"family {name} init ({model.cfg.n_layers} layers, "
        f"{model.cfg.dtype}): {n} parameters, {nbytes / 2 ** 30:.3f} GiB, "
        f"init peak {peak:.3f} GiB, {init_s:.3f} s")
    return model, params, g, {"n_params": n, "param_gib": nbytes / 2 ** 30,
                              "init_peak_gib": peak, "init_s": init_s}


def _engine_prompts(vocab, seed):
    """8 seeded prompts of 8-32 tokens (phase 9's mix)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in rng.integers(8, 33, 8)]


def _hold_slot_state(eng):
    """Wrap ``eng``'s prefill and insert: after every insert, each mamba
    sublayer's conv window and state in the slot must equal the batch-1
    prefill's bit for bit, dtype included. Returns the list of checked
    leaves per insert."""
    import torch
    from repro_torch.core.pytree import leaves_with_paths

    real_prefill, real_insert = eng._prefill_one, eng._insert_into_slot
    held, checked = [], []

    def prefill_one(tokens):
        cache, logits = real_prefill(tokens)
        held.append(cache)
        return cache, logits

    def insert(slot, req):
        real_insert(slot, req)
        one = dict(leaves_with_paths(held.pop()))
        n = 0
        for path, leaf in leaves_with_paths(eng.caches):
            if path.rsplit("/", 1)[-1] in ("h", "conv"):
                check(leaf.dtype == one[path].dtype
                      and torch.equal(leaf[:, slot], one[path][:, 0]),
                      f"request {req.uid}: slot {slot}'s {path} differs from "
                      f"its batch-1 prefill")
                n += 1
        checked.append(n)

    eng._prefill_one = prefill_one
    eng._insert_into_slot = insert
    return checked


def _serve(model, params, prompts, hold=False, graphs=True):
    """``ServeEngine`` (4 slots, max_len 256; ``graphs=False``: its decode
    and prefill programs replaced by their eager forms, every step eager)
    on ``prompts`` with 8 new tokens each; returns (outputs, stats,
    checked slot-state leaves, the engine)."""
    import torch
    from repro_torch.obs import timer
    from repro_torch.serving.engine import Request, ServeEngine

    eng = ServeEngine(model, params, n_slots=4, max_len=256, device="cuda")
    if not graphs:
        eng.decode_program = eng.decode_program.eager
        eng.prefill_program = eng.prefill_program.eager
    checked = _hold_slot_state(eng) if hold else []
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    t0 = timer.now()
    for r in reqs:
        eng.submit(r)
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    engine_s = timer.now() - t0
    check(len(eng.finished) == len(reqs),
          f"{len(eng.finished)} of {len(reqs)} requests finished")
    stats = dict(eng.stats(), steps=steps, engine_s=engine_s,
                 prompt_tokens=int(sum(len(p) for p in prompts)),
                 new_tokens=int(sum(len(r.output) for r in reqs)))
    return [r.output for r in reqs], stats, checked, eng


def _jamba(smi):
    """(b) jamba-v0.1-52b in bf16 at its published widths, ``JAMBA_LAYERS``
    of 32 layers: the counted prefill (2 K6 launches), then
    ``ServeEngine`` twice on 8 seeded requests, eagerly and through its
    graphs (phase 27 (b), ``_engine_programs``): the same tokens both
    times, and after every insert of the eager run the slot's mamba state
    equal to the batch-1 prefill's bit for bit. The MoE choices the
    4-slot decode batch drops (capacity 1 a expert) are counted in the
    eager run."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    model, params, g, det = _family_model(JAMBA_CONFIG, SEED + 20,
                                          n_layers=JAMBA_LAYERS)
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (1, FAMILY_SEQ), generator=g,
                           device="cuda")
    launches, worst, case, pre = _family_prefill(JAMBA_CONFIG, model, params,
                                                 {"tokens": tokens})
    det.update(pre)
    prompts = _engine_prompts(cfg.vocab, SEED + 20)
    drops = []
    real = tfm.moe_apply

    def counting(c, sub, h):
        if h.shape[0] == 4:
            _, _, idx = layers.moe_route(c, sub, h)
            drops.append((~_kept_choices(idx, c.moe_experts,
                                         layers.moe_capacity(c, 4))).sum())
        return real(c, sub, h)

    tfm.moe_apply = counting
    try:
        first, stats, checked, eng = _serve(model, params, prompts,
                                            hold=True, graphs=False)
        del eng
    finally:
        tfm.moe_apply = real
    _, stats2, det["programs"] = _engine_programs(
        f"{JAMBA_CONFIG} {cfg.dtype} ({JAMBA_LAYERS} layers)", model, params,
        prompts, eager=(first, stats))
    n_drop = int(sum(int(d) for d in drops))
    steps = _decode_ms(model, params, g)
    det["serving"] = dict(stats2, instrumented_engine_s=stats["engine_s"],
                          instrumented_tok_s=stats["throughput_tok_s"],
                          inserts_held=len(checked),
                          state_leaves_held=sum(checked),
                          decode_batch_moe_calls=len(drops),
                          decode_batch_dropped=n_drop,
                          decode_step_ms=steps)
    log(f"family {JAMBA_CONFIG} serving {cfg.dtype} ({JAMBA_LAYERS} layers, "
        f"4 slots): {len(prompts)} requests, {stats2['prompt_tokens']} "
        f"prompt and {stats2['new_tokens']} new tokens in {stats2['steps']} "
        f"engine steps, {stats2['engine_s']:.3f} s, "
        f"{stats2['throughput_tok_s']:.3f} tokens/s through the graphs (the "
        f"eager run, with the slot-state and drop checks on its path, "
        f"{stats['engine_s']:.3f} s); both runs give the same tokens; "
        f"{len(checked)} inserts, "
        f"{sum(checked)} mamba leaves equal to their batch-1 prefill bit for "
        f"bit; {n_drop} MoE choices dropped over {len(drops)} decode-batch "
        f"MoE calls; a decode step alone {steps['batch1']:.3f} ms at batch 1, "
        f"{steps['batch4']:.3f} ms at batch 4 (host clock, median of 10) "
        f"({smi})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, worst, case, det


def _falcon_engine(smi):
    """(c) falcon-mamba-7b at full width and depth in float32 (TF32 off):
    ``ServeEngine`` on 8 seeded requests, eagerly and through its graphs
    (phase 27 (b)), each request's tokens equal to its own sequential
    greedy decode."""
    import torch
    from repro_torch.core.qir import full_fp32

    name = "falcon-mamba-7b"
    model, params, g, det = _family_model(name, SEED + 21, dtype="float32")
    prompts = _engine_prompts(model.cfg.vocab, SEED + 21)
    with full_fp32():
        outputs, stats, det["programs"] = _engine_programs(
            f"{name} float32", model, params, prompts)
        for i, (p, out) in enumerate(zip(prompts, outputs)):
            want = _greedy(model, params, p, 8, 256)
            check(out == want, f"{name} request {i}: engine {out} != "
                               f"sequential {want}")
        steps = _decode_ms(model, params, g)
    det["serving"] = dict(stats, decode_step_ms=steps)
    log(f"family {name} serving float32 (64 layers, 4 slots): "
        f"{len(prompts)} requests, {stats['prompt_tokens']} prompt and "
        f"{stats['new_tokens']} new tokens in {stats['steps']} engine steps, "
        f"{stats['engine_s']:.3f} s, {stats['throughput_tok_s']:.3f} "
        f"tokens/s; every request equals its sequential greedy decode; a "
        f"decode step alone {steps['batch1']:.3f} ms at batch 1, "
        f"{steps['batch4']:.3f} ms at batch 4 (host clock, median of 10) "
        f"({smi})")
    del params
    torch.cuda.empty_cache()
    return det


def _embed_prefill(name, seed):
    """(d) a backbone that takes embeddings, at full width and depth in
    bf16: the counted prefill at ``FAMILY_SEQ`` from seeded embeds (and
    M-RoPE positions with an arange temporal row for qwen2-vl)."""
    import torch

    model, params, g, det = _family_model(name, seed)
    cfg = model.cfg
    batch = {"embeds": torch.randn(1, FAMILY_SEQ, cfg.d_model, generator=g,
                                   device="cuda")}
    if cfg.mrope:
        batch["positions"] = _mrope_positions(g, FAMILY_SEQ, arange_t=True)
    launches, worst, case, pre = _family_prefill(name, model, params, batch)
    det.update(pre)
    del params
    torch.cuda.empty_cache()
    return launches, worst, case, det


def _family_launchers():
    """(e) ``launch.serve`` and ``launch.train`` on jamba --reduced on the
    card (train: 10 steps, checkpoints under ``build/``, removed)."""
    import shutil

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    s = launch_serve.main(["--arch", JAMBA_CONFIG, "--reduced", "--device",
                           "cuda"])
    check(s["n_requests"] == 16, f"launch.serve drained {s['n_requests']}")
    tmp = tempfile.mkdtemp(prefix="launch-train-",
                           dir=os.path.join(ROOT, "build"))
    try:
        res = launch_train.main(["--arch", JAMBA_CONFIG, "--reduced",
                                 "--steps", "10", "--batch", "4", "--seq",
                                 "64", "--ckpt-every", "5", "--ckpt-dir",
                                 tmp, "--device", "cuda"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loss = res.metrics_history[-1]["loss"] if res.metrics_history else None
    check(res.final_step == 10 and loss is not None and math.isfinite(loss),
          f"launch.train ended at {res.final_step}, loss {loss}")
    log(f"family launchers {JAMBA_CONFIG} --reduced on the card: serve "
        f"{s['n_requests']} requests at {s['throughput_tok_s']:.3f} tokens/s"
        f", train 10 steps to loss {loss:.6f}")
    return {"serve": s, "train_loss": loss}


def phase_families(smi):
    """Phase 20: the LM families. (a) full-width sublayers in float32
    against the CPU port, (b) jamba in bf16, (c) falcon-mamba's engine,
    (d) qwen2-vl and hubert prefill, (e) the launchers. Returns (K6
    launches summed over the counted prefills, worst |kernel - plain|, K6
    timing rows, one a model at its layer 0's inputs, details)."""
    import torch
    from repro_torch.core.qir import full_fp32

    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    with full_fp32():
        sub = {"jamba_moe": _moe_sublayer(JAMBA_CONFIG, [(1, 128), (4, 1)],
                                          g),
               "llama4_moe": _moe_sublayer("llama4-scout-17b-16e",
                                           [(1, 128), (4, 1)], g),
               "jamba_mamba": _mamba_sublayer(g),
               "qwen2_vl_mrope": _mrope_sublayer(g)}
    out = {"sublayers": sub}
    k6, worst, rows = 0, 0.0, []
    for name, run in ((JAMBA_CONFIG, lambda: _jamba(smi)),
                      ("qwen2-vl-2b", lambda: _embed_prefill("qwen2-vl-2b",
                                                             SEED + 22)),
                      ("hubert-xlarge", lambda: _embed_prefill(
                          "hubert-xlarge", SEED + 23))):
        launches, w, case, out[name] = run()
        k6 += launches["flash_attention"]
        worst = max(worst, w)
        rows.append(time_case(case, reps=5, inner=10))
        del case
    out["falcon-mamba-7b"] = _falcon_engine(smi)
    out["launchers"] = _family_launchers()
    return k6, worst, rows, out


def phase_family_profile():
    """Last, with phase 9's: jamba at ``JAMBA_LAYERS`` layers again (same
    seed), one prefill and one decode step at batch 4 and at batch 1 under
    ``torch.profiler``; then falcon-mamba-7b in float32, one decode step at
    each batch. Returns the breakdowns (the decode steps' idle share says
    whether the host holds the card back)."""
    import torch
    from repro_torch.core.qir import full_fp32

    model, params, g, _ = _family_model(JAMBA_CONFIG, SEED + 20,
                                        n_layers=JAMBA_LAYERS)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (1, FAMILY_SEQ),
                                     generator=g, device="cuda")}
    model.prefill(params, batch)
    prof = {"prefill": _device_breakdown(lambda: model.prefill(params,
                                                                batch))}
    log(f"family profile {JAMBA_CONFIG} {model.cfg.dtype} prefill: "
        f"{json.dumps(prof['prefill'])}")
    prof.update(_decode_profiles(JAMBA_CONFIG, model, params, g))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    name = "falcon-mamba-7b"
    model, params, g, _ = _family_model(name, SEED + 21, dtype="float32")
    with full_fp32():
        prof[name] = _decode_profiles(name, model, params, g)
    del params
    torch.cuda.empty_cache()
    return prof


def _decode_profiles(name, model, params, g):
    """One decode step at batch 4 and at batch 1 under ``torch.profiler``,
    each after an untraced one; then a batch-4 step replayed from its
    graph (phase 27 (b))."""
    out = {}
    for b in (4, 1):
        decode = _decode_call(model, params, g, b)
        decode()
        out[f"decode_batch{b}"] = d = _device_breakdown(decode)
        log(f"family profile {name} {model.cfg.dtype} decode batch {b}: "
            f"{json.dumps(d)}")
    out["decode_batch4_replay"] = d = _device_breakdown(
        _replayed(_decode_call(model, params, g, 4)))
    log(f"family profile {name} {model.cfg.dtype} decode batch 4 replayed: "
        f"{json.dumps(d)}")
    return out


# ---------------------------------------------------------------------------
# phase 21: the int8 serve path (K5 on every linear); phase 22: the mesh
# ---------------------------------------------------------------------------

INT8_SEQ = LM_SEQ                # the int8 prefill: 1 x 4096, as phase 9's
#: K5's launches in one pass of full-width llama3-8b: 7 linears (q, k, v,
#: o, gate, up, down) x 32 layers + the head
K5_PER_PASS = 7 * 32 + 1
MESH_DDP_STEPS = 60              # the reference's test_ddp_compressed_step


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _int8_rows(cases, counts):
    """K5 timed at each of the int8 prefill's shapes on the layer's own
    codes: kernel, plain version, ``torch._int_mm`` + the scale (cuBLAS
    int8, the same function in two calls), bound; ``launches`` is the
    shape's count in the counted prefill."""
    import torch
    from repro_torch.kernels import ops, ref

    rows = []
    for (m, k, n), (x, w, sc) in cases.items():
        nbytes, nops = m * k + k * n + 4 * n + 4 * m * n, k5_ops(m, k, n)
        row = {"kernel": "qmatmul", "model": f"{LM_CONFIG} int8",
               "stage": "prefill", "shape": f"M={m} K={k} N={n}",
               "bytes": nbytes, "ops": nops, "launches": counts[(m, k, n)],
               "ms": time_ms(lambda: ops.qmatmul(x, w, sc), reps=5, inner=5),
               "plain_ms": time_ms(lambda: ref.qmatmul_ref(x, w, sc),
                                   reps=3, inner=1),
               "library_ms": time_ms(
                   lambda: torch._int_mm(x, w).to(torch.float32) * sc,
                   reps=5, inner=5),
               "bound_ms": bound_ms(nbytes, nops, INT8_OPS_PER_S),
               "bound_by": bound_by(nbytes, nops, INT8_OPS_PER_S)}
        row["int8_peak_share"] = nops / (row["ms"] * 1e-3) / INT8_OPS_PER_S
        rows.append(row)
        log(f"time qmatmul {LM_CONFIG} int8 prefill {row['shape']} x "
            f"{row['launches']}: kernel {row['ms']:.6f} ms (tile "
            f"{ops.qmatmul_plan(m, k, n)['block_m']} x "
            f"{ops.qmatmul_plan(m, k, n)['block_n']}), plain "
            f"{row['plain_ms']:.6f} ms, torch._int_mm + scale "
            f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}), {row['int8_peak_share']:.1%} of the int8 "
            f"peak")
    return rows


def _counted_int8(fn, checks):
    """Counters to 0, ``fn()``, counters read; K5's calls caught: the
    shape (M, K, N) of each, in order (``(M, K, N, "int32")`` for the
    accumulator mode, ``scale`` None), and for the launches whose index is
    in ``checks`` the output held against ``ref.qmatmul_ref`` bit for bit
    and the inputs kept, one set a shape. Returns (launches, shapes, worst
    |kernel - plain|, {shape: inputs}, ``fn()``'s result)."""
    import torch
    from repro_torch.kernels import ops, ref

    real = ops.qmatmul
    shapes, kept, worst = [], {}, [0.0]

    def catch(x_int, w_int, scale, *a, **kw):
        out = real(x_int, w_int, scale, *a, **kw)
        i = len(shapes)
        shape = (x_int.shape[0], x_int.shape[1], w_int.shape[1])
        if scale is None:
            shape += ("int32",)
        shapes.append(shape)
        if i in checks:
            want = ref.qmatmul_ref(x_int, w_int, scale, *a, **kw)
            err = float((out - want).abs().max())
            worst[0] = max(worst[0], err)
            check(torch.equal(out, want), f"int8 K5 launch {i} {shape}: "
                                          f"max err {err} against the plain "
                                          f"version")
            del want
            kept.setdefault(shape, (x_int, w_int, scale))
        return out

    ops.qmatmul = catch
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(ops.launches)
    finally:
        ops.qmatmul = real
    return launches, shapes, worst[0], kept, out


def phase_int8_serve(smi, lm_decode_ms):
    """Phase 21 (module docstring), and phase 27 (b)'s llama3-8b engines
    (``lm_decode_ms``: phase 9's eager bf16 decode step, printed beside
    theirs). Returns (K5 launches of the counted prefill, worst |kernel -
    plain|, timing rows, details)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples.serve_lm import serve
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    from repro_torch.obs import timer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(LM_CONFIG)
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    with torch.inference_mode():
        params = model.init(g, device="cuda")
        torch.cuda.synchronize()
        t0 = timer.now()
        qparams = model.quantize_params(params, bits=8)
        torch.cuda.synchronize()
        quant_s = timer.now() - t0
    out = {"card": smi, "quantize_s": quant_s,
           "bf16_tree_bytes": _tree_bytes(params),
           "int8_tree_bytes": _tree_bytes(qparams),
           "int8_leaf_bytes": sum(t.numel() for t in _leaves(qparams)
                                  if t.dtype == torch.int8)}
    log(f"int8 {LM_CONFIG}: quantize_params {quant_s:.3f} s; trees bf16 "
        f"{out['bf16_tree_bytes'] / 2**30:.3f} GiB, int8 "
        f"{out['int8_tree_bytes'] / 2**30:.3f} GiB (int8 codes "
        f"{out['int8_leaf_bytes'] / 2**30:.3f} GiB), both on the card")
    tokens = torch.randint(0, cfg.vocab, (1, INT8_SEQ), generator=g,
                           device="cuda")
    batch = {"tokens": tokens}
    per_layer = 7
    checks = set(range(per_layer)) | set(range(K5_PER_PASS - per_layer - 1,
                                                K5_PER_PASS))
    launches, shapes, worst, kept, logits = _counted_int8(
        lambda: model.prefill(qparams, batch), checks)
    log(f"int8 main-path launches (one prefill, B=1 S={INT8_SEQ}): "
        f"{json.dumps(launches)}; {len(checks)} K5 launches (layers 0 and "
        f"{cfg.n_layers - 1}, the head) equal the plain version bit for "
        f"bit")
    check(launches["qmatmul"] == K5_PER_PASS == len(shapes),
          f"int8 prefill launched qmatmul {launches['qmatmul']} times, "
          f"expected {K5_PER_PASS}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"int8 prefill launched K6 {launches['flash_attention']} times")
    for name in TINY_KERNELS + TRAIN_KERNELS + (HEAD_KERNEL,
                                                "multi_threshold"):
        check(launches[name] == 0, f"int8 prefill launched {name}")
    check(logits.shape == (1, INT8_SEQ, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"int8 logits {tuple(logits.shape)} not finite")
    ref_logits = model.prefill(params, batch)
    out["top1_agreement"] = float(
        (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    out["max_abs_logit_diff"] = float((logits - ref_logits).abs().max())
    out["max_abs_logit"] = float(ref_logits.abs().max())
    log(f"int8 against bf16 logits: top-1 agreement "
        f"{out['top1_agreement']:.4f} over {INT8_SEQ} positions, max "
        f"|diff| {out['max_abs_logit_diff']:.4f} (max |bf16 logit| "
        f"{out['max_abs_logit']:.4f})")
    del logits, ref_logits
    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1

    decode_q = _decode_call(model, qparams, g)
    decode_f = _decode_call(model, params, g)
    dl, dshapes, dworst, dkept, _ = _counted_int8(
        decode_q, set(range(K5_PER_PASS)))
    check(dl["qmatmul"] == K5_PER_PASS,
          f"int8 decode step launched qmatmul {dl['qmatmul']} times")
    worst = max(worst, dworst)
    out["decode_launches"] = dl
    prefill_q = lambda: model.prefill(qparams, batch)   # noqa: E731
    prefill_f = lambda: model.prefill(params, batch)    # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_q()
    torch.cuda.synchronize()
    out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"int8 prefill peak memory {out['prefill_peak_gib']:.3f} GiB "
        f"(both trees on the card)")
    times = {"prefill_bf16": [], "prefill_int8": [], "decode_bf16": [],
             "decode_int8": []}
    for label, fn, n in (("prefill_bf16", prefill_f, 3),
                         ("prefill_int8", prefill_q, 3),
                         ("decode_bf16", decode_f, 10),
                         ("decode_int8", decode_q, 10)):
        times[label].append(_host_ms(fn, n))
    for label, fn, n in (("prefill_int8", prefill_q, 3),
                         ("prefill_bf16", prefill_f, 3),
                         ("decode_int8", decode_q, 10),
                         ("decode_bf16", decode_f, 10)):
        times[label].append(_host_ms(fn, n))
    out["host_ms"] = times
    log(f"int8 times ({smi}; host clock, synchronised, medians in turns "
        f"bf16/int8 then int8/bf16): prefill B=1 S={INT8_SEQ} bf16 "
        f"{times['prefill_bf16']} ms, int8 {times['prefill_int8']} ms; "
        f"decode batch 4 bf16 {times['decode_bf16']} ms, int8 "
        f"{times['decode_int8']} ms")
    prompts = _engine_prompts(cfg.vocab, SEED + 24)
    out["programs"] = {}
    for label, tree in (("bf16", params), ("int8", qparams)):
        _, _, res = _engine_programs(f"{LM_CONFIG} {label}", model, tree,
                                     prompts)
        k5 = res["launches_a_step"].get("qmatmul", 0)
        check(k5 == (K5_PER_PASS if label == "int8" else 0),
              f"{LM_CONFIG} {label}: the decode step's graph holds {k5} K5 "
              f"launches")
        res["eager_readings_ms"] = {
            "phase 9 bf16 decode (batch 4)": lm_decode_ms,
            f"phase 21 {label} decode": times[f"decode_{label}"]}
        out["programs"][label] = res
        log(f"programs {LM_CONFIG} {label}: a decode step replayed "
            f"{res['decode_step_ms']['replay']:.3f} ms beside phase 21's "
            f"eager {times[f'decode_{label}']} ms and phase 9's bf16 "
            f"{lm_decode_ms:.3f} ms ({smi})")
    for label, tree in (("bf16", params), ("int8", qparams)):
        eng, steps, dt = serve(model, tree, device="cuda")
        st = eng.stats()
        check(len(eng.finished) == 8, f"serve_lm {label}: "
                                      f"{len(eng.finished)} of 8 finished")
        out[f"engine_{label}"] = {"steps": steps, "wall_s": dt,
                                  "throughput_tok_s": st["throughput_tok_s"],
                                  "mean_ttft_s": st["mean_ttft_s"]}
        log(f"int8 serve_lm loop {LM_CONFIG} {label} (8 requests, 4 slots, "
            f"12 new tokens): {steps} engine steps in {dt:.3f} s, "
            f"{st['throughput_tok_s']:.3f} tokens/s")
    del params, prefill_f, decode_f, prefill_q, decode_q
    gc.collect()
    torch.cuda.empty_cache()
    rows = _int8_rows(kept, counts)
    check(sum(r["launches"] for r in rows) == K5_PER_PASS,
          "the timed K5 shapes do not cover the prefill's launches")
    dec = {}
    for (m, k, n), (x, w, sc) in dkept.items():
        nbytes, nops = m * k + k * n + 4 * n + 4 * m * n, k5_ops(m, k, n)
        dec[f"M={m} K={k} N={n}"] = d = {
            "launches": dshapes.count((m, k, n)),
            "ms": time_ms(lambda: ops.qmatmul(x, w, sc), reps=5, inner=10),
            "plain_ms": time_ms(lambda: ref.qmatmul_ref(x, w, sc), reps=3,
                                inner=3),
            "bound_ms": bound_ms(nbytes, nops, INT8_OPS_PER_S)}
        log(f"time qmatmul {LM_CONFIG} int8 decode M={m} K={k} N={n} x "
            f"{d['launches']}: kernel {d['ms']:.6f} ms (tile "
            f"{ops.qmatmul_plan(m, k, n)['block_m']} x "
            f"{ops.qmatmul_plan(m, k, n)['block_n']}), plain "
            f"{d['plain_ms']:.6f} ms, bound {d['bound_ms']:.6f} ms")
    out["decode_k5"] = dec
    out["decode_k5_ms"] = sum(d["ms"] * d["launches"] for d in dec.values())
    out["prefill_k5_ms"] = sum(r["ms"] * r["launches"] for r in rows)
    log(f"int8 K5 device time summed over a pass: prefill "
        f"{out['prefill_k5_ms']:.3f} ms, decode step "
        f"{out['decode_k5_ms']:.3f} ms")
    del qparams, kept, dkept
    gc.collect()
    torch.cuda.empty_cache()
    return launches["qmatmul"], worst, rows, out


def phase_int8_profile():
    """Last, with the other profiles: full-width llama3-8b quantized again
    (same seed; the bf16 tree dropped first), one int8 prefill and one
    decode step at batch 4 under ``torch.profiler``: K5's share of the
    device time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    model = Model(get_config(LM_CONFIG))
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    with torch.inference_mode():
        params = model.init(g, device="cuda")
        qparams = model.quantize_params(params, bits=8)
    del params
    torch.cuda.empty_cache()
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (1, INT8_SEQ),
                                     generator=g, device="cuda")}
    decode = _decode_call(model, qparams, g)
    model.prefill(qparams, batch)
    decode()
    replay = _replayed(decode)
    out = {"prefill": _device_breakdown(lambda: model.prefill(qparams,
                                                               batch)),
           "decode": _device_breakdown(decode),
           "decode_replay": _device_breakdown(replay)}
    for k in ("prefill", "decode", "decode_replay"):
        d = out[k]
        if d is not None:
            d["k5_share_of_busy"] = d["ms_by_family"]["qmatmul"] / d[
                "busy_ms"]
        log(f"int8 profile {LM_CONFIG} {k}: {json.dumps(d)}")
    del qparams
    torch.cuda.empty_cache()
    return out


def _mesh_moe(mesh):
    """A reduced jamba MoE sublayer (float32) on the card, forward and
    backward with and without ``mesh``: equal bit for bit; then under
    ``mesh`` as a remat block (``transformer._remat``, "full"): equal
    again, and its recompute, which autograd runs on its device thread,
    saw the mesh."""
    import dataclasses
    import threading

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.models import layers, transformer
    from repro_torch.parallel.sharding import active_mesh, use_mesh_rules

    cfg = get_config(JAMBA_CONFIG).reduced()
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    p = layers.moe_init(g, cfg, device="cuda")
    x = torch.randn((4, 64, cfg.d_model), generator=g, device="cuda")
    calls = []

    def moe(q, x):
        calls.append((threading.get_ident(), active_mesh()))
        return layers.moe_apply(cfg, q, x)

    runs = []
    with full_fp32():
        for m, fn in ((None, moe), (mesh, moe), (mesh, transformer._remat(
                dataclasses.replace(cfg, remat="full"), moe))):
            q = {k: (v.clone().requires_grad_(True) if k != "router"
                     else v) for k, v in p.items()}
            with use_mesh_rules(m):
                y, aux = fn(q, x)
            grads = torch.autograd.grad((y * y).sum() + aux,
                                        [q["wi_gate"], q["wi_up"], q["wo"]])
            runs.append([y.detach(), aux.detach(), *grads])
    same = all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(runs[0], run))
    check(same, "moe_apply under the (1, 1) mesh (plain or remat) differs "
                "from it without one")
    main = threading.get_ident()
    check(len(calls) == 4 and calls[3][0] != main and calls[3][1] is mesh,
          f"the remat block's recompute: {calls[2:]} (main thread {main})")
    q = {k: (v.clone().requires_grad_(True) if k != "router" else v)
         for k, v in p.items()}

    def step(m):
        with full_fp32(), use_mesh_rules(m):
            y, aux = layers.moe_apply(cfg, q, x)
            torch.autograd.grad((y * y).sum() + aux,
                                [q["wi_gate"], q["wi_up"], q["wo"]])

    # the mesh branch's cost on one rank (its collectives are skipped):
    # forward + backward in turns, without / with / with / without
    ms = {"local": [], "mesh": []}
    for label, m in (("local", None), ("mesh", mesh), ("mesh", mesh),
                     ("local", None)):
        ms[label].append(_host_ms(lambda: step(m), 20))
    return {"tokens": 4 * 64, "equal_bit_for_bit": same,
            "recompute_on_autograd_thread_saw_mesh": True,
            "fwd_bwd_ms": ms}


def _mesh_ddp(mesh):
    """The reference's least-squares toy through
    ``make_ddp_compressed_step`` on the card: the loss falls under 0.05 of
    the first in ``MESH_DDP_STEPS`` steps."""
    import numpy as np
    import torch
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.steps import (init_ddp_state,
                                         make_ddp_compressed_step)

    opt = make_optimizer(base_lr=0.05, warmup=1, total=100, weight_decay=0.0)
    state = init_ddp_state({"w": torch.zeros(3, device="cuda")}, opt)
    step = make_ddp_compressed_step(
        lambda p, b: (((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}), opt,
        mesh)
    w_true = np.asarray([2.0, -1.0, 0.5], np.float32)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(MESH_DDP_STEPS):
        x = rng.standard_normal((16, 3)).astype(np.float32)
        state, m = step(state, {"x": x, "y": x @ w_true})
        losses.append(float(m["loss"]))
    check(losses[-1] < 0.05 * losses[0],
          f"compressed DDP loss {losses[0]} -> {losses[-1]}")
    return losses


def _mesh_launcher():
    """``python -m repro_torch.launch.train --reduced --model-parallel 2``
    as a plain child process: its own group of one rank, a (1, 1) mesh."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="launch-mesh-",
                           dir=os.path.join(ROOT, "build"))
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
             "--model-parallel", "2", "--steps", "4", "--batch", "2",
             "--seq", "64", "--ckpt-dir", tmp, "--device", "cuda"],
            env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
            text=True, timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text = r.stdout + r.stderr
    check(r.returncode == 0, f"launch.train --model-parallel 2 exited "
                             f"{r.returncode}: {text[-2000:]}")
    check("mesh {'data': 1, 'model': 1} over 1 ranks" in text
          and "finished at step 4" in text,
          f"launch.train --model-parallel 2: {text[-2000:]}")
    return text.strip().splitlines()


def phase_mesh(smi):
    """Phase 22 (module docstring). Returns details."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_elastic_mesh, mesh_devices
    from repro_torch.obs import timer

    t0 = timer.now()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_elastic_mesh(2)
        shape = tuple(mesh.shape)
        check(shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
              and mesh.device_type == "cuda",
              f"make_elastic_mesh(2) on one rank: {mesh}")
        log(f"mesh: make_elastic_mesh(2) on a one-rank NCCL group -> "
            f"{dict(zip(mesh.mesh_dim_names, shape))} over "
            f"{mesh_devices(mesh)} rank ({torch.cuda.get_device_name(0)})")
        losses = _mesh_ddp(mesh)
        log(f"mesh: make_ddp_compressed_step {MESH_DDP_STEPS} steps on the "
            f"card: loss {losses[0]:.6f} -> {losses[-1]:.6f}")
        moe = _mesh_moe(mesh)
        log(f"mesh: moe_apply ({JAMBA_CONFIG} reduced, 4 x 64 tokens) "
            f"under the (1, 1) mesh, plain and as a remat block, equals it "
            f"without one bit for bit (output, aux, gradients); the "
            f"recompute ran on autograd's device thread under the mesh; "
            f"forward + backward ({smi}, host clock, medians of 20 in "
            f"turns) without the mesh {moe['fwd_bwd_ms']['local']} ms, "
            f"with it {moe['fwd_bwd_ms']['mesh']} ms")
    finally:
        dist.destroy_process_group()
    lines = _mesh_launcher()
    log(f"mesh: launch.train --reduced --model-parallel 2: "
        f"{' | '.join(lines[:2])} ... {lines[-1]}")
    out = {"card": smi, "shape": list(shape), "ddp_losses": losses,
           "moe": moe, "launcher": lines, "wall_s": timer.now() - t0}
    log(f"mesh phase: {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 23: the dry run, the op-trace analysis and the roofline
# ---------------------------------------------------------------------------

#: the dry run's bar, the reference's (``tests/test_roofline_launch.py``):
#: per mesh, 40 cells, 32 of them traced and 8 skipped by assignment
DRYRUN_CELLS, DRYRUN_OK, DRYRUN_SKIPPED = 40, 32, 8
DRYRUN_USEFUL_MAX = 1.5
DRYRUN_TIMEOUT_S = 600
#: measured peak memory over the meta trace's predicted peak
PEAK_RATIO_RANGE = (0.5, 2.0)
#: the steps that fit one card, checked against their meta traces:
#: (label, config, (seq, batch, kind), weight bits, microbatches)
DRYRUN_STEPS = (
    ("train", TRAIN_CONFIG, (TRAIN_SEQ, TRAIN_BATCH, "train"), 16,
     TRAIN_MICROBATCHES),
    ("prefill bf16", LM_CONFIG, (LM_SEQ, 1, "prefill"), 16, 1),
    ("prefill int8", LM_CONFIG, (LM_SEQ, 1, "prefill"), 8, 1),
)
#: the device phase 23 (b) runs its steps on (the CPU in a rehearsal)
DRYRUN_DEVICE = "cuda"


def _run_module(args, cwd, timeout):
    """``python -m <args>`` with ``src`` on the path; (rc, stdout, stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


#: cells that phase 23's dry run traces at once (its ``--jobs``)
DRYRUN_PROCS = 8
#: (e) of phase 25 reads these single-pod cells' collectives
DRYRUN_COLLECTIVE_CELLS = ("falcon-mamba-7b train_4k", "llama3-8b prefill_32k",
                           "llama3-8b decode_32k")
#: the strategies whose single-pod dry runs phase 23 adds, each under
#: the same ``--jobs``; under ``ep`` the cells of this config are errors
#: (its 8 experts do not split over the 16-wide model axis; the
#: reference's jit refuses that sharding), every other cell's status the
#: baseline's
DRYRUN_STRATEGIES = ("seqpar", "ep")
DRYRUN_EP_REFUSED = "grok-1-314b"


def _start_dryrun_strategies(tmp):
    """Start ``launch.dryrun --all --mesh single --strategy <s> --jobs
    DRYRUN_PROCS`` for each of ``DRYRUN_STRATEGIES`` beside the baseline's
    dry run (each run's tail is a few long SSM cells, which leave the
    others' cores free); ``_wait_dryrun_strategies`` collects them, and
    a run left behind by a failure is killed at exit."""
    import atexit

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    procs = {}
    for st in DRYRUN_STRATEGIES:
        arts = os.path.join(tmp, "artifacts", st)
        procs[st] = (arts, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "single", "--strategy", st, "--tag", st, "--jobs",
             str(DRYRUN_PROCS), "--out", arts], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def stop():
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    return _now(), procs


def _wait_dryrun_strategies(started):
    """{strategy: (its records' directory, (rc, stdout, stderr), seconds
    from the start)} of ``_start_dryrun_strategies``' runs."""
    t0, procs = started
    out = {}
    for st, (arts, p) in procs.items():
        so, se = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        out[st] = (arts, (p.returncode, so, se), _now() - t0)
    return out


def _dryrun_strategy(strategy, run, base):
    """The records of ``launch.dryrun --all --mesh single --strategy
    <strategy>`` (``run``: ``_wait_dryrun_strategies``' entry) beside the
    baseline's single-pod records ``base`` ({(arch, shape): record}):
    the statuses the baseline's (under ``ep`` the applicable cells of
    ``DRYRUN_EP_REFUSED`` errors naming the experts' dimension, and the
    run's exit code 1 for them alone), every ok cell with its collective
    bytes, no ``not_ported`` key; under ``seqpar`` every decode cell the
    baseline's FLOPs and collectives, every other ok cell reduce-scatters.
    Returns the counts and the seconds."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.roofline import load_artifacts

    arts, (rc, so, se), wall = run
    recs = {(r["arch"], r["shape"]): r for r in load_artifacts(arts)}
    check(set(recs) == set(base), f"dryrun {strategy}: cells "
                                  f"{sorted(set(recs) ^ set(base))} differ")
    refused = {k for k, r in base.items() if strategy == "ep"
               and k[0] == DRYRUN_EP_REFUSED and r["status"] == "ok"}
    errors = {k for k, r in recs.items() if r["status"] == "error"}
    check(errors == refused, f"dryrun {strategy}: errors "
                             f"{[(k, recs[k]['error'][:200]) for k in errors]}"
                             f", expected {sorted(refused)}")
    for k in errors:
        check(recs[k]["error"].startswith("ValueError: dimension 1 of ")
              and "does not split into 16 blocks" in recs[k]["error"],
              f"dryrun {strategy} {k}: {recs[k]['error'][:300]}")
    check(rc == (1 if refused else 0),
          f"dryrun --strategy {strategy}: rc {rc}: {so[-1000:]} "
          f"{se[-2000:]}")
    n_rs = 0
    for k, r in recs.items():
        check("not_ported" not in r, f"dryrun {strategy} {k}: not_ported")
        if k in errors:
            continue
        check(r["status"] == base[k]["status"],
              f"dryrun {strategy} {k}: {r['status']}, the baseline's "
              f"{base[k]['status']}")
        if r["status"] != "ok":
            continue
        check(r["collective_bytes_per_device"] == sum(
            r["collectives_by_type"].values()) > 0,
            f"dryrun {strategy} {k}: collective bytes "
            f"{r['collective_bytes_per_device']}")
        if strategy == "seqpar" and SHAPES[k[1]].kind == "decode":
            for key in ("hlo_flops_per_device", "collectives_count",
                        "collectives_by_type"):
                check(r[key] == base[k][key],
                      f"dryrun seqpar {k}: {key} {r[key]} != the "
                      f"baseline's {base[k][key]}")
        elif strategy == "seqpar":
            check(r["collectives_count"].get("reduce-scatter", 0) > 0,
                  f"dryrun seqpar {k}: no reduce-scatter: "
                  f"{r['collectives_count']}")
            n_rs += 1
    out = {"s": wall, "ok": sum(r["status"] == "ok" for r in recs.values()),
           "skipped": sum(r["status"] == "skipped" for r in recs.values()),
           "error": sorted(f"{a} {b}" for a, b in errors),
           "reduce_scatter_cells": n_rs}
    log(f"dryrun --strategy {strategy} --mesh single: {json.dumps(out)} "
        f"({so.strip().splitlines()[-1] if so.strip() else ''})")
    return out


def _dryrun_all():
    """(a) ``launch.dryrun --all --mesh both`` over every cell of both
    meshes on the meta device, ``DRYRUN_PROCS`` cells at a time, the
    roofline tables and the bench harness's
    roofline section, from child processes; the reference's bar on the
    records; every ok cell's rank-local collectives."""
    import importlib
    import shutil

    from repro_torch.launch.roofline import analyze, load_artifacts

    # the fake process group's module is internal to torch: it must exist
    # in the card's torch
    importlib.import_module("torch.testing._internal.distributed.fake_pg")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-",
                                     dir=os.path.join(ROOT, "build")) as tmp:
        arts = os.path.join(tmp, "artifacts", "dryrun")
        strategies = _start_dryrun_strategies(tmp)
        t0 = _now()
        rc, so, se = _run_module(["repro_torch.launch.dryrun", "--all",
                                  "--mesh", "both", "--jobs",
                                  str(DRYRUN_PROCS), "--out", arts], ROOT,
                                 DRYRUN_TIMEOUT_S)
        out["dryrun_s"] = _now() - t0
        check(rc == 0, f"launch.dryrun --all --mesh both: rc {rc}: "
                       f"{so[-2000:]} {se[-2000:]}")
        log(f"dryrun: {so.strip().splitlines()[-1]} in "
            f"{out['dryrun_s']:.3f} s (the meta device, {DRYRUN_PROCS} "
            f"cells at a time)")
        recs = {f"{r['arch']} {r['shape']}": r
                for r in load_artifacts(arts) if r["mesh"] == "single"}
        out["records"] = {k: recs[k] for k in DRYRUN_COLLECTIVE_CELLS}
        base = {(r["arch"], r["shape"]): r for r in load_artifacts(arts)
                if r["mesh"] == "single"}
        runs = _wait_dryrun_strategies(strategies)
        out["strategies"] = {st: _dryrun_strategy(st, runs[st], base)
                             for st in DRYRUN_STRATEGIES}
        for r in load_artifacts(arts):
            check(r["status"] != "ok" or (
                r["collective_bytes_per_device"] is not None
                and r["collective_bytes_per_device"] > 0),
                f"dryrun {r['arch']} x {r['shape']} x {r['mesh']}: no "
                f"collective bytes")
        tables = {}
        for mesh in ("single", "multi"):
            rc, so, se = _run_module(["repro_torch.launch.roofline", "--dir",
                                      arts, "--mesh", mesh], ROOT, 120)
            check(rc == 0 and "n/a" not in so
                  and "most collective-bound   : n/a" not in so,
                  f"launch.roofline --mesh {mesh}: rc {rc}: {se[-2000:]} "
                  f"{so[-2000:]}")
            tables[mesh] = so
            log(f"roofline {mesh}: " + " | ".join(
                ln for ln in so.splitlines() if ln.startswith(
                    ("worst", "most"))))
        rc, so, se = _run_module(["repro_torch.bench.run", "--only",
                                  "roofline"], tmp, 300)
        check(rc == 0 and "1/1 sections ok" in so,
              f"bench.run --only roofline: rc {rc}: {so[-1000:]} "
              f"{se[-2000:]}")
        rows = [analyze(r) for r in load_artifacts(arts)]
        for mesh in ("single", "multi"):
            cells = [r for r in rows if r.mesh == mesh
                     and r.tag == "baseline"]
            ok = [r for r in cells if r.status == "ok"]
            n_skip = sum(r.status == "skipped" for r in cells)
            check(len(cells) == DRYRUN_CELLS and len(ok) == DRYRUN_OK
                  and n_skip == DRYRUN_SKIPPED,
                  f"dryrun {mesh}: {len(cells)} cells, {len(ok)} ok, "
                  f"{n_skip} skipped, errors "
                  f"{[(r.arch, r.shape, r.reason[:200]) for r in cells if r.status == 'error']}")
            for r in ok:
                check(r.t_compute > 0
                      and 0 < r.useful_ratio <= DRYRUN_USEFUL_MAX,
                      f"dryrun {mesh} {r.arch} x {r.shape}: compute "
                      f"{r.t_compute}, useful {r.useful_ratio}")
            out[mesh] = {f"{r.arch} {r.shape}": {
                "compute_s": r.t_compute, "memory_s": r.t_memory,
                "collective_s": r.t_collective,
                "dominant": r.dominant, "useful": r.useful_ratio,
                "roofline_fraction": r.roofline_fraction} for r in ok}
        dest = os.path.join(ROOT, "chiprun_out", "dryrun")
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(arts, dest)
        with open(os.path.join(ROOT, "chiprun_out", "roofline.txt"),
                  "w") as f:
            for mesh, table in tables.items():
                f.write(f"--- {mesh} ---\n{table}\n")
    log(f"dryrun: {DRYRUN_CELLS} cells a mesh, {DRYRUN_OK} ok, "
        f"{DRYRUN_SKIPPED} skipped, useful ratio in (0, "
        f"{DRYRUN_USEFUL_MAX}] on every ok cell, both meshes; records "
        f"under chiprun_out/dryrun, tables in chiprun_out/roofline.txt")
    return out


def _kernel_row_ops(name, d):
    """One call's operations by the formula of its kernel row."""
    from repro_torch.launch.hlo_analysis import flash_live_pairs

    if name == "qmatmul":
        return k5_ops(d["m"], d["k"], d["n"])
    pairs = flash_live_pairs(d["sq"], d["sk"], d["causal"], d["window"],
                             d["q_offset"], d["kv_len"])
    if name == "flash_attention":
        return k6_ops(d["b"], d["h"], d["d"], pairs)
    return k6_bwd_ops(d["b"], d["h"], d["d"], pairs)


def _card_trees(model, shape, bits, seed):
    """The step's trees on the card: seeded weights (quantized for an
    int8 step), the optimizer state (train), seeded tokens (and
    labels)."""
    import torch
    from repro_torch.optim.adamw import make_optimizer

    dev = DRYRUN_DEVICE
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(g, device=dev)
    if bits < 16:
        params = model.quantize_params(params, bits)
    gc.collect()
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (B, S),
                                     generator=g, device=dev,
                                     dtype=torch.int32)}
    if shape.kind == "train":
        batch["labels"] = torch.randint(0, model.cfg.vocab, (B, S),
                                        generator=g, device=dev,
                                        dtype=torch.int32)
    trees = {"params": params, "batch": batch}
    if shape.kind == "train":
        trees["opt"] = make_optimizer().init(params)
    return trees


def _step_ms(model, shape, trees, microbatches, reps=3):
    """Host ms of the step without the analysis (synchronised): the
    median of ``reps`` after one warm call."""
    import torch
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.steps import TrainState, make_train_step

    if shape.kind == "train":
        step = make_train_step(model, make_optimizer(),
                               microbatches=microbatches)
        state = TrainState(trees["params"], trees["opt"])
        run = lambda: step(state, trees["batch"])      # noqa: E731
    else:
        run = lambda: model.prefill(trees["params"], trees["batch"])  # noqa
    run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = _now()
        run()
        torch.cuda.synchronize()
        times.append((_now() - t0) * 1e3)
    return statistics.median(times), times


def _dryrun_step(label, arch, dims, bits, microbatches, smi):
    """(b) One step: its meta trace against the same step traced on the
    card under the same analysis; then timed without the analysis beside
    its roofline bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import compute_seconds, memory_seconds

    cfg = get_config(arch)
    shape = ShapeConfig(f"{dims[2]}_{dims[1]}x{dims[0]}", dims[0], dims[1],
                        dims[2])
    model, meta_trees = dryrun._abstract_trees(cfg, shape, bits)
    t0 = _now()
    meta = dryrun.trace_step(model, shape, meta_trees, microbatches)
    meta_s = _now() - t0
    del meta_trees
    trees = _card_trees(model, shape, bits, SEED + 23)
    tree_bytes = sum(t.numel() * t.element_size() for t in leaves(trees))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what the caching allocator holds at the start besides the trees
    # (earlier phases' tensors, cuBLAS workspaces): in the measured peak,
    # not in the prediction
    others = torch.cuda.memory_allocated() - tree_bytes
    ops.reset_launches()
    t0 = _now()
    card = dryrun.trace_step(model, shape, trees, microbatches)
    torch.cuda.synchronize()
    card_s = _now() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.launches)
    check(card.stats.flops == meta.stats.flops,
          f"{label}: FLOPs on the card {card.stats.flops!r} != meta "
          f"{meta.stats.flops!r}")
    check(card.argument_bytes == meta.argument_bytes == tree_bytes,
          f"{label}: argument bytes card {card.argument_bytes}, meta "
          f"{meta.argument_bytes}, the trees {tree_bytes}")
    ratio = peak / meta.peak_bytes
    check(PEAK_RATIO_RANGE[0] <= ratio <= PEAK_RATIO_RANGE[1],
          f"{label}: measured peak {peak} B over the predicted "
          f"{meta.peak_bytes} B = {ratio:.4f}, outside {PEAK_RATIO_RANGE}")
    check([(k[0], k[1]) for k in card.kernels]
          == [(k[0], k[1]) for k in meta.kernels],
          f"{label}: the card's kernel calls differ from the meta trace's")
    calls = {}
    for name, d, n_ops, _ in card.kernels:
        calls[name] = calls.get(name, 0) + 1
        want = _kernel_row_ops(name, d)
        check(n_ops == want, f"{label}: {name} {d}: counted {n_ops}, its "
                             f"kernel row {want}")
    check(all(launches[n] == c for n, c in calls.items())
          and sum(launches.values()) == len(card.kernels),
          f"{label}: launches {launches} != the analysis' calls {calls}")
    shapes = sorted({(k[0], tuple(sorted(k[1].items())))
                     for k in card.kernels})
    step_ms, times = _step_ms(model, shape, trees, microbatches)
    t_c = compute_seconds(meta.stats.flops, bits)
    state = sum(t.numel() * t.element_size()
                for t in leaves({k: v for k, v in trees.items()
                                 if k != "batch"}))
    t_m = memory_seconds(max(meta.bytes_accessed, state + meta.output_bytes))
    bound_ms_ = max(t_c, t_m) * 1e3
    res = {"card": smi, "flops": meta.stats.flops,
           "argument_bytes": meta.argument_bytes,
           "predicted_peak_bytes": meta.peak_bytes,
           "card_trace_peak_bytes": card.peak_bytes,
           "measured_peak_bytes": peak, "peak_ratio": ratio,
           "held_besides_trees_bytes": others,
           "bytes_accessed": meta.bytes_accessed, "calls": calls,
           "kernel_shapes": len(shapes), "meta_trace_s": meta_s,
           "card_trace_s": card_s, "step_ms": step_ms, "step_ms_all": times,
           "compute_ms": t_c * 1e3, "memory_ms": t_m * 1e3,
           "bound_ms": bound_ms_,
           "dominant": "compute" if t_c >= t_m else "memory",
           "bound_share": bound_ms_ / step_ms}
    log(f"dryrun check {label} ({arch}, {dims[1]} x {dims[0]}, "
        f"{microbatches} microbatch(es)) ({smi}): FLOPs meta == card "
        f"{meta.stats.flops:.6e}; argument bytes meta == card == trees "
        f"{tree_bytes}; peak measured {peak / 2**30:.3f} GiB / predicted "
        f"{meta.peak_bytes / 2**30:.3f} GiB = {ratio:.4f} (the card's own "
        f"trace {card.peak_bytes / 2**30:.3f} GiB; {others / 2**30:.3f} GiB "
        f"held at the start besides the trees); kernel calls {calls} "
        f"over {len(shapes)} shapes, each equal to its kernel row's ops; "
        f"traces meta {meta_s:.3f} s, card {card_s:.3f} s")
    log(f"dryrun check {label}: step {step_ms:.3f} ms (median of "
        f"{len(times)}, host clock, synchronised, no analysis); roofline "
        f"row: compute {t_c * 1e3:.3f} ms, memory {t_m * 1e3:.3f} ms "
        f"({meta.bytes_accessed:.4e} B accessed), bound {bound_ms_:.3f} ms "
        f"({res['dominant']}): the bound is {res['bound_share']:.1%} of the "
        f"step")
    del trees, card, meta
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_dryrun(smi):
    """Phase 23 (module docstring). Returns details."""
    t0 = _now()
    out = {"all": _dryrun_all()}
    for label, arch, dims, bits, mb in DRYRUN_STEPS:
        out[label] = _dryrun_step(label, arch, dims, bits, mb, smi)
    out["wall_s"] = _now() - t0
    log(f"dryrun phase: {out['wall_s']:.3f} s (the dry run "
        f"{out['all']['dryrun_s']:.3f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 24: the SPMD train step over two ranks that share the card
# ---------------------------------------------------------------------------

SPMD_RANKS = 2
SPMD_STEPS = 3
SPMD_TIMEOUT_S = 600
#: (a) reduced llama3-8b, float32, the chunked attention (K6) at S 64
SPMD_SMALL = "llama3-8b"
SPMD_SMALL_MESHES = ((1, 2), (2, 1))
SPMD_SMALL_BATCH, SPMD_SMALL_SEQ = 8, 64
#: the reference's bar between its SPMD step and one device
SPMD_LOSS_RTOL = 2e-3
#: the first step's gradient blocks against the one-rank gradients', of
#: each leaf's largest |g|
SPMD_GRAD_TOL = 1e-5
#: (b) internlm2-1.8b at its published widths, all 24 layers, bf16,
#: remat "full", S 4096 on the (1, 2) mesh: 2 sequences a step in one
#: microbatch (phase 19's step takes 4 in 2), as two ranks share the card
SPMD_FULL = "internlm2-1.8b"
SPMD_FULL_MESH = (1, 2)
SPMD_FULL_BATCH = 2
#: bf16: the SPMD step's losses against one rank's on the same batches
SPMD_FULL_RTOL = 1e-2
#: (c) the checkpoint's mesh
SPMD_CKPT_MESH = (2, 1)


def _spmd_batches(vocab, seq, batch):
    from repro_torch.data.synthetic import SyntheticTokens

    data = SyntheticTokens(vocab=vocab, seq_len=seq, seed=SEED)
    return [data.batch(t, batch) for t in range(SPMD_STEPS)]


def _clone_tree(tree):
    from repro_torch.core.pytree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _spmd_mesh(shape, cfg, batch, strategy="baseline"):
    """The (data, model) mesh of ``shape`` over the ranks and its rules:
    ``arch_rules``, the strategy's on top."""
    from repro_torch.launch.dryrun import (arch_rules, batch_logical_axes,
                                           combined_strategy_rules)
    from repro_torch.launch.mesh import make_elastic_mesh

    mesh = make_elastic_mesh(shape[1])
    check(tuple(mesh.shape) == tuple(shape), f"mesh {tuple(mesh.shape)}, "
                                             f"expected {shape}")
    rules = arch_rules(cfg, mesh, batch_logical_axes(batch, mesh))
    rules.update(combined_strategy_rules(strategy, cfg, mesh, None))
    return mesh, rules


def _spmd_small(rank):
    """(a): reduced llama3-8b in float32 (TF32 off) with K6, on (1, 2)
    and (2, 1) against one rank on the same weights and batches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import leaves
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.parallel.sharding import (local_block, shard_tree,
                                               spec_leaves, use_mesh_rules)
    from repro_torch.train.steps import (TrainState, batch_to_device,
                                         make_train_step, step_grads,
                                         train_state_specs)

    cfg = dataclasses.replace(get_config(SPMD_SMALL).reduced(),
                              attn_impl="chunked")
    model = Model(cfg)
    batches = _spmd_batches(cfg.vocab, SPMD_SMALL_SEQ, SPMD_SMALL_BATCH)
    b0 = batch_to_device(batches[0], "cuda")

    def opt():
        return make_optimizer(base_lr=1e-3, warmup=1, total=10)

    def run(params):
        step = make_train_step(model, opt())
        state = TrainState(params, opt().init(params))
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses

    out = {}
    with full_fp32():
        full = model.init(torch.Generator(device="cuda").manual_seed(
            SEED + 40), device="cuda")
        _, _, one_grads = step_grads(model, _clone_tree(full), b0)
        one = run(_clone_tree(full))
        for shape in SPMD_SMALL_MESHES:
            mesh, rules = _spmd_mesh(shape, cfg, SPMD_SMALL_BATCH)
            with use_mesh_rules(mesh, rules):
                specs = train_state_specs(model)
                params = shard_tree(full, specs.params)
                _, _, grads = step_grads(model, params, b0, 1, specs.params)
                worst = 0.0
                for g, want, spec in zip(grads, one_grads,
                                         spec_leaves(specs.params)):
                    block = local_block(want, spec)
                    err = float((g - block).abs().max())
                    scale = float(want.abs().max())
                    check(g.shape == block.shape
                          and err <= SPMD_GRAD_TOL * scale,
                          f"spmd {shape} rank {rank}: a gradient block "
                          f"{tuple(g.shape)} off the one-rank one by {err} "
                          f"(largest |g| {scale})")
                    worst = max(worst, err / scale if scale else err)
                losses = run(params)
            check(all(abs(a - b) <= SPMD_LOSS_RTOL * abs(b)
                      for a, b in zip(losses, one)),
                  f"spmd {shape}: losses {losses}, one rank {one}")
            out[f"{shape[0]}x{shape[1]}"] = {
                "losses": losses, "one_rank_losses": one,
                "grad_err_of_max": worst,
                "leaves": len(leaves(params))}
    return out


def _spmd_checked_k6(caught):
    """Wrappers of K6's forward and backward launches that hold each one
    against its plain version on the same inputs (the plain versions are
    not launches), keeping the first launches' inputs in ``caught``."""
    from repro_torch.kernels import ops, ref

    real_fwd, real_bwd = ops._flash_forward, ops.flash_attention_bwd
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_rel": 0.0, "n_fwd": 0,
             "n_bwd": 0}

    def fwd(q, k, v, causal, window, q_offset, kv_len, want_lse):
        out, lse = real_fwd(q, k, v, causal, window, q_offset, kv_len,
                            want_lse)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        want = ref.flash_attention_ref(q, k, v, **kw)
        err, rel = _k6_error(out, want)
        check(rel["max"] <= FAMILY_K6_TOL["max"]
              and rel["mean"] <= FAMILY_K6_TOL["mean"],
              f"spmd K6 {tuple(q.shape)} / {tuple(k.shape)}: off its plain "
              f"version by {rel['max']:.3g} of max |plain| and "
              f"{rel['mean']:.3g} of mean |plain|")
        worst["fwd"] = max(worst["fwd"], err)
        worst["fwd_rel"] = max(worst["fwd_rel"], rel["max"])
        worst["n_fwd"] += 1
        if "fwd" not in caught:
            caught["fwd"] = tuple(t.detach().clone() for t in (q, k, v)) + (
                kw,)
        return out, lse

    def bwd(q, k, v, out, lse, do, **kw):
        got = real_bwd(q, k, v, out, lse, do, **kw)
        worst["bwd"] = max(worst["bwd"], _check_bwd(
            f"spmd {tuple(q.shape)} / {tuple(k.shape)}", q, k, v, out, lse,
            do, kw, got))
        worst["n_bwd"] += 1
        if "bwd" not in caught:
            caught["bwd"] = tuple(t.detach().clone()
                                  for t in (q, k, v, out, lse, do)) + (kw,)
        return got

    def restore():
        ops._flash_forward, ops.flash_attention_bwd = real_fwd, real_bwd

    ops._flash_forward, ops.flash_attention_bwd = fwd, bwd
    return worst, restore


def _spmd_full(rank, smi):
    """(b): internlm2-1.8b at full width on (1, 2): the counted run of 3
    steps (every K6 launch of the first held against its plain version),
    the step times and peak memory; then one rank (rank 0, while rank 1
    waits) trains the same weights on the same batches; rank 0 times K6
    and its backward at the rank-local shape."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.obs import timer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         train_state_specs)

    cfg = get_config(SPMD_FULL)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16"
          and (cfg.attn_impl == "chunked"
               or cfg.attn_impl == "auto" and TRAIN_SEQ > 2048),
          f"{SPMD_FULL}: expected bf16, remat full and the chunked "
          f"attention (K6)")
    model = Model(cfg)
    batches = _spmd_batches(cfg.vocab, TRAIN_SEQ, SPMD_FULL_BATCH)

    def opt():
        return make_optimizer(base_lr=3e-4, warmup=2, total=SPMD_STEPS)

    def init():
        return model.init(torch.Generator(device="cuda").manual_seed(
            SEED + 41), device="cuda")

    mesh, rules = _spmd_mesh(SPMD_FULL_MESH, cfg, SPMD_FULL_BATCH)
    caught = {}
    losses, step_s = [], []
    with use_mesh_rules(mesh, rules):
        specs = train_state_specs(model)
        params = shard_tree(init(), specs.params)
        torch.cuda.empty_cache()
        state = TrainState(params, opt().init(params))
        step = make_train_step(model, opt())
        worst, unwrap = _spmd_checked_k6(caught)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            for i in range(SPMD_STEPS):
                t0 = timer.now()
                state, m = step(state, batches[i])
                losses.append(float(m["loss"]))         # synchronises
                step_s.append(timer.now() - t0)
                if i == 0:
                    unwrap()
            torch.cuda.synchronize()
            launches = dict(ops.launches)
        finally:
            unwrap()
        peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    check(launches["flash_attention"] == 2 * SPMD_STEPS * n
          and launches["flash_attention_bwd"] == SPMD_STEPS * n,
          f"spmd rank {rank} launches {launches}: expected "
          f"{2 * SPMD_STEPS * n} K6 and {SPMD_STEPS * n} K6 backward")
    for k, v in launches.items():
        check(k in ("flash_attention", "flash_attention_bwd") or v == 0,
              f"spmd training launched {k}")
    check(worst["n_fwd"] == 2 * n and worst["n_bwd"] == n,
          f"spmd rank {rank}: held {worst['n_fwd']} forward and "
          f"{worst['n_bwd']} backward launches of the first step")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    q, k, v, kw = caught["fwd"]
    log(f"spmd rank {rank}: {SPMD_FULL} on {SPMD_FULL_MESH} ({smi}): "
        f"losses {losses}; K6 at q {tuple(q.shape)} k {tuple(k.shape)} "
        f"{q.dtype}; launches {json.dumps(launches)}; step ms "
        f"{[round(t * 1e3, 3) for t in step_s]} (host clock, through gloo "
        f"and the host: a smoke reading, not a TP throughput), peak "
        f"{peak / 2**30:.3f} GiB")
    del state, params
    torch.cuda.empty_cache()
    out = {"losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "peak_bytes": peak, "launches": launches,
           "k6_q_shape": list(q.shape), "k6_k_shape": list(k.shape),
           "k6_worst_fwd": worst["fwd"], "k6_worst_fwd_of_max":
           worst["fwd_rel"], "k6_worst_bwd": worst["bwd"],
           "k6_held": [worst["n_fwd"], worst["n_bwd"]]}
    out["seqpar"] = _spmd_seqpar_train(rank, smi, model, init, opt, batches)
    if rank == 0:
        step = make_train_step(model, opt())
        params = init()
        state = TrainState(params, opt().init(params))
        one = []
        for b in batches:
            state, m = step(state, b)
            one.append(float(m["loss"]))
        del state, params
        torch.cuda.empty_cache()
        out["one_rank_losses"] = one
        case = flash_case(f"spmd {SPMD_FULL_MESH} attention layer 0", q, k,
                          v, kw, model=SPMD_FULL)
        out["k6_row"] = time_case(case, reps=5, inner=10)
        bq, bk, bv, bo, blse, bdo, bkw = caught["bwd"]
        out["k6_bwd_row"] = _bwd_case(
            bq, bk, bv, bo, blse, bdo, bkw, 0, model=SPMD_FULL,
            stage=f"spmd {SPMD_FULL_MESH} train layer 0")
    del caught
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _spmd_seqpar_train(rank, smi, model, init, opt, batches):
    """Phase 26 (a): ``_spmd_full``'s model, weights and batches on the
    same (1, 2) mesh under ``seqpar`` (the residual stream split into
    two 4096 / 2 sequence blocks): 3 steps, counted, the first under the
    op-trace analysis (its collectives: (e)) and every K6 and
    K6-backward launch of it held against its plain version (they must
    take the baseline mesh's shapes: the layers gather the sequence);
    the step times and peak memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import analyze_call
    from repro_torch.obs import timer
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         train_state_specs)

    cfg = model.cfg
    mesh, rules = _spmd_mesh(SPMD_FULL_MESH, cfg, SPMD_FULL_BATCH, "seqpar")
    caught, losses, step_s = {}, [], []
    with use_mesh_rules(mesh, rules):
        specs = train_state_specs(model)
        params = shard_tree(init(), specs.params)
        torch.cuda.empty_cache()
        state = TrainState(params, opt().init(params))
        step = make_train_step(model, opt())
        worst, unwrap = _spmd_checked_k6(caught)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            for i in range(SPMD_STEPS):
                t0 = timer.now()
                if i == 0:
                    (state, m), rep = analyze_call(step, state, batches[i])
                    coll = _collectives(rep)
                    del rep
                    unwrap()
                else:
                    state, m = step(state, batches[i])
                losses.append(float(m["loss"]))         # synchronises
                step_s.append(timer.now() - t0)
            torch.cuda.synchronize()
            launches = dict(ops.launches)
        finally:
            unwrap()
        peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    check(launches["flash_attention"] == 2 * SPMD_STEPS * n
          and launches["flash_attention_bwd"] == SPMD_STEPS * n
          and all(v == 0 for k, v in launches.items()
                  if k not in ("flash_attention", "flash_attention_bwd")),
          f"seqpar (a) rank {rank} launches {launches}")
    check(worst["n_fwd"] == 2 * n and worst["n_bwd"] == n,
          f"seqpar (a) rank {rank}: held {worst['n_fwd']} forward and "
          f"{worst['n_bwd']} backward launches of the first step")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    q = caught["fwd"][0]
    log(f"seqpar (a) rank {rank}: {cfg.name} on {SPMD_FULL_MESH} under "
        f"seqpar ({smi}): losses {losses}; K6 at q {tuple(q.shape)}; "
        f"launches {json.dumps(launches)}; step ms "
        f"{[round(t * 1e3, 3) for t in step_s]} (the first under the "
        f"op-trace analysis; host clock, through gloo: a smoke reading), "
        f"peak {peak / 2**30:.3f} GiB; collectives {json.dumps(coll)}")
    del state, params, step, caught
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "peak_bytes": peak, "launches": launches, "collectives": coll,
            "k6_q_shape": list(q.shape), "k6_worst_fwd": worst["fwd"],
            "k6_worst_bwd": worst["bwd"]}


#: phase 26 (c): llama4-scout-17b-16e at its published widths (d_model
#: 5120, experts of d_ff 8192, a shared expert, top-1, 202,048 tokens),
#: cut to 1 of its 48 layers and 4 of its 16 experts: 2.76 B parameters,
#: 2 whole experts and half the vocab a rank on (1, 2) under ``ep``. With
#: all 16 experts (4.27 B) each rank held 32.6 GiB at the optimizer
#: update (the state, the clipped gradients and the update's float32
#: temporaries) and two ranks beside this process overflowed the card;
#: with 8 (3.26 B) the mesh ran (29.9 GiB a rank) but one rank's step
#: needed more than 70 GiB (its meta trace: 58.0 GiB); with 4 the meta
#: trace gives 51.4 GiB; 2 x 2048 tokens a step
SEQEP_SCOUT = "llama4-scout-17b-16e"
SEQEP_SCOUT_LAYERS = 1
SEQEP_SCOUT_EXPERTS = 4
SEQEP_SCOUT_SEQ = 2048
SEQEP_SCOUT_BATCH = 2
SEQEP_MESH = (1, 2)


def _seqep_scout_config():
    """Phase 26 (c)'s config: ``SEQEP_SCOUT`` cut in depth and experts."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(SEQEP_SCOUT)
    check(cfg.moe_experts == 16 and cfg.moe_top_k == 1,
          f"{SEQEP_SCOUT}: expected 16 experts, top-1")
    return dataclasses.replace(cfg, n_layers=SEQEP_SCOUT_LAYERS,
                               moe_experts=SEQEP_SCOUT_EXPERTS)


def _spmd_ep_train(rank, smi):
    """Phase 26 (c): ``SEQEP_SCOUT`` on ``SEQEP_MESH`` under ``ep``, 3
    steps counted (the first under the op-trace analysis: (e)); then rank
    0 alone trains the same weights on the same batches."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import analyze_call
    from repro_torch.models.model import Model
    from repro_torch.obs import timer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         train_state_specs)

    cfg = _seqep_scout_config()
    check(cfg.dtype == "bfloat16" and cfg.moe_shared_expert,
          f"{SEQEP_SCOUT}: expected bf16 and a shared expert")
    model = Model(cfg)
    batches = _spmd_batches(cfg.vocab, SEQEP_SCOUT_SEQ, SEQEP_SCOUT_BATCH)

    def opt():
        return make_optimizer(base_lr=3e-4, warmup=2, total=SPMD_STEPS)

    def init():
        return model.init(torch.Generator(device="cuda").manual_seed(
            SEED + 43), device="cuda")

    def train(state, trace):
        step = make_train_step(model, opt())
        losses, step_s, coll = [], [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        for i, b in enumerate(batches):
            t0 = timer.now()
            if i == 0 and trace:
                (state, m), rep = analyze_call(step, state, b)
                coll = _collectives(rep)
                del rep
            else:
                state, m = step(state, b)
            losses.append(float(m["loss"]))             # synchronises
            step_s.append(timer.now() - t0)
        torch.cuda.synchronize()
        return (losses, [t * 1e3 for t in step_s], coll,
                torch.cuda.max_memory_allocated(), dict(ops.launches))

    mesh, rules = _spmd_mesh(SEQEP_MESH, cfg, SEQEP_SCOUT_BATCH, "ep")
    with use_mesh_rules(mesh, rules):
        params = shard_tree(init(), train_state_specs(model).params)
        gc.collect()
        torch.cuda.empty_cache()
        losses, step_ms, coll, peak, launches = train(
            TrainState(params, opt().init(params)), True)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    log(f"ep (c) rank {rank}: {SEQEP_SCOUT} ({cfg.n_layers} of 48 layers, "
        f"{cfg.moe_experts} of 16 experts) "
        f"on {SEQEP_MESH} under ep ({smi}): losses {losses}; launches "
        f"{json.dumps(launches)}; step ms {[round(t, 3) for t in step_ms]} "
        f"(the first under the op-trace analysis; host clock, through "
        f"gloo: a smoke reading), peak {peak / 2**30:.3f} GiB; collectives "
        f"{json.dumps(coll)}")
    out = {"losses": losses, "step_ms": step_ms, "peak_bytes": peak,
           "launches": launches, "collectives": coll}
    _free_card()
    dist.barrier()
    if rank == 0:
        params = init()
        one, one_ms, _, one_peak, _ = train(
            TrainState(params, opt().init(params)), False)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out.update(one_rank_losses=one, one_rank_step_ms=one_ms,
                   one_rank_peak_bytes=one_peak)
        log(f"ep (c): {SEQEP_SCOUT} on one rank: losses {one}, step ms "
            f"{[round(t, 3) for t in one_ms]}, peak "
            f"{one_peak / 2**30:.3f} GiB")
    dist.barrier()
    return out


def _free_card():
    """This process's cached blocks and its cuBLAS workspaces (one a
    stream: ``time_ms`` captures on a side stream of its own each call)
    given back to the card."""
    import torch

    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def _spmd_ckpt(rank, workdir):
    """(c): one step of reduced llama3-8b on (2, 1), saved with the spec
    tree (gathered, rank 0 writes); rank 0 restores it on one rank (no
    mesh): equal bit for bit to the gathered state, and one step from
    each equal bit for bit (under ``torch.use_deterministic_algorithms``,
    with ``CUBLAS_WORKSPACE_CONFIG`` set in the ranks' environment)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import leaves
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.parallel.sharding import (gather_tree, shard_tree,
                                               use_mesh_rules)
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         train_state_specs)

    cfg = dataclasses.replace(get_config(SPMD_SMALL).reduced(),
                              attn_impl="chunked")
    model = Model(cfg)
    batches = _spmd_batches(cfg.vocab, SPMD_SMALL_SEQ, SPMD_SMALL_BATCH)
    opt = make_optimizer(base_lr=1e-3, warmup=1, total=10)
    step = make_train_step(model, opt)
    directory = os.path.join(workdir, "ckpt")
    out = {}
    with full_fp32():
        full = model.init(torch.Generator(device="cuda").manual_seed(
            SEED + 42), device="cuda")
        mesh, rules = _spmd_mesh(SPMD_CKPT_MESH, cfg, SPMD_SMALL_BATCH)
        with use_mesh_rules(mesh, rules):
            specs = train_state_specs(model)
            params = shard_tree(full, specs.params)
            state, _ = step(TrainState(params, opt.init(params)), batches[0])
            save(directory, 1, state, specs=specs)
            whole = gather_tree(state, specs)
        if rank == 0:
            # the embedding's backward accumulates into rows that several
            # tokens share: its atomic adds are ordered only so
            torch.use_deterministic_algorithms(True)
            restored, at, _ = restore(directory, whole)
            same = at == 1 and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(leaves(restored), leaves(whole)))
            check(same, "the checkpoint written on (2, 1) and restored on "
                        "one rank differs from the gathered state")
            a, ma = step(restored, batches[1])
            b, mb = step(_clone_tree(whole), batches[1])
            stepped = float(ma["loss"]) == float(mb["loss"]) and all(
                torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
            torch.use_deterministic_algorithms(False)
            check(stepped, "a step after the restore differs from the "
                           "one-rank step on the gathered state")
            out = {"restored_bit_for_bit": same,
                   "step_after_restore_bit_for_bit": stepped,
                   "loss": float(ma["loss"]),
                   "leaves": len(leaves(whole))}
    dist.barrier()
    return out


def _spmd_worker(argv):
    """One rank of phase 24 (``chip_smoke.py --spmd-worker RANK WORLD
    INIT DIR``): a gloo group over the card's tensors; its results go to
    ``DIR/rank<RANK>.json``."""
    rank, world, init, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    # phase 26 (c), the largest, first, on a card this rank has not used
    out = {"rank": rank, "ep": _spmd_ep_train(rank, smi),
           "small": _spmd_small(rank), "full": _spmd_full(rank, smi),
           "ckpt": _spmd_ckpt(rank, workdir)}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _spmd_ranks(workdir, flag="--spmd-worker", log_name="spmd_rank",
                timeout=SPMD_TIMEOUT_S, extra_env=None):
    """Start the ranks (this file with ``flag``, ``extra_env`` added to
    their environment), wait for both (a rank that fails ends the
    other), return their results; their logs go to
    ``chiprun_out/<log_name><rank>.log``."""
    import shutil

    from repro_torch.obs import timer

    init = f"file://{os.path.join(workdir, 'store')}"
    env = dict(os.environ, PYTHONPATH=SRC,
               CUBLAS_WORKSPACE_CONFIG=CUBLAS_DETERMINISTIC,
               **(extra_env or {}))
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(SPMD_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         str(SPMD_RANKS), init, workdir], env=env,
        stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
        for r in range(SPMD_RANKS)]
    deadline = timer.now() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or timer.now() > deadline:
                break
            timer.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    for r, path in enumerate(logs):
        shutil.copy(path, os.path.join(ROOT, "chiprun_out",
                                       f"{log_name}{r}.log"))
        with open(path) as f:
            for line in f.read().splitlines():
                log(f"[rank {r}] {line}")
    codes = [p.returncode for p in procs]
    check(codes == [0] * SPMD_RANKS, f"spmd ranks exited {codes} (logs in "
                                     f"chiprun_out/{log_name}*.log)")
    res = []
    for r in range(SPMD_RANKS):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def phase_spmd(smi):
    """Phase 24 (module docstring). Returns (K6 and K6-backward launches
    of the counted run, their worst |kernel - plain|, the two timing rows,
    details)."""
    import shutil

    from repro_torch.obs import timer

    import torch

    t0 = timer.now()
    # the ranks need the card's memory (phase 26 (c) trains 51 GB on one
    # of them): this process's cached blocks are freed first, and the
    # ranks' segments can grow (two allocators on one card fragment it)
    gc.collect()
    reserved = torch.cuda.memory_reserved()
    _free_card()
    held = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "reserved_before_gib": reserved / 2**30}
    log(f"spmd: this process holds {json.dumps(held)} of the card as the "
        f"ranks start")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="spmd-", dir=os.path.join(ROOT,
                                                                 "build"))
    try:
        res = _spmd_ranks(workdir, extra_env=SPMD2_RANK_ENV)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for mesh in res[0]["small"]:
        check(all(r["small"][mesh]["losses"] == res[0]["small"][mesh][
            "losses"] for r in res), f"spmd {mesh}: the ranks' losses differ")
    full = [r["full"] for r in res]
    check(all(f["losses"] == full[0]["losses"] for f in full),
          f"spmd full: the ranks' losses differ: "
          f"{[f['losses'] for f in full]}")
    one = full[0]["one_rank_losses"]
    losses = full[0]["losses"]
    check(all(abs(a - b) <= SPMD_FULL_RTOL * abs(b)
              for a, b in zip(losses, one)),
          f"spmd {SPMD_FULL}: losses {losses} against one rank's {one}")
    # phase 26 (a): the seqpar run of the same steps, against the same
    # one rank; its K6 launches take the baseline mesh's shapes
    seq = [f["seqpar"] for f in full]
    check(all(x["losses"] == seq[0]["losses"] for x in seq),
          f"seqpar (a): the ranks' losses differ: "
          f"{[x['losses'] for x in seq]}")
    check(all(abs(a - b) <= SPMD_FULL_RTOL * abs(b)
              for a, b in zip(seq[0]["losses"], one)),
          f"seqpar (a) {SPMD_FULL}: losses {seq[0]['losses']} against one "
          f"rank's {one}")
    check(all(x["k6_q_shape"] == f["k6_q_shape"]
              for x, f in zip(seq, full)),
          f"seqpar (a): K6 at {[x['k6_q_shape'] for x in seq]}, the "
          f"baseline mesh's at {[f['k6_q_shape'] for f in full]}")
    # phase 26 (c): ep, against rank 0 alone
    ep = [r["ep"] for r in res]
    check(all(x["losses"] == ep[0]["losses"] for x in ep),
          f"ep (c): the ranks' losses differ: {[x['losses'] for x in ep]}")
    ep_one = ep[0]["one_rank_losses"]
    check(all(abs(a - b) <= SPMD_FULL_RTOL * abs(b)
              for a, b in zip(ep[0]["losses"], ep_one)),
          f"ep (c) {SEQEP_SCOUT}: losses {ep[0]['losses']} against one "
          f"rank's {ep_one}")
    launches = {k: sum(f["launches"][k] + f["seqpar"]["launches"][k]
                       + e["launches"][k] for f, e in zip(full, ep))
                for k in ("flash_attention", "flash_attention_bwd")}
    k6_row, bwd_row = full[0]["k6_row"], full[0]["k6_bwd_row"]
    k6_row["launches"] = sum(f["launches"]["flash_attention"]
                             + f["seqpar"]["launches"]["flash_attention"]
                             for f in full)
    bwd_row["launches"] = sum(f["launches"]["flash_attention_bwd"]
                              + f["seqpar"]["launches"]["flash_attention_bwd"]
                              for f in full)
    check(sum(e["launches"]["flash_attention"]
              + e["launches"]["flash_attention_bwd"] for e in ep) == 0,
          f"ep (c) launched K6 at S {SEQEP_SCOUT_SEQ} (the naive attention "
          f"expected): {[e['launches'] for e in ep]}")
    worst = {"flash_attention": max(max(f["k6_worst_fwd"],
                                        f["seqpar"]["k6_worst_fwd"])
                                    for f in full),
             "flash_attention_bwd": max(max(f["k6_worst_bwd"],
                                            f["seqpar"]["k6_worst_bwd"])
                                        for f in full)}
    details = {"card": smi, "small": res[0]["small"], "full": full,
               "ep": ep, "ckpt": res[0]["ckpt"], "launches": launches,
               "wall_s": timer.now() - t0}
    log(f"spmd phase ({smi}): (a) {SPMD_SMALL} reduced float32 K6, losses "
        f"{json.dumps({k: v['losses'] for k, v in res[0]['small'].items()})}"
        f" against one rank {res[0]['small']['1x2']['one_rank_losses']}; "
        f"(b) {SPMD_FULL} full width on {SPMD_FULL_MESH}: losses {losses} "
        f"against one rank {one}, K6 {launches['flash_attention']} and its "
        f"backward {launches['flash_attention_bwd']} launches over both "
        f"ranks, step ms {[f['step_ms'] for f in full]} (host clock, "
        f"through gloo and the host: a smoke reading, not a TP "
        f"throughput), peak GiB "
        f"{[round(f['peak_bytes'] / 2**30, 3) for f in full]}; (c) "
        f"{json.dumps(res[0]['ckpt'])}; {details['wall_s']:.3f} s")
    return launches, worst, [k6_row, bwd_row], details



# ---------------------------------------------------------------------------
# phase 25: mamba, the hybrid blocks, prefill and decode under a mesh of
# two ranks that share the card
# ---------------------------------------------------------------------------

SPMD2_SSM = ("falcon-mamba-7b", JAMBA_CONFIG)
#: (a) jamba's capacity factor: 4, its experts, so that no token is
#: dropped whether the tokens are dispatched at once or a data rank's at
#: a time, and one rank's step is the same function
SPMD2_SMALL_OVER = {JAMBA_CONFIG: {"capacity_factor": 4.0}}
#: (b) falcon-mamba-7b at its published widths (d_model 4096, d_inner
#: 8192), cut to 16 of its 64 layers (about 2.0 B parameters, so that
#: two ranks, and then one, train on the card), bf16, remat "full", one
#: 4096-token sequence a step on (1, 2): 4096 mixer channels a rank. At
#: 8 layers its third bf16 step leaves one rank's by 6.6%: bf16 noise
#: (the loss falls from 11.6 to 3.5 in one step and the noise grows from
#: there), for in float32 (TF32 off) the same cut stays within 9.3e-6 of
#: one rank at every step (``--mamba-gap``, ``MAMBA_GAP_LAYERS``)
SPMD2_MAMBA = "falcon-mamba-7b"
SPMD2_MAMBA_LAYERS = 16
SPMD2_MAMBA_BATCH = 1
SPMD2_MESH = (1, 2)
#: (c) llama3-8b whole, bf16 and int8: a prefill of 1 x 4096, then
#: decode steps at batch 4 against a cache of 256 positions split over
#: the two ranks (128 a rank), slots at 17, 64, 100 and 200 (rank 1's
#: block holds the last)
SPMD2_DECODE_STEPS = 4
SPMD2_DECODE_LEN = 256
SPMD2_DECODE_CUR = (17, 64, 100, 200)
#: (d) jamba-v0.1-52b at its published widths, cut to 8 of its 32
#: layers: one 8-sublayer group, 7 mamba mixers and an attention one, 4
#: MoE FFNs of 16 experts
SPMD2_JAMBA_LAYERS = 8
SPMD2_JAMBA_DECODE_STEPS = 4
#: bf16 logits of the mesh against one rank's (max |diff| over max |one|,
#: mean |diff| over mean |one|), held to bf16's own noise on the same
#: weights: one rank's bf16 logits against its float32 run of the
#: weights upcast (TF32 off). The mesh rounds each row-parallel partial
#: output to bf16 before the all-reduce sums it, where one rank rounds the
#: whole sum once, so its distance from one rank is of the order of that
#: noise (over 32 layers it reaches 4.5% of the mean |logit| of a
#: llama3-8b decode step); a block in the wrong place moves the logits by
#: their own size. The mesh must stay within these multiples of the noise
#: (max, mean), and its top-1 must agree wherever one rank's top-2 margin
#: exceeds twice the largest |diff| (``_top1_check``)
SPMD2_NOISE_FACTOR = {"max": 3.0, "mean": 2.0}
#: (c)'s int8 tree: K5's first launches of the prefill, layer 0's wq, wk,
#: wv, wo, wi_gate, wi_up and the MLP's wo. Their inputs are the same on
#: the mesh and on one rank, up to the block, so rank 0's codes, weights
#: and (column-parallel) scales and outputs must be the leading blocks of
#: one rank's bit for bit: a scale not maxed over its group or a block
#: out of place changes them. The row-parallel ones (attention's and the
#: MLP's wo) run K5's accumulator mode: the two ranks' int32 blocks,
#: summed, must equal one rank's accumulator of the whole contraction
#: bit for bit; the one rescale follows the sum, so the mesh's outputs
#: are one rank's and the float32-activation logits are held to
#: ``SUBLAYER_TOL`` with top-1 equal everywhere
SPMD2_K5_EXACT = (0, 1, 2, 3, 4, 5, 6)
#: the row-parallel launches among them
SPMD2_K5_ROW_PARALLEL = (3, 6)
SPMD2_TIMEOUT_S = 900
#: (b)'s scan saves thousands of 32-64 MiB chunks for its backward: two
#: ranks' caching allocators fragment the card unless their segments
#: can grow
SPMD2_RANK_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def _spmd2_small(rank):
    """(a): reduced falcon-mamba-7b and jamba in float32 (TF32 off) on
    (1, 2) and (2, 1), 3 steps each, against one rank on the same
    weights and batches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         train_state_specs)

    def opt():
        return make_optimizer(base_lr=1e-3, warmup=1, total=10)

    def run(model, params, batches):
        step = make_train_step(model, opt())
        state = TrainState(params, opt().init(params))
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses

    out = {}
    with full_fp32():
        for i, name in enumerate(SPMD2_SSM):
            cfg = dataclasses.replace(get_config(name).reduced(),
                                      **SPMD2_SMALL_OVER.get(name, {}))
            model = Model(cfg)
            batches = _spmd_batches(cfg.vocab, SPMD_SMALL_SEQ,
                                    SPMD_SMALL_BATCH)
            full = model.init(torch.Generator(device="cuda").manual_seed(
                SEED + 50 + i), device="cuda")
            one = run(model, _clone_tree(full), batches)
            res = {"one_rank_losses": one}
            for shape in SPMD_SMALL_MESHES:
                mesh, rules = _spmd_mesh(shape, cfg, SPMD_SMALL_BATCH)
                with use_mesh_rules(mesh, rules):
                    params = shard_tree(full, train_state_specs(model).params)
                    losses = run(model, params, batches)
                check(all(abs(a - b) <= SPMD_LOSS_RTOL * abs(b)
                          for a, b in zip(losses, one)),
                      f"spmd inference (a) {name} {shape} rank {rank}: "
                      f"losses {losses}, one rank {one}")
                res[f"{shape[0]}x{shape[1]}"] = losses
            out[name] = res
    return out


def _collectives(report):
    """A trace report's collectives: {"bytes", "by_type", "by_count"}."""
    s = report.stats
    return {"bytes": float(s.collective_bytes),
            "by_type": {k: float(v) for k, v in s.by_type.items()},
            "by_count": {k: int(v) for k, v in s.by_count.items()}}


def _spmd2_mamba(rank, smi, n_layers=SPMD2_MAMBA_LAYERS, float32=False):
    """(b): falcon-mamba-7b at full width, ``n_layers`` layers, on (1, 2):
    3 steps, the first under the op-trace analysis (its collectives:
    (e)), the other two timed; then rank 0 alone trains the same weights
    on the same batches. ``float32``: the weights and the steps in
    float32 with TF32 off (``--mamba-gap``)."""
    import contextlib
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.launch.hlo_analysis import analyze_call
    from repro_torch.models.model import Model
    from repro_torch.obs import timer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         train_state_specs)

    cfg = dataclasses.replace(get_config(SPMD2_MAMBA), n_layers=n_layers)
    check(cfg.dtype == "bfloat16" and cfg.remat == "full"
          and cfg.d_inner == 8192, f"{SPMD2_MAMBA}: expected bf16, remat "
                                   f"full and d_inner 8192")
    if float32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    precision = full_fp32 if float32 else contextlib.nullcontext
    model = Model(cfg)
    batches = _spmd_batches(cfg.vocab, TRAIN_SEQ, SPMD2_MAMBA_BATCH)

    def opt():
        return make_optimizer(base_lr=3e-4, warmup=2, total=SPMD_STEPS)

    def init():
        return model.init(torch.Generator(device="cuda").manual_seed(
            SEED + 52), device="cuda")

    mesh, rules = _spmd_mesh(SPMD2_MESH, cfg, SPMD2_MAMBA_BATCH)
    losses, step_s = [], []
    with use_mesh_rules(mesh, rules), precision():
        specs = train_state_specs(model)
        params = shard_tree(init(), specs.params)
        torch.cuda.empty_cache()
        state = TrainState(params, opt().init(params))
        step = make_train_step(model, opt())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(SPMD_STEPS):
            t0 = timer.now()
            if i == 0:
                (state, m), rep = analyze_call(step, state, batches[i])
                coll = _collectives(rep)
                del rep
            else:
                state, m = step(state, batches[i])
            losses.append(float(m["loss"]))             # synchronises
            step_s.append(timer.now() - t0)
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    log(f"spmd inference (b) rank {rank}: {SPMD2_MAMBA} ({cfg.n_layers} of "
        f"64 layers, d_inner {cfg.d_inner}) on {SPMD2_MESH} ({smi}): losses "
        f"{losses}; step ms {[round(t * 1e3, 3) for t in step_s]} (the "
        f"first under the op-trace analysis; host clock, through gloo and "
        f"the host: a smoke reading), peak {peak / 2**30:.3f} GiB "
        f"allocated, {peak_reserved / 2**30:.3f} GiB reserved; "
        f"collectives a step {json.dumps(coll)}")
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    out = {"losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "peak_bytes": peak, "peak_reserved_bytes": peak_reserved,
           "collectives": coll,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype}
    dist.barrier()
    if rank == 0:
        params = init()
        state = TrainState(params, opt().init(params))
        step = make_train_step(model, opt())
        one, one_s = [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            t0 = timer.now()
            with precision():
                state, m = step(state, b)
            one.append(float(m["loss"]))
            one_s.append(timer.now() - t0)
        out["one_rank_losses"] = one
        out["one_rank_step_ms"] = [t * 1e3 for t in one_s]
        out["one_rank_peak_bytes"] = torch.cuda.max_memory_allocated()
        del state, params, step
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _float32_tree(tree):
    """``tree``'s float leaves made float32 in place, one leaf at a time
    (each bf16 leaf freed as its copy is made, so the bf16 and float32
    trees are never whole on the card together)."""
    for key in list(tree):
        if isinstance(tree[key], dict):
            _float32_tree(tree[key])
        elif tree[key].is_floating_point():
            tree[key] = tree[key].float()
    return tree


def _k5_keep(store, indices):
    """Wrap K5's wrapper so that the launches whose index (in call order
    from now) is in ``indices`` keep clones of their inputs and output in
    ``store[index]``; returns the function that unwraps it."""
    from repro_torch.kernels import ops

    real, n = ops.qmatmul, [0]

    def keep(x_int, w_int, scale, *a, **kw):
        out = real(x_int, w_int, scale, *a, **kw)
        if n[0] in indices:
            store[n[0]] = tuple(None if t is None else t.clone()
                                for t in (x_int, w_int, scale, out))
        n[0] += 1
        return out

    def restore():
        ops.qmatmul = real

    ops.qmatmul = keep
    return restore


def _k5_blocks_check(label, mesh, one, acc_sums):
    """Rank 0's kept K5 launches ``SPMD2_K5_EXACT`` of the mesh against
    one rank's: the codes, ``w_int`` and, where the rank holds a block of
    the outputs (column-parallel), the scale vector and the output, each
    the leading block of one rank's, bit for bit; a row-parallel
    launch's codes are the rank's block of the contraction axis, it runs
    K5's accumulator mode (no scale), and ``acc_sums[i]``, its int32
    blocks summed over the ranks, equals one rank's accumulator of the
    whole contraction (the plain int32 product of its codes) bit for
    bit. Returns each launch's split."""
    import torch
    from repro_torch.kernels import ref

    splits = []
    for i in SPMD2_K5_EXACT:
        m, o = mesh[i], one[i]
        split = "k" if m[0].shape[1] < o[0].shape[1] else "n"
        splits.append(split)
        for name, a, b in zip(("codes", "w_int", "scale", "out"), m, o):
            if split == "k" and name in ("scale", "out"):
                continue
            block = b[tuple(slice(0, n) for n in a.shape)]
            check(a.dtype == b.dtype and torch.equal(a, block),
                  f"{label}: K5 launch {i} ({split}-split): the mesh's "
                  f"{name} {tuple(a.shape)} is not the leading block of "
                  f"one rank's {tuple(b.shape)}")
        if split == "k":
            check(m[2] is None and m[3].dtype == torch.int32,
                  f"{label}: K5 launch {i} is row-parallel and did not run "
                  f"the accumulator mode")
            want = ref.qmatmul_ref(o[0], o[1], None)
            check(torch.equal(acc_sums[i], want),
                  f"{label}: K5 launch {i}: the ranks' int32 blocks sum to "
                  f"{int((acc_sums[i] != want).sum())} values off one "
                  f"rank's accumulator")
    check(splits == ["n", "n", "n", "k", "n", "n", "k"],
          f"{label}: layer 0's wq, wk, wv, wo, wi_gate, wi_up, wo split as "
          f"{splits}")
    return splits


def _noise_check(label, mesh_err, noise):
    """The mesh's distance from one rank within ``SPMD2_NOISE_FACTOR`` of
    bf16's own noise (one rank's bf16 against its float32), both as
    (max ratio, mean ratio); a float32 model, which has no such noise,
    within phase 20's ``SUBLAYER_TOL``."""
    check(mesh_err[0] <= max(SPMD2_NOISE_FACTOR["max"] * noise[0],
                             SUBLAYER_TOL)
          and mesh_err[1] <= max(SPMD2_NOISE_FACTOR["mean"] * noise[1],
                                 SUBLAYER_TOL),
          f"{label}: the mesh's logits off one rank's by {mesh_err[0]:.3g} "
          f"of max |logit| and {mesh_err[1]:.3g} of mean |logit|, against "
          f"bf16's noise (one rank against float32) of {noise[0]:.3g} and "
          f"{noise[1]:.3g}")


def _one_rank_runs(model, params, tokens, dec_tokens):
    """Rank 0 alone: (prefill logits, every decode step's logits) on the
    whole tree, from a zeroed cache at the slots of (c)."""
    import torch

    pre = model.prefill(params, {"tokens": tokens})
    cache = model.cache_init(len(SPMD2_DECODE_CUR), SPMD2_DECODE_LEN,
                             device="cuda")
    cur0 = torch.tensor(SPMD2_DECODE_CUR, dtype=torch.int32, device="cuda")
    steps = []
    for t, tok in enumerate(dec_tokens):
        logits, cache = model.decode_step(params, cache, tok, cur0 + t)
        steps.append(logits)
    return pre, steps


def _against_one_rank(label, model, full, mesh_pre, mesh_steps, tokens,
                      dec_tokens, int8=None, extra=None):
    """The mesh's logits against rank 0 alone on the whole tree ``full``
    (bf16, or the int8 tree with bf16 activations), beside the same
    tree's own noise (its float leaves made float32 in place afterwards,
    run with float32 activations, TF32 off) and ``_top1_check``; the
    top-1 agreement over all positions is reported beside the noise
    run's. The bf16 tree is held within ``SPMD2_NOISE_FACTOR`` of its
    noise, and so are the prefills of ``extra`` ({name: the gathered
    logits of another mesh run of the same prefill}: phase 26's seqpar
    one). The int8 tree (``int8``: the mesh's kept K5 launches, the
    row-parallel launches' int32 blocks summed over the ranks, and its
    float32-activation logits) is held by ``_k5_blocks_check`` and its
    float32-activation prefill to ``SUBLAYER_TOL`` with top-1 equal at
    every position; its decode steps, and its logits in bf16
    activations, are a reading (``SPMD2_K5_EXACT``)."""
    import dataclasses

    import torch
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model

    start = torch.cuda.memory_allocated()
    kept = {}
    unkeep = _k5_keep(kept, SPMD2_K5_EXACT) if int8 else (lambda: None)
    try:
        one_pre, one_steps = _one_rank_runs(model, full, tokens, dec_tokens)
    finally:
        unkeep()
    out = {"prefill": _logits_error(mesh_pre, one_pre),
           "prefill_top1": _top1_check(f"{label} prefill", mesh_pre,
                                       one_pre),
           "decode": [_logits_error(a, b) for a, b in zip(mesh_steps,
                                                           one_steps)],
           "decode_top1": [_top1_check(f"{label} decode step {t}", a, b)
                           for t, (a, b) in enumerate(zip(mesh_steps,
                                                          one_steps))]}
    if int8:
        out["k5_layer0_splits"] = _k5_blocks_check(
            label, int8["kept"], kept, int8["acc_sums"])
    for name, pre in (extra or {}).items():
        out[name] = {"prefill": _logits_error(pre, one_pre),
                     "prefill_top1": _top1_check(f"{label} {name} prefill",
                                                 pre, one_pre)}
    del kept
    model32 = Model(dataclasses.replace(model.cfg, dtype="float32"))
    held = torch.cuda.memory_allocated()
    _float32_tree(full)
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_gib"] = {"start": start / 2**30, "bf16": held / 2**30,
                            "float32": torch.cuda.memory_allocated() / 2**30}
    log(f"{label}: one rank's bf16 run, then the tree made float32: "
        f"{json.dumps(out['allocated_gib'])} GiB allocated")
    with full_fp32():
        f_pre, f_steps = _one_rank_runs(model32, full, tokens, dec_tokens)
    out["noise_prefill"] = _logits_error(one_pre, f_pre)
    out["noise_decode"] = [_logits_error(a, b) for a, b in zip(one_steps,
                                                                f_steps)]
    out["top1_agreement"] = {
        "mesh": _agreement([mesh_pre] + mesh_steps, [one_pre] + one_steps),
        "noise": _agreement([f_pre] + f_steps, [one_pre] + one_steps)}
    del one_pre
    if int8:
        m_pre, m_steps = int8["float32"]
        # the bar: the row-parallel outputs are one rank's bit for bit, so
        # the float32-activation prefill is one rank's to float32 rounding
        err = _float32_check(f"{label} float32 prefill", m_pre, f_pre)
        top1 = bool((m_pre.argmax(-1) == f_pre.argmax(-1)).all())
        check(top1, f"{label} float32 prefill: top-1 differs from one "
                    f"rank's at some position")
        out["float32"] = {
            "prefill_max_of_max": err, "prefill_top1_everywhere": top1,
            "prefill": _logits_error(m_pre, f_pre),
            "decode": [_logits_error(a, b) for a, b in zip(m_steps,
                                                            f_steps)],
            "top1_agreement": _agreement([m_pre] + m_steps,
                                         [f_pre] + f_steps)}
        return out
    del f_pre
    _noise_check(f"{label} prefill", out["prefill"], out["noise_prefill"])
    for t, (e, n) in enumerate(zip(out["decode"], out["noise_decode"])):
        _noise_check(f"{label} decode step {t}", e, n)
    for name in extra or {}:
        _noise_check(f"{label} {name} prefill", out[name]["prefill"],
                     out["noise_prefill"])
    return out


def _agreement(got, want):
    """The share of positions whose top-1 agrees, over lists of logits."""
    same = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
               for a, b in zip(got, want))
    return same / sum(b.shape[:-1].numel() for b in want)


def _float32_check(label, got, want):
    """float32 logits of the mesh within ``SUBLAYER_TOL`` of one rank's
    largest |logit|, and ``_top1_check``; returns the ratio."""
    err = float((got - want).abs().max()) / float(want.abs().max())
    check(err <= SUBLAYER_TOL, f"{label}: the mesh's float32 logits off one "
                               f"rank's by {err:.3g} of max |logit|")
    _top1_check(label, got, want)
    return err


def _logits_error(got, want):
    """bf16 logits of the mesh against one rank's: (max |diff| over max
    |want|, mean |diff| over mean |want|)."""
    d = (got - want).abs()
    w = want.abs()
    return float(d.max() / w.max()), float(d.mean() / w.mean())


def _top1_check(label, got, want):
    """Top-1 of the mesh's logits against one rank's at every position
    whose top-2 margin exceeds twice the largest |diff|; returns (equal
    positions, positions checked, positions within the margin)."""
    import torch

    top2 = torch.topk(want.float(), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    err = float((got - want).abs().max())
    sure = margin > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    n_sure, n_same = int(sure.sum()), int((same & sure).sum())
    check(n_same == n_sure, f"{label}: top-1 differs from one rank's at "
                            f"{n_sure - n_same} of {n_sure} positions "
                            f"whose margin exceeds twice the largest "
                            f"|diff| {err:.4g}")
    return {"equal": n_same, "checked": n_sure,
            "within_margin": int((~sure).sum()),
            "equal_everywhere": bool(same.all())}


def _mesh_inference(model, params, tokens, dec_tokens, checks_k5=None):
    """One prefill and the decode steps under the active mesh on the
    rank's blocks ``params``, counted (the prefill and the first decode
    step under the op-trace analysis): (the gathered prefill logits, the
    gathered decode logits, the counters, the two traced calls'
    collectives, the decode steps' ms, K5's worst |kernel - plain|, K5's
    kept inputs, K5's shapes in launch order). K5's launches are held
    against its plain version where ``checks_k5`` names them."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import analyze_call
    from repro_torch.models.model import gather_logits

    def prefill():
        out, rep = analyze_call(model.prefill, params, {"tokens": tokens})
        return gather_logits(out), rep

    def decode():
        cache = model.cache_init(len(SPMD2_DECODE_CUR), SPMD2_DECODE_LEN,
                                 device="cuda")
        cur0 = torch.tensor(SPMD2_DECODE_CUR, dtype=torch.int32,
                            device="cuda")
        steps, ms = [], []
        for t, tok in enumerate(dec_tokens):
            torch.cuda.synchronize()
            t0 = _now()
            if t == 0:
                (logits, cache), rep = analyze_call(
                    model.decode_step, params, cache, tok, cur0 + t)
            else:
                logits, cache = model.decode_step(params, cache, tok,
                                                  cur0 + t)
            torch.cuda.synchronize()
            ms.append((_now() - t0) * 1e3)
            steps.append(gather_logits(logits))
        return steps, ms, rep

    def both():
        pre, rep = prefill()
        steps, ms, drep = decode()
        return pre, rep, steps, ms, drep

    launches, shapes, worst, kept, (pre, rep, steps, ms, drep) = \
        _counted_int8(both, checks_k5 or set())
    coll = {"prefill": _collectives(rep), "decode": _collectives(drep)}
    return pre, steps, launches, coll, ms, worst, kept, shapes


def _spmd2_llama(rank, smi):
    """(c): llama3-8b whole on (1, 2): bf16 and int8 prefills and decode
    steps of the rank's blocks, counted (every K6 launch of the bf16
    prefill held against its plain version; K5's first and last layers'
    launches of the int8 prefill and every one of the first decode step
    too), then the int8 tree's again with float32 activations (TF32 off;
    every K6 launch held against its plain version); rank 0 holds its
    int8 blocks against the blocks of the whole int8 tree, then alone runs
    the same on the whole trees and holds the mesh against them
    (``_against_one_rank``); rank 0 times K6 and K5 at the rank-local
    shapes."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import leaves_with_paths
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import (quantized_specs, shard_tree,
                                               use_mesh_rules)

    cfg = get_config(LM_CONFIG)
    model = Model(cfg)
    model32 = Model(dataclasses.replace(cfg, dtype="float32"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 53)
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=g,
                           device="cuda")
    dec_tokens = [torch.randint(0, cfg.vocab, (len(SPMD2_DECODE_CUR), 1),
                                generator=g, device="cuda")
                  for _ in range(SPMD2_DECODE_STEPS)]
    mesh, rules = _spmd_mesh(SPMD2_MESH, cfg, 1)
    check(rank != 0 or mesh.get_local_rank("model") == 0,
          "rank 0 does not hold the leading blocks")
    out = {}
    caught, caught32, kept = {}, {}, {}
    per_pass = 7 * cfg.n_layers + 1
    checks = set(range(7)) | set(range(per_pass - 8, per_pass)) | set(
        range(per_pass, 2 * per_pass))
    with torch.inference_mode():
        full = model.init(g, device="cuda")
        with use_mesh_rules(mesh, rules):
            pspecs = model.param_specs()
            params = shard_tree(full, pspecs)
            if rank != 0:
                del full
            torch.cuda.empty_cache()
            worst_k6, unwrap = _spmd_checked_k6(caught)
            try:
                bf16 = _mesh_inference(model, params, tokens, dec_tokens)
            finally:
                unwrap()
            # phase 26 (b): the same blocks' prefill under seqpar
            seqpar = _seqpar_prefill(model, params, tokens, mesh, rules)
            check(seqpar["k6_q_shape"] == list(caught["fwd"][0].shape),
                  f"seqpar (b): K6 at {seqpar['k6_q_shape']}, the baseline "
                  f"mesh's at {list(caught['fwd'][0].shape)}")
            qparams = model.quantize_params(params)
            del params
            torch.cuda.empty_cache()
            unkeep = _k5_keep(kept, SPMD2_K5_EXACT)
            try:
                int8 = _mesh_inference(model, qparams, tokens, dec_tokens,
                                       checks)
            finally:
                unkeep()
            # the row-parallel launches' int32 blocks, summed over the ranks
            acc_sums = {}
            for i in SPMD2_K5_ROW_PARALLEL:
                parts = [torch.empty_like(kept[i][3])
                         for _ in range(SPMD_RANKS)]
                dist.all_gather(parts, kept[i][3].contiguous())
                acc_sums[i] = sum(parts[1:], parts[0])
                del parts
        if rank == 0:
            # outside the mesh: the whole tree, quantized on one rank
            qfull = model.quantize_params(full)
            with use_mesh_rules(mesh, rules):
                want = shard_tree(qfull, quantized_specs(qfull, pspecs))
            diff = [path for (path, a), (_, b) in zip(
                leaves_with_paths(qparams), leaves_with_paths(want))
                if a.dtype != b.dtype or not torch.equal(a, b)]
            check(not diff, f"int8 blocks on the mesh differ from the "
                            f"whole int8 tree's at {diff[:5]}")
            out["int8_blocks_equal"] = True
            del want
        with use_mesh_rules(mesh, rules), full_fp32():
            worst32, unwrap = _spmd_checked_k6(caught32)
            try:
                int8_f32 = _mesh_inference(model32, _float32_tree(qparams),
                                           tokens, dec_tokens, checks)
            finally:
                unwrap()
            del qparams
        torch.cuda.empty_cache()
        runs = {"bf16": bf16, "int8": int8, "int8_float32": int8_f32}
        for label, res in runs.items():
            pre, steps, launches, coll, ms, _, _, _ = res
            out[label] = {"launches": launches, "collectives": coll,
                          "decode_ms": ms}
            log(f"spmd inference (c) rank {rank}: {LM_CONFIG} {label} on "
                f"{SPMD2_MESH} ({smi}): launches {json.dumps(launches)}; "
                f"collectives {json.dumps(coll)}; decode step ms "
                f"{[round(x, 3) for x in ms]} (host clock, through gloo: "
                f"a smoke reading)")
        n = cfg.n_layers
        check(bf16[2]["flash_attention"] == n and bf16[2]["qmatmul"] == 0,
              f"bf16 mesh prefill and decode launched {bf16[2]}")
        for label in ("int8", "int8_float32"):
            check(runs[label][2]["flash_attention"] == n
                  and runs[label][2]["qmatmul"]
                  == per_pass * (1 + SPMD2_DECODE_STEPS),
                  f"{label} mesh prefill and decode launched "
                  f"{runs[label][2]}")
        check(worst_k6["n_fwd"] == n and worst32["n_fwd"] == n,
              f"held {worst_k6['n_fwd']} bf16 and {worst32['n_fwd']} "
              f"float32 K6 launches")
        out["k6_worst"] = max(worst_k6["fwd"], worst32["fwd"],
                              seqpar["k6_worst"])
        out["k6_worst_of_max"] = max(worst_k6["fwd_rel"], worst32["fwd_rel"])
        out["k5_worst"] = max(int8[5], int8_f32[5])
        out["seqpar"] = {k: seqpar[k] for k in ("launches", "collectives",
                                                "prefill_ms", "k6_q_shape")}
        dist.barrier()
        if rank == 0:
            cmp = {"int8": _against_one_rank(
                f"spmd {LM_CONFIG} int8", model, qfull, int8[0], int8[1],
                tokens, dec_tokens,
                int8={"kept": kept, "acc_sums": acc_sums,
                      "float32": (int8_f32[0], int8_f32[1])})}
            del qfull, kept, acc_sums
            gc.collect()
            torch.cuda.empty_cache()
            cmp["bf16"] = _against_one_rank(
                f"spmd {LM_CONFIG} bf16", model, full, bf16[0], bf16[1],
                tokens, dec_tokens, extra={"seqpar": seqpar["logits"]})
            del full
            torch.cuda.empty_cache()
            out["against_one_rank"] = cmp
            log(f"spmd inference (c): {LM_CONFIG} on {SPMD2_MESH} against "
                f"one rank: {json.dumps(cmp)}")
            q, k, v, kw = caught["fwd"]
            out["k6_row"] = time_case(flash_case(
                f"spmd inference {SPMD2_MESH} prefill layer 0", q, k, v, kw),
                reps=5, inner=10)
            q, k, v, kw = caught32["fwd"]
            out["k6_f32_row"] = time_case(flash_case(
                f"spmd inference {SPMD2_MESH} int8 float32 prefill layer 0",
                q, k, v, kw), reps=3, inner=3)
            out["k5_rows"] = _spmd2_k5_rows(int8[6], int8[7] + int8_f32[7])
        del bf16, int8, int8_f32, runs, caught, caught32, seqpar
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _seqpar_prefill(model, params, tokens, mesh, rules):
    """Phase 26 (b): the prefill of the rank's blocks ``params`` on
    ``mesh`` under ``rules`` with ``seqpar`` on top (the blocks are the
    baseline's: "seq" splits no parameter), counted and under the
    op-trace analysis (its collectives: (e)), every K6 launch held against
    its plain version: {"logits" (gathered), "launches", "collectives",
    "prefill_ms", "k6_q_shape", "k6_worst"}."""
    import torch
    from repro_torch.launch.dryrun import combined_strategy_rules
    from repro_torch.launch.hlo_analysis import analyze_call
    from repro_torch.models.model import gather_logits
    from repro_torch.parallel.sharding import use_mesh_rules

    rules = dict(rules, **combined_strategy_rules("seqpar", model.cfg, mesh,
                                                  None))
    caught = {}
    worst, unwrap = _spmd_checked_k6(caught)

    def prefill():
        torch.cuda.synchronize()
        t0 = _now()
        logits, rep = analyze_call(model.prefill, params, {"tokens": tokens})
        torch.cuda.synchronize()
        return logits, rep, (_now() - t0) * 1e3

    try:
        with use_mesh_rules(mesh, rules):
            launches, _, _, _, (logits, rep, ms) = _counted_int8(prefill,
                                                                 set())
            logits = gather_logits(logits)
    finally:
        unwrap()
    n = model.cfg.n_layers
    check(launches["flash_attention"] == n == worst["n_fwd"]
          and launches["qmatmul"] == 0,
          f"seqpar (b) prefill launched {launches}, held {worst['n_fwd']}")
    check("reduce-scatter" in rep.stats.by_count,
          f"seqpar (b): no reduce-scatter in {rep.stats.by_count}")
    out = {"logits": logits, "launches": launches,
           "collectives": _collectives(rep), "prefill_ms": ms,
           "k6_q_shape": list(caught["fwd"][0].shape),
           "k6_worst": worst["fwd"]}
    log(f"seqpar (b): {model.cfg.name} prefill 1 x {tokens.shape[1]} under "
        f"seqpar: launches {json.dumps(launches)}, {ms:.3f} ms (under the "
        f"op-trace analysis, host clock: a smoke reading), collectives "
        f"{json.dumps(out['collectives'])}")
    return out


def _int_mm_padded(x, w):
    """``torch._int_mm`` (the library's int8 product, timed beside K5 and
    used nowhere in the port), its rows padded to the 17 it needs."""
    import torch

    m = x.shape[0]
    if m > 16:
        return torch._int_mm(x, w)
    return torch._int_mm(torch.nn.functional.pad(x, (0, 0, 0, 17 - m)),
                         w)[:m]


def _spmd2_k5_rows(kept, shapes):
    """K5 timed at each rank-local shape of the mesh's int8 prefill and
    decode steps, on the rank's own codes; ``launches``: the shape's
    count on this rank (the parent doubles it for the two ranks)."""
    import torch
    from repro_torch.kernels import ops, ref

    rows = []
    for shape, (x, w, sc) in kept.items():
        m, k, n = shape[:3]
        acc = sc is None
        # the accumulator mode reads no scale; its int32 output is 4
        # bytes an element, as the float32 one
        nbytes = m * k + k * n + (0 if acc else 4 * n) + 4 * m * n
        nops = k5_ops(m, k, n)
        row = {"kernel": "qmatmul", "model": f"{LM_CONFIG} int8 on "
                                             f"{SPMD2_MESH}",
               "stage": "prefill" if m > len(SPMD2_DECODE_CUR) else
               "decode", "shape": f"M={m} K={k} N={n}"
               + (" int32 accumulator" if acc else ""), "bytes": nbytes,
               "ops": nops, "launches": shapes.count(shape),
               "ms": time_ms(lambda: ops.qmatmul(x, w, sc), reps=5, inner=5),
               "plain_ms": time_ms(lambda: ref.qmatmul_ref(x, w, sc),
                                   reps=3, inner=1),
               "library_ms": time_ms(
                   lambda: _int_mm_padded(x, w) if acc
                   else _int_mm_padded(x, w).to(torch.float32) * sc,
                   reps=5, inner=5),
               "bound_ms": bound_ms(nbytes, nops, INT8_OPS_PER_S),
               "bound_by": bound_by(nbytes, nops, INT8_OPS_PER_S)}
        rows.append(row)
        log(f"time qmatmul {row['model']} {row['stage']} {row['shape']} x "
            f"{row['launches']} a rank: kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, torch._int_mm"
            f"{'' if acc else ' + scale'} {row['library_ms']:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms")
    check(sum(r["launches"] for r in rows) == len(shapes),
          "the timed K5 shapes do not cover the mesh's launches")
    return rows


def _spmd2_jamba(rank, smi):
    """(d): jamba-v0.1-52b at full width, 8 layers, in float32 (TF32
    off) on (1, 2): the rank's blocks drawn one rank at a time (bf16
    draws, the whole tree 25 GB, made float32 as blocks), a counted
    prefill of 1 x 4096 (its K6 launch held against its plain version)
    and 4 decode steps at batch 4; then rank 0 alone on the whole tree
    (the same draws made float32), the mesh's logits within
    ``SUBLAYER_TOL`` of its largest |logit|. float32, because at a
    decode step's 4 tokens an expert takes one token (capacity factor
    1.25, 16 experts, top-2) and bf16 noise flips near-tied routing
    choices, which moves a token's output by its own size."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules

    cfg16 = dataclasses.replace(get_config(JAMBA_CONFIG),
                                n_layers=SPMD2_JAMBA_LAYERS)
    cfg = dataclasses.replace(cfg16, dtype="float32")
    kinds = [cfg.layer_kind(i) for i in range(cfg.block_period)]
    moe = [cfg.layer_is_moe(i) for i in range(cfg.block_period)]
    check("attn" in kinds and "ssm" in kinds and any(moe),
          f"jamba cut to {cfg.n_layers} layers lacks a sublayer kind")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 54)
    tokens = torch.randint(0, cfg.vocab, (1, FAMILY_SEQ), generator=g,
                           device="cuda")
    dec_tokens = [torch.randint(0, cfg.vocab, (len(SPMD2_DECODE_CUR), 1),
                                generator=g, device="cuda")
                  for _ in range(SPMD2_JAMBA_DECODE_STEPS)]

    def init():
        return Model(cfg16).init(torch.Generator(device="cuda").manual_seed(
            SEED + 55), device="cuda")

    mesh, rules = _spmd_mesh(SPMD2_MESH, cfg, 1)
    out, caught = {}, {}
    with torch.inference_mode(), full_fp32(), use_mesh_rules(mesh, rules):
        params = None
        for r in range(2):
            if rank == r:
                full = init()
                params = shard_tree(full, model.param_specs())
                del full
                params = _float32_tree(params)
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = _now()
        worst_k6, unwrap = _spmd_checked_k6(caught)
        try:
            pre, steps, launches, coll, ms, _, _, _ = _mesh_inference(
                model, params, tokens, dec_tokens)
        finally:
            unwrap()
        out.update(launches=launches, collectives=coll,
                   decode_ms=ms, wall_s=_now() - t0,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   k6_worst=worst_k6["fwd"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
    check(launches["flash_attention"] == kinds.count("attn") * cfg.n_groups
          == worst_k6["n_fwd"], f"jamba mesh prefill launched {launches}")
    log(f"spmd inference (d) rank {rank}: {JAMBA_CONFIG} ({cfg.n_layers} "
        f"layers: {kinds}, MoE {moe}; float32) on {SPMD2_MESH} ({smi}): "
        f"launches {json.dumps(launches)}; collectives {json.dumps(coll)}; "
        f"decode step ms {[round(x, 3) for x in ms]}; prefill and decode "
        f"{out['wall_s']:.3f} s, peak {out['peak_bytes'] / 2**30:.3f} GiB")
    # phase 26 (d): the same weights and inputs under ep
    ep = _spmd2_jamba_ep(rank, smi, model, init, tokens, dec_tokens)
    check(ep["launches"]["flash_attention"] == launches["flash_attention"],
          f"ep (d) launched {ep['launches']}")
    out["ep"] = {k: ep[k] for k in ("launches", "collectives", "decode_ms",
                                    "k6_worst", "peak_bytes")}
    dist.barrier()
    if rank == 0:
        with torch.inference_mode(), full_fp32():
            one_pre, one_steps = _one_rank_runs(
                model, _float32_tree(init()), tokens, dec_tokens)
            out["against_one_rank"] = {
                "prefill": _float32_check(f"spmd {JAMBA_CONFIG} prefill",
                                          pre, one_pre),
                "decode": [_float32_check(
                    f"spmd {JAMBA_CONFIG} decode step {t}", a, b)
                    for t, (a, b) in enumerate(zip(steps, one_steps))]}
            out["ep"]["against_one_rank"] = {
                "prefill": _float32_check(
                    f"ep (d) {JAMBA_CONFIG} prefill", ep["pre"], one_pre),
                "decode": [_float32_check(
                    f"ep (d) {JAMBA_CONFIG} decode step {t}", a, b)
                    for t, (a, b) in enumerate(zip(ep["steps"],
                                                   one_steps))]}
            del one_pre, one_steps
            gc.collect()
            torch.cuda.empty_cache()
            q, k, v, kw = caught["fwd"]
            out["k6_row"] = time_case(flash_case(
                f"spmd inference {SPMD2_MESH} float32 prefill", q, k, v, kw,
                model=JAMBA_CONFIG), reps=3, inner=3)
        log(f"spmd inference (d): {JAMBA_CONFIG} against one rank "
            f"(float32, max |diff| over max |logit|): "
            f"{json.dumps(out['against_one_rank'])}")
    del pre, steps, caught, ep
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _spmd2_jamba_ep(rank, smi, model, init, tokens, dec_tokens):
    """Phase 26 (d): (d)'s model, weights and inputs on ``SPMD2_MESH``
    under ``ep`` (8 of the 16 experts a rank, whole; the dense MLPs
    whole): the rank's blocks drawn one rank at a time, a counted prefill
    (K6 held against its plain version) and the decode steps, the first
    of each under the op-trace analysis (their collectives: (e))."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.qir import full_fp32
    from repro_torch.parallel.sharding import shard_tree, use_mesh_rules

    mesh, rules = _spmd_mesh(SPMD2_MESH, model.cfg, 1, "ep")
    caught = {}
    with torch.inference_mode(), full_fp32(), use_mesh_rules(mesh, rules):
        params = None
        for r in range(SPMD_RANKS):
            if rank == r:
                full = init()
                params = shard_tree(full, model.param_specs())
                del full
                params = _float32_tree(params)
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        worst, unwrap = _spmd_checked_k6(caught)
        try:
            pre, steps, launches, coll, ms, _, _, _ = _mesh_inference(
                model, params, tokens, dec_tokens)
        finally:
            unwrap()
        peak = torch.cuda.max_memory_allocated()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    check(worst["n_fwd"] == launches["flash_attention"],
          f"ep (d): held {worst['n_fwd']} of {launches} K6 launches")
    log(f"ep (d) rank {rank}: {model.cfg.name} ({model.cfg.n_layers} "
        f"layers, float32) on {SPMD2_MESH} under ep ({smi}): launches "
        f"{json.dumps(launches)}; collectives {json.dumps(coll)}; decode "
        f"step ms {[round(x, 3) for x in ms]}; peak {peak / 2**30:.3f} GiB")
    return {"pre": pre, "steps": steps, "launches": launches,
            "collectives": coll, "decode_ms": ms, "k6_worst": worst["fwd"],
            "peak_bytes": peak}


def _spmd2_worker(argv):
    """One rank of phase 25 (``chip_smoke.py --spmd-inference-worker RANK
    WORLD INIT DIR``): a gloo group over the card's tensors; its results
    go to ``DIR/rank<RANK>.json``."""
    rank, world, init, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {"rank": rank}
    for key, fn in (("small", lambda: _spmd2_small(rank)),
                    ("mamba", lambda: _spmd2_mamba(rank, smi)),
                    ("llama", lambda: _spmd2_llama(rank, smi)),
                    ("jamba", lambda: _spmd2_jamba(rank, smi))):
        t0 = _now()
        out[key] = fn()
        out[key + "_s"] = _now() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


#: ``--mamba-gap``: phase 25 (b)'s falcon-mamba-7b cut to this depth,
#: trained in bf16 and in float32 (TF32 off), each on (1, 2) and on one
#: rank: whether the bf16 gap of this depth from one rank is bf16's own
#: noise (it closes in float32) or the mesh's (it stays)
MAMBA_GAP_LAYERS = 8


def _mamba_gap_worker(argv):
    """One rank of ``--mamba-gap`` (``chip_smoke.py --mamba-gap-worker
    RANK WORLD INIT DIR``): phase 25 (b) at ``MAMBA_GAP_LAYERS`` layers in
    bf16, then in float32; results to ``DIR/rank<RANK>.json``."""
    rank, world, init, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {"rank": rank, "card": smi}
    for key, f32 in (("bfloat16", False), ("float32", True)):
        t0 = _now()
        out[key] = _spmd2_mamba(rank, smi, MAMBA_GAP_LAYERS, float32=f32)
        out[key + "_s"] = _now() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def mamba_gap() -> int:
    """``python3 chip_smoke.py --mamba-gap``: falcon-mamba-7b at its
    published widths cut to ``MAMBA_GAP_LAYERS`` layers, phase 25 (b)'s
    three steps on (1, 2) over two ``gloo`` ranks that share the card and
    on rank 0 alone, in bf16 and in float32 (TF32 off). Prints each
    step's losses and the mesh's relative gap from one rank, a JSON line
    of them (also ``chiprun_out/mamba_gap.json``). Needs one card; runs
    no kernel of ``csrc/``."""
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="mamba-gap-",
                               dir=os.path.join(ROOT, "build"))
    try:
        res = _spmd_ranks(workdir, "--mamba-gap-worker", "mamba_gap_rank",
                          SPMD2_TIMEOUT_S, SPMD2_RANK_ENV)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = {"card": res[0]["card"], "n_layers": MAMBA_GAP_LAYERS}
    for key in ("bfloat16", "float32"):
        mesh = res[0][key]["losses"]
        one = res[0][key]["one_rank_losses"]
        out[key] = {"mesh": mesh, "one_rank": one,
                    "rel_gap": [abs(a - b) / abs(b)
                                for a, b in zip(mesh, one)],
                    "mesh_step_ms": res[0][key]["step_ms"],
                    "one_rank_step_ms": res[0][key]["one_rank_step_ms"],
                    "seconds": res[0][key + "_s"]}
        log(f"mamba gap {SPMD2_MAMBA} {MAMBA_GAP_LAYERS} layers {key}: "
            f"mesh {SPMD2_MESH} losses {mesh}, one rank {one}, relative gap "
            f"{[f'{g:.3g}' for g in out[key]['rel_gap']]} ({out['card']})")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mamba_gap.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    return 0


def _spmd2_meta_collectives():
    """(e): the same steps as (b) and (c) (the train step, the prefills
    and the first decode steps) traced rank-locally on meta by
    the dry run's machinery, over torch's fake process group of two
    ranks on the (1, 2) mesh: {label: collectives}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig

    mamba = dataclasses.replace(get_config(SPMD2_MAMBA),
                                n_layers=SPMD2_MAMBA_LAYERS)
    llama = get_config(LM_CONFIG)
    return _meta_collectives({
        "train (b)": (mamba, ShapeConfig("train", TRAIN_SEQ,
                                         SPMD2_MAMBA_BATCH, "train"), 16),
        "prefill bf16 (c)": (llama, ShapeConfig("prefill", LM_SEQ, 1,
                                                "prefill"), 16),
        "prefill int8 (c)": (llama, ShapeConfig("prefill", LM_SEQ, 1,
                                                "prefill"), 8),
        "decode bf16 (c)": (llama, ShapeConfig(
            "decode", SPMD2_DECODE_LEN, len(SPMD2_DECODE_CUR), "decode"),
            16),
        "decode int8 (c)": (llama, ShapeConfig(
            "decode", SPMD2_DECODE_LEN, len(SPMD2_DECODE_CUR), "decode"), 8),
    })


def _meta_collectives(cells):
    """{label: (config, shape, weight bits[, strategy])} -> {label: the
    collectives of the cell's step traced rank-locally on meta by the dry
    run's machinery, over torch's fake process group of two ranks on the
    (1, 2) mesh under the strategy's rules}."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_process_group
    from repro_torch.parallel.sharding import use_mesh_rules

    out = {}
    init_fake_process_group(SPMD_RANKS)
    try:
        for label, (cfg, shape, bits, *strategy) in cells.items():
            model, trees = dryrun._abstract_trees(cfg, shape, bits)
            mesh, rules = _spmd_mesh(SPMD2_MESH, cfg, shape.global_batch,
                                     *strategy)
            with use_mesh_rules(mesh, rules):
                rep = dryrun.trace_step(model, shape, dryrun.rank_trees(
                    model, shape, trees))
            out[label] = _collectives(rep)
    finally:
        dist.destroy_process_group()
    return out


def phase_seqpar_ep(smi, spmd, spmd2):
    """Phase 26 (module docstring): (a)-(d) ran in phases 24 and 25's
    ranks beside the one-rank runs they reuse (and were held there); here
    (e), each real step's collectives against its meta trace, and the
    phase's summary. Returns details."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig

    t0 = _now()
    train = get_config(SPMD_FULL)
    scout = _seqep_scout_config()
    llama = get_config(LM_CONFIG)
    jamba = dataclasses.replace(get_config(JAMBA_CONFIG),
                                n_layers=SPMD2_JAMBA_LAYERS, dtype="float32")
    meta = _meta_collectives({
        "train seqpar (a)": (train, ShapeConfig(
            "train", TRAIN_SEQ, SPMD_FULL_BATCH, "train"), 16, "seqpar"),
        "train ep (c)": (scout, ShapeConfig(
            "train", SEQEP_SCOUT_SEQ, SEQEP_SCOUT_BATCH, "train"), 16, "ep"),
        "prefill seqpar (b)": (llama, ShapeConfig(
            "prefill", LM_SEQ, 1, "prefill"), 16, "seqpar"),
        "prefill ep (d)": (jamba, ShapeConfig(
            "prefill", FAMILY_SEQ, 1, "prefill"), 16, "ep"),
        "decode ep (d)": (jamba, ShapeConfig(
            "decode", SPMD2_DECODE_LEN, len(SPMD2_DECODE_CUR), "decode"),
            16, "ep"),
    })
    full, ep = spmd["full"][0], spmd["ep"][0]
    llama_r, jamba_r = spmd2["llama"][0], spmd2["jamba"][0]
    real = {"train seqpar (a)": full["seqpar"]["collectives"],
            "train ep (c)": ep["collectives"],
            "prefill seqpar (b)": llama_r["seqpar"]["collectives"],
            "prefill ep (d)": jamba_r["ep"]["collectives"]["prefill"],
            "decode ep (d)": jamba_r["ep"]["collectives"]["decode"]}
    for label, want in meta.items():
        check(real[label] == want,
              f"seqpar/ep (e) {label}: the card's rank-local step counted "
              f"{json.dumps(real[label])}, its meta trace {json.dumps(want)}")
    check(real["train seqpar (a)"]["by_count"].get("reduce-scatter", 0) > 0
          and real["prefill seqpar (b)"]["by_count"].get(
              "reduce-scatter", 0) > 0,
          "seqpar (e): the steps under seqpar issued no reduce-scatter")
    fulls = spmd["full"]
    details = {
        "card": smi,
        "a_seqpar_train": {
            "config": SPMD_FULL, "mesh": list(SPMD_FULL_MESH),
            "losses": fulls[0]["seqpar"]["losses"],
            "baseline_losses": fulls[0]["losses"],
            "one_rank_losses": fulls[0]["one_rank_losses"],
            "step_ms": [f["seqpar"]["step_ms"] for f in fulls],
            "baseline_step_ms": [f["step_ms"] for f in fulls],
            "peak_bytes": [f["seqpar"]["peak_bytes"] for f in fulls],
            "baseline_peak_bytes": [f["peak_bytes"] for f in fulls]},
        "b_seqpar_prefill": {
            "config": LM_CONFIG,
            "prefill_ms": [x["seqpar"]["prefill_ms"]
                           for x in spmd2["llama"]],
            "against_one_rank": llama_r["against_one_rank"]["bf16"][
                "seqpar"],
            "baseline_against_one_rank": llama_r["against_one_rank"][
                "bf16"]["prefill"],
            "noise_prefill": llama_r["against_one_rank"]["bf16"][
                "noise_prefill"]},
        "c_ep_train": {
            "config": SEQEP_SCOUT, "layers": SEQEP_SCOUT_LAYERS,
            "losses": ep["losses"], "one_rank_losses": ep["one_rank_losses"],
            "step_ms": [x["step_ms"] for x in spmd["ep"]],
            "one_rank_step_ms": ep["one_rank_step_ms"],
            "peak_bytes": [x["peak_bytes"] for x in spmd["ep"]],
            "one_rank_peak_bytes": ep["one_rank_peak_bytes"]},
        "d_ep_jamba": {
            "against_one_rank": jamba_r["ep"]["against_one_rank"],
            "baseline_against_one_rank": jamba_r["against_one_rank"],
            "decode_ms": [x["ep"]["decode_ms"] for x in spmd2["jamba"]],
            "peak_bytes": [x["ep"]["peak_bytes"] for x in spmd2["jamba"]]},
        "e_collectives": {"card": real, "meta": meta},
        "wall_s": _now() - t0}
    log(f"seqpar/ep phase ({smi}): (a) {SPMD_FULL} under seqpar on "
        f"{SPMD_FULL_MESH}: losses {details['a_seqpar_train']['losses']} "
        f"(baseline mesh {fulls[0]['losses']}, one rank "
        f"{fulls[0]['one_rank_losses']}), step ms "
        f"{details['a_seqpar_train']['step_ms']} (baseline mesh "
        f"{details['a_seqpar_train']['baseline_step_ms']}), peak GiB "
        f"{[round(b / 2**30, 3) for b in details['a_seqpar_train']['peak_bytes']]}"
        f" (baseline mesh "
        f"{[round(b / 2**30, 3) for b in details['a_seqpar_train']['baseline_peak_bytes']]}"
        f"); (b) {LM_CONFIG} seqpar prefill against one rank "
        f"{json.dumps(details['b_seqpar_prefill']['against_one_rank'])} "
        f"(bf16 noise {details['b_seqpar_prefill']['noise_prefill']}); (c) "
        f"{SEQEP_SCOUT} ({SEQEP_SCOUT_LAYERS} layer) under ep: losses "
        f"{ep['losses']} against one rank {ep['one_rank_losses']}, step ms "
        f"{details['c_ep_train']['step_ms']} (one rank "
        f"{ep['one_rank_step_ms']}), peak GiB "
        f"{[round(b / 2**30, 3) for b in details['c_ep_train']['peak_bytes']]}"
        f" (one rank {ep['one_rank_peak_bytes'] / 2**30:.3f}); (d) "
        f"{JAMBA_CONFIG} under ep against one rank "
        f"{json.dumps(jamba_r['ep']['against_one_rank'])}; (e) collective "
        f"bytes a rank, card = meta: "
        f"{json.dumps({k: v['bytes'] for k, v in real.items()})}; "
        f"{details['wall_s']:.3f} s")
    return details


def _production_collectives(dryrun_details):
    """(e): the collective bytes a device of phase 23's dry run records
    for a train, a prefill and a decode cell of the single-pod mesh."""
    recs = dryrun_details["all"]["records"]
    out = {}
    for key in ("falcon-mamba-7b train_4k", "llama3-8b prefill_32k",
                "llama3-8b decode_32k"):
        rec = recs[key]
        check(rec["collective_bytes_per_device"] is not None
              and rec["collective_bytes_per_device"] > 0,
              f"dry run {key}: no collective bytes")
        out[key] = {k: rec[k] for k in ("collective_bytes_per_device",
                                        "collectives_by_type",
                                        "collectives_count")}
    return out


def phase_spmd_inference(smi, dryrun_details):
    """Phase 25 (module docstring). Returns (K6 and K5 launches of the
    mesh's counted runs, their worst |kernel - plain|, the timing rows,
    details)."""
    import shutil

    import torch
    from repro_torch.obs import timer

    t0 = timer.now()
    # the ranks need the card's memory: this process's cached blocks are
    # freed first
    gc.collect()
    torch.cuda.empty_cache()
    held = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    log(f"spmd inference: this process holds {json.dumps(held)} of the "
        f"card as the ranks start")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="spmd2-", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        res = _spmd_ranks(workdir, "--spmd-inference-worker",
                          "spmd_inference_rank", SPMD2_TIMEOUT_S,
                          SPMD2_RANK_ENV)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    small = res[0]["small"]
    for name in SPMD2_SSM:
        for mesh in SPMD_SMALL_MESHES:
            key = f"{mesh[0]}x{mesh[1]}"
            check(all(r["small"][name][key] == small[name][key]
                      for r in res),
                  f"spmd inference (a) {name} {mesh}: the ranks' losses "
                  f"differ: {[r['small'][name][key] for r in res]}")
    mamba = [r["mamba"] for r in res]
    check(all(m["losses"] == mamba[0]["losses"] for m in mamba),
          f"spmd inference (b): the ranks' losses differ: "
          f"{[m['losses'] for m in mamba]}")
    one = mamba[0]["one_rank_losses"]
    check(all(abs(a - b) <= SPMD_FULL_RTOL * abs(b)
              for a, b in zip(mamba[0]["losses"], one)),
          f"spmd inference (b) {SPMD2_MAMBA}: losses {mamba[0]['losses']} "
          f"against one rank's {one}")
    llama, jamba = [r["llama"] for r in res], [r["jamba"] for r in res]
    int8_runs = ("int8", "int8_float32")
    # with phase 26's (b) (llama3-8b's seqpar prefill, K6 at the baseline
    # mesh's shape) and (d) (jamba under ep, K6 at the baseline mesh's)
    launches = {
        "flash_attention": sum(x[k]["launches"]["flash_attention"]
                               for x in llama
                               for k in ("bf16", "seqpar") + int8_runs)
        + sum(x["launches"]["flash_attention"]
              + x["ep"]["launches"]["flash_attention"] for x in jamba),
        "qmatmul": sum(x[k]["launches"]["qmatmul"] for x in llama
                       for k in int8_runs)}
    k6_row = llama[0]["k6_row"]
    k6_row["launches"] = sum(x[k]["launches"]["flash_attention"]
                             for x in llama
                             for k in ("bf16", "seqpar", "int8"))
    k6_llama_f32_row = llama[0]["k6_f32_row"]
    k6_llama_f32_row["launches"] = sum(
        x["int8_float32"]["launches"]["flash_attention"] for x in llama)
    k6_f32_row = jamba[0]["k6_row"]
    k6_f32_row["launches"] = sum(x["launches"]["flash_attention"]
                                 + x["ep"]["launches"]["flash_attention"]
                                 for x in jamba)
    k5_rows = llama[0]["k5_rows"]
    for row in k5_rows:
        row["launches"] *= SPMD_RANKS
    check(sum(r["launches"] for r in k5_rows) == launches["qmatmul"],
          "phase 25's K5 rows do not cover the two ranks' launches")
    worst = {"flash_attention": max(
        [x["k6_worst"] for x in llama + jamba]
        + [x["ep"]["k6_worst"] for x in jamba]),
             "qmatmul": max(x["k5_worst"] for x in llama)}
    # (e): the real steps' collectives against the meta traces of the
    # same steps, and the production cells of the dry run
    meta = _spmd2_meta_collectives()
    real = {"train (b)": mamba[0]["collectives"]}
    for label in ("bf16", "int8"):
        for call in ("prefill", "decode"):
            real[f"{call} {label} (c)"] = llama[0][label]["collectives"][call]
    for label, want in meta.items():
        check(real[label] == want,
              f"spmd inference (e) {label}: the card's rank-local step "
              f"counted {json.dumps(real[label])}, its meta trace "
              f"{json.dumps(want)}")
    production = _production_collectives(dryrun_details)
    details = {"card": smi, "parent_held": held, "small": small,
               "mamba": mamba, "llama": llama,
               "jamba": jamba, "launches": launches,
               "collectives": {"card": real, "meta": meta,
                               "dry_run_single_pod": production},
               "ranks_s": {k: res[0][k + "_s"] for k in
                           ("small", "mamba", "llama", "jamba")},
               "wall_s": timer.now() - t0}
    log(f"spmd inference phase ({smi}): (a) {json.dumps(small)}; (b) "
        f"{SPMD2_MAMBA} {SPMD2_MAMBA_LAYERS} layers on {SPMD2_MESH}: losses "
        f"{mamba[0]['losses']} against one rank {one}, step ms "
        f"{[m['step_ms'] for m in mamba]} (host clock, through gloo and the "
        f"host: a smoke reading; the first under the op-trace analysis), "
        f"peak GiB {[round(m['peak_bytes'] / 2**30, 3) for m in mamba]}; "
        f"(c) {LM_CONFIG}: K6 {launches['flash_attention']} and K5 "
        f"{launches['qmatmul']} launches over both ranks (with (d)), "
        f"against one rank {json.dumps(llama[0]['against_one_rank'])}; (d) "
        f"{JAMBA_CONFIG}: {json.dumps(jamba[0]['against_one_rank'])}; (e) "
        f"collective bytes a rank, card = meta: "
        f"{json.dumps({k: v['bytes'] for k, v in real.items()})}; the dry "
        f"run's single-pod cells a device: "
        f"{json.dumps({k: v['collective_bytes_per_device'] for k, v in production.items()})}; "
        f"ranks' phases s {json.dumps(details['ranks_s'])}; "
        f"{details['wall_s']:.3f} s")
    return (launches, worst, [k6_row, k6_llama_f32_row, k6_f32_row]
            + k5_rows, details)



# ---------------------------------------------------------------------------
# phase 27: the compiled programs, one CUDA graph per input shape
# ---------------------------------------------------------------------------

#: host-clock calls a 1-row ``offline`` is timed over, eagerly and by replay
PROGRAM_TIMED_CALLS = 1000
#: the decode step the engines' graphs are held on: slot positions (of a
#: 256-long cache)
PROGRAM_DECODE_CUR = (17, 64, 100, 200)


def _nonzero(launches):
    return {k: n for k, n in launches.items() if n}


def _fresh(a, b):
    """Whether two results share no memory."""
    return (a.untyped_storage().data_ptr()
            != b.untyped_storage().data_ptr())


def _held_replay(label, prog, *args):
    """``prog(*args)``: the first call (warm-up and capture), then a replay
    counted alone, which must equal ``prog.fn`` run eagerly on the same
    inputs bit for bit (every output leaf) and launch what the eager run
    launches, the launches the graph recorded at its capture; a second
    replay must not alias the first. For a function without side
    effects. Returns (the replay's output, its launches)."""
    import torch
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels import ops

    prog(*args)
    torch.cuda.synchronize()
    ops.reset_launches()
    got = prog(*args)
    torch.cuda.synchronize()
    replay = _nonzero(ops.launches)
    again = prog(*args)
    ops.reset_launches()
    want = prog.eager(*args)
    torch.cuda.synchronize()
    eager = _nonzero(ops.launches)
    for g, w, a in zip(leaves(got), leaves(want), leaves(again)):
        check(g.dtype == w.dtype and g.shape == w.shape
              and torch.equal(g, w),
              f"{label}: the replay differs from the eager run (max |diff| "
              f"{float((g.double() - w.double()).abs().max()):.3g})")
        check(torch.equal(a, g) and _fresh(a, g),
              f"{label}: two replays differ or alias")
    recorded = [_nonzero(v) for v in prog.replay_launches().values()]
    check(replay == eager and replay in recorded,
          f"{label}: a replay launched {replay}, the eager run {eager}, the "
          f"capture recorded {recorded}")
    return got, replay


def _segments_held(label, cm, wave):
    """``wave`` through every segment program, each held by
    ``_held_replay`` (a host boundary's stages eagerly); returns the last
    wave and the programs' summed launches."""
    total = {}
    for k, seg in enumerate(cm.segments):
        if not seg.compiled:     # a host boundary: no program
            wave = cm._per_micro(cm.schedule.stages[seg.start:seg.stop],
                                 wave)
            continue
        wave, n = _held_replay(f"{label} segment {k}", cm._segment_fn(k),
                               wave)
        for key, v in n.items():
            total[key] = total.get(key, 0) + v
    return wave, total


def _host_percentiles(fn, n):
    """p50 and p90 host-clock ms of ``n`` synchronised calls, after one."""
    import numpy as np
    import torch
    from repro_torch.obs import timer

    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(n):
        t0 = timer.now()
        fn()
        torch.cuda.synchronize()
        vals.append((timer.now() - t0) * 1e3)
    return {"p50_ms": float(np.percentile(vals, 50)),
            "p90_ms": float(np.percentile(vals, 90))}


#: a program whose function reads a value on the host, in a child process
#: (``_failed_capture``): prints a JSON list of its two calls' errors and
#: the graphs it holds
FAILED_CAPTURE_CHILD = """
import json, torch
from repro_torch.core.programs import Program
prog = Program(lambda x: x * float(x.sum()), "cuda", name="host-read")
x = torch.ones(4, device="cuda")
errors = []
for _ in range(2):
    try:
        prog(x)
    except RuntimeError as e:
        errors.append(str(e))
print(json.dumps({"errors": errors, "graphs": len(prog)}))
"""


def _failed_capture():
    """A program whose function reads a value on the host: its call must
    raise, hold no graph, and raise again on the next call (no eager
    fallback). In a child process: an aborted capture can leave the
    process's caching allocator unable to hand its cached memory back to
    the card, and later phases need all of it. Returns the error's
    text."""
    proc = subprocess.run(
        [sys.executable, "-c", FAILED_CAPTURE_CHILD], capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
    check(proc.returncode == 0, f"the failed-capture child exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    errors = got["errors"]
    check(len(errors) == 2 and got["graphs"] == 0
          and all("capture" in e for e in errors),
          f"a capture that reads the host: {got}")
    return errors[0]


def phase_programs(models, tuned, smi):
    """Phase 27 (a) (module docstring). Returns {model/mode: readings}."""
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.obs import timer

    t_phase = timer.now()
    out = {"failed_capture": _failed_capture()}
    log(f"programs: a capture that reads the host raises, twice, and holds "
        f"no graph: {out['failed_capture'][:160]}")
    for name, g, s, x in models:
        for mode, mega in MODES:
            label = f"{name}/{mode}"
            cm = compile_graph(g, in_scale=s, device="cuda", megakernel=mega)
            cm.apply_tuned(tuned[name].tuned)
            cm.set_megakernel(mega)
            mb = cm.default_micro_batch
            want = {k: n for k, n in zip(TINY_KERNELS,
                                         MAIN_PATH_LAUNCHES[label]) if n}
            want[HEAD_KERNEL] = 1
            for rows in (1, BATCH):
                _, n = _held_replay(f"{label} offline {rows} rows",
                                    cm._offline,
                                    torch.as_tensor(x[:rows]))
                check(n == want, f"{label} offline {rows} rows: a replay "
                                 f"launched {n}, expected {want}")
            headless = _headless(cm)
            codes, n = _held_replay(f"{label} offline codes",
                                    headless._offline, torch.as_tensor(x))
            check(n == {k: v for k, v in want.items() if k != HEAD_KERNEL},
                  f"{label} codes: a replay launched {n}")
            del headless
            # streaming_compiled at the tuned micro-batch, segment by segment
            x_p, rows, n_micro = cm._pad_micro(x, mb)
            wave = x_p.reshape((n_micro, mb) + tuple(x_p.shape[1:]))
            y_stream, stream_l = _segments_held(f"{label} stream mb {mb}",
                                                cm, wave)
            y, _ = cm.streaming_compiled(x)
            check(torch.equal(y, y_stream.reshape(
                (n_micro * mb,) + tuple(y_stream.shape[2:]))[:rows]),
                f"{label}: streaming_compiled differs from its segments")
            # submit_wave, full and a third filled: one graph a segment
            wave_l = None
            for fill in (mb, max(1, mb // 3)):
                w = torch.zeros((1, mb) + tuple(x.shape[1:]),
                                dtype=torch.int32)
                w[0, :fill] = torch.as_tensor(x[:fill])
                y_wave, wave_l = _segments_held(
                    f"{label} wave {fill}/{mb}", cm, w.cuda())
                got, mask = cm.submit_wave(x[:fill], micro_batch=mb)
                check(mask.sum() == fill and torch.equal(got, y_wave[0]),
                      f"{label}: submit_wave of {fill}/{mb} rows differs "
                      f"from its segments")
            progs = cm.programs()
            graphs = {p.name: len(p) for p in progs}
            check(graphs["offline"] == 2 and all(graphs.values()),
                  f"{label}: graphs held {graphs}")
            cm.apply_tuned(tuned[name].tuned)
            check(all(len(p) == 0 for p in progs)
                  and len(cm._offline) == 0,
                  f"{label}: apply_tuned kept a graph")
            cm.set_megakernel(mega)
            # 1-row offline, eagerly and by replay, on the host clock
            x1 = x[:1]
            x1_dev = torch.as_tensor(x1, device="cuda")
            eager = _host_percentiles(
                lambda: cm._offline.fn(torch.as_tensor(x1, device="cuda")),
                PROGRAM_TIMED_CALLS)
            replay = _host_percentiles(lambda: cm.offline(x1),
                                       PROGRAM_TIMED_CALLS)
            dev = time_ms(lambda: cm._run_all(x1_dev))
            out[label] = r = {
                "micro_batch": mb, "graphs": graphs,
                "launches_offline": want, "launches_stream": stream_l,
                "launches_wave": wave_l, "eager_1row": eager,
                "replay_1row": replay, "device_ms_1row": dev,
                "device_share_eager": dev / eager["p50_ms"],
                "device_share_replay": dev / replay["p50_ms"]}
            log(f"programs {label} (mb {mb}): offline at 1 and {BATCH} rows, "
                f"the codes, streaming_compiled and submit_wave ({mb} and "
                f"{max(1, mb // 3)} rows) replay their eager runs bit for "
                f"bit; graphs {json.dumps(graphs)}, dropped by apply_tuned; "
                f"launches a replay: offline {json.dumps(want)}, stream "
                f"{json.dumps(stream_l)}, wave {json.dumps(wave_l)}; 1-row "
                f"offline eager p50 {eager['p50_ms']:.6f} / p90 "
                f"{eager['p90_ms']:.6f} ms, replay p50 "
                f"{replay['p50_ms']:.6f} / p90 {replay['p90_ms']:.6f} ms "
                f"(host clock, synchronised, {PROGRAM_TIMED_CALLS} calls); "
                f"device {dev:.6f} ms, {r['device_share_eager']:.1%} of the "
                f"eager p50, {r['device_share_replay']:.1%} of the replay's "
                f"({smi})")
            del cm
            gc.collect()
    out["phase_s"] = timer.now() - t_phase
    log(f"programs (a): {len(models) * len(MODES)} models and modes in "
        f"{out['phase_s']:.3f} s")
    return out


def _drop_graphs(cms):
    """Drop every graph of the compiled models ``cms`` and hand their
    memory back to the card."""
    import torch

    for cm in cms:
        for prog in cm.programs():
            prog.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _engine_programs(label, model, params, prompts, eager=None):
    """Phase 27 (b) on one model: ``ServeEngine`` eagerly (``eager``: the
    outputs and stats of an eager run already made) and through its
    graphs on the same requests, the tokens equal; then, on the graph
    engine's caches, one decode step at ``PROGRAM_DECODE_CUR`` by replay
    and eagerly from the same cache (restored): logits and caches equal
    bit for bit, the launches equal; a decode step's host ms each way.
    Returns (the graph engine's outputs and stats, readings)."""
    import numpy as np
    import torch
    from repro_torch.core.pytree import leaves
    from repro_torch.kernels import ops

    if eager is None:
        outs_e, stats_e, _, _ = _serve(model, params, prompts, graphs=False)
    else:
        outs_e, stats_e = eager
    outs, stats, _, eng = _serve(model, params, prompts)
    check(outs == outs_e, f"{label}: the engine's graphs give {outs}, its "
                          f"eager steps {outs_e}")
    prog = eng.decode_program
    check(len(prog) == 1 and len(eng.prefill_program) == 1,
          f"{label}: {len(prog)} decode and {len(eng.prefill_program)} "
          f"prefill graphs, expected one each")
    (recorded,) = [_nonzero(v) for v in prog.replay_launches().values()]
    tok = torch.as_tensor(eng.last_token)
    cur = torch.as_tensor(np.asarray(PROGRAM_DECODE_CUR, np.int32))
    snap = [c.clone() for c in leaves(eng.caches)]
    torch.cuda.synchronize()
    ops.reset_launches()
    got, _ = prog(tok, cur)
    torch.cuda.synchronize()
    replay_l = _nonzero(ops.launches)
    after = [c.clone() for c in leaves(eng.caches)]
    with torch.inference_mode():
        for c, s in zip(leaves(eng.caches), snap):
            c.copy_(s)
    ops.reset_launches()
    want, _ = prog.eager(tok, cur)
    torch.cuda.synchronize()
    eager_l = _nonzero(ops.launches)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"{label}: the decode step's replay "
                                  f"differs from its eager run (max |diff| "
                                  f"{err:.3g})")
    check(all(torch.equal(a, c) for a, c in zip(after, leaves(eng.caches))),
          f"{label}: the replay's caches differ from the eager step's")
    check(replay_l == eager_l == recorded,
          f"{label}: a replay launched {replay_l}, the eager step {eager_l}, "
          f"the capture recorded {recorded}")
    del snap, after
    ms = {"eager": _host_ms(lambda: prog.eager(tok, cur), 10),
          "replay": _host_ms(lambda: prog(tok, cur), 10)}
    res = {"tokens_equal": True, "launches_a_step": replay_l,
           "decode_step_ms": ms,
           "engine_s": {"eager": stats_e["engine_s"],
                        "graphs": stats["engine_s"]},
           "tok_s": {"eager": stats_e["throughput_tok_s"],
                     "graphs": stats["throughput_tok_s"]}}
    log(f"programs {label}: the engine's tokens through its graphs equal its "
        f"eager steps' ({len(prompts)} requests, 4 slots); a decode step's "
        f"replay equals its eager run bit for bit (logits, caches), "
        f"{json.dumps(replay_l)} launches each; a decode step "
        f"{ms['eager']:.3f} ms eager, {ms['replay']:.3f} ms replayed; the "
        f"engine {stats_e['engine_s']:.3f} s eager, {stats['engine_s']:.3f} "
        f"s with graphs (host clock, synchronised)")
    del eng
    gc.collect()
    return outs, stats, res


def _replayed(decode):
    """``decode`` (a ``_decode_call`` closure) as a program: its logits."""
    from repro_torch.core.programs import Program

    prog = Program(lambda: decode()[0], "cuda", name="decode")
    prog()
    prog()
    return prog


def _now():
    from repro_torch.obs import timer

    return timer.now()


# ---------------------------------------------------------------------------
# phase 28: the training steps and the stage programs as CUDA graphs
# ---------------------------------------------------------------------------

#: replayed launcher steps of (b), after the call that warms up and
#: captures, held against as many eager steps from the same state
TRAIN_PROGRAM_REPLAYS = 3
#: (a): Table 1's two trainings at full width and full steps
QAT_PROGRAM_RUNS = (("kws", 150), ("ad", 120))


def _p50_p90(vals):
    import numpy as np

    return {"p50_ms": float(np.percentile(vals, 50)),
            "p90_ms": float(np.percentile(vals, 90))}


def _device_idle(fn):
    """(device kernels, busy ms, span ms, idle share) of one call of
    ``fn`` from a ``torch.profiler`` trace of the card's activity alone
    (no host events, so the trace costs the host little): the busy time
    is the union of the kernels' intervals, the idle share the rest of
    the span from the first kernel's start to the last one's end. None
    when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, span = _busy_us(spans)
    return {"kernels": len(spans), "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "idle_share": 1 - busy / span}


def _qat_run(name, steps, graphed):
    """One QAT run of Table 1's ``name`` at full width through
    ``codesign.tiny_adam``'s program (``graphed``) or its eager function,
    from the seeded initial parameters on the same batches, each step
    synchronised on the host clock. Returns (the run's readings, the
    program, its state, the first batch)."""
    import torch
    from repro_torch.bench import table1_models as t1
    from repro_torch.core import codesign
    from repro_torch.core.qir import full_fp32
    from repro_torch.kernels import ops

    if name == "kws":
        model = t1.KWSMLP()
        loss_fn, batches, _ = t1.kws_problem(steps, "cuda", model)
    else:
        model = t1.ADAutoencoder()
        loss_fn, batches = t1.ad_problem(
            steps, "cuda", model,
            t1.SyntheticMelWindows(dim=model.in_dim, seed=0))
    net = model.init(torch.Generator().manual_seed(0)).to("cuda")
    prog, state = codesign.tiny_adam(loss_fn, net, lr=2e-3)
    step = prog if graphed else prog.eager
    losses, ms = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    with full_fp32():
        for t in range(steps):
            t0 = _now()
            state, loss = step(state, batches[t])
            torch.cuda.synchronize()
            ms.append((_now() - t0) * 1e3)
            losses.append(loss)
    run = {"losses": [float(v) for v in torch.stack(losses).cpu()],
           "params": [t.detach().clone() for t in state[0]],
           "counter": int(state[3]), "first_step_ms": ms[0],
           "step_ms": _p50_p90(ms[1:]), "launches": _nonzero(ops.launches),
           "graphs": len(prog)}
    return run, prog, state, batches[0]


def _qat_programs(smi):
    """(a) KWS and AD QAT at full width and steps, eagerly and through the
    step program from the same initial parameters and batches: every loss
    and parameter bit for bit; host ms a step (synchronised), the device
    kernels of one step eagerly and by replay and the replay's busy ms
    and idle share (``torch.profiler``)."""
    import torch
    from repro_torch.core.qir import full_fp32

    out = {}
    for name, steps in QAT_PROGRAM_RUNS:
        eager, prog_e, state_e, b0 = _qat_run(name, steps, False)
        graph, prog, state, _ = _qat_run(name, steps, True)
        check(graph["losses"] == eager["losses"],
              f"qat {name}: the replayed losses differ from the eager run's "
              f"at steps {[i for i, (a, b) in enumerate(zip(graph['losses'], eager['losses'])) if a != b][:5]}")
        check(all(torch.equal(a, b) for a, b in zip(graph["params"],
                                                     eager["params"]))
              and graph["counter"] == eager["counter"] == steps,
              f"qat {name}: the replayed run's parameters differ from the "
              f"eager run's")
        check(graph["graphs"] == 1 and eager["graphs"] == 0,
              f"qat {name}: {graph['graphs']} graphs")
        with full_fp32():
            prof_e = _device_idle(lambda: prog_e.eager(state_e, b0))
            prof_r = _device_idle(lambda: prog(state, b0))
        check(prof_e is not None and prof_r is not None,
              f"qat {name}: the profiler saw no device work")
        out[name] = r = {
            "steps": steps, "losses_first_last": [eager["losses"][0],
                                                  eager["losses"][-1]],
            "eager_step_ms": eager["step_ms"],
            "replay_step_ms": graph["step_ms"],
            "capture_step_ms": graph["first_step_ms"],
            "kernels_a_step": {"eager": prof_e["kernels"],
                               "replay": prof_r["kernels"]},
            "busy_ms": {"eager": prof_e["busy_ms"],
                        "replay": prof_r["busy_ms"]},
            "idle_share": {"eager": prof_e["idle_share"],
                           "replay": prof_r["idle_share"]},
            "wrapper_launches": graph["launches"]}
        log(f"train programs (a) qat {name} ({steps} steps, full width; "
            f"{smi}): replayed losses and parameters equal the eager run's "
            f"bit for bit (loss {eager['losses'][0]:.6f} -> "
            f"{eager['losses'][-1]:.6f}); host ms a step eager p50 "
            f"{eager['step_ms']['p50_ms']:.6f} / p90 "
            f"{eager['step_ms']['p90_ms']:.6f}, replayed p50 "
            f"{graph['step_ms']['p50_ms']:.6f} / p90 "
            f"{graph['step_ms']['p90_ms']:.6f} (the capturing first step "
            f"{graph['first_step_ms']:.3f}); device kernels a step "
            f"{prof_e['kernels']} eager / {prof_r['kernels']} replayed; "
            f"busy {prof_e['busy_ms']:.6f} / {prof_r['busy_ms']:.6f} ms, "
            f"idle share {prof_e['idle_share']:.1%} / "
            f"{prof_r['idle_share']:.1%} (torch.profiler, the card's "
            f"activity, one step)")
        del prog, prog_e, state, state_e
        gc.collect()
    torch.cuda.empty_cache()
    return out


def _catch_k6_forward(caught):
    """Keep the first K6 forward launch's inputs in ``caught`` (the
    launch goes through as it is); returns the restorer."""
    from repro_torch.kernels import ops

    real = ops._flash_forward

    def fwd(q, k, v, causal, window, q_offset, kv_len, want_lse):
        if "fwd" not in caught:
            caught["fwd"] = tuple(t.detach().clone() for t in (q, k, v)) + (
                dict(causal=causal, window=window, q_offset=q_offset,
                     kv_len=kv_len),)
        return real(q, k, v, causal, window, q_offset, kv_len, want_lse)

    ops._flash_forward = fwd
    return lambda: setattr(ops, "_flash_forward", real)


def _launcher_graph_vs_eager(smi):
    """(b) Full-width internlm2-1.8b (phase 19 (a)'s config: bf16, 4 x
    4096 in 2 microbatches) under deterministic algorithms: ``1 +
    TRAIN_PROGRAM_REPLAYS`` eager steps, then the same steps from the same
    seeded state through ``StepProgram`` (the first call warms up and
    captures, the rest replay); losses, metrics, parameters, m, v and the
    counter equal bit for bit, each replay launches the eager step's K6
    and K6-backward counts; step ms, peak memory, and one more step of
    each under ``torch.profiler``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.programs import StepProgram
    from repro_torch.core.pytree import leaves
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = get_config(TRAIN_CONFIG)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ, seed=SEED)
    n = 1 + TRAIN_PROGRAM_REPLAYS
    batches = [data.batch(i, TRAIN_BATCH) for i in range(n + 1)]
    runs = {}
    caught = {}
    for mode in ("eager", "graph"):
        opt = make_optimizer(base_lr=3e-4, warmup=2, total=TRAIN_STEPS)
        model, state = _train_state(cfg, SEED + 8, opt)
        step = make_train_step(model, opt, microbatches=TRAIN_MICROBATCHES)
        prog = StepProgram(step, "cuda", name="train_step")
        call = prog.eager if mode == "eager" else prog
        restore = _catch_k6_forward(caught) if mode == "eager" else None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, ms, launches = [], [], []
        try:
            for i in range(n):
                ops.reset_launches()
                t0 = _now()
                state, met = call(state, batches[i])
                torch.cuda.synchronize()
                ms.append((_now() - t0) * 1e3)
                launches.append({k: ops.launches[k] for k in (
                    "flash_attention", "flash_attention_bwd")})
                metrics.append({k: float(v) for k, v in met.items()})
        finally:
            if restore is not None:
                restore()
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        if mode == "eager":
            host = [t.detach().to("cpu", copy=True) for t in leaves(state)]
            bad = []
        else:           # leaf by leaf: one copy of the state on the host
            bad = [i for i, (t, h) in enumerate(zip(leaves(state), host))
                   if not torch.equal(t.detach().cpu(), h)]
        prof = _device_idle(lambda: call(state, batches[n]))
        check(prof is not None, f"train programs (b) {mode}: the profiler "
                                f"saw no device work")
        runs[mode] = {"metrics": metrics, "step_ms": ms, "launches": launches,
                      "peak_bytes": peak, "reserved_bytes": reserved,
                      "bad_leaves": bad, "graphs": len(prog),
                      "profile": prof}
        del state, model, prog, call, step
        gc.collect()
        torch.cuda.empty_cache()
    e, g = runs["eager"], runs["graph"]
    check(g["metrics"] == e["metrics"],
          f"train programs (b): the program's metrics {g['metrics']} differ "
          f"from the eager steps' {e['metrics']}")
    check(not g["bad_leaves"],
          f"train programs (b): the program's state differs from the eager "
          f"steps' at leaves {g['bad_leaves'][:5]} of {len(host)}")
    check(g["graphs"] == 1, f"train programs (b): {g['graphs']} graphs")
    check(all(r == e["launches"][0] for r in g["launches"][1:])
          and all(r == e["launches"][0] for r in e["launches"])
          and g["launches"][0] == e["launches"][0]
          and e["launches"][0]["flash_attention_bwd"] > 0,
          f"train programs (b): K6 / K6-backward launches a step eager "
          f"{e['launches']}, the program (capture, replays) {g['launches']}")
    replays = {k: sum(r[k] for r in g["launches"][1:])
               for k in ("flash_attention", "flash_attention_bwd")}
    out = {"eager_step_ms": e["step_ms"], "graph_step_ms": g["step_ms"],
           "losses": [m["loss"] for m in e["metrics"]],
           "launches_a_step": e["launches"][0], "replay_launches": replays,
           "peak_bytes": {"eager": e["peak_bytes"], "graph": g["peak_bytes"]},
           "reserved_bytes": {"eager": e["reserved_bytes"],
                              "graph": g["reserved_bytes"]},
           "profile": {"eager": e["profile"], "graph": g["profile"]},
           "state_leaves": len(host)}
    del runs, e, g, host
    q, k, v, kw = caught.pop("fwd")
    torch.use_deterministic_algorithms(False)    # the yardsticks
    try:
        out["k6_row"] = time_case(flash_case(
            "train layer 0 (phase 28)", q, k, v, kw, model=TRAIN_CONFIG),
            reps=5, inner=10)
    finally:
        torch.use_deterministic_algorithms(True)
    return out


def _train_programs_child(smi):
    """Phase 28's (a) and (d), then (b) under deterministic algorithms
    (the caller set ``CUBLAS_WORKSPACE_CONFIG`` before CUDA started), in
    this process; the result is JSON."""
    import torch

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == CUBLAS_DETERMINISTIC,
          "deterministic cuBLAS needs CUBLAS_WORKSPACE_CONFIG set before "
          "CUDA initialises")
    out = {"qat": _qat_programs(smi),
           "stages": _stage_programs(load_models(), smi)}
    torch.use_deterministic_algorithms(True)
    out["launcher"] = _launcher_graph_vs_eager(smi)
    return out


def _train_programs_in_child(smi):
    """Phase 28 in a child process of this script (its environment sets
    ``CUBLAS_WORKSPACE_CONFIG``; the graphs' pools and cached blocks stay
    out of this process, whose later phases and ranks need the card);
    its log lines are passed on, its result comes back as JSON on its
    last line."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    code = (f"import json, sys\nsys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
            f"import chip_smoke\n"
            f"res = chip_smoke._train_programs_child({smi!r})\n"
            f"print(json.dumps(res))\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_DETERMINISTIC)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    check(r.returncode == 0 and lines, f"the train programs' child failed "
                                       f"(exit {r.returncode}): "
                                       f"{r.stderr[-4000:]}")
    return json.loads(lines[-1])


def _stage_programs(models, smi):
    """(d) The four Table-1 models at full width in both dispatch modes:
    ``stage_outputs`` and ``streaming_host`` (the default micro-batch)
    through the stage programs equal the same calls through each stage's
    eager function bit for bit, with the same launches; ``stage_latencies``
    eagerly and by replay."""
    import torch
    from repro_torch.deploy import compile_graph
    from repro_torch.kernels import ops

    out = {}
    for name, g, s, x in models:
        for mode, mega in MODES:
            label = f"{name}/{mode}"
            cm = compile_graph(g, in_scale=s, device="cuda", megakernel=mega)
            real = cm._stage_fn
            got = {}
            for how in ("eager", "graph"):
                if how == "eager":
                    cm._stage_fn = lambda i, real=real: real(i).eager
                else:               # the captures; the replays are held
                    cm.stage_outputs(x)
                    cm.streaming_host(x)
                torch.cuda.synchronize()
                ops.reset_launches()
                outs = cm.stage_outputs(x)
                torch.cuda.synchronize()
                launched = _nonzero(ops.launches)
                y, _ = cm.streaming_host(x)
                rows = cm.stage_latencies(x[:1])
                got[how] = (outs, launched, y, rows)
                if how == "eager":
                    del cm._stage_fn
            (eo, el, ey, er), (go, gl, gy, gr) = got["eager"], got["graph"]
            check(len(go) == len(eo) and all(torch.equal(a, b)
                                             for a, b in zip(go, eo)),
                  f"stage programs {label}: stage_outputs through the stage "
                  f"programs differ from the eager stages")
            check(torch.equal(gy, ey) and torch.equal(gy, cm.offline(x)),
                  f"stage programs {label}: streaming_host through the stage "
                  f"programs differs from the eager stages or offline")
            check(gl == el and gl, f"stage programs {label}: launches {gl} "
                                   f"by the programs, {el} eagerly")
            graphs = {p.name: len(p) for p in cm.programs()
                      if p.name.startswith("stage")}
            check(len(graphs) == len(cm.schedule.stages)
                  and all(graphs.values()),
                  f"stage programs {label}: graphs {graphs}")
            out[label] = r = {
                "stages": len(go), "launches": gl, "graphs": graphs,
                "stage_ms": {row["stage"]: [er_["ms"], row["ms"]]
                             for er_, row in zip(er, gr)}}
            log(f"train programs (d) stage programs {label}: stage_outputs "
                f"({BATCH} rows) and streaming_host (micro-batch "
                f"{cm.default_micro_batch}) through the stage programs equal "
                f"the eager stages bit for bit, launches {json.dumps(gl)}; "
                f"stage_latencies at 1 row, ms eager / replayed "
                f"{json.dumps({k: [round(a, 6), round(b, 6)] for k, (a, b) in r['stage_ms'].items()})} "
                f"(host clock, synchronised; {smi})")
            for prog in cm.programs():
                prog.clear()
            del cm, real, got
            gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_programs(smi, k6_bwd_row):
    """Phase 28 (module docstring), in a child process. Returns (the K6
    and K6-backward launches of (b)'s replays, their timing rows,
    details)."""
    t0 = _now()
    out = _train_programs_in_child(smi)
    out["phase_s"] = _now() - t0
    child = out["launcher"]
    replays = child["replay_launches"]
    k6_row = dict(child["k6_row"], launches=replays["flash_attention"])
    bwd_row = dict(k6_bwd_row, launches=replays["flash_attention_bwd"],
                   stage="train layer 0 (phase 28 replays)")
    e, g = child["eager_step_ms"], child["graph_step_ms"]
    gib = {k: v / 2**30 for k, v in child["peak_bytes"].items()}
    prof = child["profile"]
    log(f"train programs (b) {TRAIN_CONFIG} full width, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_MICROBATCHES} microbatches, deterministic "
        f"algorithms ({smi}): {TRAIN_PROGRAM_REPLAYS} replayed steps after "
        f"the capturing call equal the eager steps bit for bit (losses "
        f"{child['losses']}, metrics, {child['state_leaves']} state leaves: "
        f"parameters, m, v, the counter); step ms eager "
        f"{[round(v, 3) for v in e]}, program (warm-up and capture, then "
        f"replays) {[round(v, 3) for v in g]}; idle share of one step "
        f"{prof['eager']['idle_share']:.1%} eager / "
        f"{prof['graph']['idle_share']:.1%} replayed (busy "
        f"{prof['eager']['busy_ms']:.3f} / {prof['graph']['busy_ms']:.3f} ms,"
        f" {prof['eager']['kernels']} / {prof['graph']['kernels']} device "
        f"kernels); peak memory {gib['eager']:.3f} GiB eager, "
        f"{gib['graph']:.3f} GiB with the graph; K6 / K6 backward a step "
        f"{json.dumps(child['launches_a_step'])} eagerly and by each "
        f"replay; (c) is phase 19 (b) and (d), every run through a step "
        f"program; phase 28 {out['phase_s']:.3f} s")
    return replays, [k6_row, bwd_row], out


_CLOCK = []


def _clock(label):
    """Log the wall seconds since the previous phase ended (the first
    call: since the script's timer started)."""
    now = _now()
    if _CLOCK:
        log(f"phase wall time: {label} {now - _CLOCK[-1]:.3f} s "
            f"(script {now - _CLOCK[0]:.3f} s)")
    _CLOCK.append(now)


def kernels_line(rows, launches, worst):
    """One entry per kernel. ``launches`` is the counted main-path run of
    the kernel's path: one offline call of each of the four models in each
    of the two modes (K1-K3, the float head), one full-width llama3-8b
    prefill and phase 20's jamba, qwen2-vl and hubert prefills (K6), the
    kernel bench's checking pass and phase 21's int8 prefill (K5); the
    times and the bound are summed over the same launches (each main-path
    case weighted by its launches in that run, which must add up to the
    count); ``max_abs_err`` is the kernel's own worst |kernel - plain|
    over every check."""
    out = []
    for name, (source, replaces) in REPLACES.items():
        mine = [r for r in rows if r["kernel"] == name]
        check(sum(r["launches"] for r in mine) == launches[name],
              f"{name}: timed cases cover {sum(r['launches'] for r in mine)}"
              f" launches of the {launches[name]} counted")
        total = lambda k: sum(r[k] * r["launches"] for r in mine)  # noqa
        nbytes, nops = total("bytes"), total("ops")
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": bound_by(nbytes, nops, PEAK_OPS_PER_S[name]),
            "library_ms": total("library_ms"),
        })
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.obs import timer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    try:
        t0 = timer.now()
        _clock("start")
        libs = _build.build_all()
        _clock("build_all")
        log(f"build: {len(libs)} kernels in {timer.now() - t0:.3f} s: "
            f"{[os.path.basename(str(p)) for p in libs]}")
        imma = phase_int8_sass()
        _clock("phase_int8_sass")
        worst_syn = phase_kernels_synthetic()
        _clock("phase_kernels_synthetic")
        models = load_models()
        _clock("load_models")
        results, launches, per_run = phase_main_path(models)
        _clock("phase_main_path")
        cases, worst_main, nonzero = phase_main_path_checks(models, results)
        _clock("phase_main_path_checks")
        phase_goldens()
        _clock("phase_goldens")
        bitwise = phase_streaming(models, results)
        _clock("phase_streaming")
        rows, e2e = phase_times(cases, results, models)
        _clock("phase_times")
        k3_active = phase_k3_occupancy()
        _clock("phase_k3_occupancy")
        k1_tiles = phase_k1_tile_times(cases)
        _clock("phase_k1_tile_times")
        split = phase_k12_split(cases)
        _clock("phase_k12_split")
        del cases        # their inputs: the LM phases and ranks need room
        wide, worst_wide = phase_full_width()
        _clock("phase_full_width")
        worst_flash = phase_flash_synthetic()
        _clock("phase_flash_synthetic")
        lm_launches, worst_lm, k6_case, lm = phase_lm_prefill()
        _clock("phase_lm_prefill")
        k6_row, lm["k6"] = phase_k6_times(k6_case)
        _clock("phase_k6_times")
        k6_rows = [k6_row]
        del k6_case
        lm["depth_cut_max_diff"] = phase_lm_depth_cut()
        _clock("phase_lm_depth_cut")
        lm["serving"] = phase_lm_serving()
        _clock("phase_lm_serving")
        k5_int8, worst_int8, int8_rows, lm["int8"] = phase_int8_serve(
            smi, lm["decode_ms_per_step"])
        _clock("phase_int8_serve")
        worst_k45, k5_big = phase_k4_k5()
        _clock("phase_k4_k5")
        worst_tiles = phase_k1_tiles()
        _clock("phase_k1_tiles")
        bench_launches, bench_rows, worst_bench, bench = phase_kernel_bench()
        _clock("phase_kernel_bench")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                prefix="autotune-", dir=os.path.join(ROOT, "build")) as c1, \
                tempfile.TemporaryDirectory(
                    prefix="autotune-", dir=os.path.join(ROOT, "build")) as c2, \
                tempfile.TemporaryDirectory(
                    prefix="autotune-", dir=os.path.join(ROOT, "build")) as c3:
            tuned, autotune_agree = phase_autotune(models, (c1, c2, c3))
        _clock("phase_autotune")
        trace = phase_trace_export(tuned, models[0][3], smi)
        _clock("phase_trace_export")
        scenarios = phase_scenarios(models, tuned, smi)
        _clock("phase_scenarios")
        serving = phase_serving(models, tuned, smi)
        _clock("phase_serving")
        programs = phase_programs(models, tuned, smi)
        _clock("phase_programs")
        # the tiny models' graphs (their pools take GBs at 1024 rows) go
        # before the LM phases, which need the card's memory
        _drop_graphs([cm for cm, _, _ in results.values()]
                     + list(tuned.values()))
        qat = phase_qat(smi, nonzero)
        _clock("phase_qat")
        papers = phase_paper_benches(smi)
        _clock("phase_paper_benches")
        train_launches, worst_train, k6_bwd_row, lm["train"] = \
            phase_lm_train(smi)
        _clock("phase_lm_train")
        prog_launches, prog_rows, train_programs = phase_train_programs(
            smi, k6_bwd_row)
        _clock("phase_train_programs")
        fam_k6, worst_fam, fam_rows, lm["families"] = phase_families(smi)
        _clock("phase_families")
        k6_rows += fam_rows
        mesh = phase_mesh(smi)
        _clock("phase_mesh")
        dryrun = phase_dryrun(smi)
        _clock("phase_dryrun")
        spmd_launches, worst_spmd, spmd_rows, spmd = phase_spmd(smi)
        _clock("phase_spmd")
        spmd2_launches, worst_spmd2, spmd2_rows, spmd2 = \
            phase_spmd_inference(smi, dryrun)
        _clock("phase_spmd_inference")
        seqpar_ep = phase_seqpar_ep(smi, spmd, spmd2)
        _clock("phase_seqpar_ep")
        lm["profile"] = phase_lm_profile()
        _clock("phase_lm_profile")
        lm["families"]["profile"] = phase_family_profile()
        _clock("phase_family_profile")
        lm["int8"]["profile"] = phase_int8_profile()
        _clock("phase_int8_profile")
        jamba = lm["families"][JAMBA_CONFIG]
        log(f"lm summary ({smi}): prefill {lm['prefill_ms']:.3f} ms "
            f"(B=1, S={LM_SEQ}, bf16), decode {lm['decode_ms_per_step']:.3f}"
            f" ms per step (batch 4, bf16), engine "
            f"{lm['serving']['throughput_tok_s']:.3f} tokens/s (float32, "
            f"4 slots); {JAMBA_CONFIG} ({JAMBA_LAYERS} layers, bf16) prefill "
            f"{jamba['prefill_ms']:.3f} ms, engine "
            f"{jamba['serving']['throughput_tok_s']:.3f} tokens/s; int8 "
            f"prefill {lm['int8']['host_ms']['prefill_int8']} ms, decode "
            f"{lm['int8']['host_ms']['decode_int8']} ms, engine "
            f"{lm['int8']['engine_int8']['throughput_tok_s']:.3f} tokens/s "
            f"(bf16 {lm['int8']['engine_bf16']['throughput_tok_s']:.3f}), "
            f"K5 {lm['int8']['prefill_k5_ms']:.3f} ms of a prefill")
        worst = {k: max(worst_syn[k], worst_main[k], worst_wide[k])
                 for k in TINY_KERNELS}
        worst["threshold_matmul"] = max(worst["threshold_matmul"],
                                        worst_tiles)
        worst[HEAD_KERNEL] = worst_main[HEAD_KERNEL]
        worst["flash_attention"] = max(worst_lm, worst_fam,
                                       worst_spmd["flash_attention"],
                                       worst_spmd2["flash_attention"],
                                       *worst_flash.values())
        worst["flash_attention_bwd"] = max(
            worst_train, worst_spmd["flash_attention_bwd"])
        for k in BENCH_KERNELS:
            worst[k] = max(worst_k45[k], worst_bench[k])
        worst["qmatmul"] = max(worst["qmatmul"], worst_int8,
                               worst_spmd2["qmatmul"])
        launches = {**{k: launches[k] for k in TINY_KERNELS + (HEAD_KERNEL,)},
                    "flash_attention": lm_launches["flash_attention"]
                    + fam_k6,
                    **{k: train_launches[k] for k in TRAIN_KERNELS},
                    **{k: bench_launches[k] for k in BENCH_KERNELS}}
        launches["qmatmul"] += k5_int8
        for k, n in list(spmd_launches.items()) + list(
                spmd2_launches.items()) + list(prog_launches.items()):
            launches[k] += n
        line = kernels_line(rows + k6_rows + bench_rows + [k6_bwd_row]
                            + int8_rows + spmd_rows + spmd2_rows + prog_rows,
                            launches, worst)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError,
            TypeError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "chip_smoke_details.json"), "w") as f:
        json.dump({"card": smi, "per_shape": rows, "full_width": wide,
                   "e2e_offline_ms": e2e,
                   "launches_per_offline": per_run,
                   "main_path_launches": launches,
                   "streaming_logits_bit_for_bit": bitwise,
                   "flash_attention": {"max_err_by_dtype": worst_flash,
                                       "main_path_shape": k6_rows},
                   "lm": lm, "kernel_bench": bench,
                   "scenarios": scenarios, "serving": serving, "qat": qat,
                   "paper_benches": papers, "mesh": mesh,
                   "dryrun": dryrun, "spmd": spmd,
                   "spmd_inference": spmd2, "seqpar_ep": seqpar_ep,
                   "programs": programs, "train_programs": train_programs,
                   "autotune_agreement": autotune_agree,
                   "trace_export": {"path": trace[0], "bytes": trace[1]},
                   "k12": {"imma": imma, "k1_tiles": k1_tiles,
                           "split": split},
                   "k5_big": k5_big, "k3_active_clusters": k3_active,
                   "kernels": line},
                  f, indent=1)
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spmd-worker"]:
        sys.exit(_spmd_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--spmd-inference-worker"]:
        sys.exit(_spmd2_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mamba-gap-worker"]:
        sys.exit(_mamba_gap_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mamba-gap"]:
        sys.exit(mamba_gap())
    sys.exit(main())
