#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card, the CUDA toolkit
(nvcc) and PyTorch built for CUDA.  It imports nothing of JAX and nothing of
the JAX package ``repro``.  Phases, each fatal on failure (exit 1, no result
line):

1. Print the python, torch and CUDA versions, the card, and the card's name
   and power limit as nvidia-smi reports them.
2. Build the eight kernel sources (``src/repro_torch/csrc/``: the scorer,
   the assembly tile, flash attention and its backward, the expert GEMM,
   WKV6 and its backward, and the RG-LRU scan with its backward) from the
   checkout's sources into ``build/``,
   one nvcc each, in parallel, and print the build seconds and ptxas's
   report; fail if ptxas spills registers in any kernel.
3. Hold the scorer's two kernels against their plain torch versions on
   the card.  The full tile: float64 and float32, E in {1, 8, 64}, A, B in
   {1, 13, 16, 128}, random masks, exact equality (``torch.equal``), the
   masked tail (0 / +inf) and NaN propagation.  The fused pair kernel (the
   shortlisted pairs, the work combine and eq. 9's feasibility, (3, P)
   float64 out), bit for bit (NaN as NaN): float64 and float32 (float32
   planes, float64 combine), E in {1, 8, 64}, (A, B) in {(1, 1), (13, 13),
   (5, 128), (128, 128)}, P in {1, 32, A*B} an event, events with an empty
   shortlist inside a batch, pairs in the masked tail, NaN lanes, speeds
   other than 1, ``memory_constraint`` on and off.  The window kernel
   (``ccm_scorer_spec_f64``: a captured lock event a row, flow matrix to
   selection) bit for bit, with its flow matrix in shared memory and in
   global scratch: rows of ``scaling_phase(256)``'s first lock events in
   windows of 1 to 64 rows, mixed edge buckets, a pair count of 0, every
   pair infeasible, a tied maximum (the first wins), ``max_candidates=40``
   (lanes 64: F in shared memory past 48 KB) and ``max_candidates=70``
   (lanes 128: global scratch only); the scatter's adversarial rows
   (``spec_cases.scatter_cases``: one bin, distinct bins, a bin across
   the 32- and 256-edge borders, eb 512, 1024 and 2048, all pads,
   volumes whose order matters); random rows of an odd length (lanes 5 and 8, also
   through the launcher's padded staging stride) and of 64 and 300 pair
   slots.
4. Drive the main path, ``ccm_lb`` with ``n_iter=4, k_rounds=2,
   fanout=4`` on ``device="cuda"``: ``scaling_phase(256)`` (256 ranks, 6400
   tasks, 12,799 comm edges) in float64 solo, float64 with
   ``batch_lock_events=8`` and float32 with ``batch_lock_events=8``, and a
   memory-binding phase (the same shape with a 2.4e8-byte cap) in float64
   solo.  Each run is held against the port's own ``device="cpu"`` run
   (identical assignment, transfer log, transfers and max_work), and its
   pair-kernel launches (counted from zero just before the run, read just
   after) must equal its scorer calls and be more than zero, with no
   full-tile launch.  A 16-rank run is also held against the port's scalar
   reference path (``use_engine=False``), which never calls the scorer.
   The launched (E, A, B) and (E, A, B, P) shapes are recorded, and each
   run's scorer seconds with their split (pack, h2d, launch, d2h,
   combine).  Then the speculative driver on the same phase
   (``spec_window=8`` and 32 scan/disjoint, 8 vmap/greedy), each run
   identical to f64 solo's CPU run, with window-kernel launches equal to
   the windows that scored a row and no pair or full-tile launch; and
   ``ccm_lb_many`` of the JAX package's fleet benchmark (cut to 16
   instances of a 16-rank, 400-task phase, window 16, vmap), each instance
   identical to its solo run on the card's host engine.  Wall and stage
   seconds,
   windows, rollbacks and the window launcher's split are printed.  Then
   ``ccm_lb_pipeline`` over the JAX package's pipeline benchmark (256
   ranks, cut to 2 phases of drifting loads, batch 8) on the CPU and on the
   card with ``reuse_csr``, with ``carry_engine``, and with
   ``carry_engine`` and ``spec_window=8``: each card run equal to the
   CPU's phase by phase, CSR reuse, warm starts and engine carry on every
   phase after the first, the pair (or
   window) kernel launched in every phase; per-phase seconds, transfers,
   launches and ``score``/``commit`` seconds are printed.  Last, the
   async balancer ``ccm_lb_async`` on ``scaling_phase(256)`` at latency 0
   (equal to the sync card run) and uniform(0.5, 1.5) (profiled for the
   device's idle share), on the benchmark's ``scaling_phase(64)`` at 0.5
   and uniform(0.5, 1.5) (equal to the CPU's run, event trace included;
   at 256 ranks the CPU's runs took 31.7 s of the smoke's wall), and the
   fault benchmark's 64-rank ``crash`` and
   ``crash_then_join`` (equal to the CPU's), each launching the pair
   kernel once a scorer call; walls, transfers, launches and
   ``FaultStats`` are printed.  Then the paper's Fig. 4a
   (``benchmarks/milp_vs_ccmlb.py``: ``random_phase(7, 4 ranks, 14 tasks,
   4 blocks, 16 comms)``, delta 1e-9, 1e-10, 1e-11 and 0): 12 CCM-LB seeds
   a delta on the card, each equal to the CPU's run, and the reduced FWMP
   solved by branch and bound (host numpy, a 100-node limit, 10 at delta
   0, whose solves reach any limit, a clock limit
   no solve reaches) without and with the card's best W_max as incumbent;
   a solve must end by optimality or the node limit, and a certified
   optimum must not lie above CCM-LB's best (status, objective, LP bound,
   nodes, seconds, CCM-LB's gap and increase are printed).  Last, the
   three planners on the card, each plan equal to the CPU's (the card's
   memory as the HBM budget): expert placement of
   ``benchmarks/expert_placement.py``'s qwen3-moe and llama4-scout at
   published width (zipf(1.4) counts over (4, E), 16 devices), one device
   at half speed, qwen with ``shards_per_expert=2, replicate=True``, a
   4-window drifting sequence synchronously and with ``spec_window=8``
   (window kernel, held to the synchronous plan), stage plans of three
   archs and one stage schedule (contiguous; they make no lock event, so
   no launch), and sequence packing of 256 costs on 8 ranks with and
   without a half-speed rank; pair launches per plan.
5. The paper's assembly application (section VI) on the card.  Hold the
   assembly-tile kernel (``src/repro_torch/csrc/assembly_tile.cu``) against
   its plain torch version: quad orders 4, 16, 64, 192; shapes (1, 1),
   (13, 7), (96, 96), (96, 160), (512, 512); random masks, coincident
   points in the square shapes; the direct distance to ``rtol=1e-5,
   atol=1e-4`` and ``mxu_distance`` to a relative error below 2e-2; block
   shapes (32, 64), (128, 128) and the application's 16 x 16 exactly
   equal; and the application's own launch (``execute.tile_kernel``) on
   real tasks of every quad order to ``rtol=1e-5, atol=1e-4``.  Then run
   the application at 8192 unknowns on 32 ranks: measure every task of the
   training configuration (4096 unknowns, 16 ranks) on the card, train the
   cost model on the card, and run the A/B/C comparison with measured
   durations and the trained model's predictions.  That run's placement
   (CCM-LB on the card) must equal the port's CPU placement from the same
   predictions, and homing is planned on both: both give the same plan, or
   both raise the same one of the reference's homing errors ("homing did
   not converge" is the reference's known fault, ROADMAP queue 3), which
   is then reported beside the A/B/C compute makespans.  Last, the
   analytic run on the card and on the CPU must agree exactly and
   reproduce the reference's counts.  Assembly-kernel launches, counted
   from zero before each measured run, must equal ``repeats * tasks +
   signatures``.
6. Serving ``qwen3-moe-30b-a3b`` on the card.  Hold the flash-attention
   kernel (``csrc/flash_attention.cu``) against its plain torch version in
   float32 (``atol=rtol=2e-5``) and bf16 (``2e-2``) on the cases of
   ``tests/test_kernels.py``, the serve shape (B 4, S 512, 32 / 4 heads,
   hd 128), a length that is no tile multiple, rows that see no key (exactly
   0), head dims 8 and 256, recurrentgemma-9b's local attention as served
   (B 4, S 2560, 16 query heads on one K/V head, hd 256, window 2048) and
   gemma2-27b's (S 4608, 32 query heads on 16, hd 128, window 4096,
   soft-cap 50), and phase 6c's served shapes: whisper-large-v3's encoder
   (B 4, 1500 frames, 20 heads of 64, non-causal) and cross-attention (64
   rows against the 1500 frames), gemma2's global layer (B 2, S 4608,
   causal, soft-cap 50) and llava-next-mistral-7b's (B 4, S 1664, 32 on 8
   heads, hd 128); in bf16 also against the plain model of its arithmetic,
   its walk over 64-key tiles with p = 2^(s - running max) rounded to bf16
   before p . v (``ref.reference_attention_bf16_tiles``; ``atol=4e-3``,
   ``rtol=2^-8`` beyond the model's slack, what a p within
   ``ref.P_SLACK`` (2^-20) of a bf16 rounding midpoint moves an output if
   the kernel rounds it the other way), and in float32 its block shapes against each other
   (``atol=1e-5``); hold the
   expert-GEMM kernel (``csrc/moe_gemm.cu``) against its plain version
   (``rtol=1e-5, atol=1e-4`` in float32, ``rtol=3e-2, atol=3e-1`` in bf16
   and, tighter, within one bf16 ulp: ``rtol=2^-7, atol=1e-3``) at the
   serve path's four shapes, ragged ones, and C = 1, 13 and 300.  Then
   serve: the model at its published width with its depth cut to 8 of 48
   layers, bf16 weights from the port's init (a seeded
   ``torch.Generator`` on the card), ``serve_batch`` with 4 requests of
   512-token prompts and 32 new tokens.  Launches, counted from zero just
   before the run, must be exactly 8 flash (one per layer, prefill) and
   3 x 8 x 33 = 792 expert GEMM (a prefill and 32 decode steps); prints the
   prefill (and three more prefills of the same batch, uncounted) and
   decode-step seconds, tokens/s, peak memory and, from
   ``torch.profiler`` over ``PROFILE_DECODE_STEPS`` (8) more decode steps
   after a prefill of the same batch, the device's idle share (with bounds that count the
   kernels the profiler left unrecorded).  Last,
   the weights' first 4 layers on the CPU against the card (TF32 off): a
   64-token
   prompt and 4 teacher-forced decode steps, each step's logits held to
   the serving contract (normalised log-probs within ``atol=0.07,
   rtol=0.05``, argmax equal), with the count of top-k router selections
   that differ, then again with the card's routing pinned to the CPU's.
   In float32 (the same weight values, widened) the contract must hold.
   In bf16 the discrete router turns the two devices' different last-bit
   rounding into a different expert for near-tied tokens, and the logits
   are bf16-spaced, so the contract is reported, and the run fails only
   on a difference that rounding does not explain: a router flip where
   the CPU's k-th and (k+1)-th logits lie further apart than twice the
   token's logit change, a pinned log-prob beyond the contract's
   tolerance, or a pinned argmax that differs where the CPU's top two
   logits lie further apart than twice the step's largest logit error.
   Then the expert re-placement loop on the served weights (the JAX
   package's ``launch/train.py::rebalance_experts``): one prefill of the
   served prompts through ``run_stack`` gives the router counts (8, 128),
   ``plan_expert_placement`` on 16 devices runs on the card (pair kernel),
   ``apply_expert_permutation`` moves every MoE layer's experts on the
   card, and the same prefill runs again, then once more with its
   routing pinned to the first run's: exactly 8 flash and 24 expert GEMM
   launches each, counts permuted (exactly on the first layer; on the
   others exactly or with every moved top-k selection at a near tie: the
   card's ``index_add_`` sums a token's expert outputs in another order
   once the slots move, so this check cannot catch a wrongly permuted
   later layer), the pinned run's logits within the serving contract
   against the first prefill's (an argmax may differ only at a near tie;
   this is what holds the permuted weights of layers 1 to 7), and the
   unpinned run's too unless selections moved; the unpermuted prefill
   repeated shows the card's own spread; imbalance before and after,
   transfers, the plan's seconds and the launches summed over the four
   prefills are printed.
7. Serving the recurrent LMs on the card.  Hold the WKV6 kernel
   (``csrc/wkv6.cu``) against its plain versions in float32 and bf16 (r,
   k, v; log_w and u float32): y against the sequential oracle and the
   chunked version at chunks 16, 32 and 64, the final state against the
   chunked version's (``atol=2e-4``, ``rtol=1e-5``; bf16 y ``rtol=2^-7``,
   one ulp), on ``tests/test_kernels.py``'s chunk-boundary and fast-decay
   cases (log_w -15 and the clip extreme -exp(8), where only the oracle
   holds y: the chunked form is inexact there), the serve shape (B 4, S
   512, H 64, hd 64) with the test's decay and the model's initial one, a
   ragged S and head dims 8 and 128; hold the RG-LRU kernel
   (``csrc/rglru.cu``) against its plain version (``atol=1e-4``,
   ``rtol=1e-5``; bf16 ``rtol=2^-7``; float32 its first segment bit for
   bit) on ``tests/test_kernels.py``'s cases, the serve shape (4, 2560,
   4096), the training shape (2, 2560, 4096), a 4-rank model axis's serve
   shape (4, 2560, 1024) and ragged S and W.  Then serve
   ``rwkv6-7b`` and ``recurrentgemma-9b`` at their published widths and
   full depths (7.58 G and 9.40 G parameters, bf16 weights from the port's
   init), each with ``serve_batch`` of 4 requests (512- and 2560-token
   prompts; the latter past the 2048-token local window) and 32 new
   tokens.  Launches, counted from zero just before the run, must be
   exactly 32 wkv6 (bf16), and 26 rglru (float32) and 12 flash (bf16),
   and nothing else; prints the prefill and decode-step seconds,
   tokens/s, peak memory and the device's idle share as for qwen.  Each
   model is freed before the next.  Last, each model's first layers (2 of
   rwkv6's, one period of 3 of recurrentgemma's) on the CPU against the
   card on the same weights, teacher-forced for 4 steps after a 100-token
   (rwkv6) or 2112-token (recurrentgemma, past the window) prompt; in bf16
   recurrentgemma's prompt is 64 tokens (bf16 products are slow on the
   CPU).  The serving contract must hold in float32 and in bf16, where an
   argmax may differ only at a near tie (the CPU's top two logits closer
   than twice the step's largest logit error).
6c. Serving the other families on the card, after phase 7, each model at
   its published width and full depth with bf16 weights from the port's
   init, freed before the next: ``gemma2-27b`` (46 layers, 27.23 G
   parameters) under its ring cache (``window_kv_cache``) on 2 x
   4608-token prompts, past the 4096-token window; ``whisper-large-v3``
   (32 + 32 layers) on 4 x 1500 encoder frames (random ``audio_embed``)
   and 64-token decoder prompts; ``llava-next-mistral-7b`` (32 layers) on
   4 x (1152 random ``media_embed`` positions + 512 text tokens); 32 new
   tokens each through ``serve_batch``.  Flash launches, counted from zero
   just before the run, must be exactly 46 (23 local, 23 global), 96 (32
   non-causal encoder, 32 causal self, 32 cross) and 32 a prefill, and
   nothing else; prints the prefill and decode-step seconds, tokens/s,
   peak memory and the device's idle share as for qwen.  Then gemma2's
   ring (4096 slots) against its full cache (4640 slots) at full depth on
   the served prompts, 32 teacher-forced steps: every row within the
   serving contract, an argmax differing only at a near tie; the two
   caches' K/V bytes are printed.  Last, the weights cut (gemma2 to one
   (local, global) period, whisper to 2 + 2 layers at the full 1500
   frames, llava to 2 layers at the full 1152 media positions) on the
   card in bf16 and in float32 against one float32 CPU run on the same
   values, 4 teacher-forced steps after a 64-token prompt: the serving
   contract, where in bf16 an argmax may differ only at a near tie.
7b. Training ``qwen3-moe-30b-a3b`` on the card.  Hold the flash backward
   kernel (``csrc/flash_attention_bwd.cu``, through ``ops.flash_attention``'s
   autograd function) against autograd through the plain version at every
   ``FLASH_BWD_CASES`` shape (``FLASH_CASES``, phase 6c's included:
   whisper's 1500-frame encoder and its cross-attention, gemma2's global
   layer, llava's S 1664; and recurrentgemma's local attention at hd 256
   as trained and cut), in float32 and bf16 (dq, dk, dv within 1e-4 and
   2e-2 of their largest |value|; where the backward runs on the tensor
   cores, bf16 at hd 64, 128 and 256, also within 2^-7 of the plain model of
   its rounding, twice bit for bit, with the forward's LSE instance giving
   the serve instance's output bit for bit), and the expert GEMM's
   backward (dX and dW, two launches: the TMA kernel's transpose-bit
   variants on the operands where they lie, the kernel on transposed
   copies for float32 and ragged shapes) against the plain autograd at
   the training shapes and the ragged ones (the forward's tolerances).
   Hold the WKV6 backward kernel (``csrc/wkv6_bwd.cu``, through
   ``ops.wkv6``'s autograd function) against the plain backward
   (``ref.wkv6_backward``) at the training shape (4, 512, 64, 64) with the
   test's decay and the model's initial one, a ragged S, hd 32 and 128 and
   the clip -exp(8), with and without a final-state gradient, in float32
   and bf16, and the RG-LRU backward (``csrc/rglru.cu``) against
   ``ref.rglru_backward`` at (2, 2560, 4096) and ragged S and W (its TMA
   ring where a row is a whole number of 16 bytes, its plain loads
   elsewhere): every gradient within 2e-5 of its largest |value| (bf16
   dr, dk, dv, db within 2^-7), dlog_w exactly 0 at the clip, two WKV6
   launches bit for bit, the RG-LRU's float32 gradients bit for bit its
   plain version's, and a planted fault (dlog_w shifted by a token,
   dlog_a by a step) caught; both timed at their training shapes against
   their plain versions and bounds.
   Then the same float32 weights of qwen cut to 1 layer on the card and
   the CPU: the loss and every gradient leaf of a 2 x 64-token batch
   (rtol 1e-4; gradients within 1e-3 of each leaf's largest |value|), and
   two AdamW steps' losses (rtol 1e-3).  Then ``launch.train.train_loop``
   at the published width, 4 of 48 layers (3.11 G parameters), 10 steps of 4
   x 512 tokens at lr 3e-4, a CCM-LB expert re-placement every 5 steps on
   16 expert ranks (the pair kernel in the plan; the experts and AdamW's
   moments permuted on the card).  Launches, counted from zero just before the run,
   must be 8 flash forward (forward and remat), 4 flash backward, 24
   expert GEMMs in the forward and 24 in the backward every step, all
   bf16, and some pair launches; the losses finite and the last below the
   first.  One more step runs under ``torch.profiler`` (device idle
   share, busy time by kernel).  (The restart from a checkpoint is held
   in phase 10, by ``train_moe_ccm``: a checkpoint of these 4 layers is
   31.1 GB, and the card hosts this script runs on end a run that writes
   more than 45 GiB to their disk.)  Prints the losses, seconds a step
   (median, min, max),
   tokens/s, peak memory, launches a step, each re-placement's imbalance
   and pair launches; then times both backwards at the training shapes
   against their plain versions' autograd, SDPA's and ``torch.bmm``'s
   backward (timed only) and their bounds, and the expert GEMM's backward
   also as the parent commit ran it (its transposed copies and its
   launches, each alone).
7c. The device mesh.  (a) ``torch.distributed`` over NCCL at world size 1
   and ``launch.mesh.make_local_mesh(1, 1)``: ``qwen3-moe-30b-a3b`` served
   (8 of 48 layers, the serve cell's 4 x 512-token prompts, 32 new tokens)
   and trained (4 layers, 3 steps of 4 x 512 tokens) through the mesh
   entry points (``build_model(mesh=...)``, ``serve_batch``,
   ``train_loop(mesh=...)``), each against the same run without a mesh
   under ``torch.use_deterministic_algorithms``: every prefill and decode
   logit, every loss and every parameter after the steps equal bit for
   bit; launches counted from zero just before each run (flash, the
   expert GEMM and both backwards, per step).  (b) Every model rank's
   expert-parallel body (``models.moe.local_moe`` at ``model_rank`` m of
   M = 4 and 16) on its E / M experts of the served model's first MoE
   layer, at full width over 4 x 512 tokens, with the expert GEMM kernel:
   the ranks' outputs (float32) summed by hand held to the unsharded
   layer at float32 summation order (atol 1e-5 + rtol 1e-6: each rank's
   GEMMs are the whole layer's), every rank's counts equal to the
   unsharded counts; two planted faults must fail that limit (a rank's
   share dropped, and a rank's body run at another rank's expert
   offset); and a slot permutation of a CCM-LB plan on M ranks
   (and a reversal, which crosses every rank), applied rank by rank
   (``launch.train.take_slots`` on the gathered leaf) equal to the
   one-device permutation.  (c) ``launch.dryrun`` on the ``h100`` mesh
   (host only, ``meta`` tensors) in ``DRYRUN_JOBS`` subprocesses at once,
   each on its share of the configs, the served ones first, starting no
   cell after 60 s (those listed as not run); one line a cell (FLOPs,
   bytes, dominant term, per-device GB, fits in 80 GB) and the phase's
   seconds.  (d) Every model rank's tensor-parallel body on the card, one
   rank after another (``RankReplay``: a ``sharding.ModelAxis`` whose
   collectives are done by hand, the ranks run again until each
   collective has every rank's input): at published width in float32 (no
   TF32), 2 x 256 random tokens, for M = 2, 4 and 16 where the heads
   divide (whisper's 20: 2 and 4), qwen's attention and its vocabulary
   head's logits and loss (151936 entries), gemma2's local and global
   attention (soft-cap 50), MLP and tied head (256000), an rwkv6 time mix
   and channel mix, a recurrentgemma period (RG-LRU, MLP, RG-LRU, MLP,
   local attention, MLP), a whisper encoder layer (non-causal attention,
   MLP) and decoder layer (causal, cross, MLP), and llava's attention and
   MLP: the ranks' sum in rank order and the input gradient within
   ``TP_REL`` of the whole sub-layer's largest |value|, and two planted
   faults fail it (rank 1's share dropped; for attention, rank 1 at its
   head offset shifted by one head); each sub-layer's kernel (flash,
   WKV6, the RG-LRU scan) launched forward and backward at a rank's shape
   only, its launches counted; then flash, WKV6 and the RG-LRU scan timed
   at the M = 4 ranks' shapes of qwen's, rwkv6's and recurrentgemma's
   served batches (events and ``device_ms``, plain version, bound).
7d. Training the other families on the card, each at its published width
   in bf16 through ``launch.train.train_loop``, a warm-up step and 3
   measured steps, freed before the next: ``rwkv6-7b`` at 8 of 32 layers
   (4 x 512 tokens), ``recurrentgemma-9b`` at one period of 38 layers (2 x
   2560 tokens, past the 2048-token window), ``whisper-large-v3`` at full
   depth (4 x 1500 encoder frames, 187-token decoder) and
   ``llava-next-mistral-7b`` at 8 of 32 layers (4 x (1152 media positions
   + 512 tokens)).  Launches, counted from zero just before each run,
   must be exactly the remat's every step (``expected_train_launches``:
   wkv6 16 + 8; rglru 4 + 2 and flash 2 + 1; flash 192 + 96; flash 16 +
   8), all bf16 but the RG-LRU scan's (float32, the model's gates); the
   loss must fall over the measured steps.  Prints step seconds, tokens/s,
   peak memory, launches and one profiled step's idle share and busy time
   by kernel.  Each family's float32 card-vs-CPU check (``FAMILY_TRAINS``:
   rwkv6 1 layer, recurrentgemma one RG-LRU layer and its local
   attention on one request, whisper 2 + 2 layers at the full 1500
   frames, llava 2 layers at the full 1152 media positions) at qwen's
   limits.
10. The six examples of ``repro_torch.examples`` on the card, after phase
   8 and before the result lines, each example's launches counted from
   zero just before its card run.  ``quickstart`` runs on the CPU, then
   on the card: every result equal bit for bit (assignments, transfer
   logs, max-work traces, the MILP's status, objective and nodes);
   ``async_balancer`` and ``pipeline_phases`` on the card (their CPU runs
   were cut for the smoke's wall; phase 4c-4d holds their drivers to the
   CPU); pair launches equal to the scorer calls.
   ``assembly_e2e`` with analytic durations on the CPU and the card (A/B/C
   makespans, placement and homing equal, no tile launch), then as it
   goes, measured on the card: tile launches exactly ``repeats * tasks +
   signatures`` of its two configurations, the cost model trained on the
   card, pair launches equal to the scorer calls; its makespans and
   speedups are printed.  ``serve_batched`` on the four smoke configs in
   bf16 (launches summed over the four: one flash an attention layer and
   one WKV6 or RG-LRU scan a recurrent layer in each prefill, three expert
   GEMMs an MoE layer and forward), then, through its loop body
   ``serve_one``, ``tinyllama-1.1b``, ``llama3.2-3b`` and ``smollm-360m``
   at published width and full depth (4 x 512-token prompts, 32 new
   tokens, bf16 weights from a seeded generator on the card): exactly one
   flash launch a layer and nothing else, the same prompts served again
   with each prefill and decode step on CUDA events, and each model's
   first 2 layers on the card in bf16 and float32 against one float32 CPU
   run (``cut_vs_cpu``: the serving contract); flash held to its plain
   versions and timed at their shapes, as phase 8 does for the others.  ``train_moe_ccm`` as it
   goes with ``--steps 100`` (``CONFIG_100M``, 8 x 256 tokens a step, lr
   1e-3, a checkpoint and a re-placement every 50 steps, into a temporary
   directory removed after), then failing at step 60 under
   ``run_with_restarts``, both under deterministic algorithms: every
   step's launches exactly ``expected_train_launches``, the loss falling,
   the restarted run restoring step 50 and its losses within 1e-3 of the
   uninterrupted run's.
8. Time the kernels, their plain versions and their bounds at the shapes
   the main paths launched most (the pair kernel also at E = 64, A = B =
   128, P = 32 an event, with the launcher's host time a call and its
   split) (CUDA events, median of repeats; for the
   serve kernels also one PyTorch call of the same function, SDPA and
   ``torch.bmm``, timed only; every kernel also as ``device_ms``,
   launches queued behind a sleep on the card, and flash and the expert
   GEMM as the host's time to queue one call); the assembly tile at the
   most-launched signature of each quad order, with the path's launches
   of each quad order (the mix); the RG-LRU scan at its serve and
   training shapes (``RGLRU_TIMED``; 7c (d) times the third); the flash
   backward at qwen's and recurrentgemma's training shapes (phase 7b; hd
   256 against SDPA's backward with the window as a boolean mask); and
   the card's cost of one empty launch,
   the floor under every ``device_ms``.  Flash and the expert GEMM
   are held to their plain versions at every shape the serve paths
   launched, at the tolerances of phase 6, before they are timed.  The
   window kernel at the (W, eb) the spec runs launched most, and at the
   one spec32 and the fleet each launched most, with the launcher's host
   time a call.  Then profile one float64 solo main-path
   run and one ``spec_window=8`` run with ``torch.profiler``: device time
   by kernel and copy, and the device's idle share of the run's wall
   time.
9. Import every module of ``repro_torch``, check that no module of JAX or
   ``repro`` was loaded, then print one JSON line each of serve, recurrent
   serve, the other families' serve runs, per-run, pipeline and async,
   MILP and planner, assembly and the examples' numbers, the launch floor,
   each phase's
   wall seconds, the card line, the training numbers (qwen's and the
   families'), one JSON line of per-kernel numbers (the scorer's pair
   kernel and its full-tile kernel, each in float64 and float32, its
   window kernel, the assembly tile, flash, the expert GEMM, wkv6, rglru,
   the flash backward, the expert GEMM's backward, the WKV6 backward and
   the RG-LRU backward) and, as the last line,
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, without a CUDA card or when the
``repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import gc
import importlib
import json
import pkgutil
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM, NVIDIA data sheet: HBM3 rate, and the non-tensor-core FP64 and
# FP32 rates (the scorer does adds, subtracts, maxima and compares)
HBM_BYTES_PER_S = 3.35e12
# card clock cycles to sleep while the host queues the launches that
# device_ms times (about 50 ms at the H100's 1.98 GHz boost clock)
QUEUE_SLEEP_CYCLES = 10 ** 8
# seconds of idle host time at each end of a profiled run (profiled_run)
PROFILE_MARGIN_S = 0.1
# greedy decode steps a serve run's profile covers (profile_decode)
PROFILE_DECODE_STEPS = 8
PEAK_OPS = {"float64": 34e12, "float32": 67e12}
# operations per (ia, ib) lane of the scorer: 106 adds, subtractions and
# maxima plus the two mask compares (csrc/ccm_scorer.cu); selects not counted
OPS_PER_LANE = 108
# float64 operations per pair of the pair kernel's combine: per side four
# products, one quotient and three sums, and the two cap compares
COMBINE_OPS = 18
MAIN_KW = dict(n_iter=4, k_rounds=2, fanout=4)
KERNEL_SOURCE = "src/repro_torch/csrc/ccm_scorer.cu"
REPLACES = "src/repro/kernels/ccm_scorer/kernel.py:35"
# the window kernel replaces the XLA-compiled kind="spec" body (no Pallas)
SPEC_REPLACES = "src/repro/kernels/ccm_scorer/jit.py:253"
# the main path's speculative runs: (label, spec_window, spec_mode,
# spec_fill), each at scaling_phase(256) with MAIN_KW
SPEC_RUNS = (("spec8 scan/disjoint", 8, "scan", "disjoint"),
             ("spec32 scan/disjoint", 32, "scan", "disjoint"),
             ("spec8 vmap/greedy", 8, "vmap", "greedy"))
# the fleet run: the JAX package's benchmarks/ccmlb_fleet.py configuration
# (16-rank, 400-task random phases) cut from its 64 instances to 16 (the
# smoke's time limit: 64 took some 54 s of card and CPU runs beside an
# H100 80GB HBM3 at 700 W)
FLEET_N = 16
FLEET_PHASE = dict(num_ranks=16, num_tasks=400, num_blocks=24,
                   num_comms=1600, mem_cap=1e12)
FLEET_KW = dict(n_iter=8, k_rounds=2, fanout=8, max_candidates=12)
# per shortlist slot past the scorer tree and the combine: the diff, the
# max of the works, two feasibility compares and the selection compare
SPEC_SLOT_OPS = 5
# the JAX package's benchmarks/ccmlb_pipeline.py configuration (256 ranks,
# loads drifting by a lognormal sigma of 0.08 a phase) cut from its 6 phases
# to 2, the least that carries a warm start, a CSR and an engine (the
# smoke's time limit: 6 took some 95 s, 3 some 45 s beside an H100 80GB
# HBM3 at 700 W)
PIPE_PHASE = dict(num_ranks=256, num_tasks=6400, num_blocks=768,
                  num_comms=12800, mem_cap=1e12)
PIPE_N, PIPE_DRIFT = 2, 0.08
PIPE_KW = dict(n_iter=4, k_rounds=2, fanout=4, seed=0, batch_lock_events=8)
# benchmarks/ccmlb_async.py (256 ranks; its 64-rank instance for the runs
# held to the CPU) and ccmlb_fault.py at its largest size (64 ranks)
ASYNC_LATENCIES = (0.0, 0.5, ("uniform", 0.5, 1.5))
FAULT_LAT = ("uniform", 0.5, 1.5)
FAULT_RANKS = 64
# the JAX package's benchmarks/milp_vs_ccmlb.py (paper Fig. 4a): the
# instance, the delta sweep, 12 CCM-LB seeds a delta; the MILP's node limit
# lets every solve end well inside the smoke, and its wall-clock limit is
# one no solve reaches (a solve cut by the clock is not reproducible)
MILP_PHASE = dict(num_ranks=4, num_tasks=14, num_blocks=4, num_comms=16,
                  mem_cap=5e8)
MILP_DELTAS = (1e-9, 1e-10, 1e-11, 0.0)
MILP_SEEDS = 12
MILP_KW = dict(n_iter=4, fanout=3)
MILP_NODES = 100
# delta 0's two solves reach any node limit (100 nodes took 22.4 and 23.5 s
# of host B&B on an H100 host, 25 nodes 15.2 and 15.8 s on a slower one:
# the first nodes' LPs cost most), so they stop at this one: the smoke's
# wall
MILP_DELTA0_NODES = 10
MILP_NO_CLOCK = 3600.0
# the planners: benchmarks/expert_placement.py's router counts drifting by a
# lognormal sigma a window; tests/test_balance.py's stage-plan archs
PLAN_WINDOWS, PLAN_DRIFT = 4, 0.15
STAGE_ARCHS = ("recurrentgemma-9b", "gemma2-27b", "qwen3-moe-30b-a3b")
STAGE_SCHEDULE = (2048, 4096, 8192, 4096)
ASM_SOURCE = "src/repro_torch/csrc/assembly_tile.cu"
ASM_REPLACES = "src/repro/kernels/assembly/kernel.py:25"
# operations per coupled entry and quadrature step, as the JAX package's
# analytic_durations counts them (assembly/execute.py); the kernel skips the
# ladder of an uncoupled entry, so only coupled entries count
ASM_OPS_PER_STEP = 8
ASM_QUADS = (4, 16, 64, 192)
ASM_SHAPES = ((1, 1), (13, 7), (96, 96), (96, 160), (512, 512))
# the reference's A/B/C run at 8192 unknowns, 32 ranks, task_limit_u=96,
# analytic durations, seed 0 (the JAX package on the CPU; the tests hold the
# port's CPU run to it bitwise at 2048 unknowns)
ASM_EXPECT = dict(tasks=5018, transfers=107, off_home=63, waves=2)
# the reference's homing planner's errors (assembly/homing.py)
HOMING_FAULTS = ("homing did not converge",
                 "homing infeasible: no node has headroom")
# the serving path: qwen3-moe-30b-a3b at its published width, depth cut to
# 8 of 48 layers (the card-against-CPU check keeps a copy of the weights in
# host memory); 4 requests of 512-token prompts, 32 new tokens
SERVE_ARCH = "qwen3-moe-30b-a3b"
SERVE_LAYERS = 8
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 32
CHECK_PROMPT, CHECK_STEPS = 64, 4
# the served weights' first layers, held on the CPU against the card: at
# all 8 served layers the bf16 check took 23.3 s and the float32 one 12.1
# s (an H100 80GB HBM3 at 700 W), time phase 7d needs
SERVE_CHECK_LAYERS = 4
PEAK_BF16 = 989e12          # dense bf16 tensor-core rate, H100 SXM
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash/kernel.py:28"
GEMM_SOURCE = "src/repro_torch/csrc/moe_gemm.cu"
GEMM_REPLACES = "src/repro/kernels/moe_gemm/kernel.py:22"
# tests/test_kernels.py's tolerances: flash atol = rtol = tol; the expert
# GEMM rtol = tol, atol = 10 tol
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GEMM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# the bf16 flash kernel against ref.reference_attention_bf16_tiles, the
# plain model of its arithmetic (its walk over 64-key tiles, p = 2^(s -
# running max) rounded to bf16 before p . v, in log2 units as the kernel
# computes them), which returns float32: rtol half a bf16 ulp (the
# kernel's output is rounded once), atol for the float32 sums' other
# order (2e-3 seen on the served shapes), both beyond the model's slack:
# what a p within ref.P_SLACK of a bf16 rounding midpoint moves an output
# if the kernel, its scores summed in another order, rounds it the other
# way (in a row that sees few keys one such p can move it past atol: one
# of 37,748,736 elements at gemma2's global shape, 3.2 % over, on one of
# 12 inputs, kernel_probe.py --steps flash_p; that p lay on a midpoint,
# and every p read rounded the other way lay within 2^-22 of one)
FLASH_P_TOL = dict(atol=4e-3, rtol=2 ** -8)
# the bf16 expert GEMM against its plain version, tightly: both accumulate
# the exact bf16 products in float32 and round once, so they differ only
# where float32 sums taken in another order fall on two sides of a bf16
# rounding boundary: one bf16 ulp, at most 2^-7 of the value; atol for
# results near 0, where the sums' own float32 error (about 1e-6 here)
# outweighs an ulp
GEMM_P_TOL = dict(rtol=2 ** -7, atol=1e-3)
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap): the cases of
# tests/test_kernels.py, then the serve shape, a length that is no multiple
# of the 64-row tile, rows that see no key (a window ending before the
# keys do), head dims 8 and 256, recurrentgemma-9b's local attention as
# served (16 query heads on one K/V head, hd 256, 2560 tokens past the
# 2048-token window, so whole key tiles before the window are skipped),
# gemma2-27b's local attention as served (hd 128, soft-cap 50, 4608 tokens
# past the 4096-token window); then phase 6c's served shapes: whisper's
# encoder (non-causal, 1500 frames: no multiple of the 64-row tile, hd 64)
# and cross-attention (64 decoder rows against the 1500 frames), gemma2's
# global layer (causal, soft-cap 50) and llava's (1152 media positions and
# 512 text tokens, 32 query heads on 8 K/V heads)
FLASH_CASES = (
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 4, 4, 64, True, 64, 0.0),
    (2, 128, 128, 8, 2, 32, True, 0, 50.0),
    (1, 192, 192, 2, 1, 64, False, 0, 0.0),
    (1, 96, 160, 2, 2, 64, False, 0, 0.0),
    (4, 512, 512, 32, 4, 128, True, 0, 0.0),
    (1, 100, 100, 4, 2, 128, True, 0, 0.0),
    (1, 128, 64, 2, 1, 64, False, 16, 0.0),
    (1, 37, 37, 2, 2, 8, True, 0, 0.0),
    (1, 70, 70, 2, 1, 256, True, 0, 0.0),
    (4, 2560, 2560, 16, 1, 256, True, 2048, 0.0),
    (1, 4608, 4608, 32, 16, 128, True, 4096, 50.0),
    (4, 1500, 1500, 20, 20, 64, False, 0, 0.0),
    (4, 64, 1500, 20, 20, 64, False, 0, 0.0),
    (2, 4608, 4608, 32, 16, 128, True, 0, 50.0),
    (4, 1664, 1664, 32, 8, 128, True, 0, 0.0),
)
# the flash backward is held at every shape: the training paths' (whisper's
# and llava's among phase 6c's, which phase 7d trains) and the kernel's
# corner cases, and two more at hd 256: tests/test_torch_flash.py's cut of
# recurrentgemma's local attention (one kv head, a window, a length that is
# no multiple of 64) and recurrentgemma's training shape (phase 7d's 2 x
# 2560 tokens)
FLASH_BWD_CASES = FLASH_CASES + ((1, 160, 160, 4, 1, 256, True, 64, 0.0),
                                 (2, 2560, 2560, 16, 1, 256, True, 2048,
                                  0.0))
# recurrentgemma's local attention as phase 7d trains it (B, Sq, Skv, Hq,
# Hkv, hd, causal, window, softcap): the hd 256 backward's timed shape
RG_TRAIN_ATTN = (2, 2560, 2560, 16, 1, 256, True, 2048, 0.0)
# (E, C, d, f): the serve path's prefill gate/up and down, its decode
# gate/up and down, then ragged C, d and f (the wmma kernel: d or f no
# multiple of 8), and C = 1, 13 (no multiple of 8) and 300 (two N tiles of
# the TMA kernel); time_serve_kernels also holds the kernel to its plain
# version at every shape the serve path launched
GEMM_SHAPES = ((128, 168, 2048, 768), (128, 168, 768, 2048),
               (128, 4, 2048, 768), (128, 4, 768, 2048), (3, 37, 100, 70),
               (5, 16, 64, 130), (8, 1, 2048, 768), (8, 13, 2048, 768),
               (8, 300, 2048, 768))

# the training path (phase 7b): qwen3-moe-30b-a3b at its published width,
# depth cut to 4 of 48 layers (3.11 G parameters: 37.4 GB of bf16 weights,
# bf16 gradients and float32 AdamW moments before activations); 10 steps of
# 4 x 512 tokens at lr 3e-4, a re-placement every 5 steps on 16 expert ranks
# (the production mesh's model axis).  It writes no checkpoint: one of those
# 4 layers is 31.1 GB (bf16 params, float32 m and v), and the card hosts
# this script runs on end a run that writes more than 45 GiB to their disk,
# deleted files included.  The restart from a checkpoint is held by phase
# 10's train_moe_ccm (a checkpoint of 1.2 GB); until it came, a qwen restart
# pair at 1 layer (two 12.45 GB checkpoints) held it here
TRAIN_ARCH, TRAIN_LAYERS = "qwen3-moe-30b-a3b", 4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 512, 4, 10, 3e-4
TRAIN_REBALANCE, TRAIN_RANKS = 5, 16
# a restarted run's losses against the uninterrupted run's (phase 10), and
# the card's steps against the CPU's (below): AdamW moves an element by
# about lr whatever its gradient's size, so where a gradient is near 0 the
# two sides' rounding decides the step
TRAIN_RESTART_RTOL = 1e-3
# card vs cpu: the same float32 weights of qwen cut to 1 layer (2 before
# phase 6c came: its CPU side took 76-84 s), a batch of
# 2 x 64 tokens: the loss within rtol 1e-4 and each gradient leaf within
# 1e-3 of its largest |value| (float32 on both sides, TF32 off; sums in
# other orders); two steps' losses (three before) within
# TRAIN_RESTART_RTOL, for the
# restart check's reason: AdamW moves an element by about lr whatever its
# gradient's size, so where a gradient is near 0 the two sides' rounding
# decides the step (on an H100, 7e-5 after three steps with the first loss
# equal bit for bit)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 1, 2, 64
TRAIN_CHECK_STEPS = 2
TRAIN_CHECK_RTOL, TRAIN_CHECK_GRAD = 1e-4, 1e-3
# the profiled train step's kernels kept in the train JSON, by device time
TRAIN_TOP_KERNELS = 20
# the flash backward against the plain version's autograd (float32) at every
# FLASH_BWD_CASES shape: each of dq, dk, dv within this share of its largest
# |value| (float32 inputs: sums in another order; bf16 inputs: the forward's
# output, whose p was rounded to bf16, enters D = rowsum(dO o O), and the
# gradients are rounded once to bf16)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the tensor-core flash backward (bf16, hd 64, 128, 256) against its plain
# model, ref.attention_bwd(bf16_products=True) in float32 on the same bf16
# inputs, fed the forward kernel's output and its LSE instance's row
# statistics: each of dq, dk, dv within two bf16 ulps (2^-7) of its
# largest |value|, under half of FLASH_BWD_TOL: the kernel rounds each
# gradient once to bf16 (up to 2^-9 of the value), and P and dS entries
# whose float32 values differ from the model's in the last bits (S and dP
# summed in another order) round now and then to the other bf16
# neighbour; at most 3.3e-3 was seen on an H100 over FLASH_CASES (3.5e-3
# at hd 256)
FLASH_BWD_MODEL_TOL = 2 ** -7
# the LSE instance's row statistics (log2 units, of order 1 to 15 here)
# against ref.row_lse, absolute: about ten float32 ulps of such values
# (the forward's m + log2(l) sums exp2 in another order than torch's
# logsumexp; at most 1.9e-6 was seen on an H100)
FLASH_LSE_ATOL = 2e-5
FLASH_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/models/attention.py:98"
GEMM_BWD_REPLACES = "src/repro/models/moe.py:68"
# the expert GEMM's backward: the training shapes (C = 168; gate/up and
# down), then the ragged ones of GEMM_SHAPES
GEMM_BWD_SHAPES = ((128, 168, 2048, 768), (128, 168, 768, 2048),
                   (3, 37, 100, 70), (5, 16, 64, 130), (8, 1, 2048, 768),
                   (8, 13, 2048, 768), (8, 300, 2048, 768))
# the recurrent backwards against their plain versions (phase 7b).  WKV6
# (B, S, H, hd, log_w, with a final-state gradient): the training shape with
# the test's decay and the model's initial -exp(-6), a ragged S, hd 32 and
# 128, the clip -exp(8) (where dlog_w is exactly 0); RG-LRU (B, S, W): the
# training shape, ragged S and W.  Each gradient within this share of its
# largest |value|: float32 sums in other orders (the WKV6 kernel's dlog_w
# is a difference of suffix sums; 1.4e-6 at most seen on an H100 80GB
# HBM3 at 700 W, in line with the float32 emulation's 1.5e-6 against
# float64 in tests/test_torch_wkv6.py); bf16 dr, dk, dv, db rounded once to
# bf16 (2^-8 of a value; up to 3.4e-3 of the largest seen); dlog_w, du and
# dlog_a are float32 outputs of the same bf16 inputs, so the float32 share
# holds
WKV_BWD_CASES = (
    (4, 512, 64, 64, None, False), (4, 512, 64, 64, -0.0024787521766663585,
                                    True),
    (2, 77, 3, 64, None, True), (1, 100, 2, 32, None, True),
    (2, 70, 2, 128, None, True), (1, 64, 2, 64, -2980.9579870417283, True),
)
REC_BWD_TOL = {"float32": 2e-5, "bfloat16": 2 ** -7}
RGLRU_BWD_CASES = ((2, 2560, 4096), (3, 77, 50), (2, 100, 4100), (1, 1, 300))
WKV_BWD_SOURCE = "src/repro_torch/csrc/wkv6_bwd.cu"
# no TPU kernel: the JAX package differentiates its jnp forms
WKV_BWD_REPLACES = "src/repro/models/rwkv6.py:113"
RGLRU_BWD_REPLACES = "src/repro/models/rglru.py:78"

# the recurrent serving paths, at their published widths and full depths:
# rwkv6-7b (32 rwkv6 layers: 32 wkv6 launches in prefill) and
# recurrentgemma-9b (12 periods of rglru, rglru, local_attn and 2 rglru:
# 26 rglru and 12 flash launches in prefill, with 2560-token prompts, past
# the 2048-token window); each entry: arch, prompt length, prefill
# launches {kernel: (dtype, count)}, the card-vs-cpu check's depth and its
# prompt length per dtype (recurrentgemma's bf16 check on the CPU at 64
# tokens: bf16 products are slow there; float32 at 2112, past the window)
RWKV_ARCH, RG_ARCH = "rwkv6-7b", "recurrentgemma-9b"
REC_SERVES = (
    (RWKV_ARCH, 512, {"wkv6": ("bfloat16", 32)}, 2,
     {"bfloat16": 100, "float32": 100}),
    (RG_ARCH, 2560, {"rglru": ("float32", 26), "flash": ("bfloat16", 12)}, 3,
     {"bfloat16": 64, "float32": 2112}),
)
# 6c. the rest of serving, at published widths and full depths, each model
# freed before the next: gemma2-27b under its ring cache (window_kv_cache,
# as the JAX package's launch/dryrun.py sets it) on 2 x 4608-token prompts,
# past the 4096-token window (46 flash launches a prefill: 23 local, 23
# global); whisper-large-v3 on 4 x 1500 encoder frames (its 30 s window)
# and 64-token decoder prompts (96: 32 encoder, 32 causal self, 32 cross);
# llava-next-mistral-7b on 4 x (1152 media positions + 512 text tokens)
# (32); SERVE_NEW new tokens each.  Each entry: arch, requests, prompt
# tokens, encoder frames, flash launches a prefill, and the card-vs-cpu
# check's cut (one (local, global) period; 2 + 2 layers at the full 1500
# frames; 2 layers at the full 1152 media positions)
GEMMA_ARCH, WHISPER_ARCH, LLAVA_ARCH = ("gemma2-27b", "whisper-large-v3",
                                        "llava-next-mistral-7b")
FAMILY_SERVES = (
    (GEMMA_ARCH, 2, 4608, 0, 46, {"num_layers": 2}),
    (WHISPER_ARCH, 4, 64, 1500, 96, {"num_layers": 2,
                                     "num_decoder_layers": 2}),
    (LLAVA_ARCH, 4, 512, 0, 32, {"num_layers": 2}),
)
# gemma2's ring against the full cache on the card: the full-depth model,
# the served prompts, this many teacher-forced steps
RING_STEPS = 32
WKV_SOURCE = "src/repro_torch/csrc/wkv6.cu"
WKV_REPLACES = "src/repro/kernels/rwkv6/kernel.py:22"
RGLRU_SOURCE = "src/repro_torch/csrc/rglru.cu"
RGLRU_REPLACES = "src/repro/kernels/rglru/kernel.py:25"
# tests/test_kernels.py's tolerances (wkv6 atol 2e-4, rglru 1e-4), with a
# relative term of 1e-5 for the serve shapes' larger values in float32 and
# one bf16 ulp (2^-7) for bf16 outputs
WKV_ATOL, RGLRU_ATOL = 2e-4, 1e-4
WKV_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# (B, S, H, hd, log_w): tests/test_kernels.py's chunk-boundary cases and
# fast decay (-15, and the model's clip at -exp(8)), the serve shape with
# the test's decay and with the model's initial decay -exp(-6), a ragged
# S, head dims 8 and 128
WKV_CASES = (
    (2, 64, 2, 32, None), (2, 128, 2, 32, None), (1, 64, 1, 16, -15.0),
    (1, 64, 1, 16, -2980.9579870417283), (4, 512, 64, 64, None),
    (4, 512, 64, 64, -0.0024787521766663585), (1, 100, 4, 64, None),
    (1, 37, 2, 8, None), (1, 70, 2, 128, None),
)
# (B, S, W): tests/test_kernels.py's rglru cases, the serve shape, the
# training shape and the serve shape on a 4-rank model axis, ragged S and
# W (chunks cut short at (3, 600, 50), segments of two loads at (1, 5000,
# 64))
RGLRU_CASES = ((2, 128, 64), (2, 256, 64), (2, 64, 128), (4, 2560, 4096),
               (2, 2560, 4096), (4, 2560, 1024), (3, 77, 50), (1, 1, 300),
               (2, 100, 4100), (4, 100, 4100), (3, 600, 50), (1, 5000, 64))
# the RG-LRU forward's timed shapes: the serve shape and the training shape
# (phase 7d) in phase 8, the serve shape on a 4-rank model axis in 7c (d)
RGLRU_TIMED = ((4, 2560, 4096), (2, 2560, 4096), (4, 2560, 1024))
# 7d. training the other families on the card, each at its published width
# in bf16 through train_loop, freed before the next: one warm-up step and
# FAMILY_STEPS more at TRAIN_LR.  Each entry: arch, depth cut, requests,
# tokens a request (whisper: encoder frames, with a decoder of
# decoder_len = 187 tokens; llava: 1152 media positions and 512 text
# tokens), and the float32 card-vs-CPU check's cut, requests and tokens (the
# smallest depth with every block kind, at full width; whisper at the full
# 1500 frames and llava at the full 1152 media positions, one request of
# 64 text tokens: float32 products on the CPU are the check's cost; rwkv6
# at 2 x 512 tokens: at 2 x 64 the group norm of a head's first outputs,
# spanned by one or two value vectors, made the gradients of w_r, w_k,
# mix_b, mu and the embedding ill-conditioned: a one-ulp change of the
# weights moved them by up to 1.2e-3 of their largest |value| on the CPU
# (1.8e-6 at 2 x 512), and two float32 forms differed by 2.5e-4 on one
# device and 2.4e-3 across the two, the card with a plain torch WKV6
# against the CPU (kernel_probe.py --steps rwkv_grad, on an H100 80GB HBM3
# at 700 W and its host).  Cuts: rwkv6 8 of 32 layers (2.30 G parameters,
# 27.6 GB of bf16 weights and gradients and float32 AdamW moments),
# recurrentgemma one period of 38 layers (1.71 G, its 256000 x 4096
# embedding tied; 2 x 2560 tokens, past the 2048-token window), whisper at
# full depth (2.02 G), llava 8 of 32 (2.01 G).  recurrentgemma's check runs
# one RG-LRU layer and the local attention (1.42 G parameters; one period
# is 1.60 G) on one request: on one period and two requests its CPU side,
# the gradient and one AdamW update of the tied 256000 x 4096 embedding in
# float32, took 41 of the check's 53 s on an H100 host
FAMILY_STEPS = 3
FAMILY_TRAINS = (
    (RWKV_ARCH, {"num_layers": 8}, 4, 512, {"num_layers": 1}, 2, 512),
    (RG_ARCH, {"num_layers": 3}, 2, 2560,
     {"num_layers": 2, "block_pattern": ("rglru", "local_attn")}, 1, 64),
    (WHISPER_ARCH, {}, 4, 1500, {"num_layers": 2, "num_decoder_layers": 2},
     2, 1500),
    (LLAVA_ARCH, {"num_layers": 8}, 4, 1152 + 512, {"num_layers": 2}, 1,
     1152 + 64),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def random_tiles(torch, rng, dtype, e_n, a_n, b_n):
    from repro_torch.kernels.ccm_scorer.layout import N_AV, N_PM, N_SC, SC
    av = rng.uniform(-2, 2, (e_n, N_AV, a_n))
    bv = rng.uniform(-2, 2, (e_n, N_AV, b_n))
    pm = rng.uniform(-2, 2, (e_n, N_PM, a_n, b_n))
    sc = rng.uniform(0.1, 3.0, (e_n, N_SC))
    sc[:, SC.na] = rng.integers(0, a_n, e_n)
    sc[:, SC.nb] = rng.integers(0, b_n, e_n)
    return [torch.tensor(x, dtype=dtype, device="cuda")
            for x in (av, bv, pm, sc)]


# ------------------------------------------------------------ 3. the kernel
def check_kernel(torch, kernel, ref, rng) -> dict:
    """The kernel against its plain version on the card, exactly."""
    from repro_torch.kernels.ccm_scorer.layout import AV, OUT, SC
    worst = {}
    n_cases = 0
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for e_n in (1, 8, 64):
            for a_n in (1, 13, 16, 128):
                for b_n in (1, 13, 16, 128):
                    t = random_tiles(torch, rng, dtype, e_n, a_n, b_n)
                    got = kernel.score_tiles(*t)
                    want = ref.score_tiles(*t)
                    torch.cuda.synchronize()
                    case = f"{name} E={e_n} A={a_n} B={b_n}"
                    if got.shape != want.shape or got.dtype != dtype:
                        fail(f"kernel shape/dtype {tuple(got.shape)} "
                             f"{got.dtype} at {case}")
                    if not torch.equal(got, want):
                        fail(f"kernel != plain version at {case}")
                    sc = t[3]
                    ia = torch.arange(a_n, device="cuda")[None, :, None]
                    ib = torch.arange(b_n, device="cuda")[None, None, :]
                    live = ((ia <= sc[:, SC.na, None, None])
                            & (ib <= sc[:, SC.nb, None, None]))[:, None]
                    tail = ~live
                    flow, mem = got[:, :OUT.mem_a], got[:, OUT.mem_a:]
                    if not (flow.masked_select(tail) == 0).all():
                        fail(f"flow tail not 0 at {case}")
                    if not torch.isposinf(mem.masked_select(tail)).all():
                        fail(f"memory tail not +inf at {case}")
                    if not torch.isfinite(got.masked_select(live)).all():
                        fail(f"non-finite live lane at {case}")
                    both = live.expand_as(got)
                    err = (got[both] - want[both]).abs().max().item()
                    worst[name] = max(worst[name], err)
                    n_cases += 1
        # NaN inputs must come out NaN, as through np.maximum
        t = random_tiles(torch, rng, dtype, 8, 13, 13)
        t[3][:, SC.na] = 12
        t[3][:, SC.nb] = 12
        t[0][:, AV.ovh, 3] = float("nan")         # mem_b's max operand
        t[1][:, AV.out_other, 2] = float("nan")   # off_b through sent_b
        t[3][1, SC.ovh_a] = float("nan")          # mem_a's max operand
        got = kernel.score_tiles(*t)
        want = ref.score_tiles(*t)
        if not torch.isnan(got).any():
            fail(f"NaN inputs gave no NaN output ({name})")
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        n_cases += 1
    print(f"kernel == plain version on {n_cases} cases (float64 and "
          f"float32, exact, masked tail and NaN checked); max_abs_err "
          f"{worst}", flush=True)
    return worst


def pair_events(rng, e_n, a_n, b_n, counts, tails=False, nans=False):
    """Unpadded per-event features ``(av, bv, pm, sc)`` of an (a_n, b_n)
    tile each, as the engine builds them (sc float64), with speeds other
    than 1 and caps that split the pairs, and ``counts[k]`` random pairs of
    event k, drawn over the whole tile.  ``tails``: each event's na, nb
    random below the tile's, so that pairs in the masked tail are scored
    too.  ``nans``: the last event all live and its flows NaN (a NaN W
    wherever feasible), a NaN memory high in the first event's first
    a-column and a NaN off-rank volume in the last event's first
    b-column."""
    import numpy as np
    from repro_torch.kernels.ccm_scorer.layout import AV, N_AV, N_PM, N_SC, SC
    feats, pairs = [], []
    for n in counts:
        sc = rng.uniform(0.1, 3.0, N_SC)
        sc[SC.na], sc[SC.nb] = ((rng.integers(0, a_n), rng.integers(0, b_n))
                                if tails else (a_n - 1, b_n - 1))
        sc[SC.speed_a], sc[SC.speed_b] = rng.uniform(0.3, 4.0, 2)
        sc[SC.mem_cap_a], sc[SC.mem_cap_b] = rng.uniform(4.0, 12.0, 2)
        feats.append((rng.uniform(-2, 2, (N_AV, a_n)),
                      rng.uniform(-2, 2, (N_AV, b_n)),
                      rng.uniform(-2, 2, (N_PM, a_n, b_n)), sc))
        lanes = rng.choice(a_n * b_n, size=n, replace=False)
        pairs.append(np.stack([lanes // b_n, lanes % b_n], axis=1))
    if nans:
        feats[-1][3][[SC.na, SC.nb]] = a_n - 1, b_n - 1
        feats[-1][3][SC.f_ab] = float("nan")
        feats[0][0][AV.ovh, 0] = float("nan")
        feats[-1][1][AV.out_other, 0] = float("nan")
    return feats, pairs


def pair_inputs(torch, launch, dtype, feats, pairs, params) -> list:
    """The pair kernel's inputs on the card, packed as the launcher packs
    them (``launch.pack``): av, bv, pm, sc, cf, offs, pairs."""
    _, regions, _ = launch.pack(feats, pairs, params, launch.Staging(
        torch.device("cpu"), dtype))
    return [torch.from_numpy(v).to("cuda") for v in regions]


def check_pair_kernel(torch, kernel, launch, ref, rng) -> dict:
    """The fused pair kernel against its plain version on the card, bit
    for bit (NaN as NaN): float64 and float32 (float32 planes, float64
    combine); E in {1, 8, 64}; (A, B) in {(1, 1), (13, 13), (5, 128),
    (128, 128)}; P in {1, 32, A*B} per event (events 1 and 5 empty where
    E >= 8); masked tails; NaN lanes; random coefficients, speeds other
    than 1; memory_constraint on and off."""
    from repro_torch.core import CCMParams
    worst = {}
    n_cases = 0
    split = [0, 0]          # infeasible and feasible pairs, constraint on
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for e_n in (1, 8, 64):
            for a_n, b_n in ((1, 1), (13, 13), (5, 128), (128, 128)):
                for p_n in sorted({1, min(32, a_n * b_n), a_n * b_n}):
                    for mc in (True, False):
                        nans = (n_cases % 3 == 0)
                        counts = [0 if e_n >= 8 and k in (1, 5) else p_n
                                  for k in range(e_n)]
                        feats, pairs = pair_events(rng, e_n, a_n, b_n,
                                                   counts, True, nans)
                        params = CCMParams(*rng.uniform(0.05, 2.0, 4),
                                           memory_constraint=mc)
                        t = pair_inputs(torch, launch, dtype, feats, pairs,
                                        params)
                        got = kernel.score_pairs(*t, mc)
                        want = ref.score_pairs_packed(*t, mc)
                        torch.cuda.synchronize()
                        case = (f"{name} E={e_n} A={a_n} B={b_n} P={p_n} "
                                f"memory_constraint={mc} nans={nans}")
                        if got.shape != want.shape or \
                                got.dtype != torch.float64:
                            fail(f"pair kernel shape/dtype "
                                 f"{tuple(got.shape)} {got.dtype} at {case}")
                        try:
                            torch.testing.assert_close(
                                got, want, rtol=0, atol=0, equal_nan=True)
                        except AssertionError as err:
                            fail(f"pair kernel != plain version at {case}: "
                                 f"{err}")
                        # without the constraint every pair of the last
                        # event has a NaN W
                        if nans and not mc and not torch.isnan(got).any():
                            fail(f"NaN inputs gave no NaN output at {case}")
                        feas = got[2]
                        if not ((feas == 0) | (feas == 1)).all():
                            fail(f"feasibility not 0/1 at {case}")
                        if not torch.isposinf(got[:2, feas == 0]).all():
                            fail(f"infeasible pair not +inf at {case}")
                        if mc:
                            split[0] += int((feas == 0).sum().item())
                            split[1] += int((feas == 1).sum().item())
                        ok = torch.isfinite(got) & torch.isfinite(want)
                        if ok.any():
                            err = (got[ok] - want[ok]).abs().max().item()
                            worst[name] = max(worst[name], err)
                        n_cases += 1
    if not min(split):
        fail(f"the caps did not split the pairs (infeasible, feasible: "
             f"{split})")
    print(f"pair kernel == plain version on {n_cases} cases (float64 and "
          f"float32, bit for bit, masked tails, NaN lanes, empty "
          f"shortlists; {split[0]} infeasible and {split[1]} feasible pairs "
          f"under the memory constraint); max_abs_err {worst}", flush=True)
    return worst


# --------------------------------------------------------- 4. the main path
def same_run(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.assignment, b.assignment)
            and a.transfer_log == b.transfer_log
            and a.transfers == b.transfers and a.max_work == b.max_work)


def ranks_over_cap(state) -> int:
    return sum(not state.memory_feasible(r)
               for r in range(state.phase.num_ranks))


def main_path(torch, kernel, launch) -> dict:
    import numpy as np
    from repro_torch.core import (CCMParams, CCMState, ccm_lb,
                                  initial_assignment, random_phase,
                                  scaling_phase)
    launches = {"float64": 0, "float32": 0}
    shapes = {"float64": Counter(), "float32": Counter()}
    pair_shapes = {"float64": Counter(), "float32": Counter()}
    runs = {}

    # 16 ranks against the scalar reference path (never calls the scorer)
    small = scaling_phase(16)
    a_small = initial_assignment(small)
    scalar = ccm_lb(small, a_small, CCMParams(), use_engine=False,
                    device="cpu", **MAIN_KW)
    kernel.reset_launches()
    launch.reset_stats()
    eng = ccm_lb(small, a_small, CCMParams(), device="cuda", **MAIN_KW)
    torch.cuda.synchronize()
    n16 = kernel.PAIR_LAUNCHES["float64"]
    if not same_run(scalar, eng):
        fail("16 ranks: cuda engine run differs from the scalar reference")
    if n16 == 0 or n16 != launch.STATS["calls"] \
            or sum(kernel.LAUNCHES.values()):
        fail(f"16 ranks: {n16} pair launches vs {launch.STATS['calls']} "
             f"calls, full-tile launches {kernel.LAUNCHES}")
    launches["float64"] += n16
    shapes["float64"].update(launch.STATS["shapes"])
    pair_shapes["float64"].update(launch.STATS["pair_shapes"])
    print(f"16 ranks: cuda engine == scalar reference ({eng.transfers} "
          f"transfers, {n16} launches)", flush=True)

    scaling = scaling_phase(256)
    memory = random_phase(1, num_ranks=256, num_tasks=6400, num_blocks=768,
                          num_comms=12800, mem_cap=2.4e8)
    params = CCMParams()
    print(f"main path: scaling_phase(256): {scaling.num_ranks} ranks, "
          f"{scaling.num_tasks} tasks, {scaling.num_comms} comm edges, "
          f"{MAIN_KW}", flush=True)
    f64_assignment = None
    for label, phase, batch, dtype in (
            ("f64 solo", scaling, 1, torch.float64),
            ("f64 batch8", scaling, 8, torch.float64),
            ("f32 batch8", scaling, 8, torch.float32),
            ("f64 solo memory-binding", memory, 1, torch.float64)):
        name = dtype_name(dtype)
        a0 = initial_assignment(phase)
        kw = dict(MAIN_KW, batch_lock_events=batch, dtype=dtype)
        launch.reset_stats()
        t0 = time.perf_counter()
        cpu = ccm_lb(phase, a0, params, device="cpu", profile=True, **kw)
        cpu_s = time.perf_counter() - t0
        cpu_calls = launch.STATS["calls"]

        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu = ccm_lb(phase, a0, params, device="cuda", profile=True, **kw)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        n_launch = dict(kernel.PAIR_LAUNCHES)
        calls = launch.STATS["calls"]

        if not same_run(gpu, cpu):
            fail(f"{label}: cuda run differs from the cpu run")
        if n_launch[name] == 0 or n_launch[name] != calls \
                or calls != cpu_calls:
            fail(f"{label}: pair kernel launches {n_launch} vs scorer calls "
                 f"{calls} (cpu run {cpu_calls})")
        if sum(n_launch.values()) != n_launch[name]:
            fail(f"{label}: launches of the other dtype {n_launch}")
        if sum(kernel.LAUNCHES.values()):
            fail(f"{label}: the full-tile kernel was launched "
                 f"{kernel.LAUNCHES} on the main path")
        mw = np.asarray(gpu.max_work)
        if (not np.isfinite(mw[-1]) or not mw[-1] < mw[0]
                or gpu.assignment.shape != (phase.num_tasks,)
                or gpu.assignment.min() < 0
                or gpu.assignment.max() >= phase.num_ranks):
            fail(f"{label}: implausible result (max_work {gpu.max_work})")
        over = None
        if phase is memory:
            over = (ranks_over_cap(CCMState.build(phase, a0, params)),
                    ranks_over_cap(gpu.state))
            if not np.isinf(mw[0]) or over[0] == 0 or over[1] != 0:
                fail(f"{label}: memory constraint did not bind and clear "
                     f"(ranks over the cap {over}, max_work {mw[[0, -1]]})")
        if phase is scaling and name == "float64" and batch == 1:
            f64_assignment = gpu.assignment
            f64_cpu_run, f64_cuda_run = cpu, gpu
        if name == "float32" and not np.array_equal(gpu.assignment,
                                                    f64_assignment):
            fail(f"{label}: float32 assignment differs from float64")
        launches[name] += n_launch[name]
        shapes[name].update(launch.STATS["shapes"])
        pair_shapes[name].update(launch.STATS["pair_shapes"])
        stages = {k: sum(t[k] for t in gpu.stage_timings)
                  for k in gpu.stage_timings[0]}
        cpu_stages = {k: sum(t[k] for t in cpu.stage_timings)
                      for k in cpu.stage_timings[0]}
        runs[label] = dict(
            ranks=phase.num_ranks, tasks=phase.num_tasks,
            transfers=gpu.transfers, scorer_calls=calls,
            launches=n_launch[name], cuda_s=gpu_s, cpu_s=cpu_s,
            max_work=[float(mw[0]), float(mw[-1])],
            ranks_over_cap=over, cuda_stage_s=stages,
            cpu_stage_s=cpu_stages,
            cuda_score_events_s=launch.STATS["seconds"],
            cuda_score_events_split_s=dict(launch.STATS["split"]),
            cuda_score_call_ms=launch.STATS["seconds"] / calls * 1e3,
            top_shapes=[[list(k), v] for k, v
                        in launch.STATS["shapes"].most_common(5)])
        print(f"{label}: identical to cpu; {gpu.transfers} transfers, "
              f"{calls} scorer calls = {n_launch[name]} pair launches; "
              "max_work "
              f"{float(mw[0])!r} -> {float(mw[-1])!r}"
              + (f"; ranks over the cap {over[0]} -> {over[1]}"
                 if over else "")
              + f"; wall cuda {gpu_s:.3f} s, cpu {cpu_s:.3f} s; scorer "
              f"calls {launch.STATS['seconds']!r} s, split "
              f"{launch.STATS['split']}", flush=True)
    return dict(launches=launches, shapes=shapes, pair_shapes=pair_shapes,
                runs=runs, f64_cpu_run=f64_cpu_run,
                f64_cuda_run=f64_cuda_run)


# -------------------------------------------- 3b / 4b. the speculative window
def spec_capture(phase, params, max_candidates: int, n_events: int):
    """Window rows of the first ``n_events`` lock events of ``phase``'s
    first iteration (``MAIN_KW``'s gossip), captured from its initial state
    as the spec driver captures them (``core.spec._prepare``).  Returns
    (raws, lanes, pair bucket)."""
    from collections import deque

    from repro_torch.core import CCMState, PhaseEngine, initial_assignment
    from repro_torch.core.ccmlb import ProtocolStats
    from repro_torch.core.quiesce import QuiesceTracker
    from repro_torch.core.spec import SpecInstance, _prepare, event_sequence
    from repro_torch.kernels.ccm_scorer.layout import (bucket_lanes,
                                                       bucket_pairs)
    st = CCMState.build(phase, initial_assignment(phase), params)
    eng = PhaseEngine(st, device="cpu")
    tr = QuiesceTracker(st, eng, params, seed=0,
                        k_rounds=MAIN_KW["k_rounds"],
                        fanout=MAIN_KW["fanout"])
    tr.begin_iteration(0)
    clusters, _ = tr.update_summaries()
    seq = event_sequence(phase.num_ranks,
                         tr.update_work_lists(tr.update_gossip()))
    inst = SpecInstance(state=st, engine=eng, clusters=clusters,
                        stats=ProtocolStats(), rebuild=None, queue=deque(),
                        max_candidates=max_candidates)
    lanes = bucket_lanes(max_candidates + 1)
    p_n = bucket_pairs(min(max_candidates * (max_candidates + 2), 32))
    raws = []
    for r, p in seq:
        cap, raw = _prepare(inst, r, p, lanes, lanes, p_n)
        if cap is not None:
            raws.append(raw)
        if len(raws) == n_events:
            break
    return raws, lanes, p_n


def spec_buffer(torch, launch, raws, lanes: int, p_n: int, b_lanes=None):
    """The window of ``raws`` as ``launch.score_spec`` stacks it (padded to
    a power of two of rows), on the card, contiguous; ``b_lanes`` defaults
    to ``lanes``."""
    import numpy as np
    from repro_torch.kernels.ccm_scorer.layout import (bucket_events,
                                                       spec_offsets)
    eb = max(e for _, e in raws)
    offs = spec_offsets(eb, lanes, lanes if b_lanes is None else b_lanes,
                        p_n)
    buf = np.zeros((bucket_events(len(raws)), offs[-1]))
    launch.stack_spec(raws, buf, eb, offs[4])
    return torch.from_numpy(buf).cuda()


def same_bits(torch, a, b) -> bool:
    """Bit for bit, any NaN equal to any NaN."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int64) == b.view(torch.int64))
         | (torch.isnan(a) & torch.isnan(b))).all().item())


def check_spec_kernel(torch, kernel, launch, ref) -> tuple:
    """The window kernel against its plain version on the card, bit for
    bit, with the flow matrix in shared memory and in global scratch: real
    rows of ``scaling_phase(256)``'s first lock events in windows of 1, 8,
    32 and 64 rows; rows of a 16-rank phase mixed in (other edge buckets);
    a row with pair count 0, one with every pair infeasible, one whose
    maximum is tied (the first must win); and ``max_candidates=70`` rows
    (lanes 128, G = 257: F only fits global scratch), and
    ``max_candidates=40`` (lanes 64: F in shared memory past the default
    48 KB, opted in); the fleet's first 64 rows (one window, eb 1024); the
    scatter's adversarial rows (``spec_cases.scatter_cases``, each case a
    window of two rows, and all of them in one); random rows of an odd
    length (lanes 5 and 8: the wrapper copies them to an even stride, and
    the launcher's card route, whose pinned staging pads the stride, is
    held to the plain version too) and of 64 and 300 pair slots (the
    warps' winners meet in shared memory).  The plain version on the card
    is also held to the plain version on the CPU (the tests' oracle), bit
    for bit.  Returns (the worst absolute difference, the captured 256-rank
    rows, the fleet's rows, their lanes and pair bucket)."""
    import numpy as np
    from repro_torch.core import CCMParams, random_phase, scaling_phase
    from repro_torch.kernels.ccm_scorer import spec_cases
    from repro_torch.kernels.ccm_scorer.layout import SC, spec_offsets
    params = CCMParams()
    big, lanes, p_n = spec_capture(scaling_phase(256), params, 12, 96)
    small, _, _ = spec_capture(
        random_phase(11, num_ranks=16, num_tasks=320, num_blocks=48,
                     num_comms=1280, mem_cap=1e12), params, 12, 24)
    mid, m_lanes, m_p = spec_capture(scaling_phase(256), params, 40, 8)
    wide, w_lanes, w_p = spec_capture(scaling_phase(256), params, 70, 24)
    fleet, _, _ = spec_capture(random_phase(1000, **FLEET_PHASE),
                               CCMParams(delta=1e-9), 12, FLEET_N)
    if len(big) < 96 or {e for _, e in small} == {e for _, e in big}:
        fail(f"spec capture: {len(big)} rows, edge buckets "
             f"{sorted({e for _, e in small})} / "
             f"{sorted({e for _, e in big})}")
    # edge rows from real ones
    probe = ref.score_spec_rows(spec_buffer(torch, launch, big, lanes, p_n),
                                lanes, lanes, p_n).cpu()
    k_row = next(i for i in range(len(big)) if probe[i, 0] > 0
                 and np.isfinite(probe[i, 1].item()))
    row, eb = big[k_row]
    k = int(probe[k_row, 0])
    offs = spec_offsets(eb, lanes, lanes, p_n)
    tie = row.copy()
    for o in (offs[5], offs[6]) + tuple(offs[3] + q * p_n for q in range(4)):
        tie[o] = tie[o + k]
    none, infeasible = row.copy(), row.copy()
    none[offs[7] + 5] = 0.0
    infeasible[offs[4] + SC.mem_cap_a] = -1.0
    edge = [(tie, eb), (none, eb), (infeasible, eb), (row, eb)]
    mixed = [x for pair in zip(small, big) for x in pair]
    rng = np.random.default_rng(0)
    scatter = spec_cases.scatter_cases(big[:2], lanes, lanes, p_n)
    cases = [("W=1", big[:1], lanes, lanes, p_n),
             ("W=8", big[:8], lanes, lanes, p_n),
             ("W=32", big[8:40], lanes, lanes, p_n),
             ("W=64", big[32:96], lanes, lanes, p_n),
             ("mixed edge buckets", mixed, lanes, lanes, p_n),
             ("edge rows", edge, lanes, lanes, p_n),
             ("max_candidates=40", mid, m_lanes, m_lanes, m_p),
             ("max_candidates=70", wide[:8], w_lanes, w_lanes, w_p),
             ("max_candidates=70, W=24", wide, w_lanes, w_lanes, w_p),
             ("fleet, W=64", fleet, lanes, lanes, p_n)]
    cases += [(f"scatter: {label}", raws, lanes, lanes, p_n)
              for label, raws in scatter]
    cases += [("scatter: every case", [r for _, rows in scatter
                                       for r in rows], lanes, lanes, p_n),
              ("odd row length", spec_cases.random_rows(rng, 5, 64, 5, 8,
                                                        32), 5, 8, 32),
              ("P=64", spec_cases.random_rows(rng, 4, 96, 16, 16, 64), 16,
               16, 64),
              ("P=300", spec_cases.random_rows(rng, 2, 32, 8, 8, 300), 8, 8,
               300)]
    worst, n_cases = 0.0, 0
    for label, raws, a_n, b_n, p in cases:
        buf = spec_buffer(torch, launch, raws, a_n, p, b_n)
        want = ref.score_spec_rows(buf, a_n, b_n, p)
        if not same_bits(torch, want.cpu(),
                         ref.score_spec_rows(buf.cpu(), a_n, b_n, p)):
            fail(f"spec plain version: card != cpu at {label}")
        if label == "odd row length":
            card = launch.score_spec(raws, a_lanes=a_n, b_lanes=b_n, p_n=p,
                                     device=torch.device("cuda"))
            if buf.shape[1] % 2 == 0 or not same_bits(
                    torch, torch.from_numpy(card), want.cpu()[:len(raws)]):
                fail("window launcher (padded staging stride) != plain "
                     f"version at {label}")
        in_smem = kernel.spec_f_in_smem(a_n, b_n, p)
        for f_global in ((False, True) if in_smem else (True,)):
            got = kernel.score_spec_rows(buf, a_n, b_n, p, f_global=f_global)
            torch.cuda.synchronize()
            if not same_bits(torch, got, want):
                bad = (got != want).any(1).nonzero()[:4].flatten().tolist()
                fail(f"window kernel != plain version at {label} "
                     f"(F in {'global' if f_global else 'shared'} memory), "
                     f"rows {bad}: {got[bad].tolist()} vs "
                     f"{want[bad].tolist()}")
            ok = torch.isfinite(got) & torch.isfinite(want)
            if ok.any():
                worst = max(worst, (got[ok] - want[ok]).abs().max().item())
            n_cases += 1
        if label == "edge rows":
            got = want.cpu()
            if not (got[0, 0] == 0 and got[0, 1] == probe[k_row, 1]
                    and got[1, 0] == 0 and torch.isneginf(got[1, 1])
                    and got[2, 0] == 0 and torch.isneginf(got[2, 1])
                    and got[3, 0] == k):
                fail(f"spec edge rows selected {got.tolist()}")
    if (kernel.spec_f_in_smem(w_lanes, w_lanes, w_p)
            or not kernel.spec_f_in_smem(m_lanes, m_lanes, m_p)
            or kernel.spec_smem_bytes(m_lanes, m_lanes, m_p, True)
            <= 48 * 1024):
        fail("lanes 64 should put F in opted-in shared memory (above 48 KB)"
             ", lanes 128 in global scratch")
    print(f"window kernel == plain version on {n_cases} cases (bit for bit; "
          f"F in shared memory and in global scratch; 256-rank rows, W 1 to "
          f"64, mixed edge buckets, pair count 0, all infeasible, a tie, "
          f"lanes 64 and 128, the fleet's rows, {len(scatter)} adversarial "
          f"scatter cases, an odd row length, 64 and 300 pair slots); "
          f"max_abs_err {worst}", flush=True)
    return worst, big, fleet, lanes, p_n


def spec_path(torch, kernel, launch, want) -> dict:
    """The main path through the speculative driver: ``scaling_phase(256)``
    with ``MAIN_KW`` on the card for each of ``SPEC_RUNS``, each held to
    f64 solo's CPU run (``want``).  Window-kernel launches, counted from
    zero just before each run and read just after, must equal the windows
    that scored a row (``launch.STATS["spec"]["calls"]``), with no pair or
    full-tile launch and no pair scorer call; disjoint fill rolls nothing
    back."""
    from repro_torch.core import CCMParams, ccm_lb, initial_assignment
    from repro_torch.core import scaling_phase
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    runs, shapes, launches = {}, Counter(), 0
    for label, window, mode, fill in SPEC_RUNS:
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu = ccm_lb(phase, a0, CCMParams(), device="cuda", profile=True,
                     spec_window=window, spec_mode=mode, spec_fill=fill,
                     **MAIN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel.SPEC_LAUNCHES["float64"]
        rec = launch.STATS["spec"]
        if not same_run(gpu, want):
            fail(f"{label}: cuda spec run differs from f64 solo's cpu run")
        if (n == 0 or n != rec["calls"] or n > gpu.spec_windows
                or sum(kernel.PAIR_LAUNCHES.values())
                or sum(kernel.LAUNCHES.values()) or launch.STATS["calls"]):
            fail(f"{label}: window launches {n}, windows that scored "
                 f"{rec['calls']} of {gpu.spec_windows}, pair launches "
                 f"{kernel.PAIR_LAUNCHES}, full-tile {kernel.LAUNCHES}, pair "
                 f"scorer calls {launch.STATS['calls']}")
        if fill == "disjoint" and gpu.spec_rollbacks:
            fail(f"{label}: {gpu.spec_rollbacks} rollbacks under disjoint "
                 "fill")
        stages = {k: sum(t[k] for t in gpu.stage_timings)
                  for k in gpu.stage_timings[0]}
        shapes.update(rec["shapes"])
        launches += n
        runs[label] = dict(
            window=window, mode=mode, fill=fill, transfers=gpu.transfers,
            windows=gpu.spec_windows, rollbacks=gpu.spec_rollbacks,
            launches=n, rows=rec["rows"], cuda_s=wall, cuda_stage_s=stages,
            score_spec_s=rec["seconds"], score_spec_split_s=dict(
                rec["split"]),
            score_spec_call_ms=rec["seconds"] / n * 1e3,
            top_shapes=[[list(k), v] for k, v
                        in rec["shapes"].most_common(5)])
        print(f"{label}: identical to f64 solo's cpu run; {gpu.transfers} "
              f"transfers, {gpu.spec_windows} windows ({gpu.spec_rollbacks} "
              f"rollbacks), {n} window launches for {rec['rows']} rows; wall "
              f"cuda {wall!r} s; stages {stages}; score_spec "
              f"{rec['seconds']!r} s, split {rec['split']}", flush=True)
    return dict(runs=runs, shapes=shapes, launches=launches)


def fleet_path(torch, kernel, launch) -> dict:
    """``ccm_lb_many`` of the JAX package's fleet benchmark configuration
    (``FLEET_N`` instances of ``random_phase(1000 + i, **FLEET_PHASE)``,
    ``CCMParams(delta=1e-9)``, ``FLEET_KW``, window ``FLEET_N``, mode
    vmap) on the card, every instance held to its solo run on the card's
    host engine (``ccm_lb(seed=i)``, pair kernel).  Window launches,
    counted from zero just before the fleet run, must equal the windows
    that scored a row, with no pair launch."""
    from repro_torch.core import (CCMParams, ccm_lb, ccm_lb_many,
                                  initial_assignment, random_phase)
    phases = [random_phase(1000 + i, **FLEET_PHASE) for i in range(FLEET_N)]
    a0s = [initial_assignment(p) for p in phases]
    params = CCMParams(delta=1e-9)
    kernel.reset_launches()
    launch.reset_stats()
    t0 = time.perf_counter()
    fleet = ccm_lb_many(phases, a0s, params, seed=0, device="cuda",
                        window=FLEET_N, mode="vmap", **FLEET_KW)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    n = kernel.SPEC_LAUNCHES["float64"]
    rec = dict(launch.STATS["spec"])
    if (n == 0 or n != rec["calls"] or sum(kernel.PAIR_LAUNCHES.values())
            or sum(kernel.LAUNCHES.values())):
        fail(f"fleet: window launches {n} vs windows that scored "
             f"{rec['calls']}, pair launches {kernel.PAIR_LAUNCHES}")
    kernel.reset_launches()
    launch.reset_stats()
    t0 = time.perf_counter()
    solos = [ccm_lb(phases[i], a0s[i], params, seed=i, device="cuda",
                    **FLEET_KW) for i in range(FLEET_N)]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_launches = kernel.PAIR_LAUNCHES["float64"]
    bad = [i for i in range(FLEET_N) if not same_run(fleet[i], solos[i])]
    if bad:
        fail(f"fleet instances {bad[:8]} differ from their solo runs")
    out = dict(instances=FLEET_N, transfers=sum(r.transfers for r in fleet),
               rollbacks=sum(r.spec_rollbacks for r in fleet),
               instance_windows=sum(r.spec_windows for r in fleet),
               launches=n, rows=rec["rows"], fleet_s=fleet_s,
               score_spec_s=rec["seconds"],
               score_spec_split_s=dict(rec["split"]),
               top_shapes=[[list(k), v] for k, v
                           in rec["shapes"].most_common(5)],
               solo_loop_s=solo_s, solo_pair_launches=solo_launches)
    print(f"fleet: {FLEET_N} instances identical to their solo runs; "
          f"{out['transfers']} transfers, {n} window launches for "
          f"{rec['rows']} rows; wall {fleet_s!r} s (solo loop {solo_s!r} s, "
          f"{solo_launches} pair launches); score_spec {rec['seconds']!r} s, "
          f"split {rec['split']}", flush=True)
    return out


# ------------------------------------------ 4c. the multi-phase pipeline
def pipeline_phases():
    """The JAX package's ``benchmarks/ccmlb_pipeline.py`` ``make_phases(1,
    256)``: ``PIPE_N`` phases sharing one topology, task loads drifting by a
    lognormal ``PIPE_DRIFT`` a phase."""
    import dataclasses

    import numpy as np
    from repro_torch.core import random_phase
    phases = [random_phase(1, **PIPE_PHASE)]
    rng = np.random.default_rng(2)
    for _ in range(PIPE_N - 1):
        prev = phases[-1]
        phases.append(dataclasses.replace(
            prev, task_load=prev.task_load
            * rng.lognormal(0.0, PIPE_DRIFT, prev.num_tasks)))
    return phases


def counted_pipeline(counts: dict, **kw) -> tuple:
    """``ccm_lb_pipeline(**kw)`` with the float64 launch count ``counts``
    (``kernel.PAIR_LAUNCHES`` or ``kernel.SPEC_LAUNCHES``) read before and
    after each phase's ``ccm_lb`` call (the pipeline module's own
    reference to it is wrapped for the run and restored after)."""
    from repro_torch.core import pipeline
    per_phase = []
    inner = pipeline.ccm_lb

    def counted(*args, **lb):
        n0 = counts["float64"]
        res = inner(*args, **lb)
        per_phase.append(counts["float64"] - n0)
        return res

    pipeline.ccm_lb = counted
    try:
        res = pipeline.ccm_lb_pipeline(**kw)
    finally:
        pipeline.ccm_lb = inner
    return res, per_phase


def pipeline_path(torch, kernel, launch) -> dict:
    """``ccm_lb_pipeline`` over ``pipeline_phases()`` with
    ``CCMParams(delta=1e-9)`` and ``PIPE_KW``, warm-started: on the CPU,
    then on the card with ``reuse_csr``, again with ``carry_engine``, and
    with ``carry_engine`` and ``spec_window=8`` in place of the batch;
    each card run equals the CPU's phase by phase (assignment, transfer
    log, count, max_work) with the CSR reused, the warm start carried and,
    with carry, the engine carried on every phase after the first.
    Launches, counted from zero just before each card run and read just
    after, must be more
    than zero in every phase and equal the scorer calls (pair kernel) or
    the windows that scored (window kernel), with no full-tile launch and
    none of the other kernel."""
    from repro_torch.core import CCMParams, ccm_lb_pipeline
    phases = pipeline_phases()
    params = CCMParams(delta=1e-9)
    t0 = time.perf_counter()
    cpu = ccm_lb_pipeline(phases, params, device="cpu", **PIPE_KW)
    cpu_s = time.perf_counter() - t0
    out = dict(phases=PIPE_N, ranks=phases[0].num_ranks,
               tasks=phases[0].num_tasks, cpu_s=cpu_s,
               cpu_phase_s=[r.seconds for r in cpu.runs])
    spec_kw = {k: v for k, v in PIPE_KW.items() if k != "batch_lock_events"}
    for label, carry, kw in (
            ("warm, reuse_csr", False, PIPE_KW),
            ("warm, carry_engine", True, PIPE_KW),
            ("warm, carry_engine, spec_window=8", True,
             dict(spec_kw, spec_window=8))):
        spec = "spec_window" in kw
        counts = kernel.SPEC_LAUNCHES if spec else kernel.PAIR_LAUNCHES
        other = kernel.PAIR_LAUNCHES if spec else kernel.SPEC_LAUNCHES
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu, per_phase = counted_pipeline(
            counts, phases=phases, params=params, device="cuda",
            profile=True, carry_engine=carry, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts["float64"]
        calls = (launch.STATS["spec"]["calls"] if spec
                 else launch.STATS["calls"])
        bad = [k for k in range(PIPE_N)
               if not same_run(gpu.runs[k].result, cpu.runs[k].result)]
        if bad:
            fail(f"pipeline {label}: phases {bad} differ from the cpu run")
        want = [False] + [True] * (PIPE_N - 1)
        flags = dict(csr_reused=[r.csr_reused for r in gpu.runs],
                     warm_started=[r.warm_started for r in gpu.runs],
                     engine_carried=[r.engine_carried for r in gpu.runs])
        if (flags["csr_reused"] != want or flags["warm_started"] != want
                or flags["engine_carried"] != (want if carry
                                               else [False] * PIPE_N)):
            fail(f"pipeline {label}: flags {flags}")
        if (n == 0 or n != calls or min(per_phase) == 0
                or sum(kernel.LAUNCHES.values()) or sum(other.values())):
            fail(f"pipeline {label}: launches {n} ({per_phase}) vs calls "
                 f"{calls}, full-tile {kernel.LAUNCHES}, pair "
                 f"{kernel.PAIR_LAUNCHES}, window {kernel.SPEC_LAUNCHES}")
        stages = [{k: sum(t[k] for t in r.result.stage_timings)
                   for k in ("score", "commit")} for r in gpu.runs]
        out[label] = dict(
            cuda_s=wall, kernel="window" if spec else "pair", launches=n,
            calls=calls, scorer_s=(launch.STATS["spec"]["seconds"] if spec
                                   else launch.STATS["seconds"]),
            flags=flags,
            phase_s=[r.seconds for r in gpu.runs],
            phase_transfers=[r.result.transfers for r in gpu.runs],
            phase_launches=per_phase, phase_stage_s=stages,
            max_work=[[float(r.result.max_work[0]),
                       float(r.result.max_work[-1])] for r in gpu.runs])
        print(f"pipeline {label}: {PIPE_N} phases identical to cpu; "
              f"transfers {out[label]['phase_transfers']}, "
              f"{out[label]['kernel']} launches {per_phase} (= {n} calls); "
              f"phase seconds "
              f"{out[label]['phase_s']}; score/commit {stages}; wall cuda "
              f"{wall!r} s, cpu {cpu_s!r} s", flush=True)
    return out


# ----------------------------------------- 4d. the asynchronous balancer
def same_async(a, b) -> bool:
    """``same_run`` plus the event trace, the message and protocol
    counters and everything the fault harness records."""
    import dataclasses
    fs = [None if r.fault_stats is None
          else dataclasses.asdict(r.fault_stats) for r in (a, b)]
    return (same_run(a, b) and a.events == b.events
            and fs[0] == fs[1] and all(
                getattr(a, f) == getattr(b, f)
                for f in ("messages", "sim_time", "lock_conflicts",
                          "yields", "grant_chains", "timeouts",
                          "retries_exhausted", "recovery_log",
                          "dead_ranks", "joined_ranks")))


def async_path(torch, kernel, launch, sync_run) -> dict:
    """``ccm_lb_async`` of the JAX package's ``benchmarks/ccmlb_async.py``
    instance ``scaling_phase(256)`` (``CCMParams(delta=1e-9)``,
    ``MAIN_KW``) on the card at each of ``ASYNC_LATENCIES``: at zero
    latency equal to the sync ``ccm_lb`` card run of the same phase,
    params and knobs (``sync_run``, main_path's f64 solo, whose knobs are
    these); the uniform run is the profiled one.  The other latencies'
    runs are held to the CPU's, event trace and counters included, on
    the benchmark's ``scaling_phase(FAULT_RANKS)`` instance (the CPU's
    256-rank runs took 31.7 s of the smoke's wall).  Then
    ``benchmarks/ccmlb_fault.py``'s ``crash`` and ``crash_then_join`` at
    ``FAULT_RANKS`` ranks under ``FAULT_LAT``, each equal to the CPU's.
    Pair launches, counted from zero just before each card run and read
    just after, must equal its scorer calls and be more than zero, with no
    full-tile or window launch."""
    import dataclasses

    from repro_torch.core import (CCMParams, FaultSpec, RankJoin,
                                  ccm_lb_async, initial_assignment,
                                  scaling_phase)
    params = CCMParams(delta=1e-9)
    if params != sync_run.state.params:
        fail("async_path: main_path's f64 solo run has other params")
    big = scaling_phase(256)
    small = scaling_phase(FAULT_RANKS)
    runs = {}
    cases = [(f"256 ranks, latency {lat!r}", big, dict(latency=lat))
             for lat in (ASYNC_LATENCIES[0], ASYNC_LATENCIES[-1])]
    cases += [(f"{FAULT_RANKS} ranks, latency {lat!r}", small,
               dict(latency=lat)) for lat in ASYNC_LATENCIES[1:]]
    cases += [(f"{FAULT_RANKS} ranks, crash", small, dict(
                  latency=FAULT_LAT, fault=FaultSpec(kill=((3, 1, 0.5),),
                                                     seed=19))),
              (f"{FAULT_RANKS} ranks, crash_then_join", small, dict(
                  latency=FAULT_LAT, fault=FaultSpec(kill=((3, 1, 0.5),),
                                                     seed=31),
                  membership=(RankJoin(iteration=2, count=1),)))]
    for label, phase, kw in cases:
        a0 = initial_assignment(phase)
        kw = dict(MAIN_KW, seed=0, collect_trace=True, **kw)
        zero = kw["latency"] == 0.0
        held = not zero and phase is small
        cpu_s = None
        if held:
            t0 = time.perf_counter()
            want = ccm_lb_async(phase, a0, params, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
        got = []

        def run():
            got.append(ccm_lb_async(phase, a0, params, device="cuda", **kw))

        kernel.reset_launches()
        launch.reset_stats()
        prof = None
        if kw["latency"] == ASYNC_LATENCIES[-1] and phase is big:
            prof = profiled_run(torch, run)
            wall = prof["wall_s"]
        else:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        gpu = got[0]
        n = kernel.PAIR_LAUNCHES["float64"]
        n_spec = sum(kernel.SPEC_LAUNCHES.values())
        if zero:
            if not (same_run(gpu, sync_run)
                    and gpu.lock_conflicts == gpu.yields == 0):
                fail(f"async {label}: differs from the sync card run")
        elif held and not same_async(gpu, want):
            fail(f"async {label}: cuda run differs from the cpu run")
        if (n == 0 or n != launch.STATS["calls"]
                or sum(kernel.LAUNCHES.values()) or n_spec):
            fail(f"async {label}: pair launches {n} vs scorer calls "
                 f"{launch.STATS['calls']}, full-tile {kernel.LAUNCHES}, "
                 f"window {kernel.SPEC_LAUNCHES}")
        fs = (None if gpu.fault_stats is None
              else {k: v for k, v in dataclasses.asdict(
                  gpu.fault_stats).items() if v})
        if "fault" in kw and (gpu.dead_ranks != [3]
                              or (gpu.assignment == 3).any()
                              or not fs.get("recovered_tasks")):
            fail(f"async {label}: dead {gpu.dead_ranks}, fault stats {fs}")
        if "membership" in kw and (gpu.joined_ranks != [FAULT_RANKS] or not
                                   (gpu.assignment == FAULT_RANKS).any()):
            fail(f"async {label}: joined {gpu.joined_ranks}")
        runs[label] = dict(
            ranks=phase.num_ranks, cuda_s=wall, cpu_s=cpu_s,
            profiled=prof is not None, transfers=gpu.transfers,
            launches=n, spec_launches=n_spec,
            score_events_s=launch.STATS["seconds"],
            events=len(gpu.events), messages=gpu.messages,
            sim_time=gpu.sim_time, lock_conflicts=gpu.lock_conflicts,
            yields=gpu.yields, timeouts=gpu.timeouts, fault_stats=fs,
            dead_ranks=gpu.dead_ranks, joined_ranks=gpu.joined_ranks,
            max_work=[float(gpu.max_work[0]), float(gpu.max_work[-1])])
        if prof is not None:
            runs[label].update(
                device_idle_share=prof["device_idle_share"],
                device_idle_share_bounds=prof["device_idle_share_bounds"],
                device_busy_ms=prof["device_busy_ms"])
        same = ("identical to the sync card run; " if zero
                else "identical to cpu; " if held else "")
        print(f"async {label}: {same}"
              f"{gpu.transfers} transfers, {n} pair launches, "
              f"{len(gpu.events)} events, {gpu.lock_conflicts} conflicts; "
              f"wall cuda {wall!r} s{' (profiled)' if prof else ''}, cpu "
              f"{cpu_s!r} s; fault stats {fs}"
              + (f"; device idle {prof['device_idle_share']!r} "
                 f"(bounds {prof['device_idle_share_bounds']})"
                 if prof else ""), flush=True)
    return runs


# ------------------------------------- 4e. the MILP certification (Fig. 4a)
def milp_path(torch, kernel, launch) -> dict:
    """The paper's Fig. 4a on the card, as the JAX package's
    ``benchmarks/milp_vs_ccmlb.py`` runs it: ``random_phase(7, 4 ranks,
    14 tasks, 4 blocks, 16 comms, mem_cap=5e8)`` from ``initial_assignment``
    at each delta of ``MILP_DELTAS``.  ``MILP_SEEDS`` CCM-LB runs
    (``MILP_KW``) on the card, each equal to the port's CPU run
    (assignment, transfer log and count, max-work trace), their pair
    launches counted from zero just before the card runs and read just
    after (more than zero, equal to the scorer calls, no full-tile or
    window launch).  Then ``solve_milp(build_fwmp_reduced(...))`` (host
    numpy) with ``max_nodes=MILP_NODES`` (``MILP_DELTA0_NODES`` at delta
    0, whose solves reach any limit) and a wall-clock limit no solve
    reaches, without and with the card runs' best W_max as
    ``incumbent_obj``; each solve must end by optimality or at the node
    limit, and a certified optimum must not lie above CCM-LB's best."""
    import numpy as np

    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  random_phase)
    from repro_torch.core.milp import build_fwmp_reduced, solve_milp
    phase = random_phase(7, **MILP_PHASE)
    a0 = initial_assignment(phase)
    out = {}
    for delta in MILP_DELTAS:
        params = CCMParams(alpha=1.0, beta=1e-9, gamma=1e-11, delta=delta)
        t0 = time.perf_counter()
        cpu = [ccm_lb(phase, a0, params, device="cpu", seed=s, **MILP_KW)
               for s in range(MILP_SEEDS)]
        cpu_s = time.perf_counter() - t0
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        gpu = [ccm_lb(phase, a0, params, device="cuda", seed=s, **MILP_KW)
               for s in range(MILP_SEEDS)]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        n = kernel.PAIR_LAUNCHES["float64"]
        bad = [s for s in range(MILP_SEEDS) if not same_run(gpu[s], cpu[s])]
        if bad:
            fail(f"milp delta {delta!r}: card runs of seeds {bad} differ "
                 "from the cpu runs")
        if (n == 0 or n != launch.STATS["calls"]
                or sum(kernel.LAUNCHES.values())
                or sum(kernel.SPEC_LAUNCHES.values())):
            fail(f"milp delta {delta!r}: pair launches {n} vs scorer calls "
                 f"{launch.STATS['calls']}, full-tile {kernel.LAUNCHES}, "
                 f"window {kernel.SPEC_LAUNCHES}")
        works = [float(r.max_work[-1]) for r in gpu]
        best = min(works)
        milp = build_fwmp_reduced(phase, params)
        max_nodes = MILP_NODES if delta else MILP_DELTA0_NODES
        solves = {}
        for label, inc in (("no incumbent", np.inf),
                           ("ccm-lb incumbent", best)):
            t0 = time.perf_counter()
            res = solve_milp(milp, incumbent_obj=inc, max_nodes=max_nodes,
                             time_limit_s=MILP_NO_CLOCK)
            solve_s = time.perf_counter() - t0
            if res.status != "optimal" and res.nodes < max_nodes:
                fail(f"milp delta {delta!r}, {label}: ended {res.status} "
                     f"after {res.nodes} of {max_nodes} nodes")
            if res.status == "optimal" and \
                    res.objective > best * (1 + 1e-9):
                fail(f"milp delta {delta!r}, {label}: certified optimum "
                     f"{res.objective!r} above CCM-LB's best {best!r}")
            solves[label] = dict(
                status=res.status, objective=float(res.objective),
                lp_bound=float(res.lp_bound),
                best_bound=float(res.best_bound), nodes=res.nodes,
                seconds=solve_s)
        opt = [s["objective"] for s in solves.values()
               if s["status"] == "optimal"]
        if len(set(opt)) > 1:
            fail(f"milp delta {delta!r}: the two solves' optima differ "
                 f"{opt}")
        lp = solves["no incumbent"]["lp_bound"]
        gaps = [(w - lp) / lp for w in works]
        incr = [(w - opt[0]) / opt[0] for w in works] if opt else None
        out[f"{delta:g}"] = dict(
            ccmlb_runs=MILP_SEEDS, cuda_s=gpu_s, cpu_s=cpu_s,
            pair_launches=n, transfers=[r.transfers for r in gpu],
            ccmlb_best=best, ccmlb_worst=max(works),
            ccmlb_gap_to_lp=[min(gaps), max(gaps)],
            ccmlb_increase_over_optimum=(None if incr is None
                                         else [min(incr), max(incr)]),
            milp=solves)
        print(f"milp delta {delta:g}: {MILP_SEEDS} card CCM-LB runs "
              f"identical to cpu ({n} pair launches; wall cuda {gpu_s!r} s, "
              f"cpu {cpu_s!r} s), W_max {best!r}..{max(works)!r}, gap to "
              f"the LP bound {min(gaps):.3e}..{max(gaps):.3e}, increase over "
              f"the MILP optimum "
              + ("not certified" if incr is None
                 else f"{100 * min(incr):.2f}%..{100 * max(incr):.2f}%")
              + "; MILP "
              + "; ".join(f"{k}: {v['status']} W={v['objective']!r} "
                          f"LP bound {v['lp_bound']!r} nodes {v['nodes']} "
                          f"{v['seconds']:.2f} s host"
                          for k, v in solves.items()), flush=True)
    return out


# ---------------------------------------------- 4f. the three planners
def zipf_counts(rng, e_n, l_n=4, tokens=32768):
    """Router counts as the JAX package's ``benchmarks/expert_placement.py``
    draws them: zipf(1.4) over (l_n, e_n), each layer scaled to ``tokens``."""
    import numpy as np
    counts = rng.zipf(1.4, (l_n, e_n)).astype(np.float64)
    return counts / counts.sum(1, keepdims=True) * tokens


def same_expert_plan(a, b) -> bool:
    """Two placement plans: assignment, permutations, imbalances, max work,
    the transfer log and every ``ServingPlan`` array."""
    import numpy as np
    sa, sb = a.serving, b.serving
    return (np.array_equal(a.assignment, b.assignment)
            and np.array_equal(a.permutations, b.permutations)
            and a.imbalance_before == b.imbalance_before
            and a.imbalance_after == b.imbalance_after
            and a.max_work_before == b.max_work_before
            and a.max_work_after == b.max_work_after
            and a.replicated_blocks == b.replicated_blocks
            and a.lb_result.transfer_log == b.lb_result.transfer_log
            and np.array_equal(sa.replicas, sb.replicas)
            and np.array_equal(sa.routing_shares, sb.routing_shares)
            and np.array_equal(sa.hbm_bytes, sb.hbm_bytes)
            and sa.replicated_experts == sb.replicated_experts)


def same_stage_plan(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.assignment, b.assignment)
            and np.array_equal(a.stage_flops, b.stage_flops)
            and a.imbalance == b.imbalance and a.cut_bytes == b.cut_bytes
            and a.contiguous == b.contiguous)


def same_pack(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.assignment, b.assignment)
            and a.makespan_before == b.makespan_before
            and a.makespan_after == b.makespan_after
            and a.imbalance_after == b.imbalance_after)


def planner_path(torch, kernel, launch) -> dict:
    """The three planners on the card, each plan equal to the port's CPU
    plan, with the card's own memory as the HBM budget: expert placement
    of ``benchmarks/expert_placement.py``'s configurations (qwen3-moe and
    llama4-scout at published width, zipf(1.4) counts over (4, E), 16
    devices; one device at half speed), qwen with ``shards_per_expert=2,
    replicate=True``, ``plan_expert_placement_sequence`` over
    ``PLAN_WINDOWS`` drifting windows synchronously and with
    ``spec_window=8`` (held to the synchronous plan; the window kernel),
    stage plans of ``STAGE_ARCHS`` on 4 stages (each contiguous) and one
    stage schedule, and ``rebalance_sequences`` of 256 lognormal(0, 1.2)
    costs over 8 ranks, with and without a half-speed rank.  Each card
    plan's launches are counted from zero just before it and read just
    after: pair launches (window launches on the spec run) equal to the
    scorer calls and, but for the stage plans (whose stage 1 finds no move
    worth a lock), more than zero; no full-tile launch, none of the other
    kernel."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.balance import (plan_expert_placement,
                                     plan_expert_placement_sequence,
                                     plan_pipeline_stages,
                                     plan_pipeline_stages_schedule,
                                     rebalance_sequences)
    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    rng = np.random.default_rng(0)
    qwen = configs.get_config(SERVE_ARCH)
    scout = configs.get_config("llama4-scout-17b-a16e")
    qwen_counts = zipf_counts(rng, qwen.num_experts)
    scout_counts = zipf_counts(rng, scout.num_experts)
    straggler_counts = zipf_counts(rng, qwen.num_experts)
    speed = np.ones(16)
    speed[0] = 0.5
    seq = [qwen_counts]
    for _ in range(PLAN_WINDOWS - 1):
        nxt = seq[-1] * rng.lognormal(0.0, PLAN_DRIFT, qwen_counts.shape)
        seq.append(nxt / nxt.sum(1, keepdims=True)
                   * qwen_counts.sum(1)[:, None])
    costs = np.random.default_rng(0).lognormal(0, 1.2, 256)
    seq_speed = np.ones(8)
    seq_speed[0] = 0.5
    expert_kw = dict(hbm_budget_bytes=hbm, seed=0)
    cases = [
        ("experts qwen3-moe-30b-a3b", "placement", lambda **d:
         plan_expert_placement(qwen_counts, qwen, 16, **expert_kw, **d)),
        ("experts llama4-scout-17b-a16e", "placement", lambda **d:
         plan_expert_placement(scout_counts, scout, 16, **expert_kw, **d)),
        ("experts straggler", "placement", lambda **d:
         plan_expert_placement(straggler_counts, qwen, 16, rank_speed=speed,
                               **expert_kw, **d)),
        ("experts qwen replicated", "placement", lambda **d:
         plan_expert_placement(qwen_counts, qwen, 16, shards_per_expert=2,
                               replicate=True, **expert_kw, **d)),
        (f"experts sequence x{PLAN_WINDOWS}", "sequence", lambda **d:
         plan_expert_placement_sequence(seq, qwen, 16, **expert_kw, **d)),
        (f"experts sequence x{PLAN_WINDOWS}, spec_window=8", "sequence",
         lambda **d: plan_expert_placement_sequence(
             seq, qwen, 16, spec_window=8, **expert_kw, **d)),
    ]
    for arch in STAGE_ARCHS:
        cfg = configs.get_config(arch)
        cases.append((f"stages {arch}", "stages", lambda cfg=cfg, **d:
                      plan_pipeline_stages(cfg, 4, hbm_budget_bytes=hbm,
                                           **d)))
    cases += [
        (f"stage schedule {SERVE_ARCH} {STAGE_SCHEDULE}", "schedule",
         lambda **d: plan_pipeline_stages_schedule(
             qwen, 4, STAGE_SCHEDULE, hbm_budget_bytes=hbm, **d)),
        ("seqpack 256 on 8", "seqpack", lambda **d:
         rebalance_sequences(costs, 8, seed=0, **d)),
        ("seqpack 256 on 8, rank 0 at half speed", "seqpack", lambda **d:
         rebalance_sequences(costs, 8, rank_speed=seq_speed, seed=0, **d)),
    ]
    same = {"placement": same_expert_plan, "stages": same_stage_plan,
            "seqpack": same_pack,
            "sequence": lambda a, b: len(a) == len(b) and all(
                map(same_expert_plan, a, b)),
            "schedule": lambda a, b: len(a) == len(b) and all(
                map(same_stage_plan, a, b))}
    out, cpu_plans = {}, {}
    for label, kind, plan in cases:
        spec = "spec_window" in label
        t0 = time.perf_counter()
        # the spec run is held to the synchronous sequence's cpu plan
        want = (cpu_plans[label.split(",")[0]] if spec
                else plan(device="cpu"))
        cpu_s = None if spec else time.perf_counter() - t0
        cpu_plans[label] = want
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        got = plan(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, other = ((kernel.SPEC_LAUNCHES, kernel.PAIR_LAUNCHES) if spec
                         else (kernel.PAIR_LAUNCHES, kernel.SPEC_LAUNCHES))
        n = counts["float64"]
        calls = (launch.STATS["spec"]["calls"] if spec
                 else launch.STATS["calls"])
        if not same[kind](got, want):
            fail(f"planner {label}: card plan differs from the cpu plan")
        # a stage plan makes no lock event: its stage 1 finds no move
        # worth a lock (the reference's too; ROADMAP queue 3)
        if ((n == 0 and kind not in ("stages", "schedule")) or n != calls
                or sum(kernel.LAUNCHES.values()) or sum(other.values())):
            fail(f"planner {label}: launches {n} vs calls {calls}, "
                 f"full-tile {kernel.LAUNCHES}, pair {kernel.PAIR_LAUNCHES},"
                 f" window {kernel.SPEC_LAUNCHES}")
        plans = got if isinstance(got, list) else [got]
        if kind in ("stages", "schedule") and not all(p.contiguous
                                                      for p in plans):
            fail(f"planner {label}: a stage plan is not contiguous "
                 f"{[p.assignment.tolist() for p in plans]}")
        if kind in ("placement", "sequence") and any(
                sorted(perm.tolist()) != list(range(perm.shape[0]))
                for p in plans for perm in p.permutations):
            fail(f"planner {label}: a slot permutation is not one")
        rec = dict(cuda_s=wall, cpu_s=cpu_s,
                   kernel="window" if spec else "pair", launches=n,
                   transfers=[p.lb_result.transfers for p in plans]
                   if kind in ("placement", "sequence") else None)
        if kind in ("placement", "sequence"):
            rec.update(
                imbalance=[[p.imbalance_before, p.imbalance_after]
                           for p in plans],
                max_work=[[p.max_work_before, p.max_work_after]
                          for p in plans],
                replicated_blocks=[p.replicated_blocks for p in plans],
                hbm_within_budget=all(p.serving.within_budget()
                                      for p in plans))
        elif kind == "seqpack":
            rec.update(makespan=[got.makespan_before, got.makespan_after],
                       imbalance=[got.imbalance_before, got.imbalance_after])
        else:
            rec.update(assignment=[p.assignment.tolist() for p in plans],
                       imbalance=[p.imbalance for p in plans],
                       cut_bytes=[p.cut_bytes for p in plans])
        out[label] = rec
        print(f"planner {label}: card plan identical to cpu; "
              f"{rec['kernel']} launches {n}; imbalance {rec['imbalance']}"
              f"; wall cuda {wall!r} s, cpu {cpu_s!r} s", flush=True)
    if not sum(r["launches"] for r in out.values()):
        fail("planner_path: no plan launched the pair kernel")
    out["hbm_budget_bytes"] = hbm
    return out


# ----------------------------------------------------------- 5. assembly
def tile_inputs(torch, rng, nr, nc, coincident=False):
    pr = rng.uniform(0.0, 2.0, (nr, 3))
    pc = rng.uniform(0.0, 2.0, (nc, 3))
    if coincident:
        pc[:nc // 2] = pr[:nc // 2]
    couple = rng.random((nr, nc)) < 0.7
    return (torch.tensor(pr, dtype=torch.float32, device="cuda"),
            torch.tensor(pc, dtype=torch.float32, device="cuda"),
            torch.tensor(couple, device="cuda"))


def check_assembly_kernel(torch, asm_ops, asm_ref, rng) -> float:
    """The assembly kernel against its plain version on the card; returns
    the largest absolute error of the direct mode."""
    from repro_torch.assembly.execute import TILE_BLOCK
    worst = 0.0
    n_cases = 0
    for nr, nc in ASM_SHAPES:
        for q in ASM_QUADS:
            t = tile_inputs(torch, rng, nr, nc, coincident=nr == nc)
            for mxu in (False, True):
                case = f"({nr}, {nc}) Q={q} mxu_distance={mxu}"
                got = asm_ops.assembly_tile(*t, quad_order=q,
                                            mxu_distance=mxu)
                others = [asm_ops.assembly_tile(
                    *t, quad_order=q, block_r=br, block_c=bc,
                    mxu_distance=mxu)
                    for br, bc in ((32, 64), (TILE_BLOCK, TILE_BLOCK))]
                want = asm_ref.reference_tile(*t, q, mxu_distance=mxu)
                torch.cuda.synchronize()
                if got.shape != (nr, nc) or got.dtype != torch.float32:
                    fail(f"assembly kernel shape/dtype {tuple(got.shape)} "
                         f"{got.dtype} at {case}")
                if not all(torch.equal(got, o) for o in others):
                    fail(f"assembly kernel: blocks (128, 128), (32, 64) and "
                         f"({TILE_BLOCK}, {TILE_BLOCK}) differ at {case}")
                if not (got.masked_select(~t[2]) == 0).all():
                    fail(f"assembly kernel: uncoupled entry not 0 at {case}")
                if mxu:
                    rel = ((got - want).abs()
                           / (want.abs() + 1e-3)).max().item()
                    if not rel < 2e-2:
                        fail(f"assembly kernel: relative error {rel} at "
                             f"{case}")
                else:
                    try:
                        torch.testing.assert_close(got, want, rtol=1e-5,
                                                   atol=1e-4)
                    except AssertionError as err:
                        fail(f"assembly kernel != plain version at {case}: "
                             f"{err}")
                    worst = max(worst, (got - want).abs().max().item())
                n_cases += 1
    print(f"assembly kernel == plain version on {n_cases} cases (direct: "
          f"rtol=1e-5, atol=1e-4; mxu_distance: relative error < 2e-2; "
          f"block shapes exactly equal); max_abs_err {worst!r}", flush=True)
    return worst


def check_real_tasks(torch, asm_ref, problem, per_quad: int = 3) -> float:
    """The application's own launch (``execute.tile_kernel``, 16 x 16
    tiles) against the plain version on real tasks of ``problem``: the
    first ``per_quad`` of each quad order and its largest; returns the
    largest absolute error."""
    from repro_torch.assembly.execute import _task_inputs, tile_kernel
    worst, n_cases = 0.0, 0
    for q in ASM_QUADS:
        tasks = [t for t in problem.tasks if t.quad_order == q]
        if not tasks:
            fail(f"real tasks: no task of quad order {q}")
        biggest = max(tasks, key=lambda t: len(t.rows) * len(t.cols))
        for t in tasks[:per_quad] + [biggest]:
            pr, pc, couple = _task_inputs(problem, t, torch.device("cuda"))
            got = tile_kernel(pr, pc, couple, q)
            want = asm_ref.reference_tile(pr, pc, couple, q)
            case = f"task ({len(t.rows)}, {len(t.cols)}) Q={q}"
            try:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            except AssertionError as err:
                fail(f"assembly kernel != plain version on {case}: {err}")
            worst = max(worst, (got - want).abs().max().item())
            n_cases += 1
    print(f"assembly kernel (the application's launch) == plain version on "
          f"{n_cases} real tasks (rtol=1e-5, atol=1e-4); max_abs_err "
          f"{worst!r}", flush=True)
    return worst


def signatures(problem) -> Counter:
    return Counter((len(t.rows), len(t.cols), t.quad_order)
                   for t in problem.tasks)


def spread(d) -> dict:
    import numpy as np
    med = float(np.median(d))
    return dict(min=float(d.min()), median=med, max=float(d.max()),
                max_over_median=float(d.max()) / med)


def count_launches(asm_kernel, problem, label: str) -> int:
    n = asm_kernel.LAUNCHES["float32"]
    want = 2 * problem.num_tasks + len(signatures(problem))
    if n == 0 or n != want:
        fail(f"{label}: {n} assembly-kernel launches, expected 2 x "
             f"{problem.num_tasks} tasks + {len(signatures(problem))} "
             f"signatures = {want}")
    return n


def same_plan(ha, hb) -> bool:
    return (ha is None) == (hb is None) and (
        ha is None or (ha.waves == hb.waves and ha.detours == hb.detours
                       and ha.total_bytes == hb.total_bytes))


def same_placement(a, b) -> bool:
    """Two runs balanced from the same predictions: the same predictions,
    CCM-LB placement and off-home copies, and the same baseline A."""
    import numpy as np
    return (np.array_equal(a.durations_pred, b.durations_pred)
            and np.array_equal(a.lb_result.assignment, b.lb_result.assignment)
            and a.lb_result.transfer_log == b.lb_result.transfer_log
            and a.lb_result.transfers == b.lb_result.transfers
            and a.lb_result.max_work == b.lb_result.max_work
            and a.n_off_home_ranks == b.n_off_home_ranks
            and a.makespan_baseline == b.makespan_baseline)


def home(run):
    """``plan_assembly_homing(run)`` and ``None``, or ``run`` and the
    reference's homing error."""
    from repro_torch.assembly import plan_assembly_homing
    try:
        return plan_assembly_homing(run), None
    except RuntimeError as err:
        if str(err) not in HOMING_FAULTS:
            raise
        return run, str(err)


def same_assembly_run(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a.lb_result.assignment, b.lb_result.assignment)
            and a.lb_result.transfer_log == b.lb_result.transfer_log
            and a.lb_result.transfers == b.lb_result.transfers
            and a.makespan_baseline == b.makespan_baseline
            and a.makespan_overdecomposed == b.makespan_overdecomposed
            and a.makespan_ccmlb == b.makespan_ccmlb
            and a.imbalance_before == b.imbalance_before
            and a.imbalance_after == b.imbalance_after
            and a.n_off_home_ranks == b.n_off_home_ranks
            and same_plan(a.homing, b.homing))


def run_summary(run, fault=None) -> dict:
    """A/B/C of a run; where homing raised ``fault``, C's homing time, its
    speedup and the waves are ``None`` and only C's compute is known."""
    homed = fault is None
    return dict(
        tasks=run.problem.num_tasks, transfers=run.lb_result.transfers,
        makespan_s=dict(A=run.makespan_baseline,
                        B=run.makespan_overdecomposed, C=run.makespan_ccmlb,
                        C_homing=(run.homing.est_time_s if run.homing
                                  else 0.0) if homed else None),
        speedup=dict(B=run.speedup_overdecomposed,
                     C=float(run.speedup_ccmlb) if homed else None,
                     C_compute=run.makespan_baseline / run.makespan_ccmlb),
        imbalance=[run.imbalance_before, run.imbalance_after],
        off_home_copies=run.n_off_home_ranks,
        homing_waves=(len(run.homing.waves) if run.homing else 0)
        if homed else None,
        homing_fault=fault, stage_s=run.stage_seconds)


def assembly_path(torch, asm_kernel, asm_ref, kernel, launch) -> dict:
    """The application at 8192 unknowns on 32 ranks, on the card."""
    import numpy as np
    from repro_torch.assembly import (balance_assembly, build_problem,
                                      run_assembly_comparison)
    from repro_torch.assembly.execute import measure_durations
    from repro_torch.costmodel import train_cost_model
    from repro_torch.costmodel.train import evaluate_cost_model
    out, runs, stage_s = {}, {}, {}
    scorer = 0

    # training data: every task of the 4096-unknown configuration, measured
    t0 = time.perf_counter()
    train_p = build_problem(4096, 16, task_limit_u=96, seed=1)
    feats = train_p.features()
    stage_s["train_build"] = time.perf_counter() - t0
    real_worst = check_real_tasks(torch, asm_ref, train_p)
    asm_kernel.reset_launches()
    t0 = time.perf_counter()
    durs = measure_durations(train_p, device="cuda")
    torch.cuda.synchronize()
    stage_s["train_measure"] = time.perf_counter() - t0
    n_train = count_launches(asm_kernel, train_p, "training data")
    if durs.shape != (train_p.num_tasks,) or not (np.isfinite(durs).all()
                                                  and (durs > 0).all()):
        fail("training data: durations not finite and positive")
    out["train_durations_s"] = spread(durs)

    # the cost model, trained on the card
    t0 = time.perf_counter()
    model, hist = train_cost_model(feats, durs, epochs=120, batch_size=128,
                                   alpha=0.3, reduce_to=int(0.7 * len(durs)),
                                   seed=0, device="cuda")
    torch.cuda.synchronize()
    stage_s["train_cost_model"] = time.perf_counter() - t0
    if model.net.out_w.device.type != "cuda":
        fail("cost model: not on the card")
    metrics = evaluate_cost_model(model, feats, durs)
    if not (np.isfinite(hist["loss"]).all() and hist["loss"][-1]
            < hist["loss"][0] and all(np.isfinite(v)
                                      for v in metrics.values())):
        fail(f"cost model: loss {hist['loss'][::30]} metrics {metrics}")
    out["cost_model"] = dict(metrics, loss_first=hist["loss"][0],
                             loss_last=hist["loss"][-1])

    # the target, measured, balanced on the model's predictions on the
    # card; homing is planned apart, after the placement is held against
    # the CPU's from the same predictions
    target_p = build_problem(8192, 32, task_limit_u=96, seed=2)
    asm_kernel.reset_launches()
    kernel.reset_launches()
    launch.reset_stats()
    t0 = time.perf_counter()
    bal_m = balance_assembly(8192, 32, task_limit_u=96, durations="measured",
                             cost_model=model, seed=2, device="cuda")
    torch.cuda.synchronize()
    stage_s["target_measured"] = time.perf_counter() - t0
    n_target = count_launches(asm_kernel, target_p, "target, measured")
    if kernel.PAIR_LAUNCHES["float64"] != launch.STATS["calls"] \
            or launch.STATS["calls"] == 0 or sum(kernel.LAUNCHES.values()):
        fail(f"target, measured: scorer pair launches {kernel.PAIR_LAUNCHES}"
             f" vs calls {launch.STATS['calls']}, full-tile launches "
             f"{kernel.LAUNCHES}")
    scorer += kernel.PAIR_LAUNCHES["float64"]
    d = bal_m.durations_true
    if not (np.isfinite(d).all() and (d > 0).all()
            and np.isfinite(bal_m.durations_pred).all()
            and bal_m.speedup_overdecomposed > 0
            and bal_m.makespan_ccmlb > 0):
        fail("target, measured: implausible durations or makespans")
    # CCM-LB and homing read only the predictions: balanced on the CPU from
    # the same model, the placement must be the card's, and homing must
    # give the same plan or raise the same error
    t0 = time.perf_counter()
    bal_c = balance_assembly(8192, 32, task_limit_u=96, durations="analytic",
                             cost_model=model, seed=2, device="cpu")
    stage_s["target_cpu_placement"] = time.perf_counter() - t0
    if not same_placement(bal_m, bal_c):
        fail("target, measured: the card's CCM-LB placement differs from "
             "the CPU's from the same predictions")
    run_m, homing_fault = home(bal_m)
    run_mc, cpu_fault = home(bal_c)
    if homing_fault != cpu_fault or not same_plan(run_m.homing,
                                                  run_mc.homing):
        fail(f"target, measured: homing on the card's placement "
             f"({homing_fault}) differs from the CPU's ({cpu_fault})")
    out["target_durations_s"] = spread(d)
    pred = run_m.durations_pred
    out["target_prediction"] = dict(
        rel_err_median=float(np.median(np.abs(pred - d) / d)),
        over_predict_frac=float(np.mean(pred >= d)))
    runs["measured"] = run_summary(run_m, homing_fault)

    # the target, analytic: the card's run equals the CPU's
    kernel.reset_launches()
    launch.reset_stats()
    run_a = run_assembly_comparison(8192, 32, task_limit_u=96,
                                    durations="analytic", seed=0,
                                    device="cuda")
    torch.cuda.synchronize()
    if kernel.PAIR_LAUNCHES["float64"] != launch.STATS["calls"] \
            or launch.STATS["calls"] == 0 or sum(kernel.LAUNCHES.values()):
        fail(f"target, analytic: scorer pair launches {kernel.PAIR_LAUNCHES}"
             f" vs calls {launch.STATS['calls']}, full-tile launches "
             f"{kernel.LAUNCHES}")
    scorer += kernel.PAIR_LAUNCHES["float64"]
    run_c = run_assembly_comparison(8192, 32, task_limit_u=96,
                                    durations="analytic", seed=0,
                                    device="cpu")
    if not same_assembly_run(run_a, run_c):
        fail("target, analytic: cuda run differs from the cpu run")
    got = dict(tasks=run_a.problem.num_tasks,
               transfers=run_a.lb_result.transfers,
               off_home=run_a.n_off_home_ranks,
               waves=len(run_a.homing.waves) if run_a.homing else 0)
    if got != ASM_EXPECT:
        fail(f"target, analytic: {got}, the reference gives {ASM_EXPECT}")
    runs["analytic"] = run_summary(run_a)
    runs["analytic"]["cpu_stage_s"] = run_c.stage_seconds

    sigs = signatures(train_p) + signatures(target_p)
    out.update(launches=n_train + n_target, scorer_launches=scorer,
               real_task_max_abs_err=real_worst,
               launches_by_run=dict(train=n_train, target=n_target),
               stage_s=stage_s, runs=runs, signatures=sigs,
               problems=(train_p, target_p))
    a = runs["analytic"]
    print(f"assembly: training data {train_p.num_tasks} tasks, "
          f"{n_train} launches, durations {out['train_durations_s']}",
          flush=True)
    print(f"assembly: cost model rel-err median "
          f"{metrics['rel_err_median']!r}, over-predict fraction "
          f"{metrics['over_predict_frac']!r}", flush=True)
    m = runs["measured"]
    print(f"assembly: target measured, {m['tasks']} tasks, {n_target} "
          f"launches, durations {out['target_durations_s']}; prediction "
          f"{out['target_prediction']}; placement == cpu placement; "
          f"makespans {m['makespan_s']}, speedups {m['speedup']}, imbalance "
          f"{m['imbalance']}, {m['transfers']} transfers, "
          f"{m['off_home_copies']} off-home copies, "
          + (f"{m['homing_waves']} waves (cpu: the same plan)"
             if homing_fault is None else
             f"homing raised '{homing_fault}' on the card's and the cpu's "
             f"placement alike (the reference's fault, ROADMAP queue 3)"),
          flush=True)
    print(f"assembly: target analytic, cuda == cpu; {a['tasks']} tasks, "
          f"speedups {a['speedup']}, imbalance {a['imbalance']}, "
          f"{a['transfers']} transfers, {a['off_home_copies']} off-home "
          f"copies, {a['homing_waves']} waves", flush=True)
    print(f"assembly: stage seconds {stage_s}; measured run "
          f"{m['stage_s']}; analytic cuda {a['stage_s']}", flush=True)
    return out


# ------------------------------------------------------------ 6. serving
def fold_heads(x, heads):
    """(B, S, H, hd) -> (B * H, S, hd), the kernel's layout."""
    b, s, _, hd = x.shape
    return x.transpose(1, 2).reshape(b * heads, s, hd).contiguous()


def check_flash_kernel(torch, flash_ops, flash_ref, rng) -> dict:
    """The flash kernel against its plain version on the card, and in bf16
    also against the plain model of its rounding; returns the largest
    absolute error per dtype (``bfloat16_p``: against the model)."""
    worst = {"bfloat16_p": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for case in FLASH_CASES:
            b, sq, skv, hq, hkv, hd, causal, window, cap = case
            q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                    device="cuda")
                       for shape in ((b, sq, hq, hd), (b, skv, hkv, hd),
                                     (b, skv, hkv, hd)))
            got = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window, softcap=cap)
            want = flash_ref.reference_attention(
                fold_heads(q, hq), fold_heads(k, hkv), fold_heads(v, hkv),
                causal=causal, window=window, softcap=cap)
            want = want.reshape(b, hq, sq, hd).transpose(1, 2)
            model = None
            if dtype == torch.bfloat16:
                model = tuple(
                    m.reshape(b, hq, sq, hd).transpose(1, 2)
                    for m in flash_ref.reference_attention_bf16_tiles(
                        fold_heads(q, hq), fold_heads(k, hkv),
                        fold_heads(v, hkv), causal=causal, window=window,
                        softcap=cap, slack=True))
            label = f"flash {name} {case}"
            err, err_p = hold_flash(torch, got, want, model, label)
            del model
            if not causal and window and sq > skv + window:
                dead = got[:, skv + window:]
                if not (dead == 0).all():
                    fail(f"{label}: rows that see no key are not 0")
            worst[name] = max(worst[name], err)
            worst["bfloat16_p"] = max(worst["bfloat16_p"], err_p)
            n_cases += 1
    # block-shape independence (float32, the reference's atol 1e-5)
    q, k, v = (torch.tensor(rng.standard_normal((1, 200, 4, 64)),
                            dtype=torch.float32, device="cuda")
               for _ in range(3))
    outs = [flash_ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in ((64, 64), (32, 32), (64, 17), (16, 64))]
    for o in outs[1:]:
        if not torch.allclose(o, outs[0], atol=1e-5, rtol=0):
            fail("flash: the result depends on the block shape")
    print(f"flash kernel == plain version on {n_cases} cases (float32 "
          f"atol=rtol=2e-5, bfloat16 2e-2; bfloat16 == the plain model of "
          f"its p rounding within {FLASH_P_TOL} beyond the model's slack "
          f"for p near a bf16 midpoint; float32 block shapes (64, "
          f"64), (32, 32), (64, 17), (16, 64) within 1e-5); max_abs_err "
          f"{worst}", flush=True)
    return worst


def hold_flash(torch, got, want, model, label: str) -> tuple:
    """Fails unless flash's ``got`` has ``want``'s shape and dtype and
    agrees with the plain version ``want`` at ``FLASH_TOL`` and, unless
    ``model`` is None, with the plain model of its bf16 p, ``model`` =
    (out, slack) float32 (``ref.reference_attention_bf16_tiles(...,
    slack=True)``), at ``FLASH_P_TOL`` beyond the slack; returns the
    largest absolute errors against each (0.0 without a model)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    tol = FLASH_TOL[dtype_name(got.dtype)]
    try:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    except AssertionError as err:
        fail(f"{label}: kernel != plain version: {err}")
    errs = [(got.float() - want.float()).abs().max().item(), 0.0]
    if model is not None:
        out, slack = model
        err = (got.float() - out).abs()
        over = err - slack - (FLASH_P_TOL["atol"]
                              + FLASH_P_TOL["rtol"] * out.abs())
        if over.max().item() > 0:
            at = int(over.argmax())
            fail(f"{label}: kernel != the plain model of its bf16 p: "
                 f"{int((over > 0).sum())} elements beyond {FLASH_P_TOL} "
                 f"and the model's slack, the worst {err.flatten()[at]!r} "
                 f"off (slack {slack.flatten()[at]!r})")
        errs[1] = err.max().item()
    return tuple(errs)


def check_gemm_kernel(torch, gemm_ops, gemm_ref, rng) -> dict:
    """The expert-GEMM kernel against its plain version on the card (no
    TF32 in the plain version); returns the largest absolute error per
    dtype."""
    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for e, c, d, f in GEMM_SHAPES:
            x = torch.tensor(rng.standard_normal((e, c, d)), dtype=dtype,
                             device="cuda")
            w = torch.tensor(rng.standard_normal((e, d, f)) / d ** 0.5,
                             dtype=dtype, device="cuda")
            got = gemm_ops.expert_gemm(x, w)
            worst[name] = max(worst[name], hold_gemm(
                torch, got, gemm_ref.reference_expert_gemm(x, w),
                f"expert_gemm {name} ({e}, {c}, {d}) x ({e}, {d}, {f})"))
            n_cases += 1
    print(f"expert_gemm kernel == plain version on {n_cases} cases (rtol "
          f"1e-5, atol 1e-4 in float32; rtol 3e-2, atol 3e-1 and within "
          f"{GEMM_P_TOL} in bfloat16); max_abs_err {worst}", flush=True)
    return worst


def hold_gemm(torch, got, want, label: str) -> float:
    """Fails unless the expert GEMM's ``got`` has ``want``'s shape and dtype
    and agrees with it at ``GEMM_TOL`` (rtol tol, atol 10 tol) and, in
    bf16, at ``GEMM_P_TOL``; returns the largest absolute error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    tol = GEMM_TOL[dtype_name(got.dtype)]
    tols = [dict(rtol=tol, atol=10 * tol)]
    if got.dtype == torch.bfloat16:
        tols.append(GEMM_P_TOL)
    for t in tols:
        try:
            torch.testing.assert_close(got.float(), want.float(), **t)
        except AssertionError as err:
            fail(f"{label}: kernel != plain version within {t}: {err}")
    return (got.float() - want.float()).abs().max().item()


class RouteLog:
    """Wraps ``repro_torch.models.moe.route``: records each call's router
    logits and top-k indices, or replays recorded top-k choices."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.calls, self.replay = [], None

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def __call__(self, x_flat, router_w, top_k):
        import torch
        probs, top_vals, top_idx = self.route(x_flat, router_w, top_k)
        if self.replay is not None:
            top_vals, top_idx = (t.to(x_flat.device)
                                 for t in self.replay.pop(0))
        self.calls.append(((x_flat.to(torch.float32) @ router_w).cpu(),
                           top_vals.cpu(), top_idx.cpu()))
        return probs, top_vals, top_idx


def route_flips(calls, ref_calls, top_k):
    """(tokens whose top-k set differs from the reference run's, of them
    those that rounding cannot explain: the reference's k-th and (k+1)-th
    router logits lie further apart than twice that token's largest logit
    change)."""
    import torch
    flips, unexplained = 0, 0
    for (lg, _, idx), (lg_r, _, idx_r) in zip(calls, ref_calls, strict=True):
        flipped = (torch.sort(idx, -1)[0] != torch.sort(idx_r, -1)[0]).any(-1)
        top = torch.sort(lg_r, -1, descending=True)[0]
        gap = top[:, top_k - 1] - top[:, top_k]
        drift = (lg - lg_r).abs().max(-1)[0]
        flips += int(flipped.sum())
        unexplained += int((flipped & (gap > 2 * drift)).sum())
    return flips, unexplained


def forced_logits(torch, model, params, tokens, media=None):
    """Prefill on ``tokens[:, :prompt]`` (after ``media``, the stub front
    end's inputs, where the model has one), then teacher-forced decode
    steps on the rest: the last-position logits of each, float32 on the
    CPU."""
    from repro_torch.launch.serve import decode_start, pad_caches
    prompt = tokens.shape[1] - CHECK_STEPS
    cfg = model.cfg
    off = decode_start(cfg, 0)
    t = torch.as_tensor(tokens, dtype=torch.int64, device=model.device)
    batch = {"tokens": t[:, :prompt]}
    for key, value in (media or {}).items():
        batch[key] = torch.as_tensor(value, device=model.device)
    with torch.inference_mode():
        caches, logits = model.prefill_fn(params, batch)
        caches = pad_caches(caches, off + tokens.shape[1], cfg)
        out = [logits[:, 0].float().cpu()]
        for i in range(CHECK_STEPS):
            caches, logits = model.decode_fn(
                params, caches, t[:, prompt + i:prompt + i + 1],
                off + prompt + i)
            out.append(logits[:, 0].float().cpu())
    return out


def contract_errors(torch, got, want):
    """The serving contract (``tests/test_decode_parity.py``) on each step:
    normalised log-probs within ``atol=0.07, rtol=0.05`` and argmax equal.
    Returns (all steps met it, per-step max abs error, per-step worst
    excess over the tolerance)."""
    ok, errs, excess = True, [], []
    for g, w in zip(got, want, strict=True):
        g = g - g.max(-1, keepdim=True)[0]
        w = w - w.max(-1, keepdim=True)[0]
        diff = (g - w).abs()
        errs.append(diff.max().item())
        over = (diff - (0.07 + 0.05 * w.abs())).max().item()
        excess.append(over)
        ok = ok and over <= 0 and bool((g.argmax(-1) == w.argmax(-1)).all())
    return ok, errs, excess


class StepClock:
    """Wraps a model's prefill and decode functions with CUDA events, and
    keeps the prefill logits."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.prefill, self.decode = model.prefill_fn, model.decode_fn
        self.events, self.logits = [], None
        model.prefill_fn, model.decode_fn = self._prefill, self._decode

    def _timed(self, kind, fn, *args):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self.events.append((kind, start, end))
        return out

    def _prefill(self, *args):
        out = self._timed("prefill", self.prefill, *args)
        self.logits = out[1]
        return out

    def _decode(self, *args):
        return self._timed("decode", self.decode, *args)

    def restore(self):
        self.model.prefill_fn, self.model.decode_fn = self.prefill, \
            self.decode

    def seconds(self, kind):
        return [s.elapsed_time(e) / 1e3 for k, s, e in self.events
                if k == kind]


def serve_on_card(torch, cfg, full_layers: int, prompt_len: int, want,
                  mods, batch_size: int = SERVE_BATCH, frames: int = 0):
    """``cfg`` served through ``serve_batch`` on the card: bf16 weights
    from the port's init (a seeded generator on the card), ``batch_size``
    prompts of ``prompt_len`` tokens (numpy seed 0) and, for a stub front
    end, its inputs drawn next (``serve.stub_media``; ``frames`` encoder
    frames), ``SERVE_NEW`` new tokens, after a short warm-up.  Every kernel
    of ``mods`` has its launches counted from zero and its launch shapes
    logged; they must equal ``want`` ({kernel: (dtype, count)}, every other
    count 0).  The profile (``profile_decode``) covers
    ``PROFILE_DECODE_STEPS`` decode steps after a prefill of the same
    prompts.  Returns (numbers, model, params,
    the numpy generator, the front end's inputs as card tensors or
    None)."""
    import numpy as np

    from repro_torch.launch.serve import serve_batch, stub_media
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)                        # device "cuda"
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch_size, prompt_len))
    media = stub_media(cfg, batch_size, rng, frames)
    if media is not None:
        media = {k: torch.as_tensor(v, device="cuda")
                 for k, v in media.items()}
    serve_batch(model, params, prompts[:1, :16], 2,              # warm-up
                media and {k: v[:1] for k, v in media.items()})
    clock = StepClock(torch, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.reset_launches()
    with ShapeLog(mods) as log:
        t0 = time.perf_counter()
        tokens = serve_batch(model, params, prompts, SERVE_NEW, media)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: dict(mod.LAUNCHES) for name, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    clock.restore()
    expected = {name: {"bfloat16": 0, "float32": 0} for name in mods}
    for name, (dt, n) in want.items():
        expected[name][dt] = n
    if launches != expected:
        fail(f"serve {cfg.name}: launches {launches}, expected {expected}")
    if tokens.shape != (batch_size, SERVE_NEW) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size \
            or not torch.isfinite(clock.logits).all():
        fail(f"serve {cfg.name}: bad tokens {tokens.shape} or non-finite "
             "logits")
    prefill_s = clock.seconds("prefill")[0]
    decode_s = clock.seconds("decode")
    # the same prefill three times more, after the counted run (its
    # launches not counted): the spread of one prefill's time, and what of
    # the first one's is a one-off
    batch = {"tokens": torch.as_tensor(prompts, device="cuda"),
             **(media or {})}
    again = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        model.prefill_fn(params, batch)
        end.record()
        end.synchronize()
        again.append(start.elapsed_time(end) / 1e3)
    del batch
    layers = (f"{cfg.num_layers} of {full_layers}"
              if isinstance(full_layers, int) else full_layers)
    out = dict(
        arch=cfg.name, layers=layers,
        q_heads=cfg.num_heads, params=n_params, batch=batch_size,
        prompt=prompt_len, new_tokens=SERVE_NEW, init_s=init_s, wall_s=wall,
        prefill_s=prefill_s, prefill_again_s=again,
        decode_step_s_median=float(np.median(decode_s)),
        decode_step_s_min=min(decode_s), decode_step_s_max=max(decode_s),
        tokens_per_s=batch_size * SERVE_NEW / wall,
        decode_tokens_per_s=batch_size * len(decode_s) / sum(decode_s),
        peak_memory_gb=peak / 1e9, launches=launches,
        shapes={name: [[list(k), n] for k, n in c.most_common()]
                for name, c in log.shapes.items() if c},
        log_shapes=log.shapes)
    print(f"serve: {cfg.name}, {layers} layers, "
          f"{n_params} parameters (bf16, init on the card {init_s:.2f} s); "
          f"{batch_size} requests x {prompt_len}-token prompts"
          f"{' after ' + str(frames) + ' encoder frames' if frames else ''}"
          f"{' after the media' if cfg.frontend == 'vision' else ''}, "
          f"{SERVE_NEW} new tokens: prefill {prefill_s!r} s (then "
          f"{again!r} s), decode step "
          f"median {out['decode_step_s_median']!r} s, {out['tokens_per_s']!r}"
          f" tokens/s over {wall!r} s, peak memory {peak / 1e9!r} GB; "
          f"launches {want}", flush=True)
    t0 = time.perf_counter()
    out["profile"] = profile_decode(torch, model, params, prompts, media)
    out["profile"]["seconds"] = time.perf_counter() - t0
    print(json.dumps({"serve_profile": {cfg.name: out["profile"]}}),
          flush=True)
    return out, model, params, rng, media


def serve_path(torch, mods) -> dict:
    """``qwen3-moe-30b-a3b`` at its published width, depth cut to
    ``SERVE_LAYERS`` of 48, served through ``serve_batch`` on the card
    (exactly one flash launch per layer and three expert-GEMM launches per
    layer and forward); then the first ``SERVE_CHECK_LAYERS`` layers of
    the same weights on the CPU against the card, teacher-forced."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import build_model

    # the router is a float32 product: TF32 would move its near-ties, so it
    # stays off (as it is by default) for every float32 product here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = configs.get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS)
    want = {"flash": ("bfloat16", SERVE_LAYERS),
            "gemm": ("bfloat16", 3 * SERVE_LAYERS * (1 + SERVE_NEW))}
    out, model, params, rng, _ = serve_on_card(torch, cfg, full.num_layers,
                                               SERVE_PROMPT, want, mods)

    # the served weights' first SERVE_CHECK_LAYERS layers on the CPU
    # against the card, teacher-forced: in bf16 (the served weights), then
    # in float32 (the same values, widened)
    check = rng.integers(0, cfg.vocab_size, (1, CHECK_PROMPT + CHECK_STEPS))
    ccfg = dataclasses.replace(full, num_layers=SERVE_CHECK_LAYERS)
    cparams = dict(params, blocks=params["blocks"][:SERVE_CHECK_LAYERS])
    bf = card_vs_cpu(torch, ccfg, build_model(ccfg, dtype=model.dtype),
                     cparams, check)
    if bf["router_flips_unexplained"] or bf["pinned"]["max_excess"] > 0 \
            or bf["pinned"]["argmax_unexplained"]:
        fail(f"card vs cpu, bf16: a difference that rounding does not "
             f"explain (a kernel fault): {bf}")
    wide = build_model(ccfg, dtype=torch.float32)
    wide_params = tree_map(lambda t: t.to(torch.float32), cparams)
    f32 = card_vs_cpu(torch, ccfg, wide, wide_params, check)
    del wide_params, cparams
    torch.cuda.empty_cache()
    if not f32["contract_met"]:
        fail(f"card vs cpu, float32: serving contract missed: {f32}")
    out["card_vs_cpu"] = {"bfloat16": bf, "float32": f32}
    # the expert re-placement loop on the served weights, before they go
    out["replacement"] = replacement_loop(torch, cfg, model, params, mods)
    return out


def prefill_stats(torch, cfg, params, tokens):
    """One prefill of ``tokens`` through ``transformer.run_stack`` that
    keeps its router statistics (``lm_prefill`` drops them): the
    last-position logits (B, V) float32 and the expert counts (one row per
    period of the block pattern, E), both on the CPU."""
    from repro_torch.models import transformer as tf
    with torch.inference_mode():
        x, positions = tf.lm_inputs(params, {"tokens": tokens}, cfg)
        x, stats, _ = tf.run_stack(params, x, positions, cfg)
        x = tf.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = tf.unembed(params, x[:, -1:], cfg)[:, 0]
    return logits.float().cpu(), stats["expert_counts"].cpu()


def rows_contract(torch, got, want) -> dict:
    """``compare_steps`` with each row of (B, V) logits as a step."""
    return compare_steps(torch, list(got.split(1)), list(want.split(1)))


def replacement_loop(torch, cfg, model, params, mods) -> dict:
    """The JAX package's ``launch/train.py::rebalance_experts`` flow on the
    weights ``serve_path`` has just served: one prefill of the served
    prompts through ``run_stack`` (router counts, one row per layer), an
    expert placement of those counts on 16 devices planned on the card
    (the card's memory as the HBM budget), the plan's slot permutations
    applied to every MoE layer on the card, and the same prefill again.

    Only the order in which the card's ``index_add_`` sums a token's expert
    outputs moves with the slots (the per-expert GEMMs are the same), and
    in bf16 that can move a later layer's near-tied top-k selection; the
    same prefill of the unpermuted weights, repeated, shows how much of it
    the card's unordered sums give anyway (reported, not held).  Held: the
    second run's counts are the first's permuted, exactly on the first
    layer (its router sees the same input) and on later layers unless
    every top-k selection that moved sits at a near tie (``route_flips``).
    That check of layers 1 to 7 cannot catch a wrongly permuted layer: a
    wrong permutation moves the router logits far, and ``route_flips``
    then calls every moved selection a near tie.  The permuted weights of
    those layers are held by the logits alone: a third prefill of the
    permuted weights, its routing pinned to the first run's selections in
    slot numbering, always runs, and its last-position logits must meet
    the serving contract against the first's (``rows_contract``: an
    argmax may differ only at a near tie); a token sent to a wrong expert
    would miss it.  The second run's logits must meet it too, unless a
    selection moved.  Each prefill launches exactly ``SERVE_LAYERS`` flash
    kernels and three expert GEMMs a layer, in bf16, and the plan the pair
    kernel; ``launches`` sums the counts read after every prefill the loop
    ran."""
    import numpy as np

    from repro_torch.balance import (apply_expert_permutation,
                                     plan_expert_placement)
    from repro_torch.configs.base import BLOCK_MOE
    from repro_torch.kernels.ccm_scorer import kernel as scorer
    from repro_torch.models import moe
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))   # serve_on_card's
    tokens = torch.as_tensor(prompts, device=model.device)
    want = {"flash": SERVE_LAYERS, "gemm": 3 * SERVE_LAYERS}
    ran = {k: 0 for k in want}     # launches read after each prefill, summed
    prefills = []

    def counted_prefill(p, label, replay=None):
        for mod in mods.values():
            mod.reset_launches()
        with RouteLog(moe) as routes:
            routes.replay = replay
            logits, counts = prefill_stats(torch, cfg, p, tokens)
        torch.cuda.synchronize()
        got = {k: dict(mods[k].LAUNCHES) for k in want}
        if any(got[k] != {"bfloat16": n, "float32": 0}
               for k, n in want.items()) or any(
                sum(mods[k].LAUNCHES.values()) for k in mods
                if k not in want):
            fail(f"re-placement {label} prefill: launches {got}, expected "
                 f"{want} in bf16 and nothing else")
        for k in want:
            ran[k] += got[k]["bfloat16"]
        prefills.append(label)
        return logits, counts, routes.calls

    logits0, counts0, calls0 = counted_prefill(params, "first")
    if counts0.shape != (SERVE_LAYERS, cfg.num_experts) or \
            not torch.isfinite(logits0).all():
        fail(f"re-placement: counts {tuple(counts0.shape)}, logits finite "
             f"{bool(torch.isfinite(logits0).all())}")
    logits_r, counts_r, calls_r = counted_prefill(params, "repeated")
    repeat = dict(counts_equal=bool(torch.equal(counts_r, counts0)),
                  router_flips=route_flips(calls_r, calls0, cfg.top_k)[0],
                  **rows_contract(torch, logits_r, logits0))
    counts = counts0.numpy().astype(np.float64)
    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    scorer.reset_launches()
    t0 = time.perf_counter()
    plan = plan_expert_placement(counts, cfg, 16, hbm_budget_bytes=hbm,
                                 device="cuda")
    plan_s = time.perf_counter() - t0
    n_pair = scorer.PAIR_LAUNCHES["float64"]
    if n_pair == 0 or sum(scorer.LAUNCHES.values()) \
            or sum(scorer.SPEC_LAUNCHES.values()):
        fail(f"re-placement plan: pair launches {scorer.PAIR_LAUNCHES}, "
             f"full-tile {scorer.LAUNCHES}, window {scorer.SPEC_LAUNCHES}")
    perms = [torch.as_tensor(p) for p in plan.permutations]
    period = cfg.pattern_period
    placed = dict(params, blocks=[
        dict(b, moe=apply_expert_permutation(b["moe"], perms[i // period]))
        if kind == BLOCK_MOE else b
        for i, (b, kind) in enumerate(zip(params["blocks"],
                                          cfg.layer_kinds()))])
    logits1, counts1, calls1 = counted_prefill(placed, "second")
    exact = [bool(torch.equal(counts1[r], counts0[r][p]))
             for r, p in enumerate(perms)]
    # the second run's routings in the first run's expert numbering
    mapped = [(lg[:, torch.argsort(p)], vals, p[idx])
              for (lg, vals, idx), p in zip(calls1, perms, strict=True)]
    flips, unexplained = route_flips(mapped, calls0, cfg.top_k)
    if not exact[0] or (not all(exact) and unexplained):
        fail(f"re-placement: counts not permuted (exact per layer {exact};"
             f" {flips} top-k selections moved, {unexplained} not at a "
             "near tie)")
    contract = rows_contract(torch, logits1, logits0)
    # the first run's selections, in slot numbering
    inv = [torch.argsort(p) for p in perms]
    replay = [(vals, q[idx]) for (_, vals, idx), q
              in zip(calls0, inv, strict=True)]
    logits_p, _, _ = counted_prefill(placed, "pinned", replay)
    pinned = rows_contract(torch, logits_p, logits0)
    missed = contract["max_excess"] > 0 or contract["argmax_unexplained"]
    if (missed and not flips) or pinned["max_excess"] > 0 \
            or pinned["argmax_unexplained"]:
        fail(f"re-placement: logits outside the serving contract against "
             f"the first prefill ({contract}; {flips} top-k selections "
             f"moved) or with the routing pinned ({pinned})")
    del placed
    torch.cuda.empty_cache()
    out = dict(counts_shape=list(counts0.shape), counts_exact=exact,
               router_flips=flips, router_flips_unexplained=unexplained,
               imbalance=[plan.imbalance_before, plan.imbalance_after],
               max_work=[plan.max_work_before, plan.max_work_after],
               transfers=plan.lb_result.transfers,
               replicated_blocks=plan.replicated_blocks, plan_s=plan_s,
               pair_launches=n_pair, prefills=prefills, launches=ran,
               contract=contract, pinned=pinned, repeat=repeat)
    print(f"re-placement: counts {tuple(counts0.shape)} from the served "
          f"weights; plan on the card {plan_s!r} s, {n_pair} pair launches, "
          f"{plan.lb_result.transfers} transfers, imbalance "
          f"{plan.imbalance_before!r} -> {plan.imbalance_after!r}; second "
          f"prefill's counts permuted exactly per layer {exact} ({flips} "
          f"top-k selections moved, {unexplained} not at a near tie); "
          f"logits against the first prefill's {contract}; with the "
          f"routing pinned {pinned}; the unpermuted prefill repeated: "
          f"{repeat}; {len(prefills)} prefills {prefills} launched {ran} "
          f"({want} each)", flush=True)
    return out


def profile_decode(torch, model, params, prompts, media=None) -> dict:
    """The device's idle share over ``PROFILE_DECODE_STEPS`` greedy decode
    steps (``profiled_run``), after a prefill of ``prompts`` (and
    ``media``) whose caches are padded for them, and the eight kernels with
    the most device time.  Until phase 6c came the profile covered a whole
    ``serve_batch`` run (prefill and 32 decode steps, some 10^5 kernels for
    the recurrent models), whose events took the profiler 10-29 s a model
    to total on an H100 host; the prefill is out of this scope."""
    from repro_torch.launch.serve import decode_start, pad_caches
    cfg = model.cfg
    pos = decode_start(cfg, prompts.shape[1])
    with torch.inference_mode():
        caches, logits = model.prefill_fn(params, {
            "tokens": torch.as_tensor(prompts, device="cuda"),
            **(media or {})})
        caches = pad_caches(caches, pos + PROFILE_DECODE_STEPS, cfg)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()

        def steps():
            c, t = caches, tok
            for i in range(PROFILE_DECODE_STEPS):
                c, lg = model.decode_fn(params, c, t, pos + i)
                t = torch.argmax(lg[:, -1:], dim=-1)

        out = profiled_run(torch, steps)
    rows = out.pop("by_name")
    out["top"] = [list(kv) for kv in sorted(
        rows.items(), key=lambda kv: -kv[1]["device_ms"])[:8]]
    out["what"] = f"{PROFILE_DECODE_STEPS} decode steps after a prefill"
    return out


def compare_steps(torch, card, cpu) -> dict:
    """The card's teacher-forced logits against the CPU's: the serving
    contract per step, and each step whose argmax differs checked for a
    near tie (the CPU's top two logits closer than twice the step's largest
    logit error)."""
    ok, errs, excess = contract_errors(torch, card, cpu)
    gaps, argmax_eq, logit_err = [], [], []
    for g, w in zip(card, cpu, strict=True):
        top2 = torch.topk(w[0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        logit_err.append(float((g - w).abs().max()))
        argmax_eq.append(bool((g.argmax(-1) == w.argmax(-1)).all()))
    return dict(
        contract_met=ok, max_abs_err=errs, excess_over_tolerance=excess,
        max_excess=max(excess), argmax_equal=argmax_eq,
        max_abs_logit_err=logit_err, cpu_top2_gap=gaps,
        argmax_unexplained=sum(not a and gap > 2 * err for a, gap, err
                               in zip(argmax_eq, gaps, logit_err)))


def card_vs_cpu(torch, cfg, model, params, check, media=None) -> dict:
    """``model`` with ``params`` on the card against the same weights on the
    CPU, on ``check`` teacher-forced (``compare_steps``) after ``media``
    (the stub front end's inputs, numpy) where the model has one.  Where
    the model routes tokens to experts, also the top-k router selections
    that differ (and how many of them rounding explains), and the steps
    compared again with the card's routing pinned to the CPU's."""
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    label = f"{cfg.name} {dtype_name(model.dtype)}"
    with RouteLog(moe) as card_routes:
        card = forced_logits(torch, model, params, check, media)
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_model = build_model(cfg, device="cpu", dtype=model.dtype)
    with RouteLog(moe) as cpu_routes:
        cpu = forced_logits(torch, cpu_model, cpu_params, check, media)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    out = dict(layers=cfg.num_layers, prompt=check.shape[1] - CHECK_STEPS,
               steps=CHECK_STEPS, **compare_steps(torch, card, cpu))
    routing = ""
    if cpu_routes.calls:
        flips, unexplained = route_flips(card_routes.calls, cpu_routes.calls,
                                         cfg.top_k)
        with RouteLog(moe) as pinned:
            pinned.replay = [(c[1], c[2]) for c in cpu_routes.calls]
            card_pinned = forced_logits(torch, model, params, check,
                                        media)
        p = out["pinned"] = compare_steps(torch, card_pinned, cpu)
        out.update(
            router_tokens=sum(int(c[2].shape[0]) for c in cpu_routes.calls),
            router_flips=flips, router_flips_unexplained=unexplained)
        routing = (
            f"; top-k selections differing in {flips} of "
            f"{out['router_tokens']} token routings ({unexplained} not "
            f"explained by rounding); with the card's routing pinned to the "
            f"cpu's: contract {'met' if p['contract_met'] else 'MISSED'}, "
            f"max abs error {p['max_abs_err']}, argmax equal "
            f"{p['argmax_equal']} (cpu top-two gaps {p['cpu_top2_gap']})")
    out["cpu_s"] = cpu_s
    print(f"card vs cpu, {label} ({cfg.num_layers} layers, {out['prompt']}"
          f"-token prompt, {CHECK_STEPS} teacher-forced steps): serving "
          f"contract {'met' if out['contract_met'] else 'MISSED'}; max abs "
          f"error of normalised log-probs per step {out['max_abs_err']}; "
          f"argmax equal {out['argmax_equal']} (cpu top-two gaps "
          f"{out['cpu_top2_gap']}, max logit errors "
          f"{out['max_abs_logit_err']}){routing}; cpu {cpu_s:.1f} s",
          flush=True)
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ------------------------------------------------------- 7b. the training path
def rel_err(torch, got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def check_flash_bwd(torch, flash_kernel, flash_ops, flash_ref) -> dict:
    """The flash backward kernel (through ``ops.flash_attention``'s
    autograd function: the forward kernel, then one backward launch)
    against autograd through the plain version in float32, on the same
    inputs (standard normal, drawn on the card from a seeded generator), at
    every ``FLASH_BWD_CASES`` shape in float32 and bf16: dq, dk, dv each within
    ``FLASH_BWD_TOL`` of its largest |value|.  Returns the largest absolute
    and relative errors per dtype."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = {"abs": 0.0, "rel": 0.0}
        for case in FLASH_BWD_CASES:
            b, sq, skv, hq, hkv, hd, causal, window, cap = case
            t = [torch.randn(shape, generator=gen, device="cuda")
                 .to(dtype).requires_grad_()
                 for shape in ((b, sq, hq, hd), (b, skv, hkv, hd),
                               (b, skv, hkv, hd))]
            d_out = torch.randn((b, sq, hq, hd), generator=gen,
                                device="cuda").to(dtype)
            n0 = flash_kernel.BWD_LAUNCHES[name]
            got = torch.autograd.grad(flash_ops.flash_attention(
                *t, causal=causal, window=window, softcap=cap), t, d_out)
            torch.cuda.synchronize()
            if flash_kernel.BWD_LAUNCHES[name] != n0 + 1:
                fail(f"flash backward {name} {case}: "
                     f"{flash_kernel.BWD_LAUNCHES[name] - n0} launches")
            fold = [fold_heads(x.detach().float(), h).requires_grad_()
                    for x, h in zip(t, (hq, hkv, hkv))]
            out = flash_ref.reference_attention(
                *fold, causal=causal, window=window, softcap=cap)
            want = torch.autograd.grad(out, fold,
                                       fold_heads(d_out.float(), hq))
            del out
            if flash_kernel.tc_backward(dtype, hd):
                m_err, l_err = hold_tc_backward(
                    torch, flash_kernel, flash_ref,
                    *(fold_heads(x.detach(), h)
                      for x, h in zip(t, (hq, hkv, hkv))),
                    fold_heads(d_out, hq), case)
                worst["bfloat16_model"] = max(
                    worst.get("bfloat16_model", 0.0), m_err)
                worst["bfloat16_lse"] = max(
                    worst.get("bfloat16_lse", 0.0), l_err)
            for g, w, h, what in zip(got, want, (hq, hkv, hkv), "qkv"):
                w = w.reshape(b, h, -1, hd).transpose(1, 2)
                if g.shape != w.shape or g.dtype != dtype \
                        or not torch.isfinite(g).all():
                    fail(f"flash backward {name} {case}: d{what} "
                         f"{tuple(g.shape)} {g.dtype}")
                err = rel_err(torch, g, w)
                if err > FLASH_BWD_TOL[name]:
                    fail(f"flash backward {name} {case}: d{what} off by "
                         f"{err} of its largest |value| (tolerance "
                         f"{FLASH_BWD_TOL[name]})")
                worst[name]["rel"] = max(worst[name]["rel"], err)
                worst[name]["abs"] = max(
                    worst[name]["abs"],
                    (g.float() - w).abs().max().item())
            del got, want, fold, t
            torch.cuda.empty_cache()
    print(f"flash backward kernel == plain version's autograd on "
          f"{2 * len(FLASH_BWD_CASES)} cases (dq, dk, dv within "
          f"{FLASH_BWD_TOL} of their largest |value|; the tensor-core "
          f"shapes also within {FLASH_BWD_MODEL_TOL} of the plain model of "
          f"their rounding, twice bit for bit, and the LSE instance's "
          f"output the plain instance's bit for bit); worst {worst}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def hold_tc_backward(torch, flash_kernel, flash_ref, q, k, v, d_out,
                     case) -> tuple:
    """The tensor-core flash backward at one case (bf16, folded tensors):
    the forward's LSE instance gives the plain instance's output bit for
    bit (the serve path's instance) and row statistics within
    ``FLASH_LSE_ATOL`` of ``ref.row_lse``; two backward launches give the
    same bits; the backward is within ``FLASH_BWD_MODEL_TOL`` of its plain
    model (``ref.attention_bwd`` with ``bf16_products``, fed the kernel's
    output and row statistics, in float32).  Returns the largest relative
    error against the model and the row statistics' absolute error."""
    _, sq, _, _, _, _, causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap=cap)
    plain = flash_kernel.flash_attention_fwd(q, k, v, **kw)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(plain, out):
        fail(f"flash {case}: the LSE instance's output is not the plain "
             "instance's, bit for bit")
    del plain
    lse_err = (lse[:, :sq] - flash_ref.row_lse(q, k, **kw)).abs().max().item()
    if not lse_err <= FLASH_LSE_ATOL:
        fail(f"flash {case}: the LSE instance's row statistics off by "
             f"{lse_err} (tolerance {FLASH_LSE_ATOL})")
    runs = [flash_kernel.flash_attention_bwd(q, k, v, out, d_out, lse=lse,
                                             **kw) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"flash backward {case}: two runs on the same inputs differ")
    model = flash_ref.attention_bwd(q, k, v, out, d_out, lse=lse,
                                    bf16_products=True,
                                    out_dtype=torch.float32, **kw)
    err = 0.0
    for g, m, what in zip(runs[0], model, "qkv"):
        e = rel_err(torch, g, m)
        if not e <= FLASH_BWD_MODEL_TOL:
            fail(f"flash backward {case}: d{what} off its plain model by "
                 f"{e} of its largest |value| (tolerance "
                 f"{FLASH_BWD_MODEL_TOL})")
        err = max(err, e)
    del model, runs
    torch.cuda.empty_cache()
    return err, lse_err


def check_gemm_bwd(torch, gemm_kernel, gemm_ops, gemm_ref) -> dict:
    """The expert GEMM's backward (``ops.expert_gemm``'s autograd
    function: dX and dW, one launch of the kernel each) against autograd
    through the plain version on the same inputs (normal, drawn on the
    card from a seeded generator; w scaled by 1 / sqrt(d)), at
    ``GEMM_BWD_SHAPES`` in float32 and bf16, at the forward's ``GEMM_TOL``
    (rtol tol, atol 10 tol).  Returns the largest absolute error per
    dtype."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        tol = GEMM_TOL[name]
        for e, c, d, f in GEMM_BWD_SHAPES:
            x, w, dy = (torch.randn(shape, generator=gen, device="cuda")
                        for shape in ((e, c, d), (e, d, f), (e, c, f)))
            x, w, dy = x.to(dtype), (w / d ** 0.5).to(dtype), dy.to(dtype)
            n0 = gemm_kernel.BWD_LAUNCHES[name]
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            got = torch.autograd.grad(gemm_ops.expert_gemm(xg, wg),
                                      (xg, wg), dy)
            torch.cuda.synchronize()
            if gemm_kernel.BWD_LAUNCHES[name] != n0 + 2:
                fail(f"expert_gemm backward {name} ({e}, {c}, {d}, {f}): "
                     f"{gemm_kernel.BWD_LAUNCHES[name] - n0} launches")
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            want = torch.autograd.grad(gemm_ref.reference_expert_gemm(xr, wr),
                                       (xr, wr), dy)
            for g, wt, what in zip(got, want, ("dX", "dW")):
                try:
                    torch.testing.assert_close(g.float(), wt.float(),
                                               rtol=tol, atol=tol * 10)
                except AssertionError as err:
                    fail(f"expert_gemm backward {name} ({e}, {c}, {d}, "
                         f"{f}): {what} != plain autograd: {err}")
                worst[name] = max(worst[name],
                                  (g.float() - wt.float()).abs().max().item())
    print(f"expert_gemm backward == plain autograd on "
          f"{2 * len(GEMM_BWD_SHAPES)} cases (dX and dW at rtol tol, atol 10 "
          f"tol, tol {GEMM_TOL}); max_abs_err {worst}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def rec_bwd_errors(torch, got, want, names, label, worst) -> None:
    """Each gradient's largest error over its largest |value|, against
    ``REC_BWD_TOL`` (bf16 outputs at the bf16 share, float32 outputs at
    the float32 share); fails naming the first one over.  Keeps the
    largest relative and absolute errors by gradient in ``worst``."""
    for name, g, w in zip(names, got, want):
        tol = REC_BWD_TOL[dtype_name(g.dtype)]
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{label} {name}: {tuple(g.shape)} against "
                 f"{tuple(w.shape)}, or not finite")
        rel = rel_err(torch, g, w)
        if not rel <= tol:
            fail(f"{label} {name} off its plain version by {rel} of its "
                 f"largest |value| (tolerance {tol})")
        err = worst.setdefault(name, {"rel": 0.0, "abs": 0.0})
        err["rel"] = max(err["rel"], rel)
        err["abs"] = max(err["abs"],
                         (g.float() - w.float()).abs().max().item())


def check_wkv6_bwd(torch, wkv_kernel, wkv_ops, wkv_ref) -> dict:
    """The WKV6 backward kernel (``csrc/wkv6_bwd.cu``, through
    ``ops.wkv6``'s autograd function: one backward call a gradient)
    against the plain backward (``ref.wkv6_backward``, both states held)
    on the same inputs, at ``WKV_BWD_CASES`` in float32 and bf16 (r, k, v,
    dy; log_w and u float32), with and without a final-state gradient:
    dr, dk, dv, dlog_w, du within ``REC_BWD_TOL``; at the clip dlog_w
    exactly 0; a second launch gives the same bits; and a planted fault,
    dlog_w shifted by one token, must fail the same check.  Returns the
    largest errors per dtype."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    names = ("dr", "dk", "dv", "dlog_w", "du")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = {}
        for case in WKV_BWD_CASES:
            b, s, h, hd, log_w, with_state = case
            label = f"wkv6 backward {name} {case[:5]}"
            r, k, v, lw, u = wkv6_inputs(torch, rng, b, s, h, hd, log_w,
                                         dtype)
            dy = torch.randn(r.shape, generator=gen, device="cuda").to(dtype)
            ds = torch.randn((b, h, hd, hd), generator=gen, device="cuda") \
                if with_state else None
            leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
            n0 = wkv_kernel.BWD_LAUNCHES[name]
            y, state = wkv_ops.wkv6(*leaves)
            outs, cots = ((y, state), (dy, ds)) if with_state \
                else ((y,), (dy,))
            got = torch.autograd.grad(outs, leaves, cots)
            again = wkv_kernel.wkv6_bwd(r, k, v, lw, u, dy, ds)
            torch.cuda.synchronize()
            if wkv_kernel.BWD_LAUNCHES[name] != n0 + 2:
                fail(f"{label}: {wkv_kernel.BWD_LAUNCHES[name] - n0} "
                     "backward launches for 2 calls")
            if not all(torch.equal(x, z) for x, z in zip(got, again)):
                fail(f"{label}: two launches on the same inputs differ")
            want = wkv_ref.wkv6_backward(r, k, v, lw, u, dy, ds)
            rec_bwd_errors(torch, got, want, names, label, worst[name])
            if log_w is not None and log_w < -100:
                if not ((got[3] == 0).all() and (want[3] == 0).all()):
                    fail(f"{label}: dlog_w not exactly 0 at the clip")
            else:
                shifted = torch.roll(got[3], 1, dims=1)
                if rel_err(torch, shifted, want[3]) <= REC_BWD_TOL[
                        "float32"]:
                    fail(f"{label}: dlog_w shifted by one token passes "
                         "the check")
            del got, again, want, leaves, y, state
            torch.cuda.empty_cache()
    print(f"wkv6 backward kernel == plain backward on "
          f"{2 * len(WKV_BWD_CASES)} cases (each gradient within "
          f"{REC_BWD_TOL} of its largest |value|; dlog_w 0 at the clip; "
          f"twice bit for bit; dlog_w shifted by a token caught); worst "
          f"{worst}; {time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def check_rglru_bwd(torch, rglru_kernel, rglru_ops, rglru_ref) -> dict:
    """The RG-LRU backward kernel (through ``ops.rglru_scan_op``'s autograd
    function) against the plain backward (``ref.rglru_backward``) at
    ``RGLRU_BWD_CASES`` in float32 and bf16 b, on the kernel's TMA ring or
    its plain loads as ``kernel.bwd_geometry`` picks: dlog_a and db within
    ``REC_BWD_TOL``, and in float32 bit for bit (the same steps in the
    same order); a planted fault, dlog_a shifted by one step, must fail
    the same check, and the cases must run both paths.  Returns the
    largest errors per dtype."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(22)
    worst, paths = {}, {"tma": [], "plain": []}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = {}
        for b, s, w in RGLRU_BWD_CASES:
            label = f"rglru backward {name} ({b}, {s}, {w})"
            path = "tma" if rglru_kernel.bwd_geometry(w, dtype).tma \
                else "plain"
            paths[path].append(f"{name} {(b, s, w)}")
            la = torch.tensor(-np.exp(rng.standard_normal((b, s, w))) * 0.1
                              - 1e-3, dtype=torch.float32, device="cuda")
            bb = torch.tensor(rng.standard_normal((b, s, w)),
                              dtype=torch.float32, device="cuda").to(dtype)
            dh = torch.tensor(rng.standard_normal((b, s, w)),
                              dtype=torch.float32, device="cuda").to(dtype)
            leaves = [la.clone().requires_grad_(), bb.clone().requires_grad_()]
            n0 = rglru_kernel.BWD_LAUNCHES[name]
            h = rglru_ops.rglru_scan_op(*leaves)
            got = torch.autograd.grad(h, leaves, dh)
            torch.cuda.synchronize()
            if rglru_kernel.BWD_LAUNCHES[name] != n0 + 1:
                fail(f"{label}: {rglru_kernel.BWD_LAUNCHES[name] - n0} "
                     "backward launches")
            want = rglru_ref.rglru_backward(la, h.detach(), dh)
            rec_bwd_errors(torch, got, want, ("dlog_a", "db"), label,
                           worst[name])
            if dtype == torch.float32 and not all(
                    torch.equal(g, x) for g, x in zip(got, want)):
                fail(f"{label}: not bit for bit the plain backward")
            if s > 1 and rel_err(torch, torch.roll(got[0], 1, dims=1),
                                 want[0]) <= REC_BWD_TOL["float32"]:
                fail(f"{label}: dlog_a shifted by one step passes the "
                     "check")
    print(f"rglru backward kernel == plain backward on "
          f"{2 * len(RGLRU_BWD_CASES)} cases (within {REC_BWD_TOL} of "
          f"each largest |value|, float32 bit for bit; dlog_a shifted by a "
          f"step caught); paths {paths}; worst {worst}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (paths["tma"] and paths["plain"]):
        fail(f"rglru backward: RGLRU_BWD_CASES ran one path only ({paths})")
    return worst


def time_rec_bwd(torch, mods, refs, ops_mods) -> dict:
    """The two recurrent backwards at their training shapes (phase 7d's
    rwkv6 (4, 512, 64, 64) in bf16, recurrentgemma's (2, 2560, 4096)
    float32): the kernel (CUDA events and ``device_ms``), the plain
    backward, and the bound, the larger of the bytes (``ops.cost(...,
    backward=True)``: each input read once, each output written once) over
    the HBM rate and the float32 operations over the float32 peak.  No
    single PyTorch call computes either gradient (library: null)."""
    import numpy as np
    rng = np.random.default_rng(23)
    out = {}
    b, s, h, hd = 4, 512, 64, 64
    r, k, v, lw, u = wkv6_inputs(torch, rng, b, s, h, hd, None,
                                 torch.bfloat16)
    dy = torch.randn(r.shape, device="cuda").to(torch.bfloat16)

    def launch_wkv():
        mods["wkv6"].wkv6_bwd(r, k, v, lw, u, dy)

    def launch_rglru():
        mods["rglru"].rglru_bwd(la, hh, dh)

    la = -torch.rand((2, 2560, 4096), device="cuda") * 0.1 - 1e-3
    hh = mods["rglru"].rglru_fwd(la, torch.randn_like(la))
    dh = torch.randn_like(la)
    for key, launch, plain, (ops, nbytes) in (
            (f"r={[b, s, h, hd]}", launch_wkv,
             lambda: refs["wkv6"].wkv6_backward(r, k, v, lw, u, dy),
             ops_mods["wkv6"].cost(r, lw, u, backward=True)),
            (f"x={list(la.shape)}", launch_rglru,
             lambda: refs["rglru"].rglru_backward(la, hh, dh),
             ops_mods["rglru"].cost(la, backward=True))):
        k_ms = time_ms(torch, launch, 10)
        k_dev = device_ms(torch, launch, reps=10)
        p_ms = time_ms(torch, plain, 1, rounds=3)
        t_b, t_o = (nbytes / HBM_BYTES_PER_S * 1e3,
                    ops / PEAK_OPS["float32"] * 1e3)
        name = "wkv6_bwd" if key.startswith("r=") else "rglru_bwd"
        out[name] = {key: dict(
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
            bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops)}
        print(f"time {name} {key}: kernel {k_ms!r} ms (device {k_dev!r} "
              f"ms), plain {p_ms!r} ms, bound {max(t_b, t_o)!r} ms "
              f"({out[name][key]['bound_by']}, {nbytes} B, {ops} "
              f"operations)", flush=True)
    return out


def time_flash_bwd(torch, flash_kernel, flash_ref, case,
                   per_step: int) -> dict:
    """The flash backward at one training shape ``case`` (B, Sq, Skv, Hq,
    Hkv, hd, causal, window, softcap), bf16, on the forward's LSE output
    where it runs on the tensor cores (the training path's arguments):
    kernel (CUDA events and ``device_ms``), plain version's autograd,
    SDPA's backward with K and V repeated to the q heads (a window as a
    boolean mask; timed here only), and the bound: the larger of the bytes
    (q, k, v, o, dO read once, dq, dk, dv written once) over the HBM rate
    and five products over the visible pairs over the bf16 tensor-core
    peak.  ``per_step``: the main path's launches a step."""
    import torch.nn.functional as F
    b, sq, skv, hq, hkv, hd, causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap=cap)
    q = torch.randn((b * hq, sq, hd), dtype=torch.bfloat16, device="cuda")
    k = torch.randn((b * hkv, skv, hd), dtype=torch.bfloat16,
                    device="cuda")
    v = torch.randn_like(k)
    tc = flash_kernel.tc_backward(q.dtype, hd)
    lse_kw = {}
    if tc:
        o, lse_kw["lse"] = flash_kernel.flash_attention_fwd(
            q, k, v, with_lse=True, **kw)
    else:
        o = flash_kernel.flash_attention_fwd(q, k, v, **kw)
    d_out = torch.randn_like(q)
    qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
    plain = flash_ref.reference_attention(qf, kf, vf, **kw)
    group = hq // hkv
    q4 = q.reshape(b, hq, sq, hd).detach().requires_grad_()
    k4, v4 = (t.reshape(b, hkv, skv, hd).repeat_interleave(group, dim=1)
              .detach().requires_grad_() for t in (k, v))
    mask = None
    if window:
        q_pos = torch.arange(sq, device="cuda")[:, None]
        k_pos = torch.arange(skv, device="cuda")[None, :]
        mask = k_pos > q_pos - window
        if causal:
            mask &= k_pos <= q_pos
    sdpa = F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None)
    do4 = d_out.reshape(b, hq, sq, hd)

    def launch_one():
        flash_kernel.flash_attention_bwd(q, k, v, o, d_out, **lse_kw, **kw)

    big = b * hq * sq * skv > 2 ** 28
    k_ms = time_ms(torch, launch_one, 3 if big else 10)
    k_dev, k_host = queued_ms(torch, launch_one, 5 if big else 10)
    p_ms = time_ms(torch, lambda: torch.autograd.grad(
        plain, (qf, kf, vf), d_out, retain_graph=True), 1 if big else 2,
        rounds=3 if big else 7)
    l_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), do4, retain_graph=True), 3 if big else 10)
    pairs = b * hq * sum(
        max(0, (min(i + 1, skv) if causal else skv)
            - (max(0, i - window + 1) if window else 0)) for i in range(sq))
    ops = 5 * 2 * pairs * hd
    nbytes = 2 * (4 * q.numel() + 4 * k.numel())
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
    key = f"q={list(q.shape)},kv={list(k.shape)}" \
        + (",causal" if causal else "") \
        + (f",window={window}" if window else "")
    out = dict(
        ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
        library_ms=l_ms, bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
        operations=ops, launches_per_step=per_step, tensor_cores=tc)
    if hd == 256:
        out["dkdv_splits"] = flash_kernel.dkdv_splits(
            b * hq, b * hkv, skv,
            torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"time flash backward {key}: kernel {k_ms!r} ms (device "
          f"{k_dev!r} ms), plain autograd {p_ms!r} ms, sdpa backward "
          f"{l_ms!r} ms, bound {max(t_b, t_o)!r} ms ({nbytes} B, {ops} "
          f"operations)", flush=True)
    del plain, sdpa, q4, k4, v4
    torch.cuda.empty_cache()
    return {key: out}


def time_train_kernels(torch, flash_kernel, flash_ref, gemm_kernel,
                       gemm_ref, per_step) -> dict:
    """The two backwards at the training shapes, bf16: the flash backward
    (:func:`time_flash_bwd`) at qwen's shape (recurrentgemma's hd 256
    shape is timed after phase 7d, which counts its launches), and the
    expert GEMM's: kernel (CUDA events and
    ``device_ms``), plain version's autograd, ``torch.bmm``'s backward,
    timed only, and the bound: the larger of the bytes (x, w, dY read, dX,
    dW written) over the HBM rate and two products over the bf16
    tensor-core peak.  The GEMM backward also as the parent commit ran it,
    split into its two transposed copies (W^T, X^T) and its two launches
    of the forward kernel on them, and the new path's copies are counted
    (its plan: none).  ``per_step`` is the main path's launches a step (a
    GEMM backward is two launches; gate/up and down share it)."""
    out = {"flash_bwd": {}}
    out["flash_bwd"].update(time_flash_bwd(
        torch, flash_kernel, flash_ref,
        (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 128, True, 0, 0.0),
        per_step["flash_bwd"]))
    out["gemm_bwd"] = {}
    for e, c, d, f in GEMM_BWD_SHAPES[:2]:
        x = torch.randn((e, c, d), dtype=torch.bfloat16, device="cuda")
        w = torch.randn((e, d, f), dtype=torch.bfloat16, device="cuda") \
            / d ** 0.5
        dy = torch.randn((e, c, f), dtype=torch.bfloat16, device="cuda")
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        plain = gemm_ref.reference_expert_gemm(xr, wr)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        lib = torch.bmm(xb, wb)

        def launch_one():
            gemm_kernel.expert_gemm_bwd(x, w, dy)

        copies = sum(len(r.copies) for r in gemm_kernel.plan_bwd(x, w, dy))
        k_ms = time_ms(torch, launch_one, 10)
        k_dev, k_host = queued_ms(torch, launch_one, 10)
        # the parent's path: W^T and X^T copied contiguous, then the
        # forward kernel on them, each part timed alone
        wt = w.transpose(1, 2).contiguous()
        xt = x.transpose(1, 2).contiguous()
        parent = {
            "copy_w_t": device_ms(torch, lambda: w.transpose(1, 2)
                                  .contiguous(), 10),
            "copy_x_t": device_ms(torch, lambda: x.transpose(1, 2)
                                  .contiguous(), 10),
            "dx_launch": device_ms(torch, lambda: gemm_kernel._launch(dy, wt),
                                   10),
            "dw_launch": device_ms(torch, lambda: gemm_kernel._launch(xt, dy),
                                   10)}
        parent["whole"] = device_ms(torch, lambda: (
            gemm_kernel._launch(dy, w.transpose(1, 2).contiguous()),
            gemm_kernel._launch(x.transpose(1, 2).contiguous(), dy)), 10)
        del wt, xt
        p_ms = time_ms(torch, lambda: torch.autograd.grad(
            plain, (xr, wr), dy, retain_graph=True), 5)
        l_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib, (xb, wb), dy, retain_graph=True), 10)
        ops = 2 * 2 * e * c * d * f
        nbytes = 2 * 2 * (e * c * d + e * d * f) + 2 * e * c * f
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
        key = f"x={[e, c, d]},w={[e, d, f]}"
        out["gemm_bwd"][key] = dict(
            ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops, launches_per_step=per_step["gemm_bwd"] // 2,
            copies=copies, parent_device_ms=parent)
        print(f"time expert_gemm backward {key}: kernel {k_ms!r} ms "
              f"(device {k_dev!r} ms, {copies} copies), plain autograd "
              f"{p_ms!r} ms, bmm backward {l_ms!r} ms, bound "
              f"{max(t_b, t_o)!r} ms ({nbytes} B, {ops} operations); the "
              f"parent's path, device ms: {parent}", flush=True)
    return out


def train_card_vs_cpu(torch, arch=TRAIN_ARCH, cut=None,
                      batch=TRAIN_CHECK_BATCH, seq=TRAIN_CHECK_SEQ) -> dict:
    """``arch`` cut (``cut``; ``TRAIN_CHECK_LAYERS`` layers by default) in
    float32, the same weights on the card and the CPU (drawn on the card,
    copied to the CPU): the loss and every gradient leaf of one batch of
    ``batch`` x ``seq`` at the ``TRAIN_CHECK_*`` tolerances, then the
    losses of ``TRAIN_CHECK_STEPS`` train steps within
    ``TRAIN_RESTART_RTOL``: step k's loss is the loss of batch k at the
    weights after k AdamW updates, so the updates run are the first
    ``TRAIN_CHECK_STEPS - 1`` (the last step's, which no loss shows, is
    not run: on the CPU an update of a billion float32 parameters takes
    some 15 s)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import tree_leaves as leaves
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_optimizer, to_device
    from repro_torch.models.model import build_model
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    cut = cut or {"num_layers": TRAIN_CHECK_LAYERS}
    cfg = dataclasses.replace(configs.get_config(arch), **cut)
    batches = [make_batch(cfg, seq, batch, i)
               for i in range(TRAIN_CHECK_STEPS)]
    t0 = time.perf_counter()
    card_model = build_model(cfg, device="cuda", dtype=torch.float32)
    card_params = card_model.init(torch.Generator(device="cuda")
                                  .manual_seed(1))
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_params = tree_map(lambda t: t.cpu(), card_params)
    runs = {}
    split = {"init_and_copy": time.perf_counter() - t0}
    for where, model, params in (("cuda", card_model, card_params),
                                 ("cpu", cpu_model, cpu_params)):
        t1 = time.perf_counter()
        opt = make_optimizer(params, lr=TRAIN_LR, warmup_steps=1,
                             total_steps=TRAIN_CHECK_STEPS)
        loss, _ = model.loss_fn(params, to_device(batches[0], model.device))
        loss.backward()
        runs[where] = {"loss": loss.item(), "opt": opt, "model": model,
                       "params": params}
        split[f"grad_{where}"] = time.perf_counter() - t1
    errs = [(tuple(g_cpu.shape), rel_err(torch, g_card.grad.cpu(),
                                         g_cpu.grad))
            for g_card, g_cpu in zip(leaves(card_params), leaves(cpu_params),
                                     strict=True)]
    worst_grad = max(e for _, e in errs)
    over = [(shape, e) for shape, e in errs if not e <= TRAIN_CHECK_GRAD]
    if over:
        fail(f"train card vs cpu ({arch}): gradient leaves off by more than "
             f"{TRAIN_CHECK_GRAD} of their largest |value|: {over} (of "
             f"{errs})")
    losses = {where: [r["loss"]] for where, r in runs.items()}
    for k, b in enumerate(batches[1:], start=1):
        for where, r in runs.items():
            t1 = time.perf_counter()
            # a train step's update (launch.steps.make_train_step) from the
            # last batch's gradients, then this batch's loss
            r["opt"].step()
            r["opt"].zero_grad(set_to_none=True)
            last = k == len(batches) - 1
            with torch.set_grad_enabled(not last):
                loss, _ = r["model"].loss_fn(r["params"],
                                             to_device(b, r["model"].device))
            if not last:
                loss.backward()
            losses[where].append(loss.item())
            split[f"steps_{where}"] = split.get(f"steps_{where}", 0.0) \
                + time.perf_counter() - t1
    cpu_s = time.perf_counter() - t0
    out = dict(arch=arch, cut=cut, batch=batch, seq=seq,
               loss_card=runs["cuda"]["loss"], loss_cpu=runs["cpu"]["loss"],
               grad_rel_err=worst_grad, step_losses=losses, seconds=cpu_s,
               seconds_split=split)
    lc, lp = np.array(losses["cuda"]), np.array(losses["cpu"])
    if not (abs(out["loss_card"] - out["loss_cpu"])
            <= TRAIN_CHECK_RTOL * abs(out["loss_cpu"])
            and np.allclose(lc, lp, rtol=TRAIN_RESTART_RTOL, atol=0)):
        fail(f"train card vs cpu: losses differ: {out}")
    print(f"train card vs cpu ({cfg.name}, {cut}, float32, {batch} x {seq}): "
          f"loss {out['loss_card']!r} vs {out['loss_cpu']!r}; gradient "
          f"leaves within {worst_grad} of their largest |value|; "
          f"{TRAIN_CHECK_STEPS} steps' losses {losses}; {cpu_s:.1f} s "
          f"({split})", flush=True)
    del runs, card_params, cpu_params, card_model, cpu_model
    return out


def train_path(torch, mods) -> dict:
    """The trainer on the card: ``train_loop`` on ``TRAIN_ARCH`` at its
    published width, ``TRAIN_LAYERS`` of 48 layers (the ``TRAIN_*``
    settings), launch counts zeroed just before and read just after; every
    step must launch flash forward twice a layer (forward and the remat's
    recompute) and its backward once, the expert GEMM six times a layer in
    the forward and six in the backward, all bf16, and each re-placement
    plan the pair kernel.  One more step profiled for the device's idle
    share and its busy time by kernel (the ``TRAIN_TOP_KERNELS``
    longest).  The restart from a checkpoint is held in phase 10
    (``train_example``)."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.ccm_scorer import kernel as scorer
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainLog, train_loop
    from repro_torch.models.model import build_model
    full = configs.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    common = dict(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                  global_batch=TRAIN_BATCH, rebalance_every=TRAIN_REBALANCE,
                  lr=TRAIN_LR, expert_ranks=TRAIN_RANKS, log_every=1,
                  device="cuda")
    for mod in mods.values():
        mod.reset_launches()
    scorer.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    log = TrainLog()
    t0 = time.perf_counter()
    params, opt, losses = train_loop(cfg, log=log, **common)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: dict(mods[k].LAUNCHES) for k in ("flash", "gemm")}
    counts.update({f"{k}_bwd": dict(mods[k].BWD_LAUNCHES)
                   for k in ("flash", "gemm")})
    pair = scorer.PAIR_LAUNCHES["float64"]
    others = {k: sum(mods[k].LAUNCHES.values()) for k in mods
              if k not in ("flash", "gemm")}
    want_step = expected_train_launches(cfg)
    if any(rec != want_step for rec in log.launches) or any(
            c["float32"] for c in counts.values()) or any(
            others.values()) or pair == 0 or len(log.replacements) != 2:
        fail(f"train: launches a step {log.launches} (expected "
             f"{want_step}), totals {counts}, others {others}, pair "
             f"{pair}, re-placements {log.replacements}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train: losses {losses}")
    batch = make_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS)
    step = make_train_step(build_model(cfg, device="cuda"))
    prof = profiled_run(torch, lambda: step(params, opt, batch))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()

    step_s = sorted(log.step_s)
    med = step_s[len(step_s) // 2]
    out = dict(
        layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        steps=TRAIN_STEPS, losses=losses, step_s=log.step_s,
        step_s_median=med, step_s_min=step_s[0], step_s_max=step_s[-1],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med, peak_gb=peak_gb,
        wall_s=wall, launches_per_step=log.launches[0], launches=counts,
        replacements=log.replacements, pair_launches=pair,
        device_idle_share=prof["device_idle_share"],
        device_idle_share_bounds=prof["device_idle_share_bounds"],
        profiled_step_s=prof["wall_s"], device_busy_ms=prof["device_busy_ms"],
        kernels_unrecorded=prof["kernels_unrecorded"],
        device_ms_by_kernel=dict(sorted(
            ((k[:100], r["device_ms"]) for k, r in prof["by_name"].items()),
            key=lambda kv: -kv[1])[:TRAIN_TOP_KERNELS]))
    print(f"train {cfg.name} ({TRAIN_LAYERS} of 48 layers, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens): losses {losses}; step s median {med!r} "
          f"(min {step_s[0]!r}, max {step_s[-1]!r}); {out['tokens_per_s']!r} "
          f"tokens/s; peak {peak_gb!r} GB; run {wall:.1f} s; launches a "
          f"step {log.launches[0]}; re-placements {log.replacements}; "
          f"device idle {prof['device_idle_share']} "
          f"({prof['device_idle_share_bounds']})", flush=True)
    return out


# ------------------------------------------------------ 7c. the device mesh
# (a)'s training steps (the train cell's width, depth and batch)
MESH_TRAIN_STEPS = 3
# (b)'s model-axis sizes: 128 experts give 32 a rank at 4 and 8 at 16
EP_RANKS = (4, 16)
# (b)'s limit on the ranks' float32 sum against the unsharded layer
EP_ATOL, EP_RTOL = 1e-5, 1e-6
# the served configs, whose dry-run cells (c) runs first, and (c)'s
# processes (the card host has 8 cores; there, beside an NVIDIA H100 80GB
# HBM3 at 700.00 W, one process took 70 s for 25 of the 33 cells, and five
# 35.5 s for all 33 once rwkv6's and recurrentgemma's train cells came)
DRYRUN_FIRST = ("qwen3-moe-30b-a3b", "rwkv6-7b", "recurrentgemma-9b",
                "gemma2-27b", "whisper-large-v3", "llava-next-mistral-7b")
DRYRUN_BUDGET_S = 60.0
DRYRUN_JOBS = 7


class LogitLog:
    """Every logit tensor a model's prefill and decode return, copied to
    the CPU (the model's closures wrapped while the log is open)."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __enter__(self):
        m = self.model
        self.saved = (m.prefill_fn, m.decode_fn)
        pre, dec = self.saved

        def prefill(p, b):
            caches, logits = pre(p, b)
            self.logits.append(logits.float().cpu())
            return caches, logits

        def decode(p, c, t, pos):
            caches, logits = dec(p, c, t, pos)
            self.logits.append(logits.float().cpu())
            return caches, logits
        m.prefill_fn, m.decode_fn = prefill, decode
        return self

    def __exit__(self, *exc):
        self.model.prefill_fn, self.model.decode_fn = self.saved


def launches_now(mods) -> dict:
    return {"flash": sum(mods["flash"].LAUNCHES.values()),
            "flash_bwd": sum(mods["flash"].BWD_LAUNCHES.values()),
            "gemm": sum(mods["gemm"].LAUNCHES.values()),
            "gemm_bwd": sum(mods["gemm"].BWD_LAUNCHES.values())}


def mesh_runs(torch, mods) -> dict:
    """(a): serve and train ``SERVE_ARCH`` without a mesh and on the 1 x 1
    NCCL mesh; the two equal bit for bit (see the module's docstring)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import tree_leaves as ckpt_leaves
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.train import TrainLog, train_loop
    from repro_torch.models.model import build_model

    mesh = make_local_mesh(1, 1)                    # NCCL, a world of one
    backend = dist.get_backend()
    if backend != "nccl" or mesh.device_type != "cuda":
        fail(f"mesh: backend {backend}, device {mesh.device_type}")
    full = configs.get_config(SERVE_ARCH)
    out = {"backend": backend, "world": dist.get_world_size(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
        runs = {}
        for label, kw in (("no mesh", {}), ("mesh 1x1", {"mesh": mesh})):
            model = build_model(cfg, **kw)
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
            for mod in mods.values():
                mod.reset_launches()
            t0 = time.perf_counter()
            with LogitLog(model) as log:
                tokens = serve_batch(model, params, prompts, SERVE_NEW)
            torch.cuda.synchronize()
            runs[label] = dict(tokens=tokens, logits=log.logits,
                               launches=launches_now(mods),
                               wall_s=time.perf_counter() - t0)
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["no mesh"], runs["mesh 1x1"]
        serve_same = bool((a["tokens"] == b["tokens"]).all()) and len(
            a["logits"]) == len(b["logits"]) and all(
            torch.equal(x, y) for x, y in zip(a["logits"], b["logits"]))
        want = {"flash": SERVE_LAYERS, "flash_bwd": 0,
                "gemm": 3 * SERVE_LAYERS * (1 + SERVE_NEW), "gemm_bwd": 0}
        if not serve_same or a["launches"] != want \
                or b["launches"] != want:
            fail(f"mesh serve: bit for bit {serve_same}, launches "
                 f"{a['launches']} / {b['launches']} (want {want})")
        out["serve"] = {k: {"launches": v["launches"], "wall_s": v["wall_s"],
                            "logit_rows": len(v["logits"])}
                        for k, v in runs.items()}
        out["serve"]["bit_for_bit"] = serve_same
        # training: 3 steps at 4 layers, with and without the mesh
        cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
        runs = {}
        for label, kw in (("no mesh", {}), ("mesh 1x1", {"mesh": mesh})):
            for mod in mods.values():
                mod.reset_launches()
            log = TrainLog()
            params, opt, losses = train_loop(
                cfg, steps=MESH_TRAIN_STEPS, seq_len=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, lr=TRAIN_LR, log_every=1,
                device="cuda", log=log, **kw)
            runs[label] = dict(
                losses=losses, launches=log.launches, step_s=log.step_s,
                params=[t.detach().cpu() for t in ckpt_leaves(params)])
            del params, opt
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["no mesh"], runs["mesh 1x1"]
        train_same = a["losses"] == b["losses"] and all(
            torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
        want_step = expected_train_launches(cfg)
        if not train_same or any(rec != want_step for r in runs.values()
                                 for rec in r["launches"]):
            fail(f"mesh train: bit for bit {train_same}, losses "
                 f"{a['losses']} / {b['losses']}, launches "
                 f"{a['launches']} / {b['launches']}")
        out["train"] = {k: {"losses": v["losses"], "step_s": v["step_s"],
                            "launches_per_step": v["launches"][0]}
                        for k, v in runs.items()}
        out["train"]["bit_for_bit"] = train_same
        del runs, a, b
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"mesh 1x1 ({backend}, world {out['world']}): serve "
          f"{SERVE_LAYERS} of 48 layers equal bit for bit without the mesh "
          f"({out['serve']['mesh 1x1']['logit_rows']} logit tensors), "
          f"launches {out['serve']['mesh 1x1']['launches']}; train "
          f"{TRAIN_LAYERS} layers x {MESH_TRAIN_STEPS} steps equal bit for "
          f"bit (losses {out['train']['mesh 1x1']['losses']}, every "
          f"parameter), launches a step "
          f"{out['train']['mesh 1x1']['launches_per_step']}", flush=True)
    return out


def ep_ranks(torch, mods) -> dict:
    """(b): every model rank's expert-parallel body on the one card (see
    the module's docstring)."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.balance.expert_placement import plan_expert_placement
    from repro_torch.balance.pipeline_stages import H100_HBM_BYTES
    from repro_torch.launch.train import take_slots
    from repro_torch.models import moe

    cfg = dataclasses.replace(configs.get_config(SERVE_ARCH), num_layers=1)
    params = build_model_params(torch, cfg)
    p = params["blocks"][0]["moe"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model),
                    generator=gen, device="cuda").to(torch.bfloat16)
    w = [p[n] for n in moe.EXPERT_LEAVES]
    with torch.inference_mode():
        full, _, counts = moe.local_moe(p["router"], *w, x, cfg=cfg,
                                        act_name=cfg.act)
        out = {}
        for m_size in EP_RANKS:
            e_loc = cfg.num_experts // m_size
            mods["gemm"].reset_launches()
            parts = []
            same_counts = True
            for rank in range(m_size):
                part, _, c = moe.local_moe(
                    p["router"], *(t[rank * e_loc:(rank + 1) * e_loc]
                                   for t in w), x, cfg=cfg, act_name=cfg.act,
                    model_rank=rank, model_size=m_size)
                parts.append(part)
                same_counts &= bool(torch.equal(c, counts))
            launches = sum(mods["gemm"].LAUNCHES.values())
            total = torch.stack(parts).sum(0)
            err = (total - full).abs()
            # float32 summation order: each rank's GEMMs are the whole
            # layer's, only the order of the ranks' sum differs
            tol = EP_ATOL + EP_RTOL * full.abs()
            ok = bool((err <= tol).all())
            # planted faults, which that limit must catch: rank 1's share
            # dropped, and rank 1's body at rank 0's expert offset
            wrong, _, _ = moe.local_moe(
                p["router"], *(t[e_loc:2 * e_loc] for t in w), x, cfg=cfg,
                act_name=cfg.act, model_rank=0, model_size=m_size)
            faults = {"rank dropped": total - parts[1],
                      "wrong offset": total - parts[1] + wrong}
            caught = {k: not bool(((v - full).abs() <= tol).all())
                      for k, v in faults.items()}
            if not all(caught.values()):
                fail(f"ep ranks {m_size}: a planted fault passed the "
                     f"limit ({caught})")
            # a CCM-LB plan on m_size ranks (of skewed counts: this layer's
            # random router loads its experts about evenly, and its plan
            # moves nothing), and a reversal, applied rank by rank against
            # the one-device permutation
            plan = plan_expert_placement(
                zipf_counts(np.random.default_rng(m_size), cfg.num_experts,
                            l_n=1), cfg, m_size,
                hbm_budget_bytes=H100_HBM_BYTES, rank_speed=None,
                device="cuda")
            perms = {"plan": torch.as_tensor(plan.permutations[0],
                                             device="cuda"),
                     "reversal": torch.arange(cfg.num_experts - 1, -1, -1,
                                              device="cuda")}
            moved = {}
            for name, perm in perms.items():
                got = torch.cat([take_slots(w[0], 0, perm, r, e_loc)
                                 for r in range(m_size)])
                if not torch.equal(got, w[0].index_select(0, perm)):
                    fail(f"ep ranks {m_size}: {name} permutation differs "
                         "from the one-device one")
                moved[name] = int(sum(
                    1 for s, e in enumerate(perm.tolist())
                    if s // e_loc != e // e_loc))
            out[m_size] = dict(
                experts_a_rank=e_loc, gemm_launches=launches,
                max_abs_err=float(err.max()), within_tol=ok,
                faults_caught=caught, counts_equal=same_counts,
                slots_moved_across_ranks=moved)
            if not ok or not same_counts or launches != 3 * m_size \
                    or moved["reversal"] == 0:
                fail(f"ep ranks {m_size}: {out[m_size]}")
            print(f"ep body, {m_size} model ranks x {e_loc} experts, "
                  f"{SERVE_BATCH} x {SERVE_PROMPT} tokens: the ranks' sum "
                  f"within atol {EP_ATOL:g} + rtol {EP_RTOL:g} of the "
                  f"unsharded layer (max abs err "
                  f"{out[m_size]['max_abs_err']!r}; a rank dropped and a "
                  f"wrong offset both caught), counts equal on every rank, "
                  f"{launches} GEMM launches; "
                  f"permutations across ranks equal the one-device one "
                  f"(slots moved across ranks {moved})", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def build_model_params(torch, cfg):
    from repro_torch.models.model import build_model
    return build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))


def dryrun_h100() -> dict:
    """(c): ``launch.dryrun`` on the ``h100`` mesh in ``DRYRUN_JOBS``
    subprocesses at once (the configs dealt out, the served ones first),
    none starting a cell after ``DRYRUN_BUDGET_S``."""
    import os
    import shutil
    import tempfile

    from repro_torch import configs
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    archs = DRYRUN_FIRST + tuple(a for a in configs.ARCH_IDS
                                 if a not in DRYRUN_FIRST)
    t0 = time.perf_counter()
    procs = []
    for j in range(DRYRUN_JOBS):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
               "--mesh", "h100", "--archs",
               ",".join(archs[j::DRYRUN_JOBS]), "--budget-s",
               str(DRYRUN_BUDGET_S), "--out", str(tmp / f"dryrun{j}.json")]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    recs = {}
    try:
        for j, proc in enumerate(procs):
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"dryrun: rc {proc.returncode}\n{out[-3000:]}\n"
                     f"{err[-3000:]}")
            recs.update(json.loads((tmp / f"dryrun{j}.json").read_text()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    cells = {}
    for arch, shape in configs.cells():
        rec = recs.get(f"{arch}|{shape}|h100")
        key = f"{arch} {shape}"
        if rec is None or rec.get("not_run"):
            cells[key] = {"run": False}
            print(f"dryrun h100 {key}: not run (the phase passed "
                  f"{DRYRUN_BUDGET_S:g} s)", flush=True)
            continue
        if not rec.get("ok"):
            fail(f"dryrun h100 {key}: {rec}")
        st, r, m = rec["stats"], rec["roofline"], rec["memory_per_device"]
        cells[key] = dict(run=True, flops=st["flops"],
                          bytes=st["bytes_accessed"], dominant=r["dominant"],
                          bound_step_s=r["bound_step_s"],
                          per_device_gb=m["total"] / 1e9,
                          fits_80gb=rec["fits_80gb"], count_s=rec["count_s"])
        print(f"dryrun h100 {key}: flops {st['flops']!r}, bytes "
              f"{st['bytes_accessed']!r}, dominant {r['dominant']} "
              f"(bound {r['bound_step_s']!r} s), per-device "
              f"{m['total'] / 1e9!r} GB, fits 80 GB {rec['fits_80gb']}",
              flush=True)
    print(f"dryrun h100: {sum(c['run'] for c in cells.values())} of "
          f"{len(cells)} cells run in {seconds:.1f} s on the host", flush=True)
    return {"seconds": seconds, "cells": cells}


# --------------------------------------- 7c (d). the tensor-parallel ranks
# (d)'s model-axis sizes (16 where the heads divide it), tokens, and limit:
# the ranks' float32 sum against the whole sub-layer within TP_REL of the
# whole output's (and input gradient's) largest |value|, or within
# TP_ULP_X times what one-ulp noise on the inputs moves the whole
# sub-layer by, where that is larger (float32 sums in another order; RWKV6's
# input gradient is ill-conditioned: its dlog_w is a difference of suffix
# sums); a planted fault moves them by O(1)
TP_RANKS = (2, 4, 16)
TP_BATCH, TP_SEQ = 2, 256
TP_REL = 1e-4
TP_ULP_X = 16
# (d)'s sub-layers a family, in order: attention (its mask; "cross" reads
# the encoder frames), the gated MLP, RWKV6's time and channel mixes, the
# RG-LRU block, and the vocabulary head's logits and loss
TP_FAMILIES = (
    ("qwen3-moe-30b-a3b", ("causal", "logits", "nll")),
    ("gemma2-27b", ("local", "causal", "mlp", "logits", "nll")),
    ("rwkv6-7b", ("time_mix", "channel_mix")),
    ("recurrentgemma-9b", ("rglru", "mlp", "rglru", "mlp", "local", "mlp")),
    ("whisper-large-v3", ("none", "mlp", "causal", "cross", "mlp")),
    ("llava-next-mistral-7b", ("causal", "mlp")),
)
# (d)'s kernels timed at the M = 4 shapes of the served batches
TP_TIME_M = 4


class RankReplay:
    """One model rank of ``size``, run on the one card in turn with the
    others: a ``sharding.ModelAxis`` whose collectives are done by hand.
    ``enter`` is the identity (each rank's use of a value adds its own
    share of the gradient).  A collective records this rank's input in
    ``book`` and, once every rank's is there, returns the ranks' sum in
    rank order (``sum``; ``scatter``: this rank's chunk of it), their
    maximum (``max``) or their concatenation (``gather``).  Until then it
    returns a stand-in of the right shape and marks the pass incomplete,
    and the collectives after it in that pass record nothing:
    :func:`replay_ranks` runs every rank again until a pass completes.
    ``drop``: a rank whose inputs every collective takes as zeros (a
    planted fault)."""

    def __init__(self, rank: int, size: int, book: dict, drop=None):
        self.rank, self.size, self.book, self.drop = rank, size, book, drop
        self.calls, self.complete = 0, True

    def start(self, n: int) -> int:
        return self.rank * n

    def enter(self, x):
        return x

    def _collect(self, x):
        i = self.calls
        self.calls += 1
        if not self.complete:
            return None
        got = self.book.setdefault(i, {})
        got[self.rank] = x
        if len(got) < self.size:
            self.complete = False
            return None
        return [got[r] if r != self.drop else got[r].detach() * 0
                for r in range(self.size)]

    def sum(self, x):
        xs = self._collect(x)
        if xs is None:
            return x
        out = xs[0]
        for t in xs[1:]:
            out = out + t
        return out

    def scatter(self, x, dim):
        n = x.shape[dim] // self.size
        return self.sum(x).narrow(dim, self.rank * n, n)

    def max(self, x):
        xs = self._collect(x.detach())
        if xs is None:
            return x.detach()
        out = xs[0]
        for t in xs[1:]:
            out = out.maximum(t)
        return out

    def gather(self, x, dim):
        import torch
        xs = self._collect(x)
        return torch.cat([x] * self.size if xs is None else xs, dim)


def replay_ranks(fn, size: int, drop=None):
    """``fn(axis)`` for every rank of ``size`` (a :class:`RankReplay`) in
    rank order, again until a pass completes every rank's collectives;
    returns (rank 0's output, which every rank's final sum or gather
    equals, and the passes)."""
    book = {}
    for passes in range(1, 9):
        outs, done = [], True
        for rank in range(size):
            axis = RankReplay(rank, size, book, drop)
            outs.append(fn(axis))
            done &= axis.complete
        if done:
            return outs[0], passes
    fail(f"tp ranks: {size} ranks' collectives did not complete")


def rank_shard(torch, tree, axes_tree, rank: int, size: int, shift=0):
    """This rank's model-axis shard of every whole leaf of ``tree``
    (logical axes ``axes_tree``) by ``sharding.spec_for`` on a 1 x ``size``
    mesh (views, no copy); ``shift`` moves a "heads" dimension's shard by
    that many heads (a planted fault)."""
    from repro_torch import sharding
    mesh = sharding.AbstractMesh((("data", 1), ("model", size)))
    axes = sharding.MeshAxes(batch=("data",))

    def one(t, ax):
        spec = sharding.spec_for(mesh, axes, ax, tuple(t.shape))
        for dim, entry in enumerate(spec):
            if entry == "model":
                n = t.shape[dim] // size
                if shift and ax[dim] == "heads":
                    t = torch.roll(t, -shift, dim)
                return t.narrow(dim, rank * n, n)
        return t
    return sharding.tree_map(one, tree, axes_tree)


def tp_sublayer(torch, cfg, kind: str, gen):
    """(whole float32 params, their logical axes, ``fn(p, xs, tp)``, the
    number of float inputs) of one ``kind`` of sub-layer at ``cfg``'s
    width, every leaf drawn from ``gen`` (the zero and constant inits
    perturbed, so that every leaf moves the output)."""
    from repro_torch import sharding
    from repro_torch.models import attention as attn
    from repro_torch.models import rglru as rglru_lib
    from repro_torch.models import rwkv6 as rwkv_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_mlp, mlp_axes, mlp_forward
    kw = dict(dtype=torch.float32, device="cuda")
    pos = torch.arange(TP_SEQ, device="cuda")[None].expand(TP_BATCH, TP_SEQ)
    if kind in ("causal", "local", "none", "cross"):
        mask = "none" if kind == "cross" else kind
        p, axes = attn.init_attention(gen, cfg, **kw), attn.attention_axes()

        def fn(p, xs, tp):
            return attn.attention_forward_kv(
                p, xs[0], cfg, mask_kind=mask, positions=pos,
                kv_x=xs[1] if kind == "cross" else None, tp=tp)[0]
        return p, axes, fn, 2 if kind == "cross" else 1
    if kind in ("logits", "nll"):
        w = torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                        **kw) / cfg.d_model ** 0.5
        targets = torch.randint(0, cfg.vocab_size, (TP_BATCH, TP_SEQ),
                                generator=gen, device="cuda")
        if kind == "logits":
            def fn(p, xs, tp):
                return tf.head_logits(xs[0], p["w"], cfg, tp)
        else:
            def fn(p, xs, tp):
                return tf.head_nll(xs[0], targets, p["w"], cfg, tp)[0]
        return {"w": w}, {"w": ("embed", "vocab")}, fn, 1
    if kind == "mlp":
        p, axes = init_mlp(gen, cfg.d_model, cfg.d_ff, **kw), mlp_axes()

        def fn(p, xs, tp):
            return mlp_forward(p, xs[0], cfg.act, tp)
    elif kind == "time_mix":
        p = rwkv_lib.init_time_mix(gen, cfg, **kw)
        axes = rwkv_lib.time_mix_axes(cfg)

        def fn(p, xs, tp):
            return rwkv_lib.time_mix_forward(p, xs[0], cfg, tp=tp)[0]
    elif kind == "channel_mix":
        p = rwkv_lib.init_channel_mix(gen, cfg, **kw)
        axes = rwkv_lib.channel_mix_axes()

        def fn(p, xs, tp):
            return rwkv_lib.channel_mix_forward(p, xs[0], tp=tp)[0]
    elif kind == "rglru":
        p = rglru_lib.init_rglru_block(gen, cfg, **kw)
        axes = rglru_lib.rglru_axes(cfg)

        def fn(p, xs, tp):
            return rglru_lib.rglru_block_forward(p, xs[0], cfg, tp=tp)[0]
    else:
        raise ValueError(kind)
    p = sharding.tree_map(lambda t: t + 0.02 * torch.randn(
        t.shape, generator=gen, **kw), p)
    return p, axes, fn, 1


def tp_kernel_shape(cfg, kind: str, m: int):
    """(the kernel a ``kind`` sub-layer launches, its first argument's
    shape at one of ``m`` ranks), or (None, None)."""
    if kind in ("causal", "local", "none", "cross"):
        return "flash", (TP_BATCH * cfg.num_heads // m, TP_SEQ,
                         cfg.head_dim)
    if kind == "time_mix":
        return "wkv6", (TP_BATCH, TP_SEQ,
                        cfg.d_model // cfg.rwkv_head_dim // m,
                        cfg.rwkv_head_dim)
    if kind == "rglru":
        return "rglru", (TP_BATCH, TP_SEQ, cfg.d_model // m)
    return None, None


def tp_check(torch, cfg, kind: str, gen, sizes, mods) -> dict:
    """One sub-layer at full width: for each M of ``sizes``, every rank's
    body in turn (:func:`replay_ranks`), the ranks' sum and the input
    gradient held to the whole sub-layer's, and the planted faults (rank
    1's share dropped; rank 1 at its heads' offset shifted by one head, for
    attention) caught; each M's kernel launches and their shapes."""
    p, axes, fn, n_in = tp_sublayer(torch, cfg, kind, gen)
    xs = [torch.randn((TP_BATCH, TP_SEQ, cfg.d_model), generator=gen,
                      device="cuda") for _ in range(n_in)]

    def run(call):
        ins = [x.clone().requires_grad_(True) for x in xs]
        out = call(ins)
        g = torch.ones_like(out) if out.dim() == 0 else torch.randn(
            out.shape, generator=torch.Generator(device="cuda").manual_seed(
                7), device="cuda")
        (out * g).sum().backward()
        return out.detach(), [t.grad for t in ins]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    whole, whole_g = run(lambda ins: fn(p, ins, None))
    # the whole sub-layer's own float32 conditioning: its inputs moved by
    # one ulp at random
    noise = torch.Generator(device="cuda").manual_seed(11)
    xs0 = xs
    xs = [x * (1 + 2.0 ** -23 * (torch.randint(
        0, 2, x.shape, generator=noise, device="cuda") * 2 - 1)) for x in xs0]
    moved, moved_g = run(lambda ins: fn(p, ins, None))
    xs = xs0
    ulp = max([rel(moved, whole)] + [rel(a, b) for a, b in zip(moved_g,
                                                               whole_g)])
    limit = max(TP_REL, TP_ULP_X * ulp)
    out = {}
    for m in sizes:
        def body(drop=None, shift=0):
            def call(ins):
                return replay_ranks(lambda ax: fn(rank_shard(
                    torch, p, axes, ax.rank, m,
                    shift if ax.rank == 1 else 0), ins, ax), m, drop)[0]
            return call
        for mod in mods.values():
            mod.reset_launches()
        with ShapeLog({k: mods[k] for k in ("flash", "wkv6", "rglru")}) \
                as log:
            got, got_g = run(body())
        launches = launches_now(mods)
        launches.update(wkv6=sum(mods["wkv6"].LAUNCHES.values()),
                        wkv6_bwd=sum(mods["wkv6"].BWD_LAUNCHES.values()),
                        rglru=sum(mods["rglru"].LAUNCHES.values()),
                        rglru_bwd=sum(mods["rglru"].BWD_LAUNCHES.values()))
        errs = [rel(got, whole)] + [rel(a, b) for a, b in zip(got_g,
                                                              whole_g)]
        faults = {"rank dropped": run(body(drop=1))[0]}
        if kind in ("causal", "local", "none", "cross"):
            faults["head offset shifted"] = run(body(shift=1))[0]
        caught = {k: rel(v, whole) > limit for k, v in faults.items()}
        shapes = {k: sorted({a[0] for (a, _) in v})
                  for k, v in log.shapes.items() if v}
        out[m] = dict(max_rel_err=max(errs), rel_errs=errs, one_ulp_rel=ulp,
                      limit=limit, faults_caught=caught,
                      launches={k: v for k, v in launches.items() if v},
                      shapes={k: [list(s) for s in v]
                              for k, v in shapes.items()})
        # the kernel of the sub-layer, forward and backward, at a rank's
        # shape only: flash's q (B x the rank's q heads, S, hd), WKV6's r
        # (B, S, the rank's heads, hd), the scan's (B, S, its channels)
        name, want = tp_kernel_shape(cfg, kind, m)
        ok = name is None or (launches[name] > 0
                              and launches[f"{name}_bwd"] > 0
                              and shapes.get(name) == [want])
        if max(errs) > limit or not all(caught.values()) or not ok:
            fail(f"tp ranks {cfg.name} {kind} at {m} ranks: {out[m]} "
                 f"(want {name} at {want})")
    return out


def tp_ranks(torch, mods) -> dict:
    """(d): every family's sub-layers at published width, each model rank's
    tensor-parallel body in turn on the card (see the module's
    docstring), then the flash, WKV6 and RG-LRU kernels timed at the
    M = 4 ranks' shapes of the served batches."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.models.attention import rank_heads
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out, total = {}, Counter()
    try:
        for arch, kinds in TP_FAMILIES:
            cfg = configs.get_config(arch)
            sizes = [m for m in TP_RANKS if cfg.num_heads % m == 0]
            gen = torch.Generator(device="cuda").manual_seed(29)
            fam = {}
            for i, kind in enumerate(kinds):
                fam[f"{i} {kind}"] = r = tp_check(torch, cfg, kind, gen,
                                                  sizes, mods)
                for m, rec in r.items():
                    total.update(rec["launches"])
                    print(f"tp ranks {arch} {kind}, {m} ranks: the ranks' "
                          f"sum and input gradient within "
                          f"{rec['max_rel_err']!r} of the whole sub-layer's "
                          f"largest |value| (limit {rec['limit']!r}; one "
                          f"ulp on the inputs moves it "
                          f"{rec['one_ulp_rel']!r}), faults "
                          f"caught {rec['faults_caught']}, launches "
                          f"{rec['launches']}, shapes {rec['shapes']}",
                          flush=True)
                gc.collect()
                torch.cuda.empty_cache()
            out[arch] = fam
        seconds = time.perf_counter() - t0
        # the kernels at the M = 4 ranks' shapes of the served batches:
        # qwen's flash (its 32 / 4 q heads on one of its 4 kv heads), rwkv6's
        # WKV6 (64 / 4 heads) and recurrentgemma's scan (4096 / 4 channels)
        qwen = configs.get_config(SERVE_ARCH)
        _, hq, _, hkv = rank_heads(qwen, RankReplay(0, TP_TIME_M, {}))
        times = {"flash": time_flash(
            torch, mods["flash"], flash_ref,
            (SERVE_BATCH * hq, SERVE_PROMPT, qwen.head_dim),
            (SERVE_BATCH * hkv, SERVE_PROMPT, qwen.head_dim), hq,
            {"causal": True}, 0)}
        rwkv = configs.get_config(RWKV_ARCH)
        h = rwkv.d_model // rwkv.rwkv_head_dim // TP_TIME_M
        times["wkv6"] = time_wkv6(
            torch, mods, wkv_ref, np.random.default_rng(29),
            (SERVE_BATCH, SERVE_PROMPT, h, rwkv.rwkv_head_dim), 0)
        rg = configs.get_config(RG_ARCH)
        times["rglru"] = time_rglru(
            torch, mods, rglru_ref,
            (SERVE_BATCH, REC_SERVES[1][1], rg.d_model // TP_TIME_M), 0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"tp ranks: {len(out)} families in {seconds:.1f} s, launches "
          f"{dict(total)}", flush=True)
    return {"families": out, "launches": dict(total), "seconds": seconds,
            "times_m4": times}


# ------------------------------------------- 7d. training the other families
def expected_train_launches(cfg) -> dict:
    """Kernel launches of one train step (``launch.train.launch_counts``'
    keys) by the model's remat: a kernel of a layer inside a recomputed
    period (every layer of the encoder-decoder) runs twice in the forward
    (the forward and the remat's recompute), a tail layer's once; each
    backward once (the expert GEMM's: dX and dW, two launches)."""
    from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL,
                                          BLOCK_MOE, BLOCK_REC, BLOCK_RWKV)
    want = {f"{k}_{d}": 0 for k in ("flash", "gemm", "wkv6", "rglru")
            for d in ("fwd", "bwd")}
    fwd = 1 if not cfg.remat or cfg.remat_policy == "none" else 2
    if cfg.arch_type == "encdec":
        n = cfg.num_layers + 2 * cfg.num_decoder_layers
        want.update(flash_fwd=fwd * n, flash_bwd=n)
        return want
    kinds = cfg.layer_kinds()
    n_scan = (len(kinds) // cfg.pattern_period) * cfg.pattern_period
    for i, kind in enumerate(kinds):
        times = fwd if i < n_scan else 1
        name = {BLOCK_RWKV: "wkv6", BLOCK_REC: "rglru"}.get(kind, "flash")
        if kind in (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE, BLOCK_RWKV,
                    BLOCK_REC):
            want[f"{name}_fwd"] += times
            want[f"{name}_bwd"] += 1
        if kind == BLOCK_MOE:
            want["gemm_fwd"] += 3 * times
            want["gemm_bwd"] += 6
    return want


def train_family(torch, arch, cut, batch, seq, check, mods) -> dict:
    """``arch`` cut by ``cut`` at its published width, trained on the card
    in bf16 through ``train_loop``: a warm-up step and ``FAMILY_STEPS``
    more of ``batch`` x ``seq`` at ``TRAIN_LR``, launch counts zeroed just
    before and read just after.  Every step must launch what
    ``expected_train_launches`` says, nothing in float32 but the RG-LRU
    scan (the model's gates, and so its b, are float32, as the
    reference's), and the loss must fall over the measured steps.  One
    more step under the profiler (device idle share, busy time by kernel).
    Then the float32 card-vs-CPU check at ``check`` (cut, requests,
    tokens)."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.checkpoint import tree_leaves as leaves
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainLog, train_loop
    from repro_torch.models.encdec import decoder_len
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(configs.get_config(arch), **cut)
    steps = 1 + FAMILY_STEPS
    for mod in mods.values():
        mod.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = TrainLog()
    t0 = time.perf_counter()
    params, opt, losses = train_loop(cfg, steps=steps, seq_len=seq,
                                     global_batch=batch, lr=TRAIN_LR,
                                     log_every=1, device="cuda", log=log)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: {"fwd": dict(mods[k].LAUNCHES),
                  "bwd": dict(mods[k].BWD_LAUNCHES)} for k in mods}
    want = expected_train_launches(cfg)
    float32 = {k: c["fwd"]["float32"] + c["bwd"]["float32"]
               for k, c in counts.items() if k != "rglru"}
    if any(rec != want for rec in log.launches) or any(float32.values()):
        fail(f"train {arch}: launches a step {log.launches} (expected "
             f"{want}), totals {counts}")
    measured = losses[1:]
    if not (np.isfinite(losses).all() and measured[-1] < measured[0]):
        fail(f"train {arch}: losses {losses}")
    n_params = sum(t.numel() for t in leaves(params))
    positions = batch * (seq + (decoder_len(cfg, seq)
                                if cfg.arch_type == "encdec" else 0))
    step = make_train_step(build_model(cfg, device="cuda"))
    nxt = make_batch(cfg, seq, batch, steps)
    prof = profiled_run(torch, lambda: step(params, opt, nxt))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    step_s = sorted(log.step_s[1:])
    med = step_s[len(step_s) // 2]
    out = dict(
        cut=cut, params=n_params, batch=batch, seq=seq,
        positions_per_step=positions, losses=losses, step_s=log.step_s,
        step_s_median=med, step_s_min=step_s[0], step_s_max=step_s[-1],
        tokens_per_s=positions / med, peak_gb=peak_gb, wall_s=wall,
        launches_per_step=log.launches[0], launches=counts,
        device_idle_share=prof["device_idle_share"],
        device_idle_share_bounds=prof["device_idle_share_bounds"],
        profiled_step_s=prof["wall_s"], device_busy_ms=prof["device_busy_ms"],
        kernels_unrecorded=prof["kernels_unrecorded"],
        device_ms_by_kernel=dict(sorted(
            ((k[:100], r["device_ms"]) for k, r in prof["by_name"].items()),
            key=lambda kv: -kv[1])[:TRAIN_TOP_KERNELS]))
    print(f"train {arch} ({cut or 'full depth'}, {n_params / 1e9:.3f} G "
          f"parameters, {batch} x {seq}): losses {losses}; step s median "
          f"{med!r} (min {step_s[0]!r}, max {step_s[-1]!r}) after a "
          f"warm-up of {log.step_s[0]!r}; {out['tokens_per_s']!r} "
          f"positions/s; peak {peak_gb!r} GB; run {wall:.1f} s; launches "
          f"a step {log.launches[0]}; device idle "
          f"{prof['device_idle_share']} "
          f"({prof['device_idle_share_bounds']})", flush=True)
    out["card_vs_cpu"] = train_card_vs_cpu(torch, arch, *check)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ 7. serving the recurrent LMs
def wkv6_inputs(torch, rng, b, s, h, hd, log_w, dtype):
    """tests/test_kernels.py's distributions: r, k at 0.5, v standard,
    log_w = -exp(N(0, 1)) unless given, u at 0.3; r, k, v in ``dtype``,
    log_w and u float32, on the card."""
    import numpy as np

    def card(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32, device="cuda").to(dt)
    lw = (-np.exp(rng.standard_normal((b, s, h, hd))) if log_w is None
          else np.full((b, s, h, hd), log_w))
    return (card(rng.standard_normal((b, s, h, hd)) * 0.5, dtype),
            card(rng.standard_normal((b, s, h, hd)) * 0.5, dtype),
            card(rng.standard_normal((b, s, h, hd)), dtype), card(lw),
            card(rng.standard_normal((h, hd)) * 0.3))


def check_wkv6_kernel(torch, wkv_ops, wkv_ref, rng) -> dict:
    """The WKV6 kernel against its plain versions on the card: y against
    the sequential oracle (the kernel's own form) and against the chunked
    version at chunks 16, 32 and 64 (16 only past 128 tokens), the final
    state against the chunked version's.  Returns the largest absolute
    errors per dtype."""
    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        rtol = WKV_RTOL[name]
        worst[name] = {"y": 0.0, "state": 0.0}
        for b, s, h, hd, log_w in WKV_CASES:
            r, k, v, lw, u = wkv6_inputs(torch, rng, b, s, h, hd, log_w,
                                         dtype)
            y, state = wkv_ops.wkv6(r, k, v, lw, u)
            fold = [t.transpose(1, 2).reshape(b * h, s, hd)
                    for t in (r, k, v, lw)]
            oracle = wkv_ref.reference_wkv6(*fold, u.repeat(b, 1))
            oracle = oracle.reshape(b, h, s, hd).transpose(1, 2)
            torch.cuda.synchronize()
            label = f"wkv6 {name} (B, S, H, hd) = ({b}, {s}, {h}, {hd}), " \
                f"log_w {log_w or '-exp(N(0, 1))'}"
            if y.shape != r.shape or y.dtype != dtype \
                    or state.shape != (b, h, hd, hd) \
                    or not (torch.isfinite(y).all()
                            and torch.isfinite(state).all()):
                fail(f"{label}: shape/dtype {tuple(y.shape)} {y.dtype}, "
                     f"{tuple(state.shape)}, or non-finite output")
            # at the clip extreme the chunked form's cumulated log-decay
            # reaches -4.8e4 in a chunk, where a float32 ulp is 2^-8, so its
            # y is inexact there (tests/test_torch_wkv6.py); the oracle, the
            # kernel's own form, holds y, and the state (exact in both) is
            # held to the chunked form's
            chunked_y = log_w is None or log_w > -100
            try:
                torch.testing.assert_close(y.float(), oracle.float(),
                                           atol=WKV_ATOL, rtol=rtol)
                for chunk in (16, 32, 64) if s <= 128 else (16,):
                    want_y, want_state = wkv_ref.wkv6_chunked(
                        r, k, v, lw, u, chunk=chunk)
                    if chunked_y:
                        torch.testing.assert_close(
                            y.float(), want_y.to(dtype).float(),
                            atol=WKV_ATOL, rtol=rtol)
                    torch.testing.assert_close(state, want_state,
                                               atol=WKV_ATOL, rtol=1e-5)
            except AssertionError as err:
                fail(f"{label}: kernel != plain version: {err}")
            w = worst[name]
            w["y"] = max(w["y"], (y.float() - oracle.float()).abs().max()
                         .item())
            w["state"] = max(w["state"],
                             (state - want_state).abs().max().item())
            n_cases += 1
    print(f"wkv6 kernel == plain versions on {n_cases} cases (y and final "
          f"state; float32 atol={WKV_ATOL}, rtol=1e-5; bfloat16 y rtol=2^-7, "
          f"one ulp); max_abs_err {worst}", flush=True)
    return worst


def check_rglru_kernel(torch, rglru_kernel, rglru_ops, rglru_ref,
                       rng) -> dict:
    """The RG-LRU kernel against its plain version on the card at
    ``RGLRU_CASES``, in the chunks ``kernel.fwd_geometry`` gives each:
    within ``RGLRU_ATOL`` and rtol 1e-5 (float32) or one bf16 ulp, and in
    float32 its first segment bit for bit (the plain version's steps in its
    order from h = 0).  Returns the largest absolute error per dtype."""
    import numpy as np
    worst = {}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        worst[name] = 0.0
        for b, s, w in RGLRU_CASES:
            la = torch.tensor(-np.exp(rng.standard_normal((b, s, w))) * 0.1
                              - 1e-3, dtype=torch.float32, device="cuda")
            bb = torch.tensor(rng.standard_normal((b, s, w)),
                              dtype=torch.float32, device="cuda").to(dtype)
            got = rglru_ops.rglru_scan_op(la, bb)
            want = rglru_ref.reference_rglru(la, bb)
            torch.cuda.synchronize()
            geo = rglru_kernel.fwd_geometry(b, s, w)
            label = (f"rglru {name} (B, S, W) = ({b}, {s}, {w}) "
                     f"({geo.chunks} chunks of {geo.steps} steps)")
            if got.shape != bb.shape or got.dtype != dtype:
                fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
            try:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=RGLRU_ATOL,
                                           rtol=WKV_RTOL[name])
            except AssertionError as err:
                fail(f"{label}: kernel != plain version: {err}")
            seg = geo.steps // rglru_kernel.SCAN_WARPS
            if dtype == torch.float32 \
                    and not torch.equal(got[:, :seg], want[:, :seg]):
                fail(f"{label}: the first segment is not bit for bit the "
                     "plain version")
            worst[name] = max(worst[name],
                              (got.float() - want.float()).abs().max().item())
            n_cases += 1
    print(f"rglru kernel == plain version on {n_cases} cases (float32 "
          f"atol={RGLRU_ATOL}, rtol=1e-5, the first segment bit for bit; "
          f"bfloat16 rtol=2^-7, one ulp); max_abs_err {worst}", flush=True)
    return worst


class ShapeLog:
    """Wraps the kernel launchers ``mods[name].<FWD[name]>``: counts each
    launch's argument shapes (and keywords) while in the ``with``."""

    FWD = {"wkv6": "wkv6_fwd", "rglru": "rglru_fwd",
           "flash": "flash_attention_fwd", "gemm": "expert_gemm_fwd"}

    def __init__(self, mods):
        self.mods = mods
        self.shapes = {name: Counter() for name in mods}
        self.saved = {}

    def __enter__(self):
        for name, mod in self.mods.items():
            fn = self.saved[name] = getattr(mod, self.FWD[name])
            setattr(mod, self.FWD[name], self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            key = (tuple(tuple(a.shape) for a in args),
                   tuple(sorted(kw.items())))
            self.shapes[name][key] += 1
            return fn(*args, **kw)
        return rec

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, self.FWD[name], self.saved[name])


def serve_recurrent(torch, arch, prompt_len, want, cut, check_lens,
                    mods) -> dict:
    """``arch`` at its published width and full depth, served through
    ``serve_batch`` on the card (``serve_on_card``, launches held to
    ``want``); then the first ``cut`` layers' weights on the CPU against
    the card, teacher-forced, on prompts of ``check_lens[dtype]``
    tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import build_model

    # the rglru gates and the card-vs-cpu check are float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(arch)
    out, model, params, rng, _ = serve_on_card(torch, cfg, cfg.num_layers,
                                               prompt_len, want, mods)

    # the first `cut` layers' weights on the CPU against the card: in bf16
    # (the served weights), then in float32 (the same values, widened)
    cut_cfg = dataclasses.replace(cfg, num_layers=cut)
    cut_params = dict(params, blocks=params["blocks"][:cut])
    out["card_vs_cpu"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = dtype_name(dtype)
        check = rng.integers(0, cfg.vocab_size,
                             (1, check_lens[name] + CHECK_STEPS))
        res = card_vs_cpu(
            torch, cut_cfg, build_model(cut_cfg, dtype=dtype),
            tree_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16
                     else t, cut_params), check)
        torch.cuda.empty_cache()
        if name == "float32" and not res["contract_met"]:
            fail(f"card vs cpu, {arch} float32: serving contract missed: "
                 f"{res}")
        if res["max_excess"] > 0 or res["argmax_unexplained"]:
            fail(f"card vs cpu, {arch} {name}: a difference beyond the "
                 f"serving contract that rounding does not explain: {res}")
        out["card_vs_cpu"][name] = res
    return out


# ------------------------------------------ 6c. serving the other families
def ring_vs_full(torch, cfg, model, params, rng, batch_size: int,
                 prompt_len: int) -> dict:
    """gemma2's ring cache against its full cache on the card, at full
    depth: one prefill of ``batch_size`` prompts of ``prompt_len`` tokens
    (drawn from ``rng``), its caches made into rings of min(window, total)
    slots for the local layers (``pad_caches`` under ``window_kv_cache``)
    and into padded full caches, then ``RING_STEPS`` teacher-forced decode
    steps through each: every row's logits within the serving contract of
    the full cache's, an argmax differing only at a near tie
    (``compare_steps``).  Returns the comparison and both caches' K/V
    bytes."""
    import dataclasses

    from repro_torch.launch.serve import pad_caches
    from repro_torch.models.model import build_model

    full_cfg = dataclasses.replace(cfg, window_kv_cache=False)
    full_model = build_model(full_cfg)              # the same weights
    total = prompt_len + RING_STEPS
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch_size, total)),
                             device="cuda")
    t0 = time.perf_counter()
    steps = {"ring": [], "full": []}
    with torch.inference_mode():
        caches, logits = model.prefill_fn(params,
                                          {"tokens": tokens[:, :prompt_len]})
        kv = {"ring": pad_caches(caches, total, cfg),
              "full": pad_caches(caches, total, full_cfg)}
        del caches
        nbytes = {k: sum(t.numel() * t.element_size() for c in v
                         for t in c.values()) for k, v in kv.items()}
        slots = sorted({c["k"].shape[1] for c in kv["ring"]})
        for key in steps:
            steps[key].append(logits[:, 0].float().cpu())
        for i in range(RING_STEPS):
            tok = tokens[:, prompt_len + i:prompt_len + i + 1]
            for key, m in (("ring", model), ("full", full_model)):
                kv[key], logits = m.decode_fn(params, kv[key], tok,
                                              prompt_len + i)
                steps[key].append(logits[:, 0].float().cpu())
        del kv
    torch.cuda.synchronize()
    rows = [(s[r:r + 1], f[r:r + 1]) for s, f in zip(steps["ring"],
                                                    steps["full"])
            for r in range(batch_size)]
    res = compare_steps(torch, [a for a, _ in rows], [b for _, b in rows])
    out = dict(prompt=prompt_len, steps=RING_STEPS, ring_slots=slots,
               kv_bytes_ring=nbytes["ring"], kv_bytes_full=nbytes["full"],
               contract_met=res["contract_met"],
               max_abs_err=max(res["max_abs_err"]),
               max_excess=res["max_excess"],
               argmax_differ=sum(not a for a in res["argmax_equal"]),
               argmax_unexplained=res["argmax_unexplained"],
               seconds=time.perf_counter() - t0)
    print(f"ring vs full cache, {cfg.name} ({cfg.num_layers} layers, "
          f"{batch_size} x {prompt_len}-token prompts, {RING_STEPS} "
          f"teacher-forced steps): ring slots {slots} against {total}; K/V "
          f"{nbytes['ring']} B against {nbytes['full']} B; contract "
          f"{'met' if out['contract_met'] else 'MISSED'}, max abs error "
          f"{out['max_abs_err']!r}, argmax differing in "
          f"{out['argmax_differ']} of {len(rows)} ({out['argmax_unexplained']}"
          f" not at a near tie); {out['seconds']:.1f} s", flush=True)
    if res["max_excess"] > 0 or res["argmax_unexplained"] \
            or slots != sorted({min(cfg.window_size, total), total}):
        fail(f"ring vs full cache, {cfg.name}: {out}")
    return out


def serve_family(torch, arch, batch_size, prompt_len, frames, n_flash, cut,
                 mods) -> dict:
    """``arch`` at its published width and full depth, served through
    ``serve_batch`` on the card (``serve_on_card``: exactly ``n_flash``
    bf16 flash launches and nothing else), gemma2 under its ring cache and
    then its ring against the full cache (``ring_vs_full``); then the
    weights cut to ``cut`` on the card against the CPU, teacher-forced on a
    ``CHECK_PROMPT``-token prompt after the stub front end's full-size
    inputs: the CPU runs once, in float32 on the served (bf16) values, and
    holds the card in bf16 (the served weights: the serving contract, an
    argmax differing only at a near tie) and in float32 (the same values
    widened: the serving contract).  bf16 products on the CPU are slow
    (phase 7's recurrentgemma check), so this phase runs none."""
    import dataclasses

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(arch)
    if arch == GEMMA_ARCH:
        cfg = dataclasses.replace(cfg, window_kv_cache=True)
    layers = (f"{cfg.num_layers} + {cfg.num_decoder_layers}"
              if cfg.arch_type == "encdec" else cfg.num_layers)
    t0 = time.perf_counter()
    out, model, params, rng, media = serve_on_card(
        torch, cfg, layers, prompt_len, {"flash": ("bfloat16", n_flash)},
        mods, batch_size=batch_size, frames=frames)
    del media
    out["seconds"] = {"serve": time.perf_counter() - t0}
    if cfg.window_kv_cache:
        out["ring_vs_full"] = ring_vs_full(torch, cfg, model, params, rng,
                                           batch_size, prompt_len)
        out["seconds"]["ring_vs_full"] = out["ring_vs_full"]["seconds"]
    t0 = time.perf_counter()
    # keep only the cut's weights on the card
    if cfg.arch_type == "encdec":
        cut_params = dict(params, enc_blocks=params["enc_blocks"][
            :cut["num_layers"]], dec_blocks=params["dec_blocks"][
                :cut["num_decoder_layers"]])
    else:
        cut_params = dict(params, blocks=params["blocks"][:cut["num_layers"]])
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = cut_vs_cpu(torch, cfg, cut, cut_params, rng, frames)
    out["seconds"]["card_vs_cpu"] = time.perf_counter() - t0
    return out


def cut_vs_cpu(torch, cfg, cut, cut_params, rng, frames: int = 0) -> dict:
    """The weights ``cut_params`` of ``cfg`` cut to ``cut`` on the card
    against the CPU, teacher-forced on a ``CHECK_PROMPT``-token prompt
    drawn from ``rng`` after the stub front end's full-size inputs
    (``frames`` encoder frames): the CPU runs once, in float32 on the
    served (bf16) values, and holds the card in bf16 (the served weights:
    the serving contract, an argmax differing only at a near tie) and in
    float32 (the same values widened: the serving contract).  bf16 products
    on the CPU are slow (phase 7's recurrentgemma check), so this runs
    none."""
    import dataclasses

    from repro_torch.launch.serve import stub_media
    from repro_torch.models.model import build_model

    cut_cfg = dataclasses.replace(cfg, **cut)
    check = rng.integers(0, cfg.vocab_size, (1, CHECK_PROMPT + CHECK_STEPS))
    check_media = stub_media(cfg, 1, rng, frames)
    t0 = time.perf_counter()
    wide = tree_map(lambda t: t.cpu().to(torch.float32), cut_params)
    cpu = forced_logits(torch, build_model(cut_cfg, device="cpu",
                                           dtype=torch.float32),
                        wide, check, check_media)
    cpu_s = time.perf_counter() - t0
    del wide
    out = {"cpu_s": cpu_s}
    for dtype in (torch.bfloat16, torch.float32):
        name = dtype_name(dtype)
        card = forced_logits(
            torch, build_model(cut_cfg, dtype=dtype),
            tree_map(lambda t: t.to(dtype), cut_params), check, check_media)
        torch.cuda.empty_cache()
        res = dict(layers=cut, prompt=CHECK_PROMPT, steps=CHECK_STEPS,
                   **compare_steps(torch, card, cpu))
        print(f"card vs cpu, {cfg.name} {name} against the cpu's float32 "
              f"run on the same values ({cut}, {CHECK_PROMPT}-token prompt"
              f"{' after the front end' if check_media else ''}, "
              f"{CHECK_STEPS} teacher-forced steps): serving contract "
              f"{'met' if res['contract_met'] else 'MISSED'}; max abs error "
              f"{res['max_abs_err']}; argmax equal {res['argmax_equal']} "
              f"(cpu top-two gaps {res['cpu_top2_gap']}); cpu {cpu_s:.1f} s",
              flush=True)
        if name == "float32" and not res["contract_met"]:
            fail(f"card vs cpu, {cfg.name} float32: serving contract missed: "
                 f"{res}")
        if res["max_excess"] > 0 or res["argmax_unexplained"]:
            fail(f"card vs cpu, {cfg.name} {name}: a difference beyond the "
                 f"serving contract that rounding does not explain: {res}")
        out[name] = res
    return out


# ---------------------------------------------------------- 10. the examples
# the configs the card had never served (ROADMAP C2), each at its published
# width and full depth in bf16 through the serve example's loop body
# (serve_batched.serve_one) on the serve cells' batch, then cut to
# EXAMPLE_CHECK on the card against the CPU (cut_vs_cpu)
EXAMPLE_SERVES = ("tinyllama-1.1b", "llama3.2-3b", "smollm-360m")
EXAMPLE_CHECK = {"num_layers": 2}
# train_moe_ccm: the example's run (a checkpoint every 50 steps, its
# constant) with --steps EXAMPLE_TRAIN_STEPS, then the same failing at
# EXAMPLE_FAIL_AT, restarted from its step-50 checkpoint: its losses from
# there within TRAIN_RESTART_RTOL of the uninterrupted run's.  Both under
# deterministic algorithms (the expert combine's index_add_ is otherwise
# atomic).  The example's own 300 steps made the pair 121-144 s of the
# smoke (0.16-0.19 s a step), so the smoke's wall takes it at 100
EXAMPLE_TRAIN_STEPS, EXAMPLE_FAIL_AT, EXAMPLE_CKPT_EVERY = 100, 60, 50


def same_quickstart(a, b) -> bool:
    return (same_run(a.result, b.result) and a.best == b.best
            and (a.initial_max_work, a.initial_imbalance)
            == (b.initial_max_work, b.initial_imbalance)
            and (a.milp.status, a.milp.objective, a.milp.nodes)
            == (b.milp.status, b.milp.objective, b.milp.nodes))


def summarize_example(name, r) -> dict:
    """The numbers an example printed, for the examples JSON."""
    if name == "quickstart":
        return dict(initial_max_work=r.initial_max_work,
                    max_work=float(r.result.max_work[-1]),
                    imbalance=float(r.result.imbalance[-1]),
                    transfers=r.result.transfers, best_of_12=r.best,
                    milp=dict(status=r.milp.status,
                              objective=float(r.milp.objective),
                              nodes=r.milp.nodes, seconds=r.milp.wall_s))
    if name == "async_balancer":
        return {tag: dict(transfers=res.transfers,
                          imbalance=[res.imbalance[0], res.imbalance[-1]],
                          messages=res.messages, conflicts=res.lock_conflicts,
                          yields=res.yields, chains=res.grant_chains,
                          dead=res.dead_ranks, joined=res.joined_ranks)
                for tag, res in r.items()}
    return dict(
        cold_transfers=[x.result.transfers for x in r.cold.runs],
        warm_transfers=[x.result.transfers for x in r.warm.runs],
        cold_s=r.cold.total_seconds, warm_s=r.warm.total_seconds,
        cold_over_warm=r.cold.total_seconds / r.warm.total_seconds,
        seqpack_imbalance=[[x.imbalance_before, x.imbalance_after]
                           for x in r.stream])


def balancer_examples(torch, kernel, launch) -> dict:
    """``quickstart``, ``async_balancer`` and ``pipeline_phases`` as their
    ``run`` goes on the card, and ``quickstart`` first on the CPU: its
    results equal (assignments, transfer logs, traces, counters, the
    MILP's status, objective and nodes); every run's pair kernel launched
    exactly once a scorer call (counted from zero just before the card
    run) and nothing else of the scorer.  The other two examples' CPU runs
    were cut to keep the smoke's wall (``async_path`` and
    ``pipeline_path`` hold their drivers card against CPU, and
    ``tests/test_torch_examples.py`` the examples against the JAX
    package)."""
    from repro_torch.examples import (async_balancer, pipeline_phases,
                                      quickstart)
    out = {}
    for name, mod, same in (("quickstart", quickstart, same_quickstart),
                            ("async_balancer", async_balancer, None),
                            ("pipeline_phases", pipeline_phases, None)):
        cpu, cpu_s, cpu_calls = None, None, None
        if same is not None:
            launch.reset_stats()
            t0 = time.perf_counter()
            cpu = mod.run("cpu")
            cpu_s = time.perf_counter() - t0
            cpu_calls = launch.STATS["calls"]
        kernel.reset_launches()
        launch.reset_stats()
        t0 = time.perf_counter()
        card = mod.run("cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        n, calls = kernel.PAIR_LAUNCHES["float64"], launch.STATS["calls"]
        if same is not None and not same(card, cpu):
            fail(f"example {name}: the card's run differs from the cpu's")
        if (n == 0 or n != calls
                or (cpu_calls is not None and calls != cpu_calls)
                or kernel.PAIR_LAUNCHES["float32"]
                or sum(kernel.LAUNCHES.values())
                or sum(kernel.SPEC_LAUNCHES.values())):
            fail(f"example {name}: pair launches {kernel.PAIR_LAUNCHES} vs "
                 f"scorer calls {calls} (cpu run {cpu_calls}), full-tile "
                 f"{kernel.LAUNCHES}, window {kernel.SPEC_LAUNCHES}")
        out[name] = dict(cuda_s=card_s, cpu_s=cpu_s, pair_launches=n,
                         scorer_calls=calls,
                         result=summarize_example(name, card))
        print(f"example {name}: "
              + ("the card's run equals the cpu's; " if same else "")
              + f"{n} pair launches = scorer calls; wall cuda {card_s!r} s"
              + ("" if cpu_s is None else f", cpu {cpu_s!r} s"), flush=True)
    return out


def assembly_example(torch, kernel, launch, asm_kernel) -> dict:
    """``assembly_e2e``: with analytic durations on the CPU and the card
    (the A/B/C makespans, the placement and the homing plan equal, no
    tile launch), then as the example goes, measured on the card: every
    task of the training and the target configurations timed (tile
    launches exactly ``repeats * tasks + signatures`` of each), the cost
    model trained on the card, CCM-LB on the pair kernel (launches equal
    to scorer calls)."""
    from repro_torch.assembly import balance_assembly
    from repro_torch.examples import assembly_e2e
    cpu = assembly_e2e.run("cpu", durations="analytic").run
    kernel.reset_launches()
    launch.reset_stats()
    asm_kernel.reset_launches()
    card = assembly_e2e.run("cuda", durations="analytic").run
    torch.cuda.synchronize()
    n_analytic = kernel.PAIR_LAUNCHES["float64"]
    if not same_assembly_run(card, cpu):
        fail("example assembly_e2e (analytic): the card's run differs from "
             "the cpu's")
    if (n_analytic == 0 or n_analytic != launch.STATS["calls"]
            or asm_kernel.LAUNCHES["float32"]):
        fail(f"example assembly_e2e (analytic): pair launches {n_analytic} "
             f"vs scorer calls {launch.STATS['calls']}, tile launches "
             f"{asm_kernel.LAUNCHES}")
    kernel.reset_launches()
    launch.reset_stats()
    asm_kernel.reset_launches()
    # the example's measured run stops before its homing, which is planned
    # here as the assembly phase does: where the reference's homing raises
    # (HOMING_FAULTS) on the placement the measured durations' cost model
    # gave, the check is that the CPU's placement from the same model is
    # the card's and its homing raises the same error
    t0 = time.perf_counter()
    demo = assembly_e2e.run("cuda", home=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tiles = asm_kernel.LAUNCHES["float32"]
    n = kernel.PAIR_LAUNCHES["float64"]
    n_calls = launch.STATS["calls"]
    want = sum(2 * p.num_tasks + len(signatures(p))
               for p in (demo.train_problem, demo.run.problem))
    if tiles != want or n == 0 or n != n_calls:
        fail(f"example assembly_e2e: {tiles} tile launches (expected "
             f"{want}), pair launches {n} vs scorer calls {n_calls}")
    run, fault = home(demo.run)
    if fault is not None:
        cpu_run = balance_assembly(**assembly_e2e.TARGET,
                                   durations="analytic", cost_model=demo.model,
                                   device="cpu")
        if not same_placement(run, cpu_run):
            fail("example assembly_e2e: the card's CCM-LB placement differs "
                 "from the CPU's from the same cost model")
        cpu_fault = home(cpu_run)[1]
        if cpu_fault != fault:
            fail(f"example assembly_e2e: homing raised '{fault}' on the "
                 f"card's placement, the CPU's gave {cpu_fault!r}")
        print(f"example assembly_e2e: homing raised '{fault}' on the card's "
              "and the cpu's placement alike (the reference's fault, "
              "ROADMAP queue 3)", flush=True)
    homing_s = run.homing.est_time_s if run.homing else 0.0
    out = dict(
        analytic=dict(pair_launches=n_analytic,
                      makespans=[card.makespan_baseline,
                                 card.makespan_overdecomposed,
                                 card.makespan_ccmlb],
                      speedups=[card.speedup_overdecomposed,
                                card.speedup_ccmlb]),
        measured=dict(
            wall_s=wall, tile_launches=tiles, pair_launches=n,
            tasks=[demo.train_problem.num_tasks, run.problem.num_tasks],
            train_durations_us=[float(demo.train_durations.min() * 1e6),
                                float(demo.train_durations.max() * 1e6)],
            cost_model=demo.metrics,
            makespans=[run.makespan_baseline, run.makespan_overdecomposed,
                       run.makespan_ccmlb],
            speedups=[run.speedup_overdecomposed, run.speedup_ccmlb],
            homing_s=homing_s, homing_fault=fault,
            homing_waves=len(run.homing.waves) if run.homing else 0,
            imbalance=[run.imbalance_before, run.imbalance_after],
            off_home=run.n_off_home_ranks, stage_s=run.stage_seconds))
    print(f"example assembly_e2e: analytic run on the card equals the "
          f"cpu's ({n_analytic} pair launches); measured on the card: "
          f"{tiles} tile launches, {n} pair launches, A/B/C "
          f"{out['measured']['makespans']} s, speedups "
          f"{out['measured']['speedups']}, wall {wall!r} s", flush=True)
    return out


def expected_serve_launches(cfg, max_new: int) -> dict:
    """A ``serve_batch`` run's kernel launches ({kernel: {dtype: n}}): one
    flash a prefill's attention layer, one WKV6 or RG-LRU scan (float32,
    the model's gates) a recurrent layer's prefill, three expert GEMMs an
    MoE layer's forward (the prefill and every decode step)."""
    from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL,
                                          BLOCK_MOE, BLOCK_REC, BLOCK_RWKV)
    want = {k: {"bfloat16": 0, "float32": 0}
            for k in ("flash", "gemm", "wkv6", "rglru")}
    for kind in cfg.layer_kinds():
        if kind in (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE):
            want["flash"]["bfloat16"] += 1
        if kind == BLOCK_MOE:
            want["gemm"]["bfloat16"] += 3 * (1 + max_new)
        if kind == BLOCK_RWKV:
            want["wkv6"]["bfloat16"] += 1
        if kind == BLOCK_REC:
            want["rglru"]["float32"] += 1
    return want


def serve_examples(torch, mods) -> dict:
    """``serve_batched`` as its ``run`` goes on the card (the four smoke
    configs, bf16), launches summed over the four and held to
    ``expected_serve_launches``; then the configs of ``EXAMPLE_SERVES``
    (``serve_published``)."""
    from repro_torch import configs
    from repro_torch.examples import serve_batched
    for mod in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    served = serve_batched.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: dict(mod.LAUNCHES) for name, mod in mods.items()}
    want = {k: {"bfloat16": 0, "float32": 0} for k in mods}
    for arch in serve_batched.ARCHS:
        for k, by in expected_serve_launches(
                configs.get_smoke_config(arch), 16).items():
            for dt, n in by.items():
                want[k][dt] += n
    if launches != want:
        fail(f"example serve_batched: launches {launches}, expected {want}")
    out = {"smoke": dict(
        wall_s=wall, launches=launches,
        runs={s.arch: dict(seconds=s.seconds, tokens_per_s=s.tokens_per_s,
                           first_row=s.tokens[0, :8].tolist())
              for s in served})}
    print(f"example serve_batched: four smoke configs on the card, "
          f"launches {launches} as expected; "
          + ", ".join(f"{s.arch} {s.tokens_per_s:.1f} tok/s"
                      for s in served), flush=True)
    del served
    for arch in EXAMPLE_SERVES:
        out[arch] = serve_published(torch, arch, mods)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_published(torch, arch, mods) -> dict:
    """``arch`` at its published width and full depth served through
    ``serve_batched.serve_one`` on the card (bf16, the port's init on the
    card; ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens from numpy
    seed 0, ``SERVE_NEW`` new tokens): launches counted from zero, exactly
    one flash a layer and nothing else; the same prompts served again with
    each prefill and decode step on CUDA events (uncounted); then the
    weights cut to ``EXAMPLE_CHECK`` on the card against the CPU."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.examples import serve_batched
    from repro_torch.launch.serve import serve_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(arch)
    rng = np.random.default_rng(0)
    for mod in mods.values():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with ShapeLog(mods) as log:
        t0 = time.perf_counter()
        s = serve_batched.serve_one(cfg, "cuda", torch.bfloat16, rng=rng,
                                    batch=SERVE_BATCH,
                                    prompt_len=SERVE_PROMPT,
                                    max_new=SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: dict(mod.LAUNCHES) for name, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    want = expected_serve_launches(cfg, SERVE_NEW)
    if launches != want or want["flash"]["bfloat16"] != cfg.num_layers:
        fail(f"serve {arch}: launches {launches}, expected {want}")
    if s.tokens.shape != (SERVE_BATCH, SERVE_NEW) or s.tokens.min() < 0 \
            or s.tokens.max() >= cfg.vocab_size:
        fail(f"serve {arch}: bad tokens {s.tokens.shape}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    clock = StepClock(torch, s.model)
    again = serve_batch(s.model, s.params, prompts, SERVE_NEW)
    clock.restore()
    decode_s = clock.seconds("decode")
    if not (np.array_equal(again, s.tokens)
            and torch.isfinite(clock.logits).all()):
        fail(f"serve {arch}: the same prompts served again gave other "
             "tokens or non-finite logits")
    n_params = sum(t.numel() for t in tree_leaves(s.params))
    out = dict(
        arch=cfg.name, layers=cfg.num_layers, q_heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        params=n_params, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
        new_tokens=SERVE_NEW, wall_s=wall, serve_s=s.seconds,
        tokens_per_s=s.tokens_per_s, prefill_s=clock.seconds("prefill")[0],
        decode_step_s_median=float(np.median(decode_s)),
        decode_step_s_min=min(decode_s), decode_step_s_max=max(decode_s),
        peak_memory_gb=peak / 1e9, launches=launches,
        shapes={name: [[list(k), n] for k, n in c.most_common()]
                for name, c in log.shapes.items() if c},
        log_shapes=log.shapes)
    print(f"serve {cfg.name} (example serve_batched.serve_one): "
          f"{cfg.num_layers} layers, {n_params} parameters; {SERVE_BATCH} x "
          f"{SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens in "
          f"{s.seconds!r} s ({s.tokens_per_s!r} tok/s; {wall!r} s with the "
          f"build and init); again: prefill {out['prefill_s']!r} s, decode "
          f"step median {out['decode_step_s_median']!r} s; peak "
          f"{peak / 1e9!r} GB; launches {launches}", flush=True)
    cut_params = dict(s.params, blocks=s.params["blocks"][
        :EXAMPLE_CHECK["num_layers"]])
    del s, clock
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = cut_vs_cpu(torch, cfg, EXAMPLE_CHECK, cut_params,
                                    rng)
    return out


def train_example(torch, mods) -> dict:
    """``train_moe_ccm`` on the card as the example goes (``CONFIG_100M``,
    8 x 256 tokens a step, lr 1e-3, a checkpoint and a re-placement every
    50 steps) for ``EXAMPLE_TRAIN_STEPS`` steps (its ``--steps``), then
    failing at ``EXAMPLE_FAIL_AT`` under
    ``run_with_restarts``, both into temporary directories this removes
    and under deterministic algorithms: every step's launches exactly
    ``expected_train_launches``, the loss falling, the restarted run
    restoring its step-50 checkpoint and landing within
    ``TRAIN_RESTART_RTOL`` of the uninterrupted run."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.examples import train_moe_ccm
    cfg = train_moe_ccm.CONFIG_100M
    want_step = expected_train_launches(cfg)
    tmp = Path(tempfile.mkdtemp(prefix="moe_ccm_"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mod in mods.values():
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = train_moe_ccm.run("cuda", steps=EXAMPLE_TRAIN_STEPS,
                                  ckpt_dir=str(tmp / "whole"))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        last = max((tmp / "whole").glob("step_*"))
        ckpt_bytes = sum(f.stat().st_size for f in last.rglob("*")
                         if f.is_file())
        shutil.rmtree(tmp / "whole")
        t0 = time.perf_counter()
        failed = train_moe_ccm.run("cuda", steps=EXAMPLE_TRAIN_STEPS,
                                   ckpt_dir=str(tmp / "failed"),
                                   fail_at=EXAMPLE_FAIL_AT)
        fault_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    steps = len(whole.losses)
    if any(rec != want_step for rec in whole.log.launches
           + failed.log.launches):
        fail(f"example train_moe_ccm: launches a step "
             f"{whole.log.launches[:2]} ... (expected {want_step})")
    losses = np.asarray(whole.losses)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and whole.stats.restarts == 0 and whole.stats.completed):
        fail(f"example train_moe_ccm: losses {losses[[0, -1]]}, "
             f"{whole.stats}")
    first = EXAMPLE_FAIL_AT // EXAMPLE_CKPT_EVERY * EXAMPLE_CKPT_EVERY
    agree = len(failed.losses) == steps - first and np.allclose(
        failed.losses, losses[first:], rtol=TRAIN_RESTART_RTOL, atol=0)
    if not (failed.stats.completed and failed.stats.restarts == 1
            and failed.log.restored_from == [first] and agree):
        fail(f"example train_moe_ccm --fail-at {EXAMPLE_FAIL_AT}: "
             f"{failed.stats}, restored from {failed.log.restored_from}, "
             f"losses {failed.losses} against {whole.losses[first:]}")
    step_s = sorted(whole.log.step_s)
    med = step_s[len(step_s) // 2]
    # a run writes every EXAMPLE_CKPT_EVERY steps and at its last step; the
    # failed run writes the same steps, over its two attempts
    n_ckpt = len(set(range(EXAMPLE_CKPT_EVERY, steps + 1,
                           EXAMPLE_CKPT_EVERY)) | {steps})
    out = dict(
        params=whole.n_params, steps=steps, losses_first_last=[
            float(losses[0]), float(losses[-1])],
        step_s_median=med, step_s_min=step_s[0], step_s_max=step_s[-1],
        tokens_per_s=8 * 256 / med, wall_s=wall, peak_gb=peak / 1e9,
        launches_per_step=want_step,
        launches={k: sum(rec[k] for rec in whole.log.launches
                         + failed.log.launches) for k in want_step},
        replacements=whole.log.replacements,
        checkpoint_bytes=ckpt_bytes, checkpoints_written=2 * n_ckpt,
        restart=dict(fail_at=EXAMPLE_FAIL_AT, restarts=failed.stats.restarts,
                     restored_from=failed.log.restored_from,
                     wall_s=fault_wall,
                     max_rel_diff=float(np.max(np.abs(
                         np.asarray(failed.losses) - losses[first:])
                         / np.abs(losses[first:]))),
                     steps_run=len(failed.log.steps)))
    print(f"example train_moe_ccm: {whole.n_params} parameters, {steps} "
          f"steps, loss {losses[0]!r} -> {losses[-1]!r}; step s median "
          f"{med!r} (min {step_s[0]!r}, max {step_s[-1]!r}), "
          f"{out['tokens_per_s']!r} tokens/s, run {wall:.1f} s, peak "
          f"{peak / 1e9!r} GB; launches a step {want_step}; a checkpoint "
          f"{ckpt_bytes} B, {2 * n_ckpt} written; --fail-at "
          f"{EXAMPLE_FAIL_AT}: restored from {failed.log.restored_from}, "
          f"losses within {out['restart']['max_rel_diff']!r} of the "
          f"uninterrupted run's, {fault_wall:.1f} s", flush=True)
    return out


def examples_path(torch, kernel, launch, asm_kernel, mods) -> dict:
    """Phase 10: the six examples of ``repro_torch.examples`` on the card
    (``balancer_examples``, ``assembly_example``, ``serve_examples``,
    ``train_example``), each counted from zero and timed."""
    out = {}
    t0 = time.perf_counter()
    out["balancers"] = balancer_examples(torch, kernel, launch)
    out["assembly_e2e"] = assembly_example(torch, kernel, launch, asm_kernel)
    out["seconds"] = {"balancers": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["serve_batched"] = serve_examples(torch, mods)
    out["seconds"]["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train_moe_ccm"] = train_example(torch, mods)
    out["seconds"]["train"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------------- 8. timing
def time_ms(torch, fn, reps: int, rounds: int = 7) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls, from CUDA
    events around the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2]


def bound(name: str, e_n: int, a_n: int, b_n: int):
    """Least time for the work on an H100 SXM: the larger of the bytes
    (each input read once, the output written once) over the HBM rate and
    the operations over the peak rate of the dtype."""
    from repro_torch.kernels.ccm_scorer.layout import N_AV, N_OUT, N_PM, N_SC
    size = 8 if name == "float64" else 4
    nbytes = size * e_n * (N_AV * (a_n + b_n) + N_PM * a_n * b_n + N_SC
                           + N_OUT * a_n * b_n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_n * a_n * b_n * OPS_PER_LANE / PEAK_OPS[name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_kernel(torch, kernel, ref, rng, shapes) -> dict:
    """Kernel, plain version and bound at the two shapes each dtype's main
    path launched most, and at one large tile."""
    times = {}
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        top = [k for k, _ in shapes[name].most_common(2)]
        for e_n, a_n, b_n in top + [(64, 128, 128)]:
            t = random_tiles(torch, rng, dtype, e_n, a_n, b_n)
            k_ms = time_ms(torch, lambda: kernel.score_tiles(*t), 200)
            k_dev = device_ms(torch, lambda: kernel.score_tiles(*t))
            p_ms = time_ms(torch, lambda: ref.score_tiles(*t), 20)
            b_ms, b_by, nbytes = bound(name, e_n, a_n, b_n)
            key = f"E={e_n},A={a_n},B={b_n}"
            times.setdefault(name, {})[key] = dict(
                ms=k_ms, device_ms=k_dev, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by,
                bytes=nbytes, main_path_launches=shapes[name][(e_n, a_n,
                                                               b_n)])
            print(f"time {name} {key}: kernel {k_ms!r} ms (device {k_dev!r} "
                  f"ms), plain {p_ms!r} ms, bound {b_ms!r} ms ({b_by}, {nbytes} B)", flush=True)
    return times


def pair_bound(name: str, e_n: int, p_total: int, a_cols: int,
               b_cols: int):
    """Least time of the fused pair scorer's work on an H100 SXM: bytes of
    the pm entries at the pairs, the distinct a- and b-columns read, the
    scalar rows (in the dtype), the float64 combine rows, the int32 offsets
    and pairs, and the (3, P) float64 result, each once, over the HBM rate;
    against the scorer's operations per pair in the dtype plus the
    combine's float64 ones, over the peak rates."""
    from repro_torch.kernels.ccm_scorer.layout import N_AV, N_CF, N_PM, N_SC
    size = 8 if name == "float64" else 4
    nbytes = (size * (N_PM * p_total + N_AV * (a_cols + b_cols)
                      + N_SC * e_n)
              + 8 * N_CF * e_n + 4 * (e_n + 1) + 8 * p_total + 24 * p_total)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (p_total * OPS_PER_LANE / PEAK_OPS[name]
             + p_total * COMBINE_OPS / PEAK_OPS["float64"]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_pairs(torch, kernel, ref, launch, rng, pair_shapes) -> dict:
    """The fused pair kernel at the two (E, A, B, P) each dtype's main path
    launched most, and at E = 64, A = B = 128, P = 32 an event: the launch
    between events (``ms``) and queued behind a sleep (``device_ms``, and
    the host's time to queue one launch), the launcher's host time a call
    (``launch.score_events``: pack, copies, launch, wait and results, with
    its split), the plain version and the bound.  Each shape's launch is
    held to the plain version first."""
    import numpy as np
    from repro_torch.core import CCMParams
    params = CCMParams()
    dev = torch.device("cuda")
    times = {}
    for dtype in (torch.float64, torch.float32):
        name = dtype_name(dtype)
        top = [k for k, _ in pair_shapes[name].most_common(2)]
        for e_n, a_n, b_n, p_total in top + [(64, 128, 128, 64 * 32)]:
            counts = [p_total // e_n + (k < p_total % e_n)
                      for k in range(e_n)]
            feats, pairs = pair_events(rng, e_n, a_n, b_n, counts)
            t = pair_inputs(torch, launch, dtype, feats, pairs, params)
            out = torch.empty((3, p_total), dtype=torch.float64, device=dev)
            ptrs = [x.data_ptr() for x in t] + [out.data_ptr()]

            def launch_one():
                kernel.launch_pairs(dtype, *ptrs, e_n, a_n, b_n, p_total,
                                    params.memory_constraint,
                                    torch.cuda.current_stream().cuda_stream)

            key = f"E={e_n},A={a_n},B={b_n},P={p_total}"
            launch_one()
            want = ref.score_pairs_packed(*t, params.memory_constraint)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"pair kernel != plain version at {name} {key}")
            k_ms = time_ms(torch, launch_one, 200)
            k_dev, q_host = queued_ms(torch, launch_one)
            p_ms = time_ms(torch, lambda: ref.score_pairs_packed(
                *t, params.memory_constraint), 20)
            reps = 200 if e_n * a_n * b_n < 10 ** 5 else 20
            launch.reset_stats()
            for _ in range(reps):
                launch.score_events(feats, pairs, params, device=dev,
                                    dtype=dtype)
            host_ms = launch.STATS["seconds"] / reps * 1e3
            split = {k: v / reps * 1e3
                     for k, v in launch.STATS["split"].items()}
            a_cols = sum(len(np.unique(pr[:, 0])) for pr in pairs)
            b_cols = sum(len(np.unique(pr[:, 1])) for pr in pairs)
            b_ms, b_by, nbytes = pair_bound(name, e_n, p_total, a_cols,
                                            b_cols)
            times.setdefault(name, {})[key] = dict(
                ms=k_ms, device_ms=k_dev, queue_host_ms=q_host,
                host_ms=host_ms, host_split_ms=split, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                main_path_launches=pair_shapes[name][(e_n, a_n, b_n,
                                                      p_total)])
            print(f"time pairs {name} {key}: kernel {k_ms!r} ms (device "
                  f"{k_dev!r} ms, queued in {q_host!r} ms), launcher "
                  f"{host_ms!r} ms a call {split}, plain {p_ms!r} ms, "
                  f"bound {b_ms!r} ms ({b_by}, {nbytes} B)", flush=True)
    return times


def spec_bound(buf, lanes: int, p_n: int):
    """Least time of the window kernel's work on these rows on an H100
    SXM: the rows read once and (W, 4) written once over the HBM rate,
    against this data's float64 operations over the float64 peak: each
    real edge's scatter add, the slice sums (four per group over a side's
    lanes, the eight flow sums) and, per valid shortlist slot, the scorer
    tree, the combine and the selection (pad rows need none)."""
    from repro_torch.kernels.ccm_scorer.layout import (spec_edge_bucket,
                                                       spec_groups,
                                                       spec_offsets)
    w_n, row_len = buf.shape
    eb = spec_edge_bucket(row_len, lanes, lanes, p_n)
    g_n = spec_groups(lanes, lanes)[2]
    o_ms = spec_offsets(eb, lanes, lanes, p_n)[7]
    counts = buf[:, o_ms + 5]
    real = counts > 0
    edges = int(((buf[:, :eb] != 0) & real[:, None]).sum().item())
    slots = int(counts.sum().item())
    ops = (edges + int(real.sum().item()) * (4 * g_n * lanes + 8 * lanes)
           + slots * (OPS_PER_LANE + COMBINE_OPS + SPEC_SLOT_OPS))
    nbytes = 8 * w_n * row_len + 8 * 4 * w_n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float64"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def time_spec(torch, kernel, ref, launch, shape, n_main: int, raws,
              lanes: int, p_n: int) -> dict:
    """The window kernel at ``shape`` (W, eb), which a main path launched
    ``n_main`` times, on real rows: those of that edge bucket where
    ``raws`` has them (the 256-rank spec runs), else ``raws`` as captured
    (the fleet's rows, mixed buckets padded to eb as in its windows).  The
    launch between events (``ms``), queued behind a sleep (``device_ms``,
    and the host's time to queue one launch), the launcher's host time a
    call (``score_spec``: stacking, copies, launch, wait; with its split),
    the plain version and the bound.  The launch is held to the plain
    version first."""
    w_n, eb = shape
    same = [r for r in raws if r[1] == eb] or raws
    rows = [same[i % len(same)] for i in range(w_n)]
    buf = spec_buffer(torch, launch, rows, lanes, p_n)
    if buf.shape[0] != w_n or max(e for _, e in rows) != eb:
        fail(f"time_spec: built W={buf.shape[0]}, eb="
             f"{max(e for _, e in rows)} for ({w_n}, {eb})")
    out = torch.empty((w_n, 4), dtype=torch.float64, device="cuda")

    def launch_one():
        kernel.launch_spec(buf.data_ptr(), out.data_ptr(), 0, w_n, eb,
                           lanes, lanes, p_n, buf.stride(0),
                           torch.cuda.current_stream().cuda_stream)

    launch_one()
    want = ref.score_spec_rows(buf, lanes, lanes, p_n)
    torch.cuda.synchronize()
    if not same_bits(torch, out, want):
        fail(f"window kernel != plain version at W={w_n}, eb={eb}")
    k_ms = time_ms(torch, launch_one, 200)
    k_dev, q_host = queued_ms(torch, launch_one)
    p_ms = time_ms(torch, lambda: ref.score_spec_rows(buf, lanes, lanes,
                                                      p_n), 3, rounds=3)
    launch.reset_stats()
    reps = 200
    for _ in range(reps):
        launch.score_spec(rows, a_lanes=lanes, b_lanes=lanes, p_n=p_n,
                          device=torch.device("cuda"))
    rec = launch.STATS["spec"]
    host_ms = rec["seconds"] / reps * 1e3
    split = {k: v / reps * 1e3 for k, v in rec["split"].items()}
    b_ms, b_by, nbytes, ops = spec_bound(buf, lanes, p_n)
    key = f"W={w_n},eb={eb},A=B={lanes},P={p_n}"
    print(f"time spec {key}: kernel {k_ms!r} ms (device {k_dev!r} ms, "
          f"queued in {q_host!r} ms), launcher {host_ms!r} ms a call "
          f"{split}, plain {p_ms!r} ms, bound {b_ms!r} ms ({b_by}, {nbytes} "
          f"B, {ops} operations); {n_main} main-path launches at this "
          f"shape", flush=True)
    return dict(shape=key, ms=k_ms, device_ms=k_dev, queue_host_ms=q_host,
                host_ms=host_ms, host_split_ms=split, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops,
                main_path_launches=n_main)


def task_inputs(torch, problem, sig):
    """The inputs of the first task of ``problem`` with signature ``sig``
    (rows, cols, quad order), on the card."""
    from repro_torch.assembly.execute import _task_inputs
    task = next(t for t in problem.tasks
                if (len(t.rows), len(t.cols), t.quad_order) == sig)
    return _task_inputs(problem, task, torch.device("cuda"))


def device_us(ev) -> float:
    """Device microseconds of a profiler row (the attribute's name differs
    between torch versions)."""
    dev_us = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if dev_us is None else dev_us


def profiled_run(torch, run) -> dict:
    """``run()`` under ``torch.profiler``: its wall time, the device time
    and count of each kernel, copy and set by name, their busy total, and
    the device's idle share of the wall time.  The profiler can leave a
    few kernels unrecorded, so their number is counted: the kernel launch
    calls it recorded on the host (``cudaLaunchKernel*``,
    ``cuLaunchKernel*``) less the kernels it recorded on the card.  The
    idle share is given only where none is missing; the bounds always are,
    the lower one counting each missing kernel as long as the longest one
    recorded.  The run starts and ends ``PROFILE_MARGIN_S`` inside the
    profiled window, where fewer kernels went unrecorded on an H100 (the
    rwkv6 and recurrentgemma serve runs: 6 and 280 of about 10^5 without
    the margin; 3 and 0, then 4 and 6, with it), and the profiler keeps
    its events across cycles (``acc_events``), as its warning asked."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    cuda = torch.autograd.DeviceType.CUDA
    rows, calls = {}, 0
    for ev in prof.key_averages():
        if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            calls += ev.count
        elif ev.device_type == cuda:
            rows[ev.key] = dict(count=ev.count, device_ms=device_us(ev) / 1e3)
    missing = calls - sum(r["count"] for k, r in rows.items()
                          if not k.startswith(("Memcpy", "Memset")))
    longest_ms = max((device_us(e) for e in prof.events()
                      if e.device_type == cuda), default=0.0) / 1e3
    busy_ms = sum(r["device_ms"] for r in rows.values())
    idle = 1.0 - busy_ms / 1e3 / wall
    bounds = [1.0 - (busy_ms + max(missing, 0) * longest_ms) / 1e3 / wall,
              idle]
    if missing:
        print(f"profiler: {missing} of {calls} launched kernels unrecorded; "
              f"device idle share within {bounds}", flush=True)
    return dict(wall_s=wall, launch_calls=calls, kernels_unrecorded=missing,
                device_busy_ms=busy_ms,
                device_idle_share=idle if missing == 0 else None,
                device_idle_share_bounds=bounds, by_name=rows)


def device_ms(torch, fn, reps: int = 50) -> float:
    """``queued_ms``'s device time."""
    return queued_ms(torch, fn, reps)[0]


def queued_ms(torch, fn, reps: int = 50) -> tuple:
    """Mean device time per call of ``fn``, from CUDA events around
    ``reps`` calls queued behind a sleep on the card, so that the host's
    time between launches is hidden (the event time of back-to-back calls
    is set by the host when a launch takes less than its Python wrapper),
    and the mean host time to queue one call.  Fails if the host took
    longer to queue the calls than the card slept."""
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    slept.record()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= slept.elapsed_time(start):
        fail(f"device_ms: queueing {reps} calls took {host_ms} ms, longer "
             f"than the card slept ({slept.elapsed_time(start)} ms)")
    return start.elapsed_time(end) / reps, host_ms / reps


def launch_mix(problems) -> Counter:
    """Assembly-kernel launches per quad order over the measured runs of
    ``problems``: each task twice, and each signature once more (warm-up)."""
    mix = Counter()
    for problem in problems:
        for (_, _, q), n in signatures(problem).items():
            mix[q] += 2 * n + 1
    return mix


def time_assembly_kernel(torch, asm_ops, asm_ref, asm_path) -> dict:
    """Assembly kernel (at the application's 16 x 16 tiles), plain version
    and bound at the signature the path launched most of each quad order,
    on a real task's inputs, with the path's launches of that quad order."""
    from repro_torch.assembly.execute import TILE_BLOCK
    sigs = asm_path["signatures"]
    mix = launch_mix(asm_path["problems"])
    if sum(mix.values()) != asm_path["launches"]:
        fail(f"assembly launch mix {dict(mix)} does not add up to "
             f"{asm_path['launches']} launches")
    print(f"assembly launches by quad order: {dict(sorted(mix.items()))}",
          flush=True)
    times = {}
    for quad in ASM_QUADS:
        sig = max((k for k in sigs if k[2] == quad), key=lambda k: sigs[k])
        problem = next(p for p in asm_path["problems"]
                       if sig in signatures(p))
        pr, pc, couple = task_inputs(torch, problem, sig)
        nr, nc, q = sig

        def launch_one():
            asm_ops.assembly_tile(pr, pc, couple, quad_order=q,
                                  block_r=TILE_BLOCK, block_c=TILE_BLOCK)

        k_ms = time_ms(torch, launch_one, 200)
        k_dev_ms, host_ms = queued_ms(torch, launch_one)
        p_ms = time_ms(torch, lambda: asm_ref.reference_tile(
            pr, pc, couple, q), 5 if q > 16 else 20)
        nbytes = nr * nc * (4 + 1) + (nr + nc) * 12
        ops = int(couple.sum().item()) * q * ASM_OPS_PER_STEP
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        key = f"rows={nr},cols={nc},Q={q}"
        times[key] = dict(
            ms=k_ms, device_ms=k_dev_ms, host_ms=host_ms, plain_ms=p_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, operations=ops, main_path_tasks=sigs[sig],
            quad_order_launches=mix[q])
        print(f"time assembly_tile {key}: kernel {k_ms!r} ms (device "
              f"{k_dev_ms!r} ms, host {host_ms!r} ms a call), plain "
              f"{p_ms!r} ms, bound {max(t_bytes, t_ops)!r} ms "
              f"({times[key]['bound_by']}, {nbytes} B, {ops} operations); "
              f"{mix[q]} launches at Q = {q}", flush=True)
    return times


def launch_floor(torch) -> dict:
    """The card's cost of one launch: an empty kernel
    (``torch.cuda._sleep(0)``) timed as ``device_ms`` and between events."""
    out = dict(device_ms=device_ms(torch, lambda: torch.cuda._sleep(0),
                                   reps=200),
               event_ms=time_ms(torch, lambda: torch.cuda._sleep(0), 200))
    print(f"launch floor (empty kernel): {out['device_ms']!r} ms device, "
          f"{out['event_ms']!r} ms between events", flush=True)
    return out


def profile_main_path(torch, kernel) -> dict:
    """Device time of one float64 solo main-path run, by kernel and copy,
    and the device's idle share of the run's wall time."""
    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  scaling_phase)
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    kernel.reset_launches()
    out = profiled_run(torch, lambda: ccm_lb(phase, a0, CCMParams(),
                                             device="cuda", **MAIN_KW))
    out["launches"] = kernel.PAIR_LAUNCHES["float64"]
    print(json.dumps({"profile": out}), flush=True)
    return out


def profile_spec_path(torch, kernel) -> dict:
    """The same for the first of ``SPEC_RUNS``."""
    from repro_torch.core import (CCMParams, ccm_lb, initial_assignment,
                                  scaling_phase)
    phase = scaling_phase(256)
    a0 = initial_assignment(phase)
    _, window, mode, fill = SPEC_RUNS[0]
    kernel.reset_launches()
    out = profiled_run(torch, lambda: ccm_lb(
        phase, a0, CCMParams(), device="cuda", spec_window=window,
        spec_mode=mode, spec_fill=fill, **MAIN_KW))
    out["launches"] = kernel.SPEC_LAUNCHES["float64"]
    print(json.dumps({"profile_spec": out}), flush=True)
    return out


def time_flash(torch, flash_kernel, flash_ref, q_shape, k_shape, hq: int,
               kw, launches: int) -> dict:
    """Flash at one launched shape (bf16, the launch's ``kw``: causal,
    window, soft-cap): kernel, plain version, SDPA (K/V repeated to Hq, a
    window as a boolean mask; timed here only, never on the path; null
    under a soft-cap, which SDPA cannot apply) and the bound: the larger of
    the bytes (q, k, v read once, the output written once) over the HBM
    rate and the visible pairs' operations over the bf16 tensor-core
    peak."""
    import torch.nn.functional as F
    causal, window = kw.get("causal", True), kw.get("window", 0)
    cap = kw.get("softcap", 0.0)
    mask_kw = dict(causal=causal, window=window, softcap=cap)
    bhq, sq, hd = q_shape
    bhkv, skv, _ = k_shape
    q = torch.randn(q_shape, dtype=torch.bfloat16, device="cuda")
    k = torch.randn(k_shape, dtype=torch.bfloat16, device="cuda")
    v = torch.randn(k_shape, dtype=torch.bfloat16, device="cuda")
    b, group = bhq // hq, bhq // bhkv
    q4 = q.reshape(b, hq, sq, hd)
    k4, v4 = (t.reshape(b, hq // group, skv, hd)
              .repeat_interleave(group, dim=1) for t in (k, v))
    mask = None
    if window:
        q_pos = torch.arange(sq, device="cuda")[:, None]
        k_pos = torch.arange(skv, device="cuda")[None, :]
        mask = k_pos > q_pos - window
        if causal:
            mask &= k_pos <= q_pos
    big = bhq * sq * skv > 2 ** 28
    key = f"q={list(q_shape)},kv={list(k_shape)}" \
        + ("" if causal else ",non-causal") \
        + (f",window={window}" if window else "") \
        + (f",softcap={cap:g}" if cap else "")
    hold_flash(torch,
               flash_kernel.flash_attention_fwd(q, k, v, **mask_kw),
               flash_ref.reference_attention(q, k, v, **mask_kw),
               flash_ref.reference_attention_bf16_tiles(q, k, v, **mask_kw,
                                                        slack=True),
               f"flash at the launched shape {key}")

    def launch_one():
        flash_kernel.flash_attention_fwd(q, k, v, **mask_kw)

    k_ms = time_ms(torch, launch_one, 20)
    k_dev, k_host = queued_ms(torch, launch_one)
    p_ms = time_ms(torch, lambda: flash_ref.reference_attention(
        q, k, v, **mask_kw), 2 if big else 10)
    l_ms = None
    if not cap:
        l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None),
            20)
    pairs = bhq * sum(max(0, (min(i + 1, skv) if causal else skv)
                          - (max(0, i - window + 1) if window else 0))
                      for i in range(sq))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    ops = 4 * pairs * hd
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
    out = dict(ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
               library_ms=l_ms, bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, operations=ops, launches=launches)
    if cap:
        out["library_note"] = ("SDPA cannot apply the logit soft-cap "
                               f"{cap:g}")
    print(f"time flash {key}: kernel {k_ms!r} ms (device {k_dev!r} ms, "
          f"host {k_host!r} ms a call), "
          f"plain {p_ms!r} ms, sdpa {l_ms!r} ms, bound {out['bound_ms']!r} ms "
          f"({out['bound_by']}, {nbytes} B, {ops} operations), {launches} "
          f"launches", flush=True)
    return {key: out}


def time_logged_flash(torch, flash_kernel, flash_ref, run) -> dict:
    """``time_flash`` at every flash shape a serve ``run`` launched."""
    times = {}
    for ((q_shape, k_shape, _), kw), n in \
            run["log_shapes"]["flash"].items():
        times.update(time_flash(torch, flash_kernel, flash_ref, q_shape,
                                k_shape, run["q_heads"], dict(kw), n))
    return times


def time_serve_kernels(torch, flash_kernel, flash_ref, gemm_kernel, gemm_ref,
                       serve) -> dict:
    """Each of the qwen serve path's kernels at the shapes it launched
    (bf16): kernel, plain version, one PyTorch call computing the same
    function (timed here only, never on the path) and the bound: the larger
    of the bytes (each input read once, the output written once) over the
    HBM rate and the operations over the bf16 tensor-core peak.  CUDA
    events, median of rounds."""
    times = {"flash": time_logged_flash(torch, flash_kernel, flash_ref,
                                        serve), "gemm": {}}
    for ((x_shape, w_shape), _), n in serve["log_shapes"]["gemm"].items():
        e, c, d = x_shape
        f = w_shape[2]
        x = torch.randn(x_shape, dtype=torch.bfloat16, device="cuda")
        w = torch.randn(w_shape, dtype=torch.bfloat16, device="cuda") \
            / d ** 0.5
        key = f"x={list(x_shape)},w={list(w_shape)}"
        hold_gemm(torch, gemm_kernel.expert_gemm_fwd(x, w),
                  gemm_ref.reference_expert_gemm(x, w),
                  f"expert_gemm at the launched shape {key}")

        def launch_one():
            gemm_kernel.expert_gemm_fwd(x, w)

        k_ms = time_ms(torch, launch_one, 20)
        k_dev, k_host = queued_ms(torch, launch_one)
        p_ms = time_ms(torch, lambda: gemm_ref.reference_expert_gemm(x, w),
                       10)
        l_ms = time_ms(torch, lambda: torch.bmm(x, w), 20)
        nbytes = 2 * (e * c * d + e * d * f + e * c * f)
        ops = 2 * e * c * d * f
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
        times["gemm"][key] = dict(
            ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations", bytes=nbytes,
            operations=ops, launches=n)
        print(f"time expert_gemm {key}: kernel {k_ms!r} ms (device "
              f"{k_dev!r} ms, host {k_host!r} ms a call), plain {p_ms!r} ms, "
              f"bmm {l_ms!r} ms, bound "
              f"{max(t_b, t_o)!r} ms "
              f"({times['gemm'][key]['bound_by']}, {nbytes} B, {ops} "
              f"operations), {n} launches", flush=True)
    return times


def time_wkv6(torch, mods, ref, rng, r_shape, n: int) -> dict:
    """WKV6 at one shape (bf16 r, k, v; float32 log_w and u): kernel (also
    as ``device_ms``), the plain chunked version at chunk 16 and the bound:
    the larger of the bytes, each input read once and each output written
    once, over the HBM rate, and 4 hd^2 float32 operations a token and
    head over the float32 peak.  No single PyTorch call computes a
    data-dependent-decay WKV, so there is no library time."""
    b, s, h, hd = r_shape
    r, k, v, lw, u = wkv6_inputs(torch, rng, b, s, h, hd, None,
                                 torch.bfloat16)

    def launch_one():
        mods["wkv6"].wkv6_fwd(r, k, v, lw, u)

    k_ms = time_ms(torch, launch_one, 50)
    k_dev = device_ms(torch, launch_one)
    p_ms = time_ms(torch, lambda: ref.wkv6_chunked(r, k, v, lw, u), 3)
    # r, k, v read and y written in bf16; log_w, u and the state float32
    nbytes = (2 * 4 * r.numel() + 4 * lw.numel() + 4 * u.numel()
              + 4 * b * h * hd * hd)
    ops = 4 * hd * hd * b * s * h
    t_b, t_o = (nbytes / HBM_BYTES_PER_S * 1e3,
                ops / PEAK_OPS["float32"] * 1e3)
    key = f"r={list(r_shape)}"
    out = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
               bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, operations=ops, launches=n)
    print(f"time wkv6 {key}: kernel {k_ms!r} ms (device {k_dev!r} ms), "
          f"plain {p_ms!r} ms, bound {max(t_b, t_o)!r} ms "
          f"({out['bound_by']}, {nbytes} B, {ops} operations), {n} "
          f"launches", flush=True)
    return {key: out}


def time_rglru(torch, mods, ref, shape, n: int) -> dict:
    """The RG-LRU scan at one float32 shape: kernel (also as
    ``device_ms``; the chunks ``kernel.fwd_geometry`` gives), the plain
    sequential version and the bound (bytes, each input read once and the
    output written once, over the HBM rate, against exp, multiply and add
    an element over the float32 peak).  No single PyTorch call computes a
    linear recurrence, so there is no library time."""
    la = -torch.rand(shape, device="cuda") * 0.1 - 1e-3
    bb = torch.randn(shape, device="cuda")

    def launch_one():
        mods["rglru"].rglru_fwd(la, bb)

    k_ms = time_ms(torch, launch_one, 20)
    k_dev = device_ms(torch, launch_one, reps=20)
    p_ms = time_ms(torch, lambda: ref.reference_rglru(la, bb), 1, rounds=5)
    nbytes = 3 * 4 * la.numel()
    ops = 3 * la.numel()
    t_b, t_o = (nbytes / HBM_BYTES_PER_S * 1e3,
                ops / PEAK_OPS["float32"] * 1e3)
    key = f"x={list(shape)}"
    geo = mods["rglru"].fwd_geometry(*shape)
    design = f"chunked ({geo.chunks} chunks of {geo.steps} steps)"
    out = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
               bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, operations=ops, launches=n, design=design)
    print(f"time rglru {key} ({design}): kernel {k_ms!r} ms (device "
          f"{k_dev!r} ms), plain {p_ms!r} ms, bound {max(t_b, t_o)!r} ms "
          f"({out['bound_by']}, {nbytes} B), {n} launches", flush=True)
    return {key: out}


def time_recurrent_kernels(torch, mods, refs, flash_ref, rec, rng,
                           train_rglru: int) -> dict:
    """The recurrent paths' kernels at the shapes they launched:
    :func:`time_wkv6` and :func:`time_rglru`, and flash at
    recurrentgemma's local-attention shape; the scan also at its training
    shape (``RGLRU_TIMED[1]``, ``train_rglru`` launches in phase 7d; 7c
    (d) times the third, a 4-rank model axis's)."""
    times = {"wkv6": {}, "rglru": {}, "flash": {}}
    for ((r_shape, *_), _), n in rec[RWKV_ARCH]["log_shapes"]["wkv6"].items():
        times["wkv6"].update(time_wkv6(torch, mods, refs["wkv6"], rng,
                                       r_shape, n))
    for ((la_shape, _), _), n in rec[RG_ARCH]["log_shapes"]["rglru"].items():
        times["rglru"].update(time_rglru(torch, mods, refs["rglru"],
                                         la_shape, n))
    times["rglru"].update(time_rglru(torch, mods, refs["rglru"],
                                     RGLRU_TIMED[1], train_rglru))
    times["flash"].update(time_logged_flash(torch, mods["flash"], flash_ref,
                                            rec[RG_ARCH]))
    return times


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the repro_torch package is not at {SRC}; run from the root "
             "of a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels.assembly import kernel as asm_kernel
    from repro_torch.kernels.assembly import ops as asm_ops
    from repro_torch.kernels.assembly import ref as asm_ref
    from repro_torch.kernels.ccm_scorer import kernel, launch, ref
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.moe_gemm import kernel as gemm_kernel
    from repro_torch.kernels.moe_gemm import ops as gemm_ops
    from repro_torch.kernels.moe_gemm import ref as gemm_ref
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    # 1. versions and the card
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    # each phase's wall seconds, printed before the result
    phase_s = {}
    lap_at = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - lap_at[0]
        lap_at[0] = now

    # 2. build the eight kernel sources, one nvcc each, in parallel
    t0 = time.perf_counter()
    kernel_mods = (kernel, asm_kernel, flash_kernel, gemm_kernel, wkv_kernel,
                   rglru_kernel)
    reports = _build.compile_sources([m.SOURCE for m in kernel_mods]
                                     + [flash_kernel.BWD_SOURCE,
                                        wkv_kernel.BWD_SOURCE],
                                     verbose=True)
    libs = [m.build() for m in kernel_mods]
    for source, report in reports.items():
        print(f"nvcc {source.name}:\n{report}", flush=True)
        spills = [line.strip() for line in report.splitlines()
                  if any(int(n) for n in re.findall(
                      r"(\d+) bytes spill (?:stores|loads)", line))]
        if spills:
            fail(f"ptxas spills registers in {source.name}: {spills}")
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{[str(lib.relative_to(ROOT)) for lib in libs]}", flush=True)
    lap("2 build")
    # 3. the kernel against its plain version
    rng = np.random.default_rng(0)
    worst = check_kernel(torch, kernel, ref, rng)
    pair_worst = check_pair_kernel(torch, kernel, launch, ref, rng)
    spec_worst, spec_rows, fleet_rows, spec_lanes, spec_p = \
        check_spec_kernel(torch, kernel, launch, ref)
    lap("3 scorer kernels")
    # 4. the main path (launch counts zeroed inside, per run), then through
    # the speculative driver, and the fleet
    mp = main_path(torch, kernel, launch)
    sp = spec_path(torch, kernel, launch, mp.pop("f64_cpu_run"))
    fleet = fleet_path(torch, kernel, launch)
    lap("4 main, spec and fleet paths")
    # 4c / 4d. the pipeline and the async balancer (counts zeroed inside)
    pipe = pipeline_path(torch, kernel, launch)
    asy = async_path(torch, kernel, launch, mp.pop("f64_cuda_run"))
    lap("4c-4d pipeline and async")
    # 4e / 4f. the MILP certification and the three planners (counts
    # zeroed inside, per run and per plan)
    t0 = time.perf_counter()
    milp = milp_path(torch, kernel, launch)
    milp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    planners = planner_path(torch, kernel, launch)
    planner_s = time.perf_counter() - t0
    print(f"milp_path {milp_s:.1f} s, planner_path {planner_s:.1f} s",
          flush=True)
    lap("4e-4f milp and planners")
    # 5. the assembly application (launch counts zeroed inside, per run)
    asm_worst = check_assembly_kernel(torch, asm_ops, asm_ref, rng)
    asm = assembly_path(torch, asm_kernel, asm_ref, kernel, launch)
    lap("5 assembly")
    # 6. serving qwen3-moe-30b-a3b (launch counts zeroed inside)
    flash_worst = check_flash_kernel(torch, flash_ops, flash_ref, rng)
    gemm_worst = check_gemm_kernel(torch, gemm_ops, gemm_ref, rng)
    serve_mods = {"wkv6": wkv_kernel, "rglru": rglru_kernel,
                  "flash": flash_kernel, "gemm": gemm_kernel}
    serve = serve_path(torch, serve_mods)
    gc.collect()
    torch.cuda.empty_cache()
    lap("6 serve qwen")
    # 7. serving rwkv6-7b and recurrentgemma-9b (launch counts zeroed
    # inside); each model is freed before the next
    wkv_worst = check_wkv6_kernel(torch, wkv_ops, wkv_ref, rng)
    rglru_worst = check_rglru_kernel(torch, rglru_kernel, rglru_ops,
                                     rglru_ref, rng)
    rec = {}
    for arch, prompt, want, cut, check_lens in REC_SERVES:
        rec[arch] = serve_recurrent(torch, arch, prompt, want, cut,
                                    check_lens, serve_mods)
        gc.collect()
        torch.cuda.empty_cache()
    lap("7 serve recurrent")
    # 6c. serving gemma2-27b (ring cache), whisper-large-v3 and
    # llava-next-mistral-7b (launch counts zeroed inside); each model is
    # freed before the next
    fam = {}
    for arch, batch_size, prompt, frames, n_flash, cut in FAMILY_SERVES:
        fam[arch] = serve_family(torch, arch, batch_size, prompt, frames,
                                 n_flash, cut, serve_mods)
        gc.collect()
        torch.cuda.empty_cache()
    lap("6c serve gemma2, whisper, llava")
    # 7b. training qwen3-moe-30b-a3b (launch counts zeroed inside)
    t0 = time.perf_counter()
    flash_bwd_worst = check_flash_bwd(torch, flash_kernel, flash_ops,
                                      flash_ref)
    gemm_bwd_worst = check_gemm_bwd(torch, gemm_kernel, gemm_ops, gemm_ref)
    wkv_bwd_worst = check_wkv6_bwd(torch, wkv_kernel, wkv_ops, wkv_ref)
    rglru_bwd_worst = check_rglru_bwd(torch, rglru_kernel, rglru_ops,
                                      rglru_ref)
    rec_bwd_times = time_rec_bwd(torch, serve_mods,
                                 {"wkv6": wkv_ref, "rglru": rglru_ref},
                                 {"wkv6": wkv_ops, "rglru": rglru_ops})
    gc.collect()
    torch.cuda.empty_cache()
    train_check = train_card_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train = train_path(torch, serve_mods)
    gc.collect()
    torch.cuda.empty_cache()
    train_times = time_train_kernels(torch, flash_kernel, flash_ref,
                                     gemm_kernel, gemm_ref,
                                     train["launches_per_step"])
    train_s = time.perf_counter() - t0
    print(f"train phase {train_s:.1f} s", flush=True)
    lap("7b train")
    # 7c. the device mesh: the 1 x 1 NCCL mesh's serve and train runs
    # (launch counts zeroed inside, per run), every rank's EP body, the
    # dry-run
    mesh = mesh_runs(torch, serve_mods)
    gc.collect()
    torch.cuda.empty_cache()
    mesh["ep_ranks"] = ep_ranks(torch, serve_mods)
    import torch.distributed as dist
    dist.destroy_process_group()
    mesh["dryrun_h100"] = dryrun_h100()
    lap("7c mesh")
    # 7c (d). every family's tensor-parallel ranks on the card (launch
    # counts zeroed inside, per sub-layer and model-axis size)
    tp = mesh["tp_ranks"] = tp_ranks(torch, serve_mods)
    gc.collect()
    torch.cuda.empty_cache()
    lap("7c (d) tp ranks")
    # 7d. training rwkv6-7b, recurrentgemma-9b, whisper-large-v3 and
    # llava-next-mistral-7b (launch counts zeroed inside); each model is
    # freed before the next
    fam_train = {}
    for arch, cut, batch, seq, *check in FAMILY_TRAINS:
        fam_train[arch] = train_family(torch, arch, cut, batch, seq, check,
                                       serve_mods)
    lap("7d train families")
    # recurrentgemma's hd 256 backward at the shape phase 7d trained, with
    # the launches a step that run counted
    train_times["flash_bwd"].update(time_flash_bwd(
        torch, flash_kernel, flash_ref, RG_TRAIN_ATTN,
        fam_train[RG_ARCH]["launches_per_step"]["flash_bwd"]))
    # 8. times at the main paths' shapes, and where the time goes
    times = time_kernel(torch, kernel, ref, rng, mp["shapes"])
    pair_times = time_pairs(torch, kernel, ref, launch, rng,
                            mp["pair_shapes"])
    # the window kernel at the shape the spec runs launched most, and at
    # spec32's and the fleet's most launched
    spec_at = [sp["shapes"].most_common(1)[0] + (spec_rows,)]
    for top, raws in ((sp["runs"]["spec32 scan/disjoint"]["top_shapes"],
                       spec_rows), (fleet["top_shapes"], fleet_rows)):
        spec_at.append((tuple(top[0][0]), top[0][1], raws))
    spec_by_shape = {}
    for shape, n_main, raws in spec_at:
        t = time_spec(torch, kernel, ref, launch, shape, n_main, raws,
                      spec_lanes, spec_p)
        spec_by_shape.setdefault(t["shape"], t)
    spec_times = next(iter(spec_by_shape.values()))
    floor = launch_floor(torch)
    asm_times = time_assembly_kernel(torch, asm_ops, asm_ref, asm)
    serve_times = time_serve_kernels(torch, flash_kernel, flash_ref,
                                     gemm_kernel, gemm_ref, serve)
    rec_times = time_recurrent_kernels(
        torch, serve_mods, {"wkv6": wkv_ref, "rglru": rglru_ref}, flash_ref,
        rec, rng, fam_train[RG_ARCH]["launches"]["rglru"]["fwd"]["float32"])
    for run in fam.values():
        serve_times["flash"].update(time_logged_flash(
            torch, flash_kernel, flash_ref, run))
    prof = profile_main_path(torch, kernel)
    prof_spec = profile_spec_path(torch, kernel)
    lap("8 timing and profiles")
    # 10. the six examples of repro_torch.examples on the card (launch
    # counts zeroed inside, per example), the C2 configs served through
    # serve_batched's loop body; flash held and timed at their shapes
    ex = examples_path(torch, kernel, launch, asm_kernel, serve_mods)
    for arch in EXAMPLE_SERVES:
        serve_times["flash"].update(time_logged_flash(
            torch, flash_kernel, flash_ref, ex["serve_batched"][arch]))
    lap("10 examples")

    # 9. imports, then the result
    import repro_torch
    for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(mod.name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail(f"imported JAX or the JAX package: {bad[:5]}")
    kernels = []
    for name in ("float64", "float32"):
        short = "f64" if name == "float64" else "f32"
        shape, _ = mp["pair_shapes"][name].most_common(1)[0]
        key = "E={},A={},B={},P={}".format(*shape)
        m = pair_times[name][key]
        by_path = {"ccm_lb_256": mp["launches"][name],
                   "assembly": asm["scorer_launches"]
                   if name == "float64" else 0}
        if name == "float64":
            by_path.update({f"pipeline_256 {k}": v["launches"]
                            for k, v in pipe.items()
                            if isinstance(v, dict) and v["kernel"] == "pair"})
            by_path.update({f"async {k}": v["launches"]
                            for k, v in asy.items()})
            by_path.update({f"milp delta {k}": v["pair_launches"]
                            for k, v in milp.items()})
            by_path.update({f"planner {k}": v["launches"]
                            for k, v in planners.items()
                            if isinstance(v, dict) and v["kernel"] == "pair"})
            by_path["re-placement plan"] = serve["replacement"][
                "pair_launches"]
            by_path.update({f"example {k}": v["pair_launches"]
                            for k, v in ex["balancers"].items()})
            by_path.update({f"example assembly_e2e {k}": v["pair_launches"]
                            for k, v in ex["assembly_e2e"].items()})
        kernels.append({
            "name": f"ccm_scorer_pairs_{short}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": pair_worst[name],
            "ms": m["ms"], "device_ms": m["device_ms"],
            "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
            "library_note": "no PyTorch call scores and combines CCM "
            "exchange pairs", "shape": key, "by_shape": pair_times[name],
        })
        # the full-tile kernel: held to its plain version, no longer on
        # the main path (main_path and assembly_path fail on a launch)
        shape, _ = mp["shapes"][name].most_common(1)[0]
        key = "E={},A={},B={}".format(*shape)
        m = times[name][key]
        kernels.append({
            "name": f"ccm_scorer_{short}",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": 0,
            "launches_by_path": {"ccm_lb_256": 0, "assembly": 0},
            "max_abs_err": worst[name],
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": key, "by_shape": times[name],
        })
    spec_by_path = {"ccm_lb_256_spec": sp["launches"],
                    f"fleet_{FLEET_N}": fleet["launches"],
                    "async": sum(v["spec_launches"] for v in asy.values())}
    spec_by_path.update({f"pipeline_256 {k}": v["launches"]
                         for k, v in pipe.items()
                         if isinstance(v, dict) and v["kernel"] == "window"})
    spec_by_path.update({f"planner {k}": v["launches"]
                         for k, v in planners.items()
                         if isinstance(v, dict) and v["kernel"] == "window"})
    kernels.append({
        "name": "ccm_scorer_spec_f64", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": SPEC_REPLACES,
        "launches": sum(spec_by_path.values()),
        "launches_by_path": spec_by_path, "max_abs_err": spec_worst,
        "ms": spec_times["ms"], "device_ms": spec_times["device_ms"],
        "host_ms": spec_times["host_ms"], "plain_ms": spec_times["plain_ms"],
        "bound_ms": spec_times["bound_ms"],
        "bound_by": spec_times["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call scores a CCM window",
        "shape": spec_times["shape"], "by_shape": spec_by_shape,
    })
    asm_example = ex["assembly_e2e"]["measured"]
    key = max(asm_times, key=lambda k: asm_times[k]["quad_order_launches"])
    m = asm_times[key]
    kernels.append({
        "name": "assembly_tile_f32", "route": "cuda", "source": ASM_SOURCE,
        "replaces": ASM_REPLACES,
        "launches": asm["launches"] + asm_example["tile_launches"],
        "launches_by_path": {"assembly": asm["launches"],
                             "example assembly_e2e":
                             asm_example["tile_launches"]},
        "max_abs_err": max(asm_worst, asm["real_task_max_abs_err"]),
        "ms": m["ms"], "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None, "shape": key, "by_shape": asm_times,
    })
    serve_times["flash"].update(rec_times["flash"])
    flash_by_path = {f"serve_{SERVE_ARCH}": serve["launches"]["flash"][
        "bfloat16"], f"serve_{RG_ARCH}": rec[RG_ARCH]["launches"]["flash"][
        "bfloat16"], f"re-placement_{SERVE_ARCH}": serve["replacement"][
            "launches"]["flash"], f"train_{TRAIN_ARCH}": train["launches"][
                "flash"]["bfloat16"]}
    flash_by_path.update({f"serve_{arch}": r["launches"]["flash"]["bfloat16"]
                          for arch, r in fam.items()})
    flash_by_path[f"mesh_serve_{SERVE_ARCH}"] = mesh["serve"]["mesh 1x1"][
        "launches"]["flash"]
    flash_by_path[f"mesh_train_{TRAIN_ARCH}"] = MESH_TRAIN_STEPS * mesh[
        "train"]["mesh 1x1"]["launches_per_step"]["flash_fwd"]
    flash_by_path.update({f"train_{arch}": r["launches"]["flash"]["fwd"][
        "bfloat16"] for arch, r in fam_train.items()})
    flash_by_path["tp_ranks (float32)"] = tp["launches"].get("flash", 0)
    ex_serve, ex_train = ex["serve_batched"], ex["train_moe_ccm"]["launches"]
    flash_by_path["example serve_batched"] = ex_serve["smoke"]["launches"][
        "flash"]["bfloat16"]
    flash_by_path.update({f"example serve_batched {arch}": ex_serve[arch][
        "launches"]["flash"]["bfloat16"] for arch in EXAMPLE_SERVES})
    flash_by_path["example train_moe_ccm"] = ex_train["flash_fwd"]
    for name, key, worst_err, source, replaces, by_path in (
            ("flash_attention_bf16", "flash", flash_worst, FLASH_SOURCE,
             FLASH_REPLACES, flash_by_path),
            ("expert_gemm_bf16", "gemm", gemm_worst, GEMM_SOURCE,
             GEMM_REPLACES, {f"serve_{SERVE_ARCH}": serve["launches"][
                 "gemm"]["bfloat16"], f"re-placement_{SERVE_ARCH}":
                 serve["replacement"]["launches"]["gemm"],
                 f"train_{TRAIN_ARCH}": train["launches"]["gemm"][
                     "bfloat16"],
                 f"mesh_serve_{SERVE_ARCH}": mesh["serve"]["mesh 1x1"][
                     "launches"]["gemm"],
                 f"mesh_train_{TRAIN_ARCH}": MESH_TRAIN_STEPS * mesh[
                     "train"]["mesh 1x1"]["launches_per_step"]["gemm_fwd"],
                 "example serve_batched": ex_serve["smoke"]["launches"][
                     "gemm"]["bfloat16"],
                 "example train_moe_ccm": ex_train["gemm_fwd"]})):
        by_shape = serve_times[key]
        shape = max(by_shape, key=lambda k: by_shape[k]["launches"])
        m = by_shape[shape]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": worst_err["bfloat16"],
            "max_abs_err_float32": worst_err["float32"],
            "max_abs_err_bf16_p": worst_err.get("bfloat16_p"),
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": shape,
            "by_shape": by_shape,
        })
        if key == "flash":
            kernels[-1]["tp_m4"] = tp["times_m4"]["flash"]
            kernels[-1]["instances"] = {
                "serve": "flash_attention_bf16 (hd any multiple of 8)",
                "train": "flash_attention_bf16_lse (hd 64, 128, 256: the "
                         "tensor-core backward's shapes; the serve "
                         "instance's output bit for bit)"}
    for name, key, dtype, arch, worst_bf16, worst_f32, source, replaces in (
            ("wkv6_bf16", "wkv6", "bfloat16", RWKV_ARCH,
             wkv_worst["bfloat16"]["y"], wkv_worst["float32"]["y"],
             WKV_SOURCE, WKV_REPLACES),
            ("rglru_f32", "rglru", "float32", RG_ARCH,
             rglru_worst["bfloat16"], rglru_worst["float32"], RGLRU_SOURCE,
             RGLRU_REPLACES)):
        by_shape = rec_times[key]
        shape = max(by_shape, key=lambda k: by_shape[k]["launches"])
        m = by_shape[shape]
        by_path = {f"serve_{arch}": rec[arch]["launches"][key][dtype],
                   f"train_{arch}": fam_train[arch]["launches"][key]["fwd"][
                       dtype],
                   "tp_ranks (float32)": tp["launches"].get(key, 0),
                   "example serve_batched": ex_serve["smoke"]["launches"][
                       key][dtype]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": worst_bf16 if dtype == "bfloat16" else worst_f32,
            "max_abs_err_bfloat16": worst_bf16,
            "max_abs_err_float32": worst_f32,
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes "
            + ("a data-dependent-decay WKV" if key == "wkv6"
               else "a linear recurrence"),
            "shape": shape, "by_shape": by_shape,
            "tp_m4": tp["times_m4"][key],
        })
    kernels[-2]["max_abs_err_state"] = {k: v["state"]
                                        for k, v in wkv_worst.items()}
    kernels[-1]["instances"] = {
        "float32, bf16 b": "rglru_chunked_kernel (time in chunks of 256 "
                           "steps, each walked for its summary, then from "
                           "its carry)"}
    for name, key, source, replaces, note, worst_bf16, worst_f32 in (
            ("flash_attention_bwd_bf16", "flash_bwd", FLASH_BWD_SOURCE,
             FLASH_BWD_REPLACES, "no TPU kernel: the JAX package "
             "differentiates its jnp attention (_sdpa); this is the "
             "gradient of the forward kernel (row 5)",
             flash_bwd_worst["bfloat16"]["abs"],
             flash_bwd_worst["float32"]["abs"]),
            ("expert_gemm_bwd_bf16", "gemm_bwd", GEMM_SOURCE,
             GEMM_BWD_REPLACES, "no TPU kernel: the JAX package "
             "differentiates its per-expert jnp products; dX and dW are two "
             "launches of row 4's TMA kernel's transpose-bit variants on x, "
             "w and dY where they lie (no copy)",
             gemm_bwd_worst["bfloat16"], gemm_bwd_worst["float32"])):
        by_shape = train_times[key]
        shape = next(iter(by_shape))
        m = by_shape[shape]
        by_path = {f"train_{TRAIN_ARCH}": train["launches"][key]["bfloat16"],
                   f"mesh_train_{TRAIN_ARCH}": MESH_TRAIN_STEPS * mesh[
                       "train"]["mesh 1x1"]["launches_per_step"][key],
                   "example train_moe_ccm": ex_train[key]}
        if key == "flash_bwd":
            by_path.update({f"train_{arch}": r["launches"]["flash"]["bwd"][
                "bfloat16"] for arch, r in fam_train.items()})
            by_path["tp_ranks (float32)"] = tp["launches"].get(
                "flash_bwd", 0)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_note": note,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst_bf16, "max_abs_err_float32": worst_f32,
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": shape, "by_shape": by_shape,
        })
    kernels[-2]["max_rel_err"] = {k: v["rel"]
                                  for k, v in flash_bwd_worst.items()
                                  if isinstance(v, dict)}
    kernels[-2]["instances"] = {
        "bf16, hd 64 or 128": "flash_attention_bwd_bf16_tc: bwd_delta_tc, "
                              "bwd_dkdv_tc, bwd_dq_tc",
        "bf16, hd 256": "flash_attention_bwd_bf16_tc256: bwd_delta_tc, "
                        "bwd_dkdv_tc256, bwd_dkdv_sum256, bwd_dq_tc256",
        "float32, bf16 hd 8 and 32": "flash_attention_bwd_{f32,bf16}: the "
                                     "float32-core kernels"}
    kernels[-2]["max_rel_err_bf16_model"] = flash_bwd_worst.get(
        "bfloat16_model")
    kernels[-2]["max_abs_err_lse"] = flash_bwd_worst.get("bfloat16_lse")
    for name, key, arch, dtype, source, replaces, note, worst_err in (
            ("wkv6_bwd_bf16", "wkv6", RWKV_ARCH, "bfloat16", WKV_BWD_SOURCE,
             WKV_BWD_REPLACES, "no TPU kernel: the JAX package "
             "differentiates its jnp WKV6 (wkv6_chunked); this is the "
             "gradient of row 6's kernel", wkv_bwd_worst),
            ("rglru_bwd_f32", "rglru", RG_ARCH, "float32", RGLRU_SOURCE,
             RGLRU_BWD_REPLACES, "no TPU kernel: the JAX package "
             "differentiates its associative_scan; this is the gradient of "
             "row 7's kernel", rglru_bwd_worst)):
        by_shape = rec_bwd_times[f"{key}_bwd"]
        shape = next(iter(by_shape))
        m = by_shape[shape]
        n = fam_train[arch]["launches"][key]["bwd"][dtype]
        by_path = {f"train_{arch}": n,
                   "tp_ranks (float32)": tp["launches"].get(f"{key}_bwd", 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_note": note,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(e["abs"] for e in worst_err[dtype].values()),
            "max_rel_err": worst_err,
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes this gradient",
            "shape": shape, "by_shape": by_shape,
        })
    print(json.dumps({"serve": {k: v for k, v in serve.items()
                                if k != "log_shapes"}}), flush=True)
    print(json.dumps({"serve_recurrent": {
        arch: {k: v for k, v in r.items() if k != "log_shapes"}
        for arch, r in rec.items()}}), flush=True)
    print(json.dumps({"serve_families": {
        arch: {k: v for k, v in r.items() if k != "log_shapes"}
        for arch, r in fam.items()}}), flush=True)
    print(json.dumps({"main_path": mp["runs"],
                      "device_idle_share": prof["device_idle_share"]}),
          flush=True)
    print(json.dumps({"spec_path": sp["runs"], "fleet": fleet,
                      "spec_device_idle_share": prof_spec[
                          "device_idle_share"],
                      "spec_device_idle_share_bounds": prof_spec[
                          "device_idle_share_bounds"]}), flush=True)
    print(json.dumps({"pipeline_path": pipe, "async_path": asy}),
          flush=True)
    print(json.dumps({"milp_path": milp, "milp_path_s": milp_s,
                      "planner_path": planners,
                      "planner_path_s": planner_s}), flush=True)
    print(json.dumps({"train": train, "train_card_vs_cpu": train_check,
                      "train_phase_s": train_s}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"train_families": fam_train}), flush=True)
    print(json.dumps({"assembly": {
        k: v for k, v in asm.items() if k not in ("problems", "signatures")}}),
        flush=True)
    print(json.dumps({"examples": {
        k: v for k, v in ex.items() if k != "serve_batched"} | {
        "serve_batched": {arch: {k: v for k, v in r.items()
                                 if k != "log_shapes"}
                          for arch, r in ex["serve_batched"].items()}}}),
        flush=True)
    print(json.dumps({"launch_floor": floor}), flush=True)
    lap("9 imports and result")
    print(json.dumps({"phase_s": phase_s,
                      "total_s": sum(phase_s.values())}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
