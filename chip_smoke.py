#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: the card's name and count, and its power limit from
   nvidia-smi; no CUDA device is a failure.
2. build: compiles every kernel of the four paths from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together),
   and the timing probes of ``radix_sort_probe.cu``,
   ``segment_sum_probe.cu``, ``merge_probe.cu`` and
   ``spmv_sym_probe.cu``, and prints each kernel's ``-Xptxas -v``
   report.
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on the streams its path gives it at L = 2.5e6 and 5e7: B1
   digit histogram and B2 stable digit placement on every pass of the
   radix chain (``radix_chain``: B2 with the words it carries) of sets
   1-3 and 2x20; B1 also on skewed streams at L = 2.5e6
   (``hist_stream``: every key equal, one digit, sorted, reversed, runs
   of 32 across loads and tiles, digits >= nbins), twice, at the run
   edges (``HIST_RUNS`` tiles a block) and by each variant of its
   timing probe (``HIST_VARIANTS``); B12
   block histogram and B11 counting-sort placement bit for bit; B3' fused sum and B5 prefix
   sum bit for bit on integer-valued data and within their stated
   tolerances on random float32/float64 (B5 on zero-mean and on
   same-sign data, and bit for bit from call to call; B11 also on a
   handed-over table); B4 fused min/max bit for
   bit, NaN included.  The third path's kernels (B6 product fill, B8 ELL
   SpMV, B9 symmetric streams, B10 BSR tiles) are held against their
   plain versions right after phase 4c, on the streams it gave them:
   bit for bit on integer-valued data (B6 with a NaN too), within
   ``c * eps * sum|terms|`` on random float32 for c terms an output.
   B9 also on the streams that cross its tiles (``sym_stream``: the
   arrow matrix, with a column of 2^20 entries; a column whose first
   slot is a tile's last item; runs of empty columns with sentinel rows
   and a padded tail), float32 and float64: ``up`` and ``ct`` bit for
   bit on integer-valued data, ``up`` bit for bit and ``ct`` bit for bit
   from call to call on random data and there within ``C_SEG * eps *
   sum|terms|`` of each column's exact sum; each variant of its timing
   probe bit for bit on integer-valued data.
3c. B3' and B4 on runs that cross their tiles: L = 5e7 positions in
   runs of 2^20 (``run_lengths``: each after short runs, so they start
   mid-tile) and in runs of random length 1..10^4, under a random
   permutation, with ``num_segments`` at nnz and cut mid-stream: B3' bit
   for bit on integer-valued data, bit for bit from call to call and
   within ``C_SEG * eps * sum|terms|`` of each slot's exact sum
   (``exact_segment_sums``) on random float32 and float64; B4 bit for
   bit, NaN included.
3d. B6 on product runs that cross its tiles (``product_stream``: one
   run of 2^20 products, runs of random length 1..10^4, a run that
   starts at a tile's last position, a tile of only dropped slots, sa
   and sb random into operands of 2^20 values; and ``B' B`` of the arrow
   matrix, ``arrow_gram``: one run of 2^20, 1.68e7 products), float32
   and float64: bit for bit on integer-valued data with and without a
   NaN, bit for bit from call to call and within ``C_SEG * eps *
   sum|terms|`` of each slot's exact sum on random data, one launch a
   call; each variant of its timing probe bit for bit on integer-valued
   data.
4. main path: ``repro_torch.sparse.fsparse`` (Matlab ``sparse``) on the
   paper's Table 4.1 sets 1-3 at full scale and on set 2 scaled to
   L = 5e7, each matched bit for bit against the port's numpy oracle,
   then a refill ``pattern.assemble(v)`` with random float32 values
   against the oracle in float64.  The kernels' launch counters are set
   to 0 before this phase and must rise by exactly the planned passes,
   and Parts 3-4's pass (P34, ``csrc/pattern_build.cu``) by one a plan:
   two a set.  Phases 4b-4d, 4g, 4i, 4k, 4m, 4n and 4o count P34 the
   same way, one a plan or an update's merge (4i-4m: one a microbatch's
   embedding gradient), and the serving phases expect 0.
4b. second path, on the same sets and the oracles of phase 4:
   ``fsparse(..., method="pallas")`` (the paper's counting sort, B12 and
   B11) bit for bit against the oracle, its permutation against the
   radix plan's; the unfused ``fill_pallas`` (B5) against the oracle
   within B5's tolerance; ``accum="min"|"max"|"mean"|"first"|"last"``
   on sets 1 and 3 against numpy (min/max through B4, also against its
   plain version); ``sparse2`` twice, a miss and then a hit that runs no
   plan kernel and one fill.  Counters are set to 0 before this phase
   and must rise by exactly the expected launches.
4c. third path, the FEM workload of ``examples/fem_poisson.py`` and
   ``examples/fem_multigrid.py`` at 10^6 degrees of freedom: the P1
   stiffness matrix of a 999 x 999-cell mesh with Dirichlet identity
   rows, planned and filled on the card and held bit for bit against
   the oracle; A @ x four ways (CSC; ``kernels.spmv`` on ELL, B8;
   SymCSC, B9; 2 x 2 BSR, B10), each within ``8 eps sum_j |a_ij x_j|``
   of the CSC result per row; CG on the B8 and the B9 operator to the
   example's error bound against sin(pi x) sin(pi y), and on a seeded
   random right-hand side within ``CG_RTOL`` of the same iterations in
   float64 on the host (relative residuals); the Galerkin
   product ``P' A P`` with a bilinear prolongation (10^6 x 250,000)
   through two cached product plans and B6, its structure bit for bit
   against a numpy expansion put through the oracle and its values
   within ``8 eps (|P'| |A| |P|)`` of scipy's float64 product slot by
   slot; a refill for ``2 A`` that launches one fill and two B6 and no
   plan kernel.  Counters are set to 0 before this phase and must rise
   by exactly the expected launches.
4d. fourth path, dynamic patterns and symmetric planning, on phase 4's
   sets and phase 4c's FEM stream: ``SparsePattern.update`` of a base
   (the first L - Ld triplets, planned with nzmax = L) by the last Ld,
   at 1% and 10% of L, bit for bit against the plan of the whole set,
   launching exactly the delta's radix passes and one B7 (an empty
   update launches nothing and returns the same plan); an edge flip of
   1% of the FEM mesh's cells (``edge_flip``) through
   ``sparse2_update`` (the drop path), bit for bit against ``fsparse``
   of the flipped stream and the oracle, then ``sparse2`` of that
   stream hitting the moved cache entry with one fill and no plan
   kernel; ``pattern_symmetric`` true on A and on the flipped plan with
   two B7 launches each, false with one mirror removed;
   ``fsparse(..., format="symcsc")`` and ``format="bsr", block=2``
   equal to phase 4c's conversions of A; ``detect_block`` of the P1
   stream 1.  Counters (all thirteen, P34 the pass of phase 4p) are set to 0 before this phase and
   must rise by exactly the expected launches.  Then B7 against its
   plain version and ``torch.searchsorted``, bit for bit, on both call
   sites' streams, both sides, on edge cases and on ``merge_streams``
   (random queries, ties and sentinels at the narrowed ranges' edges,
   queries below and above every target, n = 2^k +- 1), each variant of
   its timing probe too.  Then complex values
   (``complex_checks``): fills, SpMVs and a refill on the card, where
   the float kernels take them one real part at a time, against the
   CPU's plain versions, each part within the kernel's tolerance.
4e. the policy and analysis layers (``repro_torch.sparse.tuning`` and
   ``.analysis``): every family resolves to its priors on ``cuda`` and
   each build-time prior equals what its library exports; the resource
   report (registers, spills, shared bytes and blocks an SM of every
   kernel instance, read from each library) against its declared
   columns, and ``--prior-only`` consuming every row of it; the
   ``--measure`` sweep in-process (set 1 at 2.5e6 for the sorts and B7,
   the 5e7 set for ``plan``, phase 4c's FEM SymCSC for B9, whose
   cut-offs it straddles; device ms per candidate, one candidate per
   distinct call-site decision, each candidate's output held against
   the prior's: bit for bit, B9 within 16 eps; no plain method is a
   candidate on the card), its table saved and loaded through
   ``REPRO_TUNING_CACHE_DIR`` in a child process
   (``--loaded-table-check``) that checks each recorded entry steers its
   call site to the sweep's winner and runs ``fsparse`` on sets 1-3 bit
   for bit against the oracle; the host cost of one
   memoised ``resolve_policy`` and the plan and fill call ms at sets
   1-3 beside those before the policy layer;
   ``validate_pattern``/``validate_matrix`` on the plans and formats of
   phases 4-4d, a ``SymPattern``, and one ``update`` under
   ``REPRO_VALIDATE=1``; ``audit_default_paths`` on CUDA tensors.  All thirteen counters are set to 0 before the sweep and
   must be above 0 after the audit; the phase must end within 90 s.
   The rest of the run resolves from the priors again.
4f. the plan service (``PlanService``): cold, warm (threads) and
   restarted requests on sets 1-3 against phase 4's oracle-checked
   results, CUDA-graph replays against eager calls, an update, a batch,
   the contract audit of the hits and the profiler's witness; must end
   within 90 s.
4g. the sharded path (``repro_torch.sparse.sharded``): ``fsparse(...,
   method="sharded")`` on sets 1-3 on the default mesh (one shard) and
   on ``make_data_mesh(4)`` (four shards on the card), and on the 5e7
   set at four; each result's ``convert(S, "csc")`` bit for bit the
   oracle's and, on sets 1-3, a fresh single-device ``fsparse``'s.  The
   B1, B2 and B3' counters are set to 0 before these runs and must rise
   by exactly p x the digit passes of one block's plan (B1, B2) and one
   fill (B3') a run.  Then per run: Phase A's invariants (``send_base``
   an exclusive scan from 0, ``block_load`` summing to L, the blocks'
   nnz to the global nnz); on set 2 at four shards ``assemble_batch``
   bit for bit against single fills, the block-row SpMV within ``8 eps
   sum_j |a_ij x_j|`` of the single-device CSC SpMV, the fill's
   gradient bit for bit the plain version's on the CPU, B3' against its
   plain version on the routed stream; a skewed row distribution raising
   the overflow ``ValueError``; ``sparse2`` a miss, a hit (one fill, no
   plan kernel) and a miss on another p; ``PlanService.assemble`` of a
   sharded request (uncaptured).  Times: ``plan_sharded`` against
   ``plan`` and the routed fill against the single fill (call and
   device), plan once and fill many against plan and fill each call;
   must end within 60 s.
4h. the LM serving path (``repro_torch.models``, ``launch/serve.py``):
   OLMoE-1B-7B (``configs/olmoe_1b_7b.py``) at full width and depth in
   bf16 from ``init_model(cfg, seed=0, device="cuda")``, its weights'
   ``memory_allocated`` printed; 8 requests served through
   ``repro_torch.launch.serve.main`` in-process (batch 4, prompts of
   512, 32 tokens), every logit finite and every token in ``[0,
   vocab)``.  All thirteen counters are set to 0 before the served run;
   B12 and B11 must then read 1,024 each (one per MoE layer call: 16
   layers x 32 calls x 2 batches) and the others 0.  On the same model,
   the one-process runs phase 4o (d) is held to (``rank_serve_reference``:
   ``rank_serve_prompts``, two token groups, RANK_SERVE_GEN greedy
   tokens with the output projection summed as the (2, 2) mesh sums it,
   and the plain prefill; written to ``build/``).  Then: layer 0's
   expert ids of one prefill (16,384 keys) and one decode step (32)
   through ``moe_dispatch_indices`` on the card, bit for bit the plain
   route's and a stable ``torch.argsort``'s, also in 4 groups (256
   bins); a one-layer float32 OLMoE's prefill logits on the card within
   ``LM_F32_RTOL`` of ``max|logit|`` of the CPU's, the same weights on
   both; ``decode_step`` after ``prefill(..., extra_cache=1)`` against
   ``forward`` (capacity ``E/K``: nothing dropped) on the 16-layer bf16
   model within ``LM_BF16_RTOL`` and on a two-layer float32 copy at full
   width within ``LM_F32_DECODE_RTOL``, where two planted faults (a step
   one position on, a step that ignores the cache) must read above the
   limit; the embedding gradient through
   ``sparse_grad_embed`` at the full vocabulary (T = D = 2,048) on the
   card against the CPU, bit for bit on integer-valued gradients,
   within ``2 (n - 1) eps sum|g|`` otherwise.  Times: prefill and a
   decode step (call and device, and the profiler's kernel time: kernel
   and copy events only, not the operators' device annotations) against
   the decode step's byte bounds at 3.35 TB/s: the capacity-buffer
   algorithm's (every expert's weights, plus the rest and the KV cache)
   and the step's own (only the experts the step routes to, read off
   its expert ids layer by layer),
   ``tok/s`` as ``serve`` prints it, the dispatch (B12 + B11 + the row
   scatter) against a stable ``torch.argsort`` + ``bincount`` with the
   same scatter, B12 and B11 alone, the top kernels,
   ``max_memory_allocated``; must end within 120 s.
4i. the LM training path (``repro_torch.train``, ``data``, ``ckpt``,
   ``launch/train.py``): OLMoE-1B-7B at full width cut to 4 of its 16
   layers (the train state's 18 B a parameter: 32.07 GB at 4 layers,
   122.7 GB at 16), bf16, from ``init_model(cfg, seed=0,
   device="cuda")`` and ``init_train_state``, its parameters and
   ``memory_allocated`` held against the reckoning (1,781,550,080
   parameters); 8 steps of ``make_train_step`` (2 microbatches, bf16
   gradient compression with error feedback, AdamW with 2 warm-up
   steps) on one repeated ``SyntheticLM`` batch of 8 x 512: every loss
   finite, the last below the first.  All thirteen counters are set to 0
   before the steps; B12 and B11 must then read 144 each (8 steps x 2
   microbatches x (4 forward + 4 recompute MoE dispatches + 1
   embedding gradient)), P34 16 (one an embedding gradient) and the
   others 0.  Times: a step's call, split
   by CUDA events into forward + backward + compression and AdamW,
   tok/s, the profiler's kernel time and top kernels, against the
   step's FLOP bound at 989 TFLOP/s (the capacity buffers' expert
   einsums, remat's recompute, a backward of twice the forward) and
   the update's byte bound; B12 and B11 at a microbatch's dispatch
   (16,384 keys, 64 bins) and embedding gradient (2,048 keys, 50,432
   bins); ``max_memory_allocated``.  Then a one-layer float32 OLMoE at
   full width on the card against the CPU (``loss_fn`` and every
   gradient leaf within ``TRAIN_F32_RTOL``; ``adamw_update`` on the
   same handed-over gradients within ``TRAIN_OPT_RTOL``), and
   ``launch.train.main`` in-process on the card (``olmo_1b
   --reduced``): 6 steps, a second call that resumes from its
   checkpoint and runs to 9, against an uninterrupted run to 9 within
   ``TRAIN_RESUME_RTOL``, and the final state saved and restored bit
   for bit; must end within 120 s.
4j. the ssm and hybrid serving path (``repro_torch.models.ssm``, the
   ``ssm`` and ``hybrid`` branches of ``models/model.py``): Mamba2-780M
   (``configs/mamba2_780m.py``) and Zamba2-7B (``configs/zamba2_7b.py``)
   at full width and depth in bf16 from ``init_model(cfg, seed=0,
   device="cuda")``, their parameter counts held to the reference's
   (``SSM_PARAMS``) and ``memory_allocated`` printed; each served
   through ``repro_torch.launch.serve.main`` in-process as in 4h, every
   logit finite and every token in ``[0, vocab)``; all thirteen counters
   set to 0 before each served run must read 0 after it (serving these
   families runs none of the thirteen kernels).  Then, on each: float32
   copies at full width (Mamba2 with 1 layer, Zamba2 with 6: one shared
   application) whose prefill logits on the card are within
   ``LM_F32_RTOL`` of the CPU's; ``decode_step`` after ``prefill(...,
   extra_cache=1)`` against ``forward``'s last position on the bf16
   full-depth model within ``LM_BF16_RTOL`` and on the float32 copy
   within ``LM_F32_DECODE_RTOL``, where planted faults (a step whose SSM
   state restarts from zero, one whose conv window is a row stale, and
   for Zamba2 a shared-attention step one position on) must read above
   the limit; the one-layer float32 Mamba2's prefill state and conv
   window after ``chunk + 3 = 259`` tokens against a stepwise decode
   from a zero cache within ``SSM_STATE_RTOL``.  Times: prefill and a
   decode step (call, device, the profiler's kernel time and top
   kernels) against the decode step's byte bound at 3.35 TB/s (the
   weights, the shared block's once per application, the SSM and conv
   states read and written, the shared block's KV caches), ``tok/s``
   as ``serve`` prints it, ``max_memory_allocated``; must end within
   120 s.
4k. the ssm and hybrid training path: Mamba2-780M at full width and
   depth (the train state: 18 B a parameter, 14.05 GB) and Zamba2-7B at
   full width cut to 12 of its 81 layers (two shared applications;
   1,255,956,416 parameters, 22.6 GB), each trained as in 4i (8 and 4
   steps of 2 microbatches on one repeated ``SyntheticLM`` batch of 8 x
   512): every loss finite, the last below the first; B12 and B11 must
   read one launch each per microbatch (the embedding gradient: 16 and
   8) and the others 0.  Times as 4i's, against the update's byte bound
   and the step's FLOP bound split by precision (the projections, the
   shared block's MLP and the unembedding in bf16 at 989 TFLOP/s; the
   SSD scan's einsums and the shared attention's products in float32
   at 67 TFLOP/s).  Then float32 copies at full width against the CPU
   (``loss_fn``, every gradient leaf, ``adamw_update``): Mamba2 with 1
   layer at S = 259, Zamba2 with 6 at S = 64 (the shared block's
   gradient); and ``launch.train.main`` on ``zamba2_7b --reduced`` as
   in 4i; must end within 120 s.
4l. the encdec and vlm serving path (the ``encdec`` and ``vlm``
   branches of ``models/model.py``, the stub batches of
   ``launch/serve.py``): Seamless-M4T-medium
   (``configs/seamless_m4t_medium.py``) and Llama-3.2-Vision-11B
   (``configs/llama_3_2_vision_11b.py``) at full width and depth in bf16
   from ``init_model(cfg, seed=0, device="cuda")``, their parameter
   counts held to the reference's (``CROSS_PARAMS``) and
   ``memory_allocated`` printed; each served through
   ``repro_torch.launch.serve.main`` in-process as in 4h; all twelve
   counters set to 0 before each served run must read 0 after it.  Then,
   on each: float32 copies at full width (Seamless with 2 encoder and 2
   decoder layers, Llama-3.2-Vision with one layer and its cross block
   over all 1,601 vision tokens) whose prefill logits on the card are
   within ``LM_F32_RTOL`` of the CPU's; ``decode_step`` after
   ``prefill(..., extra_cache=1)`` against ``forward``'s last position
   (a source of 48 positions beside 64 tokens) on the bf16 full-depth
   model within ``LM_BF16_RTOL`` and on the float32 copies within
   ``LM_F32_DECODE_RTOL``, where planted faults (the cross K/V zeroed;
   Seamless's encoder run causal in the prefill; at full depth,
   Llama-3.2-Vision's 8 cross blocks each reading the next one's K/V)
   must read above the limit.  Llama-3.2-Vision's faults move its bf16
   logits by less than ``LM_BF16_RTOL`` (``CROSS_F32_FULL_DEPTH``): they
   are read there and held on a float32 copy at full depth (38.3 GB).  Times: prefill against its FLOP bound
   split by precision (the projections at 989 TFLOP/s bf16, the
   attention's upcast products over every chunk at 67 TFLOP/s) and a
   decode step against its byte bound at 3.35 TB/s (the decoder's
   weights but not the cross blocks' K/V projections, the caches read),
   the profiler's kernel time and top kernels, ``tok/s`` as ``serve``
   prints it, ``max_memory_allocated``; must end within 120 s.
4m. the encdec and vlm training path: Seamless-M4T-medium at full
   width and depth (12.9 GB of state) and Llama-3.2-Vision-11B at full
   width cut to 10 of its 40 layers (two cross blocks; 2,790,354,944
   parameters, 50.2 GB), each trained as in 4i (8 and 4 steps) on one
   repeated ``SyntheticLM`` batch with the launcher's stub embeddings:
   every loss finite, the last below the first; B12 and B11 must read
   one launch each per microbatch (16 and 8) and the others 0.  Times as
   4i's, against the update's byte bound and the step's FLOP bound
   split by precision.  The embedding gradient at each vocabulary
   (256,256 and 128,256 bins: B12's global-counter instance, printed)
   with B12 and B11 bit for bit against their plain versions on the card
   and the gradient against the CPU; the float32 copies of 4l against
   the CPU (``loss_fn``, every gradient leaf, ``adamw_update``) at S =
   64; ``launch.train.main`` on both ``--reduced`` archs as in 4i; must
   end within 120 s.
4n. the production sharding and the dry run.  (a) ``python -m
   repro_torch.launch.dryrun`` in a child started before phase 4e,
   niced, seven cells at once on the host's cores while phases 4e-4m
   drive the card, collected here; the fake 256-rank ``"cuda"``
   mesh for all 40
   single-pod cells and on the 512-rank mesh for one cell of each
   family (``DRYRUN_MULTI_CELLS``; the whole 80-cell sweep does not fit
   the phase: PERF.md); every cell ok but the seven full-attention
   archs' ``long_500k``, skipped with the reference's reason; the
   multi-pod cells on ``{"pod": 2, "data": 16, "model": 16}`` with
   FLOPs; every arch's parameters and train state per rank as the rules
   give them (``DRYRUN_PER_RANK_MIB``); prints the slowest trace, each
   arch's ``train_4k`` temp bytes and FLOPs and each census total; must
   end within 600 s of its start.  (b) a one-rank NCCL group (a ``HashStore``) and a
   1 x 1 ``DeviceMesh``: 4i's OLMoE state placed by ``param_shardings``
   and its batch by ``batch_specs_for``; one train step and one
   ``decode_step`` on the DTensors against the same steps on plain
   tensors from the same seed, with deterministic algorithms, bit for
   bit (loss, every updated state leaf, logits, cache), B12/B11
   launching as often in both; ``FlopCounterMode``'s count of a plain
   step on the trained tensors; the same
   step traced by the dry run on a fake 1 x 1 mesh in a child: its
   argument bytes the real state's and batch's, its FLOPs
   ``FlopCounterMode``'s count of the plain step, its temp bytes beside
   the card's peak; must end within 180 s.
4o. the port across ranks: four processes on the one card, a ``gloo``
   group (``launch/ranks.py``: NCCL refuses two ranks on one card), the
   kernels built by the parent and loaded by each rank
   (``python3 chip_smoke.py --ranks-phase DIR`` under
   ``launch.ranks.spawn_ranks``; the backend, world size and device
   printed).  (a) sets 1-3 and 2x20 through ``plan_sharded`` and the
   routed fill on the rank mesh ``make_data_mesh()`` (p = 4): each
   rank's fields bit for bit block r of the one-process plan of phase
   4g, the fill bit for bit on integer data and within ``C_SEG`` eps of
   sum|terms| on random data, the gathered SpMV within ``8 eps sum_j
   |a_ij x_j|`` of the one-process one; B1 and B2 a block's digit passes
   and B3' one launch a fill on every rank; ``plan_sharded_ranks_ms``,
   ``routed_fill_ranks_ms`` and the exchange alone (``exchange_ms``).
   (b) OLMoE-1B-7B at full width on RANK_LM_LAYERS layers, bf16, on a
   ``(data 2, model 2)`` rank mesh (the state placed by the sharding
   rules, the MoE dispatch on each data shard's tokens) for
   RANK_LM_STEPS steps of 4i's batch as one microbatch (each microbatch
   gathers the weights again): every loss finite, the first (the same
   weights) within RANK_BF16_FIRST_RTOL and every one within
   RANK_BF16_RTOL of the one-process steps on the same state and batch
   (two token groups, as the two data shards); B12 and B11 each
   RANK_LM_STEPS x (2 x RANK_LM_LAYERS + 1) times on every rank;
   ``step_ms``; a float32 one-layer copy, each rank on its shards: its
   loss and every gradient leaf against the one-process ones within
   4i's TRAIN_F32_RTOL, then the step's update half
   (``train_step.apply_gradients``) on the one-process gradients handed
   to both, its global norm within 4i's TRAIN_OPT_RTOL and the
   parameters, master, mu, nu and ef within it of each leaf's largest.
   (d) serving: OLMoE-1B-7B whole (16 layers, bf16, seed 0) on the
   ``(data 2, model 2)`` rank mesh, its weights in the layout
   ``launch.sharding.serving_mode`` chooses (``"serve"``: TP only) drawn
   block by block (``init_model(..., place=node_placer(...))``), the MoE
   dispatch on each data shard's tokens (``set_moe_dispatch``): one
   request batch of 4h's shape (``rank_serve_prompts``), ``prefill`` and
   greedy decode to RANK_SERVE_GEN tokens (``shards.greedy_tokens``),
   against 4h's one-process run of the same prompts (two token groups;
   ``rank_serve_reference`` writes it to ``build/`` RANK_SERVE_REF),
   whose attention output projection is summed as the mesh sums it
   (``tp2_out_proj``: two bf16 partial sums added in bf16): the
   prefill's last-position logits within RANK_SERVE_RTOL of max|logit|,
   each row's tokens equal up to its first step whose one-process top-2
   margin is within twice that, and each decode step's logits up to
   there within RANK_DECODE_RTOL; the logits within LM_BF16_RTOL of the
   plain one-process prefill's; the outputs each step redistributed to
   where ``logits_spec``/``cache_specs`` put them
   (``model.LAYOUT_FIXES``), counted, the same on every rank; B12 and
   B11 RANK_SERVE_CALLS
   times on every rank and B1-B3' none; ``prefill_ranks_ms``,
   ``decode_ranks_ms``, ``tok_per_s_ranks`` and the peak GB a rank.
   Then float32 on the rank mesh against one process on the card, the
   same weights and inputs, logits and every cache leaf within
   RANK_SERVE_F32_RTOL: a one-layer OLMoE (B = 2, S = 128, 3 decode
   steps) and each of RANK_SERVE_CASES (the six families reduced, three
   sequence-sharded caches past the ring's wrap).  (e)
   ``PlanService(method="sharded")`` on sets 3 and 2x20: each rank's
   block of ``assemble`` and ``assemble_many`` bit for bit block r of
   4g's one-process ``fsparse(method="sharded")`` call (made again in
   the rank), the SpMV within ``8 eps sum_j |a_ij x_j|`` of the
   one-process SpMV; B1 and B2 a
   block's digit passes and B3' one launch a fill on every rank;
   ``hit_ranks_ms``.  (c) the launcher, ``launch.train.main`` on
   ``--arch olmo_1b --reduced --dp 2 --tp 2`` for three steps, in the
   same four ranks (its group and its mesh are theirs; rank 0 prints
   its lines; it ends the group, so it runs after (d) and (e)).  Must
   end within PHASE_4O_LIMIT_S.
4p. Parts 3-4's pass (``csrc/pattern_build.cu``; run after phase 5's
   times, before the summary, or alone with ``python3 chip_smoke.py
   --parts34-phase``): both entries against the plain version bit for
   bit on ``parts34_case``'s edge cases and on streams of many tiles, at
   three nzmax each (the case's, L / 3, L + 4097), 16 B aligned and
   not, K0 choosing pairs for some and the two key streams for others
   (the choice it leaves in its scratch word); in the shapes of the
   benchmark's two assemble cells (the FEM matrix at n = 1999, set 2 at
   1e6) under their radix permutations, where ``plan`` must launch the
   pass once; then its device time beside its byte bound, set 2's
   gather floor (``parts34_bytes``) and the plain version's, and the
   pass with K0's other choice imposed, bit for bit and timed.  Must
   end within PARTS34_PHASE_S.
5. times, with CUDA events: the device time of the plan (radix and
   counting sort), the fill (fused and unfused), each kernel, its plain
   version and a PyTorch yardstick (calls back to back behind a device
   sleep that hides the host's dispatch; B11 as the counting sort calls
   it, on a handed-over table, with the copy a standalone call makes
   timed apart; B1 and B2 on the radix chain's second pass, B2 with
   the words it carries there; B1 against ``torch.bincount`` of (tile,
   digit), and on every digit pass beside the design it replaced, the
   other variants of its probe and its loads alone, in turns
   (``hist_pass_row``), with the plan and the radix sort run again with
   the replaced B1 (``replaced_b1``); B2 against a stable ``torch.sort``
   of the digit; B4 against
   ``scatter_reduce_`` with the gather ``v[perm]`` inside the timed
   call; B3' and B4 beside the gather floor, ``gather_floor``: their
   loads without the reduction; the radix sort against a stable
   ``torch.sort`` of the int64 key ``col * (M + 1) + row``), B3' and B4
   on one run of 2^20 duplicates and on L = 5e7 in runs of 2^20, each
   against the same positions with every slot once (``*_longrun*``,
   ``*_runs1*``), and the time of one call as a
   caller pays it (device plus dispatch gaps; the ratio of the two is
   the device's idle share); host-clock medians of the whole
   ``fsparse`` call, of a ``sparse2`` miss and hit, and of building
   and hashing the ``sparse2`` key.  For the third path, at its size:
   B6, B8, B9 and B10 as above (yardsticks ``index_add_`` with the two
   gathers and the product inside the timed call, cuSPARSE CSR and BSR
   ``torch.mv``); B6 on both products of the Galerkin operator (``P'
   A`` and ``(P' A) P``, each with its own bytes and bound) beside the
   design it replaced, its two-gather floor (``gather2_floor``) and each
   variant of its timing probe (``PRODUCT_VARIANTS``: tile depths and
   register bounds, the sweep), and on one run of 2^20 products against
   2^20 runs of one; the plan and
   fill of A, each SpMV, one CG iteration, ``product_plan`` split into
   the host expansion and the device plan, and the B6 refills.  For
   the fourth path: per set and delta share the update against a
   re-plan of the whole set, the update split into delta sort, B7,
   materialisation and Parts 3-4, ``sparse2_update`` of the edge flip
   on the host clock, ``plan_symmetric`` against ``plan`` of A and the
   ``SymPattern`` refill against the full fill, and B7 at both call
   sites (yardstick ``torch.searchsorted`` with the int64 packing of
   both streams it needs inside the timed call, and each of the two
   apart; bound: the queries, the offsets and the targets the ladder
   reaches), beside the design it replaced and the other shapes of
   ``merge_probe``; B9 on the FEM stream, the arrow matrix and short
   columns of as many slots, beside the design it replaced (with its
   zeroing of ``up``) and the other shapes of ``sym_probe``.

The last lines are the ``{"kernels": [...]}`` summary, the nvidia-smi
line and ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.oracle import matlab_sparse_oracle  # noqa: E402
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
#: 32-bit non-tensor-core rate, used for the ops bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Table 4.1 sets at full scale, plus set 2 scaled to L = 5e7
BIG = dict(siz=1_000_000, nnz_row=50, nrep=1)
SEED = 0
REPS = 20
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
#: B5's tolerance: each prefix within C_SCAN * eps of the running sum of
#: |x| (the kernel's first-order worst case is about 31 eps, see
#: csrc/segment_sum.cu); a difference of two prefixes (fill_pallas)
#: within twice that
C_SCAN = 64
#: the third path: fem_poisson's P1 mesh with 999 x 999 cells, 10^6
#: vertices; ELL width = the P1 stencil's row length; CG iterations
FEM_N = 999
FEM_K = 7
CG_ITERS = 50
#: CG on a random right-hand side: the relative residual after CG_ITERS
#: iterations on the card (float32) may differ from the same iterations
#: in float64 on the host by CG_RTOL of it, plus CG_ATOL (float32's
#: floor, for a system that converges in fewer iterations)
CG_RTOL, CG_ATOL = 1e-3, 1e-5
#: B3''s tolerance: each slot within C_SEG * eps * sum|terms| of the
#: exact sum (the kernel's first-order worst case is (K + 12) eps / 2 =
#: 10 eps at K = 8, see csrc/segment_sum.cu)
C_SEG = 16
#: the long run of B3''s and B4's run-length checks and of
#: ``B3_longrun_ms``
LONG_RUN = 1 << 20
ACCUM_SETS = ("1", "3")
ACCUM_MODES = ("min", "max", "mean", "first", "last")
#: phase 4d: the appended delta as a share of L (``benchmarks/
#: bench_update.py``'s split: the base is the first L - Ld triplets), and
#: the share of the FEM mesh's cells whose diagonal the edge flip turns
UPDATE_FRACS = (0.01, 0.1)
FLIP_FRAC = 0.01
#: the P1 matrix of a right triangle written (leg end, right-angle
#: vertex, leg end), the order of the edge flip's new triangles
K_FLIP = 0.5 * np.array([[1, -1, 0], [-1, 2, -1], [0, -1, 1]])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def call_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn()``, in ms: the device
    time plus any gap while the host dispatches (as a caller pays it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sleep_cycles_per_ms() -> float:
    a, b = _events()
    a.record()
    torch.cuda._sleep(10**8)
    b.record()
    b.synchronize()
    return 1e8 / a.elapsed_time(b)


def device_ms(fn, cycles_per_ms: float, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` in ms, ``reps`` calls back to back.

    The device first sleeps for longer than the host takes to enqueue
    all the calls, so no host dispatch gap falls between the events.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    a, b = _events()
    torch.cuda._sleep(int(2 * reps * host * cycles_per_ms) + 10**6)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` ending in a synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def top_kernels(fn, k: int = 4) -> list:
    """The ``k`` CUDA kernels with the most device time in one call of
    ``fn()`` (``torch.profiler``), as ``[name, ms]`` pairs."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return [[name[:60], ms] for name, ms in
            sorted(rows, key=lambda r: -r[1])[:k]]


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def slot_ids(i0: np.ndarray, j0: np.ndarray, M: int):
    """Each triplet's output slot (the oracle's order: columns, then
    rows), and the input positions of each slot's first and last
    triplet."""
    order = np.lexsort((i0, j0))
    key = j0[order].astype(np.int64) * M + i0[order]
    start = np.empty(key.shape, bool)
    start[0] = True
    start[1:] = key[1:] != key[:-1]
    end = np.empty(key.shape, bool)
    end[-1] = True
    end[:-1] = start[1:]
    slot = np.empty(key.shape, np.int64)
    slot[order] = np.cumsum(start) - 1
    return slot, order[start], order[end]


def numpy_accum(v: np.ndarray, slot, first, last, accum: str):
    """The duplicate modes in numpy over the oracle's slot ids."""
    nnz = first.shape[0]
    if accum in ("min", "max"):
        out = np.full(nnz, np.inf if accum == "min" else -np.inf, v.dtype)
        (np.minimum if accum == "min" else np.maximum).at(out, slot, v)
        return out
    if accum == "mean":
        return (np.bincount(slot, weights=v.astype(np.float64),
                            minlength=nnz)
                / np.bincount(slot, minlength=nnz))
    return v[first if accum == "first" else last]


def _cut(lengths: np.ndarray, L: int) -> np.ndarray:
    """The run lengths (int64) up to position L, the last run cut there."""
    ends = np.cumsum(lengths)
    k = int(np.searchsorted(ends, L))  # the run that reaches L
    lengths = lengths[:k + 1].astype(np.int64)
    lengths[k] -= ends[k] - L
    return lengths


def run_lengths(L: int, rng, kind: str,
                long_run: int = LONG_RUN) -> np.ndarray:
    """Run lengths of a sorted slot stream of L positions.

    ``"long"``: runs of ``long_run``, each after a stretch of about 2,000
    positions in short runs (1-3), so the long runs start mid-tile;
    ``"random"``: lengths uniform in 1..10^4.
    """
    if kind == "random":
        return _cut(rng.integers(1, 10**4 + 1, L // 2500 + 2), L)
    n = L // long_run + 1
    short = rng.integers(1, 4, (n, 1000))
    return _cut(np.concatenate([short, np.full((n, 1), long_run)],
                               1).reshape(-1), L)


def ragged_slots(kind: str, tile: int, rng,
                 long_run: int = LONG_RUN) -> np.ndarray:
    """int32 slot streams that break a design of tiles of ``tile``
    positions; the kept slots count 0, 1, ... in stream order.

    ``"one_run"``: one run of ``long_run`` between about 2,000 positions
    of short runs on either side; ``"random"``: 2^21 positions in runs of
    1..10^4; ``"tile_edge"``: single slots up to a tile's last position,
    where a run of 2 tiles + 1 starts (it ends at the last position of
    the tile after next), a single at the following tile's first
    position, then runs of 1..7; ``"dropped_tile"``: runs of 1..7, then
    dropped slots (-1, then 2^30) from 3 positions before a tile to 5
    after it, then runs of 1..7 around a run of 3 tiles.
    """
    if kind == "one_run":
        lengths = run_lengths(long_run + 4000, rng, "long", long_run)
    elif kind == "random":
        lengths = run_lengths(1 << 21, rng, "random")
    elif kind == "tile_edge":
        lengths = np.concatenate([np.ones(tile - 1, np.int64),
                                  [2 * tile + 1, 1],
                                  rng.integers(1, 8, tile // 2)])
    else:
        before = _cut(rng.integers(1, 8, 2 * tile), 4 * tile - 3)
        after = np.concatenate([rng.integers(1, 8, tile // 4), [3 * tile],
                                rng.integers(1, 8, tile // 4)])
        dropped = np.full(tile + 8, 2**30, np.int64)
        dropped[:tile // 2] = -1
        return np.concatenate([
            np.repeat(np.arange(len(before)), before), dropped,
            np.repeat(np.arange(len(after)) + len(before), after)
        ]).astype(np.int32)
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


def merge_streams(kind: str, rng, block: int):
    """``(q_rows, q_cols, t_rows, t_cols, M)`` int32 numpy streams for B7,
    whose blocks of ``block`` queries narrow their search together; the
    targets are (col, row)-sorted, ``M`` is the sentinel row.

    ``"sorted_few"``: 3,001 sorted queries into 2^23 + 3 targets (Lq <<
    n, as the update's delta); ``"sorted_all"``: Lq = n = 2^17 + 3,
    sorted; ``"random"``: 4 blocks and 7 unsorted queries into 2^13
    targets, so a block's range is all of n; ``"sparse_random"``: 3,001
    of them into 2^23 + 3;
    ``"edges"``: each block's least and greatest key equal to targets of
    a long run of one key, rows M (the sentinel) among them, and queries
    on the ties at the splitters of the narrowed range; ``"below"`` and
    ``"above"``: every query under or over every target;
    ``"n_<n>"``: n targets (1, 2^k - 1, 2^k, 2^k + 1) and a ragged Lq
    (half a block and 37).
    """
    M, N = 997, 1 << 12

    def targets(n):
        tr = rng.integers(0, M + 1, n)
        tc = rng.integers(0, N, n)
        o = np.lexsort((tr, tc))
        return tr[o], tc[o]

    def queries(Lq):
        return rng.integers(0, M + 1, Lq), rng.integers(0, N, Lq)

    def sort(qr, qc):
        o = np.lexsort((qr, qc))
        return qr[o], qc[o]

    if kind == "sorted_few":
        tr, tc = targets((1 << 23) + 3)
        qr, qc = sort(*queries(3001))
    elif kind == "sorted_all":
        tr, tc = targets((1 << 17) + 3)
        qr, qc = sort(*queries((1 << 17) + 3))
    elif kind == "random":
        tr, tc = targets(1 << 13)
        qr, qc = queries(4 * block + 7)
    elif kind == "sparse_random":
        tr, tc = targets((1 << 23) + 3)
        qr, qc = queries(3001)
    elif kind == "edges":
        tr, tc = targets(1 << 13)
        # a run of 5,000 equal keys (col 7, row M) and rows M around it
        tc = np.concatenate([tc, np.full(5000, 7)])
        tr = np.concatenate([tr, np.full(5000, M)])
        o = np.lexsort((tr, tc))
        tr, tc = tr[o], tc[o]
        k = int(np.flatnonzero((tc == 7) & (tr == M))[0])
        # every block: its first and last query on targets, the rest on
        # ties with targets at evenly spaced positions
        pick = np.sort(rng.integers(0, tr.size, 9 * block + 5))
        pick[::block] = k
        pick[block - 1::block] = k + 4999
        qr, qc = tr[pick], tc[pick]
    elif kind in ("below", "above"):
        tr, tc = targets(1 << 12)
        tc = tc + 10
        qr, qc = queries(2 * block + 1)
        qc = qc % 10 if kind == "below" else qc + N + 10
    else:
        n = int(kind.split("_")[1])
        tr, tc = targets(n)
        qr, qc = queries(block // 2 + 37)
        k = min(n, qr.size) // 2
        qr[:k], qc[:k] = tr[:k], tc[:k]
    return tuple(np.asarray(a, np.int32) for a in (qr, qc, tr, tc)) + (M,)


#: the kinds of ``merge_streams`` (B7's sparse shape takes sorted_few and
#: sparse_random, its ladder n_4095 .. n_4097, its dense shape the others)
MERGE_KINDS = ("sorted_few", "sorted_all", "random", "sparse_random",
               "edges", "below", "above", "n_1", "n_4095", "n_4096",
               "n_4097")
#: B9's arrow matrix: one dense column of ARROW_DENSE strict-upper entries
ARROW_DENSE = 1 << 20
#: the slots of ``sym_lengths``' sweep streams, about the FEM matrix's
SWEEP_SLOTS = 3_000_000


def sym_lengths(kind: str, tile: int, rng, dense: int = ARROW_DENSE):
    """Column lengths of SymCSC strict-upper streams that break a design of
    tiles of ``tile`` merge items (each column end and each slot one).

    ``"arrow"``: dense + 1 columns, column c < dense with min(c, 3)
    entries (as the FEM matrix's few), the last with ``dense`` (every row
    above it: the row and column of a bordered system's Lagrange
    multiplier); ``"short"``: min(c, 3) entries a column and as many
    slots as ``"arrow"`` (its yardstick); ``"tile_edge"``: a column of
    2 tiles + 1 entries whose first slot is the last item of the fourth
    tile, a column of 1 after it and short ones around;
    ``"empty_runs"``: runs of 1 to 3 tiles of empty columns between
    stretches of short ones; ``"width_<w>"``: min(c, w) entries a column
    and ``"mixed_<w>"``: min(c, 3) with every 64th column of w (or c),
    each about ``SWEEP_SLOTS`` slots (the FEM matrix's 2.98e6), for
    timing the shapes of B9 against the longest column.
    """
    if kind == "arrow":
        return np.concatenate([np.minimum(np.arange(dense), 3), [dense]])
    if kind == "short":
        n = dense + 1 + dense // 3
        return np.minimum(np.arange(n), 3)
    if kind == "tile_edge":
        x = 3 * tile
        # columns 1 .. s hold one entry: the long column x starts at item
        # x + s = 3 tile - 1 + tile k
        s = 4 * tile - 1 - x
        return np.concatenate([[0], np.ones(s, np.int64),
                               np.zeros(x - 1 - s, np.int64),
                               [2 * tile + 1, 1],
                               np.minimum(rng.integers(0, 4, tile), 3)])
    if kind.startswith(("width_", "mixed_")):
        w = int(kind.split("_")[1])
        if kind.startswith("width_"):
            return np.minimum(np.arange(SWEEP_SLOTS // w), w)
        n = int(SWEEP_SLOTS // (3 + w / 64))
        lengths = np.minimum(np.arange(n), 3)
        lengths[63::64] = w
        return np.minimum(lengths, np.arange(n))
    runs = []
    for _ in range(8):
        runs.append(np.zeros(int(rng.integers(tile, 3 * tile)), np.int64))
        runs.append(rng.integers(1, 4, int(rng.integers(1, tile))))
    lengths = np.concatenate([[0]] + runs)
    return np.minimum(lengths, np.arange(lengths.size))


def sym_stream(kind: str, tile: int, rng, dense: int = ARROW_DENSE):
    """``(rows, indptr, M)``, int32 numpy, of ``sym_lengths(kind)``: column
    c of length l holds rows c - l .. c - 1.  ``"empty_runs"`` also has a
    row M (the sentinel) at every 64th slot and a padded tail of 37 slots
    of row M past indptr[M]."""
    lengths = sym_lengths(kind, tile, rng, dense)
    M = lengths.size
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = np.repeat(np.arange(M), lengths)
    rows = col - lengths[col] + (np.arange(col.size) - indptr[col])
    if kind == "empty_runs":
        rows[::64] = M
        rows = np.concatenate([rows, np.full(37, M)])
    return rows.astype(np.int32), indptr, M


PRODUCT_KINDS = ("one_run", "random", "tile_edge", "dropped_tile")
#: the host expansion of B' B for the arrow matrix is checked against this
#: before it is planned (B6's run check and times skip it above)
ARROW_GRAM_MAX_FLOPS = 2 * 10**7


def product_stream(kind: str, tile: int, rng, operands: int,
                   long_run: int = LONG_RUN):
    """``(sa, sb, slot)`` int32 numpy streams of B6 that break a design of
    tiles of ``tile`` positions: ``ragged_slots(kind)`` with ``sa`` and
    ``sb`` uniform into two operand vectors of ``operands`` values."""
    slot = ragged_slots(kind, tile, rng, long_run)
    sa, sb = (rng.integers(0, operands, slot.size).astype(np.int32)
              for _ in range(2))
    return sa, sb, slot


def arrow_gram_flops(dense: int = ARROW_DENSE) -> int:
    """The products of ``B' B`` for the arrow matrix ``B`` of
    ``sym_stream("arrow")``: the sum over its rows of their counts
    squared."""
    rows, _, M = sym_stream("arrow", 1, None, dense)
    return int(np.sum(np.bincount(rows, minlength=M).astype(np.int64) ** 2))


def arrow_gram(dev, rng, dense: int = ARROW_DENSE):
    """The product plan of ``B' B`` on ``dev``, ``B`` the arrow matrix of
    ``sym_stream("arrow")`` (random values): its slot for entry (M-1,
    M-1) is one run of ``dense`` products, the dense column's dot product
    with itself.  Returns ``(plan, B', B)``."""
    from repro_torch.core.csc import CSC
    from repro_torch.sparse import convert, ops, product_plan

    rows, indptr, M = sym_stream("arrow", 1, rng, dense)
    nz = rows.size
    B = CSC(data=torch.from_numpy(rng.standard_normal(nz).astype(
        np.float32)).to(dev), indices=torch.from_numpy(rows).to(dev),
        indptr=torch.from_numpy(indptr).to(dev),
        nnz=torch.tensor(nz, dtype=torch.int32, device=dev), shape=(M, M))
    Bt = convert(ops.transpose(B), "csc")
    return product_plan(Bt, B), Bt, B


def product_err_over_eps(got: torch.Tensor, va, vb, sa, sb, slot,
                         eps: float) -> float:
    """The largest |got - exact| / (eps sum|terms|) over the slots of a B6
    result: each slot's rounded products va[sa] * vb[sb], summed exactly
    (``exact_segment_sums``)."""
    terms = va[sa.long()] * vb[sb.long()]
    want, mag = exact_segment_sums(terms, slot, got.numel())
    err = np.abs(got.double().cpu().numpy() - want)
    return float((err / np.maximum(eps * mag, 1e-300)).max(initial=0.0))


def sym_err_over_eps(ct: torch.Tensor, rows, data, indptr, x,
                     eps: float) -> float:
    """The largest |ct - exact| / (eps sum|terms|) over the columns of a B9
    result: each column's terms a_s * x[r_s] as the kernel rounds them,
    summed exactly (``exact_segment_sums``)."""
    M, nz = x.shape[0], data.shape[0]
    s = torch.arange(nz, device=data.device)
    col = torch.searchsorted(indptr[1:].long(), s, right=True)
    valid = (col < M) & (rows >= 0) & (rows < M)
    lo = torch.where(valid, data * x[torch.where(valid, rows, 0).long()], 0)
    want, mag = exact_segment_sums(lo, torch.where(valid, col, -1), M)
    err = np.abs(ct.double().cpu().numpy() - want)
    return float((err / np.maximum(eps * mag, 1e-300)).max(initial=0.0))


def slot_stream(slot: np.ndarray, dev, seed: int):
    """``(perm, slot)`` int32 streams on ``dev`` as a plan gives them: the
    slot stream and a random permutation of its positions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(slot.shape[0], generator=gen, device=dev)
    return perm.to(torch.int32), torch.from_numpy(slot).to(dev)


def run_stream(lengths: np.ndarray, dev, seed: int):
    """:func:`slot_stream` of slot s repeated ``lengths[s]`` times."""
    return slot_stream(np.repeat(np.arange(len(lengths), dtype=np.int32),
                                 lengths), dev, seed)


def exact_segment_sums(v: torch.Tensor, slot: torch.Tensor, n: int):
    """Each slot's sum of ``v`` over its kept positions (``0 <= slot <
    n``, each slot one run) and its sum of ``|v|``, float64 on the host.

    The sums are taken in extended precision (``np.longdouble``): chunks
    of at most 1,024 positions of a run, then the chunks of the run, so
    a total of m terms is within (1023 + m / 1024) u sum|terms| (u =
    2^-64 on x86-64) before it is rounded to float64: within eps64 of
    sum|terms| in all for m <= 2^20.
    """
    if np.finfo(np.longdouble).eps > 2.0**-60:
        raise RuntimeError("np.longdouble is no wider than float64 here")
    out, mag = np.zeros(n), np.zeros(n)
    x, s = v.double().cpu().numpy(), slot.cpu().numpy()
    kept = np.flatnonzero((s >= 0) & (s < n))
    if kept.size == 0:
        return out, mag
    x, s = x[kept], s[kept]
    pos = np.arange(x.size)
    start = np.ones(x.size, bool)
    start[1:] = s[1:] != s[:-1]
    run0 = np.maximum.accumulate(np.where(start, pos, 0))
    chunks = np.flatnonzero(start | ((pos - run0) % 1024 == 0))
    runs = np.flatnonzero(start)
    first = np.searchsorted(chunks, runs)  # each run's first chunk
    out[s[runs]] = np.add.reduceat(np.add.reduceat(
        x.astype(np.longdouble), chunks), first).astype(np.float64)
    mag[s[runs]] = np.add.reduceat(np.abs(x), runs)
    return out, mag


def seg_err_over_eps(got: torch.Tensor, vals: torch.Tensor,
                     perm: torch.Tensor, slot: torch.Tensor,
                     eps: float) -> float:
    """The largest |got - exact| / (eps sum|terms|) over the slots of a
    B3' result, the sums of ``vals[perm]`` (0 where a slot's terms are
    all 0 and got is exact)."""
    want, mag = exact_segment_sums(vals[perm.long()], slot, got.numel())
    err = np.abs(got.double().cpu().numpy() - want)
    return float((err / np.maximum(eps * mag, 1e-300)).max(initial=0.0))


_PROBE: dict = {}


def probe_fn(name: str):
    """A launcher of ``csrc/segment_sum_probe.cu``, for timing only (the
    gather floors, B3''s, B4's and B6's variants and the design they
    replaced)."""
    if name not in _PROBE:
        from repro_torch.kernels import common
        lib = common.load_library("segment_sum_probe")
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for key, fn in (("sum", "probe_segment_sum_f32_launch"),
                        ("max", "probe_segment_max_f32_launch")):
            _PROBE[key] = common.bind(lib, fn, [I, P, P, P, P, P, LL, LL, P])
        _PROBE["floor"] = common.bind(lib, "probe_gather_floor_f32_launch",
                                      [I, P, P, P, P, LL, LL, P])
        _PROBE["sum2"] = common.bind(lib, "probe_product_sum_f32_launch",
                                     [I, P, P, P, P, P, P, P, LL, LL, P])
        _PROBE["floor2"] = common.bind(
            lib, "probe_gather2_floor_f32_launch",
            [I, P, P, P, P, P, P, LL, LL, P])
    return _PROBE[name]


def probe_fill(variant: int, vals, perm, slot, n: int, op: str = "sum"):
    """B3' (``op="sum"``) or B4's max (``"max"``) on float32 by a variant
    of the probe: 0 the replaced design (one thread walks each run), 1
    K = 4, 2 as shipped, 3 K = 16, 4 the index streams through __ldg."""
    L = slot.numel()
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    scratch = out if variant == 0 else torch.zeros(
        1 + 2 * -(-L // 1024), dtype=torch.int64, device=vals.device)
    rc = probe_fn(op)(variant, vals.data_ptr(), perm.data_ptr(),
                      slot.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                      L, n, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"probe {op} variant {variant}: CUDA error {rc}")
    return out


def gather_floor(vals, perm, slot, n: int, variant: int = 2):
    """The gather floor: ``y[j] = vals[perm[j]]`` where ``slot[j]`` is
    kept, with B3''s loads (variant 2) or at K = 16 (3); float32."""
    L = slot.numel()
    y = torch.empty(L, dtype=torch.float32, device=vals.device)
    rc = probe_fn("floor")(variant, vals.data_ptr(), perm.data_ptr(),
                           slot.data_ptr(), y.data_ptr(), L, n,
                           torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"gather floor variant {variant}: CUDA error {rc}")
    return y


#: B6's variants in ``csrc/segment_sum_probe.cu``: the replaced design
#: (one thread walks each run), the kernel as shipped, and its tile depth
#: K and least resident blocks an SM (unbounded: the compiler's choice),
#: or its index streams through __ldg
PRODUCT_VARIANTS = {"replaced": 0, "shipped": 1, "K4": 2, "K4_min8": 3,
                    "K8": 4, "K8_min5": 5, "K8_min4": 6, "K12": 7,
                    "K12_min4": 8, "K12_min3": 9, "ldg": 10, "K8_min6": 11,
                    "K12_min5": 12}


def product_probe(variant: int, va, vb, sa, sb, slot, n: int):
    """B6 on float32 by a variant of the probe (``PRODUCT_VARIANTS``)."""
    L = slot.numel()
    out = torch.zeros(n, dtype=torch.float32, device=va.device)
    scratch = torch.zeros(1 + 2 * -(-L // 1024), dtype=torch.int64,
                          device=va.device)
    rc = probe_fn("sum2")(variant, va.data_ptr(), vb.data_ptr(),
                          sa.data_ptr(), sb.data_ptr(), slot.data_ptr(),
                          out.data_ptr(), scratch.data_ptr(), L, n,
                          torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"B6 probe variant {variant}: CUDA error {rc}")
    return out


def gather2_floor(va, vb, sa, sb, slot, n: int, variant: int = 1):
    """The two-gather floor: ``y[j] = va[sa[j]] * vb[sb[j]]`` where
    ``slot[j]`` is kept, with B6's loads (variant 1), at K = 4 (2) or
    K = 12 (3); float32."""
    L = slot.numel()
    y = torch.empty(L, dtype=torch.float32, device=va.device)
    rc = probe_fn("floor2")(variant, va.data_ptr(), vb.data_ptr(),
                            sa.data_ptr(), sb.data_ptr(), slot.data_ptr(),
                            y.data_ptr(), L, n,
                            torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"two-gather floor variant {variant}: CUDA error {rc}")
    return y


def merge_probe(variant: int, qr, qc, tr, tc, side: str):
    """B7 by a variant of ``csrc/merge_probe.cu`` (``MERGE_VARIANTS``),
    for timing only: 0 the replaced design (one thread walks a query's
    whole ladder), 1 as shipped, the others other shapes of the kernel."""
    if "merge" not in _PROBE:
        from repro_torch.kernels import common
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _PROBE["merge"] = common.bind(common.load_library("merge_probe"),
                                      "probe_merge_search_launch",
                                      [I, P, P, P, P, P, LL, I, I, P])
    out = torch.empty(qr.numel(), dtype=torch.int32, device=qr.device)
    rc = _PROBE["merge"](variant, qr.data_ptr(), qc.data_ptr(),
                         tr.data_ptr(), tc.data_ptr(), out.data_ptr(),
                         qr.numel(), tr.numel(), int(side == "right"),
                         torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"merge probe variant {variant}: CUDA error {rc}")
    return out


#: B1's variants in ``csrc/radix_sort_probe.cu`` (``hist_probe``): the
#: replaced design (one tile a block), the kernel as shipped, and the
#: counter schemes that lost (counters by tile parity summed into a
#: staged chunk: per-warp or one set a block, an atomic a key or
#: ``__match_any_sync`` aggregation); ``HIST_FLOOR`` is the loads alone
HIST_VARIANTS = {"replaced": 0, "shipped": 1, "private": 2, "match": 3,
                 "private_match": 4, "block_parity": 5, "chunk8": 7,
                 "chunk32": 8}
#: the loads alone, and B1 without its flush (scratch outputs)
HIST_FLOOR, HIST_NO_FLUSH = 6, 9
#: B1's skewed streams (``hist_stream``) and the run lengths, in tiles a
#: block, at which the shipped kernel is also checked through the probe
#: (1, the chunk, the chunk + 1, a ragged run past two chunks)
HIST_KINDS = ("equal", "one_digit", "sorted", "reversed", "runs32",
              "over_nbins")
HIST_RUNS = (1, 16, 17, 37)


def hist_stream(kind: str, L: int, rng):
    """B1's skewed keys of ``kind`` (``HIST_KINDS``), made with numpy
    from ``rng``, and the digit pass ``dict(shift, bits, nbins)`` they
    are counted by (the second byte).  ``equal``: every key one value;
    ``one_digit``: one digit, the other bits random; ``sorted`` and
    ``reversed``: random keys in order, so the digit runs L / 256 keys;
    ``runs32``: runs of 32 equal digits starting 13 keys into a 16 B
    load, so runs cross the lanes' loads and the tiles' edges;
    ``over_nbins``: random digits with ``nbins`` = 200, the rest counting
    nowhere."""
    kw = dict(shift=8, bits=8, nbins=256)
    low = rng.integers(0, 256, L)
    if kind == "equal":
        keys = np.full(L, int(rng.integers(0, 1 << 16)))
    elif kind == "one_digit":
        keys = rng.integers(0, 1 << 14, L) << 16 \
            | int(rng.integers(0, 256)) << 8 | low
    elif kind in ("sorted", "reversed"):
        keys = np.sort(rng.integers(0, 1 << 16, L))
        keys = keys[::-1] if kind == "reversed" else keys
    elif kind == "runs32":
        keys = ((np.arange(L) + 13) // 32 * 37 % 256) << 8 | low
    elif kind == "over_nbins":
        keys = rng.integers(0, 1 << 16, L)
        kw["nbins"] = 200
    else:
        raise ValueError(f"unknown B1 stream {kind!r}")
    return np.ascontiguousarray(keys, dtype=np.int32), kw


def hist_probe(variant: int, keys, kw: dict, run: int = 0):
    """B1 by a variant of ``csrc/radix_sort_probe.cu`` (``HIST_VARIANTS``,
    or ``HIST_FLOOR``, whose output is scratch) at ``run`` tiles a block
    (0: the kernel's own run; the replaced design ignores it)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.radix_sort.radix_sort import TILE
    if "hist" not in _PROBE:
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _PROBE["hist"] = common.bind(
            common.load_library("radix_sort_probe"),
            "probe_digit_histogram_launch",
            [I, P, P, LL, I, I, I, I, I, P])
    L = keys.numel()
    nblocks = -(-L // TILE)
    out = torch.empty((kw["nbins"], nblocks), dtype=torch.int32,
                      device=keys.device)
    rc = _PROBE["hist"](variant, keys.data_ptr(), out.data_ptr(), L,
                        kw["shift"], kw["bits"], kw["nbins"], nblocks, run,
                        torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"B1 probe variant {variant}: CUDA error {rc}")
    return out


def hist_pass_row(keys, kw: dict, cpm: float, runs=()) -> dict:
    """B1 on one digit pass: the kernel and each variant of its probe at
    their own run length (and the kernel at each of ``runs`` tiles a
    block) held bit for bit against the plain version, then timed in
    turns (the list forward, then backward, so the replaced design comes
    first and last) beside the loads alone and ``torch.bincount`` of
    (tile, digit); with the pass's bytes, bound and the kernel's share
    of it."""
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ref import digit_block_histogram_ref
    L = keys.numel()
    want = digit_block_histogram_ref(keys, tile=rs.TILE, **kw)
    timed = {"replaced": lambda: hist_probe(0, keys, kw),
             "B1": lambda: rs.digit_block_histogram(keys, **kw),
             **{v: (lambda i=i: hist_probe(i, keys, kw))
                for v, i in HIST_VARIANTS.items()
                if v not in ("replaced", "shipped")},
             **{f"run{r}": (lambda r=r: hist_probe(1, keys, kw, run=r))
                for r in runs}}
    for v, fn in timed.items():
        require(torch.equal(fn(), want),
                f"B1 {v} differs from the plain version, {kw}, L = {L}")
    del want
    digit = (keys >> kw["shift"]) & ((1 << kw["bits"]) - 1)
    nflat = -(-L // rs.TILE) * kw["nbins"]
    flat = (torch.arange(L, device=keys.device) // rs.TILE) * kw["nbins"] \
        + digit
    timed["floor"] = lambda: hist_probe(HIST_FLOOR, keys, kw)
    timed["no_flush"] = lambda: hist_probe(HIST_NO_FLUSH, keys, kw)
    timed["bincount"] = lambda: torch.bincount(flat, minlength=nflat)
    # the keys once, the histogram once
    row = {"L": L, **kw, "bytes": 4 * L + 4 * nflat}
    row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], 3 * L)
    order = list(timed)
    for turn in (order, order[::-1]):
        for v in turn:
            row.setdefault(f"{v}_ms", []).append(device_ms(timed[v], cpm))
    for v in order:
        row[f"{v}_ms"] = float(np.mean(row[f"{v}_ms"]))
    row["ms"] = row.pop("B1_ms")
    row["share"] = row["bound_ms"] / row["ms"]
    row["replaced_share"] = row["bound_ms"] / row["replaced_ms"]
    return row


@contextlib.contextmanager
def replaced_b1():
    """The radix chain (``radix_sort_pair``, every ``plan``) with B1's
    replaced design (``hist_probe`` variant 0) in place of the kernel,
    inside the ``with``: the "before" of the plan's device times."""
    from repro_torch.kernels.radix_sort import ops
    shipped = ops.digit_block_histogram
    ops.digit_block_histogram = lambda keys, **kw: hist_probe(0, keys, kw)
    try:
        yield
    finally:
        ops.digit_block_histogram = shipped


#: the variants of ``merge_probe`` and of ``sym_probe``, by name
MERGE_VARIANTS = {"replaced": 0, "shipped": 1, "sparse": 2, "dense": 3,
                  "ladder_tie": 4, "split": 5, "narrow_only": 6,
                  "dense_tie": 7, "sparse_q2": 8, "ladder": 9}
SYM_VARIANTS = {"replaced": 0, "tiles": 1, "tiles_K4": 2, "tiles_K12": 3,
                "tiles_lookback_only": 4, "groups": 5, "columns": 6}
#: B9's phases, as ``sym_phase_stamps`` reads them
SYM_PHASES = ("search", "load", "walk", "carry", "write")


def sym_probe(variant: int, rows, data, indptr, x):
    """B9 on float32 by a variant of ``csrc/spmv_sym_probe.cu``
    (``SYM_VARIANTS``), for timing only: 0 the replaced design (one thread
    a column; ``up`` zeroed first, as its wrapper did), 1 the merge-path
    tiles as shipped, 6 one thread a column as shipped, 5 the column
    groups, the others other shapes of the tiles."""
    if "sym" not in _PROBE:
        from repro_torch.kernels import common
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib = common.load_library("spmv_sym_probe")
        _PROBE["sym"] = common.bind(lib, "probe_sym_streams_f32_launch",
                                    [I, P, P, P, P, P, P, P, LL, LL, P])
        lib.probe_sym_tile.argtypes = [I]
        lib.probe_sym_tile.restype = LL
        _PROBE["sym_tile"] = lib.probe_sym_tile
    M, nz = x.numel(), data.numel()
    tile = _PROBE["sym_tile"](variant)
    up = (torch.zeros if variant == 0 else torch.empty)(
        nz, dtype=torch.float32, device=x.device)
    ct = torch.empty(M, dtype=torch.float32, device=x.device)
    # the tiles' ticket and descriptors (the others take none)
    scratch = torch.zeros(1 + 2 * -(-(M + nz) // tile), dtype=torch.int64,
                          device=x.device) if tile else None
    rc = _PROBE["sym"](variant, rows.data_ptr(), data.data_ptr(),
                       indptr.data_ptr(), x.data_ptr(), up.data_ptr(),
                       ct.data_ptr(), scratch.data_ptr() if tile else None,
                       M, nz, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"sym probe variant {variant}: CUDA error {rc}")
    return up, ct


def sym_phase_stamps(rows, data, indptr, x) -> dict:
    """B9 as shipped on float32 with the probe's phase stamps: the mean
    device time of the ticket and of each phase of a tile
    (``SYM_PHASES``: the merge-path search, the loads, the walk, the
    carry with its look-back, the writes; thread 0's clock), a tile's
    mean lifetime, the kernel's span and the mean number of tiles in
    flight (lifetimes over span), in us."""
    if "sym_stamped" not in _PROBE:
        from repro_torch.kernels import common
        P, LL = ctypes.c_void_p, ctypes.c_longlong
        _PROBE["sym_stamped"] = common.bind(
            common.load_library("spmv_sym_probe"),
            "probe_sym_streams_stamped_f32_launch",
            [P, P, P, P, P, P, P, LL, LL, P, P])
    from repro_torch.kernels.spmv_sym.ref import SYM_TILE
    M, nz = x.numel(), data.numel()
    ntiles = -(-(M + nz) // SYM_TILE)
    stamps = torch.zeros(8 * ntiles, dtype=torch.int64, device=x.device)
    for _ in range(2):  # the second call is read
        up = torch.empty(nz, dtype=torch.float32, device=x.device)
        ct = torch.empty(M, dtype=torch.float32, device=x.device)
        scratch = torch.zeros(1 + 2 * ntiles, dtype=torch.int64,
                              device=x.device)
        rc = _PROBE["sym_stamped"](
            rows.data_ptr(), data.data_ptr(), indptr.data_ptr(),
            x.data_ptr(), up.data_ptr(), ct.data_ptr(), scratch.data_ptr(),
            M, nz, stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"stamped sym probe: CUDA error {rc}")
    raw = stamps.view(ntiles, 8).double().cpu().numpy() / 1e3
    st = raw[:, :6]
    d = np.diff(st, axis=1)
    life = st[:, 5] - raw[:, 6]
    span = st[:, 5].max() - raw[:, 6].min()
    return {"ticket_us": float((st[:, 0] - raw[:, 6]).mean()),
            **{f"{k}_us": float(d[:, i].mean())
               for i, k in enumerate(SYM_PHASES)},
            "tile_us": float(life.mean()), "span_us": float(span),
            "tiles_in_flight": float(life.sum() / span), "tiles": ntiles}


def hist_checks(dev, rng) -> None:
    """Phase 3, B1 on the skewed streams at L = 2.5e6 (``hist_stream``)
    and their run edges (the kernel at ``HIST_RUNS`` tiles a block,
    through the probe), bit for bit against the plain version; the
    kernel twice on each stream, the same bits; each variant of the
    probe bit for bit."""
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ref import digit_block_histogram_ref

    L = 2_500_000
    for kind in HIST_KINDS:
        keys_np, kw = hist_stream(kind, L, rng)
        keys = torch.from_numpy(keys_np).to(dev)
        want = digit_block_histogram_ref(keys, tile=rs.TILE, **kw)
        a = rs.digit_block_histogram(keys, **kw)
        require(torch.equal(a, want) and torch.equal(
            rs.digit_block_histogram(keys, **kw), a),
            f"B1 differs on the {kind} stream, or from launch to launch")
        for r in HIST_RUNS:
            require(torch.equal(hist_probe(HIST_VARIANTS["shipped"], keys, kw,
                                           run=r), want),
                    f"B1 at {r} tiles a block differs, {kind} stream")
        for v, i in HIST_VARIANTS.items():
            require(torch.equal(hist_probe(i, keys, kw), want),
                    f"B1 probe variant {v} differs, {kind} stream")
        emit({"check": "B1 vs plain, skewed stream", "stream": kind, "L": L,
              **kw, "runs": list(HIST_RUNS), "B1": "bit-identical, twice",
              "probe_variants": "bit-identical"})
    torch.cuda.synchronize()


def radix_chain(rows, cols, M: int, N: int, *, upto: int | None = None,
                check=None):
    """The radix chain of ``radix_sort_pair`` driven pass by pass on B1
    and B2, with the words each pass carries.

    ``check(i, pass, args)`` runs after pass ``i`` with ``args = (keys,
    hist, base, perm, carry, kw, out)``: the pass's inputs, B1's and
    B2's outputs.
    With ``upto``, stops before pass ``upto`` and returns its inputs
    ``(keys, base, perm, carry, kw)``; else returns the permutation.
    """
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ops import (carried_words,
                                                    digit_bases,
                                                    plan_digit_passes)

    passes = plan_digit_passes(M, N, rows.shape[0])
    perm = None
    for i, p in enumerate(passes):
        keys = cols if p.src_col else rows
        want = carried_words(passes, i)
        carry = tuple(w for w, k in zip((rows, cols), want) if k)
        kw = dict(shift=p.shift, bits=p.bits, nbins=p.nbins)
        hist = rs.digit_block_histogram(keys, **kw)
        base = digit_bases(hist)
        if i == upto:
            return keys, base, perm, carry, kw
        out = rs.digit_placement(keys, base, perm, carry=carry, **kw)
        if check is not None:
            check(i, p, (keys, hist, base, perm, carry, kw, out))
        perm, moved = out if carry else (out, ())
        moved = iter(moved)
        rows = next(moved) if want[0] else rows
        cols = next(moved) if want[1] else cols
    return perm


# -- the third path's data: fem_poisson's P1 mesh and a prolongation --------
def p1_triplets(n: int):
    """Stiffness triplets of ``examples/fem_poisson.py``'s structured P1
    mesh (n x n cells, two right triangles each, nine triplets per
    triangle), vectorised, in the example's order.  Zero-offset int32
    rows and cols, float64 values, and the vertex count (n + 1)^2."""
    ix, iy = np.meshgrid(np.arange(n, dtype=np.int32),
                         np.arange(n, dtype=np.int32), indexing="ij")
    v = lambda x, y: y * (n + 1) + x  # noqa: E731 (the example's vid)
    tri = np.stack([np.stack([v(ix, iy), v(ix + 1, iy), v(ix, iy + 1)], -1),
                    np.stack([v(ix + 1, iy + 1), v(ix, iy + 1),
                              v(ix + 1, iy)], -1)], -2)  # [n, n, 2, 3]
    K = 0.5 * np.array([[2, -1, -1], [-1, 1, 0], [-1, 0, 1]])
    full = (n, n, 2, 3, 3)
    rows = np.broadcast_to(tri[..., :, None], full).ravel()
    cols = np.broadcast_to(tri[..., None, :], full).ravel()
    vals = np.broadcast_to(K, full).ravel()
    return rows, cols, vals, (n + 1) * (n + 1)


#: Parts 3-4's edge cases (``parts34_case``)
PARTS34_CASES = ("padding", "empty_columns", "nzmax_below_nnz",
                 "nzmax_above_L", "one", "one_padding", "one_column",
                 "all_duplicates", "all_unique", "all_padding", "wide_gaps")


def parts34_case(kind: str, seed: int = 0, L: int = 600, M: int = 40,
                 N: int = 30):
    """Triplet keys of one of Parts 3-4's edge cases: ``(rows, cols,
    perm, M, N, nzmax)``, int32 numpy, ``perm`` the stable (col, row)
    order.  ``padding``: rows == M inside their columns;
    ``empty_columns``: no triplet in the first, some inner and the last
    columns; ``nzmax_below_nnz``, ``nzmax_above_L``; ``one`` and
    ``one_padding``: L = 1; ``one_column``: N = 1 and a vocabulary of M
    = 50,000 rows (the embedding gradient's shape); ``all_duplicates``,
    ``all_unique``, ``all_padding``; ``wide_gaps``: the triplets spread
    over N = 2^21 columns, so that runs of empty columns are wider than
    a warp (the first and last columns empty too)."""
    rng = np.random.default_rng(seed)
    nzmax = None
    rows = rng.integers(0, M + 1, L)
    cols = rng.integers(0, N, L)
    if kind == "empty_columns":
        keep = np.setdiff1d(np.arange(N), [0, 1, N // 2, N // 2 + 1, N - 1])
        cols = rng.choice(keep, L)
    elif kind == "nzmax_below_nnz":
        nzmax = L // 4
    elif kind == "nzmax_above_L":
        nzmax = L + 37
    elif kind in ("one", "one_padding"):
        rows = np.array([M if kind == "one_padding" else M // 2])
        cols = np.array([N - 1])
    elif kind == "one_column":
        M, N = 50_000, 1
        rows = rng.integers(0, 200, L)
        cols = np.zeros(L, np.int64)
    elif kind == "all_duplicates":
        rows, cols = np.full(L, M // 3), np.full(L, N // 2)
    elif kind == "all_unique":
        key = rng.choice(M * N, L, replace=False)
        rows, cols = key % M, key // M
    elif kind == "all_padding":
        rows = np.full(L, M)
    elif kind == "wide_gaps":
        N = 1 << 21
        cols = rng.integers(N // 7, N - N // 9, L)
    elif kind != "padding":
        raise ValueError(f"unknown Parts 3-4 case {kind!r}")
    perm = np.lexsort((rows, cols))
    return (rows.astype(np.int32), cols.astype(np.int32),
            perm.astype(np.int32), M, N,
            rows.shape[0] if nzmax is None else nzmax)


def fem_system(n: int):
    """``fem_poisson.py``'s Dirichlet system: boundary rows and columns
    dropped and replaced by identity rows; the load of u = sin(pi x)
    sin(pi y).  Returns zero-offset (rows, cols, float32 vals), the
    vertex count, the float32 right-hand side and u_exact."""
    rows, cols, vals, nv = p1_triplets(n)
    xs, ys = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1))
    boundary = ((xs == 0) | (xs == 1) | (ys == 0) | (ys == 1)).ravel()
    keep = ~(boundary[rows] | boundary[cols])
    bidx = np.nonzero(boundary)[0].astype(np.int32)
    rows_f = np.concatenate([rows[keep], bidx])
    cols_f = np.concatenate([cols[keep], bidx])
    vals_f = np.concatenate([vals[keep], np.ones(bidx.size)])
    h = 1.0 / n
    u_exact = (np.sin(np.pi * xs) * np.sin(np.pi * ys)).ravel()
    f = 2 * np.pi ** 2 * u_exact * h * h
    f[boundary] = 0.0
    return (rows_f, cols_f, vals_f.astype(np.float32), nv,
            f.astype(np.float32), u_exact)


def bilinear_prolongation(n: int):
    """P: fine vertices (n + 1)^2 -> coarse vertices at even (ix, iy),
    (n // 2 + 1)^2 of them.  Each fine vertex interpolates bilinearly
    from the coarse vertices around it (weights 1, 1/2, 1/4); a parent
    past the grid's edge is left out.  Zero-offset triplets (rows, cols,
    float32 vals) and the shape."""
    nf, nc = n + 1, n // 2 + 1
    i = np.arange(nf)
    par = np.stack([i // 2, i // 2 + 1], 1)                   # [nf, 2]
    w = np.where((i % 2 == 0)[:, None], [[1.0, 0.0]], [[0.5, 0.5]])
    ok = (w > 0) & (par < nc)
    # [iy, ix, y parent, x parent]
    rows = np.broadcast_to((i[:, None] * nf + i[None, :])[:, :, None, None],
                           (nf, nf, 2, 2))
    cols = par[:, None, :, None] * nc + par[None, :, None, :]
    vals = w[:, None, :, None] * w[None, :, None, :]
    keep = ok[:, None, :, None] & ok[None, :, None, :]
    return (rows[keep].astype(np.int32), cols[keep].astype(np.int32),
            vals[keep].astype(np.float32), (nf * nf, nc * nc))


def cg(apply, b: torch.Tensor, iters: int):
    """Conjugate gradients as ``fem_poisson.py`` runs them, a fixed number
    of iterations, on the device (no host synchronisation)."""
    x = torch.zeros_like(b)
    r = b - apply(x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        Ap = apply(p)
        alpha = rs / torch.dot(p, Ap).clamp(min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs.clamp(min=1e-30)) * p
        rs = rs_new
    return x, torch.sqrt(rs)


def cg_random_check(ops_cg, Asp, b: np.ndarray, iters: int, dev):
    """CG on ``b`` (a seeded random right-hand side, so every iteration
    has work to do) through each operator of ``ops_cg``, held against
    the same iterations in float64 on the host (``Asp`` a scipy matrix):
    the relative residuals ``||b - A u|| / ||b||``, both computed in
    float64 on the host, may differ by ``CG_RTOL`` of the float64 one
    plus ``CG_ATOL``.  Returns ``{name: residual}`` with the float64
    one under ``"float64"``."""
    b64 = b.astype(np.float64)

    def relres(u):
        return float(np.linalg.norm(b64 - Asp @ u.astype(np.float64))
                     / np.linalg.norm(b64))

    u64, _ = cg(lambda v: torch.from_numpy(Asp @ v.numpy()),
                torch.from_numpy(b64), iters)
    out = {"float64": relres(u64.numpy())}
    bd = torch.from_numpy(b).to(dev)
    for name, op in ops_cg.items():
        u, _ = cg(op, bd, iters)
        out[name] = relres(u.cpu().numpy())
        require(abs(out[name] - out["float64"])
                <= CG_RTOL * out["float64"] + CG_ATOL,
                f"CG on {name}, random b: relative residual {out[name]} "
                f"against {out['float64']} in float64")
    return out


def product_structure(ir_a, jc_a, ir_b, jc_b, M: int, N: int):
    """The structure of A @ B from host CSC arrays: every stored B(k, j)
    expanded against A's column k in numpy, the (i, j) stream put through
    the numpy oracle.  Returns the oracle's (irS, jcS)."""
    ka = np.diff(jc_a).astype(np.int64)                   # |A(:, k)|
    cols_b = np.repeat(np.arange(jc_b.size - 1), np.diff(jc_b))
    k = ir_b.astype(np.int64)
    counts = ka[k]
    start = np.repeat(jc_a[:-1].astype(np.int64)[k], counts)
    within = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                 counts)
    i = ir_a[start + within]
    j = np.repeat(cols_b, counts)
    _, ir, jc = matlab_sparse_oracle(i, j, np.ones(i.size), M, N)
    return ir, jc


def values_at(ref, indices: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """A scipy CSC matrix read at the slots of a CSC structure; slots the
    matrix does not store (scipy drops exact zeros) read 0."""
    ref = ref.tocsc()
    ref.sort_indices()
    M = ref.shape[0]
    cols = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    want = cols.astype(np.int64) * M + indices
    rcols = np.repeat(np.arange(ref.shape[1]), np.diff(ref.indptr))
    have = rcols.astype(np.int64) * M + ref.indices
    pos = np.searchsorted(have, want).clip(0, max(have.size - 1, 0))
    hit = have[pos] == want if have.size else np.zeros(want.size, bool)
    return np.where(hit, ref.data[pos] if have.size else 0.0, 0.0)


def fem_path(dev, n: int, iters: int, counts, rng):
    """Phase 4c, the third path: the FEM workload of ``examples/
    fem_poisson.py`` and ``examples/fem_multigrid.py`` at (n + 1)^2
    degrees of freedom.  ``counts()`` reads the launch counters.  Returns
    the check row (with the launches of the refill for 2 A), the
    launches of the phase, the launches it expects, and what the kernel
    checks and the timing phase need; the caller compares the counts."""
    import scipy.sparse as sp

    from repro_torch import kernels
    from repro_torch.core.csc import CSC
    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.sparse import (cached_product_plan, convert, ops, plan,
                                    product_cache_clear, product_cache_info)

    def npass(M, N, L):
        return len(plan_digit_passes(M, N, L))

    start = counts()
    exp = dict.fromkeys(start, 0)

    def expect(**kw):
        for k, v in kw.items():
            exp[k] += v

    t0 = time.perf_counter()
    rows, cols, vals, nv, f, u_exact = fem_system(n)
    pr_, pc_, pv_, pshape = bilinear_prolongation(n)
    nc2 = pshape[1]
    row = {"third_path": f"P1 mesh {n} x {n} cells", "dofs": nv,
           "triplets": int(rows.size), "data_s": time.perf_counter() - t0}
    # -- assembly of A and P (B1, B2, B3) and the oracle
    vals_d = torch.from_numpy(vals).to(dev)
    rows_d, cols_d = torch.from_numpy(rows).to(dev), \
        torch.from_numpy(cols).to(dev)
    pat = plan(rows_d, cols_d, (nv, nv))
    A = pat.assemble(vals_d)
    k = npass(nv, nv, rows.size)
    expect(B1=k, B2=k, B3=1, P34=1)
    prA, irA, jcA = matlab_sparse_oracle(rows, cols, vals.astype(np.float64),
                                         nv, nv)
    nnz = int(A.nnz)
    require(nnz == prA.size
            and np.array_equal(A.indptr.cpu().numpy(), jcA)
            and np.array_equal(A.indices[:nnz].cpu().numpy(), irA)
            and np.array_equal(A.data[:nnz].cpu().numpy(),
                               prA.astype(np.float32)),
            "FEM matrix differs from the oracle")
    row.update(nnz=nnz, max_per_row=int(np.bincount(irA).max()))
    patP = plan(torch.from_numpy(pr_).to(dev), torch.from_numpy(pc_).to(dev),
                pshape)
    P = patP.assemble(torch.from_numpy(pv_).to(dev))
    k = npass(*pshape, pr_.size)
    expect(B1=k, B2=k, B3=1, P34=1)
    # -- the four SpMVs, each against the CSC result
    x = torch.from_numpy(rng.standard_normal(nv).astype(np.float32)).to(dev)
    y_csc = ops.matmul(A, x)
    absA = CSC(data=A.data.abs(), indices=A.indices, indptr=A.indptr,
               nnz=A.nnz, shape=A.shape)
    tol = 8 * EPS32 * ops.matmul(absA, x.abs())
    ell_cols, ell_vals, overflow = kernels.csc_to_ell(A,
                                                      max_per_row=FEM_K)
    require(not bool(overflow), f"ELL overflow at max_per_row={FEM_K}")
    S = convert(A, "symcsc")
    Bm = convert(A, "bsr", block=2)
    ys = {"ell": kernels.spmv(ell_cols, ell_vals, x),
          "symcsc": ops.matmul(S, x), "bsr": ops.matmul(Bm, x)}
    expect(B8=1, B9=1, B10=1)
    for name, y in ys.items():
        err = (y - y_csc).abs()
        require(bool(torch.all(err <= tol)),
                f"{name} SpMV differs from CSC by more than 8 eps sum|a x|")
        row[f"spmv_{name}_max_err_over_tol"] = float(
            (err / tol.clamp(min=1e-30)).max())
    # -- CG on the B8 and the B9 operator (fem_poisson's error bound)
    b = torch.from_numpy(f).to(dev)
    bound = 10.0 / n ** 2 + 5e-2
    ops_cg = {"ell": lambda v: kernels.spmv(ell_cols, ell_vals, v),
              "symcsc": lambda v: ops.matmul(S, v)}
    for name, op in ops_cg.items():
        u, res = cg(op, b, iters)
        expect(**{"B8" if name == "ell" else "B9": iters + 1})
        err = float(np.abs(u.cpu().numpy() - u_exact).max())
        require(np.isfinite(err) and err < bound,
                f"CG on {name}: max |u - u_exact| = {err} >= {bound}")
        row[f"cg_{name}"] = {"iters": iters, "residual": float(res),
                             "max_err": err, "bound": bound}
    # -- and on a seeded random right-hand side, against float64 CG
    Asp = sp.csc_matrix((prA, irA, jcA), shape=(nv, nv))
    b_rand = rng.standard_normal(nv).astype(np.float32)
    row["cg_random_relres"] = cg_random_check(ops_cg, Asp, b_rand, iters,
                                              dev)
    expect(B8=iters + 1, B9=iters + 1)
    # -- Galerkin product P' A P: two cached product plans, B6 refills
    product_cache_clear()
    Ac = ops.matmul(ops.matmul(ops.transpose(P), A), P)
    Ptc = convert(ops.transpose(P), "csc")
    pp1 = cached_product_plan(Ptc, A)
    PtA = pp1.multiply(Ptc.data, A.data)
    pp2 = cached_product_plan(PtA, P)
    expect(B1=npass(nc2, nv, pp1.flops) + npass(nc2, nc2, pp2.flops),
           B2=npass(nc2, nv, pp1.flops) + npass(nc2, nc2, pp2.flops),
           B6=3, P34=2)
    info = product_cache_info()
    require((info["misses"], info["hits"]) == (2, 2),
            f"product cache {info} after the Galerkin product")
    # structure: a numpy expansion of the same products through the oracle
    prP, irP, jcP = matlab_sparse_oracle(pr_, pc_, pv_.astype(np.float64),
                                         *pshape)
    _, irT, jcT = matlab_sparse_oracle(pc_, pr_, pv_.astype(np.float64),
                                       nc2, nv)
    irPA, jcPA = product_structure(irT, jcT, irA, jcA, nc2, nv)
    irC, jcC = product_structure(irPA, jcPA, irP, jcP, nc2, nc2)
    for C, ir, jc, what in ((PtA, irPA, jcPA, "P' A"), (Ac, irC, jcC,
                                                        "P' A P")):
        nz = int(C.nnz)
        require(nz == ir.size and C.nzmax == nz
                and np.array_equal(C.indptr.cpu().numpy(), jc)
                and np.array_equal(C.indices.cpu().numpy(), ir),
                f"{what} structure differs from the numpy expansion")
    # values: scipy's float64 products, slot by slot
    Psp = sp.csc_matrix((prP, irP, jcP), shape=pshape)
    ref = Psp.T @ Asp @ Psp
    mag = abs(Psp).T @ abs(Asp) @ abs(Psp)
    got = Ac.data.double().cpu().numpy()
    want, wmag = values_at(ref, irC, jcC), values_at(mag, irC, jcC)
    verr = np.abs(got - want)
    require(np.all(verr <= 8 * EPS32 * wmag),
            "P' A P differs from scipy by more than 8 eps (|P'| |A| |P|)")
    row.update(nnz_PtA=int(PtA.nnz), nnz_Ac=int(Ac.nnz), flops_PtA=pp1.flops,
               flops_Ac=pp2.flops, galerkin_max_abs_err=float(verr.max()),
               galerkin_scipy_zero_slots=int(np.sum(
                   values_at(ref, irC, jcC) == 0)))
    # refill for a second coefficient: B6 and one fill, no plan kernel
    before = counts()
    A2 = pat.assemble(2 * vals_d)
    Ac2 = ops.matmul(ops.matmul(ops.transpose(P), A2), P)
    expect(B3=1, B6=2)
    after = counts()
    refill = {k: after[k] - before[k] for k in after}
    require(torch.equal(Ac2.data, 2 * Ac.data) and product_cache_info()[
        "misses"] == 2, "the refill for 2 A differs from 2 (P' A P)")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got_counts = {k: counts()[k] - start[k] for k in start}
    row["run_s"] = time.perf_counter() - t0
    row["refill_launches"] = refill
    ctx = dict(A=A, pat=pat, rows_d=rows_d, cols_d=cols_d, vals_d=vals_d,
               x=x, b=torch.from_numpy(b_rand).to(dev), ell=(ell_cols,
               ell_vals), S=S, Bm=Bm, P=P, Ptc=Ptc, PtA=PtA, pp1=pp1,
               pp2=pp2, ops_cg=ops_cg, nv=nv, nc2=nc2, hostA=(irA, jcA),
               hostPt=(irT, jcT), host=(rows, cols, vals))
    return row, got_counts, exp, ctx


def fem_kernel_checks(fem, rng, dev):
    """Phase 3 for the third path's kernels, on the streams phase 4c gave
    them: B6, B8, B9 and B10 against their plain versions, bit for bit on
    integer-valued data and within stated tolerances on random float32
    data; B6 also with a NaN.  Returns each kernel's largest float32
    error against its plain version."""
    from repro_torch.core.csc import slot_columns
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import gather2_segment_sum_ref
    from repro_torch.kernels.spmv import spmv as ell_mod
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import bsr_tiles_ref, sym_streams_ref

    def ints(n):
        return torch.from_numpy(rng.integers(-8, 9, n).astype(np.float32)) \
            .to(dev)

    def floats(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)) \
            .to(dev)

    def within(got, want, mag, c, what):
        # c terms per output: any two summation orders differ by at most
        # c * eps * sum|terms| (each is within (c - 1) eps / 2 of exact)
        err = (got - want).abs()
        tol = c * EPS32 * mag
        require(bool(torch.all(err <= tol)),
                f"{what}: error above {c} eps x sum|terms|")
        return float(err.max())

    errs = dict.fromkeys(("B6", "B8", "B9", "B10"), 0.0)
    # B6 on both products of the Galerkin operator
    for what, pp, a, b in (("P' A", fem["pp1"], fem["Ptc"], fem["A"]),
                           ("P' A P", fem["pp2"], fem["PtA"], fem["P"])):
        st = (pp.sa, pp.sb, pp.pattern.slot)
        nz = dict(num_segments=pp.nzmax)
        va, vb = ints(a.nzmax), ints(b.nzmax)
        require(torch.equal(ss_mod.gather2_segment_sum(va, vb, *st, **nz),
                            gather2_segment_sum_ref(va, vb, *st, **nz)),
                f"B6 differs on integer-valued data, {what}")
        va, vb = floats(a.nzmax), floats(b.nzmax)
        run = int(torch.bincount(pp.pattern.slot.long()).max())
        errs["B6"] = max(errs["B6"], within(
            ss_mod.gather2_segment_sum(va, vb, *st, **nz),
            gather2_segment_sum_ref(va, vb, *st, **nz),
            gather2_segment_sum_ref(va.abs(), vb.abs(), *st, **nz), run,
            f"B6 float32, {what}"))
        # a NaN among integer-valued data: the rest is exact, bit for bit
        va, vb = ints(a.nzmax), ints(b.nzmax)
        va[int(pp.sa[0])] = float("nan")
        got = ss_mod.gather2_segment_sum(va, vb, *st, **nz)
        require(bool(torch.isnan(got).any()) and same_bits(
            got, gather2_segment_sum_ref(va, vb, *st, **nz)),
            f"B6 differs with a NaN, {what}")
    # B8 on the ELL arrays of A
    cols, vals = fem["ell"]
    nv = fem["nv"]
    xi, x = ints(nv), fem["x"]
    require(torch.equal(ell_mod.spmv_ell(cols, vals, xi),
                        spmv_ell_ref(cols, vals, xi)),
            "B8 differs on integer-valued data")
    errs["B8"] = within(ell_mod.spmv_ell(cols, vals, x),
                        spmv_ell_ref(cols, vals, x),
                        spmv_ell_ref(cols, vals.abs(), x.abs()), FEM_K,
                        "B8 float32")
    # B9 on SymCSC's strict-upper stream
    S = fem["S"]
    st = (S.indices, S.data, S.indptr)
    for got, want in zip(sym_mod.sym_streams(*st, xi),
                         sym_streams_ref(*st, xi)):
        require(torch.equal(got, want), "B9 differs on integer-valued data")
    (up, ct), (up0, ct0) = sym_mod.sym_streams(*st, x), sym_streams_ref(*st, x)
    require(torch.equal(up, up0), "B9's up stream differs (one product)")
    _, mag = sym_streams_ref(S.indices, S.data.abs(), S.indptr, x.abs())
    errs["B9"] = within(ct, ct0, mag, int(torch.diff(S.indptr).max()),
                        "B9 column totals, float32")
    # the same in the shape the path takes on it (SymCSC.longest: one
    # thread a column); the lines above run the tiles
    lw = dict(longest=S.longest)
    for got, want in zip(sym_mod.sym_streams(*st, xi, **lw),
                         sym_streams_ref(*st, xi)):
        require(torch.equal(got, want), "B9 differs on integer-valued data "
                "(one thread a column)")
    up, ct = sym_mod.sym_streams(*st, x, **lw)
    require(torch.equal(up, up0), "B9's up stream differs (one thread a "
            "column)")
    errs["B9"] = max(errs["B9"], within(
        ct, ct0, mag, S.longest, "B9 column totals, float32, one thread a "
        "column"))
    # B10 on the 2 x 2 BSR blocks
    Bm = fem["Bm"]
    bcols = slot_columns(Bm.indptr, Bm.nbmax).clamp(0, Bm.Nb - 1)
    st = (Bm.indices, bcols, Bm.data)
    kw = dict(Mb=Bm.Mb)
    require(torch.equal(sym_mod.bsr_tiles(*st, xi, **kw),
                        bsr_tiles_ref(*st, xi, **kw)),
            "B10 differs on integer-valued data")
    errs["B10"] = within(
        sym_mod.bsr_tiles(*st, x, **kw), bsr_tiles_ref(*st, x, **kw),
        bsr_tiles_ref(Bm.indices, bcols, Bm.data.abs(), x.abs(), **kw),
        Bm.block, "B10 float32")
    torch.cuda.synchronize()
    return errs


def product_run_checks(dev, rng) -> dict:
    """Phase 3d: B6 on streams that cross its tiles (``product_stream``:
    one run of 2^20 products, runs of random length 1..10^4, a run that
    starts at a tile's last position, a tile of only dropped slots; and
    ``B' B`` of the arrow matrix, whose dense column gives one run of
    2^20, where its host expansion stays under ``ARROW_GRAM_MAX_FLOPS``),
    float32 and float64: bit for bit against the plain version on
    integer-valued data, with and without a NaN; bit for bit from call to
    call on random data and there within ``C_SEG`` eps of each slot's
    sum|terms| of the exact sum of its rounded products; one launch a
    call.  Each variant of the probe bit for bit on integer-valued data
    on the random stream.  Returns the largest error over eps sum|terms|
    per stream and dtype."""
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import (PRODUCT_TILE,
                                                     gather2_segment_sum_ref)

    kern = ss_mod.gather2_segment_sum
    streams = {}
    for kind in PRODUCT_KINDS:
        sa, sb, slot = product_stream(kind, PRODUCT_TILE, rng,
                                      operands=1 << 20)
        n = int(slot[(slot >= 0) & (slot < 2**30)].max()) + 1
        streams[kind] = ((1 << 20, 1 << 20), *(torch.from_numpy(x).to(dev)
                                               for x in (sa, sb, slot)), n)
    flops = arrow_gram_flops()
    if flops <= ARROW_GRAM_MAX_FLOPS:
        pp, Bt, B = arrow_gram(dev, rng)
        streams["arrow_gram"] = ((Bt.nzmax, B.nzmax), pp.sa, pp.sb,
                                 pp.pattern.slot, pp.nzmax)
    out = {"arrow_gram_flops": flops}
    for name, ((na, nb), sa, sb, slot, n) in streams.items():
        st, nz = (sa, sb, slot), dict(num_segments=n)
        row = {"L": int(slot.numel()), "num_segments": n,
               "longest_run": int(torch.bincount(
                   slot[(slot >= 0) & (slot < n)].long()).max())}
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            def draw(k, ints):
                x = rng.integers(-8, 9, k) if ints else \
                    rng.standard_normal(k)
                return torch.from_numpy(x).to(dev, dtype)

            va, vb = draw(na, True), draw(nb, True)
            before = kern.launches
            got = kern(va, vb, *st, **nz)
            require(kern.launches == before + 1, "B6: not one launch a call")
            require(torch.equal(got, gather2_segment_sum_ref(va, vb, *st,
                                                             **nz)),
                    f"B6 {dtype} differs on integer-valued data, {name}")
            kept = torch.nonzero((slot >= 0) & (slot < n)).flatten()
            va[int(sa[kept[kept.numel() // 2]])] = float("nan")
            got = kern(va, vb, *st, **nz)
            require(bool(torch.isnan(got).any()) and same_bits(
                got, gather2_segment_sum_ref(va, vb, *st, **nz)),
                f"B6 {dtype} differs with a NaN, {name}")
            va, vb = draw(na, False), draw(nb, False)
            got = kern(va, vb, *st, **nz)
            require(torch.equal(kern(va, vb, *st, **nz), got),
                    f"B6 {dtype} differs from call to call, {name}")
            r = product_err_over_eps(got, va, vb, sa, sb, slot, eps)
            require(r <= C_SEG, f"B6 {dtype} error {r} eps x sum|terms| > "
                    f"{C_SEG}, {name}")
            row[f"{dtype}_max_err_over_eps_sum_abs"] = r
        out[name] = row
    # the probe's variants, bit for bit on integer-valued data
    (na, nb), sa, sb, slot, n = streams["random"]
    va, vb = (torch.from_numpy(rng.integers(-8, 9, k).astype(np.float32))
              .to(dev) for k in (na, nb))
    want = gather2_segment_sum_ref(va, vb, sa, sb, slot, num_segments=n)
    for v, i in PRODUCT_VARIANTS.items():
        require(torch.equal(product_probe(i, va, vb, sa, sb, slot, n), want),
                f"B6 probe variant {v} differs on integer-valued data")
    torch.cuda.synchronize()
    return out


def fem_times(fem, cpm, dev):
    """Phase 5 for the third path: each kernel (device time back to back,
    one call, its plain version, a PyTorch yardstick, the byte bound) and
    the path's own times.  Returns (kernel rows, path times)."""
    from repro_torch import kernels
    from repro_torch.core.csc import slot_columns
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import gather2_segment_sum_ref
    from repro_torch.kernels.spmv import spmv as ell_mod
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import bsr_tiles_ref, sym_streams_ref
    from repro_torch.sparse import convert, ops, plan, spgemm

    A, S, Bm, x, nv = fem["A"], fem["S"], fem["Bm"], fem["x"], fem["nv"]
    cols, vals = fem["ell"]
    t = {"times": "third path", "dofs": nv}
    # cuSPARSE yardsticks: A as a torch CSR tensor, and as torch BSR
    Acsr = convert(A, "csr")
    nnz = int(A.nnz)
    A_t = torch.sparse_csr_tensor(Acsr.indptr, Acsr.indices[:nnz],
                                  Acsr.data[:nnz], A.shape)
    nb = int(Bm.nnz)
    brow = Bm.indices[:nb].long()
    bcol = slot_columns(Bm.indptr, Bm.nbmax)[:nb].long()
    order = torch.argsort(brow * Bm.Nb + bcol)
    crow = torch.cat([brow.new_zeros(1), torch.cumsum(
        torch.bincount(brow, minlength=Bm.Mb), 0)])
    B_t = torch.sparse_bsr_tensor(crow, bcol[order], Bm.data[:nb][order],
                                  Bm.shape)
    try:  # a yardstick only: PyTorch may lack a BSR product on CUDA
        torch.mv(B_t, x)
        bsr_lib = lambda: torch.mv(B_t, x)  # noqa: E731
    except (RuntimeError, NotImplementedError) as e:
        print(f"times: no PyTorch BSR product on CUDA ({e})", flush=True)
        bsr_lib = None
    # the kernels' inputs at this path's shapes
    pp, Ptc = fem["pp1"], fem["Ptc"]
    st = (pp.sa, pp.sb, pp.pattern.slot)
    nz = dict(num_segments=pp.nzmax)
    slot_l = pp.pattern.slot.long()
    sym_in = (S.indices, S.data, S.indptr, x)
    bcols = slot_columns(Bm.indptr, Bm.nbmax).clamp(0, Bm.Nb - 1)
    bsr_in = (Bm.indices, bcols, Bm.data, x)
    F, M, K, nzh, b = pp.flops, nv, FEM_K, S.nzmax, Bm.block
    # B6 gathers operand values, so it reads those the streams reach (A's
    # padded tail is never read), not whole operand vectors; on both
    # products of the Galerkin operator (B6_Ac: (P' A) P)
    pp2, PtA, P = fem["pp2"], fem["PtA"], fem["P"]
    st2 = (pp2.sa, pp2.sb, pp2.pattern.slot)
    nz2 = dict(num_segments=pp2.nzmax)
    slot2_l = pp2.pattern.slot.long()

    def b6_bytes(q):
        reached = [int(torch.unique(i).numel()) for i in (q.sa, q.sb)]
        return 12 * q.flops + 4 * sum(reached) + 4 * q.nzmax

    fns = {
        "B6": (lambda: ss_mod.gather2_segment_sum(Ptc.data, A.data, *st, **nz),
               lambda: gather2_segment_sum_ref(Ptc.data, A.data, *st, **nz),
               lambda: torch.zeros(pp.nzmax, device=dev).index_add_(
                   0, slot_l, Ptc.data[pp.sa] * A.data[pp.sb]),
               b6_bytes(pp), 2 * F),
        "B6_Ac": (lambda: ss_mod.gather2_segment_sum(PtA.data, P.data, *st2,
                                                     **nz2),
                  lambda: gather2_segment_sum_ref(PtA.data, P.data, *st2,
                                                  **nz2),
                  lambda: torch.zeros(pp2.nzmax, device=dev).index_add_(
                      0, slot2_l, PtA.data[pp2.sa] * P.data[pp2.sb]),
                  b6_bytes(pp2), 2 * pp2.flops),
        "B8": (lambda: ell_mod.spmv_ell(cols, vals, x),
               lambda: spmv_ell_ref(cols, vals, x),
               lambda: torch.mv(A_t, x), 8 * M * K + 4 * nv + 4 * M,
               2 * M * K),
        "B9": (lambda: sym_mod.sym_streams(*sym_in, longest=S.longest),
               lambda: sym_streams_ref(*sym_in),
               lambda: torch.mv(A_t, x), 12 * nzh + 12 * M + 4, 3 * nzh),
        "B10": (lambda: sym_mod.bsr_tiles(*bsr_in, Mb=Bm.Mb),
                lambda: bsr_tiles_ref(*bsr_in, Mb=Bm.Mb), bsr_lib,
                4 * b * b * Bm.nbmax + 8 * Bm.nbmax + 4 * Bm.N
                + 4 * b * Bm.nbmax, 2 * b * b * Bm.nbmax),
    }
    rows_k = {}
    for k, (kern, plain, lib, nbytes, nops) in fns.items():
        r = {"ms": device_ms(kern, cpm), "call_ms": call_ms(kern),
             "plain_ms": device_ms(plain, cpm),
             "library_ms": None if lib is None else device_ms(lib, cpm),
             "bytes": nbytes, "ops": nops}
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, nops)
        r["GBps"] = nbytes / r["ms"] / 1e6
        r["share_of_3.35TBps"] = r["GBps"] / (HBM_BYTES_PER_S / 1e9)
        rows_k[k] = r
    # B6 beside the design it replaced, its two-gather floor (its loads and
    # products, no reduction) and the probe's tile depths and register
    # bounds (the sweep), on both products
    for k, (a, bm, q) in (("B6", (Ptc, A, pp)), ("B6_Ac", (PtA, P, pp2))):
        args = (a.data, bm.data, q.sa, q.sb, q.pattern.slot)
        r = rows_k[k]
        r["flops"], r["nzmax"] = q.flops, q.nzmax
        r["gather2_floor_ms"] = device_ms(
            lambda: gather2_floor(*args, q.nzmax), cpm)
        r["sweep_ms"] = {v: device_ms(
            lambda i=i: product_probe(i, *args, q.nzmax), cpm)
            for v, i in PRODUCT_VARIANTS.items()}
        r["replaced_ms"] = r["sweep_ms"].pop("replaced")
        r["sweep_winner"] = min(r["sweep_ms"], key=r["sweep_ms"].get)
    t["kernels"] = rows_k
    # the path: plan and fill of A, each SpMV, one CG iteration
    pat, vals_d = fem["pat"], fem["vals_d"]
    spmvs = {"plan_A": lambda: plan(fem["rows_d"], fem["cols_d"], A.shape),
             "fill_A": lambda: pat.assemble(vals_d),
             "spmv_csc": lambda: ops.matmul(A, x),
             "spmv_ell": lambda: kernels.spmv(cols, vals, x),
             "spmv_symcsc": lambda: ops.matmul(S, x),
             "spmv_bsr": lambda: ops.matmul(Bm, x)}
    for what, fn in spmvs.items():
        t[f"{what}_ms"] = call_ms(fn)
        t[f"{what}_device_ms"] = device_ms(fn, cpm)
        t[f"{what}_device_idle_share"] = \
            1.0 - t[f"{what}_device_ms"] / t[f"{what}_ms"]
    # where an operator's device time goes: the top kernels of one call
    for what in ("spmv_csc", "spmv_symcsc", "spmv_bsr"):
        t[f"{what}_top_kernels"] = top_kernels(spmvs[what])
    for name, op in fem["ops_cg"].items():
        t[f"cg_iteration_{name}_ms"] = call_ms(
            lambda: cg(op, fem["b"], 10), reps=5) / 10
    # product_plan: the host expansion and the device plan, both products
    for what, (a, bm, pq) in (("PtA", (Ptc, A, pp)),
                              ("Ac", (PtA, P, fem["pp2"]))):
        ir_a, jc_a, _, _ = spgemm._csc_structure(a)
        ir_b, jc_b, nnz_b, _ = spgemm._csc_structure(bm)
        t[f"product_plan_{what}_ms"] = host_ms(
            lambda: spgemm.product_plan(a, bm), 3)
        t[f"product_plan_{what}_host_expand_ms"] = host_ms(
            lambda: spgemm._expand(ir_a, jc_a, ir_b, jc_b, nnz_b, a.M, None),
            3)
        rc, cc = (torch.from_numpy(v).to(dev) for v in spgemm._expand(
            ir_a, jc_a, ir_b, jc_b, nnz_b, a.M, None)[:2])
        t[f"product_plan_{what}_device_plan_ms"] = device_ms(
            lambda: plan(rc, cc, pq.shape, nzmax=pq.flops), cpm, reps=5)
        t[f"refill_{what}_ms"] = call_ms(lambda: pq.multiply(a.data, bm.data))
        t[f"refill_{what}_device_ms"] = device_ms(
            lambda: pq.multiply(a.data, bm.data), cpm)
    t["galerkin_refill_ms"] = host_ms(
        lambda: ops.matmul(ops.matmul(ops.transpose(P), A), P), 5)
    return rows_k, t


def complex_checks(dev, sets, rng, n: int = 199):
    """Complex values on the card, which the float kernels take one real
    part at a time (``kernels.common.split_complex``), against the CPU's
    plain versions on the complex values: the fills of Table 4.1's set 1
    (sum and mean through B3', ``fill_pallas`` through B5), and on the
    FEM matrix of an ``n`` x ``n``-cell mesh the ELL, SymCSC and BSR
    SpMVs (B8, B9, B10) and the refill of ``P' A`` (B6).  Each part
    within the kernel's own ``c eps sum|terms|`` (a part of a complex
    product has twice the terms).  Returns the largest error over its
    tolerance, per result."""
    from repro_torch import kernels
    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.kernels.assembly_ops import fill_pallas
    from repro_torch.sparse import convert, ops, plan, product_plan
    from repro_torch.sparse.pattern import plan_coo

    def cplx(k):
        return (rng.standard_normal(k) + 1j * rng.standard_normal(k)) \
            .astype(np.complex64)

    ii, jj, ss, siz = sets["1"]
    v = cplx(ii.shape[0])
    rows_h, cols_h, vals_h, nv, _, _ = fem_system(n)
    pr_, pc_, pv_, pshape = bilinear_prolongation(n)
    w = complex(*rng.standard_normal(2))  # keeps A symmetric
    x = cplx(nv)

    def run(d):
        coo = coo_from_matlab(ii, jj, ss, (siz, siz), device=d)
        pat = plan_coo(coo)
        vd = torch.from_numpy(v).to(d)
        out = {"sum": pat.assemble(vd).data,
               "mean": plan_coo(coo, accum="mean").assemble(vd).data,
               "fill_pallas": fill_pallas(pat, vd).data}
        mag = pat.assemble(vd.abs()).data
        mags = {"sum": 8 * mag,
                "mean": 8 * plan_coo(coo, accum="mean").assemble(
                    vd.abs()).data,
                "fill_pallas": 2 * C_SCAN * torch.cumsum(mag.double(), 0)}
        A = plan(torch.from_numpy(rows_h).to(d),
                 torch.from_numpy(cols_h).to(d), (nv, nv)).assemble(
            torch.from_numpy(vals_h).to(d) * w)
        P = plan(torch.from_numpy(pr_).to(d), torch.from_numpy(pc_).to(d),
                 pshape).assemble(torch.from_numpy(pv_).to(d))
        Pt = convert(ops.transpose(P), "csc")
        xd = torch.from_numpy(x).to(d)
        ell_cols, ell_vals, _ = kernels.csc_to_ell(A, max_per_row=FEM_K)
        out.update(ell=kernels.spmv(ell_cols, ell_vals, xd),
                   symcsc=ops.matmul(convert(A, "symcsc"), xd),
                   bsr=ops.matmul(convert(A, "bsr", block=2), xd))
        spmv_mag = 2 * 8 * kernels.spmv(ell_cols, ell_vals.abs(), xd.abs())
        mags.update(ell=spmv_mag, symcsc=spmv_mag, bsr=spmv_mag)
        pp = product_plan(Pt, A)
        out["product"] = pp.multiply(Pt.data, A.data).data
        mags["product"] = 2 * 8 * pp.multiply(Pt.data.abs(),
                                              A.data.abs()).data
        return ({k: t.cpu() for k, t in out.items()},
                {k: t.cpu() for k, t in mags.items()})

    got, mags = run(dev)
    want, _ = run("cpu")
    ratios = {}
    for k, g in got.items():
        require(g.dtype == want[k].dtype == torch.complex64,
                f"complex {k}: dtype {g.dtype}")
        tol = EPS32 * mags[k].double() + 1e-30
        ratios[k] = max(float(((part(g) - part(want[k])).abs().double()
                               / tol).max())
                        for part in (torch.real, torch.imag))
        require(ratios[k] <= 1.0, f"complex {k} on the card differs from "
                f"the CPU path by {ratios[k]} x its tolerance")
    return ratios


# -- the fourth path: dynamic patterns and symmetric planning --------------
def edge_flip(n: int, rng):
    """The edge flip of phase 4d on ``fem_system(n)``'s stream.

    ``FLIP_FRAC`` of the n x n cells, drawn with ``rng`` among the cells
    with ``1 <= ix, iy <= n - 2`` (so none of their vertices is a
    Dirichlet row), turn their diagonal: the 18 triplets of their two
    triangles are dropped and the 18 of ``(v00, v10, v11)`` and ``(v00,
    v01, v11)`` appended (``K_FLIP``; values stay dyadic).  Returns the
    drop mask over the stream's order and the new zero-offset triplets
    (int32 rows, int32 cols, float32 vals)."""
    k = round(FLIP_FRAC * n * n)
    m = n - 2
    pick = rng.choice(m * m, k, replace=False)
    ix, iy = pick // m + 1, pick % m + 1
    # the cells' raw positions in p1_triplets' order ([ix, iy, 2, 3, 3])
    raw = ((ix * n + iy)[:, None] * 18 + np.arange(18)).ravel()
    rows, cols, _, nv = p1_triplets(n)
    vx, vy = np.arange(nv) % (n + 1), np.arange(nv) // (n + 1)
    boundary = (vx == 0) | (vx == n) | (vy == 0) | (vy == n)
    keep = ~(boundary[rows] | boundary[cols])   # fem_system's filter
    require(bool(np.all(keep[raw])), "a flipped cell touches the boundary")
    L = int(keep.sum()) + int(boundary.sum())   # + the identity rows
    drop = np.zeros(L, bool)
    drop[(np.cumsum(keep) - 1)[raw]] = True
    v = lambda x, y: (y * (n + 1) + x).astype(np.int32)  # noqa: E731
    v00, v10, v01, v11 = v(ix, iy), v(ix + 1, iy), v(ix, iy + 1), \
        v(ix + 1, iy + 1)
    tri = np.stack([np.stack([v00, v10, v11], -1),
                    np.stack([v00, v01, v11], -1)], 1)       # [k, 2, 3]
    full = (k, 2, 3, 3)
    return drop, (np.broadcast_to(tri[..., :, None], full).ravel(),
                  np.broadcast_to(tri[..., None, :], full).ravel(),
                  np.broadcast_to(K_FLIP, full).ravel().astype(np.float32))


def ladder_reach(qr, qc, tr, tc, side: str) -> int:
    """The number of distinct targets the merge search's ladder compares
    against for these queries: the targets it must read (B7's bound)."""
    from repro_torch.kernels.merge.ref import _below, search_steps

    n = tr.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=tr.device)
    lo = torch.zeros_like(qr)
    hi = torch.full_like(qr, n)
    for _ in range(search_steps(n)):
        active = lo < hi
        mid = torch.clamp((lo + hi) // 2, max=n - 1).long()
        seen[mid[active]] = True
        below = _below(tc[mid], tr[mid], qc, qr, inclusive=side == "right")
        lo = torch.where(active & below, mid.int() + 1, lo)
        hi = torch.where(active & ~below, mid.int(), hi)
    return int(seen.sum())


def update_path(dev, sets, fem, counts, rng):
    """Phase 4d, the fourth path: ``SparsePattern.update`` on appended
    deltas of the main path's sets, the FEM edge flip through
    ``sparse2_update``, and symmetric and block planning of the FEM
    matrix.  ``counts()`` reads the launch counters.  Returns the check
    rows, the launches of the phase, the launches it expects, and the
    streams the B7 checks and the timing phase need."""
    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.core.coo import host_triplets
    from repro_torch.sparse import (detect_block, fsparse, pattern_symmetric,
                                    plan, plan_cache_clear, plan_cache_info,
                                    plan_lookup, sparse2, sparse2_update)

    fields = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")

    def npass(M, N, L):
        return len(plan_digit_passes(M, N, L))

    start = counts()
    exp = dict.fromkeys(start, 0)

    def expect(**kw):
        for k, v in kw.items():
            exp[k] += v

    def launched(fn):
        """``fn()`` and the launches it made, by kernel."""
        before = counts()
        out = fn()
        after = counts()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    rows_out, ctx = [], {}
    # -- 1. appended deltas on the main path's sets -------------------------
    for name, (ii, jj, ss, siz) in sets.items():
        t0 = time.perf_counter()
        r_h, c_h, _, _ = host_triplets(ii, jj, ss, (siz, siz))
        r, c = torch.from_numpy(r_h).to(dev), torch.from_numpy(c_h).to(dev)
        del r_h, c_h
        L = r.shape[0]
        full = plan(r, c, (siz, siz))  # phase 4's radix plan of the set
        expect(B1=npass(siz, siz, L), B2=npass(siz, siz, L), P34=1)
        row = {"fourth_path": f"update, set {name}", "L": L}
        for frac in UPDATE_FRACS:
            Ld = round(frac * L)
            Lb = L - Ld
            base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
            expect(B1=npass(siz, siz, Lb), B2=npass(siz, siz, Lb), P34=1)
            got, made = launched(lambda: base.update(r[Lb:], c[Lb:]))
            k = npass(siz, siz, Ld)
            require(made == {"B1": k, "B2": k, "B7": 1, "P34": 1},
                    f"update of set {name} at {frac} launched {made}, "
                    f"expected {k} B1, {k} B2, one B7 and one P34")
            expect(B1=k, B2=k, B7=1, P34=1)
            for f in fields:
                require(torch.equal(getattr(got, f), getattr(full, f)),
                        f"update of set {name} at {frac}: {f} differs from "
                        "the plan of the whole set")
            require(got.epoch == 1 and got.nzmax == L,
                    f"update of set {name}: epoch {got.epoch}, nzmax "
                    f"{got.nzmax}")
            same, made = launched(lambda: base.update(r[:0], c[:0]))
            require(same is base and not made, f"an empty update of set "
                    f"{name} launched {made} or made a new plan")
            row[f"Ld_{frac}"] = Ld
            row[f"delta_passes_{frac}"] = k
            if name == "2x20":
                ctx[f"update_{frac}"] = (base.srows, base.scols, r[Lb:],
                                         c[Lb:], siz)
            del base, got
        row["update"] = "bit-identical to the plan of the whole set"
        row["run_s"] = time.perf_counter() - t0
        rows_out.append(row)
        del r, c, full
        torch.cuda.empty_cache()
    # -- 2. the FEM edge flip through sparse2_update -------------------------
    t0 = time.perf_counter()
    rows_f, cols_f, vals_f = fem["host"]
    nv, A = fem["nv"], fem["A"]
    drop, (ar, ac, av) = edge_flip(FEM_N, rng)
    Lf, Ld = rows_f.size, ar.size
    keep = ~drop
    ci = np.concatenate([rows_f[keep], ar])
    cj = np.concatenate([cols_f[keep], ac])
    cv = np.concatenate([vals_f[keep], av])
    plan_cache_clear()
    t1 = time.perf_counter()
    F, made = launched(lambda: sparse2_update(
        rows_f + 1, cols_f + 1, vals_f, ar + 1, ac + 1, av, (nv, nv),
        drop_mask=drop))
    torch.cuda.synchronize()
    flip_s = time.perf_counter() - t1
    kb, kd = npass(nv, nv, Lf), npass(nv, nv, Ld)
    require(made == {"B1": kb + kd, "B2": kb + kd, "B3": 1, "B7": 1,
                     "P34": 2},
            f"sparse2_update of the edge flip launched {made}")
    expect(B1=kb + kd, B2=kb + kd, B3=1, B7=1, P34=2)
    G = fsparse(ci + 1, cj + 1, cv, (nv, nv), nzmax=F.nzmax)
    expect(B1=npass(nv, nv, ci.size), B2=npass(nv, nv, ci.size), B3=1,
           P34=1)
    for f in ("data", "indices", "indptr", "nnz"):
        require(torch.equal(getattr(F, f), getattr(G, f)),
                f"edge flip: sparse2_update's {f} differs from fsparse")
    prF, irF, jcF = matlab_sparse_oracle(ci, cj, cv.astype(np.float64),
                                         nv, nv)
    nz = int(F.nnz)
    require(nz == prF.size and nz == int(A.nnz)
            and np.array_equal(F.indptr.cpu().numpy(), jcF)
            and np.array_equal(F.indices[:nz].cpu().numpy(), irF)
            and np.array_equal(F.data[:nz].cpu().numpy(),
                               prF.astype(np.float32))
            and bool(torch.all(F.indices[nz:] == nv))
            and int(torch.count_nonzero(F.data[nz:])) == 0,
            "edge flip differs from the oracle")
    H, made = launched(lambda: sparse2(ci + 1, cj + 1, cv, (nv, nv),
                                       nzmax=F.nzmax))
    expect(B3=1)
    info = plan_cache_info()
    require(made == {"B3": 1} and info["hits"] == 1
            and torch.equal(H.data, F.data),
            f"sparse2 after the flip launched {made} (cache {info})")
    _, pat_f, _ = plan_lookup(ci + 1, cj + 1, cv, (nv, nv), nzmax=F.nzmax)
    sym_f, made = launched(lambda: pattern_symmetric(pat_f))
    require(sym_f and made == {"B7": 2},
            f"the flipped plan: symmetric {sym_f}, launched {made}")
    expect(B7=2)
    torch.cuda.synchronize()
    rows_out.append({
        "fourth_path": f"edge flip, P1 mesh {FEM_N} x {FEM_N} cells",
        "cells": Ld // 18, "dropped": int(drop.sum()), "added": Ld, "L": Lf,
        "nnz": nz, "sparse2_update_s": flip_s,
        "result": "bit-identical to fsparse and the oracle; sparse2 hit "
                  "runs one fill; pattern symmetric",
        "run_s": time.perf_counter() - t0})
    plan_cache_clear()
    del F, G, H, pat_f, prF, irF, jcF
    # -- 3. symmetric and block planning of the FEM matrix -------------------
    t0 = time.perf_counter()
    pat = fem["pat"]
    sym, made = launched(lambda: pattern_symmetric(pat))
    require(sym and made == {"B7": 2},
            f"pattern_symmetric(A): {sym}, launched {made}")
    expect(B7=2)
    first = pat.first
    sr, sc = pat.srows[first].contiguous(), pat.scols[first].contiguous()
    require(sr.shape[0] == int(A.nnz), "first-flagged stream != nnz(A)")
    ctx["symmetric"] = (sc, sr, sr, sc)  # queries: the mirrored keys
    k = int(np.nonzero(rows_f != cols_f)[0][0])
    one = ~((fem["rows_d"] == int(rows_f[k])) & (fem["cols_d"] ==
                                                  int(cols_f[k])))
    pat_m = plan(fem["rows_d"][one], fem["cols_d"][one], (nv, nv))
    Lm = int(one.sum())
    expect(B1=npass(nv, nv, Lm), B2=npass(nv, nv, Lm), P34=1)
    require(not pattern_symmetric(pat_m),
            "a copy with one mirror removed tests symmetric")
    expect(B7=2)
    del pat_m, one
    Y = fsparse(rows_f + 1, cols_f + 1, vals_f, (nv, nv), format="symcsc")
    Lu = int(np.sum(rows_f < cols_f))
    Ldiag = int(np.sum(rows_f == cols_f))
    expect(B1=npass(nv, nv, Lu), B2=npass(nv, nv, Lu), B3=1, P34=1)
    S = fem["S"]
    nzu = int(S.nnz)
    require(int(Y.nnz) == nzu and torch.equal(Y.diag, S.diag)
            and torch.equal(Y.data[:nzu], S.data)
            and torch.equal(Y.indices[:nzu], S.indices)
            and torch.equal(Y.indptr, S.indptr)
            and bool(torch.all(Y.indices[nzu:] == nv))
            and int(torch.count_nonzero(Y.data[nzu:])) == 0,
            "fsparse(format='symcsc') differs from convert(A, 'symcsc')")
    Bz = fsparse(rows_f + 1, cols_f + 1, vals_f, (nv, nv), format="bsr",
                 block=2)
    expect(B1=npass(nv, nv, Lf), B2=npass(nv, nv, Lf), B3=1, P34=1)
    require(all(torch.equal(getattr(Bz, f), getattr(fem["Bm"], f))
                for f in ("data", "indices", "indptr", "nnz")),
            "fsparse(format='bsr', block=2) differs from convert(A, 'bsr')")
    blk = detect_block(rows_f, cols_f, (nv, nv))
    require(blk == 1, f"detect_block of the P1 stream is {blk}, not 1")
    torch.cuda.synchronize()
    rows_out.append({
        "fourth_path": "symmetric and block planning, FEM matrix",
        "pattern_symmetric": "true on A and the flipped stream, false "
                             "with one mirror removed",
        "B7_Lq_n": int(sr.shape[0]), "symcsc": "equal to convert(A)",
        "symcsc_values_streamed": Lu + Ldiag, "full_values_streamed": Lf,
        "bsr_block2": "equal to convert(A)", "detect_block": blk,
        "run_s": time.perf_counter() - t0})
    del Y, Bz
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got = {k: counts()[k] - start[k] for k in start}
    return rows_out, got, exp, ctx


def merge_kernel_checks(ctx, rng, dev):
    """Phase 3 for B7: the kernel against its plain version, bit for bit,
    on both call sites' streams (the update's sorted delta into the 5e7
    set's survivors at each delta share; the FEM structure's mirrors)
    and both sides, on edge cases (ties, sentinel rows, n = 1, a query
    count that is no multiple of the block) and on ``merge_streams``
    (random queries, ties at the narrowed ranges' edges, queries below
    and above every target, n = 2^k +- 1), each also against
    ``torch.searchsorted`` of the packed keys."""
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import merge_search_ref
    from repro_torch.sparse.dispatch import sorted_permutation

    cases = {}
    for frac in UPDATE_FRACS:
        sr_a, sc_a, ar, ac, siz = ctx[f"update_{frac}"]
        d = sorted_permutation(ar, ac, M=siz, N=siz).long()
        cases[f"update 2x20 {frac}"] = (ar[d], ac[d], sr_a, sc_a, siz)
    qr, qc, tr, tc = ctx["symmetric"]
    cases["symmetric FEM"] = (qr, qc, tr, tc, int(tr.max()) + 1)
    M = 1000

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    tr_e = np.sort(rng.integers(0, M + 1, 5000))   # one column, sentinels
    tc_e = np.zeros(5000, np.int32)
    cases["ties"] = (i32(tr_e[::7]), i32(tc_e[::7]), i32(tr_e), i32(tc_e), M)
    q = rng.integers(0, M + 1, mg.BLOCK_Q * 3 + 5)
    q[::4] = M
    cases["sentinels, ragged Lq"] = (i32(q), i32(np.zeros_like(q)),
                                     i32(tr_e), i32(tc_e), M)
    cases["n = 1"] = (i32([3, 4, 5, 4]), i32([2, 2, 2, 1]), i32([4]),
                      i32([2]), M)
    # the streams that break a search narrowed by blocks of queries
    for kind in MERGE_KINDS:
        qr, qc, tr, tc, Mk = merge_streams(kind, rng, mg.BLOCK_Q)
        cases[kind] = (i32(qr), i32(qc), i32(tr), i32(tc), Mk)
    for name, (qr, qc, tr, tc, Mk) in cases.items():
        key = tc.long() * (Mk + 1) + tr.long()
        qkey = qc.long() * (Mk + 1) + qr.long()
        for side in ("left", "right"):
            got = mg.merge_search_kernel(qr, qc, tr, tc, side=side)
            require(torch.equal(got, merge_search_ref(qr, qc, tr, tc,
                                                      side=side)),
                    f"B7 differs from its plain version, {name}, {side}")
            require(torch.equal(got.long(), torch.searchsorted(
                key, qkey, right=side == "right")),
                f"B7 differs from searchsorted, {name}, {side}")
            for v, k in MERGE_VARIANTS.items():  # what phase 5 times
                require(torch.equal(merge_probe(k, qr, qc, tr, tc, side),
                                    got),
                        f"B7's probe variant {v} differs, {name}, {side}")
    torch.cuda.synchronize()
    return list(cases)


def sym_kernel_checks(fem, rng, dev):
    """Phase 3 for B9 on the streams that break its shapes (``sym_stream``:
    the arrow matrix with a column of 2^20 entries, a column starting at
    a tile's last item, runs of empty columns with sentinel rows and a
    padded tail), both shapes, float32 and float64: ``up`` and ``ct`` bit
    for bit on integer-valued data, ``up`` bit for bit and ``ct`` bit for
    bit from call to call on random data, ``ct`` there within C_SEG eps
    of each column's sum|terms| of the exact sum.  Returns the largest
    error over eps sum|terms| per stream, shape and dtype."""
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import (SYM_TILE, sym_shape,
                                                  sym_streams_ref)

    out = {}
    for kind in ("arrow", "tile_edge", "empty_runs"):
        rows_h, indptr_h, M = sym_stream(kind, SYM_TILE, rng)
        rows = torch.from_numpy(rows_h).to(dev)
        indptr = torch.from_numpy(indptr_h).to(dev)
        nz = rows.numel()
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            def draw(k, ints):
                v = rng.integers(-8, 9, k) if ints else \
                    rng.standard_normal(k)
                return torch.from_numpy(v).to(dev, dtype)

            sti = (rows, draw(nz, True), indptr)
            xi = draw(M, True)
            stf = (rows, draw(nz, False), indptr)
            x = draw(M, False)
            # a longest column of 1 takes one thread a column (these
            # streams hold at most 4 slots a column on average), an unknown
            # one the tiles, whatever the stream
            require(sym_shape(1, M, nz) == "columns",
                    f"{kind} takes the tiles whatever its longest column")
            for shape, hint in (("columns", 1), ("tiles", None)):
                kw = dict(longest=hint)
                for got, want in zip(sym_mod.sym_streams(*sti, xi, **kw),
                                     sym_streams_ref(*sti, xi)):
                    require(torch.equal(got, want), f"B9 ({shape}) differs on "
                            f"integer-valued data, {kind}, {dtype}")
                up, ct = sym_mod.sym_streams(*stf, x, **kw)
                up0, _ = sym_streams_ref(*stf, x)
                require(torch.equal(up, up0),
                        f"B9's up ({shape}) differs, {kind}, {dtype}")
                require(torch.equal(sym_mod.sym_streams(*stf, x, **kw)[1],
                                    ct), f"B9's ct ({shape}) differs from "
                        f"call to call, {kind}, {dtype}")
                r = sym_err_over_eps(ct, *stf, x, eps)
                require(r <= C_SEG, f"B9's ct ({shape}) {dtype} error {r} "
                        f"eps x sum|terms| > {C_SEG}, {kind}")
                out[f"{kind}_{shape}_{dtype}"] = r
            if dtype == torch.float32:  # what phase 5 times
                want = sym_streams_ref(*sti, xi)
                for v, k in SYM_VARIANTS.items():
                    require(all(torch.equal(a, b) for a, b in zip(
                        sym_probe(k, *sti, xi), want)),
                        f"B9's probe variant {v} differs, {kind}")
        del rows, indptr, sti, stf, x, up, ct, up0
    torch.cuda.synchronize()
    return out


def sym_times(fem, cpm, dev):
    """Phase 5 for B9 beside the design it replaced (``sym_probe``, with
    the zeroing of ``up`` its wrapper did) and the probe's other tile
    depths, on the FEM matrix's SymCSC stream, on the arrow matrix and on
    a stream of as many slots in short columns (``sym_stream``), float32;
    device ms, back to back."""
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import SYM_TILE

    S, x = fem["S"], fem["x"]
    streams = {"fem": (S.indices, S.data, S.indptr, x)}
    g = np.random.default_rng([SEED, 9])
    for kind in ("arrow", "short"):
        rows_h, indptr_h, M = sym_stream(kind, SYM_TILE, g)
        streams[kind] = (
            torch.from_numpy(rows_h).to(dev),
            torch.from_numpy(g.standard_normal(rows_h.size).astype(
                np.float32)).to(dev),
            torch.from_numpy(indptr_h).to(dev),
            torch.from_numpy(g.standard_normal(M).astype(np.float32)).to(dev))
    t = {"times": "B9 streams"}
    for name, st in streams.items():
        M, nz = st[3].numel(), st[1].numel()
        longest = int(torch.diff(st[2]).max())
        row = {"M": M, "nzmax": nz, "longest_column": longest,
               "ms": device_ms(lambda: sym_mod.sym_streams(
                   *st, longest=longest), cpm)}
        for v, k in SYM_VARIANTS.items():
            # on the arrow matrix the shapes that walk a column on one
            # thread or one warp take 20-150 ms a call: a few calls
            slow = name == "arrow" and v in ("replaced", "groups", "columns")
            row[f"{v}_ms"] = device_ms(lambda: sym_probe(k, *st), cpm,
                                       reps=3 if slow else REPS)
        row["bound_ms"], _ = bound_ms(12 * nz + 12 * M + 4, 3 * nz)
        t[name] = row
    return t


def update_times(sets, fem, ctx, cpm, dev):
    """Phase 5 for the fourth path: per set and delta share the update
    against a re-plan of the whole set (device and call time), the
    update split into delta sort, B7, materialisation and Parts 3-4;
    ``sparse2_update`` of the edge flip on the host clock; the
    symmetric plan against the full plan and their refills; B7 at both
    call sites against its plain version and ``torch.searchsorted``
    (packing apart).  Returns (B7's kernel row, the path's times)."""
    from repro_torch.core.coo import host_triplets
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import merge_search_ref
    from repro_torch.sparse import (pattern_symmetric, plan,
                                    plan_cache_clear, plan_lookup,
                                    plan_symmetric, sparse2_update)
    from repro_torch.sparse.dispatch import merge_search, sorted_permutation
    from repro_torch.sparse.pattern import _merge_gather, pattern_from_sorted

    t = {"times": "fourth path"}
    for name, (ii, jj, ss, siz) in sets.items():
        r_h, c_h, _, _ = host_triplets(ii, jj, ss, (siz, siz))
        r, c = torch.from_numpy(r_h).to(dev), torch.from_numpy(c_h).to(dev)
        del r_h, c_h
        L = r.shape[0]
        u = {"L": L}
        u["replan_ms"] = call_ms(lambda: plan(r, c, (siz, siz)))
        u["replan_device_ms"] = device_ms(lambda: plan(r, c, (siz, siz)),
                                          cpm)
        for frac in UPDATE_FRACS:
            Ld = round(frac * L)
            Lb = L - Ld
            base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
            rd, cd = r[Lb:], c[Lb:]
            f = f"_{frac}"
            fn = lambda: base.update(rd, cd)  # noqa: E731
            u["update" + f + "_ms"] = call_ms(fn)
            u["update" + f + "_device_ms"] = device_ms(fn, cpm)
            u["update" + f + "_device_idle_share"] = \
                1.0 - u["update" + f + "_device_ms"] / u["update" + f + "_ms"]
            u["replan_over_update" + f + "_device"] = \
                u["replan_device_ms"] / u["update" + f + "_device_ms"]
            u["replan_over_update" + f + "_call"] = \
                u["replan_ms"] / u["update" + f + "_ms"]
            # the split: the same steps as _merge_sorted_streams
            d = sorted_permutation(rd, cd, M=siz, N=siz)
            qr, qc = rd[d.long()], cd[d.long()]
            pb = d + Lb
            off = merge_search(qr, qc, base.srows, base.scols, side="right")
            r_m, c_m, p_m = _merge_gather(base.srows, base.scols, base.perm,
                                          qr, qc, pb, off)
            steps = {
                "delta_sort": lambda: sorted_permutation(rd, cd, M=siz,
                                                         N=siz),
                "B7": lambda: merge_search(qr, qc, base.srows, base.scols,
                                           side="right"),
                "materialise": lambda: _merge_gather(
                    base.srows, base.scols, base.perm, qr, qc, pb, off),
                "parts34": lambda: pattern_from_sorted(
                    r_m, c_m, p_m, M=siz, N=siz, nzmax=L),
            }
            for k, step in steps.items():
                u[f"update{f}_{k}_device_ms"] = device_ms(step, cpm)
            del base, d, qr, qc, pb, off, r_m, c_m, p_m, steps, fn
            torch.cuda.empty_cache()
        t[f"set_{name}"] = u
        del r, c
        torch.cuda.empty_cache()
    # -- the FEM edge flip and symmetric planning
    rows_f, cols_f, vals_f = fem["host"]
    nv, pat, vals_d = fem["nv"], fem["pat"], fem["vals_d"]
    drop, (ar, ac, av) = edge_flip(FEM_N, np.random.default_rng(SEED))
    base_args = (rows_f + 1, cols_f + 1, vals_f)
    times = []
    for _ in range(3):
        plan_cache_clear()
        plan_lookup(*base_args, (nv, nv))     # the base, cached
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse2_update(*base_args, ar + 1, ac + 1, av, (nv, nv),
                       drop_mask=drop)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t["sparse2_update_flip_ms"] = float(np.median(times))
    plan_cache_clear()
    t["sparse2_miss_fem_ms"] = host_ms(
        lambda: (plan_cache_clear(), plan_lookup(*base_args, (nv, nv))), 3)
    plan_cache_clear()
    t["pattern_symmetric_ms"] = call_ms(lambda: pattern_symmetric(pat), 5)
    t["plan_symmetric_ms"] = host_ms(
        lambda: plan_symmetric(rows_f, cols_f, (nv, nv), device=dev), 3)
    t["plan_A_host_ms"] = host_ms(
        lambda: plan(fem["rows_d"], fem["cols_d"], (nv, nv)), 3)
    up = rows_f < cols_f
    ru, cu = (torch.from_numpy(a[up]).to(dev) for a in (rows_f, cols_f))
    t["plan_upper_device_ms"] = device_ms(lambda: plan(ru, cu, (nv, nv)),
                                          cpm)
    t["plan_A_device_ms"] = device_ms(
        lambda: plan(fem["rows_d"], fem["cols_d"], (nv, nv)), cpm)
    spat = plan_symmetric(rows_f, cols_f, (nv, nv), device=dev)
    for what, fn in (("sym_refill", lambda: spat.assemble(vals_d)),
                     ("fill_A", lambda: pat.assemble(vals_d))):
        t[f"{what}_ms"] = call_ms(fn)
        t[f"{what}_device_ms"] = device_ms(fn, cpm)
    del spat, ru, cu
    # -- B7 at both call sites
    sites = {}
    sr_a, sc_a, ar1, ac1, siz = ctx[f"update_{UPDATE_FRACS[0]}"]
    d = sorted_permutation(ar1, ac1, M=siz, N=siz).long()
    sites["update"] = (ar1[d], ac1[d], sr_a, sc_a, siz, ("right",))
    qr, qc, tr, tc = ctx["symmetric"]
    sites["symmetric"] = (qr, qc, tr, tc, nv, ("left", "right"))
    rows_k = {}
    for site, (qr, qc, tr, tc, Mk, sides) in sites.items():
        Lq, n = qr.shape[0], tr.shape[0]
        for side in sides:
            key = tc.long() * (Mk + 1) + tr.long()
            qkey = qc.long() * (Mk + 1) + qr.long()
            right = side == "right"
            reached = ladder_reach(qr, qc, tr, tc, side)
            nbytes = 12 * Lq + 8 * reached
            r = {"Lq": Lq, "n": n, "side": side,
                 "ms": device_ms(lambda: mg.merge_search_kernel(
                     qr, qc, tr, tc, side=side), cpm),
                 "call_ms": call_ms(lambda: mg.merge_search_kernel(
                     qr, qc, tr, tc, side=side)),
                 "plain_ms": device_ms(lambda: merge_search_ref(
                     qr, qc, tr, tc, side=side), cpm),
                 # like for like: searchsorted needs both streams packed
                 # into int64 keys, so the packing is timed with it
                 "library_ms": device_ms(lambda: torch.searchsorted(
                     tc.long() * (Mk + 1) + tr.long(),
                     qc.long() * (Mk + 1) + qr.long(), right=right), cpm),
                 "searchsorted_alone_ms": device_ms(
                     lambda: torch.searchsorted(key, qkey, right=right),
                     cpm),
                 "pack_ms": device_ms(lambda: (
                     tc.long() * (Mk + 1) + tr.long(),
                     qc.long() * (Mk + 1) + qr.long()), cpm),
                 **{f"{v}_ms": device_ms(lambda: merge_probe(
                     k, qr, qc, tr, tc, side), cpm)
                    for v, k in MERGE_VARIANTS.items()},
                 "targets_reached": reached, "bytes": nbytes, "ops": 0,
                 "bound_all_targets_ms": (12 * Lq + 8 * n)
                 / HBM_BYTES_PER_S * 1e3}
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 0)
            r["GBps"] = nbytes / r["ms"] / 1e6
            r["share_of_3.35TBps"] = r["GBps"] / (HBM_BYTES_PER_S / 1e9)
            rows_k[f"{site}_{side}"] = r
            del key, qkey
    t["B7"] = rows_k
    return rows_k["update_right"], t


#: phase 4e: the plan and fill call ms on sets 1-3 before the policy
#: layer (NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5), printed
#: beside this run's
CALL_MS_BEFORE = {"1": (0.9400, 0.1146), "2": (1.097, 0.09291),
                 "3": (1.437, 0.1076)}
#: phase 4e's time limit, in seconds
PHASE_4E_LIMIT_S = 90
#: host calls timed for one memoised resolve_policy
RESOLVE_CALLS = 100_000


def priors_match_builds() -> dict:
    """Phase 4e: every family resolved on ``cuda`` (an empty table: the
    priors) and each build-time prior against what its library exports."""
    from repro_torch.kernels.common import bind, load_library
    from repro_torch.sparse import tuning

    def export(lib: str, fn: str) -> int:
        return int(bind(load_library(lib), fn, [])())

    for fam in tuning.registered_families():
        require(tuning.resolve_policy(fam, backend="cuda")
                == tuning.prior_policy(fam, "cuda"),
                f"{fam} does not resolve to its priors on cuda")
    rk, sk, mk, ck, yk = (tuning.build_knobs(f) for f in (
        "radix_sort", "segment_sum", "merge", "counting_sort", "spmv_sym"))
    pairs = {
        "radix_sort.tile": (rk["tile"], export("radix_sort", "radix_tile")),
        "radix_sort.kernel_max_bits": (1 << rk["kernel_max_bits"], export(
            "radix_sort", "radix_max_bins")),
        "radix_sort.hist_per_sm": (rk["hist_per_sm"], export(
            "radix_sort", "radix_hist_per_sm")),
        "radix_sort.hist_chunk": (rk["hist_chunk"], export(
            "radix_sort", "radix_hist_chunk")),
        "segment_sum.seg_per": (sk["threads"] * sk["seg_per"], export(
            "segment_sum", "segment_tile")),
        "segment_sum.sum2_per": (sk["threads"] * sk["sum2_per"], export(
            "segment_sum", "product_tile")),
        "segment_sum.scan_per": (sk["threads"] * sk["scan_per"], export(
            "segment_sum", "scan_tile")),
        "merge.block_q": (mk["block_q"], export("merge",
                                                "merge_block_queries")),
        "merge.splitters": (mk["splitters"], export("merge",
                                                    "merge_splitters")),
        "counting_sort.place_tile": (ck["place_tile"], export(
            "counting_sort", "placement_tile")),
        "spmv.block_r": (tuning.build_knobs("spmv")["block_r"], export(
            "spmv", "spmv_block_rows")),
        "spmv_sym.sym_per": (yk["threads"] * yk["sym_per"], export(
            "spmv_sym", "sym_tile")),
    }
    for k, (want, got) in pairs.items():
        require(want == got, f"build-time prior {k}: the registry gives "
                f"{want}, the library {got}")
    return {k: got for k, (_, got) in pairs.items()}


def loaded_table_check(fingerprint: str, n_entries: int,
                       reach: str) -> None:
    """Phase 4e's child process: the table of the sweep, loaded through
    ``REPRO_TUNING_CACHE_DIR``, steers each recorded family's call site
    to the sweep's winner (``reach``: a JSON list of the recorded
    families' dataset sizes and winning decisions) and ``fsparse`` on
    sets 1-3, each bit for bit against the oracle."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.sparse import fsparse, tuning
    from repro_torch.sparse.analysis import validate_tuning_table
    from repro_torch.sparse.tuning.measure import decision

    table = tuning.get_table()
    require(tuning.default_cache_path() is not None
            and table.fingerprint() == fingerprint
            and len(table) == n_entries,
            f"the loaded table ({len(table)} entries, "
            f"{table.fingerprint()}) is not the sweep's ({n_entries}, "
            f"{fingerprint})")
    validate_tuning_table(table)
    won = json.loads(Path(reach).read_text())
    require(len(won) == n_entries, f"{len(won)} winners for {n_entries} "
            "entries")
    for w in won:
        got = decision(w["family"], w["dims"], None, "cuda")
        require(got == w["decision"], f"the loaded {w['family']} entry "
                f"steers its call site to {got}, not the sweep's "
                f"{w['decision']}")
    out = {"loaded_table": fingerprint, "entries": n_entries,
           "call_sites_reached": [f"{w['family']}: {w['decision']}"
                                  for w in won], "sets": {}}
    for k, cfg in DATA_SETS.items():
        ii, jj, ss, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                    seed=SEED)
        S = fsparse(ii, jj, ss, (siz, siz))
        pr, ir, jc = matlab_sparse_oracle(ii - 1, jj - 1, ss, siz, siz)
        nnz = pr.shape[0]
        require(int(S.nnz) == nnz
                and np.array_equal(S.indptr.cpu().numpy(), jc)
                and np.array_equal(S.indices[:nnz].cpu().numpy(), ir)
                and np.array_equal(S.data[:nnz].cpu().numpy(),
                                   pr.astype(np.float32)),
                f"fsparse under the loaded table differs from the oracle, "
                f"set {k}")
        pol = {f: tuning.resolve_policy(f, backend="cuda", M=siz, N=siz,
                                        L=ii.shape[0])
               for f in ("plan", "radix_sort")}
        out["sets"][str(k)] = {
            "plan_method": pol["plan"]["method"],
            "radix_max_bits": pol["radix_sort"]["max_bits"],
            "fsparse": "bit-identical to oracle"}
    emit(out)


def policy_phase(dev, sets, fem, kernels, refill, smi_line) -> dict:
    """Phase 4e: the policy and analysis layers on the card (the module
    docstring); returns the phase's launch counts."""
    import os
    import shutil
    import tempfile

    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.sparse import (convert, plan, plan_coo, plan_symmetric,
                                    tuning, validate_matrix,
                                    validate_pattern)
    from repro_torch.sparse.analysis import (audit_default_paths,
                                             invariants,
                                             validate_tuning_table)
    from repro_torch.sparse.analysis.vmem import (check_report, dump_json,
                                                  format_table, vmem_report)
    from repro_torch.sparse.tuning.__main__ import main as tuning_cli
    from repro_torch.sparse.tuning.__main__ import run_measure
    from repro_torch.sparse.tuning.measure import (MEASURABLE_FAMILIES,
                                                   make_dataset)

    t_phase = time.perf_counter()
    require(os.environ.get("REPRO_TUNING_CACHE_DIR") is None,
            "phase 4e runs under the priors: unset REPRO_TUNING_CACHE_DIR")
    tuning.set_table(tuning.TuningTable())
    row = {"phase": "4e", "card": smi_line,
           "build_time_priors": priors_match_builds()}
    # the resource report, measured, against its declared columns
    report = vmem_report()
    print(f"resource report ({smi_line}):\n{format_table(report)}",
          flush=True)
    bad = check_report(report)
    require(not bad, "resource report: " + "; ".join(bad))
    # the autotuner's prior-only mode consumes every row of it
    with tempfile.TemporaryDirectory(prefix="repro-report-") as tmp:
        dump_json(report, f"{tmp}/report.json")
        require(tuning_cli(["--prior-only", "--vmem-report",
                            f"{tmp}/report.json", "--json",
                            f"{tmp}/table.json"]) == 0,
                "--prior-only did not consume the resource report")
        artifact = json.loads(Path(f"{tmp}/table.json").read_text())
    require(artifact["consumed_vmem_rows"] == len(report)
            and artifact["fingerprint"] == "prior",
            f"--prior-only consumed {artifact['consumed_vmem_rows']} of "
            f"{len(report)} rows")
    row["resource_report"] = [
        {k: r[k] for k in ("kernel", "name", "threads", "registers",
                           "max_registers", "spill_bytes", "static_smem",
                           "static_smem_measured", "dynamic_smem",
                           "blocks_per_sm")} for r in report]
    for f in kernels.values():
        f.launches = 0
    # the sweep: set 1 at 2.5e6 for every family, the 5e7 set for plan;
    # every candidate held against the prior's output
    t0 = time.perf_counter()
    on_set1 = tuple(f for f in MEASURABLE_FAMILIES if f != "spmv_sym")
    d1 = make_dataset(triplets=sets["1"], families=on_set1)
    d5 = make_dataset(triplets=sets["2x20"], families=("plan",))
    # B9 on the FEM SymCSC: about 3 slots a column, so the candidates of
    # short_mean fall on both sides of its cut-off (set 1 has about 25 a
    # column: every candidate would take the tiles)
    rows_f, cols_f, vals_f = fem["host"]
    dF = make_dataset(triplets=(rows_f + 1, cols_f + 1, vals_f, fem["nv"]),
                      sym=fem["S"], families=("spmv_sym",))
    results = run_measure(
        datasets=[(d1, on_set1), (d5, ("plan",)), (dF, ("spmv_sym",))],
        log=lambda s: print(f"sweep: {s}", flush=True))
    del d1, d5, dF
    require({r["family"] for r in results} == set(MEASURABLE_FAMILIES),
            "the sweep missed a family")
    require(all(len(r["candidates"]) > 1 for r in results),
            "the sweep timed no alternative for some family")
    table = tuning.get_table()
    require(validate_tuning_table(table) == len(table), "the swept table "
            "does not validate")
    cache = tempfile.mkdtemp(prefix="repro-tuning-")
    try:
        table.save(Path(cache) / tuning.TABLE_FILENAME)
        fp, n = table.fingerprint(), len(table)
        row["sweep"] = {
            "s": time.perf_counter() - t0, "fingerprint": fp, "entries": n,
            "chosen": table.entries(),
            "families": [{k: r[k] for k in ("family", "L", "prior_ms",
                                            "best_ms", "gain", "recorded",
                                            "key")}
                         | {"best": {k: v for k, v in r["best"].items()
                                     if v != r["prior"][k]},
                            "timed": len(r["candidates"])}
                         for r in results]}
        reach = Path(cache) / "reach.json"
        reach.write_text(json.dumps(
            [{k: r[k] for k in ("family", "dims", "decision")}
             for r in results if r["recorded"]]))
        # the table through REPRO_TUNING_CACHE_DIR in a fresh process
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--loaded-table-check", fp, str(n), str(reach)],
            env=dict(os.environ, REPRO_TUNING_CACHE_DIR=cache),
            capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, "the loaded-table check failed:\n"
                + proc.stdout[-2000:] + proc.stderr[-4000:])
        row["loaded_table"] = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    tuning.reset_table()  # the rest of the run: the priors
    require(tuning.tuning_fingerprint() == "prior", "priors not restored")
    # hot-path cost: one memoised resolution, the plan and fill calls
    ii, jj, _, siz = sets["1"]
    t0 = time.perf_counter()
    for _ in range(RESOLVE_CALLS):
        tuning.resolve_policy("plan", backend="cuda", M=siz, N=siz,
                              L=ii.shape[0])
    row["resolve_policy_host_us"] = \
        (time.perf_counter() - t0) / RESOLVE_CALLS * 1e6
    calls = {}
    for name in ("1", "2", "3"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        pat = plan_coo(coo)
        v = torch.from_numpy(refill[name]).to(dev)
        calls[name] = {"plan_ms": call_ms(lambda: plan_coo(coo)),
                       "fill_ms": call_ms(lambda: pat.assemble(v)),
                       "before_policy_layer_ms": CALL_MS_BEFORE[name]}
    row["hot_path"] = calls
    # validators on the structures phases 4-4d built (the FEM path's
    # plans, products and formats; the plans of sets 1 and 2x20), a
    # SymPattern, and one update under REPRO_VALIDATE=1
    checked = []
    for name in ("1", "2x20"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        pat = validate_pattern(plan_coo(coo))
        validate_matrix(pat.assemble(coo.vals))
        checked += [f"SparsePattern, CSC (set {name})"]
    A = fem["A"]
    for label, obj in (("pat", fem["pat"]), ("pp1", fem["pp1"]),
                       ("pp2", fem["pp2"])):
        validate_pattern(obj, subject=f"FEM {label}")
    for label, obj in (("A", A), ("S", fem["S"]), ("Bm", fem["Bm"]),
                       ("P", fem["P"]), ("Ptc", fem["Ptc"]),
                       ("PtA", fem["PtA"]), ("CSR", convert(A, "csr")),
                       ("COO", convert(A, "coo"))):
        validate_matrix(obj, subject=f"FEM {label}")
    r_s, c_s, _, nv_s, _, _ = fem_system(199)
    validate_pattern(plan_symmetric(r_s, c_s, (nv_s, nv_s)))
    checked += ["FEM: SparsePattern, 2 ProductPattern, CSC x4, SymCSC, "
                "BSR, CSR, COO", "SymPattern (199 x 199 cells)"]
    ii, jj, ss, siz = sets["1"]
    r = torch.from_numpy(ii - 1).to(dev, torch.int32)
    c = torch.from_numpy(jj - 1).to(dev, torch.int32)
    L = r.shape[0]
    Lb = L - L // 100
    base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
    seen = []
    real = invariants.validate_pattern
    invariants.validate_pattern = \
        lambda p, subject=None: seen.append(subject) or real(p,
                                                             subject=subject)
    os.environ["REPRO_VALIDATE"] = "1"
    try:
        got = base.update(r[Lb:], c[Lb:])
    finally:
        del os.environ["REPRO_VALIDATE"]
        invariants.validate_pattern = real
    require(seen == ["SparsePattern.update"], f"the update under "
            f"REPRO_VALIDATE=1 validated {seen}")
    full = plan(r, c, (siz, siz))
    require(all(torch.equal(getattr(got, f), getattr(full, f)) for f in (
        "perm", "slot", "indices", "indptr", "nnz")),
        "the validated update differs from the plan of the whole set")
    checked.append("update of set 1 (1%) under REPRO_VALIDATE=1")
    row["validators"] = checked
    # the contract audit on CUDA tensors
    reports = audit_default_paths()
    row["contracts"] = {"paths": [x["name"] for x in reports],
                        "verdict": "clean"}
    launches = {k: f.launches for k, f in kernels.items()}
    row["launches"] = launches
    for k, n in launches.items():
        require(n > 0, f"kernel {k} never launched on phase 4e's path")
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4E_LIMIT_S,
            f"phase 4e took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4E_LIMIT_S} s")
    return launches


#: phase 4f's time limit, in seconds
PHASE_4F_LIMIT_S = 90
#: phase 4f's warm regime (``benchmarks/bench_serving.py``'s): threads,
#: requests a thread per set, and the value scales the requests cycle
#: through (the sets' values are ones, so every scaled result is exact)
SERVE_THREADS, SERVE_REQUESTS = 4, 8
SERVE_SCALES = (1.0, 2.0, 3.0, 4.0)


def csc_digest(A) -> str:
    """sha256 of a CSC's ``indptr``, ``indices`` and ``data`` bytes."""
    h = hashlib.sha256()
    for t in (A.indptr, A.indices, A.data):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def serving_restart_check(cache_dir: str) -> None:
    """Phase 4f's child process: a ``PlanService`` pointed at the parent's
    ``cache_dir`` loads its plans, re-plans nothing and times its first
    request per set; prints the digests of the results for the parent
    to hold against phase 4's oracle-checked ones."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.sparse import PlanService, plan_cache_info

    t0 = time.perf_counter()
    svc = PlanService(cache_dir=cache_dir)
    torch.cuda.synchronize()
    out = {"loaded_plans": svc.loaded_plans,
           "load_ms": (time.perf_counter() - t0) * 1e3,
           "first_request_ms": {}, "digest": {}}
    for k, cfg in DATA_SETS.items():
        ii, jj, ss, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                    seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = svc.assemble(ii, jj, ss, (siz, siz))
        torch.cuda.synchronize()
        out["first_request_ms"][str(k)] = (time.perf_counter() - t0) * 1e3
        out["digest"][str(k)] = csc_digest(A)
    out["plan_misses"] = plan_cache_info()["misses"]
    out["graphs"] = svc.stats()["graphs"]
    emit(out)


def _kernel_names(fn) -> list:
    """The CUDA kernels ``torch.profiler`` saw in one call of ``fn()``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.self_device_time_total > 0})


def serving_phase(dev, sets, fem, verified, kernels, cpm,
                  smi_line) -> dict:
    """Phase 4f: the plan service and its CUDA-graph tier (the module
    docstring); returns the phase's launch counts.  The service persists
    into a temporary ``cache_dir``, removed at the end."""
    import shutil
    import tempfile

    cache = tempfile.mkdtemp(prefix="repro-serve-")
    try:
        return _serving_phase(dev, sets, fem, verified, kernels, cpm,
                              smi_line, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def _serving_phase(dev, sets, fem, verified, kernels, cpm, smi_line,
                   cache) -> dict:
    import dataclasses
    import gc
    import threading

    from repro_torch.sparse import (PlanService, convert, fsparse, ops,
                                    plan_cache_clear, plan_cache_info,
                                    sparse2)
    from repro_torch.sparse.analysis import audit_retraces
    from repro_torch.sparse.analysis.contracts import audit_trace, record_ops
    from repro_torch.sparse.errors import InvariantViolation
    from repro_torch.sparse.matlab import plan_lookup
    from repro_torch.sparse.serving import _SPMV_NUMERIC_FIELDS
    from repro_torch.sparse.spgemm import _structure_key

    t_phase = time.perf_counter()
    row = {"phase": "4f", "card": smi_line}
    plan_cache_clear()
    for f in kernels.values():
        f.launches = 0
    names = ("1", "2", "3")
    torch.cuda.synchronize()
    mem = {"phase_start": torch.cuda.memory_reserved() / 2**20}
    svc = PlanService(cache_dir=cache)
    require(svc.stats()["graph_mode"] == "cuda-graph",
            "the service does not capture on the card")
    # uncached results per set and value scale: each scale is the
    # oracle-checked result of phase 4 times the scale, exactly
    want = {}
    for name in names:
        ii, jj, ss, siz = sets[name]
        base = fsparse(ii, jj, ss, (siz, siz))
        require(csc_digest(base) == verified[name], "uncached fsparse "
                f"differs from phase 4's, set {name}")
        require(float(base.data.max()) * max(SERVE_SCALES) < 2**24,
                "scaled sums past 2^24")
        want[name] = {k: fsparse(ii, jj, ss * k, (siz, siz)).data
                      for k in SERVE_SCALES}
        for k, d in want[name].items():
            require(torch.equal(d, k * base.data), f"fsparse of the "
                    f"values times {k} is not the oracle's, set {name}")
    # -- cold: the first request of each set (plan, persist, capture)
    cold = {}
    for name in names:
        ii, jj, ss, siz = sets[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = svc.assemble(ii, jj, ss, (siz, siz))
        torch.cuda.synchronize()
        cold[name] = (time.perf_counter() - t0) * 1e3
        require(csc_digest(A) == verified[name], "the cold request "
                f"differs from the oracle, set {name}")
    row["cold_ms"] = cold
    # -- warm: threads x requests per set, every result bit for bit
    lat = {name: [[] for _ in range(SERVE_THREADS)] for name in names}
    errors = []

    def worker(t):
        try:
            for name in names:
                ii, jj, ss, siz = sets[name]
                for r in range(SERVE_REQUESTS):
                    k = SERVE_SCALES[(t + r) % len(SERVE_SCALES)]
                    t0 = time.perf_counter()
                    A = svc.assemble(ii, jj, ss * k, (siz, siz))
                    torch.cuda.current_stream().synchronize()
                    lat[name][t].append(
                        (time.perf_counter() - t0) * 1e3)
                    if not torch.equal(A.data, want[name][k]):
                        errors.append(f"set {name}, scale {k}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    warm_s = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a warm thread hung")
    require(not errors, f"warm requests differ: {errors[:5]}")
    row["warm"] = {"threads": SERVE_THREADS,
                   "requests_per_thread_per_set": SERVE_REQUESTS,
                   "requests_per_s": SERVE_THREADS * SERVE_REQUESTS
                   * len(names) / warm_s}
    for name in names:
        ms = np.concatenate(lat[name])
        row["warm"][name] = {"p50_ms": float(np.percentile(ms, 50)),
                             "p99_ms": float(np.percentile(ms, 99))}
    torch.cuda.synchronize()
    mem["with_3_fill_graphs"] = torch.cuda.memory_reserved() / 2**20
    st = svc.stats()
    require(st["graphs"]["captures"] == {"fill": 3}
            and st["plan"]["misses"] == 3,
            f"warm requests captured or planned again: {st}")
    # -- restart: a child process on the same cache_dir
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()),
         "--serving-restart-check", cache],
        capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, "the restart child failed:\n"
            + proc.stdout[-2000:] + proc.stderr[-4000:])
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    require(child["loaded_plans"] >= 3 and child["plan_misses"] == 0,
            f"the restart re-planned: {child}")
    for name in names:
        require(child["digest"][name] == verified[name],
                f"the restarted service differs, set {name}")
    row["restart"] = {k: child[k] for k in (
        "loaded_plans", "plan_misses", "load_ms", "first_request_ms",
        "graphs")}
    row["persisted_MB"] = sum(
        p.stat().st_size for p in Path(cache).glob("*.pkl")) / 2**20
    # -- one accum="max" request: B4 captured
    ii, jj, ss, siz = sets["1"]
    vr = np.random.default_rng([SEED, 6]).standard_normal(
        ii.shape[0]).astype(np.float32)
    require(torch.equal(svc.assemble(ii, jj, vr, (siz, siz),
                                     accum="max").data,
                        sparse2(ii, jj, vr, (siz, siz), accum="max").data),
            "the captured max fill differs from sparse2")

    # -- replay against eager: the fill at sets 1-3 (float32 and float64,
    #    bit for bit), as a caller pays it and on the device
    rng = np.random.default_rng([SEED, 5])
    rep = {}
    for name in names:
        ii, jj, ss, siz = sets[name]
        key, pat, _ = plan_lookup(ii, jj, ss, (siz, siz))
        r = {}
        for dtype in (torch.float32, torch.float64):
            v = torch.from_numpy(rng.standard_normal(pat.L)).to(dev, dtype)
            got = svc._fill(key, pat, v)
            require(torch.equal(got, pat.scatter(v)), f"the {dtype} fill "
                    f"replay differs from eager, set {name}")
        v = torch.from_numpy(rng.standard_normal(pat.L)
                             .astype(np.float32)).to(dev)
        for what, fn in (("replay", lambda: svc._fill(key, pat, v)),
                         ("eager", lambda: pat.scatter(v))):
            r[f"{what}_ms"] = call_ms(fn)
            r[f"{what}_device_ms"] = device_ms(fn, cpm)
        rep[f"fill_{name}"] = r
    # the SpMV in four formats on the FEM matrix: within 8 eps sum|a x|
    # of eager on random x, bit for bit on integer-valued operands; on a
    # service with no cache_dir (the product plan of P' A is 0.5 GB)
    fsvc = PlanService()
    A, x = fem["A"], fem["x"]
    absA = dataclasses.replace(A, data=A.data.abs())
    tol = 8 * EPS32 * ops.matmul(absA, x.abs())
    xi = torch.from_numpy(rng.integers(-3, 4, x.shape[0]).astype(
        np.float32)).to(dev)
    fmts = {"csc": A, "csr": convert(A, "csr"), "symcsc": fem["S"],
            "bsr": fem["Bm"]}
    spmv_err = {}
    for fmt, F in fmts.items():
        y = fsvc.spmv(F, x)
        err = (y - ops.matmul(F, x)).abs()
        require(bool(torch.all(err <= tol)), f"the {fmt} spmv replay is "
                "not within 8 eps sum|a x| of eager")
        spmv_err[fmt] = float((err / tol.clamp(min=1e-30)).max())
        Fi = dataclasses.replace(F, **{
            f: torch.round(4 * getattr(F, f))
            for f in _SPMV_NUMERIC_FIELDS[type(F).__name__]})
        require(torch.equal(fsvc.spmv(Fi, xi), ops.matmul(Fi, xi)),
                f"the {fmt} spmv replay differs on integer-valued data")
        r = {}
        for what, fn in (("replay", lambda: fsvc.spmv(F, x)),
                         ("eager", lambda: ops.matmul(F, x))):
            r[f"{what}_ms"] = call_ms(fn)
            r[f"{what}_device_ms"] = device_ms(fn, cpm)
        rep[f"spmv_{fmt}"] = r
    row["spmv_max_err_over_tol"] = spmv_err
    # one CG iteration on the SymCSC operator through the service
    S, b = fem["S"], fem["b"]
    _, res_r = cg(lambda v: fsvc.spmv(S, v), b, 10)
    _, res_e = cg(lambda v: ops.matmul(S, v), b, 10)
    require(abs(float(res_r) - float(res_e)) <= 1e-3 * float(res_e) + 1e-6,
            f"CG through the service: residual {float(res_r)} against "
            f"{float(res_e)} eager")
    rep["cg_iteration_symcsc"] = {
        "replay_ms": call_ms(lambda: cg(lambda v: fsvc.spmv(S, v), b, 10),
                             reps=5) / 10,
        "eager_ms": call_ms(lambda: cg(lambda v: ops.matmul(S, v), b, 10),
                            reps=5) / 10}
    # the product P' A (B6), float32 and float64, bit for bit
    Ptc, pp1 = fem["Ptc"], fem["pp1"]
    for dtype in (torch.float32, torch.float64):
        P2 = dataclasses.replace(Ptc, data=Ptc.data.to(dtype))
        A2 = dataclasses.replace(A, data=A.data.to(dtype))
        require(torch.equal(fsvc.multiply(P2, A2).data,
                            pp1.multiply(P2.data, A2.data).data),
                f"the {dtype} multiply replay differs from eager")
    # the service's call keys both operands on the host (a copy of
    # their structures, which syncs), so its graph is also timed alone
    ex = next(e for k, e in fsvc._execs.items()
              if k[0] == "multiply" and k[2] == str(torch.float32))
    rep["multiply_PtA"] = {
        "service_call_ms": call_ms(lambda: fsvc.multiply(Ptc, A)),
        "replay_ms": call_ms(lambda: ex(Ptc.data, A.data)),
        "eager_ms": call_ms(lambda: pp1.multiply(Ptc.data, A.data)),
        "replay_device_ms": device_ms(lambda: ex(Ptc.data, A.data), cpm),
        "eager_device_ms": device_ms(
            lambda: pp1.multiply(Ptc.data, A.data), cpm),
        "product_key_host_ms": host_ms(
            lambda: (_structure_key(Ptc), _structure_key(A)), 5)}
    del ex
    torch.cuda.synchronize()
    mem["with_fem_graphs"] = torch.cuda.memory_reserved() / 2**20
    # the spmv key: the structure's bytes to the host, or the memo's hit
    rep["spmv_key"] = {"unmemoised_ms": host_ms(lambda: _structure_key(A),
                                                 REPS),
                       "memoised_ms": host_ms(
                           lambda: fsvc._structure_keys(A), REPS)}
    row["replay_vs_eager"] = rep
    # the contract audit over hits: no host sync and, on the card, no
    # copy to the host (an unmemoised key would copy its structure)
    hits = {"PlanService.assemble": lambda: svc.assemble(
        *sets["1"][:3], (sets["1"][3],) * 2).data,
        "PlanService.multiply": lambda: fsvc.multiply(Ptc, A).data,
        **{f"PlanService.spmv[{f}]": (lambda F=F: fsvc.spmv(F, x))
           for f, F in fmts.items()}}
    for name, fn in hits.items():
        fn()
        try:
            audit_trace(record_ops(fn), name=name)
        except InvariantViolation as e:
            fail(f"the contract audit over {name}: {e}")
    row["contract_audit"] = {"paths": list(hits), "verdict": "clean"}

    # -- update_structure of set 1: base the first 99%, delta the last 1%
    ii, jj, ss, siz = sets["1"]
    L = ii.shape[0]
    Lb = L - L // 100
    svc.assemble(ii[:Lb], jj[:Lb], ss[:Lb], (siz, siz), L)
    before = {k[:2] for k, _ in svc._execs.items()}
    caps = svc.stats()["graphs"]["captures"]["fill"]
    U = svc.update_structure(ii[:Lb], jj[:Lb], ss[:Lb], ii[Lb:], jj[Lb:],
                             ss[Lb:], (siz, siz), L)
    require(csc_digest(U) == verified["1"], "the update differs from a cold "
            "assemble of the whole set")
    after = {k[:2] for k, _ in svc._execs.items()}
    gone, new = before - after, after - before
    require(len(gone) == 1 and len(new) == 1
            and all(k[0] == "fill" for k in gone | new),
            f"the update purged {gone} and added {new}")
    require(svc.stats()["graphs"]["captures"]["fill"] == caps + 1,
            "the update captured more than its fill")
    row["update"] = {"purged": 1, "added": 1, "survived": len(after) - 1,
                     "result": "bit-identical to the oracle"}

    # -- assemble_many: 8 requests over sets 1 and 3, one graph a group
    order = [("1", 1.0), ("3", 1.0), ("1", 2.0), ("1", 3.0), ("3", 2.0),
             ("1", 4.0), ("3", 3.0), ("1", 1.0)]
    batch = PlanService()
    outs = batch.assemble_many([
        (sets[n][0], sets[n][1], sets[n][2] * k, (sets[n][3],) * 2)
        for n, k in order])
    for (n, k), got in zip(order, outs):
        one = svc.assemble(sets[n][0], sets[n][1], sets[n][2] * k,
                           (sets[n][3],) * 2)
        require(torch.equal(got.data, want[n][k])
                and torch.equal(got.data, one.data),
                f"assemble_many differs from per-request results ({n}, {k})")
    bst = batch.stats()
    require(bst["graphs"]["captures"] == {"fill": 2}
            and bst["exec"]["size"] == 2, f"assemble_many captured "
            f"{bst['graphs']}")
    row["assemble_many"] = {"requests": len(order), "groups": 2,
                            "captures": 2, "order": "request order, "
                            "bit-identical"}

    # -- the capture audit, and the kernels a replay runs
    row["audit_retraces"] = audit_retraces()
    key1, pat1, v1 = plan_lookup(*sets["1"][:3], (sets["1"][3],) * 2)
    fill_names = _kernel_names(lambda: svc._fill(key1, pat1, v1))
    sym_names = _kernel_names(lambda: fsvc.spmv(S, x))
    require(any("segment_reduce_kernel" in k and "Gather<" in k
                and "MinMax" not in k for k in fill_names),
            f"a fill replay ran no B3' kernel: {fill_names}")
    require(any("sym_threads_kernel" in k or "sym_streams_kernel" in k
                for k in sym_names),
            f"a SymCSC spmv replay ran no B9 kernel: {sym_names}")
    row["witness"] = {"fill_replay": [k[:90] for k in fill_names],
                      "symcsc_spmv_replay": [k[:90] for k in sym_names]}

    # -- no path fell back: every entry of both services holds a graph
    for service in (svc, fsvc, batch):
        require(all(ex.graph is not None
                    for _, ex in service._execs.items()),
                "an executable holds no graph")
    row["graphs"] = {"sets": svc.stats()["graphs"],
                     "fem": fsvc.stats()["graphs"]}
    torch.cuda.synchronize()
    mem["with_all_graphs"] = torch.cuda.memory_reserved() / 2**20
    svc._execs.clear()
    del fsvc, batch, outs
    gc.collect()
    torch.cuda.empty_cache()
    mem["graphs_evicted"] = torch.cuda.memory_reserved() / 2**20
    row["memory_reserved_MB"] = mem

    # -- the 5e7 set: one request and one replay, no threads
    ii, jj, ss, siz = sets["2x20"]
    big = PlanService()
    t = {}
    for what in ("cold", "replay"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A5 = big.assemble(ii, jj, ss, (siz, siz))
        torch.cuda.synchronize()
        t[f"{what}_ms"] = (time.perf_counter() - t0) * 1e3
        require(csc_digest(A5) == verified["2x20"], f"the {what} request "
                "differs from the oracle at 5e7")
    require(big.stats()["graphs"] == {"captures": {"fill": 1},
                                      "replays": {"fill": 2}},
            "the 5e7 requests did not replay one graph")
    row["set_2x20"] = t
    del big, A5
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()

    launches = {k: f.launches for k, f in kernels.items()}
    row["launches"] = launches
    for k in ("B1", "B2", "B3", "B4", "B6", "B7", "B9", "B10", "P34"):
        require(launches[k] > 0, f"kernel {k} never launched on phase "
                "4f's path")
    row["plan_cache"] = plan_cache_info()
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4F_LIMIT_S,
            f"phase 4f took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4F_LIMIT_S} s")
    return launches


#: phase 4g's time limit, in seconds
PHASE_4G_LIMIT_S = 60
#: phase 4g's mesh sizes: the default mesh (one shard a card) and four
#: shards on the card (the reference's tests force four host devices)
SHARDS = (1, 4)


def sharded_phase(dev, sets, oracles, kernels, cpm, smi_line) -> dict:
    """Phase 4g: the sharded path (the module docstring); ``oracles``
    holds each set's oracle CSC ``(pr, ir, jc)``.  Returns the phase's
    launch counts on its main path."""
    import dataclasses

    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.kernels.segment_sum.ref import gather_segment_sum_ref
    from repro_torch.launch import make_data_mesh
    from repro_torch.sparse import (PlanService, convert, fsparse, plan,
                                    plan_cache_clear, plan_cache_info,
                                    plan_sharded, sparse2)
    from repro_torch.sparse.sharded import route_values

    t_phase = time.perf_counter()
    row = {"phase": "4g", "card": smi_line}
    hist_k, place_k, fill_k = kernels["B1"], kernels["B2"], kernels["B3"]
    p34_k = kernels["P34"]
    meshes = {p: (None if p == 1 else make_data_mesh(p)) for p in SHARDS}
    require(make_data_mesh().shape["data"] == 1,
            "the default mesh is not one shard on the card")
    runs = [(name, p) for name in ("1", "2", "3") for p in SHARDS]
    runs.append(("2x20", 4))

    def counts() -> dict:
        return {"B1": hist_k.launches, "B2": place_k.launches,
                "B3": fill_k.launches, "P34": p34_k.launches}

    def block_passes(siz: int, L: int, p: int) -> int:
        """Digit passes of one block's plan (rpb rows, R received)."""
        L_pad = -(-L // p) * p
        cap = int(2.0 * L_pad / (p * p)) + 8
        cap = -(-cap // 8) * 8
        return len(plan_digit_passes(-(-siz // p), siz, p * cap))

    # the main path alone, counted: fsparse(..., method="sharded")
    for f in (hist_k, place_k, fill_k, p34_k):
        f.launches = 0
    expected = {"B1": 0, "B2": 0, "B3": 0, "P34": 0}
    results = {}
    for name, p in runs:
        ii, jj, ss, siz = sets[name]
        results[name, p] = fsparse(ii, jj, ss, (siz, siz), method="sharded",
                                   mesh=meshes[p])
        npass = block_passes(siz, ii.shape[0], p)
        expected["B1"] += p * npass
        expected["B2"] += p * npass
        expected["B3"] += 1
        expected["P34"] += p
    torch.cuda.synchronize()
    launches = counts()
    row["launches"], row["expected"] = launches, dict(expected)
    require(launches == expected, f"phase 4g launch counts {launches} != "
            f"{expected} (p x the digit passes of a block's plan for B1 "
            "and B2, one B3' a fill, one P34 a block's plan)")

    # each result in the Matlab layout: bit for bit the oracle's, and so
    # phase 4's single-device fsparse's; sets 1-3 also against a fresh one
    checked = {}
    for (name, p), S in results.items():
        ii, jj, ss, siz = sets[name]
        pr, ir, jc = oracles[name][:3]
        nnz = pr.shape[0]
        require(S.n_blocks == p and S.data.device.type == "cuda",
                f"set {name}, p = {p}: {S.n_blocks} blocks on "
                f"{S.data.device}")
        require(int(S.nnz.sum()) == nnz, f"set {name}, p = {p}: blocks' "
                f"nnz sum to {int(S.nnz.sum())}, not {nnz}")
        C = convert(S, "csc")
        require(int(C.nnz) == nnz
                and np.array_equal(C.indptr.cpu().numpy(), jc)
                and np.array_equal(C.indices[:nnz].cpu().numpy(), ir)
                and np.array_equal(C.data[:nnz].cpu().numpy(),
                                   pr.astype(np.float32)),
                f"convert(fsparse(method='sharded'), 'csc') differs from "
                f"the oracle, set {name}, p = {p}")
        if name != "2x20":
            F = fsparse(ii, jj, ss, (siz, siz))
            require(torch.equal(C.indptr, F.indptr)
                    and torch.equal(C.indices[:nnz], F.indices[:nnz])
                    and torch.equal(C.data[:nnz], F.data[:nnz]),
                    f"sharded CSC differs from fsparse, set {name}, p = {p}")
        checked[f"{name}/p{p}"] = {"nnz": int(nnz), "nzb": S.nzb}
        del C
    row["convert_csc"] = "bit-identical to the oracle and to fsparse"
    row["sets"] = checked
    del results

    # Phase A's invariants, the fills, the SpMV and the times, per run
    times = {}
    for name, p in runs:
        ii, jj, ss, siz = sets[name]
        mesh = make_data_mesh(p)
        rows = torch.from_numpy((ii - 1).astype(np.int32)).to(dev)
        cols = torch.from_numpy((jj - 1).astype(np.int32)).to(dev)
        L = rows.shape[0]
        pat = plan_sharded(rows, cols, (siz, siz), mesh=mesh)
        sb, bl = pat.send_base.cpu().numpy(), pat.block_load.cpu().numpy()
        require(np.all(sb[0] == 0) and np.all(np.diff(sb, axis=0) >= 0)
                and np.all(sb <= bl) and np.all(bl == bl[0])
                and int(bl[0].sum()) == L
                and int(pat.nnz_total()) == oracles[name][0].shape[0]
                and not bool(pat.any_overflow()),
                f"Phase A invariants fail, set {name}, p = {p}")
        v = torch.from_numpy(np.random.default_rng([SEED, p]).standard_normal(
            L).astype(np.float32)).to(dev)
        single = plan(rows, cols, (siz, siz))
        reps = 5 if name == "2x20" else REPS
        t = {"plan_sharded_call_ms": call_ms(
                 lambda: plan_sharded(rows, cols, (siz, siz), mesh=mesh),
                 reps=reps),
             "plan_sharded_device_ms": device_ms(
                 lambda: plan_sharded(rows, cols, (siz, siz), mesh=mesh),
                 cpm, reps=reps),
             "plan_call_ms": call_ms(lambda: plan(rows, cols, (siz, siz)),
                                     reps=reps),
             "plan_device_ms": device_ms(
                 lambda: plan(rows, cols, (siz, siz)), cpm, reps=reps),
             "routed_fill_call_ms": call_ms(lambda: pat.assemble(v),
                                            reps=reps),
             "routed_fill_device_ms": device_ms(lambda: pat.assemble(v),
                                                cpm, reps=reps),
             "fill_call_ms": call_ms(lambda: single.assemble(v), reps=reps),
             "fill_device_ms": device_ms(lambda: single.assemble(v), cpm,
                                         reps=reps),
             # bench_shard_reassemble's regimes: plan once and fill per
             # call, against plan and fill per call
             "plan_once_fill_many_ms": call_ms(lambda: pat.assemble(v),
                                               reps=reps),
             "plan_and_fill_each_ms": call_ms(
                 lambda: plan_sharded(rows, cols, (siz, siz),
                                      mesh=mesh).assemble(v), reps=reps)}
        t["reassemble_speedup"] = t["plan_and_fill_each_ms"] \
            / t["plan_once_fill_many_ms"]
        if p > 1:
            t["plan_sharded_top_kernels"] = top_kernels(
                lambda: plan_sharded(rows, cols, (siz, siz), mesh=mesh), k=6)
        times[f"{name}/p{p}"] = t
        if name == "2" and p == 4:
            # assemble_batch against single fills, bit for bit
            vb = torch.from_numpy(np.random.default_rng([SEED, 7])
                                  .standard_normal((3, L)).astype(
                                      np.float32)).to(dev)
            Ab = pat.assemble_batch(vb)
            require(all(torch.equal(Ab.batch_select(b).data,
                                    pat.assemble(vb[b]).data)
                        for b in range(3)),
                    "assemble_batch differs from single fills, set 2, p = 4")
            # the block-row SpMV against the single-device CSC SpMV, on
            # integer-valued data (the two matrices are equal)
            vi = torch.from_numpy(np.random.default_rng([SEED, 8]).integers(
                -8, 9, L).astype(np.float32)).to(dev)
            A, F = pat.assemble(vi), single.assemble(vi)
            x = torch.from_numpy(np.random.default_rng([SEED, 9])
                                 .standard_normal(siz).astype(
                                     np.float32)).to(dev)
            y, y1 = A.spmv(x), F @ x
            bound = dataclasses.replace(F, data=F.data.abs()) @ x.abs()
            err = float(((y - y1).abs() / (EPS32 * bound).clamp(
                min=1e-30)).max())
            require(err <= 8, f"block-row SpMV error {err} eps x "
                    "sum_j |a_ij x_j| > 8, set 2, p = 4")
            row["spmv_max_err_over_eps_sum_abs"] = err
            # the fill's gradient on the card against the plain version's
            # on the CPU, bit for bit
            cpu_pat = dataclasses.replace(
                pat, mesh=make_data_mesh(p, device="cpu"),
                **{f.name: getattr(pat, f.name).cpu()
                   for f in dataclasses.fields(pat)
                   if isinstance(getattr(pat, f.name), torch.Tensor)})
            w = torch.from_numpy(np.random.default_rng([SEED, 10])
                                 .standard_normal((p, pat.nzb)).astype(
                                     np.float32))
            grads = []
            for P, vv, ww in ((pat, v, w.to(dev)), (cpu_pat, v.cpu(), w)):
                vv = vv.clone().requires_grad_()
                (P.assemble(vv).data * ww).sum().backward()
                grads.append(vv.grad.cpu())
            require(torch.equal(*grads), "the sharded fill's gradient on "
                    "the card differs from the plain version's on the CPU")
            row["gradient"] = "bit-identical to the CPU's"
            # B3' against its plain version on the routed stream
            recv = route_values(pat.send_slot, vi[None], p=p,
                                capacity=pat.capacity)[0].reshape(-1)
            vn = route_values(pat.send_slot, v[None], p=p,
                              capacity=pat.capacity)[0].reshape(-1)
            perm_g, slot_g = pat._streams
            nz = dict(num_segments=p * pat.nzb)
            require(torch.equal(fill_k(recv, perm_g, slot_g, **nz),
                                gather_segment_sum_ref(recv, perm_g,
                                                       slot_g, **nz)),
                    "B3' differs from plain on the routed integer stream")
            got = fill_k(vn, perm_g, slot_g, **nz)
            want = gather_segment_sum_ref(vn, perm_g, slot_g, **nz)
            mag = gather_segment_sum_ref(vn.abs(), perm_g, slot_g, **nz)
            r = float(((got - want).abs() / (EPS32 * mag).clamp(
                min=1e-30)).max())
            require(r <= C_SEG, f"B3' error {r} eps x sum|terms| > "
                    f"{C_SEG} on the routed stream")
            row["B3_routed_stream"] = {"integer": "bit-identical",
                                       "max_err_over_eps_sum_abs": r}
        del pat, single, rows, cols, v
        torch.cuda.empty_cache()
    row["times"] = times

    # a skewed stream overflows the default capacity and raises
    ii, jj, ss, siz = sets["1"]
    try:
        fsparse(ii % max(siz // 4, 1) + 1, jj, ss, (siz, siz),
                method="sharded", mesh=make_data_mesh(4))
    except ValueError as e:
        require("overflow" in str(e), f"overflow raised {e!r}")
    else:
        fail("a skewed stream did not overflow the sharded buckets")
    row["overflow"] = "ValueError raised"

    # sparse2: a miss, a hit (one fill, no plan kernel), a miss on another
    # p; PlanService of a sharded request
    plan_cache_clear()
    ii, jj, ss, siz = sets["3"]
    before = counts()
    S1 = sparse2(ii, jj, ss, (siz, siz), method="sharded",
                 mesh=make_data_mesh(4))
    mid = counts()
    S2 = sparse2(ii, jj, ss, (siz, siz), method="sharded",
                 mesh=make_data_mesh(4))
    hit = counts()
    S3 = sparse2(ii, jj, ss, (siz, siz), method="sharded")
    info = plan_cache_info()
    require((info["misses"], info["hits"]) == (2, 1),
            f"sparse2 sharded cache {info}, expected 2 misses and 1 hit")
    require(hit["B1"] == mid["B1"] and hit["B3"] == mid["B3"] + 1
            and mid["B1"] > before["B1"] and hit["P34"] == mid["P34"]
            and mid["P34"] == before["P34"] + 4,
            "the sharded sparse2 hit ran a plan kernel or no fill, or the "
            "miss did not run one P34 a block")
    require(torch.equal(S1.data, S2.data)
            and torch.equal(convert(S1, "csc").data[:int(S1.nnz.sum())],
                            convert(S3, "csc").data[:int(S3.nnz.sum())]),
            "sparse2 sharded results differ")
    svc = PlanService()
    A = svc.assemble(ii, jj, ss, (siz, siz), method="sharded")
    require(torch.equal(A.data, S3.data)
            and svc.stats()["graphs"]["captures"] == {},
            "PlanService's sharded request differs or was captured")
    row["sparse2"] = {"misses": 2, "hits": 1}
    row["plan_service"] = "equal to sparse2, uncaptured"
    plan_cache_clear()
    del S1, S2, S3, A, svc
    torch.cuda.empty_cache()

    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4G_LIMIT_S,
            f"phase 4g took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4G_LIMIT_S} s")
    return launches


#: phase 4h's time limit, in seconds
PHASE_4H_LIMIT_S = 120
#: phase 4h: the LM serving path on OLMoE-1B-7B (arXiv:2409.02060) at
#: full width and depth, bf16, served as ``repro_torch.launch.serve``
#: would be: batch 4, prompts of 512, 32 tokens, 8 requests
LM_ARCH = "olmoe_1b_7b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_REQUESTS = 4, 512, 32, 8
#: one B12 and one B11 launch per MoE layer call: 16 layers x (the
#: prefill + 31 decode steps) x 2 batches = 1,024 each
LM_DISPATCH_CALLS = 16 * LM_GEN * (LM_REQUESTS // LM_BATCH)
#: (c) a one-layer float32 OLMoE's prefill logits on the card within
#: LM_F32_RTOL * max|logit| of the CPU's (the two sides' float32
#: matmuls add in other orders; the CPU tests measure about 1e-6 against
#: the reference)
LM_F32_RTOL = 1e-4
#: (d) decode_step after prefill(..., extra_cache=1) against forward at
#: the last position, 16 layers in bf16: within LM_BF16_RTOL *
#: max|logit| (about six bf16 eps of 2^-7: the two paths round
#: attention and the expert GEMMs' rows in other orders, through 16
#: layers)
LM_BF16_RTOL = 5e-2
#: (d) the same on LM_DECODE_F32_LAYERS layers at full width in float32:
#: within LM_F32_DECODE_RTOL * max|logit|, a limit that a step at the
#: wrong position or one that ignores the cache must exceed
LM_DECODE_F32_LAYERS = 2
LM_F32_DECODE_RTOL = 1e-4
#: (e) the embedding gradient's size: the padded vocabulary, 2,048
#: tokens of 2,048 features
LM_GRAD_TOKENS = 2048


def device_profile(fn, k: int = 10) -> tuple[list, list]:
    """One profiled call of ``fn()`` (``torch.profiler``, after one call
    unprofiled), read off the profiler's raw events rather than
    ``key_averages()`` (which builds a Python object an event: tens of
    seconds for a train step's hundreds of thousands).  Returns the
    CUDA kernels and copies of the call as ``(name, ms, launches)`` by
    device time, most first: the device's busy time, without the
    operators' device annotations (``aten::mul`` on the device's
    timeline), which span the kernels they launch; and the ``k``
    operators that launch the most device time themselves, as ``(name,
    ms, calls)``: each kernel counts for the operator its launch is
    correlated with (the profiler's ``self_device_time_total``)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    op_of = {e.correlation_id(): e.name() for e in events
             if e.device_type() != cuda}
    kern, ops = {}, {}
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        ms = e.duration_ns() / 1e6
        name = e.name()[:60]
        t = kern.setdefault(name, [0.0, 0])
        t[0] += ms
        t[1] += 1
        op = op_of.get(e.linked_correlation_id())
        if op is not None:
            t = ops.setdefault(op, [0.0, set()])
            t[0] += ms
            t[1].add(e.linked_correlation_id())
    require(not any(n.startswith("aten::") for n in kern),
            "an operator's device annotation is counted as a kernel")
    kernels = sorted(((n, ms, c) for n, (ms, c) in kern.items()),
                     key=lambda r: -r[1])
    top = sorted(((n, ms, len(c)) for n, (ms, c) in ops.items()),
                 key=lambda r: -r[1])[:k]
    return kernels, top


def embedding_grad_check(V: int, D: int, kernels, dev, rng) -> dict:
    """The embedding gradient through ``sparse_grad_embed`` at ``V``
    rows, ``LM_GRAD_TOKENS`` tokens (half among 64 ids, half over the
    vocabulary) and ``D`` features, on the card against the CPU (the
    plain versions): bit for bit on integer-valued gradients, within
    ``2 (n - 1) eps sum|g|`` on random ones; B12 and B11 once each a
    backward on the card.  Returns what it measured."""
    from repro_torch.train import sparse_grad_embed

    head = rng.integers(0, 64, LM_GRAD_TOKENS)
    tail = rng.integers(0, V, LM_GRAD_TOKENS)
    tg = torch.from_numpy(np.where(rng.random(LM_GRAD_TOKENS) < 0.5, head,
                                   tail).astype(np.int32))
    grads = {}
    for kind in ("integer", "random"):
        g = rng.integers(-64, 64, (LM_GRAD_TOKENS, D)) if kind == "integer" \
            else rng.standard_normal((LM_GRAD_TOKENS, D))
        g = torch.from_numpy(g.astype(np.float32))
        res = []
        for d in (dev, torch.device("cpu")):
            table = torch.zeros((V, D), device=d, requires_grad=True)
            before = (kernels["B12"].launches, kernels["B11"].launches)
            (sparse_grad_embed(table, tg.to(d)) * g.to(d)).sum().backward()
            if d.type == "cuda":
                require((kernels["B12"].launches - before[0],
                         kernels["B11"].launches - before[1]) == (1, 1),
                        "the embedding backward did not run B12 and B11 "
                        "once each")
            res.append(table.grad.cpu())
        if kind == "integer":
            dense = torch.zeros((V, D)).index_add_(0, tg.long(), g)
            require(torch.equal(res[0], res[1]) and torch.equal(res[1], dense),
                    "the integer-valued embedding gradient differs")
            grads[kind] = "bit-identical"
        else:
            n = torch.bincount(tg.long(), minlength=V)[:, None].double()
            abs_sum = torch.zeros((V, D), dtype=torch.float64).index_add_(
                0, tg.long(), g.abs().double())
            bound = 2 * (n - 1).clamp(min=0) * EPS32 * abs_sum
            over = ((res[0] - res[1]).abs().double() / bound.clamp(
                min=1e-300)).max()
            require(bool(((res[0] - res[1]).abs().double() <= bound).all()),
                    "the embedding gradient exceeds 2 (n - 1) eps sum|g|")
            grads[kind] = {"max_err_over_bound": float(over)}
    return {"V": V, "T": LM_GRAD_TOKENS, "D": D, **grads}


def dispatch_by_argsort(e: torch.Tensor, n_experts: int, capacity: int):
    """The reference's dispatch (``repro/models/moe.py:42-65``) in plain
    PyTorch: a stable argsort, ``bincount`` and ``searchsorted``."""
    L = e.shape[0]
    order = torch.argsort(e, stable=True)
    es = e[order]
    load = torch.bincount(e, minlength=n_experts).to(torch.int32)
    starts = torch.searchsorted(
        es, torch.arange(n_experts, dtype=es.dtype, device=e.device))
    within = torch.arange(L, device=e.device) - starts[es]
    slot_sorted = torch.where(within < capacity, es * capacity + within,
                              n_experts * capacity).to(torch.int32)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return slot, load


def serve_watched(arch: str, cfg, params, kernels, dev, phase: str) -> dict:
    """``repro_torch.launch.serve.main --arch arch`` in-process on the
    model ``params`` of ``cfg`` (batch LM_BATCH, prompts of LM_PROMPT, LM_GEN
    tokens, LM_REQUESTS requests), every launch counter set to 0 just
    before.  Fails unless it returns 0 after one prefill a batch and
    LM_GEN - 1 decode steps after each, every logit finite and every
    token in [0, vocab).  Returns the printed lines, the launch counts
    of the run and the tok/s it printed."""
    import contextlib
    import io
    import re

    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as lm

    seen = {"prefills": 0, "decodes": 0, "tokens": [],
            "bad": torch.zeros((), dtype=torch.bool, device=dev)}

    def served_init(cfg_, *, seed, device):
        require(cfg_ == cfg and seed == SEED and torch.device(device) == dev,
                "serve asked for another model than the one built")
        return params

    def watched_prefill(*a, **kw):
        logits, cache = lm.prefill(*a, **kw)
        seen["prefills"] += 1
        seen["bad"] = seen["bad"] | ~torch.isfinite(logits).all()
        return logits, cache

    def watched_decode(params_, cache, tokens, cfg_):
        logits, cache = lm.decode_step(params_, cache, tokens, cfg_)
        seen["decodes"] += 1
        seen["tokens"].append(tokens)
        seen["bad"] = seen["bad"] | ~torch.isfinite(logits).all()
        return logits, cache

    argv = ["--arch", arch, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--requests",
            str(LM_REQUESTS), "--seed", str(SEED)]
    hooks = {"init_model": served_init, "prefill": watched_prefill,
             "decode_step": watched_decode}
    saved = {k: getattr(serve_mod, k) for k in hooks}
    out = io.StringIO()
    for f in kernels.values():
        f.launches = 0
    try:
        for k, f in hooks.items():
            setattr(serve_mod, k, f)
        with contextlib.redirect_stdout(out):
            rc = serve_mod.main(argv)
        torch.cuda.synchronize()
    finally:
        for k, f in saved.items():
            setattr(serve_mod, k, f)
    launches = {k: f.launches for k, f in kernels.items()}
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"phase {phase}: {line}", flush=True)
    require(rc == 0, f"serve.main returned {rc}")
    n_batches = LM_REQUESTS // LM_BATCH
    require(seen["prefills"] == n_batches
            and seen["decodes"] == n_batches * (LM_GEN - 1),
            f"served {seen['prefills']} prefills and {seen['decodes']} "
            "decode steps")
    require(not bool(seen["bad"]), "a served logit is not finite")
    fed = torch.cat(seen["tokens"])
    require(fed.shape == (n_batches * (LM_GEN - 1) * LM_BATCH, 1)
            and int(fed.min()) >= 0 and int(fed.max()) < cfg.vocab,
            "a generated token lies outside [0, vocab)")
    samples = [int(t) for line in lines if "sample row0:" in line
               for t in re.findall(r"-?\d+", line.split("sample row0:")[1])]
    require(len(samples) == 8 * n_batches
            and all(0 <= t < cfg.vocab for t in samples),
            "the printed sample rows are not tokens in [0, vocab)")
    m = re.search(r"\(([\d.]+) tok/s incl\. prefill\)", lines[-1])
    require(m is not None, "serve printed no tok/s line")
    return {"lines": lines, "launches": launches,
            "tok_per_s": float(m.group(1))}


def rank_serve_prompts(cfg) -> np.ndarray:
    """Phase 4o (d)'s request batch: LM_BATCH prompts of LM_PROMPT
    tokens, the same on every rank and in 4h's one-process run."""
    rng = np.random.default_rng([SEED, 41])
    return rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)


def greedy_margins(logits, vocab: int):
    """``(tokens [B, 1], top-2 margins [B], max|logit|)`` of one step's
    last-position logits over the first ``vocab`` entries."""
    x = logits[:, -1, :vocab].float()
    top2 = torch.topk(x, 2, dim=-1).values
    return (torch.argmax(x, dim=-1, keepdim=True), top2[:, 0] - top2[:, 1],
            x.abs().amax())


def rank_serve_reference(params, cfg, dev) -> dict:
    """One request batch of :func:`rank_serve_prompts` served greedily on
    one process (RANK_SERVE_GEN tokens, two token groups: one a data
    shard of the rank mesh), its attention output projection summed as
    the (2, 2) mesh sums it (:func:`tp2_out_proj`), written to
    ``build/`` RANK_SERVE_REF for phase 4o (d): each step's last-position
    logits (the prefill's first), the tokens, each step's top-2 margins
    and max|logit|; and the prefill's logits summed as one process sums
    them (``prefill_plain``)."""
    from repro_torch.models import attention as attn_mod

    prompts = torch.from_numpy(rank_serve_prompts(cfg)).to(dev)
    plain, _, _, _ = _greedy(params, cfg, prompts, 1, attn_mod._out_proj)
    lasts, toks, margins, peaks = _greedy(params, cfg, prompts,
                                          RANK_SERVE_GEN, tp2_out_proj)
    first, plain = lasts[:, 0], plain[:, 0]
    out = {"logits": lasts.numpy(), "prefill_plain": plain.numpy(),
           "tokens": toks.numpy(), "margins": margins.numpy(),
           "peaks": peaks.numpy()}
    (ROOT / "build").mkdir(exist_ok=True)
    np.savez(ROOT / "build" / RANK_SERVE_REF, **out)
    return {"tokens_row0": out["tokens"][0].tolist(),
            "min_margin": float(out["margins"].min()),
            "tp2_vs_plain_rel_err": _rel_err(first, plain)}


def _greedy(params, cfg, prompts, gen: int, out_proj):
    """``prefill`` and greedy decode to ``gen`` tokens on one process with
    RANK_MESH[0] token groups and ``out_proj`` as the attention's output
    projection: ``(each step's last-position logits [B, gen, vocab],
    tokens [B, gen], top-2 margins [B, gen], max|logit| [gen])`` on the
    host."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags

    saved = attn_mod._out_proj
    attn_mod._out_proj = out_proj
    runtime_flags.set_moe_groups(RANK_MESH[0])
    try:
        with torch.inference_mode():
            logits, cache = lm.prefill(params, {"tokens": prompts}, cfg,
                                       kv_chunk=prompts.shape[1])
            lasts, toks, margins, peaks = [], [], [], []
            for i in range(gen):
                if i:
                    logits, cache = lm.decode_step(
                        params, cache, toks[-1].to(torch.int32), cfg)
                lasts.append(logits[:, -1, :cfg.vocab].float().cpu())
                tok, margin, peak = greedy_margins(logits, cfg.vocab)
                toks.append(tok)
                margins.append(margin)
                peaks.append(peak)
    finally:
        attn_mod._out_proj = saved
        runtime_flags.set_moe_groups(1)
    return (torch.stack(lasts, 1), torch.cat(toks, 1).cpu(),
            torch.stack(margins, 1).cpu(), torch.stack(peaks).cpu())


def tp2_out_proj(params, o, B, S):
    """``attention._out_proj`` as a mesh of two ``model`` ranks sums it:
    each rank's half of the heads against its rows of ``o_out`` (each
    product rounded to the model's dtype), the two added in that
    dtype."""
    w = params["o_out"]
    x = o.reshape(B, S, -1)
    h = w.shape[0] // 2
    return torch.matmul(x[..., :h], w[:h]) + torch.matmul(x[..., h:], w[h:])


def lm_serving_phase(dev, kernels, cpm, smi_line) -> dict:
    """Phase 4h: the LM serving path (the module docstring).  Returns the
    launches of its main path, the served run."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.sparse.ops import scatter_rows

    t_phase = time.perf_counter()
    row = {"phase": "4h", "card": smi_line, "arch": LM_ARCH,
           "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
                     "requests": LM_REQUESTS}}
    cfg = get_config(LM_ARCH)
    E, K, V = cfg.moe.n_experts, cfg.moe.top_k, cfg.padded_vocab
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (a) the real server: init_model on the card, then serve.main
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = lm.init_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    row["params"] = sum(p.numel() for p in params.parameters())
    row["weights_GB"] = weight_bytes / 1e9
    row["memory_allocated_GB"] = (torch.cuda.memory_allocated() - base) / 1e9
    print(f"phase 4h: {LM_ARCH} {row['params']} parameters, "
          f"memory_allocated {row['memory_allocated_GB']:.3f} GB; "
          f"{smi_line}", flush=True)
    require(abs(row["memory_allocated_GB"] - weight_bytes / 1e9) < 0.1,
            "init_model allocated more than its weights")

    served = serve_watched(LM_ARCH, cfg, params, kernels, dev, "4h")
    launches = served["launches"]
    expected = {k: LM_DISPATCH_CALLS if k in ("B11", "B12") else 0
                for k in kernels}
    row["served_lines"] = served["lines"]
    row["launches"], row["expected"] = launches, expected
    require(launches == expected, f"phase 4h launch counts {launches} != "
            f"{expected} (one B12 and one B11 per MoE layer call)")
    row["tok_per_s"] = served["tok_per_s"]
    row["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    row["max_memory_allocated_over_start_GB"] = \
        (torch.cuda.max_memory_allocated() - base) / 1e9
    # the one-process answers phase 4o (d) holds the rank mesh to, on
    # the same model: no fifth model is drawn there
    row["rank_serve_reference"] = rank_serve_reference(params, cfg, dev)

    # (b) the dispatch bit for bit: layer 0's expert ids in one prefill
    # and one decode step, on the card against the plain route (the CPU)
    # and the reference's algorithm (stable argsort) on the card
    rng = np.random.default_rng(SEED + 23)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        LM_BATCH, LM_PROMPT + 1)).astype(np.int32)).to(dev)
    captured = []
    group_dispatch = moe_mod._group_dispatch

    def capture(expert_ids, **kw):
        captured.append(expert_ids.reshape(-1).clone())
        return group_dispatch(expert_ids, **kw)

    moe_mod._group_dispatch = capture
    try:
        with torch.inference_mode():
            logits, cache = lm.prefill(params, {"tokens": toks[:, :-1]}, cfg,
                                       kv_chunk=LM_PROMPT)
            lm.decode_step(params, cache, toks[:, -1:], cfg)
    finally:
        moe_mod._group_dispatch = group_dispatch
    keys = {"prefill": captured[0].to(torch.int32),
            "decode": captured[cfg.n_layers].to(torch.int32)}
    require(keys["prefill"].shape[0] == LM_BATCH * LM_PROMPT * K
            and keys["decode"].shape[0] == LM_BATCH * K,
            "the captured expert ids have unexpected lengths")
    checks = {}
    for what, e in keys.items():
        C = moe_mod._capacity(cfg, e.shape[0] // K)
        got = moe_mod.moe_dispatch_indices(e, n_experts=E, capacity=C)
        plain = moe_mod.moe_dispatch_indices(e.cpu(), n_experts=E,
                                             capacity=C)
        ref = dispatch_by_argsort(e.long(), E, C)
        for a, b, c in zip(got, plain, ref):
            require(torch.equal(a.cpu(), b) and torch.equal(a, c),
                    f"the {what} dispatch differs from the plain route or "
                    "the stable argsort")
        # G = 4 groups, keys g * E + e over 256 bins
        G = 4
        Cg = moe_mod._capacity(cfg, e.shape[0] // K // G)
        eg = e.reshape(G, -1)
        got = moe_mod._group_dispatch(eg, n_experts=E, capacity=Cg, groups=G)
        plain = moe_mod._group_dispatch(eg.cpu(), n_experts=E, capacity=Cg,
                                        groups=G)
        for g in range(G):
            ref = dispatch_by_argsort(eg[g].long(), E, Cg)
            require(all(torch.equal(a[g], c) for a, c in zip(got, ref)),
                    f"group {g} of the {what} dispatch differs from its "
                    "stable argsort")
        require(all(torch.equal(a.cpu(), b) for a, b in zip(got, plain)),
                f"the grouped {what} dispatch differs from the plain route")
        dropped = int((got[0] >= E * Cg).sum())
        checks[what] = {"L": int(e.shape[0]), "capacity": C,
                        "groups4_capacity": Cg, "groups4_dropped": dropped,
                        "slot_load": "bit-identical"}
    row["dispatch"] = checks

    # (c) the full width against the CPU: a one-layer float32 OLMoE, the
    # same weights on both sides
    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    p_cpu = lm.init_model(cfg1, seed=SEED, device="cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 128)).astype(
        np.int32))
    with torch.inference_mode():
        want, _ = lm.prefill(p_cpu, {"tokens": t1}, cfg1, kv_chunk=128)
        got, _ = lm.prefill(p_dev, {"tokens": t1.to(dev)}, cfg1,
                            kv_chunk=128)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    row["f32_one_layer_rel_err"] = err
    require(err <= LM_F32_RTOL, f"the one-layer float32 prefill on the card "
            f"is {err:.3g} of max|logit| from the CPU's (limit "
            f"{LM_F32_RTOL})")
    del p_cpu, p_dev, want, got

    # (d) decode against forward, nothing dropped: the 16-layer bf16
    # model, and a float32 copy of a few layers at full width whose tight
    # limit must fail two planted faults (a step one position on, a step
    # that ignores the cache)
    cfg_d = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / K))
    cfg_f = dataclasses.replace(cfg_d, n_layers=LM_DECODE_F32_LAYERS,
                                dtype="float32")
    S = 64
    td = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S + 1)).astype(
        np.int32)).to(dev)

    def decode_errs(p, cfg_x) -> dict:
        with torch.inference_mode():
            full, _ = lm.forward(p, {"tokens": td}, cfg_x, kv_chunk=S + 1)
            _, c = lm.prefill(p, {"tokens": td[:, :S]}, cfg_x, kv_chunk=S,
                              extra_cache=1)
            want = full[:, -1].float()
            out = {}
            for what, c_x in (
                    ("sound", c),
                    ("pos_plus_1", dict(c, pos=c["pos"] + 1)),
                    ("cache_zeroed", dict(c, k=torch.zeros_like(c["k"]),
                                          v=torch.zeros_like(c["v"])))):
                step, _ = lm.decode_step(p, c_x, td[:, S:], cfg_x)
                got = step[:, 0].float()
                out[what] = {
                    "rel_err": float((got - want).abs().max()
                                     / want.abs().max()),
                    "argmax_equal": bool(torch.equal(got.argmax(-1),
                                                     want.argmax(-1)))}
        return out

    dec = {"bf16_16_layers": decode_errs(params, cfg_d)}
    with torch.inference_mode():
        p_f = lm.init_model(cfg_f, seed=SEED, device=dev)
    dec[f"f32_{LM_DECODE_F32_LAYERS}_layers"] = decode_errs(p_f, cfg_f)
    del p_f
    row["decode_vs_forward"] = dec
    for name, limit in ((f"f32_{LM_DECODE_F32_LAYERS}_layers",
                         LM_F32_DECODE_RTOL),
                        ("bf16_16_layers", LM_BF16_RTOL)):
        r = dec[name]
        require(r["sound"]["rel_err"] <= limit, f"decode_step ({name}) is "
                f"{r['sound']['rel_err']:.3g} of max|logit| from forward "
                f"(limit {limit})")
        for fault in ("pos_plus_1", "cache_zeroed"):
            require(r[fault]["rel_err"] > limit, f"the planted fault "
                    f"{fault} ({name}) reads {r[fault]['rel_err']:.3g}, "
                    f"within the limit {limit}: the check cannot tell it "
                    "from a sound step")

    # (e) the embedding gradient at the full vocabulary, on the card
    # against the CPU
    row["embedding_grad"] = embedding_grad_check(V, cfg.d_model, kernels,
                                                 dev, rng)

    # (f) times: prefill, a decode step against its byte bound, the
    # dispatch against the library sort, the top kernels
    with torch.inference_mode():
        batch = {"tokens": toks[:, :-1]}

        def prefill_fn():
            return lm.prefill(params, batch, cfg, kv_chunk=LM_PROMPT)

        _, cache = prefill_fn()
        tok = toks[:, -1:]

        def decode_fn():
            return lm.decode_step(params, cache, tok, cfg)

        row["prefill_ms"] = call_ms(prefill_fn, reps=5)
        row["prefill_device_ms"] = device_ms(prefill_fn, cpm, reps=5)
        row["decode_ms"] = call_ms(decode_fn, reps=10)
        row["decode_device_ms"] = device_ms(decode_fn, cpm, reps=10)
        cache_bytes = sum(cache[k].numel() * cache[k].element_size()
                          for k in ("k", "v"))
        # the capacity-buffer algorithm's bytes: every expert's weights
        # pass through the [E, C, D] einsums
        row["decode_bytes"] = weight_bytes + cache_bytes
        row["decode_bound_ms"], row["decode_bound_by"] = bound_ms(
            weight_bytes + cache_bytes, 0)
        # the step's own bytes: only the experts it routes to, layer by
        # layer (the same step's expert ids, captured in (b))
        moe0 = params["layers"][0]["moe"]
        expert_bytes = sum(moe0[n].numel() * moe0[n].element_size()
                           for n in ("gate_ein", "up_ein", "down_eout"))
        routed = [int(torch.unique(captured[cfg.n_layers + i]).numel())
                  for i in range(cfg.n_layers)]
        routed_bytes = (weight_bytes - cfg.n_layers * expert_bytes
                        + sum(routed) * expert_bytes // E + cache_bytes)
        row["decode_routed_experts"] = routed
        row["decode_routed_bytes"] = routed_bytes
        row["decode_routed_bound_ms"], _ = bound_ms(routed_bytes, 0)
        # the profiler's kernels of one call (CUDA events only, not the
        # operators that launched them): the device's busy time; the
        # back-to-back device figures above are host-bound when the host
        # enqueues slower than the card runs
        for what, fn in (("decode", decode_fn), ("prefill", prefill_fn)):
            kern, _ = device_profile(fn)
            row[f"{what}_kernel_ms"] = sum(ms for _, ms, _ in kern)
            row[f"{what}_kernel_launches"] = sum(c for _, _, c in kern)
            row[f"{what}_top_kernels"] = [[n, ms] for n, ms, _ in kern[:6]]
            row[f"{what}_busy_share"] = row[f"{what}_kernel_ms"] / \
                row[f"{what}_ms"]
        x = torch.randn((LM_BATCH * LM_PROMPT, cfg.d_model), device=dev,
                        dtype=torch.bfloat16)
        for what, e in keys.items():
            C = moe_mod._capacity(cfg, e.shape[0] // K)
            rows = x[torch.arange(e.shape[0], device=dev) // K]
            el = e.long()  # the yardstick's keys

            def ours():
                slot, _ = moe_mod.moe_dispatch_indices(e, n_experts=E,
                                                       capacity=C)
                return scatter_rows(slot, rows, num_slots=E * C)

            def library():
                slot, _ = dispatch_by_argsort(el, E, C)
                return scatter_rows(slot, rows, num_slots=E * C)

            for name, fn in (("dispatch", ours), ("library", library)):
                row[f"{name}_{what}_ms"] = call_ms(fn)
                row[f"{name}_{what}_device_ms"] = device_ms(fn, cpm)
            nbins, L = E, e.shape[0]
            bb = default_block_b(nbins, L=L)
            offsets, _ = block_offsets(e, nbins=nbins, block_b=bb)
            row[f"B12_{what}_ms"] = device_ms(lambda: kernels["B12"](
                e, nbins=nbins, block_b=bb), cpm)
            row[f"B11_{what}_ms"] = device_ms(lambda: kernels["B11"](
                e, offsets, nbins=nbins, block_b=bb), cpm)
    del params, cache, x, keys, captured
    torch.cuda.empty_cache()

    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4H_LIMIT_S,
            f"phase 4h took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4H_LIMIT_S} s")
    return launches


#: phase 4i's time limit, in seconds
PHASE_4I_LIMIT_S = 120
#: phase 4i: the LM training path on OLMoE-1B-7B at full width, cut to
#: TRAIN_LAYERS of its 16 layers for the train state's memory (18 B a
#: parameter: bf16 weights, float32 master, mu, nu and ef; 16 layers
#: would hold 122.7 GB before any gradient), trained TRAIN_STEPS steps
#: of TRAIN_MICROBATCHES microbatches on one repeated SyntheticLM batch
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES, TRAIN_STEPS = 8, 512, 2, 8
#: one B12 and one B11 launch per MoE layer call in the forward and in
#: the backward's recompute, and one each for the embedding gradient,
#: per microbatch: 8 x 2 x (4 + 4 + 1) = 144
TRAIN_DISPATCH_CALLS = TRAIN_STEPS * TRAIN_MICROBATCHES * (
    2 * TRAIN_LAYERS + 1)
#: (c) a one-layer float32 OLMoE at full width, the same weights on the
#: card and on the CPU: the loss within TRAIN_F32_RTOL of the CPU's,
#: every gradient leaf within TRAIN_F32_RTOL of its largest magnitude
#: (the two sides' float32 matmuls add in other orders; the CPU tests
#: measure about 2e-6 against the reference)
TRAIN_F32_RTOL = 1e-4
#: (c) in the ssm and hybrid families the gradients of the scan's decay
#: parameters (``a_log``, ``dt_bias``) sum every position's contribution
#: with heavy cancellation: two float32 runs on the CPU alone, on 1 and
#: on 4 threads, differ by 4.3e-5 (``a_log``) and 8.5e-6 (``dt_bias``)
#: of the leaf's largest, against at most 8.4e-7 for every other leaf
#: (one Mamba2 layer at full width, S = 259).  Those two leaves are held
#: to TRAIN_DECAY_RTOL, the others to TRAIN_F32_RTOL
TRAIN_DECAY_RTOL = 1e-3
DECAY_LEAVES = ("a_log", "dt_bias")
#: (c) adamw_update on the same handed-over gradients: master, mu, nu and
#: the new parameters within TRAIN_OPT_RTOL of each leaf's largest.  The
#: sides differ in the global norm's summation order (its relative
#: difference dn, printed, moves the clipped gradient, so mu and master
#: by dn and nu by 2 dn) and in the last bit of CUDA's pow and of a
#: division by a host scalar (a multiplication by its reciprocal on the
#: card), each a few float32 eps of the update
TRAIN_OPT_RTOL = 1e-5
#: (d) the launcher resumed against an uninterrupted run: each step's
#: loss within TRAIN_RESUME_RTOL (the same batches and state; the card
#: adds index_add_ and the combine gather's backward in no fixed order)
TRAIN_RESUME_RTOL = 1e-5
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the
#: step's FLOP bound
BF16_FLOPS_PER_S = 989e12


def train_step_flops(cfg, tokens: int, capacity: int, seq: int) -> dict:
    """The FLOPs of one train step on ``tokens`` tokens of ``seq``, as
    the port computes it: every MoE layer's expert einsums run on the
    ``[E, C]`` capacity buffers (``capacity`` slots an expert per
    microbatch of ``tokens / microbatches`` tokens), chunked attention
    runs every key chunk of the sequence, the blocks are computed twice
    (forward and remat's recompute) and the backward costs twice the
    forward."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    E, F_ = cfg.moe.n_experts, cfg.moe.d_expert
    per_mb = tokens // TRAIN_MICROBATCHES
    proj = D * (H + 2 * Hkv) * Dh + H * Dh * D
    attn = 2 * seq * H * Dh
    experts = E * capacity * 3 * D * F_ / per_mb   # per token, buffers
    layer = 2 * (proj + attn + D * E + experts)    # FLOPs a token
    head = 2 * D * cfg.padded_vocab
    forward = cfg.n_layers * layer + head
    total = tokens * (forward + cfg.n_layers * layer + 2 * forward)
    return {"forward_flop_per_token": forward, "step_flop": total}


def train_parity(cfg1, batch, dev, ocfg) -> tuple[dict, dict]:
    """A float32 model of ``cfg1``, the same weights on the card and on
    the CPU (drawn on the card, copied to the CPU): ``loss_fn`` on
    ``batch`` within TRAIN_F32_RTOL of the CPU's, every gradient leaf
    within TRAIN_F32_RTOL of its largest magnitude (DECAY_LEAVES within
    TRAIN_DECAY_RTOL); then ``adamw_update`` (``ocfg``) on the CPU's
    gradients handed to both, master, mu, nu and the new parameters
    within TRAIN_OPT_RTOL of each leaf's largest.  Returns the two sets
    of errors.  The card's results stay on the card and each CPU leaf is
    compared there (:func:`_rel_err`): the CPU's own passes over the
    float32 trees are what the phases that call this wait for."""
    import copy

    from repro_torch.models import model as lm
    from repro_torch.models.layers import (stacked_leaves, tree_leaves,
                                           tree_unflatten)
    from repro_torch.train import optimizer as opt_mod

    t0 = time.perf_counter()
    p_dev = lm.init_model(cfg1, seed=SEED, device=dev)
    p_cpu = copy.deepcopy(p_dev).to("cpu")
    S = batch["tokens"].shape[1]
    sides = (("cpu", p_cpu, torch.device("cpu")), ("cuda", p_dev, dev))
    side, stage = {}, {"init": time.perf_counter() - t0}
    for name, p, d in sides:
        t1 = time.perf_counter()
        loss = lm.loss_fn(p, {k: v.to(d) for k, v in batch.items()}, cfg1,
                          kv_chunk=S)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        side[name] = (float(loss.detach()), list(grads))
        stage[f"grad_{name}"] = time.perf_counter() - t1
    (l_cpu, g_cpu), (l_dev, g_dev) = side["cpu"], side["cuda"]
    by_leaf = {  # each block's tensor against its own largest
        n: max(_rel_err(a, b) for a, b in zip(pa, pb))
        for (n, pa, _), (_, pb, _) in zip(
            stacked_leaves(tree_unflatten(p_dev, g_dev)),
            stacked_leaves(tree_unflatten(p_cpu, g_cpu)))}
    decay = {n: e for n, e in by_leaf.items()
             if n.rsplit("/", 1)[-1] in DECAY_LEAVES}
    grad_err = max(e for n, e in by_leaf.items() if n not in decay)
    errs = {"loss_rel_err": abs(l_dev - l_cpu) / abs(l_cpu),
            "grad_rel_err": grad_err,
            "worst_leaves": sorted(by_leaf.items(), key=lambda x: -x[1])[:3]}
    if decay:
        errs["decay_grad_rel_err"] = decay
    require(abs(l_dev - l_cpu) <= TRAIN_F32_RTOL * abs(l_cpu),
            f"loss_fn on the card {l_dev} vs the CPU's {l_cpu}")
    require(grad_err <= TRAIN_F32_RTOL, f"a gradient leaf on the card is "
            f"{grad_err:.3g} of its max from the CPU's (limit "
            f"{TRAIN_F32_RTOL}): {errs['worst_leaves']}")
    require(all(e <= TRAIN_DECAY_RTOL for e in decay.values()),
            f"a decay gradient on the card differs from the CPU's: {decay} "
            f"(limit {TRAIN_DECAY_RTOL})")
    upd = {}
    for name, p, d in sides:
        t1 = time.perf_counter()
        opt = opt_mod.init_opt_state(p, ocfg)
        g = [x.to(d) for x in g_cpu]  # the CPU's gradients, handed over
        newp, opt, om = opt_mod.adamw_update(tree_unflatten(p, g), opt,
                                             ocfg)
        upd[name] = (tree_leaves(newp),
                     {k: tree_leaves(opt[k]) for k in ("master", "mu", "nu")},
                     float(om["grad_norm"]), float(om["lr"]))
        stage[f"adamw_{name}"] = time.perf_counter() - t1
    dn = abs(upd["cuda"][2] / upd["cpu"][2] - 1)
    opt_err = {}
    for k in ("master", "mu", "nu"):
        opt_err[k] = max(_rel_err(a, b) for a, b in zip(upd["cuda"][1][k],
                                                        upd["cpu"][1][k]))
    opt_err["params"] = max(_rel_err(a, b)
                            for a, b in zip(upd["cuda"][0], upd["cpu"][0]))
    require(all(v <= TRAIN_OPT_RTOL for v in opt_err.values()),
            f"adamw_update on the card differs from the CPU's: {opt_err} "
            f"(limit {TRAIN_OPT_RTOL})")
    errs["s"] = {"total": time.perf_counter() - t0, **stage}
    return errs, {"grad_norm_rel_diff": dn,
                  "lr": [upd["cuda"][3], upd["cpu"][3]],
                  **{f"{k}_rel_err": v for k, v in opt_err.items()}}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|``, on ``got``'s device (``want``
    copied there)."""
    want = want.to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def launcher_resume(arch: str, dev, phase: str) -> dict:
    """``repro_torch.launch.train.main`` in-process on ``arch
    --reduced``: 6 steps, a resumed call to 9, an uninterrupted run to
    9, each step's loss within TRAIN_RESUME_RTOL of the uninterrupted
    run's; then the final state saved and restored bit for bit."""
    import contextlib
    import io
    import signal
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launch
    from repro_torch.models import model as lm
    from repro_torch.models.layers import stacked_leaves
    from repro_torch.train import train_step as ts_mod

    recorded = {}
    make_step = train_launch.make_train_step

    def recording_step(cfg_, tcfg_):
        inner = make_step(cfg_, tcfg_)

        def run(state_, batch_):
            state_, m_ = inner(state_, batch_)
            recorded["losses"].append(float(m_["loss"]))
            recorded["state"] = state_
            return state_, m_
        return run

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "32",
            "--ckpt-every", "3", "--log-every", "1", "--seed", str(SEED)]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="repro-train-") as tmp:
        train_launch.make_train_step = recording_step
        try:
            for name, steps, ckpt in (("first", 6, "a"), ("resumed", 9, "a"),
                                      ("whole", 9, "b")):
                recorded["losses"] = []
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = train_launch.main(argv + [
                        "--steps", str(steps), "--ckpt-dir",
                        f"{tmp}/{ckpt}"])
                require(rc == 0, f"launch.train.main ({name}) returned {rc}")
                for line in out.getvalue().splitlines():
                    print(f"phase {phase} ({name}): {line}", flush=True)
                runs[name] = (list(recorded["losses"]), out.getvalue())
        finally:
            train_launch.make_train_step = make_step
            for s, h in handlers.items():
                signal.signal(s, h)
        require("[train] resumed from step 6" in runs["resumed"][1],
                "the second call did not resume from step 6")
        joined = runs["first"][0] + runs["resumed"][0]
        whole = runs["whole"][0]
        require(len(joined) == len(whole) == 9, "the launcher ran "
                f"{len(joined)} and {len(whole)} steps, not 9")
        resume_err = max(abs(a - b) / abs(b) for a, b in zip(joined, whole))
        out_row = {"arch": arch, "losses_resumed": joined,
                   "losses_whole": whole, "resume_rel_err": resume_err}
        require(resume_err <= TRAIN_RESUME_RTOL, f"the resumed run's losses "
                f"are {resume_err:.3g} from the uninterrupted run's (limit "
                f"{TRAIN_RESUME_RTOL})")
        final = recorded["state"]
        mgr = CheckpointManager(f"{tmp}/c")
        mgr.save(9, final, blocking=True)
        small = get_config(arch).reduced()
        fresh = ts_mod.init_train_state(
            lm.init_model(small, seed=SEED + 1, device=dev),
            ts_mod.TrainConfig(kv_chunk=32))
        restored, _ = mgr.restore(fresh)
        same = all(torch.equal(a, b) for (_, pa, _), (_, pb, _) in zip(
            stacked_leaves(final), stacked_leaves(restored))
            for a, b in zip(pa, pb))
        out_row["save_restore"] = "bit-identical" if same else "differs"
        require(same, "the launcher's state did not save and restore bit "
                "for bit")
        del final, fresh, restored, recorded["state"]

    return out_row


def train_step_times(step, state, batch, row: dict):
    """Times of ``step`` on ``state`` and ``batch`` into ``row``: a
    step's call and its split by CUDA events (forward + backward +
    compression, then AdamW; medians of 3), tok/s, the update's byte
    bound (it reads the float32 accumulated gradient, ef, master, mu,
    nu and writes ef, master, mu, nu and the parameters in their dtype),
    the profiler's kernel time, busy share, top kernels and top
    operators.  Returns the state the steps leave."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import train_step as ts_mod

    adamw = ts_mod.adamw_update
    marks = []

    def timed_adamw(*a, **kw):
        ev = _events()
        ev[0].record()
        out = adamw(*a, **kw)
        ev[1].record()
        marks.append(ev)
        return out

    ts_mod.adamw_update = timed_adamw
    try:
        split = []
        for _ in range(3):
            a, b = _events()
            a.record()
            state, _ = step(state, batch)
            b.record()
            b.synchronize()
            o0, o1 = marks.pop()
            split.append((a.elapsed_time(b), a.elapsed_time(o0),
                          o0.elapsed_time(o1)))
    finally:
        ts_mod.adamw_update = adamw
    call, fwd_bwd, optim = (float(np.median(x)) for x in zip(*split))
    row["step_ms"], row["fwd_bwd_compress_ms"], row["adamw_ms"] = \
        call, fwd_bwd, optim
    row["tok_per_s"] = batch["tokens"].numel() / (call / 1e3)
    opt_bytes = sum(p.numel() * (9 * 4 + p.element_size())
                    for p in tree_leaves(state["params"]))
    row["update_bytes"] = opt_bytes
    row["update_byte_bound_ms"], _ = bound_ms(opt_bytes, 0)
    t0 = time.perf_counter()
    kern, ops = device_profile(lambda: step(state, batch))
    row["profiler_s"] = time.perf_counter() - t0
    row["step_kernel_ms"] = sum(ms for _, ms, _ in kern)
    row["step_kernel_launches"] = sum(c for _, _, c in kern)
    row["step_busy_share"] = row["step_kernel_ms"] / call
    row["step_top_kernels"] = [[n, ms] for n, ms, _ in kern[:6]]
    row["step_top_ops"] = [[n, ms, c] for n, ms, c in ops]
    return state


def lm_training_phase(dev, kernels, cpm, smi_line) -> dict:
    """Phase 4i: the LM training path (the module docstring).  Returns
    the launches of its main path, (b)'s eight steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import stacked_leaves, tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    t_phase = time.perf_counter()
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    row = {"phase": "4i", "card": smi_line, "arch": LM_ARCH,
           "reduced": {"n_layers": [full.n_layers, TRAIN_LAYERS],
                       "why": "the train state's memory: 18 B a parameter"},
           "train": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                     "microbatches": TRAIN_MICROBATCHES,
                     "steps": TRAIN_STEPS}}
    print(f"phase 4i: {LM_ARCH} reduced: n_layers {full.n_layers} -> "
          f"{TRAIN_LAYERS} (width unchanged); {smi_line}", flush=True)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (a) the model and its train state on the card
    tcfg = ts_mod.TrainConfig(
        opt=opt_mod.OptConfig(lr=3e-4, warmup_steps=2,
                              total_steps=TRAIN_STEPS),
        microbatches=TRAIN_MICROBATCHES, compress_grads=True,
        kv_chunk=TRAIN_SEQ)
    params = lm.init_model(cfg, seed=SEED, device=dev)
    state = ts_mod.init_train_state(params, tcfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for _, parts, _ in
                      stacked_leaves(state) for t in parts)
    row["params"], row["state_GB"] = n_params, state_bytes / 1e9
    row["memory_allocated_GB"] = (torch.cuda.memory_allocated() - base) / 1e9
    print(f"phase 4i: {n_params} parameters, state {row['state_GB']:.3f} GB "
          f"(18 B a parameter: 32.07 GB reckoned), memory_allocated "
          f"{row['memory_allocated_GB']:.3f} GB", flush=True)
    require(n_params == 1_781_550_080, f"{n_params} parameters, not the "
            "reckoned 1,781,550,080 of 4 full-width layers")
    require(abs(row["memory_allocated_GB"] - row["state_GB"]) < 0.1,
            "the train state allocated more than its tensors")

    # (b) eight steps on one repeated batch, every counter read
    host = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = ts_mod.make_train_step(cfg, tcfg)
    losses, step_s = [], []
    for f in kernels.values():
        f.launches = 0
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = {k: f.launches for k, f in kernels.items()}
    # the embedding gradient's Parts 3-4: one P34 a microbatch
    expected = {k: TRAIN_DISPATCH_CALLS if k in ("B11", "B12") else
                TRAIN_STEPS * TRAIN_MICROBATCHES if k == "P34" else 0
                for k in kernels}
    row["losses"], row["step_s"] = losses, step_s
    row["launches"], row["expected"] = launches, expected
    row["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 4i: losses {losses}; max_memory_allocated "
          f"{row['max_memory_allocated_GB']:.3f} GB", flush=True)
    require(all(np.isfinite(losses)), "a training loss is not finite")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> "
            f"{losses[-1]}")
    require(launches == expected, f"phase 4i launch counts {launches} != "
            f"{expected} ({TRAIN_STEPS} steps x {TRAIN_MICROBATCHES} "
            f"microbatches x (2 x {TRAIN_LAYERS} + 1) B12/B11, x 1 P34)")

    # (e) times on (b)'s model: a step's call and its split by CUDA
    # events (forward + backward + compression, then AdamW), the
    # profiler's busy time, the bounds
    state = train_step_times(step, state, batch, row)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    C = moe_mod._capacity(cfg, tokens // TRAIN_MICROBATCHES)
    fl = train_step_flops(cfg, tokens, C, TRAIN_SEQ)
    row.update(fl)
    row["step_flop_bound_ms"] = fl["step_flop"] / BF16_FLOPS_PER_S * 1e3
    # B12/B11 at the step's two sizes: a microbatch's dispatch (T K keys
    # over E bins) and its embedding gradient (T keys over the vocabulary)
    rng = np.random.default_rng(SEED + 24)
    per_mb = tokens // TRAIN_MICROBATCHES
    for what, L, nbins in (("dispatch", per_mb * cfg.moe.top_k,
                            cfg.moe.n_experts),
                           ("embed_grad", per_mb, cfg.padded_vocab)):
        e = torch.from_numpy(rng.integers(0, nbins, L).astype(
            np.int32)).to(dev)
        bb = default_block_b(nbins, L=L)
        offsets, _ = block_offsets(e, nbins=nbins, block_b=bb)
        row[f"B12_{what}_ms"] = device_ms(lambda: kernels["B12"](
            e, nbins=nbins, block_b=bb), cpm)
        row[f"B11_{what}_ms"] = device_ms(lambda: kernels["B11"](
            e, offsets, nbins=nbins, block_b=bb), cpm)
        row[f"{what}_keys_bins"] = [L, nbins]
    row["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    del state, params, batch, step
    torch.cuda.empty_cache()

    # (c) the full width against the CPU: a one-layer float32 OLMoE, the
    # same weights on both sides: loss_fn, its gradients, then AdamW on
    # the same handed-over gradients
    cfg1 = dataclasses.replace(full, n_layers=1, dtype="float32")
    t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 129)).astype(
        np.int32))
    row["f32_one_layer"], row["adamw_same_grads"] = train_parity(
        cfg1, {"tokens": t1[:1, :128], "labels": t1[:1, 1:]}, dev,
        tcfg.opt)
    torch.cuda.empty_cache()

    # (d) the launcher on the card: 6 steps, a resumed call to 9, an
    # uninterrupted run to 9; then the final state saved and restored
    row["launcher"] = launcher_resume("olmo_1b", dev, "4i")

    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4I_LIMIT_S,
            f"phase 4i took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4I_LIMIT_S} s")
    return launches


#: phases 4j and 4k: the ssm family (Mamba2-780M, arXiv:2405.21060) and
#: the hybrid family (Zamba2-7B, arXiv:2411.15242) at full width; each
#: model's parameter count (and the 12-layer cut's) as the reference's
#: init gives it under jax.eval_shape, keyed by (arch, n_layers)
SSM_ARCHS = ("mamba2_780m", "zamba2_7b")
SSM_PARAMS = {("mamba2_780m", 48): 780_382_464,
              ("zamba2_7b", 81): 6_636_442_832,
              ("zamba2_7b", 12): 1_255_956_416}
#: phase 4j's time limit, in seconds
PHASE_4J_LIMIT_S = 120
#: (c), (d) float32 copies at full width: Mamba2 with 1 layer, Zamba2
#: with 6 (its shared block applied once)
SSM_F32_LAYERS = {"mamba2_780m": 1, "zamba2_7b": 6}
#: (e) a one-layer float32 Mamba2's prefill state and conv window after
#: chunk + 3 tokens against a stepwise decode from a zero cache: within
#: SSM_STATE_RTOL of the largest magnitude (the chunked scan and the
#: recurrence add in other orders; the CPU tests measure under 1e-5 at
#: the reduced width)
SSM_STATE_RTOL = 1e-4
#: phase 4k's time limit, in seconds
PHASE_4K_LIMIT_S = 120
#: phase 4k: the layers trained (Mamba2 whole; Zamba2 cut to 12 of 81,
#: two shared applications, for the train state's memory: 18 B a
#: parameter, 119.5 GB at 81 layers) and the steps of each, on 4i's
#: batch of TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICROBATCHES microbatches
SSM_TRAIN_LAYERS = {"mamba2_780m": 48, "zamba2_7b": 12}
SSM_TRAIN_STEPS = {"mamba2_780m": 8, "zamba2_7b": 4}
#: (c) the float32 copies held against the CPU: (layers, sequence)
SSM_TRAIN_F32 = {"mamba2_780m": (1, 259), "zamba2_7b": (6, 64)}


def ssm_decode_errs(p, cfg, tokens) -> dict:
    """``decode_step`` after ``prefill(tokens[:, :-1], extra_cache=1)``
    against ``forward(tokens)``'s last position, for the sound cache and
    for planted faults: the SSM state restarted from zero, the conv
    window a row stale (its newest row dropped, its oldest repeated)
    and, where the model has a shared attention cache, a step one
    position on.  Returns each case's largest difference over
    ``max|logit|`` and whether the argmaxes agree."""
    from repro_torch.models import model as lm

    S = tokens.shape[1] - 1
    with torch.inference_mode():
        full, _ = lm.forward(p, {"tokens": tokens}, cfg, kv_chunk=S + 1)
        _, c = lm.prefill(p, {"tokens": tokens[:, :S]}, cfg, kv_chunk=S,
                          extra_cache=1)
        want = full[:, -1].float()
        conv = c["conv"]
        cases = {"sound": c,
                 "state_zeroed": dict(c, state=torch.zeros_like(c["state"])),
                 "conv_stale": dict(c, conv=torch.cat(
                     [conv[:, :, :1], conv[:, :, :-1]], dim=2))}
        if "k" in c:
            cases["pos_plus_1"] = dict(c, pos=c["pos"] + 1)
        out = {}
        for what, c_x in cases.items():
            step, _ = lm.decode_step(p, c_x, tokens[:, S:], cfg)
            got = step[:, 0].float()
            out[what] = {
                "rel_err": float((got - want).abs().max() / want.abs().max()),
                "argmax_equal": bool(torch.equal(got.argmax(-1),
                                                 want.argmax(-1)))}
    return out


def ssm_stepwise_errs(p, cfg, tokens) -> dict:
    """The state and conv window ``prefill`` leaves after ``tokens``
    against ``S`` decode steps from a zero cache, each difference over
    the prefill's largest magnitude."""
    from repro_torch.models import model as lm

    B, S = tokens.shape
    with torch.inference_mode():
        _, cache = lm.prefill(p, {"tokens": tokens}, cfg, kv_chunk=S)
        c = lm.init_cache(cfg, batch=B, seq_len=S, device=tokens.device)
        for t in range(S):
            _, c = lm.decode_step(p, c, tokens[:, t:t + 1], cfg)
    return {k: float((c[k].float() - cache[k].float()).abs().max()
                     / cache[k].float().abs().max())
            for k in ("state", "conv")}


def ssm_decode_bytes(params, cache, cfg) -> int:
    """The bytes a decode step must move: every weight once, the shared
    block's once per application, the SSM and conv states read and
    written, the shared block's K/V caches read (the new position's
    write is left out)."""
    shared = sum(p.numel() * p.element_size()
                 for k in params.keys() if k.startswith("shared_")
                 for p in params[k].parameters())
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    apps = cfg.n_layers // every if every else 0
    states = sum(2 * cache[k].numel() * cache[k].element_size()
                 for k in ("state", "conv"))
    kv = sum(cache[k].numel() * cache[k].element_size()
             for k in ("k", "v") if k in cache)
    return weights + (apps - 1) * shared + states + kv


def ssm_step_flops(cfg, tokens: int, seq: int) -> dict:
    """The FLOPs of one train step on ``tokens`` tokens of ``seq``, by
    the precision they run in: the projections, the shared block's
    projections and MLP and the unembedding in bf16; the SSD scan's
    einsums (per token and layer ``2 Q H (N + P) + 4 H N P`` at chunk
    ``Q``: the scores, the intra-chunk product, the chunk states and
    the inter-chunk product) and the shared attention's two products
    (upcast to float32, every key of the sequence) in float32.  The
    blocks run twice (forward and remat's recompute), the backward
    costs twice the forward."""
    s = cfg.ssm
    D, V = cfg.d_model, cfg.padded_vocab
    di, H, N, P = s.d_inner(D), s.n_heads(D), s.d_state, s.head_dim
    Q = min(s.chunk, seq)
    proj = 2 * (D * (2 * di + 2 * s.n_groups * N + H) + di * D)
    scan = 2 * Q * H * (N + P) + 4 * H * N * P
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    apps = cfg.n_layers // every if every else 0
    Ha, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shared_bf16 = 2 * (D * (Ha + 2 * Hkv) * Dh + Ha * Dh * D
                       + 3 * D * cfg.d_ff)
    shared_f32 = 4 * seq * Ha * Dh
    blocks_bf16 = cfg.n_layers * proj + apps * shared_bf16
    blocks_f32 = cfg.n_layers * scan + apps * shared_f32
    head = 2 * D * V
    bf16 = tokens * (4 * blocks_bf16 + 3 * head)
    f32 = tokens * 4 * blocks_f32
    return {"scan_flop_per_token_layer": scan, "step_bf16_flop": bf16,
            "step_f32_flop": f32,
            "step_bf16_bound_ms": bf16 / BF16_FLOPS_PER_S * 1e3,
            "step_f32_bound_ms": f32 / FP32_OPS_PER_S * 1e3}


def ssm_serving_phase(dev, kernels, cpm, smi_line) -> dict:
    """Phase 4j: the ssm and hybrid serving path (the module docstring).
    Returns the launches of its main path, the two served runs."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    t_phase = time.perf_counter()
    row = {"phase": "4j", "card": smi_line,
           "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
                     "requests": LM_REQUESTS},
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    require(not row["tf32"], "TF32 matmuls are on: the float32 checks "
            "need them off")
    launches = {k: 0 for k in kernels}
    rng = np.random.default_rng(SEED + 25)
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        r = row[arch] = {}
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        # (a) the model on the card
        t0 = time.perf_counter()
        with torch.inference_mode():
            params = lm.init_model(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        r["init_s"] = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in params.parameters())
        r["params"] = sum(p.numel() for p in params.parameters())
        r["weights_GB"] = weight_bytes / 1e9
        r["memory_allocated_GB"] = (torch.cuda.memory_allocated()
                                    - base) / 1e9
        print(f"phase 4j: {arch} {r['params']} parameters, memory_allocated "
              f"{r['memory_allocated_GB']:.3f} GB; {smi_line}", flush=True)
        require(r["params"] == SSM_PARAMS[(arch, cfg.n_layers)],
                f"{arch}: {r['params']} parameters, not the reference's "
                f"{SSM_PARAMS[(arch, cfg.n_layers)]}")
        require(abs(r["memory_allocated_GB"] - r["weights_GB"]) < 0.1,
                "init_model allocated more than its weights")

        # (b) the real server, every counter read
        served = serve_watched(arch, cfg, params, kernels, dev, "4j")
        r["served_lines"], r["tok_per_s"] = served["lines"], \
            served["tok_per_s"]
        r["launches"] = served["launches"]
        require(all(n == 0 for n in r["launches"].values()),
                f"phase 4j ({arch}) launched {r['launches']}: serving "
                "these families runs none of the thirteen kernels")
        for k, n in served["launches"].items():
            launches[k] += n

        # (d) decode against forward on the bf16 full-depth model
        td = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65)).astype(
            np.int32)).to(dev)
        r["decode_vs_forward"] = {"bf16_full_depth": ssm_decode_errs(
            params, cfg, td)}

        # (f) times: prefill, a decode step against its byte bound
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
            LM_BATCH, LM_PROMPT + 1)).astype(np.int32)).to(dev)
        with torch.inference_mode():
            batch = {"tokens": toks[:, :-1]}

            def prefill_fn():
                return lm.prefill(params, batch, cfg, kv_chunk=LM_PROMPT)

            _, cache = prefill_fn()
            tok = toks[:, -1:]

            def decode_fn():
                return lm.decode_step(params, cache, tok, cfg)

            r["prefill_ms"] = call_ms(prefill_fn, reps=5)
            r["prefill_device_ms"] = device_ms(prefill_fn, cpm, reps=5)
            r["decode_ms"] = call_ms(decode_fn, reps=10)
            r["decode_device_ms"] = device_ms(decode_fn, cpm, reps=10)
            r["decode_bytes"] = ssm_decode_bytes(params, cache, cfg)
            r["decode_bound_ms"], r["decode_bound_by"] = bound_ms(
                r["decode_bytes"], 0)
            for what, fn in (("decode", decode_fn), ("prefill", prefill_fn)):
                kern, ops = device_profile(fn, 6)
                r[f"{what}_kernel_ms"] = sum(ms for _, ms, _ in kern)
                r[f"{what}_kernel_launches"] = sum(c for _, _, c in kern)
                r[f"{what}_top_kernels"] = [[n, ms] for n, ms, _ in kern[:6]]
                r[f"{what}_top_ops"] = [[n, ms, c] for n, ms, c in ops]
                r[f"{what}_busy_share"] = r[f"{what}_kernel_ms"] / \
                    r[f"{what}_ms"]
        r["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
        del params, cache, batch
        torch.cuda.empty_cache()

        # (c) float32 copies at full width against the CPU, the same
        # weights on both sides (drawn on the card)
        cfg_f = dataclasses.replace(cfg, n_layers=SSM_F32_LAYERS[arch],
                                    dtype="float32")
        p_dev = lm.init_model(cfg_f, seed=SEED, device=dev)
        p_cpu = copy.deepcopy(p_dev).to("cpu")
        t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 160)).astype(
            np.int32))
        with torch.inference_mode():
            want, _ = lm.prefill(p_cpu, {"tokens": t1}, cfg_f, kv_chunk=160)
            got, _ = lm.prefill(p_dev, {"tokens": t1.to(dev)}, cfg_f,
                                kv_chunk=160)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        r[f"f32_{cfg_f.n_layers}_layers_prefill_rel_err"] = err
        require(err <= LM_F32_RTOL, f"{arch}: the float32 prefill on the "
                f"card is {err:.3g} of max|logit| from the CPU's (limit "
                f"{LM_F32_RTOL})")
        del p_cpu, want, got

        # (d) decode against forward on the float32 copy; the limits
        # against the sound step and the planted faults
        name_f = f"f32_{cfg_f.n_layers}_layers"
        r["decode_vs_forward"][name_f] = ssm_decode_errs(p_dev, cfg_f, td)
        for name, limit in ((name_f, LM_F32_DECODE_RTOL),
                            ("bf16_full_depth", LM_BF16_RTOL)):
            d = r["decode_vs_forward"][name]
            require(d["sound"]["rel_err"] <= limit, f"{arch}: decode_step "
                    f"({name}) is {d['sound']['rel_err']:.3g} of max|logit| "
                    f"from forward (limit {limit})")
            for fault in (k for k in d if k != "sound"):
                require(d[fault]["rel_err"] > limit, f"{arch}: the planted "
                        f"fault {fault} ({name}) reads "
                        f"{d[fault]['rel_err']:.3g}, within the limit "
                        f"{limit}: the check cannot tell it from a sound "
                        "step")

        # (e) the one-layer Mamba2's prefill state after chunk + 3
        # tokens against a stepwise decode from a zero cache
        if cfg.family == "ssm":
            S = cfg.ssm.chunk + 3
            ts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S)).astype(
                np.int32)).to(dev)
            errs = ssm_stepwise_errs(p_dev, cfg_f, ts)
            r["prefill_vs_stepwise"] = {"S": S, **errs}
            require(max(errs.values()) <= SSM_STATE_RTOL, f"{arch}: the "
                    f"prefill's state after {S} tokens differs from the "
                    f"stepwise decode's by {errs} (limit {SSM_STATE_RTOL})")
        del p_dev
        torch.cuda.empty_cache()
        print(f"phase 4j: {arch}: {json.dumps(r['decode_vs_forward'])}",
              flush=True)

    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4J_LIMIT_S,
            f"phase 4j took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4J_LIMIT_S} s")
    return launches


def ssm_training_phase(dev, kernels, cpm, smi_line) -> dict:
    """Phase 4k: the ssm and hybrid training path (the module
    docstring).  Returns the launches of its main path, the steps of
    (b) on both models."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as lm
    from repro_torch.models.layers import stacked_leaves, tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    t_phase = time.perf_counter()
    row = {"phase": "4k", "card": smi_line,
           "train": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                     "microbatches": TRAIN_MICROBATCHES},
           "cpu_threads": torch.get_num_threads()}
    launches = {k: 0 for k in kernels}
    rng = np.random.default_rng(SEED + 26)
    for arch in SSM_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=SSM_TRAIN_LAYERS[arch])
        steps = SSM_TRAIN_STEPS[arch]
        r = row[arch] = {"n_layers": [full.n_layers, cfg.n_layers],
                         "steps": steps}
        t_arch = time.perf_counter()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        # (a) the model and its train state on the card
        tcfg = ts_mod.TrainConfig(
            opt=opt_mod.OptConfig(lr=3e-4, warmup_steps=2,
                                  total_steps=steps),
            microbatches=TRAIN_MICROBATCHES, compress_grads=True,
            kv_chunk=TRAIN_SEQ)
        params = lm.init_model(cfg, seed=SEED, device=dev)
        state = ts_mod.init_train_state(params, tcfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tree_leaves(params))
        state_bytes = sum(t.numel() * t.element_size() for _, parts, _ in
                          stacked_leaves(state) for t in parts)
        r["params"], r["state_GB"] = n_params, state_bytes / 1e9
        r["memory_allocated_GB"] = (torch.cuda.memory_allocated()
                                    - base) / 1e9
        print(f"phase 4k: {arch} at {cfg.n_layers} of {full.n_layers} "
              f"layers: {n_params} parameters, state {r['state_GB']:.3f} "
              f"GB, memory_allocated {r['memory_allocated_GB']:.3f} GB; "
              f"{smi_line}", flush=True)
        require(n_params == SSM_PARAMS[(arch, cfg.n_layers)],
                f"{arch}: {n_params} parameters, not the reference's "
                f"{SSM_PARAMS[(arch, cfg.n_layers)]}")
        require(abs(r["memory_allocated_GB"] - r["state_GB"]) < 0.1,
                "the train state allocated more than its tensors")

        stage = r["stage_s"] = {"init": time.perf_counter() - t_arch}

        # (b) the steps on one repeated batch, every counter read
        host = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                           seed=SEED).batch_at(0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        step = ts_mod.make_train_step(cfg, tcfg)
        losses, step_s = [], []
        for f in kernels.values():
            f.launches = 0
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t0)
        got = {k: f.launches for k, f in kernels.items()}
        expected = {k: steps * TRAIN_MICROBATCHES
                    if k in ("B11", "B12", "P34") else 0 for k in kernels}
        for k, n in got.items():
            launches[k] += n
        r["losses"], r["step_s"] = losses, step_s
        r["launches"], r["expected"] = got, expected
        print(f"phase 4k: {arch} losses {losses}", flush=True)
        require(all(np.isfinite(losses)), f"{arch}: a training loss is not "
                "finite")
        require(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
                f"{losses[0]} -> {losses[-1]}")
        require(got == expected, f"phase 4k ({arch}) launch counts {got} != "
                f"{expected} ({steps} steps x {TRAIN_MICROBATCHES} "
                "microbatches x 1 embedding gradient)")

        stage["steps"] = time.perf_counter() - t_arch - stage["init"]

        # (e) times and bounds
        state = train_step_times(step, state, batch, r)
        stage["times"] = time.perf_counter() - t_arch - sum(stage.values())
        r.update(ssm_step_flops(cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ))
        r["step_flop_bound_ms"] = r["step_bf16_bound_ms"] + \
            r["step_f32_bound_ms"]
        r["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
        del state, params, batch, step
        torch.cuda.empty_cache()

        # (c) float32 copies at full width against the CPU: loss_fn,
        # every gradient leaf, adamw_update on the same gradients
        layers, S = SSM_TRAIN_F32[arch]
        cfg_f = dataclasses.replace(full, n_layers=layers, dtype="float32")
        t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1)).astype(
            np.int32))
        r[f"f32_{layers}_layers"], r["adamw_same_grads"] = train_parity(
            cfg_f, {"tokens": t1[:, :S], "labels": t1[:, 1:]}, dev,
            tcfg.opt)
        torch.cuda.empty_cache()
        stage["parity"] = time.perf_counter() - t_arch - sum(stage.values())

    # (d) the launcher on the card, on the hybrid
    t0 = time.perf_counter()
    row["launcher"] = launcher_resume("zamba2_7b", dev, "4k")
    row["launcher"]["s"] = time.perf_counter() - t0
    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4K_LIMIT_S,
            f"phase 4k took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4K_LIMIT_S} s")
    return launches


#: phases 4l and 4m: the encdec family (Seamless-M4T-medium,
#: arXiv:2308.11596) and the vlm family (Llama-3.2-Vision-11B) at full
#: width; each model's parameter count (and the training cuts') as the
#: reference's init gives it under jax.eval_shape, keyed by (arch,
#: n_layers)
CROSS_ARCHS = ("seamless_m4t_medium", "llama_3_2_vision_11b")
CROSS_PARAMS = {("seamless_m4t_medium", 12): 715_454_464,
                ("llama_3_2_vision_11b", 40): 9_585_397_760,
                ("llama_3_2_vision_11b", 10): 2_790_354_944,
                ("llama_3_2_vision_11b", 5): 1_657_847_808}
#: phase 4l's time limit, in seconds
PHASE_4L_LIMIT_S = 120
#: (c), (d) float32 copies at full width: Seamless with 2 encoder and 2
#: decoder layers, Llama-3.2-Vision with one layer and its cross block
#: (over all 1,601 vision tokens)
CROSS_F32 = {"seamless_m4t_medium": {"n_layers": 2, "n_enc_layers": 2},
             "llama_3_2_vision_11b": {"n_layers": 1, "cross_attn_every": 1}}
#: (c), (d) the source length beside the prompt's, so that the two
#: cannot be confused
CROSS_SRC_LEN = 48
#: (d) the archs whose planted faults the bf16 limit cannot resolve at
#: full depth: Llama-3.2-Vision's cross blocks attend nearly uniformly
#: over 1,601 standard normal vision tokens, whose average is small, so
#: zeroing or swapping their K/V moves the 40-layer bf16 logits by about
#: 3% of max|logit|, under LM_BF16_RTOL (chip run 1, PR 26).  Their
#: faults are held to LM_F32_DECODE_RTOL on a float32 copy at full width
#: and depth (38.3 GB) instead, and read on the bf16 model
CROSS_F32_FULL_DEPTH = ("llama_3_2_vision_11b",)
#: phase 4m's time limit, in seconds
PHASE_4M_LIMIT_S = 120
#: phase 4m: the layers trained (Seamless whole; Llama-3.2-Vision cut
#: to 10 of 40, two cross blocks, for the train state's memory: 18 B a
#: parameter, 172.5 GB at 40 layers) and the steps of each, on 4i's
#: batch of TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICROBATCHES microbatches
CROSS_TRAIN_LAYERS = {"seamless_m4t_medium": 12, "llama_3_2_vision_11b": 10}
CROSS_TRAIN_STEPS = {"seamless_m4t_medium": 8, "llama_3_2_vision_11b": 4}
#: (b) the most a model's training may allocate above what the phase
#: found allocated (the earlier phases hold about 3.3 GB for phase 5):
#: past it, Llama-3.2-Vision's cut goes from 10 layers (two cross
#: blocks) to 5 (one), to keep the card's headroom
CROSS_TRAIN_PEAK_GB = 72
#: (c) the float32 copies' sequence against the CPU
CROSS_TRAIN_F32_SEQ = 64
#: (e) the embedding gradient's features at the two wide vocabularies
#: (the bins are what B12 and B11 see; the CPU's float64 bound over
#: V x D stays small)
CROSS_GRAD_D = 512


def cross_batch(cfg, tokens, rng, src_len: int, dtype=None) -> dict:
    """``tokens`` with the stub frontend's embeddings ``cfg`` takes
    (``src_embeds`` ``[B, src_len, D]`` or ``vision_embeds`` ``[B,
    n_vision_tokens, D]``), standard normal draws from ``rng`` in
    ``dtype`` (the model's by default) on the tokens' device."""
    from repro_torch.models.layers import torch_dtype

    B = tokens.shape[0]
    dt = torch_dtype(dtype or cfg.dtype)
    shape = {"encdec": (B, src_len, cfg.d_model),
             "vlm": (B, cfg.n_vision_tokens, cfg.d_model)}.get(cfg.family)
    batch = {"tokens": tokens}
    if shape is not None:
        key = "src_embeds" if cfg.family == "encdec" else "vision_embeds"
        batch[key] = torch.from_numpy(rng.normal(size=shape)).to(dt).to(
            tokens.device)
    return batch


def _causal_enc_layer(lp, h, cfg, *, positions, kv_chunk):
    """A planted fault: an encoder block that runs causal."""
    from repro_torch.models import model as lm

    h, _ = lm._dense_block(lp, h, cfg, 0, positions=positions, causal=True,
                           kv_chunk=kv_chunk)
    return h


def cross_decode_errs(p, cfg, batch) -> dict:
    """``decode_step`` after ``prefill(batch with tokens[:, :-1],
    extra_cache=1)`` against ``forward(batch)``'s last position, for the
    sound cache and for planted faults: the cross K/V (``ck``/``cv``)
    zeroed; where there are two cross blocks or more (vlm), each block
    reading the next one's K/V; for encdec, a prefill whose encoder runs
    causal.  Returns each case's largest difference over ``max|logit|``
    and whether the argmaxes agree."""
    from repro_torch.models import model as lm

    tokens = batch["tokens"]
    S = tokens.shape[1] - 1
    head = dict(batch, tokens=tokens[:, :S])
    with torch.inference_mode():
        full, _ = lm.forward(p, batch, cfg, kv_chunk=S + 1)
        _, c = lm.prefill(p, head, cfg, kv_chunk=S, extra_cache=1)
        want = full[:, -1].float()
        cases = {"sound": c,
                 "cross_zeroed": dict(c, ck=torch.zeros_like(c["ck"]),
                                      cv=torch.zeros_like(c["cv"]))}
        if lm._n_cross(cfg) >= 2:
            cases["other_cross_block"] = dict(
                c, ck=c["ck"].roll(-1, 0), cv=c["cv"].roll(-1, 0))
        if cfg.family == "encdec":
            sound_layer, lm._enc_layer = lm._enc_layer, _causal_enc_layer
            try:
                _, cases["encoder_causal"] = lm.prefill(
                    p, head, cfg, kv_chunk=S, extra_cache=1)
            finally:
                lm._enc_layer = sound_layer
        out = {}
        for what, c_x in cases.items():
            step, _ = lm.decode_step(p, c_x, tokens[:, S:], cfg)
            got = step[:, 0].float()
            out[what] = {
                "rel_err": float((got - want).abs().max() / want.abs().max()),
                "argmax_equal": bool(torch.equal(got.argmax(-1),
                                                 want.argmax(-1)))}
    return out


def _tree_bytes(node) -> int:
    return sum(t.numel() * t.element_size() for t in node.parameters())


def cross_decode_bytes(params, cache, cfg) -> int:
    """The bytes a decode step must move: every weight of the decoder
    once (not the encoder's, not the cross blocks' K/V projections,
    whose products are the cache), the self-attention K/V caches and the
    cross K/V caches read (the new position's write is left out)."""
    unread = sum(_tree_bytes(params[k]) for k in ("enc_layers",
                                                  "enc_final_norm")
                 if k in params.keys())
    for k in ("dec_cross", "cross"):
        if k in params.keys():
            unread += sum(b["attn"][w].numel() * b["attn"][w].element_size()
                          for b in params[k] for w in ("k_in", "v_in"))
    caches = sum(cache[k].numel() * cache[k].element_size()
                 for k in ("k", "v", "ck", "cv"))
    return _tree_bytes(params) - unread + caches


def _padded(n: int, chunk: int) -> int:
    """The keys chunked attention computes over: ``n`` padded to its
    chunk ``min(chunk, n)``."""
    c = min(chunk, n)
    return -(-n // c) * c


def cross_flops(cfg, batch: int, seq: int, src_len: int,
                kv_chunk: int) -> dict:
    """The FLOPs of one forward over ``batch`` sequences of ``seq``
    tokens (and ``src_len`` source tokens for encdec), by the precision
    they run in.  bf16: every projection and MLP (the encoder's over
    the source, the cross blocks' K/V once over the source or the
    vision tokens, their Q and O over the tokens) and the unembedding
    of every position; float32: the attention's two products, upcast,
    over every key chunk the port computes (``_padded``).  Returns the
    per-token split the reckoning uses."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    qo = 2 * D * H * Dh
    kv = 2 * D * Hkv * Dh
    block = qo + kv + 3 * D * cfg.d_ff           # params a token reads
    T = batch * seq
    if cfg.family == "encdec":
        n_cross, src = cfg.n_layers, src_len
        enc = batch * src_len * cfg.n_enc_layers * 2 * block
    else:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        src, enc = cfg.n_vision_tokens, 0
    bf16 = (T * 2 * (cfg.n_layers * block + n_cross * qo) + enc
            + batch * src * n_cross * 2 * kv)
    head = T * 2 * D * cfg.padded_vocab
    attn = 4 * H * Dh * batch                    # two products, a key
    f32 = attn * (cfg.n_layers * seq * _padded(seq, kv_chunk)
                  + n_cross * seq * _padded(src, kv_chunk))
    if cfg.family == "encdec":
        f32 += attn * cfg.n_enc_layers * src_len * _padded(src_len,
                                                           kv_chunk)
    return {"blocks_bf16_flop": bf16, "head_bf16_flop": head,
            "attention_f32_flop": f32}


def cross_serving_phase(dev, kernels, cpm, smi_line) -> dict:
    """Phase 4l: the encdec and vlm serving path (the module docstring).
    Returns the launches of its main path, the two served runs."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    t_phase = time.perf_counter()
    row = {"phase": "4l", "card": smi_line,
           "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
                     "requests": LM_REQUESTS},
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    require(not row["tf32"], "TF32 matmuls are on: the float32 checks "
            "need them off")
    launches = {k: 0 for k in kernels}
    rng = np.random.default_rng(SEED + 27)
    for arch in CROSS_ARCHS:
        cfg = get_config(arch)
        r = row[arch] = {}
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        # (a) the model on the card
        t0 = time.perf_counter()
        with torch.inference_mode():
            params = lm.init_model(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        r["init_s"] = time.perf_counter() - t0
        weight_bytes = _tree_bytes(params)
        r["params"] = sum(p.numel() for p in params.parameters())
        r["weights_GB"] = weight_bytes / 1e9
        r["memory_allocated_GB"] = (torch.cuda.memory_allocated()
                                    - base) / 1e9
        print(f"phase 4l: {arch} {r['params']} parameters, memory_allocated "
              f"{r['memory_allocated_GB']:.3f} GB; {smi_line}", flush=True)
        require(r["params"] == CROSS_PARAMS[(arch, cfg.n_layers)],
                f"{arch}: {r['params']} parameters, not the reference's "
                f"{CROSS_PARAMS[(arch, cfg.n_layers)]}")
        require(abs(r["memory_allocated_GB"] - r["weights_GB"]) < 0.1,
                "init_model allocated more than its weights")

        # (b) the real server, every counter read
        served = serve_watched(arch, cfg, params, kernels, dev, "4l")
        r["served_lines"], r["tok_per_s"] = served["lines"], \
            served["tok_per_s"]
        r["launches"] = served["launches"]
        require(all(n == 0 for n in r["launches"].values()),
                f"phase 4l ({arch}) launched {r['launches']}: serving "
                "these families runs none of the thirteen kernels")
        for k, n in served["launches"].items():
            launches[k] += n

        # (d) decode against forward on the bf16 full-depth model
        td = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65)).astype(
            np.int32)).to(dev)
        bd = cross_batch(cfg, td, rng, CROSS_SRC_LEN)
        r["decode_vs_forward"] = {"bf16_full_depth": cross_decode_errs(
            params, cfg, bd)}
        bd = {k: (v.float() if v.is_floating_point() else v)
              for k, v in bd.items()}

        # (f) times: prefill, a decode step against its byte bound
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
            LM_BATCH, LM_PROMPT + 1)).astype(np.int32)).to(dev)
        with torch.inference_mode():
            batch = cross_batch(cfg, toks[:, :-1], rng, LM_PROMPT)

            def prefill_fn():
                return lm.prefill(params, batch, cfg, kv_chunk=LM_PROMPT)

            _, cache = prefill_fn()
            tok = toks[:, -1:]

            def decode_fn():
                return lm.decode_step(params, cache, tok, cfg)

            r["prefill_ms"] = call_ms(prefill_fn, reps=5)
            r["prefill_device_ms"] = device_ms(prefill_fn, cpm, reps=5)
            r["decode_ms"] = call_ms(decode_fn, reps=10)
            r["decode_device_ms"] = device_ms(decode_fn, cpm, reps=10)
            r["decode_bytes"] = cross_decode_bytes(params, cache, cfg)
            r["decode_bound_ms"], r["decode_bound_by"] = bound_ms(
                r["decode_bytes"], 0)
            fl = cross_flops(cfg, LM_BATCH, LM_PROMPT, LM_PROMPT, LM_PROMPT)
            # prefill unembeds the last position only
            r["prefill_bf16_flop"] = fl["blocks_bf16_flop"] + \
                fl["head_bf16_flop"] // LM_PROMPT
            r["prefill_f32_flop"] = fl["attention_f32_flop"]
            r["prefill_bf16_bound_ms"] = r["prefill_bf16_flop"] / \
                BF16_FLOPS_PER_S * 1e3
            r["prefill_f32_bound_ms"] = r["prefill_f32_flop"] / \
                FP32_OPS_PER_S * 1e3
            for what, fn in (("decode", decode_fn), ("prefill", prefill_fn)):
                kern, ops = device_profile(fn, 6)
                r[f"{what}_kernel_ms"] = sum(ms for _, ms, _ in kern)
                r[f"{what}_kernel_launches"] = sum(c for _, _, c in kern)
                r[f"{what}_top_kernels"] = [[n, ms] for n, ms, _ in kern[:6]]
                r[f"{what}_top_ops"] = [[n, ms, c] for n, ms, c in ops]
                r[f"{what}_busy_share"] = r[f"{what}_kernel_ms"] / \
                    r[f"{what}_ms"]
        r["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
        r["base_allocated_GB"] = base / 1e9
        del params, cache, batch
        torch.cuda.empty_cache()

        # (d) where the bf16 limit cannot resolve the faults: the same
        # at full depth in float32
        if arch in CROSS_F32_FULL_DEPTH:
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            with torch.inference_mode():
                p32 = lm.init_model(cfg32, seed=SEED, device=dev)
            r["decode_vs_forward"]["f32_full_depth"] = cross_decode_errs(
                p32, cfg32, bd)
            del p32
            torch.cuda.empty_cache()

        # (c) float32 copies at full width against the CPU, the same
        # weights on both sides (drawn on the card)
        cfg_f = dataclasses.replace(cfg, dtype="float32", **CROSS_F32[arch])
        p_dev = lm.init_model(cfg_f, seed=SEED, device=dev)
        p_cpu = copy.deepcopy(p_dev).to("cpu")
        t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 160)).astype(
            np.int32))
        b1 = cross_batch(cfg_f, t1, rng, CROSS_SRC_LEN)
        with torch.inference_mode():
            want, _ = lm.prefill(p_cpu, b1, cfg_f, kv_chunk=160)
            got, _ = lm.prefill(p_dev, {k: v.to(dev) for k, v in b1.items()},
                                cfg_f, kv_chunk=160)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        name_f = f"f32_{cfg_f.n_layers}_layers"
        r[f"{name_f}_prefill_rel_err"] = err
        require(err <= LM_F32_RTOL, f"{arch}: the float32 prefill on the "
                f"card is {err:.3g} of max|logit| from the CPU's (limit "
                f"{LM_F32_RTOL})")
        del p_cpu, want, got

        # (d) decode against forward on the float32 copy; the limits
        # against the sound step and the planted faults
        r["decode_vs_forward"][name_f] = cross_decode_errs(p_dev, cfg_f, bd)
        for name, d in r["decode_vs_forward"].items():
            limit = LM_BF16_RTOL if name.startswith("bf16") else \
                LM_F32_DECODE_RTOL
            require(d["sound"]["rel_err"] <= limit, f"{arch}: decode_step "
                    f"({name}) is {d['sound']['rel_err']:.3g} of max|logit| "
                    f"from forward (limit {limit})")
            if name.startswith("bf16") and arch in CROSS_F32_FULL_DEPTH:
                continue  # read only: see CROSS_F32_FULL_DEPTH
            for fault in (k for k in d if k != "sound"):
                require(d[fault]["rel_err"] > limit, f"{arch}: the planted "
                        f"fault {fault} ({name}) reads "
                        f"{d[fault]['rel_err']:.3g}, within the limit "
                        f"{limit}: the check cannot tell it from a sound "
                        "step")
        full_name = "f32_full_depth" if arch in CROSS_F32_FULL_DEPTH \
            else "bf16_full_depth"
        require("other_cross_block" in r["decode_vs_forward"][full_name]
                or cfg.family != "vlm",
                f"{arch}: no cross-block fault was planted at full depth")
        del p_dev
        torch.cuda.empty_cache()
        print(f"phase 4l: {arch}: {json.dumps(r['decode_vs_forward'])}",
              flush=True)

    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4L_LIMIT_S,
            f"phase 4l took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4L_LIMIT_S} s")
    return launches


def cross_training_phase(dev, kernels, cpm, smi_line) -> dict:
    """Phase 4m: the encdec and vlm training path (the module
    docstring).  Returns the launches of its main path, the steps of
    (b) on both models."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.counting_sort.ref import placement_ref
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.kernels.hist.ref import block_histogram_ref
    from repro_torch.launch.specs import stub_embeddings, train_batch_specs
    from repro_torch.models import model as lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.layers import stacked_leaves, tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    hist_mod = importlib.import_module("repro_torch.kernels.hist.hist")
    t_phase = time.perf_counter()
    row = {"phase": "4m", "card": smi_line,
           "train": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                     "microbatches": TRAIN_MICROBATCHES},
           "cpu_threads": torch.get_num_threads()}
    launches = {k: 0 for k in kernels}
    rng = np.random.default_rng(SEED + 28)
    for arch in CROSS_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=CROSS_TRAIN_LAYERS[arch])
        steps = CROSS_TRAIN_STEPS[arch]
        r = row[arch] = {"n_layers": [full.n_layers, cfg.n_layers],
                         "steps": steps}
        t_arch = time.perf_counter()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        # (a) the model and its train state on the card
        tcfg = ts_mod.TrainConfig(
            opt=opt_mod.OptConfig(lr=3e-4, warmup_steps=2,
                                  total_steps=steps),
            microbatches=TRAIN_MICROBATCHES, compress_grads=True,
            kv_chunk=TRAIN_SEQ)
        params = lm.init_model(cfg, seed=SEED, device=dev)
        state = ts_mod.init_train_state(params, tcfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tree_leaves(params))
        state_bytes = sum(t.numel() * t.element_size() for _, parts, _ in
                          stacked_leaves(state) for t in parts)
        r["params"], r["state_GB"] = n_params, state_bytes / 1e9
        r["memory_allocated_GB"] = (torch.cuda.memory_allocated()
                                    - base) / 1e9
        print(f"phase 4m: {arch} at {cfg.n_layers} of {full.n_layers} "
              f"layers: {n_params} parameters, state {r['state_GB']:.3f} "
              f"GB, memory_allocated {r['memory_allocated_GB']:.3f} GB; "
              f"{smi_line}", flush=True)
        require(n_params == CROSS_PARAMS[(arch, cfg.n_layers)],
                f"{arch}: {n_params} parameters, not the reference's "
                f"{CROSS_PARAMS[(arch, cfg.n_layers)]}")
        require(abs(r["memory_allocated_GB"] - r["state_GB"]) < 0.1,
                "the train state allocated more than its tensors")
        stage = r["stage_s"] = {"init": time.perf_counter() - t_arch}

        # (b) the steps on one repeated batch with the launcher's stub
        # embeddings, every counter read
        host = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                           seed=SEED).batch_at(0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        specs = train_batch_specs(cfg, ShapeConfig("train", TRAIN_SEQ,
                                                   TRAIN_BATCH, "train"))
        batch.update(stub_embeddings(specs, np.random.default_rng(
            (SEED, 0)), dev))
        step = ts_mod.make_train_step(cfg, tcfg)
        losses, step_s = [], []
        for f in kernels.values():
            f.launches = 0
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t0)
        got = {k: f.launches for k, f in kernels.items()}
        expected = {k: steps * TRAIN_MICROBATCHES
                    if k in ("B11", "B12", "P34") else 0 for k in kernels}
        for k, n in got.items():
            launches[k] += n
        r["losses"], r["step_s"] = losses, step_s
        r["launches"], r["expected"] = got, expected
        r["base_allocated_GB"] = base / 1e9
        r["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
        r["peak_over_base_GB"] = r["max_memory_allocated_GB"] - \
            r["base_allocated_GB"]
        print(f"phase 4m: {arch} losses {losses}; max_memory_allocated "
              f"{r['max_memory_allocated_GB']:.3f} GB, "
              f"{r['peak_over_base_GB']:.3f} GB over the "
              f"{r['base_allocated_GB']:.3f} GB held before", flush=True)
        require(r["peak_over_base_GB"] < CROSS_TRAIN_PEAK_GB,
                f"{arch}: training allocated {r['peak_over_base_GB']:.2f} "
                f"GB over its base, past {CROSS_TRAIN_PEAK_GB} GB")
        require(all(np.isfinite(losses)), f"{arch}: a training loss is not "
                "finite")
        require(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
                f"{losses[0]} -> {losses[-1]}")
        require(got == expected, f"phase 4m ({arch}) launch counts {got} != "
                f"{expected} ({steps} steps x {TRAIN_MICROBATCHES} "
                "microbatches x 1 embedding gradient)")
        stage["steps"] = time.perf_counter() - t_arch - stage["init"]

        # (e) times and bounds
        state = train_step_times(step, state, batch, r)
        stage["times"] = time.perf_counter() - t_arch - sum(stage.values())
        fl = cross_flops(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, TRAIN_SEQ)
        # remat: the blocks run twice and their backward costs twice the
        # forward; the unembedding once and its backward twice
        r["step_bf16_flop"] = 4 * fl["blocks_bf16_flop"] + \
            3 * fl["head_bf16_flop"]
        r["step_f32_flop"] = 4 * fl["attention_f32_flop"]
        r["step_bf16_bound_ms"] = r["step_bf16_flop"] / BF16_FLOPS_PER_S * 1e3
        r["step_f32_bound_ms"] = r["step_f32_flop"] / FP32_OPS_PER_S * 1e3
        r["step_flop_bound_ms"] = r["step_bf16_bound_ms"] + \
            r["step_f32_bound_ms"]
        r["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
        del state, params, batch, step
        torch.cuda.empty_cache()

        # (e) the embedding gradient at this vocabulary: a microbatch's
        # 2,048 tokens into padded_vocab bins, B12 (whose instance the
        # bins choose: shared counters up to the card's opt-in shared
        # memory, global ones above) and B11 against their plain
        # versions on the card, the whole gradient against the CPU
        V, per_mb = cfg.padded_vocab, TRAIN_BATCH * TRAIN_SEQ // \
            TRAIN_MICROBATCHES
        e = torch.from_numpy(rng.integers(0, V, per_mb).astype(
            np.int32)).to(dev)
        bb = default_block_b(V, L=per_mb)
        kw = dict(nbins=V, block_b=bb)
        offsets, _ = block_offsets(e, **kw)
        require(torch.equal(kernels["B12"](e, **kw),
                            block_histogram_ref(e, **kw)),
                f"{arch}: B12 at {V} bins differs from its plain version")
        require(torch.equal(kernels["B11"](e, offsets, **kw),
                            placement_ref(e, offsets, **kw)),
                f"{arch}: B11 at {V} bins differs from its plain version")
        eg = r["embed_grad"] = {
            "keys_bins": [per_mb, V], "block_b": bb,
            "B12_instance": "shared" if 4 * V <= hist_mod._fns()["smem"]
            else "global",
            "B12_ms": device_ms(lambda: kernels["B12"](e, **kw), cpm),
            "B11_ms": device_ms(lambda: kernels["B11"](e, offsets, **kw),
                                cpm),
            "B12_B11_vs_plain": "bit-identical"}
        eg.update(embedding_grad_check(V, CROSS_GRAD_D, kernels, dev, rng))
        print(f"phase 4m: {arch} embedding gradient at {V} bins: B12 "
              f"{eg['B12_instance']} counters, {json.dumps(eg)}", flush=True)
        stage["embed_grad"] = time.perf_counter() - t_arch - \
            sum(stage.values())

        # (c) float32 copies at full width against the CPU: loss_fn,
        # every gradient leaf, adamw_update on the same gradients
        cfg_f = dataclasses.replace(full, dtype="float32", **CROSS_F32[arch])
        S = CROSS_TRAIN_F32_SEQ
        t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1)).astype(
            np.int32))
        b1 = cross_batch(cfg_f, t1[:, :S], rng, S)
        b1["labels"] = t1[:, 1:]
        r[f"f32_{cfg_f.n_layers}_layers"], r["adamw_same_grads"] = \
            train_parity(cfg_f, b1, dev, tcfg.opt)
        torch.cuda.empty_cache()
        stage["parity"] = time.perf_counter() - t_arch - sum(stage.values())

        # (d) the launcher on the card, on the reduced config
        t0 = time.perf_counter()
        r["launcher"] = launcher_resume(arch, dev, "4m")
        r["launcher"]["s"] = time.perf_counter() - t0
        stage["launcher"] = time.perf_counter() - t0

    row["launches"] = launches
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4M_LIMIT_S,
            f"phase 4m took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4M_LIMIT_S} s")
    return launches


#: phase 4n: (a)'s and (b)'s time limits, in seconds, and the cells (a)
#: traces at once
PHASE_4NA_LIMIT_S = 600
PHASE_4NB_LIMIT_S = 180
DRYRUN_JOBS = 7
#: (a)'s multi-pod cells: one of each family (the whole sweep, 80 cells,
#: does not fit (a)'s limit; PERF.md gives its time from one CLI run)
DRYRUN_MULTI_CELLS = ("olmo_1b", "olmoe_1b_7b", "mamba2_780m", "zamba2_7b",
                      "seamless_m4t_medium", "llama_3_2_vision_11b")
#: per rank, from the reference's rules: the parameters in the serve mode
#: the dry run picks (TP only, but FSDP + TP for dbrx_132b) and the train
#: state, in MiB to one decimal (no rule names "pod": the same on both
#: meshes)
DRYRUN_PER_RANK_MIB = {
    "seamless_m4t_medium": (85.4, 313.0), "mamba2_780m": (93.2, 132.5),
    "dbrx_132b": (1060.7, 9486.3), "olmoe_1b_7b": (820.4, 602.0),
    "qwen3_0_6b": (71.2, 197.7), "starcoder2_15b": (2586.9, 1766.9),
    "gemma3_1b": (119.3, 372.1), "olmo_1b": (140.3, 182.8),
    "zamba2_7b": (791.7, 569.1), "llama_3_2_vision_11b": (1143.3, 1177.4),
}


def _kill_group(proc) -> None:
    """Stop a child started in a session of its own, and its children."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def start_dryrun_sweep() -> dict:
    """Start phase 4n (a)'s cells: the dry run's CLI in a child, niced
    below this process, while phases 4e-4m run (the cells trace on the
    host's cores, those phases drive the card)."""
    import atexit
    import tempfile

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models.config import SHAPES

    out = tempfile.mkdtemp(prefix="dryrun_")
    # the longest first (train, then prefill, the deepest archs first):
    # the cells pack onto the workers
    deep = sorted(ARCHS, key=lambda a: -get_config(a).n_layers)
    cells = [f"{a}:{s}:single" for s in ("train_4k", "prefill_32k",
                                          "long_500k", "decode_32k")
             for a in deep] + \
        [f"{a}:decode_32k:multi" for a in DRYRUN_MULTI_CELLS]
    assert len(cells) == len(ARCHS) * len(SHAPES) + len(DRYRUN_MULTI_CELLS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.time()
    proc = subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--cells", *cells, "--out", out,
         "--jobs", str(DRYRUN_JOBS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    atexit.register(_kill_group, proc)
    return {"proc": proc, "out": out, "cells": cells, "t0": t0}


def dryrun_sweep_phase(sweep: dict, smi_line) -> dict:
    """Phase 4n (a): the dry run's cells on the fake production meshes
    (the module docstring), started by :func:`start_dryrun_sweep`."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.specs import cell_applicable
    from repro_torch.models.config import SHAPES

    proc, out, cells = sweep["proc"], sweep["out"], sweep["cells"]
    left = PHASE_4NA_LIMIT_S - (time.time() - sweep["t0"])
    try:
        stdout, stderr = proc.communicate(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        fail(f"phase 4n (a): the dry run ran past {PHASE_4NA_LIMIT_S} s")
    print(stdout, end="", flush=True)
    require(proc.returncode == 0, f"phase 4n (a): the dry run exited "
            f"{proc.returncode}: {stderr[-3000:]}")
    res = {}
    done = sweep["t0"]
    for c in cells:
        a, sh, m = c.split(":")
        fn = os.path.join(out, f"{a}__{sh}__{m}.json")
        done = max(done, os.path.getmtime(fn))
        with open(fn) as f:
            res[(a, sh, m)] = json.load(f)
    wall = done - sweep["t0"]
    shutil.rmtree(out, ignore_errors=True)
    status = [r["status"] for r in res.values()]
    n_ok, n_skip = status.count("ok"), status.count("skipped")
    row = {"phase": "4n-a", "card": smi_line, "cells": len(res),
           "ok": n_ok, "skipped": n_skip, "errors": status.count("error"),
           "wall_s": wall, "why_not_80": "the whole sweep (80 cells) does "
           "not fit the phase's 600 s: PERF.md gives its time from one run "
           "of the CLI"}
    require(row["errors"] == 0, "phase 4n (a) errors: " + "; ".join(
        f"{k}: {r.get('error')}" for k, r in res.items()
        if r["status"] == "error"))
    want_skip = {(a, "long_500k", "single") for a in ARCHS
                 if not get_config(a).supports_long_context}
    require(len(want_skip) == 7, "seven full-attention archs expected")
    require({k for k, r in res.items() if r["status"] == "skipped"}
            == want_skip, "the skipped cells are not the seven "
            "full-attention archs' long_500k")
    for (a, sh, m), r in res.items():
        if r["status"] == "skipped":
            require(r["reason"] == cell_applicable(get_config(a),
                                                   SHAPES[sh])[1],
                    f"{a} x {sh}: skip reason {r['reason']!r}")
    require((n_ok, n_skip) == (33 + len(DRYRUN_MULTI_CELLS), 7),
            f"phase 4n (a): {n_ok} ok, {n_skip} skipped")
    for a in DRYRUN_MULTI_CELLS:
        r = res[(a, "decode_32k", "multi")]
        require(r["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
                and r["flops"] > 0, f"{a} multi-pod cell: {r['mesh_shape']}"
                f", flops {r['flops']}")
    # the parameters' and the train state's bytes per rank
    per_rank = {}
    for a, (serve_mib, train_mib) in DRYRUN_PER_RANK_MIB.items():
        got_serve = {res[k]["argument_bytes_by_input"]["params"]
                     for k in res if k[0] == a and k[1] != "train_4k"
                     and res[k]["status"] == "ok"}
        got_train = res[(a, "train_4k", "single")][
            "argument_bytes_by_input"]["state"]
        per_rank[a] = {"params_MiB": [round(b / 2**20, 1)
                                      for b in sorted(got_serve)],
                       "train_state_MiB": round(got_train / 2**20, 1)}
        require(per_rank[a]["params_MiB"] == [serve_mib]
                and per_rank[a]["train_state_MiB"] == train_mib,
                f"{a}: per-rank bytes {per_rank[a]} != the rules' "
                f"{serve_mib}, {train_mib} MiB")
    oks = {k: r for k, r in res.items() if r["status"] == "ok"}
    slow = max(oks, key=lambda k: oks[k]["trace_s"])
    row["slowest"] = {"cell": ":".join(slow),
                      "trace_s": oks[slow]["trace_s"]}
    row["trace_s_sum"] = sum(r["trace_s"] for r in oks.values())
    row["train_4k"] = {a: {"temp_bytes": res[(a, "train_4k", "single")][
        "memory"]["temp_bytes"], "flops": res[(a, "train_4k", "single")][
        "flops"]} for a in ARCHS}
    row["census_total_bytes"] = {
        a: {f"{sh}:{m}": r["collectives"]["total_bytes"]
            for (aa, sh, m), r in oks.items() if aa == a} for a in ARCHS}
    row["per_rank"] = per_rank
    row["cells_detail"] = {":".join(k): {
        "trace_s": r.get("trace_s"), "flops": r.get("flops"),
        "memory": r.get("memory"), "census": r.get("collectives"),
        "mismatches": r.get("placement_mismatches")}
        for k, r in oks.items()}
    row["mismatches_total"] = sum(len(r.get("placement_mismatches") or [])
                                  for r in oks.values())
    print(f"phase 4n (a): {len(res)} cells, {n_ok} ok, {n_skip} skipped, "
          f"0 errors in {wall:.1f} s; slowest {row['slowest']}; outputs "
          f"placed unlike out_shardings (serving steps: redistributed) "
          f"{row['mismatches_total']}", flush=True)
    for a in ARCHS:
        print(f"phase 4n (a): {a} train_4k per rank temp "
              f"{row['train_4k'][a]['temp_bytes'] / 2**30:.2f} GiB, "
              f"{row['train_4k'][a]['flops']:.4e} FLOPs; census totals "
              f"{row['census_total_bytes'][a]}", flush=True)
    emit(row)
    require(wall < PHASE_4NA_LIMIT_S, f"phase 4n (a) took {wall:.1f} s")
    return row


#: (b)'s fake 1 x 1 trace of 4i's step, in a child process (a process
#: group of its own): the config and the batch's shape come as arguments
_TRACE_4I = """
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.models.config import ShapeConfig

arch, layers, batch, seq, mb = sys.argv[1], *map(int, sys.argv[2:6])
D.get_config = lambda a: dataclasses.replace(get_config(a), n_layers=layers)
D.SHAPES = S.SHAPES = {"train_4k": ShapeConfig("train_4k", seq, batch,
                                               "train")}
D.init_fake_group(1)
mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
low, _ = D.build_lowered(arch, "train_4k", mesh, microbatches=mb)
rec = low.trace()
print(json.dumps({k: rec[k] for k in ("argument_bytes", "temp_bytes",
                                      "flops", "argument_bytes_by_input")}))
"""


def _local_tree(tree):
    """A tree of dicts and lists of DTensors as their local tensors."""
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_tree(v) for v in tree]
    return tree.to_local()


def local_params(node):
    """A model of DTensor parameters as plain tensors: each rank's local
    shards (on a one-rank mesh, the whole tensors, not copied)."""
    from torch import nn

    from repro_torch.models.layers import Params

    if isinstance(node, nn.ModuleList):
        return nn.ModuleList([local_params(b) for b in node])
    out = Params()
    for k in node.keys():
        v = node[k]
        out[k] = local_params(v) if isinstance(v, nn.Module) \
            else v.detach().to_local()
    return out


def sharded_step_phase(dev, kernels, smi_line) -> dict:
    """Phase 4n (b): a real sharded train step and decode step on a
    one-rank mesh against the plain ones (the module docstring)."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch.sharding import (batch_specs_for, cache_specs,
                                             param_specs)
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags
    from repro_torch.models.layers import stacked_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    row = {"phase": "4n-b", "card": smi_line, "arch": LM_ARCH,
           "n_layers": TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": TRAIN_MICROBATCHES}
    child = subprocess.Popen(
        [sys.executable, "-c", _TRACE_4I, LM_ARCH, str(TRAIN_LAYERS),
         str(TRAIN_BATCH), str(TRAIN_SEQ), str(TRAIN_MICROBATCHES)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    tcfg = ts_mod.TrainConfig(opt=opt_mod.OptConfig(lr=3e-4, warmup_steps=2,
                                                    total_steps=8),
                              microbatches=TRAIN_MICROBATCHES,
                              compress_grads=True, kv_chunk=1024)
    host = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                       seed=SEED).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = ts_mod.make_train_step(cfg, tcfg)

    def state_bytes(st):
        return sum(t.numel() * t.element_size()
                   for _, parts, _ in stacked_leaves(st) for t in parts)

    def leaves(st):
        return [t for _, parts, _ in stacked_leaves(st) for t in parts]

    # both steps with deterministic algorithms: float index_add_ on the
    # card (the embedding gradient's row sums) is otherwise free to add
    # in any order, and the clip norm spreads one bit to every leaf
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # the plain step; its state kept on the host
    runtime_flags.set_moe_mesh(None)
    runtime_flags.set_moe_groups(1)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = ts_mod.init_train_state(lm.init_model(cfg, seed=SEED, device=dev),
                                    tcfg)
    row["state_bytes"] = state_bytes(state)
    row["batch_bytes"] = sum(t.numel() * t.element_size()
                             for t in batch.values())
    args_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    state, m = step(state, batch)
    torch.cuda.synchronize()
    row["real_peak_less_args_bytes"] = \
        torch.cuda.max_memory_allocated() - base - args_bytes
    plain_launches = {k: kernels[k].launches for k in ("B11", "B12", "P34")}
    plain_loss = m["loss"].clone()
    plain_state = [t.cpu() for t in leaves(state)]
    del state, m
    torch.cuda.empty_cache()

    # the same step on DTensors on a one-rank mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        state = ts_mod.init_train_state(
            lm.init_model(cfg, seed=SEED, device=dev), tcfg)
        placed = dry._place(mesh, state, param_specs(mesh, state))
        del state
        b_placed = dry._place(mesh, batch, batch_specs_for(
            mesh, batch, batch=TRAIN_BATCH))
        runtime_flags.set_moe_mesh(mesh, ("data",))
        for f in kernels.values():
            f.launches = 0
        placed, m = step(placed, b_placed)
        torch.cuda.synchronize()
        dt_launches = {k: kernels[k].launches for k in ("B11", "B12", "P34")}
        same = [torch.equal(a.to(dev), b.to_local())
                for a, b in zip(plain_state, leaves(placed))]
        row["train"] = {"loss_equal": bool(torch.equal(
            plain_loss, m["loss"].to_local())), "leaves": len(same),
            "leaves_equal": sum(same), "loss": float(plain_loss)}
        row["launches"] = {"plain": plain_launches, "dtensor": dt_launches}
        del plain_state
        # the plain step's FLOPs, by FlopCounterMode, on the trained
        # state's tensors (a counted run dispatches otherwise, so it is
        # not the run held bit for bit above)
        plain = {k: (local_params(v) if k == "params" else
                     _local_tree(v)) for k, v in placed.items()}
        runtime_flags.set_moe_mesh(None)
        with FlopCounterMode(display=False) as fc:
            step(plain, batch)
        row["plain_flops"] = fc.get_total_flops()
        del plain
        # one decode step: the trained parameters, served TP-only
        params = placed["params"]
        plain_params = local_params(params)
        cache = lm.init_cache(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                              device=dev)
        tokens = batch["tokens"][:, :1].contiguous()
        with torch.inference_mode():
            runtime_flags.set_moe_mesh(None)
            for f in kernels.values():
                f.launches = 0
            logits, c_plain = lm.decode_step(plain_params, cache, tokens, cfg)
            plain_dec = {k: kernels[k].launches for k in ("B11", "B12", "P34")}
        p_placed = dry._place(mesh, plain_params, param_specs(
            mesh, plain_params, mode="serve"))
        c_placed = dry._place(mesh, cache, cache_specs(
            mesh, cache, cfg, batch=TRAIN_BATCH))
        t_placed = dry._place(mesh, {"t": tokens}, batch_specs_for(
            mesh, {"t": tokens}, batch=TRAIN_BATCH))["t"]
        with torch.no_grad():
            runtime_flags.set_moe_mesh(mesh, ("data",))
            for f in kernels.values():
                f.launches = 0
            logits2, c2 = lm.decode_step(p_placed, c_placed, t_placed, cfg)
            dt_dec = {k: kernels[k].launches for k in ("B11", "B12", "P34")}
        row["decode"] = {
            "logits_equal": bool(torch.equal(logits, logits2.to_local())),
            "cache_equal": all(torch.equal(c_plain[k], c2[k].to_local())
                               for k in c_plain),
            "launches": {"plain": plain_dec, "dtensor": dt_dec}}
    finally:
        runtime_flags.set_moe_mesh(None)
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    out, err = child.communicate(timeout=PHASE_4NB_LIMIT_S)
    require(child.returncode == 0, f"phase 4n (b): the fake trace exited "
            f"{child.returncode}: {err[-3000:]}")
    traced = json.loads(out.strip().splitlines()[-1])
    row["traced"] = traced
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    print(f"phase 4n (b): traced argument bytes {traced['argument_bytes']} "
          f"vs state + batch {row['state_bytes'] + row['batch_bytes']}; "
          f"traced temp {traced['temp_bytes'] / 2**30:.3f} GiB vs the card's "
          f"peak less the arguments "
          f"{row['real_peak_less_args_bytes'] / 2**30:.3f} GiB; traced "
          f"FLOPs {traced['flops']:.6e} vs FlopCounterMode "
          f"{row['plain_flops']:.6e}", flush=True)
    require(row["train"]["loss_equal"] and row["train"]["leaves_equal"]
            == row["train"]["leaves"], f"phase 4n (b): the DTensor train "
            f"step differs from the plain one: {row['train']}")
    require(row["decode"]["logits_equal"] and row["decode"]["cache_equal"],
            f"phase 4n (b): the DTensor decode differs: {row['decode']}")
    for what in ("plain", "dtensor"):
        require(all(v > 0 for v in row["launches"][what].values()),
                f"phase 4n (b): B12/B11 or P34 idle in the {what} step")
    require(row["launches"]["plain"] == row["launches"]["dtensor"]
            and plain_dec == dt_dec, f"phase 4n (b): launches differ: "
            f"{row['launches']}, decode {row['decode']['launches']}")
    require(traced["argument_bytes"] == row["state_bytes"]
            + row["batch_bytes"], "phase 4n (b): the traced argument bytes "
            "are not the real state's and batch's")
    require(traced["flops"] == row["plain_flops"], "phase 4n (b): the "
            "traced FLOPs are not FlopCounterMode's count of the plain step")
    require(row["phase_s"] < PHASE_4NB_LIMIT_S,
            f"phase 4n (b) took {row['phase_s']:.1f} s")
    return row


#: phase 4o: its limit in seconds, the ranks sharing the card, the LM's
#: (data, model) rank mesh, layers and steps, the timed repetitions
PHASE_4O_LIMIT_S = 180
RANK_WORLD = 4
RANK_MESH = (2, 2)
RANK_LM_LAYERS, RANK_LM_STEPS = 2, 3
RANK_REPS = 5
#: (b) the bf16 rank steps' losses against the one-process steps': the
#: (2, 2) mesh adds its matmuls' partial sums in bf16 in other orders.
#: The first step runs on the same weights (4.8e-5 apart on the H100,
#: PERF.md); the updates then carry the bf16 differences on (1.5e-3 and
#: 4.5e-3 at steps 2 and 3)
RANK_BF16_FIRST_RTOL = 1e-3
RANK_BF16_RTOL = 1e-2
#: (d) serving: OLMoE-1B-7B whole in bf16 on the (2, 2) rank mesh, one
#: request batch of 4h's prompts (LM_BATCH x LM_PROMPT), RANK_SERVE_GEN
#: tokens: one B12 and one B11 a MoE layer call, 16 layers x (the
#: prefill + 15 decode steps) on every rank.  4h writes its one-process
#: answers to ``build/`` RANK_SERVE_REF.
RANK_SERVE_GEN = 16
RANK_SERVE_CALLS = 16 * RANK_SERVE_GEN
RANK_SERVE_REF = "rank_serve_ref.npz"
#: the (2, 2) mesh sums the attention's output projection as two bf16
#: partial sums (its row-parallel halves, one a ``model`` rank) added in
#: bf16: one rounding more a layer than one process's single product,
#: which moves the prefill's logits by 2.9e-2 of max|logit| through 16
#: layers and the MoE routing (PERF.md).  So the ranks are held
#: to a one-process run that sums that projection as the mesh does
#: (``tp2_out_proj``): the prefill's last-position logits within
#: RANK_SERVE_RTOL x max|logit| (0 measured on the H100, PERF.md), a
#: generated token equal wherever that step's top-2 margin there exceeds
#: twice that bound, each decode step's logits within RANK_DECODE_RTOL
#: (a row is compared up to its first token that may differ: after it
#: the two feed different tokens); and to the plain one-process run
#: within 4h's LM_BF16_RTOL, its bound for two bf16 orders of this model
RANK_SERVE_RTOL = 1e-3
#: a decode step splits the batch over "data" (2 of 4 rows a rank): its
#: GEMMs have other row counts than one process's, so their float32
#: orders, and then a bf16 rounding or a MoE routing choice, may differ
#: (4.55e-2 of max|logit| measured on the H100, PERF.md; the prefill's
#: 2 x 512 rows a rank read 0): held to 4h's bound for two bf16 orders
#: of this model
RANK_DECODE_RTOL = LM_BF16_RTOL
#: float32 on the rank mesh against one process on the card: a one-layer
#: OLMoE (B = 2, S = 128, 3 decode steps) and each family's reduced
#: config, logits and every cache leaf within RANK_SERVE_F32_RTOL of the
#: leaf's max
RANK_SERVE_F32_RTOL = 1e-5
#: (name, arch, batch, prompt, extra_cache, decode steps) of the reduced
#: float32 configs served on the card ranks, as
#: ``tests/test_torch_ranks_serve.py`` serves them on the CPU: the six
#: families, then caches whose sequence is sharded (over data, over
#: model, over both) run past the ring buffer's wrap
RANK_SERVE_CASES = (
    ("dense", "olmo_1b", 4, 16, 0, 3),
    ("moe", "olmoe_1b_7b", 4, 16, 0, 3),
    ("ssm", "mamba2_780m", 4, 16, 0, 3),
    ("hybrid", "zamba2_7b", 4, 16, 0, 3),
    ("encdec", "seamless_m4t_medium", 4, 16, 0, 3),
    ("vlm", "llama_3_2_vision_11b", 4, 16, 0, 3),
    ("seq_data", "olmo_1b", 1, 16, 4, 6),
    ("seq_model", "gemma3_1b", 4, 16, 4, 6),
    ("seq_both", "gemma3_1b", 1, 16, 4, 6),
)
#: (e) PlanService(method="sharded") on set 3 and 2x20, its hits timed
#: RANK_SERVICE_REPS times (each request pays the host facade: 2-3 s at
#: 5e7 on every rank)
RANK_SERVICE_SETS = ("3", "2x20")
RANK_SERVICE_REPS = 3


def _rank_kernels() -> dict:
    """The wrappers the rank path launches, by their table names."""
    from repro_torch.kernels.counting_sort import counting_sort as cs_mod
    from repro_torch.kernels.hist import hist as hist_mod
    from repro_torch.kernels.pattern_build.ops import pattern_build
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod

    return {"B1": rs.digit_block_histogram, "B2": rs.digit_placement,
            "B3": ss_mod.gather_segment_sum,
            "B11": cs_mod.placement, "B12": hist_mod.block_histogram,
            "P34": pattern_build}


def _ranks_ms(fn, reps: int) -> list:
    """Host-clock ms of ``fn()`` on this rank, every call started after a
    barrier of all ranks and ended by a synchronize."""
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _rank_sparse(info, mesh, kernels) -> dict:
    """Phase 4o (a) on one rank: its block of every set, against block
    ``r`` of the one-process plan at p = 4 on the same card."""
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.launch import ranks as ranks_mod
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sparse import plan_sharded

    dev, r, p = info.device, info.rank, info.world
    one = Mesh(("data",), (p,), (dev,) * p)
    out = {}
    specs = {str(k): (c["siz"], c["nnz_row"], c["nrep"])
             for k, c in DATA_SETS.items()}
    specs["2x20"] = (BIG["siz"], BIG["nnz_row"], BIG["nrep"])
    for name, (siz, nnz_row, nrep) in specs.items():
        ii, jj, _, _ = ransparse(siz, nnz_row, nrep, seed=SEED)
        rows = torch.from_numpy((ii - 1).astype(np.int32)).to(dev)
        cols = torch.from_numpy((jj - 1).astype(np.int32)).to(dev)
        del ii, jj
        L = rows.shape[0]
        g = np.random.default_rng([SEED, 40])
        vi = torch.from_numpy(g.integers(-8, 9, L).astype(np.float32)).to(dev)
        v = torch.from_numpy(g.standard_normal(L).astype(np.float32)).to(dev)
        x = torch.from_numpy(g.standard_normal(siz).astype(np.float32)).to(dev)
        # the main path, counted on this rank
        torch.cuda.synchronize()
        for f in kernels.values():
            f.launches = 0
        pat = plan_sharded(rows, cols, (siz, siz), mesh=mesh)
        A = pat.assemble(vi)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in kernels.items()}
        npass = len(plan_digit_passes(pat.rpb, siz, p * pat.capacity))
        row = {"launches": launches,
               "expected": {"B1": npass, "B2": npass, "B3": 1, "B11": 0,
                            "B12": 0, "P34": 1}}
        # against block r of the one-process plan, on the same card
        ref = plan_sharded(rows, cols, (siz, siz), mesh=one)
        fields = ("send_slot", "perm", "slot", "indices", "indptr", "nnz",
                  "send_base", "block_load", "overflow")
        row["fields_equal"] = all(torch.equal(getattr(pat, f)[0],
                                              getattr(ref, f)[r])
                                  for f in fields)
        R = ref.assemble(vi)
        row["fill_int_equal"] = bool(torch.equal(A.data[0], R.data[r]))
        got, want = pat.assemble(v).data[0], ref.assemble(v).data[r]
        mag = ref.assemble(v.abs()).data[r]
        row["fill_err_over_eps"] = float(((got - want).abs() / (
            EPS32 * mag).clamp(min=1e-30)).max())
        y, y1 = A.spmv(x), R.spmv(x)
        bound = ref.assemble(vi.abs()).spmv(x.abs())
        row["spmv_err_over_eps"] = float(((y - y1).abs() / (
            EPS32 * bound).clamp(min=1e-30)).max())
        row["nnz_total"] = int(pat.nnz_total())
        row["any_overflow"] = bool(pat.any_overflow())
        row["nnz_one_process"] = int(ref.nnz_total())
        del ref, R, got, want, mag
        # the times: the plan and the fill on the rank mesh, and the
        # fill's exchange alone (its bucket buffer through all_to_all)
        reps = RANK_REPS
        row["plan_sharded_ranks_ms"] = _ranks_ms(
            lambda: plan_sharded(rows, cols, (siz, siz), mesh=mesh), reps)
        row["routed_fill_ranks_ms"] = _ranks_ms(lambda: pat.assemble(v),
                                                reps)
        buf = torch.zeros(p, pat.capacity, device=dev)
        group = mesh.get_group("data")
        row["exchange_ms"] = _ranks_ms(
            lambda: ranks_mod.exchange(buf, group), reps)
        row["exchange_bytes"] = int(buf.numel() * 4)
        out[name] = row
        del pat, A, rows, cols, v, vi, x, buf
        torch.cuda.empty_cache()
    return out


def _rank_lm(info, kernels) -> dict:
    """Phase 4o (b) on one rank: OLMoE at full width on a (2, 2) rank
    mesh, against the one-process steps (rank 0)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import place_on_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags
    from repro_torch.models.layers import stacked_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    dev, r = info.device, info.rank
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=RANK_LM_LAYERS)
    mesh = make_host_mesh(data=RANK_MESH[0], model=RANK_MESH[1])
    tcfg = ts_mod.TrainConfig(
        opt=opt_mod.OptConfig(lr=3e-4, warmup_steps=2,
                              total_steps=RANK_LM_STEPS),
        microbatches=1, compress_grads=True, kv_chunk=TRAIN_SEQ)
    host = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                       seed=SEED).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    out = {"stage_s": {}}
    t_stage = time.perf_counter()

    def stage(name):
        nonlocal t_stage
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage
        t_stage = now

    def whole_state():
        return ts_mod.init_train_state(lm.init_model(cfg, seed=SEED,
                                                     device=dev), tcfg)

    # the batch first: DTensor's first use imports its machinery, which
    # takes seconds, on every rank at once; then the ranks take turns to
    # draw the whole state and keep their shards (four whole states at
    # once would not fit the card)
    placed = place_on_mesh(mesh, batch, batch=TRAIN_BATCH)
    state = None
    for turn in range(info.world):
        if turn == r:
            state = place_on_mesh(mesh, whole_state())
            torch.cuda.empty_cache()
        dist.barrier()
    out["state_local_GB"] = sum(
        t.to_local().numel() * t.element_size() for _, parts, _ in
        stacked_leaves(state) for t in parts) / 1e9
    stage("place")
    step = ts_mod.make_train_step(cfg, tcfg)
    runtime_flags.set_moe_mesh(mesh, ("data",))
    losses, step_ms = [], []
    torch.cuda.synchronize()
    for f in kernels.values():
        f.launches = 0
    for _ in range(RANK_LM_STEPS):
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, placed)
        losses.append(float(m["loss"].full_tensor()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["launches"] = {k: f.launches for k, f in kernels.items()}
    out["losses"], out["step_ms"] = losses, step_ms
    out["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    runtime_flags.set_moe_mesh(None)
    del state, placed
    torch.cuda.empty_cache()
    dist.barrier()
    stage("steps")
    # the one-process steps on the same state and batch (rank 0; two
    # token groups, as the two data shards dispatch)
    if r == 0:
        runtime_flags.set_moe_groups(RANK_MESH[0])
        state = whole_state()
        plain = []
        for _ in range(RANK_LM_STEPS):
            state, m = step(state, batch)
            plain.append(float(m["loss"]))
        runtime_flags.set_moe_groups(1)
        out["plain_losses"] = plain
        del state
        torch.cuda.empty_cache()
    dist.barrier()
    stage("one_process_steps")

    cfg1 = dataclasses.replace(full, n_layers=1, dtype="float32")
    b1 = {k: v[:2, :128].contiguous() for k, v in batch.items()}
    out.update(_rank_f32(info, mesh, cfg1, b1, tcfg))
    torch.cuda.empty_cache()
    dist.barrier()
    stage("f32")
    return out


def _rank_f32(info, mesh, cfg1, batch, tcfg) -> dict:
    """Phase 4o (b)'s float32 copy on one rank: a train step of ``cfg1``
    on the rank mesh against one process's on the same weights, each
    rank on its shards (one process's tensor cut by the mesh leaf's
    placements).  The loss and every gradient leaf; then the step's
    update half (``train_step.apply_gradients``: the compression with
    error feedback, the global norm over the shards, AdamW on each
    shard) on one process's gradients handed to both sides, every leaf
    of the parameters, master, mu, nu and ef against one process's.
    Returns the errors, each over the leaf's largest magnitude."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.sharding import place_on_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.shards import replicating
    from repro_torch.train import train_step as ts_mod

    dev, B, S = info.device, *batch["tokens"].shape
    out = {"card_free_GB": torch.cuda.mem_get_info(dev)[0] / 1e9}

    def cut(t, like):
        """One process's whole ``t`` as this rank's shard of ``like``."""
        return distribute_tensor(t, mesh, like.placements,
                                 src_data_rank=None)

    def leaves_of(state):
        return {"params": tree_leaves(state["params"]),
                **{k: tree_leaves(state["opt"][k])
                   for k in ("master", "mu", "nu")},
                "ef": tree_leaves(state["ef"])}

    def whole_state():
        return ts_mod.init_train_state(lm.init_model(cfg1, seed=SEED,
                                                     device=dev), tcfg)

    # the ranks take turns (a whole float32 state a rank at once would
    # crowd the card) to draw the whole state, take one process's loss
    # and gradients on it (two token groups, as the two data shards
    # dispatch) and keep their shards
    state = ref_loss = ref_grads = None
    for turn in range(info.world):
        if turn == info.rank:
            whole = whole_state()
            runtime_flags.set_moe_groups(RANK_MESH[0])
            loss = lm.loss_fn(whole["params"], batch, cfg1, kv_chunk=S)
            ref_grads = list(torch.autograd.grad(
                loss, tree_leaves(whole["params"])))
            runtime_flags.set_moe_groups(1)
            ref_loss = float(loss)
            state = place_on_mesh(mesh, whole)
            del whole, loss
            torch.cuda.empty_cache()
        dist.barrier()
    mesh_leaves = leaves_of(state)
    b_mesh = place_on_mesh(mesh, batch, batch=B)
    runtime_flags.set_moe_mesh(mesh, ("data",))
    with replicating(b_mesh["tokens"]):
        loss = lm.loss_fn(state["params"], b_mesh, cfg1, kv_chunk=S)
        grads = torch.autograd.grad(loss, mesh_leaves["params"])
    runtime_flags.set_moe_mesh(None)
    out["f32_loss_rel_err"] = abs(float(loss.full_tensor()) - ref_loss) \
        / abs(ref_loss)
    out["f32_grad_rel_err"] = max(
        float((g.redistribute(placements=p.placements).to_local()
               - cut(ref, p).to_local()).abs().max()
              / ref.abs().max().clamp(min=1e-30))
        for g, ref, p in zip(grads, ref_grads, mesh_leaves["params"]))
    del grads, loss
    # the update half on one process's gradients handed to both sides:
    # the rank mesh's first, on its shards copied out of them ...
    handed = [DTensor.from_local(cut(g, p).to_local().clone(), mesh,
                                 p.placements, run_check=False,
                                 shape=p.shape, stride=p.stride())
              for g, p in zip(ref_grads, mesh_leaves["params"])]
    gn = ts_mod.apply_gradients(state, handed, tcfg)["grad_norm"]
    gn = float(gn.full_tensor() if isinstance(gn, DTensor) else gn)
    mine = leaves_of(state)
    # ... then one process's, in turns, each rank against its shards
    errs, norm1 = {}, None
    for turn in range(info.world):
        if turn == info.rank:
            whole = whole_state()
            norm1 = float(ts_mod.apply_gradients(whole, ref_grads,
                                                 tcfg)["grad_norm"])
            for k, ws in leaves_of(whole).items():
                errs[k] = max(float(
                    (m.to_local() - cut(w, m).to_local()).abs().max()
                    / w.abs().max().clamp(min=1e-30))
                    for w, m in zip(ws, mine[k]))
            del whole
            torch.cuda.empty_cache()
        dist.barrier()
    out["f32_grad_norm_rel_diff"] = abs(gn / norm1 - 1)
    out["f32_opt_rel_err"] = errs
    return out


def _gathered(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _serve_pair(cfg, mesh, batch: dict, decode, extra: int, dev) -> dict:
    """``prefill`` and decode steps of ``cfg`` (float32) on one process
    and on the rank mesh, on the same weights (seed SEED) and inputs:
    the worst error of the logits and of every cache leaf, each over the
    one-process leaf's max, and the outputs the ranks' steps moved to
    where the reference's ``out_shardings`` put them
    (``model.LAYOUT_FIXES``: a list a step)."""
    from repro_torch.launch.sharding import (param_bytes, place_on_mesh,
                                             place_tokens, serving_mode)
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags

    B = batch["tokens"].shape[0]
    kv = dict(kv_chunk=batch["tokens"].shape[1], extra_cache=extra)
    runs = {}
    groups = runtime_flags.set_moe_dispatch(cfg, mesh, B)
    with torch.no_grad():  # as launch/serve.py serves on ranks
        whole = lm.init_model(cfg, seed=SEED, device=dev)
        placed = place_on_mesh(mesh, whole,
                               mode=serving_mode(mesh, param_bytes(whole)))
        for side, params in (("ranks", placed), ("one", whole)):
            if side == "one":  # the same token groups, on one process
                runtime_flags.set_moe_mesh(None)
            b = batch if side == "one" else place_on_mesh(mesh, batch,
                                                          batch=B)
            lm.LAYOUT_FIXES.clear()
            logits, cache = lm.prefill(params, b, cfg, **kv)
            got, fixes = [_gathered(logits)], [list(lm.LAYOUT_FIXES)]
            for tok in decode:
                t = tok if side == "one" else place_tokens(mesh, tok)
                lm.LAYOUT_FIXES.clear()
                logits, cache = lm.decode_step(params, cache, t, cfg)
                got.append(_gathered(logits))
                fixes.append(list(lm.LAYOUT_FIXES))
            if side == "ranks":
                layout_fixes = fixes
            runs[side] = (got, {k: _gathered(v) for k, v in cache.items()
                                if k != "pos"})
    runtime_flags.set_moe_dispatch(cfg, None, B)
    (lr, cr), (lo, co) = runs["ranks"], runs["one"]
    return {"groups": groups, "layout_fixes": layout_fixes,
            "logits_rel_err": max(_rel_err(a, b) for a, b in zip(lr, lo)),
            "cache_rel_err": max(_rel_err(cr[k], co[k]) for k in co)}


def _rank_serve(info, kernels) -> dict:
    """Phase 4o (d) on one rank: OLMoE-1B-7B served whole on a (2, 2)
    rank mesh against 4h's one-process run, then float32 copies."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (model_param_bytes, node_placer,
                                             place_on_mesh, serving_mode)
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags
    from repro_torch.models.shards import greedy_tokens

    dev = info.device
    cfg = get_config(LM_ARCH)
    mesh = make_host_mesh(data=RANK_MESH[0], model=RANK_MESH[1])
    out = {"stage_s": {}}
    t_stage = time.perf_counter()

    def stage(name):
        nonlocal t_stage
        now = time.perf_counter()
        out["stage_s"][name] = now - t_stage
        t_stage = now

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["mode"] = mode = serving_mode(mesh, model_param_bytes(cfg))
    out["groups"] = runtime_flags.set_moe_dispatch(cfg, mesh, LM_BATCH)
    prompts = torch.from_numpy(rank_serve_prompts(cfg)).to(dev)
    with torch.no_grad():  # as launch/serve.py serves on ranks
        # every rank draws the model from the seed block by block and
        # keeps its shards: never the whole model at once
        params = lm.init_model(cfg, seed=SEED, device=dev,
                               place=node_placer(mesh, mode))
        torch.cuda.synchronize()
        out["weights_local_GB"] = sum(
            p.to_local().numel() * p.element_size()
            for p in params.parameters()) / 1e9
        out["init_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        batch = place_on_mesh(mesh, {"tokens": prompts}, batch=LM_BATCH)
        stage("init")
        # the main path, counted and timed on this rank
        dist.barrier()
        torch.cuda.synchronize()
        for f in kernels.values():
            f.launches = 0
        lm.LAYOUT_FIXES.clear()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, batch, cfg, kv_chunk=LM_PROMPT)
        tok = greedy_tokens(logits, cfg.vocab)
        torch.cuda.synchronize()
        out["prefill_ranks_ms"] = (time.perf_counter() - t0) * 1e3
        toks, decode_ms, lasts = [tok], [], [logits[:, -1]]
        fixes = [list(lm.LAYOUT_FIXES)]
        for _ in range(RANK_SERVE_GEN - 1):
            lm.LAYOUT_FIXES.clear()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(params, cache,
                                           tok.to(torch.int32), cfg)
            tok = greedy_tokens(logits, cfg.vocab)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            lasts.append(logits[:, -1])
            fixes.append(list(lm.LAYOUT_FIXES))
        out["launches"] = {k: f.launches for k, f in kernels.items()}
        out["decode_ranks_ms"] = decode_ms
        out["served_s"] = (out["prefill_ranks_ms"] + sum(decode_ms)) / 1e3
        out["tok_per_s_ranks"] = LM_BATCH * RANK_SERVE_GEN / out["served_s"]
        out["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        out["layout_fixes"] = fixes
        out["cache_local_GB"] = sum(
            v.to_local().numel() * v.element_size() for k, v in
            cache.items() if k != "pos") / 1e9
        stage("served")
        # against 4h's one process: the prefill's last-position logits,
        # then each row's tokens and each step's logits up to its first
        # token that may differ
        ref = dict(np.load(ROOT / "build" / RANK_SERVE_REF))
        served = np.stack([x.full_tensor()[:, :cfg.vocab].float().cpu()
                          .numpy() for x in lasts], 1)
        gen = torch.cat(toks, 1).full_tensor().cpu().numpy()
    del params, cache, logits, lasts, batch
    runtime_flags.set_moe_dispatch(cfg, None, LM_BATCH)
    torch.cuda.empty_cache()
    got, want = served[:, 0], ref["logits"][:, 0]
    out["prefill_rel_err"] = float(np.abs(got - want).max()
                                   / np.abs(want).max())
    out["prefill_plain_rel_err"] = float(
        np.abs(got - ref["prefill_plain"]).max()
        / np.abs(ref["prefill_plain"]).max())
    compared, diverged, decode_err = 0, [], 0.0
    for b in range(LM_BATCH):
        for t in range(RANK_SERVE_GEN):
            if t:  # fed the same tokens so far
                decode_err = max(decode_err, float(np.abs(
                    served[b, t] - ref["logits"][b, t]).max()
                    / ref["peaks"][t]))
            if gen[b, t] == ref["tokens"][b, t]:
                compared += 1
                continue
            diverged.append({"row": b, "step": t, "margin_over_peak": float(
                ref["margins"][b, t] / ref["peaks"][t])})
            break
    out["tokens_row0"] = gen[0].tolist()
    out["tokens_compared"], out["tokens_diverged"] = compared, diverged
    out["decode_rel_err"] = decode_err
    dist.barrier()
    stage("checked")

    # the float32 copies, on one process and on the rank mesh on the card
    rng = np.random.default_rng([SEED, 42])
    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    toks1 = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)).astype(
        np.int32)).to(dev)
    dec1 = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 2, 1)).astype(
        np.int32)).to(dev)
    out["f32_one_layer"] = _serve_pair(cfg1, mesh, {"tokens": toks1},
                                       dec1, 0, dev)
    torch.cuda.empty_cache()
    stage("f32")
    out["families"] = {}
    for name, arch, B, S, extra, steps in RANK_SERVE_CASES:
        c = get_config(arch).reduced(dtype="float32")
        g = np.random.default_rng([SEED, 43, len(out["families"])])
        b = {"tokens": g.integers(0, c.vocab, (B, S)).astype(np.int32)}
        if c.family == "encdec":
            b["src_embeds"] = g.normal(size=(B, S, c.d_model))
        if c.family == "vlm":
            b["vision_embeds"] = g.normal(size=(B, c.n_vision_tokens,
                                                c.d_model))
        b = {k: torch.from_numpy(v.astype(np.float32) if v.dtype.kind == "f"
                                 else v).to(dev) for k, v in b.items()}
        dec = torch.from_numpy(g.integers(0, c.vocab, (steps, B, 1)).astype(
            np.int32)).to(dev)
        out["families"][name] = _serve_pair(c, mesh, b, dec, extra, dev)
    stage("families")
    return out


def _rank_service(info, mesh, kernels) -> dict:
    """Phase 4o (e) on one rank: ``PlanService(method="sharded")`` on the
    rank mesh, each set's block against block r of 4g's one-process
    call (made again in the rank, on the same card)."""
    import dataclasses

    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve import PlanService
    from repro_torch.sparse import fsparse, plan_sharded

    dev, r, p = info.device, info.rank, info.world
    one = Mesh(("data",), (p,), (dev,) * p)
    svc = PlanService(method="sharded", device=dev)
    specs = {"3": tuple(DATA_SETS[3][k] for k in ("siz", "nnz_row", "nrep")),
             "2x20": (BIG["siz"], BIG["nnz_row"], BIG["nrep"])}
    out = {}
    for name in RANK_SERVICE_SETS:
        siz, nnz_row, nrep = specs[name]
        ii, jj, _, _ = ransparse(siz, nnz_row, nrep, seed=SEED)
        shape = (siz, siz)
        g = np.random.default_rng([SEED, 44])
        vi = g.integers(-8, 9, ii.shape[0]).astype(np.float32)
        x = torch.from_numpy(g.standard_normal(siz).astype(np.float32)).to(
            dev)
        torch.cuda.synchronize()
        for f in kernels.values():
            f.launches = 0
        A = svc.assemble(ii, jj, vi, shape)
        torch.cuda.synchronize()
        row = {"launches": {k: f.launches for k, f in kernels.items()}}
        for f in kernels.values():
            f.launches = 0
        many = svc.assemble_many([(ii, jj, vi, shape),
                                  (ii, jj, 2 * vi, shape)])
        torch.cuda.synchronize()
        row["many_launches"] = {k: f.launches for k, f in kernels.items()}
        pat = plan_sharded(torch.from_numpy((ii - 1).astype(np.int32)).to(
            dev), torch.from_numpy((jj - 1).astype(np.int32)).to(dev), shape,
            mesh=mesh)
        npass = len(plan_digit_passes(pat.rpb, siz, p * pat.capacity))
        row["expected"] = {"B1": npass, "B2": npass, "B3": 1, "B11": 0,
                           "B12": 0, "P34": 1}
        row["many_expected"] = {"B1": 0, "B2": 0, "B3": 2, "B11": 0,
                                "B12": 0, "P34": 0}
        del pat
        ref = fsparse(ii, jj, vi, shape, method="sharded", mesh=one)
        row["block_equal"] = bool(torch.equal(A.data[0], ref.data[r])
                                  and torch.equal(A.indices[0],
                                                  ref.indices[r]))
        row["many_equal"] = bool(torch.equal(many[0].data[0], ref.data[r])
                                 and torch.equal(many[1].data[0],
                                                 2 * ref.data[r]))
        y, y1 = svc.spmv(A, x), ref.spmv(x)
        bound = dataclasses.replace(ref, data=ref.data.abs()).spmv(x.abs())
        row["spmv_err_over_eps"] = float(((y - y1).abs() / (
            EPS32 * bound).clamp(min=1e-30)).max())
        row["hit_ranks_ms"] = _ranks_ms(
            lambda: svc.assemble(ii, jj, vi, shape), RANK_SERVICE_REPS)
        out[name] = row
        del A, many, ref, y, y1, bound, x, ii, jj, vi
        torch.cuda.empty_cache()
    st = svc.stats()
    out["stats"] = {"plan": st["plan"], "persisted": st["persisted"],
                    "device": st["device"]}
    return out


def ranks_child(outdir: str) -> None:
    """``python3 chip_smoke.py --ranks-phase DIR``: one rank of phase 4o;
    writes ``DIR/rank<r>.json``."""
    from repro_torch.launch.mesh import init_ranks, make_data_mesh

    info = init_ranks()
    print(f"phase 4o: {info.describe()}", flush=True)
    kernels = _rank_kernels()
    t0 = time.perf_counter()
    res = {"rank": info.rank, "world": info.world,
           "backend": info.backend, "device": str(info.device),
           "sparse": _rank_sparse(info, make_data_mesh(), kernels)}
    res["sparse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["lm"] = _rank_lm(info, kernels)
    res["lm_s"] = time.perf_counter() - t0
    # (d) serving and (e) the plan service, before (c): the launcher
    # ends the group at its exit
    t0 = time.perf_counter()
    res["serve"] = _rank_serve(info, kernels)
    res["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["service"] = _rank_service(info, make_data_mesh(), kernels)
    res["service_s"] = time.perf_counter() - t0
    # (c) the launcher on this group, which it ends
    from repro_torch.launch import train as train_mod

    t0 = time.perf_counter()
    res["launcher_rc"] = train_mod.main([
        "--arch", "olmo_1b", "--reduced", "--dp", str(RANK_MESH[0]),
        "--tp", str(RANK_MESH[1]), "--steps", "3", "--log-every", "1",
        "--ckpt-dir", os.path.join(outdir, "ckpt")])
    res["launcher_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"rank{info.rank}.json"), "w") as f:
        json.dump(res, f)


def ranks_phase(smi_line) -> dict:
    """Phase 4o (the module docstring).  Returns the launches of its
    main paths on each rank: ``{kernel: [rank 0, ...]}``."""
    import tempfile

    from repro_torch.launch.ranks import choose_backend, spawn_ranks

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    backend = choose_backend("cuda", ranks_on_host=RANK_WORLD, cards=count)
    print(f"phase 4o: {RANK_WORLD} ranks on {count} card(s), backend "
          f"{backend}; {smi_line}", flush=True)
    row = {"phase": "4o", "card": smi_line, "world": RANK_WORLD,
           "backend": backend}
    torch.cuda.empty_cache()
    row["card_free_GB"] = torch.cuda.mem_get_info()[0] / 1e9
    tmp = Path(tempfile.mkdtemp(prefix="ranks_", dir=ROOT / "build"))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    try:
        res = spawn_ranks([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--ranks-phase", str(tmp)], RANK_WORLD,
                          timeout_s=PHASE_4O_LIMIT_S, env=env,
                          rendezvous=str(tmp / "rendezvous"))
    except RuntimeError as e:
        print(f"phase 4o: {e}", file=sys.stderr, flush=True)  # every rank
        fail(f"phase 4o: {e}"[:6000])
    for rc, so, _ in res:
        print("\n".join(ln for ln in so.splitlines()
                        if not ln.startswith("[train]")), flush=True)
    ranks = [json.load(open(tmp / f"rank{r}.json"))
             for r in range(RANK_WORLD)]
    for q in ranks:
        require(q["backend"] == backend and q["world"] == RANK_WORLD
                and q["device"] == "cuda:0", f"phase 4o: rank {q['rank']} "
                f"ran on {q['device']} over {q['backend']}")
    # (a) the sparse path, rank by rank
    sets = {}
    for name in ranks[0]["sparse"]:
        per = [q["sparse"][name] for q in ranks]
        for r, a in enumerate(per):
            require(a["launches"] == a["expected"], f"phase 4o (a), set "
                    f"{name}, rank {r}: launches {a['launches']} != "
                    f"{a['expected']}")
            require(a["fields_equal"] and a["fill_int_equal"],
                    f"phase 4o (a), set {name}, rank {r}: the block differs "
                    "from block r of the one-process plan or fill")
            require(a["fill_err_over_eps"] <= C_SEG, f"phase 4o (a), set "
                    f"{name}, rank {r}: fill error {a['fill_err_over_eps']}"
                    f" eps x sum|terms| > {C_SEG}")
            require(a["spmv_err_over_eps"] <= 8, f"phase 4o (a), set "
                    f"{name}, rank {r}: SpMV error {a['spmv_err_over_eps']}"
                    " eps x sum_j |a_ij x_j| > 8")
            require(a["nnz_total"] == a["nnz_one_process"]
                    and not a["any_overflow"], f"phase 4o (a), set {name}, "
                    f"rank {r}: nnz {a['nnz_total']} vs "
                    f"{a['nnz_one_process']}, overflow {a['any_overflow']}")
        sets[name] = {
            "launches": [a["launches"] for a in per],
            "plan_sharded_ranks_ms": max(float(np.median(
                a["plan_sharded_ranks_ms"])) for a in per),
            "routed_fill_ranks_ms": max(float(np.median(
                a["routed_fill_ranks_ms"])) for a in per),
            "exchange_ms": max(float(np.median(a["exchange_ms"]))
                               for a in per),
            "exchange_bytes_a_rank": per[0]["exchange_bytes"],
            "fill_err_over_eps": max(a["fill_err_over_eps"] for a in per),
            "spmv_err_over_eps": max(a["spmv_err_over_eps"] for a in per)}
        t = sets[name]
        print(f"phase 4o (a): set {name}: plan_sharded_ranks_ms "
              f"{t['plan_sharded_ranks_ms']:.4g}, routed_fill_ranks_ms "
              f"{t['routed_fill_ranks_ms']:.4g}, exchange_ms "
              f"{t['exchange_ms']:.4g} ({t['exchange_bytes_a_rank']} B a "
              f"rank); B1/B2/B3' a rank "
              f"{[(x['B1'], x['B2'], x['B3']) for x in t['launches']]}",
              flush=True)
    row["sets"] = sets
    row["sparse_s"] = max(q["sparse_s"] for q in ranks)
    # (b) the LM step on the (2, 2) rank mesh
    lm_rows = [q["lm"] for q in ranks]
    losses, plain = lm_rows[0]["losses"], lm_rows[0]["plain_losses"]
    require(all(q["losses"] == losses for q in lm_rows)
            and all(np.isfinite(losses)), f"phase 4o (b): the ranks' "
            f"losses differ or are not finite: {[q['losses'] for q in lm_rows]}")
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    rel = max(rels)
    require(rels[0] <= RANK_BF16_FIRST_RTOL and rel <= RANK_BF16_RTOL,
            f"phase 4o (b): the rank steps' losses {losses} vs the "
            f"one-process steps' {plain} (rel {rels})")
    per_run = RANK_LM_STEPS * (2 * RANK_LM_LAYERS + 1)
    for r, q in enumerate(lm_rows):
        require(q["launches"]["B12"] == per_run == q["launches"]["B11"],
                f"phase 4o (b), rank {r}: B12/B11 {q['launches']}, not "
                f"{per_run} each")
        require(q["launches"]["P34"] == RANK_LM_STEPS,
                f"phase 4o (b), rank {r}: P34 {q['launches']['P34']}, not "
                f"one a step's embedding gradient ({RANK_LM_STEPS})")
    f32 = {k: max(q[k] for q in lm_rows)
           for k in ("f32_loss_rel_err", "f32_grad_rel_err",
                     "f32_grad_norm_rel_diff")}
    f32["f32_opt_rel_err"] = {k: max(q["f32_opt_rel_err"][k]
                                     for q in lm_rows)
                              for k in lm_rows[0]["f32_opt_rel_err"]}
    require(f32["f32_loss_rel_err"] <= TRAIN_F32_RTOL
            and f32["f32_grad_rel_err"] <= TRAIN_F32_RTOL,
            f"phase 4o (b): the float32 copy on the rank mesh differs from "
            f"one process: loss {f32['f32_loss_rel_err']:.3g}, gradients "
            f"{f32['f32_grad_rel_err']:.3g} (limit {TRAIN_F32_RTOL})")
    require(f32["f32_grad_norm_rel_diff"] <= TRAIN_OPT_RTOL
            and all(v <= TRAIN_OPT_RTOL
                    for v in f32["f32_opt_rel_err"].values()),
            f"phase 4o (b): apply_gradients on the rank mesh differs from "
            f"one process's on the same gradients: {f32['f32_opt_rel_err']}"
            f", grad norm {f32['f32_grad_norm_rel_diff']:.3g} (limit "
            f"{TRAIN_OPT_RTOL})")
    row["lm"] = {
        "arch": LM_ARCH, "n_layers": RANK_LM_LAYERS, "mesh": RANK_MESH,
        "losses": losses, "plain_losses": plain, "loss_rel_diff": rels,
        "launches": [q["launches"] for q in lm_rows],
        "step_ms": [max(q["step_ms"][i] for q in lm_rows)
                    for i in range(RANK_LM_STEPS)],
        "state_local_GB": [q["state_local_GB"] for q in lm_rows],
        "peak_GB": [q["peak_GB"] for q in lm_rows],
        **f32,
        "stage_s": [q["stage_s"] for q in lm_rows],
        "f32_card_free_GB": [q["card_free_GB"] for q in lm_rows]}
    row["lm_s"] = max(q["lm_s"] for q in ranks)
    print(f"phase 4o (b): {LM_ARCH} on {RANK_LM_LAYERS} layers, mesh "
          f"{RANK_MESH}: losses {losses} vs one process {plain}; step_ms "
          f"{row['lm']['step_ms']}; B12/B11 a rank "
          f"{[(x['B12'], x['B11']) for x in row['lm']['launches']]}; "
          f"float32 loss {f32['f32_loss_rel_err']:.3g}, gradients "
          f"{f32['f32_grad_rel_err']:.3g}, the update on the same "
          f"gradients {f32['f32_opt_rel_err']} (grad norm "
          f"{f32['f32_grad_norm_rel_diff']:.3g})", flush=True)
    # (d) serving OLMoE-1B-7B on the (2, 2) rank mesh, and (e) the plan
    # service: every figure printed first, then checked
    sv = [q["serve"] for q in ranks]
    serve = {
        "arch": LM_ARCH, "mesh": RANK_MESH, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "gen": RANK_SERVE_GEN,
        "weights": sv[0]["mode"], "moe_groups": sv[0]["groups"],
        "prefill_ranks_ms": max(q["prefill_ranks_ms"] for q in sv),
        "decode_ranks_ms": max(float(np.median(q["decode_ranks_ms"]))
                               for q in sv),
        "decode_ranks_ms_each": [max(q["decode_ranks_ms"][i] for q in sv)
                                 for i in range(RANK_SERVE_GEN - 1)],
        "tok_per_s_ranks": min(q["tok_per_s_ranks"] for q in sv),
        "peak_GB": [q["peak_GB"] for q in sv],
        "init_peak_GB": [q["init_peak_GB"] for q in sv],
        "weights_local_GB": [q["weights_local_GB"] for q in sv],
        "cache_local_GB": [q["cache_local_GB"] for q in sv],
        "launches": [q["launches"] for q in sv],
        "prefill_rel_err": max(q["prefill_rel_err"] for q in sv),
        "prefill_plain_rel_err": max(q["prefill_plain_rel_err"]
                                     for q in sv),
        "decode_rel_err": max(q["decode_rel_err"] for q in sv),
        "layout_fixes_a_step": [len(f) for f in sv[0]["layout_fixes"]],
        "layout_fixes_moved": sorted({x for f in sv[0]["layout_fixes"]
                                      for x in f}),
        "tokens_row0": sv[0]["tokens_row0"],
        "tokens_compared": sv[0]["tokens_compared"],
        "tokens_diverged": sv[0]["tokens_diverged"],
        "f32_one_layer": {k: max(q["f32_one_layer"][k] for q in sv)
                          for k in ("logits_rel_err", "cache_rel_err")},
        "families": {n: {k: max(q["families"][n][k] for q in sv)
                         for k in ("logits_rel_err", "cache_rel_err")}
                     for n in sv[0]["families"]},
        "f32_layout_fixes_a_step": {
            n: [len(f) for f in q["layout_fixes"]] for n, q in [
                ("f32_one_layer", sv[0]["f32_one_layer"]),
                *sv[0]["families"].items()]},
        "stage_s": [q["stage_s"] for q in sv]}
    row["serve"] = serve
    row["serve_s"] = max(q["serve_s"] for q in ranks)
    print(f"phase 4o (d): {LM_ARCH} whole on {RANK_MESH}, "
          f"{serve['weights']} weights ({serve['weights_local_GB'][0]:.3f} "
          f"GB a rank), {serve['moe_groups']} token groups: "
          f"prefill_ranks_ms {serve['prefill_ranks_ms']:.1f}, "
          f"decode_ranks_ms {serve['decode_ranks_ms']:.1f}, "
          f"tok_per_s_ranks {serve['tok_per_s_ranks']:.2f}, peak GB a "
          f"rank {max(serve['peak_GB']):.2f}; prefill "
          f"{serve['prefill_rel_err']:.3g} of max|logit| from one process "
          f"summing the output projection as the mesh does "
          f"({serve['prefill_plain_rel_err']:.3g} from one process as it "
          f"sums it), decode steps {serve['decode_rel_err']:.3g}, "
          f"{serve['tokens_compared']} tokens compared, diverged "
          f"{serve['tokens_diverged']}; outputs redistributed a step "
          f"{serve['layout_fixes_a_step']} ({serve['layout_fixes_moved']}); "
          f"float32 one layer "
          f"{serve['f32_one_layer']}; B12/B11 a rank "
          f"{[(x['B12'], x['B11']) for x in serve['launches']]}",
          flush=True)
    for n, f in serve["families"].items():
        print(f"phase 4o (d): {n} float32 on the rank mesh vs one process: "
              f"{f}", flush=True)
    sets_e = {}
    for name in RANK_SERVICE_SETS:
        per = [q["service"][name] for q in ranks]
        sets_e[name] = {
            "launches": [a["launches"] for a in per],
            "many_launches": [a["many_launches"] for a in per],
            "hit_ranks_ms": max(float(np.median(a["hit_ranks_ms"]))
                                for a in per),
            "spmv_err_over_eps": max(a["spmv_err_over_eps"] for a in per)}
        print(f"phase 4o (e): set {name}: PlanService(method='sharded') "
              f"hit_ranks_ms {sets_e[name]['hit_ranks_ms']:.4g}; B1/B2/B3' "
              f"a rank {[(x['B1'], x['B2'], x['B3']) for x in sets_e[name]['launches']]}",
              flush=True)
    row["service"] = {"sets": sets_e,
                      "stats": [q["service"]["stats"] for q in ranks]}
    row["service_s"] = max(q["service_s"] for q in ranks)
    for r, q in enumerate(sv):
        require(q["mode"] == "serve" and q["groups"] == RANK_MESH[0],
                f"phase 4o (d), rank {r}: weights {q['mode']}, "
                f"{q['groups']} token groups")
        require(q["launches"]["B12"] == RANK_SERVE_CALLS
                == q["launches"]["B11"] and all(
                    q["launches"][k] == 0 for k in ("B1", "B2", "B3",
                                                    "P34")),
                f"phase 4o (d), rank {r}: launches {q['launches']}, not "
                f"{RANK_SERVE_CALLS} B12/B11 and no other")
        require(q["layout_fixes"] == sv[0]["layout_fixes"],
                f"phase 4o (d), rank {r}: redistributed other outputs "
                f"than rank 0: {q['layout_fixes']}")
        for name, f in [("f32_one_layer", q["f32_one_layer"]),
                        *q["families"].items()]:
            require(f["logits_rel_err"] <= RANK_SERVE_F32_RTOL
                    and f["cache_rel_err"] <= RANK_SERVE_F32_RTOL,
                    f"phase 4o (d), rank {r}, {name}: float32 on the rank "
                    f"mesh against one process: logits "
                    f"{f['logits_rel_err']:.3g}, caches "
                    f"{f['cache_rel_err']:.3g} (limit "
                    f"{RANK_SERVE_F32_RTOL})")
        require(q["prefill_rel_err"] <= RANK_SERVE_RTOL,
                f"phase 4o (d), rank {r}: prefill logits "
                f"{q['prefill_rel_err']:.3g} of max|logit| from one "
                f"process summing as the mesh does (limit "
                f"{RANK_SERVE_RTOL})")
        require(q["decode_rel_err"] <= RANK_DECODE_RTOL,
                f"phase 4o (d), rank {r}: decode logits "
                f"{q['decode_rel_err']:.3g} of max|logit| from one process "
                f"summing as the mesh does, up to each row's first token "
                f"that may differ (limit {RANK_DECODE_RTOL})")
        require(q["prefill_plain_rel_err"] <= LM_BF16_RTOL,
                f"phase 4o (d), rank {r}: prefill logits "
                f"{q['prefill_plain_rel_err']:.3g} of max|logit| from one "
                f"process (limit {LM_BF16_RTOL})")
        for dv in q["tokens_diverged"]:
            require(dv["margin_over_peak"] <= 2 * RANK_SERVE_RTOL,
                    f"phase 4o (d), rank {r}: row {dv['row']} step "
                    f"{dv['step']} differs from one process where its "
                    f"top-2 margin is {dv['margin_over_peak']:.3g} of "
                    f"max|logit| (over {2 * RANK_SERVE_RTOL})")
        require(q["tokens_row0"] == sv[0]["tokens_row0"],
                f"phase 4o (d): rank {r}'s tokens differ from rank 0's")
    for name in RANK_SERVICE_SETS:
        for r, a in enumerate(q["service"][name] for q in ranks):
            require(a["launches"] == a["expected"]
                    and a["many_launches"] == a["many_expected"],
                    f"phase 4o (e), set {name}, rank {r}: launches "
                    f"{a['launches']} / {a['many_launches']} != "
                    f"{a['expected']} / {a['many_expected']}")
            require(a["block_equal"] and a["many_equal"],
                    f"phase 4o (e), set {name}, rank {r}: the service's "
                    "block differs from block r of the one-process fsparse")
            require(a["spmv_err_over_eps"] <= 8, f"phase 4o (e), set "
                    f"{name}, rank {r}: SpMV error {a['spmv_err_over_eps']}"
                    " eps x sum_j |a_ij x_j| > 8")
    # (c) the launcher in the four ranks: rank 0's lines
    lines = [ln for ln in res[0][1].splitlines() if ln.startswith("[train]")]
    steps = [float(ln.split("loss=")[1].split()[0]) for ln in lines
             if ln.startswith("[train] step=")]
    require(all(q["launcher_rc"] == 0 for q in ranks) and lines
            and lines[0] == f"[train] ranks={RANK_WORLD} backend={backend} "
            "device=cuda:0" and len(steps) == 3 and all(np.isfinite(steps))
            and (tmp / "ckpt" / "step_0000000003" / "manifest.json").exists()
            and not any(ln.startswith("[train]") for _, so, _ in res[1:]
                        for ln in so.splitlines()),
            f"phase 4o (c): the launcher printed {lines}")
    row["launcher"] = {"losses": steps, "first_line": lines[0],
                       "s": max(q["launcher_s"] for q in ranks)}
    print(f"phase 4o (c): launch.train --dp 2 --tp 2: {lines[0]}; losses "
          f"{steps}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4O_LIMIT_S,
            f"phase 4o took {row['phase_s']:.1f} s")
    names = ("B1", "B2", "B3", "B11", "B12", "P34")
    launches = {k: [0] * RANK_WORLD for k in names}
    serving = {k: [0] * RANK_WORLD for k in names}
    for r in range(RANK_WORLD):
        for k in ("B1", "B2", "B3", "P34"):
            launches[k][r] = sum(sets[n]["launches"][r][k] for n in sets)
            serving[k][r] = sum(sets_e[n]["launches"][r][k]
                                + sets_e[n]["many_launches"][r][k]
                                for n in sets_e)
        for k in ("B11", "B12", "P34"):
            launches[k][r] += row["lm"]["launches"][r][k]
            serving[k][r] += serve["launches"][r][k]
    return launches, serving


#: phase 4p's time limit, in seconds
PARTS34_PHASE_S = 300
#: phase 4p's FEM mesh: the benchmark's ``fem_p1_1999`` (n x n cells)
PARTS34_FEM_N = 1999


def parts34_bytes(L: int, N: int, nzmax: int) -> tuple[int, int]:
    """Parts 3-4's needed bytes (perm read, rows and cols gathered,
    srows, scols and slot written, indices and indptr written) and its
    gather floor where perm is random (each gathered word a 32 B
    sector)."""
    rest = 4 * L + 12 * L + 4 * nzmax + 4 * (N + 1)
    return rest + 8 * L, rest + 64 * L


def parts34_phase(dev, smi_line) -> dict:
    """Phase 4p: Parts 3-4's pass (``csrc/pattern_build.cu``) against its
    plain version bit for bit, both entries, on the edge cases of
    ``parts34_case`` (16 B aligned and not), on streams of many tiles and
    in the shapes of the benchmark's two assemble cells (the FEM matrix of
    ``fem_p1_1999`` and set 2 at 1e6 under their radix permutations);
    ``plan`` on each of those launches the pass once; then the pass's
    device time beside its byte bound, set 2's gather floor and the plain
    version's time, and with K0's other choice of gather imposed (bit for
    bit and timed).  Returns the phase's row."""
    from repro_torch.core.ransparse import ransparse
    from repro_torch.kernels.pattern_build import ops as pb
    from repro_torch.kernels.pattern_build.ref import pattern_fields_ref
    from repro_torch.sparse.dispatch import sorted_permutation
    from repro_torch.sparse.pattern import plan

    t_phase = time.perf_counter()
    row = {"phase": "4p", "card": smi_line}

    def plain(rows, cols, perm, sizes):
        return pattern_fields_ref(rows[perm], cols[perm], **sizes)

    def pairs(rows, cols, perm, sizes, force=None):
        """The kernel's fields with K0's choice of gather (a bool)."""
        got = pb.pattern_build_kernel(rows, cols, perm, **sizes, pairs=force)
        return got, bool(got.pop("pairs"))

    def check(rows, cols, perm, sizes, what):
        want = plain(rows, cols, perm, sizes)
        r_s, c_s = want["srows"], want["scols"]
        for entry, got in (
                ("gathered", pb.pattern_build(rows, cols, perm, **sizes)),
                ("presorted", pb.pattern_build_sorted(r_s, c_s, **sizes))):
            for f, w in want.items():
                require(torch.equal(got[f], w),
                        f"4p: {what}, {entry} entry: {f} differs from the "
                        "plain version")
        return want

    def unaligned(x):
        return torch.cat([x[:1], x])[1:]

    n_checked = 0
    streams = [(kind, parts34_case(kind)) for kind in PARTS34_CASES]
    streams += [(f"padding L={L} M=N={M}", parts34_case(
        "padding", seed=L, L=L, M=M, N=M)) for L, M in (
            (2048 * 37 + 5, 3000), (2048 * 997 + 1023, 1 << 20),
            (4_000_003, 1 << 21))]
    streams.append(("one_column L=300,001", parts34_case(
        "one_column", seed=1, L=300_001)))
    streams.append(("wide_gaps L=6,161", parts34_case(
        "wide_gaps", seed=2, L=2048 * 3 + 17)))
    chose = set()
    for what, (rows, cols, perm, M, N, nzmax) in streams:
        t = [torch.from_numpy(a).to(dev) for a in (rows, cols, perm)]
        chose.add(pairs(*t, dict(M=M, N=N, nzmax=nzmax))[1])
        for nz in sorted({nzmax, rows.shape[0] // 3, rows.shape[0] + 4097}):
            sizes = dict(M=M, N=N, nzmax=nz)
            check(*t, sizes, f"{what}, nzmax {nz}")
            check(*[unaligned(x) for x in t], sizes,
                  f"{what}, nzmax {nz}, unaligned")
            n_checked += 4
    row["edge_checks"] = n_checked
    require(chose == {False, True}, "4p: the streams did not take both of "
            "K0's choices (pairs and the two key streams)")

    cpm = sleep_cycles_per_ms()
    r, c, _, nv = p1_triplets(PARTS34_FEM_N)
    ii, jj, _, siz = ransparse(**BIG)
    cells = {"fem_p1_1999": (r, c, nv),
             "ransparse_set2_1e6": (ii - 1, jj - 1, siz)}
    del r, c, ii, jj
    for name, (r, c, n) in cells.items():
        rows, cols = (torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.int32)).to(dev) for x in (r, c))
        L = rows.shape[0]
        perm = sorted_permutation(rows, cols, M=n, N=n, method="radix")
        sizes = dict(M=n, N=n, nzmax=L)
        want = check(rows, cols, perm, sizes, name)
        chosen = pairs(rows, cols, perm, sizes)[1]
        other, took = pairs(rows, cols, perm, sizes, force=not chosen)
        require(took == (not chosen), f"4p: {name}: K0 ignored the "
                "imposed choice")
        other_same = all(torch.equal(other[f], w) for f, w in want.items())
        del other, want
        before = pb.pattern_build.launches
        pat = plan(rows, cols, (n, n))
        torch.cuda.synchronize()
        require(pb.pattern_build.launches == before + 1,
                f"4p: plan of {name} launched the pass "
                f"{pb.pattern_build.launches - before} times, not once")
        nnz = int(pat.nnz)
        del pat
        need, floor = parts34_bytes(L, n, L)
        ms = device_ms(lambda: pb.pattern_build(rows, cols, perm, **sizes),
                       cpm)
        bound = need / HBM_BYTES_PER_S * 1e3
        row[name] = {
            "L": L, "N": n, "nnz": nnz, "pairs": chosen, "ms": ms,
            "call_ms": call_ms(lambda: pb.pattern_build(rows, cols, perm,
                                                        **sizes)),
            "plain_ms": device_ms(lambda: plain(rows, cols, perm, sizes),
                                  cpm, reps=5),
            "bound_ms": bound, "bound_pct": 100 * bound / ms,
            "gather_floor_ms": floor / HBM_BYTES_PER_S * 1e3,
            "kernels": top_kernels(lambda: pb.pattern_build(
                rows, cols, perm, **sizes)),
            "other_gather": {
                "pairs": not chosen, "bit_identical": other_same,
                "ms": device_ms(lambda: pb.pattern_build_kernel(
                    rows, cols, perm, **sizes, pairs=not chosen), cpm)},
        }
        require(other_same, f"4p: {name}: with pairs={not chosen} imposed "
                "the pass differs from the plain version")
        del rows, cols, perm
        torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PARTS34_PHASE_S,
            f"phase 4p took {row['phase_s']:.1f} s, over its "
            f"{PARTS34_PHASE_S} s limit")
    return row


def parts34_only() -> None:
    """``python3 chip_smoke.py --parts34-phase``: build Parts 1-4's
    kernels and run phase 4p alone."""
    from repro_torch.kernels import common

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi_line = nvidia_smi_line()
    logs = common.build(["radix_sort", "pattern_build"])
    for line in logs["pattern_build"].splitlines():
        if "ptxas" in line and ("registers" in line or "spill" in line):
            print(f"ptxas[pattern_build]: {line.strip()}", flush=True)
    parts34_phase(torch.device("cuda"), smi_line)
    print(smi_line, flush=True)
    emit({"ok": True})


def main() -> None:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels import common
    from repro_torch.kernels.assembly_ops import fill_pallas
    from repro_torch.kernels.counting_sort import counting_sort as cs_mod
    from repro_torch.kernels.counting_sort.ref import placement_ref
    from repro_torch.kernels.hist import hist as hist_mod
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.kernels.hist.ref import block_histogram_ref
    from repro_torch.kernels.merge import merge as merge_mod
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ops import (digit_bases,
                                                    plan_digit_passes,
                                                    radix_sort_pair)
    from repro_torch.kernels.radix_sort.ref import (
        digit_block_histogram_ref, digit_placement_ref, hist_runs,
        radix_sort_pair_ref)
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import (
        PRODUCT_TILE, blocked_cumsum_ref, gather_segment_minmax_ref,
        gather_segment_sum_ref)
    from repro_torch.kernels.pattern_build.ops import pattern_build
    from repro_torch.kernels.spmv import spmv as ell_mod
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.sparse.matlab import (_cache_key, expand_indices,
                                           fsparse, plan_cache_clear,
                                           plan_cache_info, sparse2)
    from repro_torch.sparse.pattern import pattern_from_perm, plan_coo
    from repro_torch.core.coo import coo_from_matlab, host_triplets

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi_line = nvidia_smi_line()
    print(f"device: {kind} (count {count}); {smi_line}", flush=True)
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = common.build(["radix_sort", "segment_sum", "hist",
                         "counting_sort", "spmv", "spmv_sym", "merge",
                         "pattern_build",
                         "radix_sort_probe", "segment_sum_probe",
                         "merge_probe", "spmv_sym_probe"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    hist_k, place_k = rs.digit_block_histogram, rs.digit_placement
    fill_k = ss_mod.gather_segment_sum
    minmax_k, scan_k = ss_mod.gather_segment_minmax, ss_mod.blocked_cumsum
    bhist_k, cplace_k = hist_mod.block_histogram, cs_mod.placement
    sum2_k = ss_mod.gather2_segment_sum
    ell_k, sym_k, bsr_k = (ell_mod.spmv_ell, sym_mod.sym_streams,
                           sym_mod.bsr_tiles)
    merge_k = merge_mod.merge_search_kernel
    p34_k = pattern_build  # Parts 3-4's pass, one launch a plan or merge
    TILE = rs.TILE

    # data: the paper's Table 4.1 sets at full scale + the L = 5e7 set
    sets = {}
    for k, cfg in DATA_SETS.items():
        sets[str(k)] = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                 seed=SEED)
    t0 = time.perf_counter()
    sets["2x20"] = ransparse(BIG["siz"], BIG["nnz_row"], BIG["nrep"],
                             seed=SEED)
    print(f"data: L = 5e7 set generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    refill = {k: rng.standard_normal(v[0].shape[0]).astype(np.float32)
              for k, v in sets.items()}

    # -- 3. kernel vs plain on the card -------------------------------------
    b3_err = 0.0  # B1 and B2 are integer kernels: checked bit for bit
    for name in ("1", "2", "3", "2x20"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        rows, cols, L = coo.rows, coo.cols, coo.L

        def check_pass(i, p, args):
            keys, hist, base, perm, carry, kw, out = args
            require(torch.equal(hist, digit_block_histogram_ref(
                keys, tile=TILE, **kw)), f"B1 differs on set {name}, {p}")
            want = digit_placement_ref(keys, base, perm, carry=carry,
                                       tile=TILE, **kw)
            got, want = (((out,), (want,)) if not carry else
                         ((out[0], *out[1]), (want[0], *want[1])))
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"B2 (carrying {len(carry)} words) differs on set "
                    f"{name}, {p}")

        perm = radix_chain(rows, cols, siz, siz, check=check_pass)
        require(torch.equal(perm, radix_sort_pair_ref(rows, cols, M=siz,
                                                      N=siz)),
                f"radix permutation differs from the stable sort, set {name}")
        pat = pattern_from_perm(rows, cols, perm, M=siz, N=siz, nzmax=L)
        fill_args = (pat.perm, pat.slot)
        nz = dict(num_segments=pat.nzmax)
        vi = torch.from_numpy(
            rng.integers(-8, 9, L).astype(np.float32)).to(dev)
        require(torch.equal(fill_k(vi, *fill_args, **nz),
                            gather_segment_sum_ref(vi, *fill_args, **nz)),
                f"B3' differs on integer-valued data, set {name}")
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            vn = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
            got = fill_k(vn, *fill_args, **nz)
            want = gather_segment_sum_ref(vn, *fill_args, **nz)
            mag = gather_segment_sum_ref(vn.abs(), *fill_args, **nz).max()
            err = float((got - want).abs().max())
            atol = float(8 * eps * mag)
            require(err <= atol, f"B3' {dtype} error {err} > {atol}, "
                    f"set {name}")
            if dtype == torch.float32:
                b3_err = max(b3_err, err)
            emit({"check": "B3' vs plain", "set": name, "dtype": str(dtype),
                  "max_abs_err": err, "atol": atol})
        emit({"check": "B1, B2, B3' vs plain", "set": name, "L": L,
              "passes": len(plan_digit_passes(siz, siz, L)),
              "B1": "bit-identical", "B2": "bit-identical, carried words "
              "included", "B3_integer": "bit-identical"})
        del coo, rows, cols, perm, pat, fill_args
    torch.cuda.synchronize()
    hist_checks(dev, np.random.default_rng(SEED))

    # -- 3b. kernel vs plain: the second path's kernels ---------------------
    b5_err = 0.0  # B4, B11 and B12 are checked bit for bit
    for name in ("3", "2x20"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        L = coo.L
        arange = torch.arange(L, dtype=torch.int32, device=dev)
        # B12 and B11 on the counting sort's two passes (rows, then the
        # row-ordered cols) at the path's block size
        nbins = siz + 1
        block_b = default_block_b(nbins)
        keys = coo.rows
        for p in ("rows", "cols"):
            kw = dict(nbins=nbins, block_b=block_b)
            require(torch.equal(bhist_k(keys, **kw),
                                block_histogram_ref(keys, **kw)),
                    f"B12 differs on set {name}, {p} pass")
            offsets, _ = block_offsets(keys, **kw)
            pos = cplace_k(keys, offsets, **kw)
            require(torch.equal(pos, placement_ref(keys, offsets, **kw)),
                    f"B11 differs on set {name}, {p} pass")
            require(torch.equal(cplace_k(keys, offsets.clone(),
                                         consume_offsets=True, **kw), pos),
                    f"B11 on a handed-over table differs, set {name}")
            rank = torch.empty_like(pos)
            rank[pos] = arange
            keys = coo.cols[rank]
        del offsets, pos, rank, keys
        # B4 on the plan's streams, with two NaNs
        pat = plan_coo(coo)
        nz = dict(num_segments=pat.nzmax)
        for dtype in (torch.float32, torch.float64):
            v = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
            v[[3, L // 2]] = float("nan")
            for op in ("min", "max"):
                got = minmax_k(v, pat.perm, pat.slot, op=op, **nz)
                require(bool(torch.isnan(got).any()), "B4 lost the NaN")
                require(same_bits(got, gather_segment_minmax_ref(
                    v, pat.perm, pat.slot, op=op, **nz)),
                    f"B4 {op} {dtype} differs, set {name}")
        # B5 on the unfused fill's stream: the masked vals[perm]
        keep = pat.slot < pat.nzmax
        vi = torch.from_numpy(rng.integers(-8, 9, L).astype(np.float32))
        xi = torch.where(keep, vi.to(dev)[pat.perm], 0)
        require(torch.equal(scan_k(xi), blocked_cumsum_ref(xi)),
                f"B5 differs on integer-valued data, set {name}")
        # zero-mean values, and same-sign ones (uniform in [0, 1)), whose
        # prefixes grow with L: the chained tile prefixes' error shows
        for (dtype, eps), (data, draw) in itertools.product(
                ((torch.float32, EPS32), (torch.float64, EPS64)),
                (("normal", rng.standard_normal), ("uniform", rng.random))):
            vn = torch.from_numpy(draw(L)).to(dev, dtype)
            x = torch.where(keep, vn[pat.perm], 0)
            got = scan_k(x)
            require(torch.equal(scan_k(x), got), f"B5 {dtype} differs "
                    f"from call to call, set {name}")
            err = (got - blocked_cumsum_ref(x)).abs().double()
            tol = C_SCAN * eps * torch.cumsum(x.abs().double(), 0)
            require(bool(torch.all(err <= tol)),
                    f"B5 {dtype} error above {C_SCAN} eps x running "
                    f"sum|x| on {data} data, set {name}")
            if dtype == torch.float32 and data == "normal":
                b5_err = max(b5_err, float(err.max()))
            emit({"check": "B5 vs plain", "set": name, "dtype": str(dtype),
                  "data": data, "max_abs_err": float(err.max()),
                  "max_err_over_tol": float((err / tol.clamp(
                      min=1e-300)).max())})
        emit({"check": "B4, B5, B11, B12 vs plain", "set": name, "L": L,
              "nbins": nbins, "block_b": block_b,
              "B4": "bit-identical (NaN included)",
              "B5_integer": "bit-identical", "B11": "bit-identical",
              "B12": "bit-identical"})
        del coo, arange, pat, v, got, keep, vi, xi, vn, x, err, tol
        torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # -- 3c. B3' and B4 on long runs and runs of random length -------------
    # L = 5e7 positions in runs of 2^20 (each after short runs, so they
    # start mid-tile) or of 1..10^4, a random permutation, num_segments at
    # nnz and cut mid-stream: sums bit for bit on integer-valued data,
    # bit for bit from call to call and within C_SEG eps sum|terms| of
    # the exact sum on random data; min/max bit for bit, NaN included
    seg_rng = np.random.default_rng([SEED, 3])
    L5 = BIG["siz"] * BIG["nnz_row"]
    for runs in ("long", "random"):
        lengths = run_lengths(L5, seg_rng, runs)
        perm, slot = run_stream(lengths, dev, SEED)
        nnz = len(lengths)
        row = {"check": "B3', B4 vs plain", "runs": runs, "L": L5,
               "nnz": nnz, "longest_run": int(lengths.max())}
        for n in (nnz, nnz // 2):
            nz = dict(num_segments=n)
            vi = torch.from_numpy(
                seg_rng.integers(-8, 9, L5).astype(np.float32)).to(dev)
            require(torch.equal(fill_k(vi, perm, slot, **nz),
                                gather_segment_sum_ref(vi, perm, slot, **nz)),
                    f"B3' differs on integer-valued data, {runs} runs, "
                    f"num_segments {n}")
            for dtype, eps in ((torch.float32, EPS32),
                               (torch.float64, EPS64)):
                vn = torch.from_numpy(seg_rng.standard_normal(L5)).to(
                    dev, dtype)
                got = fill_k(vn, perm, slot, **nz)
                require(torch.equal(fill_k(vn, perm, slot, **nz), got),
                        f"B3' {dtype} differs from call to call, {runs} runs")
                if n == nnz:
                    r = seg_err_over_eps(got, vn, perm, slot, eps)
                    require(r <= C_SEG, f"B3' {dtype} error {r} eps x "
                            f"sum|terms| > {C_SEG}, {runs} runs")
                    row[f"B3_{dtype}_max_err_over_eps_sum_abs"] = r
                vn[[3, L5 // 2]] = float("nan")
                for op in ("min", "max"):
                    require(same_bits(
                        minmax_k(vn, perm, slot, op=op, **nz),
                        gather_segment_minmax_ref(vn, perm, slot, op=op,
                                                  **nz)),
                        f"B4 {op} {dtype} differs, {runs} runs, "
                        f"num_segments {n}")
        row.update(B3_integer="bit-identical", B3_repeat="bit-identical",
                   B4="bit-identical (NaN included)",
                   num_segments=[nnz, nnz // 2], tolerance_eps=C_SEG)
        emit(row)
        del perm, slot, vi, vn, got
        torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # -- 3d. B6 on product runs that cross its tiles -----------------------
    emit({"check": "B6 vs plain on runs that cross its tiles",
          "integer_data": "bit-identical", "nan": "bit-identical",
          "repeat": "bit-identical", "tolerance_eps": C_SEG,
          "probe_variants": "bit-identical on integer-valued data",
          "streams": product_run_checks(dev, np.random.default_rng(
              [SEED, 4]))})
    torch.cuda.empty_cache()

    # -- 4. main path -------------------------------------------------------
    counters = (hist_k, place_k, fill_k, p34_k)
    for f in counters:
        f.launches = 0
    expected = {"B1": 0, "B2": 0, "B3": 0, "P34": 0}
    oracles, verified = {}, {}
    for name, (ii, jj, ss, siz) in sets.items():
        L = ii.shape[0]
        npass = len(plan_digit_passes(siz, siz, L))
        t0 = time.perf_counter()
        S = fsparse(ii, jj, ss, (siz, siz))
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        pat = plan_coo(coo)
        v = refill[name]
        R = pat.assemble(torch.from_numpy(v).to(dev))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        expected["B1"] += 2 * npass
        expected["B2"] += 2 * npass
        expected["B3"] += 2
        expected["P34"] += 2
        got = {"B1": hist_k.launches, "B2": place_k.launches,
               "B3": fill_k.launches, "P34": p34_k.launches}
        require(got == expected, f"launch counts {got} != {expected} "
                f"after set {name}")
        i0, j0 = ii - 1, jj - 1
        t0 = time.perf_counter()
        (pr, pr_v, mag), ir, jc = matlab_sparse_oracle(
            i0, j0, np.stack([ss, v, np.abs(v)]), siz, siz)
        oracle_s = time.perf_counter() - t0
        oracles[name] = (pr, ir, jc, pr_v, mag)
        for A, what in ((S, "fsparse"), (R, "refill")):
            nnz = int(A.nnz)
            require(nnz == pr.shape[0], f"{what} nnz {nnz} != oracle "
                    f"{pr.shape[0]}, set {name}")
            require(np.array_equal(A.indptr.cpu().numpy(), jc),
                    f"{what} indptr differs, set {name}")
            require(np.array_equal(A.indices[:nnz].cpu().numpy(), ir),
                    f"{what} indices differ, set {name}")
        nnz = pr.shape[0]
        data = S.data[:nnz].cpu().numpy()
        require(np.array_equal(data, pr.astype(np.float32)),
                f"fsparse data differs from the oracle, set {name}")
        require(float(pr.max()) < 2**24, "sums past 2^24")
        rdata = R.data[:nnz].cpu().numpy().astype(np.float64)
        rerr = np.abs(rdata - pr_v)
        require(np.all(np.isfinite(rdata)), f"non-finite refill, set {name}")
        require(np.all(rerr <= 1e-5 * mag),
                f"refill error {float((rerr / np.maximum(mag, 1e-300)).max())}"
                f" x sum|v| > 1e-5, set {name}")
        verified[name] = csc_digest(S)  # the oracle's, for phase 4f
        emit({"main_path": name, "L": int(L), "M": siz, "N": siz,
              "nnz": int(nnz), "passes": npass,
              "fsparse": "bit-identical to oracle",
              "refill_max_err_over_sum_abs": float(
                  (rerr / np.maximum(mag, 1e-300)).max()),
              "run_s": run_s, "oracle_s": oracle_s})
        del S, R, pat, coo
    launches = {"B1": hist_k.launches, "B2": place_k.launches,
                "B3": fill_k.launches, "P34": p34_k.launches}
    emit({"main_path_launches": launches, "expected": expected})
    for k in ("B1", "B2", "B3", "P34"):
        require(launches[k] > 0, f"kernel {k} never launched on the main "
                "path")

    # -- 4b. second path: counting sort, unfused fill, duplicate modes,
    #    sparse2 -------------------------------------------------------------
    kernels = {"B1": hist_k, "B2": place_k, "B3": fill_k, "B4": minmax_k,
               "B5": scan_k, "B11": cplace_k, "B12": bhist_k, "P34": p34_k}

    def counts() -> dict:
        return {k: f.launches for k, f in kernels.items()}

    for f in kernels.values():
        f.launches = 0
    exp2 = dict.fromkeys(kernels, 0)
    for name, (ii, jj, ss, siz) in sets.items():
        L = ii.shape[0]
        npass = len(plan_digit_passes(siz, siz, L))
        pr, ir, jc, pr_v, mag = oracles[name]
        nnz = pr.shape[0]
        t0 = time.perf_counter()
        S = fsparse(ii, jj, ss, (siz, siz), method="pallas")
        exp2["B12"] += 2
        exp2["B11"] += 2
        exp2["B3"] += 1
        exp2["P34"] += 1
        require(int(S.nnz) == nnz, f"pallas nnz differs, set {name}")
        require(np.array_equal(S.indptr.cpu().numpy(), jc)
                and np.array_equal(S.indices[:nnz].cpu().numpy(), ir)
                and np.array_equal(S.data[:nnz].cpu().numpy(),
                                   pr.astype(np.float32)),
                f"fsparse(method='pallas') differs from the oracle, "
                f"set {name}")
        coo = coo_from_matlab(ii, jj, refill[name], (siz, siz))
        pat_p = plan_coo(coo, method="pallas")
        pat = plan_coo(coo)
        exp2["B12"] += 2
        exp2["B11"] += 2
        exp2["B1"] += npass
        exp2["B2"] += npass
        exp2["P34"] += 2
        require(torch.equal(pat_p.perm, pat.perm)
                and torch.equal(pat_p.slot, pat.slot),
                f"pallas permutation differs from the radix one, set {name}")
        F = fill_pallas(pat, coo.vals)
        exp2["B5"] += 1
        ferr = np.abs(F.data[:nnz].cpu().numpy().astype(np.float64) - pr_v)
        ftol = 2 * C_SCAN * EPS32 * np.cumsum(mag)
        require(np.all(ferr <= ftol), f"fill_pallas error above "
                f"{2 * C_SCAN} eps x running sum|v|, set {name}")
        row = {"second_path": name, "L": int(L), "nnz": int(nnz),
               "pallas_fsparse": "bit-identical to oracle",
               "pallas_perm": "bit-identical to radix",
               "fill_pallas_max_abs_err": float(ferr.max()),
               "fill_pallas_max_err_over_tol": float(
                   (ferr / np.maximum(ftol, 1e-300)).max())}
        if name in ACCUM_SETS:
            slot, fpos, lpos = slot_ids(ii - 1, jj - 1, siz)
            v32 = refill[name]
            n = np.bincount(slot, minlength=nnz)
            for accum in ACCUM_MODES:
                A = fsparse(ii, jj, v32.astype(np.float64), (siz, siz),
                            accum=accum)
                exp2["B1"] += npass
                exp2["B2"] += npass
                exp2["P34"] += 1
                exp2["B4"] += accum in ("min", "max")
                exp2["B3"] += accum == "mean"
                got = A.data[:nnz].cpu().numpy()
                want = numpy_accum(v32, slot, fpos, lpos, accum)
                require(int(torch.count_nonzero(A.data[nnz:])) == 0,
                        f"accum={accum}: non-zero tail, set {name}")
                if accum == "mean":
                    ok = np.all(np.abs(got - want) <= 8 * EPS32 * mag / n)
                else:
                    ok = np.array_equal(got, want)
                require(ok, f"accum={accum} differs from numpy, set {name}")
                if accum in ("min", "max"):
                    require(torch.equal(A.data, gather_segment_minmax_ref(
                        coo.vals, pat.perm, pat.slot,
                        num_segments=pat.nzmax, op=accum)),
                        f"accum={accum} differs from B4's plain version, "
                        f"set {name}")
            row["accum"] = {"modes": list(ACCUM_MODES),
                            "min_max_first_last": "bit-identical to numpy",
                            "mean": "within 8 eps x sum|v| / count"}
        plan_cache_clear()
        A = sparse2(ii, jj, ss, (siz, siz))
        exp2["B1"] += npass
        exp2["B2"] += npass
        exp2["B3"] += 1
        exp2["P34"] += 1
        before = counts()
        B = sparse2(ii, jj, ss, (siz, siz))
        exp2["B3"] += 1
        after = counts()
        require(all(after[k] == before[k] for k in ("B1", "B2", "B11",
                                                    "B12", "P34"))
                and after["B3"] == before["B3"] + 1,
                f"sparse2 hit launched {before} -> {after}, set {name}")
        info = plan_cache_info()
        require((info["misses"], info["hits"]) == (1, 1),
                f"sparse2 cache {info}, set {name}")
        require(torch.equal(A.data, B.data) and np.array_equal(
            B.data[:nnz].cpu().numpy(), pr.astype(np.float32)),
            f"sparse2 differs from the oracle, set {name}")
        plan_cache_clear()
        torch.cuda.synchronize()
        row["sparse2"] = "miss then hit, bit-identical to oracle"
        row["run_s"] = time.perf_counter() - t0
        require(counts() == exp2, f"launch counts {counts()} != {exp2} "
                f"after set {name}")
        emit(row)
        del S, coo, pat_p, pat, F, A, B
        torch.cuda.empty_cache()
    launches2 = counts()
    emit({"second_path_launches": launches2, "expected": exp2})
    for k in ("B4", "B5", "B11", "B12", "P34"):
        require(launches2[k] > 0, f"kernel {k} never launched on its path")
    csc_oracles = {k: v[:3] for k, v in oracles.items()}  # for phase 4g
    del oracles
    torch.cuda.empty_cache()

    # -- 4c. third path: FEM SpMV four ways, CG, the Galerkin product ------
    kernels3 = {"B1": hist_k, "B2": place_k, "B3": fill_k, "B6": sum2_k,
                "B8": ell_k, "B9": sym_k, "B10": bsr_k, "P34": p34_k}

    def counts3() -> dict:
        return {k: f.launches for k, f in kernels3.items()}

    for f in kernels3.values():
        f.launches = 0
    row3, launches3, exp3, fem = fem_path(dev, FEM_N, CG_ITERS, counts3, rng)
    require(launches3 == exp3, f"launch counts {launches3} != {exp3} on the "
            "third path")
    want = dict.fromkeys(kernels3, 0)
    want.update(B3=1, B6=2)
    require(row3["refill_launches"] == want, "the P' A P refill for 2 A "
            f"launched {row3['refill_launches']}, expected {want}")
    emit(row3)
    emit({"third_path_launches": launches3, "expected": exp3})
    for k in ("B6", "B8", "B9", "B10"):
        require(launches3[k] > 0, f"kernel {k} never launched on its path")
    # phase 3 for B6, B8, B9, B10, on the streams this path gave them
    errs3 = fem_kernel_checks(fem, rng, dev)
    emit({"check": "B6, B8, B9, B10 vs plain", "path": "third",
          "integer_data": "bit-identical", "B6_nan": "bit-identical",
          "max_abs_err_float32": errs3})
    emit({"check": "B9 vs plain on the arrow matrix, a column at a tile's "
                   "last item, runs of empty columns",
          "integer_data": "bit-identical", "up": "bit-identical",
          "ct_repeat": "bit-identical", "tolerance_eps": C_SEG,
          "ct_max_err_over_eps_sum_abs": sym_kernel_checks(fem, rng, dev)})

    # -- 4d. fourth path: update, the edge flip, symmetric planning ---------
    kernels4 = {"B1": hist_k, "B2": place_k, "B3": fill_k, "B4": minmax_k,
                "B5": scan_k, "B6": sum2_k, "B7": merge_k, "B8": ell_k,
                "B9": sym_k, "B10": bsr_k, "B11": cplace_k, "B12": bhist_k,
                "P34": p34_k}

    def counts4() -> dict:
        return {k: f.launches for k, f in kernels4.items()}

    for f in kernels4.values():
        f.launches = 0
    rows4, launches4, exp4, upd = update_path(dev, sets, fem, counts4, rng)
    for row in rows4:
        emit(row)
    require(launches4 == exp4, f"launch counts {launches4} != {exp4} on "
            "the fourth path")
    emit({"fourth_path_launches": launches4, "expected": exp4})
    require(launches4["B7"] > 0, "kernel B7 never launched on its path")
    # phase 3 for B7, on the streams this path gave it
    cases7 = merge_kernel_checks(upd, rng, dev)
    emit({"check": "B7 vs plain and torch.searchsorted", "path": "fourth",
          "cases": cases7, "sides": ["left", "right"],
          "B7": "bit-identical"})
    # complex values through the float kernels, against the CPU path
    emit({"check": "complex on the card vs the CPU path",
          "max_err_over_tol": complex_checks(dev, sets, rng)})

    # phase 4n (a)'s cells trace on the host's cores from here on
    # (niced), beside the card-bound phases 4e-4m; the host-bound oracle
    # and FEM work of phases 4-4d has run
    sweep = start_dryrun_sweep()

    # -- 4e. the policy and analysis layers: priors against the builds,
    #    the sweep, a loaded table, validators, the contract audit -------
    policy_phase(dev, sets, fem, kernels4, refill, smi_line)

    # -- 4f. the plan service: cold, warm and restarted requests, graph
    #    replays against eager calls, an update, a batch, the witness ---
    cpm = sleep_cycles_per_ms()
    serving_phase(dev, sets, fem, verified, kernels4, cpm, smi_line)

    # -- 4g. the sharded path: fsparse(method="sharded") on one shard and
    #    four, Phase A's invariants, the routed fill, the block-row SpMV,
    #    the gradient, sparse2 and the service, the times ---------------
    sharded_phase(dev, sets, csc_oracles, kernels4, cpm, smi_line)

    # -- 4h. the LM serving path: OLMoE-1B-7B at full width served on the
    #    card, its dispatch on B12/B11, against the CPU, the times -------
    lm_launches = lm_serving_phase(dev, kernels4, cpm, smi_line)

    # -- 4i. the LM training path: OLMoE-1B-7B at full width (4 layers)
    #    trained on the card, its dispatch and embedding gradient on
    #    B12/B11, against the CPU, the launcher's resume, the times ----
    train_launches = lm_training_phase(dev, kernels4, cpm, smi_line)

    # -- 4j. the ssm and hybrid serving path: Mamba2-780M and Zamba2-7B
    #    at full width and depth served on the card, against the CPU,
    #    the times -------------------------------------------------------
    ssm_serve_launches = ssm_serving_phase(dev, kernels4, cpm, smi_line)

    # -- 4k. the ssm and hybrid training path: Mamba2-780M (whole) and
    #    Zamba2-7B (12 layers) trained on the card, the embedding
    #    gradient on B12/B11, against the CPU, the launcher, the times --
    ssm_train_launches = ssm_training_phase(dev, kernels4, cpm, smi_line)

    # -- 4l. the encdec and vlm serving path: Seamless-M4T-medium and
    #    Llama-3.2-Vision-11B at full width and depth served on the card,
    #    against the CPU, the times ------------------------------------
    cross_serve_launches = cross_serving_phase(dev, kernels4, cpm, smi_line)

    # -- 4m. the encdec and vlm training path: Seamless-M4T-medium (whole)
    #    and Llama-3.2-Vision-11B (10 layers) trained on the card, the
    #    embedding gradient on B12/B11 at their vocabularies, against the
    #    CPU, the launcher, the times ------------------------------------
    cross_train_launches = cross_training_phase(dev, kernels4, cpm,
                                                smi_line)

    # -- 4n. the production sharding: the dry run's cells on the fake
    #    256/512-rank meshes, then a real sharded train and decode step on
    #    a one-rank mesh against the plain ones, and its trace -----------
    dryrun_sweep_phase(sweep, smi_line)
    sharded = sharded_step_phase(dev, kernels4, smi_line)

    # -- 4o. the port across ranks: four processes on the card, a gloo
    #    group; the sharded assembly, OLMoE on a (2, 2) rank mesh, the
    #    launcher ----------------------------------------------------
    rank_launches, rank_serve_launches = ranks_phase(smi_line)

    # -- 5. times -----------------------------------------------------------
    fem_k, t3 = fem_times(fem, cpm, dev)
    t3["card"] = smi_line
    emit(t3)
    t9 = sym_times(fem, cpm, dev)
    t9["card"] = smi_line
    emit(t9)
    fem_k["B9"].update(replaced_ms=t9["fem"]["replaced_ms"],
                       columns_ms=t9["fem"]["columns_ms"],
                       tiles_ms=t9["fem"]["tiles_ms"],
                       arrow_ms=t9["arrow"]["ms"],
                       arrow_replaced_ms=t9["arrow"]["replaced_ms"],
                       short_ms=t9["short"]["ms"])
    b7_row, t4 = update_times(sets, fem, upd, cpm, dev)
    t4["card"] = smi_line
    emit(t4)
    del fem, upd
    torch.cuda.empty_cache()
    per_kernel = {}
    for name, (ii, jj, ss, siz) in sets.items():
        L = ii.shape[0]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        rows, cols = coo.rows, coo.cols
        pat = plan_coo(coo)
        v = torch.from_numpy(refill[name]).to(dev)
        passes = plan_digit_passes(siz, siz, L)
        t = {"times": name, "L": int(L), "passes": len(passes)}
        for what, fn in (("plan", lambda: plan_coo(coo)),
                         ("fill", lambda: pat.assemble(v))):
            t[f"{what}_ms"] = call_ms(fn)
            t[f"{what}_device_ms"] = device_ms(fn, cpm)
            t[f"{what}_device_idle_share"] = \
                1.0 - t[f"{what}_device_ms"] / t[f"{what}_ms"]
        # the plan's two device stages, and the host's share of fsparse
        t["radix_sort_device_ms"] = device_ms(
            lambda: radix_sort_pair(rows, cols, M=siz, N=siz), cpm)
        # the plan and the radix sort with B1's replaced design
        with replaced_b1():
            t["radix_sort_device_ms_replaced_b1"] = device_ms(
                lambda: radix_sort_pair(rows, cols, M=siz, N=siz), cpm)
            t["plan_device_ms_replaced_b1"] = device_ms(
                lambda: plan_coo(coo), cpm)
        # B1 on every digit pass beside the replaced design and the
        # probe's other variants, in turns (hist_pass_row)
        b1_rows = []
        radix_chain(rows, cols, siz, siz, check=lambda i, p, a: b1_rows.append(
            {"pass": i, **hist_pass_row(a[0], a[5], cpm)}))
        run, grid = hist_runs(-(-L // TILE), sms, rs.HIST_PER_SM)
        emit({"times": "B1 passes", "set": name, "run": run, "grid": grid,
              "card": smi_line, "passes": b1_rows})
        t["parts34_device_ms"] = device_ms(
            lambda: pattern_from_perm(rows, cols, pat.perm, M=siz, N=siz,
                                      nzmax=pat.nzmax), cpm)
        host_reps = REPS if L < 10**7 else 5
        t["fsparse_ms"] = host_ms(lambda: fsparse(ii, jj, ss, (siz, siz)),
                                  host_reps)
        t["host_expand_coo_ms"] = host_ms(
            lambda: coo_from_matlab(*expand_indices(ii, jj, ss), (siz, siz)),
            host_reps)
        key64 = cols.long() * (siz + 1) + rows.long()
        t["sort_key64_stable_ms"] = device_ms(
            lambda: torch.sort(key64, stable=True), cpm)
        # the second path: the counting-sort plan, the unfused fill, sparse2
        for what, fn in (("plan_pallas",
                          lambda: plan_coo(coo, method="pallas")),
                         ("fill_pallas", lambda: fill_pallas(pat, v))):
            t[f"{what}_ms"] = call_ms(fn)
            t[f"{what}_device_ms"] = device_ms(fn, cpm)
            t[f"{what}_device_idle_share"] = \
                1.0 - t[f"{what}_device_ms"] / t[f"{what}_ms"]
        t["sparse2_miss_ms"] = host_ms(
            lambda: (plan_cache_clear(), sparse2(ii, jj, ss, (siz, siz))),
            host_reps)
        t["sparse2_hit_ms"] = host_ms(lambda: sparse2(ii, jj, ss, (siz, siz)),
                                      host_reps)
        plan_cache_clear()
        # what every lookup pays before the LRU: the key over the 8L
        # bytes of host indices, built and hashed
        r_h, c_h, _, _ = host_triplets(*expand_indices(ii, jj, ss),
                                       (siz, siz))
        t["sparse2_key_ms"] = host_ms(lambda: hash(_cache_key(
            r_h, c_h, (siz, siz), None, "radix", dev, ("sum", None, 1))),
            host_reps)
        del r_h, c_h
        # a representative digit pass: the second one as the chain calls
        # it, its payload the first pass's permutation, with the words it
        # carries (at 5e7 a row pass carrying rows and cols)
        keys, base, perm0, carry, kw = radix_chain(rows, cols, siz, siz,
                                                   upto=1)
        p1 = passes[1]
        hist_bytes = 4 * p1.nbins * -(-L // TILE)
        # B2 reads the keys and the payload, writes the payload, and reads
        # and writes each carried word (a carried key is read once)
        b2_bytes = 12 * L + hist_bytes + sum(
            4 * L * (1 + (w is not keys)) for w in carry)
        fill_in = (v, pat.perm, pat.slot)
        nz = dict(num_segments=pat.nzmax)
        # B11/B12 on the counting sort's first pass (rows, M + 1 bins);
        # B4/B5 on the fill's streams
        cnt = dict(nbins=siz + 1, block_b=default_block_b(siz + 1))
        table_bytes = 4 * cnt["nbins"] * -(-L // cnt["block_b"])
        offsets, _ = block_offsets(rows, **cnt)
        flat = (torch.arange(L, device=dev) // cnt["block_b"]) \
            * cnt["nbins"] + rows.long()
        # B11 as the counting sort calls it: on a table handed over
        # (consume_offsets=True), which each timed call advances again;
        # the counters' values change, the work does not.  The copy a
        # standalone call makes first is timed apart.
        handed = offsets.clone()
        keep = pat.slot < pat.nzmax
        x = torch.where(keep, v[pat.perm], 0)
        seg = torch.where(keep, pat.slot, pat.nzmax).long()
        # the yardsticks of B1 and B2: bincount of (tile, digit) and a
        # stable sort of the digit
        digit = (keys >> p1.shift) & ((1 << p1.bits) - 1)
        flat1 = (torch.arange(L, device=dev) // TILE) * p1.nbins + digit
        nflat1 = -(-L // TILE) * p1.nbins
        fns = {
            "B1": (lambda: hist_k(keys, **kw),
                   lambda: digit_block_histogram_ref(keys, tile=TILE, **kw),
                   lambda: torch.bincount(flat1, minlength=nflat1),
                   4 * L + hist_bytes, 3 * L),
            "B2": (lambda: place_k(keys, base, perm0, carry=carry, **kw),
                   lambda: digit_placement_ref(keys, base, perm0,
                                               carry=carry, tile=TILE, **kw),
                   lambda: torch.sort(digit, stable=True),
                   b2_bytes, 4 * L),
            "B3": (lambda: fill_k(*fill_in, **nz),
                   lambda: gather_segment_sum_ref(*fill_in, **nz),
                   lambda: torch.zeros(pat.nzmax, device=dev).index_add_(
                       0, pat.slot, v[pat.perm]),
                   4 * L + 8 * L + 4 * pat.nzmax, L),
            "B4": (lambda: minmax_k(*fill_in, op="max", **nz),
                   lambda: gather_segment_minmax_ref(*fill_in, op="max", **nz),
                   lambda: torch.full((pat.nzmax + 1,), float("-inf"),
                                      device=dev).scatter_reduce_(
                       0, seg, v[pat.perm], "amax", include_self=False),
                   4 * L + 8 * L + 4 * pat.nzmax, L),
            "B5": (lambda: scan_k(x), lambda: blocked_cumsum_ref(x),
                   lambda: torch.cumsum(x, 0), 8 * L, L),
            "B11": (lambda: cplace_k(rows, handed, consume_offsets=True,
                                     **cnt),
                    lambda: placement_ref(rows, offsets, **cnt),
                    lambda: torch.sort(rows, stable=True),
                    8 * L + table_bytes, 2 * L),
            "B12": (lambda: bhist_k(rows, **cnt),
                    lambda: block_histogram_ref(rows, **cnt),
                    lambda: torch.bincount(flat, minlength=table_bytes // 4),
                    4 * L + table_bytes, L),
        }
        rows_k = {}
        for k, (kern, plain, lib, nbytes, nops) in fns.items():
            r = {"ms": device_ms(kern, cpm), "call_ms": call_ms(kern),
                 "plain_ms": device_ms(plain, cpm),
                 "library_ms": None if lib is None else device_ms(lib, cpm),
                 "bytes": nbytes, "ops": nops}
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, nops)
            r["GBps"] = nbytes / r["ms"] / 1e6
            r["share_of_3.35TBps"] = r["GBps"] / (HBM_BYTES_PER_S / 1e9)
            rows_k[k] = r
        rows_k["B11"]["table_copy_ms"] = device_ms(lambda: offsets.clone(),
                                                   cpm)
        # no design that gathers vals[perm] beats the gather alone
        rows_k["B3"]["gather_floor_ms"] = rows_k["B4"]["gather_floor_ms"] = \
            device_ms(lambda: gather_floor(*fill_in, pat.nzmax), cpm)
        rows_k["B11"]["standalone_ms"] = device_ms(
            lambda: cplace_k(rows, offsets, **cnt), cpm)
        rows_k["B1"]["replaced_ms"] = b1_rows[1]["replaced_ms"]
        t["kernels"] = rows_k
        t["card"] = smi_line
        emit(t)
        per_kernel[name] = rows_k
        del coo, rows, cols, pat, v, key64, perm0, keys, base, carry, fill_in
        del fns
        del offsets, handed, flat, keep, x, seg, digit, flat1
        torch.cuda.empty_cache()

    # B3' and B4 on one run of 2^20 duplicates, and on L = 5e7 in runs of
    # 2^20, each against the same positions with every slot once (one
    # permutation for both): no run is reduced by one thread, so a long
    # run should cost a small factor of runs of 1
    lr = {"times": "long runs", "card": smi_line}
    for size, tag in ((LONG_RUN, ""), (L5, "_5e7")):
        long_runs = np.array([LONG_RUN]) if size == LONG_RUN else \
            run_lengths(L5, seg_rng, "long")
        vl = torch.from_numpy(
            seg_rng.standard_normal(size).astype(np.float32)).to(dev)
        for runs, lengths in (("longrun", long_runs),
                              ("runs1", np.ones(size, np.int64))):
            perm, slot = run_stream(lengths, dev, SEED)
            nz = dict(num_segments=len(lengths))
            lr[f"B3_{runs}{tag}_ms"] = device_ms(
                lambda: fill_k(vl, perm, slot, **nz), cpm)
            lr[f"B3_{runs}{tag}_plain_ms"] = device_ms(
                lambda: gather_segment_sum_ref(vl, perm, slot, **nz), cpm)
            lr[f"B4_{runs}{tag}_ms"] = device_ms(
                lambda: minmax_k(vl, perm, slot, op="max", **nz), cpm)
            del perm, slot
        del vl
        torch.cuda.empty_cache()
    # B6 on one run of 2^20 products against 2^20 runs of one, sa and sb
    # random into operands of 2^20 values; the replaced design too (one
    # thread walks the long run: a few calls)
    va, vb = (torch.from_numpy(seg_rng.standard_normal(LONG_RUN).astype(
        np.float32)).to(dev) for _ in range(2))
    sa, sb = (torch.from_numpy(seg_rng.integers(0, LONG_RUN, LONG_RUN).astype(
        np.int32)).to(dev) for _ in range(2))
    for runs, n in (("longrun", 1), ("runs1", LONG_RUN)):
        slot = torch.arange(LONG_RUN, dtype=torch.int32, device=dev) \
            if n > 1 else torch.zeros(LONG_RUN, dtype=torch.int32, device=dev)
        nz = dict(num_segments=n)
        lr[f"B6_{runs}_ms"] = device_ms(
            lambda: sum2_k(va, vb, sa, sb, slot, **nz), cpm)
        lr[f"B6_{runs}_replaced_ms"] = device_ms(
            lambda: product_probe(PRODUCT_VARIANTS["replaced"], va, vb, sa,
                                  sb, slot, n), cpm, reps=3)
        lr[f"B6_{runs}_gather2_floor_ms"] = device_ms(
            lambda: gather2_floor(va, vb, sa, sb, slot, n), cpm)
    del va, vb, sa, sb, slot
    emit(lr)

    p34 = parts34_phase(dev, smi_line)

    big = per_kernel["2x20"]
    meta = {
        "B1": ("digit_block_histogram", "src/repro_torch/csrc/radix_sort.cu",
               "src/repro/kernels/radix_sort/radix_sort.py:123", 0.0),
        "B2": ("digit_placement", "src/repro_torch/csrc/radix_sort.cu",
               "src/repro/kernels/radix_sort/radix_sort.py:160", 0.0),
        "B3": ("gather_segment_sum", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:263", b3_err),
        "B4": ("gather_segment_minmax", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:133", 0.0),
        "B5": ("blocked_cumsum", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:65", b5_err),
        "B11": ("placement", "src/repro_torch/csrc/counting_sort.cu",
                "src/repro/kernels/counting_sort/counting_sort.py:67", 0.0),
        "B12": ("block_histogram", "src/repro_torch/csrc/hist.cu",
                "src/repro/kernels/hist/hist.py:39", 0.0),
        "B6": ("gather2_segment_sum", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:211",
               errs3["B6"]),
        "B8": ("spmv_ell", "src/repro_torch/csrc/spmv.cu",
               "src/repro/kernels/spmv/spmv.py:32", errs3["B8"]),
        "B9": ("sym_streams", "src/repro_torch/csrc/spmv_sym.cu",
               "src/repro/kernels/spmv_sym/spmv_sym.py:52", errs3["B9"]),
        "B10": ("bsr_tiles", "src/repro_torch/csrc/spmv_sym.cu",
                "src/repro/kernels/spmv_sym/spmv_sym.py:104", errs3["B10"]),
        "B7": ("merge_search_kernel", "src/repro_torch/csrc/merge.cu",
               "src/repro/kernels/merge/merge.py:47", 0.0),
        "P34": ("pattern_build", "src/repro_torch/csrc/pattern_build.cu",
                "none: the JAX package leaves Parts 3-4 to XLA", 0.0),
    }
    # launches: B1-B3 on the main path (phase 4), B4, B5, B11, B12 on
    # theirs (4b), B6, B8, B9, B10 on the third path (4c), B7 on the
    # fourth (4d), P34 on the main path; times at 5e7 for the first seven
    # and P34 (phase 4p), at the third path's size for B6 and B8-B10, B7
    # at the update of the 5e7 set (1% delta)
    path_launches = {**launches2, **launches,
                     **{k: launches3[k] for k in fem_k if k in launches3},
                     "B7": launches4["B7"]}
    big = {**big, **fem_k, "B7": b7_row,
           "P34": {**p34["ransparse_set2_1e6"], "bound_by": "bytes",
                   "library_ms": None}}
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[k], "lm_launches": lm_launches[k],
         "train_launches": train_launches[k],
         "ssm_serve_launches": ssm_serve_launches[k],
         "ssm_train_launches": ssm_train_launches[k],
         "cross_serve_launches": cross_serve_launches[k],
         "cross_train_launches": cross_train_launches[k],
         "sharded_step_launches": sharded["launches"]["dtensor"].get(k, 0),
         "rank_launches": rank_launches.get(k, [0] * RANK_WORLD),
         "rank_serve_launches": rank_serve_launches.get(k,
                                                        [0] * RANK_WORLD),
         "max_abs_err": err,
         "ms": big[k]["ms"], "call_ms": big[k]["call_ms"],
         "plain_ms": big[k]["plain_ms"],
         "bound_ms": big[k]["bound_ms"], "bound_by": big[k]["bound_by"],
         "library_ms": big[k]["library_ms"],
         **({"gather_floor_ms": big[k]["gather_floor_ms"]}
            if k in ("B3", "B4", "P34") else {}),
         **({"longrun_ms": lr[f"{k}_longrun_ms"],
             "runs1_ms": lr[f"{k}_runs1_ms"]} if k in ("B3", "B4", "B6")
            else {}),
         **({"replaced_ms": big[k]["replaced_ms"]}
            if k in ("B1", "B6", "B7", "B9") else {}),
         **({"gather2_floor_ms": big[k]["gather2_floor_ms"],
             "shipped": f"K = {PRODUCT_TILE // 256}",
             "sweep_winner": big[k]["sweep_winner"],
             "second_product": {
                 "what": "(P' A) P", **{f: big["B6_Ac"][f] for f in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "bytes", "flops", "replaced_ms", "gather2_floor_ms",
                     "sweep_winner")}}} if k == "B6" else {})}
        for k, (n, src, rep, err) in meta.items()
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loaded-table-check"]:
        loaded_table_check(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--serving-restart-check"]:
        serving_restart_check(sys.argv[2])
    elif sys.argv[1:2] == ["--ranks-phase"]:
        ranks_child(sys.argv[2])
    elif sys.argv[1:2] == ["--parts34-phase"]:
        parts34_only()
    else:
        main()
