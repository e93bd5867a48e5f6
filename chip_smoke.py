#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:

1. device — card, torch/CUDA versions, power limit; TF32 switched off, and
   bf16 products' reduced-precision reduction (they accumulate in f32).
2. build — compile the CUDA sources (kernels/csrc: the twenty-one entry
   points of kernels A-D and their int8, bf16 and bf16x3 bodies, the dma
   pipeline of kernel A under each policy, and kernels P and G) for sm_90a;
   print ptxas's registers, shared memory and spills, and check in the
   SASS (``cuobjdump -sass``) that B8's, B16's and B3's tensor-core pass
   issues GMMA instructions (IGMMA; HGMMA on BF16), and that kernel B's
   pass issues FFMA and no tensor-core instruction (no HMMA, no GMMA: no
   TF32).
3. kernels — each f32 kernel against its plain PyTorch version on the same
   CUDA tensors, at the main paths' shapes and at edge shapes, and two
   launches of each compared bitwise; every stream of the batched kernel D
   bitwise equal to kernel A on that stream.  The update kernels (C here,
   C8, C16 and C3 in 3b and 3c, a sorted scatter) are held bitwise to the
   one-hot kernels they replaced (``parent_order_update``, that
   association replayed on the card), and where kernel A's grid equals
   their order, bitwise to A's sums on A's own ids.
3b. int8 kernels — A8, B8, C8 and D8 the same way on quantized chunks: ids
   equal off counted near ties, int32 sums bitwise given the same ids,
   every stream of D8 bitwise equal to A8; B8 (a wgmma product, exact
   int32 dots) bitwise its plain version: d everywhere, ids the first
   minimum of the plain scores.
3c. bf16 and bf16x3 kernels — A16, B16, C16, D16 and A3, B3, C3, D3 the
   same way at phase 3's cases, against the plain versions at the policy
   (x cast to its storage first): ids equal off near ties, d, sums and obj
   within 1e-5, counts equal on the same ids, repeat launches bitwise, every
   stream of D16 (D3) bitwise equal to A16 (A3).
3d. dma kernels — A-dma, A8-dma, A16-dma, A3-dma bitwise kernels A, A8,
   A16, A3 at phase 3c's fused shapes and at n = 37 from a base one element
   off its buffer, held against the plain versions with phase 3's
   tolerances, repeat launches bitwise.
3e. kernel P — ``kpp_probe_cuda`` against ``kpp_probe_plain`` at the
   reference test's shapes, at L = 1, 5, 9, 33 (around its candidate
   tiles), at the seeding shape (m = 64,000, n = 28, L = 3), the same with
   x and d one element off their buffers, and at the two-pass width
   (16,384 x 1,024, L = 3): newd within 1e-5 of its terms' magnitude, pot
   within 1e-5 relative, repeat launches bitwise; two CUDA graphs of P
   captured on one stream and replayed at once on two others, 200 times
   each, every replay bitwise a lone launch (each launch owns its
   ticket); then the entry point ``kpp_probe`` once at the seeding shape,
   its launch counted.
3f. kernel G and the slot chain — ``kpp_probe.SlotChain`` (kernels G and
   P, ``core.kmeanspp.seed``'s slot loop on the card) at the seeding shape
   (64,000 x 28, L = 3) and at the codebook seeding shape (163,840 x 768,
   L = 3; P first held to its plain version there as in 3e): two chained
   slots and the last pick, each slot's candidate rows and candidates
   bitwise ``kpp_draw_plain`` on the chain's d and the slot's Gumbel noise,
   each pick (the candidate of least potential into its centroid row,
   newd's column into d; the last its row alone) bitwise; its launches
   counted (G 3, P 2).  Then
   G (pick and draw, as a slot after the first launches it) timed by graph
   replay beside its plain version (the oracle chain's pick and draw) and
   its bound (noise, newd and d once over 3.35 TB/s), and P beside its
   plain version at the codebook seeding shape.
4. main path, sequential — ``repro_torch.api.fit`` + ``evaluate`` on a
   HEPMASS-shaped mixture (m = 10.5M, n = 28, 25 components) generated on
   the card, with k = 25, s = 64,000, 32 chunks, through the kernels
   (launch counts checked; the seeding's G and P exactly against the slots
   and seedings the fit counts under ``repro_torch.tracing``); the same fit
   on the plain path must reach the same full-data objective within 1e-3.
5. main path, batched — the same data and chunk budget with the paper's
   ``batch=8, sync_every=2``, through kernel D (launch counts checked
   against the per-round iterations); the plain path within 1e-3 and with
   the same accept sequence up to a near-tie decision; a batch=1 batched
   fit bitwise equal to the sequential fit.
4b. int8 main path, sequential — phase 4's fit with ``precision="int8"``
   through kernel A8 (f32 B and C in the epilogue, B8 and C8 never); the
   plain path within 1e-3 and the same accept sequence up to a near tie;
   the int8-versus-f32 drift of the objective printed as a finding.
5b. int8 main path, batched — phase 5's fit with ``precision="int8"``
   through kernel D8, with the same checks.
4c, 4d. bf16 and bf16x3 main path, sequential — phase 4's fit with
   ``precision="bf16"`` (A16 in the loop, f32 B and C16 in the epilogue)
   and ``"bf16x3"`` (A3; B3 and C3); launch counts checked, the plain path
   within 1e-3 and the same accepts up to a near tie, the full-data
   objective within 1 % of the f32 fit's; ``'auto'`` on a bf16 tensor
   bitwise equal to ``precision="bf16"``.
5d, 5e. bf16 and bf16x3 main path, batched — phase 5's fit at each policy
   through D16 / D3, with the same checks.
5c. the two-pass route at int8 — a 2,048-entry codebook over 1,024-wide
   embeddings (k = 2,048, n = 1,024 outside the fused envelope,
   m = 1,048,576, s = 16,384, 4 chunks): B8 and C8 carry every Lloyd
   iteration; the plain path within 1e-3; B8, C8 and the two-pass step
   held against their plain versions at that shape, whose errors the
   final line reports for B8 and C8; B8 timed there beside
   ``torch._int_mm`` on the codes (its dots only).
5f. the two-pass route at bf16 — 5c's fit at ``precision="bf16"``: B16 and
   C16 carry every Lloyd iteration, held against their plain versions at
   that shape (the final line reports B16's error there); C3, B and B3
   held there too, and B at one ``evaluate`` batch of that data (262,144
   rows); B16 and B timed there beside ``torch.mm`` on the bf16 operands
   and in f32 (TF32 off), their dots only; B3 timed there (no single
   library call computes its three bf16 products).
4e. the autotuned path — ``fit(autotune=True)`` under each policy,
   sequential and ``batch=8, sync_every=2`` (every candidate's time and
   the winners printed), and with tuning off a cache file under build/
   pinning
   ``{"pipeline": "dma"}``, the sequential fit under each policy (the dma
   kernel launched once per Lloyd iteration): each bitwise the untuned fit
   (trace, centroids, full-data objective); then, tuning off, the
   committed H100 profile (``results/autotune/cuda-sm_90.json``, written
   by ``tools/tune_profile.py``, timed by CUDA events) pinned: every fit
   bitwise the untuned one, its winners printed.
6. times — each kernel, its plain version and a PyTorch library call where
   one computes the same function, by CUDA events over CUDA-graph replays
   (device time; host launch overhead excluded), beside the bound; kernel D
   (D8, D16, D3) beside 8 back-to-back single-stream launches; A and A8 at
   the fused envelope's edge (k = n = 1,024); batched and sequential fit
   walls in turns, f32 against int8, bf16 and bf16x3 fit walls in turns;
   each dma kernel beside its blocks twin in turns, at the main shape and
   at the envelope's edge; kernel P at the seeding shape and at the
   two-pass width (16,384 x 1,024, L = 3; ``at_two_pass_width``).
   The assign kernels beside the dots-only library product (``torch.mm``
   f32 for B, bf16 for B16; ``torch._int_mm`` for B8 where the widths are
   multiples of 8).  Phases 5c and 5f time B8, C8, C, B16, C16, C3, B
   and B3 at their own shape (the update kernels beside ``index_add_``;
   their rows in the final line carry these times as
   ``at_two_pass_shape``, B's at an ``evaluate`` batch of that data as
   ``at_two_pass_evaluate_batch``).

7. streaming — ``fit("data.npy", cfg)`` out of core: phase 4's mixture
   written to an ``.npy`` in a temporary directory by ``gmm_memmap`` (its
   rows checked equal to phase 4's ``X``), streamed at k = 25,
   s = 64,000, 32 chunks, at ``batch=1`` and ``batch=8, sync_every=2``
   under each policy: A· / D· launches equal the Lloyd iterations (per
   window, from a replay through ``run_stream``), the plain twin takes the
   same accepts up to a near tie and reaches the full-data objective
   within 1e-3, each policy within 1 % of f32; ``prefetch=0`` and a
   slowed consumer (host and card held back on each chunk) bitwise the
   prefetched fit; a ``ProviderSource`` and an ``IteratorSource`` over the
   same chunks and ``autotune=True`` bitwise the path fit;
   ``evaluate(res, path)`` equal to ``evaluate(res, X)``.  Then the
   breakdown: the pipeline's fetch, staging, copy (CUDA events on the copy
   stream) and wait ms per chunk, the fetch alone and the compute alone
   beside both, prefetch 2 and 0 in turns, the in-core and the streaming
   fit + evaluate in turns, the card's idle share over a
   warm fit (``torch.profiler``) and the host syncs of a fit by line.
8. faults and middleware — on phase 7's file, each run against its plain
   twin (``impl="ref"`` on the card).  8a: ``vns_ladder=(32000, 16000),
   vns_patience=4``, sequential f32: every window's rung and chunk size
   the twin's and the accepts the same up to a near tie, the full-data
   objective within 1e-3, A / B / C launches counted.  8b:
   ``scheduler="competitive_s"``, ``batch=8, sync_every=2``, the default
   ladder (fetched at 128,000 rows), 64 chunks, under each policy: the
   scheduler's history, final sizes and winner the twin's up to a near tie
   of two streams' scores, the full-data objective within 1e-3 and each
   policy within 1 % of f32, the eval chunk's score launches (B, or B16
   under bf16) counted exactly; B and B16 timed at the eval chunk.  8c:
   ``time_budget_s`` at half of the warm unbudgeted wall (prefetch 0): fewer
   chunks, exact reconciliation against the provider's calls, every
   ``budget_drop`` id counted, the wall within the budget plus the longest
   step, the run a prefix of the unbudgeted one.  8d: the chaos plan
   ``FaultPlan(seed=13, transient_rate=0.25, permanent_ids=(12,),
   nan_ids=(14,), inf_ids=(20,), shape_ids=(22,))`` with ``retries=2``:
   exact reconciliation, one failed and three quarantined chunks with the
   reference's reasons, every transient recovered, the objective within
   5 % of the clean fit, the health record the twin's.  8e: inside
   ``kernel_failure("fused")`` the fit raises (the plain fit runs); after
   it the fit is bitwise the fit before.
9. checkpoints and resume — on phase 7's file (removed after this phase),
   ``log_every=1, ckpt_every=8``; each split writes half the chunks with
   ``resume=False`` and resumes to 32.  9a: sequential under each policy
   and f32 at ``batch=8, sync_every=1``: the resumed fit runs 16 chunks and
   is bitwise the uninterrupted one (centroids, objective, ``n_d``, the
   accepts of both halves summed, the trace of chunks 16-31, the steps,
   the loop state and the newest checkpoint's leaves), through the
   policy's A· (launches counted exactly) or D.  9b: the same split under
   ``vns_ladder=(32000, 16000), vns_patience=4``.  9c: the persistent
   split (``batch=8, sync_every=2``) against its plain twin resumed from a
   copy of the directory: the same accepts up to a near tie, the full-data
   objective within 1e-3, its distance from the uninterrupted fit printed.
   9d: on a copy of 9a's f32 directory, the newest step torn: the fit to 40
   chunks falls back to the previous step and runs the rest; every step
   torn: ``("ckpt_fallback", None)`` and bitwise a fresh ``resume=False``
   fit.  9e: phase 8d's chaos plan resumed past a torn checkpoint: exact
   reconciliation, the fallback, one failed and three quarantined chunks
   with the reference's reasons, the objective within 5 % of the clean
   fit.  9f: every step written is intact, with the four meta keys and the
   seven leaves ``f32[25,28] bool[25] f32 i32 f32 u32[2] i64[3]``.  The
   median save (and device-read) and restore ms, the walls of U and of the
   split's fits.

10. serving — ``repro_torch.serve`` on phase 4's fit with the default
   ``ServeConfig`` (buckets 64-4,096: seven CUDA graphs a tenant, captured
   at registration), four tenants (k = 25, n = 28; f32, int8, bf16,
   bf16x3) and a wide f32 tenant (k = 2,048, n = 1,024, seeded), in two
   servers (``max_linger_ms`` 0 and 2).  10a: each bucket's replay bitwise
   the eager launch of the policy, held against the plain version (ids off
   near ties, d within 1e-5); the kernels at buckets 64 and 4,096 timed
   beside bound, plain and library call, one plan replay and one
   ``ModelEntry.launch`` on the host clock.  10b: 8 client threads x 200
   requests of 48 HEPMASS rows a tenant and linger: no fault, retry,
   demotion or capture; B·'s launches equal the replays times what each
   capture counted; under f32, bf16 and bf16x3 every response bitwise the
   request served alone (int8: where it rode alone); p50/p99, requests/s
   and a launch, replays a bucket; the same loops with eager launches, in
   turns with the graphs, and under ``torch.profiler`` for the card's busy
   share.  A tenant registered under traffic.  10c: the f32 tenant swapped
   mid-traffic from checkpoints the port writes, through ``Server.watch``:
   nothing dropped, both steps seen, no capture, every response its
   generation's.  10d: ``FaultPlan.wrap_launch`` chaos (a poisoned
   request, 20 % transient launches, a 20-launch outage): the poisoned
   request fails alone, transients retried by a graph replay, the breaker
   opens and closes, every served response bitwise 10b's; a bucket demoted
   on the card fails its requests (no plain route), the next one serves.
   10e:
   ``kernel_failure("assign")`` at registration raises under each policy,
   and nothing is registered.

11. baselines — the paper's §5 competitors through ``fit(X, cfg,
   method=name)`` on phase 4's data and config.  11a: ``forgy``,
   ``kmeanspp`` (3 starts), ``kmeans_parallel``, ``coreset`` and
   ``da_mssc`` (q = 32), one key each, each against its plain twin
   (``impl="ref"`` on the card, the same key and backend): the full-data
   objective at most the twin's plus 1e-3 relative, a second fit on the
   key bitwise the first, counts summing to m (forgy, kmeanspp,
   K-means||; the coreset's weights within 5 % of m; DA-MSSC's pool
   weights to q * s), A launched by every full-data Lloyd, B and C once
   each at K-means||'s pool (k = 251) over all rows; per baseline the
   warm ``evaluate`` objective beside phase 4's Big-means, the walls and
   the launches by kernel and k.  11b: a weighted Lloyd on a 64,000-row
   coreset against its plain twin (B once a step and in the epilogue, no
   A or C; ids equal off near ties, the objective within 1e-3).  11c:
   Ward at 20,000 rows (k labels, an objective below one cluster's, its
   wall) and its ``MemoryError`` at 20,001.  11d: B and C at k = 251 and
   A at k = 25 over the 10.5M rows, each held to its plain version on the
   same inputs (B's ids off near ties and d, C's counts equal and sums
   within their bound, A's counts, sums and objective, as phase 3 holds
   them), then timed as in phase 6.  11e: ``kmeanspp`` seeding all 10.5M
   rows alone, warm; kernel P (one launch a slot of that seeding) held to
   its plain version and timed at one slot's probe of that seeding.

12. multi-device and multi-host — on phase 4's data, inside phase 7's
   temporary directory (run after phase 10).  The workers of a mesh, and
   the groups of a stream mesh, are dealt onto the one card and run in
   order.  12a: ``fit(method="sharded")`` with 4 workers, 8 chunks each,
   ``sync_every=2``, on a 1-axis worker mesh and on a (2, 2) mesh over
   ("data", "model"): with ``evaluate``, against its plain twin (the
   full-data objective within 1e-3, the accept sequence up to near ties),
   A once per Lloyd iteration of every worker's chunk, B and C once a
   chunk and per evaluate batch, the full-data objective at most 1.15x
   phase 4's; the fit walls in turns with the sequential fit.  12b: the
   sharded fit with ``ckpt_dir``, stopped after window 2 and resumed
   through ``fit``: bitwise the uninterrupted fit and its checkpoints.
   12c: phase 5's batched fit on a 4-group stream mesh, bitwise phase 5's
   (centroids, f_best, every chunk's f_new and accept, the trace
   group-major), D once per Lloyd iteration of each group's slowest
   stream.  12d: two ranks from the port's ``launch_local`` on the card,
   streaming phase 7's ``.npy`` with ``topology="host_mesh"``,
   ``batch=4``, fold and ``sync_every=2``: each rank bitwise the
   single-process streaming fit, the health reconciled, the ranks'
   launches and the store's round trips; they load the library phase 2
   built and import no jax.  A rank killed at its first own chunk: its
   peer raises ``HostDead`` at window 0 within ``sync_timeout_s``.

13. the reproduction suite — ``repro_torch.evalsuite`` on the card (run
   after phase 11, in a temporary data root; the datasets generated on the
   CPU generator).  13a: the quick tier, every quick method (the two-rank
   ``bm/hostmesh-2p`` cell too), seeds 0 and 1: the document valid under
   the port's schema, every row's fit on the kernels (``impl="cuda"``) at
   its dataset's chunk budget, A, D, B and C launched, each host-cell row
   bitwise the single-process streaming fit of its config.  13b: the full
   tier, 5 seeds: every in-process method on the five datasets and the
   host cell on the quick tier's datasets (each fleet is two new
   processes; 13a's rows stand for seeds 0 and 1), merged into one
   document; D16 and D8 launched too; ε,
   success rate and ``wall_mean_s`` of every cell printed with the card's
   name and power limit, each dataset's best run; with ``f_star``
   committed, each dataset's best ε within 1e-6.  13c: the gate on 13b's
   document: a self-compare exits 0, every ``epsilon_mean`` raised by 0.2
   exits 1, a dropped cell fails with "coverage regressed".  13d:
   ``BigMeansConfig.from_workload(configs.bigmeans_paper.CONFIG,
   n_chunks=32)`` equal to phase 5's config field by field, its fit on
   phase 4's data bitwise phase 5's.  13e: ``launch.roofline.
   precision_roofline`` on the chunk rates of phases 4-5e (32 chunks over
   the ``fit`` wall, Lloyd passes a chunk from the fused launches): the
   dominant term and the share of 3.35 TB/s, which must not exceed 1; the
   rates written to ``build/chunk_rates.json`` and projected by
   ``roofline.main`` into a ``repro.bench/1`` envelope naming the card.

14. the model zoo — ``repro_torch.models`` at the published widths,
   random weights from ``--seed`` (run last, after the two-pass phases).
   14a: hymba-1.5b at full width and depth (1.59B parameters in f32),
   B = 8 x S = 2,048 (the 1,024 window binds on 29 layers, the SSD runs
   8 chunks of 256): two forwards finite and bitwise equal; prefill 2,040
   tokens and decode 8, held to the forward (``models.decode_check``:
   each step within ``DECODE_REL`` of its norm and ``HYMBA_DECODE_TOL``,
   the decode cache within ``HYMBA_CACHE_REL`` of the forward's);
   ``examples.embedding_clustering.harvest`` (the forward's first 128
   logit columns, 16,384 rows) fitted at k = 64, s = 512, 25 chunks and
   evaluated on the kernels, A / B / C launches counted exactly, the
   plain twin's full-data objective within 1e-3; A, B and C held to their
   plain versions at that chunk (s = 512, k = 64, n = 128) and timed.
   14b: seamless-m4t-medium (12 + 12 layers, 1,024 frames),
   deepseek-moe-16b at 4 of 28 layers and qwen3-moe-235b-a22b at 2 of 94
   (16.9B and 235B parameters in f32 do not fit): the B = 8 x 2,048
   forward twice, bitwise; prefill 248 + 8 decoded at B = 2 with
   ``capacity_factor = E / top_k``, every decoded row that each layer
   routed as the forward did within ``DECODE_STEPS`` bf16 steps of the
   forward, a row routed otherwise only at a router near tie, and the
   cache of the rows never rerouted within ``CACHE_REL``.  14c: the
   reference example's own run (``main(["--arch", a])``, reduced
   configs) for the four archs.  14d:
   ``launch.train.main`` at ``bigmeans_paper``, 32 chunks, ``--scale
   0.02`` (m = 210,000, n = 27, k = 25, s = 64,000, batch 8): no chunk
   failed, D / B / C launches counted, kernel D held at the launcher's
   shape; again with ``--ckpt`` (bitwise, the reference's step layout)
   and resumed by a second call to the same f_best; ``--arch
   hymba-1.5b`` refused.  14e: the reference's three public-API
   examples, ``repro_torch.examples.{quickstart, bigdata_clustering,
   serve_assignments}.main([])`` at their default sizes (each one's temp
   directory under the smoke's own): the fits on the kernels, each call's
   A / B / C launches counted; quickstart's fit held to its plain twin as
   in phase 4 and its K-means++ as in phase 11; bigdata's resume run again
   at ``log_every=1`` (bitwise) against its plain twin (accepts as in phase
   4, f on the 1M-row sample within 1e-3); serving under 8 clients while
   the second fit runs on the card: every request served, no capture after
   warmup, every response's ids and d held to the plain version on the
   centroids of the version it names (each swap's recorded as it is made;
   ids off near ties, d within RTOL, as in 10a), B = the fits' chunks +
   one eager warmup launch a bucket + one a replay; ``--topology host_mesh`` under ``launch_local``: two ranks
   refuse as the reference's example does, one rank runs the host path
   (its fits equal the in-process run's).  14f:
   ``roofline.model_flops`` for the four archs at the four assigned
   shapes.
15. training the zoo — ``repro_torch.train`` on the card, no kernel of
   this repository on its path.  15a: hymba-1.5b at its published width and
   depth, f32 masters, ``adamw(1e-3)``, B = 4 x 2,048 tokens of one seeded
   batch: ``value_and_grad`` at the initial parameters under
   ``REMAT_POLICY`` "full" and "dots" (loss and every gradient bitwise),
   the loss bitwise the inference forward's ``_nll``; 4 steps under "full"
   (finite, falling; every parameter finite, some moved), again from the
   seed (bitwise: losses and parameters); a step under each policy timed
   (CUDA events), its tokens/s and peak GB.  15b: one step of each arch's
   reduced config and of the CPU tests' VLM config at f32 compute, held to
   the same step on the CPU (loss within 1e-4, gradients as the CPU tests
   hold them, new parameters within ``train.step_check``'s gap).  15c:
   seamless-m4t-medium at full depth, ``CHUNKED_LOSS`` off and on (B = 4 x
   1,024, 1,024 frames: loss within 1e-5, ms and peak of each);
   deepseek-moe-16b at 4 of 28 layers, ``MOE_GROUPED_DISPATCH = 4`` at
   capacity E / top_k against one group (loss within 1e-6); one
   ``BF16_GRADS`` step on hymba against the f32-gradient one (loss bitwise,
   only the tied embedding's gradient off, parameters within 2 lr).
16. the dry run (``repro_torch.launch.dryrun``), counted after every
   timed phase in processes of their own, one a cell, all at once on the
   host's cores, each bound to ``DRYRUN_BOUND_S`` from its start.  16a:
   each LM arch at train_4k and decode_32k on the 16 x 16 fake mesh (``cuda``
   device type) and ``bigmeans_paper``: every cell ``ok`` with the
   reference's keys; its dominant term, roofline fraction, dispatch
   seconds and per-device argument + temp GB (counts, not times).  16b:
   hymba-1.5b at 15a's step counted on a 1 x 1 fake mesh: its FLOPs equal
   ``FlopCounterMode``'s count of that step run on the card, exactly; its
   argument + temp bytes over 15a's measured peak inside
   ``HELD_MEMORY_BAND``; 15a's median step over the record's ``bound_s``.
   16c: the cluster cell on the card, ``fit(method="sharded")`` at 256
   worker positions (16 x 16 dealt onto the card), 4 chunks a worker,
   ``max_iters`` 8: A once per Lloyd iteration, A's device time beside
   the record's modeled bytes.

Then the one ``{"kernels": [...]}`` line (the assign kernels' rows carry
their serving times as ``at_serving``; ``launches_per_path`` the serving
run's launches as ``serve``, phase 11's as ``baselines`` and phase 12's
as ``sharded``, ``sharded_2x2``, ``sharded_resume``, ``stream_mesh`` and
``host_mesh`` (both ranks' fold and persistent fits), phase 13's as
``evalsuite_quick`` and ``evalsuite_full`` (in-process cells), phase 14's
as ``embedding`` (14a's fit + evaluate), ``launch_train`` (14d) and
``example_quickstart``, ``example_bigdata``, ``example_serve`` and
``example_host_mesh`` (14e, each example's whole run; the one rank's); A's,
B's and C's rows their times at 14a's chunk as ``at_embedding``; A's row its
time over the 10.5M rows as ``at_full_data``, B's and C's theirs at the
K-means|| pool as ``at_kmeans_parallel_pool``, P's its probe over the
10.5M rows as ``at_full_data``; P's and G's their times at the codebook
seeding shape as ``at_codebook_seeding``, phase 3e's entry point run as
``kpp_probe_entry`` and phase 3f's chain as ``kpp_chain``), the card's
name and power
limit, and the final ``{"ok": true, "device": {...}}`` line.  Any failed check raises.
It needs a CUDA card and the repository's ``src`` beside it.
"""
from __future__ import annotations

import argparse
import copy
import cProfile
import dataclasses
import json
import math
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import device as devices  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch import serve as serve_lib  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.api import (  # noqa: E402
    BigMeansConfig, MemmapSource, ProviderSource, TopologySpec, evaluate,
    fit,
)
from repro_torch.cluster import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import big_means_batched  # noqa: E402
from repro_torch.core import bigmeans as bm_lib  # noqa: E402
from repro_torch.core.objective import EVAL_BATCH  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    PAPER_DATASETS, GMMSpec, gmm_chunk, gmm_dataset, gmm_memmap,
)
from repro_torch.engine import faults  # noqa: E402
from repro_torch.engine import hostmesh  # noqa: E402
from repro_torch.engine import incore  # noqa: E402
from repro_torch.engine import middleware as mw  # noqa: E402
from repro_torch.engine import scheduler as sched_lib  # noqa: E402
from repro_torch.engine import stream  # noqa: E402
from repro_torch.engine import topology as topo_lib  # noqa: E402
from repro_torch.configs import bigmeans_paper as paper_cfg  # noqa: E402
from repro_torch.configs import shapes as zoo_shapes  # noqa: E402
from repro_torch.evalsuite import datasets as suite_ds  # noqa: E402
from repro_torch.evalsuite import gate, suite  # noqa: E402
from repro_torch.evalsuite import metrics as suite_metrics  # noqa: E402
from repro_torch.evalsuite import schema as suite_schema  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    autotune, build, distance, fused_step, ops, ref,
)
from repro_torch.kernels import kpp_probe as kpp  # noqa: E402
from repro_torch.kernels import precision as px  # noqa: E402
from repro_torch.kernels import update as upd  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    bigdata_clustering, embedding_clustering, quickstart,
    serve_assignments,
)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import decode_check  # noqa: E402
from repro_torch.models import flags as zoo_flags  # noqa: E402
from repro_torch.models import layers as zoo_layers  # noqa: E402
from repro_torch.models import registry as zoo_registry  # noqa: E402
from repro_torch.models import transformer as zoo_transformer  # noqa: E402
from repro_torch.train import optimizer as zoo_optimizer  # noqa: E402
from repro_torch.train import step_check  # noqa: E402
from repro_torch.train import train_step as zoo_train_step  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402
from repro_torch.serve import registry as serve_registry  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
INT8_OP_PER_S = 1979e12        # H100 SXM int8 tensor cores (dense)
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores (dense)
RTOL = 1e-5                    # sums, d, obj: summation order differs
TIE_RTOL = 1e-4                # ids compared where the top-2 gap exceeds it

KERNELS = {
    "fused_step_f32": ("src/repro_torch/kernels/csrc/fused_step.cu",
                       "src/repro/kernels/fused_step.py:297"),
    "fused_step_batched_f32": (
        "src/repro_torch/kernels/csrc/fused_step_batched.cu",
        "src/repro/kernels/fused_step.py:433"),
    "assign_f32": ("src/repro_torch/kernels/csrc/assign.cu",
                   "src/repro/kernels/distance.py:164"),
    "update_f32": ("src/repro_torch/kernels/csrc/update.cu",
                   "src/repro/kernels/update.py:114"),
    "fused_step_int8": ("src/repro_torch/kernels/csrc/fused_step_int8.cu",
                        "src/repro/kernels/fused_step.py:297"),
    "fused_step_batched_int8": (
        "src/repro_torch/kernels/csrc/fused_step_batched_int8.cu",
        "src/repro/kernels/fused_step.py:433"),
    "assign_int8": ("src/repro_torch/kernels/csrc/assign_int8.cu",
                    "src/repro/kernels/distance.py:231"),
    "update_int8": ("src/repro_torch/kernels/csrc/update_int8.cu",
                    "src/repro/kernels/update.py:164"),
    **{f"{entry}_{prec}": (f"src/repro_torch/kernels/csrc/{src}_bf16.cu", rep)
       for prec in ("bf16", "bf16x3")
       for entry, src, rep in (
           ("fused_step", "fused_step", "src/repro/kernels/fused_step.py:297"),
           ("fused_step_batched", "fused_step_batched",
            "src/repro/kernels/fused_step.py:433"),
           ("assign", "assign", "src/repro/kernels/distance.py:164"),
           ("update", "update", "src/repro/kernels/update.py:114"))},
    **{f"fused_step_dma_{prec}": ("src/repro_torch/kernels/csrc/"
                                  "fused_step_dma.cu",
                                  "src/repro/kernels/fused_step.py:297")
       for prec in ("f32", "int8", "bf16", "bf16x3")},
    "kpp_probe": ("src/repro_torch/kernels/csrc/kpp_probe.cu",
                  "src/repro/kernels/kpp_probe.py:64"),
    "kpp_draw": ("src/repro_torch/kernels/csrc/kpp_draw.cu",
                 "src/repro/core/kmeanspp.py:80"),
}
COUNTS = {"fused_step_f32": "fused_step", "assign_f32": "assign",
          "update_f32": "update",
          "fused_step_batched_f32": "fused_step_batched",
          "fused_step_dma_f32": "fused_step_dma",
          **{name: name for name in KERNELS if not name.endswith("_f32")}}
# The path whose run gives each kernel's launches in the final line.
PATH_OF = {"fused_step_f32": "sequential", "assign_f32": "sequential",
           "update_f32": "sequential", "fused_step_batched_f32": "batched",
           "fused_step_int8": "int8_sequential",
           "fused_step_batched_int8": "int8_batched",
           "assign_int8": "int8_two_pass", "update_int8": "int8_two_pass",
           "fused_step_bf16": "bf16_sequential",
           "fused_step_batched_bf16": "bf16_batched",
           "assign_bf16": "bf16_two_pass", "update_bf16": "bf16_sequential",
           "fused_step_bf16x3": "bf16x3_sequential",
           "fused_step_batched_bf16x3": "bf16x3_batched",
           "assign_bf16x3": "bf16x3_sequential",
           "update_bf16x3": "bf16x3_sequential",
           **{f"fused_step_dma_{prec}": f"dma_{prec}_sequential"
              for prec in ("f32", "int8", "bf16", "bf16x3")},
           "kpp_probe": "sequential", "kpp_draw": "sequential"}
BATCH, SYNC_EVERY = 8, 2        # the paper's (configs/bigmeans_paper.py)
# The committed H100 tuner profile (tools/tune_profile.py), read in 4e.
PROFILE = ROOT / "results" / "autotune" / "cuda-sm_90.json"
# Each main-path fit's `fit` wall (phases 4-5e), read by phase 13e.
FIT_WALLS: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


SEEDING = ("kpp_draw", "kpp_probe")     # the K-means++ slot kernels G, P


def seeded_zeros(launches: dict) -> dict:
    """0 for each kernel of ``launches`` but the seeding's G and P, which
    keep their counts once checked: a fit on the card seeds each degenerate
    slot with one launch of G and one of P, and launches G once more a
    seeding (its last pick); how many slots it seeds it does not report."""
    draw, probe = (launches.get(name, 0) for name in SEEDING)
    check(draw == probe == 0 or probe >= draw - probe >= 1,
          f"seeding launches: G {draw}, P {probe}")
    return {**dict.fromkeys(launches, 0), "kpp_draw": draw,
            "kpp_probe": probe}


def off_seeding(launches: dict) -> dict:
    """``launches`` less the seeding's G and P, once checked."""
    seeded_zeros(launches)
    return {k: v for k, v in launches.items() if k not in SEEDING}


SASS_OPS = ("GMMA", "HMMA", "FFMA")   # tensor-core and fp32 FMA opcodes


def sass_ops(lib: Path) -> dict:
    """Tensor-core (GMMA, HMMA) and FFMA instructions by kernel in the SASS
    of the built library (``cuobjdump -sass``): {mangled name: {opcode:
    count}}."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
        elif fn and any(key in line for key in SASS_OPS):
            op = next((w for w in line.replace(";", " ").split()
                       if any(key in w for key in SASS_OPS)), None)
            if op is not None:
                out.setdefault(fn, {})
                out[fn][op] = out[fn].get(op, 0) + 1
    return out


# The assign kernels' passes by their mangled names: B8, B16 and B3 the
# tensor-core pass (assign_mma.cuh: X, accumulator, tile, operand parts),
# B the register-tiled CUDA-core pass (assign.cu).
ASSIGN_PASSES = {
    "B8": re.compile(r"assign_mma_kernelIaiLi\d+ELi1E"),
    "B16": re.compile(r"assign_mma_kernelI13__nv_bfloat16fLi\d+ELi1E"),
    "B3": re.compile(r"assign_mma_kernelI13__nv_bfloat16fLi\d+ELi2E"),
    "B": re.compile(r"assign_f32_pass"),
}


def check_assign_sass(sass: dict) -> dict:
    """Each assign pass's opcodes: the tensor-core passes issue GMMA
    (IGMMA for B8; HGMMA on BF16 for B16 and B3), kernel B's FFMA and no
    tensor-core instruction at all."""
    found = {}
    for name, pat in ASSIGN_PASSES.items():
        fns = {fn: ops_ for fn, ops_ in sass.items() if pat.search(fn)}
        check(bool(fns), f"{name}'s pass not found in the SASS")
        found[name] = fns
        opcodes = [op for ops_ in fns.values() for op in ops_]
        if name == "B8":
            check(all(any("IGMMA" in op for op in ops_)
                      for ops_ in fns.values()),
                  "B8's tensor-core pass issues no IGMMA")
        elif name == "B":
            check(all(any(op.startswith("FFMA") for op in ops_)
                      for ops_ in fns.values()),
                  "kernel B's pass issues no FFMA")
            check(not any("MMA" in op for op in opcodes),
                  "kernel B's pass issues a tensor-core instruction")
        else:
            check(all(any("HGMMA" in op and "BF16" in op for op in ops_)
                      for ops_ in fns.values()),
                  f"{name}'s tensor-core pass issues no HGMMA on BF16")
    return found


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def separated(m: int, k: int, n: int, seed: int):
    """Points around k well-separated centres, and the centres (on card)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = torch.randn((k, n), generator=gen, device="cuda") * 5.0
    comp = torch.randint(0, k, (m,), generator=gen, device="cuda")
    x = c[comp] + torch.randn((m, n), generator=gen, device="cuda")
    return x.contiguous(), c.contiguous()


def near_ties(x, c) -> torch.Tensor:
    """Rows whose best two scores ||c||^2 - 2x.c are within TIE_RTOL."""
    scores = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 0].abs()


def sums_bound(x, ids, k, ties: int):
    """Per-element error bound for cluster sums: RTOL of sum |x| in the
    cluster (the sum's condition), plus two points per near tie."""
    abs_sums, _ = ref.update_ref(x.abs(), ids, k)
    return RTOL * abs_sums + 2 * ties * float(x.abs().max()) + 1e-30


def twice(fn, *args):
    """Run a kernel twice and require bitwise equal outputs."""
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        check(torch.equal(u, v), f"{fn.__name__}: repeat launch differs")
    return a


def parent_order_update(xs, ids, k: int, G: int, split: bool = False):
    """The sums and counts of the one-hot update kernels that C, C16, C3
    and C8 were before their sorted-scatter redesign, in their association,
    on the card: each 256-row tile's [k, n] sums in row order from +0 (rows
    with an id in [0, k) only; under ``split`` the bf16 hi and lo parts
    summed apart and added at the tile's end), CTA g's partial the tiles
    g, g + G, ... in order, then ((+0 + P_0) + P_1) + ... .  ``xs``: the
    values as stored, widened to f32 (int64 for int8 codes: exact)."""
    m, n = xs.shape
    tm = build.TILE_ROWS
    tiles = -(-m // tm)
    dt = torch.int64 if not xs.dtype.is_floating_point else torch.float32
    ok = (ids >= 0) & (ids < k)
    if split:
        hi = xs.bfloat16().float()
        parts = (hi, (xs - hi).bfloat16().float())
    else:
        parts = (xs.to(dt),)
    tsum, tcnt = None, None
    for part in parts:
        acc = torch.zeros((tiles, k, n), dtype=dt, device=xs.device)
        cnt = torch.zeros((tiles, k), dtype=torch.float32, device=xs.device)
        for i in range(min(tm, m)):              # row i of every tile
            r = torch.arange(i, m, tm, device=xs.device)
            r = r[ok[r]]
            t, j = r // tm, ids[r].long()
            acc[t, j] = acc[t, j] + part[r]      # one add per element
            cnt[t, j] = cnt[t, j] + 1.0
        tsum, tcnt = (acc, cnt) if tsum is None else (tsum + acc, cnt)
    sums = torch.zeros((k, n), dtype=dt, device=xs.device)
    counts = torch.zeros(k, dtype=torch.float32, device=xs.device)
    for g in range(min(G, tiles)):
        P, C = tsum[g].clone(), tcnt[g].clone()
        for t in range(g + G, tiles, G):
            P, C = P + tsum[t], C + tcnt[t]
        sums, counts = sums + P, counts + C
    return sums, counts


def check_parent_order(sums, counts, xs, ids, k: int, what: str,
                       split: bool = False) -> None:
    """The kernel's sums (int32 for C8) and counts bitwise the one-hot
    kernels' (``parent_order_update`` at the wrapper's order G)."""
    G = upd.order(xs.device, xs.shape[0], k, xs.shape[1])
    want_s, want_c = parent_order_update(xs, ids, k, G, split)
    check(torch.equal(sums.view(torch.int32),
                      want_s.to(sums.dtype).view(torch.int32)),
          f"{what} sums differ from the one-hot kernels' (G = {G})")
    check(torch.equal(counts.view(torch.int32), want_c.view(torch.int32)),
          f"{what} counts differ from the one-hot kernels' (G = {G})")


def check_update_on_fused_ids(x, c, prec: str) -> bool:
    """Where the update's order G equals kernel A's grid (A8, A16, A3 under
    their policy), kernel C on kernel B's ids (A's argmin code) must give
    bitwise A's sums and counts.  Returns whether the grids agree (and so
    whether it was checked)."""
    m, n = x.shape[-2], x.shape[-1]
    k = c.shape[0]
    if build.grid(x.device, m, k * n + k) != build.grid(x.device, m,
                                                        k * n + k + 1):
        return False
    sums, counts, _ = ops.fused_step(x, c, impl="cuda", precision=prec)
    ids, _ = ops.assign(x, c, impl="cuda", precision=prec)
    usums, ucounts = ops.update(x, ids, k, impl="cuda", precision=prec)
    check(torch.equal(usums.view(torch.int32), sums.view(torch.int32))
          and torch.equal(ucounts.view(torch.int32),
                          counts.view(torch.int32)),
          f"update ({prec}) on kernel B's ids differs from kernel A's sums")
    return True


def check_assign(x, c, ties) -> float:
    ids, d = twice(distance.assign_f32, x, c)
    ids_p, d_p = distance.assign_plain(x, c)
    ok = ~ties
    check(torch.equal(ids[ok], ids_p[ok]), "assign ids differ off near ties")
    # d: condition of x2 - 2x.c + c2 is the magnitude of its terms
    x2 = (x * x).sum(1)
    c2 = (c * c).sum(1)
    scale = x2 + c2[ids_p.long()] + 2 * (x2 * c2[ids_p.long()]).sqrt()
    err = (d - d_p).abs()
    check(bool((err[ok] <= RTOL * scale[ok] + 1e-6).all()),
          f"assign d off by {float(err.max())}")
    return float(err.max())


def check_update(x, ids, k) -> float:
    """Kernel C twice (bitwise), bitwise the one-hot kernel's association,
    counts equal to the plain version's and sums within its bound."""
    ids = ids.clone()
    ids[::97] = -1                                  # padding never hits
    ids[1::89] = k + 3                              # out of range adds nothing
    ids[2::101] = 0                                 # -0.0 rows in a cluster
    x = x.clone()
    x[2::101] = -0.0
    sums, counts = twice(upd.update_f32, x, ids, k)
    check_parent_order(sums, counts, x, ids, k, "update")
    sums_p, counts_p = upd.update_plain(x, ids, k)
    check(torch.equal(counts, counts_p), "update counts differ")
    err = (sums - sums_p).abs()
    check(bool((err <= sums_bound(x, ids, k, 0)).all()),
          f"update sums off by {float(err.max())}")
    return float(err.max())


def check_fused(x, c, ties: int, direct: bool = True,
                pipeline: str = "blocks") -> float:
    """Kernel A (direct; A-dma under ``pipeline="dma"``) or the ops
    two-pass route against the plain step."""
    k = c.shape[0]
    if direct:
        sums, counts, obj = twice(
            lambda a, b: fused_step.fused_step_f32(a, b, pipeline), x, c)
    else:
        sums, counts, obj = ops.fused_step(x, c, impl="cuda")
    sums_p, counts_p, obj_p = fused_step.fused_step_plain(x, c)
    ids_p, _ = ref.assign_ref(x, c)
    check(int((counts - counts_p).abs().sum()) <= 2 * ties,
          "fused counts differ beyond near ties")
    err = (sums - sums_p).abs()
    check(bool((err <= sums_bound(x, ids_p, k, ties)).all()),
          f"fused sums off by {float(err.max())}")
    check(abs(float(obj) - float(obj_p)) <= RTOL * float(obj_p),
          f"fused obj {float(obj)} vs plain {float(obj_p)}")
    return max(float(err.max()), abs(float(obj) - float(obj_p)))


def batched_separated(batch: int, m: int, k: int, n: int, seed: int):
    """``batch`` independent streams of :func:`separated`."""
    pairs = [separated(m, k, n, seed + b) for b in range(batch)]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def check_batched(x, c) -> tuple[float, int]:
    """Kernel D through ``ops`` (outside the envelope: kernels B + C stream
    by stream) against its plain version, every stream bitwise equal to the
    single-stream route (kernel A inside the envelope), and two calls
    bitwise equal.  Returns (max abs err, D launches per call)."""
    batch, k = c.shape[0], c.shape[1]
    before = fused_step.batched_launches
    sums, counts, obj = twice(
        lambda a, b: ops.fused_step_batched(a, b, impl="cuda"), x, c)
    per_call = (fused_step.batched_launches - before) // 2
    sums_p, counts_p, obj_p = fused_step.fused_step_batched_plain(x, c)
    err = 0.0
    for b in range(batch):
        one = ops.fused_step(x[b], c[b], impl="cuda")
        for u, v in zip((sums[b], counts[b], obj[b]), one):
            check(torch.equal(u, v),
                  f"batched stream {b} differs from the single-stream route")
        ties = int(near_ties(x[b], c[b]).sum())
        check(int((counts[b] - counts_p[b]).abs().sum()) <= 2 * ties,
              f"batched counts differ beyond near ties (stream {b})")
        ids_p, _ = ref.assign_ref(x[b], c[b])
        e = (sums[b] - sums_p[b]).abs()
        check(bool((e <= sums_bound(x[b], ids_p, k, ties)).all()),
              f"batched sums off by {float(e.max())} (stream {b})")
        check(abs(float(obj[b]) - float(obj_p[b])) <= RTOL * float(obj_p[b]),
              f"batched obj {float(obj[b])} vs plain {float(obj_p[b])}")
        err = max(err, float(e.max()), abs(float(obj[b]) - float(obj_p[b])))
    return err, per_call


def phase_kernels(seed: int) -> dict:
    shapes = [  # (m, k, n, why)
        (64_000, 25, 28, "main path chunk"),
        (64_001, 25, 3, "ragged m, n = 3"),
        (64_001, 130, 68, "k > 128, n = 68"),
        (64_001, 1024, 1024, "fused envelope edge"),
        (20_001, 1024, 1100, "outside the envelope: two-pass route"),
    ]
    main_err = {}
    for m, k, n, why in shapes:
        x, c = separated(m, k, n, seed)
        ties = near_ties(x, c)
        n_ties = int(ties.sum())
        fits = fused_step.fits(k, n)
        row = {"phase": "kernels", "m": m, "k": k, "n": n, "case": why,
               "fits": fits, "near_ties": n_ties}
        row["assign_max_abs_err"] = check_assign(x, c, ties)
        ids_p, _ = ref.assign_ref(x, c)
        row["update_max_abs_err"] = check_update(x, ids_p, k)
        row["fused_max_abs_err"] = check_fused(x, c, n_ties, direct=fits)
        row["fused_route"] = "kernel A" if fits else "kernels B + C"
        row["update_bitwise_kernel_a_on_its_ids"] = (
            fits and check_update_on_fused_ids(x, c, "f32"))
        check(fits == (n <= 1024), "fits() envelope mismatch")
        emit(row)
        if why == "main path chunk":
            main_err = {"fused_step_f32": row["fused_max_abs_err"],
                        "assign_f32": row["assign_max_abs_err"],
                        "update_f32": row["update_max_abs_err"]}
        del x, c
        torch.cuda.empty_cache()
    batched_shapes = [  # (B, m, k, n, why)
        (BATCH, 64_000, 25, 28, "batched main path chunks"),
        (3, 64_001, 25, 3, "ragged m, n = 3"),
        (2, 64_001, 130, 68, "k > 128, n = 68"),
        (2, 64_001, 1024, 1024, "envelope edge: one stream per launch"),
        (2, 20_001, 1024, 1100, "outside the envelope: B + C per stream"),
    ]
    for batch, m, k, n, why in batched_shapes:
        x, c = batched_separated(batch, m, k, n, seed)
        fits = fused_step.fits_batched(k, n)
        err, per_call = check_batched(x, c)
        stride = k * n + k + 1
        grid = build.grid(x.device, m, stride)
        group = build.stream_group(grid, stride)
        want = -(-batch // group) if fits else 0
        check(per_call == want, f"kernel D launched {per_call} times per "
              f"call, want {want}")
        emit({"phase": "kernels", "kernel": "fused_step_batched_f32",
              "batch": batch, "m": m, "k": k, "n": n, "case": why,
              "fits": fits, "grid_per_stream": grid,
              "streams_per_launch": min(group, batch),
              "launches_per_call": per_call, "max_abs_err": err,
              "route": "kernel D" if fits else "kernels B + C per stream",
              "streams_bitwise_equal_to_single_route": True})
        if why == "batched main path chunks":
            main_err["fused_step_batched_f32"] = err
        del x, c
        torch.cuda.empty_cache()
    emit({"phase": "kernels_summary", "max_abs_err_at_main_shape":
          main_err})
    return main_err


# --------------------------------------------------------------------------
# phase 3b: the int8 kernels against their plain versions
# --------------------------------------------------------------------------


def near_ties_int8(qx, c) -> torch.Tensor:
    """Rows whose best two int8 scores csq - 2 float(xq.cq) t (the
    kernels' argmin) are within TIE_RTOL."""
    if c.shape[0] < 2:
        return torch.zeros(qx.q.shape[0], dtype=torch.bool, device="cuda")
    two = torch.topk(int8_scores(qx, c), 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 0].abs()


def int8_scores(qx, c) -> torch.Tensor:
    """The plain version's int8 scores csq - 2 float(xq.cq) t [m, k], the
    arithmetic of B8's argmin."""
    cq, t = px.quantize_centroids(c, qx.scale)
    dots = px.intdot(qx.q, cq, ([1], [1])).float() * t[None, :]
    return px.sqnorm_in_order(c)[None, :] - 2.0 * dots


def check_assign_int8(qx, c, ties):
    """Kernel B8 twice (bitwise), against the plain version: d bitwise,
    ids the first minimum of the plain scores (bitwise) and the plain ids
    off near ties (where ``(c2 - 2 dots) + x2`` rounds two scores equal,
    the plain argmin can take the other); returns (max abs err of d, B8's
    ids)."""
    ids, d = twice(distance.assign_int8, qx, c)
    ids_p, d_p = distance.assign_int8_plain(qx, c)
    ok = ~ties
    check(torch.equal(ids[ok], ids_p[ok]),
          "assign_int8 ids differ off near ties")
    check(torch.equal(d, d_p), "assign_int8 d not bitwise the plain d")
    check(torch.equal(ids, torch.argmin(int8_scores(qx, c), 1).int()),
          "assign_int8 ids not the first minimum of the plain scores")
    deq = px.dequantize(qx)
    x2 = (deq * deq).sum(1)
    c2 = (c * c).sum(1)[ids_p.long()]
    scale = x2 + c2 + 2 * (x2 * c2).sqrt()
    err = (d - d_p).abs()
    check(bool((err[ok] <= RTOL * scale[ok] + 1e-6).all()),
          f"assign_int8 d off by {float(err.max())}")
    return float(err.max()), ids


def check_update_int8(qx, ids, k) -> float:
    """Kernel C8 twice (bitwise); int32 sums bitwise the one-hot kernel's
    association; int32 sums (so the scaled sums) and counts bitwise equal
    to the plain version on the same ids."""
    ids = ids.clone()
    ids[::97] = -1                                  # padding never hits
    ids[1::89] = k + 3                              # out of range adds nothing
    sums, counts = twice(upd.update_int8, qx, ids, k)
    isums, icounts = upd.launch_update_int8(qx.q, ids, k)
    check_parent_order(isums, icounts, qx.q, ids, k, "update_int8")
    sums_p, counts_p = upd.update_int8_plain(qx, ids, k)
    check(torch.equal(counts, counts_p), "update_int8 counts differ")
    check(torch.equal(sums, sums_p), "update_int8 sums differ")
    return float((sums - sums_p).abs().max())


def check_fused_int8(qx, c, ids_b8, ties: int, direct: bool,
                     pipeline: str = "blocks") -> float:
    """Kernel A8 (direct; A8-dma under ``pipeline="dma"``) or the ops route
    (B8 + C8) twice (bitwise): its int32 sums and counts bitwise those of
    the plain update on kernel B8's ids (the same argmin code), and within
    the near-tie allowance of the plain step on the plain ids; the
    objective within RTOL."""
    k = c.shape[0]
    if direct:
        sums, counts, obj = twice(
            lambda a, b: fused_step.fused_step_int8(a, b, pipeline), qx, c)
    else:
        sums, counts, obj = twice(
            lambda a, b: ops.fused_step(a, b, impl="cuda"), qx, c)
    sums_i, counts_i = upd.update_int8_plain(qx, ids_b8, k)
    check(torch.equal(sums, sums_i) and torch.equal(counts, counts_i),
          "fused int8 sums/counts differ from the plain update on B8's ids")
    sums_p, counts_p, obj_p = fused_step.fused_step_int8_plain(qx, c)
    check(int((counts - counts_p).abs().sum()) <= 2 * ties,
          "fused int8 counts differ beyond near ties")
    room = 2 * ties * 127 * float(qx.scale.max())
    err = float((sums - sums_p).abs().max())
    check(err <= room, f"fused int8 sums off by {err} beyond near ties")
    check(abs(float(obj) - float(obj_p)) <= RTOL * float(obj_p),
          f"fused int8 obj {float(obj)} vs plain {float(obj_p)}")
    return max(err, abs(float(obj) - float(obj_p)))


def check_batched_int8(qx, c) -> tuple[float, int]:
    """Kernel D8 through ``ops`` (outside the envelope: B8 + C8 per
    stream): every stream bitwise equal to the single-stream route (kernel
    A8 inside the envelope), two calls bitwise equal, the plain version
    within the near-tie allowance.  Returns (max abs err, D8 launches per
    call)."""
    batch = c.shape[0]
    before = fused_step.batched_int8_launches
    sums, counts, obj = twice(
        lambda a, b: ops.fused_step_batched(a, b, impl="cuda"), qx, c)
    per_call = (fused_step.batched_int8_launches - before) // 2
    sums_p, counts_p, obj_p = fused_step.fused_step_batched_int8_plain(qx, c)
    err = 0.0
    for b in range(batch):
        qb = px.QuantizedChunk(qx.q[b], qx.scale[b])
        one = ops.fused_step(qb, c[b], impl="cuda")
        for u, v in zip((sums[b], counts[b], obj[b]), one):
            check(torch.equal(u, v), f"int8 batched stream {b} differs "
                  "from the single-stream route")
        ties = int(near_ties_int8(qb, c[b]).sum())
        check(int((counts[b] - counts_p[b]).abs().sum()) <= 2 * ties,
              f"int8 batched counts differ beyond near ties (stream {b})")
        e = float((sums[b] - sums_p[b]).abs().max())
        check(e <= 2 * ties * 127 * float(qb.scale.max()),
              f"int8 batched sums off by {e} (stream {b})")
        check(abs(float(obj[b]) - float(obj_p[b])) <= RTOL * float(obj_p[b]),
              f"int8 batched obj {float(obj[b])} vs plain {float(obj_p[b])}")
        err = max(err, e, abs(float(obj[b]) - float(obj_p[b])))
    return err, per_call


def phase_kernels_int8(seed: int) -> dict:
    shapes = [  # (m, k, n, why)
        (64_000, 25, 28, "main path chunk"),
        (64_001, 25, 3, "ragged m, n = 3"),
        (64_001, 129, 68, "k = 129, n = 68"),
        (64_001, 1024, 1024, "k = n = 1024: fused envelope edge"),
        (20_001, 1024, 1100, "outside the envelope: B8 + C8"),
    ]
    main_err = {}
    for m, k, n, why in shapes:
        x, c = separated(m, k, n, seed)
        qx = px.quantize_chunk(x)
        ties = near_ties_int8(qx, c)
        n_ties = int(ties.sum())
        fits = fused_step.fits(k, n)
        row = {"phase": "kernels_int8", "m": m, "k": k, "n": n, "case": why,
               "fits": fits, "near_ties": n_ties}
        row["assign_int8_max_abs_err"], ids = check_assign_int8(qx, c, ties)
        ids_p, _ = distance.assign_int8_plain(qx, c)
        row["update_int8_max_abs_err"] = check_update_int8(qx, ids_p, k)
        row["fused_int8_max_abs_err"] = check_fused_int8(qx, c, ids, n_ties,
                                                         direct=fits)
        row["fused_route"] = "kernel A8" if fits else "kernels B8 + C8"
        row["update_bitwise_kernel_a_on_its_ids"] = (
            fits and check_update_on_fused_ids(x, c, "int8"))
        emit(row)
        if why == "main path chunk":
            main_err = {"fused_step_int8": row["fused_int8_max_abs_err"],
                        "assign_int8": row["assign_int8_max_abs_err"],
                        "update_int8": row["update_int8_max_abs_err"]}
        del x, c, qx
        torch.cuda.empty_cache()
    batched_shapes = [  # (B, m, k, n, why)
        (BATCH, 64_000, 25, 28, "batched main path chunks"),
        (3, 64_001, 25, 3, "ragged m, n = 3"),
        (2, 64_001, 129, 68, "k = 129, n = 68"),
        (2, 64_001, 1024, 1024, "envelope edge: one stream per launch"),
        (2, 20_001, 1024, 1100, "outside the envelope: B8 + C8 per stream"),
    ]
    for batch, m, k, n, why in batched_shapes:
        x, c = batched_separated(batch, m, k, n, seed)
        qx = px.quantize_chunk(x)                   # a scale row per stream
        fits = fused_step.fits_batched(k, n)
        err, per_call = check_batched_int8(qx, c)
        stride = k * n + k + 1
        grid = build.grid(x.device, m, stride)
        group = build.stream_group(grid, stride)
        want = -(-batch // group) if fits else 0
        check(per_call == want, f"kernel D8 launched {per_call} times per "
              f"call, want {want}")
        emit({"phase": "kernels_int8", "kernel": "fused_step_batched_int8",
              "batch": batch, "m": m, "k": k, "n": n, "case": why,
              "fits": fits, "grid_per_stream": grid,
              "streams_per_launch": min(group, batch),
              "launches_per_call": per_call, "max_abs_err": err,
              "route": "kernel D8" if fits else "kernels B8 + C8 per stream",
              "streams_bitwise_equal_to_single_route": True})
        if why == "batched main path chunks":
            main_err["fused_step_batched_int8"] = err
        del x, c, qx
        torch.cuda.empty_cache()
    emit({"phase": "kernels_int8_summary", "max_abs_err_at_main_shape":
          main_err})
    return main_err


# --------------------------------------------------------------------------
# phase 3c: the bf16 and bf16x3 kernels against their plain versions
# --------------------------------------------------------------------------

POLICIES16 = ("bf16", "bf16x3")


def near_ties_16(x, c, prec: str) -> torch.Tensor:
    """Rows whose best two scores ||c||^2 - 2 dot(x, c) at the policy (x in
    its storage) are within TIE_RTOL."""
    xs = px.cast_storage(x, prec)
    scores = px.sqnorm(c)[None, :] - 2.0 * px.dot(xs, c, ([1], [1]), prec)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 0].abs()


def check_assign_16(x, c, ties, prec: str):
    """Kernel B16 / B3 twice (bitwise), against the plain version (x cast
    to the policy's storage) off near ties; returns (max abs err of d,
    the kernel's ids)."""
    ids, d = twice(lambda a, b: distance.assign_16(a, b, prec), x, c)
    ids_p, d_p = distance.assign_plain(x, c, prec)
    ok = ~ties
    check(torch.equal(ids[ok], ids_p[ok]),
          f"assign_{prec} ids differ off near ties")
    xs = px.cast_storage(x, prec).float()
    x2 = (xs * xs).sum(1)
    c2 = (c * c).sum(1)[ids_p.long()]
    scale = x2 + c2 + 2 * (x2 * c2).sqrt()
    err = (d - d_p).abs()
    check(bool((err[ok] <= RTOL * scale[ok] + 1e-6).all()),
          f"assign_{prec} d off by {float(err.max())}")
    return float(err.max()), ids


def check_update_16(x, ids, k, prec: str) -> float:
    """Kernel C16 / C3 twice (bitwise), bitwise the one-hot kernels'
    association; counts equal to the plain version's on the same ids, sums
    within RTOL of each cluster's sum of |x| (x in its storage)."""
    ids = ids.clone()
    ids[::97] = -1                                  # padding never hits
    ids[1::89] = k + 3                              # out of range adds nothing
    sums, counts = twice(lambda a, b: upd.update_16(a, b, k, prec), x, ids)
    check_parent_order(sums, counts, px.cast_storage(x, prec).float(), ids,
                       k, f"update_{prec}", split=prec == "bf16x3")
    sums_p, counts_p = upd.update_plain(x, ids, k, prec)
    check(torch.equal(counts, counts_p), f"update_{prec} counts differ")
    err = (sums - sums_p).abs()
    xs = px.cast_storage(x, prec).float()
    check(bool((err <= sums_bound(xs, ids, k, 0)).all()),
          f"update_{prec} sums off by {float(err.max())}")
    return float(err.max())


def check_fused_16(x, c, ties: int, prec: str, direct: bool,
                   pipeline: str = "blocks") -> float:
    """Kernel A16 / A3 (direct; their dma twins under ``pipeline="dma"``)
    or the ops route (outside the envelope: B and C at the policy) twice
    (bitwise), against the plain step."""
    k = c.shape[0]
    sums, counts, obj = twice(
        (lambda a, b: fused_step.fused_step_16(a, b, prec, pipeline))
        if direct else
        (lambda a, b: ops.fused_step(a, b, impl="cuda", precision=prec)),
        x, c)
    sums_p, counts_p, obj_p = fused_step.fused_step_plain(x, c, prec)
    ids_p, _ = distance.assign_plain(x, c, prec)
    xs = px.cast_storage(x, prec).float()
    check(int((counts - counts_p).abs().sum()) <= 2 * ties,
          f"fused {prec} counts differ beyond near ties")
    err = (sums - sums_p).abs()
    check(bool((err <= sums_bound(xs, ids_p, k, ties)).all()),
          f"fused {prec} sums off by {float(err.max())}")
    check(abs(float(obj) - float(obj_p)) <= RTOL * float(obj_p),
          f"fused {prec} obj {float(obj)} vs plain {float(obj_p)}")
    return max(float(err.max()), abs(float(obj) - float(obj_p)))


def check_batched_16(x, c, prec: str) -> tuple[float, int]:
    """Kernel D16 / D3 through ``ops`` (outside the envelope: B and C at
    the policy, stream by stream): every stream bitwise equal to the
    single-stream route (A16 / A3 inside the envelope), two calls bitwise
    equal, the plain version within the near-tie allowance.  Returns (max
    abs err, D launches per call)."""
    batch, k = c.shape[0], c.shape[1]
    before = fused_step.batched_launches16[prec]
    sums, counts, obj = twice(
        lambda a, b: ops.fused_step_batched(a, b, impl="cuda",
                                            precision=prec), x, c)
    per_call = (fused_step.batched_launches16[prec] - before) // 2
    sums_p, counts_p, obj_p = fused_step.fused_step_batched_plain(x, c, prec)
    err = 0.0
    for b in range(batch):
        one = ops.fused_step(x[b], c[b], impl="cuda", precision=prec)
        for u, v in zip((sums[b], counts[b], obj[b]), one):
            check(torch.equal(u, v), f"{prec} batched stream {b} differs "
                  "from the single-stream route")
        ties = int(near_ties_16(x[b], c[b], prec).sum())
        check(int((counts[b] - counts_p[b]).abs().sum()) <= 2 * ties,
              f"{prec} batched counts differ beyond near ties (stream {b})")
        ids_p, _ = distance.assign_plain(x[b], c[b], prec)
        xs = px.cast_storage(x[b], prec).float()
        e = (sums[b] - sums_p[b]).abs()
        check(bool((e <= sums_bound(xs, ids_p, k, ties)).all()),
              f"{prec} batched sums off by {float(e.max())} (stream {b})")
        check(abs(float(obj[b]) - float(obj_p[b])) <= RTOL * float(obj_p[b]),
              f"{prec} batched obj {float(obj[b])} vs plain "
              f"{float(obj_p[b])}")
        err = max(err, float(e.max()), abs(float(obj[b]) - float(obj_p[b])))
    return err, per_call


def phase_kernels_16(seed: int) -> dict:
    """Phase 3's cases for the eight bf16 / bf16x3 entry points."""
    shapes = [  # (m, k, n, why)
        (64_000, 25, 28, "main path chunk"),
        (64_001, 25, 3, "ragged m, n = 3"),
        (64_001, 129, 68, "k = 129, n = 68"),
        (64_001, 1024, 1024, "k = n = 1024: fused envelope edge"),
        (20_001, 1024, 1100, "outside the envelope: two-pass route"),
    ]
    batched_shapes = [  # (B, m, k, n, why)
        (BATCH, 64_000, 25, 28, "batched main path chunks"),
        (3, 64_001, 25, 3, "ragged m, n = 3"),
        (2, 64_001, 129, 68, "k = 129, n = 68"),
        (2, 64_001, 1024, 1024, "envelope edge: one stream per launch"),
        (2, 20_001, 1024, 1100, "outside the envelope: B + C per stream"),
    ]
    main_err = {}
    for prec in POLICIES16:
        for m, k, n, why in shapes:
            x, c = separated(m, k, n, seed)
            ties = near_ties_16(x, c, prec)
            n_ties = int(ties.sum())
            fits = fused_step.fits(k, n)
            row = {"phase": "kernels_16", "precision": prec, "m": m, "k": k,
                   "n": n, "case": why, "fits": fits, "near_ties": n_ties}
            row["assign_max_abs_err"], _ = check_assign_16(x, c, ties, prec)
            ids_p, _ = distance.assign_plain(x, c, prec)
            row["update_max_abs_err"] = check_update_16(x, ids_p, k, prec)
            row["fused_max_abs_err"] = check_fused_16(x, c, n_ties, prec,
                                                      direct=fits)
            row["fused_route"] = (f"fused_step_{prec}" if fits
                                  else f"assign_{prec} + update_{prec}")
            row["update_bitwise_kernel_a_on_its_ids"] = (
                fits and check_update_on_fused_ids(x, c, prec))
            emit(row)
            if why == "main path chunk":
                main_err.update({
                    f"fused_step_{prec}": row["fused_max_abs_err"],
                    f"assign_{prec}": row["assign_max_abs_err"],
                    f"update_{prec}": row["update_max_abs_err"]})
            del x, c
            torch.cuda.empty_cache()
        for batch, m, k, n, why in batched_shapes:
            x, c = batched_separated(batch, m, k, n, seed)
            fits = fused_step.fits_batched(k, n)
            err, per_call = check_batched_16(x, c, prec)
            stride = k * n + k + 1
            grid = build.grid(x.device, m, stride)
            group = build.stream_group(grid, stride)
            want = -(-batch // group) if fits else 0
            check(per_call == want, f"fused_step_batched_{prec} launched "
                  f"{per_call} times per call, want {want}")
            emit({"phase": "kernels_16", "precision": prec,
                  "kernel": f"fused_step_batched_{prec}", "batch": batch,
                  "m": m, "k": k, "n": n, "case": why, "fits": fits,
                  "grid_per_stream": grid,
                  "streams_per_launch": min(group, batch),
                  "launches_per_call": per_call, "max_abs_err": err,
                  "streams_bitwise_equal_to_single_route": True})
            if why == "batched main path chunks":
                main_err[f"fused_step_batched_{prec}"] = err
            del x, c
            torch.cuda.empty_cache()
    emit({"phase": "kernels_16_summary", "max_abs_err_at_main_shape":
          main_err})
    return main_err


# --------------------------------------------------------------------------
# phase 3d: the dma kernels against kernels A, A8, A16, A3
# --------------------------------------------------------------------------

POLICIES = ("f32", "int8", "bf16", "bf16x3")


def fused_entry(prec: str):
    """The single-chunk fused step at ``prec``: ``f(x, c, pipeline)``."""
    if prec == "f32":
        return fused_step.fused_step_f32
    if prec == "int8":
        return fused_step.fused_step_int8
    return lambda x, c, pipeline="blocks": fused_step.fused_step_16(
        x, c, prec, pipeline)


def offset_view(x, elements: int):
    """A contiguous copy of ``x`` whose first element lies ``elements``
    elements into its buffer (a bf16 or int8 row then starts off a 4-byte
    word)."""
    buf = torch.empty(x.numel() + elements, dtype=x.dtype, device=x.device)
    view = buf[elements:].view(x.shape)
    view.copy_(x)
    return view


def phase_kernels_dma(seed: int) -> dict:
    """Phase 3d: A-dma, A8-dma, A16-dma and A3-dma bitwise kernels A, A8,
    A16 and A3 at phase 3c's fused shapes and at an odd n > 32 from a base
    one element off its buffer; each held against the plain version with
    phase 3's tolerances, two launches bitwise equal."""
    shapes = [  # (m, k, n, why, base offset in elements)
        (64_000, 25, 28, "main path chunk", 0),
        (64_001, 25, 3, "ragged m, n = 3", 0),
        (64_001, 129, 68, "k = 129, n = 68", 0),
        (64_001, 1024, 1024, "k = n = 1024: fused envelope edge", 0),
        (64_001, 40, 37, "n = 37 (odd, > 32), x off its buffer's start", 1),
    ]
    main_err = {}
    for m, k, n, why, off in shapes:
        x, c = separated(m, k, n, seed)
        row = {"phase": "kernels_dma", "m": m, "k": k, "n": n, "case": why,
               "base_offset_elements": off}
        for prec in POLICIES:
            fn = fused_entry(prec)
            if prec == "int8":
                qx = px.quantize_chunk(x)
                xs = px.QuantizedChunk(offset_view(qx.q, off), qx.scale)
            else:
                xs = offset_view(px.cast_storage(x, prec), off)
            blocks, dma = fn(xs, c, "blocks"), fn(xs, c, "dma")
            torch.cuda.synchronize()
            for u, v in zip(blocks, dma):
                check(torch.equal(u, v), f"fused_step_dma_{prec} differs "
                      f"from its blocks twin at {why}")
            if prec == "f32":
                err = check_fused(xs, c, int(near_ties(x, c).sum()),
                                  pipeline="dma")
            elif prec == "int8":
                ids8, _ = distance.assign_int8(xs, c)
                err = check_fused_int8(xs, c, ids8,
                                       int(near_ties_int8(xs, c).sum()),
                                       True, "dma")
            else:
                err = check_fused_16(xs, c,
                                     int(near_ties_16(x, c, prec).sum()),
                                     prec, True, "dma")
            row[f"{prec}_bitwise_blocks"] = True
            row[f"{prec}_max_abs_err"] = err
            if why == "main path chunk":
                main_err[f"fused_step_dma_{prec}"] = err
            del xs, blocks, dma
        emit(row)
        del x, c
        torch.cuda.empty_cache()
    emit({"phase": "kernels_dma_summary", "max_abs_err_at_main_shape":
          main_err})
    return main_err


# --------------------------------------------------------------------------
# phase 3e: kernel P against its plain version
# --------------------------------------------------------------------------


def seeding_probe(x, seed: int):
    """The probe's inputs as K-means++ gives them on chunk x: a first seed
    and three candidates drawn from x, d the distances to the first."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    idx = torch.randint(0, x.shape[0], (4,), generator=gen, device="cuda")
    d = ((x - x[idx[0]]) ** 2).sum(1)
    return x[idx[1:]].contiguous(), d.contiguous()


def check_kpp(xc, cc, dc, why: str) -> float:
    """Kernel P twice (bitwise) against ``kpp_probe_plain``: newd within
    RTOL of its terms' magnitude, pot within RTOL.  Returns the max abs
    error."""
    newd, pot = twice(kpp.kpp_probe_cuda, xc, cc, dc)
    newd_p, pot_p = kpp.kpp_probe_plain(xc, cc, dc)
    terms = (xc.norm(dim=1)[:, None] + cc.norm(dim=1)[None, :]) ** 2
    e = (newd - newd_p).abs()
    check(bool((e <= RTOL * terms).all()),
          f"kpp_probe newd off by {float(e.max())} at {why}")
    pe = (pot - pot_p).abs()
    check(bool((pe <= RTOL * pot_p.abs()).all()),
          f"kpp_probe pot off by {float(pe.max())} at {why}")
    emit({"phase": "kernels_kpp", "m": xc.shape[0], "n": xc.shape[1],
          "L": cc.shape[0], "case": why, "newd_max_abs_err":
          float(e.max()), "pot_max_rel_err": float((pe / pot_p).max()),
          "repeat_bitwise": True})
    return max(float(e.max()), float(pe.max()))


def kpp_graphs_on_two_streams(x, cands, d, replays: int = 200) -> int:
    """Two CUDA graphs of kernel P captured on one stream, replayed at once
    on two other streams ``replays`` times each: every replay's pot (and
    the last replay's newd) bitwise a lone launch's.  Each launch owns its
    ticket, so the last CTA of one replay is never chosen by the other's.
    Returns the replays checked per graph."""
    newd0, pot0 = kpp.kpp_probe_cuda(x, cands, d)
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):
        kpp.kpp_probe_cuda(x, cands, d)         # warm-up on the capture stream
    graphs = []
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=cap):
            out = kpp.kpp_probe_cuda(x, cands, d)
        graphs.append((graph, out))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    pots = [torch.full((replays, cands.shape[0]), math.nan, device="cuda")
            for _ in graphs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        st.wait_stream(cap)
    for i in range(replays):
        for (graph, (_, pot)), st, rec in zip(graphs, streams, pots):
            with torch.cuda.stream(st):
                graph.replay()
                rec[i].copy_(pot)
    torch.cuda.synchronize()
    for (_, (newd, _)), rec in zip(graphs, pots):
        check(torch.equal(rec, pot0.expand_as(rec))
              and torch.equal(newd, newd0),
              "kernel P: a graph replayed beside another differs from a "
              "lone launch")
    return replays


def phase_kpp(seed: int):
    """Phase 3e: kernel P against ``kpp_probe_plain`` at the reference
    test's shapes and at L = 1, 5, 9, 33 around its candidate tiles (4, 8
    and 32 dots a row; standard normal x and candidates, d uniform in
    [0, 4n), so that about half the rows take a candidate's distance), at
    the seeding shape (a main path chunk, candidates drawn from it), the
    same with x and d one element off their buffers, and at the two-pass
    width (16,384 x 1,024, L = 3).  newd within RTOL of its terms'
    magnitude (||x|| + ||c||)^2, the condition of (csq - 2 dot) + xsq (a
    candidate's own row has newd ~ 0); pot within RTOL; repeat launches
    bitwise.  Two graphs of P replayed at once on two streams, each replay
    bitwise a lone launch (:func:`kpp_graphs_on_two_streams`).  Then the
    entry point ``kpp_probe`` once at the seeding shape,
    its launches counted: P's own path.  Returns (max abs err at the
    seeding shape, the path's counts)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cases = []
    for m, n, L, why in ((100, 7, 3, "reference test shape"),
                         (513, 28, 3, "reference test shape"),
                         (300, 768, 8, "reference test shape"),
                         (1000, 68, 128, "reference test shape"),
                         (3000, 28, 1, "L = 1"), (3000, 28, 5, "L = 5"),
                         (3000, 28, 9, "L = 9"), (3000, 28, 33, "L = 33")):
        cases.append((why,
                      torch.randn((m, n), generator=gen, device="cuda"),
                      torch.randn((L, n), generator=gen, device="cuda"),
                      torch.rand((m,), generator=gen, device="cuda")
                      * 4.0 * n))
    x, _ = separated(64_000, 25, 28, seed)
    cands, d = seeding_probe(x, seed)
    cases.append(("seeding shape", x, cands, d))
    cases.append(("seeding shape, x and d one element off their buffers",
                  offset_view(x, 1), cands, offset_view(d, 1)))
    x2, _ = separated(16_384, 2048, 1024, seed)
    cands2, d2 = seeding_probe(x2, seed)
    cases.append(("two-pass width", x2, cands2, d2))
    err = 0.0
    for why, xc, cc, dc in cases:
        row_err = check_kpp(xc, cc, dc, why)
        if why == "seeding shape":
            err = row_err
    del cases, x2, cands2, d2
    replays = kpp_graphs_on_two_streams(x, cands, d)
    emit({"phase": "kernels_kpp_two_streams", "m": x.shape[0],
          "n": x.shape[1], "L": cands.shape[0], "graphs": 2,
          "replays_each": replays, "pot_bitwise_lone_launch": True,
          "newd_bitwise_lone_launch": True})
    ops.reset_launch_counts()
    t0 = time.monotonic()
    newd, pot = kpp.kpp_probe(x, cands, d)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    want = dict.fromkeys(launches, 0)
    want["kpp_probe"] = 1
    check(launches == want, f"kpp_probe entry launches {launches}")
    check(tuple(newd.shape) == (64_000, 3) and bool(torch.isfinite(pot).all()),
          "kpp_probe entry outputs")
    return err, (launches, wall)


def kpp_draw_cost(s: int, n: int, L: int) -> tuple:
    """(bytes, operations) of kernel G after a probe: the noise and newd
    read once, d written once (the draw reads it from registers), the
    candidates gathered and written; a noise add and a compare a draw."""
    return 4 * (2 * L * s + s + 2 * L * n), 2 * L * s


def check_chain(x, d, L: int, seed: int, why: str) -> dict:
    """Two chained slots of ``SlotChain`` on ``x``, ``d`` and its finish,
    each slot's Gumbel noise drawn as ``core.kmeanspp`` draws it: every
    draw (candidate rows and candidates) bitwise ``kpp_draw_plain`` on the
    chain's d, every pick (the first candidate of least potential into its
    centroid row, newd's column into d; the last pick writes its row alone,
    as the seeding needs no d after it) bitwise; G launched 3 times, P 2.
    Returns the path's counts and wall."""
    s, n = x.shape
    keys = rnd.TORCH.split(rnd.TORCH.key(seed), 2)
    c = torch.zeros((2, n), device="cuda")
    dd = d.clone()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    chain = kpp.SlotChain(x, dd, c, L)
    want_d, pick = d, None     # the d a draw sees; the pick G must write
    for j, key in enumerate(keys):
        noise = rnd.TORCH.gumbel(key, (L, s), x.device)
        chain.slot(noise, j)            # G: slot j - 1's pick, j's draw; P
        if pick is not None:
            check(torch.equal(c[j - 1], pick[0]) and torch.equal(dd, pick[1]),
                  f"kernel G's pick of slot {j - 1} at {why}")
        idx, cands = kpp.kpp_draw_plain(x, noise, want_d)
        check(torch.equal(chain.idx, idx) and torch.equal(chain.cands, cands),
              f"kernel G's draw of slot {j} differs from kpp_draw_plain at "
              f"{why}")
        b = int(torch.argmin(chain.pot))
        pick = (chain.cands[b].clone(), chain.newd[:, b].clone())
        want_d = pick[1]
    chain.finish()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(torch.equal(c[1], pick[0]), f"kernel G's last pick at {why}")
    launches = ops.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(kpp_draw=3, kpp_probe=2)
    check(launches == want, f"slot chain launches {launches} at {why}")
    emit({"phase": "kernels_kpp_chain", "m": s, "n": n, "L": L,
          "case": why, "draws_bitwise_plain": True,
          "picks_bitwise": True, "launches": launches})
    return launches, wall


def time_draw(x, d, L: int, seed: int, launches: int) -> dict:
    """Kernel G as a slot after the first launches it (the previous slot's
    pick, then the draw) by graph replay, beside the oracle chain's pick
    and draw (``argmin`` of the potentials, the ``index_select`` of the
    candidate and of newd's column, ``kpp_draw_plain``) and its bound."""
    s, n = x.shape
    noise = rnd.TORCH.gumbel(rnd.TORCH.key(seed), (L, s), x.device)
    c = torch.zeros((1, n), device="cuda")
    chain = kpp.SlotChain(x, d.clone(), c, L)
    chain.slot(noise, 0)                 # a probe for each draw to pick from
    newd, pot, cands = chain.newd, chain.pot, chain.cands

    def plain():
        b = torch.argmin(pot, dim=0, keepdim=True)
        c[0] = cands.index_select(0, b)[0]
        return kpp.kpp_draw_plain(x, noise, newd.index_select(1, b)[:, 0])

    row = timing(lambda: chain.draw(noise), plain, None,
                 *kpp_draw_cost(s, n, L), launches)
    row.update(m=s, n=n, L=L, library="none (no single call computes it)")
    return row


def phase_kpp_chain(seed: int):
    """Phase 3f: kernel G and the slot chain (see the module docstring).
    Returns (G's max abs error, 0 as every check is bitwise; G's timing row
    at the seeding shape, its codebook seeding row under
    ``at_codebook_seeding``; P's timing row at the codebook seeding shape;
    the chain's counts and wall at the seeding shape)."""
    x, _ = separated(64_000, 25, 28, seed)
    _, d = seeding_probe(x, seed)
    path = check_chain(x, d, 3, seed, "seeding shape")
    row = time_draw(x, d, 3, seed, 200)
    del x, d
    xb, _ = separated(163_840, 64, 768, seed)
    cands, d = seeding_probe(xb, seed)
    check_kpp(xb, cands, d, "codebook seeding shape")
    check_chain(xb, d, 3, seed, "codebook seeding shape")
    row["at_codebook_seeding"] = time_draw(xb, d, 3, seed, 50)
    probe = timing(
        lambda: kpp.kpp_probe_cuda(xb, cands, d),
        lambda: kpp.kpp_probe_plain(xb, cands, d), None,
        *kpp_cost(*xb.shape, 3), 50)
    probe.update(m=xb.shape[0], n=xb.shape[1], L=3)
    for name, r in (("kpp_draw", row), ("kpp_probe", probe)):
        emit({"phase": "kernels_kpp_chain_times", "kernel": name, **r})
    del xb, cands, d
    torch.cuda.empty_cache()
    return 0.0, row, probe, path


# --------------------------------------------------------------------------
# phase 4: the sequential main path at full size
# --------------------------------------------------------------------------


def first_parting(a, b):
    for i, ((_, fa, aa), (_, fb, ab)) in enumerate(zip(a, b)):
        if aa != ab:
            return {"chunk": i, "f_new_cuda": fa, "f_new_ref": fb}
    return None


def phase_main(seed: int):
    m, n = PAPER_DATASETS["hepmass"]
    spec = GMMSpec(m=m, n=n, components=25, seed=seed)
    t0 = time.monotonic()
    X = gmm_dataset(spec, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed)
    for impl in ("cuda", "ref"):        # warm both paths (first-use costs)
        fit(X, cfg.replace(n_chunks=2, impl=impl, seed=seed + 1))

    ops.reset_launch_counts()
    tracing.snapshot()                  # the slots the fit seeds, counted
    tracing.enable(True)
    t0 = time.monotonic()
    try:
        res = fit(X, cfg, method="auto")
    finally:
        tracing.enable(False)
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    counters = tracing.snapshot()["counters"]

    n_eval = math.ceil(m / EVAL_BATCH)
    check(res.strategy == "sequential" and res.extras.get("auto"),
          f"auto resolved to {res.strategy}")
    check(res.extras["fit"]["impl"] == "cuda", "fit did not use the kernels")
    check(res.centroids.is_cuda, "centroids are not on the card")
    check(tuple(res.centroids.shape) == (25, n), "centroid shape")
    check(bool(torch.isfinite(res.centroids).all()), "non-finite centroids")
    check(tuple(ids.shape) == (m,) and int(ids.min()) >= 0
          and int(ids.max()) < 25, "evaluate ids")
    check(math.isfinite(f_full) and f_full > 0, "full objective")
    check(launches["fused_step"] == res.n_iterations,
          f"fused launches {launches['fused_step']} != iterations "
          f"{res.n_iterations}")
    check(launches["update"] == cfg.n_chunks,
          f"update launches {launches['update']} != {cfg.n_chunks}")
    check(launches["assign"] == cfg.n_chunks + n_eval,
          f"assign launches {launches['assign']} != {cfg.n_chunks} + "
          f"{n_eval}")
    # P once a seeded slot, G once more a seeding (each chunk_step that
    # re-seeds reads its degenerate mask once)
    slots = counters.get("core.kmeanspp.probe.kernel", 0)
    seedings = counters.get("host_sync.core.kmeanspp.mask", 0)
    check(slots > 0 and counters.get("core.kmeanspp.probe.plain", 0) == 0
          and launches["kpp_probe"] == slots
          and launches["kpp_draw"] == slots + seedings,
          f"seeding launches G {launches['kpp_draw']}, P "
          f"{launches['kpp_probe']} against {slots} slots in {seedings} "
          f"seedings")

    t1 = time.monotonic()
    res_ref = fit(X, cfg.replace(impl="ref"), method="auto")
    torch.cuda.synchronize()
    wall_ref_fit = time.monotonic() - t1
    check(ops.launch_counts() == launches, "the ref fit launched a kernel")
    _, f_full_ref = evaluate(res_ref, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    walls = {"ref": [], "cuda": []}     # fit wall, in turns: r, c, c, r
    for impl in ("ref", "cuda", "cuda", "ref"):
        walls[impl].append(fit(X, cfg.replace(impl=impl)).wall_time_s)
    emit({"phase": "main_path", "m": m, "n": n, "k": cfg.k, "s": cfg.s,
          "n_chunks": cfg.n_chunks, "data_gb": X.numel() * 4 / 1e9,
          "data_gen_s": gen_s, "strategy": res.strategy,
          "f_best": res.objective, "f_full": f_full,
          "f_full_per_point": f_full / m, "n_accepted": res.n_accepted,
          "n_iterations": res.n_iterations, "wall_s": wall,
          "fit_wall_s": res.wall_time_s, "seeded_slots": slots,
          "seedings": seedings,
          "fit_ms_per_lloyd_iteration": 1e3 * res.wall_time_s
          / res.n_iterations, "launches": launches,
          "eval_batches": n_eval,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations,
                  "fit_wall_s": wall_ref_fit},
          "f_full_rel_diff": rel, "fit_walls_s": walls,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": first_parting(res.trace, res_ref.trace)})
    check(rel <= 1e-3, f"full objectives differ by {rel:.3e} (> 1e-3)")
    check({k for k, v in off_seeding(launches).items() if v}
          == {"fused_step", "assign", "update"},
          f"sequential path launches {launches}")
    FIT_WALLS["sequential"] = res.wall_time_s
    return X, res, launches, wall, walls, f_full


# --------------------------------------------------------------------------
# phase 5: the batched main path at full size
# --------------------------------------------------------------------------


def incumbents_before(trace, batch: int, sync_every: int,
                      start: float = math.inf) -> list:
    """The incumbent f each chunk of a round-major batched trace was
    compared with (streams start at ``start``, inf unless resumed, and
    exchange the best every ``sync_every`` rounds)."""
    f_best = [start] * batch
    out = []
    for i, (_, f_new, accepted) in enumerate(trace):
        b = i % batch
        out.append(f_best[b])
        if accepted:
            f_best[b] = f_new
        if b == batch - 1 and (i // batch + 1) % sync_every == 0:
            f_best = [min(f_best)] * batch
    return out


def check_accepts(trace, trace_ref, batch: int, sync_every: int,
                  start: float = math.inf):
    """The two paths' ``(i, f_new, accepted)`` traces take the same accept
    decisions up to the first one that is a near tie (f_new within
    TIE_RTOL of its incumbent on either path); after such a decision the
    trajectories may part."""
    parting = first_parting(trace, trace_ref)
    if parting is None:
        return None
    i = parting["chunk"]
    incs = [incumbents_before(tr, batch, sync_every, start)[i]
            for tr in (trace, trace_ref)]
    near = [abs(tr[i][1] - inc) <= TIE_RTOL * abs(inc)
            for tr, inc in zip((trace, trace_ref), incs)]
    check(any(near), f"accept sequences part at chunk {i} without a near "
          f"tie: {parting}")
    return parting


PROFILED = (  # (file under src/repro_torch, function): host time read
    ("core/bigmeans.py", "sample_chunk"), ("core/kmeanspp.py", "seed"),
    ("core/kmeanspp.py", "seed_batched"), ("core/kmeans.py", "lloyd"),
    ("core/kmeans.py", "lloyd_batched"), ("kernels/ops.py", "fused_step"),
    ("kernels/ops.py", "fused_step_batched"), ("kernels/ops.py", "assign"),
    ("kernels/ops.py", "update"), ("core/bigmeans.py", "_exchange_best"),
    ("engine/incore.py", "_sharded_segment"))


def host_profile(path: str, run) -> None:
    """Cumulative host seconds of the package's main functions over one
    warm ``run()`` under cProfile (which inflates Python calls: read the
    shares, not the absolute times)."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.monotonic() - t0
    stats = pstats.Stats(prof).stats
    cum = {}
    for (file, _, fn), (_, calls, _, ct, _) in stats.items():
        for mod, name in PROFILED:
            if fn == name and Path(file).as_posix().endswith(
                    "repro_torch/" + mod):
                cum[f"{Path(mod).stem}.{name}"] = {"calls": calls,
                                                    "cum_s": ct}
    emit({"phase": "host_profile", "path": path, "profiled_wall_s": wall,
          "functions": cum})


def phase_batched(X, seed: int, seq_fit_walls: dict):
    m, n = X.shape
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, batch=BATCH,
                         sync_every=SYNC_EVERY, seed=seed)
    for impl in ("cuda", "ref"):        # warm both paths (first-use costs)
        fit(X, cfg.replace(n_chunks=2 * BATCH, impl=impl, seed=seed + 1))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="auto")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(m / EVAL_BATCH)
    rounds = cfg.n_chunks // BATCH
    check(res.strategy == "batched" and res.extras.get("auto"),
          f"auto resolved to {res.strategy}")
    check(res.extras["batch"] == BATCH and res.extras["rounds"] == rounds,
          "batched extras")
    check(res.extras["fit"]["impl"] == "cuda", "fit did not use the kernels")
    check(res.centroids.is_cuda, "centroids are not on the card")
    check(tuple(res.centroids.shape) == (25, n), "centroid shape")
    check(bool(torch.isfinite(res.centroids).all()), "non-finite centroids")
    check(tuple(ids.shape) == (m,) and int(ids.min()) >= 0
          and int(ids.max()) < 25, "evaluate ids")
    check(math.isfinite(f_full) and f_full > 0, "full objective")
    check(res.n_chunks == cfg.n_chunks and len(res.trace) == cfg.n_chunks,
          "batched trace length")
    # Per-chunk Lloyd iterations are not in FitResult: replay the same run
    # (same key, deterministic kernels) through the core driver.
    ops.reset_launch_counts()
    state, infos = big_means_batched(
        X, rnd.TORCH.key(seed), k=cfg.k, s=cfg.s, batch=BATCH,
        rounds=rounds, sync_every=SYNC_EVERY)
    replay_launches = ops.launch_counts()
    check(torch.equal(state.centroids, res.centroids)
          and float(state.f_best) == res.objective,
          "the core replay of the batched fit differs from it")
    iters = infos.lloyd_iters.view(rounds, BATCH)
    slowest = int(iters.max(dim=1).values.sum())
    check(replay_launches["fused_step_batched"] == slowest,
          f"kernel D launches {replay_launches['fused_step_batched']} != "
          f"sum over rounds of the slowest stream's iterations {slowest}")
    check(int(iters.sum()) == res.n_iterations, "iterations")
    want = seeded_zeros(launches)
    want.update(fused_step_batched=slowest, update=cfg.n_chunks,
                assign=cfg.n_chunks + n_eval)
    check(launches == want, f"batched path launches {launches} != {want}")

    t1 = time.monotonic()
    res_ref = fit(X, cfg.replace(impl="ref"), method="auto")
    torch.cuda.synchronize()
    wall_ref_fit = time.monotonic() - t1
    _, f_full_ref = evaluate(res_ref, X, impl="ref")
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, BATCH, SYNC_EVERY)

    # batch=1 through the batched strategy is the sequential fit, bitwise
    one_cfg = cfg.replace(batch=1, n_chunks=8)
    one = fit(X, one_cfg, method="batched")
    seq = fit(X, one_cfg, method="sequential")
    check(torch.equal(one.centroids, seq.centroids)
          and one.objective == seq.objective and one.trace == seq.trace
          and one.n_dist_evals == seq.n_dist_evals,
          "batch=1 batched fit differs from the sequential fit")

    walls = {"sequential": [], "batched": []}   # cuda fit walls, in turns
    for method in ("sequential", "batched", "batched", "sequential"):
        c = cfg if method == "batched" else cfg.replace(batch=1)
        walls[method].append(fit(X, c, method=method).wall_time_s)
    host_profile("sequential", lambda: fit(X, cfg.replace(batch=1),
                                           method="sequential"))
    host_profile("batched", lambda: fit(X, cfg, method="batched"))
    emit({"phase": "main_path_batched", "m": m, "n": n, "k": cfg.k,
          "s": cfg.s, "n_chunks": cfg.n_chunks, "batch": BATCH,
          "sync_every": SYNC_EVERY, "rounds": rounds,
          "strategy": res.strategy, "f_best": res.objective,
          "f_full": f_full, "f_full_per_point": f_full / m,
          "n_accepted": res.n_accepted, "n_iterations": res.n_iterations,
          "iterations_per_chunk": iters.flatten().tolist(),
          "slowest_stream_iterations_sum": slowest, "wall_s": wall,
          "fit_wall_s": res.wall_time_s,
          "fit_ms_per_batched_iteration": 1e3 * res.wall_time_s / slowest,
          "launches": launches, "eval_batches": n_eval,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations,
                  "fit_wall_s": wall_ref_fit},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting,
          "batch1_bitwise_equal_to_sequential": True,
          "batch1_n_chunks": one_cfg.n_chunks,
          "fit_walls_s": walls,
          "sequential_fit_walls_s_phase4": seq_fit_walls})
    check(rel <= 1e-3, f"full objectives differ by {rel:.3e} (> 1e-3)")
    FIT_WALLS["batched"] = res.wall_time_s
    return res, f_full, launches, wall


# --------------------------------------------------------------------------
# phases 4b, 5b, 5c: the int8 paths at full size
# --------------------------------------------------------------------------


def fit_checks(res, X, ids, f_full, k: int, precision: str) -> None:
    check(res.extras["fit"]["impl"] == "cuda", "fit did not use the kernels")
    check(res.extras["fit"]["precision"] == precision,
          f"fit ran precision {res.extras['fit']['precision']}")
    check(res.centroids.is_cuda, "centroids are not on the card")
    check(tuple(res.centroids.shape) == (k, X.shape[1]), "centroid shape")
    check(bool(torch.isfinite(res.centroids).all()), "non-finite centroids")
    check(tuple(ids.shape) == (X.shape[0],) and int(ids.min()) >= 0
          and int(ids.max()) < k, "evaluate ids")
    check(math.isfinite(f_full) and f_full > 0, "full objective")


def phase_main_int8(X, seed: int, f_full_f32: float):
    """Phase 4's sequential fit under ``precision="int8"`` (kernel A8)."""
    m, n = X.shape
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed,
                         precision="int8")
    for impl in ("cuda", "ref"):        # warm both paths (first-use costs)
        fit(X, cfg.replace(n_chunks=2, impl=impl, seed=seed + 1))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="auto")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(m / EVAL_BATCH)
    check(res.strategy == "sequential", f"auto resolved to {res.strategy}")
    fit_checks(res, X, ids, f_full, cfg.k, "int8")
    want = seeded_zeros(launches)
    want.update(fused_step_int8=res.n_iterations, update=cfg.n_chunks,
                assign=cfg.n_chunks + n_eval)
    check(launches == want, f"int8 sequential launches {launches} != {want}")

    res_ref = fit(X, cfg.replace(impl="ref"), method="auto")
    check(ops.launch_counts() == launches, "the ref fit launched a kernel")
    _, f_full_ref = evaluate(res_ref, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, 1, 1)
    walls = {"f32": [], "int8": []}     # cuda fit walls, in turns
    for prec in ("f32", "int8", "int8", "f32"):
        walls[prec].append(fit(X, cfg.replace(precision=prec)).wall_time_s)
    emit({"phase": "main_path_int8", "m": m, "n": n, "k": cfg.k, "s": cfg.s,
          "n_chunks": cfg.n_chunks, "strategy": res.strategy,
          "f_best": res.objective, "f_full": f_full,
          "f_full_per_point": f_full / m, "n_accepted": res.n_accepted,
          "n_iterations": res.n_iterations, "wall_s": wall,
          "fit_wall_s": res.wall_time_s, "launches": launches,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting,
          "f32_f_full": f_full_f32,
          "int8_vs_f32_f_full_drift": (f_full - f_full_f32) / f_full_f32,
          "fit_walls_s_in_turns": walls})
    check(rel <= 1e-3, f"int8 full objectives differ by {rel:.3e} (> 1e-3)")
    FIT_WALLS["int8_sequential"] = res.wall_time_s
    return launches, wall


def phase_batched_int8(X, seed: int, f_full_f32: float):
    """Phase 5's batched fit under ``precision="int8"`` (kernel D8)."""
    m, n = X.shape
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, batch=BATCH,
                         sync_every=SYNC_EVERY, seed=seed, precision="int8")
    for impl in ("cuda", "ref"):        # warm both paths (first-use costs)
        fit(X, cfg.replace(n_chunks=2 * BATCH, impl=impl, seed=seed + 1))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="auto")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(m / EVAL_BATCH)
    rounds = cfg.n_chunks // BATCH
    check(res.strategy == "batched", f"auto resolved to {res.strategy}")
    fit_checks(res, X, ids, f_full, cfg.k, "int8")
    ops.reset_launch_counts()           # replay for per-chunk iterations
    state, infos = big_means_batched(
        X, rnd.TORCH.key(seed), k=cfg.k, s=cfg.s, batch=BATCH,
        rounds=rounds, sync_every=SYNC_EVERY, precision="int8")
    check(torch.equal(state.centroids, res.centroids)
          and float(state.f_best) == res.objective,
          "the core replay of the int8 batched fit differs from it")
    iters = infos.lloyd_iters.view(rounds, BATCH)
    slowest = int(iters.max(dim=1).values.sum())
    want = seeded_zeros(launches)
    want.update(fused_step_batched_int8=slowest, update=cfg.n_chunks,
                assign=cfg.n_chunks + n_eval)
    check(launches == want, f"int8 batched launches {launches} != {want}")

    res_ref = fit(X, cfg.replace(impl="ref"), method="auto")
    _, f_full_ref = evaluate(res_ref, X, impl="ref")
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, BATCH, SYNC_EVERY)
    emit({"phase": "main_path_batched_int8", "m": m, "n": n, "k": cfg.k,
          "s": cfg.s, "n_chunks": cfg.n_chunks, "batch": BATCH,
          "sync_every": SYNC_EVERY, "rounds": rounds,
          "f_best": res.objective, "f_full": f_full,
          "n_accepted": res.n_accepted, "n_iterations": res.n_iterations,
          "iterations_per_chunk": iters.flatten().tolist(),
          "slowest_stream_iterations_sum": slowest, "wall_s": wall,
          "fit_wall_s": res.wall_time_s, "launches": launches,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting, "f32_f_full": f_full_f32,
          "int8_vs_f32_f_full_drift": (f_full - f_full_f32) / f_full_f32})
    check(rel <= 1e-3, f"int8 batched full objectives differ by {rel:.3e}")
    FIT_WALLS["int8_batched"] = res.wall_time_s
    return launches, wall


def two_pass_data(seed: int):
    """The two-pass paths' data set (phases 5c and 5f): a 2,048-component
    mixture of 1,048,576 embeddings 1,024 wide (the d_model of
    src/repro/configs/seamless_m4t_medium.py:10), generated on the card;
    returns (spec, X, seconds to generate)."""
    spec = GMMSpec(m=1 << 20, n=1024, components=2048, seed=seed)
    t0 = time.monotonic()
    X = gmm_dataset(spec, device="cuda")
    torch.cuda.synchronize()
    return spec, X, time.monotonic() - t0


def phase_two_pass_int8(spec, X, gen_s: float, seed: int):
    """An int8 fit outside the fused envelope: a 2,048-entry codebook over
    1,024-wide embeddings (:func:`two_pass_data`), so B8 and C8 carry every
    Lloyd iteration."""
    cfg = BigMeansConfig(k=2048, s=16_384, n_chunks=4, seed=seed,
                         precision="int8")
    check(not fused_step.fits(cfg.k, spec.n), "k = 2048 fits the envelope")

    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="sequential")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(spec.m / EVAL_BATCH)
    fit_checks(res, X, ids, f_full, cfg.k, "int8")
    want = seeded_zeros(launches)
    want.update(assign_int8=res.n_iterations, update_int8=res.n_iterations,
                update=cfg.n_chunks, assign=cfg.n_chunks + n_eval)
    check(launches == want, f"two-pass int8 launches {launches} != {want}")

    t1 = time.monotonic()
    res_ref = fit(X, cfg.replace(impl="ref"), method="sequential")
    torch.cuda.synchronize()
    wall_ref_fit = time.monotonic() - t1
    check(ops.launch_counts() == launches, "the ref fit launched a kernel")
    _, f_full_ref = evaluate(res_ref, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, 1, 1)

    # B8 and C8 against their plain versions at the shape this path gives
    # them (one chunk against the final centroids), then their times
    k, n, s = cfg.k, spec.n, cfg.s
    qx = px.quantize_chunk(X[:s].contiguous())
    c = res.centroids.contiguous()
    ties = near_ties_int8(qx, c)
    n_ties = int(ties.sum())
    errs = {}
    errs["assign_int8"], ids8 = check_assign_int8(qx, c, ties)
    ids_p, _ = distance.assign_int8_plain(qx, c)
    errs["update_int8"] = check_update_int8(qx, ids_p, k)
    two_pass_err = check_fused_int8(qx, c, ids8, n_ties, direct=False)
    cq, t = px.quantize_centroids(c, qx.scale)
    b8 = timing(lambda: distance.launch_assign_int8(qx.q, qx.scale, cq, t,
                                                    c),
                lambda: distance.assign_int8_plain(qx, c), int_mm(qx.q, cq),
                s * n + 5 * k * n + 4 * k + 4 * n + 8 * s, 2 * s * k * n, 20,
                INT8_OP_PER_S, wrapper=lambda: distance.assign_int8(qx, c))
    b8["library"] = int_mm_note(qx.q, cq)
    ids8l, q32 = ids8.long(), qx.q.int()
    c8 = timing(lambda: upd.launch_update_int8(qx.q, ids8, k),
                lambda: upd.update_int8_plain(qx, ids8, k),
                lambda: torch.zeros((k, n), dtype=torch.int32,
                                    device="cuda").index_add_(0, ids8l, q32),
                s * n + 4 * s + 4 * (k * n + k), s * n, 20, INT8_OP_PER_S)
    c8["library"] = ("index_add_ on the int32 codes (sums only; counts "
                     "excluded)")
    xs = X[:s].contiguous()
    c32 = timing(lambda: upd.update_f32(xs, ids8, k),
                 lambda: upd.update_plain(xs, ids8, k),
                 lambda: torch.zeros((k, n), device="cuda").index_add_(
                     0, ids8l, xs),
                 4 * (s * n + s + k * n + k), s * n, 20)
    c32["library"] = "index_add_ (sums only; counts excluded)"
    for row in (b8, c8, c32):
        row.update(m=s, k=k, n=n)
    emit({"phase": "two_pass_int8", "m": spec.m, "n": spec.n, "k": cfg.k,
          "s": cfg.s, "n_chunks": cfg.n_chunks, "data_gen_s": gen_s,
          "fits_envelope": False, "f_best": res.objective, "f_full": f_full,
          "n_accepted": res.n_accepted, "n_iterations": res.n_iterations,
          "wall_s": wall, "fit_wall_s": res.wall_time_s,
          "launches": launches,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations,
                  "fit_wall_s": wall_ref_fit},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting,
          "near_ties": n_ties, "max_abs_err_at_this_shape": {
              **errs, "fused_step_two_pass": two_pass_err},
          "times_at_this_shape": {"assign_int8": b8, "update_int8": c8,
                                  "update_f32": c32},
          "int8_kernels_s_estimate": res.n_iterations
          * (b8["ms"] + c8["ms"]) / 1e3})
    check(rel <= 1e-3, f"two-pass int8 full objectives differ by {rel:.3e}")
    return launches, wall, errs, {"assign_int8": b8, "update_int8": c8,
                                  "update_f32": c32}


# --------------------------------------------------------------------------
# phases 4c, 4d, 5d, 5e, 5f: the bf16 and bf16x3 paths at full size
# --------------------------------------------------------------------------


def epilogue_launches(prec: str, n_chunks: int, n_eval: int) -> dict:
    """Launches of the Lloyd epilogue (one per chunk) and of ``evaluate``
    under a float policy: the final assignment runs f32 kernel B under
    bf16 (on the widened bf16 view) and B3 under bf16x3; the final counts
    run C16 / C3; ``evaluate`` runs f32 kernel B."""
    if prec == "bf16":
        return {"assign": n_chunks + n_eval, "update_bf16": n_chunks}
    return {"assign": n_eval, f"assign_{prec}": n_chunks,
            f"update_{prec}": n_chunks}


def phase_main_16(X, seed: int, prec: str, f_full_f32: float):
    """Phase 4's sequential fit under ``precision=prec`` (A16 / A3)."""
    m, n = X.shape
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed,
                         precision=prec)
    for impl in ("cuda", "ref"):        # warm both paths (first-use costs)
        fit(X, cfg.replace(n_chunks=2, impl=impl, seed=seed + 1))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="auto")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(m / EVAL_BATCH)
    check(res.strategy == "sequential", f"auto resolved to {res.strategy}")
    fit_checks(res, X, ids, f_full, cfg.k, prec)
    want = seeded_zeros(launches)
    want[f"fused_step_{prec}"] = res.n_iterations
    want.update(epilogue_launches(prec, cfg.n_chunks, n_eval))
    check(launches == want, f"{prec} sequential launches {launches} != "
          f"{want}")

    res_ref = fit(X, cfg.replace(impl="ref"), method="auto")
    check(ops.launch_counts() == launches, "the ref fit launched a kernel")
    _, f_full_ref = evaluate(res_ref, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, 1, 1)
    drift = (f_full - f_full_f32) / f_full_f32
    row = {}
    if prec == "bf16":
        # 'auto' on a bf16 tensor is this fit, bit for bit
        Xb = X.bfloat16()
        auto = fit(Xb, cfg.replace(precision="auto"))
        check(auto.extras["fit"]["precision"] == "bf16",
              f"'auto' on bf16 data ran {auto.extras['fit']['precision']}")
        check(torch.equal(auto.centroids, res.centroids)
              and auto.trace == res.trace,
              "'auto' on a bf16 tensor differs from precision='bf16'")
        row["auto_on_bf16_tensor_bitwise_equal"] = True
        del Xb
    walls = {"f32": [], prec: []}       # cuda fit walls, in turns
    for p in ("f32", prec, prec, "f32"):
        walls[p].append(fit(X, cfg.replace(precision=p)).wall_time_s)
    emit({"phase": f"main_path_{prec}", "m": m, "n": n, "k": cfg.k,
          "s": cfg.s, "n_chunks": cfg.n_chunks, "strategy": res.strategy,
          "f_best": res.objective, "f_full": f_full,
          "f_full_per_point": f_full / m, "n_accepted": res.n_accepted,
          "n_iterations": res.n_iterations, "wall_s": wall,
          "fit_wall_s": res.wall_time_s, "launches": launches,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting, "f32_f_full": f_full_f32,
          f"{prec}_vs_f32_f_full_drift": drift,
          "fit_walls_s_in_turns": walls, **row})
    check(rel <= 1e-3, f"{prec} full objectives differ by {rel:.3e} (> 1e-3)")
    check(abs(drift) <= 1e-2, f"{prec} full objective drifts {drift:.3e} "
          "from f32's (> 1 %)")
    FIT_WALLS[f"{prec}_sequential"] = res.wall_time_s
    return launches, wall


def phase_batched_16(X, seed: int, prec: str, f_full_f32: float):
    """Phase 5's batched fit under ``precision=prec`` (D16 / D3)."""
    m, n = X.shape
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, batch=BATCH,
                         sync_every=SYNC_EVERY, seed=seed, precision=prec)
    for impl in ("cuda", "ref"):        # warm both paths (first-use costs)
        fit(X, cfg.replace(n_chunks=2 * BATCH, impl=impl, seed=seed + 1))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="auto")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(m / EVAL_BATCH)
    rounds = cfg.n_chunks // BATCH
    check(res.strategy == "batched", f"auto resolved to {res.strategy}")
    fit_checks(res, X, ids, f_full, cfg.k, prec)
    ops.reset_launch_counts()           # replay for per-chunk iterations
    state, infos = big_means_batched(
        X, rnd.TORCH.key(seed), k=cfg.k, s=cfg.s, batch=BATCH,
        rounds=rounds, sync_every=SYNC_EVERY, precision=prec)
    check(torch.equal(state.centroids, res.centroids)
          and float(state.f_best) == res.objective,
          f"the core replay of the {prec} batched fit differs from it")
    iters = infos.lloyd_iters.view(rounds, BATCH)
    slowest = int(iters.max(dim=1).values.sum())
    want = seeded_zeros(launches)
    want[f"fused_step_batched_{prec}"] = slowest
    want.update(epilogue_launches(prec, cfg.n_chunks, n_eval))
    check(launches == want, f"{prec} batched launches {launches} != {want}")

    res_ref = fit(X, cfg.replace(impl="ref"), method="auto")
    _, f_full_ref = evaluate(res_ref, X, impl="ref")
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, BATCH, SYNC_EVERY)
    drift = (f_full - f_full_f32) / f_full_f32
    emit({"phase": f"main_path_batched_{prec}", "m": m, "n": n, "k": cfg.k,
          "s": cfg.s, "n_chunks": cfg.n_chunks, "batch": BATCH,
          "sync_every": SYNC_EVERY, "rounds": rounds,
          "f_best": res.objective, "f_full": f_full,
          "n_accepted": res.n_accepted, "n_iterations": res.n_iterations,
          "iterations_per_chunk": iters.flatten().tolist(),
          "slowest_stream_iterations_sum": slowest, "wall_s": wall,
          "fit_wall_s": res.wall_time_s, "launches": launches,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting, "f32_f_full": f_full_f32,
          f"{prec}_vs_f32_f_full_drift": drift})
    check(rel <= 1e-3, f"{prec} batched full objectives differ by {rel:.3e}")
    check(abs(drift) <= 1e-2, f"{prec} batched full objective drifts "
          f"{drift:.3e} from f32's (> 1 %)")
    FIT_WALLS[f"{prec}_batched"] = res.wall_time_s
    return launches, wall


def phase_two_pass_16(X, seed: int):
    """Phase 5c's fit at ``precision="bf16"``: k = 2,048, n = 1,024 lies
    outside the fused envelope, so B16 and C16 carry every Lloyd
    iteration (the epilogue runs f32 B and C16)."""
    m, n = X.shape
    cfg = BigMeansConfig(k=2048, s=16_384, n_chunks=4, seed=seed,
                         precision="bf16")
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg, method="sequential")
    ids, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()

    n_eval = math.ceil(m / EVAL_BATCH)
    fit_checks(res, X, ids, f_full, cfg.k, "bf16")
    want = seeded_zeros(launches)
    want.update(assign_bf16=res.n_iterations,
                update_bf16=res.n_iterations + cfg.n_chunks,
                assign=cfg.n_chunks + n_eval)
    check(launches == want, f"two-pass bf16 launches {launches} != {want}")

    t1 = time.monotonic()
    res_ref = fit(X, cfg.replace(impl="ref"), method="sequential")
    torch.cuda.synchronize()
    wall_ref_fit = time.monotonic() - t1
    check(ops.launch_counts() == launches, "the ref fit launched a kernel")
    _, f_full_ref = evaluate(res_ref, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = check_accepts(res.trace, res_ref.trace, 1, 1)

    # B16 and C16 against their plain versions at the shape this path
    # gives them (one bf16 chunk against the final centroids), then times
    k, s = cfg.k, cfg.s
    xb = X[:s].bfloat16()
    c = res.centroids.contiguous()
    ties = near_ties_16(xb, c, "bf16")
    n_ties = int(ties.sum())
    errs = {}
    errs["assign_bf16"], ids16 = check_assign_16(xb, c, ties, "bf16")
    ids_p, _ = distance.assign_plain(xb, c, "bf16")
    errs["update_bf16"] = check_update_16(xb, ids_p, k, "bf16")
    two_pass_err = check_fused_16(xb, c, n_ties, "bf16", direct=False)
    cb16 = c.bfloat16()
    b16 = timing(lambda: distance.assign_16(xb, c, "bf16"),
                 lambda: distance.assign_plain(xb, c, "bf16"),
                 lambda: torch.mm(xb, cb16.t()),
                 2 * s * n + 4 * (k * n + k) + 8 * s, 2 * s * k * n, 20,
                 BF16_FLOP_PER_S)
    b16["library"] = MM_BF16
    ids16l, xbf = ids16.long(), xb.float()
    c16 = timing(lambda: upd.update_16(xb, ids16, k, "bf16"),
                 lambda: upd.update_plain(xb, ids16, k, "bf16"),
                 lambda: torch.zeros((k, n), device="cuda").index_add_(
                     0, ids16l, xbf),
                 2 * s * n + 4 * s + 4 * (k * n + k), s * n, 20,
                 BF16_FLOP_PER_S)
    c16["library"] = ("index_add_ on the bf16 values widened to f32 "
                      "(sums only; counts excluded)")
    x32 = X[:s].contiguous()             # kernel B beside B16 there
    # kernel C3 at this shape (no fit here drives it): its checks, then
    # its time
    errs["update_bf16x3"] = check_update_16(x32, ids_p, k, "bf16x3")
    c3 = timing(lambda: upd.update_16(x32, ids16, k, "bf16x3"),
                lambda: upd.update_plain(x32, ids16, k, "bf16x3"),
                lambda: torch.zeros((k, n), device="cuda").index_add_(
                    0, ids16l, x32),
                4 * (s * n + s + k * n + k), 2 * s * n, 20, BF16_FLOP_PER_S)
    c3["library"] = ("index_add_ on x (f32 sums, not hi + lo; sums only, "
                     "counts excluded)")
    for row in (c16, c3):
        row.update(m=s, k=k, n=n)
    # kernel B (f32) and B3 (bf16x3) at this shape, and B at one evaluate
    # batch of this data: their checks, then their times
    errs["assign_f32"] = check_assign(x32, c, near_ties(x32, c))
    b32 = timing(lambda: distance.assign_f32(x32, c),
                 lambda: distance.assign_plain(x32, c),
                 lambda: torch.mm(x32, c.t()),
                 4 * (s * n + k * n) + 8 * s, 2 * s * k * n, 20)
    b32["library"] = MM_F32
    errs["assign_bf16x3"], _ = check_assign_16(
        x32, c, near_ties_16(x32, c, "bf16x3"), "bf16x3")
    b3 = timing(lambda: distance.assign_16(x32, c, "bf16x3"),
                lambda: distance.assign_plain(x32, c, "bf16x3"), None,
                4 * (s * n + k * n + k) + 8 * s, 3 * 2 * s * k * n, 20,
                BF16_FLOP_PER_S)
    b3["library"] = ("none: no single PyTorch call computes the three bf16 "
                     "products")
    for row in (b16, b32, b3):
        row.update(m=s, k=k, n=n)
    xe = X[:EVAL_BATCH].contiguous()
    me = xe.shape[0]
    errs["assign_f32_evaluate_batch"] = check_assign(xe, c, near_ties(xe, c))
    be = timing(lambda: distance.assign_f32(xe, c),
                lambda: distance.assign_plain(xe, c),
                lambda: torch.mm(xe, c.t()),
                4 * (me * n + k * n) + 8 * me, 2 * me * k * n, 3)
    be.update(m=me, k=k, n=n, library=MM_F32)
    del xe
    emit({"phase": "two_pass_bf16", "m": m, "n": n, "k": cfg.k, "s": cfg.s,
          "n_chunks": cfg.n_chunks, "fits_envelope": False,
          "f_best": res.objective, "f_full": f_full,
          "n_accepted": res.n_accepted, "n_iterations": res.n_iterations,
          "wall_s": wall, "fit_wall_s": res.wall_time_s,
          "launches": launches,
          "ref": {"f_best": res_ref.objective, "f_full": f_full_ref,
                  "n_accepted": res_ref.n_accepted,
                  "n_iterations": res_ref.n_iterations,
                  "fit_wall_s": wall_ref_fit},
          "f_full_rel_diff": rel,
          "accepts_cuda": [int(a) for _, _, a in res.trace],
          "accepts_ref": [int(a) for _, _, a in res_ref.trace],
          "first_parting": parting,
          "near_ties": n_ties, "max_abs_err_at_this_shape": {
              **errs, "fused_step_two_pass": two_pass_err},
          "times_at_this_shape": {"assign_bf16": b16, "update_bf16": c16,
                                  "update_bf16x3": c3, "assign_f32": b32,
                                  "assign_bf16x3": b3,
                                  "assign_f32_evaluate_batch": be},
          "bf16_kernels_s_estimate": (res.n_iterations * b16["ms"]
                                      + (res.n_iterations + cfg.n_chunks)
                                      * c16["ms"]) / 1e3})
    check(rel <= 1e-3, f"two-pass bf16 full objectives differ by {rel:.3e}")
    return launches, wall, errs, {"assign_bf16": b16, "assign_f32": b32,
                                  "update_bf16": c16, "update_bf16x3": c3,
                                  "assign_bf16x3": b3}, be


# --------------------------------------------------------------------------
# phase 4e: the autotuned path at HEPMASS size
# --------------------------------------------------------------------------


def same_fit(res, f_full, want, f_want, what: str) -> None:
    """Bitwise the same run: accepts and every f_new of the trace,
    iterations, centroids and the full-data objective."""
    check(res.trace == want.trace, f"{what}: the trace differs")
    check(res.n_iterations == want.n_iterations, f"{what}: iterations")
    check(torch.equal(res.centroids, want.centroids),
          f"{what}: the centroids differ")
    check(f_full == f_want, f"{what}: full objective {f_full} != {f_want}")


def phase_autotuned(X, seed: int, seq, batched) -> dict:
    """Phase 4e.  (a) ``fit(autotune=True)`` under each policy, sequential
    and ``batch=8, sync_every=2``, tuning into a cache file under build/:
    every candidate's time and the winners printed, each result bitwise
    the untuned fit's (under f32 those of phases 4 and 5, ``seq`` and
    ``batched``: (result, full-data objective); under the other policies
    the same fits rerun untuned, with no cache).  (b) With tuning off, a
    cache file pinning ``{"pipeline": "dma"}`` for the fit's fused key:
    the sequential fit under each policy launches the policy's dma kernel
    once per Lloyd iteration (and its blocks twin never), bitwise the
    untuned fit.  (c) With tuning off, the committed profile (``PROFILE``)
    pinned: every fit of (a) bitwise the untuned one, the profile loaded
    with no anomaly, its winners printed.  Returns (b)'s paths: {name:
    (launches, wall)}."""
    m, n = X.shape
    base = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed)
    runs = {(prec, name): base.replace(precision=prec, **extra)
            for prec in POLICIES
            for name, extra in (("sequential", {}),
                                ("batched", dict(batch=BATCH,
                                                 sync_every=SYNC_EVERY)))}
    untuned = {("f32", "sequential"): seq, ("f32", "batched"): batched}
    autotune.clear()
    autotune.set_cache_path(None)
    for run, cfg in runs.items():
        if run not in untuned:
            want = fit(X, cfg)
            untuned[run] = (want, evaluate(want, X)[1])

    cache = ROOT / "build" / "autotune_smoke.json"
    cache.unlink(missing_ok=True)
    autotune.set_cache_path(cache)
    for (prec, name), cfg in runs.items():
        n_timed = len(autotune.timings())
        t0 = time.monotonic()
        res = fit(X, cfg, autotune=True)
        torch.cuda.synchronize()
        call_s = time.monotonic() - t0
        _, f_full = evaluate(res, X)
        check(not autotune.enabled(), "fit left tuning enabled")
        check(res.extras["fit"]["autotune"], "fit did not report autotune")
        same_fit(res, f_full, *untuned[prec, name],
                 f"autotuned {prec} {name} fit")
        timed = autotune.timings()[n_timed:]
        if name == "sequential":
            check({cand["pipeline"] for key, cand, _ in timed
                   if key.startswith("fused|")} == {"blocks", "dma"},
                  f"the tuner did not time both pipelines at {prec}")
        emit({"phase": "autotuned", "precision": prec, "run": name,
              "n_iterations": res.n_iterations,
              "fit_wall_s": res.wall_time_s,
              "fit_call_with_pretune_s": call_s, "f_full": f_full,
              "bitwise_equal_to_untuned": True,
              "candidates": [{"key": key, "candidate": cand,
                              "us": 1e6 * sec} for key, cand, sec in timed]})
    winners = json.loads(cache.read_text())
    check(winners["version"] == 1, "cache schema")
    emit({"phase": "autotuned", "cache": str(cache.relative_to(ROOT)),
          "winners": winners["entries"]})

    pin = ROOT / "build" / "autotune_pin.json"
    backend = ops.tune_backend(X.device)
    pin.write_text(json.dumps({"version": 1, "entries": {
        autotune.cache_key("fused", backend=backend, b=1, m=base.s, k=base.k,
                           n=n, precision=prec): {"pipeline": "dma"}
        for prec in POLICIES}}))
    autotune.clear()
    autotune.set_cache_path(pin)
    paths = {}
    for prec in POLICIES:
        cfg = runs[prec, "sequential"]
        ops.reset_launch_counts()
        t0 = time.monotonic()
        res = fit(X, cfg)
        ids, f_full = evaluate(res, X)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = ops.launch_counts()
        dma = COUNTS[f"fused_step_dma_{prec}"]
        blocks = COUNTS[f"fused_step_{prec}"]
        check(launches[dma] == res.n_iterations,
              f"{dma} launches {launches[dma]} != iterations "
              f"{res.n_iterations}")
        check(launches[blocks] == 0, f"{blocks} launched under the pin")
        fit_checks(res, X, ids, f_full, cfg.k, prec)
        same_fit(res, f_full, *untuned[prec, "sequential"],
                 f"dma-pinned {prec} fit")
        emit({"phase": "autotuned_pinned_dma", "precision": prec,
              "cache": str(pin.relative_to(ROOT)), "n_iterations":
              res.n_iterations, "launches": launches, "wall_s": wall,
              "fit_wall_s": res.wall_time_s, "f_full": f_full,
              "bitwise_equal_to_untuned": True})
        paths[f"dma_{prec}_sequential"] = (launches, wall)

    # (c) the committed H100 profile, tuning off: every fit bitwise the
    # untuned one, no load anomaly, the winners printed
    autotune.clear()
    autotune.set_cache_path(PROFILE)
    n_events = len(autotune.events())
    entries = json.loads(PROFILE.read_text())["entries"]
    check(entries and all(key.split("|")[1] == backend for key in entries),
          f"4e: the profile's keys name another backend than {backend}")
    for (prec, name), cfg in runs.items():
        res = fit(X, cfg)
        _, f_full = evaluate(res, X)
        same_fit(res, f_full, *untuned[prec, name],
                 f"profile-pinned {prec} {name} fit")
    check(autotune.events()[n_events:] == [], "4e: the profile did not load "
          f"cleanly: {autotune.events()[n_events:]}")
    emit({"phase": "autotuned_profile",
          "profile": str(PROFILE.relative_to(ROOT)), "winners": entries,
          "fits_bitwise_untuned": True})
    autotune.clear()
    autotune.set_cache_path(None)
    return paths


# --------------------------------------------------------------------------
# phase 6: times
# --------------------------------------------------------------------------


def eager_ms(fn, launches: int) -> float:
    """Time per call of ``launches`` eager back-to-back calls (warm), by
    CUDA events: the host's launch cost shows when it exceeds the kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def device_ms(fn, launches: int, replays: int = 5,
              free_cache: bool = False) -> float:
    """Device time per call: CUDA events around replays of a CUDA graph
    holding ``launches`` back-to-back calls (warm); ``free_cache``: return
    the warm-up call's cached blocks before the capture, so that the
    graph's pool starts from free memory (phase 11's [10.5M, 251] plain
    versions)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if free_cache:
        torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (launches * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, flops: float, peak: float = F32_FLOP_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing(fn, plain, library, nbytes, flops, launches,
           peak: float = F32_FLOP_PER_S, wrapper=None,
           free_cache: bool = False):
    """Device ms of ``fn`` (the kernel's launch), its plain version and a
    library call, beside the bound; ``wrapper``: the whole wrapper call
    where it does more than launch (the int8 centroid quantization);
    ``free_cache``: as :func:`device_ms`'s."""
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {"ms": device_ms(fn, launches, free_cache=free_cache),
           "eager_ms": eager_ms(fn, launches),
           "plain_ms": device_ms(plain, launches, free_cache=free_cache),
           "library_ms": None if library is None
           else device_ms(library, launches, free_cache=free_cache),
           "bound_ms": b_ms, "bound_us": 1e3 * b_ms, "bound_by": b_by,
           "bytes": nbytes, "flops": flops,
           "peak_ops_per_s": peak}
    if wrapper is not None:
        row["wrapper_ms"] = device_ms(wrapper, launches)
        row["wrapper_eager_ms"] = eager_ms(wrapper, launches)
    return row


MM_F32 = "torch.mm f32, TF32 off (the dots only)"
MM_BF16 = "torch.mm on the bf16 operands (the dots only)"


def int_mm(q, cq):
    """The dots-only library call of B8, ``torch._int_mm`` on the codes,
    where it takes the shapes (widths multiples of 8), else None."""
    if q.shape[1] % 8 or cq.shape[0] % 8:
        return None
    return lambda: torch._int_mm(q, cq.t())


def int_mm_note(q, cq) -> str:
    return ("torch._int_mm on the codes (the int32 dots only)"
            if int_mm(q, cq) is not None else
            "none: torch._int_mm takes widths in multiples of 8 only "
            f"(n = {q.shape[1]}, k = {cq.shape[0]})")


def phase_times(X, res, seed: int) -> dict:
    s, k, n = 64_000, res.centroids.shape[0], X.shape[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = X[torch.randint(0, X.shape[0], (s,), generator=gen,
                        device="cuda")].contiguous()
    c = res.centroids.contiguous()
    ids, _ = distance.assign_plain(x, c)
    ids64 = ids.long()
    out = {}
    out["fused_step_f32"] = timing(
        lambda: fused_step.fused_step_f32(x, c),
        lambda: fused_step.fused_step_plain(x, c), None,
        4 * (s * n + k * n + k * n + k + 1), 2 * s * k * n + s * n, 200)
    out["assign_f32"] = timing(
        lambda: distance.assign_f32(x, c),
        lambda: distance.assign_plain(x, c), lambda: torch.mm(x, c.t()),
        4 * (s * n + k * n + 2 * s), 2 * s * k * n, 200)
    out["update_f32"] = timing(
        lambda: upd.update_f32(x, ids, k),
        lambda: upd.update_plain(x, ids, k),
        lambda: torch.zeros((k, n), device="cuda").index_add_(0, ids64, x),
        4 * (s * n + s + k * n + k), s * n, 200)
    m = X.shape[0]
    out["assign_f32"]["at_evaluate"] = timing(
        lambda: distance.assign_f32(X, c),
        lambda: distance.assign_plain(X, c), lambda: torch.mm(X, c.t()),
        4 * (m * n + k * n + 2 * m), 2 * m * k * n, 3)
    out["assign_f32"]["at_evaluate"]["m"] = m
    out["assign_f32"]["library"] = MM_F32
    out["update_f32"]["library"] = "index_add_ (sums only; counts excluded)"
    # kernel D on BATCH chunks against the shared incumbent (every stream
    # starts a round from it after a sync), beside BATCH launches of A
    xb = X[torch.randint(0, X.shape[0], (BATCH, s), generator=gen,
                         device="cuda")].contiguous()
    cb = c.expand(BATCH, k, n).contiguous()
    out["fused_step_batched_f32"] = timing(
        lambda: fused_step.fused_step_batched_f32(xb, cb),
        lambda: fused_step.fused_step_batched_plain(xb, cb), None,
        4 * BATCH * (s * n + k * n + k * n + k + 1),
        BATCH * (2 * s * k * n + s * n), 100)
    out["fused_step_batched_f32"]["batch"] = BATCH
    out["fused_step_batched_f32"]["kernel_a_x_batch_ms"] = device_ms(
        lambda: [fused_step.fused_step_f32(xb[b], cb[b])
                 for b in range(BATCH)], 25)

    # int8: ``ms`` is the kernel's launch on prepared operands; the
    # wrapper adds the centroid quantization and the int32 -> f32 scaling
    qx = px.quantize_chunk(x)
    q, scale = qx
    cq, t = px.quantize_centroids(c, scale)
    ids8, _ = distance.assign_int8_plain(qx, c)
    q32 = q.int()
    ops8 = 2 * s * k * n
    out["fused_step_int8"] = timing(
        lambda: fused_step.launch_fused_step_int8(q, scale, cq, t, c),
        lambda: fused_step.fused_step_int8_plain(qx, c), None,
        s * n + 5 * k * n + 4 * k + 4 * n + 4 * (k * n + k + 1), ops8 + s * n,
        200, INT8_OP_PER_S,
        wrapper=lambda: fused_step.fused_step_int8(qx, c))
    out["assign_int8"] = timing(
        lambda: distance.launch_assign_int8(q, scale, cq, t, c),
        lambda: distance.assign_int8_plain(qx, c), int_mm(q, cq),
        s * n + 5 * k * n + 4 * k + 4 * n + 8 * s, ops8, 200, INT8_OP_PER_S,
        wrapper=lambda: distance.assign_int8(qx, c))
    out["assign_int8"]["library"] = int_mm_note(q, cq)
    out["update_int8"] = timing(
        lambda: upd.launch_update_int8(q, ids8, k),
        lambda: upd.update_int8_plain(qx, ids8, k),
        lambda: torch.zeros((k, n), dtype=torch.int32,
                            device="cuda").index_add_(0, ids8.long(), q32),
        s * n + 4 * s + 4 * (k * n + k), s * n, 200, INT8_OP_PER_S,
        wrapper=lambda: upd.update_int8(qx, ids8, k))
    out["update_int8"]["library"] = ("index_add_ on the int32 codes (sums "
                                     "only; counts excluded)")
    qxb = px.quantize_chunk(xb)                 # one scale row per stream
    cqb, tb = px.quantize_centroids(cb, qxb.scale)
    out["fused_step_batched_int8"] = timing(
        lambda: fused_step.launch_fused_step_batched_int8(
            qxb.q, qxb.scale, cqb, tb, cb),
        lambda: fused_step.fused_step_batched_int8_plain(qxb, cb), None,
        BATCH * (s * n + 5 * k * n + 4 * k + 4 * n + 4 * (k * n + k + 1)),
        BATCH * (ops8 + s * n), 100, INT8_OP_PER_S,
        wrapper=lambda: fused_step.fused_step_batched_int8(qxb, cb))
    out["fused_step_batched_int8"]["batch"] = BATCH
    out["fused_step_batched_int8"]["kernel_a8_x_batch_ms"] = device_ms(
        lambda: [fused_step.launch_fused_step_int8(
            qxb.q[b], qxb.scale[b], cqb[b], tb[b], cb[b])
            for b in range(BATCH)], 25)

    # bf16 / bf16x3: each wrapper on the chunk in its storage, as the Lloyd
    # loop passes it, so ``ms`` is the norms' launch, the kernel and the
    # reduce
    for prec in POLICIES16:
        out.update(times_16(prec, x, c, xb, cb))

    # A and A8 at the fused envelope's edge, where the scores dominate
    me, ke, ne = 64_000, 1024, 1024
    xe, ce = separated(me, ke, ne, seed)
    qe = px.quantize_chunk(xe)
    cqe, te = px.quantize_centroids(ce, qe.scale)
    edge_ops = 2 * me * ke * ne + me * ne
    out["fused_step_f32"]["at_envelope_edge"] = timing(
        lambda: fused_step.fused_step_f32(xe, ce),
        lambda: fused_step.fused_step_plain(xe, ce), None,
        4 * (me * ne + 2 * ke * ne + ke + 1), edge_ops, 3)
    out["fused_step_int8"]["at_envelope_edge"] = timing(
        lambda: fused_step.launch_fused_step_int8(qe.q, qe.scale, cqe, te,
                                                  ce),
        lambda: fused_step.fused_step_int8_plain(qe, ce), None,
        me * ne + 5 * ke * ne + 4 * ke + 4 * ne + 4 * (ke * ne + ke + 1),
        edge_ops, 3, INT8_OP_PER_S)
    for prec in POLICIES16:              # A16 and A3 there too
        xse = px.cast_storage(xe, prec)
        mult = 1 if prec == "bf16" else 3
        out[f"fused_step_{prec}"]["at_envelope_edge"] = timing(
            lambda: fused_step.fused_step_16(xse, ce, prec),
            lambda: fused_step.fused_step_plain(xse, ce, prec), None,
            xse.element_size() * me * ne + 4 * (2 * ke * ne + ke + 1),
            mult * 2 * me * ke * ne + me * ne, 3, BF16_FLOP_PER_S)
        del xse
    for name in ("fused_step_f32", "fused_step_int8", "fused_step_bf16",
                 "fused_step_bf16x3"):
        out[name]["at_envelope_edge"].update(m=me, k=ke, n=ne)
    out.update(times_dma(x, c, xe, ce))
    del xe, ce, qe, cqe

    # kernel P at the seeding shape: the chunk, three candidates drawn
    # from it, the distances to a first seed
    cands, d = seeding_probe(x, seed)
    L = cands.shape[0]
    out["kpp_probe"] = timing(
        lambda: kpp.kpp_probe_cuda(x, cands, d),
        lambda: kpp.kpp_probe_plain(x, cands, d), None,
        *kpp_cost(s, n, L), 200)
    out["kpp_probe"].update(L=L, library="none (no single call computes it)")
    # and at the two-pass width (16,384 x 1,024: the two-pass data's chunk
    # seeding)
    m2, n2 = 16_384, 1024
    x2, _ = separated(m2, 2048, n2, seed)
    cands2, d2 = seeding_probe(x2, seed)
    out["kpp_probe"]["at_two_pass_width"] = timing(
        lambda: kpp.kpp_probe_cuda(x2, cands2, d2),
        lambda: kpp.kpp_probe_plain(x2, cands2, d2), None,
        *kpp_cost(m2, n2, L), 50)
    out["kpp_probe"]["at_two_pass_width"].update(m=m2, n=n2, L=L)
    del x2, cands2, d2
    for name, row in out.items():
        emit({"phase": "times", "kernel": name, "m": s, "k": k, "n": n,
              **row})
    return out


def kpp_cost(m: int, n: int, L: int) -> tuple:
    """(bytes, operations) of kernel P: x, d and the candidates read once,
    newd and pot written once; the L dots, ||x||^2 and ||c||^2 as FMAs."""
    return (4 * (m * n + m + L * n + m * L + L),
            2 * m * L * n + 2 * m * n + 2 * L * n)


def fused_cost(prec: str, m: int, k: int, n: int) -> tuple:
    """(bytes, operations, peak) of one fused step at ``prec``, as phase
    6's rows of kernels A, A8, A16 and A3 count them."""
    if prec == "f32":
        return (4 * (m * n + 2 * k * n + k + 1), 2 * m * k * n + m * n,
                F32_FLOP_PER_S)
    if prec == "int8":
        return (m * n + 5 * k * n + 4 * k + 4 * n + 4 * (k * n + k + 1),
                2 * m * k * n + m * n, INT8_OP_PER_S)
    eb, mult = (2, 1) if prec == "bf16" else (4, 3)
    adds = (1 if prec == "bf16" else 2) * m * n
    return (eb * m * n + 4 * (2 * k * n + k + 1),
            mult * 2 * m * k * n + adds, BF16_FLOP_PER_S)


def times_dma(x, c, xe, ce) -> dict:
    """Phase 6's rows of the four dma entry points: at the main path's
    shape (x [s,n], c [k,n]) and at the fused envelope's edge (xe, ce:
    k = n = 1,024), each timed with its blocks twin in turns (twin, dma,
    dma, twin) by graph replay.  int8: ``ms`` is the kernel's launch on
    prepared operands, ``wrapper_ms`` the whole wrapper, as for A8."""
    out = {}
    for prec in POLICIES:
        row = {}
        for where, xx, cc, launches in (("main", x, c, 200),
                                        ("edge", xe, ce, 3)):
            m, n = xx.shape
            k = cc.shape[0]
            if prec == "int8":
                qx = px.quantize_chunk(xx)
                cq, t = px.quantize_centroids(cc, qx.scale)
                run = {pipe: (lambda pipe=pipe: fused_step.
                              launch_fused_step_int8(qx.q, qx.scale, cq, t,
                                                     cc, pipe))
                       for pipe in fused_step.PIPELINES}
                plain = lambda: fused_step.fused_step_int8_plain(qx, cc)
                wrapper = lambda: fused_step.fused_step_int8(qx, cc, "dma")
            else:
                xs = px.cast_storage(xx, prec)
                fn = fused_entry(prec)
                run = {pipe: (lambda pipe=pipe: fn(xs, cc, pipe))
                       for pipe in fused_step.PIPELINES}
                plain = lambda: fused_step.fused_step_plain(xs, cc, prec)
                wrapper = None
            nbytes, flops, peak = fused_cost(prec, m, k, n)
            r = timing(run["dma"], plain, None, nbytes, flops, launches,
                       peak, wrapper=wrapper)
            turns = {"blocks": [], "dma": []}
            for pipe in ("blocks", "dma", "dma", "blocks"):
                turns[pipe].append(device_ms(run[pipe], launches))
            r.update(m=m, k=k, n=n, ms_in_turns=turns,
                     dma_over_blocks=sum(turns["dma"]) / sum(turns["blocks"]),
                     library="none (no single call computes it)")
            if where == "main":
                row.update(r)
            else:
                row["at_envelope_edge"] = r
        out[f"fused_step_dma_{prec}"] = row
    return out


def times_16(prec: str, x, c, xb, cb) -> dict:
    """Phase 6's rows of the four ``prec`` entry points at the main path's
    shapes: x [s,n] and xb [BATCH,s,n] f32 chunks, c [k,n] and cb [BATCH,
    k,n] centroids.  Bounds: x read once at its storage width (2 bytes
    under bf16), the centroids and outputs at 4; the policy's bf16
    products (three per product under bf16x3) over the bf16 tensor-core
    peak."""
    s, n = x.shape
    k = c.shape[0]
    xs, xbs = px.cast_storage(x, prec), px.cast_storage(xb, prec)
    eb = xs.element_size()
    mult = 1 if prec == "bf16" else 3        # bf16 products per product
    adds = (1 if prec == "bf16" else 2) * s * n  # one-hot sums (hi + lo)
    ids, _ = distance.assign_plain(xs, c, prec)
    out = {}
    out[f"fused_step_{prec}"] = timing(
        lambda: fused_step.fused_step_16(xs, c, prec),
        lambda: fused_step.fused_step_plain(xs, c, prec), None,
        eb * s * n + 4 * (2 * k * n + k + 1), mult * 2 * s * k * n + adds,
        200, BF16_FLOP_PER_S)
    cb16 = c.bfloat16()
    out[f"assign_{prec}"] = timing(
        lambda: distance.assign_16(xs, c, prec),
        lambda: distance.assign_plain(xs, c, prec),
        (lambda: torch.mm(xs, cb16.t())) if prec == "bf16" else None,
        eb * s * n + 4 * (k * n + k) + 8 * s, mult * 2 * s * k * n, 200,
        BF16_FLOP_PER_S)
    ids64, xsf = ids.long(), xs.float()
    out[f"update_{prec}"] = timing(
        lambda: upd.update_16(xs, ids, k, prec),
        lambda: upd.update_plain(xs, ids, k, prec),
        lambda: torch.zeros((k, n), device="cuda").index_add_(0, ids64, xsf),
        eb * s * n + 4 * s + 4 * (k * n + k), adds, 200, BF16_FLOP_PER_S)
    name = f"fused_step_batched_{prec}"
    out[name] = timing(
        lambda: fused_step.fused_step_batched_16(xbs, cb, prec),
        lambda: fused_step.fused_step_batched_plain(xbs, cb, prec), None,
        BATCH * (eb * s * n + 4 * (2 * k * n + k + 1)),
        BATCH * (mult * 2 * s * k * n + adds), 100, BF16_FLOP_PER_S)
    out[name]["batch"] = BATCH
    out[name]["single_x_batch_ms"] = device_ms(
        lambda: [fused_step.fused_step_16(xbs[b], cb[b], prec)
                 for b in range(BATCH)], 25)
    for row in out.values():
        row["library"] = "none (no single call computes it)"
    if prec == "bf16":
        out["assign_bf16"]["library"] = MM_BF16
    out[f"update_{prec}"]["library"] = (
        "index_add_ on the bf16 values widened to f32 (sums only; counts "
        "excluded)" if prec == "bf16" else
        "index_add_ on x (f32 sums, not hi + lo; sums only, counts excluded)")
    return out


def device_share(path: str, times: dict, launches: dict, n_eval: int,
                 wall: float):
    """Kernel device seconds of a main path's run at the main shapes,
    estimated as launches times graph-replay ms (the evaluate batches at
    their own size; the int8 kernels with their wrappers' centroid
    quantization)."""
    ev = times["assign_f32"]["at_evaluate"]
    per_batch = ev["ms"] * EVAL_BATCH / ev["m"]
    s = (n_eval * per_batch
         + (launches["assign"] - n_eval) * times["assign_f32"]["ms"]
         + sum(launches[COUNTS[name]]
               * times[name].get("wrapper_ms", times[name]["ms"])
               for name in KERNELS if name != "assign_f32")) / 1e3
    emit({"phase": "where_the_time_goes", "path": path,
          "kernel_device_s_estimate": s, "main_path_wall_s": wall,
          "kernel_share_estimate": s / wall})


# --------------------------------------------------------------------------
# phase 7: the streaming strategy at HEPMASS scale, out of core
# --------------------------------------------------------------------------

STREAM_MODES = {"sequential": {},
                "batched": dict(batch=BATCH, sync_every=SYNC_EVERY)}
GPU_SLEEP_CYCLES = 20_000_000   # ~10 ms of one SM's clock a chunk


class Windows(mw.Middleware):
    """Records each window's per-stream f_new, accepts and iterations, its
    VNS rung, chunk size, incumbent and end time, and the run's start and
    final winner size."""

    def __init__(self):
        self.rows = []
        self.ladder = []                # (rung, chunk size, f_best)
        self.times = []
        self.t_start = None
        self.winner_s = None

    def on_start(self, ctx):
        self.t_start = time.monotonic()

    def after_window(self, ctx):
        info = ctx.info
        self.rows.append([t.reshape(-1).tolist() for t in (
            info.f_new, info.accepted, info.lloyd_iters)])
        self.ladder.append((ctx.rung, ctx.last_s,
                            float(torch.min(ctx.state.f_best))))
        self.times.append(time.monotonic())

    def on_finish(self, ctx):
        self.winner_s = ctx.extras.get("winner_s")

    def max_step_s(self) -> float:
        """The longest time from one window (or the start) to the next."""
        ends = [self.t_start, *self.times]
        return max(b - a for a, b in zip(ends, ends[1:]))

    def trace(self):
        """Round-major ``(i, f_new, accepted)`` as a fit's trace."""
        flat = [(f, a) for fs, acc, _ in self.rows for f, a in zip(fs, acc)]
        return [(i, f, bool(a)) for i, (f, a) in enumerate(flat)]

    def fused_launches(self) -> int:
        """Launches of A· (B = 1) or D·: one per iteration of the slowest
        stream of each window."""
        return sum(max(its) for _, _, its in self.rows)


class SlowConsumer(mw.Middleware):
    """Holds the consumer back on each chunk, on the host and on the
    card's compute stream, so the prefetch worker runs ahead."""

    def transform_chunk(self, ctx, cid, chunk):
        time.sleep(0.02)
        torch.cuda._sleep(GPU_SLEEP_CYCLES)
        return chunk


def run_path(path: str, cfg, *extra_middlewares, scheduler=None,
             wrap=None):
    """``fit(path, cfg)``'s run through ``run_stream`` directly, with
    ``extra_middlewares`` after the default stack, the config's scheduler
    (or ``scheduler``) and the memmap provider (wrapped by ``wrap``)."""
    scheduler = scheduler or sched_lib.get_scheduler(cfg.scheduler, cfg)
    fetch = MemmapSource(path).provider(
        scheduler.fetch_s, seed=cfg.seed,
        with_replacement=cfg.with_replacement)
    stack = [*mw.default_stack(cfg), *extra_middlewares]
    return stream.run_stream(wrap(fetch) if wrap else fetch, cfg,
                             n_features=PAPER_DATASETS["hepmass"][1],
                             middlewares=stack, scheduler=scheduler)


def same_state(state, res, what: str) -> None:
    check(torch.equal(state.centroids, res.centroids)
          and float(state.f_best) == res.objective, f"{what} differs")


def same_stream_fit(res, want, what: str) -> None:
    check(torch.equal(res.centroids, want.centroids)
          and res.objective == want.objective and res.trace == want.trace
          and res.n_iterations == want.n_iterations
          and res.n_accepted == want.n_accepted, f"{what} differs")


def stream_launches(prec: str, name: str, fused: int, n_chunks: int,
                    n_eval: int) -> dict:
    """A streaming fit + ``evaluate``'s launches: ``fused`` of the policy's
    A· (sequential) or D· (batched), one epilogue a chunk, ``n_eval``
    evaluate batches."""
    kind = "fused_step" if name == "sequential" else "fused_step_batched"
    want = {COUNTS[f"{kind}_{prec}"]: fused}
    if prec in POLICIES16:
        want.update(epilogue_launches(prec, n_chunks, n_eval))
    else:
        want.update(update=n_chunks, assign=n_chunks + n_eval)
    return want


def mean(xs) -> float | None:
    return sum(xs) / len(xs) if xs else None


def pipeline_row(res) -> dict:
    """Per-chunk means of the prefetch pipeline's times (ms)."""
    p = res.extras["pipeline"]
    return {f"{key}_mean": mean(p[key]) for key in p} | {
        "chunks_staged": len(p["fetch_ms"]),
        "wait_ms_total": sum(p["wait_ms"])}


def device_busy(run) -> dict:
    """Wall, and the union of the card's activity (kernels and copies) by
    ``torch.profiler`` over one ``run()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_events": len(spans),
            "device_idle_share": (1.0 - busy / wall_us) if spans else None}


def host_syncs(run) -> dict:
    """Synchronizing CUDA calls of one ``run()`` by the line that made them
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return {"total": sum(sites.values()), "by_line": dict(sites)}


def write_stream_file(X, seed: int, tmp: Path) -> str:
    """Phase 4's HEPMASS mixture written to ``tmp/hepmass.npy`` by the
    port's ``gmm_memmap``, its rows checked equal to ``X``."""
    m, n = X.shape
    spec = GMMSpec(m=m, n=n, components=25, seed=seed)
    path = str(tmp / "hepmass.npy")
    t0 = time.monotonic()
    gmm_memmap(spec, path, device="cuda")
    write_s = time.monotonic() - t0
    mm = np.load(path, mmap_mode="r")
    for lo in range(0, m, 1 << 20):
        hi = min(lo + (1 << 20), m)
        rows = torch.from_numpy(np.array(mm[lo:hi])).cuda()
        check(torch.equal(rows, X[lo:hi]),
              f"file rows {lo}:{hi} differ from phase 4's X")
    del mm, rows
    emit({"phase": "streaming_data", "path_bytes": Path(path).stat()
          .st_size, "write_s": write_s, "rows_equal_in_core_X": True,
          "page_cache": True, "card": nvidia_smi()})
    return path


def phase_streaming(X, path: str, seed: int, in_core: dict) -> dict:
    """Phase 7.  ``fit(path, cfg)`` over the HEPMASS ``.npy`` at
    ``batch=1`` and ``batch=8, sync_every=2`` under each policy: launches,
    the plain twin, the policy's drift from f32; prefetch=2 bitwise
    prefetch=0 and a slowed consumer; the provider and iterator adapters
    and ``autotune=True`` bitwise the path fit; the pipeline's breakdown.
    ``in_core``: {mode: (fit wall s, fit + evaluate wall s)} of phases 4
    and 5.  Returns {path: (launches, wall)}."""
    m, n = X.shape
    n_eval = math.ceil(m / EVAL_BATCH)
    card = nvidia_smi()
    paths = {}
    base = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed)
    fit(path, base.replace(n_chunks=2, seed=seed + 1))     # warm
    results, f_f32 = {}, {}
    for prec in POLICIES:
        for name, extra in STREAM_MODES.items():
            cfg = base.replace(precision=prec, **extra)
            ops.reset_launch_counts()
            t0 = time.monotonic()
            res = fit(path, cfg)
            ids, f_full = evaluate(res, X)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = ops.launch_counts()
            check(res.strategy == "streaming" and res.extras["auto"],
                  f"fit(path) ran {res.strategy}")
            fit_checks(res, X, ids, f_full, cfg.k, prec)
            h = res.extras["health"]
            check(h["chunks_done"] == h["chunks_fetched"]
                  == cfg.n_chunks == res.n_chunks, f"stream health {h}")

            windows = Windows()
            state, _ = run_path(path, cfg, windows)
            same_state(state, res, f"{prec} {name}: run_stream replay")
            want = seeded_zeros(launches)
            want.update(stream_launches(prec, name,
                                        windows.fused_launches(),
                                        cfg.n_chunks, n_eval))
            check(launches == want,
                  f"{prec} {name} streaming launches {launches} != "
                  f"{want}")
            check(sum(i for _, _, its in windows.rows for i in its)
                  == res.n_iterations, "iterations")

            ref_windows = Windows()
            state_ref, _ = run_path(path, cfg.replace(impl="ref"),
                                    ref_windows)
            _, f_full_ref = evaluate(state_ref.centroids, X, impl="ref")
            rel = abs(f_full - f_full_ref) / f_full_ref
            b, t = extra.get("batch", 1), extra.get("sync_every", 1)
            parting = check_accepts(windows.trace(), ref_windows.trace(),
                                    b, t)
            if prec == "f32":
                f_f32[name] = f_full
            drift = (f_full - f_f32[name]) / f_f32[name]
            results[prec, name] = res
            paths[f"streaming_{prec}_{name}"] = (launches, wall)
            emit({"phase": "streaming", "precision": prec, "run": name,
                  "m": m, "n": n, "k": cfg.k, "s": cfg.s,
                  "n_chunks": cfg.n_chunks, "f_best": res.objective,
                  "f_full": f_full, "n_accepted": res.n_accepted,
                  "n_iterations": res.n_iterations, "wall_s": wall,
                  "fit_wall_s": res.wall_time_s,
                  "in_core_fit_wall_s": in_core[name][0] if prec ==
                  "f32" else None,
                  "in_core_wall_s": in_core[name][1] if prec == "f32"
                  else None,
                  "launches": launches, "pipeline": pipeline_row(res),
                  "ref": {"f_full": f_full_ref},
                  "f_full_rel_diff": rel, "first_parting": parting,
                  f"{prec}_vs_f32_f_full_drift": drift,
                  "page_cache": True, "card": card})
            check(rel <= 1e-3, f"{prec} {name} streaming full "
                  f"objectives differ by {rel:.3e} (> 1e-3)")
            check(abs(drift) <= 1e-2, f"{prec} {name} streaming full "
                  f"objective drifts {drift:.3e} from f32's (> 1 %)")

    # bitwise: prefetch=0, and a slowed consumer, against prefetch=2
    for prec in POLICIES:
        for name, extra in STREAM_MODES.items():
            if name == "batched" and prec != "f32":
                continue
            cfg = base.replace(precision=prec, **extra)
            res = results[prec, name]
            same_stream_fit(fit(path, cfg, prefetch=0), res,
                            f"{prec} {name} prefetch=0")
            state, _ = run_path(path, cfg, SlowConsumer())
            same_state(state, res, f"{prec} {name} slowed consumer")
    # the adapters over the same chunks, and the tuned fit
    for name, extra in STREAM_MODES.items():
        cfg = base.replace(**extra)
        res = results["f32", name]
        fetch = MemmapSource(path).provider(cfg.s, seed=cfg.seed)
        same_stream_fit(fit(ProviderSource(fetch, n_features=n), cfg),
                        res, f"{name} ProviderSource")
        same_stream_fit(fit((fetch(c) for c in range(cfg.n_chunks)), cfg,
                            n_features=n), res, f"{name} IteratorSource")
        autotune.clear()
        same_stream_fit(fit(path, cfg, autotune=True), res,
                        f"{name} autotune=True")
        autotune.clear()
    # evaluate() on the path loads the file: the same objective
    res = results["f32", "sequential"]
    _, f_path = evaluate(res, path)
    _, f_x = evaluate(res, X)
    check(f_path == f_x, f"evaluate(path) {f_path} != evaluate(X) {f_x}")
    emit({"phase": "streaming_checks", "prefetch0_bitwise": True,
          "slowed_consumer_bitwise": True, "adapters_bitwise": True,
          "autotune_bitwise": True, "evaluate_path_equal": True})

    # the breakdown at f32: fetch alone, compute alone, both
    cfg = base
    fetch = MemmapSource(path).provider(cfg.s, seed=cfg.seed)
    t0 = time.perf_counter()
    chunks = [fetch(c) for c in range(cfg.n_chunks)]
    fetch_alone_s = time.perf_counter() - t0
    compute = [fit(ProviderSource(lambda c: chunks[c], n_features=n),
                   cfg).wall_time_s for _ in range(2)]
    del chunks
    turns = {"prefetch2": [], "prefetch0": []}
    for p in ("prefetch2", "prefetch0", "prefetch0", "prefetch2"):
        r = fit(path, cfg, prefetch=int(p[-1]))
        turns[p].append({"fit_wall_s": r.wall_time_s,
                         **pipeline_row(r)})
    in_turns = {"in_core": [], "streaming": []}    # fit + evaluate
    for kind in ("in_core", "streaming", "streaming", "in_core"):
        t0 = time.monotonic()
        r = fit(X if kind == "in_core" else path, cfg)
        evaluate(r, X)
        torch.cuda.synchronize()
        in_turns[kind].append({"fit_wall_s": r.wall_time_s,
                               "wall_s": time.monotonic() - t0})
    for name, extra in STREAM_MODES.items():
        c = cfg.replace(**extra)
        emit({"phase": "streaming_profile", "run": name, "card": card,
              **device_busy(lambda: fit(path, c))})
    emit({"phase": "streaming_host_syncs", "run": "sequential",
          "chunks": cfg.n_chunks, **host_syncs(lambda: fit(path, cfg))})
    emit({"phase": "streaming_breakdown", "run": "sequential",
          "fetch_alone_s": fetch_alone_s,
          "fetch_alone_ms_per_chunk": 1e3 * fetch_alone_s
          / cfg.n_chunks, "compute_alone_fit_wall_s": compute,
          "turns": turns, "in_turns_with_in_core": in_turns,
          "in_core_fit_wall_s": in_core["sequential"][0],
          "page_cache": True, "card": card})
    return paths


# --------------------------------------------------------------------------
# phase 8: faults and middleware on the streamed HEPMASS file
# --------------------------------------------------------------------------

FAULT_PLAN = dict(seed=13, transient_rate=0.25, permanent_ids=(12,),
                  nan_ids=(14,), inf_ids=(20,), shape_ids=(22,))


class RecordingCompetitiveS(sched_lib.CompetitiveS):
    """``competitive_s`` that keeps every window's per-stream scores."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.scores = []

    def observe_window(self, scores, sizes):
        self.scores.append(list(scores))
        return super().observe_window(scores, sizes)


def near_tie(scores) -> bool:
    """Two streams' scores within TIE_RTOL of each other (and not equal:
    streams that share an incumbent score the same bits on both paths)."""
    v = sorted(scores)
    return any(0 < b - a <= TIE_RTOL * abs(b) for a, b in zip(v, v[1:]))


def history_parting(sched, sched_ref):
    """The first window whose sizes, winner size or move differ between
    the paths, which must be a near tie of two streams' scores on either
    path; None when the histories are equal."""
    keys = ("sizes", "winner_s", "moved")
    for w, (h, hr) in enumerate(zip(sched.history, sched_ref.history)):
        if any(h.get(key) != hr.get(key) for key in keys):
            check(near_tie(sched.scores[w]) or near_tie(sched_ref.scores[w]),
                  f"competitive_s histories part at window {w} without a "
                  f"near tie: {h} against {hr}")
            return {"window": w, "cuda": {key: h.get(key) for key in keys},
                    "ref": {key: hr.get(key) for key in keys},
                    "scores_cuda": sched.scores[w],
                    "scores_ref": sched_ref.scores[w]}
    check(len(sched.history) == len(sched_ref.history), "window counts")
    return None


def vns_parting(log, log_ref):
    """The first window whose accept differs between the paths, which must
    be a near tie (f_new within TIE_RTOL of the incumbent it met: the last
    window's f_best rescaled to this chunk's size) on either path; the
    rung and chunk size of every window up to it must agree.  None when
    the paths agree throughout."""
    for i, (row, row_ref) in enumerate(zip(log.rows, log_ref.rows)):
        if row[1] != row_ref[1]:
            near = []
            for lg in (log, log_ref):
                inc = math.inf if i == 0 else (
                    lg.ladder[i - 1][2] * lg.ladder[i][1]
                    / lg.ladder[i - 1][1])
                near.append(abs(lg.rows[i][0][0] - inc)
                            <= TIE_RTOL * abs(inc))
            check(any(near), f"VNS accepts part at window {i} without a "
                  "near tie")
            return {"window": i, "f_new_cuda": row[0], "f_new_ref":
                    row_ref[0]}
        check(log.ladder[i][:2] == log_ref.ladder[i][:2],
              f"VNS rung / chunk size differ at window {i}: "
              f"{log.ladder[i][:2]} against {log_ref.ladder[i][:2]}")
    check(len(log.rows) == len(log_ref.rows), "VNS window counts")
    return None


def raises(fn, match: str) -> str:
    """The message of the exception ``fn()`` must raise, checked to hold
    ``match``."""
    try:
        fn()
    except Exception as exc:            # noqa: BLE001 — checked below
        check(match in str(exc), f"raised {exc!r}, not {match!r}")
        return f"{type(exc).__name__}: {exc}"
    raise AssertionError(f"no exception holding {match!r}")


def counting(calls: list):
    """``wrap`` for :func:`run_path`: a provider that logs each call."""
    def wrap(fetch):
        def provider(cid):
            calls.append(cid)
            return fetch(cid)
        return provider
    return wrap


def phase_vns(X, path: str, base, card: str) -> tuple:
    """8a: the VNS ladder in fold mode, f32, sequential."""
    cfg = base.replace(vns_ladder=(32_000, 16_000), vns_patience=4)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(path, cfg)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    check(res.strategy == "streaming" and res.extras["auto"],
          f"fit(path, vns_ladder=...) ran {res.strategy}")
    log, log_ref = Windows(), Windows()
    state, _ = run_path(path, cfg, log)
    same_state(state, res, "VNS: run_stream replay")
    state_ref, _ = run_path(path, cfg.replace(impl="ref"), log_ref)
    _, f_full = evaluate(res, X)
    _, f_full_ref = evaluate(state_ref.centroids, X, impl="ref")
    rel = abs(f_full - f_full_ref) / f_full_ref
    parting = vns_parting(log, log_ref)
    want = seeded_zeros(launches)
    want.update(fused_step=log.fused_launches(), update=cfg.n_chunks,
                assign=cfg.n_chunks)
    check(launches == want, f"VNS launches {launches} != {want}")
    turns = {"plain": [], "vns": []}    # fit walls, in turns
    for kind in ("plain", "vns", "vns", "plain"):
        turns[kind].append(fit(path, cfg if kind == "vns" else base)
                           .wall_time_s)
    emit({"phase": "faults_vns", "fit_walls_in_turns_s": turns,
          "host_syncs": host_syncs(lambda: fit(path, cfg)), "s": cfg.s, "vns_ladder": cfg.vns_ladder,
          "vns_patience": cfg.vns_patience, "n_chunks": cfg.n_chunks,
          "rungs": [r for r, _, _ in log.ladder],
          "chunk_sizes": [z for _, z, _ in log.ladder],
          "accepts": [int(a[0]) for _, a, _ in log.rows],
          "f_best": res.objective, "f_full": f_full,
          "ref": {"f_full": f_full_ref,
                  "rungs": [r for r, _, _ in log_ref.ladder]},
          "f_full_rel_diff": rel, "first_parting": parting,
          "n_iterations": res.n_iterations, "fit_wall_s": res.wall_time_s,
          "wall_s": wall, "launches": launches, "card": card})
    check(rel <= 1e-3, f"VNS full objectives differ by {rel:.3e} (> 1e-3)")
    return launches, wall


def phase_competitive(X, path: str, base, card: str) -> dict:
    """8b: ``scheduler="competitive_s"``, ``batch=8, sync_every=2``, the
    default ladder, 64 chunks, under every policy; first ``"worker"``,
    which streams bitwise like ``"uniform"``."""
    paths, f_f32 = {}, None
    cfg = base.replace(batch=BATCH, sync_every=SYNC_EVERY)
    same_stream_fit(fit(path, cfg.replace(scheduler="worker")),
                    fit(path, cfg), "scheduler='worker' against 'uniform'")
    for prec in POLICIES:
        cfg = base.replace(n_chunks=64, batch=BATCH, sync_every=SYNC_EVERY,
                           scheduler="competitive_s", precision=prec)
        ops.reset_launch_counts()
        t0 = time.monotonic()
        res = fit(path, cfg)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = ops.launch_counts()
        check(res.strategy == "streaming", f"competitive_s ran "
              f"{res.strategy}")
        info = res.extras["competitive_s"]
        sched, sched_ref = RecordingCompetitiveS(cfg), \
            RecordingCompetitiveS(cfg)
        log, log_ref = Windows(), Windows()
        state, _ = run_path(path, cfg, log, scheduler=sched)
        same_state(state, res, f"{prec} competitive_s: run_stream replay")
        check({"ladder": sched.ladder, "final_sizes": sched.s_of,
               "windows": len(sched.history)} == info,
              f"{prec} competitive_s extras {info}")
        state_ref, _ = run_path(path, cfg.replace(impl="ref"), log_ref,
                                scheduler=sched_ref)
        parting = history_parting(sched, sched_ref)
        if parting is None:
            check(sched.s_of == sched_ref.s_of
                  and log.winner_s == log_ref.winner_s,
                  f"{prec} competitive_s final sizes / winner differ")
        _, f_full = evaluate(res, X)
        _, f_full_ref = evaluate(state_ref.centroids, X, impl="ref")
        rel = abs(f_full - f_full_ref) / f_full_ref
        f_f32 = f_full if prec == "f32" else f_f32
        drift = (f_full - f_f32) / f_f32
        # the eval chunk is scored, one assignment a stream, at every
        # round's reduce, twice at each observation window (the scheduler's
        # scores, then the exchange's) and at the final reduce; the Lloyd
        # epilogue assigns once a chunk (f32 kernel B; B3 under bf16x3)
        rounds = cfg.n_chunks // BATCH
        windows = rounds // SYNC_EVERY
        scores = BATCH * (rounds + 2 * windows + 1)
        want = {"assign_bf16": 0, "assign_bf16x3": 0, "assign": 0}
        want["assign_bf16" if prec == "bf16" else "assign"] += scores
        want["assign_bf16x3" if prec == "bf16x3" else "assign"] += \
            res.n_chunks
        got = {key: launches[key] for key in want}
        kind = "fused_step_batched" + ("" if prec == "f32" else f"_{prec}")
        check(got == want, f"{prec} competitive_s assign launches {got} != "
              f"{want}")
        check(launches[kind] > 0 and launches[kind.replace("_batched", "")]
              == 0, f"{prec} competitive_s fused launches {launches}")
        paths[f"competitive_s_{prec}"] = (launches, wall)
        if prec == "f32":
            emit({"phase": "faults_competitive_s_profile", "card": card,
                  "host_syncs": host_syncs(lambda: fit(path, cfg)),
                  **device_busy(lambda: fit(path, cfg))})
        emit({"phase": "faults_competitive_s", "precision": prec,
              "n_chunks": cfg.n_chunks, "batch": BATCH,
              "sync_every": SYNC_EVERY, "ladder": info["ladder"],
              "fetch_rows": sched.fetch_s, "history": [
                  {key: h.get(key) for key in ("sizes", "winner_s",
                                               "moved")}
                  for h in sched.history],
              "final_sizes": info["final_sizes"],
              "winner_s": log.winner_s, "ref": {
                  "final_sizes": sched_ref.s_of,
                  "winner_s": log_ref.winner_s, "f_full": f_full_ref},
              "first_parting": parting, "f_best": res.objective,
              "f_full": f_full, "f_full_rel_diff": rel,
              f"{prec}_vs_f32_f_full_drift": drift,
              "score_launches": scores, "launches": launches,
              "n_iterations": res.n_iterations,
              "fit_wall_s": res.wall_time_s, "wall_s": wall,
              "pipeline": pipeline_row(res), "card": card})
        check(rel <= 1e-3, f"{prec} competitive_s full objectives differ "
              f"by {rel:.3e} (> 1e-3)")
        check(abs(drift) <= 1e-2, f"{prec} competitive_s full objective "
              f"drifts {drift:.3e} from f32's (> 1 %)")
    # B and B16 at the eval chunk's shape (128,000 rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = X[torch.randint(0, X.shape[0], (sched.fetch_s,), generator=gen,
                        device="cuda")].contiguous()
    c = x[:base.k].clone()
    m, n, k = x.shape[0], x.shape[1], base.k
    xb = x.bfloat16()
    rows = {"assign_f32": timing(
        lambda: distance.assign_f32(x, c),
        lambda: distance.assign_plain(x, c), lambda: torch.mm(x, c.t()),
        4 * (m * n + k * n + 2 * m), 2 * m * k * n, 50),
        "assign_bf16": timing(
        lambda: distance.assign_16(xb, c, "bf16"),
        lambda: distance.assign_plain(xb, c, "bf16"),
        lambda: torch.mm(xb, c.bfloat16().t()),
        2 * m * n + 4 * (k * n + 2 * m), 2 * m * k * n, 50,
        peak=BF16_FLOP_PER_S)}
    emit({"phase": "faults_score_kernels", "m": m, "n": n, "k": k,
          "rows": rows, "card": card})
    return paths


def phase_budget(path: str, base, card: str) -> None:
    """8c: the time budget on the f32 sequential streaming fit (prefetch 0,
    so that the provider's calls are the chunks fetched)."""
    cfg = base.replace(prefetch=0)
    calls: list = []
    log = Windows()
    _, m_full = run_path(path, cfg, log, wrap=counting(calls))
    max_step = log.max_step_s()
    budget = m_full.wall_time_s / 2
    calls.clear()
    log_b = Windows()
    _, m = run_path(path, cfg.replace(time_budget_s=budget), log_b,
                    wrap=counting(calls))
    drops = [cid for t in m.trace if t[0] == "budget_drop" for cid in t[1]]
    check(m.chunks_done < cfg.n_chunks, f"budget: {m.chunks_done} chunks")
    check(m.chunks_done + m.chunks_failed + m.chunks_dropped
          + m.chunks_quarantined == len(calls), "budget reconciliation")
    check(len(drops) == m.chunks_dropped and set(drops) <= set(calls),
          f"budget drops {drops} against {m.chunks_dropped}")
    check(m.wall_time_s <= budget + max_step,
          f"budgeted wall {m.wall_time_s:.4f} s > budget {budget:.4f} + "
          f"one step {max_step:.4f}")
    check(log_b.rows == log.rows[:len(log_b.rows)],
          "the budgeted run is not a prefix of the unbudgeted one")
    calls.clear()
    fetch = MemmapSource(path).provider(cfg.s, seed=cfg.seed)
    res = fit(ProviderSource(counting(calls)(fetch),
                             n_features=PAPER_DATASETS["hepmass"][1]),
              cfg.replace(time_budget_s=budget))
    h = res.health
    check(h["chunks_fetched"] == len(calls) < cfg.n_chunks
          and h["chunks_done"] + h["chunks_dropped"] == len(calls),
          f"budgeted fit health {h} against {len(calls)} fetched")
    emit({"phase": "faults_time_budget", "unbudgeted_wall_s":
          m_full.wall_time_s, "budget_s": budget, "max_step_s": max_step,
          "budgeted_wall_s": m.wall_time_s, "chunks_done": m.chunks_done,
          "chunks_dropped": m.chunks_dropped, "budget_drop": drops,
          "fetched": len(log_b.rows) + len(drops), "fit_health": h,
          "card": card})


def phase_chaos(X, path: str, base, card: str) -> None:
    """8d: the chaos plan on the HEPMASS provider, against the clean fit
    and the plain twin."""
    n = PAPER_DATASETS["hepmass"][1]
    plan = faults.FaultPlan(**FAULT_PLAN)
    cfg = base.replace(retries=2, retry_backoff_s=0.0)
    clean = fit(path, base)
    hit = plan.transient_ids(cfg.n_chunks)
    want_reasons = [(14, "non-finite values (NaN/Inf)"),
                    (20, "non-finite values (NaN/Inf)"),
                    (22, f"bad shape ({cfg.s}, {n // 2}), want (*, {n})")]
    out = {}
    for impl in ("auto", "ref"):
        wrapped = plan.wrap(MemmapSource(path).provider(cfg.s,
                                                        seed=cfg.seed))
        res = fit(ProviderSource(wrapped, n_features=n),
                  cfg.replace(impl=impl))
        h = res.health
        check(h["chunks_done"] + h["chunks_failed"] + h["chunks_dropped"]
              + h["chunks_quarantined"] == h["chunks_fetched"]
              == cfg.n_chunks, f"chaos health {h}")
        check(h["chunks_failed"] == 1 and h["chunks_quarantined"] == 3
              and h["quarantine_reasons"] == want_reasons,
              f"chaos health {h}")
        errors = [t[1] for t in res.trace if t[0] == "fetch_error"]
        check(errors == [12], f"chaos fetch errors {errors}")
        check(all(wrapped.attempts[cid] == 2 for cid in hit if cid != 12),
              f"transients not recovered: {dict(wrapped.attempts)}")
        check(res.objective <= clean.objective * 1.05,
              f"chaos objective {res.objective} > 1.05 x {clean.objective}")
        out[impl] = res, h
    (res, h), (res_ref, h_ref) = out["auto"], out["ref"]
    check(h == h_ref, f"chaos health {h} != the plain twin's {h_ref}")
    _, f_full = evaluate(res, X)
    _, f_full_ref = evaluate(res_ref.centroids, X, impl="ref")
    _, f_clean = evaluate(clean, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    emit({"phase": "faults_chaos", "plan": FAULT_PLAN, "transient_ids": hit,
          "health": h, "objective": res.objective,
          "clean_objective": clean.objective, "f_full": f_full,
          "clean_f_full": f_clean, "ref": {"f_full": f_full_ref},
          "f_full_rel_diff": rel, "fit_wall_s": res.wall_time_s,
          "card": card})
    check(rel <= 1e-3, f"chaos full objectives differ by {rel:.3e}")


def phase_no_demotion(path: str, base) -> None:
    """8e: inside ``kernel_failure("fused")`` a fit on the card raises the
    injected error (the plain path, which launches no kernel, runs); after
    it the same fit is bitwise the fit before it."""
    before = fit(path, base)
    with faults.kernel_failure("fused"):
        ops.reset_launch_counts()
        ref = fit(path, base.replace(impl="ref"))
        check(not any(ops.launch_counts().values()) and math.isfinite(
            ref.objective), "the plain fit inside kernel_failure")
        error = raises(lambda: fit(path, base),
                       "injected fused kernel failure")
    after = fit(path, base)
    same_stream_fit(after, before, "the fit after kernel_failure")
    emit({"phase": "faults_no_demotion", "raised": error,
          "after_bitwise_before": True})


def phase_faults(X, path: str, seed: int) -> dict:
    """Phase 8: faults and middleware on phase 7's HEPMASS ``.npy``, each
    run against its plain twin (``impl="ref"`` on the card): 8a the VNS
    ladder, 8b ``competitive_s`` under every policy, 8c the time budget,
    8d the chaos plan, 8e no demotion.  Returns {path: (launches, wall)}."""
    t0 = time.monotonic()
    card = nvidia_smi()
    base = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed)
    paths = {"vns_f32_sequential": phase_vns(X, path, base, card)}
    paths.update(phase_competitive(X, path, base, card))
    phase_budget(path, base, card)
    phase_chaos(X, path, base, card)
    phase_no_demotion(path, base)
    emit({"phase": "faults_summary", "wall_s": time.monotonic() - t0,
          "card": card})
    return paths


# --------------------------------------------------------------------------
# phase 9: checkpoints and resume on the streamed HEPMASS file
# --------------------------------------------------------------------------

CKPT_TIMES = ("save_ms", "restore_ms")


def leaf_layout(k: int, n: int) -> list:
    """The engine payload's seven leaves, ``(dtype, shape)``, the
    reference's: state (f32[k,n], bool[k], f32, i32, f32), key u32[2],
    aux i64[3]."""
    return [("<f4", (k, n)), ("|b1", (k,)), ("<f4", ()), ("<i4", ()),
            ("<f4", ()), ("<u4", (2,)), ("<i8", (3,))]


def ckpt_fit(data, cfg, times: dict):
    """``fit(data, cfg)`` with its checkpoint times appended to
    ``times``."""
    res = fit(data, cfg)
    for key in CKPT_TIMES:
        times[key].extend(res.extras["checkpoint"][key])
    return res


def step_arrays(directory: str, step: int) -> dict:
    with np.load(Path(directory) / f"step_{step:012d}" / "arrays.npz") as z:
        return {f: z[f] for f in z.files}


def same_checkpoints(a_dir: str, b_dir: str, what: str) -> None:
    """Equal step lists, loop states and newest payloads, bitwise."""
    check(ckpt_lib.steps(a_dir) == ckpt_lib.steps(b_dir),
          f"{what}: steps {ckpt_lib.steps(a_dir)} != {ckpt_lib.steps(b_dir)}")
    check(mw.load_loop_state(a_dir) == mw.load_loop_state(b_dir),
          f"{what}: loop states differ")
    step = ckpt_lib.latest_step(a_dir)
    a, b = step_arrays(a_dir, step), step_arrays(b_dir, step)
    check(list(a) == list(b) and all(
        a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]) for f in a),
        f"{what}: the newest checkpoints differ")


def split_fits(path: str, cfg, root: Path, name: str, times: dict):
    """The uninterrupted fit U into ``<name>_U`` and the split: half the
    chunks with ``resume=False`` into ``<name>_R``, then the fit resumed
    from there (its launches and wall counted)."""
    u_dir, r_dir = str(root / f"{name}_U"), str(root / f"{name}_R")
    full = ckpt_fit(path, cfg.replace(ckpt_dir=u_dir), times)
    first = ckpt_fit(path, cfg.replace(ckpt_dir=r_dir, resume=False,
                                       n_chunks=cfg.n_chunks // 2), times)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    resumed = ckpt_fit(path, cfg.replace(ckpt_dir=r_dir), times)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    return full, first, resumed, u_dir, r_dir, launches, wall


def check_resumed(full, first, resumed, u_dir: str, r_dir: str,
                  what: str) -> None:
    """9a: the resumed fit is bitwise the uninterrupted one."""
    half = full.config.n_chunks // 2
    check(first.n_chunks == resumed.n_chunks == half,
          f"{what}: {first.n_chunks} + {resumed.n_chunks} chunks")
    check(resumed.extras["health"]["ckpt_fallback"] is None
          and len(resumed.extras["checkpoint"]["restore_ms"]) == 1,
          f"{what}: no clean restore")
    check(torch.equal(resumed.centroids, full.centroids)
          and resumed.objective == full.objective
          and resumed.n_dist_evals == full.n_dist_evals
          and first.n_accepted + resumed.n_accepted == full.n_accepted,
          f"{what}: resumed fit differs from the uninterrupted one")
    check(resumed.trace == [t for t in full.trace if t[0] >= half],
          f"{what}: accept traces of chunks {half}.. differ")
    same_checkpoints(r_dir, u_dir, what)


def resumed_launches(prec: str, name: str, res, launches: dict) -> None:
    """The resumed fit went through the policy's kernels: A· once per Lloyd
    iteration (sequential), or D· (batched) and never A·; the epilogue's
    B· and C· once a chunk."""
    if name == "sequential":
        want = seeded_zeros(launches)
        want.update(stream_launches(prec, name, res.n_iterations,
                                    res.n_chunks, 0))
        check(launches == want, f"{prec} resume launches {launches} != "
              f"{want}")
    else:
        d = COUNTS[f"fused_step_batched_{prec}"]
        check(0 < launches[d] <= res.n_iterations
              and launches[COUNTS[f"fused_step_{prec}"]] == 0
              and launches["update"] == launches["assign"] == res.n_chunks,
              f"{prec} batched resume launches {launches}")


def check_layout(root: Path, k: int, n: int, skip: set) -> int:
    """9f: every step phase 9 wrote (outside ``skip``) is intact, with
    exactly the four meta keys and the seven leaves of the reference's
    dtypes and shapes.  Returns the count of steps checked."""
    want = leaf_layout(k, n)
    count = 0
    for d in sorted(p for p in root.iterdir() if p.name not in skip):
        for step in ckpt_lib.steps(str(d)):
            check(ckpt_lib.verify_step(str(d), step),
                  f"{d.name} step {step} fails verification")
            meta = json.loads((d / f"step_{step:012d}" / "meta.json")
                              .read_text())
            check(sorted(meta) == ["digests", "n_leaves", "step", "treedef"]
                  and meta["step"] == step and meta["n_leaves"] == 7,
                  f"{d.name} step {step} meta {sorted(meta)}")
            arrays = step_arrays(str(d), step)
            got = [(arrays[f"a{i}"].dtype.str, arrays[f"a{i}"].shape)
                   for i in range(len(arrays))]
            check(list(arrays) == [f"a{i}" for i in range(7)]
                  and got == want, f"{d.name} step {step} leaves {got}")
            count += 1
    return count


def device_read_ms(directory: str, reps: int = 50) -> dict:
    """A save's device read, alone: the newest payload of ``directory``
    restored onto the card (five tensors, the key and the aux as numpy) and
    read back by ``ckpt_lib.to_host`` (leaf by leaf), against one packed
    copy of the same tensors; median ms of ``reps`` each."""
    example = tuple(torch.empty(0) for _ in range(5)) + (
        np.zeros(2, np.uint32), np.zeros(3, np.int64))
    payload, _ = ckpt_lib.restore(directory, example, device="cuda")
    tensors = payload[:5]

    def packed():
        torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]
                  ).cpu().numpy()

    out = {}
    for name, read in (("per_leaf", lambda: ckpt_lib.to_host(payload)),
                       ("packed", packed)):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            read()
            ms.append(1e3 * (time.perf_counter() - t0))
        out[f"read_ms_{name}_median"] = float(np.median(ms))
    host = ckpt_lib.to_host(payload)
    check(all(np.array_equal(a, t.cpu().numpy())
              for a, t in zip(host[:5], tensors)),
          "to_host differs from the card's tensors")
    return out


def phase_resume_persistent(X, path: str, base, root: Path,
                            times: dict) -> dict:
    """9c: the persistent split (f32, ``batch=8, sync_every=2``) resumed on
    the card and by its plain twin from a copy of the same directory."""
    cfg = base.replace(batch=BATCH, sync_every=SYNC_EVERY)
    r_dir, twin_dir = root / "persistent_R", root / "persistent_twin"
    full = ckpt_fit(path, cfg.replace(ckpt_dir=str(root / "persistent_U")),
                    times)
    ckpt_fit(path, cfg.replace(ckpt_dir=str(r_dir), resume=False,
                               n_chunks=cfg.n_chunks // 2), times)
    shutil.copytree(r_dir, twin_dir)
    start = float(step_arrays(str(r_dir), ckpt_lib.latest_step(
        str(r_dir)))["a2"])
    log, log_ref = Windows(), Windows()
    state, m = run_path(path, cfg.replace(ckpt_dir=str(r_dir)), log)
    state_ref, m_ref = run_path(
        path, cfg.replace(ckpt_dir=str(twin_dir), impl="ref"), log_ref)
    half = cfg.n_chunks // 2
    check(m.chunks_done == m_ref.chunks_done == half,
          f"persistent resume: {m.chunks_done} / {m_ref.chunks_done} chunks")
    parting = check_accepts(log.trace(), log_ref.trace(), BATCH, SYNC_EVERY,
                            start)
    _, f_full = evaluate(state.centroids, X)
    _, f_full_ref = evaluate(state_ref.centroids, X, impl="ref")
    _, f_full_u = evaluate(full, X)
    rel = abs(f_full - f_full_ref) / f_full_ref
    check(rel <= 1e-3, f"persistent resume: full objectives differ by "
          f"{rel:.3e} (> 1e-3)")
    return {"f_full": f_full, "ref_f_full": f_full_ref,
            "f_full_rel_diff": rel, "first_parting": parting,
            "uninterrupted_f_full": f_full_u,
            "vs_uninterrupted_rel": (f_full - f_full_u) / f_full_u,
            "restored_f_best": start, "accepts": m.accepted,
            "ref_accepts": m_ref.accepted}


def phase_resume_healing(path: str, base, r_dir: str, root: Path,
                         times: dict) -> dict:
    """9d: on a copy of 9a's f32 split, the newest step torn, then every
    step: the fallback and the fresh start."""
    h_dir = str(root / "healed")
    shutil.copytree(r_dir, h_dir)
    intact = ckpt_lib.steps(h_dir)[-2]
    faults.corrupt_checkpoint(h_dir)
    res = ckpt_fit(path, base.replace(ckpt_dir=h_dir, n_chunks=40), times)
    h = res.health
    check(h["ckpt_fallback"] == intact
          and h["chunks_done"] == res.n_chunks == 40 - intact,
          f"healing: health {h} against the intact step {intact}")
    torn = ckpt_lib.steps(h_dir)
    for step in torn:
        faults.corrupt_checkpoint(h_dir, step=step)
    healed = ckpt_fit(path, base.replace(ckpt_dir=h_dir), times)
    fresh = ckpt_fit(path, base.replace(ckpt_dir=str(root / "fresh"),
                                        resume=False), times)
    check(healed.trace[0] == ("ckpt_fallback", None)
          and healed.health["ckpt_fallback"] is None,
          "every step torn: no fresh start recorded")
    same_stream_fit(types.SimpleNamespace(**{
        **vars(healed), "trace": healed.trace[1:]}), fresh,
        "every step torn: the fresh start")
    return {"fallback_step": intact, "chunks_done": h["chunks_done"],
            "torn_steps": torn, "fresh_start_bitwise": True}


def phase_resume_chaos(path: str, base, clean, root: Path,
                       times: dict) -> dict:
    """9e: phase 8d's chaos plan resumed past a torn checkpoint."""
    n = PAPER_DATASETS["hepmass"][1]
    c_dir = str(root / "chaos")
    ckpt_fit(path, base.replace(ckpt_dir=c_dir, n_chunks=11, ckpt_every=5),
             times)
    torn = ckpt_lib.latest_step(c_dir)
    faults.corrupt_checkpoint(c_dir)
    intact = ckpt_lib.latest_intact_step(c_dir)
    plan = faults.FaultPlan(**FAULT_PLAN)
    cfg = base.replace(retries=2, retry_backoff_s=0.0, ckpt_dir=c_dir,
                       ckpt_every=5)
    wrapped = plan.wrap(MemmapSource(path).provider(cfg.s, seed=cfg.seed))
    res = ckpt_fit(ProviderSource(wrapped, n_features=n), cfg, times)
    h = res.health
    want_reasons = [(14, "non-finite values (NaN/Inf)"),
                    (20, "non-finite values (NaN/Inf)"),
                    (22, f"bad shape ({cfg.s}, {n // 2}), want (*, {n})")]
    check(h["chunks_done"] + h["chunks_failed"] + h["chunks_dropped"]
          + h["chunks_quarantined"] == h["chunks_fetched"]
          == cfg.n_chunks - intact, f"chaos resume health {h}")
    check(intact is not None and intact < torn
          and h["ckpt_fallback"] == intact,
          f"chaos resume fallback {h['ckpt_fallback']} (torn {torn})")
    check(h["chunks_failed"] == 1 and h["chunks_quarantined"] == 3
          and h["quarantine_reasons"] == want_reasons,
          f"chaos resume health {h}")
    check(res.objective <= clean.objective * 1.05,
          f"chaos resume objective {res.objective} > 1.05 x "
          f"{clean.objective}")
    return {"torn_step": torn, "health": h, "objective": res.objective,
            "clean_objective": clean.objective}


def phase_resume(X, path: str, seed: int, root: Path) -> dict:
    """Phase 9: ``ckpt_dir`` / ``resume`` on phase 7's HEPMASS ``.npy``:
    9a fold-mode splits bitwise the uninterrupted fits (sequential under
    each policy, f32 at ``batch=8``), 9b the VNS split, 9c the persistent
    split against its plain twin, 9d self-healing, 9e chaos past a torn
    checkpoint, 9f the layout of every step written; the save, device-read
    (alone, per leaf against packed) and restore ms.  Returns {path: (launches, wall)} of the resumed
    fits."""
    t0 = time.monotonic()
    card = nvidia_smi()
    k, n = 25, PAPER_DATASETS["hepmass"][1]
    base = BigMeansConfig(k=k, s=64_000, n_chunks=32, seed=seed,
                          log_every=1, ckpt_every=8)
    times = {key: [] for key in CKPT_TIMES}
    paths, walls, fits = {}, {}, {}
    cases = [(prec, "sequential", {}) for prec in POLICIES]
    cases.append(("f32", "batched", dict(batch=BATCH, sync_every=1)))
    for prec, name, extra in cases:
        what = f"resume {prec} {name}"
        out = split_fits(path, base.replace(precision=prec, **extra), root,
                         f"{prec}_{name}", times)
        full, first, resumed, u_dir, r_dir, launches, wall = out
        check_resumed(full, first, resumed, u_dir, r_dir, what)
        resumed_launches(prec, name, resumed, launches)
        paths[f"resume_{prec}_{name}"] = (launches, wall)
        fits[prec, name] = out
        walls[f"{prec}_{name}"] = {
            "uninterrupted_s": full.wall_time_s,
            "first_half_s": first.wall_time_s,
            "resumed_s": resumed.wall_time_s}
    emit({"phase": "resume_fold", "cases": [f"{p}_{m}" for p, m, _ in cases],
          "bitwise_uninterrupted": True, "walls": walls, "card": card})

    vns = base.replace(vns_ladder=(32_000, 16_000), vns_patience=4)
    full, first, resumed, u_dir, r_dir, _, _ = split_fits(
        path, vns, root, "vns", times)
    check_resumed(full, first, resumed, u_dir, r_dir, "resume VNS")
    emit({"phase": "resume_vns", "bitwise_uninterrupted": True,
          "loop_state": mw.load_loop_state(r_dir),
          "mid_loop_state_restored": True, "card": card})

    emit({"phase": "resume_persistent", "card": card,
          **phase_resume_persistent(X, path, base, root, times)})
    emit({"phase": "resume_healing", **phase_resume_healing(
        path, base, fits["f32", "sequential"][4], root, times)})
    emit({"phase": "resume_chaos", "card": card, **phase_resume_chaos(
        path, base, fits["f32", "sequential"][0], root, times)})
    steps_checked = check_layout(root, k, n, skip={"healed"})
    emit({"phase": "resume_layout", "steps_checked": steps_checked,
          "leaves": leaf_layout(k, n)})
    med = {f"{key}_median": float(np.median(times[key]))
           for key in CKPT_TIMES}
    med.update(device_read_ms(fits["f32", "sequential"][3]))
    emit({"phase": "resume_times", **med,
          **{f"{key}_count": len(times[key]) for key in CKPT_TIMES},
          "save_ms_max": max(times["save_ms"]),
          "f32_sequential_walls_s": walls["f32_sequential"],
          "wall_s": time.monotonic() - t0, "card": card})
    return paths


# --------------------------------------------------------------------------
# phase 10: serving at HEPMASS scale
# --------------------------------------------------------------------------

SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 200
REQ_POINTS = 48             # one request (benchmarks/serve_latency.py:39)
SERVE_LINGERS = (0.0, 2.0)
WIDE_K, WIDE_N = 2048, 1024  # the two-pass shape (phases 5c, 5f)
TIMED_BUCKETS = (64, 4096)
# a poisoned request, transient launch faults and an outage window
SERVE_CHAOS = dict(launch_transient_rate=0.2, launch_outage_after=60,
                   launch_outage_len=20)


class Tenant(types.SimpleNamespace):
    """One served model: its centroids ``c`` (on the card), ``prec``, a
    pool ``x`` of request rows on the card and ``requests``, the closed
    loop's requests as host arrays [R, REQ_POINTS, n]."""

    def rows(self, m: int, off: int = 0) -> torch.Tensor:
        return self.x[off:off + m]


def serve_tenants(X, res, seed: int) -> dict:
    """Four tenants on phase 4's fit (k = 25, n = 28), one per policy, with
    HEPMASS rows as requests; a fifth, ``wide``, f32 at k = 2,048, n =
    1,024 on seeded centroids and points around them."""
    n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
    pool = X[1_000_000:1_000_000 + n_req * REQ_POINTS + 8192]
    reqs = pool[:n_req * REQ_POINTS].cpu().numpy().reshape(
        n_req, REQ_POINTS, -1)
    out = {prec: Tenant(c=res.centroids.contiguous(), prec=prec, x=pool,
                        requests=reqs) for prec in POLICIES}
    xw, cw = separated(n_req * REQ_POINTS + 8192, WIDE_K, WIDE_N, seed + 5)
    out["wide"] = Tenant(c=cw, prec="f32", x=xw, requests=xw[
        :n_req * REQ_POINTS].cpu().numpy().reshape(n_req, REQ_POINTS, -1))
    return out


def assign_plain_at(prec: str, x, c):
    return (distance.assign_int8_plain(x, c) if prec == "int8"
            else distance.assign_plain(x, c, prec))


def assign_ties_at(prec: str, x, c) -> torch.Tensor:
    if prec == "int8":
        return near_ties_int8(px.quantize_chunk(x), c)
    return near_ties(x, c) if prec == "f32" else near_ties_16(x, c, prec)


def check_against_plain(prec: str, x, c, ids, d, what: str) -> float:
    """ids (host or card) equal the plain version's off near ties, d within
    RTOL of its terms' magnitude; returns the max abs err of d."""
    ids = torch.as_tensor(ids).to(x.device)
    d = torch.as_tensor(d).to(x.device)
    ids_p, d_p = assign_plain_at(prec, x, c)
    ok = ~assign_ties_at(prec, x, c)
    check(torch.equal(ids[ok], ids_p[ok]), f"{what}: ids differ off ties")
    xs = (px.dequantize(px.quantize_chunk(x)) if prec == "int8"
          else px.cast_storage(x, prec).float())
    x2 = (xs * xs).sum(1)
    c2 = (c * c).sum(1)[ids_p.long()]
    scale = x2 + c2 + 2 * (x2 * c2).sqrt()
    err = (d - d_p).abs()
    check(bool((err[ok] <= RTOL * scale[ok] + 1e-6).all()),
          f"{what}: d off by {float(err.max())}")
    return float(err.max())


def serve_replays(srv, tenants: dict) -> dict:
    """10a: every bucket's capture counted one launch of its policy's
    kernel (what each replay then adds), and its replay is bitwise the
    eager launch of the same policy on the same rows, and held against the
    plain version."""
    errs = {}
    for name, t in tenants.items():
        entry = srv.registry.get(name)
        snap = entry.snapshot()
        worst = 0.0
        kernel = ops.ASSIGN_COUNTERS[t.prec]
        for b in srv.config.buckets():
            check(entry.plan(b).launches == {kernel: 1},
                  f"serve {name} bucket {b}: the capture counted "
                  f"{entry.plan(b).launches}, not one launch of {kernel}")
            x = t.rows(b, off=b)
            buf = entry.host_buffer(b)
            buf.copy_(x.cpu())
            ids, d = entry.launch(buf, snap)
            ids_e, d_e = ops.assign(x, snap.centroids, precision=t.prec)
            check(np.array_equal(ids, ids_e.cpu().numpy())
                  and np.array_equal(d, d_e.cpu().numpy()),
                  f"serve {name} bucket {b}: replay not bitwise eager")
            worst = max(worst, check_against_plain(
                t.prec, x, t.c, ids, d, f"serve {name} bucket {b}"))
        errs[name] = worst
    return errs


def assign_cost(prec: str, m: int, k: int, n: int) -> tuple:
    """(bytes, operations, peak) of one assignment at ``prec``, as phase
    6's rows of B, B8, B16 and B3 count them."""
    if prec == "int8":
        return (m * n + 5 * k * n + 4 * k + 4 * n + 8 * m, 2 * m * k * n,
                INT8_OP_PER_S)
    if prec == "f32":
        return 4 * (m * n + k * n + 2 * m), 2 * m * k * n, F32_FLOP_PER_S
    eb = 2 if prec == "bf16" else 4
    mult = 1 if prec == "bf16" else 3
    return (eb * m * n + 4 * (k * n + k) + 8 * m, mult * 2 * m * k * n,
            BF16_FLOP_PER_S)


def plan_replay_ms(plan, replays: int = 200) -> float:
    """Device ms of one replay of a serving plan's graph (the policy's
    quantization or cast and its kernel), by CUDA events."""
    plan.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        plan.graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / replays


def eager_launch(entry):
    """``entry.launch`` without its CUDA graph: the rows copied to the card,
    the policy's assign called eagerly, ids and d read back through pinned
    buffers, all on the entry's stream; the graph's twin, for timing."""
    pinned = {}

    def launch(q, snap):
        b = int(q.shape[0])
        if b not in pinned:
            pinned[b] = (torch.empty(b, dtype=torch.int32, pin_memory=True),
                         torch.empty(b, dtype=torch.float32,
                                     pin_memory=True))
        host_ids, host_d = pinned[b]
        with torch.cuda.stream(entry.stream):
            x = q.to(entry.device, non_blocking=True)
            ids, d = ops.assign(x, snap.centroids, impl=entry.impl,
                                precision=entry.precision)
            host_ids.copy_(ids, non_blocking=True)
            host_d.copy_(d, non_blocking=True)
        entry.stream.synchronize()
        return host_ids.numpy().copy(), host_d.numpy().copy()

    return launch


def serve_times(srv, tenants: dict) -> dict:
    """Each tenant's assign kernel at buckets 64 and 4,096: the kernel by
    graph replay beside its bound, plain version and dots-only library
    call (``timing``), one replay of the serving plan, and one whole
    ``ModelEntry.launch`` on the host clock (rows in, replay, ids and d
    out: the floor under a request's latency) in turns with the same
    launch made eagerly (:func:`eager_launch`)."""
    rows = {}
    for name, t in tenants.items():
        entry = srv.registry.get(name)
        snap = entry.snapshot()
        c = t.c
        k, n = c.shape
        kernel_name = f"assign_{t.prec}"
        for b in TIMED_BUCKETS:
            x = t.rows(b)
            nbytes, flops, peak = assign_cost(t.prec, b, k, n)
            if t.prec == "int8":
                qx = px.quantize_chunk(x)
                cq, tq = px.quantize_centroids(c, qx.scale)
                row = timing(
                    lambda: distance.launch_assign_int8(qx.q, qx.scale, cq,
                                                        tq, c),
                    lambda: distance.assign_int8_plain(qx, c),
                    int_mm(qx.q, cq), nbytes, flops, 100, peak,
                    wrapper=lambda: distance.assign_int8(qx, c))
                row["library"] = int_mm_note(qx.q, cq)
            elif t.prec == "f32":
                row = timing(lambda: distance.assign_f32(x, c),
                             lambda: distance.assign_plain(x, c),
                             lambda: torch.mm(x, c.t()), nbytes, flops,
                             100, peak)
                row["library"] = MM_F32
            else:
                xs, c16 = px.cast_storage(x, t.prec), c.bfloat16()
                row = timing(
                    lambda: distance.assign_16(xs, c, t.prec),
                    lambda: distance.assign_plain(xs, c, t.prec),
                    (lambda: torch.mm(xs, c16.t())) if t.prec == "bf16"
                    else None, nbytes, flops, 100, peak)
                row["library"] = (MM_BF16 if t.prec == "bf16" else
                                  "none (no single call computes it)")
            row["plan_replay_ms"] = plan_replay_ms(entry.plan(b))
            buf = entry.host_buffer(b)
            buf.copy_(x.cpu())
            eager = eager_launch(entry)
            eager(buf, snap)
            graph_ms, eager_ms = [], []
            for _ in range(50):
                for fn, ms in ((entry.launch, graph_ms), (eager, eager_ms)):
                    t0 = time.perf_counter()
                    fn(buf, snap)
                    ms.append(1e3 * (time.perf_counter() - t0))
            row["launch_host_ms_median"] = float(np.median(graph_ms))
            row["eager_launch_host_ms_median"] = float(np.median(eager_ms))
            row.update(tenant=name, bucket=b, k=k, n=n)
            rows.setdefault(kernel_name, {})[f"{name}_b{b}"] = row
            emit({"phase": "serve_times", "kernel": kernel_name, **row})
    return rows


def closed_loop(srv, name: str, requests, clients: int,
                per_client: int) -> tuple[list, float]:
    """``clients`` threads, each sending its ``per_client`` requests one
    after another; returns the responses in request order and the wall."""
    out = [None] * (clients * per_client)
    errors = []

    def client(cid: int) -> None:
        for i in range(cid * per_client, (cid + 1) * per_client):
            try:
                out[i] = srv.assign(name, requests[i], timeout=120)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(f"{type(exc).__name__}: {exc}")
                return

    threads = [threading.Thread(target=client, args=(cid,))
               for cid in range(clients)]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.monotonic() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"serve {name}: clients failed: {errors[:3]}")
    return out, wall


def same_response(a, b) -> bool:
    return np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)


def serve_traffic(servers: dict, tenants: dict) -> tuple[dict, dict]:
    """10b: the closed loop on every tenant at each linger; responses under
    f32, bf16 and bf16x3 bitwise the same request served alone (one at a
    time, linger 0); under int8 bitwise where the request rode alone, its
    agreement elsewhere printed.  Returns ({path: (launches, wall)} and
    the per-tenant rows)."""
    counts = dict.fromkeys(ops.launch_counts(), 0)
    wall_all, rows, loops = 0.0, {}, {}
    for linger, srv in servers.items():
        for name, t in tenants.items():
            entry = srv.registry.get(name)
            before = dict(entry.replays)
            ops.reset_launch_counts()
            got, wall = closed_loop(srv, name, t.requests, SERVE_CLIENTS,
                                    SERVE_PER_CLIENT)
            launches = ops.launch_counts()
            replays = {b: v - before.get(b, 0)
                       for b, v in sorted(entry.replays.items())
                       if v - before.get(b, 0)}
            kernel = ops.ASSIGN_COUNTERS[t.prec]
            want = seeded_zeros(launches)
            for b, r in replays.items():
                for key, v in entry.plan(b).launches.items():
                    want[key] += r * v
            check(launches == want and launches[kernel] == sum(
                      replays.values()),
                  f"serve {name} linger {linger}: launches "
                  f"{ {k: v for k, v in launches.items() if v} } != "
                  f"replays {replays} times the captures' counts")
            stats = srv.stats(name)
            check(stats["n_launch_faults"] == stats["n_ref_retries"] == 0
                  and not entry.demoted_buckets
                  and stats["recompiles"] == len(srv.config.buckets()),
                  f"serve {name} linger {linger}: healthy run stats {stats}")
            for key, v in launches.items():
                counts[key] += v
            wall_all += wall
            loops[linger, name] = got
            rows[f"{name}_linger{linger:g}"] = {
                "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                "mean_ms": stats["mean_ms"],
                "requests_per_s": len(got) / wall,
                "requests_per_launch": stats["requests_per_batch"],
                "launches": stats["n_batches"], "wall_s": wall,
                "replays_per_bucket": replays,
                "kernel_launches": {kernel: launches[kernel]},
                "padded_rows": stats["n_padded_rows"],
                "captures": stats["recompiles"]}
            emit({"phase": "serve_traffic", "tenant": name,
                  "precision": t.prec, "linger_ms": linger,
                  **rows[f"{name}_linger{linger:g}"]})
    alone_srv = servers[0.0]
    for name, t in tenants.items():
        alone = [alone_srv.assign(name, r) for r in t.requests]
        check(all(r.n_coalesced == 1 for r in alone), "alone coalesced")
        t.alone = alone
        for linger in servers:
            got = loops[linger, name]
            if t.prec != "int8":
                check(all(same_response(g, a) for g, a in zip(got, alone)),
                      f"serve {name} linger {linger}: coalesced not bitwise "
                      "the request served alone")
                continue
            single = [(g, a) for g, a in zip(got, alone)
                      if g.n_coalesced == 1]
            check(all(same_response(g, a) for g, a in single),
                  f"serve int8 linger {linger}: a lone launch differs")
            ids = np.stack([g.ids for g in got])
            ids_a = np.stack([a.ids for a in alone])
            d = np.stack([g.dists for g in got])
            d_a = np.stack([a.dists for a in alone])
            rows[f"{name}_linger{linger:g}"]["int8_vs_alone"] = {
                "lone_launches_bitwise": len(single),
                "ids_agree": float((ids == ids_a).mean()),
                "d_max_rel_diff": float(np.max(np.abs(d - d_a)
                                               / np.maximum(d_a, 1e-30)))}
    emit({"phase": "serve_alone_bitwise", "policies": ["f32", "bf16",
                                                       "bf16x3"],
          "int8": {k: v["int8_vs_alone"] for k, v in rows.items()
                   if "int8_vs_alone" in v}})
    return {"serve": (counts, wall_all)}, rows


def loop_row(got, wall: float) -> dict:
    lat = np.array([r.latency_ms for r in got])
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(got) / wall}


def serve_graph_vs_eager(servers: dict, tenants: dict) -> dict:
    """Each tenant's closed loop (10b's requests) at each linger with its
    launches replayed from the graphs and made eagerly
    (:func:`eager_launch`), in turns graph, eager, eager, graph; responses
    under f32, bf16 and bf16x3 bitwise 10b's alone-served ones either way.
    Returns {tenant_linger: {"graph": [row, row], "eager": [row, row]}}."""
    out = {}
    for linger, srv in servers.items():
        for name, t in tenants.items():
            entry = srv.registry.get(name)
            eager = eager_launch(entry)
            turns = {"graph": [], "eager": []}
            for way in ("graph", "eager", "eager", "graph"):
                if way == "eager":
                    entry.launch = eager
                got, wall = closed_loop(srv, name, t.requests, SERVE_CLIENTS,
                                        SERVE_PER_CLIENT)
                if way == "eager":
                    del entry.launch
                check(t.prec == "int8" or all(
                    same_response(g, a) for g, a in zip(got, t.alone)),
                    f"serve {name} linger {linger} {way}: a response "
                    "differs from 10b's")
                turns[way].append(loop_row(got, wall))
            out[f"{name}_linger{linger:g}"] = turns
            emit({"phase": "serve_graph_vs_eager", "tenant": name,
                  "linger_ms": linger, **turns})
    return out


def serve_busy_share(srv, tenants: dict) -> dict:
    """The card's busy and idle share of one 10b closed loop per tenant
    (linger 0), from a ``torch.profiler`` trace (:func:`device_busy`: the
    union of its kernels and copies over the loop's wall, the profiler's
    own cost inside that wall)."""
    out = {}
    for name, t in tenants.items():
        box = {}
        out[name] = device_busy(lambda: box.update(got=closed_loop(
            srv, name, t.requests, SERVE_CLIENTS, SERVE_PER_CLIENT)))
        out[name].update(loop_row(*box["got"]))
        emit({"phase": "serve_busy_share", "tenant": name, **out[name]})
    return out


def save_serving_checkpoint(directory: str, step: int, c) -> None:
    """A checkpoint in the engine's ``((state, key), aux)`` layout, written
    by the port's checkpoint library, serving ``c``."""
    k, n = c.shape
    state = bm_lib.init_state(k, n, device=c.device)._replace(
        centroids=c, f_best=torch.tensor(1.0, device=c.device))
    ckpt_lib.save(directory, step, ((state, np.zeros(2, np.uint32)),
                                    np.zeros(3, np.int64)))


def padded_eager(x, c, bucket: int = 64):
    """The f32 assignment of rows ``x`` served alone: zero-padded to the
    smallest bucket, kernel B, read back."""
    xp = torch.zeros((bucket, x.shape[1]), device=c.device)
    xp[:len(x)] = torch.from_numpy(x).to(c.device)
    ids, d = ops.assign(xp, c, precision="f32")
    return ids[:len(x)].cpu().numpy(), d[:len(x)].cpu().numpy()


def serve_hot_swap(srv, t, root: Path) -> dict:
    """10c: the f32 tenant swapped mid-traffic from checkpoints the port
    writes, through ``Server.watch``: no request dropped, both steps seen,
    no capture, each response bitwise the alone-served assignment on its
    step's centroids."""
    d = str(root / "serve_ckpt")
    c0 = t.c
    c1 = c0[torch.roll(torch.arange(c0.shape[0], device=c0.device), 1)]
    gens = {1: c0, 2: c1.contiguous()}
    captures = srv.recompiles("f32")
    save_serving_checkpoint(d, 1, c0)
    watcher = srv.watch("f32", d, poll_interval_s=0.02)
    t0 = time.monotonic()
    while srv.stats("f32")["step"] != 1 and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    results, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(cid: int) -> None:
        i = cid
        while not stop.is_set():
            p = t.requests[i % len(t.requests)]
            try:
                r = srv.assign("f32", p, timeout=60)
            except Exception as exc:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}")
                return
            with lock:
                results.append((p, r))
            i += SERVE_CLIENTS

    def wait_for(count: int) -> None:
        t1 = time.monotonic()
        while time.monotonic() - t1 < 60:
            with lock:
                if len(results) >= count or errors:
                    return
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(cid,))
               for cid in range(SERVE_CLIENTS)]
    for th in threads:
        th.start()
    wait_for(400)
    save_serving_checkpoint(d, 2, gens[2])
    t_swap = time.monotonic()
    while srv.stats("f32")["step"] != 2 and time.monotonic() - t_swap < 30:
        time.sleep(0.002)
    swap_s = time.monotonic() - t_swap
    wait_for(len(results) + 400)
    stop.set()
    for th in threads:
        th.join(timeout=60)
    watcher.stop()
    check(not errors and not any(th.is_alive() for th in threads),
          f"hot swap: clients failed {errors[:3]}")
    steps = sorted({r.step for _, r in results})
    check(steps == [1, 2], f"hot swap: steps seen {steps}")
    check(srv.recompiles("f32") == captures,
          f"hot swap captured: {srv.recompiles('f32')} != {captures}")
    check(watcher.n_errors == 0 and watcher.last_step == 2,
          f"watcher {watcher.describe()}")
    for p, r in results:
        ids, dd = padded_eager(p, gens[r.step])
        check(np.array_equal(r.ids, ids) and np.array_equal(r.dists, dd),
              f"hot swap: a response is not its generation's (step "
              f"{r.step})")
    return {"responses": len(results), "steps_seen": steps,
            "captures": srv.recompiles("f32"), "swap_visible_s": swap_s,
            "watcher": watcher.describe()}


def serve_late_register(srv, t) -> dict:
    """A tenant registered (warmup: its seven captures) while the f32
    tenant serves 8 x 50 requests: both tenants' responses bitwise 10b's
    alone-served ones, and the late tenant captured once per bucket."""
    per = min(50, SERVE_PER_CLIENT)
    n_req = SERVE_CLIENTS * per
    box = {}
    runner = threading.Thread(target=lambda: box.update(out=closed_loop(
        srv, "f32", t.requests[:n_req], SERVE_CLIENTS, per)))
    runner.start()
    time.sleep(0.01)
    t0 = time.monotonic()
    srv.register("late", t.c, precision="f32")
    register_s = time.monotonic() - t0
    runner.join(timeout=300)
    check(not runner.is_alive() and "out" in box, "f32 traffic hung")
    got, wall = box["out"]
    check(all(same_response(g, a) for g, a in zip(got, t.alone)),
          "late registration: f32 responses not bitwise 10b's")
    late = [srv.assign("late", r) for r in t.requests[:per]]
    check(all(same_response(g, a) for g, a in zip(late, t.alone)),
          "late tenant: responses not bitwise the f32 tenant's")
    check(srv.recompiles("late") == len(srv.config.buckets()),
          f"late tenant: {srv.recompiles('late')} captures")
    return {"register_s": register_s, "traffic_wall_s": wall,
            "requests": n_req, "late_captures": srv.recompiles("late")}


def serve_chaos(srv, t) -> dict:
    """10d: ``FaultPlan.wrap_launch`` on the f32 tenant: a poisoned request
    isolated by bisection, transient faults recovered by replaying the
    bucket's graph (``ModelEntry.relaunch``), an outage window that trips
    the breaker, which closes again.  Every response served is bitwise
    10b's alone-served one: no launch takes the plain version."""
    entry = srv.registry.get("f32")
    plan = faults.FaultPlan(seed=23, **SERVE_CHAOS)
    chaotic = plan.wrap_launch(entry.launch)
    gate = threading.Event()

    def gated(q, snap):
        gate.wait(30)
        return chaotic(q, snap)

    entry.launch = gated
    blocker = srv.submit("f32", t.requests[0])
    time.sleep(0.05)
    healthy = list(range(1, 7))
    poison = t.requests[7].copy()
    poison[5, 3] = np.nan
    futs = [srv.submit("f32", t.requests[i]) for i in healthy[:3]]
    poisoned = srv.submit("f32", poison, validate=False)
    futs += [srv.submit("f32", t.requests[i]) for i in healthy[3:]]
    gate.set()
    served = {0: blocker.result(timeout=30)}
    served.update({i: f.result(timeout=30) for i, f in zip(healthy, futs)})
    try:
        poisoned.result(timeout=30)
        check(False, "the poisoned request was served")
    except serve_lib.LaunchFault:
        pass
    entry.launch = chaotic
    check(max(r.n_coalesced for r in served.values()) > 1,
          "the poisoned request did not ride a coalesced launch")

    failed, unhealthy = [], [0]
    lock = threading.Lock()
    n_req = min(SERVE_CLIENTS * 100, len(t.requests))

    def client(cid: int) -> None:
        for i in range(8 + cid, n_req, SERVE_CLIENTS):
            for _ in range(200):
                try:
                    r = srv.assign("f32", t.requests[i], timeout=60)
                except serve_lib.ModelUnhealthy as exc:
                    with lock:
                        unhealthy[0] += 1
                    time.sleep(max(exc.retry_in_s, 0.005))
                    continue
                except serve_lib.LaunchFault:
                    with lock:
                        failed.append(i)
                    break
                with lock:
                    served[i] = r
                break

    threads = [threading.Thread(target=client, args=(cid,))
               for cid in range(SERVE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in threads), "chaos clients hung")
    stats = srv.stats("f32")
    kinds = [e[0] for e in srv.trace]
    check(stats["n_ref_retries"] > 0, f"chaos: no retries {stats}")
    check("breaker_open" in kinds and "breaker_close" in kinds,
          f"chaos: breaker events {sorted(set(kinds))}")
    check(srv.health()["models"]["f32"]["breaker"]["state"] == "closed",
          "chaos: the breaker did not close again")
    for i, r in served.items():
        check(same_response(r, t.alone[i]),
              f"chaos request {i}: not bitwise 10b's")
    return {"plan": SERVE_CHAOS, "served": len(served),
            "served_bitwise_10b": len(served),
            "failed_in_outage": len(failed), "breaker_rejections": unhealthy[0],
            "n_launch_faults": stats["n_launch_faults"],
            "retries_by_replay": stats["n_ref_retries"],
            "n_failed": stats["n_failed"], "launches": chaotic.calls["n"],
            "breaker_events": [e for e in srv.trace
                               if e[0].startswith("breaker")]}


def serve_demoted(t) -> dict:
    """10d, demotion on the card: bucket 64 of an f32 tenant fails every
    primary launch transiently (each retried by a replay) until
    ``demote_after`` = 2 demotes it; then its requests fail with
    ``LaunchFault`` (no plain route on the card) while bucket 128 serves
    bitwise 10b's request from its graph."""
    with serve_lib.serve({"f32": t.c}, ServeConfig(
            launch_retries=1, demote_after=2)) as srv:
        entry = srv.registry.get("f32")
        healthy = entry.launch
        flaky = faults.FaultPlan(seed=0, launch_transient_rate=1.0
                                 ).wrap_launch(healthy)
        entry.launch = lambda q, snap: (
            flaky if q.shape[0] == 64 else healthy)(q, snap)
        for i in range(2):
            check(same_response(srv.assign("f32", t.requests[i]),
                                t.alone[i]),
                  "demotion: a retried response differs from 10b's")
        check(entry.demoted_buckets == (64,),
              f"demotion: demoted {entry.demoted_buckets}")
        why = raises(lambda: srv.assign("f32", t.requests[2]), "demoted")
        pair = np.concatenate([t.requests[3], t.requests[4]])
        r = srv.assign("f32", pair)
        check(r.batch_rows == 128 and same_response(
            types.SimpleNamespace(ids=r.ids[:REQ_POINTS],
                                  dists=r.dists[:REQ_POINTS]), t.alone[3]),
              "demotion: bucket 128 not bitwise 10b's")
        stats = srv.stats("f32")
        check(stats["n_failed"] == 1 and stats["n_ref_retries"] == 2,
              f"demotion: stats {stats}")
        return {"demoted_buckets": list(entry.demoted_buckets),
                "raised": why, "n_failed": stats["n_failed"],
                "retries_by_replay": stats["n_ref_retries"]}


def phase_serve(X, res, seed: int, root: Path) -> tuple[dict, dict]:
    """Phase 10: ``repro_torch.api.serve`` on phase 4's fit with the
    default ``ServeConfig`` (buckets 64-4,096): 10a replays against eager
    launches and the plain version, times at buckets 64 and 4,096, 10b the
    closed loop at linger 0 and 2 ms (then again with the launches made
    eagerly, in turns with the graphs, and once under the profiler for the
    card's busy share), 10c the hot swap from checkpoints, 10d chaos and a
    demoted bucket, 10e a failing kernel at registration; between 10b and
    10c a tenant registered under traffic.  Returns ({path:
    (launches, wall)}, {kernel: {tenant_bucket: row}})."""
    t0 = time.monotonic()
    card = nvidia_smi()
    tenants = serve_tenants(X, res, seed)
    models = {name: t.c for name, t in tenants.items()}
    servers, reg_s = {}, {}
    for linger in SERVE_LINGERS:
        t1 = time.monotonic()
        srv = serve_lib.Server(ServeConfig(max_linger_ms=linger))
        for name, t in tenants.items():
            srv.register(name, models[name], precision=t.prec)
        reg_s[linger] = time.monotonic() - t1
        servers[linger] = srv
    try:
        buckets = servers[0.0].config.buckets()
        for srv in servers.values():
            for name in tenants:
                check(srv.recompiles(name) == len(buckets),
                      f"serve {name}: {srv.recompiles(name)} captures")
        errs = serve_replays(servers[0.0], tenants)
        emit({"phase": "serve_replays", "buckets": list(buckets),
              "tenants": {n: t.prec for n, t in tenants.items()},
              "captures_per_tenant": len(buckets), "register_s": reg_s,
              "max_abs_err_d": errs, "bitwise_eager": True, "card": card})
        times = serve_times(servers[0.0], tenants)
        paths, rows = serve_traffic(servers, tenants)
        serve_graph_vs_eager(servers, tenants)
        serve_busy_share(servers[0.0], tenants)
        emit({"phase": "serve_late_register", **serve_late_register(
            servers[2.0], tenants["f32"]), "card": card})
        swap = serve_hot_swap(servers[2.0], tenants["f32"], root)
        emit({"phase": "serve_hot_swap", **swap, "card": card})
    finally:
        for srv in servers.values():
            srv.close()
    with serve_lib.serve({"f32": tenants["f32"].c}, ServeConfig(
            breaker_backoff_s=0.05, breaker_backoff_max_s=0.2,
            demote_after=0)) as chaos_srv:
        chaos = serve_chaos(chaos_srv, tenants["f32"])
    emit({"phase": "serve_chaos", **chaos, "card": card})
    emit({"phase": "serve_demoted", **serve_demoted(tenants["f32"]),
          "card": card})
    failing = {}
    with serve_lib.Server(ServeConfig()) as srv:
        for prec in POLICIES:
            with faults.kernel_failure("assign"):
                failing[prec] = raises(
                    lambda: srv.register(f"broken_{prec}", res.centroids,
                                         precision=prec),
                    "injected assign kernel failure")
            check(srv.models() == [], f"{prec}: a failing model registered")
    emit({"phase": "serve_kernel_failure", "raised": failing,
          "registered": [], "wall_s": time.monotonic() - t0, "card": card})
    return paths, times


# --------------------------------------------------------------------------
# phase 11: the §5 baselines on the card at HEPMASS scale
# --------------------------------------------------------------------------

BASELINE_RUNS = ("forgy", "kmeanspp", "kmeans_parallel", "coreset",
                 "da_mssc")
FULL_DATA_LLOYD = ("forgy", "kmeanspp", "kmeans_parallel")
POOL_K = 1 + 2 * 25 * 5         # K-means||'s pool at k = 25 (l = 2k, r = 5)
WARD_ROWS = 20_000              # Ward's cap (core/baselines/ward.py)


def recording_k(seen: dict):
    """Wrap the f32 assign and update wrappers of ``ops._KERNELS`` so that
    each call notes its k in ``seen`` (the wrappers still count their own
    launches); returns the restore function."""
    table = ops._KERNELS["f32"]
    originals = dict(table)

    def note(name, fn, k_of):
        def wrapped(*args, **kwargs):
            k = k_of(*args)
            seen.setdefault(name, {}).setdefault(k, 0)
            seen[name][k] += 1
            return fn(*args, **kwargs)
        return wrapped

    table["assign"] = note("assign", originals["assign"],
                           lambda x, c, *a: c.shape[0])
    table["update"] = note("update", originals["update"],
                           lambda x, ids, k, *a: k)

    def restore():
        table.update(originals)
    return restore


def baseline_fit(X, cfg, name: str, key, f_full_bm: float) -> tuple:
    """One baseline through ``fit`` on the card, counted, against its plain
    twin (``impl="ref"`` on the card, the same key): returns (row,
    launches)."""
    m = X.shape[0]
    seen: dict = {}
    restore = recording_k(seen)
    try:
        ops.reset_launch_counts()
        res = fit(X, cfg, method=name, key=key)
        launches = ops.launch_counts()
    finally:
        restore()
    warm = fit(X, cfg, method=name, key=key)         # warm wall, same bits
    check(torch.equal(warm.centroids, res.centroids),
          f"{name}: a second fit on the same key differs")
    ops.reset_launch_counts()
    plain = fit(X, cfg.replace(impl="ref"), method=name, key=key)
    check(not any(ops.launch_counts().values()),
          f"{name}: the plain twin launched a kernel")
    _, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, f_full = evaluate(res, X)
    eval_s = time.monotonic() - t0
    _, f_plain = evaluate(plain, X)
    counts = np.asarray(res.extras["counts"], np.float64)
    check(res.algorithm == name and res.strategy is None,
          f"{name}: algorithm {res.algorithm}, strategy {res.strategy}")
    check(res.extras["fit"]["impl"] == "cuda" and res.centroids.is_cuda,
          f"{name}: the fit did not run the kernels on the card")
    check(tuple(res.centroids.shape) == (cfg.k, X.shape[1])
          and bool(torch.isfinite(res.centroids).all()),
          f"{name}: centroids")
    check(math.isfinite(f_full) and f_full > 0, f"{name}: full objective")
    rel = (f_full - f_plain) / f_plain
    check(f_full <= f_plain * (1 + 1e-3),
          f"{name}: full objective {f_full} above the plain twin's "
          f"{f_plain} by {rel:.3e} (> 1e-3)")
    if name in FULL_DATA_LLOYD:
        check(counts.sum() == m, f"{name}: counts sum {counts.sum()} != {m}")
        check(launches["fused_step"] > 0, f"{name}: kernel A not launched")
    if name == "coreset":
        # Σw estimates m without bias; its deviation is at most 2m/√s
        check(abs(counts.sum() - m) <= 0.05 * m,
              f"coreset: weights sum {counts.sum()} far from {m}")
        check(res.extras["objective_scope"] == "weighted coreset",
              "coreset: objective scope")
    if name == "da_mssc":
        check(res.n_chunks == cfg.n_chunks
              and counts.sum() == res.n_chunks * cfg.s,
              f"da_mssc: pool weights sum {counts.sum()} != q * s")
    if name == "kmeans_parallel":
        check(seen.get("assign", {}).get(POOL_K, 0) == 1
              and seen.get("update", {}).get(POOL_K, 0) == 1,
              f"kmeans_parallel: B and C at k = {POOL_K}: {seen}")
    # the weighted steps' sums and counts are plain (ops.update): the
    # coreset's only Lloyd is weighted, so it launches B alone
    check(launches["assign"] > 0
          and (launches["update"] > 0) == (name != "coreset"),
          f"{name}: B and C launches: {launches}")
    row = {"phase": "baselines", "method": name, "f_full": f_full,
           "f_full_per_point": f_full / m, "objective": res.objective,
           "f_full_plain": f_plain, "f_full_rel_diff": rel,
           "f_full_big_means": f_full_bm,
           "f_full_over_big_means": f_full / f_full_bm,
           "fit_wall_s": res.wall_time_s, "fit_wall_warm_s":
           warm.wall_time_s, "plain_fit_wall_s": plain.wall_time_s,
           "evaluate_warm_s": eval_s, "n_iterations": res.n_iterations,
           "n_chunks": res.n_chunks, "counts_sum": counts.sum(),
           "launches": {"A": launches["fused_step"],
                        "B": launches["assign"], "C": launches["update"]},
           "launches_by_k": seen,
           "seeding_launches": {k: launches[k] for k in SEEDING},
           "other_launches": {k: v for k, v in launches.items()
                              if v and k not in ("fused_step", "assign",
                                                 "update") + SEEDING}}
    check(not row["other_launches"], f"{name}: {row['other_launches']}")
    emit(row)
    return row, launches


def weighted_alone(X, seed: int) -> dict:
    """11b: a weighted Lloyd on a 64,000-row coreset against its plain
    twin, from the same weighted K-means++ start."""
    from repro_torch.core import kmeans as kmeans_lib
    from repro_torch.core.baselines import coreset
    from repro_torch.core.kmeanspp import kmeanspp

    ka, kb = rnd.TORCH.split(rnd.TORCH.key(seed + 12))
    C, w = coreset.sample(X, ka, 64_000)
    c0 = kmeanspp(C, kb, 25, weights=w)
    ops.reset_launch_counts()
    res = kmeans_lib.lloyd(C, c0, weights=w)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    plain = kmeans_lib.lloyd(C, c0, weights=w, impl="ref")
    check(launches["fused_step"] == 0 and launches["update"] == 0
          and launches["assign"] == res.iterations + 1,
          f"weighted Lloyd launches {launches} for {res.iterations} "
          "iterations (B once a step and in the epilogue)")
    ties = near_ties(C, res.centroids)
    off = ~ties
    same = bool(torch.equal(res.assignments[off], plain.assignments[off]))
    f, f_plain = float(res.objective), float(plain.objective)
    rel = (f - f_plain) / f_plain
    row = {"phase": "baselines_weighted", "rows": C.shape[0],
           "iterations": res.iterations,
           "iterations_plain": plain.iterations, "objective": f,
           "objective_plain": f_plain, "rel_diff": rel,
           "near_ties": int(ties.sum()), "ids_equal_off_ties": same,
           "weights_sum": float(w.sum()),
           "launches": {"A": launches["fused_step"], "B": launches["assign"],
                        "C": launches["update"]}}
    emit(row)
    check(same, "weighted Lloyd: ids differ from the plain twin off near "
          "ties")
    check(f <= f_plain * (1 + 1e-3),
          f"weighted Lloyd: objective {f} above the plain twin's {f_plain}")
    return launches


def ward_at_cap(X, cfg) -> tuple:
    """11c: Ward on the first 20,000 rows (its cap) through ``fit``, and its
    refusal one row above it."""
    Xw = X[:WARD_ROWS].contiguous()
    ops.reset_launch_counts()
    res = fit(Xw, cfg, method="ward")
    launches = ops.launch_counts()
    labels = res.extras["labels"]
    f_one = float(torch.sum((Xw - Xw.mean(0)) ** 2))
    refused = raises(lambda: fit(X[:WARD_ROWS + 1], cfg, method="ward"),
                     f"m={WARD_ROWS + 1}")
    emit({"phase": "baselines_ward", "rows": WARD_ROWS,
          "objective": res.objective, "one_cluster_objective": f_one,
          "fit_wall_s": res.wall_time_s,
          "labels_distinct": int(np.unique(labels).size),
          "launches": {k: v for k, v in launches.items() if v},
          "refused_above_cap": refused})
    check(labels.shape == (WARD_ROWS,) and np.unique(labels).size == cfg.k,
          "Ward: k labels")
    check(math.isfinite(res.objective) and res.objective < f_one,
          f"Ward: objective {res.objective} not below one cluster's {f_one}")
    check("MemoryError" in refused, f"Ward above its cap: {refused}")
    return res, launches


def near_ties_rows(x, c, rows: int = 1 << 20) -> torch.Tensor:
    """:func:`near_ties` a block of rows at a time (its [m, k] scores at
    m = 10.5M, k = 251 would be 10.5 GB each)."""
    return torch.cat([near_ties(x[i:i + rows], c)
                      for i in range(0, x.shape[0], rows)])


def hold_baseline_kernels(X, pool) -> dict:
    """11d: B and C at K-means||'s pool (k = 251) over all 10.5M rows and A
    over them at k = 25, each against its plain version on the same
    inputs, as phase 3 holds them: B's ids equal off near ties and its d
    within RTOL of its terms; C on B's ids with counts equal and sums
    within :func:`sums_bound`; A's counts within two per near tie, sums
    within the bound, objective within RTOL.  Returns max abs errors."""
    k = pool.shape[0]
    ties = near_ties_rows(X, pool)
    errs = {"assign_f32": check_assign(X, pool, ties)}
    ids, _ = distance.assign_f32(X, pool)
    sums, counts = twice(upd.update_f32, X, ids, k)
    sums_p, counts_p = upd.update_plain(X, ids, k)
    check(torch.equal(counts, counts_p),
          f"update counts differ at k = {k} over {X.shape[0]} rows")
    err = (sums - sums_p).abs()
    check(bool((err <= sums_bound(X, ids, k, 0)).all()),
          f"update sums off by {float(err.max())} at k = {k}")
    errs["update_f32"] = float(err.max())
    del sums_p, counts_p, err
    c = pool[:25].contiguous()
    ties_c = int(near_ties_rows(X, c).sum())
    errs["fused_step_f32"] = check_fused(X, c, ties_c)
    emit({"phase": "baselines_kernels", "m": X.shape[0], "n": X.shape[1],
          "k_pool": k, "near_ties_pool": int(ties.sum()),
          "near_ties_k25": ties_c, "max_abs_err": errs})
    return errs


def times_baselines(X, pool) -> dict:
    """11d: B and C at the K-means|| pool (k = 251) over all 10.5M rows, and
    A over them at k = 25, held to their plain versions, then timed by
    CUDA-graph replay beside bound, plain version and library call."""
    m, n = X.shape
    k = pool.shape[0]
    errs = hold_baseline_kernels(X, pool)
    ids, _ = distance.assign_f32(X, pool)
    ids64 = ids.long()
    out = {}
    out["assign_f32"] = timing(
        lambda: distance.assign_f32(X, pool),
        lambda: distance.assign_plain(X, pool),
        lambda: torch.mm(X, pool.t()),
        4 * (m * n + k * n + 2 * m), 2 * m * k * n, 1, free_cache=True)
    out["assign_f32"]["library"] = MM_F32
    out["update_f32"] = timing(
        lambda: upd.update_f32(X, ids, k),
        lambda: upd.update_plain(X, ids, k),
        lambda: torch.zeros((k, n), device=X.device).index_add_(0, ids64, X),
        4 * (m * n + m + k * n + k), m * n, 1, free_cache=True)
    out["update_f32"]["library"] = "index_add_ (sums only; counts excluded)"
    c = pool[:25].contiguous()
    nbytes, flops, peak = fused_cost("f32", m, 25, n)
    out["fused_step_f32"] = timing(
        lambda: fused_step.fused_step_f32(X, c),
        lambda: fused_step.fused_step_plain(X, c), None, nbytes, flops, 1,
        peak, free_cache=True)
    for name, row in out.items():
        row.update(m=m, k=k if name != "fused_step_f32" else 25, n=n,
                   max_abs_err=errs[name])
        emit({"phase": "baselines_times", "kernel": name, **row})
    return out


def time_seed(X, seed: int, k: int = 25, candidates: int = 3) -> dict:
    """11e: ``kmeanspp`` seeding all 10.5M rows alone, as the ``kmeanspp``
    baseline does once a start (warm, host wall around a synchronised
    call); then kernel P, which ``seed`` does not call, held to its plain
    version and timed at the probe one slot of that seeding gives it
    (10.5M rows, three candidates), as phase 6 times it at a chunk.
    Returns P's timing row."""
    from repro_torch.core.kmeanspp import kmeanspp

    m, n = X.shape
    key = rnd.TORCH.key(seed + 13)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = kmeanspp(X, key, k, candidates=candidates)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.monotonic() - t0))
    check(tuple(c.shape) == (k, n) and bool(torch.isfinite(c).all()),
          "kmeanspp seeding at full data")
    cands, d = seeding_probe(X, seed)
    L = cands.shape[0]
    err = check_kpp(X, cands, d, "full data")
    row = timing(
        lambda: kpp.kpp_probe_cuda(X, cands, d),
        lambda: kpp.kpp_probe_plain(X, cands, d), None,
        *kpp_cost(m, n, L), 3, free_cache=True)
    row.update(m=m, n=n, L=L, max_abs_err=err,
               library="none (no single call computes it)")
    emit({"phase": "baselines_seed", "m": m, "n": n, "k": k,
          "candidates": L, "seed_ms_first": walls[0],
          "seed_ms_warm": min(walls[1:]), "seed_ms": walls,
          "kpp_probe_ms": row["ms"], "kpp_probe_plain_ms": row["plain_ms"],
          "kpp_probe_bound_ms": row["bound_ms"],
          "probes_a_seeding": k, "probes_ms_plain": k * row["plain_ms"],
          "probes_ms_kernel": k * row["ms"]})
    return row


def phase_baselines(X, f_full_bm: float, seed: int) -> tuple:
    """Phase 11: the §5 baselines through ``fit(method=...)`` at HEPMASS
    scale, each against its plain twin; the weighted path alone; Ward at
    its cap; B, C at the K-means|| pool and A over the full data held to
    their plain versions and timed; the full-data seeding timed."""
    t_phase = time.monotonic()
    torch.cuda.empty_cache()        # the plain K-means|| twin peaks ~33 GB
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed)
    total = {name: 0 for name in ops.launch_counts()}
    walls = 0.0
    for i, name in enumerate(BASELINE_RUNS):
        key = rnd.TORCH.fold_in(rnd.TORCH.key(seed + 11), i)
        row, launches = baseline_fit(X, cfg, name, key, f_full_bm)
        for k, v in launches.items():
            total[k] += v
        walls += row["fit_wall_s"]
        torch.cuda.empty_cache()
    for k, v in weighted_alone(X, seed).items():
        total[k] += v
    _, ward_launches = ward_at_cap(X, cfg)
    for k, v in ward_launches.items():
        total[k] += v
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    pool = X[torch.randint(0, X.shape[0], (POOL_K,), generator=gen,
                           device=X.device)].contiguous()
    times = times_baselines(X, pool)
    torch.cuda.empty_cache()
    times["kpp_probe"] = time_seed(X, seed)
    emit({"phase": "baselines_done", "seconds": time.monotonic() - t_phase,
          "launches": {k: v for k, v in total.items() if v}})
    return (total, walls), times



# --------------------------------------------------------------------------
# phase 12: multi-device and multi-host on the one card
# --------------------------------------------------------------------------

WORKERS = 4         # phase 12's worker mesh, and its stream groups


class StopAfter(mw.Middleware):
    """Stops a rounds loop once ``windows`` windows are done."""

    def __init__(self, windows: int):
        self.windows = windows

    def should_stop(self, ctx) -> bool:
        return ctx.step >= self.windows


def sharded_incumbents(trace, workers: int, sync_every: int) -> list:
    """The incumbent f each chunk of a worker-major sharded trace was
    compared with: the worker's own, set to the minimum over the workers
    after every window of ``sync_every`` chunks."""
    cpw = len(trace) // workers
    f = [math.inf] * workers
    out = [math.inf] * len(trace)
    for r in range(cpw // sync_every):
        for w in range(workers):
            for j in range(r * sync_every, (r + 1) * sync_every):
                i = w * cpw + j
                out[i] = f[w]
                if trace[i][2]:
                    f[w] = trace[i][1]
        f = [min(f)] * workers
    return out


def check_sharded_accepts(res, twin, workers: int, sync_every: int):
    """The kernels and the plain twin take the same accept decisions up to
    the first near tie (f_new within TIE_RTOL of its incumbent on either
    path), as phase 5 holds them."""
    parting = first_parting(res.trace, twin.trace)
    if parting is None:
        return None
    i = parting["chunk"]
    near = [abs(tr[i][1] - inc[i]) <= TIE_RTOL * abs(inc[i])
            for tr, inc in ((res.trace, sharded_incumbents(
                                res.trace, workers, sync_every)),
                            (twin.trace, sharded_incumbents(
                                twin.trace, workers, sync_every)))]
    check(any(near), f"sharded accept sequences part at chunk {i} without "
          f"a near tie: {parting}")
    return parting


def phase_sharded(X, seed: int, f_full_seq: float, card: str) -> tuple:
    """12a: ``fit(method="sharded")`` on phase 4's data: 4 workers on a
    1-axis worker mesh and on a (2, 2) mesh over ("data", "model"), 8
    chunks a worker, ``sync_every=2``; each with ``evaluate``, against its
    plain twin (the full-data objective within 1e-3, the accept sequence
    up to near ties), A once per Lloyd iteration of every worker's chunk
    and the epilogue's B and C once a chunk, the full-data objective at
    most 1.15x phase 4's sequential fit's.  The fit walls in turns with
    the sequential fit.  Returns ({path: (launches, wall)}, the 1-axis
    fit's row)."""
    m, n = X.shape
    n_eval = math.ceil(m / EVAL_BATCH)
    base = BigMeansConfig(k=25, s=64_000, n_chunks=32,
                          sync_every=SYNC_EVERY, seed=seed)
    cpw = base.n_chunks // WORKERS
    meshes = {"sharded": TopologySpec(kind="worker_mesh", devices=WORKERS),
              "sharded_2x2": TopologySpec(kind="worker_mesh", devices=(2, 2),
                                          axes=("data", "model"))}
    fit(X, base.replace(n_chunks=2 * WORKERS, seed=seed + 1,
                        topology=meshes["sharded"]), method="sharded")
    paths, rows, fits = {}, {}, {}
    for name, spec in meshes.items():
        cfg = base.replace(topology=spec)
        ops.reset_launch_counts()
        t0 = time.monotonic()
        res = fit(X, cfg, method="sharded")
        ids, f_full = evaluate(res, X)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = ops.launch_counts()
        check(res.strategy == "sharded" and res.extras["workers"] == WORKERS
              and res.extras["chunks_per_worker"] == cpw,
              f"{name}: {res.strategy}, {res.extras}")
        check(res.extras["fit"]["impl"] == "cuda" and res.centroids.is_cuda,
              f"{name} did not run on the kernels")
        check(tuple(res.centroids.shape) == (25, n)
              and bool(torch.isfinite(res.centroids).all()),
              f"{name} centroids")
        check(tuple(ids.shape) == (m,) and math.isfinite(f_full),
              f"{name} evaluate")
        check(res.n_chunks == base.n_chunks == len(res.trace),
              f"{name} trace length {len(res.trace)}")
        want = seeded_zeros(launches)
        want.update(fused_step=res.n_iterations, update=base.n_chunks,
                    assign=base.n_chunks + n_eval)
        check(launches == want, f"{name} launches {launches} != {want}")
        twin = fit(X, cfg.replace(impl="ref"), method="sharded")
        _, f_twin = evaluate(twin, X, impl="ref")
        rel = abs(f_full - f_twin) / f_twin
        check(rel <= 1e-3, f"{name}: full objectives differ by {rel:.3e}")
        parting = check_sharded_accepts(res, twin, WORKERS, SYNC_EVERY)
        ratio = f_full / f_full_seq
        check(ratio <= 1.15, f"{name}: full objective {ratio:.4f}x the "
              "sequential fit's (> 1.15)")
        rows[name] = {
            "workers": WORKERS, "chunks_per_worker": cpw,
            "sync_every": SYNC_EVERY, "devices": spec.devices,
            "axes": spec.axes or ("data",),
            "f_best": res.objective, "f_full": f_full,
            "f_full_ratio_to_sequential": ratio,
            "n_accepted": res.n_accepted, "n_iterations": res.n_iterations,
            "launches": launches, "wall_s": wall,
            "fit_wall_s": res.wall_time_s,
            "twin": {"f_full": f_twin, "n_accepted": twin.n_accepted,
                     "fit_wall_s": twin.wall_time_s},
            "f_full_rel_diff": rel, "first_parting": parting,
            "accepts": [int(a) for _, _, a in res.trace],
            "accepts_twin": [int(a) for _, _, a in twin.trace]}
        paths[name] = (launches, wall)
        fits[name] = res
    a, b = fits["sharded"], fits["sharded_2x2"]
    check(torch.equal(a.centroids, b.centroids) and a.trace == b.trace,
          "the (2, 2) worker mesh differs from the 1-axis one (the same "
          "4 workers)")
    walls = {"sequential": [], "sharded": []}      # fit walls, in turns
    for method in ("sequential", "sharded", "sharded", "sequential"):
        cfg = base.replace(topology=meshes["sharded"]) \
            if method == "sharded" else base
        walls[method].append(fit(X, cfg, method=method).wall_time_s)
    host_profile("sharded", lambda: fit(
        X, base.replace(topology=meshes["sharded"]), method="sharded"))
    for name, row in rows.items():
        emit({"phase": f"multi_{name}", **row, "card": card})
    emit({"phase": "multi_sharded_walls", "fit_walls_in_turns_s": walls,
          "card": card})
    return paths, rows["sharded"]


def phase_sharded_resume(X, seed: int, root: Path, card: str) -> dict:
    """12b: the sharded fit with ``ckpt_dir`` (a checkpoint every window,
    by window index): the run stopped after window 2 and resumed through
    ``fit`` is bitwise the uninterrupted fit, its trace windows 2-3 of
    each worker, and its newest checkpoint bitwise the uninterrupted
    one's."""
    base = BigMeansConfig(k=25, s=64_000, n_chunks=32, seed=seed,
                          sync_every=SYNC_EVERY, ckpt_every=SYNC_EVERY,
                          topology=TopologySpec(kind="worker_mesh",
                                                devices=WORKERS))
    cpw = base.n_chunks // WORKERS
    u_dir, r_dir = str(root / "sharded_U"), str(root / "sharded_R")
    full = fit(X, base.replace(ckpt_dir=u_dir), method="sharded")
    _, infos, ctx = incore.worker_sharded_rounds(
        X, rnd.TORCH.key(seed), mesh=topo_lib.make_mesh((WORKERS,),
                                                        ("data",)),
        k=base.k, s=base.s, chunks_per_worker=cpw, sync_every=SYNC_EVERY,
        middlewares=[mw.Checkpoint(r_dir, SYNC_EVERY, SYNC_EVERY,
                                   step_from="step"), StopAfter(2)])
    check(ctx.step == 2 and infos.f_new.numel() == 2 * SYNC_EVERY * WORKERS
          and ckpt_lib.latest_step(r_dir) == 2,
          f"sharded split stopped at window {ctx.step}")
    ops.reset_launch_counts()
    t0 = time.monotonic()
    resumed = fit(X, base.replace(ckpt_dir=r_dir), method="sharded")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    check(resumed.extras["rounds_done"] == cpw // SYNC_EVERY
          and len(resumed.extras["checkpoint"]["restore_ms"]) == 1,
          f"sharded resume: {resumed.extras}")
    check(torch.equal(resumed.centroids, full.centroids)
          and resumed.objective == full.objective
          and resumed.n_accepted == full.n_accepted
          and resumed.n_dist_evals == full.n_dist_evals,
          "the resumed sharded fit differs from the uninterrupted one")
    tail = [t[1:] for w in range(WORKERS)
            for t in full.trace[w * cpw + 2 * SYNC_EVERY:(w + 1) * cpw]]
    check([t[1:] for t in resumed.trace] == tail,
          "the resumed sharded trace differs from windows 2-3")
    same_checkpoints(r_dir, u_dir, "sharded resume")
    want = seeded_zeros(launches)
    want.update(fused_step=resumed.n_iterations, update=resumed.n_chunks,
                assign=resumed.n_chunks)
    check(launches == want, f"sharded resume launches {launches}")
    emit({"phase": "multi_sharded_resume", "bitwise_uninterrupted": True,
          "stopped_after_window": 2, "resumed_chunks": resumed.n_chunks,
          "steps": ckpt_lib.steps(r_dir), "launches": launches,
          "uninterrupted_fit_s": full.wall_time_s,
          "resumed_fit_s": resumed.wall_time_s,
          "save_ms": full.extras["checkpoint"]["save_ms"],
          "restore_ms": resumed.extras["checkpoint"]["restore_ms"],
          "card": card})
    return {"sharded_resume": (launches, wall)}


def phase_stream_mesh(X, seed: int, res_b, f_full_b: float,
                      card: str) -> dict:
    """12c: phase 5's batched fit (``batch=8, sync_every=2``) on a
    4-group stream mesh: bitwise phase 5's (centroids, f_best, accepts and
    each chunk's f_new, the trace group-major), and kernel D launched once
    per Lloyd iteration of each group's slowest stream."""
    m = X.shape[0]
    n_eval = math.ceil(m / EVAL_BATCH)
    cfg = BigMeansConfig(k=25, s=64_000, n_chunks=32, batch=BATCH,
                         sync_every=SYNC_EVERY, seed=seed)
    spec = TopologySpec(kind="stream_mesh", devices=WORKERS)
    rounds, bl = cfg.n_chunks // BATCH, BATCH // WORKERS
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = fit(X, cfg.replace(topology=spec))
    _, f_full = evaluate(res, X)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    check(res.strategy == "batched", f"stream mesh ran {res.strategy}")
    check(torch.equal(res.centroids, res_b.centroids)
          and res.objective == res_b.objective
          and res.n_accepted == res_b.n_accepted and f_full == f_full_b,
          "the stream-mesh fit differs from phase 5's")
    # group-major (group, round, stream) -> phase 5's round-major order
    order = [r * BATCH + g * bl + j for g in range(WORKERS)
             for r in range(rounds) for j in range(bl)]
    check([t[1:] for t in res.trace]
          == [res_b.trace[i][1:] for i in order],
          "the stream-mesh trace differs from phase 5's")
    ops.reset_launch_counts()
    _, infos = big_means_batched(
        X, rnd.TORCH.key(seed), k=cfg.k, s=cfg.s, batch=BATCH, rounds=rounds,
        sync_every=SYNC_EVERY,
        mesh=topo_lib.make_mesh((WORKERS,), ("streams",)))
    iters = infos.lloyd_iters.view(WORKERS, rounds, bl)
    slowest = int(iters.max(dim=2).values.sum())
    check(ops.launch_counts()["fused_step_batched"] == slowest,
          "kernel D launches != the groups' slowest streams' iterations")
    want = seeded_zeros(launches)
    want.update(fused_step_batched=slowest, update=cfg.n_chunks,
                assign=cfg.n_chunks + n_eval)
    check(launches == want, f"stream mesh launches {launches} != {want}")
    emit({"phase": "multi_stream_mesh", "groups": WORKERS,
          "streams_per_group": bl, "bitwise_phase5": True,
          "f_full": f_full, "launches": launches,
          "slowest_group_stream_iterations_sum": slowest, "wall_s": wall,
          "fit_wall_s": res.wall_time_s,
          "phase5_fit_wall_s": res_b.wall_time_s, "card": card})
    return {"stream_mesh": (launches, wall)}


HOST_RANK = r"""
import json, os, sys, time
import numpy as np
import torch
from repro_torch.api import BigMeansConfig, MemmapSource, TopologySpec, fit
from repro_torch.engine import hostmesh
from repro_torch.engine.faults import HostDead
from repro_torch.kernels import build, ops

path, seed, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
timeout_s = float(sys.argv[4])
rank = int(os.environ[hostmesh.ENV_RANK])
build.load()
gathers = []
allgather = hostmesh.HostRuntime.allgather


def timed(self, tag, payload):
    t0 = time.perf_counter()
    try:
        return allgather(self, tag, payload)
    finally:
        gathers.append([tag, 1e3 * (time.perf_counter() - t0)])


hostmesh.HostRuntime.allgather = timed
spec = TopologySpec(kind="host_mesh", sync_timeout_s=timeout_s)
base = BigMeansConfig(k=25, s=64_000, n_chunks=32, batch=4, seed=seed,
                      log_every=0, topology=spec)
out = {"rank": rank, "built_here": build.info().built,
       "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules)}
if mode == "run":
    fit(path, base.replace(n_chunks=8))     # warm: first-use costs
    for name, sync_every in (("fold", 1), ("persistent", 2)):
        ops.reset_launch_counts()
        gathers.clear()
        r = fit(path, base.replace(sync_every=sync_every))
        torch.cuda.synchronize()
        out[name] = {
            "objective": r.objective, "centroids": r.centroids.tolist(),
            "n_accepted": r.n_accepted, "n_iterations": r.n_iterations,
            "n_dist_evals": r.n_dist_evals, "wall_s": r.wall_time_s,
            "host": r.extras["host"], "ranks": r.extras["health"]["ranks"],
            "syncs": [t[1] for t in r.trace if t[0] == "host_sync"],
            "launches": ops.launch_counts(), "gather_ms": list(gathers)}
else:   # rank 1 dies on its first own chunk; rank 0 must raise HostDead
    fetch = MemmapSource(path).provider(base.s, seed=seed)

    def provider(cid):
        if rank == 1 and cid in (2, 3):
            os._exit(3)
        return fetch(cid)

    t0 = time.monotonic()
    try:
        fit(provider, base.replace(prefetch=0), n_features=28)
        out["host_dead"] = False
    except HostDead as e:
        out.update(host_dead=True, window=e.window, dead_rank=e.rank,
                   health=e.health, gather_ms=list(gathers),
                   run_s=time.monotonic() - t0)
print("RESULT " + json.dumps(out), flush=True)
"""


def rank_results(procs, what: str) -> list:
    outs = []
    for p in procs:
        lines = [ln for ln in p.output.splitlines()
                 if ln.startswith("RESULT ")]
        check(bool(lines), f"{what}: rank {p.rank} (exit {p.returncode}) "
              f"printed no result: {p.output[-2000:]}")
        outs.append(json.loads(lines[-1][len("RESULT "):]))
    return outs


def phase_host_mesh(path: str, seed: int, card: str) -> dict:
    """12d: two ranks on the one card from the port's ``launch_local``,
    each streaming phase 7's ``.npy`` with ``topology="host_mesh"``,
    ``batch=4`` (two streams a rank), fold and ``sync_every=2``: each rank
    bitwise the single-process streaming fit of the same config, the
    per-rank health reconciled, the ranks' launches (D once per Lloyd
    iteration of their batched steps, B and C once a chunk), the store's
    round trips (each rank warmed by a fit of 8 chunks first); the ranks
    load the kernels the parent built, and import no jax.  Then a rank killed at its first own chunk: its peer raises
    ``HostDead`` at window 0 within ``sync_timeout_s``."""
    env = {"PYTHONPATH": str(ROOT / "src")}
    base = BigMeansConfig(k=25, s=64_000, n_chunks=32, batch=4, seed=seed,
                          log_every=0)
    single = {}
    for name, sync_every in (("fold", 1), ("persistent", 2)):
        single[name] = fit(path, base.replace(sync_every=sync_every))
    t0 = time.monotonic()
    procs = hostmesh.launch_local(
        [sys.executable, "-c", HOST_RANK, path, str(seed), "run", "60"], 2,
        timeout_s=300, env_extra=env)
    wall = time.monotonic() - t0
    outs = rank_results(procs, "host mesh")
    check([p.returncode for p in procs] == [0, 0],
          f"host mesh ranks exited {[p.returncode for p in procs]}")
    total = {}
    for out in outs:
        check(not out["jax"] and not out["built_here"],
              f"rank {out['rank']}: jax imported or kernels rebuilt")
        for name, want in single.items():
            got = out[name]
            check(got["objective"] == want.objective
                  and np.array_equal(np.asarray(got["centroids"],
                                                dtype=np.float32),
                                     want.centroids.cpu().numpy())
                  and got["n_accepted"] == want.n_accepted
                  and got["n_iterations"] == want.n_iterations,
                  f"rank {out['rank']} {name} differs from the "
                  "single-process fit")
            check(got["host"]["processes"] == 2
                  and [h["rank"] for h in got["ranks"]] == [0, 1]
                  and all(h["chunks_done"] == 16 and h["chunks_fetched"]
                          == 16 for h in got["ranks"]),
                  f"rank {out['rank']} {name} health {got['ranks']}")
            lc = got["launches"]
            check(lc["fused_step"] == 0 and lc["fused_step_batched"] > 0
                  and lc["assign"] == lc["update"] == 16,
                  f"rank {out['rank']} {name} launches {lc}")
            for kname, v in lc.items():
                total[kname] = total.get(kname, 0) + v
    check(outs[0]["fold"]["syncs"] == list(range(8)) + ["final"]
          and outs[0]["persistent"]["syncs"] == [1, 3, 5, 7, "final"],
          f"host syncs {outs[0]['fold']['syncs']}, "
          f"{outs[0]['persistent']['syncs']}")
    rows = {name: {
        "single_process_fit_s": single[name].wall_time_s,
        "rank_fit_s": [o[name]["wall_s"] for o in outs],
        "gathers": len(outs[0][name]["gather_ms"]),
        "gather_ms_median": [float(np.median([g[1] for g in o[name][
            "gather_ms"]])) for o in outs],
        "gather_ms": [o[name]["gather_ms"] for o in outs],
        "n_dist_evals": [o[name]["n_dist_evals"] for o in outs],
        "single_n_dist_evals": single[name].n_dist_evals}
        for name in single}

    t1 = time.monotonic()
    timeout_s = 10.0
    procs = hostmesh.launch_local(
        [sys.executable, "-c", HOST_RANK, path, str(seed), "killed",
         str(timeout_s)], 2, timeout_s=180, env_extra=env)
    killed_wall = time.monotonic() - t1
    outs = rank_results(procs[:1], "host mesh, killed peer")
    dead = outs[0]
    failing = [g[1] for g in dead.get("gather_ms", []) if g[0] == "x0"]
    check(procs[1].returncode == 3 and dead["host_dead"]
          and dead["window"] == 0 and dead["dead_rank"] == 0
          and dead["health"]["chunks_done"] == 2
          and failing and failing[0] <= 1e3 * (timeout_s + 2.0),
          f"killed peer: {dead}, rank 1 exit {procs[1].returncode}")
    emit({"phase": "multi_host_mesh", "ranks": 2, "batch": 4,
          "bitwise_single_process": True, "launch_wall_s": wall,
          "launches_both_ranks": total, "modes": rows,
          "killed_peer": {"host_dead_window": dead["window"],
                          "sync_timeout_s": timeout_s,
                          "failing_gather_ms": failing[0],
                          "survivor_run_s": dead["run_s"],
                          "survivor_health": dead["health"],
                          "launch_wall_s": killed_wall},
          "card": card})
    return {"host_mesh": (total, wall)}


def phase_multi(X, path: str, seed: int, root: Path, f_full_seq: float,
                res_b, f_full_b: float) -> dict:
    """Phase 12: 12a sharded, 12b sharded resume, 12c the stream mesh,
    12d the host mesh.  Returns {path: (launches, wall)}."""
    t0 = time.monotonic()
    card = nvidia_smi()
    paths, _ = phase_sharded(X, seed, f_full_seq, card)
    paths.update(phase_sharded_resume(X, seed, root, card))
    paths.update(phase_stream_mesh(X, seed, res_b, f_full_b, card))
    t_host = time.monotonic()
    paths.update(phase_host_mesh(path, seed, card))
    emit({"phase": "multi_walls", "in_core_s": t_host - t0,
          "host_mesh_s": time.monotonic() - t_host,
          "wall_s": time.monotonic() - t0, "card": card})
    return paths


# --------------------------------------------------------------------------
# phase 13: the reproduction suite (repro_torch.evalsuite), the paper's
# workload config and the chunk roofline
# --------------------------------------------------------------------------

# A committed f* (7 significant digits: at most 5e-7 off the run's
# value) reproduces within this.
SUITE_F_STAR_RTOL = 1e-6
# The kernels each suite tier must launch in-process (the host cell's ranks
# launch theirs in their own processes).
SUITE_KERNELS = {
    "quick": ("fused_step", "fused_step_batched", "assign", "update"),
    "full": ("fused_step", "fused_step_batched", "fused_step_batched_bf16",
             "fused_step_batched_int8", "assign", "update"),
}
# 13b runs the host cell on the quick tier's datasets only (each fleet is
# two new processes on the card)
HOST_CELL = "bm/hostmesh-2p"


def suite_doc_checks(doc, what: str) -> None:
    """The port's validator and the row contract: every row finite on the
    card, every Big-means row at its dataset's chunk budget."""
    errors = suite_schema.validate(doc, suite_schema.SUITE_SCHEMA)
    check(not errors, f"{what}: schema errors {errors[:3]}")
    budget = {d["name"]: d["n_chunks"] for d in doc["datasets"]}
    for r in doc["rows"]:
        check(math.isfinite(r["f_full"]) and r["f_full"] > 0,
              f"{what}: {r['dataset']} {r['method']} f_full {r['f_full']}")
        check(r["fit"]["impl"] == "cuda" and r["fit"]["device"]
              .startswith("cuda"), f"{what}: {r['method']} fit {r['fit']}")
        if r["kind"] == "bigmeans":
            check(r["n_chunks"] == budget[r["dataset"]],
                  f"{what}: {r['dataset']} {r['method']} ran "
                  f"{r['n_chunks']} chunks")
    check(doc["host"]["backend"] == "cuda" and doc["host"]["device"]
          == torch.cuda.get_device_name(0), f"{what}: host {doc['host']}")


def suite_cells(doc) -> list:
    return [{key: c[key] for key in (
        "dataset", "method", "n_seeds", "epsilon_mean", "epsilon_min",
        "epsilon_max", "success_rate", "wall_mean_s")} for c in doc["cells"]]


def run_tier(tier: str, root: Path, **kw) -> tuple:
    """``run_suite`` on the card with the launch counts set to 0 just
    before it; returns (doc, launches, seconds)."""
    ops.reset_launch_counts()
    t0 = time.monotonic()
    doc = suite.run_suite(tier, data_root=str(root), verbose=False, **kw)
    torch.cuda.synchronize()
    return doc, ops.launch_counts(), time.monotonic() - t0


def merge_suite(docs: list) -> dict:
    """One suite document from runs over parts of one tier's matrix: each
    dataset's f* the committed one, or (bootstrap) the best f_full of all
    the runs' rows; ε, success and the cells recomputed with the port's
    metrics."""
    first = docs[0]
    rows = [dict(r) for d in docs for r in d["rows"]]
    records = {}
    for d in docs:
        for rec in d["datasets"]:
            records.setdefault(rec["name"], dict(rec))
    for name, rec in records.items():
        if rec["f_star_source"] != "committed":
            rec["f_star"] = min(r["f_full"] for r in rows
                                if r["dataset"] == name)
    for r in rows:
        r["epsilon"] = suite_metrics.relative_error(
            r["f_full"], records[r["dataset"]]["f_star"])
        r["success"] = r["epsilon"] <= first["success_tol"]
    kinds = {}
    for r in rows:
        kinds.setdefault((r["dataset"], r["method"]), r["kind"])
    cells = [suite_metrics.aggregate_cell(
        ds_name, method, kind,
        [r for r in rows if (r["dataset"], r["method"]) == (ds_name,
                                                            method)],
        success_tol=first["success_tol"])
        for (ds_name, method), kind in kinds.items()]
    doc = dict(first, rows=rows, datasets=list(records.values()),
               cells=cells)
    suite_schema.check(doc, suite_schema.SUITE_SCHEMA, what="merged suite")
    return doc


def host_cell_bitwise(doc, root: Path) -> int:
    """Each host-cell row's f_native bitwise the single-process streaming
    fit of its config on the card; returns the rows checked."""
    m = next(x for x in suite.METHODS if x.name == HOST_CELL)
    over = {k: v for k, v in m.overrides.items() if k != "hosts"}
    n = 0
    for r in doc["rows"]:
        if r["method"] != HOST_CELL:
            continue
        spec = suite_ds.get_dataset(r["dataset"])
        cfg = BigMeansConfig(k=spec.k, s=spec.s, n_chunks=spec.n_chunks,
                             seed=r["seed"], log_every=0, **over)
        one = fit(suite_ds.source(spec, str(root)), cfg, method="streaming")
        check(one.objective == r["f_native"] and one.n_chunks
              == r["n_chunks"], f"host cell {r['dataset']} seed "
              f"{r['seed']}: {r['f_native']}, {r['n_chunks']} chunks "
              f"against one process's {one.objective}, {one.n_chunks}")
        n += 1
    return n


def phase_suite_quick(root: Path, card: str) -> tuple:
    """13a: the quick tier, every quick method (the host cell too), seeds
    0 and 1."""
    doc, launches, secs = run_tier("quick", root)
    suite_doc_checks(doc, "13a quick tier")
    check({c["method"] for c in doc["cells"]}
          == set(suite.list_methods("quick")), "13a: quick methods")
    missing = [k for k in SUITE_KERNELS["quick"] if not launches[k]]
    check(not missing, f"13a: kernels not launched {missing}")
    t0 = time.monotonic()
    checked = host_cell_bitwise(doc, root)
    emit({"phase": "suite_quick", "seconds": secs, "launches": launches,
          "host_cell_rows_bitwise_one_process": checked,
          "host_cell_check_s": time.monotonic() - t0,
          "datasets": doc["datasets"], "cells": suite_cells(doc),
          "card": card})
    return doc, launches, secs


def phase_suite_full(root: Path, quick_doc, card: str) -> tuple:
    """13b: the full tier, 5 seeds: every in-process method on the five
    datasets, the host cell on the quick tier's datasets (13a's rows for
    the quick tier's seeds, new fleets for the others); one document,
    validated; with f* committed, each dataset's best ε within
    SUITE_F_STAR_RTOL."""
    in_process = [m for m in suite.list_methods("full") if m != HOST_CELL]
    doc_a, launches, secs_a = run_tier("full", root,
                                       method_names=in_process)
    quick_seeds = suite.SEEDS["quick"]
    doc_h, _, secs_h = run_tier(
        "full", root, method_names=[HOST_CELL],
        dataset_names=suite_ds.list_datasets("quick"),
        seeds=[x for x in suite.SEEDS["full"] if x not in quick_seeds])
    reused = {"rows": [r for r in quick_doc["rows"] if r["method"]
                       == HOST_CELL and r["seed"] in quick_seeds],
              "datasets": []}
    doc = merge_suite([doc_a, doc_h, reused])
    suite_doc_checks(doc, "13b full tier")
    missing = [k for k in SUITE_KERNELS["full"] if not launches[k]]
    check(not missing, f"13b: kernels not launched {missing}")
    best = {}
    for rec in doc["datasets"]:
        rows = [r for r in doc["rows"] if r["dataset"] == rec["name"]]
        top = min(rows, key=lambda r: r["f_full"])
        best[rec["name"]] = {"f_best": top["f_full"],
                             "f_best_7g": float(f"{top['f_full']:.7g}"),
                             "method": top["method"], "seed": top["seed"],
                             "epsilon_min": top["epsilon"],
                             "f_star": rec["f_star"],
                             "f_star_source": rec["f_star_source"]}
    emit({"phase": "suite_full", "seconds_in_process": secs_a,
          "seconds_host_cell": secs_h, "host_cell_rows_from_13a":
          len(reused["rows"]), "launches": launches,
          "cpu_capability": torch.backends.cpu.get_cpu_capability(),
          "best": best, "cells": suite_cells(doc), "card": card})
    for name, b in best.items():
        if b["f_star_source"] == "committed":
            check(abs(b["epsilon_min"]) <= SUITE_F_STAR_RTOL,
                  f"13b: {name} best epsilon {b['epsilon_min']:.3e}: the "
                  f"committed f* {b['f_star']} does not reproduce")
    return doc, launches, secs_a + secs_h


def phase_suite_gate(doc, root: Path) -> dict:
    """13c: the gate on the card's own documents: a self-compare exits 0,
    every epsilon_mean raised by 0.2 exits 1, a dropped cell fails with
    "coverage regressed"."""
    import contextlib
    import io

    def run(fresh, name: str) -> tuple:
        base_p, fresh_p = root / "gate_base.json", root / f"gate_{name}.json"
        base_p.write_text(json.dumps(doc))
        fresh_p.write_text(json.dumps(fresh))
        report = root / f"gate_{name}.txt"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = gate.main(["--baseline", str(base_p), "--fresh",
                            str(fresh_p), "--report", str(report)])
        return rc, report.read_text()

    rc_self, _ = run(doc, "self")
    check(rc_self == 0, f"13c: self-compare exited {rc_self}")
    worse = json.loads(json.dumps(doc))
    for cell in worse["cells"]:
        cell["epsilon_mean"] += 0.2
    rc_worse, rep_worse = run(worse, "worse")
    check(rc_worse == 1 and "FAIL" in rep_worse,
          f"13c: epsilon +0.2 exited {rc_worse}")
    dropped = json.loads(json.dumps(doc))
    gone = dropped["cells"].pop()
    rc_drop, rep_drop = run(dropped, "dropped")
    check(rc_drop == 1 and "coverage regressed" in rep_drop,
          f"13c: a dropped cell exited {rc_drop}: {rep_drop[-300:]}")
    out = {"self": rc_self, "epsilon_plus_0.2": rc_worse,
           "dropped_cell": [gone["dataset"], gone["method"], rc_drop],
           "failures_epsilon_plus_0.2": rep_worse.count("FAIL  ")}
    emit({"phase": "suite_gate", **out})
    return out


def phase_workload(X, seed: int, res_b) -> None:
    """13d: ``BigMeansConfig.from_workload(bigmeans_paper.CONFIG,
    n_chunks=32)`` is phase 5's config field by field, and its fit on
    phase 4's data bitwise phase 5's f32 batched fit."""
    cfg = BigMeansConfig.from_workload(paper_cfg.CONFIG, n_chunks=32,
                                       seed=seed)
    want = res_b.config
    differ = [f.name for f in dataclasses.fields(cfg)
              if getattr(cfg, f.name) != getattr(want, f.name)]
    check(not differ and (cfg.k, cfg.s, cfg.batch, cfg.sync_every)
          == (25, 64_000, 8, 2), f"13d: fields differ {differ}")
    res = fit(X, cfg)
    check(res.strategy == "batched" and res.objective == res_b.objective
          and torch.equal(res.centroids, res_b.centroids)
          and res.trace == res_b.trace
          and res.n_iterations == res_b.n_iterations,
          "13d: the workload's fit differs from phase 5's")
    emit({"phase": "suite_workload", "config_equal_phase5": True,
          "bitwise_phase5": True, "k": cfg.k, "s": cfg.s,
          "batch": cfg.batch, "sync_every": cfg.sync_every,
          "fit_wall_s": res.wall_time_s,
          "phase5_fit_wall_s": res_b.wall_time_s})


def phase_roofline(paths: dict, n: int) -> list:
    """13e: ``precision_roofline`` on the chunk rates phases 4 and 5
    measured under each policy: 32 chunks over the ``fit`` wall, Lloyd
    passes a chunk from the fused launches (D's times the batch, over the
    chunks).  An achieved share of 3.35 TB/s above 1 fails.  The measured
    rows go to ``build/chunk_rates.json`` and ``roofline.main`` projects
    them into ``build/roofline_torch.json`` (a ``repro.bench/1`` envelope
    naming the card), whose rows must be the ones computed here."""
    rows, measured = [], []
    for prec in POLICIES:
        suffix = "" if prec == "f32" else f"_{prec}"
        for batch, path, kname in (
                (1, "sequential", "fused_step"),
                (BATCH, "batched", "fused_step_batched")):
            name = path if prec == "f32" else f"{prec}_{path}"
            key = kname if prec == "f32" else f"{kname}{suffix}"
            launches = paths[name][0][key]
            iters = launches * batch / 32
            rate = {"s": 64_000, "n": n, "k": 25, "precision": prec,
                    "batch": batch, "lloyd_iters_per_chunk": iters,
                    "chunks_per_s": 32 / FIT_WALLS[name]}
            measured.append(rate)
            row = roofline.precision_roofline(rate)
            check(row["achieved_frac_of_peak"] <= 1.0,
                  f"13e: {name} at {row['achieved_frac_of_peak']} of the "
                  "HBM peak: the traffic model counts too little")
            rows.append(dict(row, path=name, fit_wall_s=FIT_WALLS[name],
                             fused_launches=launches))
    emit({"phase": "suite_roofline", "hbm_bytes_per_s": roofline.HBM_BW,
          "rows": [{key: r[key] for key in (
              "path", "precision", "batch", "passes", "chunks_per_s",
              "fit_wall_s", "fused_launches", "model_bytes_per_chunk",
              "arithmetic_intensity", "dominant", "bound_s",
              "achieved_bytes_per_s", "achieved_frac_of_peak")}
              for r in rows]})
    bench = ROOT / "build" / "chunk_rates.json"
    out = ROOT / "build" / "roofline_torch.json"
    bench.parent.mkdir(parents=True, exist_ok=True)
    bench.write_text(json.dumps({"rows": measured}))
    out.unlink(missing_ok=True)
    roofline.main(["--bench", str(bench), "--out", str(out)])
    doc = json.loads(out.read_text())
    suite_schema.check(doc, suite_schema.ENVELOPE_SCHEMA, what=out.name)
    check(doc["host"]["device"] == torch.cuda.get_device_name(0)
          and doc["host"]["power_limit"]
          and doc["hbm_bw"] == roofline.HBM_BW,
          f"13e: the envelope's host {doc['host']}")
    check([{k: r[k] for k in ("precision", "batch", "bound_s",
                              "achieved_frac_of_peak")}
           for r in doc["rows"]]
          == [{k: r[k] for k in ("precision", "batch", "bound_s",
                                 "achieved_frac_of_peak")} for r in rows],
          "13e: roofline.main's rows differ from precision_roofline's")
    emit({"phase": "suite_roofline_main", "path": str(out.relative_to(ROOT)),
          "bench": doc["bench"], "rows": len(doc["rows"]),
          "host": doc["host"]})
    return rows


def phase_suite(X, seed: int, res_b, paths: dict) -> dict:
    """Phase 13: 13a-13c in a temporary data root (removed after), 13d,
    13e.  Returns {path: (launches, wall)} for the two tiers."""
    card = nvidia_smi()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_suite_"))
    seconds = {}
    try:
        quick, launches_q, seconds["13a"] = phase_suite_quick(root, card)
        doc, launches_f, seconds["13b"] = phase_suite_full(root, quick,
                                                            card)
        t0 = time.monotonic()
        phase_suite_gate(doc, root)
        seconds["13c"] = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.monotonic()
    phase_workload(X, seed, res_b)
    seconds["13d"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_roofline(paths, X.shape[1])
    seconds["13e"] = time.monotonic() - t0
    emit({"phase": "suite_seconds", **seconds, "card": card})
    return {"evalsuite_quick": (launches_q, seconds["13a"]),
            "evalsuite_full": (launches_f, seconds["13b"])}


# --------------------------------------------------------------------------
# phase 14: the model zoo's serving path and its two entry points
# --------------------------------------------------------------------------

ZOO_B, ZOO_S = 8, 2048              # 14a's and 14b's forward
ZOO_DECODE = 8                      # tokens decoded after the prefill
ZOO_DECODE_B, ZOO_DECODE_S = 2, 256  # 14b's prefill + decode: 248 + 8
ZOO_FRAMES = 1024                   # seamless's audio frames
ZOO_DEPTH = {"deepseek-moe-16b": 4,  # of 28: 16.9B parameters in f32 do
             "qwen3-moe-235b-a22b": 2}  # not fit; of 94: 235B
# Decoded logits and the decode cache against the forward's:
# ``repro_torch.models.decode_check`` (its docstring has the bounds and why).
EMBED_K, EMBED_S, EMBED_CHUNKS = 64, 512, 25   # the example's fit
LAUNCH_ARGV = ["--arch", "bigmeans_paper", "--chunks", "32", "--scale",
               "0.02"]


def timed(fn):
    """(fn(), its wall in ms), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.monotonic() - t0)


def zoo_config(arch: str):
    """The arch at its published width, its depth cut where ZOO_DEPTH
    says."""
    cfg = zoo_registry.get_config(arch)
    if arch in ZOO_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=ZOO_DEPTH[arch])
    return cfg


def zoo_forward_twice(cfg, model, tokens, frames, what: str):
    """Two forwards: logits [B, S, V], finite, bitwise equal; their ms."""
    a, ms_a = timed(lambda: decode_check.forward(cfg, model, tokens,
                                                 frames)[0])
    b, ms_b = timed(lambda: decode_check.forward(cfg, model, tokens,
                                                 frames)[0])
    check(tuple(a.shape) == (*tokens.shape, cfg.vocab_size),
          f"{what}: logits {tuple(a.shape)}")
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite logits")
    check(torch.equal(a, b), f"{what}: two forwards differ")
    return a, [ms_a, ms_b]


def embedding_kernels(H, res, seed: int) -> dict:
    """A, B and C at the embedding fit's chunk shape (s = 512 rows of H, its
    k = 64 centroids, n = 128): each held to its plain version on the same
    inputs as phase 3 holds them, then timed as in phase 6."""
    s, (k, n) = EMBED_S, res.centroids.shape
    gen = torch.Generator(device=H.device).manual_seed(seed)
    x = H[torch.randint(0, H.shape[0], (s,), generator=gen,
                        device=H.device)].contiguous()
    c = res.centroids.contiguous()
    ties = near_ties(x, c)
    errs = {"fused_step_f32": check_fused(x, c, int(ties.sum())),
            "assign_f32": check_assign(x, c, ties)}
    ids, _ = distance.assign_plain(x, c)
    errs["update_f32"] = check_update(x, ids, k)
    nb, ops_, _ = fused_cost("f32", s, k, n)
    rows = {"fused_step_f32": timing(
        lambda: fused_step.fused_step_f32(x, c),
        lambda: fused_step.fused_step_plain(x, c), None, nb, ops_, 200)}
    nb, ops_, _ = assign_cost("f32", s, k, n)
    rows["assign_f32"] = timing(
        lambda: distance.assign_f32(x, c),
        lambda: distance.assign_plain(x, c), lambda: torch.mm(x, c.t()),
        nb, ops_, 200)
    rows["assign_f32"]["library"] = MM_F32
    ids64 = ids.long()
    rows["update_f32"] = timing(
        lambda: upd.update_f32(x, ids, k),
        lambda: upd.update_plain(x, ids, k),
        lambda: torch.zeros((k, n), device="cuda").index_add_(0, ids64, x),
        4 * (s * n + s + k * n + k), s * n, 200)
    rows["update_f32"]["library"] = "index_add_ (sums only; counts excluded)"
    for name, row in rows.items():
        row.update(s=s, k=k, n=n, max_abs_err=errs[name])
    return rows


def phase_zoo_hymba(seed: int, card: str) -> tuple:
    """14a: hymba-1.5b at its published width and depth.  Returns
    ({kernel: row at the embedding shape}, the embedding path's (launches,
    wall s))."""
    dev = devices.resolve(None)
    cfg = zoo_config("hymba-1.5b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model, init_ms = timed(lambda: zoo_transformer.init_params(
        cfg, gen, device=dev))
    tokens, _ = decode_check.random_inputs(cfg, ZOO_B, ZOO_S, gen, dev)
    windows = zoo_transformer.window_schedule(cfg, cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    full, fwd_ms = zoo_forward_twice(cfg, model, tokens, None, "14a")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dec = decode_check.decode_gap(cfg, model, tokens, None, ZOO_DECODE)
    bad = decode_check.decode_faults(dec, hybrid=True)
    check(not bad, f"14a: {bad}")
    H, harvest_ms = timed(lambda: embedding_clustering.harvest(
        cfg, model, tokens))
    check(tuple(H.shape) == (ZOO_B * ZOO_S, 128) and torch.equal(
        H, full.reshape(-1, cfg.vocab_size)[:, :128]),
        "14a: harvest is not the forward's first 128 logit columns")
    n_params = sum(p.numel() for p in model.parameters())
    del full, model
    torch.cuda.empty_cache()

    kw = dict(k=EMBED_K, s=EMBED_S, n_chunks=EMBED_CHUNKS, seed=seed)
    for impl in ("auto", "ref"):        # warm both paths (first-use costs)
        fit(H, **dict(kw, n_chunks=2, seed=seed + 1), impl=impl)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res, fit_ms = timed(lambda: fit(H, **kw))
    (ids, f_full), eval_ms = timed(lambda: evaluate(res, H))
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    n_eval = math.ceil(H.shape[0] / EVAL_BATCH)
    check(res.extras["fit"]["impl"] == "cuda" and res.strategy
          == "sequential", "14a: the embedding fit did not use the kernels")
    check(launches == dict(seeded_zeros(launches),
                           fused_step=res.n_iterations,
                           assign=EMBED_CHUNKS + n_eval,
                           update=EMBED_CHUNKS),
          f"14a: launches {launches}, {res.n_iterations} iterations")
    check(tuple(ids.shape) == (H.shape[0],) and math.isfinite(f_full),
          "14a: evaluate")
    res_ref = fit(H, **kw, impl="ref")
    check(ops.launch_counts() == launches, "14a: the ref fit launched")
    _, f_ref = evaluate(res_ref, H)
    rel = abs(f_full - f_ref) / f_ref
    check(rel <= 1e-3, f"14a: full objectives differ by {rel:.3e}")
    rows = embedding_kernels(H, res, seed)
    emit({"phase": "zoo_hymba", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                            cfg.num_kv_heads],
          "vocab": cfg.vocab_size, "parameters": n_params,
          "param_count": cfg.param_count(), "batch": ZOO_B, "seq": ZOO_S,
          "window_layers": sum(w == cfg.window for w in windows),
          "ssd_chunks": math.ceil(ZOO_S / cfg.ssm_chunk),
          "init_ms": init_ms, "forward_ms": fwd_ms,
          "forward_peak_gb": peak_gb, "forwards_bitwise": True,
          "decode": dec, "decode_tol": decode_check.HYMBA_DECODE_TOL,
          "cache_rel_bound": decode_check.HYMBA_CACHE_REL,
          "harvest_ms": harvest_ms, "rows": list(H.shape),
          "fit": {"k": EMBED_K, "s": EMBED_S, "n_chunks": EMBED_CHUNKS,
                  "fit_ms": fit_ms, "fit_wall_s": res.wall_time_s,
                  "evaluate_ms": eval_ms, "f_full": f_full,
                  "f_full_ref": f_ref, "f_full_rel_diff": rel,
                  "n_iterations": res.n_iterations,
                  "n_accepted": res.n_accepted, "launches": launches},
          "kernels_at_embedding_shape": rows, "card": card})
    return rows, (launches, wall)


def phase_zoo_others(seed: int, card: str) -> list:
    """14b: seamless-m4t-medium at full depth, deepseek-moe-16b and
    qwen3-moe-235b-a22b at their published widths with ZOO_DEPTH layers:
    the B = 8 forward twice, and prefill + decode at B = 2 (248 + 8, no
    token dropped) against the forward."""
    dev = devices.resolve(None)
    out = []
    for arch in ("seamless-m4t-medium", "deepseek-moe-16b",
                 "qwen3-moe-235b-a22b"):
        cfg = zoo_config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model, init_ms = timed(lambda: zoo_transformer.init_params(
            cfg, gen, device=dev))
        n_params = sum(p.numel() for p in model.parameters())
        tokens, frames = decode_check.random_inputs(
            cfg, ZOO_B, ZOO_S, gen, dev, frames=ZOO_FRAMES)
        torch.cuda.reset_peak_memory_stats()
        full, fwd_ms = zoo_forward_twice(cfg, model, tokens, frames,
                                         f"14b {arch}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del full, tokens, frames
        torch.cuda.empty_cache()
        dcfg = cfg
        if cfg.moe:                     # no token dropped in the forward
            dcfg = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        tokens, frames = decode_check.random_inputs(
            dcfg, ZOO_DECODE_B, ZOO_DECODE_S, gen, dev, frames=ZOO_FRAMES)
        dec = decode_check.decode_gap(dcfg, model, tokens, frames,
                                      ZOO_DECODE)
        bad = decode_check.decode_faults(dec, hybrid=False)
        check(not bad, f"14b {arch}: {bad}")
        row = {"arch": arch, "layers": cfg.num_layers,
               "published_layers": zoo_registry.get_config(arch).num_layers,
               "encoder_layers": cfg.encoder_layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "parameters": n_params, "batch": ZOO_B, "seq": ZOO_S,
               "frames": ZOO_FRAMES if frames is not None else None,
               "init_ms": init_ms, "forward_ms": fwd_ms,
               "forward_peak_gb": peak_gb, "forwards_bitwise": True,
               "decode": dec,
               "decode_steps_bound": decode_check.DECODE_STEPS,
               "cache_rel_bound": decode_check.CACHE_REL,
               "capacity_factor": dcfg.capacity_factor, "card": card}
        emit({"phase": "zoo_other", **row})
        out.append(row)
        del model, tokens, frames
        torch.cuda.empty_cache()
    return out


def phase_zoo_example(card: str) -> list:
    """14c: the reference example's own run, reduced configs, on the card."""
    rows = []
    for arch in zoo_registry.LM_ARCHS:
        got, ms = timed(lambda: embedding_clustering.main(["--arch", arch]))
        res = got["result"]
        check((got["rows"], got["width"]) == (1024, 128)
              and res.extras["fit"]["impl"] == "cuda"
              and res.centroids.is_cuda
              and 0 < got["mse"] < got["variance"],
              f"14c {arch}: {got['rows']} x {got['width']}, "
              f"mse {got['mse']}, variance {got['variance']}")
        rows.append({"arch": arch, "mse": got["mse"],
                     "variance": got["variance"], "wall_ms": ms})
    emit({"phase": "zoo_example", "rows": rows, "card": card})
    return rows


def phase_launch_train(seed: int, root: Path, card: str) -> tuple:
    """14d: the clustering launcher on the card; again with ``--ckpt`` (the
    reference's step layout), resumed by a second call; an LM arch
    refused.  Returns the launcher path's (launches, wall s)."""
    argv = [*LAUNCH_ARGV, "--seed", str(seed)]
    chunks = int(argv[argv.index("--chunks") + 1])
    launch_train.main([*argv[:3], str(BATCH), *argv[4:]])   # warm
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res, ms = timed(lambda: launch_train.main(argv))
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    failed = res.extras.get("chunks_failed", 0)
    check(res.strategy == "streaming" and res.n_chunks == chunks
          and failed == 0
          and math.isfinite(res.objective) and res.config.batch == BATCH,
          f"14d: {res.strategy} {res.n_chunks} chunks, {failed} failed")
    check(launches["fused_step_batched"] > 0 and launches == dict(
        seeded_zeros(launches), update=chunks, assign=chunks,
        fused_step_batched=launches["fused_step_batched"]),
        f"14d: launches {launches}")
    # kernel D at the launcher's shape: its 8 streams of chunks, the fit's
    # incumbent on each
    cfg = zoo_registry.get_config("bigmeans_paper")
    scale = float(argv[argv.index("--scale") + 1])
    spec = GMMSpec(m=max(int(cfg.m * scale), cfg.s * 2), n=cfg.n_features,
                   components=cfg.k, spread=4.0, seed=seed)
    xb = torch.stack([gmm_chunk(spec, i, cfg.s) for i in range(BATCH)])
    cb = res.centroids.expand(BATCH, *res.centroids.shape).contiguous()
    d_err, _ = check_batched(xb, cb)
    del xb

    ckpt = root / "launch_train"
    first = launch_train.main([*argv, "--ckpt", str(ckpt)])
    check(first.objective == res.objective
          and torch.equal(first.centroids, res.centroids),
          "14d: the checkpointed run differs from the plain one")
    steps = ckpt_lib.steps(str(ckpt))
    layout = check_layout(root, cfg.k, cfg.n_features, set())
    again = launch_train.main([*argv, "--ckpt", str(ckpt)])
    check(again.n_chunks == 0 and again.objective == first.objective,
          f"14d: resumed {again.n_chunks} chunks to f_best "
          f"{again.objective} (first {first.objective})")
    refused = raises(lambda: launch_train.main(["--arch", "hymba-1.5b"]),
                     "LM archs")
    emit({"phase": "zoo_launch_train", "argv": argv,
          "m": spec.m, "n": spec.n, "k": res.config.k, "s": res.config.s,
          "batch": res.config.batch, "f_best": res.objective,
          "n_accepted": res.n_accepted, "failed": failed, "wall_ms": ms,
          "fit_wall_s": res.wall_time_s, "launches": launches,
          "fused_step_batched_err_at_shape": d_err,
          "ckpt_steps": steps, "ckpt_steps_checked": layout,
          "resumed_chunks": again.n_chunks, "resumed_f_best":
          again.objective, "refused": refused, "card": card})
    return launches, wall


# 14e: the reference's three public-API examples, at their default sizes
EXAMPLE_HOST_ARGV = ["--chunks", "24", "--s", "2048", "--topology",
                     "host_mesh"]
# What the reference's example does under two ranks (run on the CPU
# through repro.engine.hostmesh.launch_local): every rank refuses in phase
# 1, the example's batch of 1 not divisible by 2 hosts.
EXAMPLE_HOST_REFUSAL = ("ValueError: host_mesh needs hosts (2) to divide "
                        "the global batch (1)")
EXAMPLE_RANK = """\
import json, os, sys, time
import torch
from repro_torch.engine import hostmesh
from repro_torch.examples import bigdata_clustering
from repro_torch.kernels import build, ops
build.load()
ops.reset_launch_counts()
t0 = time.monotonic()
got = bigdata_clustering.main(sys.argv[1:])
torch.cuda.synchronize()
runs = (got["phase1"], got["phase2"])
print("RESULT " + json.dumps({
    "rank": int(os.environ[hostmesh.ENV_RANK]),
    "wall_s": time.monotonic() - t0, "built_here": build.info().built,
    "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    "impl": [r.extras["fit"]["impl"] for r in runs],
    "on_card": [r.centroids.is_cuda for r in runs],
    "objective": [r.objective for r in runs],
    "n_chunks": [r.n_chunks for r in runs],
    "n_accepted": [r.n_accepted for r in runs],
    "n_iterations": [r.n_iterations for r in runs],
    "fit_s": [r.wall_time_s for r in runs],
    "host": runs[1].extras.get("host"), "per_point": got["per_point"],
    "sample_rows": got["sample_rows"], "launches": ops.launch_counts()}),
    flush=True)
"""


def counted_calls(module, calls: list, *names):
    """Wrap ``module.<name>`` for each of ``names``: every call appends
    (name, result, ms, {kernel: launches it made}) to ``calls``, the card
    synchronized on both sides.  Returns the restore function."""
    originals = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = 1e3 * (time.monotonic() - t0)
            after = ops.launch_counts()
            calls.append((name, out, ms, {
                k: v - before[k] for k, v in after.items() if v != before[k]}))
            return out
        return wrapper

    for name, fn in originals.items():
        setattr(module, name, wrap(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(module, name, fn)
    return restore


def run_example(module, argv: list, *names) -> tuple:
    """``module.main(argv)`` on the card with ``names`` counted
    (:func:`counted_calls`): (what it returned, its calls, the launches of
    the whole run, its wall s)."""
    calls: list = []
    restore = counted_calls(module, calls, *names)
    try:
        ops.reset_launch_counts()
        got, ms = timed(lambda: module.main(argv))
        launches = ops.launch_counts()
    finally:
        restore()
    return got, calls, launches, ms / 1e3


def on_card(res, what: str) -> None:
    check(res.extras["fit"]["impl"] == "cuda" and res.centroids.is_cuda,
          f"{what}: the fit did not run the kernels on the card")


def lloyd_launches(res) -> dict:
    """A sequential fit's launches: A once per Lloyd iteration, its
    epilogue's B and C once a chunk."""
    return {"fused_step": res.n_iterations, "assign": res.n_chunks,
            "update": res.n_chunks}


def stream_accepts(*runs) -> list:
    """The ``(i, f_new, accepted)`` trace of streamed fits run one after
    another at ``log_every=1`` (a chunk is accepted where the incumbent
    after it is its f_new)."""
    rows = [(fn, fb == fn) for r in runs for t in r.trace
            if isinstance(t[0], int) for _, fb, fn in (t,)]
    return [(i, fn, acc) for i, (fn, acc) in enumerate(rows)]


def example_quickstart() -> tuple:
    """14e: ``quickstart.main([])``: the fit's, ``evaluate``'s and the
    K-means++ baseline's launches; the fit held to its plain twin on the
    same rows as phase 4 holds it, the baseline as phase 11 does."""
    got, calls, launches, wall = run_example(quickstart, [], "fit",
                                             "evaluate")
    (_, res, fit_ms, fit_l), (_, _, eval_ms, eval_l), \
        (_, base, base_ms, base_l) = calls
    X, cfg = got["X"], got["config"]
    on_card(res, "14e quickstart")
    on_card(base, "14e quickstart's K-means++")
    n_eval = math.ceil(X.shape[0] / EVAL_BATCH)
    check(res.strategy == "sequential"
          and off_seeding(fit_l) == lloyd_launches(res)
          and eval_l == {"assign": n_eval}
          and set(off_seeding(base_l)) == {"fused_step", "assign", "update"},
          f"14e quickstart: launches {fit_l}, {eval_l}, {base_l}")
    twin = fit(X, cfg.replace(impl="ref"))
    parting = check_accepts(res.trace, twin.trace, 1, 1)
    _, f_twin = evaluate(twin, X, impl="ref")
    rel = abs(got["objective"] - f_twin) / f_twin
    check(rel <= 1e-3, f"14e quickstart: f {got['objective']} against the "
          f"plain twin's {f_twin} ({rel:.3e})")
    base_twin = fit(X, cfg.replace(impl="ref"), method="kmeanspp", seed=1)
    check(base.objective <= base_twin.objective * (1 + 1e-3),
          f"14e quickstart: K-means++ f {base.objective} above the plain "
          f"twin's {base_twin.objective}")
    row = {"m": X.shape[0], "k": cfg.k, "s": cfg.s,
           "n_chunks": res.n_chunks, "n_accepted": res.n_accepted,
           "n_iterations": res.n_iterations, "wall_s": wall,
           "fit_ms": fit_ms, "fit_wall_s": res.wall_time_s,
           "evaluate_ms": eval_ms, "f_full": got["objective"],
           "f_full_plain": f_twin, "f_full_rel_diff": rel,
           "first_parting": parting, "kmeanspp": {
               "ms": base_ms, "fit_wall_s": base.wall_time_s,
               "n_iterations": base.n_iterations, "f": base.objective,
               "f_plain": base_twin.objective, "launches": base_l},
           "launches": launches}
    return row, (launches, wall)


def example_bigdata(root: Path) -> tuple:
    """14e: ``bigdata_clustering.main([])``: phase 1, the resume and the
    final pass, each one's launches; the resume held to its plain twin as
    phase 9 holds it (both runs again at ``log_every=1``: the kernels' is
    bitwise the example's, the accept sequences as phase 4's, f on the
    sample within 1e-3)."""
    got, calls, launches, wall = run_example(bigdata_clustering, [], "fit",
                                             "evaluate")
    (_, r1, ms1, l1), (_, r2, ms2, l2), (_, _, eval_ms, eval_l) = calls
    cfg = got["config"]
    half = cfg.n_chunks // 2
    for res, what in ((r1, "phase 1"), (r2, "phase 2")):
        on_card(res, f"14e bigdata {what}")
    n_eval = math.ceil(got["sample_rows"] / EVAL_BATCH)
    check(off_seeding(l1) == lloyd_launches(r1)
          and off_seeding(l2) == lloyd_launches(r2)
          and eval_l == {"assign": n_eval},
          f"14e bigdata: launches {l1}, {l2}, {eval_l}")
    check(r1.n_chunks == r2.n_chunks == half
          and r2.extras["health"]["ckpt_fallback"] is None
          and len(r2.extras["checkpoint"]["restore_ms"]) == 1,
          f"14e bigdata: {r1.n_chunks} + {r2.n_chunks} chunks, resume "
          f"{r2.extras['checkpoint']}")
    spec, s = bigdata_clustering.SPEC, cfg.s

    def fetch(chunk_id: int) -> np.ndarray:
        return devices.host_array(gmm_chunk(spec, chunk_id, s), np.float32)

    runs = {}
    for impl in ("auto", "ref"):        # auto: the example's (the kernels)
        c = cfg.replace(ckpt_dir=str(root / f"bigdata_{impl}"), impl=impl,
                        log_every=1)
        runs[impl] = [fit(fetch, c.replace(n_chunks=half, resume=False),
                          method="streaming", n_features=spec.n),
                      fit(fetch, c, method="streaming", n_features=spec.n)]
    again = runs["auto"][1]
    check(torch.equal(again.centroids, r2.centroids)
          and again.objective == r2.objective,
          "14e bigdata: the kernels' run again at log_every=1 differs")
    accepts = {impl: stream_accepts(*r) for impl, r in runs.items()}
    check(len(accepts["auto"]) == len(accepts["ref"]) == cfg.n_chunks,
          f"14e bigdata: traces of {len(accepts['auto'])} and "
          f"{len(accepts['ref'])} chunks")
    parting = check_accepts(accepts["auto"], accepts["ref"], 1, 1)
    _, f_twin = evaluate(runs["ref"][1].centroids, got["sample"], impl="ref")
    rel = abs(got["objective"] - f_twin) / f_twin
    check(rel <= 1e-3, f"14e bigdata: f on the sample {got['objective']} "
          f"against the plain twin's {f_twin} ({rel:.3e})")
    row = {"chunks": cfg.n_chunks, "k": cfg.k, "s": s,
           "sample_rows": got["sample_rows"], "wall_s": wall,
           "phase1": {"ms": ms1, "fit_wall_s": r1.wall_time_s,
                      "n_accepted": r1.n_accepted, "f_best": r1.objective},
           "phase2": {"ms": ms2, "fit_wall_s": r2.wall_time_s,
                      "n_accepted": r2.n_accepted, "f_best": r2.objective,
                      "restore_ms": r2.extras["checkpoint"]["restore_ms"]},
           "sample_evaluate_ms": eval_ms, "per_point": got["per_point"],
           "f_sample_plain": f_twin, "f_sample_rel_diff": rel,
           "first_parting": parting,
           "sizes": [int(v) for v in got["sizes"]], "launches": launches}
    return row, (launches, wall)


def recording_serving(responses: list, snapshots: dict):
    """Wrap ``Server.assign`` and ``ModelEntry.swap``: each response is
    appended to ``responses`` with its rows and the entry's policy, each
    swap's centroids kept in ``snapshots`` by version as it is made.
    Returns the restore function."""
    assign, swap = serve_lib.Server.assign, serve_registry.ModelEntry.swap
    lock = threading.Lock()

    def recording_assign(self, model_id, points, *args, **kwargs):
        resp = assign(self, model_id, points, *args, **kwargs)
        prec = self.registry.get(model_id).precision
        with lock:
            responses.append((np.array(points), resp, prec))
        return resp

    def recording_swap(self, centroids, **kwargs):
        snap = swap(self, centroids, **kwargs)
        with lock:
            snapshots[snap.version] = snap.centroids.clone()
        return snap

    serve_lib.Server.assign = recording_assign
    serve_registry.ModelEntry.swap = recording_swap

    def restore():
        serve_lib.Server.assign = assign
        serve_registry.ModelEntry.swap = swap
    return restore


def check_served(responses: list, snapshots: dict) -> dict:
    """Every response's ids and distances held to the plain version on its
    rows and the centroids of the version it names, as 10a holds a replay
    (ids equal off near ties, d within RTOL of its terms): one check a
    version over all its rows.  Returns {version: [responses, rows, near
    ties, max abs err of d]}."""
    by_version: dict = {}
    for points, resp, prec in responses:
        check(resp.version in snapshots and len(resp.ids) == len(points),
              f"14e serve: a response of {len(resp.ids)} ids for "
              f"{len(points)} rows, version {resp.version} of "
              f"{sorted(snapshots)}")
        by_version.setdefault((resp.version, prec), []).append(
            (points, resp))
    rows = {}
    for (version, prec), got in sorted(by_version.items()):
        x = torch.from_numpy(np.concatenate([p for p, _ in got])).cuda()
        ids = np.concatenate([r.ids for _, r in got])
        d = np.concatenate([r.dists for _, r in got])
        err = check_against_plain(prec, x, snapshots[version], ids, d,
                                  f"14e serve, version {version}")
        ties = int(assign_ties_at(prec, x, snapshots[version]).sum())
        rows[version] = [len(got), int(x.shape[0]), ties, err]
    return rows


def example_serve() -> tuple:
    """14e: ``serve_assignments.main([])``: 8 clients of 60 requests while
    a second fit runs on the card; no request dropped, no capture after
    warmup; every response held to the plain version on the centroids of
    the version it names (each swap's recorded as it is made); A, B, C:
    the fits', the buckets' warmup launches (B, eager, one a bucket) and
    one B a replay."""
    responses, snapshots = [], {}
    restore = recording_serving(responses, snapshots)
    try:
        got, calls, launches, wall = run_example(serve_assignments, [],
                                                 "fit")
    finally:
        restore()
    (_, trained, ms1, l1), (_, more, ms2, _) = calls
    on_card(trained, "14e serve, training")
    on_card(more, "14e serve, retraining")
    stats = got["stats"]
    replays = sum(stats["replays"].values())
    chunks = trained.n_chunks + more.n_chunks
    check(off_seeding(l1) == lloyd_launches(trained) and launches == dict(
        seeded_zeros(launches),
        fused_step=trained.n_iterations + more.n_iterations,
        update=chunks, assign=chunks + len(got["buckets"]) + replays),
        f"14e serve: launches {l1}, {launches}; {replays} replays")
    check(got["completed"] == stats["n_requests"] == 8 * 60
          and replays == stats["n_batches"]
          and stats["n_launch_faults"] == 0
          and got["recompiles_after_warmup"] == 0
          and len(responses) == 8 * 60,
          f"14e serve: {got['completed']} completed, {len(responses)} "
          f"recorded, stats {stats}")
    snapshots[0] = trained.centroids
    served = check_served(responses, snapshots)
    changed = [v for v in snapshots
               if v and not torch.equal(snapshots[v], snapshots[0])]
    row = {"wall_s": wall, "train": {"ms": ms1,
                                     "fit_wall_s": trained.wall_time_s},
           "retrain": {"ms": ms2, "fit_wall_s": more.wall_time_s,
                       "n_chunks": more.n_chunks},
           "requests": got["completed"], "n_batches": stats["n_batches"],
           "requests_per_batch": stats["requests_per_batch"],
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "recompiles_after_warmup": got["recompiles_after_warmup"],
           "n_swaps": got["n_swaps"], "trace": got["trace"],
           "versions": got["versions"],
           "served_per_version": served, "swaps_that_changed_centroids":
           changed, "launches": launches}
    return row, (launches, wall)


def example_host_mesh(root: Path) -> tuple:
    """14e: ``bigdata_clustering`` with ``--topology host_mesh`` under the
    port's ``launch_local``.  Two ranks: each refuses in phase 1 as the
    reference's example does, writing no checkpoint.  One rank: the host
    path on the card, its launches from the rank, its fits and its sample's
    f equal to the example run in this process on the same arguments."""
    env = {"PYTHONPATH": str(ROOT / "src"), "TMPDIR": str(root)}
    cmd = [sys.executable, "-c", EXAMPLE_RANK, *EXAMPLE_HOST_ARGV]
    ckpt = root / "bigmeans_demo_ckpt"
    t0 = time.monotonic()
    procs = hostmesh.launch_local(cmd, 2, timeout_s=300, env_extra=env)
    refused_s = time.monotonic() - t0
    for p in procs:
        lines = p.output.splitlines()
        check(p.returncode == 1 and lines[-1] == EXAMPLE_HOST_REFUSAL
              and lines[0] == "phase 1: clustering 12 chunks, then "
              "'crashing'…", f"14e host_mesh, 2 ranks: rank {p.rank} exit "
              f"{p.returncode}: {p.output[-2000:]}")
    check(not ckpt.exists() or not ckpt_lib.steps(str(ckpt)),
          "14e host_mesh, 2 ranks: a checkpoint was written")
    t0 = time.monotonic()
    procs = hostmesh.launch_local(cmd, 1, timeout_s=300, env_extra=env)
    wall = time.monotonic() - t0
    check(procs[0].returncode == 0, f"14e host_mesh, 1 rank: exit "
          f"{procs[0].returncode}: {procs[0].output[-2000:]}")
    out, = rank_results(procs, "14e host_mesh, 1 rank")
    single = bigdata_clustering.main(EXAMPLE_HOST_ARGV[:4])
    runs = (single["phase1"], single["phase2"])
    lc = out["launches"]
    n_eval = math.ceil(out["sample_rows"] / EVAL_BATCH)
    check(out["impl"] == ["cuda", "cuda"] and all(out["on_card"])
          and not out["jax"] and not out["built_here"]
          and out["host"]["processes"] == 1, f"14e host_mesh rank: {out}")
    check(lc == dict(seeded_zeros(lc),
                     fused_step=sum(out["n_iterations"]),
                     update=sum(out["n_chunks"]),
                     assign=sum(out["n_chunks"]) + n_eval),
          f"14e host_mesh rank: launches {lc}")
    check(out["objective"] == [r.objective for r in runs]
          and out["n_accepted"] == [r.n_accepted for r in runs]
          and out["per_point"] == single["per_point"],
          f"14e host_mesh rank: {out['objective']}, {out['per_point']} "
          f"against one process's {[r.objective for r in runs]}, "
          f"{single['per_point']}")
    row = {"argv": EXAMPLE_HOST_ARGV, "two_ranks_refused":
           EXAMPLE_HOST_REFUSAL, "two_ranks_launch_s": refused_s,
           "one_rank_launch_s": wall, "rank_wall_s": out["wall_s"],
           "rank_fit_s": out["fit_s"], "single_process_fit_s":
           [r.wall_time_s for r in runs], "launches": lc}
    return row, (lc, wall)


def phase_examples(root: Path, card: str) -> dict:
    """14e: the reference's three examples on the card at their default
    sizes (``repro_torch.examples``), and the streaming one under
    ``host_mesh``; each one's temp directory under ``root``.  Returns
    {path: (launches, wall s)}."""
    rows, paths, seconds = {}, {}, {}
    saved = tempfile.tempdir
    tempfile.tempdir = str(root)
    try:
        for name, run in (("quickstart", example_quickstart),
                          ("bigdata", lambda: example_bigdata(root)),
                          ("serve", example_serve),
                          ("host_mesh", lambda: example_host_mesh(root))):
            t0 = time.monotonic()
            rows[name], paths[f"example_{name}"] = run()
            seconds[name] = time.monotonic() - t0
    finally:
        tempfile.tempdir = saved
    emit({"phase": "zoo_examples", **rows, "seconds": seconds,
          "card": card})
    return paths


def phase_zoo_flops(card: str) -> list:
    """14f: ``roofline.model_flops`` for the four archs at the four
    assigned shapes."""
    rows = [{"arch": arch, "shape": name, "kind": shape.kind,
             "model_flops": roofline.model_flops(
                 zoo_registry.get_config(arch), shape)}
            for arch in zoo_registry.LM_ARCHS
            for name, shape in zoo_shapes.SHAPES.items()]
    emit({"phase": "zoo_model_flops", "rows": rows, "card": card})
    return rows


def phase_zoo(seed: int) -> tuple:
    """Phase 14.  Returns ({kernel: row at the embedding shape}, {path:
    (launches, wall s)})."""
    card = nvidia_smi()
    torch.cuda.empty_cache()            # 14b's forwards peak at ~67 GB
    emit({"phase": "zoo_start",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9, "card": card})
    seconds, paths = {}, {}
    t0 = time.monotonic()
    rows, paths["embedding"] = phase_zoo_hymba(seed, card)
    seconds["14a"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_zoo_others(seed, card)
    seconds["14b"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_zoo_example(card)
    seconds["14c"] = time.monotonic() - t0
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_zoo_"))
    t0 = time.monotonic()
    try:
        paths["launch_train"] = phase_launch_train(seed, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds["14d"] = time.monotonic() - t0
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    t0 = time.monotonic()
    try:
        paths.update(phase_examples(root, card))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds["14e"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_zoo_flops(card)
    seconds["14f"] = time.monotonic() - t0
    emit({"phase": "zoo_seconds", **seconds, "card": card})
    return rows, paths


# --------------------------------------------------------------------------
# phase 15: training the zoo (repro_torch.train)
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 2048          # 15a: S as phase 14's, the window binds
TRAIN_STEPS, TRAIN_LR = 4, 1e-3
TRAIN_F32_RTOL = 1e-4               # 15b: the CPU tests' F32_RTOL
TRAIN_HYBRID_STEPS = (1.0, 0.1)     # 15b: hymba's gradient allowance, in
#                                     bf16 steps of a leaf's scale (largest
#                                     error, 99th percentile), the CPU tests'
BF16_STEP = 2.0 ** -7
CHUNK_B, CHUNK_S, CHUNK = 4, 1024, 256   # 15c: seamless's decoder tokens
#                                     (1,024 frames), the loss chunk
GROUPED_DEPTH, GROUPED_G = 4, 4     # 15c: deepseek-moe-16b at 4 of 28 layers


def vlm_test_config():
    """The VLM config of the CPU tests (``tests/test_torch_models.py``):
    prefix-LM attention over 4 stub patches, softcaps, sandwich norms,
    scaled embeddings, geglu, local / global layers."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name="vlm-test", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        window=8, layer_pattern="local_global", attn_softcap=50.0,
        final_softcap=30.0, sandwich_norm=True, scale_embedding=True,
        mlp="geglu", frontend="vision", frontend_dim=32, frontend_len=4)


def lm_batch(cfg, B: int, S: int, gen, device, frames: int = 1024) -> dict:
    """Random next-token data: tokens [B, S], labels the tokens after them
    (and the frames of an encoder-decoder, the patches of a VLM)."""
    seq = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                        device=device)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.family == "encdec":
        batch["frontend"] = torch.randn((B, frames, cfg.frontend_dim),
                                        generator=gen, device=device)
    elif cfg.family == "vlm":
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_len, cfg.frontend_dim), generator=gen,
            device=device)
    return batch


def event_ms(fn):
    """(fn(), its device ms by CUDA events, peak GB allocated during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), \
        torch.cuda.max_memory_allocated() / 1e9


def same_grads(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def train_run(cfg, seed: int, batch: dict, policy: str):
    """A model from ``seed`` trained TRAIN_STEPS AdamW steps on ``batch``:
    (model, [loss], [ms], [peak GB])."""
    dev = devices.resolve(None)
    model = zoo_transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = zoo_optimizer.adamw(TRAIN_LR)
    state = opt.init(model)
    step = zoo_train_step.make_train_step(cfg, opt)
    losses, ms, peaks = [], [], []
    zoo_flags.REMAT_POLICY = policy
    try:
        for _ in range(TRAIN_STEPS):
            (model, state, m), t, gb = event_ms(
                lambda: step(model, state, batch))
            losses.append(m["loss"])
            ms.append(t)
            peaks.append(gb)
    finally:
        zoo_flags.REMAT_POLICY = "full"
    return model, losses, ms, peaks


def phase_train_hymba(seed: int, card: str) -> dict:
    """15a: hymba-1.5b at its published width and depth, f32 masters and
    AdamW, B = 4 x 2,048 on one seeded batch."""
    dev = devices.resolve(None)
    cfg = zoo_config("hymba-1.5b")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = lm_batch(cfg, TRAIN_B, TRAIN_S, gen, dev)
    model = zoo_transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(p.numel() for p in model.parameters())

    # the inference forward's NLL: step 0's loss, bitwise
    logits, _ = zoo_transformer.forward(cfg, model, batch["tokens"])
    tot, cnt = zoo_transformer._nll(logits, batch["labels"])
    nll_ref = tot / torch.clamp_min(cnt, 1)
    del logits
    torch.cuda.empty_cache()

    # gradients at the initial parameters: "full", "dots", BF16_GRADS
    vg = {}
    for policy in ("full", "dots"):
        zoo_flags.REMAT_POLICY = policy
        try:
            vg[policy] = event_ms(lambda: zoo_train_step.value_and_grad(
                cfg, model, batch))
        finally:
            zoo_flags.REMAT_POLICY = "full"
    (loss0, g32), _, _ = vg["full"]
    check(torch.equal(loss0, vg["dots"][0][0])
          and same_grads(g32, vg["dots"][0][1]),
          "15a: 'dots' loss or gradients differ from 'full'")
    check(torch.equal(loss0, nll_ref),
          f"15a: loss {float(loss0)} is not the inference forward's NLL "
          f"{float(nll_ref)}")
    grad_ms = {k: v[1] for k, v in vg.items()}
    grad_gb = {k: v[2] for k, v in vg.items()}
    del vg
    torch.cuda.empty_cache()
    bf16 = phase_train_bf16_grads(cfg, model, batch, loss0, g32)
    del g32, model
    torch.cuda.empty_cache()

    # two runs of the 4 steps from the seed, bitwise; then a "dots" step
    run_a, losses, ms, peaks = train_run(cfg, seed, batch, "full")
    losses_f = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses_f)
          and losses_f[-1] < losses_f[0],
          f"15a: losses {losses_f}")
    check(torch.equal(losses[0], nll_ref), "15a: step 0's loss")
    check(all(bool(torch.isfinite(p).all()) for p in run_a.parameters()),
          "15a: a parameter is not finite")
    init = zoo_transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    moved = sum(not torch.equal(a, b) for a, b in zip(
        run_a.parameters(), init.parameters()))
    check(moved > 0, "15a: no parameter moved")
    del init
    run_b, losses_b, ms_b, peaks_b = train_run(cfg, seed, batch, "full")
    check(all(torch.equal(a, b) for a, b in zip(losses, losses_b))
          and all(torch.equal(a, b) for a, b in zip(run_a.parameters(),
                                                    run_b.parameters())),
          "15a: two runs of the steps differ")
    del run_a
    torch.cuda.empty_cache()
    opt = zoo_optimizer.adamw(TRAIN_LR)
    state = opt.init(run_b)
    step = zoo_train_step.make_train_step(cfg, opt)
    step_ms, step_gb = {}, {}
    for policy in ("full", "dots"):
        zoo_flags.REMAT_POLICY = policy
        try:
            (run_b, state, _), step_ms[policy], step_gb[policy] = event_ms(
                lambda: step(run_b, state, batch))
        finally:
            zoo_flags.REMAT_POLICY = "full"
    del run_b, state
    torch.cuda.empty_cache()
    tokens = TRAIN_B * TRAIN_S
    row = {"arch": cfg.name, "layers": cfg.num_layers, "parameters": n_params,
           "batch": TRAIN_B, "seq": TRAIN_S, "lr": TRAIN_LR,
           "losses": losses_f, "loss0_is_forward_nll": True,
           "step_ms": ms, "step_ms_second_run": ms_b,
           "step_peak_gb": peaks, "tokens_per_s": [tokens / (t / 1e3)
                                                  for t in ms],
           "two_runs_bitwise": True, "parameters_moved": moved,
           "grad_ms": grad_ms, "grad_peak_gb": grad_gb,
           "dots_bitwise_full": True,
           "policy_step_ms": step_ms, "policy_step_peak_gb": step_gb,
           "policy_tokens_per_s": {k: tokens / (t / 1e3)
                                   for k, t in step_ms.items()},
           "bf16_grads": bf16, "card": card}
    emit({"phase": "train_hymba", **row})
    return row


def phase_train_bf16_grads(cfg, model, batch, loss32, g32) -> dict:
    """15c: one ``BF16_GRADS`` step on hymba from the initial parameters
    against the f32-gradient step (zero moments both): the loss bitwise
    (every weight is cast to bf16 before use either way), every gradient
    but the tied embedding's bitwise the f32 one, the new parameters
    within 2 lr of each other (a first AdamW step moves an element by at
    most lr (1 + wd |p|), the decay term the same on both sides)."""
    zoo_flags.BF16_GRADS = True
    try:
        (loss16, g16), ms, gb = event_ms(
            lambda: zoo_train_step.value_and_grad(cfg, model, batch))
    finally:
        zoo_flags.BF16_GRADS = False
    check(torch.equal(loss16, loss32), f"15c: BF16_GRADS loss "
          f"{float(loss16)} against {float(loss32)}")
    differ = sorted(k for k in g32 if not torch.equal(g16[k].float(),
                                                      g32[k]))
    check(differ in ([], ["embedding"]),
          f"15c: BF16_GRADS gradients differ at {differ[:5]}")
    check(all(g.dtype == (torch.bfloat16 if g.ndim > 1 else torch.float32)
              for g in g16.values()), "15c: BF16_GRADS gradient dtypes")
    emb = ((g16["embedding"].float() - g32["embedding"]).abs().max()
           / (BF16_STEP * g32["embedding"].abs().max())).item()
    opt = zoo_optimizer.adamw(TRAIN_LR)
    gaps = {}
    a = copy.deepcopy(model)
    opt.update(g32, opt.init(a), a)
    b = copy.deepcopy(model)
    opt.update(g16, opt.init(b), b)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        gaps[name] = (pa - pb).abs().max().item()
    del a, b
    top = max(gaps.values())
    bound = 2 * TRAIN_LR * (1 + 1e-4)   # and the new values' f32 rounding
    check(all(math.isfinite(v) for v in gaps.values()) and top <= bound,
          f"15c: BF16_GRADS step {top} from the f32 one")
    others = max(v for k, v in gaps.items() if k != "embedding")
    return {"loss_bitwise": True, "grads_differing": differ,
            "embedding_grad_bf16_steps": emb, "grad_ms": ms,
            "grad_peak_gb": gb, "param_gap_max": top,
            "param_gap_embedding": gaps["embedding"],
            "param_gap_others_max": others,
            "params_differing": sum(v > 0 for v in gaps.values()),
            "bound": bound}


def grads_within(got: dict, want: dict, hybrid: bool) -> float:
    """The CPU tests' hold of gradients leaf by leaf (largest error and
    99th percentile against the leaf's scale); returns the largest
    error over scale."""
    top, q99 = ((TRAIN_HYBRID_STEPS[0] * BF16_STEP,
                 TRAIN_HYBRID_STEPS[1] * BF16_STEP) if hybrid
                else (TRAIN_F32_RTOL, TRAIN_F32_RTOL))
    worst = 0.0
    for name, w in want.items():
        g = got[name].detach().float().cpu()
        err, scale = (g - w).abs(), w.abs().max().item()
        q = torch.quantile(err.flatten(), 0.99).item()
        check(q <= q99 * scale and err.max().item() <= top * scale,
              f"15b: gradient {name}: {err.max().item()} over {scale}")
        worst = max(worst, err.max().item() / max(scale, 1e-30))
    return worst


def phase_train_reduced(seed: int, card: str) -> list:
    """15b: one train step of each arch's reduced config (and the CPU
    tests' VLM config) on the card at f32 compute, held to the same step
    on the CPU: the loss within TRAIN_F32_RTOL, the gradients as the CPU
    tests hold them, the new parameters within ``step_check``'s gap of
    the two gradients."""
    dev = devices.resolve(None)
    rows = []
    compute = zoo_layers.COMPUTE_DTYPE
    zoo_layers.COMPUTE_DTYPE = torch.float32
    try:
        for arch in [*zoo_registry.LM_ARCHS, "vlm"]:
            cfg = vlm_test_config() if arch == "vlm" else \
                zoo_registry.get_config(arch).reduced()
            cpu = zoo_transformer.init_params(cfg, seed, device="cpu")
            batch = lm_batch(cfg, 2, 32, torch.Generator().manual_seed(seed),
                             "cpu", frames=16)
            gpu = copy.deepcopy(cpu).to(dev)
            gbatch = {k: v.to(dev) for k, v in batch.items()}
            p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
            l_cpu, g_cpu = zoo_train_step.value_and_grad(cfg, cpu, batch)
            l_gpu, g_gpu = zoo_train_step.value_and_grad(cfg, gpu, gbatch)
            rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
            check(rel <= TRAIN_F32_RTOL, f"15b {arch}: loss {rel}")
            worst = grads_within(g_gpu, g_cpu, cfg.hybrid)
            opt = zoo_optimizer.adamw(TRAIN_LR)
            for m, b in ((cpu, batch), (gpu, gbatch)):
                zoo_train_step.make_train_step(cfg, opt)(m, opt.init(m), b)
            zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
            bound = step_check.step_gap_bound(p0, g_cpu, g_gpu, zeros, zeros,
                                              1, TRAIN_LR)
            gaps = {k: (v.detach().cpu() - w.detach()).abs().double()
                    for (k, v), w in zip(gpu.named_parameters(),
                                         cpu.parameters())}
            check(all(bool((gaps[k].numpy() <= bound[k]).all())
                      for k in gaps), f"15b {arch}: new parameters")
            rows.append({"arch": arch, "loss_cpu": l_cpu.item(),
                         "loss_card": l_gpu.item(), "loss_rel": rel,
                         "grad_max_rel": worst,
                         "param_gap_max": max(v.max().item()
                                              for v in gaps.values())})
    finally:
        zoo_layers.COMPUTE_DTYPE = compute
    emit({"phase": "train_reduced", "rows": rows, "card": card})
    return rows


def phase_train_switches(seed: int, card: str) -> dict:
    """15c: seamless-m4t-medium at full depth, ``CHUNKED_LOSS`` off and on
    (loss and gradients at a batch whose f32 logits fit); deepseek-moe-16b
    at GROUPED_DEPTH layers, ``MOE_GROUPED_DISPATCH = 4`` at capacity E /
    top_k against one group (the loss)."""
    dev = devices.resolve(None)
    out = {}
    cfg = zoo_config("seamless-m4t-medium")
    model = zoo_transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = lm_batch(cfg, CHUNK_B, CHUNK_S,
                     torch.Generator(device=dev).manual_seed(seed + 2), dev,
                     frames=ZOO_FRAMES)
    res = {}
    for chunk in (None, CHUNK):
        zoo_flags.CHUNKED_LOSS = chunk
        try:
            (loss, grads), ms, gb = event_ms(
                lambda: zoo_train_step.value_and_grad(cfg, model, batch))
        finally:
            zoo_flags.CHUNKED_LOSS = None
        res[chunk] = (loss.item(), ms, gb)
        del grads
        torch.cuda.empty_cache()
    rel = abs(res[CHUNK][0] - res[None][0]) / abs(res[None][0])
    check(rel <= 1e-5, f"15c: chunked loss {rel} from the unchunked")
    out["seamless_chunked"] = {
        "layers": [cfg.encoder_layers, cfg.num_layers],
        "vocab": cfg.vocab_size, "batch": CHUNK_B, "seq": CHUNK_S,
        "frames": ZOO_FRAMES, "chunk": CHUNK, "loss": res[None][0],
        "loss_chunked": res[CHUNK][0], "rel": rel,
        "grad_ms": res[None][1], "grad_ms_chunked": res[CHUNK][1],
        "peak_gb": res[None][2], "peak_gb_chunked": res[CHUNK][2]}
    del model
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(
        zoo_registry.get_config("deepseek-moe-16b"), num_layers=GROUPED_DEPTH)
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.num_experts / cfg.top_k)
    model = zoo_transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = lm_batch(cfg, TRAIN_B, TRAIN_S,
                     torch.Generator(device=dev).manual_seed(seed + 3), dev)
    losses = {}
    for groups in (0, GROUPED_G):
        zoo_flags.MOE_GROUPED_DISPATCH = groups
        try:
            with torch.no_grad():
                losses[groups], ms, gb = event_ms(
                    lambda: zoo_transformer.loss_fn(cfg, model, batch))
        finally:
            zoo_flags.MOE_GROUPED_DISPATCH = -1
        out.setdefault("deepseek_grouped", {})[f"G{groups}"] = {
            "loss": losses[groups].item(), "ms": ms, "peak_gb": gb}
    gap = abs(losses[GROUPED_G].item() - losses[0].item())
    check(gap <= 1e-6, f"15c: grouped loss {gap} from the global one")
    out["deepseek_grouped"].update(
        layers=GROUPED_DEPTH, published_layers=28,
        parameters=sum(p.numel() for p in model.parameters()),
        capacity_factor=cfg.capacity_factor, batch=TRAIN_B, seq=TRAIN_S,
        gap=gap, bitwise=bool(torch.equal(losses[0], losses[GROUPED_G])))
    del model
    torch.cuda.empty_cache()
    emit({"phase": "train_switches", **out, "card": card})
    return out


def phase_train(seed: int) -> dict:
    """Phase 15: the zoo's training path on the card; returns 15a's row."""
    card = nvidia_smi()
    seconds = {}
    t0 = time.monotonic()
    row = phase_train_hymba(seed, card)
    seconds["15a"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_train_reduced(seed, card)
    seconds["15b"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_train_switches(seed, card)
    seconds["15c"] = time.monotonic() - t0
    emit({"phase": "train_seconds", **seconds, "card": card})
    return row

# --------------------------------------------------------------------------
# phase 16: the dry run (launch.dryrun) on a fake mesh, and held to the card
# --------------------------------------------------------------------------
DRYRUN_SHAPES = ("train_4k", "decode_32k")      # 16a, with bigmeans_paper
DRYRUN_BOUND_S = 300.0          # 16a and 16b's counts, from their start
HELD_MEMORY_BAND = (0.8, 1.25)  # 16b: dry-run argument + temp over the peak
CLUSTER_MESH = ((16, 16), ("data", "model"))    # 16c: 256 worker positions
_HELD = """
import json, sys
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models.registry import get_config
rec = dryrun.cell(get_config("hymba-1.5b"),
                  ShapeSpec("train_b4_s2048", "train", 2048, 4),
                  mesh_shape=((1, 1), ("data", "model")), device_type="cuda")
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
"""


def start_dryruns(out: Path) -> dict:
    """Start 16a (``python -m repro_torch.launch.dryrun --arch A --shape S
    --device-type cuda``, one process a cell: every LM arch at each of
    ``DRYRUN_SHAPES`` on the 16 x 16 fake mesh, and ``bigmeans_paper``) and
    16b's count (hymba-1.5b at phase 15a's step on a 1 x 1 fake mesh), all
    at once, after the timed phases: they count on the host's cores.
    Returns {name: (process, output path, log path, start)}."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cells = {f"{a}|{s}": ["--arch", a, "--shape", s]
             for a in zoo_registry.LM_ARCHS for s in DRYRUN_SHAPES}
    cells["bigmeans_paper"] = ["--arch", "bigmeans_paper"]
    procs = {}
    for name in (*cells, "held"):
        stem = name.replace("|", "_")
        path, log = out / f"dryrun_{stem}.jsonl", out / f"dryrun_{stem}.log"
        path.unlink(missing_ok=True)
        cmd = ([sys.executable, "-m", "repro_torch.launch.dryrun",
                *cells[name], "--device-type", "cuda", "--json", str(path)]
               if name != "held"
               else [sys.executable, "-c", _HELD, str(path)])
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env,
                                            stdout=f,
                                            stderr=subprocess.STDOUT),
                           path, log, time.monotonic())
    return procs


def stop_dryruns(procs: dict) -> None:
    for proc, *_ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_records(procs: dict, name: str) -> tuple[list, float]:
    """The records of one dry-run process, waited for within
    ``DRYRUN_BOUND_S`` of its start; (records, seconds waited here)."""
    proc, path, log, t0 = procs[name]
    t_wait = time.monotonic()
    left = DRYRUN_BOUND_S - (t_wait - t0)
    try:
        rc = proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        check(False, f"16: the {name} dry run passed its "
              f"{DRYRUN_BOUND_S} s bound")
    seconds = time.monotonic() - t_wait
    check(rc == 0, f"16: the {name} dry run exited {rc}: "
          f"{log.read_text()[-3000:]}")
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()], seconds


def phase_dryrun_matrix(procs: dict, card: str) -> list:
    """16a: each LM arch at train_4k and decode_32k on the 16 x 16 fake
    mesh (``cuda`` device type) and ``bigmeans_paper``: status ok, the
    reference's keys, finite positive counts; each cell's dominant term,
    roofline fraction, dispatch seconds and per-device argument + temp
    GB (counts on a fake mesh, not times)."""
    keys = {"arch", "shape", "mesh", "devices", "status", "memory_analysis",
            "compile_s", "raw_flops_per_device", "raw_bytes_per_device",
            "collective_raw", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "roofline"}
    rows, waited, dispatch = [], {}, {}
    for name in procs:
        if name == "held":
            continue
        recs, waited[name] = dryrun_records(procs, name)
        dispatch[name] = sum(r.get("compile_s", 0.0) for r in recs)
        arch, _, shape = name.partition("|")
        check([(r["arch"], r["shape"]) for r in recs]
              == [(arch, shape or "cluster")],
              f"16a: {name} records {[r['arch'] for r in recs]}")
        for r in recs:
            check(r["status"] == "ok", f"16a: {r['arch']} x {r['shape']}: "
                  f"{r.get('error', r['status'])}")
            want = keys | ({"model_flops_global", "useful_flops_ratio"}
                           if r["arch"] != "bigmeans_paper" else set())
            check(want <= set(r), f"16a: {r['arch']} lacks "
                  f"{sorted(want - set(r))}")
            check(r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
                  and math.isfinite(r["roofline"]["bound_s"]),
                  f"16a: {r['arch']} x {r['shape']} counts")
            mem = r["memory_analysis"]
            rows.append({
                "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                "dominant": r["roofline"]["dominant"],
                "roofline_fraction": r["roofline"]["roofline_fraction"],
                "bound_s": r["roofline"]["bound_s"],
                "dispatch_s": r["compile_s"],
                "argument_plus_temp_gb_per_device": (
                    mem["argument_bytes"] / r["devices"]
                    + mem["temp_bytes"]) / 1e9,
                "flops_per_device": r["flops_per_device"],
                "collectives": r["collective_raw"]["by_op_count"],
                "useful_flops_ratio": r.get("useful_flops_ratio")})
    emit({"phase": "dryrun_matrix", "mesh": "16x16 (fake)",
          "device_type": "cuda", "cells": rows,
          "dispatch_seconds": dispatch, "waited_s": waited,
          "bound_s": DRYRUN_BOUND_S, "card": card})
    return rows


def phase_dryrun_held(seed: int, procs: dict, train_row: dict,
                      card: str) -> dict:
    """16b: hymba-1.5b at 15a's step (B = 4 x 2,048, full width and depth,
    ``REMAT_POLICY="full"``) counted on a 1 x 1 fake mesh, held to the
    card: its FLOPs equal ``FlopCounterMode``'s count of the same step run
    on the card, exactly; its argument + temp bytes beside 15a's measured
    peak, their ratio inside ``HELD_MEMORY_BAND``; 15a's step time over the
    record's ``bound_s`` (the measured roofline fraction)."""
    from repro_torch.launch import hlo_analysis

    dev = devices.resolve(None)
    cfg = zoo_config("hymba-1.5b")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = lm_batch(cfg, TRAIN_B, TRAIN_S, gen, dev)
    model = zoo_transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = zoo_optimizer.adamw(TRAIN_LR)
    state = opt.init(model)
    step = zoo_train_step.make_train_step(cfg, opt)
    check(zoo_flags.REMAT_POLICY == "full", "16b: remat policy")
    with hlo_analysis.flop_counter() as counter:
        _, _, out = step(model, state, batch)
    torch.cuda.synchronize()
    real = counter.get_total_flops()
    check(math.isfinite(float(out["loss"])), "16b: the step's loss")
    del model, state, batch, out
    torch.cuda.empty_cache()
    (rec,), count_s = dryrun_records(procs, "held")
    check(rec["status"] == "ok", f"16b: {rec}")
    check(real == rec["flops_per_device"],
          f"16b: the dry run counts {rec['flops_per_device']} FLOPs, the "
          f"card's step {real}")
    mem = rec["memory_analysis"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    peak = max(train_row["step_peak_gb"]) * 1e9
    ratio = predicted / peak
    lo, hi = HELD_MEMORY_BAND
    check(lo <= ratio <= hi, f"16b: argument + temp {predicted / 1e9:.2f} "
          f"GB is {ratio:.3f}x the measured peak {peak / 1e9:.2f} GB")
    steps = sorted(train_row["step_ms"][1:])
    step_s = steps[len(steps) // 2] / 1e3
    row = {"arch": cfg.name, "batch": TRAIN_B, "seq": TRAIN_S,
           "mesh": rec["mesh"], "flops_dry_run": rec["flops_per_device"],
           "flops_card_flop_counter": real, "flops_equal": True,
           "model_flops": rec["model_flops_global"],
           "argument_gb": mem["argument_bytes"] / 1e9,
           "temp_gb": mem["temp_bytes"] / 1e9,
           "argument_plus_temp_gb": predicted / 1e9,
           "measured_peak_gb": peak / 1e9,
           "predicted_over_measured": ratio, "band": HELD_MEMORY_BAND,
           "roofline": rec["roofline"], "step_s_median": step_s,
           "measured_roofline_fraction": rec["roofline"]["bound_s"]
           / step_s,
           "dispatch_s": rec["compile_s"], "waited_s": count_s,
           "card": card}
    emit({"phase": "dryrun_held", **row})
    return row


def phase_dryrun_cluster(seed: int, card: str) -> dict:
    """16c: the cluster cell on the card: ``fit(method="sharded")`` at the
    cell's 256 worker positions (16 x 16, dealt round-robin onto the one
    card), 4 chunks a worker, ``max_iters`` 8, on a bigmeans_paper-shaped
    mixture (n = 27, the rows padded to the worker grid); A once per Lloyd
    iteration; A's device time (launches x its µs at the chunk shape)
    against the record's modeled bytes (``dryrun.build_bigmeans``)."""
    from repro_torch.launch import dryrun

    cell = paper_cfg.CONFIG
    dims, axes = CLUSTER_MESH
    W = math.prod(dims)
    m = -(-cell.m // W) * W
    rec = dryrun.build_bigmeans(cell, dims)
    X = gmm_dataset(GMMSpec(m=m, n=cell.n_features, components=cell.k,
                            seed=seed + 16), device="cuda")
    cfg = BigMeansConfig(
        k=cell.k, s=cell.s, n_chunks=cell.chunks_per_worker * W,
        sync_every=cell.sync_every, max_iters=dryrun.MAX_ITERS, seed=seed,
        topology=TopologySpec(kind="worker_mesh", devices=dims, axes=axes))
    ops.reset_launch_counts()
    res = fit(X, cfg, method="sharded")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(res.extras["workers"] == W and res.extras["fit"]["impl"] == "cuda",
          f"16c: {res.extras}")
    check(launches["fused_step"] == res.n_iterations > 0,
          f"16c: A launches {launches['fused_step']} against "
          f"{res.n_iterations} iterations")
    check(res.n_iterations <= dryrun.MAX_ITERS * cfg.n_chunks,
          "16c: more iterations than the cell's budget")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xc = X[torch.randint(0, m, (cell.s,), generator=gen, device="cuda")]
    c = xc[:cell.k].clone()
    a_ms = device_ms(lambda: fused_step.fused_step_f32(xc, c), 20)
    kernel_s = launches["fused_step"] * a_ms / 1e3
    modeled = rec["bytes"] * W
    row = {"workers": W, "mesh": "x".join(map(str, dims)),
           "chunks": cfg.n_chunks, "m": m, "n": cell.n_features,
           "k": cell.k, "s": cell.s, "max_iters": dryrun.MAX_ITERS,
           "n_iterations": res.n_iterations, "launches": launches,
           "a_us": 1e3 * a_ms, "a_kernel_s": kernel_s,
           "modeled_passes_per_chunk": dryrun.MAX_ITERS + 2,
           "measured_passes_per_chunk": res.n_iterations / cfg.n_chunks
           + 2,
           "modeled_bytes_all_workers": modeled,
           "modeled_bytes_over_a_time_per_s": modeled / kernel_s,
           "modeled_bound_s": modeled / roofline.HBM_BW,
           "fit_wall_s": res.wall_time_s, "f_best": res.objective,
           "card": card}
    emit({"phase": "dryrun_cluster", **row})
    del X
    torch.cuda.empty_cache()
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    # phase 1: device (and no tuning, unless phase 4e asks for it)
    autotune.enable(False)
    autotune.set_cache_path(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32, as XLA's do (the zoo, phase 14)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "matmul_allow_bf16_reduced_precision_reduction":
          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    procs: dict = {}
    try:
        return run_phases(args, smi, procs)
    finally:
        stop_dryruns(procs)


def run_phases(args, smi: str, procs: dict) -> int:
    """Phases 2-16 and the final lines."""
    # phase 2: build
    build.load(rebuild=True)
    info = build.info()
    check(info.built, "the kernels were not built from source")
    passes = check_assign_sass(sass_ops(info.path))
    mma = {name: row for name, row in info.resources.items()
           if any(part in name for part in (
               "assign_mma_kernel", "assign_f32_pass", "assign_fold",
               "sqnorm_chain_rows", "split_bf16_rows"))}
    emit({"phase": "build", "arch": build.ARCH, "seconds": info.seconds,
          "library": str(info.path.relative_to(ROOT)),
          "ptxas": info.resources,
          "dma_dynamic_smem_bytes": info.dma_smem_bytes})
    emit({"phase": "build_assign_kernels", "ptxas": mma,
          "dynamic_smem_bytes": info.mma_smem_bytes, "sass": passes})

    # phase 3: kernels vs plain (3b: the int8 kernels; 3c: bf16, bf16x3;
    # 3d: the dma kernels; 3e: kernel P, and its entry point's run; 3f:
    # kernel G and the slot chain)
    errs = phase_kernels(args.seed)
    errs.update(phase_kernels_int8(args.seed))
    errs.update(phase_kernels_16(args.seed))
    errs.update(phase_kernels_dma(args.seed))
    errs["kpp_probe"], kpp_path = phase_kpp(args.seed)
    errs["kpp_draw"], draw_row, probe_row, chain_path = phase_kpp_chain(
        args.seed)

    # phase 4: the sequential main path (4b: at int8)
    X, res, launches, wall, seq_walls, f_full = phase_main(args.seed)
    paths = {"sequential": (launches, wall)}

    # phase 5: the batched main path (5b: at int8)
    res_b, f_full_b, launches_b, wall_b = phase_batched(X, args.seed,
                                                        seq_walls)
    paths["batched"] = (launches_b, wall_b)
    paths["int8_sequential"] = phase_main_int8(X, args.seed, f_full)
    paths["int8_batched"] = phase_batched_int8(X, args.seed, f_full)
    # phases 4c, 4d (sequential) and 5d, 5e (batched): bf16 and bf16x3
    for prec in POLICIES16:
        paths[f"{prec}_sequential"] = phase_main_16(X, args.seed, prec,
                                                    f_full)
    for prec in POLICIES16:
        paths[f"{prec}_batched"] = phase_batched_16(X, args.seed, prec,
                                                    f_full)
    # phase 4e: the autotuned fits, and the fits with the dma pipeline
    # pinned
    paths.update(phase_autotuned(X, args.seed, (res, f_full),
                                 (res_b, f_full_b)))

    # phase 6: times
    times = phase_times(X, res, args.seed)
    times["kpp_draw"] = draw_row
    times["kpp_probe"]["at_codebook_seeding"] = probe_row
    # phase 7: the streaming strategy, fit("data.npy") out of core; phase
    # 8: faults and middleware on the same file
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_"))
    try:
        path = write_stream_file(X, args.seed, tmp)
        paths.update(phase_streaming(X, path, args.seed, {
            "sequential": (res.wall_time_s, wall),
            "batched": (res_b.wall_time_s, wall_b)}))
        fault_paths = phase_faults(X, path, args.seed)
        # phase 9: checkpoints and resume on the same file
        ckpt_root = tmp / "ckpt"
        ckpt_root.mkdir()
        fault_paths.update(phase_resume(X, path, args.seed, ckpt_root))
        # phase 10: serving phase 4's fit
        serve_paths, serve_rows = phase_serve(X, res, args.seed, tmp)
        fault_paths.update(serve_paths)
        # phase 12: the sharded strategy, the stream mesh and the host
        # mesh (12d streams the same file)
        fault_paths.update(phase_multi(X, path, args.seed, tmp, f_full,
                                       res_b, f_full_b))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # phase 11: the §5 baselines on phase 4's data
    fault_paths["baselines"], baseline_times = phase_baselines(
        X, f_full, args.seed)
    times["assign_f32"]["at_kmeans_parallel_pool"] = baseline_times[
        "assign_f32"]
    times["update_f32"]["at_kmeans_parallel_pool"] = baseline_times[
        "update_f32"]
    times["fused_step_f32"]["at_full_data"] = baseline_times[
        "fused_step_f32"]
    times["kpp_probe"]["at_full_data"] = baseline_times["kpp_probe"]
    # phase 13: the reproduction suite, the paper's workload config on
    # phase 4's data and the chunk roofline of phases 4 and 5
    fault_paths.update(phase_suite(X, args.seed, res_b, paths))
    n_eval = math.ceil(X.shape[0] / EVAL_BATCH)
    for path, (counts, path_wall) in paths.items():
        device_share(path, times, counts, n_eval, path_wall)
    paths.update(fault_paths)
    paths["kpp_probe_entry"] = kpp_path
    paths["kpp_chain"] = chain_path
    del X
    torch.cuda.empty_cache()

    # phases 5c, 5f: the two-pass route at int8 and at bf16 (their own
    # data set)
    spec2, X2, gen_s = two_pass_data(args.seed)
    launches_2p, wall_2p, two_pass_errs, two_pass_times = (
        phase_two_pass_int8(spec2, X2, gen_s, args.seed))
    paths["int8_two_pass"] = (launches_2p, wall_2p)
    launches_2p, wall_2p, two_pass_errs_16, times_16, b_eval = (
        phase_two_pass_16(X2, args.seed))
    paths["bf16_two_pass"] = (launches_2p, wall_2p)
    # the update kernels' rows carry their times at the two-pass shape
    two_pass_times.update(times_16)
    for name, row in two_pass_times.items():
        times[name]["at_two_pass_shape"] = row
    times["assign_f32"]["at_two_pass_evaluate_batch"] = b_eval
    # the assign kernels at the serving buckets (phase 10)
    for name, rows in serve_rows.items():
        times[name]["at_serving"] = rows
    del X2
    torch.cuda.empty_cache()
    # B8, C8 and B16 run on the main path only at the two-pass shape: their
    # errors in the final line are those of that shape (phases 3b and 3c
    # hold the main chunk shape's)
    errs.update(two_pass_errs)
    errs["assign_bf16"] = two_pass_errs_16["assign_bf16"]

    # phase 14: the model zoo on the card, its embedding clustering and
    # the clustering launcher
    zoo_rows, zoo_paths = phase_zoo(args.seed)
    for name, row in zoo_rows.items():
        times[name]["at_embedding"] = row
    paths.update(zoo_paths)
    del zoo_rows
    torch.cuda.empty_cache()

    # phase 15: training the zoo (hymba at full width and depth, the
    # reduced configs against the CPU, the switches at width)
    train_row = phase_train(args.seed)

    # phase 16: the dry run (16a the fake 16 x 16 matrix, 16b held to
    # 15a's step, 16c the cluster cell on the card), counted on the host's
    # cores after every timed phase; 16b's step on the card and 16c after
    # the counts
    card = nvidia_smi()
    t0 = time.monotonic()
    procs.update(start_dryruns(ROOT / "build" / "dryrun"))
    phase_dryrun_held(args.seed, procs, train_row, card)
    phase_dryrun_matrix(procs, card)
    waited = time.monotonic() - t0
    t0 = time.monotonic()
    phase_dryrun_cluster(args.seed, card)
    emit({"phase": "dryrun_seconds", "16ab_wait": waited,
          "16c": time.monotonic() - t0, "card": card})

    # launches: each kernel's from the path that drives it (PATH_OF),
    # every path's counts beside them
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths[PATH_OF[name]][0][COUNTS[name]],
         "launches_per_path": {p: c[COUNTS[name]]
                               for p, (c, _) in paths.items()},
         "max_abs_err": errs[name], **times[name]}
        for name, (src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
