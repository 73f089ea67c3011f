#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

Run from the root of the repository:  python3 chip_smoke.py
(``--lm`` runs phases 1-2, 12-13 and the LM profile only; ``--launch``
phases 1-2 and 20, the launch layer; ``--sharded`` phases 1-2 and 21,
sharded execution on a world of NCCL ranks; ``--train``
phases 1-2, 19 and 19p, training smollm-360m at full width from the
document lake; ``--families``
phases 1-2 and 18, the MoE, SSM, encoder-decoder and VLM families at
full width; ``--serve``
phases 1-2 and 14, the serving path; ``--mutable`` phases 1-2, the
soc-LiveJournal1 set-up, 15 and 16, the mutable plane; ``--partitions``
phases 1-2, the soc-LiveJournal1 set-up and 17, the partition plane, its
oracle then from the numpy engine; ``--traversal``
phases 1-3, 5 and 6, which hold and time kernels 3 and 5 and drive the
traversal path that launches them; ``--per-dispatch`` phases 1-2, the
soc-LiveJournal1 set-up and phase 9, which hold and time kernels 8-10,
with no slice phase, so that their rows count no launches; ``--resident``
phases 1-4, which hold and time kernels 1-4 and drive the resident
retrieval slice that launches them; ``--entries`` phases 1-2, the
soc-LiveJournal1 set-up and phases 10-11, which drive the entries and hold
and time kernels 11-14, phase 10's batch-16384 PAC then from the numpy
engine.)

Phases, each of which exits non-zero when it fails (12, 13, 18, 14 and 19
run right after 2, in that order, so that their host timings come before
any profiler in the process; the LM and training profiles run last):
  1. device: require a CUDA device; print the card's name and power limit;
  2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` (timed); print
     ptxas's registers and spills, and count the tensor-core instructions
     (HGMMA) of each bf16 flash kernel in the library's SASS
     (``cuobjdump -sass``): each must have some, and no flash,
     per-dispatch, resident fused, single-range, RLE-label or selection
     kernel may spill;
  set-up: a soc-LiveJournal1-sized graph (4,847,571 vertices, ~69.0M
     edges) from ``powerlaw_graph`` and 8 ``clustered_labels``, ``by_src``
     adjacency at page size 2048;
  3. kernels: an empty kernel's launch-to-completion time (the launch
     floor); each of the four kernels against its plain PyTorch version
     on the card, at the shapes the main path gives it, bit for bit;
     timed against the plain version and against its bound
     (``gather_decode`` at 8 rows, a launch's overhead, and as row
     ``gather_decode@16384`` at the retrieval slice's p_pad-16384 page
     list, each beside its device time queued behind the host).  The fused
     kernels (1 and 4) are held with ``want_ids`` both ways and with junk
     rows past ``total``; each logs its call time beside its device time
     queued behind the host, the mean ``need / page_size`` of the real
     rows (the prefix a row is decoded to) and its bound beside the
     whole-row bound; row ``fused_gather_decode_bitmap_batch@want_ids``
     times kernel 1's cold-LRU call, which returns the decoded matrix;
  4. slice: ``retrieve_neighbors_batch(engine="cuda")`` over batches of
     8 / 16 / 1024 / 16384 vertices, unfiltered and filtered by
     ``(L0 & L1) | ~L2``, with no page cache and with a 4096-page LRU
     (cold, then warm); every run is held against the ``numpy`` engine
     (PAC, IOMeter and LRU counters equal) and every kernel must have
     launched;
  5. traversal: the ``TraversalPlan`` built on the card (timed), then
     ``k_hop(engine="cuda")`` from 1, 8 and 64 seeds at 2 and 3 hops,
     unfiltered, filtered and with the per-hop list ``[None, filt, ...]``:
     meterless runs timed (host ms, median of 3, one device round trip
     each), runs with a meter (no cache, then a 4096-page LRU cold and
     warm) held against the host-loop oracle; ``two_hop_pac`` from one
     seed against the staged numpy path, and ``frontier_edge_counts``
     over ``L0``'s intervals against a numpy bincount; the traversal
     kernels, ``gather_decode`` (the plan build) and ``cond_bitmap`` (the
     predicate plane) must have launched;
  6. traversal kernels: ``khop_scan``, ``two_hop`` and ``count_hop``
     against their plain versions on the card, bit for bit, at the
     traversal path's shapes and with padding keys, sentinel seeds and
     intervals, overlapping intervals and an end equal to ``n_key``; timed
     against the plain version and against the bound.  (Row 7b,
     ``count_hop`` at BI-2's shape, is measured after phase 8.)
  7. per-dispatch: the configurations of phase 4 again, on the
     per-dispatch pack route (``pac_decode.ops.DEVICE_RESIDENT`` off for
     the phase: pages shipped packed with every dispatch), each run held
     against phase 4's numpy results; ``delta_decode`` and both
     ``fused_decode*_bitmap_batch`` kernels must have launched;
  8. ldbc: ``ldbc_like(scale=40)`` (400,000 persons, 3,200,000 messages)
     built with ``build_snb_graphar`` and ``build_snb_baseline``; IS-3,
     IC-8 (the person with the most messages, unlabeled, and the fused
     hop 2's (person, tag class) with the most labeled replies, whose
     answer must not be empty) and BI-2 for ``LDBC_BI2_CLASSES`` (1 of
     the 8 tag classes), under
     the resident route and then the per-dispatch one, each run held
     against the numpy engine (result and IOMeter) and the acero baseline
     (result), timed (host ms, median of 3) beside acero (one run: three
     before phase 21's families needed the room); each route's
     kernels must have launched; profiled (host cProfile, device busy by
     kernel, ``count_hop``'s device ms for BI-2); then, outside the counted
     run, row 7b: ``count_hop`` at BI-2's shape (the ``message-hasTag-tag``
     plan, 3,200,000 messages to 64 tags, over TagClass3's intervals)
     against its plain version bit for bit, timed beside it and its bound;
  9. per-dispatch kernels: ``delta_decode``, ``fused_decode_bitmap_batch``
     and ``fused_decode_filter_bitmap_batch`` against their plain versions
     on the card, bit for bit, at phase 7's batch-16384 cold-LRU shapes,
     warm (no miss page), with ``gidx`` rows past ``gcount`` and past the
     matrix and under two programs; timed against the plain version and
     the bound (each row's time a call beside the device's own time with
     the calls queued behind the host), the host pack and the copy to the
     card timed apart; then each launch's device time in the fused calls
     (kernel 8: decode and scatter; kernel 9: decode and the filtered
     scatter that evaluates the predicate) from a ``torch.profiler``
     window.
 10. entries: ``ids_to_bitmap`` (phase 4's batch-16384 PAC, the sorted
     ``<src>`` ids and a window of them), ``decode_range_to_bitmap`` (the
     whole ``<src>`` and the whole unsorted ``<dst>`` column, and a
     page-aligned sub-range with a non-zero base), ``rle_to_bitmap`` (the
     8 label columns, ``want`` True and False, and a scattered column),
     ``select_from_pages`` (a seeded ``age`` property by the batch-16384
     PAC) and ``retrieve_neighbors_batch`` of that batch filtered by two
     ``NumericFilter``s over ``age`` and one that also takes a NOT over a
     leaf of a clustered ``joined`` property whose zone maps skip pages,
     resident and per-dispatch; each run
     held bit for bit against the numpy oracle (the raw edge arrays' id
     sets, the dense label planes, ``vals[pac.to_ids()]``, the numpy
     engine with its IOMeter and property-page counters);
 11. entry kernels: the launch floor; ``bitmap``, ``fused_decode_bitmap``,
     ``rle_to_bitmap`` and ``bitmap_select`` against their plain versions
     on the card, bit for bit, at phase 10's shapes; timed against the
     plain version, the bound and, for ``bitmap_select``,
     ``torch.masked_select``; each row's call time beside its device time
     queued behind the host; ``fused_decode_bitmap`` over the sorted
     ``<src>`` as row ``fused_decode_bitmap@src``, ``rle_to_bitmap`` over
     the scattered column (row 13) and over the clustered label ``L0`` as
     row ``rle_to_bitmap@label``.
 12. lm: smollm-360m at full width (32 layers, d_model 960, 15 query and
     5 KV heads of 64, d_ff 2560, vocab 49152, tied, bf16), weights from
     the port's ``init(seed=0)`` on the card.  (a) ``forward`` of 4 x 2048
     seeded tokens on the flash route (kernel 15, 32 launches per forward)
     and on the plain route in bf16, each against the float32 plain route:
     max |d logit|, top-1 agreement over all positions and over the
     decisive ones (top two float32 logits more than 4 bf16 steps apart;
     there it must be >= 0.99), the flash error at most 1.5x the plain
     route's; (b) float32 flash against float32 plain within 1e-3 of max
     |logit|, and ``loss`` on both; (c) 4 ``HashTokenizer`` prompts cut
     or padded to 512 tokens prefilled into a bf16 cache of 1024, 32
     greedy decode steps, every step held against the plain full forward
     over the same tokens (top-1 equal on every decisive position), and
     prompts of 128/256/384/512 prefilled one by one into a vector-index
     cache (``serve.steps.write_slots``) and decoded together; host ms of
     the forward, prefill and decode step, median of 3;
 13. flash kernel: kernel 15 against ``attention_ref`` on the card at
     [60, 2048, 64] and at one block, d 32, 128 and 256, float32 (1e-4)
     and bf16 (0.1), causal and not; timed at [60, 2048, 64] bf16 causal
     beside the plain version, the bound and
     ``scaled_dot_product_attention``; then the forward's own call,
     ``ops.mha`` on [4, 15, 2048, 64] queries over [4, 5, 2048, 64] KV
     heads as strided views of [b, s, h, d] tensors, bf16 causal, against
     the plain version (0.1, and elementwise 2^-8 (|want| + max|v|)),
     timed beside it, the bound and ``scaled_dot_product_attention`` with
     ``enable_gqa=True`` (row ``flash_attention@gqa``); then row 15o, the
     sequence-parallel call: the same tensors' query rows 0..1024 and
     1024..2048 (``q_start`` 0 and 1024, ranks 0 and 1 of ``model`` 2)
     over the whole K/V, each against its plain version (the same bounds)
     and bit for bit the whole call's rows, timed beside it, its bound
     over the (row, key) pairs it computes and
     ``scaled_dot_product_attention`` under ``causal_lower_right`` over
     the keys cut to ``q_start + 1024`` (``flash_attention@q_start0``,
     ``@q_start1024``);
 14. serve: smollm-360m at full width (phase 12's configuration, bf16,
     ``init(seed=0)``) in a ``ServeEngine`` of 8 slots of 1024 positions
     behind a ``GraphRetriever(engine="cuda", max_neighbors=2,
     tokens_per_neighbor=16, hops=2)`` scoped to ``HighQuality & ~Spam``
     over ``document_graph(100_000, vocab 49152, mean_len 256, seed=2)``
     (~25.6M tokens, ~800k links, ``doc-links-doc`` by source at page size
     2048), with the two tenants of ``examples/serve_batched.py``; 32
     seeded greedy requests (prompts of 24-256 of the seed document's
     tokens, 32 new tokens; 8 ``prod``, 24 ``batch``, of which some are
     shed) arriving at a steady rate, Poisson gaps of mean 2 ticks.  A
     throwaway engine warms the process; then four drains, each engine
     over a fresh lake, in the order pipelined (P1), sequential
     (``pipeline=False``, S1), S2, P2.  (a) P1 against S1, bit for bit:
     every finished request's id, status, tokens, prompt and context, the
     shed outcomes, IOMeter, the retrievers' calls and seeds, the LRU's
     hits and misses; S2 and P2 equal to them; (b) a ``numpy``-engine
     retriever fed S1's recorded seed batches: equal contexts, IOMeter and
     LRU counters; (c) 4 requests re-run alone (prefill and
     ``decode_step`` at batch 1, fed the engine's tokens): top-1 equal to
     the engine's token on every step before the first that is not
     decisive (phase 12's rule).  Prints requests served and shed; for
     each drain its ticks and tokens per second, its first (cold) decode
     tick and its tokens per second over the warm ticks after it; each
     part of the tick split over P1's and P2's warm ticks (median, min,
     max), the prefetch counters and overlap, the host syncs of a decode
     step and of a retrieval call (``torch.cuda.set_sync_debug_mode``),
     and the launches of kernels 2, 3 and 5 in P1, which must all have
     launched;
 15. mutable: the soc-LiveJournal1 adjacency (after phase 11, the last
     phase that reads it, since this one compacts it in place): a fused
     ``k_hop`` builds (or reuses) the write-once traversal plan; 16 seeded
     batches of 4,096 rows (65,536, 0.095% of the base) go through
     ``ingest_edges``, keys the ``<src>`` of uniformly drawn base rows,
     values uniform, one row in 16 a copy of its base row's edge; the
     oracle is a CSR sorted with numpy from the base's ``(src, dst)`` read
     once with the numpy engine and the ingested arrays, with no delta
     plane in it.  With the rows pending, each equal to the oracle:
     ``retrieve_neighbors_batch`` over phase 4's batches of 1024 and 16384
     and a batch of 16384 half drawn from the ingested keys, unfiltered
     and ``(L0 & L1) | ~L2``, no cache, then a 4096-page LRU cold and
     warm; ``neighbor_ids_batch(unique=False)`` over the 1024;
     ``k_hop`` from 1, 8 and 64 seeds at 2 and 3 hops, unfiltered and
     filtered (each the counted host-loop fallback).  The poisoned mirror:
     ``pack_column(col).poison()``, then batch 16384 both ways equal with
     no launch of kernels 1 and 4 and ``fallbacks`` up; ``bump_version``
     heals it (one transfer, kernel 1 again).  ``CompactionRunner(adj)
     .maybe_compact()`` in memory, timed by stage; the first ``k_hop``
     after it rebuilds the plan once and runs fused, and device memory
     (``torch.cuda.memory_allocated``) after it is within 5% of its value
     before the compaction, every stale plan holding no arrays; then the
     same reads equal the oracle and the pending reads bit for bit, with
     ``k_hop`` fused (kernel 5, no fallback).  Prints ingest ms a batch,
     delta lookup ms, each batch's host ms pending and compacted, the
     compaction's seconds and stages, the plan rebuild and device memory;
     kernels 1-5 must all have launched;
 16. serve mutable: phase 14's configuration (its model and lake, or
     built anew under ``--mutable``) with 8 seeded ``ServeEngine.ingest``
     calls of 512 links at ticks 4, 12, ..., 60, their sources the
     requests' seed documents; one pipelined and one sequential drain,
     each over a fresh lake.  (a) pipelined equal to sequential bit for
     bit (requests, shed outcomes, IOMeter, calls, LRU, the ``mutable``
     stats), mis-speculations printed; (b) a numpy retriever fed the
     sequential drain's calls and ingests in their order: equal contexts,
     IOMeter and LRU.  Then the sequential drain's lake saved to a
     ``GraphStore`` in a temporary directory under ``build/`` and compacted
     under ``FaultPlan({"store.write": 1, "compact.pre_swap": 1,
     "compact.mid_gc": 1})``: generation 1 committed with 3 faults
     absorbed, the superseded files collected, the tables
     ``GraphStore.read`` gives back equal to the compacted pages; the next
     retrievals (the last 4 recorded seed batches) run ``khop_scan`` again
     and equal the numpy retriever's, compacted in memory.  A throwaway
     warm-up engine runs first (phase 14's), then the drains in the order
     P S; kernels 2, 3 and 5 must have launched in the pipelined drain
     (the counts are its own);
 17. partitions (after phase 11, before 15, on the soc-LiveJournal1
     adjacency): (a) the single-card tail: phase 4's batches of 1024 and
     16384, unfiltered and ``(L0 & L1) | ~L2``, no cache and a 4096-page
     LRU cold and warm, first on the monolithic column (timed), then with
     the column in 8 partitions (``partition_column``); each PAC and
     IOMeter equal to phase 4's numpy oracle (the numpy engine's when
     phase 4 did not run), the LRU counters to the numpy engine's over the
     partitioned column; host ms of each partitioned batch beside the
     monolithic one's; (b) the partitioned traversal plan (timed), then
     ``k_hop`` from 1, 8 and 64 seeds at 2 and 3 hops, unfiltered and
     with the per-hop list ``[None, filt, ...]``, with a meter, equal to
     the host-loop oracle (ids and IOMeter), ``two_hop_pac`` and
     ``frontier_edge_counts`` equal to phase 5's oracles; (c) the
     multi-device tail (``pac_decode.ops._devices`` replaced by a mesh,
     ``SHARD_MIN_PAGES`` 0) on meshes naming the card 8 times and 4 times
     (two partitions an entry), and over the real cards when there are
     several: (a)'s batch-16384 cases, the page-matrix decode of batch
     1024 and (b)'s ``k_hop`` cases equal to the same oracles, each call
     one launch of kernel 1, 4 or 2 per mesh entry (never one per
     partition) and, per hop, one expansion per entry and one
     ``rt_merge_hop``; (d) statistics pruning on the community-local graph
     of ``benchmarks/bench_partition.py:_fixture(local=True)`` (2^20
     vertices of degree 16, page 2048, ``HOT`` the first quarter of the
     ids): batches of 1024 and 16384 filtered by ``L("HOT")`` at 8
     partitions, ids equal to the numpy oracle on the monolithic column,
     IOMeter equal to the numpy engine's over the partitions and no larger
     than the monolithic column's, ``stats_pruned`` above 0, pages decoded
     beside the monolithic count.  Device memory before and after, with
     no cyclic collection (a partitioned column's plane holds it weakly),
     within 2% in the full run, where phase 4 placed the monolithic plan
     before; the column is left monolithic for phase 15.  Then (uncounted) the sharded
     k-hop's launches against their plain versions at the 8-entry shape:
     ``seed_words``, one entry's ``expand_words`` and ``rt_merge_hop``,
     each timed beside its bound;
 18. families (after 13, before 14): deepseek-moe-16b, llama-3.2-vision-11b,
     mamba2-2.7b and whisper-small at full width, bf16, ``init(seed=0)``
     with every cross sub-layer's ``x_gate`` at 0.5 (at its initial 0 the
     cross sub-layer adds nothing), one model at a time, each freed before
     the next.  (a) a forward of 4 x 2048 seeded tokens (whisper: 4 x 448
     over 4 x 1,500 seeded frames; llama-vision: 1,600 seeded vision
     embeddings), on the flash route (kernel 15, one launch a layer) and
     the plain one for deepseek and llama-vision; the reference is the
     float32 plain route of the same weights widened (a float32 copy built
     alone on the card and freed before the bf16 one: deepseek's takes 61
     GiB); the top-1 of each bf16 route equal to the reference's on at
     least 0.99 of the decisive positions (phase 12's rule), except on
     MoE, where bf16 rounding moves tokens across the top-6 routing and
     capacity boundaries: there the float32 flash route is held at 0.99
     and the bf16 flash route within 0.01 of the bf16 plain route; and
     on mamba2, where bf16 rounding compounds over 64 random-init layers,
     the whole phase runs its first 8 layers at full width (the run's time
     limit; deepseek its first 8, llama-vision its first 10, to make room
     for phase 20); whisper runs
     ``use_flash=False``, and kernel
     15 is checked to refuse
     its lengths (no multiple of 128) rather than fall back; (b) a prefill
     of 4 x 512 seeded tokens and 16 greedy decode steps, held (except for
     MoE, whose capacity depends on the batch shape) against the plain
     full forward over the same tokens, top-1 equal on every decisive
     step; (c) one deepseek MoE layer at T = 8192 (64 experts, top 6,
     capacity 960; the tokens skewed by a shared direction, so that some
     assignments drop) through ``moe_apply`` and the plain per-expert
     loop ``moe_ref``: keep masks identical, outputs within 2^-6 of the
     largest |output|; one mamba2 mixer's ``ssd_chunked`` against the sequential
     ``ssd_reference`` at L = 1024 (4 chunks), float32, within 1e-4 of the
     largest |value|; (d) mamba2 in a ``ServeEngine`` of 4 slots behind
     phase 14's ``GraphRetriever(engine="cuda")`` over
     ``document_graph(10_000, vocab 50280, mean_len 256, seed=2)``, 8
     seeded greedy requests of 16 tokens: after a warm-up drain, the
     pipelined drain equal to the sequential one bit for bit, batched
     decode equal to solo decode on decisive steps, tokens per second;
     (e) reduced jamba-1.5-large-398b (741.5 GiB in bf16 at full width)
     and qwen3-moe-30b-a3b on the card against the CPU, float32, within
     2e-4.  Prints each model's forward, prefill and decode-step host ms
     (median of 3), its peak ``torch.cuda.max_memory_allocated`` and
     kernel 15's launches; then (uncounted) row 15d: kernel 15 at head
     dim 128 as deepseek calls it ([4, 16, 2048, 128], MHA,
     ``flash_attention@d128``) and as llama-vision does ([4, 32, 2048,
     128] over 8 KV heads, ``flash_attention@d128gqa``), each against its
     plain version, timed beside it, the bound and
     ``scaled_dot_product_attention``;
 19. train (after 14, on its lake): smollm-360m at full width (32 layers,
     d_model 960, 15/5 heads of 64, bf16, ``init(seed=0)``, the config's
     ``remat="dots"`` and 4 microbatches) trained for 6 steps of 8 x 2048
     tokens from phase 14's ``document_graph(100_000, vocab 49152,
     mean_len 256, seed=2)`` lake (built when phase 14 did not run)
     through ``GraphCorpusPipeline(engine="cuda")`` under ``(HighQuality |
     News) & ~Spam``, with ``adamw(warmup_cosine(3e-4, 5, 6))``.  (a) the
     eligible documents equal the numpy engine's, and the label filter's
     kernel (3) launched; (b) every loss finite, the mean of the last 3
     below the mean of the first 3; (c) one step of 4 microbatches equal
     to one of 1 on a float32 copy at 8 x 512 (params rtol 2e-4, atol
     5e-4; loss within rel 1e-5, grad norm within rel 1e-4);
     (d) the bf16 loss within 2% of the float32 copy's and the cosine of
     their flattened gradients at least 0.99; (e) ``Trainer`` for 6 steps
     on the model's first 4 layers at full width (one microbatch of 8 x
     512 a step, AdamW's moments in bf16 too), a
     checkpoint every 3 under ``build/``
     (removed after), a crash at 5,
     against a clean run: histories within rel 1e-4; (f) a
     ``use_flash=True`` loss under autograd raises.  Prints the warm step
     (median of steps 3-6) split into the pipeline's host ms and the
     step's host wall, with its forward+backward and optimizer on the
     device's clock; tokens per second; peak ``max_memory_allocated``; a
     checkpoint of the trained state saved and restored (bytes, seconds,
     equal); kernel 3's launches;
 12p. lm profile: ``torch.profiler`` over one forward, prefill and decode
     step of the bf16 model: device busy ms by kernel, idle share against
     phase 12's unprofiled host wall; then (14p) 20 ticks of phase 14's
     pipelined engine on a fresh lake, every request submitted at once,
     busy and idle share against phase 14's unprofiled median warm tick;
 19p. train profile: ``torch.profiler`` over one warm train step of phase
     19's model at its full batch: device busy ms by kernel, idle share
     against phase 19's unprofiled median step.
 20. launch (after every profile, the earlier phases' models freed),
     smollm-360m at full width: (a) (under ``--launch``; phase 21 (a)
     traces the same rows in the full script) the dry-run
     (``launch/dryrun.py``) of the reference's
     ``tests/test_dryrun_small.py`` cells (smollm-360m ``train_4k``,
     mamba2-2.7b ``decode_32k``, whisper-small ``prefill_32k`` on the
     2x4 test mesh, smollm-360m ``train_4k`` on 2x2x2), traced on
     ``meta``, each ``ok`` with its roofline terms, and ``python -m
     repro_torch.launch.train --arch smollm-360m --lower-only`` in a
     subprocess (exit 0, its row ``ok``);
     ``torch.cuda.memory_allocated`` unchanged across (a); (b) smollm's
     three cells run on the card at the largest batch that holds
     (``LAUNCH_*``: a train step of one microbatch of rows of 4096, a
     prefill cut to 16384, decode cut in slots of a 32768 cache) and
     traced on ``meta`` at the same cut on a one-entry mesh: the dry-run's
     parameter, optimizer and cache bytes equal to the real tensors',
     the step's peak ``max_memory_allocated`` at least the dry-run's
     argument bytes, the profiler's device busy ms printed beside
     ``t_compute`` and ``t_memory``; (c) a bf16 checkpoint of the model's
     parameters from ``save_checkpoint`` under ``build/`` restored by
     ``elastic_restore`` onto the 2x4 test mesh naming ``cuda:0``: every
     leaf's ``full()`` and each shard (its ``indices()`` slice) bit-equal
     to the saved tree, device memory after placement within 1% of the
     tree's bytes and back to its value before once the shards are
     dropped; (d) ``repro_torch.launch.serve.main`` for 8 requests of 16
     tokens at full width on ``cuda:0``: 8 x 16 tokens served.
 21. sharded (last; ``--sharded`` alone): (a) the dry-run on a fake world
     (``launch/mesh.py:fake_world``): phase 20's four cells and
     smollm-360m ``train_4k`` on 16x16 (``launch.train --lower-only``),
     each traced as rank 0 of the mesh's ranks on ``meta`` in a process
     of its own, all started with the phase and run during (b)'s set-up,
     (b)'s ranks waiting for them before their first timed step:
     ``coll_count``, collective bytes by op and ``t_collective`` beside
     the virtual row (each ``ok``, no collective; the train cells must
     issue collectives);
     and the same cuts as (b) (smollm-360m, 8 x 2048, and, where the
     mesh has more than one rank, each family's) on (b)'s mesh, on a
     fake world whose meshes take the cards' device type (DTensor plans
     as on the cards: NCCL's all-to-all, the host's cards), its steps
     accumulating gradients in float32 as (b)'s do;
     (b) a world of ``torch.cuda.device_count()`` NCCL ranks spawned
     from the script (``--sharded-rank``), one a card: a (1, 1) mesh on
     one card, (data 2, model 2) on four.  Each rank: smollm-360m at full
     width (bf16, ``init(seed=0)``, 4 microbatches, remat "dots") placed
     by the sharding rules (``shard_model``), 3 train steps of 8 x 2048
     from phase 14's lake (pickled by the parent; its 100,000 docs built
     when phase 14 did not run), each data rank's shard through
     ``GraphCorpusPipeline(engine="cuda")`` (kernel 3), the global batch
     a DTensor of the data ranks' local ones; rank 0 then runs the
     first two one-card steps on the same weights and gathered batches
     (all 3 before the families needed the room): losses within 1e-2,
     and the sharded forward's top-1 equal to the one-card
     forward's on every decisive position (phase 12's rule); the first,
     cold, step traced for its NCCL collectives (count and bytes), the
     warm step the median of the other two; stablelm-1.6b at full width
     on the flash route, 4 x 2048, kernel 15 on each rank's local heads
     (``local_map``), top-1 equal to the same card's one-rank forward on
     every decisive position; smollm-360m's flash forward, 4 x 2048 (15
     heads: on ``model`` 2 the sequence-parallel route, each rank's query
     rows through kernel 15 from its ``q_start``), top-1 equal to the
     one-card forward on at least 0.99 of the decisive positions; phase
     20's bf16 checkpoint of smollm-360m (written again under ``build/``)
     restored by ``elastic_restore`` onto the mesh, each rank holding
     exactly its ``indices()`` slices.  Then the other families at full
     width, cut in depth (``SHARDED_FAMILIES``: deepseek-moe-16b's dense
     layer and 2 MoE units, mamba2-2.7b's first 4 layers,
     llama-3.2-vision-11b 1 unit of 5 layers with its cross layer and
     1,600 vision tokens, whisper-small whole over 1,500 frames), bf16,
     ``init(seed=0)``, gates at 0.5: one train step of 8 sequences (2048
     tokens; whisper 448) in the config's microbatches, traced for NCCL,
     its loss within 1e-2 of the same step on one card without a mesh
     (rank 0, after the world's work); a ``no_grad`` forward of 2 of them
     with top-1 equal to the one-card forward's on at least 0.99 of the
     decisive positions, and for deepseek and llama-vision the same on
     the flash route (kernel 15 on local heads) against the one-card
     flash route.  Printed per rank: step ms, peak memory, the NCCL
     collectives a step beside the dry-run's for the same cut ((a)
     traces each family's cut too).  A rank that fails (NCCL, the
     kernels' build, a check) or does not end within 600 s fails the
     phase (a collective waits 120 s at most).  Each rank counts its own
     launches of kernels 3 and 15 over its sharded steps and forwards;
     the phase's counts are their sums.
Every launch count is set to 0 just before each of phases 4, 5, 7, 8, 10,
12, 15, 17, 18, 19 and 21 (in each of its ranks), phase 14's P1 drain and
phase 16's pipelined drain, and read just after; a kernel's ``launches``
is the sum over the thirteen.
The card's name and power limit, then the kernel table as JSON, come on
the lines before the last; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_VERTICES = 4_847_571          # SNAP soc-LiveJournal1
AVG_DEGREE = 14.23              # 68,993,773 edges / 4,847,571 vertices
PAGE_SIZE = 2048
LABELS = [f"L{i}" for i in range(8)]
BATCHES = (8, 16, 1024, 16384)
CACHE_PAGES = 4096
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT32_OPS_PER_S = 67e12         # H100 SXM 32-bit non-tensor peak
REPS = 3
SEED_COUNTS = (1, 8, 64)
#: kernels launched by the retrieval slice (phase 4) and by the traversal
#: path (phase 5: the plan build decodes through gather_decode, and each
#: filter's predicate plane comes from cond_bitmap)
RETRIEVAL_KERNELS = ("gather_decode", "fused_gather_decode_bitmap_batch",
                     "cond_bitmap", "fused_gather_decode_filter_bitmap_batch")
TRAVERSAL_KERNELS = ("gather_decode", "cond_bitmap", "khop_scan", "two_hop",
                     "count_hop")
#: kernels of the per-dispatch pack route (phase 7), and of the LDBC queries
#: under the resident route and then the per-dispatch one (phase 8)
PER_DISPATCH_KERNELS = ("delta_decode", "fused_decode_bitmap_batch",
                        "fused_decode_filter_bitmap_batch")
LDBC_KERNELS = {"resident": ("gather_decode", "cond_bitmap", "two_hop",
                             "count_hop"),
                "per-dispatch": ("cond_bitmap",) + PER_DISPATCH_KERNELS}
#: the CUDA kernels of ``count_hop`` as the profiler names them
COUNT_HOP_KERNELS = ("interval_words_kernel", "count_tiles_kernel")
#: kernels of the single-range, RLE-label and selection entries (phase 10)
ENTRY_KERNELS = ("bitmap", "fused_decode_bitmap", "rle_to_bitmap",
                 "bitmap_select")
#: ldbc_like(40): 400,000 persons and 3,200,000 messages, the order of
#: LDBC SNB SF1's posts and comments; BI-2 runs for 1 of its 8 tag classes
#: (TagClass3, the profiled one and row 7b's) and IC-8 for the person with
#: the most messages, unlabeled (the labeled hop is the fused query's): all
#: 8 classes and 2 persons before phase 20 needed the room, 4 classes and 2
#: persons before phase 21, 2 classes and 1 person labeled too before its
#: room was measured on a slow host (a query ~10-13 s, most of it acero's
#: three runs)
LDBC_SCALE = 40
#: acero's timed runs a query: its time is the yardstick beside the
#: card's, held equal each run (3 before phase 21's families needed the
#: room, ~16 s of the phase)
ACERO_REPS = 1
LDBC_BI2_CLASSES, LDBC_IC8_PERSONS = ("TagClass3",), 0
LDBC_IC8_LABELS = (None,)
#: where the kernel phase runs and which engine the slice drives
DEVICE = "cuda:0"
ENGINE = "cuda"
#: the LM slice (phases 12-13): smollm-360m at full width, SmolLM's context
LM_ARCH = "smollm-360m"
LM_BATCH, LM_SEQ = 4, 2048
LM_HEADS = 15                   # smollm-360m's query heads
PROMPT_LEN, CACHE_LEN, DECODE_STEPS = 512, 1024, 32
SLOT_PROMPTS = (128, 256, 384, 512)
#: two logits closer than this many bf16 steps are a tie for top-1
TIE_ULPS = 4
#: words of text behind each of the 4 requests: two cut to PROMPT_LEN
#: tokens, two padded
REQUEST_WORDS = (700, 600, 400, 300)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:89"
#: the serving slice (phase 14): smollm-360m behind a label-scoped
#: two-hop GraphRetriever over a document lake of 100,000 passages, with
#: the two tenants of examples/serve_batched.py
SERVE_DOCS, SERVE_MEAN_LEN, SERVE_PAGE = 100_000, 256, 2048
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW_TOKENS = 8, 1024, 32
SERVE_PROD, SERVE_BATCH = 8, 24
SERVE_PROMPT = (24, 256)
SERVE_SOLO = 4                  # requests re-run alone at batch 1
SERVE_GAP = 2                   # mean ticks between two arrivals
SERVE_PROFILE_TICKS = 20
#: kernels of a retrieval tick: each tick's decode_edge_ranges (and the
#: traversal plan's build) through gather_decode, the label predicate's
#: plane through cond_bitmap, one fused k_hop through khop_scan
SERVE_KERNELS = ("gather_decode", "cond_bitmap", "khop_scan")
SERVE_PARTS = ("admit_ms", "retrieval_ms", "dispatch_ms", "prefetch_ms",
               "decode_sample_ms", "tick_ms")
#: the mutable phase (15) over soc-LiveJournal1: 16 ingest batches of 4,096
#: rows, one row in 16 a copy of a base edge; the kernels it must launch
MUT_BATCHES, MUT_ROWS, MUT_REPEAT = 16, 4096, 16
MUTABLE_KERNELS = ("gather_decode", "fused_gather_decode_bitmap_batch",
                   "cond_bitmap", "fused_gather_decode_filter_bitmap_batch",
                   "khop_scan")
#: ingest while serving (phase 16): 8 batches of 512 links at ticks 4, 12,
#: ..., 60; the kernels its pipelined drain must launch
SERVE_INGESTS, SERVE_INGEST_LINKS = 8, 512
SERVE_MUTABLE_KERNELS = ("gather_decode", "cond_bitmap", "khop_scan")
#: the partition plane (phase 17): the soc-LiveJournal1 column in PARTS
#: partitions, its batches of 1024 and 16384, and the community-local graph
#: of benchmarks/bench_partition.py:_fixture(local=True) at 2^20 vertices
#: of degree 16; the kernels the phase must launch
PARTS = 8
PART_BATCHES = (1024, 16384)
LOCAL_VERTICES, LOCAL_DEGREE = 1 << 20, 16
#: the rest of the LM stack (phase 18): four models at full width, one at
#: a time (each float32 copy, deepseek's 61 GiB too, alone on the card);
#: the two whose forward runs kernel 15; whisper's
#: published text and frame lengths; the prefill and decode of (b); the
#: layer checks of (c); mamba2's serving cell (d); the reduced configs of
#: (e); every cross sub-layer's gate
FAMILY_ARCHS = ("deepseek-moe-16b", "llama-3.2-vision-11b", "mamba2-2.7b",
                "whisper-small")
FAMILY_FLASH = ("deepseek-moe-16b", "llama-3.2-vision-11b")
# --------------------------------------------------------------------------
# phase 21: sharded execution (a fake world's dry-run, a world of NCCL
# ranks, one a card)
# --------------------------------------------------------------------------

#: the mesh of the NCCL world by the number of cards
SHARDED_MESHES = {1: ((1, 1), ("data", "model")),
                  4: ((2, 2), ("data", "model"))}
#: smollm-360m's train steps (8 x 2048 from phase 14's lake, the config's
#: 4 microbatches) and stablelm-1.6b's flash forward
SHARDED_STEPS, SHARDED_FLASH_ARCH = 3, "stablelm-1.6b"
#: the one-card steps the sharded ones are held against: the first two
#: (the second's loss reads the first's update; all 3 before the families
#: needed the room)
SHARDED_ONE_CARD_STEPS = 2
SHARDED_FLASH_BATCH = 4
#: the other families on the rank world, at full width and cut in depth
#: (units of their repeating unit: deepseek-moe-16b its dense layer and 2
#: MoE units, mamba2-2.7b 4 of its 64 layers, llama-3.2-vision-11b 1 unit
#: of 5 layers with its cross layer, whisper-small whole), one train step
#: of 8 sequences in the config's own microbatches (2048 tokens; whisper
#: its 448 over 1,500 frames) and a forward of the first 2; the flash
#: route too where the config's forward takes kernel 15
SHARDED_FAMILIES = {"deepseek-moe-16b": 2, "mamba2-2.7b": 4,
                    "llama-3.2-vision-11b": 1, "whisper-small": 12}
SHARDED_FAMILY_FLASH = ("deepseek-moe-16b", "llama-3.2-vision-11b")
SHARDED_FAMILY_BATCH, SHARDED_FAMILY_FORWARD = 8, 2
#: every rank done within this many seconds, or the phase fails
SHARDED_JOIN_S = 600
SHARDED_KERNELS = ("cond_bitmap", "flash_attention")


def family_seq(cfg) -> int:
    return WHISPER_TEXT if cfg.encoder_layers else TRAIN_SEQ


def family_cut(arch):
    """(the config cut to phase 21's depth, its text length)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(n_units=SHARDED_FAMILIES[arch])
    return cfg, family_seq(cfg)


def family_inputs(torch, cfg, seq, dev):
    """The global batch of a family's step (the same on every rank: numpy
    tokens and labels, the context from a seeded generator on the card)
    [SHARDED_FAMILY_BATCH, seq], with whisper's 1,500 frames or
    llama-vision's 1,600 vision embeddings."""
    import numpy as np
    rng = np.random.default_rng(seq + cfg.d_model)
    b = SHARDED_FAMILY_BATCH
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, seq))
                               .astype(np.int32)).to(dev)
           for k in ("tokens", "labels")}
    gen = torch.Generator(device=dev).manual_seed(cfg.d_model)
    n = WHISPER_FRAMES if cfg.encoder_layers else cfg.num_vision_tokens
    if n:
        out["frames" if cfg.encoder_layers else "vision"] = torch.randn(
            (b, n, cfg.d_model), generator=gen, device=dev).bfloat16()
    return out


def forward_part(batch):
    """The forward's inputs: the first SHARDED_FAMILY_FORWARD rows, no
    labels."""
    return {k: v[:SHARDED_FAMILY_FORWARD] for k, v in batch.items()
            if k != "labels"}


def sharded_families(torch, mesh, dev, rank, out):
    """Phase 21 (b)'s other families on the mesh: each model placed by the
    rules, one train step (the first traced for NCCL), a ``no_grad``
    forward (its top-1 kept) and, for deepseek and llama-vision, the same
    forward on the flash route (kernel 15 on local heads)."""
    from repro_torch.launch.dryrun import TraceCounter
    from repro_torch.launch.roofline import parse_collectives
    from repro_torch.models import build_model
    from repro_torch.models.model import shard_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import make_train_step, unit_layout
    from repro_torch.distributed.sharding import place, shard_params
    res = {}
    for arch in SHARDED_FAMILIES:
        t0 = time.perf_counter()
        cfg, seq = family_cut(arch)
        batch = family_inputs(torch, cfg, seq, dev)
        model = shard_model(open_gates(build_model(cfg, dev).init(0)), mesh)
        opt = adamw(TRAIN_PEAK)
        step = make_train_step(model, opt, cfg.train_microbatches)
        params = {n: p.detach() for n, p in model.named_parameters()}
        state = opt.init(params, unit_layout(model))
        state = place(state, shard_params(state, mesh, cfg))
        r = {}
        with mesh:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with TraceCounter(meta_only=False) as tc:
                params, state, met = step(params, state, batch)
            torch.cuda.synchronize()
            r["step_ms"] = (time.perf_counter() - t1) * 1e3
            r["loss"] = float(met["loss"])
            coll = parse_collectives(tc.records)
            r["nccl_bytes"], r["nccl_count"] = coll.total_bytes, coll.count
            r["nccl_by_op"] = coll.by_op
            if cfg.moe:
                r["bank_gathers"] = bank_gathers_over_model(
                    tc.records, model, mesh)
                require(not r["bank_gathers"],
                        f"21. rank {rank}: {arch} all-gathered an expert "
                        f"bank across model: {r['bank_gathers']}")
            del params, state, step
            fwd = forward_part(batch)
            t1 = time.perf_counter()
            r["top"] = model(fwd)[0].full_tensor().argmax(-1).cpu()
            torch.cuda.synchronize()
            r["forward_ms"] = (time.perf_counter() - t1) * 1e3
            if arch in SHARDED_FAMILY_FLASH:
                model.cfg = cfg.with_(use_flash=True)
                t1 = time.perf_counter()
                r["flash_top"] = model(fwd)[0].full_tensor().argmax(-1).cpu()
                torch.cuda.synchronize()
                r["flash_ms"] = (time.perf_counter() - t1) * 1e3
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        del model, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r["s"] = time.perf_counter() - t0
        res[arch] = r
    return res


def bank_gathers_over_model(records, model, mesh):
    """The all-gathers among a ``model`` group (ranks of one data
    coordinate; ``model`` is the mesh's last axis) whose result is an
    expert bank's local part gathered over ``model``, in bf16 or float32:
    the expert dim must stay split."""
    m = mesh.shape["model"]
    n_dp = mesh.size // m
    banks = {w.numel() // n_dp * k for blk in model.blocks()
             if hasattr(blk, "moe")
             for w in (blk.moe.w_gate, blk.moe.w_up, blk.moe.w_down)
             for k in (2, 4)}
    return [(op, n) for op, n, ranks in records
            if op == "all-gather" and ranks and len(ranks) == m > 1
            and len({r // m for r in ranks}) == 1 and n in banks]


def one_card_families(torch, dev, sharded):
    """Rank 0 after the world's work: each family's step and forwards on
    one card without a mesh, the same weights and batches; the sharded
    loss within 1e-2, the sharded forwards' top-1 equal to the one-card
    forward's on at least 0.99 of its decisive positions (phase 12's
    rule; the flash route against the one-card flash route)."""
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import make_train_step, unit_layout
    for arch, r in sharded.items():
        t0 = time.perf_counter()
        cfg, seq = family_cut(arch)
        batch = family_inputs(torch, cfg, seq, dev)
        model = open_gates(build_model(cfg, dev).init(0))
        opt = adamw(TRAIN_PEAK)
        step = make_train_step(model, opt, cfg.train_microbatches)
        params = {n: p.detach() for n, p in model.named_parameters()}
        _, _, met = step(params, opt.init(params, unit_layout(model)), batch)
        r["one_card_loss"] = float(met["loss"])
        del params, step
        require(abs(r["loss"] - r["one_card_loss"]) <= 1e-2,
                f"21. {arch}: the sharded step's loss {r['loss']} is not "
                f"within 1e-2 of the one-card step's {r['one_card_loss']}")
        fwd = forward_part(batch)
        for route, key in ((False, "top"), (True, "flash_top")):
            if key not in r:
                continue
            model.cfg = cfg.with_(use_flash=route)
            ref = model(fwd)[0].float()
            mask, _ = decisive(torch, ref)
            share = agreement(torch, r[key].to(dev), ref.argmax(-1), mask)
            r[f"{key}_share"] = share
            r[f"{key}_decisive"] = int(mask.sum())
            require(share[1] >= 0.99,
                    f"21. {arch}: the sharded {'flash ' if route else ''}"
                    f"forward's top-1 agrees with one card's on "
                    f"{share[1]:.4f} < 0.99 of the decisive positions")
            del ref
        del model, batch
        torch.cuda.empty_cache()
        r["one_card_s"] = time.perf_counter() - t0
        r.pop("top")
        r.pop("flash_top", None)


def sharded_dir(name: str = "") -> Path:
    import shutil
    d = ROOT / "build" / "chip_smoke_sharded" / name
    if name:
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    return d


def trace_cell_main(argv) -> int:
    """``--trace-cell ARCH SHAPE MULTI OUT VIRTUAL [BATCH SEQ MESH
    [UNITS]]``: one dry-run cell of the test meshes in its own process
    (phase 21 (a) runs them side by side): the fake world's row, and with
    VIRTUAL ``1`` the virtual mesh's too, as JSON to OUT.  With BATCH, SEQ
    and MESH (``1x1`` or ``2x2``) a train cell of that cut on that mesh;
    with UNITS too, of ``family_cut``'s depth and context (whisper's 1,500
    frames beside its text)."""
    import repro_torch.launch.dryrun as DR
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (distributed_mesh, fake_world,
                                         make_test_mesh, virtual_mesh)
    from repro_torch.launch.shapes import ShapeDef
    import os
    import torch
    torch.set_num_threads(1)
    os.nice(10)              # behind the ranks' untimed set-up
    arch, shape, multi, out = argv[0], argv[1], argv[2] == "1", argv[3]
    virtual = argv[4] == "1"
    t0 = time.perf_counter()
    rows = {}
    if len(argv) > 5:
        b, s, mesh_id = int(argv[5]), int(argv[6]), argv[7]
        dims = tuple(int(x) for x in mesh_id.split("x"))
        cfg, cut = get_config(arch), ShapeDef(shape, "train", s, b)
        # (b)'s steps accumulate their gradients in float32 (the train
        # step's default; the dry-run's cells in the parameters' type), so
        # their gradient reductions move float32
        step = DR.make_train_step
        DR.make_train_step = lambda model, opt, n_micro=1, **_: step(
            model, opt, n_micro)
        if len(argv) > 8:
            cfg = family_cut(arch)[0]
            if cfg.encoder_layers:        # (b)'s frames, not SEQ of them
                import repro_torch.launch.shapes as SH
                specs = SH.batch_specs

                def with_frames(cfg, shape, with_labels):
                    out = specs(cfg, shape, with_labels)
                    if "frames" in out:
                        out["frames"] = SH._sds(
                            (shape.batch, WHISPER_FRAMES, cfg.d_model),
                            out["frames"].dtype)
                    return out
                DR.batch_specs = with_frames
        axes = ("data", "model")
        if virtual:
            rows["virtual"] = DR.roofline_row(arch, cfg, cut, virtual_mesh(
                dims, axes, "cpu"), mesh_id)
        # (b)'s cut, planned as the cards of this host plan it
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        with fake_world(dims[0] * dims[1], kind):
            rows["fake"] = DR.roofline_row(arch, cfg, cut, distributed_mesh(
                dims, axes), mesh_id)
    else:
        rows["fake"] = DR.run_cell(arch, shape, multi,
                                   mesh_factory=make_test_mesh, fake=True)
        if virtual:
            rows["virtual"] = DR.run_cell(arch, shape, multi,
                                          mesh_factory=make_test_mesh)
    rows["seconds"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(rows, default=str))
    return 0


def sharded_rank_main(argv) -> int:
    """``--sharded-rank RANK WORLD PORT DIR``: one rank of phase 21 (b)
    (see the module docstring); writes ``DIR/rank{RANK}.json``."""
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch.core as TC
    from repro_torch.checkpoint.reshard import elastic_restore
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (GraphCorpusPipeline,
                                           PipelineConfig, global_batch)
    from repro_torch.distributed.sharding import (rank_slices,
                                                  shard_params,
                                                  tree_leaves_with_path)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as AK
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.launch.dryrun import TraceCounter
    from repro_torch.launch.mesh import distributed_mesh, init_world
    from repro_torch.launch.roofline import parse_collectives
    from repro_torch.models import build_model
    from repro_torch.models.model import shard_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import (make_train_step, model_params,
                                              unit_layout)
    rank, world, port, d = int(argv[0]), int(argv[1]), int(argv[2]), \
        Path(argv[3])
    require(torch.cuda.is_available(), "21. a rank without a card")
    torch.set_grad_enabled(False)
    out = {"rank": rank}
    dev = init_world(rank, world, f"tcp://localhost:{port}",
                     backend="nccl", timeout_s=120)
    require(dev.type == "cuda", f"21. rank {rank} is on {dev}")
    _build.library()                 # the parent's build, or fails here
    shape, axes = SHARDED_MESHES[world]
    mesh = distributed_mesh(shape, axes)
    out["coordinate"] = mesh.coordinate()
    wrappers = {"cond_bitmap": LK.cond_bitmap,
                "flash_attention": AK.flash_attention}
    for w in wrappers.values():
        w.launches = 0

    # smollm-360m: each data rank's shard of the lake, 3 sharded steps
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    with open(d / "lake.pkl", "rb") as f:
        lake = pickle.load(f)
    cond = (TC.L("HighQuality") | TC.L("News")) & ~TC.L("Spam")
    pcfg = PipelineConfig(seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH
                          // (world // shape[-1]))
    pipe = GraphCorpusPipeline(serve_graph(lake), cond, pcfg, engine=ENGINE,
                               mesh=mesh)
    out["eligible"] = int(pipe.eligible.size)
    out["shard"] = [pipe.cfg.shard_id, pipe.cfg.num_shards]
    model = build_model(cfg, dev).init(0)
    one = {n: p.detach().clone() for n, p in model.named_parameters()}
    shard_model(model, mesh)
    out["setup_s"] = time.perf_counter() - t0
    opt = adamw(warmup_cosine(TRAIN_PEAK, TRAIN_WARMUP, SHARDED_STEPS))
    step = make_train_step(model, opt, cfg.train_microbatches)
    params = model_params(model)
    state = opt.init(params, unit_layout(model))
    from repro_torch.distributed.sharding import place
    state = place(state, shard_params(state, mesh, cfg))
    stream = pipe.batches()
    batches, losses, ms = [], [], []
    # nothing timed beside (a)'s tracers: the parent marks their end
    t0 = time.perf_counter()
    while not (d / "traced").exists():
        require(time.perf_counter() - t0 < SHARDED_JOIN_S,
                f"21. rank {rank}: (a)'s tracers never ended")
        time.sleep(0.1)
    out["wait_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mesh:
        for i in range(SHARDED_STEPS):
            b = global_batch({k: v for k, v in next(stream).items()
                              if k in ("tokens", "labels")}, mesh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i:
                params, state, met = step(params, state, b)
            else:               # the cold step's collectives, traced
                with TraceCounter(meta_only=False) as tc:
                    params, state, met = step(params, state, b)
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t1) * 1e3)
            batches.append({k: v.full_tensor() for k, v in b.items()})
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        # the forward of the initial weights (the model's own; the steps
        # trained copies), every rank taking part in its collectives
        got = model({"tokens": batches[0]["tokens"]})[0].full_tensor()
        coll = parse_collectives(tc.records)
        out["nccl_bytes"], out["nccl_count"] = coll.total_bytes, coll.count
        out["nccl_by_op"] = coll.by_op
    out["losses"], out["step_ms"] = losses, ms
    out["steps_s"] = time.perf_counter() - t0
    require(all(math.isfinite(x) for x in losses),
            f"21. rank {rank}: a loss is not finite: {losses}")

    # stablelm-1.6b's flash forward: kernel 15 on this rank's local heads
    t0 = time.perf_counter()
    scfg = get_config(SHARDED_FLASH_ARCH).with_(use_flash=True)
    smodel = shard_model(build_model(scfg, dev).init(0), mesh)
    gen = np.random.default_rng(21)
    toks = torch.from_numpy(gen.integers(
        0, scfg.vocab_size, (SHARDED_FLASH_BATCH, TRAIN_SEQ)).astype(
            np.int32)).to(dev)
    with mesh:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        slog = smodel({"tokens": toks})[0].full_tensor()
        torch.cuda.synchronize()
        out["flash_ms"] = (time.perf_counter() - t1) * 1e3
        # smollm-360m's flash forward: its 15 heads on model 2 take the
        # sequence-parallel route, each rank's query rows from q_start
        model.cfg = cfg.with_(use_flash=True)
        t1 = time.perf_counter()
        seq_top = model({"tokens": batches[0]["tokens"][:SHARDED_FLASH_BATCH]}
                        )[0].full_tensor().argmax(-1)
        torch.cuda.synchronize()
        out["seq_flash_ms"] = (time.perf_counter() - t1) * 1e3
        model.cfg = cfg
    out["launches"] = {n: w.launches for n, w in wrappers.items()}

    # (checks, uncounted) the one-card forward of the same weights
    plain = build_model(scfg, dev)
    plain.load_state_dict({n: p.full_tensor() for n, p in
                           smodel.named_parameters()})
    del smodel
    ref = plain({"tokens": toks})[0].float()
    mask, _ = decisive(torch, ref)
    same = slog.argmax(-1) == ref.argmax(-1)
    out["flash"] = {"err": (slog.float() - ref).abs().max().item(),
                    "max": ref.abs().max().item(),
                    "n_decisive": int(mask.sum()),
                    "all_decisive": bool(same[mask].all())}
    require(out["flash"]["all_decisive"],
            f"21. rank {rank}: stablelm's sharded flash forward picks "
            f"another top-1 on a decisive position: {out['flash']}")
    del plain, ref, slog
    torch.cuda.empty_cache()
    out["flash_s"] = time.perf_counter() - t0

    # phase 20's bf16 checkpoint onto the mesh: this rank's slices only
    like = {n: t.to("meta") for n, t in one.items()}
    t1 = time.perf_counter()
    placed, _ = elastic_restore(str(d / "ckpt"), 1, like, mesh, cfg)
    torch.cuda.synchronize()
    out["restore_ms"] = (time.perf_counter() - t1) * 1e3
    shardings = dict(tree_leaves_with_path(shard_params(like, mesh, cfg)))
    n_ok = 0
    for (path,), leaf in tree_leaves_with_path(placed):
        part = leaf.to_local()
        want = one[path][rank_slices(shardings[(path,)], leaf.shape)]
        require(part.device == dev and torch.equal(part, want),
                f"21. rank {rank}: {path} restored is not its slice")
        n_ok += 1
    out["restored_leaves"] = n_ok
    out["restored_bytes"] = sum(leaf.to_local().numel()
                                * leaf.to_local().element_size()
                                for leaf in placed.values())
    del placed

    # the MoE, SSM, VLM and encoder-decoder families on the mesh, smollm's
    # trained state freed first (its checks read the initial weights)
    del params, state, model
    torch.cuda.empty_cache()
    before = {n: w.launches for n, w in wrappers.items()}
    out["families"] = sharded_families(torch, mesh, dev, rank, out)
    for n, w in wrappers.items():    # the checks between are not counted
        out["launches"][n] += w.launches - before[n]

    # the one-card steps on the same weights and batches (rank 0)
    t0 = time.perf_counter()
    if rank == 0:
        ref_model = build_model(cfg, dev)
        ref_model.load_state_dict(one)
        ref_step = make_train_step(ref_model, opt,
                                   cfg.train_microbatches)
        p1 = {n: t.clone() for n, t in one.items()}
        s1 = opt.init(p1, unit_layout(ref_model))
        ref_losses = []
        first = ref_model({"tokens": batches[0]["tokens"]})[0].float()
        for b in batches[:SHARDED_ONE_CARD_STEPS]:
            p1, s1, met = ref_step(p1, s1, b)
            ref_losses.append(float(met["loss"]))
        mask, _ = decisive(torch, first)
        same = got.argmax(-1) == first.argmax(-1)
        seq_mask = mask[:SHARDED_FLASH_BATCH]
        out["one_card"] = {"losses": ref_losses,
                           "n_decisive": int(mask.sum()),
                           "all_decisive": bool(same[mask].all()),
                           "err": (got.float() - first).abs().max().item(),
                           "seq_flash": agreement(
                               torch, seq_top,
                               first[:SHARDED_FLASH_BATCH].argmax(-1),
                               seq_mask)}
        require(all(abs(a - b) <= 1e-2 for a, b in zip(losses, ref_losses)),
                f"21. the sharded losses {losses} are not within 1e-2 of "
                f"the one-card steps' {ref_losses}")
        require(out["one_card"]["all_decisive"],
                f"21. the sharded forward picks another top-1 than the "
                f"one-card forward on a decisive position: {out['one_card']}")
        require(out["one_card"]["seq_flash"][1] >= 0.99,
                f"21. smollm's sharded flash forward agrees with the "
                f"one-card forward on {out['one_card']['seq_flash']} of the "
                f"decisive positions")
        del ref_model, p1, s1, first
    del batches, got
    torch.cuda.empty_cache()
    if rank == 0:
        one_card_families(torch, dev, out["families"])
    for r in out["families"].values():         # tensors: not for the log
        r.pop("top", None)
        r.pop("flash_top", None)
    out["one_card_s"] = time.perf_counter() - t0
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_traces(d, shape, env):
    """Phase 21 (a)'s tracers, one process a cell, started together: the
    four cells (their virtual rows too), (b)'s cut on (b)'s mesh, and
    ``launch.train --lower-only``."""
    traces = []
    cut = (LM_ARCH, f"train_{TRAIN_SEQ}", False, "0",
           str(TRAIN_BATCH), str(TRAIN_SEQ), "x".join(map(str, shape)))
    mesh_id = "x".join(map(str, shape))
    # the families' cuts where their steps issue collectives (a mesh of
    # one rank issues none, as smollm's cut shows)
    families = [(arch, f"train_{family_cut(arch)[1]}", False, "0",
                 str(SHARDED_FAMILY_BATCH), str(family_cut(arch)[1]),
                 mesh_id, str(units))
                for arch, units in SHARDED_FAMILIES.items()
                if math.prod(shape) > 1]
    cells = [(a, sh, m, "1") for a, sh, m in LAUNCH_CELLS] + [cut] + families
    for i, (arch, sh, multi, *extra) in enumerate(cells):
        f = d / f"cell{i}.json"
        traces.append((arch, sh, multi, f, subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--trace-cell",
             arch, sh, "1" if multi else "0", str(f)] + extra,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    # smollm-360m train_4k on 16x16: the CLI's own row, from a fake world
    # of 256 (phase 20 (a) runs it under --launch)
    lower = d / "lower_only"
    lower.mkdir()
    traces.append((LM_ARCH, "train_4k@16x16", False,
                   lower / "dryrun_report.json", subprocess.Popen(
                       [sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", LM_ARCH, "--lower-only"], cwd=lower,
                       env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)))
    return traces, cut[1]


def sharded_phase(torch, card, lake=None):
    """Phase 21: sharded execution (see the module docstring); returns
    the kernels' launches summed over the ranks."""
    import os
    import pickle
    import socket
    from repro_torch.checkpoint.checkpointer import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import document_graph
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    require(n in SHARDED_MESHES, f"21. no mesh for {n} cards")
    shape, axes = SHARDED_MESHES[n]
    d = sharded_dir("run")
    cfg = get_config(LM_ARCH)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # (a) traces during (b)'s set-up; the ranks wait for it before any
    # timed step
    traces, cut_shape = sharded_traces(d, shape, env)
    ranks = []
    try:
        deadline = time.perf_counter() + SHARDED_JOIN_S
        # (b)'s inputs: phase 14's lake and phase 20's bf16 checkpoint
        if lake is None:
            lake = document_graph(num_docs=SERVE_DOCS, vocab=cfg.vocab_size,
                                  mean_len=SERVE_MEAN_LEN, seed=2)
        with open(d / "lake.pkl", "wb") as f:
            pickle.dump(lake, f, protocol=pickle.HIGHEST_PROTOCOL)
        model = build_model(cfg).init(0)
        host = {k: p.detach().cpu() for k, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
        save_checkpoint(str(d / "ckpt"), 1, host)
        del host
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        for r in range(n):
            log_f = open(d / f"rank{r}.log", "w")
            ranks.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--sharded-rank", str(r), str(n), str(port), str(d)],
                env=dict(env, LOCAL_RANK=str(r)), stdout=log_f,
                stderr=subprocess.STDOUT), log_f))
        for *_, p in traces:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
        a_s = time.perf_counter() - t0
        (d / "traced").touch()
        for p, _ in ranks:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
        b_s = time.perf_counter() - t0
    finally:
        for p, f in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
        for *_, p in traces:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, _) in enumerate(ranks):
        require(p.returncode == 0, f"21. rank {r} exited {p.returncode}: "
                + (d / f"rank{r}.log").read_text()[-3000:])
    res = [json.loads((d / f"rank{r}.json").read_text()) for r in range(n)]
    launches = {k: sum(r["launches"][k] for r in res)
                for k in SHARDED_KERNELS}
    require(all(launches.values()), f"21. a kernel of the sharded path "
            f"never launched: {launches}")
    one = res[0]["one_card"]
    log(f"21. (b) a world of {n} NCCL rank(s) on {describe_mesh(shape, axes)}"
        f": {LM_ARCH} at full width, {SHARDED_STEPS} steps of {TRAIN_BATCH} "
        f"x {TRAIN_SEQ} from phase 14's lake (each data rank's shard through "
        f"GraphCorpusPipeline(engine=\"cuda\")), losses "
        + " ".join(f"{x:.4f}" for x in res[0]["losses"])
        + " beside the one-card steps' " + " ".join(
            f"{x:.4f}" for x in one["losses"])
        + f" (within 1e-2); forward top-1 equal on all {one['n_decisive']:,} "
        f"decisive positions (max |d| {one['err']:.4f}); launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" ({b_s:.1f} s with the set-up; (a)'s tracers done {a_s:.1f} s "
        f"in, before the ranks' first timed step) on {card}")
    for r in res:
        fl = r["flash"]
        warm = statistics.median(r["step_ms"][1:])
        log(f"21. (b) rank {r['rank']} {r['coordinate']} on cuda:"
            f"{r['rank'] % n}: shard {r['shard'][0]} of {r['shard'][1]} "
            f"({r['eligible']:,} eligible docs); step ms "
            + " ".join(f"{x:.1f}" for x in r["step_ms"])
            + f" (the first traced; warm median {warm:.1f} ms of the "
            f"{SHARDED_STEPS - 1} untraced, "
            f"{TRAIN_BATCH * TRAIN_SEQ / warm * 1e3 / n:,.0f}"
            f" tokens/s a card); peak max_memory_allocated "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; NCCL collectives a step "
            f"(traced) {r['nccl_count']} moving {r['nccl_bytes']:,} B "
            f"{r['nccl_by_op']}; {SHARDED_FLASH_ARCH} flash forward "
            f"{SHARDED_FLASH_BATCH} x {TRAIN_SEQ} {r['flash_ms']:.1f} ms "
            f"on the local heads, top-1 equal on all {fl['n_decisive']:,} "
            f"decisive positions of the one-card forward (max |d| "
            f"{fl['err']:.4f} of {fl['max']:.2f}); {LM_ARCH} flash forward "
            f"{SHARDED_FLASH_BATCH} x {TRAIN_SEQ} {r['seq_flash_ms']:.1f} ms "
            f"({LM_HEADS} heads: sequence-parallel where model > 1); kernel "
            f"15 {r['launches']['flash_attention']} launches in all; "
            f"elastic_restore of phase 20's bf16 "
            f"checkpoint: {r['restored_leaves']} leaves, "
            f"{r['restored_bytes'] / 2**20:.1f} MiB of this rank's slices "
            f"in {r['restore_ms']:.1f} ms; seconds: set-up "
            f"{r['setup_s']:.1f}, waiting for (a) {r['wait_s']:.1f}, steps "
            f"{r['steps_s']:.1f}, flash forward and its check "
            f"{r['flash_s']:.1f}, one-card steps "
            f"{r['one_card_s']:.1f}; on {card}")
    sq = one["seq_flash"]
    log(f"21. (b) {LM_ARCH}'s flash forward on the mesh: top-1 equal to the "
        f"one-card forward on {sq[1]:.4f} of the decisive positions "
        f"({sq[0]:.4f} of all)")
    for arch, f0 in res[0]["families"].items():
        cfg, seq = family_cut(arch)
        log(f"21. (b) {arch} ({cfg.num_layers} + {cfg.encoder_layers} "
            f"encoder layers at full width) on {describe_mesh(shape, axes)}:"
            f" one train step of {SHARDED_FAMILY_BATCH} x {seq} in "
            f"{cfg.train_microbatches} microbatches, loss {f0['loss']:.4f} "
            f"beside one card's {f0['one_card_loss']:.4f} (within 1e-2); "
            f"forward of {SHARDED_FAMILY_FORWARD} x {seq}: top-1 equal to one "
            f"card's on {f0['top_share'][1]:.4f} of {f0['top_decisive']:,} "
            f"decisive positions"
            + (f", flash route (kernel 15) {f0['flash_top_share'][1]:.4f} of "
               f"{f0['flash_top_decisive']:,}" if "flash_top_share" in f0
               else "")
            + "; per rank: step ms " + " ".join(
                f"{r['families'][arch]['step_ms']:.1f}" for r in res)
            + ", forward ms " + " ".join(
                f"{r['families'][arch]['forward_ms']:.1f}" for r in res)
            + ", NCCL a step " + " ".join(
                f"{r['families'][arch]['nccl_count']}/"
                f"{r['families'][arch]['nccl_bytes']:,} B" for r in res)
            + f" {f0['nccl_by_op']}"
            + (f", expert banks all-gathered across model: "
               f"{len(f0['bank_gathers'])}" if "bank_gathers" in f0 else "")
            + ", peak "
            + " ".join(f"{r['families'][arch]['peak_bytes'] / 2**30:.2f}"
                       for r in res)
            + f" GiB; {f0['s']:.1f} s on the mesh, {f0['one_card_s']:.1f} s "
            f"one card")
    # (a) the fake world's rows beside the virtual ones; every cell is
    # reported before a failed one fails the phase
    failed = []
    for arch, sh, multi, f, p in traces:
        if p.returncode != 0:
            failed.append(f"tracing {arch} {sh} exited {p.returncode}: "
                          + p.stdout.read()[-1500:])
            log(f"21. (a) {arch} {sh}: FAILED, {failed[-1]}")
            continue
        rows = json.loads(f.read_text())
        if isinstance(rows, list):             # the CLI's report
            rows = {"fake": rows[0], "seconds": rows[0]["compile_s"]}
        fake = rows["fake"]
        if fake["status"] != "ok" or (
                sh.startswith("train") and fake["chips"] > 1
                and not (fake["coll_count"] > 0
                         and fake["t_collective_s"] > 0)):
            failed.append(f"{arch} {sh}: {fake}")
            log(f"21. (a) {arch} {sh}: FAILED, {failed[-1][:1500]}")
            continue
        side = rows.get("virtual")
        if side and not (side["status"] == "ok" and side["t_compute_s"] > 0
                         and side["t_memory_s"] > 0
                         and side["coll_count"] == 0):
            failed.append(f"{arch} {sh} on the virtual mesh: {side}")
            log(f"21. (a) {arch} {sh}: FAILED, {failed[-1][:1500]}")
            continue
        log(f"21. (a) {arch} {sh} {'2x2x2' if multi else fake['mesh']} on "
            f"a fake world of {fake['chips']}: coll_count "
            f"{fake['coll_count']}, bytes by op {fake['coll_by_op']}, "
            f"t_collective {fake['t_collective_s'] * 1e3:.3f} ms, t_memory "
            f"{fake['t_memory_s'] * 1e3:.3f} ms, t_compute "
            f"{fake['t_compute_s'] * 1e3:.3f} ms"
            + (f"; virtual row t_memory {side['t_memory_s'] * 1e3:.3f} ms, "
               f"t_compute {side['t_compute_s'] * 1e3:.3f} ms, "
               f"t_collective {side['t_collective_s'] * 1e3:.3f} ms"
               if side else "")
            + f" (traced in {rows['seconds']:.1f} s)")
        # (b)'s own cuts: smollm's and each family's (no virtual row)
        nccl = None if "virtual" in rows else res[0] \
            if (arch, sh) == (LM_ARCH, cut_shape) \
            else res[0]["families"].get(arch)
        if nccl is not None:
            dry = fake['coll_ici_bytes'] + fake['coll_dcn_bytes']
            log(f"21. (a) the same cut as (b), {arch}: the dry-run's "
                f"collectives a step {fake['coll_count']} moving {dry:,} B "
                f"beside NCCL's traced {nccl['nccl_count']} moving "
                f"{nccl['nccl_bytes']:,} B on rank 0"
                + (f" ({nccl['nccl_bytes'] / dry:.4f}x)" if dry else ""))
    require(not failed, "21. (a) " + " | ".join(failed))
    import shutil
    shutil.rmtree(d, ignore_errors=True)
    return launches


def describe_mesh(shape, axes) -> str:
    return " x ".join(f"{a}={n}" for a, n in zip(axes, shape))


WHISPER_TEXT, WHISPER_FRAMES = 448, 1500
#: 16 decode steps a model (32 before phase 20 needed the room)
FAMILY_PROMPT, FAMILY_STEPS, FAMILY_TIMED_STEPS = 512, 16, 8
SSD_BATCH, SSD_LEN = 2, 1024
FAMILY_SERVE_DOCS, FAMILY_SERVE_SLOTS, FAMILY_SERVE_LEN = 10_000, 4, 512
FAMILY_SERVE_REQUESTS, FAMILY_SERVE_NEW, FAMILY_SERVE_SOLO = 8, 16, 4
FAMILY_REDUCED = ("jamba-1.5-large-398b", "qwen3-moe-30b-a3b")
#: the depth at which mamba2 runs: bf16 against float32 top-1 on decisive
#: positions fell 0.9992, 0.988, 0.929, 0.771 over its first 8, 16, 32 and
#: all 64 random-init layers (H100 80GB HBM3, 700 W), and its pass over all
#: 64 (reported, not held) took ~25 s of the full run's 1200 s limit;
#: deepseek-moe-16b runs its dense layer and 7 of its 27 MoE units,
#: llama-3.2-vision-11b 2 of its 8 units of 5 layers (one cross layer
#: each), at full width: the depth cut that made room for phase 20
FAMILY_UNITS = {"mamba2-2.7b": 8, "deepseek-moe-16b": 7,
                "llama-3.2-vision-11b": 2}
X_GATE = 0.5
#: training (phase 19): smollm-360m at full width from phase 14's lake,
#: 16,384 tokens a step (8 sequences of 2048, in the config's 4
#: microbatches), AdamW under warmup-cosine, 6 steps (20 before phase 20
#: needed the room: the warm median runs over steps 3-6, the loss held
#: over the first and last 3); (c) and (d) on a float32 copy
#: at seq 512; (e) the trainer's 6 steps (one a train step's batch) with
#: a checkpoint every 3 and a crash at 5, on the model's first layers (8,
#: 4 and 6 before phase 20 needed the room); the kernel the phase must
#: launch (the label filter's)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2048, 8, 6
TRAIN_PEAK, TRAIN_WARMUP, TRAIN_WINDOW = 3e-4, 5, 3
TRAIN_CHECK_SEQ = 512
TRAIN_FT_STEPS, TRAIN_FT_EVERY, TRAIN_FT_FAIL = 6, 3, 5
#: (e) holds the recovery, not the model: it runs the first 4 of the 32
#: layers at full width, which cut its two runs (and three checkpoints of
#: the trained state) from ~27-80 s to a few, for phase 8's acero
#: baseline's three runs in the 1200 s limit
TRAIN_FT_UNITS = 4
TRAIN_KERNELS = ("cond_bitmap",)
#: the launch layer (phase 20): the dry-run's four cells of the reference's
#: ``tests/test_dryrun_small.py`` on its test meshes; then smollm-360m's
#: three cells run on the card at the largest batch that holds, from these
#: candidates (a train step of one microbatch of rows of 4096; a prefill
#: cut to LAUNCH_PREFILL_SEQ, since [1, 15, 32768, 32768] float32 scores
#: are 64 GB; decode cut in slots, since 128 slots of a 32768 cache are
#: 172 GB in bf16), each traced on ``meta`` at the same cut
LAUNCH_CELLS = (("smollm-360m", "train_4k", False),
                ("mamba2-2.7b", "decode_32k", False),
                ("whisper-small", "prefill_32k", False),
                ("smollm-360m", "train_4k", True))
#: each list opens one above the largest that held on an otherwise empty
#: card, so that the phase shows the refusal too (it logs both)
LAUNCH_TRAIN_ROWS = (11, 10, 8, 4, 2, 1)
LAUNCH_PREFILL_SEQ, LAUNCH_PREFILL_ROWS = 16384, (2, 1)
LAUNCH_DECODE_SLOTS = (52, 48, 44, 32, 16)
LAUNCH_SERVE_REQUESTS, LAUNCH_SERVE_TOKENS = 8, 16
PARTITION_KERNELS = ("gather_decode", "fused_gather_decode_bitmap_batch",
                     "cond_bitmap", "fused_gather_decode_filter_bitmap_batch",
                     "khop_scan", "two_hop", "count_hop", "seed_words",
                     "expand_words", "merge_hop")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events around the run, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` with the host ahead of the card:
    the ``reps`` calls are queued behind a spin kernel of about 10 ms, so
    no launch waits on the host, and the events time the device alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_each(torch, fn, reps: int) -> list:
    """Device milliseconds of each of ``reps`` calls of ``fn`` (CUDA
    events around each call, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    marks[0].record()
    for m in marks[1:]:
        fn()
        m.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def kernel_row(name, source, replaces, err, ms, plain_ms, nbytes, nops=0,
               ops_per_s=INT32_OPS_PER_S):
    """One entry of the ``kernels`` line; its launches are filled in from
    the slice phases."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def max_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def build_graph():
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
    t0 = time.perf_counter()
    src, dst = powerlaw_graph(N_VERTICES, AVG_DEGREE, seed=0)
    adj = TC.build_adjacency(src, dst, N_VERTICES, N_VERTICES, TC.BY_SRC,
                             TC.ENC_GRAPHAR, page_size=PAGE_SIZE)
    labels = clustered_labels(N_VERTICES, LABELS, density=0.3,
                              run_scale=512, seed=0)
    vt = TC.VertexTable.build(TC.VertexTypeSchema("v", [], labels=LABELS),
                              {}, labels, num_vertices=N_VERTICES)
    col = adj.table["<dst>"].encoded
    TC.pack_column(col).unpack_plan()
    log(f"set-up: {N_VERTICES} vertices, {adj.num_edges} edges, "
        f"{len(col.pages)} pages of {PAGE_SIZE}, host build "
        f"{time.perf_counter() - t0:.1f} s")
    # the id sets of the raw edge arrays and the dense label planes: what
    # phase 10's whole-column bitmaps must equal
    truth = {"labels": labels,
             "src": np.bincount(src, minlength=N_VERTICES) > 0,
             "dst": np.bincount(dst, minlength=N_VERTICES) > 0}
    del src, dst
    rng = np.random.default_rng(1)
    batches = {b: rng.integers(0, N_VERTICES, b) for b in BATCHES}
    return adj, vt, batches, truth


def staged_for(adj, vs, filt=None):
    """What the resident fused route stages for batch ``vs`` with no
    cache, from its own staging step: the staged vector, p_pad, the
    number of real pages and the requested-row count."""
    from repro_torch.core.encoding import prune_page_list
    from repro_torch.kernels.pac_decode import ops
    col = adj.table["<dst>"].encoded
    los, his = adj.edge_ranges_batch(vs)
    pages, _ = ops.page_set_for_ranges(los, his, col.page_size)
    qual = filt.qual_range() if filt is not None else None
    pages, pmask = prune_page_list(col, pages, qual)
    staged, p_pad, total = ops.stage_resident(col, los, his, pages, pmask)
    return staged, p_pad, len(pages), total


def launch_floor_ms(torch, dev):
    """An empty kernel's device milliseconds: one launch bracketed by
    events (median of 20), and the mean of 100 queued back to back."""
    from repro_torch.kernels import _build

    def empty():
        _build.launch("rt_launch_floor", _build.stream(dev))

    empty()
    one = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        empty()
        end.record()
        torch.cuda.synchronize()
        one.append(start.elapsed_time(end))
    return statistics.median(one), queued_ms(torch, empty, 100)


def kernel_phase(torch, adj, vt, batches):
    import numpy as np
    from repro_torch.core.encoding import delta_encode_column, pack_column
    from repro_torch.core.labels import L, LabelFilter
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.label_filter import ref as LR
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.pac_decode import ops
    from repro_torch.kernels.pac_decode import ref as PR
    dev = torch.device(DEVICE)
    one, each = launch_floor_ms(torch, dev)
    log(f"kernels: launch floor: an empty kernel takes {one:.4f} ms from "
        f"launch to completion (median of 20), {each:.4f} ms each queued "
        f"back to back")
    col = adj.table["<dst>"].encoded
    plan = col.packed_cache.device_plan(dev)
    n_pages, d = plan[1].shape
    ps = d + 1
    bit_widths = col.packed_cache.bit_widths
    n_words = -(-adj.num_value_vertices // 32)
    rows = []

    def entry(*args, **kwargs):
        rows.append(kernel_row(*args, **kwargs))

    def plan_bytes(pages):
        """Bytes of the resident plan a decode of ``pages`` must read:
        ``first``, ``pos`` and ``mind`` whole, and of the packed words
        only the sum of each page's bit widths (a miniblock of width bw
        packs its 32 deltas into bw words; the zero words past them are
        never read)."""
        pages = np.asarray(pages, np.int64)
        return 4 * (len(pages) * (1 + 2 * d)
                    + int(bit_widths[pages].sum()))

    # -- gather_decode: the non-fused path's page list for batch 8, plus
    #    a 16384-vertex page list and out-of-range padding (clamped)
    los, his = adj.edge_ranges_batch(batches[BATCHES[0]])
    pages8, _ = ops.page_set_for_ranges(los, his, PAGE_SIZE)
    idx8 = torch.from_numpy(ops._page_index_vector(pages8, n_pages)).to(dev)
    staged_big, p_big, n_big, _ = staged_for(adj, batches[BATCHES[-1]])
    idx_big = torch.from_numpy(staged_big[:p_big].copy())
    idx_big[n_big:] = torch.tensor([-7, n_pages + 5] * p_big)[
        :p_big - n_big].to(torch.int32)
    idx_big = idx_big.to(dev)
    for idx in (idx8, idx_big):
        k, r = PK.gather_decode(*plan, idx), PR.gather_decode(*plan, idx)
        require(torch.equal(k, r), f"gather_decode differs at {len(idx)} "
                f"rows ({max_err(k, r)})")
    # row 2 at 8 rows (a launch's overhead), row 2@16384 at the retrieval
    # slice's p_pad-16384 call: each distinct page's plan row read once,
    # the ids written
    for idx, suffix, reps in ((idx8, "", 50), (idx_big, "@16384", 20)):
        err = max_err(PK.gather_decode(*plan, idx),
                      PR.gather_decode(*plan, idx))
        uniq = np.unique(np.clip(idx.cpu().numpy(), 0, n_pages - 1))
        entry("gather_decode" + suffix,
              "src/repro_torch/kernels/csrc/gather_decode.cu",
              "src/repro/kernels/pac_decode/kernel.py:453", err,
              cuda_ms(torch, lambda: PK.gather_decode(*plan, idx), reps),
              cuda_ms(torch, lambda: PR.gather_decode(*plan, idx),
                      reps // 5),
              plan_bytes(uniq) + 4 * len(idx) + 4 * len(idx) * ps)
        device = queued_ms(torch, lambda: PK.gather_decode(*plan, idx), reps)
        log(f"kernels: {rows[-1]['name']} at {len(idx)} rows "
            f"({len(uniq)} distinct pages): {rows[-1]['ms']:.4f} ms a call, "
            f"{device:.4f} ms of device queued; bound "
            f"{rows[-1]['bound_ms']:.4f} ms")
    # other page sizes: one pass of the block scan (256) and several (8192)
    rng = np.random.default_rng(2)
    for page_size in (256, 8192):
        vals = np.concatenate(
            [np.sort(rng.integers(0, 1 << 24, 5 * page_size)),
             rng.integers(-(1 << 30), 1 << 30, 77)])
        other = pack_column(delta_encode_column(vals, page_size))
        oplan = other.device_plan(dev)
        oidx = torch.arange(-1, other.n_pages + 1, dtype=torch.int32,
                            device=dev)
        k, r = PK.gather_decode(*oplan, oidx), PR.gather_decode(*oplan, oidx)
        require(torch.equal(k, r), f"gather_decode differs at page size "
                f"{page_size} ({max_err(k, r)})")
    log(f"kernels: gather_decode equal at {len(idx8)} and {len(idx_big)} "
        f"rows, and at page sizes 256 and 8192")

    # -- fused: batch 16384, unfiltered and filtered, want_ids both ways
    filt = LabelFilter(vt, (L("L0") & L("L1")) | ~L("L2"))
    fplan = filt.plan()
    pos_t, meta_t = fplan.device(dev)
    fw = LK.cond_bitmap(pos_t, meta_t, fplan.program.ops, n_words)
    fr = LR.cond_bitmap(pos_t, meta_t, fplan.program.ops, n_words)
    require(torch.equal(fw, fr), f"cond_bitmap differs ({max_err(fw, fr)})")
    # the least work: one flip per run boundary inside the words of each
    # leaf the program reads, and each op once per word
    n_ops = len(fplan.program.ops)
    flips = sum(int((fplan.pos[op[1]] < 32 * n_words).sum())
                for op in fplan.program.ops if op[0] == "leaf")
    entry("cond_bitmap", "src/repro_torch/kernels/csrc/cond_bitmap.cu",
          "src/repro/kernels/label_filter/kernel.py:88", max_err(fw, fr),
          cuda_ms(torch, lambda: LK.cond_bitmap(
              pos_t, meta_t, fplan.program.ops, n_words), 20),
          cuda_ms(torch, lambda: LR.cond_bitmap(
              pos_t, meta_t, fplan.program.ops, n_words), 3),
          fplan.pos.nbytes + fplan.meta.nbytes + 4 * n_ops + 4 * n_words,
          flips + n_words * n_ops)
    queued = queued_ms(torch, lambda: LK.cond_bitmap(
        pos_t, meta_t, fplan.program.ops, n_words), 100)
    log(f"kernels: cond_bitmap equal over {n_words} words ({n_ops} ops, "
        f"{flips} run boundaries); {rows[-1]['ms']:.4f} ms a call back to "
        f"back, {queued:.4f} ms of device queued behind the host")

    host_pos = col.packed_cache.unpack_plan()[1]

    def need_bytes(staged, p_pad, total):
        """What a call without want_ids must read of the plan: for each
        page a request lands in, ``first``, ``pos`` and ``mind`` of its
        deltas before its last requested position (``need - 1`` of them),
        and the distinct packed words that those deltas of a non-zero
        width name.  Returns the bytes and each row's ``need``."""
        f = np.clip(staged[p_pad:p_pad + total].astype(np.int64), 0,
                    p_pad * ps - 1)
        need = np.zeros(p_pad, np.int64)
        np.maximum.at(need, f // ps, f % ps + 1)
        pages = np.clip(staged[:p_pad], 0, n_pages - 1)
        per_page = np.zeros(n_pages, np.int64)
        np.maximum.at(per_page, pages, need)
        used = np.nonzero(per_page)[0]
        deltas = per_page[used] - 1
        pos = host_pos[used]
        named = (np.arange(d) < deltas[:, None]) & ((pos & 63) != 0)
        key = np.nonzero(named)[0] * (1 << 21) + (pos[named] >> 11)
        nbytes = 4 * (len(used) + 2 * int(deltas.sum())
                      + len(np.unique(key)))
        return nbytes, need

    for name, fwords in (("fused_gather_decode_bitmap_batch", None),
                         ("fused_gather_decode_filter_bitmap_batch", fw)):
        staged, p_pad, n_real, total = staged_for(
            adj, batches[BATCHES[-1]], filt if fwords is not None else None)
        st = torch.from_numpy(staged).to(dev)
        buf = torch.empty(n_words, dtype=torch.int32, device=dev)

        def kern(want_ids, st=st, p_pad=p_pad, buf=buf, fwords=fwords):
            if fwords is None:
                return PK.fused_gather_decode_bitmap_batch(
                    *plan, st, buf, p_pad=p_pad, want_ids=want_ids)
            return LK.fused_gather_decode_filter_bitmap_batch(
                *plan, st, fwords, buf, p_pad=p_pad, want_ids=want_ids)

        def plain(st=st, p_pad=p_pad, fwords=fwords):
            return PR.fused_gather_batch(*plan, st, n_words, p_pad, fwords)

        rw, rids = plain()
        kw, kids = kern(True)
        require(torch.equal(kw, rw) and torch.equal(kids, rids),
                f"{name} (want_ids) differs")
        ids_err = max(max_err(kw, rw), max_err(kids, rids))
        kw = kern(False)
        require(torch.equal(kw, rw), f"{name} differs")
        # rows past `total` must be ignored whatever they point at
        junk = st.clone()
        tail = junk[p_pad + total:-1]
        tail.copy_(torch.randint(0, p_pad * ps, tail.shape,
                                 dtype=torch.int32, device=dev))
        kj = kern(False, st=junk)
        require(torch.equal(kj, rw), f"{name} reads rows past total")
        ids_req = rids.reshape(-1)[st[p_pad:p_pad + total].long()]
        dups = total - int(torch.unique(ids_req).numel())
        require(dups > 0 and len(staged) - p_pad - 1 > total
                and p_pad > n_real,
                f"{name}: the case lacks duplicates or padding")
        # the bound counts what these inputs need (the rows' requested
        # prefixes); the whole-row bound of earlier runs is logged beside
        nbytes, need = need_bytes(staged, p_pad, total)
        tail_bytes = 4 * len(staged) + 4 * n_words
        if fwords is not None:
            live = ids_req[(ids_req >= 0) & (ids_req < 32 * n_words)]
            tail_bytes += 4 * int(torch.unique(live >> 5).numel())
        whole = plan_bytes(staged[:n_real]) + 4 * len(staged) \
            + 4 * n_words + (4 * n_words if fwords is not None else 0)
        call = cuda_ms(torch, lambda: kern(False), 20)
        device = queued_ms(torch, lambda: kern(False), 100)
        plain_ms = cuda_ms(torch, plain, 3)
        entry(name, "src/repro_torch/kernels/csrc/bitmap_scatter.cu",
              "src/repro/kernels/pac_decode/kernel.py:540"
              if fwords is None else
              "src/repro/kernels/label_filter/kernel.py:231",
              max_err(kw, rw), call, plain_ms, nbytes + tail_bytes)
        log(f"kernels: {name} equal (want_ids both ways) at p_pad={p_pad}, "
            f"{n_real} pages, {total} rows, {dups} duplicate ids, "
            f"{len(staged) - p_pad - 1 - total} padding rows; mean "
            f"need / page_size {need[:n_real].mean() / ps:.4f} over the "
            f"real rows; {call:.4f} ms a call back to back, {device:.4f} ms "
            f"of device queued behind the host; bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({nbytes + tail_bytes} B), "
            f"whole rows {whole / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"({whole} B)")
        if fwords is None:
            # the cold-LRU call: every row decoded whole and returned
            call = cuda_ms(torch, lambda: kern(True), 20)
            device = queued_ms(torch, lambda: kern(True), 100)
            entry(name + "@want_ids",
                  "src/repro_torch/kernels/csrc/bitmap_scatter.cu",
                  "src/repro/kernels/pac_decode/kernel.py:540", ids_err,
                  call, plain_ms,
                  plan_bytes(staged[:n_real]) + 4 * p_pad * ps + tail_bytes)
            log(f"kernels: {name}@want_ids {call:.4f} ms a call back to "
                f"back, {device:.4f} ms of device queued behind the host; "
                f"bound {rows[-1]['bound_ms']:.4f} ms")
    return rows


def pac_key(pac):
    return [(p, pac.bitmaps[p].tobytes()) for p in sorted(pac.bitmaps)]


def retrieval_runs(torch, adj, vt, batches, card, oracle, tag):
    """The 24 retrieval configurations on the card: batches of 8 / 16 /
    1024 / 16384 vertices, unfiltered and filtered by ``(L0 & L1) | ~L2``,
    with no page cache, then a 4096-page LRU cold (1 run) and warm (3
    runs).  Each run is held against the numpy oracle's run of the same
    batch, filter, cache state and repetition: computed here when
    ``oracle`` is empty (phase 4), reused when it is filled (phase 7)."""
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    enc = adj.table["<dst>"].encoded
    cond = (TC.L("L0") & TC.L("L1")) | ~TC.L("L2")
    filt = TC.LabelFilter(vt, cond)
    fill = not oracle
    results = []
    log(f"{tag}: host ms per batch on {card}, each run equal to numpy")

    def run(engine, vs, f, cache):
        enc.page_cache = cache
        meter = TC.IOMeter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pac = TC.retrieve_neighbors_batch(adj, vs, PAGE_SIZE, meter,
                                          engine=engine, filter=f)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (pac_key(pac), meter.nbytes, meter.nrequests,
                None if cache is None else
                (cache.hits, cache.misses, cache.evictions)), ms

    for b in BATCHES:
        vs = batches[b]
        for f in (None, filt):
            # one untimed call per shape: plan upload, predicate plane
            run(ENGINE, vs, f, None)
            caches = {ENGINE: DecodedPageCache(CACHE_PAGES),
                      "numpy": DecodedPageCache(CACHE_PAGES)}
            for mode in ("none", "cold", "warm"):
                key = (b, f is not None, mode)
                times = []
                for rep in range(REPS if mode != "cold" else 1):
                    cache = None if mode == "none" else caches[ENGINE]
                    got, ms = run(ENGINE, vs, f, cache)
                    times.append(ms)
                    if fill:
                        cache = None if mode == "none" else caches["numpy"]
                        oracle.setdefault(key, []).append(
                            run("numpy", vs, f, cache)[0])
                    require(got == oracle[key][rep],
                            f"{tag}: batch {b} filter={f is not None} "
                            f"{mode}: cuda differs from the numpy oracle")
                res = {"batch": b, "filtered": f is not None, "cache": mode,
                       "median_ms": statistics.median(times), "runs": times,
                       "pages": len(got[0]), "io_bytes": got[1],
                       "io_requests": got[2], "lru": got[3]}
                results.append(res)
                log(f"{tag}: batch {b:5d} filtered={f is not None!s:5} "
                    f"cache={mode:4s} median {res['median_ms']:.3f} ms "
                    f"({len(times)} runs), {res['pages']} PAC pages, "
                    f"io {res['io_bytes']} B / {res['io_requests']} req, "
                    f"lru {res['lru']}")
    enc.page_cache = None
    return results


def slice_phase(torch, adj, vt, batches, card, oracle):
    """Phase 4: the resident route, filling the numpy oracle."""
    return retrieval_runs(torch, adj, vt, batches, card, oracle, "slice")


def per_dispatch_phase(torch, adj, vt, batches, card, oracle):
    """Phase 7: the same configurations on the per-dispatch pack route
    (the module switch off for the phase), against phase 4's oracle."""
    from repro_torch.kernels.pac_decode import ops as pac_ops
    require(pac_ops.DEVICE_RESIDENT, "the resident route is not the default")
    pac_ops.DEVICE_RESIDENT = False
    results = retrieval_runs(torch, adj, vt, batches, card, oracle,
                             "per-dispatch")
    pac_ops.DEVICE_RESIDENT = True
    return results


def traversal_slice_phase(torch, adj, vt, card):
    """The traversal entry points on the card: ``k_hop`` (timed meterless,
    held against the host-loop oracle with a meter, with no cache and a
    cold then warm LRU), ``two_hop_pac`` against the staged numpy path
    and ``frontier_edge_counts`` against a numpy bincount."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    from repro_torch.kernels.traversal import ops as TO
    enc = adj.table["<dst>"].encoded
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    plan = TO.traversal_plan(adj, ENGINE)
    plan.device(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"traversal: plan built and uploaded in {build_s:.1f} s "
        f"({plan.rows} rows, {len(plan.key_sorted)} padded, "
        f"{plan.n_value} segments)")
    # a fresh filter: its predicate plane is built on this path
    filt = TC.LabelFilter(vt, (TC.L("L0") & TC.L("L1")) | ~TC.L("L2"))
    rng = np.random.default_rng(3)
    seeds_of = {s: rng.integers(0, N_VERTICES, s) for s in SEED_COUNTS}
    results = {"plan_build_s": build_s, "k_hop": []}
    log(f"traversal: k_hop host ms on {card}, each metered run equal to "
        f"the host-loop oracle")
    for n_seeds, seeds in seeds_of.items():
        for hops in (2, 3):
            for kind in ("none", "filter", "per_hop"):
                f = {"none": None, "filter": filt,
                     "per_hop": [None] + [filt] * (hops - 1)}[kind]
                ids = TC.k_hop(adj, seeds, hops, engine=ENGINE, filter=f)
                times = []
                for _ in range(REPS):
                    r0 = plan.device_roundtrips
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    TC.k_hop(adj, seeds, hops, engine=ENGINE, filter=f)
                    times.append((time.perf_counter() - t0) * 1e3)
                    require(plan.device_roundtrips == r0 + 1,
                            "a meterless k_hop made more than one round "
                            "trip")
                sizes = plan.last_frontier_sizes.tolist()
                caches = {ENGINE: DecodedPageCache(CACHE_PAGES),
                          "numpy": DecodedPageCache(CACHE_PAGES)}
                io = {}
                for mode in ("none", "cold", "warm"):
                    outs = {}
                    for engine, fused in ((ENGINE, None), ("numpy", False)):
                        cache = None if mode == "none" else caches[engine]
                        enc.page_cache = cache
                        meter = TC.IOMeter()
                        got = TC.k_hop(adj, seeds, hops, meter,
                                       engine=engine, filter=f, fused=fused)
                        outs[engine] = (got.tobytes(), meter.nbytes,
                                        meter.nrequests,
                                        None if cache is None else
                                        (cache.hits, cache.misses,
                                         cache.evictions))
                    enc.page_cache = None
                    require(outs[ENGINE] == outs["numpy"]
                            and outs[ENGINE][0] == ids.tobytes(),
                            f"k_hop seeds={n_seeds} hops={hops} {kind} "
                            f"{mode}: cuda differs from the oracle")
                    io[mode] = outs[ENGINE][1:]
                res = {"seeds": n_seeds, "hops": hops, "filter": kind,
                       "median_ms": statistics.median(times), "runs": times,
                       "ids": len(ids), "frontier_sizes": sizes, "io": io}
                results["k_hop"].append(res)
                log(f"traversal: k_hop seeds {n_seeds:2d} hops {hops} "
                    f"{kind:7s} median {res['median_ms']:.3f} ms, "
                    f"{len(ids)} ids, sizes {sizes}, io/lru {io}")

    f = [None, filt, filt]
    wall, busy = profile_ms(torch, lambda: TC.k_hop(
        adj, seeds_of[64], 3, engine=ENGINE, filter=f))
    results["k_hop_profile"] = {"wall_ms": wall, "device_ms": busy}
    log(f"traversal: k_hop profile (64 seeds, 3 hops, per-hop filter): "
        f"{wall:.3f} ms per call under the profiler, device busy "
        + (f"{sum(busy.values()):.3f} ms (idle share "
           f"{1 - sum(busy.values()) / wall:.3f}): " + ", ".join(
               f"{k[:40]} {v:.3f}" for k, v in sorted(
                   busy.items(), key=lambda kv: -kv[1]))
           if busy else "not measured (the profiler saw no device time)"))

    seed = int(seeds_of[1][0])
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    pac = TO.two_hop_pac(adj, adj, [seed], PAGE_SIZE, filt, m_k, ENGINE)
    created = TC.neighbor_ids_batch(adj, [seed], m_o, engine="numpy")
    want = TC.retrieve_neighbors_batch(adj, created, PAGE_SIZE, m_o,
                                       "numpy", filter=filt)
    require(pac_key(pac) == pac_key(want) and pac.count() > 0
            and (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests),
            "two_hop_pac differs from the staged numpy path")
    times = [host_timed(torch, lambda: TO.two_hop_pac(
        adj, adj, [seed], PAGE_SIZE, filt, engine=ENGINE))[1]
        for _ in range(REPS)]
    results["two_hop_pac"] = {"median_ms": statistics.median(times),
                              "runs": times, "ids": pac.count()}
    log(f"traversal: two_hop_pac from vertex {seed}: {pac.count()} ids, "
        f"median {statistics.median(times):.3f} ms, equal to the staged "
        f"numpy path (PAC, io {m_k.nbytes} B / {m_k.nrequests} req)")

    starts, ends = TC.LabelFilter(vt, TC.L("L0")).intervals("numpy")
    off = np.asarray(adj.offsets["<offset>"].values, np.int64)
    los, his = off[starts], off[ends]
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    counts = TO.frontier_edge_counts(adj, starts, ends, los, his, m_k,
                                     ENGINE)
    rows = TC.decode_edge_ranges(adj, los, his, m_o, "numpy")
    require(np.array_equal(counts, np.bincount(rows, minlength=N_VERTICES))
            and (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests),
            "frontier_edge_counts differs from the numpy bincount")
    times = [host_timed(torch, lambda: TO.frontier_edge_counts(
        adj, starts, ends, los, his, engine=ENGINE))[1] for _ in range(REPS)]
    results["frontier_edge_counts"] = {
        "median_ms": statistics.median(times), "runs": times,
        "intervals": len(starts), "edges": int(counts.sum())}
    log(f"traversal: frontier_edge_counts over L0's {len(starts)} "
        f"intervals: {int(counts.sum())} edges, median "
        f"{statistics.median(times):.3f} ms, equal to the numpy bincount "
        f"(io {m_k.nbytes} B / {m_k.nrequests} req)")
    results["inputs"] = {"plan": plan, "filt": filt, "seeds": seeds_of,
                         "intervals": (starts, ends)}
    return results


def profile_ms(torch, fn, reps: int = 5, events=None):
    """``torch.profiler`` over ``reps`` calls of ``fn``: host wall ms per
    call, and device ms per call by kernel or copy name (empty when the
    profiler sees no device activity), read from the raw trace.  With a
    list ``events``, the device ms per call summed from ``prof.events()``
    (the parsed events, the earlier reader) is appended to it, to show
    that the two readers agree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy = {}
    # the raw trace: parsing it into FunctionEvents (prof.events()) took
    # 45 s for one train step's events (phase 19p)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy[e.name()] = (busy.get(e.name(), 0.0)
                              + e.duration_ns() / 1e6 / reps)
    if events is not None:
        events.append(sum(e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == DeviceType.CUDA) / 1e3 / reps)
    return wall, busy


def kernel_name(name: str) -> str:
    """A profiler's kernel name without its namespace, return type and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("void ").strip()


def host_timed(torch, fn):
    """``(fn(), host wall milliseconds of the call)``, synchronised on both
    ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def needed_rows(torch, ks, voff, frontier, active):
    """Row mask of the ``key_sorted`` rows an expansion of ``frontier``
    must read for the value ids marked ``active``: each segment up to its
    first selected row, or whole where none is selected (the early exit
    of kernels 5 and 6)."""
    n = voff.numel() - 1
    nk = frontier.numel()
    rows = int(voff[-1])
    ksl = ks[:rows].long()
    sel = (ksl < nk) & (frontier[ksl.clamp(max=nk - 1)] != 0)
    lens = (voff[1:] - voff[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n, device=ks.device), lens)
    r = torch.arange(rows, device=ks.device)
    first = torch.full((n,), rows, dtype=torch.int64, device=ks.device)
    first = first.scatter_reduce(0, seg[sel], r[sel], "amin")
    return active[seg] & (r <= first[seg])


def traversal_kernel_phase(torch, inputs):
    """Kernels 5-7 against their plain versions on the card, bit for bit,
    at the shapes the traversal slice gives them (and with padding keys,
    sentinel seeds and intervals, overlapping intervals and an end equal
    to ``n_key``), each timed beside its bound."""
    import numpy as np
    from repro_torch.kernels._pad import size_class
    from repro_torch.kernels.traversal import kernel as TK
    from repro_torch.kernels.traversal import ops as TO
    from repro_torch.kernels.traversal import ref as TR
    dev = torch.device(DEVICE)
    plan, filt = inputs["plan"], inputs["filt"]
    ks, voff = plan.device(dev)
    n = plan.n_value
    n_words = -(-n // 32)
    rng = np.random.default_rng(4)
    hit = torch.from_numpy(rng.choice(plan.rows, 4096, replace=False)) \
        .to(dev)
    ks_pad = ks.clone()
    ks_pad[hit] = plan.n_key
    fwords = filt.plan().device_bitmap(dev, n_words)
    ones = torch.full((n_words,), -1, dtype=torch.int32, device=dev)
    rows = []

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def bits_of(words, count):
        return TR._filter_bits(words, count).bool()

    # -- 5: khop_scan at the 64-seed, 3-hop, per-hop-filter shape, and with
    #    padding keys, duplicate and sentinel seeds
    sv = to_dev(TO._seed_vector(np.unique(inputs["seeds"][64]), n))
    sv_junk = sv.clone()
    sv_junk[40:] = n
    sv_junk[30:40] = sv[:10]
    fw3 = torch.stack([ones, fwords, fwords])
    want = TR.khop_scan(ks, voff, sv, fw3, n)
    got = TK.khop_scan(ks, voff, sv, fw3, n)
    require(equal(got, want), "khop_scan differs")
    err = max(max_err(a, b) for a, b in zip(got, want))
    for k, s_ in ((ks_pad, sv), (ks, sv_junk), (ks_pad, sv_junk)):
        require(equal(TK.khop_scan(k, voff, s_, fw3, n),
                      TR.khop_scan(k, voff, s_, fw3, n)),
                "khop_scan differs with padding keys or sentinel seeds")
    # the card's clocks fall while the host works (phase 5): warm it up
    # before it is timed
    cuda_ms(torch, lambda: TK.khop_scan(ks, voff, sv, fw3, n), 30)
    visited, planes, _ = want
    frontier = TR._seed_plane(sv, n)
    seen = frontier.clone()
    need = torch.zeros(int(voff[-1]), dtype=torch.bool, device=dev)
    for h in range(fw3.shape[0]):
        active = (seen == 0) & bits_of(fw3[h], n)
        need |= needed_rows(torch, ks, voff, frontier, active)
        frontier = planes[h]
        seen = seen + frontier
    nbytes = 4 * (int(need.sum()) + (n + 1) + sv.numel() + fw3.numel()
                  + n + planes.numel() + fw3.shape[0])
    rows.append(kernel_row(
        "khop_scan", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:42", err,
        cuda_ms(torch, lambda: TK.khop_scan(ks, voff, sv, fw3, n), 10),
        cuda_ms(torch, lambda: TR.khop_scan(ks, voff, sv, fw3, n), 2),
        nbytes))
    log(f"kernels: khop_scan equal at 3 hops, {plan.rows} rows, "
        f"{int(sv.lt(n).sum())} seeds (and with {len(hit)} padding keys, "
        f"duplicate and sentinel seeds); sizes {want[2].tolist()}, "
        f"{int(need.sum())} rows needed")

    # -- 6: two_hop at the one-seed IC-8 shape (63 sentinel seeds)
    sv1 = to_dev(TO._seed_vector(inputs["seeds"][1][:1], n))
    kw = dict(n_key=n, n_mid=n, n_out=n, n_words=n_words)
    want = TR.two_hop(ks, voff, ks, voff, sv1, fwords, **kw)
    got = TK.two_hop(ks, voff, ks, voff, sv1, fwords, **kw)
    require(equal(got, want), "two_hop differs")
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(equal(TK.two_hop(ks_pad, voff, ks_pad, voff, sv_junk, fwords,
                             **kw),
                  TR.two_hop(ks_pad, voff, ks_pad, voff, sv_junk, fwords,
                             **kw)),
            "two_hop differs with padding keys or sentinel seeds")
    all_v = torch.ones(n, dtype=torch.bool, device=dev)
    need_a = needed_rows(torch, ks, voff, TR._seed_plane(sv1, n), all_v)
    need_b = needed_rows(torch, ks, voff, want[0], all_v)
    nbytes = 4 * (int(need_a.sum()) + int(need_b.sum()) + 2 * (n + 1)
                  + sv1.numel() + 2 * n_words + n)
    rows.append(kernel_row(
        "two_hop", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:74", err,
        cuda_ms(torch, lambda: TK.two_hop(ks, voff, ks, voff, sv1, fwords,
                                          **kw), 10),
        cuda_ms(torch, lambda: TR.two_hop(ks, voff, ks, voff, sv1, fwords,
                                          **kw), 2),
        nbytes))
    log(f"kernels: two_hop equal from 1 seed ({int(want[0].sum())} mid "
        f"ids; and with padding keys, sentinel seeds)")

    # -- 7: count_hop over L0's intervals padded with the sentinel, and
    #    with overlapping intervals and an end equal to n_key
    starts, ends = inputs["intervals"]

    def bounds(st, en):
        i_pad = size_class(len(st), TO.INTERVAL_CLASS_MIN)
        s_ = np.full(i_pad, plan.n_key + 1, np.int32)
        e_ = np.full(i_pad, plan.n_key + 1, np.int32)
        s_[:len(st)] = st
        e_[:len(en)] = en
        return to_dev(s_), to_dev(e_)

    s_, e_ = bounds(starts, ends)
    kw = dict(n_key=plan.n_key, n_out=n)
    want = TR.count_hop(ks, voff, s_, e_, **kw)
    got = TK.count_hop(ks, voff, s_, e_, **kw)
    require(torch.equal(got, want), "count_hop differs")
    err = max_err(got, want)
    s2, e2 = bounds(np.r_[starts, starts[:3], n - 1000],
                    np.r_[ends, ends[:3] + 5000, n])
    require(torch.equal(TK.count_hop(ks_pad, voff, s2, e2, **kw),
                        TR.count_hop(ks_pad, voff, s2, e2, **kw)),
            "count_hop differs with overlapping intervals or end == n_key")
    nbytes = 4 * (int(voff[-1]) + (n + 1) + s_.numel() + e_.numel() + n)
    each = cuda_ms_each(torch, lambda: TK.count_hop(ks, voff, s_, e_, **kw),
                        10)
    rows.append(kernel_row(
        "count_hop", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:113", err,
        statistics.fmean(each),
        cuda_ms(torch, lambda: TR.count_hop(ks, voff, s_, e_, **kw), 2),
        nbytes))
    log(f"kernels: count_hop equal over {len(starts)} intervals "
        f"(i_pad {s_.numel()}; and overlapping, end == n_key), "
        f"{int(want.sum())} edges; ms per call "
        + ", ".join(f"{t:.3f}" for t in each))
    return rows


def ldbc_phase(torch, card, wrappers):
    """Phase 8: IS-3, IC-8 and BI-2 over an LDBC-SNB-like graph of
    ``ldbc_like(scale=LDBC_SCALE)``, each under the resident route and then
    the per-dispatch route on the card, held against the numpy engine
    (result and IOMeter) and the acero baseline (result); graphar on the
    card timed (host ms, median of 3) beside acero (one run)."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.core import query as Q
    from repro_torch.data.synthetic import ldbc_like
    from repro_torch.kernels.pac_decode import ops as pac_ops
    t0 = time.perf_counter()
    snb = ldbc_like(scale=LDBC_SCALE, seed=0)
    g = Q.build_snb_graphar(snb, PAGE_SIZE)
    base = Q.build_snb_baseline(snb, PAGE_SIZE)
    build_s = time.perf_counter() - t0
    knows = g.adjacency("person-knows-person", TC.BY_SRC)
    msgs = np.bincount(snb.has_creator_person, minlength=snb.num_persons)
    rng = np.random.default_rng(5)
    persons = rng.integers(0, snb.num_persons, 4)
    top_msgs = int(np.argmax(msgs))
    require(msgs[top_msgs] >= pac_ops.FUSED_MIN_RANGES,
            "no person has enough messages for the fused hop-2 retrieval")
    log(f"ldbc: ldbc_like(scale={LDBC_SCALE}): {snb.num_persons} persons, "
        f"{snb.num_messages} messages, {len(snb.knows_src)} knows, "
        f"{len(snb.reply_of_src)} replyOf, {len(snb.has_tag_msg)} hasTag "
        f"edges; graphar and acero tables built in {build_s:.1f} s "
        f"(host); top knows degree {int(knows.degrees().max())}, top "
        f"messages {int(msgs[top_msgs])}")
    # the fused labeled hop 2 with a non-empty answer: of the persons with
    # enough messages for the fused retrieval, the (person, tag class)
    # with the most labeled replies
    parent = snb.has_creator_person[snb.reply_of_dst]  # message i's creator
    fusable = msgs[parent] >= pac_ops.FUSED_MIN_RANGES
    labeled = np.stack([np.bincount(
        parent[fusable & snb.message_labels[name][snb.reply_of_src]],
        minlength=snb.num_persons) for name in snb.tagclass_names])
    best_c, best_p = np.unravel_index(np.argmax(labeled), labeled.shape)
    ic8_fused_label = ("IC-8", int(best_p), snb.tagclass_names[best_c])
    require(labeled[best_c, best_p] > 0,
            "no fused labeled IC-8 has a non-empty answer")
    queries = [("IS-3", int(p), None) for p in
               (int(np.argmax(knows.degrees())), *persons[:2])]
    queries += [("IC-8", int(p), lab)
                for p in (top_msgs, *persons[2:2 + LDBC_IC8_PERSONS])
                for lab in LDBC_IC8_LABELS]
    queries += [ic8_fused_label]
    queries += [("BI-2", name, None)
                for name in LDBC_BI2_CLASSES]
    log(f"ldbc: fused labeled IC-8: person {best_p} "
        f"({int(msgs[best_p])} messages), {ic8_fused_label[2]}, "
        f"{int(labeled[best_c, best_p])} labeled replies")

    def graphar(q, engine, meter=None):
        kind, arg, lab = q
        if kind == "IS-3":
            return Q.is3_graphar(g, arg, meter, engine)
        if kind == "IC-8":
            return Q.ic8_graphar(g, arg, meter=meter, engine=engine,
                                 reply_label=lab)
        return Q.bi2_graphar(g, arg, meter, engine)

    def acero(q, meter=None):
        kind, arg, lab = q
        if kind == "IS-3":
            return Q.is3_acero(base, arg, meter)
        if kind == "IC-8":
            return Q.ic8_acero(base, arg, meter=meter, reply_label=lab)
        return Q.bi2_acero(base, arg, meter)

    def same(kind, a, b):
        if kind == "BI-2":
            return a == b
        if kind == "IS-3":     # friends in date order; ties in any order
            return (np.array_equal(np.sort(a[0]), np.sort(b[0]))
                    and np.array_equal(a[1], b[1]))
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    def size(kind, r):
        return len(r) if kind == "BI-2" else len(r[0])

    oracle = {}
    results = {"build_s": build_s, "queries": []}
    for q in queries:
        m_n = TC.IOMeter()
        want = graphar(q, "numpy", m_n)
        refs, times = [], []
        for _ in range(ACERO_REPS):     # timed runs; each result checked
            times.append(host_timed(torch, lambda: refs.append(acero(q)))[1])
        require(all(same(q[0], want, ref) for ref in refs),
                f"{q}: the numpy engine differs from acero")
        oracle[q] = (want, (m_n.nbytes, m_n.nrequests),
                     statistics.median(times))
    for resident in (True, False):
        regime = "resident" if resident else "per-dispatch"
        pac_ops.DEVICE_RESIDENT = resident
        before = {n: w.launches for n, w in wrappers.items()}
        mem0 = torch.cuda.memory_allocated()
        for q in queries:
            want, io, acero_ms = oracle[q]
            m_k = TC.IOMeter()
            got = graphar(q, ENGINE, m_k)
            require(same(q[0], got, want)
                    and (m_k.nbytes, m_k.nrequests) == io,
                    f"{q} {regime}: cuda differs from the numpy engine")
            times = [host_timed(torch, lambda: graphar(q, ENGINE))[1]
                     for _ in range(REPS)]
            res = {"query": q[0], "arg": q[1], "label": q[2],
                   "regime": regime, "median_ms": statistics.median(times),
                   "runs": times, "acero_ms": acero_ms,
                   "size": size(q[0], got), "io": list(io)}
            results["queries"].append(res)
            if q == ic8_fused_label:
                require(res["size"] > 0, f"{q} {regime}: empty answer")
            log(f"ldbc: {q[0]} {q[1]!s:9} label={q[2]!s:9} {regime:12s} "
                f"cuda median {res['median_ms']:.3f} ms, acero "
                f"{acero_ms:.3f} ms, {res['size']} rows, io {io[0]} B / "
                f"{io[1]} req, equal to numpy and acero")
        ran = {n: w.launches - before[n] for n, w in wrappers.items()}
        results[f"{regime}_launches"] = ran
        if resident:
            results["resident_device_bytes"] = \
                torch.cuda.memory_allocated() - mem0
            log(f"ldbc: the resident pass left "
                f"{results['resident_device_bytes']} B more allocated on "
                f"the card (plans, predicate planes)")
        log(f"ldbc: {regime} launches {ran}")
    # where the time goes: the host's heaviest functions (cProfile, one
    # call) and the device's busy share (torch.profiler, 3 calls)
    is3, ic8_label = queries[0], ic8_fused_label  # top degree, fused hop 2
    bi2 = ("BI-2", "TagClass3", None)
    starts, ends = TC.LabelFilter(g.vertex("message"),
                                  TC.L(bi2[1])).intervals("numpy")
    log(f"ldbc: {bi2[1]} labels {len(starts)} intervals of messages")
    from repro_torch.kernels.traversal import ops as TO
    results["bi2_inputs"] = {
        "plan": TO.traversal_plan(g.adjacency("message-hasTag-tag",
                                              TC.BY_SRC), ENGINE),
        "intervals": (starts, ends)}
    results["profiles"] = []
    for resident, q in ((True, is3), (False, ic8_label), (True, bi2),
                        (False, bi2)):
        pac_ops.DEVICE_RESIDENT = resident
        hot = host_profile(lambda: graphar(q, ENGINE))
        wall, busy = profile_ms(torch, lambda: graphar(q, ENGINE), 3)
        regime = "resident" if resident else "per-dispatch"
        hop_ms = sum(v for k, v in busy.items()
                     if any(c in k for c in COUNT_HOP_KERNELS))
        results["profiles"].append({"query": list(q), "regime": regime,
                                    "host_top": hot, "wall_ms": wall,
                                    "device_ms": busy,
                                    "count_hop_ms": hop_ms})
        top_dev = sorted(busy.items(), key=lambda kv: -kv[1])[:4]
        log(f"ldbc: profile {q[0]} {q[1]} label={q[2]} {regime}: "
            f"{wall:.3f} ms per call, device busy "
            f"{sum(busy.values()):.3f} ms ("
            + ", ".join(f"{k[:48]} {v:.3f}" for k, v in top_dev)
            + (f"; count_hop {hop_ms:.4f}" if q[0] == "BI-2" else "")
            + "); host tottime: "
            + ", ".join(f"{name} {ms:.1f} ms" for name, ms in hot))
    pac_ops.DEVICE_RESIDENT = True
    return results


def bi2_count_hop_row(torch, inputs):
    """Row 7b: ``count_hop`` at BI-2's shape -- ``ldbc_like(40)``'s
    ``message-hasTag-tag`` plan (3,200,000 messages to 64 tags) over
    TagClass3's intervals of messages, padded as ``frontier_edge_counts``
    pads them -- against its plain version bit for bit, timed beside it
    and its bound (counted as phase 6 counts row 7).  It runs after phase
    8's launch counts are read, so its launches do not count."""
    import numpy as np
    from repro_torch.kernels._pad import size_class
    from repro_torch.kernels.traversal import kernel as TK
    from repro_torch.kernels.traversal import ops as TO
    from repro_torch.kernels.traversal import ref as TR
    dev = torch.device(DEVICE)
    plan, (starts, ends) = inputs["plan"], inputs["intervals"]
    ks, voff = plan.device(dev)
    n = plan.n_value
    i_pad = size_class(len(starts), TO.INTERVAL_CLASS_MIN)
    s_ = np.full(i_pad, plan.n_key + 1, np.int32)
    e_ = np.full(i_pad, plan.n_key + 1, np.int32)
    s_[:len(starts)] = starts
    e_[:len(ends)] = ends
    s_, e_ = torch.from_numpy(s_).to(dev), torch.from_numpy(e_).to(dev)
    kw = dict(n_key=plan.n_key, n_out=n)
    want = TR.count_hop(ks, voff, s_, e_, **kw)
    got = TK.count_hop(ks, voff, s_, e_, **kw)
    require(torch.equal(got, want), "count_hop differs at BI-2's shape")
    nbytes = 4 * (int(voff[-1]) + (n + 1) + s_.numel() + e_.numel() + n)
    each = cuda_ms_each(torch, lambda: TK.count_hop(ks, voff, s_, e_, **kw),
                        10)
    row = kernel_row(
        "count_hop@BI-2", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:113", max_err(got, want),
        statistics.fmean(each),
        cuda_ms(torch, lambda: TR.count_hop(ks, voff, s_, e_, **kw), 2),
        nbytes)
    log(f"8. count_hop at BI-2's shape equal to its plain version: "
        f"{plan.n_key} messages, {n} tags, {int(voff[-1])} rows, "
        f"{len(starts)} intervals (i_pad {i_pad}), {int(want.sum())} edges; "
        f"kernel {row['ms']:.4f} ms (each "
        + ", ".join(f"{t:.4f}" for t in each)
        + f"), plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
        f"ms")
    return row


def host_profile(fn, top: int = 6):
    """The ``top`` functions by own host time (cProfile over one call of
    ``fn``): ``[(file:line(function), ms), ...]``."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{Path(k[0]).name}:{k[1]}({k[2]})", v[2] * 1e3)
                   for k, v in stats.items()), key=lambda r: -r[1])
    return rows[:top]


def per_dispatch_kernel_phase(torch, adj, vt, batches):
    """Phase 9: kernels 8-10 against their plain versions on the card, bit
    for bit, at the shapes of phase 7's 16384 batch with a cold LRU (every
    page a miss, one zero cached row), and in a warm dispatch (no miss:
    one zero page), with ``gidx`` rows past ``gcount`` and past the
    matrix, and under two programs whose NOT is not the last op; timed
    beside their byte bound, with the host pack and the host-to-device
    copy timed apart."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.label_filter import ref as LR
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.pac_decode import ops
    from repro_torch.kernels.pac_decode import ref as PR
    from repro_torch.core.encoding import prune_page_list
    dev = torch.device(DEVICE)
    vs = batches[BATCHES[-1]]
    n_words = -(-adj.num_value_vertices // 32)
    col = adj.table["<dst>"].encoded
    rows = []

    def staged(filt=None):
        """What the fused per-dispatch route ships for batch ``vs`` with
        no page cache (every page a miss), from its own staging step;
        with the number of real pages."""
        los, his = adj.edge_ranges_batch(vs)
        pages, _ = ops.page_set_for_ranges(los, his, col.page_size)
        qual = filt.qual_range() if filt is not None else None
        pages, pmask = prune_page_list(col, pages, qual)
        return (*ops.stage_packed(col, los, his, pages, pmask, {},
                                  [int(p) for p in pages]), len(pages))

    def page_bytes(args, m):
        """Bytes of the m real pages' arrays a decode must read: the
        header arrays whole, and of the packed words only the sum of the
        page's bit widths (a miniblock of width bw packs its 32 deltas
        into bw words; the zero words past them are never read)."""
        n_mini = args[1].shape[1]
        return 4 * (m * (2 + 3 * n_mini) + int(args[2][:m].sum()))

    t0 = time.perf_counter()
    args, cached, gidx, total, m = staged()
    pack_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages_t = ops.ship_pages(args, dev)
    rest = [torch.from_numpy(a).to(dev) for a in
            (cached, gidx, np.full((1, 1), total, np.int32))]
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    m_pad, ps = args[0].shape[0], cached.shape[1]
    shipped_mb = sum(a.nbytes for a in args) / 1e6
    log(f"kernels: per-dispatch batch {len(vs)}: {m} miss pages "
        f"(m_pad {m_pad}), {total} rows (t {len(gidx)}): host pack "
        f"{pack_ms:.3f} ms, host-to-device copy of {shipped_mb:.1f} MB "
        f"{h2d_ms:.3f} ms")
    page_in = page_bytes(args, m)

    def timed(fn):
        """A call's device ms (events around back-to-back calls) and the
        device's own ms with the calls queued behind the host."""
        call = cuda_ms(torch, fn, 10)
        device = queued_ms(torch, fn, 10)
        return call, device

    # -- 10: delta_decode over the miss pages
    k = PK.delta_decode(*pages_t, page_size=ps)
    r = PR.decode_pages(*pages_t, page_size=ps)
    require(torch.equal(k, r), f"delta_decode differs ({max_err(k, r)})")
    call, device = timed(lambda: PK.delta_decode(*pages_t, page_size=ps))
    rows.append(kernel_row(
        "delta_decode", "src/repro_torch/kernels/csrc/per_dispatch.cu",
        "src/repro/kernels/pac_decode/kernel.py:110", max_err(k, r), call,
        cuda_ms(torch, lambda: PR.decode_pages(*pages_t, page_size=ps), 2),
        page_in + 4 * m * ps))
    log(f"kernels: delta_decode equal over {m_pad} pages; {call:.4f} ms a "
        f"call, {device:.4f} ms of device queued")
    decoded = k

    # -- 8: cold (no hits), then warm (no misses) with junk gidx rows
    def fused(*a):
        return PK.fused_decode_bitmap_batch(*a, n_words=n_words)

    def fused_plain(*a):
        return PR.fused_batch(*a, n_words=n_words)

    def check(kern, plain, inputs, what):
        kw, ki = kern(*inputs)
        rw, ri = plain(*inputs)
        require(torch.equal(kw, rw) and torch.equal(ki, ri),
                f"{what} differs ({max_err(kw, rw)}, {max_err(ki, ri)})")
        return max(max_err(kw, rw), max_err(ki, ri))

    cold = (*pages_t, *rest)
    err = check(fused, fused_plain, cold, "fused_decode_bitmap_batch cold")
    junk = rest[1].clone()
    end = (m_pad + 1) * ps
    junk[:3] = torch.tensor([end + 5, -7, end - 1], dtype=torch.int32)
    junk[total:] = torch.randint(-50, end + 50, junk[total:].shape,
                                 dtype=torch.int32, device=dev)
    check(fused, fused_plain, (*pages_t, rest[0], junk, rest[2]),
          "fused_decode_bitmap_batch with junk gidx")
    # warm: the first 4096 pages arrive decoded, nothing ships packed
    hits = min(m, CACHE_PAGES)
    counts = torch.from_numpy(args[5][:hits, 0].astype(np.int64)).to(dev)
    lane = torch.arange(ps, device=dev)
    warm_cached = torch.where(lane[None, :] < counts[:, None],
                              decoded[:hits], torch.zeros_like(
                                  decoded[:hits]))
    zero_page = tuple(torch.zeros((1,) + t.shape[1:], dtype=torch.int32,
                                  device=dev) for t in pages_t)
    g_np = gidx[:total]
    keep = g_np < hits * ps
    warm_g = np.zeros(len(gidx), np.int32)
    warm_g[:int(keep.sum())] = g_np[keep] + ps      # rows shift past m_pad=1
    warm = (*zero_page, warm_cached.contiguous(),
            torch.from_numpy(warm_g).to(dev),
            torch.full((1, 1), int(keep.sum()), dtype=torch.int32,
                       device=dev))
    check(fused, fused_plain, warm, "fused_decode_bitmap_batch warm")
    t = len(gidx)
    call, device = timed(lambda: fused(*cold))
    rows.append(kernel_row(
        "fused_decode_bitmap_batch",
        "src/repro_torch/kernels/csrc/per_dispatch.cu",
        "src/repro/kernels/pac_decode/kernel.py:321", err, call,
        cuda_ms(torch, lambda: fused_plain(*cold), 2),
        page_in + 4 * m * ps + 4 * t + 4 + 4 * n_words))
    log(f"kernels: fused_decode_bitmap_batch equal cold ({m_pad} pages, 1 "
        f"zero cached row), with rows past gcount and past the matrix, "
        f"and warm (1 zero page, {hits} cached rows); {call:.4f} ms a "
        f"call, {device:.4f} ms of device queued")
    splits = {"fused_decode_bitmap_batch": lambda: fused(*cold)}

    # -- 9: the phase's filter, and a NOT-first program, cold and warm
    progs = [(TC.L("L0") & TC.L("L1")) | ~TC.L("L2"),
             ~TC.L("L0") & TC.L("L1")]
    for i, cond in enumerate(progs):
        plan = TC.LabelFilter(vt, cond).plan()
        fargs = (torch.from_numpy(plan.pos).to(dev),
                 torch.from_numpy(plan.meta).to(dev), plan.program.ops)

        def ffused(*a, fargs=fargs):
            return LK.fused_decode_filter_bitmap_batch(*a, *fargs, n_words)

        def fplain(*a, fargs=fargs):
            return LR.fused_filter_batch(*a, *fargs, n_words)

        if i == 0:
            fa, fc, fg, ftotal, fm = staged(TC.LabelFilter(vt, cond))
            fcold = (*ops.ship_pages(fa, dev), *[
                torch.from_numpy(a).to(dev) for a in
                (fc, fg, np.full((1, 1), ftotal, np.int32))])
            err = check(ffused, fplain, fcold,
                        "fused_decode_filter_bitmap_batch cold")
            nbytes = (page_bytes(fa, fm) + 4 * fm * ps + 4 * len(fg) + 4
                      + 4 * n_words + plan.pos.nbytes + plan.meta.nbytes)
            call, device = timed(lambda: ffused(*fcold))
            row = kernel_row(
                "fused_decode_filter_bitmap_batch",
                "src/repro_torch/kernels/csrc/per_dispatch.cu",
                "src/repro/kernels/label_filter/kernel.py:147", err, call,
                cuda_ms(torch, lambda: fplain(*fcold), 2), nbytes)
            splits["fused_decode_filter_bitmap_batch"] = \
                lambda: ffused(*fcold)
        else:
            check(ffused, fplain, cold,
                  "fused_decode_filter_bitmap_batch NOT-first")
        check(ffused, fplain, warm, "fused_decode_filter_bitmap_batch warm")
    rows.append(row)
    log(f"kernels: fused_decode_filter_bitmap_batch equal cold and warm "
        f"under {len(progs)} programs; {call:.4f} ms a call, {device:.4f} "
        f"ms of device queued")
    # each launch's device ms, from a profiler window after every timing;
    # after earlier windows in the process, a window can come back with no
    # device event
    for name, fn in splits.items():
        for _ in range(3):
            _, busy = profile_ms(torch, fn, 5)
            if busy:
                break
        log(f"kernels: {name} per launch: " + (", ".join(
            f"{kernel_name(k)} {v:.4f} ms" for k, v in busy.items())
            or "not measured"))
    return rows, {"pack_ms": pack_ms, "h2d_ms": h2d_ms,
                  "shipped_mb": shipped_mb, "m": m, "m_pad": m_pad,
                  "rows": total}


def per_dispatch_rows(torch, adj, vt, batches):
    """Phase 9, logged; returns its kernel rows."""
    t0 = time.perf_counter()
    rows, host = per_dispatch_kernel_phase(torch, adj, vt, batches)
    log(f"9. per-dispatch kernels: all three equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s); host pack {host['pack_ms']:.3f}"
        f" ms, host-to-device copy {host['h2d_ms']:.3f} ms")
    return rows


def dense_words(np, bits, n_words):
    """uint32[n_words] with bit i set where ``bits[i]``."""
    plane = np.zeros(32 * n_words, bool)
    plane[:len(bits)] = bits
    return np.packbits(plane, bitorder="little").view(np.uint32)


def pac_from_key(key):
    """The PAC of a ``pac_key`` list (phase 4's oracle keeps those)."""
    import numpy as np
    from repro_torch.core.pac import PAC
    return PAC(PAGE_SIZE, {p: np.frombuffer(b, np.uint32).copy()
                           for p, b in key})


def entries_phase(torch, adj, truth, batches, oracle, card):
    """Phase 10: the single-range, RLE-label and selection entries and
    numeric predicates on the card, each run held bit for bit against the
    numpy oracle: ``ids_to_bitmap`` over phase 4's batch-16384 PAC, the
    sorted ``<src>`` ids and a window of them; ``decode_range_to_bitmap``
    over the whole ``<src>`` and ``<dst>`` columns and a page-aligned
    sub-range; ``rle_to_bitmap`` over the 8 label columns (``want`` True
    and False) and a scattered column; ``select_from_pages`` of a seeded
    ``age`` property by the batch-16384 PAC; and ``retrieve_neighbors_batch``
    of that batch filtered by two ``NumericFilter``s over ``age`` and one
    with a NOT over a clustered property's leaf whose zone maps skip
    pages, resident and per-dispatch.  Returns the results and the inputs
    the kernel phase reuses."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.data.synthetic import scattered_labels
    from repro_torch.kernels.bitmap_select.ops import select_from_pages
    from repro_torch.kernels.pac_decode import ops
    from repro_torch.kernels.rle_filter.ops import rle_to_bitmap
    n_words = -(-N_VERTICES // 32)
    res = {}

    # (a) ids_to_bitmap; the batch-16384 PAC from phase 4's oracle, or
    #     from the numpy engine where phase 4 has not run (--entries)
    key = (BATCHES[-1], False, "none")
    pac = pac_from_key(oracle[key][0][0]) if key in oracle else \
        TC.retrieve_neighbors_batch(adj, batches[BATCHES[-1]], PAGE_SIZE,
                                    None, engine="numpy")
    wpp = PAGE_SIZE // 32
    pac_words = np.zeros(-(-N_VERTICES // PAGE_SIZE) * wpp, np.uint32)
    for p, w in pac.bitmaps.items():
        pac_words[p * wpp:(p + 1) * wpp] = w
    pac_words = pac_words[:n_words]
    src_ids = np.repeat(np.arange(N_VERTICES, dtype=np.int32),
                        adj.degrees().astype(np.int64))
    window = (32 * (N_VERTICES // 64), N_VERTICES // 512)
    for what, ids, base, nw, want in (
            ("the batch-16384 PAC's ids", pac.to_ids(), 0, n_words,
             pac_words),
            ("the <src> column's ids", src_ids, 0, n_words,
             dense_words(np, truth["src"], n_words)),
            ("a window of the <src> ids", src_ids, *window, None)):
        got, ms = host_timed(
            torch, lambda: ops.ids_to_bitmap(ids, base, nw, ENGINE))
        if want is None:
            want = ops.ids_to_bitmap(ids, base, nw, "numpy")
            require(want.any() and ids.min() < base
                    and ids.max() >= base + 32 * nw,
                    "the window has no ids on both sides")
        require(np.array_equal(got, want),
                f"ids_to_bitmap differs over {what}")
        log(f"entries: ids_to_bitmap over {what} ({len(ids)} ids, base "
            f"{base}, {nw} words) equal, {ms:.3f} ms")
    # (b) decode_range_to_bitmap
    src_col = adj.table["<src>"].encoded
    dst_col = adj.table["<dst>"].encoded
    sub = (1000 * PAGE_SIZE, 1100 * PAGE_SIZE, 32 * (N_VERTICES // 96),
           N_VERTICES // 100)
    for what, col, lo, hi, base, nw, want in (
            ("the whole <src> column", src_col, 0, src_col.count, 0, n_words,
             dense_words(np, truth["src"], n_words)),
            ("the whole <dst> column", dst_col, 0, dst_col.count, 0, n_words,
             dense_words(np, truth["dst"], n_words)),
            ("<dst> pages [1000, 1100)", dst_col, *sub, None)):
        got, ms = host_timed(torch, lambda: ops.decode_range_to_bitmap(
            col, lo, hi, base, nw, ENGINE))
        if want is None:
            want = ops.decode_range_to_bitmap(col, lo, hi, base, nw, "numpy")
        require(np.array_equal(got, want) and want.any(),
                f"decode_range_to_bitmap differs over {what}")
        log(f"entries: decode_range_to_bitmap over {what} (rows [{lo}, "
            f"{hi}), base {base}, {nw} words) equal, {ms:.3f} ms")
    # (c) rle_to_bitmap
    scattered = scattered_labels(N_VERTICES, ["S"], seed=5)["S"]
    rles = {name: TC.rle_encode_bool(truth["labels"][name])
            for name in LABELS}
    rles["scattered"] = TC.rle_encode_bool(scattered)
    planes = dict(truth["labels"], scattered=scattered)
    for name, rle in rles.items():
        for want_value in (True, False):
            got, ms = host_timed(
                torch, lambda: rle_to_bitmap(rle, want_value, ENGINE))
            require(np.array_equal(got, dense_words(
                np, planes[name] == want_value, n_words)),
                f"rle_to_bitmap differs on {name} == {want_value}")
        log(f"entries: rle_to_bitmap on {name} ({rle.positions.size} "
            f"positions) equal for want True and False, {ms:.3f} ms")
    # (d) select_from_pages
    age = np.random.default_rng(4).integers(0, 100, N_VERTICES) \
        .astype(np.int32)
    vals = age.astype(np.float32)
    page_values = {p: vals[p * PAGE_SIZE:(p + 1) * PAGE_SIZE]
                   for p in pac.pages()}
    got, ms = host_timed(
        torch, lambda: select_from_pages(pac, page_values, ENGINE))
    require(np.array_equal(got.view(np.int32),
                           vals[pac.to_ids()].view(np.int32)),
            "select_from_pages differs from vals[pac.to_ids()]")
    log(f"entries: select_from_pages over {len(pac.pages())} pages "
        f"({pac.count()} ids) equal, {ms:.3f} ms")
    # (e) numeric-filtered retrieval, resident and per-dispatch
    # `joined` rises with the vertex id, so the zone maps skip the pages
    # of `joined < 2500` past the column's middle and NOT carries the
    # leaf's False there over as True
    joined = np.sort(np.random.default_rng(5).integers(0, 5000, N_VERTICES)
                     .astype(np.int32))
    vt_age = TC.VertexTable.build(
        TC.VertexTypeSchema("v_age", [TC.PropertySchema("age", "int32"),
                                      TC.PropertySchema("joined", "int32")],
                            page_size=PAGE_SIZE),
        {"age": age, "joined": joined}, {}, num_vertices=N_VERTICES)
    vs = batches[BATCHES[-1]]
    conds = {"18 <= age < 30": TC.NumProp("age").between(18, 30),
             "age >= 90": TC.NumProp("age") >= 90,
             "~(joined < 2500) & age >= 90":
                 ~(TC.NumProp("joined") < 2500) & (TC.NumProp("age") >= 90)}

    def run(engine, cond, resident=None):
        filt = TC.NumericFilter(vt_age, cond)
        out = []
        for _ in range(REPS if engine == ENGINE else 1):
            meter = TC.IOMeter()
            p, ms = host_timed(torch, lambda: TC.retrieve_neighbors_batch(
                adj, vs, PAGE_SIZE, meter, engine, filter=filt,
                resident=resident))
            out.append(((pac_key(p), meter.nbytes, meter.nrequests,
                         filt.prop_pages_read, filt.prop_pages_skipped),
                        ms))
        return out

    res["numeric"] = []
    for label, cond in conds.items():
        want = run("numpy", cond)[0][0]
        for resident in (True, False):
            runs = run(ENGINE, cond, resident)
            require(all(r[0] == want for r in runs),
                    f"numeric retrieval {label} resident={resident} "
                    f"differs from the numpy engine")
            require("joined" not in label or want[4] > 0,
                    f"numeric retrieval {label} skipped no property page")
            times = [r[1] for r in runs]
            res["numeric"].append({
                "filter": label, "resident": resident,
                "median_ms": statistics.median(times), "runs": times,
                "pages": len(want[0]), "io_bytes": want[1],
                "prop_pages_read": want[3], "prop_pages_skipped": want[4]})
            log(f"entries: batch {len(vs)} filtered by {label} "
                f"resident={resident}: equal to numpy (PAC {len(want[0])} "
                f"pages, io {want[1]} B / {want[2]} req, property pages "
                f"{want[3]} read / {want[4]} skipped), host ms "
                + ", ".join(f"{t:.3f}" for t in times))
    res["inputs"] = {"src_ids": src_ids, "window": window, "sub": sub,
                     "pac": pac, "rles": rles, "page_values": page_values}
    return res


def entry_kernel_phase(torch, adj, inputs):
    """Phase 11: kernels 11-14 against their plain versions on the card,
    bit for bit, at phase 10's shapes (the whole unsorted ``<dst>``
    column among them); timed against the plain version, the bound and,
    for ``bitmap_select``, ``torch.masked_select`` with the mask
    precomputed; each row's call time beside its device time queued
    behind the host, after the launch floor."""
    import numpy as np
    from repro_torch.kernels.bitmap_select import kernel as BK
    from repro_torch.kernels.bitmap_select import ops as BO
    from repro_torch.kernels.bitmap_select import ref as BR
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.pac_decode import ops
    from repro_torch.kernels.pac_decode import ref as PR
    from repro_torch.kernels.rle_filter import kernel as FK
    from repro_torch.kernels.rle_filter import ops as FO
    from repro_torch.kernels.rle_filter import ref as FR
    dev = torch.device(DEVICE)
    rows = []
    words_out = -(-N_VERTICES // 2048) * 64
    one, each = launch_floor_ms(torch, dev)
    log(f"kernels: launch floor: an empty kernel takes {one:.4f} ms from "
        f"launch to completion (median of 20), {each:.4f} ms each queued "
        f"back to back")

    def equal(k, r, what):
        require(torch.equal(k, r), f"{what} differs ({max_err(k, r)})")
        return max_err(k, r)

    # -- 11: bitmap over the sorted <src> ids, the PAC's ids and a window
    src_t = torch.from_numpy(inputs["src_ids"]).to(dev)
    n_src = src_t.shape[0]
    err = equal(PK.bitmap(src_t, n_src, 0, words_out),
                PR.bitmap(src_t, n_src, 0, words_out), "bitmap on <src>")
    pac_t = torch.from_numpy(inputs["pac"].to_ids().astype(np.int32)).to(dev)
    equal(PK.bitmap(pac_t, pac_t.shape[0], 0, words_out),
          PR.bitmap(pac_t, pac_t.shape[0], 0, words_out), "bitmap on the PAC")
    base, nw = inputs["window"]
    equal(PK.bitmap(src_t, n_src, base, nw),
          PR.bitmap(src_t, n_src, base, nw), "bitmap on a window")
    rows.append(kernel_row(
        "bitmap", "src/repro_torch/kernels/csrc/single_range.cu",
        "src/repro/kernels/pac_decode/kernel.py:180", err,
        cuda_ms(torch, lambda: PK.bitmap(src_t, n_src, 0, words_out), 20),
        cuda_ms(torch, lambda: PR.bitmap(src_t, n_src, 0, words_out), 2),
        4 * n_src + 4 * words_out))
    device = queued_ms(torch, lambda: PK.bitmap(src_t, n_src, 0, words_out),
                       50)
    log(f"kernels: bitmap equal over {n_src} <src> ids, "
        f"{pac_t.shape[0]} PAC ids and a window; {rows[-1]['ms']:.4f} ms a "
        f"call, {device:.4f} ms of device queued; bound "
        f"{rows[-1]['bound_ms']:.4f} ms")
    del src_t

    # -- 12: fused_decode_bitmap over the whole <dst> and <src> columns and
    #    a sub-range of <dst>
    lo, hi, sub_base, sub_nw = inputs["sub"]
    for name in ("<dst>", "<src>"):
        enc = adj.table[name].encoded
        args = ops.pack_pages(enc, 0, len(enc.pages))
        shipped = ops.ship_pages(args, dev)

        def fused(fn, shipped=shipped, base=0, nw=words_out):
            return fn(*shipped, base=base, page_size=PAGE_SIZE, words_out=nw)

        err12 = equal(fused(PK.fused_decode_bitmap),
                      fused(PR.fused_decode_bitmap),
                      f"fused_decode_bitmap on {name}")
        if name == "<dst>":
            part = ops.ship_pages(ops.pack_pages(
                enc, lo // PAGE_SIZE, hi // PAGE_SIZE), dev)
            equal(fused(PK.fused_decode_bitmap, part, sub_base, sub_nw),
                  fused(PR.fused_decode_bitmap, part, sub_base, sub_nw),
                  "fused_decode_bitmap on a sub-range")
        # the whole unsorted <dst> is row 12; the sorted <src>, whose ids
        # repeat in runs, its row @src
        n_pages, n_mini = args[1].shape
        rows.append(kernel_row(
            "fused_decode_bitmap" + ("" if name == "<dst>" else "@src"),
            "src/repro_torch/kernels/csrc/single_range.cu",
            "src/repro/kernels/pac_decode/kernel.py:570", err12,
            cuda_ms(torch, lambda: fused(PK.fused_decode_bitmap), 20),
            cuda_ms(torch, lambda: fused(PR.fused_decode_bitmap), 2),
            4 * (n_pages * (2 + 3 * n_mini) + int(args[2].sum()))
            + 4 * words_out))
        device = queued_ms(torch, lambda: fused(PK.fused_decode_bitmap), 50)
        log(f"kernels: {rows[-1]['name']} over {name}: {rows[-1]['ms']:.4f} "
            f"ms a call, {device:.4f} ms of device queued; bound "
            f"{rows[-1]['bound_ms']:.4f} ms")
        del shipped
    log(f"kernels: fused_decode_bitmap equal over the whole <dst> and <src> "
        f"columns ({len(adj.table['<dst>'].encoded.pages)} pages each) and "
        f"<dst> rows [{lo}, {hi})")

    # -- 13: rle_to_bitmap over every column of phase 10, timed on the
    #    scattered one (row 13) and on the clustered label L0 (row @label,
    #    the sparse lists of 16 of the entry's 18 launches)
    for name, rle in inputs["rles"].items():
        for want_value in (True, False):
            pos, meta, nw = FO.stage_rle(rle, want_value)
            pos_t = torch.from_numpy(pos).to(dev)
            meta_t = torch.from_numpy(meta).to(dev)
            err13 = equal(FK.rle_to_bitmap(pos_t, meta_t, nw),
                          FR.rle_to_bitmap(pos_t, meta_t, nw),
                          f"rle_to_bitmap on {name} == {want_value}")
    log(f"kernels: rle_to_bitmap equal on {len(inputs['rles'])} columns, "
        f"want True and False")
    for name, suffix in (("scattered", ""), ("L0", "@label")):
        pos, meta, nw = FO.stage_rle(inputs["rles"][name], False)
        pos_t = torch.from_numpy(pos).to(dev)
        meta_t = torch.from_numpy(meta).to(dev)
        n_pos = pos.shape[1]
        rows.append(kernel_row(
            "rle_to_bitmap" + suffix,
            "src/repro_torch/kernels/csrc/rle_filter.cu",
            "src/repro/kernels/rle_filter/kernel.py:47", err13,
            cuda_ms(torch, lambda: FK.rle_to_bitmap(pos_t, meta_t, nw), 20),
            cuda_ms(torch, lambda: FR.rle_to_bitmap(pos_t, meta_t, nw), 3),
            # a toggle per position, a word operation per lane
            4 * n_pos + 12 + 4 * nw, n_pos + 32 * nw))
        device = queued_ms(torch, lambda: FK.rle_to_bitmap(pos_t, meta_t, nw),
                           50)
        log(f"kernels: {rows[-1]['name']} on {name} ({n_pos} positions, "
            f"{nw} words): {rows[-1]['ms']:.4f} ms a call, {device:.4f} ms "
            f"of device queued; bound {rows[-1]['bound_ms']:.4f} ms")

    # -- 14: bitmap_select over the batch-16384 PAC's pages
    vals, words = BO.stage_pages(inputs["pac"], inputs["page_values"])
    n, ps = vals.shape
    vals_t = torch.from_numpy(vals).to(dev)
    words_t = torch.from_numpy(words.view(np.int32)).to(dev)
    k_out, k_cnt = BK.bitmap_select(vals_t, words_t, ps)
    r_out, r_cnt = BR.bitmap_select(vals_t, words_t, ps)
    err = max(equal(k_cnt, r_cnt, "bitmap_select counts"),
              equal(k_out.view(torch.int32), r_out.view(torch.int32),
                    "bitmap_select values"))
    lanes = torch.arange(ps, device=dev)
    mask = ((words_t.long()[:, lanes >> 5] >> (lanes & 31)) & 1).bool()
    row = kernel_row(
        "bitmap_select", "src/repro_torch/kernels/csrc/bitmap_select.cu",
        "src/repro/kernels/bitmap_select/kernel.py:44", err,
        cuda_ms(torch, lambda: BK.bitmap_select(vals_t, words_t, ps), 50),
        cuda_ms(torch, lambda: BR.bitmap_select(vals_t, words_t, ps), 5),
        # only the selected lanes' values need reading
        4 * int(k_cnt.sum()) + 4 * n * (ps // 32) + 4 * n * ps + 4 * n)
    row["library_ms"] = cuda_ms(
        torch, lambda: torch.masked_select(vals_t, mask), 50)
    rows.append(row)
    device = queued_ms(torch, lambda: BK.bitmap_select(vals_t, words_t, ps),
                       50)
    log(f"kernels: bitmap_select equal over {n} pages "
        f"({int(k_cnt.sum())} values): {row['ms']:.4f} ms a call, "
        f"{device:.4f} ms of device queued; bound {row['bound_ms']:.4f} ms; "
        f"library_ms {row['library_ms']:.4f} is torch.masked_select with "
        f"the mask precomputed")
    return rows



def lm_models(torch, cfg):
    """smollm-360m's bf16 weights from the port's ``init(seed=0)`` on the
    card, as four models: bf16 and float32, each on the flash route and
    on the plain one (the same weights, the float32 ones widened)."""
    from repro_torch.models import build_model
    f16 = build_model(cfg).init(0)
    state = f16.state_dict()
    models = {("bf16", True): f16}
    for dt, flash in (("bf16", False), ("f32", True), ("f32", False)):
        c = cfg.with_(use_flash=flash)
        if dt == "f32":
            c = c.with_(param_dtype="float32", compute_dtype="float32")
        m = build_model(c)
        m.load_state_dict({k: v.float() if dt == "f32" else v
                           for k, v in state.items()})
        models[(dt, flash)] = m
    return models


def prompts(np, n_words, length, vocab):
    """``HashTokenizer`` prompts of seeded text, cut or padded (``PAD``
    after the text) to ``length`` tokens: int32 [len(n_words), length]."""
    from repro_torch.data.tokenizer import PAD, HashTokenizer
    tok = HashTokenizer(vocab)
    rng = np.random.default_rng(3)
    out = np.full((len(n_words), length), PAD, np.int32)
    for i, n in enumerate(n_words):
        ids = tok.encode(" ".join(f"w{int(w)}" for w in
                                  rng.zipf(1.3, n) % 100_000))[:length]
        out[i, :ids.size] = ids
    return out


def greedy_requests(torch, model, tokens, cache, steps, ctx=None):
    """Prefill ``tokens`` (with the cross context ``ctx``, a dict of
    ``frames`` or ``vision``) into ``cache``, then ``steps`` greedy decode
    steps; returns the logits of the prefill and of every step (float32,
    [B, steps + 1, V]) and the fed tokens [B, steps]."""
    from repro_torch.serve.sampling import sample
    logits, cache = model.prefill({"tokens": tokens, **(ctx or {})}, cache)
    outs, fed = [logits[:, -1].float()], []
    for _ in range(steps):
        nxt = sample(logits[:, -1])[:, None].to(torch.int32)
        fed.append(nxt)
        logits, cache = model.decode_step(nxt, cache)
        outs.append(logits[:, -1].float())
    return torch.stack(outs, 1), torch.cat(fed, 1), cache


def decisive(torch, ref):
    """Positions whose top two reference logits lie more than ``TIE_ULPS``
    bf16 steps apart (a step at the largest |logit|): there a bf16 route
    must pick the reference's token; nearer, bf16 cannot tell the two
    apart.  Returns the mask and the margin used."""
    big = ref.abs().max().item()
    tie = TIE_ULPS * 2.0 ** (math.floor(math.log2(big)) - 7)
    top2 = ref.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1] > tie, tie


def agreement(torch, pick, top, mask):
    """(top-1 share over all positions, over the ``mask`` positions)."""
    same = pick == top
    return same.float().mean().item(), same[mask].float().mean().item()


def held_against_forward(torch, plain, tokens, fed, step_logits, start,
                         ctx=None):
    """Hold prefill/decode logits [B, steps + 1, V] against the plain
    route's full forward over prompt + fed tokens (positions ``start - 1``
    on, the cross context ``ctx``); returns the top-1 shares (all,
    decisive), the decisive count, max |d| and max |logit|."""
    full, _ = plain.forward({"tokens": torch.cat([tokens, fed], 1),
                             **(ctx or {})})
    ref = full[:, start - 1:start + fed.shape[1]].float()
    mask, _ = decisive(torch, ref)
    top1 = agreement(torch, step_logits.argmax(-1), ref.argmax(-1), mask)
    same = step_logits.argmax(-1) == ref.argmax(-1)
    return {"top1": top1[0], "top1_decisive": top1[1],
            "n": mask.numel(), "n_decisive": int(mask.sum()),
            "all_decisive": bool(same[mask].all()),
            "err": (ref - step_logits).abs().max().item(),
            "max": ref.abs().max().item()}


def lm_phase(torch, card):
    """Phase 12: smollm-360m at full width on the card (see the module
    docstring); returns its measurements."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.serve.steps import write_slots
    dev = torch.device(DEVICE)
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "float32 matmuls must not take TF32 in the LM phase")
    cfg = get_config(LM_ARCH, use_flash=True)
    require((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings,
             cfg.param_dtype) == (32, 960, 15, 5, 64, 2560, 49152, True,
                                  "bfloat16"), f"{LM_ARCH} config changed")
    t0 = time.perf_counter()
    models = lm_models(torch, cfg)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (LM_BATCH, LM_SEQ), np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (LM_BATCH, LM_SEQ), np.int32))
    batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}

    # (a)/(b): forwards over 4 x 2048 random tokens
    def forward(key):
        before = FK.flash_attention.launches
        logits, _ = models[key].forward(batch)
        ran = FK.flash_attention.launches - before
        require(ran == (cfg.num_layers if key[1] else 0),
                f"{key}: the flash kernel launched {ran} times in one "
                f"forward")
        return logits

    ref = forward(("f32", False))
    top = ref.argmax(-1)
    mask, tie = decisive(torch, ref)
    out.update(ref_max=ref.abs().max().item(), tie=tie,
               n_decisive=int(mask.sum()), n=mask.numel(),
               ceiling=agreement(torch, ref.bfloat16().argmax(-1), top,
                                 mask))
    for key in (("bf16", True), ("bf16", False), ("f32", True)):
        logits = forward(key).float()
        top1 = agreement(torch, logits.argmax(-1), top, mask)
        out[key] = {"err": (logits - ref).abs().max().item(),
                    "top1": top1[0], "top1_decisive": top1[1]}
        del logits
    del ref, top, mask
    flash, plain = out[("bf16", True)], out[("bf16", False)]
    log(f"12a. bf16 forward vs float32 plain ({out['n']} positions, "
        f"{out['n_decisive']} decisive: top two more than {tie:.4f} apart): "
        f"flash max|d| {flash['err']:.4f}, top-1 {flash['top1']:.5f} "
        f"(decisive {flash['top1_decisive']:.5f}); plain max|d| "
        f"{plain['err']:.4f}, top-1 {plain['top1']:.5f} (decisive "
        f"{plain['top1_decisive']:.5f}); float32 logits rounded to bf16: "
        f"top-1 {out['ceiling'][0]:.5f} (decisive {out['ceiling'][1]:.5f}); "
        f"max|logit| {out['ref_max']:.3f}")
    for name, r in (("flash", flash), ("plain", plain)):
        require(r["top1_decisive"] >= 0.99,
                f"bf16 {name} route: top-1 {r['top1_decisive']} < 0.99 on "
                f"decisive positions")
    require(flash["err"] <= 1.5 * plain["err"],
            f"bf16 flash max|d| {flash['err']} > 1.5x plain's "
            f"{plain['err']}")
    require(flash["top1"] >= plain["top1"] - 0.01,
            f"bf16 flash top-1 {flash['top1']} below plain's "
            f"{plain['top1']} - 0.01")
    f32 = out[("f32", True)]
    require(f32["err"] <= 1e-3 * out["ref_max"],
            f"float32 flash max|d| {f32['err']} > 1e-3 x max|logit|")
    losses = {flash: models[("f32", flash)].loss(batch)[0].item()
              for flash in (True, False)}
    out["loss"] = losses
    require(abs(losses[True] - losses[False]) <= 1e-4,
            f"float32 loss flash {losses[True]} vs plain {losses[False]}")
    log(f"12b. float32 flash vs plain: max|d| {f32['err']:.3e} "
        f"({f32['err'] / out['ref_max']:.3e} of max|logit|), top-1 "
        f"{f32['top1']:.5f}; loss flash {losses[True]:.6f} plain "
        f"{losses[False]:.6f}")

    # timing: host wall of one forward, median of 3
    for key in (("bf16", True), ("bf16", False)):
        out[f"forward_ms_{key[1]}"] = statistics.median(
            host_timed(torch, lambda: models[key].forward(batch))[1]
            for _ in range(REPS))

    # (c): 4 requests, prefill 512 into a bf16 cache of 1024, 32 greedy steps
    m16, p16 = models[("bf16", True)], models[("bf16", False)]
    prompt = torch.from_numpy(prompts(np, REQUEST_WORDS, PROMPT_LEN,
                                      cfg.vocab_size)).to(dev)
    n_req = prompt.shape[0]
    step_logits, fed, cache = greedy_requests(
        torch, m16, prompt, m16.init_cache(n_req, CACHE_LEN), DECODE_STEPS)
    require(int(cache["index"]) == PROMPT_LEN + DECODE_STEPS,
            f"cache index {int(cache['index'])}")
    held = held_against_forward(torch, p16, prompt, fed, step_logits,
                                PROMPT_LEN)
    out["requests"] = held
    log(f"12c. requests: prefill + {DECODE_STEPS} greedy steps vs the plain "
        f"forward, {held['n']} positions: top-1 equal {held['top1']:.5f} "
        f"(decisive {held['n_decisive']}: {held['top1_decisive']:.5f}), "
        f"max|d| {held['err']:.4f} (max|logit| {held['max']:.3f})")
    require(held["all_decisive"],
            "a request's top-1 differs from the full forward")

    def prefill_ms():
        cache = m16.init_cache(n_req, CACHE_LEN)
        return host_timed(torch, lambda: m16.prefill({"tokens": prompt},
                                                     cache))[1]

    def decode_ms():
        cache = m16.init_cache(n_req, CACHE_LEN)
        m16.prefill({"tokens": prompt}, cache)
        nxt = fed[:, :1]
        return host_timed(torch, lambda: [m16.decode_step(nxt, cache)
                                          for _ in range(DECODE_STEPS)]
                          )[1] / DECODE_STEPS

    out["prefill_ms"] = statistics.median(prefill_ms() for _ in range(REPS))
    out["decode_ms"] = statistics.median(decode_ms() for _ in range(REPS))

    # per-slot vector index: prompts of 128/256/384/512, each prefilled on
    # its own, written into one continuous batch, decoded together
    slot_prompts = prompts(np, (700,) * len(SLOT_PROMPTS),
                           max(SLOT_PROMPTS), cfg.vocab_size)
    vcache = m16.init_cache(len(SLOT_PROMPTS), CACHE_LEN, vector_index=True)
    first = []
    for slot, n in enumerate(SLOT_PROMPTS):
        p = torch.from_numpy(slot_prompts[slot:slot + 1, :n]).to(dev)
        logits, one = m16.prefill({"tokens": p},
                                  m16.init_cache(1, CACHE_LEN))
        write_slots(vcache, one, [slot])
        first.append(logits[:, -1].float())
    steps, fed_v = [torch.cat(first)], []
    for _ in range(DECODE_STEPS):
        nxt = steps[-1].argmax(-1)[:, None].to(torch.int32)
        fed_v.append(nxt)
        logits, vcache = m16.decode_step(nxt, vcache)
        steps.append(logits[:, -1].float())
    steps, fed_v = torch.stack(steps, 1), torch.cat(fed_v, 1)
    require(vcache["index"].tolist() ==
            [n + DECODE_STEPS for n in SLOT_PROMPTS],
            f"vector index {vcache['index'].tolist()}")
    slots = [held_against_forward(
        torch, p16, torch.from_numpy(slot_prompts[i:i + 1, :n]).to(dev),
        fed_v[i:i + 1], steps[i:i + 1], n)
        for i, n in enumerate(SLOT_PROMPTS)]
    out["slots"] = slots
    log("12c. vector index: " + "; ".join(
        f"prompt {n}: top-1 equal {h['top1']:.5f} (decisive "
        f"{h['n_decisive']}/{h['n']}: {h['top1_decisive']:.5f}), max|d| "
        f"{h['err']:.4f}" for n, h in zip(SLOT_PROMPTS, slots)))
    require(all(h["all_decisive"] for h in slots),
            "a slot's top-1 differs from the full forward")
    log(f"12. timing (host wall, median of {REPS}): forward "
        f"{LM_BATCH}x{LM_SEQ} {out['forward_ms_True']:.3f} ms flash, "
        f"{out['forward_ms_False']:.3f} ms plain; prefill "
        f"{n_req}x{PROMPT_LEN} {out['prefill_ms']:.3f} ms; decode "
        f"{out['decode_ms']:.3f} ms/step "
        f"({n_req * 1e3 / out['decode_ms']:.1f} tokens/s); model init "
        f"{out['init_s']:.1f} s")

    return out


def lm_profile_phase(torch, lm):
    """Where the LM's time goes: ``torch.profiler`` over one bf16 forward
    (flash route), prefill and decode step of a model built anew from
    ``init(seed=0)``.  Device busy ms by kernel; the idle share is taken
    against phase 12's unprofiled host wall, since the profiler slows the
    host (and every later host timing in the process), which is why this
    runs last."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    dev = torch.device(DEVICE)
    cfg = get_config(LM_ARCH, use_flash=True)
    m16 = build_model(cfg).init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ), np.int32)).to(dev)}
    prompt = torch.from_numpy(prompts(np, REQUEST_WORDS, PROMPT_LEN,
                                      cfg.vocab_size)).to(dev)
    n_req = prompt.shape[0]
    cache = m16.init_cache(n_req, CACHE_LEN)
    m16.prefill({"tokens": prompt}, cache)
    out = {}
    for what, wall_key, fn in (
            ("forward", "forward_ms_True", lambda: m16.forward(batch)),
            ("prefill", "prefill_ms", lambda: m16.prefill(
                {"tokens": prompt}, m16.init_cache(n_req, CACHE_LEN))),
            ("decode step", "decode_ms",
             lambda: m16.decode_step(prompt[:, :1], cache))):
        # the forward's busy ms read both ways: the raw trace, which every
        # profiled phase reads, and the parsed events
        events = [] if what == "forward" else None
        wall, busy = profile_ms(torch, fn, reps=2, events=events)
        total = sum(busy.values())
        out[what] = {"profiled_wall": wall, "busy": total,
                     "idle": 1 - total / lm[wall_key], "kernels": busy}
        top6 = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        both = "" if not events else \
            f" (prof.events() reads {events[0]:.3f} ms)"
        log(f"12p. profile, one bf16 {what}: device busy {total:.3f} ms{both} "
            f"of {lm[wall_key]:.3f} ms unprofiled host wall (idle share "
            f"{out[what]['idle']:.3f}; {wall:.3f} ms under the profiler); "
            + "; ".join(f"{n[:50]} {ms:.3f}" for n, ms in top6))
    return out


def serve_graph(lake):
    """A fresh GraphAr graph over the document lake's arrays: its decoded
    page LRU and device mirrors start empty."""
    import repro_torch.core as TC
    b = TC.GraphArBuilder("passages")
    b.add_vertices(
        TC.VertexTypeSchema("doc", [TC.PropertySchema("tokens", "tokens")],
                            labels=list(lake.labels), page_size=SERVE_PAGE),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(TC.EdgeTypeSchema("doc", "links", "doc",
                                  page_size=SERVE_PAGE),
                lake.links_src, lake.links_dst)
    return b.build()


def serve_graph_retriever(lake, engine):
    """A fresh graph and the phase's ``GraphRetriever`` over it on
    ``engine``, with its own IOMeter."""
    import repro_torch.core as TC
    from repro_torch.serve.retrieval import GraphRetriever
    g = serve_graph(lake)
    return g, GraphRetriever(
        g.adjacency("doc-links-doc", TC.BY_SRC),
        g.vertex("doc").table["tokens"], max_neighbors=2,
        tokens_per_neighbor=16, meter=TC.IOMeter(), engine=engine, hops=2,
        filter_vt=g.vertex("doc"),
        filter_cond=TC.L("HighQuality") & ~TC.L("Spam"))


def serve_retriever(lake, engine):
    return serve_graph_retriever(lake, engine)[1]


class Recorder:
    """A context_fn that forwards to a retriever and keeps each call's
    seed batch and contexts (check (b) replays them)."""

    def __init__(self, retr):
        self.retr, self.batches = retr, []

    def __call__(self, vs):
        out = self.retr(vs)
        self.batches.append((vs.copy(), [c.copy() for c in out]))
        return out

    def __getattr__(self, name):
        return getattr(self.retr, name)


def serve_requests(lake):
    """The phase's traffic over ``lake``'s documents: 32 seeded greedy
    requests (prompts of 24-256 of the seed document's tokens, 32 new
    tokens; 8 ``prod`` and 24 ``batch`` in a seeded order), each with its
    arrival tick, the gaps Poisson with mean ``SERVE_GAP`` ticks:
    ``[(tick, Request)]``, made anew for each engine."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(7)
    tenants = rng.permutation(["prod"] * SERVE_PROD
                              + ["batch"] * SERVE_BATCH)
    out, tick = [], 0
    for rid, tenant in enumerate(tenants):
        doc = int(rng.integers(0, lake.num_docs))
        n = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        out.append((tick, Request(
            rid, lake.tokens[doc][:n].astype(np.int32),
            max_new_tokens=SERVE_NEW_TOKENS, temperature=0.0,
            context_vertex=doc, tenant=str(tenant))))
        tick += int(rng.poisson(SERVE_GAP))
    return out


def serve_engine(model, context_fn, pipeline):
    """The phase's engine, with the two tenants of
    ``examples/serve_batched.py``."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.tenancy import TenantConfig
    return ServeEngine(model, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       eos_id=-1, context_fn=context_fn, pipeline=pipeline,
                       tenants=[TenantConfig("prod", weight=4, max_queue=16),
                                TenantConfig("batch", weight=1, rate=0.5,
                                             burst=4.0, max_queue=4,
                                             deadline_ticks=64)])


def serve_drain(torch, eng, arrivals, max_ticks=2000, ingests=()):
    """Drive ``eng`` through ``arrivals``: each request submitted at its
    tick, each of ``ingests`` (``(tick, src, dst)``) forwarded by
    ``eng.ingest`` at its tick, one ``step`` a tick, until all have
    arrived and the engine has drained
    (``run_until_drained(max_ticks=0)`` raises if work is left).
    Returns the shed outcomes, the host wall ms of the whole drain and,
    for each tick that decoded, the engine's ``last_tick`` split with the
    tick's host wall ms and the tokens it made."""
    reqs = [r for _, r in arrivals]
    shed, ticks, made, i, j = [], [], 0, 0, 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for tick in range(max_ticks):
        while i < len(arrivals) and arrivals[i][0] <= tick:
            out = eng.submit(arrivals[i][1])
            if not out.admitted:
                shed.append((arrivals[i][1].request_id, out.reason.value,
                             out.retry_after))
            i += 1
        while j < len(ingests) and ingests[j][0] <= tick:
            eng.ingest(*ingests[j][1:])
            j += 1
        steps = eng.steps
        t0 = time.perf_counter()
        active = eng.step()
        ms = (time.perf_counter() - t0) * 1e3
        if eng.steps > steps:
            now = sum(len(r.output) for r in reqs)
            ticks.append(dict(eng.last_tick, wall_ms=ms, tokens=now - made))
            made = now
        if i == len(arrivals) and j == len(ingests) and not active \
                and not eng.stats()["queued"]:
            break
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_start) * 1e3
    eng.run_until_drained(max_ticks=0)
    return {"shed": shed, "ticks": ticks, "wall_ms": wall,
            "tokens": made}


def drain_rates(d):
    """A drain's tokens per second over its wall; its first (cold) decode
    tick; over the warm decode ticks after it, tokens per second and the
    median tick ms."""
    warm = d["ticks"][1:]
    return (d["tokens"] * 1e3 / d["wall_ms"], d["ticks"][0],
            sum(t["tokens"] for t in warm) * 1e3
            / sum(t["wall_ms"] for t in warm),
            statistics.median(t["wall_ms"] for t in warm))


def sync_count(torch, fn) -> int:
    """Host syncs ``fn`` makes on the card, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own notice, that it is a prototype, is not a sync)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in seen)


def request_key(r):
    return (r.request_id, r.status.value, list(r.output),
            r.context_tokens, r.prompt.tolist())


def serve_model_lake(torch):
    """Phase 14's model (smollm-360m at full width, ``init(0)``, on the
    card) and document lake, with the seconds each took."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import document_graph
    from repro_torch.models import build_model
    cfg = get_config(LM_ARCH, use_flash=True)
    require((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.vocab_size, cfg.param_dtype) ==
            (32, 960, 15, 5, 49152, "bfloat16"), f"{LM_ARCH} config changed")
    t0 = time.perf_counter()
    model = build_model(cfg).init(0)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    lake = document_graph(num_docs=SERVE_DOCS, vocab=cfg.vocab_size,
                          mean_len=SERVE_MEAN_LEN, seed=2)
    return model, lake, t_model, time.perf_counter() - t0


def serve_warmup(torch, model, lake) -> float:
    """Warm the process (the first GEMMs and kernel loads) on a throwaway
    engine, so that no measured drain is the process's first; returns
    its host ms."""
    t0 = time.perf_counter()
    warm = serve_engine(model, serve_retriever(lake, ENGINE), True)
    for tick, req in serve_requests(lake)[:SERVE_SLOTS]:
        req.max_new_tokens = 2
        warm.submit(req)
    warm.run_until_drained()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def solo_decode(torch, model, reqs, max_len):
    """Re-run each finished request alone (prefill and ``decode_step`` at
    batch 1, fed the engine's tokens): returns the steps whose top-1 equals
    the engine's token among those before each request's first step that
    is not decisive, the count of those steps, and all steps."""
    agree = decisive_n = steps = 0
    dev = model.device
    for req in reqs:
        cache = model.init_cache(1, max_len, dtype=torch.float32)
        logits, cache = model.prefill(
            {"tokens": torch.from_numpy(req.prompt[None]).to(dev)}, cache)
        solo = [logits[0, -1].float()]
        for tok in req.output[:-1]:
            logits, cache = model.decode_step(
                torch.tensor([[tok]], dtype=torch.int32, device=dev), cache)
            solo.append(logits[0, -1].float())
        solo = torch.stack(solo)
        mask, _ = decisive(torch, solo)
        first = int((~mask).nonzero()[0]) if (~mask).any() else len(mask)
        same = solo.argmax(-1).cpu() == torch.tensor(req.output)
        agree += int(same[:first].sum())
        decisive_n += first
        steps += len(req.output)
    return agree, decisive_n, steps


def serve_phase(torch, card, drive):
    """Phase 14: the serving path at full width on the card (see the
    module docstring); returns its measurements, with the launch counts
    of the first pipelined drain (``drive`` sets them to 0 just before
    it and reads them just after)."""
    import numpy as np
    model, lake, t_model, t_lake = serve_model_lake(torch)
    t0 = time.perf_counter()
    retr_p = serve_retriever(lake, ENGINE)
    t_graph = time.perf_counter() - t0
    n_tokens = sum(len(t) for t in lake.tokens)
    arrivals = serve_requests(lake)
    log(f"14. set-up: {LM_ARCH} init {t_model:.1f} s; document lake "
        f"{lake.num_docs:,} docs, {n_tokens:,} tokens, "
        f"{len(lake.links_src):,} links in {t_lake:.1f} s; graph build "
        f"{t_graph:.1f} s (page size {SERVE_PAGE}); {len(arrivals)} "
        f"requests arriving over ticks 0-{arrivals[-1][0]}")

    log(f"14. warm-up: {SERVE_SLOTS} requests of 2 tokens on a throwaway "
        f"engine in {serve_warmup(torch, model, lake):.1f} ms")

    # the drains, pipelined and sequential in the order P S S P, each
    # engine over a fresh lake; the launch counts are the first's
    eng_p = serve_engine(model, retr_p, True)
    p1, launches = drive(serve_drain, torch, eng_p, serve_requests(lake))
    retr_s = Recorder(serve_retriever(lake, ENGINE))
    eng_s = serve_engine(model, retr_s, False)
    s1 = serve_drain(torch, eng_s, serve_requests(lake))
    repeats = []
    for pipeline in (False, True):
        eng = serve_engine(model, serve_retriever(lake, ENGINE), pipeline)
        repeats.append((serve_drain(torch, eng, serve_requests(lake)),
                        [request_key(r) for r in eng.finished]))
        del eng
    (s2, keys_s2), (p2, keys_p2) = repeats
    fin_p, fin_s = eng_p.finished, eng_s.finished
    ok = [r for r in fin_p if r.status.value == "ok"]
    keys = [request_key(r) for r in fin_p]
    # (a) pipelined against sequential, bit for bit
    require(keys == [request_key(r) for r in fin_s],
            "(a) the pipelined engine's requests differ from the "
            "sequential engine's")
    require(p1["shed"] == s1["shed"], "(a) the shed outcomes differ")
    require(keys_s2 == keys == keys_p2 and s2["shed"] == p2["shed"]
            == p1["shed"], "(a) a repeated drain differs from the first")
    mp, ms_ = retr_p.meter, retr_s.meter
    require((mp.nbytes, mp.nrequests) == (ms_.nbytes, ms_.nrequests),
            f"(a) IOMeter {mp.nbytes}/{mp.nrequests} pipelined vs "
            f"{ms_.nbytes}/{ms_.nrequests} sequential")
    require((retr_p.calls, retr_p.vertices_seen) ==
            (retr_s.calls, retr_s.vertices_seen),
            "(a) the retrievers' calls or vertices differ")
    cp, cs = retr_p.page_cache, retr_s.page_cache
    require((cp.hits, cp.misses) == (cs.hits, cs.misses),
            f"(a) LRU {cp.hits}/{cp.misses} vs {cs.hits}/{cs.misses}")
    pipe = eng_p.stats()["pipeline"]
    log(f"14a. pipelined == sequential: {len(fin_p)} requests (ids, status, "
        f"tokens, contexts), {len(p1['shed'])} shed, IOMeter {mp.nbytes} B "
        f"/ {mp.nrequests} requests, {retr_p.calls} retrievals of "
        f"{retr_p.vertices_seen} seeds, LRU {cp.hits} hits / {cp.misses} "
        f"misses; the repeated drains equal; prefetch issued "
        f"{pipe['prefetch_issued']}, hits {pipe['prefetch_hits']}, "
        f"mis-speculations {pipe['mis_speculations']}")
    require(pipe["prefetch_hits"] > 0, "(a) no prefetch was consumed")
    out = {"served": len(fin_p), "ok": len(ok), "shed": len(p1["shed"]),
           "pipeline": pipe, "launches": launches}

    # (b) the card's retrieval against numpy, on the recorded batches
    retr_n = serve_retriever(lake, "numpy")
    n_ctx = 0
    for vs, contexts in retr_s.batches:
        for got, want in zip(contexts, retr_n(vs)):
            require(np.array_equal(got, want),
                    "(b) a context differs from the numpy engine's")
            n_ctx += 1
    mn = retr_n.meter
    require((mn.nbytes, mn.nrequests) == (ms_.nbytes, ms_.nrequests),
            f"(b) IOMeter {ms_.nbytes}/{ms_.nrequests} cuda vs "
            f"{mn.nbytes}/{mn.nrequests} numpy")
    require(retr_n.page_cache.stats() == cs.stats(),
            "(b) the LRU counters differ from the numpy engine's")
    log(f"14b. cuda retrieval == numpy on {len(retr_s.batches)} recorded "
        f"batches: {n_ctx} contexts, IOMeter, LRU counters")

    # (c) batched decode against solo decode at batch 1
    agree, decisive_n, steps = solo_decode(
        torch, model, sorted(ok, key=lambda r: -r.context_tokens)[:SERVE_SOLO],
        SERVE_MAX_LEN)
    share = agree / decisive_n if decisive_n else 0.0
    log(f"14c. batched == solo decode: {SERVE_SOLO} requests, {steps} "
        f"steps, {decisive_n} decisive before the first that is not; "
        f"share equal {share:.5f}")
    require(decisive_n > 0 and share == 1.0,
            "(c) a decisive step of batched decode differs from solo")
    out["solo_share"] = share

    # where a tick's time goes (unprofiled host wall): each drain in run
    # order, then the split over the two pipelined drains' warm ticks
    drains = {"P1": p1, "S1": s1, "S2": s2, "P2": p2}
    out["drains"] = {}
    for name, d in drains.items():
        rate, first, warm_rate, warm_tick = drain_rates(d)
        out["drains"][name] = (d["wall_ms"], rate, first["wall_ms"],
                               warm_rate, warm_tick)
        log(f"14. drain {name}: {len(d['ticks'])} decode ticks, "
            f"{d['tokens']} tokens in {d['wall_ms']:.1f} ms, {rate:.1f} "
            f"tokens/s; first decode tick {first['wall_ms']:.1f} ms "
            f"(admit {first['admit_ms']:.1f}, of which retrieval "
            f"{first['retrieval_ms']:.1f}); warm ticks {warm_rate:.1f} "
            f"tokens/s, median {warm_tick:.3f} ms")
    warm = p1["ticks"][1:] + p2["ticks"][1:]
    split = {}
    for part in SERVE_PARTS:
        vals = [t[part] for t in warm]
        split[part] = (statistics.median(vals), min(vals), max(vals))
    out["split"] = split
    log(f"14. served {out['served']} ({out['ok']} ok), shed {out['shed']}; "
        f"tick split over the {len(warm)} warm decode ticks of P1 and P2 "
        f"(ms, median [min, max] total): " + "; ".join(
            f"{p[:-3]} {m:.3f} [{lo:.3f}, {hi:.3f}] "
            f"{sum(t[p] for t in warm):.1f}"
            for p, (m, lo, hi) in split.items()))
    log("14. P1's admitting ticks (decode tick: admit ms, of which "
        "retrieval ms): " + "; ".join(
            f"{i + 1}: {t['admit_ms']:.1f}, {t['retrieval_ms']:.1f}"
            for i, t in enumerate(p1["ticks"]) if t["admit_ms"] > 1.0))
    log(f"14. prefetch: issued {pipe['prefetch_issued']}, hits "
        f"{pipe['prefetch_hits']}, mis-speculations "
        f"{pipe['mis_speculations']}, pipeline_overlap_ms "
        f"{eng_p.pipeline_overlap_ms:.3f}")

    # host syncs: a decode step, with the engine's staged tokens and with
    # numpy tokens, and one retrieval call (the prefetch's work)
    tokens = np.full((SERVE_SLOTS, 1), 5, np.int32)
    cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN,
                             dtype=torch.float32, vector_index=True)
    staged = sync_count(torch, lambda: model.decode_step(
        eng_p._device_tokens(tokens), cache))
    plain = sync_count(torch, lambda: model.decode_step(tokens, cache))
    vs = np.asarray([r.context_vertex for r in ok[:SERVE_SLOTS]], np.int64)
    retrieval = sync_count(torch, lambda: retr_p(vs))
    out["syncs"] = {"decode_step": staged, "decode_step_numpy": plain,
                    "retrieval": retrieval}
    log(f"14. host syncs: decode_step {staged} a step (tokens staged "
        f"through pinned memory), {plain} with numpy tokens; one retrieval "
        f"of {vs.size} seeds {retrieval} (the prefetch overlaps decode "
        f"until its first); sampling 1 a tick; on {card}")
    out["median_tick_ms"] = split["tick_ms"][0]
    del eng_p, eng_s, retr_n, cache
    torch.cuda.empty_cache()
    out.update(model=model, lake=lake)
    return out


def serve_profile_phase(torch, serve):
    """``torch.profiler`` over ``SERVE_PROFILE_TICKS`` ticks of the
    pipelined engine, on a fresh lake with every request submitted at
    once, after 3 warm ticks: device busy ms a tick by kernel, idle share
    against phase 14's unprofiled median warm tick."""
    eng = serve_engine(serve["model"], serve_retriever(serve["lake"], ENGINE),
                       True)
    for _, req in serve_requests(serve["lake"]):
        eng.submit(req)
    for _ in range(2):
        eng.step()
    wall, busy = profile_ms(torch, eng.step, reps=SERVE_PROFILE_TICKS)
    require(eng.stats()["active"] > 0, "the profiled ticks ran out of work")
    total = sum(busy.values())
    tick = serve["median_tick_ms"]
    top6 = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    log(f"14p. profile, {SERVE_PROFILE_TICKS} ticks of the pipelined "
        f"engine: device busy {total:.3f} ms a tick of {tick:.3f} ms "
        f"median unprofiled tick (idle share {1 - total / tick:.3f}; "
        f"{wall:.3f} ms a tick under the profiler); "
        + "; ".join(f"{n[:50]} {ms:.3f}" for n, ms in top6))
    return {"busy": total, "idle": 1 - total / tick, "profiled_wall": wall}


def flash_kernel_phase(torch):
    """Phase 13: the flash kernel against ``attention_ref`` on the card,
    at the forward's shape [60, 2048, 64] and at one block, d 32/128/256;
    timed at the forward's shape, bf16 causal, beside the plain version,
    ``scaled_dot_product_attention`` and the bound."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    bh = LM_BATCH * LM_HEADS
    shapes = [(bh, LM_SEQ, 64), (8, 64, 64), (4, 384, 128), (8, 256, 32),
              (4, 256, 256)]
    errs = {}
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            for causal in (True, False):
                got = FK.flash_attention(q, k, v, causal)
                want = FR.attention_ref(q, k, v, causal)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = 1e-4 if dtype == torch.float32 else 0.1
                require(err <= tol, f"flash_attention {shape} {dtype} "
                        f"causal={causal}: max|d| {err} > {tol}")
                errs[(shape, str(dtype)[6:], causal)] = err
    log("13. flash kernel vs attention_ref: " + "; ".join(
        f"{s[0]}x{s[1]}x{s[2]} {dt} {'causal' if c else 'full'} {e:.2e}"
        for (s, dt, c), e in errs.items()))
    q, k, v = (torch.randn((bh, LM_SEQ, 64), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    err = errs[((bh, LM_SEQ, 64), "bfloat16", True)]
    flops = 4 * bh * LM_SEQ * LM_SEQ * 64 / 2
    row = kernel_row(
        "flash_attention", FLASH_SOURCE, FLASH_REPLACES, err,
        cuda_ms(torch, lambda: FK.flash_attention(q, k, v, True), 10),
        cuda_ms(torch, lambda: FR.attention_ref(q, k, v, True), 3),
        4 * q.numel() * q.element_size(), flops, BF16_FLOPS_PER_S)
    q4, k4, v4 = (x.view(LM_BATCH, LM_HEADS, LM_SEQ, 64)
                  for x in (q, k, v))
    row["library_ms"] = cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 10)
    log(f"13. flash_attention [{bh}, {LM_SEQ}, 64] bf16 causal: kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return [row, flash_mha_call(torch, gen, "flash_attention@gqa", LM_HEADS,
                                5, 64)] + flash_offset_rows(torch, gen)


def flash_offset_rows(torch, gen):
    """Row 15o: kernel 15 as the two ranks of a sequence-parallel
    ``model`` 2 call it at smollm-360m's forward shape: 1024 query rows of
    [4, 15, 2048, 64] starting at ``q_start`` 0 (rank 0) and 1024 (rank
    1) over the whole [4, 5, 2048, 64] K/V, strided views, bf16 causal.
    Each held against its plain version (0.1, and elementwise 2^-8 (|want|
    + max|v|)) and bit for bit against those rows of the whole sequence's
    call (``q_start`` a multiple of both kernels' query blocks: the same
    tiles in the same order); timed beside its plain version, its bound
    (4 b h d over the (row, key) pairs it computes, at 989 TFLOP/s) and
    ``scaled_dot_product_attention`` under ``causal_lower_right`` over
    the keys cut to ``q_start + s_q``."""
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels.flash_attention import ops as FO
    dev = torch.device(DEVICE)
    h, h_kv, d, s_q = LM_HEADS, 5, 64, LM_SEQ // 2
    q, k, v = (torch.randn((LM_BATCH, LM_SEQ, n, d), generator=gen,
                           device=dev).bfloat16().transpose(1, 2)
               for n in (h, h_kv, h_kv))
    whole = FO.mha(q, k, v, True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for q_start in (0, s_q):
        qr = q[:, :, q_start:q_start + s_q]
        got = FO.mha(qr, k, v, True, q_start=q_start)
        want = FO.mha(qr, k, v, True, use_kernel=False, q_start=q_start)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        within = bool((diff <= 2.0 ** -8 * (want.float().abs()
                                            + v.float().abs().max())).all())
        name = f"flash_attention@q_start{q_start}"
        require(err <= 0.1 and within,
                f"{name}: max|d| {err}, elementwise bound {within}")
        require(torch.equal(got, whole[:, :, q_start:q_start + s_q]),
                f"{name} is not bit for bit the whole call's rows")
        kc, vc = (x[:, :, :q_start + s_q] for x in (k, v))
        mask = causal_lower_right(s_q, q_start + s_q)
        how, lib_fn = "enable_gqa=True", lambda: sdpa(
            qr, kc, vc, attn_mask=mask, enable_gqa=True)
        try:                    # the yardstick only
            lib_fn()
        except (TypeError, RuntimeError):
            how = "KV heads repeated"
            kr, vr = (x.repeat_interleave(h // h_kv, 1) for x in (kc, vc))
            lib_fn = lambda: sdpa(qr, kr, vr, attn_mask=mask)
        pairs = s_q * q_start + s_q * (s_q + 1) // 2
        row = kernel_row(
            name, FLASH_SOURCE, FLASH_REPLACES, err,
            cuda_ms(torch, lambda: FO.mha(qr, k, v, True, q_start=q_start),
                    10),
            cuda_ms(torch, lambda: FO.mha(qr, k, v, True, use_kernel=False,
                                          q_start=q_start), 3),
            2 * (2 * qr.numel() + kc.numel() + vc.numel()),
            4 * LM_BATCH * h * d * pairs, BF16_FLOPS_PER_S)
        row["library_ms"] = cuda_ms(torch, lib_fn, 10)
        log(f"{name}: mha of rows {q_start}..{q_start + s_q} of [{LM_BATCH}, "
            f"{h}, {LM_SEQ}, {d}] over {h_kv} KV heads, bf16 causal: max|d| "
            f"{err:.3e} (elementwise bound held), bit for bit the whole "
            f"call's rows; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"(causal_lower_right, {how}) {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms over {pairs:,} (row, key) "
            f"pairs a head")
        rows.append(row)
    return rows


def flash_mha_call(torch, gen, name, h, h_kv, d):
    """A forward's own call of kernel 15: ``ops.mha`` on [4, h, 2048, d]
    queries over ``h_kv`` KV heads, each a [b, h, s, d] view of a [b, s,
    h, d] tensor, bf16 causal; held against the plain version and timed
    beside it and ``scaled_dot_product_attention`` (with GQA when
    ``h_kv < h``).  Returns its row of the kernel table, ``name``:
    ``flash_attention@gqa`` is smollm-360m's call (15 heads over 5, d 64),
    ``flash_attention@d128`` deepseek-moe-16b's (16 heads, MHA, d 128) and
    ``flash_attention@d128gqa`` llama-3.2-vision-11b's (32 over 8, d
    128)."""
    from repro_torch.kernels.flash_attention import ops as FO
    dev = torch.device(DEVICE)
    q, k, v = (torch.randn((LM_BATCH, LM_SEQ, n, d), generator=gen,
                           device=dev).bfloat16().transpose(1, 2)
               for n in (h, h_kv, h_kv))
    got = FO.mha(q, k, v, True)
    want = FO.mha(q, k, v, True, use_kernel=False)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    within = bool((diff <= 2.0 ** -8 * (want.float().abs()
                                        + v.float().abs().max())).all())
    require(err <= 0.1 and within,
            f"{name} strided: max|d| {err}, elementwise bound {within}")
    require(got.transpose(1, 2).is_contiguous(),
            "mha's output is not a view of a [b, s, h, d] tensor")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    how, lib_fn = "MHA", lambda: sdpa(q, k, v, is_causal=True)
    if h_kv < h:
        how = "enable_gqa=True"
        lib_fn = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        try:                    # the yardstick only: torch < 2.5 lacks it
            lib_fn()
        except TypeError:
            how = "KV heads repeated"
            kr, vr = (x.repeat_interleave(h // h_kv, 1) for x in (k, v))
            lib_fn = lambda: sdpa(q, kr, vr, is_causal=True)
    row = kernel_row(
        name, FLASH_SOURCE, FLASH_REPLACES, err,
        cuda_ms(torch, lambda: FO.mha(q, k, v, True), 10),
        cuda_ms(torch, lambda: FO.mha(q, k, v, True, use_kernel=False), 3),
        2 * (2 * q.numel() + k.numel() + v.numel()),   # q, out, k, v
        4 * LM_BATCH * h * LM_SEQ * LM_SEQ * d / 2, BF16_FLOPS_PER_S)
    row["library_ms"] = cuda_ms(torch, lib_fn, 10)
    log(f"{name}: mha [{LM_BATCH}, {h}, {LM_SEQ}, {d}] over {h_kv} KV "
        f"heads, strided views, bf16 causal: max|d| {err:.3e} (elementwise "
        f"bound held); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention ({how}) {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms")
    return row


# --------------------------------------------------------------------------
# phase 18: the rest of the LM stack at full width
# --------------------------------------------------------------------------

def open_gates(model):
    """Every cross sub-layer's ``x_gate`` to ``X_GATE``: at its initial 0,
    tanh(0) = 0 and the cross sub-layer (and whisper's whole encoder) adds
    nothing to the logits."""
    for name, p in model.named_parameters():
        if name.endswith("x_gate"):
            p.data.fill_(X_GATE)
    return model


def family_model(torch, cfg, f32):
    """``cfg``'s model on the card from ``init(seed=0)``, its gates open:
    bf16, or (``f32``) the same weights widened to float32 (a float32
    ``init`` draws the bf16 one's numbers unrounded; each is rounded to
    bf16 and widened back)."""
    from repro_torch.models import build_model
    if f32:
        cfg = cfg.with_(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg).init(0)
    if f32:
        for p in model.parameters():
            p.data.copy_(p.data.bfloat16().float())
    return open_gates(model)


def set_flash(model, on):
    """Send the model's self-attention through kernel 15 (``on``) or the
    plain route: the same weights, the config's ``use_flash``."""
    model.cfg = model.cfg.with_(use_flash=on)


def family_batch(torch, cfg, seq):
    """Seeded tokens [4, seq] and, for the cross-attention families, the
    context: whisper's 1,500 frames or llama-vision's 1,600 vision
    embeddings [4, n, d_model] (float32, cast to the compute type by the
    model)."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, seq), np.int32)).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(1)
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(
            (LM_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
            device=dev)
    if cfg.num_vision_tokens:
        batch["vision"] = torch.randn(
            (LM_BATCH, cfg.num_vision_tokens, cfg.d_model), generator=gen,
            device=dev)
    return batch


def family_forward(torch, model, batch):
    """One forward; requires finite logits of the batch's shape and one
    launch of kernel 15 a self-attention layer on the flash route (none
    on the plain one)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    cfg = model.cfg
    before = FK.flash_attention.launches
    logits, aux = model.forward(batch)
    ran = FK.flash_attention.launches - before
    want = cfg.num_layers + cfg.encoder_layers if cfg.use_flash else 0
    require(ran == want, f"{cfg.name}: kernel 15 launched {ran} times in "
            f"one forward, not {want}")
    require(tuple(logits.shape) == tuple(batch["tokens"].shape)
            + (cfg.vocab_size,) and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(aux)), f"{cfg.name}: bad logits")
    return logits


def family_forwards(torch, cfg, batch, out):
    """(a): the float32 copy's plain route is the reference (each model is
    built alone, so deepseek's 61 GiB fit); then the bf16 model on each of
    its routes, top-1 held on the reference's
    decisive positions.  The MoE model routes each token to its top 6 of
    64 experts under a capacity: bf16 rounding moves tokens across that
    boundary, and every move shifts the slots behind it, so its bf16
    routes cannot reach the dense models' 0.99 whatever the attention
    does.  There kernel 15 is held at 0.99 in float32 (flash against plain
    on the float32 copy), and its bf16 route no more than 0.01 below the
    bf16 plain route's.  Returns the bf16 model."""
    name = f"{cfg.name} ({cfg.num_layers} layers)"
    m32 = family_model(torch, cfg, True)
    moe = cfg.moe is not None
    logits = family_forward(torch, m32, batch)
    mask, tie = decisive(torch, logits)
    top, big = logits.argmax(-1), logits.abs().max().item()
    del logits
    out["n_decisive"], out["n"] = int(mask.sum()), mask.numel()
    if moe:
        set_flash(m32, True)
        out["top1_f32_flash"] = agreement(
            torch, family_forward(torch, m32, batch).argmax(-1), top, mask)
        require(out["top1_f32_flash"][1] >= 0.99,
                f"{name}: float32 flash route top-1 "
                f"{out['top1_f32_flash'][1]} < 0.99 on decisive positions")
    del m32
    torch.cuda.empty_cache()
    m16 = family_model(torch, cfg, False)
    routes = (True, False) if cfg.name in FAMILY_FLASH else (False,)
    for flash in routes:
        set_flash(m16, flash)
        pick = family_forward(torch, m16, batch).argmax(-1)
        out[f"top1_{'flash' if flash else 'plain'}"] = agreement(
            torch, pick, top, mask)
        del pick
    for route in ("flash", "plain"):
        share = out.get(f"top1_{route}")
        if share is None:
            continue
        if not moe:
            require(share[1] >= 0.99, f"{name}: bf16 {route} route top-1 "
                    f"{share[1]} < 0.99 on decisive positions")
        elif route == "flash":
            require(share[1] >= out["top1_plain"][1] - 0.01,
                    f"{name}: bf16 flash route top-1 {share[1]} more than "
                    f"0.01 below the plain route's {out['top1_plain'][1]}")
    log(f"18a. {name}: " + ", ".join(
        f"{k[5:].replace('_', ' ')} route top-1 {v[0]:.5f} (decisive "
        f"{v[1]:.5f})" for k, v in out.items() if k.startswith("top1_"))
        + f" (bf16 unless named) against the float32 plain route over "
        f"{out['n']} positions ({out['n_decisive']} decisive: top two more "
        f"than {tie:.4f} apart; max|logit| {big:.3f}); held")
    set_flash(m16, routes[0])
    return m16


def family_decode(torch, model, batch, out):
    """(b): a prefill of 4 x 512 seeded tokens (and the batch's context)
    and 16 greedy decode steps; except for MoE, the top-1 of every step
    held against the plain full forward's over the same tokens on its
    decisive steps."""
    import numpy as np
    cfg = model.cfg
    name = f"{cfg.name} ({cfg.num_layers} layers)"
    ctx = {k: v for k, v in batch.items() if k in ("frames", "vision")}
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (LM_BATCH, FAMILY_PROMPT), np.int32)).to(
            model.device)
    step_logits, fed, c = greedy_requests(
        torch, model, prompt, family_cache(model, batch), FAMILY_STEPS, ctx)
    require(int(c["index"]) == FAMILY_PROMPT + FAMILY_STEPS
            and bool(torch.isfinite(step_logits).all()),
            f"{name}: prefill/decode index {int(c['index'])} or non-finite")
    if cfg.moe is None:
        flash = cfg.use_flash
        set_flash(model, False)     # 544 tokens: no multiple of 128
        held = held_against_forward(torch, model, prompt, fed, step_logits,
                                    FAMILY_PROMPT, ctx)
        set_flash(model, flash)
        out["requests"] = held
        log(f"18b. {name}: prefill {LM_BATCH}x{FAMILY_PROMPT} + "
            f"{FAMILY_STEPS} greedy steps vs the plain forward, "
            f"{held['n']} positions: top-1 equal {held['top1']:.5f} "
            f"(decisive {held['n_decisive']}: {held['top1_decisive']:.5f}), "
            f"max|d| {held['err']:.4f} (max|logit| {held['max']:.3f}); "
            f"held")
        require(held["all_decisive"],
                f"{name}: a decisive decode step differs from the forward")
    else:
        log(f"18b. {name}: prefill {LM_BATCH}x{FAMILY_PROMPT} + "
            f"{FAMILY_STEPS} greedy steps, finite (MoE capacity depends on "
            f"the batch shape: not held against the forward)")
    return prompt, fed


def family_cache(model, batch):
    """A bf16 cache for the 4 prompts of (b) and their decode steps, with
    room for the batch's context."""
    ctx = [v for k, v in batch.items() if k in ("frames", "vision")]
    return model.init_cache(LM_BATCH, FAMILY_PROMPT + FAMILY_STEPS,
                            ctx_len=ctx[0].shape[1] if ctx else 0)


def family_timing(torch, model, batch, prompt, fed, out):
    """Host ms, median of ``REPS``: the forward (on the model's route), a
    prefill of 4 x 512 into a fresh cache, and a decode step (over
    ``FAMILY_TIMED_STEPS`` steps)."""
    ctx = {k: v for k, v in batch.items() if k in ("frames", "vision")}

    def prefill_ms():
        c = family_cache(model, batch)
        return host_timed(torch, lambda: model.prefill(
            {"tokens": prompt, **ctx}, c))[1]

    def decode_ms():
        c = family_cache(model, batch)
        model.prefill({"tokens": prompt, **ctx}, c)
        nxt = fed[:, :1]
        return host_timed(torch, lambda: [
            model.decode_step(nxt, c) for _ in range(FAMILY_TIMED_STEPS)]
        )[1] / FAMILY_TIMED_STEPS

    out["forward_ms"] = statistics.median(
        host_timed(torch, lambda: model.forward(batch))[1]
        for _ in range(REPS))
    out["prefill_ms"] = statistics.median(prefill_ms() for _ in range(REPS))
    out["decode_ms"] = statistics.median(decode_ms() for _ in range(REPS))


def moe_layer_check(torch, moe, cfg, out):
    """(c): one deepseek MoE layer at T = 8192 (E = 64, k = 6, capacity
    960) through ``moe_apply`` and the plain per-expert loop ``moe_ref``:
    keep masks identical, outputs within 2^-6 of the largest |output|
    (bf16, the products batched differently); each timed."""
    from repro_torch.models.moe import capacity_of, moe_apply, moe_ref, route
    m = cfg.moe
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    # a direction shared by every token skews the router, so that the
    # favoured experts overflow their capacity and assignments drop
    x = (torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), generator=gen,
                     device=dev)
         + 0.5 * torch.randn((cfg.d_model,), generator=gen, device=dev)
         ).bfloat16()
    kw = dict(num_experts=m.num_experts, top_k=m.top_k,
              capacity_factor=m.capacity_factor)
    cap = capacity_of(LM_BATCH * LM_SEQ, m.num_experts, m.top_k,
                      m.capacity_factor)
    got, aux = moe_apply(moe, x, **kw)
    want, raux, keep = moe_ref(moe, x, **kw)
    r = route(moe, x.reshape(-1, cfg.d_model), **kw)
    require(torch.equal(keep, r["keep"]) and not bool(keep.all()),
            "the MoE keep masks differ, or none dropped")
    err = (got.float() - want.float()).abs().max().item()
    big = want.float().abs().max().item()
    require(err <= 2.0 ** -6 * big and abs(aux.item() - raux.item()) <= 1e-6,
            f"moe_apply vs moe_ref: max|d| {err} (max|y| {big}), aux "
            f"{aux.item()} vs {raux.item()}")
    ms = cuda_ms(torch, lambda: moe_apply(moe, x, **kw), 5)
    ref_ms = cuda_ms(torch, lambda: moe_ref(moe, x, **kw), 2)
    out["moe_layer"] = {"err": err, "max": big, "ms": ms, "ref_ms": ref_ms,
                        "dropped": int((~keep).sum()), "capacity": cap}
    log(f"18c. deepseek MoE layer at T = {LM_BATCH * LM_SEQ} (E "
        f"{m.num_experts}, k {m.top_k}, capacity {cap}): keep masks equal "
        f"({out['moe_layer']['dropped']} of {keep.numel()} assignments "
        f"dropped), max|d| {err:.4f} (max|y| {big:.3f}), aux {aux.item():.6f}"
        f"; moe_apply {ms:.3f} ms, moe_ref {ref_ms:.3f} ms (device)")


def ssd_check(torch, ssm, cfg, out):
    """(c): one mamba2 mixer's ``ssd_chunked`` against the sequential
    ``ssd_reference`` at L = 1024 (4 chunks of 256; 80 heads of 64, state
    128), float32, the layer's own A and D: within 1e-4 of the largest
    |y| and |state| (a value sums 256 x 128 float32 products in another
    order on each side; a random walk of their roundings reaches about
    1e-5 of it)."""
    from repro_torch.models.ssm import ssd_chunked, ssd_reference
    s = cfg.ssm
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    b, l = SSD_BATCH, SSD_LEN

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = rand(b, l, s.num_heads, s.head_dim)
    B, C = rand(b, l, s.n_groups, s.state_dim), rand(b, l, s.n_groups,
                                                     s.state_dim)
    dt = torch.nn.functional.softplus(rand(b, l, s.num_heads)
                                      + ssm.dt_bias.float())
    A, D = -torch.exp(ssm.A_log.float()), ssm.D.float()
    y, st = ssd_chunked(x, dt, A, B, C, D, s.chunk_len)
    ry, rst = ssd_reference(x, dt, A, B, C, D)
    errs = ((y - ry).abs().max().item(), (st - rst).abs().max().item())
    bigs = (ry.abs().max().item(), rst.abs().max().item())
    require(all(e <= 1e-4 * max(1.0, m) for e, m in zip(errs, bigs)),
            f"ssd_chunked vs ssd_reference: max|d| {errs} (max {bigs})")
    ms = cuda_ms(torch, lambda: ssd_chunked(x, dt, A, B, C, D, s.chunk_len),
                 5)
    ref_ms = cuda_ms(torch, lambda: ssd_reference(x, dt, A, B, C, D), 1)
    out["ssd"] = {"err": errs, "max": bigs, "ms": ms, "ref_ms": ref_ms}
    log(f"18c. mamba2 ssd_chunked vs ssd_reference at [{b}, {l}, "
        f"{s.num_heads}, {s.head_dim}], state {s.state_dim}, "
        f"{l // s.chunk_len} chunks, float32: max|d| y {errs[0]:.3e} (max "
        f"{bigs[0]:.3f}), state {errs[1]:.3e} (max {bigs[1]:.3f}); "
        f"ssd_chunked {ms:.3f} ms, ssd_reference {ref_ms:.3f} ms (device)")


def family_serve(torch, model, out):
    """(d): mamba2-2.7b at full width in a ``ServeEngine`` of 4 slots
    behind phase 14's label-scoped two-hop ``GraphRetriever(engine=
    "cuda")`` over a 10,000-passage lake; 8 seeded greedy requests, all
    submitted at tick 0.  The pipelined drain equal to the sequential one
    bit for bit; batched decode equal to solo decode on decisive steps;
    tokens per second."""
    import numpy as np
    from repro_torch.data.synthetic import document_graph
    from repro_torch.serve.engine import Request, ServeEngine
    lake = document_graph(num_docs=FAMILY_SERVE_DOCS,
                          vocab=model.cfg.vocab_size,
                          mean_len=SERVE_MEAN_LEN, seed=2)

    def drain(pipeline):
        retr = serve_retriever(lake, ENGINE)
        eng = ServeEngine(model, max_slots=FAMILY_SERVE_SLOTS,
                          max_len=FAMILY_SERVE_LEN, eos_id=-1,
                          context_fn=retr, pipeline=pipeline)
        rng = np.random.default_rng(7)
        for rid in range(FAMILY_SERVE_REQUESTS):
            doc = int(rng.integers(0, lake.num_docs))
            n = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
            eng.submit(Request(rid, lake.tokens[doc][:n].astype(np.int32),
                               max_new_tokens=FAMILY_SERVE_NEW,
                               temperature=0.0, context_vertex=doc))
        fin, ms = host_timed(torch, eng.run_until_drained)
        return fin, ms, retr

    drain(True)                         # warm-up, not measured
    p, p_ms, rp = drain(True)
    s, s_ms, rs = drain(False)
    require([request_key(r) for r in p] == [request_key(r) for r in s],
            "18d. the pipelined drain differs from the sequential one")
    require((rp.meter.nbytes, rp.meter.nrequests, rp.calls)
            == (rs.meter.nbytes, rs.meter.nrequests, rs.calls),
            "18d. the retrievals differ between the drains")
    agree, decisive_n, _ = solo_decode(torch, model, p[:FAMILY_SERVE_SOLO],
                                       FAMILY_SERVE_LEN)
    require(decisive_n > 0 and agree == decisive_n,
            "18d. a decisive step of batched decode differs from solo")
    tokens = sum(len(r.output) for r in p)
    out["serve"] = {"tokens": tokens, "p_ms": p_ms, "s_ms": s_ms,
                    "p_tps": tokens * 1e3 / p_ms,
                    "s_tps": tokens * 1e3 / s_ms}
    log(f"18d. mamba2 serving: {len(p)} requests, {tokens} tokens, "
        f"pipelined == sequential bit for bit ({rp.calls} retrievals, "
        f"IOMeter {rp.meter.nbytes} B); batched == solo on {decisive_n} "
        f"decisive steps; pipelined {p_ms:.1f} ms ({out['serve']['p_tps']:.1f}"
        f" tokens/s), sequential {s_ms:.1f} ms "
        f"({out['serve']['s_tps']:.1f} tokens/s)")


def family_reduced(torch, arch):
    """(e): ``arch``'s reduced config (every ``x_gate`` 0.5) on the card
    against the same weights on the CPU, float32: forward and balance
    loss within the CPU tests' 2e-4."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    cpu = open_gates(build_model(cfg, "cpu").init(0))
    card = build_model(cfg)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    got, gaux = card.forward({"tokens": tokens})
    want, waux = cpu.forward({"tokens": tokens})
    err = (got.cpu() - want).abs().max().item()
    aerr = abs(gaux.item() - waux.item())
    require(err <= 2e-4 and aerr <= 2e-4,
            f"18e. reduced {arch} on the card vs the CPU: max|d| {err}, "
            f"aux {aerr}")
    return err, aerr


def families_phase(torch, card):
    """Phase 18: deepseek-moe-16b, llama-3.2-vision-11b, mamba2-2.7b and
    whisper-small at full width on the card, one model at a time (see the
    module docstring); returns its measurements."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    res = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        out = res[arch] = {}
        launches = FK.flash_attention.launches
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        seq = WHISPER_TEXT if cfg.encoder_layers else LM_SEQ
        batch = family_batch(torch, cfg, seq)
        if arch in FAMILY_UNITS:
            # bf16 rounding compounds over mamba2's 64 random-init layers,
            # and the run's time limit: mamba2 runs on its first layers,
            # full width
            cfg = cfg.with_(n_units=FAMILY_UNITS[arch])
        model = family_forwards(torch, cfg, batch, out)
        if cfg.encoder_layers:
            # 1,500 frames and 448 tokens are no multiple of 128: kernel 15
            # refuses them, and the model does not fall back
            set_flash(model, True)
            refused = False
            try:
                model.forward(batch)
            except ValueError as e:
                refused = "multiple of" in str(e)
            require(refused, f"{arch}: kernel 15 did not refuse "
                    f"{WHISPER_FRAMES} frames")
            set_flash(model, False)
            log(f"18a. {arch}: use_flash=False (kernel 15 refuses "
                f"{WHISPER_FRAMES} frames and {WHISPER_TEXT} tokens, no "
                f"multiple of 128: checked, it raises)")
        prompt, fed = family_decode(torch, model, batch, out)
        family_timing(torch, model, batch, prompt, fed, out)
        if cfg.moe is not None:
            moe_layer_check(torch, model.layers[0].moe, cfg, out)
        if cfg.ssm is not None:
            ssd_check(torch, model.layers[0].ssm, cfg, out)
            family_serve(torch, model, out)
        del model, batch, prompt, fed
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["flash_launches"] = FK.flash_attention.launches - launches
        require((out["flash_launches"] > 0) == (arch in FAMILY_FLASH),
                f"{arch}: kernel 15 launched {out['flash_launches']} times")
        log(f"18. {arch}: forward {LM_BATCH}x{seq} "
            f"{out['forward_ms']:.3f} ms, prefill {LM_BATCH}x{FAMILY_PROMPT} "
            f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms']:.3f} "
            f"ms/step (host wall, median of {REPS}); peak "
            f"{out['peak_gib']:.2f} GiB; kernel 15 launched "
            f"{out['flash_launches']} times "
            f"({time.perf_counter() - t0:.1f} s) on {card}")
    torch.cuda.empty_cache()
    for arch in FAMILY_REDUCED:
        err, aerr = family_reduced(torch, arch)
        res[arch] = {"err": err, "aux_err": aerr}
        log(f"18e. reduced {arch} on the card vs the CPU (float32): max|d| "
            f"logits {err:.3e}, aux {aerr:.3e}")
    return res


def family_flash_rows(torch):
    """Row 15d: kernel 15 at head dim 128, as deepseek-moe-16b's forward
    calls it ([4, 16, 2048, 128], MHA) and llama-3.2-vision-11b's ([4, 32,
    2048, 128] over 8 KV heads read in place), bf16 causal."""
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(6)
    return [flash_mha_call(torch, gen, "flash_attention@d128", 16, 16, 128),
            flash_mha_call(torch, gen, "flash_attention@d128gqa", 32, 8,
                           128)]


def spill_free(report, marker: str, what: str) -> None:
    """Fail unless every kernel whose mangled name holds ``marker``
    compiled without spills (ptxas's report)."""
    lines = report.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and marker in line:
            props = " ".join(lines[i + 1:i + 4])
            require(" 0 bytes spill stores" in props,
                    f"{what} spills: {line.strip()} {props}")


def flash_build_check(report, lib) -> None:
    """Phase 2's check of kernel 15's build: no flash kernel spills, and
    each bf16 (``flash_wgmma_kernel``) instantiation holds tensor-core
    instructions, counted in the library's SASS."""
    import os
    spill_free(report, "flash_", "a flash kernel")
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None                # tensor-core ops and TMA loads
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "flash_wgmma_kernel" in fn:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn in counts:
            for ins in counts[fn]:
                counts[fn][ins] += f" {ins}." in line or f" {ins} " in line
    for fn, c in sorted(counts.items()):
        log(f"   sass: {fn}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    require(len(counts) == 4 and all(c["HGMMA"] > 0
                                     for c in counts.values()),
            f"a bf16 flash kernel holds no HGMMA: {counts}")


class CsrOracle:
    """The mutable phase's oracle, which does not use the delta plane:
    the base's edges read once with the numpy engine, the ingested rows
    concatenated, sorted into a CSR with numpy.  Each vertex's row holds
    its neighbors sorted, with multiplicity."""

    def __init__(self, np, src, dst, n):
        key = src * n + dst
        key.sort()
        self.np, self.n = np, n
        self.indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(key // n, minlength=n), out=self.indptr[1:])
        self.dst = key % n

    def rows(self, vs):
        """Each vertex's sorted neighbors, concatenated in ``vs`` order."""
        np = self.np
        lo, hi = self.indptr[vs], self.indptr[vs + 1]
        k = hi - lo
        within = np.arange(int(k.sum()), dtype=np.int64) \
            - np.repeat(np.cumsum(k) - k, k)
        return self.dst[np.repeat(lo, k) + within]

    def ids(self, vs, mask=None):
        out = self.np.unique(self.rows(vs))
        return out if mask is None else out[mask[out]]

    def k_hop(self, seeds, hops, mask=None):
        """``k_hop``'s semantics: a hop's neighbors, filtered, less the
        visited ones, are the next frontier; filtered ids stay unvisited."""
        np = self.np
        visited = np.zeros(self.n, bool)
        frontier = np.unique(seeds)
        visited[frontier] = True
        for _ in range(hops):
            if frontier.size == 0:
                break
            nbrs = self.ids(frontier, mask)
            frontier = nbrs[~visited[nbrs]]
            visited[frontier] = True
        return np.flatnonzero(visited)


def mutable_reads(torch, adj, filt, mask, batches, seeds_of, oracle, tag):
    """Phase 15's reads on the card, each held against the CSR oracle:
    ``retrieve_neighbors_batch`` over ``batches``, unfiltered and
    filtered, with no cache, then a 4096-page LRU cold and warm;
    ``neighbor_ids_batch(unique=False)`` over the batch of 1024; ``k_hop``
    from ``seeds_of`` at 2 and 3 hops, unfiltered and filtered.  Returns
    each read's result (to hold the two runs against each other) and the
    batch-16384 host ms with no cache."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    enc = adj.table["<dst>"].encoded
    out, walls = {}, {}
    for name, vs in batches.items():
        for f in (None, filt):
            want = oracle.ids(vs, None if f is None else mask)
            cache = DecodedPageCache(CACHE_PAGES)
            for mode in ("none", "cold", "warm"):
                enc.page_cache = None if mode == "none" else cache
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pac = TC.retrieve_neighbors_batch(adj, vs, PAGE_SIZE,
                                                  engine=ENGINE, filter=f)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                require(np.array_equal(pac.to_ids(), want),
                        f"15 {tag}: batch {name} filtered={f is not None} "
                        f"{mode} differs from the CSR oracle")
                out[(name, f is not None, mode)] = pac_key(pac)
                walls[(name, f is not None, mode)] = ms
            enc.page_cache = None
    vs = batches["1024"]
    rows = TC.neighbor_ids_batch(adj, vs, engine=ENGINE, unique=False)
    require(np.array_equal(rows, oracle.rows(vs)),
            f"15 {tag}: neighbor_ids_batch(unique=False) differs from the "
            f"CSR oracle")
    out["rows"] = rows.tobytes()
    for n_seeds, seeds in seeds_of.items():
        for hops in (2, 3):
            for f in (None, filt):
                t0 = time.perf_counter()
                ids = TC.k_hop(adj, seeds, hops, engine=ENGINE, filter=f)
                walls[("k_hop", n_seeds, hops, f is not None)] = \
                    (time.perf_counter() - t0) * 1e3
                require(np.array_equal(ids, oracle.k_hop(
                    seeds, hops, None if f is None else mask)),
                    f"15 {tag}: k_hop seeds={n_seeds} hops={hops} "
                    f"filtered={f is not None} differs from the CSR oracle")
                out[("k_hop", n_seeds, hops, f is not None)] = ids.tobytes()
    return out, walls


def mutable_phase(torch, adj, vt, batches, truth, card):
    """Phase 15: soc-LiveJournal1 with rows pending, a poisoned mirror and
    an in-memory compaction (see the module docstring)."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.core.compaction import CompactionRunner
    from repro_torch.core.delta_segment import (base_edges, ingest_edges,
                                                live_delta)
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.traversal import kernel as TK
    from repro_torch.kernels.traversal import ops as TO
    enc = adj.table["<dst>"].encoded
    cond = (TC.L("L0") & TC.L("L1")) | ~TC.L("L2")
    filt = TC.LabelFilter(vt, cond)
    lab = truth["labels"]
    mask = (lab["L0"] & lab["L1"]) | ~lab["L2"]
    rng = np.random.default_rng(15)
    seeds_of = {s: rng.integers(0, N_VERTICES, s) for s in SEED_COUNTS}
    # the write-once traversal plan (phase 5's, or built here)
    t0 = time.perf_counter()
    TC.k_hop(adj, seeds_of[64], 2, engine=ENGINE)
    log(f"15. write-once k_hop (plan at version {enc.version}) "
        f"{time.perf_counter() - t0:.1f} s")

    # 1. ingest: keys are the <src> of uniformly drawn base rows (degree-
    # proportional), values uniform, one row in 16 a copy of its base row
    t0 = time.perf_counter()
    bsrc, bdst = base_edges(adj)
    t_base = time.perf_counter() - t0
    keys, vals, ingest_ms, repeats = [], [], [], 0
    for _ in range(MUT_BATCHES):
        rows = rng.integers(0, len(bsrc), MUT_ROWS)
        k = bsrc[rows]
        v = rng.integers(0, N_VERTICES, MUT_ROWS)
        dup = rng.random(MUT_ROWS) < 1 / MUT_REPEAT
        v[dup] = bdst[rows[dup]]
        repeats += int(dup.sum())
        keys.append(k)
        vals.append(v)
        t0 = time.perf_counter()
        ingest_edges(adj, k, v)
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
    delta = live_delta(adj)
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    require(delta.pending_rows() == MUT_BATCHES * MUT_ROWS,
            "15: the pending rows differ from the rows ingested")
    # 2. the oracle: a CSR over base + ingested rows, sorted by numpy
    t0 = time.perf_counter()
    oracle = CsrOracle(np, np.concatenate([bsrc, keys]),
                       np.concatenate([bdst, vals]), N_VERTICES)
    t_oracle = time.perf_counter() - t0
    del bsrc, bdst
    log(f"15. ingest: {MUT_BATCHES} batches of {MUT_ROWS} rows "
        f"({delta.pending_rows()} pending, "
        f"{100 * delta.pending_rows() / adj.num_edges:.3f}% of the base, "
        f"{repeats} copies of a base edge), ms per batch median {statistics.median(ingest_ms):.3f} "
        f"[{min(ingest_ms):.3f}, {max(ingest_ms):.3f}]; base read "
        f"{t_base:.1f} s, CSR oracle {t_oracle:.1f} s")

    half = batches[16384].copy()
    half[::2] = keys[rng.integers(0, len(keys), len(half[::2]))]
    reads = {"1024": batches[1024], "16384": batches[16384],
             "16384i": half}
    lookup = []
    for fn in (delta.lookup_batch, delta.unique_ids):
        t0 = time.perf_counter()
        fn(half)
        lookup.append((time.perf_counter() - t0) * 1e3)
    log(f"15. delta lookup over the half-ingested batch of 16384: "
        f"lookup_batch {lookup[0]:.3f} ms, unique_ids {lookup[1]:.3f} ms")

    # 3. reads while rows are pending
    fb0 = TO.traversal_stats(adj)["fallbacks"]
    t0 = time.perf_counter()
    pending, walls_p = mutable_reads(torch, adj, filt, mask, reads,
                                     seeds_of, oracle, "pending")
    fallbacks = TO.traversal_stats(adj)["fallbacks"] - fb0
    require(fallbacks == 2 * 2 * len(SEED_COUNTS),
            f"15: {fallbacks} k_hop fallbacks while pending, not one a call")
    log(f"15. pending: {len(pending)} reads equal to the CSR oracle "
        f"({time.perf_counter() - t0:.1f} s); k_hop took the host loop "
        f"{fallbacks} times")

    # 4. the poisoned mirror: the host oracle serves, no fused launch
    fused = (PK.fused_gather_decode_bitmap_batch,
             LK.fused_gather_decode_filter_bitmap_batch)
    packed = TC.pack_column(enc)
    packed.poison()
    before = [w.launches for w in fused]
    vs = reads["16384"]
    for f in (None, filt):
        t0 = time.perf_counter()
        pac = TC.retrieve_neighbors_batch(adj, vs, PAGE_SIZE, engine=ENGINE,
                                          filter=f)
        ms = (time.perf_counter() - t0) * 1e3
        require(pac_key(pac) == pending[("16384", f is not None, "none")],
                "15: the poisoned mirror's retrieval differs")
        log(f"15. poisoned: batch 16384 filtered={f is not None} on the "
            f"host oracle in {ms:.1f} ms")
    require([w.launches for w in fused] == before and packed.fallbacks > 0,
            "15: a fused kernel launched on a poisoned mirror")
    enc.bump_version()
    pac = TC.retrieve_neighbors_batch(adj, vs, PAGE_SIZE, engine=ENGINE)
    healed = enc.packed_cache
    require(pac_key(pac) == pending[("16384", False, "none")]
            and healed is not packed and healed.device_transfers == 1,
            "15: bump_version did not heal the mirror")
    require(fused[0].launches > before[0],
            "15: kernel 1 did not launch on the healed mirror")
    log(f"15. poison: {packed.fallbacks} fallbacks, kernels 1 and 4 "
        f"launched 0 times; bump_version healed it (one transfer, kernel 1 "
        f"launched again)")
    del packed, healed, pac

    # 5. the compaction, in memory, timed by stage
    runner = CompactionRunner(adj)
    stages = {}
    for name in ("_merge", "_persist", "_swap"):
        def timed(job, fn=getattr(runner, name), name=name[1:]):
            t = time.perf_counter()
            fn(job)
            stages[name] = time.perf_counter() - t
        setattr(runner, name, timed)
    n_plans = len(adj._traversal_plans)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    require(runner.maybe_compact() and live_delta(adj) is None,
            "15: the policy did not compact the backlog")
    compact_s = time.perf_counter() - t0
    require(adj.num_edges == len(oracle.dst),
            "15: the compacted column lost or gained rows")
    launches5 = TK.khop_scan.launches
    t0 = time.perf_counter()
    ids = TC.k_hop(adj, seeds_of[64], 3, engine=ENGINE)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    mem_after = torch.cuda.memory_allocated()
    require(np.array_equal(ids, oracle.k_hop(seeds_of[64], 3)),
            "15: the first compacted k_hop differs from the CSR oracle")
    require(len(adj._traversal_plans) == n_plans + 1,
            "15: k_hop did not rebuild its plan once")
    require(TK.khop_scan.launches > launches5,
            "15: khop_scan did not launch after the compaction")
    stale = [p for k, p in adj._traversal_plans.items()
             if k[0] != enc.version]
    require(all(not p._device and p.host_vals.size == 0 for p in stale),
            "15: a stale traversal plan still holds its arrays")
    require(abs(mem_after - mem_before) <= 0.05 * mem_before,
            f"15: device memory {mem_before / 2**20:.1f} MiB before the "
            f"compaction, {mem_after / 2**20:.1f} MiB after")
    log(f"15. compaction: {compact_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stages.items()) + f"), version "
        f"{enc.version}; first k_hop (plan rebuild) {rebuild_s:.1f} s; "
        f"device memory {mem_before / 2**20:.1f} MiB before, "
        f"{mem_after / 2**20:.1f} MiB after")

    fb0 = TO.traversal_stats(adj)["fallbacks"]
    launches5 = TK.khop_scan.launches
    t0 = time.perf_counter()
    compacted, walls_c = mutable_reads(torch, adj, filt, mask, reads,
                                       seeds_of, oracle, "compacted")
    require(compacted == pending,
            "15: a compacted read differs from its pending read")
    require(TO.traversal_stats(adj)["fallbacks"] == fb0,
            "15: k_hop fell back after the compaction")
    require(TK.khop_scan.launches > launches5,
            "15: khop_scan did not launch in the compacted reads")
    log(f"15. compacted: the same {len(compacted)} reads equal to the CSR "
        f"oracle and to the pending reads bit for bit "
        f"({time.perf_counter() - t0:.1f} s); k_hop fused again")
    for name in reads:
        for f in (False, True):
            log(f"15. batch {name:6s} filtered={f!s:5} host ms none / cold "
                f"/ warm: pending " + " / ".join(
                    f"{walls_p[(name, f, m)]:.1f}" for m in
                    ("none", "cold", "warm")) + ", compacted " + " / ".join(
                    f"{walls_c[(name, f, m)]:.1f}" for m in
                    ("none", "cold", "warm")) + f" on {card}")
    log("15. k_hop host ms pending (host loop) / compacted (fused): "
        + "; ".join(f"{k[1]} seeds {k[2]} hops filtered={k[3]}: "
                    f"{walls_p[k]:.1f} / {walls_c[k]:.1f}"
                    for k in walls_p if k[0] == "k_hop"))
    return {"ingest_ms": ingest_ms, "lookup_ms": lookup,
            "compact_s": compact_s, "stages": stages,
            "rebuild_s": rebuild_s, "memory": (mem_before, mem_after),
            "walls": (walls_p, walls_c)}


def serve_ingests(lake, arrivals):
    """Phase 16's ingests: ``SERVE_INGESTS`` seeded batches of
    ``SERVE_INGEST_LINKS`` links at ticks 4, 12, ..., 60, their sources
    the requests' seed documents: ``[(tick, src, dst)]``."""
    import numpy as np
    rng = np.random.default_rng(16)
    seeds = np.asarray([r.context_vertex for _, r in arrivals], np.int64)
    return [(4 + 8 * i, seeds[rng.integers(0, len(seeds),
                                           SERVE_INGEST_LINKS)],
             rng.integers(0, lake.num_docs, SERVE_INGEST_LINKS))
            for i in range(SERVE_INGESTS)]


class IngestRecorder(Recorder):
    """A ``Recorder`` that also keeps each ingest, in order with the
    calls (check (b) replays both)."""

    def __call__(self, vs):
        out = self.retr(vs)
        self.batches.append(("call", vs.copy(), [c.copy() for c in out]))
        return out

    def ingest(self, src, dst):
        self.batches.append(("ingest", list(src), list(dst)))
        return self.retr.ingest(src, dst)


def serve_mutable_phase(torch, card, serve, drive):
    """Phase 16: phase 14's serving configuration with ingests while it
    serves, then a durable compaction of the lake's edges (see the module
    docstring).  ``serve`` holds phase 14's model and lake, or None.
    Returns its measurements, with the launch counts of the pipelined
    drain alone (``drive`` sets them to 0 just before it and reads them
    just after)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.compaction import CompactionRunner
    from repro_torch.core.delta_segment import live_delta
    from repro_torch.core.storage import GraphStore
    from repro_torch.ft.faults import FaultPlan
    from repro_torch.kernels.traversal import kernel as TK
    model, lake = serve_model_lake(torch)[:2] if serve is None else \
        (serve["model"], serve["lake"])
    arrivals = serve_requests(lake)
    ingests = serve_ingests(lake, arrivals)
    log(f"16. warm-up: {SERVE_SLOTS} requests of 2 tokens on a throwaway "
        f"engine in {serve_warmup(torch, model, lake):.1f} ms")
    # the drains, pipelined then sequential (P then S, both after the
    # warm-up), each over a fresh lake, the same ingests at the same
    # ticks; the launch counts are the pipelined drain's alone
    g_p, retr_p = serve_graph_retriever(lake, ENGINE)
    eng_p = serve_engine(model, retr_p, True)
    p, launches = drive(serve_drain, torch, eng_p, serve_requests(lake),
                        ingests=ingests)
    g_s, retr = serve_graph_retriever(lake, ENGINE)
    retr_s = IngestRecorder(retr)
    eng_s = serve_engine(model, retr_s, False)
    s = serve_drain(torch, eng_s, serve_requests(lake), ingests=ingests)
    keys = [request_key(r) for r in eng_p.finished]
    require(keys == [request_key(r) for r in eng_s.finished]
            and p["shed"] == s["shed"],
            "16 (a): the pipelined engine's requests differ from the "
            "sequential engine's")
    mp, ms_ = retr_p.meter, retr.meter
    cp, cs = retr_p.page_cache, retr.page_cache
    require((mp.nbytes, mp.nrequests) == (ms_.nbytes, ms_.nrequests),
            f"16 (a): IOMeter {mp.nbytes}/{mp.nrequests} pipelined vs "
            f"{ms_.nbytes}/{ms_.nrequests} sequential")
    require((retr_p.calls, retr_p.vertices_seen, cp.hits, cp.misses) ==
            (retr.calls, retr.vertices_seen, cs.hits, cs.misses),
            "16 (a): the retrievers' calls or LRU counters differ")
    # the delta plane's read counters also count the prefetches that were
    # rolled back (the snapshot covers the meter, the LRU and the
    # retriever's own counters); every other field must be equal
    mut_p, mut = retr_p.stats()["mutable"], retr.stats()["mutable"]
    spec = ("lookups", "segments_pruned")
    require({k: v for k, v in mut_p.items() if k not in spec} ==
            {k: v for k, v in mut.items() if k not in spec},
            f"16 (a): the mutable plane differs: {mut_p} vs {mut}")
    pipe = eng_p.stats()["pipeline"]
    log(f"16a. pipelined == sequential with {len(ingests)} ingests of "
        f"{SERVE_INGEST_LINKS} links: {len(keys)} requests, "
        f"{len(p['shed'])} shed, IOMeter {mp.nbytes} B / {mp.nrequests} "
        f"requests, {retr.calls} retrievals, LRU {cs.hits} / {cs.misses}; "
        f"prefetch issued {pipe['prefetch_issued']}, hits "
        f"{pipe['prefetch_hits']}, mis-speculations "
        f"{pipe['mis_speculations']}; mutable {mut} (lookups pipelined "
        f"{mut_p['lookups']})")
    require(mut["pending_rows"] == SERVE_INGESTS * SERVE_INGEST_LINKS,
            "16: the ingests did not all land")

    # (b) a numpy retriever fed the same calls and ingests in order
    _, retr_n = serve_graph_retriever(lake, "numpy")
    n_calls = 0
    for kind, a, b in retr_s.batches:
        if kind == "ingest":
            retr_n.ingest(a, b)
            continue
        for got, want in zip(b, retr_n(a)):
            require(np.array_equal(got, want),
                    "16 (b): a context differs from the numpy engine's")
        n_calls += 1
    mn = retr_n.meter
    require((mn.nbytes, mn.nrequests) == (ms_.nbytes, ms_.nrequests)
            and retr_n.page_cache.stats() == cs.stats(),
            "16 (b): IOMeter or LRU differ from the numpy engine's")
    log(f"16b. cuda retrieval == numpy on {n_calls} recorded calls with "
        f"the {len(ingests)} ingests between them: contexts, IOMeter, LRU")
    for name, d in (("P", p), ("S", s)):
        rate, first, warm_rate, warm_tick = drain_rates(d)
        log(f"16. drain {name} (run order P S, after the warm-up): "
            f"{len(d['ticks'])} decode ticks, {d['tokens']} tokens in "
            f"{d['wall_ms']:.1f} ms, {rate:.1f} tokens/s; first decode "
            f"tick {first['wall_ms']:.1f} ms; warm ticks median "
            f"{warm_tick:.3f} ms on {card}")

    # the durable compaction of the sequential drain's lake
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_store_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        g_s.save(root)
        t_save = time.perf_counter() - t0
        adj = retr.adj
        plan = FaultPlan({"store.write": 1, "compact.pre_swap": 1,
                          "compact.mid_gc": 1})
        store = GraphStore(root, faults=plan)
        legacy = {f"{adj.table.name}.gar", f"{adj.offsets.name}.gar"}
        require(legacy <= set(os.listdir(root)),
                "16: the lake's edge tables were not written")
        runner = CompactionRunner(adj, store=store, faults=plan,
                                  sleep=lambda _s: None)
        t0 = time.perf_counter()
        require(runner.compact() and live_delta(adj) is None,
                "16: the durable compaction did not commit")
        compact_s = time.perf_counter() - t0
        files = set(os.listdir(root))
        require(store.current_generation() == 1 and runner.faults_hit == 3
                and plan.remaining() == 0,
                f"16: generation {store.current_generation()}, "
                f"{runner.faults_hit} faults absorbed")
        require(not legacy & files and not any(".tmp-" in f for f in files),
                f"16: GC left superseded files: {sorted(files)}")
        for logical, live in ((adj.table.name, adj.table),
                              (adj.offsets.name, adj.offsets)):
            read = GraphStore(root).read(logical)
            require(table_key(read) == table_key(live),
                    f"16: {logical} read back differs from the compacted "
                    f"pages")
        log(f"16. durable compaction: lake written in {t_save:.1f} s, "
            f"compacted to generation 1 in {compact_s:.2f} s through "
            f"{runner.faults_hit} injected faults ({runner.attempts} "
            f"attempts); GC removed the superseded files; the tables read "
            f"back equal the compacted pages")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the next ticks' retrievals: fused k_hop again, equal to numpy
    require(CompactionRunner(retr_n.adj).compact(),
            "16: the numpy retriever's compaction did not commit")
    before = TK.khop_scan.launches
    calls = [a for kind, a, _ in retr_s.batches if kind == "call"][-4:]
    for vs in calls:
        for got, want in zip(retr(vs), retr_n(vs)):
            require(np.array_equal(got, want),
                    "16: a compacted context differs from numpy")
    require(TK.khop_scan.launches > before,
            "16: khop_scan did not launch after the compaction")
    log(f"16. after the compaction: {len(calls)} retrievals equal to numpy, "
        f"khop_scan launched {TK.khop_scan.launches - before} times")
    return {"mis_speculations": pipe["mis_speculations"],
            "compact_s": compact_s, "launches": launches}


# --------------------------------------------------------------------------
# phase 17: the partition plane
# --------------------------------------------------------------------------

def partition_runs(torch, adj, vt, batches, oracle, tag, lru_oracle=None):
    """Phase 17's retrieval configurations on the current partitioning:
    batches of 1024 and 16384 (``PART_BATCHES``), unfiltered and ``(L0 &
    L1) | ~L2``, no cache, then a 4096-page LRU cold and warm, one run
    each.  PAC and IOMeter are held against ``oracle`` (the monolithic
    numpy engine's), the LRU counters against ``lru_oracle`` (the numpy
    engine's over the same partitioned column: filled when None).
    Returns ``{key: host ms}`` and the LRU oracle."""
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    enc = adj.table["<dst>"].encoded
    filt = TC.LabelFilter(vt, (TC.L("L0") & TC.L("L1")) | ~TC.L("L2"))
    fill = lru_oracle is None
    lru_oracle = {} if fill else lru_oracle
    times = {}

    def run(engine, vs, f, cache):
        enc.page_cache = cache
        meter = TC.IOMeter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pac = TC.retrieve_neighbors_batch(adj, vs, PAGE_SIZE, meter,
                                          engine=engine, filter=f)
        torch.cuda.synchronize()
        return (pac_key(pac), meter.nbytes, meter.nrequests,
                None if cache is None else
                (cache.hits, cache.misses, cache.evictions)), \
            (time.perf_counter() - t0) * 1e3

    for b in PART_BATCHES:
        for f in (None, filt):
            run(ENGINE, batches[b], f, None)  # untimed: placements, planes
            caches = {ENGINE: DecodedPageCache(CACHE_PAGES),
                      "numpy": DecodedPageCache(CACHE_PAGES)}
            for mode in ("none", "cold", "warm"):
                key = (b, f is not None, mode)
                cache = None if mode == "none" else caches[ENGINE]
                got, ms = run(ENGINE, batches[b], f, cache)
                times[key] = ms
                require(got[:3] == oracle[key][0][:3],
                        f"{tag}: batch {b} filter={f is not None} {mode}: "
                        f"PAC or IOMeter differs from the numpy oracle")
                if mode != "none":
                    if fill:
                        lru_oracle[key] = run("numpy", batches[b], f,
                                              caches["numpy"])[0][3]
                    require(got[3] == lru_oracle[key],
                            f"{tag}: batch {b} filter={f is not None} "
                            f"{mode}: LRU {got[3]} != numpy's "
                            f"{lru_oracle[key]}")
    enc.page_cache = None
    return times, lru_oracle


def partition_phase(torch, adj, vt, batches, card, oracle):
    """Phase 17 (see the module docstring): (a) the single-card tail, (b)
    the partitioned traversal, (c) the multi-device tail on meshes naming
    the card 8 and 4 times (and the real cards where there are several),
    (d) statistics pruning on a community-local graph."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.pac_decode import ops as PO
    from repro_torch.kernels.traversal import kernel as TK
    from repro_torch.kernels.traversal import ops as TO
    enc = adj.table["<dst>"].encoded
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    log(f"17. partitions: device memory before {mem0 / 2**20:.1f} MiB")
    out = {}

    # -- (a) the single-card tail: monolithic first (oracle, times), then
    #    the same column partitioned PARTS ways
    t0 = time.perf_counter()
    keys = [(b, f, mode) for b in PART_BATCHES for f in (False, True)
            for mode in ("none", "cold", "warm")]
    if all(k in oracle for k in keys):
        mono_oracle = {k: oracle[k] for k in keys}
    else:
        # phase 4 did not run (--partitions): the monolithic numpy engine
        # gives the oracle here
        mono_oracle = numpy_oracle(torch, adj, vt, batches)
    mono_ms, _ = partition_runs(torch, adj, vt, batches, mono_oracle,
                                "17a monolithic", lru_oracle={
                                    k: v[0][3] for k, v in
                                    mono_oracle.items() if k[2] != "none"})
    parts = TC.partition_column(enc, PARTS)
    part_ms, lru_part = partition_runs(torch, adj, vt, batches, mono_oracle,
                                       "17a single-card tail")
    out["a"] = {"mono_ms": mono_ms, "part_ms": part_ms,
                "stats": parts.stats()}
    log(f"17a. single-card tail: {PARTS} partitions, pmax {parts.pmax}, "
        f"{parts.stack_rows} stacked rows; every run equal to the numpy "
        f"oracle (PAC, IOMeter) and the LRU to the numpy engine over the "
        f"partitioned column; counters {parts.stats()} "
        f"({time.perf_counter() - t0:.1f} s) on {card}")
    for key in part_ms:
        b, f, mode = key
        log(f"17a. batch {b:5d} filtered={f!s:5} cache={mode:4s} host "
            f"{part_ms[key]:.3f} ms partitioned, {mono_ms[key]:.3f} ms "
            f"monolithic")

    # -- (b) traversal over the partitioned plan
    t0 = time.perf_counter()
    plan = TO.traversal_plan(adj, ENGINE)
    plan.device(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"17b. partitioned traversal plan built in {build_s:.1f} s "
        f"({plan.rows} rows)")
    filt = TC.LabelFilter(vt, (TC.L("L0") & TC.L("L1")) | ~TC.L("L2"))
    rng = np.random.default_rng(3)
    seeds_of = {s: rng.integers(0, N_VERTICES, s) for s in SEED_COUNTS}
    khop = {}
    for n_seeds, seeds in seeds_of.items():
        for hops in (2, 3):
            for kind in ("none", "per_hop"):
                f = None if kind == "none" else [None] + [filt] * (hops - 1)
                outs = {}
                for engine, fused in ((ENGINE, None), ("numpy", False)):
                    meter = TC.IOMeter()
                    got = TC.k_hop(adj, seeds, hops, meter, engine=engine,
                                   filter=f, fused=fused)
                    outs[engine] = (got.tobytes(), meter.nbytes,
                                    meter.nrequests)
                require(outs[ENGINE] == outs["numpy"],
                        f"17b: k_hop seeds={n_seeds} hops={hops} {kind} "
                        f"differs from the host-loop oracle")
                _, ms = host_timed(torch, lambda: TC.k_hop(
                    adj, seeds, hops, engine=ENGINE, filter=f))
                khop[(n_seeds, hops, kind)] = (outs["numpy"][0], ms,
                                               plan.last_frontier_sizes
                                               .tolist())
                log(f"17b. k_hop seeds {n_seeds:2d} hops {hops} {kind:7s} "
                    f"{ms:.3f} ms, {len(got)} ids, sizes "
                    f"{plan.last_frontier_sizes.tolist()}, io "
                    f"{outs[ENGINE][1]} B / {outs[ENGINE][2]} req")
    seed = int(seeds_of[1][0])
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    pac = TO.two_hop_pac(adj, adj, [seed], PAGE_SIZE, filt, m_k, ENGINE)
    created = TC.neighbor_ids_batch(adj, [seed], m_o, engine="numpy")
    want = TC.retrieve_neighbors_batch(adj, created, PAGE_SIZE, m_o,
                                       "numpy", filter=filt)
    require(pac_key(pac) == pac_key(want) and pac.count() > 0
            and (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests),
            "17b: two_hop_pac differs from the staged numpy path")
    starts, ends = TC.LabelFilter(vt, TC.L("L0")).intervals("numpy")
    off = np.asarray(adj.offsets["<offset>"].values, np.int64)
    los, his = off[starts], off[ends]
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    counts = TO.frontier_edge_counts(adj, starts, ends, los, his, m_k,
                                     ENGINE)
    rows = TC.decode_edge_ranges(adj, los, his, m_o, "numpy")
    require(np.array_equal(counts, np.bincount(rows, minlength=N_VERTICES))
            and (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests),
            "17b: frontier_edge_counts differs from the numpy bincount")
    del rows
    out["b"] = {"plan_build_s": build_s, "k_hop": khop,
                "stats": parts.stats(),
                "traversal": TO.traversal_stats(adj)}
    log(f"17b. traversal: {len(khop)} k_hop configurations, two_hop_pac "
        f"({pac.count()} ids) and frontier_edge_counts "
        f"({int(counts.sum())} edges) equal to their oracles; counters "
        f"{parts.stats()} ({time.perf_counter() - t0:.1f} s) on {card}")

    # -- (c) the multi-device tail: meshes naming the card PARTS and
    #    PARTS / 2 times (two partitions an entry), and the real cards
    meshes = [(f"{PARTS} x {DEVICE}", (dev,) * PARTS),
              (f"{PARTS // 2} x {DEVICE}", (dev,) * (PARTS // 2))]
    if torch.cuda.device_count() > 1:
        meshes.append(("cards", tuple(torch.device("cuda", i) for i in
                                      range(torch.cuda.device_count()))))
    saved = (PO._devices, PO.SHARD_MIN_PAGES)
    PO.SHARD_MIN_PAGES = 0
    out["c"] = {}
    merge_inputs = None
    b = PART_BATCHES[-1]
    for name, mesh in meshes:
        t0 = time.perf_counter()
        PO._devices = lambda engine, m=mesh: m
        g = parts.mesh_size(len(mesh))
        t1 = time.perf_counter()
        layouts = plan.sharded_arrays(parts, parts.mesh_devices(mesh))
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t1
        res = {"g": g, "layout_s": layout_s, "retrieval_ms": {},
               "k_hop_ms": {}}
        for f in (None, filt):
            cache = DecodedPageCache(CACHE_PAGES)
            for mode in ("none", "cold", "warm"):
                key = (b, f is not None, mode)
                enc.page_cache = None if mode == "none" else cache
                wr = LK.fused_gather_decode_filter_bitmap_batch \
                    if f is not None else PK.fused_gather_decode_bitmap_batch
                l0 = wr.launches
                meter = TC.IOMeter()
                got, ms = host_timed(torch, lambda: TC.retrieve_neighbors_batch(
                    adj, batches[b], PAGE_SIZE, meter, engine=ENGINE,
                    filter=f))
                lru = None if mode == "none" else \
                    (cache.hits, cache.misses, cache.evictions)
                require((pac_key(got), meter.nbytes, meter.nrequests)
                        == mono_oracle[key][0][:3]
                        and lru == (lru_part.get(key)),
                        f"17c {name}: batch {b} filter={f is not None} "
                        f"{mode} differs from the oracle")
                require(wr.launches - l0 == PK.FUSED_LAUNCHES * g,
                        f"17c {name}: {wr.launches - l0} fused launches a "
                        f"call, want one call ({PK.FUSED_LAUNCHES}) per "
                        f"mesh entry ({g})")
                res["retrieval_ms"][key] = ms
            enc.page_cache = None
        vs = batches[PART_BATCHES[0]]
        l0 = PK.gather_decode.launches
        ids = TC.neighbor_ids_batch(adj, vs, engine=ENGINE)
        require(PK.gather_decode.launches - l0 == g
                and np.array_equal(ids, TC.neighbor_ids_batch(
                    adj, vs, engine="numpy")),
                f"17c {name}: the page-matrix decode differs or took "
                f"{PK.gather_decode.launches - l0} launches, want {g}")
        for (n_seeds, hops, kind), (want_ids, _, _) in khop.items():
            f = None if kind == "none" else [None] + [filt] * (hops - 1)
            e0, m0, k0 = (TK.expand_words.launches, TK.merge_hop.launches,
                          TK.khop_scan.launches)
            got, ms = host_timed(torch, lambda: TC.k_hop(
                adj, seeds_of[n_seeds], hops, engine=ENGINE, filter=f))
            require(got.tobytes() == want_ids,
                    f"17c {name}: k_hop seeds={n_seeds} hops={hops} {kind} "
                    f"differs from the host-loop oracle")
            require((TK.expand_words.launches - e0, TK.merge_hop.launches
                     - m0, TK.khop_scan.launches - k0) == (g * hops, hops, 0),
                    f"17c {name}: k_hop launched "
                    f"{TK.expand_words.launches - e0} expansions and "
                    f"{TK.merge_hop.launches - m0} merges for {hops} hops "
                    f"over {g} mesh entries")
            res["k_hop_ms"][(n_seeds, hops, kind)] = ms
        if merge_inputs is None:
            merge_inputs = {"mesh": parts.mesh_devices(mesh),
                            "layouts": layouts, "seeds": seeds_of[64],
                            "filt": filt, "n": plan.n_value}
        out["c"][name] = res
        log(f"17c. {name}: mesh of {g} entries ({PARTS // g} partitions "
            f"an entry), layouts built in {layout_s:.1f} s; batch {b} "
            f"unfiltered and filtered, no cache and LRU cold and warm, "
            f"the page-matrix decode and {len(khop)} k_hop configurations "
            f"equal to the oracles, one launch of kernels 1, 4, 2 per entry "
            f"and one rt_merge_hop a hop ({time.perf_counter() - t0:.1f} s)")
        log(f"17c. {name}: host ms, retrieval " + ", ".join(
            f"{'f' if k[1] else 'u'}/{k[2]} {v:.3f}"
            for k, v in res["retrieval_ms"].items()) + "; k_hop " +
            ", ".join(f"{k[0]}/{k[1]}/{k[2]} {v:.3f}"
                      for k, v in res["k_hop_ms"].items()))
    PO._devices, PO.SHARD_MIN_PAGES = saved
    out["c_stats"] = parts.stats()

    # -- (d) statistics pruning at scale, community-local graph
    out["d"] = local_pruning(torch, card)

    # leave the column as phase 11 left it for phase 15: monolithic, the
    # partitioned plan and its placements freed
    adj._traversal_plans.pop((enc.version, PARTS)).release()
    TC.partition_column(enc, 1)
    out["memory_before"] = mem0
    out["inputs"] = merge_inputs
    return out


def numpy_oracle(torch, adj, vt, batches):
    """The monolithic numpy engine's runs of phase 17's configurations,
    keyed as phase 4's oracle (a one-run list each)."""
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    enc = adj.table["<dst>"].encoded
    filt = TC.LabelFilter(vt, (TC.L("L0") & TC.L("L1")) | ~TC.L("L2"))
    orc = {}
    for b in PART_BATCHES:
        for f in (None, filt):
            cache = DecodedPageCache(CACHE_PAGES)
            for mode in ("none", "cold", "warm"):
                enc.page_cache = None if mode == "none" else cache
                meter = TC.IOMeter()
                pac = TC.retrieve_neighbors_batch(adj, batches[b], PAGE_SIZE,
                                                  meter, engine="numpy",
                                                  filter=f)
                orc[(b, f is not None, mode)] = [(
                    pac_key(pac), meter.nbytes, meter.nrequests,
                    None if mode == "none" else
                    (cache.hits, cache.misses, cache.evictions))]
    enc.page_cache = None
    return orc


def local_pruning(torch, card):
    """Phase 17 (d): the community-local graph of
    ``benchmarks/bench_partition.py:_fixture(local=True)`` at
    LOCAL_VERTICES vertices of degree LOCAL_DEGREE, ``HOT`` the first
    quarter of the ids; batches of 1024 and 16384 filtered by
    ``L("HOT")`` on the monolithic column and at PARTS partitions."""
    import numpy as np
    import repro_torch.core as TC
    t0 = time.perf_counter()
    n = LOCAL_VERTICES
    off = np.concatenate([np.arange(-(LOCAL_DEGREE // 2), 0),
                          np.arange(1, LOCAL_DEGREE - LOCAL_DEGREE // 2 + 1)])
    src = np.repeat(np.arange(n), len(off))
    dst = np.clip(np.arange(n)[:, None] + off[None, :], 0, n - 1).ravel()
    adj = TC.build_adjacency(src, dst, n, n, TC.BY_SRC, TC.ENC_GRAPHAR,
                             page_size=PAGE_SIZE)
    del src, dst
    col = adj.table["<dst>"].encoded
    lvt = TC.VertexTable.build(
        TC.VertexTypeSchema("v", [], labels=["HOT"], page_size=PAGE_SIZE),
        {}, {"HOT": np.arange(n) < n // 4}, num_vertices=n)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    batches = {b: rng.integers(0, n, b) for b in PART_BATCHES}

    def run(vs, engine):
        meter = TC.IOMeter()
        st = col.prune_stats
        c0, p0 = st.pages_considered, st.pages_pruned
        pac = TC.retrieve_neighbors_batch(
            adj, vs, PAGE_SIZE, meter, engine=engine,
            filter=TC.LabelFilter(lvt, TC.L("HOT")))
        decoded = (st.pages_considered - c0) - (st.pages_pruned - p0)
        return pac.to_ids(), (meter.nbytes, meter.nrequests), decoded

    res = {"build_s": build_s, "edges": adj.num_edges,
           "pages": len(col.pages)}
    mono = {b: run(batches[b], "numpy") for b in PART_BATCHES}
    mono_cuda = {b: run(batches[b], ENGINE) for b in PART_BATCHES}
    parts = TC.partition_column(col, PARTS)
    for b in PART_BATCHES:
        s0 = parts.stats_pruned
        ids, io, decoded = run(batches[b], ENGINE)
        _, io_np, _ = run(batches[b], "numpy")
        require(np.array_equal(ids, mono[b][0]),
                f"17d: batch {b}: ids differ from the monolithic oracle")
        require(io == io_np and io[0] <= mono_cuda[b][1][0]
                and mono_cuda[b][1] == mono[b][1],
                f"17d: batch {b}: IOMeter {io} (numpy over the partitions "
                f"{io_np}, monolithic {mono_cuda[b][1]})")
        require(parts.stats_pruned - s0 > 0,
                f"17d: batch {b}: no partition statistics-pruned")
        res[b] = {"ids": len(ids), "io": io, "io_mono": mono_cuda[b][1],
                  "pages_decoded": decoded,
                  "pages_decoded_mono": mono_cuda[b][2],
                  "stats_pruned": parts.stats_pruned - s0}
        log(f"17d. local graph batch {b:5d}: {len(ids)} ids equal to the "
            f"monolithic oracle; {parts.stats_pruned - s0} partitions "
            f"statistics-pruned; pages decoded {decoded} (monolithic "
            f"{mono_cuda[b][2]}); io {io[0]} B / {io[1]} req (monolithic "
            f"{mono_cuda[b][1][0]} B / {mono_cuda[b][1][1]} req)")
    res["stats"] = parts.stats()
    log(f"17d. statistics pruning: {n} vertices, {adj.num_edges} edges, "
        f"{len(col.pages)} pages, built in {build_s:.1f} s; counters "
        f"{parts.stats()} ({time.perf_counter() - t0:.1f} s) on {card}")
    return res


def partition_kernel_rows(torch, inputs):
    """The sharded k-hop's launches against their plain versions on the
    card at the 8-entry mesh's shapes (64 seeds, the first hop): the seed
    launch, one entry's expansion, and ``rt_merge_hop`` over the 8
    entries' partial words; each timed beside its bound."""
    import numpy as np
    from repro_torch.kernels.traversal import kernel as TK
    from repro_torch.kernels.traversal import ops as TO
    from repro_torch.kernels.traversal import ref as TR
    mesh, layouts, n = inputs["mesh"], inputs["layouts"], inputs["n"]
    dev = mesh[0]
    nw = -(-n // 32)
    g, n_sum = TK._summary_shape(nw)
    sv = torch.from_numpy(TO._seed_vector(np.unique(inputs["seeds"]), n)) \
        .to(dev)
    fwords = inputs["filt"].plan().device_bitmap(dev, nw)
    ones = torch.full((nw,), -1, dtype=torch.int32, device=dev)
    rows = []

    bufs = [torch.zeros(k, dtype=torch.int32, device=dev)
            for k in (n, nw, nw, n_sum, 2)]

    def seeds():
        # the kernel ORs into zeroed buffers: calls again on the same
        # buffers set the same bits
        TK.seed_words(sv, n, *bufs[:4], g, bufs[4])
        return bufs

    def seeds_plain():
        plane = TR._seed_plane(sv, n)
        w = TR._pack_words(plane, nw)
        return [plane, w, w, TR.summary_words(w, g, n_sum),
                torch.zeros(2, dtype=torch.int32, device=dev)]

    got, want = seeds(), seeds_plain()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "seed_words differs from its plain version")
    visited, frontier, vis_words, summary, _ = got
    rows.append(kernel_row(
        "seed_words", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/shard.py:107", 0, cuda_ms(torch, seeds, 10),
        cuda_ms(torch, seeds_plain, 3),
        4 * (sv.numel() + 4 * int(sv.lt(n).sum()) + 2)))

    def expand(i, out):
        ks, voff = layouts[i]
        return TK.expand_words(ks, voff, frontier, summary, g, n, ones, out,
                               n)

    def expand_plain(i):
        ks, voff = layouts[i]
        plane = TR.expand_plane(ks, voff, TR._filter_bits(frontier, n))
        return TR._pack_words(plane, nw) & ones

    partial = torch.empty((len(mesh), nw), dtype=torch.int32, device=dev)
    for i in range(len(mesh)):
        expand(i, partial[i])
        require(torch.equal(partial[i], expand_plain(i)),
                f"expand_words differs from its plain version (entry {i})")
    ks0, voff0 = layouts[0]
    all_v = torch.ones(n, dtype=torch.bool, device=dev)
    need = needed_rows(torch, ks0, voff0, visited, all_v)
    scratch = torch.empty(nw, dtype=torch.int32, device=dev)
    rows.append(kernel_row(
        "expand_words", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:74", 0,
        cuda_ms(torch, lambda: expand(0, scratch), 10),
        cuda_ms(torch, lambda: expand_plain(0), 2),
        4 * (int(need.sum()) + (n + 1) + 3 * nw + n_sum)))
    log(f"kernels: seed_words and expand_words equal to their plain "
        f"versions ({len(mesh)} entries, {int(need.sum())} rows needed by "
        f"entry 0)")

    outs = [torch.empty(k, dtype=torch.int32, device=dev)
            for k in (nw, n_sum, n)]
    state = [vis_words.clone(), visited.clone(),
             torch.zeros(1, dtype=torch.int32, device=dev)]

    def merge():
        # timed calls go on from the state the first left: every input
        # word is read and the plane written again, the visited updates
        # find nothing new
        TK.merge_hop(partial, fwords, state[0], state[1], outs[0], outs[1],
                     g, outs[2], state[2], n)
        return outs + state

    def merge_plain():
        nxt, summ, plane, vw, size = TR.merge_hop(partial, fwords,
                                                  vis_words, n, g, n_sum)
        return [nxt, summ, plane, vw, visited | plane, size]

    got, want = merge(), merge_plain()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "merge_hop differs from its plain version")
    err = max(max_err(a, b) for a, b in zip(got, want))
    found = int(got[5][0])
    nbytes = 4 * ((len(mesh) + 2) * nw + 2 * nw + n_sum + n + found + 1)
    rows.append(kernel_row(
        "merge_hop", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/shard.py:116", err, cuda_ms(torch, merge, 20),
        cuda_ms(torch, merge_plain, 3), nbytes))
    log(f"kernels: merge_hop equal to its plain version over {len(mesh)} "
        f"entries' words ({nw} words, {found} ids found)")
    return rows


def partition_phases(torch, drive, adj, vt, batches, oracle, card):
    """Phase 17 (counted) and its kernel rows; returns the rows and the
    launch counts."""
    t0 = time.perf_counter()
    res, launches = drive(partition_phase, torch, adj, vt, batches, card,
                          oracle)
    require(all(launches[n] for n in PARTITION_KERNELS),
            f"a kernel of the partition plane never launched: {launches}")
    log(f"17. partitions: (a)-(d) pass, launches " + ", ".join(
        f"{n} {c}" for n, c in launches.items() if c)
        + f" ({time.perf_counter() - t0:.1f} s) on {card}")
    t0 = time.perf_counter()
    rows = partition_kernel_rows(torch, res.pop("inputs"))
    log(f"17k. partition kernels: seed_words, expand_words, merge_hop "
        f"equal to their plain versions ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before, after = res["memory_before"], torch.cuda.memory_allocated()
    log(f"17. partitions: device memory {before / 2**20:.1f} MiB before, "
        f"{after / 2**20:.1f} MiB after (the partitioned plans and "
        f"placements freed with their columns, no cyclic collection)")
    if oracle:
        # phase 4 placed the monolithic column's plan before this phase
        # (under --partitions this phase places it): only (d)'s dropped
        # graph and the partitioned plans could add to it
        require(after <= 1.02 * before,
                f"device memory after phase 17 {after} > 1.02 x {before}")
    return rows, launches


def table_key(table):
    """A table's columns as bytes: every delta page's header and words,
    or the plain values."""
    import numpy as np
    out = {}
    for name, col in table.columns.items():
        enc = getattr(col, "encoded", None)
        if enc is None:
            out[name] = np.asarray(col.read_all()).tobytes()
        else:
            out[name] = [(p.count, p.first_value, p.min_deltas.tobytes(),
                          p.bit_widths.tobytes(), p.word_offsets.tobytes(),
                          p.packed.tobytes()) for p in enc.pages]
    return (table.num_rows, out)


# --------------------------------------------------------------------------
# phase 19: training smollm-360m at full width from the GraphAr lake
# --------------------------------------------------------------------------

class TimedOptimizer:
    """An optimizer whose ``update`` records a CUDA event on each side,
    so that a train step splits into its forward and backward and its
    optimizer update on the device's clock."""

    def __init__(self, torch, opt):
        from repro_torch.train.optimizer import Optimizer
        self.torch = torch
        self.inner = opt
        self.marks = []
        self.opt = Optimizer(opt.init, self.update)

    def update(self, grads, state, params, layout=None):
        ev = self.torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        out = self.inner.update(grads, state, params, layout)
        end.record()
        self.marks.append((start, end))
        return out


def train_checkpoint_dir(name: str) -> Path:
    """An empty directory for a checkpoint run under ``build/``."""
    import shutil
    d = ROOT / "build" / "chip_smoke_train" / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def train_phase(torch, card, lake=None):
    """Phase 19: training at full width on the card (see the module
    docstring); returns the measurements and what the profile (19p)
    needs."""
    import shutil
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                     save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import GraphCorpusPipeline, PipelineConfig
    from repro_torch.data.synthetic import document_graph
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import (make_train_step, model_params,
                                              unit_layout)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(LM_ARCH)
    require((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim, cfg.vocab_size, cfg.param_dtype, cfg.remat,
             cfg.train_microbatches, cfg.use_flash) ==
            (32, 960, 15, 5, 64, 49152, "bfloat16", "dots", 4, False),
            f"{LM_ARCH} config changed")
    n_micro = cfg.train_microbatches

    def sched():
        return warmup_cosine(TRAIN_PEAK, TRAIN_WARMUP, TRAIN_STEPS)

    t0 = time.perf_counter()
    built = lake is None
    if built:
        lake = document_graph(num_docs=SERVE_DOCS, vocab=cfg.vocab_size,
                              mean_len=SERVE_MEAN_LEN, seed=2)
    graph = serve_graph(lake)
    t_lake = time.perf_counter() - t0
    cond = (TC.L("HighQuality") | TC.L("News")) & ~TC.L("Spam")
    pcfg = PipelineConfig(seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH)
    pipe, t_filter = host_timed(torch, lambda: GraphCorpusPipeline(
        graph, cond, pcfg, engine=ENGINE))
    host = GraphCorpusPipeline(graph, cond, pcfg, engine="numpy")
    require(np.array_equal(pipe.eligible, host.eligible),
            "(a) the cuda label filter's eligible documents differ from "
            "the numpy engine's")
    t0 = time.perf_counter()
    model = build_model(cfg).init(0)
    torch.cuda.synchronize()
    log(f"19. set-up: lake of {lake.num_docs:,} docs "
        f"({'built' if built else 'reused from phase 14'}) and graph in {t_lake:.1f} "
        f"s; (a) {pipe.eligible.size:,} eligible docs under "
        f"(HighQuality | News) & ~Spam, equal to the numpy engine's, label "
        f"filter {t_filter:.1f} ms; {LM_ARCH} init "
        f"{time.perf_counter() - t0:.1f} s")

    timed = TimedOptimizer(torch, adamw(sched()))
    step = make_train_step(model, timed.opt, n_micro)
    params = model_params(model)
    state = timed.opt.init(params, unit_layout(model))
    stream = pipe.batches()
    batches, rows = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        b = next(stream)
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, met = step(params, state, b)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        t2 = time.perf_counter()
        o_start, o_end = timed.marks[-1]
        rows.append({"pipeline_ms": (t1 - t0) * 1e3,
                     "step_ms": (t2 - t1) * 1e3,
                     "fwd_bwd_ms": start.elapsed_time(o_start),
                     "opt_ms": o_start.elapsed_time(o_end),
                     "loss": loss, "grad_norm": gnorm})
        batches.append({k: b[k] for k in ("tokens", "labels")})
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in rows]
    first = statistics.mean(losses[:TRAIN_WINDOW])
    last = statistics.mean(losses[-TRAIN_WINDOW:])
    require(all(math.isfinite(x) for x in losses)
            and all(math.isfinite(r["grad_norm"]) for r in rows),
            f"(b) a loss or gradient norm is not finite: {rows}")
    require(last < first, f"(b) the loss did not fall: mean of the first "
            f"{TRAIN_WINDOW} {first:.4f}, of the last {last:.4f}")
    warm = rows[2:]
    med = {k: statistics.median(r[k] for r in warm)
           for k in ("pipeline_ms", "step_ms", "fwd_bwd_ms", "opt_ms")}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"losses": losses, "rows": rows, "peak_bytes": peak, **med,
           "tokens_per_s": tokens / ((med["pipeline_ms"] + med["step_ms"])
                                     / 1e3)}
    log(f"19. train: {TRAIN_STEPS} steps of {tokens:,} tokens "
        f"({TRAIN_BATCH} x {TRAIN_SEQ}, {n_micro} microbatches, remat "
        f"{cfg.remat}); (b) loss " + " ".join(f"{x:.3f}" for x in losses)
        + f"; mean of the first {TRAIN_WINDOW} {first:.4f} > of the last "
        f"{last:.4f}; grad norm {rows[0]['grad_norm']:.3f} -> "
        f"{rows[-1]['grad_norm']:.3f}; on {card}")
    log(f"19. warm step (median of steps 3-{TRAIN_STEPS}): pipeline host "
        f"{med['pipeline_ms']:.1f} ms, train step {med['step_ms']:.1f} ms "
        f"host wall (forward+backward {med['fwd_bwd_ms']:.1f} ms, optimizer "
        f"{med['opt_ms']:.1f} ms on the device's clock); "
        f"{out['tokens_per_s']:,.0f} tokens/s with the pipeline, "
        f"{tokens / (med['step_ms'] / 1e3):,.0f} without; peak "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; on {card}")

    # the remat policy's cost: one warm step under "full" beside "dots"
    remat_ms = {}
    for remat in ("full", cfg.remat):
        model.cfg = cfg.with_(remat=remat)
        _, remat_ms[remat] = host_timed(torch, lambda: step(
            params, state, batches[-1]))
    model.cfg = cfg
    out["remat_ms"] = remat_ms
    log(f"19. remat: one warm step {remat_ms['full']:.1f} ms under "
        f"\"full\" (every unit recomputed) beside {remat_ms[cfg.remat]:.1f} "
        f"ms under \"{cfg.remat}\" (the projections kept, the policy "
        f"consulted in Python on every op); on {card}")

    # a bf16 checkpoint of the trained state: save, restore, equal
    ck = train_checkpoint_dir("roundtrip")
    tree = {"params": params, "opt": state}
    path, save_ms = host_timed(torch, lambda: save_checkpoint(
        str(ck), TRAIN_STEPS, tree, extra={"next_step": TRAIN_STEPS}))
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    (back, extra), restore_ms = host_timed(torch, lambda: restore_checkpoint(
        str(ck), TRAIN_STEPS, like=tree))
    require(extra == {"next_step": TRAIN_STEPS} and all(
        torch.equal(back["params"][k], v) for k, v in params.items())
        and all(torch.equal(back["opt"][m][k], v) for m in ("m", "v")
                for k, v in state[m].items())
        and int(back["opt"]["step"]) == TRAIN_STEPS
        and back["params"]["embed"].dtype == torch.bfloat16,
        "the restored checkpoint differs from the saved train state")
    shutil.rmtree(ck)
    out.update(ckpt_bytes=nbytes, save_ms=save_ms, restore_ms=restore_ms)
    log(f"19. checkpoint: {nbytes / 2**30:.3f} GiB (bf16 params, float32 "
        f"moments) saved in {save_ms / 1e3:.2f} s, restored and held equal "
        f"in {restore_ms / 1e3:.2f} s (warm page cache) under build/; on "
        f"{card}")

    # (c) n_micro 4 == 1 and (d) bf16 against float32, from the init weights
    # (a step never writes the model's own parameters)
    small = {k: torch.from_numpy(np.ascontiguousarray(
        batches[0][k][:, :TRAIN_CHECK_SEQ])).to(model.device)
        for k in ("tokens", "labels")}
    m32 = build_model(cfg.with_(param_dtype="float32",
                                compute_dtype="float32"))
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    p32 = model_params(m32)
    got = {}
    for n in (1, n_micro):
        o = adamw(sched())
        got[n] = make_train_step(m32, o, n)(
            p32, o.init(p32, unit_layout(m32)), small)
    (q1, _, c1), (q4, _, c4) = got[1], got[n_micro]
    worst = max(float(((q4[k] - q1[k]).abs()
                       / (5e-4 + 2e-4 * q1[k].abs())).max()) for k in q1)
    # the parameters alone cannot show a wrong accumulation (the clip and
    # Adam's scale invariance hide its scale, and a first step at lr 6e-5
    # moves no parameter past the atol): the gradient norm, taken before
    # the clip from the accumulated gradients, is held too
    g1, g4 = float(c1["grad_norm"]), float(c4["grad_norm"])
    require(abs(float(c4["loss"]) - float(c1["loss"]))
            <= 1e-5 * abs(float(c1["loss"])) and abs(g4 - g1) <= 1e-4 * g1
            and worst <= 1.0,
            f"(c) n_micro {n_micro} differs from n_micro 1: loss "
            f"{float(c4['loss'])} vs {float(c1['loss'])}, grad norm {g4} vs "
            f"{g1}, worst |diff| / (5e-4 + 2e-4 |p|) {worst:.3f}")
    del got, q1, q4, p32
    with torch.enable_grad():
        l16, _ = model.loss(small)
        g16 = torch.autograd.grad(l16, list(model.parameters()))
        l32, _ = m32.loss(small)
        g32 = torch.autograd.grad(l32, list(m32.parameters()))
    dot = sum(float((a.float() * b).sum()) for a, b in zip(g16, g32))
    n16 = math.sqrt(sum(float((a.float() ** 2).sum()) for a in g16))
    n32 = math.sqrt(sum(float((b ** 2).sum()) for b in g32))
    cos = dot / (n16 * n32)
    rel = abs(float(l16) - float(l32)) / abs(float(l32))
    require(rel <= 0.02 and cos >= 0.99,
            f"(d) bf16 against float32: loss {float(l16):.5f} vs "
            f"{float(l32):.5f} (rel {rel:.5f}), grad cosine {cos:.5f}")
    out.update(micro_worst=worst, micro_gnorm_rel=abs(g4 - g1) / g1,
               bf16_loss_rel=rel, bf16_grad_cos=cos)
    log(f"19. (c) n_micro {n_micro} == 1 on the float32 copy at "
        f"{TRAIN_BATCH} x {TRAIN_CHECK_SEQ}: loss {float(c4['loss']):.6f} "
        f"vs {float(c1['loss']):.6f}, grad norm {g4:.6f} vs {g1:.6f} (rel "
        f"{abs(g4 - g1) / g1:.2e}, tolerance 1e-4), worst |diff| / (5e-4 + "
        f"2e-4 |p|) {worst:.3f}; (d) bf16 loss {float(l16):.5f} vs float32 "
        f"{float(l32):.5f} (rel {rel:.5f}), gradient cosine {cos:.6f}")
    del g16, g32, m32
    torch.cuda.empty_cache()

    # (e) the trainer: a crash at step 6, restored from step 4, against a
    # clean run from the same init(0), all in bf16 (parameters and AdamW's
    # moments); the recovery, not the step, is what (e) holds, so it runs
    # the model's first TRAIN_FT_UNITS layers at full width, and its steps
    # take one microbatch of 8 x 512 (a step's host time grows with its
    # layers and microbatches: the remat policy's dispatch)
    ft_model = build_model(cfg.with_(n_units=TRAIN_FT_UNITS))
    ft_batches = [{k: np.ascontiguousarray(v[:, :TRAIN_CHECK_SEQ])
                   for k, v in b.items()} for b in batches]

    def trainer_run(name, fail):
        d = train_checkpoint_dir(name)
        tcfg = TrainerConfig(total_steps=TRAIN_FT_STEPS,
                             checkpoint_every=TRAIN_FT_EVERY,
                             checkpoint_dir=str(d), log_every=1)
        t0 = time.perf_counter()
        res = Trainer(ft_model, adamw(sched(), moment_dtype="bfloat16"), tcfg,
                      lambda s: ft_batches[s]).run(
                          simulate_failure_at=fail)
        res["seconds"] = time.perf_counter() - t0
        res["checkpoints"] = sorted(p.name for p in d.iterdir())
        shutil.rmtree(d)
        return res
    crash = trainer_run("crash", TRAIN_FT_FAIL)
    clean = trainer_run("clean", None)
    want = {h["step"]: h for h in clean["history"]}
    steps = [h["step"] for h in crash["history"]]
    require(crash["failures"] == 1 and crash["final_step"] == TRAIN_FT_STEPS
            and steps == list(range(1, TRAIN_FT_FAIL + 1))
            + list(range(TRAIN_FT_EVERY + 1, TRAIN_FT_STEPS + 1))
            and sorted(want) == list(range(1, TRAIN_FT_STEPS + 1)),
            f"(e) the crashed run did not recover as planned: {steps}, "
            f"{crash['failures']} failures")
    drift = max(max(abs(h[k] - want[h["step"]][k]) / abs(want[h["step"]][k])
                    for k in ("loss", "grad_norm"))
                for h in crash["history"])
    require(drift <= 1e-4, f"(e) the recovered history differs from the "
            f"clean run's by rel {drift:.2e}")
    out.update(ft_drift=drift, ft_seconds=(crash["seconds"],
                                           clean["seconds"]))
    del ft_model
    log(f"19. (e) Trainer, {TRAIN_FT_UNITS} layers at full width, "
        f"{TRAIN_FT_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_CHECK_SEQ} in one microbatch, bf16 moments, a checkpoint "
        f"every "
        f"{TRAIN_FT_EVERY}, a crash at {TRAIN_FT_FAIL}: recovered from step "
        f"{TRAIN_FT_EVERY} ({crash['checkpoints']} left), history within "
        f"rel {drift:.2e} of the clean run's (tolerance 1e-4; not under "
        f"torch.use_deterministic_algorithms); {crash['seconds']:.1f} s "
        f"and {clean['seconds']:.1f} s")

    # (f) the flash route refuses autograd
    flash = build_model(cfg.with_(use_flash=True))
    flash.load_state_dict(model.state_dict())
    try:
        with torch.enable_grad():
            flash.loss(small)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    require("no backward kernel" in raised,
            f"(f) a use_flash=True loss under autograd did not raise: "
            f"{raised!r}")
    del flash
    log("19. (f) a use_flash=True loss under autograd raises: "
        + raised.split(":")[0])
    out.update(model=model, step=step, params=params, state=state,
               batch=batches[-1])
    return out


def train_profile_phase(torch, train, card):
    """``torch.profiler`` over one warm train step of phase 19's model at
    its full batch: device busy ms by kernel, idle share against phase
    19's unprofiled median step."""
    t0 = time.perf_counter()
    wall, busy = profile_ms(torch, lambda: train["step"](
        train["params"], train["state"], train["batch"]), reps=1)
    total = sum(busy.values())
    step = train["step_ms"]
    top6 = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    log(f"19p. profile, one warm train step: device busy {total:.1f} ms of "
        f"{step:.1f} ms median unprofiled step (idle share "
        f"{1 - total / step:.3f}; {wall:.1f} ms under the profiler); "
        + "; ".join(f"{kernel_name(n)[:50]} {ms:.1f}" for n, ms in top6)
        + f" ({time.perf_counter() - t0:.1f} s) on {card}")
    return {"busy": total, "idle": 1 - total / step, "profiled_wall": wall}


# --------------------------------------------------------------------------
# phase 20: the launch layer (dry-run, its roofline against the card,
# elastic restore, the serve CLI)
# --------------------------------------------------------------------------

def launch_dir(name: str) -> Path:
    """An empty directory for phase 20 under ``build/``."""
    import shutil
    d = ROOT / "build" / "chip_smoke_launch" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def row_terms(row) -> str:
    return (f"t_compute {row['t_compute_s'] * 1e3:.3f} ms, t_memory "
            f"{row['t_memory_s'] * 1e3:.3f} ms, t_collective "
            f"{row['t_collective_s'] * 1e3:.3f} ms ({row['collectives']}), "
            f"bottleneck {row['bottleneck']}, useful "
            f"{row['useful_flops_ratio']:.3f}, args "
            f"{row['memory']['argument_size_in_bytes'] / 1e9:.3f} GB/dev")


def nbytes(tree) -> int:
    """The bytes of the tensors in ``tree``, as the dry-run counts them."""
    import repro_torch.launch.dryrun as DR
    return DR._nbytes(DR._flat(tree, []))


def largest(torch, sizes, run):
    """``(size, run(size))`` for the first of ``sizes`` (largest first)
    whose run the card holds; each refused size is freed and logged."""
    import gc
    for n in sizes:
        try:
            return n, run(n)
        except torch.cuda.OutOfMemoryError:
            pass
        # outside the handler: the error's traceback no longer holds the
        # refused run's tensors, so the cache can give their memory back
        gc.collect()
        torch.cuda.empty_cache()
        log(f"20. (b) {n} does not fit the card; trying the next")
    raise RuntimeError(f"none of {sizes} fits the card")


def launch_real_cells(torch, card, model, cfg):
    """Phase 20 (b): smollm-360m's train, prefill and decode cells run on
    the card at cut sizes, each beside its dry-run on ``meta`` at the same
    cut (a mesh of one entry naming the card): the dry-run's parameter
    and optimizer (or cache) bytes against the real tensors', the peak
    against the argument bytes, the profiler's device busy beside the
    roofline terms."""
    import numpy as np
    import repro_torch.launch.dryrun as DR
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.launch.shapes import ShapeDef
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import (make_train_step, model_params,
                                              unit_layout)
    one = virtual_mesh((1, 1), ("data", "model"))
    dev = model.device
    gen = np.random.default_rng(20)
    out = {}

    def tokens(b, s):
        return torch.from_numpy(gen.integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)

    def cell(kind, name, b, s, run, real):
        """Profile ``run`` (after a warm call) with the peak reset, then
        trace the same cut on meta and hold the two."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, busy = profile_ms(torch, run, reps=1)
        peak = torch.cuda.max_memory_allocated()
        c = cfg.with_(train_microbatches=1) if kind == "train" else cfg
        row = DR.roofline_row(LM_ARCH, c, ShapeDef(name, kind, s, b), one,
                              "1x1")
        mem = row["memory"]
        for key, want in real.items():
            require(mem[key] == want, f"20. (b) {name}: the dry-run's {key} "
                    f"{mem[key]:.0f} != the card's {want}")
        require(peak >= mem["argument_size_in_bytes"],
                f"20. (b) {name}: peak {peak} below the dry-run's argument "
                f"bytes {mem['argument_size_in_bytes']:.0f}")
        t_c, t_m = row["t_compute_s"] * 1e3, row["t_memory_s"] * 1e3
        dev_ms = sum(busy.values())
        out[name] = {"batch": b, "seq": s, "busy_ms": dev_ms,
                     "wall_ms": wall, "t_compute_ms": t_c,
                     "t_memory_ms": t_m, "peak": peak,
                     "args": mem["argument_size_in_bytes"],
                     "trace_s": row["compile_s"]}
        log(f"20. (b) {name} cut to {b} x {s}: device busy {dev_ms:.1f} ms "
            f"(host wall {wall:.1f} ms under the profiler) beside the "
            f"dry-run's t_compute {t_c:.1f} ms and t_memory {t_m:.1f} ms "
            f"(busy / max(terms) {dev_ms / max(t_c, t_m):.2f}; traced "
            f"{row['aten_ops']:,} aten ops in {row['compile_s']:.1f} s); "
            + ", ".join(f"{k} {v:,}" for k, v in real.items())
            + f" equal to the dry-run's; peak max_memory_allocated "
            f"{peak / 1e9:.2f} GB >= args "
            f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB; on {card}")

    # train_4k: one microbatch of rows of 4096
    opt = adamw(warmup_cosine(3e-4, 100, 10_000),
                moment_dtype=DR.moment_dtype_for(cfg))
    params = model_params(model)
    state = opt.init(params, unit_layout(model))
    step = make_train_step(model, opt, 1, accum_dtype=torch.bfloat16)
    real = {"params_bytes": nbytes(params),
            "opt_state_bytes": nbytes(state)}

    def train(b):
        batch = {"tokens": tokens(b, 4096), "labels": tokens(b, 4096)}
        cell("train", "train_4k", b, 4096,
             lambda: step(params, state, batch), real)
    largest(torch, LAUNCH_TRAIN_ROWS, train)
    del params, state, step
    torch.cuda.empty_cache()
    real = {"params_bytes": nbytes(list(model.parameters()))}

    # prefill_32k: the sequence cut
    def prefill(b):
        s = LAUNCH_PREFILL_SEQ
        cache = model.init_cache(b, s)
        batch = {"tokens": tokens(b, s)}
        cell("prefill", "prefill_32k", b, s, lambda: model.prefill(
            batch, cache), {**real, "cache_bytes": nbytes(cache)})
    largest(torch, LAUNCH_PREFILL_ROWS, prefill)
    torch.cuda.empty_cache()

    # decode_32k: the slots cut
    def decode(b):
        cache = model.init_cache(b, 32768)
        cache["index"].fill_(32767)
        toks = tokens(b, 1)
        cell("decode", "decode_32k", b, 32768, lambda: model.decode_step(
            toks, cache), {**real, "cache_bytes": nbytes(cache)})
    largest(torch, LAUNCH_DECODE_SLOTS, decode)
    torch.cuda.empty_cache()
    return out


def launch_phase(torch, card, dry_run: bool = True):
    """Phase 20: the launch layer on the card (see the module docstring);
    ``dry_run=False`` leaves (a), the four rows and ``--lower-only``, to
    phase 21 (a)."""
    import os
    import shutil
    import repro_torch.launch.dryrun as DR
    from repro_torch.checkpoint.checkpointer import save_checkpoint
    from repro_torch.checkpoint.reshard import elastic_restore
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import describe, make_test_mesh
    from repro_torch.models import build_model
    out = {}
    # (a) the dry-run: nothing allocated on the card; --lower-only's
    # subprocess runs beside the four rows traced here
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    d = launch_dir("lower_only")
    lower = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         LM_ARCH, "--lower-only"], cwd=d, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))) \
        if dry_run else None
    try:
        for arch, shape, multi in LAUNCH_CELLS if dry_run else ():
            row = DR.run_cell(arch, shape, multi,
                              mesh_factory=make_test_mesh)
            require(row["status"] == "ok" and row["t_compute_s"] > 0
                    and row["t_memory_s"] > 0 and row["coll_count"] == 0,
                    f"20. (a) {arch} {shape}: {row}")
            log(f"20. (a) dry-run {arch} {shape} on {row['mesh']}: "
                f"{row_terms(row)}; traced on meta in "
                f"{row['compile_s']:.1f} s")
        if lower is not None:
            _, err = lower.communicate(timeout=300)
    finally:
        if lower is not None and lower.poll() is None:
            lower.kill()
            lower.wait()
    if lower is not None:
        require(lower.returncode == 0, f"20. (a) --lower-only exited "
                f"{lower.returncode}: {err[-2000:]}")
        row = json.loads((d / "dryrun_report.json").read_text())[0]
        require(row["status"] == "ok", f"20. (a) --lower-only: {row}")
        log(f"20. (a) launch.train --lower-only: {row['arch']} "
            f"{row['shape']} on {row['mesh']}: {row_terms(row)} (the "
            f"subprocess done {time.perf_counter() - t0:.1f} s into (a))")
    torch.cuda.synchronize()
    require(torch.cuda.memory_allocated() == mem0,
            f"20. (a) the dry-run allocated on the card: "
            f"{torch.cuda.memory_allocated() - mem0} B")
    out["a_s"] = time.perf_counter() - t0
    log(f"20. (a) 5 dry-run rows ok, memory_allocated unchanged at {mem0} B "
        f"({out['a_s']:.1f} s)" if dry_run else
        "20. (a) the dry-run's rows: in phase 21 (a), beside its fake worlds")

    # (b) the dry-run against the card
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = build_model(cfg).init(0)
    out["cells"] = launch_real_cells(torch, card, model, cfg)
    out["b_s"] = time.perf_counter() - t0
    log(f"20. (b) three cells held against their dry-runs "
        f"({out['b_s']:.1f} s)")

    # (c) elastic_restore of a full-width bf16 checkpoint onto 2x4 x cuda:0
    t0 = time.perf_counter()
    host = {n: p.detach().cpu() for n, p in model.named_parameters()}
    like = {n: p.to("meta") for n, p in host.items()}
    del model
    torch.cuda.empty_cache()
    ck = launch_dir("ckpt")
    save_checkpoint(str(ck), 1, host)
    tree_bytes = nbytes(host)
    mesh = make_test_mesh()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    placed, _ = elastic_restore(str(ck), 1, like, mesh, cfg)
    torch.cuda.synchronize()
    used = torch.cuda.memory_allocated() - mem0
    require(abs(used - tree_bytes) <= 0.01 * tree_bytes,
            f"20. (c) placement took {used} B for a tree of {tree_bytes} B")
    shards = 0
    for n, p in host.items():
        sh = placed[n]
        require(torch.equal(sh.full().cpu(), p),
                f"20. (c) {n}: full() differs from the saved tree")
        for idx, s in zip(sh.indices(), sh.shards):
            require(s.device == torch.device("cuda", 0)
                    and torch.equal(s.cpu(), p[idx]),
                    f"20. (c) {n}: a shard is not its indices()' slice")
            shards += 1
    del placed, sh, s
    shutil.rmtree(ck)
    torch.cuda.synchronize()
    require(torch.cuda.memory_allocated() == mem0,
            "20. (c) the shards were not freed")
    out["c_s"] = time.perf_counter() - t0
    log(f"20. (c) elastic_restore of {LM_ARCH}'s bf16 checkpoint "
        f"({len(host)} leaves, {tree_bytes / 1e9:.3f} GB) onto "
        f"{describe(mesh)} x {mesh.devices.flat[0]}: {shards} shards "
        f"bit-equal to their indices()' slices, every full() equal; "
        f"{used / 1e9:.3f} GB on the "
        f"card ({used / tree_bytes:.4f} of the tree), freed after "
        f"({out['c_s']:.1f} s) on {card}")
    del host, like

    # (d) the serve CLI at full width
    t0 = time.perf_counter()
    res = serve.main(["--arch", LM_ARCH, "--requests",
                      str(LAUNCH_SERVE_REQUESTS), "--max_new_tokens",
                      str(LAUNCH_SERVE_TOKENS)])
    require(res["requests"] == LAUNCH_SERVE_REQUESTS and res["tokens"] ==
            LAUNCH_SERVE_REQUESTS * LAUNCH_SERVE_TOKENS,
            f"20. (d) the serve CLI served {res}")
    torch.cuda.empty_cache()
    out["d_s"] = time.perf_counter() - t0
    log(f"20. (d) serve CLI: {res['requests']} requests x "
        f"{LAUNCH_SERVE_TOKENS} tokens at full width in {res['ticks']} ticks "
        f"({res['steps']} batched decode steps, {res['seconds']:.2f} s) "
        f"({out['d_s']:.1f} s) on {card}")
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--lm", action="store_true",
                      help="run phases 1-2 and 12-13 only (the LM slice)")
    only.add_argument("--traversal", action="store_true",
                      help="run phases 1-3, 5 and 6 only (kernels 3 and 5 "
                      "and the traversal path)")
    only.add_argument("--per-dispatch", action="store_true",
                      help="run phases 1-2 and 9 only (kernels 8-10 over "
                      "the soc-LiveJournal1 graph)")
    only.add_argument("--resident", action="store_true",
                      help="run phases 1-4 only (kernels 1-4 and the "
                      "resident retrieval slice)")
    only.add_argument("--entries", action="store_true",
                      help="run phases 1-2, 10 and 11 only (kernels 11-14 "
                      "and the entries that launch them)")
    only.add_argument("--serve", action="store_true",
                      help="run phases 1-2 and 14 only (the serving path)")
    only.add_argument("--mutable", action="store_true",
                      help="run phases 1-2, 15 and 16 only (the mutable "
                      "plane over soc-LiveJournal1 and under serving)")
    only.add_argument("--partitions", action="store_true",
                      help="run phases 1-2 and 17 only (the partition "
                      "plane over soc-LiveJournal1)")
    only.add_argument("--families", action="store_true",
                      help="run phases 1-2 and 18 only (the MoE, SSM, "
                      "encoder-decoder and VLM families at full width)")
    only.add_argument("--train", action="store_true",
                      help="run phases 1-2, 19 and 19p only (training "
                      "smollm-360m at full width from the GraphAr lake)")
    only.add_argument("--launch", action="store_true",
                      help="run phases 1-2 and 20 only (the launch layer: "
                      "the dry-run, its roofline against the card, "
                      "elastic restore, the serve CLI)")
    only.add_argument("--sharded", action="store_true",
                      help="run phases 1-2 and 21 only (sharded execution "
                      "on a world of NCCL ranks, one a card, and the "
                      "dry-run on a fake world)")
    args = ap.parse_args()
    graph_only = next((f for f in ("traversal", "per-dispatch", "resident",
                                   "entries", "mutable", "partitions")
                       if getattr(args, f.replace("-", "_"))), None)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the parameters are trainable: every phase but the train step (which
    # turns gradients on for itself) runs the model's inference routes
    torch.set_grad_enabled(False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"1. device: {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_select import kernel as BK
    from repro_torch.kernels.flash_attention import kernel as AK
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.rle_filter import kernel as FK
    from repro_torch.kernels.traversal import kernel as TK
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    log(f"2. build: {time.perf_counter() - t0:.1f} s ({lib.name})")
    report = lib.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log(f"   ptxas: {line.strip()}")
    flash_build_check(report, lib)
    spill_free(report, "_per_dispatch_cu_", "a per-dispatch kernel")
    spill_free(report, "_bitmap_scatter_cu_", "a resident fused kernel")
    spill_free(report, "_single_range_cu_", "a single-range kernel")
    spill_free(report, "_rle_filter_cu_", "the RLE-label kernel")
    spill_free(report, "_bitmap_select_cu_", "the selection kernel")

    wrappers = {"gather_decode": PK.gather_decode,
                "fused_gather_decode_bitmap_batch":
                    PK.fused_gather_decode_bitmap_batch,
                "cond_bitmap": LK.cond_bitmap,
                "fused_gather_decode_filter_bitmap_batch":
                    LK.fused_gather_decode_filter_bitmap_batch,
                "khop_scan": TK.khop_scan, "two_hop": TK.two_hop,
                "count_hop": TK.count_hop,
                "delta_decode": PK.delta_decode,
                "fused_decode_bitmap_batch": PK.fused_decode_bitmap_batch,
                "fused_decode_filter_bitmap_batch":
                    LK.fused_decode_filter_bitmap_batch,
                "bitmap": PK.bitmap,
                "fused_decode_bitmap": PK.fused_decode_bitmap,
                "rle_to_bitmap": FK.rle_to_bitmap,
                "bitmap_select": BK.bitmap_select,
                "flash_attention": AK.flash_attention,
                "seed_words": TK.seed_words,
                "expand_words": TK.expand_words,
                "merge_hop": TK.merge_hop}

    def drive(phase, *args, **kwargs):
        """Run one slice phase with every launch count set to 0 just
        before it; returns its result and the counts read just after."""
        for w in wrappers.values():
            w.launches = 0
        out = phase(*args, **kwargs)
        return out, {n: w.launches for n, w in wrappers.items()}

    rows, counts, serve, train = [], [], None, None
    lm_only = args.lm or args.serve or args.families or args.train \
        or args.launch or args.sharded
    if not graph_only and not args.serve and not args.families \
            and not args.train and not args.launch and not args.sharded:
        # the LM slice first: its host timings come before any profiler in
        # the process (phases 5 and 8 profile); its own profile runs last
        t0 = time.perf_counter()
        lm, a_launches = drive(lm_phase, torch, card)
        require(a_launches["flash_attention"] > 0,
                f"the flash kernel never launched: {a_launches}")
        log(f"12. lm: {LM_ARCH} forward, loss, prefill and decode checked, "
            f"launches {a_launches} ({time.perf_counter() - t0:.1f} s) on "
            f"{card}")
        counts.append(a_launches)

        t0 = time.perf_counter()
        rows = flash_kernel_phase(torch)
        log(f"13. flash kernel: equal to attention_ref within tolerance "
            f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()

    if not graph_only and not args.serve and not args.lm and not args.train \
            and not args.launch and not args.sharded:
        # the rest of the LM stack, before any profiler in the process
        t0 = time.perf_counter()
        _, f_launches = drive(families_phase, torch, card)
        require(f_launches["flash_attention"] > 0,
                f"kernel 15 never launched in phase 18: {f_launches}")
        log(f"18. families: deepseek-moe-16b, llama-3.2-vision-11b, "
            f"mamba2-2.7b and whisper-small at full width, checks (a)-(e) "
            f"pass, launches " + ", ".join(
                f"{n} {c}" for n, c in f_launches.items() if c)
            + f" ({time.perf_counter() - t0:.1f} s) on {card}")
        counts.append(f_launches)
        rows += family_flash_rows(torch)
        torch.cuda.empty_cache()

    if not graph_only and not args.lm and not args.families \
            and not args.train and not args.launch and not args.sharded:
        # the serving path, before any profiler in the process too
        t0 = time.perf_counter()
        serve = serve_phase(torch, card, drive)
        s_launches = serve["launches"]
        require(all(s_launches[n] for n in SERVE_KERNELS),
                f"a kernel of the serving path never launched: "
                f"{s_launches}")
        log(f"14. serve: checks (a), (b) and (c) pass, launches "
            + ", ".join(f"{n} {c}" for n, c in s_launches.items() if c)
            + f" ({time.perf_counter() - t0:.1f} s) on {card}")
        counts.append(s_launches)

    if not graph_only and not args.lm and not args.families \
            and not args.serve and not args.launch and not args.sharded:
        # training, before any profiler in the process; on phase 14's lake
        t0 = time.perf_counter()
        train, r_launches = drive(train_phase, torch, card,
                                  serve["lake"] if serve else None)
        require(all(r_launches[n] for n in TRAIN_KERNELS)
                and not r_launches["flash_attention"],
                f"the label filter kernel never launched in phase 19, or "
                f"the flash kernel did: {r_launches}")
        log(f"19. train: checks (a)-(f) pass, launches " + ", ".join(
            f"{n} {c}" for n, c in r_launches.items() if c)
            + f" ({time.perf_counter() - t0:.1f} s) on {card}")
        counts.append(r_launches)
        torch.cuda.empty_cache()

    if not lm_only:
        graph_rows, graph_counts = graph_phases(torch, drive, wrappers, card,
                                                graph_only)
        rows = graph_rows + rows
        counts += graph_counts
    if graph_only in (None, "mutable") and not lm_only:
        t0 = time.perf_counter()
        m_launches = serve_mutable_phase(torch, card, serve,
                                         drive)["launches"]
        require(all(m_launches[n] for n in SERVE_MUTABLE_KERNELS),
                f"a kernel of ingest while serving never launched in the "
                f"pipelined drain: {m_launches}")
        log(f"16. serve mutable: checks (a) and (b) pass, the durable "
            f"compaction committed, launches over the pipelined drain "
            + ", ".join(f"{n} {c}" for n, c in m_launches.items() if c)
            + f" ({time.perf_counter() - t0:.1f} s) on {card}")
        counts.append(m_launches)
    if not graph_only and not args.serve and not args.families \
            and not args.train and not args.launch and not args.sharded:
        t0 = time.perf_counter()
        lm_profile_phase(torch, lm)
        if serve is not None:
            serve_profile_phase(torch, serve)
        log(f"12p. lm profile ({time.perf_counter() - t0:.1f} s)")
    if train is not None:
        train_profile_phase(torch, train, card)
    lake = serve["lake"] if serve else None
    if not graph_only and not args.lm and not args.serve \
            and not args.families and not args.train and not args.sharded:
        # the launch layer: (b) profiles, and runs the card's largest
        # batches with the earlier phases' models freed
        lm = serve = train = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        # (a), the dry-run's rows on meta, runs in phase 21 (a) when phase
        # 21 follows
        launch_phase(torch, card, dry_run=args.launch)
        log(f"20. launch: (a)-(d) pass ({time.perf_counter() - t0:.1f} s) "
            f"on {card}")
    if not graph_only and not args.lm and not args.serve \
            and not args.families and not args.train and not args.launch:
        # sharded execution last: its ranks are processes of their own,
        # each counting its own launches; the counts are their sums
        lm = serve = train = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.append({**{n: 0 for n in wrappers},
                       **sharded_phase(torch, card, lake)})
        log(f"21. sharded: (a) and (b) pass ({time.perf_counter() - t0:.1f} "
            f"s) on {card}")
    for r in rows:
        # a row named "kernel@shape" times a kernel at another shape
        r["launches"] = sum(c[r["name"].split("@")[0]] for c in counts)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def graph_phases(torch, drive, wrappers, card, only=None):
    """Phases 3-11, 17 and 15 over the soc-LiveJournal1 graph and
    ``ldbc_like(40)`` (``only="traversal"``: phases 3, 5 and 6;
    ``only="per-dispatch"``: phase 9; ``only="resident"``: phases 3 and 4;
    ``only="entries"``: phases 10 and 11; ``only="mutable"``: phase 15;
    ``only="partitions"``: phase 17);
    returns their kernel rows and the launch counts of their slice
    phases."""
    adj, vt, batches, truth = build_graph()
    if only == "partitions":
        rows, launches = partition_phases(torch, drive, adj, vt, batches, {},
                                          card)
        return rows, [launches]
    if only == "mutable":
        return [], [mutable_phases(torch, drive, adj, vt, batches, truth,
                                   card)]
    if only == "per-dispatch":
        return per_dispatch_rows(torch, adj, vt, batches), []
    if only == "entries":
        rows, e_launches = entry_phases(torch, drive, adj, truth, batches, {},
                                        card)
        return rows, [e_launches]
    traversal_only = only == "traversal"
    t0 = time.perf_counter()
    rows = kernel_phase(torch, adj, vt, batches)
    log(f"3. kernels: the four retrieval kernels equal to their plain "
        f"versions ({time.perf_counter() - t0:.1f} s)")

    oracle = {}
    if not traversal_only:
        t0 = time.perf_counter()
        results, launches = drive(slice_phase, torch, adj, vt, batches, card,
                                  oracle)
        require(all(launches[n] for n in RETRIEVAL_KERNELS),
                f"a retrieval kernel never launched: {launches}")
        log(f"4. slice: {len(results)} configurations equal to the numpy "
            f"oracle, launches {launches} ({time.perf_counter() - t0:.1f} "
            f"s) on {card}")
        if only == "resident":
            return rows, [launches]

    t0 = time.perf_counter()
    trav, t_launches = drive(traversal_slice_phase, torch, adj, vt, card)
    require(all(t_launches[n] for n in TRAVERSAL_KERNELS),
            f"a traversal-path kernel never launched: {t_launches}")
    log(f"5. traversal: {len(trav['k_hop'])} k_hop configurations, "
        f"two_hop_pac and frontier_edge_counts equal to their oracles, "
        f"launches {t_launches} ({time.perf_counter() - t0:.1f} s) "
        f"on {card}")

    t0 = time.perf_counter()
    rows += traversal_kernel_phase(torch, trav["inputs"])
    log(f"6. traversal kernels: all three equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    if traversal_only:
        return rows, [t_launches]

    t0 = time.perf_counter()
    pd, p_launches = drive(per_dispatch_phase, torch, adj, vt, batches, card,
                           oracle)
    require(all(p_launches[n] for n in PER_DISPATCH_KERNELS),
            f"a per-dispatch kernel never launched: {p_launches}")
    log(f"7. per-dispatch: {len(pd)} configurations equal to phase 4's "
        f"numpy oracle, launches {p_launches} "
        f"({time.perf_counter() - t0:.1f} s) on {card}")

    t0 = time.perf_counter()
    ldbc, l_launches = drive(ldbc_phase, torch, card, wrappers)
    for regime, names in LDBC_KERNELS.items():
        ran = ldbc[f"{regime}_launches"]
        require(all(ran[n] for n in names),
                f"an LDBC kernel never launched under the {regime} "
                f"route: {ran}")
    log(f"8. ldbc: {len(ldbc['queries'])} query runs equal to the numpy "
        f"engine and to acero, launches {l_launches} "
        f"({time.perf_counter() - t0:.1f} s) on {card}")
    rows.append(bi2_count_hop_row(torch, ldbc["bi2_inputs"]))

    rows += per_dispatch_rows(torch, adj, vt, batches)

    e_rows, e_launches = entry_phases(torch, drive, adj, truth, batches,
                                      oracle, card)
    k_rows, k_launches = partition_phases(torch, drive, adj, vt, batches,
                                          oracle, card)
    m_launches = mutable_phases(torch, drive, adj, vt, batches, truth, card)
    return rows + e_rows + k_rows, [launches, t_launches, p_launches,
                                    l_launches, e_launches, k_launches,
                                    m_launches]


def mutable_phases(torch, drive, adj, vt, batches, truth, card):
    """Phase 15 (counted), last of the soc-LiveJournal1 phases since it
    compacts the adjacency in place; returns its launch counts."""
    t0 = time.perf_counter()
    _, launches = drive(mutable_phase, torch, adj, vt, batches, truth, card)
    require(all(launches[n] for n in MUTABLE_KERNELS),
            f"a kernel of the mutable plane never launched: {launches}")
    log(f"15. mutable: every read equal to the CSR oracle while pending "
        f"and after the compaction, launches " + ", ".join(
            f"{n} {c}" for n, c in launches.items() if c)
        + f" ({time.perf_counter() - t0:.1f} s) on {card}")
    return launches


def entry_phases(torch, drive, adj, truth, batches, oracle, card):
    """Phases 10 (counted) and 11; returns phase 11's kernel rows and
    phase 10's launch counts."""
    t0 = time.perf_counter()
    ent, e_launches = drive(entries_phase, torch, adj, truth, batches,
                            oracle, card)
    require(all(e_launches[n] for n in ENTRY_KERNELS),
            f"an entry kernel never launched: {e_launches}")
    log(f"10. entries: ids_to_bitmap, decode_range_to_bitmap, "
        f"rle_to_bitmap, select_from_pages and {len(ent['numeric'])} "
        f"numeric-filtered retrievals equal to the numpy oracle, launches "
        f"{e_launches} ({time.perf_counter() - t0:.1f} s) on {card}")

    t0 = time.perf_counter()
    rows = entry_kernel_phase(torch, adj, ent["inputs"])
    log(f"11. entry kernels: all four equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    return rows, e_launches


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--trace-cell"]:
        sys.exit(trace_cell_main(sys.argv[2:]))
    sys.exit(main())
