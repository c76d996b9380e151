#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's exact query path, device-resident kNN
loop, index builder, serving lifecycle, paged storage tier,
cluster-sharded executor, replica-set serving frontend and LM serving
path (dense, then the moe, ssm, hybrid, vlm and encdec families), the
paper's baselines beside the executor, LM training, and LM prefill and
decode over ranks on one CUDA card (or more, for the sharded phase's
mesh, the frontend's replicas and the ranks of the training step and of
serving).

    python3 chip_smoke.py [--n 1000000] [--batches 3] [--linf-n 200000]
                          [--seed 0] [--sharded-only | --frontend-only |
                          --families-only | --train-only | --dp-only |
                          --fsdp-only | --tp-only | --serve-tp-only]

Phases, each printing lines that start with its name:

1. device   the card's name, count and power limit (nvidia-smi); then
            env: the table of every REPRO_* knob (python -m
            repro_torch.env); REPRO_TUNE_CACHE points at a file under
            TMPDIR, so the tile table is the shipped one alone;
2. build    nvcc builds the twelve kernel entry points (and the kNN
            loop's graph functions) from the seven sources in
            src/repro_torch/kernels/csrc (one process each, in parallel),
            and prints each entry function's registers, shared memory
            and spills (ptxas -v, in the same build's log); in the whole
            run the build runs in a thread beside main's host work (the
            rows, the host index, the queries and the host index's
            answers, none of which launches a kernel), and main's
            snapshot waits for it;
3. main     GaussMix (n rows, d = 8, seed 0) -> host LIMSIndex(K=64, m=3,
            N=20, degree 8) -> LIMSSnapshot.build on the card ->
            range (0.01% selectivity) and kNN (k = 10) batches of 64
            queries (--batches of each kind, default 3), with
            REPRO_COMPACT on and off, the kNN batches by
            the device-resident loop (REPRO_KNN_DRIVER's auto on a card;
            every kNN line prints its driver).  Every result must
            equal the host index's, ids and f64 distances; one batch of
            each kind is checked against an f64 brute-force scan.  The
            launch counters are zeroed just before the snapshot build
            and read after the last batch: each kernel must have run;
4. E        the certified rank-error bound covers the error of the
            card's pdist_rankeval at every data point, and E certified
            by the rankeval kernel equals E certified by its plain
            version group for group;
5. kernels  each kernel against its plain PyTorch version at the main
            path's shapes, bit for bit (range_filter: mask and counts;
            rankeval and pdist_rankeval also with NaN, +-inf and 1e30
            distances and query coordinates, where a NaN ranks 0 in ring
            0), timed with CUDA events beside its plain version, its bound
            and (pdist only) torch.cdist(q, p)**2; pdist, range_filter and
            rankeval also print their issue floor (the fixed f32 operation
            order's instructions at the SMs' clock) as a note, and pdist a
            second line at the planner's (64, 192); rankeval and
            pdist_rankeval print bare launches (CUDA events), their SASS
            instruction count (cuobjdump), and pdist_rankeval its device
            time replayed from a CUDA graph beside the same at (1, 1) (the
            launch floor) and the host cost of each step of its wrapper;
6. lp       the reduced-precision filter plane (REPRO_ROWS_DTYPE) on
            main's host index, batches and host answers, for bf16 and
            then f16: the snapshot built on the card under the knob
            (lp_eps, the plane's bytes; the plane equal to the host's
            rounding of the rows and lp_eps to lp_quant_eps recomputed
            on the host), main's 3 range batches with REPRO_COMPACT on
            and off and 3 kNN batches, every id and f64 distance equal
            to the host index's; q/s and ball-filter candidates per
            query beside main's f32 ones from the same run; the launch
            counters zeroed before the build and read after the
            batches: every pdist and range_filter launch over the plane
            took the bf16 / f16 entry (f32 pdist only at the planner's
            (64, G) pivot shape, no f32 range_filter at all); the two
            kernels' bf16 / f16 rows at (64, P, d 8), equal to their
            plain versions bit for bit (range_filter: mask and counts),
            with bounds at 2-byte points; then f32 once more (turns
            f32, bf16, f16, f32), so the host's drift shows;
6b. knn_loop the device-resident kNN loop (REPRO_KNN_DRIVER=loop: one
            CUDA graph a batch, a WHILE conditional node over one
            captured round, built by csrc/graph_loop.cu) on main's
            snapshot: (a) main's 3 kNN batches through a fresh
            QueryExecutor a turn, turns loop, rounds, loop, rounds, each
            from an empty cache: answers equal to the host index's; q/s,
            rounds and host_syncs a batch, graph captures and their ms,
            launches (loop: pdist_rankeval = the rounds, knn_loop_cond =
            the rounds, pdist = 2 a batch; rounds: pdist_rankeval = the
            rounds), memory_allocated / memory_reserved after each
            batch; peak reserved under the loop at most rounds' + 4 GB,
            the loop's second turn within 64 MB of its first, reserved
            back to its start once the executor is dropped; (b) 4
            queries with the snapshot's filter margin widened to 8 (the
            largest k-th distance + BALL_ABS), a looser certified bound
            that forces >= 3 rounds (4 at these queries; the margin
            makes nearly every row a candidate, so the batch's host
            refinement takes ~0.3 s a query), beside a 1-round batch:
            equal device-to-host copies (torch.profiler), the answers
            checked from the last profiled call; (c) batch sizes 64
            down to 1 on one executor: 7 graph keys, 4 kept, reserved
            no higher after the first four; pdist_rankeval (64, G) and
            pdist (64, P) bit for bit against their plain versions on
            the loop's buffers; (d) ShardedExecutor on cuda:0 named 4
            times, turns loop, rounds over 2 batches (a CUT), the same
            checks with launches 4 x; then knn_loop_cond's kernel row
            (the condition alone in a WHILE graph against its plain
            version, all open / all done, max_rounds 1, 3, 64);
6c. tune    the tile autotuner (repro_torch/kernels/autotune.py) with
            its cache in a temporary file: (a) warm at the quick buckets
            (every kernel and body: sql2, l1, linf, bf16, f16) and at
            main's five (pdist and range_filter at (64, 4,607,872, d 8),
            range_filter at (64, 1,048,576), pdist_rankeval at (64,
            192) C 9, rankeval at (192, 71,998) C 9): every candidate
            tile's outputs bit-equal to the plain version's, each entry
            with its tiles, us and static us; (b) the four main kernels
            at main's shapes, tuned and REPRO_AUTOTUNE=off in turns on,
            off, off, on: equal outputs, wrapper and device (a CUDA
            graph of 20 calls) ms; (c) one range and one kNN batch of
            main's through a fresh executor under the shipped table,
            equal to the host index;
6d. roof    roofline.pipeline's report on the card at main's
            snapshot and first batch (n = 1,000,000, batch 64, the
            shapes main launches): each stage's counted bytes and flops
            (roofline.analysis, the counts every kernel row's bound
            comes from), its time, and its utilization against the
            H100's data sheet; one above 1.05 is a wrong count and
            fails;
7. builder  the device index builder (LIMSIndex(backend="device")) at
            the same n: (a) GaussMix L2, held against main's host index
            (structures, then every range and kNN batch through a
            snapshot of it); (b) Skewed L1 and (c) Skewed L-infinity,
            each against a host build of its own (structures, 64 range
            and 64 kNN queries, query 0 against an f64 brute-force
            scan; the host builds in spawned worker processes, all four
            started before (a), and the queries too, two a
            part); structure differences pass only at ties within one
            ulp of the host's f64 distances.  The launch counters are
            zeroed before each build: pdist_l1 and pdist_linf must have
            run exactly once in (b) and (c), pivot_columns' one grouped
            launch (each cluster's m pivots against its own n_max member
            slots); their kernel rows are timed at that shape (batched
            torch.cdist p=1 / p=inf as the library yardstick), with a
            printed line at the reference's chunked launch shape (48,
            16 n_max); (e) L1 and L-infinity at d = 256 on GaussMix, n =
            20,000, checked as (b) and (c) are (a width the first
            pdist_lp.cu could not launch); (d) retrain: the largest
            cluster of the (a) index and of main's host index loses 1%
            of its rows and gains as many; a device retrain of one and a
            host retrain of the other answer identically, and "auto"
            picks the device for it.  (c) runs at --linf-n rows (default
            200,000, a cut that keeps the whole script within twice the
            query path's time); --linf-n 1000000 runs it uncut.
8. serving  the serving lifecycle (repro_torch.serving) on main's host
            index as the builder leaves it, counters zeroed before and
            read after (each query-path kernel must run): (a)
            ServingEngine(refresh_every=2,000) on the card, 2 rounds of
            1,000 inserts (data rows + N(0, 0.003), seed 5) and 1,000
            deletes of stored rows, each round's refresh followed by a
            range and a kNN batch equal to the host index's answers and
            64 of its inserted rows found, 64 of its deleted rows not
            found, at r = 1e-9 (all 2,000 in the snapshot's live ids; a
            CUT: line says so), REPRO_COMPACT at its default "on";
            refresh s per generation, inserts/s, deletes/s, engine q/s
            and memory after each generation; (b) retrain_cluster of
            the largest cluster: "auto" must take the device, publish a
            generation and answer as the host does; (c)
            async_refresh=True: a query thread runs 8 range and 8 kNN
            batches, each grabbing engine.executor once and held to an
            f64 brute-force scan of that executor's snapshot's live
            rows, while the main thread applies 2 x 2,000 mutations;
            batch p50/p99 with a refresh in flight (the traced
            engine.snapshot_build spans) and with none, and the kernel
            table, emptied first, loaded once; (d) Monitor (manual
            tick) + MonitorDaemon(retrain="auto"): every
            executor.rank_err_ratio gauge <= 1 after real batches and no
            rank_drift finding, then the largest cluster's gauge at 0.9
            gives one retrain_auto, a generation and host answers; (e)
            q/s with REPRO_OBS on and off (a warm-up batch, then turns
            on, off, off, on),
            equal host_syncs, kernels.<name>.launches equal to _cuda's
            tally, complete profiles, and the profile and trace rings
            held at their caps.  memory_allocated after the last
            generation must not exceed the 2nd generation's plus one
            snapshot;
9. paged    the paged storage tier (repro_torch.storage) on main's
            snapshot and index, counters zeroed before (b)'s paged
            batches and read after (c) (each query-path kernel must
            run): (a) main's
            snapshot, spilled right after main's kernel rows to a
            temporary directory at 4,096-byte pages, loads cold
            (store=True, a 4,096-page cache: 16 MB, every batch evicts)
            and resident; spill s, load s, bytes on disk, and the paged
            snapshot's device bytes, which must be at most the
            resident's less its rows; (b) the first of main's batches
            of each kind (a CUT) through the resident executor and the
            paged one with REPRO_PREFETCH off and async (REPRO_CACHE_PIN
            on; under REPRO_REAL_IO=1 the OS page cache is dropped
            first), each kind from a cold page cache: ids and f64
            distances equal to the resident path's and the host
            index's; q/s, pages per query, hit rate, evictions, rows
            gathered and host_syncs; the off turn split into masks,
            IO planning, pins, page fetch, gather, cast + copy,
            kernels and the rest; the
            pdist and range_filter launches tallied by (nq, np), and
            each held to its plain version (torch.equal) at the gathered
            shape launched most; (c) ServingEngine(storage="paged") on
            main's host index: 1,000 inserts and 1,000 deletes, a
            refresh (extents reused), a range batch held to the host
            index, compact() (bytes reclaimed), and a cold start with
            ServingEngine.from_spill, its kNN batch held to the host
            index;
10. sharded the cluster-sharded executor (repro_torch.sharding,
            ShardedExecutor) on main's snapshot, loaded resident from
            paged:'s spill, over a mesh of 4 shards: min(4, count)
            distinct cards in turn where the machine has more than one,
            else cuda:0 named 4 times (the line says which).  Building
            the executor must grow memory_allocated on the snapshot's
            card by under 1 MB (on that card its shards are views);
            every kernel of the sharded path equals its plain version
            bit for bit at shard 0's local shapes: pdist and
            range_filter at (64, P/4), pdist_rankeval and the pivot
            pdist at (64, G/4); (a) turns sharded,
            single-device, single-device, sharded (REPRO_COMPACT=off:
            the sharded path does not compact) over main's 3 range and 3
            kNN batches (turns 3 and 4 a CUT of 2), every id and f64
            distance equal to main's host answers, q/s of each turn; the
            counters zeroed before turns 1 and 2 and read after: each of
            pdist, range_filter and pdist_rankeval launched 4 x as often
            in the sharded turn, kNN rounds equal batch for batch and
            host_syncs where both turns ran one driver (auto: the loop
            on one card, the host-driven rounds on a mesh over several,
            where REPRO_KNN_DRIVER=loop must raise), the launches
            tallied by (nq, np); (b) 3 shards
            (K padded 64 -> 66), (c) REPRO_ROWS_DTYPE=bf16 with
            REPRO_COMPACT=on at 4 shards (no 2-byte entry point may
            launch: the sharded filter streams f32 rows), each over 2 of
            main's batches of each kind (a CUT), equal to the host; (d)
            a store-backed ShardedExecutor over the spill, 1 batch of
            each kind from a cold cache, results, last_io, last_knn and
            cache stats equal to the paged single-device executor's; (e)
            ServingEngine(mesh=...) on main's host index: 1,000 inserts
            and 1,000 deletes, a refresh (its standby sharded on the same
            mesh), a range and a kNN batch equal to the host index.
            --sharded-only runs phases 1, 2 and 10 alone (main's index,
            batches, host answers and spill built first, unprinted and
            unchecked), for a run of the mesh on four cards
            (chiprun --chips 4); its last line is the same;
11. frontend replica-set serving (repro_torch.serving: ServingFrontend,
            PlanRouter, ReplicaSet) through ServingEngine.frontend(
            n_replicas=4, max_batch=64, slo_ms=5) on a copy of main's
            host index taken before the builder changes it: (a) a
            4-replica set over its snapshot with the default devices
            (cuda:0 four times on one card, one replica a card on
            several) adds 0 B on the snapshot's card, every replica
            tensor sharing the snapshot's storage, and prints the bytes
            copied to other cards; (b) 64 submitter threads, thread j
            sending row j of each of main's range batches, then of its
            kNN batches (k = 10), every answer equal to main's host
            answers (ids and f64 distances); batches, mean batch size,
            coalesced batches, queue wait and latency p50/p99 and q/s
            from metrics(), and one plan a batch on the routing
            executor; (c) 32 range and 32 kNN submitters at once (a CUT
            of 2 batches), no batch mixing kinds; (d) the launch
            counters zeroed before (b) and read after: pdist_rankeval =
            batches + range sub-batches + kNN sub-batch rounds,
            range_filter = range sub-batches, pdist = kNN batches + kNN
            sub-batches; every (nq, np) the router launched, and pdist,
            range_filter and pdist_rankeval bit for bit against their
            plain versions at their three most frequent ragged shapes;
            router.replica_spread; (e) paused at max_queue=64: the 65th
            submit raises FrontendOverload at once, shed = 1, and the 64
            drain exactly after resume(); (i) q/s through the frontend
            against the engine's direct batches, turns frontend, direct,
            direct, frontend (a CUT of 2 batches of each kind), the
            ratios printed and no gain claimed; (f) 1,000 inserts, 1,000
            deletes and a refresh: the next batch rebuilds the replica
            set once and answers as the host index does after the
            updates; then every cluster owned by replica 0 and a
            Monitor (adopted by the frontend, its daemon routed to the
            frontend's router) ticked by hand after each kNN batch until
            the heat-skew detector fires and the daemon rebalances,
            heat_skew before and after, answers equal throughout; (g) a
            frontend over ServingEngine.from_spill (4 replicas on one
            page cache): one range and one kNN batch from a cold cache
            equal to main's answers, the cache's stats, last_io summed
            over replicas and what the per-thread pinned staging
            buffers cost; (h) repro_torch.obs.report.main(--demo
            --health --device cuda, JSON, Prometheus and Chrome trace):
            the files parse and the health report holds a finding, the
            obs mode restored after.  --frontend-only runs phases 1, 2
            and 11 alone (as --sharded-only does), so that a machine
            with four cards runs one replica on each;
12. lm      the dense LM at Llama-3-8B widths (configs/llama3_8b.py),
            random weights from --seed: (a) float32 at a cut depth of 4
            layers, batch 2, 64-token prompts: prefill of tokens[:, :-1]
            and a decode step of tokens[:, -1] give forward_seq's logits
            at -2 and -1, and the forward with the flash kernel gives the
            forward with the plain dense_attention, each within 4e-3 of
            the logits' max |value|; the plain path's own deviations and
            a control whose attention runs on bf16-rounded q, k, v are
            printed, and the control must miss the bar; (b) bfloat16 at
            full depth (32 layers): 4 requests of 2,000-token prompts,
            prefill and 32 greedy decode steps, with prefill and decode
            rates and peak memory.  The launch counters are zeroed just before the
            prefill: flash_attention must launch exactly once per layer,
            and its layer-0 and layer-31 outputs must equal the f64
            answer on the same q, k, v within one bf16 ulp (rtol = atol
            = 2**-7), and lie nearer it than the plain version wherever
            they part from the plain version by more than that; then the
            body each type and head width takes (bf16 at D 64, 80, 112
            and 128: the tensor cores, 80 and 112 in tiles padded to 128
            columns; the check fails otherwise), the HGMMA count of the
            flash library's SASS (HGMMA must show in flash_tc_kernel at
            D 80, 112 and 128), its kernel row at the prefill's padded
            shape (bound: the function's own flops, one bf16 pass over
            the real rows, at the tensor cores' rate; flash_work), with
            scaled_dot_product_attention as the library yardstick, and an
            f32 kernel-vs-plain check at a small shape;
13. retrieval the twin of examples/retrieval_serving.py steps 1-4: an
            encoder LM (4 layers, d 256, f32) embeds 5,000 32-token docs
            on the card (its attention through the flash kernel), a host
            LIMSIndex(K=100, m=3, N=20) indexes them, and BatchedLIMS on
            the card answers 16 kNN queries (k = 5), identical to the host
            index and to an f64 brute-force scan.  Counters are zeroed
            before the encoding: flash_attention and the query kernels
            must run;
14. families the five non-dense LM families (--families-only runs
            phases 1, 2 and this one): for each of mixtral-8x7b,
            kimi-k2-1t-a32b, llava-next-34b, mamba2-780m, zamba2-2.7b
            and seamless-m4t-large-v2, (a) float32 at full width and a
            cut depth (kimi also 64 of its 384 experts): prefill and
            greedy decode through zoo.prefill_fn / zoo.decode_fn, held
            to a teacher-forced full-sequence pass over the prompt and
            the generated tokens (logits within 4e-3 of their max
            |value|; every greedy token equal to the teacher-forced
            argmax wherever that row's top-2 margin exceeds twice the
            row's max |diff|); mixtral's 4,100-token prompt passes its
            4,096 window, so the decode steps write ring slots; (b)
            bfloat16 at full width (mixtral 8 of 32 layers, kimi 1 of
            61, llava 16 of 60, the rest at full depth; each cut on a
            "families: CUT:" line): 2 or 4 requests of 2,000 tokens
            (mixtral 6,000; llava 2,304 prefix embeddings + 1,792
            tokens; seamless 2,000 source frames and one prime token),
            prefill and 32 greedy decode steps (kimi 16), with
            parameters, bytes, init s, prefill tokens/s and decode
            ms/step (CUDA events, after a warm-up at the served shape:
            medians of 5 prefills and of the steps, with max / min),
            peak memory; the counters are zeroed
            just before the prefill and flash_attention must launch
            once per attention layer (zamba2: per shared-block call;
            seamless: encoder, decoder and cross; mamba2: never); then
            the kernel's rows at D 80 (zamba2), D 112 (kimi), window
            4,096 (mixtral), non-causal (seamless's encoder) and the
            cross-attention, on the operands the main path gave it,
            held to flash_attention_ref and the f64 answer (within the
            bar 2**-7 widened by exactly the plain version's measured
            f32 score rounding, 2 x err x max |v|, which the plain
            version with its scores rounded to bf16 must fail) and timed
            beside SDPA and the bound of flash_work;
15. baselines the paper's comparison (the twin of benchmarks/bench_range.py
            and bench_knn.py; after frontend:): GaussMix at n = 200,000
            (a CUT of --n: BallTree and ZMIndex build, and every
            baseline queries, in Python), d = 8, one batch of 64 range
            (0.01% selectivity) and kNN (k = 10) queries through the
            host LIMSIndex (K 64, m 3, N 20, degree 8), LinearScan,
            MLIndex (K 64), NLIMS, ZMIndex (range only) and BallTree,
            and the port's QueryExecutor on the card over a snapshot of
            the host index: every answer equal to the host index's (ids
            and f64 distances; kNN ids as sets at ties); a row per
            method (build s, q/s, pages and distance computations per
            query); the counters zeroed before the snapshot build and
            read after the executor's batches (pdist, rankeval,
            range_filter and pdist_rankeval must run), and the four
            kernels bit for bit against their plain versions at this
            phase's shapes;
16. train   (last; --train-only runs phases 1, 2 and this one) the twin
            of examples/train_lm.py: first a reduced llama3-8b step in
            f32 (selective remat, 2 microbatches) on the card against
            the CPU port's; then llama3-8b at full width in bf16 cut to
            4 of 32 layers (the CUT line prints parameters and bytes),
            train_4k's seq 4,096 at a global batch of 8 in 4
            microbatches, remat "selective", AdamW: every parameter's
            gradient (each layer's slice) finite and nonzero on one
            microbatch, wq / wk / wv included (the autograd Function
            gives the flash kernel the plain attention's gradient);
            (a) 5 steps on TokenPipeline's batches: the loss falls,
            flash_attention launches 2 x layers x microbatches a step
            and no other kernel runs, ms a step (median, min, max),
            tokens/s, peak memory, the device-busy share and top device
            operations of one more step under torch.profiler; the
            Function's q / k / v gradients at one layer's shape (2, 32,
            4096, 128) x (2, 8, 4096, 128) against autograd through
            plain_attention; row 5-train (the kernel at the training
            shape held to its plain version and the f64 answer, beside
            SDPA and flash_work's bound); the dry-run's memory model
            (launch.dryrun.analyze_cell at this configuration on a mesh
            of one card) printed beside (a)'s measured peak, with their
            ratio (a reading, not a check); (b) run_training over 5
            steps, a checkpoint every 3 in TMPDIR (keep 1), a failure
            injected at step 4: it ends at step 5 with one restart (the
            replay of step 3 from the step-3 checkpoint; three saves:
            steps 0, 3 and 5), and its losses, first pass and replay,
            equal (a)'s within 2**-7;
            (c) 3 steps each of Adafactor and 8-bit Adam (the last step's
            loss reads step 1's update), then every parameter and
            optimizer-state leaf finite and every parameter leaf drawn
            at random moved.
17. dp      (after train; --dp-only runs phases 1, 2 and this one) the
            training step data-parallel over processes (launch.ranks,
            one rank a card).  At count >= 2: count NCCL ranks at
            train:'s width and depth, a global batch of 4 x count rows
            (TokenPipeline's DataShard draws) in 4 microbatches; every
            rank first takes the one-card step on that batch in 4 x
            count microbatches of one row (each row's bf16 gradient
            rounded as on the ranks), keeping its state after
            DP_EQUAL_STEPS steps on the host, and rank 0 the one-card
            step at 4 rows; then DP_STEPS timed
            AdamW steps of plain DP and of ZeRO-1 on every rank: every
            step's loss within 2**-7 of the one-card step's, the grad
            norms of the first DP_EQUAL_STEPS steps within 2**-8 and
            later ones within DP_LATE_NORM_REL, and after those steps
            the parameters', mu's and nu's L2 distance from the
            one-card state within DP_STATE_REL,
            flash_attention 2 x layers x microbatches a step on each
            rank, optimizer state and accumulator bytes equal to
            abstract_state's and the gradient shardings'; ms a
            step, tokens/s, the scaling against count x the one-card
            rate at 4 rows, and per rank one step under torch.profiler
            (NCCL kernel ms, flash ms a launch, device time, peak beside
            the dry-run's memory model).  At one card (NCCL takes one
            card a rank; the CUT line says so): (a) a NCCL group of one
            in this process on train:'s state and batch, bit-equal to
            the plain step, and one step of it profiled; (b) two gloo
            ranks on the card at the reduced f32 config (matrices x
            DP_GLOO_SCALE; in the whole run started in a thread before
            train: (b), beside its checkpoint IO, with --dp-only before
            (a), beside it; ended before (a)'s profiled step runs,
            alone on the card), plain DP and ZeRO-1 within
            DP_GLOO_REL of the one-process step, beside that step's
            distance from the same step on the CPU at the fan_in
            weights and at DP_GLOO_SCALE; a collective gloo lacks for
            CUDA tensors cuts its mode on a CUT line.
18. fsdp    (after dp; --fsdp-only runs phases 1, 2 and this one) FSDP
            (the parameters held as each rank's chunk of their embed
            dim, a layer's chunks gathered inside its remat'd function,
            each gradient reduce-scattered in f32 into the rank's
            accumulator chunk) and Adafactor on shards.  At count >= 2:
            count NCCL ranks, (a) internlm2-20b at full width cut to 8
            of 48 layers (the CUT line prints parameters and bytes), its
            run config (FSDP, remat full, AdamW) in 8 microbatches of
            one row a card at train_4k's seq, and (b) kimi-k2's FSDP +
            Adafactor pairing at the families' cut (1 layer, 64
            experts) in 4 microbatches; each FSDP_STEPS timed steps of
            FSDP and of ZeRO-1 on the same ranks, batches and initial
            parameters (FSDP drawn leaf by leaf, each cut to its chunk
            as it is drawn) and one more step of each under
            torch.profiler: FSDP held to ZeRO-1 (every loss and grad
            norm, and after the steps each rank's parameter chunk and
            optimizer-state chunks; the line says whether they are
            bit-equal, else prints the largest differences; the checks
            are dp:'s bars), the parameter, optimizer-state and
            accumulator bytes of each rank equal to abstract_state's
            and the gradient shardings' shard bytes, flash_attention 2
            x layers x microbatches a step; ms a step, tokens/s, NCCL
            ms, busy share and peak a card beside estimate_memory's
            FSDP and ZeRO-1 totals; row 5-train-i2 (the kernel at
            internlm2's (1, 48, 4096, 128) x (1, 8, 4096, 128), a GQA
            group of 6, on (a)'s first operands, held to its plain
            version and the f64 answer, beside SDPA and flash_work's
            bound).  At one card (the CUT line says why): (c)
            internlm2-20b at full width, 4 of 48 layers, its first run
            on a card: every parameter's gradient finite and nonzero on
            one microbatch, 2 AdamW steps (remat full, 8 microbatches of
            one row), the second profiled, row 5-train-i2 at its
            operands; (d) two gloo ranks on the card (started in a
            thread before train: (b) with dp: (b)'s, or with --fsdp-only
            before (c); ended before dp: (a)'s profiled step and before
            (c)'s steps) at the reduced f32 configs (matrices
            x DP_GLOO_SCALE): FSDP x {AdamW, Adafactor, 8-bit Adam} on
            dense llama, FSDP + Adafactor on a reduced MoE with drops and
            ZeRO-1 + Adafactor on llama, each within DP_GLOO_REL of the
            one-process step on the card (8-bit Adam's parameters at
            FSDP_8BIT_REL), FSDP + Adafactor bit-equal to ZeRO-1 +
            Adafactor on the same ranks.
19. tp      (after fsdp; --tp-only runs phases 1, 2 and this one) the
            training step tensor-parallel over the model axis of NCCL
            ranks, one card each (ROADMAP Queue A item 8(a), the dense
            family: the projections split by column and by row, the
            embedding, head and NLL by vocabulary; item 8(b) part 1,
            the moe, vlm and encdec families: experts or expert_mlp,
            the router's gathered logits, the vlm prefix, the encoder
            and cross-attention; item 8(b) part 2, the ssm and hybrid
            families: the mamba mixer's ssm_inner chunks, its in_proj
            output and conv gathered whole, its heads, the gated norm
            summed over the line, the hybrid's shared block), composed
            with plain DP, ZeRO-1 and
            FSDP over the data axis.  At count >= 2: train:'s llama3-8b
            at full width, 4 of 32 layers (a CUT line), its global
            batch of 8 x 4,096 tokens in 4 microbatches, on (data 1,
            model count) plain, and at count 4 also on (2, 2) plain,
            ZeRO-1 and FSDP; every rank first takes the one-card step on
            the global batch (in 4 microbatches, and in 8 of one row for
            the (2, 2) modes, whose data ranks take one row a
            microbatch), and again with its attention forward rounded
            another way (a chunked plain attention for the kernel: the
            noise floor of bf16 rounding); TP_STEPS timed steps of each
            mode and one more under torch.profiler, held at dp:'s bars
            to the one-card step: every loss within 2**-7, the first
            DP_EQUAL_STEPS grad norms within 2**-8 and later ones within
            DP_LATE_NORM_REL, the state's L2 distance after
            DP_EQUAL_STEPS steps within DP_STATE_REL, each of the last
            three or within TP_FLOOR_X x the noise floor's; each rank's parameter, optimizer-state and
            accumulator bytes equal to abstract_state's shard bytes on
            that mesh; flash_attention 2 x layers x microbatches a step
            a rank; ms a step, tokens/s, NCCL ms, busy share and peak a
            card beside estimate_memory at that mesh; (c) the same
            comparison in f32 (the matrices x DP_GLOO_SCALE, one row a
            step, on (1, count) plain), where the noise floor stays
            small and the bars bite; row
            5-train-tp (the kernel at a (1, 4) rank's (2, 8, 4096, 128)
            x (2, 2, 4096, 128) on its first operands, held to its
            plain version and the f64 answer, beside SDPA and
            flash_work's bound); (d) TP_FAMILY_RUNS in f32 at full
            width and a cut depth (CUT lines; the matrices x
            DP_GLOO_SCALE, remat full, TP_FAMILY_ROWS rows a step):
            mixtral (2 layers), kimi (1 layer, 64 experts, Adafactor),
            llava (2 layers, its prefix), seamless (2 + 2 layers,
            more source frames than tokens), mamba2 (4 layers) and
            zamba2 (6 layers: one super-block, Adafactor) on (1,
            count) plain and at
            count 4 on (2, 2) under ZeRO-1 or FSDP, each against its
            one-card f32 step at (c)'s bars, with its bytes, exact
            flash launches, ms a step, tokens/s, NCCL ms (by collective:
            all-gather, reduce-scatter, all-reduce), busy share and
            peak beside estimate_memory, and a flash row for each shape
            its (1, count) steps gave rank 0's kernel (held by
            flash_verdict, beside SDPA and the f32 bound).  At
            one card (the CUT line says why): four gloo ranks on the
            card (started in a thread before train: (b) with dp: (b)'s
            and fsdp: (d)'s, ended before dp: (a)'s profiled step; with
            --tp-only started at the phase's start) at dp:'s reduced f32
            llama (matrices x DP_GLOO_SCALE) on (1, 4) plain and on
            (2, 2) plain, ZeRO-1 and FSDP, and TP_GLOO_FAMILIES (the
            reduced mixtral with its experts split and with
            expert_mlp split, kimi with its shared expert, llava,
            seamless on both meshes, mamba2 on (1, 4) plain, zamba2 on
            (2, 2) FSDP), each within DP_GLOO_REL of the
            one-process step on the card (AdamW's sign flips as
            TP_FLIP_FRAC allows); a mode needing a collective that gloo
            lacks on CUDA tensors is cut on a CUT line.
20. serve_tp (after tp; --serve-tp-only runs phases 1, 2 and this one)
            LM prefill and decode over ranks (ROADMAP Queue A item
            10(a), the dense, moe and vlm families): each rank takes its
            chunks of the weights (zoo.rank_params) and its rows of the
            batch, runs zoo.prefill_fn / zoo.decode_fn with the mesh, and
            holds its chunk of the KV cache as the reference lays it
            out (batch on data, kv_seq on model, or kv_heads where
            kv_seq does not divide the line).  At one card (a CUT line):
            four gloo ranks on the card, started at the phase's start
            while the parent runs the one-process references on the
            card, SERVE_TP_GLOO_RUNS reduced in f32 (matrices x
            DP_GLOO_SCALE; llama on (1, 4) and (2, 2), a 31-slot cache,
            mixtral's window with a ring-wrapping decode, kimi's shared
            expert, llava's prefix, internlm2's FSDP weights), prefill
            and SERVE_TP_STEPS greedy steps with the launch counters zeroed
            just before and read just after on every rank: logits within
            SERVE_TP_GLOO_REL of the one-process run's scale, tokens equal,
            every rank of a model line holding the same logits,
            flash_attention one launch a layer a rank, cache bytes equal
            to the dry-run's cache_specs shard bytes; the flash row at
            the first run's rank shape against its plain version (1e-4
            absolute, f32).  At count >= 2: NCCL ranks, llama3-8b at full
            width in bf16 at SERVE_TP_LAYERS layers (CUT lines): a
            SERVE_TP_PREFILL prefill and SERVE_TP_DECODE decode steps from a
            cache of N(0, 1) keys and values on (1, count) and (2, 2),
            timed (its logits read, not held: their noise floor sits at
            their scale); the same in f32 with the matrices x
            DP_GLOO_SCALE (SERVE_TP_F32) on the same meshes, and mixtral
            in f32 at its window on (1, count) (timed on its own routing,
            compared on the one-card routes), each against rank 0's
            one-card run of the first rows within TP_FLOOR_X x its noise
            floor, the floor below SERVE_TP_FLOOR_CAP; ms of prefill and a
            step, tokens/s, NCCL ms by collective, busy share, peak a
            card beside estimate_memory; the flash row at a rank's
            prefill shape.

The whole run, the build included, must end within 1,200 s; the
``total:`` line prints its seconds.  Before the last line it prints the
kernels as one JSON object and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.  Any failed check raises, so the script
exits nonzero and prints no result.  It also exits nonzero when no CUDA
device is available or the port's sources are missing beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

DEVICE = "cuda"
PROFILER_WINDOWS = 5            # one-call profiler windows per kernel row
D = 8                           # GaussMix width every repro benchmark uses
B = 64                          # queries per batch
K_NN = 10
SELECTIVITY = 1e-4              # the paper's default 0.01%

K_CLUSTERS, M, RINGS, DEGREE = 64, 3, 20, 8   # bench_build.py:39
LINF_N = 200_000                # (c)'s cut n; --linf-n overrides it
# (e): L1 and L-infinity builds at a width the old pdist_lp.cu tile could
# not launch (d >= 202), on GaussMix, at an n that keeps (e) near 30 s
WIDE_D, WIDE_N = 256, 20_000
# (b), (c) and (e)'s query checks: BUILDER_SLICES slices of a part's
# queries, one spawned worker a slice, running beside the builder's
# later parts; a slice's answer waited for at most BUILDER_QUERY_WAIT_S
# (4 slices a part took 35-52 s longer than 2: each slice's task pickles
# the part's rows and both indexes; tools/ab_builder_slices.py, PERF.md)
BUILDER_SLICES, BUILDER_WORKERS, BUILDER_QUERY_WAIT_S = 2, 8, 600.0
# serving: rounds of SERVE_ROWS inserts + SERVE_ROWS deletes, a refresh
# every SERVE_REFRESH mutations; (c)'s query thread runs
# SERVE_ASYNC_BATCHES batches of each kind; (a) sends FOUND_SAMPLE of a
# round's inserted and of its deleted rows through r = 1e-9 queries
# (2 rounds, each with every check of a round: the whole run keeps
# within its limit)
SERVE_ROUNDS, SERVE_ROWS, SERVE_REFRESH = 2, 1_000, 2_000
SERVE_ASYNC_BATCHES = 8
FOUND_SAMPLE = 64
# paged: main's snapshot spilled at PAGE_BYTES pages, served behind a
# CACHE_PAGES page cache (16 MB, far under the store); (b) runs the first
# PAGED_BATCHES of main's batches of each kind in each prefetch mode (a
# CUT of main's 3: a cold paged batch takes 2-4 s at n = 1M, and 3 of
# each in both modes would double the phase, PERF.md); (c)'s engine
# takes one round of SERVE_ROWS inserts and SERVE_ROWS deletes
PAGE_BYTES, CACHE_PAGES, PAGED_BATCHES = 4096, 4096, 1
# sharded: SHARDS shards (K = 64 splits evenly), then SHARDS_PADDED (K
# padded to 66); (b) and (c) run SHARDED_CUT of main's batches of each
# kind, and the q/s turns 3 and 4 SHARDED_TURN_CUT (CUTs that keep the
# phase near a minute)
SHARDS, SHARDS_PADDED, SHARDED_CUT, SHARDED_TURN_CUT = 4, 3, 2, 2
# frontend: FRONTEND_REPLICAS replicas behind ServingEngine.frontend(
# max_batch=B, slo_ms=FRONTEND_SLO_MS); (b) sends rows of
# FRONTEND_BATCHES of main's batches of each kind, (c) and the q/s turns
# of (i) FRONTEND_MIXED_CUT and FRONTEND_TURN_CUT (CUTs that keep the
# phase near a minute); (f) ticks the monitor at most FRONTEND_MAX_TICKS
# times; a submitter not answered within FRONTEND_JOIN_S fails the phase
FRONTEND_REPLICAS, FRONTEND_SLO_MS, FRONTEND_BATCHES = 4, 5.0, 8
FRONTEND_MIXED_CUT, FRONTEND_TURN_CUT, FRONTEND_MAX_TICKS = 2, 2, 8
FRONTEND_JOIN_S = 300.0
# knn_loop: the loop's memory bound over the host-driven rounds (peak
# reserved), (b)'s forced batch size, (c)'s batch sizes (7 graph keys
# against the 4 an executor keeps), and (d)'s cut of main's batches
LOOP_MEMORY_SLACK = 4 << 30
LOOP_TURN_SLACK = 64 << 20      # allocator rounding between equal turns
LOOP_FORCED_B = 4
D2H_WINDOWS = 3                 # profiler windows a copy count reads
LOOP_KEYS = (64, 32, 16, 8, 4, 2, 1)
LOOP_SHARDED_CUT = 2
# kernels of the query path; pdist_l1 and pdist_linf run in the builder
MAIN_KERNELS = ("pdist", "rankeval", "range_filter", "pdist_rankeval")
# the Pallas kernel (or kernel body) each CUDA kernel replaces
REPLACES = {
    "pdist": "src/repro/kernels/pdist.py:55",
    "pdist_bf16": "src/repro/kernels/pdist.py:55",
    "pdist_f16": "src/repro/kernels/pdist.py:55",
    "rankeval": "src/repro/kernels/rankeval.py:69",
    "range_filter": "src/repro/kernels/range_filter.py:35",
    "range_filter_bf16": "src/repro/kernels/range_filter.py:35",
    "range_filter_f16": "src/repro/kernels/range_filter.py:35",
    "pdist_rankeval": "src/repro/kernels/fused.py:58",
    "pdist_l1": "src/repro/kernels/pdist.py:36",
    "pdist_linf": "src/repro/kernels/pdist.py:43",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    # not a Pallas kernel: the cond of the reference's compiled kNN loop
    "knn_loop_cond": "src/repro/core/executor.py:178",
}

# baselines: the paper's comparison on its own GaussMix corpus, cut to
# BASELINE_N rows (BallTree and ZMIndex build and every baseline queries
# in Python on the host), BASELINE_BATCHES batches of each kind
BASELINE_N, BASELINE_BATCHES = 200_000, 1

# train: examples/train_lm.py's twin at TRAIN_ARCH's full width in bf16,
# the depth cut to TRAIN_LAYERS so weights, gradients and AdamW state fit
# one card; train_4k's seq at a global batch of TRAIN_BATCH in
# TRAIN_MICRO microbatches.  TRAIN_LR: the schedule warms up over 100
# steps, so step s runs at s / 100 of it; at 1e-2 the first steps'
# updates (1e-4 and up) reach past half a bf16 ulp of the weights
# (~1.2e-4 at 0.0156), where 3e-4 would leave them unchanged.  (a) runs
# TRAIN_STEPS steps, (b) FAULT_STEPS with a checkpoint every
# FAULT_EVERY and a failure injected at FAULT_AT, (c) OTHER_STEPS of
# each other optimizer.  Bars: (b)'s losses against (a)'s (bf16 noise:
# the embedding's backward accumulates with atomics), the flash
# Function's gradients against plain attention's, and the reduced f32
# step on the card against the CPU port's (as the CPU tests' SCALED)
TRAIN_ARCH, TRAIN_LAYERS = "llama3-8b", 4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_LR = 4_096, 8, 4, 1e-2
TRAIN_STEPS, FAULT_STEPS, FAULT_EVERY, FAULT_AT, OTHER_STEPS = 5, 5, 3, 4, 3
TRAIN_REPLAY_REL, TRAIN_GRAD_REL, TRAIN_F32_REL = 2.0 ** -7, 2.0 ** -8, 2e-3
# dp: DP_STEPS timed steps of each mode (plus one profiled); (b)'s bar
# on two gloo ranks against the one-process step, f32, over DP_GLOO_STEPS
# steps (the warm-up's lr is 0 at step 0: both steps' metrics read the
# initial parameters, the second's update shows in the parameters; a
# third step's metrics would read Adam's first, sign-like update, where
# f32 rounding flips near-zero gradient elements by +-lr, and the
# reduced model's sharpness parts them by ~1 relative)
DP_STEPS, DP_GLOO_STEPS, DP_GLOO_REL = 3, 2, 1e-5
# over cards the one-card step takes the global batch one row a
# microbatch, so each row's bf16 gradient rounds as on the ranks and only
# the order of the f32 sums differs.  Every step's loss is held to
# train:'s bar, and so are the grad norms of the first DP_EQUAL_STEPS
# steps, whose metrics read the initial weights (lr 0 at step 0).  The
# state after them (Adam's first update) is held by L2 distance to the
# one-card state: the parameters over that state's own move from the
# initial ones, mu and nu over their norm, within DP_STATE_REL (a wrong
# chunk or moment update reads ~1).  A later step's grad norm reads the
# weights after that sign-like update of bf16 weights, where a 1e-5
# difference in the gradient parted it by 1.01% (PERF.md): held
# within DP_LATE_NORM_REL, above the 0.94-3.40% readings
DP_EQUAL_STEPS, DP_STATE_REL, DP_LATE_NORM_REL = 2, 2.0 ** -5, 2.0 ** -4
# (b)'s matrices (every leaf of 2 or more dims) scaled by DP_GLOO_SCALE:
# at the fan_in weights the reduced model's gradient norm is ~1,172 and
# f32 arithmetic alone moves it by 4.2e-4 (the one-process step on the
# card against the same step on the CPU), past any 1e-5 comparison; at
# half the scale it is ~15.7 and the two agree within 6.1e-8 (PERF.md).
# The phase prints that reading beside its own.
DP_GLOO_SCALE = 0.5
# fsdp: at count >= 2, (a) FSDP_ARCH at full width cut to FSDP_LAYERS
# layers in its run config (FSDP, remat "full", AdamW, FSDP_MICRO
# microbatches, here of one row a card) and (b) KIMI_ARCH's FSDP +
# Adafactor pairing at the families' cut (KIMI_LAYERS layers,
# KIMI_EXPERTS experts) in KIMI_MICRO microbatches (of its 16); each
# mode FSDP_STEPS timed steps and one profiled.  At one card (c)
# FSDP_ARCH at FSDP_ONE_LAYERS and (d) FSDP_GLOO_RUNS ((MoE?,
# optimizer, mode)) on two gloo ranks at dp:'s bar, FSDP + Adafactor held
# to ZeRO-1 + Adafactor bit for bit.  8-bit Adam's parameters are held at
# FSDP_8BIT_REL of their scale, the CPU tests' bar for the same
# comparison (PORT_PARAM_REL in tests/test_torch_train_dp.py): its int8
# moments round x / scale to a code, so where the ranks' f32 gradient
# sums part from the one-process sum in the last bit a code can flip and
# move that element's update by a step of its block's scale (1.24e-5 of
# the scale read on an H100, PERF.md)
FSDP_ARCH, FSDP_LAYERS, FSDP_ONE_LAYERS = "internlm2-20b", 8, 4
FSDP_MICRO, FSDP_STEPS = 8, 2
KIMI_ARCH, KIMI_LAYERS, KIMI_EXPERTS, KIMI_MICRO = \
    "kimi-k2-1t-a32b", 1, 64, 4
FSDP_GLOO_RUNS = ((False, "adamw", "fsdp"), (False, "adafactor", "fsdp"),
                  (False, "adamw8bit", "fsdp"), (True, "adafactor", "fsdp"),
                  (False, "adafactor", "zero1"))
FSDP_8BIT_REL = 2e-5
# AdamW's second-step update is lr * sign(g) wherever |g| is far above its
# eps, so an element whose one-process gradient is itself f32 rounding
# noise may take the other sign over ranks and part by lr: the gloo
# checks let fewer than TP_FLIP_FRAC of a leaf's parameters part further
# than DP_GLOO_REL, each where the one-process first moment is within
# TP_NOISE_REL of the leaf's largest, with every first moment within
# DP_GLOO_REL (as tests/test_torch_train_tp_families.py holds them)
TP_FLIP_FRAC, TP_NOISE_REL = 1e-4, 1e-5
# AdamW's second update (DP_GLOO_STEPS = 2; the warm-up's lr is 0 at step
# 0, so both steps take the same clipped gradient g) is lr * g / (|g| +
# eps): where g is near eps (the mamba mixer's zero-initialised conv_b,
# A_log and dt_bias once the clip divides the gradient by its norm) a
# first moment's rounding moves the update further, so the gloo checks
# also let an element part by up to twice the difference of that update
# at the two first moments (tp_adamw_spread; as
# tests/test_torch_train_tp_ssm.py holds it).  zamba2's reduced f32
# gradients lie 4.4e-5 of their scale from float64 at matrices x 0.5 (its
# embeddings joined into every shared block; 2.7e-6 at x 0.25, the CPU),
# above DP_GLOO_REL, so its gloo run scales them by TP_GLOO_SCALES
TP_GLOO_SCALES = {"zamba2": 0.25}
# tp: at count >= 2 train:'s TRAIN_ARCH at full width and TRAIN_LAYERS,
# its global batch in TRAIN_MICRO microbatches, on TP_MESHES[count]
# ((data, model, modes) a mesh), TP_STEPS timed steps a mode and one
# profiled, at dp:'s bars; at one card TP_GLOO_MESHES on four gloo ranks
# at DP_GLOO_REL
TP_STEPS = DP_STEPS
# dp:'s bars on the grad norms and the state assume the ranks compute
# each row's bf16 forward and backward as one card does; tensor
# parallelism adds bf16 roundings (each rank's partial sums), and at
# random fan_in weights near-tied attention scores turn any such rounding
# into O(1) changes of single gradient elements (the reduced and d 2048
# models' bf16 gradients lie 111-131% from their f32 ones on the CPU,
# PERF.md).  So a grad norm or state distance also passes within
# TP_FLOOR_X x the same distance between two one-card steps that differ
# only in such a rounding: the attention forward by a chunked plain
# attention (TP_FLOOR_CHUNK) in place of the flash kernel -- the
# repo's "no further than 4 x" rule (tests/test_torch_train.py)
TP_FLOOR_X, TP_FLOOR_CHUNK = 4.0, 1024
TP_MESHES = {2: ((1, 2, ("plain",)),),
             4: ((1, 4, ("plain",)), (2, 2, ("plain", "zero1", "fsdp")))}
TP_GLOO_MESHES = ((1, 4, ("plain",)), (2, 2, ("plain", "zero1", "fsdp")))
# tp: (a) at one card the families on the same four gloo ranks, reduced
# f32 at DP_GLOO_SCALE: (name, arch, changes to the reduced config, data,
# model, mode, optimizer); the MoE configs at capacity factor 1.25 in 2
# dispatch groups.  "mixtral-emlp" has 3 experts, a count that divides
# neither line, so each expert's expert_mlp dim splits (mixtral's 8 on the
# production line of 16); seamless's vocabulary is 510, which divides by
# 2 and not by 4, as its 256,206 does; mamba2's mixer splits every leaf
# on ssm_inner (in_proj's output gathered whole, the gated norm's sum
# over the line), zamba2 adds the shared attention block
TP_GLOO_FAMILIES = (
    ("mixtral", "mixtral-8x7b", {}, 1, 4, "plain", "adamw"),
    ("mixtral", "mixtral-8x7b", {}, 2, 2, "zero1", "adamw"),
    ("mixtral-emlp", "mixtral-8x7b", {"n_experts": 3}, 1, 4, "plain",
     "adamw"),
    ("kimi", "kimi-k2-1t-a32b", {}, 2, 2, "fsdp", "adafactor"),
    ("llava", "llava-next-34b", {}, 1, 4, "plain", "adamw"),
    ("seamless", "seamless-m4t-large-v2", {"vocab": 510}, 1, 4, "plain",
     "adamw"),
    ("seamless", "seamless-m4t-large-v2", {"vocab": 510}, 2, 2, "zero1",
     "adamw"),
    ("mamba2", "mamba2-780m", {}, 1, 4, "plain", "adamw"),
    ("zamba2", "zamba2-2.7b", {}, 2, 2, "fsdp", "adamw"))
# tp: (d) at count >= 2 the families at full width in f32 (matrices x
# DP_GLOO_SCALE, remat full), TP_FAMILY_ROWS rows a step in one
# microbatch, against the one-card f32 step: (label, arch, layers (a
# stack's, for encdec), experts (None: all), optimizer, positions a row,
# source frames a row (encdec), the (2, 2) mode); the MoE configs in
# TP_FAMILY_ROWS dispatch groups (one a data rank on (2, 2), as the
# dry-run sets them); zamba2's 6 layers are one super-block and one
# invocation of its shared block
TP_FAMILY_RUNS = (
    ("mixtral", "mixtral-8x7b", 2, None, "adamw", 4_096, None, "zero1"),
    ("kimi", "kimi-k2-1t-a32b", 1, 64, "adafactor", 2_048, None, "fsdp"),
    ("llava", "llava-next-34b", 2, None, "adamw", 4_096, None, "fsdp"),
    ("seamless", "seamless-m4t-large-v2", 2, None, "adamw", 2_048, 4_096,
     "zero1"),
    ("mamba2", "mamba2-780m", 4, None, "adamw", 4_096, None, "zero1"),
    ("zamba2", "zamba2-2.7b", 6, None, "adafactor", 4_096, None, "fsdp"))
TP_FAMILY_ROWS = 2
# (a mamba mixer's gathered in_proj output reduce-scatters its gradient
# in every mode: tp_needs)
TP_NEEDS = {"plain": ("all_reduce", "all_reduce_max",
                      "all_gather_into_tensor"),
            "zero1": ("all_reduce", "all_reduce_max",
                      "all_gather_into_tensor", "reduce_scatter_tensor"),
            "fsdp": ("all_reduce", "all_reduce_max",
                     "all_gather_into_tensor", "reduce_scatter_tensor")}

# serve_tp: LM prefill and decode over ranks (ROADMAP Queue A item
# 10(a)).  At one card four gloo ranks on the card run SERVE_TP_GLOO_RUNS
# ((label, arch, changes to the reduced config, cache_len, prompt
# tokens, data, model, FSDP weights)) reduced in f32 (matrices x
# DP_GLOO_SCALE), SERVE_TP_ROWS rows, prefill and SERVE_TP_STEPS greedy
# decode steps held to the one-process prefill and decode on the card
# within SERVE_TP_GLOO_REL of the logits' max |value|
# (tests/test_torch_serve_tp.py holds the same at 1e-5 on the CPU,
# reading 1.7e-6 at most).  The runs: llama with its cache's kv_seq on
# model (ranks 2 and 3 of (1, 4) hold no valid slot until decode reaches
# them) and on (2, 2); a cache of 31 slots, which no line divides (whole
# on (1, 4)); mixtral's window of 32 with a 44-token prompt (prefill
# rolls the ring; decode writes slots 12-19, across the (1, 4) shard
# boundary at 16); kimi's shared expert on (2, 2); llava's prefix;
# internlm2's FSDP weights on (2, 2).  At count >= 2 (--serve-tp-only on
# four cards) SERVE_TP_ARCH at full width in bf16 at SERVE_TP_LAYERS
# layers: SERVE_TP_PREFILL (rows, tokens) of prefill_32k,
# SERVE_TP_DECODE (rows, cache slots) of decode_32k from a cache of
# N(0, 1) keys and values, and SERVE_TP_MIXTRAL ((arch, layers, rows,
# prompt): decode slots 1020-1027 cross the 1,024-slot shard boundary of
# (1, 4)) in f32, each compared with rank 0's one-card run of the first
# SERVE_TP_ONE_ROWS (prefill, decode) rows within TP_FLOOR_X x the noise
# floor of that run rounded another way (llama's bf16 run is only timed:
# below): its q, k, v projections summed
# in two half contractions (serve_split_qkv), prefill's attention by the
# chunked plain attention, decode's weights kept in f32 before P V (as
# the ranks' merge keeps them; the reference casts them to the cache's
# dtype); the bf16 flash row's f64 check reads the first
# SERVE_TP_VERDICT_ROWS query rows of sequence 0
SERVE_TP_STEPS, SERVE_TP_ROWS, SERVE_TP_GLOO_REL = 8, 4, 1e-5
SERVE_TP_GLOO_RUNS = (
    ("llama", "llama3-8b", {}, 64, 20, 1, 4, False),
    ("llama", "llama3-8b", {}, 64, 20, 2, 2, False),
    ("llama-t31", "llama3-8b", {}, 31, 20, 1, 4, False),
    ("mixtral", "mixtral-8x7b", {"moe_dispatch_groups": 2}, 64, 44, 1, 4,
     False),
    ("kimi", "kimi-k2-1t-a32b", {"moe_dispatch_groups": 2}, 64, 20, 2, 2,
     False),
    ("llava", "llava-next-34b", {}, 64, 20, 1, 4, False),
    ("internlm2", "internlm2-20b", {}, 64, 20, 2, 2, True))
SERVE_TP_ARCH, SERVE_TP_LAYERS = "llama3-8b", 4
SERVE_TP_PREFILL, SERVE_TP_DECODE = (16, 32_768), (128, 32_768)
SERVE_TP_ONE_ROWS = (2, 8)
SERVE_TP_MIXTRAL = ("mixtral-8x7b", 2, 8, 5_116)
SERVE_TP_VERDICT_ROWS = 2_048
# mixtral at 8 x 5,116 tokens: any rounding flips some token's top-k at a
# near-tie of its router logits in every row (the noise floor's run did,
# measured on four H100s), and a flipped expert moves that row's logits far
# above rounding.  So the ranks and the floor's run dispatch every token
# to the one-card run's experts (serve_routes), and each token whose own
# top-k differs must be a near-tie: the gap between its k-th and
# (k+1)-th router logit within SERVE_TP_ROUTE_GAP of its largest |router
# logit| (the ranks' router logits part from one card's by 6.0e-5 of
# their scale at full width in f32, measured on one H100)
SERVE_TP_ROUTE_GAP = 1e-3
# llama's bf16 run is timed, not held (SERVE_TP_TIMED): at random fan_in
# weights its one-card run rounded another way parts from itself by
# 1.157 / 0.536 of the logits' scale (prefill / decode, four H100s), so
# a bar drawn from that floor passes logits of all zeros.  The same
# model in f32 with its matrices x DP_GLOO_SCALE (SERVE_TP_SCALES), on
# the same meshes, SERVE_TP_F32 ((rows, prompt tokens, one-card rows))
# prefill and SERVE_TP_STEPS decode steps on its own cache, is held;
# every held run's noise floor must lie below SERVE_TP_FLOOR_CAP of the
# logits' scale, or its bar could not catch a fault
SERVE_TP_TIMED = ("llama",)
SERVE_TP_SCALES = {"llama-f32": DP_GLOO_SCALE}
SERVE_TP_F32 = (4, 4_096, 2)
SERVE_TP_FLOOR_CAP = 1e-2

LM_ARCH = "llama3-8b"
# (a)'s cut depth, and its bar on max |diff| relative to the compared
# logits' max |value| (as tests/test_torch_models.py's _close_scaled):
# above what the plain dense_attention path reads against forward_seq,
# and below what the same forward reads with its attention rounded to
# bf16 (the control), which the script checks too (PERF.md, PR 13)
LM_F32_LAYERS = 4
LM_F32_REL = 4e-3
LM_REQUESTS, LM_PROMPT, LM_DECODE = 4, 2_000, 32
# examples/retrieval_serving.py:42-45
ENCODER = dict(name="encoder-20m", family="dense", n_layers=4, d_model=256,
               n_heads=4, n_kv_heads=4, d_ff=1024, vocab=8192, head_dim=64,
               attn_impl="dense", remat="none", dtype="float32")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, replays: int = 10) -> float:
    """Device ms a call of ``fn`` (bare kernel launches) with no host
    cost in the window: ``n`` calls captured in one CUDA graph, CUDA
    events around ``replays`` replays.  For kernels shorter than the
    host's launch path, which back-to-back launches measure instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls
    (time.perf_counter_ns, after one warm-up call), then a synchronise
    outside the window."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return t / calls / 1e3


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit where neither is NaN, NaN where the other is."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a),
                                               torch.where(nb, 0, b))


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def launch_tile(kernel: str, metric=None, dims=None) -> tuple:
    """The tile ints a bare launch of ``kernel`` takes last, as ``ops``
    resolves them at ``dims`` (the tuning table's, else the static
    tile); without ``dims`` the static tile (``pdist_grouped``'s)."""
    from repro_torch.kernels import autotune
    return autotune.tile_args(
        kernel, autotune.tiles_for(kernel, metric, dims) if dims else None)


# ------------------------------------------------------------------ phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} count={count} nvidia-smi='{smi}' "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    return name, count, smi


def phase_build():
    from repro_torch.kernels import _cuda
    t0 = time.perf_counter()
    built = _cuda.build(force=True)
    print(f"build: {len(built)} sources ({len(_cuda.SIGNATURES)} kernels) "
          f"with nvcc in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{b.name} {b.seconds:.2f} s' for b in built.values())})",
          flush=True)
    for b in built.values():
        use = re.findall(r"Used (\d+) registers.*?(?:, (\d+) bytes smem)?$",
                         b.log, re.M)
        regs = "/".join(u[0] for u in use) or "?"
        smem = "/".join(u[1] or "0" for u in use) or "0"
        spills = "/".join(re.findall(r"(\d+) bytes spill stores", b.log))
        print(f"build: {b.name} registers={regs} static_smem={smem} B "
              f"spill_stores={spills or '?'} B (per entry function)",
              flush=True)


def make_queries(X, rng, n_batches: int, metric: str = "l2"):
    """Batches of B data rows plus N(0, 0.003) noise, each with the
    radius at its SELECTIVITY quantile of true ``metric`` distances (f64,
    on the card: torch.quantile's linear interpolation, like
    np.quantile)."""
    Xd = torch.from_numpy(X).to(DEVICE)
    out = []
    for _ in range(n_batches):
        Q = X[rng.choice(len(X), B)] + rng.normal(0.0, 0.003,
                                                  (B, X.shape[1]))
        r = np.empty(B)
        for i, q in enumerate(torch.from_numpy(Q).to(DEVICE)):
            if metric == "l2":
                dist = torch.sqrt(((Xd - q) ** 2).sum(dim=1))
            elif metric == "l1":
                dist = (Xd - q).abs().sum(dim=1)
            else:
                dist = (Xd - q).abs().amax(dim=1)
            r[i] = float(torch.quantile(dist, SELECTIVITY))
        out.append((Q, r))
    return out


def same_range(got, want) -> bool:
    gi, gd = got
    wi, wd = want
    a, b = np.argsort(gi), np.argsort(wi)
    return np.array_equal(gi[a], wi[b]) and np.array_equal(gd[a], wd[b])


def same_knn(got, want) -> bool:
    """Equal f64 distances in order and equal id sets (ties may order
    ids differently)."""
    return (np.array_equal(got[1], want[1])
            and np.array_equal(np.sort(got[0]), np.sort(want[0])))


def shape_spy(names=("pdist", "range_filter")):
    """({name: {}} for ``names``, an unstarted patch of ``_cuda.launch``
    and ``_cuda.add_launches``) that tallies each launch of those pdist
    / range_filter / pdist_rankeval entry points by its (nq, np), the C
    arguments after the pointers (pdist_rankeval: (B, G)); under a lock,
    as the router launches from one thread per replica.  A launch made
    inside ``_cuda.recording()`` (the kNN loop's warm-up round and
    capture) is not a launch that runs: its shape is kept with the
    recording and tallied once for each replayed round that
    ``add_launches`` counts for it."""
    from repro_torch.kernels import _cuda
    shapes = {name: {} for name in names}
    recorded = {}           # id(tally.kernels) -> (tally.kernels, shapes)
    real_launch, real_add = _cuda.launch, _cuda.add_launches
    lock = threading.Lock()

    def tally(name, shape, n):
        shapes[name][shape] = shapes[name].get(shape, 0) + n

    def spy(name, *args, **kw):
        real_launch(name, *args, **kw)
        if name in shapes:
            if name == "pdist_rankeval":
                nq, npts = args[10:12]
            elif name.startswith("range_filter"):
                nq, npts = args[5:7]
            else:
                nq, npts = args[3:5]
            rec = _cuda.current_recording()
            with lock:
                if rec is None:
                    tally(name, (nq, npts), 1)
                else:
                    recorded.setdefault(id(rec.kernels), (rec.kernels, []))[
                        1].append((name, (nq, npts)))

    def add_spy(kernels, times):
        real_add(kernels, times)
        with lock:
            for name, shape in recorded.get(id(kernels), (None, ()))[1]:
                tally(name, shape, times)

    return shapes, mock.patch.multiple(_cuda, launch=spy,
                                       add_launches=add_spy)


def host_answers(ix, batches, show: bool = True) -> tuple:
    """The host index's answers to every range and every kNN batch
    (ids and f64 distances), with ``show`` its q/s printed."""
    t0 = time.perf_counter()
    host_range = [[ix.range_query(q, r)[:2] for q, r in zip(Q, rs)]
                  for Q, rs in batches]
    t1 = time.perf_counter()
    host_knn = [[ix.knn_query(q, K_NN)[:2] for q in Q] for Q, _ in batches]
    t2 = time.perf_counter()
    nq = len(batches) * B
    if show:
        print(f"main: host LIMSIndex range {nq / (t1 - t0):.2f} q/s, "
              f"kNN {nq / (t2 - t1):.2f} q/s (one CPU thread)", flush=True)
    return host_range, host_knn


def phase_main(X, ix, batches, host_range, host_knn, snap_cls,
               executor_cls):
    """The counted main path.  Returns the launch counts and the
    snapshot (reused by the later phases)."""
    from repro_torch.core.metrics import dist_one_to_many
    from repro_torch.kernels import _cuda

    # the (nq, np) of each pdist and range_filter launch of the counted run
    shapes, spying = shape_spy()
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    spying.start()
    t0 = time.perf_counter()
    snap = snap_cls.build(ix, device=DEVICE)
    sync()
    check(snap.rows_lp is None, "main: the snapshot holds a filter plane "
          "with REPRO_ROWS_DTYPE unset")
    ex = executor_cls(snap)
    print(f"main: snapshot K={snap.K} n_max={snap.n_max} P={snap.n_slots} "
          f"G={snap.K * snap.m} C={snap.coef.shape[-1]} "
          f"device_bytes={snap.device_nbytes()} "
          f"build_s={time.perf_counter() - t0:.3f}", flush=True)
    rates = {}
    for compact in ("on", "off"):
        os.environ["REPRO_COMPACT"] = compact
        r = rates[compact] = query_batches(ex, batches, host_range,
                                           host_knn, f"compact={compact}")
        print(f"main: REPRO_COMPACT={compact} range {r['range']:.2f} q/s "
              f"kNN {r['knn']:.2f} q/s (B={B}, k={K_NN}, wall clock incl. "
              f"host refinement); candidates/query range "
              f"{r['range_cand']:.2f} kNN {r['knn_cand']:.2f}; kNN "
              f"driver={r['driver']} rounds/batch={r['rounds']} "
              f"host_syncs/batch={r['syncs']}; "
              f"last compact gather={r['compact']}", flush=True)
    sync()
    spying.stop()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    print(f"main: launches {json.dumps(counts)} "
          f"max_memory_allocated={peak}", flush=True)
    for name in MAIN_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    check(rates["on"]["driver"] == rates["off"]["driver"] == "loop"
          and counts["knn_loop_cond"] == sum(rates["on"]["rounds"])
          + sum(rates["off"]["rounds"]),
          "main: the kNN batches did not all run the device loop (auto "
          "on a card), or knn_loop_cond's launches are not the rounds")
    for name, by in shapes.items():
        check(sum(by.values()) == counts[name],
              f"{name}: the shape tally misses launches")
        print(f"main: {name} launches by (nq, np): "
              + ", ".join(f"{n} x {s}" for s, n in sorted(by.items())),
              flush=True)

    # one batch of each kind against an f64 brute-force scan
    Q, rs = batches[0]
    got_r = ex.range_query_batch(Q, rs)
    ids_k, ds_k = ex.knn_query_batch(Q, K_NN)
    for b in range(B):
        dist = dist_one_to_many(Q[b], X, "l2")
        hit = np.nonzero(dist <= rs[b])[0]
        check(same_range(got_r[b], (hit, dist[hit])),
              f"range query {b} differs from the brute-force scan")
        top = np.argsort(dist, kind="stable")[:K_NN]
        check(np.array_equal(ds_k[b], dist[top])
              and np.array_equal(np.sort(ids_k[b]), np.sort(top)),
              f"kNN query {b} differs from the brute-force scan")
    print(f"main: batch 0 equals the f64 brute-force scan "
          f"(range hits/query={np.mean([len(g[0]) for g in got_r]):.1f})",
          flush=True)
    return counts, shapes, snap, rates


def query_batches(ex, batches, host_range, host_knn, tag: str) -> dict:
    """Every range batch, then every kNN batch, through ``ex``, each
    result equal to the host index's: q/s of each kind (wall clock,
    host refinement included), the mean certified candidates per query
    (the rows refinement scans), the kNN rounds and host syncs, and the
    last compact gather."""
    nq = len(batches) * B
    out = {"rounds": [], "syncs": [], "drivers": set()}
    cand = []
    t0 = time.perf_counter()
    for (Q, rs), want in zip(batches, host_range):
        got = ex.range_query_batch(Q, rs)
        cand.append(ex.last_profile.candidates_per_query)
        for b in range(B):
            check(same_range(got[b], want[b]),
                  f"range result differs from the host index ({tag}, "
                  f"query {b})")
    out["range"] = nq / (time.perf_counter() - t0)
    out["range_cand"] = float(np.mean(cand))
    out["compact"] = ex.last_compact
    cand = []
    t0 = time.perf_counter()
    for (Q, _), want in zip(batches, host_knn):
        ids, ds = ex.knn_query_batch(Q, K_NN)
        out["rounds"].append(ex.last_knn["rounds"])
        out["syncs"].append(ex.last_knn["host_syncs"])
        out["drivers"].add(ex.last_knn["driver"])
        cand.append(ex.last_profile.candidates_per_query)
        for b in range(B):
            check(np.array_equal(ds[b], want[b][1])
                  and np.array_equal(np.sort(ids[b]), np.sort(want[b][0])),
                  f"kNN result differs from the host index ({tag}, "
                  f"query {b})")
    out["knn"] = nq / (time.perf_counter() - t0)
    out["knn_cand"] = float(np.mean(cand))
    out["driver"] = "+".join(sorted(out["drivers"])) or "none"
    return out


def phase_error_bound(ix, snap):
    """E against pdist_rankeval's rank error at every data point: each
    stored row against its own cluster's m pivots, rg = 0."""
    from repro_torch.kernels import ops
    worst = (0.0, 0, 0.0, 0, -1, -1)
    E = snap.rank_err.cpu().numpy()
    for ci in ix.clusters:
        if ci.n == 0:
            continue
        k = ci.cid
        q = torch.from_numpy(ci.store.rows.astype(np.float32)).to(DEVICE)
        _, rank, _ = ops.pdist_rankeval(
            q, snap.pivots[k], snap.coef[k], snap.model_lo[k],
            snap.model_hi[k], snap.model_n[k],
            torch.zeros(ci.n, device=DEVICE), n_rings=snap.n_rings)
        rank = rank.cpu().numpy()                            # (m, n_i)
        for j in range(snap.m):
            true = np.searchsorted(ci.mapping.d_sorted[j],
                                   ci.pivot_d_stored[:, j], side="left")
            err = np.abs(rank[j] - true).max()
            check(err <= E[k, j], f"rank error {err} exceeds E={E[k, j]} "
                  f"(cluster {k}, pivot {j})")
            ratio = err / max(E[k, j], 1.0)
            if ratio >= worst[0]:
                worst = (ratio, int(err), float(E[k, j]), ci.n, k, j)
    # E certified again, by the kernel and by rank_math_plain in its
    # place on the same card: the same bound group for group
    from repro_torch.core import snapshot as snapshot_mod
    from repro_torch.kernels.rankeval import rank_math_plain
    e_kernel = snapshot_mod._certified_rank_table(ix, snap.coef.device)[4]
    with mock.patch.object(snapshot_mod.ops, "rankeval", rank_math_plain):
        e_plain = snapshot_mod._certified_rank_table(ix, snap.coef.device)[4]
    check(np.array_equal(e_kernel, e_plain)
          and np.array_equal(e_kernel.astype(np.float32).reshape(E.shape), E),
          "E certified by the rankeval kernel differs from E certified by "
          "its plain version, or from the snapshot's")
    n_g = snap.model_n.cpu().numpy()
    print(f"E: certified by the kernel and by its plain version: equal in "
          f"all {E.size} groups, and equal to the snapshot's", flush=True)
    print(f"E: covers pdist_rankeval's rank error at all {ix.space.n} "
          f"data points; worst observed/E = {worst[0]:.4f} (error "
          f"{worst[1]}, E {worst[2]}, n {worst[3]}, cluster {worst[4]}, "
          f"pivot {worst[5]}); groups with E = n: "
          f"{int((E >= n_g).sum())} of {E.size}", flush=True)


def phase_kernels(ix, snap, batches, counts, shapes):
    from repro_torch.core.planner import _BALL_ABS, _R_ABS, _R_REL
    from repro_torch.core.snapshot import rank_columns
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.fused import pdist_rankeval_plain
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    from repro_torch.kernels.rankeval import rank_math_plain
    from repro_torch.roofline import analysis as ra

    Q, rs = batches[0]
    q = torch.from_numpy(Q.astype(np.float32)).to(DEVICE)
    rf = torch.from_numpy(rs.astype(np.float32)).to(DEVICE)
    P, G, C = snap.n_slots, snap.K * snap.m, snap.coef.shape[-1]
    rows = snap.rows.reshape(P, D)
    piv = snap.pivots.reshape(G, D)
    coef = snap.coef.reshape(G, C)
    lo, hi, nn = (t.reshape(G) for t in
                  (snap.model_lo, snap.model_hi, snap.model_n))
    out = []

    def row(name, *args, **kw):
        out.append(kernel_row(name, counts[name], *args, **kw))

    # pdist: the kNN distance matrix (B, P), bit for bit
    got = ops.pdist(q, rows)
    want = pdist_plain(q, rows)
    check(torch.equal(got, want), "pdist differs from its plain version")
    del got, want
    row("pdist", 0.0, lambda: ops.pdist(q, rows), 20,
        lambda: pdist_plain(q, rows), 3, *ra.pdist_work(B, P, D),
        library=lambda: torch.cdist(q, rows) ** 2,
        note=f"main-path launches at this shape: "
             f"{shapes['pdist'].get((B, P), 0)} of {counts['pdist']}; "
             + issue_floor(B * P, 2 * D + 4))
    # and at the plan_knn seed's shape (B, G), where the launch is the
    # cost; a printed line only (the JSON row is the (B, P) one)
    got = ops.pdist(q, piv)
    check(torch.equal(got, pdist_plain(q, piv)),
          f"pdist differs from its plain version at ({B}, {G})")
    kernel_row("pdist", counts["pdist"], 0.0, lambda: ops.pdist(q, piv), 200,
               lambda: pdist_plain(q, piv), 20, *ra.pdist_work(B, G, D),
               library=lambda: torch.cdist(q, piv) ** 2,
               shape=f"({B}, {G})",
               note=f"main-path launches at this shape: "
                    f"{shapes['pdist'].get((B, G), 0)} of {counts['pdist']}")

    # rankeval: the snapshot's E certification (G, n_col), and the same
    # columns with NaN, +-inf and far distances planted
    N = snap.n_rings
    x = torch.from_numpy(rank_columns(ix)).to(DEVICE)
    x_odd = plant_odd(x)
    for xs in (x, x_odd):
        rk, rid = ops.rankeval(xs, coef, lo, hi, nn, N)
        rk_p, rid_p = rank_math_plain(xs, coef, lo, hi, nn, N)
        check(torch.equal(rk, rk_p) and torch.equal(rid, rid_p),
              "rankeval differs from its plain version")
    nan = torch.isnan(x_odd)
    check(bool((rk[nan] == 0).all() and (rid[nan] == 0).all()),
          "rankeval: a NaN distance does not rank 0 in ring 0")
    print(f"kernels: rankeval equals its plain version bit for bit at "
          f"{tuple(x.shape)}, and with {ODD_CELLS} NaN, +-inf and +-1e30 "
          f"distances planted ({int(nan.sum())} NaN: rank 0, ring 0)",
          flush=True)
    nc = x.shape[1]
    outs = torch.empty(2, G, nc, dtype=torch.int32, device=DEVICE)
    ptrs = [t.data_ptr() for t in (x, coef, lo, hi, nn, outs[0], outs[1])]
    ptrs += [G, nc, C, N,
             *launch_tile("rankeval", None, {"g": G, "b": nc, "c": C})]
    row("rankeval", 0.0,
        lambda: ops.rankeval(x, coef, lo, hi, nn, N), 50,
        lambda: rank_math_plain(x, coef, lo, hi, nn, N), 5,
        *ra.rankeval_work(G, nc, C),
        bare=lambda: _cuda.launch("rankeval", *ptrs, device=x.device),
        note=issue_floor(G * nc, ra.rank_ops(C)) + "; "
        + sass_instructions("rankeval", f"rankeval_kernelILi{C}E")
        + " over the 8 values a thread")

    # range_filter: the full ball prefilter (B, P) at the batch's
    # guard-widened radii
    r = rf * (1.0 + _R_REL) + _BALL_ABS
    r2 = r * r
    mask, cnt = ops.range_filter(q, rows, r)
    mask_p, cnt_p = range_filter_plain(q, rows, r2)
    n_diff = int((mask != mask_p).sum())
    print(f"kernels: range_filter mask cells differing from plain: {n_diff} "
          f"of {B * P}; count tiles differing: "
          f"{int((cnt != cnt_p).sum())}; hits={int(mask.sum())}", flush=True)
    check(n_diff == 0 and torch.equal(cnt, cnt_p),
          "range_filter mask or counts differ from its plain version")
    del mask, cnt, mask_p, cnt_p
    row("range_filter", 0.0,
        lambda: ops.range_filter(q, rows, r), 20,
        lambda: range_filter_plain(q, rows, r2), 3,
        *ra.range_filter_work(B, P, D),
        note=f"main-path launches at this shape: "
             f"{shapes['range_filter'].get((B, P), 0)} of "
             f"{counts['range_filter']} (the others on compacted buckets); "
             + issue_floor(B * P, 2 * D + 6))

    # pdist_rankeval: the fused plan stage (B, G) against the staged
    # pdist -> sqrt -> rankeval chain and its plain version, bitwise
    rg = rf * (1.0 + _R_REL) + _R_ABS

    def staged(qs, rgs):
        dq = torch.sqrt(torch.clamp(ops.pdist(qs, piv), min=0.0))
        xs = torch.cat([(dq - rgs[:, None]).T, (dq + rgs[:, None]).T], dim=1)
        rank, _ = ops.rankeval(xs, coef, lo, hi, nn, N)
        return dq, rank[:, :B], rank[:, B:]

    # and with a NaN coordinate (NaN dq), an infinite one, 1e30
    # coordinates and an infinite radius
    q_odd, rg_odd = q.clone(), rg.clone()
    q_odd[0, 3], q_odd[1], q_odd[2, 5] = float("nan"), 1e30, float("inf")
    rg_odd[3] = float("inf")
    errs = []
    for qs, rgs in ((q, rg), (q_odd, rg_odd)):
        fused = ops.pdist_rankeval(qs, piv, coef, lo, hi, nn, rgs, N)
        plain = pdist_rankeval_plain(qs, piv, coef, lo, hi, nn, rgs, N)
        for f, s, p in zip(fused, staged(qs, rgs), plain):
            check(same_bits(f, s), "fused and staged plans differ")
            check(same_bits(f, p), "pdist_rankeval differs from its plain "
                  "version")
        errs.append(max(float((f.double() - p.double()).nan_to_num(0.0)
                              .abs().max()) for f, p in zip(fused, plain)))
    check(bool(torch.isnan(fused[0][0]).all() and (fused[1][:, 0] == 0).all()
               and (fused[2][:, 0] == 0).all()),
          "pdist_rankeval: a NaN dq does not rank 0")
    print("kernels: pdist_rankeval equals the staged pdist -> sqrt -> "
          "rankeval chain and its plain version bit for bit, also with a "
          "NaN, an infinite and 1e30 query coordinates and an infinite "
          "radius (NaN dq: rank 0)", flush=True)
    outs = torch.empty(3, G, B, dtype=torch.int32, device=DEVICE)
    one = torch.empty(3, 1, 1, dtype=torch.int32, device=DEVICE)

    def bare_at(b, g, out):
        ptrs = [t.data_ptr() for t in (q, piv, coef, lo, hi, nn, rg, *out)]
        ptrs += [b, g, D, C, N,
                 *launch_tile("pdist_rankeval", None,
                              {"g": g, "b": b, "d": D, "c": C})]
        return lambda: _cuda.launch("pdist_rankeval", *ptrs, device=q.device)

    bare, floor = bare_at(B, G, outs), bare_at(1, 1, one)
    at = [time_ms(bare, 200), graph_ms(bare)]
    fl = [time_ms(floor, 200), graph_ms(floor)]
    print(f"kernels: pdist_rankeval bare launch at ({B}, {G}) against "
          f"(1, 1): CUDA events around 200 back-to-back launches "
          f"launch_ms={at[0]:.5f} launch_floor_ms={fl[0]:.5f} "
          f"({at[0] / fl[0]:.3f}x); replayed from a CUDA graph of 20 "
          f"graph_ms={at[1]:.5f} graph_floor_ms={fl[1]:.5f} "
          f"({at[1] / fl[1]:.3f}x)", flush=True)
    wrapper_breakdown((q, piv, coef, lo, hi, nn, rg), N)
    row("pdist_rankeval", errs[0],
        lambda: ops.pdist_rankeval(q, piv, coef, lo, hi, nn, rg, N), 200,
        lambda: pdist_rankeval_plain(q, piv, coef, lo, hi, nn, rg, N), 20,
        *ra.pdist_rankeval_work(B, G, D, C),
        bare=bare, graph=True,
        note=f"launch_floor_ms={fl[0]:.5f} graph_floor_ms={fl[1]:.5f}; "
        + sass_instructions("pdist_rankeval",
                            f"pdist_rankeval_kernelILi{C}E"))
    return out


# -------------------------------------------------------------------- tune
def phase_tune(ix, snap, batches, host_range, host_knn) -> None:
    """The kernel tile autotuner (kernels/autotune.py) on the card, with
    REPRO_TUNE_CACHE pointed at a temporary file: (a) ``warm`` at the
    quick buckets (every kernel and body: sql2, l1, linf, bf16, f16) and
    main's: every candidate's outputs bit-equal to the plain version's at
    its bucket (``tune`` checks each before timing it), each entry
    printed with its tiles, us and static us; (b) the four main kernels
    at main's shapes at their tuned tiles and with REPRO_AUTOTUNE=off:
    equal outputs, the wrapper's ms (CUDA events) and the device's (a
    CUDA graph of 20 calls); (c) one range and one kNN batch of main's
    through a fresh executor under the shipped table alone, equal to the
    host index's."""
    from repro_torch.core import QueryExecutor
    from repro_torch.core.planner import _BALL_ABS, _R_ABS, _R_REL
    from repro_torch.core.snapshot import rank_columns
    from repro_torch.kernels import autotune, ops
    t_phase = time.perf_counter()
    prev = {k: os.environ.get(k) for k in ("REPRO_TUNE_CACHE",
                                           "REPRO_AUTOTUNE")}
    tmp = tempfile.mkdtemp()
    try:
        os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "tune.json")
        os.environ["REPRO_AUTOTUNE"] = "on"
        autotune._reset()
        t0 = time.perf_counter()
        shapes = autotune._WARM_QUICK + autotune._WARM_MAIN
        res = autotune.warm(shapes)
        for key, ent in res.items():
            ntiles = len(autotune._candidates(
                *autotune._parse_key(key)[1:]))
            static = autotune.static_tiles(*autotune._parse_key(key)[1:])
            print(f"tune: (a) {key}: {ntiles} candidate tiles, each "
                  f"bit-equal to the plain version; tiles {ent['tiles']} "
                  f"{ent['us']:.3f} us, static {static} "
                  f"{ent['static_us']:.3f} us "
                  f"({ent['static_us'] / ent['us']:.3f}x)", flush=True)
        print(f"tune: (a) warm over {len(shapes)} buckets in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # (b) main's four kernels at the tuned tiles and at the static ones
        Q, rs = batches[0]
        q = torch.from_numpy(Q.astype(np.float32)).to(DEVICE)
        rf = torch.from_numpy(rs.astype(np.float32)).to(DEVICE)
        P, G, C = snap.n_slots, snap.K * snap.m, snap.coef.shape[-1]
        N = snap.n_rings
        rows = snap.rows.reshape(P, D)
        piv = snap.pivots.reshape(G, D)
        coef = snap.coef.reshape(G, C)
        lo, hi, nn = (t.reshape(G) for t in
                      (snap.model_lo, snap.model_hi, snap.model_n))
        x = torch.from_numpy(rank_columns(ix)).to(DEVICE)
        r = rf * (1.0 + _R_REL) + _BALL_ABS
        rg = rf * (1.0 + _R_REL) + _R_ABS
        p_pad = -(-P // 128) * 128
        rows_b = (
            ("pdist", ("pdist", "sql2", {"q": B, "p": P, "d": D}),
             lambda: ops.pdist(q, rows), 20),
            ("range_filter",
             ("range_filter", "sql2", {"q": B, "p": p_pad, "d": D}),
             lambda: ops.range_filter(q, rows, r), 20),
            ("rankeval", ("rankeval", None,
                          {"g": G, "b": x.shape[1], "c": C}),
             lambda: ops.rankeval(x, coef, lo, hi, nn, N), 50),
            ("pdist_rankeval", ("pdist_rankeval", None,
                                {"g": G, "b": B, "d": D, "c": C}),
             lambda: ops.pdist_rankeval(q, piv, coef, lo, hi, nn, rg, N),
             200))
        for name, (kernel, metric, dims), fn, iters in rows_b:
            got = {}
            for mode in ("on", "off", "off", "on"):
                os.environ["REPRO_AUTOTUNE"] = mode
                out = autotune._outputs(fn())
                got.setdefault(mode, {"out": out, "ms": [], "dev": []})
                got[mode]["ms"].append(time_ms(fn, iters))
                got[mode]["dev"].append(graph_ms(fn))
            check(autotune.same_outputs(got["on"]["out"], got["off"]["out"]),
                  f"tune: (b) {name}'s outputs at its tuned tiles differ "
                  "from the static tiles'")
            os.environ["REPRO_AUTOTUNE"] = "on"
            tiles = autotune.tiles_for(kernel, metric, dims)
            static = autotune.static_tiles(kernel, metric, dims)
            lookup_us = host_us(lambda: autotune.tiles_for(
                kernel, metric, dims, q.device))
            on, off = ({k: float(np.mean(v)) for k, v in got[m].items()
                        if k != "out"} for m in ("on", "off"))
            print(f"tune: (b) {name} at {tuple(dims.values())}: tuned "
                  f"{tiles or static}{'' if tiles else ' (static)'} "
                  f"wrapper_ms={on['ms']:.5f} device_ms={on['dev']:.5f}; "
                  f"REPRO_AUTOTUNE=off {static} wrapper_ms={off['ms']:.5f} "
                  f"device_ms={off['dev']:.5f}; device off/tuned "
                  f"{off['dev'] / on['dev']:.3f}x (turns on, off, off, on); "
                  f"outputs equal; the table lookup {lookup_us:.3f} host us "
                  f"a call", flush=True)
            del got

        # (c) main's batches under the shipped table alone
        os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "none.json")
        autotune._reset()
        shipped = [k for k in autotune._entries()
                   if k.startswith(autotune.backend_key() + "/")]
        ex = QueryExecutor(snap)
        rates = query_batches(ex, batches[:1], host_range[:1], host_knn[:1],
                              "tune (c), the shipped table")
        main_tiles = []
        for kernel, metric, dims in autotune._WARM_MAIN:
            bd = {k: autotune.bucket(v) for k, v in dims.items()}
            t = autotune.tiles_for(kernel, metric, dims)
            main_tiles.append(f"{kernel} {tuple(bd.values())} "
                              f"{t if t else 'static'}")
        print(f"tune: (c) a fresh executor under the shipped table "
              f"({len(shipped)} entries for {autotune.backend_key()}; main's "
              f"buckets: {'; '.join(main_tiles)}): 1 range and 1 kNN batch "
              f"equal to the host index (range {rates['range']:.2f} q/s, "
              f"kNN {rates['knn']:.2f} q/s)", flush=True)
        del ex
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune._reset()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"tune: phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_roof(snap, batch) -> None:
    """The query pipeline's roofline report on the card
    (roofline.pipeline.pipeline_report at main's snapshot, n =
    1,000,000, and main's first batch of 64: the shapes the main path
    launches; each stage's bytes and flops from roofline.analysis, its
    time by CUDA events, against the H100's data sheet); a stage above
    1.05 of its bound is a wrong count."""
    from repro_torch.roofline.pipeline import pipeline_report, render
    t0 = time.perf_counter()
    rep = pipeline_report(snapshot=snap, queries=batch)
    for line in render(rep).splitlines():
        print(f"roof: {line}", flush=True)
    for st in rep["stages"]:
        check(st["roofline_utilization"] <= 1.05,
              f"roof: {st['stage']} at {st['roofline_utilization']:.4f} of "
              "its bound: the count is wrong")
    print(f"roof: every stage at most 1.05 of its bound; phase in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------- knn_loop
def d2h_copies(fn, windows: int = D2H_WINDOWS) -> list:
    """Device-to-host copies one call of ``fn`` makes (torch.profiler's
    memcpy records) in each of ``windows`` one-call windows.  A caller
    reads the most: the profiler drops a window's device records at
    random and never adds one (a forced batch's window once held 1 of
    its 2 copies; kernel_row's windows hold none at some rows), so the
    readings are printed beside it."""
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(windows):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        counts.append(sum(e.count for e in prof.key_averages()
                          if "DtoH" in e.key or "Device -> Host" in e.key))
    return counts


def mem_now() -> tuple[int, int]:
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def fresh_memory() -> tuple[int, int]:
    """(allocated, reserved) after a collection and an empty cache: what
    the process holds with no cached blocks."""
    gc.collect()
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return mem_now()


def loop_turns(make_ex, batches, host_knn, tag: str, drivers) -> list:
    """kNN batches through a fresh executor a turn (``make_ex()``), the
    turns under ``drivers`` in order: every answer equal to main's host
    answers; q/s (all batches, the first's capture included), rounds,
    host syncs, launches, the loop's captures and their ms, and
    memory_allocated / memory_reserved after each batch, peak reserved
    over the turn and reserved after the executor is dropped (each turn
    starts from an empty cache).  Returns each turn's numbers."""
    from repro_torch.kernels import _cuda
    out = []
    for i, driver in enumerate(drivers):
        os.environ["REPRO_KNN_DRIVER"] = driver
        base = fresh_memory()
        ex = make_ex()
        _cuda.reset_launches()
        rounds, syncs, mem, stages = [], [], [], []
        t0 = time.perf_counter()
        for (Q, _), want in zip(batches, host_knn):
            ids, ds = ex.knn_query_batch(Q, K_NN)
            for b in range(len(Q)):
                check(same_knn((ids[b], ds[b]), want[b]),
                      f"knn_loop: {tag} turn {i + 1} ({driver}): query {b} "
                      f"differs from the host index")
            check(ex.last_knn["driver"] == driver,
                  f"knn_loop: {tag} ran {ex.last_knn['driver']}, not "
                  f"{driver}")
            rounds.append(ex.last_knn["rounds"])
            syncs.append(ex.last_knn["host_syncs"])
            stages.append(ex.last_profile.stages)
            sync()
            mem.append(mem_now())
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_reserved()
        captures = list(ex._loop.captures) if ex._loop is not None else []
        del ex
        after = fresh_memory()
        r = SimpleNamespace(driver=driver, qps=len(batches) * len(
            batches[0][0]) / secs, rounds=rounds, syncs=syncs, mem=mem,
            peak=peak, base=base, after=after, counts=counts,
            captures=captures)
        out.append(r)
        print(f"knn_loop: {tag} turn {i + 1} {driver}: {len(batches)} kNN "
              f"batches of {len(batches[0][0])} (k={K_NN}) {r.qps:.2f} q/s "
              f"(wall clock incl. capture and host refinement); "
              f"rounds/batch={rounds} host_syncs/batch={syncs}; graph "
              f"captures {len(captures)} "
              f"({', '.join(f'{c * 1e3:.1f}' for c in captures)} ms); "
              f"launches {json.dumps(counts)}; profile stages, mean ms a "
              f"batch after the first: " + " ".join(
                  f"{k}={np.mean([st[k] for st in stages[1:]]) * 1e3:.1f}"
                  for k in stages[0]), flush=True)
        print(f"knn_loop: {tag} turn {i + 1} {driver}: memory (allocated, "
              f"reserved) before {base}, after each batch "
              f"{[m for m in mem]}, peak reserved {peak}, after the "
              f"executor is dropped {after}", flush=True)
    return out


def loop_launches_hold(turns, S: int, tag: str) -> None:
    """Replays counted: under the loop, pdist_rankeval = S x the rounds,
    knn_loop_cond = the rounds and pdist = 2 S a batch (the planner's
    pivots and the seed); under rounds, pdist_rankeval = S x the
    rounds."""
    for t in turns:
        n, R = t.counts, sum(t.rounds)
        want = {"pdist_rankeval": S * R,
                "pdist": 2 * S * len(t.rounds)}
        if t.driver == "loop":
            want["knn_loop_cond"] = R
            check(set(t.syncs) == {2}, f"knn_loop: {tag} loop host_syncs "
                  f"{t.syncs}, not 2 a batch")
        for name, v in want.items():
            check(n.get(name, 0) == v, f"knn_loop: {tag} {t.driver}: "
                  f"{name} launched {n.get(name, 0)} times, not {v}")
        check(t.after[1] <= t.base[1], f"knn_loop: {tag} {t.driver}: "
              f"reserved {t.after[1]} after the executor was dropped, above "
              f"the {t.base[1]} before it")


def loop_memory_holds(turns, tag: str) -> int:
    """Peak reserved under the loop <= under rounds + LOOP_MEMORY_SLACK,
    and no growth from the first loop turn to the second.  Returns the
    loop's excess over rounds."""
    loop = [t.peak - t.base[1] for t in turns if t.driver == "loop"]
    rounds = [t.peak - t.base[1] for t in turns if t.driver == "rounds"]
    excess = max(loop) - max(rounds)
    check(excess <= LOOP_MEMORY_SLACK, f"knn_loop: {tag}: peak reserved "
          f"under the loop {loop} exceeds rounds' {rounds} by {excess} B")
    check(loop[-1] <= loop[0] + LOOP_TURN_SLACK, f"knn_loop: {tag}: the "
          f"loop's peak grew from turn to turn: {loop}")
    print(f"knn_loop: {tag}: peak reserved over each turn's start, loop "
          f"{loop} B, rounds {rounds} B: loop - rounds = {excess} B <= "
          f"{LOOP_MEMORY_SLACK} B; the loop's second turn within "
          f"{LOOP_TURN_SLACK} B of its first",
          flush=True)
    return excess


def loop_cond_row(launches: int) -> dict:
    """knn_loop_cond's row: the condition alone in a WHILE graph at
    main's B, held to its plain version (rounds and flag, all open and
    all done, max_rounds 1 and 64), timed per round: the graph at
    max_rounds 64 (CUDA events, one launch) / 64 against the plain
    version's 64 rounds on the card / 64."""
    from repro_torch.kernels.graph_loop import (WhileGraph, loop_cond_plain,
                                                loop_rounds,
                                                loop_rounds_plain)
    err = 0
    for fill in (False, True):
        for mr in (1, 3, 64):
            done = torch.full((B,), fill, dtype=torch.bool, device=DEVICE)
            got = loop_rounds(done, mr)
            want = loop_rounds_plain(done, mr)
            err = max(err, *(abs(int(g) - int(w))
                             for g, w in zip(got, want)))
    check(err == 0, "knn_loop: knn_loop_cond differs from its plain version")
    R = 64
    done = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    rounds = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    flag = torch.zeros_like(rounds)
    graph = WhileGraph(None, done, rounds, R, flag)

    def run_graph():
        rounds.zero_()
        graph.launch()

    def run_plain():
        rounds.zero_()
        for _ in range(R):
            loop_cond_plain(done, rounds, R)

    ms = time_ms(run_graph, 20) / R
    plain_ms = time_ms(run_plain, 5) / R
    check(int(rounds) == R, "knn_loop: the timed WHILE graph ran "
          f"{int(rounds)} rounds, not {R}")
    graph.close()
    from repro_torch.roofline import analysis as ra, hw
    b_ms, by = hw.bound(*ra.knn_loop_cond_work(B))
    print(f"kernels: knn_loop_cond (one thread; the condition of the "
          f"loop's WHILE node) at B={B} max_abs_err={err} ms={ms:.5f} a "
          f"round (the graph at max_rounds {R}, {R} rounds) plain_ms="
          f"{plain_ms:.5f} a round bound_ms={b_ms:.8f} ({by}) "
          f"library_ms=None", flush=True)
    return {"name": "knn_loop_cond", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
            "replaces": REPLACES["knn_loop_cond"], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def forced_rounds_batch(snap, batches, host_knn) -> None:
    """(b) a batch of LOOP_FORCED_B queries forced to >= 3 rounds on
    main's snapshot: its filter plane set to its own f32 rows with the
    margin widened to 8 (max k-th distance + BALL_ABS) (a looser bound
    stays certified; round 2's radius stays under the k-th distance plus
    that margin), beside a 1-round batch of as many queries on main's
    snapshot: answers equal to the host's, and device-to-host copies
    (torch.profiler) equal for the two batches under the loop, each
    after its graph's capture; the host-driven rounds' copies of the
    same two batches printed beside them."""
    from repro_torch.core import QueryExecutor
    from repro_torch.core.planner import _BALL_ABS
    os.environ["REPRO_KNN_DRIVER"] = "loop"
    Q, want = batches[0][0][:LOOP_FORCED_B], host_knn[0][:LOOP_FORCED_B]
    eps = 8.0 * (max(float(w[1][-1]) for w in want) + _BALL_ABS)
    wide = dataclasses.replace(snap, rows_lp=snap.rows, lp_eps=eps)
    seen, host_rounds = {}, {}
    for tag, ex in (("1-round", QueryExecutor(snap)),
                    ("forced", QueryExecutor(wide))):
        ex.knn_query_batch(Q, K_NN)             # the capture
        t0 = time.perf_counter()
        last = {}                   # the last profiled call's answers
        windows = d2h_copies(lambda: last.update(
            zip(("ids", "ds"), ex.knn_query_batch(Q, K_NN))))
        copies = max(windows)
        secs = (time.perf_counter() - t0) / D2H_WINDOWS
        ids, ds = last["ids"], last["ds"]
        for b in range(len(Q)):
            check(same_knn((ids[b], ds[b]), want[b]),
                  f"knn_loop: (b) {tag} query {b} differs from the host")
        seen[tag] = (copies, ex.last_knn["rounds"],
                     ex.last_profile.candidates_per_query, secs, windows)
        os.environ["REPRO_KNN_DRIVER"] = "rounds"
        host_rounds[tag] = max(d2h_copies(
            lambda: ex.knn_query_batch(Q, K_NN)))
        check(ex.last_knn["rounds"] == seen[tag][1],
              f"knn_loop: (b) {tag}: rounds differ between the drivers")
        os.environ["REPRO_KNN_DRIVER"] = "loop"
        del ex
    check(seen["1-round"][1] == 1 and seen["forced"][1] >= 3,
          f"knn_loop: (b) rounds {seen}")
    check(seen["1-round"][0] == seen["forced"][0] > 0,
          f"knn_loop: (b) device-to-host copies differ: {seen}")
    print(f"knn_loop: (b) {LOOP_FORCED_B} of batch 0's queries: main's "
          f"snapshot {seen['1-round'][1]} round, "
          f"{seen['1-round'][0]} device-to-host copies, "
          f"{seen['1-round'][2]:.1f} candidates/query, "
          f"{seen['1-round'][3] * 1e3:.1f} ms (profiled); margin widened "
          f"to {eps:.6f}: {seen['forced'][1]} rounds, "
          f"{seen['forced'][0]} device-to-host copies, "
          f"{seen['forced'][2]:.1f} candidates/query, "
          f"{seen['forced'][3] * 1e3:.1f} ms; answers equal to the host; "
          f"REPRO_KNN_DRIVER=rounds on the same batches: "
          f"{host_rounds['1-round']} and {host_rounds['forced']} "
          f"device-to-host copies (the most over {D2H_WINDOWS} profiler "
          f"windows; the loop's windows read {seen['1-round'][4]} and "
          f"{seen['forced'][4]})", flush=True)


def loop_keys(snap, batches, host_knn) -> None:
    """(c) one executor through LOOP_KEYS batch buckets of batch 0
    (64 down to 1 queries: 7 graph keys, 4 kept): reserved memory after
    each, none above the first four's largest (the card's buffers and
    pool hold the largest key's needs)."""
    from repro_torch.core import QueryExecutor
    os.environ["REPRO_KNN_DRIVER"] = "loop"
    fresh_memory()
    ex = QueryExecutor(snap)
    Q, want = batches[0][0], host_knn[0]
    reserved = []
    for n in LOOP_KEYS:
        ids, ds = ex.knn_query_batch(Q[:n], K_NN)
        for b in range(n):
            check(same_knn((ids[b], ds[b]), want[b]),
                  f"knn_loop: (c) B={n} query {b} differs from the host")
        sync()
        reserved.append(torch.cuda.memory_reserved())
        if n == B:
            loop_kernels_vs_plain(ex)
    graphs = len(ex._loop.entries)
    check(graphs <= 4 and len(ex._loop.captures) == len(LOOP_KEYS),
          f"knn_loop: (c) {graphs} graphs kept, "
          f"{len(ex._loop.captures)} captures")
    check(max(reserved[4:]) <= max(reserved[:4]),
          f"knn_loop: (c) reserved grew with the keys: {reserved}")
    print(f"knn_loop: (c) batch sizes {list(LOOP_KEYS)} on one executor: "
          f"{len(ex._loop.captures)} captures, {graphs} graphs kept (one "
          f"pool on the card: {ex._loop.card.graphs} graph(s)); reserved "
          f"after each {reserved}: no growth past the first four keys",
          flush=True)
    del ex


def loop_kernels_vs_plain(ex) -> None:
    """pdist_rankeval and pdist at the loop's shapes, on the inputs the
    card's buffers hold after ``ex``'s batch of B (its queries, the
    radii the loop ended at): bit for bit against their plain
    versions."""
    from repro_torch.core.planner import _R_ABS, _R_REL
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import pdist_rankeval_plain
    from repro_torch.kernels.pdist import pdist_plain
    snap, card = ex.snap, ex._loop.card
    with card.lock:
        st = card.buffers(ex, B)
        q, rf = st.qf.clone(), st.r.clone()
    d, G = snap.d, snap.K * snap.m
    args = (q, snap.pivots.reshape(G, d), snap.coef.reshape(G, -1),
            snap.model_lo.reshape(-1), snap.model_hi.reshape(-1),
            snap.model_n.reshape(-1), rf * (1.0 + _R_REL) + _R_ABS,
            snap.n_rings)
    fused, plain = ops.pdist_rankeval(*args), pdist_rankeval_plain(*args)
    for f, p in zip(fused, plain):
        check(same_bits(f, p), "knn_loop: pdist_rankeval differs from its "
              "plain version at the loop's shape")
    rows = snap.rows.reshape(-1, d)
    check(torch.equal(ops.pdist(q, rows), pdist_plain(q, rows)),
          "knn_loop: pdist differs from its plain version at the seed's "
          "shape")
    print(f"knn_loop: pdist_rankeval ({B}, G={G}) on the loop's queries and "
          f"final radii, and pdist ({B}, {rows.shape[0]}) on its queries: "
          f"bit for bit equal to their plain versions", flush=True)


def phase_knn_loop(snap, batches, host_knn, counts) -> dict:
    """The device-resident kNN loop (module doc, parts (a)-(d)).
    Returns knn_loop_cond's kernel row."""
    from repro_torch.core import QueryExecutor, ShardedExecutor
    from repro_torch.sharding import Mesh
    t_phase = time.perf_counter()
    has_if = hasattr(torch._C, "_CUDAGraph") and hasattr(
        torch._C._CUDAGraph, "begin_capture_to_if_node")
    print(f"knn_loop: torch {torch.__version__} (CUDA {torch.version.cuda}):"
          f" CUDAGraph.begin_capture_to_if_node "
          f"{'present' if has_if else 'absent'}; the loop runs as a WHILE "
          f"conditional node built by csrc/graph_loop.cu over one captured "
          f"round", flush=True)
    try:
        turns = loop_turns(lambda: QueryExecutor(snap), batches, host_knn,
                           "(a) single", ("loop", "rounds", "loop",
                                          "rounds"))
        loop_launches_hold(turns, 1, "(a) single")
        loop_memory_holds(turns, "(a) single")
        loop, rounds = turns[0::2], turns[1::2]
        print(f"knn_loop: (a) q/s loop {[round(t.qps, 2) for t in loop]} "
              f"rounds {[round(t.qps, 2) for t in rounds]} (turns 1, 3 and "
              f"2, 4; no gain claimed); host_syncs/batch loop 2, rounds "
              f"{sorted(set(rounds[0].syncs))}", flush=True)
        forced_rounds_batch(snap, batches, host_knn)
        loop_keys(snap, batches, host_knn)
        mesh = Mesh((torch.device(DEVICE, 0),) * SHARDS)
        sel = batches[:LOOP_SHARDED_CUT]
        print(f"knn_loop: CUT: (d) runs {len(sel)} of main's "
              f"{len(batches)} kNN batches a turn", flush=True)
        turns = loop_turns(lambda: ShardedExecutor(snap, mesh=mesh), sel,
                           host_knn, f"(d) sharded {mesh_name(mesh)}",
                           ("loop", "rounds"))
        loop_launches_hold(turns, SHARDS, "(d) sharded")
        loop_memory_holds(turns, "(d) sharded")
    finally:
        os.environ.pop("REPRO_KNN_DRIVER", None)
    row = loop_cond_row(counts["knn_loop_cond"])
    print(f"knn_loop: all parts in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return row


def phase_lp(ix, batches, host_range, host_knn, rates) -> list:
    """The reduced-precision filter plane, bf16 then f16 (module doc,
    part 6).  Returns the four kernel rows."""
    from repro_torch.core import QueryExecutor
    from repro_torch.core.planner import _BALL_ABS, _R_REL
    from repro_torch.core.snapshot import LP_DTYPES, LIMSSnapshot, \
        lp_quant_eps
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    from repro_torch.roofline import analysis as ra
    t_phase = time.perf_counter()
    G = ix.K * ix.m
    out = []
    for dt in ("bf16", "f16"):
        os.environ["REPRO_ROWS_DTYPE"] = dt
        names = (f"pdist_{dt}", f"range_filter_{dt}")
        shapes, spying = shape_spy(("pdist", "range_filter") + names)
        sync()
        _cuda.reset_launches()
        spying.start()
        try:
            t0 = time.perf_counter()
            snap = LIMSSnapshot.build(ix, device=DEVICE)
            sync()
            t_build = time.perf_counter() - t0
            P = snap.n_slots
            plane = snap.rows_lp.reshape(P, D)
            rows32 = torch.from_numpy(snap.rows_np.astype(np.float32))
            host_lp = rows32.to(LP_DTYPES[dt])
            eps_host = lp_quant_eps(rows32, host_lp)
            check(plane.dtype == LP_DTYPES[dt]
                  and torch.equal(plane.cpu(), host_lp)
                  and snap.lp_eps == eps_host,
                  f"lp: {dt}: the plane or lp_eps differs from the host's "
                  f"rounding of the rows ({snap.lp_eps} vs {eps_host})")
            print(f"lp: {dt} snapshot built in {t_build:.3f} s; lp_eps="
                  f"{snap.lp_eps!r} (= lp_quant_eps recomputed on the "
                  f"host); plane {plane.nbytes} B beside the f32 rows' "
                  f"{snap.rows.nbytes} B; device_bytes "
                  f"{snap.device_nbytes()}", flush=True)
            ex = QueryExecutor(snap)
            for compact in ("on", "off"):
                os.environ["REPRO_COMPACT"] = compact
                r = query_batches(ex, batches, host_range, host_knn,
                                  f"{dt}, compact={compact}")
                f = rates[compact]
                print(f"lp: {dt} REPRO_COMPACT={compact} range "
                      f"{r['range']:.2f} q/s (f32 {f['range']:.2f}) kNN "
                      f"{r['knn']:.2f} q/s (f32 {f['knn']:.2f}); "
                      f"candidates/query range {r['range_cand']:.2f} (f32 "
                      f"{f['range_cand']:.2f}) kNN {r['knn_cand']:.2f} (f32 "
                      f"{f['knn_cand']:.2f}); kNN rounds/batch="
                      f"{r['rounds']}; last compact gather={r['compact']}",
                      flush=True)
            sync()
        finally:
            spying.stop()
        counts = dict(_cuda.LAUNCHES)
        print(f"lp: {dt} launches {json.dumps(counts)}", flush=True)
        for name, by in shapes.items():
            check(sum(by.values()) == counts[name],
                  f"lp: {name}: the shape tally misses launches")
            if by:
                print(f"lp: {dt} {name} launches by (nq, np): "
                      + ", ".join(f"{n} x {s}" for s, n in sorted(by.items())),
                      flush=True)
        check(all(counts[n] > 0 for n in names),
              f"lp: {dt}: a 2-byte entry point was not launched")
        check(counts["range_filter"] == 0
              and all(npts == G for _, npts in shapes["pdist"]),
              f"lp: {dt}: an f32 pdist or range_filter ran over the plane")

        # the two kernels at (B, P, d 8) against their plain versions
        Q, rs = batches[0]
        q = torch.from_numpy(Q.astype(np.float32)).to(DEVICE)
        r = torch.from_numpy(rs.astype(np.float32)).to(DEVICE) \
            * (1.0 + _R_REL) + _BALL_ABS + snap.lp_eps
        got = ops.pdist(q, plane)
        check(torch.equal(got, pdist_plain(q, plane)),
              f"lp: pdist_{dt} differs from its plain version")
        mask, cnt = ops.range_filter(q, plane, r)
        mask_p, cnt_p = range_filter_plain(q, plane, r * r)
        check(torch.equal(mask, mask_p) and torch.equal(cnt, cnt_p),
              f"lp: range_filter_{dt} mask or counts differ from its plain "
              f"version")
        print(f"kernels: pdist_{dt} and range_filter_{dt} equal their plain "
              f"versions bit for bit at ({B}, {P}, d {D}) (range_filter "
              f"mask and counts, hits={int(mask.sum())})", flush=True)
        del got, mask, cnt, mask_p, cnt_p
        out.append(kernel_row(
            f"pdist_{dt}", counts[f"pdist_{dt}"], 0.0,
            lambda: ops.pdist(q, plane), 20, lambda: pdist_plain(q, plane),
            3, *ra.pdist_work(B, P, D, point_bytes=2),
            note=f"library: none (no PyTorch call computes a 2-byte-point "
                 f"f32 Gram distance); lp-phase launches at this shape: "
                 f"{shapes[f'pdist_{dt}'].get((B, P), 0)}"))
        out.append(kernel_row(
            f"range_filter_{dt}", counts[f"range_filter_{dt}"], 0.0,
            lambda: ops.range_filter(q, plane, r), 20,
            lambda: range_filter_plain(q, plane, r * r), 3,
            *ra.range_filter_work(B, P, D, point_bytes=2),
            note="library: none; lp-phase launches at this shape: "
                 f"{shapes[f'range_filter_{dt}'].get((B, P), 0)}"))
        del ex, snap, plane
    # f32 once more, after the 2-byte turns: main's q/s and these bracket
    # them, so the host's drift over the phase shows beside the gain
    os.environ["REPRO_ROWS_DTYPE"] = "off"
    ex = QueryExecutor(LIMSSnapshot.build(ix, device=DEVICE))
    for compact in ("on", "off"):
        os.environ["REPRO_COMPACT"] = compact
        r = query_batches(ex, batches, host_range, host_knn,
                          f"f32 again, compact={compact}")
        f = rates[compact]
        print(f"lp: f32 again REPRO_COMPACT={compact} range "
              f"{r['range']:.2f} q/s (main {f['range']:.2f}) kNN "
              f"{r['knn']:.2f} q/s (main {f['knn']:.2f})", flush=True)
    os.environ["REPRO_COMPACT"] = "on"
    print(f"lp: all parts in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# the NaN, +-inf and far distances planted among the rank columns
ODD_VALUES = (float("nan"), float("inf"), float("-inf"), 1e30, -1e30)
ODD_CELLS = 64


def plant_odd(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """A copy of ``x`` with ODD_CELLS cells, at seeded places, set to
    ODD_VALUES in turn."""
    out = x.clone()
    g = torch.Generator().manual_seed(seed)
    cells = torch.randperm(out.numel(), generator=g)[:ODD_CELLS]
    vals = torch.tensor(ODD_VALUES).repeat(ODD_CELLS // len(ODD_VALUES) + 1)
    out.view(-1)[cells.to(out.device)] = vals[:ODD_CELLS].to(out.device)
    return out


def wrapper_breakdown(args, n_rings: int) -> None:
    """Host microseconds of each step of ``ops.pdist_rankeval``'s call
    at the plan's shape (1,000 calls each), beside the parent tree's way
    of doing the same step, and the whole wrapper."""
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.pdist import check_operands
    q, piv, coef = args[:3]
    B, G = q.shape[0], piv.shape[0]
    dev = q.device
    index = torch.cuda.current_device()
    fn = _cuda._FUNCS["pdist_rankeval", None]
    outs = torch.empty(3, G, B, dtype=torch.int32, device=dev)
    cargs = ([t.data_ptr() for t in (*args, *outs)]
             + [B, G, q.shape[1], coef.shape[1], n_rings,
                *launch_tile("pdist_rankeval", None,
                             {"g": G, "b": B, "d": q.shape[1],
                              "c": coef.shape[1]})])
    stream = _cuda.current_stream(index)

    def outputs_one():
        dq, lo_, hi_ = torch.empty(3, G, B, dtype=torch.int32,
                                   device=dev).unbind(0)
        return dq.view(torch.float32).view(B, G), lo_, hi_

    def stream_parent():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    steps = {
        "7 x .to(f32).contiguous() (parent)":
            lambda: [t.to(torch.float32).contiguous() for t in args],
        "7 x _f32 (now)": lambda: [ops._f32(t) for t in args],
        "check_operands(7)": lambda: check_operands(*args),
        "3 x torch.empty (parent, now)": lambda: (
            torch.empty(B, G, device=dev),
            torch.empty(G, B, dtype=torch.int32, device=dev),
            torch.empty(G, B, dtype=torch.int32, device=dev)),
        "1 x torch.empty + unbind + views (not taken)": outputs_one,
        "device switch + current_stream (parent)": stream_parent,
        "current_device + raw stream (now)": lambda: (
            torch.cuda.current_device(), _cuda.current_stream(index)),
        "ctypes entry point (the launch itself)":
            lambda: fn(*cargs, stream),
        "_cuda.launch": lambda: _cuda.launch("pdist_rankeval", *cargs,
                                             device=dev),
        "whole ops.pdist_rankeval": lambda: ops.pdist_rankeval(
            *args, n_rings=n_rings),
    }
    print("kernels: pdist_rankeval wrapper breakdown (host us a call, "
          "1,000 calls each, perf_counter_ns): "
          + "; ".join(f"{k} {host_us(f):.3f}" for k, f in steps.items()),
          flush=True)


def issue_floor(cells: int, instr_per_cell: int) -> str:
    """A note for the kernels: lines: the time the card needs to issue
    ``instr_per_cell`` f32 instructions for each of ``cells`` outputs (the
    fixed no-FMA operation order of gram.cuh), at 128 lanes per SM and the
    SMs' maximum clock from nvidia-smi.  Beside the bound, not in it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = cells * instr_per_cell / (sms * 128 * mhz * 1e6) * 1e3
    return (f"issue_floor_ms={ms:.4f} ({instr_per_cell} f32 instructions "
            f"a cell, {sms} SMs x 128 lanes at {mhz:.0f} MHz)")


def kernel_row(name, launches, err, call, iters, plain, plain_iters, nbytes,
               flops, library=None, flop_per_s=None, note="",
               shape="", bare=None, graph=False, kernel=None) -> dict:
    """Time ``call`` (the wrapper) and ``plain`` with CUDA events, and
    the kernel's own device time under the profiler: the median over
    the windows of PROFILER_WINDOWS single calls that hold device
    records (torch.profiler drops a one-call window's device records
    at random; the row says how many held them).  ``bare`` (a bare
    ``_cuda.launch`` into a preallocated output) is timed with CUDA
    events too, and with ``graph`` also replayed from a CUDA graph
    (graph_ms).  Print the row (with ``note``, and ``shape`` where it is
    not the row's main-path shape) and return it for the JSON line;
    ``kernel`` names the launched kernel where the row's name is one of
    its shapes.  The bound is ``roofline.hw.bound`` of ``nbytes`` and
    ``flops`` (``roofline.analysis``'s counts) at ``flop_per_s`` (f32 if
    None)."""
    from repro_torch.kernels import _cuda
    from repro_torch.roofline.hw import bound
    ms = time_ms(call, iters)
    plain_ms = time_ms(plain, plain_iters)
    library_ms = time_ms(library, 10) if library else None
    windows = [device_busy(call)[1] for _ in range(PROFILER_WINDOWS)]
    held = [w for w in windows if w > 0.0]
    kernel_ms = f"{np.median(held):.4f}" if held else "none"
    launch_ms = f" launch_ms={time_ms(bare, iters):.4f}" if bare else ""
    if graph:
        launch_ms += f" graph_ms={graph_ms(bare):.5f}"
    b_ms, by = bound(nbytes, flops, flop_per_s)
    print(f"kernels: {name}{' at ' + shape if shape else ''} "
          f"max_abs_err={err} ms={ms:.4f}{launch_ms} "
          f"profiler_device_ms={kernel_ms} ({len(held)} of "
          f"{PROFILER_WINDOWS} windows held device records) "
          f"plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({by}) library_ms={library_ms}"
          f"{' ' + note if note else ''}", flush=True)
    kernel = kernel or name
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{_cuda.SOURCES[kernel]}",
            "replaces": REPLACES[kernel], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms}


def is_nccl_kernel(name: str) -> bool:
    """An NCCL kernel's profiler name; not the ``nccl:all_reduce``-style
    record of the same collective, which torch.profiler gives the
    kernel's device time too."""
    return name.lower().startswith(("nccldevkernel", "ncclkernel"))


def nccl_ms(top) -> float:
    """The device ms of the NCCL kernels among ``device_busy``'s ``top``."""
    return sum(t for n, t in top if is_nccl_kernel(n))


def device_busy(fn, n_top: int | None = 6) -> tuple[float, float, list]:
    """(wall ms, device ms, top device activities; all with ``n_top``
    None) of one call of ``fn`` under torch.profiler.  Only the
    device's own events count (kernels and copies); the CPU ops that
    launched them are skipped, or their device time would be counted
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [(e.key[:48], e.device_time_total / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    evs = sorted((e for e in evs if e[1] > 0), key=lambda e: -e[1])
    return wall, sum(t for _, t in evs), evs[:n_top]


def phase_profile(ex, batches):
    """Where one batch's time goes: host-clock stages, each ended by a
    device synchronise, and the device's busy share under
    torch.profiler (run with --profile)."""
    from repro_torch.core.metrics import dist_one_to_many
    Q, rs = batches[-1]
    T = time.perf_counter

    def refine_range(hit, plan):
        for b in range(B):
            idx = np.nonzero(hit[b])[0]
            d = dist_one_to_many(Q[b], ex.snap.rows_np[idx], "l2")
            ex.snap.gids_np[idx][d <= plan.radii[b]]

    for compact in ("on", "off"):
        os.environ["REPRO_COMPACT"] = compact
        ex.range_query_batch(Q, rs)                     # warm
        st = {}
        t0 = T()
        plan = ex.planner.plan_range(Q, rs)
        plan.mask_dev
        sync()
        st["plan_device"] = T() - t0
        t0 = T()
        plan.mask
        st["mask_to_host"] = T() - t0
        if compact == "on":
            t0 = T()
            slots = plan.compact_slots()
            st["compact_slots_host"] = T() - t0
            rf = torch.from_numpy(plan.radii.astype(np.float32)).to(DEVICE)
            t0 = T()
            hit = ex.backend._range_hits_compact(plan, rf, slots)
            st["gather_filter_hits"] = T() - t0
        else:
            t0 = T()
            hit = ex.backend.range_hits(plan)
            st["filter_hits"] = T() - t0
        t0 = T()
        refine_range(hit, plan)
        st["refine_host"] = T() - t0
        wall, dev, top = device_busy(lambda: ex.range_query_batch(Q, rs))
        print(f"profile: range REPRO_COMPACT={compact} stages_ms="
              f"{json.dumps({k: round(v * 1e3, 3) for k, v in st.items()})}"
              f" batch_wall_ms={wall:.3f} device_ms={dev:.3f} "
              f"busy={dev / wall:.4f} top={json.dumps(top)}", flush=True)
    ex.knn_query_batch(Q, K_NN)                         # warm
    st = {}
    t0 = T()
    plan = ex.planner.plan_knn(Q, K_NN, 64)
    st["plan_knn_seed"] = T() - t0
    t0 = T()
    final, rounds = ex.backend.knn_candidates(plan)
    st["rounds_incl_distance_matrix"] = T() - t0
    t0 = T()
    ex._refine_topk(Q, [np.nonzero(row)[0] for row in final], K_NN)
    st["refine_host"] = T() - t0
    wall, dev, top = device_busy(lambda: ex.knn_query_batch(Q, K_NN))
    print(f"profile: knn rounds={rounds} candidates/query="
          f"{final.sum(axis=1).mean():.1f} stages_ms="
          f"{json.dumps({k: round(v * 1e3, 3) for k, v in st.items()})} "
          f"batch_wall_ms={wall:.3f} device_ms={dev:.3f} "
          f"busy={dev / wall:.4f} top={json.dumps(top)}", flush=True)


# ----------------------------------------------------------------- builder
def lims_index(X, metric, **kw):
    from repro_torch.core import LIMSIndex, MetricSpace
    return LIMSIndex(MetricSpace(X, metric), n_clusters=K_CLUSTERS, m=M,
                     n_rings=RINGS, degree=DEGREE, **kw)


def compare_structures(tag, X, metric, host, dev) -> None:
    """Centers, assignment and pivot ids of the device build against
    the host build's.  A difference passes only at a tie: the host's f64
    distances of the two candidates within one ulp (the reference's own
    allowance, repro/build/cluster.py:12-14).  The first differing
    center or assignment makes everything after it incomparable, so the
    comparison stops there."""
    from repro_torch.core.metrics import dist_one_to_many
    hc, dc = host.clustering, dev.clustering
    ties = []

    def tie(a, b, what):
        check(abs(a - b) <= np.spacing(max(abs(a), abs(b))),
              f"builder: {tag} {what} differs from the host build and is "
              f"no tie ({a!r} vs {b!r})")
        ties.append(f"{what}: {a!r} vs {b!r}")

    n_c = int((hc.center_idx != dc.center_idx).sum())
    n_a = int((hc.assign != dc.assign).sum())
    n_p = sum(int((h.pivot_idx != d.pivot_idx).sum())
              for h, d in zip(host.clusters, dev.clusters))
    if n_c:
        c = int(np.nonzero(hc.center_idx != dc.center_idx)[0][0])
        d_near = np.min([dist_one_to_many(X[g], X, metric)
                         for g in hc.center_idx[:c]], axis=0)
        tie(d_near[hc.center_idx[c]], d_near[dc.center_idx[c]],
            f"center {c}")
    elif n_a:
        for i in np.nonzero(hc.assign != dc.assign)[0]:
            both = hc.center_idx[[hc.assign[i], dc.assign[i]]]
            d = dist_one_to_many(X[i], X[both], metric)
            tie(d[0], d[1], f"assignment of row {i}")
    else:
        for h, d in zip(host.clusters, dev.clusters):
            bad = np.nonzero(h.pivot_idx != d.pivot_idx)[0]
            if len(bad):
                j = int(bad[0])
                d_near = h.pivot_d_stored[:, :j].min(axis=1)
                at = [int(np.nonzero(h.store_ids == g)[0][0])
                      for g in (h.pivot_idx[j], d.pivot_idx[j])]
                tie(d_near[at[0]], d_near[at[1]],
                    f"cluster {h.cid} pivot {j}")
    print(f"builder: {tag} structure differences from the host build: "
          f"centers={n_c} assignment={n_a} pivot_ids={n_p}; ties "
          f"(host f64 distances of the two candidates): {ties}",
          flush=True)


def print_build(tag, dev, t_dev, t_host, counts, where="") -> None:
    t = {k: round(v, 4) for k, v in dev.device_build_timings.items()}
    print(f"builder: {tag} device build stages_s={json.dumps(t)} "
          f"LIMSIndex(backend='device') total_s={t_dev:.3f} (stages + host "
          f"f64 materialization); host build total_s={t_host:.3f}{where}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}; "
          f"launches {json.dumps(counts)}", flush=True)


def phase_builder_l2(X, ix, t_host, batches, host_range, host_knn):
    """(a): device build of main's GaussMix L2 index, its structures
    against main's host index, and every main batch through a snapshot
    of it on the card."""
    from repro_torch.core import LIMSSnapshot, QueryExecutor
    from repro_torch.kernels import _cuda
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ixd = lims_index(X, "l2", backend="device")
    t_dev = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    check(counts["pdist"] > 0, "builder: l2 build launched no pdist")
    print_build("l2 GaussMix", ixd, t_dev, t_host, counts)
    compare_structures("l2", X, "l2", ix, ixd)
    ex = QueryExecutor(LIMSSnapshot.build(ixd, device=DEVICE))
    for (Q, rs), want_r, want_k in zip(batches, host_range, host_knn):
        for b, got in enumerate(ex.range_query_batch(Q, rs)):
            check(same_range(got, want_r[b]), f"builder: l2 range query {b} "
                  f"of the device-built snapshot differs from the host index")
        ids, ds = ex.knn_query_batch(Q, K_NN)
        for b in range(B):
            check(same_knn((ids[b], ds[b]), want_k[b]), f"builder: l2 kNN "
                  f"query {b} of the device-built snapshot differs")
    print(f"builder: l2 snapshot of the device-built index: all "
          f"{len(batches)} range and kNN batches equal the host index",
          flush=True)
    return ixd


def builder_queries(X, metric, host, dev, Q, rs, first):
    """A slice of (b), (c) or (e)'s queries, in a worker process: range
    and kNN queries ``first``, ``first`` + 1, ... of a batch through the
    host- and the device-built index, query 0 also against an f64
    brute-force scan.  The host query path is Python on one core (20-45
    s a part at these sizes), so the slices run beside each other and
    the builder's later parts.  Returns (what differs, or None; each
    index's query seconds): a worker that raised SystemExit, as
    ``check`` does, would never answer."""
    from repro_torch.core.metrics import dist_one_to_many
    t_q = {"host": 0.0, "device": 0.0}
    for b, (q, r) in enumerate(zip(Q, rs), first):
        t0 = time.perf_counter()
        want_r, want_k = host.range_query(q, r)[:2], host.knn_query(q, K_NN)[:2]
        t1 = time.perf_counter()
        got_r, got_k = dev.range_query(q, r)[:2], dev.knn_query(q, K_NN)[:2]
        t_q["host"] += t1 - t0
        t_q["device"] += time.perf_counter() - t1
        if not (same_range(got_r, want_r) and same_knn(got_k, want_k)):
            return (f"query {b}: the device-built index differs from the "
                    f"host build"), t_q
        if b == 0:
            dist = dist_one_to_many(q, X, metric)
            hit = np.nonzero(dist <= r)[0]
            top = np.argsort(dist, kind="stable")[:K_NN]
            if not (same_range(got_r, (hit, dist[hit]))
                    and same_knn(got_k, (top, dist[top]))):
                return "query 0 differs from brute force", t_q
    return None, t_q


def builder_query_results(pending) -> None:
    """Waits for each part's builder_queries slices (at most
    BUILDER_QUERY_WAIT_S each) and fails at the first difference."""
    for tag, results in pending:
        t_q = {"host": 0.0, "device": 0.0}
        for result in results:
            diff, t = result.get(timeout=BUILDER_QUERY_WAIT_S)
            check(diff is None, f"builder: {tag} {diff}")
            for k in t_q:
                t_q[k] += t[k]
        print(f"builder: {tag} {B} range (selectivity {SELECTIVITY}) and "
              f"{B} kNN (k={K_NN}) queries identical between the device- "
              f"and host-built index; query 0 equals the f64 brute-force "
              f"scan; host query path s={json.dumps(t_q)} (summed over "
              f"{len(results)} worker processes)", flush=True)


def builder_data(n: int, d: int, data: str):
    """(b), (c) or (e)'s rows: Skewed (the paper's L1 data set) or
    GaussMix, seed 0."""
    from repro_torch.data.datasets import gauss_mix, skewed
    return (skewed if data == "skewed" else gauss_mix)(n, d, seed=0)


def builder_host(metric, n, data, d):
    """(b), (c) or (e)'s host build, in a worker process (the four run
    beside each other and beside the builder's (a)): the index and its
    build seconds."""
    X = builder_data(n, d, data)
    t0 = time.perf_counter()
    host = lims_index(X, metric)
    return host, time.perf_counter() - t0


def phase_builder_lp(metric, n, pool, host, data="skewed", d=D, rows=True):
    """(b), (c) or (e): ``data`` (Skewed, the paper's L1 data set, or
    GaussMix) at width ``d`` with ``metric``: a host build (``host``:
    builder_host's pending result) and a device build, their
    structures, 64 range and 64 kNN queries through both (handed to
    ``pool``: builder_queries), query 0 against brute force; the kernel
    launched once in the build; then the kernel against its plain
    version at pivot_columns' grouped launch shape and, with ``rows``,
    its row there and a printed line at the reference's chunked launch
    shape.  Returns (the row or None, (tag, the pending queries))."""
    from repro_torch.build import cluster_major
    from repro_torch.roofline import analysis as ra
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.pdist import METRICS
    name, plain = METRICS[metric]
    X = builder_data(n, d, data)
    tag = f"{metric} {'Skewed' if data == 'skewed' else 'GaussMix'} n={n}" \
          + ("" if d == D else f" d={d}")
    host, t_host = host.get(timeout=BUILDER_QUERY_WAIT_S)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    dev = lims_index(X, metric, backend="device")
    t_dev = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    check(counts[name] == 1, f"builder: the {tag} build launched {name} "
          f"{counts[name]} times, not once")
    print_build(tag, dev, t_dev, t_host, counts,
                " (in a worker process, beside the other parts' builds)")
    compare_structures(tag, X, metric, host, dev)

    (Q, rs), = make_queries(X, np.random.default_rng(2), 1, metric)
    size = -(-B // BUILDER_SLICES)
    pending = (tag, [pool.apply_async(builder_queries, (
        X, metric, host, dev, Q[i:i + size], rs[i:i + size], i))
        for i in range(0, B, size)])

    # the kernel at the shape pivot_columns launches it with: every
    # cluster's m pivots against its own n_max member slots
    member_idx, _, _, n_max = cluster_major(dev.clustering.members)
    K = dev.K
    Xf = torch.from_numpy(X.astype(np.float32)).to(DEVICE)
    p = Xf[torch.from_numpy(member_idx).to(DEVICE)]
    q = Xf[torch.from_numpy(
        np.stack([ci.pivot_idx for ci in dev.clusters])).to(DEVICE)]
    del Xf, host, dev
    m = q.shape[1]
    got = ops.pdist_grouped(q, p, metric)
    want = plain(q, p)
    check(torch.equal(got, want), f"{name} differs from its plain version "
          f"at pivot_columns' shape ({K}, {m}, {n_max}, d {d})")
    err = float((got - want).abs().max())
    del got, want
    print(f"kernels: {name} at pivot_columns' grouped launch ({K}, {m}, "
          f"{n_max}, d {d}) equals its plain version bit for bit", flush=True)
    if not rows:
        return None, pending
    p_norm = 1.0 if metric == "l1" else float("inf")
    out = torch.empty(K, m, n_max, device=DEVICE)
    tile = launch_tile(name)
    row = kernel_row(
        name, counts[name], err, lambda: ops.pdist_grouped(q, p, metric), 20,
        lambda: plain(q, p), 3,
        *ra.pdist_lp_work(K, m, n_max, d),
        library=lambda: torch.cdist(q, p, p=p_norm),
        shape=f"pivot_columns' grouped launch ({K}, {m}, {n_max}, d {d})",
        bare=lambda: _cuda.launch(name, q.data_ptr(), p.data_ptr(),
                                  out.data_ptr(), K, m, n_max, d, *tile,
                                  device=q.device))

    # and at the reference's launch shape, the chunked (cc·m, cc·n_max)
    # pdist_pallas call (G = 1): a printed line only
    cc = min(16, K)
    q1 = q[:cc].reshape(cc * m, d)
    p1 = p[:cc].reshape(cc * n_max, d)
    del q, p, out
    got = ops.pdist(q1, p1, metric)
    check(torch.equal(got, plain(q1, p1)), f"{name} differs from its plain "
          f"version at ({cc * m}, {cc * n_max}, d {d})")
    del got
    nq, npts = q1.shape[0], p1.shape[0]
    out = torch.empty(nq, npts, device=DEVICE)
    tile = launch_tile("pdist", metric, {"q": nq, "p": npts, "d": d})
    kernel_row(
        name, counts[name], 0.0, lambda: ops.pdist(q1, p1, metric), 20,
        lambda: plain(q1, p1), 3, *ra.pdist_lp_work(1, nq, npts, d),
        library=lambda: torch.cdist(q1, p1, p=p_norm),
        shape=f"the full function's ({nq}, {npts}, d {d}) (cc={cc}, "
              f"n_max={n_max})",
        note="(the reference's chunked launch; not on the path now)",
        bare=lambda: _cuda.launch(name, q1.data_ptr(), p1.data_ptr(),
                                  out.data_ptr(), 1, nq, npts, d, *tile,
                                  device=q1.device))
    return row, pending


def phase_retrain(X, ix, ixd, batches):
    """(d): the largest cluster of the device-built index ``ixd`` and of
    the host-built ``ix`` loses 1% of its rows and gains as many new
    ones; a device retrain of one and a host retrain of the other must
    answer identically, and "auto" must pick the device."""
    from repro_torch.core.index import RETRAIN_AUTO_ROWS
    c = int(np.argmax([ci.n for ci in ixd.clusters]))
    rng = np.random.default_rng(3)
    stored = ixd.clusters[c].store_ids
    gone = rng.choice(stored, size=len(stored) // 100, replace=False)
    new = X[rng.choice(stored, size=len(gone))] + rng.normal(
        0.0, 0.003, (len(gone), D))
    for index in (ixd, ix):
        for g in gone:
            check(index.delete(X[g]) == 1, f"builder: delete of row {g}")
        for row in new:
            index.insert(row)
    rows = ixd.clusters[c].n - len(gone) + len(ixd.clusters[c].buf_ids)
    times = {}
    for index, backend in ((ixd, "device"), (ix, "host"), (ixd, "auto")):
        sync()
        t0 = time.perf_counter()
        index.retrain_cluster(c, backend=backend)
        sync()
        times[backend] = time.perf_counter() - t0
    check(ixd.last_retrain_backend == "device",
          f"builder: auto picked {ixd.last_retrain_backend} for {rows} rows")
    Q, rs = batches[0]
    for b, (q, r) in enumerate(zip(Q, rs)):
        check(same_range(ixd.range_query(q, r)[:2], ix.range_query(q, r)[:2])
              and same_knn(ixd.knn_query(q, K_NN)[:2],
                           ix.knn_query(q, K_NN)[:2]),
              f"builder: query {b} differs after the device and host "
              f"retrains")
    print(f"builder: retrain cluster {c} ({rows} rows after -{len(gone)} "
          f"+{len(new)}): device_s={times['device']:.4f} "
          f"host_s={times['host']:.4f} auto_s={times['auto']:.4f} (auto "
          f"picked {ixd.last_retrain_backend}; RETRAIN_AUTO_ROWS="
          f"{RETRAIN_AUTO_ROWS}); batch 0's {B} range and {B} kNN queries "
          f"identical after both", flush=True)


# ----------------------------------------------------------------- serving
def host_answers_equal(engine, Q, rs, tag: str,
                       phase: str = "serving") -> tuple[float, float]:
    """One range and one kNN batch through ``engine`` against its host
    index (ids and f64 distances); returns the two batches' wall
    seconds (the host's answers excluded)."""
    t0 = time.perf_counter()
    got_r = engine.range_query_batch(Q, rs)
    t1 = time.perf_counter()
    ids, ds = engine.knn_query_batch(Q, K_NN)
    t2 = time.perf_counter()
    ix = engine.index
    for b, (q, r) in enumerate(zip(Q, rs)):
        check(same_range(got_r[b], ix.range_query(q, r)[:2]),
              f"{phase}: {tag}: range query {b} differs from the host index")
        check(same_knn((ids[b], ds[b]), ix.knn_query(q, K_NN)[:2]),
              f"{phase}: {tag}: kNN query {b} differs from the host index")
    return t1 - t0, t2 - t1


def live_arrays(snap):
    """(f64 rows, gids) of a snapshot's live slots, as host copies."""
    live = np.nonzero(snap.valid_np)[0]
    return snap.rows_np[live], snap.gids_np[live]


def brute_force_equal(rows, gids, Q, rs, got, kind: str, tag: str) -> None:
    """``got`` against an f64 brute-force scan of live ``rows``: each
    row's f64 distance on the card (direct differences, no Gram trick)
    picks the rows within 1e-9 of each answer's boundary, and
    ``dist_one_to_many`` gives their exact f64 distances on the host,
    the distances the engine's refinement computes."""
    from repro_torch.core.metrics import dist_one_to_many
    d = torch.cdist(torch.from_numpy(Q).to(DEVICE),
                    torch.from_numpy(rows).to(DEVICE),
                    compute_mode="donot_use_mm_for_euclid_dist")
    if kind == "range":
        edge = torch.from_numpy(rs).to(DEVICE)
    else:
        edge = torch.topk(d, K_NN, dim=1, largest=False).values[:, -1]
    near = (d <= (edge + 1e-9)[:, None]).cpu().numpy()
    del d
    for b in range(len(Q)):
        idx = np.nonzero(near[b])[0]
        exact = dist_one_to_many(Q[b], rows[idx], "l2")
        if kind == "range":
            hit = exact <= rs[b]
            ok = same_range(got[b], (gids[idx[hit]], exact[hit]))
        else:
            top = np.argsort(exact, kind="stable")[:K_NN]
            ok = same_knn((got[0][b], got[1][b]),
                          (gids[idx[top]], exact[top]))
        check(ok, f"serving: {tag}: {kind} query {b} differs from the f64 "
              f"brute-force scan of its snapshot's live rows")


def mutate(engine, X, rng, deletable):
    """SERVE_ROWS inserts (data rows + N(0, 0.003)), then SERVE_ROWS
    deletes of stored rows taken from ``deletable``; returns the
    inserted (gid, row) pairs, the deleted ids and the seconds of each
    loop."""
    new = X[rng.choice(len(X), SERVE_ROWS)] + rng.normal(
        0.0, 0.003, (SERVE_ROWS, D))
    t0 = time.perf_counter()
    inserted = [(engine.insert(row), row) for row in new]
    t1 = time.perf_counter()
    gone = [deletable.pop() for _ in range(SERVE_ROWS)]
    for g in gone:
        check(engine.delete(X[g]) == 1, f"serving: delete of row {g}")
    return inserted, gone, t1 - t0, time.perf_counter() - t1


def memory_line(tag: str, engine, mem: dict) -> None:
    """memory_allocated after a generation, kept in ``mem[tag]``."""
    sync()
    mem[tag] = torch.cuda.memory_allocated()
    print(f"serving: {tag}: generation {engine.generation} "
          f"memory_allocated={mem[tag]} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"snapshot device_bytes={engine.snapshot.device_nbytes()}",
          flush=True)


def found_at_1e9(engine, X, inserted, gone, rng, tag: str) -> None:
    """A round's inserted rows are found at r = 1e-9 and its deleted
    rows are not: FOUND_SAMPLE of each through the engine's range
    batches, all of them in the published snapshot's live ids."""
    pick = rng.choice(len(inserted), FOUND_SAMPLE, replace=False)
    rows = np.stack([inserted[i][1] for i in pick])
    for i, (ids, _) in zip(pick, engine.range_query_batch(rows, 1e-9)):
        check(inserted[i][0] in set(ids.tolist()),
              f"serving: {tag}: inserted row {inserted[i][0]} not found")
    dead = [gone[i] for i in pick]
    for g, (ids, _) in zip(dead, engine.range_query_batch(X[dead], 1e-9)):
        check(g not in set(ids.tolist()),
              f"serving: {tag}: deleted row {g} still found")
    s = engine.snapshot
    live = set(s.gids_np[s.valid_np].tolist())
    check(all(g in live for g, _ in inserted)
          and not any(g in live for g in gone),
          f"serving: {tag}: the published snapshot's live ids miss an "
          f"insert or keep a delete")


def serving_sync(X, ix, batches, rng, deletable, mem) -> None:
    """(a) synchronous refresh rounds and (b) a retrain on the card."""
    from repro_torch.core.serving import ServingEngine
    from repro_torch.obs import REGISTRY
    sync()
    t_part = t0 = time.perf_counter()
    engine = ServingEngine(ix, refresh_every=SERVE_REFRESH, device=DEVICE)
    sync()
    print(f"serving: (a) ServingEngine(refresh_every={SERVE_REFRESH}) "
          f"generation 0 built in {time.perf_counter() - t0:.3f} s",
          flush=True)
    memory_line("(a) generation 0", engine, mem)
    # refresh seconds: the engine.snapshot_build span histogram's sum
    span = REGISTRY.histogram("span.engine.snapshot_build")
    t_ins = t_del = t_refresh = t_range = t_knn = 0.0
    for rnd in range(SERVE_ROUNDS):
        s0 = span.sum
        inserted, gone, ti, td = mutate(engine, X, rng, deletable)
        refresh_s = span.sum - s0
        check(engine.generation == rnd + 1 and engine.pending_mutations == 0,
              f"serving: (a) round {rnd}: generation {engine.generation}, "
              f"pending {engine.pending_mutations}")
        t_ins += ti
        t_del += td - refresh_s
        t_refresh += refresh_s
        memory_line(f"(a) generation {rnd + 1}", engine, mem)
        Q, rs = batches[rnd % len(batches)]
        tr, tk = host_answers_equal(engine, Q, rs, f"(a) round {rnd}")
        t_range += tr
        t_knn += tk
        found_at_1e9(engine, X, inserted, gone, rng, f"(a) round {rnd}")
        print(f"serving: (a) round {rnd}: +{SERVE_ROWS} -{SERVE_ROWS} -> "
              f"generation {engine.generation}, refresh_s={refresh_s:.4f}; "
              f"range and kNN batch equal the host index; rows found and "
              f"gone at r=1e-9", flush=True)
    n_mut = SERVE_ROUNDS * SERVE_ROWS
    nq = SERVE_ROUNDS * B
    print(f"serving: (a) engine inserts/s {n_mut / t_ins:.1f} deletes/s "
          f"{n_mut / t_del:.1f} (refreshes excluded); refresh "
          f"s/generation {t_refresh / SERVE_ROUNDS:.4f}; engine range "
          f"{nq / t_range:.2f} q/s, kNN {nq / t_knn:.2f} q/s (B={B}, "
          f"k={K_NN}, kNN driver={engine.executor.last_knn['driver']}, "
          f"wall clock incl. host refinement)", flush=True)
    if FOUND_SAMPLE < SERVE_ROWS:
        print(f"serving: CUT: (a)'s r = 1e-9 queries cover {FOUND_SAMPLE} "
              f"of each round's {SERVE_ROWS} inserted and {SERVE_ROWS} "
              f"deleted rows (a query's (B, P) mask is 4.6 MB to the "
              f"host); all are checked in the published snapshot's live "
              f"ids", flush=True)
    print(f"serving: (a) in {time.perf_counter() - t_part:.1f} s",
          flush=True)

    c = int(np.argmax([ci.n for ci in ix.clusters]))
    rows = ix.clusters[c].n + len(ix.clusters[c].buf_ids)
    gen = engine.generation
    sync()
    t0 = time.perf_counter()
    engine.retrain_cluster(c)
    sync()
    t_retrain = time.perf_counter() - t0
    check(ix.last_retrain_backend == "device",
          f"serving: (b) auto picked {ix.last_retrain_backend} for {rows} "
          f"rows")
    check(engine.generation == gen + 1,
          "serving: (b) the retrain published no generation")
    host_answers_equal(engine, *batches[0], "(b)")
    memory_line("(b) after the retrain", engine, mem)
    print(f"serving: (b) retrain_cluster({c}) ({rows} rows) on the device "
          f"+ refresh in {t_retrain:.4f} s -> generation "
          f"{engine.generation}; range and kNN batch equal the host index; "
          f"(b) in {time.perf_counter() - t0:.1f} s", flush=True)


def serving_async(X, ix, batches, rng, deletable, mem):
    """(c) async refresh under a query thread.  Returns the engine."""
    import threading

    from repro_torch import obs
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kernels import _cuda
    from repro_torch.obs import trace as obs_trace
    t_part = time.perf_counter()
    engine = ServingEngine(ix, refresh_every=SERVE_REFRESH,
                           async_refresh=True, device=DEVICE)
    memory_line("(c) generation 0", engine, mem)
    obs.configure("trace")          # snapshot_build spans with their times
    obs.clear_trace()
    # an empty kernel table: the first launches of (c) load it again,
    # under the loader's lock, on whichever thread comes first
    _cuda._FUNCS.clear()
    builds = []
    real_build = _cuda.build

    def counted_build(*a, **k):
        builds.append(threading.current_thread().name)
        return real_build(*a, **k)

    errors, lat = [], []

    def queries():
        try:
            for i in range(2 * SERVE_ASYNC_BATCHES):
                kind = ("range", "knn")[i % 2]
                Q, rs = batches[(i // 2) % len(batches)]
                ex = engine.executor            # once a batch
                t0 = time.perf_counter()
                got = (ex.range_query_batch(Q, rs) if kind == "range"
                       else ex.knn_query_batch(Q, K_NN))
                t1 = time.perf_counter()
                rows, gids = live_arrays(ex.snap)
                del ex
                lat.append((kind, t0, t1, len(gids)))
                brute_force_equal(rows, gids, Q, rs, got, kind,
                                  f"(c) batch {i}")
        except BaseException as e:              # raised on the main thread
            errors.append(e)

    with mock.patch.object(_cuda, "build", counted_build):
        worker = threading.Thread(target=queries, name="serving-queries")
        worker.start()
        t0 = time.perf_counter()
        for _ in range(SERVE_ROUNDS):
            mutate(engine, X, rng, deletable)
        t_mut = time.perf_counter() - t0
        worker.join(timeout=900)
        check(not worker.is_alive(), "serving: (c) the query thread hangs")
        engine.wait_refresh()
    if errors:
        raise errors[0]
    check(len(builds) == 1,
          f"serving: (c) the kernels were loaded {len(builds)} times")
    # mutations wait on the update lock while a refresh builds, and a
    # refresh takes every mutation pending when it starts: the rounds'
    # thresholds may share a generation
    check(1 <= engine.generation <= SERVE_ROUNDS
          and engine.pending_mutations < SERVE_REFRESH,
          f"serving: (c) generation {engine.generation}, pending "
          f"{engine.pending_mutations} after wait_refresh()")
    spans = [(obs_trace._EPOCH + e["ts"] / 1e6,
              obs_trace._EPOCH + (e["ts"] + e["dur"]) / 1e6)
             for e in obs.chrome_trace()["traceEvents"]
             if e.get("name") == "engine.snapshot_build"]
    obs.configure("on")
    obs.clear_trace()
    check(len(spans) == engine.generation,
          f"serving: (c) {len(spans)} snapshot_build spans traced for "
          f"{engine.generation} generations")
    memory_line("(c) after wait_refresh()", engine, mem)

    def pct(v):
        return (f"p50 {np.percentile(v, 50) * 1e3:.1f} p99 "
                f"{np.percentile(v, 99) * 1e3:.1f} ms (n={len(v)})"
                if v else "none")

    for kind in ("range", "knn"):
        busy, idle = [], []
        for k, t0, t1, _ in lat:
            if k == kind:
                inflight = any(t0 < e and t1 > s for s, e in spans)
                (busy if inflight else idle).append(t1 - t0)
        print(f"serving: (c) {kind} batch latency with a refresh in flight "
              f"{pct(busy)}; with none {pct(idle)}", flush=True)
    print(f"serving: (c) {SERVE_ROUNDS} x {2 * SERVE_ROWS} mutations in "
          f"{t_mut:.2f} s beside {len(lat)} batches, each equal to an f64 "
          f"brute-force scan of its snapshot's live rows (live counts "
          f"{sorted({n for *_, n in lat})}); generations reached after "
          f"wait_refresh(): {engine.generation} (pending "
          f"{engine.pending_mutations}); refresh spans (s) "
          f"{[round(e - s, 4) for s, e in spans]}; the kernel table was "
          f"loaded once (on the thread {builds}); (c) in "
          f"{time.perf_counter() - t_part:.1f} s", flush=True)
    return engine


def serving_loop(engine, batches, mem) -> None:
    """(d) the monitor + daemon closed loop, retrain='auto'."""
    from repro_torch import obs
    from repro_torch.obs.health import RankDriftDetector
    from repro_torch.obs.monitor import Monitor
    from repro_torch.serving import MonitorDaemon
    t_part = time.perf_counter()
    obs.REGISTRY.reset()
    mon = Monitor(interval=3600.0,
                  detectors=[RankDriftDetector(persistence=1)])
    daemon = MonitorDaemon(mon, lambda: None, engine, retrain="auto")
    Q, rs = batches[1 % len(batches)]
    host_answers_equal(engine, Q, rs, "(d) before the loop")
    gauges = {m.name: m.value for m in obs.REGISTRY.metrics()
              if m.name.startswith("executor.rank_err_ratio.c")}
    check(gauges and all(v <= 1.0 for v in gauges.values()),
          f"serving: (d) observed rank error above E: {gauges}")
    fired = mon.tick()
    check(not [f for f in fired if f.detector == "rank_drift"],
          f"serving: (d) a rank_drift finding on fresh models: {fired}")
    c = int(np.argmax([ci.n for ci in engine.index.clusters]))
    gen = engine.generation
    obs.REGISTRY.gauge(f"executor.rank_err_ratio.c{c}").set(0.9)
    fired = mon.tick()
    engine.wait_refresh()
    auto = [e for e in daemon.events() if e["action"] == "retrain_auto"]
    check(len(auto) == 1 and auto[0]["cluster"] == c,
          f"serving: (d) daemon events {daemon.events()}")
    check(engine.generation == gen + 1,
          "serving: (d) the automatic retrain published no generation")
    host_answers_equal(engine, Q, rs, "(d) after the retrain")
    memory_line("(d) after the automatic retrain", engine, mem)
    print(f"serving: (d) {len(gauges)} rank_err_ratio gauges after real "
          f"batches, max {max(gauges.values()):.6f} (<= 1.0), no rank_drift "
          f"finding; cluster {c} set to 0.9 -> one {fired[0].severity} "
          f"finding -> retrain_auto on the "
          f"{engine.index.last_retrain_backend} -> generation "
          f"{engine.generation}; batch equals the host index; (d) in "
          f"{time.perf_counter() - t_part:.1f} s", flush=True)


def serving_obs(engine, batches) -> None:
    """(e) what observability costs, and that it counts what ran."""
    from repro_torch import obs
    from repro_torch.kernels import _cuda
    t_part = time.perf_counter()
    Q, rs = batches[0]
    ex = engine.executor
    ex.range_query_batch(Q, rs)         # warm-up, untimed
    ex.knn_query_batch(Q, K_NN)
    qps = {"on": [], "off": []}
    syncs = {"on": [], "off": []}
    # host seconds of the profile step itself, a batch: the part of the
    # instrumentation's cost that the noisy q/s turns cannot resolve
    emit = {(m, k): [] for m in qps for k in ("range", "knn")}
    real_emit = ex._emit_profile
    mode = None

    def timed_emit(plan, *args):
        t = time.perf_counter()
        real_emit(plan, *args)
        emit[mode, plan.kind].append(time.perf_counter() - t)

    timing = mock.patch.object(ex, "_emit_profile", timed_emit)
    timing.start()
    for mode in ("on", "off", "off", "on"):
        obs.configure(mode)
        launches = dict(_cuda.LAUNCHES)
        counted = {n: obs.REGISTRY.counter(f"kernels.{n}.launches").value
                   for n in MAIN_KERNELS}
        sync()
        t0 = time.perf_counter()
        ex.range_query_batch(Q, rs)
        t1 = time.perf_counter()
        r_syncs, prof_r = ex._tls.syncs, ex.last_profile
        ex.knn_query_batch(Q, K_NN)
        t2 = time.perf_counter()
        syncs[mode].append((r_syncs, ex.last_knn["host_syncs"]))
        qps[mode].append((B / (t1 - t0), B / (t2 - t1)))
        if mode == "on":
            for n in MAIN_KERNELS:
                got = obs.REGISTRY.counter(f"kernels.{n}.launches").value \
                    - counted[n]
                want = _cuda.LAUNCHES[n] - launches[n]
                check(got == want, f"serving: (e) kernels.{n}.launches "
                      f"counted {got}, _cuda {want}")
            for p in (prof_r, ex.last_profile):
                check(p is not None and p.missing() == [],
                      f"serving: (e) incomplete profile {p}")
    timing.stop()
    check(syncs["on"] == syncs["off"],
          f"serving: (e) host_syncs differ with REPRO_OBS on / off: {syncs}")
    os.environ["REPRO_OBS_PROFILES"] = "2"
    os.environ["REPRO_OBS_TRACE_CAP"] = "4"
    obs.clear_profiles()
    obs.clear_trace()
    obs.configure("trace")
    for _ in range(3):
        ex.knn_query_batch(Q[:8], K_NN)
    rings = (len(obs.profiles()), obs.trace_len())
    del os.environ["REPRO_OBS_PROFILES"], os.environ["REPRO_OBS_TRACE_CAP"]
    obs.clear_profiles()
    obs.clear_trace()
    obs.configure("on")
    check(rings == (2, 4), f"serving: (e) rings {rings}, caps (2, 4)")
    mean = {m: np.mean(v, axis=0) for m, v in qps.items()}
    print(f"serving: (e) REPRO_OBS on: range {mean['on'][0]:.2f} q/s, kNN "
          f"{mean['on'][1]:.2f} q/s; off: range {mean['off'][0]:.2f} q/s, "
          f"kNN {mean['off'][1]:.2f} q/s (kNN driver "
          f"{engine.executor.last_knn['driver']}; after a warm-up batch of "
          f"each kind, turns on, off, off, on; batch 0 of each kind a turn; "
          f"per "
          f"turn {qps}); _emit_profile a batch on: range "
          f"{np.mean(emit['on', 'range']) * 1e3:.2f} ms, kNN "
          f"{np.mean(emit['on', 'knn']) * 1e3:.2f} ms, off: range "
          f"{np.mean(emit['off', 'range']) * 1e6:.2f} us, kNN "
          f"{np.mean(emit['off', 'knn']) * 1e6:.2f} us; host_syncs (range, "
          f"kNN) {syncs['on'][0]} on and off; kernels.<name>.launches equal "
          f"_cuda's tally; profiles complete; profile and trace rings held "
          f"at their caps 2 and 4; (e) in {time.perf_counter() - t_part:.1f} "
          f"s", flush=True)


def phase_serving(X, ix, batches) -> None:
    """The serving lifecycle on ``ix``, parts (a)-(e) (module doc).  The
    launch counters are zeroed before and read after: every kernel of
    the query path must have run."""
    from repro_torch.kernels import _cuda
    t0 = time.perf_counter()
    # serve with the default compacted range path (main's loop leaves
    # the knob at "off")
    os.environ["REPRO_COMPACT"] = "on"
    rng = np.random.default_rng(5)
    deletable = [int(g) for g in np.random.default_rng(6).permutation(len(X))
                 if g not in ix.tombstones]
    mem = {}
    _cuda.reset_launches()
    serving_sync(X, ix, batches, rng, deletable, mem)
    engine = serving_async(X, ix, batches, rng, deletable, mem)
    serving_loop(engine, batches, mem)
    serving_obs(engine, batches)
    sync()
    counts = dict(_cuda.LAUNCHES)
    for name in MAIN_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the serving path")
    last = mem["(d) after the automatic retrain"]
    second = mem["(a) generation 2"]
    limit = second + engine.snapshot.device_nbytes()
    check(last <= limit, f"serving: memory_allocated {last} after the last "
          f"generation exceeds {limit} (the 2nd generation's {second} + "
          f"one snapshot)")
    print(f"serving: launches {json.dumps(counts)}; memory_allocated after "
          f"the last generation {last} <= the 2nd generation's {second} + "
          f"one snapshot = {limit}; served by {executor_name(engine)}; all "
          f"parts in {time.perf_counter() - t0:.1f} s", flush=True)


def executor_name(engine) -> str:
    """The engine's executor type and shard count: with no mesh the
    engine auto-shards where more than one card is visible."""
    ex = engine.executor
    return f"{type(ex).__name__} (n_shards {ex.n_shards})"


# ------------------------------------------------------------------- paged
def spill_main(snap) -> dict:
    """(a)'s spill of main's snapshot into a temporary directory, timed;
    the directory, its seconds and the resident snapshot's sizes."""
    t0 = time.perf_counter()
    path = tempfile.mkdtemp(prefix="chip-smoke-paged-")
    man = snap.spill(path, page_bytes=PAGE_BYTES)
    return {"path": path, "spill_s": time.perf_counter() - t0,
            "pages": man.total_pages, "rows_per_page": man.rows_per_page,
            "device_bytes": snap.device_nbytes(),
            "rows_bytes": snap.rows.nbytes}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def paged_batches(ex, sel, host_range, host_knn, want_r, want_k, tag,
                  split: dict | None = None):
    """Main's range and kNN batches ``sel`` through the paged executor
    ``ex``, each kind from a cold page cache: ids and f64 distances
    equal to the resident executor's (``want_*``) and the host index's.
    Prints each kind's q/s and counters, and with ``split`` (the
    accumulators of ``split_timers``) where its time went."""
    store = ex.snap.store
    nq = len(sel) * B
    for kind in ("range", "knn"):
        store.cache.clear()
        store.stats.reset()
        if os.environ.get("REPRO_REAL_IO") == "1":
            store.drop_os_cache()
        if split is not None:
            split.clear()
        syncs, pages = [], []
        sync()
        t0 = time.perf_counter()
        for i, (Q, rs) in enumerate(sel):
            if kind == "range":
                got = ex.range_query_batch(Q, rs)
                for b in range(B):
                    check(np.array_equal(got[b][0], want_r[i][b][0])
                          and np.array_equal(got[b][1], want_r[i][b][1])
                          and same_range(got[b], host_range[i][b]),
                          f"paged: {tag}: range query {b} of batch {i} "
                          f"differs from the resident path or the host")
                syncs.append(ex.last_profile.host_syncs)
            else:
                ids, ds = ex.knn_query_batch(Q, K_NN)
                check(np.array_equal(ids, want_k[i][0])
                      and np.array_equal(ds, want_k[i][1]),
                      f"paged: {tag}: kNN batch {i} differs from the "
                      f"resident path")
                for b in range(B):
                    check(same_knn((ids[b], ds[b]), host_knn[i][b]),
                          f"paged: {tag}: kNN query {b} of batch {i} "
                          f"differs from the host index")
                syncs.append(ex.last_knn["host_syncs"])
            pages.append(ex.last_io["pages"])
        t = time.perf_counter() - t0
        st = store.stats.snapshot()
        extra = ""
        if ex.prefetcher is not None and kind == "knn":
            pf = ex.prefetcher.snapshot()
            extra = (f" prefetch pages_submitted={pf['pages_submitted']} "
                     f"fetched={pf['pages_fetched']} "
                     f"hit_rate={pf['hit_rate']} "
                     f"overlapped_rounds={pf['overlapped_rounds']}")
        print(f"paged: (b) {tag} {kind} {nq / t:.2f} q/s "
              f"(B={B}, {len(sel)} batches, cold cache) "
              f"pages/query={st['pages_per_query']} "
              f"batch_pages={pages} hit_rate={st['hit_rate']} "
              f"requests={st['requests']} misses={st['misses']} "
              f"evictions={st['evictions']} "
              f"prefetch_reads={st['prefetch_reads']} "
              f"rows_gathered={st['rows_gathered']} "
              f"host_syncs/batch={syncs}{extra}", flush=True)
        if split is not None:
            parts = " ".join(f"{k}={v * 1e3:.1f}" for k, v in split.items())
            print(f"paged: (b) {tag} {kind} split (ms over the batches): "
                  f"total={t * 1e3:.1f} {parts} "
                  f"rest={(t - sum(split.values())) * 1e3:.1f}", flush=True)


@contextlib.contextmanager
def timing_patches(on, acc: dict, props=()):
    """Patch each ``(obj, name, key)`` of ``on`` (and each ``(cls, name,
    key)`` property of ``props``) to add its synchronised wall seconds
    to ``acc[key]``; only the outermost timed call counts."""
    depth = [0]

    def timed(key, fn):
        def wrapped(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sync()
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
                depth[0] -= 1
        return wrapped

    patches = [mock.patch.object(obj, name, timed(key, getattr(obj, name)))
               for obj, name, key in on]
    patches += [mock.patch.object(cls, name, property(timed(
        key, getattr(cls, name).fget))) for cls, name, key in props]
    for p in patches:
        p.start()
    try:
        yield acc
    finally:
        for p in patches:
            p.stop()


def split_timers(ex, acc: dict):
    """Accumulate into ``acc`` the wall seconds the paged executor
    ``ex`` spends in: the plan's candidate masks (computed on the card,
    copied to the host), IO planning (``plan_batch``), page pins and
    their release, page fetch, row gather (the refinement's too), cast +
    copy to the card, and kernels.  Each timed call is synchronised and
    only the outermost one counts (a mask's kernel is the mask's); the
    rest of a batch is certification, the hits scatter, per-query page
    accounting and f64 refinement."""
    from repro_torch.core import executor as exmod
    from repro_torch.core.planner import CandidatePlan
    from repro_torch.kernels import ops
    store, be, planner = ex.snap.store, ex.backend, ex.planner
    on = [(store, "fetch", "fetch"), (store, "gather", "gather"),
          (store, "pin_pages", "pins"), (store, "unpin_pages", "pins"),
          (be, "_to_device", "h2d"), (planner, "eval_mask", "mask"),
          (exmod, "plan_batch", "plan_io")]
    on += [(ops, n, "kernels")
           for n in ("pdist", "range_filter", "pdist_rankeval")]
    return timing_patches(on, acc, props=[(CandidatePlan, "mask", "mask")])


def paged_kernels_vs_plain(paged, shapes, Q, rs) -> None:
    """Each kernel of the paged path against its plain version,
    ``torch.equal``, at the gathered shape the tally launched most."""
    from repro_torch.core.planner import _BALL_ABS, _R_REL
    from repro_torch.kernels import ops
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    q = torch.from_numpy(Q.astype(np.float32)).to(DEVICE)
    r = torch.from_numpy(rs.astype(np.float32)).to(DEVICE) \
        * (1.0 + _R_REL) + _BALL_ABS
    G = paged.K * paged.m
    for name in ("range_filter", "pdist"):
        by = {s: n for s, n in shapes[name].items() if s != (B, G)}
        check(by, f"paged: no gathered {name} launch in the tally")
        (nq, npts), n = max(by.items(), key=lambda kv: (kv[1], kv[0][1]))
        rows = torch.from_numpy(paged.store.gather(
            np.nonzero(paged.valid_np)[0][:npts]).astype(np.float32)).to(
                DEVICE)
        if name == "pdist":
            ok = torch.equal(ops.pdist(q, rows), pdist_plain(q, rows))
        else:
            mask, cnt = ops.range_filter(q, rows, r)
            mask_p, cnt_p = range_filter_plain(q, rows, r * r)
            ok = torch.equal(mask, mask_p) and torch.equal(cnt, cnt_p)
        check(ok, f"paged: {name} differs from its plain version at the "
              f"gathered shape ({nq}, {npts})")
        print(f"paged: {name} equals its plain version (torch.equal) at "
              f"the gathered shape ({nq}, {npts}, d {D}), launched {n} "
              f"times there", flush=True)


def batch_equals_host(engine, ix, Q, rs, kind: str, tag: str) -> float:
    """One ``kind`` batch through ``engine`` held to ``ix`` (ids and f64
    distances); its wall seconds."""
    t0 = time.perf_counter()
    if kind == "range":
        got = engine.range_query_batch(Q, rs)
    else:
        ids, ds = engine.knn_query_batch(Q, K_NN)
    t = time.perf_counter() - t0
    for b, (q, r) in enumerate(zip(Q, rs)):
        ok = same_range(got[b], ix.range_query(q, r)[:2]) \
            if kind == "range" else \
            same_knn((ids[b], ds[b]), ix.knn_query(q, K_NN)[:2])
        check(ok, f"paged: (c) {tag}: {kind} query {b} differs from the "
              f"host index")
    return t


def paged_engine(X, ix, Q, rs) -> None:
    """(c) ServingEngine(storage="paged") on main's host index: one
    round of updates and a refresh (extents reused), compaction (bytes
    reclaimed) and a cold start from the spill, each held to the host
    index's answers."""
    from repro_torch.serving import ServingEngine
    from repro_torch.storage import Manifest
    path = tempfile.mkdtemp(prefix="chip-smoke-engine-")
    try:
        t0 = time.perf_counter()
        engine = ServingEngine(ix, refresh_every=0, storage="paged",
                               storage_path=path, page_bytes=PAGE_BYTES,
                               cache_pages=CACHE_PAGES, device=DEVICE)
        t_build = time.perf_counter() - t0
        check(engine.snapshot.rows.shape[1] == 0,
              "paged: (c) the engine's snapshot holds rows on the card")
        man0 = Manifest.load(path)
        deletable = [int(g) for g in
                     np.random.default_rng(8).permutation(len(X))
                     if g not in ix.tombstones]
        _, _, t_ins, t_del = mutate(engine, X, np.random.default_rng(9),
                                    deletable)
        t0 = time.perf_counter()
        engine.refresh()
        t_refresh = time.perf_counter() - t0
        man1 = Manifest.load(path)
        reused = sum(a == b for a, b in zip(man0.extents, man1.extents)) \
            if man1.n_max == man0.n_max else 0
        t_r = batch_equals_host(engine, ix, Q, rs, "range", "refreshed")
        print(f"paged: (c) ServingEngine(storage='paged') built+spilled "
              f"in {t_build:.3f} s, served by {executor_name(engine)}; "
              f"{SERVE_ROWS} inserts {t_ins:.2f} s, "
              f"{SERVE_ROWS} deletes {t_del:.2f} s; refresh (spill of "
              f"generation {man1.generation}) {t_refresh:.3f} s; extents "
              f"reused {reused} of {man1.K} (n_max {man0.n_max} -> "
              f"{man1.n_max}); pages {man0.total_pages} -> "
              f"{man1.total_pages}; a range batch equals the host index "
              f"({t_r:.3f} s)", flush=True)
        before = engine.store.nbytes_file()
        t0 = time.perf_counter()
        man_c = engine.compact()
        t_compact = time.perf_counter() - t0
        after = engine.store.nbytes_file()
        check(after <= before and man_c.total_pages ==
              man_c.K * man_c.layout().pages_per_cluster,
              "paged: (c) compaction left garbage pages")
        print(f"paged: (c) compact() in {t_compact:.3f} s reclaimed "
              f"{before - after} bytes ({before} -> {after})", flush=True)
        del engine
        t0 = time.perf_counter()
        cold = ServingEngine.from_spill(path, cache_pages=CACHE_PAGES,
                                        device=DEVICE)
        t_start = time.perf_counter() - t0
        t_k = batch_equals_host(cold, ix, Q, rs, "knn", "cold start")
        print(f"paged: (c) ServingEngine.from_spill started in "
              f"{t_start:.3f} s; its first kNN batch equals the host index "
              f"({t_k:.3f} s, page misses {cold.store.stats.misses})",
              flush=True)
        del cold
    finally:
        shutil.rmtree(path, ignore_errors=True)


def phase_paged(X, ix, batches, host_range, host_knn, spilled) -> None:
    """The paged storage tier on main's snapshot and index, parts (a)-(c)
    (module doc).  The launch counters are zeroed after the resident
    comparison's batches and read after (c): each kernel of the paged
    path must have run."""
    from repro_torch.core import QueryExecutor
    from repro_torch.core.snapshot import LIMSSnapshot
    from repro_torch.kernels import _cuda
    t_phase = time.perf_counter()
    os.environ["REPRO_COMPACT"] = "on"
    os.environ["REPRO_CACHE_PIN"] = "on"
    path = spilled["path"]
    t0 = time.perf_counter()
    paged = LIMSSnapshot.load(path, store=True, cache_pages=CACHE_PAGES,
                              device=DEVICE)
    sync()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    resident = LIMSSnapshot.load(path, device=DEVICE)
    sync()
    t_res = time.perf_counter() - t0
    limit = resident.device_nbytes() - resident.rows.nbytes
    check(resident.device_nbytes() == spilled["device_bytes"],
          "paged: the resident load differs in size from main's")
    check(paged.device_nbytes() <= limit,
          f"paged: the store-backed snapshot holds {paged.device_nbytes()} "
          f"B on the card, more than the resident "
          f"{resident.device_nbytes()} B less its rows")
    print(f"paged: (a) spill of main's snapshot {spilled['spill_s']:.3f} s "
          f"({spilled['pages']} pages of {PAGE_BYTES} B, "
          f"{spilled['rows_per_page']} rows a page); cold load "
          f"(store=True, cache {CACHE_PAGES} pages) {t_load:.3f} s; "
          f"resident load {t_res:.3f} s; on disk {dir_bytes(path)} B "
          f"(pages file {paged.store.nbytes_file()} B); device_bytes paged "
          f"{paged.device_nbytes()} vs resident {resident.device_nbytes()} "
          f"(rows {resident.rows.nbytes})", flush=True)

    sel = batches[:PAGED_BATCHES]
    print(f"paged: CUT: (b) runs {len(sel)} of main's {len(batches)} "
          f"batches of each kind in each prefetch mode", flush=True)
    res_ex = QueryExecutor(resident)
    nq = len(sel) * B
    t0 = time.perf_counter()
    want_r = [res_ex.range_query_batch(Q, rs) for Q, rs in sel]
    t1 = time.perf_counter()
    want_k = [res_ex.knn_query_batch(Q, K_NN) for Q, _ in sel]
    t2 = time.perf_counter()
    print(f"paged: (b) resident (loaded from the spill) range "
          f"{nq / (t1 - t0):.2f} q/s, kNN {nq / (t2 - t1):.2f} q/s",
          flush=True)
    del res_ex, resident

    shapes, spying = shape_spy()
    sync()
    _cuda.reset_launches()
    spying.start()
    try:
        ex = QueryExecutor(paged, prefetch="off")
        with split_timers(ex, {}) as acc:
            paged_batches(ex, sel, host_range, host_knn, want_r, want_k,
                          "REPRO_PREFETCH=off", split=acc)
        paged_batches(QueryExecutor(paged, prefetch="async"), sel,
                      host_range, host_knn, want_r, want_k,
                      "REPRO_PREFETCH=async")
        paged_engine(X, ix, *sel[0])
        sync()
    finally:
        spying.stop()
    counts = dict(_cuda.LAUNCHES)
    for name in MAIN_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the paged path")
    print(f"paged: launches {json.dumps(counts)}", flush=True)
    for name, by in shapes.items():
        check(sum(by.values()) == counts[name],
              f"paged: {name}: the shape tally misses launches")
        print(f"paged: {name} launches by (nq, np): "
              + ", ".join(f"{n} x {s}" for s, n in sorted(by.items())),
              flush=True)
    paged_kernels_vs_plain(paged, shapes, *sel[0])
    print(f"paged: all parts in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ----------------------------------------------------------------- sharded
def shard_mesh(S: int, count: int):
    """A 1-D mesh of S shards: over min(SHARDS, count) distinct cards in
    turn where the machine has more than one, else cuda:0 named S
    times (S shards on one card)."""
    from repro_torch.sharding import Mesh
    cards = min(SHARDS, count) if count > 1 else 1
    return Mesh(tuple(torch.device("cuda", i % cards) for i in range(S)))


def mesh_name(mesh) -> str:
    cards = sorted({str(d) for d in mesh.devices})
    return (f"S={mesh.size} on {len(cards)} distinct card(s) "
            f"({', '.join(str(d) for d in mesh.devices)})")


def shard_kernels_vs_plain(sx, Q, rs) -> None:
    """Every kernel the sharded path launches, at shard 0's local shapes,
    against its plain version: range_filter (mask and counts) and the
    kNN seed's pdist at (64, P/S), the fused plan's pdist_rankeval and
    the planner's pivot-distance pdist at (64, G/S); bit for bit."""
    from repro_torch.core.planner import _BALL_ABS, _R_ABS, _R_REL
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import pdist_rankeval_plain
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    sh = sx._parts[0]
    d, N = sx.snap.d, sx.snap.n_rings
    rows = sh.rows.reshape(-1, d)
    piv = sh.pivots.reshape(-1, d)
    G = piv.shape[0]
    q = torch.from_numpy(Q.astype(np.float32)).to(sh.device)
    rf = torch.from_numpy(rs.astype(np.float32)).to(sh.device)
    r = rf * (1.0 + _R_REL) + _BALL_ABS
    d2, d2_p = ops.pdist(q, rows), pdist_plain(q, rows)
    mask, cnt = ops.range_filter(q, rows, r)
    mask_p, cnt_p = range_filter_plain(q, rows, r * r)
    check(torch.equal(d2, d2_p), "sharded: pdist differs from its plain "
          "version at the shard-local row shape")
    check(torch.equal(mask, mask_p) and torch.equal(cnt, cnt_p),
          "sharded: range_filter differs from its plain version at the "
          "shard-local shape")
    dp, dp_p = ops.pdist(q, piv), pdist_plain(q, piv)
    check(same_bits(dp, dp_p), "sharded: pdist differs from its plain "
          "version at the shard-local pivot shape")
    args = (q, piv, sh.coef.reshape(G, -1), sh.model_lo.reshape(-1),
            sh.model_hi.reshape(-1), sh.model_n.reshape(-1),
            rf * (1.0 + _R_REL) + _R_ABS, N)
    fused, plain = ops.pdist_rankeval(*args), pdist_rankeval_plain(*args)
    for f, p in zip(fused, plain):
        check(same_bits(f, p), "sharded: pdist_rankeval differs from its "
              "plain version at the shard-local shape")
    err = float((d2 - d2_p).abs().max())
    err_p = float((dp - dp_p).abs().max())
    err_f = max(float((f.double() - p.double()).abs().max())
                for f, p in zip(fused, plain))
    print(f"sharded: kernels against their plain versions bit for bit on "
          f"{sh.device}: pdist (max_abs_err={err}) and range_filter (mask, "
          f"counts) at the shard-local row shape ({B}, {rows.shape[0]}, d "
          f"{D}); pdist (max_abs_err={err_p}) and pdist_rankeval (dq, "
          f"rank_lo, rank_hi; max_abs_err={err_f}) at the shard-local "
          f"pivot shape ({B}, G={G})", flush=True)


def sharded_turns(sx, one, batches, host_range, host_knn) -> None:
    """(a): the S-shard executor and the single-device one in turns
    sharded, single, single, sharded (REPRO_COMPACT=off: the sharded
    path does not compact), each result equal to main's host answers.
    Turns 1 and 2 run all of main's batches with the launch counters
    zeroed before and read after each: turn 1 is the phase's counted
    run, and each kernel's launches there must be S times turn 2's, with
    equal kNN rounds and host_syncs batch for batch.  Turns 3 and 4 run
    the first SHARDED_TURN_CUT batches of each kind."""
    from repro_torch.kernels import _cuda
    S = sx.n_shards
    os.environ["REPRO_COMPACT"] = "off"
    turns = [("sharded", sx), ("single", one), ("single", one),
             ("sharded", sx)]
    print(f"sharded: CUT: turns 3 and 4 run {SHARDED_TURN_CUT} of main's "
          f"{len(batches)} batches of each kind", flush=True)
    seen = []
    for i, (tag, ex) in enumerate(turns):
        n = len(batches) if i < 2 else SHARDED_TURN_CUT
        shapes, spying = shape_spy()
        sync()
        _cuda.reset_launches()
        spying.start()
        try:
            r = query_batches(ex, batches[:n], host_range[:n],
                              host_knn[:n], f"sharded: turn {i + 1} {tag}")
            sync()
        finally:
            spying.stop()
        counts = dict(_cuda.LAUNCHES)
        seen.append((r, counts, shapes))
        print(f"sharded: (a) turn {i + 1} {tag} ({n} + {n} batches) range "
              f"{r['range']:.2f} q/s kNN {r['knn']:.2f} q/s (B={B}, "
              f"k={K_NN}, REPRO_COMPACT=off, wall clock incl. host "
              f"refinement); kNN driver={r['driver']} rounds/batch="
              f"{r['rounds']} host_syncs/batch={r['syncs']}; launches "
              f"{json.dumps(counts)}", flush=True)
    (r_sh, c_sh, shapes), (r_one, c_one, _) = seen[0], seen[1]
    for name in ("pdist", "range_filter", "pdist_rankeval"):
        check(c_sh.get(name, 0) > 0,
              f"sharded: kernel {name} was not launched on the sharded path")
        check(c_sh.get(name, 0) == S * c_one.get(name, 0),
              f"sharded: {name} launched {c_sh.get(name, 0)} times, not "
              f"{S} x the single-device {c_one.get(name, 0)}")
    check(r_sh["rounds"] == r_one["rounds"]
          and (r_sh["syncs"] == r_one["syncs"]
               or r_sh["driver"] != r_one["driver"]),
          "sharded: kNN rounds, or host_syncs under one driver, differ "
          "from the single-device executor's")
    for name, by in shapes.items():
        check(sum(by.values()) == c_sh[name],
              f"sharded: {name}: the shape tally misses launches")
        print(f"sharded: (a) turn 1 {name} launches by (nq, np): "
              + ", ".join(f"{n} x {s}" for s, n in sorted(by.items())),
              flush=True)

    def ratio(a, b, kind):
        return seen[a][0][kind] / seen[b][0][kind]

    print(f"sharded: (a) launches per kernel = {S} x the single-device "
          f"run's; equal rounds, and host_syncs where the drivers are "
          f"equal (sharded {r_sh['driver']}, single {r_one['driver']}); "
          f"q/s sharded / single: "
          f"turns 1/2 range {ratio(0, 1, 'range'):.4f} kNN "
          f"{ratio(0, 1, 'knn'):.4f}, turns 4/3 range "
          f"{ratio(3, 2, 'range'):.4f} kNN {ratio(3, 2, 'knn'):.4f}",
          flush=True)


def sharded_store(path, mesh, batches, host_range, host_knn) -> None:
    """(d): a store-backed ShardedExecutor over the spill against the
    paged single-device executor (each on a store of its own, caches
    cleared before each kind): results, last_io, last_knn and the cache
    stats equal."""
    from repro_torch.core import QueryExecutor, ShardedExecutor
    from repro_torch.core.snapshot import LIMSSnapshot

    def load():
        return LIMSSnapshot.load(path, store=True, cache_pages=CACHE_PAGES,
                                 device=DEVICE)

    sp = ShardedExecutor(load(), mesh=mesh, prefetch="off")
    pp = QueryExecutor(load(), prefetch="off")
    (Q, rs), want_r, want_k = batches[0], host_range[0], host_knn[0]
    for kind in ("range", "knn"):
        secs = []
        for ex in (sp, pp):
            ex.snap.store.cache.clear()
            ex.snap.store.stats.reset()
            sync()
            t0 = time.perf_counter()
            if kind == "range":
                got = ex.range_query_batch(Q, rs)
                ok = all(same_range(got[b], want_r[b]) for b in range(B))
            else:
                ids, ds = ex.knn_query_batch(Q, K_NN)
                ok = all(same_knn((ids[b], ds[b]), want_k[b])
                         for b in range(B))
            secs.append(time.perf_counter() - t0)
            check(ok, f"sharded: (d) {kind}: a store-backed result differs "
                  f"from main's host answers")
        check(sp.last_io == pp.last_io
              and sp.snap.store.stats.snapshot()
              == pp.snap.store.stats.snapshot(),
              f"sharded: (d) {kind}: IO counters differ from the paged "
              f"single-device executor's")
        if kind == "knn":
            check(sp.last_knn == pp.last_knn,
                  "sharded: (d) last_knn differs from the paged executor's")
        st = sp.snap.store.stats.snapshot()
        print(f"sharded: (d) store-backed S={sp.n_shards} {kind}: 1 batch "
              f"equal to the host and to the paged single-device "
              f"executor, IO counters equal (pages={sp.last_io['pages']} "
              f"misses={st['misses']} evictions={st['evictions']}); "
              f"{secs[0]:.3f} s vs {secs[1]:.3f} s", flush=True)


def sharded_split(execs, Q, rs) -> None:
    """Where one range and one kNN batch's time goes, for each executor
    of ``execs`` ({tag: executor}): the plan math (``plan_arrays``, once
    a shard, its kernel included), ``range_filter``, ``pdist`` (the kNN
    seed and the planner's pivot distances), each kNN round's masks,
    the merges on the lead (concatenations, counts, the k-th top-k),
    the f64 refinement (the profile's stage) and the rest (host copies,
    the hits and certification on the host).  Each timed call is
    synchronised."""
    from repro_torch.core import executor as exmod
    from repro_torch.kernels import ops
    on = [(exmod, "plan_arrays", "plan"), (ops, "range_filter", "filter"),
          (ops, "pdist", "pdist"),
          (exmod, "_knn_round_masks", "round_masks"),
          (exmod, "_on_lead", "merge"), (exmod, "_merged_count", "merge"),
          (exmod, "_merged_kth", "merge")]
    for tag, ex in execs.items():
        for kind in ("range", "knn"):
            with timing_patches(on, {}) as acc:
                sync()
                t0 = time.perf_counter()
                if kind == "range":
                    ex.range_query_batch(Q, rs)
                else:
                    ex.knn_query_batch(Q, K_NN)
                t = time.perf_counter() - t0
            acc["refine"] = ex.last_profile.stages["refine"]
            parts = " ".join(f"{k}={v * 1e3:.1f}" for k, v in acc.items())
            print(f"sharded: split {tag} {kind} (ms, one batch, each part "
                  f"synchronised): total={t * 1e3:.1f} {parts} "
                  f"rest={(t - sum(acc.values())) * 1e3:.1f}", flush=True)


def phase_sharded(X, ix, batches, host_range, host_knn, spilled,
                  count: int) -> None:
    """The cluster-sharded executor (module doc, parts (a)-(e))."""
    from repro_torch.core import QueryExecutor, ShardedExecutor
    from repro_torch.core.serving import ServingEngine
    from repro_torch.core.snapshot import LIMSSnapshot
    from repro_torch.kernels import _cuda
    t_phase = time.perf_counter()
    path = spilled["path"]
    mesh = shard_mesh(SHARDS, count)
    print(f"sharded: mesh {mesh_name(mesh)}", flush=True)
    t0 = time.perf_counter()
    res = LIMSSnapshot.load(path, device=DEVICE)
    sync()
    t_load = time.perf_counter() - t0
    lead = res.device
    sync()
    before = torch.cuda.memory_allocated(lead)
    t0 = time.perf_counter()
    sx = ShardedExecutor(res, mesh=mesh)
    sync()
    t_build = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated(lead) - before
    check(sx.snap is res, "sharded: K = 64 over 4 shards was padded")
    check(grown < 1 << 20, f"sharded: building the executor took {grown} "
          f"B on the snapshot's card (its shards should be views)")
    views = sum(sh.rows.untyped_storage().data_ptr()
                == res.rows.untyped_storage().data_ptr() for sh in sx._parts)
    print(f"sharded: main's snapshot loaded resident from the spill in "
          f"{t_load:.3f} s (K={res.K}, P={res.n_slots}); ShardedExecutor "
          f"built in {t_build:.4f} s, memory_allocated on {lead} grew by "
          f"{grown} B; {views} of {sx.n_shards} shards are views of the "
          f"snapshot's tensors", flush=True)
    shard_kernels_vs_plain(sx, *batches[0])
    one = QueryExecutor(res)
    sharded_turns(sx, one, batches, host_range, host_knn)
    if len({d.index for d in mesh.devices}) > 1:
        # auto took the host-driven rounds here; the loop refuses
        os.environ["REPRO_KNN_DRIVER"] = "loop"
        try:
            sx.knn_query_batch(batches[0][0], K_NN)
        except RuntimeError as e:
            print(f"sharded: REPRO_KNN_DRIVER=loop on {mesh_name(mesh)} "
                  f"raises: {e}", flush=True)
        else:
            fail("sharded: the kNN loop ran on a mesh over several cards")
        finally:
            os.environ.pop("REPRO_KNN_DRIVER", None)
    sharded_split({f"S={sx.n_shards}": sx, "single": one}, *batches[0])
    del sx, one

    sel = batches[:SHARDED_CUT]
    print(f"sharded: CUT: (b) and (c) run {len(sel)} of main's "
          f"{len(batches)} batches of each kind", flush=True)
    mesh3 = shard_mesh(SHARDS_PADDED, count)
    sx3 = ShardedExecutor(res, mesh=mesh3)
    check(sx3.snap.K == -(-res.K // SHARDS_PADDED) * SHARDS_PADDED
          and sx3.snap.K > res.K, "sharded: (b) K was not padded")
    r = query_batches(sx3, sel, host_range, host_knn, "sharded: (b)")
    print(f"sharded: (b) {mesh_name(mesh3)}: K {res.K} padded to "
          f"{sx3.snap.K}; {len(sel)} + {len(sel)} batches equal to the host "
          f"(range {r['range']:.2f} q/s, kNN {r['knn']:.2f} q/s, kNN "
          f"driver={r['driver']})", flush=True)
    del sx3, res

    os.environ["REPRO_ROWS_DTYPE"] = "bf16"
    try:
        lp = LIMSSnapshot.load(path, device=DEVICE)
    finally:
        os.environ["REPRO_ROWS_DTYPE"] = "off"
    check(lp.rows_lp is not None, "sharded: (c) no bf16 plane was built")
    os.environ["REPRO_COMPACT"] = "on"
    sync()
    _cuda.reset_launches()
    r = query_batches(ShardedExecutor(lp, mesh=mesh), sel, host_range,
                      host_knn, "sharded: (c)")
    sync()
    counts = dict(_cuda.LAUNCHES)
    two_byte = {k: v for k, v in counts.items()
                if k.endswith(("_bf16", "_f16")) and v}
    check(not two_byte, f"sharded: (c) a 2-byte entry point launched: "
          f"{two_byte}")
    print(f"sharded: (c) REPRO_ROWS_DTYPE=bf16 (lp_eps {lp.lp_eps}), "
          f"REPRO_COMPACT=on, S={mesh.size}: {len(sel)} + {len(sel)} "
          f"batches equal to the f32 results (kNN driver={r['driver']}); "
          f"launches {json.dumps(counts)} (no 2-byte entry point)",
          flush=True)
    del lp

    sharded_store(path, mesh, batches, host_range, host_knn)

    engine = ServingEngine(ix, refresh_every=0, mesh=mesh, device=DEVICE)
    deletable = [int(g) for g in
                 np.random.default_rng(10).permutation(len(X))
                 if g not in ix.tombstones]
    _, _, t_ins, t_del = mutate(engine, X, np.random.default_rng(11),
                                deletable)
    sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    engine.refresh()
    t_refresh = time.perf_counter() - t0
    ex = engine.executor
    check(isinstance(ex, ShardedExecutor) and ex.mesh is mesh,
          "sharded: (e) the refreshed engine is not sharded on its mesh")
    t_r, t_k = host_answers_equal(engine, *batches[0], "(e)",
                                  phase="sharded")
    sync()
    counts = dict(_cuda.LAUNCHES)
    for name in MAIN_KERNELS:
        check(counts.get(name, 0) > 0,
              f"sharded: (e) kernel {name} was not launched")
    print(f"sharded: (e) ServingEngine(mesh={mesh.size} shards): "
          f"{SERVE_ROWS} inserts {t_ins:.2f} s, {SERVE_ROWS} deletes "
          f"{t_del:.2f} s, refresh {t_refresh:.3f} s (generation "
          f"{engine.generation}); a range ({t_r:.3f} s) and a kNN "
          f"({t_k:.3f} s, driver {ex.last_knn['driver']}) batch equal to "
          f"the host index; launches {json.dumps(counts)}", flush=True)
    del engine, ex
    print(f"sharded: all parts in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------- frontend
def fe_submit(fe, reqs: list, tag: str) -> float:
    """One submitter thread per entry of ``reqs`` (a list of (kind, q,
    arg, want) requests, sent in order, each answer held to ``want``
    before the next is sent); returns the wall seconds until every
    thread has its answers.  Threads are daemons and joined with a
    bound, so a stuck batch fails the phase instead of hanging it."""
    errors = []

    def run(j, mine):
        try:
            for kind, q, arg, want in mine:
                if kind == "range":
                    ok = same_range(fe.range_query(q, arg), want)
                else:
                    ok = same_knn(fe.knn_query(q, arg), want)
                if not ok:
                    errors.append(f"{tag}: submitter {j}'s {kind} answer "
                                  f"differs from the host index")
        except Exception as e:              # reported on the main thread
            errors.append(f"{tag}: submitter {j}: {e!r}")

    threads = [threading.Thread(target=run, args=(j, mine), daemon=True,
                                name=f"submit-{j}")
               for j, mine in enumerate(reqs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    deadline = t0 + FRONTEND_JOIN_S
    for t in threads:
        t.join(max(deadline - time.perf_counter(), 0.0))
    t = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads),
          f"frontend: {tag}: submitters still waiting after "
          f"{FRONTEND_JOIN_S} s")
    check(not errors, f"frontend: {errors[0] if errors else ''}")
    return t


def row_requests(kind: str, batches, wants, cols=range(B)) -> list:
    """Requests by submitter: submitter j sends row j of each batch in
    turn (range at the batch's radius, kNN at k = K_NN)."""
    return [[(kind, Q[j], rs[j] if kind == "range" else K_NN, want[j])
             for (Q, rs), want in zip(batches, wants)] for j in cols]


@contextlib.contextmanager
def dispatch_log():
    """What the frontend and the router did inside the block: each
    batch's request keys (``ServingFrontend._execute``) and each
    sub-batch's kind, size and kNN rounds (``QueryExecutor.
    execute_range``/``execute_knn``), by wrapping those methods; list
    appends are atomic, so replica threads record without a lock."""
    from repro_torch.core.executor import QueryExecutor
    from repro_torch.serving.frontend import ServingFrontend
    log = SimpleNamespace(batches=[], subs=[])
    real_exec = ServingFrontend._execute
    real_range = QueryExecutor.execute_range
    real_knn = QueryExecutor.execute_knn

    def execute(fe, batch):
        log.batches.append({(r.kind, r.arg if r.kind == "knn" else None)
                            for r in batch})
        return real_exec(fe, batch)

    def execute_range(ex, Q, plan):
        out = real_range(ex, Q, plan)
        log.subs.append(("range", plan.B, 1))
        return out

    def execute_knn(ex, Q, plan):
        out = real_knn(ex, Q, plan)
        log.subs.append(("knn", plan.B, ex.last_knn["rounds"],
                         ex.last_knn["driver"]))
        return out

    with mock.patch.object(ServingFrontend, "_execute", execute), \
            mock.patch.object(QueryExecutor, "execute_range",
                              execute_range), \
            mock.patch.object(QueryExecutor, "execute_knn", execute_knn):
        yield log


def frontend_line(tag: str, m: dict, n: int, secs: float) -> None:
    print(f"frontend: {tag}: {n} queries in {secs:.3f} s = "
          f"{n / secs:.2f} q/s; batches={m['batches']} "
          f"batch_size_mean={m['batch_size_mean']} "
          f"coalesced_batches={m['coalesced_batches']} queue_wait_ms "
          f"p50={m['queue_wait_ms_p50']} p99={m['queue_wait_ms_p99']} "
          f"latency_ms p50={m['latency_ms_p50']} "
          f"p99={m['latency_ms_p99']} shed={m['shed']}", flush=True)


FRONTEND_SPANS = ("frontend.execute", "planner.plan_range",
                  "planner.plan_knn", "router.assign", "router.dispatch",
                  "router.subbatch", "executor.range_execute",
                  "executor.knn_execute", "executor.refine")


def frontend_split(secs: float) -> None:
    """Where (b)'s time went, from the span histograms (the registry is
    reset before (b)): count, p50 and total ms of each span.  Sub-batch
    spans run on the router's threads at once, so their totals add up
    past the wall clock."""
    from repro_torch.obs import REGISTRY
    parts = []
    for name in FRONTEND_SPANS:
        h = REGISTRY.histogram("span." + name)
        parts.append(f"{name} n={h.count} p50={h.percentile(50) * 1e3:.1f} "
                     f"total={h.sum * 1e3:.1f}")
    print(f"frontend: (b) split (ms; wall {secs * 1e3:.1f}): "
          + "; ".join(parts), flush=True)


def frontend_placement(snap) -> None:
    """(a): a 4-replica set over ``snap`` with the default devices: on
    the snapshot's card the replicas hold its very tensors (0 B added);
    replicas on other cards hold copies, whose bytes are printed."""
    from repro_torch.core.snapshot import DEVICE_FIELDS
    from repro_torch.serving import ReplicaSet
    lead = snap.device
    sync()
    before = {i: torch.cuda.memory_allocated(i)
              for i in range(torch.cuda.device_count())}
    t0 = time.perf_counter()
    rs = ReplicaSet(snap, n_replicas=FRONTEND_REPLICAS)
    sync()
    t = time.perf_counter() - t0
    grown = {i: torch.cuda.memory_allocated(i) - b
             for i, b in before.items()}
    local = [m for m in rs.members if m.device == lead]
    shared = all(getattr(m.ex.snap, f).untyped_storage().data_ptr()
                 == getattr(snap, f).untyped_storage().data_ptr()
                 for m in local for f in DEVICE_FIELDS)
    check(shared, "frontend: (a) a replica on the snapshot's card copied "
          "a tensor")
    check(grown[lead.index or 0] == 0, f"frontend: (a) the replicas added "
          f"{grown[lead.index or 0]} B on the snapshot's card")
    copied = sum(m.ex.snap.device_nbytes() for m in rs.members
                 if m not in local)
    print(f"frontend: (a) ReplicaSet(n_replicas={FRONTEND_REPLICAS}) over "
          f"the {snap.device_nbytes()} B snapshot in {t:.4f} s on "
          f"{', '.join(str(m.device) for m in rs.members)}: "
          f"{len(local)} replica(s) on {lead} share every tensor's storage "
          f"(memory_allocated grew {grown[lead.index or 0]} B there); "
          f"{copied} B copied to other cards (memory_allocated growth by "
          f"card {grown})", flush=True)


def frontend_kernels_vs_plain(snap, shapes, Q, rs) -> None:
    """(d): pdist, range_filter and pdist_rankeval against their plain
    versions at the three most frequent ragged (nq < B) shapes the
    router launched, on main's queries and snapshot: rows [0, np) of
    the slot array, or the pivots where np is G; bit for bit."""
    from repro_torch.core.planner import _BALL_ABS, _R_ABS, _R_REL
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import pdist_rankeval_plain
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    d, N = snap.d, snap.n_rings
    G = snap.K * snap.m
    rows = snap.rows.reshape(-1, d)
    piv = snap.pivots.reshape(G, d)
    qf = torch.from_numpy(Q.astype(np.float32)).to(snap.device)
    rf = torch.from_numpy(rs.astype(np.float32)).to(snap.device)
    held = []
    for name in ("pdist", "range_filter", "pdist_rankeval"):
        ragged = sorted(((n, s) for s, n in shapes[name].items()
                         if s[0] < B), reverse=True)[:3]
        check(ragged, f"frontend: (d) {name} launched no ragged shape")
        for _, (nq, npts) in ragged:
            q, r = qf[:nq], rf[:nq]
            if name == "pdist":
                p = piv if npts == G else rows[:npts]
                got, want = ops.pdist(q, p), pdist_plain(q, p)
                ok, err = same_bits(got, want), float(
                    (got - want).abs().max())
            elif name == "range_filter":
                rb = r * (1.0 + _R_REL) + _BALL_ABS
                got = ops.range_filter(q, rows[:npts], rb)
                want = range_filter_plain(q, rows[:npts], rb * rb)
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                err = float((got[1] - want[1]).abs().max())
            else:
                check(npts == G, f"frontend: (d) pdist_rankeval at "
                      f"({nq}, {npts}), not G = {G}")
                args = (q, piv, snap.coef.reshape(G, -1),
                        snap.model_lo.reshape(-1), snap.model_hi.reshape(-1),
                        snap.model_n.reshape(-1),
                        r * (1.0 + _R_REL) + _R_ABS, N)
                got, want = ops.pdist_rankeval(*args), \
                    pdist_rankeval_plain(*args)
                ok = all(same_bits(a, b) for a, b in zip(got, want))
                err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
            check(ok, f"frontend: (d) {name} differs from its plain "
                  f"version at the router's shape ({nq}, {npts})")
            held.append(f"{name} ({nq}, {npts}) max_abs_err={err}")
    sync()
    print(f"frontend: (d) bit for bit against the plain versions at the "
          f"router's three most frequent ragged shapes: "
          + "; ".join(held), flush=True)


def frontend_paged(path, batches, host_range, host_knn) -> None:
    """(g): a frontend over ServingEngine.from_spill with 4 replicas
    sharing one page cache: one range and one kNN batch from a cold
    cache, equal to main's answers; the cache's stats, last_io summed
    over the replicas, and what the per-thread pinned staging buffer
    costs when each sub-batch runs on a fresh router thread."""
    from repro_torch.core.executor import _PagedBackend
    from repro_torch.serving import ServingEngine
    allocs, calls = [], []
    real = _PagedBackend._to_device

    def to_device(backend, rows64):
        # the allocation _to_device makes on a thread whose buffer is
        # missing or too small, made (and timed) here first, so that the
        # real call finds it and the two costs are apart
        buf = getattr(backend._tls, "staging", None)
        t0 = time.perf_counter()
        if backend.ex.snap.device.type == "cuda" and (
                buf is None or buf.numel() < rows64.size):
            backend._tls.staging = torch.empty(
                rows64.size, dtype=torch.float32, pin_memory=True)
            allocs.append((rows64.size, time.perf_counter() - t0))
        t1 = time.perf_counter()
        out = real(backend, rows64)
        calls.append(time.perf_counter() - t1)
        return out

    pe = ServingEngine.from_spill(path, cache_pages=CACHE_PAGES,
                                  device=DEVICE)
    pe.store.cache.clear()
    pe.store.stats.reset()
    secs = {}
    with mock.patch.object(_PagedBackend, "_to_device", to_device), \
            pe.frontend(n_replicas=FRONTEND_REPLICAS, max_batch=B,
                        slo_ms=FRONTEND_SLO_MS) as fe:
        for kind, want in (("range", host_range), ("knn", host_knn)):
            secs[kind] = fe_submit(fe, row_requests(kind, batches[:1],
                                                    want[:1]),
                                   f"(g) paged {kind}")
        m = fe.metrics()
        reps = fe._router_obj.replicas.members
    check(all(r.ex.snap.store is reps[0].ex.snap.store for r in reps)
          and reps[0].ex.snap.store.base is pe.store,
          "frontend: (g) the replicas do not share one page cache")
    check(pe.store.cache.pinned == 0, "frontend: (g) pages stay pinned")
    io = {}
    for r in reps:
        for key, v in (r.ex.last_io or {}).items():
            if isinstance(v, (int, float)):
                io[key] = io.get(key, 0) + v
    st = pe.store.stats.snapshot()
    sizes = [n for n, _ in allocs]
    print(f"frontend: (g) paged frontend (from_spill, cache {CACHE_PAGES} "
          f"pages, {len(reps)} replicas on one page cache): 1 range "
          f"({secs['range']:.3f} s) and 1 kNN ({secs['knn']:.3f} s) batch "
          f"of {B} submitters equal to main's answers; batches="
          f"{m['batches']}; cache stats {json.dumps(st)}; last_io summed "
          f"over replicas {json.dumps(io)}; staging: {len(calls)} copies "
          f"({sum(calls):.4f} s: cast, pinned fill, copy), {len(allocs)} "
          f"pinned buffer allocation(s) on router threads with none yet "
          f"({sum(sizes) * 4} B, {sum(t for _, t in allocs):.4f} s)",
          flush=True)
    del pe


def frontend_turns(se, batches, host_range, host_knn) -> None:
    """(i): q/s through the frontend (B submitters, one row of each
    batch each) against the engine's direct batches, in turns
    frontend, direct, direct, frontend over FRONTEND_TURN_CUT batches
    of each kind, every answer held to main's."""
    n = FRONTEND_TURN_CUT
    sel, wr, wk = batches[:n], host_range[:n], host_knn[:n]
    nq = n * B
    rates = []
    for turn in ("frontend", "direct", "direct", "frontend"):
        r = {}
        if turn == "frontend":
            with se.frontend(n_replicas=FRONTEND_REPLICAS, max_batch=B,
                             slo_ms=FRONTEND_SLO_MS) as fe:
                for kind, want in (("range", wr), ("knn", wk)):
                    r[kind] = nq / fe_submit(
                        fe, row_requests(kind, sel, want),
                        f"(i) {kind}")
        else:
            r["range"] = nq / query_batches_timed(se, sel, wr, "range")
            r["knn"] = nq / query_batches_timed(se, sel, wk, "knn")
        rates.append(r)
        print(f"frontend: (i) turn {len(rates)} {turn}: range "
              f"{r['range']:.2f} q/s, kNN {r['knn']:.2f} q/s ({n} batches "
              f"of {B} each)", flush=True)

    def ratio(a, b, kind):
        return rates[a][kind] / rates[b][kind]

    print(f"frontend: (i) q/s frontend / direct: turns 1/2 range "
          f"{ratio(0, 1, 'range'):.4f} kNN {ratio(0, 1, 'knn'):.4f}, "
          f"turns 4/3 range {ratio(3, 2, 'range'):.4f} kNN "
          f"{ratio(3, 2, 'knn'):.4f} (no gain claimed)", flush=True)
    # the same range batches with the compacted gather off, direct then
    # through the frontend: a direct batch's compaction works on the
    # whole batch's union of candidates, a sub-batch's on its own
    os.environ["REPRO_COMPACT"] = "off"
    try:
        off = {"direct": nq / query_batches_timed(se, sel, wr, "range")}
        with se.frontend(n_replicas=FRONTEND_REPLICAS, max_batch=B,
                         slo_ms=FRONTEND_SLO_MS) as fe:
            off["frontend"] = nq / fe_submit(
                fe, row_requests("range", sel, wr), "(i) range, compact off")
    finally:
        os.environ["REPRO_COMPACT"] = "on"
    print(f"frontend: (i) REPRO_COMPACT=off, range: direct "
          f"{off['direct']:.2f} q/s, frontend {off['frontend']:.2f} q/s "
          f"(ratio {off['frontend'] / off['direct']:.4f}); against the "
          f"compact-on turns above", flush=True)


def query_batches_timed(se, batches, wants, kind: str) -> float:
    """Wall seconds of the engine's direct batches of ``kind``, each
    answer held to ``wants``."""
    t0 = time.perf_counter()
    for (Q, rs), want in zip(batches, wants):
        if kind == "range":
            got = se.range_query_batch(Q, rs)
            ok = all(same_range(got[b], want[b]) for b in range(B))
        else:
            ids, ds = se.knn_query_batch(Q, K_NN)
            ok = all(same_knn((ids[b], ds[b]), want[b]) for b in range(B))
        check(ok, f"frontend: (i) a direct {kind} answer differs from the "
              f"host index")
    return time.perf_counter() - t0


def frontend_loop(se, fe, mon, X, batches, deletable) -> None:
    """(f): 1,000 inserts and 1,000 deletes and a refresh; the next batch
    rebuilds the replica set and answers as the host index does after
    the updates.  Then drift: every cluster owned by replica 0, the
    Monitor ticked by hand after each kNN batch until the heat-skew
    detector fires and the frontend's daemon rebalances; results equal
    before and after."""
    from repro_torch.obs import REGISTRY
    ix = se.index
    _, _, t_ins, t_del = mutate(se, X, np.random.default_rng(12), deletable)
    t0 = time.perf_counter()
    se.refresh()
    t_ref = time.perf_counter() - t0
    Q, rs = batches[0]
    t0 = time.perf_counter()
    want_r = [ix.range_query(q, r)[:2] for q, r in zip(Q, rs)]
    want_k = [ix.knn_query(q, K_NN)[:2] for q in Q]
    t_host = time.perf_counter() - t0
    rebuilds = REGISTRY.counter("frontend.replica_rebuilds").value
    old = fe._router_obj
    fe_submit(fe, row_requests("range", [(Q, rs)], [want_r]),
              "(f) after the refresh")
    check(fe._router_obj is not old and fe._gen == se.generation
          and REGISTRY.counter("frontend.replica_rebuilds").value
          == rebuilds + 1,
          "frontend: (f) the refresh did not rebuild the replica set once")
    fe_submit(fe, row_requests("knn", [(Q, rs)], [want_k]),
              "(f) after the refresh")
    print(f"frontend: (f) {SERVE_ROWS} inserts {t_ins:.2f} s, {SERVE_ROWS} "
          f"deletes {t_del:.2f} s, refresh {t_ref:.3f} s -> generation "
          f"{se.generation}; the next batch rebuilt the replica set "
          f"(frontend.replica_rebuilds {rebuilds} -> "
          f"{REGISTRY.counter('frontend.replica_rebuilds').value}); a "
          f"range and a kNN batch equal to the host index after the "
          f"updates (host answers {t_host:.2f} s)", flush=True)

    router = fe._router_obj
    skew0 = router.heat_skew()
    router.replicas.set_ownership(np.zeros(router.replicas.K, np.int64))
    skew_drift = router.heat_skew()
    ticks = 0
    while ticks < FRONTEND_MAX_TICKS and not [
            e for e in fe.daemon.events() if e["action"] == "rebalance"]:
        fe_submit(fe, row_requests("knn", [(Q, rs)], [want_k]),
                  f"(f) drift tick {ticks + 1}")
        mon.tick()
        ticks += 1
    found = [f for f in mon.snapshot()["findings"]
             if f["detector"] == "heat_skew"]
    rebal = [e for e in fe.daemon.events() if e["action"] == "rebalance"]
    check(found and rebal, f"frontend: (f) no heat-skew finding and "
          f"rebalance within {FRONTEND_MAX_TICKS} ticks")
    skew1 = router.heat_skew()
    fe_submit(fe, row_requests("knn", [(Q, rs)], [want_k]),
              "(f) after the rebalance")
    fe_submit(fe, row_requests("range", [(Q, rs)], [want_r]),
              "(f) after the rebalance")
    check(skew1 < skew_drift, "frontend: (f) the rebalance did not lower "
          "the heat skew")
    print(f"frontend: (f) heat_skew {skew0:.4f} before the drift, "
          f"{skew_drift:.4f} with every cluster on replica 0; finding "
          f"'{found[0]['summary']}' at tick {found[0]['tick']}, daemon "
          f"rebalance at tick {rebal[0]['tick']} (owners by replica "
          f"{np.bincount(router.replicas.owner, minlength=FRONTEND_REPLICAS).tolist()}"
          f"); heat_skew after {skew1:.4f}; kNN batches before, during "
          f"and after, and a range batch after, equal to the host index",
          flush=True)


def frontend_report() -> None:
    """(h): ``repro_torch.obs.report.main`` with --demo --health and all
    three exports on the card; the files parse and the health report
    holds a finding.  The obs mode is restored after."""
    import io as _io
    from repro_torch import obs
    from repro_torch.obs import report
    mode = obs.obs_mode()
    out = _io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"obs.{k}") for k in
                 ("json", "prom", "trace")}
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = report.main(["--demo", "--health", "--device", DEVICE]
                                 + [a for k, p in paths.items()
                                    for a in (f"--{k}", p)])
        finally:
            obs.configure(mode)
        t = time.perf_counter() - t0
        with open(paths["json"]) as f:
            doc = json.load(f)
        with open(paths["trace"]) as f:
            events = json.load(f)["traceEvents"]
        with open(paths["prom"]) as f:
            prom = f.read()
    text = out.getvalue()
    n_found = int(re.search(r"findings=(\d+)", text).group(1))
    check(rc == 0 and doc["profiles"] and events and "lims_" in prom,
          "frontend: (h) the report's files are empty or do not parse")
    check(n_found >= 1, "frontend: (h) the health report has no finding")
    finding = next(line.strip() for line in text.splitlines()
                   if line.strip().startswith("["))
    print(f"frontend: (h) python -m repro_torch.obs.report --demo --health "
          f"--device {DEVICE} in {t:.2f} s: JSON ({len(doc['profiles'])} "
          f"profiles, {len(doc['metrics'])} metrics), Prometheus "
          f"({len(prom.splitlines())} lines) and Chrome trace "
          f"({len(events)} events) parse; {n_found} finding(s), first: "
          f"{finding}; obs mode restored to {obs.obs_mode()}", flush=True)


def frontend_admission(se, batches, host_knn) -> None:
    """(e): a frontend paused with max_queue = B, filled by B submitters
    of batch 0's kNN rows: the next submit is shed at once with
    FrontendOverload, and after resume() the B queued requests drain,
    each equal to the host index."""
    from repro_torch.serving import FrontendOverload
    with se.frontend(n_replicas=FRONTEND_REPLICAS, max_batch=B,
                     slo_ms=FRONTEND_SLO_MS, max_queue=B) as adm:
        adm.pause()
        Q, _ = batches[0]
        errors = []

        def submit(j):
            try:
                if not same_knn(adm.knn_query(Q[j], K_NN), host_knn[0][j]):
                    errors.append(j)
            except Exception as e:
                errors.append(repr(e))
        threads = [threading.Thread(target=submit, args=(j,), daemon=True)
                   for j in range(B)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + FRONTEND_JOIN_S
        while True:
            with adm._cv:
                pending = len(adm._pending)
            if pending == B or time.perf_counter() > deadline:
                break
            time.sleep(0.001)
        check(pending == B, f"frontend: (e) only {pending} of {B} queued")
        t0 = time.perf_counter()
        try:
            adm.knn_query(Q[0], K_NN)
            shed = False
        except FrontendOverload:
            shed = True
        t_shed = time.perf_counter() - t0
        check(shed and adm.metrics()["shed"] == 1,
              "frontend: (e) the submit past a full queue was not shed")
        t0 = time.perf_counter()
        adm.resume()
        for t in threads:
            t.join(max(deadline - time.perf_counter(), 0.0))
        t_drain = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads) and not errors,
              f"frontend: (e) the queued requests did not drain exactly "
              f"({errors[:1]})")
        m = adm.metrics()
    print(f"frontend: (e) paused with max_queue={B}: the {B + 1}th submit "
          f"raised FrontendOverload in {t_shed * 1e3:.3f} ms (shed="
          f"{m['shed']}, shed_rate={m['shed_rate']}); after resume the "
          f"{B} queued requests drained in {t_drain:.3f} s "
          f"({m['batches']} batch(es)), each equal to the host index",
          flush=True)


def frontend_counted(fe, sel, host_range, host_knn) -> dict:
    """(b) and (d)'s counts: B submitters, submitter j sending row j of
    each batch of ``sel``, range then kNN, through ``fe``; the launch
    counters and the registry zeroed before, the launches checked
    against the batches and sub-batches the frontend and the router
    made.  Returns the launches by (nq, np)."""
    from repro_torch import obs
    from repro_torch.kernels import _cuda
    shapes, spying = shape_spy(("pdist", "range_filter", "pdist_rankeval"))
    nq = 2 * len(sel) * B
    sync()
    obs.REGISTRY.reset()            # (b)'s spans alone in the split
    _cuda.reset_launches()
    spying.start()
    try:
        with dispatch_log() as log:
            secs = fe_submit(fe, [a + b for a, b in zip(
                row_requests("range", sel, host_range),
                row_requests("knn", sel, host_knn))], "(b)")
        sync()
    finally:
        spying.stop()
    counts = dict(_cuda.LAUNCHES)
    m = fe.metrics()
    built = fe._router_obj.routing_ex.planner.built
    frontend_line("(b) 64 submitters, each row j of main's range then kNN "
                  "batches", m, nq, secs)
    frontend_split(secs)
    n_b = m["batches"]
    check(built == n_b == len(log.batches),
          f"frontend: (b) {built} plans for {n_b} batches")
    check(all(len(keys) == 1 for keys in log.batches),
          "frontend: (b) a batch mixed request keys")
    subs_r = [s for s in log.subs if s[0] == "range"]
    subs_k = [s for s in log.subs if s[0] == "knn"]
    n_knn_b = sum(1 for keys in log.batches if next(iter(keys))[0] == "knn")
    rounds = sum(s[2] for s in subs_k)
    want = {"pdist_rankeval": n_b + len(subs_r) + rounds,
            "range_filter": len(subs_r), "pdist": n_knn_b + len(subs_k)}
    for name, n in want.items():
        check(counts[name] == n, f"frontend: (d) {name} launched "
              f"{counts[name]} times, not {n}")
        check(sum(shapes[name].values()) == counts[name],
              f"frontend: (d) {name}: the shape tally misses launches")
    spread = obs.REGISTRY.histogram("router.replica_spread")
    print(f"frontend: (b) every answer equal to main's host answers; "
          f"{built} plans for {n_b} batches (one a batch); "
          f"{len(log.subs)} sub-batches (range sizes "
          f"{sorted(s[1] for s in subs_r)}, kNN sizes "
          f"{sorted(s[1] for s in subs_k)}, kNN rounds "
          f"{sorted(set(s[2] for s in subs_k))}, kNN driver "
          f"{'+'.join(sorted(set(s[3] for s in subs_k)))})", flush=True)
    print(f"frontend: (d) launches {json.dumps(counts)}: pdist_rankeval = "
          f"{n_b} batches + {len(subs_r)} range sub-batches + {rounds} kNN "
          f"sub-batch rounds; range_filter = {len(subs_r)} range "
          f"sub-batches; pdist = {n_knn_b} kNN batches + {len(subs_k)} kNN "
          f"sub-batches; router.replica_spread p50={spread.percentile(50)} "
          f"mean={spread.mean:.3f} max={spread.max} (n={spread.count})",
          flush=True)
    for name, by in shapes.items():
        print(f"frontend: (d) {name} launches by (nq, np): "
              + ", ".join(f"{n} x {s}" for s, n in sorted(by.items())),
              flush=True)
    return shapes


def frontend_mixed(fe, batches, host_range, host_knn) -> None:
    """(c): B/2 range and B/2 kNN submitters at once over the first
    FRONTEND_MIXED_CUT batches; no batch mixes kinds."""
    half = B // 2
    n = min(FRONTEND_MIXED_CUT, len(batches))
    print(f"frontend: CUT: (c) runs {n} of main's {len(batches)} batches "
          f"of each kind", flush=True)
    with dispatch_log() as log:
        secs = fe_submit(fe, row_requests(
            "range", batches[:n], host_range, range(half))
            + row_requests("knn", batches[:n], host_knn, range(half, B)),
            "(c) mixed")
    check(all(len(keys) == 1 for keys in log.batches),
          "frontend: (c) a batch mixed range and kNN requests")
    kinds = [next(iter(keys))[0] for keys in log.batches]
    print(f"frontend: (c) {half} range and {B - half} kNN submitters at "
          f"once: {len(kinds)} batches ({kinds.count('range')} range, "
          f"{kinds.count('knn')} kNN, none mixed), every answer equal to "
          f"the host index, {2 * n * half / secs:.2f} q/s", flush=True)


def phase_frontend(X, ix, batches, host_range, host_knn, spilled) -> None:
    """Replica-set serving through the request frontend, parts (a)-(i)
    (module doc).  ``ix`` is main's host index, unchanged."""
    from repro_torch import obs
    from repro_torch.obs.monitor import Monitor
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    os.environ["REPRO_COMPACT"] = "on"
    mode = obs.obs_mode()
    obs.configure("on")
    se = ServingEngine(ix, refresh_every=0, device=DEVICE)
    check(se.snapshot.device_nbytes() == spilled["device_bytes"],
          "frontend: the engine's snapshot differs in size from main's")
    print(f"frontend: ServingEngine on main's host index, served by "
          f"{executor_name(se)}", flush=True)
    frontend_placement(se.snapshot)

    sel = batches[:FRONTEND_BATCHES]
    if len(sel) < len(batches):
        print(f"frontend: CUT: (b) runs {len(sel)} of main's {len(batches)} "
              f"batches of each kind", flush=True)
    with se.frontend(n_replicas=FRONTEND_REPLICAS, max_batch=B,
                     slo_ms=FRONTEND_SLO_MS) as fe:
        shapes = frontend_counted(fe, sel, host_range, host_knn)
        frontend_kernels_vs_plain(se.snapshot, shapes, *batches[0])
        frontend_mixed(fe, batches, host_range, host_knn)
    frontend_admission(se, batches, host_knn)
    frontend_turns(se, batches, host_range, host_knn)

    deletable = [int(g) for g in np.random.default_rng(13).permutation(
        len(X)) if g not in ix.tombstones]
    mon = Monitor(interval=3600.0)      # ticked by hand in (f)
    with se.frontend(n_replicas=FRONTEND_REPLICAS, max_batch=B,
                     slo_ms=FRONTEND_SLO_MS, monitor=mon) as fe:
        fe_submit(fe, row_requests("knn", batches[:1], host_knn[:1]),
                  "(f) before the updates")
        frontend_loop(se, fe, mon, X, batches, deletable)
    check(not mon.running, "frontend: (f) close() left the monitor running")
    del se, fe

    frontend_paged(spilled["path"], batches, host_range, host_knn)
    frontend_report()
    obs.configure(mode)
    print(f"frontend: all parts in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------- baselines
def baseline_answers(ix, batches, knn: bool):
    """Per query (ids, dists) and stats of ``ix`` over ``batches``, and
    the wall seconds of each kind."""
    rng_out, knn_out, stats = [], [], []
    t0 = time.perf_counter()
    for Q, rs in batches:
        for q, r in zip(Q, rs):
            ids, d, st = ix.range_query(q, r)
            rng_out.append((np.asarray(ids), np.asarray(d)))
            stats.append(("range", st))
    t_range = time.perf_counter() - t0
    t0 = time.perf_counter()
    if knn:
        for Q, _ in batches:
            for q in Q:
                ids, d, st = ix.knn_query(q, K_NN)
                knn_out.append((np.asarray(ids), np.asarray(d)))
                stats.append(("knn", st))
    return rng_out, knn_out, stats, t_range, time.perf_counter() - t0


def baselines_kernels_vs_plain(ix, snap, Q, rs, shapes) -> None:
    """The executor's kernels against their plain versions, bit for
    bit, at this phase's shapes: pdist at (B, P) and (B, G),
    range_filter at (B, P) on the guard-widened radii, pdist_rankeval at
    (B, G) and rankeval over the snapshot's rank columns."""
    from repro_torch.core.planner import _BALL_ABS, _R_ABS, _R_REL
    from repro_torch.core.snapshot import rank_columns
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import pdist_rankeval_plain
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    from repro_torch.kernels.rankeval import rank_math_plain
    q = torch.from_numpy(Q.astype(np.float32)).to(DEVICE)
    rf = torch.from_numpy(rs.astype(np.float32)).to(DEVICE)
    P, G, C = snap.n_slots, snap.K * snap.m, snap.coef.shape[-1]
    rows, piv = snap.rows.reshape(P, D), snap.pivots.reshape(G, D)
    coef = snap.coef.reshape(G, C)
    lo, hi, nn = (t.reshape(G) for t in
                  (snap.model_lo, snap.model_hi, snap.model_n))
    N = snap.n_rings
    for pts in (rows, piv):
        check(torch.equal(ops.pdist(q, pts), pdist_plain(q, pts)),
              f"baselines: pdist differs from its plain version at "
              f"({B}, {pts.shape[0]})")
    r = rf * (1.0 + _R_REL) + _BALL_ABS
    mask, cnt = ops.range_filter(q, rows, r)
    mask_p, cnt_p = range_filter_plain(q, rows, r * r)
    check(torch.equal(mask, mask_p) and torch.equal(cnt, cnt_p),
          f"baselines: range_filter differs from its plain version at "
          f"({B}, {P})")
    rg = rf * (1.0 + _R_REL) + _R_ABS
    for f, p in zip(ops.pdist_rankeval(q, piv, coef, lo, hi, nn, rg, N),
                    pdist_rankeval_plain(q, piv, coef, lo, hi, nn, rg, N)):
        check(same_bits(f, p), f"baselines: pdist_rankeval differs from "
              f"its plain version at ({B}, {G})")
    x = torch.from_numpy(rank_columns(ix)).to(DEVICE)
    for a, b in zip(ops.rankeval(x, coef, lo, hi, nn, N),
                    rank_math_plain(x, coef, lo, hi, nn, N)):
        check(torch.equal(a, b), f"baselines: rankeval differs from its "
              f"plain version at {tuple(x.shape)}")
    print(f"baselines: pdist at ({B}, {P}) and ({B}, {G}), range_filter at "
          f"({B}, {P}), pdist_rankeval at ({B}, {G}) and rankeval at "
          f"{tuple(x.shape)} equal their plain versions bit for bit; the "
          f"executor's launches by (nq, np): "
          + "; ".join(f"{name} " + ", ".join(f"{n} x {s}" for s, n in
                                             sorted(by.items()))
                      for name, by in shapes.items()), flush=True)


def phase_baselines(n: int) -> None:
    """The paper's comparison (benchmarks/bench_range.py, bench_knn.py)
    on one GaussMix corpus: the five baselines, the host LIMSIndex and
    the port's QueryExecutor on the card answer the same range and kNN
    batches; every answer equals the host index's."""
    from repro_torch import baselines
    from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
    from repro_torch.core.snapshot import LIMSSnapshot
    from repro_torch.data.datasets import gauss_mix
    from repro_torch.kernels import _cuda
    t_phase = time.perf_counter()
    if n > BASELINE_N:
        print(f"baselines: CUT: the corpus has n={BASELINE_N:,} rows, not "
              f"--n {n:,}: BallTree and ZMIndex build, and every baseline "
              f"queries, in Python on the host", flush=True)
        n = BASELINE_N
    X = gauss_mix(n, D, seed=0)
    space = MetricSpace(X, "l2")
    batches = make_queries(X, np.random.default_rng(3), BASELINE_BATCHES)
    nq = BASELINE_BATCHES * B
    t0 = time.perf_counter()
    ix = LIMSIndex(space, n_clusters=K_CLUSTERS, m=M, n_rings=RINGS,
                   degree=DEGREE)
    t_build = time.perf_counter() - t0
    want_r, want_k, stats, t_r, t_k = baseline_answers(ix, batches, True)
    rows = [("lims (host)", t_build, stats, t_r, t_k)]
    methods = (("LinearScan", {}), ("MLIndex", dict(n_clusters=K_CLUSTERS)),
               ("NLIMS", dict(n_clusters=K_CLUSTERS, m=M, n_rings=RINGS,
                              degree=DEGREE)),
               ("ZMIndex", {}), ("BallTree", {}))
    for name, kw in methods:
        t0 = time.perf_counter()
        bl = getattr(baselines, name)(space, **kw)
        t_build = time.perf_counter() - t0
        knn = name != "ZMIndex"
        got_r, got_k, stats, t_r, t_k = baseline_answers(bl, batches, knn)
        for i, (g, w) in enumerate(zip(got_r, want_r)):
            check(same_range(g, w), f"baselines: {name} range query {i} "
                  f"differs from the host index")
        for i, (g, w) in enumerate(zip(got_k, want_k)):
            check(same_knn(g, w), f"baselines: {name} kNN query {i} "
                  f"differs from the host index")
        rows.append((bl.name, t_build, stats, t_r, t_k if knn else None))
    # the port's executor on the card, its launches counted
    shapes, spying = shape_spy(("pdist", "range_filter", "pdist_rankeval"))
    sync()
    _cuda.reset_launches()
    spying.start()
    t0 = time.perf_counter()
    snap = LIMSSnapshot.build(ix, device=DEVICE)
    ex = QueryExecutor(snap)
    sync()
    t_snap = time.perf_counter() - t0
    t0 = time.perf_counter()
    for bi, (Q, rs) in enumerate(batches):
        for b, g in enumerate(ex.range_query_batch(Q, rs)):
            check(same_range(g, want_r[bi * B + b]), f"baselines: the "
                  f"executor's range query {bi * B + b} differs from the "
                  f"host index")
    ex_r = time.perf_counter() - t0
    t0 = time.perf_counter()
    for bi, (Q, _) in enumerate(batches):
        ids, ds = ex.knn_query_batch(Q, K_NN)
        for b in range(B):
            check(same_knn((ids[b], ds[b]), want_k[bi * B + b]),
                  f"baselines: the executor's kNN query {bi * B + b} "
                  f"differs from the host index")
    ex_k = time.perf_counter() - t0
    sync()
    spying.stop()
    counts = dict(_cuda.LAUNCHES)
    for name in MAIN_KERNELS:
        check(counts[name] > 0, f"baselines: kernel {name} was not launched "
              f"on the executor's path")
    print(f"baselines: GaussMix n={n:,} d={D}; {BASELINE_BATCHES} batches "
          f"of {B} range (selectivity {SELECTIVITY:g}) and kNN (k={K_NN}) "
          f"queries; every answer of every method equals the host "
          f"LIMSIndex's (ids and f64 distances; kNN ids as sets at ties)",
          flush=True)
    for name, t_build, stats, t_r, t_k in rows:
        per = {}
        for kind, st in stats:
            acc = per.setdefault(kind, [0, 0, 0])
            acc[0] += 1
            acc[1] += st.pages
            acc[2] += st.dist_comps
        line = f"baselines: {name:12s} build {t_build:.3f} s; range " \
               f"{nq / t_r:.2f} q/s pages/query " \
               f"{per['range'][1] / per['range'][0]:.1f} dist/query " \
               f"{per['range'][2] / per['range'][0]:.1f}"
        if t_k is not None:
            line += (f"; kNN {nq / t_k:.2f} q/s pages/query "
                     f"{per['knn'][1] / per['knn'][0]:.1f} dist/query "
                     f"{per['knn'][2] / per['knn'][0]:.1f}")
        else:
            line += "; kNN: none (ZM answers range and point queries only)"
        print(line, flush=True)
    print(f"baselines: {'executor':12s} snapshot on the card in "
          f"{t_snap:.3f} s; range {nq / ex_r:.2f} q/s kNN {nq / ex_k:.2f} q/s "
          f"(one snapshot + plan + kernels + host f64 refinement; no page "
          f"accounting); launches {json.dumps(counts)}", flush=True)
    Q, rs = batches[0]
    baselines_kernels_vs_plain(ix, snap, Q, rs, shapes)
    del ex, snap
    torch.cuda.empty_cache()
    print(f"baselines: all in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------- lm
def lm_model(cfg, seed: int):
    """The port's own random parameters for ``cfg`` on the card."""
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return init_params(zoo.model_specs(cfg), g, cfg.dtype, device=DEVICE)


def lm_tokens(shape, vocab: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, vocab, size=shape).astype(np.int32)).to(DEVICE)


def assert_close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        fail(f"{what}: {e}")
    return err


def exact_attention(q, k, v, kv_len=None, causal=True, window=None,
                    score_dtype=None):
    """GQA attention of (B, H, S, D) tensors in f64 with the kernel's
    mask (causal from the top-left origin, keys at or beyond ``kv_len``
    masked, and with ``window`` keys with qpos - kpos >= window): the
    arbiter where a kernel and its plain version part.  With
    ``score_dtype`` the scores are the f32 products of q * scale and k
    rounded to that dtype, the rest still f64: the error of a kernel
    that kept its scores in that dtype."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    pos = torch.arange(sk, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    ok = (pos < (sk if kv_len is None else kv_len))[None, :].expand(sq, sk)
    if causal:
        ok = ok & (qpos >= pos[None, :])
    if window is not None:
        ok = ok & (qpos - pos[None, :] < window)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for h in range(hk):
            if score_dtype is None:
                s = torch.einsum("gqd,kd->gqk",
                                 q[bi, h * g:(h + 1) * g].double(),
                                 k[bi, h].double()) / d ** 0.5
            else:
                s = torch.einsum("gqd,kd->gqk",
                                 q[bi, h * g:(h + 1) * g].float()
                                 * (1.0 / d ** 0.5), k[bi, h].float())
                s = s.to(score_dtype).double()
            out[bi, h * g:(h + 1) * g] = torch.softmax(
                s.masked_fill(~ok, float("-inf")), -1) @ v[bi, h].double()
    return out


def flash_refs(q, k, v, kv_len, causal=True, window=None):
    """(plain version's output, the f64 answer) on the same operands."""
    from repro_torch.kernels.ref import flash_attention_ref
    plain = flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                window=window).double()
    return plain, exact_attention(q, k, v, kv_len, causal, window)


def flash_verdict(got, plain, exact, shift: float = 0.0):
    """(passes, max |got - plain|, readings) of a bf16 flash_attention
    output against its plain version and the f64 answer: within the bar
    rtol = atol = 2**-7 of the f64 answer everywhere, the bar widened by
    ``shift`` (absolute, added to every element's bar); and wherever it
    parts from the plain version by more than the bar, nearer the f64
    answer than the plain version."""
    tol = 2.0 ** -7
    got = got.double()
    bar = tol * (1.0 + exact.abs())
    got_off, plain_off = (got - exact).abs() / bar, (plain - exact).abs() / bar
    beyond = (got - plain).abs() / (tol * (1.0 + plain.abs())) > 1
    n_beyond, n_plain_off = int(beyond.sum()), int((plain_off > 1).sum())
    n_blamed = int((beyond & (got_off >= plain_off)).sum())
    widened = float(((got - exact).abs() / (bar + shift)).max())
    err = float((got - plain).abs().max())
    readings = (f"max |diff| from plain {err:.4g}; {n_beyond} elements "
                f"beyond rtol = atol = 2**-7 of plain, {n_blamed} of them "
                f"no nearer the f64 answer than plain; max share of the bar "
                f"from the f64 answer: kernel {float(got_off.max()):.4g}, "
                f"plain {float(plain_off.max()):.4g} (plain beyond it at "
                f"{n_plain_off} elements)")
    if shift:
        readings += (f"; of the bar widened by the plain version's score "
                     f"rounding {shift:.4g}: kernel {widened:.4g}")
    return n_blamed == 0 and widened <= 1.0, err, readings


def check_flash_bf16(got, q, k, v, kv_len, what, causal=True, window=None,
                     shift: float = 0.0):
    """Holds a bf16 flash_attention output to the f64 answer within
    rtol = atol = 2**-7 everywhere, and reads it against its plain
    version (flash_attention_ref) at the same bar: wherever the two part
    by more than the bar, the output must lie nearer the f64 answer than
    the plain version does (flash_verdict).  The plain version's f32
    scores carry the rounding of a sequential f32 dot product of q *
    scale and k; at rows whose leading keys nearly tie, with |v| ~ 100,
    that alone moves an output by about the bar (PERF.md, Findings).
    ``shift`` widens the f64 bar by exactly that rounding where the
    caller measured it (score_rounding: the families' rows, whose large
    q and k carry more than a bar of it); the dense rows keep the strict
    bar.  Returns max |got - plain| and the readings."""
    ok, err, readings = flash_verdict(
        got, *flash_refs(q, k, v, kv_len, causal, window), shift)
    check(ok, f"{what}: {readings}")
    return err, readings


def lm_deviations(params, tokens, cfg):
    """Logits of forward_seq + _unembed, and of prefill(tokens[:, :-1])
    and a decode step of tokens[:, -1], with the model's attention as
    it is patched."""
    from repro_torch.models import transformer as tr
    from repro_torch.models import zoo
    x, _, _ = tr.forward_seq(params, tokens, cfg)
    logits = tr._unembed(params, x, cfg)
    lp, cache = zoo.prefill_fn(cfg, tokens.shape[1] + 8)(
        params, {"tokens": tokens[:, :-1]})
    ld, _ = zoo.decode_fn(cfg)(params, tokens[:, -1], cache)
    return logits, lp[:, 0], ld[:, 0]


def rel_dev(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def phase_lm_consistency(seed: int):
    """(a): float32 at Llama-3-8B widths and a cut depth.  Prefill and
    decode against the forward, and the kernel forward against the
    dense_attention forward, within LM_F32_REL of the logits' scale;
    the plain path's own readings and a bf16-attention control are
    printed beside them, and the control must exceed the bar."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tr
    full = get_arch(LM_ARCH)
    print(f"lm: CUT: (a) float32 runs {LM_F32_LAYERS} of {full.n_layers} "
          f"layers at full width (d_model {full.d_model}, {full.n_q_heads} "
          f"q heads, {full.n_kv_heads} kv heads, hd {full.hd}, d_ff "
          f"{full.d_ff}, vocab {full.vocab})", flush=True)
    cfg = dataclasses.replace(full, n_layers=LM_F32_LAYERS, dtype="float32")
    params = lm_model(cfg, seed)
    tokens = lm_tokens((2, 64), cfg.vocab, seed)
    kernel = tr.attention

    def control(q, k, v, cfg_):
        """The model's attention on q, k and v rounded to bf16."""
        return kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                      cfg_).to(q.dtype)

    runs = {}
    for path, attn in (("kernel", kernel), ("plain", tr.plain_attention),
                       ("control", control)):
        with mock.patch.object(tr, "attention", attn):
            runs[path] = lm_deviations(params, tokens, cfg)
    del params
    torch.cuda.empty_cache()
    p_fwd = runs["plain"][0]
    # (prefill at -2, decode at -1, whole forward) against their
    # references: a path's own forward, or the plain forward
    dev = {path: (rel_dev(lp, ref[:, -2]), rel_dev(ld, ref[:, -1]),
                  rel_dev(fwd, p_fwd))
           for path, (fwd, lp, ld) in runs.items()
           for ref in [p_fwd if path == "control" else fwd]}
    fmt = lambda t: " / ".join(f"{x:.3g}" for x in t)
    print(f"lm: (a) float32 {LM_F32_LAYERS} layers, B=2 S=64, logits max "
          f"|{float(p_fwd.abs().max()):.4g}|; max |diff| / max |want| of "
          f"prefill at -2 / decode at -1 / forward against the plain "
          f"forward: kernel path {fmt(dev['kernel'])}, plain path "
          f"{fmt(dev['plain'])} (prefill and decode against each path's "
          f"own forward); bf16-attention control against the plain "
          f"forward {fmt(dev['control'])}; bar {LM_F32_REL:g}", flush=True)
    check(all(bool(torch.isfinite(t).all()) for t in runs["kernel"]),
          "lm: (a) logits not finite")
    for what, d in zip(("prefill logits differ from forward_seq's at -2",
                        "decode logits differ from forward_seq's at -1",
                        "the forward with the flash kernel differs from "
                        "the one with dense_attention"), dev["kernel"]):
        check(d <= LM_F32_REL, f"lm: (a) {what}: {d:.3g} > {LM_F32_REL:g}")
    check(min(dev["control"]) > LM_F32_REL,
          f"lm: (a) the bar {LM_F32_REL:g} does not separate the bf16 "
          f"control ({fmt(dev['control'])})")


def phase_lm_serving(seed: int):
    """(b): bfloat16 Llama-3-8B at full depth: prefill of 4 x 2,000
    tokens and 32 greedy decode steps, the counted LM main path.
    Returns the kernel's launch count and the captured layer-0 q, k, v
    (for the kernel row)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as tr
    from repro_torch.models import zoo
    from repro_torch.models.params import count_params, tree_bytes
    cfg = get_arch(LM_ARCH)
    specs = zoo.model_specs(cfg)
    cache_len = LM_PROMPT + LM_DECODE
    sync()
    t0 = time.perf_counter()
    params = lm_model(cfg, seed)
    sync()
    t_init = time.perf_counter() - t0
    c_bytes = 2 * np.prod(tr.cache_spec(cfg, LM_REQUESTS, cache_len)["k"][0]
                          ) * 2
    print(f"lm: (b) {cfg.name} bfloat16, {cfg.n_layers} layers, "
          f"{count_params(specs):,} parameters ({tree_bytes(specs, cfg.dtype):,}"
          f" bytes) drawn on the card in {t_init:.2f} s; cache {c_bytes:,} "
          f"bytes (B={LM_REQUESTS}, T={cache_len})", flush=True)
    prefill, decode = zoo.prefill_fn(cfg, cache_len), zoo.decode_fn(cfg)
    tokens = lm_tokens((LM_REQUESTS, LM_PROMPT), cfg.vocab, seed + 1)
    # warm-up (cuBLAS handles, the first launch), not counted
    lw, cw = prefill(params, {"tokens": tokens[:1, :128]})
    decode(params, lw[:, 0].argmax(-1), cw)
    del lw, cw

    captured = {}
    calls = []

    def spy(q, k, v, cfg_):
        o = real(q, k, v, cfg_)
        if len(calls) in (0, cfg.n_layers - 1):
            captured[len(calls)] = (q, k, v, o)
        calls.append(1)
        return o

    real = tr.attention
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(tr, "attention", spy):
        logits, cache = prefill(params, {"tokens": tokens})
    sync()
    t_prefill = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        token = logits[:, 0].argmax(-1)
        logits, cache = decode(params, token, cache)
        finite &= torch.isfinite(logits).all()
    sync()
    t_decode = time.perf_counter() - t0
    counts_all = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(bool(finite), "lm: (b) logits are not all finite")
    check(counts["flash_attention"] == cfg.n_layers,
          f"lm: (b) flash_attention launched {counts['flash_attention']} "
          f"times in the prefill, not once per layer ({cfg.n_layers})")
    check(cache["pos"] == cache_len, "lm: (b) the cache did not fill")
    n_tok = LM_REQUESTS * LM_PROMPT
    print(f"lm: (b) prefill {LM_REQUESTS} x {LM_PROMPT} tokens in "
          f"{t_prefill:.4f} s = {n_tok / t_prefill:.1f} tokens/s; "
          f"{LM_DECODE} greedy decode steps in {t_decode:.4f} s = "
          f"{t_decode * 1e3 / LM_DECODE:.3f} "
          f"ms/step, {LM_REQUESTS * LM_DECODE / t_decode:.1f} tokens/s; "
          f"max_memory_allocated={peak}; launches over the prefill "
          f"{json.dumps(counts)}, after decode {json.dumps(counts_all)}; "
          f"logits finite", flush=True)
    check(sorted(captured) == [0, cfg.n_layers - 1],
          "lm: (b) layers 0 and 31 were not captured")
    for layer, (q, k, v, o) in sorted(captured.items()):
        _, readings = check_flash_bf16(
            o.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), None, f"lm: (b) layer {layer}: "
            f"flash_attention differs by more than one bf16 ulp")
        print(f"lm: (b) layer {layer}: flash_attention against "
              f"flash_attention_ref and the f64 answer on its q, k, v: "
              f"{readings}", flush=True)
    # where the time goes: one prefill and one decode step under the
    # profiler, device activities by name (after the counted run)
    batch = {"tokens": tokens}
    del logits
    for what, fn in (("prefill", lambda: prefill(params, batch)),
                     ("decode step", lambda: decode(
                         params, token, dict(cache, pos=cache_len - 1)))):
        wall, dev, top = device_busy(fn, n_top=10)
        print(f"lm: (b) profile {what}: wall_ms={wall:.3f} device_ms="
              f"{dev:.3f} busy={dev / wall:.4f} top={json.dumps(top)}",
              flush=True)
    q, k, v, _ = captured[0]
    del params, cache, captured
    torch.cuda.empty_cache()
    return counts["flash_attention"], (q, k, v)


def dump_sass(lib):
    """(cuobjdump's path or None, its --dump-sass run on ``lib`` or
    None): the CUDA toolkit's cuobjdump or Triton's copy."""
    import importlib.util
    from repro_torch.kernels import _cuda
    exes = [shutil.which("cuobjdump"),
            *(str(Path(r, "bin", "cuobjdump")) for r in _cuda.CUDA_ROOTS)]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        exes.append(str(Path(spec.origin).parent / "backends" / "nvidia"
                        / "bin" / "cuobjdump"))
    exe = next((e for e in exes if e and Path(e).is_file()), None)
    sass = subprocess.run([exe, "--dump-sass", str(lib)],
                          capture_output=True, text=True,
                          timeout=300) if exe else None
    return exe, sass


def sass_instructions(kernel: str, template: str) -> str:
    """A note: the SASS instructions of ``template`` (a mangled-name
    fragment, say "rankeval_kernelILi9E") in ``kernel``'s library,
    counted statically: every instruction of the function, the division's
    slow-path code included."""
    from repro_torch.kernels import _cuda
    exe, sass = dump_sass(_cuda.build()[_cuda.SOURCES[kernel]].path)
    if sass is None or sass.returncode != 0:
        return f"sass_instructions(\"{template}\")=not available"
    for fn in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        if template in fn.split("\n", 1)[0]:
            n = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", fn))
            return f"sass_instructions(\"{template}\")={n}"
    return f"sass_instructions(\"{template}\")=not found"


def flash_bodies_and_sass():
    """Which body the flash library launches for each type and head
    width (its own flash_attention_body), and the HGMMA (wgmma)
    instructions in each kernel's SASS, read with cuobjdump from the CUDA
    toolkit or Triton's copy ("not available" without one).  Fails if
    bf16 at D 64, 80, 112 or 128 is not the tensor-core body, if f32 at
    any width or bf16 at D 16 or 32 is not the CUDA-core body, or if
    readable SASS shows no HGMMA in flash_tc_kernel at D 80, 112 or
    128."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    lib = _cuda.build()[_cuda.SOURCES["flash_attention"]].path
    names = {1: "tensor cores (flash_tc_kernel)",
             0: "CUDA cores (flash_kernel)"}
    bodies = {(dt, d): fa.body(getattr(torch, dt), d)
              for dt in ("float32", "bfloat16") for d in fa.HEAD_DIMS}
    print("kernels: flash_attention bodies: " + "; ".join(
        f"{dt} D {d}: {names.get(b, b)}" for (dt, d), b in bodies.items()),
        flush=True)
    for (dt, d), b in bodies.items():
        want = int(dt == "bfloat16" and d >= 64)
        check(b == want, f"kernels: {dt} D {d} takes body {b}, not "
              f"{names[want]}")
    exe, sass = dump_sass(lib)
    if sass is None or sass.returncode != 0:
        print("kernels: flash_attention SASS HGMMA count: not available "
              f"({'no cuobjdump' if exe is None else sass.stderr.strip()})",
              flush=True)
        return
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        m = re.search(r"(flash_tc_kernel|flash_kernel)I(f|13__nv_bfloat16)?"
                      r"Li(\d+)E(?:Lb(\d)E)?", fn.split("\n", 1)[0])
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            win = ", window" if m.group(4) == "1" else ""
            counts[f"{m.group(1)}<{dt}, {m.group(3)}{win}>"] = \
                fn.count("HGMMA")
    print(f"kernels: flash_attention SASS HGMMA count ({exe}): "
          f"{json.dumps(counts)}", flush=True)
    for d in (80, 112, 128):
        check(counts.get(f"flash_tc_kernel<bf16, {d}>", 0) > 0,
              f"kernels: no HGMMA in flash_tc_kernel<bf16, {d}>'s SASS")


def phase_flash_kernel(launches, qkv):
    """The kernel row at the prefill's padded shape, the bodies and
    HGMMA count of the flash library, and an f32 check of kernel against
    plain version at a small shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    flash_bodies_and_sass()
    for causal in (True, False):
        q, k, v = (torch.from_numpy(np.random.default_rng(i).normal(
            size=s).astype(np.float32)).to(DEVICE) for i, s in
            enumerate(((2, 8, 200, 128), (2, 2, 300, 128), (2, 2, 300, 128))))
        err = assert_close(ops.flash_attention(q, k, v, causal=causal),
                           flash_attention_ref(q, k, v, causal=causal), 1e-4,
                           "kernels: f32 flash_attention differs from plain")
        print(f"kernels: flash_attention f32 (2, 8, 200, 128) x (2, 2, 300, "
              f"128) causal={causal}: max |diff| from plain {err:.3g} "
              f"(bar 1e-4)", flush=True)
    q, k, v = (t.transpose(1, 2) for t in qkv)
    b, hq, s, d = q.shape
    hk = k.shape[1]
    pad = (-s) % fa.TILE
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)).contiguous()
                  for t in (q, k, v))
    sp = s + pad
    err, readings = check_flash_bf16(
        fa.flash_attention(qp, kp, vp, causal=True, kv_len=s), qp, kp, vp, s,
        "kernels: flash_attention at the prefill shape")
    print(f"kernels: flash_attention at the prefill's padded shape against "
          f"flash_attention_ref and the f64 answer: {readings}", flush=True)
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    live, flops, nbytes = flash_work(b, hq, hk, d, s, s, True, None)
    ms_at = lambda passes, rate: passes * flops / rate * 1e3
    print(f"kernels: flash_attention at the prefill's padded shape "
          f"({b}, {hq}, {sp}, {d}) x ({b}, {hk}, {sp}, {d}) bf16 causal, "
          f"kv_len {s}: {live:,} live pairs per head over the {s} real "
          f"rows, {flops:.4g} flops, {nbytes:.4g} bytes unpadded; bound at "
          f"the function's own work (one bf16 pass at "
          f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s) "
          f"{ms_at(1, hw.PEAK_FLOPS_BF16):.4f} ms; notes: the work the "
          f"tensor-core body does ({hw.FLASH_TC_PASSES:g} bf16 passes: Q K^T "
          f"once, P V as P_hi V + P_lo V) "
          f"{ms_at(hw.FLASH_TC_PASSES, hw.PEAK_FLOPS_BF16):.4f} ms, 3 bf16 "
          f"passes {ms_at(3, hw.PEAK_FLOPS_BF16):.4f} ms, the CUDA cores' "
          f"f32 rate {ms_at(1, hw.PEAK_FLOPS_F32):.4f} ms", flush=True)
    try:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qp, kp, vp, is_causal=True, enable_gqa=True)
        sdpa()
    except TypeError:       # a torch without enable_gqa: repeat k and v
        kr, vr = (t.repeat_interleave(hq // hk, 1) for t in (kp, vp))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qp, kr, vr, is_causal=True)
    return kernel_row(
        "flash_attention", launches, err,
        lambda: fa.flash_attention(qp, kp, vp, causal=True, kv_len=s), 10,
        lambda: flash_attention_ref(qp, kp, vp, causal=True, kv_len=s), 3,
        nbytes, flops, library=sdpa, flop_per_s=hw.PEAK_FLOPS_BF16)


# ---------------------------------------------------------------- families
def family_flash_spy():
    """(tally, context manager): while the manager is open, every launch
    of the flash kernel is tallied by its padded shape, causal flag and
    window (launches unchanged), and the first operands at each shape
    are kept for its kernel row."""
    from repro_torch.kernels import flash_attention as fa
    tally, first = {}, {}
    real = fa.flash_attention_cuda

    def spy(q, k, v, causal, kv_len, window=None):
        key = (tuple(q.shape), tuple(k.shape), bool(causal), kv_len, window)
        tally[key] = tally.get(key, 0) + 1
        first.setdefault(key, (q, k, v))
        return real(q, k, v, causal, kv_len, window)

    return (tally, first), mock.patch.object(fa, "flash_attention_cuda", spy)


def family_model(name: str, layers, dtype: str, seed: int, **cut):
    """(config at ``layers`` layers, or full depth for None, in
    ``dtype``, with any other ``cut`` fields; its parameters on the
    card, drawn from ``seed``; init seconds)."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(name)
    kw = dict(cut, dtype=dtype)
    if layers is not None:
        kw["n_layers"] = layers
        if cfg.n_dec_layers is not None:
            kw["n_dec_layers"] = layers
    cfg = dataclasses.replace(cfg, **kw)
    sync()
    t0 = time.perf_counter()
    params = lm_model(cfg, seed)
    sync()
    return cfg, params, time.perf_counter() - t0


def family_batch(cfg, batch: int, prompt: int, seed: int) -> dict:
    """``zoo.make_batch`` of a prefill cell: ``prompt`` tokens (a vlm's
    prefix embeddings come on top; an encdec takes ``prompt`` source
    frames and its one prime token)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import zoo
    return zoo.make_batch(cfg, ShapeCell("prefill", prompt +
                                         cfg.n_prefix_embeds, batch,
                                         "prefill"), seed, device=DEVICE)


def family_positions(cfg, batch: dict) -> int:
    """The positions a prefill of ``batch`` puts in the cache."""
    prefix = batch.get("prefix_embeds")
    return batch["tokens"].shape[1] + (0 if prefix is None
                                       else prefix.shape[1])


def teacher_forced(params, cfg, batch: dict, tokens):
    """Logits (B, S, V) of the whole of ``tokens`` in one full-sequence
    pass: forward_seq + _unembed after a vlm's prefix (its positions
    dropped), or an encdec's decoder over the encoded source."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tr
    if cfg.family == "encdec":
        mem = encdec.encode(params, batch["src_embeds"], cfg)
        return encdec.decode_train(params, mem, tokens, cfg)
    x, _, _ = tr.forward_seq(params, tokens, cfg,
                             batch.get("prefix_embeds"))
    return tr._unembed(params, x[:, x.shape[1] - tokens.shape[1]:], cfg)


def greedy_serve(params, cfg, batch: dict, steps: int):
    """Prefill then ``steps`` greedy decode steps through the zoo entry
    points.  Returns (the served logits (B, steps + 1, V), the greedy
    tokens (B, steps + 1), the final cache)."""
    from repro_torch.models import zoo
    cache_len = family_positions(cfg, batch) + steps
    logits, cache = zoo.prefill_fn(cfg, cache_len)(params, batch)
    served, toks = [logits[:, 0]], [logits[:, 0].argmax(-1)]
    decode = zoo.decode_fn(cfg)
    for _ in range(steps):
        logits, cache = decode(params, toks[-1], cache)
        served.append(logits[:, 0])
        toks.append(logits[:, 0].argmax(-1))
    return torch.stack(served, 1), torch.stack(toks, 1), cache


def family_consistency(name, layers, batch_size, prompt, steps, seed,
                       experts=None):
    """float32 at full width and a cut depth: the greedy tokens of
    prefill + ``steps`` decode steps against a teacher-forced
    full-sequence pass over the prompt and the generated tokens.  The
    served logits must lie within LM_F32_REL of the teacher-forced
    logits' max |value|, and every greedy token must equal the
    teacher-forced argmax wherever that row's top-2 margin exceeds twice
    the row's max |diff| (the bar: no rounding difference of that size
    can flip the pick).  ``experts`` cuts a MoE's expert count.  Returns
    the printed reading."""
    from repro_torch.configs.registry import get_arch
    cut = {}
    if experts is not None:
        cut["moe"] = dataclasses.replace(get_arch(name).moe,
                                         n_experts=experts)
    cfg, params, _ = family_model(name, layers, "float32", seed, **cut)
    batch = family_batch(cfg, batch_size, prompt, seed + 1)
    served, toks, _ = greedy_serve(params, cfg, batch, steps)
    tokens = torch.cat([batch["tokens"], toks[:, :-1].to(torch.int32)], 1)
    full = teacher_forced(params, cfg, batch, tokens)
    want = full[:, batch["tokens"].shape[1] - 1:]
    rel = rel_dev(served, want)
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    row_err = (served - want).abs().amax(-1)
    clear = margin > 2 * row_err
    same = toks == want.argmax(-1)
    n_tie = int((~clear).sum())
    check(bool(torch.isfinite(served).all()), f"families: {name} (f32) "
          f"logits not finite")
    check(rel <= LM_F32_REL, f"families: {name} (f32) served logits differ "
          f"from the teacher-forced pass by {rel:.3g} of their scale > "
          f"{LM_F32_REL:g}")
    check(bool(same[clear].all()), f"families: {name} (f32) greedy tokens "
          f"differ from the teacher-forced argmax at "
          f"{int((~same & clear).sum())} clear positions")
    reading = (f"{name} f32 {cfg.n_layers} layers, B={batch_size}, prompt "
               f"{prompt}, {steps} steps: max |diff| / max |logit| "
               f"{rel:.3g} (bar {LM_F32_REL:g}); greedy tokens equal at "
               f"{int(same.sum())} of {same.numel()} positions, "
               f"{n_tie} within the tie bar (top-2 margin <= 2 x the row's "
               f"max |diff|)")
    del params, served, full, want
    torch.cuda.empty_cache()
    return reading


def family_serve(name, layers, batch_size, prompt, steps, seed,
                 expect_flash):
    """bfloat16 at full width: prefill of ``batch_size`` requests and
    ``steps`` greedy decode steps, the counted main path.  Returns the
    printed row, the flash tally by shape and the first operands at each
    shape."""
    from repro_torch.kernels import _cuda
    from repro_torch.models import zoo
    from repro_torch.models.params import count_params, tree_bytes
    cfg, params, t_init = family_model(name, layers, "bfloat16", seed)
    specs = zoo.model_specs(cfg)
    batch = family_batch(cfg, batch_size, prompt, seed + 1)
    positions = family_positions(cfg, batch)
    prefill = zoo.prefill_fn(cfg, positions + steps)
    decode = zoo.decode_fn(cfg)
    # warm-up at the served shape (cuBLAS handles and heuristics, the
    # allocator's pools), neither counted nor timed; its pools stay
    lw, cw = prefill(params, batch)
    decode(params, lw[:, 0].argmax(-1), cw)
    del lw, cw
    torch.cuda.reset_peak_memory_stats()
    (tally, first), spy = family_flash_spy()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 2)]
    sync()
    _cuda.reset_launches()
    with spy:
        ev[0].record()
        logits, cache = prefill(params, batch)
        ev[1].record()
        finite = torch.isfinite(logits).all()
        for i in range(steps):
            logits, cache = decode(params, logits[:, 0].argmax(-1), cache)
            finite &= torch.isfinite(logits).all()
            ev[i + 2].record()
    sync()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(steps)]
    # more prefills at the served shape, timed alone (not counted)
    pre_ms = [ev[0].elapsed_time(ev[1])]
    for _ in range(FAMILY_PREFILLS - 1):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = prefill(params, batch)
        e1.record()
        del out
        sync()
        pre_ms.append(e0.elapsed_time(e1))
    check(bool(finite), f"families: {name} logits are not all finite")
    check(cache["pos"] == positions + steps,
          f"families: {name} cache at {cache['pos']}, not "
          f"{positions + steps}")
    check(counts["flash_attention"] == expect_flash,
          f"families: {name} launched flash_attention "
          f"{counts['flash_attention']} times, not {expect_flash}")
    # positions a prefill runs: a vlm's prefix and tokens, an encdec's
    # source frames (its one prime token aside)
    n_tok = batch_size * (positions if cfg.family != "encdec"
                          else batch["src_embeds"].shape[1])
    t_prefill = float(np.median(pre_ms)) / 1e3
    spread = {"prefill": max(pre_ms) / min(pre_ms),
              "decode": max(step_ms) / min(step_ms)}
    row = {"config": name, "layers": cfg.n_layers,
           "parameters": count_params(specs),
           "bytes": tree_bytes(specs, cfg.dtype), "init_s": t_init,
           "B": batch_size, "positions": positions,
           "prefill_s": t_prefill, "prefill_ms_each": pre_ms,
           "prefill_tokens_per_s": n_tok / t_prefill,
           "decode_steps": steps,
           "decode_ms_per_step": float(np.median(step_ms)),
           "decode_ms_min": min(step_ms), "decode_ms_max": max(step_ms),
           "max_memory_allocated": peak,
           "flash_attention_launches": counts["flash_attention"]}
    unresolved = [k for k, r in spread.items() if r > 2.0]
    flag = (f"; UNRESOLVED (its readings part by > 2x): "
            f"{', '.join(unresolved)}" if unresolved else "")
    print(f"families: {name} bfloat16 {json.dumps(row)}; medians of "
          f"{FAMILY_PREFILLS} prefills and of the {steps} decode steps, "
          f"max / min {spread['prefill']:.3f} and {spread['decode']:.3f}"
          f"{flag}; flash shapes "
          f"{json.dumps([[list(k), n] for k, n in tally.items()])}; logits "
          f"finite", flush=True)
    # where the time goes: one prefill and one decode step under the
    # profiler, after the counted run (the last step's slot again)
    token = logits[:, 0].argmax(-1)
    del logits
    for what, fn in (("prefill", lambda: prefill(params, batch)),
                     ("decode step", lambda: decode(
                         params, token, dict(cache, pos=cache["pos"] - 1)))):
        wall, dev, evs = device_busy(fn, n_top=None)
        # the flash kernels' device time: a one-call profiler window of
        # the kernel alone drops its records (kernel_row), this one not
        flash = sum(t for k, t in evs if "flash" in k)
        print(f"families: {name} profile {what}: wall_ms={wall:.3f} "
              f"device_ms={dev:.3f} busy={dev / wall:.4f} "
              f"top={json.dumps(evs[:5])} flash_attention_device_ms="
              f"{flash:.4f}", flush=True)
    del params, cache
    torch.cuda.empty_cache()
    return row, tally, first


# prefills timed per configuration (the first is the counted main path's)
FAMILY_PREFILLS = 5
# configuration, layers run (None: all), requests, prompt tokens (an
# encdec: source frames; a vlm's prefix comes on top), decode steps; the
# f32 consistency run's layers, requests, prompt, steps and expert count
# (None: the config's; kimi's 384 experts are 67.6 GB in f32).  The f32
# mixtral prompt passes the 4,096 window, so its decode steps write ring
# slots; mamba2's and zamba2's 300 tokens end in a ragged SSD chunk
FAMILY_RUNS = (
    ("mixtral-8x7b", 8, 2, 6_000, 32, (2, 1, 4_100, 8, None)),
    ("kimi-k2-1t-a32b", 1, 2, 2_000, 16, (1, 1, 256, 8, 64)),
    ("llava-next-34b", 16, 2, 1_792, 32, (2, 1, 64, 8, None)),
    ("mamba2-780m", None, 4, 2_000, 32, (4, 1, 300, 8, None)),
    ("zamba2-2.7b", None, 4, 2_000, 32, (12, 1, 300, 8, None)),
    ("seamless-m4t-large-v2", None, 4, 2_000, 32, (2, 1, 300, 8, None)),
)


def flash_expected(cfg_name: str, layers) -> int:
    """flash_attention launches of one prefill: one per attention layer
    (zamba2: one per shared-block invocation; seamless: the encoder's,
    the decoder's self- and cross-attention)."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(cfg_name)
    n = cfg.n_layers if layers is None else layers
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return n // cfg.shared_every
    if cfg.family == "encdec":
        return 3 * n
    return n


def score_rounding(q, k, v, kv_len, causal, window) -> tuple[float, str]:
    """The f32 rounding in the plain version's scores: over the live
    pairs, max |score| and its f32 ulp, the most the plain version's f32
    scores (q * scale in f32, then q k^T in f32) part from the f64
    scores, and the output shift that alone can give (2 x that x max
    |v|: softmax weights move by at most 2 x the score error, relative).
    Returns (that shift, the readings)."""
    b, hq, sq, d = q.shape
    hk, g = k.shape[1], q.shape[1] // k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(kv_len, device=q.device)[None, :]
    ok = torch.ones(sq, kv_len, dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= qpos - kpos < window
    top = err = 0.0
    for bi in range(b):
        for h in range(hk):
            qs, ks = q[bi, h * g:(h + 1) * g], k[bi, h, :kv_len]
            s32 = (qs.float() * (1.0 / d ** 0.5)) @ ks.float().T
            s64 = qs.double() @ ks.double().T / d ** 0.5
            top = max(top, float(s64.abs().masked_fill(~ok, 0).max()))
            err = max(err, float((s32.double() - s64).abs()
                                 .masked_fill(~ok, 0).max()))
    vmax = float(v[:, :, :kv_len].abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 23) if top > 0 else 0.0
    return 2 * err * vmax, (
            f"plain's f32 scores: max |score| {top:.4g} (f32 ulp there "
            f"{ulp:.3g}), max |f32 - f64 score| {err:.4g}, max |v| "
            f"{vmax:.4g}, so up to {2 * err * vmax:.4g} of output shift "
            f"from the scores alone against the bar 2**-7 x (1 + |out|)")


def family_flash_row(label, key, qkv, launches, real_len, tag="families"):
    """One flash_attention row at a family's shape: the kernel on the
    first operands the main path gave it, held to flash_attention_ref
    and the f64 answer (flash_verdict: the f64 bar widened by exactly
    the plain version's measured score rounding, score_rounding's 2 x
    err x max |v|; the plain version with its scores rounded to bf16
    must fail it), timed beside the plain version, its bound (the
    function's own work, flash_work) and scaled_dot_product_attention on
    the unpadded operands (``enable_gqa``; a window as an explicit
    boolean mask).  The bound takes the operands' dtype's peak rate;
    ``tag`` begins the printed lines."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    (qs, ks, causal, kv_len, window), (q, k, v) = key, qkv
    b, hq, sq, d = qs
    hk, sk = ks[1], ks[2]
    sq_real = min(real_len[0], sq)
    shift, rounding = score_rounding(q[:, :, :sq_real], k, v, kv_len,
                                     causal, window)
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                             window=window)
    plain, exact = flash_refs(q, k, v, kv_len, causal, window)
    ok, err, readings = flash_verdict(got, plain, exact, shift)
    check(ok, f"{tag}: flash_attention {label}: {readings}")
    # the widened bar must reject the plain version with its scores
    # kept in bf16 (a kernel that stored S in bf16)
    planted = exact_attention(q, k, v, kv_len, causal, window,
                              score_dtype=torch.bfloat16)
    share = float(((planted - exact).abs() / (
        2.0 ** -7 * (1.0 + exact.abs()) + shift)).max())
    check(not flash_verdict(planted, plain, exact, shift)[0],
          f"{tag}: flash_attention {label}: the widened bar passes the "
          f"plain version with bf16 scores ({share:.4g} widened bars)")
    readings += (f"; the plain version with bf16 scores reaches {share:.4g} "
                 f"widened bars and fails the check, as it must")
    del plain, exact, planted
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    live, flops, nbytes = flash_work(b, hq, hk, d, sq_real, kv_len, causal,
                                     window)
    qu, ku, vu = q[:, :, :sq_real], k[:, :, :kv_len], v[:, :, :kv_len]
    mask = None
    if window is not None:
        pos = torch.arange(kv_len, device=q.device)
        qp = torch.arange(sq_real, device=q.device)[:, None]
        mask = (qp >= pos) & (qp - pos < window)
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    try:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, ku, vu, enable_gqa=True, **sdpa_kw)
        sdpa()
    except TypeError:       # a torch without enable_gqa: repeat k and v
        kr, vr = (t.repeat_interleave(hq // hk, 1) for t in (ku, vu))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, kr, vr, **sdpa_kw)
    print(f"{tag}: flash_attention {label} at ({b}, {hq}, {sq}, {d}) x "
          f"({b}, {hk}, {sk}, {d}) {str(q.dtype)[6:]} causal={causal} "
          f"kv_len={kv_len} "
          f"window={window}: {sq_real} real rows, {live:,} live pairs, "
          f"{flops:.4g} flops, {nbytes:.4g} bytes unpadded; against "
          f"flash_attention_ref and the f64 answer: {readings}; {rounding}",
          flush=True)
    body = {1: "tensor cores, P V in two bf16 passes",
            0: "CUDA cores"}[fa.body(q.dtype, d)]
    if d % 64 and fa.body(q.dtype, d):
        body += f", tiles padded from {d} to 128 columns"
    return kernel_row(
        f"flash_attention {label}", launches, err,
        lambda: fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                   window=window), 10,
        lambda: flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                    window=window), 3,
        nbytes, flops, library=sdpa,
        flop_per_s=hw.PEAK_FLOPS_BF16 if q.dtype == torch.bfloat16
        else hw.PEAK_FLOPS_F32, kernel="flash_attention",
        note=f"body: {body}; notes: {hw.FLASH_TC_PASSES:g} bf16 passes (the "
             f"tensor-core body's work) "
             f"{hw.FLASH_TC_PASSES * flops / hw.PEAK_FLOPS_BF16 * 1e3:.4f} "
             f"ms, "
             f"the f32 CUDA-core rate "
             f"{flops / hw.PEAK_FLOPS_F32 * 1e3:.4f} ms")


def phase_families(seed: int) -> list:
    """The five non-dense families: per configuration an f32 greedy
    consistency run at a cut depth, then the bf16 serving run at full
    width (the counted main path); then flash_attention's rows at the
    shapes these families give it.  Returns the rows for the JSON
    line."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.zoo import ENC_MEM_LEN
    t_phase = time.perf_counter()
    rows, tallies, firsts = [], {}, {}
    for name, layers, bsz, prompt, steps, (fl, fb, fp, fs, experts) in \
            FAMILY_RUNS:
        full = get_arch(name)
        depth = full.n_layers
        experts_of = f", experts {full.moe.n_experts}" if full.moe else ""
        if layers is not None:
            print(f"families: CUT: {name} bf16 runs {layers} of {depth} "
                  f"layers{' per stack' if full.n_dec_layers else ''} at "
                  f"full width (d_model {full.d_model}, {full.n_q_heads} q "
                  f"heads, {full.n_kv_heads} kv heads, hd {full.hd}, d_ff "
                  f"{full.d_ff}, vocab {full.vocab}"
                  f"{experts_of})", flush=True)
        cut_experts = (f"; experts {experts} of {full.moe.n_experts}"
                       if experts else "")
        print(f"families: CUT: {name} f32 consistency runs {fl} of "
              f"{depth} layers{' per stack' if full.n_dec_layers else ''}"
              f"{cut_experts}, B={fb}, prompt {fp}, {fs} steps", flush=True)
        reading = family_consistency(name, fl, fb, fp, fs, seed, experts)
        print(f"families: {reading}", flush=True)
        row, tally, first = family_serve(name, layers, bsz, prompt, steps,
                                         seed, flash_expected(name, layers))
        rows.append(row)
        tallies[name], firsts[name] = tally, first
    print(f"families: encdec cache_desc memory length ENC_MEM_LEN "
          f"{ENC_MEM_LEN} (the decode cell's); the served seamless "
          f"requests' memory is their 2,000 source frames", flush=True)
    print(f"families: table {json.dumps(rows)}", flush=True)

    def pick(name, pred):
        keys = [k for k in tallies[name] if pred(k)]
        check(len(keys) == 1, f"families: {name}: {len(keys)} flash shapes "
              f"match, not 1: {list(tallies[name])}")
        return keys[0], tallies[name][keys[0]], firsts[name][keys[0]]

    specs = (
        ("D 80 (zamba2)", "zamba2-2.7b", lambda k: k[0][3] == 80, (2000,)),
        ("D 112 (kimi-k2)", "kimi-k2-1t-a32b", lambda k: k[0][3] == 112,
         (2000,)),
        ("window 4096 (mixtral)", "mixtral-8x7b",
         lambda k: k[4] == 4096, (6000,)),
        ("non-causal (seamless encoder)", "seamless-m4t-large-v2",
         lambda k: not k[2] and k[0][2] == k[1][2], (2000,)),
        ("cross (seamless decoder)", "seamless-m4t-large-v2",
         lambda k: not k[2] and k[0][2] != k[1][2], (1,)),
    )
    kernel_rows = []
    for label, name, pred, real_len in specs:
        key, n, qkv = pick(name, pred)
        kernel_rows.append(family_flash_row(label, key, qkv, n, real_len))
    del tallies, firsts
    torch.cuda.empty_cache()
    print(f"families: all in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return kernel_rows


# -------------------------------------------------------------------- train
def train_state(cfg, run, seed: int):
    """A fresh train state: the port's own random parameters for ``cfg``
    drawn on the card from ``seed`` (the same seed gives the same
    state)."""
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.train.step import init_state
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_params(zoo.model_specs(cfg), gen, cfg.dtype, device=DEVICE)
    return init_state(cfg, run, params)


def train_batches(cfg):
    """step -> the pipeline's batch of that step on the card
    (``_batch_for_step``, what TokenPipeline yields at that step)."""
    from repro_torch.data.pipeline import DataShard, _batch_for_step
    return lambda s: {k: torch.from_numpy(v).to(DEVICE) for k, v in
                      _batch_for_step(s, DataShard(0, 1), cfg.vocab,
                                      TRAIN_BATCH, TRAIN_SEQ).items()}


def train_reduced_check(seed: int) -> None:
    """One microbatched step of the reduced llama in f32 (selective
    remat) on the card against the CPU port's step from the same
    parameters and batch."""
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).reduced(),
                              dtype="float32", remat="selective")
    run = RunConfig(learning_rate=1e-3, microbatches=2)
    cell = ShapeCell("t", 64, 4, "train")
    out = {}
    for dev in ("cpu", DEVICE):
        params = init_params(zoo.model_specs(cfg),
                             torch.Generator().manual_seed(seed), "float32",
                             device="cpu")
        params = optim.tree_map(lambda p: p.to(dev), params)
        batch = zoo.make_batch(cfg, cell, seed, device=dev)
        state, m = build_train_step(cfg, run)(init_state(cfg, run, params),
                                              batch)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [p.detach() for p in optim.tree_leaves(state["params"])])
    (mc, pc), (md, pd) = out["cpu"], out[DEVICE]
    worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(pd, pc))
    check(abs(md["loss"] - mc["loss"]) <= 1e-4 * abs(mc["loss"])
          and abs(md["grad_norm"] - mc["grad_norm"]) <= 1e-3 * mc["grad_norm"]
          and worst <= TRAIN_F32_REL,
          f"train: the reduced f32 step on the card differs from the CPU "
          f"port's: {md} against {mc}, params {worst:.3g}")
    print(f"train: reduced {TRAIN_ARCH} f32 step (remat selective, 2 "
          f"microbatches) on the card equals the CPU port's: loss "
          f"{md['loss']:.6f} / {mc['loss']:.6f}, grad_norm "
          f"{md['grad_norm']:.6f} / {mc['grad_norm']:.6f}, updated params "
          f"within {worst:.3g} of their scale (bar {TRAIN_F32_REL:g})",
          flush=True)


def train_grads_check(cfg, state, batch) -> None:
    """Every parameter leaf's gradient on the first microbatch is finite
    and nonzero (a stacked leaf: each layer's slice), the attention
    projections wq / wk / wv included; the kernel launches twice a
    layer (selective remat relaunches it in the recompute)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.kernels import _cuda
    from repro_torch.models import zoo
    params = state["params"]
    micro = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in batch.items()}
    flat = _flatten(params)                 # {"a/b": leaf}
    leaves = list(flat.values())
    for p in leaves:
        p.requires_grad_(True)
    _cuda.reset_launches()
    loss, _ = zoo.loss_fn(cfg)(params, micro)
    grads = torch.autograd.grad(loss, leaves)
    sync()
    launches = _cuda.LAUNCHES["flash_attention"]
    smallest = []
    for name, g in zip(flat, grads):
        parts = g if name.startswith("layers/") else g[None]
        for i, part in enumerate(parts):
            big = float(part.float().abs().max())
            check(bool(torch.isfinite(part).all()) and big > 0,
                  f"train: the gradient of {name}[{i}] is not finite and "
                  f"nonzero (max |g| {big})")
            smallest.append((big, f"{name}[{i}]" if parts is g else name))
    del grads
    check(launches == 2 * cfg.n_layers,
          f"train: flash_attention launched {launches} times in one "
          f"microbatch's forward and backward, not 2 x {cfg.n_layers}")
    smallest.sort()
    qkv_min = {w: min(v for v, n in smallest if n.startswith(f"layers/attn/{w}"))
               for w in ("wq", "wk", "wv")}
    print(f"train: every parameter's gradient on microbatch 0 is finite "
          f"and nonzero ({len(smallest)} leaves and layer slices; smallest "
          f"max |g|: " + ", ".join(f"{n} {v:.3g}" for v, n in smallest[:4])
          + "; the smallest layer's max |g| of " + ", ".join(
              f"{w} {v:.3g}" for w, v in qkv_min.items())
          + f"); loss {float(loss):.4f}; flash_attention launched "
          f"{launches} times (2 x {cfg.n_layers} layers)", flush=True)


def train_flash_grads(cfg, qkv) -> None:
    """The differentiable flash_attention at one full-width layer's
    shape, on the operands the training gave the kernel: its q / k / v
    gradients against autograd through plain_attention on the card."""
    import functools
    from repro_torch.models import layers, transformer
    q, k, v = (t.transpose(1, 2).detach().clone().requires_grad_(True)
               for t in qkv)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    go = torch.randn(q.shape, generator=g, device=DEVICE).to(q.dtype)
    plain = functools.partial(transformer.plain_attention, cfg=cfg)
    got = torch.autograd.grad(layers.flash_attention(q, k, v, plain),
                              (q, k, v), go)
    want = torch.autograd.grad(plain(q, k, v), (q, k, v), go)
    errs = []
    for name, a, b in zip("qkv", got, want):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        errs.append(f"d{name} max |diff| {err:.4g} of {scale:.4g} "
                    f"({'bit-equal' if torch.equal(a, b) else 'differs'})")
        check(scale > 0 and err <= TRAIN_GRAD_REL * scale,
              f"train: the flash Function's d{name} differs from autograd "
              f"through plain_attention: {err} > {TRAIN_GRAD_REL} x {scale}")
    print(f"train: the differentiable flash_attention at {tuple(qkv[0].shape)} "
          f"x {tuple(qkv[1].shape)} bf16 causal (one full-width layer, the "
          f"training's own operands): q/k/v gradients against autograd "
          f"through plain_attention (chunked at {cfg.attn_chunk}): "
          + "; ".join(errs) + f" (bar {TRAIN_GRAD_REL:g} of the scale)",
          flush=True)


def train_row(qkv, launches: int, per_step: int) -> dict:
    """Row 5-train: the flash kernel at the training shape, on the first
    operands training gave it, held to its plain version and the f64
    answer (check_flash_bf16's strict bar), timed beside SDPA and
    flash_work's bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = qkv
    b, hq, s, d = q.shape
    hk = k.shape[1]
    err, readings = check_flash_bf16(
        fa.flash_attention(q, k, v, causal=True, kv_len=s), q, k, v, s,
        "train: flash_attention at the training shape")
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    live, flops, nbytes = flash_work(b, hq, hk, d, s, s, True, None)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    print(f"train: flash_attention at ({b}, {hq}, {s}, {d}) x ({b}, {hk}, "
          f"{s}, {d}) bf16 causal: {per_step} launches a step, {launches} "
          f"in (a); against flash_attention_ref and the f64 answer: "
          f"{readings}", flush=True)
    return kernel_row(
        "flash_attention train", launches, err,
        lambda: fa.flash_attention(q, k, v, causal=True, kv_len=s), 10,
        lambda: flash_attention_ref(q, k, v, causal=True, kv_len=s), 2,
        nbytes, flops, library=sdpa, flop_per_s=hw.PEAK_FLOPS_BF16,
        kernel="flash_attention",
        note=f"{per_step} launches a step (2 x {TRAIN_LAYERS} layers x "
             f"{TRAIN_MICRO} microbatches: selective remat relaunches it)")


def phase_train(seed: int, before_fault=None) -> dict:
    """The twin of examples/train_lm.py at llama3-8b's full width in
    bf16 (depth cut): (a) TRAIN_STEPS AdamW steps on the pipeline's
    batches, (b) run_training with an injected failure (after
    ``before_fault()``, where given: work that runs beside (b)'s
    checkpoint IO), (c) Adafactor and 8-bit Adam.  Returns the 5-train
    kernel row."""
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _cuda
    from repro_torch.models import zoo
    from repro_torch.models.params import count_params
    from repro_torch.runtime.fault import FaultConfig, run_training
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step
    t_phase = time.perf_counter()
    train_reduced_check(seed)
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    n = count_params(zoo.model_specs(cfg))
    print(f"train: CUT: {TRAIN_ARCH} runs {TRAIN_LAYERS} of {full.n_layers} "
          f"layers at full width (d_model {cfg.d_model}, {cfg.n_q_heads} q / "
          f"{cfg.n_kv_heads} kv heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}), {cfg.dtype}: {n:,} parameters, {2 * n:,} bytes; "
          f"AdamW at 16 B a parameter (bf16 weights and gradients, f32 "
          f"moments and gradient accumulator) {16 * n:,} bytes", flush=True)
    print(f"train: CUT: train_4k's seq {TRAIN_SEQ} at a global batch of "
          f"{TRAIN_BATCH}, not 256, in {TRAIN_MICRO} microbatches; remat "
          f"{cfg.remat}, attention {cfg.attn_impl} past {cfg.attn_chunk} in "
          f"the backward pass", flush=True)
    cell = ShapeCell("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    run = RunConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                    microbatches=TRAIN_MICRO)
    step = build_train_step(cfg, run, total_steps=FAULT_STEPS)
    batches = train_batches(cfg)

    # (a) the pipeline's batches, counted and timed
    t0 = time.perf_counter()
    state = train_state(cfg, run, seed)
    sync()
    print(f"train: (a) parameters and AdamW state on the card in "
          f"{time.perf_counter() - t0:.2f} s; memory_allocated "
          f"{torch.cuda.memory_allocated()}", flush=True)
    pipe = TokenPipeline(cfg, cell, device=DEVICE)
    try:
        batch = next(pipe)
        train_grads_check(cfg, state, batch)
        (tally, first), spying = family_flash_spy()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        losses, times = [], []
        with spying:
            for s in range(TRAIN_STEPS):
                if s:
                    batch = next(pipe)
                sync()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
        counts = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        wall_ms, busy_ms, top = device_busy(
            lambda: step(state, next(pipe)), n_top=8)
    finally:
        pipe.close()
    per_step = 2 * TRAIN_LAYERS * TRAIN_MICRO
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train: (a) the loss does not fall: {losses}")
    check(counts["flash_attention"] == TRAIN_STEPS * per_step
          and sum(counts.values()) == counts["flash_attention"],
          f"train: (a) launches {counts}: flash_attention must launch "
          f"{per_step} times a step (2 x {TRAIN_LAYERS} layers x "
          f"{TRAIN_MICRO} microbatches) and nothing else")
    check(len(tally) == 1, f"train: (a) flash shapes {list(tally)}")
    key = next(iter(tally))
    med = float(np.median(times))
    print(f"train: (a) {TRAIN_STEPS} AdamW steps (lr {TRAIN_LR:g}, warmup "
          f"100) losses {[round(x, 4) for x in losses]}; ms a step median "
          f"{med * 1e3:.1f} (min {min(times) * 1e3:.1f}, max "
          f"{max(times) * 1e3:.1f}; step 0 first); "
          f"{TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s; "
          f"max_memory_allocated {peak}; launches {json.dumps(counts)}; "
          f"flash shape {key}", flush=True)
    print(f"train: (a) one more step under torch.profiler: device busy "
          f"{busy_ms:.1f} ms of its {wall_ms:.1f} ms wall "
          f"({100 * busy_ms / wall_ms:.2f}%); top device operations "
          + "; ".join(f"{n} {t:.1f} ms" for n, t in top), flush=True)
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.sharding.logical import LogicalMesh
    rec = analyze_cell(TRAIN_ARCH, "train_4k", False, cfg=cfg, run=run,
                       cell=cell, mesh=LogicalMesh(("data", "model"), (1, 1)))
    mem = rec["mem"]["bytes"]
    print(f"train: (a) the dry-run's memory model at this configuration "
          f"(launch.dryrun.analyze_cell, a mesh of one card, remat "
          f"{rec['run']['remat']}): total {mem['total']:,} B ("
          + ", ".join(f"{k} {v:,}" for k, v in mem.items() if k != "total")
          + f") beside the measured peak {peak:,} B: model / measured "
          f"{mem['total'] / peak:.4f} (a reading, not a check); its "
          f"roofline at the H100's ceilings: {rec['roofline']['bottleneck']}"
          f"-bound, {rec['roofline']['step_time_lower_bound_s'] * 1e3:.1f} "
          f"ms a step at the least", flush=True)
    qkv = first[key]
    train_flash_grads(cfg, qkv)
    row = train_row(qkv, counts["flash_attention"], per_step)
    del state, qkv, first, m
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the fault-tolerant loop: one injected failure, restore, replay
    if before_fault is not None:
        before_fault()
    state = train_state(cfg, run, seed)
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        print(f"train: (b) checkpoints in {d} ({free:,} bytes free)",
              flush=True)
        fc = FaultConfig(ckpt_dir=d, ckpt_every=FAULT_EVERY, keep=1,
                         inject_failures_at=(FAULT_AT,))
        t0 = time.perf_counter()
        state, stats = run_training(step, state, batches, FAULT_STEPS, fc)
        secs = time.perf_counter() - t0
        ck = os.path.join(d, f"step_{FAULT_STEPS:08d}")
        on_disk = dir_bytes(ck) if os.path.isdir(ck) else 0
    replayed = FAULT_AT - FAULT_EVERY
    check(int(state["step"]) == FAULT_STEPS and stats.restarts == 1
          and stats.steps_run == FAULT_STEPS + replayed,
          f"train: (b) step {int(state['step'])}, restarts "
          f"{stats.restarts}, steps run {stats.steps_run}")
    by_step = [(s, x) for s, x in enumerate(stats.losses[:FAULT_AT])] + \
        [(FAULT_EVERY + i, x) for i, x in enumerate(stats.losses[FAULT_AT:])]
    rel = max(abs(x - losses[s]) / abs(losses[s]) for s, x in by_step
              if s < TRAIN_STEPS)
    check(rel <= TRAIN_REPLAY_REL, f"train: (b) the losses part from (a)'s "
          f"uninterrupted run by {rel:.4g} (bar {TRAIN_REPLAY_REL:g})")
    print(f"train: (b) run_training over {FAULT_STEPS} steps, checkpoint "
          f"every {FAULT_EVERY} (keep 1), failure injected at step "
          f"{FAULT_AT}: ended at step {int(state['step'])}, restarts "
          f"{stats.restarts}, steps run {stats.steps_run} (steps "
          f"{list(range(FAULT_EVERY, FAULT_AT))} replayed from the step-"
          f"{FAULT_EVERY} checkpoint) in {secs:.1f} s, of which ~"
          f"{secs - stats.steps_run * med:.1f} s not in steps (the "
          f"checkpoints' IO, the restore; (a)'s median step "
          f"{med * 1e3:.1f} ms); a checkpoint {on_disk:,} bytes on disk; "
          f"losses by step "
          f"{[(s, round(x, 4)) for s, x in by_step]}; steps 0-"
          f"{TRAIN_STEPS - 1}, first pass and replay, within {rel:.4g} of "
          f"(a)'s uninterrupted run (bar {TRAIN_REPLAY_REL:g})", flush=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the other two optimizers
    for opt in ("adafactor", "adamw8bit"):
        run_o = dataclasses.replace(run, optimizer=opt)
        step_o = build_train_step(cfg, run_o, total_steps=FAULT_STEPS)
        torch.cuda.reset_peak_memory_stats()
        state = train_state(cfg, run_o, seed)
        opt_bytes = sum(t.numel() * t.element_size() for t in
                        optim.tree_leaves(state["opt"]))
        first = moments_fingerprint(state["params"])
        drawn = [bool(p.min() != p.max())
                 for p in optim.tree_leaves(state["params"])]
        got, times = [], []
        for s in range(OTHER_STEPS):
            sync()
            t0 = time.perf_counter()
            state, m = step_o(state, batches(s))
            got.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        check(all(np.isfinite(got)), f"train: (c) {opt} losses {got}")
        bad = [i for i, t in enumerate(optim.tree_leaves(
            (state["params"], state["opt"]))) if not bool(
                torch.isfinite(t).all())]
        check(not bad, f"train: (c) {opt}: leaves {bad} of the parameters "
              f"and optimizer state are not finite after the last step")
        moved = [a != b for a, b in zip(first,
                                        moments_fingerprint(state["params"]))]
        still = [i for i, (d, mv) in enumerate(zip(drawn, moved))
                 if d and not mv]
        check(not still, f"train: (c) {opt}: parameter leaves {still}, "
              f"drawn at random, did not move over {OTHER_STEPS} steps")
        print(f"train: (c) {opt}: {OTHER_STEPS} steps, losses "
              f"{[round(x, 4) for x in got]} (the last reads step 1's "
              f"update), every parameter and optimizer-state leaf finite, "
              f"{sum(moved)} of {len(moved)} parameter leaves moved (every "
              f"one drawn at random; a constant leaf, a norm's 1.0, may "
              f"not: the first updates fall under half its bf16 ulp), "
              f"ms a step "
              f"{[round(t * 1e3, 1) for t in times]}; optimizer state "
              f"{opt_bytes:,} bytes; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    print(f"train: all in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row


# ----------------------------------------------------------------------- dp
def moments_fingerprint(tree) -> list:
    """One int64 a leaf: the sum of its elements' bit patterns (equal
    bits give equal sums) -- a comparison of moments or parameters
    without a host copy of them."""
    from repro_torch.train import optim
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [int(t.detach().contiguous().view(bits[t.element_size()])
                .to(torch.int64).sum()) for t in optim.tree_leaves(tree)]


def dp_group_of_one(seed: int, before_profile) -> None:
    """(a) at one card: train:'s full-width step in a NCCL group of one
    process (the data-parallel path, its collectives over one rank)
    bit-equal to the plain step from the same state and batch; then
    ``before_profile()`` (which ends every other process on the card)
    and one more step under torch.profiler."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import process_group
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    run = RunConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                    microbatches=TRAIN_MICRO)
    batch = train_batches(cfg)(1)
    t0 = time.perf_counter()
    state = train_state(cfg, run, seed)
    state["step"].fill_(1)                    # lr 1e-4: the update shows
    state, m = build_train_step(cfg, run, total_steps=FAULT_STEPS)(state,
                                                                   batch)
    want_m = {k: float(v) for k, v in m.items()}
    want_p = [p.detach().cpu() for p in optim.tree_leaves(state["params"])]
    want_o = moments_fingerprint(state["opt"])
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d, \
            process_group("nccl", 1, 0, os.path.join(d, "rendezvous"),
                          device=DEVICE + ":0"):
        mesh = make_host_mesh()
        state = train_state(cfg, run, seed)
        state["step"].fill_(1)
        step = build_train_step(cfg, run, total_steps=FAULT_STEPS, mesh=mesh)
        _cuda.reset_launches()
        state, m = step(state, batch)
        sync()
        launches = dict(_cuda.LAUNCHES)
        got_m = {k: float(v) for k, v in m.items()}
        same_p = all(torch.equal(a.detach().cpu(), b) for a, b in
                     zip(optim.tree_leaves(state["params"]), want_p))
        same_o = moments_fingerprint(state["opt"]) == want_o
        before_profile()
        wall, busy, top = device_busy(lambda: step(state, batch), n_top=None)
        del state, m
    gc.collect()
    torch.cuda.empty_cache()
    per_step = 2 * TRAIN_LAYERS * TRAIN_MICRO
    check(launches.get("flash_attention", 0) == per_step,
          f"dp: (a) flash_attention launched {launches} in the group's "
          f"step, not {per_step}")
    check(got_m == want_m and same_p and same_o,
          f"dp: (a) the NCCL group of one's step differs from the plain "
          f"step: metrics {got_m} / {want_m}, params equal {same_p}, "
          f"moments equal {same_o}")
    print(f"dp: (a) a NCCL group of one process (file:// rendezvous, "
          f"make_host_mesh over its ranks) on {TRAIN_ARCH} at full width, "
          f"{TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{TRAIN_MICRO} microbatches, AdamW: the data-parallel step (batch "
          f"gathered, loss sums and one f32 accumulator all-reduce over the "
          f"group) bit-equal to the plain step: loss {got_m['loss']!r}, "
          f"grad_norm {got_m['grad_norm']!r}, every parameter and AdamW "
          f"moment equal; flash_attention {launches['flash_attention']} "
          f"launches (2 x {TRAIN_LAYERS} layers x {TRAIN_MICRO} "
          f"microbatches); {time.perf_counter() - t0:.1f} s", flush=True)
    flash = sum(t for n, t in top if "flash" in n.lower())
    nccl = nccl_ms(top)
    print(f"dp: (a) one more step of the group under torch.profiler: "
          f"device kernel time {busy:.1f} ms of {wall:.1f} ms wall "
          f"({100 * busy / wall:.2f}%), NCCL kernels {nccl:.3f} ms; "
          f"flash_attention at ({TRAIN_BATCH // TRAIN_MICRO}, "
          f"{cfg.n_q_heads}, {TRAIN_SEQ}, {cfg.hd}) {flash:.3f} ms over its "
          f"{per_step} launches, {flash / per_step:.4f} ms a launch (row "
          f"5-train's shape)", flush=True)


DP_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "broadcast")
DP_NEEDS = {"plain": ("all_reduce", "all_gather_into_tensor"),
            "zero1": ("all_reduce", "all_gather_into_tensor",
                      "reduce_scatter_tensor")}


def dp_reduced_cfg():
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(TRAIN_ARCH).reduced(),
                               dtype="float32", remat="selective")


def dp_gloo_rank(rank, device, params, batch, modes):
    """(b)'s rank body: gloo's collectives probed on CUDA tensors, then
    DP_STEPS steps of each mode whose collectives gloo has."""
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataShard, shard_rows
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    missing = {}
    for name in DP_COLLECTIVES:
        x = torch.ones(4, device=device)
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
            elif name == "broadcast":
                dist.broadcast(x, 0)
            elif name == "all_gather_into_tensor":
                dist.all_gather_into_tensor(torch.empty(8, device=device), x)
            else:
                dist.reduce_scatter_tensor(torch.empty(2, device=device), x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            missing[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    cfg = dp_reduced_cfg()
    mesh = make_host_mesh(device=device)
    local = {k: v.to(device) for k, v in
             shard_rows(batch, DataShard(rank, 2)).items()}
    out = {"missing": missing}
    for mode in modes:
        if any(n in missing for n in DP_NEEDS[mode]):
            continue
        run = RunConfig(learning_rate=1e-3, microbatches=2,
                        zero1=mode == "zero1")
        state = init_state(cfg, run, params_from_reference(params,
                                                           device=device),
                           mesh=mesh)
        step = build_train_step(cfg, run, mesh=mesh)
        _cuda.reset_launches()
        ms = []
        for _ in range(DP_GLOO_STEPS):
            state, m = step(state, local)
            ms.append({k: float(v) for k, v in m.items()})
        out[mode] = (ms, [p.detach().cpu() for p in
                          optim.tree_leaves(state["params"])],
                     dict(_cuda.LAUNCHES))
    return out


def dp_reduced_inputs(seed: int, scale: float):
    """(b)'s parameters (every matrix x ``scale``) and batch, on the
    host."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.train import optim
    cfg = dp_reduced_cfg()
    params = optim.tree_map(
        lambda p: p * scale if p.dim() >= 2 else p,
        init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(seed),
                    "float32", device="cpu"))
    batch = zoo.make_batch(cfg, ShapeCell("t", 64, 4, "train"), seed,
                           device="cpu")
    batch["labels"][0, :40] = -1          # the ranks' label counts differ
    return params, batch


def gloo_start(rank_body, args: tuple, tag: str, world: int = 2):
    """``world`` gloo ranks on the card (NCCL refuses two ranks on one
    device) running ``rank_body`` in a thread of this process, so their
    start-up overlaps the caller's work on the card; ``gloo_join`` ends
    them.  ``tag`` names them in a failure; the last item is when they
    started."""
    from repro_torch.launch.ranks import run_ranks
    out = {}

    def work():
        try:
            out["got"] = run_ranks(rank_body, world, args, backend="gloo",
                                   devices=[DEVICE + ":0"] * world,
                                   timeout_s=600)
        except BaseException as e:      # re-raised by gloo_join
            out["error"] = e
    thread = threading.Thread(target=work, name=f"{tag} gloo", daemon=True)
    thread.start()
    return thread, out, tag, time.perf_counter()


def gloo_join(pending) -> dict:
    """Wait for ``gloo_start``'s ranks to end (and their processes with
    them); returns what they returned, re-raising what they raised."""
    thread, out, tag, _ = pending
    thread.join(timeout=660)
    check(not thread.is_alive(), f"{tag} the gloo ranks did not end")
    if "error" in out:
        raise out["error"]
    return out["got"]


def dp_gloo_start(seed: int):
    """(b) at one card, started: its gloo ranks overlap (a); (a)'s
    profiled step joins them."""
    from repro_torch.train import optim
    params, batch = dp_reduced_inputs(seed, DP_GLOO_SCALE)
    host = optim.tree_map(lambda p: p.numpy().copy(), params)
    return gloo_start(dp_gloo_rank, (host, batch, ("plain", "zero1")),
                      "dp: (b)")


def dp_gloo_finish(seed: int, pending) -> None:
    """(b), finished: plain DP and ZeRO-1 on the two gloo ranks held to
    the one-process step on the card at DP_GLOO_REL, beside a reading
    of the f32 conditioning (the one-process step on the card against
    the same step on the CPU, at the fan_in weights and at
    DP_GLOO_SCALE)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    t0 = pending[-1]
    cfg = dp_reduced_cfg()
    run = RunConfig(learning_rate=1e-3, microbatches=2)
    step = build_train_step(cfg, run)
    one, spread = {}, {}
    for scale in (1.0, DP_GLOO_SCALE):
        params, batch = dp_reduced_inputs(seed, scale)
        for dev in (DEVICE, "cpu"):
            state = init_state(cfg, run, optim.tree_map(
                lambda p: p.to(dev, copy=True), params))
            ms = []
            for _ in range(DP_GLOO_STEPS):
                state, m = step(state, {k: v.to(dev)
                                        for k, v in batch.items()})
                ms.append({k: float(v) for k, v in m.items()})
            one[scale, dev] = (ms, [p.detach().cpu() for p in
                                    optim.tree_leaves(state["params"])])
            del state
        card, cpu = one[scale, DEVICE][0][0], one[scale, "cpu"][0][0]
        spread[scale] = (card["grad_norm"], abs(
            card["grad_norm"] - cpu["grad_norm"]) / card["grad_norm"])
    want, want_p = one[DP_GLOO_SCALE, DEVICE]
    print(f"dp: (b) the one-process step at the reduced {TRAIN_ARCH}: grad "
          f"norm on the card, and its distance from the same step on the "
          f"CPU (a reading of the f32 conditioning, not a check): "
          + "; ".join(f"matrices x {sc}: {g:.4f}, {d:.3g}"
                      for sc, (g, d) in spread.items()), flush=True)
    got = gloo_join(pending)
    missing = got[0]["missing"]
    if missing:
        print("dp: CUT: (b) gloo lacks on CUDA tensors: " + "; ".join(
            f"{n} ({why})" for n, why in missing.items()), flush=True)
    ran = [mode for mode in ("plain", "zero1") if mode in got[0]]
    for mode in ("plain", "zero1"):
        if mode not in ran:
            print(f"dp: CUT: (b) {mode} not run on two gloo ranks on the "
                  f"card: it needs "
                  f"{', '.join(n for n in DP_NEEDS[mode] if n in missing)}",
                  flush=True)
    for mode in ran:
        worst_m = worst_p = 0.0
        for r in got:
            ms, ps, launches = r[mode]
            check(launches.get("flash_attention", 0) > 0,
                  f"dp: (b) {mode}: no flash_attention launch on a rank "
                  f"({launches})")
            for g, w in zip(ms, want):
                worst_m = max([worst_m] + [abs(g[k] - w[k]) / max(abs(w[k]),
                                                                  1e-30)
                                           for k in w])
            worst_p = max([worst_p] + [
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(ps, want_p)])
        check(worst_m <= DP_GLOO_REL and worst_p <= DP_GLOO_REL,
              f"dp: (b) {mode} on two gloo ranks differs from the "
              f"one-process step: metrics {worst_m:.3g}, params "
              f"{worst_p:.3g} (bar {DP_GLOO_REL:g})")
        print(f"dp: (b) {mode} on two gloo ranks on the card (reduced "
              f"{TRAIN_ARCH}, f32, matrices x {DP_GLOO_SCALE}, 4 x 64 tokens "
              f"in 2 microbatches, labels "
              f"masked unevenly, {DP_GLOO_STEPS} steps): metrics within "
              f"{worst_m:.3g} and parameters within {worst_p:.3g} of their "
              f"scale of the one-process step on the card (bar "
              f"{DP_GLOO_REL:g}); flash_attention launches per rank "
              f"{[r[mode][2].get('flash_attention', 0) for r in got]}",
              flush=True)
    print(f"dp: (b) in {time.perf_counter() - t0:.1f} s", flush=True)


def dp_nccl_rank(rank, device, seed, world, cfg, seq):
    """The W-card rank body (``cfg`` at ``seq`` tokens a row): every rank
    first takes the one-card step on the global batch (one row a
    microbatch) and keeps its state on the host, rank 0 also the
    one-card step at the per-card rows; then every rank runs DP_STEPS
    timed steps of plain DP and of ZeRO-1, measures its state's distance
    from the one-card state, and runs one more step under
    torch.profiler."""
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.data.pipeline import DataShard, _batch_for_step
    from repro_torch.kernels import _cuda
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.sharding import collective
    from repro_torch.sharding.logical import LogicalMesh, default_rules
    from repro_torch.train import optim
    from repro_torch.train.step import (abstract_state, build_train_step,
                                        init_state, zero1_grad_shardings)
    rows = TRAIN_MICRO * world                  # one row a microbatch a card
    on_card = device.type == "cuda"

    def draw(s, shard):
        return {k: torch.from_numpy(v).to(device) for k, v in
                _batch_for_step(s, shard, cfg.vocab, rows, seq).items()}

    def wait():
        if on_card:
            torch.cuda.synchronize(device)

    def initial():
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(zoo.model_specs(cfg), gen, cfg.dtype,
                           device=device)

    def fresh(run, mesh=None):
        return init_state(cfg, run, initial(), mesh=mesh)

    def timed(step, state, batches):
        losses, norms, times = [], [], []
        for b in batches:
            wait()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
        return state, losses, norms, times

    def leaves(state):
        return [optim.tree_leaves(state["params"]),
                optim.tree_leaves(state["opt"]["mu"]),
                optim.tree_leaves(state["opt"]["nu"])]

    def distances(state, one):
        """Relative L2 distances of this mode's parameters (over the
        one-card step's own move from the initial parameters), mu and nu
        (over the one-card moments' norm) from the one-card state; a
        ZeRO-1 chunk against its chunk of the one-card leaf, a whole
        leaf counted on rank 0, summed over the ranks."""
        sums = torch.zeros(3, 2, dtype=torch.float64, device=device)
        base = [optim.tree_leaves(initial()), None, None]
        for i, (mine, theirs) in enumerate(zip(leaves(state), one)):
            for j, (a, b) in enumerate(zip(mine, theirs)):
                sh = collective.shard_of(a)
                if sh is None and rank != 0:
                    continue
                b = b.to(device)
                ref = (b if base[i] is None else base[i][j]).to(torch.float32)
                b = b.to(torch.float32)
                if sh is not None:
                    b, ref = sh.of(b), sh.of(ref)
                sums[i, 0] += torch.sum((a.detach().float() - b) ** 2)
                sums[i, 1] += torch.sum((b - ref) ** 2 if base[i] is not None
                                        else b ** 2)
                del b, ref
        del base
        dist.all_reduce(sums)
        return [float(x) for x in torch.sqrt(sums[:, 0] / sums[:, 1])]

    out = {"device": str(device)}
    run = RunConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                    microbatches=TRAIN_MICRO)
    # the one-card step on the global batch, one row a microbatch: each
    # row's bf16 gradient is then rounded as on the ranks, and only the
    # order of the f32 sums differs (on every rank, which keeps its state
    # on the host to hold its own against it)
    glob = [{k: torch.cat([draw(s, DataShard(r, world))[k]
                           for r in range(world)])
             for k in ("tokens", "labels")} for s in range(DP_STEPS)]
    run_one = dataclasses.replace(run, microbatches=rows)
    step = build_train_step(cfg, run_one, total_steps=FAULT_STEPS)
    state, *first = timed(step, fresh(run_one), glob[:DP_EQUAL_STEPS])
    one = [[t.detach().to("cpu", copy=True) for t in part]
           for part in leaves(state)]             # the step updates in place
    state, *rest = timed(step, state, glob[DP_EQUAL_STEPS:])
    out["one_loss"], out["one_norm"], out["one_times"] = (
        a + b for a, b in zip(first, rest))
    del glob, state, step
    gc.collect()
    if rank == 0:
        step = build_train_step(cfg, run, total_steps=FAULT_STEPS)
        per = [draw(s, DataShard(0, world)) for s in range(DP_STEPS)]
        _, _, _, out["per_card_times"] = timed(step, fresh(run), per)
        del step, per
        gc.collect()
    dist.barrier()
    mesh = make_host_mesh(device=device)
    local = [draw(s, DataShard(rank, world)) for s in range(DP_STEPS + 1)]
    desc = LogicalMesh(("data", "model"), (world, 1))
    for mode in ("plain", "zero1"):
        run_m = dataclasses.replace(run, zero1=mode == "zero1")
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        state = fresh(run_m, mesh)
        step = build_train_step(cfg, run_m, total_steps=FAULT_STEPS,
                                mesh=mesh)
        _cuda.reset_launches()
        state, *first = timed(step, state, local[:DP_EQUAL_STEPS])
        dists = distances(state, one)
        state, *rest = timed(step, state, local[DP_EQUAL_STEPS:DP_STEPS])
        losses, norms, times = (a + b for a, b in zip(first, rest))
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        opt_bytes = sum(t.numel() * t.element_size()
                        for t in optim.tree_leaves(state["opt"]))
        acc_bytes = step.held["grad_acc_bytes"]
        wall, busy, top = device_busy(
            lambda: step(state, local[DP_STEPS]), n_top=None) if on_card \
            else (1.0, 0.0, [])                 # no device time to read
        nccl = nccl_ms(top)
        flash = sum(t for n, t in top if "flash" in n.lower())
        specs = zoo.model_specs(cfg)
        ab = abstract_state(cfg, run_m, specs, desc, default_rules())
        want_opt = sum(int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
                       * t.element_size() for t in
                       optim.tree_leaves(ab["opt"]))
        shardings = optim.tree_leaves(zero1_grad_shardings(cfg, run_m, desc))
        want_acc = sum(int(np.prod(s.shard_shape(tuple(p.shape)))) * 4
                       if mode == "zero1" else p.numel() * 4
                       for p, s in zip(optim.tree_leaves(ab["params"]),
                                       shardings))
        rec = analyze_cell(cfg.name, "train_4k", False, cfg=cfg, run=run_m,
                           cell=ShapeCell("train_4k", seq, rows, "train"),
                           mesh=desc)
        out[mode] = dict(loss=losses, norm=norms, times=times, dists=dists,
                         launches=launches, peak=peak, opt_bytes=opt_bytes,
                         acc_bytes=acc_bytes, want_opt=want_opt,
                         want_acc=want_acc, wall_ms=wall, busy_ms=busy,
                         nccl_ms=nccl, flash_ms=flash,
                         model_bytes=rec["mem"]["bytes"]["total"],
                         top=[(n, round(t, 3)) for n, t in top[:6]])
        del state, step
        gc.collect()
    return out


def dp_over_cards(seed: int, world: int) -> None:
    """At count >= 2: W NCCL ranks, one card each, at train:'s full
    width and depth, plain DP and ZeRO-1 against the one-card step on
    the same global batch."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.ranks import run_ranks
    t0 = time.perf_counter()
    rows = TRAIN_MICRO * world
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    got = run_ranks(dp_nccl_rank, world, (seed, world, cfg, TRAIN_SEQ),
                    timeout_s=900)
    one = got[0]
    tokens = rows * TRAIN_SEQ
    one_rate = TRAIN_MICRO * TRAIN_SEQ / float(np.median(
        one["per_card_times"]))
    print(f"dp: {world} NCCL ranks, one card each; {TRAIN_ARCH} at full "
          f"width, {TRAIN_LAYERS} layers, a global batch of {rows} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches ({TRAIN_MICRO} "
          f"rows a card); the one-card step on that batch in {rows} "
          f"microbatches of one row (each row's bf16 gradient rounded as on "
          f"the ranks): losses {one['one_loss']}, grad norms "
          f"{one['one_norm']}, ms a step "
          f"{[round(t * 1e3, 1) for t in one['one_times']]}; at "
          f"{TRAIN_MICRO} rows on one card: ms a step "
          f"{[round(t * 1e3, 1) for t in one['per_card_times']]}, "
          f"{one_rate:.1f} tokens/s", flush=True)
    per_step = 2 * TRAIN_LAYERS * TRAIN_MICRO
    for mode in ("plain", "zero1"):
        rel_l = rel_g = rel_late = 0.0
        for r, res in enumerate(got):
            m = res[mode]
            check(m["launches"].get("flash_attention", 0)
                  == DP_STEPS * per_step,
                  f"dp: {mode} rank {r}: launches {m['launches']}, not "
                  f"{DP_STEPS} x {per_step} flash_attention")
            rel_l = max([rel_l] + [abs(a - b) / abs(b) for a, b in
                                   zip(m["loss"], res["one_loss"])])
            norm_rel = [abs(a - b) / abs(b) for a, b in
                        zip(m["norm"], res["one_norm"])]
            rel_g = max([rel_g] + norm_rel[:DP_EQUAL_STEPS])
            rel_late = max([rel_late] + norm_rel[DP_EQUAL_STEPS:])
            check(rel_l <= TRAIN_REPLAY_REL and rel_g <= TRAIN_GRAD_REL
                  and rel_late <= DP_LATE_NORM_REL,
                  f"dp: {mode} rank {r}: losses {m['loss']} / grad norms "
                  f"{m['norm']} part from the one-card step's by "
                  f"{rel_l:.3g} / {rel_g:.3g} (the first {DP_EQUAL_STEPS} "
                  f"steps), {rel_late:.3g} (later) (bars "
                  f"{TRAIN_REPLAY_REL:g}, {TRAIN_GRAD_REL:g}, "
                  f"{DP_LATE_NORM_REL:g})")
            check(max(m["dists"]) <= DP_STATE_REL,
                  f"dp: {mode} rank {r}: parameters / mu / nu after "
                  f"{DP_EQUAL_STEPS} steps part from the one-card step's by "
                  f"{m['dists']} (bar {DP_STATE_REL:g})")
            check(m["opt_bytes"] == m["want_opt"]
                  and m["acc_bytes"] == m["want_acc"],
                  f"dp: {mode} rank {r}: optimizer state {m['opt_bytes']} "
                  f"B and accumulators {m['acc_bytes']} B, not the "
                  f"described {m['want_opt']} and {m['want_acc']}")
        print(f"dp: {mode}: after {DP_EQUAL_STEPS} steps (Adam's first "
              f"update) the state's L2 distance from the one-card step's: "
              f"parameters (over the one-card step's move from the initial "
              f"ones), mu, nu (over their norm) "
              f"{[r[mode]['dists'] for r in got]} by rank (bar "
              f"{DP_STATE_REL:g}); losses by step {got[0][mode]['loss']}, "
              f"grad norms {got[0][mode]['norm']}: within {rel_l:.3g}, "
              f"{rel_g:.3g} (the first {DP_EQUAL_STEPS} steps) and "
              f"{rel_late:.3g} (later) of the one-card step's", flush=True)
        med = float(np.median(got[0][mode]["times"]))
        rate = tokens / med
        print(f"dp: {mode}: ms a step "
              f"{[[round(t * 1e3, 1) for t in res[mode]['times']] for res in got]}"
              f" (per rank; median {med * 1e3:.1f} on rank 0), "
              f"{rate:.1f} tokens/s, {rate / (world * one_rate):.4f} of "
              f"{world} x the one-card rate at {TRAIN_MICRO} rows; "
              f"flash_attention "
              f"{[res[mode]['launches'].get('flash_attention', 0) for res in got]}"
              f" launches per rank ({DP_STEPS} steps x 2 x {TRAIN_LAYERS} "
              f"layers x {TRAIN_MICRO} microbatches)", flush=True)
        for r, res in enumerate(got):
            m = res[mode]
            print(f"dp: {mode} rank {r} ({res['device']}): one step under "
                  f"torch.profiler: NCCL kernels {m['nccl_ms']:.3f} ms, "
                  f"flash_attention {m['flash_ms'] / per_step:.4f} ms a "
                  f"launch at (1, {cfg.n_q_heads}, {TRAIN_SEQ}, {cfg.hd}); "
                  f"device kernel time {m['busy_ms']:.1f} of "
                  f"{m['wall_ms']:.1f} ms wall "
                  f"({100 * m['busy_ms'] / m['wall_ms']:.2f}%: summed over "
                  f"streams, so NCCL's overlap with compute can pass 100%); "
                  f"peak "
                  f"{m['peak']:,} B beside the dry-run's memory model "
                  f"{m['model_bytes']:,} B (a ({world}, 1) mesh); optimizer "
                  f"state {m['opt_bytes']:,} B and f32 accumulators "
                  f"{m['acc_bytes']:,} B, as abstract_state and the "
                  f"gradient shardings describe; top {m['top']}",
                  flush=True)
    print(f"dp: over {world} cards in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_dp(seed: int, count: int, pending=None, running=()) -> None:
    """The training step data-parallel over processes (one NCCL rank a
    card): over every card where there are several; at one card a NCCL
    group of one and two gloo ranks on the card (``pending``: (b)'s
    ranks where the caller started them, else started here).
    ``running``: other ``gloo_start`` ranks on the card that (a)'s
    profiled step waits for too, so it runs alone on the card."""
    t_phase = time.perf_counter()
    if count >= 2:
        dp_over_cards(seed, count)
    else:
        print("dp: CUT: one card: NCCL takes one card a rank, so the "
              "phase runs (a) a NCCL group of one and (b) two gloo ranks "
              "on the card, not W ranks over W cards", flush=True)
        pending = pending or dp_gloo_start(seed)
        dp_group_of_one(seed, lambda: [gloo_join(p) for p in
                                       (pending, *running)])
        dp_gloo_finish(seed, pending)
    print(f"dp: all in {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------- fsdp
def fsdp_cfg(world: int, kimi: bool, layers: int):
    """(a)'s internlm2-20b or (b)'s kimi-k2 at full width in bf16, cut
    to ``layers`` layers (kimi also to KIMI_EXPERTS experts, its MoE
    dispatch one group a rank), remat "full" (their run configs')."""
    from repro_torch.configs.registry import get_arch
    if not kimi:
        return dataclasses.replace(get_arch(FSDP_ARCH), n_layers=layers,
                                   remat="full")
    cfg = get_arch(KIMI_ARCH)
    return dataclasses.replace(
        cfg, n_layers=layers, remat="full", moe_dispatch_groups=world,
        moe=dataclasses.replace(cfg.moe, n_experts=KIMI_EXPERTS))


def fsdp_params(cfg, seed: int, device, lazy: bool):
    """``cfg``'s parameters drawn on ``device`` from ``seed``: the whole
    tree, or with ``lazy`` the same tree as callables that each draw
    their leaf (``train.step.shard_params`` cuts each as it is drawn, so
    a rank holds one whole leaf beside its chunks); the same values
    either way (one generator, the specs' order)."""
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = zoo.model_specs(cfg)
    if not lazy:
        return init_params(specs, gen, cfg.dtype, device=device)

    def lazy_tree(tree):
        if isinstance(tree, dict):
            return {k: lazy_tree(v) for k, v in tree.items()}
        return lambda: init_params({"x": tree}, gen, cfg.dtype,
                                   device=device)["x"]
    return lazy_tree(specs)


def shard_bytes(tree) -> int:
    """The bytes one device holds of a tree of ``abstract_state``'s
    ``meta`` tensors (each by its sharding description)."""
    from repro_torch.train import optim
    return sum(int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
               * t.element_size() if t.dim() else t.element_size()
               for t in optim.tree_leaves(tree))


def state_parts(state) -> tuple:
    """(names, leaf lists) of a train state: the parameters, then each
    optimizer-state tree (AdamW's mu and nu, Adafactor's v)."""
    from repro_torch.train import optim
    names = ["params"] + [k for k in sorted(state["opt"]) if k != "count"]
    return names, [optim.tree_leaves(state["params"] if k == "params"
                                     else state["opt"][k]) for k in names]


def fsdp_state_versus(state, kept, initial) -> dict:
    """ZeRO-1's ``state`` on this rank against FSDP's (``kept``: each
    part's (host copy, Shard or None) pairs): bit-equal or not, each
    part's largest |difference|, and its L2 distance summed over the
    ranks as dp: measures it (the parameters over ZeRO-1's move from
    ``initial``, the optimizer state over its norm; a chunk on every
    rank, a whole leaf on rank 0)."""
    import torch.distributed as dist
    _, mine = state_parts(state)
    dev = mine[0][0].device
    sums = torch.zeros(len(mine), 2, dtype=torch.float64, device=dev)
    equal, worst = True, [0.0] * len(mine)
    rank = dist.get_rank()
    for i, (zs, fs) in enumerate(zip(mine, kept)):
        for j, (z, (f, sh)) in enumerate(zip(zs, fs)):
            z, f = z.detach(), f.to(dev)
            base = initial[j] if i == 0 else None
            if i == 0 and sh is not None:
                z, base = sh.of(z), sh.of(base)   # ZeRO-1's whole leaf
            if not torch.equal(z, f):
                equal = False
                worst[i] = max(worst[i], float((z.float() - f.float())
                                               .abs().max()))
            if sh is None and rank != 0:
                continue
            z = z.float()
            sums[i, 0] += torch.sum((f.float() - z) ** 2)
            sums[i, 1] += torch.sum((z - base.float()) ** 2 if i == 0
                                    else z ** 2)
    dist.all_reduce(sums)
    return {"equal": equal, "worst": worst,
            "dists": [float(x) for x in torch.sqrt(sums[:, 0] /
                                                   sums[:, 1])]}


def fsdp_nccl_job(rank, device, seed, world, kimi, layers, optimizer,
                  micro, steps, seq):
    """One configuration on the W ranks: ``steps`` timed steps of FSDP,
    then of ZeRO-1, from the same initial parameters on the same batches
    (one more step of each under torch.profiler); FSDP's state is kept
    on the host and held to ZeRO-1's after; rank 0 keeps FSDP's first
    flash operands for the kernel row."""
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.data.pipeline import DataShard, _batch_for_step
    from repro_torch.kernels import _cuda
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.sharding import collective
    from repro_torch.sharding.logical import LogicalMesh, default_rules
    from repro_torch.train import optim
    from repro_torch.train.step import (abstract_state, build_train_step,
                                        init_state, zero1_grad_shardings)
    cfg = fsdp_cfg(world, kimi, layers)
    rows = micro * world                       # one row a microbatch a card
    mesh = make_host_mesh(device=device)
    desc = LogicalMesh(("data", "model"), (world, 1))
    local = [{k: torch.from_numpy(v).to(device) for k, v in _batch_for_step(
        s, DataShard(rank, world), cfg.vocab, rows, seq).items()}
        for s in range(steps + 1)]
    out, kept, qkv = {"config": cfg.name}, None, None
    for mode in ("fsdp", "zero1"):
        run = RunConfig(optimizer=optimizer, learning_rate=TRAIN_LR,
                        microbatches=micro, fsdp=mode == "fsdp",
                        zero1=mode == "zero1")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state = init_state(cfg, run, fsdp_params(cfg, seed, device,
                                                 lazy=mode == "fsdp"),
                           mesh=mesh)
        torch.cuda.synchronize(device)
        init_s = time.perf_counter() - t0
        step = build_train_step(cfg, run, total_steps=FAULT_STEPS, mesh=mesh)
        (_, first), spying = family_flash_spy()
        _cuda.reset_launches()
        losses, norms, times = [], [], []
        with spying if rank == 0 and mode == "fsdp" and not kimi \
                else contextlib.nullcontext():
            for s in range(steps):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                state, m = step(state, local[s])
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                times.append(time.perf_counter() - t0)
        launches = dict(_cuda.LAUNCHES)
        if first:
            qkv = tuple(t.detach().cpu() for t in next(iter(first.values())))
        got = {}
        wall, busy, top = device_busy(
            lambda: got.setdefault("m", step(state, local[steps])),
            n_top=None)
        losses.append(float(got["m"][1]["loss"]))
        norms.append(float(got["m"][1]["grad_norm"]))
        peak = torch.cuda.max_memory_allocated(device)
        ab = abstract_state(cfg, run, zoo.model_specs(cfg), desc,
                            default_rules(fsdp=run.fsdp))
        want_acc = sum(int(np.prod(s.shard_shape(tuple(p.shape)))) * 4
                       for p, s in zip(optim.tree_leaves(ab["params"]),
                                       optim.tree_leaves(zero1_grad_shardings(
                                           cfg, run, desc))))
        rec = analyze_cell(cfg.name, "train_4k", False, cfg=cfg, run=run,
                           cell=ShapeCell("train_4k", seq, rows, "train"),
                           mesh=desc)
        out[mode] = dict(
            loss=losses, norm=norms, times=times, init_s=init_s,
            launches=launches, peak=peak, wall_ms=wall, busy_ms=busy,
            nccl_ms=nccl_ms(top),
            flash_ms=sum(t for n, t in top if "flash" in n.lower()),
            param_bytes=step.held["param_bytes"],
            opt_bytes=sum(t.numel() * t.element_size()
                          for t in optim.tree_leaves(state["opt"])),
            acc_bytes=step.held["grad_acc_bytes"],
            want=(shard_bytes(ab["params"]), shard_bytes(ab["opt"]),
                  want_acc),
            model_bytes=rec["mem"]["bytes"]["total"],
            top=[(n, round(t, 3)) for n, t in top[:5]])
        if mode == "fsdp":
            out["parts"], leaves = state_parts(state)
            kept = [[(t.detach().to("cpu", copy=True),
                      collective.shard_of(t)) for t in part]
                    for part in leaves]
            del leaves
        else:
            initial = optim.tree_leaves(fsdp_params(cfg, seed, device,
                                                    lazy=False))
            out["versus"] = fsdp_state_versus(state, kept, initial)
            del initial
        del state, step, got
    del kept
    out["qkv"] = qkv
    return out


def fsdp_nccl_rank(rank, device, seed, world, jobs):
    """The W-card rank body: each of ``jobs`` (``fsdp_nccl_job``'s
    arguments after ``world``) in turn."""
    return [fsdp_nccl_job(rank, device, seed, world, *job) for job in jobs]


def fsdp_report(tag, got, world, layers, micro, steps, seq) -> None:
    """(a) / (b)'s checks and lines: FSDP held to ZeRO-1 on the same
    ranks, bit for bit where it is (else at dp:'s bars, the largest
    difference printed), the bytes each rank holds against
    abstract_state's, the flash launches, the times."""
    per_step = 2 * layers * micro
    for r, res in enumerate(got):
        f, z, vs = res["fsdp"], res["zero1"], res["versus"]
        for mode, m in (("fsdp", f), ("zero1", z)):
            check(m["launches"].get("flash_attention", 0) == steps * per_step,
                  f"fsdp: {tag} {mode} rank {r}: launches {m['launches']}, "
                  f"not {steps} x {per_step} flash_attention (2 x {layers} "
                  f"layers x {micro} microbatches, remat full)")
            check((m["param_bytes"], m["opt_bytes"], m["acc_bytes"])
                  == tuple(m["want"]),
                  f"fsdp: {tag} {mode} rank {r}: parameters, optimizer state "
                  f"and accumulators hold {m['param_bytes']}, "
                  f"{m['opt_bytes']}, {m['acc_bytes']} B, not the described "
                  f"{m['want']}")
        check(f["param_bytes"] < z["param_bytes"],
              f"fsdp: {tag} rank {r}: FSDP holds {f['param_bytes']} B of "
              f"parameters, not fewer than ZeRO-1's {z['param_bytes']}")
        rel_l = max(abs(a - b) / abs(b) for a, b in zip(f["loss"], z["loss"]))
        rel = [abs(a - b) / abs(b) for a, b in zip(f["norm"], z["norm"])]
        check(rel_l <= TRAIN_REPLAY_REL
              and max(rel[:DP_EQUAL_STEPS]) <= TRAIN_GRAD_REL
              and max(rel[DP_EQUAL_STEPS:] + [0.0]) <= DP_LATE_NORM_REL
              and max(vs["dists"]) <= DP_STATE_REL,
              f"fsdp: {tag} rank {r}: FSDP against ZeRO-1: losses "
              f"{f['loss']} / {z['loss']}, grad norms {f['norm']} / "
              f"{z['norm']}, state distances {vs['dists']} (bars "
              f"{TRAIN_REPLAY_REL:g}, {TRAIN_GRAD_REL:g} / "
              f"{DP_LATE_NORM_REL:g}, {DP_STATE_REL:g})")
    f0, z0 = got[0]["fsdp"], got[0]["zero1"]
    bits = all(r["versus"]["equal"] and r["fsdp"]["loss"] == r["zero1"]["loss"]
               and r["fsdp"]["norm"] == r["zero1"]["norm"] for r in got)
    print(f"fsdp: {tag} FSDP against ZeRO-1 on the same {world} ranks, "
          f"batches and initial parameters, {steps + 1} steps: "
          + ("bit-equal (every loss, grad norm, parameter chunk and "
             "optimizer-state chunk on every rank)" if bits else
             f"not bit-equal: losses {f0['loss']} / {z0['loss']}, grad norms "
             f"{f0['norm']} / {z0['norm']}; largest |difference| of "
             f"{', '.join(got[0]['parts'])} by rank "
             f"{[r['versus']['worst'] for r in got]}; L2 distances "
             f"{[r['versus']['dists'] for r in got]} (held at dp:'s bars "
             f"{TRAIN_REPLAY_REL:g}, {TRAIN_GRAD_REL:g} / "
             f"{DP_LATE_NORM_REL:g}, {DP_STATE_REL:g})"), flush=True)
    tokens = micro * world * seq
    # the first step pays its warm-up (NCCL's sub-group communicators,
    # cuBLAS handles): the rate is the later steps'
    steady = {mode: float(np.median(got[0][mode]["times"][1:]))
              for mode in ("fsdp", "zero1")}
    print(f"fsdp: {tag} FSDP / ZeRO-1 steady step on rank 0: "
          f"{steady['fsdp'] * 1e3:.1f} / {steady['zero1'] * 1e3:.1f} ms = "
          f"{steady['fsdp'] / steady['zero1']:.4f}", flush=True)
    for mode in ("fsdp", "zero1"):
        m = f0 if mode == "fsdp" else z0
        med = steady[mode]
        print(f"fsdp: {tag} {mode}: losses {m['loss']}, grad norms "
              f"{m['norm']}; ms a step "
              f"{[[round(t * 1e3, 1) for t in r[mode]['times']] for r in got]}"
              f" (per rank, the first with its warm-up; {med * 1e3:.1f} "
              f"after it on rank 0), "
              f"{tokens / med:.1f} tokens/s ({micro * world} x {seq} tokens "
              f"a step); init {m['init_s']:.1f} s; flash_attention "
              f"{[r[mode]['launches'].get('flash_attention', 0) for r in got]}"
              f" launches per rank ({steps} steps x {per_step}); parameters "
              f"{m['param_bytes']:,} B, optimizer state {m['opt_bytes']:,} B, "
              f"f32 accumulators {m['acc_bytes']:,} B a rank (abstract_state's"
              f" and the gradient shardings' shard bytes)", flush=True)
        for r, res in enumerate(got):
            x = res[mode]
            print(f"fsdp: {tag} {mode} rank {r}: one step under "
                  f"torch.profiler: NCCL kernels {x['nccl_ms']:.3f} ms, flash "
                  f"{x['flash_ms'] / per_step:.4f} ms a launch; device kernel "
                  f"time {x['busy_ms']:.1f} of {x['wall_ms']:.1f} ms wall "
                  f"({100 * x['busy_ms'] / x['wall_ms']:.2f}%, summed over "
                  f"streams); peak {x['peak']:,} B beside estimate_memory's "
                  f"{x['model_bytes']:,} B ({mode}, a ({world}, 1) mesh); top "
                  f"{x['top']}", flush=True)


def fsdp_over_cards(seed: int, world: int) -> dict:
    """At count >= 2: (a) internlm2-20b and (b) kimi's FSDP + Adafactor
    pairing over ``world`` NCCL ranks, each held to ZeRO-1 on the same
    ranks; returns the 5-train-i2 row from (a)'s operands."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import zoo
    from repro_torch.models.params import count_params
    t0 = time.perf_counter()
    full = get_arch(FSDP_ARCH)
    cfg = fsdp_cfg(world, False, FSDP_LAYERS)
    n = count_params(zoo.model_specs(cfg))
    print(f"fsdp: CUT: (a) {FSDP_ARCH} runs {FSDP_LAYERS} of {full.n_layers} "
          f"layers at full width (d_model {cfg.d_model}, {cfg.n_q_heads} q / "
          f"{cfg.n_kv_heads} kv heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}), bf16: {n:,} parameters, {2 * n:,} bytes; its run "
          f"config (FSDP, remat full, AdamW, {FSDP_MICRO} microbatches) at "
          f"one row a microbatch a card, a global batch of {FSDP_MICRO} x "
          f"{world} (not 256), train_4k's seq {TRAIN_SEQ}", flush=True)
    kfull = get_arch(KIMI_ARCH)
    kcfg = fsdp_cfg(world, True, KIMI_LAYERS)
    kn = count_params(zoo.model_specs(kcfg))
    print(f"fsdp: CUT: (b) {KIMI_ARCH} runs {KIMI_LAYERS} of "
          f"{kfull.n_layers} layers and {KIMI_EXPERTS} of "
          f"{kfull.moe.n_experts} experts at full width (the families' cut; "
          f"d_model {kcfg.d_model}, hd {kcfg.hd}, vocab {kcfg.vocab}): "
          f"{kn:,} parameters, {2 * kn:,} bytes; FSDP + Adafactor, remat "
          f"full, {KIMI_MICRO} microbatches of one row a card (not 16), seq "
          f"{TRAIN_SEQ}", flush=True)
    jobs = [(False, FSDP_LAYERS, "adamw", FSDP_MICRO, FSDP_STEPS, TRAIN_SEQ),
            (True, KIMI_LAYERS, "adafactor", KIMI_MICRO, FSDP_STEPS,
             TRAIN_SEQ)]
    got = run_ranks(fsdp_nccl_rank, world, (seed, world, jobs),
                    timeout_s=1500)
    fsdp_report("(a)", [r[0] for r in got], world, FSDP_LAYERS, FSDP_MICRO,
                FSDP_STEPS, TRAIN_SEQ)
    fsdp_report("(b)", [r[1] for r in got], world, KIMI_LAYERS, KIMI_MICRO,
                FSDP_STEPS, TRAIN_SEQ)
    print(f"fsdp: over {world} cards in {time.perf_counter() - t0:.1f} s",
          flush=True)
    a = [r[0] for r in got]
    qkv = tuple(t.to(DEVICE) for t in a[0]["qkv"])
    launches = a[0]["fsdp"]["launches"]["flash_attention"]
    return fsdp_row(qkv, launches, 2 * FSDP_LAYERS * FSDP_MICRO, FSDP_LAYERS,
                    FSDP_MICRO)


def fsdp_row(qkv, launches: int, per_step: int, layers: int,
             micro: int) -> dict:
    """Row 5-train-i2: the flash kernel at internlm2's training shape (a
    GQA group of 6), on the first operands its training gave it, held to
    its plain version and the f64 answer (check_flash_bf16's strict
    bar), timed beside SDPA and flash_work's bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    q, k, v = qkv
    b, hq, s, d = q.shape
    hk = k.shape[1]
    err, readings = check_flash_bf16(
        fa.flash_attention(q, k, v, causal=True, kv_len=s), q, k, v, s,
        "fsdp: flash_attention at internlm2's training shape")
    live, flops, nbytes = flash_work(b, hq, hk, d, s, s, True, None)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    print(f"fsdp: flash_attention at ({b}, {hq}, {s}, {d}) x ({b}, {hk}, "
          f"{s}, {d}) bf16 causal (GQA group {hq // hk}): {per_step} "
          f"launches a step, {launches} on the main path; against "
          f"flash_attention_ref and the f64 answer: {readings}", flush=True)
    return kernel_row(
        "flash_attention train-i2", launches, err,
        lambda: fa.flash_attention(q, k, v, causal=True, kv_len=s), 10,
        lambda: flash_attention_ref(q, k, v, causal=True, kv_len=s), 2,
        nbytes, flops, library=sdpa, flop_per_s=hw.PEAK_FLOPS_BF16,
        kernel="flash_attention",
        note=f"{per_step} launches a step (2 x {layers} layers x {micro} "
             f"microbatches: remat full relaunches it)")


def fsdp_gloo_cfg(moe: bool):
    """(d)'s reduced f32 configs: llama (dp:'s), or the MoE with drops
    (mixtral, dispatch groups 2, capacity factor 1.25)."""
    from repro_torch.configs.registry import get_arch
    if not moe:
        return dp_reduced_cfg()
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(),
                              dtype="float32", remat="selective",
                              moe_dispatch_groups=2)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))


def fsdp_gloo_inputs(seed: int, moe: bool):
    """(d)'s parameters (matrices x DP_GLOO_SCALE) and batch, on the
    host."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.train import optim
    cfg = fsdp_gloo_cfg(moe)
    params = optim.tree_map(
        lambda p: p * DP_GLOO_SCALE if p.dim() >= 2 else p,
        init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(seed),
                    "float32", device="cpu"))
    batch = zoo.make_batch(cfg, ShapeCell("t", 64, 4, "train"), seed,
                           device="cpu")
    batch["labels"][0, :40] = -1          # the ranks' label counts differ
    return params, batch


def fsdp_gloo_rank(rank, device, seed):
    """(d)'s rank body: each FSDP_GLOO_RUNS entry, two steps from the
    same state; the gathered parameters, and FSDP + Adafactor's chunks
    and optimizer state against ZeRO-1 + Adafactor's bit for bit.  Two
    threads a rank: the ranks may share the host with dp:'s."""
    torch.set_num_threads(2)
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataShard, shard_rows
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import elastic
    from repro_torch.sharding import collective
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    mesh = make_host_mesh(device=device)
    out, states = {}, {}
    for moe, optimizer, mode in FSDP_GLOO_RUNS:
        t0 = time.perf_counter()
        cfg = fsdp_gloo_cfg(moe)
        params, batch = fsdp_gloo_inputs(seed, moe)
        host = optim.tree_map(lambda p: p.numpy(), params)
        local = {k: v.to(device) for k, v in
                 shard_rows(batch, DataShard(rank, 2)).items()}
        run = RunConfig(optimizer=optimizer, learning_rate=1e-3,
                        microbatches=2, fsdp=mode == "fsdp",
                        zero1=mode == "zero1")
        state = init_state(cfg, run, params_from_reference(
            host, device=device), mesh=mesh)
        step = build_train_step(cfg, run, mesh=mesh)
        _cuda.reset_launches()
        ms = []
        for _ in range(DP_GLOO_STEPS):
            state, m = step(state, local)
            ms.append({k: float(v) for k, v in m.items()})
        whole = elastic.gather_state(state["params"])
        if (moe, optimizer) == (False, "adafactor"):
            states[mode] = state
        out[moe, optimizer, mode] = (
            ms, [p.detach().cpu() for p in optim.tree_leaves(whole)],
            dict(_cuda.LAUNCHES), time.perf_counter() - t0)
    f, z = states["fsdp"], states["zero1"]
    pairs = [(p, w if collective.shard_of(p) is None
              else collective.shard_of(p).of(w))
             for p, w in zip(optim.tree_leaves(f["params"]),
                             optim.tree_leaves(z["params"]))]
    pairs += list(zip(optim.tree_leaves(f["opt"]),
                      optim.tree_leaves(z["opt"])))
    out["equal"] = all(torch.equal(a.detach(), b.detach()) for a, b in pairs)
    return out


def fsdp_gloo_start(seed: int):
    """(d) started: its gloo ranks overlap what runs before (c)'s timed
    steps, which join them."""
    return gloo_start(fsdp_gloo_rank, (seed,), "fsdp: (d)")


def fsdp_gloo_finish(seed: int, pending) -> None:
    """(d), finished: every run on the two gloo ranks held to the
    one-process step on the card at DP_GLOO_REL (8-bit Adam's
    parameters at FSDP_8BIT_REL), and FSDP + Adafactor to ZeRO-1 +
    Adafactor on the same ranks bit for bit."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    t0 = pending[-1]
    got = gloo_join(pending)
    pair = (False, "adafactor")
    check(all(r["equal"] and r[pair + ("fsdp",)][0] == r[pair + ("zero1",)][0]
              for r in got),
          f"fsdp: (d) FSDP + Adafactor differs from ZeRO-1 + Adafactor on "
          f"the same gloo ranks")
    one = {}
    for moe, optimizer, mode in FSDP_GLOO_RUNS:
        if (moe, optimizer) not in one:
            cfg = fsdp_gloo_cfg(moe)
            params, batch = fsdp_gloo_inputs(seed, moe)
            run = RunConfig(optimizer=optimizer, learning_rate=1e-3,
                            microbatches=2)
            step = build_train_step(cfg, run)
            state = init_state(cfg, run, optim.tree_map(
                lambda p: p.to(DEVICE, copy=True), params))
            want = []
            for _ in range(DP_GLOO_STEPS):
                state, m = step(state, {k: v.to(DEVICE) for k, v in
                                        batch.items()})
                want.append({k: float(v) for k, v in m.items()})
            one[moe, optimizer] = (want, [p.detach().cpu() for p in
                                          optim.tree_leaves(state["params"])])
            del state
        want, want_p = one[moe, optimizer]
        name = f"{'MoE' if moe else TRAIN_ARCH} {optimizer} {mode}"
        bar_p = FSDP_8BIT_REL if optimizer == "adamw8bit" else DP_GLOO_REL
        worst_m = worst_p = 0.0
        for r in got:
            ms, ps, launches, _ = r[moe, optimizer, mode]
            check(launches.get("flash_attention", 0) > 0,
                  f"fsdp: (d) {name}: no flash_attention launch on a rank "
                  f"({launches})")
            for g, w in zip(ms, want):
                worst_m = max([worst_m] + [
                    abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w])
            worst_p = max([worst_p] + [
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(ps, want_p)])
        check(worst_m <= DP_GLOO_REL and worst_p <= bar_p,
              f"fsdp: (d) {name} on two gloo ranks differs from the "
              f"one-process step: metrics {worst_m:.3g}, params "
              f"{worst_p:.3g} (bars {DP_GLOO_REL:g}, {bar_p:g})")
        print(f"fsdp: (d) {name} on two gloo ranks on the card (reduced "
              f"f32, matrices x {DP_GLOO_SCALE}, 4 x 64 tokens in 2 "
              f"microbatches, {DP_GLOO_STEPS} steps): metrics within "
              f"{worst_m:.3g} and gathered parameters within {worst_p:.3g} "
              f"of their scale of the one-process step on the card (bars "
              f"{DP_GLOO_REL:g}, {bar_p:g}); flash_attention launches per "
              f"rank {[r[moe, optimizer, mode][2].get('flash_attention', 0) for r in got]}; "
              f"{max(r[moe, optimizer, mode][3] for r in got):.1f} s on the "
              f"ranks", flush=True)
    print(f"fsdp: (d) FSDP + Adafactor bit-equal to ZeRO-1 + Adafactor on "
          f"the same ranks (losses, grad norms, parameter chunks, factors); "
          f"(d) in {time.perf_counter() - t0:.1f} s", flush=True)


def fsdp_one_card(seed: int, before_steps) -> dict:
    """(c) at one card: internlm2-20b at full width, FSDP_ONE_LAYERS
    layers, its first run on a card: every parameter's gradient finite
    and nonzero on one microbatch, ``before_steps()`` (which ends every
    other process on the card), then two AdamW steps in FSDP_MICRO
    microbatches, the first timed and the second profiled; returns row
    5-train-i2."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataShard, _batch_for_step
    from repro_torch.kernels import _cuda
    from repro_torch.models import zoo
    from repro_torch.models.params import count_params
    from repro_torch.train.step import build_train_step, init_state
    t0 = time.perf_counter()
    full = get_arch(FSDP_ARCH)
    cfg = fsdp_cfg(1, False, FSDP_ONE_LAYERS)
    n = count_params(zoo.model_specs(cfg))
    print(f"fsdp: CUT: (c) {FSDP_ARCH} runs {FSDP_ONE_LAYERS} of "
          f"{full.n_layers} layers at full width (d_model {cfg.d_model}, "
          f"{cfg.n_q_heads} q / {cfg.n_kv_heads} kv heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}), bf16: {n:,} parameters, "
          f"{2 * n:,} bytes; remat full, AdamW, {FSDP_MICRO} microbatches of "
          f"one row, seq {TRAIN_SEQ}", flush=True)
    run = RunConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                    microbatches=FSDP_MICRO)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, run, fsdp_params(cfg, seed, DEVICE, lazy=False))
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in
                _batch_for_step(s, DataShard(0, 1), cfg.vocab, FSDP_MICRO,
                                TRAIN_SEQ).items()}
               for s in range(2)]
    (tally, first), spying = family_flash_spy()
    with spying:
        fsdp_grads_check(cfg, state, batches[0])
    t1 = time.perf_counter()
    before_steps()
    print(f"fsdp: (c) waited {time.perf_counter() - t1:.1f} s for (d)'s "
          f"ranks to end before its steps ({t1 - t0:.1f} s in)", flush=True)
    step = build_train_step(cfg, run, total_steps=FAULT_STEPS)
    _cuda.reset_launches()
    # step 0 timed, step 1 under torch.profiler (its wall beside)
    sync()
    t1 = time.perf_counter()
    state, m = step(state, batches[0])
    ms0 = (time.perf_counter() - t1) * 1e3
    got = {}
    wall, busy, top = device_busy(
        lambda: got.setdefault("m", step(state, batches[1])), n_top=5)
    launches = dict(_cuda.LAUNCHES)
    losses = [float(m["loss"]), float(got["m"][1]["loss"])]
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * FSDP_ONE_LAYERS * FSDP_MICRO
    check(all(np.isfinite(losses))
          and launches["flash_attention"] == 2 * per_step
          and sum(launches.values()) == launches["flash_attention"],
          f"fsdp: (c) losses {losses}, launches {launches}: flash_attention "
          f"must launch {per_step} times a step (2 x {FSDP_ONE_LAYERS} "
          f"layers x {FSDP_MICRO} microbatches, remat full) and nothing else")
    print(f"fsdp: (c) 2 AdamW steps: losses "
          f"{[round(x, 4) for x in losses]}; step 0 {ms0:.1f} ms, "
          f"{FSDP_MICRO * TRAIN_SEQ / ms0 * 1e3:.1f} tokens/s; step 1 under "
          f"torch.profiler: device busy {busy:.1f} of {wall:.1f} ms wall "
          f"({100 * busy / wall:.2f}%), top "
          + "; ".join(f"{n_} {t:.1f} ms" for n_, t in top)
          + f"; max_memory_allocated {peak:,}; flash_attention "
          f"{launches['flash_attention']} launches; (c) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del state, m, got
    gc.collect()
    torch.cuda.empty_cache()
    key = next(iter(tally))
    return fsdp_row(first[key], launches["flash_attention"], per_step,
                    FSDP_ONE_LAYERS, FSDP_MICRO)


def fsdp_grads_check(cfg, state, batch) -> None:
    """(c): every parameter leaf's gradient on one microbatch (one row)
    finite and nonzero, each layer's slice of a stacked leaf; the flash
    kernel launched twice a layer (the recompute relaunches it)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.kernels import _cuda
    from repro_torch.models import zoo
    micro = {k: v[:1] for k, v in batch.items()}
    flat = _flatten(state["params"])
    leaves = list(flat.values())
    for p in leaves:
        p.requires_grad_(True)
    _cuda.reset_launches()
    loss, _ = zoo.loss_fn(cfg)(state["params"], micro)
    grads = torch.autograd.grad(loss, leaves)
    sync()
    launches = _cuda.LAUNCHES["flash_attention"]
    smallest = []
    for name, g in zip(flat, grads):
        parts = g if name.startswith("layers/") else g[None]
        for i, part in enumerate(parts):
            big = float(part.float().abs().max())
            check(bool(torch.isfinite(part).all()) and big > 0,
                  f"fsdp: (c) the gradient of {name}[{i}] is not finite and "
                  f"nonzero (max |g| {big})")
            smallest.append((big, f"{name}[{i}]" if parts is g else name))
    del grads
    check(launches == 2 * cfg.n_layers,
          f"fsdp: (c) flash_attention launched {launches} times in one "
          f"microbatch's forward and backward, not 2 x {cfg.n_layers}")
    smallest.sort()
    print(f"fsdp: (c) every parameter's gradient on one microbatch is "
          f"finite and nonzero ({len(smallest)} leaves and layer slices; "
          f"smallest max |g|: " + ", ".join(f"{n} {v:.3g}" for v, n in
                                            smallest[:4])
          + f"); loss {float(loss.detach()):.4f}; flash_attention launched {launches} "
          f"times (2 x {cfg.n_layers} layers)", flush=True)


def phase_fsdp(seed: int, count: int, pending=None) -> dict:
    """FSDP and Adafactor on shards (ROADMAP Queue A items 7 and 9) over
    NCCL ranks, one card each, where there are several; at one card
    internlm2's first run and two gloo ranks on the card (``pending``:
    (d)'s ranks where the caller started them, else started here).
    Returns row 5-train-i2."""
    t_phase = time.perf_counter()
    if count >= 2:
        row = fsdp_over_cards(seed, count)
    else:
        print("fsdp: CUT: one card: NCCL takes one card a rank, so the "
              "phase runs (c) internlm2-20b on the card alone and (d) two "
              "gloo ranks on the card, not (a) and (b) over several cards",
              flush=True)
        pending = pending or fsdp_gloo_start(seed)
        row = fsdp_one_card(seed, lambda: gloo_join(pending))
        fsdp_gloo_finish(seed, pending)
    print(f"fsdp: all in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row


# ----------------------------------------------------------------------- tp
def tp_owns(t, coords) -> bool:
    """Whether this rank counts leaf ``t`` in a sum over every rank: a
    chunk of a data or model split on every rank of that line, a leaf
    whole on a line on the line's first rank."""
    from repro_torch.sharding import collective
    return ((collective.shard_of(t) is not None or coords["data"] == 0)
            and (collective.model_of(t) is not None
                 or coords["model"] == 0))


def tp_parts(state) -> list:
    """The leaf lists a state is compared by: its parameters, then its
    optimizer state (AdamW's mu and nu, or Adafactor's factors)."""
    from repro_torch.train import optim
    opt = state["opt"]
    return [optim.tree_leaves(state["params"])] + (
        [optim.tree_leaves(opt["mu"]), optim.tree_leaves(opt["nu"])]
        if "mu" in opt else [optim.tree_leaves(opt["v"])])


def tp_distances(state, one, initial, coords, device) -> list:
    """Relative L2 distances of a TP state's parameters (over the
    one-card step's move from ``initial``'s) and optimizer state (over
    the one-card state's norm; AdamW's mu and nu, or Adafactor's
    factors) from the one-card state ``one`` (host copies of its
    :func:`tp_parts`): each chunk against its chunk of the one-card leaf
    (``collective.cut``), each element counted on one rank
    (:func:`tp_owns`), summed over the ranks."""
    import torch.distributed as dist
    from repro_torch.sharding import collective
    from repro_torch.train import optim
    mine = tp_parts(state)
    base = optim.tree_leaves(initial())
    sums = torch.zeros(len(mine), 2, dtype=torch.float64, device=device)
    for i, (leaves, theirs) in enumerate(zip(mine, one)):
        for j, (a, b) in enumerate(zip(leaves, theirs)):
            if not tp_owns(a, coords):
                continue
            m, sh = collective.model_of(a), collective.shard_of(a)
            b = collective.cut(b.to(device), m, sh).float()
            ref = collective.cut(base[j], m, sh).float() if i == 0 else 0.0
            sums[i, 0] += torch.sum((a.detach().float() - b) ** 2)
            sums[i, 1] += torch.sum((b - ref) ** 2)
            del b, ref
    del base
    dist.all_reduce(sums)
    return [float(x) for x in torch.sqrt(sums[:, 0] / sums[:, 1])]


def tp_nccl_rank(rank, device, seed, cfg, seq, meshes, families=()):
    """The W-card rank body (``cfg`` at ``seq`` tokens a row, train:'s
    global batch of TRAIN_BATCH rows; None: (d) alone): every rank
    first takes the one-card step on the global batch in TRAIN_MICRO
    microbatches and,
    where a mesh has a data axis, in one-row microbatches (keeping each
    state after DP_EQUAL_STEPS steps on the host), each also with its
    attention forward rounded another way (the noise floor: its
    distances from the one-card step); then on each of ``meshes``
    ((data, model, modes)) TP_STEPS timed steps of each mode, the
    state's distance from the one-card state, the bytes against
    abstract_state's, and one more step under torch.profiler; rank 0
    keeps the first flash operands of the first mesh's first mode.
    Then (c): the same comparison in f32 (``cfg`` in f32, its matrices
    x DP_GLOO_SCALE, one row a step, (1, W) plain).  Last, (d): each of
    ``families`` ((label, config in f32, optimizer, tokens, source
    frames, the (2, 2) mode)) the same way in f32 against its one-card
    step, TP_FAMILY_ROWS rows a step, on (1, W) plain and at W = 4 on
    (2, 2) in its mode; rank 0 keeps the first flash operands of each
    shape the (1, W) steps gave the kernel."""
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.data.pipeline import DataShard, _batch_for_step, \
        shard_rows
    from repro_torch.kernels import _cuda
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import encdec, transformer, zoo
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.params import init_params
    from repro_torch.sharding.logical import LogicalMesh, default_rules
    from repro_torch.train import optim
    from repro_torch.train.step import (abstract_state, build_train_step,
                                        init_state, zero1_grad_shardings)
    rows, on_card = TRAIN_BATCH, device.type == "cuda"
    world = dist.get_world_size()
    meshes_of = {}

    def mesh_of(m):
        if m not in meshes_of:
            meshes_of[m] = make_host_mesh(model_parallel=m, device=device)
        return meshes_of[m]

    def wait():
        if on_card:
            torch.cuda.synchronize(device)

    def initial(c, scale=1.0):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(zoo.model_specs(c), gen, c.dtype, device=device)
        if scale != 1.0:
            for p in optim.tree_leaves(params):
                if p.dim() >= 2:
                    p.mul_(scale)
        return params

    def timed(step, state, batches):
        losses, norms, times = [], [], []
        for b in batches:
            wait()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
        return state, losses, norms, times

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def floor_attention(q, k, v, cfg, causal=True):
        ck = min(TP_FLOOR_CHUNK, max(1, q.shape[1] // 4))
        return chunked_attention(q, k, v, causal=causal,
                                 window=cfg.sliding_window if causal
                                 else None, chunk_q=ck, chunk_k=ck)

    def floor_patch():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(transformer, "attention",
                                              floor_attention))
        stack.enter_context(mock.patch.object(encdec, "attention",
                                              floor_attention))
        return stack

    def reference(c, run_one, batches, scale=1.0):
        """The one-card step on ``batches`` from the initial parameters
        (matrices x ``scale``; its state after DP_EQUAL_STEPS steps kept
        on the host), then the noise floor."""
        out = {}
        for floor in (False, True):
            with floor_patch() if floor else contextlib.nullcontext():
                step = build_train_step(c, run_one, total_steps=FAULT_STEPS)
                state, *first = timed(step, init_state(c, run_one,
                                                       initial(c, scale)),
                                      batches[:DP_EQUAL_STEPS])
                if floor:
                    dists = tp_distances(state, out["one"]["kept"],
                                         lambda: initial(c, scale),
                                         {"data": 0, "model": 0}, device)
                else:
                    kept = [[t.detach().to("cpu", copy=True) for t in x]
                            for x in tp_parts(state)]
                state, *rest = timed(step, state,
                                     batches[DP_EQUAL_STEPS:TP_STEPS])
            loss, norm, times = (a + b for a, b in zip(first, rest))
            out["floor" if floor else "one"] = dict(
                loss=loss, norm=norm, times=times,
                **({"dists": dists} if floor else {"kept": kept}))
            del state, step
            free()
        return out

    def mode(c, run_m, mesh, d, m, local, one, watch, scale=1.0,
             cell_seq=seq):
        """TP_STEPS timed steps of one mode on ``mesh`` and one profiled,
        from the initial parameters (matrices x ``scale``); (its record,
        where ``watch`` the first flash operands of each shape and its
        launches in the first DP_EQUAL_STEPS steps)."""
        coords = mesh.coords()
        desc = LogicalMesh(("data", "model"), (d, m))
        free()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        state = init_state(c, run_m, initial(c, scale), mesh=mesh)
        step = build_train_step(c, run_m, total_steps=FAULT_STEPS,
                                mesh=mesh)
        (tally, spied), spying = family_flash_spy()
        _cuda.reset_launches()
        with spying if watch else contextlib.nullcontext():
            state, *first = timed(step, state, local[:DP_EQUAL_STEPS])
        ops = {key: (tally[key], tuple(t.detach().cpu() for t in qkv))
               for key, qkv in spied.items()} if watch and spied else None
        dists = tp_distances(state, one["kept"], lambda: initial(c, scale),
                             coords, device)
        state, *rest = timed(step, state, local[DP_EQUAL_STEPS:TP_STEPS])
        losses, norms, times = (a + b for a, b in zip(first, rest))
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        held = (step.held["param_bytes"],
                sum(t.numel() * t.element_size()
                    for t in optim.tree_leaves(state["opt"])),
                step.held["grad_acc_bytes"])
        wall, busy, top = device_busy(
            lambda: step(state, local[TP_STEPS]), n_top=None) \
            if on_card else (1.0, 0.0, [])
        ab = abstract_state(c, run_m, zoo.model_specs(c), desc,
                            default_rules(fsdp=run_m.fsdp))
        accs = optim.tree_leaves(zero1_grad_shardings(c, run_m, desc)) \
            if run_m.zero1 or run_m.fsdp else \
            [t.sharding for t in optim.tree_leaves(ab["params"])]
        want = (shard_bytes(ab["params"]), shard_bytes(ab["opt"]),
                sum(int(np.prod(s.shard_shape(tuple(t.shape)))) * 4
                    for t, s in zip(optim.tree_leaves(ab["params"]), accs)))
        rec = analyze_cell(c.name, "train_4k", False, cfg=c, run=run_m,
                           cell=ShapeCell("train_4k", cell_seq,
                                          local[0]["tokens"].shape[0] * d,
                                          "train"), mesh=desc)
        del state, step
        return dict(
            loss=losses, norm=norms, times=times, dists=dists,
            launches=launches, peak=peak, held=held, want=want,
            wall_ms=wall, busy_ms=busy,
            nccl_ms=nccl_ms(top),
            nccl_kinds=nccl_kinds(top),
            flash_ms=sum(t for n, t in top if "flash" in n.lower()),
            model_bytes=rec["mem"]["bytes"]["total"],
            top=[(n, round(t, 3)) for n, t in top[:5]]), ops

    def dense(out, run):
        """(a)-(c): the dense family in bf16 on ``meshes``, then in f32."""
        glob = [{k: torch.from_numpy(v).to(device) for k, v in
                 _batch_for_step(s, DataShard(0, 1), cfg.vocab, rows,
                                 seq).items()}
                for s in range(TP_STEPS + 1)]
        refs = {micro: reference(cfg, dataclasses.replace(
            run, microbatches=micro), glob)
            for micro in sorted({TRAIN_MICRO if d == 1 else rows
                                 for d, _, _ in meshes})}
        out["one"] = {k: {n: v for n, v in r["one"].items() if n != "kept"}
                      for k, r in refs.items()}
        out["floor"] = {k: r["floor"] for k, r in refs.items()}
        dist.barrier()
        out["qkv"] = None
        for d, m, modes in meshes:
            mesh = mesh_of(m)
            local = [shard_rows(b, DataShard(mesh.coords()["data"], d))
                     for b in glob]
            for name in modes:
                run_m = dataclasses.replace(run, zero1=name == "zero1",
                                            fsdp=name == "fsdp")
                watch = rank == 0 and on_card and out["qkv"] is None
                out[d, m, name], ops = mode(
                    cfg, run_m, mesh, d, m, local,
                    refs[TRAIN_MICRO if d == 1 else rows]["one"], watch)
                if ops is not None:
                    out["qkv"] = next(iter(ops.values()))[1]
        del refs
        free()
        # (c) f32, one row a step, on (1, W), the matrices x DP_GLOO_SCALE
        # (at the fan_in weights f32 rounding alone moves the gradient by
        # ~1%, PERF.md): the floor stays small and the comparison bites
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        run32 = dataclasses.replace(run, microbatches=1)
        one_row = [{k: v[:1] for k, v in b.items()} for b in glob]
        ref32 = reference(cfg32, run32, one_row, DP_GLOO_SCALE)
        out["f32"] = {"one": {n: v for n, v in ref32["one"].items()
                              if n != "kept"}, "floor": ref32["floor"]}
        out["f32"]["tp"], _ = mode(cfg32, run32, mesh_of(world), 1, world,
                                   one_row, ref32["one"], False,
                                   DP_GLOO_SCALE)

    def family(c, optimizer, tokens, frames, mode22):
        """(d): one family in f32 (matrices x DP_GLOO_SCALE) on
        TP_FAMILY_ROWS rows a step against its one-card step, on (1, W)
        plain and at W = 4 on (2, 2) in ``mode22``."""
        cell = ShapeCell("train_4k", tokens, TP_FAMILY_ROWS, "train")
        glob = []
        for s in range(TP_STEPS + 1):
            b = zoo.make_batch(c, cell, seed + s, device=device)
            if frames is not None:
                b["src_embeds"] = zoo.make_batch(c, ShapeCell(
                    "train_4k", frames, TP_FAMILY_ROWS, "train"), seed + s,
                    device=device)["src_embeds"]
            glob.append(b)
        run_f = RunConfig(optimizer=optimizer, learning_rate=TRAIN_LR,
                          microbatches=1)
        ref = reference(c, run_f, glob, DP_GLOO_SCALE)
        got = {"one": {n: v for n, v in ref["one"].items() if n != "kept"},
               "floor": ref["floor"], "qkv": None}
        dist.barrier()
        plan = [(1, world, "plain")] + ([(2, 2, mode22)] if world == 4
                                        else [])
        for d, m, name in plan:
            mesh = mesh_of(m)
            local = [shard_rows(b, DataShard(mesh.coords()["data"], d))
                     for b in glob]
            run_m = dataclasses.replace(run_f, zero1=name == "zero1",
                                        fsdp=name == "fsdp")
            watch = rank == 0 and on_card and got["qkv"] is None
            got[d, m, name], ops = mode(c, run_m, mesh, d, m, local,
                                        ref["one"], watch, DP_GLOO_SCALE,
                                        cell_seq=tokens)
            if ops is not None:
                got["qkv"] = ops
        del ref
        free()
        return got

    out = {"device": str(device)}
    if cfg is not None:
        dense(out, RunConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                             microbatches=TRAIN_MICRO))
    out["families"] = {label: family(c, optimizer, tokens, frames, mode22)
                       for label, c, optimizer, tokens, frames, mode22
                       in families}
    return out


def tp_bars(one, floor) -> tuple:
    """(first grad norms, later grad norms, [parameters, mu, nu]) bars
    of a comparison with the one-card step ``one``: dp:'s, or within
    TP_FLOOR_X x the noise floor's reading where that is wider."""
    rel = [abs(a - b) / abs(b) for a, b in zip(floor["norm"], one["norm"])]
    return (max(TRAIN_GRAD_REL, TP_FLOOR_X * max(rel[:DP_EQUAL_STEPS])),
            max(DP_LATE_NORM_REL, TP_FLOOR_X * max(rel[DP_EQUAL_STEPS:]
                                                   + [0.0])),
            [max(DP_STATE_REL, TP_FLOOR_X * x) for x in floor["dists"]])


def tp_check(tag, got, key, one_of, bars) -> tuple:
    """Every rank's record ``res[key]`` against the one-card step
    ``one_of(res)`` at ``bars`` (:func:`tp_bars`) and its bytes against
    abstract_state's; returns the largest relative loss, first and later
    grad-norm differences."""
    rel_l = rel_g = rel_late = 0.0
    bar_g, bar_late, bar_s = bars
    for r, res in enumerate(got):
        x, one = key(res), one_of(res)
        rel_l = max([rel_l] + [abs(a - b) / abs(b) for a, b in
                               zip(x["loss"], one["loss"])])
        rel = [abs(a - b) / abs(b) for a, b in zip(x["norm"], one["norm"])]
        rel_g = max([rel_g] + rel[:DP_EQUAL_STEPS])
        rel_late = max([rel_late] + rel[DP_EQUAL_STEPS:])
        check(rel_l <= TRAIN_REPLAY_REL and rel_g <= bar_g
              and rel_late <= bar_late,
              f"{tag} rank {r}: losses {x['loss']} / grad norms "
              f"{x['norm']} part from the one-card step's by {rel_l:.3g} / "
              f"{rel_g:.3g} (the first {DP_EQUAL_STEPS} steps), "
              f"{rel_late:.3g} (later) (bars {TRAIN_REPLAY_REL:g}, "
              f"{bar_g:.3g}, {bar_late:.3g})")
        check(all(a <= b for a, b in zip(x["dists"], bar_s)),
              f"{tag} rank {r}: parameters / mu / nu after {DP_EQUAL_STEPS} "
              f"steps part from the one-card step's by {x['dists']} (bars "
              f"{bar_s})")
        check(tuple(x["held"]) == tuple(x["want"]),
              f"{tag} rank {r}: parameters, optimizer state and accumulators "
              f"hold {x['held']} B, not the described {x['want']}")
    return rel_l, rel_g, rel_late


def tp_reference_line(tag, one, floor, bars) -> None:
    rel = [abs(a - b) / abs(b) for a, b in zip(floor["norm"], one["norm"])]
    print(f"{tag}: losses {one['loss']}, grad norms {one['norm']}, ms a "
          f"step {[round(t * 1e3, 1) for t in one['times']]}; with its "
          f"attention forward rounded another way (chunked plain attention, "
          f"not the flash kernel): losses {floor['loss']}, grad norms "
          f"{floor['norm']} ({[round(x, 6) for x in rel]} apart), "
          f"parameters / mu / nu at L2 distances {floor['dists']} after "
          f"{DP_EQUAL_STEPS} steps: the noise floor; bars: grad norms "
          f"{bars[0]:.3g} / {bars[1]:.3g}, state "
          f"{[round(x, 5) for x in bars[2]]}", flush=True)


def tp_report(got, world, cfg, meshes) -> None:
    """The W-card checks and lines: each mode against the one-card step
    on the same global batch at dp:'s bars (the grad norms and the state
    within TP_FLOOR_X x the noise floor where that is wider), the bytes,
    the launches, the times; then (c), the f32 comparison."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_step = 2 * cfg.n_layers * TRAIN_MICRO
    bars = {}
    for micro, o in got[0]["one"].items():
        bars[micro] = tp_bars(o, got[0]["floor"][micro])
        tp_reference_line(f"tp: the one-card step on the global batch "
                          f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens) in {micro} "
                          f"microbatches", o, got[0]["floor"][micro],
                          bars[micro])
    one_rate = tokens / float(np.median(
        got[0]["one"][TRAIN_MICRO]["times"][1:]))
    for d, m, modes in meshes:
        for mode in modes:
            micro = TRAIN_MICRO if d == 1 else TRAIN_BATCH
            tag = f"tp: ({d}, {m}) {mode}"
            for r, res in enumerate(got):
                check(res[d, m, mode]["launches"].get("flash_attention", 0)
                      == TP_STEPS * per_step,
                      f"{tag} rank {r}: launches "
                      f"{res[d, m, mode]['launches']}, not {TP_STEPS} x "
                      f"{per_step} flash_attention")
            rel_l, rel_g, rel_late = tp_check(
                tag, got, lambda res: res[d, m, mode],
                lambda res: res["one"][micro], bars[micro])
            x0 = got[0][d, m, mode]
            print(f"{tag}: against the one-card step in {micro} "
                  f"microbatches: losses {x0['loss']}, grad norms "
                  f"{x0['norm']}: within {rel_l:.3g}, {rel_g:.3g} (the "
                  f"first {DP_EQUAL_STEPS} steps) and {rel_late:.3g} "
                  f"(later); after {DP_EQUAL_STEPS} steps the L2 distance "
                  f"of parameters / mu / nu by rank "
                  f"{[res[d, m, mode]['dists'] for res in got]} (bars "
                  f"{[round(b, 5) for b in bars[micro][2]]}); parameters, "
                  f"optimizer state, f32 accumulators {x0['held']} B on "
                  f"rank 0, as abstract_state describes", flush=True)
            med = float(np.median(x0["times"][1:]))
            print(f"{tag}: ms a step "
                  f"{[[round(t * 1e3, 1) for t in res[d, m, mode]['times']] for res in got]}"
                  f" (per rank, the first with its warm-up; median after "
                  f"it on rank 0 {med * 1e3:.1f}), {tokens / med:.1f} "
                  f"tokens/s, {tokens / med / (world * one_rate):.4f} of "
                  f"{world} x the one-card rate; flash_attention "
                  f"{[res[d, m, mode]['launches'].get('flash_attention', 0) for res in got]}"
                  f" launches per rank ({TP_STEPS} steps x {per_step})",
                  flush=True)
            for r, res in enumerate(got):
                tp_profile_line(f"{tag} rank {r} ({res['device']})",
                                res[d, m, mode], per_step, d, m)
    f32 = got[0]["f32"]
    for r, res in enumerate(got):
        n = res["f32"]["tp"]["launches"].get("flash_attention", 0)
        check(n == TP_STEPS * 2 * cfg.n_layers,
              f"tp: (c) f32 rank {r}: {n} flash_attention launches, not "
              f"{TP_STEPS} x 2 x {cfg.n_layers}")
    b32 = tp_bars(f32["one"], f32["floor"])
    tp_reference_line(f"tp: (c) f32, matrices x {DP_GLOO_SCALE}, the "
                      f"one-card step on one row of {TRAIN_SEQ} tokens",
                      f32["one"], f32["floor"], b32)
    rel_l, rel_g, rel_late = tp_check(
        f"tp: (c) f32 (1, {world}) plain", got,
        lambda res: res["f32"]["tp"], lambda res: res["f32"]["one"], b32)
    x0 = f32["tp"]
    print(f"tp: (c) f32 (1, {world}) plain against the one-card step: "
          f"losses {x0['loss']}, grad norms {x0['norm']}: within "
          f"{rel_l:.3g}, {rel_g:.3g} (the first {DP_EQUAL_STEPS} steps) and "
          f"{rel_late:.3g} (later); parameters / mu / nu at "
          f"{[res['f32']['tp']['dists'] for res in got]} by rank (bars "
          f"{[round(b, 5) for b in b32[2]]}); ms a step "
          f"{[round(t * 1e3, 1) for t in x0['times']]} on rank 0",
          flush=True)
    tp_profile_line(f"tp: (c) f32 rank 0 ({got[0]['device']})", x0,
                    2 * cfg.n_layers, 1, world)


def tp_attention_calls(cfg) -> int:
    """Flash launches a step of one microbatch under remat full: each
    attention twice (the forward and the backward's recompute), an
    encdec decoder layer's two (self and cross) included, the hybrid's
    shared block once a super-block, none in an ssm."""
    if cfg.family == "encdec":
        return 2 * (cfg.n_layers + 2 * cfg.n_dec_layers)
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return 2 * (cfg.n_layers // cfg.shared_every)
    return 2 * cfg.n_layers


def tp_needs(mode: str, cfg) -> tuple:
    """The collectives a mode needs of gloo: TP_NEEDS, and a
    reduce-scatter for a mamba mixer (its gathered in_proj output)."""
    return TP_NEEDS[mode] + (("reduce_scatter_tensor",) if cfg.ssm
                             else ())


def nccl_kinds(top) -> dict:
    """NCCL kernel ms of a profiled step by collective (the kernel names
    torch.profiler gives, cut at 48 characters; nccl_ms's kernels)."""
    out = {}
    for n, t in top:
        if is_nccl_kernel(n):
            low = n.lower()
            kind = next((k for k in ("allgather", "reducescatter",
                                     "allreduce") if k in low), "other")
            out[kind] = out.get(kind, 0.0) + t
    return {k: round(v, 3) for k, v in sorted(out.items())}


def tp_family_report(got, world, families) -> None:
    """(d): each family against its one-card f32 step at dp:'s bars (or
    TP_FLOOR_X x its f32 noise floor where that is wider), its bytes and
    launches, on (1, W) plain and at W = 4 on (2, 2) in its mode; ms a
    step, tokens/s against W x one card, NCCL ms, busy share and peak a
    card beside estimate_memory."""
    for label, c, _, tokens, frames, mode22 in families:
        fam = [res["families"][label] for res in got]
        f0 = fam[0]
        bars = tp_bars(f0["one"], f0["floor"])
        what = (f"{TP_FAMILY_ROWS} rows of {tokens} positions"
                + (f" and {frames} source frames" if frames else ""))
        tp_reference_line(f"tp: (d) {label} f32, matrices x "
                          f"{DP_GLOO_SCALE}, the one-card step on {what}",
                          f0["one"], f0["floor"], bars)
        per_step = tp_attention_calls(c)
        n_tok = TP_FAMILY_ROWS * tokens
        one_rate = n_tok / float(np.median(f0["one"]["times"][1:]))
        plan = [(1, world, "plain")] + ([(2, 2, mode22)] if world == 4
                                        else [])
        for d, m, name in plan:
            tag = f"tp: (d) {label} ({d}, {m}) {name}"
            for r, res in enumerate(fam):
                n = res[d, m, name]["launches"].get("flash_attention", 0)
                check(n == TP_STEPS * per_step,
                      f"{tag} rank {r}: {n} flash_attention launches, not "
                      f"{TP_STEPS} x {per_step}")
            rel_l, rel_g, rel_late = tp_check(
                tag, fam, lambda res: res[d, m, name],
                lambda res: res["one"], bars)
            x0 = f0[d, m, name]
            med = float(np.median(x0["times"][1:]))
            print(f"{tag}: against the one-card f32 step: losses "
                  f"{x0['loss']}, grad norms {x0['norm']}: within "
                  f"{rel_l:.3g}, {rel_g:.3g} (the first {DP_EQUAL_STEPS} "
                  f"steps) and {rel_late:.3g} (later); after "
                  f"{DP_EQUAL_STEPS} steps the L2 distance of parameters / "
                  f"optimizer state by rank "
                  f"{[res[d, m, name]['dists'] for res in fam]} (bars "
                  f"{[round(b, 5) for b in bars[2]]}); parameters, optimizer "
                  f"state, f32 accumulators {x0['held']} B on rank 0, as "
                  f"abstract_state describes; ms a step "
                  f"{[[round(t * 1e3, 1) for t in res[d, m, name]['times']] for res in fam]}"
                  f" (per rank; median after the first on rank 0 "
                  f"{med * 1e3:.1f}), {n_tok / med:.1f} tokens/s, "
                  f"{n_tok / med / (world * one_rate):.4f} of {world} x the "
                  f"one-card rate", flush=True)
            for r, res in enumerate(fam):
                tp_profile_line(f"{tag} rank {r} ({got[r]['device']})",
                                res[d, m, name], per_step, d, m)


def tp_profile_line(tag, x, per_step, d, m) -> None:
    flash = (f"flash_attention {x['flash_ms'] / per_step:.4f} ms a launch"
             if per_step else "no attention")
    print(f"{tag}: one step under torch.profiler: NCCL kernels "
          f"{x['nccl_ms']:.3f} ms (by collective {x['nccl_kinds']}), "
          f"{flash}; device kernel time "
          f"{x['busy_ms']:.1f} of {x['wall_ms']:.1f} ms wall "
          f"({100 * x['busy_ms'] / x['wall_ms']:.2f}%, summed over "
          f"streams); peak {x['peak']:,} B beside estimate_memory's "
          f"{x['model_bytes']:,} B (a ({d}, {m}) mesh); top {x['top']}",
          flush=True)


def tp_family_cfgs() -> list:
    """TP_FAMILY_RUNS as the rank body takes them: (label, config in f32
    at full width and the run's depth, optimizer, positions, frames, the
    (2, 2) mode)."""
    from repro_torch.configs.registry import get_arch
    out = []
    for label, arch, layers, experts, optimizer, tokens, frames, mode22 in \
            TP_FAMILY_RUNS:
        full = get_arch(arch)
        kw = dict(n_layers=layers, dtype="float32", remat="full")
        if full.n_dec_layers is not None:
            kw["n_dec_layers"] = layers
        if full.moe is not None:
            kw["moe_dispatch_groups"] = TP_FAMILY_ROWS
            if experts is not None:
                kw["moe"] = dataclasses.replace(full.moe, n_experts=experts)
        out.append((label, dataclasses.replace(full, **kw), optimizer, tokens,
                    frames, mode22))
    return out


def tp_over_cards(seed: int, world: int) -> list:
    """At count >= 2: W NCCL ranks, one card each, on TP_MESHES[W] at
    train:'s width and depth against the one-card step, then (d) the
    families in f32; returns row 5-train-tp and a row for each flash
    shape (d)'s (1, W) steps gave rank 0's kernel."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.ranks import run_ranks
    t0 = time.perf_counter()
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    meshes = TP_MESHES.get(world, ((1, world, ("plain",)),))
    print(f"tp: CUT: {TRAIN_ARCH} runs {TRAIN_LAYERS} of {full.n_layers} "
          f"layers at full width (d_model {cfg.d_model}, {cfg.n_q_heads} q / "
          f"{cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"train:'s global batch of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{TRAIN_MICRO} microbatches (not 256 rows); meshes (data, "
          f"model, modes) {meshes}", flush=True)
    families = tp_family_cfgs()
    for (label, c, optimizer, tokens, frames, mode22), run in zip(
            families, TP_FAMILY_RUNS):
        full = get_arch(run[1])
        depth = (f"{c.n_layers} + {c.n_dec_layers} of {full.n_layers} + "
                 f"{full.n_dec_layers}" if c.n_dec_layers else
                 f"{c.n_layers} of {full.n_layers}")
        experts = (f", {c.moe.n_experts} of {full.moe.n_experts} experts "
                   f"(top {c.moe.top_k}), {TP_FAMILY_ROWS} dispatch groups"
                   if c.moe else "")
        heads = f"{c.n_q_heads} q / {c.n_kv_heads} kv heads of {c.hd}"
        if c.ssm is not None:
            d_in = c.ssm.expand * c.d_model
            ssm = (f"{d_in // c.ssm.head_dim} SSM heads of "
                   f"{c.ssm.head_dim}, state {c.ssm.d_state}, chunk "
                   f"{c.ssm.chunk}")
            heads = ssm if c.family == "ssm" else \
                f"{ssm}; the shared block's {heads}"
        print(f"tp: CUT: (d) {label} ({run[1]}) in f32 at full width "
              f"(d_model {c.d_model}, {heads}, vocab {c.vocab}), {depth} "
              f"layers{experts}, "
              f"remat full, {optimizer}, {TP_FAMILY_ROWS} rows of {tokens} "
              f"positions{f' and {frames} source frames' if frames else ''} "
              f"a step in one microbatch (not train_4k's 256 rows); (1, "
              f"{world}) plain{f' and (2, 2) {mode22}' if world == 4 else ''}",
              flush=True)
    got = run_ranks(tp_nccl_rank, world, (seed, cfg, TRAIN_SEQ, meshes,
                                          families), timeout_s=2400)
    tp_report(got, world, cfg, meshes)
    tp_family_report(got, world, families)
    print(f"tp: over {world} cards in {time.perf_counter() - t0:.1f} s",
          flush=True)
    qkv = tuple(t.to(DEVICE) for t in got[0]["qkv"])
    d, m, modes = meshes[0]
    launches = got[0][d, m, modes[0]]["launches"]["flash_attention"]
    rows = [tp_row(qkv, launches, 2 * TRAIN_LAYERS * TRAIN_MICRO)]
    del qkv
    for label, c, *_ in families:
        for key, (n, qkv) in (got[0]["families"][label]["qkv"]
                              or {}).items():
            causal, window = key[2], key[4]
            shape = (f"window {window}" if window else "causal" if causal
                     else "non-causal" if key[0][2] == key[1][2]
                     else "cross")
            rows.append(family_flash_row(
                f"train-tp {label} ({shape})", key,
                tuple(t.to(DEVICE) for t in qkv), n, (key[0][2],), tag="tp"))
    return rows


def tp_row(qkv, launches: int, per_step: int) -> dict:
    """Row 5-train-tp: the flash kernel at a model rank's shape (its
    share of the q and kv heads), on the first operands its TP step gave
    it, held to its plain version and the f64 answer (check_flash_bf16's
    strict bar), timed beside SDPA and flash_work's bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    q, k, v = qkv
    b, hq, s, d = q.shape
    hk = k.shape[1]
    err, readings = check_flash_bf16(
        fa.flash_attention(q, k, v, causal=True, kv_len=s), q, k, v, s,
        "tp: flash_attention at a model rank's training shape")
    live, flops, nbytes = flash_work(b, hq, hk, d, s, s, True, None,
                                     itemsize=q.element_size())
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    print(f"tp: flash_attention at ({b}, {hq}, {s}, {d}) x ({b}, {hk}, {s}, "
          f"{d}) bf16 causal: {per_step} launches a step a rank, {launches} "
          f"on rank 0's path; against flash_attention_ref and the f64 "
          f"answer: {readings}", flush=True)
    return kernel_row(
        "flash_attention train-tp", launches, err,
        lambda: fa.flash_attention(q, k, v, causal=True, kv_len=s), 10,
        lambda: flash_attention_ref(q, k, v, causal=True, kv_len=s), 2,
        nbytes, flops, library=sdpa, flop_per_s=hw.PEAK_FLOPS_BF16,
        kernel="flash_attention",
        note=f"{per_step} launches a step a rank (2 x {TRAIN_LAYERS} layers "
             f"x {TRAIN_MICRO} microbatches: selective remat relaunches it)")


def tp_gloo_rank(rank, device, params, batch, families):
    """The one-card rank body: gloo's collectives probed on CUDA tensors
    (an all-reduce's max too, the vocabulary split's), then
    DP_GLOO_STEPS steps of each TP_GLOO_MESHES mode and each
    TP_GLOO_FAMILIES run (``families``: each name's host parameters and
    batch) whose collectives gloo has; the gathered parameters.  One
    thread a rank: four ranks share the host with dp:'s and fsdp:'s."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataShard, shard_rows
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import elastic
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    missing = {}
    for name in DP_COLLECTIVES + ("all_reduce_max",):
        x = torch.ones(4, device=device)
        try:
            if name in ("all_reduce", "all_reduce_max"):
                dist.all_reduce(x, op=dist.ReduceOp.MAX
                                if name == "all_reduce_max"
                                else dist.ReduceOp.SUM)
            elif name == "broadcast":
                dist.broadcast(x, 0)
            elif name == "all_gather_into_tensor":
                dist.all_gather_into_tensor(torch.empty(16, device=device),
                                            x)
            else:
                dist.reduce_scatter_tensor(torch.empty(1, device=device), x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            missing[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    out = {"missing": missing}
    meshes = {(d, m): make_host_mesh(model_parallel=m, device=device)
              for d, m, _ in TP_GLOO_MESHES}

    def run_one(cfg, host, batch, d, m, mode, optimizer):
        mesh = meshes[d, m]
        local = {k: v.to(device) for k, v in shard_rows(
            batch, DataShard(mesh.coords()["data"], d)).items()}
        t0 = time.perf_counter()
        run = RunConfig(optimizer=optimizer, learning_rate=1e-3,
                        microbatches=2, zero1=mode == "zero1",
                        fsdp=mode == "fsdp")
        state = init_state(cfg, run, params_from_reference(
            host, device=device), mesh=mesh)
        step = build_train_step(cfg, run, mesh=mesh)
        _cuda.reset_launches()
        ms = []
        for _ in range(DP_GLOO_STEPS):
            state, met = step(state, local)
            ms.append({k: float(v) for k, v in met.items()})
        mu = [t.detach().cpu() for t in optim.tree_leaves(
            elastic.gather_state(state["opt"]["mu"]))] \
            if "mu" in state["opt"] else None
        return (ms, [p.detach().cpu() for p in optim.tree_leaves(
            elastic.gather_state(state["params"]))],
            dict(_cuda.LAUNCHES), time.perf_counter() - t0, mu)

    cfg = dp_reduced_cfg()
    for d, m, modes in TP_GLOO_MESHES:
        for mode in modes:
            if not any(n in missing for n in TP_NEEDS[mode]):
                out[d, m, mode] = run_one(cfg, params, batch, d, m, mode,
                                          "adamw")
    for name, _, _, d, m, mode, optimizer in TP_GLOO_FAMILIES:
        fam = tp_family_cfg(name)
        if not any(n in missing for n in tp_needs(mode, fam)):
            out[name, d, m, mode] = run_one(fam, *families[name], d, m,
                                            mode, optimizer)
    return out


def tp_family_cfg(name: str):
    """A TP_GLOO_FAMILIES config: the arch's reduced config in f32 with
    selective remat and the entry's changes (the MoE's at capacity
    factor 1.25 in 2 dispatch groups)."""
    from repro_torch.configs.registry import get_arch
    _, arch, changes, *_ = next(f for f in TP_GLOO_FAMILIES if f[0] == name)
    changes = dict(changes)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              remat="selective",
                              vocab=changes.pop("vocab", None)
                              or get_arch(arch).reduced().vocab)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=2, moe=(
            dataclasses.replace(cfg.moe, capacity_factor=1.25, **changes)))
    return cfg


def tp_adamw_spread(mu_a, mu_b, lr: float, b1: float = 0.9,
                    eps: float = 1e-8):
    """|lr * (f(a) - f(b))| by element: f = g / (|g| + eps), AdamW's second
    update at the clipped gradient g = mu / (1 - b1**2) of each first
    moment (both steps' gradient, so sqrt(nu-hat) = |g|)."""
    def f(mu):
        g = mu.double() / (1 - b1 ** 2)
        return g / (g.abs() + eps)
    return lr * (f(mu_a) - f(mu_b)).abs()


def tp_family_inputs(seed: int, name: str):
    """A TP_GLOO_FAMILIES config's parameters (matrices x DP_GLOO_SCALE,
    or its TP_GLOO_SCALES entry) and batch of 4 x 64 positions (a vlm's
    prefix among them), on the host."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.train import optim
    cfg = tp_family_cfg(name)
    params = optim.tree_map(
        lambda p: p * TP_GLOO_SCALES.get(name, DP_GLOO_SCALE)
        if p.dim() >= 2 else p,
        init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(seed),
                    "float32", device="cpu"))
    batch = zoo.make_batch(cfg, ShapeCell("t", 64, 4, "train"), seed,
                           device="cpu")
    batch["labels"][0, :20] = -1          # the ranks' label counts differ
    return params, batch


def tp_gloo_start(seed: int):
    """The one-card check started: four gloo ranks on the card."""
    from repro_torch.train import optim
    params, batch = dp_reduced_inputs(seed, DP_GLOO_SCALE)
    host = optim.tree_map(lambda p: p.numpy().copy(), params)
    families = {}
    for name, *_ in TP_GLOO_FAMILIES:
        fp, fb = tp_family_inputs(seed, name)
        families[name] = (optim.tree_map(lambda p: p.numpy().copy(), fp), fb)
    return gloo_start(tp_gloo_rank, (host, batch, families), "tp:", world=4)


def tp_gloo_finish(seed: int, pending) -> None:
    """The one-card check finished: each mode and each family run on
    the four gloo ranks held within DP_GLOO_REL of the one-process step
    on the card."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import optim
    from repro_torch.train.step import build_train_step, init_state
    t0 = pending[-1]
    got = gloo_join(pending)

    def one_process(cfg, params, batch, optimizer):
        run = RunConfig(optimizer=optimizer, learning_rate=1e-3,
                        microbatches=2)
        state = init_state(cfg, run, optim.tree_map(
            lambda p: p.to(DEVICE, copy=True), params))
        step = build_train_step(cfg, run)
        want = []
        for _ in range(DP_GLOO_STEPS):
            state, m = step(state, {k: v.to(DEVICE) for k, v in
                                    batch.items()})
            want.append({k: float(v) for k, v in m.items()})
        mu = [t.detach().cpu() for t in optim.tree_leaves(
            state["opt"]["mu"])] if "mu" in state["opt"] else None
        return want, [p.detach().cpu() for p in
                      optim.tree_leaves(state["params"])], mu

    from repro_torch.train.optim import lr_schedule
    lr2 = float(lr_schedule(1e-3, total=10_000)(1))     # run_one's step 2

    def hold(key, what, want, want_p, want_mu, attends=True,
             scale=DP_GLOO_SCALE):
        worst_m = worst_p = worst_mu = 0.0
        flips = spread = 0
        for r in got:
            ms, ps, launches, _, mus = r[key]
            check((launches.get("flash_attention", 0) > 0) == attends,
                  f"tp: {what}: flash_attention launches on a rank "
                  f"({launches}), expected {'some' if attends else 'none'}")
            for g, w in zip(ms, want):
                worst_m = max([worst_m] + [
                    abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w])
            for i, (a, b) in enumerate(zip(ps, want_p)):
                off = (a - b).abs() / b.abs().max()
                far = off > DP_GLOO_REL
                if want_mu is not None:
                    mu = want_mu[i].abs()
                    worst_mu = max(worst_mu, float(
                        (mus[i] - want_mu[i]).abs().max() / mu.max()))
                    past = far
                    far = past & ((a - b).abs() > DP_GLOO_REL * b.abs().max()
                                  + 2 * tp_adamw_spread(mus[i], want_mu[i],
                                                        lr2))
                    spread += int((past & ~far).sum())
                    off = torch.where(past & ~far, 0.0, off)
                if want_mu is not None and far.any():
                    check(float(far.float().mean()) < TP_FLIP_FRAC and bool(
                        (mu[far] <= TP_NOISE_REL * mu.max()).all()),
                          f"tp: {what}: {int(far.sum())} of {far.numel()} "
                          f"elements of parameter {i} part from the "
                          f"one-process step by up to {float(off.max()):.3g} "
                          f"of its scale, not all where its first moment is "
                          f"within {TP_NOISE_REL:g} of the largest")
                    flips += int(far.sum())
                    off = off[~far]
                worst_p = max(worst_p, float(off.max()) if off.numel()
                              else 0.0)
        check(worst_m <= DP_GLOO_REL and worst_p <= DP_GLOO_REL
              and worst_mu <= DP_GLOO_REL,
              f"tp: {what} on four gloo ranks differs from the one-process "
              f"step: metrics {worst_m:.3g}, params {worst_p:.3g}, first "
              f"moments {worst_mu:.3g} (bar {DP_GLOO_REL:g})")
        print(f"tp: {what} on four gloo ranks on the card (f32, matrices x "
              f"{scale}, 4 x 64 positions in 2 microbatches, "
              f"{DP_GLOO_STEPS} steps): metrics within {worst_m:.3g} and "
              f"gathered parameters within {worst_p:.3g} of their scale of "
              f"the one-process step on the card (bar {DP_GLOO_REL:g}, "
              f"past it by rank {spread} elements within twice AdamW's "
              f"update spread at the two first moments and "
              f"{flips} past both, each where AdamW's first "
              f"moment is rounding noise, the first moments then within "
              f"{worst_mu:.3g}); "
              f"flash_attention launches per rank "
              f"{[r[key][2].get('flash_attention', 0) for r in got]}; "
              f"{max(r[key][3] for r in got):.1f} s on the ranks",
              flush=True)

    def cut(key, what, needs):
        if key in got[0]:
            return False
        print(f"tp: CUT: {what} not run on four gloo ranks on the card: it "
              f"needs {', '.join(n for n in needs if n in missing)}",
              flush=True)
        return True

    missing = got[0]["missing"]
    if missing:
        print("tp: CUT: gloo lacks on CUDA tensors: " + "; ".join(
            f"{n} ({why})" for n, why in missing.items()), flush=True)
    params, batch = dp_reduced_inputs(seed, DP_GLOO_SCALE)
    want = one_process(dp_reduced_cfg(), params, batch, "adamw")
    for d, m, modes in TP_GLOO_MESHES:
        for mode in modes:
            what = f"({d}, {m}) {mode} (reduced {TRAIN_ARCH}, AdamW)"
            if not cut((d, m, mode), what, TP_NEEDS[mode]):
                hold((d, m, mode), what, *want)
    print("tp: CUT: the families run reduced (d_model 128, 4 q heads, "
          "vocab 512, 4 experts of d 64, 16 SSM heads of 16 at state 16, "
          "zamba2 at 8 layers in 2 super-blocks): mixtral-emlp is reduced "
          "mixtral at 3 experts, a count that divides neither line, so each "
          "expert's expert_mlp dim splits (mixtral's 8 on the production "
          "line of 16); seamless runs at a vocabulary of 510, which "
          "divides by 2 and not by 4, as its 256,206 does", flush=True)
    wants = {}
    for name, arch, _, d, m, mode, optimizer in TP_GLOO_FAMILIES:
        cfg = tp_family_cfg(name)
        what = (f"({d}, {m}) {mode} reduced {name} ({arch}, {optimizer}; "
                f"experts split {cfg.moe.n_experts % m == 0}"
                if cfg.moe else f"({d}, {m}) {mode} reduced {name} "
                f"({arch}, {optimizer}; vocabulary split "
                f"{cfg.vocab % m == 0}") + ")"
        if cut((name, d, m, mode), what, tp_needs(mode, cfg)):
            continue
        if (name, optimizer) not in wants:
            wants[name, optimizer] = one_process(
                cfg, *tp_family_inputs(seed, name), optimizer)
        hold((name, d, m, mode), what, *wants[name, optimizer],
             attends=cfg.family != "ssm",
             scale=TP_GLOO_SCALES.get(name, DP_GLOO_SCALE))
    print(f"tp: the gloo ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_tp(seed: int, count: int, pending=None) -> list:
    """The training step tensor-parallel over processes (ROADMAP Queue A
    item 8: the dense, moe, vlm, encdec, ssm and hybrid families): over
    every card where there are several (returns row
    5-train-tp and the families' flash rows); at one card four gloo
    ranks on the card (``pending``: their ``gloo_start`` where the
    caller started them, else started here; returns no row)."""
    t_phase = time.perf_counter()
    rows = []
    if count >= 2:
        rows = tp_over_cards(seed, count)
    else:
        print("tp: CUT: one card: NCCL takes one card a rank, so the phase "
              "runs four gloo ranks on the card at the reduced f32 llama "
              "and families, not train:'s width over several cards",
              flush=True)
        tp_gloo_finish(seed, pending or tp_gloo_start(seed))
    print(f"tp: all in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


# ------------------------------------------------------------ serve_tp
def serve_run(prefill, decode, params, batch, steps: int, tokens=None):
    """Prefill, then ``steps`` decode steps, each fed the argmax of the
    last logits (greedy) or, with ``tokens`` (steps, rows), those
    tokens: (the logits of each on the host, the tokens fed, the cache,
    the prefill's and each step's seconds, each ended by a device
    synchronise)."""
    def wait(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    wait(logits)
    times = [time.perf_counter() - t0]
    out, fed = [logits.float().cpu()], []
    for i in range(steps):
        tok = (torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
               if tokens is None else tokens[i].to(logits.device))
        fed.append(tok.cpu())
        t0 = time.perf_counter()
        logits, cache = decode(params, tok, cache)
        wait(logits)
        times.append(time.perf_counter() - t0)
        out.append(logits.float().cpu())
    return out, fed, cache, times


def serve_gloo_cfg(run):
    """A SERVE_TP_GLOO_RUNS entry's config: the arch's reduced config in f32
    with the entry's changes."""
    from repro_torch.configs.registry import get_arch
    _, arch, changes, *_ = run
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                               **changes)


def serve_gloo_inputs(seed: int) -> dict:
    """Per SERVE_TP_GLOO_RUNS label its parameters (matrices x
    DP_GLOO_SCALE, as numpy on the host) and its batch of SERVE_TP_ROWS
    rows (a vlm's prefix too)."""
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    from repro_torch.train import optim
    out = {}
    for run in SERVE_TP_GLOO_RUNS:
        label, _, _, _, prompt, *_ = run
        if label in out:
            continue
        cfg = serve_gloo_cfg(run)
        params = optim.tree_map(
            lambda p: (p * DP_GLOO_SCALE if p.dim() >= 2 else p).numpy(),
            init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(
                seed), "float32", device="cpu"))
        rng = np.random.default_rng(seed)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (SERVE_TP_ROWS, prompt)).astype(np.int32))}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.from_numpy(rng.normal(
                0, 0.02, (SERVE_TP_ROWS, cfg.n_prefix_embeds, cfg.d_model))
                .astype(np.float32))
        out[label] = (params, batch)
    return out


def serve_gloo_rank(rank, device, inputs):
    """The one-card rank body: each SERVE_TP_GLOO_RUNS entry on its mesh,
    the rank's chunks of the parameters and its rows of the batch,
    prefill and SERVE_TP_STEPS greedy decode steps with the launch counters
    zeroed just before and read just after; its logits, tokens, cache
    bytes and layout; rank 0 keeps the first flash operands of the
    first run.  One thread a rank."""
    torch.set_num_threads(1)
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataShard, shard_rows
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.sharding import collective
    meshes = {}
    out = {}
    (tally, first), spy = family_flash_spy()
    for i, run in enumerate(SERVE_TP_GLOO_RUNS):
        label, _, _, cache_len, _, d, m, fsdp = run
        if (d, m) not in meshes:
            meshes[d, m] = make_host_mesh(model_parallel=m, device=device)
        mesh, cfg = meshes[d, m], serve_gloo_cfg(run)
        host, batch = inputs[label]
        chunks = zoo.rank_params(cfg, params_from_reference(
            host, device=device), mesh, fsdp=fsdp)
        local = {k: v.to(device) for k, v in shard_rows(
            batch, DataShard(mesh.coords()["data"], d)).items()}
        prefill = zoo.prefill_fn(cfg, cache_len, mesh)
        decode = zoo.decode_fn(cfg, mesh)
        _cuda.reset_launches()
        with spy if i == 0 else contextlib.nullcontext():
            logits, fed, cache, times = serve_run(prefill, decode, chunks,
                                                  local, SERVE_TP_STEPS)
        launches = dict(_cuda.LAUNCHES)
        split = collective.model_of(cache["k"])
        out[i] = {"logits": logits, "tokens": fed, "launches": launches,
                  "seconds": sum(times), "data": mesh.coords()["data"],
                  "bytes": {k: v.numel() * v.element_size()
                            for k, v in cache.items() if k != "pos"},
                  "layout": None if split is None else split.dim}
    out["qkv"] = {key: (n, tuple(t.cpu() for t in first[key]))
                  for key, n in tally.items()} if rank == 0 else None
    return out


def serve_gloo_start(seed: int):
    """The one-card check started: four gloo ranks on the card."""
    return gloo_start(serve_gloo_rank, (serve_gloo_inputs(seed),),
                      "serve_tp:", world=4)


def serve_gloo_finish(seed: int, pending) -> list:
    """The one-card check finished: each run's logits (prefill and every
    step, the ranks' rows joined in data order) within SERVE_TP_GLOO_REL of
    the logits' max |value| of the one-process prefill and decode on
    the card, the greedy tokens equal, every rank of a model line
    holding the same logits, each rank's flash launches one a layer
    (prefill; decode attends in plain torch), its cache bytes equal to
    the dry-run's cache_specs shard bytes on the mesh and its cache
    split as the guard lays it out.  Returns the flash row at the first
    run's rank shape."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.convert import params_from_reference
    from repro_torch.launch.dryrun import cache_specs
    from repro_torch.models import zoo
    from repro_torch.sharding.logical import LogicalMesh, default_rules
    inputs = serve_gloo_inputs(seed)
    wants = {}
    for run in SERVE_TP_GLOO_RUNS:                     # beside the ranks
        label, _, _, cache_len, *_ = run
        cfg = serve_gloo_cfg(run)
        host, batch = inputs[label]
        key = (label, cache_len)
        if key not in wants:
            wants[key] = serve_run(
                zoo.prefill_fn(cfg, cache_len), zoo.decode_fn(cfg),
                params_from_reference(host, device=DEVICE),
                {k: v.to(DEVICE) for k, v in batch.items()}, SERVE_TP_STEPS)
    t0 = pending[-1]
    got = gloo_join(pending)
    for i, run in enumerate(SERVE_TP_GLOO_RUNS):
        label, arch, _, cache_len, prompt, d, m, fsdp = run
        cfg = serve_gloo_cfg(run)
        want, want_tok, want_cache, _ = wants[label, cache_len]
        what = (f"({d}, {m}) reduced {label} ({arch}{', FSDP' if fsdp else ''}"
                f", cache {cache_len}, prompt {prompt})")
        for r in range(4):
            lead = got[r - r % m][i]
            check(all(torch.equal(a, b) for a, b in
                      zip(got[r][i]["logits"], lead["logits"])),
                  f"serve_tp: {what}: rank {r}'s logits differ from its "
                  "model line's first rank's")
        joined = [torch.cat(parts) for parts in zip(
            *(got[k * m][i]["logits"] for k in range(d)))]
        toks = [torch.cat(parts) for parts in zip(
            *(got[k * m][i]["tokens"] for k in range(d)))]
        worst = max(float((a - w).abs().max() / w.abs().max())
                    for a, w in zip(joined, want))
        check(worst <= SERVE_TP_GLOO_REL,
              f"serve_tp: {what}: logits {worst:.3g} of their scale from "
              f"the one-process prefill and decode (bar "
              f"{SERVE_TP_GLOO_REL:g})")
        check(all(torch.equal(a, w) for a, w in zip(toks, want_tok)),
              f"serve_tp: {what}: greedy tokens differ from the one-process "
              "decode's")
        launches = [got[r][i]["launches"].get("flash_attention", 0)
                    for r in range(4)]
        check(launches == [cfg.n_layers] * 4,
              f"serve_tp: {what}: flash_attention launches per rank "
              f"{launches}, expected {cfg.n_layers} (one a layer in prefill)")
        specs = cache_specs(cfg, ShapeCell("serve", cache_len, SERVE_TP_ROWS,
                                           "decode"),
                            LogicalMesh(("data", "model"), (d, m)),
                            default_rules())
        shard = {k: int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
                 * t.element_size() for k, t in specs.items() if t.dim()}
        check(all(got[r][i]["bytes"] == shard for r in range(4)),
              f"serve_tp: {what}: cache bytes {got[0][i]['bytes']} on rank "
              f"0, cache_specs' shard bytes {shard}")
        check(all(got[r][i]["data"] == r // m for r in range(4)),
              f"serve_tp: {what}: ranks off their data coordinates")
        layout = {None: "whole on the line", 2: "kv_seq on model",
                  3: "kv_heads on model"}[got[0][i]["layout"]]
        print(f"serve_tp: {what} on four gloo ranks on the card (f32, "
              f"matrices x {DP_GLOO_SCALE}, {SERVE_TP_ROWS} rows, "
              f"{SERVE_TP_STEPS} greedy steps): logits within {worst:.3g} of "
              f"their scale of the one-process prefill and decode on the "
              f"card (bar {SERVE_TP_GLOO_REL:g}), tokens equal; cache "
              f"{layout}, {sum(shard.values()):,} B a rank as cache_specs "
              f"says; flash_attention launches per rank {launches}; "
              f"{max(got[r][i]['seconds'] for r in range(4)):.2f} s on the "
              f"ranks", flush=True)
    print(f"serve_tp: the gloo ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    (key, (n, qkv)), = list(got[0]["qkv"].items())[:1]
    return serve_f32_row("serve-tp " + SERVE_TP_GLOO_RUNS[0][0], key,
                         tuple(t.to(DEVICE) for t in qkv),
                         got[0][0]["launches"]["flash_attention"])


def serve_f32_row(label, key, qkv, launches) -> dict:
    """The flash kernel at a rank's f32 prefill shape (its share of the q
    and kv heads), on the first operands the rank gave it: within 1e-4
    absolute of flash_attention_ref (the f32 bar of the repo's gpu
    tests), and no further from the f64 answer than the plain version
    plus that; timed beside the plain version, SDPA and flash_work's
    bound at the f32 rate."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    (qs, ks, causal, kv_len, window), (q, k, v) = key, qkv
    b, hq, sq, d = qs
    hk = ks[1]
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                             window=window).double()
    plain, exact = flash_refs(q, k, v, kv_len, causal, window)
    err = float((got - plain).abs().max())
    off, plain_off = (float((x - exact).abs().max()) for x in (got, plain))
    check(err <= 1e-4 and off <= plain_off + 1e-4,
          f"serve_tp: flash_attention {label}: max |diff| from plain "
          f"{err:.3g}, from the f64 answer {off:.3g} (plain {plain_off:.3g})")
    # the rows past kv_len are ops.flash_attention's padding to 128: the
    # function's query rows are kv_len, as SDPA's below
    live, flops, nbytes = flash_work(b, hq, hk, d, kv_len, kv_len, causal,
                                     window, itemsize=q.element_size())
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, :kv_len], k[:, :, :kv_len], v[:, :, :kv_len],
        is_causal=causal, enable_gqa=True)
    print(f"serve_tp: flash_attention {label} at ({b}, {hq}, {sq}, {d}) x "
          f"({b}, {hk}, {ks[2]}, {d}) f32 causal={causal} kv_len={kv_len} "
          f"window={window}: {launches} launches on rank 0's path; max "
          f"|diff| from plain {err:.3g}, from the f64 answer {off:.3g} "
          f"(plain {plain_off:.3g})", flush=True)
    return kernel_row(
        f"flash_attention {label}", launches, err,
        lambda: fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                   window=window), 10,
        lambda: flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                    window=window), 3,
        nbytes, flops, library=sdpa, flop_per_s=hw.PEAK_FLOPS_F32,
        kernel="flash_attention",
        note=f"a (data, model) rank's share of the heads, reduced f32")


def serve_cache_fill(cache, rows: range, seed: int) -> None:
    """Fill a k / v cache (this rank's chunk, or a whole one) with the
    cache of the global ``rows``: each (layer, row) slab of every slot
    and kv head N(0, 1) from its own seed, the rank keeping its chunk of
    the slab, so any layout holds the same values."""
    from repro_torch.sharding import collective
    for name, off in (("k", 0), ("v", 1)):
        x = cache[name]
        split = collective.model_of(x)
        n_layers, _, t, hk, hd = x.shape
        full = (split.full if split is not None and split.dim == 2 else t,
                split.full if split is not None and split.dim == 3 else hk)
        gen = torch.Generator(device=x.device)
        for i in range(n_layers):
            for j, g in enumerate(rows):
                gen.manual_seed(((seed * 2 + off) * 1_000 + i) * 100_000 + g)
                slab = torch.randn(full + (hd,), generator=gen,
                                   device=x.device, dtype=torch.float32)
                if split is not None:
                    slab = slab.narrow(split.dim - 2, split.index * split.size,
                                       split.size)
                x[i, j].copy_(slab)
            del slab


def serve_split_qkv():
    """A context under which the q, k and v projections sum their
    contraction in two halves (two products added): the projections
    rounded another way, as a rank's products of its heads' columns
    round otherwise than the whole matmul's.  At random fan_in weights
    attention scores reach the hundreds, so softmax turns such a
    rounding into a change of the output far above the dtype's eps."""
    from repro_torch.models import layers, transformer

    def qkv(p, xn, cfg, cos, sin):
        h = xn.shape[-1] // 2

        def proj(w):
            return (torch.einsum("bsd,dhk->bshk", xn[..., :h], w[:h])
                    + torch.einsum("bsd,dhk->bshk", xn[..., h:], w[h:]))
        rot = int(cfg.hd * cfg.partial_rotary)
        return (layers.apply_rope(proj(p["wq"]), cos, sin, rot),
                layers.apply_rope(proj(p["wk"]), cos, sin, rot),
                proj(p["wv"]))
    return mock.patch.object(transformer, "_qkv", qkv)


def serve_floor_decode():
    """A context under which a decode step rounds another way: the
    split projections (serve_split_qkv) and the partial softmax of
    layers.decode_partial over the whole cache, normalised in f32 (the
    ranks' merge of one part), in place of the reference's weights cast
    to the cache's dtype before P V."""
    from repro_torch.models import layers, transformer

    def f32_weights(q, k, v, pos, window=None):
        m, l, o = layers.decode_partial(q, k, v, pos, 0, k.shape[1], window)
        return (o / l[..., None]).to(v.dtype).reshape(q.shape)
    return serve_patches(serve_split_qkv(), mock.patch.object(
        transformer, "decode_attention", f32_weights))


def serve_floor_prefill(chunk: int):
    """A context under which prefill rounds another way: the split
    projections (serve_split_qkv) and the chunked plain attention
    (``chunk`` rows and keys a block) in place of the kernel (tp:'s
    noise floor)."""
    from repro_torch.models import layers, transformer

    def plain(q, k, v, cfg):
        ck = min(chunk, max(1, q.shape[1] // 4))
        return layers.chunked_attention(q, k, v, causal=True,
                                        window=cfg.sliding_window,
                                        chunk_q=ck, chunk_k=ck)
    return serve_patches(serve_split_qkv(),
                         mock.patch.object(transformer, "attention", plain))


@contextlib.contextmanager
def serve_patches(*patches):
    """Every patch in ``patches`` entered when the block is (not when
    this is called), left when it ends."""
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield


def serve_routes(routes: list, force=None):
    """A context under which every MoE dispatch group appends to
    ``routes`` its tokens' own top-k experts (sorted), the gap between
    the k-th and the (k+1)-th router logit and each token's largest
    |router logit|, on the host; with ``force`` (another run's
    ``routes``, group by group) the group is dispatched to those experts
    instead, at their own logits (so the gates are this run's)."""
    from repro_torch.models import moe
    real = moe._dispatch_one_group
    want = iter(force or ())

    def spy(xf, logits, m, cap, gate=None, experts=None):
        v, i = torch.topk(logits, m.top_k + 1, dim=-1)
        routes.append((torch.sort(i[:, :m.top_k], dim=-1).values.cpu(),
                       (v[:, m.top_k - 1] - v[:, m.top_k]).cpu(),
                       logits.abs().amax(dim=-1).cpu()))
        if force is not None:
            idx = next(want)[0].to(logits.device)
            logits = torch.full_like(logits, float("-inf")).scatter(
                1, idx, logits.gather(1, idx))
        return real(xf, logits, m, cap, gate, experts)
    return mock.patch.object(moe, "_dispatch_one_group", spy)


def serve_route_flips(got, want) -> tuple:
    """(tokens whose own top-k in ``got`` differs from ``want``'s, the
    largest gap of such a token in ``want`` relative to its largest
    |router logit|): two serve_routes lists, group by group."""
    n, worst = 0, 0.0
    for (a, _, _), (b, gap, top) in zip(got, want):
        diff = (a != b).any(dim=-1)
        if diff.any():
            n += int(diff.sum())
            worst = max(worst, float((gap[diff] / top[diff]).max()))
    return n, worst


def serve_dist(got, want) -> float:
    """max |got - want| over max |want|, over a list of logits."""
    return max(float((a - w).abs().max() / w.abs().max())
               for a, w in zip(got, want))


def serve_nccl_rank(rank, device, seed, runs):
    """The W-card rank body: per ``runs`` entry (label, config, meshes
    ((data, model) a mesh), prefill (rows, tokens), decode (rows, cache
    slots) or None, the one-card rows (prefill, decode)), the rank first
    holds rank 0's one-card prefill and decode of the first rows (and
    each with its attention rounded another way: the noise floor), then
    on each mesh: the prefill of the global rows split over the data
    axis, timed, then again under torch.profiler; and, for a decode
    cell, a cache of the decode rows at its last SERVE_TP_STEPS slots
    (serve_cache_fill; pos = slots - SERVE_TP_STEPS), SERVE_TP_STEPS decode
    steps fed the same seeded tokens, the last under torch.profiler.
    Without a decode cell the prefill's own cache takes SERVE_TP_STEPS
    steps; a MoE's run then goes twice: timed on its own routing, then
    untimed with its tokens dispatched to rank 0's one-card routes
    (serve_routes), whose logits are compared.  Matrices x
    SERVE_TP_SCALES[label] where given.  Peak memory a card beside
    estimate_memory; rank 0 keeps the first flash operands of the first
    mesh's prefill."""
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.data.pipeline import DataShard, shard_rows
    from repro_torch.kernels import _cuda
    from repro_torch.launch.dryrun import cache_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer, zoo
    from repro_torch.models.params import init_params
    from repro_torch.roofline.analysis import estimate_memory
    from repro_torch.sharding.logical import default_rules
    from repro_torch.train import optim
    on_card = device.type == "cuda"

    def wait():
        if on_card:
            torch.cuda.synchronize(device)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)

    def peak():
        return torch.cuda.max_memory_allocated(device) if on_card else 0

    out = {}
    meshes = {}
    kept = None
    for label, cfg, mesh_list, (pb, ps), dec, (one_p, one_d) in runs:
        gen = torch.Generator(device=device).manual_seed(seed)
        whole = init_params(zoo.model_specs(cfg), gen, cfg.dtype,
                            device=device)
        if label in SERVE_TP_SCALES:
            whole = optim.tree_map(
                lambda p: p * SERVE_TP_SCALES[label] if p.dim() >= 2 else p,
                whole)
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (pb, ps))
                                  .astype(np.int32))
        steps = torch.from_numpy(rng.integers(
            0, cfg.vocab, (SERVE_TP_STEPS, dec[0] if dec else pb))
            .astype(np.int32))
        res = {"one": None}
        if rank == 0:
            # the one-card prefill and decode of the first rows, and the
            # same with the attention rounded another way
            one = {}
            batch = {"tokens": tokens[:one_p].to(device)}
            if dec is None:
                # decode reads the prefill's cache: the floor rounds both;
                # a MoE's floor takes the one-card run's routes
                for tag, ctxs in (("one", ()), ("floor", (
                        serve_floor_prefill(TP_FLOOR_CHUNK),
                        serve_floor_decode()))):
                    routes = []
                    with contextlib.ExitStack() as stack:
                        for ctx in ctxs + (serve_routes(
                                routes, one.get("one_routes")),):
                            stack.enter_context(ctx)
                        lg, _, _, _ = serve_run(
                            zoo.prefill_fn(cfg, ps + SERVE_TP_STEPS),
                            zoo.decode_fn(cfg), whole, batch, SERVE_TP_STEPS,
                            steps[:, :one_p])
                    one[tag + "_prefill"], one[tag + "_decode"] = \
                        lg[0], lg[1:]
                    one[tag + "_routes"] = routes
                    free()
            else:
                for tag, ctx in (("one", contextlib.nullcontext()),
                                 ("floor",
                                  serve_floor_prefill(TP_FLOOR_CHUNK))):
                    with ctx:
                        lg, _ = zoo.prefill_fn(cfg, ps + SERVE_TP_STEPS)(
                            whole, batch)
                    one[tag + "_prefill"] = lg.float().cpu()
                    free()
                rows, slots = dec
                for tag, ctx in (("one", contextlib.nullcontext()),
                                 ("floor", serve_floor_decode())):
                    cache = transformer.init_cache(cfg, one_d, slots,
                                                   device=device)
                    serve_cache_fill(cache, range(one_d), seed)
                    cache["pos"] = slots - SERVE_TP_STEPS
                    lgs = []
                    with ctx:
                        for i in range(SERVE_TP_STEPS):
                            lg, cache = zoo.decode_fn(cfg)(
                                whole, steps[i, :one_d].to(device), cache)
                            lgs.append(lg.float().cpu())
                    one[tag + "_decode"] = lgs
                    del cache
                    free()
            res["one"] = one
        # every rank dispatches a MoE's tokens to rank 0's one-card routes
        # (its own are kept and read against them): the logits then part
        # by rounding alone, not by a top-k flipped at a near-tie
        forced = [res["one"]["one_routes"] if rank == 0 and dec is None
                  else None]
        dist.broadcast_object_list(forced, src=0)
        dist.barrier()
        for d, m in mesh_list:
            if (d, m) not in meshes:
                meshes[d, m] = make_host_mesh(model_parallel=m, device=device)
            mesh = meshes[d, m]
            coord = mesh.coords()["data"]
            chunks = zoo.rank_params(cfg, whole, mesh)
            free()
            local = {"tokens": shard_rows({"tokens": tokens},
                                          DataShard(coord, d))["tokens"]
                     .to(device)}
            cache_len = ps + SERVE_TP_STEPS if dec is None else ps
            prefill = zoo.prefill_fn(cfg, cache_len, mesh)
            decode = zoo.decode_fn(cfg, mesh)

            def one_pass(timed: bool):
                """Prefill, then SERVE_TP_STEPS decode steps: (what the
                pass read, its last cache); ``timed`` adds the ms, the
                profiled calls and the peaks."""
                nonlocal kept
                (tally, first), spy = family_flash_spy()
                peak_reset()
                _cuda.reset_launches()
                wait()
                t0 = time.perf_counter()
                with spy:
                    lg, cache = prefill(chunks, local)
                wait()
                ms_prefill = (time.perf_counter() - t0) * 1e3
                launches = dict(_cuda.LAUNCHES).get("flash_attention", 0)
                got = {"prefill": lg[:one_p].float().cpu() if coord == 0
                       else None, "ms_prefill": ms_prefill,
                       "launches": launches, "peak_prefill": peak()}
                if rank == 0 and kept is None:
                    kept = next(iter(first.items()))
                    kept = (kept[0], tally[kept[0]], kept[1], launches)
                del lg
                if dec is None:
                    step_rows = range(coord * (pb // d),
                                      (coord + 1) * (pb // d))
                else:
                    del cache
                    free()
                    wall, busy, top = device_busy(
                        lambda: prefill(chunks, local), None)
                    got["prefill_busy"] = (wall, busy, nccl_kinds(top))
                    free()
                    rows, slots = dec
                    per = rows // d
                    step_rows = range(coord * per, (coord + 1) * per)
                    cache = transformer.init_cache(cfg, rows, slots,
                                                   device=device, mesh=mesh)
                    serve_cache_fill(cache, step_rows, seed)
                    cache["pos"] = slots - SERVE_TP_STEPS
                peak_reset()
                lgs, times = [], []
                for i in range(SERVE_TP_STEPS):
                    tok = steps[i, step_rows.start:step_rows.stop].to(device)
                    if timed and i == SERVE_TP_STEPS - 1:
                        box = {}

                        def last():
                            box["out"] = decode(chunks, tok, cache)
                        wall, busy, top = device_busy(last, None)
                        lg, cache = box["out"]
                        got["decode_busy"] = (wall, busy, nccl_kinds(top))
                    else:
                        wait()
                        t0 = time.perf_counter()
                        lg, cache = decode(chunks, tok, cache)
                        wait()
                        times.append((time.perf_counter() - t0) * 1e3)
                    lgs.append(lg[:one_d].float().cpu() if coord == 0
                               else None)
                got["decode"] = lgs
                got["ms_steps"] = times
                got["peak_decode"] = peak()
                return got, cache

            if cfg.moe is not None and dec is None:
                # timed on the port's own routing; then, untimed, the
                # logits compared with the tokens dispatched to the
                # one-card routes (the spy copies each group's top-k to
                # the host)
                got, cache = one_pass(True)
                del cache
                free()
                routes = []
                with serve_routes(routes, forced[0]):
                    held, cache = one_pass(False)
                got.update(prefill=held["prefill"], decode=held["decode"],
                           routes=routes if rank == 0 else None)
            else:
                got, cache = one_pass(True)
            got["cache_bytes"] = sum(v.numel() * v.element_size()
                                     for k, v in cache.items() if k != "pos")
            cell = ShapeCell("serve", dec[1] if dec else cache_len,
                             dec[0] if dec else pb, "decode")
            specs = cache_specs(cfg, cell, mesh, default_rules())
            got["cache_specs"] = sum(
                int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
                * t.element_size() for t in specs.values() if t.dim())
            rules = default_rules()
            est = {}
            for kind, (rws, sq) in (("prefill", (pb, ps)),
                                    ("decode", dec or (pb, cache_len))):
                est[kind] = estimate_memory(
                    cfg, RunConfig(), zoo.model_specs(cfg),
                    ShapeCell("serve", sq, rws, kind), mesh, rules,
                    cache_abstract=specs if kind == "decode" else None
                )["total"]
            got["estimate"] = est
            del cache, chunks
            free()
            res[d, m] = got
        out[label] = res
        del whole
        free()
    if rank == 0:
        key, n, qkv, launches = kept
        out["row"] = serve_bf16_row(f"serve-tp {runs[0][0]}", key, qkv,
                                    launches)
    dist.barrier()
    return out


def serve_bf16_row(label, key, qkv, launches) -> dict:
    """The flash kernel at a rank's bf16 prefill shape, on the first
    operands the first mesh's prefill gave rank 0's kernel: held to the
    plain version and the f64 answer (flash_verdict, the dense rows'
    strict bar) on the first SERVE_TP_VERDICT_ROWS query rows of the first
    sequence (causal: those rows read no later key, so the kernel's
    output there is the output on the cut operands; the f64 answer of a
    whole 32,768-token head does not fit), timed at the whole shape
    beside the plain version, SDPA and flash_work's bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import flash_work
    (qs, ks, causal, kv_len, window), (q, k, v) = key, qkv
    b, hq, sq, d = qs
    hk = ks[1]
    cut = min(SERVE_TP_VERDICT_ROWS, kv_len)
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                             window=window)[:1, :, :cut]
    ok, err, readings = flash_verdict(got, *flash_refs(
        q[:1, :, :cut], k[:1, :, :cut], v[:1, :, :cut], cut, causal,
        window))
    check(ok, f"serve_tp: flash_attention {label}: {readings}")
    del got
    live, flops, nbytes = flash_work(b, hq, hk, d, kv_len, kv_len, causal,
                                     window, itemsize=q.element_size())
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)
    print(f"serve_tp: flash_attention {label} at ({b}, {hq}, {sq}, {d}) x "
          f"({b}, {hk}, {ks[2]}, {d}) bf16 causal={causal} window={window}: "
          f"{launches} launches on rank 0's prefill; on the first {cut} "
          f"query rows of sequence 0 against flash_attention_ref and the "
          f"f64 answer: {readings}", flush=True)
    return kernel_row(
        f"flash_attention {label}", launches, err,
        lambda: fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                   window=window), 5,
        lambda: flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                    window=window), 1,
        nbytes, flops, library=sdpa, flop_per_s=hw.PEAK_FLOPS_BF16,
        kernel="flash_attention",
        note="a (1, W) rank's share of the q and kv heads in prefill")


def serve_report(got, world, runs) -> None:
    """Each run on each mesh against rank 0's one-card prefill and
    decode of the first rows: the logits' distance (max |diff| over
    max |value|) within TP_FLOOR_X x the noise floor's (the one-card
    run with its attention rounded another way), or within
    SERVE_TP_GLOO_REL, the floor itself below SERVE_TP_FLOOR_CAP (the
    bar then holds the greedy tokens too: a token can flip only where
    the one-card logits' top two part by less than twice the distance,
    so their agreement is printed, not checked again); a SERVE_TP_TIMED
    run's logits are only finite and read, not held; flash launches one
    a layer; cache
    bytes equal to cache_specs' shard bytes; the times, tokens/s, NCCL
    ms by collective, busy share and peak a card beside
    estimate_memory."""
    for label, cfg, mesh_list, (pb, ps), dec, (one_p, one_d) in runs:
        one = got[0][label]["one"]
        floor_p = serve_dist([one["floor_prefill"]], [one["one_prefill"]])
        floor_d = serve_dist(one["floor_decode"], one["one_decode"])
        for d, m in mesh_list:
            what = f"{label} on ({d}, {m})"
            x = got[0][label][d, m]
            flips = ""
            if cfg.moe is not None and dec is None:
                n, gap = serve_route_flips(x["routes"], one["one_routes"])
                check(gap <= SERVE_TP_ROUTE_GAP,
                      f"serve_tp: {what}: {n} tokens' own top-k experts "
                      f"differ from the one-card run's, one at a top-k gap "
                      f"of {gap:.3g} of its largest router logit (near-tie "
                      f"bar {SERVE_TP_ROUTE_GAP:g})")
                fn, fgap = serve_route_flips(one["floor_routes"],
                                             one["one_routes"])
                tokens = sum(r[0].shape[0] for r in one["one_routes"])
                flips = (f"; the ranks' own top-k differs from the one-card "
                         f"run's at {n} of {tokens} routed tokens (the noise "
                         f"floor's run at {fn}), each a near-tie (gap at most "
                         f"{gap:.3g} of the largest router logit; floor "
                         f"{fgap:.3g}); both dispatched to the one-card "
                         f"routes")
            dist_p = serve_dist([x["prefill"]], [one["one_prefill"]])
            dist_d = serve_dist(x["decode"], one["one_decode"])
            pairs = list(zip([x["prefill"]] + x["decode"],
                             [one["one_prefill"]] + one["one_decode"]))
            agree = float(np.mean([
                torch.equal(torch.argmax(a[:, -1], -1),
                            torch.argmax(w[:, -1], -1))
                for a, w in pairs]))
            check(all(bool(torch.isfinite(a).all()) for a, _ in pairs),
                  f"serve_tp: {what}: logits not finite")
            bar_p = max(TP_FLOOR_X * floor_p, SERVE_TP_GLOO_REL)
            bar_d = max(TP_FLOOR_X * floor_d, SERVE_TP_GLOO_REL)
            held = label not in SERVE_TP_TIMED
            if held:
                check(max(floor_p, floor_d) <= SERVE_TP_FLOOR_CAP,
                      f"serve_tp: {what}: noise floors {floor_p:.4g}, "
                      f"{floor_d:.4g} of the logits' scale, above "
                      f"{SERVE_TP_FLOOR_CAP:g}: a bar drawn from them "
                      f"would not catch a fault")
                check(dist_p <= bar_p and dist_d <= bar_d,
                      f"serve_tp: {what}: prefill logits {dist_p:.4g} and "
                      f"decode logits {dist_d:.4g} of their scale from the "
                      f"one-card run (bars {bar_p:.4g}, {bar_d:.4g}: "
                      f"{TP_FLOOR_X:g} x the noise floors {floor_p:.4g}, "
                      f"{floor_d:.4g})")
            launches = [g[label][d, m]["launches"] for g in got]
            check(launches == [cfg.n_layers] * world,
                  f"serve_tp: {what}: flash_attention launches per rank "
                  f"{launches}, expected {cfg.n_layers}")
            check(all(g[label][d, m]["cache_bytes"]
                      == g[label][d, m]["cache_specs"] for g in got),
                  f"serve_tp: {what}: cache bytes "
                  f"{[g[label][d, m]['cache_bytes'] for g in got]}, "
                  f"cache_specs' {x['cache_specs']}")
            ms_p = max(g[label][d, m]["ms_prefill"] for g in got)
            step = float(np.median([t for g in got
                                    for t in g[label][d, m]["ms_steps"]]))
            rows = dec[0] if dec else pb
            peaks = [max(g[label][d, m]["peak_prefill"],
                         g[label][d, m]["peak_decode"]) for g in got]
            line = (f"serve_tp: {what} {str(cfg.dtype)} (NCCL, {world} "
                    f"cards): prefill "
                    f"{pb} x {ps} tokens in {ms_p:.1f} ms "
                    f"({pb * ps / ms_p * 1e3:,.0f} tokens/s), "
                    f"{x['launches']} flash launches a rank; decode "
                    f"{rows} rows" + (f" at {dec[1]:,} cache slots"
                                      if dec else "")
                    + f": {step:.2f} ms a step (median of the timed steps "
                    f"of every rank; {rows / step * 1e3:,.0f} tokens/s); "
                    f"logits from the one-card run of the first rows"
                    + ("" if held else " (read, not held: the floors sit "
                       "at the logits' scale)")
                    + f": prefill {dist_p:.4g}, decode {dist_d:.4g} (noise "
                    f"floors {floor_p:.4g}, {floor_d:.4g}), greedy tokens "
                    f"of the first rows equal at {agree:.3f} of the calls; "
                    f"cache {x['cache_bytes']:,} B a rank as cache_specs "
                    f"says{flips}")
            for kind in ("prefill_busy", "decode_busy"):
                if kind in x:
                    wall, busy, kinds = x[kind]
                    line += (f"; rank 0's profiled {kind[:-5]}: {wall:.1f} "
                             f"ms wall, device busy {busy / wall:.3f}, NCCL "
                             f"ms by collective {kinds}")
            est = x["estimate"]
            line += (f"; peak a card {max(peaks):,} B (rank 0 prefill "
                     f"{x['peak_prefill']:,}, decode {x['peak_decode']:,}) "
                     f"beside estimate_memory's prefill {est['prefill']:,}, "
                     f"decode {est['decode']:,}")
            print(line, flush=True)


def serve_over_cards(seed: int, world: int) -> list:
    """At count >= 2: W NCCL ranks, one card each: SERVE_TP_ARCH at full
    width at SERVE_TP_LAYERS layers on (1, W) (and (2, 2) at W = 4), in
    bf16 (timed) and in f32 (SERVE_TP_F32, held), and SERVE_TP_MIXTRAL's
    window on (1, W), each against rank 0's one-card run
    (serve_nccl_rank, serve_report); returns the flash row at the rank
    shape."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.ranks import run_ranks
    t0 = time.perf_counter()
    full = get_arch(SERVE_TP_ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_TP_LAYERS)
    meshes = ((1, world),) + (((2, world // 2),) if world == 4 else ())
    arch, layers, rows, prompt = SERVE_TP_MIXTRAL
    mix = get_arch(arch)
    mcfg = dataclasses.replace(mix, n_layers=layers, dtype="float32")
    f32_rows, f32_prompt, f32_one = SERVE_TP_F32
    runs = (("llama", cfg, meshes, SERVE_TP_PREFILL, SERVE_TP_DECODE,
             SERVE_TP_ONE_ROWS),
            ("llama-f32", dataclasses.replace(cfg, dtype="float32"), meshes,
             (f32_rows, f32_prompt), None, (f32_one, f32_one)),
            ("mixtral", mcfg, ((1, world),), (rows, prompt), None,
             (rows, rows)))
    print(f"serve_tp: CUT: {SERVE_TP_ARCH} runs {SERVE_TP_LAYERS} of "
          f"{full.n_layers} layers at full width (d_model {cfg.d_model}, "
          f"{cfg.n_q_heads} q / {cfg.n_kv_heads} kv heads, vocab "
          f"{cfg.vocab}) in bf16; prefill_32k's cell cut to "
          f"{SERVE_TP_PREFILL[0]} of 32 rows of {SERVE_TP_PREFILL[1]:,} "
          f"tokens; "
          f"decode_32k's {SERVE_TP_DECODE[0]} rows at {SERVE_TP_DECODE[1]:,} "
          f"cache slots, the cache filled with N(0, 1) keys and values "
          f"(not a prefill of 4M tokens) and {SERVE_TP_STEPS} decode steps "
          f"from slot {SERVE_TP_DECODE[1] - SERVE_TP_STEPS}; the one-card "
          f"comparison at the first {SERVE_TP_ONE_ROWS[0]} prefill and "
          f"{SERVE_TP_ONE_ROWS[1]} decode rows; meshes (data, model) "
          f"{meshes}; timed, its logits read and not held (their noise "
          f"floor sits at their scale)", flush=True)
    print(f"serve_tp: CUT: llama-f32 is the same {SERVE_TP_LAYERS} layers "
          f"in f32 with the matrices x {DP_GLOO_SCALE}, {f32_rows} rows of "
          f"a {f32_prompt:,}-token prompt and {SERVE_TP_STEPS} decode steps "
          f"on its cache, on {meshes}, held to the one-card run of the "
          f"first {f32_one} rows", flush=True)
    print(f"serve_tp: CUT: {arch} runs {layers} of {mix.n_layers} layers "
          f"at full width in f32, {rows} rows of a {prompt:,}-token "
          f"prompt "
          f"(window {mix.sliding_window}: prefill rolls the last "
          f"{mix.sliding_window} positions into the ring; decode slots "
          f"{prompt % mix.sliding_window}-"
          f"{(prompt + SERVE_TP_STEPS - 1) % mix.sliding_window} cross the "
          f"{mix.sliding_window // world}-slot shard boundary) on (1, "
          f"{world})", flush=True)
    got = run_ranks(serve_nccl_rank, world, (seed, runs), timeout_s=1500)
    serve_report(got, world, runs)
    print(f"serve_tp: over {world} cards in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return [got[0]["row"]]


def phase_serve_tp(seed: int, count: int) -> list:
    """LM prefill and decode over ranks (ROADMAP Queue A item 10(a), the
    dense, moe and vlm families): over every card where there are
    several (serve_over_cards); at one card four gloo ranks on the card
    at the reduced f32 configs (serve_gloo_finish).  Returns the flash
    row at a rank's prefill shape."""
    t_phase = time.perf_counter()
    if count >= 2:
        rows = serve_over_cards(seed, count)
    else:
        print("serve_tp: CUT: one card: NCCL takes one card a rank, so the "
              "phase runs four gloo ranks on the card at reduced f32 "
              "configs, not llama3-8b's width over several cards",
              flush=True)
        rows = [serve_gloo_finish(seed, serve_gloo_start(seed))]
    print(f"serve_tp: all in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows


# --------------------------------------------------------------- retrieval
def phase_retrieval(seed: int):
    """The port's twin of examples/retrieval_serving.py steps 1-4."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import BatchedLIMS, LIMSIndex, MetricSpace
    from repro_torch.core.metrics import dist_one_to_many
    from repro_torch.kernels import _cuda
    from repro_torch.models.transformer import forward_seq
    cfg = ModelConfig(**ENCODER)
    params = lm_model(cfg, seed)
    rng = np.random.default_rng(0)
    anchors = rng.integers(0, cfg.vocab, (100, 32))
    corpus_tokens = np.repeat(anchors, 50, axis=0)
    for i in range(5_000):
        corpus_tokens[i, rng.integers(0, 32)] = rng.integers(0, cfg.vocab)
    q_tokens = anchors[:16].copy()
    for i in range(16):
        q_tokens[i, rng.integers(0, 32)] = rng.integers(0, cfg.vocab)

    def encode(tokens):
        t = torch.from_numpy(tokens.astype(np.int32)).to(DEVICE)
        x, _, _ = forward_seq(params, t, cfg)
        return x.mean(dim=1)[:, :32].double().cpu().numpy()

    sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    corpus = encode(corpus_tokens)
    t_enc = time.perf_counter() - t0
    q_emb = encode(q_tokens)
    check(np.isfinite(corpus).all(), "retrieval: embeddings not finite")
    t0 = time.perf_counter()
    ix = LIMSIndex(MetricSpace(corpus, "l2"), n_clusters=100, m=3, n_rings=20)
    t_ix = time.perf_counter() - t0
    bx = BatchedLIMS(ix, device=DEVICE)
    bx.knn_query_batch(q_emb, 5)
    sync()
    t0 = time.perf_counter()
    ids, ds = bx.knn_query_batch(q_emb, 5)
    t_q = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    for name in ("flash_attention", "pdist", "rankeval", "pdist_rankeval"):
        check(counts[name] > 0, f"retrieval: {name} was not launched")
    for i, q in enumerate(q_emb):
        h_ids, h_ds = ix.knn_query(q, 5)[:2]
        d_all = dist_one_to_many(q, corpus, "l2")
        top = np.argsort(d_all, kind="stable")[:5]
        check(np.array_equal(ds[i], h_ds)
              and np.array_equal(np.sort(ids[i]), np.sort(h_ids)),
              f"retrieval: query {i} differs from the host index")
        check(np.array_equal(ds[i], d_all[top])
              and np.array_equal(np.sort(ids[i]), np.sort(top)),
              f"retrieval: query {i} differs from the f64 brute-force scan")
    print(f"retrieval: {cfg.name} (4 layers, d 256, f32) embedded "
          f"{len(corpus):,} docs of 32 tokens to d=32 in {t_enc:.3f} s on "
          f"the card; host LIMSIndex(K=100, m=3, N=20) in {t_ix:.2f} s; "
          f"BatchedLIMS 16 kNN (k=5) in {t_q * 1e3:.2f} ms; all 16 "
          f"identical to the host index and to the f64 brute-force scan; "
          f"launches {json.dumps(counts)}", flush=True)
    d32_bodies(torch.from_numpy(q_emb.astype(np.float32)).to(DEVICE),
               torch.from_numpy(corpus.astype(np.float32)).to(DEVICE), seed)


def d32_bodies(q_emb, corpus, seed: int) -> None:
    """pdist and range_filter at d = 32 through their register body and
    through the generic one (Points<0>, which the C entry points take for
    operands that are not 16-B aligned): equal bit for bit, and timed at
    the retrieval example's (16, 5,000) and at a shape that moves bytes."""
    from repro_torch.kernels import pdist as _pdist
    from repro_torch.kernels import range_filter as _rf

    def offset(t):          # the same values, 4 bytes past a 16-B boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    big = (torch.randn(B, 32, generator=g, device=DEVICE),
           torch.randn(1 << 20, 32, generator=g, device=DEVICE))
    for q, p in ((q_emb, corpus), big):
        p_gen = offset(p)
        d2 = _pdist.pdist(q, p)
        check(torch.equal(d2, _pdist.pdist(q, p_gen))
              and torch.equal(d2, _pdist.pdist_plain(q, p)),
              f"retrieval: pdist's d = 32 bodies differ at {tuple(q.shape)} "
              f"x {tuple(p.shape)}")
        r2 = d2.kthvalue(max(1, p.shape[0] // 100), dim=1).values
        m, c = _rf.range_filter(q, p, r2)
        m_g, c_g = _rf.range_filter(q, p_gen, r2)
        m_p, c_p = _rf.range_filter_plain(q, p, r2)
        check(all(torch.equal(a, b) for a, b in
                  ((m, m_g), (c, c_g), (m, m_p), (c, c_p))),
              f"retrieval: range_filter's d = 32 bodies differ at "
              f"{tuple(q.shape)} x {tuple(p.shape)}")
        del d2, m, c, m_g, c_g, m_p, c_p
        it = 200 if p.shape[0] < 100_000 else 20
        t = [time_ms(lambda: _pdist.pdist(q, p), it),
             time_ms(lambda: _pdist.pdist(q, p_gen), it),
             time_ms(lambda: _rf.range_filter(q, p, r2), it),
             time_ms(lambda: _rf.range_filter(q, p_gen, r2), it)]
        print(f"retrieval: d=32 at ({q.shape[0]}, {p.shape[0]}): pdist "
              f"register body {t[0]:.4f} ms, generic body {t[1]:.4f} ms; "
              f"range_filter register {t[2]:.4f} ms, generic {t[3]:.4f} ms "
              f"(wrapper ms, CUDA events; bit for bit equal)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="GaussMix rows (default 1,000,000)")
    ap.add_argument("--batches", type=int, default=3,
                    help="query batches of 64 per kind (default 3)")
    ap.add_argument("--profile", action="store_true",
                    help="also print where one batch's time goes")
    ap.add_argument("--linf-n", type=int, default=LINF_N,
                    help=f"Skewed rows of the builder's L-infinity part "
                         f"(default {LINF_N:,}; the other parts run at --n)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM phases' weights and tokens")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run only the device and sharded phases")
    ap.add_argument("--frontend-only", action="store_true",
                    help="run only the device and frontend phases")
    ap.add_argument("--families-only", action="store_true",
                    help="run only the device, build and families phases")
    ap.add_argument("--train-only", action="store_true",
                    help="run only the device, build and train phases")
    ap.add_argument("--dp-only", action="store_true",
                    help="run only the device, build and dp phases")
    ap.add_argument("--fsdp-only", action="store_true",
                    help="run only the device, build and fsdp phases")
    ap.add_argument("--tp-only", action="store_true",
                    help="run only the device, build and tp phases")
    ap.add_argument("--serve-tp-only", action="store_true",
                    help="run only the device, build and serve_tp phases")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
    from repro_torch.core.snapshot import LIMSSnapshot
    from repro_torch.data.datasets import gauss_mix

    os.environ["REPRO_ROWS_DTYPE"] = "off"     # the lp: phase sets it
    # the tuning table: the shipped defaults, no user cache from HOME
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), f"chip_smoke-tune-{os.getpid()}.json")
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    from repro_torch import env
    for line in env.describe().splitlines():
        print(f"env: {line}", flush=True)
    only = (args.families_only or args.train_only or args.dp_only
            or args.fsdp_only or args.tp_only or args.serve_tp_only
            or args.sharded_only or args.frontend_only)
    built = in_background(phase_build)
    if only:
        built()
    if args.families_only:
        kernels = phase_families(args.seed)
        finish(kernels, t_start, smi, name, count)
        return 0
    if args.train_only:
        finish([phase_train(args.seed)], t_start, smi, name, count)
        return 0
    if args.dp_only:
        phase_dp(args.seed, count)
        finish([], t_start, smi, name, count)
        return 0
    if args.fsdp_only:
        finish([phase_fsdp(args.seed, count)], t_start, smi, name, count)
        return 0
    if args.tp_only:
        finish(phase_tp(args.seed, count), t_start, smi, name, count)
        return 0
    if args.serve_tp_only:
        finish(phase_serve_tp(args.seed, count), t_start, smi, name, count)
        return 0

    X = gauss_mix(args.n, D, seed=0)
    t0 = time.perf_counter()
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=K_CLUSTERS, m=M,
                   n_rings=RINGS, degree=DEGREE)
    t_host = time.perf_counter() - t0
    sizes = [ci.n for ci in ix.clusters]
    print(f"main: GaussMix n={args.n} d={D}; host LIMSIndex K={ix.K} m={M} "
          f"N={RINGS} degree={DEGREE} built in {t_host:.2f} s; "
          f"cluster rows max={max(sizes)} mean={np.mean(sizes):.1f}",
          flush=True)
    batches = make_queries(X, np.random.default_rng(1), args.batches)
    host_range, host_knn = host_answers(ix, batches, show=not only)
    if args.sharded_only or args.frontend_only:
        spilled = spill_main(LIMSSnapshot.build(ix, device=DEVICE))
        try:
            if args.sharded_only:
                phase_sharded(X, ix, batches, host_range, host_knn,
                              spilled, count)
            if args.frontend_only:
                phase_frontend(X, ix, batches, host_range, host_knn,
                               spilled)
        finally:
            shutil.rmtree(spilled["path"], ignore_errors=True)
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return 0

    built()
    mark("main", t_start)
    counts, shapes, snap, rates = phase_main(
        X, ix, batches, host_range, host_knn, LIMSSnapshot, QueryExecutor)
    # main's host index as main served it, for the frontend phase (the
    # builder's retrain and the serving phases change ``ix``)
    ix_main = copy.deepcopy(ix)
    mark("E", t_start)
    phase_error_bound(ix, snap)
    mark("kernels", t_start)
    kernels = phase_kernels(ix, snap, batches, counts, shapes)
    mark("lp", t_start)
    kernels += phase_lp(ix, batches, host_range, host_knn, rates)
    mark("knn_loop", t_start)
    kernels.append(phase_knn_loop(snap, batches, host_knn, counts))
    mark("tune", t_start)
    phase_tune(ix, snap, batches, host_range, host_knn)
    phase_roof(snap, batches[0])
    if args.profile:
        phase_profile(QueryExecutor(snap), batches)
    spilled = spill_main(snap)
    del snap
    # the builder parts' host builds and host query checks run in worker
    # processes, the host builds all started first
    mark("builder", t_start)
    pool = multiprocessing.get_context("spawn").Pool(BUILDER_WORKERS)
    try:
        t0 = time.perf_counter()
        parts = (("l1", args.n, "skewed", D, True),
                 ("linf", args.linf_n, "skewed", D, True),
                 ("l1", WIDE_N, "gaussmix", WIDE_D, False),
                 ("linf", WIDE_N, "gaussmix", WIDE_D, False))
        hosts = [pool.apply_async(builder_host, part[:4]) for part in parts]
        ixd = phase_builder_l2(X, ix, t_host, batches, host_range, host_knn)
        if args.linf_n != args.n:
            print(f"builder: CUT: the L-infinity part (c) runs at "
                  f"n={args.linf_n}, not {args.n}", flush=True)
        pending = []
        for (metric, n, data, d, rows), host in zip(parts, hosts):
            row, queries = phase_builder_lp(metric, n, pool, host,
                                            data=data, d=d, rows=rows)
            if rows:
                kernels.append(row)
            pending.append(queries)
        phase_retrain(X, ix, ixd, batches)
        builder_query_results(pending)
        pool.close()
        print(f"builder: all parts in {time.perf_counter() - t0:.1f} s",
              flush=True)
        mark("serving", t_start)
        phase_serving(X, ix, batches)
        mark("paged", t_start)
        phase_paged(X, ix, batches, host_range, host_knn, spilled)
        mark("sharded", t_start)
        phase_sharded(X, ix, batches, host_range, host_knn, spilled, count)
        mark("frontend", t_start)
        phase_frontend(X, ix_main, batches, host_range, host_knn, spilled)
    finally:
        pool.terminate()
        pool.join()
        # the spill (~0.3 GB at the default size) lives in TMPDIR
        shutil.rmtree(spilled["path"], ignore_errors=True)
    del X, ix, ix_main, ixd, batches, host_range, host_knn
    torch.cuda.empty_cache()
    mark("baselines", t_start)
    phase_baselines(args.n)

    mark("lm", t_start)
    t0 = time.perf_counter()
    phase_lm_consistency(args.seed)
    launches, qkv = phase_lm_serving(args.seed)
    kernels.append(phase_flash_kernel(launches, qkv))
    del qkv
    phase_retrieval(args.seed)
    print(f"lm: and retrieval: in {time.perf_counter() - t0:.1f} s",
          flush=True)
    mark("families", t_start)
    kernels += phase_families(args.seed)
    # at one card the gloo ranks of dp: (b) and fsdp: (d) start before
    # train: (b) and run beside its checkpoint IO (the card idles
    # between its steps); dp: (a)'s profiled step and fsdp: (c)'s steps
    # wait for them
    mark("train", t_start)
    ranks = {}

    def start_ranks():
        ranks["dp"] = dp_gloo_start(args.seed)
        ranks["fsdp"] = fsdp_gloo_start(args.seed)
        ranks["tp"] = tp_gloo_start(args.seed)
    kernels.append(phase_train(args.seed, start_ranks if count < 2
                               else None))
    mark("dp", t_start)
    phase_dp(args.seed, count, ranks.get("dp"),
             (ranks["fsdp"], ranks["tp"]) if ranks else ())
    mark("fsdp", t_start)
    kernels.append(phase_fsdp(args.seed, count, ranks.get("fsdp")))
    mark("tp", t_start)
    kernels += phase_tp(args.seed, count, ranks.get("tp"))
    mark("serve_tp", t_start)
    kernels += phase_serve_tp(args.seed, count)
    finish(kernels, t_start, smi, name, count)
    return 0


def finish(kernels, t_start, smi, name, count) -> None:
    """The closing lines: every row complete, the kernels' JSON line,
    the nvidia-smi line and the result."""
    for k in kernels:
        check(all(v is not None for key, v in k.items()
                  if key != "library_ms"), f"incomplete row {k}")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


def mark(phase: str, t_start: float) -> None:
    """A line that says when ``phase`` starts, in seconds since the
    script's start (the whole run's breakdown by phase)."""
    print(f"time: {phase} starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)


def in_background(fn):
    """Start ``fn()`` in a thread.  Returns a function that waits for it
    and raises what it raised (a failed check too)."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            out["error"] = e
    t = threading.Thread(target=run, name=fn.__name__, daemon=True)
    t.start()

    def wait():
        t.join()
        if "error" in out:
            raise out["error"]
    return wait


if __name__ == "__main__":
    sys.exit(main())
