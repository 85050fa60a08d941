#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device paths once, on one card: the streaming-RAG
serving path, the same pipeline through the port's own engine (``pw.run``), the
contrastive trainer, the other model families (the ViT image embedder of multimodal
RAG, the cross-encoder reranker and the local decoder chat), the relational operators,
the xpack's RAG document pipeline (``VectorStoreServer`` over BGE-base, and the
adaptive RAG question answerer over it), its ``rag_evals`` harness, the table
operations (the expression namespaces, deduplicate, sort, having, ``apply_async``), the
temporal operators (Nexmark queries 5, 7 and 8), ``pw.iterate`` (PageRank), two
programs killed and resumed under persistence, the in-process connectors (RAG served
over HTTP from an object store, SQLite into the card's groupby, Delta Lake) and the
message buses (RAG fed and answered through Kafka, a Debezium change stream into the
card's groupby, NATS) and the databases (RAG fed by Airbyte and answered into Postgres,
an Iceberg table streamed into the card's groupby and kept live in Postgres, MongoDB and
Elasticsearch), all over local sockets; every
engine path runs through the engine's C++ host kernels (``pathway_tpu_torch/native``),
and each workload runs once more on their Python branches to compare.

    python3 chip_smoke.py

Phases, each printing one JSON line (and each number beside the card's name and power
limit):

1. device: the card's name, count and power limit; no CUDA means exit 1.
2. build: every ``pathway_tpu_torch/csrc/*.cu`` compiled with ``nvcc`` for ``sm_90a``,
   with its build time and ``-Xptxas -v`` register, shared-memory and spill lines; any
   spill fails. sass: the tensor-core instructions (HMMA, HGMMA) of each kernel's bf16
   instances, counted in ``cuobjdump -sass``; every bf16 instance of the forward, dQ and
   dK/dV must have some. native_build: ``pathway_tpu_torch/native/enginecore.cpp``
   built with ``g++`` into ``_build/``: its seconds, ``g++ --version``, the host CPU
   from ``/proc/cpuinfo``; a failed build fails the run.
3. kernel: the flash-attention kernel against its plain PyTorch version on the card at
   the main path's shape and at the edge shapes (head dim 64, t not a multiple of the
   tile, multi-tile t, no mask, a fully masked row, the ViT-B/16 call: t = 197, d = 64,
   no mask, the BGE-base embed call of the vector store: [256, 128, 12, 64] with 10-34
   real keys) and the tile-skipping patterns (real keys only in the last 16-key tile or
   past position 128, live and masked tiles in turn, a dead sequence among live ones);
   then its time at the serving, the train, the vision and the BGE-base serving shape
   against its bound, the plain version and
   ``scaled_dot_product_attention`` (timed here only, as a yardstick; the port never
   calls it).
4. train_kernel: the flash-attention backward's two kernels (dQ, dK/dV) against their
   plain PyTorch version on the card at the train shape, the edge shapes and the
   tile-skipping patterns (masked keys' dK, dV and dbias exact zeros); the fused route
   (``flash_attention_qkv``, whose backward writes dq, dk and dv into one dqkv buffer)
   against the split route's dq, dk and dv at the train shape, bit for bit, and against
   the plain versions; then each kernel's time against its bound and its plain version,
   and the backward of ``scaled_dot_product_attention`` with the same mask (its forward
   and backward less its forward; timed here only, as a yardstick).
5. checkpoint: the committed ``tests/fixtures/tiny_bert`` checkpoint through the port's
   importer and the kernel in f32 reproduces its golden embeddings.
6. relational: ``bench_dataflow.py``'s workloads at its own sizes through the port's
   Scope and Scheduler (groupby_sum: 1M rows by ``i % 1024``, sum and count;
   wordcount: 1M rows over 4,096 string keys; join_inner and join_multikey: 500,000 x
   50,000 rows on one and two int keys; incremental_update: after the 1M-row load, 100
   commits of 1,000 retractions and 1,000 inserts), each once on the host kernels
   (``PATHWAY_TPU_DEVICE_OPS=0``, the spec) and once on the card after a warm-up:
   rows/s each way, the operators' calls and ns, the routes the batches took, the
   segment stage kernels' launches in the timed card run (each of ``SEGMENT_PATH_KERNELS``
   where the workload has a float sum, the int kernel alone for wordcount) and peak
   device memory. The card's output state must be the host's bit for bit (keys equal,
   floats through their int64 views), and every batch must take the device route. A
   profiler window over one 1M-row device groupby commit; ``t_dadd``, the latency of a
   dependent float64 add (a 2^20-add chain in one thread); then ``segment_reduce`` alone
   on float64 sums at [1M rows, 1,024 | 8 | 1M groups], on int64 diffs at [1M, 1,024 |
   4,096] (no partition launched), on groupby_sum's own commit (an int64 count and a
   float64 sum in one call), on one of incremental_update's 2,000-row commits and on a
   Zipf-skewed (s = 1.1) float64 index over 65,536 groups, each against its plain
   version (bit for bit), ``np.add.at`` and ``np.bincount``, ``index_add_`` per column
   (timed only, on CUDA events and on device busy time), its byte bound and its
   chain floor (the longest run times ``t_dadd``), with the whole dispatch (upload,
   kernels, fetch) timed apart; the device matcher at the join_inner shape against the
   host matcher, on the host clock and between CUDA events, against its byte bound.
   Then native (relational_engine): groupby_sum and join_inner, the card's operators
   forced, with the host kernels and under ``PATHWAY_TPU_DISABLE_NATIVE=1``.
7. relational_engine: one ``pw.run`` program through the Table API at
   ``device_ops_leg``'s size: 200,000 rows through ``pw.io.python`` into
   ``groupby(k).reduce(k, s=sum(v), c=count())``, ``join_left`` with a 1,024-row table
   from ``pw.debug.table_from_rows``, ``filter``, ``concat_reindex`` with a second
   stream of 50,000 rows joined inner to the same table, ``pw.io.subscribe``; the
   subscriber's state must equal NumPy's answer, the groupby's commits and the inner
   join's batches must take the device route (the left join takes its row path, as in
   the JAX package).
   sharded: workers in one process, ``pw.run(threads=N)``. (a) relational_engine's
   program at 2 and 4 workers: the state must be NumPy's answer and the ``threads=1``
   run's bits, every worker's groupby must reduce on the card; rows/s beside
   ``threads=1``'s, the segment launches and the exchange's deliveries by plane (elided,
   host, collective: 0, the device plane not being ported). (b) BASELINE #1's RAG at 2
   workers, 4,096 docs and 32 queries, the index as engine_pipeline builds it: every doc
   by the device route, every query answered once with its own doc at top-1, recall@10
   >= 0.99 against exact f32 search over the vectors the index received, the forward's
   launches per worker (each worker embeds its shard). (c) the persistence tutorial's
   word count (100,000 words in 10 files) under operator snapshots at 2 workers over
   half the files, resumed at 4 over all of them: the snapshot re-shards, the counts
   are ``np.unique``'s and every worker's groupby runs on the card after the resume.
   processes: workers in several processes, each a fresh interpreter from
   ``pathway_tpu_torch.cli.spawn`` (``--processes-child``) with its own CUDA context,
   over the authenticated TCP mesh; every process writes its own kernel launches,
   exchange planes and bytes on the wire. One 2-process mesh runs, one ``pw.run``
   after another: (a) relational_engine's program at 2 x 1 and 2 x 2, process 0's sink
   NumPy's answer and the ``threads=1`` run's bits, every process's groupby on the
   card; (b) BASELINE #1's RAG (4,096 docs, 32 queries, the 1M-slot index on process 0
   only), every query answered once with its own doc at top-1, recall@10 >= 0.99,
   both processes launching the forward, every doc reaching the index once (process
   1's as host rows); (c) the word count (100,000 words in 10 files, one a commit)
   under operator snapshots. Two more meshes run (c) beside it: one with process 1
   killed at commit 3 by a fault plan and recovered under the supervisor, fed the same
   files in lockstep, one rescaled 2 -> 3 through ``cli rescale`` at commit 3 on files
   of its own from the phase's start; each sink the fault-free run's (the rescaled one's after each
   commit's partial counts are cancelled), the counts ``np.unique``'s, the leader's
   metrics showing the recovery and the rescale, every groupby on the card after the
   resume.
8. main_path: MiniLM-L6 at full width (seeded weights) embeds 20,000 generated docs in
   256-doc commits into a 1,048,576-slot f32 index on the card, 980,000 seeded unit
   vectors are bulk-added so 1,000,000 rows are live, and 64 queries are embedded and
   searched one per commit. Reports docs/s, query p50/p95, peak memory and the kernels'
   launches (the forward's must be 6 per embed call, the backward's 0). Checks that every key's slot holds its
   input vector bit for bit, and recall@10 against exact f32 search in a host index
   built from the same inputs through its own ``add``; then one 256-doc batch through
   the kernel against the plain attention (cosine, beside the readings of two broken
   attentions), and profiler windows over a few more ingest commits and queries:
   device time by kernel and the device's idle share.
9. engine_pipeline: ``bench.py::pipeline_leg``'s program through the port's engine:
   20,000 docs through ``pw.io.python`` (100 ms autocommit), the embedder UDF (lazy
   device rows, 256-doc chunks) and ``DataIndex`` into a 1,048,576-slot index, 64
   as-of-now queries once every doc has reached the doc subscriber, two subscribe
   sinks, with the async device pipeline on (``configure()`` before every ``pw.run``:
   its controller persists across runs in a process). Reports docs/s (beside
   main_path's), query p50/p95, recall@10 against exact f32 search over the streamed
   embeddings, the kernels' launches, the rows the index took by its device and host
   routes, device memory and the pipeline's stats; checks that every doc arrives and
   takes the device route, every query is answered and finds its own doc, no device
   batch outlives the run, the subscriber's rows equal the index's stored vectors bit
   for bit, the pipeline completed commits, has none in flight after the run and left
   no completion thread. engine_async_parity: 2,048 docs fed as 8 commits of 256,
   once with the synchronous commit boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) and once
   with the async pipeline; the doc subscriber's events and the index's stored rows
   must be the same bits; per mode docs/s, commits, embed chunk sizes, launches, the
   controller's stats, occupancy, the deepest in-flight count and the dispatch-to-
   completion p50/p99; then a GIL check (two commits in flight while the completion
   thread waits on a copy held behind card work, and the scheduler thread keeps
   running). engine_host_cost: a profiled ``pw.run`` of 2,048 docs with the scheduler's
   probe on, beside the device-path loop over the same docs (wall and device-busy ms,
   idle share, per-node batches, insertions, deletions and time, and the engine's own
   host time per 256 docs: in-commit wall less the batch-apply node's time).
   observability: (a) the same program (20,000 docs, 64 queries, 1,048,576 slots) with
   the tracer on every 4th commit (``TRACER.configure(enabled=True, sample=4)``, as
   ``bench.py``'s pipeline leg runs it) and the sampling profiler at its default 50 Hz,
   exporting into a temporary directory: every doc and query answered, recall@10 >=
   0.99 and every query its own doc; each trace's four critical-path buckets summing to
   its wall within 4e-6 s (a clamped trace keeps no host time; clamped traces are
   counted and printed), the Chrome trace valid, the spans holding ``ingest-wait``,
   ``knn-update``, ``knn-search``, ``op`` and ``sink``; the latency histogram's count
   equal to the sinks' rows, the connectors' entries equal to docs plus queries, 64 KNN
   queries and at least 20,000 KNN updates; the exported profile valid with ``cuda:0``'s
   allocator in it, and the registry's exposition (``full_snapshot`` of the run's
   scheduler) valid with ``pathway_device_memory_bytes{device="cuda:0"}``; traced docs/s
   beside engine_pipeline's untraced docs/s, the median bucket shares, the profile's
   phase totals. (b) groupby_sum's 1M-row commit on the card (``PATHWAY_TPU_DEVICE_OPS=1``)
   untraced, then traced at every commit: ``device_ops.segment_reduce`` in the trace's
   device bucket, its device seconds above 0, the output's bits unchanged. (c)
   ``bench_dataflow.py``'s fused_chain shape (8 stages, 20,000 base rows, 60 commits of
   1,000 changes) through the port's Scope and Scheduler, 4 runs, each gate in a child
   process (``chip_smoke.py --overhead-gate trace|profile|null``; ``null`` runs both
   ways off): two graphs whose commits alternate, the gate on for one of them
   (alternating between runs), the collector off inside a run; the overhead is the mean
   over the runs of each run's on-over-off total, printed beside the best-of-4 and the
   per-commit median readings; the tracer at 1/16 and the profiler at 50 Hz each at
   most 5% over off (the profiler's reading retried once past the gate); then
   a streamed ``pw.run`` whose UDF raises on one row (an error row) and whose sink
   raises in the same commit: the flight dump holds ``run_start``, ``commit``,
   ``error`` and ``run_error`` and the id of the trace in flight. The phase prints its
   seconds.
   watch: (a) the same program at 10,000 docs with 256-doc paced commits under
   ``pw.run(monitoring_level=ALL if rich imports else NONE, with_http_server=True,
   monitoring_server_port=<a free port>)`` with the profiler, the timeseries loop at
   0.1 s, the telemetry sampler at 0.5 s and two SLOs (``WATCH_SLO``: an ingest p95
   latency bound of 1e-6 s that must burn, a 1 row/s floor on the connectors' entries
   that must not), while a thread scrapes ``/metrics`` every 0.25 s and, once ingest
   ends, ``/timeseries`` (the index, a family, a bad window), ``/requests`` and
   ``/profile``: every doc and query answered, recall@10 >= 0.99 and every query its
   own doc; at least 10 scrapes while docs embed, every body a valid exposition,
   ``pathway_commits_total`` never falling, the first scrape after the monitor synced
   the last doc showing 20,000 entries for the doc connector; the family's points
   (>= 5) never falling, the bad window 400; ``/profile`` valid with ``cuda:0``'s
   allocator, ``/requests`` JSON; one ``slo_burn`` event and one breach, both the
   latency SLO's; a process sample with RSS and an operator of >= 20,000 insertions; no
   watch thread alive after the run and its port bindable again. Watched docs/s beside
   engine_pipeline's, scrape and tick p50/p99, which of ``rich``, ``psutil``,
   ``aiohttp`` and ``requests`` import. (b) the metrics plane's cost on fused_chain
   (``--overhead-gate metrics``: probe stats, ``StatsMonitor(ALL).on_commit``,
   ``observe_n``, a flight event a commit) at most 5%, retried once. (c) two children
   (``chip_smoke.py --lockwatch-child <dir>``, one with ``PATHWAY_TPU_LOCKWATCH=1``)
   run (a)'s program at 4,096 docs and 16 queries with every background thread on
   (the endpoint and a scraper, the timeseries loop, the profiler, the telemetry
   sampler, tracing at every 4th commit, the async device pipeline): the watched child
   installs the watcher before torch's locks, records no cycle and writes no report,
   counts acquisitions of the port's metrics, timeseries and device-pipeline locks, and
   answers every query with the plain child's top-10 doc ids; their walls printed, not
   gated. The phase prints its seconds.
   connectors: (a) rest_rag, the same program served over HTTP: its 20,000 docs read by
   ``pw.io.s3.read(format="json")`` from a ``DictObjectStore`` that a feeder thread fills
   with 40 JSON-lines objects of 500 while the run is live, the embedder and DataIndex
   on the card, 64 queries POSTed by 8 client threads (``urllib``) to a
   ``pw.io.http.rest_connector`` route on a free port once every doc has reached the doc
   subscriber, the run wired as the reference's ``BaseRestServer.run`` wires it
   (``GraphRunner()``, ``attach(result, runner)``, ``runner.run()`` on a thread), the
   answers also sent through ``pw.io.http.write`` to an in-process ``http.server``
   collector; docs/s (the first object put to the last doc at the subscriber), request
   p50/p95 on the client's clock, the store's polls and ms a poll, recall@10 against
   exact f32 search over the subscriber's vectors, the forward's launches, peak device
   memory; every doc by the device route, every request 200 with its own doc at top-1,
   recall@10 >= 0.99, each answer at the collector once (and its retraction once),
   ``/_schema`` valid JSON naming the route, the port closed after the run. (b) sqlite:
   relational_engine's groupby (``groupby(k).reduce(k, s=sum(v), c=count())``) over
   200,000 rows read by ``pw.io.sqlite.read`` from a database file, the groupby forced
   onto the card, then 10 rounds of 1,000 UPDATEs, 1,000 DELETEs and 1,000 INSERTs from
   another connection; after the load and every round the subscriber's state must equal
   NumPy's groupby over a ``SELECT`` of the table exactly, and every groupby commit take
   the device route; rows/s, each round's rescan seconds, the segment kernels' launches.
   (c) deltalake: where pyarrow imports, (b)'s final state through
   ``pw.io.deltalake.write`` and back through ``pw.io.deltalake.read`` in a second
   ``pw.run``, equal to it; else the line says ``"pyarrow absent"``.
   buses, over a ``FakeKafkaBroker`` and a ``FakeNatsServer`` on local ports (the port's
   own Kafka and NATS wire code; no client library, nothing downloaded): (a)
   kafka_rag, the same program fed and answered through Kafka: a feeder produces the
   20,000 docs as JSON to ``docs`` in 4 record batches while ``pw.io.kafka.read``
   reads them, the embedder and DataIndex on the card over 1,000,000 live rows (main
   path's 980,000 bulk vectors put into the index as it is built), then, once every
   doc has reached the doc subscriber, 64 queries (each its doc less the last word)
   produced one at a time to ``queries``, answered as of now and written by
   ``pw.io.kafka.write(format="json", key="qid")`` to ``answers``, which a
   ``KafkaWireClient`` fetches; the run ends when the two read transports are closed.
   docs/s (the first fetch with docs to the last doc at the subscriber), the answer
   latency from produce to fetch (p50, p95); every query answered exactly once under
   its key, its own doc at top-1, recall@10 of 1.0 against a ``HostKnnIndex`` over the
   same 1,000,000 rows, every row by the device route, 6 forward launches an embed
   call. (b) debezium: a Postgres Debezium topic with a 50,000-row snapshot (``op:
   "r"``) in 10 record batches, then 10 rounds of 1,000 ``u`` (before and after
   images), 1,000 ``d`` and 1,000 ``c`` envelopes with their key payloads, read by
   ``pw.io.debezium.read`` into the count and sum groupby over 1,088 keys with the
   device operators forced; after the snapshot and every round the subscriber's state
   must equal NumPy's exactly, and every groupby commit take the device route. (c)
   nats: ``pw.io.nats.write`` publishes (b)'s groupby update stream, which a
   ``NatsConnection`` subscriber on the script's thread folds; its final state must
   equal (b)'s. The phase prints each leg's seconds, the bytes that crossed each broker
   and the peak device memory.
   databases, over a ``FakePostgresServer`` (SCRAM-SHA-256), ``FakeMongoServer``,
   ``FakeElasticsearchServer`` (Basic auth) and ``FakeIcebergRestServer`` on local ports
   and an Airbyte-protocol source script the phase writes to a temporary directory (the
   port's own wire code; no client library): (a) airbyte_rag, the same program fed by
   ``pw.io.airbyte.read(execution_type="local")`` in two incremental syncs of 10,000
   docs, the second resuming from the first one's STATE, into the 1,000,000-row index,
   64 queries (each its doc less the last word) pushed one at a time once every doc has
   reached the doc subscriber, the answers written by ``pw.io.postgres.write`` (the
   update log) over the v3 wire; docs/s (the first RECORD's ``emitted_at`` to the last
   doc at the subscriber), each sync's seconds, the answer latency from a query's
   arrival to its COMMIT on the server (p50, p95); every doc embedded once, each query
   one row in the server's committed table, its own doc at top-1 and recall@10 of 1.0
   against exact f32 search (on the card) over the docs received and the bulk vectors,
   6 forward launches an embed call. (b) iceberg_groupby: (b) of buses' source table
   (1,088 keys, a 50,000-row start, 10 rounds of 1,000 updates, 1,000 deletes and 1,000
   inserts) committed by an outside ``IcebergWriter`` over a ``RestCatalog`` on the
   script's thread, one snapshot for the start and one a round, read by
   ``pw.io.iceberg.read(mode="streaming")`` (``id`` the primary key) into the count and
   sum groupby over 1,088 keys with the device operators forced, its result written by
   ``pw.io.postgres.write_snapshot(primary_key=["k"])``, ``pw.io.mongodb.write`` and
   ``pw.io.elasticsearch.write``; after the start and every round the server's committed
   Postgres table must equal NumPy's state exactly, at the end the Mongo and ES update
   logs folded by (time, diff) must equal it too, and every groupby commit take the
   device route; rows/s, each round's seconds from its Iceberg commit to its Postgres
   COMMIT, the statements, commits, inserts and ``_bulk`` requests.
10. train: ``make_train_step(minilm_l6())`` at full width (seeded weights) takes 20 AdamW
   steps on one batch of 1,024 (query, positive) pairs of 128 tokens (a doc's first
   3-8 words, and the doc). Reports the per-step ms, pairs/s, peak memory, the loss
   curve (which must fall and stay finite) and each kernel's launches (which must be
   12 a step: 6 layers x 2 embed calls); a profiler window over two more steps gives
   device time by kernel and the device's idle share, and shows that no concatenation
   of dq, dk and dv (autograd of the qkv split) runs. Then one parity step at 128
   pairs from the same initial weights: the loss and each parameter's gradient through
   the kernels against the plain forward and backward through the same
   ``autograd.Function``, and the same reading with a deliberately broken backward
   (delta left out), which must fall below the bar.
11. vision_parity: one 64-image batch of 224-px pixels through ``ImageEmbedder``'s
   CLIP ViT-B/16 tower (seeded, full width) with the kernel (12 launches) and with the
   plain attention, the embeddings within the bf16 bar; ``normalize_u8`` on the card
   against the host's ``preprocess_image`` within 1e-6; the forward's time against
   its FLOP bound. multimodal_pipeline: ``bench.py::multimodal_leg`` through
   ``pw.run`` (512 PNG images of 64x64, 16 noisy queries, top-1 from a 1,024-slot
   index): images/s, the noisy-query top-1, launches (12 per embed call); every
   answer must be the top-1 of an exact f32 host search over the embeddings the
   subscriber received; a second, profiled run gives the device's idle share inside
   commits.
12. rerank: ``bench.py::reranker_leg``, the MiniLM-L6 cross-encoder reranker over 256
   pairs in a 3 s loop: pairs/s, launches per call (6), a profiler window; one batch's
   scores with the kernel against the plain attention; one ``pw.run`` of the same pairs
   as a two-column UDF, whose scores must be the direct call's on the same chunks.
13. decode: ``bench.py::decode_leg``, the Mistral-7B shape with seeded bf16 weights
   (after the earlier phases' index and models are freed): greedy decode of a
   128-token prompt of ones, prefill ms, per-step ms, tokens/s, HBM utilisation
   against the 4.24 ms byte bound of a step, peak memory, a profiler window over decode
   steps; checks: two greedy runs agree, ``top_k=1`` sampling gives the greedy tokens
   (up to a tie of the top logits), sampled rows are independent of the batch.
14. chat_engine: eight prompts through ``PipelineChat("mistral-7b")`` in ``pw.run`` with
   the decode phase's weights; every reply must be the tokenizer's decode of a direct
   ``greedy_generate`` on the same left-padded batch.
15. vector_store: ``bench.py::vector_store_leg`` (BASELINE config #2) through
   ``pw.run``: 3,000 docs with ``_metadata={"path": ...}`` through ``pw.io.python``
   into a ``VectorStoreServer`` over ``EncoderEmbedder("BAAI/bge-base-en-v1.5")`` at
   full width (768 hidden, 12 layers, 12 heads, bf16, seeded, 128-token buckets,
   256-doc chunks) and a 4,096-slot index, then 16 queries of docs' own texts with k =
   10, one at a time. Reports docs/s, query p50/p95 (and each query's ms), peak memory,
   the forward's launches (12 per embed call) and the groupby's device calls; checks
   that every query is answered, each top-1 is its own doc, each answer's hits and
   dists are the exact f32 host search's over the vectors the index received (dist = 1
   - cos within 1e-5; neighbours closer than that may trade places) and every doc takes
   the device route. A profiled run of 768 docs gives the device's idle share in
   commits.
16. rag: ``AdaptiveRAGQuestionAnswerer`` over the same store program with the decode
   phase's chat (the Mistral-7B shape): 4 prompts in one commit, whose expansion loops
   run at once on the async executor's worker threads; every prompt must be answered,
   each reply must equal the chat's direct batch-1 reply to ``prompts.prompt_qa`` of
   the first two retrieved docs (the seeded chat never says "No information found.",
   checked), and no event-loop thread may outlive the run.
17. rag_evals: BASELINE config #5's ``rag_evals`` harness. ``RagEvaluator`` over
   ``BaseRAGQuestionAnswerer(search_topk=2)`` and a ``DocumentStore`` of the same 3,000
   docs (a static table) over the vector store's BGE-base and a 4,096-slot index, on
   256 samples labelled here (a doc's text as the question, its first three words as
   the answer, the doc as the source) with an oracle chat keyed on the question (exact
   match, token F1 and hit rate must be 1.0, none missing), then on the first 16 with
   the decode phase's chat, handed one prompt a call (each answer must be the chat's
   direct batch-1 reply to ``prompt_qa`` of the same retrieved docs, hit rate 1.0, none
   missing); both reports, each run's seconds, the forward's launches (12 per embed
   call).
18. table_ops: one streamed ``pw.run`` of 100,000 seeded rows in 20 commits through the
   expression namespaces (``.str``, ``.dt``, ``.num``), ``deduplicate`` (4,096
   instances), ``sort`` (1,024 instances), ``having`` and a groupby (count and sum) over
   the deduplicated rows on the card's segment reduction, with a 4,096-row stream
   through ``apply_async`` and ``await_futures``; every output equal to a plain Python /
   NumPy computation; rows/s and the segment kernels' launches.
19. temporal: Nexmark queries 5 (a sliding 10 s window every 2 s per auction, count
   and sum of the price), 7 (the highest bid of each tumbling 10 s window, exactly once)
   and 8 (persons and the auctions they open in the same tumbling 10 s window, a
   ``window_join``) and an interval join of bids to their auction, over 50,000 events
   of Beam's generator (1 : 3 : 46 persons, auctions and bids at 1,000 events/s of
   event time) as one streamed ``pw.run`` through ``pw.io.python`` in 10 commits; once
   on the host kernels and once on the card, both equal to a plain Python computation
   exactly and to each other; Q7 retracts nothing and Q5's groupby reduces every commit
   on the card. Reports events/s, the commits, the segment kernels' launches, the
   matcher calls and each query's rows.
20. iterate: ``pw.stdlib.graphs.pagerank`` (20 rounds at most) through one ``pw.run``
   over a Graph500 Kronecker graph of scale 11 (2,048 vertices, 32,768 edges) in two
   commits of a StreamGenerator table (90% of the edges, then the rest); once on the
   host kernels and once on the card: the ranks after each commit bit for bit equal,
   within 1e-9 of a NumPy power iteration with the same rounding and rounds; the
   rounds' groupbys on the card's segment reduction and their inner joins on the
   matcher. Reports seconds and rounds per commit and edges/s per round.
21. optimizer: the graph optimizer (pushdown, fusion, elision marks) and the
   measurement-driven placement, over relational_engine's program, table_ops' at a
   quarter of its depth (50,000 rows in 5 commits) and ``bench_dataflow.py``'s
   incremental_update (the 1M-row load, 100 commits of +-1,000 rows), each in three
   modes: spec (``PATHWAY_TPU_OPTIMIZE=0``, ``PATHWAY_TPU_DEVICE_OPS=0``), forced
   (optimizer on, ``=1``) and auto (optimizer on, unset). Every output equal to the
   spec's bit for bit; per program and mode rows/s, ``optimizer_stats()``,
   ``POLICY.decisions()``, the residency plane's h2d/d2h bytes per commit (equal to the
   operators' upload and fetch tensors' bytes), the segment kernels' launches and the
   matcher's calls; in auto mode incremental_update's groupby probed on both sides; no
   resident batch outlives a commit; ``optimizer_stats()`` of engine_pipeline's graph.
22. persistence: two programs under persistence, each in PERSISTING (input journals) and
   OPERATOR_PERSISTING (operator snapshots), three ways: fault-free, in a child process
   (``chip_smoke.py --persistence-child``) that SIGKILLs itself after half its input
   files' commits and that commit's checkpoint, and resumed over the killed run's files
   and store. ``persistence_rag``: engine_pipeline's program (MiniLM-L6, DataIndex over
   1,048,576 slots) with 10,000 docs read from 20 JSON-lines files by
   ``pw.io.jsonlines.read(persistent_id="docs")``, one file a commit, then 64 as-of-now
   queries; ``persistence_wordcount``: the Pathway persistence tutorial's
   ``pw.io.plaintext.read`` -> groupby count -> ``pw.io.csv.write`` over 100,000 words
   of 4,096 keys in 10 files, the groupby on the card (both cut from 20,000 docs and
   250,000 words for the processes phase's time). Checks: every doc stored once,
   every query answered with the exact f32 search's hits, recall@10 against the
   fault-free run >= 0.99; under operator snapshots the restored index on the card and
   equal to the snapshot's bits, no doc embedded twice and no word read twice; the word
   counts (the csv log, resumed under one ``PATHWAY_RUN_ID``) equal to ``np.unique``'s
   in every run; the groupby's device route on every commit after the resume. A fifth
   word-count run under operator snapshots is killed between two interval snapshots
   (none forced) and resumed from the older one: its folded sink file equal to the
   fault-free run's, the words read again counted. Reports docs/s and rows/s, journal bytes, events replayed and replay seconds, snapshot bytes
   and write seconds, restore seconds (the index's upload among them) and the time to
   recover.
23. native: each workload with the C++ host kernels and once more on their Python
   branches (``PATHWAY_TPU_DISABLE_NATIVE=1``), at the depths of ``NATIVE_*``: table_ops
   (25,000 rows in 5 commits), temporal (10,000 Nexmark events in 2 commits), iterate
   (PageRank at scale 9), serving (1,024 docs through the MiniLM-L6 embedder into the
   index as 4 paced commits, 8 queries), the optimizer's auto mode (relational_engine's
   program at its full depth) and engine_rows (the row-form paths: an upsert session, a
   filter, an inner join after retractions, 6 commits). The outputs must be equal, every
   kernel of the workload's path (``NATIVE_PATHS``) called with the kernels and none
   without; wall seconds, units/s and each kernel's calls and ns, both ways.
24. The script line (the seconds since the script started, and each phase's), the
   native line (every phase's host kernel calls and ns, and the both-ways
   comparisons), the kernels line (the three flash kernels and ``segment_reduce``; the
   forward's ``launches_by_path`` includes ``rag_evals``, ``persistence``,
   ``observability``, ``watch``, ``connectors``, ``buses``, ``databases`` and
   ``sharded``, the segment reduction's ``table_ops``, ``temporal``, ``iterate``,
   ``optimizer``, ``persistence``, ``observability``, ``connectors``, ``buses``,
   ``databases`` and ``sharded``),
   the ``nvidia-smi`` line, and last ``{"ok": true, ...}``.

Every graph runs through the port's optimizer (``pathway_tpu_torch.optimize``) before
its first batch, as in the JAX package. Phases that check a device route
(relational_engine, table_ops, relational, temporal, iterate) force the device operators
(``PATHWAY_TPU_DEVICE_OPS=1``): in auto mode the placement policy sends some batches to
the host kernels.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# first: under PATHWAY_TPU_LOCKWATCH=1 the package installs its lock-order watcher
# before torch (and numpy) make their locks, as a program that imports it first does
import pathway_tpu_torch as pw  # noqa: I001

import numpy as np
import torch

from pathway_tpu_torch import _build, native
from pathway_tpu_torch.engine import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.engine import device as hd
from pathway_tpu_torch.engine import device_ops, device_pipeline, device_residency
from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.engine.device import TRANSFERS, device_batches_held, lazy_rows
from pathway_tpu_torch.engine.graph import Scheduler, Scope, _match_join_pairs
from pathway_tpu_torch.engine.reducers import ReducerKind, make_reducer
from pathway_tpu_torch.engine import expression as eex
from pathway_tpu_torch.internals import metrics as pmetrics
from pathway_tpu_torch.internals import profiling, tracing
from pathway_tpu_torch.internals.runner import (
    DistributedGraphRunner,
    GraphRunner,
    ShardedGraphRunner,
)
from pathway_tpu_torch.engine.routing import EXCHANGE_STATS
from pathway_tpu_torch.engine.sharded import ShardedScheduler
from pathway_tpu_torch.models import (
    ContrastiveBatch,
    Encoder,
    cross_encode,
    decoder_forward,
    embed,
    greedy_generate,
    info_nce_loss,
    init_cache,
    load_sentence_transformer,
    make_train_step,
    minilm_l6,
    normalize_u8,
    preprocess_image,
    preprocess_image_u8,
    sample_generate,
    vision_forward,
)
from pathway_tpu_torch.ops import flash_attention as fa
from pathway_tpu_torch.optimize import optimizer_stats
from pathway_tpu_torch.optimize.placement import POLICY, PlacementPolicy
from pathway_tpu_torch.ops import segment_reduce as sr
from pathway_tpu_torch.stdlib.indexing import DataIndex, DeviceKnnFactory
from pathway_tpu_torch.xpacks.llm import (
    AdaptiveRAGQuestionAnswerer,
    CrossEncoderReranker,
    DocumentStore,
    EncoderEmbedder,
    ImageEmbedder,
    PipelineChat,
    VectorStoreServer,
    prompt_chat_single_qa,
)
from pathway_tpu_torch.xpacks.llm.llms import EOS_ID
from pathway_tpu_torch.xpacks.llm._tokenizer import HashTokenizer, pad_to_buckets

SEED = 0
N_DOCS = 20_000  # the JAX bench's N_DOCS
N_BULK = 980_000  # seeded unit vectors: 1,000,000 live rows in all
N_QUERIES = 64
CHUNK = 256
SEQ_LEN = 128
K = 10
CAPACITY = 1 << 20
DIM = 384
LAYERS = 6
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "tiny_bert")

# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# Parity bars, kernel against its plain version on the same card: the JAX bench's
# own bar for bf16 outputs (values rounded to bf16 differ by an ulp near 1), 1e-4 for
# f32, where only the order of the f32 sums differs. lse is f32 in both dtypes.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4  # relative to max(1, |lse|)
# min cosine of the main path's embeddings, kernel against plain attention
EMBED_COS_BAR = 0.999
# The backward's outputs grow past 1 (a key's dV sums over every query row), so their
# error is taken relative to max(1, |plain|) elementwise, as lse's, against TOL.
TRAIN_PAIRS = 1024  # the all-MiniLM-L6-v2 recipe's batch
TRAIN_STEPS = 20
PARITY_PAIRS = 128
# min over parameters (``_grad_cosines``) of the cosine between a gradient through the
# kernels and through the plain versions; and the bar on the two losses' difference
GRAD_COS_BAR = 0.99
LOSS_TOL = 1e-2
VIT_ATTN_SHAPE = (64, 197, 12, 64)  # ViT-B/16 at 224 px: 196 patches + CLS, 12 heads of 64
BGE_ATTN_SHAPE = (CHUNK, SEQ_LEN, 12, 64)  # BGE-base: 256 docs in the 128 bucket, 12 heads of 64
TILE = 16  # keys per tile that the kernels skip when all of its keys are masked
# the tile-skipping parity cases, forward and backward, each in bf16 and f32
TILE_CASES = [
    ("late_keys", (64, 128, 12, 32), torch.bfloat16, "late_keys"),
    ("late_keys_f32", (16, 128, 12, 32), torch.float32, "late_keys"),
    ("gappy", (64, 128, 12, 32), torch.bfloat16, "gappy"),
    ("gappy_f32", (16, 128, 12, 64), torch.float32, "gappy"),
    ("late_keys_t200", (32, 200, 12, 32), torch.bfloat16, "late_keys_t200"),
    ("late_keys_t200_f32", (8, 200, 12, 32), torch.float32, "late_keys_t200"),
    ("mixed_dead", (64, 128, 12, 32), torch.bfloat16, "mixed_dead"),
    ("mixed_dead_f32", (16, 128, 12, 32), torch.float32, "mixed_dead"),
]

_WORDS = (
    "stream table index vector engine commit window join reduce shard "
    "tensor batch query embed token device mesh scatter gather fuse"
).split()


def doc_text(i: int) -> str:
    """The JAX bench's generated doc text (bench.py ``_doc_text``)."""
    rng = np.random.default_rng(i)
    n = 8 + int(rng.integers(0, 24))
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), n))


class Card:
    def __init__(self) -> None:
        self.name = torch.cuda.get_device_name(0)
        self.count = torch.cuda.device_count()
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    def emit(self, phase: str, **fields) -> None:
        print(json.dumps({"phase": phase, "card": self.smi, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the sequence with no real key in the ``dead_row`` and ``mixed_dead`` patterns
def dead_sequence(masked: str, b: int) -> int | None:
    return {"dead_row": 0, "mixed_dead": b // 2}.get(masked)


def attn_inputs(b, t, h, d, dtype, gen, *, masked: str):
    """q, k, v as views of one fused [b, t, 3*h*d] projection (the encoder's layout)
    and a key bias, as ``attn_qkv`` makes them."""
    qkv, bias = attn_qkv(b, t, h, d, dtype, gen, masked=masked)
    return (*fa.split_heads(qkv, h), bias)


def attn_qkv(b, t, h, d, dtype, gen, *, masked: str):
    """One fused [b, t, 3*h*d] projection (the encoder's layout) and a key bias: ``ragged`` (10-34 real tokens, as the bench's docs), ``random``,
    ``none``, ``ragged`` with sequence 0 fully masked (``dead_row``), and the patterns
    that exercise the kernels' skipping of fully masked 16-key tiles: ``late_keys``
    (real keys only in the last tile), ``gappy`` (live and fully masked tiles in
    turn), ``late_keys_t200`` (real keys only past position 128) and ``mixed_dead``
    (ragged, with the middle sequence fully masked)."""
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    pos = torch.arange(t, device="cuda")[None, :]
    if masked == "none":
        return qkv, None
    if masked == "random":
        mask = torch.rand((b, t), generator=gen, device="cuda") > 0.3
        mask[:, 0] = True
    elif masked == "late_keys":
        mask = (pos >= t - TILE).expand(b, t)
    elif masked == "gappy":
        mask = ((pos // TILE) % 2 == 0).expand(b, t)
    elif masked == "late_keys_t200":
        mask = (pos >= 128).expand(b, t)
    else:
        real = torch.randint(10, 35, (b,), generator=gen, device="cuda")
        mask = pos < real[:, None]
        dead = dead_sequence(masked, b)
        if dead is not None:
            mask[dead] = False
    return qkv, fa.mask_bias(mask)


def _weighted_keys(bias: torch.Tensor | None, b: int, t: int) -> int:
    """Keys that carry weight, summed over sequences: the real keys, or all t for a
    sequence with none (its rows weigh every key)."""
    if bias is None:
        return b * t
    real = (bias > fa.NEG_INF / 2).sum(dim=1)
    return int(torch.where(real > 0, real, t).sum())


def attn_bound_ms(q: torch.Tensor, bias: torch.Tensor | None) -> tuple[float, str]:
    """The least time one call can take on these inputs. Bytes: q read and o written
    for every row, lse written, the bias read, and k and v read only for the keys that
    carry weight: a key with bias -1e30 has exp(s - m) == 0 in f32 for every row that
    has a real key, so its k and v rows change nothing; a fully masked row weighs all t
    keys. Operations: q.k and p.v over those keys for every query row."""
    b, t, h, d = q.shape
    elt = q.element_size()
    keys = _weighted_keys(bias, b, t)
    nbytes = 2 * b * t * h * d * elt + 2 * keys * h * d * elt + b * h * t * 4
    nbytes += 0 if bias is None else b * t * 4
    flops = 4 * t * h * d * keys
    peak = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attn_bwd_bound_ms(q: torch.Tensor, bias: torch.Tensor | None, kernel: str) -> tuple[float, str]:
    """The least time one backward kernel can take on these inputs, counted as
    ``attn_bound_ms`` counts the forward's. dQ: q, dO and O (delta's input) read and dQ
    written for every row, lse read and delta written, k and v read for the keys that
    carry weight; 6d operations per (row, weighted key) and 2d per row for delta.
    dK/dV: q, dO, lse and delta read for every row, k and v for the weighted keys, dK
    and dV written for every key and dbias per (batch, head, key); 8d operations per
    (row, weighted key)."""
    b, t, h, d = q.shape
    elt = q.element_size()
    keys = _weighted_keys(bias, b, t)
    rows = b * t * h * d * elt  # one [b, t, h, d] tensor
    stats = b * h * t * 4  # one [b, h, t] f32 tensor
    kv = 2 * keys * h * d * elt
    nbytes = kv + (0 if bias is None else b * t * 4)
    if kernel == "dq":
        nbytes += 4 * rows + 2 * stats
        flops = 6 * t * h * d * keys + 2 * b * t * h * d
    else:
        nbytes += 4 * rows + 3 * stats
        flops = 8 * t * h * d * keys
    peak = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_build(card: Card) -> None:
    t0 = time.perf_counter()
    results = _build.build()
    for r in results.values():
        lines = [ln.strip() for ln in r.log.splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln or "smem" in ln]
        card.emit("build", kernel=r.name, seconds=r.seconds, ptxas=lines)
        spills = [ln for ln in lines if "spill" in ln]
        check(bool(spills) and all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
              f"{r.name}: ptxas reports spills: {spills}")
    card.emit("build_total", seconds=time.perf_counter() - t0, kernels=sorted(results))


# kernel -> (its library, the marks of its bf16 instances' mangled names)
SASS_KERNELS = {
    "flash_attention_fwd": ("flash_attention_fwd", ("flash_fwd_mma_kernel",)),
    "flash_attention_bwd_dq": ("flash_attention_bwd", ("flash_bwd_dq_mma_kernel",)),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", ("flash_bwd_dkv_mma_kernel",)),
}


def phase_sass(card: Card) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the built libraries' bf16 instances,
    from ``cuobjdump -sass``: every bf16 instance of every kernel must use them."""
    texts = {lib: _build.sass(lib) for lib in {lib for lib, _ in SASS_KERNELS.values()}}
    totals = {}
    for name, (lib, marks) in SASS_KERNELS.items():
        per_head_dim, instance = {}, None  # "d=32" -> count
        for line in texts[lib].splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                instance = None
                if all(m in found.group(1) for m in marks):
                    instance = "d=" + re.search(r"Li(\d+)E", found.group(1)).group(1)
                    per_head_dim[instance] = 0
            elif instance and re.search(r"\bH(G)?MMA\b", line):
                per_head_dim[instance] += 1
        totals[name] = sum(per_head_dim.values())
        card.emit("sass", kernel=name, library=lib, bf16_instances=per_head_dim,
                  tensor_core_instructions=totals[name])
        check(len(per_head_dim) == len(fa.HEAD_DIMS), f"{name}: bf16 instances {per_head_dim}")
        check(all(n > 0 for n in per_head_dim.values()), f"{name}: no tensor-core instructions {per_head_dim}")
    return totals


def phase_kernel(card: Card) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("main", (256, 128, 12, 32), torch.bfloat16, "ragged"),
        ("main_f32", (32, 128, 12, 32), torch.float32, "ragged"),
        ("head_dim_64", (64, 128, 12, 64), torch.bfloat16, "ragged"),
        ("t_200", (8, 200, 12, 32), torch.bfloat16, "random"),
        ("t_200_f32", (8, 200, 12, 32), torch.float32, "random"),
        ("t_512", (4, 512, 12, 64), torch.bfloat16, "random"),
        ("mask_none", (16, 128, 12, 32), torch.bfloat16, "none"),
        ("dead_row_f32", (4, 128, 12, 32), torch.float32, "dead_row"),
        ("dead_row", (4, 200, 12, 32), torch.bfloat16, "dead_row"),
        # the vision path's call: t = 197 (not a multiple of the tile), d = 64, no mask
        ("vit_b16", VIT_ATTN_SHAPE, torch.bfloat16, "none"),
        # one BGE-base embed call of the vector store: 256 docs of 10-34 tokens in the
        # 128 bucket, 12 heads of 64
        ("bge_base", BGE_ATTN_SHAPE, torch.bfloat16, "ragged"),
        *TILE_CASES,
    ]
    main_err = None
    for name, shape, dtype, masked in cases:
        q, k, v, bias = attn_inputs(*shape, dtype, gen, masked=masked)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, bias)
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
        card.emit("kernel_parity", case=name, shape=list(shape), dtype=str(dtype),
                  max_abs_err=err, tol=TOL[dtype], lse_rel_err=lse_err, lse_tol=LSE_TOL)
        check(math.isfinite(err) and err <= TOL[dtype], f"{name}: o error {err}")
        check(math.isfinite(lse_err) and lse_err <= LSE_TOL, f"{name}: lse error {lse_err}")
        dead = dead_sequence(masked, shape[0])
        if dead is not None:
            uniform = v[dead].float().mean(dim=0)  # [h, d]: the uniform average over t keys
            dead_err = (o[dead].float() - uniform[None]).abs().max().item()
            check(dead_err <= TOL[dtype], f"{name}: fully masked row is not the mean of v ({dead_err})")
        if name == "main":
            main_err = err

    # the serving shape (one embed call of 256 docs), the train shape (one embed call
    # of the trainer's 1,024 sequences), the vision shape (one ViT-B/16 forward call
    # of 64 images, no mask) and the vector store's (one BGE-base embed call of 256 docs)
    times = {}
    for path, (b, t, h, d), masked in (("serving", (CHUNK, SEQ_LEN, 12, DIM // 12), "ragged"),
                                       ("train", (TRAIN_PAIRS, SEQ_LEN, 12, DIM // 12), "ragged"),
                                       ("vision", VIT_ATTN_SHAPE, "none"),
                                       ("bge_serving", BGE_ATTN_SHAPE, "ragged")):
        q, k, v, bias = attn_inputs(b, t, h, d, torch.bfloat16, gen, masked=masked)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias), iters=200)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, bias), iters=10, warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        add_mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=add_mask), iters=200)
        bound_ms, bound_by = attn_bound_ms(q, bias)
        # labels only: the bound if every key were real (k and v read in full), and
        # one PyTorch copy of q's strided view into a contiguous o, the bulk of the
        # call's bytes moved with the same access pattern and no arithmetic
        dense_bound_ms, _ = attn_bound_ms(q, None)
        o_like = torch.empty_like(q, memory_format=torch.contiguous_format)
        copy_ms = cuda_ms(lambda: o_like.copy_(q), iters=200)
        card.emit("kernel_time", path=path, shape=[b, t, h, d], dtype="bfloat16", ms=ms,
                  plain_ms=plain_ms, library_ms=library_ms, library="scaled_dot_product_attention",
                  bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
                  real_keys_per_seq=_weighted_keys(bias, b, t) / b, dense_bound_ms=dense_bound_ms,
                  q_to_o_copy_ms=copy_ms)
        times[path] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library_ms}
        del q, k, v, bias, qt, kt, vt, add_mask, o_like
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "pathway_tpu/ops/flash_attention.py:47",
        "max_abs_err": main_err,
        **times["serving"],
        "train_shape": times["train"],
        "vision_shape": times["vision"],
        "bge_serving_shape": times["bge_serving"],
    }


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()


def phase_train_kernel(card: Card) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    train_shape = (TRAIN_PAIRS, SEQ_LEN, 12, DIM // 12)
    cases = [
        ("train", train_shape, torch.bfloat16, "ragged"),
        ("train_f32", (64, 128, 12, 32), torch.float32, "ragged"),
        ("head_dim_64", (64, 128, 12, 64), torch.bfloat16, "ragged"),
        ("t_200", (8, 200, 12, 32), torch.bfloat16, "random"),
        ("t_200_f32", (8, 200, 12, 32), torch.float32, "random"),
        ("t_512", (4, 512, 12, 64), torch.bfloat16, "random"),
        ("mask_none", (16, 128, 12, 32), torch.bfloat16, "none"),
        ("dead_row_f32", (4, 128, 12, 32), torch.float32, "dead_row"),
        ("dead_row", (4, 200, 12, 32), torch.bfloat16, "dead_row"),
        *TILE_CASES,
    ]
    names = ("dq", "dk", "dv", "dbias")
    train_err = {}
    for name, shape, dtype, masked in cases:
        q, k, v, bias = attn_inputs(*shape, dtype, gen, masked=masked)
        do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        ours = fa.flash_attention_bwd(q, k, v, bias, do, o, lse)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(q, k, v, bias, do, o, lse)
        rel = {n: _rel_err(a, r) for n, a, r in zip(names, ours, ref)}
        abs_err = {n: (a.float() - r.float()).abs().max().item() for n, a, r in zip(names, ours, ref)}
        zeros = True
        if bias is not None:  # masked keys of sequences with a real key: exact zeros
            masked_keys = (bias < fa.NEG_INF / 2) & (bias > fa.NEG_INF / 2).any(dim=1, keepdim=True)
            zeros = all(bool((x[masked_keys] == 0).all()) for x in ours[1:])
        card.emit("train_kernel_parity", case=name, shape=list(shape), dtype=str(dtype),
                  rel_err=rel, max_abs_err=abs_err, tol=TOL[dtype],
                  max_abs_plain={n: r.float().abs().max().item() for n, r in zip(names, ref)},
                  masked_keys_exact_zero=zeros)
        for n in names:
            check(math.isfinite(rel[n]) and rel[n] <= TOL[dtype], f"{name}: {n} error {rel[n]}")
        check(zeros, f"{name}: masked keys' dk, dv, dbias are not exact zeros")
        if name == "train":
            train_err = abs_err
        del q, k, v, bias, do, o, lse, ours, ref

    phase_fused_vs_split(card, gen, train_shape)
    q, k, v, bias = attn_inputs(*train_shape, torch.bfloat16, gen, masked="ragged")
    do = torch.randn(train_shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    _dq, delta = fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse)
    times = {
        "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse), iters=50),
        "dkv": cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta), iters=50),
    }
    plain = {
        "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse),
                      iters=5, warmup=2),
        "dkv": cuda_ms(lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta),
                       iters=5, warmup=2),
    }
    # the yardstick: SDPA's backward with the same additive mask, as its forward and
    # backward less its forward (it computes dq, dk and dv, not dbias)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    add_mask = bias[:, None, None, :].to(torch.bfloat16)
    sdpa_fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=add_mask), iters=50)
    sdpa_fwd_bwd_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=add_mask), (qt, kt, vt), dot), iters=50
    )
    library_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms
    rows = []
    for kern, name, replaces in (
        ("dq", "flash_attention_bwd_dq", "pathway_tpu/ops/flash_attention.py:125"),
        ("dkv", "flash_attention_bwd_dkv", "pathway_tpu/ops/flash_attention.py:166"),
    ):
        bound_ms, bound_by = attn_bwd_bound_ms(q, bias, kern)
        card.emit("train_kernel_time", kernel=name, shape=list(train_shape), dtype="bfloat16",
                  ms=times[kern], plain_ms=plain[kern], bound_ms=bound_ms, bound_by=bound_by,
                  roofline_share=bound_ms / times[kern], library_ms=library_ms,
                  library="scaled_dot_product_attention backward (fwd+bwd less fwd), dq+dk+dv",
                  sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
                  real_keys_per_seq=float((bias == 0).sum()) / train_shape[0])
        errs = [train_err["dq"]] if kern == "dq" else [train_err[n] for n in ("dk", "dv", "dbias")]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "pathway_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces,
            "max_abs_err": max(errs),
            "ms": times[kern],
            "plain_ms": plain[kern],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return rows


def phase_fused_vs_split(card: Card, gen: torch.Generator, shape) -> None:
    """The fused route at the train shape: ``flash_attention_qkv``'s gradient (the
    kernels writing into the three thirds of one dqkv buffer) against the split route's
    dq, dk and dv from the same kernels on the same inputs, concatenated, which must
    agree bit for bit (the kernels use no atomics; only the output addresses differ);
    and each third against the plain versions, within the bars."""
    b, t, h, d = shape
    qkv, bias = attn_qkv(b, t, h, d, torch.bfloat16, gen, masked="ragged")
    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    x = qkv.detach().requires_grad_()
    o = fa.flash_attention_qkv(x, bias == 0, h)
    (dqkv,) = torch.autograd.grad(o, x, do)
    q, k, v = fa.split_heads(qkv, h)
    o_split, lse = fa.flash_attention_fwd(q, k, v, bias)
    dq, dk, dv, _ = fa.flash_attention_bwd(q, k, v, bias, do, o_split, lse)
    split = torch.cat([g.reshape(b, t, h * d) for g in (dq, dk, dv)], dim=-1)
    torch.cuda.synchronize()
    identical = torch.equal(o, o_split) and torch.equal(dqkv, split)
    ref = fa.flash_attention_bwd_reference(q, k, v, bias, do, o_split, lse)
    rel = {n: _rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), fa.split_heads(dqkv, h), ref)}
    card.emit("fused_vs_split", shape=list(shape), dtype="bfloat16", bit_identical=identical,
              rel_err_vs_plain=rel, tol=TOL[torch.bfloat16],
              dqkv_strides=list(dqkv.stride()), dqkv_contiguous=dqkv.is_contiguous())
    check(identical, "the fused route's dqkv differs from the split route's dq, dk, dv")
    for n, err in rel.items():
        check(math.isfinite(err) and err <= TOL[torch.bfloat16], f"fused route: {n} error {err}")


def phase_checkpoint(card: Card) -> None:
    data = np.load(os.path.join(FIXTURE, "golden_embeddings.npz"))
    texts = [str(x) for x in data["texts"]]
    expected = np.asarray(data["embeddings"], np.float32)
    state, cfg, tok = load_sentence_transformer(FIXTURE)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    enc = Encoder(cfg, device="cuda", seed=None)
    enc.load_state_dict(state)
    ids, mask = tok.encode_batch(texts, 32)
    ours = embed(enc, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu().numpy()
    err = float(np.abs(ours - expected).max())
    card.emit("checkpoint", fixture="tests/fixtures/tiny_bert", head_dim=cfg.head_dim,
              max_abs_err=err, tol=1e-4)
    check(err <= 1e-4, f"tiny_bert goldens: {err}")


def phase_main_path(card: Card) -> int:
    corpus = [doc_text(i) for i in range(N_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    check(embedder.get_embedding_dimension() == DIM, "MiniLM-L6 width")
    index = DeviceKnnIndex(dim=DIM, capacity=CAPACITY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in (fa.KERNEL, fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL):
        kern.launches = 0
    embed_calls = 0
    doc_vecs = []  # the embedder's outputs, kept on the card for the checks below
    t0 = time.perf_counter()
    for start in range(0, N_DOCS, CHUNK):
        texts = corpus[start:start + CHUNK]
        vecs = embedder.embed_batch(texts)
        embed_calls += 1
        index.add(range(start, start + len(texts)), vecs)
        doc_vecs.append(vecs)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bulk = torch.randn((N_BULK, DIM), generator=gen, device="cuda")
    bulk /= torch.linalg.vector_norm(bulk, dim=1, keepdim=True)
    t0 = time.perf_counter()
    index.add(range(N_DOCS, N_DOCS + N_BULK), bulk)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    check(len(index) == N_DOCS + N_BULK, "live rows")

    latencies, answers, qvecs, qdocs = [], [], [], []
    for i in range(N_QUERIES):
        doc = i * 37 % N_DOCS  # queries reuse doc texts, as the JAX bench does
        t0 = time.perf_counter()
        q = embedder.embed_batch([doc_text(doc)])
        embed_calls += 1
        hits = index.search(q, k=K)[0]
        latencies.append(time.perf_counter() - t0)
        answers.append([key for key, _ in hits])
        qvecs.append(q[0].cpu().numpy())
        qdocs.append(doc)
    launches = fa.KERNEL.launches
    backward_launches = fa.BWD_DQ_KERNEL.launches + fa.BWD_DKV_KERNEL.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the index's state against its inputs: every key's slot holds its vector bit for
    # bit, with its squared norm, and exactly the 1M slots are live
    inputs = torch.cat([torch.cat(doc_vecs).float(), bulk])
    del doc_vecs, bulk
    slot_of = torch.tensor([index.key_to_slot[key] for key in range(N_DOCS + N_BULK)], device="cuda")
    check(torch.equal(index.state.vectors.index_select(0, slot_of), inputs), "stored vectors")
    check(torch.allclose(index.state.norms[slot_of], (inputs * inputs).sum(dim=1), rtol=1e-5),
          "stored squared norms")
    check(bool(index.state.valid[slot_of].all()) and int(index.state.valid.sum()) == N_DOCS + N_BULK,
          "live slots")
    # exact f32 search on the host over an index built from the same inputs through
    # its own add, not from the device index's buffers
    inputs = inputs.cpu().numpy()
    host = HostKnnIndex(dim=DIM, capacity=CAPACITY)
    host.add(range(N_DOCS + N_BULK), inputs)
    del inputs, slot_of
    exact = host.search(qvecs, k=K)
    recalls = [len(set(a) & {key for key, _ in e}) / len(e) for a, e in zip(answers, exact)]
    recall = float(np.mean(recalls))
    self_hit = all(doc in a for doc, a in zip(qdocs, answers))

    lat_ms = sorted(1e3 * x for x in latencies)
    card.emit("main_path", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
              n_docs=N_DOCS, live_rows=len(index), capacity=index.capacity,
              index_gb=index.state.vectors.numel() * 4 / 1e9,
              docs_per_s=N_DOCS / ingest_s, ingest_s=ingest_s, bulk_add_s=bulk_s,
              query_p50_ms=lat_ms[len(lat_ms) // 2], query_p95_ms=lat_ms[int(0.95 * len(lat_ms))],
              peak_device_gib=peak_gib, embed_calls=embed_calls, flash_launches=launches,
              backward_launches=backward_launches,
              recall_at_10=recall, self_hit=self_hit)
    check(launches > 0 and launches == LAYERS * embed_calls,
          f"flash launches {launches} != {LAYERS} x {embed_calls} embed calls")
    check(backward_launches == 0, f"serving launched {backward_launches} backward kernels")
    check(recall >= 0.99, f"recall@10 {recall}")
    check(self_hit, "every query finds its own doc")

    phase_embed_parity(card, embedder, corpus)
    phase_profile(card, embedder, index, corpus)
    return {"launches": launches, "docs_per_s": N_DOCS / ingest_s}


def plain_attention(q, k, v, mask):
    """The forward kernel's plain PyTorch version as an attention function: the
    kernel's arithmetic with no kernel, on the same card."""
    return fa.flash_attention_fwd_reference(q, k, v, None if mask is None else fa.mask_bias(mask))[0]


def phase_embed_parity(card: Card, embedder: EncoderEmbedder, corpus) -> None:
    """One 256-doc batch through the kernel against the same encoder on the plain
    attention, on the card (min cosine over the batch). To show what the bar can see,
    the same reading with two deliberately broken attentions: the mask ignored, and
    uniform weights over the real keys (q.k ignored). With seeded N(0, 0.02) weights
    the attention's scores are small, so the second fault passes the bar: this check
    guards the mask and the sum over v (an ignored mask must fall below the bar, or
    the script fails), and the kernel-level parity guards the scores."""
    def mask_ignored(q, k, v, mask):
        return fa.flash_attention_fwd_reference(q, k, v, None)[0]

    def uniform(q, k, v, mask):
        return plain_attention(torch.zeros_like(q), k, v, mask)

    ids, mask, real = embedder.tokenize(corpus[:CHUNK])
    ref = embed(embedder.encoder, ids, mask, attn_fn=plain_attention)[:real]

    def min_cos(attn_fn=None) -> float:
        out = embed(embedder.encoder, ids, mask, attn_fn=attn_fn)[:real]
        check(bool(torch.isfinite(out).all()) and out.shape == (CHUNK, DIM), "embedding shape and finiteness")
        return float((out * ref).sum(dim=1).min())

    cos_min = min_cos()
    broken = {"mask_ignored": min_cos(mask_ignored), "uniform_weights": min_cos(uniform)}
    card.emit("embed_parity", batch=CHUNK, min_cosine=cos_min, bar=EMBED_COS_BAR,
              broken_min_cosine=broken)
    check(cos_min >= EMBED_COS_BAR, f"kernel vs plain attention embeddings: cosine {cos_min}")
    check(broken["mask_ignored"] < EMBED_COS_BAR, f"the bar cannot see an ignored mask: {broken}")


def _profiled(fn) -> tuple[float, list[tuple[float, str, int]], dict[str, int]]:
    """Run ``fn`` under the profiler -> (wall ms, [(device ms, kernel, count)], {host
    op or autograd node: count}), counting only device-side events as kernels, so no
    kernel is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [
        (evt.self_device_time_total / 1e3, evt.key, evt.count)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    ops = {evt.key: evt.count for evt in prof.key_averages() if evt.device_type == DeviceType.CPU}
    return wall_ms, sorted(kernels, reverse=True), ops


def phase_profile(card: Card, embedder: EncoderEmbedder, index: DeviceKnnIndex, corpus) -> None:
    """Where the time goes: profiler windows over a few more ingest commits and
    queries on the same 1M-row index, with device time by kernel and the device's
    idle share of each window."""
    commits, queries = 8, 8
    base = 2 * CAPACITY  # keys past every key of the main path

    def ingest() -> None:
        for c in range(commits):
            keys = range(base + c * CHUNK, base + (c + 1) * CHUNK)
            index.add(keys, embedder.embed_batch(corpus[c * CHUNK:(c + 1) * CHUNK]))

    def query() -> None:
        for i in range(queries):
            index.search(embedder.embed_batch([corpus[i]]), k=K)

    for name, fn, n in (("ingest", ingest, commits), ("query", query, queries)):
        wall_ms, kernels, _ops = _profiled(fn)
        busy_ms = sum(k[0] for k in kernels)
        card.emit(
            "profile",
            window=f"{n} {name} commits on the 1M-row index",
            wall_ms_per_commit=wall_ms / n,
            device_busy_ms_per_commit=busy_ms / n if kernels else "not measured",
            device_idle_share=(1.0 - busy_ms / wall_ms) if kernels else "not measured",
            top=[{"kernel": k[:80], "device_ms_per_commit": ms / n, "launches": c}
                 for ms, k, c in kernels[:12]],
        )


class _KeptKnnFactory(DeviceKnnFactory):
    """The pipeline's index factory, keeping the index it builds so the script can read
    its routes' row counts and its stored vectors after the run."""

    def build(self) -> DeviceKnnIndex:
        self.built = super().build()
        return self.built


def _engine_program(embedder: EncoderEmbedder, corpus, n_docs: int, n_queries: int,
                    factory: DeviceKnnFactory, wait_s: float, pace: int | None = None):
    """``bench.py::pipeline_leg``'s program against the port: the python connector ->
    the embedder UDF -> DataIndex -> as-of-now query -> two subscribe sinks. Queries
    start once every doc has reached the doc subscriber. With ``pace`` the feed pushes
    the docs in batches of ``pace``, each once the one before has reached the doc
    subscriber, so each batch is a commit of its own. Returns the observations (filled
    in while ``pw.run`` runs) and the function that runs it."""
    obs = {"docs": {}, "doc_times": set(), "answers": {}, "latencies": [], "timeouts": [],
           "failures": [], "run_start": 0.0, "first_doc_seen": 0.0, "ingest_end": 0.0,
           "answer_events": collections.Counter()}
    ingest_done, answer_seen, batch_seen = threading.Event(), threading.Event(), threading.Event()

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            obs["run_start"] = time.perf_counter()
            step = pace or n_docs
            for start in range(0, n_docs, step):
                batch_seen.clear()
                for i in range(start, min(n_docs, start + step)):
                    self.next(doc_id=i, text=corpus[i])
                if pace and not batch_seen.wait(timeout=wait_s):
                    obs["failures"].append(f"docs {start}.. never reached the subscriber")
                    return

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=wait_s):
                obs["failures"].append(f"{len(obs['docs'])} of {n_docs} docs arrived")
                return
            for i in range(n_queries):
                answer_seen.clear()
                t0 = time.perf_counter()
                self.next(query_id=i, text=doc_text(i * 37 % N_DOCS))
                if answer_seen.wait(timeout=wait_s):
                    obs["latencies"].append(time.perf_counter() - t0)
                else:
                    obs["timeouts"].append(i)

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(doc_id=int, text=str),
                             autocommit_duration_ms=100)
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(query_id=int, text=str),
                                autocommit_duration_ms=None)
    queries = queries.select(query_id=pw.this.query_id, qemb=embedder(pw.this.text))
    res = DataIndex(docs, factory, docs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=K)

    def on_doc(key, row, time, is_addition):
        if is_addition:
            if not obs["docs"]:
                obs["first_doc_seen"] = perf_counter()
            obs["docs"][key] = (row["doc_id"], np.asarray(row["emb"], np.float32))
            obs["doc_times"].add(time)
            if pace and (len(obs["docs"]) % pace == 0 or len(obs["docs"]) == n_docs):
                batch_seen.set()  # a full batch, or the last, shorter one
            if len(obs["docs"]) == n_docs:
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][row["query_id"]] = (tuple(row["_pw_index_reply_ids"]),
                                               np.asarray(row["qemb"], np.float32))
            obs["answer_events"][row["query_id"]] += 1
            answer_seen.set()

    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module
    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    return obs, pw.run


def _engine_recall(obs: dict) -> tuple[float, bool]:
    """Recall@10 of an ``_engine_program`` run's answers against exact f32 search over
    the vectors its doc subscriber received (as pipeline_leg computes it), and whether
    every query found its own doc."""
    docs, answers = obs["docs"], obs["answers"]
    keys = list(docs)
    mat = np.stack([docs[k][1] for k in keys])
    norms = np.linalg.norm(mat, axis=1)
    recalls, self_hit = [], True
    key_of = {doc_id: key for key, (doc_id, _emb) in docs.items()}
    for qid, (hit_keys, qvec) in answers.items():
        scores = mat @ qvec / np.maximum(norms * np.linalg.norm(qvec), 1e-30)
        exact = {keys[j] for j in np.argsort(-scores)[:K]}
        recalls.append(len(exact & set(hit_keys)) / len(exact))
        self_hit &= key_of.get(qid * 37 % N_DOCS) in hit_keys
    return (float(np.mean(recalls)) if recalls else float("nan")), self_hit


def _count_embed_calls(embedder: EncoderEmbedder) -> tuple[list[int], list[int]]:
    """Count the embed calls the UDF makes (one per chunk of at most CHUNK texts; the
    device pipeline's controller may narrow the chunks) -> ([calls], the texts handed
    over per call)."""
    calls, sizes = [0], []
    embed_batch = embedder.embed_batch

    def counted(texts):
        calls[0] += math.ceil(len(texts) / CHUNK)
        sizes.append(len(texts))
        return embed_batch(texts)

    embedder.embed_batch = counted
    return calls, sizes


def _pipeline_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name == "pw-device-pipeline"]


def _track_inflight() -> list[int]:
    """Record the device pipeline's in-flight commits just after each staging (its
    deepest point) -> the list it fills; ``_untrack_inflight`` restores the pipe."""
    seen = []
    boundary = device_pipeline.PIPELINE.commit_boundary

    def tracked(time_: int) -> None:
        boundary(time_)
        seen.append(device_pipeline.PIPELINE.inflight())

    device_pipeline.PIPELINE.commit_boundary = tracked
    return seen


def _untrack_inflight() -> None:
    device_pipeline.PIPELINE.__dict__.pop("commit_boundary", None)


def _pipe_mark() -> tuple[float, list[int]]:
    """The pipeline's commit counter and latency histogram, which count for the whole
    process, read before a run so that ``_pipe_since`` can give the run's own."""
    pipe = device_pipeline.PIPELINE
    return pipe._c_commits.value, list(pipe._h_latency.counts)


def _pipe_since(mark: tuple[float, list[int]]) -> dict:
    from pathway_tpu_torch.internals.metrics import Histogram

    pipe = device_pipeline.PIPELINE
    hist = Histogram(device_pipeline.DISPATCH_BUCKETS)
    hist.counts = [a - b for a, b in zip(pipe._h_latency.counts, mark[1])]
    hist.count = sum(hist.counts)
    return {"completed_commits_in_run": int(pipe._c_commits.value - mark[0]),
            "dispatch_complete_p50_ms_in_run": 1e3 * hist.quantile(0.5),
            "dispatch_complete_p99_ms_in_run": 1e3 * hist.quantile(0.99)}


def phase_engine_pipeline(card: Card, main_path_docs_per_s: float) -> tuple[int, int, float]:
    """The streaming-RAG pipeline through the port's own engine, as ``bench.py::
    pipeline_leg`` drives the JAX package: 20,000 docs through the python connector
    (100 ms autocommit), the embedder UDF (256-doc chunks, lazy device rows) and
    DataIndex into a 1,048,576-slot index on the card; 64 queries, one commit each,
    once every doc has reached the doc subscriber. Then the engine's host cost: a
    profiled pw.run of 2,048 docs beside the device-path loop over the same docs."""
    corpus = [doc_text(i) for i in range(N_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, N_DOCS, N_QUERIES, factory, wait_s=300.0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = torch.cuda.memory_allocated()
    d2h_before = TRANSFERS["d2h_copies"]
    # the controller persists across runs in a process: start each run from its knobs
    device_pipeline.PIPELINE.configure()
    check(device_pipeline.async_enabled(), "the device pipeline must run async here")
    mark = _pipe_mark()
    for kern in (fa.KERNEL, fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL):
        kern.launches = 0
    t0 = time.perf_counter()
    run()
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    # the rewrite of this run's graph, for the optimizer phase's report
    OPTIMIZER_SEEN["engine_pipeline"] = optimizer_stats()
    pipe = {**device_pipeline.PIPELINE.stats(), **_pipe_since(mark)}
    threads_after = _pipeline_threads()
    backward_launches = fa.BWD_DQ_KERNEL.launches + fa.BWD_DKV_KERNEL.launches
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    index = factory.built
    held = device_batches_held()
    index_bytes = sum(x.numel() * x.element_size() for x in index.state)
    weight_bytes = sum(p.numel() * p.element_size() for p in embedder.encoder.parameters())
    after_bytes = torch.cuda.memory_allocated()

    docs, answers = obs["docs"], obs["answers"]
    keys = list(docs)
    recall, self_hit = _engine_recall(obs)
    # a sample of the subscriber's rows (host twins) against the index's stored rows
    rng = np.random.default_rng(SEED)
    sample = [keys[i] for i in rng.choice(len(keys), 256, replace=False)]
    slots = torch.tensor([index.key_to_slot[k] for k in sample], device="cuda")
    stored = index.state.vectors.index_select(0, slots).cpu().numpy()
    bit_equal = bool(np.array_equal(stored, np.stack([docs[k][1] for k in sample])))

    lat_ms = sorted(1e3 * x for x in obs["latencies"])
    ingest_s = obs["ingest_end"] - obs["run_start"]
    docs_per_s = N_DOCS / ingest_s if ingest_s > 0 else float("nan")
    card.emit(
        "engine_pipeline",
        model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
        n_docs=len(docs), n_queries=len(lat_ms), query_timeouts=len(obs["timeouts"]),
        capacity=index.capacity, docs_per_s=docs_per_s, ingest_s=ingest_s,
        first_doc_seen_s=obs["first_doc_seen"] - obs["run_start"] if docs else None,
        doc_commits=len(obs["doc_times"]), run_s=run_s,
        docs_per_s_over_main_path=docs_per_s / main_path_docs_per_s,
        main_path_docs_per_s=main_path_docs_per_s,
        query_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        query_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        recall_at_10=recall, self_hit=self_hit, embed_calls=embed_calls[0],
        flash_launches=launches, backward_launches=backward_launches,
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        live_device_batches_after_run=held, peak_device_gib=peak_gib,
        device_gib_after_run=after_bytes / 2**30, device_gib_before_run=before_bytes / 2**30,
        index_gib=index_bytes / 2**30, weights_gib=weight_bytes / 2**30,
        after_run_beyond_index_and_weights_mib=(after_bytes - index_bytes - weight_bytes) / 2**20,
        host_twin_copies=TRANSFERS["d2h_copies"] - d2h_before,
        subscriber_rows_bit_equal_to_index=bit_equal,
        device_pipeline=pipe, pipeline_threads_after_run=threads_after,
        failures=obs["failures"],
    )
    check(not obs["failures"], f"engine pipeline: {obs['failures']}")
    check(len(docs) == N_DOCS, f"{len(docs)} of {N_DOCS} docs arrived")
    check(len(lat_ms) == N_QUERIES and not obs["timeouts"],
          f"{len(lat_ms)} answers, timeouts {obs['timeouts']}")
    check(recall >= 0.99, f"engine recall@10 {recall}")
    check(self_hit, "engine: every query finds its own doc")
    check(launches > 0 and launches == LAYERS * embed_calls[0],
          f"engine: flash launches {launches} != {LAYERS} x {embed_calls[0]} embed calls")
    check(backward_launches == 0, f"engine launched {backward_launches} backward kernels")
    check(index.rows_device == N_DOCS and index.rows_host == 0,
          f"index routes: {index.rows_device} device, {index.rows_host} host")
    check(held == 0, f"{held} device batches still hold a tensor after pw.run")
    check(bit_equal, "the subscriber's rows differ from the index's stored vectors")
    check(pipe["completed_commits_in_run"] > 0, f"device pipeline: {pipe}")
    check(pipe["inflight"] == 0, f"{pipe['inflight']} commits in flight after pw.run")
    check(not threads_after, f"completion threads alive after pw.run: {threads_after}")
    del factory, index, obs, docs, answers
    parity = phase_engine_async_parity(card, embedder, corpus)
    phase_engine_host_cost(card, embedder, corpus)
    return launches, parity, docs_per_s


def _gil_check() -> dict:
    """The completion thread's wait on a copy event releases the GIL: a commit whose
    copy sits behind ~0.2 s of card work is staged, then a second one, so two commits
    are in flight while the first one's wait runs; meanwhile the scheduler thread
    counts loop turns, against the same count just before."""

    def turns(seconds: float) -> int:
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n += 1
        return n

    device_pipeline.PIPELINE.configure()
    base = torch.randn((CHUNK, DIM), device="cuda")
    torch.cuda.synchronize()
    baseline = turns(0.05)
    torch.cuda._sleep(400_000_000)  # ~0.2 s of card time ahead of the first copy
    first = lazy_rows(base * 2.0, CHUNK)
    device_pipeline.commit_boundary(0)
    second = lazy_rows(base * 3.0, CHUNK)
    device_pipeline.commit_boundary(1)
    depth = device_pipeline.PIPELINE.inflight()
    during = turns(0.05)
    still_waiting = first[0].batch.dev is not None
    device_pipeline.drain()
    ok_bits = (np.array_equal(first[0].batch.host(), (base * 2.0).cpu().numpy())
               and np.array_equal(second[0].batch.host(), (base * 3.0).cpu().numpy()))
    out = {"inflight_after_second_staging": depth, "first_commit_still_waiting": still_waiting,
           "scheduler_turns_during_wait_over_before": during / baseline,
           "host_twins_bit_equal": ok_bits}
    device_pipeline.PIPELINE.configure()
    return out


def phase_engine_async_parity(card: Card, embedder: EncoderEmbedder, corpus) -> int:
    """The same program on 2,048 docs fed as 8 commits of 256 (the feed waits for each
    batch at the doc subscriber before it pushes the next), run twice in this call:
    with the synchronous commit boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) and with the
    async pipeline, ``configure()`` before each. The doc subscriber's events (keys,
    doc ids, embeddings) and the index's stored row of every key must be the same bits
    in both modes. Then the GIL check of the completion thread's wait."""
    n = 8 * CHUNK
    modes, runs = {}, {}
    prior = os.environ.get("PATHWAY_TPU_ASYNC_DEVICE")
    try:
        for mode in ("0", "1"):
            os.environ["PATHWAY_TPU_ASYNC_DEVICE"] = mode
            embed_calls, sizes = _count_embed_calls(embedder)
            factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
            obs, run = _engine_program(embedder, corpus, n, 0, factory, wait_s=120.0,
                                       pace=CHUNK)
            device_pipeline.PIPELINE.configure()
            mark = _pipe_mark()
            inflight = _track_inflight()
            for kern in (fa.KERNEL, fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL):
                kern.launches = 0
            try:
                run()
            finally:
                _untrack_inflight()
                del embedder.embed_batch  # back to the class's method
            launches = fa.KERNEL.launches
            backward_launches = fa.BWD_DQ_KERNEL.launches + fa.BWD_DKV_KERNEL.launches
            pipe = {**device_pipeline.PIPELINE.stats(), **_pipe_since(mark)}
            check(not obs["failures"] and len(obs["docs"]) == n,
                  f"parity run (async={mode}): {len(obs['docs'])} docs, {obs['failures']}")
            index = factory.built
            keys = sorted(obs["docs"], key=int)
            slots = torch.tensor([index.key_to_slot[k] for k in keys], device="cuda")
            runs[mode] = {
                "keys": [int(k) for k in keys],
                "doc_ids": [obs["docs"][k][0] for k in keys],
                "emb": np.stack([obs["docs"][k][1] for k in keys]),
                "stored": index.state.vectors.index_select(0, slots).cpu().numpy(),
            }
            ingest_s = obs["ingest_end"] - obs["run_start"]
            modes["async" if mode == "1" else "sync"] = {
                "docs_per_s": n / ingest_s, "ingest_s": ingest_s,
                "doc_commits": len(obs["doc_times"]),
                "embed_chunk_sizes": sizes, "embed_calls": embed_calls[0],
                "flash_launches": launches, "backward_launches": backward_launches,
                "index_rows_device_route": index.rows_device,
                "index_rows_host_route": index.rows_host,
                "max_inflight_after_staging": max(inflight, default=0),
                "live_device_batches_after_run": device_batches_held(),
                "device_pipeline": pipe,
                "subscriber_rows_bit_equal_to_index": bool(
                    np.array_equal(runs[mode]["emb"], runs[mode]["stored"])),
            }
            check(launches == LAYERS * embed_calls[0] and backward_launches == 0,
                  f"parity: flash launches {launches} != {LAYERS} x {embed_calls[0]}, "
                  f"or {backward_launches} backward launches")
            del factory, index, obs
    finally:
        if prior is None:
            os.environ.pop("PATHWAY_TPU_ASYNC_DEVICE", None)
        else:
            os.environ["PATHWAY_TPU_ASYNC_DEVICE"] = prior
    sync, asy = runs["0"], runs["1"]
    same = {
        "keys": sync["keys"] == asy["keys"],
        "doc_ids": sync["doc_ids"] == asy["doc_ids"],
        "embeddings": bool(np.array_equal(sync["emb"], asy["emb"])),
        "index_rows": bool(np.array_equal(sync["stored"], asy["stored"])),
    }
    gil = _gil_check()
    card.emit("engine_async_parity",
              window=f"{n} docs in {n // CHUNK} paced batches of {CHUNK}, pw.run with the "
                     "sync boundary and with the async pipeline",
              modes=modes, bit_identical=same, gil_check=gil)
    check(all(same.values()), f"async against sync: {same}")
    for name, m in modes.items():
        check(m["doc_commits"] >= n // CHUNK, f"{name}: {m['doc_commits']} doc commits")
        check(m["index_rows_device_route"] == n and m["index_rows_host_route"] == 0,
              f"{name}: index routes {m['index_rows_device_route']} / {m['index_rows_host_route']}")
        check(m["live_device_batches_after_run"] == 0, f"{name}: batches held after the run")
        check(m["subscriber_rows_bit_equal_to_index"], f"{name}: subscriber rows != index rows")
        check(m["device_pipeline"]["inflight"] == 0, f"{name}: commits in flight after pw.run")
    check(modes["sync"]["device_pipeline"]["completed_commits_in_run"] == 0,
          "the sync boundary must not go through the completion thread")
    check(modes["async"]["device_pipeline"]["completed_commits_in_run"] >= n // CHUNK,
          f"async: {modes['async']['device_pipeline']}")
    check(gil["inflight_after_second_staging"] == 2 and gil["first_commit_still_waiting"],
          f"GIL check: two commits must be in flight during the wait: {gil}")
    check(gil["scheduler_turns_during_wait_over_before"] > 0.5,
          f"GIL check: the scheduler thread stalled during the completion wait: {gil}")
    check(gil["host_twins_bit_equal"], "GIL check: host twins differ from the device rows")
    device_pipeline.stop_worker()
    return modes["async"]["flash_launches"]


def _profiled_commits(run) -> tuple[float, list, list[float], Scheduler]:
    """``_profiled(run)`` for a ``pw.run``, timing each commit of its scheduler -> (wall
    ms, device kernels as ``_profiled`` gives them, seconds inside each commit, the
    scheduler)."""
    inside, schedulers = [], []
    commit = Scheduler.commit

    def timed_commit(self):
        if not schedulers:
            schedulers.append(self)
        t0 = time.perf_counter()
        try:
            return commit(self)
        finally:
            inside.append(time.perf_counter() - t0)

    Scheduler.commit = timed_commit
    try:
        wall_ms, kernels, _ops = _profiled(run)
    finally:
        Scheduler.commit = commit
    return wall_ms, kernels, inside, schedulers[0]


def phase_engine_host_cost(card: Card, embedder: EncoderEmbedder, corpus) -> None:
    """The engine's host cost: a pw.run of 2,048 docs (no queries) under the profiler,
    and the device-path loop (embed_batch + index.add per 256 docs) over the same docs,
    in the same call. Wall and device-busy ms per commit, per 256 docs, and the
    device's idle share: over the whole run and over the time spent inside commits
    (the run's wall also holds the 100 ms autocommit window and the pump's idle
    polls)."""
    n = 8 * CHUNK
    factory = DeviceKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, n, 0, factory, wait_s=120.0)
    device_pipeline.PIPELINE.configure()
    mark = _pipe_mark()
    prior = os.environ.get("PATHWAY_PROCESS_METRICS")
    os.environ["PATHWAY_PROCESS_METRICS"] = "1"  # pw.run turns the scheduler's probe on
    try:
        wall_ms, kernels, inside, sched = _profiled_commits(run)
    finally:
        if prior is None:
            os.environ.pop("PATHWAY_PROCESS_METRICS", None)
        else:
            os.environ["PATHWAY_PROCESS_METRICS"] = prior
    check(len(obs["docs"]) == n and not obs["failures"], f"profiled engine run: {obs['failures']}")
    check(sched.probe and sched.stats, "the probe kept no per-node stats")
    nodes = []
    for node in sched.scope.nodes:
        st = sched.stats.get(node.index)
        if st is not None:
            nodes.append({"node": node.index, "type": type(node).__name__,
                          "name": getattr(node, "name", None), "batches": st.batches,
                          "insertions": st.insertions, "deletions": st.deletions,
                          "time_spent_ms": 1e3 * st.time_spent})
    udf_ms = sum(x["time_spent_ms"] for x in nodes if x["type"] == "BatchApplyNode")
    probed_ms = sum(x["time_spent_ms"] for x in nodes)
    busy_ms = sum(k[0] for k in kernels)
    doc_commits = len(obs["doc_times"])
    commit_ms = 1e3 * sum(inside)
    engine = {
        "docs": n, "commits_with_docs": doc_commits, "commits": len(inside),
        "wall_ms": wall_ms, "in_commit_wall_ms": commit_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "wall_ms_per_doc_commit": wall_ms / doc_commits,
        "device_busy_ms_per_doc_commit": busy_ms / doc_commits if kernels else "not measured",
        "wall_ms_per_256_docs": wall_ms / (n / CHUNK),
        "in_commit_wall_ms_per_256_docs": commit_ms / (n / CHUNK),
        "device_busy_ms_per_256_docs": busy_ms / (n / CHUNK) if kernels else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else "not measured",
        "device_idle_share_in_commits": (1.0 - busy_ms / commit_ms) if kernels else "not measured",
        "batch_apply_ms": udf_ms, "probed_nodes_ms": probed_ms,
        # the engine's own host time: in-commit wall less the batch-apply node's
        # time, which holds the embed calls
        "engine_own_ms_per_256_docs": (commit_ms - udf_ms) / (n / CHUNK),
        "outside_nodes_ms_per_256_docs": (commit_ms - probed_ms) / (n / CHUNK),
        "device_pipeline": {**device_pipeline.PIPELINE.stats(), **_pipe_since(mark)},
    }
    index = DeviceKnnIndex(dim=DIM, capacity=CAPACITY)

    def loop() -> None:
        for c in range(n // CHUNK):
            keys = range(c * CHUNK, (c + 1) * CHUNK)
            index.add(keys, embedder.embed_batch(corpus[c * CHUNK:(c + 1) * CHUNK]))

    loop_wall_ms, loop_kernels, _ops = _profiled(loop)
    loop_busy_ms = sum(k[0] for k in loop_kernels)
    device_path = {
        "docs": n, "commits": n // CHUNK, "wall_ms": loop_wall_ms,
        "device_busy_ms": loop_busy_ms if loop_kernels else "not measured",
        "wall_ms_per_commit": loop_wall_ms / (n // CHUNK),
        "device_busy_ms_per_commit": loop_busy_ms / (n // CHUNK) if loop_kernels else "not measured",
        "device_idle_share": (1.0 - loop_busy_ms / loop_wall_ms) if loop_kernels else "not measured",
    }
    card.emit("engine_host_cost", window=f"{n} docs through pw.run and through the device-path loop",
              engine=engine, device_path_loop=device_path, nodes=nodes,
              engine_top=[{"kernel": k[:80], "device_ms": ms, "launches": c} for ms, k, c in kernels[:8]])
    del index


OBS_TRACE_SAMPLE = 4  # bench.py's pipeline leg traces every 4th commit
OBS_CHAIN = dict(stages=8, base=20_000, commits=60, delta=1000)  # bench_dataflow.py's fused_chain shape
OBS_OVERHEAD_SAMPLE = 16  # the tracer's default interval, at which its overhead gate runs
OBS_GATE_PCT = 5.0
OBS_BLOCK = 4  # commits a side runs in turn in the overhead gates (a few sampler periods)
OBS_GATE_RUNS = 8  # runs an overhead gate averages (the graph with the gate on alternating)
BUCKETS = ("host_compute_s", "exchange_s", "queue_wait_s", "device_s")


def _family_total(name: str) -> float:
    """The sum over every label set of a family in the registry's snapshot."""
    fam = pmetrics.REGISTRY.snapshot().get(name)
    return sum(e["value"] for e in fam["series"]) if fam else 0.0


def _obs_marks() -> dict:
    """The process-wide counters the traced run is held to, read before and after it."""
    reg = pmetrics.REGISTRY
    return {
        "latency_count": reg.histogram("pathway_ingest_to_sink_latency_seconds").count,
        "output_rows": reg.counter("pathway_output_rows_total").value,
        "connector_entries": _family_total("pathway_connector_entries_total"),
        "knn_updates": reg.counter("pathway_device_knn_updates_total").value,
        "knn_queries": reg.counter("pathway_device_knn_queries_total").value,
    }


def _only_file(directory: str, prefix: str) -> dict:
    names = [n for n in os.listdir(directory) if n.startswith(prefix)] if os.path.isdir(directory) else []
    check(len(names) == 1, f"{directory}: {names} (one {prefix}* file expected)")
    with open(os.path.join(directory, names[0])) as fh:
        return json.load(fh)


def _observability_traced_run(card: Card, untraced_docs_per_s: float, out: str) -> int:
    """engine_pipeline's program with the tracer on (every 4th commit, as bench.py's
    pipeline leg runs it) and the sampling profiler at its default rate, each exporting
    into ``out``: the answers, the traces, the exported files and the registry's
    exposition checked; -> the forward kernel's launches."""
    corpus = [doc_text(i) for i in range(N_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, N_DOCS, N_QUERIES, factory, wait_s=300.0)
    trace_dir, profile_dir = os.path.join(out, "traces"), os.path.join(out, "profiles")
    gc.collect()
    device_pipeline.PIPELINE.configure()
    before = _obs_marks()
    fa.KERNEL.launches = 0
    tracing.TRACER.configure(enabled=True, sample=OBS_TRACE_SAMPLE, clear=True)
    profiling.PROFILER.configure(enabled=True, clear=True)  # PATHWAY_TPU_PROFILE_HZ: 50
    try:
        with _KeptRunner() as kept:
            t0 = time.perf_counter()
            _with_env({"PATHWAY_TPU_TRACE_DIR": trace_dir, "PATHWAY_TPU_PROFILE_DIR": profile_dir}, run)
            run_s = time.perf_counter() - t0
        traces = tracing.TRACER.traces()
        interval = tracing.TRACER.interval
    finally:
        tracing.TRACER.configure(enabled=False, clear=True)
        profiling.PROFILER.configure(enabled=False, clear=True)
    launches = fa.KERNEL.launches
    delta = {k: v - before[k] for k, v in _obs_marks().items()}
    recall, self_hit = _engine_recall(obs)
    ingest_s = obs["ingest_end"] - obs["run_start"]
    docs_per_s = N_DOCS / ingest_s if ingest_s > 0 else float("nan")

    chrome = tracing.chrome_trace(traces)
    tracing.validate_chrome_trace(chrome)
    exported = _only_file(trace_dir, "pathway_trace_p")
    tracing.validate_chrome_trace(exported)
    doc = _only_file(profile_dir, "pathway_profile_p")
    profiling.validate_profile(doc)
    memory = doc["workers"]["0"]["device"].get("memory", {})
    text = pmetrics.render_snapshots({"0": pmetrics.full_snapshot(kept.runners[0].scheduler)})
    families = pmetrics.validate_exposition(text)
    mem_series = {(la["device"], la["stat"]) for _n, la, _v
                  in families.get("pathway_device_memory_bytes", {"samples": []})["samples"]}

    clamped = [t["commit_time"] for t in traces if t["critical_path"]["clamped"]]
    sums_off = [abs(sum(t["critical_path"][b] for b in BUCKETS) - t["critical_path"]["wall_s"])
                for t in traces if not t["critical_path"]["clamped"]]
    names = {s["name"] for t in traces for s in t["spans"]}
    cats = collections.Counter(s["cat"] for t in traces for s in t["spans"])
    shares = {b: float(np.median([t["critical_path"]["shares"][b] for t in traces]))
              for b in ("host_compute", "exchange", "queue_wait", "device")} if traces else {}
    card.emit(
        "observability_traced_run",
        model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)", capacity=CAPACITY,
        n_docs=len(obs["docs"]), n_answers=len(obs["answers"]), query_timeouts=len(obs["timeouts"]),
        docs_per_s_traced=docs_per_s, docs_per_s_untraced_engine_pipeline=untraced_docs_per_s,
        traced_over_untraced=docs_per_s / untraced_docs_per_s, run_s=run_s,
        recall_at_10=recall, self_hit=self_hit, traces=len(traces), sample_interval_at_end=interval,
        median_bucket_shares=shares, clamped_traces=len(clamped), clamped_commit_times=clamped,
        largest_bucket_sum_error_s=max(sums_off, default=0.0), span_categories=dict(cats),
        span_names=sorted(names), registry_deltas=delta, profile_phase_totals_s=doc["phases"],
        profile_samples=doc["workers"]["0"]["sample_count"], profile_rate_hz=doc["workers"]["0"]["rate_hz"],
        profile_memory=memory, exposition_families=len(families), flash_launches=launches,
        embed_calls=embed_calls[0], failures=obs["failures"],
    )
    check(not obs["failures"], f"observability: {obs['failures']}")
    check(len(obs["docs"]) == N_DOCS, f"observability: {len(obs['docs'])} of {N_DOCS} docs arrived")
    check(len(obs["answers"]) == N_QUERIES and not obs["timeouts"],
          f"observability: {len(obs['answers'])} answers, timeouts {obs['timeouts']}")
    check(recall >= 0.99 and self_hit, f"observability: recall@10 {recall}, self hit {self_hit}")
    check(len(traces) > 0 and max(sums_off, default=0.0) <= 4e-6,
          f"observability: bucket sums off the wall by {max(sums_off, default=0.0)} s")
    check(all(t["critical_path"]["host_compute_s"] == 0.0 for t in traces if t["critical_path"]["clamped"]),
          "observability: a clamped trace kept host time")
    check({"ingest-wait", "knn-update", "knn-search"} <= names and cats["op"] > 0 and cats["sink"] > 0,
          f"observability: spans {sorted(names)}, categories {dict(cats)}")
    check(delta["latency_count"] == delta["output_rows"] > 0,
          f"observability: latency count {delta['latency_count']} != sink rows {delta['output_rows']}")
    check(delta["connector_entries"] == N_DOCS + N_QUERIES,
          f"observability: connector entries {delta['connector_entries']}")
    check(delta["knn_queries"] == N_QUERIES and delta["knn_updates"] >= N_DOCS,
          f"observability: knn counters {delta}")
    check(memory.get("cuda:0", {}).get("bytes_in_use", 0) > 0, f"observability: profile memory {memory}")
    check({("cuda:0", st) for st in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")} <= mem_series,
          f"observability: device memory series {sorted(mem_series)}")
    check(launches > 0 and launches == LAYERS * embed_calls[0],
          f"observability: flash launches {launches} != {LAYERS} x {embed_calls[0]} embed calls")
    return launches


def _traced_groupby(rows: list, traced: bool) -> tuple[dict | None, tuple]:
    """One groupby_sum commit of ``rows`` on the card, in the tracer's commit bracket
    (every commit sampled when ``traced``) -> (its trace, the output state)."""
    sched, node = _groupby_prepared(rows, _sum_count(), 2)
    tracing.TRACER.configure(enabled=traced, sample=1, clear=True)
    try:
        ctx = tracing.TRACER.begin(sched.time, origin_mono=time.monotonic())
        t = sched.commit()
        trace = tracing.TRACER.end(t) if ctx is not None else None
    finally:
        tracing.TRACER.configure(enabled=False, clear=True)
    return trace, _final_state(node)


def _observability_device_bucket(card: Card, rows: list) -> int:
    """groupby_sum's 1M-row commit on the card, untraced then traced: the trace's device
    bucket holds the segment reduction's ns and the output keeps its bits; -> the
    segment kernels' launches in the traced commit."""
    _none, plain = _with_device_ops("1", lambda: _traced_groupby(rows, False))
    _zero_segment_launches()
    trace, traced = _with_device_ops("1", lambda: _traced_groupby(rows, True))
    launches = _segment_launches()
    cp = trace["critical_path"]
    card.emit("observability_device_bucket", workload="groupby_sum", rows=len(rows),
              device_kernel_ns=trace["device_kernel_ns"], device_s=trace["device_s"],
              critical_path={k: v for k, v in cp.items() if k != "chain"},
              spans=[(s["name"], s["cat"], s["dur"]) for s in trace["spans"]],
              segment_launches=launches, bit_identical=_same_state(plain, traced))
    check("device_ops.segment_reduce" in trace["device_kernel_ns"] and trace["device_s"] > 0,
          f"observability: device bucket {trace['device_kernel_ns']}")
    check(_same_state(plain, traced), "observability: the traced groupby's output differs")
    check(sum(launches.values()) > 0, f"observability: segment launches {launches}")
    return sum(launches.values())


def _fused_chain(probe: bool = False) -> tuple:
    """bench_dataflow.py's fused_chain graph on the port's Scope and Scheduler: an
    expression, a filter, 8 expression stages -> (its scheduler, with per-operator probe
    stats when ``probe``, and its input session)."""
    scope = Scope()
    sess = scope.input_session(2)
    cur = scope.expression_table(sess, [eex.ColumnRef(0), eex.ColumnRef(1),
                                        eex.Binary(">", eex.ColumnRef(0), eex.Const(100))])
    cur = scope.filter_table(cur, 2)
    for _ in range(OBS_CHAIN["stages"]):
        cur = scope.expression_table(cur, [eex.ColumnRef(0), eex.Binary(
            "+", eex.Binary("*", eex.ColumnRef(1), eex.Const(1.0000001)), eex.Const(0.5))])
    return Scheduler(scope, probe=probe), sess


def _fused_chain_pair(rows: list, gate: str, on_side: int) -> tuple[list, list]:
    """Two fused_chain graphs over the same rows, their commits in blocks of
    ``OBS_BLOCK`` in turn (the side that leads a pair of blocks alternating): the base
    rows, then commits of retractions and inserts. Graph ``on_side``'s commits run with
    ``gate`` on: ``trace``, each in the tracer's commit bracket at 1/16; ``profile``,
    with the profiler's 50 Hz sampler thread running over each of its blocks (started
    before the block and stopped after it, both outside the timed commits; a block holds
    several of the thread's periods, so the tick a start forgoes is a small share);
    ``metrics``, ``bench_dataflow.py::metrics_overhead_leg``'s per-commit work (the
    graph's scheduler probing every operator, then ``StatsMonitor(ALL).on_commit``, the
    ingest-to-sink histogram's ``observe_n`` and a ``commit`` flight event, all inside
    the timed commit); ``null``, as the other.
    -> each commit's seconds ([off], [on]). Interleaving blocks of commits, not whole
    runs, puts both sides under the same pace of the host, whose CPU throughput swings
    by tens of percent within a second: on the card's host, runs of the same work a run
    apart differ by more than the 5% gate, so no comparison of separate runs resolves
    it. The heap is collected before the run and the collector is off during it: a
    collection inside the run (a fifth of its time, in steps of milliseconds) would land
    on whichever graph's commit crossed its threshold."""
    gc.collect()
    gc.disable()
    graphs = [_fused_chain(probe=gate == "metrics" and side == on_side) for side in (0, 1)]
    monitor = hist = None
    if gate == "metrics":
        from pathway_tpu_torch.internals.monitoring import MonitoringLevel, StatsMonitor

        monitor = StatsMonitor(MonitoringLevel.ALL)
        monitor.scheduler = graphs[on_side][0]
        hist = pmetrics.REGISTRY.histogram("pathway_ingest_to_sink_latency_seconds")
    tracing.TRACER.configure(enabled=gate == "trace", sample=OBS_OVERHEAD_SAMPLE, clear=True)
    profiling.PROFILER.configure(enabled=gate == "profile", clear=True)
    try:
        for sched, sess in graphs:
            for key, row in rows:
                sess.insert(key, row)
            sched.commit()
        times: list[list[float]] = [[], []]
        base_n, delta = OBS_CHAIN["base"], OBS_CHAIN["delta"]
        for b in range(0, OBS_CHAIN["commits"], OBS_BLOCK):
            for side in ((0, 1) if (b // OBS_BLOCK) % 2 == 0 else (1, 0)):
                sched, sess = graphs[side]
                on = side == on_side
                if on:
                    check(profiling.PROFILER.maybe_start() == (gate == "profile"),
                          "the profiler's thread did not start")
                for c in range(b, min(b + OBS_BLOCK, OBS_CHAIN["commits"])):
                    base = (c * delta) % (base_n - delta)
                    for i in range(base, base + delta):
                        key, row = rows[i]
                        sess.remove(key, row)
                        sess.insert(key, (row[0], row[1] + 1.0))
                    t0 = time.perf_counter()
                    wall = time.monotonic()
                    ctx = tracing.TRACER.begin(sched.time, origin_mono=wall) if on else None
                    sched.commit()
                    if ctx is not None:
                        tracing.TRACER.end(sched.time - 1)
                    if on and monitor is not None:
                        monitor.on_commit(c, wall)
                        hist.observe_n(time.monotonic() - wall, 2 * delta)
                        pmetrics.FLIGHT.record("commit", time=c)
                    times[on].append(time.perf_counter() - t0)
                profiling.PROFILER.stop()
        check(gate != "profile" or profiling.PROFILER._samples > 0, "the profiler took no sample")
        return times[0], times[1]
    finally:
        profiling.PROFILER.stop()
        tracing.TRACER.configure(enabled=False, clear=True)
        profiling.PROFILER.configure(enabled=False, clear=True)
        gc.enable()


def _overhead(rows: list, gate: str) -> dict:
    """``OBS_GATE_RUNS`` runs, the two ways' blocks of commits interleaved in each run
    and the graph that runs with the gate on alternating between runs -> the overhead:
    the mean over the runs of each run's total on over its total off, less 1. Beside
    it, two readings the gate does not use: the best of the runs each way (each
    commit's best run, summed over the 60 commits), and the median of all commits'
    on/off ratios, which cannot see a cost that only the sampled commits carry."""
    runs = [_fused_chain_pair(rows, gate, on_side=r % 2) for r in range(OBS_GATE_RUNS)]
    paired = [sum(on) / sum(off) for off, on in runs]
    t_off, t_on = (sum(min(col) for col in zip(*(r[way] for r in runs))) for way in (0, 1))
    ratios = sorted(b / a for r in runs for a, b in zip(r[0], r[1]))
    return {"overhead_pct": 100.0 * (sum(paired) / len(paired) - 1.0),
            "runs_pct": [100.0 * (p - 1.0) for p in paired],
            "off_s": [sum(off) for off, _on in runs], "on_s": [sum(on) for _off, on in runs],
            "best_of_runs_pct": 100.0 * (t_on - t_off) / t_off,
            "commit_median_pct": 100.0 * (ratios[len(ratios) // 2] - 1.0)}


def _overhead_child(kind: str) -> int:
    """``chip_smoke.py --overhead-gate trace|profile|metrics|null``: one gate's reading,
    printed as the last line, in a fresh process (the parent's heap, a million rows and
    the models, would make its garbage collections set the pace)."""
    rows = [(pw.ref_scalar(i), (i, float(i) * 0.5)) for i in range(OBS_CHAIN["base"])]
    print(json.dumps(_overhead(rows, kind)), flush=True)
    return 0


def _overhead_gate(kind: str) -> dict:
    """One gate's reading from a child process (as the JAX package's gates run theirs)."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--overhead-gate", kind],
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _observability_flight(card: Card, out: str) -> dict:
    """A streamed pw.run with every commit traced whose UDF raises on one row (an
    error row and a flight ``error`` event: a UDF's exception does not end a run, in
    either package) and whose sink then raises on the same commit: the flight dump in
    PATHWAY_TPU_FLIGHT_DIR must hold run_start, commit, error and run_error, and carry
    the trace in flight."""
    flight_dir = os.path.join(out, "flight")
    landed = threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for c in range(2):
                landed.clear()
                for i in range(8):
                    self.next(x=c * 8 + i)
                if not landed.wait(timeout=60.0):
                    return

    @pw.udf
    def checked(x: int) -> int:
        if x == 9:
            raise ValueError("the UDF raised on x = 9")
        return x

    def on_change(key, row, time, is_addition):
        if row["x"] == 15:
            raise RuntimeError("the sink raised on x = 15")
        if row["x"] == 7:
            landed.set()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(x=int), autocommit_duration_ms=50)
    pw.io.subscribe(t.select(x=pw.this.x, y=checked(pw.this.x)), on_change=on_change)
    pmetrics.FLIGHT.clear()
    tracing.TRACER.configure(enabled=True, sample=1, clear=True)
    tracing.TRACER._adapt = lambda *a: None  # every commit sampled, the raising one too
    raised = None
    try:
        _with_env({"PATHWAY_TPU_FLIGHT_DIR": flight_dir}, pw.run)
    except RuntimeError as e:
        raised = str(e)
    finally:
        del tracing.TRACER._adapt
        tracing.TRACER.configure(enabled=False, clear=True)
    dump = _only_file(flight_dir, "pathway_flight_p")
    kinds = [e["kind"] for e in dump["events"]]
    run_error = [e for e in dump["events"] if e["kind"] == "run_error"]
    got = {"raised": raised, "reason": dump["reason"], "kinds": kinds, "trace_id": dump["trace_id"],
           "run_error_trace_id": run_error[0].get("trace_id") if run_error else None}
    check(raised is not None and "x = 15" in raised, f"observability: pw.run raised {raised!r}")
    check({"run_start", "commit", "error", "run_error"} <= set(kinds), f"observability: flight {kinds}")
    check(dump["trace_id"] is not None and got["run_error_trace_id"] == dump["trace_id"],
          f"observability: flight trace ids {got}")
    return got


def phase_observability(card: Card, untraced_docs_per_s: float, groupby_rows: list) -> dict:
    """The why plane on the card: (a) engine_pipeline's program traced and profiled,
    (b) the device bucket of a 1M-row groupby commit, (c) the tracer's and the
    profiler's overhead on bench_dataflow.py's fused_chain (each must stay at or under
    5%) and a raising run's flight dump. -> the forward kernel's and the segment
    kernels' launches."""
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="pw_observability_")
    try:
        flash = _observability_traced_run(card, untraced_docs_per_s, out)
        segment = _observability_device_bucket(card, groupby_rows)
        trace_gate = _overhead_gate("trace")
        profile_gate = _overhead_gate("profile")
        if profile_gate["overhead_pct"] > OBS_GATE_PCT:
            # the sampler steals time only through the GIL: one reading past the gate
            # is retried, as the JAX package's profile gate does
            profile_gate = dict(_overhead_gate("profile"), retried_after=profile_gate)
        flight = _observability_flight(card, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    card.emit("observability", seconds=time.perf_counter() - t_phase,
              chain=OBS_CHAIN, trace_overhead=dict(trace_gate, sample=OBS_OVERHEAD_SAMPLE),
              profile_overhead=profile_gate, flight=flight)
    check(trace_gate["overhead_pct"] <= OBS_GATE_PCT, f"trace overhead {trace_gate}")
    check(profile_gate["overhead_pct"] <= OBS_GATE_PCT, f"profile overhead {profile_gate}")
    return {"flash": flash, "segment": segment}


# -- watch: the monitoring plane on the card ---------------------------------------

WATCH_SCRAPE_S = 0.25  # the scraper's period: Prometheus' fastest common interval, x4
WATCH_SLO = [
    # must burn: no commit delivers its rows within a microsecond
    {"name": "watch_ingest_p95", "kind": "latency", "family": "pathway_ingest_to_sink_latency_seconds",
     "bound": 1e-6, "quantile": "p95"},
    # must hold: the connectors' rows/s stay above 1 while the run feeds them
    {"name": "watch_entries_floor", "kind": "throughput", "family": "pathway_connector_entries_total",
     "bound": 1.0, "labels": {"connector": "python-connector"}},
]
WATCH_DOCS = 10_000  # (a)'s docs: half of engine_pipeline's, since its pace waits out each commit
WATCH_LOCK_DOCS = 4096  # the lock-order children's docs and queries
WATCH_LOCK_QUERIES = 16
WATCH_PACKAGES = ("rich", "psutil", "aiohttp", "requests")
WATCH_FLIGHT_EVENTS = 4096  # the phase's flight ring: every commit's event and the SLO's


def _imports(name: str) -> bool:
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def _free_port() -> int:
    """A port no one listens on (bound at 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_get(port: int, path: str) -> tuple[int, bytes, float]:
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            code, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, time.perf_counter() - t0


def _watch_threads() -> list[str]:
    """The watch plane's threads still alive: the timeseries loop, the telemetry
    sampler, the HTTP server's accept loop and its handler threads."""
    return [t.name for t in threading.enumerate() if t.is_alive() and (
        t.name in ("pathway-timeseries", "pw-telemetry") or "serve_forever" in t.name
        or "process_request_thread" in t.name)]


class _Scraper(threading.Thread):
    """GETs ``/metrics`` every ``WATCH_SCRAPE_S`` while the run lasts (until ``done()``
    or ``halt``), keeping each scrape's start, end, status and body; once ``after()``
    holds, GETs ``/timeseries`` (the index, a family, a bad window), ``/requests`` and
    ``/profile`` once."""

    def __init__(self, port: int, done, after) -> None:
        super().__init__(name="watch-scraper", daemon=True)
        self.port, self.done, self.after = port, done, after
        self.halt = threading.Event()
        self.scrapes: list[tuple[float, float, int, str]] = []
        self.errors: list[tuple[float, str]] = []
        self.once: dict | None = None

    def run(self) -> None:
        while not self.halt.is_set() and not self.done():
            t0 = time.perf_counter()
            try:
                code, body, _s = _http_get(self.port, "/metrics")
                self.scrapes.append((t0, time.perf_counter(), code, body.decode()))
                if self.once is None and self.after():
                    fam = "/timeseries?family=pathway_connector_entries_total&window=600&worker=0"
                    self.once = {path: _http_get(self.port, path)[:2] for path in (
                        "/timeseries", fam, fam.replace("window=600", "window=soon"), "/requests",
                        "/profile")}
            except OSError as e:  # refused before the server starts; kept, judged by time
                self.errors.append((t0, repr(e)))
            self.halt.wait(max(0.0, WATCH_SCRAPE_S - (time.perf_counter() - t0)))


class _MonitorCommits:
    """Records, while open, the end of each ``StatsMonitor.on_commit`` and the
    entries its connector rows held: when the monitor synced the last doc."""

    def __enter__(self):
        from pathway_tpu_torch.internals.monitoring import StatsMonitor

        self.cls, self.commits = StatsMonitor, []
        self._on_commit = on_commit = StatsMonitor.on_commit
        seen = self.commits

        def recorded(monitor, time_, wall_start):
            on_commit(monitor, time_, wall_start)
            seen.append((time.perf_counter(), time.time(),
                         {n: st.entries for n, st in monitor.connectors.items()}))

        StatsMonitor.on_commit = recorded
        return self

    def __exit__(self, *exc):
        self.cls.on_commit = self._on_commit


def _unlabelled(text: str, family: str) -> list[tuple[dict, float]]:
    fams = pmetrics.validate_exposition(text)
    return [(la, v) for _n, la, v in fams.get(family, {"samples": []})["samples"] if "worker" not in la]


def _watched_run(n_docs: int, n_queries: int, out: str, slo: list | None, trace: bool) -> dict:
    """engine_pipeline's program (MiniLM-L6, the 1,048,576-slot index, 256-doc paced
    commits) under ``pw.run(monitoring_level=ALL if rich imports else NONE,
    with_http_server=True)`` on a free port, with the profiler, the timeseries loop
    (0.1 s), the telemetry sampler (0.5 s), the SLO specs ``slo``, tracing at every 4th
    commit when ``trace``, the async device pipeline, and a scraper thread; -> what the
    run and the scraper saw."""
    from pathway_tpu_torch.internals import telemetry, timeseries

    corpus = [doc_text(i) for i in range(n_docs)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, n_docs, n_queries, factory, wait_s=300.0, pace=CHUNK)
    rich_ok = _imports("rich")
    port = _free_port()
    env = {"PATHWAY_TPU_PROFILE": "1", "PATHWAY_TPU_PROFILE_DIR": os.path.join(out, "profiles"),
           "PATHWAY_TPU_TRACE_DIR": os.path.join(out, "traces"),
           "PATHWAY_TPU_FLIGHT_DIR": os.path.join(out, "flight"), "PATHWAY_TPU_TS_INTERVAL": "0.1",
           "PATHWAY_PROCESS_METRICS": "1", "PATHWAY_TELEMETRY_INTERVAL_S": "0.5",
           "PATHWAY_TPU_SLO": json.dumps(slo) if slo else None}
    scraper = _Scraper(port, done=lambda: len(obs["answers"]) + len(obs["timeouts"]) >= n_queries
                       or bool(obs["failures"]), after=lambda: bool(obs["ingest_end"]))
    gc.collect()
    device_pipeline.PIPELINE.configure()
    check(device_pipeline.async_enabled(), "watch: the device pipeline must run async here")
    timeseries.STORE.clear()
    flight, pmetrics.FLIGHT = pmetrics.FLIGHT, pmetrics.FlightRecorder(WATCH_FLIGHT_EVENTS)
    fa.KERNEL.launches = 0
    dashboard = io.StringIO()

    def watched() -> None:
        timeseries.SENTINEL.configure()  # PATHWAY_TPU_SLO, the burn states re-armed
        profiling.PROFILER.configure(clear=True)  # PATHWAY_TPU_PROFILE=1
        if trace:
            tracing.TRACER.configure(enabled=True, sample=OBS_TRACE_SAMPLE, clear=True)
        scraper.start()
        try:
            with contextlib.redirect_stdout(dashboard):  # rich's live table, if any
                run(monitoring_level=pw.MonitoringLevel.ALL if rich_ok else pw.MonitoringLevel.NONE,
                    with_http_server=True, monitoring_server_port=port)
        finally:
            scraper.halt.set()
            scraper.join(timeout=60.0)
            tracing.TRACER.configure(enabled=False, clear=True)
            profiling.PROFILER.configure(enabled=False, clear=True)

    try:
        with _MonitorCommits() as commits:
            t0 = time.perf_counter()
            _with_env(env, watched)
            run_s = time.perf_counter() - t0
        events = pmetrics.FLIGHT.snapshot()
    finally:
        pmetrics.FLIGHT = flight
        timeseries.SENTINEL.configure([])
    launches = fa.KERNEL.launches
    deadline = time.monotonic() + 2.0  # a handler thread closing its last connection
    while _watch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    threads_after = _watch_threads()
    with socket.socket() as s:
        # the run released its port: a server binds it again (with SO_REUSEADDR, as
        # http.server does: the closed scrapes' connections linger in TIME_WAIT)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()
    recall, self_hit = _engine_recall(obs)
    ingest_s = obs["ingest_end"] - obs["run_start"]
    ids = {qid: sorted(obs["docs"][k][0] for k in hit if k in obs["docs"])
           for qid, (hit, _q) in obs["answers"].items()}
    return {"obs": obs, "run_s": run_s, "ingest_s": ingest_s, "port": port, "recall": recall,
            "self_hit": self_hit, "answers": ids, "launches": launches, "embed_calls": embed_calls[0],
            "scraper": scraper, "commits": commits.commits, "events": events,
            "threads_after": threads_after, "rich": rich_ok, "dashboard_chars": len(dashboard.getvalue()),
            "process": telemetry.latest_process_metrics()}


def _watch_main_run(card: Card, engine_docs_per_s: float, out: str) -> int:
    """(a): the main path watched live at 10,000 docs and 64 queries, its scrapes,
    routes, SLO verdicts, process samples and threads checked; -> the forward kernel's
    launches."""
    got = _watched_run(WATCH_DOCS, N_QUERIES, out, WATCH_SLO, trace=False)
    obs, scraper = got["obs"], got["scraper"]
    run_start, ingest_end = obs["run_start"], obs["ingest_end"]
    # the first monitor commit whose doc row held every doc, and the first scrape after it
    synced = next((t for t, _w, entries in got["commits"] if entries.get("python-connector") == WATCH_DOCS),
                  None)
    scrapes = [(t0, t1, code, body) for t0, t1, code, body in scraper.scrapes]
    during = [s for s in scrapes if run_start <= s[0] and s[1] <= ingest_end]
    bad = [(i, code) for i, (_a, _b, code, _t) in enumerate(scrapes) if code != 200]
    commits_seen, invalid = [], []
    for _t0, _t1, _code, body in scrapes:
        try:
            commits_seen.append(_unlabelled(body, "pathway_commits_total")[0][1])
        except ValueError as e:
            invalid.append(repr(e))
    after_sync = next((s for s in scrapes if synced is not None and s[0] >= synced), None)
    doc_entries = ({la["connector"]: v for la, v in _unlabelled(after_sync[3], "pathway_input_entries_total")}
                   if after_sync else {})
    once = scraper.once or {}
    fam = "/timeseries?family=pathway_connector_entries_total&window=600&worker=0"
    series = json.loads(once[fam][1])["series"] if once.get(fam, (0,))[0] == 200 else []
    points = [v for s in series for _t, v in s["points"]]
    profile = json.loads(once["/profile"][1]) if once.get("/profile", (0,))[0] == 200 else {}
    if profile:
        profiling.validate_profile(profile)
    memory = profile.get("workers", {}).get("0", {}).get("device", {}).get("memory", {})
    burns = [e for e in got["events"] if e["kind"] == "slo_burn"]
    # the floor is first evaluated over the ring's first two ticks (0.1 s apart): when
    # the paced feed's second batch lands after both, it reads 0 rows/s there, before
    # the monitor's second commit; any other burn of the floor is a real breach
    second_commit = got["commits"][1][1] if len(got["commits"]) > 1 else float("inf")
    floor_burns = [e for e in burns if e["slo"] == "watch_entries_floor"]
    startup = [e for e in floor_burns if e["measured"] == 0.0 and e["wall"] <= second_commit]
    breaches = {e["labels"]["slo"]: e["value"] for e in (pmetrics.REGISTRY.snapshot().get(
        "pathway_slo_breaches_total") or {"series": []})["series"]}
    tick = pmetrics.REGISTRY.histogram("pathway_timeseries_tick_seconds")
    lat = sorted(t1 - t0 for t0, t1, _c, _b in scrapes)
    proc = got["process"]
    top_ops = max((st["insertions"] for st in proc.get("operators", {}).values()), default=0)
    errors_in_run = [e for t, e in scraper.errors if run_start <= t <= ingest_end]
    docs_per_s = WATCH_DOCS / got["ingest_s"] if got["ingest_s"] > 0 else float("nan")
    card.emit(
        "watch_main_path", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
        capacity=CAPACITY, n_docs=len(obs["docs"]), n_answers=len(obs["answers"]),
        query_timeouts=len(obs["timeouts"]), docs_per_s_watched=docs_per_s,
        docs_per_s_engine_pipeline=engine_docs_per_s,
        watched_over_engine_pipeline=docs_per_s / engine_docs_per_s,
        run_s=got["run_s"], ingest_s=got["ingest_s"], recall_at_10=got["recall"], self_hit=got["self_hit"],
        monitoring_level="ALL" if got["rich"] else "NONE", dashboard_chars=got["dashboard_chars"],
        imports={name: _imports(name) for name in WATCH_PACKAGES},
        scrapes=len(scrapes), scrapes_while_embedding=len(during), scrape_errors_in_ingest=errors_in_run,
        scrape_errors=len(scraper.errors), non_200=bad, invalid_bodies=invalid,
        scrape_p50_ms=1e3 * lat[len(lat) // 2] if lat else None,
        scrape_p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
        commits_first_last=[commits_seen[0], commits_seen[-1]] if commits_seen else None,
        entries_after_ingest=doc_entries, once_codes={p: c for p, (c, _b) in once.items()},
        timeseries_points=len(points),
        slo_burns=[(e["slo"], e["burn"], e["measured"], e["wall"] - second_commit) for e in burns],
        floor_startup_burns=len(startup),
        slo_breaches=breaches, tick_count=tick.count, tick_p50_ms=1e3 * tick.quantile(0.5),
        tick_p99_ms=1e3 * tick.quantile(0.99), profile_memory=memory,
        process_rss_bytes=proc.get("memory_rss_bytes"), process_threads=proc.get("num_threads"),
        largest_operator_insertions=top_ops, threads_after_run=got["threads_after"],
        flash_launches=got["launches"], embed_calls=got["embed_calls"], failures=obs["failures"],
    )
    check(not obs["failures"], f"watch: {obs['failures']}")
    check(len(obs["docs"]) == WATCH_DOCS, f"watch: {len(obs['docs'])} of {WATCH_DOCS} docs arrived")
    check(len(obs["answers"]) == N_QUERIES and not obs["timeouts"],
          f"watch: {len(obs['answers'])} answers, timeouts {obs['timeouts']}")
    check(got["recall"] >= 0.99 and got["self_hit"],
          f"watch: recall@10 {got['recall']}, self hit {got['self_hit']}")
    check(len(during) >= 10, f"watch: {len(during)} scrapes landed while docs were embedded")
    check(not bad and not invalid and not errors_in_run, f"watch: scrapes {bad} {invalid} {errors_in_run}")
    check(all(b >= a for a, b in zip(commits_seen, commits_seen[1:])), f"watch: commits fell: {commits_seen}")
    check(doc_entries.get("python-connector") == WATCH_DOCS, f"watch: entries after ingest {doc_entries}")
    check(len(points) >= 5 and all(b >= a for a, b in zip(points, points[1:])),
          f"watch: /timeseries points {points}")
    check(once.get(fam.replace("window=600", "window=soon"), (0,))[0] == 400, f"watch: bad window {once}")
    check(once.get("/requests", (0,))[0] == 200 and "requests" in json.loads(once["/requests"][1]),
          f"watch: /requests {once.get('/requests')}")
    check(once.get("/timeseries", (0,))[0] == 200, f"watch: /timeseries {once.get('/timeseries')}")
    check(memory.get("cuda:0", {}).get("bytes_in_use", 0) > 0, f"watch: /profile memory {memory}")
    check([e["slo"] for e in burns if e["slo"] != "watch_entries_floor"] == ["watch_ingest_p95"],
          f"watch: slo_burn events {burns}")
    check(floor_burns == startup and len(startup) <= 1, f"watch: the floor burned while rows flowed {burns}")
    check(breaches.get("watch_ingest_p95") == 1 and breaches.get("watch_entries_floor", 0) == len(startup),
          f"watch: breaches {breaches}")
    check((proc.get("memory_rss_bytes") or 0) > 0 and top_ops >= WATCH_DOCS, f"watch: process sample {proc}")
    check(not got["threads_after"], f"watch: threads alive after pw.run: {got['threads_after']}")
    check(got["launches"] > 0 and got["launches"] == LAYERS * got["embed_calls"],
          f"watch: flash launches {got['launches']} != {LAYERS} x {got['embed_calls']} embed calls")
    return got["launches"]


def _lockwatch_child(args: list[str]) -> int:
    """``chip_smoke.py --lockwatch-child <dir>``: the watched program at 4,096 docs and
    16 queries with every background thread on, in a fresh process whose environment
    says whether the lock-order watcher runs; prints what it saw as the last line."""
    from pathway_tpu_torch.internals import lockwatch, timeseries

    got = _watched_run(WATCH_LOCK_DOCS, WATCH_LOCK_QUERIES, args[0], None, trace=True)
    sites = {}
    if lockwatch._INSTALLED:
        acquired = {s["labels"]["lock"]: s["value"] for s in
                    pmetrics.REGISTRY.snapshot()["pathway_lock_acquisitions_total"]["series"]}
        for what, lock in (("metrics", pmetrics.REGISTRY._lock), ("timeseries", timeseries.STORE._lock),
                           ("device_pipeline", device_pipeline.PIPELINE._lock)):
            sites[what] = (lock._name, acquired.get(lock._name, 0.0))
    print(json.dumps({
        "installed": lockwatch._INSTALLED,
        "torch_lock_watched": isinstance(getattr(torch.cuda, "_initialization_lock", None),
                                         lockwatch._WatchedLock),
        "cycles": lockwatch.cycles(), "sites": sites, "run_s": got["run_s"],
        "docs": len(got["obs"]["docs"]), "answers": got["answers"], "timeouts": got["obs"]["timeouts"],
        "failures": got["obs"]["failures"], "recall": got["recall"], "self_hit": got["self_hit"],
        "scrapes": len(got["scraper"].scrapes), "threads_after": got["threads_after"],
        "launches": got["launches"]}), flush=True)
    return 0


def _lockwatch_children(card: Card, out: str) -> dict:
    """(c): the watched and the plain child, one after the other; -> their readings."""
    got = {}
    for mode in ("watched", "plain"):
        d = os.path.join(out, mode)
        os.makedirs(d)
        env = dict(os.environ, PATHWAY_TPU_LOCKWATCH="1" if mode == "watched" else "0",
                   PATHWAY_TPU_LOCKWATCH_DIR=d)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--lockwatch-child", d],
                              env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"lockwatch {mode} child exit {proc.returncode}: {proc.stderr[-4000:]}")
        got[mode] = dict(json.loads(proc.stdout.strip().splitlines()[-1]), process_s=wall,
                         reports=[n for n in os.listdir(d) if n.startswith("pathway_lockwatch_cycle_p")])
    w, p = got["watched"], got["plain"]
    same = {q: w["answers"].get(q) == ids for q, ids in p["answers"].items()}
    card.emit("watch_lockwatch", docs=WATCH_LOCK_DOCS, queries=WATCH_LOCK_QUERIES,
              watched_process_s=w["process_s"], plain_process_s=p["process_s"],
              watched_run_s=w["run_s"], plain_run_s=p["run_s"],
              watched_over_plain_run=w["run_s"] / p["run_s"], cycles=w["cycles"], reports=w["reports"],
              lock_sites=w["sites"], torch_lock_watched=w["torch_lock_watched"],
              installed={"watched": w["installed"], "plain": p["installed"]},
              scrapes={"watched": w["scrapes"], "plain": p["scrapes"]},
              recall={"watched": w["recall"], "plain": p["recall"]},
              same_top10=sum(same.values()), launches={"watched": w["launches"], "plain": p["launches"]},
              threads_after={"watched": w["threads_after"], "plain": p["threads_after"]})
    for mode, g in got.items():
        check(not g["failures"] and g["docs"] == WATCH_LOCK_DOCS and not g["timeouts"]
              and len(g["answers"]) == WATCH_LOCK_QUERIES and g["self_hit"] and not g["threads_after"],
              f"lockwatch {mode} child: {g}")
    check(w["installed"] and not p["installed"] and w["torch_lock_watched"], f"lockwatch: installs {got}")
    check(not w["cycles"] and not w["reports"], f"lockwatch: cycles {w['cycles']}, reports {w['reports']}")
    check(all(v > 0 for _name, v in w["sites"].values()) and len(w["sites"]) == 3,
          f"lockwatch: acquisitions {w['sites']}")
    check(all(same.values()) and len(same) == WATCH_LOCK_QUERIES, f"lockwatch: top-10 differ {same}")
    return got


def phase_watch(card: Card, engine_docs_per_s: float) -> dict:
    """The watch plane on the card: (a) the main path under pw.run's monitoring
    options, scraped live; (b) the metrics plane's cost on fused_chain (at most 5%, one
    retry); (c) the lock-order watcher over every background thread, in two child
    processes. -> the forward kernel's launches in (a)."""
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="pw_watch_")
    try:
        flash = _watch_main_run(card, engine_docs_per_s, out)
        t_gate = time.perf_counter()
        metrics_gate = _overhead_gate("metrics")
        if metrics_gate["overhead_pct"] > OBS_GATE_PCT:
            metrics_gate = dict(_overhead_gate("metrics"), retried_after=metrics_gate)
        gate_s = time.perf_counter() - t_gate
        t_lock = time.perf_counter()
        children = _lockwatch_children(card, out)
        lock_s = time.perf_counter() - t_lock
    finally:
        shutil.rmtree(out, ignore_errors=True)
    card.emit("watch", seconds=time.perf_counter() - t_phase, gate_s=gate_s, lockwatch_s=lock_s,
              chain=OBS_CHAIN, metrics_overhead=metrics_gate,
              lockwatch_cycles=len(children["watched"]["cycles"]))
    check(metrics_gate["overhead_pct"] <= OBS_GATE_PCT, f"metrics overhead {metrics_gate}")
    return {"flash": flash}


# -- the in-process connectors: RAG served over HTTP, SQLite, Delta Lake ---------------------

CONN_OBJECTS = 40  # the docs reach the connector as 40 JSON-lines objects of 500
CONN_CLIENTS = 8  # client threads POSTing the queries
CONN_ROUTE = "/v1/retrieve"
CONN_WAIT_S = 300.0
SQLITE_ROWS = 200_000  # relational_engine's rows (N_ENGINE)
SQLITE_ROUNDS = 10
SQLITE_ROUND_ROWS = 1_000  # UPDATEs, DELETEs and INSERTs a round, each
SQLITE_GROUPS = 1024 + 64  # relational_engine's keys: N_DIM, and 64 more


class _Collector:
    """An in-process ``http.server`` that keeps the JSON body of every POST."""

    def __init__(self) -> None:
        import http.server

        bodies, lock = [], threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server's name
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with lock:
                    bodies.append(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.bodies, self.lock = bodies, lock
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/answers"
        self.thread = threading.Thread(target=self.server.serve_forever, name="connectors-collector",
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30.0)


class _TimedPolls:
    """Wraps ``cls.poll`` while open: times every poll, and once ``stop`` is set reports
    the reader done (a streaming reader never ends by itself)."""

    def __init__(self, cls) -> None:
        self.cls, self.stop = cls, threading.Event()
        self.seconds: list[float] = []
        self.with_entries: list[float] = []

    def __enter__(self):
        self._poll = orig = self.cls.poll
        me = self

        def poll(reader):
            t0 = time.perf_counter()
            entries, done = orig(reader)
            dt = time.perf_counter() - t0
            me.seconds.append(dt)
            if entries:
                me.with_entries.append(dt)
            return entries, done or me.stop.is_set()

        self.cls.poll = poll
        return self

    def __exit__(self, *exc):
        self.cls.poll = self._poll


def _wait_for(cond, thread: threading.Thread, timeout: float = CONN_WAIT_S) -> bool:
    """Wait until ``cond()`` holds, at most ``timeout`` s and only while the run's
    ``thread`` lives -> whether it held."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline or not thread.is_alive():
            return cond()
        time.sleep(0.01)
    return True


def _attach_sinks(runner) -> None:
    """Build and attach every registered sink (``pw.io.subscribe``, ``pw.io.http.write``)
    in ``runner``, as ``pw.run`` does before its run."""
    from pathway_tpu_torch.internals.parse_graph import G

    for sink in G.sinks:
        driver = sink.attach(runner.scope, runner.build(sink.table))
        if driver is not None:
            runner.drivers.append(driver)


def _post_json(port: int, path: str, payload: dict) -> tuple[int, object, float]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=CONN_WAIT_S) as resp:
            code, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, json.loads(body), time.perf_counter() - t0


def _connectors_rest_rag(card: Card) -> int:
    """(a): BASELINE #1's program served over HTTP: docs from ``pw.io.s3.read`` over a
    ``DictObjectStore`` that a feeder thread fills while the run is live, the embedder
    UDF and DataIndex on the card, queries POSTed to a ``rest_connector`` route by
    client threads, the run wired as ``BaseRestServer.run`` wires it (``GraphRunner()``,
    ``attach``, ``runner.run()`` on a thread), the answers also sent through
    ``pw.io.http.write`` to a collector; -> the forward kernel's launches."""
    from pathway_tpu_torch.engine.storage import ObjectStoreReader
    from pathway_tpu_torch.internals.parse_graph import G

    corpus = [doc_text(i) for i in range(N_DOCS)]
    per_object = N_DOCS // CONN_OBJECTS
    objects = [(f"docs/part-{j:03d}.jsonl",
                "".join(json.dumps({"doc_id": i, "text": corpus[i]}) + "\n"
                        for i in range(j * per_object, (j + 1) * per_object)))
               for j in range(CONN_OBJECTS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
    store = pw.io.s3.DictObjectStore()
    collector = _Collector()
    port = _free_port()
    server = pw.io.http.PathwayWebserver("127.0.0.1", port)
    obs = {"docs": {}, "answers": {}, "first_put": 0.0, "ingest_end": 0.0}
    ingest_done = threading.Event()

    docs = pw.io.s3.read("docs/", format="json", schema=pw.schema_from_types(doc_id=int, text=str),
                         client=store)
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries, attach = pw.io.http.rest_connector(
        schema=pw.schema_from_types(qid=int, text=str), route=CONN_ROUTE, webserver=server)
    queries = queries.select(qid=pw.this.qid, qemb=embedder(pw.this.text))
    res = DataIndex(docs, factory, docs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=K)
    result = res.select(qid=pw.this.qid, ids=pw.this._pw_index_reply_ids,
                        scores=pw.this._pw_index_reply_scores)
    perf_counter = time.perf_counter

    def on_doc(key, row, time, is_addition):
        if is_addition:
            obs["docs"][key] = (row["doc_id"], np.asarray(row["emb"], np.float32))
            if len(obs["docs"]) == N_DOCS:
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][row["qid"]] = np.asarray(row["qemb"], np.float32)

    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    pw.io.http.write(result, collector.url)

    def feed() -> None:
        obs["first_put"] = time.perf_counter()
        for name, text in objects:
            store.put_object(name, text)
            time.sleep(0.01)

    run_error: list = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    t_run = time.perf_counter()
    with _TimedPolls(ObjectStoreReader) as polls:
        runner = GraphRunner()
        attach(result, runner)  # builds the route's graph and starts the webserver
        _attach_sinks(runner)
        G.clear()

        def run() -> None:
            try:
                runner.run()
            except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
                run_error.append(e)

        thread = threading.Thread(target=run, name="connectors-rest-run")
        thread.start()
        feeder = threading.Thread(target=feed, name="connectors-feeder")
        feeder.start()
        try:
            arrived = _wait_for(ingest_done.is_set, thread)
            feeder.join(CONN_WAIT_S)
            schema = _http_get(port, "/_schema?format=json")
            replies: list = [None] * N_QUERIES

            def client(c: int) -> None:
                for qid in range(c, N_QUERIES, CONN_CLIENTS):
                    replies[qid] = _post_json(port, CONN_ROUTE,
                                              {"qid": qid, "text": doc_text(qid * 37 % N_DOCS)})

            clients = [threading.Thread(target=client, args=(c,)) for c in range(CONN_CLIENTS)]
            t_q = time.perf_counter()
            if arrived:
                for t in clients:
                    t.start()
                for t in clients:
                    t.join(CONN_WAIT_S)
            queries_s = time.perf_counter() - t_q
            # each answer once as an insertion, and its retraction once the request's
            # row is deleted (delete_completed_queries)
            _wait_for(lambda: len(collector.bodies) >= 2 * N_QUERIES, thread, timeout=60.0)
        finally:
            server.stop()  # closes the port and ends the query stream
            polls.stop.set()  # ends the object-store read
            thread.join(CONN_WAIT_S)
            collector.close()
    run_s = time.perf_counter() - t_run
    if run_error:
        raise run_error[0]
    check(not thread.is_alive(), "rest_rag: the run did not end")
    launches = fa.KERNEL.launches
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    index = factory.built
    try:
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
        port_closed = False
    except ConnectionRefusedError:
        port_closed = True

    key_of_text = {str(k): k for k in obs["docs"]}
    key_of_doc = {doc_id: k for k, (doc_id, _e) in obs["docs"].items()}
    statuses = [r[0] if r else None for r in replies]
    answers, top1 = {}, []
    for qid, r in enumerate(replies):
        if r and r[0] == 200 and qid in obs["answers"]:
            hits = tuple(key_of_text.get(i) for i in r[1]["ids"])
            answers[qid] = (hits, obs["answers"][qid])
            top1.append(bool(hits) and hits[0] == key_of_doc.get(qid * 37 % N_DOCS))
    recall, _self_hit = _engine_recall({"docs": obs["docs"], "answers": answers})
    posted = collections.Counter((b["qid"], b["diff"]) for b in collector.bodies)
    lat_ms = sorted(1e3 * r[2] for r in replies if r)
    desc = json.loads(schema[1]) if schema[0] == 200 else {}
    ingest_s = obs["ingest_end"] - obs["first_put"]
    card.emit(
        "connectors_rest_rag", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
        capacity=index.capacity, n_docs=len(obs["docs"]), objects=CONN_OBJECTS,
        docs_per_s=N_DOCS / ingest_s if ingest_s > 0 else None, ingest_s=ingest_s, run_s=run_s,
        requests=len(lat_ms), clients=CONN_CLIENTS, queries_s=queries_s,
        request_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        request_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        request_ms_by_qid=[1e3 * r[2] if r else None for r in replies],
        statuses=dict(collections.Counter(statuses)), recall_at_10=recall, top1_own_doc=sum(top1),
        store_polls=len(polls.seconds), store_poll_ms_mean=1e3 * float(np.mean(polls.seconds)),
        store_poll_ms_p50=1e3 * float(np.median(polls.seconds)),
        store_poll_ms_max=1e3 * max(polls.seconds),
        store_polls_with_entries=len(polls.with_entries),
        collector_posts=len(collector.bodies), collector_inserts=sum(v for (q, d), v in posted.items() if d > 0),
        flash_launches=launches, embed_calls=embed_calls[0],
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        peak_device_gib=peak_gib, schema_paths=sorted(desc.get("paths", {})), port_closed=port_closed,
    )
    check(len(obs["docs"]) == N_DOCS, f"rest_rag: {len(obs['docs'])} of {N_DOCS} docs arrived")
    check(statuses == [200] * N_QUERIES, f"rest_rag: statuses {statuses}")
    check(len(top1) == N_QUERIES and all(top1), f"rest_rag: {sum(top1)} of {N_QUERIES} own docs at top-1")
    check(recall >= 0.99, f"rest_rag: recall@10 {recall}")
    check(all(posted[(q, 1)] == 1 for q in range(N_QUERIES)) and all(
        d in (1, -1) and n == 1 for (q, d), n in posted.items()), f"rest_rag: collector {posted}")
    check(CONN_ROUTE in desc.get("paths", {}) and desc.get("openapi") == "3.0.3",
          f"rest_rag: /_schema {schema[:2]}")
    check(index.rows_device == N_DOCS and index.rows_host == 0,
          f"rest_rag: index routes {index.rows_device} device, {index.rows_host} host")
    check(launches > 0 and launches == LAYERS * embed_calls[0],
          f"rest_rag: flash launches {launches} != {LAYERS} x {embed_calls[0]} embed calls")
    check(port_closed, f"rest_rag: port {port} still accepts connections after the run")
    return launches


def _sqlite_expected(conn) -> dict:
    """NumPy's groupby over a ``SELECT`` of the table: {k: (k, sum's bits, count)}."""
    return _groupby_expected(conn.execute("SELECT k, v FROM t").fetchall())


def _groupby_expected(kv) -> dict:
    """NumPy's ``groupby(k).reduce(k, s=sum(v), c=count())`` over (k, v) pairs: {k: (k,
    sum's bits, count)}."""
    rows = np.array(kv, dtype=np.float64).reshape(-1, 2)
    k = rows[:, 0].astype(np.int64)
    counts = np.bincount(k, minlength=SQLITE_GROUPS)
    sums = np.bincount(k, weights=rows[:, 1], minlength=SQLITE_GROUPS)
    return {int(g): (int(g), np.float64(sums[g]).view(np.int64).item(), int(counts[g]))
            for g in np.nonzero(counts)[0]}


def _connectors_sqlite(card: Card, root: str) -> tuple[int, dict]:
    """(b): relational_engine's groupby (``groupby(k).reduce(k, s=sum(v), c=count())``)
    over 200,000 rows read by ``pw.io.sqlite.read`` from a database file, on the card;
    then 10 rounds of 1,000 UPDATEs, DELETEs and INSERTs from another connection, the
    subscriber's state equal to NumPy's over a ``SELECT`` after every round; -> (the
    segment kernels' launches, the final state)."""
    import sqlite3

    from pathway_tpu_torch.engine.storage import SqliteReader

    db = os.path.join(root, "rel.sqlite")
    rng = np.random.default_rng(SEED)
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (k INTEGER, v REAL)")
    conn.executemany("INSERT INTO t VALUES (?, ?)", zip(
        rng.integers(0, SQLITE_GROUPS, SQLITE_ROWS).tolist(),
        (rng.integers(-4000, 4000, SQLITE_ROWS) * 0.125).tolist()))
    conn.commit()
    state: dict = {}
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        value = (row["k"], np.float64(row["s"]).view(np.int64).item(), row["c"])
        with lock:
            if is_addition:
                state[row["k"]] = value
            elif state.get(row["k"]) == value:  # a retraction of the row it holds
                del state[row["k"]]

    t = pw.io.sqlite.read(db, "t", pw.schema_from_types(k=int, v=float))
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
    pw.io.subscribe(g, on_change=on_change)
    run_error: list = []

    def wait_equal(want: dict) -> bool:
        def equal() -> bool:
            with lock:
                return state == want

        return _wait_for(equal, thread)

    rounds = []
    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    _zero_segment_launches()
    with _TimedPolls(SqliteReader) as polls, _KeptRunner() as kept:
        def run() -> None:
            try:
                _with_device_ops("1", pw.run)
            except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
                run_error.append(e)

        t0 = time.perf_counter()
        thread = threading.Thread(target=run, name="connectors-sqlite-run")
        thread.start()
        try:
            loaded = wait_equal(_sqlite_expected(conn))
            load_s = time.perf_counter() - t0
            for r in range(SQLITE_ROUNDS if loaded else 0):
                rowids = [x for (x,) in conn.execute("SELECT rowid FROM t")]
                picks = rng.choice(len(rowids), 2 * SQLITE_ROUND_ROWS, replace=False)
                upd = [rowids[i] for i in picks[:SQLITE_ROUND_ROWS]]
                dele = [rowids[i] for i in picks[SQLITE_ROUND_ROWS:]]
                n_scans = len(polls.with_entries)
                t_r = time.perf_counter()
                conn.executemany("UPDATE t SET k = ?, v = ? WHERE rowid = ?", zip(
                    rng.integers(0, SQLITE_GROUPS, SQLITE_ROUND_ROWS).tolist(),
                    (rng.integers(-4000, 4000, SQLITE_ROUND_ROWS) * 0.125).tolist(), upd))
                conn.executemany("DELETE FROM t WHERE rowid = ?", [(x,) for x in dele])
                conn.executemany("INSERT INTO t VALUES (?, ?)", zip(
                    rng.integers(0, SQLITE_GROUPS, SQLITE_ROUND_ROWS).tolist(),
                    (rng.integers(-4000, 4000, SQLITE_ROUND_ROWS) * 0.125).tolist()))
                conn.commit()
                ok = wait_equal(_sqlite_expected(conn))
                rounds.append({"equal": ok, "s": time.perf_counter() - t_r,
                               "rescan_s": sum(polls.with_entries[n_scans:])})
                if not ok:
                    break
        finally:
            polls.stop.set()
            thread.join(CONN_WAIT_S)
            conn.close()
    if run_error:
        raise run_error[0]
    check(not thread.is_alive(), "sqlite: the run did not end")
    by_kernel = _segment_launches()
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in kept.runners[0].scope.nodes
              if hasattr(n, "routes")}
    groupbys = [r for name, r in routes.items() if name.startswith("GroupbyNode")]
    card.emit("connectors_sqlite", rows=SQLITE_ROWS, groups=SQLITE_GROUPS, rounds=len(rounds),
              round_rows=SQLITE_ROUND_ROWS, load_s=load_s, rows_per_s=SQLITE_ROWS / load_s,
              first_scan_s=polls.with_entries[0] if polls.with_entries else None,
              round_s=[x["s"] for x in rounds], rescan_s_per_round=[x["rescan_s"] for x in rounds],
              rounds_equal=[x["equal"] for x in rounds], polls=len(polls.seconds),
              routes=routes, segment_launches=by_kernel)
    check(loaded, "sqlite: the loaded groupby differs from NumPy's")
    check(len(rounds) == SQLITE_ROUNDS and all(x["equal"] for x in rounds),
          f"sqlite: rounds {rounds}")
    check(len(groupbys) == 1 and groupbys[0]["device"] > SQLITE_ROUNDS and groupbys[0]["host"] == 0
          and groupbys[0]["rows"] == 0, f"sqlite: groupby routes {groupbys}")
    check(all(by_kernel[k] > 0 for k in SEGMENT_PATH_KERNELS), f"sqlite: segment launches {by_kernel}")
    return sum(by_kernel.values()), dict(state)


def _connectors_deltalake(card: Card, root: str, final: dict) -> dict:
    """(c): (b)'s final groupby state written by ``pw.io.deltalake.write`` and read back
    by ``pw.io.deltalake.read`` in a second ``pw.run``, where pyarrow imports."""
    if not _imports("pyarrow"):
        card.emit("connectors_deltalake", deltalake="pyarrow absent")
        return {"deltalake": "pyarrow absent"}
    lake = os.path.join(root, "lake")
    rows = [(k, np.int64(s).view(np.float64).item(), c) for k, s, c in final.values()]
    t0 = time.perf_counter()
    pw.io.deltalake.write(pw.debug.table_from_rows(pw.schema_from_types(k=int, s=float, c=int), rows),
                          lake)
    pw.run()
    write_s = time.perf_counter() - t0

    class S(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        s: float
        c: int

    back: dict = {}
    pw.io.subscribe(pw.io.deltalake.read(lake, schema=S, mode="static"),
                    on_change=lambda key, row, time, is_addition: back.update(
                        {row["k"]: (row["k"], np.float64(row["s"]).view(np.int64).item(), row["c"])}))
    t0 = time.perf_counter()
    pw.run()
    read_s = time.perf_counter() - t0
    log = sorted(os.listdir(os.path.join(lake, "_delta_log")))
    card.emit("connectors_deltalake", deltalake="pyarrow", rows=len(rows), write_s=write_s,
              read_s=read_s, log=log, equal=back == final)
    check(back == final, f"deltalake: {len(back)} rows read back, {len(final)} written, not equal")
    return {"deltalake": "pyarrow", "rows": len(rows)}


def phase_connectors(card: Card) -> dict:
    """The in-process connectors on the card: (a) RAG served over HTTP, (b) SQLite into
    the card's groupby, (c) Delta Lake; -> the forward kernel's and the segment
    reduction's launches."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="pw_connectors_")
    try:
        t0 = time.perf_counter()
        flash = _connectors_rest_rag(card)
        rest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        segment, final = _connectors_sqlite(card, root)
        sqlite_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lake = _connectors_deltalake(card, root, final)
        lake_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card.emit("connectors", seconds=time.perf_counter() - t_phase, rest_rag_s=rest_s,
              sqlite_s=sqlite_s, deltalake_s=lake_s, **lake)
    return {"flash": flash, "segment": segment}


# -- the message buses: RAG through Kafka, Debezium CDC into the card's groupby, NATS -------

BUS_DOC_BATCHES = 4  # the feeder produces the docs as 4 record batches of 5,000
BUS_AUTOCOMMIT_MS = 100  # engine_pipeline's doc connector window, for the docs and the CDC
BUS_WAIT_S = 300.0
DEBEZIUM_ROWS = 50_000  # the snapshot's rows (``op: "r"``)
DEBEZIUM_SNAPSHOT_BATCHES = 10  # produced as 10 record batches of 5,000
DEBEZIUM_ROUNDS = 10
DEBEZIUM_ROUND_ROWS = 1_000  # ``u``, ``d`` and ``c`` envelopes a round, each
DEBEZIUM_TOPIC = "pg.public.t"  # Debezium's <server>.<schema>.<table>
NATS_SUBJECT = "groups"


def _bus_query_text(qid: int) -> str:
    """Query ``qid``'s text: a prefix of its own doc (``qid * 37 % N_DOCS``), the doc
    less its last word."""
    return " ".join(doc_text(qid * 37 % N_DOCS).split()[:-1])


class _BulkKnnFactory(_KeptKnnFactory):
    """The pipeline's index factory that puts main_path's 980,000 seeded unit vectors
    into the index it builds, under keys of their own (ints), so that the docs join
    1,000,000 live rows at ``CAPACITY`` slots; keeps the bulk vectors for the host check."""

    def build(self) -> DeviceKnnIndex:
        index = super().build()
        gen = torch.Generator(device=index.device).manual_seed(SEED)
        bulk = torch.randn((N_BULK, DIM), generator=gen, device=index.device)
        bulk /= torch.linalg.vector_norm(bulk, dim=1, keepdim=True)
        index.add(range(N_DOCS, N_DOCS + N_BULK), bulk)
        self.bulk = bulk
        return index


def _run_thread(name: str, errors: list, fn=None) -> threading.Thread:
    """``pw.run`` (or ``fn``) started on a thread of its own; what it raises lands in
    ``errors``, to be raised on the main thread."""

    def run() -> None:
        try:
            (fn or pw.run)()
        except BaseException as e:  # noqa: BLE001 — raised on the main thread
            errors.append(e)

    thread = threading.Thread(target=run, name=name)
    thread.start()
    return thread


def _buses_kafka_rag(card: Card, broker) -> int:
    """(a): BASELINE #1's program fed and answered through Kafka: a feeder produces the
    20,000 docs as JSON to ``docs`` while ``pw.run`` reads them with
    ``pw.io.kafka.read(format="json")``, embeds them at full MiniLM-L6 width and puts
    them into the 1M-row index; once every doc has reached the doc subscriber, 64
    queries (each a prefix of its own doc) are produced one at a time to ``queries``,
    answered as of now and written by ``pw.io.kafka.write(format="json", key="qid")`` to
    ``answers``, which a ``KafkaWireClient`` fetches; the run ends when the script
    closes the two read transports; -> the forward kernel's launches."""
    from pathway_tpu_torch.io._kafka_wire import KafkaWireClient, KafkaWireTransport, WireRecord

    bootstrap = f"{broker.host}:{broker.port}"
    settings = {"bootstrap.servers": bootstrap}
    corpus = [doc_text(i) for i in range(N_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _BulkKnnFactory(dimensions=DIM, capacity=CAPACITY)
    docs_tr = KafkaWireTransport(bootstrap, "docs")
    queries_tr = KafkaWireTransport(bootstrap, "queries")
    fetches: list[float] = []  # the perf_counter of each docs poll that read messages
    poll_docs = docs_tr.poll_messages

    def timed_poll():
        msgs = poll_docs()
        if msgs:
            fetches.append(time.perf_counter())
        return msgs

    docs_tr.poll_messages = timed_poll
    obs = {"docs": {}, "qembs": {}, "ingest_end": 0.0, "produce_s": 0.0}
    ingest_done = threading.Event()
    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module

    docs = pw.io.kafka.read(settings, "docs", format="json", transport=docs_tr,
                            schema=pw.schema_from_types(doc_id=int, text=str),
                            autocommit_duration_ms=BUS_AUTOCOMMIT_MS)
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries = pw.io.kafka.read(settings, "queries", format="json", transport=queries_tr,
                               schema=pw.schema_from_types(qid=int, text=str),
                               autocommit_duration_ms=None)
    queries = queries.select(qid=pw.this.qid, qemb=embedder(pw.this.text))
    res = DataIndex(docs, factory, docs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=K)
    answers = res.select(qid=pw.this.qid, ids=pw.this._pw_index_reply_ids,
                         scores=pw.this._pw_index_reply_scores)

    def on_doc(key, row, time, is_addition):
        if is_addition:
            obs["docs"][key] = (row["doc_id"], np.asarray(row["emb"], np.float32))
            if len(obs["docs"]) == N_DOCS:
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["qembs"][row["qid"]] = np.asarray(row["qemb"], np.float32)

    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    pw.io.kafka.write(answers, settings, "answers", format="json", key="qid")

    def feed() -> None:
        client = KafkaWireClient(broker.host, broker.port)
        per = N_DOCS // BUS_DOC_BATCHES
        t0 = time.perf_counter()
        for j in range(BUS_DOC_BATCHES):
            client.produce("docs", 0, [
                WireRecord(value=json.dumps({"doc_id": i, "text": corpus[i]}).encode())
                for i in range(j * per, (j + 1) * per)])
        obs["produce_s"] = time.perf_counter() - t0
        client.close()

    errors: list = []
    gc.collect()
    torch.cuda.synchronize()
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    bytes0 = (broker.bytes_received, broker.bytes_sent)
    t_run = time.perf_counter()
    thread = _run_thread("buses-kafka-run", errors)
    feeder = threading.Thread(target=feed, name="buses-kafka-feeder")
    feeder.start()
    fetched: dict[int, list] = collections.defaultdict(list)  # qid -> [(diff, msg, t)]
    lat_s: list[float] = []
    producer = KafkaWireClient(broker.host, broker.port)
    fetcher = KafkaWireClient(broker.host, broker.port)
    offset = 0
    try:
        arrived = _wait_for(ingest_done.is_set, thread, timeout=BUS_WAIT_S)
        feeder.join(BUS_WAIT_S)
        ingest_s = obs["ingest_end"] - fetches[0] if arrived and fetches else float("nan")
        t_q = time.perf_counter()
        for qid in range(N_QUERIES if arrived else 0):
            t0 = time.perf_counter()
            producer.produce("queries", 0, [WireRecord(
                value=json.dumps({"qid": qid, "text": _bus_query_text(qid)}).encode(),
                key=str(qid).encode())])
            deadline = t0 + BUS_WAIT_S
            while not fetched[qid] and time.perf_counter() < deadline and thread.is_alive():
                recs, _high = fetcher.fetch("answers", 0, offset)
                now = time.perf_counter()
                for rec in recs:
                    offset = rec.offset + 1
                    msg = json.loads(rec.value)
                    fetched[msg["qid"]].append((msg["diff"], msg, now, rec.key))
                if not recs:
                    time.sleep(0.001)
            if not fetched[qid]:
                break
            lat_s.append(fetched[qid][0][2] - t0)
        queries_s = time.perf_counter() - t_q
    finally:
        queries_tr.close()  # ends both reads: the run drains its last commit and stops
        docs_tr.close()
        thread.join(BUS_WAIT_S)
        producer.close()
    run_s = time.perf_counter() - t_run
    if errors:
        raise errors[0]
    check(not thread.is_alive(), "kafka_rag: the run did not end")
    # every answer the writer produced, read once more from the start after the run
    every, _high = fetcher.fetch("answers", 0, 0)
    fetcher.close()
    launches = fa.KERNEL.launches
    torch.cuda.synchronize()
    index = factory.built
    answered = collections.Counter((json.loads(r.value)["qid"], json.loads(r.value)["diff"])
                                   for r in every)
    keys_ok = all(r.key == str(json.loads(r.value)["qid"]).encode() for r in every)

    # top-1 and recall@10 against exact f32 search in a HostKnnIndex over the same
    # 1,000,000 rows: the subscriber's doc vectors and the bulk vectors
    key_of_text = {repr(k): k for k in obs["docs"]}
    key_of_doc = {doc_id: k for k, (doc_id, _e) in obs["docs"].items()}
    doc_keys = list(obs["docs"])
    host = HostKnnIndex(dim=DIM, capacity=CAPACITY)
    host.add(doc_keys + list(range(N_DOCS, N_DOCS + N_BULK)),
             np.concatenate([np.stack([obs["docs"][k][1] for k in doc_keys]),
                             factory.bulk.cpu().numpy()]))
    qids = [q for q in range(N_QUERIES) if fetched[q] and q in obs["qembs"]]
    exact = host.search([obs["qembs"][q] for q in qids], k=K) if qids else []
    top1, recalls = [], []
    for q, e in zip(qids, exact):
        hits = [key_of_text.get(i, i) for i in fetched[q][0][1]["ids"]]
        top1.append(bool(hits) and hits[0] == key_of_doc.get(q * 37 % N_DOCS))
        recalls.append(len({k for k, _ in e} & set(hits)) / K)
    del host
    recall = float(np.mean(recalls)) if recalls else float("nan")
    lat_ms = sorted(1e3 * x for x in lat_s)
    card.emit(
        "buses_kafka_rag", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
        capacity=index.capacity, live_rows=len(index), n_docs=len(obs["docs"]),
        doc_batches=BUS_DOC_BATCHES, produce_s=obs["produce_s"],
        docs_per_s=N_DOCS / ingest_s if ingest_s > 0 else None, ingest_s=ingest_s,
        doc_fetches=len(fetches), run_s=run_s, queries_s=queries_s, answered=len(lat_ms),
        answer_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        answer_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        answer_ms_by_qid=[1e3 * x for x in lat_s], answer_messages=len(every),
        recall_at_10=recall, top1_own_doc=sum(top1), flash_launches=launches,
        embed_calls=embed_calls[0], index_rows_device_route=index.rows_device,
        index_rows_host_route=index.rows_host,
        broker_bytes_received=broker.bytes_received - bytes0[0],
        broker_bytes_sent=broker.bytes_sent - bytes0[1],
    )
    check(len(obs["docs"]) == N_DOCS, f"kafka_rag: {len(obs['docs'])} of {N_DOCS} docs arrived")
    check(answered == collections.Counter({(q, 1): 1 for q in range(N_QUERIES)}) and keys_ok,
          f"kafka_rag: answers {sorted(answered.items())[:8]}, keys {keys_ok}")
    check(len(top1) == N_QUERIES and all(top1), f"kafka_rag: {sum(top1)} of {N_QUERIES} own docs at top-1")
    check(recall == 1.0, f"kafka_rag: recall@10 {recall} against HostKnnIndex")
    check(index.rows_device == N_DOCS + N_BULK and index.rows_host == 0 and len(index) == N_DOCS + N_BULK,
          f"kafka_rag: index routes {index.rows_device} device, {index.rows_host} host")
    check(launches > 0 and launches == LAYERS * embed_calls[0],
          f"kafka_rag: flash launches {launches} != {LAYERS} x {embed_calls[0]} embed calls")
    return launches


def _debezium_envelope(op: str, before, after, lsn: int) -> bytes:
    """A Debezium Postgres change event as its JSON converter writes the value."""
    return json.dumps({"payload": {
        "before": before, "after": after, "op": op, "ts_ms": 1_700_000_000_000 + lsn,
        "source": {"connector": "postgresql", "db": "bench", "schema": "public", "table": "t",
                   "lsn": lsn}}}).encode()


class _Fold:
    """A groupby's update stream folded into its state: {k: (k, sum's bits, count)}."""

    def __init__(self) -> None:
        self.state: dict = {}
        self.lock = threading.Lock()

    def apply(self, row: dict, is_addition: bool) -> None:
        value = (row["k"], np.float64(row["s"]).view(np.int64).item(), row["c"])
        with self.lock:
            if is_addition:
                self.state[row["k"]] = value
            elif self.state.get(row["k"]) == value:  # a retraction of the row it holds
                del self.state[row["k"]]

    def equals(self, want: dict) -> bool:
        with self.lock:
            return self.state == want


def _buses_debezium(card: Card, broker, nats) -> tuple[int, dict]:
    """(b) and (c): a Debezium Postgres stream over the Kafka wire into the card's
    groupby: a 50,000-row snapshot (``op: "r"``), then 10 rounds of 1,000 ``u`` (before
    and after images), 1,000 ``d`` and 1,000 ``c`` envelopes with their key payloads,
    read by ``pw.io.debezium.read`` into ``groupby(k).reduce(k, s=sum(v), c=count())``
    with the device operators forced; the subscriber's state equal to NumPy's after the
    snapshot and every round. (c): ``pw.io.nats.write`` publishes the groupby's update
    stream to a ``FakeNatsServer``, and a ``NatsConnection`` subscriber on this thread
    folds it; its final state must equal (b)'s. -> (the segment kernels' launches, the
    phase's figures)."""
    from pathway_tpu_torch.io._kafka_wire import KafkaWireClient, KafkaWireTransport, WireRecord
    from pathway_tpu_torch.io._nats_wire import NatsConnection

    rng = np.random.default_rng(SEED)
    rows: dict[int, tuple[int, float]] = {}  # the source table: id -> (k, v)
    lsn = [0]

    def draw() -> tuple[int, float]:
        return int(rng.integers(0, SQLITE_GROUPS)), float(rng.integers(-4000, 4000)) * 0.125

    def record(op: str, rid: int, before, after) -> WireRecord:
        lsn[0] += 1
        img = lambda r: None if r is None else {"id": rid, "k": r[0], "v": r[1]}  # noqa: E731
        return WireRecord(value=_debezium_envelope(op, img(before), img(after), lsn[0]),
                          key=json.dumps({"payload": {"id": rid}}).encode())

    client = KafkaWireClient(broker.host, broker.port)
    bytes0 = (broker.bytes_received, broker.bytes_sent)
    t0 = time.perf_counter()
    per = DEBEZIUM_ROWS // DEBEZIUM_SNAPSHOT_BATCHES
    for j in range(DEBEZIUM_SNAPSHOT_BATCHES):
        batch = []
        for rid in range(j * per, (j + 1) * per):
            rows[rid] = draw()
            batch.append(record("r", rid, None, rows[rid]))
        client.produce(DEBEZIUM_TOPIC, 0, batch)
    snapshot_produce_s = time.perf_counter() - t0
    next_id = DEBEZIUM_ROWS

    class S(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        k: int
        v: float

    fold, nats_fold = _Fold(), _Fold()
    cdc_tr = KafkaWireTransport(f"{broker.host}:{broker.port}", DEBEZIUM_TOPIC)
    t = pw.io.debezium.read({"bootstrap.servers": f"{broker.host}:{broker.port}"}, DEBEZIUM_TOPIC,
                            schema=S, db_type="postgres", transport=cdc_tr,
                            autocommit_duration_ms=BUS_AUTOCOMMIT_MS)
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
    pw.io.subscribe(g, on_change=lambda key, row, time, is_addition: fold.apply(row, is_addition))
    pw.io.nats.write(g, f"nats://127.0.0.1:{nats.port}", NATS_SUBJECT)
    sub = NatsConnection("127.0.0.1", nats.port)
    sub.subscribe(NATS_SUBJECT, sid=1)
    sub.flush()
    nats_msgs = [0]

    def drain_nats() -> None:
        for _subject, _sid, payload in sub.drain(0.001):
            msg = json.loads(payload)
            nats_msgs[0] += 1
            nats_fold.apply(msg, msg["diff"] > 0)

    def wait_equal(want: dict, thread) -> bool:
        def equal() -> bool:
            drain_nats()
            return fold.equals(want)

        return _wait_for(equal, thread, timeout=BUS_WAIT_S)

    rounds: list[dict] = []
    errors: list = []
    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    _zero_segment_launches()
    with _KeptRunner() as kept:
        t0 = time.perf_counter()
        thread = _run_thread("buses-debezium-run", errors, lambda: _with_device_ops("1", pw.run))
        try:
            loaded = wait_equal(_groupby_expected(list(rows.values())), thread)
            load_s = time.perf_counter() - t0
            for _r in range(DEBEZIUM_ROUNDS if loaded else 0):
                picks = rng.choice(np.fromiter(rows, np.int64, len(rows)), 2 * DEBEZIUM_ROUND_ROWS,
                                   replace=False)
                batch = []
                for rid in picks[:DEBEZIUM_ROUND_ROWS].tolist():
                    before, rows[rid] = rows[rid], draw()
                    batch.append(record("u", rid, before, rows[rid]))
                for rid in picks[DEBEZIUM_ROUND_ROWS:].tolist():
                    batch.append(record("d", rid, rows.pop(rid), None))
                for rid in range(next_id, next_id + DEBEZIUM_ROUND_ROWS):
                    rows[rid] = draw()
                    batch.append(record("c", rid, None, rows[rid]))
                next_id += DEBEZIUM_ROUND_ROWS
                t_r = time.perf_counter()
                client.produce(DEBEZIUM_TOPIC, 0, batch)
                produced_s = time.perf_counter() - t_r
                ok = wait_equal(_groupby_expected(list(rows.values())), thread)
                rounds.append({"equal": ok, "s": time.perf_counter() - t_r, "produce_s": produced_s})
                if not ok:
                    break
        finally:
            cdc_tr.close()  # ends the read: the run drains its last commit and stops
            thread.join(BUS_WAIT_S)
            client.close()
        debezium_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    check(not thread.is_alive(), "debezium: the run did not end")
    final = dict(fold.state)
    t0 = time.perf_counter()
    nats_equal = _wait_for(lambda: (drain_nats(), nats_fold.equals(final))[1], threading.main_thread(),
                           timeout=60.0)
    nats_tail_s = time.perf_counter() - t0
    sub.close()
    by_kernel = _segment_launches()
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in kept.runners[0].scope.nodes
              if hasattr(n, "routes")}
    groupbys = [r for name, r in routes.items() if name.startswith("GroupbyNode")]
    out = {"debezium_s": debezium_s, "nats_tail_s": nats_tail_s,
           "kafka_bytes_received": broker.bytes_received - bytes0[0],
           "kafka_bytes_sent": broker.bytes_sent - bytes0[1],
           "nats_bytes_received": nats.bytes_received, "nats_bytes_sent": nats.bytes_sent}
    card.emit("buses_debezium", rows=DEBEZIUM_ROWS, groups=SQLITE_GROUPS, rounds=len(rounds),
              round_rows=DEBEZIUM_ROUND_ROWS, snapshot_produce_s=snapshot_produce_s, load_s=load_s,
              rows_per_s=DEBEZIUM_ROWS / load_s, round_s=[x["s"] for x in rounds],
              round_produce_s=[x["produce_s"] for x in rounds],
              rounds_equal=[x["equal"] for x in rounds], routes=routes, segment_launches=by_kernel,
              final_groups=len(final), nats_messages=nats_msgs[0], nats_equal=nats_equal, **out)
    check(loaded, "debezium: the snapshot's groupby differs from NumPy's")
    check(len(rounds) == DEBEZIUM_ROUNDS and all(x["equal"] for x in rounds), f"debezium: rounds {rounds}")
    check(final == _groupby_expected(list(rows.values())), "debezium: the final state differs from NumPy's")
    check(len(groupbys) == 1 and groupbys[0]["device"] > DEBEZIUM_ROUNDS and groupbys[0]["host"] == 0
          and groupbys[0]["rows"] == 0, f"debezium: groupby routes {groupbys}")
    check(all(by_kernel[k] > 0 for k in SEGMENT_PATH_KERNELS), f"debezium: segment launches {by_kernel}")
    check(nats_equal, f"nats: the folded state ({len(nats_fold.state)} groups) differs from (b)'s")
    return sum(by_kernel.values()), out


def phase_buses(card: Card) -> dict:
    """The message buses on the card, over an in-process ``FakeKafkaBroker`` and
    ``FakeNatsServer`` on local ports: (a) RAG fed and answered through Kafka, (b) a
    Debezium CDC stream into the card's groupby, (c) (b)'s groupby through NATS; -> the
    forward kernel's and the segment reduction's launches."""
    from pathway_tpu_torch.io._kafka_wire import FakeKafkaBroker
    from pathway_tpu_torch.io._nats_wire import FakeNatsServer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    broker, nats = FakeKafkaBroker(), FakeNatsServer()
    try:
        t0 = time.perf_counter()
        rag_bytes0 = (broker.bytes_received, broker.bytes_sent)
        flash = _buses_kafka_rag(card, broker)
        kafka_rag_s = time.perf_counter() - t0
        rag_bytes = (broker.bytes_received - rag_bytes0[0], broker.bytes_sent - rag_bytes0[1])
        segment, cdc = _buses_debezium(card, broker, nats)
    finally:
        broker.close()
        nats.close()
    torch.cuda.synchronize()
    card.emit("buses", seconds=time.perf_counter() - t_phase, kafka_rag_s=kafka_rag_s,
              kafka_rag_bytes_received=rag_bytes[0], kafka_rag_bytes_sent=rag_bytes[1],
              peak_device_gib=torch.cuda.max_memory_allocated() / 2**30, **cdc)
    return {"flash": flash, "segment": segment}


# -- the databases: RAG fed by Airbyte into Postgres, Iceberg into the card's groupby -------

DB_SYNCS = 2  # the docs arrive in two incremental Airbyte syncs of 10,000
DB_REFRESH_MS = 200  # the Airbyte reader's refresh interval between syncs
DB_WAIT_S = 300.0
DB_PASSWORD = "pw-bench"
DB_ES_USER = ("elastic", "pw-bench")
LAKE_ROWS = DEBEZIUM_ROWS  # buses (b)'s source table: the start ...
LAKE_ROUNDS = DEBEZIUM_ROUNDS  # ... and its rounds of updates, deletes and inserts
LAKE_ROUND_ROWS = DEBEZIUM_ROUND_ROWS

_AIRBYTE_DOCS_SOURCE = """
import argparse, json, time

p = argparse.ArgumentParser()
p.add_argument("command")
p.add_argument("--config")
p.add_argument("--catalog")
p.add_argument("--state")
a = p.parse_args()
if a.command == "spec":
    print(json.dumps({"type": "SPEC", "spec": {"connectionSpecification": {}}}))
elif a.command == "check":
    print(json.dumps({"type": "CONNECTION_STATUS", "connectionStatus": {"status": "SUCCEEDED"}}))
elif a.command == "discover":
    print(json.dumps({"type": "CATALOG", "catalog": {"streams": [
        {"name": "docs", "json_schema": {"type": "object"},
         "supported_sync_modes": ["full_refresh", "incremental"]}]}}))
elif a.command == "read":
    config = json.load(open(a.config))
    cursor = json.load(open(a.state))["cursor"] if a.state else 0
    with open(config["docs_file"]) as f:
        lines = f.read().splitlines()[cursor:cursor + config["per_sync"]]
    out = []
    for line in lines:
        out.append(json.dumps({"type": "RECORD", "record": {
            "stream": "docs", "data": json.loads(line), "emitted_at": int(time.time() * 1000)}}))
    out.append(json.dumps({"type": "STATE", "state": {"data": {"cursor": cursor + len(lines)}}}))
    print("\\n".join(out))
"""


class _Syncs:
    """Wraps the Airbyte reader's ``poll`` and its source's ``extract`` while open: times
    each sync, keeps each STATE handed in and out, stops syncing after ``n`` syncs, and
    reports the reader done once ``stop`` is set."""

    def __init__(self, n: int) -> None:
        from pathway_tpu_torch.io import airbyte

        self.airbyte, self.n, self.stop = airbyte, n, threading.Event()
        self.syncs: list[dict] = []

    def __enter__(self):
        reader_cls, source_cls = self.airbyte._AirbyteReader, self.airbyte.ExecutableAirbyteSource
        self._poll, self._extract = poll, extract = reader_cls.poll, source_cls.extract
        me = self

        def timed_extract(source, state=None):
            t0 = time.perf_counter()
            records, final = extract(source, state)
            me.syncs.append({"s": time.perf_counter() - t0, "records": len(records),
                             "state_in": state, "state_out": final,
                             "first_emitted_ms": records[0]["emitted_at"] if records else None})
            return records, final

        def limited_poll(reader):
            if len(me.syncs) >= me.n:
                return [], me.stop.is_set()
            entries, done = poll(reader)
            return entries, done or me.stop.is_set()

        reader_cls.poll, source_cls.extract = limited_poll, timed_extract
        return self

    def __exit__(self, *exc):
        self.airbyte._AirbyteReader.poll = self._poll
        self.airbyte.ExecutableAirbyteSource.extract = self._extract


def _pg_settings(srv) -> dict:
    return {"host": "127.0.0.1", "port": srv.port, "user": "pathway", "password": DB_PASSWORD,
            "dbname": "bench", "sslmode": "prefer"}


def _pg_array(text: str) -> list:
    """A Postgres array literal of quoted items, as the wire's text params spell a tuple
    -> the items' texts."""
    body = text[1:-1]
    return [item.strip('"') for item in body.split(",")] if body else []


def _databases_airbyte_rag(card: Card, root: str, pg) -> int:
    """(a): BASELINE #1's program fed by an Airbyte source and answered into Postgres:
    the 20,000 docs arrive through ``pw.io.airbyte.read(execution_type="local")`` in two
    incremental syncs (the second resumes from the first one's STATE), are embedded at
    full MiniLM-L6 width and put into the 1M-row index; once every doc has reached the
    doc subscriber, 64 queries are pushed one at a time through ``pw.io.python``, each
    once the answer before it is committed on the server, answered as of now and written
    by ``pw.io.postgres.write`` over the v3 wire; -> the forward kernel's launches."""
    script = os.path.join(root, "docs_source.py")
    with open(script, "w") as f:
        f.write(_AIRBYTE_DOCS_SOURCE)
    docs_file = os.path.join(root, "docs.jsonl")
    corpus = [doc_text(i) for i in range(N_DOCS)]
    with open(docs_file, "w") as f:
        f.write("\n".join(json.dumps({"doc_id": i, "text": corpus[i]}) for i in range(N_DOCS)) + "\n")
    config = os.path.join(root, "airbyte.json")
    with open(config, "w") as f:
        json.dump({"docs_file": docs_file, "per_sync": N_DOCS // DB_SYNCS}, f)

    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, sizes = _count_embed_calls(embedder)
    factory = _BulkKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs = {"docs": {}, "qembs": {}, "ingest_end_wall": 0.0, "arrivals": {}, "committed": {},
           "failures": []}
    ingest_done = threading.Event()
    perf_counter, wall = time.perf_counter, time.time  # the callbacks' ``time`` shadows the module

    def answered(qid: int) -> bool:
        return any(r["qid"] == qid for r in pg.snapshot("answers"))

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=DB_WAIT_S):
                obs["failures"].append(f"{len(obs['docs'])} of {N_DOCS} docs arrived")
                return
            for qid in range(N_QUERIES):
                t0 = perf_counter()
                obs["arrivals"][qid] = t0
                self.next(qid=qid, text=_bus_query_text(qid))
                deadline = t0 + DB_WAIT_S
                while not answered(qid):
                    if perf_counter() > deadline:
                        obs["failures"].append(f"query {qid} was not committed")
                        return
                    time.sleep(0.0005)
                obs["committed"][qid] = perf_counter()

    source = pw.io.airbyte.read(config, ["docs"], mode="streaming", execution_type="local",
                                connector_command=[sys.executable, script],
                                refresh_interval_ms=DB_REFRESH_MS)
    docs = source.select(doc_id=pw.apply_with_type(lambda d: int(d.value["doc_id"]), int, pw.this.data),
                         text=pw.apply_with_type(lambda d: d.value["text"], str, pw.this.data))
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, text=str),
                                autocommit_duration_ms=None)
    queries = queries.select(qid=pw.this.qid, qemb=embedder(pw.this.text))
    res = DataIndex(docs, factory, docs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=K)
    answers = res.select(qid=pw.this.qid, ids=pw.this._pw_index_reply_ids,
                         scores=pw.this._pw_index_reply_scores)

    def on_doc(key, row, time, is_addition):
        if is_addition:
            obs["docs"][key] = (row["doc_id"], np.asarray(row["emb"], np.float32))
            if len(obs["docs"]) == N_DOCS:
                obs["ingest_end_wall"] = wall()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["qembs"][row["qid"]] = np.asarray(row["qemb"], np.float32)

    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    pw.io.postgres.write(answers, _pg_settings(pg), table_name="answers")

    errors: list = []
    gc.collect()
    torch.cuda.synchronize()
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    stmts0, commits0 = len(pg.statements), pg.commits
    t_run = time.perf_counter()
    with _Syncs(DB_SYNCS) as syncs:
        thread = _run_thread("databases-airbyte-run", errors)
        try:
            _wait_for(lambda: len(obs["committed"]) == N_QUERIES or bool(obs["failures"]), thread,
                      timeout=2 * DB_WAIT_S)
        finally:
            syncs.stop.set()  # ends the Airbyte read; the query feed has returned
            thread.join(DB_WAIT_S)
    run_s = time.perf_counter() - t_run
    if errors:
        raise errors[0]
    check(not thread.is_alive(), "airbyte_rag: the run did not end")
    launches = fa.KERNEL.launches
    torch.cuda.synchronize()
    index = factory.built
    rows = pg.snapshot("answers")
    per_qid = collections.Counter(r["qid"] for r in rows)

    # top-1 and recall@10 against exact f32 search on the card over the docs received and
    # the bulk vectors
    doc_keys = list(obs["docs"])
    key_of_text = {repr(k): k for k in doc_keys}
    key_of_doc = {doc_id: k for k, (doc_id, _e) in obs["docs"].items()}
    mat = torch.cat([torch.from_numpy(np.stack([obs["docs"][k][1] for k in doc_keys])).to(factory.bulk.device),
                     factory.bulk])
    all_keys = doc_keys + list(range(N_DOCS, N_DOCS + N_BULK))
    by_qid = {r["qid"]: r for r in rows}
    qids = [q for q in range(N_QUERIES) if q in by_qid and q in obs["qembs"]]
    top1, recalls = [], []
    if qids:
        q = torch.from_numpy(np.stack([obs["qembs"][x] for x in qids])).to(mat.device)
        scores = (q @ mat.T) / (torch.linalg.vector_norm(q, dim=1, keepdim=True)
                                * torch.linalg.vector_norm(mat, dim=1)[None, :]).clamp_min(1e-30)
        exact = torch.topk(scores, K, dim=1).indices.cpu().numpy()
        for x, row in zip(qids, exact):
            hits = [key_of_text[t] if t.startswith("^") else int(t) for t in _pg_array(by_qid[x]["ids"])]
            top1.append(bool(hits) and hits[0] == key_of_doc.get(x * 37 % N_DOCS))
            recalls.append(len({all_keys[j] for j in row} & set(hits)) / K)
    del mat
    recall = float(np.mean(recalls)) if recalls else float("nan")
    lat_ms = sorted(1e3 * (obs["committed"][q] - obs["arrivals"][q]) for q in obs["committed"])
    first_ms = min((s["first_emitted_ms"] for s in syncs.syncs if s["first_emitted_ms"]), default=None)
    ingest_s = obs["ingest_end_wall"] - first_ms / 1e3 if first_ms and obs["ingest_end_wall"] else float("nan")
    card.emit(
        "databases_airbyte_rag", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
        capacity=index.capacity, live_rows=len(index), n_docs=len(obs["docs"]),
        syncs=len(syncs.syncs), sync_s=[x["s"] for x in syncs.syncs],
        sync_records=[x["records"] for x in syncs.syncs],
        sync_states=[(x["state_in"], x["state_out"]) for x in syncs.syncs],
        docs_per_s=N_DOCS / ingest_s if ingest_s > 0 else None, ingest_s=ingest_s, run_s=run_s,
        answered=len(lat_ms), answer_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        answer_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        answer_ms_by_qid=[1e3 * (obs["committed"][q] - obs["arrivals"][q]) for q in sorted(obs["committed"])],
        pg_rows=len(rows), pg_statements=len(pg.statements) - stmts0, pg_commits=pg.commits - commits0,
        recall_at_10=recall, top1_own_doc=sum(top1), flash_launches=launches,
        embed_calls=embed_calls[0], embedded_texts=sum(sizes),
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        failures=obs["failures"],
    )
    check(not obs["failures"], f"airbyte_rag: {obs['failures']}")
    check(len(obs["docs"]) == N_DOCS and sum(sizes) == N_DOCS + N_QUERIES,
          f"airbyte_rag: {len(obs['docs'])} docs arrived, {sum(sizes)} texts embedded")
    check([x["records"] for x in syncs.syncs] == [N_DOCS // DB_SYNCS] * DB_SYNCS
          and syncs.syncs[0]["state_in"] is None
          and syncs.syncs[1]["state_in"] == syncs.syncs[0]["state_out"] == {"cursor": N_DOCS // DB_SYNCS},
          f"airbyte_rag: syncs {[(x['records'], x['state_in'], x['state_out']) for x in syncs.syncs]}")
    check(per_qid == collections.Counter({q: 1 for q in range(N_QUERIES)})
          and all(r["diff"] == 1 for r in rows), f"airbyte_rag: answer rows {sorted(per_qid.items())[:8]}")
    check(len(top1) == N_QUERIES and all(top1), f"airbyte_rag: {sum(top1)} of {N_QUERIES} own docs at top-1")
    check(recall == 1.0, f"airbyte_rag: recall@10 {recall} against exact f32 search")
    check(index.rows_device == N_DOCS + N_BULK and index.rows_host == 0,
          f"airbyte_rag: index routes {index.rows_device} device, {index.rows_host} host")
    check(launches > 0 and launches == LAYERS * embed_calls[0],
          f"airbyte_rag: flash launches {launches} != {LAYERS} x {embed_calls[0]} embed calls")
    return launches


def _fold_log(docs: list) -> dict:
    """An update log's documents (``k``, ``s``, ``c``, ``time``, ``diff``) folded in
    (time, diff) order -> {k: (k, sum's bits, count)}."""
    state: dict = {}
    for d in sorted(docs, key=lambda d: (d["time"], d["diff"])):
        value = (d["k"], np.float64(d["s"]).view(np.int64).item(), d["c"])
        if d["diff"] > 0:
            state[d["k"]] = value
        elif state.get(d["k"]) == value:
            del state[d["k"]]
    return state


def _databases_iceberg_groupby(card: Card, root: str, pg, mongo, es, catalog) -> tuple[int, dict]:
    """(b): buses (b)'s source table committed to an Iceberg table by an outside
    ``IcebergWriter`` over the REST catalog (the start as one snapshot, each round as
    one more), streamed by ``pw.io.iceberg.read`` into the card's groupby and kept live
    in Postgres (the snapshot), MongoDB and Elasticsearch (the update logs); ->
    (the segment kernels' launches, the leg's figures)."""
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.io.iceberg import IcebergReader, IcebergWriter, RestCatalog

    rng = np.random.default_rng(SEED)
    rows: dict[int, tuple[int, float]] = {}  # the source table: id -> (k, v)

    def draw() -> tuple[int, float]:
        return int(rng.integers(0, SQLITE_GROUPS)), float(rng.integers(-4000, 4000)) * 0.125

    writer = IcebergWriter(None, ["id", "k", "v"], {"id": dt.INT, "k": dt.INT, "v": dt.FLOAT},
                           catalog=RestCatalog(catalog.uri(), ["bench"], "t"))
    t0 = time.perf_counter()
    for rid in range(LAKE_ROWS):
        rows[rid] = draw()
        writer.on_change(None, (rid, *rows[rid]), 0, 1)
    writer.on_time_end(0)
    start_commit_s = time.perf_counter() - t0
    next_id = LAKE_ROWS

    class S(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        k: int
        v: float

    t = pw.io.iceberg.read(catalog.uri(), ["bench"], "t", schema=S, mode="streaming",
                           autocommit_duration_ms=BUS_AUTOCOMMIT_MS)
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
    pw.io.postgres.write_snapshot(g, _pg_settings(pg), table_name="groups", primary_key=["k"])
    pw.io.mongodb.write(g, f"mongodb://127.0.0.1:{mongo.port}", database="bench", collection="groups")
    pw.io.elasticsearch.write(g, es.host(), pw.io.elasticsearch.ElasticSearchAuth.basic(*DB_ES_USER),
                              index_name="groups")

    def pg_state() -> dict:
        return {r["k"]: (r["k"], np.float64(r["s"]).view(np.int64).item(), r["c"])
                for r in pg.snapshot("groups")}

    def wait_equal(want: dict, thread) -> bool:
        return _wait_for(lambda: pg_state() == want, thread, timeout=DB_WAIT_S)

    rounds: list[dict] = []
    errors: list = []
    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    _zero_segment_launches()
    pg0 = (len(pg.statements), pg.commits)
    time_iceberg = _TimedPolls(IcebergReader)
    with _KeptRunner() as kept, time_iceberg:
        t0 = time.perf_counter()
        thread = _run_thread("databases-iceberg-run", errors, lambda: _with_device_ops("1", pw.run))
        try:
            loaded = wait_equal(_groupby_expected(list(rows.values())), thread)
            load_s = time.perf_counter() - t0
            for r in range(LAKE_ROUNDS if loaded else 0):
                picks = rng.choice(np.fromiter(rows, np.int64, len(rows)), 2 * LAKE_ROUND_ROWS,
                                   replace=False)
                for rid in picks[:LAKE_ROUND_ROWS].tolist():
                    before, rows[rid] = rows[rid], draw()
                    writer.on_change(None, (rid, *before), r + 1, -1)
                    writer.on_change(None, (rid, *rows[rid]), r + 1, 1)
                for rid in picks[LAKE_ROUND_ROWS:].tolist():
                    writer.on_change(None, (rid, *rows.pop(rid)), r + 1, -1)
                for rid in range(next_id, next_id + LAKE_ROUND_ROWS):
                    rows[rid] = draw()
                    writer.on_change(None, (rid, *rows[rid]), r + 1, 1)
                next_id += LAKE_ROUND_ROWS
                t_r = time.perf_counter()
                writer.on_time_end(r + 1)
                committed = time.perf_counter()
                ok = wait_equal(_groupby_expected(list(rows.values())), thread)
                rounds.append({"equal": ok, "s": time.perf_counter() - committed,
                               "iceberg_commit_s": committed - t_r})
                if not ok:
                    break
        finally:
            time_iceberg.stop.set()  # ends the read: the run drains its last commit and stops
            thread.join(DB_WAIT_S)
        iceberg_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    check(not thread.is_alive(), "iceberg_groupby: the run did not end")
    want = _groupby_expected(list(rows.values()))
    final_pg = pg_state()
    mongo_docs = mongo.snapshot("bench.groups")
    es_docs = list(es.indices.get("groups", ()))
    mongo_state, es_state = _fold_log(mongo_docs), _fold_log(es_docs)
    by_kernel = _segment_launches()
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in kept.runners[0].scope.nodes
              if hasattr(n, "routes")}
    groupbys = [x for name, x in routes.items() if name.startswith("GroupbyNode")]
    snapshots = len(catalog.tables["bench.t"]["snapshots"])
    out = {"iceberg_s": iceberg_s, "pg_statements": len(pg.statements) - pg0[0],
           "pg_commits": pg.commits - pg0[1], "mongo_inserts": mongo.commands.count("insert"),
           "mongo_docs": len(mongo_docs), "es_bulk_requests": len(es.bulk_requests),
           "es_docs": len(es_docs), "iceberg_snapshots": snapshots,
           "catalog_requests": len(catalog.requests)}
    card.emit("databases_iceberg_groupby", rows=LAKE_ROWS, groups=SQLITE_GROUPS, rounds=len(rounds),
              round_rows=LAKE_ROUND_ROWS, start_commit_s=start_commit_s, load_s=load_s,
              rows_per_s=LAKE_ROWS / load_s, round_s=[x["s"] for x in rounds],
              round_iceberg_commit_s=[x["iceberg_commit_s"] for x in rounds],
              rounds_equal=[x["equal"] for x in rounds], routes=routes, segment_launches=by_kernel,
              iceberg_polls=len(time_iceberg.seconds), iceberg_polls_with_rows=len(time_iceberg.with_entries),
              iceberg_poll_ms_with_rows=[1e3 * x for x in time_iceberg.with_entries],
              final_groups=len(final_pg), mongo_equal=mongo_state == want, es_equal=es_state == want, **out)
    check(loaded, "iceberg_groupby: Postgres after the start differs from NumPy's")
    check(len(rounds) == LAKE_ROUNDS and all(x["equal"] for x in rounds), f"iceberg_groupby: rounds {rounds}")
    check(final_pg == want, "iceberg_groupby: the final Postgres table differs from NumPy's")
    check(mongo_state == want, f"iceberg_groupby: the Mongo log folds to {len(mongo_state)} groups, not NumPy's")
    check(es_state == want, f"iceberg_groupby: the ES log folds to {len(es_state)} groups, not NumPy's")
    check(snapshots == 1 + LAKE_ROUNDS, f"iceberg_groupby: {snapshots} snapshots")
    check(len(groupbys) == 1 and groupbys[0]["device"] > LAKE_ROUNDS and groupbys[0]["host"] == 0
          and groupbys[0]["rows"] == 0, f"iceberg_groupby: groupby routes {groupbys}")
    check(all(by_kernel[k] > 0 for k in SEGMENT_PATH_KERNELS), f"iceberg_groupby: segment launches {by_kernel}")
    return sum(by_kernel.values()), out


def phase_databases(card: Card) -> dict:
    """The databases and the lakehouse on the card, over in-process fake Postgres, Mongo,
    Elasticsearch and Iceberg REST servers on local ports and an Airbyte source script:
    (a) RAG fed by Airbyte and answered into Postgres, (b) an Iceberg table streamed into
    the card's groupby and kept live in the three stores; -> the forward kernel's and the
    segment reduction's launches."""
    from pathway_tpu_torch.io._es_wire import FakeElasticsearchServer, auth_header_basic
    from pathway_tpu_torch.io._iceberg_rest import FakeIcebergRestServer
    from pathway_tpu_torch.io._mongo_wire import FakeMongoServer
    from pathway_tpu_torch.io._pg_wire import FakePostgresServer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="pw_databases_")
    servers = []
    threads_before = set(threading.enumerate())
    try:
        pg = FakePostgresServer(password=DB_PASSWORD, auth="scram-sha-256")
        servers.append(pg)
        mongo = FakeMongoServer()
        servers.append(mongo)
        es = FakeElasticsearchServer(auth_header=auth_header_basic(*DB_ES_USER))
        servers.append(es)
        catalog = FakeIcebergRestServer(os.path.join(root, "warehouse"))
        servers.append(catalog)
        t0 = time.perf_counter()
        flash = _databases_airbyte_rag(card, root, pg)
        airbyte_rag_s = time.perf_counter() - t0
        peak_rag_gib = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        segment, lake = _databases_iceberg_groupby(card, root, pg, mongo, es, catalog)
        iceberg_groupby_s = time.perf_counter() - t0
    finally:
        for srv in servers:
            srv.close()
        shutil.rmtree(root, ignore_errors=True)
    leftover = [t.name for t in set(threading.enumerate()) - threads_before if t.name.startswith("fake-")]
    torch.cuda.synchronize()
    card.emit("databases", seconds=time.perf_counter() - t_phase, airbyte_rag_s=airbyte_rag_s,
              iceberg_groupby_s=iceberg_groupby_s, peak_rag_device_gib=peak_rag_gib,
              peak_device_gib=torch.cuda.max_memory_allocated() / 2**30, server_threads_left=leftover,
              **lake)
    check(not leftover, f"databases: server threads left after close: {leftover}")
    return {"flash": flash, "segment": segment}


def train_batch(n: int, vocab_size: int) -> ContrastiveBatch:
    """n (query, positive) pairs on the card, padded to SEQ_LEN: each positive is a
    generated doc, its query the doc's first 3-8 words."""
    rng = np.random.default_rng(SEED)
    docs = [doc_text(i) for i in range(n)]
    queries = [" ".join(doc.split()[: int(rng.integers(3, 9))]) for doc in docs]
    tok = HashTokenizer(vocab_size)
    out = []
    for texts in (queries, docs):
        ids, mask = tok.encode_batch(texts, SEQ_LEN)
        ids, mask, real = pad_to_buckets(ids, mask, batch_bucket_min=n, seq_bucket_min=SEQ_LEN)
        check(real == n and ids.shape == (n, SEQ_LEN), "train batch shape")
        out += [torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()]
    return ContrastiveBatch(*out)


def _grad_cosines(a: dict, b: dict, hidden: int) -> dict:
    """Cosine between two gradients, per parameter. The fused qkv projection counts as
    its three projections (the q, k and v columns of ``qkv_w`` and ``qkv_b``): the
    attention's dQ and dK reach only the q and k columns, which the v columns would
    otherwise outweigh. The k columns of ``qkv_b`` are left out: a key bias adds the
    same q.b to every score of a row, which the softmax ignores, so their exact
    gradient is zero and the computed one is rounding noise."""
    out = {}
    for name, x in a.items():
        y = b[name]
        parts = {name: (x, y)}
        if name.endswith(("qkv_w", "qkv_b")):
            parts = {f"{name}[{p}]": (x[..., i * hidden:(i + 1) * hidden], y[..., i * hidden:(i + 1) * hidden])
                     for i, p in enumerate("qkv") if not (p == "k" and name.endswith("qkv_b"))}
        for part, (u, w) in parts.items():
            nu, nw = float(u.norm()), float(w.norm())
            out[part] = 1.0 if nu == nw == 0.0 else float((u * w).sum()) / max(nu * nw, 1e-30)
    return out


def phase_train(card: Card) -> dict:
    cfg = minilm_l6()
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(seed=SEED)
    weights = {n: p.detach().clone() for n, p in state.params.state_dict().items()}
    batch = train_batch(TRAIN_PAIRS, cfg.vocab_size)
    real_tokens = [float(m.sum(dim=1).float().mean()) for m in (batch.q_mask, batch.d_mask)]
    kernels = {"flash_attention_fwd": fa.KERNEL, "flash_attention_bwd_dq": fa.BWD_DQ_KERNEL,
               "flash_attention_bwd_dkv": fa.BWD_DKV_KERNEL}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in kernels.values():
        kern.launches = 0
    events, losses = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step_fn(state, batch)
        end.record()
        events.append((start, end))
        losses.append(loss)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    steady_ms = float(np.median(step_ms[1:]))
    card.emit("train", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded, f32 masters, bf16 compute)",
              pairs=TRAIN_PAIRS, seq_len=SEQ_LEN, steps=TRAIN_STEPS,
              real_tokens_per_seq={"query": real_tokens[0], "doc": real_tokens[1]},
              step_ms=step_ms, step_ms_median=steady_ms, pairs_per_s=TRAIN_PAIRS / (steady_ms / 1e3),
              wall_s=wall_s, peak_device_gib=peak_gib, losses=losses, launches=launches,
              launches_per_step={name: n / TRAIN_STEPS for name, n in launches.items()})
    for name, n in launches.items():
        check(n == 2 * cfg.layers * TRAIN_STEPS, f"{name}: {n} launches in {TRAIN_STEPS} steps, not 12 a step")
    check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    check(losses[2] < losses[0] and losses[-1] < losses[0], f"the loss falls: {losses}")
    phase_train_profile(card, lambda: step_fn(state, batch))
    del state, batch

    phase_train_parity(card, cfg, weights)
    return launches


def phase_train_profile(card: Card, step, steps: int = 2) -> None:
    """Where a train step's time goes: a profiler window over a few more steps, with
    device time by kernel, by group, and the device's idle share; and whether dq, dk and
    dv are still concatenated (autograd of a split of the qkv projection, ``cat`` on the
    host and its copy kernel on the card): the fused route leaves no split to undo."""
    def run() -> None:
        for _ in range(steps):
            step()

    wall_ms, kernels, ops = _profiled(run)
    busy_ms = sum(k[0] for k in kernels)
    groups = {"flash kernels (this port)": ("flash_",), "matmuls (cuBLAS)": ("nvjet", "gemm", "cutlass"),
              "optimizer (AdamW, foreach)": ("multi_tensor_apply",)}
    by_group = {name: 0.0 for name in (*groups, "other (elementwise, reductions, copies)")}
    for ms, key, _count in kernels:
        group = next((g for g, marks in groups.items() if any(m in key for m in marks)),
                     "other (elementwise, reductions, copies)")
        by_group[group] += ms / steps
    card.emit(
        "train_profile",
        window=f"{steps} train steps at {TRAIN_PAIRS} pairs",
        wall_ms_per_step=wall_ms / steps,
        device_busy_ms_per_step=busy_ms / steps if kernels else "not measured",
        device_idle_share=(1.0 - busy_ms / wall_ms) if kernels else "not measured",
        device_ms_per_step_by_group=by_group,
        top=[{"kernel": k[:80], "device_ms_per_step": ms / steps, "launches": c}
             for ms, k, c in kernels[:15]],
    )
    split_nodes = {k: n for k, n in ops.items() if k.startswith(("SplitBackward", "SplitWithSizesBackward"))}
    cat_kernels = [{"kernel": k[:80], "device_ms_per_step": ms / steps, "launches": c}
                   for ms, k, c in kernels if "CatArray" in k]  # at::cat's copy kernels
    card.emit("qkv_grad_concat", window=f"{steps} train steps at {TRAIN_PAIRS} pairs",
              split_backward_nodes=split_nodes, aten_cat_calls=ops.get("aten::cat", 0),
              cat_kernels=cat_kernels)
    check(not split_nodes, f"a split's backward still concatenates gradients: {split_nodes}")


def phase_train_parity(card: Card, cfg, weights: dict) -> None:
    """One step's loss and gradients at PARITY_PAIRS pairs from the same initial
    weights, through the kernels and through the plain versions on the same
    ``autograd.Function``; and, to show what the bar can see, through the plain
    versions with a broken backward that leaves delta out (o read as zeros)."""
    def plain(q, k, v, mask):
        bias = None if mask is None else fa.mask_bias(mask)
        return fa.FlashAttention.apply(q, k, v, bias, fa.flash_attention_fwd_reference,
                                       fa.flash_attention_bwd_reference)

    def no_delta_bwd(q, k, v, bias, do, o, lse):
        return fa.flash_attention_bwd_reference(q, k, v, bias, do, torch.zeros_like(o), lse)

    def broken(q, k, v, mask):
        bias = None if mask is None else fa.mask_bias(mask)
        return fa.FlashAttention.apply(q, k, v, bias, fa.flash_attention_fwd_reference, no_delta_bwd)

    model = Encoder(cfg, device="cuda", seed=None, trainable=True)
    model.load_state_dict(weights)
    batch = train_batch(PARITY_PAIRS, cfg.vocab_size)

    def loss_and_grads(attn_fn):
        model.zero_grad(set_to_none=True)
        loss = info_nce_loss(model, batch, cfg, 0.05, attn_fn)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    kernel_loss, kernel_grads = loss_and_grads(fa.flash_attention)
    plain_loss, plain_grads = loss_and_grads(plain)
    broken_loss, broken_grads = loss_and_grads(broken)
    cos = _grad_cosines(kernel_grads, plain_grads, cfg.hidden)
    broken_cos = _grad_cosines(broken_grads, plain_grads, cfg.hidden)
    worst = min(cos, key=cos.get)
    broken_worst = min(broken_cos, key=broken_cos.get)
    card.emit("train_parity", pairs=PARITY_PAIRS, kernel_loss=kernel_loss, plain_loss=plain_loss,
              loss_tol=LOSS_TOL, min_grad_cosine=cos[worst], min_grad_cosine_param=worst,
              bar=GRAD_COS_BAR, grad_cosine=cos,
              broken_no_delta={"loss": broken_loss, "min_grad_cosine": broken_cos[broken_worst],
                               "min_grad_cosine_param": broken_worst})
    check(all(math.isfinite(x) for x in (kernel_loss, plain_loss)), "finite parity losses")
    check(abs(kernel_loss - plain_loss) <= LOSS_TOL, f"parity loss {kernel_loss} vs {plain_loss}")
    check(cos[worst] >= GRAD_COS_BAR, f"gradient cosine {cos[worst]} ({worst})")
    check(broken_cos[broken_worst] < GRAD_COS_BAR,
          f"the bar cannot see a backward without delta: {broken_cos[broken_worst]}")


# -- the other model families: vision (BASELINE config #5), the reranker (#3), the
# decoder and its chat (#4) --------------------------------------------------------

N_IMAGES = 512  # bench.py multimodal_leg's BENCH_MM_IMAGES
N_IMAGE_QUERIES = 16  # and its BENCH_MM_QUERIES
IMAGE_BATCH = 64  # the embedder's max_batch_size in multimodal_leg
RERANK_BATCH = 256  # reranker_leg's BENCH_RERANK_BATCH
RERANK_SECONDS = 3.0  # reranker_leg's timed loop
DECODE_PROMPT = 128  # decode_leg's prompt of ones (bench.py SEQ_LEN)
SAMPLE_TOKENS = 16
CHAT_PROMPTS = 8
CHAT_NEW_TOKENS = 32
# Mistral-7B shape: every parameter of DecoderConfig() (embedding and lm_head untied)
MISTRAL_7B_PARAMS = 7_241_732_096


def make_png(i: int, noisy_rng: "np.random.Generator | None" = None) -> bytes:
    """bench.py multimodal_leg's ``make_png``: a 64x64 RGB image seeded by ``i``, with
    noise of +-12 levels from ``noisy_rng`` (the bench's one generator of seed 0, drawn
    in query order) when given."""
    from PIL import Image

    arr = np.random.default_rng(i).integers(0, 255, (64, 64, 3), np.uint8)
    if noisy_rng is not None:
        noise = noisy_rng.integers(-12, 12, arr.shape)
        arr = np.clip(arr.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


def vit_flops(cfg, b: int) -> float:
    """Multiply-adds x 2 of one ViT forward over b images: the patch embed, per layer
    the qkv, attention, output and MLP products, the projection."""
    t, hid = cfg.n_patches + 1, cfg.hidden
    per_layer = 2 * t * hid * (3 * hid + hid + 2 * cfg.intermediate) + 4 * t * t * hid
    return b * (2 * cfg.n_patches * cfg.patch * cfg.patch * 3 * hid
                + cfg.layers * per_layer + 2 * hid * cfg.out_dim)


def _count_calls(obj, name: str) -> list[int]:
    """Count the calls of ``obj.name`` (an instance attribute shadowing the method)
    -> the list of each call's row count; ``del obj.name`` restores the method."""
    sizes = []
    method = getattr(obj, name)

    def counted(rows, *args):
        sizes.append(len(rows))
        return method(rows, *args)

    setattr(obj, name, counted)
    return sizes


def phase_vision_parity(card: Card, embedder) -> int:
    """One 64-image batch of 224-px pixels (the bench's PNGs, resized on the host)
    through ``ImageEmbedder``'s forward with the kernel, and through the same weights
    with the plain attention on the card; and ``normalize_u8`` on the card against the
    host's ``preprocess_image``. Then the forward's time against its FLOP bound."""
    from PIL import Image

    cfg = embedder.config
    images = [Image.open(io.BytesIO(make_png(i))) for i in range(IMAGE_BATCH)]
    pixels = np.stack([preprocess_image_u8(img, cfg) for img in images])
    host = np.stack([preprocess_image(img, cfg) for img in images])
    dev = torch.from_numpy(pixels).cuda()
    norm_err = float(np.abs(normalize_u8(dev).cpu().numpy() - host).max())
    fa.KERNEL.launches = 0
    ours = embedder.forward_u8(pixels)
    torch.cuda.synchronize()
    launches = fa.KERNEL.launches
    ref = vision_forward(embedder.encoder, normalize_u8(dev), attn_fn=plain_attention)
    err = (ours - ref).abs().max().item()
    cos_min = float((ours * ref).sum(dim=1).min())
    finite = bool(torch.isfinite(ours).all()) and ours.shape == (IMAGE_BATCH, cfg.out_dim)
    norms = torch.linalg.vector_norm(ours, dim=1)
    forward_ms = cuda_ms(lambda: embedder.forward_u8(pixels), iters=20)
    flops = vit_flops(cfg, IMAGE_BATCH)
    card.emit("vision_parity", model="CLIP ViT-B/16 image tower (224 px, patch 16, hidden 768, "
              "12 layers, 12 heads, seeded)", batch=IMAGE_BATCH, max_abs_err=err,
              tol=TOL[torch.bfloat16], min_cosine=cos_min, normalize_u8_max_abs_err=norm_err,
              normalize_tol=1e-6, flash_launches=launches,
              unit_norm_max_dev=float((norms - 1).abs().max()),
              forward_ms=forward_ms, forward_gflop=flops / 1e9,
              forward_bound_ms=1e3 * flops / BF16_FLOP_PER_S,
              forward_roofline_share=1e3 * flops / BF16_FLOP_PER_S / forward_ms,
              note="forward_ms includes the uint8 upload and normalize_u8")
    check(finite, "vision embeddings: shape and finiteness")
    check(float((norms - 1).abs().max()) < 1e-3, "vision embeddings are unit vectors")
    check(math.isfinite(err) and err <= TOL[torch.bfloat16], f"vision kernel vs plain: {err}")
    check(norm_err <= 1e-6, f"normalize_u8 on the card vs the host: {norm_err}")
    check(launches == cfg.layers, f"vision: {launches} forward launches, not {cfg.layers}")
    return launches


def _multimodal_program(embedder, blobs: list, query_blobs: list, factory):
    """``bench.py::multimodal_leg``'s program against the port: PNG bytes through the
    python connector (100 ms autocommit), the image embedder UDF and DataIndex; one
    noisy query per commit once every image has reached the subscriber, top-1."""
    obs = {"imgs": {}, "answers": {}, "failures": [], "run_start": 0.0, "ingest_end": 0.0}
    ingest_done, answer_seen = threading.Event(), threading.Event()

    class ImgFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            obs["run_start"] = time.perf_counter()
            for i, blob in enumerate(blobs):
                self.next(img_id=i, data=blob)

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=300.0):
                obs["failures"].append(f"{len(obs['imgs'])} of {len(blobs)} images arrived")
                return
            for i, blob in enumerate(query_blobs):
                answer_seen.clear()
                self.next(qid=i, data=blob)
                if not answer_seen.wait(timeout=120.0):
                    obs["failures"].append(f"no answer to query {i}")
                    return

    imgs = pw.io.python.read(ImgFeed(), schema=pw.schema_from_types(img_id=int, data=bytes),
                             autocommit_duration_ms=100)
    imgs = imgs.select(img_id=pw.this.img_id, emb=embedder(pw.this.data))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, data=bytes),
                                autocommit_duration_ms=None)
    queries = queries.select(qid=pw.this.qid, qemb=embedder(pw.this.data))
    res = DataIndex(imgs, factory, imgs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=1)

    def on_img(key, row, time, is_addition):
        if is_addition:
            obs["imgs"][key] = (row["img_id"], np.asarray(row["emb"], np.float32))
            if len(obs["imgs"]) == len(blobs):
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][row["qid"]] = (tuple(row["_pw_index_reply_ids"]),
                                          np.asarray(row["qemb"], np.float32))
            answer_seen.set()

    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module
    pw.io.subscribe(imgs, on_change=on_img)
    pw.io.subscribe(res, on_change=on_answer)
    return obs, pw.run


def phase_multimodal_pipeline(card: Card, embedder) -> int:
    """``bench.py::multimodal_leg`` (BASELINE config #5) through the port's ``pw.run``:
    512 PNG images of 64x64 and 16 noisy queries, ViT-B/16 at full width, a 1,024-slot
    index. Reports images/s, the noisy-query top-1 and the forward's launches; checks
    that every query is answered with the top-1 of an exact f32 host search over the
    embeddings the subscriber received. Then the same program under the profiler, for
    the device's idle share inside commits."""
    blobs = [make_png(i) for i in range(N_IMAGES)]
    noise = np.random.default_rng(0)
    query_blobs = [make_png((i * 31) % N_IMAGES, noise) for i in range(N_IMAGE_QUERIES)]
    for b in (8, IMAGE_BATCH):
        embedder._fn(blobs[:b])  # warm, as the bench does
    dim = embedder.get_embedding_dimension()
    sizes = _count_calls(embedder, "forward_u8")
    factory = _KeptKnnFactory(dimensions=dim, capacity=1024)
    obs, run = _multimodal_program(embedder, blobs, query_blobs, factory)
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        run()
    finally:
        del embedder.forward_u8
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    imgs, answers = obs["imgs"], obs["answers"]
    keys = list(imgs)
    mat = np.stack([imgs[k][1] for k in keys])
    norms = np.linalg.norm(mat, axis=1)
    exact_ok, top1 = [], []
    for qid, (hits, qvec) in sorted(answers.items()):
        scores = mat @ qvec / np.maximum(norms * np.linalg.norm(qvec), 1e-30)
        exact_ok.append(len(hits) == 1 and hits[0] == keys[int(np.argmax(scores))])
        top1.append(bool(hits) and imgs[hits[0]][0] == (qid * 31) % N_IMAGES)
    ingest_s = obs["ingest_end"] - obs["run_start"]
    index = factory.built

    # the same program under the profiler: the device's idle share inside commits
    factory2 = DeviceKnnFactory(dimensions=dim, capacity=1024)
    obs2, run2 = _multimodal_program(embedder, blobs, query_blobs, factory2)
    device_pipeline.PIPELINE.configure()
    wall_ms, kernels, inside, _sched = _profiled_commits(run2)
    busy_ms = sum(k[0] for k in kernels)
    commit_ms = 1e3 * sum(inside)
    card.emit(
        "multimodal_pipeline",
        model="CLIP ViT-B/16 image tower (224 px, hidden 768, 12 layers, seeded)",
        n_images=len(imgs), n_queries=len(answers), images_per_s=N_IMAGES / ingest_s if ingest_s > 0 else None,
        ingest_s=ingest_s, run_s=run_s, noisy_query_top1=float(np.mean(top1)) if top1 else None,
        answers_equal_exact_f32_search=all(exact_ok) and len(exact_ok) == N_IMAGE_QUERIES,
        embed_calls=len(sizes), embed_chunk_sizes=sizes, flash_launches=launches,
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        live_device_batches_after_run=device_batches_held(),
        profiled_run={"wall_ms": wall_ms, "in_commit_wall_ms": commit_ms, "commits": len(inside),
                      "device_busy_ms": busy_ms if kernels else "not measured",
                      "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
                      "device_idle_share_in_commits": (1 - busy_ms / commit_ms) if kernels else "not measured",
                      "images": len(obs2["imgs"]), "answers": len(obs2["answers"]),
                      "top": [{"kernel": k[:80], "device_ms": ms, "launches": c} for ms, k, c in kernels[:8]]},
        failures=obs["failures"] + obs2["failures"],
    )
    check(not obs["failures"] and not obs2["failures"], f"multimodal: {obs['failures'] + obs2['failures']}")
    check(len(imgs) == N_IMAGES and len(obs2["imgs"]) == N_IMAGES, f"{len(imgs)} of {N_IMAGES} images arrived")
    check(len(answers) == N_IMAGE_QUERIES and len(obs2["answers"]) == N_IMAGE_QUERIES,
          f"{len(answers)} of {N_IMAGE_QUERIES} queries answered")
    check(all(exact_ok), "multimodal: an answer differs from the exact f32 search")
    check(launches > 0 and launches == embedder.config.layers * len(sizes),
          f"multimodal: {launches} forward launches for {len(sizes)} embed calls")
    check(index.rows_device == N_IMAGES and index.rows_host == 0,
          f"multimodal index routes: {index.rows_device} device, {index.rows_host} host")
    check(device_batches_held() == 0, "device batches held after the multimodal run")
    return launches


def phase_rerank(card: Card) -> int:
    """``bench.py::reranker_leg`` (BASELINE config #3): the cross-encoder reranker over
    256 (doc, query) pairs in a 3 s loop, pairs/s; the forward's launches per call; a
    profiler window over a few calls; one batch's scores with the kernel against the
    plain attention; and one ``pw.run`` of the same pairs as a two-column UDF, whose
    scores must be the direct call's on the same chunks."""
    rr = CrossEncoderReranker(max_batch_size=RERANK_BATCH, seed=SEED)
    docs = [doc_text(i) for i in range(RERANK_BATCH)]
    queries = [doc_text(i * 7) for i in range(RERANK_BATCH)]
    direct = rr._fn(docs, queries)  # warm
    fa.KERNEL.launches = 0
    calls, pairs = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RERANK_SECONDS:
        scores = rr._fn(docs, queries)
        calls += 1
        pairs += len(scores)
    loop_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    wall_ms, kernels, _ops = _profiled(lambda: [rr._fn(docs, queries) for _ in range(4)])
    busy_ms = sum(k[0] for k in kernels)

    ids, mask, real = rr.tokenize(docs, queries)
    ours = cross_encode(rr.model, ids, mask)[:real]
    ref = cross_encode(rr.model, ids, mask, attn_fn=plain_attention)[:real]
    rel = _rel_err(ours, ref)

    # the same pairs through pw.run, select(score=rr(doc, query))
    chunks, score_batch = [], rr._fn

    def recorded(d, q):
        chunks.append((list(d), list(q)))
        return score_batch(d, q)

    rr._fn = recorded
    got, done = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, (d, q) in enumerate(zip(docs, queries)):
                self.next(pair_id=i, doc=d, query=q)

    rows = pw.io.python.read(Feed(), schema=pw.schema_from_types(pair_id=int, doc=str, query=str),
                             autocommit_duration_ms=100)
    scored = rows.select(pair_id=pw.this.pair_id, score=rr(pw.this.doc, pw.this.query))

    def on_change(key, row, time, is_addition):
        if is_addition:
            got[row["pair_id"]] = row["score"]
            if len(got) == RERANK_BATCH:
                done.set()

    pw.io.subscribe(scored, on_change=on_change)
    device_pipeline.PIPELINE.configure()
    try:
        pw.run()
    finally:
        rr._fn = score_batch
    same_chunks = {}
    for d, q in chunks:
        same_chunks.update(zip(d, score_batch(d, q)))
    engine_scores = [got.get(i) for i in range(RERANK_BATCH)]
    equal_chunks = engine_scores == [same_chunks.get(d) for d in docs]
    card.emit("rerank", model="MiniLM-L6 cross-encoder (hidden 384, 6 layers, 12 heads, seeded)",
              batch=RERANK_BATCH, padded_shape=list(ids.shape), pairs_per_s=pairs / loop_s,
              calls=calls, loop_s=loop_s, flash_launches=launches,
              launches_per_call=launches / calls if calls else None,
              profile={"window": "4 calls of 256 pairs", "wall_ms_per_call": wall_ms / 4,
                       "device_busy_ms_per_call": busy_ms / 4 if kernels else "not measured",
                       "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
                       "top": [{"kernel": k[:80], "device_ms_per_call": ms / 4, "launches": c}
                               for ms, k, c in kernels[:8]]},
              kernel_vs_plain_rel_err=rel, tol=TOL[torch.bfloat16],
              engine={"answered": len(got), "chunks": [len(d) for d, _q in chunks],
                      "scores_equal_direct_on_same_chunks": equal_chunks,
                      "scores_equal_one_direct_call": engine_scores == direct})
    check(launches == LAYERS * calls, f"rerank: {launches} forward launches for {calls} calls")
    check(all(math.isfinite(x) for x in direct), "rerank scores are finite")
    check(math.isfinite(rel) and rel <= TOL[torch.bfloat16], f"rerank kernel vs plain: {rel}")
    check(len(got) == RERANK_BATCH, f"rerank pw.run answered {len(got)} of {RERANK_BATCH}")
    check(equal_chunks, "rerank: pw.run scores differ from the direct call's")
    return launches


def _step_logits(model, prompt: torch.Tensor, max_new: int, prefix: torch.Tensor) -> torch.Tensor:
    """The logits greedy decode sees at step ``len(prefix)``: the prompt's prefill and
    one cached step per prefix token, at the shapes ``greedy_generate`` uses (its cache
    length), so the logits are the same bits."""
    cache = init_cache(model.cfg, prompt.shape[0], prompt.shape[1] + max_new)
    offset = torch.zeros((prompt.shape[0],), dtype=torch.int64, device=prompt.device)
    logits, cache = decoder_forward(model, prompt, cache, pos_offset=offset)
    for j in range(prefix.shape[1]):
        logits, cache = decoder_forward(model, prefix[:, j:j + 1], cache, pos_offset=offset)
    return logits[:, -1]


def phase_decode(card: Card) -> "PipelineChat":
    """``bench.py::decode_leg`` (BASELINE config #4): the Mistral-7B shape with seeded
    bf16 weights on one card (built by ``PipelineChat``, whose decoder the chat phase
    reuses), greedy decode of a 128-token prompt of ones for 4 and for 36 new tokens:
    per-step ms by the bench's formula ((t36 - t4) / 32), tokens/s, HBM utilisation by
    the bench's formula and the step against its byte bound; the prefill and 32 steps
    after it timed alone; a profiler window over decode steps; and the checks:
    two greedy runs give the same tokens, ``top_k=1`` sampling gives the greedy tokens
    (up to a tie of the top logits, which top-k keeps as JAX's filter does), two rows of
    one prompt and one seed in a batch of 3 give the same tokens, and a sampled row
    gives the batch's tokens alone up to the first step where its logits differ (cuBLAS
    may round a product of another shape apart)."""
    gc.collect()
    torch.cuda.empty_cache()
    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chat = PipelineChat("mistral-7b", max_new_tokens=CHAT_NEW_TOKENS, max_batch_size=CHAT_PROMPTS,
                        seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dec = chat.decoder
    cfg = dec.cfg
    n_params = sum(p.numel() for p in dec.parameters())
    weight_gib = sum(p.numel() * p.element_size() for p in dec.parameters()) / 2**30
    prompt = torch.ones((1, DECODE_PROMPT), dtype=torch.int64, device="cuda")

    def timed(n_new: int) -> tuple[torch.Tensor, float]:
        torch.cuda.synchronize()
        start = time.perf_counter()
        toks = greedy_generate(dec, prompt, n_new)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - start

    first4, _ = timed(4)  # warm
    first36, _ = timed(36)
    toks4, t4 = timed(4)
    toks36, t36 = timed(36)
    # the bench's per-step time: 36 new tokens less 4, over the 32 steps between
    per_step = (t36 - t4) / 32.0
    tok_s = 1.0 / per_step
    # the prefill alone (cache, 128-token forward, first token), and 32 decode steps
    # after it, each ended by a synchronise: the median of three
    offset = torch.zeros((1,), dtype=torch.int64, device="cuda")
    prefills, step_runs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        cache = init_cache(cfg, 1, DECODE_PROMPT + 36)
        logits, cache = decoder_forward(dec, prompt, cache, pos_offset=offset)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefills.append(time.perf_counter() - start)
        start = time.perf_counter()
        for _ in range(32):
            logits, cache = decoder_forward(dec, tok[:, None], cache, pos_offset=offset)
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        step_runs.append((time.perf_counter() - start) / 32)
    prefill = float(np.median(prefills))
    per_step_direct = float(np.median(step_runs))
    del cache
    step_bytes = 2 * (n_params - cfg.vocab_size * cfg.hidden)  # every weight but tok_emb
    bound_ms = 1e3 * step_bytes / HBM_BYTES_PER_S
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # a profiler window over decode steps alone, after a prefill
    cache = init_cache(cfg, 1, DECODE_PROMPT + 16)
    logits, cache = decoder_forward(dec, prompt, cache, pos_offset=offset)
    state = {"tok": logits[:, -1].argmax(-1)}
    n_steps = 8

    def steps() -> None:
        for _ in range(n_steps):
            out, _cache = decoder_forward(dec, state["tok"][:, None], cache, pos_offset=offset)
            state["tok"] = out[:, -1].argmax(-1)

    wall_ms, kernels, _ops = _profiled(steps)
    busy_ms = sum(k[0] for k in kernels)
    device_ops = sum(k[2] for k in kernels)
    del cache

    # top_k=1 sampling against greedy
    sampled = sample_generate(dec, prompt, 36, [SEED], top_k=1)
    diverge = (sampled[0] != toks36[0]).nonzero()
    tie = None
    if len(diverge):
        j = int(diverge[0])
        step_logits = _step_logits(dec, prompt, 36, toks36[:, :j])[0]
        g, s_ = int(toks36[0, j]), int(sampled[0, j])
        tie = {"step": j, "greedy_token": g, "sampled_token": s_,
               "tied_at_the_max": bool(step_logits[g] == step_logits[s_] == step_logits.max())}
    # a sampled row alone and inside a batch of 3. Rows 0 and 2 are one prompt with one
    # seed: inside one batch they meet the same products, so their tokens must be the
    # same. Alone, a row meets products of another shape, which cuBLAS may round apart
    # in bf16: its tokens must be the batch's up to the first step where its logits
    # differ between the two runs.
    rng = np.random.default_rng(SEED)
    other = torch.from_numpy(rng.integers(4, cfg.vocab_size, (1, DECODE_PROMPT))).cuda()
    batch_prompts = torch.cat([prompt, other, prompt])
    seeds = [11, 12, 11]
    knobs = dict(temperature=0.8, top_k=50, top_p=0.9, eos_id=EOS_ID)
    batch = sample_generate(dec, batch_prompts, SAMPLE_TOKENS, seeds, **knobs)
    alone_rows = []
    for r in range(2):
        alone = sample_generate(dec, batch_prompts[r:r + 1], SAMPLE_TOKENS, [seeds[r]], **knobs)
        diverge = (alone[0] != batch[r]).nonzero()
        row = {"row": r, "steps_equal": int(diverge[0]) if len(diverge) else SAMPLE_TOKENS}
        if len(diverge):
            j = row["steps_equal"]
            in_batch = _step_logits(dec, batch_prompts, SAMPLE_TOKENS, batch[:, :j])[r]
            by_itself = _step_logits(dec, batch_prompts[r:r + 1], SAMPLE_TOKENS, alone[:, :j])[0]
            row["logits_differ_at_divergence"] = not torch.equal(in_batch, by_itself)
            row["logits_max_abs_diff"] = (in_batch - by_itself).abs().max().item()
        alone_rows.append(row)
    duplicate_rows_equal = bool(torch.equal(batch[0], batch[2]))

    card.emit(
        "decode",
        model=f"Mistral-7B shape (hidden {cfg.hidden}, {cfg.layers} layers, {cfg.heads} heads / "
              f"{cfg.kv_heads} kv heads, intermediate {cfg.intermediate}, vocab {cfg.vocab_size}; "
              "seeded bf16 weights)",
        n_params=n_params, weights_gib=weight_gib, init_s=init_s, prompt_len=DECODE_PROMPT,
        device_gib_before_phase=before_gib, peak_device_gib=peak_gib,
        t4_s=t4, t36_s=t36, prefill_ms=1e3 * prefill, prefill_ms_runs=[1e3 * x for x in prefills],
        per_step_ms=1e3 * per_step, per_step_ms_direct=1e3 * per_step_direct,
        per_step_ms_direct_runs=[1e3 * x for x in step_runs], decode_tokens_per_s=tok_s,
        hbm_utilization=2.0 * n_params * tok_s / HBM_BYTES_PER_S,
        step_bound_ms=bound_ms, step_bound_by="bytes (every bf16 weight but tok_emb, once a step)",
        step_roofline_share=bound_ms / (1e3 * per_step),
        profile={"window": f"{n_steps} decode steps at batch 1 after a {DECODE_PROMPT}-token prefill",
                 "wall_ms_per_step": wall_ms / n_steps,
                 "device_busy_ms_per_step": busy_ms / n_steps if kernels else "not measured",
                 "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
                 "device_ops_per_step": device_ops / n_steps,
                 "top": [{"kernel": k[:80], "device_ms_per_step": ms / n_steps, "launches": c}
                         for ms, k, c in kernels[:10]]},
        greedy_tokens=toks36[0].tolist(),
        greedy_runs_equal=bool(torch.equal(first36, toks36) and torch.equal(first4, toks4)),
        top_k_1_equals_greedy=tie is None, top_k_1_tie=tie,
        sampled_duplicate_rows_equal_in_batch=duplicate_rows_equal,
        sampled_row_alone_against_batch=alone_rows,
    )
    check(n_params == MISTRAL_7B_PARAMS, f"Mistral-7B shape: {n_params} parameters")
    check(toks36.shape == (1, 36) and bool(((toks36 >= 0) & (toks36 < cfg.vocab_size)).all()),
          "greedy tokens: shape and range")
    check(torch.equal(first36, toks36) and torch.equal(first4, toks4), "two greedy runs differ")
    check(tie is None or tie["tied_at_the_max"],
          f"top_k=1 sampling left greedy decode without a tie of the top logits: {tie}")
    check(duplicate_rows_equal, "two rows of one prompt and one seed sampled apart in a batch")
    check(all(row["steps_equal"] == SAMPLE_TOKENS or row["logits_differ_at_divergence"]
              for row in alone_rows),
          f"a sampled row left the batch's tokens with the same logits: {alone_rows}")
    check(per_step > 0 and per_step_direct > 0 and prefill > 0,
          f"decode timing: step {per_step} / {per_step_direct}, prefill {prefill}")
    return chat


def phase_chat_engine(card: Card, chat) -> dict:
    """Eight prompts through ``PipelineChat("mistral-7b", max_new_tokens=32)`` in
    ``pw.run``, with the decode phase's weights. Every prompt must be answered, and each
    reply must be the tokenizer's decode of a direct ``greedy_generate`` on the same
    left-padded batch (the chunk the UDF was handed)."""
    prompts = [prompt_chat_single_qa(doc_text(i)) if i % 2 else doc_text(i)
               for i in range(CHAT_PROMPTS)]
    chunks, generate = [], chat._fn

    def recorded(batch):
        chunks.append(list(batch))
        return generate(batch)

    chat._fn = recorded
    replies, done = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, p in enumerate(prompts):
                self.next(prompt_id=i, prompt=p)

    rows = pw.io.python.read(Feed(), schema=pw.schema_from_types(prompt_id=int, prompt=str),
                             autocommit_duration_ms=100)
    answered = rows.select(prompt_id=pw.this.prompt_id, reply=chat(pw.this.prompt))

    def on_change(key, row, time, is_addition):
        if is_addition:
            replies[row["prompt_id"]] = row["reply"]
            if len(replies) == CHAT_PROMPTS:
                done.set()

    pw.io.subscribe(answered, on_change=on_change)
    device_pipeline.PIPELINE.configure()
    t0 = time.perf_counter()
    try:
        pw.run()
    finally:
        chat._fn = generate
    run_s = time.perf_counter() - t0
    direct = {}
    for batch in chunks:
        ids, mask, _texts = chat.encode_prompts(batch)
        toks = greedy_generate(chat.decoder, ids, CHAT_NEW_TOKENS, eos_id=EOS_ID, prompt_mask=mask)
        direct.update(zip(batch, (chat.tokenizer.decode(list(r)) for r in toks.cpu().numpy())))
    equal = [replies.get(i) == direct.get(p) for i, p in enumerate(prompts)]
    card.emit("chat_engine", model="Mistral-7B shape (the decode phase's weights)",
              prompts=CHAT_PROMPTS, max_new_tokens=CHAT_NEW_TOKENS, answered=len(replies),
              chunks=[len(c) for c in chunks], run_s=run_s,
              generated_tokens_per_s=CHAT_PROMPTS * CHAT_NEW_TOKENS / run_s,
              replies_equal_direct_greedy=equal,
              reply_words=[len(replies.get(i, "").split()) for i in range(CHAT_PROMPTS)])
    check(len(replies) == CHAT_PROMPTS, f"chat: {len(replies)} of {CHAT_PROMPTS} prompts answered")
    check(all(equal), f"chat replies differ from the direct greedy decode: {equal}")
    return {"replies": len(replies)}


# -- the RAG document pipeline of the xpack ----------------------------------------------

VS_DOCS = 3000  # bench.py vector_store_leg's BENCH_VS_DOCS
VS_QUERIES = 16  # and its BENCH_VS_QUERIES
VS_CAPACITY = 4096  # its index capacity: 1 << max(10, (n_docs - 1).bit_length())
VS_PROFILED_DOCS = 768  # the profiled second run: three 256-doc commits' worth
RAG_PROMPTS = 4
DIST_TOL = 1e-5  # dist = 1 - cos, against the exact f32 host search
BGE = "BAAI/bge-base-en-v1.5"


def _vector_store_program(embedder: EncoderEmbedder, corpus, n_queries: int,
                          factory: DeviceKnnFactory, wait_s: float):
    """``bench.py::vector_store_leg``'s program against the port: docs with
    ``_metadata={"path": ...}`` through the python connector (100 ms autocommit) into a
    ``VectorStoreServer`` (parse, split, embed, index on the card), and queries of docs'
    own texts with k = 10, sent one at a time once every chunk has reached the
    subscriber of ``store.indexed``. Returns the observations and the run."""
    n_docs = len(corpus)
    obs = {"chunks": {}, "answers": {}, "latencies": [], "timeouts": [], "failures": [],
           "run_start": 0.0, "ingest_end": 0.0, "doc_times": set()}
    ingest_done, answer_seen = threading.Event(), threading.Event()

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            obs["run_start"] = time.perf_counter()
            for i in range(n_docs):
                self.next(data=corpus[i], _metadata={"path": f"/d/{i}"})

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=wait_s):
                obs["failures"].append(f"{len(obs['chunks'])} of {n_docs} chunks arrived")
                return
            for i in range(n_queries):
                answer_seen.clear()
                t0 = time.perf_counter()
                self.next(query=corpus[(i * 53) % n_docs], k=K)
                if answer_seen.wait(timeout=wait_s):
                    obs["latencies"].append(time.perf_counter() - t0)
                else:
                    obs["timeouts"].append(i)

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(data=str, _metadata=dict),
                             autocommit_duration_ms=100)
    store = VectorStoreServer(docs, embedder=embedder, index_capacity=VS_CAPACITY)
    store.index.factory = factory  # the same index, kept so its routes can be read
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(query=str, k=int),
                                autocommit_duration_ms=None)
    res = store.retrieve_query(queries)
    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            meta = row["_metadata"]
            path = getattr(meta, "value", meta)["path"]
            obs["chunks"][path] = (row["text"], np.asarray(row["emb"], np.float32))
            obs["doc_times"].add(time)
            if len(obs["chunks"]) == n_docs:
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][len(obs["answers"])] = row["result"]
            answer_seen.set()

    pw.io.subscribe(store.indexed, on_change=on_chunk)
    pw.io.subscribe(res, on_change=on_answer)
    return obs, pw.run


def _exact_top_k(chunks: dict, qvec: np.ndarray, k: int):
    """Exact f32 cosine search over the vectors the index received -> (paths in rank
    order, dists 1 - cos in that order, the (k+1)-th dist)."""
    paths = sorted(chunks)
    mat = np.stack([chunks[p][1] for p in paths])
    cos = (mat @ qvec) / np.maximum(np.linalg.norm(mat, axis=1) * np.linalg.norm(qvec),
                                    np.float32(1e-30))
    order = np.argsort(-cos, kind="stable")
    dist = 1.0 - cos[order].astype(np.float64)
    return [paths[j] for j in order[:k]], dist[:k], dist[k] if len(order) > k else math.inf


def _check_answer(result, query: str, qvec: np.ndarray, chunks: dict) -> dict:
    """One answer against the exact f32 host search: its top-1 is the query's own doc;
    its paths are the exact top-k's and in its order, where neighbours' dists differ by
    more than DIST_TOL (closer ones are a tie either search may order either way, as is
    the k-th against the (k+1)-th); each dist is 1 - cos of the query and that doc's
    vector within DIST_TOL; each text and path belong together."""
    paths = [hit["metadata"]["path"] for hit in result]
    dists = np.array([hit["dist"] for hit in result], np.float64)
    exact_paths, exact_dist, next_dist = _exact_top_k(chunks, qvec, len(result))
    own = [chunks[p][1] for p in paths]
    direct = np.array([1.0 - float(np.dot(v, qvec) / (np.linalg.norm(v) * np.linalg.norm(qvec)))
                       for v in own])
    ties_only = all(
        a == b or abs(float(exact_dist[i]) - float(dists[i])) <= DIST_TOL
        for i, (a, b) in enumerate(zip(paths, exact_paths))
    ) and (set(paths) == set(exact_paths) or abs(float(exact_dist[-1]) - next_dist) <= DIST_TOL)
    return {
        "k": len(result),
        "top1_own_doc": bool(result) and result[0]["text"] == query,
        "texts_match_paths": all(hit["text"] == chunks[p][0] for hit, p in zip(result, paths)),
        "order_exact": paths == exact_paths,
        "order_within_ties": ties_only,
        "max_dist_err_vs_exact": float(np.abs(dists - exact_dist).max()) if result else None,
        "max_dist_err_vs_own_vector": float(np.abs(dists - direct).max()) if result else None,
    }


def phase_vector_store(card: Card) -> tuple[EncoderEmbedder, int]:
    """``bench.py::vector_store_leg`` (BASELINE config #2) through the port's ``pw.run``:
    3,000 generated docs with ``_metadata`` through the python connector into a
    ``VectorStoreServer`` whose embedder is BGE-base at full width (768 hidden, 12
    layers, 12 heads of 64, bf16, seeded weights, 128-token buckets, 256-doc chunks),
    a 4,096-slot index on the card, then 16 queries of docs' own texts with k = 10, one
    at a time. Reports docs/s (first doc into the connector to the last chunk at the
    subscriber), query p50/p95, peak memory, the forward's launches (12 per embed call)
    and the groupby's device calls; checks that every query is answered, that each
    answer's top-1 is its own doc and its hits and dists are the exact f32 search's
    over the vectors the index received, and that every doc takes the device route.
    Then a profiled run of 768 docs for the device's idle share inside commits."""
    corpus = [doc_text(i) for i in range(VS_DOCS)]
    embedder = EncoderEmbedder(BGE, max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    check(embedder.config.hidden == 768 and embedder.config.layers == 12
          and embedder.config.heads == 12 and embedder.config.dtype == torch.bfloat16,
          f"BGE-base config: {embedder.config}")
    for b in (8, 64, CHUNK):
        embedder.embed_batch(corpus[:b])  # warm, as the bench does
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=VS_CAPACITY)
    obs, run = _vector_store_program(embedder, corpus, VS_QUERIES, factory, wait_s=300.0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    device_pipeline.PIPELINE.configure()
    device_ops.reset_counters()
    fa.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        run()
    finally:
        del embedder.embed_batch
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    groupby_device_calls = device_ops.hit_counts()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    index = factory.built
    chunks, answers = obs["chunks"], obs["answers"]
    checks = []
    for i, result in sorted(answers.items()):
        query = corpus[(i * 53) % VS_DOCS]
        qvec = embedder.embed_batch([query]).float().cpu().numpy()[0]  # the run's own shape
        checks.append(_check_answer(result, query, qvec, chunks))
    lat_ms = sorted(1e3 * x for x in obs["latencies"])
    ingest_s = obs["ingest_end"] - obs["run_start"]

    # the same program under the profiler, on fewer docs and no queries: the device's
    # idle share inside commits
    factory2 = DeviceKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=VS_CAPACITY)
    obs2, run2 = _vector_store_program(embedder, corpus[:VS_PROFILED_DOCS], 0, factory2, wait_s=300.0)
    device_pipeline.PIPELINE.configure()
    wall_ms, kernels, inside, _sched = _profiled_commits(run2)
    busy_ms = sum(k[0] for k in kernels)
    commit_ms = 1e3 * sum(inside)

    # statistics_query's count over the same 3,000 docs (a BM25 store: the count needs
    # no embedding): does the groupby's count take the device route at this size?
    static_docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=dict),
        [(corpus[i], {"path": f"/d/{i}"}) for i in range(VS_DOCS)])
    stats_query = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
    device_ops.reset_counters()
    stats, _ = pw.debug.table_to_dicts(
        DocumentStore(static_docs, retriever_factory="bm25").statistics_query(stats_query))
    stats_device_calls = device_ops.hit_counts()
    stats_count = [row["count"] for row in stats.values()]
    card.emit(
        "vector_store",
        model=f"{BGE} (hidden 768, 12 layers, 12 heads of 64, bf16, seeded)",
        n_docs=len(chunks), n_queries=len(lat_ms), query_timeouts=len(obs["timeouts"]),
        capacity=index.capacity, docs_per_s=VS_DOCS / ingest_s if ingest_s > 0 else None,
        ingest_s=ingest_s, doc_commits=len(obs["doc_times"]), run_s=run_s,
        query_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        query_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        query_ms_in_order=[1e3 * x for x in obs["latencies"]],
        top1_self_retrieval=float(np.mean([c["top1_own_doc"] for c in checks])) if checks else None,
        answers_order_exact=sum(c["order_exact"] for c in checks),
        max_dist_err_vs_exact=max((c["max_dist_err_vs_exact"] for c in checks), default=None),
        max_dist_err_vs_own_vector=max((c["max_dist_err_vs_own_vector"] for c in checks), default=None),
        embed_calls=embed_calls[0], flash_launches=launches,
        groupby_device_calls=groupby_device_calls,
        statistics_query={"count": stats_count, "groupby_device_calls": stats_device_calls},
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        live_device_batches_after_run=device_batches_held(), peak_device_gib=peak_gib,
        profiled_run={"docs": len(obs2["chunks"]), "wall_ms": wall_ms, "in_commit_wall_ms": commit_ms,
                      "commits": len(inside),
                      "device_busy_ms": busy_ms if kernels else "not measured",
                      "device_idle_share_in_commits": (1 - busy_ms / commit_ms) if kernels else "not measured",
                      "top": [{"kernel": k[:80], "device_ms": ms, "launches": c} for ms, k, c in kernels[:10]]},
        failures=obs["failures"] + obs2["failures"],
    )
    check(not obs["failures"] and not obs2["failures"], f"vector store: {obs['failures'] + obs2['failures']}")
    check(len(chunks) == VS_DOCS and len(obs2["chunks"]) == VS_PROFILED_DOCS,
          f"{len(chunks)} of {VS_DOCS} chunks arrived")
    check(len(answers) == VS_QUERIES and not obs["timeouts"],
          f"vector store: {len(answers)} answers, timeouts {obs['timeouts']}")
    check(all(c["k"] == K for c in checks), f"vector store: answers of {[c['k'] for c in checks]} hits")
    check(all(c["top1_own_doc"] for c in checks), "vector store: a query's top-1 is not its own doc")
    check(all(c["texts_match_paths"] for c in checks), "vector store: a hit's text and path disagree")
    check(all(c["order_within_ties"] for c in checks),
          "vector store: an answer is not the exact f32 search's top-k")
    check(all(c["max_dist_err_vs_exact"] <= DIST_TOL and c["max_dist_err_vs_own_vector"] <= DIST_TOL
              for c in checks), f"vector store: dist off 1 - cos by more than {DIST_TOL}")
    check(launches > 0 and launches == embedder.config.layers * embed_calls[0],
          f"vector store: {launches} forward launches for {embed_calls[0]} embed calls")
    check(index.rows_device == VS_DOCS and index.rows_host == 0,
          f"vector store index routes: {index.rows_device} device, {index.rows_host} host")
    check(device_batches_held() == 0, "device batches held after the vector store run")
    check(stats_count == [VS_DOCS], f"statistics_query counted {stats_count} chunks")
    return embedder, launches


def phase_rag(card: Card, chat, embedder: EncoderEmbedder) -> int:
    """BASELINE config #4's template: ``AdaptiveRAGQuestionAnswerer`` over the vector
    store's program (the same 3,000 docs, BGE-base and index) with the decode phase's
    chat (the Mistral-7B shape, so no second model is loaded); 4 prompts in one commit
    once every chunk has arrived, so their expansion loops run at once on the event
    loop's worker threads, each calling the chat on the card. Checks that every prompt
    is answered and that each reply is the chat's direct batch-1 reply to the prompt
    ``prompts.prompt_qa`` builds from the first two retrieved docs: the seeded model's
    replies are token ids, which never say "No information found.", so no prompt
    expands (checked)."""
    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop
    from pathway_tpu_torch.xpacks.llm import prompts

    corpus = [doc_text(i) for i in range(VS_DOCS)]
    questions = [corpus[(i * 331) % VS_DOCS] for i in range(RAG_PROMPTS)]
    obs = {"chunks": 0, "replies": {}, "failures": [], "sent": 0.0, "done": 0.0}
    ingest_done, all_answered = threading.Event(), threading.Event()
    perf_counter = time.perf_counter

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(VS_DOCS):
                self.next(data=corpus[i], _metadata={"path": f"/d/{i}"})

    class PromptFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=300.0):
                obs["failures"].append(f"{obs['chunks']} of {VS_DOCS} chunks arrived")
                return
            obs["sent"] = perf_counter()
            for q in questions:
                self.next(prompt=q)
            if not all_answered.wait(timeout=300.0):
                obs["failures"].append(f"{len(obs['replies'])} of {RAG_PROMPTS} prompts answered")

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(data=str, _metadata=dict),
                             autocommit_duration_ms=100)
    store = VectorStoreServer(docs, embedder=embedder, index_capacity=VS_CAPACITY)
    rag = AdaptiveRAGQuestionAnswerer(chat, store, n_starting_documents=2, factor=2,
                                      max_iterations=4)
    queries = pw.io.python.read(PromptFeed(), schema=pw.schema_from_types(prompt=str),
                                autocommit_duration_ms=None)
    answered = rag.answer_query(queries)
    out = queries.restrict(answered).select(prompt=queries.prompt, result=answered.result,
                                            docs=answered.context_docs)

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            obs["chunks"] += 1
            if obs["chunks"] == VS_DOCS:
                ingest_done.set()

    def on_reply(key, row, time, is_addition):
        if is_addition:
            obs["replies"][row["prompt"]] = (row["result"], [d["text"] for d in row["docs"]])
            if len(obs["replies"]) == RAG_PROMPTS:
                obs["done"] = perf_counter()
                all_answered.set()

    pw.io.subscribe(store.chunks, on_change=on_chunk)
    pw.io.subscribe(out, on_change=on_reply)
    calls, generate = [], chat._fn

    def counted(batch):
        calls.append(len(batch))
        return generate(batch)

    chat._fn = counted  # what the UDF calls; the direct calls below take the method
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        pw.run()
    finally:
        chat._fn = generate
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    loop_threads = [t.name for t in threading.enumerate() if t.is_alive() and t.name == "pw-udf-loop"]
    stop_event_loop()
    rows, direct_s = [], 0.0
    for q in questions:
        reply, doc_texts = obs["replies"].get(q, (None, []))
        t1 = time.perf_counter()
        direct = chat.generate_batch([prompts.prompt_qa(q, doc_texts[:2])])[0]
        direct_s += time.perf_counter() - t1
        rows.append({"answered": reply is not None, "equal_direct": reply == direct,
                     "expanded": "no information found." in (direct or "").lower(),
                     "docs": len(doc_texts), "own_doc_first": bool(doc_texts) and doc_texts[0] == q,
                     "reply_words": len((reply or "").split())})
    card.emit("rag", model="Mistral-7B shape (the decode phase's weights) over the vector store "
                           f"({BGE}, {VS_DOCS} docs)",
              prompts=RAG_PROMPTS, answered=len(obs["replies"]), run_s=run_s,
              prompts_to_replies_s=(obs["done"] - obs["sent"]) if obs["done"] else None,
              direct_calls_one_after_another_s=direct_s,
              chat_calls=len(calls), chat_batch_sizes=calls, flash_launches=launches,
              udf_loop_threads_after_run=loop_threads, replies=rows, failures=obs["failures"])
    check(not obs["failures"], f"rag: {obs['failures']}")
    check(len(obs["replies"]) == RAG_PROMPTS, f"rag: {len(obs['replies'])} of {RAG_PROMPTS} answered")
    check(not any(r["expanded"] for r in rows), "rag: the seeded chat said it found nothing")
    check(all(r["equal_direct"] for r in rows), f"rag: replies differ from the direct calls: {rows}")
    check(calls == [1] * RAG_PROMPTS, f"rag: chat calls {calls}, one batch-1 call a prompt expected")
    check(not loop_threads, f"rag: event-loop threads alive after pw.run: {loop_threads}")
    check(launches > 0 and launches % embedder.config.layers == 0,
          f"rag: {launches} forward launches, not {embedder.config.layers} a call")
    return launches


RAG_EVAL_SAMPLES = 256
RAG_EVAL_CHAT_SAMPLES = 16


def _rag_eval_samples() -> list:
    """BASELINE config #5's harness on labelled samples made here: each question is a
    doc's own text, its answer that doc's first three words, its source the doc."""
    from pathway_tpu_torch.xpacks.llm import RagEvalSample

    corpus = [doc_text(i) for i in range(VS_DOCS)]
    picks = [(i * 89) % VS_DOCS for i in range(RAG_EVAL_SAMPLES)]  # 89 is prime to 3,000
    return [RagEvalSample(question=corpus[i], answer=" ".join(corpus[i].split()[:3]),
                          source=corpus[i]) for i in picks]


def _question_of(prompt: str) -> str:
    """The question of a ``prompts.prompt_qa`` prompt."""
    return prompt.rsplit("\nQuestion: ", 1)[1].rsplit("\nAnswer:", 1)[0]


def phase_rag_evals(card: Card, chat, embedder: EncoderEmbedder) -> int:
    """BASELINE config #5's ``rag_evals`` harness on the card: ``RagEvaluator`` over
    ``BaseRAGQuestionAnswerer(search_topk=2)`` and a ``DocumentStore`` over the vector
    store phase's BGE-base (full width, seeded) with the same 3,000 docs from a static
    table and a 4,096-slot index; one static run (``GraphRunner().capture``) each.
    Run A: 256 samples and an oracle chat, a host UDF keyed on the prompt's question; it
    must score exact match, token F1 and hit rate 1.0 with no sample missing. Run B: the
    decode phase's chat (the Mistral-7B shape) on the first 16 samples, its UDF handed
    one prompt a call; each answer must be the chat's direct batch-1 reply to
    ``prompts.prompt_qa`` of the same retrieved docs, the hit rate 1.0, none missing.
    Reports both reports, each run's wall seconds and the forward's launches (12 per
    embed call)."""
    from pathway_tpu_torch.internals.udfs.executors import BatchExecutor, stop_event_loop
    from pathway_tpu_torch.xpacks.llm import BaseRAGQuestionAnswerer, RagEvaluator, prompts

    class KeptRows(RagEvaluator):
        """Keeps the captured (prompt, result, context_docs) rows."""

        def _run(self, samples):
            self.rows = super()._run(samples)
            return self.rows

    phase_t0 = time.perf_counter()
    corpus = [doc_text(i) for i in range(VS_DOCS)]
    samples = _rag_eval_samples()
    answers = {s.question: s.answer for s in samples}

    @pw.udf
    def oracle(prompt: str) -> str:
        return answers.get(_question_of(prompt), "No information found.")

    def evaluator(llm, n: int):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=str, _metadata=dict),
            [(corpus[i], {"path": f"/d/{i}"}) for i in range(VS_DOCS)])
        store = DocumentStore(docs, embedder=embedder, index_capacity=VS_CAPACITY)
        return KeptRows(BaseRAGQuestionAnswerer(llm, store, search_topk=2)), samples[:n]

    device_pipeline.PIPELINE.configure()
    embed_calls, _sizes = _count_embed_calls(embedder)
    fa.KERNEL.launches = 0
    try:
        ev_a, samples_a = evaluator(oracle, RAG_EVAL_SAMPLES)
        t0 = time.perf_counter()
        report_a = ev_a.evaluate(samples_a)
        run_a_s = time.perf_counter() - t0
        calls_a, launches_a = embed_calls[0], fa.KERNEL.launches

        chat_calls, generate, executor = [], chat._fn, chat._executor

        def counted(batch):
            chat_calls.append(len(batch))
            return generate(batch)

        chat._fn, chat._executor = counted, BatchExecutor(max_batch_size=1)
        try:
            ev_b, samples_b = evaluator(chat, RAG_EVAL_CHAT_SAMPLES)
            t0 = time.perf_counter()
            report_b = ev_b.evaluate(samples_b)
            run_b_s = time.perf_counter() - t0
        finally:
            chat._fn, chat._executor = generate, executor
    finally:
        del embedder.embed_batch
    launches = fa.KERNEL.launches
    calls = embed_calls[0]
    loop_threads = [t.name for t in threading.enumerate() if t.is_alive() and t.name == "pw-udf-loop"]
    stop_event_loop()
    direct_equal, own_doc_first = [], []
    for prompt, result, docs in ev_b.rows:
        texts = [d["text"] for d in docs]
        direct_equal.append(result == chat.generate_batch([prompts.prompt_qa(prompt, texts)])[0])
        own_doc_first.append(bool(texts) and texts[0] == prompt)
    card.emit("rag_evals",
              store=f"{BGE} (hidden 768, 12 layers, bf16, seeded), {VS_DOCS} docs, "
                    f"{VS_CAPACITY}-slot index, search_topk=2",
              oracle_run={"samples": len(samples_a), "report": report_a.as_dict(), "run_s": run_a_s,
                          "embed_calls": calls_a, "flash_launches": launches_a},
              chat_run={"model": "Mistral-7B shape (the decode phase's weights)",
                        "samples": len(samples_b), "report": report_b.as_dict(), "run_s": run_b_s,
                        "embed_calls": calls - calls_a, "flash_launches": launches - launches_a,
                        "chat_calls": len(chat_calls), "chat_batch_sizes": sorted(set(chat_calls)),
                        "answers_equal_direct": sum(direct_equal),
                        "own_doc_first": sum(own_doc_first)},
              flash_launches=launches, embed_calls=calls, udf_loop_threads_after_run=loop_threads,
              phase_s=time.perf_counter() - phase_t0)
    a, b = report_a, report_b
    check(a.n_samples == RAG_EVAL_SAMPLES and a.n_missing == 0,
          f"rag_evals oracle run: {a.n_samples} samples, {a.n_missing} missing")
    check(a.answer_exact_match == a.answer_token_f1 == a.retrieval_hit_rate == 1.0,
          f"rag_evals oracle run: {a.as_dict()}")
    check(b.n_samples == RAG_EVAL_CHAT_SAMPLES and b.n_missing == 0 and b.retrieval_hit_rate == 1.0,
          f"rag_evals chat run: {b.as_dict()}")
    check(len(ev_b.rows) == RAG_EVAL_CHAT_SAMPLES and all(direct_equal),
          f"rag_evals chat run: answers equal to the direct calls {direct_equal}")
    check(chat_calls == [1] * RAG_EVAL_CHAT_SAMPLES, f"rag_evals chat calls {chat_calls}")
    check(not loop_threads, f"rag_evals: event-loop threads alive after the runs: {loop_threads}")
    check(launches > 0 and launches == embedder.config.layers * calls,
          f"rag_evals: {launches} forward launches for {calls} embed calls")
    return launches


#: rows of table_ops: half device_ops_leg's 200,000, cut so that the script keeps its time
N_OPS = 100_000
OPS_COMMITS = 20
OPS_DEDUP_INSTANCES = 4096
OPS_SORT_INSTANCES = 1024
OPS_GROUPS = 64
OPS_PICKS = 4096  # ids that having keeps
OPS_ASYNC_ROWS = 4096
OPS_FLOOR = 900  # seconds: dt.floor to 15 minutes
OPS_EPOCH = datetime.datetime(2024, 1, 1)


def _ops_rows(n: int = N_OPS) -> dict:
    """``n`` seeded rows in bench_dataflow.py's manner: a primary-key row number, an int
    key, a float value (distinct multiples of 1/8, so every sum is exact in float64 in
    any order and every instance has one largest value), a word of mixed case and a
    timestamp (whole seconds around 2024-01-01)."""
    rng = np.random.default_rng(SEED + 11)
    return {
        "id": np.arange(n),
        "key": rng.integers(0, 1 << 20, n),
        "v": (rng.permutation(n) - n // 2) * 0.125,
        "word": [w.upper() if f else w for w, f in
                 zip((_WORDS[j] for j in rng.integers(0, len(_WORDS), n)),
                     rng.random(n) < 0.5)],
        "secs": rng.integers(-10**8, 10**8, n),
        "picks": rng.choice(n, OPS_PICKS, replace=False),
    }


def _ops_expected(rows: dict) -> dict:
    """The plain Python / NumPy answer of table_ops' program on ``rows``."""
    ids, keys, vals, words, secs = (rows[c] for c in ("id", "key", "v", "word", "secs"))
    n = len(ids)
    sel = {}
    for i in range(n):
        s = int(secs[i])
        sel[i] = (int(keys[i]), words[i].lower(), len(words[i]),
                  (OPS_EPOCH + datetime.timedelta(seconds=s)).hour,
                  OPS_EPOCH + datetime.timedelta(seconds=s // OPS_FLOOR * OPS_FLOOR), abs(float(vals[i])))
    best: dict[int, int] = {}
    for i in range(n):
        inst = int(keys[i]) % OPS_DEDUP_INSTANCES
        if inst not in best or vals[i] > vals[best[inst]]:
            best[inst] = i
    dedup = {inst: int(ids[i]) for inst, i in best.items()}
    groups: dict[int, list] = {}
    for inst, i in best.items():
        g = groups.setdefault(int(keys[i]) % OPS_GROUPS, [0, 0.0])
        g[0] += 1
        g[1] += float(vals[i])
    order: dict[int, list] = {}
    for i in np.argsort(vals, kind="stable"):
        order.setdefault(int(keys[i]) % OPS_SORT_INSTANCES, []).append(int(i))
    neighbours = {}
    for members in order.values():
        for j, i in enumerate(members):
            neighbours[i] = (members[j - 1] if j else None,
                             members[j + 1] if j + 1 < len(members) else None)
    return {"sel": sel, "dedup": dedup, "groups": {g: tuple(x) for g, x in groups.items()},
            "sort": neighbours, "having": sorted(int(i) for i in rows["picks"])}


async def _ops_async_fn(v: float) -> float:
    return 3.0 * v + 1.0


def _table_ops_run(n_ops: int, commits: int) -> dict:
    """One streamed ``pw.run`` of table_ops' program (see :func:`phase_table_ops`) over
    ``n_ops`` rows in ``commits`` commits, under the environment as it stands: -> each
    output against the plain answer, the outputs' bits, the run's seconds, the kept
    runner, the groupby's routes and the segment kernels' launches."""
    import datetime

    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop

    rows = _ops_rows(n_ops)
    t0 = time.perf_counter()
    want = _ops_expected(rows)
    plain_s = time.perf_counter() - t0
    n_batch = n_ops // commits
    seen = {"sel": 0}
    batch_seen = threading.Semaphore(0)
    failures: list = []

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for b in range(commits):
                for i in range(b * n_batch, (b + 1) * n_batch):
                    self.next(rid=i, key=int(rows["key"][i]), v=float(rows["v"][i]),
                              word=rows["word"][i],
                              ts=OPS_EPOCH + datetime.timedelta(seconds=int(rows["secs"][i])))
                if not batch_seen.acquire(timeout=300.0):
                    failures.append(f"batch {b} did not reach the subscriber")
                    return

    class AsyncFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(OPS_ASYNC_ROWS):
                self.next(rid=i, v=float(rows["v"][i]))

    schema = pw.schema_from_dict({
        "rid": pw.column_definition(dtype=int, primary_key=True),
        "key": int, "v": float, "word": str, "ts": datetime.datetime,
    })
    t = pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=100)
    sel = t.select(pw.this.rid, pw.this.key, low=pw.this.word.str.lower(), n=pw.this.word.str.len(),
                   hour=pw.this.ts.dt.hour(), q=pw.this.ts.dt.floor(datetime.timedelta(seconds=OPS_FLOOR)),
                   a=pw.this.v.num.abs())
    dedup = t.deduplicate(value=pw.this.v, instance=pw.this.key % OPS_DEDUP_INSTANCES,
                          acceptor=lambda new, old: new > old)
    groups = dedup.select(g=pw.this.key % OPS_GROUPS, v=pw.this.v).groupby(pw.this.g).reduce(
        pw.this.g, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))
    srt = t.sort(key=pw.this.v, instance=pw.this.key % OPS_SORT_INSTANCES)
    picks = pw.debug.table_from_rows(pw.schema_from_types(r=int), [(int(r),) for r in rows["picks"]])
    kept = t.having(picks.select(p=t.pointer_from(picks.r)).p)
    a = pw.io.python.read(AsyncFeed(), schema=pw.schema_from_types(rid=int, v=float),
                          autocommit_duration_ms=100)
    awaited = a.select(pw.this.rid, w=pw.apply_async(_ops_async_fn, pw.this.v)).await_futures()

    states = {name: {} for name in ("sel", "dedup", "groups", "sort", "having", "async")}
    times: set = set()

    def sink(name: str):
        state = states[name]

        def on_change(key, row, time, is_addition):
            if is_addition:
                state[key] = row
            else:
                state.pop(key, None)
            if name == "sel":
                times.add(time)
                seen["sel"] += 1
                if seen["sel"] % n_batch == 0:
                    batch_seen.release()

        return on_change

    for name, table in (("sel", sel), ("dedup", dedup), ("groups", groups), ("sort", srt),
                        ("having", kept), ("async", awaited)):
        pw.io.subscribe(table, on_change=sink(name))
    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    _zero_segment_launches()
    with _KeptRunner() as keep:
        t0 = time.perf_counter()
        pw.run()
        run_s = time.perf_counter() - t0
    by_kernel = _segment_launches()
    loop_threads = [th.name for th in threading.enumerate() if th.is_alive() and th.name == "pw-udf-loop"]
    stop_event_loop()
    runner = keep.runners[0]
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in runner.scope.nodes
              if hasattr(n, "routes")}

    st = states
    got_sel = {r["rid"]: (r["key"], r["low"], r["n"], r["hour"], r["q"], r["a"]) for r in st["sel"].values()}
    id_of = {k: r["rid"] for k, r in st["sel"].items()}
    got_dedup = {r["key"] % OPS_DEDUP_INSTANCES: r["rid"] for r in st["dedup"].values()}
    got_groups = {r["g"]: (r["c"], r["s"]) for r in st["groups"].values()}
    got_sort = {id_of.get(k): (id_of.get(r["prev"]), id_of.get(r["next"])) for k, r in st["sort"].items()}
    got_having = sorted(r["rid"] for r in st["having"].values())
    got_async = {r["rid"]: r["w"] for r in st["async"].values()}
    want_async = {i: 3.0 * float(rows["v"][i]) + 1.0 for i in range(OPS_ASYNC_ROWS)}
    bits = lambda d: {k: tuple(np.float64(x).view(np.int64).item() if isinstance(x, float) else x  # noqa: E731
                               for x in (v if isinstance(v, tuple) else (v,))) for k, v in d.items()}
    got = {"sel": bits(got_sel), "dedup": got_dedup, "groups": bits(got_groups), "sort": got_sort,
           "having": got_having, "async": bits(got_async)}
    same = {
        "sel": got["sel"] == bits(want["sel"]),
        "dedup": got_dedup == want["dedup"],
        "groups": got["groups"] == bits(want["groups"]),
        "sort": got_sort == want["sort"],
        "having": got_having == want["having"],
        "async": got["async"] == bits(want_async),
    }
    return {"out": got, "same": same, "run_s": run_s, "plain_s": plain_s, "runner": runner,
            "routes": routes, "by_kernel": by_kernel, "commits": len(times),
            "out_rows": {name: len(s) for name, s in states.items()},
            "loop_threads": loop_threads, "failures": failures, "rows": n_ops}


def phase_table_ops(card: Card) -> int:
    """One streamed ``pw.run`` of 200,000 rows through ``pw.io.python`` in 20 commits of
    10,000 (the feed waits for each commit to reach the subscriber): one ``select`` of
    the expression namespaces (``.str.lower()``, ``.str.len()``, ``.dt.hour()``,
    ``.dt.floor(15 min)``, ``.num.abs()``), ``deduplicate(value=v, instance=key % 4096)``
    keeping the largest value, ``sort(key=v, instance=key % 1024)``, ``having`` over
    4,096 picked ids from a static table, and ``groupby(key % 64).reduce(count, sum)``
    over the deduplicated rows, whose commits the card's segment reduction takes; with
    a second stream of 4,096 rows through ``pw.apply_async`` and ``await_futures``.
    Every output's final state must equal a plain Python / NumPy computation of the same
    rows exactly. Reports rows/s, the commits and the segment kernels' launches. The
    device operators are forced (``PATHWAY_TPU_DEVICE_OPS=1``), as in
    relational_engine."""
    phase_t0 = time.perf_counter()
    res = _with_device_ops("1", lambda: _table_ops_run(N_OPS, OPS_COMMITS))
    by_kernel, routes, same, failures = res["by_kernel"], res["routes"], res["same"], res["failures"]
    launches = sum(by_kernel.values())
    groupbys = [r for name, r in routes.items() if name.startswith("GroupbyNode")]
    card.emit("table_ops", rows=N_OPS, commits=res["commits"], async_rows=OPS_ASYNC_ROWS,
              dedup_instances=OPS_DEDUP_INSTANCES, sort_instances=OPS_SORT_INSTANCES,
              run_s=res["run_s"], rows_per_s=N_OPS / res["run_s"], plain_answer_s=res["plain_s"],
              out_rows=res["out_rows"], equals_plain=same, segment_launches=by_kernel,
              groupby_routes=groupbys, hit_counts=device_ops.hit_counts(),
              udf_loop_threads_after_run=res["loop_threads"], failures=failures,
              phase_s=time.perf_counter() - phase_t0)
    check(not failures, f"table_ops: {failures}")
    check(all(same.values()), f"table_ops: outputs differ from the plain computation: {same}")
    check(len(groupbys) == 1 and groupbys[0]["device"] > 0 and groupbys[0]["host"] == 0,
          f"table_ops groupby routes {groupbys}")
    check(launches > 0, f"table_ops launched no segment kernel: {by_kernel}")
    check(not res["loop_threads"],
          f"table_ops: event-loop threads alive after pw.run: {res['loop_threads']}")
    return launches


# -- the temporal operators: Nexmark ------------------------------------------------------

NEXMARK_EVENTS = 50_000  # 100,000 until the databases phase came: cut for the script's time
NEXMARK_COMMITS = 10
NEXMARK_MS_PER_EVENT = 1  # 1,000 events/s of event time
NEXMARK_WINDOW_MS = 10_000
NEXMARK_HOP_MS = 2_000
# Beam's NexmarkConfiguration defaults and its generator's constants
NEXMARK_PROPORTIONS = (1, 3, 46)  # person : auction : bid
NEXMARK_ACTIVE_PEOPLE = 1000
NEXMARK_IN_FLIGHT_AUCTIONS = 100
NEXMARK_HOT_AUCTION_RATIO = 2
NEXMARK_HOT_SELLER_RATIO = 4
NEXMARK_HOT_BIDDER_RATIO = 4
_NEXMARK_FIRST_ID = 1000  # FIRST_PERSON_ID and FIRST_AUCTION_ID
_NEXMARK_HOT_SPAN = 100  # HOT_SELLER_RATIO, HOT_AUCTION_RATIO, HOT_BIDDER_RATIO: ids rounded down
_NEXMARK_PERSON_LEAD = 10
_NEXMARK_AUCTION_LEAD = 10
PERSON, AUCTION, BID = 0, 1, 2


def _nexmark_events(n: int) -> dict:
    """Beam's Nexmark generator (``sdks/java/testing/nexmark``: ``GeneratorConfig``, the
    person, auction and bid generators) on numpy from ``SEED``: event ``i`` is a person, an
    auction or a bid by ``i % 50`` against the 1 : 3 : 46 mix, at event time ``i`` ms;
    persons and auctions take the next ids, an auction's seller and a bid's bidder are a
    hot person (id rounded down to 100) 3 times in 4 or else one of the 1,000 active
    people, a bid's auction is the hot auction (rounded down to 100) 1 time in 2 or else
    one of the 100 in flight, and a price is ``round(10 ** (6 u) * 100)`` cents. Columns
    (kind, t, oid, seller, auction, bidder, price), 0 where a kind has no such field."""
    rng = np.random.default_rng(SEED + 12)
    i = np.arange(n, dtype=np.int64)
    total = sum(NEXMARK_PROPORTIONS)
    n_person, n_auction, _n_bid = NEXMARK_PROPORTIONS
    epoch, offset = i // total, i % total
    kind = np.where(offset < n_person, PERSON, np.where(offset < n_person + n_auction, AUCTION, BID))
    last_person = epoch * n_person + np.minimum(offset, n_person - 1)  # lastBase0PersonId
    a_epoch = np.where(offset < n_person, epoch - 1, epoch)
    a_off = np.where(offset < n_person, n_auction - 1,
                     np.where(offset >= n_person + n_auction, n_auction - 1, offset - n_person))
    last_auction = a_epoch * n_auction + a_off  # lastBase0AuctionId

    def next_person() -> np.ndarray:
        people = last_person + 1
        active = np.minimum(people, NEXMARK_ACTIVE_PEOPLE)
        return people - active + (rng.random(n) * (active + _NEXMARK_PERSON_LEAD)).astype(np.int64)

    hot_seller = rng.integers(0, NEXMARK_HOT_SELLER_RATIO, n) > 0
    seller = np.where(hot_seller, last_person // _NEXMARK_HOT_SPAN * _NEXMARK_HOT_SPAN, next_person())
    hot_auction = rng.integers(0, NEXMARK_HOT_AUCTION_RATIO, n) > 0
    lo = np.maximum(last_auction - NEXMARK_IN_FLIGHT_AUCTIONS, 0)
    cold_auction = lo + (rng.random(n) * (last_auction - lo + 1 + _NEXMARK_AUCTION_LEAD)).astype(np.int64)
    auction = np.where(hot_auction, last_auction // _NEXMARK_HOT_SPAN * _NEXMARK_HOT_SPAN, cold_auction)
    hot_bidder = rng.integers(0, NEXMARK_HOT_BIDDER_RATIO, n) > 0
    bidder = np.where(hot_bidder, last_person // _NEXMARK_HOT_SPAN * _NEXMARK_HOT_SPAN + 1, next_person())
    price = np.round(10.0 ** (rng.random(n) * 6.0) * 100.0).astype(np.int64)
    is_p, is_a, is_b = kind == PERSON, kind == AUCTION, kind == BID
    zero = np.zeros(n, np.int64)
    return {
        "kind": kind,
        "t": i * NEXMARK_MS_PER_EVENT,
        "oid": np.where(is_p, last_person, np.where(is_a, last_auction, zero)) + _NEXMARK_FIRST_ID * (is_p | is_a),
        "seller": np.where(is_a, seller + _NEXMARK_FIRST_ID, zero),
        "auction": np.where(is_b, auction + _NEXMARK_FIRST_ID, zero),
        "bidder": np.where(is_b, bidder + _NEXMARK_FIRST_ID, zero),
        "price": np.where(is_b, price, zero),
    }


def _sliding_starts(t: int, hop: int, duration: int) -> list[int]:
    first = (t - duration) // hop * hop + hop  # the first start s with t < s + duration
    return list(range(first, t + 1, hop))


def _nexmark_expected(ev: dict) -> dict:
    """The plain Python answer of the four queries on ``ev``."""
    kinds, ts = ev["kind"].tolist(), ev["t"].tolist()
    ids, sellers = ev["oid"].tolist(), ev["seller"].tolist()
    auctions, prices = ev["auction"].tolist(), ev["price"].tolist()
    q5: dict = {}
    q7: dict = {}
    persons_in: dict = {}  # window start -> person ids
    auctions_in: dict = {}  # window start -> [(auction id, seller)]
    auction_t: dict = {}
    for j, kind in enumerate(kinds):
        t = ts[j]
        w = t // NEXMARK_WINDOW_MS * NEXMARK_WINDOW_MS
        if kind == PERSON:
            persons_in.setdefault(w, set()).add(ids[j])
        elif kind == AUCTION:
            auctions_in.setdefault(w, []).append((ids[j], sellers[j]))
            auction_t[ids[j]] = t
        else:
            for s in _sliding_starts(t, NEXMARK_HOP_MS, NEXMARK_WINDOW_MS):
                c = q5.setdefault((s, auctions[j]), [0, 0])
                c[0] += 1
                c[1] += prices[j]
            q7[w] = max(q7.get(w, prices[j]), prices[j])
    q8 = sorted((w, a, s) for w, pairs in auctions_in.items() for a, s in pairs
                if s in persons_in.get(w, ()))
    joined = sorted((auctions[j], ts[j], prices[j]) for j, kind in enumerate(kinds)
                    if kind == BID and auctions[j] in auction_t
                    and 0 <= ts[j] - auction_t[auctions[j]] <= NEXMARK_WINDOW_MS)
    return {"q5": {k: tuple(v) for k, v in q5.items()}, "q7": q7, "q8": q8, "interval": joined}


def _nexmark_program(ev: dict, n_batch: int):
    """Nexmark queries 5, 7 and 8 and an interval join over one ``pw.io.python`` event
    stream; the feed pushes ``n_batch`` events, then waits for the commit that holds
    them to end at the subscribers. -> what the sinks gather: each query's state, Q7's
    updates, the commits and the feed's clocks."""
    cols = ("kind", "t", "oid", "seller", "auction", "bidder", "price")
    # built before the run: the feed's thread only pushes, so a batch reaches the
    # connector well inside one autocommit window
    rows = [dict(zip(cols, r)) for r in zip(*(ev[c].tolist() for c in cols))]
    out = {"q5": {}, "q7": {}, "q8": {}, "interval": {}, "q7_updates": [], "times": set(),
           "seen": 0, "released": 0, "last_row": 0.0, "first_event": 0.0, "failures": []}
    batch_seen = threading.Semaphore(0)

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            out["first_event"] = time.perf_counter()
            for b in range(0, len(rows), n_batch):
                for r in rows[b:b + n_batch]:
                    self.next(**r)
                if not batch_seen.acquire(timeout=300.0):
                    out["failures"].append(f"events from {b} did not reach the subscriber")
                    return

    events = pw.io.python.read(Feed(), schema=pw.schema_from_types(**dict.fromkeys(cols, int)),
                               autocommit_duration_ms=800)
    persons = events.filter(pw.this.kind == PERSON).select(pw.this.t, pw.this.oid)
    auctions = events.filter(pw.this.kind == AUCTION).select(pw.this.t, pw.this.oid, pw.this.seller)
    bids = events.filter(pw.this.kind == BID).select(pw.this.t, pw.this.auction, pw.this.price)
    q5 = bids.windowby(
        bids.t, window=pw.temporal.sliding(hop=NEXMARK_HOP_MS, duration=NEXMARK_WINDOW_MS),
        instance=bids.auction,
    ).reduce(pw.this._pw_window_start, pw.this._pw_instance, n=pw.reducers.count(),
             total=pw.reducers.sum(pw.this.price))
    q7 = bids.windowby(
        bids.t, window=pw.temporal.tumbling(NEXMARK_WINDOW_MS),
        behavior=pw.temporal.exactly_once_behavior(),
    ).reduce(pw.this._pw_window_start, top=pw.reducers.max(pw.this.price))
    q8 = pw.temporal.window_join(
        persons, auctions, persons.t, auctions.t, pw.temporal.tumbling(NEXMARK_WINDOW_MS),
        persons.oid == auctions.seller,
    ).select(start=pw.left._pw_window_start, auction=auctions.oid, seller=persons.oid)
    joined = auctions.interval_join(
        bids, auctions.t, bids.t, pw.temporal.interval(0, NEXMARK_WINDOW_MS),
        auctions.oid == bids.auction,
    ).select(auction=pw.right.auction, t=pw.right.t, price=pw.right.price)

    def on_event(key, row, time, is_addition):
        out["times"].add(time)
        out["seen"] += 1

    def on_event_time_end(time):
        # the whole commit has run: release the feed for each batch it completed
        while out["released"] < min(out["seen"] // n_batch, -(-len(rows) // n_batch)) or (
                out["seen"] == len(rows) and out["released"] * n_batch < len(rows)):
            out["released"] += 1
            batch_seen.release()

    def sink(name: str, fields):
        state = out[name]

        def on_change(key, row, time, is_addition):
            out["last_row"] = _now()
            if is_addition:
                state[key] = tuple(row[f] for f in fields)
            else:
                state.pop(key, None)
            if name == "q7":
                out["q7_updates"].append((tuple(row[f] for f in fields), time, is_addition))

        return on_change

    pw.io.subscribe(events, on_change=on_event, on_time_end=on_event_time_end)
    for name, table, fields in (("q5", q5, ("_pw_window_start", "_pw_instance", "n", "total")),
                                ("q7", q7, ("_pw_window_start", "top")),
                                ("q8", q8, ("start", "auction", "seller")),
                                ("interval", joined, ("auction", "t", "price"))):
        pw.io.subscribe(table, on_change=sink(name, fields))
    return out


_now = time.perf_counter  # the sinks' own ``time`` argument shadows the module


def _nexmark_run(ev: dict, n_batch: int) -> tuple[dict, list]:
    """One ``pw.run`` of the Nexmark program. -> (its outputs, the routes of the kept
    runner's nodes)."""
    out = _nexmark_program(ev, n_batch)
    with _KeptRunner() as keep:
        pw.run()
    nodes = keep.runners[0].scope.nodes
    routes = [(type(n).__name__, [r.kind.name for r, _c in getattr(n, "reducers", ())], dict(n.routes))
              for n in nodes if hasattr(n, "routes")]
    return out, routes


def _nexmark_final(o: dict) -> dict:
    """The queries' final states of one Nexmark run, for comparisons."""
    return {
        "q5": {(s, a): (n, tot) for s, a, n, tot in o["q5"].values()},
        "q7": {s: top for s, top in o["q7"].values()},
        "q8": sorted(o["q8"].values()),
        "interval": sorted(o["interval"].values()),
    }


def phase_temporal(card: Card) -> int:
    """Nexmark queries 5 (hot items: a sliding window of 10 s every 2 s per auction,
    count and sum of the price), 7 (highest bid: a tumbling 10 s window with
    ``exactly_once_behavior``, so the buffer and freeze nodes are on the path) and 8
    (new users: a tumbling 10 s ``window_join`` of persons and auctions on person id ==
    seller), and an interval join of bids to their auction within 10 s after it, over
    50,000 events of Beam's generator (1,000 events/s of event time, in event-time
    order) as one streamed ``pw.run`` through ``pw.io.python`` in 10 commits of 5,000;
    the feed waits for each commit to reach the subscriber. Once on the host kernels
    (``PATHWAY_TPU_DEVICE_OPS=0``), then on the card; both runs' outputs must equal a
    plain Python computation exactly and each other, Q7 may retract nothing, and the
    Q5 groupby must reduce every commit it sees on the card (no row path). Reports
    events/s (first event into the connector to the last row at the subscribers), the
    commits, the segment kernels' launches, the matcher calls and each query's rows."""
    phase_t0 = time.perf_counter()
    ev = _nexmark_events(NEXMARK_EVENTS)
    t0 = time.perf_counter()
    want = _nexmark_expected(ev)
    plain_s = time.perf_counter() - t0
    n_batch = NEXMARK_EVENTS // NEXMARK_COMMITS
    device_ops.configure()
    host, host_routes = _with_device_ops("0", lambda: _nexmark_run(ev, n_batch))
    device_ops.reset_counters()
    _zero_segment_launches()
    t0 = time.perf_counter()
    got, routes = _with_device_ops("1", lambda: _nexmark_run(ev, n_batch))
    run_s = time.perf_counter() - t0
    by_kernel = _segment_launches()
    launches = sum(by_kernel.values())
    hits = device_ops.hit_counts()
    got_f, host_f = _nexmark_final(got), _nexmark_final(host)
    # commit times follow the connector's autocommit clock, not the data: Q7's updates
    # compare by row and sign, in order
    same_as_host = got_f == host_f and (
        [(r, a) for r, _t, a in got["q7_updates"]] == [(r, a) for r, _t, a in host["q7_updates"]])
    same = {q: got_f[q] == want[q] for q in want}
    q5_nodes = [r for name, kinds, r in routes
                if name == "GroupbyNode" and sorted(kinds) == ["COUNT", "SUM"]]
    span_s = got["last_row"] - got["first_event"]
    card.emit("temporal", events=NEXMARK_EVENTS, commits=len(got["times"]),
              host_commits=len(host["times"]),
              events_per_s=NEXMARK_EVENTS / span_s, span_s=span_s, run_s=run_s,
              plain_answer_s=plain_s, rows={q: len(got_f[q]) for q in got_f},
              q7_updates=len(got["q7_updates"]), equals_plain=same,
              equals_host_kernels=same_as_host, segment_launches=by_kernel,
              matcher_calls=hits.get("match_pairs", 0),
              segment_reduce_calls=hits.get("segment_reduce", 0),
              routes=[(name, kinds, r) for name, kinds, r in routes if name in ("GroupbyNode", "JoinNode")],
              host_routes=[(n, r) for n, _k, r in host_routes if n == "GroupbyNode"],
              failures=got["failures"] + host["failures"], phase_s=time.perf_counter() - phase_t0)
    check(not got["failures"] and not host["failures"], f"temporal: {got['failures'] + host['failures']}")
    check(all(same.values()), f"temporal: outputs differ from the plain computation: {same}")
    check(same_as_host, "temporal: the card's run differs from the host kernels' run")
    check(all(added for _row, _t, added in got["q7_updates"]) and
          len(got["q7_updates"]) == len(want["q7"]), "temporal: Q7 retracted or revised a window")
    check(len(q5_nodes) == 1 and q5_nodes[0]["device"] == len(got["times"])
          and q5_nodes[0]["host"] == 0 and q5_nodes[0]["rows"] == 0,
          f"temporal: Q5 groupby routes {q5_nodes} over {len(got['times'])} commits")
    check(all(r["device"] == 0 for n, _k, r in host_routes), "temporal: the host run took the card")
    check(by_kernel["int_sum"] > 0, f"temporal launched no segment kernel: {by_kernel}")
    check(hits.get("match_pairs", 0) > 0, "temporal: Q8's join never reached the matcher")
    return launches


# -- pw.iterate: PageRank -----------------------------------------------------------------

GRAPH_SCALE = 11  # Graph500's smallest class is scale 26; 12 until cut for the script's time
GRAPH_EDGE_FACTOR = 16
GRAPH_ABC = (0.57, 0.19, 0.19)
PAGERANK_ROUNDS = 20
PAGERANK_FIRST_SHARE = 0.9  # the first commit's share of the edges
PAGERANK_TOL = 1e-9


def _kronecker_edges(scale: int, edge_factor: int) -> tuple[np.ndarray, np.ndarray]:
    """Graph500's Kronecker generator (``kronecker_generator.m``) on numpy from ``SEED``:
    ``edge_factor * 2**scale`` edges, each picking a quadrant per bit level with
    probabilities A, B, C and 1 - A - B - C, then a random relabelling of the vertices
    and a random order of the edges."""
    rng = np.random.default_rng(SEED + 13)
    n, m = 1 << scale, edge_factor << scale
    a, b, c = GRAPH_ABC
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for bit in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        u += ii.astype(np.int64) << bit
        v += jj.astype(np.int64) << bit
    perm = rng.permutation(n)
    order = rng.permutation(m)
    return perm[u][order], perm[v][order]


def _numpy_pagerank(u: np.ndarray, v: np.ndarray, rounds: int, damping: float = 0.85):
    """``stdlib.graphs.pagerank`` in NumPy, with its rounding (``round(..., 12)`` of
    ``(1 - d) + d * inflow``) and its stop (no change, or ``rounds`` rounds). -> ({vertex:
    rank}, rounds run)."""
    verts = np.unique(np.concatenate([u, v]))
    size = int(verts.max()) + 1
    deg = np.bincount(u, minlength=size).astype(np.float64)
    has_inflow = np.bincount(v, minlength=size) > 0
    rank = np.zeros(size)
    rank[verts] = 1.0
    for step in range(1, rounds + 1):
        inflow = np.bincount(v, weights=rank[u] / deg[u], minlength=size)
        new = rank.copy()
        for x in verts.tolist():
            t = float(inflow[x]) if has_inflow[x] else 0.0
            new[x] = round((1.0 - damping) + damping * t, 12)
        done = np.array_equal(new, rank)
        rank = new
        if done:
            break
    return {int(x): float(rank[x]) for x in verts}, step


class _RoutesScheduler(Scheduler):
    """The scheduler of ``pw.iterate``'s rounds, keeping its groupbys' and joins'
    routes."""

    seen: list = []

    def run_static(self) -> None:
        super().run_static()
        for n in self.scope.nodes:
            if hasattr(n, "routes"):
                _RoutesScheduler.seen.append((type(n).__name__, dict(n.routes)))


def _pagerank_run(u: np.ndarray, v: np.ndarray, n_first: int) -> dict:
    """PageRank over a StreamGenerator edge table of two commits (the first ``n_first``
    edges, then the rest) through one ``pw.run``. -> the ranks after each commit, the
    seconds and rounds of each fixed point, and the routes of the rounds' operators."""
    from pathway_tpu_torch.internals import iterate as iterate_mod

    edges_rows = [{"u": a, "v": b} for a, b in zip(u.tolist(), v.tolist())]
    edges = pw.debug.StreamGenerator().table_from_list_of_batches(
        [edges_rows[:n_first], edges_rows[n_first:]], pw.schema_from_types(u=int, v=int))
    ranks = pw.stdlib.graphs.pagerank(edges, iteration_limit=PAGERANK_ROUNDS)
    engine = ranks._spec.params["engine"]
    fixed_points: list = []
    compute_all = engine.compute_all

    def timed(states):
        t0 = time.perf_counter()
        result = compute_all(states)
        fixed_points.append((time.perf_counter() - t0, engine.steps))
        return result

    engine.compute_all = timed
    state: dict = {}
    changed: set = set()
    by_commit: dict = {}

    def on_change(key, row, time, is_addition):
        changed.add(time)
        if is_addition:
            state[key] = (row["v"], row["rank"])
        else:
            state.pop(key, None)

    def on_time_end(time):
        if time in changed:
            by_commit[time] = dict(state.values())

    pw.io.subscribe(ranks, on_change=on_change, on_time_end=on_time_end)
    _RoutesScheduler.seen = []
    iterate_mod.Scheduler = _RoutesScheduler
    try:
        t0 = time.perf_counter()
        pw.run()
        run_s = time.perf_counter() - t0
    finally:
        iterate_mod.Scheduler = Scheduler
    return {"commits": [ranks_ for _t, ranks_ in sorted(by_commit.items())], "fixed_points": fixed_points, "run_s": run_s,
            "routes": list(_RoutesScheduler.seen)}


def phase_iterate(card: Card) -> int:
    """``pw.stdlib.graphs.pagerank`` (20 rounds at most) through one ``pw.run`` over a
    Graph500 Kronecker graph of scale 11 (2,048 vertices, 32,768 edges; A = 0.57, B = C
    = 0.19, edge factor 16) fed as two commits of a StreamGenerator table: 90% of the
    edges, then the other 10%, which makes the iteration recompute and emit a delta.
    Once on the host kernels (``PATHWAY_TPU_DEVICE_OPS=0``), then on the card: the ranks
    after each commit must be the host run's bit for bit and within 1e-9 of a NumPy power
    iteration with the same rounding and the same rounds; every groupby inside the
    rounds must take the device route and the inner joins the matcher. Reports seconds
    and rounds per commit, edges per second per round, and the segment and matcher
    calls."""
    phase_t0 = time.perf_counter()
    u, v = _kronecker_edges(GRAPH_SCALE, GRAPH_EDGE_FACTOR)
    n_first = int(len(u) * PAGERANK_FIRST_SHARE)
    t0 = time.perf_counter()
    want = [_numpy_pagerank(u[:n_first], v[:n_first], PAGERANK_ROUNDS),
            _numpy_pagerank(u, v, PAGERANK_ROUNDS)]
    plain_s = time.perf_counter() - t0
    device_ops.configure()
    host = _with_device_ops("0", lambda: _pagerank_run(u, v, n_first))
    device_ops.reset_counters()
    _zero_segment_launches()
    got = _with_device_ops("1", lambda: _pagerank_run(u, v, n_first))
    by_kernel = _segment_launches()
    launches = sum(by_kernel.values())
    hits = device_ops.hit_counts()
    bits = lambda ranks: {k: np.float64(x).view(np.int64).item() for k, x in ranks.items()}  # noqa: E731
    err = [max(abs(got_c.get(x, math.inf) - r) for x, r in want_c.items())
           for got_c, (want_c, _steps) in zip(got["commits"], want)]
    per_commit = [{"seconds": s, "rounds": r, "edges": n,
                   "edges_per_s_per_round": n * r / s}
                  for (s, r), n in zip(got["fixed_points"], (n_first, len(u)))]
    groupbys = [r for name, r in got["routes"] if name == "GroupbyNode"]
    joins = [r for name, r in got["routes"] if name == "JoinNode"]
    card.emit("iterate", vertices=1 << GRAPH_SCALE, edges=len(u), first_commit_edges=n_first,
              commits=len(got["commits"]), per_commit=per_commit,
              host_per_commit=[{"seconds": s, "rounds": r} for s, r in host["fixed_points"]],
              numpy_rounds=[steps for _w, steps in want], max_abs_err=err,
              equals_host_kernels=[bits(a) == bits(b) for a, b in zip(got["commits"], host["commits"])],
              run_s=got["run_s"], plain_answer_s=plain_s, segment_launches=by_kernel,
              segment_reduce_calls=hits.get("segment_reduce", 0),
              matcher_calls=hits.get("match_pairs", 0),
              inner_groupby_routes={k: sum(r[k] for r in groupbys) for k in ("device", "host", "rows")},
              inner_join_routes={k: sum(r[k] for r in joins) for k in ("device", "host", "rows")},
              phase_s=time.perf_counter() - phase_t0)
    check(len(got["commits"]) == 2 and len(host["commits"]) == 2,
          f"iterate: {len(got['commits'])} commits of ranks, want 2")
    check(all(bits(a) == bits(b) for a, b in zip(got["commits"], host["commits"])),
          "iterate: the card's ranks differ from the host kernels'")
    check(all(set(g) == set(w) for g, (w, _s) in zip(got["commits"], want)),
          "iterate: the ranked vertices differ from NumPy's")
    check(max(err) <= PAGERANK_TOL, f"iterate: ranks {err} from NumPy's, bar {PAGERANK_TOL}")
    check([r for _s, r in got["fixed_points"]] == [s for _w, s in want],
          f"iterate: rounds {got['fixed_points']} against NumPy's {[s for _w, s in want]}")
    check(groupbys and all(r["device"] > 0 and r["host"] == 0 and r["rows"] == 0 for r in groupbys),
          f"iterate: inner groupby routes {groupbys}")
    check(any(r["device"] > 0 for r in joins) and all(r["host"] == 0 for r in joins),
          f"iterate: inner join routes {joins}")
    check(by_kernel["fold_runs"] > 0, f"iterate: the inflow sum launched no fold: {by_kernel}")
    return launches


# -- the relational operators -----------------------------------------------------------

N_REL = 1_000_000  # bench_dataflow.py's N
N_RIGHT = 50_000  # its join_inner / join_multikey right side
N_ENGINE = 200_000  # its device_ops_leg's size
ENGINE_CHUNK = 25_000  # rows between the connector's pauses in relational_engine
N_DIM = 1024
INC_COMMITS, INC_DELTA = 100, 1000  # its incremental_update
# the segment reduction alone: (case, rows, groups, int64 columns, float64 columns,
# index). The float64 sums at groupby_sum's shape and at the two ends; the int64 diffs
# at groupby_sum's (+1/-1) and wordcount's (+1) shapes; groupby_sum's own commit (index
# i % 1,024, an int64 count and the float64 sum of float(i) in one call); one of
# incremental_update's 2,000-row commits (1,000 groups of a retraction and an insert, a
# count and a float sum); a skewed float64 case (Zipf s = 1.1 over 65,536 groups, drawn
# again past the last group: two partition passes and both run classes)
SEGMENT_CASES = (
    ("float64_1024", N_REL, 1024, 0, 1, "uniform"),
    ("float64_8", N_REL, 8, 0, 1, "uniform"),
    ("float64_1M", N_REL, N_REL, 0, 1, "uniform"),
    ("int64_1024", N_REL, 1024, 1, 0, "uniform"),
    ("int64_4096", N_REL, 4096, 1, 0, "uniform"),
    ("commit_1024", N_REL, 1024, 1, 1, "groupby_sum"),
    ("commit_2000", 2 * INC_DELTA, INC_DELTA, 1, 1, "incremental_update"),
    ("zipf_65536", N_REL, 65_536, 0, 1, "zipf"),
)
DADD_ITERS = 1 << 20  # the calibration chain of dependent float64 adds
# the segment entry points a relational path's shapes launch (run_ends only follows a
# second partition pass, past 2,048 groups in a commit with a float column)
SEGMENT_PATH_KERNELS = ("int_sum", "radix_pass", "fold_runs")
PROFILED_CALLS = 5  # segment_reduce calls in each case's profiler window


def _relational_rows() -> dict:
    """bench_dataflow.py's rows, keyed as it keys them (the port's ``ref_scalar``)."""
    keys = [pw.ref_scalar(i) for i in range(N_REL)]
    lkeys = [pw.ref_scalar(("l", i)) for i in range(N_REL // 2)]
    rkeys = [pw.ref_scalar(("r", i)) for i in range(N_RIGHT)]
    return {
        "groupby": [(k, (i % 1024, float(i))) for i, k in enumerate(keys)],
        "words": [(k, (f"w{i % 4096}",)) for i, k in enumerate(keys)],
        "join_l": [(k, (i % N_RIGHT, float(i))) for i, k in enumerate(lkeys)],
        "join_r": [(k, (i, f"name{i}")) for i, k in enumerate(rkeys)],
        "multi_l": [(k, (i % 250, (i // 250) % 200, float(i))) for i, k in enumerate(lkeys)],
        "multi_r": [(k, (i % 250, i // 250, f"name{i}")) for i, k in enumerate(rkeys)],
    }


def _final_state(node) -> tuple:
    """A node's output state for a bit-for-bit comparison: its columnar output
    batches stacked and sorted by key bytes (float columns as int64 bits), or its row
    state with floats as their bits where the output is not columnar."""
    lag = node._state_lag
    if not node._state and lag and all(b.columns is not None and b.columns.diffs is None for b in lag):
        cols = Columns.concat([b.columns for b in lag]) if len(lag) > 1 else lag[0].columns
        if cols is not None:
            kb = np.ascontiguousarray(cols.kbytes())
            order = np.lexsort(kb.T[::-1])
            arrays = [c[order].view(np.int64) if c.dtype == np.float64 else c[order] for c in cols.cols]
            return "columns", kb[order], arrays
    bits = lambda v: np.float64(v).view(np.int64).item() if isinstance(v, float) else v  # noqa: E731
    return "rows", {int(k): tuple(map(bits, row)) for k, row in node.current.items()}


def _same_state(a: tuple, b: tuple) -> bool:
    if a[0] != b[0]:
        return False
    if a[0] == "rows":
        return a[1] == b[1]
    return np.array_equal(a[1], b[1]) and len(a[2]) == len(b[2]) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a[2], b[2])
    )


def _groupby_prepared(rows, reducers, n_in):
    """A groupby over an input session holding ``rows``, before its commit."""
    scope = Scope()
    sess = scope.input_session(n_in)
    node = scope.group_by_table(sess, by_cols=[0], reducers=reducers)
    sched = Scheduler(scope)
    for key, row in rows:
        sess.insert(key, row)
    return sched, node


def _groupby_once(rows, reducers, n_in):
    sched, node = _groupby_prepared(rows, reducers, n_in)
    t0 = time.perf_counter()
    sched.commit()
    return time.perf_counter() - t0, node


def _sum_count():
    return [(make_reducer(ReducerKind.SUM), [1]), (make_reducer(ReducerKind.COUNT), [])]


def _workload(name: str, rows: dict):
    """-> (rows the timed part moves, run() -> (seconds, output node))."""
    if name == "groupby_sum":
        return N_REL, lambda: _groupby_once(rows["groupby"], _sum_count(), 2)
    if name == "wordcount":
        return N_REL, lambda: _groupby_once(rows["words"], [(make_reducer(ReducerKind.COUNT), [])], 1)
    if name in ("join_inner", "join_multikey"):
        side = "join" if name == "join_inner" else "multi"
        nk = 1 if name == "join_inner" else 2

        def run():
            scope = Scope()
            left, right = scope.input_session(nk + 1), scope.input_session(nk + 1)
            node = scope.join_tables(left, right, list(range(nk)), list(range(nk)), kind="inner")
            sched = Scheduler(scope)
            for key, row in rows[f"{side}_l"]:
                left.insert(key, row)
            for key, row in rows[f"{side}_r"]:
                right.insert(key, row)
            t0 = time.perf_counter()
            sched.commit()
            return time.perf_counter() - t0, node

        return N_REL // 2 + N_RIGHT, run
    if name == "incremental_update":

        def run():
            scope = Scope()
            sess = scope.input_session(2)
            node = scope.group_by_table(sess, by_cols=[0], reducers=[(make_reducer(ReducerKind.SUM), [1])])
            sched = Scheduler(scope)
            data = rows["groupby"]
            for key, row in data:
                sess.insert(key, row)
            sched.commit()
            t = 0.0
            for c in range(INC_COMMITS):
                base = (c * INC_DELTA) % (N_REL - INC_DELTA)
                for i in range(base, base + INC_DELTA):
                    key, row = data[i]
                    sess.remove(key, row)
                    sess.insert(key, (row[0], row[1] + 1.0))
                t0 = time.perf_counter()
                sched.commit()
                t += time.perf_counter() - t0
            return t, node

        return INC_COMMITS * 2 * INC_DELTA, run
    raise KeyError(name)


def _with_env(env: dict, fn):
    """``fn()`` with the variables of ``env`` set (None: unset), restored after."""
    prior = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return fn()
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _with_device_ops(flag: str, fn):
    return _with_env({"PATHWAY_TPU_DEVICE_OPS": flag}, fn)


def _segment_bound_ms(n: int, groups: int, cols: int) -> float:
    """The byte bound of ``segment_reduce``: the group index read once (8 bytes a row),
    every weight column read once (8 bytes a row) and every sum written once (8 bytes a
    group)."""
    return (8 * n + 8 * n * cols + 8 * groups * cols) / HBM_BYTES_PER_S * 1e3


def _segment_launches() -> dict[str, int]:
    return {name: k.launches for name, k in sr.KERNELS.items()}


def _zero_segment_launches() -> None:
    for k in sr.KERNELS.values():
        k.launches = 0


def phase_relational(card: Card, rows: dict) -> dict:
    """bench_dataflow.py's workloads through the port's Scope and Scheduler, once on
    the host kernels (``PATHWAY_TPU_DEVICE_OPS=0``, the spec) and once on the card
    after a warm-up; the card's output state must be the host's bit for bit, and every
    batch must have taken the device route. Then the segment reduction alone against
    its plain version and ``index_add_``, the whole dispatch, and the matcher alone
    against the host matcher."""
    device_ops.configure()
    launches = dict.fromkeys(sr.KERNELS, 0)  # the timed card runs' launches only
    for name in ("groupby_sum", "wordcount", "join_inner", "join_multikey", "incremental_update"):
        n, run = _workload(name, rows)
        host_s, host_node = _with_device_ops("0", run)
        host_state = _final_state(host_node)
        check(host_node.routes["device"] == 0, f"{name}: host run took the card")
        del host_node
        _with_device_ops("1", run)  # warm-up
        device_ops.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_segment_launches()
        dev_s, dev_node = _with_device_ops("1", run)
        run_launches = _segment_launches()
        for k, v in run_launches.items():
            launches[k] += v
        peak = torch.cuda.max_memory_allocated()
        stats = device_ops.stats()
        routes = dict(dev_node.routes)
        same = _same_state(host_state, _final_state(dev_node))
        card.emit("relational", workload=name, rows=n, host_rows_per_s=n / host_s,
                  device_rows_per_s=n / dev_s, host_s=host_s, device_s=dev_s, routes=routes,
                  segment_launches=run_launches, hit_counts=stats["hit_counts"],
                  kernel_ns=stats["kernel_ns"], peak_device_mib=peak / 2**20,
                  bit_identical=same)
        check(same, f"{name}: the card's output state differs from the host spec")
        check(routes["device"] > 0 and routes["host"] == 0 and routes["rows"] == 0,
              f"{name}: routes {routes}")
        if name in ("groupby_sum", "incremental_update"):  # a count and a float sum
            check(all(run_launches[k] > 0 for k in SEGMENT_PATH_KERNELS),
                  f"{name}: segment launches {run_launches}")
        elif name == "wordcount":  # the count alone: the int path, no partition
            check(run_launches["int_sum"] > 0 and sum(run_launches.values()) == run_launches["int_sum"],
                  f"{name}: segment launches {run_launches}")
        del dev_node
    check(all(launches[k] > 0 for k in SEGMENT_PATH_KERNELS),
          f"the relational path left a segment kernel unlaunched: {launches}")

    profile_groupby(card, rows)
    gc.collect()
    kernel = segment_kernel_parity_and_time(card)
    matcher_alone(card)
    return {**kernel, "launches": sum(launches.values()), "launches_by_kernel": launches}


def profile_groupby(card: Card, rows: dict) -> None:
    """One device groupby_sum commit of 1M rows under the profiler: where the time
    goes between the host, the upload and the segment kernels."""
    sched, _node = _groupby_prepared(rows["groupby"], _sum_count(), 2)
    wall_ms, kernels, _ops = _profiled(lambda: _with_device_ops("1", sched.commit))
    busy = sum(ms for ms, _k, _c in kernels)
    card.emit("relational_profile", workload="groupby_sum", rows=N_REL, wall_ms=wall_ms,
              device_busy_ms=busy if kernels else "not measured",
              idle_share=1 - busy / wall_ms if kernels else "not measured",
              device_ms_by_kernel=[[k, ms, c] for ms, k, c in kernels[:12]])


def _segment_case(n: int, groups: int, ni: int, nf: int, index: str, gen):
    """-> (inverse, int64 [ni, n], float64 [nf, n]) on the host."""
    if index == "groupby_sum":  # bench_dataflow.py's rows: i % 1024, float(i), a +1 count
        inverse = np.arange(n, dtype=np.int64) % groups
        return inverse, np.ones((ni, n), np.int64), np.arange(n, dtype=np.float64)[None].repeat(nf, 0)
    if index == "incremental_update":  # its commit: each row retracted, then inserted + 1.0
        inverse = np.tile(np.arange(groups, dtype=np.int64), 2)
        diffs = np.repeat(np.array([-1, 1], np.int64), groups)[None].repeat(ni, 0)
        vals = np.arange(groups, dtype=np.float64)
        return inverse, diffs, (np.concatenate([vals, vals + 1.0]) * diffs[0])[None].repeat(nf, 0)
    if index == "zipf":
        inverse = _zipf_index(gen, n, groups, 1.1)
    else:
        inverse = gen.integers(0, groups, n)
    w_float = gen.standard_normal((nf, n)) * 10.0 ** gen.integers(-6, 7, (nf, n))
    # diffs: the +1/-1 of a retracting commit, or wordcount's +1s
    w_int = gen.choice(np.array([-1, 1], np.int64), (ni, n)) if groups == 1024 else np.ones((ni, n), np.int64)
    return inverse, w_int, w_float


def _zipf_index(gen, n: int, groups: int, s: float) -> np.ndarray:
    """Zipf(s) over ``[0, groups)``: a draw past the last group is drawn again, so group
    0 keeps its own share of the rows."""
    inverse = gen.zipf(s, n) - 1
    out = inverse >= groups
    while out.any():
        inverse[out] = gen.zipf(s, int(out.sum())) - 1
        out = inverse >= groups
    return inverse.astype(np.int64)


def _kernel_name(key: str) -> str:
    """A profiler key's function name with its template arguments, without the
    namespace and the parameter list."""
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", key)
    return m.group(1) if m else key[:48]


def _once_ms(fn):
    """(fn's result, its card time in ms), one call between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _busy_ms_per_call(fn) -> tuple[float | str, list[tuple[float, str, int]]]:
    """(the card's busy ms per call of ``fn`` over ``PROFILED_CALLS`` calls under the
    profiler, its kernels); a window in which the profiler sees no device event is
    profiled once more, and a second such window is "not measured"."""
    for _ in range(2):
        _wall, kernels, _ops = _profiled(lambda: [fn() for _ in range(PROFILED_CALLS)])
        if kernels:
            return sum(k_ms for k_ms, _k, _c in kernels) / PROFILED_CALLS, kernels
    return "not measured", []


def segment_kernel_parity_and_time(card: Card) -> dict:
    """``segment_reduce`` alone at each of ``SEGMENT_CASES``: bit for bit against its
    plain version on the card and against ``np.add.at`` / ``np.bincount``; its whole
    card time (the int path, the partition passes, the fold, every column of the call)
    against its byte bound and the chain floor (the longest run times ``t_dadd``, the
    latency of a dependent float64 add measured here); ``index_add_`` per column (timed
    only, on CUDA events and on the profiler's busy time as the kernel is: for int64 the
    same function, for float64 a yardstick in another order); and the whole dispatch on
    the host clock."""
    gen = np.random.default_rng(SEED)
    x = torch.tensor([0.0, 1.0], dtype=torch.float64).cuda()
    chain = sr.dadd_chain(x, DADD_ITERS)
    torch.cuda.synchronize()
    check(chain.item() == float(DADD_ITERS), f"dadd_chain gave {chain.item()}")
    t_dadd_ns = cuda_ms(lambda: sr.dadd_chain(x, DADD_ITERS), iters=3, warmup=1) * 1e6 / DADD_ITERS
    card.emit("dadd_latency", iters=DADD_ITERS, t_dadd_ns=t_dadd_ns)
    out: dict = {}
    worst = 0.0
    for case, n, groups, ni, nf, index in SEGMENT_CASES:
        inverse, w_int, w_float = _segment_case(n, groups, ni, nf, index, gen)
        host = np.zeros((ni + nf, groups), np.int64)
        for c in range(ni):
            np.add.at(host[c], inverse, w_int[c])
        for c in range(nf):
            host[ni + c] = np.bincount(inverse, weights=w_float[c], minlength=groups).view(np.int64)
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (inverse, w_int, w_float)]
        before = _segment_launches()
        got = sr.segment_reduce(*args, groups)
        torch.cuda.synchronize()
        stages = {k: v - before[k] for k, v in _segment_launches().items()}
        plain, plain_ms = _once_ms(lambda: sr.segment_reduce_reference(*args, groups))
        got_h, plain_h = got.cpu().numpy(), plain.cpu().numpy()
        bits_plain = np.array_equal(got_h, plain_h)
        bits_host = np.array_equal(got_h, host)
        as_values = lambda a: np.concatenate([a[:ni].astype(np.float64).ravel(), a[ni:].view(np.float64).ravel()])  # noqa: E731
        with np.errstate(invalid="ignore"):
            err = float(np.nan_to_num(np.abs(as_values(got_h) - as_values(plain_h))).max())
        worst = max(worst, err)
        ms = cuda_ms(lambda: sr.segment_reduce(*args, groups), iters=20, warmup=2)
        # the card's own time by kernel (CUDA events above read the host's pace where
        # it enqueues more slowly than the card runs), and the host's time to enqueue
        device_busy_ms, kernels = _busy_ms_per_call(lambda: sr.segment_reduce(*args, groups))
        by_kernel = [[_kernel_name(k), k_ms / PROFILED_CALLS, c // PROFILED_CALLS]
                     for k_ms, k, c in kernels]
        t0 = time.perf_counter()
        for _ in range(20):
            sr.segment_reduce(*args, groups)
        host_enqueue_ms = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        inv_d = args[0]
        columns = [*args[1], *args[2]]
        def library():
            return [torch.zeros(groups, dtype=w.dtype, device=w.device).index_add_(0, inv_d, w)
                    for w in columns]

        library_ms = cuda_ms(library, iters=20, warmup=2)
        library_busy_ms, _lib_kernels = _busy_ms_per_call(library)
        longest = int(np.bincount(inverse, minlength=groups).max())
        chain_floor_ms = longest * t_dadd_ns * 1e-6 if nf else None
        bound_ms = _segment_bound_ms(n, groups, ni + nf)
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": library_ms, "library_busy_ms": library_busy_ms,
               "roofline_share": bound_ms / ms,
               "device_busy_ms": device_busy_ms, "busy_roofline_share": (bound_ms / device_busy_ms if kernels else "not measured"),
               "host_enqueue_ms": host_enqueue_ms, "device_ms_by_kernel": by_kernel,
               "chain_floor_ms": chain_floor_ms, "longest_run": longest,
               "passes": len(sr.radix_passes(groups)) if nf else 0, "stage_launches": stages}
        if nf == 0:
            check(sum(stages.values()) == stages["int_sum"] == 1, f"{case}: int-only launches {stages}")
        diffs = w_int[0] if ni else np.ones(n, np.int64)
        vals = [*w_int[1:], *w_float]
        device_ops.segment_reduce_dispatch(inverse, diffs, vals, groups).fetch()  # warm
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            device_ops.segment_reduce_dispatch(inverse, diffs, vals, groups).fetch()
        row["dispatch_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        hd.segment_count(inverse, diffs, groups)
        for col in vals:
            hd.segment_sum(inverse, col, diffs, groups)
        row["host_spec_ms"] = 1e3 * (time.perf_counter() - t0)
        card.emit("segment_kernel", case=case, rows=n, groups=groups, int_columns=ni,
                  float_columns=nf, index=index, max_abs_err=err, tol=0.0,
                  bits_equal_plain=bits_plain, bits_equal_host=bits_host,
                  host="np.add.at + np.bincount", library="index_add_ per column",
                  t_dadd_ns=t_dadd_ns, **row)
        check(bits_plain and bits_host, f"segment_reduce {case}: bits differ")
        out[case] = row
        del args, got, plain, inv_d, columns
    main = out["commit_1024"]
    return {
        "name": "segment_reduce",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "pathway_tpu/engine/device_ops.py:213",
        "max_abs_err": worst,
        **main,
        "t_dadd_ns": t_dadd_ns,
        "shapes": out,
    }


def matcher_alone(card: Card) -> None:
    """The device pair matcher at the join_inner shape against the host matcher: the
    whole call on the host clock (uploads and fetch included), and its on-card part
    (``_pairs_on_card`` over codes already on the card, one wait for the pair count
    included) between CUDA events, against its byte bound (la and ra read once, the
    pairs written once). No single PyTorch call computes the pair list."""
    la = np.arange(N_REL // 2, dtype=np.int64) % N_RIGHT
    ra = np.arange(N_RIGHT, dtype=np.int64)
    device_ops.match_pairs([la], [ra])  # warm
    t0 = time.perf_counter()
    got = device_ops.match_pairs([la], [ra])
    dev_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = _match_join_pairs(la, ra)
    host_ms = 1e3 * (time.perf_counter() - t0)
    same = np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    la_d, ra_d = torch.from_numpy(la).cuda(), torch.from_numpy(ra).cuda()
    card_ms = cuda_ms(lambda: device_ops._pairs_on_card(la_d, ra_d), iters=10, warmup=2)
    pairs = len(ref[0])
    bound_ms = (8 * (len(la) + len(ra)) + 16 * pairs) / HBM_BYTES_PER_S * 1e3
    card.emit("matcher", left=len(la), right=len(ra), pairs=pairs, device_ms=dev_ms,
              card_ms=card_ms, bound_ms=bound_ms, bound_by="bytes", roofline_share=bound_ms / card_ms,
              library_ms=None, host_ms=host_ms, pairs_equal=same)
    check(same, "device matcher pairs differ from the host matcher's")


class _KeptRunner:
    """Keeps the runner (a GraphRunner, or the ShardedGraphRunner of ``threads`` > 1) of
    the next ``pw.run``, to read its nodes' routes."""

    def __enter__(self):
        self.runners = []
        self._runs = {cls: cls.run for cls in (GraphRunner, ShardedGraphRunner,
                                               DistributedGraphRunner)}
        kept = self.runners

        for cls, orig in self._runs.items():
            def run(runner, *a, _orig=orig, **kw):
                kept.append(runner)
                return _orig(runner, *a, **kw)

            cls.run = run
        return self

    def __exit__(self, *exc):
        for cls, orig in self._runs.items():
            cls.run = orig


def _worker_scopes(runner) -> list:
    """The scopes of a kept runner: its workers' under ``threads`` > 1, else its own."""
    return [w.scope for w in runner.workers] if hasattr(runner, "workers") else [runner.scope]


def _relational_engine_run(threads: int = 1) -> dict:
    """One ``pw.run(threads=threads)`` of relational_engine's program (see
    :func:`phase_relational_engine`) under the environment as it stands: -> the
    subscriber's final state, NumPy's answer, the run's seconds, the kept runner, the
    nodes' routes (``w<worker>:`` before each name under ``threads`` > 1) and the
    segment kernels' launches."""

    class Feed(pw.io.python.ConnectorSubject):
        def __init__(self, keys, vals) -> None:
            super().__init__()
            self.keys, self.vals = keys, vals

        def run(self) -> None:
            # a pause every 25,000 rows lets the 50 ms autocommit cut the stream into
            # commits, so the groupby's later commits carry retractions
            for i, (k, v) in enumerate(zip(self.keys, self.vals)):
                self.next(k=k, v=v)
                if i % ENGINE_CHUNK == ENGINE_CHUNK - 1:
                    time.sleep(0.2)

    rng = np.random.default_rng(SEED)
    a_k = rng.integers(0, N_DIM + 64, N_ENGINE)  # 64 groups with no dimension row
    a_v = rng.integers(-4000, 4000, N_ENGINE) * 0.125
    b_k = rng.integers(0, N_DIM + 64, N_ENGINE // 4)
    b_v = rng.integers(-4000, 4000, N_ENGINE // 4) * 0.125
    min_count = int(np.median(np.bincount(a_k)))
    schema = pw.schema_from_types(k=int, v=float)
    a = pw.io.python.read(Feed(a_k.tolist(), a_v.tolist()), schema=schema, autocommit_duration_ms=50)
    b = pw.io.python.read(Feed(b_k.tolist(), b_v.tolist()), schema=schema, autocommit_duration_ms=50)
    dim = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str),
                                   [(i, f"d{i}") for i in range(N_DIM)])
    g = a.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
    j = g.join_left(dim, pw.left.k == pw.right.k).select(pw.left.k, pw.left.s, pw.left.c,
                                                         name=pw.right.name)
    f = j.filter(pw.this.c >= min_count)
    bj = b.join_inner(dim, pw.left.k == pw.right.k).select(pw.left.k, s=pw.left.v, c=1,
                                                           name=pw.right.name)
    out = f.concat_reindex(bj)
    state: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            state[key] = (row["k"], row["s"], row["c"], row["name"])
        else:
            state.pop(key, None)

    pw.io.subscribe(out, on_change=on_change)
    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    _zero_segment_launches()
    with _KeptRunner() as kept:
        t0 = time.perf_counter()
        pw.run(threads=threads)
        run_s = time.perf_counter() - t0
    by_kernel = _segment_launches()
    runner = kept.runners[0]
    scopes = _worker_scopes(runner)
    routes = {(f"w{w}:" if threads > 1 else "") + type(n).__name__ + f"#{n.index}": dict(n.routes)
              for w, scope in enumerate(scopes) for n in scope.nodes if hasattr(n, "routes")}
    counts = np.bincount(a_k, minlength=N_DIM + 64)
    sums = np.bincount(a_k, weights=a_v, minlength=N_DIM + 64)
    want = [
        (k, float(sums[k]), int(counts[k]), f"d{k}" if k < N_DIM else None)
        for k in range(N_DIM + 64) if counts[k] >= min_count
    ] + [(int(k), float(v), 1, f"d{k}") for k, v in zip(b_k, b_v) if k < N_DIM]
    bits = lambda r: (r[0], np.float64(r[1]).view(np.int64).item(), r[2], r[3])  # noqa: E731
    return {"out": sorted(map(bits, state.values()), key=repr),
            "want": sorted(map(bits, want), key=repr), "run_s": run_s, "runner": runner,
            "routes": routes, "by_kernel": by_kernel, "rows": N_ENGINE * 5 // 4}


def phase_relational_engine(card: Card) -> tuple[int, list, float]:
    """One ``pw.run`` program through the Table API at device_ops_leg's size: a python
    connector (200,000 rows) into a groupby (sum and count), a left join with a
    1,024-row dimension table from ``pw.debug.table_from_rows``, a filter, and a
    concat_reindex with a second stream (50,000 rows) joined inner to the same
    dimension table; the subscriber's final state must equal a NumPy computation of
    the same answer, and the groupby must have reduced more than one commit on the
    card. The values are multiples of 1/8 well inside float64's exact range,
    so every sum is exact and the answer does not depend on how the stream splits into
    commits. The device operators are forced (``PATHWAY_TPU_DEVICE_OPS=1``): in auto
    mode the placement policy sends some batches to the host kernels (the optimizer
    phase runs the program in every mode)."""
    torch.cuda.reset_peak_memory_stats()
    res = _with_device_ops("1", _relational_engine_run)
    by_kernel, routes = res["by_kernel"], res["routes"]
    launches = sum(by_kernel.values())
    same = res["out"] == res["want"]
    card.emit("relational_engine", rows=N_ENGINE, second_stream=N_ENGINE // 4, dim_rows=N_DIM,
              out_rows=len(res["out"]), expected_rows=len(res["want"]),
              rows_per_s=res["rows"] / res["run_s"], run_s=res["run_s"], routes=routes,
              segment_launches=by_kernel, hit_counts=device_ops.hit_counts(),
              peak_device_mib=torch.cuda.max_memory_allocated() / 2**20, equals_numpy=same)
    check(same, "relational_engine: the subscriber's state differs from NumPy's answer")
    groupbys = [r for name, r in routes.items() if name.startswith("GroupbyNode")]
    joins = [r for name, r in routes.items() if name.startswith("JoinNode")]
    check(len(groupbys) == 1 and groupbys[0]["device"] > 1 and groupbys[0]["host"] == 0
          and groupbys[0]["rows"] == 0, f"groupby routes {groupbys}")
    # the inner join's matcher took the card; the left join takes the row path, as it
    # does in the JAX package (its columnar path is inner-only)
    check(any(r["device"] > 0 for r in joins) and all(r["host"] == 0 for r in joins),
          f"join routes {joins}")
    check(all(by_kernel[k] > 0 for k in SEGMENT_PATH_KERNELS),
          f"relational_engine left a segment kernel unlaunched: {by_kernel}")
    return launches, res["out"], res["rows"] / res["run_s"]


# -- workers in one process: pw.run(threads=N) -------------------------------------------

SHARDED_THREADS = (2, 4)  # (a)'s worker counts
SHARDED_RAG_DOCS = 4096  # (b): BASELINE #1's RAG cut in depth only
SHARDED_RAG_QUERIES = 32
SHARDED_WC_FILES = 10  # (c): the word count's files; half before the stop, half after
SHARDED_WC_LINES = 10_000


def _exchange_since(mark: dict) -> dict:
    """The exchange counters' movement since ``mark``, by plane; checks the invariant
    ``elided + host + collective == repartitions`` and that no collective ran."""
    d = {k: EXCHANGE_STATS[k] - mark[k] for k in ("elided", "host_deliveries",
                                                   "collective_deliveries", "repartitions")}
    check(d["elided"] + d["host_deliveries"] + d["collective_deliveries"] == d["repartitions"],
          f"sharded: the exchange's planes do not add up: {d}")
    check(d["collective_deliveries"] == 0 and d["repartitions"] > 0, f"sharded: exchange {d}")
    return d


class _WorkerLaunches:
    """Counts the forward kernel's launches made inside each worker's operators during
    the next sharded run (every node's ``process`` wrapped per worker)."""

    def __enter__(self):
        self.by_worker: list[int] = []
        self._init = ShardedScheduler.__init__
        counts = self.by_worker

        def init(sched, scopes, *a, _orig=self._init, **kw):
            _orig(sched, scopes, *a, **kw)
            counts[:] = [0] * len(sched.scopes)
            for w, scope in enumerate(sched.scopes):
                for node in scope.nodes:
                    process = node.process

                    def counted(time_, _process=process, _w=w):
                        before = fa.KERNEL.launches
                        try:
                            return _process(time_)
                        finally:
                            counts[_w] += fa.KERNEL.launches - before

                    node.process = counted

        ShardedScheduler.__init__ = init
        return self

    def __exit__(self, *exc):
        ShardedScheduler.__init__ = self._init


class _AllKnnFactory(_KeptKnnFactory):
    """Keeps every index it builds: a sharded run builds one, on worker 0, where the
    index operator is pinned (the replicas build none, so hold none on the card)."""

    def build(self) -> DeviceKnnIndex:
        index = super().build()
        self.all = getattr(self, "all", []) + [index]
        return index


def _sharded_relational(card: Card, base_out: list, base_rows_per_s: float) -> int:
    """(a): relational_engine's program at 2 and 4 workers."""
    launches = 0
    for threads in SHARDED_THREADS:
        mark = dict(EXCHANGE_STATS)
        res = _with_device_ops("1", lambda: _relational_engine_run(threads))
        planes = _exchange_since(mark)
        by_kernel, routes = res["by_kernel"], res["routes"]
        launches += sum(by_kernel.values())
        groupbys = {name: r for name, r in routes.items() if "GroupbyNode" in name}
        rows_per_s = res["rows"] / res["run_s"]
        card.emit("sharded_relational", threads=threads, rows=N_ENGINE,
                  second_stream=N_ENGINE // 4, out_rows=len(res["out"]),
                  rows_per_s=rows_per_s, threads_1_rows_per_s=base_rows_per_s,
                  over_threads_1=rows_per_s / base_rows_per_s, run_s=res["run_s"],
                  segment_launches=by_kernel, exchange=planes, groupby_routes=groupbys,
                  routes=routes)
        check(res["out"] == res["want"],
              f"sharded ({threads}): the subscriber's state differs from NumPy's answer")
        check(res["out"] == base_out, f"sharded ({threads}): not the threads=1 run's bits")
        check(len(groupbys) == threads and all(
            r["device"] >= 1 and r["host"] == 0 and r["rows"] == 0 for r in groupbys.values()),
            f"sharded ({threads}): groupby routes {groupbys}")
        check(all(by_kernel[k] > 0 for k in SEGMENT_PATH_KERNELS),
              f"sharded ({threads}) left a segment kernel unlaunched: {by_kernel}")
    return launches


def _sharded_rag(card: Card) -> int:
    """(b): BASELINE #1's RAG through ``pw.run(threads=2)``."""
    corpus = [doc_text(i) for i in range(SHARDED_RAG_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _AllKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, _run = _engine_program(embedder, corpus, SHARDED_RAG_DOCS, SHARDED_RAG_QUERIES,
                                factory, wait_s=300.0)
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    mark = dict(EXCHANGE_STATS)
    with _WorkerLaunches() as per_worker:
        t0 = time.perf_counter()
        pw.run(threads=2)
        run_s = time.perf_counter() - t0
    planes = _exchange_since(mark)
    launches = fa.KERNEL.launches
    index = factory.all[0]
    recall, self_hit = _engine_recall(obs)
    key_of = {doc_id: key for key, (doc_id, _e) in obs["docs"].items()}
    top1 = [hits[:1] == (key_of.get(q * 37 % N_DOCS),) for q, (hits, _v) in obs["answers"].items()]
    ingest_s = obs["ingest_end"] - obs["run_start"]
    card.emit("sharded_rag", threads=2,
              model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded, bf16)",
              n_docs=len(obs["docs"]), n_queries=len(obs["answers"]), capacity=index.capacity,
              answer_events=sum(obs["answer_events"].values()), top1_own_doc=sum(top1),
              recall_at_10=recall, docs_per_s=SHARDED_RAG_DOCS / ingest_s if ingest_s > 0 else None,
              run_s=run_s, flash_launches=launches, flash_launches_by_worker=per_worker.by_worker,
              embed_calls=embed_calls[0], indexes_built=len(factory.all),
              index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
              exchange=planes, failures=obs["failures"])
    check(not obs["failures"] and not obs["timeouts"], f"sharded rag: {obs['failures']}")
    check(len(factory.all) == 1, f"sharded rag: {len(factory.all)} indexes built")
    check(len(obs["docs"]) == SHARDED_RAG_DOCS, f"sharded rag: {len(obs['docs'])} docs arrived")
    check(index.rows_device == SHARDED_RAG_DOCS and index.rows_host == 0,
          f"sharded rag: index routes {index.rows_device} device, {index.rows_host} host")
    check(sorted(obs["answer_events"]) == list(range(SHARDED_RAG_QUERIES))
          and all(v == 1 for v in obs["answer_events"].values()),
          f"sharded rag: answers {obs['answer_events']}")
    check(len(top1) == SHARDED_RAG_QUERIES and all(top1),
          f"sharded rag: {sum(top1)} of {SHARDED_RAG_QUERIES} own docs at top-1")
    check(recall >= 0.99, f"sharded rag: recall@10 {recall}")
    check(launches == LAYERS * embed_calls[0] and sum(per_worker.by_worker) == launches
          and all(n > 0 for n in per_worker.by_worker),
          f"sharded rag: forward launches {per_worker.by_worker} (total {launches}, "
          f"{embed_calls[0]} embed calls)")
    del factory, index, embedder
    return launches


def _sharded_wordcount(card: Card) -> int:
    """(c): the persistence tutorial's word count under operator snapshots at 2 workers,
    stopped at half its files and resumed at 4, which re-shards the snapshot."""
    ids = np.random.default_rng(SEED).integers(0, PERSIST_WC_KEYS,
                                               SHARDED_WC_FILES * SHARDED_WC_LINES)
    words, counts = np.unique(ids, return_counts=True)
    want = {f"w{w}": int(c) for w, c in zip(words.tolist(), counts.tolist())}
    root = tempfile.mkdtemp(prefix="pw-sharded-")
    indir, store = os.path.join(root, "in"), os.path.join(root, "store")
    os.makedirs(indir)
    launches, legs, state = 0, [], {}
    try:
        for leg, (threads, files) in enumerate(((2, range(0, SHARDED_WC_FILES // 2)),
                                                (4, range(SHARDED_WC_FILES // 2, SHARDED_WC_FILES)))):
            for f in files:
                with open(os.path.join(indir, f"words{f:03d}.txt"), "w") as fh:
                    part = ids[f * SHARDED_WC_LINES:(f + 1) * SHARDED_WC_LINES].tolist()
                    fh.write("".join(f"w{x}\n" for x in part))
            out_csv = os.path.join(root, f"out{leg}.csv")
            lines = pw.io.plaintext.read(indir, mode="static", persistent_id="w")
            cnt = lines.groupby(lines.data).reduce(word=lines.data, cnt=pw.reducers.count())
            pw.io.csv.write(cnt, out_csv)
            _zero_segment_launches()
            mark = dict(EXCHANGE_STATS)

            def run(threads=threads):
                device_ops.configure()
                with _KeptRunner() as kept:
                    t0 = time.perf_counter()
                    pw.run(threads=threads, persistence_config=_persist_config(
                        store, "OPERATOR_PERSISTING", 0))
                return kept.runners[0], time.perf_counter() - t0

            runner, run_s = _with_device_ops("1", run)
            planes = _exchange_since(mark)
            by_kernel = _segment_launches()
            launches += sum(by_kernel.values())
            routes = [dict(n.routes) for sc in _worker_scopes(runner) for n in sc.nodes
                      if type(n).__name__ == "GroupbyNode"]
            state.update(_fold_csv(out_csv))
            mgr = runner.snapshot_manager
            legs.append({"threads": threads, "run_s": run_s, "routes": routes,
                         "segment_launches": by_kernel, "exchange": planes,
                         "restore_bytes": mgr.restore_bytes, "restore_s": mgr.restore_seconds,
                         "snapshot_bytes": mgr.write_bytes[-1] if mgr.write_bytes else None})
            check(len(routes) == threads and all(
                r["device"] >= 1 and r["host"] == 0 and r["rows"] == 0 for r in routes),
                f"sharded wordcount ({threads}): groupby routes {routes}")
        card.emit("sharded_wordcount", words=int(len(ids)), keys=PERSIST_WC_KEYS,
                  files=SHARDED_WC_FILES, legs=legs, distinct=len(state))
        check(legs[0]["restore_bytes"] == 0 and legs[1]["restore_bytes"] > 0,
              f"sharded wordcount: restores {[leg['restore_bytes'] for leg in legs]}")
        check(state == want, "sharded wordcount: the counts differ from np.unique's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_sharded(card: Card, base_out: list, base_rows_per_s: float) -> dict:
    """Workers in one process through ``pw.run(threads=N)``: (a) relational_engine's
    program at 2 and 4 workers, its state NumPy's answer and the ``threads=1`` run's
    bits, every worker's groupby on the card; (b) BASELINE #1's RAG at 2 workers, each
    worker's embedder launching the forward kernel on its shard, the index (pinned to
    worker 0) filled by the device route; (c) the word count under operator snapshots,
    stopped at half at 2 workers and resumed at 4 (the snapshot re-sharded). The
    exchange's planes are reported per run, with no collective delivery (the device
    plane comes with ROADMAP queue 1 item 14's slice c)."""
    t0 = time.perf_counter()
    segment = _sharded_relational(card, base_out, base_rows_per_s)
    flash = _sharded_rag(card)
    segment += _sharded_wordcount(card)
    card.emit("sharded", seconds=time.perf_counter() - t0, segment_launches=segment,
              flash_launches=flash)
    return {"segment": segment, "flash": flash}


# -- workers in several processes: the TCP mesh ------------------------------------------

PROC_WAIT_S = 420.0  # one mesh's deadline: past it every child exits and the phase fails
PROC_RAG_DOCS = SHARDED_RAG_DOCS  # (b): the sharded phase's cut
PROC_RAG_QUERIES = SHARDED_RAG_QUERIES
PROC_WC_FILES = SHARDED_WC_FILES  # (c): 100,000 words in 10 files, one file a commit
PROC_WC_LINES = SHARDED_WC_LINES
PROC_KILL_AT_COMMIT = 3  # the fault plan kills process 1 after this commit's snapshot
PROC_RESCALE_AFTER = 2  # the rescale 2 -> 3 is asked once this file reached the sink
#: the script a mesh's processes run (``--processes-child``): this one
PROC_CHILD_SCRIPT = os.path.abspath(__file__)
_PROC_TOPOLOGY = ("PATHWAY_THREADS", "PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID",
                  "PATHWAY_FIRST_PORT", "PATHWAY_TPU_FAULT_PLAN", "PATHWAY_TPU_RECOVER",
                  "PATHWAY_TPU_SUPERVISOR_DIR", "PATHWAY_TPU_RESHARD", "PATHWAY_RUN_ID")


#: port ranges this script handed to meshes (several meshes start before any binds)
_PORTS_TAKEN: set[int] = set()


def _free_port_base(n: int) -> int:
    """A base port such that base..base+n-1 are bindable now and not handed out before."""
    for _ in range(64):
        base = _free_port()
        if base + n >= 65535 or _PORTS_TAKEN & set(range(base, base + n)):
            continue
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            _PORTS_TAKEN.update(range(base, base + n))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def _count_sent_bytes() -> list[int]:
    """Count the bytes this process writes to sockets from now on (the mesh's frames:
    the programs here open no other socket)."""
    sent = [0]
    sendall = socket.socket.sendall

    def counted(sock, data, *a):
        sent[0] += len(data)
        return sendall(sock, data, *a)

    socket.socket.sendall = counted
    return sent


def _process_started_at() -> float:
    """This process's start on the wall clock (``/proc/self/stat``'s start time after
    boot plus ``/proc/stat``'s boot time)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as fh:
        btime = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def _proc_relational_stage(threads: int):
    def stage(pid: int, args: list[str]) -> dict:
        res = _relational_engine_run(threads)
        rep = {"routes": res["routes"], "rows": res["rows"], "run_s": res["run_s"]}
        if pid == 0:
            rep.update(out=res["out"], want=res["want"])
        return rep

    return stage


def _proc_rag_stage(pid: int, args: list[str]) -> dict:
    corpus = [doc_text(i) for i in range(PROC_RAG_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, sizes = _count_embed_calls(embedder)
    factory = _AllKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, PROC_RAG_DOCS, PROC_RAG_QUERIES, factory,
                               wait_s=300.0)
    device_pipeline.PIPELINE.configure()
    t0 = time.perf_counter()
    run()
    rep = {"run_s": time.perf_counter() - t0, "embed_calls": embed_calls[0],
           "texts_embedded": sum(sizes), "indexes_built": len(getattr(factory, "all", []))}
    if pid == 0:
        index = factory.all[0]
        recall, _self_hit = _engine_recall(obs)
        key_of = {doc_id: key for key, (doc_id, _e) in obs["docs"].items()}
        top1 = [hits[:1] == (key_of.get(q * 37 % N_DOCS),)
                for q, (hits, _v) in obs["answers"].items()]
        ingest_s = obs["ingest_end"] - obs["run_start"]
        rep.update(n_docs=len(obs["docs"]), n_queries=len(obs["answers"]),
                   answer_events=dict(obs["answer_events"]), top1_own_doc=sum(top1),
                   recall_at_10=recall, docs_per_s=PROC_RAG_DOCS / ingest_s if ingest_s > 0 else None,
                   capacity=index.capacity, index_rows_device=index.rows_device,
                   index_rows_host=index.rows_host, failures=obs["failures"] + [
                       f"query {q} timed out" for q in obs["timeouts"]])
    return rep


def _proc_wordcount_stage(pid: int, args: list[str]) -> dict:
    indir, store, out_csv, stop = args
    from pathway_tpu_torch.engine import connectors as _conn

    orig = _conn.FsReader.poll

    def paced(self):
        entries, done = orig(self)
        if not entries and os.path.exists(stop):
            done = True
        return entries, done

    _conn.FsReader.poll = paced
    try:
        lines = pw.io.plaintext.read(indir, mode="streaming", persistent_id="w",
                                     autocommit_duration_ms=PERSIST_AUTOCOMMIT_MS)
        cnt = lines.groupby(lines.data).reduce(word=lines.data, cnt=pw.reducers.count())
        pw.io.csv.write(cnt, out_csv)
        with _KeptRunner() as kept:
            t0 = time.perf_counter()
            pw.run(persistence_config=_persist_config(store, "OPERATOR_PERSISTING", 0))
            run_s = time.perf_counter() - t0
    finally:
        _conn.FsReader.poll = orig
    rep = {"run_s": run_s}
    if kept.runners and hasattr(kept.runners[0], "workers"):
        rep["groupby_routes"] = [dict(n.routes) for sc in _worker_scopes(kept.runners[0])
                                 for n in sc.nodes if type(n).__name__ == "GroupbyNode"]
    if pid == 0 and not os.environ.get("PATHWAY_TPU_RESHARD"):
        rep["metrics"] = pmetrics.render_snapshots({"": pmetrics.full_snapshot()})
        rep["flight"] = [e for e in pmetrics.FLIGHT.snapshot()
                         if e.get("kind") in ("recovery_done", "peer_dead", "quiesce")]
    return rep


_PROC_STAGES = {"relational1": _proc_relational_stage(1), "relational2": _proc_relational_stage(2),
                "rag": _proc_rag_stage, "wordcount": _proc_wordcount_stage}


def _processes_child(args: list[str]) -> int:
    """One process of a mesh the processes phase spawned (``chip_smoke.py
    --processes-child <outdir> <stage,...> [the word count's paths]``): runs each
    stage's program through ``pw.run`` in turn (the topology comes from ``cli spawn``'s
    environment; each ``pw.run`` builds its own mesh) and writes its own counts, read in
    this process after the stage, to ``<outdir>/report-<stage>-p<id>.json``: the segment
    and forward kernels' launches, the exchange's deliveries by plane, the bytes it
    wrote to the mesh, the device its operators ran on, and its clock."""
    outdir, stages = args[0], args[1].split(",")
    main_at = time.time()
    pid = int(os.environ["PATHWAY_PROCESS_ID"])
    who = "reshard" if os.environ.get("PATHWAY_TPU_RESHARD") else f"p{pid}"
    log = os.path.join(outdir, f"child-{who}-{os.environ.get('PATHWAY_TPU_RESTART_COUNT', '0')}"
                               f"-{os.getpid()}.log")
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    if who != "reshard":  # the supervisor reads the re-shard helper's report on its stdout
        os.dup2(fd, 1)
    os.dup2(fd, 2)
    _child_watchdog(outdir)
    go = os.environ.get("CHIP_SMOKE_GO")
    while go and not os.path.exists(go):  # a mesh started ahead waits for its release
        time.sleep(0.05)
    sent = _count_sent_bytes()
    for stage in stages:
        _zero_segment_launches()
        fa.KERNEL.launches = 0
        mark, sent0, start_at = dict(EXCHANGE_STATS), sent[0], time.time()
        rep = _PROC_STAGES[stage](pid, args[2:])
        rep.update(process=pid, threads=int(os.environ.get("PATHWAY_THREADS", "1")),
                   incarnation=int(os.environ.get("PATHWAY_TPU_RESTART_COUNT", "0")),
                   process_started_at=_process_started_at(), main_at=main_at,
                   stage_start_at=start_at, stage_end_at=time.time(),
                   segment_launches=_segment_launches(), flash_launches=fa.KERNEL.launches,
                   bytes_sent=sent[0] - sent0, device=str(device_ops.device()),
                   exchange={k: EXCHANGE_STATS[k] - mark[k] for k in EXCHANGE_STATS})
        path = os.path.join(outdir, f"report-{stage}-{who}.json")
        with open(path + ".tmp", "w") as fh:
            json.dump(rep, fh)
        os.replace(path + ".tmp", path)
    return 0


class _ProcMesh:
    """``pathway_tpu_torch.cli.spawn`` (the function behind ``python -m
    pathway_tpu_torch.cli spawn``; called here, the launcher pays no import of its own)
    of this script's ``--processes-child`` on a thread. Every child watches the mesh's
    deadline (``CHIP_SMOKE_MESH_DEADLINE``, absolute) and ``<outdir>/abort``, and exits
    124 at either; its output goes to ``<outdir>/child-<id>-<incarnation>.log``."""

    def __init__(self, outdir: str, stages: str, processes: int, env: dict | None = None,
                 args: tuple = (), port_span: int | None = None):
        from pathway_tpu_torch.cli import spawn

        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        base = dict(os.environ)
        for name in _PROC_TOPOLOGY:
            base.pop(name, None)
        self.spawned_at = time.time()
        self.t0 = time.perf_counter()
        # the operators on the card for every batch, as the relational_engine phase runs
        base.update(PATHWAY_TPU_DEVICE_OPS="1", PATHWAY_TPU_MESH_TIMEOUT="120",
                    PATHWAY_TPU_RECOVER_DEADLINE="120",
                    CHIP_SMOKE_MESH_DEADLINE=str(self.spawned_at + PROC_WAIT_S), **(env or {}))
        self.rc: list = []
        self.thread = threading.Thread(
            target=lambda: self.rc.append(spawn(
                sys.executable, [PROC_CHILD_SCRIPT, "--processes-child", outdir, stages, *args],
                processes=processes,
                first_port=_free_port_base(port_span or processes), env=base)),
            name="chip-smoke-mesh", daemon=True)
        self.thread.start()

    def alive(self) -> bool:
        return self.thread.is_alive()

    def remaining(self) -> float:
        return PROC_WAIT_S - (time.perf_counter() - self.t0)

    def kill(self) -> None:
        """Make every child exit now (its watchdog sees the abort file) and wait for
        the launcher."""
        open(os.path.join(self.outdir, "abort"), "w").close()
        self.thread.join(timeout=60)

    def tail(self) -> str:
        out = []
        for name in sorted(os.listdir(self.outdir)):
            if name.startswith("child-"):
                with open(os.path.join(self.outdir, name), "rb") as fh:
                    out.append(f"--- {name}\n" + fh.read()[-1500:].decode(errors="replace"))
        return "\n".join(out)

    def wait(self, what: str) -> float:
        """Wait for the mesh's end; -> its seconds. A non-zero exit or the deadline
        fails the phase (the children exit at the deadline by themselves)."""
        self.thread.join(timeout=max(0.1, self.remaining()) + 60)
        self.done_at = time.time()
        check(not self.thread.is_alive() and self.rc == [0],
              f"processes {what}: the mesh exited {self.rc}:\n{self.tail()}")
        return time.perf_counter() - self.t0

    def reports(self, stage: str, n: int) -> list[dict]:
        out = []
        for p in range(n):
            with open(os.path.join(self.outdir, f"report-{stage}-p{p}.json")) as fh:
                out.append(json.load(fh))
        return out

    def clock(self, first: list[dict], last: list[dict]) -> dict:
        """Where a mesh's wall went, from the processes' own stamps (``first``: the
        first stage's reports, ``last``: the last's): each process's start after the
        spawn, its imports (start to ``--processes-child``), its first stage's start,
        and the mesh's end after the last report."""
        return {f"p{r['process']}": {
            "started_s": r["process_started_at"] - self.spawned_at,
            "imports_s": r["main_at"] - r["process_started_at"],
            "first_stage_s": r["stage_start_at"] - self.spawned_at} for r in first} | {
            "exit_after_last_report_s": self.done_at - max(r["stage_end_at"] for r in last)}


def _child_watchdog(outdir: str) -> None:
    """Exit this process (124) once the mesh's deadline passed or the phase asked every
    child to stop, so no process of a failed mesh outlives the phase."""
    deadline = float(os.environ.get("CHIP_SMOKE_MESH_DEADLINE", "inf"))
    abort = os.path.join(outdir, "abort")

    def watch() -> None:
        while time.time() < deadline and not os.path.exists(abort):
            time.sleep(0.2)
        print("chip_smoke: mesh deadline or abort: exiting 124", flush=True)
        os._exit(124)

    threading.Thread(target=watch, name="chip-smoke-watchdog", daemon=True).start()


def _proc_planes(reports: list[dict]) -> dict:
    """The mesh's deliveries by plane, per process: PWCF frames sent and received,
    pickled row batches sent, the host deliveries, elided edges, the bytes written; no
    collective delivery (slice c)."""
    planes = {}
    for r in reports:
        ex = r["exchange"]
        check(ex["elided"] + ex["host_deliveries"] + ex["collective_deliveries"]
              == ex["repartitions"] and ex["collective_deliveries"] == 0,
              f"processes: process {r['process']}'s planes {ex}")
        planes[f"p{r['process']}"] = {
            "pwcf_frames_sent": ex["columnar_frames_sent"],
            "pwcf_frames_received": ex["columnar_frames_received"],
            "pickled_row_batches_sent": ex["row_batches_sent"],
            "host_deliveries": ex["host_deliveries"], "elided": ex["elided"],
            "collective_deliveries": ex["collective_deliveries"], "bytes_sent": r["bytes_sent"]}
    return planes


def _processes_relational(card: Card, mesh: _ProcMesh, base_out: list,
                          base_rows_per_s: float) -> int:
    """(a): relational_engine's program at 2 x 1 and 2 x 2."""
    launches = 0
    for threads in (1, 2):
        reps = mesh.reports(f"relational{threads}", 2)
        out = [tuple(r) for r in reps[0]["out"]]
        rows_per_s = reps[0]["rows"] / reps[0]["run_s"]
        launches += sum(sum(r["segment_launches"].values()) for r in reps)
        groupbys = {f"p{r['process']}:{name}": route for r in reps
                    for name, route in r["routes"].items() if "GroupbyNode" in name}
        card.emit("processes_relational", processes=2, threads=threads, rows=N_ENGINE,
                  second_stream=N_ENGINE // 4, out_rows=len(out), rows_per_s=rows_per_s,
                  threads_1_rows_per_s=base_rows_per_s,
                  over_threads_1=rows_per_s / base_rows_per_s, run_s=reps[0]["run_s"],
                  segment_launches={f"p{r['process']}": r["segment_launches"] for r in reps},
                  planes=_proc_planes(reps), groupby_routes=groupbys,
                  devices=[r["device"] for r in reps])
        check(out == [tuple(r) for r in reps[0]["want"]],
              f"processes 2 x {threads}: process 0's sink differs from NumPy's answer")
        check(out == base_out, f"processes 2 x {threads}: not the threads=1 run's bits")
        check(all(r["device"].startswith("cuda") for r in reps),
              f"processes 2 x {threads}: devices {[r['device'] for r in reps]}")
        check(len(groupbys) == 2 * threads and all(
            g["device"] >= 1 and g["host"] == 0 and g["rows"] == 0 for g in groupbys.values()),
            f"processes 2 x {threads}: groupby routes {groupbys}")
        for r in reps:
            check(all(r["segment_launches"][k] > 0 for k in SEGMENT_PATH_KERNELS),
                  f"processes 2 x {threads}: process {r['process']} left a segment kernel "
                  f"unlaunched: {r['segment_launches']}")
    return launches


def _processes_rag(card: Card, mesh: _ProcMesh) -> int:
    """(b): BASELINE #1's RAG at 2 processes."""
    reps = mesh.reports("rag", 2)
    lead = reps[0]
    flash = [r["flash_launches"] for r in reps]
    card.emit("processes_rag", processes=2,
              model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded, bf16)",
              n_docs=lead["n_docs"], n_queries=lead["n_queries"], capacity=lead["capacity"],
              answer_events=sum(lead["answer_events"].values()),
              top1_own_doc=lead["top1_own_doc"], recall_at_10=lead["recall_at_10"],
              docs_per_s=lead["docs_per_s"], run_s=lead["run_s"],
              flash_launches_by_process=flash,
              texts_embedded_by_process=[r["texts_embedded"] for r in reps],
              embed_calls_by_process=[r["embed_calls"] for r in reps],
              indexes_built_by_process=[r["indexes_built"] for r in reps],
              index_rows_device_route=lead["index_rows_device"],
              index_rows_host_route=lead["index_rows_host"], planes=_proc_planes(reps),
              failures=lead["failures"])
    check(not lead["failures"], f"processes rag: {lead['failures']}")
    check([r["indexes_built"] for r in reps] == [1, 0],
          f"processes rag: indexes built {[r['indexes_built'] for r in reps]}")
    check(lead["n_docs"] == PROC_RAG_DOCS, f"processes rag: {lead['n_docs']} docs arrived")
    check(lead["index_rows_device"] + lead["index_rows_host"] == PROC_RAG_DOCS,
          f"processes rag: the index took {lead['index_rows_device']} rows by the device "
          f"route and {lead['index_rows_host']} by the host route")
    check(sorted(int(q) for q in lead["answer_events"]) == list(range(PROC_RAG_QUERIES))
          and all(v == 1 for v in lead["answer_events"].values()),
          f"processes rag: answers {lead['answer_events']}")
    check(lead["top1_own_doc"] == PROC_RAG_QUERIES,
          f"processes rag: {lead['top1_own_doc']} of {PROC_RAG_QUERIES} own docs at top-1")
    check(lead["recall_at_10"] >= 0.99, f"processes rag: recall@10 {lead['recall_at_10']}")
    check(all(n > 0 for n in flash)
          and all(r["flash_launches"] == LAYERS * r["embed_calls"] for r in reps),
          f"processes rag: forward launches {flash}, embed calls "
          f"{[r['embed_calls'] for r in reps]}")
    return sum(flash)


def _proc_wc_files() -> tuple[list[list[str]], dict]:
    """The word count's files: 10,000 words each over 4,096 keys, and a marker word of
    its own per file that shows it reached the sink; -> (files, np.unique's counts)."""
    ids = np.random.default_rng(SEED).integers(0, PERSIST_WC_KEYS, PROC_WC_FILES * PROC_WC_LINES)
    files = [[f"w{x}" for x in ids[f * PROC_WC_LINES:(f + 1) * PROC_WC_LINES].tolist()]
             + [f"file{f}"] for f in range(PROC_WC_FILES)]
    words, counts = np.unique(np.array([w for f in files for w in f]), return_counts=True)
    return files, dict(zip(words.tolist(), counts.tolist()))


def _proc_wc_paths(root: str, tag: str, indir: str = "in") -> tuple:
    """(input dir, store, sink, stop file). Runs whose sinks are compared line for line
    read one input directory (``<root>/in``): a row's key hashes its file's path, and
    the key routes the row, so the partial counts a sink sees within a commit are the
    same only over one path."""
    base = os.path.join(root, tag)
    os.makedirs(base, exist_ok=True)
    return (os.path.join(root, indir), os.path.join(base, "store"),
            os.path.join(base, "out.csv"), os.path.join(base, "stop"))


def _proc_feed(runs: list, files: list, mid=None) -> None:
    """Feed the word-count runs (``(mesh, paths, tag)`` each, one input directory)
    one file a commit, in lockstep: file k goes in once file k-1's marker reached
    every run's sink, so every run cuts the same commits; ``mid=(k, fn)`` calls
    ``fn()`` once file k's marker arrived everywhere; then every run's stop file ends
    its stream."""
    indir = runs[0][1][0]
    shutil.rmtree(indir, ignore_errors=True)
    os.makedirs(indir)
    try:
        for k, words in enumerate(files):
            # written beside the input directory and moved in whole
            nxt = indir + ".next"
            with open(nxt, "w") as fh:
                fh.write("".join(f"{w}\n" for w in words))
            os.replace(nxt, os.path.join(indir, f"f{k:03d}.txt"))
            marker = f"\nfile{k},".encode()
            for mesh, paths, tag in runs:
                while not _has_marker(paths[2], marker):
                    check(mesh.alive() and mesh.remaining() > 0,
                          f"processes wordcount {tag}: file {k} never reached the sink:\n"
                          f"{mesh.tail()}")
                    time.sleep(0.02)
            if mid is not None and k == mid[0]:
                mid[1]()
        for _mesh, paths, _tag in runs:
            open(paths[3], "w").close()
    except BaseException:
        for mesh, _paths, _tag in runs:
            mesh.kill()
        raise


def _has_marker(path: str, marker: bytes) -> bool:
    try:
        with open(path, "rb") as fh:
            return marker in fh.read()
    except FileNotFoundError:
        return False


def _consolidated_sink(sink: bytes) -> list:
    """The sink's updates with each commit's own insert-and-retract pairs cancelled:
    (word, count, commit time) -> the sum of its diffs, the non-zero ones, sorted. A
    group whose rows reach it from several workers in one commit emits a partial count
    and retracts it in the same commit; which partials appear depends on the number of
    workers, the consolidated updates do not."""
    net: dict = collections.Counter()
    for line in sink.decode().splitlines()[1:]:
        word, cnt, t, diff = line.rsplit(",", 3)
        net[(word, int(cnt), int(t))] += int(diff)
    return sorted((k, d) for k, d in net.items() if d)


def _family(text: str, family: str) -> float:
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(family) and not line.startswith("#"))


def _processes_wordcount(card: Card, runs: dict) -> int:
    """(c)'s checks: ``runs`` maps fault_free, killed and rescaled to (mesh, paths)."""
    _files, want = _proc_wc_files()

    def sink_of(run) -> bytes:
        with open(run[1][2], "rb") as fh:
            return fh.read()

    canonical = sorted(sink_of(runs["fault_free"]).splitlines())
    consolidated = _consolidated_sink(sink_of(runs["fault_free"]))
    launches, legs = 0, {}
    for name, run in runs.items():
        mesh = run[0]
        sink = sink_of(run)
        reps = mesh.reports("wordcount", 3 if name == "rescaled" else 2)
        metrics = reps[0]["metrics"]
        legs[name] = {
            "processes": len(reps), "run_s": reps[0]["run_s"], "sink_lines": len(canonical),
            "canonical_equal": sorted(sink.splitlines()) == canonical,
            "consolidated_equal": _consolidated_sink(sink) == consolidated,
            "counts_equal_np_unique": _fold_csv(run[1][2]) == want,
            "recoveries": _family(metrics, "pathway_mesh_recoveries_total"),
            "rescales": _family(metrics, "pathway_mesh_rescales_total"),
            "rescale_s": _family(metrics, "pathway_mesh_rescale_seconds_sum"),
            "recover_s": [e.get("wall_s") for e in reps[0]["flight"]
                          if e["kind"] == "recovery_done"],
            "incarnations": [r["incarnation"] for r in reps],
            "segment_launches": {f"p{r['process']}": r["segment_launches"] for r in reps},
            "groupby_routes": {f"p{r['process']}": r.get("groupby_routes") for r in reps},
            "planes": _proc_planes(reps)}
        if name != "fault_free":
            legs[name]["mesh_wall_s"] = mesh.done_at - mesh.spawned_at
            legs[name]["clock"] = mesh.clock(reps, reps)
        launches += sum(sum(r["segment_launches"].values()) for r in reps)
    card.emit("processes_wordcount", words=PROC_WC_FILES * PROC_WC_LINES,
              keys=PERSIST_WC_KEYS, files=PROC_WC_FILES, kill_at_commit=PROC_KILL_AT_COMMIT,
              rescale_after_file=PROC_RESCALE_AFTER, legs=legs)
    for name, leg in legs.items():
        # at 2 processes throughout, the sorted lines are the fault-free run's; the
        # rescaled run's commits after the rescale run on 3 workers, whose partial counts
        # differ, so it is held to the consolidated updates
        check(leg["consolidated_equal"] and (leg["canonical_equal"] or name == "rescaled"),
              f"processes wordcount {name}: not the fault-free sink")
        check(leg["counts_equal_np_unique"], f"processes wordcount {name}: counts differ "
              "from np.unique's")
        for p, routes in leg["groupby_routes"].items():
            check(routes and all(r["device"] >= 1 and r["host"] == 0 and r["rows"] == 0
                                 for r in routes),
                  f"processes wordcount {name}: {p}'s groupby routes {routes}")
    # process 1 was restarted (a second restart happens when the leader's kill request
    # for the dead worker reaches the supervisor after its first restart, as in the
    # JAX package)
    check(legs["killed"]["recoveries"] >= 1 and legs["killed"]["incarnations"][0] == 0
          and legs["killed"]["incarnations"][1] >= 1,
          f"processes wordcount killed: recoveries {legs['killed']['recoveries']}, "
          f"incarnations {legs['killed']['incarnations']}")
    check(legs["rescaled"]["rescales"] >= 1,
          f"processes wordcount rescaled: rescales {legs['rescaled']['rescales']}")
    return launches


def phase_processes(card: Card, base_out: list, base_rows_per_s: float) -> dict:
    """Workers in several processes, each a fresh interpreter spawned by
    ``pathway_tpu_torch.cli.spawn`` with its own CUDA context on the card, the batches
    exchanged over the authenticated TCP mesh. A mesh of 2 processes runs, one
    ``pw.run`` after another: (a) relational_engine's program at 2 x 1 and 2 x 2,
    process 0's sink NumPy's answer and the ``threads=1`` run's bits, every process's
    groupby on the card by its own segment launches; (b) BASELINE #1's RAG, the index
    on process 0 only, both processes launching the forward kernel; (c) the word count
    under operator snapshots, fault-free. A second mesh runs (c) with process 1 killed
    at commit 3 and recovered under the supervisor: it starts with the first (its
    imports overlap the first's stages), waits until the first's word count starts,
    and the two take the same files in lockstep, so the killed run's sink is the
    fault-free run's line for line. A third mesh, rescaled 2 -> 3 through ``cli
    rescale`` at commit 3, runs from the start beside them on files of its own (its
    rows hash another path, so it is held to the fault-free sink's consolidated
    updates). Every process writes its own counts; nothing is inferred."""
    from pathway_tpu_torch.cli import rescale as cli_rescale

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="pw-processes-")
    meshes: list = []
    try:
        go = os.path.join(root, "go")
        sup_dir = os.path.join(root, "sup")
        paths = {"fault_free": _proc_wc_paths(root, "fault_free"),
                 "killed": _proc_wc_paths(root, "killed"),
                 "rescaled": _proc_wc_paths(root, "rescaled", indir="in-rescaled")}
        plan = json.dumps({"seed": SEED, "faults": [
            {"type": "kill", "process": 1, "at_commit": PROC_KILL_AT_COMMIT}]})
        files = _proc_wc_files()[0]
        meshes.append(_ProcMesh(os.path.join(root, "mesh"),
                                "relational1,relational2,rag,wordcount", 2,
                                args=paths["fault_free"]))
        meshes.append(_ProcMesh(os.path.join(root, "killed"), "wordcount", 2,
                                args=paths["killed"], env={
                                    "PATHWAY_TPU_RECOVER": "1", "PATHWAY_TPU_FAULT_PLAN": plan,
                                    "CHIP_SMOKE_GO": go}))
        meshes.append(_ProcMesh(os.path.join(root, "rescaled"), "wordcount", 2,
                                args=paths["rescaled"], port_span=3, env={
                                    "PATHWAY_TPU_RECOVER": "1",
                                    "PATHWAY_TPU_SUPERVISOR_DIR": sup_dir}))
        main, killed, rescaled = meshes

        def request() -> None:
            """Ask for the rescale and wait until the mesh runs at 3 (the supervisor
            took the request and removed its quiesce marker), so the later files reach
            the new mesh."""
            check(cli_rescale(3, supervisor_dir=sup_dir) == 0, "processes: cli rescale refused")
            while any(os.path.exists(os.path.join(sup_dir, f)) for f in ("rescale", "quiesce")):
                check(rescaled.alive() and rescaled.remaining() > 0,
                      "processes: the rescale never ended")
                time.sleep(0.02)

        feed_errors: list = []

        def feed_rescaled() -> None:
            try:
                _proc_feed([(rescaled, paths["rescaled"], "rescaled")], files,
                           mid=(PROC_RESCALE_AFTER, request))
            except BaseException as exc:  # noqa: BLE001 — raised on the phase's thread
                feed_errors.append(exc)

        feeder = threading.Thread(target=feed_rescaled, name="chip-smoke-feed", daemon=True)
        feeder.start()
        # the killed mesh starts its word count with the first mesh's, after the
        # relational and RAG stages
        while not os.path.exists(os.path.join(main.outdir, "report-rag-p0.json")):
            check(main.alive() and main.remaining() > 0,
                  f"processes: the first mesh ended early:\n{main.tail()}")
            time.sleep(0.05)
        open(go, "w").close()
        _proc_feed([(main, paths["fault_free"], "fault_free"), (killed, paths["killed"], "killed")],
                   files)
        feeder.join(timeout=max(0.1, rescaled.remaining()))
        if feed_errors:
            raise feed_errors[0]
        check(not feeder.is_alive(), "processes: the rescaled run's feed never ended")
        wall_s = main.wait("relational, rag and wordcount")
        killed.wait("wordcount killed")
        rescaled.wait("wordcount rescaled")
        card.emit("processes_mesh", stages="relational 2 x 1, relational 2 x 2, rag, wordcount",
                  wall_s=wall_s, clock=main.clock(main.reports("relational1", 2),
                                                  main.reports("wordcount", 2)),
                  stage_s={s: main.reports(s, 2)[0]["stage_end_at"]
                           - main.reports(s, 2)[0]["stage_start_at"]
                           for s in ("relational1", "relational2", "rag", "wordcount")})
        segment = _processes_relational(card, main, base_out, base_rows_per_s)
        flash = _processes_rag(card, main)
        segment += _processes_wordcount(card, {"fault_free": (main, paths["fault_free"]),
                                               "killed": (killed, paths["killed"]),
                                               "rescaled": (rescaled, paths["rescaled"])})
    finally:
        for mesh in meshes:
            if mesh.alive():
                mesh.kill()
        shutil.rmtree(root, ignore_errors=True)
    card.emit("processes", seconds=time.perf_counter() - t0, segment_launches=segment,
              flash_launches=flash)
    return {"segment": segment, "flash": flash}


# -- the graph optimizer and measurement-driven placement --------------------------------

#: optimizer_stats() of earlier phases' graphs, for the optimizer phase's report
OPTIMIZER_SEEN: dict = {}
#: (mode, its environment): the spec (no rewrite, host kernels), forced device operators,
#: and auto placement (the policy decides per batch)
OPT_MODES = (
    ("spec", {"PATHWAY_TPU_OPTIMIZE": "0", "PATHWAY_TPU_DEVICE_OPS": "0"}),
    ("forced", {"PATHWAY_TPU_OPTIMIZE": "1", "PATHWAY_TPU_DEVICE_OPS": "1"}),
    ("auto", {"PATHWAY_TPU_OPTIMIZE": "1", "PATHWAY_TPU_DEVICE_OPS": None}),
)
#: table_ops at a quarter of device_ops_leg's depth (50,000 rows in 5 commits)
OPT_OPS_ROWS, OPT_OPS_COMMITS = 50_000, OPS_COMMITS // 4


class _TransferLedger:
    """The bytes of the device operators' upload and fetch tensors, counted from the
    arrays they are handed and return, beside the residency plane's own ledger: the
    segment reduction uploads ``[1 + columns, rows]`` int64 and fetches ``[columns,
    groups]`` int64 (the count is a column); the matcher uploads both key arrays and
    fetches both index arrays."""

    def __enter__(self):
        self.h2d = self.d2h = 0
        self._dispatch = device_ops.segment_reduce_dispatch
        self._match = device_ops._match_pairs_device
        ledger = self

        def dispatch(inverse, diffs, vals, n_groups):
            live = 1 + sum(v is not None for v in vals)
            ledger.h2d += (1 + live) * len(inverse) * 8
            ledger.d2h += live * n_groups * 8
            return ledger._dispatch(inverse, diffs, vals, n_groups)

        def match(la, ra):
            out = ledger._match(la, ra)
            # the swapped call comes back through this wrapper, and is counted there
            if len(la) and len(ra) and len(ra) <= len(la):
                ledger.h2d += la.nbytes + ra.nbytes
                ledger.d2h += out[0].nbytes + out[1].nbytes
            return out

        device_ops.segment_reduce_dispatch = dispatch
        device_ops._match_pairs_device = match
        return self

    def __exit__(self, *exc):
        device_ops.segment_reduce_dispatch = self._dispatch
        device_ops._match_pairs_device = self._match


def _incremental_run(rows: list) -> dict:
    """``bench_dataflow.py::incremental_update`` through a Scope: the 1M-row load, then
    100 commits of 1,000 retractions and 1,000 inserts into a groupby (sum)."""
    scope = Scope()
    sess = scope.input_session(2)
    node = scope.group_by_table(sess, by_cols=[0], reducers=[(make_reducer(ReducerKind.SUM), [1])])
    sched = Scheduler(scope)
    for key, row in rows:
        sess.insert(key, row)
    t0 = time.perf_counter()
    sched.commit()
    load_s = time.perf_counter() - t0
    t = 0.0
    for c in range(INC_COMMITS):
        base = (c * INC_DELTA) % (N_REL - INC_DELTA)
        for i in range(base, base + INC_DELTA):
            key, row = rows[i]
            sess.remove(key, row)
            sess.insert(key, (row[0], row[1] + 1.0))
        t0 = time.perf_counter()
        sched.commit()
        t += time.perf_counter() - t0
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in scope.nodes
              if hasattr(n, "routes")}
    return {"out": _final_state(node), "run_s": t, "load_s": load_s, "routes": routes,
            "commits": sched.time, "rows": INC_COMMITS * 2 * INC_DELTA, "node": node}


def phase_optimizer(card: Card) -> int:
    """The graph optimizer and measurement-driven placement. Three programs, each in
    three modes: ``spec`` (``PATHWAY_TPU_OPTIMIZE=0``, ``PATHWAY_TPU_DEVICE_OPS=0``: the
    graph as written, host kernels), ``forced`` (optimizer on, ``=1``) and ``auto``
    (optimizer on, the variable unset: the placement policy picks host or card per
    batch). The programs: relational_engine's (200,000 + 50,000 rows through
    ``pw.run``), table_ops' at a quarter of its depth (50,000 rows in 5 commits of
    10,000) and ``bench_dataflow.py::incremental_update`` (a 1M-row load, then 100
    commits of 1,000 retractions and 1,000 inserts, so auto mode sees batches on both
    sides of ``min_rows``: 1M and 2,000 rows above, the table_ops groupby's small
    commits below). Every output must equal the spec's bit for bit. Reports, per program
    and mode: rows/s, ``optimizer_stats()``, ``POLICY.decisions()`` (calls and ns/row
    each side, the final side), the residency plane's h2d/d2h bytes per commit (which
    must equal the bytes of the operators' upload and fetch tensors), the segment
    kernels' launches and the matcher's calls; and ``optimizer_stats()`` of
    engine_pipeline's graph. Checks: in auto mode incremental_update's groupby ran at
    least ``PROBE_CALLS`` batches on each side; no resident batch outlived a commit.
    Returns the segment kernels' launches of the forced and auto runs."""
    phase_t0 = time.perf_counter()
    inc_rows = [(pw.ref_scalar(i), (i % 1024, float(i))) for i in range(N_REL)]
    programs = (
        ("relational_engine", _relational_engine_run),
        ("table_ops", lambda: _table_ops_run(OPT_OPS_ROWS, OPT_OPS_COMMITS)),
        ("incremental_update", lambda: _incremental_run(inc_rows)),
    )
    launches = 0
    spec: dict = {}
    for prog, run in programs:
        for mode, env in OPT_MODES:
            POLICY.reset()
            device_residency.reset_counters()
            device_ops.configure()
            device_ops.reset_counters()
            _zero_segment_launches()
            with _TransferLedger() as ledger:
                res = _with_env(env, run)
            stats = optimizer_stats()
            by_kernel = _segment_launches()
            hits = device_ops.hit_counts()
            res_stats = device_residency.stats()
            decisions = POLICY.decisions()
            commits = res["runner"].scheduler.time if "runner" in res else res["commits"]
            if mode != "spec":
                launches += sum(by_kernel.values())
            if mode == "spec":
                spec[prog] = res["out"]
                same = True
            elif prog == "incremental_update":
                same = _same_state(spec[prog], res["out"])
            else:
                same = res["out"] == spec[prog]
            plain = {"table_ops": res.get("same"),
                     "relational_engine": res.get("want") == res["out"]}.get(prog)
            card.emit(
                "optimizer", program=prog, mode=mode, env=env, rows=res["rows"],
                run_s=res["run_s"], rows_per_s=res["rows"] / res["run_s"], commits=commits,
                optimizer_stats=stats, placement=decisions, routes=res["routes"],
                segment_launches=by_kernel, segment_reduce_calls=hits.get("segment_reduce", 0),
                matcher_calls=hits.get("match_pairs", 0),
                h2d_bytes_per_commit=res_stats["h2d"]["bytes"] / max(1, commits),
                d2h_bytes_per_commit=res_stats["d2h"]["bytes"] / max(1, commits),
                residency=res_stats, upload_fetch_tensor_bytes={"h2d": ledger.h2d, "d2h": ledger.d2h},
                equals_spec=same, equals_plain=plain,
            )
            check(same, f"optimizer: {prog} in {mode} mode differs from the spec")
            if prog == "table_ops":
                check(all(res["same"].values()) and not res["failures"],
                      f"optimizer: table_ops in {mode} mode: {res['same']} {res['failures']}")
            if prog == "relational_engine":
                check(res["out"] == res["want"], f"optimizer: relational_engine in {mode} mode")
            check(res_stats["h2d"]["bytes"] == ledger.h2d and res_stats["d2h"]["bytes"] == ledger.d2h,
                  f"optimizer: {prog} {mode}: residency ledger {res_stats['h2d']} {res_stats['d2h']}"
                  f" against the tensors' {ledger.h2d} / {ledger.d2h} bytes")
            check(device_residency.live_resident_batches() == 0
                  and res_stats["events"]["resident_batches"] == 0,
                  f"optimizer: {prog} {mode}: a resident batch outlived its commit")
            if mode == "spec":
                check(not decisions and sum(by_kernel.values()) == 0,
                      f"optimizer: {prog}: the spec run reached the card")
            if mode == "forced":
                check(all(d["host_calls"] == 0 for d in decisions.values()) and decisions,
                      f"optimizer: {prog}: forced mode consulted the host side: {decisions}")
            if mode == "auto" and prog == "incremental_update":
                key = f"groupby:{res['node'].index}"
                st = decisions.get(key, {})
                check(st.get("host_calls", 0) >= PlacementPolicy.PROBE_CALLS
                      and st.get("device_calls", 0) >= PlacementPolicy.PROBE_CALLS,
                      f"optimizer: incremental_update's groupby was not probed on both sides: {st}")
            del res
            gc.collect()
    card.emit("optimizer", program="engine_pipeline", optimizer_stats=OPTIMIZER_SEEN.get("engine_pipeline"),
              phase_s=time.perf_counter() - phase_t0)
    return launches


# -- persistence: killed and resumed ------------------------------------------------------

PERSIST_MODES = ("PERSISTING", "OPERATOR_PERSISTING")
#: BASELINE #1's docs, cut from N_DOCS (20,000) to half for the script's time with the
#: processes phase
PERSIST_RAG_DOCS = N_DOCS // 2
PERSIST_RAG_FILES = 20  # PERSIST_RAG_DOCS in files of 500 docs
#: bench_dataflow.py wordcount's 10,000-line files, cut from its 1,000,000 words to 250,000 so
#: that the script stays within its time with the databases phase, and to 100,000 with the
#: processes phase
PERSIST_WC_FILES = 10
PERSIST_WC_LINES = 10_000
PERSIST_WC_KEYS = 4096
#: snapshot intervals: the 1.61 GB index's snapshot amortized over 30 s of commits, the
#: word count's (its input session and per-file rows grow to 1M rows each) over 15 s
PERSIST_RAG_INTERVAL_MS = 30_000
PERSIST_WC_INTERVAL_MS = 15_000
PERSIST_AUTOCOMMIT_MS = 20  # a file arrives whole in one poll
PERSIST_WAIT_S = 300.0


class _Paced:
    """One persistence run's harness. ``files`` ([(name, text)]) are written into
    ``root/in`` one at a time, each once the one before has reached the sink, so each is
    a commit of its own; files already there (a killed run's) are skipped.
    ``FsReader.poll`` is wrapped to record what it read and to end the streaming read
    once ``root/stop`` exists, which the pacer writes after the last file's commit and
    ``after_all()``. With ``kill_after`` the run SIGKILLs its own process once the
    ``kill_after``-th file's commit has reached the sink and that commit's checkpoint
    (its journal segment, or a snapshot forced at that commit) is written, after writing
    ``report()`` to ``root/child.json``. With ``force_checkpoint=False`` no snapshot is
    forced: the kill falls on the first such commit that its interval did not snapshot,
    so the resume starts from an older snapshot, as after a crash."""

    def __init__(self, root: str, files: list, kill_after: int | None = None,
                 force_checkpoint: bool = True) -> None:
        self.root, self.files, self.kill_after = root, files, kill_after
        self.force_checkpoint = force_checkpoint
        self.last_snapshot_time: int | None = None
        self.indir = os.path.join(root, "in")
        self.stop = os.path.join(root, "stop")
        os.makedirs(self.indir, exist_ok=True)
        self.cv = threading.Condition()
        self.reads = 0  # polls that returned entries
        self.committed = 0  # self.reads as of the last commit at the sink
        self.read_at: dict[str, int] = {}  # path -> the poll that read it
        self.lines_read = 0
        self.all_seen = False
        self.commit_walls: list[float] = []
        self.first_data_commit = 0.0
        self.t_start = 0.0
        self.kill_pending = False
        self.failures: list[str] = []
        self.after_all = None
        self.report = lambda: {}

    def files_committed(self) -> int:
        return sum(1 for r in self.read_at.values() if r <= self.committed)

    def on_time_end(self, _time: int) -> None:
        with self.cv:
            self.commit_walls.append(time.perf_counter())
            if self.reads > self.committed:
                self.committed = self.reads
                if not self.first_data_commit:
                    self.first_data_commit = self.commit_walls[-1]
                self.cv.notify_all()
                if self.kill_after is not None and self.files_committed() >= self.kill_after:
                    self.kill_pending = True

    def _poll(self, orig):
        def poll(reader):
            entries, done = orig(reader)
            with self.cv:
                if entries:
                    self.reads += 1
                    for payload, path, _meta in entries:
                        if payload is not None:
                            self.read_at[path] = self.reads
                            self.lines_read += payload.count("\n")
                if len(reader._seen) == len(self.files):
                    self.all_seen = True
                    self.cv.notify_all()
            return entries, done or (not entries and os.path.exists(self.stop))

        return poll

    def _die(self, time_: int) -> None:
        with open(os.path.join(self.root, "child.json"), "w") as fh:
            json.dump({"files_committed": self.files_committed(), "lines_read": self.lines_read,
                       "killed_at_time": time_, "last_snapshot_time": self.last_snapshot_time,
                       **self.report()}, fh)
        os.kill(os.getpid(), signal.SIGKILL)

    def _kill_after_journal(self, orig):
        def on_commit(driver, time_):
            orig(driver, time_)
            if self.kill_pending:
                self._die(time_)

        return on_commit

    def _kill_after_snapshot(self, orig):
        def on_commit(mgr, scope, drivers, time_):
            written = len(mgr.write_seconds)
            orig(mgr, scope, drivers, time_)
            if self.kill_pending and self.force_checkpoint and len(mgr.write_seconds) == written:
                mgr.snapshot(scope, drivers, time_)  # this commit's checkpoint
            if len(mgr.write_seconds) > written:
                self.last_snapshot_time = time_
                if not self.force_checkpoint:
                    return  # an interval snapshot of this commit: die at a later one
            if self.kill_pending:
                self._die(time_)

        return on_commit

    def _pace(self) -> None:
        try:
            for name, text in self.files:
                path = os.path.join(self.indir, name)
                if os.path.exists(path):
                    continue
                part = os.path.join(self.root, "part")
                with open(part, "w") as fh:
                    fh.write(text)
                os.replace(part, path)  # the reader never sees half a file
                with self.cv:
                    if not self.cv.wait_for(
                        lambda: self.read_at.get(path, math.inf) <= self.committed,
                        timeout=PERSIST_WAIT_S,
                    ):
                        self.failures.append(f"{name} never reached the sink")
                        return
            with self.cv:
                if not self.cv.wait_for(lambda: self.all_seen and self.committed == self.reads,
                                        timeout=PERSIST_WAIT_S):
                    self.failures.append("the last file's commit never reached the sink")
                    return
            if self.after_all is not None:
                self.after_all()
        finally:
            open(self.stop, "w").close()

    def run(self, config, extra_patches: list = ()) -> None:
        """``pw.run(persistence_config=config)`` with the harness's wraps in place and
        the pacer running; the wraps are undone and the pacer joined after."""
        from pathway_tpu_torch.engine.connectors import FsReader
        from pathway_tpu_torch.engine.persistence import OperatorSnapshotManager, PersistentDriver

        patches = [(FsReader, "poll", self._poll(FsReader.poll)), *extra_patches]
        if self.kill_after is not None:
            patches += [
                (PersistentDriver, "on_commit", self._kill_after_journal(PersistentDriver.on_commit)),
                (OperatorSnapshotManager, "on_commit",
                 self._kill_after_snapshot(OperatorSnapshotManager.on_commit)),
            ]
        saved = [(cls, name, cls.__dict__[name]) for cls, name, _fn in patches]
        for cls, name, fn in patches:
            setattr(cls, name, fn)
        self.t_start = time.perf_counter()
        pacer = threading.Thread(target=self._pace, daemon=True, name="pw-persist-pacer")
        pacer.start()
        try:
            pw.run(persistence_config=config)
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)
            open(self.stop, "w").close()  # a failed run leaves no pacer waiting
            pacer.join(timeout=PERSIST_WAIT_S)


def _persist_config(store: str, mode: str, interval_ms: int):
    return pw.persistence.Config(
        pw.persistence.Backend.filesystem(store), snapshot_interval_ms=interval_ms,
        persistence_mode=pw.persistence.PersistenceMode[mode],
    )


def _persist_rag_files() -> list:
    per = PERSIST_RAG_DOCS // PERSIST_RAG_FILES
    return [
        (f"docs{f:03d}.jsonl",
         "".join(json.dumps({"doc_id": i, "text": doc_text(i)}) + "\n"
                 for i in range(f * per, (f + 1) * per)))
        for f in range(PERSIST_RAG_FILES)
    ]


def _persist_embedders():
    """The docs' embedder and the queries' (the same seeded weights), so that the docs'
    embedded rows are counted apart from the queries'."""
    return tuple(EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                                 seq_bucket_min=SEQ_LEN, seed=SEED) for _ in range(2))


def _persist_rag_run(paced: _Paced, store: str, mode: str, embedder, qembedder,
                     restore_watch: dict | None = None) -> dict:
    """The streaming-RAG program (BASELINE #1) with its docs read by
    ``pw.io.jsonlines.read(..., persistent_id="docs")`` under persistence: the embedder
    UDF, DataIndex over 1,048,576 slots on the card, N_QUERIES as-of-now queries once
    every doc is in the index; then the stop file ends the read. ``restore_watch``
    collects the index as restored."""
    obs = {"answers": {}, "latencies": [], "timeouts": [], "ingest_end": 0.0}
    factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
    go, queries_done, answer_seen = threading.Event(), threading.Event(), threading.Event()
    doc_texts = [0]
    embed_batch = embedder.embed_batch

    def counted(texts):
        doc_texts[0] += len(texts)
        return embed_batch(texts)

    embedder.embed_batch = counted
    paced.report = lambda: {"docs_embedded": doc_texts[0]}

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not go.wait(timeout=PERSIST_WAIT_S):
                obs["timeouts"].append("the docs never all reached the index")
                return
            for i in range(N_QUERIES):
                answer_seen.clear()
                t0 = time.perf_counter()
                self.next(query_id=i, text=doc_text(i * 37 % PERSIST_RAG_DOCS))
                if answer_seen.wait(timeout=PERSIST_WAIT_S):
                    obs["latencies"].append(time.perf_counter() - t0)
                else:
                    obs["timeouts"].append(i)
            queries_done.set()

    def after_all() -> None:
        deadline = time.monotonic() + PERSIST_WAIT_S
        while len(factory.built.key_to_slot) < PERSIST_RAG_DOCS:
            if time.monotonic() > deadline:
                paced.failures.append("the index never held every doc")
                return
            time.sleep(0.005)
        obs["ingest_end"] = time.perf_counter()
        go.set()
        queries_done.wait(timeout=PERSIST_WAIT_S)

    paced.after_all = after_all
    docs = pw.io.jsonlines.read(paced.indir, schema=pw.schema_from_types(doc_id=int, text=str),
                                mode="streaming", persistent_id="docs",
                                autocommit_duration_ms=PERSIST_AUTOCOMMIT_MS)
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(query_id=int, text=str),
                                autocommit_duration_ms=None)
    queries = queries.select(query_id=pw.this.query_id, qemb=qembedder(pw.this.text))
    res = DataIndex(docs, factory, docs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=K)

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][row["query_id"]] = (tuple(row["_pw_index_reply_ids"]),
                                               np.asarray(row["qemb"], np.float32))
            answer_seen.set()

    pw.io.subscribe(res, on_change=on_answer, on_time_end=paced.on_time_end)
    from pathway_tpu_torch.engine.persistence import FileBackend

    patches = [_timed(DeviceKnnIndex, "op_state", obs.setdefault("index_copy_s", [])),
               _timed(FileBackend, "write", obs.setdefault("file_write_s", []))]
    if restore_watch is not None:
        # the index as restored: a device copy of its tensors beside the snapshot's
        # arrays (compared after the run), the upload's seconds, the tensors' device
        from pathway_tpu_torch.engine.external_index import ExternalIndexNode

        orig_restore = ExternalIndexNode.restore_op_state

        def restore(node, state):
            _sync()
            t0 = time.perf_counter()
            orig_restore(node, state)
            _sync()
            idx = node.ext_index
            restore_watch.update(
                upload_s=time.perf_counter() - t0, snapshot=state["index"],
                device=str(idx.state.vectors.device), clone=[t.clone() for t in idx.state],
                docs=len(idx.key_to_slot))

        patches.append((ExternalIndexNode, "restore_op_state", restore))
    device_pipeline.PIPELINE.configure()
    with _KeptRunner() as kept:
        paced.run(_persist_config(store, mode, PERSIST_RAG_INTERVAL_MS), patches)
    embedder.embed_batch = embed_batch
    return {"obs": obs, "index": factory.built, "runner": kept.runners[0],
            "docs_embedded": doc_texts[0], "run_s": time.perf_counter() - paced.t_start}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(cls, name: str, into: list) -> tuple:
    """A patch of ``cls.name`` that appends each call's seconds to ``into``."""
    orig = cls.__dict__[name]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        into.append(time.perf_counter() - t0)
        return out

    return (cls, name, timed)


def _lazy_rows_snapshot(runner) -> dict:
    """The share of a snapshot that the lazy device rows (the embedder's output, held by
    the nodes downstream of it) take: the distinct rows, and the bytes and seconds of
    pickling those nodes' states in one pass, as a snapshot does (a row that several
    nodes hold is pickled once)."""
    import pickle

    from pathway_tpu_torch.engine.device import LazyDeviceVector

    states, rows = [], set()
    for node in runner.scope.nodes:
        lazy = [v for row in node.current.values() for v in row if isinstance(v, LazyDeviceVector)]
        if lazy:
            states.append(node.op_state())
            rows.update(map(id, lazy))
    t0 = time.perf_counter()
    size = len(pickle.dumps(states, protocol=4))
    return {"rows": len(rows), "nodes": len(states), "bytes": size,
            "pickle_s": time.perf_counter() - t0}


def _persist_wc_files() -> tuple[list, dict]:
    """The word count's 10 files of 10,000 lines (a seeded draw over 4,096 words) and
    ``np.unique``'s counts of all of them."""
    ids = np.random.default_rng(SEED).integers(0, PERSIST_WC_KEYS, PERSIST_WC_FILES * PERSIST_WC_LINES)
    words, counts = np.unique(ids, return_counts=True)
    want = {f"w{w}": int(c) for w, c in zip(words.tolist(), counts.tolist())}
    files = [
        (f"words{f:03d}.txt",
         "".join(f"w{x}\n" for x in ids[f * PERSIST_WC_LINES:(f + 1) * PERSIST_WC_LINES].tolist()))
        for f in range(PERSIST_WC_FILES)
    ]
    return files, want


def _persist_wc_run(paced: _Paced, store: str, mode: str, out_csv: str) -> dict:
    """The Pathway persistence tutorial's program: ``pw.io.plaintext.read(...,
    persistent_id="w")``, a groupby and count (on the card), ``pw.io.csv.write``."""
    words = pw.io.plaintext.read(paced.indir, mode="streaming", persistent_id="w",
                                 autocommit_duration_ms=PERSIST_AUTOCOMMIT_MS)
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    pw.io.csv.write(counts, out_csv)
    from pathway_tpu_torch.engine.connectors import FileWriter

    orig_time_end = FileWriter.on_time_end

    def on_time_end(writer, time_):  # the sink's commit end (no second subscriber)
        orig_time_end(writer, time_)
        paced.on_time_end(time_)

    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    with _KeptRunner() as kept:
        paced.run(_persist_config(store, mode, PERSIST_WC_INTERVAL_MS),
                  [(FileWriter, "on_time_end", on_time_end)])
    runner = kept.runners[0]
    routes = [dict(n.routes) for n in runner.scope.nodes if type(n).__name__ == "GroupbyNode"]
    return {"runner": runner, "routes": routes, "run_s": time.perf_counter() - paced.t_start}


def _fold_csv(path: str) -> dict:
    """The state a csv update log leaves (a row in on +1, out on -1 of the same row)."""
    import csv as _csv

    state: dict = {}
    with open(path, newline="") as fh:
        for row in _csv.DictReader(fh):
            cnt = int(row["cnt"])
            if int(row["diff"]) > 0:
                state[row["word"]] = cnt
            elif state.get(row["word"]) == cnt:
                del state[row["word"]]
    return state


def _starts_with(path: str, prefix: bytes) -> bool:
    with open(path, "rb") as fh:
        return fh.read(len(prefix)) == prefix and len(fh.read(1)) == 1


def _persistence_child(args: list[str]) -> int:
    """``chip_smoke.py --persistence-child <program> <mode> <root> <kill_after>
    [interval]``: one of the two programs in a process of its own, which SIGKILLs itself
    after the commit of file ``kill_after`` and that commit's checkpoint (with
    ``interval``: at the first commit from there that its snapshot interval did not
    checkpoint). It makes its models and inputs, then waits for ``root/go`` (so its
    start-up overlaps the parent's fault-free run) before it touches ``root``. Returns
    only if it was not killed (which the parent counts as a failure)."""
    program, mode, root, kill_after = args[0], args[1], args[2], int(args[3])
    force = args[4:5] != ["interval"]
    store = os.path.join(root, f"store-kr-{mode}")
    if program == "rag":
        files = _persist_rag_files()
        embedder, qembedder = _persist_embedders()
    else:
        files, _want = _persist_wc_files()
    deadline = time.monotonic() + PERSIST_WAIT_S
    while not os.path.exists(os.path.join(root, "go")):
        if time.monotonic() > deadline:
            return 4
        time.sleep(0.01)
    paced = _Paced(root, files, kill_after=kill_after, force_checkpoint=force)
    if program == "rag":
        _persist_rag_run(paced, store, mode, embedder, qembedder)
    else:
        _persist_wc_run(paced, store, mode, os.path.join(root, f"out-kr-{mode}.csv"))
    return 3


#: the persistence children started, so that a failed phase leaves none behind
_CHILDREN: list = []


def _spawn_persistence_child(args: list[str], env: dict) -> subprocess.Popen:
    """Start ``_persistence_child(args)`` in a fresh interpreter."""
    cmd = [sys.executable, os.path.abspath(__file__), "--persistence-child", *args]
    _CHILDREN.append(subprocess.Popen(cmd, env=env))
    return _CHILDREN[-1]


def _release_child(root: str, child: subprocess.Popen) -> tuple[int, float, dict]:
    """Let a started child run over fresh inputs in ``root`` -> (its return code, its
    seconds from the release to its end, its report)."""
    _fresh_inputs(root)
    t0 = time.perf_counter()
    open(os.path.join(root, "go"), "w").close()
    try:
        rc = child.wait(timeout=PERSIST_WAIT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        os.remove(os.path.join(root, "go"))
    seconds = time.perf_counter() - t0
    with open(os.path.join(root, "child.json")) as fh:
        return rc, seconds, json.load(fh)


def _fresh_inputs(root: str) -> None:
    """An empty input directory at the same path (the connector's keys hash the path,
    so every run of a program gives its docs the same keys) and no stop file."""
    shutil.rmtree(os.path.join(root, "in"), ignore_errors=True)
    for name in ("stop", "child.json", "part"):
        if os.path.exists(os.path.join(root, name)):
            os.remove(os.path.join(root, name))


def _persistence_stats(runner, paced: _Paced) -> dict:
    """What the persistence layer did in a run: the journal's bytes and replay, the
    snapshots' writes and restore; and the time to recover: from the run's start to its
    first commit at the sink (the replayed history's, or the first after the restore),
    and to its first commit of new input."""
    from pathway_tpu_torch.engine.persistence import PersistentDriver

    out: dict = {"commits_at_sink": len(paced.commit_walls), "lines_read": paced.lines_read}
    journals = [d for d in runner.drivers if isinstance(d, PersistentDriver)]
    if journals:
        out.update(journal_bytes=sum(d.journal_bytes for d in journals),
                   events_replayed=sum(d.events_replayed for d in journals),
                   replay_s=sum(d.replay_seconds for d in journals))
    mgr = runner.snapshot_manager
    if mgr is not None:
        out.update(snapshot_interval_ms=int(mgr.interval * 1000), snapshots=len(mgr.write_seconds),
                   snapshot_bytes=mgr.write_bytes[-1] if mgr.write_bytes else 0,
                   snapshot_write_median_s=float(np.median(mgr.write_seconds)) if mgr.write_seconds else None,
                   snapshot_write_s=mgr.write_seconds, restore_s=mgr.restore_seconds,
                   restore_bytes=mgr.restore_bytes)
    if paced.commit_walls:
        out["recover_to_first_commit_s"] = paced.commit_walls[0] - paced.t_start
    if paced.first_data_commit:
        out["to_first_new_input_commit_s"] = paced.first_data_commit - paced.t_start
    return out


def _snapshot_breakdown(run: dict) -> dict:
    """Where a RAG run's snapshot writes went: the index's copy to the host and the
    file writes (fsync included) by medians; the lazy rows' share of a snapshot."""
    out = {"index_copy_s": run["obs"]["index_copy_s"], "file_write_s": run["obs"]["file_write_s"]}
    if run["runner"].snapshot_manager is not None:
        out["lazy_rows"] = _lazy_rows_snapshot(run["runner"])
    return out


def _rag_checks(run: dict, mode: str) -> tuple[dict, dict]:
    """Every doc stored once, every query answered with the exact f32 search's hits
    over the vectors the index holds -> (the checks, {key: stored vector})."""
    obs, index = run["obs"], run["index"]
    keys = list(index.key_to_slot)
    slots = torch.tensor([index.key_to_slot[k] for k in keys], device=index.state.vectors.device)
    mat = index.state.vectors.index_select(0, slots).cpu().numpy()
    valid = int(index.state.valid.sum().item())
    norms = np.linalg.norm(mat, axis=1)
    row_of = {k: i for i, k in enumerate(keys)}
    worst = 0.0
    answered_exact = True
    for _qid, (hit_keys, qvec) in obs["answers"].items():
        cos = mat @ qvec / np.maximum(norms * np.linalg.norm(qvec), np.float32(1e-30))
        top = np.sort(cos)[::-1][:K]
        got = np.sort(np.array([cos[row_of[k]] for k in hit_keys], np.float32))[::-1]
        err = float(np.abs(got - top).max()) if len(got) == len(top) else math.inf
        worst = max(worst, err)
        answered_exact &= err <= DIST_TOL
    checks = {
        "docs_stored_once": len(keys) == PERSIST_RAG_DOCS and valid == PERSIST_RAG_DOCS,
        "every_query_answered": len(obs["answers"]) == N_QUERIES and not obs["timeouts"],
        "hits_are_exact_f32_top_k": answered_exact,
    }
    return {**checks, "max_top_k_cos_err": worst, "index_rows": len(keys), "valid_slots": valid}, \
        {k: mat[i] for i, k in enumerate(keys)}


def _persistence_rag(card: Card, base: str) -> int:
    root = os.path.join(base, "rag")
    os.makedirs(root, exist_ok=True)
    files = _persist_rag_files()
    kill_after = PERSIST_RAG_FILES // 2
    embedder, qembedder = _persist_embedders()
    calls = [_count_embed_calls(embedder)[0], _count_embed_calls(qembedder)[0]]
    launches_before = fa.KERNEL.launches
    fault_free = None
    for mode in PERSIST_MODES:
        # the killed run's process starts now and waits for its inputs
        child_proc = _spawn_persistence_child(["rag", mode, root, str(kill_after)],
                                              dict(os.environ, PATHWAY_RUN_ID=f"rag-{mode}"))
        # 1. fault-free, with persistence on, into a fresh store
        _fresh_inputs(root)
        paced = _Paced(root, files)
        ff = _persist_rag_run(paced, os.path.join(root, f"store-ff-{mode}"), mode, embedder, qembedder)
        ff_checks, ff_vectors = _rag_checks(ff, mode)
        ff_stats = _persistence_stats(ff["runner"], paced)
        ff_docs_per_s = PERSIST_RAG_DOCS / (ff["obs"]["ingest_end"] - paced.t_start)
        ff_breakdown = _snapshot_breakdown(ff)
        ff_run_s, ff_failures = ff["run_s"], paced.failures
        if fault_free is None:
            fault_free = (ff["obs"]["answers"], ff_vectors)
        del ff
        gc.collect()
        # 2. the same program in the child process, which kills itself after commit k
        rc, child_s, child = _release_child(root, child_proc)
        # 3. the resumed run over the killed run's files and store
        watch: dict = {}
        paced = _Paced(root, files)
        rs = _persist_rag_run(paced, os.path.join(root, f"store-kr-{mode}"), mode, embedder,
                              qembedder, restore_watch=watch if mode == "OPERATOR_PERSISTING" else None)
        rs_checks, rs_vectors = _rag_checks(rs, mode)
        rs_stats = _persistence_stats(rs["runner"], paced)
        index = rs["index"]
        new_docs = PERSIST_RAG_DOCS - watch.get("docs", 0)
        rs_docs_per_s = rs["docs_embedded"] / max(rs["obs"]["ingest_end"] - paced.t_start, 1e-9)
        # recall@10 against the fault-free run, and how many stored rows are the same bits
        ff_answers, ff_vecs = fault_free
        recalls = [len(set(hits) & set(ff_answers[q][0])) / K
                   for q, (hits, _v) in rs["obs"]["answers"].items() if q in ff_answers]
        recall = float(np.mean(recalls)) if recalls else float("nan")
        same_bits = sum(1 for k, v in rs_vectors.items()
                        if k in ff_vecs and np.array_equal(v.view(np.int32), ff_vecs[k].view(np.int32)))
        checks = {**{f"resumed_{k}": v for k, v in rs_checks.items() if isinstance(v, bool)},
                  **{f"fault_free_{k}": v for k, v in ff_checks.items() if isinstance(v, bool)},
                  "child_killed": rc == -signal.SIGKILL,
                  "recall_vs_fault_free_ge_0.99": recall >= 0.99}
        fields: dict = {}
        if mode == "OPERATOR_PERSISTING":
            snap = watch.get("snapshot")
            restored_bits = snap is not None and all(
                np.array_equal(t.cpu().numpy(), np.asarray(snap[name]))
                for t, name in zip(watch["clone"], ("vectors", "valid", "norms")))
            checks.update(
                restored_index_bit_equal_to_snapshot=bool(restored_bits),
                restored_index_on_card=watch.get("device", "").startswith("cuda"),
                no_doc_embedded_twice=child["docs_embedded"] + rs["docs_embedded"] == PERSIST_RAG_DOCS,
                resumed_embedded_only_new_docs=rs["docs_embedded"] == new_docs,
                new_docs_by_device_route=index.rows_device == new_docs and index.rows_host == 0)
            fields.update(restored_docs=watch.get("docs"), upload_s=watch.get("upload_s"),
                          index_rows_device_route=index.rows_device,
                          index_rows_host_route=index.rows_host)
            del watch["clone"], watch["snapshot"]
        else:
            checks.update(replayed_docs_embedded_again=rs["docs_embedded"] == PERSIST_RAG_DOCS,
                          docs_by_device_route=index.rows_device == PERSIST_RAG_DOCS and index.rows_host == 0)
        lat_ms = sorted(1e3 * x for x in rs["obs"]["latencies"])
        failures = ff_failures + paced.failures
        card.emit(
            "persistence", program="persistence_rag", mode=mode,
            source=f"BASELINE #1 (bench.py::pipeline_leg) with its docs read from "
                   f"{PERSIST_RAG_FILES} JSON-lines files",
            docs=PERSIST_RAG_DOCS, files=PERSIST_RAG_FILES, kill_after_file=kill_after,
            fault_free_docs_per_s=ff_docs_per_s, resumed_docs_per_s=rs_docs_per_s,
            fault_free=ff_stats, fault_free_run_s=ff_run_s, child_s=child_s, child=child,
            fault_free_snapshot_parts=ff_breakdown, resumed_snapshot_parts=_snapshot_breakdown(rs),
            resumed=rs_stats, resumed_run_s=rs["run_s"], resumed_docs_embedded=rs["docs_embedded"],
            resumed_query_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
            recall_at_10_vs_fault_free=recall, stored_rows_bit_equal_to_fault_free=same_bits,
            max_top_k_cos_err=rs_checks["max_top_k_cos_err"], checks=checks, failures=failures,
            **fields)
        check(not failures, f"persistence_rag {mode}: {failures}")
        check(all(checks.values()), f"persistence_rag {mode}: {checks}")
        del rs, index
        gc.collect()
        torch.cuda.empty_cache()
    launches = fa.KERNEL.launches - launches_before
    embed_calls = calls[0][0] + calls[1][0]
    check(launches == LAYERS * embed_calls,
          f"persistence: flash launches {launches} != {LAYERS} x {embed_calls} embed calls")
    return launches


def _persistence_wordcount(card: Card, base: str) -> int:
    root = os.path.join(base, "wordcount")
    os.makedirs(root, exist_ok=True)
    files, want = _persist_wc_files()
    kill_after = PERSIST_WC_FILES // 2
    n_words = PERSIST_WC_FILES * PERSIST_WC_LINES
    _zero_segment_launches()
    fault_free = None
    iroot = os.path.join(base, "wordcount-interval")
    os.makedirs(iroot, exist_ok=True)
    for mode in PERSIST_MODES:
        child_proc = _spawn_persistence_child(
            ["wordcount", mode, root, str(kill_after)],
            dict(os.environ, PATHWAY_RUN_ID=f"wc-{mode}", PATHWAY_TPU_DEVICE_OPS="1"))
        if mode == "OPERATOR_PERSISTING":
            # the crash between interval snapshots, run after this loop
            interval_child = _spawn_persistence_child(
                ["wordcount", mode, iroot, str(kill_after), "interval"],
                dict(os.environ, PATHWAY_RUN_ID="wc-interval", PATHWAY_TPU_DEVICE_OPS="1"))
        _fresh_inputs(root)
        paced = _Paced(root, files)
        ff_out = os.path.join(root, f"out-ff-{mode}.csv")
        ff = _with_device_ops("1", lambda: _persist_wc_run(paced, os.path.join(root, f"store-ff-{mode}"),
                                                          mode, ff_out))
        ff_stats = _persistence_stats(ff["runner"], paced)
        ff_state = _fold_csv(ff_out)
        failures = list(paced.failures)
        if fault_free is None:
            fault_free = ff_state
        rc, child_s, child = _release_child(root, child_proc)
        out = os.path.join(root, f"out-kr-{mode}.csv")
        with open(out, "rb") as fh:
            killed_log = fh.read()
        paced = _Paced(root, files)
        rs = _with_env({"PATHWAY_TPU_DEVICE_OPS": "1", "PATHWAY_RUN_ID": f"wc-{mode}"},
                       lambda: _persist_wc_run(paced, os.path.join(root, f"store-kr-{mode}"), mode, out))
        rs_stats = _persistence_stats(rs["runner"], paced)
        rs_state = _fold_csv(out)
        failures += paced.failures
        (routes,) = rs["routes"]
        checks = {
            "child_killed": rc == -signal.SIGKILL,
            "fault_free_counts_equal_np_unique": ff_state == want,
            "resumed_counts_equal_np_unique": rs_state == want,
            "resumed_state_equals_fault_free": rs_state == fault_free,
            "groupby_device_route_every_commit": routes["device"] > 0 and routes["host"] == 0
            and routes["rows"] == 0,
            "sink_file_resumed_past_the_killed_runs_lines": _starts_with(out, killed_log)
            and killed_log.count(b"\n") > 1,
        }
        if mode == "OPERATOR_PERSISTING":
            checks["no_word_read_twice"] = child["lines_read"] + paced.lines_read == n_words
        else:
            checks["journal_replayed_the_killed_runs_words"] = (
                rs_stats.get("events_replayed") == child["lines_read"])
        card.emit(
            "persistence", program="persistence_wordcount", mode=mode,
            source="Pathway's persistence tutorial (plaintext -> groupby count -> csv) at "
                   "bench_dataflow.py::wordcount's size",
            words=n_words, keys=PERSIST_WC_KEYS, files=PERSIST_WC_FILES, kill_after_file=kill_after,
            fault_free_rows_per_s=n_words / ff["run_s"], fault_free_run_s=ff["run_s"],
            resumed_rows_per_s=paced.lines_read / rs["run_s"], resumed_run_s=rs["run_s"],
            fault_free=ff_stats, child_s=child_s, child=child, resumed=rs_stats,
            groupby_routes_after_resume=routes, sink_lines_before_resume=killed_log.count(b"\n"),
            checks=checks, failures=failures)
        check(not failures, f"persistence_wordcount {mode}: {failures}")
        check(all(checks.values()), f"persistence_wordcount {mode}: {checks}")
        del ff, rs
        gc.collect()
    _wordcount_between_snapshots(card, iroot, interval_child, files, want, fault_free, kill_after)
    launches = sum(_segment_launches().values())
    check(launches > 0, "persistence_wordcount launched no segment kernel")
    return launches


def _wordcount_between_snapshots(card: Card, root: str, child_proc, files: list, want: dict,
                                 fault_free: dict, kill_after: int) -> None:
    """The word count under operator snapshots killed as a crash would kill it: at the
    first commit from file ``kill_after`` on that its 15 s interval did not snapshot.
    The resume starts from the older snapshot, reads the files after it again and
    writes their commits to the sink again; the folded sink file must still equal the
    fault-free run's state and ``np.unique``'s counts."""
    mode = "OPERATOR_PERSISTING"
    n_words = PERSIST_WC_FILES * PERSIST_WC_LINES
    rc, child_s, child = _release_child(root, child_proc)
    out = os.path.join(root, f"out-kr-{mode}.csv")
    with open(out, "rb") as fh:
        killed_log = fh.read()
    paced = _Paced(root, files)
    rs = _with_env({"PATHWAY_TPU_DEVICE_OPS": "1", "PATHWAY_RUN_ID": "wc-interval"},
                   lambda: _persist_wc_run(paced, os.path.join(root, f"store-kr-{mode}"), mode, out))
    rs_stats = _persistence_stats(rs["runner"], paced)
    rs_state = _fold_csv(out)
    (routes,) = rs["routes"]
    last, killed_at = child["last_snapshot_time"], child["killed_at_time"]
    read_again = child["lines_read"] + paced.lines_read - n_words
    checks = {
        "child_killed": rc == -signal.SIGKILL,
        "killed_after_its_last_snapshot": last is not None and last < killed_at,
        "resumed_from_an_older_snapshot_read_words_again": read_again > 0,
        "resumed_counts_equal_np_unique": rs_state == want,
        "resumed_state_equals_fault_free": rs_state == fault_free,
        "groupby_device_route_every_commit": routes["device"] > 0 and routes["host"] == 0
        and routes["rows"] == 0,
        "sink_file_resumed_past_the_killed_runs_lines": _starts_with(out, killed_log)
        and killed_log.count(b"\n") > 1,
    }
    card.emit(
        "persistence", program="persistence_wordcount", mode=mode,
        kill="between_interval_snapshots", words=n_words, kill_after_file=kill_after,
        snapshot_interval_ms=PERSIST_WC_INTERVAL_MS, child_s=child_s, child=child,
        words_read_again=read_again, resumed_rows_per_s=paced.lines_read / rs["run_s"],
        resumed_run_s=rs["run_s"], resumed=rs_stats, groupby_routes_after_resume=routes,
        sink_lines_before_resume=killed_log.count(b"\n"), checks=checks,
        failures=paced.failures)
    check(not paced.failures, f"persistence_wordcount between snapshots: {paced.failures}")
    check(all(checks.values()), f"persistence_wordcount between snapshots: {checks}")


def phase_persistence(card: Card) -> dict:
    """The two programs under persistence, each in both modes (PERSISTING: input
    journals; OPERATOR_PERSISTING: operator snapshots), three ways: a fault-free run,
    a run in a child process that SIGKILLs itself after the commit of its k-th file
    (half the files) and that commit's checkpoint, and the resumed run over the killed
    run's files and store. The fault-free and resumed runs run here, so their kernel
    launches are counted. ``persistence_rag``: BASELINE #1's streaming RAG (MiniLM-L6
    bf16 through the flash forward kernel, DataIndex over 1,048,576 slots, k = 10) fed
    10,000 docs from 20 JSON-lines files one file a commit, then 64 as-of-now queries;
    every doc stored once, every query answered with the exact f32 search's hits over
    the vectors the index holds, recall@10 against the fault-free run >= 0.99; under
    operator snapshots the resumed run embeds only the docs after the snapshot, its
    index restored on the card equal to the snapshot's bit for bit.
    ``persistence_wordcount``: the Pathway persistence tutorial's plaintext -> groupby
    count -> csv program at a tenth of bench_dataflow.py::wordcount's size (100,000 words
    over 4,096 keys in 10 files of 10,000 lines), the groupby forced onto the card; the sink
    file resumed under one ``PATHWAY_RUN_ID`` folds to ``np.unique``'s counts, as the
    fault-free run's does; under operator snapshots no word is read twice. A fifth run
    of the word count kills it between two interval snapshots instead, and resumes it
    from the older one. Inputs and stores live in a temporary directory, removed
    after."""
    phase_t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="pw-persistence-")
    try:
        rag = _persistence_rag(card, base)
        wordcount = _persistence_wordcount(card, base)
    finally:
        for child in _CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(base, ignore_errors=True)
    card.emit("persistence_total", phase_s=time.perf_counter() - phase_t0,
              flash_launches=rag, segment_launches=wordcount)
    return {"flash": rag, "segment": wordcount}


# -- the engine's C++ host kernels ----------------------------------------------------------

#: the Python-branch reruns' depths (the kernel run of each comparison takes the same
#: depth; the earlier phases run every workload at full depth with the kernels)
#: (halved, with the phases above, for the script's time)
NATIVE_OPS_ROWS, NATIVE_OPS_COMMITS = 25_000, OPT_OPS_COMMITS  # table_ops at an eighth
NATIVE_NEXMARK_EVENTS, NATIVE_NEXMARK_COMMITS = 10_000, 2
NATIVE_GRAPH_SCALE = 9  # PageRank over 512 vertices, 8,192 edges
NATIVE_SERVING_DOCS, NATIVE_SERVING_QUERIES = 4 * CHUNK, 8  # four paced commits of 256
NATIVE_SERVING_CAPACITY = 1 << 12
NATIVE_ROWS, NATIVE_ROWS_COMMITS = 10_000, 6  # engine_rows: rows a commit, commits
#: the host kernels each workload's path calls (every kernel with a caller in the port
#: is on one of them; hash_tuples_batch and shard_values have none yet)
NATIVE_PATHS = {
    "relational_engine/groupby_sum": ("extract_column", "entry_diffs", "pointers_to_bytes"),
    "relational_engine/join_inner": ("entries_to_side", "hash_join_pairs"),
    "table_ops": ("extract_column", "entry_diffs", "consolidate", "apply_state",
                  "bytes_to_pointers", "entry_keys_bytes", "columns_to_entries"),
    "temporal": ("extract_column", "entry_diffs", "consolidate", "apply_state", "build_entries",
                 "bytes_to_pointers", "entry_keys_bytes", "hash_join_pairs", "columns_to_entries",
                 "entries_to_side"),
    "iterate": ("extract_column", "consolidate", "apply_state", "entry_keys_bytes",
                "hash_join_pairs", "columns_to_entries"),
    "serving": ("extract_column", "consolidate", "apply_state", "bytes_to_pointers",
                "entry_keys_bytes", "columns_to_entries"),
    "optimizer_auto": ("extract_column", "consolidate", "apply_state", "bytes_to_pointers",
                       "entry_keys_bytes", "hash_join_pairs", "columns_to_entries"),
    "engine_rows": ("session_overlay", "filter_truthy", "join_insert_inner", "match_pairs_i64",
                    "consolidate", "apply_state", "entries_to_side"),
}


def _host_cpu() -> dict:
    """The host CPU as ``/proc/cpuinfo``'s first processor block gives it, and the
    processor count."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _sep, value = line.partition(":")
            if key.strip() in ("model name", "vendor_id", "cpu family", "model", "stepping", "cpu MHz"):
                fields[key.strip()] = value.strip()
    fields["processors"] = os.cpu_count()
    return fields


def phase_native_build(card: Card) -> None:
    """``pathway_tpu_torch/native/enginecore.cpp`` built with g++ into ``_build/``, with
    the build's seconds, ``g++ --version`` and the host CPU; every kernel of the
    reference's table present, in its order. A failed build raises."""
    gxx = subprocess.run([_build.GXX, "--version"], capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    kernels = native.get()
    check(kernels is not None, f"native: the host kernels are disabled ({native.load_error()})")
    card.emit("native_build", seconds=native.build_seconds, wall_s=time.perf_counter() - t0,
              gxx=gxx.stdout.splitlines()[0], cpu=_host_cpu(), python=sys.version.split()[0],
              numpy=np.__version__, kernels=list(kernels.hit_counts()))
    check(list(kernels.hit_counts()) == list(NATIVE_KERNELS),
          f"native: kernels {list(kernels.hit_counts())}")


NATIVE_KERNELS = (
    "extract_column", "entry_diffs", "consolidate", "apply_state", "build_entries",
    "filter_truthy", "join_insert_inner", "pointers_to_bytes", "bytes_to_pointers",
    "entry_keys_bytes", "hash_join_pairs", "columns_to_entries", "hash_tuples_batch",
    "shard_values", "entries_to_side", "match_pairs_i64", "session_overlay",
)


class _NativeMark:
    """The host kernels' calls and nanoseconds since this mark (the counters are never
    reset, so a phase's counts and a comparison's stay apart)."""

    def __init__(self) -> None:
        self.hits, self.ns = native.hit_counts(), native.kernel_ns()

    def since(self) -> tuple[dict, dict]:
        hits, ns = native.hit_counts(), native.kernel_ns()
        return ({k: v - self.hits.get(k, 0) for k, v in hits.items() if v - self.hits.get(k, 0)},
                {k: v - self.ns.get(k, 0) for k, v in ns.items() if v - self.ns.get(k, 0)})


def _state_bits(state: tuple) -> tuple:
    """:func:`_final_state` as comparable values: numeric columns by dtype and bytes,
    string and object columns by their values (the host kernels give exact-object
    columns where the Python branch gives a str array)."""
    if state[0] != "columns":
        return state
    cols = tuple(tuple(c.tolist()) if c.dtype.kind in "OU" else (c.dtype.str, c.tobytes())
                 for c in state[2])
    return "columns", state[1].tobytes(), cols


def _native_both_ways(card: Card, workload: str, run, depth: dict, unit: str) -> dict:
    """``run() -> (outputs, seconds, units)`` with the host kernels, then once more under
    ``PATHWAY_TPU_DISABLE_NATIVE=1``. Checks: equal outputs, every kernel of the
    workload's path called in the first run, none in the second. Reports wall seconds,
    units/s and seconds a unit, and each kernel's calls and ns, both ways."""
    mark = _NativeMark()
    out_k, s_k, n = run()
    hits, ns = mark.since()
    gc.collect()
    mark = _NativeMark()
    out_p, s_p, n_p = _with_env({native.DISABLE_ENV: "1"}, run)
    plain_hits, plain_ns = mark.since()
    gc.collect()
    same = out_k == out_p
    card.emit("native", workload=workload, depth=depth, unit=unit, units=n,
              kernels_s=s_k, plain_s=s_p, kernels_per_s=n / s_k, plain_per_s=n_p / s_p,
              kernels_s_per_unit=s_k / n, plain_s_per_unit=s_p / n_p, plain_over_kernels=s_p / s_k,
              hit_counts=hits, kernel_ns=ns, kernel_s_total=sum(ns.values()) / 1e9,
              plain_hit_counts=plain_hits, plain_kernel_ns=plain_ns, equal_outputs=same)
    check(same and n == n_p, f"native: {workload}: the outputs differ with and without the host kernels")
    missing = [k for k in NATIVE_PATHS[workload] if not hits.get(k)]
    check(not missing, f"native: {workload}: kernels of its path never called: {missing}; calls {hits}")
    check(not plain_hits, f"native: {workload}: kernels ran under {native.DISABLE_ENV}=1: {plain_hits}")
    return {"kernels_s": s_k, "plain_s": s_p, "hits": hits, "ns": ns}


def phase_native_relational(card: Card, rows: dict) -> dict:
    """``relational``'s 1M-row groupby_sum and 500,000 x 50,000 join_inner (the
    device operators forced, as there), with the host kernels and on the Python
    branches; the output states must be equal."""
    phase_t0 = time.perf_counter()
    out = {}
    for name in ("groupby_sum", "join_inner"):
        n, run = _workload(name, rows)

        def timed(run=run, n=n):
            seconds, node = run()
            return _state_bits(_final_state(node)), seconds, n

        out[f"relational_engine/{name}"] = _with_device_ops("1", lambda: _native_both_ways(
            card, f"relational_engine/{name}", timed, {"rows": n}, "rows"))
    card.emit("native_phase", part="relational", seconds=time.perf_counter() - phase_t0)
    return out


def _engine_rows_run() -> tuple:
    """The engine's row-form paths at the Scope level, on the host operators: an upsert
    session (its overlay) filtered on a bool column (the row-form filter sweep), joined
    inner with a second session (the columnar join, and after the first retractions the
    dict arrangements and the insert-only delta) and counted by key. Even commits insert
    fresh keys, odd ones update the previous commit's rows."""
    scope = Scope()
    left, right = scope.input_session(3, upsert=True), scope.input_session(2)
    kept = scope.filter_table(left, 2)
    join = scope.join_tables(kept, right, [0], [0])
    counts = scope.group_by_table(join, by_cols=[0], reducers=[(make_reducer(ReducerKind.COUNT), [])])
    sched = Scheduler(scope)
    rng = np.random.default_rng(SEED + 14)
    t = 0.0
    for c in range(NATIVE_ROWS_COMMITS):
        ks = rng.integers(0, 4096, NATIVE_ROWS).tolist()
        flags = (rng.random(NATIVE_ROWS) < 0.75).tolist()
        for i in range(NATIVE_ROWS):
            left.insert(pw.ref_scalar("l", c - c % 2, i), (ks[i], c, flags[i]))
        for i in range(NATIVE_ROWS // 10):
            right.insert(pw.ref_scalar("r", c, i), (ks[i], float(i)))
        t0 = time.perf_counter()
        sched.commit()
        t += time.perf_counter() - t0
    join.current  # noqa: B018 — apply the lazy state inside the comparison
    out = {int(k): r for k, r in join.current.items()}, _state_bits(_final_state(counts))
    return out, t, NATIVE_ROWS_COMMITS * NATIVE_ROWS * 11 // 10


def phase_native(card: Card) -> dict:
    """The other workloads both ways, at the depths of ``NATIVE_*``: table_ops (50,000
    rows in 5 commits, forced device operators), temporal (Nexmark Q5, Q7, Q8 and the
    interval join over 20,000 events in 2 commits, forced), iterate (PageRank, 20 rounds,
    scale 10, forced), serving (1,024 docs through the MiniLM-L6 embedder into the index
    as 4 paced commits, 8 queries) and the optimizer's auto mode (relational_engine's
    program: 200,000 + 50,000 rows), and engine_rows (:func:`_engine_rows_run`, the host
    operators: 6 commits of 22,000 rows)."""
    phase_t0 = time.perf_counter()
    out = {}

    def table_ops():
        res = _table_ops_run(NATIVE_OPS_ROWS, NATIVE_OPS_COMMITS)
        check(all(res["same"].values()) and not res["failures"], f"native: table_ops {res['same']}")
        return res["out"], res["run_s"], NATIVE_OPS_ROWS

    out["table_ops"] = _with_device_ops("1", lambda: _native_both_ways(
        card, "table_ops", table_ops, {"rows": NATIVE_OPS_ROWS, "commits": NATIVE_OPS_COMMITS}, "rows"))

    ev = _nexmark_events(NATIVE_NEXMARK_EVENTS)

    def temporal():
        t0 = time.perf_counter()
        got, _routes = _nexmark_run(ev, NATIVE_NEXMARK_EVENTS // NATIVE_NEXMARK_COMMITS)
        seconds = time.perf_counter() - t0
        check(not got["failures"], f"native: temporal {got['failures']}")
        updates = [(r, a) for r, _t, a in got["q7_updates"]]
        return (_nexmark_final(got), updates), got["last_row"] - got["first_event"] or seconds, NATIVE_NEXMARK_EVENTS

    out["temporal"] = _with_device_ops("1", lambda: _native_both_ways(
        card, "temporal", temporal, {"events": NATIVE_NEXMARK_EVENTS, "commits": NATIVE_NEXMARK_COMMITS},
        "events"))

    u, v = _kronecker_edges(NATIVE_GRAPH_SCALE, GRAPH_EDGE_FACTOR)
    n_first = int(len(u) * PAGERANK_FIRST_SHARE)

    def iterate():
        got = _pagerank_run(u, v, n_first)
        bits = [{k: np.float64(x).view(np.int64).item() for k, x in c.items()} for c in got["commits"]]
        rounds = sum(r for _s, r in got["fixed_points"])
        return bits, sum(s for s, _r in got["fixed_points"]), rounds

    out["iterate"] = _with_device_ops("1", lambda: _native_both_ways(
        card, "iterate", iterate, {"vertices": 1 << NATIVE_GRAPH_SCALE, "edges": len(u),
                                   "rounds": PAGERANK_ROUNDS}, "rounds"))

    corpus = [doc_text(i) for i in range(NATIVE_SERVING_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)

    def serving():
        factory = _KeptKnnFactory(dimensions=DIM, capacity=NATIVE_SERVING_CAPACITY)
        obs, run = _engine_program(embedder, corpus, NATIVE_SERVING_DOCS, NATIVE_SERVING_QUERIES,
                                   factory, wait_s=120.0, pace=CHUNK)
        device_pipeline.PIPELINE.configure()
        run()
        check(not obs["failures"] and not obs["timeouts"], f"native: serving {obs['failures']}")
        docs = {doc_id: emb.tobytes() for doc_id, emb in obs["docs"].values()}
        answers = {q: tuple(map(int, ids)) for q, (ids, _e) in obs["answers"].items()}
        check(len(docs) == NATIVE_SERVING_DOCS and len(answers) == NATIVE_SERVING_QUERIES,
              f"native: serving {len(docs)} docs, {len(answers)} answers")
        return (docs, answers), obs["ingest_end"] - obs["run_start"], NATIVE_SERVING_DOCS

    out["serving"] = _native_both_ways(card, "serving", serving,
                                       {"docs": NATIVE_SERVING_DOCS, "queries": NATIVE_SERVING_QUERIES},
                                       "docs")
    del embedder

    def optimizer_auto():
        res = _relational_engine_run()
        check(res["out"] == res["want"], "native: optimizer auto: relational_engine's answer")
        return res["out"], res["run_s"], res["rows"]

    out["optimizer_auto"] = _with_env(
        {"PATHWAY_TPU_OPTIMIZE": "1", "PATHWAY_TPU_DEVICE_OPS": None},
        lambda: _native_both_ways(card, "optimizer_auto", optimizer_auto,
                                  {"rows": N_ENGINE * 5 // 4}, "rows"))
    out["engine_rows"] = _with_device_ops("0", lambda: _native_both_ways(
        card, "engine_rows", _engine_rows_run,
        {"rows_per_commit": NATIVE_ROWS * 11 // 10, "commits": NATIVE_ROWS_COMMITS}, "rows"))
    card.emit("native_phase", part="the rest", seconds=time.perf_counter() - phase_t0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--persistence-child"]:
        return _persistence_child(sys.argv[2:])
    if sys.argv[1:2] == ["--overhead-gate"]:
        return _overhead_child(sys.argv[2])
    if sys.argv[1:2] == ["--lockwatch-child"]:
        return _lockwatch_child(sys.argv[2:])
    if sys.argv[1:2] == ["--processes-child"]:
        return _processes_child(sys.argv[2:])
    t_script = time.perf_counter()
    card = Card()
    card.emit("device", name=card.name, count=card.count, torch=torch.__version__,
              cuda=torch.version.cuda)
    phase_build(card)
    phase_native_build(card)
    by_phase: dict = {}  # phase -> the host kernels' calls and ns during it
    phase_seconds: dict = {}  # phase -> its wall seconds

    def counted(name: str, fn, *args):
        mark = _NativeMark()
        t_phase = time.perf_counter()
        result = fn(*args)
        phase_seconds[name] = time.perf_counter() - t_phase
        hits, ns = mark.since()
        by_phase[name] = {"hit_counts": hits, "kernel_ns": ns}
        return result

    sass = phase_sass(card)
    fwd = phase_kernel(card)
    bwd = phase_train_kernel(card)
    phase_checkpoint(card)
    t0 = time.perf_counter()
    rel_rows = _relational_rows()
    card.emit("relational_rows", seconds=time.perf_counter() - t0, rows=N_REL)
    relational = counted("relational", phase_relational, card, rel_rows)
    native_paths = phase_native_relational(card, rel_rows)
    groupby_rows = rel_rows["groupby"]  # the observability phase's groupby commit
    del rel_rows
    gc.collect()
    relational_engine, engine_out, engine_rows_per_s = counted(
        "relational_engine", phase_relational_engine, card)
    sharded = counted("sharded", phase_sharded, card, engine_out, engine_rows_per_s)
    processes = counted("processes", phase_processes, card, engine_out, engine_rows_per_s)
    del engine_out
    serving = counted("main_path", phase_main_path, card)
    engine, parity, engine_docs_per_s = counted("engine_pipeline", phase_engine_pipeline, card,
                                                serving["docs_per_s"])
    observability = counted("observability", phase_observability, card, engine_docs_per_s,
                            groupby_rows)
    del groupby_rows
    watch = counted("watch", phase_watch, card, engine_docs_per_s)
    connectors = counted("connectors", phase_connectors, card)
    buses = counted("buses", phase_buses, card)
    databases = counted("databases", phase_databases, card)
    train = counted("train", phase_train, card)
    image_embedder = ImageEmbedder("vit-b16", max_batch_size=IMAGE_BATCH, seed=SEED)
    vision = counted("vision_parity", phase_vision_parity, card, image_embedder)
    multimodal = counted("multimodal_pipeline", phase_multimodal_pipeline, card, image_embedder)
    del image_embedder
    rerank = counted("rerank", phase_rerank, card)
    chat = counted("decode", phase_decode, card)
    counted("chat_engine", phase_chat_engine, card, chat)
    bge, vector_store = counted("vector_store", phase_vector_store, card)
    rag = counted("rag", phase_rag, card, chat, bge)
    rag_evals = counted("rag_evals", phase_rag_evals, card, chat, bge)
    del chat, bge
    table_ops = counted("table_ops", phase_table_ops, card)
    temporal = counted("temporal", phase_temporal, card)
    iterate = counted("iterate", phase_iterate, card)
    optimizer = counted("optimizer", phase_optimizer, card)
    persistence = counted("persistence", phase_persistence, card)
    native_paths.update(phase_native(card))
    fwd["launches"] = serving["launches"]
    fwd["launches_by_path"] = {"serving": serving["launches"], "engine": engine,
                               "engine_async_parity": parity,
                               "train": train[fwd["name"]], "vision": vision,
                               "multimodal": multimodal, "rerank": rerank,
                               "vector_store": vector_store, "rag": rag,
                               "rag_evals": rag_evals, "persistence": persistence["flash"],
                               "observability": observability["flash"], "watch": watch["flash"],
                               "connectors": connectors["flash"], "buses": buses["flash"],
                               "databases": databases["flash"], "sharded": sharded["flash"],
                               "processes": processes["flash"]}
    for row in bwd:
        row["launches"] = train[row["name"]]
        row["launches_by_path"] = {"train": train[row["name"]]}
    for row in (fwd, *bwd):
        row["tensor_core_instructions"] = sass[row["name"]]
    relational["launches_by_path"] = {"relational": relational["launches"],
                                      "relational_engine": relational_engine,
                                      "table_ops": table_ops, "temporal": temporal,
                                      "iterate": iterate, "optimizer": optimizer,
                                      "persistence": persistence["segment"],
                                      "observability": observability["segment"],
                                      "connectors": connectors["segment"],
                                      "buses": buses["segment"],
                                      "databases": databases["segment"],
                                      "sharded": sharded["segment"],
                                      "processes": processes["segment"]}
    card.emit("script", seconds=time.perf_counter() - t_script, phase_seconds=phase_seconds)
    print(json.dumps({"native": {"by_phase": by_phase, "both_ways": native_paths}}), flush=True)
    print(json.dumps({"kernels": [fwd, *bwd, relational]}), flush=True)
    print(card.smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card.name, "count": card.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
