PYTHON ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-slow test-fast test-launches test-shards test-cache \
	lint bench bench-pipeline bench-smoke bench-repair bench-disaster \
	bench-classes bench-shards bench-slo headline

# tier-1 verification command (slow interpret-mode kernel tests are
# deselected by pytest.ini; run them with `make test-slow`)
test:
	$(PYTHON) -m pytest -x -q

# the slow interpret-mode Pallas kernel sweeps only
test-slow:
	$(PYTHON) -m pytest -x -q -m slow

# dispatch-regression lane (also a CI job): a put window must stay
# O(1) gear + O(1) SHA-1 + O(buckets) GF launches with no gear retraces,
# a storm repair pass must stay O(buckets) per sub-batch, not O(chunks)
# (including whole-cluster re-placement drains and scrub sweeps), and a
# mixed-storage-class window must stay O(code buckets x length buckets),
# never O(files)
test-launches:
	$(PYTHON) -m pytest -x -q tests/test_ingest.py tests/test_repair.py \
		tests/test_classes.py tests/test_disaster.py

# sharded-control-plane lane: ShardMap mechanics + the N-shard-vs-
# 1-shard differential proof harness (all engines, mid-trace add/drain),
# then the core store/scheduler suites re-run sanitized with 3 control
# shards so the per-shard launch model and shard-ledger conservation
# checks run live on every window
test-shards:
	$(PYTHON) -m pytest -x -q tests/test_shards.py
	SEARS_SANITIZE=1 SEARS_SHARDS=3 $(PYTHON) -m pytest -x -q \
		tests/test_store.py tests/test_scheduler.py

# block-cache lane: BlockCache mechanics, write-back ack/drain/delete
# ordering, shard-drain + cluster-loss barriers, scheduler priority
# lanes + admission control, and the cache-on-vs-off differential
# proof -- then the whole suite again with the runtime sanitizer's
# cache-ledger audit live on every window
test-cache:
	$(PYTHON) -m pytest -x -q tests/test_cache.py
	SEARS_SANITIZE=1 $(PYTHON) -m pytest -x -q tests/test_cache.py

# searslint: begin-purity, dispatch hygiene, counter coverage, plan
# determinism, cache discipline (exits 1 on any unwaivered finding)
lint:
	$(PYTHON) -m repro.lint src tests benchmarks
	$(PYTHON) -m repro_torch.lint src/repro_torch tests

# skip the slow model/kernel suites; storage core only
test-fast:
	$(PYTHON) -m pytest -x -q tests/test_store.py tests/test_engine.py \
		tests/test_scheduler.py tests/test_ingest.py \
		tests/test_repair.py tests/test_classes.py \
		tests/test_disaster.py \
		tests/test_gf256_rs.py tests/test_chunking_hashing.py \
		tests/test_workload_binding.py tests/test_system.py \
		tests/test_lint.py tests/test_sanitizer.py tests/test_shards.py \
		tests/test_cache.py

# full paper-claim benchmark battery (results/bench.json)
bench:
	$(PYTHON) -m benchmarks.run

# per-chunk vs batched data-plane comparison (BENCH_pipeline.json)
bench-pipeline:
	$(PYTHON) -m benchmarks.run --only pipeline_bench

# quick CI smoke: data-plane pipeline + cross-user scheduler + control
# sharding + storm repair + disaster recovery + storage-class + block
# cache/SLO benchmarks (BENCH_pipeline.json + BENCH_scheduler.json +
# BENCH_shard.json + BENCH_repair.json + BENCH_disaster.json +
# BENCH_classes.json + BENCH_slo.json)
bench-smoke:
	$(PYTHON) -m benchmarks.run --only pipeline_bench,scheduler_bench,shard_bench,repair_bench,disaster_bench,class_bench,slo_bench

# failure-storm repair: per-chunk vs batched cross-cluster rebuild on
# both engines (BENCH_repair.json)
bench-repair:
	$(PYTHON) -m benchmarks.run --only repair_bench

# disaster recovery: whole-cluster-loss rebuild throughput, scrub
# overhead, and the repair-throttle SLO gate (BENCH_disaster.json)
bench-disaster:
	$(PYTHON) -m benchmarks.run --only disaster_bench

# storage classes: realtime-vs-archival retrieval/overhead trade-off and
# mixed-window launch economics on both engines (BENCH_classes.json)
bench-classes:
	$(PYTHON) -m benchmarks.run --only class_bench

# block cache & SLO: zipf cache-hit latency, write-back put-ack
# deferral, and the two-class admission-control knee sweep
# (BENCH_slo.json)
bench-slo:
	$(PYTHON) -m benchmarks.run --only slo_bench

# control-plane sharding: 1/2/4-shard flush windows must produce
# byte-identical artifacts at O(buckets)-per-sub-window launch cost
# (BENCH_shard.json)
bench-shards:
	$(PYTHON) -m benchmarks.run --only shard_bench

# headline 3 MB retrieval claim; ENGINE=numpy|kernel
ENGINE ?= numpy
headline:
	$(PYTHON) benchmarks/headline_3mb.py --engine $(ENGINE)
