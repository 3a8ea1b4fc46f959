"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before
the result line:

  1. device   - the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build    - every CUDA kernel of the port (csrc/*.cu), built from the
                sources in this checkout with nvcc for sm_90a, one nvcc per
                source, all started together;
  3. kernels  - each kernel against its plain PyTorch version on the card,
                at ragged shapes, edge cases (ties, one repeated id, empty
                batches) and the main path's full shapes: the bf16 fused
                scan at B 1-256 (one CTA, whole and ragged clusters of
                query tiles) and L 128, 512 and 4,096 with and without a
                mask and a bound inside a block, planted exact ties at B=8
                and 64, the runner-up sequence (v, v, then 2v in bins 3,
                5 and L-1: scored, masked, past the bound) at B=8 and 64
                and over the 2,262,292-row catalog, then its times at B=8,
                64 and 256 and L=512, 4,096 and 8,192 beside its bound;
                the int8 fused
                scan at B=8, 13 and 64 over the full 2,265,088-column
                catalog with planted copies of one vector, and at B=8
                with a planted runner-up sequence (v, v, then 2v in one
                bin) and with a bound inside a block, gather_pool at
                its launch plan's edges on this card (float32 D 1-256 and
                bf16 D 8-64, B at a pass of a small and of a large launch
                and at the last pass of two full CTAs an SM, each +-1, -1 and
                clamped ids, K=1 exactly equal, K=5 within POOL_TOL; a
                100M x 32 bf16 table past 2^31 elements), scatter_add's
                vector and generic instantiations (D 4, 6, 32, 64 and
                128, updates one float off a 16-byte boundary, ids -1
                and R, untouched rows bit-equal) and at a pile-up, the
                shared-memory scatter against its plain version and
                scatter_add at the album table, at both edges of its CTA
                row ranges (rows hit once bit-equal) and at a pile-up
                (and its refusal of the artist table); then the generic
                kernels of csrc/fused_generic.cu (the widths and slot
                counts the tuned kernels lack): the bf16 and int8 scans
                at D 8, 24, 48, 100, 256, 300 and 768, B 1, 13 and 65, L
                128, 512 and 2,048, with neither mask nor bound and with
                both, planted copies of one vector (exact ties, ids
                equal) and the runner-up sequence v, v, 2v; the affinity
                at D 16, 48 and 256 with C 1, 5, 9 and 16, planted
                copies and the membership edge cases; values within
                width_tol (TOL plus the float32 summation-order bound of
                D products); the dispatch by the launch counters (tuned
                at D 16-128, the affinity at D 32-128 with C <= 8,
                generic elsewhere); the scans' times at B=8 and 64 over
                a random 2,262,292 x 256 catalog at L=4,096 beside their
                byte bounds;
  4. train    - the main path's training half: the quality flagship
                (feature_size 32, 100,000 album buckets, 295,861 artists,
                B=2048, C=5, M=32, a shared pool of 512 negatives,
                row-sparse steps with the dense momentum carrier, SGD
                momentum 0.98 at lr 0.004, bf16 scoring), initialised from
                seed 0, trained 20 steps through the gather and scatter-add
                kernels, with one fused recall@500 eval round over 2,048
                playlists against all 2,262,292 tracks (the affinity
                kernel), then exported; then the exact eval on the same
                playlists, K steps with the kernels against K steps with
                their plain versions from one state, gather_pool and
                scatter_add timed at the step's shapes (scatter_add also
                with every id on one row), and a torch.profiler breakdown
                of one step (scatter_add's device time in it);
  5. harness  - the training entry point at the same full width:
                workloads/playlist.train() from packed shards written
                by full_scale_run.write_packed_shards (2 x 65,536
                playlists and an eval shard of 8,192: the data set cut,
                not its widths) to step 20, with checkpoints at 10 and 20,
                one fused eval round and the export, through the three
                training kernels; checkpoint 20 restored bit for bit into
                a fresh state; a resume to step 30; a run stopped at step
                15 by a managed PreemptionGuard, then resumed; and the
                CLI (python -m esrecsys_tpu_torch.workloads.playlist) on
                TFRecords that the port's ETL wrote, in a subprocess;
                host-feed examples/s beside the device feed's, checkpoint
                bytes and seconds, the stop-to-return seconds and the
                TFRecord reader's records/s;
  5b. wide    - the main path at feature_size 128 (a 256-wide catalog),
                every other width the flagship's: 5 steps, one fused
                recall@500 eval round over the 2,262,292 tracks through
                fused_affinity_generic (D=256), the export; the fused
                eval against the exact one on 256 of its playlists
                (overlap@500, floor 0.99) and the affinity kernel against
                its plain version there, timed at the whole eval batch
                beside its operation bound; the artifact served top-500
                at B=8 fused (fused_scan_generic) and fused int8
                (fused_scan_int8_generic) against the exact service,
                overlap@500 at least 0.99 and 0.98, 20 timed calls each,
                the tuned scans launched no time; both scans at the
                served shape beside their byte bounds;
  6. serve    - the trained artifact loaded, its catalog embedded and
                served top-500 by the fused and the exact RetrievalService,
                64 queries through topk and several HTTP requests through
                serve(port=0); overlap@500 of fused against exact, timings,
                and a torch.profiler breakdown of one served call;
  7. int8     - the same catalog served in the four int8 modes (int8,
                int8+r8, fused int8, fused int8+r8) and one HTTP request
                through serve(fused, quantized, rescore_int8); the device
                quantizer against its numpy twin over the whole catalog,
                overlap@500 of each mode against exact, B=8 latency and a
                breakdown of each;
  8. modes    - the full-scan modes and the catalog lifecycle on the same
                catalog: approx and int8+approx at B=8, k=500 (overlap@500
                against exact at least 0.95, latency, breakdown, L, r and
                kb; one block's select on the card against the CPU, with
                planted ties); add_capacity 65,536 in the exact, approx,
                fused and fused int8 modes, 4 adds of 1,024 rows, answers
                equal to a fresh service on the grown catalog and no
                buffer reallocated; a live fused server reloaded under
                traffic to the perturbed catalog (no failed request); a
                deploy cycle of full_scale_run (20 steps, then 10, the
                result reloaded into a live approx server); serving_bench at
                2,262,292 x 64, k=500, batch 256 over every ported mode,
                against its overlap floors;
  9. sublinear - the IVF and PQ modes on the same catalog at the bench's
                defaults (4,096 cells, nprobe 64, 10 iterations; S=8, 256
                codes, 15 iterations, oversample 64): both structures
                built on the card (seconds, imbalance, Lmax); ivf,
                ivf+int8, pq, ivf+pq, pq+r8 and ivf+pq+r8 served at B=8,
                k=500 (latency, busy and idle device time, largest ops,
                overlap@500 against exact); an IVF service probing all of
                its 64 cells and a pq service rescoring every row equal to
                exact; time to first query from prebuilt npz against a
                build; a live ivf_pq server reloaded under traffic with
                aux rebuild, then reuse (no failed request); a pq service
                grown by 4 adds of 1,024 rows equal to one over the grown
                catalog; serving_bench --structured over the six modes,
                then ivf and ivf+int8 with --ivf_max_cell 1024, against
                their floors; a deploy cycle into a live ivf_pq server with
                aux reuse; then scatter_add at the IVF and PQ centroid-sum
                pile-ups and gather_pool at the IVF candidate shape
                against their plain versions;
  10. tool    - the port's scatter_attempt (shared-memory scatter,
                scatter_add, index_add_ at the album table and a half-size
                one), then the shared-memory scatter timed at the album
                table and with every id on one row;
  11. lazy    - the lazy momentum carrier at the flagship's full width:
                20 float32 steps under the lazy and the dense carrier from
                one init on the same batches and negatives, the lazy
                tables flushed (settled_params) against the dense ones;
                the flagship (bf16) trained 20 steps under the lazy
                carrier through full_scale_run with one fused recall@500
                eval round and the export (the settled model), fused
                against exact eval, a bit-exact checkpoint round trip and
                both carrier adaptations; the dense against the lazy step
                on the host clock with the device's busy share, at the
                flagship and at 10,000,000 album buckets (where "auto" is
                lazy); a short flagship_quality_bench; then, the earlier
                tensors freed, gather_pool and scatter_add against their
                plain versions on a 100M x 32 float32 table (row offsets
                past 2^31 elements) and scale_table at that width with
                momentum 0.98;
  12. bf16    - bf16 tables: gather_pool's bf16 and narrow instantiations
                (bf16 D in 8, 32, 64, 128 and 1, 3, 12; float32 D 1, 3, 6;
                tables one element off a 16-byte boundary) bit-equal to
                their plain versions at K=1, scatter_add's bf16 ones (D 32,
                64, 128 vector, 1, 3, 8 generic) bit-equal on rows hit once
                and within a bf16 bound on rows hit more, at an exactly
                representable pile-up bit-equal and at a random one within
                the bound; both on a 100M x 32 bf16 table; then the main
                path, scale_table --dtype bfloat16 at 100M x 32 with
                momentum 0 and 0.98 (rows/s, ms/step, peak memory under 14
                GB), the row kernels timed at its step's shapes, and 20
                lazy steps on a 1M x 32 bf16 table with bf16 moments
                against the same steps through the plain versions;
  13. glove   - the GloVe trainer at the reference's width (565,537 tokens
                padded to 565,632 x 64, B=2048, lr 5e-4): a 500,000-token
                dictionary and 200,000 co-occurrence triples with Zipf ids
                written by the port's recordio; workloads/glove.train()
                for 20 steps under adam and under lazy_adam, each with one
                eval round of 50 batches (its loss below the init's), the
                knn hook on the six probe terms, a checkpoint restored bit
                for bit and the export; each step on the host clock with
                the device's busy share; the row kernels at the step's
                shapes (D=64 and D=1); the dense step against its
                plain-version twin for 5 steps;
  14. wiki    - the Wikipedia pipeline: (a) the ETL chain in the port's
                code on a synthetic MediaWiki dump of 400 pages (cut
                from about 20,000 for the time limit; 300-600 Zipf tokens
                over a 200,000-word lexicon, 5-30 links, redirects,
                Template: pages): pages, token documents (native tokenizer), both
                dictionaries, token co-occurrence (native accumulator,
                equal to the Python one on a shard), the three
                sparse-document conversions, url co-occurrence, codex and
                dump_correlates, GloVe train() and txt2url train() from
                its checkpoint for 5 steps each, seconds and pages/s per
                stage; (b) txt2url at the reference's full width (565,537
                x 64 word and 1,000,000 x 64 URL tables, B=64, L=32,
                LSTM, margin, RMSprop 1e-3) on synthetic Zipf shards:
                train() for 20 steps with GloVe transfer from a port
                checkpoint, one eval round of 16 batches with recall@10
                over all URLs, both probe hooks, a checkpoint restored bit
                for bit and the export; 5 steps with the kernels against
                5 with their plain versions under margin, softmax and
                reference_exact (LSTM) and margin (mean); the encoder
                against float64 on the CPU; the step on the host clock
                with its device breakdown; the row kernels at the step's
                ids (the pad row's pile-up) against their plain versions
                and timed against index_select / index_add_.

  15. stl     - the Shop-the-Look pipeline at the reference run's full
                width (512 px, filters (16, 32, 64, 128), output 64, B=16
                triplets, 5 negatives, Adam 1e-4, bf16 towers): 1,024
                scene/product pairs (2,048 JPEGs, 400 x 300-700 px,
                4:2:0, 4:4:4 and grayscale, quality 75-95, some restart
                intervals) written by the port's writer; the decoder's
                images/s on 1 and on all threads; the towers on the card
                (float32 with TF32 off, bf16) against float64 on the CPU;
                train() for 20 steps with one eval round, a checkpoint
                restored bit for bit and the export; the step on the host
                clock fed by the decoding pipeline, from batches decoded
                in advance and from the device, with its device
                breakdown; both indexes from the artifact; recommend for
                100 scenes against a float64 brute force; a txt2url
                model trained 20 steps at width 64 and exported; serve()
                with the text and image_key encoders, fused (256 bins)
                and exact, their HTTP answers against encoder + topk and
                float64; the STL CLI (index, recommend) and
                random_recommender as subprocesses, fetch_images from a
                local http.server; fused_scan and gather_pool at the
                phase's shapes against their plain versions. Before the
                corpus: every committed JPEG fixture of
                tests/torch_fixtures/jpeg (progressive files of each
                subsampling, with restart markers and with unrefined
                scans, CMYK and YCCK files) decoded on the host and held
                byte for byte against its stored TensorFlow decode; the
                three corpus-sized ones (two progressive, one CMYK) then
                replace three of the corpus's files, so train() and the
                indexes read them; progressive against baseline decoding
                in images/s on 1 and all threads.
  16. mesh    - a world of one rank on NCCL (a file:// rendezvous) and the
                playlist's sharded code on a 1x1 mesh at the flagship's
                full width (as in train, exact eval): one step from one
                state, whose rows (owner gathers summed over the model
                group), row gradients, local ids and gathered updates are
                bit-equal to the unsharded step's; 20 sharded steps
                (through gather_pool and scatter_add) against 20
                unsharded ones from the same init, batches and negatives,
                within the bounds of the train phase's kernel-against-plain
                check, beside the spread of two unsharded runs (the
                scatter's atomics sum duplicate rows in a run-dependent
                order); one sharded eval round (the corpus matrix
                reduced into its shard, the sharded top-k) over all
                2,262,292 tracks whose top-500 ids and scores equal the
                unsharded exact eval's; host ms per step of both, and the
                collectives' share of the sharded step's device time from
                torch.profiler.
  17. calibrate - run after the sublinear phase, on its trained catalog:
                the port's tools at their full widths. retrieval_autotune
                on the 2,262,292 x 64 catalog (k=500, target 0.95, 256
                calibration queries, k-means on a 262,144-row sample,
                queries/s measured on the card), every row's recall and
                q/s and the build seconds, the recommendation served
                against the exact top-500 of 64 fresh queries;
                parity_runs for the four workloads at the tool's widths
                (playlist D=32 / 20,000 / 5,000 at B=1 and B=2048, GloVe
                20,000 x 64, STL 32 px, txt2url 2,000 URLs; steps cut);
                playlist_parity_sweep --mode bayes for 6 runs of 8 steps;
                scaling_study --mode measure on one NCCL rank; then
                fused_scan at B=64 over the catalog at L=512 and 8,192,
                gather_pool at the IVF probe of 64 queries and
                scatter_add at the 1,024-cell k-means sums against their
                plain versions, timed against their bounds.

Each main-path phase (train, harness, wide, serve, int8, modes, sublinear, tool,
lazy, bf16's scale_table runs, glove's train() runs, wiki's chain and its
train() runs, stl's corpus-to-served-answers path, mesh's sharded steps
and eval, calibrate's tools) sets the launch counts
to 0 just before it and reads them just after.
A line gives the seconds each phase took. The second-to-last line is the
kernel table as JSON, the last line ``{"ok": true, "device": {...}}``.
Row-kernel times come from profiler traces; an entry of the kernel table
that holds a time from a trace that lost rows says ``"timer":
"profiler_per_launch"``, one from the CUDA-event fallback (the traces
held no device rows) ``"timer": "cuda_events"``.
Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor rate
TOL = 1e-5                    # kernel vs plain: absolute and relative
QUALITY_FLOOR = 0.99          # fused overlap@500 against exact
INT8_FLOOR = 0.98             # int8 modes' overlap@500 against exact
POOL_TOL = 1e-6               # pooled lookup: K float32 rows in two orders
# 76,288 float32 adds into one row in two orders: partial sums reach about
# 3, so the two sums may part by about sqrt(n) float32 ulps of 3
PILEUP_ATOL = 5e-4
# smem_scatter's previous design (whole table copied through shared memory,
# every CTA reading every id) at the album table with the L2 cache flushed:
# its time in PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700.00 W),
# logged beside this run's time, not re-run
SMEM_SCATTER_PREVIOUS_MS = 0.0350
# fused_affinity's previous (mma.sync) design at the eval shape: PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W; logged beside the new time, not re-run
AFFINITY_PREVIOUS_MS = 17.646
# fused_scan_int8's previous design (the int8 branch of fused_scan.cu: two
# mma.sync warps a CTA, cp.async copies) at the served shape: PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W; logged beside the new time, not re-run
FUSED_SCAN_INT8_PREVIOUS_MS = 0.1635
# scatter_add's previous design (one thread and one scalar atomic per
# element) at the step's shapes, L2 flushed, mean of the two tables: PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W; logged beside the new time, not re-run
SCATTER_ADD_PREVIOUS_MS = 0.01561
# gather_pool's previous design (one thread a 16-byte piece, ceil(B*P/256)
# CTAs of 256, one dependent load in flight a thread) at the step's shapes,
# L2 flushed: PERF.md, NVIDIA H100 80GB HBM3 at 700 W; logged beside the
# new time, not re-run
GATHER_POOL_PREVIOUS_MS = 0.00917
# gather_pool against index_select at the 192-id URL tables of txt2url and
# the mesh: this many runs of each, in turns, and their medians
SMALL_RUNS = 5
GATHER_SMALL = {}             # shape -> medians and runs
# fused_scan against its plain version at these batches: one query tile,
# one cluster of tiles, eight, and more clusters with the last one short
SCAN_BATCHES = (1, 8, 9, 13, 57, 64, 65, 200, 256)
# fused_scan timed at these batches and bins over a 2,262,292-row catalog
SCAN_TIMED = ((8, 64, 256), (512, 4096, 8192))
STEPS = 20                    # training steps of the main path
K_STEPS = 5                   # steps compared, kernels against plain
# the harness phase's data set: packed shards of synthetic playlists at the
# flagship's widths (572 bytes a playlist at C=5, M=32), cut in size only
HARNESS_SHARDS = 2
HARNESS_SHARD_EXAMPLES = 65_536
HARNESS_EVAL_EXAMPLES = 8_192
PREEMPT_AT = 15               # the step at which the harness stops a run
# kernels against plain over K steps: atomics sum duplicate rows in
# another order, and a last-ulp difference in a table value can flip its
# bf16 rounding, which moves one gradient element by a bf16 ulp; tables
# and momentum must agree within these bounds, and at most this share of
# their elements may differ by more than 1e-6 (a scatter into a wrong row
# would move whole rows)
TRAIN_TABLE_ATOL = 1e-5
TRAIN_MOMENTUM_ATOL = 2e-4
TRAIN_DIFF_SHARE = 1e-4
# the lazy carrier plus a flush against the dense carrier, 20 float32 steps
# from one init: the same trajectory up to float32 rounding (duplicate-row
# gradients summed in another order; the catch-up's closed form for
# mu + ... + mu^k against k multiplications); tables start near 0.18
LAZY_LOSS_RTOL = 1e-5
LAZY_TABLE_ATOL = 1e-5
LAZY_MOMENTUM_ATOL = 1e-4
CARRIER_STEPS = 20            # steps timed per carrier and turn (cut
                              # from 30 for the generic and wide phases)
BIG_BUCKETS = 10_000_000      # album buckets where "auto" is lazy (1.28 GB)
SCALE_ROWS = 100_000_000      # scale_table's full width: 100M x 32 float32
SCALE_IDS = 262_144


TRACE_TRIES = 6               # profiler traces of one timing, at most
TRACE_PAUSE_S = 0.2           # pause after a trace with no device rows


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms (fn must end in a device sync)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def device_breakdown(fn, reps: int):
    """Profile ``reps`` calls of ``fn`` (each ending in a device sync):
    (wall ms per call, device-busy ms per call, [(op, device ms per call)]
    largest first). Busy time sums the device rows of the trace (kernels
    and copies); None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, e.self_device_time_total / 1e3 / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not rows:
        return wall_ms, None, []
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows


def compare_top2(kv, ki, pv, pi, identical, score, near_tol,
                 value_tol=None):
    """Kernel (kv, ki) against plain (pv, pi) per-bin top-2 candidates.
    Values agree within TOL, or, with ``value_tol(b, g, s)``, within that
    per-slot tolerance of the plain value s of item g for query b. Ids
    agree, except in near-tie slots whose two items score within
    ``near_tol(score)`` (or ``value_tol``) of each other in a third
    (float32 elementwise) order, ``score(b, g)``: another summation order
    may flip such a near-tie. Two items with identical inputs
    (``identical(gk, gp)``) score bit-equal in both versions, where the
    strict-'>' rule decides, so their ids must match. A zero gap in the
    third order proves no such tie. Returns (max abs error, near-tie
    slots, slots holding an exact tie)."""
    import torch

    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError("kernel and plain disagree on which slots "
                             "are filled")
    if value_tol is None:
        torch.testing.assert_close(kv[fin], pv[fin], atol=TOL, rtol=TOL)
    else:
        b, slot = fin.nonzero(as_tuple=True)
        gap = (kv[b, slot] - pv[b, slot]).abs()
        tol = value_tol(b, pi[b, slot].long(), pv[b, slot])
        if bool((gap > tol).any()):
            worst = int((gap - tol).argmax())
            raise AssertionError(
                f"{int((gap > tol).sum())} values differ past their "
                f"tolerance; worst {float(gap[worst])} against "
                f"{float(tol[worst])}")
    if not torch.equal(ki[~fin], pi[~fin]):
        raise AssertionError("ids of unfilled slots differ")
    err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    L = pv.shape[1] // 2
    exact_ties = int((fin[:, L:] & (pv[:, :L] == pv[:, L:])).sum())
    diff = (ki != pi) & fin
    near = int(diff.sum())
    if near:
        b, slot = diff.nonzero(as_tuple=True)
        gk, gp = ki[b, slot].long(), pi[b, slot].long()
        same = identical(gk, gp)
        if bool(same.any()):
            raise AssertionError(
                f"{int(same.sum())} ids differ between items with identical "
                f"inputs: the earlier-block-wins rule is broken")
        s_p = score(b, gp)
        gap = (score(b, gk) - s_p).abs()
        limit = (near_tol(s_p) if value_tol is None
                 else value_tol(b, gp, s_p))
        if bool((gap > limit).any()):
            raise AssertionError(
                f"{near} id mismatches, worst score gap {float(gap.max())}")
    return err, near, exact_ties


def chunked(fn, b, g, chunk: int = 8192):
    """``fn(b, g)`` over index vectors b, g in chunks (a (n, D) gather of
    every filled slot at D=768 would take gigabytes)."""
    import torch

    if b.numel() <= chunk:
        return fn(b, g)
    return torch.cat([fn(b[i:i + chunk], g[i:i + chunk])
                      for i in range(0, b.numel(), chunk)])


def width_tol(dim: int, sum_abs):
    """The value tolerance of a kernel at any width (the generic checks):
    TOL absolute and relative, plus 2 dim 2^-24 times the sum of the
    magnitudes of the ``dim`` products, ``sum_abs(b, g)``: the bound on how
    far two float32 summation orders of those products can part (each is
    within dim u of the exact sum of magnitudes, u = 2^-24). TOL alone was
    stated for D=64; at D=256 an item whose products cancel to a small
    score parts by more (up to 3e-4 measured)."""
    return lambda b, g, s: (TOL + TOL * s.abs()
                            + 2 * dim * 2.0 ** -24 * chunked(sum_abs, b, g))


def compare_candidates(q, packed, kv, ki, pv, pi, scales=None, wide=False):
    """fused_scan (bf16 ``packed``) or fused_scan_int8 (int8 ``packed``
    with its ``scales``) against its plain version (compare_top2); with
    ``wide``, values within ``width_tol``."""
    def identical(gk, gp):
        same = (packed[:, gk] == packed[:, gp]).all(0)
        return same if scales is None else same & (scales[gk] == scales[gp])

    def score(b, g):
        s = chunked(lambda bb, gg: (q.float()[bb]
                                    * packed[:, gg].T.float()).sum(-1), b, g)
        return s if scales is None else s * scales[g]

    def sum_abs(b, g):
        s = (q.float()[b].abs() * packed[:, g].T.float().abs()).sum(-1)
        return s if scales is None else s * scales[g]

    return compare_top2(kv, ki, pv, pi, identical, score,
                        lambda s: TOL + TOL * s.abs(),
                        width_tol(packed.shape[0], sum_abs) if wide else None)


def runner_up_items(gen, M: int, D: int, L: int, bins, B: int = 8):
    """A random catalog of M float32 items where each of ``bins`` holds one
    vector v in blocks 0 and 1 and 2v in block 2, with B queries near v:
    every query scores 2v first and the block-1 copy of v second under the
    sequential fold (a merge of per-block top-2 lists by lowest id would
    keep the block-0 copy). Returns (q (B, D) bf16, items)."""
    import torch

    items = torch.randn(M, D, generator=gen, device="cuda")
    v = 3 * torch.randn(D, generator=gen, device="cuda")
    for j in bins:
        items[j] = items[j + L] = v
        items[j + 2 * L] = 2 * v
    q = v + torch.randn(B, D, generator=gen, device="cuda")
    return q.to(torch.bfloat16), items


def check_runner_up(ki, L: int, bins, lead: int, what: str) -> None:
    """The planted bins keep (v or 2v at block ``lead``, block-1 v)."""
    for j in bins:
        want = (j + lead * L, j + L)
        got = (ki[:, j], ki[:, L + j])
        if not all(bool((g == w).all()) for g, w in zip(got, want)):
            raise AssertionError(f"runner-up sequence ({what}), bin {j}: "
                                 f"ids {got[0].tolist()}, {got[1].tolist()}, "
                                 f"want {want}")


def scan_against_plain(card: str, q, packed, L: int, bound: int, mask,
                       what: str, dup: bool = False) -> tuple:
    """fused_scan against fused_scan_plain on one input; logs the case.
    Returns (max abs error, kernel ids)."""
    import torch

    from esrecsys_tpu_torch.kernels.fused_scan import (fused_scan_cuda,
                                                       fused_scan_plain)

    kv, ki = fused_scan_cuda(q, packed, L, bound, mask)
    pv, pi = fused_scan_plain(q, packed, L, bound, mask)
    torch.cuda.synchronize()
    err, near, exact = compare_candidates(q, packed, kv, ki, pv, pi)
    if dup and exact == 0:
        raise AssertionError(f"{what}: the duplicate-items case holds no tie")
    log(f"kernel fused_scan B={q.shape[0]} D={q.shape[1]} "
        f"Mp={packed.shape[1]} L={L} bound={bound} mask={mask is not None}"
        f" {what}: ok, max_abs_err {err:.3g}, exact-tie slots {exact} (ids "
        f"equal there), near-tie id slots {near} [{card}]")
    return err, ki


def scan_runner_up(card: str, gen, M: int, D: int, L: int, B: int) -> float:
    """fused_scan against its plain version on runner_up_items in bins 3,
    5 and L - 1, the 2v items scored, masked and past the bound, the
    planted ids checked; returns the largest error."""
    import torch

    from esrecsys_tpu_torch.retrieval.fused import pack_catalog

    bins = (3, 5, L - 1)
    q, planted = runner_up_items(gen, M, D, L, bins, B)
    packed = pack_catalog(planted, L)
    del planted
    worst = 0.0
    # (case, bound, keep the 2v items, lead block): the 2v items scored,
    # masked out, and past a bound that ends inside block 2 (they lie at
    # 2L + j, so a bound of 2L + 3 leaves out every planted one)
    for name, bound, keep, lead in (("2v scored", M, True, 2),
                                    ("2v masked", M, False, 0),
                                    ("2v past the bound", 2 * L + 3, True,
                                     0)):
        msk = None
        if not keep:
            msk = torch.ones(packed.shape[1], dtype=torch.bool, device="cuda")
            msk[[j + 2 * L for j in bins]] = False
        err, ki = scan_against_plain(
            card, q, packed, L, bound, msk,
            f"runner-up sequence v, v, 2v in bins {bins}, {name}")
        check_runner_up(ki, L, bins, lead, name)
        worst = max(worst, err)
    return worst


def scan_bound(B: int, D: int, mp: int, L: int) -> tuple:
    """fused_scan's least time in ms on the card and what sets it: the
    catalog read once, the queries read, the (B, 2L) values and ids
    written; 2 B D operations per column."""
    moved = D * mp * 2 + B * D * 2 + B * 2 * L * 8
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2 * B * D * mp / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scan_timings(card: str, items, reps: int = 20) -> dict:
    """fused_scan's time (CUDA events, mean of ``reps``) at each of
    SCAN_TIMED's batches and bins over ``items``, beside its bound."""
    import torch

    from esrecsys_tpu_torch.kernels.fused_scan import fused_scan_cuda
    from esrecsys_tpu_torch.retrieval.fused import pack_catalog

    gen = torch.Generator(device="cuda").manual_seed(2)
    M, D = items.shape
    qs = torch.randn(max(SCAN_TIMED[0]), D, generator=gen,
                     device="cuda").to(torch.bfloat16)
    out = {}
    for L in SCAN_TIMED[1]:
        packed = pack_catalog(items, L)
        mp = packed.shape[1]
        for B in SCAN_TIMED[0]:
            q = qs[:B]
            ms = cuda_ms(lambda: fused_scan_cuda(q, packed, L, M), reps)
            bound_ms, bound_by = scan_bound(B, D, mp, L)
            out[f"B{B}_L{L}"] = {"ms": ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by}
            log(f"kernel fused_scan time B={B} D={D} Mp={mp} L={L}: "
                f"{ms:.4f} ms (mean of {reps}, CUDA events), bound "
                f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.3f} of "
                f"bound speed [{card}]")
        del packed
    return out


def phase_kernels(card: str) -> tuple:
    """fused_scan against its plain version: ragged batches (one, two,
    eight and more clusters of query tiles, the last one short) at three
    bin counts with and without a mask and a bound inside a block, planted
    exact ties, the kernel's four dims, the runner-up sequence of the
    sequential fold, the full 2,262,292-row catalog; then its times at
    SCAN_TIMED's shapes over that catalog. Returns (max abs error, times)."""
    import torch

    from esrecsys_tpu_torch.retrieval.fused import pack_catalog

    gen = torch.Generator(device="cuda").manual_seed(1)
    D, M = 64, 100_003
    items = torch.randn(M, D, generator=gen, device="cuda")
    mask_m = torch.rand(M, generator=gen, device="cuda") > 0.3
    worst = 0.0
    for L in (128, 512, 4096):
        packed = pack_catalog(items, L)
        Mp = packed.shape[1]
        mask = torch.zeros(Mp, dtype=torch.bool, device="cuda")
        mask[:M] = mask_m
        for B in SCAN_BATCHES:
            q = torch.randn(B, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
            for bound, msk in ((M, None), (97_001, mask)):
                worst = max(worst, scan_against_plain(
                    card, q, packed, L, bound, msk, "random")[0])
    # copies of one vector in later blocks of its bin (g, g + L, g + 3L),
    # scaled up so that they lead their bins: equal scores, where the
    # strict '>' keeps the earlier block's id in each slot
    for L in (128, 4096):
        dup = items.clone()
        g = torch.arange(0, L, 2, device="cuda")
        dup[g] *= 3
        dup[g + L] = dup[g]
        dup[g + 3 * L] = dup[g]
        packed = pack_catalog(dup, L)
        for B in (8, 64):
            q = torch.randn(B, D, generator=gen, device="cuda")
            q[0] = dup[0]
            worst = max(worst, scan_against_plain(
                card, q.to(torch.bfloat16), packed, L, M, None,
                "duplicated items", dup=True)[0])
    # the runner-up sequence (v, v, then 2v in bins 3, 5 and L - 1)
    for L in (512, 4096):
        for B in (8, 64):
            worst = max(worst, scan_runner_up(card, gen, M, D, L, B))
    # the kernel's other dims, at a small ragged catalog
    for D in (16, 32, 128):
        M = 10_007
        items = torch.randn(M, D, generator=gen, device="cuda")
        packed = pack_catalog(items, 128)
        mask = torch.rand(packed.shape[1], generator=gen, device="cuda") > 0.3
        for B in (13, 65):
            q = torch.randn(B, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
            worst = max(worst, scan_against_plain(
                card, q, packed, 128, 9_001, mask, "other dim")[0])
    # the full 2,262,292-row catalog: B=8 on random items, the runner-up
    # sequence at B=64, then the times
    D, M, L = 64, 2_262_292, 4096
    worst = max(worst, scan_runner_up(card, gen, M, D, L, 64))
    items = torch.randn(M, D, generator=gen, device="cuda")
    packed = pack_catalog(items, L)
    q = torch.randn(8, D, generator=gen, device="cuda").to(torch.bfloat16)
    worst = max(worst, scan_against_plain(card, q, packed, L, M, None,
                                          "full catalog")[0])
    del packed
    return worst, scan_timings(card, items)


@contextlib.contextmanager
def plain_kernels():
    """Route the train step's gather and scatter-add through their plain
    PyTorch versions (on the card) while the block runs."""
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.ops import lookup, scatter

    saved = (lookup.gather_pool, lookup.scatter_add, scatter.scatter_add)
    lookup.gather_pool = gp.gather_pool_plain
    lookup.scatter_add = sa.scatter_add_plain
    scatter.scatter_add = sa.scatter_add_plain
    try:
        yield
    finally:
        lookup.gather_pool, lookup.scatter_add, scatter.scatter_add = saved


def phase_build() -> None:
    from esrecsys_tpu_torch.kernels import build

    names = build.kernel_sources()
    t0 = time.perf_counter()
    build.build_all(names)
    log(f"build {', '.join(names)}: {time.perf_counter() - t0:.1f} s, one "
        f"nvcc per source started together")
    for name in names:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def small_launch_medians(card: str, what: str, table, ids,
                         yardstick) -> None:
    """gather_pool against index_select at a small launch (``ids`` 1-D,
    no -1), in turns SMALL_RUNS times each on ``yardstick``; the medians
    and every run into GATHER_SMALL[what]."""
    import statistics

    from esrecsys_tpu_torch.kernels import gather_pool as gp

    ids2 = ids[:, None].contiguous()
    runs = {"ms": [], "library_ms": []}
    for _ in range(SMALL_RUNS):
        runs["ms"].append(yardstick(
            lambda: gp.gather_pool_cuda(table, ids2, False, -1)))
        runs["library_ms"].append(yardstick(
            lambda: table.index_select(0, ids)))
    med = {k: statistics.median(v) for k, v in runs.items()}
    GATHER_SMALL[what] = {**med, "runs": runs}
    log(f"gather_pool against index_select at {what} ({ids.shape[0]} ids, "
        f"{yardstick.__name__}, {SMALL_RUNS} runs each in turns): median "
        f"{med['ms'] * 1e3:.2f} us against {med['library_ms'] * 1e3:.2f} "
        f"us; runs " + ", ".join(f"{a * 1e3:.2f}/{b * 1e3:.2f}" for a, b in
                                 zip(runs["ms"], runs["library_ms"]))
        + f" [{card}]")


def check_gather_plan_edges(card: str, gen) -> float:
    """gather_pool against its plain version at the launch plan's edges on
    this card: for each instantiation's widths (float32 D 1, 4, 8, 32, 64,
    128, 256; bf16 D 8, 32, 64), B at a warp's pass of a small launch (one
    row a lane) and of a large one (U rows a lane, three passes an SM),
    and at the last pass of a grid of two full CTAs an SM (eight warps,
    one pass each), each one less and one more; ids past both ends
    of the table (clamped) and -1 ids under mask_id=-1 mixed in. K=1 must
    be exactly equal; K=5 (sum and mean) at B 1, 33 and 777 within
    POOL_TOL. Then a 100M x 32 bf16 table with ids whose row offsets pass
    2^31 elements, exactly equal. Returns the largest difference."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    R = 50_021
    err, n_cases = 0.0, 0
    for dtype, dims in ((torch.float32, (1, 4, 8, 32, 64, 128, 256)),
                        (torch.bfloat16, (8, 32, 64))):
        for D in dims:
            table = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
            full = gp.launch_plan(D, dtype, table.data_ptr(), 1 << 24, 1,
                                  sms)
            run = max(1, full.rows_per_pass // full.segments)
            last = 16 * sms * full.rows_per_pass // full.segments
            plan = gp.launch_plan(D, dtype, table.data_ptr(), last, 1, sms)
            if (plan.ctas, plan.threads, plan.passes) != (2 * sms, 256,
                                                          16 * sms):
                raise AssertionError(f"gather_pool plan at B={last} D={D}: "
                                     f"{plan}")
            # a small launch's pass (one row a lane), a large launch's
            # pass (U rows a lane) and the last pass of two full CTAs an
            # SM, +-1
            small = max(1, full.groups // full.segments)
            mid = 3 * sms * run
            for B in (small - 1, small, small + 1, mid - 1, mid, mid + 1,
                      last - 1, last, last + 1):
                if B < 1:
                    continue
                ids = torch.randint(-3, R + 7, (B, 1), generator=gen,
                                    device="cuda", dtype=torch.int32)
                ids[torch.rand((B, 1), generator=gen, device="cuda")
                    < 0.1] = -1
                k = gp.gather_pool_cuda(table, ids, False, -1)
                p = gp.gather_pool_plain(table, ids, False, -1)
                torch.cuda.synchronize()
                if not torch.equal(k, p):
                    raise AssertionError(f"gather_pool {dtype} D={D} B={B} "
                                         f"K=1 differs")
                n_cases += 1
            for B in (1, 33, 777):
                ids = torch.randint(-3, R + 7, (B, 5), generator=gen,
                                    device="cuda", dtype=torch.int32)
                ids[torch.rand((B, 5), generator=gen, device="cuda")
                    < 0.2] = -1
                for mean in (False, True):
                    k = gp.gather_pool_cuda(table, ids, mean, -1)
                    p = gp.gather_pool_plain(table, ids, mean, -1)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(k, p, rtol=POOL_TOL,
                                               atol=POOL_TOL)
                    err = max(err, float((k - p).abs().max()))
                    n_cases += 1
            del table
    # 100M x 32 bf16: rows on both sides of offset 2^31 elements
    rows, D = 100_000_000, 32
    table = torch.randn(rows, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    ids = torch.randint(0, rows, (262_144, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    edge = (1 << 31) // D
    ids[:8, 0] = torch.tensor([edge - 1, edge, edge + 1, rows - 1, rows,
                               -1, rows + 5, -2], dtype=torch.int32)
    k = gp.gather_pool_cuda(table, ids, False, -1)
    p = gp.gather_pool_plain(table, ids, False, -1)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError("gather_pool differs on the 100M x 32 bf16 "
                             "table")
    del table, k, p
    torch.cuda.empty_cache()
    log(f"kernel gather_pool at its plan's edges on {sms} SMs: float32 D in "
        f"(1, 4, 8, 32, 64, 128, 256), bf16 D in (8, 32, 64), B at a small "
        f"and a large launch's pass and at the last pass of two full CTAs "
        f"an SM, each +-1, with -1 and "
        f"clamped ids, K=1 exactly equal; K=5 sum and mean within "
        f"{POOL_TOL} (max_abs_err {err:.3g}); {n_cases} cases; 100M x 32 "
        f"bf16 with offsets past 2^31 elements exactly equal [{card}]")
    return err


def check_gather_scatter(card: str):
    """gather_pool and scatter_add against their plain versions at ragged
    shapes and edge cases. Returns (gather max err, scatter max err)."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    gen = torch.Generator(device="cuda").manual_seed(2)
    g_err = s_err = 0.0
    R = 100_003
    for D in (4, 32, 64):
        table = torch.randn(R, D, generator=gen, device="cuda")
        for B, K, mean, mask_id in ((1, 1, False, -1), (777, 1, False, -1),
                                    (13, 5, True, 0), (1000, 5, False, 0)):
            # clamped (negative, past the end) and masked ids included
            ids = torch.randint(-3, R + 7, (B, K), generator=gen,
                                device="cuda", dtype=torch.int32)
            ids[0, 0] = mask_id
            k = gp.gather_pool_cuda(table, ids, mean, mask_id)
            p = gp.gather_pool_plain(table, ids, mean, mask_id)
            torch.cuda.synchronize()
            if K == 1 and not torch.equal(k, p):
                raise AssertionError(f"gather_pool K=1 D={D} B={B} differs")
            torch.testing.assert_close(k, p, rtol=POOL_TOL, atol=POOL_TOL)
            g_err = max(g_err, float((k - p).abs().max()))
    # scatter_add: the vector instantiations (D 32, 64, 128, aligned) and
    # the generic one (D 4 and 6, and D 32 with updates one float off a
    # 16-byte boundary); n not a multiple of any CTA's rows
    taken = set()
    for D in (4, 6, 32, 64, 128):
        table = torch.randn(R, D, generator=gen, device="cuda")
        for n in (1, 777, 10_000):
            ids = torch.randint(-2, R + 2, (n,), generator=gen,
                                device="cuda", dtype=torch.int32)
            if n > 2:  # dropped ids at both ends of the range
                ids[n // 2], ids[-1] = -1, R
            cases = [torch.randn(n, D, generator=gen, device="cuda") * 1e-3]
            if D == 32:
                buf = torch.randn(n * D + 1, generator=gen,
                                  device="cuda") * 1e-3
                cases.append(buf[1:].view(n, D))
            for upd in cases:
                k, p = table.clone(), table.clone()
                taken.add(sa.launch_plan(n, D, k.data_ptr(),
                                         upd.data_ptr())[0])
                sa.scatter_add_cuda(k, ids, upd)
                sa.scatter_add_plain(p, ids, upd)
                torch.cuda.synchronize()
                torch.testing.assert_close(k, p, rtol=TOL, atol=TOL)
                hit = torch.zeros(R, dtype=torch.bool, device="cuda")
                hit[ids[(ids >= 0) & (ids < R)].long()] = True
                if not torch.equal(k[~hit], table[~hit]):
                    raise AssertionError(f"scatter_add D={D} n={n} changed "
                                         f"rows no id touches")
                s_err = max(s_err, float((k - p).abs().max()))
    if taken != {0, 32, 64, 128}:
        raise AssertionError(f"scatter_add instantiations taken: {taken}")
    # empty batches launch nothing and K=0 pools to zeros
    table = torch.randn(50, 32, generator=gen, device="cuda")
    empty = gp.gather_pool_cuda(table, torch.zeros((0, 1), dtype=torch.int32,
                                                   device="cuda"), False, -1)
    zero_k = gp.gather_pool_cuda(table, torch.zeros((3, 0), dtype=torch.int32,
                                                    device="cuda"), True, -1)
    sa.scatter_add_cuda(table, torch.zeros(0, dtype=torch.int32,
                                           device="cuda"),
                        torch.zeros((0, 32), device="cuda"))
    torch.cuda.synchronize()
    if empty.shape != (0, 32) or not bool((zero_k == 0).all()):
        raise AssertionError("empty gather_pool batches are wrong")
    g_err = max(g_err, check_gather_plan_edges(card, gen))
    # every id equal: 76,288 updates pile onto one row
    table = torch.randn(100_096, 32, generator=gen, device="cuda")
    upd = torch.randn(76_288, 32, generator=gen, device="cuda") * 1e-2
    same = torch.full((76_288,), 7, dtype=torch.int32, device="cuda")
    k = sa.scatter_add_cuda(table.clone(), same, upd)
    p = sa.scatter_add_plain(table.clone(), same, upd)
    torch.cuda.synchronize()
    pile = float((k - p).abs().max())
    if pile > PILEUP_ATOL or not torch.equal(
            torch.cat([k[:7], k[8:]]), torch.cat([table[:7], table[8:]])):
        raise AssertionError(f"scatter_add pile-up: max err {pile}")
    log(f"kernel gather_pool: D in (4, 32, 64), B in (1, 13, 777, 1000), "
        f"K in (1, 5), sum and mean, masked and clamped ids, empty batches: "
        f"ok, K=1 exactly equal, max_abs_err {g_err:.3g} [{card}]")
    log(f"kernel scatter_add: D in (4, 6, 32, 64, 128), n in (1, 777, "
        f"10000) with dropped out-of-range ids (-1 and R among them), D=32 "
        f"also with updates one float off a 16-byte boundary; "
        f"instantiations {sorted(taken)} (0: generic): ok, rows no id "
        f"touches bit-equal, max_abs_err {s_err:.3g}; 76,288 updates on "
        f"one row: max_abs_err {pile:.3g} (bound {PILEUP_ATOL}) [{card}]")
    return g_err, s_err


def affinity_at(q, packed, album, artist, actx, artx, b, g):
    """Exact float32 affinity of queries ``b`` to catalog items ``g``."""
    qf = q.float()[b]                                   # (n, C, D)
    items = packed[:, g.long()].T.float()               # (n, D)
    s = (qf * items[:, None, :]).sum(-1).amax(-1)
    s = s + (actx[b] == album[g.long()][:, None]).any(-1).float() * 0.1
    return s + (artx[b] == artist[g.long()][:, None]).any(-1).float() * 0.1


def compare_affinity(args, kv, ki, pv, pi, wide=False):
    """fused_affinity against its plain version (compare_top2): identical
    inputs are a catalog column with its album and artist; near-tie items
    score within 10 TOL in a third order. With ``wide``, values and near
    ties within ``width_tol`` of the largest slot's products."""
    q, packed, album, artist = args[:4]

    def identical(gk, gp):
        return ((packed[:, gk] == packed[:, gp]).all(0)
                & (album[gk] == album[gp]) & (artist[gk] == artist[gp]))

    def sum_abs(b, g):
        items = packed[:, g].T.float().abs()
        return (q.float()[b].abs() * items[:, None, :]).sum(-1).amax(-1)

    return compare_top2(
        kv, ki, pv, pi, identical,
        lambda b, g: chunked(lambda bb, gg: affinity_at(*args, bb, gg), b, g),
        lambda s: TOL * 10,
        width_tol(packed.shape[0], sum_abs) if wide else None)


def affinity_case(gen, B, C, D, M, L, bound, dup=False):
    """Random affinity inputs; with ``dup``, copies of one vector (and its
    album and artist) at g, g + L, g + 3L, scaled to lead their bins."""
    import torch

    from esrecsys_tpu_torch.retrieval.fused import pack_catalog, pack_payload

    items = torch.randn(M, D, generator=gen, device="cuda")
    album = torch.randint(0, 50, (M,), generator=gen, device="cuda",
                          dtype=torch.int32)
    artist = torch.randint(0, 30, (M,), generator=gen, device="cuda",
                           dtype=torch.int32)
    if dup:
        g = torch.arange(0, L, 2, device="cuda")
        items[g] *= 3
        for off in (L, 3 * L):
            items[g + off] = items[g]
            album[g + off] = album[g]
            artist[g + off] = artist[g]
    packed = pack_catalog(items, L)
    q = torch.randn(B, C, D, generator=gen, device="cuda")
    if dup:
        q[0, 0] = items[0]
    q = q.to(torch.bfloat16)
    actx = torch.randint(0, 50, (B, C), generator=gen, device="cuda",
                         dtype=torch.int32)
    artx = torch.randint(0, 30, (B, C), generator=gen, device="cuda",
                         dtype=torch.int32)
    Mp = packed.shape[1]
    return (q, packed, pack_payload(album, Mp), pack_payload(artist, Mp),
            actx, artx)


def affinity_ids(case: str, args, M: int) -> None:
    """Rewrite the context and catalog ids of affinity inputs ``args`` in
    place for one membership edge case of the kernel's hash tables:
    ``shared`` (every query of the tile holds the same ids: every mask bit
    set), ``colliding`` (64 x C distinct ids in one probe chain, items
    holding them and other ids of the chain) or ``special`` (the padding
    ids -1 and -2, the int32 extremes, one id repeated in a query's
    slots)."""
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa

    _, _, album, artist, actx, artx = args
    B, C = actx.shape
    g = torch.arange(0, M, 3, device="cuda")
    if case == "shared":
        actx[:] = actx[0].clone()
        artx[:] = artx[0].clone()
    elif case == "colliding":
        for ctx, cat, slot in ((actx, album, 3), (artx, artist, 900)):
            chain = fa.colliding_ids(B * C + 40, slot).cuda()
            ctx.copy_(chain[:B * C].view(B, C))
            cat[g] = chain[g % chain.numel()]
    elif case == "special":
        ext = torch.tensor([-1, -2, -2**31, 2**31 - 1, 7], device="cuda",
                           dtype=torch.int32)
        for ctx, cat in ((actx, album), (artx, artist)):
            ctx.copy_(ext[torch.randint(0, 5, (B, C), device="cuda")])
            ctx[1] = ctx[1, 0].item()
            cat[g] = ext[g % 5]
    else:
        raise ValueError(case)


def check_affinity(card: str) -> float:
    """fused_affinity against its plain version at ragged shapes, with
    exact ties, at the membership tables' edge cases (``affinity_ids``) and
    with ``bound`` at and past a block edge; the full eval shape is checked
    in the train phase. Tolerance: compare_top2's TOL on values, equal ids
    at exact ties."""
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for B, C, D, M, L, bound, dup, ids in (
            (13, 5, 64, 100_003, 128, 100_003, False, None),
            (1, 1, 64, 10_007, 128, 9_001, False, None),
            (70, 5, 32, 20_011, 256, 20_011, False, None),
            (64, 8, 128, 5_000, 128, 4_999, False, None),
            (40, 1, 32, 10_007, 256, 10_007, False, None),
            (130, 5, 64, 100_003, 4096, 97_001, False, None),
            (13, 5, 64, 100_003, 4096, 3 * 4096, False, None),
            (13, 5, 64, 100_003, 4096, 3 * 4096 + 1, False, None),
            (8, 5, 64, 100_003, 128, 100_003, True, None),
            (8, 5, 64, 100_003, 4096, 100_003, True, None),
            (64, 5, 64, 20_011, 128, 20_011, False, "shared"),
            (64, 5, 64, 20_011, 128, 20_011, False, "colliding"),
            (64, 8, 64, 20_011, 128, 20_011, False, "colliding"),
            (70, 5, 64, 20_011, 128, 20_011, False, "special")):
        args = affinity_case(gen, B, C, D, M, L, bound, dup)
        if ids:
            affinity_ids(ids, args, M)
        kv, ki = fa.fused_affinity_cuda(*args, L, bound)
        pv, pi = fa.fused_affinity_plain(*args, L, bound)
        torch.cuda.synchronize()
        err, near, exact = compare_affinity(args, kv, ki, pv, pi)
        if dup and exact == 0:
            raise AssertionError("the duplicate-items case holds no tie")
        worst = max(worst, err)
        log(f"kernel fused_affinity B={B} C={C} D={D} M={M} L={L} "
            f"bound={bound}{' duplicated items' if dup else ''}"
            f"{f' {ids} ids' if ids else ''}: ok, max_abs_err {err:.3g}, "
            f"exact-tie slots {exact} (ids equal there), near-tie id slots "
            f"{near} [{card}]")
    # an empty batch launches nothing
    args = affinity_case(gen, 0, 5, 64, 1000, 128, 1000)
    kv, _ = fa.fused_affinity_cuda(*args, 128, 1000)
    if kv.shape != (0, 256):
        raise AssertionError("empty fused_affinity batch is wrong")
    return worst


def int8_case(gen, M: int, D: int, L: int, dup: bool):
    """A random int8 catalog (codes, scales) of M items; with ``dup``,
    copies of one vector at g, g + L, g + 3L, scaled to lead their bins."""
    import torch

    from esrecsys_tpu_torch.retrieval.fused import pack_catalog_int8

    items = torch.randn(M, D, generator=gen, device="cuda")
    if dup:
        g = torch.arange(0, L, 2, device="cuda")
        items[g] *= 3
        items[g + L] = items[g]
        items[g + 3 * L] = items[g]
    codes, scales = pack_catalog_int8(items, L)
    return items, codes, scales


def int8_runner_up(gen, M: int, D: int, L: int, bins):
    """runner_up_items at B=8 as an int8 catalog: (q, codes, scales)."""
    from esrecsys_tpu_torch.retrieval.fused import pack_catalog_int8

    q, items = runner_up_items(gen, M, D, L, bins)
    codes, scales = pack_catalog_int8(items, L)
    return q, codes, scales


def check_fused_int8(card: str) -> float:
    """fused_scan_int8 against its plain version: ragged catalogs with a
    bound and a mask, the kernel's four dims at ragged batches, planted
    exact ties, and the full 2,265,088-column catalog at B=8, 13 and 64,
    with a planted runner-up sequence and a bound inside a block."""
    import torch

    from esrecsys_tpu_torch.kernels import fused_scan as fs

    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    cases = [(D, 10_007, 128, False, (1, 9, 13) if D < 64 else (13,))
             for D in (16, 32, 128)]
    cases += [(64, 100_003, L, dup, (1, 8, 13))
              for L in (128, 4096) for dup in (False, True)]
    cases.append((64, 2_262_292, 4096, True, (8, 13, 64)))
    for D, M, L, dup, batches in cases:
        items, codes, scales = int8_case(gen, M, D, L, dup)
        Mp = codes.shape[1]
        mask = torch.rand(Mp, generator=gen, device="cuda") > 0.3
        for B in batches:
            q = torch.randn(B, D, generator=gen, device="cuda")
            if dup:
                q[0] = items[0]
            q = q.to(torch.bfloat16)
            runs = ((M, None),) if M > 1_000_000 else ((M, None),
                                                        (M - 3_001, mask))
            for bound, msk in runs:
                kv, ki = fs.fused_scan_int8_cuda(q, codes, scales, L, bound,
                                                 msk)
                pv, pi = fs.fused_scan_int8_plain(q, codes, scales, L, bound,
                                                  msk)
                torch.cuda.synchronize()
                err, near, exact = compare_candidates(
                    q, codes, kv, ki, pv, pi, scales)
                if dup and exact == 0:
                    raise AssertionError("the duplicate-items case holds no "
                                         "tie")
                worst = max(worst, err)
                log(f"kernel fused_scan_int8 B={B} D={D} M={M} L={L} "
                    f"bound={bound} mask={msk is not None}"
                    f"{' duplicated items' if dup else ''}: ok, max_abs_err "
                    f"{err:.3g}, exact-tie slots {exact} (ids equal there), "
                    f"near-tie id slots {near} [{card}]")
        del items, codes, scales
    # the runner-up sequence at the full catalog, with the 2v items scored,
    # masked out, and past a bound that ends inside a block (the 2v items
    # lie in block 2, ids 2L + j, so a bound of 2L + 3 leaves out every
    # planted one), then with a bound inside block 244 and a mask
    M, D, L = 2_262_292, 64, 4096
    bins = (3, 5, 2_000, L - 1)
    q, codes, scales = int8_runner_up(gen, M, D, L, bins)
    Mp = codes.shape[1]
    no_2v = torch.ones(Mp, dtype=torch.bool, device="cuda")
    no_2v[[j + 2 * L for j in bins]] = False
    half = torch.rand(Mp, generator=gen, device="cuda") > 0.5
    half[[j + k * L for j in bins for k in range(3)]] = True
    for name, bound, msk, lead in (
            ("2v scored", M, None, 2),
            ("2v masked", M, no_2v, 0),
            ("2v past the bound", 2 * L + 3, None, 0),
            ("bound 1,000,017 inside a block, mask", 1_000_017, half, 2)):
        kv, ki = fs.fused_scan_int8_cuda(q, codes, scales, L, bound, msk)
        pv, pi = fs.fused_scan_int8_plain(q, codes, scales, L, bound, msk)
        torch.cuda.synchronize()
        err, near, exact = compare_candidates(q, codes, kv, ki, pv, pi,
                                              scales)
        worst = max(worst, err)
        check_runner_up(ki, L, bins, lead, name)
        log(f"kernel fused_scan_int8 B=8 D={D} M={M} L={L} runner-up "
            f"sequence v, v, 2v in bins {bins}, {name}: ok, max_abs_err "
            f"{err:.3g}, the planted bins keep (2v or v, block-1 v), "
            f"exact-tie slots {exact}, near-tie id slots {near} [{card}]")
    del codes, scales
    return worst


GENERIC_DIMS = (8, 24, 48, 100, 256, 300, 768)  # the generic scans' checks
GENERIC_BATCHES = (1, 13, 65)
GENERIC_BINS = (128, 512, 2048)
GENERIC_AFFINITY = ((16, 48, 256), (1, 5, 9, 16))   # (D, C) checked
GENERIC_TIMED = (8, 64)       # batches timed over the 2,262,292 x 256 catalog


def generic_counts() -> dict:
    """The generic entries' launch counts."""
    from esrecsys_tpu_torch.kernels import fused_generic as fg

    return {"fused_scan_generic": fg.LAUNCHES_SCAN.count,
            "fused_scan_int8_generic": fg.LAUNCHES_SCAN_INT8.count,
            "fused_affinity_generic": fg.LAUNCHES_AFFINITY.count}


def generic_against_plain(q, cat, scales, L: int, bound: int, mask=None):
    """The bf16 (``scales`` None) or int8 scan of ``cat`` against its plain
    version on one input, values within ``width_tol``
    (compare_candidates). Returns (max abs error, near-tie id slots,
    exact-tie slots, the kernel's ids)."""
    import torch

    from esrecsys_tpu_torch.kernels import fused_scan as fs

    if scales is None:
        kv, ki = fs.fused_scan_cuda(q, cat, L, bound, mask)
        pv, pi = fs.fused_scan_plain(q, cat, L, bound, mask)
    else:
        kv, ki = fs.fused_scan_int8_cuda(q, cat, scales, L, bound, mask)
        pv, pi = fs.fused_scan_int8_plain(q, cat, scales, L, bound, mask)
    torch.cuda.synchronize()
    err, near, exact = compare_candidates(q, cat, kv, ki, pv, pi, scales,
                                          wide=True)
    return err, near, exact, ki


def check_routing(card: str) -> None:
    """The dispatch on the card: the tuned kernels at their widths (and the
    affinity at up to 8 slots), the generic ones elsewhere, by their
    launch counters."""
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa
    from esrecsys_tpu_torch.kernels import fused_scan as fs

    gen = torch.Generator(device="cuda").manual_seed(9)
    seen = []
    for D in (16, 32, 64, 128, 24, 256):
        items, codes, scales = int8_case(gen, 4_000, D, 128, False)
        packed = codes.to(torch.bfloat16).contiguous()
        q = torch.randn(8, D, generator=gen, device="cuda").to(torch.bfloat16)
        for name, fn, tuned in (
                ("fused_scan", lambda: fs.fused_scan_cuda(q, packed, 128,
                                                          4_000),
                 fs.LAUNCHES),
                ("fused_scan_int8", lambda: fs.fused_scan_int8_cuda(
                    q, codes, scales, 128, 4_000), fs.LAUNCHES_INT8)):
            before, gbefore = tuned.count, generic_counts()
            fn()
            want = fs.variant(D)
            got = ("tuned" if tuned.count == before + 1 and
                   generic_counts() == gbefore else
                   "generic" if tuned.count == before else "none")
            if got != want:
                raise AssertionError(f"{name} at D={D} launched {got}, the "
                                     f"dispatch says {want}")
            seen.append(f"{name} D={D} {got}")
        del items, codes, scales, packed
    for D, C in ((64, 8), (64, 9), (128, 5), (48, 5), (256, 5), (32, 16)):
        args = affinity_case(gen, 8, C, D, 4_000, 128, 4_000)
        before, gbefore = fa.LAUNCHES.count, generic_counts()
        fa.fused_affinity_cuda(*args, 128, 4_000)
        got = ("tuned" if fa.LAUNCHES.count == before + 1 and
               generic_counts() == gbefore else
               "generic" if fa.LAUNCHES.count == before else "none")
        if got != fa.variant(D, C):
            raise AssertionError(f"fused_affinity at D={D} C={C} launched "
                                 f"{got}, the dispatch says "
                                 f"{fa.variant(D, C)}")
        seen.append(f"fused_affinity D={D} C={C} {got}")
    torch.cuda.synchronize()
    log(f"dispatch on the card, by the launch counters: {'; '.join(seen)} "
        f"[{card}]")


def check_generic(card: str) -> dict:
    """The generic kernels (csrc/fused_generic.cu) against their plain
    versions: the bf16 and int8 scans at GENERIC_DIMS, B in
    GENERIC_BATCHES and L in GENERIC_BINS over twelve catalog blocks (a
    B <= 8 scan's ring of eight stages wraps even at one depth chunk a
    block), with neither mask nor bound and with both (the bound inside a
    block), planted copies of one vector at g, g + L, g + 3L and g + 9L
    (past the wrap) in every catalog (exact ties: ids equal) and the
    runner-up sequence v, v, 2v over ten blocks (scored, masked, past the
    bound); the affinity at GENERIC_AFFINITY's widths and slot counts,
    with planted copies and the membership edge cases of
    ``affinity_ids``. Values within ``width_tol``. Then the dispatch
    (``check_routing``), and the scans over a random 2,262,292 x 256
    catalog at L=4096 at GENERIC_TIMED's batches: held against their
    plain versions, then timed beside their byte bounds. Returns the
    largest errors and the times."""
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa
    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.retrieval.fused import (pack_catalog,
                                                    pack_catalog_int8)

    gen = torch.Generator(device="cuda").manual_seed(8)
    errs = {"fused_scan_generic": 0.0, "fused_scan_int8_generic": 0.0,
            "fused_affinity_generic": 0.0}
    before = generic_counts()
    for D in GENERIC_DIMS:
        per = {"bf16": [0, 0.0, 0, 0], "int8": [0, 0.0, 0, 0]}
        for L in GENERIC_BINS:
            M = 11 * L + 37
            items = torch.randn(M, D, generator=gen, device="cuda")
            g = torch.arange(0, L, 2, device="cuda")
            items[g] *= 3
            for copy in (1, 3, 9):
                items[g + copy * L] = items[g]
            packed = pack_catalog(items, L)
            codes, scales = pack_catalog_int8(items, L)
            Mp = packed.shape[1]
            mask = torch.rand(Mp, generator=gen, device="cuda") > 0.3
            for B in GENERIC_BATCHES:
                q = torch.randn(B, D, generator=gen, device="cuda")
                q[0] = items[0]
                q = q.to(torch.bfloat16)
                for bound, msk in ((M, None), (M - L // 2 - 3, mask)):
                    for kind, sc, cat in (("bf16", None, packed),
                                          ("int8", scales, codes)):
                        err, near, exact, _ = generic_against_plain(
                            q, cat, sc, L, bound, msk)
                        if exact == 0:
                            raise AssertionError(
                                f"{kind} D={D} B={B} L={L}: the planted "
                                f"copies hold no tie")
                        row = per[kind]
                        row[0] += 1
                        row[1] = max(row[1], err)
                        row[2] += exact
                        row[3] += near
            del items, packed, codes, scales
        # the runner-up sequence at B=8 over nine blocks and a tail
        L = 512
        bins = (3, 5, L - 1)
        q, planted = runner_up_items(gen, 9 * L + 100, D, L, bins)
        packed = pack_catalog(planted, L)
        codes, scales = pack_catalog_int8(planted, L)
        M, Mp = planted.shape[0], packed.shape[1]
        no_2v = torch.ones(Mp, dtype=torch.bool, device="cuda")
        no_2v[[j + 2 * L for j in bins]] = False
        for name, bound, msk, lead in (("2v scored", M, None, 2),
                                       ("2v masked", M, no_2v, 0),
                                       ("2v past the bound", 2 * L + 3,
                                        None, 0)):
            for kind, sc, cat in (("bf16", None, packed),
                                  ("int8", scales, codes)):
                err, near, _, ki = generic_against_plain(q, cat, sc, L,
                                                         bound, msk)
                check_runner_up(ki, L, bins, lead, f"{kind} D={D} {name}")
                row = per[kind]
                row[0] += 1
                row[1] = max(row[1], err)
                row[3] += near
        del q, planted, packed, codes, scales
        for kind, name in (("bf16", "fused_scan_generic"),
                           ("int8", "fused_scan_int8_generic")):
            n, err, exact, near = per[kind]
            errs[name] = max(errs[name], err)
            log(f"kernel {name} D={D}: {n} cases (B {GENERIC_BATCHES}, L "
                f"{GENERIC_BINS}, no mask and no bound or both, planted "
                f"copies; the runner-up sequence v, v, 2v in bins {bins} "
                f"scored, masked, past the bound) ok, max_abs_err "
                f"{err:.3g}, exact-tie slots {exact} (ids equal there), "
                f"near-tie id slots {near} [{card}]")
    D_C = [(D, C) for D in GENERIC_AFFINITY[0] for C in GENERIC_AFFINITY[1]]
    for D, C in D_C:
        cases = [(13, 128, True, None), (70, 256, False, None),
                 (64, 128, False, "shared"), (64, 128, False, "colliding"),
                 (70, 128, False, "special")]
        n, worst, ties, nears = 0, 0.0, 0, 0
        for B, L, dup, ids in cases:
            M = 20_011
            bound = M - 11 if ids is None else M
            args = affinity_case(gen, B, C, D, M, L, bound, dup)
            if ids:
                affinity_ids(ids, args, M)
            kv, ki = fa.fused_affinity_cuda(*args, L, bound)
            pv, pi = fa.fused_affinity_plain(*args, L, bound)
            torch.cuda.synchronize()
            err, near, exact = compare_affinity(args, kv, ki, pv, pi,
                                                wide=True)
            if dup and exact == 0:
                raise AssertionError(f"affinity D={D} C={C}: the planted "
                                     f"copies hold no tie")
            n += 1
            worst, ties, nears = max(worst, err), ties + exact, nears + near
        errs["fused_affinity_generic"] = max(
            errs["fused_affinity_generic"], worst)
        log(f"kernel fused_affinity_generic D={D} C={C}: {n} cases "
            f"(planted copies, ragged B, a bound inside a block, the "
            f"shared, colliding and special membership ids) ok, "
            f"max_abs_err {worst:.3g}, exact-tie slots {ties} (ids equal "
            f"there), near-tie id slots {nears} [{card}]")
    after = generic_counts()
    ran = {k: after[k] - before[k] for k in after}
    if not all(ran.values()):
        raise AssertionError(f"a generic entry never launched: {ran}")
    check_routing(card)

    # ---- the scans over a random 2,262,292 x 256 catalog: checked, timed
    M, D, L = 2_262_292, 256, 4096
    items = torch.randn(M, D, generator=gen, device="cuda")
    packed = pack_catalog(items, L)
    codes, scales = pack_catalog_int8(items, L)
    del items
    Mp = packed.shape[1]
    cols = -(-M // L) * L
    timed = {}
    for B in GENERIC_TIMED:
        q = torch.randn(B, D, generator=gen, device="cuda").to(torch.bfloat16)
        for name, sc, cat, fn, plain, per_col in (
                ("fused_scan_generic", None, packed,
                 lambda: fs.fused_scan_cuda(q, packed, L, M),
                 lambda: fs.fused_scan_plain(q, packed, L, M), 2 * D),
                ("fused_scan_int8_generic", scales, codes,
                 lambda: fs.fused_scan_int8_cuda(q, codes, scales, L, M),
                 lambda: fs.fused_scan_int8_plain(q, codes, scales, L, M),
                 D + 4)):
            err, near, exact, _ = generic_against_plain(q, cat, sc, L, M)
            errs[name] = max(errs[name], err)
            log(f"kernel {name} B={B} D={D} Mp={Mp} L={L}: ok against the "
                f"plain version, max_abs_err {err:.3g}, exact-tie slots "
                f"{exact}, near-tie id slots {near} [{card}]")
            ms = cuda_ms(fn, 20)
            moved = cols * per_col + B * D * 2 + B * 2 * L * 8
            t_ops = 2 * B * D * cols / BF16_FLOPS_PER_S
            bound = max(moved / HBM_BYTES_PER_S, t_ops) * 1e3
            by = "bytes" if moved / HBM_BYTES_PER_S >= t_ops else "operations"
            row = {"ms": ms, "bound_ms": bound, "bound_by": by}
            if B == 8:
                row["plain_ms"] = cuda_ms(plain, 1, warmup=1)
            timed[f"{name}_B{B}"] = row
            log(f"kernel {name} time B={B} D={D} Mp={Mp} L={L}: {ms:.4f} ms "
                f"(mean of 20, CUDA events), bound {bound:.4f} ms by {by} "
                f"({moved / 1e9:.3f} GB), {bound / ms:.3f} of bound speed"
                + (f", plain version {row['plain_ms']:.1f} ms"
                   if "plain_ms" in row else "") + f" [{card}]")
    del packed, codes, scales
    return {"errs": errs, "timed": timed}


def smem_edge_ids(R: int, D: int, step: int, dup: int, gen):
    """Ids at both edges of the card's smem_scatter plan's CTA ranges: for
    every ``step``-th CTA c and the plan's last (ragged when R cuts its
    range short), its first and last rows and the row before its first
    (the last of CTA c - 1); with step 3, CTAs c + 1 get no id. Each id
    ``dup`` times, shuffled, with -1 and R (dropped) among them."""
    import torch

    from esrecsys_tpu_torch.kernels import smem_scatter as ss

    ctas, per = ss.smem_plan(R, D, *ss.smem_budget(torch.device("cuda")))
    edges = []
    for c in sorted(set(range(0, ctas, step)) | {ctas - 1}):
        r0 = c * per
        edges += [r0 - 1, r0, min(R, r0 + per) - 1]
    ids = torch.tensor(sorted({e for e in edges if e >= 0}) * dup + [-1, R],
                       dtype=torch.int32, device="cuda")
    return ids[torch.randperm(ids.numel(), generator=gen,
                              device="cuda")], ctas, per


def check_smem_scatter(card: str):
    """smem_scatter against its plain version at ragged shapes with dropped
    out-of-range ids, against its plain version and scatter_add at the
    album table with the step's 76,288 ids (rows hit once bit-equal), at
    both edges of every CTA range of the card's plan and of every third
    (the others empty), each id once (bit-equal) and three times (the
    duplicates of rows on both sides of a boundary), with every id on one
    row, and
    its refusal of the artist table. Returns (max err, pile-up err)."""
    import torch

    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.kernels import smem_scatter as ss

    gen = torch.Generator(device="cuda").manual_seed(4)
    err = 0.0
    for D, R, n in ((3, 50_003, 777), (32, 50_003, 1), (64, 50_003, 76_288),
                    (32, 100_096, 76_288)):
        table = torch.randn(R, D, generator=gen, device="cuda")
        ids = torch.randint(-2, R + 2, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        upd = torch.randn(n, D, generator=gen, device="cuda") * 1e-3
        k = ss.smem_scatter_cuda(table.clone(), ids, upd)
        p = ss.smem_scatter_plain(table.clone(), ids, upd)
        a = sa.scatter_add_cuda(table.clone(), ids, upd)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, rtol=TOL, atol=TOL)
        torch.testing.assert_close(k, a, rtol=TOL, atol=TOL)
        # a row hit once is table + u in both versions, bit for bit
        ok = ids[(ids >= 0) & (ids < R)].long()
        once = torch.bincount(ok, minlength=R) == 1
        if not torch.equal(k[once], p[once]):
            raise AssertionError(f"smem_scatter D={D} R={R} n={n}: a row "
                                 f"hit once differs from the plain version")
        err = max(err, float((k - p).abs().max()))
    edges = []
    for D, R in ((3, 50_003), (32, 100_096), (64, 50_003)):
        table = torch.randn(R, D, generator=gen, device="cuda")
        for step, dup in ((1, 1), (1, 3), (3, 1), (3, 3)):
            ids, ctas, per = smem_edge_ids(R, D, step, dup, gen)
            upd = torch.randn(ids.numel(), D, generator=gen,
                              device="cuda") * 1e-3
            k = ss.smem_scatter_cuda(table.clone(), ids, upd)
            p = ss.smem_scatter_plain(table.clone(), ids, upd)
            torch.cuda.synchronize()
            if dup == 1 and not torch.equal(k, p):
                raise AssertionError(f"smem_scatter D={D} R={R} step "
                                     f"{step}: distinct edge ids differ "
                                     f"from the plain version")
            torch.testing.assert_close(k, p, rtol=TOL, atol=TOL)
            err = max(err, float((k - p).abs().max()))
        edges.append(f"D={D} R={R} ({ctas} CTAs of {per} rows, the last "
                     f"{R - (ctas - 1) * per})")
    # every id equal: 76,288 updates pile onto one row of the album table
    table = torch.randn(100_096, 32, generator=gen, device="cuda")
    upd = torch.randn(76_288, 32, generator=gen, device="cuda") * 1e-2
    same = torch.full((76_288,), 7, dtype=torch.int32, device="cuda")
    k = ss.smem_scatter_cuda(table.clone(), same, upd)
    p = ss.smem_scatter_plain(table.clone(), same, upd)
    torch.cuda.synchronize()
    pile = float((k - p).abs().max())
    if pile > PILEUP_ATOL or not torch.equal(
            torch.cat([k[:7], k[8:]]), torch.cat([table[:7], table[8:]])):
        raise AssertionError(f"smem_scatter pile-up: max err {pile}")
    try:
        ss.smem_scatter_cuda(torch.zeros(295_936, 32, device="cuda"), same,
                             upd)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("smem_scatter took the artist table")
    log(f"kernel smem_scatter: D in (3, 32, 64), n in (1, 777, 76288) with "
        f"dropped out-of-range ids, the album table against scatter_add: "
        f"ok, rows hit once bit-equal; ids at both edges of every CTA "
        f"range and of every third (the CTAs after them empty), once "
        f"(bit-equal) and three times each, {'; '.join(edges)}: ok; "
        f"max_abs_err {err:.3g}; "
        f"76,288 updates on one row: max_abs_err {pile:.3g} (bound "
        f"{PILEUP_ATOL}); artist table refused: {refused} [{card}]")
    return err, pile


def rows_bytes(ids, dim: int) -> int:
    """Bytes of the distinct float32 table rows ``ids`` touch."""
    import torch

    return int(torch.unique(ids).numel()) * dim * 4


def trace_rows(calls, reps: int, marker=None):
    """Device ms a round by kernel, from a torch.profiler trace of
    ``reps`` rounds of ``calls``; None when TRACE_TRIES traces held no
    device rows (or none of ``marker``'s, a kernel launched once a
    round): a trace now and then comes back empty, about once in sixty
    on an H100, at times several in a row. A kernel whose count in the
    trace is no multiple of ``reps`` lost rows there (a trace read 265 us
    for a 660 us gather): its time is its mean per launch times
    ceil(count / reps) launches a round, marked "profiler_per_launch"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for call in calls:
                    call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total]
        if events and (marker is None
                       or any(marker in e.key for e in events)):
            break
        time.sleep(TRACE_PAUSE_S)
    else:
        return None
    got, lost = {}, []
    for e in events:
        t = e.self_device_time_total / 1e3
        if e.count % reps:
            lost.append(f"{e.key[:40]} {e.count}")
            got[e.key] = MarkedMs(t / e.count * -(-e.count // reps),
                                  "profiler_per_launch")
        else:
            got[e.key] = t / reps
    if lost:
        log(f"profiler trace of {reps} rounds lost rows: "
            f"{'; '.join(lost)} (their per-launch means, marked)")
    return got


def cold_rows(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` in ms, per kernel it launches,
    with the 50 MB L2 cache flushed before each call, as the train step
    finds its tables after the rest of the step has streamed through the
    cache: the device rows of a torch.profiler trace (``trace_rows``),
    less the flush's own rows (a bitwise NOT over 256 MiB of bytes, an op
    none of the timed functions uses, found by its name). CUDA events
    around a few-microsecond call would time the host's launch instead;
    they are the fallback when the traces hold no device rows."""
    import torch

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    got = trace_rows((flush.bitwise_not_, fn), reps, "bitwise_not")
    if got is None:
        log(f"cold_rows: {TRACE_TRIES} profiler traces held no device "
            f"rows; CUDA events around the call instead (marked)")
        return {"cuda events": events_ms(fn, flush, reps)}
    timed = {k: t for k, t in got.items() if "bitwise_not" not in k}
    if not timed:
        raise RuntimeError("the profiler trace holds no device time")
    return timed


class MarkedMs(float):
    """A time in ms not from a whole profiler trace; ``timer`` says how
    it was taken: "cuda_events" (``events_ms``) or "profiler_per_launch"
    (``trace_rows`` on a trace that lost rows). Arithmetic with it keeps
    the mark, so every number derived from one carries it, and
    ``mark_timers`` writes it into the kernels line."""

    def __new__(cls, value, timer: str):
        obj = super().__new__(cls, value)
        obj.timer = timer
        return obj

    def _op(fn):
        def op(self, other):
            timers = {self.timer, getattr(other, "timer", self.timer)}
            return MarkedMs(fn(float(self), float(other)),
                            "+".join(sorted(timers)))
        return op

    __add__ = _op(lambda a, b: a + b)
    __radd__ = _op(lambda a, b: b + a)
    __sub__ = _op(lambda a, b: a - b)
    __rsub__ = _op(lambda a, b: b - a)
    __mul__ = _op(lambda a, b: a * b)
    __rmul__ = _op(lambda a, b: b * a)
    __truediv__ = _op(lambda a, b: a / b)
    __rtruediv__ = _op(lambda a, b: b / a)


def mark_timers(obj) -> int:
    """Add ``"timer": <how>`` to each dict in ``obj`` (nested dicts and
    lists) that holds a MarkedMs, directly or in a list or tuple; every
    other time in the kernels line is from whole profiler traces or, where
    the line says so, CUDA events. Returns the dicts marked."""
    if isinstance(obj, (list, tuple)):
        return sum(mark_timers(v) for v in obj)
    if not isinstance(obj, dict):
        return 0
    n = sum(mark_timers(v) for v in obj.values())
    timers = set()
    for v in obj.values():
        for x in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(x, MarkedMs):
                timers.update(x.timer.split("+"))
    if timers:
        obj["timer"] = "+".join(sorted(timers))
        n += 1
    return n


def events_ms(fn, flush, reps: int) -> MarkedMs:
    """Device time of one call of ``fn`` in ms by CUDA events, ``flush``
    negated in place before each call: the timers' fallback when
    TRACE_TRIES profiler traces held no device rows. Not the profiler's
    yardstick: the events also take the gaps between the call's launches,
    and they stop before ``written_ms``'s write-back, so the result is
    marked "cuda_events"."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.bitwise_not_()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return MarkedMs(total / reps, "cuda_events")


def cold_ms(fn, reps: int = 20) -> float:
    """``cold_rows`` summed: the device time of one whole call in ms."""
    return sum(cold_rows(fn, reps).values())


def launch_split(rows: dict) -> str:
    """``cold_rows``' kernels by their short names, in us."""
    import re

    short = sorted(((re.search(r"\w+_kernel", k) or [k])[0], t)
                   for k, t in rows.items())
    return " + ".join(f"{name} {t * 1e3:.1f}" for name, t in short)


def time_kernel(kernel, plain, library):
    """(kernel ms, plain ms, library ms) per call, L2 flushed before each."""
    return cold_ms(kernel), cold_ms(plain), cold_ms(library)


def affinity_overlap(model, batch, corpus_embed, corpus, fused_ids,
                     exact_ids, chunk: int = 256) -> float:
    """Share of the fused top-k whose affinity is at or above the exact
    k-th affinity, both scored by one float32 function (tracks that share
    album and artist have equal vectors, so ties count as found)."""
    import torch

    from esrecsys_tpu_torch.models.playlist import affinity_scores

    found = []
    with torch.no_grad():
        for i in range(0, fused_ids.shape[0], chunk):
            sl = slice(i, i + chunk)
            actx = batch["album_context"][sl]
            artx = batch["artist_context"][sl]
            ctx = model.get_embeddings(actx, artx)

            def score(ids):
                return affinity_scores(ctx, corpus_embed[ids],
                                       corpus["albums"][ids],
                                       corpus["artists"][ids], actx, artx)

            kth = score(exact_ids[sl]).amin(-1, keepdim=True)
            found.append((score(fused_ids[sl]) >= kth).float().mean(-1))
    return float(torch.cat(found).mean())


def phase_train(card: str, work: str) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.retrieval.fused import pack_payload
    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.workloads import playlist as pl

    dev = torch.device("cuda")
    run = fsr.TrainRunConfig(
        out_dir=work, steps=STEPS, batch_size=2048, max_next=32,
        eval_every=STEPS, eval_playlists=2048, eval_fused_bins=4096,
        log_every=10, fused=True, device="cuda")
    kernels = {"gather_pool": gp, "scatter_add": sa, "fused_affinity": fa}
    # ---- the main path: 20 steps, one fused eval round, export
    for mod in kernels.values():
        mod.LAUNCHES.reset()
    t0 = time.perf_counter()
    tr = fsr.run_train(run)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES.count for name, mod in kernels.items()}
    # ---- checks of what came out
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the training path never launched {name}")
    res, cfg = tr["result"], tr["cfg"]
    report = fsr.train_report(run, tr)
    loss = res.last_train_metrics.get("train_loss", float("nan"))
    if res.steps_run != STEPS or not np.isfinite(loss):
        raise AssertionError(f"training: {res.steps_run} steps, loss {loss}")
    ev = res.last_eval_metrics
    if not ev or not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"fused eval metrics: {ev}")
    if not os.path.exists(tr["artifact"]):
        raise AssertionError("no trained artifact")
    log(f"train path: {STEPS} steps of the flagship (B=2048, C=5, M=32, "
        f"N=512 shared, bf16, momentum 0.98 dense carrier) + one fused "
        f"eval round + export in {path_s:.1f} s; launches {launches}; "
        f"loss of steps 11-20 {loss:.5f}; first step "
        f"{res.first_dispatch_s:.2f} s [{card}]")
    log(f"train throughput: {res.last_train_metrics['examples_per_sec']:.0f} "
        f"examples/s over steps 11-20 ("
        f"{res.last_train_metrics['ms_per_step']:.3f} ms/step, host clock); "
        f"steady {report['steady_examples_per_s']:.0f} examples/s without "
        f"the first step and the eval round [{card}]")
    log(f"eval round (fused, 2048 playlists x {run.num_tracks} tracks, "
        f"corpus embed + scan copy included): {res.eval_round_s[0] * 1e3:.1f}"
        f" ms; recall@500 track {ev['eval_track_recall']:.5f} artist "
        f"{ev['eval_artist_recall']:.5f} [{card}]")

    # ---- fused against exact eval on the same 2,048 playlists
    state, model = res.state, res.state.params
    corpus = {k: torch.from_numpy(v).to(dev)
              for k, v in fsr.synth_corpus(run).items()}
    batch = pl.to_device(fsr.host_batch(np.random.default_rng(999), 2048,
                                        5, 32, run), dev)
    aux = pl.make_corpus_embed_setup(model, cfg, corpus)(state)
    fused_topk = pl.make_eval_topk(model, cfg, corpus)
    exact_cfg = dataclasses.replace(cfg, eval_fused_bins=0)
    exact_topk = pl.make_eval_topk(model, exact_cfg, corpus)
    fused_ms = host_ms(lambda: (fused_topk(state, batch, aux),
                                torch.cuda.synchronize()), 3)
    fv, fi = fused_topk(state, batch, aux)
    t_exact = time.perf_counter()
    xv, xi = exact_topk(state, batch, aux[0])
    torch.cuda.synchronize()
    exact_ms = (time.perf_counter() - t_exact) * 1e3
    overlap = affinity_overlap(model, batch, aux[0], corpus, fi, xi)
    tracks, artists = corpus["tracks"], corpus["artists"]
    fm = pl._hit_metrics(batch, fv, fi, tracks, artists, 500)
    xm = pl._hit_metrics(batch, xv, xi, tracks, artists, 500)
    log(f"eval quality: fused overlap@500 vs exact {overlap:.5f} over 2048 "
        f"playlists (floor {QUALITY_FLOOR}); recall@500 track fused "
        f"{float(fm['track_recall']):.5f} exact "
        f"{float(xm['track_recall']):.5f} (diff "
        f"{float(fm['track_recall'] - xm['track_recall']):.2e}), artist "
        f"fused {float(fm['artist_recall']):.5f} exact "
        f"{float(xm['artist_recall']):.5f}")
    log(f"eval latency, 2048 playlists: fused top-500 {fused_ms:.1f} ms, "
        f"exact {exact_ms:.1f} ms (host clock, corpus embed excluded) "
        f"[{card}]")
    if overlap < QUALITY_FLOOR:
        raise AssertionError(f"eval overlap@500 {overlap} < {QUALITY_FLOOR}")
    # where a warm fused eval round's time goes: corpus embed, scan copy,
    # scan, candidate select, rescore, metrics
    setup = pl.make_corpus_embed_setup(model, cfg, corpus)
    eval_step = pl.make_eval_step(model, cfg, corpus)
    wall, busy, top = device_breakdown(
        lambda: (eval_step(state, batch, setup(state)),
                 torch.cuda.synchronize()), 3)
    if busy is None:
        log(f"breakdown fused eval round: {wall:.1f} ms per round, device "
            f"time not measured (no device rows in the trace) [{card}]")
    else:
        ops = ", ".join(f"{k[:40]} {v:.2f} ms" for k, v in top[:4])
        log(f"breakdown fused eval round (warm): {wall:.1f} ms per round "
            f"under the profiler, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.2f}); largest: {ops} [{card}]")

    # ---- fused_affinity at the eval's full shape
    with torch.no_grad():
        q = model.get_embeddings(batch["album_context"],
                                 batch["artist_context"]).to(torch.bfloat16)
    packed = aux[1]
    Mp = packed.shape[1]
    args = (q, packed, pack_payload(corpus["albums"], Mp),
            pack_payload(corpus["artists"], Mp),
            batch["album_context"].contiguous(),
            batch["artist_context"].contiguous())
    L, bound = 4096, run.num_tracks
    kv, ki = fa.fused_affinity_cuda(*args, L, bound)
    t_plain = time.perf_counter()
    pv, pi = fa.fused_affinity_plain(*args, L, bound)
    torch.cuda.synchronize()
    aff_plain_ms = (time.perf_counter() - t_plain) * 1e3
    aff_err, near, exact = compare_affinity(args, kv, ki, pv, pi)
    aff_ms = cuda_ms(lambda: fa.fused_affinity_cuda(*args, L, bound), 5)
    B, C, D = q.shape
    aff_flops = 2 * B * C * D * bound
    cols = -(-bound // L) * L  # catalog columns the scan reads
    aff_bytes = cols * (D * 2 + 8) + B * C * (D * 2 + 8) + B * 2 * L * 8
    aff_bound = max(aff_bytes / HBM_BYTES_PER_S,
                    aff_flops / BF16_FLOPS_PER_S) * 1e3
    aff_by = ("operations" if aff_flops / BF16_FLOPS_PER_S
              >= aff_bytes / HBM_BYTES_PER_S else "bytes")
    log(f"kernel fused_affinity B={B} C={C} D={D} Mp={Mp} L={L} (the eval "
        f"batch): ok, max_abs_err {aff_err:.3g}, near-tie id slots {near}, "
        f"exact-tie slots {exact}; {aff_ms:.3f} ms (mean of 5, CUDA events; "
        f"the previous design {AFFINITY_PREVIOUS_MS} ms, from PERF.md) "
        f"against its bound {aff_bound:.3f} ms by {aff_by} "
        f"({aff_flops:.3e} bf16 operations), plain version {aff_plain_ms:.1f}"
        f" ms (one call, host clock) [{card}]")

    # ---- K steps through the kernels against K steps through the plain
    # versions, from one initial state with the same batches and negatives
    feed = fsr.device_feed(run, cfg, dev)
    batches = [next(feed) for _ in range(K_STEPS)]
    neg_gen = torch.Generator(device=dev).manual_seed(5)
    negs = [torch.randint(0, run.num_tracks, (512,), generator=neg_gen,
                          device=dev, dtype=torch.int32)
            for _ in range(K_STEPS)]
    runs = []
    for use_plain in (False, True):
        m_k, s_k = pl.init_state(cfg, dev)
        step = pl.make_sparse_train_step(m_k, cfg, corpus, seed=0)
        ctx = plain_kernels() if use_plain else contextlib.nullcontext()
        with ctx:
            losses = [float(step(s_k, b, neg_ids=n)[1]["loss"])
                      for b, n in zip(batches, negs)]
        runs.append((s_k, losses))
    (sk, lk), (sp, lp) = runs
    worst = {}
    for name, a, b, atol in (
            ("album table", sk.params.album_embed.embedding,
             sp.params.album_embed.embedding, TRAIN_TABLE_ATOL),
            ("artist table", sk.params.artist_embed.embedding,
             sp.params.artist_embed.embedding, TRAIN_TABLE_ATOL),
            ("album momentum", sk.opt_state["album"]["momentum"],
             sp.opt_state["album"]["momentum"], TRAIN_MOMENTUM_ATOL),
            ("artist momentum", sk.opt_state["artist"]["momentum"],
             sp.opt_state["artist"]["momentum"], TRAIN_MOMENTUM_ATOL)):
        d = (a.detach() - b.detach()).abs()
        share = float((d > 1e-6).float().mean())
        worst[name] = (float(d.max()), share)
        if float(d.max()) > atol or share > TRAIN_DIFF_SHARE:
            raise AssertionError(f"{K_STEPS} steps, kernels against plain: "
                                 f"{name} max diff {float(d.max())}, share "
                                 f"over 1e-6 {share}")
    if not all(np.isfinite(lk)) or abs(lk[-1] - lp[-1]) > 1e-4 * abs(lp[-1]):
        raise AssertionError(f"losses kernels {lk} plain {lp}")
    log(f"train kernels vs plain, {K_STEPS} steps from seed 0: losses "
        f"{lk[-1]:.6f} / {lp[-1]:.6f}; max diff (share > 1e-6): "
        + ", ".join(f"{k} {v[0]:.3g} ({v[1]:.2e})" for k, v in worst.items())
        + f" [{card}]")

    # ---- gather_pool and scatter_add at the step's shapes, timed
    b0 = batches[0]
    alb_ids = torch.remainder(torch.cat([
        b0["album_context"].reshape(-1), b0["next_album"].reshape(-1),
        corpus["albums"][negs[0].long()]]), cfg.album_hash_buckets).int()
    art_ids = torch.cat([b0["artist_context"].reshape(-1),
                         b0["next_artist"].reshape(-1),
                         corpus["artists"][negs[0].long()]]).int()
    timed = {"gather_pool": [], "scatter_add": []}
    for name, table, ids in (
            ("album", sk.params.album_embed.embedding.detach(), alb_ids),
            ("artist", sk.params.artist_embed.embedding.detach(), art_ids)):
        R, Dt = table.shape
        n = ids.shape[0]
        ids2 = ids[:, None].contiguous()
        k = gp.gather_pool_cuda(table, ids2, False, -1)
        if not torch.equal(k, gp.gather_pool_plain(table, ids2, False, -1)):
            raise AssertionError(f"gather_pool differs on the {name} table")
        distinct = rows_bytes(ids, Dt)
        g_bytes = distinct + n * 4 + n * Dt * 4
        timed["gather_pool"].append(time_kernel(
            lambda: gp.gather_pool_cuda(table, ids2, False, -1),
            lambda: gp.gather_pool_plain(table, ids2, False, -1),
            lambda: table.index_select(0, ids)) + (
                g_bytes / HBM_BYTES_PER_S * 1e3,))
        upd = torch.randn(n, Dt, device="cuda") * 1e-3
        tk, tp = table.clone(), table.clone()
        sa.scatter_add_cuda(tk, ids, upd)
        sa.scatter_add_plain(tp, ids, upd)
        torch.cuda.synchronize()
        torch.testing.assert_close(tk, tp, rtol=TOL, atol=TOL)
        s_bytes = n * Dt * 4 + n * 4 + 2 * distinct
        timed["scatter_add"].append(time_kernel(
            lambda: sa.scatter_add_cuda(tk, ids, upd),
            lambda: sa.scatter_add_plain(tp, ids, upd),
            lambda: tp.index_add_(0, ids, upd)) + (
                s_bytes / HBM_BYTES_PER_S * 1e3,))
        if name == "album":
            # every id on one row, on the same yardstick
            same = torch.full((n,), 7, dtype=torch.int32, device="cuda")
            pile_ms = cold_ms(lambda: sa.scatter_add_cuda(tk, same, upd))
        log(f"path shapes, {name} table ({R} x {Dt}, {n} ids, "
            f"{distinct // (Dt * 4)} distinct), device time per call with "
            f"the L2 cache flushed before it (profiler, 20 calls): "
            f"gather_pool "
            f"{timed['gather_pool'][-1][0] * 1e3:.1f} us (plain "
            f"{timed['gather_pool'][-1][1] * 1e3:.1f}, index_select "
            f"{timed['gather_pool'][-1][2] * 1e3:.1f}, bound "
            f"{timed['gather_pool'][-1][3] * 1e3:.1f}); scatter_add "
            f"{timed['scatter_add'][-1][0] * 1e3:.1f} us (plain "
            f"{timed['scatter_add'][-1][1] * 1e3:.1f}, index_add_ "
            f"{timed['scatter_add'][-1][2] * 1e3:.1f}, bound "
            f"{timed['scatter_add'][-1][3] * 1e3:.1f}) [{card}]")
    gather_ms = sum(r[0] for r in timed["gather_pool"]) / 2
    log(f"gather_pool at the step's shapes: {gather_ms * 1e3:.2f} us, mean "
        f"of the two tables (previous design "
        f"{GATHER_POOL_PREVIOUS_MS * 1e3:.2f}, from PERF.md, not re-run) "
        f"[{card}]")
    scatter_ms = sum(r[0] for r in timed["scatter_add"]) / 2
    log(f"scatter_add at the step's shapes: {scatter_ms * 1e3:.2f} us, mean "
        f"of the two tables (previous design "
        f"{SCATTER_ADD_PREVIOUS_MS * 1e3:.2f}, from PERF.md, not re-run); "
        f"all {alb_ids.shape[0]} ids on one row of the album table: "
        f"{pile_ms * 1e3:.1f} us (same yardstick) [{card}]")

    # ---- where one train step's time goes
    step = pl.make_sparse_train_step(sk.params, cfg, corpus, seed=0)
    wall, busy, top = device_breakdown(
        lambda: (step(sk, b0, neg_ids=negs[0]), torch.cuda.synchronize()), 5)
    if busy is None:
        log(f"breakdown train step: {wall:.3f} ms per step, device time not "
            f"measured (no device rows in the trace) [{card}]")
    else:
        ops = ", ".join(f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:4])
        in_step = [v for k, v in top if "scatter_add_kernel" in k]
        log(f"breakdown train step: {wall:.3f} ms per step under the "
            f"profiler, device busy {busy:.3f} ms (idle share "
            f"{1 - busy / wall:.2f}); largest: {ops}; scatter_add "
            f"{sum(in_step) * 1e3:.1f} us per step (its two launches) "
            f"[{card}]")

    def mean(rows, i):
        return sum(r[i] for r in rows) / len(rows)

    out = {}
    for name in ("gather_pool", "scatter_add"):
        rows = timed[name]
        out[name] = {"launches": launches[name], "ms": mean(rows, 0),
                     "plain_ms": mean(rows, 1), "library_ms": mean(rows, 2),
                     "bound_ms": mean(rows, 3), "bound_by": "bytes"}
    out["device_feed_examples_per_s"] = \
        res.last_train_metrics["examples_per_sec"]
    out["eval_track_recall"] = ev["eval_track_recall"]
    out["fused_affinity"] = {
        "launches": launches["fused_affinity"], "max_abs_err": aff_err,
        "ms": aff_ms, "plain_ms": aff_plain_ms, "bound_ms": aff_bound,
        "bound_by": aff_by, "library_ms": None}
    return out


WIDE_FEATURES = 128           # the wide path's feature_size: 256-wide rows
WIDE_STEPS = 5                # its training steps (depth, cut from 20)
WIDE_CHECKED = 256            # eval playlists held against the plain
                              # version and the exact eval (of 2,048)
WIDE_CALLS = 10               # timed B=8 calls a served mode (cut from 20)


def phase_wide(card: str, work: str) -> dict:
    """The main path at feature_size 128 (a 256-wide catalog: album ||
    artist), every other width the quality flagship's (100,000 album
    buckets, 295,861 artists, B=2048, C=5, M=32, 512 shared negatives,
    dense carrier, bf16 scoring, eval_fused_bins 4096): WIDE_STEPS steps,
    one fused eval round over the 2,262,292 tracks (fused_affinity_generic
    at D=256), the export; the artifact served top-500 at B=8 fused
    (fused_scan_generic) and fused int8 (fused_scan_int8_generic) against
    the exact service, overlap@500 against the floors. Then the affinity
    kernel at the eval shape against its plain version (on WIDE_CHECKED
    playlists) and timed at the whole eval batch beside its operation
    bound, and the two scans at the served shape beside their byte
    bounds, each held against its plain version there first."""
    import dataclasses

    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa
    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.retrieval.fused import pack_payload
    from esrecsys_tpu_torch.serving.server import RetrievalService
    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.workloads import playlist as pl

    dev = torch.device("cuda")
    out_dir = os.path.join(work, "wide")
    run = fsr.TrainRunConfig(
        out_dir=out_dir, feature_size=WIDE_FEATURES, steps=WIDE_STEPS,
        batch_size=2048, max_next=32, eval_every=WIDE_STEPS,
        eval_playlists=2048, eval_fused_bins=4096, log_every=WIDE_STEPS,
        fused=True, device="cuda")
    # ---- the main path: steps, one fused eval round, export
    _reset_all_launches()
    t0 = time.perf_counter()
    tr = fsr.run_train(run)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _all_launches()
    res, cfg = tr["result"], tr["cfg"]
    loss = res.last_train_metrics.get("train_loss", float("nan"))
    ev = res.last_eval_metrics
    if res.steps_run != WIDE_STEPS or not np.isfinite(loss):
        raise AssertionError(f"wide training: {res.steps_run} steps, loss "
                             f"{loss}")
    if not ev or not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"wide fused eval metrics: {ev}")
    if not tr["artifact"] or not os.path.exists(tr["artifact"]):
        raise AssertionError("no wide artifact")
    for name in ("fused_affinity_generic", "gather_pool", "scatter_add"):
        if train_launches[name] <= 0:
            raise AssertionError(f"the wide path never launched {name}")
    if train_launches["fused_affinity"]:
        raise AssertionError("the tuned fused_affinity ran at D=256")
    log(f"wide path: feature_size {WIDE_FEATURES} (256-wide catalog), "
        f"{WIDE_STEPS} steps of the flagship's shape + one fused eval round "
        f"(2048 playlists x {run.num_tracks} tracks) + export in "
        f"{train_s:.1f} s; loss {loss:.5f}; eval round "
        f"{res.eval_round_s[0] * 1e3:.1f} ms (corpus embed and scan copy "
        f"included), recall@500 track {ev['eval_track_recall']:.5f} artist "
        f"{ev['eval_artist_recall']:.5f}; launches {train_launches} [{card}]")

    # ---- fused against exact eval, and the affinity kernel against its
    # plain version, on WIDE_CHECKED of the round's playlists
    state, model = res.state, res.state.params
    corpus = {k: torch.from_numpy(v).to(dev)
              for k, v in fsr.synth_corpus(run).items()}
    batch = pl.to_device(fsr.host_batch(np.random.default_rng(999), 2048,
                                        5, 32, run), dev)
    aux = pl.make_corpus_embed_setup(model, cfg, corpus)(state)
    part = {k: v[:WIDE_CHECKED] for k, v in batch.items()}
    fv, fi = pl.make_eval_topk(model, cfg, corpus)(state, part, aux)
    exact_topk = pl.make_eval_topk(
        model, dataclasses.replace(cfg, eval_fused_bins=0), corpus)
    xv, xi = exact_topk(state, part, aux[0])
    eval_overlap = affinity_overlap(model, part, aux[0], corpus, fi, xi)
    if eval_overlap < QUALITY_FLOOR:
        raise AssertionError(f"wide eval overlap@500 {eval_overlap} < "
                             f"{QUALITY_FLOOR}")
    with torch.no_grad():
        q = model.get_embeddings(batch["album_context"],
                                 batch["artist_context"]).to(torch.bfloat16)
    packed = aux[1]
    Mp = packed.shape[1]
    payload = (pack_payload(corpus["albums"], Mp),
               pack_payload(corpus["artists"], Mp))
    args = (q, packed, *payload, batch["album_context"].contiguous(),
            batch["artist_context"].contiguous())
    small = (q[:WIDE_CHECKED].contiguous(), packed, *payload,
             part["album_context"].contiguous(),
             part["artist_context"].contiguous())
    L, bound = 4096, run.num_tracks
    kv, ki = fa.fused_affinity_cuda(*small, L, bound)
    t_plain = time.perf_counter()
    pv, pi = fa.fused_affinity_plain(*small, L, bound)
    torch.cuda.synchronize()
    aff_plain_ms = (time.perf_counter() - t_plain) * 1e3
    aff_err, near, exact = compare_affinity(small, kv, ki, pv, pi, wide=True)
    aff_ms = cuda_ms(lambda: fa.fused_affinity_cuda(*args, L, bound), 3,
                     warmup=1)
    B, C, D = q.shape
    aff_flops = 2 * B * C * D * bound
    cols = -(-bound // L) * L
    aff_bytes = cols * (D * 2 + 8) + B * C * (D * 2 + 8) + B * 2 * L * 8
    aff_bound = max(aff_bytes / HBM_BYTES_PER_S,
                    aff_flops / BF16_FLOPS_PER_S) * 1e3
    aff_by = ("operations" if aff_flops / BF16_FLOPS_PER_S
              >= aff_bytes / HBM_BYTES_PER_S else "bytes")
    log(f"wide eval: fused overlap@500 vs exact {eval_overlap:.5f} over "
        f"{WIDE_CHECKED} playlists (floor {QUALITY_FLOOR}); kernel "
        f"fused_affinity_generic B={WIDE_CHECKED} C={C} D={D} Mp={Mp} "
        f"L={L}: ok, max_abs_err {aff_err:.3g}, near-tie id slots {near}, "
        f"exact-tie slots {exact}; plain version {aff_plain_ms:.1f} ms (one "
        f"call, host clock, {WIDE_CHECKED} playlists); at the whole eval "
        f"batch B={B}: {aff_ms:.3f} ms (mean of 3, CUDA events) against its "
        f"bound {aff_bound:.3f} ms by {aff_by} ({aff_flops:.3e} bf16 "
        f"operations) [{card}]")
    del aux, args, small, q, payload, kv, ki, pv, pi

    # ---- the artifact served: fused, fused int8, exact
    scfg = fsr.ServingRunConfig(out_dir=out_dir, feature_size=WIDE_FEATURES,
                                fused=True, device="cuda")
    _reset_all_launches()
    t0 = time.perf_counter()
    svc, report = fsr.serve_from_artifact(scfg, fsr.synth_corpus(scfg))
    index = svc.index
    svc8 = RetrievalService(index, max_k=500, max_batch=8, fused=True,
                            quantized=True, fused_bins=4096, device="cuda")
    exact_svc = RetrievalService(index, max_k=500, max_batch=8,
                                 device="cuda")
    rng = np.random.default_rng(0)
    vecs = index.vectors
    queries = (vecs[rng.integers(0, len(index), 64)]
               + rng.normal(size=(64, vecs.shape[1])).astype(np.float32)
               * 0.05 * np.abs(vecs).mean())
    answers = {"fused": svc.topk(queries, k=500),
               "fused int8": svc8.topk(queries, k=500),
               "exact": exact_svc.topk(queries, k=500)}
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = _all_launches()
    if vecs.shape != (run.num_tracks, 2 * WIDE_FEATURES):
        raise AssertionError(f"wide catalog {vecs.shape}")
    for name in ("fused_scan_generic", "fused_scan_int8_generic"):
        if serve_launches[name] <= 0:
            raise AssertionError(f"wide serving never launched {name}")
    if serve_launches["fused_scan"] or serve_launches["fused_scan_int8"]:
        raise AssertionError(f"a tuned scan ran at D=256: {serve_launches}")
    out = {"launches": {"fused_affinity_generic":
                        train_launches["fused_affinity_generic"],
                        "fused_scan_generic":
                        serve_launches["fused_scan_generic"],
                        "fused_scan_int8_generic":
                        serve_launches["fused_scan_int8_generic"]},
           "errs": {"fused_affinity_generic": aff_err},
           "fused_affinity_generic": {
               "ms": aff_ms, "plain_ms": aff_plain_ms,
               "plain_batch": WIDE_CHECKED, "bound_ms": aff_bound,
               "bound_by": aff_by},
           "eval_round_ms": res.eval_round_s[0] * 1e3,
           "eval_overlap": eval_overlap, "modes": {}}
    q8 = queries[:8]
    for mode, service, floor in (("fused", svc, QUALITY_FLOOR),
                                 ("fused int8", svc8, INT8_FLOOR)):
        ids, scores = answers[mode]
        if scores.shape != (64, 500) or not np.isfinite(scores).all():
            raise AssertionError(f"wide {mode}: scores {scores.shape} not "
                                 f"finite")
        overlap = overlap_at_k(exact_svc._items, queries, ids,
                               answers["exact"][0])
        ms = host_ms(lambda: service.topk(q8, k=500), WIDE_CALLS)
        out["modes"][mode] = {"overlap": overlap, "topk_ms": ms}
        log(f"wide serve {mode}: overlap@500 vs exact {overlap:.4f} over 64 "
            f"queries (floor {floor}); B=8 k=500 topk {ms:.3f} ms (median "
            f"of {WIDE_CALLS}, host clock) [{card}]")
        if overlap < floor:
            raise AssertionError(f"wide {mode} overlap@500 {overlap} < "
                                 f"{floor}")
    exact_ms = host_ms(lambda: exact_svc.topk(q8, k=500), WIDE_CALLS)
    out["modes"]["exact"] = {"topk_ms": exact_ms}
    log(f"wide serving path: {run.num_tracks} x {vecs.shape[1]} served in "
        f"{serve_s:.1f} s (embed {report['embed_catalog_s']:.2f} s, time to "
        f"first query {report['time_to_first_query_s']:.2f} s); exact B=8 "
        f"topk {exact_ms:.3f} ms; launches {serve_launches} [{card}]")
    # ---- the scans at the served shape (after the counts were read)
    qb = torch.from_numpy(q8).cuda().to(torch.bfloat16)
    M = len(index)
    L = svc._fused_bins
    cols = -(-M // L) * L
    for name, sc, cat, fn, plain, per_col in (
            ("fused_scan_generic", None, svc._items_packed,
             lambda: fs.fused_scan_cuda(qb, svc._items_packed, L, M),
             lambda: fs.fused_scan_plain(qb, svc._items_packed, L, M),
             2 * D),
            ("fused_scan_int8_generic", svc8._fused_scales,
             svc8._items_packed,
             lambda: fs.fused_scan_int8_cuda(qb, svc8._items_packed,
                                             svc8._fused_scales, L, M),
             lambda: fs.fused_scan_int8_plain(qb, svc8._items_packed,
                                              svc8._fused_scales, L, M),
             D + 4)):
        err, near, exact, _ = generic_against_plain(qb, cat, sc, L, M)
        out["errs"][name] = err
        log(f"kernel {name} B=8 D={D} L={L} (the served shape, trained "
            f"catalog): ok against the plain version, max_abs_err {err:.3g},"
            f" exact-tie slots {exact}, near-tie id slots {near} [{card}]")
        ms = cuda_ms(fn, 50)
        plain_ms = cuda_ms(plain, 1, warmup=1)
        moved = cols * per_col + 8 * D * 2 + 8 * 2 * L * 8
        t_ops = 2 * 8 * D * cols / BF16_FLOPS_PER_S
        bound_ms = max(moved / HBM_BYTES_PER_S, t_ops) * 1e3
        by = "bytes" if moved / HBM_BYTES_PER_S >= t_ops else "operations"
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by}
        log(f"kernel {name} B=8 D={D} L={L} (the served shape, trained "
            f"catalog): {ms * 1e3:.1f} us (mean of 50, CUDA events), bound "
            f"{bound_ms * 1e3:.1f} us by {by} ({moved / 1e9:.3f} GB), "
            f"{bound_ms / ms:.3f} of bound speed, plain version "
            f"{plain_ms:.1f} ms [{card}]")
    return out


def write_mpd(root: str, slices: int = 3, playlists: int = 2000,
              seed: int = 0) -> str:
    """Synthetic MPD slices for the CLI drill: 5,000 tracks on 1,500
    albums and 700 artists, playlists of 12 to 60 tracks. Returns their
    glob."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(slices):
        out = []
        for _ in range(playlists):
            ids = rng.choice(5000, int(rng.integers(12, 61)), replace=False)
            out.append({"num_tracks": len(ids), "tracks": [
                {"track_uri": f"spotify:track:{i}",
                 "album_uri": f"spotify:album:{i % 1500}",
                 "artist_uri": f"spotify:artist:{i % 700}"} for i in ids]})
        with open(os.path.join(root, f"mpd.slice.{s}.json"), "w") as f:
            json.dump({"playlists": out}, f)
    return os.path.join(root, "mpd.slice.*.json")


def feed_split(step, state, feed, place, steps: int = 10):
    """Host ms per step of a feed: (waiting for the batch, placing it on
    the card, the step's launches, wall per step), over ``steps`` steps
    ending in one device sync, after three warm-up steps."""
    import torch

    for _ in range(3):
        step(state, place(next(feed)))
    torch.cuda.synchronize()
    split = [0.0, 0.0, 0.0]
    t_all = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next(feed)
        t1 = time.perf_counter()
        batch = place(batch)
        t2 = time.perf_counter()
        step(state, batch)
        t3 = time.perf_counter()
        split = [split[0] + t1 - t0, split[1] + t2 - t1, split[2] + t3 - t2]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    return [x * 1e3 / steps for x in split] + [wall * 1e3 / steps]


def phase_harness(card: str, device_feed_eps: float) -> dict:
    """The training entry point on the card at the flagship's full width:
    ``workloads/playlist.train`` from packed shards with the checkpoint,
    eval and preemption cadences, a checkpoint round trip, a resume, a
    preemption, and the CLI on TFRecords written by the port's ETL."""
    import dataclasses

    import numpy as np
    import torch

    from esrecsys_tpu_torch.data import pipelines
    from esrecsys_tpu_torch.data.prefetch import prefetched
    from esrecsys_tpu_torch.etl import playlists as etl
    from esrecsys_tpu_torch.kernels import fused_affinity as fa
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.train import Checkpointer, PreemptionGuard
    from esrecsys_tpu_torch.workloads import playlist as pl

    kernels = {"gather_pool": gp, "scatter_add": sa, "fused_affinity": fa}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the data: packed shards (the data set cut, not its widths)
        run = fsr.TrainRunConfig(
            out_dir=tmp, steps=STEPS, batch_size=2048, max_next=32,
            eval_every=STEPS, eval_playlists=2048, eval_fused_bins=4096,
            log_every=10, ckpt_every=10, device="cuda")
        t0 = time.perf_counter()
        train_pattern = fsr.write_packed_shards(
            f"{tmp}/shards", HARNESS_SHARDS, HARNESS_SHARD_EXAMPLES, run, 5,
            32)
        eval_pattern = fsr.write_packed_shards(
            f"{tmp}/eval_shards", 1, HARNESS_EVAL_EXAMPLES, run, 5, 32,
            seed=1_000_000_099)
        write_s = time.perf_counter() - t0
        shard_mb = os.path.getsize(f"{tmp}/shards/packed-00000.npz") / 1e6
        cfg = dataclasses.replace(
            fsr.flagship_cfg(run), train_pattern=train_pattern,
            test_pattern=eval_pattern, work_dir=f"{tmp}/run",
            graceful_shutdown=True)
        corpus_np = fsr.train_corpus(run)
        log(f"harness data: {HARNESS_SHARDS} packed shards x "
            f"{HARNESS_SHARD_EXAMPLES} playlists ({shard_mb:.1f} MB each) + "
            f"one eval shard of {HARNESS_EVAL_EXAMPLES}, written in "
            f"{write_s:.2f} s; the data set's size is cut, not its widths "
            f"(C=5, M=32, the 2,262,292-track id ranges)")

        # ---- the main path: train() to step 20 from the files
        for mod in kernels.values():
            mod.LAUNCHES.reset()
        t0 = time.perf_counter()
        res = pl.train(cfg, corpus_np=corpus_np)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = {n: mod.LAUNCHES.count for n, mod in kernels.items()}
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"train() never launched {name}")
        ck = Checkpointer(f"{cfg.work_dir}/checkpoints")
        ev = res.last_eval_metrics
        loss = res.last_train_metrics.get("train_loss", float("nan"))
        if res.steps_run != STEPS or ck.all_steps() != [10, STEPS]:
            raise AssertionError(f"train(): {res.steps_run} steps, "
                                 f"checkpoints {ck.all_steps()}")
        if not ev or not all(np.isfinite(v) for v in ev.values()) \
                or not np.isfinite(loss):
            raise AssertionError(f"train(): loss {loss}, eval {ev}")
        artifact = f"{cfg.work_dir}/artifacts/playlist-{STEPS:08d}.npz"
        if not os.path.exists(artifact):
            raise AssertionError("train() exported no artifact")
        host_eps = res.last_train_metrics["examples_per_sec"]
        # the window of steps 11-20 holds the cadenced save at step 10
        window_s = 10 * cfg.batch_size / host_eps
        host_eps_nosave = 10 * cfg.batch_size / (window_s
                                                 - res.ckpt_save_s[0])
        log(f"harness path: train() from packed shards, {STEPS} steps of "
            f"the flagship + checkpoints at 10 and 20 + one fused eval "
            f"round + export in {path_s:.1f} s; launches {launches}; loss "
            f"of steps 11-20 {loss:.5f}; recall@500 track "
            f"{ev['eval_track_recall']:.5f} artist "
            f"{ev['eval_artist_recall']:.5f} [{card}]")
        log(f"harness throughput, steps 11-20, host clock: host feed "
            f"{host_eps:.0f} examples/s (the step-10 checkpoint save in its "
            f"window; {host_eps_nosave:.0f} without it) against the device "
            f"feed's {device_feed_eps:.0f} (train phase) [{card}]")

        # ---- where a step's host time goes, by feed (the counts are read):
        # the device feed, the packed shards through the prefetch thread
        # (train()'s feed), and the same shards pulled on this thread
        dev = torch.device("cuda")
        corpus = {k: torch.from_numpy(v).to(dev)
                  for k, v in corpus_np.items() if isinstance(v, np.ndarray)}
        model, st = pl.init_state(cfg)
        step = pl.select_train_step(model, cfg, corpus, seed=cfg.seed)

        def shards():
            return pipelines.packed_playlist_batches(
                train_pattern, cfg.batch_size, seed=cfg.seed)

        splits = {
            "device feed": feed_split(step, st, fsr.device_feed(run, cfg, dev),
                                      lambda b: b),
            "host feed, prefetch 2": feed_split(
                step, st, prefetched(shards(), 2),
                lambda b: pl.to_device(b, dev)),
            "host feed, no prefetch": feed_split(
                step, st, shards(), lambda b: pl.to_device(b, dev))}
        del model, st, step, corpus
        log("harness feeds, host ms per step (batch wait / placing it on "
            "the card / the step's launches / wall, 10 steps, one sync): "
            + "; ".join(f"{k} " + " / ".join(f"{x:.3f}" for x in v)
                        for k, v in splits.items()) + f" [{card}]")

        # ---- checkpoint 20 restored into a fresh template, bit for bit
        _, fresh = pl.init_state(dataclasses.replace(cfg, seed=cfg.seed + 1))
        ckpt_bytes = os.path.getsize(ck.path(STEPS))
        t0 = time.perf_counter()
        ck.restore(fresh, step=STEPS)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = res.state
        pairs = [("album table", fresh.params.album_embed.embedding,
                  want.params.album_embed.embedding),
                 ("artist table", fresh.params.artist_embed.embedding,
                  want.params.artist_embed.embedding)]
        pairs += [(f"{t} momentum", fresh.opt_state[t]["momentum"],
                   want.opt_state[t]["momentum"]) for t in ("album",
                                                            "artist")]
        for name, a, b in pairs:
            if not torch.equal(a, b):
                raise AssertionError(f"checkpoint round trip: {name} differs")
        if fresh.step != STEPS or not isinstance(fresh.step, int):
            raise AssertionError(f"checkpoint round trip: step {fresh.step}")
        log(f"harness checkpoint: {ckpt_bytes} bytes (two padded tables + "
            f"two momentum buffers); ckpt_save_s {list(res.ckpt_save_s)} "
            f"(the saves at 10 and 20, then the final save, skipped as step "
            f"20 is on disk); restore {restore_s:.3f} s; bit-equal round "
            f"trip of both tables, both momentum buffers and the step "
            f"[{card}]")
        del fresh

        # ---- resume to 30 from checkpoint 20 (the stream starts again)
        res2 = pl.train(dataclasses.replace(cfg, resume=True, max_steps=30),
                        corpus_np=corpus_np)
        loss2 = res2.last_train_metrics.get("train_loss", float("nan"))
        if res2.steps_run != 10 or res2.state.step != 30 \
                or not np.isfinite(loss2):
            raise AssertionError(f"resume: {res2.steps_run} steps to "
                                 f"{res2.state.step}, loss {loss2}")
        log(f"harness resume: 10 steps from checkpoint 20 to 30, loss of "
            f"steps 21-30 {loss2:.5f} [{card}]")
        del res, res2

        # ---- preemption: a managed guard stopped by a hook at step 15
        guard, stop = PreemptionGuard(), {}

        def stop_at(state, step):
            if step == PREEMPT_AT:
                stop["t"] = time.perf_counter()
                guard.request_stop()

        pcfg = dataclasses.replace(cfg, work_dir=f"{tmp}/preempt")
        with guard:
            res3 = pl.train(pcfg, corpus_np=corpus_np, preemption=guard,
                            hooks=[stop_at])
        stop_s = time.perf_counter() - stop["t"]
        saved = Checkpointer(f"{pcfg.work_dir}/checkpoints").all_steps()
        if not res3.preempted or saved[-1:] != [PREEMPT_AT] \
                or os.path.exists(f"{pcfg.work_dir}/artifacts"):
            raise AssertionError(
                f"preemption: preempted {res3.preempted}, checkpoints "
                f"{saved}, artifacts "
                f"{os.path.exists(f'{pcfg.work_dir}/artifacts')}")
        res4 = pl.train(dataclasses.replace(pcfg, resume=True),
                        corpus_np=corpus_np)
        if res4.steps_run != STEPS - PREEMPT_AT or res4.state.step != STEPS:
            raise AssertionError(f"resume after preemption: "
                                 f"{res4.steps_run} steps")
        log(f"harness preemption: stopped at step {PREEMPT_AT} "
            f"(checkpoints {saved}, no artifact), {stop_s:.3f} s "
            f"from request_stop() to train()'s return (its final save "
            f"included); resumed to step {STEPS} [{card}]")
        del res3, res4

        # ---- the CLI on TFRecords written by the port's ETL
        pattern = write_mpd(f"{tmp}/mpd")
        data = f"{tmp}/training"
        t0 = time.perf_counter()
        etl.main(["--playlists", pattern, "--output", data])
        etl_s = time.perf_counter() - t0
        records = f"{data}/*.tfrecord"
        tf_bytes = sum(os.path.getsize(os.path.join(data, f))
                       for f in os.listdir(data) if f.endswith(".tfrecord"))
        t0 = time.perf_counter()
        n_rec = sum(1 for _ in pipelines.playlist_batches(
            records, max_next=32, repeat=False))
        read_s = time.perf_counter() - t0
        log(f"harness tfrecords: the port's ETL wrote {n_rec} playlists "
            f"({tf_bytes} bytes) in {etl_s:.2f} s; the reader took "
            f"{read_s:.3f} s: {n_rec / read_s:.0f} records/s, "
            f"{tf_bytes / read_s / 1e6:.2f} MB/s on the card's host "
            f"[{card}]")
        wd = f"{tmp}/cli"
        here = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "esrecsys_tpu_torch.workloads.playlist",
               "--train_pattern", records, "--test_pattern", records,
               "--all_tracks", f"{data}/all_tracks.json",
               "--dictionaries", data, "--work_dir", wd,
               "--album_hash_buckets", "1000", "--num_artists", "700",
               "--num_negatives", "64", "--shared_negatives", "true",
               "--sparse_updates", "true", "--batch_size", "64",
               "--max_next", "32", "--max_steps", "6",
               "--log_every_steps", "3", "--eval_every_steps", "6",
               "--eval_steps", "64", "--checkpoint_every_steps", "3"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                             timeout=600,
                             env={**os.environ, "PYTHONPATH": here})
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"CLI exit {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        cli_ck = Checkpointer(f"{wd}/checkpoints").all_steps()
        if cli_ck != [3, 6] or not os.path.exists(
                f"{wd}/artifacts/playlist-00000006.npz"):
            raise AssertionError(f"CLI left checkpoints {cli_ck}, artifacts "
                                 f"{os.listdir(wd)}")
        log(f"harness CLI: python -m esrecsys_tpu_torch.workloads.playlist "
            f"on those TFRecords, 6 steps on the card, exit 0 in "
            f"{cli_s:.1f} s (process start included), checkpoints "
            f"{cli_ck}, artifact playlist-00000006.npz [{card}]")
    return {"launches": launches}


def http_json(url: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=300) as r:
        return json.loads(r.read())


def overlap_at_k(svc_items, queries, fused_ids, exact_ids,
                 fused_scores=None) -> float:
    """Share of the fused answer whose exact score is at or above the
    exact k-th score, both scored by one float32 multiply-sum (tracks
    share album and artist rows, so equal scores are common). With
    ``fused_scores``, a slot scored -inf (fewer eligible candidates than
    k, as an IVF probe may find) counts as a miss."""
    import torch

    q = torch.from_numpy(queries).to(svc_items.device)

    def scores(ids):
        idx = torch.from_numpy(ids.astype("int64")).to(svc_items.device)
        return (svc_items[idx] * q[:, None, :]).sum(-1)

    kth = scores(exact_ids).min(dim=-1, keepdim=True).values
    found = scores(fused_ids) >= kth
    if fused_scores is not None:
        found &= torch.from_numpy(fused_scores).to(found.device).isfinite()
    return float(found.float().mean(dim=-1).mean())


def phase_main(card: str, work: str):
    """Serve the artifact the train phase exported in ``work``."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.serving.server import RetrievalService, serve
    from esrecsys_tpu_torch.tools.full_scale_run import (ServingRunConfig,
                                                         serve_from_artifact,
                                                         synth_corpus)

    cfg = ServingRunConfig(out_dir=work, fused=True, device="cuda")
    corpus = synth_corpus(cfg)
    fs.LAUNCHES.reset()
    # ---- the main path: trained artifact -> catalog -> fused + exact
    t0 = time.perf_counter()
    svc, report = serve_from_artifact(cfg, corpus)
    index = svc.index
    exact = RetrievalService(index, max_k=500, max_batch=8,
                             device="cuda")
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(index), 64)
    vecs = index.vectors
    queries = (vecs[rows] + rng.normal(size=(64, vecs.shape[1]))
               .astype(np.float32) * 0.05 * np.abs(vecs).mean())
    f_ids, f_scores = svc.topk(queries, k=500)
    e_ids, e_scores = exact.topk(queries, k=500)
    httpd = serve(index, port=0, max_k=500, max_batch=8, fused=True,
                  fused_bins=4096, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = http_json(f"{url}/healthz")
        one = http_json(f"{url}/v1/topk",
                        {"vector": queries[0].tolist(), "k": 500})
        by_id = http_json(f"{url}/v1/topk", {"id": "17", "k": 10,
                                              "exclude": ["17"]})
        batch = http_json(f"{url}/v1/topk",
                          {"vectors": queries[:8].tolist(), "k": 500})
        stats = http_json(f"{url}/statsz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fs.LAUNCHES.count
    # ---- checks of what came out
    if launches <= 0:
        raise AssertionError("the main path never launched fused_scan")
    if health["items"] != cfg.num_tracks or health["dim"] != 64:
        raise AssertionError(f"healthz: {health}")
    if len(one["ids"]) != 500 or one["ids"] != list(f_ids[0]):
        raise AssertionError("HTTP single query differs from topk")
    if len(by_id["ids"]) != 10 or "17" in by_id["ids"]:
        raise AssertionError(f"HTTP id query: {by_id}")
    if [len(r) for r in batch["ids"]] != [500] * 8:
        raise AssertionError("HTTP batch query is not (8, 500)")
    if stats["mode"] != "fused:bins=4096" or stats["queries"] < 10:
        raise AssertionError(f"statsz: {stats}")
    for name, s in (("fused", f_scores), ("exact", e_scores)):
        if s.shape != (64, 500) or not np.isfinite(s).all():
            raise AssertionError(f"{name} scores {s.shape} not finite")
    overlap = overlap_at_k(svc._items, queries, f_ids, e_ids)
    log(f"serve path: {cfg.num_tracks} tracks D=64 of the trained model "
        f"served in "
        f"{main_s:.1f} s (embed {report['embed_catalog_s']:.2f} s, "
        f"time to first query {report['time_to_first_query_s']:.2f} s), "
        f"fused_scan launches {launches}, HTTP requests 5 ok [{card}]")
    log(f"quality: fused overlap@500 vs exact {overlap:.4f} over 64 "
        f"queries (floor {QUALITY_FLOOR})")
    if overlap < QUALITY_FLOOR:
        raise AssertionError(f"overlap@500 {overlap} < {QUALITY_FLOOR}")

    # ---- timings at B=8 (after the counts were read)
    q8 = queries[:8]
    fused_ms = host_ms(lambda: svc.topk(q8, k=500), 20)
    exact_ms = host_ms(lambda: exact.topk(q8, k=500), 20)
    packed = svc._items_packed
    qb = torch.from_numpy(q8).cuda().to(torch.bfloat16)
    L, M = svc._fused_bins, len(index)
    kernel_ms = cuda_ms(lambda: fs.fused_scan_cuda(qb, packed, L, M), 50)
    plain_ms = cuda_ms(lambda: fs.fused_scan_plain(qb, packed, L, M), 3,
                       warmup=1)
    D = packed.shape[0]
    bound_ms, bound_by = scan_bound(q8.shape[0], D, -(-M // L) * L, L)
    log(f"latency B=8 k=500: fused topk {fused_ms:.3f} ms, exact topk "
        f"{exact_ms:.3f} ms (median of 20, host clock) [{card}]")
    log(f"kernel fused_scan B=8 D={D} Mp={packed.shape[1]} L={L}: "
        f"{kernel_ms * 1e3:.1f} us (mean of 50, CUDA events), bound "
        f"{bound_ms * 1e3:.1f} us by {bound_by}, plain version "
        f"{plain_ms:.3f} ms [{card}]")
    # where a served call's time goes, from a torch.profiler trace
    for name, svc_ in (("fused", svc), ("exact", exact)):
        wall, busy, top = device_breakdown(
            lambda: svc_.topk(q8, k=500), 20)
        if busy is None:
            log(f"breakdown {name} topk B=8: {wall:.3f} ms per call, "
                f"device time not measured (no device rows in the "
                f"trace) [{card}]")
            continue
        ops = ", ".join(f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:4])
        log(f"breakdown {name} topk B=8: {wall:.3f} ms per call under "
            f"the profiler, device busy {busy:.3f} ms (idle share "
            f"{1 - busy / wall:.2f}); largest: {ops} [{card}]")
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "fused_topk_ms": fused_ms, "exact_topk_ms": exact_ms,
            "overlap": overlap}, {"index": index, "exact": exact,
                                  "queries": queries, "exact_ids": e_ids}


INT8_MODES = (
    ("int8", {"quantized": True}),
    ("int8+r8", {"quantized": True, "rescore_int8": True}),
    ("fused:bins=4096+int8", {"fused": True, "quantized": True}),
    ("fused:bins=4096+int8+r8", {"fused": True, "quantized": True,
                                 "rescore_int8": True}),
)


def fused_int8_witness(svc, exact_items, queries, exact_ids) -> dict:
    """Where the fused int8 modes lose overlap@500, each answer rescored in
    float32 from the resident rows: the int8 scan's candidates with the
    top 500 (the served path) and the top 2,000 by scan score rescored,
    and the top 500 by the int8 and by the bf16 scan score over the whole
    catalog, with no bins (each rounding's own loss, without bin
    collisions)."""
    import torch

    from esrecsys_tpu_torch.retrieval.fused import binned_candidates
    from esrecsys_tpu_torch.retrieval.mips import topk_lower_index_first

    q = torch.from_numpy(queries).to(exact_items.device)
    M = exact_items.shape[0]

    def overlap(cand):  # (B, n) int64 candidates -> overlap@500 of their top
        s = (exact_items[cand] * q[:, None, :]).sum(-1)
        _, sel = topk_lower_index_first(s, 500)
        return overlap_at_k(exact_items, queries,
                            torch.gather(cand, -1, sel).cpu().numpy(),
                            exact_ids)

    out = {}
    vals, ids = binned_candidates(q, svc._items_packed, M, svc._fused_bins,
                                  item_scales=svc._fused_scales)
    for width in (500, 2000):
        _, sel = topk_lower_index_first(vals, width)
        out[f"bins, {width} rescored"] = overlap(
            torch.gather(ids, -1, sel).long())
    qb = q.to(torch.bfloat16).float()
    int8 = (qb @ svc._items_packed[:, :M].float()) * svc._fused_scales[:M]
    out["int8, no bins"] = overlap(torch.topk(int8, 500).indices)
    del int8
    bf16 = qb @ exact_items.to(torch.bfloat16).float().T
    out["bf16, no bins"] = overlap(torch.topk(bf16, 500).indices)
    return out


def phase_int8(card: str, ctx: dict) -> dict:
    """Serve the trained catalog in the four int8 modes and through one
    HTTP request of serve(fused, quantized, rescore_int8)."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.serving.server import RetrievalService, serve

    index, exact, queries = ctx["index"], ctx["exact"], ctx["queries"]
    fs.LAUNCHES_INT8.reset()
    # ---- the main path: the four int8 modes, then HTTP
    t0 = time.perf_counter()
    services, answers = {}, {}
    built = {}
    for mode, kw in INT8_MODES:
        t_build = time.perf_counter()
        svc = RetrievalService(index, max_k=500, max_batch=8,
                               fused_bins=4096, device="cuda", **kw)
        built[mode] = time.perf_counter() - t_build
        services[mode] = svc
        answers[mode] = svc.topk(queries, k=500)
    httpd = serve(index, port=0, max_k=500, max_batch=8, fused=True,
                  fused_bins=4096, quantized=True, rescore_int8=True,
                  device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        one = http_json(f"{url}/v1/topk",
                        {"vector": queries[0].tolist(), "k": 500})
        stats = http_json(f"{url}/statsz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = fs.LAUNCHES_INT8.count
    # ---- checks of what came out
    if launches <= 0:
        raise AssertionError("the fused int8 modes never launched "
                             "fused_scan_int8")
    r8 = "fused:bins=4096+int8+r8"
    if one["ids"] != list(answers[r8][0][0]):
        raise AssertionError("HTTP int8+r8 query differs from topk")
    if (stats["mode"] != r8
            or stats["resident_bytes_per_item"] != 2 * (64 + 4)):
        raise AssertionError(f"statsz: {stats}")
    # the device quantizer (int8: from the resident float32 rows) against
    # its numpy twin (int8+r8: quantized on the host), whole catalog
    dq, hq = services["int8"], services["int8+r8"]
    if hq._items is not None or services[r8]._items is not None:
        raise AssertionError("rescore_int8 kept a float32 catalog")
    if not (torch.equal(dq._q_items, hq._q_items) and torch.equal(
            dq._scales.view(torch.int32), hq._scales.view(torch.int32))):
        raise AssertionError("quantize_rows on the card differs from "
                             "quantize_rows_np")
    log(f"int8 path: {len(index)} tracks served in 4 int8 modes + 1 HTTP "
        f"request in {path_s:.1f} s, fused_scan_int8 launches {launches}; "
        f"quantize_rows on the card equals quantize_rows_np bit for bit "
        f"over {dq._q_items.numel()} codes and {dq._scales.numel()} scales "
        f"[{card}]")
    q8 = queries[:8]
    out = {"launches": launches, "modes": {}}
    for mode, svc in services.items():
        ids, scores = answers[mode]
        if (svc.mode != mode or scores.shape != (64, 500)
                or not np.isfinite(scores).all()):
            raise AssertionError(f"{mode}: mode {svc.mode}, scores "
                                 f"{scores.shape} not finite")
        overlap = overlap_at_k(exact._items, queries, ids, ctx["exact_ids"])
        ms = host_ms(lambda: svc.topk(q8, k=500), 20)
        wall, busy, top = device_breakdown(lambda: svc.topk(q8, k=500), 5)
        if busy is None:
            split = "device time not measured (no device rows in the trace)"
        else:
            split = (f"device busy {busy:.3f} ms (idle share "
                     f"{1 - busy / wall:.2f}); largest: " + ", ".join(
                         f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:4]))
        log(f"serve {mode}: built in {built[mode]:.2f} s (upload, "
            f"quantize, scan copy, warm-up query); overlap@500 vs exact "
            f"{overlap:.4f} over 64 queries (floor {INT8_FLOOR}), "
            f"{svc.resident_bytes_per_item} resident bytes per item; B=8 "
            f"k=500 topk {ms:.3f} ms (median "
            f"of 20, host clock); breakdown {wall:.3f} ms per call under "
            f"the profiler, {split} [{card}]")
        if overlap < INT8_FLOOR:
            raise AssertionError(f"{mode} overlap@500 {overlap} < "
                                 f"{INT8_FLOOR}")
        out["modes"][mode] = {"overlap": overlap, "topk_ms": ms}
    svc = services["fused:bins=4096+int8"]
    witness = fused_int8_witness(svc, exact._items, queries,
                                 ctx["exact_ids"])
    log("fused int8 overlap@500 vs exact over 64 queries, by where the "
        "candidates come from (each rescored in float32): " + ", ".join(
            f"{k} {v:.4f}" for k, v in witness.items()) + f" [{card}]")
    if abs(witness["bins, 500 rescored"]
           - out["modes"]["fused:bins=4096+int8"]["overlap"]) > 1e-6:
        raise AssertionError(f"the witness's served path {witness} differs "
                             f"from the fused int8 service")
    # ---- the int8 kernel at the served shape, timed
    codes, scales = svc._items_packed, svc._fused_scales
    qb = torch.from_numpy(q8).cuda().to(torch.bfloat16)
    L, M = svc._fused_bins, len(index)
    kernel_ms = cuda_ms(
        lambda: fs.fused_scan_int8_cuda(qb, codes, scales, L, M), 50)
    plain_ms = cuda_ms(
        lambda: fs.fused_scan_int8_plain(qb, codes, scales, L, M), 3,
        warmup=1)
    D, Mp = codes.shape
    cols = -(-M // L) * L
    moved = cols * (D + 4) + q8.shape[0] * D * 2 + q8.shape[0] * 2 * L * 8
    flops = 2 * q8.shape[0] * D * cols
    out["ms"], out["plain_ms"] = kernel_ms, plain_ms
    out["bound_ms"] = max(moved / HBM_BYTES_PER_S,
                          flops / BF16_FLOPS_PER_S) * 1e3
    out["bound_by"] = ("bytes" if moved / HBM_BYTES_PER_S
                       >= flops / BF16_FLOPS_PER_S else "operations")
    log(f"kernel fused_scan_int8 B=8 D={D} Mp={Mp} L={L}: "
        f"{kernel_ms * 1e3:.1f} us (mean of 50, CUDA events; previous "
        f"design {FUSED_SCAN_INT8_PREVIOUS_MS * 1e3:.1f}, from PERF.md, "
        f"not re-run), bound {out['bound_ms'] * 1e3:.1f} us by "
        f"{out['bound_by']} ({moved / 1e6:.1f} MB), plain version "
        f"{plain_ms:.3f} ms [{card}]")
    return out


APPROX_FLOOR = 0.95           # approx modes' overlap@500 (reference's target)
GROWTH_CAPACITY = 65_536      # add_capacity of the growth checks
GROWTH_ADDS = 4               # adds of GROWTH_ROWS rows each (cut from 8)
GROWTH_ROWS = 1024
GROWTH_MODES = (
    ("exact", {}),
    ("approx", {"approx": True}),
    ("fused:bins=4096", {"fused": True}),
    ("fused:bins=4096+int8", {"fused": True, "quantized": True}),
)
# serving_bench's overlap floors (PERF.md section 2); filtered is exact
# over its eligible rows up to float32 summation order. The IVF and PQ
# modes' are for the bench's --structured catalog (the sublinear phase),
# where the reference measured 0.991 and 0.980: about a point below
BENCH_FLOORS = {"exact": None, "approx": APPROX_FLOOR,
                "fused": QUALITY_FLOOR, "fused_q8": INT8_FLOOR,
                "fused_q8_r8": INT8_FLOOR, "quantized": INT8_FLOOR,
                "quantized_approx": APPROX_FLOOR, "quantized_r8": INT8_FLOOR,
                "filtered": QUALITY_FLOOR, "ivf": 0.98, "pq": 0.98,
                "ivf_pq": 0.98, "ivf_quantized": 0.97, "pq_r8": 0.97,
                "ivf_pq_r8": 0.97}
SUBLINEAR_MODES = ("ivf", "ivf_quantized", "pq", "ivf_pq", "pq_r8",
                   "ivf_pq_r8")
BENCH_QUERIES = 256           # serving_bench --queries, cut from 2048, 512
SERVE_TIMED = 10              # timed B=8 calls a mode in the modes and
#                               sublinear phases (cut from 20)
BENCH_REPS = 1                # serving_bench --reps, cut from 3
DEPLOY_CYCLES = 1             # deploy cycles into a live server, cut from 2


def check_approx_select(card: str, items) -> dict:
    """One flagship block's bf16 scores through approx_select_ids on the
    card and on the CPU: identical ids, on the scores as they are, rounded
    to a coarse grid (ties everywhere), and with planted ties (a whole bin
    group equal: its first position must win; two bins of equal maxima:
    the lower bin first)."""
    import torch

    from esrecsys_tpu_torch.retrieval import mips

    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(8, items.shape[1], generator=gen, device="cuda")
    s = mips.bf16_scores(q.to(torch.bfloat16), items[:262_144])
    out = {}
    for kb in (256, 223):
        L, r = mips.approx_reduction_size(s.shape[1], kb, 0.95)
        planted = s.clone()
        top = float(s.max()) + 1.0
        planted[:, 5::L] = top            # bin 5's whole group ties
        planted[:, 9 + 3 * L] = top       # bin 9 ties bin 5, at row 3
        cases = {"scores": s, "coarse": (s * 4).round() / 4,
                 "planted": planted}
        for name, case in cases.items():
            on_card = mips.approx_select_ids(case, kb, 0.95)
            on_cpu = mips.approx_select_ids(case.cpu(), kb, 0.95)
            if not torch.equal(on_card.cpu(), on_cpu):
                raise AssertionError(f"approx select kb={kb} {name}: the "
                                     f"card's ids differ from the CPU's")
            if name == "planted" and not (
                    on_card[:, 0].eq(5).all() and on_card[:, 1].eq(
                        9 + 3 * L).all()):
                raise AssertionError(f"planted ties: {on_card[:, :2]}")
        out[kb] = (L, r)
    log(f"approx select on one block (8 x 262144 bf16 scores, float32 "
        f"sums): the card's ids equal the CPU's for kb 256 and 223 (L, r "
        f"{out[256]}, {out[223]}), on the scores, on a 0.25 grid and with "
        f"planted ties (first position of a bin group, lower bin) [{card}]")
    return out


def growth_rows(vecs, rng, n: int):
    """n rows near the catalog; a quarter scaled by 3 (they win the
    queries made from them)."""
    import numpy as np

    rows = (vecs[rng.integers(0, len(vecs), n)]
            + rng.normal(size=(n, vecs.shape[1])).astype(np.float32)
            * 0.05 * np.abs(vecs).mean())
    rows[: n // 4] *= 3.0
    return rows.astype(np.float32)


def check_growth(card: str, index, queries) -> dict:
    """add_capacity in four modes: 8 adds of 1,024 rows written in place,
    then the answers of a fresh service of the same mode on the grown
    catalog (ids identical, scores within 1e-6), no buffer reallocated."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving.server import RetrievalService

    rng = np.random.default_rng(11)
    vecs = index.vectors
    adds = [growth_rows(vecs, rng, GROWTH_ROWS) for _ in range(GROWTH_ADDS)]
    new_ids = [[f"add{a}-{i}" for i in range(GROWTH_ROWS)]
               for a in range(GROWTH_ADDS)]
    grown_vecs = np.concatenate([vecs] + adds)
    grown_ids = list(index.ids) + sum(new_ids, [])
    # queries made from added rows that win, and the served queries
    q = np.concatenate([adds[a][:4] for a in range(GROWTH_ADDS)]
                       + [queries[:32]])
    out = {}
    for mode, kw in GROWTH_MODES:
        svc = RetrievalService(
            EmbeddingIndex(list(index.ids), vecs), max_k=500, max_batch=8,
            add_capacity=GROWTH_CAPACITY, device="cuda", **kw)
        bufs = {n: getattr(svc, n) for n in (
            "_items", "_q_items", "_scales", "_items_packed",
            "_fused_scales") if getattr(svc, n) is not None}
        ptrs = {n: b.data_ptr() for n, b in bufs.items()}
        times = []
        for a in range(GROWTH_ADDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.add_items(new_ids[a], adds[a])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        got_ids, got_scores = svc.topk(q, k=500)
        moved = [n for n, b in bufs.items()
                 if getattr(svc, n).data_ptr() != ptrs[n]]
        del svc, bufs
        fresh = RetrievalService(EmbeddingIndex(grown_ids, grown_vecs),
                                 max_k=500, max_batch=8, device="cuda", **kw)
        want_ids, want_scores = fresh.topk(q, k=500)
        del fresh
        if answers_differ(got_ids, got_scores, want_ids, want_scores):
            raise AssertionError(f"growth {mode}: answers differ from a "
                                 f"fresh service on the grown catalog")
        if moved:
            raise AssertionError(f"growth {mode}: reallocated {moved}")
        won = np.mean([got_ids[i][0] == new_ids[i // 4][i % 4]
                       for i in range(4 * GROWTH_ADDS)])
        if won < 0.5:
            raise AssertionError(f"growth {mode}: added rows won only "
                                 f"{won:.2f} of their queries")
        times.sort()
        out[mode] = {"ms_per_add_median": times[len(times) // 2],
                     "ms_per_add": times, "own_row_first": float(won)}
        log(f"growth {mode}: {GROWTH_ADDS} adds of {GROWTH_ROWS} rows into "
            f"add_capacity {GROWTH_CAPACITY}, {times[len(times) // 2]:.2f} "
            f"ms per add (median, host clock, min {times[0]:.2f}, max "
            f"{times[-1]:.2f}); {len(q)} queries equal a fresh service on "
            f"the grown {len(grown_ids)} items (ids identical, scores "
            f"within 1e-6); buffers {sorted(ptrs)} not reallocated; added "
            f"rows first for {won:.2f} of their own queries [{card}]")
    return out


def answers_differ(got_ids, got_scores, want_ids, want_scores) -> bool:
    import numpy as np

    return not (np.array_equal(got_ids, want_ids) and np.allclose(
        got_scores, want_scores, rtol=0, atol=1e-6))


def live_traffic(url: str, queries):
    """Two client threads posting top-500 queries to /v1/topk until
    halted: (start, halt, errors, sent)."""
    stop, errors, sent = threading.Event(), [], [0]

    def client():
        i = 0
        while not stop.is_set():
            try:
                http_json(f"{url}/v1/topk", {
                    "vector": queries[i % len(queries)].tolist(), "k": 500})
                sent[0] += 1
            except Exception as e:  # every failure is counted
                errors.append(repr(e))
            i += 1

    clients = [threading.Thread(target=client) for _ in range(2)]

    def start():
        for c in clients:
            c.start()

    def halt():
        stop.set()
        for c in clients:
            if c.ident is not None:
                c.join(timeout=120)

    return start, halt, errors, sent


def check_reload(card: str, index, queries, work: str) -> dict:
    """A live fused server reloaded under traffic to the catalog perturbed
    and saved as npz: no failed request, then the answers of a fresh
    service on the new index."""
    import numpy as np

    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving.server import RetrievalService, serve

    rng = np.random.default_rng(12)
    vecs = index.vectors
    path = os.path.join(work, "perturbed.npz")
    EmbeddingIndex(index.ids, vecs + rng.normal(size=vecs.shape).astype(
        np.float32) * 0.01 * np.abs(vecs).mean()).save(path)
    httpd = serve(index, port=0, max_k=500, max_batch=8, fused=True,
                  device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    start, halt, errors, sent = live_traffic(url, queries)
    try:
        start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        rep = http_json(f"{url}/admin/reload", {"index": path})
        wall = time.perf_counter() - t0
        time.sleep(1.0)
        halt()
        stats = http_json(f"{url}/statsz")
        live = httpd.service.topk(queries, k=500)
        one = http_json(f"{url}/v1/topk",
                        {"vector": queries[0].tolist(), "k": 500})
    finally:
        halt()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    fresh = RetrievalService(EmbeddingIndex.load(path), max_k=500,
                             max_batch=8, fused=True, device="cuda")
    want = fresh.topk(queries, k=500)
    del fresh
    if errors:
        raise AssertionError(f"reload: {len(errors)} failed requests, "
                             f"first {errors[0]}")
    if rep.get("status") != "ok" or stats["reloads"] != 1:
        raise AssertionError(f"reload: {rep}, statsz {stats}")
    if answers_differ(live[0], live[1], want[0], want[1]) or \
            one["ids"] != list(want[0][0]):
        raise AssertionError("reload: answers differ from a fresh service "
                             "on the new index")
    log(f"hot reload of a live fused server to the perturbed catalog "
        f"({len(vecs)} items, npz): reload_seconds "
        f"{rep['reload_seconds']:.3f} (server), {wall:.3f} s (client); "
        f"{sent[0]} requests from 2 client threads during and 1 s after, "
        f"0 failed; statsz reloads {stats['reloads']}; the answers equal a "
        f"fresh fused service on the new index [{card}]")
    return {"reload_seconds": rep["reload_seconds"], "client_s": wall,
            "requests": sent[0], "failed": len(errors),
            "reloads": stats["reloads"]}


def check_deploy(card: str, work: str) -> dict:
    """full_scale_run's deploy cycles at full width: 20 steps, then
    DEPLOY_CYCLES cycles of 10 steps, each exported, embedded, saved and
    reloaded into a live approx server."""
    from esrecsys_tpu_torch.tools import full_scale_run as fsr

    out_dir = os.path.join(work, "deploy")
    res = fsr.main(["--out_dir", out_dir, "--train", "--steps", "20",
                    "--deploy_cycles", str(DEPLOY_CYCLES),
                    "--cycle_steps", "10",
                    "--deploy_serve_mode", "approx",
                    "--deploy_quality_queries", "64"])
    cycles = res["deploy_cycles"]
    if len(cycles) != DEPLOY_CYCLES or \
            not all(c["probe_hit"] for c in cycles) or \
            res["deploy_final_step"] != 20 + 10 * DEPLOY_CYCLES:
        raise AssertionError(f"deploy cycles: {res}")
    for c in cycles:
        if c["overlap_at_k"] < APPROX_FLOOR:
            raise AssertionError(f"deploy cycle overlap: {c}")
        log(f"deploy cycle {c['cycle']} (approx server, 10 steps of the "
            f"flagship at full width): retrain {c['retrain_s']:.3f} s, "
            f"embed and save {c['embed_and_save_s']:.3f} s, reload "
            f"{c['reload_s']:.3f} s, artifact to live {c['artifact_to_live_s']:.3f} s, probe hit "
            f"{c['probe_hit']}, overlap@100 {c['overlap_at_k']:.4f} over 64 "
            f"queries [{card}]")
    return {"cycles": cycles, "server_startup_s":
            res["deploy_server_startup_s"]}


def check_bench(card: str) -> dict:
    from esrecsys_tpu_torch.tools import serving_bench as sb

    full_scan = [m for m in BENCH_FLOORS if m not in SUBLINEAR_MODES]
    res = sb.main(["--items", "2262292", "--dim", "64", "--k", "500",
                   "--batch", "256", "--reps", str(BENCH_REPS),
                   "--queries", str(BENCH_QUERIES),
                   "--modes", ",".join(full_scan), "--out", ""])
    for r in res["results"]:
        floor = BENCH_FLOORS[r["mode"]]
        if floor is not None and not r["overlap_vs_exact"] >= floor:
            raise AssertionError(f"serving_bench {r} under {floor}")
    log("serving_bench --items 2262292 --dim 64 --k 500 --batch 256 --reps "
        f"{BENCH_REPS} --queries {BENCH_QUERIES} (cut from 2048): "
        + ", ".join(
            f"{r['mode']} {r['queries_per_s']} q/s overlap "
            f"{r['overlap_vs_exact']} {r['resident_bytes_per_item']} B/item "
            f"setup {r['setup_s']} s" for r in res["results"])
        + f" [{card}]")
    return res


def phase_modes(card: str, ctx: dict, work: str) -> dict:
    """The full-scan serving modes and the catalog lifecycle on the
    trained catalog: approx and int8+approx, growth, a reload under
    traffic, the deploy cycles and serving_bench."""
    import gc

    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.retrieval.mips import (OVERSAMPLE,
                                                   approx_reduction_size)
    from esrecsys_tpu_torch.serving.server import RetrievalService

    index, exact, queries = ctx["index"], ctx["exact"], ctx["queries"]
    counters = {"fused_scan": fs.LAUNCHES, "fused_scan_int8":
                fs.LAUNCHES_INT8, "gather_pool": gp.LAUNCHES,
                "scatter_add": sa.LAUNCHES}
    for c in counters.values():
        c.reset()
    t_phase = time.perf_counter()
    out = {"approx": {}}
    # ---- 1. approx and int8+approx at B=8, k=500
    M = len(index)
    nblk = -(-M // 262_144)
    for mode, kw, kb in (
            ("approx", {"approx": True}, max(-(-500 // nblk), 256)),
            ("int8+approx", {"approx": True, "quantized": True},
             -(-OVERSAMPLE * 500 // nblk))):
        t0 = time.perf_counter()
        svc = RetrievalService(index, max_k=500, max_batch=8, device="cuda",
                               **kw)
        build_s = time.perf_counter() - t0
        ids, scores = svc.topk(queries, k=500)
        if (svc.mode != mode or scores.shape != (len(queries), 500)
                or not np.isfinite(scores).all()):
            raise AssertionError(f"{mode}: {svc.mode}, {scores.shape}")
        overlap = overlap_at_k(exact._items, queries, ids, ctx["exact_ids"])
        q8 = queries[:8]
        ms = host_ms(lambda: svc.topk(q8, k=500), SERVE_TIMED)
        wall, busy, top = device_breakdown(lambda: svc.topk(q8, k=500),
                                           SERVE_TIMED)
        L, r = approx_reduction_size(262_144, kb, 0.95)
        row = {"overlap": overlap, "topk_ms": ms, "L": L, "r": r, "kb": kb,
               "build_s": build_s, "profiled_ms": wall, "busy_ms": busy,
               "idle_share": None if busy is None else 1 - busy / wall,
               "bytes_per_item": svc.resident_bytes_per_item}
        split = ("device time not measured (no device rows in the trace)"
                 if busy is None else
                 f"device busy {busy:.3f} ms (idle share "
                 f"{1 - busy / wall:.2f}); largest: " + ", ".join(
                     f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:4]))
        log(f"serve {mode}: L {L}, r {r} (bins of {1 << r}), kb {kb} of "
            f"{nblk} blocks; built in {build_s:.2f} s; overlap@500 vs exact "
            f"{overlap:.4f} over {len(queries)} queries (floor "
            f"{APPROX_FLOOR}); {svc.resident_bytes_per_item} resident bytes "
            f"per item; B=8 k=500 topk {ms:.3f} ms (median of "
            f"{SERVE_TIMED}, host clock); breakdown {wall:.3f} ms per call "
            f"under the profiler, "
            f"{split} [{card}]")
        if overlap < APPROX_FLOOR:
            raise AssertionError(f"{mode} overlap@500 {overlap}")
        out["approx"][mode] = row
        del svc
    parts = {"approx": round(time.perf_counter() - t_phase, 1)}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        parts[name] = round(time.perf_counter() - t0, 1)

    part("select", check_approx_select, card, exact._items)
    # ---- 2. growth, 3. reload under traffic
    part("growth", check_growth, card, index, queries)
    part("reload", check_reload, card, index, queries, work)
    # ---- 4. the deploy cycles, 5. serving_bench
    part("deploy", check_deploy, card, work)
    part("bench", check_bench, card)
    out["bench"] = out["bench"]["results"]
    torch.cuda.synchronize()
    log(f"modes seconds per part: {parts}")
    out["launches"] = {n: c.count for n, c in counters.items()}
    out["seconds"] = time.perf_counter() - t_phase
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"modes phase launches: {out['launches']}")
    log(f"modes path launches: {out['launches']} (growth and reload: "
        f"fused_scan, fused_scan_int8; deploy cycles: gather_pool, "
        f"scatter_add; serving_bench: both fused scans) [{card}]")
    log(json.dumps({"modes": out}, default=float))
    return out


# ---- the sublinear phase: IVF and PQ serving on the trained catalog
FULL_PROBE_CLUSTERS = 64      # the exactness check's IVF cell count
SCORE_RTOL = 1e-5             # exactness checks: scores against exact


def sublinear_kwargs(mode: str, **extra) -> dict:
    """A mode's serving keywords at the reference's bench defaults."""
    from esrecsys_tpu_torch.tools import serving_bench as sb

    return {**sb.mode_kwargs(mode, object()), **extra}


def equal_up_to_ties(items, queries, got, want, what: str) -> int:
    """Scores within SCORE_RTOL relative of exact's; ids equal except where
    the two ids' float32 scores tie within the same bound. Returns the
    tied slots whose ids differ."""
    import numpy as np
    import torch

    g_ids, g_s = got
    w_ids, w_s = want
    if not np.allclose(g_s, w_s, rtol=SCORE_RTOL, atol=0):
        raise AssertionError(f"{what}: scores differ from exact by "
                             f"{np.abs(g_s - w_s).max()}")
    diff = g_ids != w_ids
    if diff.any():
        q = torch.from_numpy(queries).to(items.device)
        b, slot = np.nonzero(diff)
        gi = torch.from_numpy(g_ids[b, slot].astype("int64")).to(items.device)
        wi = torch.from_numpy(w_ids[b, slot].astype("int64")).to(items.device)
        qb = q[torch.from_numpy(b).to(items.device)]
        sg, sw = (items[gi] * qb).sum(-1), (items[wi] * qb).sum(-1)
        if bool(((sg - sw).abs() > SCORE_RTOL * sw.abs()).any()):
            raise AssertionError(f"{what}: {int(diff.sum())} ids differ "
                                 f"outside tied scores")
    return int(diff.sum())


def build_structures(card: str, exact, work: str) -> dict:
    """1. The IVF index and the PQ codebook of the trained catalog at the
    bench's defaults, built on the card and saved as npz."""
    import torch

    from esrecsys_tpu_torch.retrieval.ivf import IVFIndex
    from esrecsys_tpu_torch.retrieval.pq import PQCodebook
    from esrecsys_tpu_torch.tools.serving_bench import IVF_PQ_DEFAULTS as d

    rows = exact._items[:len(exact.index)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = IVFIndex.build(rows, d["ivf_clusters"], iters=d["ivf_iters"])
    ivf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pq = PQCodebook.build(rows, d["pq_subspaces"], n_codes=256, iters=15)
    pq_s = time.perf_counter() - t0
    paths = {"ivf": os.path.join(work, "ivf.npz"),
             "pq": os.path.join(work, "pq.npz")}
    ivf.save(paths["ivf"])
    pq.save(paths["pq"])
    counts = (ivf.bucket_ids >= 0).sum(1)
    log(f"sublinear build on the trained {ivf.n_items} x {rows.shape[1]} "
        f"catalog: IVF {ivf.n_clusters} cells, 10 Lloyd iterations, "
        f"{ivf_s:.2f} s (host clock, the host cell table included), "
        f"imbalance {ivf.imbalance:.2f}, Lmax {ivf.bucket_ids.shape[1]}, "
        f"cells empty {int((counts == 0).sum())}, median cell "
        f"{int(sorted(counts)[len(counts) // 2])}; PQ S=8 x 256 codes, 15 "
        f"iterations a subspace, {pq_s:.2f} s [{card}]")
    return {"ivf": ivf, "pq": pq, "paths": paths, "ivf_build_s": ivf_s,
            "pq_build_s": pq_s, "imbalance": ivf.imbalance,
            "lmax": int(ivf.bucket_ids.shape[1])}


def serve_sublinear_modes(card: str, ctx: dict, paths: dict) -> dict:
    """2. The six modes at B=8, k=500 from the saved structures: topk on
    the host clock, busy and idle device time, the largest device ops,
    overlap@500 against exact."""
    import numpy as np

    from esrecsys_tpu_torch.serving.server import RetrievalService

    index, exact, queries = ctx["index"], ctx["exact"], ctx["queries"]
    out = {}
    for mode in SUBLINEAR_MODES:
        kw = sublinear_kwargs(mode)
        if "ivf_clusters" in kw:
            kw["ivf_index_path"] = paths["ivf"]
        if "pq_subspaces" in kw:
            kw["pq_index_path"] = paths["pq"]
        t0 = time.perf_counter()
        svc = RetrievalService(index, max_k=500, max_batch=8, device="cuda",
                               **kw)
        load_s = time.perf_counter() - t0
        ids, scores = svc.topk(queries, k=500)
        filled = np.isfinite(scores).sum(1)
        # an IVF probe may hold fewer than k candidates: a -inf tail
        if scores.shape != (len(queries), 500) or not (
                np.isfinite(scores[:, 0]).all()
                and (scores[:, :-1] >= scores[:, 1:]).all()):
            raise AssertionError(f"{mode}: {scores.shape} or unsorted")
        overlap = overlap_at_k(exact._items, queries, ids, ctx["exact_ids"],
                               scores)
        q8 = queries[:8]
        ms = host_ms(lambda: svc.topk(q8, k=500), SERVE_TIMED)
        wall, busy, top = device_breakdown(lambda: svc.topk(q8, k=500),
                                           SERVE_TIMED)
        out[mode] = {"mode": svc.mode, "overlap": overlap, "topk_ms": ms,
                     "profiled_ms": wall, "busy_ms": busy,
                     "idle_share": None if busy is None else 1 - busy / wall,
                     "top_ops": top[:6], "load_s": load_s,
                     "min_filled": int(filled.min()),
                     "bytes_per_item": svc.resident_bytes_per_item}
        split = ("device time not measured (no device rows in the trace)"
                 if busy is None else
                 f"device busy {busy:.3f} ms (idle share "
                 f"{1 - busy / wall:.2f}); largest: " + ", ".join(
                     f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:5]))
        log(f"serve {svc.mode} (trained catalog, structures loaded in "
            f"{load_s:.2f} s): overlap@500 vs exact {overlap:.4f} over "
            f"{len(queries)} queries (at least {int(filled.min())} of 500 "
            f"slots filled); {svc.resident_bytes_per_item} "
            f"resident bytes per item; B=8 k=500 topk {ms:.3f} ms (median "
            f"of {SERVE_TIMED}, host clock); breakdown {wall:.3f} ms per "
            f"call under the profiler, {split} [{card}]")
        del svc
    return out


def check_full_width_exactness(card: str, ctx: dict) -> dict:
    """3. An IVF service probing all of its 64 cells, and a pq service
    whose candidates are every row of every block, against exact."""
    import torch

    from esrecsys_tpu_torch.serving.server import RetrievalService

    index, exact, queries = ctx["index"], ctx["exact"], ctx["queries"][:8]
    want = exact.topk(queries, k=500)
    nblk = -(-len(index) // 262_144)
    over = -(-262_144 * nblk // 500)   # kb = the whole block
    out = {}
    for name, kw in (
            ("ivf", dict(ivf_clusters=FULL_PROBE_CLUSTERS,
                         nprobe=FULL_PROBE_CLUSTERS, ivf_iters=10)),
            ("pq", dict(pq_subspaces=8, pq_oversample=over))):
        t0 = time.perf_counter()
        svc = RetrievalService(index, max_k=500, max_batch=8, device="cuda",
                               **kw)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = svc.topk(queries, k=500)
        topk_s = time.perf_counter() - t0
        tied = equal_up_to_ties(exact._items, queries, got, want,
                                f"full-width {svc.mode}")
        out[name] = {"mode": svc.mode, "tied_slots_reordered": tied,
                     "build_s": build_s, "topk_s": topk_s}
        log(f"exactness {svc.mode}: 8 queries, k=500, equal to exact "
            f"(scores within {SCORE_RTOL} relative, ids equal but "
            f"{tied} slots reordered among tied scores); built in "
            f"{build_s:.2f} s, topk {topk_s:.3f} s [{card}]")
        del svc
        torch.cuda.empty_cache()
    return out


def check_prebuilt(card: str, ctx: dict, paths: dict, work: str) -> dict:
    """4. Time to first query of an ivf_pq service that builds its
    structures against one that loads them (no k-means: no scatter_add
    launch), and their answers equal on the same structures."""
    import torch

    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.serving.server import RetrievalService

    index, queries = ctx["index"], ctx["queries"]
    fresh = {"ivf": os.path.join(work, "ivf_fresh"),
             "pq": os.path.join(work, "pq_fresh")}
    kw = sublinear_kwargs("ivf_pq")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = RetrievalService(index, max_k=500, max_batch=8, device="cuda",
                             ivf_index_path=fresh["ivf"],
                             pq_index_path=fresh["pq"], **kw)
    build_s = time.perf_counter() - t0
    want = built.topk(queries, k=500)
    del built
    before = sa.LAUNCHES.count
    t0 = time.perf_counter()
    loaded = RetrievalService(index, max_k=500, max_batch=8, device="cuda",
                              ivf_index_path=fresh["ivf"],
                              pq_index_path=fresh["pq"], **kw)
    load_s = time.perf_counter() - t0
    ran = sa.LAUNCHES.count - before
    got = loaded.topk(queries, k=500)
    del loaded
    if ran or answers_differ(got[0], got[1], want[0], want[1]):
        raise AssertionError(f"prebuilt: {ran} scatter_add launches, or "
                             f"answers that differ from the build's")
    for p in fresh.values():
        if not os.path.exists(p + ".npz"):
            raise AssertionError(f"prebuilt: {p}.npz was not written")
    log(f"prebuilt caches (ivf_pq, 4096 cells, S=8): time to first query "
        f"{build_s:.2f} s building both structures, {load_s:.2f} s loading "
        f"them from npz (no k-means: 0 scatter_add launches); "
        f"{len(queries)} answers equal [{card}]")
    return {"build_ttfq_s": build_s, "load_ttfq_s": load_s}


def check_sublinear_reload(card: str, ctx: dict, paths: dict,
                           work: str) -> dict:
    """5. A live ivf_pq server reloaded under traffic to the perturbed
    catalog, aux "rebuild" then "reuse"; no request may fail, and the
    answers after reuse equal a service on the saved structures."""
    import shutil

    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving.server import RetrievalService, serve

    index, queries = ctx["index"], ctx["queries"]
    live = {n: os.path.join(work, f"live_{n}.npz") for n in paths}
    for n, p in paths.items():
        shutil.copy(p, live[n])
    new_path = os.path.join(work, "perturbed.npz")   # the modes phase's
    kw = sublinear_kwargs("ivf_pq", ivf_index_path=live["ivf"],
                          pq_index_path=live["pq"])
    httpd = serve(index, port=0, max_k=500, max_batch=8, device="cuda", **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    start, halt, errors, sent = live_traffic(url, queries)
    reps = {}
    try:
        start()
        time.sleep(0.5)
        for aux in ("rebuild", "reuse"):
            old_cent = httpd.service.pq.centroids
            t0 = time.perf_counter()
            reps[aux] = http_json(f"{url}/admin/reload",
                                  {"index": new_path, "aux": aux})
            reps[aux]["client_s"] = time.perf_counter() - t0
            same = (httpd.service.pq.centroids == old_cent).all()
            if reps[aux].get("status") != "ok" or same != (aux == "reuse"):
                raise AssertionError(f"reload {aux}: {reps[aux]}")
        time.sleep(1.0)
        halt()
        live_ans = httpd.service.topk(queries, k=500)
        stats = http_json(f"{url}/statsz")
    finally:
        halt()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    fresh = RetrievalService(EmbeddingIndex.load(new_path), max_k=500,
                             max_batch=8, device="cuda", **kw)
    want = fresh.topk(queries, k=500)
    del fresh
    if errors:
        raise AssertionError(f"reload: {len(errors)} failed requests, "
                             f"first {errors[0]}")
    if stats["reloads"] != 2 or answers_differ(live_ans[0], live_ans[1],
                                               want[0], want[1]):
        raise AssertionError("reload: the live answers differ from a "
                             "service on the saved structures")
    log(f"hot reload of a live ivf_pq server to the perturbed catalog: aux "
        f"rebuild {reps['rebuild']['reload_seconds']:.3f} s, aux reuse "
        f"{reps['reuse']['reload_seconds']:.3f} s (server); {sent[0]} "
        f"requests from 2 client threads during and 1 s after, 0 failed; "
        f"the answers equal a service loading the rewritten npz [{card}]")
    return {"rebuild_s": reps["rebuild"]["reload_seconds"],
            "reuse_s": reps["reuse"]["reload_seconds"],
            "requests": sent[0], "failed": len(errors)}


def check_pq_growth(card: str, ctx: dict, paths: dict, work: str) -> dict:
    """6. A pq service with add_capacity 65,536 takes 8 adds of 1,024 rows
    in place; its answers equal a service over the grown catalog with the
    same codebook and codes, and each add's codes equal the codebook's
    encoding of its rows."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving.server import RetrievalService

    index, queries = ctx["index"], ctx["queries"]
    rng = np.random.default_rng(13)
    vecs = index.vectors
    adds = [growth_rows(vecs, rng, GROWTH_ROWS) for _ in range(GROWTH_ADDS)]
    new_ids = [[f"pqadd{a}-{i}" for i in range(GROWTH_ROWS)]
               for a in range(GROWTH_ADDS)]
    kw = sublinear_kwargs("pq", pq_index_path=paths["pq"])
    svc = RetrievalService(EmbeddingIndex(list(index.ids), vecs), max_k=500,
                           max_batch=8, add_capacity=GROWTH_CAPACITY,
                           device="cuda", **kw)
    book = svc.pq
    ptrs = {n: getattr(svc, n).data_ptr() for n in ("_items", "_pq_codes")}
    times = []
    for a in range(GROWTH_ADDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.add_items(new_ids[a], adds[a])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q = np.concatenate([adds[a][:4] for a in range(GROWTH_ADDS)]
                       + [queries[:32]])
    got = svc.topk(q, k=500)
    moved = [n for n, p in ptrs.items() if getattr(svc, n).data_ptr() != p]
    n0 = len(vecs)
    for a in range(GROWTH_ADDS):
        rows = svc.pq.codes[n0 + a * GROWTH_ROWS: n0 + (a + 1) * GROWTH_ROWS]
        enc = book.encode(adds[a], device="cuda").codes
        if not np.array_equal(rows, enc):
            raise AssertionError(f"pq growth: add {a}'s codes differ from "
                                 f"the codebook's encoding")
    grown_path = os.path.join(work, "pq_grown.npz")
    svc.pq.save(grown_path)
    grown = EmbeddingIndex(list(svc.index.ids), svc.index.vectors.copy())
    del svc
    fresh = RetrievalService(grown, max_k=500, max_batch=8, device="cuda",
                             **sublinear_kwargs("pq",
                                                pq_index_path=grown_path))
    want = fresh.topk(q, k=500)
    del fresh
    if moved or answers_differ(got[0], got[1], want[0], want[1]):
        raise AssertionError(f"pq growth: reallocated {moved}, or answers "
                             f"that differ from the grown catalog's")
    times.sort()
    log(f"growth pq:S=8: {GROWTH_ADDS} adds of {GROWTH_ROWS} rows into "
        f"add_capacity {GROWTH_CAPACITY} (each encoded against the live "
        f"codebook), {times[len(times) // 2]:.2f} ms per add (median, host "
        f"clock, min {times[0]:.2f}, max {times[-1]:.2f}); {len(q)} queries "
        f"equal a service over the grown {n0 + GROWTH_ADDS * GROWTH_ROWS} "
        f"items with the same codebook and codes; buffers {sorted(ptrs)} "
        f"not reallocated [{card}]")
    return {"ms_per_add_median": times[len(times) // 2], "ms_per_add": times}


def check_sublinear_bench(card: str) -> dict:
    """7. serving_bench on its --structured catalog: the six modes, then
    ivf and ivf+int8 with --ivf_max_cell 1024 (the cap's cell table; the
    PQ modes on it were cut for the script's time), against their
    floors."""
    from esrecsys_tpu_torch.tools import serving_bench as sb

    out = {}
    for name, extra, modes in (
            ("untuned", [], SUBLINEAR_MODES),
            ("max_cell_1024", ["--ivf_max_cell", "1024"],
             ("ivf", "ivf_quantized"))):
        res = sb.main(["--items", "2262292", "--dim", "64", "--k", "500",
                       "--batch", "256", "--reps", str(BENCH_REPS),
                       "--structured",
                       "--queries", str(BENCH_QUERIES),
                       "--modes", ",".join(("exact",) + tuple(modes)),
                       "--out", ""] + extra)
        for r in res["results"]:
            floor = BENCH_FLOORS[r["mode"]]
            if floor is not None and not r["overlap_vs_exact"] >= floor:
                raise AssertionError(f"serving_bench {name} {r} under "
                                     f"{floor}")
        flags = " ".join(["--structured"] + extra)
        log(f"serving_bench {flags} --items 2262292 --dim 64 --k 500 "
            f"--batch 256 --reps {BENCH_REPS} --queries {BENCH_QUERIES}: "
            + ", ".join(
                f"{r['mode']} {r['queries_per_s']} q/s overlap "
                f"{r['overlap_vs_exact']} {r['resident_bytes_per_item']} "
                f"B/item setup {r['setup_s']} s"
                + (f" imbalance {r['ivf_imbalance']} Lmax {r['ivf_lmax']}"
                   if "ivf_lmax" in r else "")
                for r in res["results"]) + f" [{card}]")
        out[name] = res["results"]
    return out


def check_sublinear_deploy(card: str, work: str) -> dict:
    """8. DEPLOY_CYCLES deploy cycles of 10 steps into a live ivf_pq
    server that reuses its centroids and codebook at each reload."""
    from esrecsys_tpu_torch.tools import full_scale_run as fsr

    res = fsr.main(["--out_dir", os.path.join(work, "deploy_ivfpq"),
                    "--train", "--steps", "20",
                    "--deploy_cycles", str(DEPLOY_CYCLES),
                    "--cycle_steps", "10", "--deploy_serve_mode", "ivf_pq",
                    "--deploy_reload_aux", "reuse",
                    "--deploy_quality_queries", "64"])
    cycles = res["deploy_cycles"]
    if len(cycles) != DEPLOY_CYCLES or \
            not all(c["probe_hit"] for c in cycles):
        raise AssertionError(f"ivf_pq deploy cycles: {res}")
    for c in cycles:
        log(f"deploy cycle {c['cycle']} (ivf_pq server, aux reuse, 10 steps "
            f"of the flagship at full width): retrain {c['retrain_s']:.3f} "
            f"s, embed and save {c['embed_and_save_s']:.3f} s, reload "
            f"{c['reload_s']:.3f} s, artifact to live "
            f"{c['artifact_to_live_s']:.3f} s, overlap@100 "
            f"{c['overlap_at_k']:.4f} over 64 queries [{card}]")
    log(f"ivf_pq deploy server startup (both structures built): "
        f"{res['deploy_server_startup_s']:.3f} s [{card}]")
    return {"cycles": cycles,
            "server_startup_s": res["deploy_server_startup_s"]}


def check_sublinear_kernels(card: str, exact, structures: dict,
                            queries) -> dict:
    """9. scatter_add at the IVF centroid-sum pile-up (2,262,292 rows onto
    4,096 x 64, the vector instantiation) and at a PQ codebook's (onto
    256 x 8, the generic one), gather_pool at the IVF candidate shape
    (bit-equal), each against its plain version on the same inputs.
    Tolerance of a pile-up: float32 sums of n rows in two orders part by
    about sqrt(n) ulps of the largest partial sum; the bound allows 8
    times that, from this run's counts and sums."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.retrieval.ivf import (_chunks,
                                                  _probe_candidates,
                                                  kmeans_assign)

    items = exact._items[:len(exact.index)]
    ivf, pq = structures["ivf"], structures["pq"]
    out = {}
    cent = torch.from_numpy(ivf.centroids).to("cuda")
    cases = (
        ("ivf", kmeans_assign(items, cent), items, ivf.n_clusters),
        ("pq", torch.from_numpy(pq.codes[:, 0].astype(np.int64)).cuda(),
         items[:, :8].contiguous(), pq.n_codes))
    for name, ids, upd, rows in cases:
        ids32 = ids.to(torch.int32)
        table = torch.zeros((rows, upd.shape[1]), device="cuda")
        k = sa.scatter_add_cuda(table.clone(), ids32, upd)
        p = sa.scatter_add_plain(table.clone(), ids32, upd)
        torch.cuda.synchronize()
        counts = torch.bincount(ids, minlength=rows)
        abs_sum = sa.scatter_add_plain(table.clone(), ids32, upd.abs())
        bound = float(8 * counts.max().float().sqrt()
                      * torch.finfo(torch.float32).eps * abs_sum.max())
        err = float((k - p).abs().max())
        if err > bound:
            raise AssertionError(f"scatter_add {name} pile-up: err {err} "
                                 f"over {bound}")
        plan = sa.launch_plan(len(ids32), upd.shape[1], table.data_ptr(),
                              upd.data_ptr())[0]
        k_ms = cuda_ms(lambda: sa.scatter_add_cuda(table, ids32, upd), 10)
        p_ms = cuda_ms(lambda: sa.scatter_add_plain(table, ids32, upd), 10)
        out[f"scatter_add_{name}"] = {"max_abs_err": err, "bound": bound,
                                      "ms": k_ms, "plain_ms": p_ms}
        log(f"kernel scatter_add at the {name} centroid sums: "
            f"{len(ids32)} rows onto {rows} x {upd.shape[1]} (instantiation "
            f"{plan}, 0: generic; {int(counts.max())} on the fullest row, "
            f"{int(counts.min())} on the emptiest): max_abs_err {err:.3g} "
            f"(bound {bound:.3g}), {k_ms:.3f} ms against the plain "
            f"version's {p_ms:.3f} (CUDA events) [{card}]")
    # the queries of the first chunk ivf_topk cuts from a batch of 8
    width = 64 * ivf.bucket_ids.shape[1]
    q = torch.from_numpy(queries[:8][_chunks(8, width, 64)[0]]).cuda()
    _, _, safe = _probe_candidates(
        q, cent, torch.from_numpy(ivf.bucket_ids).cuda(), 64)
    ids = safe.reshape(-1, 1).to(torch.int32).contiguous()
    k = gp.gather_pool_cuda(items, ids, False, -1)
    p = gp.gather_pool_plain(items, ids, False, -1)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError("gather_pool at the IVF candidate shape differs")
    k_ms = cuda_ms(lambda: gp.gather_pool_cuda(items, ids, False, -1), 10)
    p_ms = cuda_ms(lambda: gp.gather_pool_plain(items, ids, False, -1), 10)
    out["gather_pool_ivf"] = {"rows": int(ids.shape[0]), "ms": k_ms,
                              "plain_ms": p_ms, "max_abs_err": 0.0}
    log(f"kernel gather_pool at the IVF candidate shape ({len(q)} queries "
        f"x nprobe 64 x Lmax {ivf.bucket_ids.shape[1]} = {ids.shape[0]} rows "
        f"of 64 floats): bit-equal to the plain version, {k_ms:.3f} ms "
        f"against {p_ms:.3f} (CUDA events, {ids.shape[0] * 512 / 1e6:.0f} "
        f"MB read and written) [{card}]")
    return out


def phase_sublinear(card: str, ctx: dict, work: str) -> dict:
    """IVF and PQ retrieval on the trained catalog: builds, the six modes,
    exactness at full width, prebuilt caches, a reload under traffic, pq
    growth, serving_bench on its structured catalog, the deploy cycles,
    then the two kernels at the phase's shapes."""
    import gc

    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    counters = {"gather_pool": gp.LAUNCHES, "scatter_add": sa.LAUNCHES}
    for c in counters.values():
        c.reset()
    t_phase = time.perf_counter()
    out = {}
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        parts[name] = round(time.perf_counter() - t0, 1)

    part("build", build_structures, card, ctx["exact"], work)
    st = out.pop("build")
    out["build"] = {k: st[k] for k in ("ivf_build_s", "pq_build_s",
                                       "imbalance", "lmax")}
    part("serve", serve_sublinear_modes, card, ctx, st["paths"])
    part("exactness", check_full_width_exactness, card, ctx)
    part("prebuilt", check_prebuilt, card, ctx, st["paths"], work)
    part("reload", check_sublinear_reload, card, ctx, st["paths"], work)
    part("growth", check_pq_growth, card, ctx, st["paths"], work)
    part("bench", check_sublinear_bench, card)
    part("deploy", check_sublinear_deploy, card, work)
    torch.cuda.synchronize()
    log(f"sublinear seconds per part: {parts}")
    out["launches"] = {n: c.count for n, c in counters.items()}
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"sublinear phase launches: {out['launches']}")
    log(f"sublinear path launches: {out['launches']} (IVF and PQ builds: "
        f"scatter_add; ivf and ivf+int8 rescores: gather_pool; deploy "
        f"cycles: both) [{card}]")
    out["kernels"] = check_sublinear_kernels(card, ctx["exact"], st,
                                             ctx["queries"])
    out["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"sublinear": out}, default=float))
    return out


def phase_tool(card: str) -> dict:
    """The port's scatter_attempt tool, then smem_scatter timed at the
    album table with the tool's inputs and with every id on one row."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import smem_scatter as ss
    from esrecsys_tpu_torch.tools import scatter_attempt as sat

    ss.LAUNCHES.reset()
    # ---- the main path: the tool, a few iterations
    res = sat.main(["--iters", "5"])
    torch.cuda.synchronize()
    launches = ss.LAUNCHES.count
    if launches <= 0:
        raise AssertionError("scatter_attempt never launched smem_scatter")
    for rows in sat.ROWS:
        r = res[f"R{rows}"]
        for name in ("smem_scatter", "scatter_add"):
            if not r[f"{name}_max_abs_diff"] <= TOL:
                raise AssertionError(f"scatter_attempt R={rows}: {name} "
                                     f"differs from index_add_ by "
                                     f"{r[name + '_max_abs_diff']}")
        log(f"tool scatter_attempt R={rows} x {sat.DIM}, {sat.N_IDS} ids: "
            f"smem_scatter {r['smem_scatter_ms'] * 1e3:.1f} us, scatter_add "
            f"{r['scatter_add_ms'] * 1e3:.1f} us, index_add_ "
            f"{r['index_add_ms'] * 1e3:.1f} us (mean of 5, CUDA events, "
            f"table warm in L2) [{card}]")
    # ---- smem_scatter at the album table, L2 flushed before each call
    rng = np.random.default_rng(0)
    R, D, n = sat.ROWS[0], sat.DIM, sat.N_IDS
    table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32)
                             ).cuda()
    ids = torch.from_numpy(rng.integers(0, R, n).astype(np.int32)).cuda()
    upd = torch.from_numpy((rng.normal(size=(n, D)) * 1e-4)
                           .astype(np.float32)).cuda()
    tk, tp, tl = table.clone(), table.clone(), table.clone()
    split = cold_rows(lambda: ss.smem_scatter_cuda(tk, ids, upd))
    ms = sum(split.values())
    plain_ms = cold_ms(lambda: ss.smem_scatter_plain(tp, ids, upd))
    lib_ms = cold_ms(lambda: tl.index_add_(0, ids, upd))
    # every id on one row: one CTA takes all the work
    same = torch.full((n,), 7, dtype=torch.int32, device="cuda")
    pile = cold_rows(lambda: ss.smem_scatter_cuda(tk, same, upd))
    pile_ms = sum(pile.values())
    # the function, in place, moves only the rows its ids touch, as
    # scatter_add's bound counts them
    distinct = rows_bytes(ids, D)
    moved = 2 * distinct + n * D * 4 + n * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"kernel smem_scatter at the album table ({R} x {D}, {n} ids, "
        f"{distinct // (D * 4)} distinct), device time per call (both "
        f"launches) with the L2 cache flushed before it (profiler, 20 "
        f"calls): {ms * 1e3:.1f} us (previous design "
        f"{SMEM_SCATTER_PREVIOUS_MS * 1e3:.1f}, not re-run; plain "
        f"{plain_ms * 1e3:.1f}, index_add_ {lib_ms * 1e3:.1f}, "
        f"{ms / lib_ms:.2f} of it; bound {bound_ms * 1e3:.1f} by bytes, "
        f"{moved / 1e6:.1f} MB: the touched rows read and written, updates "
        f"and ids read), per launch {launch_split(split)}; all {n} ids on "
        f"one row: {pile_ms * 1e3:.1f} us, per launch {launch_split(pile)} "
        f"[{card}]")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


def bit_equal_states(a, b) -> list:
    """Names of the tensors (params, optimizer state) where two sparse
    train states differ in any bit, plus ``step`` if their steps do."""
    import torch

    bad = [] if a.step == b.step else ["step"]
    for name, t in a.params.state_dict().items():
        if not torch.equal(t, b.params.state_dict()[name]):
            bad.append(name)
    for table, d in a.opt_state.items():
        if set(d) != set(b.opt_state[table]):
            bad.append(f"{table} keys")
            continue
        bad += [f"{table}/{k}" for k, v in d.items()
                if not torch.equal(v, b.opt_state[table][k])]
    return bad


def carrier_cost(card: str, work: str, buckets: int) -> dict:
    """The dense-carrier step against the lazy one at ``buckets`` album
    buckets (the flagship otherwise, bf16 scoring as users run it), in
    turns dense, lazy, lazy, dense on one batch: ms per step on the host
    clock over CARRIER_STEPS steps ending in a sync, and the device's busy
    share of a step from torch.profiler."""
    import torch

    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.workloads import playlist as pl

    dev = torch.device("cuda")
    out = {"dense": [], "lazy": []}
    for carrier in ("dense", "lazy", "lazy", "dense"):
        run = fsr.TrainRunConfig(out_dir=work, batch_size=2048, max_next=32,
                                 album_buckets=buckets, device="cuda",
                                 momentum_carrier=carrier)
        cfg = fsr.flagship_cfg(run)
        if pl.use_lazy_momentum(cfg) != (carrier == "lazy"):
            raise AssertionError(f"{carrier} carrier did not resolve")
        corpus = {k: torch.from_numpy(v).to(dev)
                  for k, v in fsr.synth_corpus(run).items()}
        model, state = pl.init_state(cfg, dev)
        step = pl.make_sparse_train_step(model, cfg, corpus, seed=0)
        batch = next(fsr.device_feed(run, cfg, dev))
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CARRIER_STEPS):
            _, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / CARRIER_STEPS
        if not torch.isfinite(m["loss"]):
            raise AssertionError(f"{carrier} carrier: loss {m['loss']}")
        wall, busy, top = device_breakdown(
            lambda: (step(state, batch), torch.cuda.synchronize()), 5)
        out[carrier].append((ms, wall, busy, top))
        del model, state, step, corpus
        torch.cuda.empty_cache()
    for carrier, rows in out.items():
        ms = [r[0] for r in rows]
        busy = [r[2] for r in rows]
        busy_txt = ("device time not measured" if None in busy else
                    "device busy " + " / ".join(f"{b:.3f}" for b in busy)
                    + " ms (idle share " + " / ".join(
                        f"{1 - b / r[1]:.2f}" for b, r in zip(busy, rows))
                    + ")")
        top = rows[0][3]
        ops = ", ".join(f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:3])
        log(f"carrier cost, {buckets} album buckets (album table "
            f"{buckets * 32 * 4 / 1e9:.3f} GB), {carrier} carrier: "
            + " / ".join(f"{x:.3f}" for x in ms)
            + f" ms per step ({2048 / (min(ms) / 1e3):.0f} examples/s at "
            f"the faster; host clock, {CARRIER_STEPS} steps, one sync); "
            f"under the profiler {busy_txt}; largest: {ops} [{card}]")
    return {c: [r[0] for r in rows] for c, rows in out.items()}


def check_big_table(card: str, rows: int, dim: int, n: int,
                    dtype: str = "float32") -> float:
    """gather_pool and scatter_add against their plain versions on a
    (rows, dim) table of ``dtype``, with ids above 2^26 so that row offsets
    pass 2^31 elements; only the touched rows are compared (and their
    untouched neighbours), so nothing table-sized is copied. float32 rows
    agree within TOL; bf16 rows hit once are bit-equal and rows hit more
    within ``bf16_scatter_bound``. Returns the largest difference."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.tools import scale_table as st

    dev = torch.device("cuda")
    cfg = st.ScaleConfig(rows=rows, dim=dim, ids_per_step=n, device="cuda",
                         dtype=dtype)
    table, _ = st.init(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, rows, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    # rows at both sides of offset 2^31 and at the table's end, repeated
    high = torch.tensor([rows - 1, rows - 1, (1 << 31) // dim - 1,
                         (1 << 31) // dim, (1 << 31) // dim + 1, rows - 2,
                         rows - 1],
                        dtype=torch.int32, device=dev)
    ids[:high.numel()] = high
    if int(ids.max()) * dim < 1 << 31:
        raise AssertionError("no row offset past 2^31 elements")
    ids2 = ids[:, None].contiguous()
    k = gp.gather_pool_cuda(table, ids2, False, -1)
    p = gp.gather_pool_plain(table, ids2, False, -1)
    if not torch.equal(k, p):
        raise AssertionError(f"gather_pool differs on the {rows}-row table: "
                             f"{float((k - p).abs().max())}")
    uniq, inv = torch.unique(ids, return_inverse=True)
    nb = (uniq + 1).clamp(max=rows - 1)
    nb = nb[~torch.isin(nb, uniq)].long()
    before, nb_before = table[uniq.long()], table[nb]
    upd = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
    sa.scatter_add_cuda(table, ids, upd)
    inv = inv.to(torch.int32)
    want = sa.scatter_add_plain(before.clone(), inv, upd)
    got = table[uniq.long()]
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if table.dtype == torch.bfloat16:
        check_bf16_scatter(got, want, before, inv, upd, "big table")
    else:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    if not torch.equal(table[nb], nb_before):
        raise AssertionError("scatter_add wrote an untouched row")
    log(f"kernel gather_pool and scatter_add on a {rows} x {dim} {dtype} "
        f"table ({rows * dim / 2 ** 31:.2f} x 2^31 elements), {n} ids up to "
        f"{int(ids.max())} (offsets to {int(ids.max()) * dim} elements): "
        f"gather equal, scatter max_abs_err {err:.3g} over "
        f"{uniq.numel()} touched rows, {nb.numel()} untouched neighbours "
        f"bit-equal [{card}]")
    return err


def phase_lazy(card: str, dense: dict) -> dict:
    """The lazy momentum carrier at full width: lazy plus flush against
    the dense carrier (float32), the flagship under the lazy carrier
    through train, a fused eval round and export, its checkpoints and both
    adaptations, scale_table at 100M rows, the carrier's cost, and the
    flagship bench tool."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_affinity as fa
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.tools import flagship_quality_bench as fqb
    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.tools import scale_table as st
    from esrecsys_tpu_torch.train import Checkpointer
    from esrecsys_tpu_torch.train.export import load_model
    from esrecsys_tpu_torch.workloads import playlist as pl

    dev = torch.device("cuda")
    kernels = {"gather_pool": gp, "scatter_add": sa, "fused_affinity": fa}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        run = fsr.TrainRunConfig(
            out_dir=work, steps=STEPS, batch_size=2048, max_next=32,
            eval_every=STEPS, eval_playlists=2048, eval_fused_bins=4096,
            log_every=10, fused=True, device="cuda",
            momentum_carrier="lazy")
        corpus = {k: torch.from_numpy(v).to(dev)
                  for k, v in fsr.synth_corpus(run).items()}

        # ---- 1. lazy plus flush against the dense carrier, float32
        cfg_l = dataclasses.replace(fsr.flagship_cfg(run),
                                    compute_dtype="float32")
        cfg_d = dataclasses.replace(cfg_l, momentum_carrier="dense")
        feed = fsr.device_feed(run, cfg_l, dev)
        batches = [next(feed) for _ in range(STEPS)]
        neg_gen = torch.Generator(device=dev).manual_seed(6)
        negs = [torch.randint(0, run.num_tracks, (512,), generator=neg_gen,
                              device=dev, dtype=torch.int32)
                for _ in range(STEPS)]
        runs = {}
        for name, cfg in (("lazy", cfg_l), ("dense", cfg_d)):
            model, state = pl.init_state(cfg, dev)
            step = pl.make_sparse_train_step(model, cfg, corpus, seed=0)
            losses = [float(step(state, b, neg_ids=n)[1]["loss"])
                      for b, n in zip(batches, negs)]
            runs[name] = (state, losses)
        (sl, ll), (sd, ld) = runs["lazy"], runs["dense"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ll, ld))
        settled = pl.settled_params(sl, cfg_l)
        worst = {}
        for t in ("album", "artist"):
            a = getattr(settled, f"{t}_embed").embedding
            b = getattr(sd.params, f"{t}_embed").embedding.detach()
            worst[f"{t} table"] = float((a - b).abs().max())
        pl.settle_momentum_state(sl, cfg_l)
        for t in ("album", "artist"):
            if not torch.equal(getattr(sl.params, f"{t}_embed").embedding,
                               getattr(settled, f"{t}_embed").embedding):
                raise AssertionError(f"settle and flush differ ({t})")
            worst[f"{t} momentum"] = float(
                (sl.opt_state[t]["momentum"]
                 - sd.opt_state[t]["momentum"]).abs().max())
        log(f"lazy against dense carrier, {STEPS} float32 steps of the "
            f"flagship from one init, same batches and negatives: loss max "
            f"relative diff {loss_rel:.3g} (bound {LAZY_LOSS_RTOL}); "
            "settled max abs diff "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (bounds: tables {LAZY_TABLE_ATOL}, momentum "
            f"{LAZY_MOMENTUM_ATOL}) [{card}]")
        if loss_rel > LAZY_LOSS_RTOL or any(
                v > (LAZY_TABLE_ATOL if "table" in k else LAZY_MOMENTUM_ATOL)
                for k, v in worst.items()):
            raise AssertionError(f"lazy plus flush is off the dense "
                                 f"trajectory: loss {loss_rel}, {worst}")
        del runs, sl, sd, settled, batches, negs, feed

        # ---- 2. the main path under the lazy carrier, bf16 scoring:
        # 20 steps, one fused eval round, export
        for mod in kernels.values():
            mod.LAUNCHES.reset()
        t0 = time.perf_counter()
        tr = fsr.run_train(run)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = {name: mod.LAUNCHES.count for name, mod in kernels.items()}
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the lazy path never launched {name}")
        res, cfg = tr["result"], tr["cfg"]
        state = res.state
        ev = res.last_eval_metrics
        loss = res.last_train_metrics.get("train_loss", float("nan"))
        if not pl.use_lazy_momentum(cfg) or res.steps_run != STEPS \
                or not np.isfinite(loss) or not ev \
                or not all(np.isfinite(v) for v in ev.values()):
            raise AssertionError(f"lazy training: {res.steps_run} steps, "
                                 f"loss {loss}, eval {ev}")
        report = fsr.train_report(run, tr)
        log(f"lazy path: {STEPS} steps of the flagship (bf16, momentum 0.98, "
            f"lazy carrier) + one fused eval round + export in {path_s:.1f} "
            f"s; launches {launches}; loss of steps 11-20 {loss:.5f}; "
            f"{res.last_train_metrics['examples_per_sec']:.0f} examples/s "
            f"over steps 11-20 ({res.last_train_metrics['ms_per_step']:.3f} "
            f"ms/step, host clock), steady "
            f"{report['steady_examples_per_s']:.0f}; eval round "
            f"{res.eval_round_s[0] * 1e3:.1f} ms; recall@500 track "
            f"{ev['eval_track_recall']:.5f} (dense carrier, train phase: "
            f"{dense['eval_track_recall']:.5f}) artist "
            f"{ev['eval_artist_recall']:.5f} [{card}]")
        out["launches"] = launches

        # fused against exact eval on the same 2,048 playlists
        model = state.params
        batch = pl.to_device(fsr.host_batch(np.random.default_rng(999),
                                            2048, 5, 32, run), dev)
        aux = pl.make_corpus_embed_setup(model, cfg, corpus)(state)
        fused_topk = pl.make_eval_topk(model, cfg, corpus)
        exact_topk = pl.make_eval_topk(
            model, dataclasses.replace(cfg, eval_fused_bins=0), corpus)
        fused_ms = host_ms(lambda: (fused_topk(state, batch, aux),
                                    torch.cuda.synchronize()), 3)
        fv, fi = fused_topk(state, batch, aux)
        xv, xi = exact_topk(state, batch, aux[0])
        settled = pl.settled_params(state, cfg)
        overlap = affinity_overlap(settled, batch, aux[0], corpus, fi, xi)
        fm = pl._hit_metrics(batch, fv, fi, corpus["tracks"],
                             corpus["artists"], 500)
        xm = pl._hit_metrics(batch, xv, xi, corpus["tracks"],
                             corpus["artists"], 500)
        log(f"lazy eval quality: fused overlap@500 vs exact {overlap:.5f} "
            f"over 2048 playlists (floor {QUALITY_FLOOR}); recall@500 track "
            f"fused {float(fm['track_recall']):.5f} exact "
            f"{float(xm['track_recall']):.5f}; fused top-500 of 2048 "
            f"playlists {fused_ms:.1f} ms (host clock, corpus embed "
            f"excluded) [{card}]")
        if overlap < QUALITY_FLOOR:
            raise AssertionError(f"lazy eval overlap@500 {overlap}")
        del aux, fv, fi, xv, xi

        # the exported artifact is the settled model
        params, _, meta = load_model(tr["artifact"])
        for t in ("album", "artist"):
            if not np.array_equal(params[f"{t}_embed"]["embedding"],
                                  getattr(settled, f"{t}_embed")
                                  .embedding.cpu().numpy()):
                raise AssertionError(f"the artifact's {t} table is not the "
                                     "settled one")
        # checkpoint round trip, then both adaptations
        ck = Checkpointer(os.path.join(work, "lazy_ckpt"))
        t0 = time.perf_counter()
        ck.save(state.step, state)
        save_s = time.perf_counter() - t0
        _, fresh = pl.init_state(dataclasses.replace(cfg, seed=1), dev)
        bad = bit_equal_states(ck.restore(fresh), state)
        if bad:
            raise AssertionError(f"lazy checkpoint round trip differs: {bad}")
        cfg_dn = dataclasses.replace(cfg, momentum_carrier="dense")
        _, to_dense = pl.init_state(dataclasses.replace(cfg_dn, seed=2), dev)
        pl.restore_adapt_carrier(ck, to_dense, cfg_dn)
        pl.settle_momentum_state(fresh, cfg)
        bad = bit_equal_states(to_dense, dataclasses.replace(
            fresh, opt_state={t: {"momentum": d["momentum"]}
                              for t, d in fresh.opt_state.items()}))
        if bad:
            raise AssertionError(f"lazy to dense adaptation: {bad}")
        ck_d = Checkpointer(os.path.join(work, "dense_ckpt"))
        ck_d.save(to_dense.step, to_dense)
        _, to_lazy = pl.init_state(dataclasses.replace(cfg, seed=3), dev)
        pl.restore_adapt_carrier(ck_d, to_lazy, cfg)
        bad = bit_equal_states(to_lazy, dataclasses.replace(
            to_dense, opt_state={t: {**d, "last_step": torch.full_like(
                to_lazy.opt_state[t]["last_step"], to_dense.step)}
                for t, d in to_dense.opt_state.items()}))
        if bad:
            raise AssertionError(f"dense to lazy adaptation: {bad}")
        mb = os.path.getsize(ck.path(state.step)) / 1e6
        log(f"lazy checkpoint: {mb:.1f} MB saved in {save_s:.2f} s, restored "
            f"bit for bit (last_step included); adapted lazy to dense (every "
            f"row settled) and dense to lazy (last_step = {state.step}), "
            f"both bit-equal to their expectation; the exported artifact is "
            f"the settled model [{card}]")
        del tr, res, state, model, settled, fresh, to_dense, to_lazy, batch
        del corpus, params

        # ---- 3. the carrier's cost, at the flagship and at 10M buckets
        out["carrier"] = {b: carrier_cost(card, work, b)
                          for b in (run.album_buckets, BIG_BUCKETS)}

        # ---- 4. the flagship bench tool, a short run
        bench = fqb.main(["--spc", "8", "--n_calls", "2", "--out",
                          os.path.join(work, "bench.json")])
        log(f"flagship_quality_bench (--spc 8 --n_calls 2), examples/s: "
            + ", ".join(f"{k} {v:.0f}" for k, v in bench.items()
                        if isinstance(v, float)) + f" [{card}]")

    # ---- 5. scale_table at 100M rows, the earlier phases' tensors freed
    gc.collect()
    torch.cuda.empty_cache()
    out["big_err"] = check_big_table(card, SCALE_ROWS, 32, SCALE_IDS,
                                     "float32")
    gc.collect()
    torch.cuda.empty_cache()
    for mod in (gp, sa):
        mod.LAUNCHES.reset()
    scale = st.run(st.ScaleConfig(
        rows=SCALE_ROWS, dim=32, dtype="float32", ids_per_step=SCALE_IDS,
        momentum=0.98, calls=5, device="cuda"))
    scale_launches = {"gather_pool": gp.LAUNCHES.count,
                      "scatter_add": sa.LAUNCHES.count}
    if min(scale_launches.values()) <= 0 or not scale["value"] > 0 \
            or not np.isfinite(scale["last_loss"]):
        raise AssertionError(f"scale_table: {scale}, {scale_launches}")
    log(f"scale_table --rows {SCALE_ROWS} --dim 32 --ids_per_step "
        f"{SCALE_IDS} --momentum 0.98 (lazy carrier, float32: "
        f"{scale['table_gb']:.1f} GB table + as much momentum + last_step): "
        f"{scale['value']:.0f} rows/s, {scale['ms_per_step']:.3f} ms/step "
        f"over {scale['steps']} steps (host clock), peak device memory "
        f"{scale['peak_memory_gb']:.2f} GB; launches {scale_launches} "
        f"[{scale['card']}]")
    out["scale"] = scale
    return out


# ------------------------------------------------------------------ bf16

# bf16 scatter-adds: a row hit once is exactly round(t + round(u)) in both
# versions, so bit-equal; a row hit k times rounds at each of the kernel's
# reductions into it (at most k) and at each merged sum's rounding, in an
# order that changes from run to run, and the plain version sums in float32
# and rounds once. Both must lie within k (ulp(M) + M 2^-22) of the exact
# float64 sum, where M = |t| + sum |round(u)| bounds every partial sum.
LAZY_BF16_ROWS = 1_000_000    # the lazy bf16 check's table: 1M x 32
# ids of the bounded random pile-up: 64 of the kernel's reductions into one
# bf16 row, few enough that the bound below is a third of the sum
BF16_PILE_IDS = 2_048
SCALE_BF16_PEAK_GB = 14.0     # scale_table bf16 at 100M x 32, momentum 0.98


def bf16_ulp(x):
    """The bf16 ulp at |x| (float64 out; subnormals as the least normal)."""
    import torch

    mag = x.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_scatter_bound(before, ids, upd):
    """(exact float64 sum, per-element bound, adds per row) of a bf16
    scatter-add of float32 ``upd`` at ``ids`` into ``before``; see above."""
    import torch

    R = before.shape[0]
    keep = (ids >= 0) & (ids < R)
    idx = ids[keep].long()
    ub = upd[keep].to(torch.bfloat16).double()
    exact = before.double().index_add(0, idx, ub)
    mag = before.double().abs().index_add(0, idx, ub.abs())
    adds = torch.bincount(idx, minlength=R).double()[:, None]
    return exact, adds * (bf16_ulp(mag) + mag * 2.0 ** -22), adds[:, 0]


def check_bf16_scatter(got, plain, before, ids, upd, what: str) -> float:
    """A bf16 scatter-add's kernel result ``got`` and plain result
    ``plain`` from ``before``: rows hit once bit-equal, rows hit more
    within ``bf16_scatter_bound`` of the exact sum, rows hit never
    unchanged. Returns the largest difference of ``got`` from the exact
    sum in units of its bound (0 when no row is hit twice)."""
    import torch

    exact, bound, adds = bf16_scatter_bound(before, ids, upd)
    once = adds == 1
    if not torch.equal(got[once], plain[once]):
        raise AssertionError(f"{what}: rows hit once differ between kernel "
                             f"and plain")
    if not torch.equal(got[adds == 0], before[adds == 0]):
        raise AssertionError(f"{what}: rows no id touches changed")
    worst = 0.0
    for name, t in (("kernel", got), ("plain", plain)):
        over = (t.double() - exact).abs() / bound.clamp(min=1e-300)
        bad = (adds[:, None] > 1) & (over > 1)
        if bool(bad.any()):
            raise AssertionError(f"{what}: {name} off the exact sum by "
                                 f"{float(over[bad].max()):.3g} bounds")
        if name == "kernel" and bool((adds > 1).any()):
            worst = float(over[adds > 1].max())
    return worst


def pileup_bound(row, upd, rows_per_warp: int):
    """Per-element bound on |kernel - exact sum| for a bf16 scatter-add of
    float32 ``upd`` (n, D) all onto one row that starts at ``row``. The
    kernel merges each warp's ``rows_per_warp`` consecutive updates,
    rounded to bf16, in float32 (error within gamma_31(2^-24) of their
    magnitudes), rounds the merged sum to bf16 once (2^-8 of it) and
    sends it as one of r = ceil(n / rows_per_warp) reductions, each
    rounding in bf16 in any order: recursive summation of r + 1 terms,
    within gamma_r(2^-8) (|row| + sum of their magnitudes), gamma_r(u) =
    r u / (1 - r u) (Higham, Accuracy and Stability, 4.3)."""
    def gamma(r, u):
        return r * u / (1 - r * u)

    n = upd.shape[0]
    r = -(-n // rows_per_warp)
    mass = upd.to(row.dtype).double().abs().sum(0)   # sum |round(u)|
    merged = mass * (1 + 2.0 ** -8) * (1 + gamma(rows_per_warp, 2.0 ** -24))
    return (gamma(r, 2.0 ** -8) * (row.double().abs() + merged)
            + merged - mass)


def check_bf16_kernels(card: str) -> dict:
    """gather_pool's bf16 and narrow instantiations and scatter_add's bf16
    ones against their plain versions, at ragged shapes and edge cases."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    gen = torch.Generator(device="cuda").manual_seed(12)
    R = 100_003
    g_err = 0.0
    taken = set()
    cases = [(torch.bfloat16, D, False) for D in (8, 32, 64, 128, 1, 3, 12)]
    cases += [(torch.float32, D, False) for D in (1, 3, 6)]
    cases += [(torch.bfloat16, 32, True), (torch.float32, 32, True)]
    for dtype, D, off in cases:
        buf = torch.randn(R * D + 1, generator=gen, device="cuda").to(dtype)
        # one element off a 16-byte boundary: the narrow instantiation
        table = (buf[1:] if off else buf[:-1]).view(R, D)
        for B, K, mean, mask_id in ((1, 1, False, -1), (777, 1, False, -1),
                                    (13, 5, True, 0), (1000, 5, False, 0)):
            ids = torch.randint(-3, R + 7, (B, K), generator=gen,
                                device="cuda", dtype=torch.int32)
            ids[0, 0] = mask_id
            taken.add(gp.instantiation(D, dtype, table.data_ptr()))
            k = gp.gather_pool_cuda(table, ids, mean, mask_id)
            p = gp.gather_pool_plain(table, ids, mean, mask_id)
            torch.cuda.synchronize()
            if K == 1 and not torch.equal(k, p):
                raise AssertionError(f"gather_pool {dtype} D={D} B={B} "
                                     f"differs")
            torch.testing.assert_close(k, p, rtol=POOL_TOL, atol=POOL_TOL)
            g_err = max(g_err, float((k - p).abs().max()))
    if taken != {gp.BF16X8, gp.NARROW_F32, gp.NARROW_BF16}:
        raise AssertionError(f"gather_pool instantiations taken: {taken}")
    # scatter_add into bf16 tables: vector (D 32, 64, 128) and generic
    # (D 1, 3, 8, and D 32 with updates one float off a 16-byte boundary)
    s_taken, worst, s_err = set(), 0.0, 0.0
    for D in (32, 64, 128, 1, 3, 8):
        table = (torch.randn(R, D, generator=gen, device="cuda")
                 * 0.1).to(torch.bfloat16)
        for n in (1, 777, 10_000):
            uniq = torch.randperm(R, generator=gen, device="cuda")[:n].int()
            if n > 2:  # dropped ids at both ends of the range
                uniq[n // 2], uniq[-1] = -1, R
            dup = torch.randint(0, max(n // 4, 1), (n,), generator=gen,
                                device="cuda", dtype=torch.int32)
            upds = [torch.randn(n, D, generator=gen, device="cuda") * 1e-2]
            if D == 32:
                off = torch.randn(n * D + 1, generator=gen,
                                  device="cuda") * 1e-2
                upds.append(off[1:].view(n, D))
            for ids in (uniq, dup):
                for upd in upds:
                    k, p = table.clone(), table.clone()
                    s_taken.add(sa.launch_plan(n, D, k.data_ptr(),
                                               upd.data_ptr(),
                                               torch.bfloat16)[0])
                    sa.scatter_add_cuda(k, ids, upd)
                    sa.scatter_add_plain(p, ids, upd)
                    torch.cuda.synchronize()
                    worst = max(worst, check_bf16_scatter(
                        k, p, table, ids, upd, f"bf16 scatter D={D} n={n}"))
                    s_err = max(s_err, float((k.float() - p.float()).abs()
                                             .max()))
    if s_taken != {0, 32, 64, 128}:
        raise AssertionError(f"bf16 scatter_add instantiations: {s_taken}")
    # exact pile-ups, every id on row 7 of a 100,096-row bf16 table, at D
    # 32 (vector) and 1 (generic): 76,288 updates, zero but for 160 + c at
    # random rows of column c, 100 + c of them +2^-8 and 60 of them -2^-8,
    # onto a row that starts at (60 + c) 2^-8. Every partial sum in any
    # order, merged in a warp or not, is a whole number of 2^-8 in
    # [0, 222], exact in bf16 (8 significant bits), so kernel, plain and
    # the exact sum (100 + 2c) 2^-8 must be bit-equal: an update dropped,
    # doubled or sent to another column or row shows
    n = 76_288
    same = torch.full((n,), 7, dtype=torch.int32, device="cuda")
    for D in (32, 1):
        table = (torch.randn(100_096, D, generator=gen, device="cuda")
                 * 0.1).to(torch.bfloat16)
        col = torch.arange(D, device="cuda")
        table[7] = ((60 + col) * 2.0 ** -8).to(torch.bfloat16)
        upd = torch.zeros(n, D, device="cuda")
        for c in range(D):
            rows = torch.randperm(n, generator=gen, device="cuda")[:160 + c]
            upd[rows[:100 + c], c] = 2.0 ** -8
            upd[rows[100 + c:], c] = -2.0 ** -8
        k = sa.scatter_add_cuda(table.clone(), same, upd)
        p = sa.scatter_add_plain(table.clone(), same, upd)
        torch.cuda.synchronize()
        want = table.clone()
        want[7] = ((100 + 2 * col) * 2.0 ** -8).to(torch.bfloat16)
        exact, _, _ = bf16_scatter_bound(table, same, upd)
        if not (torch.equal(k, want) and torch.equal(p, want)
                and torch.equal(exact, want.double())):
            raise AssertionError(f"bf16 exact pile-up D={D} differs")
    # a random pile-up: BF16_PILE_IDS positive updates on row 7 at D=32,
    # held to pileup_bound, built on the kernel's reductions into the row
    D = 32
    table = (torch.randn(100_096, D, generator=gen, device="cuda")
             * 0.1).to(torch.bfloat16)
    same = torch.full((BF16_PILE_IDS,), 7, dtype=torch.int32, device="cuda")
    upd = torch.rand(BF16_PILE_IDS, D, generator=gen, device="cuda") * 1e-2
    k = sa.scatter_add_cuda(table.clone(), same, upd)
    p = sa.scatter_add_plain(table.clone(), same, upd)
    torch.cuda.synchronize()
    bound = pileup_bound(table[7], upd, rows_per_warp=32)
    exact = table[7].double() + upd.to(torch.bfloat16).double().sum(0)
    over = float(((k[7].double() - exact).abs() / bound).max())
    if over > 1 or not torch.equal(torch.cat([k[:7], k[8:]]),
                                   torch.cat([table[:7], table[8:]])):
        raise AssertionError(f"bf16 random pile-up: {over:.3g} of its bound")
    pile_err = float((k.float() - p.float()).abs().max())
    s_err = max(s_err, pile_err)
    log(f"kernel gather_pool bf16 and narrow instantiations: bf16 D in (8, "
        f"32, 64, 128) and (1, 3, 12), float32 D in (1, 3, 6), D=32 one "
        f"element off a 16-byte boundary in both dtypes; B in (1, 13, 777, "
        f"1000), K in (1, 5), sum and mean, masked and clamped ids: ok, "
        f"K=1 bit-equal, max_abs_err {g_err:.3g}; instantiations "
        f"{sorted(gp.INSTANTIATIONS[t] for t in taken)} [{card}]")
    log(f"kernel scatter_add into bf16 tables: D in (32, 64, 128, 1, 3, 8), "
        f"n in (1, 777, 10000), unique ids (dropped -1 and R among them) "
        f"and ids repeated about 4 times, D=32 also with updates off a "
        f"16-byte boundary; instantiations {sorted(s_taken)} (0: generic): "
        f"rows hit once bit-equal, rows hit more within "
        f"{worst:.3g} of their bound (k (ulp(M) + M 2^-22)); 76,288 updates "
        f"on one row at D 32 and 1, every partial sum exact: bit-equal to "
        f"the exact sum; {BF16_PILE_IDS} positive random updates on one "
        f"row: within {over:.3g} of the bound on the kernel's reductions "
        f"(largest bound {float(bound.max()):.3g}, row sum up to "
        f"{float(exact.max()):.3g}); max_abs_err against plain "
        f"{s_err:.3g} [{card}]")
    return {"gather_err": g_err, "scatter_err": s_err}


def lazy_bf16_steps(card: str) -> dict:
    """20 lazy steps at momentum 0.98 on a 1M x 32 bf16 table with bf16
    moments (scale_table's step), with the kernels and then, from the same
    init, with their plain versions on the card."""
    import torch

    from esrecsys_tpu_torch.tools import scale_table as st

    dev = torch.device("cuda")
    cfg = st.ScaleConfig(rows=LAZY_BF16_ROWS, dim=32, dtype="bfloat16",
                         ids_per_step=SCALE_IDS, momentum=0.98,
                         device="cuda")
    states = []
    for plain in (False, True):
        table, state = st.init(cfg, dev)
        step = st.make_step(cfg, table, state)
        with plain_kernels() if plain else contextlib.nullcontext():
            losses = [float(step(s)) for s in range(STEPS)]
        states.append((table, state, losses))
    (tk, sk, lk), (tp, sp, lp) = states
    if not torch.equal(sk["last_step"], sp["last_step"]):
        raise AssertionError("lazy bf16: last_step differs")
    report = {}
    for name, a, b in (("table", tk, tp),
                       ("momentum", sk["momentum"], sp["momentum"])):
        report[name] = int((a != b).sum())
        if report[name]:
            raise AssertionError(f"lazy bf16 {name}: {report[name]} "
                                 f"elements differ")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"lazy carrier, bf16 table and moments ({LAZY_BF16_ROWS} x 32, "
        f"{SCALE_IDS} ids a step, momentum 0.98), {STEPS} steps with the "
        f"kernels against the plain versions on the card from one init: "
        f"last_step, table and momentum bit-equal; loss max relative diff "
        f"{loss_rel:.3g} [{card}]")
    return report


def written_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn`` in ms, its write-back to HBM
    included. A round is a read-only pass over 128 MiB (a row-wise max),
    the call, and another such pass (a row-wise min, so the two are told
    apart by name). The call finds the 50 MB L2 cache cold and clean; the
    pass after it also writes the call's dirty lines back. So the time is
    the call's own kernel time plus how much longer the second pass takes
    than the first, less that difference in rounds without the call
    (each from one profiler trace, so drift between traces cancels). An
    output that fits in the L2 so counts as written, as it does not when
    the clock stops at the call's end (``cold_rows``). The traces are
    ``trace_rows``'; CUDA events are the fallback when they hold no
    device rows."""
    import torch

    flush = torch.ones((32768, 1024), dtype=torch.int32, device="cuda")

    def first():
        flush.amax(dim=1)

    def second():
        flush.amin(dim=1)

    fn()
    second()
    torch.cuda.synchronize()
    first_rows = trace_rows((first,), reps)
    base = trace_rows((first, second), reps) if first_rows else None
    timed = trace_rows((first, fn, second), reps) if base else None
    if not timed:
        log(f"written_ms: {TRACE_TRIES} profiler traces held no device "
            f"rows; CUDA events around the call with the L2 flushed "
            f"instead, no write-back (marked)")
        return events_ms(fn, flush, reps)
    first_keys = set(first_rows)
    second_keys = set(base) - first_keys
    if not second_keys or not first_keys <= set(timed) \
            or not second_keys <= set(timed):
        raise RuntimeError(f"the passes' kernels: {sorted(base)}")

    def lag(r):  # how much longer the second pass takes than the first
        return (sum(r[k] for k in second_keys)
                - sum(r[k] for k in first_keys))

    own = sum(t for k, t in timed.items()
              if k not in first_keys and k not in second_keys)
    return own + lag(timed) - lag(base)


def row_kernel_calls(table, ids, upd):
    """The gather row's and the scatter row's calls at one shape, (kernel,
    plain, library) each, and their bounds in ms: the distinct rows the
    ids touch (read once; the scatter's also written once), the ids, and
    the float32 rows out or updates in, at the HBM rate."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    n, D = upd.shape
    ids2 = ids[:, None].contiguous()
    distinct = int(torch.unique(ids).numel()) * D * table.element_size()
    g_bound = (distinct + n * 4 + n * D * 4) / HBM_BYTES_PER_S * 1e3
    s_bound = (n * D * 4 + n * 4 + 2 * distinct) / HBM_BYTES_PER_S * 1e3
    lib_upd = upd.to(table.dtype)
    gather = (lambda: gp.gather_pool_cuda(table, ids2, False, -1),
              lambda: gp.gather_pool_plain(table, ids2, False, -1),
              lambda: table.index_select(0, ids))
    scatter = (lambda: sa.scatter_add_cuda(table, ids, upd),
               lambda: sa.scatter_add_plain(table, ids, upd),
               lambda: table.index_add_(0, ids, lib_upd))
    return gather, scatter, g_bound, s_bound


def time_row_kernels(table, ids, upd):
    """(gather row, scatter row) at one shape: (kernel, plain, library,
    bound) ms each, from a cold and clean L2, write-back included
    (``written_ms``)."""
    gather, scatter, g_bound, s_bound = row_kernel_calls(table, ids, upd)
    return (tuple(map(written_ms, gather)) + (g_bound,),
            tuple(map(written_ms, scatter)) + (s_bound,))


def timing_line(what: str, gather, scatter) -> str:
    return (f"{what}: gather_pool {gather[0] * 1e3:.1f} us (plain "
            f"{gather[1] * 1e3:.1f}, index_select {gather[2] * 1e3:.1f}, "
            f"bound {gather[3] * 1e3:.1f}); scatter_add {scatter[0] * 1e3:.1f}"
            f" us (plain {scatter[1] * 1e3:.1f}, index_add_ "
            f"{scatter[2] * 1e3:.1f}, bound {scatter[3] * 1e3:.1f})")


def instantiation_row(timed, launches: int) -> dict:
    kernel, plain, library, bound = timed
    return {"launches": launches, "ms": kernel, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": "bytes"}


def phase_bf16(card: str) -> dict:
    """bf16 tables: the new instantiations against their plain versions,
    both kernels on a 100M x 32 bf16 table, scale_table --dtype bfloat16
    at that width (the main path: momentum 0, then 0.98), and 20 lazy
    steps with bf16 moments against the plain versions."""
    import gc

    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.tools import scale_table as st

    out = check_bf16_kernels(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["big_err"] = check_big_table(card, SCALE_ROWS, 32, SCALE_IDS,
                                     "bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    # ---- the main path: scale_table --dtype bfloat16 at 100M x 32
    for mod in (gp, sa):
        mod.LAUNCHES.reset()
    runs = {}
    for mu in (0.0, 0.98):
        runs[mu] = st.run(st.ScaleConfig(
            rows=SCALE_ROWS, dim=32, dtype="bfloat16",
            ids_per_step=SCALE_IDS, momentum=mu, calls=5, device="cuda"))
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = {"gather_pool": dict(gp.LAUNCHES.by_instantiation),
                       "scatter_add": dict(sa.LAUNCHES.by_instantiation)}
    for mu, r in runs.items():
        if not r["value"] > 0 or not np.isfinite(r["last_loss"]):
            raise AssertionError(f"scale_table bf16 momentum {mu}: {r}")
        log(f"scale_table --rows {SCALE_ROWS} --dim 32 --dtype bfloat16 "
            f"--ids_per_step {SCALE_IDS} --momentum {mu} ({r['table_gb']:.1f} "
            f"GB table{' + as much momentum + last_step' if mu else ''}): "
            f"{r['value']:.0f} rows/s, {r['ms_per_step']:.3f} ms/step over "
            f"{r['steps']} steps (host clock), peak device memory "
            f"{r['peak_memory_gb']:.2f} GB [{r['card']}]")
    if runs[0.98]["peak_memory_gb"] > SCALE_BF16_PEAK_GB:
        raise AssertionError(f"scale_table bf16 peak "
                             f"{runs[0.98]['peak_memory_gb']:.2f} GB")
    log(f"bf16 path launches {out['launches']} [{card}]")
    out["scale"] = runs
    # ---- the step's row kernels at its shapes on a 100M x 32 bf16 table
    cfg = st.ScaleConfig(rows=SCALE_ROWS, dim=32, dtype="bfloat16",
                         ids_per_step=SCALE_IDS, device="cuda")
    table, _ = st.init(cfg, torch.device("cuda"))
    ids = st.step_ids(cfg, 0, torch.Generator(device="cuda"))
    upd = torch.randn(SCALE_IDS, 32, device="cuda") * 1e-3
    gather, scatter = time_row_kernels(table, ids, upd)
    log(timing_line(f"scale_table's step shapes ({SCALE_ROWS} x 32 bf16, "
                    f"{SCALE_IDS} ids), device time per call from a cold, "
                    f"clean L2, write-back included (profiler, 50 calls)",
                    gather, scatter)
        + f" [{card}]")
    out["timed"] = {"gather_pool": {"bf16x8": gather},
                    "scatter_add": {"bf16_d32": scatter}}
    del table, ids, upd
    gc.collect()
    torch.cuda.empty_cache()
    out["lazy"] = lazy_bf16_steps(card)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ glove

GLOVE_VOCAB = 500_000         # dictionary tokens: 565,537 table rows with
# the mask and the 65,536 minhash buckets (BENCHMARKS.md:241)
GLOVE_ROWS = 4_000            # co-occurrence rows written, 50 others each:
GLOVE_OTHERS = 50             # 200,000 triples, past 20 steps and one eval
GLOVE_SHUFFLE = 131_072       # shuffle buffer, cut from 5,000,000
GLOVE_EVAL_STEPS = 50         # the reference's eval_steps
GLOVE_PROBES = "news,apple,computer,physics,math,biology"
# the dense step with the kernels against the same steps with the plain
# versions: the gradients' duplicate rows sum in another order, and Adam's
# m / (sqrt(v) + eps) can turn a near-cancelled float32 gradient element's
# last bits into a different update; at most this share of the elements of
# the rows the steps touch (the only rows dense Adam moves) may differ by
# more than 1e-6, so a row that takes a wrong update shows
GLOVE_DIFF_SHARE = 1e-4
GLOVE_LOSS_RTOL = 1e-5


def write_glove_data(root: str, seed: int = 0):
    """A dictionary of GLOVE_VOCAB tokens (the probe terms first) and
    GLOVE_ROWS co-occurrence rows with Zipf-drawn token ids, so ids
    repeat as in text, written by the port's recordio: (dictionary path,
    shard pattern, the vocabulary)."""
    import numpy as np

    from esrecsys_tpu_torch.data import recordio
    from esrecsys_tpu_torch.data.protos import CooccurrenceRow
    from esrecsys_tpu_torch.data.vocab import VocabEntry, Vocabulary

    probes = GLOVE_PROBES.split(",")
    tokens = probes + [f"w{i:06d}" for i in range(GLOVE_VOCAB - len(probes))]
    vocab = Vocabulary([VocabEntry(token=t, frequency=GLOVE_VOCAB - i,
                                   doc_frequency=1)
                        for i, t in enumerate(tokens)])
    dict_path = os.path.join(root, "dictionary.gz")
    vocab.save(dict_path)
    rng = np.random.default_rng(seed)

    def zipf(n):
        return (rng.zipf(1.1, n) - 1) % GLOVE_VOCAB + 1

    index = zipf(GLOVE_ROWS)
    others = zipf(GLOVE_ROWS * GLOVE_OTHERS).reshape(GLOVE_ROWS, -1)
    counts = np.floor(rng.pareto(1.2, others.shape) * 3 + 1).astype(
        np.float32)
    with recordio.ShardedWriter(os.path.join(root, "cooc"),
                                records_per_shard=1000) as w:
        for i in range(GLOVE_ROWS):
            w.write_proto(CooccurrenceRow(index=int(index[i]),
                                          other_index=others[i],
                                          count=counts[i]))
    return dict_path, os.path.join(root, "cooc", "part-*.bz2"), vocab


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def glove_run(card: str, root: str, pattern: str, vocab, optimizer: str
              ) -> dict:
    """workloads/glove.train() at full width for STEPS steps: two log
    windows, one eval round, the knn hook at steps 10 and 20, a
    checkpoint at 20 (restored bit for bit into a fresh state) and the
    export; launches by instantiation."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.core.tracking import MemoryTracker
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.train import Checkpointer
    from esrecsys_tpu_torch.train.export import load_model
    from esrecsys_tpu_torch.workloads import glove as gl

    work = os.path.join(root, optimizer)
    half = STEPS // 2
    cfg = gl.GloveConfig(
        train_pattern=pattern, work_dir=work, steps_per_epoch=half,
        num_epochs=2, eval_every_epochs=2, checkpoint_every_epochs=2,
        shuffle_buffer_size=GLOVE_SHUFFLE, eval_steps=GLOVE_EVAL_STEPS,
        optimizer=optimizer)
    # the eval loss at the init, over the batches of the run's eval round
    model0, state0 = gl.init_state(cfg, vocab.num_embeddings, "cuda")
    eval_step = gl.make_eval_step(model0)
    feed = pipelines_glove_batches(pattern, seed=cfg.seed + 1)
    eval0 = float(np.mean([float(eval_step(
        state0, gl.to_device(next(feed), torch.device("cuda")))["loss"])
        for _ in range(GLOVE_EVAL_STEPS)]))
    del model0, state0
    tracker = MemoryTracker()
    records = _Records()
    glog = logging.getLogger("esrecsys_tpu_torch.workloads.glove")
    glog.setLevel(logging.INFO)
    glog.addHandler(records)
    for mod in (gp, sa):
        mod.LAUNCHES.reset()
    try:
        t0 = time.perf_counter()
        res = gl.train(cfg, tracker=tracker, vocab=vocab, device="cuda")
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
    finally:
        glog.removeHandler(records)
    launches = {"gather_pool": dict(gp.LAUNCHES.by_instantiation),
                "scatter_add": dict(sa.LAUNCHES.by_instantiation)}
    windows = [m["train_loss"] for _, m in tracker.records
               if "train_loss" in m]
    ms = [m["ms_per_step"] for _, m in tracker.records if "ms_per_step" in m]
    ev = res.last_eval_metrics
    knn = [line for line in records.lines if line.startswith("knn step=")]
    want = {"gather_pool": {"f32x4", "narrow_f32"},
            "scatter_add": {"f32_d64", "f32_generic"}}
    if res.state.step != STEPS or len(windows) != 2 or not ev \
            or not ev["eval_loss"] < eval0 \
            or len(knn) != 2 * len(GLOVE_PROBES.split(",")) \
            or any(set(launches[k]) != v for k, v in want.items()):
        raise AssertionError(f"glove {optimizer}: step {res.state.step}, "
                             f"loss windows {windows}, eval {ev} (at the "
                             f"init {eval0}), "
                             f"{len(knn)} knn lines, launches {launches}")
    emb = res.state.params.token_embedding.embedding
    if emb.shape != (565_632, 64) or vocab.num_embeddings != 565_537:
        raise AssertionError(f"glove table {tuple(emb.shape)}")
    params, _, meta = load_model(os.path.join(
        work, "artifacts", f"glove-{STEPS:08d}.npz"))
    if meta["padded_rows"] != 565_632 or meta["vocab_rows"] != 565_537 \
            or not np.array_equal(params["bias"]["embedding"],
                                  res.state.params.bias.embedding.detach()
                                  .cpu().numpy()):
        raise AssertionError(f"glove {optimizer} export: {meta}")
    ck = Checkpointer(os.path.join(work, "checkpoints"))
    _, fresh = gl.init_state(dataclasses.replace(cfg, seed=1),
                             vocab.num_embeddings, "cuda")
    restored = ck.restore(fresh)
    bad = [n for n, t in res.state.params.state_dict().items()
           if not torch.equal(t, restored.params.state_dict()[n])]
    bad += [f"{k}/{m}" for k, d in res.state.opt_state.items()
            for m, t in d.items()
            if not torch.equal(t, restored.opt_state[k][m])]
    if bad or restored.step != STEPS:
        raise AssertionError(f"glove {optimizer} checkpoint differs: {bad}")
    # a step on the host clock and the device's busy share
    batch = gl.to_device(next(pipelines_glove_batches(pattern)),
                         torch.device("cuda"))
    step = gl.select_train_step(res.state.params, cfg)
    step_ms = host_ms(lambda: (step(res.state, batch),
                               torch.cuda.synchronize()), 10)
    wall, busy, top = device_breakdown(
        lambda: (step(res.state, batch), torch.cuda.synchronize()), 5)
    busy_txt = ("device time not measured" if busy is None else
                f"device busy {busy:.3f} ms (idle share "
                f"{1 - busy / wall:.2f}); largest: "
                + ", ".join(f"{k[:40]} {v * 1e3:.1f} us"
                            for k, v in top[:3]))
    log(f"glove train() ({optimizer}, {vocab.num_embeddings} tokens padded "
        f"to 565,632 x 64, B=2048, lr 5e-4, {STEPS} steps, shuffle buffer "
        f"{GLOVE_SHUFFLE}): {path_s:.1f} s with one eval round of "
        f"{GLOVE_EVAL_STEPS} batches ({res.eval_round_s[0] * 1e3:.1f} ms), "
        f"the knn hook twice, a checkpoint ({res.ckpt_save_s[0]:.2f} s, "
        f"restored bit for bit) and the export; eval loss over the same "
        f"{GLOVE_EVAL_STEPS} batches {eval0:.5f} at the init, "
        f"{ev['eval_loss']:.5f} at step {STEPS}; train loss of steps 1-10 "
        f"{windows[0]:.5f}, 11-20 {windows[1]:.5f}; fit's ms/step "
        f"{ms[0]:.3f}, {ms[1]:.3f} "
        f"(host clock, data included); launches {launches} [{card}]")
    log(f"glove {optimizer} step: {step_ms:.3f} ms on the host clock "
        f"(median of 10, one batch on the card); under the profiler "
        f"{wall:.3f} ms, {busy_txt} [{card}]")
    log(f"glove knn at step {STEPS}: {knn[-1][:160]}")
    return {"launches": launches, "step_ms": step_ms, "busy": busy,
            "wall": wall, "eval": (eval0, ev["eval_loss"]),
            "state": res.state}


def pipelines_glove_batches(pattern: str, shuffle_buffer: int = 0,
                            seed: int = 5):
    """Full-width GloVe batches (B=2048) of the shards."""
    from esrecsys_tpu_torch.data import pipelines

    return pipelines.glove_batches(pattern, 2048,
                                   shuffle_buffer=shuffle_buffer, seed=seed)


def glove_dense_against_plain(card: str, pattern: str, vocab) -> dict:
    """K_STEPS dense steps with the kernels against the same steps with
    their plain versions on the card, from one init."""
    import torch

    from esrecsys_tpu_torch.workloads import glove as gl

    cfg = gl.GloveConfig(train_pattern=pattern)
    feed = pipelines_glove_batches(pattern)
    batches = [gl.to_device(next(feed), torch.device("cuda"))
               for _ in range(K_STEPS)]
    runs = []
    for plain in (False, True):
        model, state = gl.init_state(cfg, vocab.num_embeddings, "cuda")
        step = gl.make_train_step(model, cfg)
        with plain_kernels() if plain else contextlib.nullcontext():
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
        runs.append((state, losses))
    (sk, lk), (sp, lp) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    touched = torch.unique(torch.cat([t for (pair, _) in batches
                                      for t in pair]).long())
    worst, share = {}, {}
    for name in ("token_embedding", "bias"):
        a = getattr(sk.params, name).embedding.detach()[touched]
        b = getattr(sp.params, name).embedding.detach()[touched]
        diff = (a - b).abs()
        worst[name] = float(diff.max())
        share[name] = float((diff > 1e-6).double().mean())
        if share[name] > GLOVE_DIFF_SHARE:
            raise AssertionError(f"glove dense step {name}: share "
                                 f"{share[name]} of the touched elements "
                                 f"differ by more than 1e-6")
    if loss_rel > GLOVE_LOSS_RTOL:
        raise AssertionError(f"glove dense step loss: {loss_rel}")
    log(f"glove dense step, {K_STEPS} steps with the kernels against their "
        f"plain versions on the card from one init: loss max relative diff "
        f"{loss_rel:.3g} (bound {GLOVE_LOSS_RTOL}); over the "
        f"{touched.numel()} rows the steps touch: "
        + ", ".join(f"{k} max abs diff {worst[k]:.3g}, share over 1e-6 "
                    f"{share[k]:.3g}" for k in worst)
        + f" (bound: share {GLOVE_DIFF_SHARE}) [{card}]")
    return worst


def rows_against_plain(card: str, what: str, table, ids, upd, kinds):
    """A step's row kernels at its ids (repeats and pile-ups and all)
    against their plain versions on fresh clones of one of its trained
    tables: the gather bit-equal, the scatter-add within TOL, rows no id
    touches untouched, the instantiations ``kinds``. ``what`` names the
    step and the table. Returns (gather err, scatter err)."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    ids2 = ids[:, None].contiguous()
    gk = gp.gather_pool_cuda(table, ids2, False, -1)
    gplain = gp.gather_pool_plain(table, ids2, False, -1)
    k, p = table.clone(), table.clone()
    taken = (gp.INSTANTIATIONS[gp.instantiation(table.shape[1], table.dtype,
                                                 table.data_ptr())],
             sa.launch_plan(ids.shape[0], table.shape[1], k.data_ptr(),
                            upd.data_ptr())[0])
    sa.scatter_add_cuda(k, ids, upd)
    sa.scatter_add_plain(p, ids, upd)
    torch.cuda.synchronize()
    if not torch.equal(gk, gplain):
        raise AssertionError(f"{what}: gather_pool differs")
    torch.testing.assert_close(k, p, rtol=TOL, atol=TOL)
    hit = torch.zeros(table.shape[0], dtype=torch.bool, device="cuda")
    hit[ids.long()] = True
    if not torch.equal(k[~hit], table[~hit]):
        raise AssertionError(f"{what}: scatter_add changed rows no id "
                             f"touches")
    want = (kinds[0], 0 if kinds[1] == "f32_generic" else table.shape[1])
    if taken != want:
        raise AssertionError(f"{what}: instantiations {taken}")
    s_err = float((k - p).abs().max())
    log(f"{what} ({tuple(table.shape)}, {ids.shape[0]} "
        f"ids): gather_pool {kinds[0]} bit-equal to plain; scatter_add "
        f"{kinds[1]} max_abs_err {s_err:.3g} (TOL {TOL}) [{card}]")
    return 0.0, s_err


def phase_glove(card: str) -> dict:
    """The GloVe trainer at the reference's full width: synthetic data by
    the port's recordio, train() under adam and lazy_adam (the main path),
    the dense step against its plain-version twin, and the row kernels at
    the step's shapes."""
    import gc

    import numpy as np
    import torch

    from esrecsys_tpu_torch.data.vocab import Vocabulary

    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dict_path, pattern, vocab = write_glove_data(root)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = Vocabulary.load(dict_path)
        t_load = time.perf_counter() - t0
        if loaded.num_embeddings != vocab.num_embeddings:
            raise AssertionError("the dictionary does not load back")
        log(f"glove data: a {GLOVE_VOCAB}-token dictionary and "
            f"{GLOVE_ROWS * GLOVE_OTHERS} co-occurrence triples (Zipf ids) "
            f"written by the port's recordio in {t_write:.1f} s; the "
            f"dictionary loaded in {t_load:.1f} s [{card}]")
        for optimizer in ("adam", "lazy_adam"):
            r = glove_run(card, root, pattern, loaded, optimizer)
            out[optimizer] = {k: v for k, v in r.items() if k != "state"}
            state = r["state"]
            del r
            gc.collect()
            torch.cuda.empty_cache()
        # the row kernels at the step's shapes, on the trained tables
        (t1, t2), _ = next(pipelines_glove_batches(pattern))
        ids = torch.from_numpy(np.concatenate([t1, t2])).cuda()
        timed, errs = {}, {}
        for name, kinds in (("token_embedding", ("f32x4", "f32_d64")),
                            ("bias", ("narrow_f32", "f32_generic"))):
            table = getattr(state.params, name).embedding.detach().clone()
            upd = torch.randn(ids.shape[0], table.shape[1],
                              device="cuda") * 1e-3
            errs[kinds[0]], errs[kinds[1]] = rows_against_plain(
                card, f"glove step ids on {name}", table, ids, upd, kinds)
            gather, scatter = time_row_kernels(table, ids, upd)
            timed[kinds[0]], timed[kinds[1]] = gather, scatter
            log(timing_line(f"glove step shapes, {name} ({table.shape[0]} x "
                            f"{table.shape[1]} float32, {ids.shape[0]} ids, "
                            f"{int(torch.unique(ids).numel())} distinct), "
                            f"device time per call from a cold, clean L2, "
                            f"write-back included (profiler, 50 calls)",
                            gather, scatter)
                + f" [{card}]")
            del table, upd
        out["timed"], out["errs"] = timed, errs
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out["dense_vs_plain"] = glove_dense_against_plain(card, pattern,
                                                          loaded)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- wiki

# pages of the synthetic dump, cut from about 20,000: the script must exit
# within 1,200 s and is held to half of that, so that a host 1.3-1.6x
# slower (seen between runs) still passes. The chain is host Python and
# linear in pages (375-381 s at 20,000, 176.8 s at 10,000, 60-97 s at
# 5,000, 66.8-91.9 s for the whole wiki phase at 1,250, on an NVIDIA H100
# 80GB HBM3 at 700 W: PERF.md); 625 pages left room for the stl fixtures
# and the grown mesh phase within about 600 s on the slower hosts, 400 for
# the generic kernels' checks and the wide path too
WIKI_PAGES = 400              # cut from 625 for the generic and wide phases
WIKI_LEXICON = 200_000        # distinct words, drawn Zipf(1.1) by rank
WIKI_STEPS = 5                # GloVe and txt2url steps on the chain's output
T2U_WORDS = 500_000           # dictionary tokens: 565,537 word rows
T2U_URLS = 1_000_000          # title dictionary: the URL table's rows
T2U_DOCS = 10_000             # synthetic sparse documents, 30 % short
                              # (cut from 20,000)
T2U_ROWS = 20_000             # url2url rows of 20 others each
T2U_EVAL_STEPS = 16
# K steps with the kernels against the same steps through the plain
# versions: the scatter sums duplicate rows (the pad row's pile-up among
# them) in another order, and RMSprop divides each gradient element by
# its own root mean square, so an element of a float32-noise gradient
# can take a different update; at most this share of the compared
# elements (the rows the steps touch, every element of the dense
# parameters) may differ by more than 1e-6
T2U_DIFF_SHARE = 1e-3
T2U_LOSS_RTOL = 1e-5
# the encoder on the card against the same encoder in float64 on the CPU:
# float32 rounding through 32 LSTM steps stays near 1e-6; a TF32 product
# keeps 10 mantissa bits (about 5e-4 relative)
T2U_F64_ATOL = 1e-5


def write_wiki_dump(path: str, pages: int, seed: int = 0) -> dict:
    """A MediaWiki export of ``pages`` pages made from ``seed``: articles
    of 300-600 tokens drawn Zipf(1.1) over a WIKI_LEXICON-word lexicon
    (every sixth word capitalised) with punctuation, each with 5-30
    links (half to uniformly drawn pages, half Zipf(1.3), a third with
    shown text, one in ten into a rejected namespace), 2 % redirects and
    2 % Template: pages; some titles non-ASCII. Returns the counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 11, 2 * WIKI_LEXICON)
    chars = rng.integers(97, 123, (2 * WIKI_LEXICON, 10), dtype=np.uint8)
    words = list(dict.fromkeys(chars[i, :lens[i]].tobytes().decode()
                               for i in range(2 * WIKI_LEXICON)))
    words = [w.capitalize() if i % 6 == 0 else w
             for i, w in enumerate(words[:WIKI_LEXICON])]
    titles = [f"{words[i % 5000].capitalize()} {words[(7 * i) % 9973]} {i}"
              + (" café" if i % 97 == 0 else "") for i in range(pages)]
    seps = [" "] * 6 + [", ", ". ", "; ", " (", ") "]
    counts = {"articles": 0, "redirects": 0, "namespace": 0, "tokens": 0,
              "links": 0}
    with open(path, "w", encoding="utf-8") as f:
        f.write('<mediawiki xmlns="http://www.mediawiki.org/xml/'
                'export-0.10/">\n')
        for i, title in enumerate(titles):
            head = (f"<page><title>{{}}</title><ns>{{}}</ns><id>{i + 1}</id>")
            rev = (f"<revision><id>{10 * i}</id><parentid>{10 * i - 1}"
                   f"</parentid><timestamp>2020-01-01T00:00:00Z</timestamp>"
                   f"<contributor><username>u{i % 50}</username><id>"
                   f"{i % 50}</id></contributor><text>{{}}</text>"
                   f"</revision></page>\n")
            if i % 50 == 7:
                target = titles[(i + 1) % pages]
                f.write(head.format(title, 0)
                        + f'<redirect title="{target}"/>'
                        + rev.format(f"#REDIRECT [[{target}]]"))
                counts["redirects"] += 1
                continue
            n = int(rng.integers(300, 601))
            toks = (rng.zipf(1.1, n) - 1) % WIKI_LEXICON
            sep = rng.integers(0, len(seps), n)
            body = "".join(words[t] + seps[s] for t, s in zip(toks, sep))
            k = int(rng.integers(5, 31))
            links = np.where(rng.random(k) < 0.5, rng.integers(0, pages, k),
                             (rng.zipf(1.3, k) - 1) % pages)
            parts = []
            for j, link in enumerate(links):
                target = titles[link] if j % 10 else f"User:{words[link]}"
                parts.append(f"[[{target}|{words[link]}]]" if j % 3 == 1
                             else f"[[{target}]]")
            text = body + " " + " ".join(parts)
            if i % 50 == 13:
                f.write(head.format(f"Template:{title}", 10) + rev.format(text))
                counts["namespace"] += 1
                continue
            f.write(head.format(title, 0) + rev.format(text))
            counts["articles"] += 1
            counts["tokens"] += n
            counts["links"] += k
        f.write("</mediawiki>\n")
    return counts


def _stage(timings: dict, name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    timings[name] = time.perf_counter() - t0
    return out


def _reset_row_launches():
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    for mod in (gp, sa):
        mod.LAUNCHES.reset()


def _row_launches() -> dict:
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    return {"gather_pool": dict(gp.LAUNCHES.by_instantiation),
            "scatter_add": dict(sa.LAUNCHES.by_instantiation)}


def launches_by_table(fn) -> dict:
    """Run ``fn()`` with ``ops/lookup.py``'s calls of the row kernels
    wrapped: per table (by its row count), the launches each kernel's own
    count gained across that table's calls."""
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.ops import lookup

    by_table = {}

    def counted(name, kernel, counter):
        def call(table, *args, **kw):
            before = counter.count
            out = kernel(table, *args, **kw)
            got = by_table.setdefault(int(table.shape[0]),
                                      {"gather_pool": 0, "scatter_add": 0})
            got[name] += counter.count - before
            return out
        return call

    kernels = {"gather_pool": (lookup.gather_pool, gp.LAUNCHES),
               "scatter_add": (lookup.scatter_add, sa.LAUNCHES)}
    try:
        for name, (kernel, counter) in kernels.items():
            setattr(lookup, name, counted(name, kernel, counter))
        fn()
    finally:
        for name, (kernel, _) in kernels.items():
            setattr(lookup, name, kernel)
    return by_table


def accumulators_agree(shard: str, vocab, window: int = 10):
    """The native and the Python accumulator over one shard of token
    documents: (native s, Python s, entries); raises unless their rows
    are equal."""
    import numpy as np

    from esrecsys_tpu_torch import native
    from esrecsys_tpu_torch.data import recordio
    from esrecsys_tpu_torch.data.protos import TextDocument
    from esrecsys_tpu_torch.etl import cooccurrence

    ids = [vocab.embedding_indices(d.tokens)
           for d in recordio.read_protos(shard, TextDocument)]
    out = []
    for acc in (native.NativeCoocAccumulator(),
                cooccurrence.PyCoocAccumulator()):
        t0 = time.perf_counter()
        for doc in ids:
            acc.add_window(doc, window)
        rows = acc.export()
        out.append((time.perf_counter() - t0, rows))
    (t_native, a), (t_py, b) = out
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"the accumulators differ on {shard}")
    return t_native, t_py, int(a[0].shape[0])


def run_wiki_chain(card: str, root: str, device: str = "cuda") -> dict:
    """(a) The Wikipedia chain in the port's own code on a synthetic dump:
    XML -> pages -> token documents (native tokenizer) -> both
    dictionaries -> token co-occurrence (native accumulator, checked
    against the Python one on a shard) -> txt2url, url2url and tf-idf
    documents -> url co-occurrence -> codex and dump_correlates on a
    shard -> GloVe train() -> txt2url train() with GloVe transfer, to a
    txt2url artifact. Seconds and pages/s per stage."""
    import contextlib
    import io

    from esrecsys_tpu_torch import native
    from esrecsys_tpu_torch.core.tracking import MemoryTracker
    from esrecsys_tpu_torch.data.vocab import Vocabulary
    from esrecsys_tpu_torch.etl import (cooccurrence, dictionary,
                                        sparse_docs, wiki)
    from esrecsys_tpu_torch.tools import codex, dump_correlates
    from esrecsys_tpu_torch.train.export import load_model
    from esrecsys_tpu_torch.workloads import glove as gl
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    os.makedirs(root, exist_ok=True)
    xml = os.path.join(root, "dump.xml")
    sec = {}
    counts = _stage(sec, "dump", lambda: write_wiki_dump(xml, WIKI_PAGES))
    n_pages = _stage(sec, "xml2proto", lambda: wiki.xml_to_pages(
        xml, f"{root}/pages"))
    if wiki.tokenizer() is not native.tokenize:
        raise AssertionError("the native tokenizer did not load")
    n_docs = _stage(sec, "tokenize", lambda: wiki.tokenize_pages(
        f"{root}/pages/part-*", f"{root}/docs"))
    docs = f"{root}/docs/part-*"
    tok = _stage(sec, "token_dictionary",
                 lambda: dictionary.build_token_dictionary(docs))
    titles = _stage(sec, "title_dictionary",
                    lambda: dictionary.build_title_dictionary(docs))
    tok_path, title_path = f"{root}/tokens.bz2", f"{root}/titles.bz2"
    _stage(sec, "dictionaries_saved", lambda: (tok.save(tok_path),
                                               titles.save(title_path)))
    if type(cooccurrence.make_accumulator()) is not \
            native.NativeCoocAccumulator:
        raise AssertionError("the native accumulator did not load")
    n_cooc = _stage(sec, "token_cooccurrence",
                    lambda: cooccurrence.build_token_cooccurrence(
                        docs, tok, f"{root}/cooc"))
    t_native, t_py, entries = accumulators_agree(
        f"{root}/docs/part-00000.bz2", tok)
    n_sparse = {}
    for mode in ("txt2url", "url2url", "tfidf"):
        n_sparse[mode] = _stage(sec, mode, lambda: sparse_docs.convert(
            mode, docs, f"{root}/{mode}", tok, titles))
    n_url = _stage(sec, "url_cooccurrence",
                   lambda: cooccurrence.build_url_cooccurrence(
                       f"{root}/url2url/part-*", f"{root}/url_cooc"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        n_codex = codex.main(["--input", f"{root}/docs/part-00000.bz2",
                              "--proto", "doc", "--limit", "3"])
        dice = dump_correlates.main([
            "--input", f"{root}/url_cooc/part-00000.bz2", "--dictionary",
            title_path, "--metric", "dice", "--scale", "2.0", "--limit",
            "5"])
        counted = dump_correlates.main([
            "--input", f"{root}/cooc/part-00000.bz2", "--dictionary",
            tok_path, "--embedding_indices", "true", "--limit", "5"])
    if n_codex != 3 or printed.getvalue().count("primary: ") != 3 \
            or len(dice) != 5 or len(counted) != 5:
        raise AssertionError(f"codex {n_codex}, dump_correlates "
                             f"{len(dice)}, {len(counted)}")
    if not (n_docs and n_cooc and n_url and all(n_sparse.values())):
        raise AssertionError(f"an empty stage: docs {n_docs}, rows "
                             f"{n_cooc}, url rows {n_url}, {n_sparse}")
    # the trainers on the chain's output
    probes = ",".join(tok.token(i) for i in range(3))
    gcfg = gl.GloveConfig(
        train_pattern=f"{root}/cooc/part-*", token_dictionary=tok_path,
        work_dir=f"{root}/glove", steps_per_epoch=WIKI_STEPS, num_epochs=1,
        shuffle_buffer_size=65_536, eval_steps=2, terms=probes)
    g_res = _stage(sec, "glove_train", lambda: gl.train(
        gcfg, tracker=MemoryTracker(), device=device))
    tcfg = t2u.Txt2UrlConfig(
        txt2url_pattern=f"{root}/txt2url/part-*",
        url2url_pattern=f"{root}/url_cooc/part-*",
        token_dictionary=tok_path, title_dictionary=title_path,
        work_dir=f"{root}/txt2url_run", steps_per_epoch=WIKI_STEPS,
        num_epochs=1, shuffle_buffer=2048,
        glove_checkpoint=f"{root}/glove/checkpoints",
        eval_txt2url_pattern=f"{root}/txt2url/part-*",
        eval_every_steps=WIKI_STEPS, eval_steps=2, probe_words=probes,
        probe_sentences=" ".join(tok.token(i) for i in range(5)))
    t_res = _stage(sec, "txt2url_train", lambda: t2u.train(
        tcfg, tracker=MemoryTracker(), device=device))
    params, _, meta = load_model(os.path.join(
        tcfg.work_dir, "artifacts", f"txt2url-{WIKI_STEPS:08d}.npz"))
    rows = Vocabulary.load(tok_path).num_embeddings
    if g_res.state.step != WIKI_STEPS or t_res.state.step != WIKI_STEPS \
            or meta["valid_rows"] != {"word_embed": rows,
                                      "url_embed": len(titles)} \
            or params["url_embedding"]["embedding"].shape != (len(titles), 64) \
            or not 0 <= t_res.last_eval_metrics["eval_recall_at_k"] <= 1:
        raise AssertionError(f"wiki trainers: glove step {g_res.state.step},"
                             f" txt2url step {t_res.state.step}, {meta}, "
                             f"{t_res.last_eval_metrics}")
    per_stage = ", ".join(
        f"{k} {v:.2f} s ({WIKI_PAGES / v:.0f} pages/s)"
        for k, v in sec.items())
    log(f"wiki chain on a synthetic dump of {WIKI_PAGES} pages "
        f"({counts['articles']} articles of {counts['tokens']} tokens and "
        f"{counts['links']} links, {counts['redirects']} redirects, "
        f"{counts['namespace']} Template: pages; {os.path.getsize(xml)} "
        f"bytes): {n_pages} pages, {n_docs} documents, dictionaries of "
        f"{len(tok)} tokens and {len(titles)} titles, {n_cooc} token "
        f"co-occurrence rows, sparse documents {n_sparse}, {n_url} url "
        f"rows; GloVe {WIKI_STEPS} steps (loss "
        f"{g_res.last_train_metrics.get('train_loss', float('nan')):.5f}), "
        f"txt2url {WIKI_STEPS} steps from its checkpoint (eval recall@10 "
        f"{t_res.last_eval_metrics['eval_recall_at_k']:.4f}) to "
        f"txt2url-{WIKI_STEPS:08d}.npz [{card}]")
    log(f"wiki chain stages (host clock, pages/s of the dump's pages): "
        f"{per_stage}")
    log(f"wiki token co-occurrence of docs/part-00000 ({entries} entries): "
        f"native accumulator {t_native:.3f} s, Python {t_py:.3f} s, rows "
        f"equal; the chain used the native one")
    return {"seconds": sec, "accumulators": (t_native, t_py)}


def _t2u_vocabularies():
    """The full-width dictionaries in memory: T2U_WORDS tokens (the GloVe
    probe terms first) and T2U_URLS titles with Zipf document
    frequencies."""
    import numpy as np

    from esrecsys_tpu_torch.data.vocab import VocabEntry, Vocabulary

    probes = GLOVE_PROBES.split(",")
    tokens = probes + [f"w{i:06d}" for i in range(T2U_WORDS - len(probes))]
    words = Vocabulary([VocabEntry(token=t, frequency=T2U_WORDS - i,
                                   doc_frequency=1)
                        for i, t in enumerate(tokens)])
    df = np.minimum(np.random.default_rng(1).zipf(1.5, T2U_URLS), 10 ** 6)
    titles = Vocabulary([VocabEntry(token=f"https://en.wikipedia.org/wiki/"
                                    f"T{i:07d}", frequency=int(d),
                                    doc_frequency=int(d))
                         for i, d in enumerate(df.tolist())])
    return words, titles


def write_t2u_data(root: str, words, seed: int = 0):
    """T2U_DOCS sparse documents (3 in 10 shorter than 32 tokens, the
    rest 32-400, token ids Zipf over the word rows) and T2U_ROWS url2url
    rows, Zipf ids, written by the port's codec: their patterns."""
    import numpy as np

    from esrecsys_tpu_torch.data import recordio
    from esrecsys_tpu_torch.data.protos import (CooccurrenceRow,
                                                SparseDocument)

    rng = np.random.default_rng(seed)
    vocab_rows = words.num_embeddings - 1
    with recordio.ShardedWriter(os.path.join(root, "txt2url"),
                                records_per_shard=5000) as w:
        for i in range(T2U_DOCS):
            n = (int(rng.integers(1, 32)) if rng.random() < 0.3
                 else int(rng.integers(32, 401)))
            toks = (rng.zipf(1.1, n) - 1) % vocab_rows + 1
            w.write_proto(SparseDocument(
                primary_index=int((rng.zipf(1.2) - 1) % T2U_URLS),
                token_index=toks))
    with recordio.ShardedWriter(os.path.join(root, "url_cooc"),
                                records_per_shard=5000) as w:
        for i in range(T2U_ROWS):
            index = int((rng.zipf(1.2) - 1) % T2U_URLS)
            others = (rng.zipf(1.2, 20) - 1) % T2U_URLS
            w.write_proto(CooccurrenceRow(
                index=index, other_index=others,
                count=rng.integers(1, 6, 20).astype(np.float32)))
    return (os.path.join(root, "txt2url", "part-*.bz2"),
            os.path.join(root, "url_cooc", "part-*.bz2"))


def encoder_against_f64(card: str, model, tokens) -> float:
    """The sentence encoder on the card against the same parameters in
    float64 on the CPU (no TF32 anywhere): the largest difference."""
    import copy

    import torch

    enc = model.encoder
    with torch.no_grad():
        got = model.encode_text(tokens).double().cpu()
        t = tokens.cpu().long()
        emb = enc.word_embedding.embedding.detach().double().cpu()[t]
        if enc.encoder_type == "lstm":
            rnn = copy.deepcopy(enc.rnn).cpu().double()
            hidden = rnn(emb, (t != 0).sum(-1))
        else:
            m = (t != 0).double()[..., None]
            hidden = (emb * m).sum(-2) / m.sum(-2).clamp(min=1.0)
        want = copy.deepcopy(enc.to_url).cpu().double()(hidden)
    err = float((got - want).abs().max())
    if not err <= T2U_F64_ATOL:
        raise AssertionError(f"txt2url {enc.encoder_type} encoder on the "
                             f"card differs from float64 by {err}")
    return err


def t2u_against_plain(card: str, cfg, rows: tuple, batches,
                      objective: str, encoder: str) -> dict:
    """K_STEPS steps of one objective and encoder with the kernels
    against the same steps with their plain versions on the card, from
    one init: loss within T2U_LOSS_RTOL, at most T2U_DIFF_SHARE of the
    compared elements over 1e-6 apart."""
    import torch

    from esrecsys_tpu_torch.workloads import txt2url as t2u

    cfg = dataclasses.replace(cfg, text_objective=objective,
                              encoder_type=encoder)
    runs = []
    for plain in (False, True):
        model, state = t2u.init_state(cfg, *rows, "cuda")
        step = t2u.make_train_step(model, cfg)
        with plain_kernels() if plain else contextlib.nullcontext():
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
        runs.append((model, losses))
    (mk, lk), (mp, lp) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    word_ids = torch.unique(torch.cat([b["tokens"].reshape(-1)
                                       for b in batches]).long())
    url_ids = torch.unique(torch.cat([b[k] for b in batches for k in (
        "url_near_text", "url1", "url2")]).long())
    pk, pp = dict(mk.named_parameters()), dict(mp.named_parameters())
    over = total = 0
    worst = 0.0
    for name, a in pk.items():
        a, b = a.detach(), pp[name].detach()
        if name == "encoder.word_embedding.embedding":
            a, b = a[word_ids], b[word_ids]
        elif name == "url_embedding.embedding":
            a, b = a[url_ids], b[url_ids]
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        over += int((diff > 1e-6).sum())
        total += diff.numel()
    share = over / total
    if loss_rel > T2U_LOSS_RTOL or share > T2U_DIFF_SHARE:
        raise AssertionError(f"txt2url {objective}/{encoder}: loss rel "
                             f"{loss_rel}, share over 1e-6 {share}")
    log(f"txt2url {objective}/{encoder}, {K_STEPS} steps with the kernels "
        f"against their plain versions on the card from one init: loss max "
        f"relative diff {loss_rel:.3g} (bound {T2U_LOSS_RTOL}); over "
        f"{total} compared elements (the {word_ids.numel()} word and "
        f"{url_ids.numel()} URL rows touched, the dense parameters) max abs "
        f"diff {worst:.3g}, share over 1e-6 {share:.3g} (bound "
        f"{T2U_DIFF_SHARE}) [{card}]")
    return {"loss_rel": loss_rel, "share": share, "worst": worst}


def run_t2u_full_width(card: str, root: str) -> dict:
    """(b) txt2url at the reference's full width: 565,537 word rows and
    1,000,000 URL rows, Txt2UrlConfig's defaults (B=64, L=32, LSTM,
    RMSprop at 1e-3, margin); train() for STEPS steps from synthetic
    shards with GloVe transfer from a port checkpoint at that width, one
    eval round of T2U_EVAL_STEPS batches with recall@10 over the whole
    URL table, both probe hooks, a checkpoint restored bit for bit and the
    export; then the kernels against their plain versions (K steps under
    each objective, the row kernels at the step's ids with the pad row's
    pile-up), the encoder against float64, the step on the host clock
    with its device breakdown, and the row kernels timed at its shapes."""
    import gc

    import numpy as np
    import torch

    from esrecsys_tpu_torch.core.tracking import MemoryTracker
    from esrecsys_tpu_torch.data import pipelines
    from esrecsys_tpu_torch.train import Checkpointer
    from esrecsys_tpu_torch.train.export import load_model
    from esrecsys_tpu_torch.workloads import glove as gl
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    os.makedirs(root, exist_ok=True)
    out = {}
    t0 = time.perf_counter()
    words, titles = _t2u_vocabularies()
    t_vocab = time.perf_counter() - t0
    t0 = time.perf_counter()
    docs, pairs = write_t2u_data(root, words)
    t_data = time.perf_counter() - t0
    rows = (words.num_embeddings, len(titles))
    if rows != (565_537, 1_000_000):
        raise AssertionError(f"txt2url tables {rows}")
    # a port GloVe checkpoint at the word table's width
    _, gstate = gl.init_state(gl.GloveConfig(), rows[0], "cuda")
    glove_dir = os.path.join(root, "glove_ckpt")
    Checkpointer(glove_dir).save(1, gstate)
    glove_table = gstate.params.token_embedding.embedding.detach()[
        :rows[0]].clone()
    del gstate
    log(f"txt2url data: dictionaries of {T2U_WORDS} tokens ({rows[0]} word "
        f"rows) and {T2U_URLS} titles built in {t_vocab:.1f} s; {T2U_DOCS} "
        f"sparse documents and {T2U_ROWS} url2url rows (Zipf ids) written "
        f"by the port's codec in {t_data:.1f} s [{card}]")

    cfg = t2u.Txt2UrlConfig(
        txt2url_pattern=docs, url2url_pattern=pairs,
        work_dir=os.path.join(root, "run"), steps_per_epoch=STEPS,
        num_epochs=1, glove_checkpoint=glove_dir, eval_txt2url_pattern=docs,
        eval_every_steps=STEPS, eval_steps=T2U_EVAL_STEPS,
        probe_words="news,apple,computer",
        probe_sentences="news about apple computers|physics and math")
    tracker = MemoryTracker()
    records = _Records()
    tlog = logging.getLogger("esrecsys_tpu_torch.workloads.txt2url")
    tlog.setLevel(logging.INFO)
    tlog.addHandler(records)
    _reset_row_launches()
    try:
        t0 = time.perf_counter()
        res = t2u.train(cfg, tracker=tracker, device="cuda",
                        token_vocab=words, title_vocab=titles)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
    finally:
        tlog.removeHandler(records)
    launches = _row_launches()
    ev = res.last_eval_metrics
    probes = [m for m in records.lines if m.startswith(("word_nn step=",
                                                        "sentence_nn step="))]
    want = {"gather_pool": {"f32x4"}, "scatter_add": {"f32_d64"}}
    if res.state.step != STEPS or not ev \
            or not 0 <= ev["eval_mrr_at_k"] <= ev["eval_recall_at_k"] <= 1 \
            or not np.isfinite(ev["eval_loss"]) or len(probes) != 5 \
            or not any(m.startswith("transferred GloVe") for m in records.lines) \
            or any(set(launches[k]) != v for k, v in want.items()):
        raise AssertionError(f"txt2url train(): step {res.state.step}, eval "
                             f"{ev}, {len(probes)} probe lines, launches "
                             f"{launches}")
    model = res.state.params
    # rows no step touched keep the GloVe rows bit for bit: their RMSprop
    # update is 0 and their norms are under the 3.0 cap
    kept = float((model.encoder.word_embedding.embedding.detach()
                  == glove_table).all(-1).float().mean())
    del glove_table
    if kept < 0.9:
        raise AssertionError(f"txt2url: {kept} of the word rows hold the "
                             f"GloVe rows")
    if model.encoder.word_embedding.embedding.shape != (rows[0], 64) \
            or model.url_embedding.embedding.shape != (rows[1], 64):
        raise AssertionError("txt2url tables are padded")
    params, _, meta = load_model(os.path.join(
        cfg.work_dir, "artifacts", f"txt2url-{STEPS:08d}.npz"))
    if meta["valid_rows"] != {"word_embed": rows[0], "url_embed": rows[1]} \
            or not np.array_equal(params["url_embedding"]["embedding"],
                                  model.url_embedding.embedding.detach()
                                  .cpu().numpy()):
        raise AssertionError(f"txt2url export: {meta}")
    ck = Checkpointer(os.path.join(cfg.work_dir, "checkpoints"))
    _, fresh = t2u.init_state(dataclasses.replace(cfg, seed=1), *rows,
                              "cuda")
    restored = ck.restore(fresh)
    bad = [n for n, t in model.state_dict().items()
           if not torch.equal(t, restored.params.state_dict()[n])]
    bad += [n for n, t in res.state.opt_state["nu"].items()
            if not torch.equal(t, restored.opt_state["nu"][n])]
    if bad or restored.step != STEPS:
        raise AssertionError(f"txt2url checkpoint differs: {bad}")
    del fresh, restored
    windows = [m["train_loss"] for _, m in tracker.records
               if "train_loss" in m]
    ms = [m["ms_per_step"] for _, m in tracker.records if "ms_per_step" in m]
    log(f"txt2url train() at full width ({rows[0]} x 64 word and "
        f"{rows[1]} x 64 URL tables, B=64, L=32, LSTM, margin, RMSprop 1e-3, "
        f"{STEPS} steps, shuffle buffer {cfg.shuffle_buffer}): "
        f"{path_s:.1f} s with the GloVe transfer, one eval round of "
        f"{T2U_EVAL_STEPS} batches ({res.eval_round_s[0] * 1e3:.1f} ms: "
        f"recall@10 {ev['eval_recall_at_k']:.4f}, mrr@10 "
        f"{ev['eval_mrr_at_k']:.4f} over all {rows[1]} URLs), "
        f"{len(probes)} probe lines, {kept:.4f} of the word rows still the "
        f"GloVe checkpoint's (the rest moved), a checkpoint ({res.ckpt_save_s[0]:.2f} s"
        f", restored bit for bit) and the export; train loss {windows}; "
        f"fit's ms/step {ms} (host clock, data included); launches "
        f"{launches} [{card}]")
    log(f"txt2url probes at step {STEPS}: {probes[0][:120]} | "
        f"{probes[-1][:120]}")
    out["launches"] = launches
    out["eval"] = ev

    # the step's batches, unshuffled, on the card
    feed = pipelines.txt2url_batches(
        docs, pairs, np.asarray([titles.doc_frequency(i) for i in
                                 range(len(titles))], np.float64), 64, 32, 4)
    batches = [t2u.to_device(next(feed), torch.device("cuda"))
               for _ in range(K_STEPS)]
    batch = batches[0]
    pads = int((batch["tokens"] == 0).sum())
    # launches of one step, per table, counted by the kernels themselves
    step = t2u.make_train_step(model, cfg)
    _reset_row_launches()
    by_table = launches_by_table(lambda: (step(res.state, batch),
                                          torch.cuda.synchronize()))
    per_step = _row_launches()
    one_each = {"gather_pool": 1, "scatter_add": 1}
    if by_table != {rows[0]: one_each, rows[1]: one_each} or per_step != {
            "gather_pool": {"f32x4": 2}, "scatter_add": {"f32_d64": 2}}:
        raise AssertionError(f"txt2url step launches: by table {by_table}"
                             f", by instantiation {per_step}")
    out["per_step"] = {"word_table": by_table[rows[0]],
                       "url_table": by_table[rows[1]]}
    step_ms = host_ms(lambda: (step(res.state, batch),
                               torch.cuda.synchronize()), 10)
    wall, busy, top = device_breakdown(
        lambda: (step(res.state, batch), torch.cuda.synchronize()), 5)
    busy_txt = ("device time not measured" if busy is None else
                f"device busy {busy:.3f} ms (idle share "
                f"{1 - busy / wall:.2f}); largest: "
                + ", ".join(f"{k[:40]} {v * 1e3:.1f} us"
                            for k, v in top[:4]))
    log(f"txt2url step (LSTM, margin, B=64, L=32, {pads} of 2048 token "
        f"slots the pad id 0): {step_ms:.3f} ms on the host clock (median "
        f"of 10, one batch on the card); under the profiler {wall:.3f} ms, "
        f"{busy_txt}; launches a step {per_step}, by table "
        f"{out['per_step']} [{card}]")
    out["step_ms"], out["busy"], out["wall"] = step_ms, busy, wall
    f64 = {"lstm": encoder_against_f64(card, model, batch["tokens"])}
    mean, _ = t2u.init_state(dataclasses.replace(cfg, encoder_type="mean"),
                             *rows, "cuda")
    with torch.no_grad():
        mean.encoder.word_embedding.embedding.copy_(
            model.encoder.word_embedding.embedding)
    f64["mean"] = encoder_against_f64(card, mean, batch["tokens"])
    del mean
    log(f"txt2url encoder on the card against float64 on the CPU (the "
        f"batch's 64 x 32 tokens, trained word table): max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in f64.items())
        + f" (bound {T2U_F64_ATOL}) [{card}]")
    # the row kernels at the step's ids: the word table with the pad row's
    # pile-up, the URL table at the three lookups' 192 ids
    word_ids = batch["tokens"].reshape(-1).contiguous()
    url_ids = torch.cat([batch[k] for k in ("url_near_text", "url1",
                                            "url2")]).contiguous()
    timed, errs = {}, {}
    for name, table, ids in (
            ("word_table", model.encoder.word_embedding.embedding, word_ids),
            ("url_table", model.url_embedding.embedding, url_ids)):
        table = table.detach().clone()
        upd = torch.randn(ids.shape[0], 64, device="cuda") * 1e-3
        errs[name] = rows_against_plain(
            card, f"txt2url step ids on the {name}", table, ids, upd,
            ("f32x4", "f32_d64"))
        gather, scatter = time_row_kernels(table, ids, upd)
        timed[name] = {"gather_pool": gather, "scatter_add": scatter}
        if name == "url_table":
            small_launch_medians(card, "txt2url's URL table", table, ids,
                                 written_ms)
        log(timing_line(
            f"txt2url step shapes, {name} ({table.shape[0]} x 64 float32, "
            f"{ids.shape[0]} ids, {int(torch.unique(ids).numel())} distinct"
            f"{f', {pads} on the pad row' if name == 'word_table' else ''}),"
            f" device time per call from a cold, clean L2, write-back "
            f"included (profiler, 50 calls)", gather, scatter) + f" [{card}]")
        del table, upd
    out["timed"], out["errs"] = timed, errs
    del res, model, step
    gc.collect()
    torch.cuda.empty_cache()
    # K steps with the kernels against the plain versions, per objective
    out["vs_plain"] = {}
    for objective, encoder in (("margin", "lstm"), ("softmax", "lstm"),
                               ("reference_exact", "lstm"),
                               ("margin", "mean")):
        out["vs_plain"][f"{objective}/{encoder}"] = t2u_against_plain(
            card, cfg, rows, batches, objective, encoder)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_wiki(card: str) -> dict:
    """The Wikipedia pipeline: (a) the chain from a synthetic XML dump to
    a trained txt2url artifact, (b) txt2url at the reference's full
    width. The launch counts of both main paths are summed."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        _reset_row_launches()
        out["chain"] = run_wiki_chain(card, os.path.join(root, "chain"))
        chain_launches = _row_launches()
        log(f"wiki chain launches {chain_launches} [{card}]")
        full = run_t2u_full_width(card, os.path.join(root, "t2u"))
    out.update(full)
    launches = {k: sum(chain_launches[k].values())
                + sum(full["launches"][k].values())
                for k in ("gather_pool", "scatter_add")}
    out["launch_totals"] = launches
    return out


# ------------------------------------------------------------- stl

# the Shop-the-Look corpus: scene/product pairs of JPEGs written by the
# port's writer (the card's machine has no other), 400 px wide and
# 300-700 px tall so that both the crop and the pad to 512 run
STL_PAIRS = 512               # cut from 1,024 (depth: the corpus)
STL_WIDTH = 400
STL_HEIGHTS = (300, 701)
STL_EVAL_STEPS = 4            # eval batches of one round (cut from 16)
STL_TIMED_STEPS = 5           # steps timed per feed (cut from 10)
STL_DECODE_IMAGES = 128       # images timed through the decoder (cut from
#                               256)
STL_QUERIES = 32              # image_key queries served (and 16 texts)
STL_FUSED_BINS = 256          # 2 rows a bin over the 512 products
# the towers on the card against the same weights in float64 on the CPU,
# relative to the largest float64 output: float32 (TF32 off) sums in
# another order, 1e-6 seen on the CPU; bf16 keeps 8 bits at each of some
# 20 roundings in a row, 0.006-0.018 seen on the CPU at 512 px
STL_F32_RTOL = 1e-4
STL_BF16_RTOL = 0.05
T2U_SERVE_WORDS = 10_000      # the served txt2url model's dictionary
T2U_SERVE_URLS = 10_000
STL_TEXTS = ("red sofa", "wooden table lamp", "blue rug and chair",
             "kitchen", "a green plant by the window")


def stl_key(i: int, role: int) -> str:
    """A 32-hex-digit image key (the pinimg scheme's length)."""
    return f"{i:06x}{role:02x}" + "5" * 24


def write_stl_corpus(root: str, pairs: int = STL_PAIRS, seed: int = 0):
    """``pairs`` scene/product pairs as JPEGs by the port's writer:
    a pair shares a coloured low-frequency field (the product a brighter
    crop of the scene's palette) with fine noise; 4:2:0, 4:4:4 and
    grayscale in turn, quality 75-95, every fourth file with a restart
    interval. Returns (pairs json path, image dir, seconds, bytes)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from esrecsys_tpu_torch.data import jpeg

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(pairs):
        palette = rng.integers(0, 256, (8, 3))
        for role in (0, 1):
            specs.append((stl_key(i, role), int(rng.integers(*STL_HEIGHTS)),
                          ("4:2:0", "4:4:4", "gray")[(2 * i + role) % 3],
                          int(rng.integers(75, 96)),
                          (0, 4, 0, 0, 16, 0, 0, 0)[(2 * i + role) % 8],
                          palette, int(rng.integers(1 << 30)), role))

    # fine noise: a few tiles made once (numpy under the interpreter lock
    # would serialise the writer threads), one a file
    tiles = rng.integers(-12, 13, (8, STL_HEIGHTS[1], STL_WIDTH, 1),
                         dtype=np.int16)

    def make(spec):
        key, h, mode, quality, restart, palette, s, role = spec
        r = np.random.default_rng(s)
        pal = np.minimum(palette * (1.0 + 0.2 * role), 255).astype(np.int16)
        cells = r.integers(0, 8, (h // 32 + 2, STL_WIDTH // 32 + 2))
        field = pal[cells].repeat(32, 0).repeat(32, 1)[:h, :STL_WIDTH]
        px = np.clip(field + tiles[s % 8, :h], 0, 255).astype(np.uint8)
        if mode == "gray":
            px = px[..., 1]
        data = jpeg.encode(px, quality, "4:2:0" if mode == "gray" else mode,
                           restart)
        with open(os.path.join(img_dir, key + ".jpg"), "wb") as f:
            f.write(data)
        return len(data)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        nbytes = sum(pool.map(make, specs))
    seconds = time.perf_counter() - t0
    path = os.path.join(root, "pairs.json")
    with open(path, "w") as f:
        for i in range(pairs):
            f.write(json.dumps({"scene": stl_key(i, 0),
                                "product": stl_key(i, 1)}) + "\n")
    return path, img_dir, seconds, nbytes


def decoder_rates(card: str, paths: list, what: str) -> dict:
    """images/s of ``decode_image`` at 512 px, one thread and
    ``os.cpu_count()`` threads, over ``paths``."""
    from esrecsys_tpu_torch.data import images

    t0 = time.perf_counter()
    serial = [images.decode_image(p, 512) for p in paths]
    one = len(paths) / (time.perf_counter() - t0)
    threads = os.cpu_count() or 1
    with images.decode_pool() as pool:
        images.decode_batch(pool, paths[:16], 512)  # start the threads
        t0 = time.perf_counter()
        batch = images.decode_batch(pool, paths, 512)
        many = len(paths) / (time.perf_counter() - t0)
    import numpy as np

    if not np.array_equal(np.stack(serial), batch):
        raise AssertionError("the threaded decode differs from the serial")
    log(f"stl decoder: {one:.1f} images/s on 1 thread, {many:.1f} on "
        f"{threads} threads ({len(paths)} {what} to 512 x 512 float32, "
        f"host clock) [{card}]")
    return {"images_per_s_1": one, "images_per_s_n": many,
            "threads": threads}


def check_jpeg_fixtures(card: str) -> list:
    """Decode every committed fixture of tests/torch_fixtures/jpeg on this
    host and hold it byte for byte against its stored TensorFlow decode
    (the corpus-sized ones against the SHA-256 of it). Returns [(name,
    path)] of the fixtures; raises on any difference."""
    import hashlib

    import numpy as np

    from esrecsys_tpu_torch.data import jpeg

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_fixtures", "jpeg")
    names = sorted(f for f in os.listdir(root) if f.endswith(".jpg"))
    checked = []
    with np.load(os.path.join(root, "tf_decodes.npz")) as z:
        for name in names:
            with open(os.path.join(root, name), "rb") as f:
                got = jpeg.decode(f.read())
            key = f"sha256/{name}"
            if key in z.files:
                ok = str(z[key]) == hashlib.sha256(got.tobytes()).hexdigest()
            else:
                ok = np.array_equal(got, z[name])
            if not ok:
                raise AssertionError(f"JPEG fixture {name} decodes unlike TF")
            checked.append((name, os.path.join(root, name)))
    if len(checked) < 15:
        raise AssertionError(f"only {len(checked)} JPEG fixtures found")
    log(f"jpeg fixtures: {len(checked)} files (progressive 4:4:4, 4:2:2, "
        f"4:2:0, gray, restart markers, unrefined scans; CMYK, YCCK) "
        f"byte-equal to their stored TF decodes on this host [{card}]")
    return checked


def towers_against_f64(card: str, cfg, batch) -> dict:
    """The towers at full width on the card, float32 (TF32 off, cuDNN)
    and bf16, against the same weights in float64 on the CPU: the largest
    difference over the largest float64 output, in eval and train mode."""
    import torch

    from esrecsys_tpu_torch.models.cnn import STLModel

    g = torch.Generator(device="cuda").manual_seed(7)
    m32 = STLModel(cfg.output_size, cfg.filters, torch.float32,
                   device="cuda", generator=g)
    out = {}
    for train in (False, True):
        m16 = STLModel(cfg.output_size, cfg.filters, torch.bfloat16,
                       device="cuda")
        m64 = STLModel(cfg.output_size, cfg.filters, torch.float64,
                       device="cpu")
        m16.load_state_dict(m32.state_dict())
        m64.load_state_dict(m32.state_dict())
        m64.double()
        x = torch.from_numpy(batch)
        with torch.no_grad():
            want = m64.scene_tower(x.double(), train)
            a = m32.scene_tower(x.cuda(), train).double().cpu()
            b = m16.scene_tower(x.cuda(), train).double().cpu()
        scale = float(want.abs().max())
        r32 = float((a - want).abs().max()) / scale
        r16 = float((b - want).abs().max()) / scale
        mode = "train" if train else "eval"
        out[mode] = {"f32": r32, "bf16": r16}
        if not (r32 <= STL_F32_RTOL and r16 <= STL_BF16_RTOL):
            raise AssertionError(f"towers ({mode}) against float64: f32 "
                                 f"{r32}, bf16 {r16}")
    log(f"stl towers at {batch.shape[1]} px, filters {cfg.filters}, output "
        f"{cfg.output_size}, B={batch.shape[0]} against float64 on the CPU "
        f"(relative to the largest output): eval f32 {out['eval']['f32']:.3g}"
        f" bf16 {out['eval']['bf16']:.3g}, train f32 "
        f"{out['train']['f32']:.3g} bf16 {out['train']['bf16']:.3g} "
        f"(bounds {STL_F32_RTOL}, {STL_BF16_RTOL}) [{card}]")
    return out


def stl_step_timings(card: str, cfg, train_trips, img_dir) -> dict:
    """A fresh model's full-width step on the host clock: fed by the
    decoding pipeline, from batches decoded in advance (host arrays,
    copied each step), and from one batch on the device; the device's
    busy share and largest ops of the last (profiler)."""
    import torch

    from esrecsys_tpu_torch.data import images
    from esrecsys_tpu_torch.workloads import stl

    model, state = stl.init_state(cfg, "cuda")
    step = stl.make_train_step(model, cfg)
    feed = images.triplet_image_dataset(train_trips, img_dir, cfg.batch_size,
                                        cfg.image_size, seed=1)
    host = [next(feed) for _ in range(3)]
    for b in host:  # warm-up: cuDNN's first calls
        step(state, stl.to_device(b, torch.device("cuda")))
    torch.cuda.synchronize()

    def timed(get):
        t0 = time.perf_counter()
        for i in range(STL_TIMED_STEPS):
            step(state, get(i))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STL_TIMED_STEPS

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    decoded = [next(feed) for _ in range(STL_TIMED_STEPS)]
    decode_ms = (time.perf_counter() - t0) * 1e3 / STL_TIMED_STEPS
    fed_ms = timed(lambda i: stl.to_device(next(feed), dev))
    ahead_ms = timed(lambda i: stl.to_device(decoded[i], dev))
    on_dev = stl.to_device(decoded[0], dev)
    device_ms = timed(lambda i: on_dev)

    def one():
        step(state, on_dev)
        torch.cuda.synchronize()

    wall, busy, top = device_breakdown(one, 5)
    ops = ", ".join(f"{k[:48]} {v:.3f} ms" for k, v in top[:5])
    busy_txt = ("not measured" if busy is None else
                f"{busy:.2f} ms busy (idle share {1 - busy / wall:.2f})")
    log(f"stl step ({cfg.image_size} px, B={cfg.batch_size} triplets = "
        f"{3 * cfg.batch_size} images, bf16 towers, Adam), host clock, mean "
        f"of {STL_TIMED_STEPS}: {fed_ms:.2f} ms fed by the decoding pipeline "
        f"in the loop (decode alone {decode_ms:.2f} ms a batch), "
        f"{ahead_ms:.2f} ms from batches decoded in advance (copy "
        f"included), {device_ms:.2f} ms from a batch on the device; under "
        f"the profiler {wall:.2f} ms a step, {busy_txt}; largest: {ops} "
        f"[{card}]")
    del model, state, on_dev
    return {"fed_ms": fed_ms, "decode_ms": decode_ms, "ahead_ms": ahead_ms,
            "device_ms": device_ms, "profiled_ms": wall, "busy_ms": busy,
            "top": top[:5]}


def train_serving_txt2url(card: str, root: str):
    """A txt2url artifact for the server's text queries: full width (64,
    LSTM), a T2U_SERVE_WORDS-token dictionary and T2U_SERVE_URLS URLs,
    STEPS margin steps on synthetic batches, exported. Returns (artifact,
    dictionary path)."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.data.vocab import VocabEntry, Vocabulary
    from esrecsys_tpu_torch.train.export import export_model
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    words = sorted({w for t in STL_TEXTS for w in t.split()})
    words += [f"w{i:05d}" for i in range(T2U_SERVE_WORDS - len(words))]
    vocab = Vocabulary([VocabEntry(token=w, frequency=T2U_SERVE_WORDS - i)
                        for i, w in enumerate(words)])
    dict_path = os.path.join(root, "tokens.dict")
    vocab.save(dict_path)
    cfg = t2u.Txt2UrlConfig(work_dir=os.path.join(root, "t2u"))
    model, state = t2u.init_state(cfg, vocab.num_embeddings,
                                  T2U_SERVE_URLS, "cuda")
    step = t2u.make_train_step(model, cfg)
    rng = np.random.default_rng(3)
    B, L = cfg.batch_size, cfg.sentence_length
    for _ in range(STEPS):
        batch = {"url_near_text": rng.integers(0, T2U_SERVE_URLS, B),
                 "tokens": rng.integers(0, vocab.num_embeddings, (B, L)),
                 "url1": rng.integers(0, T2U_SERVE_URLS, B),
                 "url2": rng.integers(0, T2U_SERVE_URLS, B),
                 "sqrt_dice": rng.random(B)}
        batch = {k: v.astype(np.float32 if k == "sqrt_dice" else np.int32)
                 for k, v in batch.items()}
        state, metrics = step(state, t2u.to_device(batch,
                                                   torch.device("cuda")))
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("the serving txt2url model's loss is not "
                             "finite")
    art = export_model(cfg.work_dir, "txt2url", model, step=state.step,
                       metadata=t2u.export_metadata(
                           cfg, vocab.num_embeddings, T2U_SERVE_URLS))
    return art, dict_path


def _reset_all_launches() -> None:
    from esrecsys_tpu_torch.kernels import (fused_affinity, fused_scan,
                                            gather_pool, scatter_add,
                                            smem_scatter)

    from esrecsys_tpu_torch.kernels import fused_generic

    for counter in (fused_scan.LAUNCHES, fused_scan.LAUNCHES_INT8,
                    fused_affinity.LAUNCHES, gather_pool.LAUNCHES,
                    scatter_add.LAUNCHES, smem_scatter.LAUNCHES,
                    fused_generic.LAUNCHES_SCAN,
                    fused_generic.LAUNCHES_SCAN_INT8,
                    fused_generic.LAUNCHES_AFFINITY):
        counter.reset()


def _all_launches() -> dict:
    from esrecsys_tpu_torch.kernels import (fused_affinity, fused_scan,
                                            gather_pool, scatter_add,
                                            smem_scatter)

    return {"fused_scan": fused_scan.LAUNCHES.count,
            "fused_scan_int8": fused_scan.LAUNCHES_INT8.count,
            "fused_affinity": fused_affinity.LAUNCHES.count,
            "gather_pool": gather_pool.LAUNCHES.count,
            "scatter_add": scatter_add.LAUNCHES.count,
            "smem_scatter": smem_scatter.LAUNCHES.count, **generic_counts()}


def top10_up_to_ties(got_ids, vectors_q, product_index, what: str) -> int:
    """Each row of ``got_ids`` (catalog ids, k of them) against a float64
    brute force: every id scores at or above the float64 k-th score
    (less 1e-6 of the row's scale), no id twice. Returns the rows
    checked."""
    import numpy as np

    row = {k: i for i, k in enumerate(product_index.ids)}
    items = product_index.vectors.astype(np.float64)
    for q, ids in zip(vectors_q, got_ids):
        scores = items @ np.asarray(q, np.float64)
        k = len(ids)
        kth = np.sort(scores)[::-1][k - 1]
        got = scores[[row[i] for i in ids]]
        slack = 1e-6 * max(1.0, float(np.abs(scores).max()))
        if len(set(ids)) != k or (got < kth - slack).any():
            raise AssertionError(f"{what}: top-{k} differs from the float64 "
                                 f"brute force beyond ties")
    return len(got_ids)


def corpus_handler(directory: str):
    """An ``http.server`` handler serving ``<directory>/<key>.jpg`` at the
    CDN's path layout (``/400x/ab/cd/ef/<key>.jpg``)."""
    import http.server

    class Handler(http.server.SimpleHTTPRequestHandler):
        def translate_path(self, path):
            return os.path.join(directory, os.path.basename(path))

        def log_message(self, *args):
            pass

    return Handler


def stl_fetch_local(card: str, stl_json: str, img_dir: str, root: str,
                    pairs: int = 64) -> dict:
    """``etl/fetch_images`` over the first ``pairs`` pairs against a local
    ``http.server`` holding the corpus (the CDN URL rewritten to it): every
    file fetched once, byte-equal, a second run skipping them all."""
    import http.server

    from esrecsys_tpu_torch.data import images
    from esrecsys_tpu_torch.etl import fetch_images as fi

    sub = os.path.join(root, "fetch_pairs.json")
    with open(stl_json) as f, open(sub, "w") as g:
        for _ in range(pairs):
            g.write(f.readline())
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), corpus_handler(img_dir))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    cdn = fi.images_lib.key_to_url
    fi.images_lib.key_to_url = lambda key: cdn(key).replace(
        "http://i.pinimg.com", f"http://127.0.0.1:{port}")
    out = os.path.join(root, "fetched")
    try:
        cfg = fi.FetchConfig(stl_json=sub, image_dir=out, sleep_every=50,
                             sleep_seconds=0.0, max_retries=2,
                             backoff_seconds=0.0)
        t0 = time.perf_counter()
        first = fi.fetch_all(cfg)
        seconds = time.perf_counter() - t0
        again = fi.fetch_all(cfg)
    finally:
        fi.images_lib.key_to_url = cdn
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    keys = fi.unique_keys(sub)
    if first != {"ok": len(keys), "failed": 0} or again != first:
        raise AssertionError(f"fetch_images: {first}, then {again}")
    for key in keys:
        with open(images.key_to_filename(key, out), "rb") as a, \
                open(images.key_to_filename(key, img_dir), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"fetched {key} differs")
    log(f"stl fetch_images: {len(keys)} images from a local http.server in "
        f"{seconds:.2f} s, byte-equal, a second run skipped them all "
        f"[{card}]")
    return {"fetched": len(keys), "seconds": seconds}


def stl_subprocesses(card: str, cfg, here: str, root: str, paths) -> dict:
    """The STL CLI (``--mode index`` then ``--mode recommend``) on the
    trained artifact in a fresh work dir, and ``random_recommender`` beside
    them, each as a subprocess: the CLI's indexes equal the in-process ones
    (1e-5), and so do its pages' ids."""
    import shutil

    import numpy as np

    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex

    wd = os.path.join(root, "cli")
    shutil.copytree(os.path.join(cfg.work_dir, "artifacts"),
                    os.path.join(wd, "artifacts"))
    flags = ["--stl_json", cfg.stl_json, "--image_dir", cfg.image_dir,
             "--work_dir", wd]
    env = {**os.environ, "PYTHONPATH": here}
    took = {}
    # random_recommender needs nothing of the CLI's: it runs beside it
    html_path = os.path.join(root, "random.html")
    t_random = time.perf_counter()
    random_rec = subprocess.Popen(
        [sys.executable, "-m", "esrecsys_tpu_torch.tools.random_recommender",
         "--stl_json", cfg.stl_json, "--output_html", html_path,
         "--num_items", "20"], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        for mode in ("index", "recommend"):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "esrecsys_tpu_torch.workloads.stl",
                 "--mode", mode, *flags], cwd=here, capture_output=True,
                text=True, timeout=600, env=env)
            took[mode] = time.perf_counter() - t0
            if out.returncode != 0:
                raise AssertionError(f"stl CLI {mode} exit {out.returncode}: "
                                     f"{out.stderr[-3000:]}")
        for name in ("scene", "product"):
            a = EmbeddingIndex.load(paths[name])
            b = EmbeddingIndex.load(os.path.join(wd, f"{name}_index.npz"))
            if a.ids != b.ids or not np.allclose(a.vectors, b.vectors, rtol=0,
                                                 atol=1e-5):
                raise AssertionError(f"the CLI's {name} index differs")
        pages = os.path.join(cfg.work_dir, "recommendations")
        ours = sorted(os.listdir(pages))
        theirs = sorted(os.listdir(os.path.join(wd, "recommendations")))
        row = re.compile(r"<td>([0-9a-f]+)</td>")
        for name in ours:
            with open(os.path.join(pages, name)) as f, \
                    open(os.path.join(wd, "recommendations", name)) as g:
                if row.findall(f.read()) != row.findall(g.read()):
                    raise AssertionError(f"the CLI's page {name} differs")
        if ours != theirs:
            raise AssertionError("the CLI wrote other pages")
        out = random_rec.communicate(timeout=300)
    finally:  # the script stops every process it starts
        if random_rec.poll() is None:
            random_rec.kill()
            random_rec.wait()
    took["random_recommender"] = time.perf_counter() - t_random
    if random_rec.returncode != 0:
        raise AssertionError(f"random_recommender exit "
                             f"{random_rec.returncode}: {out[1][-3000:]}")
    with open(html_path) as f:
        rows = row.findall(f.read())
    if len(rows) != 20:
        raise AssertionError(f"random_recommender wrote {len(rows)} rows")
    log(f"stl subprocesses: CLI index {took['index']:.1f} s and recommend "
        f"{took['recommend']:.1f} s equal to the in-process run; "
        f"random_recommender beside them, {took['random_recommender']:.1f} "
        f"s to its end, 20 rows [{card}]")
    return took


def stl_serve(card: str, cfg, paths, t2u_art: str, dict_path: str) -> dict:
    """``serve(port=0)`` over the product index with both encoders, fused
    (STL_FUSED_BINS bins) and exact: image_key queries (scene keys through
    the scene tower) and text queries over HTTP, each answer equal to the
    encoder plus the service's topk, exact's equal to a float64 brute force
    up to ties, fused's overlap with exact at least QUALITY_FLOOR; latency
    of each kind through each server (host clock, median of 20)."""
    import numpy as np

    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving import encoders
    from esrecsys_tpu_torch.serving.server import serve
    from esrecsys_tpu_torch.train.export import latest_artifact

    enc = {"text": encoders.txt2url_text_encoder(t2u_art, dict_path,
                                                 device="cuda"),
           "image_key": encoders.stl_image_encoder(
               latest_artifact(cfg.work_dir, "stl"), cfg.image_dir,
               device="cuda")}
    products = EmbeddingIndex.load(paths["product"])
    scenes = EmbeddingIndex.load(paths["scene"])
    keys = scenes.ids[:STL_QUERIES]
    texts = list(STL_TEXTS) * 3 + ["sofa"]
    servers = {}
    answers = {}
    lat = {}
    try:
        for name, kw in (("fused", {"fused": True,
                                    "fused_bins": STL_FUSED_BINS}),
                         ("exact", {})):
            httpd = serve(paths["product"], port=0, max_k=10, max_batch=8,
                          encoders=enc, device="cuda", **kw)
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            servers[name] = (httpd, thread)
            url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/topk"
            answers[name] = {
                "image_key": [http_json(url, {"image_key": k, "k": 10})
                              for k in keys],
                "text": [http_json(url, {"text": t, "k": 10})
                         for t in texts]}
            svc = httpd.service
            for kind, payloads in (("image_key", keys), ("text", texts)):
                vecs = np.stack([enc[kind](p) for p in payloads])
                want, _ = svc.topk(vecs, k=10)
                got = [a["ids"] for a in answers[name][kind]]
                if got != [list(r) for r in want]:
                    raise AssertionError(f"{name} {kind}: HTTP answers "
                                         f"differ from encoder + topk")
                answers[name][kind + "_vecs"] = vecs
            for kind, body in (("image_key", {"image_key": keys[0]}),
                               ("text", {"text": texts[0]})):
                lat[(name, kind)] = host_ms(
                    lambda: http_json(url, {**body, "k": 10}), 20)
    finally:
        for httpd, thread in servers.values():
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    # the scene tower on the card against the index's (bf16) embeddings
    drift = float(np.abs(answers["exact"]["image_key_vecs"]
                         - scenes.vectors[:STL_QUERIES]).max())
    checked = 0
    for kind in ("image_key", "text"):
        checked += top10_up_to_ties(
            [a["ids"] for a in answers["exact"][kind]],
            answers["exact"][kind + "_vecs"], products, f"exact {kind}")
    # fused against exact: a fused id counts where its float64 score is at
    # or above the exact 10th, less the bf16 scan's rounding of a dot
    # product (2^-7 |q| max|v|: two bf16 factors, float32 sums); strict
    # counts no slack
    items = products.vectors.astype(np.float64)
    norm = float(np.linalg.norm(items, axis=1).max())
    row = {k: i for i, k in enumerate(products.ids)}
    hits = strict = total = 0
    for kind in ("image_key", "text"):
        for q, f, e in zip(answers["exact"][kind + "_vecs"],
                           answers["fused"][kind], answers["exact"][kind]):
            s = items @ q.astype(np.float64)
            kth = min(s[row[i]] for i in e["ids"])
            slack = 2.0 ** -7 * float(np.linalg.norm(q)) * norm
            hits += sum(s[row[i]] >= kth - slack for i in f["ids"])
            strict += sum(s[row[i]] >= kth for i in f["ids"])
            total += len(e["ids"])
    overlap, strict = hits / total, strict / total
    if overlap < QUALITY_FLOOR:
        raise AssertionError(f"fused overlap@10 {overlap} < {QUALITY_FLOOR}")
    log(f"stl serving over {len(products)} products x 64: {len(keys)} "
        f"image_key and {len(texts)} text queries over HTTP equal to encoder "
        f"+ topk; exact equal to float64 up to ties ({checked} rows); fused "
        f"(L={STL_FUSED_BINS}) overlap@10 with exact {overlap:.4f} within "
        f"the bf16 scan's rounding (floor {QUALITY_FLOOR}), {strict:.4f} "
        f"strict; the float32 scene tower against the bf16 index "
        f"embedding {drift:.3g}; latency (HTTP, median of 20): image_key "
        f"fused {lat[('fused', 'image_key')]:.2f} ms, exact "
        f"{lat[('exact', 'image_key')]:.2f} ms; text fused "
        f"{lat[('fused', 'text')]:.2f} ms, exact {lat[('exact', 'text')]:.2f}"
        f" ms [{card}]")
    return {"overlap": overlap, "strict_overlap": strict, "latency_ms": {f"{a}/{b}": v for (a, b), v
                                               in lat.items()},
            "text_vec": answers["exact"]["text_vecs"][0],
            "image_vecs": answers["exact"]["image_key_vecs"]}


def stl_kernels_against_plain(card: str, paths, t2u_art, dict_path,
                              image_vecs) -> dict:
    """The two kernels the phase launched, at its shapes, against their
    plain versions: fused_scan over the packed product index (B=8, D=64,
    L=STL_FUSED_BINS) and gather_pool at the text encoder's lookup (one
    sentence of 32 ids from the served word table). Returns the largest
    differences."""
    import torch

    from esrecsys_tpu_torch import convert
    from esrecsys_tpu_torch.data.vocab import Vocabulary, simple_tokenize
    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.retrieval.fused import pack_catalog
    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex

    products = EmbeddingIndex.load(paths["product"])
    items = torch.from_numpy(products.vectors).cuda()
    packed = pack_catalog(items, STL_FUSED_BINS)
    q = torch.from_numpy(image_vecs[:8]).cuda().to(torch.bfloat16)
    M = len(products)
    kv, ki = fs.fused_scan_cuda(q, packed, STL_FUSED_BINS, M)
    pv, pi = fs.fused_scan_plain(q, packed, STL_FUSED_BINS, M)
    scan_err, near, _ = compare_candidates(q, packed, kv, ki, pv, pi)
    model, meta = convert.txt2url_model_from_artifact(t2u_art, "cuda")
    vocab = Vocabulary.load(dict_path)
    ids = vocab.embedding_indices(simple_tokenize(" ".join(STL_TEXTS)))
    ids = (ids * 32)[:32]
    table = model.encoder.word_embedding.embedding.detach()
    tid = torch.tensor(ids, dtype=torch.int32, device="cuda")[:, None]
    got = gp.gather_pool_cuda(table, tid, False, -1)
    want = gp.gather_pool_plain(table, tid, False, -1)
    gather_err = float((got - want).abs().max())
    if gather_err != 0.0:
        raise AssertionError(f"gather_pool at the encoder's ids differs by "
                             f"{gather_err}")
    log(f"stl kernels against their plain versions: fused_scan B=8 D=64 "
        f"M={M} L={STL_FUSED_BINS} max abs err {scan_err:.3g} ({near} "
        f"near-tie id swaps); gather_pool at the text encoder's 32 ids of "
        f"the {table.shape[0]} x {table.shape[1]} word table bit-equal "
        f"[{card}]")
    return {"fused_scan": scan_err, "gather_pool": gather_err}


def phase_stl(card: str) -> dict:
    """The Shop-the-Look pipeline at the reference run's full width
    (STLConfig's defaults: 512 px, filters (16, 32, 64, 128), output 64,
    B=16 triplets, 5 negatives, Adam 1e-4, bf16 towers): a synthetic
    corpus of STL_PAIRS pairs written by the port's writer; the decoder's
    rates; the towers against float64; train() for STEPS steps with one
    eval round, a checkpoint restored bit for bit and the export; the
    step's timings by feed; both indexes from the artifact; recommend for
    100 scenes against a float64 brute force; a served txt2url model and
    serve() with both encoders, fused and exact; the CLI,
    random_recommender and fetch_images; then the phase's kernels against
    their plain versions. The launch counts are read around the main
    path (corpus to served answers)."""
    import gc

    import numpy as np
    import torch

    from esrecsys_tpu_torch.data import images
    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.train.checkpoint import Checkpointer
    from esrecsys_tpu_torch.train.export import latest_artifact
    from esrecsys_tpu_torch.workloads import stl

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    fixtures = check_jpeg_fixtures(card)
    with tempfile.TemporaryDirectory() as root:
        stl_json, img_dir, write_s, nbytes = write_stl_corpus(root)
        log(f"stl corpus: {STL_PAIRS} pairs, {2 * STL_PAIRS} JPEGs "
            f"({nbytes / 1e6:.1f} MB) written by the port's writer in "
            f"{write_s:.1f} s [{card}]")
        baseline = sorted(os.path.join(img_dir, f)
                          for f in os.listdir(img_dir))[:STL_DECODE_IMAGES]
        out["decoder"] = decoder_rates(card, baseline,
                                       "400 x 300-700 baseline JPEGs")
        prog = [p for n, p in fixtures if n.startswith("corpus_prog")]
        out["decoder_progressive"] = decoder_rates(
            card, (prog * STL_DECODE_IMAGES)[:STL_DECODE_IMAGES],
            "400 x 320-500 progressive JPEGs (the two corpus fixtures)")
        # the corpus-sized fixtures take the places of three corpus files
        for i, (name, path) in enumerate(
                (n, p) for n, p in fixtures if n.startswith("corpus_")):
            with open(path, "rb") as src, open(os.path.join(
                    img_dir, stl_key(i, i % 2) + ".jpg"), "wb") as dst:
                dst.write(src.read())
        cfg = stl.STLConfig(stl_json=stl_json, image_dir=img_dir,
                            work_dir=os.path.join(root, "wd"),
                            max_steps=STEPS, log_every_steps=10,
                            eval_every_steps=STEPS,
                            eval_steps=STL_EVAL_STEPS,
                            checkpoint_every_steps=10)
        pairs = images.valid_scene_product(
            images.load_scene_product_pairs(stl_json), img_dir)
        train_trips, _ = stl.generate_triplets(pairs, cfg.num_negatives,
                                               cfg.seed)
        batch = next(images.triplet_image_dataset(
            train_trips, img_dir, 4, cfg.image_size, shuffle=False))[0]
        out["f64"] = towers_against_f64(card, cfg, batch)

        # ---- the main path: corpus -> train -> indexes -> pages -> served
        _reset_all_launches()
        t0 = time.perf_counter()
        result = stl.train(cfg, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if result.steps_run != STEPS or not np.isfinite(
                result.last_train_metrics["train_loss"]):
            raise AssertionError(f"stl train: {result.steps_run} steps, "
                                 f"{result.last_train_metrics}")
        ev = result.last_eval_metrics
        if set(ev) != {"eval_loss", "eval_triplet_accuracy"} or not all(
                np.isfinite(v) for v in ev.values()):
            raise AssertionError(f"stl eval: {ev}")
        _, fresh = stl.init_state(dataclasses.replace(cfg, seed=5), "cuda")
        Checkpointer(os.path.join(cfg.work_dir, "checkpoints")).restore(fresh)
        mismatched = [n for (n, a), (_, b) in zip(
            result.state.params.state_dict().items(),
            fresh.params.state_dict().items()) if not torch.equal(a, b)]
        mismatched += [f"{k}/{n}" for k in ("mu", "nu")
                       for n, t in result.state.opt_state[k].items()
                       if not torch.equal(t, fresh.opt_state[k][n])]
        if mismatched or fresh.step != STEPS:
            raise AssertionError(f"stl checkpoint restore differs: "
                                 f"{mismatched[:5]}")
        del fresh
        artifact = latest_artifact(cfg.work_dir, "stl")
        if not artifact or not artifact.endswith(f"stl-{STEPS:08d}.npz"):
            raise AssertionError(f"stl export: {artifact}")
        t0 = time.perf_counter()
        paths = stl.build_catalog_indexes(cfg, device="cuda")
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pages_dir = stl.recommend(cfg, device="cuda")
        recommend_s = time.perf_counter() - t0
        t2u_art, dict_path = train_serving_txt2url(card, root)
        served = stl_serve(card, cfg, paths, t2u_art, dict_path)
        torch.cuda.synchronize()
        out["launches"] = _all_launches()
        log(f"stl main path launches {out['launches']} [{card}]")
        for name in ("fused_scan", "gather_pool"):
            if out["launches"][name] <= 0:
                raise AssertionError(f"the stl path never launched {name}")

        # ---- what came out
        scenes = EmbeddingIndex.load(paths["scene"])
        products = EmbeddingIndex.load(paths["product"])
        if len(scenes) != STL_PAIRS or len(products) != STL_PAIRS or \
                scenes.vectors.shape[1] != 64 or \
                not np.isfinite(scenes.vectors).all() or \
                not np.isfinite(products.vectors).all():
            raise AssertionError("stl indexes: wrong size or not finite")
        row = re.compile(r"<td>([0-9a-f]+)</td>")
        pages = sorted(os.listdir(pages_dir))
        got = []
        for name in pages:
            with open(os.path.join(pages_dir, name)) as f:
                got.append(row.findall(f.read()))
        if len(pages) != min(cfg.max_results, len(scenes)) or any(
                len(g) != cfg.top_k for g in got):
            raise AssertionError(f"stl pages: {len(pages)}")
        checked = top10_up_to_ties(got, scenes.vectors[:cfg.max_results],
                                   products, "recommend")
        log(f"stl train: {STEPS} steps at {cfg.image_size} px, filters "
            f"{cfg.filters}, "
            f"output {cfg.output_size}, B={cfg.batch_size} triplets, bf16, "
            f"in {train_s:.1f} s (first step {result.first_dispatch_s:.2f} "
            f"s); fit's window {result.last_train_metrics} ; eval "
            f"({STL_EVAL_STEPS} batches) {ev}; checkpoint restored bit for "
            f"bit; exported [{card}]")
        log(f"stl index: {2 * STL_PAIRS} images embedded in {index_s:.2f} s "
            f"({2 * STL_PAIRS / index_s:.1f} images/s, decode included); "
            f"recommend: {len(pages)} scenes' top-{cfg.top_k} pages in "
            f"{recommend_s:.2f} s, equal to a float64 brute force up to ties "
            f"({checked} rows) [{card}]")
        out.update(train_s=train_s, index_s=index_s,
                   recommend_s=recommend_s, serve=served,
                   fit_window=result.last_train_metrics)
        out["timings"] = stl_step_timings(card, cfg, train_trips, img_dir)
        out["subprocesses"] = stl_subprocesses(card, cfg, here, root, paths)
        out["fetch"] = stl_fetch_local(card, stl_json, img_dir, root)
        out["errs"] = stl_kernels_against_plain(
            card, paths, t2u_art, dict_path, served["image_vecs"])
    gc.collect()
    torch.cuda.empty_cache()
    return out


def trajectory_diffs(a, b) -> dict:
    """{tensor: (max abs diff, share of elements off by more than 1e-6)}
    of two playlist train states' tables and momentum buffers."""
    out = {}
    for t in ("album", "artist"):
        for name, x, y in (
                (f"{t} table", getattr(a.params, f"{t}_embed").embedding,
                 getattr(b.params, f"{t}_embed").embedding),
                (f"{t} momentum", a.opt_state[t]["momentum"],
                 b.opt_state[t]["momentum"])):
            d = (x.detach() - y.detach()).abs()
            out[name] = (float(d.max()), float((d > 1e-6).float().mean()))
    return out


def mesh_first_step(cfg, corpus, batch, model_u, state_u, model_s, state_s,
                    mesh) -> bool:
    """One step's inputs to the scatter from one state, through the
    unsharded and the sharded code: the gathered rows, the row gradients,
    the ids and the updates each rank applies. Raises unless each is
    bit-equal (the scatter that follows sums duplicates with atomics, in
    an order no run repeats)."""
    import torch

    from esrecsys_tpu_torch.ops.lookup import gather_rows
    from esrecsys_tpu_torch.ops.optim import shard_updates
    from esrecsys_tpu_torch.workloads import playlist as pl

    for_step = pl._step_generator(torch.device("cuda", 0), cfg.seed)
    _, na, nr = pl._negatives(cfg, corpus, for_step, 0,
                              batch["track_context"].shape[0], None)
    ids = pl._step_ids(cfg, batch, na, nr)
    tables_u = (state_u.params.album_embed.embedding,
                state_u.params.artist_embed.embedding)
    tables_s = (state_s.params.album_embed.embedding,
                state_s.params.artist_embed.embedding)
    with torch.no_grad():
        rows_u = [gather_rows(t, i) for t, i in zip(tables_u, ids)]
        rows_s = [mesh.sum_model(pl._owner_rows(
            t, state_s.opt_state[name], i, mesh, cfg, 0))
            for t, i, name in zip(tables_s, ids, ("album", "artist"))]
    for a, b in zip(rows_u, rows_s):
        if not torch.equal(a, b):
            raise AssertionError("sharded rows differ from unsharded rows")
    g_u = pl._row_grads(model_u, cfg, batch, *rows_u, na, nr)
    g_s = pl._row_grads(model_s, cfg, batch, *rows_s, na, nr)
    for a, b in zip(g_u[:2], g_s[:2]):
        if not torch.equal(a, b):
            raise AssertionError("sharded row gradients differ")
    for t, i, g in zip(tables_s, ids, g_s[:2]):
        li, lg = shard_updates(t, i, g, mesh)
        if not (torch.equal(li, i) and torch.equal(lg, g)):
            raise AssertionError("the sharded updates differ")
    return True


MESH_STEPS = 20               # sharded steps against unsharded ones
MESH_PROFILED = 5             # sharded steps under torch.profiler
MESH_SERVE_MODES = (          # the catalog-sharded serving modes
    ("exact", {}), ("int8", {"quantized": True}),
    ("int8+r8", {"quantized": True, "rescore_int8": True}),
    ("fused:bins=4096", {"fused": True, "fused_bins": 4096}))
MESH_WORKLOAD_STEPS = 5       # GloVe, txt2url and STL steps on the mesh
MESH_SHARDS = 4               # the shard count of the kernels' shard shapes


def counted(fn, total: dict):
    """``fn()``, its kernel launches added into ``total`` (the counts set
    to 0 just before it and read just after)."""
    import torch

    _reset_all_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in _all_launches().items():
        total[k] = total.get(k, 0) + v
    return out


def timed_steps(step, state, batches, launches: dict) -> tuple:
    """Each batch through ``step`` from ``state``, the kernels' launches
    added into ``launches``: (the losses as floats, host ms a step over
    every step but the first, which builds the kernels and, on a mesh,
    sets up NCCL's communicators)."""
    import torch

    losses = []

    def run():
        for i, b in enumerate(batches):
            losses.append(float(step(state, b)[1]["loss"]))
            if i == 0:
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)

    return losses, counted(run, launches)


def top_against_plain(items, queries, got, valid: int, what: str) -> bool:
    """A sharded top-k ``got`` (scores, rows) over the table ``items``
    against the plain top-k of the same table (``queries @ items.T`` over
    its first ``valid`` rows), ``equal_up_to_ties``. Raises on a
    difference; returns whether the ids are equal outright."""
    import torch

    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else t

    scores, rows = host(got[0]), host(got[1])
    with torch.no_grad():
        top, idx = torch.topk(queries @ items[:valid].T, rows.shape[-1])
    equal_up_to_ties(items, host(queries), (rows, scores),
                     (idx.cpu().numpy(), top.cpu().numpy()), what)
    return bool((rows == idx.cpu().numpy()).all())


def mesh_serving(card: str, index, queries) -> dict:
    """The trained catalog served catalog-sharded on the one-rank mesh in
    the four modes, each against the unsharded service of the same mode:
    ids and scores equal (one shard scans the catalog as the unsharded
    service does, and the exchange of one rank keeps its order); host ms
    per B=8 call of each."""
    import numpy as np

    from esrecsys_tpu_torch.serving.server import RetrievalService

    q = queries[:8]
    out, launches = {}, {}
    for name, kw in MESH_SERVE_MODES:
        plain = RetrievalService(index, max_k=500, max_batch=8,
                                 device="cuda", **kw)
        want = plain.topk(q, k=500)
        plain_ms = host_ms(lambda: plain.topk(q, k=500), 20)
        del plain
        svc = counted(lambda: RetrievalService(
            index, max_k=500, max_batch=8, n_model_shards=1, device="cuda",
            **kw), launches)
        got = counted(lambda: svc.topk(q, k=500), launches)
        ms = counted(lambda: host_ms(lambda: svc.topk(q, k=500), 20),
                     launches)
        mode, per_item = svc.mode, svc.resident_bytes_per_item
        svc.stop_shards()
        del svc
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"sharded {name} differs from the "
                                 f"unsharded service")
        out[name] = {"ms": ms, "unsharded_ms": plain_ms}
        log(f"mesh serving {mode} (one NCCL rank) over {len(index)} x "
            f"{index.vectors.shape[1]}, B=8, k=500: ids and scores equal "
            f"to the unsharded service; {ms:.3f} ms a call against "
            f"{plain_ms:.3f} unsharded (host clock, median of 20), "
            f"{per_item} B/item [{card}]")
    out["launches"] = launches
    return out


def diff_share(a, b, rows=None):
    """(max abs diff, share of elements over 1e-6) of two tensors, over
    ``rows`` only when given."""
    a, b = a.detach(), b.detach()
    if rows is not None:
        a, b = a[rows], b[rows]
    d = (a.float() - b.float()).abs()
    return float(d.max()), float((d > 1e-6).double().mean())


def mesh_glove(card: str, mesh) -> dict:
    """GloVe at its full width (565,632 x 64, B=2048) under both
    optimizers: MESH_WORKLOAD_STEPS sharded steps on the one-rank mesh
    against as many unsharded steps from one init, held as the glove
    phase holds the kernels against their plain versions (the scatter's
    atomics sum duplicate rows in a run-dependent order)."""
    import numpy as np

    import torch

    from esrecsys_tpu_torch.workloads import glove as gl

    rows = GLOVE_VOCAB + 65_537
    gen = np.random.default_rng(41)
    dev = torch.device("cuda", 0)
    batches = []
    for _ in range(MESH_WORKLOAD_STEPS):
        t = gen.zipf(1.3, (2, 2048)) % (rows - 1) + 1
        count = gen.integers(1, 300, 2048).astype(np.float32)
        batches.append(gl.to_device(((t[0].astype(np.int32),
                                      t[1].astype(np.int32)), count), dev))
    touched = torch.unique(torch.cat([x for (pair, _) in batches
                                      for x in pair]).long())
    out, launches = {}, {}
    for opt in ("adam", "lazy_adam"):
        cfg = gl.GloveConfig(optimizer=opt)
        runs = []
        for m in (None, mesh):
            model, state = gl.init_state(cfg, rows, "cuda", mesh=m)
            runs.append((state, *timed_steps(
                gl.select_train_step(model, cfg), state, batches,
                launches if m is not None else {})))
        (su, lu, ms_u), (ss, ls, ms_s) = runs
        rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lu))
        diffs = {n: diff_share(getattr(ss.params, n).embedding,
                               getattr(su.params, n).embedding, touched)
                 for n in gl.TABLES}
        if rel > GLOVE_LOSS_RTOL or any(v[1] > GLOVE_DIFF_SHARE
                                        for v in diffs.values()):
            raise AssertionError(f"glove {opt} on the mesh: loss rel {rel}, "
                                 f"diffs {diffs}")
        probe = torch.tensor([1, 2, 3], device=dev)
        table = ss.params.token_embedding.embedding
        knn_equal = top_against_plain(
            table, table[probe], gl.knn(ss, probe, 10, valid_rows=rows),
            rows, f"glove {opt}: the sharded knn")
        out[opt] = {"ms": ms_s, "unsharded_ms": ms_u, "loss_rel": rel}
        log(f"mesh glove {opt} (565,632 x 64, B=2048, one NCCL rank): "
            f"{MESH_WORKLOAD_STEPS} sharded steps against unsharded from "
            f"one init: loss max rel {rel:.3g} (bound {GLOVE_LOSS_RTOL}); "
            + ", ".join(f"{k} max abs diff {v[0]:.3g}, share over 1e-6 "
                        f"{v[1]:.3g}" for k, v in diffs.items())
            + f" over the {touched.numel()} touched rows (bound "
            f"{GLOVE_DIFF_SHARE}); the sharded knn against the plain top-10 "
            f"of its table: equal up to tied scores (ids equal outright "
            f"{knn_equal}); host {ms_s:.3f} ms a step sharded, {ms_u:.3f} "
            f"unsharded, first step left out [{card}]")
    return {"runs": out, "launches": launches,
            "ids": torch.cat(batches[0][0]).to(torch.int32)}


def mesh_txt2url(card: str, mesh) -> dict:
    """txt2url at the reference's width (565,537 word and 1,000,000 URL
    rows, B=64, L=32, LSTM, margin): MESH_WORKLOAD_STEPS sharded steps on
    the one-rank mesh against unsharded ones from one init (the bounds of
    the wiki phase's kernel-against-plain checks), and the sharded
    recall@10 top-k over all URLs against the unsharded one."""
    import numpy as np

    import torch

    from esrecsys_tpu_torch.workloads import txt2url as t2u

    words, urls = GLOVE_VOCAB + 65_537, 1_000_000
    cfg = t2u.Txt2UrlConfig()
    gen = np.random.default_rng(43)
    dev = torch.device("cuda", 0)
    batches = []
    for _ in range(MESH_WORKLOAD_STEPS):
        tok = (gen.zipf(1.2, (64, 32)) % (words - 1) + 1).astype(np.int32)
        lengths = gen.integers(1, 33, 64)
        tok[np.arange(32)[None, :] >= lengths[:, None]] = 0
        batches.append(t2u.to_device({
            "url_near_text": gen.integers(0, urls, 64).astype(np.int32),
            "tokens": tok,
            "url1": gen.integers(0, urls, 64).astype(np.int32),
            "url2": gen.integers(0, urls, 64).astype(np.int32),
            "sqrt_dice": gen.random(64).astype(np.float32)}, dev))
    runs, launches = [], {}
    for m in (None, mesh):
        model, state = t2u.init_state(cfg, words, urls, "cuda", mesh=m)
        runs.append((model, *timed_steps(t2u.make_train_step(model, cfg),
                                         state, batches,
                                         launches if m is not None else {})))
    (mu, lu, ms_u), (ms_, ls, ms_s) = runs
    rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lu))
    pu, ps = dict(mu.named_parameters()), dict(ms_.named_parameters())
    over = total = 0
    worst = 0.0
    for name, a in pu.items():
        d, share = diff_share(ps[name], a)
        worst = max(worst, d)
        over += share * a.numel()
        total += a.numel()
    share = over / total
    if rel > T2U_LOSS_RTOL or share > T2U_DIFF_SHARE:
        raise AssertionError(f"txt2url on the mesh: loss rel {rel}, share "
                             f"{share}")
    with torch.no_grad():
        enc = ms_.encoder(batches[0]["tokens"])
        ids_equal = top_against_plain(
            ms_.url_embedding.embedding, enc,
            t2u.top_rows(ms_.url_embedding, enc, 10),
            ms_.url_embedding.num_embeddings,
            "txt2url: the sharded top-10 over all URLs")
    log(f"mesh txt2url (565,537 and 1,000,000 x 64, B=64, LSTM, one NCCL "
        f"rank): {MESH_WORKLOAD_STEPS} sharded steps against unsharded "
        f"from one init: loss max rel {rel:.3g} (bound {T2U_LOSS_RTOL}); "
        f"max abs diff {worst:.3g}, share over 1e-6 {share:.3g} (bound "
        f"{T2U_DIFF_SHARE}); the sharded top-10 over all URLs against the "
        f"plain top-10 of its table: equal up to tied scores (ids equal "
        f"outright {ids_equal}); host {ms_s:.3f} ms a step sharded, "
        f"{ms_u:.3f} unsharded, first step left out [{card}]")
    return {"ms": ms_s, "unsharded_ms": ms_u, "loss_rel": rel,
            "launches": launches}


def mesh_stl(card: str) -> dict:
    """STL at STLConfig's width (512 px, B=16 triplets, bf16 towers) for
    MESH_WORKLOAD_STEPS steps on a one-rank data mesh against as many
    unsharded steps from one init: bit-equal (each collective of one rank
    is the identity), cuDNN held to deterministic algorithms for the
    comparison."""
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.workloads import stl

    cfg = stl.STLConfig()
    gen = torch.Generator(device="cuda").manual_seed(47)
    batches = [tuple(torch.randn((16, 512, 512, 3), generator=gen,
                                 device="cuda") * 0.3 for _ in range(3))
               for _ in range(MESH_WORKLOAD_STEPS)]
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        mesh = mesh_lib.make_mesh_for_batch(cfg.batch_size)
        runs, launches = [], {}
        for m in (None, mesh):
            model, state = stl.init_state(cfg, "cuda", mesh=m)
            runs.append((state, *timed_steps(
                stl.make_train_step(model, cfg), state, batches,
                launches if m is not None else {})))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    (su, lu, ms_u), (ss, ls, ms_s) = runs
    bad = [k for k, v in su.params.state_dict().items()
           if not torch.equal(v, ss.params.state_dict()[k])]
    bad += [f"{k}/{n}" for k in ("mu", "nu")
            for n, v in su.opt_state[k].items()
            if not torch.equal(v, ss.opt_state[k][n])]
    if bad or lu != ls:
        raise AssertionError(f"stl on a one-rank data mesh differs: {bad}")
    log(f"mesh stl (512 px, B=16, bf16, one NCCL rank, data mesh "
        f"{mesh.n_data}x{mesh.n_model}): {MESH_WORKLOAD_STEPS} steps "
        f"bit-equal to the unsharded steps (params, BatchNorm statistics, "
        f"Adam moments, losses); host {ms_s:.1f} ms a step sharded, "
        f"{ms_u:.1f} unsharded (deterministic cuDNN), first step left "
        f"out [{card}]")
    return {"ms": ms_s, "unsharded_ms": ms_u, "launches": launches}


def mesh_dense_playlist(card: str, mesh, run, corpus, batches) -> dict:
    """The playlist's dense autograd step at the flagship's width on the
    one-rank mesh: MESH_STEPS sharded steps against as many unsharded
    ones from one init, held to the train phase's bounds."""
    import torch

    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.workloads import playlist as pl

    cfg = dataclasses.replace(fsr.flagship_cfg(run), sparse_updates=False)
    runs, launches = [], {}
    for m in (None, mesh):
        model, state = pl.init_state(cfg, "cuda", mesh=m)
        runs.append((state, *timed_steps(
            pl.select_train_step(model, cfg, corpus, cfg.seed, mesh=m),
            state, batches[:MESH_STEPS], launches if m is not None else {})))
    (su, lu, ms_u), (ss, ls, ms_s) = runs
    diffs = {}
    for name in ("album_embed", "artist_embed"):
        pu = getattr(su.params, name).embedding
        ps = getattr(ss.params, name).embedding
        diffs[f"{name} table"] = diff_share(ps, pu)
        diffs[f"{name} momentum"] = diff_share(
            ss.opt_state.state[ps]["momentum_buffer"],
            su.opt_state.state[pu]["momentum_buffer"])
    for name, (d, share) in diffs.items():
        atol = TRAIN_TABLE_ATOL if "table" in name else TRAIN_MOMENTUM_ATOL
        if d > atol or share > TRAIN_DIFF_SHARE:
            raise AssertionError(f"dense step on the mesh: {name} {d} "
                                 f"{share}")
    ls, lu = torch.tensor(ls), torch.tensor(lu)
    rel = float(((ls - lu).abs() / lu.abs()).max())
    if not torch.isfinite(ls).all() or rel > 1e-5:
        raise AssertionError(f"dense step losses {ls} against {lu}")
    log(f"mesh dense step (the flagship's width, B=2048, SGD momentum "
        f"0.98, one NCCL rank): {MESH_STEPS} sharded steps against "
        f"unsharded from one init: loss max rel {rel:.3g}; "
        + ", ".join(f"{k} {v[0]:.3g} ({v[1]:.2e})" for k, v in diffs.items())
        + f"; host {ms_s:.3f} ms a step sharded, {ms_u:.3f} unsharded, "
        f"first step left out [{card}]")
    return {"ms": ms_s, "unsharded_ms": ms_u, "diffs": diffs,
            "launches": launches}


def shard_rows_against_plain(card: str, what: str, table, ids, upd):
    """The row kernels at a shard's shape and a step's local ids (-1 where
    another shard owns the row) against their plain versions: the gather
    bit-equal, the scatter-add bit-equal on rows hit once, each row hit
    more within its own float32 pile-up bound or TOL, whichever is
    larger, and no row outside the ids touched; then their device times
    at the shard's owned ids (the library calls take no -1) with the L2
    flushed. Returns (errs, times)."""
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa

    ids2 = ids[:, None].contiguous()
    gk = gp.gather_pool_cuda(table, ids2, False, -1)
    gplain = gp.gather_pool_plain(table, ids2, False, -1)
    k, p = table.clone(), table.clone()
    sa.scatter_add_cuda(k, ids, upd)
    sa.scatter_add_plain(p, ids, upd)
    torch.cuda.synchronize()
    if not torch.equal(gk, gplain):
        raise AssertionError(f"{what}: gather_pool differs")
    own = ids >= 0
    hits = torch.bincount(ids[own].long(), minlength=table.shape[0])
    hit = hits > 0
    if not torch.equal(k[~hit], table[~hit]):
        raise AssertionError(f"{what}: scatter_add changed rows no id "
                             f"touches")
    # a row hit once is one rounding in both: bit-equal. A row hit n
    # times sums its n updates in the order the atomics take, so its
    # elements may part from the plain sum by up to the float32 bound of
    # the script's other pile-ups (the k-means sums), 8 sqrt(n) eps
    # (|t| + sum |u|), row by row; below that bound TOL holds, as before
    once = hits == 1
    if not torch.equal(k[once], p[once]):
        raise AssertionError(f"{what}: scatter_add differs on a row hit "
                             f"once")
    abs_sum = sa.scatter_add_plain(table.abs(), ids, upd.abs())
    pile = (8 * hits.float().sqrt()[:, None]
            * torch.finfo(torch.float32).eps * abs_sum)
    bound = torch.maximum(pile, TOL + TOL * p.abs())
    diff = (k - p).abs()
    if bool((diff > bound).any()):
        at = int((diff - bound).argmax()) // table.shape[1]
        raise AssertionError(
            f"{what}: scatter_add row {at} (hit {int(hits[at])} times) "
            f"differs by {float(diff[at].max())}, its bound "
            f"{float(bound[at].min())}")
    s_err = float(diff.max())
    del k, p
    # device time with the L2 flushed before each call (cold_ms): at a
    # few hundred ids written_ms's write-back lag is within its noise
    g_calls, s_calls, g_bound, s_bound = row_kernel_calls(
        table, ids[own].contiguous(), upd[own].contiguous())
    gather = tuple(map(cold_ms, g_calls)) + (g_bound,)
    scatter = tuple(map(cold_ms, s_calls)) + (s_bound,)
    if "URL" in what:
        small_launch_medians(card, what, table, ids[own].contiguous(),
                             cold_ms)
    log(f"{what} ({tuple(table.shape)} shard, {ids.shape[0]} local ids, "
        f"{int((~own).sum())} of them -1): gather_pool bit-equal to plain, "
        f"scatter_add max_abs_err {s_err:.3g}; "
        + timing_line("at the owned ids", gather, scatter) + f" [{card}]")
    return {"gather_pool": 0.0, "scatter_add": s_err}, {
        "gather_pool": gather, "scatter_add": scatter}


def mesh_shard_kernels(card: str, index, glove_ids) -> dict:
    """The three kernels of the path at their shard shapes against their
    plain versions: fused_scan on the (64, rps) slices of the trained
    catalog cut into MESH_SHARDS shards at L=4096 (the first, and the
    last with its valid bound), gather_pool and scatter_add on shard 0 of
    GloVe's table cut in two (the GloVe check's ids, made local) and of
    txt2url's 1,000,000-row URL table cut in two (192 ids)."""
    import numpy as np

    import torch

    from esrecsys_tpu_torch.kernels.fused_scan import (fused_scan_cuda,
                                                       fused_scan_plain)
    from esrecsys_tpu_torch.retrieval.fused import pack_catalog

    L, B = 4096, 8
    n = len(index)
    padded = -(-n // (MESH_SHARDS * L)) * MESH_SHARDS * L
    rps = padded // MESH_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(53)
    D = index.vectors.shape[1]
    q = torch.randn(B, D, generator=gen, device="cuda").to(torch.bfloat16)
    errs, out = {"fused_scan": 0.0}, {}
    for j in (0, MESH_SHARDS - 1):
        rows = np.zeros((rps, D), np.float32)
        part = index.vectors[j * rps:min((j + 1) * rps, n)]
        rows[:part.shape[0]] = part
        packed = pack_catalog(torch.from_numpy(rows).to("cuda"), L)
        bound = max(0, min(n - j * rps, rps))
        kv, ki = fused_scan_cuda(q, packed, L, bound)
        pv, pi = fused_scan_plain(q, packed, L, bound)
        torch.cuda.synchronize()
        err, ties, _ = compare_candidates(q, packed, kv, ki, pv, pi)
        errs["fused_scan"] = max(errs["fused_scan"], err)
        if j == 0:
            ms = cuda_ms(lambda: fused_scan_cuda(q, packed, L, bound), 50)
            plain_ms = cuda_ms(lambda: fused_scan_plain(q, packed, L, bound),
                               3, warmup=1)
            nbytes = D * rps * 2 + B * D * 2 + B * 2 * L * 8
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            out["fused_scan"] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": "bytes",
                                 "library_ms": None}
        log(f"kernel fused_scan at shard {j} of {MESH_SHARDS} ((64, {rps}) "
            f"slice, L={L}, B={B}, valid bound {bound}): ok, max_abs_err "
            f"{err:.3g}, near-tie id slots {ties}" + (
                f"; {ms:.4f} ms (plain {plain_ms:.3f}, byte bound "
                f"{bound_ms:.4f}) [{card}]" if j == 0 else f" [{card}]"))
        del packed
    for name, rows, ids in (
            ("glove shard", GLOVE_VOCAB + 65_537 + 95, glove_ids),
            ("txt2url URL shard", 1_000_000, torch.randint(
                0, 1_000_000, (192,), generator=gen, device="cuda"))):
        per = rows // 2
        table = torch.randn((per, 64), generator=gen, device="cuda")
        local = torch.where(ids < per, ids, -1).to(torch.int32)
        upd = torch.randn((local.shape[0], 64), generator=gen,
                          device="cuda")
        e, t = shard_rows_against_plain(card, f"mesh {name}", table, local,
                                        upd)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        out[name] = t
        del table
    return {"errs": errs, "timed": out, "rps": rps}


def phase_mesh(card: str, serve_ctx: dict) -> dict:
    """The port's sharded code on a 1x1 mesh of one NCCL rank at full
    width: the playlist's sparse step (one step's scatter inputs bit for
    bit, 20 sharded steps against 20 unsharded ones, and two unsharded
    runs against each other), the sharded eval against the exact one,
    their host times, and the collectives' share of the sharded step's
    device time; then the trained catalog served sharded in four modes,
    GloVe and txt2url 5 steps each, STL 5 steps on a data mesh, the dense
    playlist step 20 steps, each against its unsharded twin; then the
    path's three kernels at their shard shapes against their plain
    versions. The launch counts are read around each main-path run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.tools import full_scale_run as fsr
    from esrecsys_tpu_torch.workloads import playlist as pl

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = fsr.TrainRunConfig(out_dir="", steps=MESH_STEPS, batch_size=2048,
                             max_next=32, eval_every=MESH_STEPS,
                             eval_playlists=2048, eval_fused_bins=0,
                             device="cuda")
    cfg = fsr.flagship_cfg(run)
    corpus = {k: torch.from_numpy(v).to(dev)
              for k, v in fsr.synth_corpus(run).items()}
    rng = np.random.default_rng(31)
    batches = [pl.to_device(fsr.host_batch(rng, 2048, 5, 32, run), dev)
               for _ in range(MESH_STEPS + MESH_PROFILED)]
    eval_batch = pl.to_device(fsr.host_batch(rng, 2048, 5, 32, run), dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=1, rank=0)
        try:
            mesh = mesh_lib.make_mesh(n_model=cfg.n_model_shards)
            if mesh.shape != {"data": 1, "model": 1} or \
                    mesh.model_group is None:
                raise AssertionError(f"mesh {mesh.shape} without groups")
            model_u, state_u = pl.init_state(cfg, dev)
            model_s, state_s = pl.init_state(cfg, dev, mesh=mesh)
            bad = bit_equal_states(state_u, state_s)
            if bad:
                raise AssertionError(f"sharded init differs: {bad}")
            out["first_step"] = mesh_first_step(cfg, corpus, batches[0],
                                                model_u, state_u, model_s,
                                                state_s, mesh)
            log(f"mesh step 1 from one state: the sharded step's rows "
                f"(owner gathers summed over the model group), row "
                f"gradients, local ids and the data group's gathered "
                f"updates bit-equal to the unsharded step's [{card}]")
            step_u = pl.make_sparse_train_step(model_u, cfg, corpus,
                                               cfg.seed)
            step_s = pl.make_sharded_train_step(model_s, cfg, corpus, mesh,
                                                cfg.seed)

            def steps(step, state):
                losses = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches[:MESH_STEPS]:
                    state, m = step(state, b)
                    losses.append(m["loss"])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / MESH_STEPS
                return torch.stack(losses), ms

            loss_u, ms_u = steps(step_u, state_u)
            # a second unsharded run: the scatter's atomics sum duplicate
            # rows in a run-dependent order, so this spread is the floor
            _, state_2 = pl.init_state(cfg, dev)
            loss_2, _ = steps(pl.make_sparse_train_step(
                state_2.params, cfg, corpus, cfg.seed), state_2)
            _reset_all_launches()
            loss_s, ms_s = steps(step_s, state_s)
            torch.cuda.synchronize()
            step_launches = _all_launches()
            for name in ("gather_pool", "scatter_add"):
                if step_launches[name] <= 0:
                    raise AssertionError(f"the sharded steps never "
                                         f"launched {name}")
            spread = trajectory_diffs(state_u, state_2)
            diffs = trajectory_diffs(state_u, state_s)
            for name, (d, share) in diffs.items():
                atol = (TRAIN_TABLE_ATOL if "table" in name
                        else TRAIN_MOMENTUM_ATOL)
                if d > atol or share > TRAIN_DIFF_SHARE:
                    raise AssertionError(
                        f"{MESH_STEPS} sharded steps against unsharded: "
                        f"{name} max diff {d}, share over 1e-6 {share}")
            rel = float(((loss_s - loss_u).abs() / loss_u.abs()).max())
            if not torch.isfinite(loss_s).all() or rel > 1e-5:
                raise AssertionError(f"sharded losses {loss_s.tolist()} "
                                     f"against {loss_u.tolist()}")
            exact = {k: v[0] == 0.0 for k, v in diffs.items()}
            log(f"mesh steps: {MESH_STEPS} sharded steps on a 1x1 NCCL mesh "
                f"at the flagship's width (B=2048, C=5, M=32, 512 shared "
                f"negatives, dense carrier, bf16 scoring) against "
                f"{MESH_STEPS} unsharded from one init: losses bit-equal "
                f"{bool(torch.equal(loss_s, loss_u))} (max rel "
                f"{rel:.2e}); max diff (share > 1e-6) "
                + ", ".join(f"{k} {v[0]:.3g} ({v[1]:.2e})"
                            for k, v in diffs.items())
                + f"; bit-equal {exact}; two unsharded runs "
                + ", ".join(f"{k} {v[0]:.3g} ({v[1]:.2e})"
                            for k, v in spread.items())
                + f", losses bit-equal {bool(torch.equal(loss_2, loss_u))};"
                f" host {ms_s:.3f} ms/step sharded, {ms_u:.3f} unsharded; "
                f"launches {step_launches} [{card}]")
            out.update(step_ms=ms_s, unsharded_step_ms=ms_u, diffs=diffs,
                       spread=spread)
            del state_2

            # ---- the sharded eval against the exact one
            exact = pl.make_eval_topk(model_u, cfg, corpus)
            aux_u = pl.make_corpus_embed_setup(model_u, cfg, corpus)(state_u)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xv, xi = exact(state_u, eval_batch, aux_u)
            torch.cuda.synchronize()
            exact_ms = (time.perf_counter() - t0) * 1e3
            del aux_u
            _reset_all_launches()
            t0 = time.perf_counter()
            setup = pl.make_sharded_corpus_embed_setup(model_s, cfg, corpus,
                                                       mesh)
            sharded = pl.make_sharded_eval_topk(model_s, cfg, corpus, mesh)
            aux_s = setup(state_s)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sv, si = sharded(state_s, eval_batch, aux_s)
            torch.cuda.synchronize()
            sharded_ms = (time.perf_counter() - t1) * 1e3
            setup_ms = (t1 - t0) * 1e3
            eval_launches = _all_launches()
            if not (torch.equal(si, xi) and torch.equal(sv, xv)):
                raise AssertionError(
                    "sharded eval top-500 differs from the exact eval: "
                    f"{int((si != xi).sum())} ids")
            if not torch.isfinite(sv).all():
                raise AssertionError("sharded eval scores not finite")
            log(f"mesh eval: sharded top-500 over {run.num_tracks} tracks "
                f"for 2048 playlists equal to the exact eval's (ids and "
                f"scores); {sharded_ms:.1f} ms sharded, {exact_ms:.1f} ms "
                f"exact (host clock, corpus matrix excluded; the sharded "
                f"setup {setup_ms:.1f} ms) [{card}]")
            del aux_s
            out.update(eval_ms=sharded_ms, exact_eval_ms=exact_ms)

            # ---- the collectives' share of the sharded step's device time
            it = iter(batches[MESH_STEPS:])
            wall, busy, top = device_breakdown(
                lambda: (step_s(state_s, next(it)),
                         torch.cuda.synchronize()), MESH_PROFILED - 1)
            if busy is None:
                raise AssertionError("the profiler saw no device time")
            coll = sum(ms for name, ms in top if "nccl" in name.lower())
            log(f"mesh step breakdown: {wall:.3f} ms wall, {busy:.3f} ms "
                f"device busy, collectives {coll:.4f} ms "
                f"({coll / busy:.4f} of busy; NCCL launches no kernel for "
                f"a group of one rank); largest "
                f"{[(n[:60], round(v, 4)) for n, v in top[:6]]} [{card}]")
            out.update(wall_ms=wall, busy_ms=busy, collective_ms=coll)
            launches = {k: step_launches[k] + eval_launches[k]
                        for k in step_launches}
            del state_u, state_s, model_u, model_s

            # ---- the second half: serving and the other workloads
            paths = {}
            for name, fn, args in (
                    ("serving", mesh_serving,
                     (serve_ctx["index"], serve_ctx["queries"])),
                    ("glove", mesh_glove, (mesh,)),
                    ("txt2url", mesh_txt2url, (mesh,)),
                    ("stl", mesh_stl, ()),
                    ("dense", mesh_dense_playlist,
                     (mesh, run, corpus, batches))):
                # each path counts the launches of its sharded runs only
                paths[name] = fn(card, *args)
                for k, v in paths[name]["launches"].items():
                    launches[k] += v
            for name, kernels in (("serving", ("fused_scan",)),
                                  ("glove", ("gather_pool", "scatter_add")),
                                  ("txt2url", ("gather_pool",
                                               "scatter_add")),
                                  ("dense", ("gather_pool", "scatter_add"))):
                for k in kernels:
                    if paths[name]["launches"].get(k, 0) <= 0:
                        raise AssertionError(f"mesh {name} never launched "
                                             f"{k}")
            out["shards"] = mesh_shard_kernels(
                card, serve_ctx["index"], paths["glove"].pop("ids"))
            out["paths"] = paths
            out["launches"] = launches
        finally:
            dist.destroy_process_group()
    return out


# ---- the calibrate phase: the tools at their full widths
CAL_QUERIES = 256             # retrieval_autotune's default calibration set
CAL_K = 500                   # serving's max_k
CAL_TARGET = 0.95
CAL_TRAIN_SAMPLE = 262_144    # --build_train_sample: k-means on a sample
CAL_BATCH = 64                # the tuner's query batch
CAL_FUSED_BINS = (512, 8192)  # the bins sweep's ends, checked against plain
PARITY_EXAMPLES = 512         # playlist examples: 512 B=1 steps, 16 at
#                               B=2048 (cut from 400,000 by depth)
PARITY_GLOVE_STEPS = 64       # cut from 20,000 (160 LazyAdam steps)
PARITY_STL_STEPS = 10         # cut from 600
PARITY_T2U_STEPS = 20         # cut from 3,000
BAYES_RUNS = 6                # 5 random picks, then one GP pick
MEASURE_STEPS = 10


def calibrate_autotune(card: str, index) -> dict:
    """retrieval_autotune on the trained catalog (k=500, target 0.95, 256
    calibration queries at the reference's noise, throughput measured on
    the card), and the recommendation served: a RetrievalService with its
    kwargs over the catalog answers 64 fresh queries at the calibrated
    recall (less the reference test's slack of 0.07)."""
    import numpy as np

    from esrecsys_tpu_torch.retrieval.mips import topk_over_matrix
    from esrecsys_tpu_torch.serving.server import RetrievalService
    from esrecsys_tpu_torch.tools import retrieval_autotune as ra

    import torch

    vecs = np.ascontiguousarray(index.vectors, np.float32)
    rng = np.random.default_rng(0)
    queries = ra.calibration_queries(vecs, CAL_QUERIES, 0.1, rng)
    t0 = time.perf_counter()
    res = ra.autotune(vecs, queries, CAL_TARGET, k=CAL_K,
                      train_sample=CAL_TRAIN_SAMPLE, batch=CAL_BATCH,
                      measure_throughput=True, device="cuda")
    seconds = time.perf_counter() - t0
    rows = res["all_configs"]
    rec = res["recommended"]
    if rec is None or not rec["meets_target"] or rec["recall"] < CAL_TARGET:
        raise AssertionError(f"autotune recommends {rec}")
    if rows[0]["mode"] != "exact" or rows[0]["recall"] != 1.0:
        raise AssertionError(f"autotune exact row {rows[0]}")
    for c in rows:
        if not 0.0 <= c["recall"] <= 1.0:
            raise AssertionError(f"autotune row {c}")
        if c["meets_target"] and not c.get("queries_per_s", 0) > 0:
            raise AssertionError(f"autotune row without q/s: {c}")
    modes = {c["mode"] for c in rows}
    if modes != {"exact", "int8", "fused", "ivf", "ivf_int8", "pq",
                 "ivf_pq"}:
        raise AssertionError(f"autotune modes {sorted(modes)}")
    ivf_flags = next(c["flags"] for c in rows if c["mode"] == "ivf")
    if "--ivf_clusters 1024" not in ivf_flags:
        raise AssertionError(f"sqrt-law cells: {ivf_flags}")
    log(f"autotune on the trained catalog ({res['n_items']} x {res['dim']}, "
        f"k={CAL_K}, target {CAL_TARGET}, {CAL_QUERIES} queries, build "
        f"sample {CAL_TRAIN_SAMPLE}): {seconds:.1f} s; builds "
        f"{res['build_seconds']} s; recommended {rec['mode']} {rec['knob']} "
        f"recall {rec['recall']} at {rec['queries_per_s']} q/s, flags "
        f"'{rec['flags']}' [{card}]")
    log("autotune rows: " + "; ".join(
        f"{c['mode']} {c['knob']} recall {c['recall']}"
        + (f" {c['queries_per_s']} q/s" if "queries_per_s" in c else "")
        + f" {c['scan_bytes_per_query'] / 1e6:.2f} MB/query"
        for c in rows) + f" [{card}]")
    # the recommendation served, on fresh queries
    held = ra.calibration_queries(vecs, 64, 0.1, np.random.default_rng(7))
    items = torch.from_numpy(vecs).cuda()
    truth = topk_over_matrix(torch.from_numpy(held).cuda(), items,
                             CAL_K)[1].cpu().numpy()
    del items
    svc = RetrievalService(index, max_k=CAL_K, max_batch=8, device="cuda",
                           **rec["kwargs"])
    ids, _ = svc.topk(held, k=CAL_K)
    del svc
    got = np.asarray([[index._id2row[x] for x in row] for row in ids])
    served = ra._recall(got, truth)
    if served < CAL_TARGET - 0.07:
        raise AssertionError(f"the recommended {rec['mode']} serves recall "
                             f"{served} on fresh queries")
    log(f"autotune recommendation served ({rec['mode']} {rec['flags']}): "
        f"recall@{CAL_K} "
        f"{served:.4f} on 64 fresh queries (calibrated {rec['recall']}) "
        f"[{card}]")
    return {"result": res, "seconds": seconds, "served_recall": served,
            "queries": queries}


def calibrate_tools(card: str, work: str) -> dict:
    """parity_runs for the four workloads at the tools' widths (steps cut
    by depth), playlist_parity_sweep --mode bayes for BAYES_RUNS runs of
    one run of 8 steps each, scaling_study --mode measure on one NCCL
    rank."""
    import math

    from esrecsys_tpu_torch.tools import parity_runs as pr
    from esrecsys_tpu_torch.tools import playlist_parity_sweep as pps
    from esrecsys_tpu_torch.tools import scaling_study as ss

    out = {}
    t0 = time.perf_counter()
    parity = {
        "playlist": pr.run_playlist([0], work, examples=PARITY_EXAMPLES,
                                    device="cuda"),
        "glove": pr.run_glove([0], work, steps=PARITY_GLOVE_STEPS,
                              device="cuda"),
        "stl": pr.run_stl([0], work, steps=PARITY_STL_STEPS, device="cuda"),
        "txt2url": pr.run_txt2url([0], work, steps=PARITY_T2U_STEPS,
                                  device="cuda")}
    for wl, res in parity.items():
        for name, rows in res.items():
            for r in rows:
                vals = [v for k, v in r.items()
                        if k not in ("seed", "steps", "examples",
                                     "train_seconds")]
                if not all(math.isfinite(v) for v in vals):
                    raise AssertionError(f"parity {wl} {name}: {r}")
    ref = parity["playlist"]["reference_shape"][0]
    if (ref["steps"], parity["playlist"]["fast"][0]["steps"]) != (
            PARITY_EXAMPLES, PARITY_EXAMPLES * 64 // 2048):
        raise AssertionError(f"parity playlist steps: {parity['playlist']}")
    out["parity"] = parity
    out["parity_s"] = time.perf_counter() - t0
    ref_ms = ref["train_seconds"] * 1e3 / ref["steps"]
    log(f"parity_runs (seed 0; playlist {ref['steps']} reference steps at "
        f"B=1 and {parity['playlist']['fast'][0]['steps']} at B=2048, GloVe "
        f"{PARITY_GLOVE_STEPS} / "
        f"{int(PARITY_GLOVE_STEPS * 2.5)} steps at 20,000 x 64, STL "
        f"{PARITY_STL_STEPS} steps at 32 px, txt2url {PARITY_T2U_STEPS} "
        f"steps over 2,000 URLs): {out['parity_s']:.1f} s; "
        + "; ".join(f"{wl} {name} {rows[0]}" for wl, res in parity.items()
                    for name, rows in res.items())
        + f"; the reference playlist step {ref_ms:.2f} ms on the host "
        f"clock, so 400,000 take about {ref_ms * 400:.0f} s [{card}]")
    t0 = time.perf_counter()
    bay = pps.bayes(os.path.join(work, "bayes"), examples=1,
                    max_runs=BAYES_RUNS, device="cuda")
    out["bayes_s"] = time.perf_counter() - t0
    if len(bay["runs"]) != BAYES_RUNS or \
            not math.isfinite(bay["best"]["track_recall@500"]):
        raise AssertionError(f"bayes sweep: {bay}")
    out["bayes"] = bay
    log(f"playlist_parity_sweep --mode bayes: {BAYES_RUNS} runs of 8 steps "
        f"(5 random, then one GP-EI pick) in {out['bayes_s']:.1f} s; runs "
        + "; ".join(f"{r['overrides']} -> {r['track_recall@500']:.4f}"
                    for r in bay["runs"]) + f" [{card}]")
    t0 = time.perf_counter()
    meas = ss.run_measure_mode(MEASURE_STEPS, None, device="cuda",
                               procs=[1])
    out["measure_s"] = time.perf_counter() - t0
    row = meas["rows"][0]["per_process"][0]
    if not (row["step_ms"] > 0 and row["processes"] == 1):
        raise AssertionError(f"scaling measure: {meas}")
    out["measure"] = meas
    log(f"scaling_study --mode measure on one NCCL rank (D=32, 20,000 "
        f"buckets, B=1024, N=128 shared, M=16): {row['step_ms']:.3f} ms a "
        f"step, {row['global_examples_per_s']:.0f} examples/s; "
        f"{out['measure_s']:.1f} s with the worker's start [{card}]")
    return out


def calibrate_kernels(card: str, index, queries, tuned: dict) -> dict:
    """The three kernels of the tools' path at their shapes, against their
    plain versions: fused_scan at B=64 over the trained catalog at the
    bins sweep's ends (L=512 and 8,192); gather_pool at the IVF probe of
    64 queries over 1,024 cells (the first chunk of the widest nprobe the
    tuner tried, bit-equal); scatter_add at the k-means cell sums of an
    IVF built as the tuner builds it (262,144 sampled rows onto 1,024 x
    64, the pile-up bound of the sublinear phase)."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import gather_pool as gp
    from esrecsys_tpu_torch.kernels import scatter_add as sa
    from esrecsys_tpu_torch.kernels.fused_scan import (fused_scan_cuda,
                                                       fused_scan_plain)
    from esrecsys_tpu_torch.retrieval.fused import pack_catalog
    from esrecsys_tpu_torch.retrieval.ivf import (IVFIndex, _chunks,
                                                  _probe_candidates,
                                                  kmeans_assign)

    items = torch.from_numpy(np.ascontiguousarray(index.vectors,
                                                  np.float32)).cuda()
    n, D = items.shape
    qf = torch.from_numpy(queries[:CAL_BATCH]).cuda()
    qb = qf.to(torch.bfloat16)
    errs, timed = {"fused_scan": 0.0}, {}
    for L in CAL_FUSED_BINS:
        packed = pack_catalog(items, L)
        kv, ki = fused_scan_cuda(qb, packed, L, n)
        pv, pi = fused_scan_plain(qb, packed, L, n)
        torch.cuda.synchronize()
        err, ties, _ = compare_candidates(qb, packed, kv, ki, pv, pi)
        errs["fused_scan"] = max(errs["fused_scan"], err)
        ms = cuda_ms(lambda: fused_scan_cuda(qb, packed, L, n), 20)
        plain_ms = cuda_ms(lambda: fused_scan_plain(qb, packed, L, n), 1,
                           warmup=0)
        mp = packed.shape[1]
        bound_ms, bound_by = scan_bound(CAL_BATCH, D, mp, L)
        timed[f"fused_scan_B64_L{L}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
        log(f"kernel fused_scan at the autotuner's shape (B={CAL_BATCH}, "
            f"D={D}, Mp={mp}, L={L}): ok, max_abs_err {err:.3g}, near-tie "
            f"id slots {ties}; {ms:.4f} ms (mean of 20, CUDA events), "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.3f} of bound speed [{card}]")
        del packed, kv, ki, pv, pi
    # the k-means cell sums of the tuner's IVF build: the sample it trains
    # on (kmeans' generator), assigned to the built centroids
    ivf = IVFIndex.build(items, 1024, iters=10, train_sample=CAL_TRAIN_SAMPLE)
    cent = torch.from_numpy(ivf.centroids).cuda()
    sample = torch.randperm(n, generator=torch.Generator().manual_seed(0))[
        :CAL_TRAIN_SAMPLE].cuda()
    train = items[sample]
    ids = kmeans_assign(train, cent).to(torch.int32)
    table = torch.zeros((1024, D), device="cuda")
    k = sa.scatter_add_cuda(table.clone(), ids, train)
    p = sa.scatter_add_plain(table.clone(), ids, train)
    counts = torch.bincount(ids.long(), minlength=1024)
    abs_sum = sa.scatter_add_plain(table.clone(), ids, train.abs())
    torch.cuda.synchronize()
    bound = float(8 * counts.max().float().sqrt()
                  * torch.finfo(torch.float32).eps * abs_sum.max())
    s_err = float((k - p).abs().max())
    if s_err > bound:
        raise AssertionError(f"scatter_add at the 1,024-cell sums: err "
                             f"{s_err} over {bound}")
    _, s_calls, _, s_bound = row_kernel_calls(table, ids, train)
    timed["scatter_add_kmeans_1024"] = dict(zip(
        ("ms", "plain_ms", "library_ms"), map(cold_ms, s_calls)),
        bound_ms=s_bound, bound_by="bytes")
    log(f"kernel scatter_add at the autotuner's k-means cell sums "
        f"({CAL_TRAIN_SAMPLE} rows onto 1024 x {D}; {int(counts.max())} on "
        f"the fullest cell): max_abs_err {s_err:.3g} (bound {bound:.3g}); "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in
                    timed["scatter_add_kmeans_1024"].items()
                    if k_ != "bound_by") + f" ms (L2 flushed) [{card}]")
    del k, p, abs_sum, train
    # the IVF probe's gather: the first chunk ivf_topk cuts from 64 queries
    # at the widest nprobe the tuner tried
    lmax = ivf.bucket_ids.shape[1]
    nprobe = max(c["knob"]["nprobe"] for c in tuned["all_configs"]
                 if c["mode"].startswith("ivf"))
    chunk = _chunks(CAL_BATCH, nprobe * lmax, D)[0]
    _, _, safe = _probe_candidates(qf[chunk], cent,
                                   torch.from_numpy(ivf.bucket_ids).cuda(),
                                   nprobe)
    gids = safe.reshape(-1).to(torch.int32).contiguous()
    gk = gp.gather_pool_cuda(items, gids[:, None], False, -1)
    gplain = gp.gather_pool_plain(items, gids[:, None], False, -1)
    torch.cuda.synchronize()
    if not torch.equal(gk, gplain):
        raise AssertionError("gather_pool at the autotuner's probe differs")
    del gk, gplain
    g_calls, _, g_bound, _ = row_kernel_calls(
        items, gids, torch.empty((gids.shape[0], D), device="meta"))
    timed["gather_pool_probe_B64"] = dict(zip(
        ("ms", "plain_ms", "library_ms"), map(cold_ms, g_calls)),
        bound_ms=g_bound, bound_by="bytes")
    width = len(range(CAL_BATCH)[chunk])
    log(f"kernel gather_pool at the autotuner's IVF probe ({width} of "
        f"{CAL_BATCH} queries a chunk x nprobe {nprobe} x "
        f"Lmax {lmax} = {gids.shape[0]} rows of {D} floats): bit-equal; "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in
                    timed["gather_pool_probe_B64"].items()
                    if k_ != "bound_by") + f" ms (L2 flushed) [{card}]")
    return {"errs": {**errs, "gather_pool": 0.0, "scatter_add": s_err},
            "timed": timed}


def phase_calibrate(card: str, serve_ctx: dict) -> dict:
    """The tools at their full widths: retrieval_autotune on the trained
    catalog, parity_runs for the four workloads, the bayes sweep of
    playlist_parity_sweep, scaling_study --mode measure on one NCCL rank;
    the launch counts read around them; then the three kernels of the
    path at the tools' shapes against their plain versions."""
    import torch

    _reset_all_launches()
    t0 = time.perf_counter()
    out = {"autotune": calibrate_autotune(card, serve_ctx["index"])}
    with tempfile.TemporaryDirectory() as work:
        out.update(calibrate_tools(card, work))
    torch.cuda.synchronize()
    out["launches"] = _all_launches()
    out["path_s"] = time.perf_counter() - t0
    for k in ("fused_scan", "gather_pool", "scatter_add"):
        if out["launches"][k] <= 0:
            raise AssertionError(f"the calibrate path never launched {k}")
    log(f"calibrate path launches: {out['launches']} (the autotuner's fused "
        f"rows: fused_scan; IVF builds and probes: scatter_add, "
        f"gather_pool; the parity runs and the sweep: both row kernels) "
        f"[{card}]")
    out["kernels"] = calibrate_kernels(card, serve_ctx["index"],
                                       out["autotune"].pop("queries"),
                                       out["autotune"]["result"])
    out["seconds"] = time.perf_counter() - t0
    return out


def new_path_instantiations(bf16_res: dict, glove_res: dict, g_err: float,
                            s_err: float):
    """(per kernel, per instantiation: the bf16 and glove paths' launches
    and each instantiation's times at its path's shapes (kernel, plain
    version, library call, byte bound) and its largest difference from
    the plain version in the checks; per kernel, those paths' launches of
    every instantiation)."""
    launches = {"gather_pool": {}, "scatter_add": {}}
    paths = [bf16_res["launches"]] + [glove_res[o]["launches"]
                                      for o in ("adam", "lazy_adam")]
    for counts in paths:
        for kernel, by in counts.items():
            for inst, n in by.items():
                launches[kernel][inst] = launches[kernel].get(inst, 0) + n
    timed = {"gather_pool": {**bf16_res["timed"]["gather_pool"],
                             "f32x4": glove_res["timed"]["f32x4"],
                             "narrow_f32": glove_res["timed"]["narrow_f32"]},
             "scatter_add": {**bf16_res["timed"]["scatter_add"],
                             "f32_d64": glove_res["timed"]["f32_d64"],
                             "f32_generic":
                                 glove_res["timed"]["f32_generic"]}}
    glove_errs = glove_res["errs"]
    errs = {"bf16x8": bf16_res["gather_err"],
            "narrow_f32": max(bf16_res["gather_err"],
                              glove_errs["narrow_f32"]),
            "f32x4": max(g_err, glove_errs["f32x4"]),
            "bf16_d32": bf16_res["scatter_err"],
            "f32_d64": max(s_err, glove_errs["f32_d64"]),
            "f32_generic": max(s_err, glove_errs["f32_generic"])}
    out = {}
    for kernel, by in timed.items():
        out[kernel] = {}
        for inst, t in by.items():
            out[kernel][inst] = {**instantiation_row(
                t, launches[kernel].get(inst, 0)), "max_abs_err": errs[inst]}
    return out, {k: sum(by.values()) for k, by in launches.items()}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import esrecsys_tpu_torch.kernels.build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the esrecsys_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    try:
        # exact paths need full float32 products, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from esrecsys_tpu_torch.core.device import card_line

        card = card_line(torch.device("cuda", 0))
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}")
        spent = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] = round(time.perf_counter() - t0, 1)
            return out

        timed("build", phase_build)
        max_err, scan_times = timed("fused_scan", phase_kernels, card)
        g_err, s_err = timed("gather_scatter", check_gather_scatter, card)
        a_err = timed("affinity", check_affinity, card)
        i8_err = timed("fused_scan_int8", check_fused_int8, card)
        sm_err, sm_pile = timed("smem_scatter", check_smem_scatter, card)
        gen_res = timed("generic", check_generic, card)
        with tempfile.TemporaryDirectory() as work:
            train_res = timed("train", phase_train, card, work)
            timed("harness", phase_harness, card,
                  train_res["device_feed_examples_per_s"])
            wide_res = timed("wide", phase_wide, card, work)
            main_res, ctx = timed("serve", phase_main, card, work)
            int8_res = timed("int8", phase_int8, card, ctx)
            modes_res = timed("modes", phase_modes, card, ctx, work)
            sub_res = timed("sublinear", phase_sublinear, card, ctx, work)
            serve_ctx = {"index": ctx["index"], "queries": ctx["queries"]}
            del ctx
        cal_res = timed("calibrate", phase_calibrate, card, serve_ctx)
        tool_res = timed("tool", phase_tool, card)
        lazy_res = timed("lazy", phase_lazy, card, train_res)
        bf16_res = timed("bf16", phase_bf16, card)
        glove_res = timed("glove", phase_glove, card)
        wiki_res = timed("wiki", phase_wiki, card)
        stl_res = timed("stl", phase_stl, card)
        mesh_res = timed("mesh", phase_mesh, card, serve_ctx)
        del serve_ctx
        log(f"seconds per phase: {spent}")
    except Exception:
        traceback.print_exc()
        return 1
    train_res["gather_pool"]["max_abs_err"] = g_err
    train_res["scatter_add"]["max_abs_err"] = max(s_err, lazy_res["big_err"])
    aff = train_res["fused_affinity"]
    aff["max_abs_err"] = max(a_err, aff["max_abs_err"])
    cal_errs, cal_timed = (cal_res["kernels"]["errs"],
                           cal_res["kernels"]["timed"])
    rows = [{
        "name": "fused_scan", "route": "cuda",
        "source": "esrecsys_tpu_torch/csrc/fused_scan.cu",
        "replaces": "esrecsys_tpu/retrieval/fused.py:191",
        "launches": main_res["launches"]
        + modes_res["launches"]["fused_scan"]
        + stl_res["launches"]["fused_scan"]
        + mesh_res["launches"]["fused_scan"]
        + cal_res["launches"]["fused_scan"],
        "max_abs_err": max(max_err, stl_res["errs"]["fused_scan"],
                           mesh_res["shards"]["errs"]["fused_scan"],
                           cal_errs["fused_scan"]),
        "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
        "bound_ms": main_res["bound_ms"], "bound_by": main_res["bound_by"],
        "library_ms": None,
        "shard_shape": {"rps": mesh_res["shards"]["rps"],
                        **mesh_res["shards"]["timed"]["fused_scan"]},
        "autotune_shapes": {k: v for k, v in cal_timed.items()
                            if k.startswith("fused_scan")},
        "timed_shapes": scan_times}]
    new_paths, new_launches = new_path_instantiations(bf16_res, glove_res,
                                                      g_err, s_err)
    for name, replaces in (
            ("gather_pool", "esrecsys_tpu/ops/lookup.py:34"),
            ("scatter_add", "esrecsys_tpu/ops/scatter.py:74"),
            ("fused_affinity", "esrecsys_tpu/retrieval/fused.py:453")):
        r = train_res[name]
        # the serving phases' launches: the deploy cycles' training, the
        # IVF builds and rescores; the bf16, glove, wiki and stl paths
        served = sum(res["launches"].get(name, 0)
                     for res in (modes_res, sub_res))
        inst = new_paths.get(name, {})
        wiki_err = ({"gather_pool": 0, "scatter_add": 1}.get(name))
        row = {
            "name": name, "route": "cuda",
            "source": f"esrecsys_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": r["launches"] + served
            + new_launches.get(name, 0)
            + wiki_res["launch_totals"].get(name, 0)
            + stl_res["launches"][name]
            + mesh_res["launches"][name]
            + cal_res["launches"][name],
            "max_abs_err": max(
                r["max_abs_err"], stl_res["errs"].get(name, 0.0),
                mesh_res["shards"]["errs"].get(name, 0.0),
                cal_errs.get(name, 0.0),
                *((e[wiki_err] for e in wiki_res["errs"].values())
                  if wiki_err is not None else ())),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if inst:
            row["instantiations"] = inst
        if name == "gather_pool":
            row["previous_ms"] = GATHER_POOL_PREVIOUS_MS
            row["small_launches"] = GATHER_SMALL
        if name in ("gather_pool", "scatter_add"):
            # at the autotuner's shapes (the B=64 probe, the 1,024 cells)
            row["autotune_shape"] = next(v for k, v in cal_timed.items()
                                         if k.startswith(name))
            # at the mesh's shard shapes (GloVe's and the URL table's)
            row["shard_shapes"] = {
                what: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                               t[name]), bound_by="bytes")
                for what, t in mesh_res["shards"]["timed"].items()
                if what != "fused_scan"}
        if wiki_err is not None:
            # the txt2url step's shapes (the wiki phase): f32x4 / f32_d64
            row["txt2url_shapes"] = {
                table: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                                t[name]), bound_by="bytes",
                            launches_per_step=wiki_res["per_step"][table][
                                name])
                for table, t in wiki_res["timed"].items()}
        rows.append(row)
    rows.append({
        "name": "fused_scan_int8", "route": "cuda",
        "source": "esrecsys_tpu_torch/csrc/fused_scan_int8.cu",
        "replaces": "esrecsys_tpu/retrieval/fused.py:212",
        "launches": int8_res["launches"]
        + modes_res["launches"]["fused_scan_int8"], "max_abs_err": i8_err,
        "ms": int8_res["ms"], "plain_ms": int8_res["plain_ms"],
        "bound_ms": int8_res["bound_ms"], "bound_by": int8_res["bound_by"],
        "library_ms": None})
    rows.append({
        "name": "smem_scatter", "route": "cuda",
        "source": "esrecsys_tpu_torch/csrc/smem_scatter.cu",
        "replaces": "esrecsys_tpu/ops/scatter.py:240",
        "launches": tool_res["launches"],
        "max_abs_err": max(sm_err, sm_pile), "ms": tool_res["ms"],
        "plain_ms": tool_res["plain_ms"], "bound_ms": tool_res["bound_ms"],
        "bound_by": tool_res["bound_by"],
        "library_ms": tool_res["library_ms"]})
    # the generic entries (csrc/fused_generic.cu): the wide path's launches
    # and times, the generic checks' errors and times over a random catalog
    for name, replaces in (
            ("fused_scan_generic", "esrecsys_tpu/retrieval/fused.py:191"),
            ("fused_scan_int8_generic",
             "esrecsys_tpu/retrieval/fused.py:212"),
            ("fused_affinity_generic",
             "esrecsys_tpu/retrieval/fused.py:453")):
        w = wide_res[name]
        row = {
            "name": name, "route": "cuda",
            "source": "esrecsys_tpu_torch/csrc/fused_generic.cu",
            "replaces": replaces, "launches": wide_res["launches"][name],
            "max_abs_err": max(gen_res["errs"][name],
                               wide_res["errs"].get(name, 0.0)),
            "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "library_ms": None}
        if name == "fused_affinity_generic":
            row["plain_batch"] = w["plain_batch"]
        else:
            row["timed_shapes"] = {k: v for k, v in gen_res["timed"].items()
                                   if k.rsplit("_B", 1)[0] == name}
        rows.append(row)
    marked = mark_timers(rows)
    if marked:
        log(f"{marked} entries of the kernels line hold a time not from a "
            f"whole profiler trace (their \"timer\" says how it was taken)")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
