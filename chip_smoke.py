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
                batches) and the main path's full shapes: the int8 fused
                scan at B=8, 13 and 64 over the full 2,265,088-column
                catalog with planted copies of one vector, and at B=8
                with a planted runner-up sequence (v, v, then 2v in one
                bin) and with a bound inside a block, scatter_add's
                vector and generic instantiations (D 4, 6, 32, 64 and
                128, updates one float off a 16-byte boundary, ids -1
                and R, untouched rows bit-equal) and at a pile-up, the
                shared-memory scatter against its plain version and
                scatter_add at the album table, at both edges of its CTA
                row ranges (rows hit once bit-equal) and at a pile-up
                (and its refusal of the artist table);
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
  5. serve    - the trained artifact loaded, its catalog embedded and
                served top-500 by the fused and the exact RetrievalService,
                64 queries through topk and several HTTP requests through
                serve(port=0); overlap@500 of fused against exact, timings,
                and a torch.profiler breakdown of one served call;
  6. int8     - the same catalog served in the four int8 modes (int8,
                int8+r8, fused int8, fused int8+r8) and one HTTP request
                through serve(fused, quantized, rescore_int8); the device
                quantizer against its numpy twin over the whole catalog,
                overlap@500 of each mode against exact, B=8 latency and a
                breakdown of each;
  7. tool     - the port's scatter_attempt (shared-memory scatter,
                scatter_add, index_add_ at the album table and a half-size
                one), then the shared-memory scatter timed at the album
                table and with every id on one row.

Each main-path phase (train, serve, int8, tool) sets the launch counts to
0 just before it and reads them just after. A line gives the seconds each
phase took. The second-to-last line is the kernel table as JSON, the last
line ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import os
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
STEPS = 20                    # training steps of the main path
K_STEPS = 5                   # steps compared, kernels against plain
# kernels against plain over K steps: atomics sum duplicate rows in
# another order, and a last-ulp difference in a table value can flip its
# bf16 rounding, which moves one gradient element by a bf16 ulp; tables
# and momentum must agree within these bounds, and at most this share of
# their elements may differ by more than 1e-6 (a scatter into a wrong row
# would move whole rows)
TRAIN_TABLE_ATOL = 1e-5
TRAIN_MOMENTUM_ATOL = 2e-4
TRAIN_DIFF_SHARE = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def compare_top2(kv, ki, pv, pi, identical, score, near_tol):
    """Kernel (kv, ki) against plain (pv, pi) per-bin top-2 candidates.
    Values agree within TOL. Ids agree, except in near-tie slots whose two
    items score within ``near_tol(score)`` of each other in a third
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
    torch.testing.assert_close(kv[fin], pv[fin], atol=TOL, rtol=TOL)
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
        if bool((gap > near_tol(s_p)).any()):
            raise AssertionError(
                f"{near} id mismatches, worst score gap {float(gap.max())}")
    return err, near, exact_ties


def compare_candidates(q, packed, kv, ki, pv, pi, scales=None):
    """fused_scan (bf16 ``packed``) or fused_scan_int8 (int8 ``packed``
    with its ``scales``) against its plain version (compare_top2)."""
    def identical(gk, gp):
        same = (packed[:, gk] == packed[:, gp]).all(0)
        return same if scales is None else same & (scales[gk] == scales[gp])

    def score(b, g):
        s = (q.float()[b] * packed[:, g].T.float()).sum(-1)
        return s if scales is None else s * scales[g]

    return compare_top2(kv, ki, pv, pi, identical, score,
                        lambda s: TOL + TOL * s.abs())


def phase_kernels(card: str) -> float:
    import torch

    from esrecsys_tpu_torch.kernels.fused_scan import (fused_scan_cuda,
                                                       fused_scan_plain)
    from esrecsys_tpu_torch.retrieval.fused import pack_catalog

    gen = torch.Generator(device="cuda").manual_seed(1)
    D, M = 64, 100_003
    items = torch.randn(M, D, generator=gen, device="cuda")
    mask_m = torch.rand(M, generator=gen, device="cuda") > 0.3
    worst = 0.0
    for L in (128, 4096):
        packed = pack_catalog(items, L)
        Mp = packed.shape[1]
        mask = torch.zeros(Mp, dtype=torch.bool, device="cuda")
        mask[:M] = mask_m
        for B in (1, 8, 13):
            q = torch.randn(B, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
            for bound, msk in ((M, None), (97_001, mask)):
                kv, ki = fused_scan_cuda(q, packed, L, bound, msk)
                pv, pi = fused_scan_plain(q, packed, L, bound, msk)
                torch.cuda.synchronize()
                err, ties, _ = compare_candidates(q, packed, kv, ki, pv, pi)
                worst = max(worst, err)
                log(f"kernel fused_scan B={B} D={D} M={M} L={L} "
                    f"bound={bound} mask={msk is not None}: ok, max_abs_err "
                    f"{err:.3g}, near-tie id slots {ties}")
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
        q = torch.randn(8, D, generator=gen, device="cuda")
        q[0] = dup[0]
        q = q.to(torch.bfloat16)
        kv, ki = fused_scan_cuda(q, packed, L, M)
        pv, pi = fused_scan_plain(q, packed, L, M)
        torch.cuda.synchronize()
        err, ties, exact = compare_candidates(q, packed, kv, ki, pv, pi)
        if exact == 0:
            raise AssertionError("the duplicate-items case holds no tie")
        worst = max(worst, err)
        log(f"kernel fused_scan B=8 D={D} M={M} L={L} duplicated items: ok, "
            f"max_abs_err {err:.3g}, exact-tie slots {exact} (ids equal "
            f"there), near-tie id slots {ties}")
    # the kernel's other dims, at a small ragged catalog
    for D in (16, 32, 128):
        M = 10_007
        items = torch.randn(M, D, generator=gen, device="cuda")
        packed = pack_catalog(items, 128)
        mask = torch.rand(packed.shape[1], generator=gen, device="cuda") > 0.3
        q = torch.randn(13, D, generator=gen, device="cuda").to(torch.bfloat16)
        kv, ki = fused_scan_cuda(q, packed, 128, 9_001, mask)
        pv, pi = fused_scan_plain(q, packed, 128, 9_001, mask)
        torch.cuda.synchronize()
        err, ties, _ = compare_candidates(q, packed, kv, ki, pv, pi)
        worst = max(worst, err)
        log(f"kernel fused_scan B=13 D={D} M={M} L=128 bound=9001 mask=True: "
            f"ok, max_abs_err {err:.3g}, near-tie id slots {ties}")
    # one full-size case: B=8 against a 2,262,292-row catalog
    D = 64
    M = 2_262_292
    items = torch.randn(M, D, generator=gen, device="cuda")
    packed = pack_catalog(items, 4096)
    del items
    q = torch.randn(8, D, generator=gen, device="cuda").to(torch.bfloat16)
    kv, ki = fused_scan_cuda(q, packed, 4096, M)
    pv, pi = fused_scan_plain(q, packed, 4096, M)
    torch.cuda.synchronize()
    err, ties, _ = compare_candidates(q, packed, kv, ki, pv, pi)
    worst = max(worst, err)
    log(f"kernel fused_scan B=8 D={D} M={M} L=4096 full catalog: ok, "
        f"max_abs_err {err:.3g}, near-tie id slots {ties} [{card}]")
    return worst


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


def compare_affinity(args, kv, ki, pv, pi):
    """fused_affinity against its plain version (compare_top2): identical
    inputs are a catalog column with its album and artist; near-tie items
    score within 10 TOL in a third order."""
    _, packed, album, artist = args[:4]

    def identical(gk, gp):
        return ((packed[:, gk] == packed[:, gp]).all(0)
                & (album[gk] == album[gp]) & (artist[gk] == artist[gp]))

    return compare_top2(kv, ki, pv, pi, identical,
                        lambda b, g: affinity_at(*args, b, g),
                        lambda s: TOL * 10)


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
    """An int8 catalog of M items where each of ``bins`` holds one vector v
    in blocks 0 and 1 and 2v in block 2, with queries near v: every query
    scores 2v first and the block-1 copy of v second under the sequential
    fold (a merge of per-block top-2 lists by lowest id would keep the
    block-0 copy). Returns (q (8, D) bf16, codes, scales)."""
    import torch

    from esrecsys_tpu_torch.retrieval.fused import pack_catalog_int8

    items = torch.randn(M, D, generator=gen, device="cuda")
    v = 3 * torch.randn(D, generator=gen, device="cuda")
    for j in bins:
        items[j] = items[j + L] = v
        items[j + 2 * L] = 2 * v
    q = v + torch.randn(8, D, generator=gen, device="cuda")
    codes, scales = pack_catalog_int8(items, L)
    return q.to(torch.bfloat16), codes, scales


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
        for j in bins:
            want = (j + lead * L, j + L)
            got = (ki[:, j], ki[:, L + j])
            if not all(bool((g == w).all()) for g, w in zip(got, want)):
                raise AssertionError(f"runner-up sequence ({name}), bin {j}: "
                                     f"ids {got[0].tolist()}, "
                                     f"{got[1].tolist()}, want {want}")
        log(f"kernel fused_scan_int8 B=8 D={D} M={M} L={L} runner-up "
            f"sequence v, v, 2v in bins {bins}, {name}: ok, max_abs_err "
            f"{err:.3g}, the planted bins keep (2v or v, block-1 v), "
            f"exact-tie slots {exact}, near-tie id slots {near} [{card}]")
    del codes, scales
    return worst


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


def cold_rows(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` in ms, per kernel it launches,
    with the 50 MB L2 cache flushed before each call, as the train step
    finds its tables after the rest of the step has streamed through the
    cache: the device rows of a torch.profiler trace, less the flush's own
    rows (a bitwise NOT over 256 MiB of bytes, an op none of the timed
    functions uses, found by its name). CUDA events around a
    few-microsecond call would time the host's launch instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    # a trace now and then comes back with no device rows at all (about
    # once in sixty traces on an H100): trace the window again, three
    # times at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total}
        flushes = [k for k in rows if "bitwise_not" in k]
        if flushes:
            break
    else:
        raise RuntimeError("three profiler traces held no flush rows")
    timed = {k: t / 1e3 / reps for k, t in rows.items() if k not in flushes}
    if not timed:
        raise RuntimeError("the profiler trace holds no device time")
    return timed


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
    batch = fsr.to_device(fsr.host_batch(np.random.default_rng(999), 2048,
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
    out["fused_affinity"] = {
        "launches": launches["fused_affinity"], "max_abs_err": aff_err,
        "ms": aff_ms, "plain_ms": aff_plain_ms, "bound_ms": aff_bound,
        "bound_by": aff_by, "library_ms": None}
    return out


def http_json(url: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=300) as r:
        return json.loads(r.read())


def overlap_at_k(svc_items, queries, fused_ids, exact_ids) -> float:
    """Share of the fused answer whose exact score is at or above the
    exact k-th score, both scored by one float32 multiply-sum (tracks
    share album and artist rows, so equal scores are common)."""
    import torch

    q = torch.from_numpy(queries).to(svc_items.device)

    def scores(ids):
        idx = torch.from_numpy(ids.astype("int64")).to(svc_items.device)
        return (svc_items[idx] * q[:, None, :]).sum(-1)

    kth = scores(exact_ids).min(dim=-1, keepdim=True).values
    found = (scores(fused_ids) >= kth).float().mean(dim=-1)
    return float(found.mean())


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
    nblk = -(-M // L)
    D = packed.shape[0]
    moved = nblk * L * D * 2 + q8.shape[0] * D * 2 + q8.shape[0] * 2 * L * 8
    flops = 2 * q8.shape[0] * D * nblk * L
    bound_ms = max(moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    bound_by = ("bytes" if moved / HBM_BYTES_PER_S
                >= flops / BF16_FLOPS_PER_S else "operations")
    log(f"latency B=8 k=500: fused topk {fused_ms:.3f} ms, exact topk "
        f"{exact_ms:.3f} ms (median of 20, host clock) [{card}]")
    log(f"kernel fused_scan B=8 D={D} Mp={packed.shape[1]} L={L}: "
        f"{kernel_ms * 1e3:.1f} us (mean of 50, CUDA events), bound "
        f"{bound_ms * 1e3:.1f} us by {bound_by} ({moved / 1e6:.1f} MB), "
        f"plain version {plain_ms:.3f} ms [{card}]")
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
        card = card_line()
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
        max_err = timed("fused_scan", phase_kernels, card)
        g_err, s_err = timed("gather_scatter", check_gather_scatter, card)
        a_err = timed("affinity", check_affinity, card)
        i8_err = timed("fused_scan_int8", check_fused_int8, card)
        sm_err, sm_pile = timed("smem_scatter", check_smem_scatter, card)
        with tempfile.TemporaryDirectory() as work:
            train_res = timed("train", phase_train, card, work)
            main_res, ctx = timed("serve", phase_main, card, work)
            int8_res = timed("int8", phase_int8, card, ctx)
            del ctx
        tool_res = timed("tool", phase_tool, card)
        log(f"seconds per phase: {spent}")
    except Exception:
        traceback.print_exc()
        return 1
    train_res["gather_pool"]["max_abs_err"] = g_err
    train_res["scatter_add"]["max_abs_err"] = s_err
    aff = train_res["fused_affinity"]
    aff["max_abs_err"] = max(a_err, aff["max_abs_err"])
    rows = [{
        "name": "fused_scan", "route": "cuda",
        "source": "esrecsys_tpu_torch/csrc/fused_scan.cu",
        "replaces": "esrecsys_tpu/retrieval/fused.py:191",
        "launches": main_res["launches"], "max_abs_err": max_err,
        "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
        "bound_ms": main_res["bound_ms"], "bound_by": main_res["bound_by"],
        "library_ms": None}]
    for name, replaces in (
            ("gather_pool", "esrecsys_tpu/ops/lookup.py:34"),
            ("scatter_add", "esrecsys_tpu/ops/scatter.py:74"),
            ("fused_affinity", "esrecsys_tpu/retrieval/fused.py:453")):
        r = train_res[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"esrecsys_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    rows.append({
        "name": "fused_scan_int8", "route": "cuda",
        "source": "esrecsys_tpu_torch/csrc/fused_scan_int8.cu",
        "replaces": "esrecsys_tpu/retrieval/fused.py:212",
        "launches": int8_res["launches"], "max_abs_err": i8_err,
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
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
