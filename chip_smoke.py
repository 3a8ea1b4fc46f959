"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before
the result line:

  1. device   - the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build    - every CUDA kernel of the served path, built from the
                sources in this checkout with nvcc for sm_90a;
  3. kernels  - each kernel against its plain PyTorch version on the card,
                at ragged and full-catalog shapes;
  4. main     - the playlist catalog served end to end at full width:
                a model (feature_size 32, 100,000 album buckets, 295,861
                artists) initialised from seed 0, exported, loaded back,
                its 2,262,292 tracks embedded and served top-500 by the
                fused and the exact RetrievalService, 64 queries through
                topk and several HTTP requests through serve(port=0);
                then overlap@500 of fused against exact, timings, and a
                torch.profiler breakdown of one served call.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
    for the four largest). Busy time sums the device rows of the trace
    (kernels and copies); None when the trace holds no device time."""
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
    return wall_ms, sum(r[1] for r in rows), rows[:4]


def compare_candidates(q, packed, kv, ki, pv, pi):
    """Kernel (kv, ki) against plain (pv, pi) candidates. Values agree
    within TOL. Ids agree, except in slots whose two competing items score
    apart by a nonzero gap within TOL (a different summation order may flip
    such a near-tie); where the two score bit-equal (copies of one vector)
    the strict-'>' rule decides, so the ids must match. Returns (max abs
    error, count of near-tie slots, count of slots holding an exact tie)."""
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
        qf = q.float()[b]
        s_k = (qf * packed[:, ki[b, slot].long()].T.float()).sum(-1)
        s_p = (qf * packed[:, pi[b, slot].long()].T.float()).sum(-1)
        gap = (s_k - s_p).abs()
        if bool((gap == 0).any()):
            raise AssertionError(
                f"{int((gap == 0).sum())} ids differ between items that "
                f"score bit-equal: the earlier-block-wins rule is broken")
        if bool((gap > TOL + TOL * s_p.abs()).any()):
            raise AssertionError(
                f"{near} id mismatches, worst score gap {float(gap.max())}")
    return err, near, exact_ties


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


def phase_main(card: str):
    import numpy as np
    import torch

    from esrecsys_tpu_torch.kernels import fused_scan as fs
    from esrecsys_tpu_torch.serving.server import RetrievalService, serve
    from esrecsys_tpu_torch.tools.full_scale_run import (ServingRunConfig,
                                                         init_and_export,
                                                         serve_from_artifact,
                                                         synth_corpus)

    with tempfile.TemporaryDirectory() as work:
        cfg = ServingRunConfig(out_dir=work, fused=True, device="cuda")
        corpus = synth_corpus(cfg)
        fs.LAUNCHES.reset()
        # ---- the main path: artifact -> catalog -> fused + exact serving
        t0 = time.perf_counter()
        init_and_export(cfg)
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
        log(f"main path: {cfg.num_tracks} tracks D=64 served in "
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
            ops = ", ".join(f"{k[:40]} {v * 1e3:.1f} us" for k, v in top)
            log(f"breakdown {name} topk B=8: {wall:.3f} ms per call under "
                f"the profiler, device busy {busy:.3f} ms (idle share "
                f"{1 - busy / wall:.2f}); largest: {ops} [{card}]")
        return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "fused_topk_ms": fused_ms, "exact_topk_ms": exact_ms,
                "overlap": overlap}


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
        from esrecsys_tpu_torch.kernels import build
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
        t0 = time.perf_counter()
        build.load_library("fused_scan")
        log(f"build fused_scan: {time.perf_counter() - t0:.1f} s "
            f"(nvcc {build.build_seconds.get('fused_scan', 0.0):.1f} s)")
        for line in build.build_logs.get("fused_scan", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        max_err = phase_kernels(card)
        main_res = phase_main(card)
    except Exception:
        traceback.print_exc()
        return 1
    log(json.dumps({"kernels": [{
        "name": "fused_scan", "route": "cuda",
        "source": "esrecsys_tpu_torch/csrc/fused_scan.cu",
        "replaces": "esrecsys_tpu/retrieval/fused.py:191",
        "launches": main_res["launches"], "max_abs_err": max_err,
        "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
        "bound_ms": main_res["bound_ms"], "bound_by": main_res["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
