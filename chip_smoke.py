#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Every phase is fatal on failure; nothing is caught and passed over.

1. card: CUDA must be present; prints the card's name and power limit.
2. build: ``nvcc`` builds the frontier-gather kernel from
   ``src/repro_torch/kernels/csrc/`` (build time and the ptxas report printed).
3. check: the kernel against its plain PyTorch version on the card for kl,
   itakura_saito, renyi_0.25, l2 and negdot, at the search shape
   and NN-descent shapes of both configurations below (NN-descent on a
   row subset), m'=128, with -1 padding: rtol = atol = 1e-5 and equal inf
   positions.
4. serve defaults: n=20,000, d=32, KL, NN-descent, ef 96, frontier 4, k 10,
   256 queries in batches of 64 through ``launch.serve.build_and_serve``;
   recall@10 >= 0.90.
5. main path at full size: n=1,000,000 LDA-like histograms (d=128,
   alpha=0.08), 1,024 held-out queries in batches of 64, through the same
   entry point, with the graph degree doubled (NN 30) and ef 512.  The
   launch count is set to 0 just before and read just after; build and
   search must both have launched the kernel, and recall@10 against
   ``knn_scan`` must exceed 0.5.
6. timing: the kernel per launch at the search-step and NN-descent-round
   shapes of both configurations, over the full-size database, beside its
   bound and the plain version's time.  ``ms`` is device time from the
   profiler's kernel records; ``event_ms`` is CUDA events around
   back-to-back calls, which also counts the host's launch gaps.
7. profile: device time by kernel and the device's idle share for one
   full-size build and one search batch (``torch.profiler``).
8. graph quality at full size, NN 15 against NN 30: the share of each
   node's true NN nearest neighbours that the NN-descent graph holds, and
   search recall@10 at ef 96 and 512.

The last three lines are the card line, a JSON object with the kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
DISTANCES = ["kl", "itakura_saito", "renyi_0.25", "l2", "negdot"]
TOL = dict(rtol=1e-5, atol=1e-5)

N_FULL, D_FULL, Q_FULL, BATCH = 1_000_000, 128, 1024, 64

# (B, R): search step = batch x frontier*M, NN-descent round = rows x (K*K + K + 8)
CHECK_SHAPES = [(64, 120), (4096, 248), (64, 240), (2048, 938)]
TIME_SHAPES = [("full search step B=64 R=240 (NN 30)", 64, 240),
               ("full NN-descent round B=1e6 R=938 (NN 30)", N_FULL, 938),
               ("serve-default search step B=64 R=120 (NN 15)", 64, 120),
               ("serve-default NN-descent round B=1e6 R=248 (NN 15)", N_FULL, 248)]


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_ids(gen, B, R, n, pad=0.1):
    ids = torch.randint(0, n, (B, R), generator=gen, device="cuda", dtype=torch.int32)
    drop = torch.rand((B, R), generator=gen, device="cuda") < pad
    return torch.where(drop, -1, ids).contiguous()


def bound(ids, m: int):
    """Least time for one call: (ms, "bytes" | "operations", gathered-rows ms).

    Bytes count every input read once and the output written once: the ids,
    the query reps and biases, the DISTINCT database rows and biases the ids
    name, and the (B, R) output.  Operations are 2 m' per valid (b, r) at the
    float32 rate.  The third number is the time to read every gathered row
    from device memory, with no reuse: the floor of a design that, like this
    kernel, fetches each (b, r) row on its own.
    """
    B, R = ids.shape
    valid = ids[ids >= 0]
    distinct = int(torch.unique(valid).numel())
    n_valid = int(valid.numel())
    row = 4 * m + 4
    nbytes = 4 * B * R + 4 * B * m + 4 * B + distinct * row + 4 * B * R
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * m * n_valid / H100_FP32_FLOPS
    gathered = (4 * B * R + 4 * B * m + n_valid * row + 4 * B * R) / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * gathered


def time_ms(fn, args_list, reps: int) -> float:
    """Mean ms per call from CUDA events around ``reps`` back-to-back calls
    cycling through ``args_list``; counts the host's launch gaps too."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _profiled(fn):
    """Run ``fn()`` under torch.profiler; (host wall ms, [(device ms, count, kernel)]).

    The rows are the CUDA kernels' own times, as the profiler's table sums them.
    """
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    return wall_ms, rows


def device_ms(fn, args_list, reps: int) -> float:
    """Mean device time per call: the kernels ``fn`` launches, without host gaps.

    CUDA events around back-to-back calls also count the time the card
    waits for the host to launch the next call, which exceeds a short
    kernel's own time; the profiler's kernel records do not.
    """
    for a in args_list[:2]:
        fn(*a)

    def run():
        for i in range(reps):
            fn(*args_list[i % len(args_list)])

    _, rows = _profiled(run)
    if not rows:
        raise AssertionError("the profiler recorded no CUDA kernels")
    return sum(r[0] for r in rows) / reps


def profile_device(fn, label: str) -> None:
    """Device time by kernel and the idle share of ``fn()`` under torch.profiler.

    The wall time includes the profiler's own host overhead, so the idle
    share reads high.
    """
    wall_ms, rows = _profiled(fn)
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms:
        log(f"profile {label}: wall {wall_ms:.3f} ms, device time not measured "
            f"(the profiler recorded no CUDA kernels)")
        return
    log(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {sum(r[1] for r in rows)} kernels")
    for ms, count, key in rows[:8]:
        log(f"  {ms:10.3f} ms  {count:6d} x  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.distances import get_distance
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.data.synthetic import lda_like_histograms, split_queries
    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_gather import frontier_scores
    from repro_torch.kernels.ref import gather_scores_ref
    from repro_torch.launch.serve import build_and_serve
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.spec import RetrievalSpec

    # the serve scenario with the graph degree doubled (NN 30, M 60) and ef 512:
    # at NN 15 the NN-descent graph holds few of each node's true neighbours
    # at n = 1e6, d = 128, and recall@10 stays below the 0.5 floor (phase 8
    # measures both; PERF.md)
    full_spec = RetrievalSpec(distance="kl", builder="nndescent", NN=30, ef_search=512,
                              frontier=4, wave=64, slots=48, sched_frontier=12,
                              steps_per_sync=4)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.load("frontier_gather")
    log(f"build frontier_gather: {time.perf_counter() - t0:.3f} s")
    print(build.build_log("frontier_gather").strip(), flush=True)

    # -- 3. kernel vs plain version ------------------------------------------------
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    X_chk = lda_like_histograms(rng, 200_000, D_FULL, device="cuda")
    max_err = {}
    for name in DISTANCES:
        dist = get_distance(name)
        x_rep = dist.prep_left(X_chk).contiguous()
        x_bias = dist.bias_left(X_chk).contiguous()
        for B, R in CHECK_SHAPES:
            Q = X_chk[torch.randint(0, X_chk.shape[0], (B,), generator=gen, device="cuda")]
            q_rep, q_bias = dist.prep_right(Q).contiguous(), dist.bias_right(Q).contiguous()
            ids = random_ids(gen, B, R, X_chk.shape[0])
            got = frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
            want = gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
            torch.cuda.synchronize()
            if not torch.equal(torch.isinf(got), ids < 0):
                raise AssertionError(f"{name} {B}x{R}: inf positions differ from the padding")
            torch.testing.assert_close(got, want, **TOL)
            fin = ids >= 0
            err = float((got[fin] - want[fin]).abs().max())
            rel = float(((got[fin] - want[fin]).abs() / want[fin].abs().clamp(min=1e-30)).max())
            max_err[(name, B, R)] = err
            log(f"check {name:13s} B={B:5d} R={R:4d}: max abs err {err:.3e}, "
                f"max rel err {rel:.3e}")
    del X_chk, x_rep, x_bias

    # -- 4. serve defaults -----------------------------------------------------------
    small = build_and_serve(n_db=20_000, dim=32, n_queries=256, batch=64, ef_search=96,
                            frontier=4, device="cuda", verbose=False)
    log("serve defaults n=20000 d=32: " + json.dumps(
        {k: v for k, v in small.items() if k != "spec"}))
    if small["recall@k"] < 0.90:
        raise AssertionError(f"recall@10 {small['recall@k']} < 0.90 at the serve defaults")

    # -- 5. the main path at full size ----------------------------------------------
    frontier_scores.launches = 0
    full = build_and_serve(spec=full_spec, n_db=N_FULL, dim=D_FULL, n_queries=Q_FULL,
                           batch=BATCH, alpha=0.08, device="cuda", verbose=False)
    launches = frontier_scores.launches
    log("main path n=1000000 d=128: " + json.dumps(
        {k: v for k, v in full.items() if k != "spec"}))
    log(f"main path launches: {launches} (build {full['build_kernel_launches']}, timed "
        f"search {full['search_kernel_launches']}, the rest warm-up search)")
    if not (full["build_kernel_launches"] > 0 and full["search_kernel_launches"] > 0):
        raise AssertionError(f"kernel not launched on the main path: {full}")
    if not full["recall@k"] > 0.5:
        raise AssertionError(f"recall@10 {full['recall@k']} <= 0.5 at n=1e6")

    # -- 6. timing at the main path's shapes ---------------------------------------------
    rng = np.random.default_rng(0)  # the data build_and_serve drew for the same seed
    data = lda_like_histograms(rng, N_FULL + Q_FULL, D_FULL, device="cuda")
    Q, rest = split_queries(data, Q_FULL, rng)
    X = rest[:N_FULL]
    del data, rest
    dist = get_distance("kl")
    x_rep, x_bias = dist.prep_left(X).contiguous(), dist.bias_left(X).contiguous()
    qa_rep, qa_bias = dist.prep_right(X).contiguous(), dist.bias_right(X).contiguous()

    def kernel(ids, q_rep, q_bias):
        return frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)

    def plain(ids, q_rep, q_bias):
        return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)

    timings = []
    for label, B, R in TIME_SHAPES:
        q_rep, q_bias = (qa_rep[:B], qa_bias[:B]) if B == N_FULL else (
            dist.prep_right(Q[:B]).contiguous(), dist.bias_right(Q[:B]).contiguous())
        # search steps cycle through 32 id sets, so a step does not find the
        # previous step's rows in L2; an NN-descent round is 1 GB+ of ids
        sets = 32 if B < N_FULL else 1
        args = [(random_ids(gen, B, R, N_FULL), q_rep, q_bias) for _ in range(sets)]
        reps = 320 if sets > 1 else 5
        b_ms, b_by, g_ms = bound(args[0][0], D_FULL)
        row = {"shape": label, "B": B, "R": R,
               "ms": device_ms(kernel, args, reps), "ms_again": device_ms(kernel, args, reps),
               "event_ms": time_ms(kernel, args, reps),
               "bound_ms": b_ms, "bound_by": b_by, "gathered_rows_ms": g_ms}
        # the plain version materialises (B, R, m'): rows beyond 4096 would not fit
        rows = min(B, 4096)
        sub = [(a[0][:rows].contiguous(), a[1][:rows].contiguous(), a[2][:rows].contiguous())
               for a in args]
        row["plain_rows"] = rows
        row["plain_ms"] = device_ms(plain, sub, 64 if sets > 1 else 5)
        row["plain_event_ms"] = time_ms(plain, sub, 64 if sets > 1 else 5)
        if rows < B:
            row["kernel_ms_same_rows"] = device_ms(kernel, sub, 20)
        timings.append(row)
        log(f"time {label}: " + json.dumps(row))
        del args, sub

    # -- 7. profile one full-size build and one search batch -----------------------------
    built = {}
    profile_device(lambda: built.setdefault("idx", ANNIndex.build(
        X, spec=full_spec, generator=torch.Generator(device="cuda").manual_seed(0))),
        "build n=1e6")
    search = built["idx"].searcher()
    search(Q[:BATCH])
    out = {}
    profile_device(lambda: out.setdefault("r", search(Q[BATCH:2 * BATCH])), "search batch of 64")
    d, ids, n_evals, hops = out["r"]
    if not (d.shape == ids.shape == (BATCH, full_spec.k) and bool(torch.isfinite(d).all())
            and bool((ids >= 0).all())):
        raise AssertionError("search results are not finite (64, k) beams")
    log(f"profiled batch: {int(hops.max())} lock-steps, {float(n_evals.float().mean()):.1f} "
        f"evals per query")

    # -- 8. graph quality: why the full-size cell doubles NN ----------------------------
    probe = torch.arange(0, N_FULL, N_FULL // 512, device="cuda")[:512]
    _, true_q = knn_scan(dist, Q[:512], X, 10)
    for nn in (15, full_spec.NN):
        spec = full_spec.replace(NN=nn)
        idx = built["idx"] if nn == full_spec.NN else ANNIndex.build(
            X, spec=spec, generator=torch.Generator(device="cuda").manual_seed(0))
        _, true_nb = knn_scan(dist, X[probe], X, nn + 1)
        hits = 0
        for p, t, g in zip(probe.tolist(), true_nb.tolist(), idx.neighbors[probe, :nn].tolist()):
            hits += len(set([v for v in t if v != p][:nn]) & set(g))
        line = {"NN": nn, "nnd_iters": spec.nnd_iters, "graph_recall@NN": hits / (nn * 512)}
        for ef in (96, 512):
            _, found, evals, _ = idx.searcher(ef_search=ef)(Q[:512])
            line[f"recall@10_ef{ef}"] = recall_at_k(found, true_q)
            line[f"evals_ef{ef}"] = float(evals.float().mean())
        log("graph quality n=1e6 d=128: " + json.dumps(line))

    main_row = timings[0]
    kernels = [{
        "name": "frontier_scores",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_gather.cu",
        "replaces": "src/repro/kernels/frontier_gather.py:95",
        "launches": launches,
        "max_abs_err": max(v for (name, _, _), v in max_err.items() if name == "kl"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "max_abs_err_all_distances": max(max_err.values()),
        "other_shapes": timings[1:],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
