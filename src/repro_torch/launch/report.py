"""Render the dry-run / roofline tables from the port's dry-run records
(PyTorch port of ``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single_pod_16x16|both]

The table is ``repro``'s but for the memory column: the rank's peak bytes
per card from the port's record, measured on the card where it ran
(``dryrun --device cuda``) and reckoned on the meta device otherwise; the
heading says which (``m`` / ``r`` beside each value when a table mixes
them).  ``repro``'s ``tpu_true_estimate_bytes`` (XLA:CPU's temp scaled by
0.55) has no counterpart.  The last column keeps ``repro``'s heading; the
port's ratio is MODEL_FLOPS over the rank's counted FLOPs times the ranks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_records(art_dir: str, mesh: str):
    recs = []
    for path in sorted(glob.glob(os.path.join(art_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("TiB", 2**40), ("GiB", 2**30), ("MiB", 2**20)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def _memory_heading(recs) -> tuple:
    """(the memory column's heading, whether each value carries m / r)."""
    sources = {r["memory"]["peak_source"] for r in recs if r["status"] == "ok"}
    if sources == {"measured"}:
        return "mem/card (measured)", False
    if sources <= {"reckoned"}:
        return "mem/card (reckoned)", False
    return "mem/card (m = measured, r = reckoned)", True


def roofline_table(recs, show_skipped=True):
    heading, marked = _memory_heading(recs)
    lines = [
        "| arch | shape | kind | compute | memory | collective | dominant |"
        f" {heading} | fits | MODEL/HLO flops |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            if show_skipped:
                lines.append(
                    f"| {r['arch']} | {r['shape']} | - | - | - | - | skipped |"
                    f" - | - | {r['skip_reason'][:40]}... |")
            continue
        if r["status"] == "error":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['kind']} "
                         f"| ERROR | | | | | | {r['error'][:50]} |")
            continue
        rl = r["roofline"]
        mem = r["memory"]
        peak = fmt_b(mem["peak_bytes"]) + (f" {mem['peak_source'][0]}" if marked else "")
        ratio = r.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {fmt_s(rl['compute_s'])} | {fmt_s(rl['memory_s'])} "
            f"| {fmt_s(rl['collective_s'])} | **{rl['dominant']}** "
            f"| {peak} "
            f"| {'Y' if mem['fits'] else 'N'} "
            f"| {ratio:.2f} |" if ratio else
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {fmt_s(rl['compute_s'])} | {fmt_s(rl['memory_s'])} "
            f"| {fmt_s(rl['collective_s'])} | **{rl['dominant']}** "
            f"| {peak} "
            f"| {'Y' if mem['fits'] else 'N'} | - |"
        )
    return "\n".join(lines)


def meshes_table(recs_by_mesh: dict, show_skipped=True):
    """One row per cell, ``roofline_table``'s columns for each mesh side by
    side (``recs_by_mesh``: {mesh tag: its records}; cells matched by arch
    and shape, in the first mesh's order)."""
    heads = {tag: _memory_heading(recs) for tag, recs in recs_by_mesh.items()}
    cols = lambda tag: ["compute", "memory", "collective", "dominant",  # noqa: E731
                        heads[tag][0], "fits", "MODEL/HLO flops"]
    by_cell = {}
    for tag, recs in recs_by_mesh.items():
        for r in recs:
            by_cell.setdefault((r["arch"], r["shape"]), {})[tag] = r
    n_cols = 3 + sum(len(cols(t)) for t in recs_by_mesh)
    lines = ["| arch | shape | kind | " + " | ".join(f"{t} {c}" for t in recs_by_mesh
                                                   for c in cols(t)) + " |",
             "|" + "---|" * n_cols]
    for (arch, shape), rows in by_cell.items():
        first = next(iter(rows.values()))
        if first["status"] == "skipped":
            if show_skipped:
                lines.append(f"| {arch} | {shape} | - | skipped |" + " |" * (n_cols - 4))
            continue
        cells = [arch, shape, first["kind"]]
        for tag in recs_by_mesh:
            r = rows.get(tag)
            if r is None or r["status"] != "ok":
                cells += ["ERROR" if r else "-"] + [""] * (len(cols(tag)) - 1)
                continue
            rl, mem, ratio = r["roofline"], r["memory"], r.get("useful_flops_ratio")
            mark = f" {mem['peak_source'][0]}" if heads[tag][1] else ""
            cells += [fmt_s(rl["compute_s"]), fmt_s(rl["memory_s"]), fmt_s(rl["collective_s"]),
                      f"**{rl['dominant']}**", fmt_b(mem["peak_bytes"]) + mark,
                      "Y" if mem["fits"] else "N", f"{ratio:.2f}" if ratio else "-"]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def pick_hillclimb_cells(recs):
    """worst roofline fraction, most collective-bound, most paper-representative."""
    ok = [r for r in recs if r["status"] == "ok"]

    def frac(r):  # useful compute / bound time (roofline fraction proxy)
        rl = r["roofline"]
        bound = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        return rl["compute_s"] / bound if bound else 1.0

    worst = min(ok, key=frac)
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
               / max(r["roofline"]["compute_s"], 1e-12))
    paper = next((r for r in ok if r["arch"] == "two-tower-retrieval"
                  and r["shape"] == "retrieval_cand"), ok[0])
    return {"worst_fraction": worst, "most_collective": coll,
            "paper_representative": paper}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--art-dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="single_pod_16x16",
                    help="a mesh's records, or 'both': the two production meshes side by side")
    args = ap.parse_args(argv)
    if args.mesh == "both":
        both = {"16x16": load_records(args.art_dir, "single_pod_16x16"),
                "2x16x16": load_records(args.art_dir, "multi_pod_2x16x16")}
        print("## Roofline - single_pod_16x16 and multi_pod_2x16x16\n")
        print(meshes_table(both))
        return
    recs = load_records(args.art_dir, args.mesh)
    if not recs:
        raise SystemExit(f"no records for mesh {args.mesh} in {args.art_dir}")
    print(f"## Roofline - {args.mesh} ({len(recs)} cells)\n")
    print(roofline_table(recs))
    picks = pick_hillclimb_cells(recs)
    print("\nhillclimb picks:")
    for why, r in picks.items():
        print(f"  {why}: {r['arch']}::{r['shape']} "
              f"(dominant={r['roofline']['dominant']})")


if __name__ == "__main__":
    main()
