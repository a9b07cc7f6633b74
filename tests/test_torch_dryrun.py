"""Port parity: the dry run (``repro_torch.launch.{cells,roofline,dryrun,
report}``) against ``repro.launch``'s.

  * ``list_cells()`` equals ``repro``'s: ids, kinds and skip reasons.
  * Every runnable cell's analytic fields (MODEL_FLOPS, the analytic FLOPs
    and bytes, tokens, optimizer, accumulation steps, parameter (+ state)
    bytes, loop hints, KV bytes, serving mode, embedding gather bytes) on
    both production meshes equal ``repro``'s to rel 1e-12.  The oracle is one
    JAX subprocess with 512 forced host devices running ``repro``'s
    ``build_cell`` on ``jax.make_mesh``; the port builds the same cells on
    the meta device for rank 0 of an in-process ``fake`` group of 256 and
    512 ranks.
  * ``Roofline`` and ``build_roofline`` give ``repro``'s numbers when both run
    on ``repro``'s constants (one link rate for every collective).
  * ``roofline_table`` and ``pick_hillclimb_cells`` give ``repro``'s text and
    picks on records carrying the fields both read; the memory column (the
    port's peak, reckoned or measured, under its own heading) is the one
    difference.
  * A meta ``run_cell`` of ``gcn-cora::molecule`` and
    ``llama3.2-1b::decode_32k`` on the 256-rank mesh comes back ``ok``, its
    counted collective bytes by kind equal to a reckoning from the cell's
    specs written out below, and ``collective_totals`` applies ``repro``'s
    wire factors to them.
  * No fallback hides the device or a backend: ``--device cuda`` without a
    card raises, and so does a counted collective under an unknown backend.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as tdist

from repro_torch.configs import get_config
from repro_torch.core import distributed as cd
from repro_torch.launch import cells, dryrun, report, roofline
from repro_torch.launch import mesh as tmesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
FIELDS = ("model_flops", "analytic_flops", "analytic_bytes", "tokens", "opt", "accum_steps",
          "param_bytes", "loop_hints", "kv_bytes", "serve_params", "embed_gather_bytes")

JAX_ORACLE = f"""
import json, sys
import jax
from repro.launch import cells
from repro.sharding.api import use_mesh

out = {{"cells": [[c.cell_id, c.kind, c.skip_reason] for c in cells.list_cells()]}}
for name, multi in {MESHES!r}.items():
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    mesh = jax.make_mesh(shape, axes)
    rows = {{}}
    for c in cells.list_cells():
        if c.skip_reason:
            continue
        with use_mesh(mesh):
            built = cells.build_cell(c, mesh)
        rows[c.cell_id] = {{k: built[k] for k in {FIELDS!r} if k in built}}
    out[name] = rows
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "repro.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_ORACLE, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.fixture
def fake_mesh():
    """A production (or debug) mesh over an in-process fake group."""
    yield dryrun.make_mesh
    if tdist.is_initialized():
        tdist.destroy_process_group()


def test_list_cells_equals_repro(oracle):
    got = [[c.cell_id, c.kind, c.skip_reason] for c in cells.list_cells()]
    assert got == oracle["cells"]
    assert len(got) == 40 and sum(s is not None for _, _, s in got) == 4


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1e-12 * max(abs(a), abs(b))
    return a == b


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_analytic_fields_equal_repro(oracle, fake_mesh, mesh_name):
    """All 36 runnable cells, built on the meta device for rank 0."""
    mesh = fake_mesh(mesh_name)
    want = oracle[mesh_name]
    runnable = [c for c in cells.list_cells() if not c.skip_reason]
    assert len(runnable) == len(want) == 36
    for c in runnable:
        built = cells.build_cell(c, mesh, device="meta")
        got = {k: built[k] for k in FIELDS if k in built}
        assert got.keys() == want[c.cell_id].keys(), c.cell_id
        for k, v in want[c.cell_id].items():
            g = list(got[k]) if isinstance(got[k], tuple) else got[k]
            assert _close(g, v), (c.cell_id, k, g, v)


REPRO_CONSTANTS = dict(PEAK_FLOPS_BF16=197e12, HBM_BW=819e9, NVLINK_BW=50e9, NET_BW=50e9)


@pytest.mark.parametrize("totals", [
    {"all-gather": 3.5e9, "all-reduce": 1.25e10, "reduce-scatter": 7e8},
    {"all-reduce": 2e3, "_n_instructions": 4},
    {"all-gather": 1e11, "all-to-all": 5e9, "collective-permute": 2e8, "_net_bytes": 0.0}])
def test_roofline_arithmetic_equals_repro(monkeypatch, totals):
    from repro.launch import roofline as jroofline

    for name, value in REPRO_CONSTANTS.items():
        monkeypatch.setattr(roofline, name, value)
    kw = dict(model_flops=3.1e18, hlo_bytes_per_chip=4.2e10, collective_totals=totals,
              n_chips=256, analytic_flops=3.3e18)
    got, want = roofline.build_roofline(**kw), jroofline.build_roofline(**kw)
    for key, value in want.as_dict().items():
        assert got.as_dict()[key] == value, key
    assert got.bound_s == want.bound_s
    r, j = roofline.Roofline(1e12, 2e9, 3e8, 512), jroofline.Roofline(1e12, 2e9, 3e8, 512)
    assert (r.compute_s, r.memory_s, r.collective_s, r.dominant) == (
        j.compute_s, j.memory_s, j.collective_s, j.dominant)


def test_roofline_uses_the_cards_links():
    """Bytes over groups that span nodes move at NET_BW, the rest at NVLINK_BW."""
    r = roofline.Roofline(0.0, 0.0, 9e9, 256, net_bytes_per_chip=4e9)
    assert r.collective_s == pytest.approx(5e9 / tmesh.NVLINK_BW + 4e9 / tmesh.NET_BW)
    assert (tmesh.NVLINK_BW, tmesh.NET_BW, tmesh.CARDS_PER_NODE) == (450e9, 50e9, 8)


def _records():
    """Records carrying both packages' memory fields, the same bytes in each."""
    rows = [("yi-34b", "train_4k", "train", 2.1, 0.3, 4.0, 6.1e10, True, 0.91),
            ("llama3.2-1b", "decode_32k", "decode", 1e-5, 2e-3, 3.6e-3, 1.2e9, True, 0.37),
            ("din", "retrieval_cand", "retrieval", 3e-4, 1e-1, 3e-1, 1.0e11, False, None),
            ("two-tower-retrieval", "retrieval_cand", "retrieval", 2e-6, 1e-5, 1e-6, 2.7e8,
             True, 0.5)]
    recs = []
    for arch, shape, kind, c, m, k, peak, fits, ratio in rows:
        recs.append({"arch": arch, "shape": shape, "kind": kind, "status": "ok",
                     "roofline": {"compute_s": c, "memory_s": m, "collective_s": k,
                                  "dominant": max(("compute", c), ("memory", m),
                                                  ("collective", k), key=lambda t: t[1])[0]},
                     "memory_analysis": {"tpu_true_estimate_bytes": peak, "fits": fits},
                     "memory": {"peak_bytes": peak, "fits": fits, "peak_source": "reckoned"},
                     "useful_flops_ratio": ratio})
    recs.append({"arch": "kimi-k2-1t-a32b", "shape": "long_500k", "kind": "decode",
                 "status": "skipped", "skip_reason": "pure full-attention arch: long_500k "
                                                     "requires sub-quadratic attention"})
    recs.append({"arch": "gcn-cora", "shape": "molecule", "kind": "train", "status": "error",
                 "error": "RuntimeError: something failed in the step of this cell"})
    return recs


def test_report_equals_repro_but_the_memory_column():
    from repro.launch import report as jreport

    recs = _records()
    got = report.roofline_table(recs).splitlines()
    want = jreport.roofline_table(recs).splitlines()
    assert got[0] == want[0].replace("mem/chip (tpu-est)", "mem/card (reckoned)")
    assert got[1:] == want[1:]
    assert report.pick_hillclimb_cells(recs) == jreport.pick_hillclimb_cells(recs)
    for r in recs[:2]:
        r["memory"]["peak_source"] = "measured"
    mixed = report.roofline_table(recs).splitlines()
    assert "m = measured, r = reckoned" in mixed[0] and " m |" in mixed[2]
    # both meshes side by side: one row per cell, each mesh's columns as above
    both = report.meshes_table({"16x16": recs, "2x16x16": recs[:-1]}).splitlines()
    assert len(both) == 2 + len(recs)
    assert all(len(line.split("|")) == len(both[0].split("|")) for line in both)
    for line, row in zip(both[2:6], mixed[2:6]):
        cells = row.split("|")[4:-1]
        assert line.split("|")[4:-1] == cells + cells
    assert "ERROR" in both[-1] and both[-1].rstrip(" |").endswith("-")


def _llama_decode_collectives(mesh) -> dict:
    """Counted bytes by kind of one llama3.2-1b decode_32k step on rank 0 of
    the (16, 16) mesh, from the serving specs (FSDP over "data", TP over
    "model") and the cell's shapes: 8 sequences per rank, bf16 weights."""
    cfg = get_config("llama3.2-1b")
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    d, L, dh, V = cfg.d_model, cfg.n_layers, cfg.d_head, cfg.vocab_size
    hq, hkv, ff = cfg.n_heads * dh, cfg.n_kv_heads * dh, cfg.d_ff
    b, bf, f32 = 128 // dp, 2, 4
    embed = V // tp * d * bf  # the vocab block gathered over "data" (lookup; tied head)
    per_layer_fsdp = ((d * hq // tp + d * hkv // tp * 2) * bf  # wq, wk, wv blocks
                      + hq // tp * d * bf  # wo
                      + 3 * d * ff // tp * bf)  # w_gate, w_up, w_down
    per_layer_tp = (b * hq + 2 * b * hkv) * bf  # the step's q, k, v over "model"
    per_layer_psum = (b * cfg.n_heads * dh * f32 + b * cfg.n_heads * f32  # the LSE combine
                      + 2 * b * d * bf)  # wo's and w_down's row-parallel sums
    return {"fsdp_gather": 2 * embed + L * per_layer_fsdp,
            "all_gather": L * per_layer_tp + b * V * bf,  # q, k, v; the logits
            "psum": b * d * bf + L * per_layer_psum,  # the lookup's sum, then the layers
            "pmax": L * b * cfg.n_heads * f32}


def test_meta_run_cells_count_the_reckoned_collectives(fake_mesh, tmp_path):
    mesh = fake_mesh("single_pod_16x16")
    by_id = {c.cell_id: c for c in cells.list_cells()}
    recs = {cid: dryrun.run_cell(by_id[cid], mesh, "single_pod_16x16", str(tmp_path), "meta")
            for cid in ("gcn-cora::molecule", "llama3.2-1b::decode_32k")}
    for cid, rec in recs.items():
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory"]["peak_source"] == "reckoned" and rec["memory"]["fits"]
        assert rec["counted_flops_per_chip"] > 0
        assert json.loads((tmp_path / f"{cid.replace('::', '__')}__single_pod_16x16.json")
                          .read_text())["status"] == "ok"
    # the GCN's weights are replicated: one psum of the loss (pmean over
    # "data"), one per weight's gradient (its pvary's backward)
    gcn = recs["gcn-cora::molecule"]["collective_calls"]
    n_w = 16 * 16 + 16 + 16 * 2 + 2  # d_feat 16 -> hidden 16 -> 2 classes, with biases
    assert {k: v["bytes"] for k, v in gcn.items()} == {"psum": 4 + 4 * n_w}
    assert gcn["psum"]["calls"] == 5
    llama = recs["llama3.2-1b::decode_32k"]
    want = _llama_decode_collectives(mesh)
    assert {k: v["bytes"] for k, v in llama["collective_calls"].items()} == want
    for kind, v in llama["collective_calls"].items():
        assert [(g["size"], g["spans_nodes"]) for g in v["groups"]] == [(16, True)]
    g = 16
    assert llama["collectives"]["all-gather"] == pytest.approx(
        (want["all_gather"] + want["fsdp_gather"]) * (g - 1) / g)
    assert llama["collectives"]["all-reduce"] == pytest.approx(
        (want["psum"] + want["pmax"]) * 2 * (g - 1) / g)
    assert llama["collectives"]["_net_bytes"] == pytest.approx(
        sum(v for k, v in llama["collectives"].items() if not k.startswith("_")))


def test_no_fallback_hides_the_device_or_the_backend(fake_mesh, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(["--device", "cuda", "--arch", "gcn-cora", "--shape", "molecule"])
    fake_mesh("debug_4x4")
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        cd.all_reduce(torch.ones(2))
