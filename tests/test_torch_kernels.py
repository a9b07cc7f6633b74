"""Port parity: the frontier-gather kernel's plain version and its dispatch.

The port's ``gather_scores_ref`` is held to the JAX package's Pallas kernel
``frontier_scores`` (interpret mode, as the JAX tests run it on the CPU) and
to the JAX oracle ``repro.kernels.ref.gather_scores_ref``, for every
post-combine id and with -1 padding.  Tolerance rtol = atol = 1e-5: float32
dot products summed in different orders, nothing else differs.

The CUDA kernel itself runs only on the card: ``tests/test_torch_gpu.py``.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro.kernels import ref as jref
from repro.kernels.frontier_gather import frontier_scores as jax_frontier_scores
from repro_torch.core import distances as td
from repro_torch.kernels import build, ops
from repro_torch.kernels.frontier_gather import frontier_scores
from repro_torch.kernels.ref import gather_scores_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
# one distance per post-combine id: LINEAR, RENYI, NEG, L2 (+ a second LINEAR)
POST_DISTS = ["kl", "renyi_0.25", "negdot", "l2", "itakura_saito"]


def _hist(rng, n, m):
    x = rng.dirichlet(np.full(m, 0.3), size=n).astype(np.float32)
    x = np.maximum(x, np.float32(1e-6))
    return x / x.sum(axis=1, keepdims=True)


def _inputs(name, B=5, R=12, n=40, m=16, seed=0):
    """Prepped numpy reps for ``name`` plus (B, R) ids with -1 padding."""
    rng = np.random.default_rng(seed)
    Q, X = _hist(rng, B, m), _hist(rng, n, m)
    dist = jd.get_distance(name)
    reps = dict(
        q_rep=np.asarray(dist.prep_right(jnp.asarray(Q))),
        q_bias=np.asarray(dist.bias_right(jnp.asarray(Q))),
        x_rep=np.asarray(dist.prep_left(jnp.asarray(X))),
        x_bias=np.asarray(dist.bias_left(jnp.asarray(X))),
    )
    ids = rng.integers(0, n, (B, R)).astype(np.int32)
    ids[rng.random((B, R)) < 0.25] = -1
    ids[0, :] = -1  # a fully padded row
    ids[1, :3] = ids[1, 3]  # repeated ids in one row
    return dist, ids, reps


def _torch(a):
    return torch.from_numpy(np.array(a))  # a writable copy of a JAX-owned buffer


@pytest.mark.parametrize("name", POST_DISTS)
def test_plain_version_matches_pallas_kernel_and_jax_oracle(name):
    dist, ids, r = _inputs(name)
    got = gather_scores_ref(_torch(ids), _torch(r["q_rep"]), _torch(r["x_rep"]),
                            _torch(r["q_bias"]), _torch(r["x_bias"]),
                            dist.post_id, dist.c0).numpy()
    pallas = np.asarray(jax_frontier_scores(
        jnp.asarray(ids), jnp.asarray(r["q_rep"]), jnp.asarray(r["q_bias"]),
        jnp.asarray(r["x_rep"]), jnp.asarray(r["x_bias"]), dist.post_id, dist.c0,
        interpret=True))
    oracle = np.asarray(jref.gather_scores_ref(
        jnp.asarray(ids), jnp.asarray(r["q_rep"]), jnp.asarray(r["x_rep"]),
        jnp.asarray(r["q_bias"]), jnp.asarray(r["x_bias"]), dist.post_id, dist.c0))
    assert got.dtype == np.float32 and got.shape == ids.shape
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("name", POST_DISTS)
def test_ops_takes_plain_path_on_cpu_without_launching(name):
    dist, ids, r = _inputs(name, seed=1)
    tdist = td.get_distance(name)
    before = frontier_scores.launches
    got = ops.frontier_gather_scores(tdist, _torch(ids), _torch(r["q_rep"]),
                                     _torch(r["q_bias"]), _torch(r["x_rep"]),
                                     _torch(r["x_bias"]))
    assert frontier_scores.launches == before
    want = gather_scores_ref(_torch(ids), _torch(r["q_rep"]), _torch(r["x_rep"]),
                             _torch(r["q_bias"]), _torch(r["x_bias"]),
                             tdist.post_id, tdist.c0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    dist, ids, r = _inputs("kl")
    with pytest.raises(ValueError, match="CUDA"):
        frontier_scores(_torch(ids), _torch(r["q_rep"]), _torch(r["q_bias"]),
                        _torch(r["x_rep"]), _torch(r["x_bias"]), dist.post_id)


def test_importing_the_kernel_modules_needs_no_nvcc(tmp_path):
    """Import + the CPU path with no nvcc anywhere: nothing is built."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import ops, build\n"
        "from repro_torch.kernels.frontier_gather import frontier_scores\n"
        "from repro_torch.core.distances import get_distance\n"
        "ids = torch.tensor([[0, -1]], dtype=torch.int32)\n"
        "q = torch.ones(1, 4); x = torch.ones(3, 4)\n"
        "d = ops.frontier_gather_scores(get_distance('negdot'), ids, q, torch.zeros(1),"
        " x, torch.zeros(3))\n"
        "assert d.tolist() == [[-4.0, float('inf')]], d\n"
        "assert frontier_scores.launches == 0\n"
        "try:\n"
        "    build._nvcc()\n"
        "except RuntimeError:\n"
        "    print('no-nvcc-ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no-nvcc-ok" in out.stdout


def test_build_targets_hopper_and_writes_under_build():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    lib = build.library_path("frontier_gather")
    assert lib.parent == ROOT / "build" / "repro_torch"
    assert (build.CSRC / "frontier_gather.cu").is_file()
