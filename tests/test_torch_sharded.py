"""Port parity: ``build_sharded`` on ``torch.distributed`` against
``repro.core.build_engine.build_sharded``.

The JAX package builds under ``shard_map`` on 2 forced host devices in a
subprocess (the device count must be set before JAX starts, as in
``tests/test_multidevice.py``); the port builds in a 2-rank gloo group
spawned with ``torch.multiprocessing``, each rank holding its block of rows.
The JAX package's per-shard ``jax.random`` draws (the cross-link samples,
and the NN-descent draws) are replayed into the port.  The stitched
adjacency must be exactly equal (tolerance 0: integer ids), for the wave
and the NN-descent builders.  World size 1 is compared with JAX's
1-device mesh in this process, and a corpus that does not split into equal
shards raises ``ValueError``.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from repro.core import build_sharded, get_distance
from repro.data.synthetic import lda_like_histograms
from repro_torch.core import build_engine as tbe
from repro_torch.core import distances as td

from test_torch_nndescent import replay_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, DIM, NN, WAVE, CROSS, SAMPLE, NND_ITERS = 256, 16, 8, 16, 3, 16, 4
KEY = 5

JAX_2_DEVICES = f"""
import jax, numpy as np
from repro.core import build_sharded, get_distance
from repro.data.synthetic import lda_like_histograms
mesh = jax.make_mesh((2,), ("data",))
X = lda_like_histograms(jax.random.PRNGKey(0), {N}, {DIM})
out = {{}}
for builder in ("wave", "nndescent"):
    out[builder] = np.asarray(jax.device_get(build_sharded(
        mesh, get_distance("kl"), X, NN={NN}, builder=builder, wave={WAVE},
        nnd_iters={NND_ITERS}, cross_links={CROSS}, sample_per_shard={SAMPLE},
        key=jax.random.PRNGKey({KEY}))))
np.savez(__import__("sys").argv[1], X=np.asarray(X), **out)
"""


def _jax_draws(shards: int):
    """Per shard: the cross-link sample indices and the NN-descent draws that
    JAX's ``build_sharded`` takes from ``fold_in(key, shard)``."""
    n_local = N // shards
    key = jax.random.PRNGKey(KEY)
    draws = []
    for shard in range(shards):
        k_shard = jax.random.fold_in(key, shard)
        sample = jax.random.choice(jax.random.fold_in(k_shard, 1), n_local,
                                   (min(SAMPLE, n_local),), replace=False)
        nnd = replay_draws(k_shard, n_local, NN, NND_ITERS, 8, 2 * NN)
        draws.append((np.asarray(sample, np.int64), [np.asarray(a) for a in nnd]))
    return draws


def _port_build(rank, world, X, draws, builder):
    sample, nnd = draws[rank]
    return tbe.build_sharded(
        td.get_distance("kl"), tbe.shard_rows(torch.from_numpy(np.array(X)), rank, world), NN=NN,
        builder=builder, wave=WAVE, nnd_iters=NND_ITERS, cross_links=CROSS,
        sample_per_shard=SAMPLE, sample_idx=torch.from_numpy(sample),
        nnd_draws=_nnd_draws(nnd))


def _nnd_draws(arrays):
    from repro_torch.core.nndescent import NNDescentDraws

    return NNDescentDraws(*(torch.from_numpy(a) for a in arrays))


def _rank_main(rank, world, store, X, draws, out_dir):
    """One rank of the spawned gloo group: both builders, then the refusal
    of unequal shards; results go to ``out_dir``."""
    tdist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                             world_size=world)
    try:
        for builder in ("wave", "nndescent"):
            np.save(f"{out_dir}/{builder}{rank}.npy", _port_build(rank, world, X, draws,
                                                                  builder).numpy())
        # rank 1 holds one row fewer: every rank refuses
        try:
            tbe.build_sharded(td.get_distance("kl"), torch.from_numpy(X[:64 - rank]), NN=4)
        except ValueError as e:
            np.save(f"{out_dir}/refused{rank}.npy", np.array([str(e).startswith(
                "build_sharded needs n")]))
    finally:
        tdist.destroy_process_group()


def test_two_ranks_equal_jax_two_devices(tmp_path):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    want_path = tmp_path / "jax.npz"
    proc = subprocess.run([sys.executable, "-c", JAX_2_DEVICES, str(want_path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    want = np.load(want_path)
    X = want["X"]
    tmp.start_processes(_rank_main, args=(2, str(tmp_path / "store"), X, _jax_draws(2),
                                          str(tmp_path)),
                        nprocs=2, join=True, start_method="spawn")
    for builder in ("wave", "nndescent"):
        got = np.concatenate([np.load(tmp_path / f"{builder}{r}.npy") for r in range(2)])
        assert got.shape == (N, 2 * NN + CROSS) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want[builder], err_msg=builder)
        # the cross links reach the other shard
        cross = got[:, -CROSS:]
        shard = np.arange(N) // (N // 2)
        assert (cross >= 0).all() and (cross // (N // 2) != shard[:, None]).all()
    assert all(np.load(tmp_path / f"refused{r}.npy")[0] for r in range(2))


@pytest.fixture
def one_rank_group(tmp_path):
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                             world_size=1)
    yield
    tdist.destroy_process_group()


def test_one_rank_equals_jax_one_device(one_rank_group):
    X = lda_like_histograms(jax.random.PRNGKey(0), N, DIM)
    mesh = jax.make_mesh((1,), ("data",))
    want = np.asarray(build_sharded(mesh, get_distance("kl"), X, NN=NN, builder="wave",
                                    wave=WAVE, cross_links=CROSS, sample_per_shard=SAMPLE,
                                    key=jax.random.PRNGKey(KEY)))
    got = _port_build(0, 1, X, _jax_draws(1), "wave").numpy()
    np.testing.assert_array_equal(got, want)
    # one shard: every sampled row is the rank's own, so no cross link
    assert (got[:, -CROSS:] == -1).all()


def test_shard_rows_refuses_a_ragged_split():
    X = torch.zeros((10, 3))
    assert tbe.shard_rows(X, 1, 2).shape == (5, 3)
    with pytest.raises(ValueError, match="divisible"):
        tbe.shard_rows(X, 0, 3)


def test_unknown_builder_raises(one_rank_group):
    with pytest.raises(ValueError, match="unknown sharded builder"):
        tbe.build_sharded(td.get_distance("kl"), torch.zeros((8, 4)), builder="hnsw")
