"""Port parity: the partition-spec trees, the mesh launch helpers and the
elastic plans (``repro_torch.sharding.api``, ``launch/mesh.py``,
``launch/elastic.py``) against ``repro``'s.

Every ``param_specs`` tree (each arch's FULL and SMOKE config: dense, MoE
with shared experts, GNN, recsys under all four interactions),
``kv_cache_specs``, ``table_spec``, ``moe_layer_specs``, AdamW's
``state_specs`` and ``adafactor_state_specs`` equal ``repro``'s exactly,
each spec read as a tuple of entries (a one-name tuple as the name, as JAX
normalises it).  ``launch/elastic.py`` gives ``repro``'s plans on
``tests/test_elastic.py``'s inputs.  A production mesh raises on a group of
4 ranks (an in-process fake group) and builds on 256.
"""

import jax
import pytest
import torch.distributed as tdist
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import elastic as jelastic
from repro.models import embedding as jembedding
from repro.models import gnn as jgnn
from repro.models import moe as jmoe
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.launch import elastic, mesh as tmesh
from repro_torch.models import embedding, gnn, moe, recsys, transformer
from repro_torch.sharding.api import flatten
from repro_torch.train import optimizer as topt

MODULES = {"lm": (jtransformer, transformer), "gnn": (jgnn, gnn), "recsys": (jrecsys, recsys)}


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _jnorm(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, spec in leaves:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = tuple(_entry(e) for e in spec)
    return out


def _pnorm(tree) -> dict:
    return {k: tuple(_entry(e) for e in s) for k, s in flatten(tree).items()}


CASES = [(arch, smoke) for arch in jconfigs.ARCH_IDS for smoke in (False, True)]


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_specs_equal_repro(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
    jmod, tmod = MODULES[configs.get_family(arch)]
    want, got = _jnorm(jmod.param_specs(jcfg)), _pnorm(tmod.param_specs(tcfg))
    assert got == want
    if configs.get_family(arch) == "lm":  # TP-only serving specs too
        assert (_pnorm(tmod.param_specs(tcfg, fsdp_axis=None))
                == _jnorm(jmod.param_specs(jcfg, fsdp_axis=None)))


def test_param_specs_cover_every_parameter():
    """The spec trees name exactly the port's parameters (MoE with shared
    experts, and each recsys interaction)."""
    for arch in ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b", "gemma3-12b", "gcn-cora",
                 "two-tower-retrieval", "autoint", "din", "dcn-v2"):
        cfg = configs.get_smoke_config(arch)
        tmod = MODULES[configs.get_family(arch)][1]
        params = dict(tmod.init_params(cfg, device="cpu").named_parameters())
        specs = flatten(tmod.param_specs(cfg))
        assert set(specs) == set(params), arch
        for k, p in params.items():
            assert len(specs[k]) <= p.ndim, (arch, k)


@pytest.mark.parametrize("kw", [{}, dict(seq_axes=("data", "model"), batch_axes=()),
                                dict(seq_axes=("model",), batch_axes=("pod", "data"))])
def test_kv_cache_specs_equal_repro(kw):
    assert _pnorm(transformer.kv_cache_specs(**kw)) == _jnorm(jtransformer.kv_cache_specs(**kw))


@pytest.mark.parametrize("kw", [{}, dict(fsdp_axis="data"), dict(tp_axis="data")])
def test_table_spec_equals_repro(kw):
    assert _pnorm(embedding.table_spec(**kw)) == _jnorm(jembedding.table_spec(**kw))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_moe_layer_specs_equal_repro(arch):
    for fsdp, tp in (("data", "model"), (None, "model")):
        got = moe.moe_layer_specs(configs.get_config(arch), fsdp, tp)
        assert _pnorm(got) == _jnorm(jmoe.moe_layer_specs(jconfigs.get_config(arch), fsdp, tp))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b", "dcn-v2"])
def test_optimizer_state_specs_equal_repro(arch):
    family = configs.get_family(arch)
    jmod, tmod = MODULES[family]
    jcfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    lr = topt.warmup_cosine(1e-3, 1, 10)
    jlr = jopt.warmup_cosine(1e-3, 1, 10)
    assert (_pnorm(topt.adamw(lr).state_specs(tmod.param_specs(tcfg)))
            == _jnorm(jopt.adamw(jlr).state_specs(jmod.param_specs(jcfg))))
    with pytest.raises(NotImplementedError, match="adafactor_state_specs"):
        topt.adafactor(lr).state_specs(tmod.param_specs(tcfg))
    # Adafactor factors the trailing two axes of a weight at least this wide
    for min_dim in (128, 8):
        jparams = jmod.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = dict(tmod.init_params(tcfg, device="cpu").named_parameters())
        got = topt.adafactor_state_specs(tparams, tmod.param_specs(tcfg), min_dim)
        want = jopt.adafactor_state_specs(jparams, jmod.param_specs(jcfg), min_dim)
        assert _pnorm(got) == _jnorm(want)


def _manifest(n_entries=2, n_chunks=8):
    return {"entries": {f"params/w{i}": {"chunks": [{"file": f"w{i}_{c}.msgpack"}
                                                    for c in range(n_chunks)]}
                        for i in range(n_entries)}}


@pytest.mark.parametrize("hosts", [(4, 4), (4, 2), (2, 4), (3, 5), (8, 1)])
def test_reshard_plan_equals_repro(hosts):
    for n_entries, n_chunks in ((1, 8), (2, 8), (3, 5)):
        m = _manifest(n_entries, n_chunks)
        got = [tuple(vars(mv).values()) for mv in elastic.reshard_plan(m, *hosts)]
        assert got == [tuple(vars(mv).values()) for mv in jelastic.reshard_plan(m, *hosts)]


@pytest.mark.parametrize("args", [(256, 16, 16, 256, 1), (512, 40, 16, 512, 2),
                                  (64, 4, 8, 96, 3), (16, 8, 16, 256, 1)])
def test_shrink_mesh_equals_repro(args):
    n, failed, model_axis, global_batch, accum = args
    kw = dict(failed=failed, model_axis=model_axis, global_batch=global_batch, accum=accum)
    try:
        want = jelastic.shrink_mesh(n, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            elastic.shrink_mesh(n, **kw)
        return
    assert elastic.shrink_mesh(n, **kw) == want


def test_shard_replica_map_equals_repro():
    for n_shards, r, hosts in ((8, 2, 8), (4, 3, 6), (5, 2, 7)):
        t, j = elastic.ShardReplicaMap(n_shards, r), jelastic.ShardReplicaMap(n_shards, r)
        for dead in ((), (0,), (3, 4), (0, 4), (1, 2, 3)):
            assert t.survives(hosts, dead) == j.survives(hosts, dead)
            for s in range(n_shards):
                assert t.hosts_for(s, hosts) == j.hosts_for(s, hosts)
                assert t.recovery_sources(s, hosts, dead) == j.recovery_sources(s, hosts, dead)


@pytest.fixture
def fake_group():
    """An in-process fake group (``torch.distributed``'s test backend): any
    world size, collectives that do nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world: int):
        tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield init
    if tdist.is_initialized():
        tdist.destroy_process_group()


def test_production_mesh_raises_on_4_ranks(fake_group):
    fake_group(4)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    debug = tmesh.make_debug_mesh()
    assert debug.shape == {"data": 2, "model": 2} and debug.coords == (0, 0)


def test_production_mesh_builds_on_256_ranks(fake_group):
    fake_group(256)
    m = tmesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert m.axis_index("data") == 0 and m.index(("model", "data")) == 0
    # the card's constants, not v5e's
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.HBM_PER_CHIP) == (989e12, 3.35e12, 80e9)
    assert not hasattr(tmesh, "ICI_BW")
    assert m.size_of(("data", "model")) == 256
