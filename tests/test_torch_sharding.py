"""The port's mesh and rules (``repro_torch.parallel.sharding``,
``repro_torch.launch.mesh``) against the reference's.

The reference resolves on ``jax.sharding.AbstractMesh`` (no devices);
the port on a ``DeviceMesh`` of the same shape and names, built without
its subgroups inside a one-rank gloo group (any size: a (2, 16, 16) mesh
needs no 512 ranks to be resolved against). The mesh builders run in a
one-rank group and in one spawned group of four ranks
(``test_torch_ranks.run_ranks``). Specs compare as tuples, entry for entry.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train.step import abstract_state as jabstract_state  # noqa: E402
from repro_torch.configs import get_smoke as tget_smoke  # noqa: E402
from repro_torch.launch import mesh as tlaunch  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.train.step import abstract_state as tabstract_state  # noqa: E402
from test_torch_ranks import one_rank_group, run_ranks  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}

# (logical names, shape): Qwen2's 28 heads on a 16-way model axis, a
# batch of 8 on data=16, axes already used, None names, the cache and
# shard dims, and the param table's names
GRID = [
    (("batch", "seq", "heads", "head_dim"), (8, 128, 28, 128)),
    (("batch", "seq", "heads", "head_dim"), (32, 128, 32, 128)),
    (("batch", "seq", "embed"), (8, 2048, 3584)),
    (("batch", "seq", "vocab"), (64, 16, 152064)),
    (("heads", "ff"), (32, 64)),
    (("batch", "groups", "capacity"), (32, 32, 7)),
    (("groups", "experts", "capacity", "embed"), (16, 64, 40, 512)),
    ((None, "ff"), (3, 64)),
    ((None, None), (5, 7)),
    (("batch", "kv", "cache", "head_dim"), (1, 8, 4096, 128)),
    (("batch", "cache", "kv", "head_dim"), (64, 32768, 8, 128)),
    (("shards", None), (128, 3125)),
    (("shards", None), (6, 10)),
    (("period", "embed", "ff"), (28, 3584, 18944)),
    (("vocab", "embed"), (151936, 1024)),
    (("embed",), (1024,)),
    (("experts", "embed", "ff"), (64, 2048, 1024)),
    (("conv", "inner"), (4, 3072)),
    (("period", "embed", "heads", "head_dim"), (2, 64, 28, 128)),
    (("unknown", "heads"), (4, 16)),
]

RULE_FLAGS = list(itertools.product((False, True), (False, True)))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with one_rank_group(tmp_path_factory.mktemp("sharding1")):
        yield


def _tmesh(name):
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = MESHES[name]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False)


def _jmesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _rules(pkg, mesh_name, fsdp, seq_shard):
    multi_pod = "pod" in MESHES[mesh_name][1]
    return pkg.default_rules(multi_pod=multi_pod, fsdp=fsdp,
                             seq_shard=seq_shard)


class _JCtx:
    """The reference's (mesh, rules) context on an AbstractMesh, which
    ``use_mesh``'s ``with mesh:`` does not accept."""

    def __init__(self, mesh, rules=None):
        self.new = (mesh, rules or jsh.default_rules(
            multi_pod="pod" in mesh.axis_names))

    def __enter__(self):
        self.old = (jsh._CTX.mesh, jsh._CTX.rules)
        jsh._CTX.mesh, jsh._CTX.rules = self.new

    def __exit__(self, *exc):
        jsh._CTX.mesh, jsh._CTX.rules = self.old


@pytest.mark.parametrize("multi_pod,fsdp,seq_shard",
                         list(itertools.product((False, True), repeat=3)))
def test_default_rules_tables_are_the_references(multi_pod, fsdp, seq_shard):
    j = jsh.default_rules(multi_pod=multi_pod, fsdp=fsdp, seq_shard=seq_shard)
    t = tsh.default_rules(multi_pod=multi_pod, fsdp=fsdp, seq_shard=seq_shard)
    assert t.act == j.act and t.param == j.param
    assert list(t.act) == list(j.act) and list(t.param) == list(j.param)
    for name in (*j.act, None, "absent"):
        assert t.lookup(t.act, name) == j.lookup(j.act, name)


def test_partition_spec_is_a_tuple_of_the_entries():
    entries = ("data", None, ("pod", "data"), ("model",), ())
    spec = tsh.PartitionSpec(*entries)
    assert tuple(spec) == tuple(P(*entries))
    assert tuple(tsh.PartitionSpec()) == tuple(P()) == ()
    assert "PartitionSpec" in repr(spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp,seq_shard", RULE_FLAGS)
def test_resolve_matches_the_reference(group, mesh_name, fsdp, seq_shard):
    tm, jm = _tmesh(mesh_name), _jmesh(mesh_name)
    tr = _rules(tsh, mesh_name, fsdp, seq_shard)
    jr = _rules(jsh, mesh_name, fsdp, seq_shard)
    for table in ("act", "param"):
        for names, shape in GRID:
            want = jsh._resolve(getattr(jr, table), names, shape, jm)
            got = tsh._resolve(getattr(tr, table), names, shape, tm)
            assert isinstance(got, tsh.PartitionSpec)
            assert tuple(got) == tuple(want), (table, names, shape)


def test_resolve_falls_back_and_uses_an_axis_once(group):
    tm = _tmesh("16x16")
    rules = tsh.default_rules()
    # Qwen2's 28 heads do not divide the 16-way model axis
    assert tuple(tsh._resolve(rules.act, ("batch", "heads"), (32, 28),
                              tm)) == ("data", None)
    # a batch of 8 on data=16 is replicated
    assert tuple(tsh._resolve(rules.act, ("batch", "ff"), (8, 64),
                              tm)) == (None, "model")
    # "ff" after "heads": the model axis is taken
    assert tuple(tsh._resolve(rules.act, ("heads", "ff"), (32, 64),
                              tm)) == ("model", None)


def test_placements_of_a_spec(group):
    from torch.distributed.tensor import Replicate, Shard

    tm = _tmesh("2x16x16")
    spec = tsh.PartitionSpec(("pod", "data"), None, "model")
    assert tsh.placements(spec, tm) == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.PartitionSpec(None, None), tm) == (
        Replicate(), Replicate(), Replicate())
    assert tsh.NamedSharding(tm, spec).placements == tsh.placements(spec, tm)


def _leaves(tree, stop, path=()):
    if isinstance(tree, stop):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], stop, path + (k,))
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, stop, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["qwen2_7b", "olmoe_1b_7b", "zamba2_7b"])
def test_param_specs_of_a_smoke_tree_match_the_reference(group, arch):
    from jax.sharding import NamedSharding as JNS

    jstate, jaxes = jabstract_state(jget_smoke(arch))
    tstate, taxes = tabstract_state(tget_smoke(arch))
    for mesh_name in ("4x2", "16x16", "2x16x16"):
        with _JCtx(_jmesh(mesh_name)):
            want = dict(_leaves(jsh.param_specs(jstate.params, jaxes.params),
                                JNS))
        with tsh.use_mesh(_tmesh(mesh_name)):
            got = dict(_leaves(tsh.param_specs(tstate.params, taxes.params),
                               tsh.NamedSharding))
        assert got.keys() == want.keys() and got
        for path, ns in got.items():
            assert tuple(ns.spec) == tuple(want[path].spec), (mesh_name, path)
    # with no mesh every leaf maps to None, as the reference's
    assert all(v is None for _, v in _leaves(
        tsh.param_specs(tstate.params, taxes.params), tsh.NamedSharding))


def test_act_specs_and_act_spec_match_the_reference(group):
    shapes = {"k": (2, 8, 64, 16), "v": (2, 8, 64, 16), "pos": (2,),
              "tokens": (16, 128)}
    axes = {"k": "batch,kv,cache,head_dim", "v": "batch,kv,cache,head_dim",
            "pos": "batch", "tokens": "batch,seq"}
    ttree = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    jtree = {k: np.empty(s, np.int8) for k, s in shapes.items()}
    for mesh_name in MESHES:
        for _, seq_shard in RULE_FLAGS[:2]:
            tr = _rules(tsh, mesh_name, True, seq_shard)
            jr = _rules(jsh, mesh_name, True, seq_shard)
            with _JCtx(_jmesh(mesh_name), jr):
                want = jsh.act_specs(jtree, axes)
                want1 = jsh.act_spec((64, 32768, 8, 128), "batch", "cache",
                                     "kv", "head_dim")
            with tsh.use_mesh(_tmesh(mesh_name), tr):
                got = tsh.act_specs(ttree, axes)
                got1 = tsh.act_spec((64, 32768, 8, 128), "batch", "cache",
                                    "kv", "head_dim")
            for k in shapes:
                assert tuple(got[k].spec) == tuple(want[k].spec), (mesh_name,
                                                                   k)
            assert tuple(got1.spec) == tuple(want1.spec)
    assert tsh.act_spec((4,), "batch") is None


def test_context_and_mesh_axis_with_absent_axes(group):
    assert tsh.current_mesh() is None and tsh.current_rules() is None
    assert tsh.mesh_axis("shards") is None
    assert tsh.mesh_resize("shards", 4) is None
    cases = [("1x1", None), ("4x2", None), ("2x16x16", None)]
    for mesh_name, rules in cases:
        tm, jm = _tmesh(mesh_name), _jmesh(mesh_name)
        with tsh.use_mesh(tm, rules), _JCtx(jm, rules):
            assert tsh.current_mesh() is tm
            assert (tsh.current_rules().act, tsh.current_rules().param) == (
                jsh.current_rules().act, jsh.current_rules().param)
            for name in ("shards", "batch", "heads", "seq", "absent",
                         "cache"):
                for table in ("act", "param"):
                    assert tsh.mesh_axis(name, table) == jsh.mesh_axis(
                        name, table), (mesh_name, name, table)
                for new in (1, 2, 3, 4, 6, 8, 32, 33, 512):
                    assert tsh.mesh_resize(name, new) == jsh.mesh_resize(
                        name, new), (mesh_name, name, new)
    # multi-pod rules on a mesh without "pod": the absent axis is dropped
    rules = tsh.default_rules(multi_pod=True)
    jrules = jsh.default_rules(multi_pod=True)
    with tsh.use_mesh(_tmesh("4x2"), rules), _JCtx(_jmesh("4x2"), jrules):
        assert tsh.mesh_axis("shards") == jsh.mesh_axis("shards") == (
            "data",)
        assert tsh.mesh_resize("shards", 6) == jsh.mesh_resize(
            "shards", 6) is None
    # a rules table whose "shards" binds nothing
    empty = tsh.ShardingRules(act={}, param={})
    with tsh.use_mesh(_tmesh("4x2"), empty):
        assert tsh.mesh_axis("shards") is None
        assert tsh.mesh_resize("shards", 8) is None
    assert tsh.current_mesh() is None


def test_shard_without_a_mesh_or_on_a_plain_tensor(group):
    x = torch.arange(12.).reshape(3, 4)
    assert tsh.shard(x, "batch", "ff") is x
    with tsh.use_mesh(_tmesh("4x2")):
        assert tsh.shard(x, "batch", "ff") is x
        with pytest.raises(ValueError):
            tsh.shard(x, "batch")


def test_host_device_mesh_error_cites_its_recipe():
    with pytest.raises(RuntimeError, match="FileStore"):
        tsh.host_device_mesh(64)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tlaunch.make_production_mesh(device="cpu")


def test_mesh_builders_on_one_rank(group):
    import torch.distributed as dist

    m = tlaunch.make_smoke_mesh(1, device="cpu")
    assert tuple(m.shape) == (1, 1)
    assert tsh.axis_names(m) == ("data", "model")
    line = tsh.host_device_mesh(1, device="cpu")
    assert tsh.axis_names(line) == ("shards",) and tuple(line.shape) == (1,)
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs a process group of "
                                               f"{need} ranks"):
            tlaunch.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert dist.get_world_size() == 1


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    return x, run_ranks("sharding", 4, tmp_path_factory.mktemp("sharding4"),
                        {"x": x})


def test_make_smoke_mesh_of_four_ranks(four_ranks):
    _, outs = four_ranks
    # the reference's make_smoke_mesh(4): (n // 2, 2) over (data, model)
    for out in outs:
        assert tuple(out["smoke/shape"]) == (2, 2)
        assert tuple(out["smoke/names"]) == ("data", "model")
        assert tuple(out["line/shape"]) == (4,)
        assert tuple(out["line/names"]) == ("data",)


def test_shard_redistributes_a_dtensor_on_four_ranks(four_ranks):
    x, outs = four_ranks
    with _JCtx(AbstractMesh((2, 2), ("data", "model"))):
        want = tuple(jsh.act_spec(x.shape, "batch", "ff").spec)
    for out in outs:
        assert str(out["act_spec"]) == str(want)
        assert str(out["shard/placements"]) == (
            "(Shard(dim=0), Shard(dim=1))")
        assert tuple(out["shard/local_shape"]) == (4, 3)
        np.testing.assert_array_equal(out["shard/full"], x)
        # the host-staged gather (what a CUDA DTensor on gloo takes)
        np.testing.assert_array_equal(out["shard/via_host"], x)
        np.testing.assert_array_equal(out["rows/via_host"], x)
        np.testing.assert_array_equal(out["rows/full"], x)
        assert bool(out["shard/plain_is_x"])
