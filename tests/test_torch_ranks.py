"""Multi-rank runs of the port for the CPU tests: a gloo process group of
N processes on this host over a ``FileStore`` (no network device, no
TCP rendezvous).

Parent side, ``run_ranks(suite, world, tmp, inputs)``: writes the
inputs (numpy arrays) under ``tmp``, starts ``world`` processes of this
file, waits for them and returns each rank's outputs (dicts of numpy
arrays). Child side, ``python torch_ranks.py SUITE RANK WORLD DIR``:
joins the group, runs ``SUITES[SUITE](rank, world, inputs)`` and writes
its outputs. The children import only the port, never ``jax`` or
``repro``: the parent computes the reference's results and compares.

``one_rank_group(tmp)`` starts the in-process group of one rank that a
size-1 mesh needs; the one test here holds it.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def one_rank_group(tmp):
    """A gloo group of this process alone, over a FileStore in ``tmp``."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(pathlib.Path(tmp) / "store1"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_ranks(suite: str, world: int, tmp, inputs: dict,
              timeout: float = 300.0) -> list:
    """Run ``suite`` on ``world`` ranks; each rank's outputs, rank order."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    if bad:
        raise RuntimeError("ranks failed: " + "\n".join(
            f"rank {r} exited {rc}:\n{log[-4000:]}" for r, rc, log in bad))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def test_one_rank_group_starts_and_ends(tmp_path):
    """The in-process group is up (one rank, gloo) inside the context and
    gone after it, so the next module can start its own."""
    import torch.distributed as dist

    with one_rank_group(tmp_path):
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Child side: the suites (port only)
# ---------------------------------------------------------------------------

def _bank(out: dict, key: str, bank) -> None:
    """The gathered bank's three fields under ``key/ids`` and so on."""
    from repro_torch.parallel import sharding as psh

    for name, t in zip(("ids", "counts", "errors"), bank):
        out[f"{key}/{name}"] = psh.full(t).numpy()


def suite_sharding(rank: int, world: int, inp: dict) -> dict:
    """The mesh builders on ``world`` ranks and ``shard`` on a DTensor."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as psh

    out = {}
    smoke = make_smoke_mesh(world, device="cpu")
    out["smoke/shape"] = np.asarray(smoke.shape)
    out["smoke/names"] = np.asarray(psh.axis_names(smoke))
    line = psh.host_device_mesh(world, axis="data", device="cpu")
    out["line/shape"] = np.asarray(line.shape)
    out["line/names"] = np.asarray(psh.axis_names(line))
    x = torch.from_numpy(inp["x"])
    d = DTensor.from_local(x, smoke, [Replicate(), Replicate()],
                           run_check=False)
    with psh.use_mesh(smoke):
        y = psh.shard(d, "batch", "ff")
        out["shard/placements"] = np.asarray(str(tuple(y.placements)))
        out["shard/local_shape"] = np.asarray(y.to_local().shape)
        out["shard/full"] = y.full_tensor().numpy()
        out["shard/via_host"] = psh._gather_via_host(y).numpy()
        rows = DTensor.from_local(x[2 * rank:2 * rank + 2], smoke,
                                  [Shard(0), Shard(0)], run_check=False)
        out["rows/via_host"] = psh._gather_via_host(rows).numpy()
        out["rows/full"] = rows.full_tensor().numpy()
        plain = psh.shard(x, "batch", "ff")
        out["shard/plain_is_x"] = np.asarray(plain is x)
        out["act_spec"] = np.asarray(str(tuple(psh.act_spec(
            x.shape, "batch", "ff").spec)))
    return out


def suite_sketch(rank: int, world: int, inp: dict) -> dict:
    """The sharded and dyadic-sharded banks' shard_map paths, a session
    under a mesh, the not-divisible errors and reshard_session, on a
    (world,) and a (world // 2, 2) mesh."""
    import torch

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as psh
    from repro_torch.sketch import api, elastic, session
    from repro_torch.sketch import dyadic_sharded as ds
    from repro_torch.sketch import sharded as shd

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    meshes = {"line": psh.host_device_mesh(world, axis="data", device="cpu"),
              "grid": make_smoke_mesh(world, device="cpu")}
    ktot, ubits = int(inp["ktot"]), int(inp["ubits"])
    spec = api.SketchSpec(k=int(inp["session_k"]), shards=8, bits=ubits,
                          backend="bank")
    for m, mesh in meshes.items():
        with psh.use_mesh(mesh):
            for S in (4, 8):
                for v in (1, 2):
                    path = "shard_map" if S == 4 else "auto"
                    st = shd.init(ktot, S, device="cpu")
                    for it, w in zip(t["items"], t["weights"]):
                        st = shd.update_block(st, it, w, v,
                                              universe_bits=ubits, path=path)
                    key = f"{m}/sharded/{S}/{v}"
                    _bank(out, key, st.bank)
                    out[f"{key}/local_rows"] = np.asarray(
                        st.bank.ids.to_local().shape[0])
                    out[f"{key}/query"] = shd.query_many(
                        st, t["probe"]).numpy()
            for v in (1, 2):
                st = ds.init(int(inp["qbits"]), 4, total_counters=256,
                             device="cpu")
                for it, w in zip(t["q_items"], t["q_weights"]):
                    st = ds.update_block(st, it, w, v, path="shard_map")
                key = f"{m}/dyadic/{v}"
                _bank(out, key, st.bank)
                out[f"{key}/mass"] = st.mass.numpy()
                out[f"{key}/rank"] = ds.rank_many(st, t["q_probe"]).numpy()
            sess = session.StreamSession(spec, block=256, device="cpu")
            sess.ingest(inp["s_items"], inp["s_weights"])
            sess.flush()
            key = f"{m}/session"
            out[f"{key}/dtensor"] = np.asarray(
                psh.is_dtensor(sess.state.bank.ids))
            out[f"{key}/own_cell"] = np.asarray(
                sess._compiled.layout is not None)
            for name, a in api.save(spec, sess.state).items():
                out[f"{key}/save/{name}"] = np.asarray(a)
            out[f"{key}/query"] = sess.query_many(inp["probe"]).numpy()
            ids, counts = sess.topk(10)
            out[f"{key}/topk_ids"] = ids.numpy()
            out[f"{key}/topk_counts"] = counts.numpy()
    with psh.use_mesh(meshes["line"]):
        one = torch.ones(8, dtype=torch.int32)
        for name, fn in (("sharded", lambda: shd.update_block(
                shd.init(60, 6, device="cpu"), one, one, path="shard_map")),
                         ("dyadic", lambda: ds.update_block(
                             ds.init(8, 6, total_counters=256, device="cpu"),
                             one, one, path="shard_map"))):
            try:
                fn()
                out[f"divisible/{name}"] = np.asarray("no error")
            except ValueError as e:
                out[f"divisible/{name}"] = np.asarray(str(e))
    half = len(inp["s_items"]) // 2
    with psh.use_mesh(meshes["grid"]):
        for new in (6, 3):
            sess = session.StreamSession(spec, block=256, device="cpu")
            sess.ingest(inp["s_items"][:half], inp["s_weights"][:half])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                elastic.reshard_session(sess, new)
            key = f"reshard/{new}"
            out[f"{key}/warnings"] = np.asarray(
                "\n".join(str(w.message) for w in caught))
            sess.ingest(inp["s_items"][half:], inp["s_weights"][half:])
            sess.flush()
            out[f"{key}/dtensor"] = np.asarray(
                psh.is_dtensor(sess.state.bank.ids))
            out[f"{key}/slack"] = np.asarray(sess.error_slack)
            for name, a in api.save(sess.spec, sess.state).items():
                out[f"{key}/save/{name}"] = np.asarray(a)
    return out


def suite_exchange(rank: int, world: int, inp: dict) -> dict:
    """``compressed_psum_leaf`` on groups of 1, 2 and ``world`` ranks over
    the cases of ``inp`` (3 steps carrying the residual), then
    ``build_compressed_allreduce`` over a tree on a (world,) mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import sharding as psh
    from repro_torch.train.dp_exchange import (build_compressed_allreduce,
                                               compressed_psum_leaf)

    singles = [dist.new_group([r]) for r in range(world)]
    pairs = [dist.new_group([2 * j, 2 * j + 1]) for j in range(world // 2)]
    groups = {1: singles[rank], 2: pairs[rank // 2], world: None}
    out = {}
    for case in sorted({k.split("/")[0] for k in inp
                        if "/" in k and not k.startswith("tree.")}):
        G = torch.from_numpy(inp[f"{case}/g"])        # (steps, world, ...)
        k = int(inp[f"{case}/k"])
        for A, group in groups.items():
            r = torch.from_numpy(inp[f"{case}/r0"][rank])
            for step in range(G.shape[0]):
                dense, r = compressed_psum_leaf(G[step, rank], r, k, group)
                out[f"{case}/{A}/{step}/sum"] = dense.numpy()
                out[f"{case}/{A}/{step}/residual"] = r.numpy().copy()
    mesh = psh.host_device_mesh(world, axis="data", device="cpu")
    allreduce = build_compressed_allreduce(mesh, float(inp["k_frac"]))
    names = sorted(k.removeprefix("tree.").removesuffix("/g")
                   for k in inp if k.startswith("tree.") and k.endswith("/g"))

    def tree(step=None, key="g"):
        leaves = {n: torch.from_numpy(
            inp[f"tree.{n}/{key}"][step, rank] if step is not None
            else inp[f"tree.{n}/{key}"][rank]) for n in names}
        return {"a": leaves["a"], "b": {"c": leaves["c"], "d": leaves["d"]},
                "e": leaves["e"]}

    res = tree(key="r0")
    for step in range(int(inp["tree_steps"])):
        sums, res = allreduce(tree(step), res)
        for n, s, r in (("a", sums["a"], res["a"]),
                        ("c", sums["b"]["c"], res["b"]["c"]),
                        ("d", sums["b"]["d"], res["b"]["d"]),
                        ("e", sums["e"], res["e"])):
            out[f"tree/{step}/{n}/sum"] = s.numpy()
            out[f"tree/{step}/{n}/residual"] = r.numpy().copy()
    return out


SUITES = {"sharding": suite_sharding, "sketch": suite_sketch,
          "exchange": suite_exchange}


def _child(suite: str, rank: int, world: int, d: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(d / "store"), world), rank=rank, world_size=world)
    try:
        out = SUITES[suite](rank, world, dict(np.load(d / "inputs.npz")))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           pathlib.Path(sys.argv[4]))
