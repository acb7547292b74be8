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


def _tree(flat: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix``-ed entries of ``flat`` (keys
    ``prefix/a/b``), the reference's param tree."""
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    return out


def _flat_out(out: dict, key: str, tree) -> None:
    """A tree's leaves, gathered whole, under ``key/<path>``."""
    import torch

    from repro_torch.parallel import sharding as psh
    from repro_torch.train.checkpoint import _flatten

    for path, t in _flatten(tree).items():
        t = psh.full(t)
        out[f"{key}/{path}"] = (t.float() if t.dtype == torch.bfloat16
                                else t).numpy()


def suite_model(rank: int, world: int, inp: dict) -> dict:
    """The model on a (world // 2, 2) mesh: forward logits, expert counts
    and loss of each config in ``inp["archs"]``; OLMoE where capacity
    binds per dispatch group; Qwen3 on a (1, world) mesh (kv-heads
    replicated, each rank's q-head reading its kv-head); ``_attend`` on
    synthetic GQA shapes; Gemma3's prefill and decode steps with the SS±
    cache's slots over "model"; the Trainer resumed from the reference's
    checkpoint for 2 steps; one OLMoE train step."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.convert import params_from_reference
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import layers as L, moe
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import sharding as psh
    from repro_torch.serve import build_prefill_step, build_serve_step
    from repro_torch.serve import kv_cache
    from repro_torch.train import (Trainer, TrainerConfig, TrainState,
                                   build_train_step, state_axes)

    out = {}
    mesh = make_smoke_mesh(world, device="cpu")
    line = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))

    def model_of(arch, **kw):
        cfg = dataclasses.replace(configs.get_smoke(arch), **kw)
        params = params_from_reference(_tree(inp, f"{arch}/params"), cfg,
                                       device="cpu")
        _, axes = T.init_params(None, cfg, device="meta")
        return cfg, params, axes

    def batch_of(arch, cfg):
        b = {"tokens": torch.from_numpy(inp[f"{arch}/tokens"]),
             "labels": torch.from_numpy(inp[f"{arch}/labels"])}
        if f"{arch}/frames" in inp:
            b["frames"] = torch.from_numpy(inp[f"{arch}/frames"]).bfloat16()
        return b

    def forward(key, arch, on, **kw):
        cfg, params, axes = model_of(arch, **kw)
        b = batch_of(arch, cfg)
        with psh.use_mesh(on):
            p = psh.distribute(params, axes)
            logits, counts = T.forward(p, cfg, b["tokens"],
                                       frames=b.get("frames"))
            out[f"{key}/placements"] = np.asarray(str(tuple(
                logits.placements)))
            out[f"{key}/logits"] = psh.full(logits).float().numpy()
            out[f"{key}/counts"] = psh.full(counts).numpy()
            loss, _ = T.loss_fn(p, cfg, b)
            out[f"{key}/loss"] = psh.full(loss).numpy()
            out[f"{key}/groups"] = np.asarray(moe._num_dispatch_groups(
                b["tokens"].numel()))

    for arch in inp["archs"]:
        forward(str(arch), str(arch), mesh)
    forward("moe_bind", "olmoe_1b_7b", mesh,
            capacity_factor=float(inp["moe_bind_cf"]))
    forward("line", "qwen3_0_6b", line)

    gen = torch.Generator().manual_seed(5)
    for H, KV in ((8, 2), (4, 1), (6, 3)):
        q, k, v = (torch.randn((2, 8, h, 8), generator=gen)
                   for h in (H, KV, KV))
        with psh.use_mesh(mesh):
            qs = psh.act_spec(q.shape, "batch", "seq", "heads", None).spec
            ks = psh.act_spec(k.shape, "batch", "seq", "kv", None).spec
            got = L._attend(psh.lay_out(q, qs), psh.lay_out(k, ks),
                            psh.lay_out(v, ks), True, 0, "kernel")
            out[f"gqa/{H}x{KV}/got"] = psh.full(got).numpy()
        out[f"gqa/{H}x{KV}/want"] = L._attend(q, k, v, True, 0,
                                               "kernel").numpy()
        out[f"gqa/{H}x{KV}/split"] = np.asarray([qs[2] is not None,
                                                 ks[2] is not None])

    kv_cache.HH_ENGAGE_CTX = int(inp["hh_engage"])
    cfg, params, axes = model_of("gemma3_27b")
    ctx, steps = int(inp["gemma/context"]), int(inp["gemma/steps"])
    toks = torch.from_numpy(inp["gemma3_27b/tokens"])
    for name, on in (("plain", None), ("mesh", mesh)):
        with psh.use_mesh(on):
            p = psh.distribute(params, axes)
            pre = build_prefill_step(cfg, ctx, device="cpu")
            step = build_serve_step(cfg, ctx, int(inp["gemma/decay"]),
                                    device="cpu")
            logits, cache = pre(p, {"tokens": toks})
            seq = [psh.full(logits)[:, -1]]
            for _ in range(steps):
                cur = seq[-1].argmax(-1).to(torch.int32)[:, None]
                logits, cache, _ = step(p, cache, cur)
                seq.append(psh.full(logits)[:, -1])
            out[f"gemma/{name}/logits"] = torch.stack(seq).float().numpy()
            hh = next(e for e in cache["periods"].values()
                      if "counts" in e)
            if on is not None:
                out["gemma/cache_placements"] = np.asarray(str(tuple(
                    hh["counts"].placements)))
            for f in ("ids", "counts", "errors"):
                out[f"gemma/{name}/{f}"] = psh.full(hh[f]).numpy()

    cfg = configs.get_smoke("qwen3_0_6b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = TrainerConfig(total_steps=2, ckpt_every=0,
                       ckpt_dir=str(inp["trainer/ckpt_dir"]), log_every=1,
                       track_tokens=False)
    tr = Trainer(cfg, dc, tc, mesh=mesh, device="cpu")
    out["trainer/resumed"] = np.asarray(tr.try_resume())
    out["trainer/state_placements"] = np.asarray(str(tuple(
        tr.state.opt.master["embed"].placements)))
    tr.run(2)
    out["trainer/losses"] = np.asarray([r["loss"] for r in tr.metrics_log])
    out["trainer/grad_norms"] = np.asarray(
        [r["grad_norm"] for r in tr.metrics_log])

    cfg, params, axes = model_of("olmoe_1b_7b")
    with psh.use_mesh(mesh):
        state = psh.distribute(TrainState(params, adamw_init(params)),
                               state_axes(axes))
        new, metrics = build_train_step(cfg)(
            state, batch_of("olmoe_1b_7b", cfg))
        for k in ("loss", "grad_norm"):
            out[f"olmoe_step/{k}"] = psh.full(metrics[k]).numpy()
        out["olmoe_step/expert_counts"] = psh.full(
            metrics["expert_counts"]).numpy()
        _flat_out(out, "olmoe_step/params", new.params)
    return out


def suite_checkpoint(rank: int, world: int, inp: dict) -> dict:
    """Checkpoints across meshes on ``world`` = 8 ranks: the reference's
    grid (a (8, 8) leaf on "embed,ff" saved from a (4, 2) mesh, restored
    onto (2, 4)); a model state saved on the (4, 2) mesh for the parent
    to restore in the JAX package; the JAX package's checkpoint restored
    onto the (2, 4) mesh."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import sharding as psh
    from repro_torch.train import checkpoint as ckpt

    out = {}
    m42 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d = str(inp["dir"])
    x = torch.from_numpy(inp["w"])
    with psh.use_mesh(m42):
        xs = psh.distribute({"w": x}, {"w": "embed,ff"})
        out["grid/saved_local"] = np.asarray(xs["w"].to_local().shape)
        ckpt.save(f"{d}/grid", 1, xs)
    with psh.use_mesh(m24):
        got, _ = ckpt.restore(f"{d}/grid", {"w": x}, axes={"w": "embed,ff"},
                              device="cpu")
    w = got["w"]
    out["grid/mesh"] = np.asarray(w.device_mesh.shape)
    out["grid/placements"] = np.asarray(str(tuple(w.placements)))
    out["grid/local"] = w.to_local().numpy()
    out["grid/full"] = psh.full(w).numpy()

    like = {"params": {"w": torch.from_numpy(inp["state/w"]).bfloat16(),
                       "b": torch.from_numpy(inp["state/b"])},
            "step": torch.tensor(int(inp["state/step"]), dtype=torch.int32)}
    axes = {"params": {"w": "embed,ff", "b": "ff"}, "step": ""}
    with psh.use_mesh(m42):
        state = psh.distribute(like, axes)
        ckpt.save(f"{d}/port", 3, state, extra={"step": 3})
    with psh.use_mesh(m24):
        got, extra = ckpt.restore(f"{d}/jax", like, axes=axes, device="cpu")
    out["jax/extra_step"] = np.asarray(extra["step"])
    out["jax/dtensor"] = np.asarray(all(
        psh.is_dtensor(t) for t in (got["params"]["w"], got["step"])))
    out["jax/w_placements"] = np.asarray(str(tuple(
        got["params"]["w"].placements)))
    _flat_out(out, "jax/state", got)
    return out


def suite_mesh24(rank: int, world: int, inp: dict) -> dict:
    """Smoke Qwen3 on a (2, world // 2) ("data", "model") mesh, where the
    model axis (4 on 8 ranks) does not divide its 2 kv-heads and the data
    axis is above 1: forward logits and loss, and one train step's loss,
    gradient norm and new params (the projections' layouts:
    ``layers.project``)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.convert import params_from_reference
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import sharding as psh
    from repro_torch.train import TrainState, build_train_step, state_axes

    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    cfg = configs.get_smoke("qwen3_0_6b")
    params = params_from_reference(_tree(inp, "params"), cfg, device="cpu")
    _, axes = T.init_params(None, cfg, device="meta")
    b = {k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")}
    out = {}
    with psh.use_mesh(mesh):
        p = psh.distribute(params, axes)
        logits, _ = T.forward(p, cfg, b["tokens"])
        out["logits"] = psh.full(logits).float().numpy()
        out["loss"] = psh.full(T.loss_fn(p, cfg, b)[0]).numpy()
        k = _k_projection(p, cfg, b["tokens"])
        out["k_placements"] = np.asarray(str(tuple(k.placements)))
        state = psh.distribute(TrainState(params, adamw_init(params)),
                               state_axes(axes))
        new, metrics = build_train_step(cfg)(state, b)
        for key in ("loss", "grad_norm"):
            out[f"step/{key}"] = psh.full(metrics[key]).numpy()
        _flat_out(out, "step/params", new.params)
    return out


def _k_projection(p, cfg, tokens):
    """The first layer's k projection of the embedded tokens (its
    layout is the point: kv-heads replicated over "model")."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    x = T._embed(p, cfg, tokens, None)
    wk = p["periods"]["pos0"]["attn"]["wk"][0]
    return L.project(x, wk, "kv", None)


def suite_eight(rank: int, world: int, inp: dict) -> dict:
    """The 8-rank group's two suites in one spawn: ``suite_checkpoint``,
    then ``suite_mesh24``."""
    return {**suite_checkpoint(rank, world, inp),
            **suite_mesh24(rank, world, inp)}


SUITES = {"sharding": suite_sharding, "sketch": suite_sketch,
          "exchange": suite_exchange, "model": suite_model,
          "eight": suite_eight}


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
