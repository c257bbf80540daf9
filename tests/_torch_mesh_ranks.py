"""The port's LM on a mesh, on four gloo ranks on the CPU, for
``tests/test_torch_mesh.py``.

    python tests/_torch_mesh_ranks.py <dir> <arch,...> [extras]

spawns four ranks, each of which joins a gloo group through
``file://<dir>/init``, reads the reference's draws from ``<dir>/draws.npz``
(``tests/_torch_mesh_reference.py`` writes them before it computes), runs
each named architecture (``mesh_config`` reads the name) on (2, 2) and
(4, 1) meshes (and with ``extras`` the checkpoint, pipeline, compression
and compressed-step scenarios) and saves what it got to
``<dir>/rank<r>.pt`` (every rank's hold the gathered trees).  This file
imports neither JAX nor the reference package.
"""

from __future__ import annotations

import contextlib
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
CACHE_LEN, DECODE_STEPS = 48, 3
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


@contextlib.contextmanager
def world_of_one(root: Path, shape=(1, 1), names=("data", "model")):
    """A gloo group of this process alone and a mesh of ``shape`` (all ones)
    over it; the group is destroyed after."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{root}/init1", rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def mesh_config(name: str, get_smoke):
    """The config a case's name stands for: an architecture's smoke config
    (``get_smoke``), ``arch@dN`` the same at d_model N, ``arch@seq`` the same
    config, which the port's ranks run sequence-parallel whatever its width
    (``transformer.SEQ_SHARD_MIN_D_MODEL`` lowered; the math is the
    reference's)."""
    import dataclasses

    arch, _, tag = name.partition("@")
    cfg = get_smoke(arch)
    if tag.startswith("d"):
        cfg = dataclasses.replace(cfg, d_model=int(tag[1:]))
    return cfg


def serve_config(cfg):
    """The config the serving checks run: a MoE at the no-drop capacity
    (E / k), since the expert-parallel capacity follows each data shard's
    token count and so drops other tokens than one card does."""
    import dataclasses

    if not cfg.moe_experts:
        return cfg
    return dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)


def nested(ref, prefix: str) -> dict:
    """The npz's flat ``prefix/...`` keys as a nested dict of arrays."""
    out: dict = {}
    for key in ref.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = ref[key]
    return out


def lm(ref, arch, mesh):
    """lm_loss, its gradients and one AdamW step on ``mesh``; prefill and
    decode logits on it; the rows of each group input that remat saves
    (``saved_rows``)."""
    from repro_torch.models import transformer as tfm

    threshold = tfm.SEQ_SHARD_MIN_D_MODEL
    if arch.endswith("@seq"):
        tfm.SEQ_SHARD_MIN_D_MODEL = 0
    try:
        return _lm(ref, arch, mesh)
    finally:
        tfm.SEQ_SHARD_MIN_D_MODEL = threshold


def _saved_rows(fn):
    """``fn()`` and the sequence rows of each group input that
    ``transformer._rematerialised`` was given (what remat "full" saves)."""
    from repro_torch.models import transformer as tfm

    rows, inner = [], tfm._rematerialised

    def spy(f, remat, *args):
        if getattr(f, "func", None) is not None and f.func.__name__ == "group":
            rows.append(args[0].shape[1])
        return inner(f, remat, *args)

    tfm._rematerialised = spy
    try:
        return fn(), rows
    finally:
        tfm._rematerialised = inner


def _lm(ref, arch, mesh):
    from repro_torch import convert
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import optimizers as topt
    from repro_torch.parallel import sharding as sh

    cfg = mesh_config(arch, get_smoke_config)
    params = convert.lm_params_from_numpy(nested(ref, f"{arch}/params"), cfg, mesh=mesh)
    pspecs = sh.param_specs(tfm.init_lm(0, cfg, device="meta"), cfg, mesh)
    full_batch = {k: torch.from_numpy(v) for k, v in nested(ref, f"{arch}/batch").items()}
    b = full_batch["tokens"].shape[0]
    batch = sh.shard_tree(full_batch, sh.batch_specs(cfg, ShapeConfig("t", 32, b, "train"), mesh),
                          mesh)
    for p in sh.walk(params):
        p[1].requires_grad_(True)
    loss, grads = ttrain.loss_and_grads(
        lambda p: tfm.lm_loss(p, cfg, batch, mesh=mesh, dtype=torch.float32), params)
    out = {"loss": float(loss), "grads": sh.gather_tree(grads, pspecs, mesh)}
    _, out["saved_rows"] = _saved_rows(lambda: tfm.lm_loss(params, cfg, batch, mesh=mesh,
                                                           dtype=torch.float32, remat="full"))
    # Serving: a prefill of the prompt, then decode steps on fixed tokens.
    serve = ShapeConfig("s", CACHE_LEN, b, "decode")
    serve_cfg = serve_config(cfg)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, cache, index = tfm.prefill(params, serve_cfg, prompt, CACHE_LEN, mesh=mesh,
                                           dtype=torch.float32)
        rows = [logits]
        for t in range(DECODE_STEPS):
            token = batch["labels"][:, t:t + 1]
            logits, cache = tfm.decode_step(params, serve_cfg, token, cache, index + t, mesh=mesh,
                                            dtype=torch.float32, cache_len=CACHE_LEN)
            rows.append(logits)
    tok = tserve.serve_specs(serve_cfg, serve, mesh, dtype=torch.float32)["token"]
    out["logits"] = [sh.gather_leaf(r, tok, mesh) for r in rows]
    if cfg.long_context == "ckm":
        out["ck"] = compressed_decode(ref, arch, serve_cfg, params, batch, mesh)

    # One AdamW step (in place: after the serving checks, which read the
    # reference's parameters).
    opt = topt.make_optimizer(topt.OptConfig(name="adamw"))
    state = opt.init(params)
    opt.update(grads, state, params, torch.zeros((), dtype=torch.int32), mesh=mesh, specs=pspecs)
    out["step"] = sh.gather_tree(params, pspecs, mesh)
    return out


def compressed_decode(ref, arch, cfg, params, batch, mesh):
    """Decode steps from a random CKM-compressed cache (``"ckm"`` mode: the
    attention layers' centroids, weights and ring, the Mamba states), on the
    mesh (its pieces placed by ``cache_specs``) and on one card (the whole
    cache, in this process): both logits, the mesh's gathered."""
    from repro_torch import convert
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as sh

    b = 4
    shape = ShapeConfig("long", 64, b, "long_decode")
    whole = tfm.init_cache(cfg, b, shape.seq_len, "ckm", torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(11)
    whole = sh.map_with_path(lambda _, t: torch.randn(t.shape, generator=gen), whole)
    local = sh.shard_tree(whole, sh.cache_specs(whole, cfg, shape, mesh), mesh)
    full_params = convert.lm_params_from_numpy(nested(ref, f"{arch}/params"), cfg, device="cpu")
    tok = sh.token_spec(shape, mesh)
    got, want = [], []
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            index = tfm.CKM_KV_RECENT + 5 + t  # past the ring's first wrap
            logits, local = tfm.decode_step(params, cfg, batch["labels"][:, t:t + 1], local,
                                            index, mesh=mesh, dtype=torch.float32,
                                            cache_len=shape.seq_len)
            got.append(sh.gather_leaf(logits, sh.P(*tok), mesh))
            token = torch.from_numpy(nested(ref, f"{arch}/batch")["labels"][:, t:t + 1])
            logits, whole = tfm.decode_step(full_params, cfg, token, whole, index,
                                            dtype=torch.float32)
            want.append(logits)
    return {"got": got, "want": want}


def checkpoint(root: Path, mesh, other):
    """A train loop on ``mesh`` (2, 2) that checkpoints, restored onto
    ``other`` (4, 1).  The monitor's decode is left out (its sketch is
    compared, not its CKM result)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import optimizers as topt
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import train_loop

    cfg = get_smoke_config("llama3.2-1b")
    shape = ShapeConfig("t", 32, 4, "train")
    loop = train_loop.LoopConfig(steps=2, ckpt_dir=str(root / "ckpt"), ckpt_every=2, keep=1,
                                 monitor_k=2, log_every=1, dtype=torch.float32)
    train_loop.ActivationMonitor.decode = lambda self, state, seed=None: None
    out = train_loop.run(cfg, shape, mesh, loop, DataConfig(seed=0))
    opt = topt.make_optimizer(ttrain.default_opt_config(cfg))
    specs = ttrain.state_specs(ttrain.state_shapes(cfg, opt), cfg, mesh)
    state = {k: v for k, v in out["state"].items() if k != "monitor"}
    live = sh.gather_tree(state, {k: specs[k] for k in state}, mesh)
    # Restore onto (4, 1): every rank reads the gathered checkpoint and keeps
    # its blocks of the other mesh's placement.
    ospecs = ttrain.state_specs(ttrain.state_shapes(cfg, opt), cfg, other)
    like = dict(live, monitor=out["state"]["monitor"])
    full = Checkpointer(root / "ckpt").restore(like)
    full.pop("monitor")
    pieces = sh.shard_tree(full, {k: ospecs[k] for k in full}, other)
    back = sh.gather_tree(pieces, {k: ospecs[k] for k in pieces}, other)
    return {"live": live, "restored_4x1": back, "history": out["history"],
            "monitor": out["state"]["monitor"]}


def pipeline(ref, mesh):
    from repro_torch.parallel.pipeline import pipeline_apply

    r = mesh.get_local_rank("pipe")
    ws = torch.from_numpy(ref["pipe/ws"])[r:r + 1]
    return pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, torch.from_numpy(ref["pipe/x"]),
                          mesh, axis="pipe")


def compression(ref, mesh):
    from repro_torch.optim.grad_compression import compress_allreduce_tree

    g = {"g": torch.from_numpy(ref["gc/g"])[mesh.get_local_rank("pod")]}
    err = {"g": torch.zeros((1, g["g"].shape[0]))}
    sums, err1 = [], None
    for _ in range(20):
        s, err = compress_allreduce_tree(g, err, mesh, "pod")
        sums.append(s["g"])
        if err1 is None:
            err1 = err["g"]
    return {"sums": torch.stack(sums), "err1": err1}


def compressed_step(pod):
    """build_compressed_train_step against build_train_step on the (2, 2)
    ("pod", "data") mesh at llama3.2-1b's smoke config: the gradients each
    optimizer took (gathered), each pod's gradient on one card (pod p holds
    rows 2p and 2p + 1), the losses, and whether the pods hold the same
    parameters after the step."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import optimizers as topt
    from repro_torch.optim.grad_compression import local_error_state
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as sh

    cfg = get_smoke_config("llama3.2-1b")
    opt = topt.make_optimizer(topt.OptConfig(name="adamw"))
    shape = ShapeConfig("t", 32, 4, "train")
    batch = SyntheticLM(cfg, shape, DataConfig(seed=1), device="cpu").batch(0)
    batch = {k: v for k, v in batch.items() if not k.startswith("_")}
    rows = sh.shard_tree(batch, sh.batch_specs(cfg, shape, pod), pod)
    specs = ttrain.state_specs(ttrain.state_shapes(cfg, opt), cfg, pod)["params"]
    comp = ttrain.init_sharded_state(cfg, opt, pod, seed=3)
    comp["err"] = local_error_state(comp["params"])
    plain = ttrain.init_sharded_state(cfg, opt, pod, seed=3)
    _, mc = ttrain.build_compressed_train_step(cfg, opt, pod, dtype=torch.float32,
                                               return_grads=True)(comp, rows)
    _, mp = ttrain.build_train_step(cfg, opt, mesh=pod, dtype=torch.float32,
                                    return_grads=True)(plain, rows)
    params = sh.gather_tree(comp["params"], specs, pod)
    sp = C.Spmd(pod)
    same = all(torch.equal(*C.all_gather(t[None], sp, "pod", 0)) for t in tree_leaves(params))
    fresh = ttrain.init_state(cfg, opt, seed=3, device="cpu")["params"]
    pods = [ttrain.loss_and_grads(lambda p, b=b: tfm.lm_loss(p, cfg, b, dtype=torch.float32),
                                  fresh)[1]
            for b in ({k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2))]
    return {"comp": sh.gather_tree(mc["grads"], specs, pod),
            "plain": sh.gather_tree(mp["grads"], specs, pod),
            "pods": tree_map(lambda t: t.detach(), pods),
            "losses": (float(mc["loss"]), float(mp["loss"])), "pods_equal": same}


def rank_main(rank: int, root: str, archs: list, extras: bool) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_local_mesh

    # Four ranks share the machine's cores: one thread each.
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root}/init", rank=rank, world_size=4,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        ref = np.load(root / "draws.npz")
        meshes = {name: make_local_mesh(model=shape[1], device="cpu")
                  for name, shape in MESHES.items()}
        out = {f"{arch}/{name}": lm(ref, arch, mesh)
               for arch in archs for name, mesh in meshes.items()}
        if extras:
            out["checkpoint"] = checkpoint(root, meshes["2x2"], meshes["4x1"])
            out["pipeline"] = pipeline(ref, init_device_mesh("cpu", (4,), mesh_dim_names=("pipe",)))
            pod = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
            out["compression"] = compression(ref, pod)
            out["compressed_step"] = compressed_step(pod)
        torch.save(out, root / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(rank_main, args=(sys.argv[1], sys.argv[2].split(","), len(sys.argv) > 3),
                       nprocs=4, start_method="spawn")
