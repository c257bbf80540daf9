"""Mesh axis arithmetic and the fleet's tenant mesh (counterpart of
``repro.parallel.sharding.axis_extent`` and ``tenant_mesh``).

``axis_extent`` reads a ``torch.distributed`` ``DeviceMesh`` (the sharded
SketchEngine's, one process a rank) or a :class:`TenantMesh`.  A
``TenantMesh`` is the fleet's single-controller mesh: one process, one
device per block of tenant rows, no process group.  The reference's
``tenant_shard_specs`` (PartitionSpecs for a sharded JAX array) has no
counterpart: no torch tensor spans devices, so the fleet keeps one ordinary
stacked state a block (``core.fleet.FleetShards``).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Sequence

import torch

from repro_torch import device as dev_mod


@dataclasses.dataclass(frozen=True)
class TenantMesh:
    """A 1-D mesh of ``devices`` on the axis ``mesh_dim_names[0]``: block s
    of a tenant-sharded fleet lives on ``devices[s]``.  A device may repeat
    (several blocks on one card, or on the CPU): placement and routing are
    real, concurrency is not."""

    devices: tuple[torch.device, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.devices),)


def tenant_mesh(shards: int, axis: str = "tenant", devices=None) -> TenantMesh:
    """1-D mesh for fleet tenant sharding: ``shards`` devices on one axis.

    ``devices=None`` takes the first ``shards`` visible CUDA cards and raises
    when there are fewer (no fallback to the CPU, no sharing of a card).  An
    explicit ``devices`` list is taken in order and may repeat a device,
    e.g. ``[torch.device("cpu")] * 4``.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if shards > cards:
            raise ValueError(
                f"tenant_mesh needs {shards} devices, only {cards} available (visible "
                "CUDA cards; pass devices=[...] to place several blocks on one device)"
            )
        devices = [torch.device("cuda", i) for i in range(shards)]
    devices = [dev_mod.resolve(d) for d in devices]
    if shards > len(devices):
        raise ValueError(f"tenant_mesh needs {shards} devices, only {len(devices)} given")
    return TenantMesh(tuple(devices[:shards]), (str(axis),))


def axis_extent(mesh, axes: Sequence[str]) -> int:
    """Product of the named mesh axes' sizes — the number of ranks a leading
    data axis is split over (the sharded SketchEngine's block count, the
    ``p`` of ``core.topology.wire_cost_model``), or a tenant mesh's block
    count.  ``mesh``: anything ``axis_sizes`` reads."""
    sizes = axis_sizes(mesh)
    ext = 1
    for a in axes:
        ext *= sizes[a]
    return ext


# ---------------------------------------------------------------------------
# The LM half: parameter, optimizer-state, batch and cache placement
# ---------------------------------------------------------------------------
#
# Axes (launch/mesh.py): ("pod", "data", "model") multi-pod or ("data",
# "model") single-pod.  A parameter's tensor-parallel dimension goes over
# "model" (attention heads, FFN hidden, vocabulary, experts, Mamba's
# channels), its FSDP dimension over "data"; optimizer state mirrors its
# parameter; the batch goes over ("pod", "data"); a decode cache's sequence
# over "model".  A dimension its axis does not divide is replicated.  The
# rules are the reference's; they work on the port's unstacked trees, so a
# group leaf's spec is the reference's without its leading None.


class P(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry a
    dimension, each None, a mesh axis name, or a tuple of names (the batch
    axes, the first the most significant); trailing Nones dropped."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# (path-regex, tags) — first match wins.  "F" = fsdp axis, "M" = model.
_PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"embed/table$", ("M", "F")),  # (vocab, d)
    (r"lm_head/w$", ("F", "M")),  # (d, vocab)
    (r"(mixer|cross)/wq$", ("F", "M")),
    (r"(mixer|cross)/wk$", ("F", "M")),
    (r"(mixer|cross)/wv$", ("F", "M")),
    (r"(mixer|cross)/wo$", ("M", "F")),
    (r"mlp/w_gate$", ("F", "M")),
    (r"mlp/w_up$", ("F", "M")),
    (r"mlp/w_down$", ("M", "F")),
    (r"mlp/router$", (None, None)),  # replicated: every expert rank routes
    # MoE experts (E, d, f) / (E, f, d): EP over model, FSDP over d / f.
    (r"mlp/w_(gate|up)$", ("M", "F", None)),
    (r"mlp/w_down$", ("M", None, "F")),
    # Mamba: the channel (d_inner) dimension over model.
    (r"mixer/in_proj$", ("F", "M")),
    (r"mixer/conv_w$", (None, "M")),
    (r"mixer/conv_b$", ("M",)),
    (r"mixer/x_proj$", ("M", None)),
    (r"mixer/dt_proj$", (None, "M")),
    (r"mixer/dt_bias$", ("M",)),
    (r"mixer/a_log$", ("M", None)),
    (r"mixer/d_skip$", ("M",)),
    (r"mixer/out_proj$", ("M", "F")),
]
_MOE_3D = {"w_gate", "w_up", "w_down"}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and shape with no devices behind it: all the spec
    functions read (``launch.mesh.make_production_mesh``)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, an ``Spmd``, a ``MeshShape``, a
    ``TenantMesh`` or any object with ``axis_names`` and ``devices`` (the
    reference's ``Mesh``, or a stand-in for it)."""
    from repro_torch.parallel.collectives import Spmd

    if isinstance(mesh, Spmd):
        return dict(mesh.sizes)
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    if isinstance(mesh, TenantMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


def walk(tree, path: str = ""):
    """``(path, leaf)`` of every tensor or ``sds`` leaf: dict keys, list
    indices and NamedTuple fields joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from walk(v, f"{path}/{i}" if path else str(i))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields") and not hasattr(tree, "dtype"):
        for k, v in zip(tree._fields, tree):
            yield from walk(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def map_with_path(fn, tree, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (paths as
    ``walk`` makes them)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and not hasattr(tree, "dtype"):
        return type(tree)(*(map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                            for k, v in zip(tree._fields, tree)))
    return fn(path, tree)


def _strip(out: list) -> P:
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _resolve(tags, shape, sizes: dict, fsdp_axis: str | None) -> P:
    """Tags -> spec, replicating a dimension its axis does not divide."""
    model = sizes.get("model", 1)
    fsdp = sizes.get(fsdp_axis, 1) if fsdp_axis else 1
    if len(tags) != len(shape):
        return P()  # rank mismatch — replicate
    out: list = []
    for tag, d in zip(tags, shape):
        if tag == "M" and model > 1 and d % model == 0:
            out.append("model")
        elif tag == "F" and fsdp > 1 and d % fsdp == 0:
            out.append(fsdp_axis)
        else:
            out.append(None)
    return _strip(out)


def leaf_spec(path: str, shape, family: str, sizes: dict, fsdp_axis: str | None = "data") -> P:
    """The spec of the parameter at ``path`` of a model of ``family`` (the
    reference's rule for it)."""
    if family == "ssm" and "embed" not in path and "lm_head" not in path:
        return P()
    name = path.rsplit("/", 1)[-1]
    rank = len(shape)
    if name in _MOE_3D and rank == 3:
        tags = ("M", "F", None) if name in ("w_gate", "w_up") else ("M", None, "F")
        return _resolve(tags, shape, sizes, fsdp_axis)
    for pat, tags in _PARAM_RULES:
        if re.search(pat, path) and len(tags) == rank:
            return _resolve(tags, shape, sizes, fsdp_axis)
    return P()  # norms, biases, gates: replicated


def param_specs(params, cfg, mesh, fsdp_axis: str | None = "data"):
    """The spec tree of a parameter tree (tensors or ``sds`` records of the
    full, unsharded shapes)."""
    sizes = axis_sizes(mesh)
    return map_with_path(lambda path, leaf: leaf_spec(path, tuple(leaf.shape), cfg.family, sizes,
                                                      fsdp_axis), params)


@functools.lru_cache(maxsize=None)
def layer_specs(cfg, mixer: str, mlp_kind: str, cross: bool, sizes_key: tuple,
                fsdp_axis: str | None = "data") -> dict:
    """The specs of one layer's parameters (every layer of a kind has the
    same), from its shapes on the meta device; ``sizes_key`` is
    ``tuple(axis_sizes(mesh).items())``."""
    from repro_torch.models import transformer as tfm

    meta = tfm.init_layer(None, cfg, mixer, mlp_kind, cross, torch.device("meta"))
    sizes = dict(sizes_key)
    return map_with_path(lambda path, leaf: leaf_spec(path, tuple(leaf.shape), cfg.family, sizes,
                                                      fsdp_axis), meta)


def opt_state_specs(opt_state, pspecs):
    """Optimizer state mirrors its parameters: Adam's m and v take the
    parameter's spec; Adafactor's factored statistics the spec with the
    reduced dimension removed; int8 payloads (``Q8``) are replicated
    (their blocked layout is the whole leaf's)."""
    by_path = dict(walk(pspecs))

    def pad(base: P, rank: int) -> tuple:
        t = tuple(base)
        return t + (None,) * (rank - len(t))

    def spec(path, leaf):
        for prefix in ("m/", "v/", "stats/"):
            if not path.startswith(prefix):
                continue
            rest = path[len(prefix):]
            if rest in by_path:  # plain adam m/v — same shape, same spec
                return by_path[rest]
            if "/" in rest:
                cand, suffix = rest.rsplit("/", 1)
                if cand in by_path:
                    base = pad(by_path[cand], len(leaf.shape) + 1)
                    if suffix == "vr":  # the parameter's shape minus its last dim
                        return _strip(list(base[:-1]))
                    if suffix == "vc":  # minus its second-to-last dim
                        return _strip(list(base[:-2] + base[-1:]))
                    if suffix == "v":
                        return _strip(list(base[:len(leaf.shape)]))
                    return P()  # q / scale payloads
        return P()

    return map_with_path(spec, opt_state)


def batch_axes(mesh) -> tuple[str, ...]:
    names = tuple(axis_sizes(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def batch_entry(mesh, b: int):
    """A batch dimension's spec entry: the batch axes where they divide
    ``b`` rows, else None (replicated)."""
    ba = batch_axes(mesh)
    dp = axis_extent(mesh, ba)
    if not (b % dp == 0 and b >= dp):
        return None
    return ba[0] if len(ba) == 1 else ba  # P(("data",)) is P("data")


def batch_specs(cfg, shape, mesh) -> dict:
    """Specs of the train / prefill batch: its rows over ("pod", "data")
    where they divide, else replicated."""
    bspec = batch_entry(mesh, shape.global_batch)
    specs = {"tokens": _strip([bspec, None])}
    if shape.kind == "train":
        specs["labels"] = _strip([bspec, None])
    if cfg.frontend == "vision":
        specs["patches"] = _strip([bspec, None, None])
    elif cfg.frontend == "audio":
        specs["frames"] = _strip([bspec, None, None])
    return specs


def token_spec(shape, mesh) -> P:
    """The decode token's (B, 1) spec."""
    return _strip([batch_entry(mesh, shape.global_batch), None])


def cache_specs(cache, cfg, shape, mesh):
    """Decode-cache specs: the batch over ("pod", "data") where it divides;
    a KV cache's sequence over "model" (sequence-parallel decode attention:
    the softmax's max and sums become all-reduces and the cache is never
    gathered); Mamba's channels over "model"; mLSTM / sLSTM states
    replicated."""
    model = axis_sizes(mesh).get("model", 1)
    bspec = batch_entry(mesh, shape.global_batch)

    def spec(path, leaf):
        dims = tuple(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        out: list = [bspec]
        if name in ("k", "v", "ck", "cv", "cross_k", "cross_v"):
            s = dims[1]
            out += ["model" if s % model == 0 and cfg.family != "ssm" else None, None, None]
        elif name == "clogw":
            out += ["model" if dims[1] % model == 0 else None, None]
        elif path.endswith("state/conv"):
            out += [None, "model" if dims[2] % model == 0 else None]
        elif path.endswith("state/ssm"):
            out += ["model" if dims[1] % model == 0 else None, None]
        else:  # mLSTM C / n / m, sLSTM h / c / n / m: small, replicated
            out += [None] * (len(dims) - 1)
        return _strip(out)

    return map_with_path(spec, cache)


def seq_sharded(s_full: int, model: int, cfg) -> bool:
    """Whether a KV cache of ``s_full`` positions has its sequence over
    "model" (``cache_specs``'s rule for "k" / "v")."""
    return model > 1 and s_full % model == 0 and cfg.family != "ssm"


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` placed by ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, e in enumerate(spec):
        if e is None:
            continue
        for a in ((e,) if isinstance(e, str) else e):
            out[dim] //= sizes[a]
    return tuple(out)


def _axes_of(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_leaf(t: torch.Tensor, spec, sp) -> torch.Tensor:
    """This rank's block of a full leaf (a view)."""
    from repro_torch.parallel.collectives import as_spmd, own_slice

    sp = as_spmd(sp)
    for dim, e in enumerate(spec):
        if e is not None:
            t = own_slice(t, sp, e, dim)
    return t


def gather_leaf(t: torch.Tensor, spec, sp) -> torch.Tensor:
    """The full leaf from every rank's block (a collective)."""
    from repro_torch.parallel.collectives import as_spmd, gather_steps

    sp = as_spmd(sp)
    steps = [(a, dim) for dim, e in enumerate(spec) if e is not None
             for a in reversed(_axes_of(e))]
    out = gather_steps(t.detach(), sp, steps)
    # A new tensor always: never the caller's storage.
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def sharded_axes(spec) -> tuple[str, ...]:
    """The mesh axes a leaf placed by ``spec`` is split over, sorted."""
    return tuple(sorted({a for e in spec if e is not None for a in _axes_of(e)}))


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of a full tree (the counterpart of
    ``to_shardings`` and placement): a view of the leaf, cloned so that the
    full leaf can go."""
    from repro_torch.parallel.collectives import as_spmd

    sp = as_spmd(mesh)
    flat = dict(walk(specs))
    return map_with_path(lambda path, leaf: shard_leaf(leaf, flat[path], sp).clone(), tree)


def gather_tree(tree, specs, mesh):
    """The full tree back from every rank's blocks (a collective: every rank
    calls it, in the same order)."""
    from repro_torch.parallel.collectives import as_spmd

    sp = as_spmd(mesh)
    flat = dict(walk(specs))
    return map_with_path(lambda path, leaf: gather_leaf(leaf, flat[path], sp), tree)
