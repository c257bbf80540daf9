"""The port's LM sharding rules against the reference's, at full size.

``repro_torch.parallel.sharding``'s ``param_specs``, ``opt_state_specs``
(adamw, adamw8, adafactor), ``batch_specs`` (train, prefill, decode) and
``cache_specs`` (every cache mode) for all ten architectures, on stand-in
meshes of the production shapes (16, 16) and (2, 16, 16) and on (2, 2).
The reference's spec functions read only a mesh's axis names and shape, so
a ``SimpleNamespace`` stands in for a ``jax.sharding.Mesh`` and the shapes
come from ``jax.eval_shape``; the port's from the meta device.  The port's
trees are unstacked: a group leaf's spec is the reference's without its
leading None, and the reference's ``groups/<i>/...`` leaf stands for the
port's ``groups/<g>/<i>/...`` of every group g.
"""

import functools
import types

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro.parallel import sharding as jsh
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import sharding as tsh

pytestmark = pytest.mark.torch_port

MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
}
OPTS = ("adamw", "adamw8", "adafactor")


def _ref_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(name):
    names, shape = MESHES[name]
    return tsh.MeshShape(names, shape)


def _norm(spec):
    """A spec as a plain tuple without trailing Nones."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple((e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (list, tuple)) else e
                 for e in out)


def _ref_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(jsh._path_str([k]).lstrip(".") for k in path): _norm(v)
            for path, v in flat}


def _port_flat(specs):
    return {path: _norm(v) for path, v in tsh.walk(specs)}


def _expand(ref: dict, arch: str) -> dict:
    """The reference's paths as the port's: a stacked leaf (under a
    ``groups`` component) for every group g (the encoder's: every layer),
    its leading None dropped."""
    cfg = tbase.get_config(arch)
    out = {}
    for path, spec in ref.items():
        parts = path.split("/")
        if "groups" not in parts:
            out[path] = spec
            continue
        at = parts.index("groups")
        if spec[:1] not in ((), (None,)):
            # Adafactor's vc of a stacked (G, d) vector drops the stacking
            # dimension itself; the port keeps one v there (see below).
            assert parts[0] == "stats" and parts[-1] == "vc", (path, spec)
            continue
        encoder = at > 0 and parts[at - 1] == "encoder"
        n = cfg.encoder_layers if encoder else cfg.n_layers // cfg.period
        for g in range(n):
            out["/".join(parts[:at + 1] + [str(g)] + parts[at + 1:])] = spec[1:]
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    ref = jax.eval_shape(lambda: jtfm.init_lm(jax.random.PRNGKey(0), jcfg))
    port = ttfm.init_lm(0, tcfg, device="meta")
    return jcfg, tcfg, ref, port


@functools.lru_cache(maxsize=None)
def _opt_shapes(arch, name):
    _, _, ref_p, port_p = _shapes(arch)
    ref_opt = jax.eval_shape(jopt.make_optimizer(jopt.OptConfig(name=name)).init, ref_p)
    return ref_opt, topt.make_optimizer(topt.OptConfig(name=name)).init(port_p)


def _compare(arch, ref_specs, port_specs, allowed_missing=lambda path: False):
    want = _expand(_ref_flat(ref_specs), arch)
    got = _port_flat(port_specs)
    common = want.keys() & got.keys()
    assert common, arch
    bad = {p: (want[p], got[p]) for p in common if want[p] != got[p]}
    assert not bad, dict(list(bad.items())[:5])
    unmatched = want.keys() ^ got.keys()
    assert all(allowed_missing(p) for p in unmatched), sorted(unmatched)[:5]
    return len(common)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh):
    jcfg, tcfg, ref_p, port_p = _shapes(arch)
    ref_specs = jsh.param_specs(ref_p, jcfg, _ref_mesh(mesh))
    port_specs = tsh.param_specs(port_p, tcfg, _port_mesh(mesh))
    n = _compare(arch, ref_specs, port_specs)
    assert n == len(list(tsh.walk(port_p)))
    for name in OPTS:
        ref_opt, port_opt = _opt_shapes(arch, name)

        def stacked_1d_stats(path, port_p=port_p):
            # Adafactor factors the reference's stacked (G, d) vectors into vr
            # and vc; the port's (d,) leaf keeps one v (ROADMAP Queue 3).
            param = path.split("/", 1)[1].rsplit("/", 1)[0]
            leaf = dict(tsh.walk(port_p)).get(param)
            return name == "adafactor" and leaf is not None and leaf.ndim == 1 \
                and "groups/" in param
        _compare(arch, jsh.opt_state_specs(ref_opt, ref_specs),
                 tsh.opt_state_specs(port_opt, port_specs), stacked_1d_stats)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    rmesh, pmesh = _ref_mesh(mesh), _port_mesh(mesh)
    for shape_name, jshape in jbase.SHAPES.items():
        tshape = tbase.SHAPES[shape_name]
        assert _norm_tree(jsh.batch_specs(jcfg, jshape, rmesh)) == \
            _norm_tree(tsh.batch_specs(tcfg, tshape, pmesh)), shape_name
        if jshape.kind in ("decode", "long_decode"):
            from repro.launch import serve as jserve

            ref_cache = jax.eval_shape(lambda: jtfm.init_cache(
                jcfg, jshape.global_batch, jshape.seq_len, jserve.cache_mode(jcfg, jshape)))
            port_cache = ttfm.init_cache(tcfg, tshape.global_batch, tshape.seq_len,
                                         tserve.cache_mode(tcfg, tshape), device="meta")
            _compare(arch, jsh.cache_specs(ref_cache, jcfg, jshape, rmesh),
                     tsh.cache_specs(port_cache, tcfg, tshape, pmesh))
            # The decode token's spec is the serve step's batch spec.
            want = jsh.batch_specs(jcfg, jshape, rmesh)["tokens"]
            assert _norm(tsh.token_spec(tshape, pmesh)) == _norm(want)


def _norm_tree(specs: dict) -> dict:
    return {k: _norm(v) for k, v in specs.items()}


def test_production_mesh_shapes():
    assert tmesh.make_production_mesh() == tsh.MeshShape(("data", "model"), (16, 16))
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.shape == (2, 16, 16)
    assert tsh.axis_sizes(multi) == {"pod": 2, "data": 16, "model": 16}
    assert tsh.batch_axes(multi) == ("pod", "data")
