"""The port's sharded SketchEngine, ``distributed_sketch`` and sharded fits
over ``torch.distributed`` with gloo on the CPU, against the reference.

- A world of one rank, in process: the sharded backend is bitwise the
  "kernel" backend under every topology (every collective is the identity).
- Four ranks, spawned once (``tests/_torch_dist_ranks.py``): the port of the
  reference's in-mesh parity tests (``test_topology.py::TestShardedTopologies``,
  ``test_distributed.py::test_sharded_sketch_multidevice``) — every topology
  within 1e-4 of the reference's sketch, the ragged stream with an empty
  rank, the (2, 2) ("pod", "data") mesh within 1e-5, 1-bit sums bitwise
  across topologies and ranks and equal to the reference's under the
  boundary rule, decayed states, async ingest, and sharded fits whose ranks
  agree bitwise.
- Three ranks: the butterfly refuses the axis, naming "power-of-two".

The ranks never import JAX: each saves its results under ``tmp_path``, and
this process compares them with the reference.  Every spawn has its own time
limit, and every collective its own timeout (``_torch_dist_ranks.py``).
"""

import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import engine as jeng
from repro.core import freq_ops as jfo
from repro.core import quantize as jqz
from repro.core import sketch as jsk
from repro_torch import convert
from repro_torch import device as dev_mod
from repro_torch.core import ckm
from repro_torch.core import engine as teng
from repro_torch.data.pipeline import chunked

from _torch_codes import assert_sums_within_flips

pytestmark = pytest.mark.torch_port

TOPOLOGY_NAMES = ("allreduce", "tree", "ring")
RANKS = Path(__file__).with_name("_torch_dist_ranks.py")
SPAWN_TIMEOUT_S = 240


def _inputs(seed=0, npts=4096, n=6, m=48):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((npts, n)).astype(np.float32),
        "w": rng.standard_normal((n, m)).astype(np.float32),
        "dither": rng.uniform(0, 2 * np.pi, size=m).astype(np.float32),
    }


def _spawn(root: Path, scenario: str, world: int, inputs) -> list[dict]:
    """Run ``scenario`` on ``world`` gloo ranks; their results, by rank.  The
    launcher runs in its own session, killed whole at the time limit."""
    np.savez(root / "inputs.npz", **inputs)
    proc = subprocess.Popen(
        [sys.executable, str(RANKS), scenario, str(world), str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        _, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{scenario} on {world} ranks took more than {SPAWN_TIMEOUT_S} s")
    assert proc.returncode == 0, err[-4000:]
    return [torch.load(root / f"rank{r}.pt") for r in range(world)]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def _kernel_engine(inputs, bits=None, decay=None):
    q = None if bits is None else convert.quantizer_from_numpy(bits, inputs["dither"], device="cpu")
    return teng.SketchEngine(convert.operator_from_numpy(inputs["w"], device="cpu"),
                             device="cpu", quantizer=q, decay=decay)


def _reference_sketch(x, w):
    return np.asarray(jsk.sketch(jnp.asarray(x), jnp.asarray(w)))


def _reference_codes(inputs, x):
    q = jqz.SketchQuantizer(1, jnp.asarray(inputs["dither"]))
    je = jeng.SketchEngine(jfo.as_operator(jnp.asarray(inputs["w"])), "xla", quantizer=q)
    return je.update(je.init_state(), jnp.asarray(x))


# -- a world of one rank, in process ----------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init", rank=0,
                            world_size=1)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("topology", TOPOLOGY_NAMES)
def test_world_of_one_is_bitwise_the_kernel_backend(world_of_one, topology):
    inputs = _inputs(1, npts=900)
    x = torch.from_numpy(inputs["x"])
    w = convert.operator_from_numpy(inputs["w"], device="cpu")
    for bits in (None, 1):
        for decay in (None, 0.9):
            q = (None if bits is None
                 else convert.quantizer_from_numpy(bits, inputs["dither"], device="cpu"))
            ref = teng.SketchEngine(w, device="cpu", quantizer=q, decay=decay)
            sh = teng.SketchEngine(w, "sharded", device="cpu", mesh=world_of_one, quantizer=q,
                                   decay=decay, reduce_topology=topology)
            a, b = ref.init_state(), sh.init_state()
            for t, c in enumerate(chunked(x, 250)):
                kw = {} if decay is None else {"t": t}
                a, b = ref.update(a, c, **kw), sh.update(b, c, **kw)
            assert type(a) is type(b)
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (bits, decay, f)
            assert sh.shard_points(x) is not None and torch.equal(sh.shard_points(x), x)
    ws = torch.from_numpy(np.random.default_rng(2).uniform(size=900).astype(np.float32))
    for got, want in zip(teng.SketchEngine(w, "sharded", device="cpu", mesh=world_of_one,
                                           reduce_topology=topology).sketch(x, ws),
                         teng.SketchEngine(w, device="cpu").sketch(x, ws)):
        assert torch.equal(got, want)


def test_world_of_one_structured_and_fit(world_of_one):
    """A structured operator through the sharded backend, and a sharded fit:
    the kernel backend's bits, decode included."""
    from repro_torch.core import freq_ops

    inputs = _inputs(3, npts=700, n=5)
    x = torch.from_numpy(inputs["x"])
    op = freq_ops.make_operator("structured", dev_mod.generator(0, torch.device("cpu")), 40, 5,
                                torch.tensor(1.0), device="cpu")
    for got, want in zip(teng.SketchEngine(op, "sharded", device="cpu", mesh=world_of_one,
                                           reduce_topology="ring").sketch(x),
                         teng.SketchEngine(op, device="cpu").sketch(x)):
        assert torch.equal(got, want)
    cfg = ckm.CKMConfig(k=2, m=30, atom_steps=15, joint_steps=10, final_steps=15, nnls_iters=15)
    sharded = ckm.fit(4, x, ckm.dataclasses.replace(cfg, sketch_backend="sharded",
                                                    reduce_topology="tree"),
                      device="cpu", mesh=world_of_one)
    single = ckm.fit(4, x, cfg, device="cpu")
    for f in ("centroids", "weights", "cost", "sigma2", "sketch"):
        assert torch.equal(getattr(sharded, f), getattr(single, f)), f


def test_sharded_mesh_checks(world_of_one):
    w = np.ones((4, 8), np.float32)
    with pytest.raises(ValueError, match="backend='sharded' requires a mesh"):
        teng.SketchEngine(w, "sharded", device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        ckm.fit(0, torch.zeros((10, 4)), ckm.CKMConfig(k=2, sketch_backend="sharded"),
                device="cpu")
    cuda_mesh = types.SimpleNamespace(device_type="cuda", mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="device type 'cuda' is not the engine's device"):
        teng.SketchEngine(w, "sharded", device="cpu", mesh=cuda_mesh)
    with pytest.raises(ValueError, match=r"data axes \['pod'\] are not axes of the mesh"):
        teng.SketchEngine(w, "sharded", device="cpu", mesh=world_of_one, data_axes=("pod",))
    with pytest.raises(ValueError, match="unknown reduce topology"):
        teng.SketchEngine(w, "sharded", device="cpu", mesh=world_of_one, reduce_topology="star")
    with pytest.raises(ValueError, match="shard_points needs the 'sharded' backend's mesh"):
        teng.SketchEngine(w, device="cpu").shard_points(torch.zeros((3, 4)))


def test_sharded_without_a_process_group_raises():
    assert not dist.is_initialized()
    mesh = types.SimpleNamespace(device_type="cpu", mesh_dim_names=("data",))
    with pytest.raises(RuntimeError, match="initialised torch.distributed process group"):
        teng.SketchEngine(np.ones((4, 8), np.float32), "sharded", device="cpu", mesh=mesh)


# -- four ranks --------------------------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    inputs = _inputs(0)
    return inputs, _spawn(tmp_path_factory.mktemp("four_ranks"), "parity", 4, inputs)


def test_four_ranks_agree_bitwise(four_ranks):
    _, ranks = four_ranks
    for key, value in ranks[0].items():
        if key.endswith("ragged_rows"):
            continue
        for r, other in enumerate(ranks[1:], 1):
            for a, b in zip(_as_tuple(value), _as_tuple(other[key])):
                assert torch.equal(a, b), (key, r)


@pytest.mark.parametrize("topology", TOPOLOGY_NAMES)
def test_four_ranks_float_sketch_matches_the_reference(four_ranks, topology):
    inputs, ranks = four_ranks
    x = inputs["x"]
    z, lo, hi = ranks[0][f"{topology}/float"]
    np.testing.assert_allclose(z.numpy(), _reference_sketch(x, inputs["w"]), atol=1e-4)
    np.testing.assert_allclose(lo.numpy(), x.min(0), atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), x.max(0), atol=1e-6)
    z_pod, lo_pod, hi_pod = ranks[0][f"{topology}/pod_data"]
    np.testing.assert_allclose(z_pod.numpy(), _reference_sketch(x, inputs["w"]), atol=1e-5)
    assert torch.equal(lo_pod, lo) and torch.equal(hi_pod, hi)


@pytest.mark.parametrize("topology", TOPOLOGY_NAMES)
def test_four_ranks_ragged_stream_with_an_empty_rank(four_ranks, topology):
    inputs, ranks = four_ranks
    x = inputs["x"][:4003]
    assert [int(r[f"{topology}/ragged_rows"][-1]) for r in ranks] == [1, 1, 1, 0]
    z, lo, hi = ranks[0][f"{topology}/ragged"]
    np.testing.assert_allclose(z.numpy(), _reference_sketch(x, inputs["w"]), atol=1e-4)
    np.testing.assert_allclose(lo.numpy(), x.min(0), atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), x.max(0), atol=1e-6)


def test_four_ranks_one_bit_sums_bitwise_and_as_the_reference(four_ranks):
    inputs, ranks = four_ranks
    x = inputs["x"]
    states = [ranks[0][f"{name}/1bit"] for name in TOPOLOGY_NAMES]
    for s in states[1:]:
        for a, b in zip(states[0], s):
            assert torch.equal(a, b)
    single = _kernel_engine(inputs, bits=1)
    whole = single.update(single.init_state(), torch.from_numpy(x))
    for a, b in zip(states[0], whole):
        assert torch.equal(a, b)  # each point's codes do not depend on the split
    assert states[0][0].dtype == torch.int32 and float(states[0][5]) == x.shape[0]
    assert_sums_within_flips(states[0][:2], _reference_codes(inputs, x)[:2],
                             x @ inputs["w"] + inputs["dither"], 1)


@pytest.mark.parametrize("topology", TOPOLOGY_NAMES)
def test_four_ranks_decayed_states(four_ranks, topology):
    """Decayed float and 1-bit states over five ticks: the 1-bit one bitwise
    the single engine's, the float one's sketch within 1e-5 of it (its
    other fields bitwise), and both finalize within 1e-4 of the reference's
    decayed engine."""
    inputs, ranks = four_ranks
    x = inputs["x"]
    for bits, key in ((None, "decayed"), (1, "decayed_1bit")):
        single = _kernel_engine(inputs, bits=bits, decay=0.9)
        s = single.init_state()
        for t, c in enumerate(chunked(torch.from_numpy(x), 1000)):
            s = single.update(s, c, t=t)
        got = type(s)(*ranks[0][f"{topology}/{key}"])
        for f in s._fields:
            if bits == 1 or f not in ("cos_acc", "sin_acc", "weight_sum"):
                assert torch.equal(getattr(got, f), getattr(s, f)), (key, f)
        # The float sums re-associate across ranks: 1e-5 on sums / weight.
        np.testing.assert_allclose(single.finalize(got)[0].numpy(), single.finalize(s)[0].numpy(),
                                   atol=1e-5)
        q = None if bits is None else jqz.SketchQuantizer(1, jnp.asarray(inputs["dither"]))
        je = jeng.SketchEngine(jfo.as_operator(jnp.asarray(inputs["w"])), "xla", quantizer=q,
                               decay=0.9)
        js = je.init_state()
        for t, c in enumerate(chunked(x, 1000)):
            js = je.update(js, jnp.asarray(c), t=t)
        np.testing.assert_allclose(single.finalize(got)[0].numpy(), np.asarray(je.finalize(js)[0]),
                                   atol=1e-4)


def test_four_ranks_async_ingest_gives_the_sync_bits(four_ranks):
    _, ranks = four_ranks
    for a, b in zip(ranks[0]["ingest_sync"], ranks[0]["ingest_async"]):
        assert torch.equal(a, b)


def test_four_ranks_distributed_sketch(four_ranks):
    inputs, ranks = four_ranks
    x = inputs["x"]
    for key in ("distributed_sketch", "distributed_sketch/pod_data"):
        z, lo, hi = ranks[0][key]
        np.testing.assert_allclose(z.numpy(), _reference_sketch(x, inputs["w"]), atol=1e-5)
        np.testing.assert_allclose(lo.numpy(), x.min(0), atol=1e-6)
        np.testing.assert_allclose(hi.numpy(), x.max(0), atol=1e-6)


def test_four_ranks_sharded_fits(four_ranks):
    """The 2-way sharded fit (pods as replicas): sigma^2 bitwise the
    single-process fit's on the same global x, the sketch within 1e-5 and
    the bounds equal; the streaming fit's sigma^2 from rank 0's first batch
    (the first 512 rows)."""
    inputs, ranks = four_ranks
    x = torch.from_numpy(inputs["x"])
    cfg = ckm.CKMConfig(k=3, m=48, atom_steps=20, joint_steps=10, final_steps=20, nnls_iters=20)
    seed = dev_mod.derive_seed(7, 0)
    z, _, sigma2, (lo, hi) = ckm.compute_sketch(seed, x, cfg, device="cpu")
    cents, weights, cost, got_sigma2, got_z, got_lo, got_hi = ranks[0]["fit"]
    assert torch.equal(got_sigma2, sigma2)
    np.testing.assert_allclose(got_z.numpy(), z.numpy(), atol=1e-5)
    assert torch.equal(got_lo, lo) and torch.equal(got_hi, hi)
    assert cents.shape == (3, 6) and bool(torch.isfinite(cents).all())
    assert abs(float(weights.sum()) - 1.0) < 1e-5 and cost.ndim == 0
    _, _, sigma2_first, _ = ckm.compute_sketch(seed, x[:512], cfg, device="cpu")
    assert torch.equal(ranks[0]["fit_streaming"][3], sigma2_first)
    at_first = ckm.dataclasses.replace(cfg, sigma2=float(sigma2_first))
    z_first, *_ = ckm.compute_sketch(seed, x, at_first, device="cpu")
    np.testing.assert_allclose(ranks[0]["fit_streaming"][4].numpy(), z_first.numpy(), atol=1e-5)


# -- three ranks -------------------------------------------------------------


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    inputs = _inputs(5, npts=3001)
    return inputs, _spawn(tmp_path_factory.mktemp("three_ranks"), "tree3", 3, inputs)


def test_three_ranks_tree_needs_a_power_of_two(three_ranks):
    _, ranks = three_ranks
    for r in ranks:
        assert "power-of-two" in r["tree_error"], r["tree_error"]
        assert "got 3" in r["tree_error"]


@pytest.mark.parametrize("topology", ["allreduce", "ring"])
def test_three_ranks_reduce_as_the_reference(three_ranks, topology):
    inputs, ranks = three_ranks
    x = inputs["x"]
    z, lo, hi = ranks[0][f"{topology}/float"]
    np.testing.assert_allclose(z.numpy(), _reference_sketch(x, inputs["w"]), atol=1e-4)
    np.testing.assert_array_equal(lo.numpy(), x.min(0))
    np.testing.assert_array_equal(hi.numpy(), x.max(0))
    for r in ranks[1:]:
        for a, b in zip(ranks[0][f"{topology}/float"] + ranks[0][f"{topology}/1bit"],
                        r[f"{topology}/float"] + r[f"{topology}/1bit"]):
            assert torch.equal(a, b)
    assert_sums_within_flips(ranks[0][f"{topology}/1bit"][:2], _reference_codes(inputs, x)[:2],
                             x @ inputs["w"] + inputs["dither"], 1)
