"""The port's ``Checkpointer``: atomic round trips, retention, torn
directories, ``meta``, the flavour and shape guards, an async snapshot that
a later in-place write cannot reach, and the reference's on-disk format in
both directions — a float, a 1-bit and a decayed engine row written by
either package restore bitwise in the other, and a service's ``{"row": ...,
"window": [...]}`` payload keeps JAX's leaf order."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.core import freq_ops as jfo
from repro.core import quantize as jqz
from repro.core.engine import SketchEngine as JaxEngine
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _flatten, _unflatten
from repro_torch.core.engine import (
    QuantizedSketchEngineState,
    SketchEngine,
    SketchEngineState,
)

pytestmark = pytest.mark.torch_port

N, M = 3, 32


def _state(seed=0, m=M):
    g = torch.Generator().manual_seed(seed)
    return SketchEngineState(
        cos_acc=torch.randn(m, generator=g), sin_acc=torch.randn(m, generator=g),
        weight_sum=torch.tensor(5.0), lower=torch.randn(N, generator=g),
        upper=torch.randn(N, generator=g), count=torch.tensor(5.0),
    )


def _equal(a, b):
    la, lb = _flatten(a), _flatten(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_round_trip_of_a_nested_state(tmp_path):
    ck = Checkpointer(tmp_path)
    state = {"b": [_state(1), (torch.arange(4, dtype=torch.int32), None)], "a": _state(2)}
    ck.save(7, state)
    like = {"b": [_state(9), (torch.zeros(4, dtype=torch.int32), None)], "a": _state(8)}
    got = ck.restore(like)
    assert _equal(got, state) and list(got) == ["b", "a"]
    assert got["b"][1][1] is None and isinstance(got["a"], SketchEngineState)
    manifest = json.loads((tmp_path / "step_0000000007" / "manifest.json").read_text())
    # Keys sorted: "a"'s six leaves, then "b"'s state and its int32 leaf.
    assert [e["dtype"] for e in manifest["leaves"]] == ["float32"] * 12 + ["int32"]
    assert manifest["leaves"][0]["shape"] == [M] and manifest["leaves"][2]["shape"] == []
    assert manifest["step"] == 7 and "SketchEngineState" in manifest["treedef"]


def test_leaf_order_is_jax_pytree_order():
    tree = {"z": (1, [2, 3]), "a": {"y": 4, "b": None, "c": 5}, "m": _state()._replace(
        cos_acc=6, sin_acc=7, weight_sum=8, lower=9, upper=10, count=11)}
    want = jax.tree_util.tree_leaves(tree)
    assert _flatten(tree) == want == [5, 4, 6, 7, 8, 9, 10, 11, 1, 2, 3]
    back = _unflatten(tree, iter(range(100, 111)))
    assert jax.tree_util.tree_leaves(back) == list(range(100, 111))
    assert back["a"] == {"y": 101, "b": None, "c": 100} and list(back["a"]) == ["y", "b", "c"]
    assert back["m"].count == 107 and back["z"] == (108, [109, 110])


def test_restore_places_leaves(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(0, {"x": torch.arange(3.0)})
    as_np = ck.restore({"x": np.zeros(3, np.float32)})
    assert isinstance(as_np["x"], np.ndarray)
    on_dev = ck.restore({"x": np.zeros(3, np.float32)}, device="cpu")
    assert isinstance(on_dev["x"], torch.Tensor) and on_dev["x"].device.type == "cpu"
    np.testing.assert_array_equal(as_np["x"], [0.0, 1.0, 2.0])


def test_retention_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, _state(step))
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert _equal(ck.restore(_state()), _state(4))
    assert _equal(ck.restore(_state(), step=3), _state(3))


def test_torn_and_tmp_directories_are_ignored(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(2, _state(2))
    (tmp_path / "step_0000000009").mkdir()  # torn: no manifest
    (tmp_path / "step_0000000010.tmp").mkdir()  # a writer preempted mid-write
    assert ck.all_steps() == [2]
    assert _equal(ck.restore(_state()), _state(2))
    # A rewrite of a step whose tmp directory was left behind succeeds.
    (tmp_path / "step_0000000003.tmp").mkdir()
    ck.save(3, _state(3))
    assert ck.all_steps() == [2, 3] and not (tmp_path / "step_0000000003.tmp").exists()


def test_empty_directory_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_state())
    with pytest.raises(FileNotFoundError):
        ck.read_meta()


def test_meta_round_trip(tmp_path):
    ck = Checkpointer(tmp_path)
    state = {"a": torch.arange(4.0)}
    ck.save(3, state, meta={"tenant": 7, "freq_op_spec": ["dense", 1]})
    ck.save(5, state, meta={"tenant": 7, "version": 5})
    assert ck.read_meta(3) == {"tenant": 7, "freq_op_spec": ["dense", 1]}
    assert ck.read_meta() == {"tenant": 7, "version": 5}
    ck.save(6, state)  # no meta -> {}
    assert ck.read_meta(6) == {}
    ck.save(8, state, specs={"op": ("dense", 3)})
    manifest = json.loads((tmp_path / "step_0000000008" / "manifest.json").read_text())
    assert manifest["specs"] == ["'dense'", "3"]


def test_flavour_shape_and_count_guards(tmp_path):
    ck = Checkpointer(tmp_path)
    fstate = _state()
    ck.save(0, fstate)
    qlike = QuantizedSketchEngineState(
        qcos_acc=torch.zeros(M, dtype=torch.int32), qsin_acc=torch.zeros(M, dtype=torch.int32),
        weight_sum=torch.zeros(()), lower=torch.zeros(N), upper=torch.zeros(N),
        count=torch.zeros(()),
    )
    with pytest.raises(ValueError, match="flavour"):
        ck.restore(qlike)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(fstate._replace(cos_acc=torch.zeros(M * 2)))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"only": torch.zeros(M)})


def test_save_async_snapshots_before_an_in_place_write(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state(3)
    want = SketchEngineState(*(t.clone() for t in state))
    ck.save_async(1, state)
    for t in state:  # what ingest_stream(donate=True) does to a carried state
        t.add_(1000.0)
    ck.wait()
    assert _equal(ck.restore(_state()), want)


# -- the reference's format, both ways --------------------------------------------


def _reference_rows():
    """Float, 1-bit and decayed rows of reference engines over one operator."""
    op = jfo.make_operator("dense", jax.random.PRNGKey(1), M, N, jnp.asarray(1.0))
    x = jax.random.normal(jax.random.PRNGKey(2), (40, N))
    rows = {}
    eng = JaxEngine(op)
    rows["float"] = eng.update(eng.init_state(), x)
    q = jqz.make_quantizer(jax.random.PRNGKey(3), M, "1bit")
    qeng = JaxEngine(op, quantizer=q)
    rows["1bit"] = qeng.update(qeng.init_state(), x)
    deng = JaxEngine(op, decay=0.5)
    rows["decayed"] = deng.update(deng.update(deng.init_state(), x[:20], t=1.0), x[20:], t=3.0)
    return op, q, rows


def _port_like(op, q, flavour):
    w = convert.operator_from_numpy(np.asarray(op.w), device="cpu")
    quant = convert.quantizer_from_numpy(q.bits, np.asarray(q.dither), device="cpu")
    kw = {"1bit": dict(quantizer=quant), "decayed": dict(decay=0.5)}.get(flavour, {})
    return SketchEngine(w, device="cpu", **kw).init_state()


@pytest.mark.parametrize("flavour", ["float", "1bit", "decayed"])
def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path, flavour):
    op, q, rows = _reference_rows()
    JaxCheckpointer(tmp_path).save(4, rows[flavour], meta={"tenant": 1})
    ck = Checkpointer(tmp_path)
    got = ck.restore(_port_like(op, q, flavour))
    want = rows[flavour]
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == {jnp.float32: torch.float32, jnp.int32: torch.int32}[b.dtype.type]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ck.read_meta() == {"tenant": 1}


@pytest.mark.parametrize("flavour", ["float", "1bit", "decayed"])
def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path, flavour):
    op, q, rows = _reference_rows()
    want = rows[flavour]
    port_row = type(_port_like(op, q, flavour))(*(torch.from_numpy(np.array(v)) for v in want))
    Checkpointer(tmp_path).save(4, port_row)
    like = jax.tree_util.tree_map(jnp.zeros_like, want)
    got = JaxCheckpointer(tmp_path).restore(like)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_window_payload_keeps_its_leaf_order_across_packages(tmp_path):
    """A windowed service's eviction payload: the lifetime row and W bucket
    rows, each different, written by the reference, read by the port, and
    back."""
    op, q, rows = _reference_rows()
    eng = JaxEngine(op)
    xs = jax.random.normal(jax.random.PRNGKey(9), (3, 7, N))
    column = [eng.update(eng.init_state(), xs[i]) for i in range(3)]
    payload = {"window": column, "row": rows["float"]}
    JaxCheckpointer(tmp_path / "ref").save(1, payload)
    like0 = _port_like(op, q, "float")
    got = Checkpointer(tmp_path / "ref").restore({"row": like0, "window": [like0] * 3})
    for g, w in zip([got["row"], *got["window"]], [rows["float"], *column]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Checkpointer(tmp_path / "port").save(1, got)
    back = JaxCheckpointer(tmp_path / "port").restore(
        jax.tree_util.tree_map(jnp.zeros_like, payload))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(payload)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bf16_bits(seed, shape):
    """Every 16-bit pattern is a bfloat16 (NaNs and infinities included)."""
    return np.random.default_rng(seed).integers(0, 1 << 16, size=shape, dtype=np.uint16)


def _bf16_state(bits):
    return {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
            "m": torch.arange(5, dtype=torch.float32), "step": torch.tensor(3, dtype=torch.int32)}


def _bits(t) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_bf16_state_round_trips_bitwise(tmp_path):
    bits = _bf16_bits(0, (7, 9))
    Checkpointer(tmp_path).save(1, _bf16_state(bits))
    manifest = json.loads((tmp_path / "step_0000000001" / "manifest.json").read_text())
    assert [e["dtype"] for e in manifest["leaves"]] == ["float32", "int32", "bfloat16"]
    assert np.load(tmp_path / "step_0000000001" / "leaf_00002.npy").dtype.itemsize == 2
    got = Checkpointer(tmp_path).restore(_bf16_state(np.zeros((7, 9), np.uint16)))
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), bits)
    assert torch.equal(got["m"], torch.arange(5, dtype=torch.float32))


def test_reference_bf16_checkpoint_restores_bitwise_in_the_port(tmp_path):
    import ml_dtypes

    bits = _bf16_bits(1, (4, 6))
    state = {"w": jnp.asarray(bits.view(ml_dtypes.bfloat16)), "m": jnp.arange(5.0),
             "step": jnp.asarray(3, jnp.int32)}
    JaxCheckpointer(tmp_path).save(2, state)
    manifest = json.loads((tmp_path / "step_0000000002" / "manifest.json").read_text())
    assert manifest["leaves"][2]["dtype"] == "bfloat16"
    got = Checkpointer(tmp_path).restore(_bf16_state(np.zeros((4, 6), np.uint16)))
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), bits)


def test_port_bf16_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    import ml_dtypes

    bits = _bf16_bits(2, (3, 5))
    Checkpointer(tmp_path).save(3, _bf16_state(bits))
    like = {"w": jnp.zeros((3, 5), jnp.bfloat16), "m": jnp.zeros(5, jnp.float32),
            "step": jnp.asarray(0, jnp.int32)}
    got = JaxCheckpointer(tmp_path).restore(like)
    # The reference hands back each leaf as np.load reads it: the bf16
    # leaf's 16-bit patterns, which are the state's.
    np.testing.assert_array_equal(np.asarray(got["w"]).view(np.uint16), bits)
    back = np.asarray(got["w"]).view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.uint16), bits)
