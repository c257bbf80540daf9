"""The port's cost mode (``repro_torch.utils.hlo``) against the reference's
trip-count-aware HLO analyzer on the programs of ``tests/test_hlo.py``: a
matmul, a loop of 8 (``lax.scan`` there), 3 x 5 nested loops and a batched
einsum give the same flops; elementwise bytes fall in the reference's band;
the cost model's byte rules and live bytes; and the collectives of
``parallel/collectives.py`` over a fake 4-rank group are counted where they
reach the dispatcher."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.utils import hlo as jhlo
from repro_torch.utils import hlo

pytestmark = pytest.mark.torch_port


def _reference(f, *shapes):
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jhlo.analyze_compiled(jax.jit(f).lower(*structs).compile())


def _port(f, *shapes):
    with FakeTensorMode():
        return hlo.analyze(f, *(torch.empty(s) for s in shapes))


def _loop(w, x, n):
    for _ in range(n):
        x = x @ w
    return x


def _scan(w, x, n):
    return jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=n)[0]


def _nested(x, w, outer, inner):
    for _ in range(outer):
        x = _loop(w, x, inner)
    return x


def _nested_scan(x, w, outer, inner):
    return jax.lax.scan(lambda c, _: (_scan(w, c, inner), None), x, None, length=outer)[0]


CASES = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b, ((128, 256), (256, 512)),
               2 * 128 * 256 * 512),
    "loop of 8": (lambda x, w: _loop(w, x, 8), lambda x, w: _scan(w, x, 8),
                  ((128, 128), (128, 128)), 8 * 2 * 128 ** 3),
    "3 x 5 nested loops": (lambda x, w: _nested(x, w, 3, 5), lambda x, w: _nested_scan(x, w, 3, 5),
                           ((64, 64), (64, 64)), 15 * 2 * 64 ** 3),
    "batched einsum": (lambda a, w: torch.einsum("bmk,bkn->bmn", a, w),
                       lambda a, w: jnp.einsum("bmk,bkn->bmn", a, w),
                       ((4, 32, 64), (4, 64, 16)), 2 * 4 * 32 * 64 * 16),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flops_match_the_reference(name):
    port_fn, ref_fn, shapes, want = CASES[name]
    got, ref = _port(port_fn, *shapes).flops, _reference(ref_fn, *shapes).flops
    assert got == pytest.approx(ref, rel=0.01), (got, ref)
    assert got == pytest.approx(want, rel=0.01)


def test_composite_ops_are_costed_in_inference_mode():
    """Under ``inference_mode`` ``matmul`` and ``einsum`` reach the mode
    whole; their products are counted all the same."""
    def f(a, b):
        with torch.inference_mode():
            return torch.einsum("ij,jk->ik", a, b) + torch.matmul(a, b)

    assert _port(f, (16, 32), (32, 8)).flops == 2 * (2 * 16 * 32 * 8)


def test_elementwise_bytes_in_the_reference_band():
    n = 1 << 16
    got = _port(lambda a: a * 2.0 + 1.0, (n,)).bytes
    ref = _reference(lambda a: a * 2.0 + 1.0, (n,)).bytes
    for b in (got, ref):
        assert 2 * 4 * n <= b <= 6 * 4 * n, (got, ref)


def test_byte_rules():
    n, d, k = 1000, 64, 10
    with FakeTensorMode():
        x = torch.empty((n, d), dtype=torch.bfloat16)
        idx = torch.zeros(k, dtype=torch.int64)
        upd = torch.empty((k, d), dtype=torch.bfloat16)
        row = torch.empty((1, d), dtype=torch.bfloat16)
        # Views and metadata are free.
        assert hlo.analyze(lambda t: t.t().reshape(d, n)[:5].unsqueeze(0), x).bytes == 0
        # A bf16 op is charged at 2 bytes an element: read x, write the sum.
        assert hlo.analyze(lambda t: t + 1, x).bytes == 2 * 2 * n * d
        # A broadcast operand is read once.
        assert hlo.analyze(lambda t, r: t * r.expand(n, d), x, row).bytes == 2 * (2 * n * d + d)
        # Slicing: twice the output; updating: twice the update.
        assert hlo.analyze(lambda t, i: t.index_select(0, i), x, idx).bytes == 2 * 2 * k * d
        add = hlo.analyze(lambda t, i, u: t.index_add_(0, i, u), x, idx, upd)
        assert add.bytes == 2 * 2 * k * d
        assert hlo.analyze(lambda t, u: t[:k].copy_(u), x, upd).bytes == 2 * 2 * k * d


def test_live_bytes():
    """a * 2 + 1: the argument, the product and the sum live at once; the
    product is freed before the step ends."""
    n = 1 << 12
    c = _port(lambda a: a * 2.0 + 1.0, (n,))
    assert c.argument_bytes == 4 * n and c.output_bytes == 4 * n
    assert c.peak_bytes == 3 * 4 * n and c.temp_bytes == 2 * 4 * n
    assert c.memory_analysis()["argument_size"] == 4 * n
    # An in-place update creates no storage: the peak is the argument.
    inplace = _port(lambda a: a.mul_(2.0), (n,))
    assert inplace.peak_bytes == inplace.argument_bytes == 4 * n and inplace.output_bytes == 0


_COLLECTIVES = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.parallel import collectives as C
    from repro_torch.utils import hlo

    fake_group(4)
    sp = C.Spmd(init_device_mesh("cpu", (4,), mesh_dim_names=("data",)))
    steps, n = 6, 1024

    def loop(x):
        for _ in range(steps):
            dist.all_reduce(x)
        return x

    c = hlo.analyze(loop, torch.ones(n))
    assert dict(c.coll_by_op) == {"all-reduce": steps * n * 4}, dict(c.coll_by_op)
    assert dict(c.coll_count) == {"all-reduce": steps}, dict(c.coll_count)
    assert c.coll_bytes == steps * n * 4 and c.bytes >= c.coll_bytes
    # The port's collectives reach the dispatcher: none is counted by hand.
    x = torch.ones(n)
    for fn, op in ((lambda t: C.all_reduce(t, sp, ("data",), "max"), "all-reduce"),
                   (lambda t: C.all_gather(t, sp, "data", 0), "all-gather"),
                   (lambda t: C._reduce_scatter_raw(t, sp, "data", 0), "reduce-scatter"),
                   (lambda t: C.exchange(t, sp, "data", 1, 3), "collective-permute"),
                   (lambda t: C.all_to_all(t, sp, "data", [n // 4] * 4, [n // 4] * 4),
                    "all-to-all")):
        c = hlo.analyze(fn, x)
        assert dict(c.coll_by_op) == {op: n * 4} and dict(c.coll_count) == {op: 1}, (op, c)
    # The sequence-parallel pair over "model", forward and backward: each
    # is one collective a way, under the reference's names.
    mp = C.Spmd(init_device_mesh("cpu", (4,), mesh_dim_names=("model",)))
    block = torch.ones((2, 8, n // 16), requires_grad=True)
    for fn, want in ((C.gather_seq, {"all-gather": n * 4, "reduce-scatter": 4 * n * 4}),
                     (C.reduce_scatter_seq, {"reduce-scatter": n * 4, "all-gather": n * 4 // 4})):
        c = hlo.analyze(lambda t: torch.autograd.grad(fn(t, mp).sum(), t), block)
        assert dict(c.coll_by_op) == want, (fn, dict(c.coll_by_op))
        assert dict(c.coll_count) == {op: 1 for op in want}, (fn, dict(c.coll_count))
    # A collective without a cost model raises: none is costed as a plain op.
    try:
        hlo.analyze(lambda t: dist.reduce(t, 0), x)
        raise AssertionError("dist.reduce was costed")
    except NotImplementedError:
        pass
    # A fake group is never staged through the host, a CUDA operand neither.
    with FakeTensorMode():
        assert not C._staged(torch.empty(n, device="cuda"), sp.group("data"))
    dist.destroy_process_group()
    print("OK")
""")


def test_collectives_over_a_fake_group():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_meta_ops_cost_nothing():
    """An op on the meta device (shapes alone) moves and holds nothing."""
    n = 1 << 20
    c = hlo.analyze(lambda: torch.empty(n, device="meta").mul_(2.0).to(torch.bfloat16))
    assert c.bytes == 0 and c.peak_bytes == 0 and c.flops == 0


def test_a_scalar_scatter_is_charged_at_its_indices():
    n, k = 1000, 10
    with FakeTensorMode():
        x = torch.empty(n)
        idx = torch.zeros(k, dtype=torch.int64)
        assert hlo.analyze(lambda t, i: t.scatter_(0, i, 1.0), x, idx).bytes == 2 * 4 * k
