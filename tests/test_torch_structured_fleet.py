"""The tenant-axis entries of kernels 4 and 5 (``structured_sketch_sums_fleet``,
``quantized_structured_sketch_sums_fleet``) and the structured fleet's path
through them.

1. The plain entries are bitwise the single plain versions, tenant by tenant
   (float, 1 bit and 4 bits; d = 32 at n = 3 and n = 20, d = 64).
2. Shape and dtype errors raise, in the plain entries and the kernel
   wrappers alike.
3. ``kernels.ops`` gives each tenant's ``(m,)`` sums of its own operator,
   bitwise, as contiguous ``(T, m)`` rows (a ragged block tail, the dither
   padded per tenant).
4. A structured ``update``, an ``ingest`` with duplicate ids (its rounds)
   and each block of a tenant mesh call the fleet entry once, and never the
   single-tenant functions.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fleet as fl
from repro_torch.kernels import freq_transform as ft
from repro_torch.kernels import ops as kops
from repro_torch.parallel import tenant_mesh

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
MODES = ["float", "1bit", "4bit"]
# (n, d, nblocks, T, B): d = 32 with NX = 16 (n <= 16) and 32, and d = 64.
SHAPES = [(3, 32, 3, 4, 37), (20, 32, 2, 3, 50), (40, 64, 2, 3, 21)]


def _inputs(seed, n, d, nblocks, tenants, rows):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((tenants, rows, n)).astype(f32)
    diags = rng.choice(np.array([-1.0, 1.0], f32), size=(tenants, nblocks, 3, d))
    radii = rng.uniform(0.2, 3.0, (tenants, nblocks, d)).astype(f32)
    beta = rng.uniform(0.0, 2.0, (tenants, rows)).astype(f32)
    dither = rng.uniform(0.0, 2 * np.pi, (tenants, nblocks, d)).astype(f32)
    return tuple(torch.from_numpy(a) for a in (x, diags, radii, beta, dither))


def _fleet_plain(mode, x, diags, radii, beta, dither):
    if mode == "float":
        return ft.structured_sketch_sums_fleet_plain(x, diags, radii, beta)
    return ft.quantized_structured_sketch_sums_fleet_plain(x, diags, radii, dither,
                                                           int(mode[0]))


def _single_plain(mode, x, diags, radii, beta, dither):
    if mode == "float":
        return ft.structured_sketch_sums_plain(x, diags, radii, beta)
    return ft.quantized_structured_sketch_sums_plain(x, diags, radii, dither, int(mode[0]))


# -- 1. the plain entries, tenant by tenant -----------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}-d{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_plain_fleet_entries_are_the_single_plain_calls_bitwise(mode, shape):
    n, d, nblocks, tenants, rows = shape
    x, diags, radii, beta, dither = _inputs(0, *shape)
    got = _fleet_plain(mode, x, diags, radii, beta, dither)
    want_dtype = torch.float32 if mode == "float" else torch.int32
    for g in got:
        assert g.shape == (tenants, nblocks, d) and g.dtype == want_dtype
    for t in range(tenants):
        ref = _single_plain(mode, x[t], diags[t], radii[t], beta[t], dither[t])
        for g, r in zip(got, ref):
            assert torch.equal(g[t], r), (mode, t)


# -- 2. shape and dtype errors ---------------------------------------------------------


def _bad_cases():
    """name -> ((x, diags, radii, beta, dither), (error, message))."""
    x, diags, radii, beta, dither = _inputs(1, 3, 32, 2, 3, 10)
    shape, width = (ValueError, "expected"), (ValueError, "block width")
    dtype = (TypeError, "float32")
    return {
        "x not (T, B, n)": ((x[0], diags, radii, beta, dither), shape),
        "x of no rows": ((x[:, :0], diags, radii, beta[:, :0], dither), shape),
        "diags of other T": ((x, diags[:2], radii, beta, dither), shape),
        "diags not (T, nblocks, 3, d)": ((x, diags[:, :, :2], radii, beta, dither), shape),
        "radii of other nblocks": ((x, diags, radii[:, :1], beta, dither), shape),
        "beta of other B": ((x, diags, radii, beta[:, :5], dither), shape),
        "dither of other d": ((x, diags, radii, beta, dither[..., :16]), shape),
        "d below n": ((torch.zeros((3, 10, 40)), diags, radii, beta, dither), width),
        "d not a power of two": ((x, diags[..., :24], radii[..., :24], beta,
                                  dither[..., :24]), width),
        "x float64": ((x.double(), diags, radii, beta, dither), dtype),
        "radii float64": ((x, diags, radii.double(), beta, dither), dtype),
    }


# Each mode's cases: the float entries take beta, the code entries dither.
_MODE_CASES = [(mode, case) for mode in ("float", "1bit") for case in _bad_cases()
               if not case.startswith("dither" if mode == "float" else "beta")]


@pytest.mark.parametrize("mode,case", _MODE_CASES)
@pytest.mark.parametrize("entry", ["plain", "kernel"])
def test_fleet_entries_refuse_bad_shapes_and_dtypes(entry, mode, case):
    (x, diags, radii, beta, dither), (err, match) = _bad_cases()[case]
    fns = {
        ("float", "plain"): lambda: ft.structured_sketch_sums_fleet_plain(x, diags, radii, beta),
        ("float", "kernel"): lambda: ft.structured_sketch_sums_fleet(x, diags, radii, beta),
        ("1bit", "plain"): lambda: ft.quantized_structured_sketch_sums_fleet_plain(
            x, diags, radii, dither, 1),
        ("1bit", "kernel"): lambda: ft.quantized_structured_sketch_sums_fleet(
            x, diags, radii, dither, 1),
    }
    with pytest.raises(err, match=match):
        fns[(mode, entry)]()


# -- 3. the dispatch ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_ops_fleet_sums_are_each_tenants_own_sums(mode):
    """m = 50 of two d = 32 blocks: a ragged tail sliced off every row, the
    (T, m) dither padded per tenant."""
    tenants, rows, n, m = 3, 17, 5, 50
    stacked = fl.FleetEngine(fl.fleet_specs(3, tenants, "structured", m, n, 1.0),
                             device="cpu")._stacked_op
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((tenants, rows, n)).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0.5, 1.5, (tenants, rows)).astype(np.float32))
    dither = torch.from_numpy(rng.uniform(0, 6.0, (tenants, m)).astype(np.float32))
    if mode == "float":
        got = kops.fleet_fourier_sketch_sums(x, stacked, beta)
        refs = [kops.fourier_sketch_sums(x[t], stacked.tenant(t), beta[t])
                for t in range(tenants)]
    else:
        bits = int(mode[0])
        got = kops.quantized_fleet_fourier_sketch_sums(x, stacked, dither, bits)
        refs = [kops.quantized_fourier_sketch_sums(x[t], stacked.tenant(t), dither[t], bits)
                for t in range(tenants)]
    for g, r in zip(got, zip(*refs)):
        assert g.shape == (tenants, m) and g.is_contiguous()
        assert torch.equal(g, torch.stack(r))


# -- 4. one call of the fleet entry an update, an ingest and a block -----------------------


def _counted(monkeypatch):
    """Count the fleet plain entries' calls; make every single-tenant
    function of kernels 4-5 (kernel and plain) raise."""
    calls = {"float": 0, "codes": 0}

    def counting(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    def single(*args, **kwargs):
        raise AssertionError("a structured fleet called a single-tenant kernel 4-5 function")

    monkeypatch.setattr(ft, "structured_sketch_sums_fleet_plain",
                        counting("float", ft.structured_sketch_sums_fleet_plain))
    monkeypatch.setattr(ft, "quantized_structured_sketch_sums_fleet_plain",
                        counting("codes", ft.quantized_structured_sketch_sums_fleet_plain))
    for name in ("structured_sketch_sums", "structured_sketch_sums_plain",
                 "quantized_structured_sketch_sums", "quantized_structured_sketch_sums_plain"):
        monkeypatch.setattr(ft, name, single)
    return calls


def _engine(quant, tenants, p=None):
    specs = fl.fleet_specs(0, tenants, "structured", 24, 3, 1.5)
    quants = fl.fleet_quantizers(7, tenants, 24, quant, device="cpu")
    if p is None:
        return fl.FleetEngine(specs, quantizers=quants, device="cpu")
    return fl.FleetEngine(specs, quantizers=quants, sharding="mesh",
                          mesh=tenant_mesh(p, devices=[CPU] * p))


@pytest.mark.parametrize("quant", ["none", "1bit"])
def test_structured_update_ingest_and_mesh_call_the_fleet_entry_once(monkeypatch, quant):
    tenants = 4
    key = "float" if quant == "none" else "codes"
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.standard_normal((2, tenants, 9, 3)).astype(np.float32))
    calls = _counted(monkeypatch)

    eng = _engine(quant, tenants)
    state = eng.update(eng.init_state(), xs[0])
    assert calls[key] == 1
    # Duplicate ids: three rounds of merges, one fleet call for the partials.
    ids = np.array([2, 0, 2, 2, 1])
    reqs = torch.from_numpy(rng.standard_normal((5, 9, 3)).astype(np.float32))
    eng.ingest(state, ids, reqs)
    assert calls[key] == 2

    mesh = _engine(quant, tenants, p=2)
    mesh.update(mesh.update(mesh.init_state(), xs[0]), xs[1])
    assert calls[key] == 2 + 2 * 2  # once a block an update
    assert calls["float" if key == "codes" else "codes"] == 0
