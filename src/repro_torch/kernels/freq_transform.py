"""Fast structured frequency transform: the Walsh–Hadamard helpers and the
structured sketch kernels, each beside its plain PyTorch version.

Counterpart of ``repro.kernels.freq_transform``.  Each block of
``d = 2^k`` frequencies of the structured operator is

    B = c·H D_2 · c·H D_1 · c·H D_0          (c = d^{-1/2}, D_i Rademacher)

:func:`fwht` applies ``H_d`` in the reference's Kronecker form
``H_d = H_a ⊗ H_b`` (two small matmuls), and :func:`hd_chain` the three
stages; the operator's ``apply``/``adjoint`` and the plain versions below use
them, and autograd flows through them.

Kernels (``csrc/structured_sketch.cu``), for ``x (N, n)`` with ``n <= d``,
``diags (nblocks, 3, d)`` and ``radii (nblocks, d)``:

- :func:`structured_sketch_sums` — ``(nblocks, d)`` float sums
  ``sum_i beta_i cos(hd_chain(x_i) * radii)`` and the sin twin (the
  reference's ``structured_sketch_kernel``);
- :func:`quantized_structured_sketch_sums` — the same phases plus a
  ``(nblocks, d)`` dither, through the QCKM codes, as int32 sums (the
  reference's ``quantized_structured_sketch_kernel``).

The CUDA kernels run the ``O(d log d)`` butterfly, a thread holding 32
coordinates of a block, on a grid of one wave of resident CTAs
(:func:`structured_grid`), for ``d`` from 32 to ``MAX_KERNEL_D`` = 16384
(blocks above ``WIDE_FROM`` in teams of ``d / 32`` threads a row, each team
a row group, several a CTA); the plain versions run :func:`hd_chain` in the
Kronecker form over chunks of rows.

The fleet entries :func:`structured_sketch_sums_fleet` and
:func:`quantized_structured_sketch_sums_fleet` take a tenant axis (``x (T,
B, n)``, ``diags (T, nblocks, 3, d)``, ...) and sketch every tenant in one
launch, each tenant's sums bitwise those of its own single launch (the
reference ``vmap`` s its kernels over the tenants).

Each kernel launch adds one to its count (``STRUCTURED_LAUNCHES``,
``QUANTIZED_STRUCTURED_LAUNCHES``, ``STRUCTURED_FLEET_LAUNCHES``,
``QUANTIZED_STRUCTURED_FLEET_LAUNCHES``); ``kernels.ops`` picks between
kernel and plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, grid_rows, on_device, sm_count, stream_ptr

# Kernel launches since the counts were last reset (plain calls do not count).
STRUCTURED_LAUNCHES = 0
QUANTIZED_STRUCTURED_LAUNCHES = 0
STRUCTURED_FLEET_LAUNCHES = 0
QUANTIZED_STRUCTURED_FLEET_LAUNCHES = 0

# Widest block the kernels take: the block of the widest d_model among the
# configs (mistral-large, 12288).  Blocks above WIDE_FROM run the wide
# kernel (csrc/structured_sketch.cu, structured_wide).
MAX_KERNEL_D = 16384
WIDE_FROM = 2048
# The kernels' instances: float sums, b-bit codes, 1-bit codes.
_MODE_FLOAT, _MODE_CODES, _MODE_SIGNS = 0, 1, 2
# (row groups per SM, frequency blocks per CTA) of each instance, by
# (device index, d, n, mode).
_RESIDENT: dict[tuple[int, int, int, int], tuple[int, int]] = {}
# The plain versions hold (chunk, nblocks, d) float32 projections: at most
# this many elements per chunk.
_PLAIN_ELEMS = 1 << 24


@functools.lru_cache(maxsize=None)
def _hadamard_list(k: int) -> tuple[tuple[float, ...], ...]:
    assert k >= 1 and (k & (k - 1)) == 0, k
    h = [[1.0]]
    while len(h) < k:
        h = [row + row for row in h] + [row + [-v for v in row] for row in h]
    return tuple(tuple(row) for row in h)


def kron_factors(d: int) -> tuple[int, int]:
    """Balanced Kronecker split ``d = a * b`` with ``a, b`` powers of two."""
    assert d >= 1 and (d & (d - 1)) == 0, d
    p = d.bit_length() - 1
    a = 1 << ((p + 1) // 2)
    return a, d // a


def hadamard(k: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The Sylvester Hadamard matrix ``H_k`` (entries ±1), ``k`` a power of two."""
    return torch.tensor(_hadamard_list(k), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _hadamard_on(k: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # Built once per (k, dtype, device): a decoder applies the operator every
    # step, and a fresh host-to-device copy each time would stall the stream.
    return hadamard(k, dtype, device)


@functools.lru_cache(maxsize=None)
def inv_sqrt(d: int, dtype: torch.dtype = torch.float32) -> float:
    """``d^-1/2`` computed in ``dtype`` (as the reference's
    ``jnp.asarray(d, dtype) ** -0.5``), as a Python float."""
    return float(torch.tensor(float(d), dtype=dtype) ** -0.5)


def fwht(v: torch.Tensor) -> torch.Tensor:
    """Unnormalised Walsh–Hadamard transform along the last axis: ``v @ H_d``.

    Two Kronecker contractions (``H_d = H_a ⊗ H_b``), as the reference
    computes it.
    """
    d = v.shape[-1]
    if d == 1:
        return v
    a, b = kron_factors(d)
    ha = _hadamard_on(a, v.dtype, v.device)
    hb = _hadamard_on(b, v.dtype, v.device)
    rows = v.reshape(-1, d).shape[0]
    y = v.reshape(rows * a, b) @ hb
    y = torch.einsum("ij,rjk->rik", ha, y.reshape(rows, a, b))
    return y.reshape(v.shape)


def hd_chain(xp: torch.Tensor, diags: torch.Tensor) -> torch.Tensor:
    """``c·H D_2 (c·H D_1 (c·H D_0 xp))`` with ``c = d^{-1/2}``.

    ``xp: (..., d)`` zero-padded inputs, ``diags: (..., 3, d)`` Rademacher
    signs; leading axes broadcast (e.g. ``(nblocks, 3, d)`` against
    ``(N, 1, d)``).
    """
    c = inv_sqrt(xp.shape[-1], xp.dtype)
    v = xp
    for s in range(3):
        v = fwht(v * diags[..., s, :]) * c
    return v


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("structured_sketch")
    fn, qfn = lib.structured_sketch_sums, lib.quantized_structured_sketch_sums
    if fn.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, f32, i64, i32,
                       ptr, ptr, ptr, ptr, ptr]
        qfn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, f32, i32,
                        f32, i64, i32, ptr, ptr, ptr]
        lib.structured_sketch_sums_fleet.argtypes = [
            ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, f32, i64, i32, ptr, ptr, ptr, ptr, ptr]
        lib.quantized_structured_sketch_sums_fleet.argtypes = [
            ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, f32, i32, f32, i64, i32, ptr, ptr, ptr]
        for entry in (fn, qfn, lib.structured_sketch_sums_fleet,
                      lib.quantized_structured_sketch_sums_fleet):
            entry.restype = i32
        lib.structured_sketch_resident.argtypes = [i32, i32, i32, ctypes.POINTER(i32),
                                                   ctypes.POINTER(i32)]
        lib.structured_sketch_resident.restype = i32
        lib.structured_sketch_error_string.argtypes = [i32]
        lib.structured_sketch_error_string.restype = ctypes.c_char_p
    return lib


def structured_grid(
    n_pts: int, nblocks: int, freq_blocks: int, sms: int, resident: int, d: int = 32
) -> tuple[int, int, int]:
    """``(rows_per_group, groups, col_blocks)`` of the structured kernels'
    grid: ``col_blocks`` CTAs of ``freq_blocks`` frequency blocks each by
    ``groups`` contiguous row ranges of ``rows_per_group`` rows (the last
    one ragged).  One wave of ``resident`` groups per SM on ``sms`` SMs,
    where N is large enough (``_launch.grid_rows``); no cap on the rows of a
    group, since the float kernels add their float sums into double
    accumulators and the codes are summed exactly.  So the
    ``(groups, nblocks * d)`` partials do not grow with N.  Blocks ``d``
    above ``WIDE_FROM`` (the wide kernel, whose ``resident`` counts the row
    teams an SM runs, each team a group) take one row a group at least, so
    a few rows of a block run in parallel; the others at least
    ``_launch.grid_rows``' default."""
    col_blocks = -(-nblocks // freq_blocks)
    if d > WIDE_FROM:
        rows, groups = grid_rows(n_pts, col_blocks, sms, resident, min_rows=1)
    else:
        rows, groups = grid_rows(n_pts, col_blocks, sms, resident)
    return rows, groups, col_blocks


def _resident(lib: ctypes.CDLL, dev: torch.device, d: int, n: int, mode: int):
    """``(row groups per SM, frequency blocks per CTA)`` of the instance the
    kernel launches for ``(d, n, mode)`` on ``dev``: its CTAs per SM, times
    the row teams of a wide kernel's CTA."""
    key = (dev.index, d, n, mode)
    if key not in _RESIDENT:
        per_sm, fb = ctypes.c_int(0), ctypes.c_int(0)
        status = lib.structured_sketch_resident(d, n, mode, ctypes.byref(per_sm),
                                                ctypes.byref(fb))
        if status != 0 or per_sm.value < 1:
            msg = lib.structured_sketch_error_string(status).decode()
            raise RuntimeError(f"structured_sketch occupancy query failed: {msg} ({status})")
        _RESIDENT[key] = (per_sm.value, fb.value)
    return _RESIDENT[key]


def _check_inputs(x, diags, radii, rowv, freq_rows=()) -> None:
    if x.ndim != 2 or diags.ndim != 3 or diags.shape[1] != 3:
        raise ValueError(
            f"expected x (N, n) and diags (nblocks, 3, d); got {tuple(x.shape)}, "
            f"{tuple(diags.shape)}"
        )
    nblocks, _, d = diags.shape
    if d & (d - 1) or x.shape[1] > d:
        raise ValueError(f"block width d = {d} must be a power of two >= n = {x.shape[1]}")
    for name, t in (("radii", radii), *freq_rows):
        if tuple(t.shape) != (nblocks, d):
            raise ValueError(f"{name} must be ({nblocks}, {d}), got {tuple(t.shape)}")
    if rowv is not None and tuple(rowv.shape) != (x.shape[0],):
        raise ValueError(f"per-row vector must be ({x.shape[0]},), got {tuple(rowv.shape)}")
    for name, t in (("x", x), ("diags", diags), ("radii", radii), *freq_rows,
                    ("per-row vector", rowv)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _check_kernel_widths(d: int, n: int) -> None:
    if not 32 <= d <= MAX_KERNEL_D:
        raise ValueError(f"the structured kernel takes 32 <= d <= {MAX_KERNEL_D}, got {d}")
    if n < 1:
        raise ValueError("the structured kernel takes n >= 1 columns")


def _launch_check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.structured_sketch_error_string(status).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({status})")


def structured_sketch_sums(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(cos_sums, sin_sums)``, each ``(nblocks, d)``.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices, ``d`` outside
    ``[32, MAX_KERNEL_D]``, ``n = 0``).  The sums are bitwise repeatable:
    per-CTA double partials and a fixed-order second pass, no float atomics.
    """
    global STRUCTURED_LAUNCHES
    _check_inputs(x, diags, radii, beta)
    dev = check_cuda((("x", x), ("diags", diags), ("radii", radii), ("beta", beta)))
    nblocks, _, d = diags.shape
    n_pts, n = x.shape
    _check_kernel_widths(d, n)
    lib = _lib()
    with on_device(dev):
        per_sm, fb = _resident(lib, dev, d, n, _MODE_FLOAT)
        rows, groups, _ = structured_grid(n_pts, nblocks, fb, sm_count(dev), per_sm, d)
        part = torch.empty((2, groups, nblocks * d), dtype=torch.float64, device=dev)
        out = torch.empty((2, nblocks, d), dtype=torch.float32, device=dev)
        status = lib.structured_sketch_sums(
            x.data_ptr(), diags.data_ptr(), radii.data_ptr(), beta.data_ptr(),
            n_pts, n, d, nblocks, inv_sqrt(d), rows, groups,
            part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream_ptr(dev),
        )
    _launch_check(lib, status, "structured_sketch")
    STRUCTURED_LAUNCHES += 1
    return out[0], out[1]


def quantized_structured_sketch_sums(
    x: torch.Tensor,
    diags: torch.Tensor,
    radii: torch.Tensor,
    dither: torch.Tensor,
    bits: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: int32 ``(qcos_sums, qsin_sums)``, each ``(nblocks, d)``.

    ``dither`` is ``(nblocks, d)`` (the operator's ``(m,)`` dither
    zero-padded); ``valid`` an optional ``(N,)`` 0/1 row mask.  Integer sums
    are exact, so any split of the rows adds up to the same bits.
    """
    global QUANTIZED_STRUCTURED_LAUNCHES
    _check_inputs(x, diags, radii, valid, (("dither", dither),))
    dev = check_cuda((("x", x), ("diags", diags), ("radii", radii),
                      ("dither", dither), ("valid", valid)))
    nblocks, _, d = diags.shape
    n_pts, n = x.shape
    _check_kernel_widths(d, n)
    lib = _lib()
    with on_device(dev):
        mode = _MODE_SIGNS if bits == 1 else _MODE_CODES
        per_sm, fb = _resident(lib, dev, d, n, mode)
        rows, groups, _ = structured_grid(n_pts, nblocks, fb, sm_count(dev), per_sm, d)
        q = torch.zeros((2, nblocks, d), dtype=torch.int32, device=dev)
        status = lib.quantized_structured_sketch_sums(
            x.data_ptr(), diags.data_ptr(), radii.data_ptr(), dither.data_ptr(),
            None if valid is None else valid.data_ptr(), n_pts, n, d, nblocks,
            inv_sqrt(d), int(bits == 1), float(qz.quantization_scale(bits)), rows, groups,
            q[0].data_ptr(), q[1].data_ptr(), stream_ptr(dev),
        )
    _launch_check(lib, status, "quantized_structured_sketch")
    QUANTIZED_STRUCTURED_LAUNCHES += 1
    return q[0], q[1]


def _plain_phases(x, diags, radii):
    """Chunks ``(start, stop, phases (chunk, nblocks, d))`` of the structured
    projection, through :func:`hd_chain` in the Kronecker form."""
    nblocks, _, d = diags.shape
    chunk = max(1, _PLAIN_ELEMS // (nblocks * d))
    for start in range(0, x.shape[0], chunk):
        xc = x[start : start + chunk]
        xp = torch.nn.functional.pad(xc, (0, d - x.shape[1]))
        yield start, start + xc.shape[0], hd_chain(xp[:, None, :], diags) * radii


def structured_sketch_sums_plain(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`structured_sketch_sums`, chunked over
    rows so the ``(N, nblocks, d)`` projection never materialises.  The
    per-chunk sums are added up in float64: at N = 10^7 there are hundreds of
    chunks, and float32 running sums would lose more than the kernel."""
    _check_inputs(x, diags, radii, beta)
    return _plain_sums(x, diags, radii, beta)


def _plain_sums(x, diags, radii, beta):
    cos_s = torch.zeros(radii.shape, dtype=torch.float64, device=x.device)
    sin_s = torch.zeros_like(cos_s)
    for start, stop, proj in _plain_phases(x, diags, radii):
        b = beta[start:stop]
        cos_s += torch.einsum("c,cbd->bd", b, torch.cos(proj))
        sin_s += torch.einsum("c,cbd->bd", b, torch.sin(proj))
    return cos_s.to(torch.float32), sin_s.to(torch.float32)


def quantized_structured_sketch_sums_plain(
    x: torch.Tensor,
    diags: torch.Tensor,
    radii: torch.Tensor,
    dither: torch.Tensor,
    bits: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`quantized_structured_sketch_sums`:
    chunked :func:`hd_chain` phases through ``quantize.quantize_codes``."""
    _check_inputs(x, diags, radii, valid, (("dither", dither),))
    return _plain_codes(x, diags, radii, dither, bits, valid)


def _plain_codes(x, diags, radii, dither, bits, valid=None):
    qcos = torch.zeros(radii.shape, dtype=torch.int32, device=x.device)
    qsin = torch.zeros_like(qcos)
    for start, stop, proj in _plain_phases(x, diags, radii):
        v = None if valid is None else valid[start:stop, None, None]
        qc, qs = qz.quantize_codes(proj, dither, bits, valid=v)
        qcos += qc.sum(dim=0, dtype=torch.int32)
        qsin += qs.sum(dim=0, dtype=torch.int32)
    return qcos, qsin


# -- the fleet entries: a tenant axis, one launch ------------------------------


def _check_fleet(x, diags, radii, name: str, v: torch.Tensor) -> None:
    """``x (T, B, n)`` with ``B >= 1``, ``diags (T, nblocks, 3, d)``,
    ``radii (T, nblocks, d)`` and ``v``: ``beta (T, B)`` or ``dither (T,
    nblocks, d)`` by ``name``; all float32, ``d`` a power of two ``>= n``."""
    ok = x.ndim == 3 and x.shape[1] >= 1 and diags.ndim == 4 and diags.shape[2] == 3
    if ok:
        tenants, n_pts = x.shape[:2]
        _, nblocks, _, d = diags.shape
        want = (tenants, n_pts) if name == "beta" else (tenants, nblocks, d)
        ok = (diags.shape[0] == tenants and tuple(radii.shape) == (tenants, nblocks, d)
              and tuple(v.shape) == want)
    if not ok:
        raise ValueError(
            f"expected x (T, B >= 1, n), diags (T, nblocks, 3, d), radii (T, nblocks, d) and "
            f"beta (T, B) or dither (T, nblocks, d); got {tuple(x.shape)}, {tuple(diags.shape)}, "
            f"{tuple(radii.shape)}, {name} {tuple(v.shape)}"
        )
    if d & (d - 1) or x.shape[2] > d:
        raise ValueError(f"block width d = {d} must be a power of two >= n = {x.shape[2]}")
    for label, t in (("x", x), ("diags", diags), ("radii", radii), (name, v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{label} must be float32, got {t.dtype}")


def _fleet_grid(lib, dev, tenants: int, n_pts: int, n: int, d: int, nblocks: int, mode: int):
    """One tenant's ``(rows_per_group, groups)``: the grid of an isolated
    call of ``n_pts`` rows, never one sized for ``T * n_pts``."""
    per_sm, fb = _resident(lib, dev, d, n, mode)
    rows, groups, _ = structured_grid(n_pts, nblocks, fb, sm_count(dev), per_sm, d)
    if tenants * groups > 2**31 - 1:
        raise ValueError(f"T = {tenants} tenants of {groups} row groups exceed the grid limit")
    return rows, groups


def structured_sketch_sums_fleet(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel over a fleet: ``(cos_sums, sin_sums)``, each ``(T,
    nblocks, d)``, for CUDA tensors ``x (T, B, n)``, ``diags (T, nblocks, 3,
    d)``, ``radii (T, nblocks, d)``, ``beta (T, B)``, in one launch.  Tenant
    t's sums are bitwise ``structured_sketch_sums(x[t], diags[t], radii[t],
    beta[t])``: each tenant gets that call's grid and reduction order.
    Raises for anything the kernel does not take."""
    global STRUCTURED_FLEET_LAUNCHES
    _check_fleet(x, diags, radii, "beta", beta)
    dev = check_cuda((("x", x), ("diags", diags), ("radii", radii), ("beta", beta)))
    tenants, n_pts, n = x.shape
    _, nblocks, _, d = diags.shape
    _check_kernel_widths(d, n)
    lib = _lib()
    with on_device(dev):
        rows, groups = _fleet_grid(lib, dev, tenants, n_pts, n, d, nblocks, _MODE_FLOAT)
        part = torch.empty((2, tenants, groups, nblocks * d), dtype=torch.float64, device=dev)
        out = torch.empty((2, tenants, nblocks, d), dtype=torch.float32, device=dev)
        status = lib.structured_sketch_sums_fleet(
            x.data_ptr(), diags.data_ptr(), radii.data_ptr(), beta.data_ptr(), tenants,
            n_pts, n, d, nblocks, inv_sqrt(d), rows, groups,
            part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream_ptr(dev),
        )
    _launch_check(lib, status, "structured_sketch fleet")
    STRUCTURED_FLEET_LAUNCHES += 1
    return out[0], out[1]


def structured_sketch_sums_fleet_plain(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: :func:`structured_sketch_sums_plain` per
    tenant, stacked."""
    _check_fleet(x, diags, radii, "beta", beta)
    sums = [_plain_sums(x[t], diags[t], radii[t], beta[t]) for t in range(x.shape[0])]
    return torch.stack([c for c, _ in sums]), torch.stack([s for _, s in sums])


def quantized_structured_sketch_sums_fleet(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, dither: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel over a fleet: int32 ``(qcos_sums, qsin_sums)``, each
    ``(T, nblocks, d)``, for CUDA tensors ``x (T, B, n)``, ``diags``,
    ``radii`` as :func:`structured_sketch_sums_fleet` and ``dither (T,
    nblocks, d)`` (each tenant's ``(m,)`` dither zero-padded), in one
    launch; tenant t's sums are those of ``quantized_structured_sketch_sums(
    x[t], diags[t], radii[t], dither[t], bits)``.  Raises for anything the
    kernel does not take."""
    global QUANTIZED_STRUCTURED_FLEET_LAUNCHES
    _check_fleet(x, diags, radii, "dither", dither)
    dev = check_cuda((("x", x), ("diags", diags), ("radii", radii), ("dither", dither)))
    tenants, n_pts, n = x.shape
    _, nblocks, _, d = diags.shape
    _check_kernel_widths(d, n)
    lib = _lib()
    with on_device(dev):
        mode = _MODE_SIGNS if bits == 1 else _MODE_CODES
        rows, groups = _fleet_grid(lib, dev, tenants, n_pts, n, d, nblocks, mode)
        q = torch.zeros((2, tenants, nblocks, d), dtype=torch.int32, device=dev)
        status = lib.quantized_structured_sketch_sums_fleet(
            x.data_ptr(), diags.data_ptr(), radii.data_ptr(), dither.data_ptr(), tenants,
            n_pts, n, d, nblocks, inv_sqrt(d), int(bits == 1),
            float(qz.quantization_scale(bits)), rows, groups, q[0].data_ptr(), q[1].data_ptr(),
            stream_ptr(dev),
        )
    _launch_check(lib, status, "quantized_structured_sketch fleet")
    QUANTIZED_STRUCTURED_FLEET_LAUNCHES += 1
    return q[0], q[1]


def quantized_structured_sketch_sums_fleet_plain(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, dither: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: :func:`quantized_structured_sketch_sums_plain`
    per tenant, stacked."""
    _check_fleet(x, diags, radii, "dither", dither)
    sums = [_plain_codes(x[t], diags[t], radii[t], dither[t], bits) for t in range(x.shape[0])]
    return torch.stack([c for c, _ in sums]), torch.stack([s for _, s in sums])
