"""Fused random-Fourier-feature sketch sums, float and quantized: the CUDA
kernels and their plain twins.

Counterpart of ``repro.kernels.fourier_sketch``.  For ``x (N, n)`` and
``w (n, m)``:

- :func:`fourier_sketch_sums` (``csrc/fourier_sketch.cu``, the reference's
  ``fourier_sketch_kernel``) computes, with weights ``beta (N,)``,

      (sum_i beta_i cos(x_i W)  (m,),   sum_i beta_i sin(x_i W)  (m,))

  and counts each launch in ``LAUNCHES``;
- :func:`quantized_fourier_sketch_sums` (``csrc/quantized_fourier_sketch.cu``,
  the reference's ``quantized_fourier_sketch_kernel``) computes the int32 sums
  of the QCKM codes of the dithered phases ``x_i W + xi``
  (``core.quantize.quantize_codes``), optionally masked by ``valid (N,)``, and
  counts each launch in ``QUANTIZED_LAUNCHES``.

Each launches its kernel on CUDA tensors or raises.  Beside each is its plain
PyTorch version (``*_plain``), summed over chunks of rows so the ``(chunk, m)``
projection stays bounded; ``kernels.ops`` picks between them by the tensor's
device.

The fleet entries :func:`fourier_sketch_sums_fleet` and
:func:`quantized_fourier_sketch_sums_fleet` take ``x (T, B, n)``,
``w (T, n, m)`` and ``beta (T, B)`` or ``dither (T, m)``, sketch each
tenant's rows against its own operator, and return ``(T, m)`` sums in one
launch for the whole fleet (counted in ``FLEET_LAUNCHES`` and
``QUANTIZED_FLEET_LAUNCHES``): the counterpart of the reference's ``vmap`` of
its kernels over the tenant axis.  Each tenant gets the grid of an isolated
call of B rows, so its sums are bitwise those of ``T`` single launches.
Their plain versions loop the single plain versions over the tenants.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, grid_rows, on_device, sm_count, stream_ptr

# Kernel launches since the counts were last reset (plain calls do not count).
LAUNCHES = 0
QUANTIZED_LAUNCHES = 0
FLEET_LAUNCHES = 0
QUANTIZED_FLEET_LAUNCHES = 0

# Frequencies per block of the float kernel (the quantized kernel reports
# its own), and the rows both stage at a time (the least a block is given
# where N allows).
FREQS_PER_BLOCK = 256
TILE_ROWS = 128
_PLAIN_CHUNK = 1 << 16
# What each kernel's occupancy query reported, by (device index, kernel,
# n[, one_bit]).
_RESIDENT: dict[tuple, tuple[int, ...]] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("fourier_sketch")
    fn = lib.fourier_sketch_sums
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, i64, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
        lib.fourier_sketch_sums_fleet.argtypes = [ptr, ptr, ptr, i32, i64, i32, i32, i64, i32,
                                                  ptr, ptr, ptr, ptr, ptr]
        lib.fourier_sketch_sums_fleet.restype = i32
        lib.fourier_sketch_resident.argtypes = [i32, ctypes.POINTER(i32)]
        lib.fourier_sketch_resident.restype = i32
        lib.fourier_sketch_error_string.argtypes = [ctypes.c_int]
        lib.fourier_sketch_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or beta.ndim != 1:
        raise ValueError(
            f"expected x (N, n), w (n, m), beta (N,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(beta.shape)}"
        )
    if x.shape[1] != w.shape[0] or beta.shape[0] != x.shape[0]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"beta {tuple(beta.shape)}"
        )
    for name, t in (("x", x), ("w", w), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def sketch_grid(n_pts: int, m: int, sms: int, resident: int,
                freqs: int = FREQS_PER_BLOCK) -> tuple[int, int, int]:
    """``(rows_per_group, groups, col_blocks)`` of both kernels' grids:
    ``col_blocks`` blocks of ``freqs`` frequencies by ``groups``
    contiguous row ranges of ``rows_per_group`` rows (the last one ragged).
    One wave of ``resident`` blocks per SM on ``sms`` SMs, where N is large
    enough for a tile of ``TILE_ROWS`` rows a block (``_launch.grid_rows``);
    no cap on the rows of a group: the float kernel adds each tile's float
    sums into double registers, so its ``(groups, m)`` partials do not grow
    with N, and the quantized kernel's int32 sums are exact at any length."""
    col_blocks = -(-m // freqs)
    rows, groups = grid_rows(n_pts, col_blocks, sms, resident, min_rows=TILE_ROWS)
    return rows, groups, col_blocks


def _resident(lib: ctypes.CDLL, name: str, dev: torch.device, *args: int, outs: int = 1):
    """What ``<name>_resident(*args, ...)`` reports for this device (blocks
    per SM; for the quantized kernel also its frequencies per block), asked
    of the library once per device."""
    key = (dev.index, name, *args)
    if key not in _RESIDENT:
        out = [ctypes.c_int(0) for _ in range(outs)]
        status = getattr(lib, f"{name}_resident")(*args, *map(ctypes.byref, out))
        if status != 0 or min(o.value for o in out) < 1:
            msg = getattr(lib, f"{name}_error_string")(status).decode()
            raise RuntimeError(f"{name} occupancy query failed: {msg} ({status})")
        _RESIDENT[key] = tuple(o.value for o in out)
    return _RESIDENT[key]


def fourier_sketch_sums(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(cos_sums (m,), sin_sums (m,))`` for CUDA tensors.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices).  The sums are
    bitwise repeatable on one card: no atomics, a fixed reduction order.
    """
    global LAUNCHES
    _check_inputs(x, w, beta)
    dev = check_cuda((("x", x), ("w", w), ("beta", beta)))
    n_pts, n = x.shape
    m = w.shape[1]
    if m > 65535 * FREQS_PER_BLOCK:
        raise ValueError(f"m = {m} exceeds the kernel's grid limit")
    lib = _lib()
    with on_device(dev):
        (resident,) = _resident(lib, "fourier_sketch", dev, n)
        rows, groups, _ = sketch_grid(n_pts, m, sm_count(dev), resident)
        part = torch.empty((2, groups, m), dtype=torch.float64, device=dev)
        out = torch.empty((2, m), dtype=torch.float32, device=dev)
        status = lib.fourier_sketch_sums(
            x.data_ptr(), w.data_ptr(), beta.data_ptr(), n_pts, n, m, rows, groups,
            part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream_ptr(dev),
        )
    if status != 0:
        msg = lib.fourier_sketch_error_string(status).decode()
        raise RuntimeError(f"fourier_sketch kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return out[0], out[1]


def fourier_sketch_sums_plain(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``beta @ cos(x @ w)`` and ``beta @ sin(x @ w)``,
    summed over chunks of rows."""
    _check_inputs(x, w, beta)
    m = w.shape[1]
    cos_s = torch.zeros((m,), dtype=torch.float32, device=x.device)
    sin_s = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[0], _PLAIN_CHUNK):
        proj = x[start : start + _PLAIN_CHUNK] @ w  # (chunk, m)
        b = beta[start : start + _PLAIN_CHUNK]
        cos_s += b @ torch.cos(proj)
        sin_s += b @ torch.sin(proj)
    return cos_s, sin_s


def _qlib() -> ctypes.CDLL:
    lib = _build.load("quantized_fourier_sketch")
    fn = lib.quantized_fourier_sketch_sums
    if fn.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, f32, i64, i32, ptr, ptr, ptr]
        fn.restype = i32
        lib.quantized_fourier_sketch_sums_fleet.argtypes = [ptr, ptr, ptr, i32, i64, i32, i32,
                                                            i32, f32, i64, i32, ptr, ptr, ptr]
        lib.quantized_fourier_sketch_sums_fleet.restype = i32
        lib.quantized_fourier_sketch_resident.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 2
        lib.quantized_fourier_sketch_resident.restype = i32
        lib.quantized_fourier_sketch_error_string.argtypes = [i32]
        lib.quantized_fourier_sketch_error_string.restype = ctypes.c_char_p
    return lib


def _check_quantized(x, w, dither, valid) -> None:
    if x.ndim != 2 or w.ndim != 2 or dither.ndim != 1:
        raise ValueError(
            f"expected x (N, n), w (n, m), dither (m,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(dither.shape)}"
        )
    if x.shape[1] != w.shape[0] or dither.shape[0] != w.shape[1] or (
        valid is not None and tuple(valid.shape) != (x.shape[0],)
    ):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, dither "
            f"{tuple(dither.shape)}, valid {None if valid is None else tuple(valid.shape)}"
        )
    for name, t in (("x", x), ("w", w), ("dither", dither), ("valid", valid)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def quantized_fourier_sketch_sums(
    x: torch.Tensor,
    w: torch.Tensor,
    dither: torch.Tensor,
    bits: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: int32 ``(qcos_sums (m,), qsin_sums (m,))``.

    Raises for anything the kernel does not take.  Integer sums are exact,
    so the result is bitwise repeatable and any split of the rows adds up to
    the same bits.
    """
    global QUANTIZED_LAUNCHES
    _check_quantized(x, w, dither, valid)
    dev = check_cuda((("x", x), ("w", w), ("dither", dither), ("valid", valid)))
    n_pts, n = x.shape
    m = w.shape[1]
    one_bit = int(bits == 1)
    lib = _qlib()
    with on_device(dev):
        resident, freqs = _resident(lib, "quantized_fourier_sketch", dev, n, one_bit, outs=2)
        if m > 65535 * freqs:
            raise ValueError(f"m = {m} exceeds the kernel's grid limit")
        rows, groups, _ = sketch_grid(n_pts, m, sm_count(dev), resident, freqs)
        qcos = torch.zeros((m,), dtype=torch.int32, device=dev)
        qsin = torch.zeros_like(qcos)
        status = lib.quantized_fourier_sketch_sums(
            x.data_ptr(), w.data_ptr(), dither.data_ptr(),
            None if valid is None else valid.data_ptr(), n_pts, n, m, one_bit,
            float(qz.quantization_scale(bits)), rows, groups, qcos.data_ptr(),
            qsin.data_ptr(), stream_ptr(dev),
        )
    if status != 0:
        msg = lib.quantized_fourier_sketch_error_string(status).decode()
        raise RuntimeError(f"quantized_fourier_sketch kernel launch failed: {msg} ({status})")
    QUANTIZED_LAUNCHES += 1
    return qcos, qsin


def quantized_fourier_sketch_sums_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    dither: torch.Tensor,
    bits: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: chunks of ``x @ w`` through
    ``quantize.quantize_codes``, summed in int32."""
    _check_quantized(x, w, dither, valid)
    m = w.shape[1]
    qcos = torch.zeros((m,), dtype=torch.int32, device=x.device)
    qsin = torch.zeros_like(qcos)
    for start in range(0, x.shape[0], _PLAIN_CHUNK):
        v = None if valid is None else valid[start : start + _PLAIN_CHUNK, None]
        qc, qs = qz.quantize_codes(x[start : start + _PLAIN_CHUNK] @ w, dither, bits, valid=v)
        qcos += qc.sum(dim=0, dtype=torch.int32)
        qsin += qs.sum(dim=0, dtype=torch.int32)
    return qcos, qsin


# -- the fleet entries: a tenant axis, one launch ------------------------------


def _check_fleet(x: torch.Tensor, w: torch.Tensor, name: str, v: torch.Tensor) -> None:
    """``x (T, B, n)``, ``w (T, n, m)`` and ``v``: ``beta (T, B)`` or
    ``dither (T, m)`` by ``name``; all float32."""
    ok = x.ndim == 3 and w.ndim == 3 and tuple(w.shape[:2]) == (x.shape[0], x.shape[2])
    if ok:
        ok = tuple(v.shape) == (x.shape[0], x.shape[1] if name == "beta" else w.shape[2])
    if not ok:
        raise ValueError(
            f"expected x (T, B, n), w (T, n, m) and beta (T, B) or dither (T, m); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {name} {tuple(v.shape)}"
        )
    for label, t in (("x", x), ("w", w), (name, v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{label} must be float32, got {t.dtype}")


def fourier_sketch_sums_fleet(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel over a fleet: ``(cos_sums (T, m), sin_sums (T, m))``
    for CUDA tensors ``x (T, B, n)``, ``w (T, n, m)``, ``beta (T, B)``, in
    one launch.  Tenant t's sums are bitwise ``fourier_sketch_sums(x[t],
    w[t], beta[t])``: each tenant gets that call's grid and reduction order.
    Raises for anything the kernel does not take."""
    global FLEET_LAUNCHES
    _check_fleet(x, w, "beta", beta)
    dev = check_cuda((("x", x), ("w", w), ("beta", beta)))
    tenants, n_pts, n = x.shape
    m = w.shape[2]
    if m > 65535 * FREQS_PER_BLOCK:
        raise ValueError(f"m = {m} exceeds the kernel's grid limit")
    lib = _lib()
    with on_device(dev):
        (resident,) = _resident(lib, "fourier_sketch", dev, n)
        rows, groups, _ = sketch_grid(n_pts, m, sm_count(dev), resident)
        part = torch.empty((2, tenants, groups, m), dtype=torch.float64, device=dev)
        out = torch.empty((2, tenants, m), dtype=torch.float32, device=dev)
        status = lib.fourier_sketch_sums_fleet(
            x.data_ptr(), w.data_ptr(), beta.data_ptr(), tenants, n_pts, n, m, rows, groups,
            part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream_ptr(dev),
        )
    if status != 0:
        msg = lib.fourier_sketch_error_string(status).decode()
        raise RuntimeError(f"fourier_sketch fleet kernel launch failed: {msg} ({status})")
    FLEET_LAUNCHES += 1
    return out[0], out[1]


def fourier_sketch_sums_fleet_plain(
    x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: :func:`fourier_sketch_sums_plain` per tenant."""
    _check_fleet(x, w, "beta", beta)
    sums = [fourier_sketch_sums_plain(x[t], w[t], beta[t]) for t in range(x.shape[0])]
    return torch.stack([c for c, _ in sums]), torch.stack([s for _, s in sums])


def quantized_fourier_sketch_sums_fleet(
    x: torch.Tensor, w: torch.Tensor, dither: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel over a fleet: int32 ``(qcos_sums (T, m), qsin_sums
    (T, m))`` for CUDA tensors ``x (T, B, n)``, ``w (T, n, m)``,
    ``dither (T, m)``, in one launch; tenant t's sums are those of
    ``quantized_fourier_sketch_sums(x[t], w[t], dither[t], bits)``.  Raises
    for anything the kernel does not take."""
    global QUANTIZED_FLEET_LAUNCHES
    _check_fleet(x, w, "dither", dither)
    dev = check_cuda((("x", x), ("w", w), ("dither", dither)))
    tenants, n_pts, n = x.shape
    m = w.shape[2]
    one_bit = int(bits == 1)
    lib = _qlib()
    with on_device(dev):
        resident, freqs = _resident(lib, "quantized_fourier_sketch", dev, n, one_bit, outs=2)
        if m > 65535 * freqs:
            raise ValueError(f"m = {m} exceeds the kernel's grid limit")
        rows, groups, _ = sketch_grid(n_pts, m, sm_count(dev), resident, freqs)
        q = torch.zeros((2, tenants, m), dtype=torch.int32, device=dev)
        status = lib.quantized_fourier_sketch_sums_fleet(
            x.data_ptr(), w.data_ptr(), dither.data_ptr(), tenants, n_pts, n, m, one_bit,
            float(qz.quantization_scale(bits)), rows, groups, q[0].data_ptr(), q[1].data_ptr(),
            stream_ptr(dev),
        )
    if status != 0:
        msg = lib.quantized_fourier_sketch_error_string(status).decode()
        raise RuntimeError(f"quantized_fourier_sketch fleet kernel launch failed: {msg} ({status})")
    QUANTIZED_FLEET_LAUNCHES += 1
    return q[0], q[1]


def quantized_fourier_sketch_sums_fleet_plain(
    x: torch.Tensor, w: torch.Tensor, dither: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: :func:`quantized_fourier_sketch_sums_plain`
    per tenant."""
    _check_fleet(x, w, "dither", dither)
    sums = [quantized_fourier_sketch_sums_plain(x[t], w[t], dither[t], bits)
            for t in range(x.shape[0])]
    return torch.stack([c for c, _ in sums]), torch.stack([s for _, s in sums])
