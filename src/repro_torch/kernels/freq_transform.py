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

The CUDA kernels run the ``O(d log d)`` butterfly; the plain versions run
:func:`hd_chain` in the Kronecker form over chunks of rows.  Each kernel
launch adds one to its count (``STRUCTURED_LAUNCHES``,
``QUANTIZED_STRUCTURED_LAUNCHES``); ``kernels.ops`` picks between
kernel and plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, grid_rows, sm_count

# Kernel launches since the counts were last reset (plain calls do not count).
STRUCTURED_LAUNCHES = 0
QUANTIZED_STRUCTURED_LAUNCHES = 0

# Widest block the kernels take (their shared-memory layout is sized for it).
MAX_KERNEL_D = 2048
_THREADS = 256
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
        fn.restype = i32
        qfn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, f32, i32,
                        f32, i64, i32, ptr, ptr, ptr]
        qfn.restype = i32
        lib.structured_sketch_error_string.argtypes = [i32]
        lib.structured_sketch_error_string.restype = ctypes.c_char_p
    return lib


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


def _launch_check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.structured_sketch_error_string(status).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({status})")


def structured_sketch_sums(
    x: torch.Tensor, diags: torch.Tensor, radii: torch.Tensor, beta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(cos_sums, sin_sums)``, each ``(nblocks, d)``.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices, ``d`` above
    ``MAX_KERNEL_D``).  The sums are bitwise repeatable: per-block partials
    and a fixed-order second pass, no float atomics.
    """
    global STRUCTURED_LAUNCHES
    _check_inputs(x, diags, radii, beta)
    dev = check_cuda((("x", x), ("diags", diags), ("radii", radii), ("beta", beta)))
    nblocks, _, d = diags.shape
    if not 32 <= d <= MAX_KERNEL_D:
        raise ValueError(f"the structured kernel takes 32 <= d <= {MAX_KERNEL_D}, got {d}")
    n_pts, n = x.shape
    fb = max(1, _THREADS // d)
    rows, groups = grid_rows(n_pts, -(-nblocks // fb), sm_count(dev))
    lib = _lib()
    with torch.cuda.device(dev):
        part_c = torch.empty((groups, nblocks * d), dtype=torch.float32, device=dev)
        part_s = torch.empty_like(part_c)
        cos_out = torch.empty((nblocks, d), dtype=torch.float32, device=dev)
        sin_out = torch.empty_like(cos_out)
        status = lib.structured_sketch_sums(
            x.data_ptr(), diags.data_ptr(), radii.data_ptr(), beta.data_ptr(),
            n_pts, n, d, nblocks, inv_sqrt(d), rows, groups,
            part_c.data_ptr(), part_s.data_ptr(), cos_out.data_ptr(), sin_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launch_check(lib, status, "structured_sketch")
    STRUCTURED_LAUNCHES += 1
    return cos_out, sin_out


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
    if not 32 <= d <= MAX_KERNEL_D:
        raise ValueError(f"the structured kernel takes 32 <= d <= {MAX_KERNEL_D}, got {d}")
    n_pts, n = x.shape
    fb = max(1, _THREADS // d)
    rows, groups = grid_rows(n_pts, -(-nblocks // fb), sm_count(dev))
    lib = _lib()
    with torch.cuda.device(dev):
        qcos = torch.zeros((nblocks, d), dtype=torch.int32, device=dev)
        qsin = torch.zeros_like(qcos)
        status = lib.quantized_structured_sketch_sums(
            x.data_ptr(), diags.data_ptr(), radii.data_ptr(), dither.data_ptr(),
            None if valid is None else valid.data_ptr(), n_pts, n, d, nblocks,
            inv_sqrt(d), int(bits == 1), float(qz.quantization_scale(bits)), rows, groups,
            qcos.data_ptr(), qsin.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launch_check(lib, status, "quantized_structured_sketch")
    QUANTIZED_STRUCTURED_LAUNCHES += 1
    return qcos, qsin


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
    qcos = torch.zeros(radii.shape, dtype=torch.int32, device=x.device)
    qsin = torch.zeros_like(qcos)
    for start, stop, proj in _plain_phases(x, diags, radii):
        v = None if valid is None else valid[start:stop, None, None]
        qc, qs = qz.quantize_codes(proj, dither, bits, valid=v)
        qcos += qc.sum(dim=0, dtype=torch.int32)
        qsin += qs.sum(dim=0, dtype=torch.int32)
    return qcos, qsin
