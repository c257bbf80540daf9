"""The sketch-and-shift score step: the CUDA kernel and its plain twin.

Counterpart of ``repro.kernels.sketch_shift.sketch_shift_kernel``.  For
candidates ``c (P, n)``, a dense frequency matrix ``w (n, m)`` and the halves
``z1, z2 (m,)`` of a stacked-real sketch, both functions here return the
unnormalised sums

    f_sums (P,)   = sum_j  cos(c w_j) z1_j - sin(c w_j) z2_j
    g_sums (P, n) = sum_j (-sin(c w_j) z1_j - cos(c w_j) z2_j) w_j

- :func:`sketch_shift_sums` launches ``csrc/sketch_shift.cu`` on CUDA tensors
  (or raises) and counts each launch in ``LAUNCHES``;
- :func:`sketch_shift_sums_plain` is the plain PyTorch version: ``c @ w``,
  then the two sums.

``kernels.ops.sketch_shift_scores`` picks between them by the tensor's
device and divides by m.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, on_device, sm_count, stream_ptr

# Kernel launches since the count was last reset (plain calls do not count;
# one call counts one, on either path).
LAUNCHES = 0
# The narrow path (one cluster launch) takes n <= NARROW_MAX_N: CANDS
# candidates a cluster of at most MAX_CLUSTER CTAs, each CTA a slice of at
# least MIN_SLICE frequencies where m allows.
NARROW_MAX_N = 64
CANDS = 2
MAX_CLUSTER = 8
MIN_SLICE = 32
# The wide path: a CTA's tile is 16 tp candidates (tp <= MAX_TP) by TILE
# columns, the contraction staged DEPTH at a time; the gradient's split
# over m aims at SPLIT_BLOCKS_PER_SM CTAs an SM.
MAX_TP = 8
TILE = 64
DEPTH = 16
SPLIT_BLOCKS_PER_SM = 8


def _lib() -> ctypes.CDLL:
    lib = _build.load("sketch_shift")
    if lib.sketch_shift_narrow.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sketch_shift_narrow.argtypes = [ptr] * 4 + [i32] * 5 + [ptr, ptr]
        lib.sketch_shift_narrow.restype = i32
        lib.sketch_shift_wide.argtypes = [ptr] * 4 + [i32] * 6 + [ptr, ptr, ptr]
        lib.sketch_shift_wide.restype = i32
        lib.sketch_shift_error_string.argtypes = [i32]
        lib.sketch_shift_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(c, w, z1, z2) -> None:
    if c.ndim != 2 or w.ndim != 2 or z1.ndim != 1 or z2.ndim != 1:
        raise ValueError(
            f"expected c (P, n), w (n, m), z1 and z2 (m,); got {tuple(c.shape)}, "
            f"{tuple(w.shape)}, {tuple(z1.shape)}, {tuple(z2.shape)}"
        )
    if c.shape[1] != w.shape[0] or z1.shape[0] != w.shape[1] or z2.shape != z1.shape:
        raise ValueError(
            f"shape mismatch: c {tuple(c.shape)}, w {tuple(w.shape)}, "
            f"z1 {tuple(z1.shape)}, z2 {tuple(z2.shape)}"
        )
    for name, t in (("c", c), ("w", w), ("z1", z1), ("z2", z2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def shift_grid(p_cand: int, m: int) -> tuple[int, int, int]:
    """``(cluster, split_len, groups)`` of the narrow path's grid: ``groups``
    clusters of ``CANDS`` candidates, each of ``cluster`` CTAs that split m
    into contiguous slices of ``split_len`` frequencies, none empty.  The
    cluster is as wide as allowed (``MAX_CLUSTER``) while each slice keeps
    ``MIN_SLICE`` frequencies: at the decoder's P = 80, m = 1000 that is 40
    clusters of 8 CTAs, 320 CTAs for 132 SMs.  A fixed function of the
    shape, so the rank-order sum repeats its bits."""
    groups = -(-p_cand // CANDS)
    cluster = max(1, min(MAX_CLUSTER, m // MIN_SLICE))
    split_len = -(-m // cluster)
    return -(-m // split_len), split_len, groups


def wide_grid(p_cand: int, n: int, m: int, sms: int) -> dict[str, int]:
    """The wide path's geometry: ``tp`` candidates a thread (``16 tp`` a
    CTA: all of them up to 128), the tiles of the phase kernel
    (``p_tiles`` by ``m_tiles`` of ``TILE`` frequencies) and of the gradient
    kernel (``p_tiles`` by ``n_tiles`` of ``TILE`` coordinates by
    ``splits`` slices of ``split_len`` frequencies, a multiple of
    ``DEPTH``, none empty), and the ``scratch`` floats they need: t (P, m),
    f's tile partials and g's split partials."""
    tp = min(MAX_TP, max(1, -(-p_cand // 16)))
    p_tiles = -(-p_cand // (16 * tp))
    m_tiles, n_tiles = -(-m // TILE), -(-n // TILE)
    wanted = max(1, -(-SPLIT_BLOCKS_PER_SM * sms // (n_tiles * p_tiles)))
    depth_steps = -(-m // DEPTH)
    split_len = DEPTH * -(-depth_steps // min(wanted, depth_steps, 65535))
    splits = -(-m // split_len)
    scratch = p_cand * m + m_tiles * p_cand + splits * p_cand * n
    return {"tp": tp, "p_tiles": p_tiles, "m_tiles": m_tiles, "n_tiles": n_tiles,
            "splits": splits, "split_len": split_len, "scratch": scratch}


def sketch_shift_sums(
    c: torch.Tensor, w: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(f_sums (P,), g_sums (P, n))`` for CUDA tensors.

    n <= ``NARROW_MAX_N`` takes one cluster launch, wider operators the
    two-phase path.  Raises for anything the kernel does not take (a CPU
    tensor, another dtype, a non-contiguous tensor, mismatched devices).
    The sums are bitwise repeatable: no float atomics, a fixed reduction
    order.
    """
    global LAUNCHES
    _check_inputs(c, w, z1, z2)
    dev = check_cuda((("c", c), ("w", w), ("z1", z1), ("z2", z2)))
    p_cand, n = c.shape
    m = w.shape[1]
    if max(p_cand * (n + 1), n * m, p_cand * m) >= 2**31:
        raise ValueError(f"P, n, m = {p_cand}, {n}, {m} exceed the kernel's int32 sizes")
    lib = _lib()
    with on_device(dev):
        out = torch.empty((p_cand * (n + 1),), dtype=torch.float32, device=dev)
        if n <= NARROW_MAX_N:
            cluster, split_len, _ = shift_grid(p_cand, m)
            status = lib.sketch_shift_narrow(
                c.data_ptr(), w.data_ptr(), z1.data_ptr(), z2.data_ptr(), p_cand, n, m,
                cluster, split_len, out.data_ptr(), stream_ptr(dev),
            )
        else:
            geo = wide_grid(p_cand, n, m, sm_count(dev))
            scratch = torch.empty((geo["scratch"],), dtype=torch.float32, device=dev)
            status = lib.sketch_shift_wide(
                c.data_ptr(), w.data_ptr(), z1.data_ptr(), z2.data_ptr(), p_cand, n, m,
                geo["tp"], geo["splits"], geo["split_len"], scratch.data_ptr(),
                out.data_ptr(), stream_ptr(dev),
            )
    if status != 0:
        msg = lib.sketch_shift_error_string(status).decode()
        raise RuntimeError(f"sketch_shift kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return out[:p_cand], out[p_cand:].view(p_cand, n)


def sketch_shift_sums_plain(
    c: torch.Tensor, w: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``proj = c @ w``, then both sums (the ``(P, m)``
    trig matrices are materialised)."""
    _check_inputs(c, w, z1, z2)
    proj = c @ w
    cosp, sinp = torch.cos(proj), torch.sin(proj)
    f = cosp @ z1 - sinp @ z2
    g = ((-sinp) * z1 - cosp * z2) @ w.T
    return f, g
