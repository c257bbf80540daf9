"""The ``"structured"`` frequency operator — stacked HD-Rademacher blocks
(counterpart of ``repro.core.freq_ops.structured``).

Each block of ``d = block_dim(n)`` frequencies uses the fast transform

    B = c·H D_2 · c·H D_1 · c·H D_0        (c = d^{-1/2}, D_i Rademacher ±1)

— exactly orthogonal, so its rows are unit-norm directions; ``ceil(m/d)``
independent blocks are stacked and the tail past ``m`` is sliced off.  The
radial part is the adapted-radius law (``frequencies.draw_radii``): each drawn
radius ``rho_j`` is divided by the norm of row j restricted to the first
``n`` coordinates, so the realised ``||ω_j||`` equals ``rho_j`` and
``col_norms()`` is the stored ``rho``.

``apply``/``adjoint`` are differentiable torch ops (``kernels.freq_transform``
in the Kronecker form), so decoders optimise through the fast transform with
autograd.  The sketch pass does not call them: ``kernels.ops`` sends the
operator's signs and radii to the structured CUDA kernels.
"""

from __future__ import annotations

import torch

from repro_torch import device as dev_mod
from repro_torch.core import frequencies as freq_mod
from repro_torch.core.freq_ops.base import FrequencyOperator, register_freq_op
from repro_torch.kernels import freq_transform as ft

# Minimum WHT block width: at small n the HD orbit holds few distinct
# directions; a wider block restricted back to n coordinates recovers them.
_MIN_BLOCK = 32


def block_dim(n: int) -> int:
    """The WHT block width: next power of two >= n, floored at ``_MIN_BLOCK``."""
    return max(1 << max(0, int(n) - 1).bit_length(), _MIN_BLOCK)


def _pad_last(x: torch.Tensor, size: int) -> torch.Tensor:
    pad = size - x.shape[-1]
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))


class StructuredOperator(FrequencyOperator):
    """Stacked fast-transform blocks with adapted-radius radial rescaling.

    ``diags (nblocks, 3, d)`` Rademacher signs, ``radii (nblocks, d)`` the
    rescaled step sizes, ``rho (nblocks, d)`` the drawn magnitudes
    (``col_norms``); all float32 on one device.
    """

    name = "structured"

    def __init__(self, diags: torch.Tensor, radii: torch.Tensor, rho: torch.Tensor,
                 n: int, m: int, spec=None):
        nblocks, three, d = diags.shape
        if three != 3 or tuple(radii.shape) != (nblocks, d) or tuple(rho.shape) != (nblocks, d):
            raise ValueError(
                f"expected diags (nblocks, 3, d), radii and rho (nblocks, d); got "
                f"{tuple(diags.shape)}, {tuple(radii.shape)}, {tuple(rho.shape)}"
            )
        if not (0 < n <= d and 0 < m <= nblocks * d):
            raise ValueError(f"n = {n}, m = {m} do not fit {nblocks} blocks of width {d}")
        self.diags, self.radii, self.rho = diags, radii, rho
        self._n, self._m = int(n), int(m)
        self._spec = spec

    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        return self._m

    @property
    def d(self) -> int:
        return self.diags.shape[-1]

    @property
    def nblocks(self) -> int:
        return self.diags.shape[0]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.diags.dtype)
        xp = _pad_last(x, self.d)  # zero feature pad shifts no phases
        v = ft.hd_chain(xp[..., None, :], self.diags)  # (..., nblocks, d)
        y = v * self.radii
        return y.reshape(x.shape[:-1] + (self.nblocks * self.d,))[..., : self.m]

    def adjoint(self, v: torch.Tensor) -> torch.Tensor:
        v = v.to(self.diags.dtype)
        vp = _pad_last(v, self.nblocks * self.d)
        u = vp.reshape(v.shape[:-1] + (self.nblocks, self.d)) * self.radii
        # Transpose of the hd_chain: the same symmetric H stages, diags reversed.
        c = ft.inv_sqrt(self.d, u.dtype)
        for s in (2, 1, 0):
            u = ft.fwht(u) * c * self.diags[..., s, :]
        return torch.sum(u, dim=-2)[..., : self.n]

    def materialize(self) -> torch.Tensor:
        return self.apply(torch.eye(self.n, dtype=self.diags.dtype, device=self.diags.device))

    def col_norms(self) -> torch.Tensor:
        return self.rho.reshape(-1)[: self.m]

    def to(self, device: torch.device) -> "StructuredOperator":
        if self.diags.device == device:
            return self
        return StructuredOperator(
            self.diags.to(device), self.radii.to(device), self.rho.to(device), self._n, self._m,
            self._spec,
        )


# The restricted rescale's (chunk, nblocks, d) float32 chain outputs: an
# operator whose whole tensor takes at most _RESCALE_ONE_PASS_BYTES is summed
# in one pass (every operator the suite and the smoke run draw below d_model
# 4096 does: the monitor's at 2048, K = 4, takes 268 MB); a larger one in
# chunks of _RESCALE_CHUNK_BYTES, which the host's caches hold (per element,
# some 2-4x faster than chunks of hundreds of MB on an 8-core Xeon), their
# sums added in float64.  So the draw's memory is bounded at any n: a chunk
# and a few intermediates of its size.
_RESCALE_ONE_PASS_BYTES = 512 << 20
_RESCALE_CHUNK_BYTES = 8 << 20


def _basis_chain(diags: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """``hd_chain`` of the zero-padded basis vectors ``e_start .. e_stop-1``
    against every block, ``(stop - start, nblocks, d)``.  The first stage of
    ``e_i`` is ``c D_0[i] H[i, :]``, every entry ``+-c`` exactly (one nonzero
    product a sum), so it is written out rather than transformed: the same
    bits without a third of the transforms."""
    d = diags.shape[-1]
    idx = torch.arange(start, stop, device=diags.device)
    a, b = ft.kron_factors(d)
    ha = ft.hadamard(a, diags.dtype, diags.device)
    hb = ft.hadamard(b, diags.dtype, diags.device)
    h_rows = (ha[idx // b][:, :, None] * hb[idx % b][:, None, :]).reshape(-1, d)  # H[i, :]
    c = ft.inv_sqrt(d, diags.dtype)
    v = h_rows[:, None, :] * (diags[:, 0, start:stop].T[:, :, None] * c)
    for s in (1, 2):
        v = ft.fwht(v * diags[..., s, :]) * c
    return v


def _restricted_rescale(diags: torch.Tensor, rho: torch.Tensor, n: int) -> torch.Tensor:
    """``rho`` divided by each row's norm restricted to the first ``n``
    coordinates: the chain over the ``n`` zero-padded basis vectors, its
    squares summed in one pass, or over chunks in float64 (see
    ``_RESCALE_ONE_PASS_BYTES``), which may move the last bits against one
    pass."""
    nblocks, _, d = diags.shape
    row_bytes = 4 * nblocks * d
    if n * row_bytes <= _RESCALE_ONE_PASS_BYTES:
        cols = _basis_chain(diags, 0, n)
        total = torch.sum(cols * cols, dim=0)  # (nblocks, d)
    else:
        chunk = max(1, _RESCALE_CHUNK_BYTES // row_bytes)
        total = torch.zeros((nblocks, d), dtype=torch.float64, device=diags.device)
        for start in range(0, n, chunk):
            cols = _basis_chain(diags, start, min(n, start + chunk))
            total += torch.sum(cols * cols, dim=0, dtype=torch.float64)
        total = total.to(diags.dtype)
    return rho / torch.clamp(torch.sqrt(total), min=1e-6)


@register_freq_op("structured")
def build_structured(
    gen: torch.Generator,
    m: int,
    n: int,
    sigma2,
    *,
    dist: str = "adapted_radius",
    device=dev_mod.DEFAULT,
) -> StructuredOperator:
    """Draw the signs, then the radii, from ``gen``, and rescale the radii by
    the restricted row norms."""
    dev = dev_mod.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(
            f"generator lives on {gen.device} but device={str(dev)!r}; create "
            "it with torch.Generator(device=...)"
        )
    d = block_dim(n)
    nblocks = -(-int(m) // d)
    bits = torch.randint(0, 2, (nblocks, 3, d), generator=gen, device=dev)
    diags = (2 * bits - 1).to(torch.float32)
    rho = freq_mod.draw_radii(gen, nblocks * d, n, sigma2, dist, dev).reshape(nblocks, d)
    return StructuredOperator(diags, _restricted_rescale(diags, rho, n), rho, int(n), int(m))
