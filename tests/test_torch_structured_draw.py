"""The structured operator's restricted-norm rescale in bounded memory.

``freq_ops.structured._restricted_rescale`` sums the chain over the ``n``
zero-padded basis vectors in one pass when the ``(n, nblocks, d)`` tensor
fits ``_RESCALE_ONE_PASS_BYTES``, else in chunks of ``_RESCALE_CHUNK_BYTES``
added in float64, with the first stage written out.  Held here: the chunked
sums against one pass (rtol 1e-6: the same terms added in another order),
an operator that fits one pass bitwise its draw by the one-pass formula
(``hd_chain`` of the identity's rows, as the port drew before it chunked),
and a chunked draw against the reference's formula on the same numpy signs
and radii (rtol 1e-5, the operator tolerance of
``test_torch_structured.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import freq_transform as jft
from repro_torch.core import freq_ops as tfo
from repro_torch.core.freq_ops import structured as tst
from repro_torch.kernels import freq_transform as tft

pytestmark = pytest.mark.torch_port


def _one_pass(diags, rho, n):
    """The one-pass formula: the chain over ``eye(d)[:n]``, squares summed
    over the basis in one ``torch.sum``."""
    d = diags.shape[-1]
    basis = torch.eye(d, dtype=diags.dtype)[:n]
    cols = tft.hd_chain(basis[:, None, :], diags)
    return rho / torch.clamp(torch.sqrt(torch.sum(cols * cols, dim=0)), min=1e-6)


def _signs_and_rho(nblocks, d, seed):
    rng = np.random.default_rng(seed)
    diags = rng.choice(np.array([-1.0, 1.0], np.float32), (nblocks, 3, d))
    rho = rng.uniform(0.1, 3.0, (nblocks, d)).astype(np.float32)
    return torch.from_numpy(diags), torch.from_numpy(rho)


@pytest.mark.parametrize("d,nblocks,n,chunk_rows", [
    (32, 4, 10, 3), (256, 3, 200, 7), (1024, 2, 700, 64), (4096, 2, 2500, 1),
])
def test_chunked_rescale_matches_one_pass(monkeypatch, d, nblocks, n, chunk_rows):
    """With the one-pass budget forced below the operator and chunks of
    ``chunk_rows`` rows, the chunked radii are the one-pass radii to 1e-6."""
    diags, rho = _signs_and_rho(nblocks, d, seed=d + n)
    want = _one_pass(diags, rho, n)
    monkeypatch.setattr(tst, "_RESCALE_ONE_PASS_BYTES", 0)
    monkeypatch.setattr(tst, "_RESCALE_CHUNK_BYTES", 4 * nblocks * d * chunk_rows)
    got = tst._restricted_rescale(diags, rho, n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("d,nblocks,n", [(32, 32, 10), (128, 3, 100), (1024, 3, 600),
                                         (2048, 10, 2048)])
def test_one_pass_operator_keeps_its_bits(d, nblocks, n):
    """An operator within the one-pass budget (here up to the wide shape's
    n = 2048, m = 20,000: 168 MB) draws bitwise what the one-pass formula
    gives: the written-out first stage is exact."""
    assert n * nblocks * d * 4 <= tst._RESCALE_ONE_PASS_BYTES
    diags, rho = _signs_and_rho(nblocks, d, seed=3 * d + n)
    assert torch.equal(tst._restricted_rescale(diags, rho, n), _one_pass(diags, rho, n))


def test_one_pass_budget_covers_the_draws_below_d_model_4096():
    """The monitor at d_model 2048 with K = 4 (m = 32,768: 16 blocks of
    2048) fits one pass; d_model 4096 (16 blocks of 4096) does not."""
    assert 2048 * 16 * 2048 * 4 <= tst._RESCALE_ONE_PASS_BYTES < 4096 * 16 * 4096 * 4


def test_seeded_draw_keeps_its_bits():
    """``seeded_operator`` (a CPU generator, then moved) gives the radii of
    the one-pass formula on its own signs and rho, bitwise."""
    op = tfo.seeded_operator("structured", 11, 3000, 600, 0.8, device="cpu")
    assert torch.equal(op.radii, _one_pass(op.diags, op.rho, 600))


@pytest.mark.parametrize("d,nblocks,n", [(256, 3, 200), (4096, 2, 2500)])
def test_chunked_draw_matches_reference_formula(monkeypatch, d, nblocks, n):
    """A chunked draw against the reference's ``build_structured`` formula
    (one ``hd_chain`` over ``jnp.eye(d)[:n]``) on the same numpy signs and
    rho: rtol 1e-5."""
    diags, rho = _signs_and_rho(nblocks, d, seed=5 * d + n)
    monkeypatch.setattr(tst, "_RESCALE_ONE_PASS_BYTES", 0)
    monkeypatch.setattr(tst, "_RESCALE_CHUNK_BYTES", 4 * nblocks * d * 37)
    got = tst._restricted_rescale(diags, rho, n)
    basis = jnp.eye(d, dtype=jnp.float32)[:n]
    cols = jft.hd_chain(basis[:, None, :], jnp.asarray(diags.numpy()))
    want = jnp.asarray(rho.numpy()) / jnp.maximum(jnp.sqrt(jnp.sum(cols * cols, axis=0)), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
