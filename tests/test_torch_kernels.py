"""The port's kernel modules on the CPU: each plain version against the
reference's kernel (Pallas in interpret mode), the device dispatch, and the
kernel wrappers' refusal of what the CUDA kernels do not take.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds each
of them against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freq_ops as jfo
from repro.kernels import ops as jops
from repro_torch.kernels import assign_argmin as aa
from repro_torch.kernels import fourier_sketch as fs
from repro_torch.kernels import ops as kops

pytestmark = pytest.mark.torch_port


def _sketch_inputs(seed, n_pts, feat, m):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, feat)) * 2.0).astype(np.float32)
    w = rng.standard_normal((feat, m)).astype(np.float32)
    beta = rng.uniform(size=n_pts).astype(np.float32)
    return x, w, beta


@pytest.mark.parametrize(
    "n_pts,feat,m",
    [(100, 10, 130), (1, 3, 7), (333, 24, 257), (1000, 10, 1000)],
)
def test_fourier_sketch_plain_matches_reference_kernel(n_pts, feat, m):
    """Sums / N agree with the reference's Pallas kernel within 1e-4 (the
    repo's bar across sketch backends), at ragged N and m."""
    x, w, beta = _sketch_inputs(0, n_pts, feat, m)
    jc, js = jops.fourier_sketch_sums(
        jnp.asarray(x), jfo.as_operator(jnp.asarray(w)), jnp.asarray(beta),
        block_n=128, block_m=128, interpret=True,
    )
    tc, ts = fs.fourier_sketch_sums_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(beta)
    )
    np.testing.assert_allclose(tc.numpy() / n_pts, np.asarray(jc) / n_pts, atol=1e-4)
    np.testing.assert_allclose(ts.numpy() / n_pts, np.asarray(js) / n_pts, atol=1e-4)


def test_fourier_sketch_plain_chunking_is_invisible(monkeypatch):
    """Rows summed over several chunks give the one-chunk sums."""
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(1, 1000, 5, 64))
    whole = fs.fourier_sketch_sums_plain(x, w, beta)
    monkeypatch.setattr(fs, "_PLAIN_CHUNK", 128)
    parts = fs.fourier_sketch_sums_plain(x, w, beta)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)


def _assign_inputs(seed, n_pts, feat, k):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, feat)) * 3).astype(np.float32)
    c = (rng.standard_normal((k, feat)) * 3).astype(np.float32)
    return x, c


@pytest.mark.parametrize(
    "n_pts,feat,k", [(100, 10, 10), (1, 4, 3), (777, 5, 13), (2048, 16, 64)]
)
def test_assign_argmin_plain_matches_reference_kernel(n_pts, feat, k):
    """Labels equal and distances within rtol 1e-5 of the reference kernel."""
    x, c = _assign_inputs(10, n_pts, feat, k)
    jl, jd = jops.assign_argmin(jnp.asarray(x), jnp.asarray(c), block_n=128, interpret=True)
    tl, td = aa.assign_argmin_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_assign_argmin_plain_ties_go_to_lowest_index():
    """Duplicated centroids tie exactly; the lowest index wins, as in
    ``jnp.argmin`` and the reference kernel."""
    x, c = _assign_inputs(11, 300, 4, 5)
    c = np.concatenate([c, c[[1, 0]]])  # centroid 5 == 1, centroid 6 == 0
    jl, _ = jops.assign_argmin(jnp.asarray(x), jnp.asarray(c), block_n=128, interpret=True)
    tl, _ = aa.assign_argmin_plain(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert not np.isin(tl.numpy(), [5, 6]).any()


def test_ops_dispatch_cpu_tensors_to_the_plain_versions(monkeypatch):
    """A CPU tensor reaches the plain version and never the kernel wrapper."""

    def no_kernel(*args):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(fs, "fourier_sketch_sums", no_kernel)
    monkeypatch.setattr(aa, "assign_argmin", no_kernel)
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(2, 50, 3, 20))
    before = (fs.LAUNCHES, aa.LAUNCHES)
    for a, b in zip(kops.fourier_sketch_sums(x, w, beta), fs.fourier_sketch_sums_plain(x, w, beta)):
        assert torch.equal(a, b)
    labels, _ = kops.assign_argmin(x, x[:4].contiguous())
    assert labels.shape == (50,)
    assert (fs.LAUNCHES, aa.LAUNCHES) == before  # plain calls do not count


@pytest.mark.parametrize("kernel", ["fourier_sketch", "assign_argmin"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The kernel wrappers launch on CUDA tensors or raise: no fallback."""
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(3, 20, 3, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        if kernel == "fourier_sketch":
            fs.fourier_sketch_sums(x, w, beta)
        else:
            aa.assign_argmin(x, x[:2].contiguous())


def test_wrappers_check_shapes_and_dtypes():
    x, w, beta = (torch.from_numpy(a) for a in _sketch_inputs(4, 20, 3, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        fs.fourier_sketch_sums_plain(x, w[:2], beta)
    with pytest.raises(TypeError, match="float32"):
        fs.fourier_sketch_sums_plain(x.double(), w, beta)
    with pytest.raises(ValueError, match="expected x"):
        aa.assign_argmin_plain(x, x[:4, :2].contiguous())
    with pytest.raises(ValueError, match="at least one centroid"):
        aa.assign_argmin_plain(x, x[:0])
