"""The port's Lloyd-Max baseline against the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lloyd as jlloyd
from repro_torch import convert
from repro_torch.core import lloyd as tlloyd

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("init", ["range", "sample", "kpp"])
def test_lloyd_from_reference_init_matches_reference(gaussian_blobs, init):
    """Both packages start from the reference's initial centroids: the final
    centroids agree within 1e-4 and take the same number of iterations."""
    x, _, _ = gaussian_blobs
    jcfg = jlloyd.LloydConfig(k=5, init=init)
    key = jax.random.PRNGKey(3)
    ref = jlloyd.lloyd(key, x, jcfg)
    cents0 = jlloyd._init_centroids(key, x, jnp.min(x, axis=0), jnp.max(x, axis=0), jcfg)
    xt = torch.from_numpy(np.array(x))
    cents, iters = tlloyd._iterate(
        xt, convert.centroids_from_numpy(np.asarray(cents0), device="cpu"),
        tlloyd.LloydConfig(k=5, init=init),
    )
    np.testing.assert_allclose(cents.numpy(), np.asarray(ref.centroids), atol=1e-4)
    assert iters == int(ref.iters)


@pytest.mark.parametrize("init", ["range", "sample", "kpp"])
def test_kmeans_replicates_pick_the_best_sse(gaussian_blobs, init):
    x, _, _ = gaussian_blobs
    xt = torch.from_numpy(np.array(x))
    cfg = tlloyd.LloydConfig(k=5, init=init, replicates=3)
    best = tlloyd.kmeans(4, xt, cfg, device="cpu")
    singles = [
        tlloyd.lloyd(tlloyd.dev_mod.derive_seed(4, r), xt, cfg, device="cpu") for r in range(3)
    ]
    assert float(best.sse) == min(float(s.sse) for s in singles)
    assert best.centroids.shape == (5, 4) and 1 <= best.iters <= cfg.max_iters
    ref = jlloyd.kmeans(jax.random.PRNGKey(4), x, jlloyd.LloydConfig(k=5, init=init, replicates=3))
    assert float(best.sse) <= 1.05 * float(ref.sse)


def test_empty_clusters_keep_their_centroid():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    far = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    cents, _ = tlloyd._iterate(x, far, tlloyd.LloydConfig(k=3))
    assert torch.equal(cents[2], far[2])
    np.testing.assert_allclose(cents[0].numpy(), [0.05, 0.0])


def test_kmeans_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tlloyd.kmeans(0, torch.zeros((10, 2)), tlloyd.LloydConfig(k=2))
