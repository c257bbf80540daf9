"""The port's MoE and hybrid families on a mesh against the reference's mesh
run (granite-moe-1b-a400m, jamba-v0.1-52b): ``test_torch_mesh.py``'s checks,
in a file of their own so that the two halves run side by side.

The reference's expert-parallel body takes the capacity from its data
shard's token count and returns each shard's own aux loss, so its loss
depends on the mesh: the port is held to the reference's mesh run, not to
its own one-card run.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from _torch_mesh_ranks import MESHES  # noqa: E402
from test_torch_mesh import (  # noqa: E402
    check_loss,
    check_ranks_agree,
    check_serve,
    check_tree,
    mesh_runs,
)

pytestmark = pytest.mark.torch_port

ARCHS = ("granite-moe-1b-a400m", "jamba-v0.1-52b")
CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("mesh_moe"), ARCHS, extras=False)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_lm_loss_matches_the_reference_mesh(runs, arch, mesh):
    check_loss(runs.ref, runs.ranks, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_gradients_match_the_reference_mesh(runs, arch, mesh):
    check_tree(runs.ref, runs.ranks, arch, mesh, "grads")
    check_ranks_agree(runs.ranks, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_adamw_step_matches_the_reference(runs, arch, mesh):
    check_tree(runs.ref, runs.ranks, arch, mesh, "step")


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_and_decode_match_one_card(runs, arch, mesh):
    check_serve(runs.ref, runs.ranks, arch, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_compressed_decode_matches_one_card(runs, mesh):
    """jamba's CKM-compressed cache on the mesh (centroids and ring split
    over "model", each rank attending over its blocks with the softmax's
    max and sums all-reduced) decodes as on one card."""
    out = runs.ranks[0][f"jamba-v0.1-52b/{mesh}"]["ck"]
    assert len(out["got"]) == len(out["want"]) > 0
    for g, w in zip(out["got"], out["want"]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
