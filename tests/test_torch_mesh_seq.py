"""Sequence parallelism and the grouped prefill of the port's LM on a mesh,
on the CPU.

- internvl2-26b's smoke config at d_model 4096, the reference's threshold
  (``internvl2-26b@d4096``), on (2, 2) and (4, 1) ("data", "model") meshes
  against the reference's mesh run (``test_torch_mesh.py``'s harness and
  bars): on (2, 2) the residual stream is each rank's half of the
  sequence, and remat saves that half;
- the smoke configs of the other mixers and of the grouped attention run
  sequence-parallel by the port whatever their width (``arch@seq``: gemma3's
  grouped attention over local windows, jamba's Mamba and MoE, whisper's
  cross-attention, xlstm's mLSTM and sLSTM) against the reference's mesh
  run of the same config, which is the same math;
- on a fake group of two ranks, ``utils.hlo.CostMode`` counts gemma3's
  grouped prefill: each rank's attention is half the replicated one's, and
  each attention layer's cache takes one all-to-all.
"""

import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

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

WIDE = "internvl2-26b@d4096"
ARCHS = (WIDE, "gemma3-1b@seq", "jamba-v0.1-52b@seq", "whisper-small@seq", "xlstm-125m@seq")
CASES = [(a, m) for a in ARCHS for m in MESHES]
S = 32  # _torch_mesh_reference.S: the batch's positions, vision prefix included


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("mesh_seq"), ARCHS, extras=False)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_lm_loss_matches_the_reference_mesh(runs, arch, mesh):
    check_loss(runs.ref, runs.ranks, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_gradients_match_the_reference_mesh(runs, arch, mesh):
    check_tree(runs.ref, runs.ranks, arch, mesh, "grads")
    check_ranks_agree(runs.ranks, arch, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_adamw_step_matches_the_reference(runs, mesh):
    """The d_model-4096 config's step.  The forced cases' gradients are held
    above: an AdamW step at count 1 moves a leaf by about lr whatever its
    gradient, and one whose gradient is near Adam's eps (Mamba's conv_b,
    drawn zero) by an amount that magnifies the gradient's last bits."""
    check_tree(runs.ref, runs.ranks, WIDE, mesh, "step")


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_and_decode_match_one_card(runs, arch, mesh):
    check_serve(runs.ref, runs.ranks, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_remat_saves_the_rank_block_of_the_sequence(runs, arch, mesh):
    """Each group input that remat "full" saves holds S / model rows where
    the stream is sequence-parallel (every arch here on (2, 2)), S on (4, 1)."""
    model = MESHES[mesh][1]
    for r in runs.ranks:
        rows = r[f"{arch}/{mesh}"]["saved_rows"]
        assert rows and set(rows) == {S // model}, rows


def test_grouped_prefill_splits_the_attention_and_exchanges_once(monkeypatch):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import serve_specs
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as sh
    from repro_torch.utils import hlo

    cfg = get_smoke_config("gemma3-1b")  # 2 heads, 1 KV head: grouped on 2 "model" ranks
    cache_len = 64
    attend, core = L._attend_block, []

    def counted(*args, **kwargs):
        mode = hlo.CostMode()
        with mode:
            out = attend(*args, **kwargs)
        core.append(mode.costs.flops)
        return out

    monkeypatch.setattr(L, "_attend_block", counted)
    dryrun.fake_group(2)
    try:
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        shape = ShapeConfig("p", cache_len, 2, "prefill")
        params = sh.shard_tree(tfm.init_lm(0, cfg, device="cpu"),
                               serve_specs(cfg, shape, mesh, dtype=torch.float32)["params"], mesh)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 48))}
        costs = {}
        for name in ("grouped", "replicated"):
            if name == "replicated":
                monkeypatch.setattr(tfm, "_attn_grouped", lambda cfg, sp: False)
            core.clear()
            with torch.no_grad():
                costs[name] = hlo.analyze(
                    lambda: tfm.prefill(params, cfg, batch, cache_len, mesh=mesh,
                                        dtype=torch.float32))
            costs[name].core = sum(core)
    finally:
        dist.destroy_process_group()
    grouped, replicated = costs["grouped"], costs["replicated"]
    assert grouped.core > 0 and grouped.core * 2 == replicated.core
    assert grouped.flops < replicated.flops
    assert grouped.coll_count["all-to-all"] == cfg.n_layers  # every layer attends
    assert "all-to-all" not in replicated.coll_count
