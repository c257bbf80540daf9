"""The port's LM on a mesh against the reference's mesh run, on the CPU.

One smoke config a dense family (llama3.2-1b, gemma3-1b, xlstm-125m,
whisper-small, internvl2-26b; the MoE and hybrid families are in
``test_torch_mesh_moe.py``, so that the two halves run side by side) on
(2, 2) and (4, 1) ("data", "model") meshes:

- the reference's run comes from ``tests/_torch_mesh_reference.py``, a
  subprocess with four forced host devices and ``AxisType.Auto`` meshes
  built there (``make_local_mesh``'s are ``Explicit`` on this JAX);
- the port's from four gloo ranks, one spawn (``tests/_torch_mesh_ranks.py``,
  which never imports JAX), on the reference's parameters and batch;
- ``lm_loss`` within 1e-5 relative, each gradient leaf within 1e-4 of its
  max-abs, one AdamW step's parameters likewise; prefill and decode logits
  within tests/test_archs.py's bar of the port's one-card run;
- ``pipeline_apply`` over 4 stages against the reference's; the compressed
  all-reduce over (2, 2) ("pod", "data") against the reference's, within
  one quantisation step, and over 20 steps tracking the exact sum;
- ``build_compressed_train_step`` on that mesh: the exchanged mean gradient
  within one int16 step of the plain step's, the pods' parameters equal;
- a train loop's checkpoint saved on (2, 2) restores bitwise on (4, 1) and
  on one card, and its monitor sketch matches a one-card loop's.
"""

import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as sh

sys.path.insert(0, str(Path(__file__).parent))
from _torch_mesh_ranks import (  # noqa: E402
    CACHE_LEN,
    DECODE_STEPS,
    MESHES,
    mesh_config,
    nested,
    serve_config,
)

pytestmark = pytest.mark.torch_port

HERE = Path(__file__).parent
ARCHS = ("llama3.2-1b", "gemma3-1b", "xlstm-125m", "whisper-small", "internvl2-26b")
REFERENCE_TIMEOUT_S, SPAWN_TIMEOUT_S = 600, 300
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
LOGIT_ATOL, LOGIT_RTOL = 2e-2, 1e-2


def _start(cmd, log: Path, env=None):
    """``cmd`` in a session of its own, its errors written to ``log``."""
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err, text=True,
                                start_new_session=True, env=env)
    proc.log = log
    return proc


def _kill(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _finish(proc, deadline, what):
    try:
        proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        _kill(proc)
        pytest.fail(f"{what} ran past its time limit")
    assert proc.returncode == 0, f"{what}: {proc.log.read_text()[-4000:]}"


def mesh_runs(root: Path, archs, extras: bool):
    """The reference's run, and the port's four ranks on its draws, which
    start as soon as the reference has written them: the reference's npz
    (``ref``), every rank's results (``ranks``) and their folder
    (``root``)."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    env.pop("XLA_FLAGS", None)
    tail = ["extras"] if extras else []
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    ref = _start([sys.executable, str(HERE / "_torch_mesh_reference.py"), str(root / "ref.npz"),
                  ",".join(archs), *tail], root / "reference.log", env)
    try:
        while not (root / "draws.npz").exists() and ref.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        if not (root / "draws.npz").exists():
            _finish(ref, deadline, "the reference's mesh run")
            pytest.fail("the reference's mesh run wrote no draws")
        ranks = _start([sys.executable, str(HERE / "_torch_mesh_ranks.py"), str(root),
                        ",".join(archs), *tail], root / "ranks.log")
        try:
            _finish(ranks, time.monotonic() + SPAWN_TIMEOUT_S, "the port's four ranks")
        finally:
            _kill(ranks)
        _finish(ref, deadline, "the reference's mesh run")
    finally:
        _kill(ref)
    return types.SimpleNamespace(
        ref=np.load(root / "ref.npz"), root=root,
        ranks=[torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)])


def _ref_leaf(ref, prefix: str, path: str) -> np.ndarray:
    """The reference's leaf for the port's ``path`` (its stacked groups
    indexed)."""
    parts = path.split("/")
    if "groups" not in parts:
        return ref[f"{prefix}/{path}"]
    at = parts.index("groups")
    return ref[f"{prefix}/" + "/".join(parts[:at + 1] + parts[at + 2:])][int(parts[at + 1])]


def check_loss(ref, ranks, arch, mesh):
    got, want = ranks[0][f"{arch}/{mesh}"]["loss"], float(ref[f"{arch}/{mesh}/loss"])
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def check_tree(ref, ranks, arch, mesh, kind):
    tree = ranks[0][f"{arch}/{mesh}"][kind]
    n = 0
    for path, t in sh.walk(tree):
        want = _ref_leaf(ref, f"{arch}/{mesh}/{kind}", path)
        scale = max(float(np.max(np.abs(want))), 1e-30)
        err = float(np.max(np.abs(t.numpy() - want)))
        assert err <= LEAF_TOL * scale, (path, err, scale)
        n += 1
    assert n == len(list(sh.walk(tfm.init_lm(0, mesh_config(arch, get_smoke_config),
                                             device="meta"))))


def check_ranks_agree(ranks, arch, mesh):
    """Every rank gathers the same trees: replicated leaves stayed equal."""
    for r in ranks[1:]:
        for kind in ("grads", "step"):
            for (_, a), (_, b) in zip(sh.walk(ranks[0][f"{arch}/{mesh}"][kind]),
                                      sh.walk(r[f"{arch}/{mesh}"][kind]), strict=True):
                assert torch.equal(a, b)


def check_serve(ref, ranks, arch, mesh):
    """Prefill and decode logits on the mesh against the port's one card."""
    cfg = serve_config(mesh_config(arch, get_smoke_config))
    params = convert.lm_params_from_numpy(nested(ref, f"{arch}/params"), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in nested(ref, f"{arch}/batch").items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, cache, index = tfm.prefill(params, cfg, prompt, CACHE_LEN, dtype=torch.float32)
        want = [logits]
        for t in range(DECODE_STEPS):
            logits, cache = tfm.decode_step(params, cfg, batch["labels"][:, t:t + 1], cache,
                                            index + t, dtype=torch.float32)
            want.append(logits)
    got = ranks[0][f"{arch}/{mesh}"]["logits"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("mesh"), ARCHS, extras=True)


CASES = [(a, m) for a in ARCHS for m in MESHES]


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


def test_pipeline_matches_the_reference(runs):
    ref, ranks = runs.ref, runs.ranks
    for r in ranks:
        torch.testing.assert_close(r["pipeline"], torch.from_numpy(ref["pipe/out"]),
                                   atol=1e-5, rtol=1e-5)
    from repro_torch.parallel.pipeline import bubble_fraction

    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12


def test_compressed_allreduce_matches_the_reference(runs):
    ref, ranks = runs.ref, runs.ranks
    g = ref["gc/g"]
    exact = g.sum(axis=0)
    step = float(np.max(np.abs(g))) / 8192  # one quantisation step
    for r, out in enumerate(ranks):
        sums = out["compression"]["sums"].numpy()
        # The first step: within one step of the reference's and of the
        # exact sum's int16 grid (the reference's own bar).
        assert np.max(np.abs(sums[0] - ref["gc/sums"][0])) <= step
        assert np.max(np.abs(sums[0] - exact)) <= 2 * step + 1e-6
        pod = r // 2  # (pod, data) rank order
        np.testing.assert_allclose(out["compression"]["err1"].numpy()[0], ref["gc/err1"][pod],
                                   atol=step)
        # Error feedback: the accumulated sums track the exact one.
        acc = sums.sum(axis=0)
        rel = np.linalg.norm(acc - 20 * exact) / np.linalg.norm(20 * exact)
        assert rel < 0.01, rel
        np.testing.assert_allclose(acc, ref["gc/sums"].sum(axis=0), atol=20 * step)


def test_compressed_train_step_on_four_ranks(runs):
    """build_compressed_train_step over (2, 2) ("pod", "data") against
    build_train_step on the same mesh: the mean gradient the pods exchanged
    is within one int16 step of the plain step's (a leaf's step: the larger
    pod gradient's max-abs over 2^13), the plain step's is the mean of the
    pods' one-card gradients, the losses agree and the pods hold the same
    parameters after the step."""
    for out in (r["compressed_step"] for r in runs.ranks):
        assert out["pods_equal"]
        loss_c, loss_p = out["losses"]
        assert abs(loss_c - loss_p) <= LOSS_RTOL * abs(loss_p)
        g0, g1 = (dict(sh.walk(g)) for g in out["pods"])
        plain = dict(sh.walk(out["plain"]))
        n = 0
        for path, comp in sh.walk(out["comp"]):
            step = max(float(g0[path].abs().max()), float(g1[path].abs().max())) / 2 ** 13
            assert float((comp - plain[path]).abs().max()) <= step, path
            mean = (g0[path] + g1[path]) / 2
            assert float((plain[path] - mean).abs().max()) <= \
                LEAF_TOL * float(mean.abs().max()), path
            n += 1
        assert n == len(g0) == len(plain)


def test_checkpoint_restores_on_any_mesh(runs, tmp_path, monkeypatch):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import train_loop

    out = runs.ranks[0]["checkpoint"]
    for (_, a), (_, b) in zip(sh.walk(out["live"]), sh.walk(out["restored_4x1"]), strict=True):
        assert torch.equal(a, b)
    # On one card: the gathered checkpoint restores into the one-card state.
    cfg = get_smoke_config("llama3.2-1b")
    opt = topt.make_optimizer(ttrain.default_opt_config(cfg))
    like = ttrain.init_state(cfg, opt, device="cpu")
    like["monitor"] = out["monitor"]
    restored = Checkpointer(runs.root / "ckpt").restore(like)
    for (_, a), (_, b) in zip(sh.walk({k: v for k, v in restored.items() if k != "monitor"}),
                              sh.walk(out["live"]), strict=True):
        assert torch.equal(a, b)
    # The mesh loop's monitor sketch against a one-card loop's (same data).
    monkeypatch.setattr(train_loop.ActivationMonitor, "decode", lambda self, s, seed=None: None)
    loop = train_loop.LoopConfig(steps=2, ckpt_dir=str(tmp_path / "one"), ckpt_every=2, keep=1,
                                 monitor_k=2, log_every=1, dtype=torch.float32)
    one = train_loop.run(cfg, ShapeConfig("t", 32, 4, "train"), None, loop, DataConfig(seed=0),
                         device="cpu")
    for a, b in zip(one["state"]["monitor"], out["monitor"], strict=True):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for h1, h2 in zip(one["history"], out["history"], strict=True):
        assert abs(h1["loss"] - h2["loss"]) <= 1e-5 * abs(h1["loss"])
