"""The port's examples (``repro_torch.examples``), run on the CPU through
their ``main(argv)`` at small sizes: their output lines, the relative SSE of
CKM against Lloyd-Max x5, the one-rank process group of ``full_pipeline
--backend sharded`` (the kernel backend's sketch and decode),
``serve_fleet``'s placement, shard routing and bitwise evict/restore, and
``serve_kv_ckm``'s compressed-cache fidelity."""

import re

import pytest
import torch
import torch.distributed as dist

from repro_torch.examples import full_pipeline, quickstart, serve_fleet, serve_kv_ckm

pytestmark = pytest.mark.torch_port

MAX_RELATIVE_SSE = 1.5  # chip_smoke's bar: catches a broken port, not seed spread
_OUT: dict = {}


def _run(capsys, module, *argv):
    key = (module.__name__, argv)
    if key not in _OUT:
        module.main([*argv, "--device", "cpu"])
        _OUT[key] = capsys.readouterr().out.splitlines()
    return _OUT[key]


def _number(lines, pattern):
    found = [m for line in lines for m in [re.search(pattern, line)] if m]
    assert len(found) == 1, (pattern, lines)
    return float(found[0].group(1))


def test_quickstart(capsys):
    lines = _run(capsys, quickstart, "--n", "5000")
    assert lines[0] == "sketch size m = 480 (vs 30000 dataset scalars)"
    ckm_sse = _number(lines, r"^CKM    SSE/N = ([\d.]+)$")
    lloyd_sse = _number(lines, r"^Lloyd5 SSE/N = ([\d.]+)$")
    assert ckm_sse / lloyd_sse <= MAX_RELATIVE_SSE
    alphas = re.findall(r"'([\d.]+)'", lines[-1])
    assert lines[-1].startswith("mixture weights alpha: ") and len(alphas) == 8
    assert abs(sum(float(a) for a in alphas) - 1.0) < 0.01


PIPELINE = ("--n", "20000", "--k", "3", "--dim", "4")


def _pipeline_lines(lines):
    for tag in ("[1] sketch (", "[2] clompr decode", "[3] Lloyd-Max x5", "[4] relative SSE"):
        assert sum(line.startswith(tag) for line in lines) == 1, (tag, lines)
    assert "m=120, one pass" in lines[[i for i, line in enumerate(lines)
                                       if line.startswith("[1]")][0]]
    assert _number(lines, r"^\[4\] relative SSE ([\d.]+);") <= MAX_RELATIVE_SSE


def test_full_pipeline_kernel_backend(capsys):
    lines = _run(capsys, full_pipeline, *PIPELINE, "--backend", "kernel")
    _pipeline_lines(lines)
    assert "backend=kernel topology=allreduce" in lines[0]
    assert not any(line.startswith("[0]") for line in lines)


def test_full_pipeline_sharded_as_one_gloo_rank(capsys):
    """Launched alone, the sharded backend makes a one-rank gloo group over a
    ("data",) mesh, destroys it after, and decodes the kernel backend's
    sketch: the same SSE/N."""
    lines = _run(capsys, full_pipeline, *PIPELINE, "--backend", "sharded",
                 "--stream-chunk", "5000")
    assert lines[0] == ("[0] launched alone: made a one-rank gloo process group over a "
                        "('data',) mesh")
    assert lines[1] == "[0] mesh: ('data',) of 1 rank(s), gloo on cpu"
    _pipeline_lines(lines)
    assert not dist.is_initialized()
    assert sum(line.startswith("[2b] streaming fit (5000-pt chunks)") for line in lines) == 1
    kernel = _run(capsys, full_pipeline, *PIPELINE, "--backend", "kernel")
    pattern = r"^\[2\] clompr decode .*SSE/N=([\d.]+)$"
    assert _number(lines, pattern) == _number(kernel, pattern)


def test_serve_fleet_over_a_tenant_mesh(capsys):
    lines = _run(capsys, serve_fleet, "--tenants", "8", "--shards", "4", "--requests", "40")
    assert lines[0] == ("placement: shard 0 -> cpu, shard 1 -> cpu, shard 2 -> cpu, "
                        "shard 3 -> cpu")
    assert "shards=4x2rows(axis='tenant'), devices=[cpu, cpu, cpu, cpu])" in lines[1]
    assert lines[1].endswith("on 1 device(s)")
    assert any(line.startswith("served 40 requests (10240 points)") for line in lines)
    shard = [re.match(r"  shard (\d): tenants \[(\d+), (\d+)\) on cpu \| (\d+) requests", line)
             for line in lines]
    shard = [m for m in shard if m]
    assert [int(m.group(1)) for m in shard] == [0, 1, 2, 3]
    assert [(int(m.group(2)), int(m.group(3))) for m in shard] == [(0, 2), (2, 4), (4, 6),
                                                                   (6, 8)]
    assert sum(int(m.group(4)) for m in shard) == 40
    decodes = [line for line in lines if re.match(r"tenant [012]: ", line)]
    assert [("hit" in line) for line in decodes] == [False, False, False, True, True, True]
    assert any(re.match(r"tenant 3: evicted -> restored bitwise=True, decode cost=", line)
               for line in lines)
    assert re.match(r"requests=40 points=10240 flushes=\d+ decodes=7 hit_rate=0.43 "
                    r"evictions=1 restores=1$", lines[-1])


def test_serve_fleet_unsharded(capsys):
    lines = _run(capsys, serve_fleet, "--tenants", "8", "--requests", "16")
    assert not any(line.startswith("placement") for line in lines)
    assert "device='cpu'" in lines[0] and "shards=" not in lines[0]
    assert any("restored bitwise=True" in line for line in lines)
    assert lines[-1].startswith("requests=16 points=4096 ")


def test_serve_fleet_placement():
    """``--devices N`` spreads the blocks in contiguous runs; the CPU is one
    device; more devices than blocks is refused."""
    import torch

    cpu = torch.device("cpu")
    assert serve_fleet.placement(4, 0, "cpu") == [cpu] * 4
    assert serve_fleet.placement(4, 1, "cpu") == [cpu] * 4
    with pytest.raises(ValueError, match="the CPU is one device"):
        serve_fleet.placement(4, 2, "cpu")
    with pytest.raises(ValueError, match=r"--devices must lie in \[0, --shards=2\]"):
        serve_fleet.placement(2, 3, "cpu")


def test_serve_kv_ckm(capsys, monkeypatch):
    """The reference's lines for both clusterers on the random model's keys
    and on planted clusters, at a shorter prompt and fewer centroids (the
    example's K = 64 takes minutes of CKM on the CPU); the clustered regime
    under ``tests/test_kv_clustering.py``'s 0.15 bar."""
    for name, value in (("S_PROMPT", 256), ("N_CENTROIDS", 8), ("RING", 16)):
        monkeypatch.setattr(serve_kv_ckm, name, value)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # CLOMPR's tiny CPU ops: see test_torch_kv_clustering
    try:
        lines = _run(capsys, serve_kv_ckm)
    finally:
        torch.set_num_threads(threads)
    for method in ("lloyd", "ckm"):
        pad = f"{method:6s}"
        rel = _number(lines, rf"^random-init KV  {pad}: rel err ([\d.]+) \(10\.7x smaller "
                             r"cache; random-init keys have no cluster structure — worst case\)$")
        assert 0.0 <= rel
        rel = _number(lines, rf"^clustered KV    {pad}: rel err ([\d.]+) "
                             r"\(pretrained-cache regime\)$")
        assert rel < 0.15, (method, rel)
    assert lines[-1].startswith("note: for LOCAL offline compression Lloyd is the right")
