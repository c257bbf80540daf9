"""The port's roofline accounting (``repro_torch.utils.roofline``) against
the reference's: the frequency-operator model and the model-flop counts
equal, and the roofline terms of counted costs at the H100's peaks."""

import pytest

from repro.utils import roofline as jrl
from repro_torch.utils import hlo
from repro_torch.utils import roofline as rl

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("args", [(1000, 10, 2000, 16, 125), (1 << 20, 784, 16384, 1024, 16),
                                  (3, 1, 5, 1, 5), (50_000, 3000, 32768, 4096, 8)])
def test_freq_transform_model_matches_the_reference(args):
    assert rl.freq_transform_model(*args) == jrl.freq_transform_model(*args)


@pytest.mark.parametrize("n,t", [(1_235_814_400, 256 * 4096), (3, 7), (10 ** 12, 1)])
def test_model_flops_match_the_reference(n, t):
    assert rl.train_model_flops(n, t) == jrl.train_model_flops(n, t)
    assert rl.decode_model_flops(n, t) == jrl.decode_model_flops(n, t)


def test_the_card_constants():
    """The H100 SXM's peaks, not the v5e's."""
    assert (rl.PEAK_FLOPS, rl.PEAK_FP32_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 67e12, 3.35e12,
                                                                         50e9)


def test_roofline_terms_of_counted_costs():
    c = hlo.Costs(flops=989e9, bytes=6.7e9)
    c.coll_by_op["all-reduce"] += 1e8
    c.coll_by_op["all-gather"] += 5e7
    c.coll_count["all-reduce"] += 3
    r = rl.analyze(c, chips=256, model_flops=0.5 * 989e9 * 256)
    assert r.compute_s == pytest.approx(1e-3) and r.memory_s == pytest.approx(2e-3)
    assert r.collective_s == pytest.approx(3e-3) and r.collective_bytes == 1.5e8
    assert r.dominant == "collective" and r.bound_step_time() == r.collective_s
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.roofline_fraction() == pytest.approx(0.5e-3 / 3e-3)
    assert rl.analyze(hlo.Costs(), 1, 0.0).useful_ratio == 0.0
