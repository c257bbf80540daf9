"""The port's flash attention (kernel 8) against the reference, on the CPU.

The same numpy inputs go through the reference's ``ops.flash_attention``
(its Pallas kernel in interpret mode) and the port's ``ops.flash_attention``
(on CPU tensors, the kernel's plain version): the reference suite's five
shapes and its bf16 case, the LSE against the reference kernel's second
output, a row with no key, the reference's refusal of a non-causal ragged
S_kv, and the model's attention (``repro.models.layers``) through the
port's entry point.  Bars: 1e-5 in float32 (output and LSE); the reference
test's own bars at bf16 and for the model check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

pytestmark = pytest.mark.torch_port

F32_TOL = 1e-5


def _qkv(seed, b, s_q, s_kv, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s_q, h, hd)).astype(np.float32),
        rng.standard_normal((b, s_kv, kv, hd)).astype(np.float32),
        rng.standard_normal((b, s_kv, kv, hd)).astype(np.float32),
    )


def _flat(x):
    """(B, S, H, hd) -> (B*H, S, hd), as both entry points flatten heads."""
    b, s, h, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd))


# tests/test_kernels.py::TestFlashAttentionKernel::test_matches_ref's shapes.
SHAPES = [
    (1, 128, 4, 4, 32, True, 0),     # MHA causal
    (2, 128, 4, 2, 32, True, 0),     # GQA rep=2
    (1, 256, 4, 1, 32, True, 64),    # MQA + sliding window
    (1, 96, 2, 2, 16, True, 0),      # ragged seq (padding path)
    (1, 128, 2, 2, 32, False, 0),    # non-causal (encoder)
]


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", SHAPES)
def test_entry_point_matches_reference(b, s, h, kv, hd, causal, window):
    q, k, v = _qkv(0, b, s, s, h, kv, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        block_q=64, block_k=64, interpret=True,
    ))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=causal, window=window)
    assert got.shape == (b, s, h * hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", SHAPES)
def test_lse_matches_reference_kernel(b, s, h, kv, hd, causal, window):
    q, k, v = (_flat(t) for t in _qkv(1, b, s, s, h, kv, hd))
    rep = h // kv
    # Blocks of 32 divide every S here, so the reference kernel needs no pad.
    o_ref, lse_ref = jfa.flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rep=rep, causal=causal,
        window=window, block_q=32, block_k=32, interpret=True,
    )
    o, lse = tfa.flash_attention_kernel(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), rep, causal, window)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=F32_TOL)


def test_bf16_matches_reference():
    q, k, v = _qkv(2, 1, 128, 128, 2, 2, 32)
    want = jops.flash_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), block_q=64, block_k=64,
        interpret=True,
    )
    got = tops.flash_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               atol=3e-2, rtol=3e-2)


def test_rows_with_no_key_take_the_mean_of_v():
    """Causal with a window and S_q > S_kv: rows i >= S_kv + window - 1 see
    no key.  As in the reference, they end with the mean of V over all S_kv
    keys and an LSE of -1e30 (+ log S_kv, below float32's resolution)."""
    s_q, s_kv, window = 96, 64, 16
    q, k, v = _qkv(3, 1, s_q, s_kv, 2, 1, 16)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        interpret=True,
    ))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    _, lse_ref = jfa.flash_attention_kernel(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), rep=2, causal=True,
        window=window, block_q=32, block_k=32, interpret=True,
    )
    o, lse = tfa.flash_attention_kernel(torch.from_numpy(qf), torch.from_numpy(kf),
                                        torch.from_numpy(vf), 2, True, window)
    keyless = slice(s_kv + window - 1, s_q)
    assert np.all(np.asarray(lse_ref)[:, keyless] == -1e30)
    assert torch.all(lse[:, keyless] == -1e30)
    mean_v = vf.mean(axis=1)  # (BKV, hd); both q heads read kv head 0
    np.testing.assert_allclose(o[:, keyless].numpy(), np.broadcast_to(
        mean_v[:, None], (2, s_q - keyless.start, 16)), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=F32_TOL)


def test_non_causal_ragged_kv_is_refused_as_the_reference_refuses_it():
    q, k, v = _qkv(4, 1, 96, 96, 2, 2, 16)
    with pytest.raises(AssertionError, match="causal"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                             interpret=True)
    with pytest.raises(ValueError, match="causal"):
        tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=False)
    # Whole blocks (128 = one block) pass in both.
    q, k, v = _qkv(4, 1, 128, 128, 2, 2, 16)
    tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         causal=False)


def test_matches_model_attention():
    """The reference model's q, k, v (post-rope) through the port's entry
    point, times ``wo``, against ``layers.attention_apply``."""
    import jax

    from repro.models import layers as L

    dims = L.AttnDims(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, q_block=32)
    params = L.init_attention(jax.random.PRNGKey(0), dims)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 64), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(64), (2, 64))
    want = np.asarray(L.attention_apply(params, dims, x, pos))
    q, k, v = (torch.from_numpy(np.array(t)) for t in L._qkv(params, dims, x, pos))
    got = tops.flash_attention(q, k, v, causal=True) @ torch.from_numpy(np.asarray(params["wo"]))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-2)


def test_chunked_plain_version_matches_the_whole():
    q, k, v = (torch.from_numpy(_flat(t)) for t in _qkv(5, 1, 200, 200, 4, 2, 24))
    whole = tfa.flash_attention_plain(q, k, v, 2, True, 40)
    for chunk in (7, 64, 200):
        part = tfa.flash_attention_plain(q, k, v, 2, True, 40, q_chunk=chunk)
        for a, b in zip(part, whole):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad,err", [
    (dict(hd=12), ValueError),       # not a multiple of 8
    (dict(hd=264), ValueError),      # wider than 256
    (dict(rep=3), ValueError),       # BKV * rep != BH
    (dict(window=-1), ValueError),
    (dict(dtype=torch.float64), TypeError),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    hd, rep, dtype = bad.get("hd", 16), bad.get("rep", 2), bad.get("dtype", torch.float32)
    q = torch.zeros((4, 8, hd), dtype=dtype)
    k = torch.zeros((2, 8, hd), dtype=dtype)
    with pytest.raises(err):
        tfa.flash_attention_kernel(q, k, k, rep, True, bad.get("window", 0))


def test_kernel_wrapper_takes_a_non_cpu_tensor_to_the_kernel_or_raises():
    """Only CPU tensors reach the plain version; anything else must pass the
    CUDA checks, and a meta tensor fails them."""
    q = torch.zeros((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_kernel(q, q, q, 1, True, 0)
    with pytest.raises(ValueError, match="device meta"):
        tops.flash_attention(q[None].transpose(1, 2), q[None].transpose(1, 2),
                             q[None].transpose(1, 2))


# The chip bar for bf16 outputs (chip_smoke.py's FLASH_BF16_*) and the LSE.
BF16_RTOL, BF16_ATOL, LSE_TOL = 2.0**-7, 1e-4, 1e-5


def _tensor_core_model(q, k, v, rep, causal, window, block_k=64):
    """The bf16 kernel's arithmetic (``csrc/flash_attention.cu``,
    ``flash_fwd_tc``) in torch, on flattened bf16 ``q (BH, S_q, hd)`` and
    ``k, v (BKV, S_kv, hd)``: S from the raw bf16 q and k accumulated in f32,
    then scaled; the online softmax over tiles of ``block_k`` keys in f32;
    P split into hi = bf16(P) and lo = bf16(P - hi), both multiplied by the
    bf16 V into one f32 O; l summed from the f32 P.  Returns (o bf16, lse)."""
    bh, s_q, hd = q.shape
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(rep, dim=0) for t in (k, v))
    scale = torch.tensor(1.0 / hd**0.5, dtype=torch.float32)
    m = torch.full((bh, s_q), -1e30)
    l = torch.zeros((bh, s_q))
    o = torch.zeros((bh, s_q, hd))
    qpos = torch.arange(s_q)[:, None]
    for k0 in range(0, kf.shape[1], block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = (qf @ kt.transpose(1, 2)) * scale
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        mask = torch.ones((s_q, kt.shape[1]), dtype=torch.bool)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= (qpos - kpos) < window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + hi @ vt + lo @ vt
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return (o / l_safe[..., None]).to(torch.bfloat16), m + torch.log(l_safe)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [
    (1, 128, 4, 4, 64, True, 0),     # MHA causal: rows 0.. see 1.. keys
    (1, 128, 4, 1, 72, True, 0),     # GQA rep=4, hd not a multiple of 16
    (2, 192, 4, 2, 64, True, 0),     # GQA rep=2, three kv tiles
    (1, 256, 2, 1, 64, True, 48),    # MQA + sliding window
    (1, 128, 2, 2, 72, True, 40),    # window, hd 72
    (1, 128, 4, 2, 64, False, 0),    # non-causal
    (1, 128, 2, 1, 72, False, 0),    # non-causal, hd 72
])
def test_tensor_core_rounding_model_meets_the_chip_bar(b, s, h, kv, hd, causal, window):
    """The bf16 kernel's rounding (P split into bf16 hi and lo, f32 sums)
    against the reference's entry point and kernel in interpret mode on the
    same bf16 inputs: o within the chip's bar 2^-7 |o| + 1e-4, the LSE within
    1e-5.  The kernel itself is held to its plain version on the card."""
    q, k, v = (t.astype(jnp.bfloat16) for t in _qkv(6, b, s, s, h, kv, hd))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        block_q=64, block_k=64, interpret=True,
    ).astype(jnp.float32))
    qf, kf, vf = (torch.from_numpy(_flat(np.asarray(t, np.float32))).to(torch.bfloat16)
                  for t in (q, k, v))
    o, lse = _tensor_core_model(qf, kf, vf, h // kv, causal, window)
    got = o.float().reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd).numpy()
    used = np.abs(got - want) / (BF16_RTOL * np.abs(want) + BF16_ATOL)
    assert used.max() <= 1.0, used.max()
    _, lse_ref = jfa.flash_attention_kernel(
        *(jnp.asarray(_flat(np.asarray(t, np.float32)), jnp.bfloat16) for t in (q, k, v)),
        rep=h // kv, causal=causal, window=window, block_q=32, block_k=32, interpret=True,
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=LSE_TOL)
