"""The port's CUDA kernels on the card (marker ``cuda``).

Each kernel against its plain PyTorch version, and one backward of the
attention layer through the kernels.  This file imports no jax (nor does
anything it imports), so that it runs on a GPU host without the JAX
package: ``python -m pytest --noconftest tests/test_torch_cuda.py -m
cuda``.  Without a card every test skips inside the ``cuda`` fixture.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models import (TransformerLM, from_jax_params,
                                            to_jax_params)
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    MultiHeadSelfAttention)


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,sq,sk,masked", [
    (torch.float32, True, 512, 512, False),
    (torch.float32, False, 200, 777, True),
    (torch.bfloat16, True, 37, 37, False),
])
def test_cuda_kernel_matches_plain(cuda, dtype, causal, sq, sk, masked):
    """The CUDA kernel against its plain version on the card: o within
    1e-4 (f32) or 2e-2 (bf16), lse within 1e-5 (f32) or 1e-4 (bf16)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((8, s, 64), generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    lens = (torch.randint(1, sk + 1, (8,), generator=g, device=cuda).float()
            if masked else None)
    before = _kernels.flash_fwd.launches
    o, lse = _kernels.flash_fwd(q, k, v, lens, causal, 0.125)
    o_ref, lse_ref = tattn.flash_attention_reference(q, k, v, causal, 0.125,
                                                     lens)
    torch.cuda.synchronize()
    assert _kernels.flash_fwd.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    close(o.float().cpu(), o_ref.float().cpu(), rtol=0, atol=tol)
    close(lse.cpu(), lse_ref.cpu(), rtol=0, atol=LSE_TOL[dtype])


#: the forward's lse, which both backward kernels replay p from
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [72, 128, 256])
def test_cuda_forward_matches_plain_at_wide_heads(cuda, dtype, d):
    """The forward kernel at head dims past 64 (d = 256 is its widest
    instantiation), cross causal with lengths: o within 1e-4 (f32) or
    2e-2 (bf16), lse within 1e-5 (f32) or 1e-4 (bf16)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((8, 129, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((8, 300, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    lens = torch.randint(1, 301, (8,), generator=g, device=cuda).float()
    o, lse = _kernels.flash_fwd(q, k, v, lens, True, d ** -0.5)
    o_ref, lse_ref = tattn.flash_attention_reference(q, k, v, True,
                                                     d ** -0.5, lens)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    close(o.float().cpu(), o_ref.float().cpu(), rtol=0, atol=tol)
    close(lse.cpu(), lse_ref.cpu(), rtol=0, atol=LSE_TOL[dtype])


@pytest.mark.cuda
def test_cuda_prefill_launches_the_forward_once_a_layer(cuda):
    """generate() with one new token on the card: its prefill runs the
    forward kernel once a layer, and the token equals the one the same
    weights give on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=61, seq_len=64, n_layers=2, d_model=64, n_heads=2)
    gpu = TransformerLM(**cfg, device="cuda", seed=0).eval()
    cpu = TransformerLM(**cfg, device="cpu", seed=1).eval()
    from_jax_params(cpu, to_jax_params(gpu))
    prompt = np.random.default_rng(0).integers(0, 61, (2, 40))
    before = _kernels.flash_fwd.launches
    out = gpu.generate(prompt, 1)
    assert _kernels.flash_fwd.launches - before == cfg["n_layers"]
    assert out.shape == (2, 41) and (out[:, :40] == prompt).all()
    assert (out == cpu.generate(prompt, 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,sq,sk,masked", [
    (torch.float32, True, 512, 512, False),
    (torch.float32, False, 200, 777, True),
    (torch.float32, True, 192, 512, False),
    (torch.bfloat16, True, 37, 37, False),
])
def test_cuda_backward_kernels_match_plain(cuda, dtype, causal, sq, sk,
                                          masked):
    """Each backward kernel against its plain version on the card: dq, dk
    and dv within max|diff| / max|ref| <= 1e-4 (f32) or 2e-2 (bf16)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, do = (torch.randn((8, sq, 64), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((8, sk, 64), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    lens = (torch.randint(1, sk + 1, (8,), generator=g, device=cuda).float()
            if masked else None)
    o, lse = _kernels.flash_fwd(q, k, v, lens, causal, 0.125)
    delta = tattn._flash_delta(o, do)
    args = (q, k, v, do, lse, delta, lens, causal, 0.125)
    got = (_kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args))
    ref = (tattn.flash_bwd_dq_reference(*args),
           *tattn.flash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, ref):
        err = float((a.double() - r.double()).abs().max()
                    / r.double().abs().max())
        assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d_model", [384, 512])
def test_cuda_auto_attention_at_wide_head_dims(cuda, d_model):
    """head_dim 192 and 256 (2 heads): ``"auto"`` runs the layer's forward
    and backward through the kernels on the card, one launch of each, and
    its output and gradients match the same weights on the CPU (max|diff|
    / max|ref| <= 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = {dev: MultiHeadSelfAttention(d_model, 2, device=dev)
              for dev in ("cpu", "cuda")}
    with torch.no_grad():
        for key, p in layers["cuda"].params().items():
            p.copy_(layers["cpu"].params()[key])
    x = torch.randn((2, 40, d_model),
                    generator=torch.Generator().manual_seed(0))
    before = _kernels.launch_counts()
    results = {}
    for dev, layer in layers.items():
        out = layer(x.to(dev))
        out.square().sum().backward()
        results[dev] = [out.detach()] + [
            layer.params()[w].grad for w in ("Wq", "Wk", "Wv", "Wo")]
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    for got, ref in zip(results["cuda"], results["cpu"]):
        err = float((got.cpu().double() - ref.double()).abs().max()
                    / ref.double().abs().max())
        assert err <= 1e-4


@pytest.mark.cuda
def test_cuda_attention_weights_get_gradients(cuda):
    """One backward through the flash path on the card reaches Wq/Wk/Wv,
    through both backward kernels."""
    layer = MultiHeadSelfAttention(64, 4, implementation="flash",
                                   device="cuda")
    x = torch.randn((2, 96, 64), device=cuda)
    before = _kernels.launch_counts()
    layer(x).square().sum().backward()
    after = _kernels.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    for w in ("Wq", "Wk", "Wv"):
        grad = getattr(layer, w).grad
        assert grad is not None and bool(torch.isfinite(grad).all())
        assert float(grad.abs().max()) > 0
