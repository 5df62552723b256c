"""The port's CUDA kernels on the card (marker ``cuda``).

Each kernel against its plain PyTorch version, one backward of the
attention layer through the kernels, LeNet (a Sequential of
Convolution2D, MaxPooling2D, Flatten, Dense) fitting, predicting, saved
and loaded on the card, BatchNorm's closed form and one ResNet-50
training step against the CPU, and the serving plane: the decode
engine's CUDA graphs, its admissions' kernel launches, coalesced
predict, and the engine's and coalescer's streams waiting for the
caller's writes; the kernels' sums over a long walk of keys that share
a large mean against exact attention; recurrent layers against the CPU,
the Switch-MoE index dispatch against its dense form, a MoE model's
captured decode step against the eager one, and a MoE training step
through the kernels; the int8 products (``torch._int_mm`` at the shapes
it refuses unpadded) and convolutions against the CPU's accumulators,
the quantize passes and eval BatchNorm bit for bit against the CPU, the
native decode, and ``predict_image_set`` against the CPU; the
BatchNorm debias bit for bit, and Deconvolution2D (same, stride 2) and
ResizeBilinear (shrinking) against the CPU; an asynchronous snapshot
holding the weights of its step after the next in-place step, remat
through the flash kernels giving the non-remat gradients, a corrupt
snapshot tag falling back on the card, and a world of one over NCCL
training under fsdp bit for bit with the plain Trainer; two replicas of
one model on one card (each on its own stream) giving the model's own
bits, and the weight pager returning a paged-out model's bytes; a
sharded group of two on one card giving the single-device bits, a
sharded load holding only the groups' blocks on the card, a function
without its module gathering its whole tree a dispatch where a module
gathers a layer, and a kernel-library store hit in a second process
running no nvcc; a fleet of two worker processes on one card replaying
the single-process registry's tokens, its first activation the only one
that runs nvcc, and a SIGKILLed worker's replay running none; a fit from
a ``from_batch_iterable`` stream launching each kernel once a layer and
step and giving the in-memory fit's bits, an ONNX model and a GraphDef
(built by the port's codecs) predicting on the card as on the CPU, an
``OnnxNet`` keeping no parameter on the CPU; and the zoolint sanitizer's
guard (``set_sync_debug_mode("error")``) catching an injected ``.item()``
and ``.cpu()`` and restoring the mode, passing the explicit fetch, a
warmed replicated predict with the bits of a blocking fetch, and a
warmed decode engine's admissions and steps. This file
imports no jax (nor does anything it imports), so that it runs on a
GPU host without the JAX package: ``python -m pytest --noconftest
tests/test_torch_cuda.py -m cuda``. Without a card every test skips
inside the ``cuda`` fixture.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (nhwc_graph_def, recorded, resnet_stage1_onnx,
                        stream_factory, unmatched_detections, write_png)
from analytics_zoo_tpu_torch.models import (ImageClassifier, NeuralCF,
                                            ObjectDetector, TransformerLM,
                                            decode_output, from_jax_params,
                                            to_jax_params, to_jax_state)
from analytics_zoo_tpu_torch.models.image.detection import ssd_priors
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import batchnorm as tbn
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential, load_model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    BatchNormalization, Convolution2D, Deconvolution2D, Dense, Dropout,
    Flatten, MaxPooling2D, MultiHeadSelfAttention, ResizeBilinear)
from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def rel_err(got, ref, base=None):
    """max |got - ref| over max |ref - base| across two JAX-keyed trees
    ({layer: {name: array}}) of the same keys."""
    num = max(float(np.abs(got[n][k] - ref[n][k]).max())
              for n in ref for k in ref[n])
    den = max(float(np.abs(ref[n][k] - (0 if base is None
                                        else base[n][k])).max())
              for n in ref for k in ref[n])
    return num / den


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def design_key(dtype, design):
    return (f"flash_fwd[{'f32' if dtype == torch.float32 else 'bf16'},"
            f"{design}]")


def forward_checked(q, k, v, lens, causal, scale, design=None):
    """One flash_fwd launch held to its plain version: o within 1e-4
    (f32) or 2e-2 (bf16), lse within LSE_TOL.  Returns (o, lse, the
    design that ran, read from the counts by design)."""
    before = _kernels.launch_counts_by_design()
    launches = _kernels.flash_fwd.launches
    o, lse = _kernels.flash_fwd._run(design, q, k, v, lens, causal, scale)
    o_ref, lse_ref = tattn.flash_attention_reference(q, k, v, causal, scale,
                                                     lens)
    torch.cuda.synchronize()
    after = _kernels.launch_counts_by_design()
    ran = [key for key in after if after[key] == before[key] + 1]
    assert len(ran) == 1 and _kernels.flash_fwd.launches == launches + 1
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    close(o.float().cpu(), o_ref.float().cpu(), rtol=0, atol=tol)
    close(lse.cpu(), lse_ref.cpu(), rtol=0, atol=LSE_TOL[q.dtype])
    return o, lse, ran[0]


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["sm90", "base"])
@pytest.mark.parametrize("dtype,causal,sq,sk,masked", [
    (torch.float32, True, 512, 512, False),
    (torch.float32, False, 200, 777, True),
    (torch.bfloat16, True, 37, 37, False),
])
def test_cuda_kernel_matches_plain(cuda, dtype, causal, sq, sk, masked,
                                   design):
    """The CUDA kernel, at each design of the forward, against its plain
    version on the card: o within 1e-4 (f32) or 2e-2 (bf16), lse within
    1e-5 (f32) or 1e-4 (bf16); the counts by design show which ran."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((8, s, 64), generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    lens = (torch.randint(1, sk + 1, (8,), generator=g, device=cuda).float()
            if masked else None)
    _, _, ran = forward_checked(q, k, v, lens, causal, 0.125, design)
    assert ran == design_key(dtype, design)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,sq,sk,lens_at", [
    # lengths no multiple of the 64- and 128-row tiles
    (torch.float32, True, 200, 200, None),
    (torch.bfloat16, False, 130, 333, None),
    (torch.bfloat16, True, 255, 255, None),
    # lengths that cut a key tile, and whole tiles past them
    (torch.bfloat16, False, 256, 300, (1, 63, 64, 65, 127, 129, 200, 300)),
    (torch.float32, False, 96, 257, (2, 31, 32, 33, 64, 97, 128, 257)),
    # cross causal: sk != sq
    (torch.float32, True, 63, 129, None),
    (torch.bfloat16, True, 100, 700, (700, 650, 600, 500, 400, 300, 200,
                                      100)),
    (torch.float32, True, 1, 300, None),
])
def test_cuda_forward_sm90_at_tma_edges(cuda, dtype, causal, sq, sk,
                                        lens_at):
    """The sm90 forward where TMA's zero fill replaces the edge masking:
    ragged query and key lengths, lengths cutting a tile, cross causal;
    within its tolerances and chosen by the design rule (d = 64)."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q, k, v = (torch.randn((8, s, 64), generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    lens = (None if lens_at is None else
            torch.tensor(lens_at, dtype=torch.float32, device=cuda))
    _, _, ran = forward_checked(q, k, v, lens, causal, 0.125)
    assert ran == design_key(dtype, "sm90")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_design_follows_the_base_pointer(cuda, dtype):
    """Inputs that start one row into a buffer keep 16-byte-aligned bases
    at d = 64 and run sm90; one element in, they run the baseline; both
    within the tolerances."""
    g = torch.Generator(device=cuda).manual_seed(1)
    bh, s, d = 8, 130, 64
    flat = [torch.randn(bh * s * d + d, generator=g, device=cuda).to(dtype)
            for _ in range(3)]
    for offset, design in ((d, "sm90"), (1, "base")):
        q, k, v = (t[offset:offset + bh * s * d].view(bh, s, d)
                   for t in flat)
        _, _, ran = forward_checked(q, k, v, None, True, d ** -0.5)
        assert ran == design_key(dtype, design)
    with pytest.raises(ValueError, match="does not take"):
        _kernels.flash_fwd._run("sm90", q, k, v, None, True, d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("design", ["sm90", "base"])
def test_cuda_forward_launches_agree_bit_for_bit(cuda, dtype, design):
    """Two launches of the forward on the same inputs give the same o and
    lse bit for bit (no split over keys, no atomics), at a training-like
    shape with lengths."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((24, 1024, 64), generator=g,
                           device=cuda).to(dtype) for _ in range(3))
    lens = torch.randint(1, 1025, (24,), generator=g, device=cuda).float()
    first = _kernels.flash_fwd._run(design, q, k, v, lens, True, 0.125)
    second = _kernels.flash_fwd._run(design, q, k, v, lens, True, 0.125)
    torch.cuda.synchronize()
    assert all(map(torch.equal, first, second))


#: the forward's lse, which both backward kernels replay p from
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# parameters over the largest change of 3 adam steps; the card read
# 4.6e-4 here (H100 80GB HBM3, 700 W)
NCF_TOL = 1e-3


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


def backward_inputs(dtype, bh, sq, sk, d, causal, lens_max, seed=0):
    """Seeded q, k, v, do (and lens up to ``lens_max``, or None) on the
    card, the forward's lse and o, and the backward's arguments."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((bh, sq, d), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bh, sk, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lens = (None if lens_max is None else torch.randint(
        1, lens_max + 1, (bh,), generator=g, device="cuda").float())
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(q, k, v, lens, causal, scale)
    delta = tattn._flash_delta(o, do)
    return (q, k, v, do, lse, delta, lens, causal, scale)


def backward_checked(args, design=None):
    """Both backward kernels at ``design`` (None: ``bwd_design``'s) held
    to their plain versions: dq, dk and dv within max|diff| / max|ref| <=
    1e-4 (f32) or 2e-2 (bf16), a second launch bit-equal to the first,
    dk = dv = 0 exactly past every length.  Returns the design that ran,
    read from the counts by design."""
    q, k, lens = args[0], args[1], args[6]
    before = _kernels.launch_counts_by_design()
    got = (_kernels.flash_bwd_dq._run(design, *args),
           *_kernels.flash_bwd_dkv._run(design, *args))
    again = (_kernels.flash_bwd_dq._run(design, *args),
             *_kernels.flash_bwd_dkv._run(design, *args))
    ref = (tattn.flash_bwd_dq_reference(*args),
           *tattn.flash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    after = _kernels.launch_counts_by_design()
    ran = {key.split("[")[1] for key in after if after[key] != before[key]}
    assert len(ran) == 1
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        err = float((a.double() - r.double()).abs().max()
                    / r.double().abs().max())
        assert err <= tol
    if lens is not None:
        past = (torch.arange(k.shape[1], device=k.device)[None, :]
                >= lens[:, None])[..., None]
        for a in got[1:]:
            assert bool((a.masked_select(past) == 0).all())
    return ran.pop().rstrip("]").split(",")[1]


def rule_design(dtype, d):
    """The backward's design for contiguous, aligned tensors: sm90 on rows
    of 16-byte multiples up to d = 128 at bf16 and d = 64 at f32."""
    item = 4 if dtype == torch.float32 else 2
    widest = 64 if dtype == torch.float32 else 128
    return "sm90" if d <= widest and (d * item) % 16 == 0 else "base"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,sq,sk,d,lens_max,design", [
    (torch.float32, True, 512, 512, 64, None, None),
    (torch.float32, False, 200, 777, 64, 777, None),
    (torch.float32, True, 192, 512, 64, None, None),
    (torch.float32, True, 129, 300, 96, None, None),
    (torch.bfloat16, True, 37, 37, 64, None, None),
    # at the sm90 design's TMA edges, at both designs: lengths no multiple
    # of the tiles, sk > sq causal, lens; d 32, 64, 96 and 128 at bf16,
    # and at f32 (whose widest sm90 head is 64) d 32, 64, 36 (an atom and
    # a few columns) and 20 (rows of 80 bytes)
    *[(dtype, causal, sq, sk, d, lens_max, design)
      for dtype, wide, widest in ((torch.bfloat16, 96, 128),
                                  (torch.float32, 36, 20))
      for causal, sq, sk, d, lens_max in (
          (True, 65, 127, 64, 127),
          (False, 200, 333, 32, 333),
          (True, 129, 300, wide, None),
          (True, 63, 129, widest, 129),
          (False, 256, 300, 64, 300),
          (True, 1, 300, 64, None),
          (True, 1000, 1000, 64, 1000))
      for design in ("sm90", "base")],
])
def test_cuda_backward_kernels_match_plain(cuda, dtype, causal, sq, sk, d,
                                          lens_max, design):
    """Each backward kernel against its plain version on the card, at the
    design the rule picks (None) or a forced one: dq, dk and dv within
    max|diff| / max|ref| <= 1e-4 (f32) or 2e-2 (bf16), a second launch
    of each equal bit for bit, dk = dv = 0 past every length; the rule
    runs sm90 up to d = 128 at bf16 and d = 64 at f32, the baseline past
    them."""
    args = backward_inputs(dtype, 8, sq, sk, d, causal, lens_max)
    ran = backward_checked(args, design)
    want = design or rule_design(dtype, d)
    assert ran == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 6),
                                     (torch.float32, 72),
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 20)])
def test_cuda_forced_sm90_backward_refuses_what_it_does_not_take(cuda,
                                                                 dtype, d):
    """A forced sm90 backward past its widest head (64 at f32, 128 at
    bf16) or on rows of no 16-byte multiple (d = 6 at f32, 20 at bf16)
    raises before any launch; the rule runs those on the baseline."""
    args = backward_inputs(dtype, 4, 65, 65, d, True, None)
    launches = dict(_kernels.launch_counts())
    for kern in (_kernels.flash_bwd_dq, _kernels.flash_bwd_dkv):
        with pytest.raises(ValueError, match="does not take"):
            kern._run("sm90", *args)
    assert _kernels.launch_counts() == launches
    assert backward_checked(args) == "base"


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["sm90", "base"])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernels_sum_long_walks_without_bias(cuda, d, design):
    """At 2,048 causal keys whose keys and values share a large mean (as
    deep layers' do), the kernels' sums over the walk stay unbiased, with
    the forward at each design and the backward at the rule's (sm90 at
    d = 64, the baseline at 128): o within 5e-6 of exact attention's
    largest entry, dq, dk and dv within 5e-5 of theirs, and dk's sum over
    keys (exactly 0) within 5e-4 of dk's largest entry.  The tensor core
    cuts every sum it writes back towards zero; summed into c over the
    whole walk, those cuts put o ~3e-5 off and dk's key sum ~5e-3 off on
    these inputs."""
    g = torch.Generator(device=cuda).manual_seed(0)
    s, scale = 2048, d ** -0.5

    def draw(mean):
        return (torch.randn((4, s, d), generator=g, device=cuda) * 0.3
                + mean * torch.randn((1, 1, d), generator=g, device=cuda))

    q, k, v, do = draw(0.2), draw(1.0), draw(1.0), draw(0.0)
    before = _kernels.launch_counts_by_design()["flash_fwd[f32," + design
                                                + "]"]
    o, lse = _kernels.flash_fwd._run(design, q, k, v, None, True, scale)
    assert _kernels.launch_counts_by_design()[
        "flash_fwd[f32," + design + "]"] == before + 1
    delta = tattn._flash_delta(o, do)
    args = (q, k, v, do, lse, delta, None, True, scale)
    counts = _kernels.launch_counts_by_design()
    got = (_kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args))
    after = _kernels.launch_counts_by_design()
    bwd = rule_design(torch.float32, d)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        key = f"{name}[f32,{bwd}]"
        assert after[key] == counts[key] + 1
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    sc = torch.einsum("bqd,bkd->bqk", q64, k64) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=cuda).tril()
    o64 = torch.softmax(sc.masked_fill(~causal, -float("inf")), -1) @ v64
    ref = torch.autograd.grad(o64, (q64, k64, v64), do.double())

    def err(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    assert err(o, o64.detach()) <= 5e-6
    for a, b in zip(got, ref):
        assert err(a, b) <= 5e-5
    dk = got[1].double()
    assert float(dk.sum(1).abs().max() / dk.abs().max()) <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_bf16_backward_long_walk_no_worse_than_base(cuda, d):
    """The long-walk inputs above at bf16: the sm90 backward's dq, dk and
    dv error against exact attention (f64 autograd on the same bf16
    inputs) and dk's sum over keys (exactly 0) are at most 1.25x the
    baseline design's on the same inputs, each walk summed in its
    accumulators across 2,048 causal keys."""
    g = torch.Generator(device=cuda).manual_seed(0)
    s, scale = 2048, d ** -0.5

    def draw(mean):
        return (torch.randn((4, s, d), generator=g, device=cuda) * 0.3
                + mean * torch.randn((1, 1, d), generator=g, device=cuda)
                ).to(torch.bfloat16)

    q, k, v, do = draw(0.2), draw(1.0), draw(1.0), draw(0.0)
    o, lse = _kernels.flash_fwd(q, k, v, None, True, scale)
    delta = tattn._flash_delta(o, do)
    args = (q, k, v, do, lse, delta, None, True, scale)
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    sc = torch.einsum("bqd,bkd->bqk", q64, k64) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=cuda).tril()
    o64 = torch.softmax(sc.masked_fill(~causal, -float("inf")), -1) @ v64
    ref = torch.autograd.grad(o64, (q64, k64, v64), do.double())

    def errors(design):
        got = (_kernels.flash_bwd_dq._run(design, *args),
               *_kernels.flash_bwd_dkv._run(design, *args))
        errs = [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]
        dk = got[1].double()
        return errs + [float(dk.sum(1).abs().max() / dk.abs().max())]

    sm90, base = errors("sm90"), errors("base")
    for a, b in zip(sm90, base):
        assert a <= 1.25 * b


@pytest.mark.cuda
@pytest.mark.parametrize("d_model", [384, 512])
def test_cuda_auto_attention_at_wide_head_dims(cuda, d_model):
    """head_dim 192 and 256 (2 heads): ``"auto"`` runs the layer's forward
    and backward through the kernels on the card, one launch of each, and
    its output and gradients match the same weights on the CPU (max|diff|
    / max|ref| <= 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = {dev: MultiHeadSelfAttention(2, input_shape=(40, d_model),
                                          device=dev)
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
    layer = MultiHeadSelfAttention(4, implementation="flash",
                                   input_shape=(96, 64), device="cuda")
    x = torch.randn((2, 96, 64), device=cuda)
    before = _kernels.launch_counts()
    layer(x).square().sum().backward()
    after = _kernels.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    for w in ("Wq", "Wk", "Wv"):
        grad = getattr(layer, w).grad
        assert grad is not None and bool(torch.isfinite(grad).all())
        assert float(grad.abs().max()) > 0


def make_blobs(n, classes=10, seed=0):
    """tests/test_lenet_e2e.py's synthetic 28x28 class blobs."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    for i in range(n):
        x[i, 2 * y[i]:2 * y[i] + 3, 2 * y[i]:2 * y[i] + 3, 0] += 2.0
    return x, y.astype(np.int32)


def lenet(device, seed=0):
    """tests/test_lenet_e2e.py's LeNet on ``device``."""
    model = Sequential(device=device, seed=seed)
    model.add(Convolution2D(6, 5, 5, activation="relu", border_mode="same",
                            input_shape=(28, 28, 1)))
    model.add(MaxPooling2D())
    model.add(Convolution2D(16, 5, 5, activation="relu"))
    model.add(MaxPooling2D())
    model.add(Flatten())
    model.add(Dense(120, activation="relu"))
    model.add(Dropout(0.1))
    model.add(Dense(84, activation="relu"))
    model.add(Dense(10, activation="softmax"))
    return model


@pytest.fixture
def f32_convs():
    """cuDNN convolutions and matmuls in f32 (PyTorch's default lets
    cuDNN use TF32), restored after the test."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
def test_cuda_lenet_fits_and_predicts(cuda, f32_convs):
    """LeNet trains on the card (losses fall, validation accuracy above
    0.5, softmax rows sum to 1), and its predictions match the same
    weights on the CPU within 1e-4."""
    x, y = make_blobs(256)
    xv, yv = make_blobs(64, seed=1)
    model = lenet("cuda")
    assert all(p.is_cuda for p in model.parameters())
    model.compile(optimizer={"name": "adam", "lr": 1e-3},
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "top5accuracy"])
    hist = model.fit(x, y, batch_size=64, nb_epoch=3,
                     validation_data=(xv, yv))
    assert len(hist["loss"]) == 12 and hist["loss"][-1] < hist["loss"][0]
    assert hist["val"][-1]["accuracy"] > 0.5
    probs = model.predict(x[:100], batch_size=64)
    assert probs.shape == (100, 10)
    close(probs.sum(axis=1), 1.0, rtol=0, atol=1e-4)
    cpu = lenet("cpu", seed=1)
    cpu.set_weights(model.get_weights())
    close(probs, cpu.predict(x[:100], batch_size=64), rtol=0, atol=1e-4)
    assert set(model.evaluate(x, y, batch_size=64)) == {
        "accuracy", "top5accuracy", "loss"}


@pytest.mark.cuda
def test_cuda_lenet_save_load(cuda, f32_convs, tmp_path):
    """save_model/load_model on the card: the same predictions, on the
    card."""
    x, y = make_blobs(128)
    model = lenet("cuda")
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    model.fit(x, y, batch_size=64, nb_epoch=1)
    model.save_model(str(tmp_path / "lenet"))
    loaded = load_model(str(tmp_path / "lenet"), device="cuda")
    assert all(p.is_cuda for p in loaded.parameters())
    close(loaded.predict(x[:64]), model.predict(x[:64]), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_bf16_accumulated_fit_runs_the_bf16_kernels(cuda):
    """A small TransformerLM compiled with compute_dtype=bf16 and
    accum_steps=2 on the card: each step launches every kernel at bf16
    once a layer and microbatch and none at f32, the master weights and
    adam moments stay f32, and the losses match the same weights trained
    on the CPU (flash's plain versions at bf16) within 2e-2 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=61, seq_len=64, n_layers=2, d_model=64, n_heads=2)
    gpu = TransformerLM(**cfg, device="cuda", seed=0)
    cpu = TransformerLM(**cfg, implementation="flash", device="cpu", seed=1)
    from_jax_params(cpu, to_jax_params(gpu))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 61, (16, 64)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    losses = {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        m.compile({"name": "adam", "lr": 3e-3}, "class_nll",
                  compute_dtype=torch.bfloat16, accum_steps=2)
        _kernels.reset_launch_counts()
        losses[name] = m.fit(x, y, batch_size=8, shuffle=False)["loss"]
        if name == "cuda":
            counts = _kernels.launch_counts_by_dtype()
    steps = len(losses["cuda"])
    for kernel in _kernels.KERNELS:
        assert counts[f"{kernel}[bf16]"] == 2 * 2 * steps
        assert counts[f"{kernel}[f32]"] == 0
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in gpu.parameters())
    adam = gpu.trainer.state.opt_state.states[0]
    assert all(t.dtype == torch.float32 for t in adam["mu"] + adam["nu"])
    close(losses["cuda"], losses["cpu"], rtol=2e-2, atol=0)


@pytest.mark.cuda
def test_cuda_prefetch_keeps_order_on_the_device(cuda):
    """The trainer's device feed on the card: batches arrive in order, as
    CUDA tensors equal to the host arrays, through the side stream."""
    from analytics_zoo_tpu_torch.common.prefetch import DeviceFeed, prefetch
    feed = DeviceFeed(cuda)
    assert feed.stream is not None
    batches = [(np.full((64, 128), i, np.float32),
                np.arange(64, dtype=np.int32) + i) for i in range(20)]
    out = []
    with prefetch(batches, transform=feed, depth=2) as it:
        for item in it:
            x, y = feed.ready(item)
            assert x.is_cuda and y.is_cuda
            out.append((float(x.sum()), int(y[0])))
    assert out == [(64 * 128 * i, i) for i in range(20)]


@pytest.mark.cuda
def test_cuda_frozen_layer_does_not_move(cuda):
    """freeze() on the card: the frozen layer's weights stay bit for bit
    through a fit, the others train."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64, 2)).astype(np.float32)
    m = Sequential(device="cuda")
    m.add(Dense(8, input_shape=(4,), activation="relu", name="fz_a"))
    m.add(Dense(2, name="fz_b"))
    m.compile("adam", "mse")
    m.fit(x, y, batch_size=32, nb_epoch=1)
    m.freeze("fz_a")
    before = m.get_weights()
    m.fit(x, y, batch_size=32, nb_epoch=2)
    after = m.get_weights()
    np.testing.assert_array_equal(after["fz_a"]["W"], before["fz_a"]["W"])
    assert not np.allclose(after["fz_b"]["W"], before["fz_b"]["W"])


def sharp_lm(cfg, device, seed=0):
    """A TransformerLM whose head is scaled by 5: greedy picks stay far
    from f32 ties, so the card's and the CPU's streams can be compared
    token for token."""
    model = TransformerLM(**cfg, device=device, seed=seed).eval()
    with torch.no_grad():
        model.lm_head.W.mul_(5)
    return model


@pytest.mark.cuda
def test_cuda_engine_captures_its_plans_once(cuda, f32_convs):
    """The engine on the card: warmup captures the single step and the
    fused windows (4 and 2) as CUDA graphs, serving at every occupancy
    captures none more, and each greedy stream equals generate() of its
    prompt padded to the bucket."""
    cfg = dict(vocab_size=64, seq_len=48, n_layers=2, d_model=64, n_heads=2)
    model = sharp_lm(cfg, "cuda")
    engine = DecodeEngine(model, capacity=3, prompt_buckets=(16,))
    try:
        engine.warmup()
        assert engine.stats()["captures"] == 3
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 64, int(n)) for n in (3, 16, 7, 11, 5)]
        news = [9, 4, 12, 3, 7]
        outs = engine.generate(prompts, news, timeout=60)
        for p, m, out in zip(prompts, news, outs):
            padded = np.zeros((1, 16), np.int32)
            padded[0, :len(p)] = p
            ref = model.generate(padded, m, prompt_lengths=[len(p)])
            np.testing.assert_array_equal(out, ref[0, len(p):len(p) + m])
        stats = engine.stats()
        assert stats["captures"] == 3 and stats["plans_built"] == 3
        assert stats["fused_dispatches"] > 0
    finally:
        engine.close()


@pytest.mark.cuda
def test_cuda_admission_launches_the_forward_once_a_layer(cuda):
    """An admission's prefill runs the flash forward once a layer; a
    prefix-pool hit runs none (its prefix is copied, its tail prefilled
    with einsum attention), a miss once a layer."""
    cfg = dict(vocab_size=64, seq_len=48, n_layers=2, d_model=64, n_heads=2)
    model = sharp_lm(cfg, "cuda")
    engine = DecodeEngine(model, capacity=2, prompt_buckets=(8, 16),
                          prefix_pool=2)
    try:
        engine.warmup()
        rng = np.random.default_rng(1)
        head = rng.integers(0, 64, 8)
        counts = []
        for tail in (3, 5):
            before = _kernels.flash_fwd.launches
            engine.generate([np.concatenate([head, rng.integers(0, 64,
                                                                tail)])],
                            [2], timeout=60)
            counts.append(_kernels.flash_fwd.launches - before)
        before = _kernels.flash_fwd.launches
        engine.generate([rng.integers(0, 64, 5)], [2], timeout=60)
        counts.append(_kernels.flash_fwd.launches - before)
        assert counts == [cfg["n_layers"], 0, cfg["n_layers"]]
        st = engine.stats()
        assert st["prefix_misses"] == 1 and st["prefix_hits"] == 1
    finally:
        engine.close()


@pytest.mark.cuda
def test_cuda_coalesced_predict_matches_solo(cuda, f32_convs):
    """Coalesced LeNet predictions from 4 threads on the card: each within
    1e-5 of a solo predict (at f32 convolutions: TF32 ones would round
    differently at the two runs' batch sizes)."""
    import threading
    net = Sequential(device="cuda")
    net.add(Convolution2D(6, 5, 5, activation="relu", border_mode="same",
                          input_shape=(28, 28, 1)))
    net.add(MaxPooling2D())
    net.add(Flatten())
    net.add(Dense(10, activation="softmax"))
    coal = net.to_serving(supported_concurrent_num=2, coalescing=True,
                          warmup_shapes=(28, 28, 1))
    solo = net.to_serving()
    try:
        rng = np.random.default_rng(2)
        xs = [rng.normal(size=(int(rng.integers(1, 9)), 28, 28, 1)).astype(
            np.float32) for _ in range(12)]
        outs = [None] * len(xs)

        def client(t):
            for i in range(t, len(xs), 4):
                outs[i] = coal.predict(xs[i])

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for x, out in zip(xs, outs):
            close(out, solo.predict(x), rtol=0, atol=1e-5)
    finally:
        coal.close()
        solo.close()


def overwrite_behind_a_sleep(model, new):
    """Copy ``new``'s weights into ``model`` on the default stream behind
    a device sleep of about two seconds: work that does not wait for the
    default stream reads the old weights."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 32)
    with torch.no_grad():
        for p, q in zip(model.parameters(), new.parameters()):
            p.copy_(q)


@pytest.mark.cuda
def test_cuda_engine_waits_for_weights_written_before_it(cuda, f32_convs):
    """Weights rewritten in place on the default stream, then an engine
    made and served at once, with no warmup: the engine's stream orders
    itself after the caller's (it has the sleep to wait for), so its
    greedy streams are the new weights' generate().  Without warmup the
    plans are captured at the dispatcher's start, before any slot is
    live."""
    cfg = dict(vocab_size=64, seq_len=48, n_layers=2, d_model=64, n_heads=2)
    model = sharp_lm(cfg, "cuda")
    new = sharp_lm(cfg, "cuda", seed=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, int(n)) for n in (5, 9)]
    refs = []
    for p in prompts:
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(p)] = p
        refs.append(new.generate(padded, 6, prompt_lengths=[len(p)])[
            0, len(p):len(p) + 6])
    # an engine made and closed first: a process's first engine pays
    # one-time set-up that, run behind the sleep, could outlast it
    DecodeEngine(model, capacity=2, prompt_buckets=(16,)).close()
    overwrite_behind_a_sleep(model, new)
    engine = DecodeEngine(model, capacity=2, prompt_buckets=(16,))
    try:
        assert not engine._stream.query()
        outs = engine.generate(prompts, [6, 6], timeout=60)
    finally:
        engine.close()
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)


@pytest.mark.cuda
def test_cuda_coalescer_waits_for_weights_written_before_it(cuda,
                                                            f32_convs):
    """The same for a coalescing handle made right after the write: its
    first predict (a bucket build on the coalescer's stream) is within
    1e-5 of the new weights' predict."""
    net, new = lenet("cuda", seed=0), lenet("cuda", seed=1)
    x = make_blobs(5, seed=4)[0]
    ref = new.predict(x)
    overwrite_behind_a_sleep(net, new)
    coal = net.to_serving(coalescing=True)
    try:
        assert not coal._coalescer._stream.query()
        close(coal.predict(x), ref, rtol=0, atol=1e-5)
    finally:
        coal.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout", [
    (torch.float32, "nhwc"), (torch.float32, "channels_last"),
    (torch.bfloat16, "nhwc"), (torch.bfloat16, "channels_last")])
def test_cuda_batch_norm_train_matches_cpu(cuda, dtype, layout):
    """batch_norm_train on the card against the CPU on the same input:
    an NHWC tensor (channel axis -1), or the NCHW view of one
    (``channels_last`` memory, channel axis 1), as the port's
    convolutions give them.  out, dx, dgamma, dbeta within 1e-5 (f32) or
    one bf16 step of their magnitude (bf16); the f32 statistics within
    1e-5 at both."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, (16, 14, 14, 64)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    gamma = rng.normal(1.0, 0.2, 64).astype(np.float32)
    beta = rng.normal(0.0, 0.2, 64).astype(np.float32)
    runs = []
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).to(dtype)
        dyt = torch.from_numpy(dy).to(dev).to(dtype)
        if layout == "channels_last":
            xt, dyt, ax = xt.permute(0, 3, 1, 2), dyt.permute(0, 3, 1, 2), 1
        else:
            ax = 3
        xt.requires_grad_()
        g, b = (torch.from_numpy(a).to(dev).requires_grad_()
                for a in (gamma, beta))
        out, mean, var = tbn.batch_norm_train(xt, g, b, 1e-3, ax)
        grads = torch.autograd.grad(out, (xt, g, b), dyt)
        runs.append([t.detach().float().cpu().numpy()
                     for t in (out, mean, var) + grads])
    for name, a, b in zip(["out", "mean", "var", "dx", "dgamma", "dbeta"],
                          *runs):
        if dtype == torch.float32 or name in ("mean", "var"):
            close(a, b, 1e-5, 1e-5)
        else:
            close(a, b, 0, 2 ** -7 * np.abs(b).max())


@pytest.mark.cuda
def test_cuda_resnet50_train_step_matches_cpu(cuda, f32_convs):
    """ResNet-50 at 32x32 (7 classes, batch 8), one sgd-momentum step at
    f32 on the card and on the CPU from the same weights and state: the
    loss within 1e-4 (relative), the moving statistics within 1e-4 and
    the weight change within 0.1 (each of the largest entry over the
    model), every count 1; then predict within 1e-4.  The weight
    change's bound is the JAX package's own spread on the CPU, doubled:
    this network's training-mode gradient at its random init is
    ill-conditioned (tests/test_torch_image_classifier.py); the card
    lands 2.3% from the CPU here, the batch-norm step itself within 1e-5
    (test_cuda_batch_norm_train_matches_cpu)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 7, 8).astype(np.int32)
    models = [ImageClassifier("resnet-50", input_shape=(32, 32, 3),
                              num_classes=7, device=dev)
              for dev in ("cpu", "cuda")]
    p0 = models[0].get_weights()
    from_jax_params(models[1], p0, to_jax_state(models[0]))
    runs = []
    for m in models:
        m.compile({"name": "sgd", "lr": 1e-3, "momentum": 0.9},
                  "sparse_categorical_crossentropy")
        loss = m.fit(x, y, batch_size=8, shuffle=False)["loss"]
        runs.append((loss, m.get_weights(), to_jax_state(m),
                     m.predict(x, batch_size=8)))
    (l_ref, w_ref, s_ref, p_ref), (l, w, s, p) = runs
    close(l, l_ref, 1e-4, 0)
    moving = {n: {k: v for k, v in d.items() if k != "count"}
              for n, d in s_ref.items()}
    assert rel_err({n: {k: s[n][k] for k in d} for n, d in moving.items()},
                   moving) <= 1e-4
    assert rel_err(w, w_ref, p0) <= 0.1
    assert {float(d["count"]) for d in s.values()} == {1.0}
    close(p, p_ref, 0, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("logits", ["random", "zeros"])
def test_cuda_decode_output_matches_cpu(cuda, logits):
    """SSD postprocessing of one raw head (8,732 priors, 21 classes,
    batch 2) on the card and on the CPU: labels equal, scores and boxes
    within 1e-5; all-zero logits tie every score, so the tie order is
    the card's too."""
    priors = torch.from_numpy(ssd_priors(300))
    rng = np.random.default_rng(0)
    out = (rng.normal(size=(2, priors.shape[0], 25)) if logits == "random"
           else np.zeros((2, priors.shape[0], 25))).astype(np.float32)
    out = torch.from_numpy(out)
    ref = decode_output(out, priors, 21).numpy()
    got = decode_output(out.to(cuda), priors.to(cuda), 21)
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    close(got[..., 1:], ref[..., 1:], 1e-5, 1e-5)


@pytest.mark.cuda
def test_cuda_decode_output_follows_the_model(cuda):
    """``decode_output(det.predict(x), det.priors, n)``, predict's numpy
    with the model's priors as the JAX package calls it, decodes on the
    card, where the priors live, and equals the decode of the same head
    handed over as a card tensor."""
    det = ObjectDetector("ssd-vgg16-300", num_classes=4, seed=0)
    assert det.priors.device.type == "cuda"
    x = np.random.default_rng(0).uniform(0, 255, (1, 300, 300, 3)).astype(
        np.float32)
    raw = det.predict(x, batch_size=1)
    assert isinstance(raw, np.ndarray)
    got = decode_output(raw, det.priors, 4, conf_threshold=0.2)
    assert got.device.type == "cuda"
    ref = decode_output(torch.from_numpy(raw).to(cuda), det.priors, 4,
                        conf_threshold=0.2)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_cuda_neuralcf_steps_match_cpu(cuda):
    """bench.py's NCF widths (6040 x 3706, 5 classes) at batch 256: 3
    adam steps on the card and on the CPU from the same weights give
    losses within 1e-5 (relative) and parameters within NCF_TOL of the
    largest change the steps made (the embedding backward adds rows in
    another order on the card)."""
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(1, 6041, 768), rng.integers(1, 3707, 768)],
                 axis=1).astype(np.int32)
    y = rng.integers(0, 5, 768).astype(np.int32)
    runs = []
    for dev in ("cpu", "cuda"):
        m = NeuralCF(user_count=6040, item_count=3706, num_classes=5,
                     device=dev)
        if runs:
            from_jax_params(m, runs[0][2])
        init = m.get_weights()
        m.compile({"name": "adam", "lr": 1e-3}, "class_nll")
        loss = m.fit(x, y, batch_size=256, shuffle=False)["loss"]
        runs.append((loss, m.get_weights(), init))
    (l_ref, w_ref, init), (l, w, _) = runs
    close(l, l_ref, 1e-5, 0)
    err = rel_err(w, w_ref, init)
    assert err <= NCF_TOL, err


def flat_weights(tree):
    """{layer: {name: array}} of a weight tree that may nest deeper
    (Bidirectional's forward/backward), deeper keys joined by '/'."""
    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v
    return {layer: dict(leaves(sub)) for layer, sub in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_cuda_recurrent_steps_match_cpu(cuda, f32_convs, cell):
    """A Bidirectional recurrent Sequential (hard_sigmoid gates, seq 40)
    takes 2 sgd steps at rate 1 (the weights move by the gradient; adam's
    first step, lr * g / (|g| + eps), would amplify the rounding of
    gradients near eps) on the card and on the CPU from the same
    weights: predictions within 1e-5 before, losses within 1e-5
    (relative) and parameters within 1e-3 of the largest change the
    steps made."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 40, 16)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    runs = []
    for dev in ("cpu", "cuda"):
        m = Sequential(device=dev, seed=1)
        m.add(L.Bidirectional(getattr(L, cell)(24, return_sequences=True),
                              input_shape=(40, 16), name="bi"))
        m.add(getattr(L, cell)(24, go_backwards=True, name="rnn"))
        m.add(Dense(3, activation="softmax", name="out"))
        if runs:
            from_jax_params(m, runs[0][3])
        init = m.get_weights()
        pred = m.predict(x, batch_size=32)
        m.compile({"name": "sgd", "lr": 1.0},
                  "sparse_categorical_crossentropy")
        loss = m.fit(x, y, batch_size=16, shuffle=False)["loss"]
        runs.append((pred, loss, flat_weights(m.get_weights()), init))
    (p_ref, l_ref, w_ref, init), (p, l, w, _) = runs
    close(p, p_ref, 1e-5, 1e-5)
    close(l, l_ref, 1e-5, 0)
    err = rel_err(w, w_ref, flat_weights(init))
    assert err <= 1e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_cuda_switch_moe_index_dispatch_matches_dense(cuda, f32_convs,
                                                      capacity_factor):
    """The index dispatch against the dense one-hot einsums on the card
    at (4096, 768) tokens, 8 experts of width 3072: outputs within 1e-5
    of the largest entry, the aux loss equal, and the gradients of every
    weight and of the tokens within 1e-5 of each tensor's largest
    entry."""
    from analytics_zoo_tpu_torch.parallel import expert
    g = torch.Generator(device=cuda).manual_seed(0)
    p = expert.MoEParams(*(t.requires_grad_(True) for t in
                           expert.init_moe_params(g, 768, 3072, 8)))
    x = torch.randn((4096, 768), generator=g, device=cuda,
                    requires_grad=True)
    w = torch.randn((4096, 768), generator=g, device=cuda)
    grads = []
    for fn in (expert.switch_moe, expert.switch_moe_plain):
        out, aux = fn(x, p, capacity_factor)
        grads.append((out.detach(), float(aux), torch.autograd.grad(
            (out * w).sum() + aux, [x, *p])))
    (out, aux, ga), (ref, aux_ref, gb) = grads
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert aux == aux_ref
    for a, b in zip(ga, gb):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def moe_lm(device, **kw):
    cfg = dict(vocab_size=64, seq_len=48, n_layers=2, d_model=64, n_heads=2,
               moe_every=2, n_experts=4, **kw)
    return sharp_lm(cfg, device)


@pytest.mark.cuda
def test_cuda_moe_decode_graph_step_equals_eager(cuda, f32_convs):
    """A MoE TransformerLM's engine captures its plans once; one replay
    of the captured step equals the same step run eagerly from the same
    slot state (tokens and positions equal, caches within 1e-6), and
    the engine's greedy streams equal generate()'s."""
    model = moe_lm("cuda")
    engine = DecodeEngine(model, capacity=3, prompt_buckets=(16,))
    try:
        engine.warmup()
        assert engine.stats()["captures"] == 3
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 64, int(n)) for n in (3, 16, 7)]
        news = [9, 4, 12]
        outs = engine.generate(prompts, news, timeout=60)
        for p, m, out in zip(prompts, news, outs):
            ref = model.generate(p[None], m)
            np.testing.assert_array_equal(out, ref[0, len(p):])
        state = [engine._tok, engine._pos]
        caches = [c for kv in engine._caches for c in kv]
        with engine._on_device():
            saved = [t.clone() for t in state + caches]
            engine._step_plan.graph.replay()
            graph = [t.clone() for t in state + caches]
            for t, v in zip(state + caches, saved):
                t.copy_(v)
            engine._step_body()
            torch.cuda.synchronize()
        for a, b in zip(graph[:2], state):
            assert torch.equal(a, b)
        for a, b in zip(graph[2:], caches):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                float(b.abs().max()), 1.0)
        assert engine.stats()["captures"] == 3
    finally:
        engine.close()


@pytest.mark.cuda
def test_cuda_moe_capture_after_an_engine_captured_on_its_dispatcher(
        cuda, f32_convs):
    """The order that failed a MoE engine's first capture: an engine made
    behind the caller's writes and served at once (its plans captured on
    its dispatcher thread, as in engine_waits), closed and left to the
    cyclic collector with its graphs, then a MoE engine's warmup, with
    the collector set to run at nearly every allocation.  A collection
    inside a capture could destroy the old graphs there, which
    invalidates the capture; none runs during one, and the MoE engine's
    streams equal generate()'s."""
    import gc
    cfg = dict(vocab_size=64, seq_len=48, n_layers=2, d_model=64, n_heads=2)
    model, new = sharp_lm(cfg, "cuda"), sharp_lm(cfg, "cuda", seed=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, int(n)) for n in (5, 9)]
    overwrite_behind_a_sleep(model, new)
    old = DecodeEngine(model, capacity=2, prompt_buckets=(16,))
    try:
        old.generate(prompts, [6, 6], timeout=60)
        assert old.stats()["captures"] == 3
    finally:
        old.close()
    del old  # unreachable now, but held by its reference cycles
    during = []

    def watch(phase, info):
        if phase == "start":
            during.append(torch.cuda.is_current_stream_capturing())

    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    moe = moe_lm("cuda")
    try:
        engine = DecodeEngine(moe, capacity=3, prompt_buckets=(16,))
        try:
            engine.warmup()
            assert engine.stats()["captures"] == 3
            prompts = [rng.integers(0, 64, int(n)) for n in (3, 16, 7)]
            outs = engine.generate(prompts, [9, 4, 12], timeout=60)
        finally:
            engine.close()
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
    assert during and not any(during)
    for p, m, out in zip(prompts, [9, 4, 12], outs):
        np.testing.assert_array_equal(out, moe.generate(p[None], m)[
            0, len(p):])


@pytest.mark.cuda
def test_cuda_engines_capturing_at_once_keep_the_collector_off(cuda,
                                                              f32_convs):
    """Two MoE engines, never warmed, start serving at the same moment on
    two threads, so both dispatchers capture their plans at once, with a
    closed engine's graphs left to the cyclic collector and the collector
    set to run at nearly every allocation.  Captures take turns with the
    collector off, so the capture that ends first cannot turn it back on
    under the other: no collection starts on a capturing thread, each
    engine captures its three plans, and each gives generate()'s streams;
    the collector is on again after."""
    import gc
    import threading
    cfg = dict(vocab_size=64, seq_len=48, n_layers=2, d_model=64, n_heads=2)
    old = DecodeEngine(sharp_lm(cfg, "cuda"), capacity=2,
                       prompt_buckets=(16,))
    try:
        old.warmup()
    finally:
        old.close()
    del old  # unreachable now, but held by its reference cycles
    moes = [moe_lm("cuda") for _ in range(2)]
    engines = [DecodeEngine(m, capacity=3, prompt_buckets=(16,))
               for m in moes]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, int(n)) for n in (3, 16, 7)]
    news = [9, 4, 12]
    start = threading.Barrier(len(engines))
    outs, errors, during = {}, [], []

    def serve(i):
        try:
            start.wait(timeout=60)
            outs[i] = engines[i].generate(prompts, news, timeout=120)
        except Exception as e:  # the assertion below names it
            errors.append(e)

    def watch(phase, info):
        if phase == "start":
            during.append(torch.cuda.is_current_stream_capturing())

    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(len(engines))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        captures = [e.stats()["captures"] for e in engines]
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
        for e in engines:
            e.close()
    assert not errors, errors
    assert captures == [3, 3]
    assert during and not any(during)
    assert gc.isenabled()
    for i, moe in enumerate(moes):
        for p, m, out in zip(prompts, news, outs[i]):
            np.testing.assert_array_equal(out, moe.generate(p[None], m)[
                0, len(p):])


@pytest.mark.cuda
def test_cuda_moe_lm_step_launches_the_three_kernels(cuda, f32_convs):
    """One fit step of a MoE TransformerLM (flash attention) launches
    each kernel once a layer at f32, and twice a layer at bf16 with two
    microbatches; its f32 gradients match blockwise attention's within
    1e-3 of each tensor's largest entry."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    rng = np.random.default_rng(1)
    x = rng.integers(0, 64, (8, 48)).astype(np.int32)
    y = rng.integers(0, 64, (8, 48)).astype(np.int32)
    for dtype, accum, name in ((None, 1, "f32"), (torch.bfloat16, 2,
                                                  "bf16")):
        model = moe_lm("cuda", implementation="flash")
        model.compile({"name": "adam", "lr": 1e-3}, "class_nll",
                      compute_dtype=dtype, accum_steps=accum)
        _kernels.reset_launch_counts()
        loss = model.fit(x, y, batch_size=8)["loss"]
        counts = _kernels.launch_counts_by_dtype()
        assert np.isfinite(loss).all()
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert counts[f"{k}[{name}]"] == 2 * accum, counts
    model = moe_lm("cuda", implementation="flash", capacity_factor=4.0)
    params = list(model.parameters())
    ids, labels = (torch.as_tensor(a, device=cuda) for a in (x, y))
    grads = {}
    for impl in ("flash", "blockwise"):
        for i in range(2):
            getattr(model, f"attn_{i}").implementation = impl
        loss = objectives.class_nll(labels, model(ids)).mean()
        grads[impl] = torch.autograd.grad(loss, params)
    for a, b in zip(grads["flash"], grads["blockwise"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (2, 64, 16), (16, 147, 64), (17, 64, 84), (5, 24, 126), (1, 2048, 1000),
    (32, 2048, 1000), (100352, 576, 64)])
def test_cuda_int_matmul_pads_to_exact_accumulators(cuda, m, k, n):
    """torch._int_mm refuses rows <= 16 and a depth or width off a
    multiple of 8 on the card: the padded product equals the CPU's int32
    accumulators exactly (ResNet-50's stem depth 147, SSD's head widths
    84 and 126, the fc at batch 1, a 3x3 64-channel layer at batch 32)."""
    from analytics_zoo_tpu_torch.ops.quantize import int_matmul
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = int_matmul(a.to(cuda), b.to(cuda))
    assert got.device.type == cuda.type and got.dtype == torch.int32
    assert torch.equal(got.cpu(), int_matmul(a, b))


@pytest.mark.cuda
def test_cuda_quantize_passes_give_the_cpu_bits(cuda):
    """The int8 weights and scales, the per-sample activation scales and
    int8 values, and eval-mode BatchNorm's output are bit-equal on the
    card and the CPU.  CUDA divides by a host scalar as a product with
    its reciprocal and its ``rsqrt`` is approximate; either one shifts a
    scale by a bit, flips int8 roundings, and the flips grow through a
    deep int8 net (ResNet-50 0.009 apart in probability)."""
    from analytics_zoo_tpu_torch.ops import batchnorm as B
    from analytics_zoo_tpu_torch.ops import quantize as Q
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 3, 256, 512, generator=g)
    x = torch.randn(64, 14, 14, 256, generator=g) * 3
    for name, got, want in (
            ("weights", Q.quantize_per_channel(w.to(cuda)),
             Q.quantize_per_channel(w)),
            ("activations", Q.dynamic_quantize(x.to(cuda)),
             Q.dynamic_quantize(x))):
        for part, a, b in zip(("int8", "scale"), got, want):
            assert torch.equal(a.cpu(), b), (name, part)
    gamma, beta, mean = (torch.randn(256, generator=g) for _ in range(3))
    var = torch.rand(256, generator=g) * 4
    args = (gamma, beta, mean, var, 1e-3, 3)
    got = B.batch_norm_inference(x.to(cuda), *(a.to(cuda) for a in args[:4]),
                                 *args[4:]).cpu()
    want = B.batch_norm_inference(x, *args)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,cin,cout,stride,padding", [
    (7, 3, 64, 2, "SAME"), (3, 64, 64, 1, "SAME"), (1, 256, 64, 1, "VALID"),
    (3, 512, 84, 1, "SAME"), (3, 256, 126, 1, "SAME")])
def test_cuda_int8_conv_accumulators_match_cpu(cuda, kernel, cin, cout,
                                               stride, padding):
    from analytics_zoo_tpu_torch.ops import quantize as Q
    g = torch.Generator().manual_seed(kernel * cin + cout)
    xq, _ = Q.dynamic_quantize(torch.randn(2, 38, 38, cin, generator=g))
    wq, _ = Q.quantize_per_channel(torch.randn(kernel, kernel, cin, cout,
                                               generator=g))
    args = ((stride, stride), padding)
    got = Q.conv_accumulate(xq.to(cuda), wq.to(cuda), *args)
    assert torch.equal(got.cpu(), Q.conv_accumulate(xq, wq, *args))


def _png_folder(root, n=6):
    """PNG class folders written with chip_smoke's standard-library
    encoder (the card host may have no imaging package); returns {path:
    rgb}."""
    rng = np.random.default_rng(0)
    written = {}
    for i in range(n):
        h, w = 40 + 7 * i, 64 - 5 * i
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        d = root / f"c{i % 2}"
        d.mkdir(exist_ok=True)
        path = d / f"{i}.png"
        write_png(path, rgb)
        written[str(path)] = rgb
    return written


@pytest.mark.cuda
def test_cuda_native_decode_reads_the_written_pixels(cuda, tmp_path):
    """The port's native library decodes PNG class folders to the
    written pixels (BGR), and its normalized batches go to the card."""
    from analytics_zoo_tpu_torch import native
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    if not native.available():
        pytest.skip(f"native library not built here: {native.build_error()}")
    written = _png_folder(tmp_path)
    iset = ImageSet.read(str(tmp_path), with_label=True)
    for f in iset.features:
        np.testing.assert_array_equal(f["image"][:, :, ::-1],
                                      written[f["uri"]])
    batch = native.decode_resize_normalize_batch(
        [open(p, "rb").read() for p in sorted(written)], 32)
    assert torch.as_tensor(batch, device=cuda).shape == (6, 32, 32, 3)


@pytest.mark.cuda
def test_cuda_predict_image_set_matches_cpu(cuda, f32_convs, tmp_path):
    """A classifier (squeezenet at 32x32 through a resize, crop and
    normalize configure; f32 and -quantize) and a detector
    (ssd-mobilenet-300 through its parsed configure) predict an image
    set of raw sizes on the card as on the CPU: probabilities within
    1e-5, and every detection found on the other device with its label,
    its score within 1e-4 and its box within 1e-4 of the image size (in
    any order among near-tied scores)."""
    from analytics_zoo_tpu_torch.feature.image import (
        ImageCenterCrop, ImageChannelNormalize, ImageResize, ImageSet)
    from analytics_zoo_tpu_torch.models import ImageConfigure
    raw = [np.asarray(v, np.float32)[:, :, ::-1]
           for v in _png_folder(tmp_path).values()]
    cfg = ImageConfigure(pre_processor=(
        ImageResize(40, 40) >> ImageCenterCrop(32, 32)
        >> ImageChannelNormalize(123.68, 116.779, 103.939, 58.4, 57.1,
                                 57.4)))
    weights = ImageClassifier("squeezenet", input_shape=(32, 32, 3),
                              num_classes=5, device="cpu").get_weights()
    for name in ("squeezenet", "squeezenet-quantize"):
        out = {}
        for dev in ("cuda", "cpu"):
            m = ImageClassifier(name, input_shape=(32, 32, 3),
                                num_classes=5, device=dev)
            m.set_weights(weights)
            iset = ImageSet.from_arrays(raw)
            m.predict_image_set(iset, configure=cfg)
            out[dev] = np.stack([p for _, p in iset.get_predicts()])
        close(out["cuda"], out["cpu"], rtol=0, atol=1e-5)
    src = ObjectDetector("ssd-mobilenet-300", num_classes=4, device="cpu")
    dets = {}
    for dev in ("cuda", "cpu"):
        det = ObjectDetector("ssd-mobilenet-300", num_classes=4,
                             max_detections=20, device=dev)
        from_jax_params(det, src.get_weights(), to_jax_state(src))
        iset = ImageSet.from_arrays(raw[:2])
        det.predict_image_set(
            iset, batch_size=2,
            configure=ImageConfigure.parse("ssd-mobilenet-300"))
        dets[dev] = np.stack([p for _, p in iset.get_predicts()])
    for a, b in zip(dets["cuda"], dets["cpu"]):
        assert unmatched_detections(a, b, tol=1e-4, scale=64) == 0



@pytest.mark.cuda
@pytest.mark.parametrize("momentum,count", [(0.99, 3.0), (0.99, 5.0),
                                            (0.9, 17.0), (0.99, 1000.0)])
def test_cuda_batchnorm_debias_gives_the_cpu_bits(cuda, momentum, count):
    """A BatchNormalization's debiased moving statistics (the f64
    ``momentum ** count`` and its divisions) on the card equal the CPU's
    bit for bit, at the counts of a short training: there the debias
    magnifies a last-bit difference of its inputs 30-fold and more."""
    g = torch.Generator().manual_seed(int(count))
    state = {"moving_mean": 0.1 * torch.randn(256, generator=g),
             "moving_var": 0.97 + 0.05 * torch.rand(256, generator=g),
             "count": torch.tensor(count)}
    out = {}
    for dev in ("cuda", "cpu"):
        bn = BatchNormalization(momentum=momentum, input_shape=(256,),
                                device=dev)
        with torch.no_grad():
            for k, v in bn.state().items():
                v.copy_(state[k])
        out[dev] = [t.cpu() for t in bn.debiased_statistics()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4])
def test_cuda_deconvolution2d_same_stride2_matches_cpu(cuda, f32_convs, k):
    """Deconvolution2D, border_mode same at stride 2 (XLA's padding,
    asymmetric at an even kernel, cut from cuDNN's transposed
    convolution) on the card against the CPU: forward, input and weight
    gradients within 1e-5 of the largest entry."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn(8, 17, 16, 32, generator=g)
    cot = torch.randn(8, 34, 32, 24, generator=g)
    layers = [Deconvolution2D(24, k, k, subsample=(2, 2), border_mode="same",
                              input_shape=(17, 16, 32), device=dev)
              for dev in ("cuda", "cpu")]
    layers[0].load_state_dict(layers[1].state_dict())
    res = []
    for layer in layers:
        xi = x.to(layer.W.device).requires_grad_()
        out = layer(xi)
        grads = torch.autograd.grad((out * cot.to(out.device)).sum(),
                                    [xi, layer.W, layer.b])
        res.append([t.detach().cpu() for t in (out,) + grads])
    for a, b in zip(*res):
        close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("out_hw", [(24, 40), (7, 13), (20, 70)])
def test_cuda_resize_bilinear_down_matches_cpu(cuda, out_hw):
    """ResizeBilinear shrinking (the antialiased filter the JAX package's
    jax.image.resize applies) on the card against the CPU: forward and
    input gradient within 1e-5 of the largest entry; the last case
    shrinks one axis and grows the other."""
    g = torch.Generator().manual_seed(sum(out_hw))
    x = torch.randn(4, 64, 48, 16, generator=g)
    cot = torch.randn((4,) + out_hw + (16,), generator=g)
    res = []
    for dev in ("cuda", "cpu"):
        layer = ResizeBilinear(*out_hw)
        xi = x.to(dev).requires_grad_()
        out = layer(xi)
        (gx,) = torch.autograd.grad((out * cot.to(dev)).sum(), [xi])
        res.append((out.detach().cpu(), gx.cpu()))
    for a, b in zip(*res):
        close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


# ---- fault-tolerant training on the card ----------------------------------

def _card_lm(cuda, **kw):
    return TransformerLM(vocab_size=64, seq_len=128, n_layers=2,
                         d_model=64, n_heads=2, implementation="flash",
                         device=cuda, seed=0, **kw)


@pytest.mark.cuda
def test_cuda_async_save_copies_before_the_next_in_place_step(cuda,
                                                              tmp_path):
    """An asynchronous snapshot taken between two in-place optimizer
    steps holds the weights of the first: the copy to the host is made,
    on the caller's stream, before ``async_save_sharded`` returns."""
    from analytics_zoo_tpu_torch.train import checkpoint as ckpt
    from analytics_zoo_tpu_torch.train import triggers
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    lm = _card_lm(cuda)
    lm.compile({"name": "adam", "lr": 1e-2}, "class_nll")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (16, 128)).astype(np.int32)
    ds = Dataset.from_ndarray(x, (x + 1) % 64)
    lm.trainer.fit(ds, 8, end_trigger=triggers.MaxIteration(1))
    want = {n: p.detach().cpu().clone() for n, p in lm.named_parameters()}
    tree = lm.trainer.state_tree()
    ckpt.async_save_sharded(str(tmp_path), 1, tree)
    lm.trainer.fit(ds, 8, end_trigger=triggers.MaxIteration(2))
    ckpt.wait_pending(str(tmp_path))
    got = ckpt.restore_sharded(str(tmp_path), tree, 1)["params"]
    moved = 0
    for layer, params in to_jax_params(lm).items():
        for name in params:
            saved = got[layer][name]
            key = f"{layer}.{name}"
            np.testing.assert_array_equal(saved, want[key].numpy())
            moved += int(not np.array_equal(saved, params[name]))
    assert moved  # the second step did move the live weights


@pytest.mark.cuda
def test_cuda_remat_with_flash_kernels_gives_the_gradients(cuda):
    """remat on every attention and MLP sublayer recomputes through the
    flash forward kernel in the backward (twice the forward launches)
    and gives the non-remat gradients (the kernels are deterministic)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 64, (4, 128))).to(cuda)
    grads, fwd = [], []
    for remat in (False, True):
        lm = _card_lm(cuda, remat=remat).train()
        before = _kernels.flash_fwd.launches
        loss = lm(x)[..., 0].sum()
        grads.append(torch.autograd.grad(loss, list(lm.parameters())))
        fwd.append(_kernels.flash_fwd.launches - before)
    assert fwd == [2, 4]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_cuda_corrupt_tag_falls_back(cuda, tmp_path, monkeypatch):
    """ZOO_FAULT_CORRUPT_TAG on the card: the resumed trainer discards
    the corrupt newest tag and restores the one before it, onto the
    card, to the weights an uninterrupted run had there."""
    from analytics_zoo_tpu_torch.train import triggers
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    rng = np.random.default_rng(2)
    x = rng.integers(0, 64, (32, 128)).astype(np.int32)
    ds = Dataset.from_ndarray(x, (x + 1) % 64)
    monkeypatch.setenv("ZOO_CKPT_SYNC", "1")
    monkeypatch.setenv("ZOO_FAULT_CORRUPT_TAG", "4")
    lm = _card_lm(cuda)
    lm.compile("adam", "class_nll")
    lm.trainer.set_checkpoint(str(tmp_path),
                              trigger=triggers.SeveralIteration(2))
    lm.trainer.fit(ds, 8, end_trigger=triggers.MaxIteration(2))
    want = [p.detach().cpu().clone() for p in lm.parameters()]
    lm.trainer.fit(ds, 8, end_trigger=triggers.MaxIteration(4))
    monkeypatch.setenv("ZOO_RESUME", "1")
    res = _card_lm(cuda)
    res.compile("adam", "class_nll")
    res.trainer.set_checkpoint(str(tmp_path),
                               trigger=triggers.SeveralIteration(2))
    res.trainer.fit(ds, 8, end_trigger=triggers.MaxIteration(2))
    assert res.trainer.state.step == 2
    assert not any(f.startswith("ckpt_4") for f in os.listdir(tmp_path))
    for p, w in zip(res.parameters(), want):
        assert p.device.type == "cuda"
        assert torch.equal(p.detach().cpu(), w)


@pytest.mark.cuda
def test_cuda_fsdp_fit_on_a_world_of_one_matches_plain(cuda):
    """A world of one over NCCL: a mesh naming the six axes, and a small
    TransformerLM trained under fsdp (its weights and adam moments
    DTensors on the mesh) through the kernels, against the plain Trainer
    from the same weights: losses and weights bit for bit, 2 launches of
    each kernel a step."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=61, seq_len=64, n_layers=2, d_model=64, n_heads=2)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 61, (16, 64)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    mesh = mesh_lib.create_mesh(device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        assert mesh.mesh_dim_names == mesh_lib.AXES
        runs = []
        for kw in ({}, dict(mesh=mesh, strategy="fsdp")):
            m = TransformerLM(**cfg, device="cuda", seed=0)
            m.compile({"name": "adam", "lr": 3e-3}, "class_nll", **kw)
            _kernels.reset_launch_counts()
            loss = m.fit(x, y, batch_size=8, shuffle=False)["loss"]
            counts = _kernels.launch_counts()
            runs.append((loss, [p.detach().cpu() for p in m.parameters()]))
            assert all(c == 2 * len(loss) for c in counts.values())
        tree = m.trainer.state_tree()
        assert isinstance(tree["params"]["attn_0"]["Wq"], DTensor)
        assert isinstance(tree["opt_state"]["0"][".mu"]["attn_0"]["Wq"],
                          DTensor)
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)
    finally:
        mesh_lib.set_default_mesh(None)
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_replicas_on_one_card_give_the_models_bits(cuda, f32_convs):
    """A replica set over ``["cuda:0", "cuda:0"]``: each replica's
    dispatch runs on its own stream and returns the bits of the model's
    own forward at the same batch, coalesced or solo, with or without a
    hedge."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    net = lenet("cuda", seed=2)
    net.eval()
    x = make_blobs(8, seed=5)[0]
    with torch.no_grad():
        want = net(torch.from_numpy(x).cuda()).cpu().numpy()
    im = InferenceModel(max_batch_size=8, buckets=[8], coalescing=True,
                        replicas=["cuda:0", "cuda:0"],
                        hedging=True).load_keras_net(net)
    try:
        im.warmup((28, 28, 1))
        rs = im._cache.replica_set
        assert rs.replicas[0].stream != rs.replicas[1].stream
        from analytics_zoo_tpu_torch.pipeline.inference.serving import \
            fetch_rows
        for r in rs.replicas:
            np.testing.assert_array_equal(
                fetch_rows(rs.dispatch(r, x), 8), want)
        np.testing.assert_array_equal(im.predict(x), want)
    finally:
        im.close()


@pytest.mark.cuda
def test_cuda_page_out_frees_the_models_bytes(cuda):
    """A paged-out model returns at least 95% of its weight bytes to the
    card, and faults back in with its own bits."""
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    shape = (64, 64, 3)
    reg = ModelRegistry(device="cuda", pager={"max_resident": 1})
    x = np.random.default_rng(1).normal(size=(2,) + shape).astype(
        np.float32)
    try:
        net = ImageClassifier("resnet-50", input_shape=shape,
                              num_classes=10, device="cuda", seed=0)
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in net.state_dict().values())
        reg.deploy("a", net, warmup_shapes=shape)
        del net
        want = reg.predict("a", x)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        entry = reg._entry("a")
        assert reg.pager._try_evict("a", entry, "pressure")
        torch.cuda.synchronize()
        assert before - torch.cuda.memory_allocated() >= 0.95 * weight_bytes
        np.testing.assert_array_equal(reg.predict("a", x), want)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        assert reg.pager._try_evict("a", entry, "pressure")
        torch.cuda.synchronize()
        assert before - torch.cuda.memory_allocated() >= 0.95 * weight_bytes
    finally:
        reg.shutdown()


@pytest.mark.cuda
def test_cuda_shard_group_of_two_on_one_card_gives_the_solo_bits(cuda):
    """A group of two on one card (``replicas=["cuda:0", "cuda:0"]``,
    ``{"axes": {"tensor": 2}}``): each member holds its blocks, the
    forward gathers each layer on use on the group's stream, and the
    output is the single-device handle's bit for bit, through the flash
    forward once a layer."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    lm = TransformerLM(vocab_size=1000, seq_len=128, n_layers=2,
                       d_model=128, n_heads=2, device="cuda").eval()
    x = np.random.default_rng(3).integers(0, 1000, (3, 128)).astype(
        np.int32)
    # device="cuda" against the model's cuda:0: the same card
    solo = InferenceModel(max_batch_size=4, device="cuda").load_keras_net(lm)
    im = InferenceModel(max_batch_size=4, mesh={"axes": {"tensor": 2}},
                        replicas=["cuda:0", "cuda:0"]).load_keras_net(lm)
    try:
        im.warmup((128,), np.int32)
        want = solo.predict(x)
        _kernels.reset_launch_counts()
        got = im.predict(x)
        assert _kernels.launch_counts()["flash_fwd"] == 2
        np.testing.assert_array_equal(got, want)
        rs = im._cache.replica_set
        assert rs.group_size == 2 and len(rs.groups) == 1
        assert rs.groups[0].stream is not None
        whole = sum(t.numel() * t.element_size() for t in
                    list(lm.parameters()) + list(lm.buffers()))
        (members,) = rs.member_bytes()
        assert max(members) < whole <= sum(members)
    finally:
        im.close()
        solo.close()


@pytest.mark.cuda
def test_cuda_sharded_load_holds_only_the_blocks(cuda, tmp_path):
    """``load()`` under a mesh reads the saved model onto the host and
    carves the groups' blocks from it: the card's allocation grows by the
    members' blocks, not the blocks plus the model, and the output is the
    single-device load's bit for bit."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    lm = TransformerLM(vocab_size=1000, seq_len=128, n_layers=2,
                       d_model=128, n_heads=2, device="cpu").eval()
    path = str(tmp_path / "lm")
    lm.save_model(path)
    whole = sum(t.numel() * t.element_size() for t in
                list(lm.parameters()) + list(lm.buffers()))
    x = np.random.default_rng(4).integers(0, 1000, (3, 128)).astype(
        np.int32)
    # the bytes requested of the allocator (its block rounding left out)
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    im = InferenceModel(max_batch_size=4, mesh={"axes": {"tensor": 2}},
                        replicas=["cuda:0", "cuda:0"]).load(path)
    solo = None
    try:
        torch.cuda.synchronize()
        grown = torch.cuda.memory_stats()[
            "requested_bytes.all.current"] - base
        blocks = sum(sum(m) for m in im._cache.replica_set.member_bytes())
        assert blocks <= grown < blocks + 0.1 * whole
        solo = InferenceModel(max_batch_size=4).load(path)
        np.testing.assert_array_equal(im.predict(x), solo.predict(x))
    finally:
        im.close()
        if solo is not None:
            solo.close()


@pytest.mark.cuda
def test_cuda_bare_fn_gathers_its_whole_tree_a_module_a_layer(cuda):
    """A function served under a mesh without its module gathers its
    whole tree on the group's first device for each dispatch; the same
    function carrying ``fn.module`` gathers one layer at a time.  The
    dispatch peaks over what is resident, against an unsharded handle's
    at the same input, pin both."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import (
        meta_skeleton, module_forward, module_tensors)
    lm = TransformerLM(vocab_size=512, seq_len=128, n_layers=4,
                       d_model=256, n_heads=4, device="cpu").eval()
    params = module_tensors(lm)
    whole = sum(t.numel() * t.element_size() for t in params.values())
    by_layer = module_forward(meta_skeleton(lm))

    def bare(p, x):
        return by_layer(p, x)

    x = np.random.default_rng(5).integers(0, 512, (2, 128)).astype(
        np.int32)
    peaks, outs = {}, {}
    for name, fn in (("solo", by_layer), ("layer", by_layer),
                     ("bare", bare)):
        if name == "solo":
            im = InferenceModel(max_batch_size=2).load_fn(fn, params)
        else:
            im = InferenceModel(max_batch_size=2,
                                mesh={"axes": {"tensor": 2}},
                                replicas=["cuda:0", "cuda:0"]).load_fn(
                                    fn, params)
        try:
            im.warmup((128,), np.int32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[name] = im.predict(x)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
        finally:
            im.close()
    np.testing.assert_array_equal(outs["bare"], outs["solo"])
    np.testing.assert_array_equal(outs["layer"], outs["solo"])
    assert peaks["layer"] - peaks["solo"] < 0.5 * whole
    assert 0.5 * whole < peaks["bare"] - peaks["layer"] <= whole


@pytest.mark.cuda
def test_cuda_kernel_lib_store_hit_in_a_subprocess(cuda, tmp_path):
    """Two processes from fresh copies of the package share one store:
    the first runs nvcc and writes every kernel library (one a source),
    the second runs no nvcc (no compile in its profile), loads them from
    the store and gives the first one's flash_fwd and predict bits."""
    from chip_smoke import store_worker
    store = str(tmp_path / "store")
    libs = len(_kernels._SIGNATURES)
    cold, a, _ = store_worker(str(tmp_path), "cold", store)
    warm, b, _ = store_worker(str(tmp_path), "warm", store)
    assert cold["compiles"] == 1 and cold["store"]["write"] == libs
    assert warm["compiles"] == 0 and warm["compile_keys"] == []
    assert warm["store"]["hit"] == libs and warm["store"]["write"] == 0
    for key in ("y", "o", "lse"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.cuda
def test_cuda_two_worker_fleet_generates_the_registry_tokens(cuda,
                                                             tmp_path):
    """A fleet of two workers on the card (from a fresh copy of the
    package) serving a 2-layer TransformerLM: generate equals the
    single-process registry token for token, greedy and sampled; each
    worker's flash_fwd count (read by ``ping``) grows 2 an admission;
    the first activation runs nvcc, the second none (it loads the first's
    libraries from the build directory of the copy they share); with that
    directory removed, a SIGKILLed worker comes back replaying the model
    from the store, with no nvcc and no store miss."""
    import time
    from chip_smoke import fleet_drop_builds, fleet_env, fleet_package
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    from analytics_zoo_tpu_torch.serving.fleet import FleetRouter, builders
    args = dict(vocab_size=1000, seq_len=128, n_layers=2, d_model=128,
                n_heads=2, capacity=2, prompt_buckets=[32, 64])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, int(n)) for n in (5, 30, 47, 64)]
    samplings = [{}, dict(temperature=0.9, top_k=20, seed=3)] * 2
    reg = ModelRegistry()
    try:
        reg.deploy("lm", **builders.lm(args, None, device="cuda"))
        ref = [reg.generate("lm", [p], 6, **s)[0]
               for p, s in zip(prompts, samplings)]
    finally:
        reg.shutdown()
    pkg = fleet_package(str(tmp_path))
    r = FleetRouter(str(tmp_path / "share"), n_workers=2, device="cuda",
                    env=fleet_env(pkg),
                    max_restarts=1, call_timeout_s=600)
    try:
        r.start(timeout=300)
        acts = r.deploy("lm", None, "analytics_zoo_tpu_torch.serving."
                        "fleet.builders:lm", args)["activations"]
        assert all("error" not in a for a in acts), acts
        assert acts[0]["kernel_builds"] == 1 and acts[0]["store_misses"] > 0
        assert acts[1]["kernel_builds"] == 0
        assert acts[1]["store_misses"] == 0
        before = {rk: r.ping(rk)["launches"]["flash_fwd"] for rk in (0, 1)}
        outs = [r.generate_ex("lm", [p], 6, **s)[0][0]
                for p, s in zip(prompts, samplings)]
        for got, want in zip(outs, ref):
            np.testing.assert_array_equal(got, want)
        after = {rk: r.ping(rk)["launches"]["flash_fwd"] for rk in (0, 1)}
        # sequential requests rotate over the idle workers: two each
        assert all(after[rk] - before[rk] == 2 * 2 for rk in (0, 1))
        assert len(fleet_drop_builds(pkg)) == len(_kernels._SIGNATURES)
        r.supervisor.kill(1)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and not (
                r.supervisor.worker(1).incarnation == 1
                and r.handles[1].routable):
            time.sleep(0.05)
        (replay,) = r.replays[1]
        assert replay["kernel_builds"] == 0 and replay["store_misses"] == 0
        assert replay["store_hits"] == len(_kernels._SIGNATURES)
        assert r.ping(1)["incarnation"] == 1
        for p, s, want in zip(prompts, samplings, ref):
            np.testing.assert_array_equal(
                r.generate_ex("lm", [p], 6, **s)[0][0], want)
    finally:
        r.close()


@pytest.mark.cuda
def test_cuda_stream_fit_launches_and_equals_the_memory_fit(cuda):
    """The full-width config at 2 layers (seq 2048, batch 8): 3 steps from
    a stream of ragged chunks with a windowed shuffle launch each kernel
    twice a step, and a fit over the emitted batches from memory gives
    the same losses and weights, bit for bit."""
    from chip_smoke import periodic_tokens
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    cfg = dict(vocab_size=32000, seq_len=2048, n_layers=2, d_model=768,
               n_heads=12)
    x, y = periodic_tokens(24, cfg["vocab_size"], 2048, seed=2)
    emitted = []
    runs = []
    for data in ("stream", "memory"):
        model = TransformerLM(**cfg, seed=0)
        model.compile({"name": "adam", "lr": 3e-4}, "class_nll")
        if data == "stream":
            ds = recorded(Dataset.from_batch_iterable(
                stream_factory(x, y, 3, []), shuffle_buffer=24), emitted)
        else:
            ds = Dataset.from_ndarray(np.concatenate([b[0] for b in emitted]),
                                      np.concatenate([b[1] for b in emitted]))
        _kernels.reset_launch_counts()
        hist = model.fit(ds, batch_size=8, shuffle=data == "stream")
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        assert all(counts[k] == 2 * 3 for k in
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")), counts
        runs.append((hist["loss"], [p.detach().clone()
                                    for p in model.parameters()]))
        del model
    assert len(emitted) == 3
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
def test_cuda_onnx_and_graphdef_predict_as_on_the_cpu(cuda, f32_convs,
                                                     tmp_path):
    from analytics_zoo_tpu_torch.pipeline.api.net import Net
    from analytics_zoo_tpu_torch.pipeline.api.onnx import proto as P
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph import proto as TP
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph.net import write_meta
    onnx_path = str(tmp_path / "stage1.onnx")
    with open(onnx_path, "wb") as f:
        f.write(resnet_stage1_onnx(P, 64, 10))
    x = np.random.default_rng(0).normal(size=(4, 3, 64, 64)).astype(
        np.float32)
    got = Net.load_onnx(onnx_path).predict(x)
    want = Net.load_onnx(onnx_path, device="cpu").predict(x)
    assert np.abs(got - want).max() <= 1e-4
    folder = tmp_path / "graph"
    folder.mkdir()
    (folder / "frozen_inference_graph.pb").write_bytes(nhwc_graph_def(TP, 10))
    write_meta(str(folder), ["image:0"], ["probs:0"])
    x = np.random.default_rng(1).normal(size=(4, 65, 63, 3)).astype(
        np.float32)
    got = Net.load_tf(str(folder)).predict(x)
    want = Net.load_tf(str(folder), device="cpu").predict(x)
    assert got.shape == (4, 10) and np.abs(got - want).max() <= 1e-4


@pytest.mark.cuda
def test_cuda_onnxnet_keeps_no_parameter_on_the_cpu(cuda):
    from analytics_zoo_tpu_torch.pipeline.api.onnx import OnnxNet
    from analytics_zoo_tpu_torch.pipeline.api.onnx import proto as P
    net = OnnxNet(model=P.load_model(resnet_stage1_onnx(P, 32, 10)))
    tensors = list(net.parameters()) + list(net.buffers())
    assert tensors and all(t.device.type == "cuda" for t in tensors)
    out = net(torch.zeros((2, 3, 32, 32), device="cuda"))
    assert out.device.type == "cuda" and out.shape == (2, 10)


@pytest.mark.cuda
def test_cuda_sanitize_guard_catches_implicit_syncs_and_restores(cuda):
    """Under ``sanitize()`` the card's sync debug mode is "error": an
    injected ``.item()``, a blocking ``.cpu()`` or a blocking upload and
    a stream's ``synchronize()`` raise (in a worker thread too), while
    the explicit fetch — a non-blocking copy into pinned memory and an
    event — passes; the entry mode comes back and the listener is
    gone."""
    import threading
    from analytics_zoo_tpu_torch.observability import profile
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    t = torch.arange(8.0, device=cuda)
    torch.cuda.synchronize()
    mode0 = torch.cuda.get_sync_debug_mode()
    caught = []
    with sanitize(max_compiles=0) as rep:
        assert torch.cuda.get_sync_debug_mode() == 2
        for fn in (lambda: t.sum().item(), lambda: t.cpu(),
                   lambda: torch.tensor([1.0], device=cuda),
                   lambda: torch.cuda.current_stream().synchronize()):
            with pytest.raises(RuntimeError, match="synchroniz"):
                fn()

        def worker():
            try:
                t.tolist()
            except RuntimeError as e:
                caught.append(str(e))

        th = threading.Thread(target=worker)
        th.start()
        th.join(60)
        assert not th.is_alive()
        host = t.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    assert caught and "synchroniz" in caught[0]
    assert host.is_pinned() and host.tolist() == list(range(8))
    assert rep.sync_mode_before == mode0 and rep.sync_mode_in_block == 2
    assert torch.cuda.get_sync_debug_mode() == mode0
    assert profile.compile_listeners() == ()
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sanitize(max_compiles=0):
            t.max().item()
    assert torch.cuda.get_sync_debug_mode() == mode0


@pytest.mark.cuda
def test_cuda_hostcopy_passes_the_guard_and_returns_pageable(cuda):
    """``common.hostcopy`` under ``"error"``: a pageable host tensor
    goes up through a pinned block, results come down through pinned
    memory and an event, and ``fetch`` hands back pageable numpy arrays
    with the bits; the pinned blocks stay with torch's host allocator
    (``host_memory`` reads it)."""
    from analytics_zoo_tpu_torch.common import hostcopy
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    from analytics_zoo_tpu_torch.tools.zoolint.sanitizer import host_memory
    rng = np.random.default_rng(9)
    x = rng.normal(size=(64, 1000)).astype(np.float32)
    with sanitize(max_compiles=0):
        dev = hostcopy.upload(torch.from_numpy(x), cuda)
        y, = hostcopy.fetch([dev * 2.0])
        ring = [torch.empty(dev.shape, pin_memory=True)]
        host, events = hostcopy.start_fetch([dev], out=ring)
        hostcopy.wait(events)
    assert not torch.from_numpy(y).is_pinned()
    np.testing.assert_array_equal(y, x * 2.0)
    assert host[0] is ring[0]
    np.testing.assert_array_equal(host[0].numpy(), x)
    mem = host_memory()
    assert mem["rss_bytes"] > 0
    assert mem["pinned"] is None or all(
        isinstance(v, int) for v in mem["pinned"].values())


@pytest.mark.cuda
def test_cuda_warmed_replicated_predict_passes_the_guard(cuda):
    """A warmed two-replica coalesced predict on one card runs under
    ``"error"`` with no build and gives the bits of a blocking fetch of
    the same forward (the pinned non-blocking fetch of ``serving._host``
    changes how the bytes travel, not what they are)."""
    import threading
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    rng = np.random.default_rng(4)
    w = rng.normal(size=(16, 16)).astype(np.float32)
    xs = [rng.normal(size=(1 + i % 4, 16)).astype(np.float32)
          for i in range(12)]
    im = InferenceModel(max_batch_size=4, coalescing=True,
                        supported_concurrent_num=4,
                        replicas=["cuda:0", "cuda:0"])
    try:
        im.load_fn(lambda p, x: torch.tanh(x @ p["w"]), {"w": w})
        im.warmup((16,))
        for x in xs:  # fill the staging rings and the pinned pool
            im.predict(x)
        outs = [None] * len(xs)

        def client(c):
            for i in range(c, len(xs), 3):
                outs[i] = im.predict(xs[i])

        with sanitize(max_compiles=0) as rep:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(3)]
            [t.start() for t in threads]
            [t.join(120) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert rep.compiles == 0
        wd = torch.from_numpy(w).to(cuda)
        for x, o in zip(xs, outs):
            ref = torch.tanh(torch.from_numpy(x).to(cuda) @ wd).cpu()
            assert o is not None and not torch.from_numpy(o).is_pinned()
            np.testing.assert_allclose(o, ref.numpy(), rtol=1e-6,
                                       atol=1e-6)
    finally:
        im.close()


@pytest.mark.cuda
def test_cuda_warmed_decode_engine_passes_the_guard(cuda):
    """The decode engine's admission uploads its prompt non-blocking,
    fills its sampling values on the card and fetches its first token
    through pinned memory and an event; its windows fetch the same way.
    So a warmed engine generates under ``"error"`` with no capture, the
    unguarded run's tokens, and 2 flash_fwd launches an admission."""
    from analytics_zoo_tpu_torch.tools.zoolint import sanitize
    lm = TransformerLM(vocab_size=128, seq_len=96, n_layers=2, d_model=64,
                       n_heads=4, device="cuda", seed=0).eval()
    eng = DecodeEngine(lm, capacity=4, max_len=96, prompt_buckets=(16, 32),
                       prefix_pool=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, n) for n in (5, 20, 17, 30, 9, 16)]
    news = [6, 3, 8, 2, 5, 4]
    try:
        eng.warmup()
        ref = eng.generate(prompts, news, timeout=120)
        before = eng.stats()
        _kernels.reset_launch_counts()
        with sanitize(max_compiles=0) as rep:
            got = eng.generate(prompts, news, timeout=120)
        after = eng.stats()
        computed = (after["admitted"] - before["admitted"]
                    - (after["prefix_hits"] - before["prefix_hits"]))
        assert rep.compiles == 0 and after["captures"] == before["captures"]
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        assert _kernels.launch_counts()["flash_fwd"] >= 2 * computed > 0
    finally:
        eng.close()
