"""The port's CUDA kernels on the card (marker ``cuda``).

Each kernel against its plain PyTorch version, one backward of the
attention layer through the kernels, LeNet (a Sequential of
Convolution2D, MaxPooling2D, Flatten, Dense) fitting, predicting, saved
and loaded on the card, and the serving plane: the decode engine's CUDA
graphs, its admissions' kernel launches, coalesced predict, and the
engine's and coalescer's streams waiting for the caller's writes. This
file imports no jax (nor does anything it imports), so that it runs on a
GPU host without the JAX package: ``python -m pytest --noconftest
tests/test_torch_cuda.py -m cuda``. Without a card every test skips
inside the ``cuda`` fixture.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models import (TransformerLM, from_jax_params,
                                            to_jax_params)
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential, load_model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution2D, Dense, Dropout, Flatten, MaxPooling2D,
    MultiHeadSelfAttention)
from analytics_zoo_tpu_torch.pipeline.inference import DecodeEngine


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
    a device sleep of about a second: work that does not wait for the
    default stream reads the old weights."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 31)
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
