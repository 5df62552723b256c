"""TransformerLM end to end on the PyTorch/CUDA port: train the zoo's
decoder-only LM on a character-level copy task and sample from it.

The port of ``transformer_lm_example.py``: Embedding +
PositionalEmbedding -> pre-norm MultiHeadSelfAttention blocks (causal;
on a card the hand-written flash kernels forward and backward) ->
log-softmax head trained with class_nll on next-token targets, then
greedy, top-k and beam decoding from a KV cache.

Run:  python transformer_lm_example_torch.py [--device cpu]
"""

import argparse

import numpy as np


def char_dataset(n_seqs, seq_len, vocab, seed=0):
    """Periodic integer sequences — deterministic next-token structure
    a causal LM can learn quickly."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 5, n_seqs)
    start = rng.integers(0, vocab, n_seqs)
    toks = (start[:, None]
            + step[:, None] * np.arange(seq_len + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)
    if args.seq_len < 4:
        ap.error("--seq-len must be >= 4 (the demo prompts with "
                 "seq_len//2 tokens and checks the learned stride)")

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models import TransformerLM

    init_nncontext("TransformerLM example", device=args.device)
    x, y = char_dataset(512, args.seq_len, args.vocab)

    lm = TransformerLM(vocab_size=args.vocab, seq_len=args.seq_len,
                       n_layers=2, d_model=64, n_heads=4,
                       device=args.device)
    lm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll",
               metrics=["accuracy"])
    lm.fit(x, y, batch_size=64, nb_epoch=args.epochs)
    res = lm.evaluate(x, y, batch_size=64)
    print(f"next-token accuracy: {res['accuracy']:.3f} "
          f"(unigram floor ~{1 / args.vocab:.3f})")

    # KV-cache decode (greedy here; temperature/top_k sample instead).
    # prompt_len + max_new_tokens must fit the model's max_len (= seq_len
    # here)
    p_len = min(8, args.seq_len // 2)
    n_new = min(12, args.seq_len - p_len)
    prompt = x[:1, :p_len]
    out = lm.generate(prompt, max_new_tokens=n_new, temperature=0.0)
    generated = np.asarray(out)[0, p_len:].tolist()
    print("greedy continuation:", generated)

    # the trained structure is periodic — the continuation must keep the
    # prompt's stride
    stride = int((prompt[0, 1] - prompt[0, 0]) % args.vocab)
    want = [(int(prompt[0, -1]) + stride * (i + 1)) % args.vocab
            for i in range(n_new)]
    match = np.mean([g == w for g, w in zip(generated, want)])
    print(f"continuation matches the learned cycle at {match:.0%}")

    sampled = lm.generate(prompt, max_new_tokens=n_new, temperature=0.8,
                          top_k=4, seed=1)
    print("top-k sample:", np.asarray(sampled)[0, p_len:].tolist())

    beam = lm.generate(prompt, max_new_tokens=n_new, num_beams=4)
    print("beam-4 continuation:", np.asarray(beam)[0, p_len:].tolist())
    print("transformer lm example done")


if __name__ == "__main__":
    main()
