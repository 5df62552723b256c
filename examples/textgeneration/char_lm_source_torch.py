"""Train the zoo's TransformerLM on REAL text with the PyTorch/CUDA port:
the port package's own source code, character-level.

The port of ``char_lm_source.py``.  Every other text dataset in the
reference's gallery (aclImdb, news20) is download-gated, so this example
uses the one large real corpus any checkout always has — itself, read as
text (nothing is downloaded).  The model family, losses, and decode path
are exactly what a user would run on their own corpus: build integer
windows, `compile("adam", "class_nll")`, `fit`, then `generate()` from a
KV cache; on a card attention runs the hand-written flash kernels.

Reports validation bits-per-character (the LM-quality unit; uniform
over the ~100-char vocabulary is ~6.6 bpc) and samples a code-shaped
continuation from a ``def `` prompt.

Run:  python char_lm_source_torch.py --epochs 4 [--device cpu]
"""

import argparse
import glob
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def load_corpus(root):
    files = sorted(glob.glob(os.path.join(root, "**", "*.py"),
                             recursive=True))
    if not files:
        raise SystemExit(f"no .py files under {root}")
    parts = []
    for f in files:
        # errors="replace": one stray non-UTF-8 file must not abort a
        # whole-corpus read
        with open(f, encoding="utf-8", errors="replace") as fh:
            parts.append(fh.read())
    text = "\n\n".join(parts)
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    return text, chars, stoi


def windows(text, stoi, seq_len):
    ids = np.array([stoi[c] for c in text], np.int32)
    n = (len(ids) - 1) // seq_len
    x = ids[:n * seq_len].reshape(n, seq_len)
    y = ids[1:n * seq_len + 1].reshape(n, seq_len)
    p = np.random.RandomState(0).permutation(n)
    return x[p], y[p]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(
                        REPO, "analytics_zoo_tpu_torch"),
                    help="directory whose .py files form the corpus")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--limit-seqs", type=int, default=0,
                    help="cap training windows (0 = all; tests use a cap)")
    ap.add_argument("--max-new", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu to run without a card")
    args = ap.parse_args(argv)
    if args.seq_len < 8:
        ap.error("--seq-len must be >= 8 (the demo prompts with 4 "
                 "chars and decodes at least a few more)")

    from analytics_zoo_tpu_torch.common import init_nncontext
    from analytics_zoo_tpu_torch.models import TransformerLM

    init_nncontext("char-lm-on-source", device=args.device)
    text, chars, stoi = load_corpus(args.data)
    x, y = windows(text, stoi, args.seq_len)
    if len(x) < 4:
        raise SystemExit(
            f"corpus too small: only {len(x)} windows of {args.seq_len} "
            "chars — point --data at a larger directory")
    n_val = min(max(64, len(x) // 20), len(x) // 2)
    x_tr, y_tr = x[n_val:], y[n_val:]
    x_va, y_va = x[:n_val], y[:n_val]
    if args.limit_seqs:
        x_tr, y_tr = x_tr[:args.limit_seqs], y_tr[:args.limit_seqs]
    print(f"corpus: {len(text):,} chars, vocab {len(chars)}, "
          f"{len(x_tr)} train / {len(x_va)} val windows")

    lm = TransformerLM(vocab_size=len(chars), seq_len=args.seq_len,
                       n_layers=2, d_model=128, n_heads=4,
                       device=args.device)
    lm.compile({"name": "adam", "lr": 3e-3}, "class_nll",
               metrics=["accuracy"])
    lm.fit(x_tr, y_tr, batch_size=128, nb_epoch=args.epochs)

    res = lm.evaluate(x_va, y_va, batch_size=128)
    bpc = res["loss"] / np.log(2)
    print(f"val accuracy {res['accuracy']:.3f}  "
          f"bits/char {bpc:.2f} (uniform {np.log2(len(chars)):.2f})")

    prompt_text = "def "
    prompt = np.array([[stoi[c] for c in prompt_text]], np.int32)
    n_new = min(args.max_new, args.seq_len - prompt.shape[1])
    out = lm.generate(prompt, max_new_tokens=n_new, temperature=0.6,
                      top_k=8, seed=0)
    sample = "".join(chars[i] for i in np.asarray(out)[0])
    print("sample:")
    print(sample)
    print("char lm on real source done")


if __name__ == "__main__":
    main()
