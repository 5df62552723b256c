import torch


def step(out, x):
    out.copy_(x * 2)
    return x.cpu()  # a host copy at capture that no replay repeats


def capture(g, out, x):
    with torch.cuda.graph(g):
        step(out, x)
