import torch


def step(out, x):
    out.copy_(x * 2)  # the replay's result stays on the device


def capture(g, out, x):
    with torch.cuda.graph(g):
        step(out, x)


def fetch(g, out, host):
    g.replay()
    host.copy_(out, non_blocking=True)  # after the replay, into pinned
