import torch


def advance(pos):
    # the graph records a host buffer freed before the first replay
    pos.add_(torch.tensor([1], device="cuda"))


def capture(g, pos):
    with torch.cuda.graph(g):
        advance(pos)
