import torch


def scale(x):
    return x * float(x.max())  # a sync at capture, frozen in every replay


def capture(g, x):
    with torch.cuda.graph(g):
        scale(x)
