import torch


def step(x):
    if x.dim() == 2 and x.shape[0] > 1:  # host metadata: fine
        x.copy_(torch.where(x.sum() > 0, x * 2, x))


def capture(g, x):
    with torch.cuda.graph(g):
        step(x)
