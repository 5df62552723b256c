import torch


def predict(fn, x):  # hot entry point by name
    out = fn(x)
    torch.cuda.synchronize()  # forced sync on the request path
    return out
