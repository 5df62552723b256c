import torch


def build_all(xs, step):
    graphs = []
    for x in xs:
        g = torch.cuda.CUDAGraph()  # a fresh capture per iteration
        with torch.cuda.graph(g):
            step(x)
        graphs.append(g)
    return graphs
