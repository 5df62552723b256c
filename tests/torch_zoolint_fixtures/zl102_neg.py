import torch


class Runner:
    def __init__(self, step):
        self.step = step
        self.graph = None

    def build(self, buf):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self.step(buf)
        self.graph = g  # kept: every later call only replays

    def run(self):
        self.graph.replay()
