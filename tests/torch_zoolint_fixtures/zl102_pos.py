import torch


class Runner:
    def __init__(self, step):
        self.step = step

    def run(self, buf):
        g = torch.cuda.CUDAGraph()  # captured and replayed per call
        with torch.cuda.graph(g):
            self.step(buf)
        g.replay()
