import torch


class Scaler:
    def __init__(self, x):
        self._x = x
        self.scale = 1.0

    def set_scale(self, s):
        self.scale = s  # rebound between replays

    def _body(self):
        self._x.mul_(self.scale)  # the capture keeps the value it saw

    def capture(self, g):
        with torch.cuda.graph(g):
            self._body()
