import torch


class Scaler:
    def __init__(self, x):
        self._x = x
        self._scale = torch.ones((), device=x.device)

    def set_scale(self, s):
        self._scale.fill_(s)  # written in place: every replay reads it

    def _body(self):
        self._x.mul_(self._scale)

    def capture(self, g):
        with torch.cuda.graph(g):
            self._body()
