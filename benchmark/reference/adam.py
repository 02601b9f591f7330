"""Adam (Kingma and Ba, 2015) with bias correction, no weight decay, the
update written out step by step."""

from __future__ import annotations

import math


class Adam:
    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = params
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = {k: v.new_zeros(v.shape) for k, v in params.items()}
        self.v = {k: v.new_zeros(v.shape) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict):
        b1, b2 = self.betas
        self.t += 1
        bc1 = 1.0 - b1 ** self.t
        bc2 = 1.0 - b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.m[k] + (g - self.m[k]) * (1.0 - b1)
            self.v[k] = self.v[k] * b2 + g * g * (1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            self.params[k] = self.params[k] - (self.lr / bc1) * (
                self.m[k] / denom)
