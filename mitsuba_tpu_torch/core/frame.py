"""Shading frames (port of ``mitsuba_tpu/core/frame.py``): three (..., 3)
tensors (s, t, n); in local coordinates the normal is +Z, so
cos_theta(w) = w.z."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m


class Frame(NamedTuple):
    s: torch.Tensor  # (..., 3) tangent
    t: torch.Tensor  # (..., 3) bitangent
    n: torch.Tensor  # (..., 3) normal

    @staticmethod
    def from_normal(n):
        s, t = m.coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v):
        return torch.stack(
            [m.dot(v, self.s), m.dot(v, self.t), m.dot(v, self.n)], dim=-1
        )

    def to_world(self, v):
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )


def cos_theta(w):
    return w[..., 2]


def sin_theta_2(w):
    return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)


def sin_theta(w):
    """sqrt(sin_theta_2), through ``safe_sqrt`` for its gradient of 0 at 0
    (a sampled direction on the normal; the values are sqrt's)."""
    return m.safe_sqrt(sin_theta_2(w))


def tan_theta(w):
    return m.safe_div(sin_theta(w), w[..., 2])
