"""Lie-group classes with operator sugar over one tensor (port of
rampvo_tpu/lie/groups.py, whose API mirrors the reference's lietorch:
SE3/SO3/Sim3/RxSO3, `*`, .inv(), .log(), .exp, .act/act4 via `*` on
points, .adjT, .matrix, .retr, .scale, indexing), over the functional
ops in `ops.py`. Plain classes: no pytree registration.
"""

from __future__ import annotations

import torch

from . import ops

__all__ = ["SO3", "SE3", "RxSO3", "Sim3", "stack"]


class _LieGroup:
    """Thin tensor wrapper; subclasses bind the functional ops."""

    N: int          # embedding dim
    K: int          # tangent dim
    _id: tuple      # indices set to 1 in the identity

    def __init__(self, data):
        self.data = torch.as_tensor(data)

    @property
    def shape(self):
        return self.data.shape[:-1]

    def __getitem__(self, index):
        return type(self)(self.data[index])

    def __repr__(self):
        return f"{type(self).__name__}(shape={tuple(self.shape)})"

    @classmethod
    def exp(cls, xi):
        return cls(cls._exp(xi))

    def log(self):
        return self._log(self.data)

    def inv(self):
        return type(self)(self._inv(self.data))

    def mul(self, other):
        return type(self)(self._mul(self.data, other.data))

    def act(self, p):
        return self._act(self.data, p)

    def __mul__(self, other):
        if isinstance(other, _LieGroup):
            return self.mul(other)
        # group action on points: 4-vectors use act4 where defined
        other = torch.as_tensor(other)
        if other.shape[-1] == 4 and hasattr(self, "_act4"):
            return self._act4(self.data, other)
        return self.act(other)

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device=None):
        base = torch.zeros(cls.N, dtype=dtype, device=device)
        base[list(cls._id)] = 1.0
        return cls(base.expand(tuple(shape) + (cls.N,)).clone())

    @classmethod
    def IdentityLike(cls, other):
        return cls.Identity(*other.shape, dtype=other.data.dtype,
                            device=other.data.device)

    def retr(self, xi):
        return type(self).exp(xi) * self


class SO3(_LieGroup):
    N, K, _id = 4, 3, (3,)
    _exp = staticmethod(ops.so3_exp)
    _log = staticmethod(ops.so3_log)
    _inv = staticmethod(ops.so3_inv)
    _mul = staticmethod(ops.so3_mul)
    _act = staticmethod(ops.so3_act)

    def matrix(self):
        return ops.quat_to_matrix(self.data)


class SE3(_LieGroup):
    N, K, _id = 7, 6, (6,)
    _exp = staticmethod(ops.se3_exp)
    _log = staticmethod(ops.se3_log)
    _inv = staticmethod(ops.se3_inv)
    _mul = staticmethod(ops.se3_mul)
    _act = staticmethod(ops.se3_act)
    _act4 = staticmethod(ops.se3_act4)

    def adj(self, x):
        return ops.se3_adj(self.data, x)

    def adjT(self, x):
        return ops.se3_adjT(self.data, x)

    def matrix(self):
        return ops.se3_matrix(self.data)

    def retr(self, xi):
        return SE3(ops.se3_retr(self.data, xi))

    def scale(self, s):
        """Scale the translation part (lietorch SE3.scale semantics)."""
        s = torch.as_tensor(s, dtype=self.data.dtype, device=self.data.device)
        if s.ndim < self.data.ndim:
            s = s[..., None]
        return SE3(torch.cat([self.data[..., :3] * s, self.data[..., 3:7]],
                             dim=-1))

    def translation(self):
        return self.data[..., :3]

    def normalize(self):
        return SE3(ops.se3_normalize(self.data))


class RxSO3(_LieGroup):
    N, K, _id = 5, 4, (3, 4)
    _exp = staticmethod(ops.rxso3_exp)
    _log = staticmethod(ops.rxso3_log)
    _inv = staticmethod(ops.rxso3_inv)
    _mul = staticmethod(ops.rxso3_mul)
    _act = staticmethod(ops.rxso3_act)


class Sim3(_LieGroup):
    N, K, _id = 8, 7, (6, 7)
    _exp = staticmethod(ops.sim3_exp)
    _log = staticmethod(ops.sim3_log)
    _inv = staticmethod(ops.sim3_inv)
    _mul = staticmethod(ops.sim3_mul)
    _act = staticmethod(ops.sim3_act)


def stack(groups, axis=0):
    """lietorch.stack equivalent."""
    return type(groups[0])(torch.stack([g.data for g in groups], dim=axis))
