"""Homogeneous 4x4 transforms (core/transform.py counterpart).

Stored as (matrix, inverse transpose) like the reference. Constructors run
on the host in numpy (scene building never touches the device); the
application functions take tensors (``scene.from_numpy`` moves a scene's
transforms onto its device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Transform:
    m: object        # (..., 4, 4) numpy array or tensor
    inv_t: object    # (..., 4, 4) inverse transpose

    # -- host-side constructors ---------------------------------------------
    @staticmethod
    def from_matrix(m):
        m = np.asarray(m, dtype=np.float32)
        inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        return Transform(m=m, inv_t=np.swapaxes(inv, -1, -2))

    @staticmethod
    def identity():
        return Transform.from_matrix(np.eye(4, dtype=np.float32))

    @staticmethod
    def translate(v):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = np.asarray(v, dtype=np.float32)
        return Transform.from_matrix(m)

    @staticmethod
    def scale(v):
        v = np.broadcast_to(np.asarray(v, dtype=np.float32), (3,))
        return Transform.from_matrix(
            np.diag(np.concatenate([v, [1.0]]).astype(np.float32)))

    @staticmethod
    def rotate(axis, angle_deg):
        a = np.asarray(axis, dtype=np.float64)
        a = a / np.linalg.norm(a)
        th = np.deg2rad(float(angle_deg))
        c, s = np.cos(th), np.sin(th)
        x, y, z = a
        K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        R = np.eye(3) + s * K + (1 - c) * (K @ K)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = R.astype(np.float32)
        return Transform.from_matrix(m)

    @staticmethod
    def look_at(origin, target, up):
        """Camera-to-world: +z looks at target, +y up, +x left (Mitsuba)."""
        origin = np.asarray(origin, dtype=np.float64)
        dir_ = np.asarray(target, dtype=np.float64) - origin
        dir_ = dir_ / np.linalg.norm(dir_)
        up = np.asarray(up, dtype=np.float64)
        left = np.cross(up / np.linalg.norm(up), dir_)
        left = left / np.linalg.norm(left)
        new_up = np.cross(dir_, left)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = dir_
        m[:3, 3] = origin
        return Transform.from_matrix(m)

    def __matmul__(self, other):
        return Transform(m=self.m @ other.m, inv_t=self.inv_t @ other.inv_t)

    # -- application (tensors) ------------------------------------------------
    def transform_affine_point(self, p):
        return (torch.matmul(self.m[..., :3, :3], p[..., None])[..., 0]
                + self.m[..., :3, 3])

    def transform_vector(self, v):
        return torch.matmul(self.m[..., :3, :3], v[..., None])[..., 0]

    def transform_normal(self, n):
        return torch.matmul(self.inv_t[..., :3, :3], n[..., None])[..., 0]

    def inverse(self):
        # swapaxes: numpy arrays (scene building) and tensors alike
        return Transform(m=self.inv_t.swapaxes(-1, -2),
                         inv_t=self.m.swapaxes(-1, -2))

    @property
    def translation(self):
        return self.m[..., :3, 3]


def as_transform(t) -> Transform:
    """Transform | 4x4 array-like | dict | list of dicts | None, with the
    dict loader's tags: look_at, translate, scale, rotate, matrix. A list
    composes left to right (the last listed is applied last)."""
    if t is None:
        return Transform.identity()
    if isinstance(t, Transform):
        return t
    if isinstance(t, dict):
        kind = t["type"]
        if kind in ("look_at", "lookat"):
            return Transform.look_at(t.get("origin", [0, 0, 0]),
                                     t.get("target", [0, 0, 1]),
                                     t.get("up", [0, 1, 0]))
        if kind == "translate":
            return Transform.translate(t.get("value", [0, 0, 0]))
        if kind == "scale":
            return Transform.scale(t.get("value", 1.0))
        if kind == "rotate":
            return Transform.rotate(t.get("axis", [0, 0, 1]),
                                    t.get("angle", 0.0))
        if kind == "matrix":
            return Transform.from_matrix(
                np.asarray(t["value"], np.float32).reshape(4, 4))
        raise ValueError(f"unknown transform dict type {kind!r}")
    if isinstance(t, (list, tuple)) and t and isinstance(t[0], dict):
        out = Transform.identity()
        for step in t:
            out = as_transform(step) @ out
        return out
    return Transform.from_matrix(np.asarray(t, dtype=np.float32))
