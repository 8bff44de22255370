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

from .math import normalize, widen


@dataclasses.dataclass(frozen=True)
class Transform:
    m: object        # (..., 4, 4) numpy array or tensor
    inv_t: object    # (..., 4, 4) inverse transpose

    # -- host-side constructors ---------------------------------------------
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

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

    @staticmethod
    def perspective(fov_deg, near, far):
        """The projective transform taking the view frustum of ``fov_deg``
        between ``near`` and ``far`` to z in [0, 1] (transform.h
        perspective)."""
        recip = 1.0 / (far - near)
        cot = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
        return Transform.from_matrix(np.array(
            [[cot, 0, 0, 0], [0, cot, 0, 0],
             [0, 0, far * recip, -near * far * recip], [0, 0, 1, 0]],
            dtype=np.float32))

    def __matmul__(self, other):
        return Transform(m=self.m @ other.m, inv_t=self.inv_t @ other.inv_t)

    # -- application (tensors) ------------------------------------------------
    # a float32 point under a float64 transform is widened first, as the
    # reference's promotion widens it
    def transform_affine_point(self, p):
        m = self.m
        return (torch.matmul(m[..., :3, :3], widen(p, m)[..., None])[..., 0]
                + m[..., :3, 3])

    def transform_point(self, p):
        """The projective image of ``p``: divided by its w."""
        m = self.m
        p = widen(p, m)
        ph = torch.matmul(m[..., :3, :3], p[..., None])[..., 0] + m[..., :3, 3]
        w = torch.sum(m[..., 3, :3] * p, dim=-1) + m[..., 3, 3]
        return ph / w[..., None]

    def transform_vector(self, v):
        return torch.matmul(self.m[..., :3, :3],
                            widen(v, self.m)[..., None])[..., 0]

    def transform_normal(self, n):
        return torch.matmul(self.inv_t[..., :3, :3],
                            widen(n, self.inv_t)[..., None])[..., 0]

    def transform_unit_vector(self, v):
        return normalize(self.transform_vector(v))

    def transform_ray(self, o, d):
        """(origin, direction) of a ray under the transform."""
        return self.transform_affine_point(o), self.transform_vector(d)

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


@dataclasses.dataclass(frozen=True)
class AnimatedTransform:
    """Keyframed rigid + scale transform (transform.h:364).

    Keyframe matrices are polar-decomposed on the host into (translation,
    rotation quaternion, symmetric 3x3 stretch), as the reference does;
    ``eval(time)`` lerps translation and stretch, slerps the rotation and
    recomposes, clamped outside the keyframe range. The fields are numpy
    arrays when built and tensors on the scene's device in a Scene."""

    times: object         # (K,)
    translations: object  # (K, 3)
    quats: object         # (K, 4) (w, x, y, z), sign-aligned
    stretches: object     # (K, 3, 3)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_keyframes(frames):
        """frames: (time, anything as_transform accepts) pairs, at least
        one, times strictly increasing."""
        ts, trs, qs, ss = [], [], [], []
        for t, tr in frames:
            m = np.asarray(as_transform(tr).m, np.float64)
            u, sig, vt = np.linalg.svd(m[:3, :3])  # a = R S, S symmetric
            r = u @ vt
            if np.linalg.det(r) < 0:  # keep a proper rotation
                u[:, -1] *= -1.0
                sig[-1] *= -1.0
                r = u @ vt
            ts.append(float(t))
            trs.append(m[:3, 3])
            q = _mat_to_quat(r)
            if qs and np.dot(qs[-1], q) < 0:
                q = -q  # shortest-arc slerp
            qs.append(q)
            ss.append(vt.T @ np.diag(sig) @ vt)
        f32 = lambda a: np.asarray(a, np.float32)
        return AnimatedTransform(times=f32(ts), translations=f32(trs),
                                 quats=f32(qs), stretches=f32(ss))

    def eval(self, time) -> Transform:
        """The Transform at ``time`` (a tensor; batched like it, except
        for a single keyframe)."""
        times, trs, quats, st = (torch.as_tensor(a) for a in (
            self.times, self.translations, self.quats, self.stretches))
        k = times.shape[0]
        if k == 1:
            return _compose(_quat_to_mat(quats[0]) @ st[0], trs[0])
        time = torch.as_tensor(time, dtype=torch.float32,
                               device=times.device)
        i1 = torch.clamp(torch.searchsorted(times, time, right=True), 1,
                         k - 1)
        i0 = i1 - 1
        t0, t1 = times[i0], times[i1]
        f = torch.clamp((time - t0) / torch.clamp(t1 - t0, min=1e-12), 0.0,
                        1.0)
        trans = (1 - f)[..., None] * trs[i0] + f[..., None] * trs[i1]
        stretch = ((1 - f)[..., None, None] * st[i0]
                   + f[..., None, None] * st[i1])
        q0, q1 = quats[i0], quats[i1]
        dot = torch.sum(q0 * q1, dim=-1)
        q1 = torch.where(dot[..., None] < 0, -q1, q1)
        dot = torch.abs(dot)
        theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
        sin_t = torch.sin(theta)
        lerp = sin_t < 1e-4
        den = torch.where(lerp, 1.0, sin_t)
        w0 = torch.where(lerp, 1 - f, torch.sin((1 - f) * theta) / den)
        w1 = torch.where(lerp, f, torch.sin(f * theta) / den)
        q = w0[..., None] * q0 + w1[..., None] * q1
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        return _compose(_quat_to_mat(q) @ stretch, trans)


def _mat_to_quat(r):
    """3x3 rotation -> (w, x, y, z) quaternion (numpy, float64)."""
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2.0
        return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w),
                         (r[0, 2] - r[2, 0]) / (4 * w),
                         (r[1, 0] - r[0, 1]) / (4 * w)])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    x = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 0.0)) / 2.0
    q = np.zeros(4)
    q[1 + i] = x
    q[0] = (r[k, j] - r[j, k]) / (4 * x)
    q[1 + j] = (r[j, i] + r[i, j]) / (4 * x)
    q[1 + k] = (r[k, i] + r[i, k]) / (4 * x)
    return q


def _quat_to_mat(q):
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1)], dim=-2)


def _compose(m3, trans):
    """(batched) 3x3 and translation -> Transform with its inverse
    transpose."""
    batch = m3.shape[:-2]
    inv3 = torch.linalg.inv(m3)
    bottom = torch.zeros(batch + (1, 4), dtype=m3.dtype, device=m3.device)
    bottom[..., 0, 3] = 1.0
    m = torch.cat([torch.cat([m3, trans[..., None]], dim=-1), bottom], dim=-2)
    inv = torch.cat([torch.cat([inv3, -(inv3 @ trans[..., None])], dim=-1),
                     bottom], dim=-2)
    return Transform(m=m, inv_t=inv.transpose(-1, -2))


def as_animated_transform(t):
    """An AnimatedTransform for an animation dict ({'type': 'animation',
    'keyframes': [[time, transform], ...]}), else None (a static transform
    for as_transform)."""
    if isinstance(t, AnimatedTransform):
        return t
    if isinstance(t, dict) and t.get("type") == "animation":
        return AnimatedTransform.from_keyframes(t["keyframes"])
    return None
