"""Vector/transform math over SoA tensors (port of statmc_tpu/core/math.py).

Vectors are tensors shaped [..., 3]; every op broadcasts over leading
batch dimensions.  The numpy transform builders (``look_at``,
``perspective``, ``np_transform_*`` ...) are host code copied unchanged
from statmc_tpu/core/math.py:102-221.
"""
from __future__ import annotations

import numpy as np
import torch

# Large-but-finite ray bound (inf*0 = nan breaks the t-interval math).
INF = 1e30

_CONSTS: dict = {}  # (values, dtype, device) -> tensor


def const(values: tuple, device, dtype=torch.float32):
    """The tensor of `values` (a tuple) on `device`, made once and shared
    by every later call: the bounce step's CUDA graphs
    (render/bounce_graphs.py) cannot copy host data to the card while
    they record.  Callers must not write into it."""
    key = (values, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def sqrt(x):
    """Correctly rounded float32 square root.  PyTorch's vectorized CPU
    sqrt is off by one ulp for ~0.7% of inputs, so CPU tensors take the
    root in float64 and round once (CUDA's sqrtf is already exact)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def fma(a, b, c):
    """Fused multiply-add a*b + c in float32, through float64: the
    product of two floats is exact there (48 bits), and the float64 sum
    rounds to the fused result except when it lands exactly on a
    float32 tie.  Used where the JAX package's compiled CPU program
    contracts a product and a sum."""
    return (a.double() * b.double() + c.double()).float()


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return sqrt(length_squared(v))


def normalize(v, eps: float = 1e-20):
    return v * torch.rsqrt(torch.clamp(length_squared(v), min=eps))[..., None]


def dot_fused(a, b):
    """dot() rounded as XLA's compiled CPU code rounds a 3-term sum of
    products: fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def normalize_fused(v, eps: float = 1e-20):
    """normalize() rounded as the JAX package's compiled CPU code rounds
    it: the sum of squares by dot_fused, the inverse root rounded once
    (XLA's own rsqrt is within an ulp of that).  Used for camera rays,
    whose every ulp moves the hit points downstream."""
    ss = torch.clamp(dot_fused(v, v), min=eps)
    return v * (1.0 / torch.sqrt(ss.double())).float()[..., None]


def coordinate_system(v1):
    """Orthonormal basis around unit v1 (pbrt CoordinateSystem),
    branchless per lane."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    cond = torch.abs(x) > torch.abs(y)
    inv_a = torch.rsqrt(torch.where(cond, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    v2 = torch.where(
        cond[..., None],
        torch.stack([-z * inv_a, zero, x * inv_a], dim=-1),
        torch.stack([zero, z * inv_a, -y * inv_a], dim=-1),
    )
    return v2, cross(v1, v2)


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1)


# ---------------------------------------------------------------------------
# 4x4 transforms.  Host builders are numpy; M maps p' = (M @ [p,1])[:3].
# ---------------------------------------------------------------------------


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(delta) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, dtype=np.float32)
    return m


def scale_mat(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    """Rotation about arbitrary axis (transform.cpp:Rotate)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.radians(angle_deg))
    c = np.cos(np.radians(angle_deg))
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return m.astype(np.float32)


def look_at(eye, look, up) -> np.ndarray:
    """Camera-to-world matrix (transform.cpp:LookAt)."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    rn = np.linalg.norm(right)
    if rn < 1e-12:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right = right / rn
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m.astype(np.float32)


def perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    """Perspective projection (transform.cpp:Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return (scale_mat([inv_tan, inv_tan, 1.0]).astype(np.float64) @ persp).astype(
        np.float32
    )


def _row(r, x, y, z):
    """r0 x + r1 y + r2 z rounded as the JAX package's compiled CPU code
    rounds it (XLA contracts it to fma(r2, z, fma(r0, x, r1 y)))."""
    return fma(r[2], z, fma(r[0], x, r[1] * y))


def _apply33(rows, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([_row(rows[i], x, y, z) for i in range(3)], dim=-1)


def transform_point(m, p):
    """Apply a 4x4 tensor to points [..., 3] with homogeneous divide."""
    r = _apply33(m, p) + m[:3, 3]
    w = _row(m[3], p[..., 0], p[..., 1], p[..., 2]) + m[3, 3]
    return torch.where(torch.abs(w[..., None] - 1.0) < 1e-9, r, r / w[..., None])


def transform_vector(m, v):
    return _apply33(m, v)


def np_transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return np.where(np.abs(w[..., None] - 1.0) < 1e-9, r, r / w[..., None])


def np_transform_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return v @ m[:3, :3].T


def np_transform_normal(m_inv: np.ndarray, n: np.ndarray) -> np.ndarray:
    return n @ m_inv[:3, :3]
