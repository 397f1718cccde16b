"""Procedural terrain heightfields (port of ``env/terrain.py``).

A terrain is data: a regular height grid with a bilinear height query, so
terrain is one more randomization axis of a sweep.  A ``Terrain`` may carry
leading scenario axes (``tree.tile`` of one grid, or a stack of grids, one
per scenario); :func:`height_at` then takes points whose leading axes start
with the same scenario axes.  The generators build one grid on ``device``;
:func:`random_rough` draws from a ``torch.Generator`` and smooths in
:func:`smooth_heights`, which also takes any raw grid.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Terrain:
    """Regular-grid heightfield.

    ``height[..., i, j]`` is the ground z at ``origin + (i*cell, j*cell)``.
    World coordinates outside the grid clamp to the border (flat beyond).
    """

    height: torch.Tensor   # (..., H, W) float32
    cell: torch.Tensor     # (...) grid spacing in meters
    origin: torch.Tensor   # (..., 2) world xy of grid node (0, 0)

    @property
    def extent(self):
        H, W = self.height.shape[-2:]
        return (H - 1) * self.cell, (W - 1) * self.cell


def _grid(size: float, cell: float) -> int:
    return int(round(size / cell)) + 1


def _terrain(h: torch.Tensor, size: float, cell: float) -> Terrain:
    f32 = dict(dtype=torch.float32, device=h.device)
    return Terrain(height=h.to(torch.float32).contiguous(),
                   cell=torch.tensor(cell, **f32),
                   origin=torch.tensor([-size / 2, -size / 2], **f32))


def _coord(n: int, cell: float, device) -> torch.Tensor:
    """``arange(n) * cell`` in float32, as the JAX generators compute it."""
    return torch.arange(n, dtype=torch.float32, device=device) * cell


def flat(size: float = 20.0, cell: float = 0.1, device="cuda") -> Terrain:
    n = _grid(size, cell)
    return _terrain(torch.zeros((n, n), device=device), size, cell)


def slope(grade: float, size: float = 20.0, cell: float = 0.1, axis: int = 0,
          device="cuda") -> Terrain:
    """Uniform slope: z = grade * distance along ``axis``."""
    n = _grid(size, cell)
    h = grade * _coord(n, cell, device)
    h2d = h[:, None] if axis == 0 else h[None, :]
    return _terrain(h2d.expand(n, n), size, cell)


def stairs(step_width: float, step_height: float, size: float = 20.0,
           cell: float = 0.05, axis: int = 0, device="cuda") -> Terrain:
    """Ascending stairs along ``axis``."""
    n = _grid(size, cell)
    h = torch.floor(_coord(n, cell, device) / step_width) * step_height
    h2d = h[:, None] if axis == 0 else h[None, :]
    return _terrain(h2d.expand(n, n), size, cell)


def pyramid(slope_grade: float, platform: float = 1.0, size: float = 20.0,
            cell: float = 0.1, device="cuda") -> Terrain:
    """Pyramid with a flat central platform."""
    n = _grid(size, cell)
    coord = _coord(n, cell, device) - size / 2
    dx = coord.abs()[:, None]
    dy = coord.abs()[None, :]
    d = torch.clamp(torch.maximum(dx, dy) - platform / 2, min=0.0)
    peak = slope_grade * (size / 2 - platform / 2)
    return _terrain(peak - slope_grade * d, size, cell)


def smooth_heights(h: torch.Tensor, smooth: int = 2) -> torch.Tensor:
    """``smooth`` passes of a 3x3 box filter over an edge-padded (..., n, n)
    grid (JAX: ``convolve2d`` of the edge-padded grid, mode ``valid``)."""
    k = torch.full((), 1.0 / 9.0, dtype=torch.float32)
    n0, n1 = h.shape[-2:]
    for _ in range(smooth):
        hp = torch.cat([h[..., :1, :], h, h[..., -1:, :]], dim=-2)
        hp = torch.cat([hp[..., :1], hp, hp[..., -1:]], dim=-1)
        acc = torch.zeros_like(h)
        for i in range(3):
            for j in range(3):
                acc = acc + hp[..., i:i + n0, j:j + n1] * k
        h = acc
    return h


def random_rough(generator: torch.Generator, amplitude: float = 0.03,
                 size: float = 20.0, cell: float = 0.1, smooth: int = 2,
                 device="cuda") -> Terrain:
    """Uniform random roughness in [-amplitude, amplitude), box-smoothed
    ``smooth`` times; deterministic for a seeded ``generator`` (a generator
    on ``device``)."""
    n = _grid(size, cell)
    u = torch.rand((n, n), generator=generator, dtype=torch.float32, device=device)
    h = -amplitude + u * (2.0 * amplitude)
    return _terrain(smooth_heights(h, smooth), size, cell)


def height_at(terrain: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear ground height at world ``xy`` (..., 2) -> (...,).

    The terrain's leading (scenario) axes must lead ``xy``'s as well; an
    unbatched terrain answers points of any shape.  Gathers only, so it
    runs inside a captured CUDA graph."""
    lead = terrain.cell.shape
    H, W = terrain.height.shape[-2:]
    pts = xy.shape[len(lead):-1]
    expand = lambda t: t.reshape(lead + (1,) * len(pts) + t.shape[len(lead):])
    uv = (xy - expand(terrain.origin)) / expand(terrain.cell)[..., None]
    u = torch.clamp(uv[..., 0], 0.0, H - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, W - 1.001)
    i0 = torch.floor(u).to(torch.int32)
    j0 = torch.floor(v).to(torch.int32)
    fu = u - i0
    fv = v - j0
    flat_h = terrain.height.reshape(lead + (H * W,))
    idx = (i0 * W + j0).long().reshape(lead + (-1,))
    at = lambda off: torch.gather(flat_h, -1, idx + off).reshape(u.shape)
    h00, h10, h01, h11 = at(0), at(W), at(1), at(W + 1)
    return (
        h00 * (1 - fu) * (1 - fv)
        + h10 * fu * (1 - fv)
        + h01 * (1 - fu) * fv
        + h11 * fu * fv
    )


def normal_at(terrain: Terrain, xy: torch.Tensor, delta: float = 0.05) -> torch.Tensor:
    """Finite-difference unit surface normal at world ``xy`` (..., 2) -> (..., 3)."""
    x, y = xy[..., 0], xy[..., 1]
    at = lambda px, py: height_at(terrain, torch.stack([px, py], dim=-1))
    dzdx = (at(x + delta, y) - at(x - delta, y)) / (2 * delta)
    dzdy = (at(x, y + delta) - at(x, y - delta)) / (2 * delta)
    n = torch.stack([-dzdx, -dzdy, torch.ones_like(dzdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
