"""Gait definitions as data (port of ``pympc_quadruped_tpu/models/gaits.py``).

A gait is a dataclass of int32 tensors; the phase machinery lives in
:mod:`..ops.gaitsched`, so gaits can carry a scenario axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class GaitParams:
    """One periodic gait: ``num_segments`` MPC segments per cycle; leg ``j``
    is in stance for ``stance_durations[j]`` segments from segment
    ``stance_offsets[j]``."""

    num_segments: torch.Tensor      # int32 scalar
    stance_offsets: torch.Tensor    # (4,) int32
    stance_durations: torch.Tensor  # (4,) int32

    @property
    def total_stance_segments(self) -> torch.Tensor:
        return self.stance_durations[..., 0]

    @property
    def total_swing_segments(self) -> torch.Tensor:
        return self.num_segments - self.stance_durations[..., 0]


def _gait(num_segments, offsets, durations, device) -> GaitParams:
    i32 = dict(dtype=torch.int32, device=device)
    return GaitParams(
        num_segments=torch.tensor(num_segments, **i32),
        stance_offsets=torch.tensor(offsets, **i32),
        stance_durations=torch.tensor(durations, **i32),
    )


class Gaits:
    """The reference's gait library (ref gait.py:16-22), as constructors
    that make their tensors on ``device``."""

    @staticmethod
    def standing(device="cuda") -> GaitParams:
        return _gait(16, [0, 0, 0, 0], [16, 16, 16, 16], device)

    @staticmethod
    def trotting16(device="cuda") -> GaitParams:
        return _gait(16, [0, 8, 8, 0], [8, 8, 8, 8], device)

    @staticmethod
    def trotting10(device="cuda") -> GaitParams:
        return _gait(10, [0, 5, 5, 0], [5, 5, 5, 5], device)

    @staticmethod
    def jumping16(device="cuda") -> GaitParams:
        return _gait(16, [0, 0, 0, 0], [4, 4, 4, 4], device)

    @staticmethod
    def pacing16(device="cuda") -> GaitParams:
        return _gait(16, [8, 0, 8, 0], [8, 8, 8, 8], device)

    @staticmethod
    def pacing10(device="cuda") -> GaitParams:
        return _gait(10, [5, 0, 5, 0], [5, 5, 5, 5], device)

    @staticmethod
    def bounding8(device="cuda") -> GaitParams:
        """Bounding: front pair then rear pair (commented out in the
        reference, ref gait.py:20)."""
        return _gait(8, [4, 4, 0, 0], [4, 4, 4, 4], device)

    @staticmethod
    def by_name(name: str, device="cuda") -> GaitParams:
        return {
            "standing": Gaits.standing,
            "trotting16": Gaits.trotting16,
            "trotting10": Gaits.trotting10,
            "jumping16": Gaits.jumping16,
            "pacing16": Gaits.pacing16,
            "pacing10": Gaits.pacing10,
            "bounding8": Gaits.bounding8,
        }[name](device)
