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


def _gait(num_segments, offsets, durations) -> GaitParams:
    i32 = torch.int32
    return GaitParams(
        num_segments=torch.tensor(num_segments, dtype=i32),
        stance_offsets=torch.tensor(offsets, dtype=i32),
        stance_durations=torch.tensor(durations, dtype=i32),
    )


class Gaits:
    """The reference's gait library (ref gait.py:16-22), as constructors."""

    @staticmethod
    def standing() -> GaitParams:
        return _gait(16, [0, 0, 0, 0], [16, 16, 16, 16])

    @staticmethod
    def trotting16() -> GaitParams:
        return _gait(16, [0, 8, 8, 0], [8, 8, 8, 8])

    @staticmethod
    def trotting10() -> GaitParams:
        return _gait(10, [0, 5, 5, 0], [5, 5, 5, 5])

    @staticmethod
    def jumping16() -> GaitParams:
        return _gait(16, [0, 0, 0, 0], [4, 4, 4, 4])

    @staticmethod
    def pacing16() -> GaitParams:
        return _gait(16, [8, 0, 8, 0], [8, 8, 8, 8])

    @staticmethod
    def pacing10() -> GaitParams:
        return _gait(10, [5, 0, 5, 0], [5, 5, 5, 5])

    @staticmethod
    def bounding8() -> GaitParams:
        """Bounding: front pair then rear pair (commented out in the
        reference, ref gait.py:20)."""
        return _gait(8, [4, 4, 0, 0], [4, 4, 4, 4])

    @staticmethod
    def by_name(name: str) -> GaitParams:
        return {
            "standing": Gaits.standing,
            "trotting16": Gaits.trotting16,
            "trotting10": Gaits.trotting10,
            "jumping16": Gaits.jumping16,
            "pacing16": Gaits.pacing16,
            "pacing10": Gaits.pacing10,
            "bounding8": Gaits.bounding8,
        }[name]()
