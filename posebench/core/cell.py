"""What a driver is given and what it gives back."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class Cell:
    """One cell's files, read: its workload name, configuration and
    traffic mix, the run's seed and device."""

    name: str
    config: dict
    traffic: dict
    seed: int
    device: Any


@dataclasses.dataclass
class Program:
    """A driver's set-up program: ``call(i)`` answers request ``i`` of
    ``n_inputs`` (the window cycles through them); ``state`` holds the
    inputs the reference needs after the program is freed."""

    call: Callable[[int], Any]
    n_inputs: int
    forward_hw: Tuple[int, int]      # network input of one forward
    forward_batch: int               # forward batch of one request
    precision: str                   # "f32" or "int8"
    program_span: Optional[str]      # the port's span prefix, if any
    state: Dict[str, Any]
    free: Callable[[], None]
