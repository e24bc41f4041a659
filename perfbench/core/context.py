"""What a driver gets for one run, and the seeds it derives."""

from __future__ import annotations

import dataclasses
import hashlib
import sys
from pathlib import Path

from .trace import Tracer


def derive(seed: int, tag: str) -> int:
    """An independent 62-bit seed for one use (weights, training, traffic)
    of the run's ``--seed``, so that no two generators share a stream."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


@dataclasses.dataclass
class Context:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    out_dir: Path
    tracer: Tracer = None
    setup_phases: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(self.trace, self.out_dir)

    def log(self, msg: str) -> None:
        print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
