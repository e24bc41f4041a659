import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


def pytest_sessionstart(session):
    # a test run's workers share the host's cores: one torch thread each
    import torch

    torch.set_num_threads(1)
