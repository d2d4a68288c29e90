import os
import sys
from pathlib import Path

# NOTE: do NOT set xla_force_host_platform_device_count here -- smoke tests
# and benches must see 1 device.  Multi-device tests spawn subprocesses.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped when torch.cuda.is_available() is false"
    )
