"""The device's roofline ceilings: the analytic spec table and its
calibration on the card."""

from .roofline import (
    BACKEND_SPECS,
    H100_DATASHEET,
    H100_DATASHEET_SFU_S,
    HardwareSpec,
    backend_spec,
)

__all__ = ["BACKEND_SPECS", "H100_DATASHEET", "H100_DATASHEET_SFU_S", "HardwareSpec",
           "backend_spec"]
