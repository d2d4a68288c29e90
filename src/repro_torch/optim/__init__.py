"""The port's optimizer: AdamW (:mod:`.adamw`) and int8 error-feedback
gradient compression (:mod:`.compress`)."""

from . import compress  # noqa: F401
from .adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply_updates,
    global_norm,
    init,
    opt_state_pspecs,
    schedule,
    zero1_pspecs,
)
