"""Hand-written CUDA kernels of the port and their wrappers.

``csrc/`` holds the sources (built by :mod:`.build` at first use);
:mod:`.btf`, :mod:`.bts`, :mod:`.fused_spike`, :mod:`.bcr`, :mod:`.wkv`,
:mod:`.ssd` and :mod:`.flash_attn` are the wrappers, each with its launch
counter; :mod:`.ref` holds the plain versions of the two scan kernels and
of flash attention; :mod:`.ops` is the public dispatch layer.
"""

from . import ops, ref  # noqa: F401
from .ops import block_tridiag_factor, block_tridiag_solve, ssd, wkv6  # noqa: F401
