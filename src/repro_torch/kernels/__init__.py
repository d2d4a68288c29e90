"""Hand-written CUDA kernels of the port and their wrappers.

``csrc/`` holds the sources (built by :mod:`.build` at first use);
:mod:`.btf`, :mod:`.bts`, :mod:`.fused_spike` and :mod:`.bcr` are the
wrappers, each with its launch counter; :mod:`.ops` is the public dispatch layer.
"""
