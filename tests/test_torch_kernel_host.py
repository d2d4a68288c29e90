"""Host-side pieces of the port's kernel layer, on the CPU: the operand
checks every card wrapper runs before a launch, and the build cache's key.

The card wrappers write their outputs through raw pointers, so a CUDA
output carries no autograd graph; the checks refuse an operand that
requires grad while grad mode is on, so a loss through a kernel cannot
silently lose its gradient.  The build names each library by a hash of
its source, every header and the flags, so an edit to any header
rebuilds every kernel.
"""

import shutil

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import check_operands
from repro_torch.kernels.flash_attn import check_card_operands


def test_check_operands_refuses_an_operand_that_requires_grad():
    x = torch.zeros(2, 3, requires_grad=True)
    y = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="btf: e requires grad"):
        check_operands("btf", torch.device("cpu"), d=y, e=x)
    with torch.no_grad():
        check_operands("btf", torch.device("cpu"), d=y, e=x)
    check_operands("btf", torch.device("cpu"), d=y, e=x.detach())


def test_flash_operand_check_refuses_an_operand_that_requires_grad():
    q, k, v = (torch.zeros(1, 2, 64, 64) for _ in range(3))
    k.requires_grad_(True)
    with pytest.raises(ValueError, match="flash_attention: k requires grad"):
        check_card_operands(q, k, v)
    with torch.no_grad():
        check_card_operands(q, k, v)


@pytest.mark.parametrize("header", ["common.cuh", "gj_cluster.cuh"])
@pytest.mark.parametrize("name", build.SOURCES)
def test_library_path_changes_with_any_header(tmp_path, monkeypatch, name, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._library_path(name)
    assert build._library_path(name) == before  # the key is stable
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    assert build._library_path(name) != before


def test_library_path_changes_with_a_new_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._library_path("btf")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build._library_path("btf") != before
