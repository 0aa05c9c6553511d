"""The kernel wrappers' allocations, on the CPU.

Every output and workspace a wrapper hands a CUDA kernel comes from
``kernels/_build.py``'s ``empty`` / ``empty_like``, which fill it with NaN
inside ``_build.poisoned()`` (``chip_smoke.py``'s ``[poison]`` phase: a
kernel that leaves an element unwritten, or reads one it did not write,
then shows NaN on every run).  Here: the helper poisons exactly inside the
context, keeps ``empty_like``'s strides, and no wrapper calls
``torch.empty`` itself.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

WRAPPERS = sorted((Path(_build.__file__).parent).glob("*/kernel.py"))


def test_every_kernel_has_a_wrapper_module():
    names = {p.parent.name for p in WRAPPERS}
    assert names == {"fed_agg", "flash_attention", "robust_agg",
                     "rwkv6_scan", "ssm_scan"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_is_nan_only_inside_poisoned(dtype):
    with _build.poisoned():
        t = _build.empty((3, 5), dtype, "cpu")
        assert t.shape == (3, 5) and t.dtype == dtype
        assert bool(torch.isnan(t).all())
        with _build.poisoned():                 # nested: still poisoned
            assert bool(torch.isnan(_build.empty((2,), dtype, "cpu")).all())
        assert bool(torch.isnan(_build.empty((2,), dtype, "cpu")).all())
    assert _build._POISON == [0]
    # outside, a plain torch.empty: not written at all (whatever it holds)
    assert _build.empty((4,), dtype, "cpu").shape == (4,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_like_keeps_the_strides_and_poisons(dtype):
    base = torch.zeros((2, 7, 3, 8), dtype=dtype).transpose(1, 2)
    with _build.poisoned():
        t = _build.empty_like(base)
    assert t.stride() == base.stride() and t.shape == base.shape
    assert t.dtype == dtype and bool(torch.isnan(t).all())


def test_poisoned_leaves_integer_tensors_alone():
    with _build.poisoned():
        t = _build.empty((3,), torch.int64, "cpu")
    assert t.dtype == torch.int64


def test_poisoned_resets_after_an_exception():
    with pytest.raises(RuntimeError):
        with _build.poisoned():
            raise RuntimeError("a failing check")
    assert _build._POISON == [0]


def _calls(tree):
    """(dotted callee name, line) of every call in a module."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            parts = []
            while isinstance(f, ast.Attribute):
                parts.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                parts.append(f.id)
            out.append((".".join(reversed(parts)), node.lineno))
    return out


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.parent.name)
def test_no_wrapper_allocates_with_torch_empty(path):
    """Outputs and workspaces go through ``_build.empty`` /
    ``_build.empty_like`` (zeros and clones are written, and may stay)."""
    calls = _calls(ast.parse(path.read_text()))
    direct = [(name, line) for name, line in calls
              if name in ("torch.empty", "torch.empty_like",
                          "torch.empty_strided")
              or name.endswith(".new_empty")]
    assert direct == []
    assert any(name in ("_build.empty", "_build.empty_like")
               for name, _ in calls)
