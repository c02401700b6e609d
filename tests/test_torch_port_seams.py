"""The port's seams, on the CPU.

- Every kernel wrapper of ``kernels.KERNELS`` is made by the one launch seam
  (``kernels.card_kernel``) and keeps its rule: on the CPU it returns its
  plain version and counts nothing; on another device it refuses, but for
  ``conv_epilogue``, which takes its plain version for every tensor not on
  the card (RetinaNet's set-up runs the ResNet on ``meta``).
- The layers' arrows point down: the tracer reads the kernels' registry and
  imports no step; the graph layer names no kernel module; nothing under
  ``kernels/`` knows a model's modules (BatchNorm's fold lives in
  ``models/layers.py``); and every function under ``kernels/`` that reaches
  a launch is a registered wrapper. Read from the sources' syntax trees, so
  prose in docstrings does not count.
"""

import ast
import pathlib

import pytest
import torch

from efficientdet_tpu_torch import kernels
from kernel_cases import wrapper_calls

PACKAGE = pathlib.Path(kernels.__file__).resolve().parent.parent
KERNEL_MODULES = sorted((PACKAGE / "kernels").glob("*.py"))


def _name(fn):
    return fn.__name__


@pytest.mark.parametrize("fn", kernels.KERNELS, ids=_name)
def test_wrapper_on_cpu_is_plain_and_not_counted(fn):
    plain, args = wrapper_calls("cpu")[fn.__name__]
    before = fn.launches
    with torch.no_grad():
        got, want = fn(*args), plain(*args)
    assert fn.launches == before
    got, want = ((got, want) if isinstance(got, torch.Tensor)
                 else (got[0], want[0]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("fn", kernels.KERNELS, ids=_name)
def test_wrapper_on_other_devices(fn):
    """``meta`` tensors: refused by every wrapper but ``conv_epilogue``,
    whose plain version gives y's shape and dtype; nothing counted."""
    plain, args = wrapper_calls("meta")[fn.__name__]
    before = fn.launches
    with torch.no_grad():
        if fn.__name__ == "conv_epilogue":
            out = fn(*args)
            assert out.device.type == "meta"
            assert out.shape == args[0].shape and out.dtype == args[0].dtype
        else:
            with pytest.raises(ValueError, match=f"{fn.__name__}: "
                               "unsupported device meta"):
                fn(*args)
    assert fn.launches == before


def _imports(path):
    """The modules ``path`` imports anywhere (function bodies included), as
    absolute dotted names."""
    package = ("efficientdet_tpu_torch." + ".".join(
        path.relative_to(PACKAGE).parent.parts)).rstrip(".")
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return out


def _launchers(tree):
    """Names of the module-level functions of ``tree`` that reach a launch:
    a call of ``_build.call`` or of a Triton kernel (``kernel[grid](...)``),
    directly or through another such function of the module."""
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def calls(fn):
        return [n for n in ast.walk(fn) if isinstance(n, ast.Call)]

    found = {name for name, fn in defs.items() if any(
        isinstance(c.func, ast.Subscript)
        or (isinstance(c.func, ast.Attribute) and c.func.attr == "call"
            and isinstance(c.func.value, ast.Name)
            and c.func.value.id == "_build")
        for c in calls(fn))}
    while True:
        more = {name for name, fn in defs.items() if name not in found and any(
            isinstance(c.func, ast.Name) and c.func.id in found
            for c in calls(fn))}
        if not more:
            return found
        found |= more


@pytest.mark.parametrize("check", ["tracing", "graphed", "kernels", "resnet",
                                   "registry"])
def test_arrows_point_down(check):
    if check == "tracing":
        got = _imports(PACKAGE / "utils" / "tracing.py")
        assert not [m for m in got
                    if m.startswith("efficientdet_tpu_torch.train")]
        assert "efficientdet_tpu_torch.kernels" in got
    elif check == "graphed":
        got = _imports(PACKAGE / "train" / "graphed.py")
        assert "efficientdet_tpu_torch.kernels" in got
        assert not [m for m in got
                    if m.startswith("efficientdet_tpu_torch.kernels.")]
    elif check == "kernels":
        forbidden = {"BatchNorm", "BatchNorm2d", "Module", "running_mean",
                     "running_var"}
        for path in KERNEL_MODULES:
            assert not [m for m in _imports(path)
                        if m.startswith("efficientdet_tpu_torch.models")
                        or m.startswith("torch.nn.modules")], path.name
            tree = ast.parse(path.read_text())
            names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
            attrs = {n.attr for n in ast.walk(tree)
                     if isinstance(n, ast.Attribute)}
            assert not (names | attrs) & forbidden, path.name
    elif check == "resnet":
        got = _imports(PACKAGE / "models" / "resnet.py")
        assert not [m for m in got if "mbconv_kernel" in m]
    else:
        registered = {(fn.__module__, fn.__name__) for fn in kernels.KERNELS}
        assert len(registered) == len(kernels.KERNELS) == 7
        reached = set()
        for path in KERNEL_MODULES:
            module = f"efficientdet_tpu_torch.kernels.{path.stem}"
            for name in _launchers(ast.parse(path.read_text())):
                reached.add((module, name))
                if not name.startswith("_"):
                    assert (module, name) in registered, (module, name)
        assert registered <= reached
