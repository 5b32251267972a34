"""Import guard of the PyTorch port: ``unitex_torch/`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``unitex_tpu`` (the port
keeps its own copies of the host modules it needs), and import ``triton``
only inside functions, so the CPU test run can import every module.  Also:
the port's entry points default to CUDA and raise, rather than fall back
to the CPU, when there is no card."""

import ast
import importlib
import os
import pkgutil

import pytest
import torch

import unitex_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "unitex_tpu")


def _sources():
    root = os.path.join(REPO, "unitex_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_names(tree):
    """(module name, is at module level) of every import in ``tree``,
    including ``importlib.import_module("...")`` and ``__import__("...")``
    with a literal name."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        at_top = id(node) in top
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, at_top
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module, at_top
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__"):
                yield node.args[0].value, False


def test_guard_sees_every_source():
    files = _sources()
    assert len(files) > 30
    assert os.path.join(REPO, "unitex_torch", "ops", "attention.py") in files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for name, at_top in _imported_names(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
        assert not (root == "triton" and at_top), \
            f"{path} imports triton at module level"


def test_every_module_imports_without_a_card():
    names = [m.name for m in pkgutil.walk_packages(unitex_torch.__path__, "unitex_torch.")]
    assert "unitex_torch.ops.attention" in names
    for name in names:
        importlib.import_module(name)


def test_native_build_is_not_walked_as_a_module():
    """The g++ build of ``native/meshproc.cpp`` lands in the git-ignored
    ``unitex_torch/_build/``, which is no package: once a mesh has been
    decimated, the walk of :func:`test_every_module_imports_without_a_card`
    still meets only importable modules (a ``_meshproc.so`` beside its
    source had been walked as the extension module
    ``unitex_torch.native._meshproc`` and failed to import)."""
    from unitex_torch.native import meshproc

    build_dir = os.path.join(REPO, "unitex_torch", "_build")
    assert os.path.dirname(meshproc._SO) == build_dir
    assert not os.path.exists(os.path.join(build_dir, "__init__.py"))
    if meshproc.available():
        assert os.path.exists(meshproc._SO)
    assert not os.path.exists(os.path.join(REPO, "unitex_torch", "native",
                                           "_meshproc.so"))
    names = [m.name for m in pkgutil.walk_packages(unitex_torch.__path__,
                                                   "unitex_torch.")]
    assert not [n for n in names if "._build" in n or "_meshproc" in n]
    for name in names:
        importlib.import_module(name)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    import inspect

    from unitex_torch.models.flux.model import init_flux_params
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline, RGBTextureFullPipelineBase
    from unitex_torch.utils.precision import resolve_device

    from unitex_torch import run
    from unitex_torch.scripts.train_flux_lora import parse_args
    from unitex_torch.training.data import SyntheticTextureDataset
    from unitex_torch.training.flux_lora import create_train_state

    sig = inspect.signature(RGBTextureFullPipelineBase.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(init_flux_params).parameters["device"].default == "cuda"
    assert inspect.signature(create_train_state).parameters["device"].default == "cuda"
    assert SyntheticTextureDataset().device == "cuda"
    assert parse_args([]).device == "cuda"
    assert run.parse_args(["--image", "i.png", "--mesh", "m.obj"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CustomRGBTextureFullPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
