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
    for module in ("texture/fast_texture.py", "texture/refine.py",
                   "texture/pbr.py", "texture/envmap.py", "render/unify.py",
                   "render/scene.py", "ops/raytrace.py", "ops/visibility.py",
                   "geometry/topology.py", "camera/rotation.py",
                   "models/siglip.py", "models/flux/redux.py",
                   "render/volume.py", "render/field_vis.py", "render/viewer.py",
                   "utils/metrics.py", "scripts/view_mesh.py",
                   "scripts/roundtrip_oracle.py", "scripts/compare_golden.py",
                   "scripts/check_meshes.py", "scripts/merge_reports.py",
                   "parallel/mesh.py", "parallel/sharding.py",
                   "ops/ring_attention.py", "models/flux/sp.py",
                   "scripts/probe_multi_gpu.py", "parallel/collectives.py",
                   "parallel/pipeline.py", "models/flux/pp.py",
                   "training/full_finetune.py"):
        assert os.path.join(REPO, "unitex_torch", *module.split("/")) in files


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
    from unitex_torch.image.isnet import convert_isnet_torch, load_isnet
    from unitex_torch.image.rembg import build_background_remover
    from unitex_torch.models.birefnet import convert_birefnet_torch, load_birefnet
    from unitex_torch.scripts import batch_pipeline, serve_pipeline
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
    assert batch_pipeline.parse_args(["jobs"]).device == "cuda"
    assert serve_pipeline.parse_args([]).device == "cuda"
    assert inspect.signature(
        build_background_remover).parameters["device"].default == "cuda"
    for fn in (convert_isnet_torch, load_isnet, convert_birefnet_torch,
               load_birefnet):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CustomRGBTextureFullPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_tsdsr_trainer_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    """The TSD-SR trainer's entry points run on the card unless asked for
    the CPU: its launcher without ``--cpu``, ``create_tsd_state``, the
    LPIPS and LoRA inits; without a card the launcher raises."""
    import inspect

    from unitex_torch.models.sd3.lora import init_sd3_lora
    from unitex_torch.scripts import train_tsdsr
    from unitex_torch.training.tsdsr import create_tsd_state
    from unitex_torch.utils.lpips import init_lpips_params, load_torch_lpips

    for fn in (create_tsd_state, init_sd3_lora, init_lpips_params,
               load_torch_lpips):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    argv = ["--lr-dir", str(tmp_path), "--hr-dir", str(tmp_path), "--tiny"]
    assert not train_tsdsr.parse_args(argv).cpu
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tsdsr.main(argv)


def test_ltm_trainer_text_encoders_and_samplers_default_to_cuda(tmp_path):
    """The LTM trainer's launcher and state, the text encoders' inits and
    ``build_text_encoders``, the remap and the device samplers run on the
    card unless asked for the CPU; without a card the launcher raises."""
    import inspect

    from unitex_torch.geometry.sampling import sample_near_surface, sample_spatial
    from unitex_torch.models.text import init_clip_text_params, init_t5_encoder_params
    from unitex_torch.models.text_encoders import (
        DeviceFluxTextEncoders, FluxTextEncoders, build_text_encoders,
    )
    from unitex_torch.scripts import train_ltm
    from unitex_torch.texture.remapping import color_transfer_v_uv, remap_texture
    from unitex_torch.training.ltm import create_ltm_state, sample_ltm_batch

    for fn in (sample_spatial, sample_near_surface, init_clip_text_params,
               init_t5_encoder_params, build_text_encoders, remap_texture,
               color_transfer_v_uv, create_ltm_state, sample_ltm_batch,
               DeviceFluxTextEncoders.__init__, FluxTextEncoders.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert train_ltm.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ltm.main(["--tiny", "--out", str(tmp_path / "ltm.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_text_encoders(str(tmp_path))


def test_texture_tools_default_to_cuda():
    """FLUX img2img and inpainting, FastTexture, the unified renders, the
    turntable export and the environment map's directions run on the card
    unless asked for the CPU; without a card the inpainting raises."""
    import inspect

    from unitex_torch.models.flux.pipeline import run_flux_inpaint
    from unitex_torch.render.unify import (
        generate_cameras_v1, generate_cameras_v2, unified_pbr_render,
        unified_rgb_render,
    )
    from unitex_torch.render.video import export_turntable
    from unitex_torch.texture.envmap import equirect_dirs
    from unitex_torch.texture.fast_texture import inpaint_texture, upscale_texture

    for fn in (run_flux_inpaint, inpaint_texture, upscale_texture,
               unified_rgb_render, unified_pbr_render, generate_cameras_v1,
               generate_cameras_v2, export_turntable, equirect_dirs):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_flux_inpaint({}, None, {}, None, None, torch.zeros(16, 16, 3))


def test_redux_viewer_and_tool_scripts_default_to_cuda(tmp_path):
    """The Redux conditioner, the SigLIP init and loaders, the viewer, its
    server and script, and the round-trip and golden scripts run on the
    card unless asked for the CPU; without a card they raise."""
    import inspect

    from unitex_torch.models.flux.redux import (
        ReduxConditioner, init_redux_params, load_redux_params, redux_image_ids,
    )
    from unitex_torch.models.siglip import (
        convert_siglip_vision, init_siglip_params, load_siglip, preprocess_siglip,
    )
    from unitex_torch.render.viewer import MeshViewer, serve
    from unitex_torch.scripts import compare_golden, roundtrip_oracle, view_mesh

    for fn in (ReduxConditioner.__init__, init_redux_params, load_redux_params,
               redux_image_ids, convert_siglip_vision, init_siglip_params,
               load_siglip, preprocess_siglip, MeshViewer.__init__, serve,
               compare_golden.compare_caches):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert view_mesh.parse_args(["m.glb"]).device == "cuda"
    assert roundtrip_oracle.parse_args([]).device == "cuda"
    assert compare_golden.parse_args(["a", "b"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReduxConditioner(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roundtrip_oracle.main(["--uv-size", "64"])


def test_multi_gpu_entry_points_default_to_cuda_and_nccl():
    """The mesh and the multi-rank pipeline run on the card (NCCL) unless
    asked for the CPU (gloo); without a card the mesh raises before any
    process group starts."""
    import inspect

    import torch.distributed as dist

    from unitex_torch.models.sd3.sr_pipeline import TSDSRPipeline
    from unitex_torch.parallel.mesh import make_mesh

    assert inspect.signature(make_mesh).parameters["device"].default == "cuda"
    assert inspect.signature(TSDSRPipeline.__init__).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(store=object(), rank=0, world_size=1)
    assert not dist.is_initialized()
