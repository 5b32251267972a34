"""``chip_smoke.py``'s helpers on the CPU: the ptxas report parser (each
kernel's line in the script's output carries its own registers and spill
text, the two head-width instantiations of B1, B2a and B2b apart), the tree -> diffusers
names of the checkpoints it writes (FLUX, VAE, SD3), read back through
the port's loaders at tiny size, the SR stage's derived launch count,
phase 10's comparison with ORACLE_r05.json, phase 12 (matting) at tiny
size and the result lines.  ``chip_smoke.py`` imports
only the standard library at its top; the parser's tests need neither a
card, PyTorch nor JAX."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mangled(name, lib):
    """A kernel's mangled name; ``name<N>`` is an instantiation of a
    template on the int N (the head widths of B1, B2a and B2b)."""
    base, _, arg = name.partition("<")
    inst = f"ILi{arg[:-1]}EEEv" if arg else "E"
    return (f"_ZN50_GLOBAL__N__5c148451_17_{lib}_cu_b137d46c{len(base)}{base}"
            f"{inst}14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16iixxxff")


# (kernel, library, registers, spill stores, spill loads, serialized)
KERNELS = [
    ("flash_fwd_kernel", "flash_attn_fwd", 168, 0, 0, False),
    ("flash_bwd_dkv_kernel", "flash_attn_bwd", 168, 276, 284, True),
    ("flash_bwd_dq_kernel", "flash_attn_bwd", 166, 0, 0, False),
    ("flash_qk8_kernel", "flash_attn_qk8", 226, 0, 0, False),
    ("flash_fwd_kernel<128>", "flash_attn_fwd", 168, 0, 0, False),
    ("flash_fwd_kernel<64>", "flash_attn_fwd", 154, 8, 8, True),
    ("flash_bwd_dkv_kernel<128>", "flash_attn_bwd", 168, 0, 0, False),
    ("flash_bwd_dkv_kernel<64>", "flash_attn_bwd", 168, 4, 4, True),
    ("flash_bwd_dq_kernel<128>", "flash_attn_bwd", 168, 0, 0, False),
    ("flash_bwd_dq_kernel<64>", "flash_attn_bwd", 160, 0, 0, False),
]


def _log():
    """A ptxas -v log in nvcc's order: the C75xx notes of all kernels
    first, then for each kernel its entry, properties, spill and
    register lines."""
    lines = []
    for name, lib, _, _, _, serialized in KERNELS:
        lines.append("ptxas info    : (C7519) warpgroup.arrive is injected in "
                     f"around line 478 by compiler to allow use of registers in "
                     f"GMMA in function '{_mangled(name, lib)}'")
        if serialized:
            lines.append("ptxas info    : (C7512) Potential Performance Loss: "
                         "wgmma.mma_async instructions are serialized due to "
                         "insufficient register resources for the function "
                         f"'{_mangled(name, lib)}'")
    lines.append("ptxas info    : 0 bytes gmem")
    for name, lib, regs, st, ld, _ in KERNELS:
        m = _mangled(name, lib)
        lines += [
            f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'",
            f"ptxas info    : Function properties for {m}",
            f"    {max(st, ld)} bytes stack frame, {st} bytes spill stores, "
            f"{ld} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 16 barriers",
            "ptxas info    : Compile time = 459.001 ms",
        ]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def usage(tmp_path_factory):
    path = tmp_path_factory.mktemp("ptxas") / "lib.so.log"
    path.write_text(_log())
    return dict(_chip_smoke().ptxas_usage(str(path)))


def test_ptxas_usage_names_each_kernel_once(usage):
    assert sorted(usage) == sorted(k[0] for k in KERNELS)


@pytest.mark.parametrize("kernel", KERNELS, ids=[k[0] for k in KERNELS])
def test_ptxas_usage_keeps_each_kernels_own_report(usage, kernel):
    name, _, regs, st, ld, serialized = kernel
    report = usage[name]
    assert report.startswith(f"Used {regs} registers")
    assert f"{st} bytes spill stores, {ld} bytes spill loads" in report
    assert ("wgmma serialized" in report) == serialized


@pytest.mark.parametrize("which", ["flux", "vae"])
def test_state_dict_names_round_trip_through_the_loader(which):
    """``flux_state_dict`` / ``vae_state_dict`` give every leaf of a tiny
    tree its diffusers name and torch layout: the port's loader maps them
    back to the same tree, every leaf equal, and reads no name twice."""
    import torch

    from unitex_torch.models.flux import loader
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.model import init_flux_params
    from unitex_torch.models.flux.vae import VAEConfig, init_vae_params

    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    if which == "flux":
        cfg = FluxConfig.tiny()
        tree = init_flux_params(gen, cfg, device="cpu")
        pairs = list(cs.flux_state_dict(tree))
        back = loader.flux_params_from_state_dict(dict(pairs), cfg, device="cpu")
    else:
        cfg = VAEConfig.tiny()
        tree = init_vae_params(gen, cfg, device="cpu")
        pairs = list(cs.vae_state_dict(tree))
        back = loader.vae_params_from_state_dict(dict(pairs), cfg, device="cpu")
    assert len(pairs) == len({name for name, _ in pairs})
    want, got = dict(cs._named_leaves(tree)), dict(cs._named_leaves(back))
    assert sorted(got) == sorted(want)
    n_leaves = sum(x.shape[0] if k.startswith(("/dual", "/single")) else 1
                   for k, x in want.items())
    assert len(pairs) == n_leaves
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sd3_state_dict_round_trips_through_the_loader():
    """``sd3_state_dict`` (phase 6's SD3 checkpoint) gives every leaf of a
    tiny SD3 tree its diffusers name and torch layout (the patchify linear
    as the PatchEmbed conv, the position table as [1, pmax², d], the final
    block as the last ``transformer_blocks`` entry): the port's loader maps
    them back to the same tree, and no name repeats."""
    import torch

    from unitex_torch.models.sd3 import loader
    from unitex_torch.models.sd3.config import SD3Config
    from unitex_torch.models.sd3.model import init_sd3_params

    cs = _chip_smoke()
    cfg = SD3Config.tiny()
    tree = init_sd3_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    pairs = list(cs.sd3_state_dict(tree, cfg))
    names = dict(pairs)
    assert len(pairs) == len(names)
    assert names["pos_embed.proj.weight"].shape == (64, 4, 2, 2)
    assert names["pos_embed.pos_embed"].shape == (1, 16 * 16, 64)
    assert "transformer_blocks.1.attn.to_add_out.weight" not in names
    assert "transformer_blocks.0.attn.to_add_out.weight" in names
    back = loader.sd3_params_from_state_dict(names, cfg, device="cpu")
    want, got = dict(cs._named_leaves(tree)), dict(cs._named_leaves(back))
    assert sorted(got) == sorted(want)
    n_leaves = sum(x.shape[0] if k.startswith("/blocks") else 1
                   for k, x in want.items())
    assert len(pairs) == n_leaves
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sr_launches_are_derived_from_the_tiling():
    """The SR stage's B1 (D = 64) launches: the 2x3 grid of 512² views is
    a 512 x 768 latent, 9 x 14 = 126 tiles of 64² (overlap 8) in 16 calls
    of 8 (the last of 6), one launch a layer of SD3-medium's 24; one view
    is 5 x 5 = 25 tiles in 4 calls."""
    cs = _chip_smoke()
    assert cs.sr_launches(512, 2, 3) == 16 * 24 == 384
    assert cs.sr_launches(512, 1, 1) == 4 * 24
    assert (cs.SD3_H, cs.SD3_D, cs.SD3_S) == (24, 64, 1178)


@pytest.mark.parametrize("primitive", ["cup", "trefoil"])
@pytest.mark.parametrize("setting", ["priority_k1", "cosine_k8_relax", "cosine_ltm"])
def test_oracle_record_finds_each_recorded_case(primitive, setting):
    """Phase 10 compares each of ``oracle_campaign.SETTINGS`` with its
    case in ORACLE_r05.json (the LTM case carries ``fill: ltm`` and no
    ``fill_k``)."""
    from unitex_torch.scripts.oracle_campaign import SETTINGS

    cs = _chip_smoke()
    assert setting in SETTINGS and primitive in cs.ORACLE_PRIMITIVES
    ref = cs.oracle_record(primitive, setting)
    assert ref["primitive"] == primitive
    assert ref["paste_mode"] == SETTINGS[setting]["paste_mode"]
    assert (ref.get("fill") == "ltm") == (setting == "cosine_ltm")
    if setting != "cosine_ltm":
        assert ref["fill_k"] == SETTINGS[setting]["fill_k"]
        assert ref["fill_relax_iters"] == SETTINGS[setting]["fill_relax_iters"]


def test_oracle_line_and_order_check():
    cs = _chip_smoke()
    ref = cs.oracle_record("cup", "cosine_ltm")
    case = {k: ref[k] for k in cs.ORACLE_KEYS}
    case["texture_psnr_all"] = ref["texture_psnr_all"] - 0.5
    case["bake_s"] = 1.25
    line = cs.oracle_line("cup", "cosine_ltm", case, ref)
    assert line.startswith("[oracle] cup cosine_ltm: visible_texel_fraction ")
    assert f"texture_psnr_all {case['texture_psnr_all']} (JAX 33.51, -0.50)" in line
    assert line.endswith("; bake 1.250s")
    idw = {"texture_psnr_all": 30.73}
    cs.check_oracle_order("cup", {"cosine_ltm": case, "cosine_k8_relax": idw})
    with pytest.raises(AssertionError, match="does not beat"):
        cs.check_oracle_order("cup", {"cosine_ltm": idw, "cosine_k8_relax": case})


def test_the_last_line_is_the_result():
    """The output's last three lines: the kernels' record, the card, and
    ``{"ok": true, "device": {...}}`` with exactly the keys the result
    carries."""
    import json

    cs = _chip_smoke()
    lines = cs.result_lines([{"name": "B1"}], "NVIDIA H100 80GB HBM3, 700.00 W",
                            "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(lines[0]) == {"kernels": [{"name": "B1"}]}
    assert lines[1] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[2]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert lines[2] == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                        '"NVIDIA H100 80GB HBM3", "count": 1}}')


def test_matting_phase_and_checkpoints_rehearse_on_the_cpu(tmp_path, monkeypatch,
                                                           capsys):
    """Phase 12 on the CPU at tiny configs and 64² forwards (the card's
    calls stubbed): both models' forwards, removers and lines; then the
    seeded state dicts written where ``build_background_remover`` looks
    pick ISNet (RMBG-1.4 is tried first) and, alone, BiRefNet (the default
    configs patched to tiny)."""
    import dataclasses

    import torch
    from torch_cpu_share import share_cpu

    from unitex_torch.image import isnet, rembg
    from unitex_torch.models import birefnet

    share_cpu()
    cs = _chip_smoke()
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    tiny = {"isnet": dataclasses.replace(isnet.IsnetConfig.tiny(), size=64),
            "birefnet": birefnet.BiRefNetConfig.tiny()}
    cs.run_matting(torch, "cpu", tiny, forward_size=64)
    out = capsys.readouterr().out
    for name in tiny:
        assert f"[matting] {name} (" in out and f"[matting] {name} remover" in out
    monkeypatch.setattr(isnet.IsnetConfig, "rmbg14", staticmethod(lambda: tiny["isnet"]))
    monkeypatch.setattr(birefnet.BiRefNetConfig, "rmbg20",
                        staticmethod(birefnet.BiRefNetConfig.tiny))
    root = str(tmp_path)
    for name, cls in (("birefnet", birefnet.BirefnetRemover),
                      ("isnet", isnet.IsnetRemover)):
        sd = cs.matting_model(torch, name, "cpu", tiny[name])[1]
        assert cs.write_matting_checkpoint(root, name, sd) > 0
        assert isinstance(rembg.build_background_remover(root, device="cpu"), cls)


def test_ltm_training_and_text_phases_rehearse_on_the_cpu(monkeypatch, capsys):
    """Phases 16 and 17 on the CPU: the LTM trainer at ``--tiny`` (60
    steps; the fixed batches' loss gate, the npz read back and taken by
    the pipeline, the profiled step with its annotation) and the text
    encoders at tiny configs (the forwards, the depth-2 copies against
    themselves, the HF names and back, the backend's choice)."""
    import torch
    from torch_cpu_share import share_cpu

    from unitex_torch.models.text import CLIPTextConfig, T5EncoderConfig

    share_cpu()
    cs = _chip_smoke()
    cs.run_ltm_training(torch, "cpu", args=("--tiny", "--steps", "60",
                                            "--log-every", "30"))
    out = capsys.readouterr().out
    assert "fixed batches' summed loss" in out and "read back equal" in out
    assert "the pipeline's LTM loader took it" in out
    assert "annotation present" in out
    clip = CLIPTextConfig(vocab_size=1000, hidden_size=48, num_layers=3,
                          mlp_dim=64, eos_token_id=999)
    t5 = T5EncoderConfig(vocab_size=500, d_model=32, d_kv=8, d_ff=64,
                         num_layers=3, num_heads=4)
    cs.run_text(torch, "cpu", clip, t5)
    out = capsys.readouterr().out
    assert "[text] clip: 52 HF-named tensors -> 20 leaves equal" in out
    assert "[text] t5: 30 HF-named tensors -> 12 leaves equal" in out
    assert "None: zero embeddings" in out


def test_redux_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 19 on the CPU at tiny sizes: the tiny SigLIP and Redux trees
    through the HF-named checkpoint and the conditioner, the Redux job on
    tiny FLUX and VAE trees (no kernel launches on the CPU: the gate
    expects none), the search, volume and field checks on small inputs,
    the viewer over HTTP and the four scripts."""
    import dataclasses
    import types

    import numpy as np
    import torch
    from torch_cpu_share import share_cpu
    from PIL import Image

    from unitex_torch.config import DEFAULT_CONFIG
    from unitex_torch.geometry.io.mesh_io import save_mesh
    from unitex_torch.geometry.primitives import make_icosphere
    from unitex_torch.geometry.uv_atlas import unwrap_atlas
    from unitex_torch.models.flux import model as tmodel
    from unitex_torch.models.flux import vae as tvae
    from unitex_torch.models.flux.config import FluxConfig
    from unitex_torch.models.flux.lora import init_lora_params
    from unitex_torch.models.siglip import SiglipVisionConfig
    from unitex_torch.ops import attention as attn

    share_cpu()
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fcfg, vcfg = FluxConfig.tiny(), tvae.VAEConfig.tiny()
    flux = tmodel.init_flux_params(torch.Generator().manual_seed(0), fcfg, device="cpu")
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        diffusion=dataclasses.replace(DEFAULT_CONFIG.diffusion, height=16,
                                      width=96, dual_size=16),
        camera=dataclasses.replace(DEFAULT_CONFIG.camera, view_size=32))
    pipe = types.SimpleNamespace(
        transformer_params=flux, flux_cfg=fcfg, config=cfg, vae_cfg=vcfg,
        vae_params=tvae.init_vae_params(torch.Generator().manual_seed(1), vcfg,
                                        device="cpu"),
        texture_lora=init_lora_params(torch.Generator().manual_seed(2), flux,
                                      rank=2, device="cpu"),
        delight_lora=None)
    host = unwrap_atlas(make_icosphere(3), size=64, gutter=1)
    yy, xx = np.mgrid[:64, :64] / 63.0
    host.texture = (127 + 100 * np.sin(4 * xx[..., None] + 3 * yy[..., None]
                                       + np.arange(3))).astype(np.uint8)
    save_mesh(str(tmp_path / "icosphere.glb"), host)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)).save(
        tmp_path / "icosphere.png")
    (tmp_path / "icosphere_cache").mkdir()
    for name, shape in (("mv_normal", (32, 48)), ("mv_ccm", (32, 48)),
                        ("processed_image", (16, 16))):
        Image.fromarray(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).save(
            tmp_path / "icosphere_cache" / f"{name}.png")
    cs._reset(attn)
    cs.run_redux_tools(attn, torch, pipe, str(tmp_path), device="cpu",
                       siglip_cfg=SiglipVisionConfig.tiny(), steps=2,
                       search_n=2048, search_cpu=256, grid=16, frame=64,
                       oracle=("--subdiv", "2", "--view-size", "32",
                               "--uv-size", "64"))
    out = capsys.readouterr().out
    assert "backend port, heads 4, input side 28, both trees leaf for leaf equal True" in out
    assert "prompt_embeds (1, 4, 64)" in out and "S = 212" in out
    assert "indices agree (ties of 1 ulp forgiven) on 1.000000" in out
    for tag in ("[volume]", "[fields] isosurface", "[fields] texture",
                "[fields] get_visible_faces", "a bad mode answers 400",
                "[scripts] roundtrip_oracle", "worst PSNR 120.0 dB",
                "[scripts] check_meshes"):
        assert tag in out, tag
