"""``chip_smoke.py``'s helpers on the CPU: the ptxas report parser (each
kernel's line in the script's output carries its own registers and spill
text, B1's two head-width instantiations apart), the tree -> diffusers
names of the checkpoints it writes (FLUX, VAE, SD3), read back through
the port's loaders at tiny size, the SR stage's derived launch count,
phase 10's comparison with ORACLE_r05.json and the result lines.  ``chip_smoke.py`` imports
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
    template on the int N (B1's head widths)."""
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
