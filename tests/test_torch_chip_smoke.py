"""``chip_smoke.py``'s ptxas report parser, on the CPU: each kernel's line in
the script's output carries its own registers and spill text.
``chip_smoke.py`` imports only the standard library at its top, so this
runs without a card, PyTorch or JAX."""

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
    return (f"_ZN50_GLOBAL__N__5c148451_17_{lib}_cu_b137d46c{len(name)}{name}"
            "E14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16iixxxff")


# (kernel, library, registers, spill stores, spill loads, serialized)
KERNELS = [
    ("flash_fwd_kernel", "flash_attn_fwd", 168, 0, 0, False),
    ("flash_bwd_dkv_kernel", "flash_attn_bwd", 168, 276, 284, True),
    ("flash_bwd_dq_kernel", "flash_attn_bwd", 166, 0, 0, False),
    ("flash_qk8_kernel", "flash_attn_qk8", 226, 0, 0, False),
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
