"""Texture round-trip oracle (port of scripts/oracle_campaign.py).

A mesh is given a known texture (its chart texels coloured 0.5 + 0.5 ·
position / 0.85, the gutter pull-push dilated), rendered into the six box
views (512², ortho, radius 2.8), and re-baked into a 2048² atlas with
``bake_texture(method="reproject")``.  Scores: PSNR over the visible chart
texels, over all chart texels, and of the re-rendered views against the
input views.  The JAX package recorded these for its bake
(``ORACLE_r05.json``); the three option sets compared there are
``SETTINGS``.

    python -m unitex_torch.scripts.oracle_campaign --primitives cup trefoil \\
        --ltm ltm_params.npz --out oracle.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

PRIMITIVES = ("sphere", "torus", "trefoil", "compound", "cup")

# ORACLE_r05.json's option sets: reference parity (priority paste, k=1
# fill), the quality set (cosine paste, k=8 inverse-distance fill and 50
# relaxation passes), and the trained LTM field with the cosine paste
SETTINGS = {
    "priority_k1": dict(paste_mode="priority", fill_k=1, fill_relax_iters=0),
    "cosine_k8_relax": dict(paste_mode="cosine", fill_k=8, fill_relax_iters=50),
    "cosine_ltm": dict(paste_mode="cosine", ltm=True),
}


def load_ltm_query_field(path: str, device="cuda"):
    """A trained LTM checkpoint (the npz of ``utils/param_cache``, its
    ``LTMConfig`` in the meta) -> the bake's ``query_field`` hook."""
    from ..models.ltm import LTMConfig, make_query_field
    from ..utils.param_cache import load_meta, load_params
    from ..utils.params import tree_to

    meta = load_meta(path) or {}
    cfg = LTMConfig(**meta.get("config", {}))
    return make_query_field(tree_to(load_params(path), device), cfg)


def _host_mesh(primitive: str):
    from ..geometry.primitives import (
        make_compound,
        make_cup,
        make_icosphere,
        make_torus,
        make_trefoil,
    )

    return {
        "sphere": lambda: make_icosphere(5),
        "torus": lambda: make_torus(n_major=192, n_minor=128),
        "trefoil": lambda: make_trefoil(n_major=384, n_minor=40),
        "compound": lambda: make_compound(subdivisions=5),
        # a tilted open cup: interior texels within one wall thickness of
        # the outer surface, deep cavities no view sees
        "cup": lambda: make_cup(),
    }[primitive]()


@torch.no_grad()
def prepare_case(primitive: str, view_size: int = 512, uv_size: int = 2048,
                 device="cuda", host=None, texture=None) -> dict:
    """The unwrapped mesh, its ground-truth texture and the six views of
    it: what every bake of ``primitive`` starts from.  ``host`` is an
    unwrapped host mesh to take instead of the primitive; ``texture``
    [H, W, 3] in [0, 1] (resized to the atlas as ``jax.image.resize``
    does) replaces the position colours on the chart."""
    from ..geometry.mesh import Mesh
    from ..geometry.uv_atlas import unwrap_atlas
    from ..ops.image_ops import pull_push
    from ..render.conditioning import condition_cameras
    from ..render.renderer import render_views
    from ..render.renderer_inverse import uv_render
    from ..utils.resize import resize_bilinear

    if host is None:
        host = unwrap_atlas(_host_mesh(primitive), size=uv_size, gutter=4)
    mesh = Mesh(
        torch.from_numpy(np.asarray(host.vertices * 0.85, np.float32)).to(device),
        torch.from_numpy(np.asarray(host.faces, np.int64)).to(device),
        uv=torch.from_numpy(np.asarray(host.uv, np.float32)).to(device),
        faces_uv=torch.from_numpy(np.asarray(host.faces_uv, np.int64)).to(device),
    )
    uv_out = uv_render(mesh, uv_size)
    mask = uv_out["mask"]
    if texture is None:
        tex = 0.5 + 0.5 * uv_out["position"] / 0.85
    else:
        tex = torch.as_tensor(texture, dtype=torch.float32).to(mask.device)
        if tuple(tex.shape[:2]) != (uv_size, uv_size):
            tex = resize_bilinear(tex, uv_size, uv_size)
    tex = torch.where(mask, tex, torch.zeros_like(tex))
    # the views see the texture with its gutter dilated, as a baked
    # texture ships: a zero gutter would darken every seam pixel
    c2ws, intr = condition_cameras(device=device)
    out = render_views(mesh, c2ws, intr, (view_size, view_size),
                       map_attr=pull_push(tex, mask), render_uv=True,
                       render_map_attr=True)
    return {"primitive": primitive, "mesh": mesh, "uv_size": uv_size,
            "mask": mask, "tex": tex, "c2ws": c2ws, "intr": intr,
            "views": out.map_attr, "alpha": out.alpha,
            "view_size": view_size}


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return round(-10 * np.log10(max(mse, 1e-10)), 2)


@torch.no_grad()
def run_case(primitive: str, view_size: int = 512, uv_size: int = 2048,
             ltm_path=None, device="cuda", scene=None, method="reproject",
             **bake_kwargs) -> dict:
    """One round trip of ``primitive`` by the bake ``method`` with the bake
    options ``bake_kwargs`` (and the LTM field of ``ltm_path``); ``scene`` is a
    :func:`prepare_case` of the same primitive and sizes to start from.
    Adds ``bake_s``, the bake's seconds ending in a device sync, and
    returns ``texture`` (the baked atlas, on the device) beside the
    scores."""
    from ..render.renderer import render_views
    from ..render.renderer_inverse import bake_texture

    if scene is None:
        scene = prepare_case(primitive, view_size, uv_size, device)
    extra = {}
    if ltm_path is not None:
        extra["query_field"] = load_ltm_query_field(ltm_path, device)
    mesh = scene["mesh"]
    sync = torch.cuda.synchronize if mesh.vertices.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    baked = bake_texture(mesh, scene["views"], scene["c2ws"], scene["intr"],
                         uv_size=uv_size, method=method, **bake_kwargs,
                         **extra)
    sync()
    bake_s = time.perf_counter() - t0
    rec = baked["texture"]
    mask = scene["mask"][..., 0].cpu().numpy()
    vis_any = baked["mask_visible_any"][..., 0].cpu().numpy()
    ok = mask & vis_any
    rec_np, tex_np = rec.cpu().numpy(), scene["tex"].cpu().numpy()
    V = (view_size, view_size)
    out2 = render_views(mesh, scene["c2ws"], scene["intr"], V, map_attr=rec,
                        render_uv=True, render_map_attr=True)
    alpha = scene["alpha"][..., 0].cpu().numpy() > 0.5
    views = scene["views"].cpu().numpy()
    return {
        "primitive": primitive,
        "faces": int(mesh.faces.shape[0]),
        **({"fill": "ltm"} if ltm_path is not None else {}),
        **bake_kwargs,
        "visible_texel_fraction": round(float(vis_any[mask].mean()), 4),
        "texture_psnr_visible": _psnr(rec_np[ok], tex_np[ok]),
        "texture_psnr_all": _psnr(rec_np[mask], tex_np[mask]),
        "rerender_psnr": _psnr(out2.map_attr.cpu().numpy()[alpha], views[alpha]),
        "bake_s": bake_s,
        "texture": rec,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="oracle.json")
    ap.add_argument("--view-size", type=int, default=512)
    ap.add_argument("--uv-size", type=int, default=2048)
    ap.add_argument("--primitives", nargs="+", default=list(PRIMITIVES),
                    choices=PRIMITIVES)
    ap.add_argument("--ltm", default=None,
                    help="a trained LTM checkpoint (such as ltm_params.npz): "
                         "adds the LTM option set")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cases = []
    for prim in args.primitives:
        scene = prepare_case(prim, args.view_size, args.uv_size, args.device)
        for name, setting in SETTINGS.items():
            setting = dict(setting)
            if setting.pop("ltm", False):
                if args.ltm is None:
                    continue
                setting["ltm_path"] = args.ltm
            case = run_case(prim, args.view_size, args.uv_size,
                            device=args.device, scene=scene, **setting)
            case.pop("texture")
            cases.append({"setting": name, **case})
            print(json.dumps(cases[-1]), flush=True)
    with open(args.out, "w") as f:
        json.dump({"metric": "texture_roundtrip", "cases": cases}, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
