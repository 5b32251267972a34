"""Texture round-trip oracle with the PyTorch port (the counterpart of the
root ``scripts/roundtrip_oracle.py``): render a mesh with a known texture
into the six box views, re-bake the texture from those views and compare.

    python -m unitex_torch.scripts.roundtrip_oracle [--mesh m.glb | --primitive sphere]
        [--texture t.png] [--view-size 512] [--uv-size 2048]
        [--method reproject|kdtree|reproject_blending] [--out report.json]
        [--device cuda]

Without ``--texture`` a smooth function of 3D position is the ground
truth.  Prints one JSON line: the texture PSNR over the chart texels some
view sees, and the re-rendered views' PSNR against the input views.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default=None, help="obj/ply/glb (unwrapped if needed)")
    ap.add_argument("--primitive", default="sphere",
                    choices=["sphere", "torus", "trefoil", "compound"])
    ap.add_argument("--subdiv", type=int, default=5, help="sphere subdivisions")
    ap.add_argument("--texture", default=None, help="ground-truth texture PNG")
    ap.add_argument("--view-size", type=int, default=512)
    ap.add_argument("--uv-size", type=int, default=2048)
    ap.add_argument("--method", default="reproject",
                    choices=["reproject", "kdtree", "reproject_blending"])
    ap.add_argument("--paste-mode", default="priority",
                    choices=["priority", "cosine"],
                    help="reproject paste: the fixed view order, or per texel "
                         "the most head-on view")
    ap.add_argument("--fill-k", type=int, default=1,
                    help="neighbours of the invisible-texel fill (k > 1: "
                         "inverse-distance weighted)")
    ap.add_argument("--fill-relax", type=int, default=0,
                    help="seam-aware relaxation passes over the fill")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs without a card)")
    return ap.parse_args(argv)


def _host(args):
    from ..geometry.primitives import make_icosphere
    from ..geometry.uv_atlas import preprocess_blank_mesh, unwrap_atlas
    from .oracle_campaign import _host_mesh

    if args.mesh:
        from ..geometry.io.mesh_io import load_mesh

        return preprocess_blank_mesh(load_mesh(args.mesh), uv_size=args.uv_size)
    mesh = (make_icosphere(args.subdiv) if args.primitive == "sphere"
            else _host_mesh(args.primitive))
    return unwrap_atlas(mesh, size=args.uv_size, gutter=4)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the round trip; print and return the report."""
    args = parse_args(argv)
    from ..utils.precision import resolve_device
    from .oracle_campaign import prepare_case, run_case

    device = resolve_device(args.device)
    texture = None
    if args.texture:
        from ..utils.image_io import load_image

        texture = load_image(args.texture)
    scene = prepare_case(args.primitive, args.view_size, args.uv_size, device,
                         host=_host(args), texture=texture)
    bake_kwargs = {}
    if args.method == "reproject":
        bake_kwargs = dict(paste_mode=args.paste_mode, fill_k=args.fill_k,
                           fill_relax_iters=args.fill_relax)
    case = run_case(args.primitive, args.view_size, args.uv_size, device=device,
                    scene=scene, method=args.method, **bake_kwargs)
    report = {
        "metric": "texture_roundtrip",
        "method": args.method,
        **bake_kwargs,
        "faces": case["faces"],
        "uv_size": args.uv_size,
        "view_size": args.view_size,
        "visible_texel_fraction": case["visible_texel_fraction"],
        "texture_psnr_visible": case["texture_psnr_visible"],
        "rerender_psnr": case["rerender_psnr"],
    }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
