"""Texture-generation HTTP service with the PyTorch port (the counterpart
of the root ``scripts/serve_pipeline.py``): load the pipeline once, serve
(image, mesh) -> textured-GLB jobs over ``unitex_torch.serving``.

    python -m unitex_torch.scripts.serve_pipeline --port 8080 \\
        --pretrain-models <root> [--device cuda]
    curl -X POST localhost:8080/jobs -d '{"image_path": "x.png",
                                          "mesh_path": "m.glb"}'
    curl localhost:8080/jobs/<id>            # poll status
    curl -o out.glb localhost:8080/jobs/<id>/result
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--work-dir", default="serve_jobs")
    ap.add_argument("--pretrain-models", default=None)
    ap.add_argument("--seed", type=int, default=63)
    ap.add_argument("--super-resolution", action="store_true")
    ap.add_argument("--int8", dest="int8", action="store_const", const=True,
                    default=False, help="W8A8 int8 serving")
    ap.add_argument("--int8-max-memory", dest="int8",
                    action="store_const", const="max_memory",
                    help="int8 + weight-only int8 for the other block kernels")
    ap.add_argument("--small", action="store_true",
                    help="reduced resolutions (smoke tests, CPU)")
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--prewarm", action="store_true",
                    help="run every device stage once on the device thread "
                         "before the first job")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs without a card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from unitex_torch.pipeline import CustomRGBTextureFullPipeline
    from unitex_torch.scripts.batch_pipeline import build_config
    from unitex_torch.serving import serve

    config = build_config(args.small)
    kwargs = {"config": config} if config is not None else {}
    pipe = CustomRGBTextureFullPipeline(
        pretrain_models=args.pretrain_models,
        super_resolutions=args.super_resolution,
        seed=args.seed,
        int8_serving=args.int8,
        device=args.device,
        **kwargs,
    )
    httpd = serve(pipe, args.work_dir, port=args.port, host=args.host,
                  prefetch=not args.no_prefetch, prewarm=args.prewarm)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(work dir {args.work_dir})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.jobs.stop()
        httpd.server_close()


if __name__ == "__main__":
    main()
