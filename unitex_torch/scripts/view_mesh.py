"""Interactive mesh viewer server with the PyTorch port (the counterpart of
the root ``scripts/view_mesh.py``): drag-to-orbit rendering of a mesh in
the browser, rendered server-side by ``unitex_torch.render.viewer`` on
the card, or on the CPU with ``--cpu``.

    python -m unitex_torch.scripts.view_mesh path/to/mesh.glb --port 7860 [--cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mesh")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU instead of the card")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from ..render.viewer import serve

    serve(args.mesh, port=args.port, host=args.host, device=args.device)


if __name__ == "__main__":
    main()
