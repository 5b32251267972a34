"""Batch mesh-dataset checker with the PyTorch port (the counterpart of the
root ``scripts/check_meshes.py``): glob glTF/GLB files, parse their headers
only, and write a CSV of path/V/F/NC/NM, in one pass over a thread pool
(the header parse is bound by the disk).

    python -m unitex_torch.scripts.check_meshes "assets/**/*.glb" --out mesh_check.csv
"""

from __future__ import annotations

import argparse
import csv
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob

from ..geometry.io.mesh_header import parse_mesh_info

CHECK_LIST = ["path", "V", "F", "NC", "NM"]


def check_one(path: str) -> dict:
    try:
        item = parse_mesh_info(path)
    except Exception as e:  # noqa: BLE001 — a broken asset must not kill the sweep
        item = {"V": -1, "F": -1, "NC": -1, "NM": -1, "error": str(e)}
    item["path"] = path
    return item


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pattern", help="glob of .glb/.gltf files")
    ap.add_argument("--out", default="mesh_check.csv")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    paths = sorted(glob(args.pattern, recursive=True))
    if not paths:
        raise SystemExit(f"no files match {args.pattern!r}")
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        rows = list(pool.map(check_one, paths))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=CHECK_LIST, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
    bad = [r for r in rows if r["V"] < 0]
    print(f"checked {len(rows)} meshes -> {args.out} ({len(bad)} failed)")


if __name__ == "__main__":
    main()
