"""Merge per-asset JSON reports with the PyTorch port (the counterpart of
the root ``scripts/merge_reports.py``): one JSON and one CSV of all
records, optionally joined with each asset's vertex and face counts from
its glTF header, and split into success and failure CSVs.

    python -m unitex_torch.scripts.merge_reports "reports/*.json" --out merged \
        [--mesh-root assets] [--fail-key status]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from glob import glob

from ..geometry.io.mesh_header import parse_mesh_info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pattern", help="glob of per-asset JSON shards")
    ap.add_argument("--out", default="merged", help="output basename (.json/.csv)")
    ap.add_argument(
        "--mesh-root",
        default=None,
        help="if set, join V/F counts from <mesh-root>/<uid>.glb headers",
    )
    ap.add_argument(
        "--fail-key",
        default=None,
        help="column whose value 'failed' splits rows into _success/_fail CSVs",
    )
    args = ap.parse_args(argv)

    data: dict = {}
    for p in sorted(glob(args.pattern, recursive=True)):
        with open(p, "r", encoding="utf-8") as f:
            shard = json.load(f)
        if not isinstance(shard, dict):
            raise SystemExit(f"{p}: expected an object of uid -> record")
        data.update(shard)

    keys: list = []
    for uid, rec in data.items():
        if isinstance(rec, str):  # a bare failure string becomes a row of it
            rec = data[uid] = {k: rec for k in keys} if keys else {"status": rec}
        if args.mesh_root:
            try:
                info = parse_mesh_info(os.path.join(args.mesh_root, uid + ".glb"))
                rec.update({"vertices": info["V"], "faces": info["F"]})
            except Exception:  # noqa: BLE001 — any broken asset falls back to -1
                rec.update({"vertices": -1, "faces": -1})
        for k in rec:
            if k not in keys:
                keys.append(k)

    with open(args.out + ".json", "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4)

    def write_csv(path, rows):
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=["uid"] + keys, extrasaction="ignore")
            w.writeheader()
            for uid, rec in rows:
                w.writerow({"uid": uid, **rec})

    items = sorted(data.items())
    write_csv(args.out + ".csv", items)
    if args.fail_key:
        write_csv(
            args.out + "_success.csv",
            [(u, r) for u, r in items if r.get(args.fail_key) != "failed"],
        )
        write_csv(
            args.out + "_fail.csv",
            [(u, r) for u, r in items if r.get(args.fail_key) == "failed"],
        )
    print(f"merged {len(data)} records -> {args.out}.json/.csv")


if __name__ == "__main__":
    main()
