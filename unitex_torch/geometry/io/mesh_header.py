"""GLB/glTF header inspection without loading buffer data.

Capability of the reference's io/mesh_header_loader.py:12-78: read only the
JSON chunk of a .glb (or the JSON document of a .gltf, buffers stripped) and
summarize vertex/face/mesh/material counts — used to triage large datasets
(io/check_gltf.py) without decoding geometry.  Pure stdlib.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A  # 'JSON'


def load_mesh_header(mesh_path: str) -> Dict:
    """Parse the glTF JSON header of a .glb/.gltf file.  Non-glTF extensions
    return ``{'meshes': []}`` like the reference (mesh_header_loader.py:56)."""
    ext = os.path.splitext(mesh_path)[1].lower()
    if ext == ".glb":
        with open(mesh_path, "rb") as f:
            head = struct.unpack("<5I", f.read(20))
            if head[0] != _GLB_MAGIC:
                raise ValueError("incorrect header on GLB file")
            if head[1] != 2:
                raise NotImplementedError(
                    f"only GLTF 2 is supported not `{head[1]}`"
                )
            _, chunk_length, chunk_type = head[2:]
            if chunk_type != _CHUNK_JSON:
                raise ValueError("no initial JSON header!")
            return json.loads(f.read(int(chunk_length)).decode("utf-8"))
    if ext == ".gltf":
        with open(mesh_path, "r", encoding="utf-8") as f:
            header = json.load(f)
        header.pop("buffers", None)
        return header
    return {"meshes": []}


def parse_mesh_info(mesh_path: str) -> Dict[str, int]:
    """Vertex/triangle/mesh/material counts from accessor metadata alone
    (mesh_header_loader.py:62-78): V, F (triangles), NC (mesh count),
    NM (material count)."""
    h = load_mesh_header(mesh_path)
    vl = fl = 0
    meshes = h.get("meshes", [])
    accessors = h.get("accessors", [])
    for m in meshes:
        for prim in m.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" in attrs:
                vl += accessors[attrs["POSITION"]]["count"]
            if prim.get("indices") is not None:
                fl += accessors[prim["indices"]]["count"]
    return {
        "V": vl,
        "F": fl // 3,
        "NC": len(meshes),
        "NM": len(h.get("materials", [])),
    }
